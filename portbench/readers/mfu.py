"""The whole step's share of the card's dense bf16 peak: the least FLOPs of
the calls answered in the (unprofiled) window, counted from their shapes by
the configuration's system module, over the window's seconds."""


def read(run):
    if run.peaks is None or not run.window_flops:
        return None
    return 100.0 * run.window_flops / run.window_s / run.peaks["bf16_flops"]

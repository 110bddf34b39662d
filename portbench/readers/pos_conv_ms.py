"""Device time per public call of the operations launched inside the program's
span ``fsem.hubert.pos_conv``: SpeechBERTScore's feature projection,
grouped positional conv and encoder LayerNorm."""

SPAN = "fsem.hubert.pos_conv"


def read(run):
    if run.trace is None or not run.traced:
        return None
    ops = run.trace.ops_under(SPAN)
    if not ops:
        return None
    return sum(o.end - o.start for o in ops) * 1e-3 / len(run.traced)

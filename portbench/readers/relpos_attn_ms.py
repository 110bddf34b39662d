"""Device time per public call of the operations launched inside the program's
span ``fsem.hubert.relpos_attn``: WavLM's gated relative-position attention,
every layer of every row chunk (on the kernel route the ``relpos_attn``
launch; on the plain route the gate, the bias and the attention)."""

SPAN = "fsem.hubert.relpos_attn"


def read(run):
    if run.trace is None or not run.traced:
        return None
    ops = run.trace.ops_under(SPAN)
    if not ops:
        return None
    return sum(o.end - o.start for o in ops) * 1e-3 / len(run.traced)

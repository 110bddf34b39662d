"""Device time per public call of the operations launched inside the
model's entry (the function the configuration names ``model`` under
``trace_ranges``)."""


def read(run):
    if run.trace is None or not run.traced:
        return None
    ops = run.trace.ops_under("model")
    if not ops:
        return None
    return sum(o.end - o.start for o in ops) * 1e-3 / len(run.traced)

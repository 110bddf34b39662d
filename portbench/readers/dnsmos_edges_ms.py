"""Device time per public call of the operations launched inside the program's
span ``fsem.dnsmos.edges``: DNSMOS's per-window edge strips through the
conv stack."""

SPAN = "fsem.dnsmos.edges"


def read(run):
    if run.trace is None or not run.traced:
        return None
    ops = run.trace.ops_under(SPAN)
    if not ops:
        return None
    return sum(o.end - o.start for o in ops) * 1e-3 / len(run.traced)

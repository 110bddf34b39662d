"""Device time per public call of the operations launched inside the program's
span ``fsem.dnsmos.trunk``: DNSMOS's conv trunk on the whole signal, with
pool 3 and conv 6 on its two phases."""

SPAN = "fsem.dnsmos.trunk"


def read(run):
    if run.trace is None or not run.traced:
        return None
    ops = run.trace.ops_under(SPAN)
    if not ops:
        return None
    return sum(o.end - o.start for o in ops) * 1e-3 / len(run.traced)

"""Share of the profiled stretch (the public calls' own time, summed) with
no operation running on the device."""


def read(run):
    if run.trace is None or not run.trace.ops_in_stretch():
        return None
    busy = sum(b - a for a, b in run.trace.busy_intervals())
    return 100.0 * (1.0 - busy / run.trace.stretch_us())

"""Host time per public call inside the program's entry span
(``fsem.entry``: ``BaseMetric.compute``'s coercion and host-to-device
copies of both arrays) in the profiled stretch."""

SPAN = "fsem.entry"


def read(run):
    if run.trace is None or not run.traced:
        return None
    spans = [r for r in run.trace.ranges if r.name == SPAN]
    if not spans:
        return None
    return sum(r.end - r.start for r in spans) * 1e-3 / len(run.traced)

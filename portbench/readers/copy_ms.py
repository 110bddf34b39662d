"""Device time of host-to-device and device-to-host copies per public call
in the profiled stretch."""


def read(run):
    if run.trace is None or not run.traced:
        return None
    copies = [o for o in run.trace.ops_in_stretch() if o.kind == "memcpy" and ("HtoD" in o.name or "DtoH" in o.name)]
    if not copies:
        return None
    return sum(o.end - o.start for o in copies) * 1e-3 / len(run.traced)

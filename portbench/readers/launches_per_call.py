"""Device kernels per public call in the profiled stretch."""


def read(run):
    if run.trace is None or not run.traced:
        return None
    kernels = sum(1 for o in run.trace.ops_in_stretch() if o.kind == "kernel")
    return kernels / len(run.traced) if kernels else None

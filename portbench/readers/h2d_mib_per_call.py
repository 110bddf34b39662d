"""MiB per public call that the program copied from the host to the card in
the profiled stretch: its own count (``tracing.counts["h2d_bytes"]``, taken
only while a profiler records, so over the traced calls alone; one process
runs one cell)."""


def read(run):
    if run.trace is None or not run.traced:
        return None
    try:
        from fast_speech_enhancement_metrics_tpu_torch import tracing
    except ImportError:  # a program without the counter
        return None
    n = tracing.counts.get("h2d_bytes")
    return n / 2**20 / len(run.traced) if n else None

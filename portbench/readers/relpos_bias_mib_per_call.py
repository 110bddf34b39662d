"""MiB per public call of WavLM's gated position bias that the program built as
a tensor in the profiled stretch: its own count
(``tracing.counts["relpos_bias_bytes"]``, taken only while a profiler
records). The kernel route builds none and counts 0; a program without the
counter reports nothing."""


def read(run):
    if run.trace is None or not run.traced:
        return None
    try:
        from fast_speech_enhancement_metrics_tpu_torch import tracing
    except ImportError:
        return None
    n = tracing.counts.get("relpos_bias_bytes")
    return None if n is None else n / 2**20 / len(run.traced)

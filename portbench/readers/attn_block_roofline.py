"""Kernels A7 (attention block) and A8 (FFN block) against their roofline:
the least time of their launches in the profiled stretch, each the larger
of its operations over the bf16 peak and its bytes over the peak
bandwidth, over the device time of what the two launched.

Per launch on x of shape (rows, T, d), with h heads and an FFN of width f
(counts as ``chip_smoke.py`` makes them): A7 does 2 rows T d 3d (QKV) +
4 rows T^2 d (attention) + 2 rows T d d (output) operations and moves
x and y in float32, its four d x d weights in bf16 and six d-vectors in
float32; A8 does 4 rows T d f and moves x and y, its two d x f weights in
bf16 and f + 3d floats."""

from portbench.peaks import least_seconds


def a7(shape, d):
    rows, t, _ = shape
    flops = rows * (2.0 * t * d * 3 * d + 4.0 * t * t * d + 2.0 * t * d * d)
    return flops, 2.0 * rows * t * d * 4 + 4.0 * d * d * 2 + 6.0 * d * 4


def a8(shape, d, f):
    rows, t, _ = shape
    return 4.0 * rows * t * d * f, 2.0 * rows * t * d * 4 + 2.0 * d * f * 2 + (f + 3.0 * d) * 4


def read(run):
    if run.trace is None or run.peaks is None:
        return None
    ops = run.trace.ops_under("attn_block") + run.trace.ops_under("ffn_block")
    device_s = sum(o.end - o.start for o in ops) * 1e-6
    if not device_s:
        return None
    model = run.cell.config["model"]
    d, f = model["hidden_size"], model["intermediate_size"]
    least = sum(least_seconds(*a7(s, d), run.peaks) for s in run.shapes.get("attn_block", []))
    least += sum(least_seconds(*a8(s, d, f), run.peaks) for s in run.shapes.get("ffn_block", []))
    return 100.0 * least / device_s

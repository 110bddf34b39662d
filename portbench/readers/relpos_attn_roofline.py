"""The gated relative-position attention kernel (``relpos_attn``) against its
roofline: the least time of its launches in the profiled stretch, each the
larger of its operations over the bf16 peak and its bytes over the peak
bandwidth, over the device time of what the configuration's range
``relpos_attn`` (the kernel's entry, ``ops/relpos_attention.py``) launched.

Per launch on the product qkvg of shape (rows, T, 3 d + G), with h heads of
hd = d / h: 4 rows h T^2 hd operations (Q K^T and P V); bytes read once or
written once: q, k, v and the context in bf16 (rows T 4 d 2), the gate
logits (rows T 2 h, bf16), the offset vector (h 2 tp floats, tp = T
rounded up to 128) and the gate constants (h floats)."""

from portbench.peaks import least_seconds


def launch(shape, d, heads):
    rows, t, _ = shape
    tp = -(-t // 128) * 128
    flops = 4.0 * rows * heads * t * t * (d // heads)
    nbytes = rows * t * (4.0 * d * 2 + 2.0 * heads * 2) + heads * 2.0 * tp * 4 + heads * 4.0
    return flops, nbytes


def read(run):
    if run.trace is None or run.peaks is None:
        return None
    ops = run.trace.ops_under("relpos_attn")
    device_s = sum(o.end - o.start for o in ops) * 1e-6
    if not device_s:
        return None
    model = run.cell.config["model"]
    d, heads = model["hidden_size"], model["num_attention_heads"]
    least = sum(least_seconds(*launch(s, d, heads), run.peaks) for s in run.shapes.get("relpos_attn", []))
    return 100.0 * least / device_s

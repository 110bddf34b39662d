"""SDR auto/cross correlations: CUDA kernel A4 and its plain version.

Counterpart of the JAX package's ``ops/sdr_corr_gram.py``
(``correlation_lags_gram``): r_auto[l] = sum_t c[t-l] c[t] and r_cross[l] =
sum_t c[t-l] d[t] for l = 0..n_lags-1, zeros outside the signal. The CUDA
kernel (``csrc/sdr_corr_gram.cu``) sums the products directly in the time
domain in float32.

``split`` is the JAX kernel's product class. With hi = bf16(x) and lo =
bf16(x - hi), each product c[t-l] y[t] is formed from the halves: "x4" sums
hh + hl + lh + ll (the float32 product here), "x3" drops ll, "x1" keeps hh.
The TPU kept x3 and x1 to save matrix-unit passes; on this card they save
nothing and exist so that ``SDR(corr_impl="gram" | "gram_x1")`` gives the
reference's results.

The plain version is the package's plain correlation, the overlap-save DFT
matmuls of ``ops/dft.py::correlation_lags``, on the raw signals (x4), or
summed over the split signals: corr(ch, yh) + corr(ch, yl) + corr(cl, yh)
for x3 and corr(ch, yh) for x1. The TPU kernel's shifted-Gram formulation
exists for a 128 x 128 matrix unit and is not kept.
"""

from __future__ import annotations

import torch

from fast_speech_enhancement_metrics_tpu_torch.ops import cuda_lib
from fast_speech_enhancement_metrics_tpu_torch.ops.dft import correlation_lags

KERNEL = "correlation_lags_gram"
#: the launch counter of each split mode; x4 keeps the kernel's own name
KERNELS = {"x4": KERNEL, "x3": f"{KERNEL}_x3", "x1": f"{KERNEL}_x1"}
#: the C entry point's split argument: the terms of hh + hl + lh + ll kept
_SPLIT_TERMS = {"x4": 4, "x3": 3, "x1": 1}
_HB = 128
#: samples of t per block of the CUDA kernel (csrc/sdr_corr_gram.cu, kSlab)
_SLAB = 4096


def _hi_lo(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """bf16 halves as float32: hi = bf16(x), lo = bf16(x - hi)."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _correlation_lags_plain(
    c: torch.Tensor, d: torch.Tensor, n_lags: int, split: str = "x4"
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel A4 in each split mode."""
    if split == "x4":
        r_auto, r_cross = correlation_lags(c, (c, d), n_lags)
        return r_auto, r_cross
    ch, cl = _hi_lo(c)
    dh, dl = _hi_lo(d)
    r_auto, r_cross = correlation_lags(ch, (ch, dh), n_lags)
    if split == "x3":
        for lagged, (ya, yc) in ((ch, (cl, dl)), (cl, (ch, dh))):
            ra, rc = correlation_lags(lagged, (ya, yc), n_lags)
            r_auto, r_cross = r_auto + ra, r_cross + rc
    return r_auto, r_cross


def _correlation_lags_cuda(
    c: torch.Tensor, d: torch.Tensor, n_lags: int, split: str
) -> tuple[torch.Tensor, torch.Tensor]:
    dev = c.device
    cuda_lib.check_operand(c, "c", dev, torch.float32, 2)
    cuda_lib.check_operand(d, "d", dev, torch.float32, 2)
    if n_lags != 512:
        raise NotImplementedError(f"the correlation kernel is built for 512 lags, got {n_lags}")
    batch, t = c.shape
    if batch == 0 or t == 0:
        raise ValueError(f"need at least one row and one sample, got {tuple(c.shape)}")
    n_slabs = -(-t // _SLAB)
    partial = torch.empty(batch, n_slabs, 2, n_lags, device=dev, dtype=torch.float32)
    r_auto = torch.empty(batch, n_lags, device=dev, dtype=torch.float32)
    r_cross = torch.empty(batch, n_lags, device=dev, dtype=torch.float32)
    cuda_lib.launch(KERNEL, dev, c, d, partial, r_auto, r_cross, batch, t, _SPLIT_TERMS[split])
    cuda_lib.launch_counts[KERNELS[split]] += 1
    return r_auto, r_cross


def correlation_lags_gram(
    c: torch.Tensor, d: torch.Tensor, n_lags: int, split: str = "x4"
) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel A4 wrapper: c, d (B, T) float32 -> (r_auto, r_cross), each
    (B, n_lags), with the products of ``split`` ("x4", "x3" or "x1"). CPU
    tensors take the plain version; CUDA tensors launch the kernel (or
    raise); any other device raises."""
    assert c.ndim == 2 and c.shape == d.shape
    assert n_lags % _HB == 0, f"lag count must be a multiple of {_HB}, got {n_lags}"
    if split not in KERNELS:
        raise ValueError(f"split must be one of {tuple(KERNELS)}, got {split!r}")
    if c.device.type == "cpu":
        return _correlation_lags_plain(c, d, n_lags, split)
    if c.device.type != "cuda":
        raise ValueError(f"no correlation kernel for device {c.device}")
    return _correlation_lags_cuda(c, d, n_lags, split)

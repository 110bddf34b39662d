"""SDR correlations with on-chip chunk spectra: CUDA kernel A10 and its plain version.

Counterpart of the JAX package's ``ops/sdr_corr_fused.py``
(``correlation_lags_fused``; kernels ``_corr_kernel`` and
``_corr_kernel_raw``): r_auto[l] = sum_t c[t-l] c[t] and r_cross[l] =
sum_t c[t-l] d[t], l = 0..n_lags-1, by overlap-save over chunks of h =
n_lags samples. Per group of ``chunk_block`` windows the kernel computes
the packed 2h-point chunk spectra ([cos 0..h-1 | cos_h | sin 1..h-1], 2h
columns), combines adjacent chunks into window spectra with (-1)^f, and
reduces the auto and cross spectral products into a (6, h) partial. The
sum over groups, the unpack and the inverse DFT at the lags are plain
PyTorch, as they are XLA in JAX.

The CUDA kernel is ``csrc/sdr_corr_fused.cu``: one kernel for both JAX
variants, counted as ``corr_fused_raw`` (T a multiple of h, the JAX
package's zero-copy ``_corr_kernel_raw``) or ``corr_fused`` (the padded
``_corr_kernel``). CPU tensors take the plain version of the partials;
CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from fast_speech_enhancement_metrics_tpu_torch.ops import cuda_lib
from fast_speech_enhancement_metrics_tpu_torch.ops.dft import _inverse_lag_matrices, _rdft_matrices
from fast_speech_enhancement_metrics_tpu_torch.ops.stft import device_table

KERNEL_A10 = "corr_fused"
KERNEL_A10_RAW = "corr_fused_raw"
#: windows per group of the CUDA kernel (csrc/sdr_corr_fused.cu, kCB)
KERNEL_CHUNK_BLOCK = 128


@functools.lru_cache(maxsize=None)
def _packed_corr_matrix(h: int) -> np.ndarray:
    """(h, 2h) packed [cos 0..h-1 | cos_h | sin 1..h-1] chunk-DFT matrix."""
    cos, sin = _rdft_matrices(2 * h)  # (2h, h+1) each; rows h.. unused here
    return np.concatenate([cos[:h, :h], cos[:h, h:h + 1], sin[:h, 1:h]], axis=1).astype(np.float32)


def _corr_partials_plain(c: torch.Tensor, d: torch.Tensor, h: int, chunk_block: int) -> torch.Tensor:
    """Plain PyTorch version of kernel A10: (B, groups, 6, h) partials."""
    batch, t = c.shape
    n_groups = -(-(-(-t // h)) // chunk_block)
    n_chunks = n_groups * chunk_block
    # window k of c spans c[h k - h : h k + h]: left-pad by h, then chunk
    cc = F.pad(c, (h, n_chunks * h - t)).reshape(batch, n_chunks + 1, h)
    dc = F.pad(d, (0, n_chunks * h - t)).reshape(batch, n_chunks, h)
    w = device_table(_packed_corr_matrix(h), c.device)
    a_c, a_d = cc @ w, dc @ w
    sign = 1.0 - 2.0 * (torch.arange(2 * h, device=c.device) % 2).float()
    a_w = a_c[:, :-1] + sign * a_c[:, 1:]
    re_w, x2_w = a_w[..., :h], a_w[..., h:]

    def sums(a_b):
        re_b, x2_b = a_b[..., :h], a_b[..., h:]
        prods = (re_w * re_b, x2_w * x2_b, x2_w * re_b - re_w * x2_b)
        return [p.reshape(batch, n_groups, chunk_block, h).sum(dim=2) for p in prods]

    return torch.stack(sums(a_c[:, 1:]) + sums(a_d), dim=2)


def _corr_partials_cuda(c: torch.Tensor, d: torch.Tensor, h: int, chunk_block: int) -> torch.Tensor:
    dev = c.device
    cuda_lib.check_operand(c, "c", dev, torch.float32, 2)
    cuda_lib.check_operand(d, "d", dev, torch.float32, 2)
    if chunk_block != KERNEL_CHUNK_BLOCK or h % 32:
        raise ValueError(f"the fused correlation kernel takes chunk_block={KERNEL_CHUNK_BLOCK} and "
                         f"n_lags % 32 == 0, got {chunk_block}, {h}")
    batch, t = c.shape
    if batch == 0 or t == 0:
        raise ValueError(f"need at least one row and one sample, got {tuple(c.shape)}")
    n_groups = -(-(-(-t // h)) // chunk_block)
    partial = torch.empty(batch, n_groups, 6, h, device=dev, dtype=torch.float32)
    table = device_table(_packed_corr_matrix(h), dev)
    cuda_lib.launch("corr_fused", dev, c, d, table, partial, batch, t, h, n_groups)
    cuda_lib.launch_counts[KERNEL_A10_RAW if t % h == 0 else KERNEL_A10] += 1
    return partial


def _lags_from_partials(partial: torch.Tensor, n_lags: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, groups, 6, h) partials -> (r_auto, r_cross): the sum over groups,
    the unpack and the inverse DFT at the lags."""
    h = partial.shape[-1]
    s = torch.sum(partial, dim=1)  # (B, 6, h)

    def unpack(p1, p2, q):
        # bins 0..h: s_re = [P1[0], P1[1..h-1] + P2[1..h-1], P2[0]];
        # s_im = [0, Q[1..h-1], 0] (bins 0 and h are real)
        s_re = torch.cat([p1[:, :1], p1[:, 1:] + p2[:, 1:], p2[:, :1]], dim=1)
        zero = torch.zeros_like(q[:, :1])
        return s_re, torch.cat([zero, q[:, 1:], zero], dim=1)

    icos_np, isin_np = _inverse_lag_matrices(h, n_lags)
    icos, isin = device_table(icos_np, s.device), device_table(isin_np, s.device)

    def idft(s_re, s_im):
        return s_re @ icos - s_im @ isin

    return idft(*unpack(s[:, 0], s[:, 1], s[:, 2])), idft(*unpack(s[:, 3], s[:, 4], s[:, 5]))


def _correlation_lags_fused_plain(
    c: torch.Tensor, d: torch.Tensor, n_lags: int, chunk_block: int = 128
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``correlation_lags_fused`` (any device)."""
    return _lags_from_partials(_corr_partials_plain(c.float(), d.float(), n_lags, chunk_block), n_lags)


def correlation_lags_fused(
    c: torch.Tensor, d: torch.Tensor, n_lags: int, chunk_block: int = 128
) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel A10 wrapper: c, d (B, T) -> (r_auto, r_cross), each (B, n_lags),
    with ``r[l] = sum_t c[t-l] * y[t]``."""
    assert c.ndim == 2 and c.shape == d.shape
    # the packed (-1)^f window combine reuses one sign vector across both
    # column blocks, which needs the Nyquist bin (col h, sign (-1)^h) even
    assert n_lags % 2 == 0, f"fused correlations require even n_lags, got {n_lags}"
    if c.device.type == "cpu":
        return _correlation_lags_fused_plain(c, d, n_lags, chunk_block)
    if c.device.type != "cuda":
        raise ValueError(f"no correlation kernel for device {c.device}")
    partial = _corr_partials_cuda(c.float().contiguous(), d.float().contiguous(), n_lags, chunk_block)
    return _lags_from_partials(partial, n_lags)

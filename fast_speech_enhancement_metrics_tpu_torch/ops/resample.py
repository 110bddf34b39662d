"""Polyphase windowed-sinc resampling as block matmuls.

Counterpart of the JAX package's ``ops/resample.py``: the classic
band-limited interpolation resampler (the algorithm of torchaudio's
``Resample``), with the kernel bank built once in float64 numpy and folded
into one block matrix, applied as a few float32 matmuls on shifted views of
the zero-copy block reshape.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from fast_speech_enhancement_metrics_tpu_torch.ops.stft import device_table


@functools.lru_cache(maxsize=None)
def sinc_resample_kernel(
    orig_freq: int,
    new_freq: int,
    lowpass_filter_width: int = 6,
    rolloff: float = 0.99,
) -> tuple[np.ndarray, int, int, int]:
    """Build the polyphase kernel bank.

    Returns (kernel[(phases, K)], width, orig_freq_reduced, new_freq_reduced).
    """
    gcd = math.gcd(orig_freq, new_freq)
    orig = orig_freq // gcd
    new = new_freq // gcd

    base_freq = min(orig, new) * rolloff
    width = int(math.ceil(lowpass_filter_width * orig / base_freq))

    # time grid: one row per output phase, columns spanning the kernel support
    idx = np.arange(-width, width + orig, dtype=np.float64) / orig
    phase = np.arange(0, -new, -1, dtype=np.float64)[:, None] / new
    t = (phase + idx[None, :]) * base_freq
    t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)

    window = np.cos(t * np.pi / lowpass_filter_width / 2.0) ** 2
    t = t * np.pi
    kernel = np.where(t == 0.0, 1.0, np.sin(t) / np.where(t == 0.0, 1.0, t))
    kernel = kernel * window * (base_freq / orig)
    return kernel.astype(np.float32), width, orig, new


@functools.lru_cache(maxsize=None)
def _block_resample_matrix(
    orig_freq: int, new_freq: int, lowpass_filter_width: int = 6,
    rolloff: float = 0.99,
) -> tuple[np.ndarray, int, int, int, int, int]:
    """Fold ``bs`` polyphase frames into one block matrix.

    Processes ``bs*orig`` input samples -> ``bs*new`` output samples per
    block with one (n_sub*in_blk, out_blk) matrix: M[i, q] = kernel[q % new,
    i - orig*(q // new)], applied as ``n_sub`` matmuls on shifted views of
    the block reshape.
    """
    kernel, width, orig, new = sinc_resample_kernel(
        orig_freq, new_freq, lowpass_filter_width, rolloff
    )
    k = kernel.shape[1]
    bs = max(1, -(-128 // orig))  # input block >= 128 samples
    in_blk = bs * orig
    out_blk = bs * new
    span = orig * (bs - 1) + k  # input samples touched by one output block
    n_sub = -(-span // in_blk)
    m = np.zeros((n_sub * in_blk, out_blk), np.float64)
    for q in range(out_blk):
        p, f = q % new, q // new
        m[orig * f : orig * f + k, q] = kernel[p]
    return m.astype(np.float32), width, orig, new, bs, k


@functools.lru_cache(maxsize=None)
def _block_resample_parts(orig_freq: int, new_freq: int, **kw) -> tuple[np.ndarray, ...]:
    """The block matrix cut into its ``n_sub`` (in_blk, out_blk) row slabs."""
    m, _, orig, _, bs, _ = _block_resample_matrix(orig_freq, new_freq, **kw)
    in_blk = bs * orig
    return tuple(
        np.ascontiguousarray(m[s * in_blk : (s + 1) * in_blk])
        for s in range(m.shape[0] // in_blk)
    )


def resample(x: torch.Tensor, orig_freq: int, new_freq: int, **kw) -> torch.Tensor:
    """Resample (..., T) from orig_freq to new_freq. No-op if rates match."""
    if orig_freq == new_freq:
        return x
    _, width, orig, new, bs, k = _block_resample_matrix(orig_freq, new_freq, **kw)
    parts = _block_resample_parts(orig_freq, new_freq, **kw)
    t = x.shape[-1]
    target_length = -(-new * t // orig)  # ceil

    in_blk, out_blk = bs * orig, bs * new
    n_sub = len(parts)
    # frame count matches the classic polyphase form (pad width left,
    # width + orig right); blocks round up so every shifted chunk view exists
    f_total = 1 + (t + 2 * width + orig - k) // orig
    c_blocks = -(-f_total // bs)
    need = (c_blocks + n_sub - 1) * in_blk
    xp = F.pad(x, (width, need - t - width))
    chunks = xp.reshape(x.shape[:-1] + (c_blocks + n_sub - 1, in_blk))

    out = None
    for s, ms in enumerate(parts):
        o_s = chunks[..., s : s + c_blocks, :] @ device_table(ms, x.device)
        out = o_s if out is None else out + o_s
    out = out.reshape(x.shape[:-1] + (c_blocks * out_blk,))
    return out[..., :target_length]

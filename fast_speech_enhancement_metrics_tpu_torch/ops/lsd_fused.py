"""Fused LSD (log-spectral distance): CUDA kernel A1 and its plain version.

Counterpart of the JAX package's ``ops/lsd_fused.py``. Only the branch the
main path takes is here: raw hop-aligned pairs with the projection scale
computed by the kernel (``denoised_scale="auto"``), the JAX package's
``_lsd_wholesig_raw_kernel``. Two ideas carry it:

* **Shared-chunk DFT.** With hop = n_fft/2, frame f = [chunk_{f-1} |
  chunk_f] of the centered signal, so the frame spectrum is X_f[k] =
  A_{f-1}[k] + (-1)^k A_f[k] with A_j the n_fft-point DFT of raw chunk j:
  one (hop x n_fft) product per chunk instead of two per frame.
* **Frequency-domain Hann.** The periodic Hann window is the exact 3-tap
  convolution Y[k] = 0.5 X[k] - 0.25 (X[k-1] + X[k+1]), with
  X[-1] = conj X[1] and X[n_fft/2 + 1] = conj X[n_fft/2 - 1].

The CUDA kernel is ``csrc/lsd_fused.cu``. ``lsd_scores`` launches it for
CUDA tensors and runs ``_lsd_wholesig_raw_plain`` for CPU tensors.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from fast_speech_enhancement_metrics_tpu_torch.ops import cuda_lib
from fast_speech_enhancement_metrics_tpu_torch.ops.dft import _chunk_rdft_matrix_packed
from fast_speech_enhancement_metrics_tpu_torch.ops.stft import device_table

KERNEL = "lsd_wholesig_raw"
#: frames per block of the CUDA kernel (csrc/lsd_fused.cu, kTileFrames)
_TILE_FRAMES = 16
#: blocks per row of the kernel's scale reduction (kScaleSplits)
_SCALE_SPLITS = 16


def _hann_power(xre: torch.Tensor, xim: torch.Tensor, xnyq: torch.Tensor) -> torch.Tensor:
    """(..., F, nb) unwindowed frame spectra (bins 0..nb-1) + real Nyquist
    column (..., F, 1) -> windowed |Y|^2 over bins 0..nb, (..., F, nb+1)."""
    # neighbours with X[-1] = conj X[1], X[nb] = Nyquist, X[nb+1] = conj X[nb-1]
    re = torch.cat([xre, xnyq], dim=-1)
    im = F.pad(xim, (0, 1))
    left_re = torch.cat([re[..., 1:2], re[..., :-1]], dim=-1)
    left_im = torch.cat([-im[..., 1:2], im[..., :-1]], dim=-1)
    right_re = torch.cat([re[..., 1:], re[..., -2:-1]], dim=-1)
    right_im = torch.cat([im[..., 1:], -im[..., -2:-1]], dim=-1)
    yre = 0.5 * re - 0.25 * (left_re + right_re)
    yim = 0.5 * im - 0.25 * (left_im + right_im)
    return yre * yre + yim * yim


def _frame_powers(chunks: torch.Tensor) -> torch.Tensor:
    """(B, NC, hop) raw chunks -> windowed power spectra of the NC + 1
    centered frames, (B, NC + 1, hop + 1)."""
    hop = chunks.shape[-1]
    a = chunks @ device_table(_chunk_rdft_matrix_packed(2 * hop), chunks.device)
    alt = 1.0 - 2.0 * (torch.arange(hop, device=chunks.device) % 2).to(chunks.dtype)
    nyq = (chunks * alt).sum(dim=-1, keepdim=True)  # (B, NC, 1) chunk Nyquist
    # zero chunks on both sides are the centered STFT's padding
    a = F.pad(a, (0, 0, 1, 1))
    nyq = F.pad(nyq, (0, 0, 1, 1))
    sign = alt  # (-1)^k over bins 0..hop-1
    are, aim = a[..., :hop], a[..., hop:]
    xre = are[..., :-1, :] + sign * are[..., 1:, :]
    xim = aim[..., :-1, :] + sign * aim[..., 1:, :]
    xnyq = nyq[..., :-1, :] + nyq[..., 1:, :]  # (-1)^hop = +1
    return _hann_power(xre, xim, xnyq)


def _lsd_wholesig_raw_plain(
    clean: torch.Tensor, denoised: torch.Tensor, hop: int, eps: float
) -> torch.Tensor:
    """Plain PyTorch version of kernel A1: same arithmetic, as tensor ops."""
    batch, t = clean.shape
    scale = torch.sum(clean * denoised, dim=1, keepdim=True) / (
        torch.sum(denoised * denoised, dim=1, keepdim=True) + eps
    )
    c = clean.reshape(batch, t // hop, hop)
    d = (denoised * scale).reshape(batch, t // hop, hop)
    c_sq = _frame_powers(c)
    d_sq = _frame_powers(d)
    d_mag = torch.sqrt(d_sq) + eps
    log_ratio = torch.log(c_sq / (d_mag * d_mag) + eps)
    frame_ms = torch.mean(log_ratio * log_ratio, dim=-1)  # (B, NC + 1)
    return torch.mean(torch.sqrt(frame_ms), dim=-1)


def _lsd_wholesig_raw_cuda(
    clean: torch.Tensor, denoised: torch.Tensor, hop: int, eps: float
) -> torch.Tensor:
    dev = clean.device
    batch, t = clean.shape
    cuda_lib.check_operand(clean, "clean", dev, torch.float32, 2)
    cuda_lib.check_operand(denoised, "denoised", dev, torch.float32, 2)
    if denoised.shape != clean.shape:
        raise ValueError(f"shape mismatch {tuple(clean.shape)} vs {tuple(denoised.shape)}")
    if hop != 256:
        raise NotImplementedError(f"the LSD kernel is built for hop 256, got {hop}")
    nc = t // hop
    if batch == 0 or nc == 0:
        raise ValueError(f"need at least one row and one chunk, got {tuple(clean.shape)}")
    n_tiles = -(-(nc + 1) // _TILE_FRAMES)
    table = device_table(_chunk_rdft_matrix_packed(2 * hop), dev)
    scale_partial = torch.empty(batch, _SCALE_SPLITS, 2, device=dev, dtype=torch.float32)
    partial = torch.empty(batch, n_tiles, device=dev, dtype=torch.float32)
    out = torch.empty(batch, device=dev, dtype=torch.float32)
    cuda_lib.launch(KERNEL, dev, clean, denoised, table, scale_partial, partial, out, batch, nc, eps)
    cuda_lib.launch_counts[KERNEL] += 1
    return out


def lsd_wholesig_raw(
    clean: torch.Tensor, denoised: torch.Tensor, hop: int, eps: float
) -> torch.Tensor:
    """Kernel A1 wrapper: (B, T) float32 pairs with T % hop == 0 -> (B,) LSD.

    CPU tensors take the plain version; CUDA tensors launch the kernel (or
    raise); any other device raises.
    """
    if clean.device.type == "cpu":
        return _lsd_wholesig_raw_plain(clean, denoised, hop, eps)
    if clean.device.type != "cuda":
        raise ValueError(f"no LSD kernel for device {clean.device}")
    return _lsd_wholesig_raw_cuda(clean, denoised, hop, eps)


def lsd_scores(
    clean: torch.Tensor,
    denoised: torch.Tensor,
    n_fft: int,
    hop: int,
    eps: float,
    denoised_scale: str | None = "auto",
) -> torch.Tensor:
    """Centered-STFT LSD of (B, T) pairs -> (B,) scores, fully fused.

    ``denoised_scale="auto"``: the least-squares projection scale of the
    denoised signal is computed in the kernel. Only hop-aligned clips
    (T % hop == 0) with that scale are ported so far; the other branches of
    the JAX package's ``lsd_scores`` need kernels A2 (pre-scaled or
    non-aligned clips) and A3 (frame-blocked long clips).
    """
    assert n_fft == 2 * hop, "fused LSD requires 50% overlap"
    t = clean.shape[-1]
    if denoised_scale != "auto" or t % hop:
        raise NotImplementedError(
            "lsd_scores: only hop-aligned clips with denoised_scale='auto' are "
            "ported (kernel A1); this input needs kernel A2 "
            "(_lsd_wholesig_kernel), not yet ported"
        )
    return lsd_wholesig_raw(clean, denoised, hop, eps)

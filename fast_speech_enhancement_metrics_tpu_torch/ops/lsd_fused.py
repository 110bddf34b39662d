"""Fused LSD (log-spectral distance): CUDA kernels A1, A2, A3 and their plain versions.

Counterpart of the JAX package's ``ops/lsd_fused.py`` and of its
``lsd_scores`` dispatch:

* A1 (``_lsd_wholesig_raw_kernel``): raw hop-aligned pairs, the projection
  scale computed by the kernel (``denoised_scale="auto"``);
* A2 (``_lsd_wholesig_kernel``): pre-scaled pairs of any length with
  F + 1 <= ``MAX_WHOLESIG_CHUNKS`` frames;
* A3 (``_lsd_framed_kernel``): the same function past that, frame-blocked.

On the card the three are one frame-tile kernel, ``csrc/lsd_fused.cu``:
A1 with its scale stage, A2 and A3 without (one C entry point, counted
under each kernel's own name). Two ideas carry it:

* **Shared-chunk DFT.** With hop = n_fft/2, frame f = [chunk_{f-1} |
  chunk_f] of the centered signal, so the frame spectrum is X_f[k] =
  A_{f-1}[k] + (-1)^k A_f[k] with A_j the n_fft-point DFT of raw chunk j:
  one (hop x n_fft) product per chunk instead of two per frame.
* **Frequency-domain Hann.** The periodic Hann window is the exact 3-tap
  convolution Y[k] = 0.5 X[k] - 0.25 (X[k-1] + X[k+1]), with
  X[-1] = conj X[1] and X[n_fft/2 + 1] = conj X[n_fft/2 - 1].

``lsd_scores`` launches the kernel for CUDA tensors and runs the plain
versions (``_lsd_wholesig_raw_plain``, ``_lsd_wholesig_plain``,
``_lsd_framed_plain``) for CPU tensors.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from fast_speech_enhancement_metrics_tpu_torch.ops import cuda_lib
from fast_speech_enhancement_metrics_tpu_torch.ops.dft import _chunk_rdft_matrix_packed
from fast_speech_enhancement_metrics_tpu_torch.ops.stft import device_table

KERNEL = "lsd_wholesig_raw"  # A1
KERNEL_A2 = "lsd_wholesig"
KERNEL_A3 = "lsd_framed"
#: frames + 1 above which the JAX package takes the frame-blocked kernel
#: (A3); kept so the port's launch counts follow the same routes
MAX_WHOLESIG_CHUNKS = 1024
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


def _pair_powers(chunks: torch.Tensor) -> torch.Tensor:
    """(B, N, hop) consecutive chunks -> windowed power spectra of the N - 1
    frames [chunk i | chunk i + 1], (B, N - 1, hop + 1)."""
    hop = chunks.shape[-1]
    a = chunks @ device_table(_chunk_rdft_matrix_packed(2 * hop), chunks.device)
    alt = 1.0 - 2.0 * (torch.arange(hop, device=chunks.device) % 2).to(chunks.dtype)
    nyq = (chunks * alt).sum(dim=-1, keepdim=True)  # (B, N, 1) chunk Nyquist
    sign = alt  # (-1)^k over bins 0..hop-1
    are, aim = a[..., :hop], a[..., hop:]
    xre = are[..., :-1, :] + sign * are[..., 1:, :]
    xim = aim[..., :-1, :] + sign * aim[..., 1:, :]
    xnyq = nyq[..., :-1, :] + nyq[..., 1:, :]  # (-1)^hop = +1
    return _hann_power(xre, xim, xnyq)


def _frame_powers(chunks: torch.Tensor) -> torch.Tensor:
    """(B, NC, hop) raw chunks -> windowed power spectra of the NC + 1
    centered frames, (B, NC + 1, hop + 1); the zero chunks on both sides
    are the centered STFT's padding."""
    return _pair_powers(F.pad(chunks, (0, 0, 1, 1)))


def _frame_lsd(c_sq: torch.Tensor, d_sq: torch.Tensor, eps: float) -> torch.Tensor:
    """Power spectra (..., F, bins) -> per-frame sqrt(mean log-ratio^2), (..., F)."""
    d_mag = torch.sqrt(d_sq) + eps
    log_ratio = torch.log(c_sq / (d_mag * d_mag) + eps)
    return torch.sqrt(torch.mean(log_ratio * log_ratio, dim=-1))


def _padded_chunks(x: torch.Tensor, hop: int) -> torch.Tensor:
    """(B, T) -> (B, F + 1, hop) chunks of the centered signal, F = 1 + T // hop:
    chunk 0 is the left padding, chunk F the signal's tail and right padding."""
    batch, t = x.shape
    f = 1 + t // hop
    return F.pad(x, (hop, (f + 1) * hop - t - hop)).reshape(batch, f + 1, hop)


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
    return torch.mean(_frame_lsd(_frame_powers(c), _frame_powers(d), eps), dim=-1)


def _lsd_wholesig_plain(clean: torch.Tensor, denoised: torch.Tensor, hop: int, eps: float) -> torch.Tensor:
    """Plain PyTorch version of kernel A2: pre-scaled (B, T) pairs, any T."""
    c, d = _padded_chunks(clean, hop), _padded_chunks(denoised, hop)
    return torch.mean(_frame_lsd(_pair_powers(c), _pair_powers(d), eps), dim=-1)


#: plain version of kernel A3: A2's function (the TPU kernel's frame blocks
#: only keep a long signal within VMEM)
_lsd_framed_plain = _lsd_wholesig_plain


def _lsd_wholesig_raw_cuda(
    clean: torch.Tensor, denoised: torch.Tensor, hop: int, eps: float
) -> torch.Tensor:
    _check_pair(clean, denoised, hop)
    dev = clean.device
    batch, t = clean.shape
    nc = t // hop
    if nc == 0 or t % hop:
        raise ValueError(f"need whole chunks of {hop} samples, got {tuple(clean.shape)}")
    n_tiles = -(-(nc + 1) // _TILE_FRAMES)
    table = device_table(_chunk_rdft_matrix_packed(2 * hop), dev)
    scale_partial = torch.empty(batch, _SCALE_SPLITS, 2, device=dev, dtype=torch.float32)
    partial = torch.empty(batch, n_tiles, device=dev, dtype=torch.float32)
    out = torch.empty(batch, device=dev, dtype=torch.float32)
    cuda_lib.launch(KERNEL, dev, clean, denoised, table, scale_partial, partial, out, batch, nc, eps)
    cuda_lib.launch_counts[KERNEL] += 1
    return out


def _check_pair(clean: torch.Tensor, denoised: torch.Tensor, hop: int) -> None:
    dev = clean.device
    cuda_lib.check_operand(clean, "clean", dev, torch.float32, 2)
    cuda_lib.check_operand(denoised, "denoised", dev, torch.float32, 2)
    if denoised.shape != clean.shape:
        raise ValueError(f"shape mismatch {tuple(clean.shape)} vs {tuple(denoised.shape)}")
    if hop != 256:
        raise NotImplementedError(f"the LSD kernel is built for hop 256, got {hop}")
    if clean.shape[0] == 0:
        raise ValueError(f"need at least one row, got {tuple(clean.shape)}")


def _lsd_wholesig_cuda(
    clean: torch.Tensor, denoised: torch.Tensor, hop: int, eps: float, kernel: str
) -> torch.Tensor:
    """Launch the scale-free frame-tile kernel (A2 and A3 on this card)."""
    _check_pair(clean, denoised, hop)
    dev = clean.device
    batch, t = clean.shape
    n_tiles = -(-(1 + t // hop) // _TILE_FRAMES)
    table = device_table(_chunk_rdft_matrix_packed(2 * hop), dev)
    partial = torch.empty(batch, n_tiles, device=dev, dtype=torch.float32)
    out = torch.empty(batch, device=dev, dtype=torch.float32)
    cuda_lib.launch("lsd_wholesig", dev, clean, denoised, table, partial, out, batch, t, eps)
    cuda_lib.launch_counts[kernel] += 1
    return out


def _dispatch(clean: torch.Tensor, plain, cuda):
    """CPU tensors take the plain version, CUDA tensors the kernel; any
    other device raises."""
    if clean.device.type == "cpu":
        return plain()
    if clean.device.type != "cuda":
        raise ValueError(f"no LSD kernel for device {clean.device}")
    return cuda()


def lsd_wholesig(clean: torch.Tensor, denoised: torch.Tensor, hop: int, eps: float) -> torch.Tensor:
    """Kernel A2 wrapper: pre-scaled (B, T) float32 pairs, any T -> (B,) LSD."""
    return _dispatch(
        clean,
        lambda: _lsd_wholesig_plain(clean, denoised, hop, eps),
        lambda: _lsd_wholesig_cuda(clean, denoised, hop, eps, KERNEL_A2),
    )


def lsd_framed(clean: torch.Tensor, denoised: torch.Tensor, hop: int, eps: float) -> torch.Tensor:
    """Kernel A3 wrapper: A2's function for long clips (F + 1 > 1024 frames)."""
    return _dispatch(
        clean,
        lambda: _lsd_framed_plain(clean, denoised, hop, eps),
        lambda: _lsd_wholesig_cuda(clean, denoised, hop, eps, KERNEL_A3),
    )


def lsd_wholesig_raw(
    clean: torch.Tensor, denoised: torch.Tensor, hop: int, eps: float
) -> torch.Tensor:
    """Kernel A1 wrapper: (B, T) float32 pairs with T % hop == 0 -> (B,) LSD.

    CPU tensors take the plain version; CUDA tensors launch the kernel (or
    raise); any other device raises.
    """
    return _dispatch(
        clean,
        lambda: _lsd_wholesig_raw_plain(clean, denoised, hop, eps),
        lambda: _lsd_wholesig_raw_cuda(clean, denoised, hop, eps),
    )


def lsd_scores(
    clean: torch.Tensor,
    denoised: torch.Tensor,
    n_fft: int,
    hop: int,
    eps: float,
    denoised_scale: str | torch.Tensor | None = "auto",
) -> torch.Tensor:
    """Centered-STFT LSD of (B, T) pairs -> (B,) scores, fully fused; any T.

    ``denoised_scale``: ``"auto"`` projects the denoised signal onto the
    clean one (least-squares scale), a (B,) or (B, 1) tensor is that scale
    given, ``None`` means ``denoised`` is already scaled. The routes follow
    the JAX package's ``lsd_scores``: hop-aligned clips with ``"auto"`` take
    A1, which computes the scale itself; everything else is scaled here and
    takes A2, or A3 past ``MAX_WHOLESIG_CHUNKS``.
    """
    assert n_fft == 2 * hop, "fused LSD requires 50% overlap"
    t = clean.shape[-1]
    if isinstance(denoised_scale, str):
        if denoised_scale != "auto":
            raise ValueError(f"denoised_scale must be 'auto', a tensor or None, got {denoised_scale!r}")
        if t % hop == 0:
            return lsd_wholesig_raw(clean, denoised, hop, eps)
        denoised_scale = torch.sum(clean * denoised, dim=1) / (torch.sum(denoised * denoised, dim=1) + eps)
    if denoised_scale is not None:
        denoised = denoised * denoised_scale.reshape(-1, 1)
    if (1 + t // hop) + 1 <= MAX_WHOLESIG_CHUNKS:
        return lsd_wholesig(clean, denoised, hop, eps)
    return lsd_framed(clean, denoised, hop, eps)

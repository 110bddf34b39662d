"""Fused LSD (log-spectral distance): CUDA kernels A1, A2, A3, A13 and their plain versions.

Counterpart of the JAX package's ``ops/lsd_fused.py`` and of its
``lsd_scores`` dispatch:

* A1 (``_lsd_wholesig_raw_kernel``): raw hop-aligned pairs, the projection
  scale computed by the kernel (``denoised_scale="auto"``);
* A2 (``_lsd_wholesig_kernel``): pre-scaled pairs of any length with
  F + 1 <= ``MAX_WHOLESIG_CHUNKS`` frames;
* A3 (``_lsd_framed_kernel``): the same function past that, frame-blocked;
* A13 (``_lsd_wholesig_ct_kernel``, ``dft_impl="ct"``): A1's function with
  the 512-point chunk DFT factorized into three radix-2 DIF folds and eight
  64-point branch DFTs (``_ct_constants``); on the card each branch DFT is
  a float32 FFT (``_ct_fft_reference`` spells out its dataflow).

On the card A1-A3 are one frame-tile kernel on the tensor cores,
``csrc/lsd_fused.cu``: A1 with the projection scale applied in its split
pass, A2 and A3 without (one C entry point, counted under each kernel's own
name); A13 is a second kernel in the same source, a float32 FFT over
tiles of 63 frames. Three ideas carry them:

* **Shared-chunk DFT.** With hop = n_fft/2, frame f = [chunk_{f-1} |
  chunk_f] of the centered signal, so the frame spectrum is X_f[k] =
  A_{f-1}[k] + (-1)^k A_f[k] with A_j the n_fft-point DFT of raw chunk j:
  one (hop x n_fft) product per chunk instead of two per frame.
* **Frequency-domain Hann.** The periodic Hann window is the exact 3-tap
  convolution Y[k] = 0.5 X[k] - 0.25 (X[k-1] + X[k+1]), with
  X[-1] = conj X[1] and X[n_fft/2 + 1] = conj X[n_fft/2 - 1].
* **Halo bin tiles** (A1-A3). The chunk DFT is a bf16x6 tensor-core
  product: the signals and the table in three bf16 pieces each
  (``split_pieces``, ``_tile_table_pieces``), the six products of order
  <= 2^-16, the main product x0w0 added last. Its columns come in five
  tiles of 64 bins k = 62 t - 1 .. 62 t + 62, straight from the DFT
  formula: 62 output bins and a halo bin on each side for the Hann taps;
  the per-frame sums of the five tiles are added in tile order
  (``_lsd_tiles_reference`` spells out the dataflow).

``lsd_scores`` launches the kernels for CUDA tensors and runs the plain
versions (``_lsd_wholesig_raw_plain``, ``_lsd_wholesig_plain``,
``_lsd_framed_plain``, ``_lsd_wholesig_ct_plain``) for CPU tensors.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from fast_speech_enhancement_metrics_tpu_torch.ops import cuda_lib
from fast_speech_enhancement_metrics_tpu_torch.ops.dft import _chunk_rdft_matrix_packed
from fast_speech_enhancement_metrics_tpu_torch.ops.stft import device_table

KERNEL = "lsd_wholesig_raw"  # A1
KERNEL_A2 = "lsd_wholesig"
KERNEL_A3 = "lsd_framed"
KERNEL_A13 = "lsd_wholesig_ct"
#: frames + 1 above which the JAX package takes the frame-blocked kernel
#: (A3) for clips that are scaled before the kernel. The port sends every
#: hop-aligned "auto" clip to A1 whatever its chunk count (the JAX package
#: only when ``nc % 8 == 0`` and F + 1 <= this); only A13's route follows
#: the JAX package's chunk conditions (``_takes_ct``)
MAX_WHOLESIG_CHUNKS = 1024
#: the frame-tile kernel's bin tiles (csrc/lsd_fused.cu, tiles::): 5 tiles
#: of 64 bins, 62 output bins and a halo bin on each side
_TILES, _TILE_BINS, _OUT_BINS = 5, 64, 62
#: frames per group of the frame-tile kernel (tiles::kFrames): its 128
#: chunk rows per signal fill two m64 tiles
_GROUP_FRAMES = 127
#: launches of the three-piece split pass alone (``split_pieces`` on a
#: CUDA tensor); A1-A3 run it inside their own launches
KERNEL_SPLIT = "lsd_split"
#: blocks per row of the kernel's scale reduction (kScaleSplits)
_SCALE_SPLITS = 16
#: frames per tile of A13's kernel (fft::kTileFrames); a tile transforms
#: 64 chunks of each signal
_CT_TILE_FRAMES = 63
#: float32 operations of A13's FFT per chunk and signal (``fft::``): the
#: folds 4 480, 64 DFT8s 3 840, the W64 twiddles 3 072, 64 half DFT8s
#: 3 328, the Nyquist bin 256
CT_FFT_OPS = 14976


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


@functools.lru_cache(maxsize=None)
def _ct_constants() -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Tables of the factorized (radix-2 DIF) one-sided real chunk DFT, built
    in float64 and rounded to float32, as the JAX package's ``_ct_constants``.

    The 512-point DFT of a zero-padded 256-sample chunk is three DIF folds
    followed by eight 64-point DFTs of the branches br = j1 + 2 j2 + 4 j3,
    DFT512(x)[8 m + br] = DFT64(b_br)[m]; bins 0..255 need m = 0..31.
    Returns ``tw`` (8, 256): the fold twiddles [w1re, w1im, w2re|0, w2im|0,
    w3re|0, w3im|0, 0, 0] (w_l[t] = exp(-2 pi i t / (1024 / 2^l))); ``w0``
    (64, 64): a real branch to packed [Re(32) | Im(32)]; ``wc`` (128, 64): a
    packed [re(64) | im(64)] complex branch likewise.
    """
    tw = np.zeros((8, 256), dtype=np.float64)
    t1 = np.arange(256)
    tw[0] = np.cos(-2 * np.pi * t1 / 512)
    tw[1] = np.sin(-2 * np.pi * t1 / 512)
    t2 = np.arange(128)
    tw[2, :128] = np.cos(-2 * np.pi * t2 / 256)
    tw[3, :128] = np.sin(-2 * np.pi * t2 / 256)
    t3 = np.arange(64)
    tw[4, :64] = np.cos(-2 * np.pi * t3 / 128)
    tw[5, :64] = np.sin(-2 * np.pi * t3 / 128)
    ang = -2 * np.pi * np.outer(np.arange(64), np.arange(32)) / 64
    c, s = np.cos(ang), np.sin(ang)
    w0 = np.concatenate([c, s], axis=1)
    wc = np.block([[c, s], [-s, c]])
    return tw.astype(np.float32), w0.astype(np.float32), wc.astype(np.float32)


def _ct_branch_spectra(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., NC, 256) real chunks -> (packed one-sided branch spectra
    (..., NC, 8, 64) as [Re(32) | Im(32)] per branch br = 0..7, chunk
    Nyquist bins (..., NC, 1)): the three folds (branch 0's path stays
    real), then the seven complex branches through ``wc`` and branch 0
    through ``w0``."""
    tw, w0, wc = (device_table(a, x.device) for a in _ct_constants())
    w1re, w1im = tw[0], tw[1]
    w2re, w2im = tw[2, :128], tw[3, :128]
    w3re, w3im = tw[4, :64], tw[5, :64]

    def fold(vre, vim, half, wre, wim):
        """One DIF level on a complex (vim not None) or real slab: (sum, difference x twiddle)."""
        are, bre = vre[..., :half], vre[..., half:]
        if vim is None:
            d = are - bre
            return (are + bre, None), (d * wre, d * wim)
        aim, bim = vim[..., :half], vim[..., half:]
        dre, dim = are - bre, aim - bim
        return (are + bre, aim + bim), (dre * wre - dim * wim, dre * wim + dim * wre)

    b1 = (x * w1re, x * w1im)
    e00, o01 = fold(x, None, 128, w2re, w2im)
    e10, o11 = fold(*b1, 128, w2re, w2im)
    (br0, _), br4 = fold(*e00, 64, w3re, w3im)
    br1, br5 = fold(*e10, 64, w3re, w3im)
    br2, br6 = fold(*o01, 64, w3re, w3im)
    br3, br7 = fold(*o11, 64, w3re, w3im)
    complex_branches = torch.stack(
        [torch.cat(b, dim=-1) for b in (br1, br2, br3, br4, br5, br6, br7)], dim=-2
    )  # (..., NC, 7, 128)
    z = torch.cat([(br0 @ w0).unsqueeze(-2), complex_branches @ wc], dim=-2)
    return z, _chunk_nyquist(x)


def _chunk_nyquist(x: torch.Tensor) -> torch.Tensor:
    alt = 1.0 - 2.0 * (torch.arange(x.shape[-1], device=x.device) % 2).to(x.dtype)
    return (x * alt).sum(dim=-1, keepdim=True)


def _ct_hann_power(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Frame spectra in the scrambled layout k = 8 m + br, (..., F, 8, 64)
    packed, and their real Nyquist bins (..., F, 1) -> windowed |Y|^2 of
    the 257 one-sided bins, (..., F, 257) in the order (br 0..7 by m), then
    bin 256.

    X[k -+ 1] sits in branch br -+ 1 at the same m, except the two carries:
    (br 0, m) - 1 is (br 7, m - 1), whose bin k = 0 takes X[-1] = conj X[1]
    instead, and (br 7, m) + 1 is (br 0, m + 1), whose bin 255 takes the
    real X[256] instead."""
    lanes = torch.arange(64, device=x.device)
    half_sign = torch.where(lanes < 32, 1.0, -1.0).to(x.dtype)  # conj in the packed layout
    br0, br7 = x[..., 0, :], x[..., 7, :]
    prev7 = torch.where((lanes == 0) | (lanes == 32), half_sign * x[..., 1, :], torch.roll(br7, 1, dims=-1))
    next0 = torch.roll(br0, -1, dims=-1)
    next0 = torch.where(lanes == 31, q, torch.where(lanes == 63, torch.zeros_like(next0), next0))
    left = torch.cat([prev7.unsqueeze(-2), x[..., :7, :]], dim=-2)
    right = torch.cat([x[..., 1:, :], next0.unsqueeze(-2)], dim=-2)
    y = 0.5 * x - 0.25 * (left + right)
    power = (y[..., :32] ** 2 + y[..., 32:] ** 2).flatten(-2)  # (..., F, 256)
    ynyq = 0.5 * q - 0.5 * br7[..., 31:32]  # bin 256: X[257] = conj X[255]
    return torch.cat([power, ynyq * ynyq], dim=-1)


#: (-1)^br of the eight branches, (8, 1): a device table, so that a call copies nothing from the host
_CT_BRANCH_SIGN = np.array([1.0, -1.0] * 4, dtype=np.float32)[:, None]


def _ct_frame_powers(chunks: torch.Tensor) -> torch.Tensor:
    """(B, NC, 256) raw chunks -> windowed power spectra of the NC + 1
    centered frames, (B, NC + 1, 257) in the scrambled bin order: the branch
    spectra, the frame combine X_f = Z_{f-1} + (-1)^br Z_f over the zero
    chunks on both sides ((-1)^k = (-1)^br for k = 8 m + br), the Hann."""
    z, q = _ct_branch_spectra(chunks)
    z = F.pad(z, (0, 0, 0, 0, 1, 1))  # (B, NC + 2, 8, 64)
    q = F.pad(q, (0, 0, 1, 1))
    sign = device_table(_CT_BRANCH_SIGN, z.device).to(z.dtype)
    return _ct_hann_power(z[:, :-1] + sign * z[:, 1:], q[:, :-1] + q[:, 1:])


def _ct_fft_reference(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A13's chunk FFT on the card (``csrc/lsd_fused.cu``, ``fft::``) as a
    torch dataflow: (..., NC, 256) real chunks -> the one-sided spectrum of
    each zero-padded chunk, (re, im) (..., NC, 256) in natural bin order,
    and the chunk Nyquist bins (..., NC, 1).

    ``_ct_branch_spectra``'s three folds, then each branch's 64-point DFT
    as an FFT: with t = 8 n1 + n2 and m = k1 + 8 k2, a DFT8 over n1 (a DIF
    radix-2 level with the twiddles W8^n, then two DFT4s), the twiddles
    W64^(n2 k1), and a DFT8 over n2 of which k2 = 0..3 is kept; bin
    8 m + br. The twiddles are ``_ct_constants``' (W64^j from ``w0``'s
    column m = 1). The kernel runs the same operations in float32 (its
    compiler may fuse a product and a sum into one rounding)."""
    tw, w0, _ = (device_table(a, x.device).to(x.dtype) for a in _ct_constants())
    w1re, w1im = tw[0], tw[1]
    w2re, w2im = tw[2, :128], tw[3, :128]
    w3re, w3im = tw[4, :64], tw[5, :64]
    w64re, w64im = w0[:, 1], w0[:, 33]  # exp(-2 pi i j / 64), j = 0..63

    def cmul(are, aim, wre, wim):
        return are * wre - aim * wim, are * wim + aim * wre

    def fold(vre, vim, half, wre, wim):
        are, bre = vre[..., :half], vre[..., half:]
        if vim is None:
            d = are - bre
            return (are + bre, torch.zeros_like(are)), (d * wre, d * wim)
        aim, bim = vim[..., :half], vim[..., half:]
        return (are + bre, aim + bim), cmul(are - bre, aim - bim, wre, wim)

    e00, o01 = fold(x, None, 128, w2re, w2im)
    e10, o11 = fold(x * w1re, x * w1im, 128, w2re, w2im)
    (br0, _), br4 = fold(e00[0], None, 64, w3re, w3im)
    br1, br5 = fold(*e10, 64, w3re, w3im)
    br2, br6 = fold(*o01, 64, w3re, w3im)
    br3, br7 = fold(*o11, 64, w3re, w3im)
    branches = (br0, torch.zeros_like(br0)), br1, br2, br3, br4, br5, br6, br7
    bre = torch.stack([b[0] for b in branches], dim=-2)  # (..., NC, 8 br, 64 t)
    bim = torch.stack([b[1] for b in branches], dim=-2)

    def dft8(vre, vim, half):
        """DFT8 over the last axis (n) -> the outputs k = 0..7 (0..3 with half)."""
        w8 = (w64re[8], w64im[8]), (w64re[24], w64im[24])  # W8^1, W8^3
        v = [(vre[..., n], vim[..., n]) for n in range(8)]
        a = [(v[n][0] + v[n + 4][0], v[n][1] + v[n + 4][1]) for n in range(4)]
        b = [(v[n][0] - v[n + 4][0], v[n][1] - v[n + 4][1]) for n in range(4)]
        b[1] = cmul(*b[1], *w8[0])
        b[2] = (b[2][1], -b[2][0])  # (-i)
        b[3] = cmul(*b[3], *w8[1])
        out = [None] * 8
        for p, first in ((a, 0), (b, 1)):
            q0 = (p[0][0] + p[2][0], p[0][1] + p[2][1])
            q1 = (p[1][0] + p[3][0], p[1][1] + p[3][1])
            q2 = (p[0][0] - p[2][0], p[0][1] - p[2][1])
            q3 = (p[1][1] - p[3][1], -(p[1][0] - p[3][0]))
            out[first] = (q0[0] + q1[0], q0[1] + q1[1])
            out[first + 2] = (q2[0] + q3[0], q2[1] + q3[1])
            out[first + 4] = (q0[0] - q1[0], q0[1] - q1[1])
            out[first + 6] = (q2[0] - q3[0], q2[1] - q3[1])
        out = out[:4] if half else out
        return torch.stack([o[0] for o in out], dim=-1), torch.stack([o[1] for o in out], dim=-1)

    # stage 1 over n1: (..., br, n2, n1) -> (..., br, n2, k1), twiddle W64^(n2 k1)
    yre, yim = dft8(bre.unflatten(-1, (8, 8)).transpose(-1, -2), bim.unflatten(-1, (8, 8)).transpose(-1, -2), False)
    j = torch.arange(8, device=x.device)
    idx = j[:, None] * j[None, :]  # (n2, k1)
    yre, yim = cmul(yre, yim, w64re[idx], w64im[idx])
    # stage 2 over n2: (..., br, k1, n2) -> (..., br, k1, k2), m = k1 + 8 k2
    zre, zim = dft8(yre.transpose(-1, -2), yim.transpose(-1, -2), True)
    zre, zim = zre.transpose(-1, -2).flatten(-2), zim.transpose(-1, -2).flatten(-2)  # (..., br, m)
    # bin k = 8 m + br
    return zre.transpose(-1, -2).flatten(-2), zim.transpose(-1, -2).flatten(-2), _chunk_nyquist(x)


def _lsd_ct_fft_reference(
    clean: torch.Tensor, denoised: torch.Tensor, hop: int, eps: float, scale: torch.Tensor | None = None
) -> torch.Tensor:
    """A13's scores from ``_ct_fft_reference``'s spectra: as
    ``_lsd_wholesig_ct_plain``, the frame combine X_f = Z_{f-1} +
    (-1)^k Z_f over the zero chunks on both sides, then A1's Hann, log
    ratio and per-frame root."""
    batch, t = clean.shape
    if scale is None:
        scale = torch.sum(clean * denoised, dim=1, keepdim=True) / (
            torch.sum(denoised * denoised, dim=1, keepdim=True) + eps
        )

    def powers(chunks):
        zre, zim, q = (F.pad(a, (0, 0, 1, 1)) for a in _ct_fft_reference(chunks))
        sign = 1.0 - 2.0 * (torch.arange(hop, device=chunks.device) % 2).to(chunks.dtype)
        return _hann_power(zre[:, :-1] + sign * zre[:, 1:], zim[:, :-1] + sign * zim[:, 1:], q[:, :-1] + q[:, 1:])

    c = clean.reshape(batch, t // hop, hop)
    d = denoised.reshape(batch, t // hop, hop) * scale.reshape(batch, 1, 1)
    return torch.mean(_frame_lsd(powers(c), powers(d), eps), dim=-1)


def _lsd_wholesig_ct_plain(
    clean: torch.Tensor, denoised: torch.Tensor, hop: int, eps: float, scale: torch.Tensor | None = None
) -> torch.Tensor:
    """Plain PyTorch version of kernel A13: hop-aligned (B, T) pairs, the
    projection scale computed here (``scale=None``) or given ((B, 1))."""
    batch, t = clean.shape
    if scale is None:
        scale = torch.sum(clean * denoised, dim=1, keepdim=True) / (
            torch.sum(denoised * denoised, dim=1, keepdim=True) + eps
        )
    c = clean.reshape(batch, t // hop, hop)
    d = denoised.reshape(batch, t // hop, hop) * scale.reshape(batch, 1, 1)
    return torch.mean(_frame_lsd(_ct_frame_powers(c), _ct_frame_powers(d), eps), dim=-1)


def _pieces(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Three bf16 pieces of a float32 tensor, rounded to nearest even: x0 =
    bf16(x), x1 = bf16(x - x0), x2 = bf16(x - x0 - x1) (both differences
    exact in float32)."""
    x0 = x.to(torch.bfloat16)
    r = x - x0.float()
    x1 = r.to(torch.bfloat16)
    return x0, x1, (r - x1.float()).to(torch.bfloat16)


@functools.lru_cache(maxsize=None)
def _tile_table() -> np.ndarray:
    """(5 x 128, 256) float32: the frame-tile kernel's chunk-DFT table, built
    in float64. Rows t 128 + j and t 128 + 64 + j hold the cos and sin
    columns of bin k = 62 t - 1 + j (j = 0..63), cos(-2 pi n k / 512) and
    sin(-2 pi n k / 512) for n = 0..255: tile t's [re 64 | im 64], K-major."""
    n_fft = 2 * 256
    t = np.arange(256, dtype=np.float64)[None, :]
    k = (np.arange(_TILES)[:, None] * _OUT_BINS - 1 + np.arange(_TILE_BINS)[None, :]).reshape(-1, 1)
    ang = -2.0 * np.pi * t * k.astype(np.float64) / n_fft  # (5 x 64, 256)
    rows = np.concatenate([np.cos(ang).reshape(_TILES, _TILE_BINS, 256),
                           np.sin(ang).reshape(_TILES, _TILE_BINS, 256)], axis=1)
    return rows.reshape(_TILES * 2 * _TILE_BINS, 256).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _tile_table_pieces_bits() -> np.ndarray:
    """(3, 640, 256) int16: the bits of ``_tile_table``'s three bf16 pieces."""
    return torch.stack(_pieces(torch.from_numpy(_tile_table()))).contiguous().view(torch.int16).numpy()


def _tile_table_pieces(device: torch.device | str = "cpu") -> torch.Tensor:
    """``_tile_table_pieces_bits`` as a bf16 tensor on ``device`` (one copy per device)."""
    return device_table(_tile_table_pieces_bits(), torch.device(device)).view(torch.bfloat16)


def _scale_partials_plain(clean: torch.Tensor, denoised: torch.Tensor) -> torch.Tensor:
    """(B, 16, 2) sums of c d and d d over the kernel's 16 slices of each row."""
    t = clean.shape[1]
    per = -(-t // _SCALE_SPLITS)
    parts = []
    for i in range(_SCALE_SPLITS):
        c, d = clean[:, i * per:(i + 1) * per], denoised[:, i * per:(i + 1) * per]
        parts.append(torch.stack([torch.sum(c * d, dim=1), torch.sum(d * d, dim=1)], dim=1))
    return torch.stack(parts, dim=1)


def _scale_from_partials(partial: torch.Tensor, eps: float) -> torch.Tensor:
    """(B, 16, 2) partials -> (B, 1) projection scale, the sixteen added in
    order in float32 as the split pass adds them."""
    num, den = partial[:, 0, 0], partial[:, 0, 1]
    for i in range(1, _SCALE_SPLITS):
        num, den = num + partial[:, i, 0], den + partial[:, i, 1]
    return (num / (den + eps))[:, None]


def _split_pieces_plain(
    clean: torch.Tensor, denoised: torch.Tensor, row_len: int, scale: torch.Tensor | None = None
) -> torch.Tensor:
    """Plain version of the three-piece split: (6, B, row_len) bf16, the
    planes [c0, c1, c2, d0, d1, d2], zeros past T; with ``scale`` (B, 1)
    the denoised signal is scaled (in float32) before its split."""
    if scale is not None:
        denoised = denoised * scale
    planes = []
    for x in (clean, denoised):
        planes += _pieces(F.pad(x.float(), (0, row_len - x.shape[-1])))
    return torch.stack(planes)


def split_pieces(
    clean: torch.Tensor, denoised: torch.Tensor, row_len: int, eps: float | None = None
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The split pass that A1-A3 run first: (B, T) float32 pairs -> ((6, B,
    row_len) bf16 pieces, zero-padded (row_len >= T, a multiple of 8); with
    ``eps`` given, A1's (B, 16, 2) scale partials, the denoised signal
    scaled by ``_scale_from_partials`` before its split, else None). CPU
    tensors take the plain version; on a CUDA tensor the kernel
    (``csrc/sdr_halves.cuh``, ``halves::split<3>``)."""
    assert clean.ndim == 2 and clean.shape == denoised.shape and row_len >= clean.shape[1] and row_len % 8 == 0
    if clean.device.type == "cpu":
        partial = None if eps is None else _scale_partials_plain(clean, denoised)
        scale = None if partial is None else _scale_from_partials(partial, eps)
        return _split_pieces_plain(clean, denoised, row_len, scale), partial
    if clean.device.type != "cuda":
        raise ValueError(f"no split kernel for device {clean.device}")
    dev = clean.device
    cuda_lib.check_operand(clean, "clean", dev, torch.float32, 2)
    cuda_lib.check_operand(denoised, "denoised", dev, torch.float32, 2)
    batch = clean.shape[0]
    out = torch.empty(6, batch, row_len, device=dev, dtype=torch.bfloat16)
    partial = None if eps is None else torch.empty(batch, _SCALE_SPLITS, 2, device=dev, dtype=torch.float32)
    cuda_lib.launch("lsd_split", dev, clean, denoised, partial, out, batch, clean.shape[1], row_len,
                    0.0 if eps is None else eps)
    cuda_lib.launch_counts[KERNEL_SPLIT] += 1
    return out, partial


def _lsd_tiles_reference(pieces: torch.Tensor, t_len: int, eps: float) -> torch.Tensor:
    """The frame-tile kernel's dataflow in torch, in float32, for the tests:
    from the pieces (6, B, chunks x 256) and ``_tile_table_pieces``, per
    group of 127 frames the 128 chunk rows of each signal (chunk 127 g - 1
    ..; zeros before chunk 0 and past the row) times each bin tile as the
    five cross products x0w1 + x1w0 + x0w2 + x1w1 + x2w0, then + x0w0 (the
    kernel's order), the frame combine
    with the absolute bin's sign (-1)^(62 t - 1 + j), the Hann taps over the
    halo columns, lr^2 summed over each tile's output bins 62 t ..
    min(62 t + 61, 256) into (B, F, 5), then per frame the five partials
    in tile order, sqrt(s / 257) and the mean over frames: (B,) scores."""
    _, batch, row_len = pieces.shape
    hop = 256
    n_chunks, n_frames = row_len // hop, 1 + t_len // hop
    n_groups = -(-n_frames // _GROUP_FRAMES)
    x = pieces.float().reshape(2, 3, batch, n_chunks, hop)
    # padded chunk row i is chunk i - 1: group g reads rows 127 g .. 127 g + 127
    x = F.pad(x, (0, 0, 1, n_groups * _GROUP_FRAMES + 1 - n_chunks))
    w = _tile_table_pieces(pieces.device).float()  # (3, 640, 256)
    products = ((0, 1), (1, 0), (0, 2), (1, 1), (2, 0), (0, 0))
    j = torch.arange(_TILE_BINS, device=pieces.device)
    sign = torch.where(j % 2 == 1, 1.0, -1.0)  # (-1)^(62 t - 1 + j): 62 t is even
    partial = torch.zeros(batch, n_groups * _GROUP_FRAMES, _TILES, device=pieces.device)
    for g in range(n_groups):
        rows = x[:, :, :, g * _GROUP_FRAMES:g * _GROUP_FRAMES + _GROUP_FRAMES + 1]  # (2, 3, B, 128, 256)
        for t in range(_TILES):
            wt = w[:, t * 2 * _TILE_BINS:(t + 1) * 2 * _TILE_BINS].transpose(1, 2)  # (3, 256, 128)
            spec = rows[:, 0] @ wt[1]
            for p, q in products[1:]:
                spec = spec + rows[:, p] @ wt[q]
            re, im = spec[..., :_TILE_BINS], spec[..., _TILE_BINS:]
            xre, xim = re[..., :-1, :] + sign * re[..., 1:, :], im[..., :-1, :] + sign * im[..., 1:, :]
            yre = 0.5 * xre[..., 1:-1] - 0.25 * (xre[..., :-2] + xre[..., 2:])
            yim = 0.5 * xim[..., 1:-1] - 0.25 * (xim[..., :-2] + xim[..., 2:])
            power = yre * yre + yim * yim  # (2, B, 127, 62): output bins 62 t ..
            d_mag = torch.sqrt(power[1]) + eps
            lr = torch.log(power[0] / (d_mag * d_mag) + eps)
            keep = t * _OUT_BINS + torch.arange(_OUT_BINS, device=pieces.device) <= hop
            partial[:, g * _GROUP_FRAMES:(g + 1) * _GROUP_FRAMES, t] = torch.sum(lr * lr * keep, dim=-1)
    s = partial[:, :n_frames, 0]
    for t in range(1, _TILES):
        s = s + partial[:, :n_frames, t]
    return torch.mean(torch.sqrt(s / (hop + 1)), dim=-1)


def _lsd_wholesig_raw_cuda(
    clean: torch.Tensor, denoised: torch.Tensor, hop: int, eps: float
) -> torch.Tensor:
    _check_pair(clean, denoised, hop)
    dev = clean.device
    batch, t = clean.shape
    nc = t // hop
    if nc == 0 or t % hop:
        raise ValueError(f"need whole chunks of {hop} samples, got {tuple(clean.shape)}")
    pieces = torch.empty(6, batch, nc * hop, device=dev, dtype=torch.bfloat16)
    scale_partial = torch.empty(batch, _SCALE_SPLITS, 2, device=dev, dtype=torch.float32)
    partial = torch.empty(batch, nc + 1, _TILES, device=dev, dtype=torch.float32)
    out = torch.empty(batch, device=dev, dtype=torch.float32)
    cuda_lib.launch(KERNEL, dev, clean, denoised, pieces, _tile_table_pieces(dev), scale_partial, partial, out,
                    batch, nc, eps)
    cuda_lib.launch_counts[KERNEL] += 1
    return out


def _lsd_wholesig_ct_cuda(
    clean: torch.Tensor, denoised: torch.Tensor, hop: int, eps: float, scale: torch.Tensor | None
) -> torch.Tensor:
    _check_pair(clean, denoised, hop)
    dev = clean.device
    batch, t = clean.shape
    nc = t // hop
    if nc == 0 or t % hop:
        raise ValueError(f"need whole chunks of {hop} samples, got {tuple(clean.shape)}")
    if scale is not None:
        scale = scale.reshape(batch)
        cuda_lib.check_operand(scale, "scale", dev, torch.float32, 1)
    tw, w0, _ = (device_table(a, dev) for a in _ct_constants())
    # the kernel stages chunks with 16-byte copies
    clean, denoised = (a if a.data_ptr() % 16 == 0 else a.clone() for a in (clean, denoised))
    n_tiles = -(-(nc + 1) // _CT_TILE_FRAMES)
    scale_partial = torch.empty(batch, _SCALE_SPLITS, 2, device=dev, dtype=torch.float32)
    partial = torch.empty(batch, n_tiles, device=dev, dtype=torch.float32)
    out = torch.empty(batch, device=dev, dtype=torch.float32)
    cuda_lib.launch("lsd_wholesig_ct", dev, clean, denoised, scale, tw, w0, scale_partial, partial, out,
                    batch, nc, eps)
    cuda_lib.launch_counts[KERNEL_A13] += 1
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
    if t == 0:
        raise ValueError(f"need at least one sample, got {tuple(clean.shape)}")
    pieces = torch.empty(6, batch, -(-t // hop) * hop, device=dev, dtype=torch.bfloat16)
    partial = torch.empty(batch, 1 + t // hop, _TILES, device=dev, dtype=torch.float32)
    out = torch.empty(batch, device=dev, dtype=torch.float32)
    cuda_lib.launch("lsd_wholesig", dev, clean, denoised, pieces, _tile_table_pieces(dev), partial, out, batch, t,
                    eps)
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


def lsd_wholesig_ct(
    clean: torch.Tensor, denoised: torch.Tensor, hop: int, eps: float, scale: torch.Tensor | None = None
) -> torch.Tensor:
    """Kernel A13 wrapper: (B, T) float32 pairs with T % hop == 0 -> (B,)
    LSD, the projection scale computed by the kernel (``scale=None``) or
    given ((B,) or (B, 1)). The factorized chunk DFT is built for hop 256."""
    return _dispatch(
        clean,
        lambda: _lsd_wholesig_ct_plain(clean, denoised, hop, eps, scale),
        lambda: _lsd_wholesig_ct_cuda(clean, denoised, hop, eps, scale),
    )


def _takes_ct(t: int, n_fft: int, hop: int) -> bool:
    """The JAX package's conditions for its factorized whole-signal kernel:
    hop-aligned, a chunk count that is a multiple of 8, F + 1 <=
    ``MAX_WHOLESIG_CHUNKS`` frames and n_fft 512."""
    nc = t // hop
    return t % hop == 0 and nc % 8 == 0 and nc + 2 <= MAX_WHOLESIG_CHUNKS and n_fft == 512


def lsd_scores(
    clean: torch.Tensor,
    denoised: torch.Tensor,
    n_fft: int,
    hop: int,
    eps: float,
    denoised_scale: str | torch.Tensor | None = "auto",
    dft_impl: str = "dense",
) -> torch.Tensor:
    """Centered-STFT LSD of (B, T) pairs -> (B,) scores, fully fused; any T.

    ``denoised_scale``: ``"auto"`` projects the denoised signal onto the
    clean one (least-squares scale), a (B,) or (B, 1) tensor is that scale
    given, ``None`` means ``denoised`` is already scaled. The routes follow
    the JAX package's ``lsd_scores``: with ``dft_impl="ct"`` and a scale
    (``"auto"`` or given), a clip that meets its conditions (``_takes_ct``)
    takes A13; otherwise hop-aligned clips with ``"auto"`` take A1, which
    computes the scale itself; everything else is scaled here and takes A2,
    or A3 past ``MAX_WHOLESIG_CHUNKS``.
    """
    assert n_fft == 2 * hop, "fused LSD requires 50% overlap"
    if dft_impl not in ("dense", "ct"):
        raise ValueError(f"dft_impl must be 'dense' or 'ct', got {dft_impl!r}")
    t = clean.shape[-1]
    if isinstance(denoised_scale, str) and denoised_scale != "auto":
        raise ValueError(f"denoised_scale must be 'auto', a tensor or None, got {denoised_scale!r}")
    if dft_impl == "ct" and denoised_scale is not None and _takes_ct(t, n_fft, hop):
        given = None if isinstance(denoised_scale, str) else denoised_scale.reshape(-1, 1).to(torch.float32)
        return lsd_wholesig_ct(clean, denoised, hop, eps, given)
    if isinstance(denoised_scale, str):
        if t % hop == 0:
            return lsd_wholesig_raw(clean, denoised, hop, eps)
        denoised_scale = torch.sum(clean * denoised, dim=1) / (torch.sum(denoised * denoised, dim=1) + eps)
    if denoised_scale is not None:
        denoised = denoised * denoised_scale.reshape(-1, 1)
    if (1 + t // hop) + 1 <= MAX_WHOLESIG_CHUNKS:
        return lsd_wholesig(clean, denoised, hop, eps)
    return lsd_framed(clean, denoised, hop, eps)

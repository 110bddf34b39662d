"""STOI/ESTOI segment correlations: CUDA kernel A6 and its plain version.

Counterpart of the JAX package's ``ops/stoi_fused.py``
(``stoi_segment_sums``). Per 30-frame segment m < num_segments and band j:

* consts  = ||X_m|| / (||Y_m|| + 1e-9)          (uncentered segment norms)
* Y'      = min(consts * Y, (1 + 10^(15/20)) * X)   (equalize + clip)
* STOI_m  = sum_j <x_hat, y'_hat> with the centered cross term
  sum_n (X - mu_x) * Y' (the mu_y' term vanishes since sum(X - mu_x) = 0)
* ESTOI_m = sum_n <x2, y2>_n with x2 the band-normalized x1, expanded via
  band sums (P - Mx*My/15) / (sx2 * sy2)

Variances are computed centered (second pass after the mean); every rsqrt
is floored at 1e-30. The CUDA kernel is ``csrc/stoi_fused.cu``: tiles of 64
segments, per-(segment, band) statistics in a first stage, ESTOI's band
sums per (segment, frame) serially over the bands in a second;
``_stoi_two_stage_reference`` spells out its dataflow and order of sums.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from fast_speech_enhancement_metrics_tpu_torch.ops import cuda_lib

KERNEL = "stoi_segment_sums"
#: equalize-clip factor: 1 + 10^(-beta/20), beta = -15 dB
_CLIPF = 1.0 + 10.0 ** (15.0 / 20.0)
#: segments per block of the CUDA kernel (csrc/stoi_fused.cu, kTileSegs)
_TILE_SEGS = 64


def _stoi_segment_sums_plain(
    tob_clean: torch.Tensor, tob_denoised: torch.Tensor,
    num_segments: torch.Tensor, n: int, num_bands: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel A6: the same formulas over the
    (B, M, bands, n) segment views."""
    batch, f, _ = tob_clean.shape
    m = max(f - n + 1, 0)
    if m == 0:
        zero = tob_clean.new_zeros(batch)
        return zero, zero
    x = tob_clean.transpose(1, 2).unfold(-1, n, 1).transpose(1, 2)  # (B, M, bands, n)
    y = tob_denoised.transpose(1, 2).unfold(-1, n, 1).transpose(1, 2)

    mu_x = x.sum(-1, keepdim=True) * (1.0 / n)
    mu_y = y.sum(-1, keepdim=True) * (1.0 / n)
    consts = torch.sqrt((x * x).sum(-1, keepdim=True)) / (
        torch.sqrt((y * y).sum(-1, keepdim=True)) + 1e-9
    )
    xc, yc = x - mu_x, y - mu_y
    vx = (xc * xc).sum(-1, keepdim=True)
    vy = (yc * yc).sum(-1, keepdim=True)
    yp = torch.minimum(consts * y, _CLIPF * x)
    num_s = (xc * yp).sum(-1, keepdim=True)
    ypc = yp - yp.sum(-1, keepdim=True) * (1.0 / n)
    vyp = (ypc * ypc).sum(-1, keepdim=True)
    rsx = torch.rsqrt(torch.clamp(vx, min=1e-30))
    rsy = torch.rsqrt(torch.clamp(vy, min=1e-30))
    rsyp = torch.rsqrt(torch.clamp(vyp, min=1e-30))
    stoi_m = (num_s * rsx * rsyp).sum(dim=(2, 3))  # (B, M)

    x1, y1 = xc * rsx, yc * rsy  # (B, M, bands, n)
    p = (x1 * y1).sum(2)
    mx, my = x1.sum(2), y1.sum(2)
    qx, qy = (x1 * x1).sum(2), (y1 * y1).sum(2)
    numer = p - mx * my * (1.0 / num_bands)
    s2x = torch.rsqrt(torch.clamp(qx - mx * mx * (1.0 / num_bands), min=1e-30))
    s2y = torch.rsqrt(torch.clamp(qy - my * my * (1.0 / num_bands), min=1e-30))
    estoi_m = (numer * s2x * s2y).sum(-1)  # (B, M)

    valid = torch.arange(m, device=x.device)[None, :] < num_segments[:, None]
    stoi = torch.where(valid, stoi_m, 0.0).sum(-1)
    estoi = torch.where(valid, estoi_m, 0.0).sum(-1)
    return stoi, estoi


def _warp_butterfly(a: torch.Tensor) -> torch.Tensor:
    """(..., 32) -> (...,): a warp's xor butterfly sum (16, 8, 4, 2, 1)."""
    for o in (16, 8, 4, 2, 1):
        a = a[..., :o] + a[..., o:2 * o]
    return a[..., 0]


def _stoi_two_stage_reference(
    tob_clean: torch.Tensor, tob_denoised: torch.Tensor, num_segments: torch.Tensor,
    n: int = 30, num_bands: int = 15,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The CUDA kernel's dataflow (``csrc/stoi_fused.cu``) in torch float32,
    for the tests: every sum in the kernel's order (the kernel contracts
    products into fused multiply-adds, so the two agree to round-off).

    Tiles of ``_TILE_SEGS`` segments over the padded frames. Stage 1, per
    (segment, band), sequentially over the 30 frames: loop A's sums, loop
    B's centered variances and STOI numerator, var(Y'); each segment's STOI
    terms added over bands 0-7, then 8-14, the two halves added. Stage 2,
    per (segment, frame): x1, y1 and the five band sums serially over the
    15 bands; each segment's ESTOI terms added over frames 0-14, then
    15-29, the two halves added. Per tile, the valid segments (m <
    min(num_segments, F - n + 1)) by a butterfly over each 32 and the warps
    in order; a tile past the row's last valid segment gives zeros (the
    kernel's early exit). Per row, lane l adds tiles l, l + 32, ..., then a
    butterfly."""
    batch, f, _ = tob_clean.shape
    positions = max(f - n + 1, 0)
    n_tiles = -(-positions // _TILE_SEGS)
    if n_tiles == 0:
        zero = tob_clean.new_zeros(batch)
        return zero, zero
    mt = n_tiles * _TILE_SEGS
    pad = (0, 0, 0, mt + n - 1 - f)
    xw = F.pad(tob_clean, pad).unfold(1, n, 1)  # (B, mt, bands, n)
    yw = F.pad(tob_denoised, pad).unfold(1, n, 1)
    zeros = tob_clean.new_zeros(batch, mt, num_bands)

    sc, sc2, sd, sd2 = zeros, zeros, zeros, zeros  # loop A
    for i in range(n):
        x, y = xw[..., i], yw[..., i]
        sc, sc2, sd, sd2 = sc + x, sc2 + x * x, sd + y, sd2 + y * y
    mu_x, mu_y = sc * (1.0 / n), sd * (1.0 / n)
    consts = torch.sqrt(sc2) / (torch.sqrt(sd2) + 1e-9)
    vx, vy, syp, num, yps = zeros, zeros, zeros, zeros, []  # loop B
    for i in range(n):
        x, y = xw[..., i], yw[..., i]
        xc, yc = x - mu_x, y - mu_y
        yp = torch.minimum(consts * y, _CLIPF * x)
        vx, vy, syp, num = vx + xc * xc, vy + yc * yc, syp + yp, num + xc * yp
        yps.append(yp)
    mu_yp, vyp = syp * (1.0 / n), zeros
    for yp in yps:
        vyp = vyp + (yp - mu_yp) * (yp - mu_yp)
    rsx = torch.rsqrt(torch.clamp(vx, min=1e-30))
    rsy = torch.rsqrt(torch.clamp(vy, min=1e-30))
    rsyp = torch.rsqrt(torch.clamp(vyp, min=1e-30))
    term = num * rsx * rsyp

    def ordered(parts):
        total = parts[0]
        for part in parts[1:]:
            total = total + part
        return total

    half = 8
    stoi_m = ordered([term[..., j] for j in range(half)]) + ordered([term[..., j] for j in range(half, num_bands)])

    frame_terms = []  # stage 2
    for i in range(n):
        x1 = [(xw[..., j, i] - mu_x[..., j]) * rsx[..., j] for j in range(num_bands)]
        y1 = [(yw[..., j, i] - mu_y[..., j]) * rsy[..., j] for j in range(num_bands)]
        p = ordered([a * c for a, c in zip(x1, y1)])
        mx, my = ordered(x1), ordered(y1)
        qx, qy = ordered([a * a for a in x1]), ordered([c * c for c in y1])
        numer = p - mx * my * (1.0 / num_bands)
        s2x = torch.rsqrt(torch.clamp(qx - mx * mx * (1.0 / num_bands), min=1e-30))
        s2y = torch.rsqrt(torch.clamp(qy - my * my * (1.0 / num_bands), min=1e-30))
        frame_terms.append(numer * s2x * s2y)
    estoi_m = ordered(frame_terms[:n // 2]) + ordered(frame_terms[n // 2:])

    n_valid = torch.clamp(num_segments.to(device=tob_clean.device, dtype=torch.long), max=positions)
    m_idx = torch.arange(mt, device=tob_clean.device)
    valid = m_idx[None, :] < n_valid[:, None]
    live = (m_idx[::_TILE_SEGS][None, :] < n_valid[:, None])  # (B, tiles): not an early exit
    out = []
    for seg in (stoi_m, estoi_m):
        warps = _warp_butterfly(torch.where(valid, seg, 0.0).reshape(batch, n_tiles, -1, 32))
        tiles = torch.where(live, ordered([warps[..., w] for w in range(warps.shape[-1])]), 0.0)
        lanes = F.pad(tiles, (0, -n_tiles % 32)).reshape(batch, -1, 32)
        out.append(_warp_butterfly(ordered([lanes[:, r] for r in range(lanes.shape[1])])))
    return out[0], out[1]


def _stoi_segment_sums_cuda(
    tob_clean: torch.Tensor, tob_denoised: torch.Tensor,
    num_segments: torch.Tensor, n: int, num_bands: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    dev = tob_clean.device
    if (n, num_bands) != (30, 15):
        raise NotImplementedError(f"the STOI kernel is built for 30 frames x 15 bands, got {n} x {num_bands}")
    cuda_lib.check_operand(tob_clean, "tob_clean", dev, torch.float32, 3)
    cuda_lib.check_operand(tob_denoised, "tob_denoised", dev, torch.float32, 3)
    if tob_denoised.shape != tob_clean.shape or tob_clean.shape[2] != num_bands:
        raise ValueError(f"envelopes must both be (B, F, {num_bands})")
    batch, f, _ = tob_clean.shape
    if batch == 0:
        raise ValueError("need at least one row")
    nseg = num_segments.to(device=dev, dtype=torch.int32).contiguous()
    cuda_lib.check_operand(nseg, "num_segments", dev, torch.int32, 1)
    n_tiles = -(-max(f - n + 1, 0) // _TILE_SEGS)
    partial = torch.empty(batch, max(n_tiles, 1), 2, device=dev, dtype=torch.float32)
    out = torch.empty(batch, 2, device=dev, dtype=torch.float32)
    cuda_lib.launch(KERNEL, dev, tob_clean, tob_denoised, nseg, partial, out, batch, f)
    return out[:, 0], out[:, 1]


def stoi_segment_sums(
    tob_clean: torch.Tensor,
    tob_denoised: torch.Tensor,
    num_segments: torch.Tensor,
    n: int = 30,
    num_bands: int = 15,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel A6 wrapper: masked segment-correlation sums from band envelopes.

    tob_*: (B, F, num_bands) float32 third-octave envelopes; num_segments:
    (B,) integer, at most F - n + 1. Returns (stoi_sum, estoi_sum), each
    (B,): the sums over valid segments of the per-segment band-correlation
    sums; the caller divides by num_bands, n and num_segments. CPU tensors
    take the plain version; CUDA tensors launch the kernel (or raise); any
    other device raises.
    """
    return cuda_lib.dispatch("STOI kernel", tob_clean.device, _stoi_segment_sums_plain, _stoi_segment_sums_cuda,
                             tob_clean, tob_denoised, num_segments, n, num_bands)

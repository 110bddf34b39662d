"""SDR auto/cross correlations: CUDA kernel A4 and its plain version.

Counterpart of the JAX package's ``ops/sdr_corr_gram.py``
(``correlation_lags_gram``): r_auto[l] = sum_t c[t-l] c[t] and r_cross[l] =
sum_t c[t-l] d[t] for l = 0..n_lags-1, zeros outside the signal.

``split`` is the JAX kernel's product class. With hi = bf16(x) and lo =
bf16(x - hi), each product c[t-l] y[t] is formed from the halves: "x4" sums
hh + hl + lh + ll, "x3" drops ll, "x1" keeps hh. Each bf16 x bf16 product
is exact in float32.

The CUDA kernel (``csrc/sdr_corr_gram.cu``) computes what the TPU kernel
computes, on the tensor cores: the signals cut into frames of 128, C[f, i]
= c[128 f + i], the shifted Grams G_s = C^T Y[. + s] (s = 0..4, Y in {C,
D}) as bf16 ``wgmma`` products with the halves K-stacked per ``K_STACK``
(the JAX kernel's [ch, ch, cl, cl] . [yh, yl, yh, yl], cut to x1's and
x3's terms), and r[128 a + b] from the diagonal sums of G_a and G_{a+1}.
The halves are split once, up front, by one elementwise pass into
zero-padded bf16 rows (``split_halves``; A10 reads the same layout).
``_gram_operands`` and ``_gram_reference`` spell out, in torch, the
operands as the kernel's TMA boxes read them and the epilogue's diagonal
indexing; the CPU tests hold them against the JAX kernel's operands and
against the plain correlation.

The plain version is the package's plain correlation, the overlap-save DFT
matmuls of ``ops/dft.py::correlation_lags``, in float32 on the raw signals
(x4), or summed over the split signals: corr(ch, yh) + corr(ch, yl) +
corr(cl, yh) for x3 and corr(ch, yh) for x1.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from fast_speech_enhancement_metrics_tpu_torch.ops import cuda_lib
from fast_speech_enhancement_metrics_tpu_torch.ops.dft import correlation_lags

KERNEL = "correlation_lags_gram"
#: the launch counter of each split mode; x4 keeps the kernel's own name
KERNELS = {"x4": KERNEL, "x3": f"{KERNEL}_x3", "x1": f"{KERNEL}_x1"}
#: launches of the split pass alone (``split_halves`` on a CUDA tensor); A4
#: and A10 run it inside their own launches
KERNEL_SPLIT = "split_halves"
#: the C entry point's split argument: the terms of hh + hl + lh + ll kept
_SPLIT_TERMS = {"x4": 4, "x3": 3, "x1": 1}
#: the K-stacked products of each split, (clean half, target half) with 0
#: hi and 1 lo, in the kernel's order
K_STACK = {
    "x1": ((0, 0),),
    "x3": ((0, 0), (0, 1), (1, 0)),
    "x4": ((0, 0), (0, 1), (1, 0), (1, 1)),
}
_HB = 128
#: shifted operands of the Gram: lag blocks of 128 and one more
_SHIFTS = 512 // _HB + 1
#: 256-column tiles of N = [C_0..C_4 | D_0..D_4] per row (a CTA each)
_N_TILES = 2 * _SHIFTS * _HB // 256
#: frames per pipeline stage of the CUDA kernel (csrc/sdr_corr_gram.cu, Cfg::kFr)
_STAGE_FRAMES = {"x4": 32, "x3": 32, "x1": 64}
#: an item's fixed cost (its epilogue) in frames of one product term, for
#: choosing the k ranges
_ITEM_FRAMES = 128
_MAX_K_RANGES = 32


def _hi_lo(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """bf16 halves as float32: hi = bf16(x), lo = bf16(x - hi)."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _split_halves_plain(c: torch.Tensor, d: torch.Tensor, row_len: int) -> torch.Tensor:
    """Plain version of the split pass: (4, B, row_len) bf16, the planes
    [clean hi, clean lo, denoised hi, denoised lo], zeros past T."""
    planes = []
    for x in (c, d):
        hi, lo = _hi_lo(F.pad(x.float(), (0, row_len - x.shape[-1])))
        planes += [hi.to(torch.bfloat16), lo.to(torch.bfloat16)]
    return torch.stack(planes)


def split_halves(c: torch.Tensor, d: torch.Tensor, row_len: int, lo: bool = True) -> torch.Tensor:
    """The split pass that A4 and A10 run first: c, d (B, T) float32 ->
    (4, B, row_len) bf16 halves, zero-padded (row_len >= T, a multiple of
    8). CPU tensors take the plain version; on a CUDA tensor the kernel
    (``csrc/sdr_halves.cuh``), which with ``lo=False`` leaves the lo planes
    unwritten."""
    assert c.ndim == 2 and c.shape == d.shape and row_len >= c.shape[1] and row_len % 8 == 0
    return cuda_lib.dispatch("split kernel", c.device, lambda: _split_halves_plain(c, d, row_len),
                             lambda: _split_halves_cuda(c, d, row_len, lo))


def _split_halves_cuda(c: torch.Tensor, d: torch.Tensor, row_len: int, lo: bool) -> torch.Tensor:
    dev = c.device
    cuda_lib.check_operand(c, "c", dev, torch.float32, 2)
    cuda_lib.check_operand(d, "d", dev, torch.float32, 2)
    out = torch.empty(4, c.shape[0], row_len, device=dev, dtype=torch.bfloat16)
    cuda_lib.launch(KERNEL_SPLIT, dev, c, d, out, c.shape[0], c.shape[1], row_len, int(lo))
    return out


def _gram_operands(halves: torch.Tensor, split: str) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's K-stacked operands, as its TMA boxes read them from the
    halves (4, B, F x 128): A (B, terms x F, 128), the clean frames C[f, i]
    of each term's clean half, and B (B, terms x F, 1280), the blocks
    [C_0..C_4 | D_0..D_4] of the term's target half, block (y, s) holding
    Y[f + s] at frame f (zeros past the last frame). G = A^T B."""
    _, batch, row_len = halves.shape
    frames = row_len // _HB
    planes = halves.reshape(4, batch, frames, _HB)
    a_terms, b_terms = [], []
    for ha, hb in K_STACK[split]:
        a_terms.append(planes[ha])
        blocks = []
        for y in (0, 1):
            target = F.pad(planes[2 * y + hb], (0, 0, 0, _SHIFTS - 1))
            blocks += [target[:, s:s + frames] for s in range(_SHIFTS)]
        b_terms.append(torch.cat(blocks, dim=2))
    return torch.cat(a_terms, dim=1), torch.cat(b_terms, dim=1)


def _gram_reference(halves: torch.Tensor, split: str, split_frames: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's arithmetic in torch, in the halves' dtype cast to
    float64, for the tests: per k range of ``split_frames`` frames the ten
    128 x 128 blocks of G, each cut into the diagonal sums U[b] (G[i, i +
    b], i + b < 128) and L[b] (G[i, i + b - 128], i + b >= 128) over each
    warpgroup's 64 rows, indexed as the epilogue reads them, then r[128 a +
    b] = the sum over the k ranges and row halves of U_a[b] + L_{a+1}[b]
    (the finalize launch)."""
    a, b = (x.double() for x in _gram_operands(halves, split))
    batch, k, _ = a.shape
    terms = len(K_STACK[split])
    frames = k // terms
    a = a.reshape(batch, terms, frames, _HB)
    b = b.reshape(batch, terms, frames, 2 * _SHIFTS * _HB)
    i = torch.arange(_HB)[:, None]
    off = torch.arange(_HB)[None, :]
    j = (i + off) % _HB  # the column thread (block, off) reads in row i
    upper = i + off < _HB
    r = torch.zeros(batch, 2, 512, dtype=torch.float64)
    for f0 in range(0, frames, split_frames):
        g = torch.einsum("btfi,btfn->bin", a[:, :, f0:f0 + split_frames], b[:, :, f0:f0 + split_frames])
        g = g.reshape(batch, _HB, 2 * _SHIFTS, _HB).permute(0, 2, 1, 3)  # (B, block, i, j)
        diag = g[:, :, i, j]  # (B, block, i, off)
        for rows in (slice(0, _HB // 2), slice(_HB // 2, _HB)):  # the two warpgroups
            up = torch.where(upper[rows], diag[:, :, rows], 0.0).sum(dim=2)
            low = torch.where(upper[rows], 0.0, diag[:, :, rows]).sum(dim=2)
            for y in (0, 1):
                for lag_block in range(_SHIFTS - 1):
                    g0 = y * _SHIFTS + lag_block
                    r[:, y, lag_block * _HB:(lag_block + 1) * _HB] += up[:, g0] + low[:, g0 + 1]
    return r[:, 0], r[:, 1]


@functools.lru_cache(maxsize=256)
def _gram_k_ranges(batch: int, frames: int, split: str, sms: int) -> tuple[int, int]:
    """(frames per k range, k ranges) for the kernel's 5 x ranges x batch
    items over its persistent grid of ``sms`` CTAs: the fewest rounds of the
    longest items, each range a whole number of stages."""
    stage = _STAGE_FRAMES[split]
    terms = len(K_STACK[split])
    best = None
    for ranges in range(1, _MAX_K_RANGES + 1):
        split_frames = -(-(-(-frames // ranges)) // stage) * stage
        n = -(-frames // split_frames)
        waves = -(-(_N_TILES * n * batch) // sms)
        cost = waves * (split_frames * terms + _ITEM_FRAMES)
        if best is None or cost < best[0]:
            best = (cost, split_frames, n)
    return best[1], best[2]


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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
    frames = -(-t // _HB)
    split_frames, n_ranges = _gram_k_ranges(batch, frames, split, _sm_count(dev.index or 0))
    halves = torch.empty(4, batch, frames * _HB, device=dev, dtype=torch.bfloat16)
    partial = torch.empty(batch, n_ranges, 2 * _SHIFTS, 2, 2, _HB, device=dev, dtype=torch.float32)
    r_auto = torch.empty(batch, n_lags, device=dev, dtype=torch.float32)
    r_cross = torch.empty(batch, n_lags, device=dev, dtype=torch.float32)
    cuda_lib.launch(KERNEL, dev, c, d, halves, partial, r_auto, r_cross, batch, t, _SPLIT_TERMS[split],
                    split_frames, n_ranges, count=KERNELS[split])
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
    return cuda_lib.dispatch("correlation kernel", c.device, _correlation_lags_plain, _correlation_lags_cuda, c, d,
                             n_lags, split)

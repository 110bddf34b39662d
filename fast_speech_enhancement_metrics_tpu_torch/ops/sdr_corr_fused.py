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
``_corr_kernel``). Its chunk DFT is bf16x3 on the tensor cores, as the
TPU kernel's: the chunks' halves from A4's split pass
(``sdr_corr_gram.split_halves``), stacked [xh, xh, xl], against the table
split once on the host, [wh; wl; wh] (``_table_halves``: the packed
table's columns permuted so that each 64-bin tile's re and x2 columns are
one block, transposed to K-major). Its groups are 127 windows (one chunk
row fewer than the JAX kernel's 128 + 1, so that a group fills whole
``wgmma`` tiles); the sum over groups only reorders. CPU tensors take the
plain version of the partials; CUDA tensors launch the kernel or raise.
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
#: windows per group of the CUDA kernel (csrc/sdr_corr_fused.cu, kWin)
KERNEL_WINDOWS = 127
#: bins per CTA of the CUDA kernel (kNB): a tile's packed columns are its
#: bins' re columns, then their x2 columns
_BIN_TILE = 64


@functools.lru_cache(maxsize=None)
def _packed_corr_matrix(h: int) -> np.ndarray:
    """(h, 2h) packed [cos 0..h-1 | cos_h | sin 1..h-1] chunk-DFT matrix."""
    cos, sin = _rdft_matrices(2 * h)  # (2h, h+1) each; rows h.. unused here
    return np.concatenate([cos[:h, :h], cos[:h, h:h + 1], sin[:h, 1:h]], axis=1).astype(np.float32)


def _table_columns(h: int) -> torch.Tensor:
    """The CUDA kernel's order of the packed table's 2h columns: per tile
    of 64 bins f0.., the re columns f0.. f0 + 63, then the x2 columns h +
    f0 .. h + f0 + 63."""
    tiles = torch.arange(h // _BIN_TILE)[:, None, None] * _BIN_TILE
    cols = tiles + torch.arange(_BIN_TILE)[None, None, :] + torch.tensor([0, h])[None, :, None]
    return cols.reshape(-1)


@functools.lru_cache(maxsize=None)
def _table_halves_bits(h: int) -> np.ndarray:
    """(2, 2h, h) int16, the bits of the bf16 table operand: the packed
    chunk-DFT table split once into wh = bf16(w) and wl = bf16(w - wh), as
    the JAX kernel's [wh; wl; wh] operand, with its columns in
    ``_table_columns`` order and transposed (row n holds column n,
    K-major)."""
    w = torch.from_numpy(_packed_corr_matrix(h))
    wh = w.to(torch.bfloat16)
    wl = (w - wh.float()).to(torch.bfloat16)
    cols = _table_columns(h)
    return torch.stack([wh[:, cols].t(), wl[:, cols].t()]).contiguous().view(torch.int16).numpy()


def _table_halves(h: int, device: torch.device | str = "cpu") -> torch.Tensor:
    """``_table_halves_bits`` as a bf16 tensor on ``device`` (one copy per device)."""
    return device_table(_table_halves_bits(h), torch.device(device)).view(torch.bfloat16)


def _corr_dft_reference(halves: torch.Tensor, h: int) -> torch.Tensor:
    """The CUDA kernel's arithmetic in torch, in float64, for the tests:
    from the halves (4, B, chunks x h) and ``_table_halves``, per group of
    ``KERNEL_WINDOWS`` windows and tile of 64 bins, the spectra of the
    clean chunks j 127 - 1 .. (128 rows; zeros before chunk 0 and past the
    last) and the denoised chunks j 127 .. (128 rows) as xh wh + xh wl + xl
    wh, then the six products over the group's windows, indexed as the
    epilogue reads them: (B, groups, 6, h)."""
    _, batch, row_len = halves.shape
    n_chunks = row_len // h
    n_groups = -(-n_chunks // KERNEL_WINDOWS)
    x = halves.double().reshape(4, batch, n_chunks, h)
    pad = n_groups * KERNEL_WINDOWS + 1 - n_chunks
    clean = F.pad(x[:2], (0, 0, 1, pad))  # clean row r of group j: chunk j 127 - 1 + r
    den = F.pad(x[2:], (0, 0, 0, pad + 1))
    wt = _table_halves(h).double()  # (2, 2h, h)
    partial = torch.zeros(batch, n_groups, 6, h, dtype=torch.float64)
    f = torch.arange(_BIN_TILE)
    sign = 1.0 - 2.0 * (f % 2).double()  # (-1)^bin: a tile starts at an even bin
    for j in range(n_groups):
        rows = slice(j * KERNEL_WINDOWS, j * KERNEL_WINDOWS + 128)
        for tile in range(h // _BIN_TILE):
            cols = slice(tile * 2 * _BIN_TILE, (tile + 1) * 2 * _BIN_TILE)
            wh, wl = wt[0, cols].t(), wt[1, cols].t()

            def spectra(hi, lo):
                return hi @ wh + hi @ wl + lo @ wh

            sc, sd = spectra(*clean[:, :, rows]), spectra(*den[:, :, rows])
            m = slice(0, KERNEL_WINDOWS)
            re0, x20 = sc[:, m, :_BIN_TILE], sc[:, m, _BIN_TILE:]
            re1, x21 = sc[:, 1:KERNEL_WINDOWS + 1, :_BIN_TILE], sc[:, 1:KERNEL_WINDOWS + 1, _BIN_TILE:]
            red, x2d = sd[:, m, :_BIN_TILE], sd[:, m, _BIN_TILE:]
            re_w, x2_w = re0 + sign * re1, x20 + sign * x21
            prods = (re_w * re1, x2_w * x21, x2_w * re1 - re_w * x21, re_w * red, x2_w * x2d, x2_w * red - re_w * x2d)
            for q, p in enumerate(prods):
                partial[:, j, q, tile * _BIN_TILE:(tile + 1) * _BIN_TILE] = p.sum(dim=1)
    return partial


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


def _corr_partials_cuda(c: torch.Tensor, d: torch.Tensor, h: int) -> torch.Tensor:
    dev = c.device
    cuda_lib.check_operand(c, "c", dev, torch.float32, 2)
    cuda_lib.check_operand(d, "d", dev, torch.float32, 2)
    if h % _BIN_TILE:
        raise ValueError(f"the fused correlation kernel takes n_lags % {_BIN_TILE} == 0, got {h}")
    batch, t = c.shape
    if batch == 0 or t == 0:
        raise ValueError(f"need at least one row and one sample, got {tuple(c.shape)}")
    n_chunks = -(-t // h)
    n_groups = -(-n_chunks // KERNEL_WINDOWS)
    halves = torch.empty(4, batch, n_chunks * h, device=dev, dtype=torch.bfloat16)
    partial = torch.empty(batch, n_groups, 6, h, device=dev, dtype=torch.float32)
    table = _table_halves(h, dev)
    cuda_lib.launch("corr_fused", dev, c, d, halves, table, partial, batch, t, h, n_groups,
                    count=KERNEL_A10_RAW if t % h == 0 else KERNEL_A10)
    return partial


@functools.lru_cache(maxsize=None)
def _partial_lag_matrix(h: int, n_lags: int) -> np.ndarray:
    """(3h, n_lags): the unpack and the inverse DFT at the lags as one
    matrix on a correlation's partial sums [P1 | P2 | Q]. Bins 0..h: Re S =
    [P1[0], P1[1..h-1] + P2[1..h-1], P2[0]], Im S = [0, Q[1..h-1], 0] (bins
    0 and h are real), and r = Re S icos - Im S isin."""
    icos, isin = _inverse_lag_matrices(h, n_lags)  # (h + 1, n_lags) each
    m = np.zeros((3 * h, n_lags), np.float32)
    m[:h] = icos[:h]
    m[h] = icos[h]
    m[h + 1:2 * h] = icos[1:h]
    m[2 * h + 1:] = -isin[1:h]
    return m


def _lags_from_partials(partial: torch.Tensor, n_lags: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, groups, 6, h) partials -> (r_auto, r_cross): the sum over groups,
    then the unpack and the inverse DFT at the lags as one product."""
    batch, _, _, h = partial.shape
    s = torch.sum(partial, dim=1).reshape(batch * 2, 3 * h)  # [P1 | P2 | Q] of each correlation
    # one 2-D product (cuBLAS takes a slower kernel for a batched one of these shapes)
    r = (s @ device_table(_partial_lag_matrix(h, n_lags), s.device)).reshape(batch, 2, n_lags)
    return r[:, 0], r[:, 1]


def _correlation_lags_fused_plain(
    c: torch.Tensor, d: torch.Tensor, n_lags: int, chunk_block: int = 128
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``correlation_lags_fused`` (any device)."""
    return _lags_from_partials(_corr_partials_plain(c.float(), d.float(), n_lags, chunk_block), n_lags)


def _correlation_lags_fused_cuda(c: torch.Tensor, d: torch.Tensor, n_lags: int) -> tuple[torch.Tensor, torch.Tensor]:
    return _lags_from_partials(_corr_partials_cuda(c.float().contiguous(), d.float().contiguous(), n_lags), n_lags)


def correlation_lags_fused(
    c: torch.Tensor, d: torch.Tensor, n_lags: int, chunk_block: int = 128
) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel A10 wrapper: c, d (B, T) -> (r_auto, r_cross), each (B, n_lags),
    with ``r[l] = sum_t c[t-l] * y[t]``. ``chunk_block``: windows per group
    of the plain version (the JAX kernel's); the CUDA kernel groups its own
    (``KERNEL_WINDOWS``), which only reorders the sum."""
    assert c.ndim == 2 and c.shape == d.shape
    # the packed (-1)^f window combine reuses one sign vector across both
    # column blocks, which needs the Nyquist bin (col h, sign (-1)^h) even
    assert n_lags % 2 == 0, f"fused correlations require even n_lags, got {n_lags}"
    return cuda_lib.dispatch("correlation kernel", c.device,
                             lambda: _correlation_lags_fused_plain(c, d, n_lags, chunk_block),
                             lambda: _correlation_lags_fused_cuda(c, d, n_lags))

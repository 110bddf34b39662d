"""Framed real DFT, framed spectrogram and lag correlations as matmuls.

Counterpart of the JAX package's ``ops/dft.py``. The DFT tables are built
in float64 numpy and rounded to float32, exactly as the JAX package builds
them; the transforms are float32 ``torch.matmul`` calls (TF32 must be off,
which is PyTorch's default for matmuls), so every spectrum here is a plain
GEMM on the card.

Framing fusion: with hop h dividing n_fft = k*h, frame f is the
concatenation of hop-chunks [f, f+1, .., f+k-1] of the signal, so the
framed DFT is a sum of k matmuls on shifted views of the (T//h, h) chunk
reshape; no (frames, n_fft) tensor is materialized.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from fast_speech_enhancement_metrics_tpu_torch.ops.stft import (
    device_table,
    hann_window,
    num_frames,
)


@functools.lru_cache(maxsize=None)
def _rdft_matrices(n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    """(n_fft, n_bins) cos / -sin matrices of the one-sided real DFT.

    Computed in float64, returned as float32: ``x @ cos`` is Re(rfft(x)),
    ``x @ sin`` is Im(rfft(x)).
    """
    n_bins = n_fft // 2 + 1
    t = np.arange(n_fft, dtype=np.float64)[:, None]
    f = np.arange(n_bins, dtype=np.float64)[None, :]
    ang = -2.0 * np.pi * t * f / n_fft
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _windowed_rdft_matrices(
    n_fft: int, win_length: int | None, window_key: object
) -> tuple[np.ndarray, np.ndarray]:
    """DFT matrices with the analysis window folded into their rows."""
    cos, sin = _rdft_matrices(n_fft)
    if window_key is None:
        w = hann_window(win_length or n_fft).astype(np.float64)
        if len(w) < n_fft:  # torch.stft center-pads the window
            left = (n_fft - len(w)) // 2
            w = np.pad(w, (left, n_fft - len(w) - left))
    else:
        w = np.asarray(window_key, dtype=np.float64)
        assert w.shape == (n_fft,)
    return (cos * w[:, None]).astype(np.float32), (sin * w[:, None]).astype(
        np.float32
    )


@functools.lru_cache(maxsize=None)
def _shift_matrices(
    n_fft: int, hop: int, win_length: int | None, window_key: object
) -> tuple[tuple[int, np.ndarray], ...]:
    """(shift i, packed (hop, 2*n_bins) cos|sin rows of shift i) for every
    shift whose window rows are not all zero (STOI's 256-tap window
    center-padded to 512 leaves shifts 0 and 3 empty)."""
    cos, sin = _windowed_rdft_matrices(n_fft, win_length, window_key)
    out = []
    for i in range(n_fft // hop):
        cos_i = cos[i * hop : (i + 1) * hop]
        sin_i = sin[i * hop : (i + 1) * hop]
        if cos_i.any() or sin_i.any():
            out.append((i, np.concatenate([cos_i, sin_i], axis=1)))
    return tuple(out)


def framed_rdft(
    x: torch.Tensor,
    n_fft: int,
    hop: int,
    win_length: int | None = None,
    center: bool = False,
    window: np.ndarray | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Windowed framed real DFT of (..., T) -> (re, im), each (..., F, n_bins).

    ``torch.stft`` semantics (constant padding when ``center``), frames-major
    layout. Requires ``hop`` to divide ``n_fft``.
    """
    assert n_fft % hop == 0, "framed_rdft requires hop | n_fft"
    window_key = None if window is None else tuple(np.asarray(window).tolist())
    n_bins = n_fft // 2 + 1
    if center:
        pad = n_fft // 2
        x = F.pad(x, (pad, pad))

    t = x.shape[-1]
    f = num_frames(t, n_fft, hop)
    shape = x.shape[:-1] + (max(f, 0), n_bins)
    if f <= 0:
        return x.new_zeros(shape), x.new_zeros(shape)

    n_chunks = f + n_fft // hop - 1
    usable = n_chunks * hop
    if usable > t:
        x = F.pad(x, (0, usable - t))
    chunks = x[..., :usable].reshape(x.shape[:-1] + (n_chunks, hop))

    out = None
    for i, packed in _shift_matrices(n_fft, hop, win_length, window_key):
        o = chunks[..., i : i + f, :] @ device_table(packed, x.device)
        out = o if out is None else out + o
    if out is None:
        return x.new_zeros(shape), x.new_zeros(shape)
    return out[..., :n_bins], out[..., n_bins:]


def framed_spectrogram(
    x: torch.Tensor,
    n_fft: int,
    hop: int,
    win_length: int | None = None,
    center: bool = False,
    power: float = 2.0,
    window: np.ndarray | None = None,
) -> torch.Tensor:
    """Magnitude (power=1) / power (power=2) spectrogram, frames-major."""
    re, im = framed_rdft(
        x, n_fft, hop, win_length=win_length, center=center, window=window
    )
    mag_sq = re * re + im * im
    if power == 2.0:
        return mag_sq
    if power == 1.0:
        return torch.sqrt(mag_sq)
    return mag_sq ** (power / 2.0)


@functools.lru_cache(maxsize=None)
def _chunk_rdft_matrix_packed(n_fft: int) -> np.ndarray:
    """(n_fft/2, n_fft) packed cos|sin chunk-DFT matrix, bins 0..n_fft/2-1.

    Transforms a hop-sized chunk (hop = n_fft/2) at the n_fft-point DFT
    frequencies. The Nyquist bin is the alternating-sign chunk sum and the
    guard bin n_fft/2+1 is conj(bin n_fft/2-1) by Hermitian symmetry; the
    LSD kernel (``ops/lsd_fused.py``) reconstructs both.
    """
    hop = n_fft // 2
    nb = n_fft // 2
    t = np.arange(hop, dtype=np.float64)[:, None]
    f = np.arange(nb, dtype=np.float64)[None, :]
    ang = -2.0 * np.pi * t * f / n_fft
    return np.concatenate([np.cos(ang), np.sin(ang)], axis=1).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _split_window_chunk_matrices(
    n_fft: int, window_key: tuple, n_bins: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Packed windowed chunk-DFT matrix + combine constants for
    ``framed_rdft_center_half``.

    For a window supported on the middle half of the frame (taps
    [hop, 3*hop) with hop = n_fft/4), frame f is chunk_{f+1}·w_a at offset
    hop plus chunk_{f+2}·w_b at offset 2*hop, so the windowed frame spectrum
    is X_f[k] = B1_{f+1}[k]·e^{-i·pi·k/2} + B2_{f+2}[k]·(-1)^k with B1/B2
    the DFTs of the w_a/w_b-windowed chunks. Returns the (hop, 4*n_bins)
    packed [w_a·cos | w_a·sin | w_b·cos | w_b·sin] matrix and the (n_bins,)
    combine constants (cos, sin of -pi*k/2, (-1)^k).
    """
    hop = n_fft // 4
    w = np.asarray(window_key, dtype=np.float64)
    assert w.shape == (n_fft,)
    assert not (w[:hop].any() or w[3 * hop :].any()), (
        "window must be supported on the middle half of the frame"
    )
    t = np.arange(n_fft, dtype=np.float64)[:, None]
    f = np.arange(n_bins, dtype=np.float64)[None, :]
    ang = -2.0 * np.pi * t * f / n_fft
    cos64, sin64 = np.cos(ang), np.sin(ang)
    wa = w[hop : 2 * hop, None]
    wb = w[2 * hop : 3 * hop, None]
    packed = np.concatenate(
        [
            wa * cos64[:hop],
            wa * sin64[:hop],
            wb * cos64[:hop],
            wb * sin64[:hop],
        ],
        axis=1,
    ).astype(np.float32)
    k = np.arange(n_bins, dtype=np.float64)
    cr = np.cos(-np.pi * k / 2).round().astype(np.float32)  # 1,0,-1,0,..
    ci = np.sin(-np.pi * k / 2).round().astype(np.float32)  # 0,-1,0,1,..
    s2 = ((-1.0) ** k).astype(np.float32)
    return packed, cr, ci, s2


def framed_rdft_center_half(
    x: torch.Tensor,
    n_fft: int,
    hop: int,
    window: np.ndarray,
    n_bins: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Framed real DFT for windows supported on the frame's middle half.

    Same spectra as ``framed_rdft`` at half the matmul FLOPs: each
    hop-chunk gets ONE (hop, 4*n_bins) windowed-DFT matmul shared by the
    two frames that contain it. Built for STOI's 512-point / hop-128 STFT
    whose 256-tap window is center-padded. ``n_bins`` may trim bins that no
    caller reads.
    """
    assert n_fft == 4 * hop, "center-half factorization requires hop = n_fft/4"
    if n_bins is None:
        n_bins = n_fft // 2 + 1
    assert n_bins <= n_fft // 2 + 1
    window_key = tuple(np.asarray(window, dtype=np.float64).tolist())
    packed, cr, ci, s2 = _split_window_chunk_matrices(n_fft, window_key, n_bins)

    t = x.shape[-1]
    f = num_frames(t, n_fft, hop)
    if f <= 0:
        shape = x.shape[:-1] + (0, n_bins)
        return x.new_zeros(shape), x.new_zeros(shape)
    n_chunks = f + 2  # chunk indices 1 .. f+1 are consumed
    usable = (n_chunks + 1) * hop
    if usable > t:
        x = F.pad(x, (0, usable - t))
    chunks = x[..., :usable].reshape(x.shape[:-1] + (n_chunks + 1, hop))

    dev = x.device
    b = chunks @ device_table(packed, dev)
    b1re = b[..., 1 : f + 1, 0 * n_bins : 1 * n_bins]
    b1im = b[..., 1 : f + 1, 1 * n_bins : 2 * n_bins]
    b2re = b[..., 2 : f + 2, 2 * n_bins : 3 * n_bins]
    b2im = b[..., 2 : f + 2, 3 * n_bins : 4 * n_bins]
    crj, cij, s2j = (device_table(a, dev) for a in (cr, ci, s2))
    re = b1re * crj - b1im * cij + s2j * b2re
    im = b1re * cij + b1im * crj + s2j * b2im
    return re, im


@functools.lru_cache(maxsize=None)
def _inverse_lag_matrices(h: int, n_lags: int) -> tuple[np.ndarray, np.ndarray]:
    """(n_bins, n_lags) inverse-rDFT matrices of the overlap-save correlation.

    Inverse rDFT of a 2h-point spectrum evaluated only at the wanted points
    m = h - l: r[m] = (1/w) * sum_f alpha_f * (Re S cos(2 pi f m / w)
    - Im S sin(...)).
    """
    w = 2 * h
    n_bins = h + 1
    m_pts = (h - np.arange(n_lags, dtype=np.float64))[None, :]
    f_pts = np.arange(n_bins, dtype=np.float64)[:, None]
    alpha = np.where((f_pts == 0) | (f_pts == h), 1.0, 2.0) / w
    ang = 2.0 * np.pi * f_pts * m_pts / w
    return (
        (alpha * np.cos(ang)).astype(np.float32),
        (alpha * np.sin(ang)).astype(np.float32),
    )


@functools.lru_cache(maxsize=None)
def _lag_tables(n_lags: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Lower-half rows of the 2*n_lags-point DFT (cos, sin) and the (-1)^f
    window-combine signs of ``correlation_lags``."""
    cos, sin = _rdft_matrices(2 * n_lags)
    sign = (1.0 - 2.0 * (np.arange(n_lags + 1) % 2)).astype(np.float32)
    return np.ascontiguousarray(cos[:n_lags]), np.ascontiguousarray(sin[:n_lags]), sign


def correlation_lags(
    c: torch.Tensor,
    others: tuple[torch.Tensor, ...],
    n_lags: int,
) -> list[torch.Tensor]:
    """Correlations ``b_y[l] = sum_t c[t-l] * y[t]`` for lags 0..n_lags-1.

    Overlap-save: the signals are cut into ``n_lags``-sized blocks whose
    2*n_lags-point DFTs are matmuls; the spectral products are summed over
    blocks before the inverse DFT at the n_lags wanted points. ``c`` is the
    lagged signal; each ``y`` in ``others`` may be ``c`` itself
    (autocorrelation). All shapes (..., T); lags beyond the signal see
    zeros (the zero-padded linear correlation).
    """
    h = n_lags
    t = c.shape[-1]
    k_blocks = -(-t // h)
    pad_t = k_blocks * h - t
    dev = c.device

    # windows of c: [chunk_k, chunk_{k+1}] over chunks of the left-padded
    # signal, so window k spans c[h*k-h : h*k+h]
    chunks = F.pad(c, (h, pad_t)).reshape(c.shape[:-1] + (k_blocks + 1, h))
    cos_np, sin_np, sign_np = _lag_tables(n_lags)
    cos_lo, sin_lo, sign = (device_table(a, dev) for a in (cos_np, sin_np, sign_np))

    # rows h..2h-1 of the 2h-point DFT are (-1)^f times rows 0..h-1, so the
    # two-chunk window spectrum combines adjacent chunk spectra
    re_c = chunks @ cos_lo
    im_c = chunks @ sin_lo
    re_w = re_c[..., :-1, :] + sign * re_c[..., 1:, :]
    im_w = im_c[..., :-1, :] + sign * im_c[..., 1:, :]

    icos_np, isin_np = _inverse_lag_matrices(h, n_lags)
    icos, isin = device_table(icos_np, dev), device_table(isin_np, dev)

    out = []
    for y in others:
        if y is c:
            # blocks of c (right-padded) are chunks[1:] of the left-padded view
            re_y, im_y = re_c[..., 1:, :], im_c[..., 1:, :]
        else:
            yb = F.pad(y, (0, pad_t)).reshape(y.shape[:-1] + (k_blocks, h))
            re_y = yb @ cos_lo
            im_y = yb @ sin_lo
        # S[f] = sum_k W_k[f] * conj(Y_k[f])
        s_re = torch.sum(re_w * re_y + im_w * im_y, dim=-2)
        s_im = torch.sum(im_w * re_y - re_w * im_y, dim=-2)
        out.append(s_re @ icos - s_im @ isin)
    return out

"""IIR filtering without a sequential recursion.

Counterpart of the JAX package's ``ops/iir.py``. ``lfilter`` with a zero
initial state is a causal convolution with the filter's impulse response,
so a stable filter needs no recursion over the samples:

* ``lfilter_fir`` (PESQ's path) truncates the impulse response where it has
  decayed below float32 significance and applies it as ``taps/block + 1``
  float32 matmuls on shifted views of the signal's block reshape (TF32 off,
  PyTorch's default for matmuls), so on the card it is a few GEMMs;
* ``lfilter_fft`` multiplies one large rFFT by the transfer function on the
  DFT grid (``torch.fft.rfft`` / ``irfft``), for long or slowly decaying
  filters.

The impulse response and the transfer function are computed in float64 on
the host, exactly as the JAX package computes them.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from fast_speech_enhancement_metrics_tpu_torch.ops.stft import device_table


@functools.lru_cache(maxsize=None)
def _freq_response(b: tuple, a: tuple, n: int) -> np.ndarray:
    """Transfer function B(z)/A(z) on the length-``n`` rFFT grid (float64
    arithmetic, complex64 result)."""
    k = np.arange(n // 2 + 1)
    zinv = np.exp(-2j * np.pi * k / n)  # z^-1 on the unit circle
    num = np.zeros_like(zinv)
    den = np.zeros_like(zinv)
    for i, coeff in enumerate(b):
        num = num + coeff * zinv**i
    for i, coeff in enumerate(a):
        den = den + coeff * zinv**i
    return (num / den).astype(np.complex64)


def next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


@functools.lru_cache(maxsize=None)
def _impulse_response(b: tuple, a: tuple, taps: int) -> np.ndarray:
    """First ``taps`` samples of the filter's impulse response (float64).

    Direct-form recursion on the host; asserts that the response has decayed
    to float32 insignificance by the truncation point, so the FIR below is
    the IIR to round-off.
    """
    b = np.asarray(b, np.float64)
    a = np.asarray(a, np.float64)
    h = np.zeros(taps, np.float64)
    for n in range(taps):
        acc = b[n] if n < len(b) else 0.0
        for k in range(1, min(n + 1, len(a))):
            acc -= a[k] * h[n - k]
        h[n] = acc / a[0]
    peak = np.abs(h).max()
    tail = np.abs(h[-32:]).max()
    assert tail <= 1e-8 * peak, (
        f"impulse response not decayed at {taps} taps: tail {tail:.3e} vs peak {peak:.3e}"
    )
    return h


@functools.lru_cache(maxsize=None)
def _fir_blocks(b: tuple, a: tuple, taps: int, block: int) -> tuple[np.ndarray, ...]:
    """The ``taps/block + 1`` (block, block) float32 matrices H_i with
    ``H[i*block + r, j] = h[taps + j - i*block - r]`` (0 outside the
    response)."""
    h = _impulse_response(b, a, taps)
    w = taps + block
    i_idx = np.arange(w)[:, None]
    j_idx = np.arange(block)[None, :]
    tau = taps + j_idx - i_idx
    h_mat = np.where((tau >= 0) & (tau < taps), h[np.clip(tau, 0, taps - 1)], 0.0)
    h_mat = h_mat.astype(np.float32)  # (w, block)
    return tuple(np.ascontiguousarray(h_mat[i * block : (i + 1) * block]) for i in range(taps // block + 1))


def lfilter_fir(
    x: torch.Tensor,
    b: tuple | np.ndarray,
    a: tuple | np.ndarray,
    taps: int = 768,
    block: int = 256,
) -> torch.Tensor:
    """Causal IIR filter of (..., T) as a truncated-impulse FIR.

    Both PESQ filters have pole radius <= 0.973, so their impulse responses
    fall below 1e-9 of peak within 768 samples. Output block c is
    ``sum_i chunks[c + i] @ H_i`` over the blocks of the signal left-padded
    by ``taps`` zeros; no (T, taps) tensor is built.
    """
    assert taps % block == 0, "taps must be a multiple of block"
    mats = _fir_blocks(tuple(np.asarray(b)), tuple(np.asarray(a)), taps, block)

    t = x.shape[-1]
    n_blocks = -(-t // block)
    xp = F.pad(x, (taps, n_blocks * block - t))
    chunks = xp.reshape(x.shape[:-1] + (n_blocks + taps // block, block))

    y = None
    for i, m in enumerate(mats):
        y_i = chunks[..., i : i + n_blocks, :] @ device_table(m, x.device)
        y = y_i if y is None else y + y_i
    return y.reshape(x.shape[:-1] + (n_blocks * block,))[..., :t].to(x.dtype)


def lfilter_fft(
    x: torch.Tensor,
    b: tuple | np.ndarray,
    a: tuple | np.ndarray,
    tail: int = 8192,
) -> torch.Tensor:
    """Causal IIR filter of (..., T) with zero initial conditions.

    Matches ``scipy.signal.lfilter(b, a, x)`` to float32 round-off for
    stable filters whose impulse response decays within ``tail`` samples.
    """
    t = x.shape[-1]
    n = next_pow2(t + tail)
    h = device_table(_freq_response(tuple(np.asarray(b)), tuple(np.asarray(a)), n), x.device)
    spectrum = torch.fft.rfft(x, n=n, dim=-1)
    y = torch.fft.irfft(spectrum * h, n=n, dim=-1)
    return y[..., :t].to(x.dtype)

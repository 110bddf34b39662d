"""Framed STFT primitives and the Hann window (``torch.stft`` semantics).

Counterpart of the JAX package's ``ops/stft.py``: the window is built in
float64 numpy and handed to PyTorch as a constant table; framing is a strided
view (``Tensor.unfold``), the FFT ``torch.fft.rfft``. ``stft`` and
``spectrogram`` are public API only (the metrics use ``ops/dft.py``); they
run on the input tensor's device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

#: device copies of host-built constant tables, keyed by (id(table), device)
_DEVICE_TABLES: dict = {}


def device_table(table: np.ndarray, device: torch.device) -> torch.Tensor:
    """Device copy of a constant numpy table, made once per device.

    Only for tables that live for the whole process (the ``lru_cache``d
    table functions in ``ops/``): the cache keys on the array's identity and keeps
    the array alive beside its copy, so the identity cannot be reused.
    """
    key = (id(table), str(device))
    hit = _DEVICE_TABLES.get(key)
    if hit is None or hit[0] is not table:
        hit = (table, torch.from_numpy(np.ascontiguousarray(table)).to(device))
        _DEVICE_TABLES[key] = hit
    return hit[1]


def hann_window(win_length: int, periodic: bool = True, dtype=np.float32) -> np.ndarray:
    """Hann window matching ``torch.hann_window`` semantics.

    ``periodic=True`` (torch default) computes 0.5*(1-cos(2*pi*k/N)) for
    k=0..N-1; ``periodic=False`` uses N-1 in the denominator.
    """
    n = win_length if periodic else win_length - 1
    k = np.arange(win_length, dtype=np.float64)
    w = 0.5 * (1.0 - np.cos(2.0 * np.pi * k / n))
    return w.astype(dtype)


def num_frames(length: int, frame_length: int, hop: int) -> int:
    """Number of full frames of ``frame_length`` at stride ``hop`` (no padding)."""
    if length < frame_length:
        return 0
    return 1 + (length - frame_length) // hop


def frame(x: torch.Tensor, frame_length: int, hop: int) -> torch.Tensor:
    """Slice ``x`` (..., T) into overlapping frames (..., F, frame_length)."""
    f = num_frames(x.shape[-1], frame_length, hop)
    if f <= 0:
        return x.new_zeros(x.shape[:-1] + (0, frame_length))
    return x.unfold(-1, frame_length, hop)


@functools.lru_cache(maxsize=None)
def _window_cache(win_length: int, n_fft: int, periodic: bool) -> np.ndarray:
    w = hann_window(win_length, periodic=periodic)
    if win_length < n_fft:
        # torch.stft center-pads the window to n_fft
        left = (n_fft - win_length) // 2
        w = np.pad(w, (left, n_fft - win_length - left))
    return w


def stft(
    x: torch.Tensor,
    n_fft: int,
    hop: int,
    win_length: int | None = None,
    center: bool = False,
    window: np.ndarray | torch.Tensor | None = None,
) -> torch.Tensor:
    """Complex STFT of (..., T) -> (..., F_frames, n_fft//2+1), complex64.

    Matches ``torch.stft(..., pad_mode="constant", onesided=True)`` but with
    the frames axis *before* the frequency axis (torch returns (freq,
    frames)).
    """
    if window is None:
        w = device_table(_window_cache(win_length or n_fft, n_fft, True), x.device)
    else:
        w = torch.as_tensor(window, device=x.device)
    if center:
        pad = n_fft // 2
        x = torch.nn.functional.pad(x, (pad, pad))
    frames = frame(x, n_fft, hop) * w.to(x.dtype)
    return torch.fft.rfft(frames, dim=-1)


def spectrogram(
    x: torch.Tensor,
    n_fft: int,
    hop: int,
    win_length: int | None = None,
    center: bool = False,
    power: float = 2.0,
    window: np.ndarray | torch.Tensor | None = None,
) -> torch.Tensor:
    """Magnitude (power=1) or power (power=2) spectrogram, frames-major layout."""
    z = stft(x, n_fft, hop, win_length=win_length, center=center, window=window)
    mag_sq = z.real**2 + z.imag**2
    if power == 2.0:
        return mag_sq
    if power == 1.0:
        return torch.sqrt(mag_sq)
    return mag_sq ** (power / 2.0)

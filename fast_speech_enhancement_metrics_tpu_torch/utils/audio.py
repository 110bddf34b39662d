"""Deterministic synthetic speech/noise generation and SNR mixing.

The port's own copy of the synthetic generator: harmonic "speech" with
pitch/amplitude modulation and pauses, plus coloured noise, mixed at a
per-utterance SNR with RMS-based mixing math. The same seed gives the same
arrays as the JAX package's generator, so tests and benches on either side
score identical audio. There is no network loader: scoring runs offline.
"""

from __future__ import annotations

import numpy as np


def synth_speech(
    num_samples: int,
    duration_s: float,
    sample_rate: int = 16000,
    seed: int = 0,
) -> np.ndarray:
    """Speech-like signals: voiced harmonic stacks with f0/amplitude modulation,
    unvoiced noise bursts, and silent pauses. Shape (num_samples, T), float32."""
    rng = np.random.RandomState(seed)
    t_len = int(duration_s * sample_rate)
    t = np.arange(t_len) / sample_rate
    out = np.zeros((num_samples, t_len), dtype=np.float64)

    for i in range(num_samples):
        f0_base = rng.uniform(90, 220)
        # slowly varying pitch
        f0 = f0_base * (1.0 + 0.08 * np.sin(2 * np.pi * rng.uniform(0.3, 1.5) * t + rng.uniform(0, 6)))
        phase = 2 * np.pi * np.cumsum(f0) / sample_rate
        voiced = np.zeros(t_len)
        for h in range(1, 12):
            # formant-ish spectral envelope
            amp = np.exp(-0.5 * ((h * f0_base - rng.uniform(400, 2600)) / 700.0) ** 2)
            amp += 0.15 / h
            voiced += amp * np.sin(h * phase + rng.uniform(0, 6))
        # syllabic amplitude modulation (~3-6 Hz) with pauses
        envelope = 0.5 * (1 + np.sin(2 * np.pi * rng.uniform(2.5, 5.5) * t + rng.uniform(0, 6)))
        envelope = envelope ** 1.5
        gate = (np.sin(2 * np.pi * rng.uniform(0.2, 0.5) * t + rng.uniform(0, 6)) > -0.7).astype(float)
        # unvoiced fricative-like bursts
        unvoiced = rng.randn(t_len) * 0.1
        b = np.hanning(64)
        unvoiced = np.convolve(unvoiced, b - b.mean(), mode="same")
        sig = (voiced * envelope + unvoiced * (1 - envelope) * 2.0) * gate
        out[i] = sig / (np.abs(sig).max() + 1e-9) * rng.uniform(0.3, 0.9)

    return out.astype(np.float32)


def synth_noise(
    num_samples: int,
    duration_s: float,
    sample_rate: int = 16000,
    seed: int = 1,
) -> np.ndarray:
    """Colored (pink-ish) noise with slow amplitude flutter. (num_samples, T)."""
    rng = np.random.RandomState(seed)
    t_len = int(duration_s * sample_rate)
    t = np.arange(t_len) / sample_rate
    out = np.zeros((num_samples, t_len), dtype=np.float64)
    for i in range(num_samples):
        white = rng.randn(t_len)
        spec = np.fft.rfft(white)
        freqs = np.fft.rfftfreq(t_len, 1 / sample_rate)
        spec = spec / np.maximum(freqs, 30.0) ** 0.5
        pink = np.fft.irfft(spec, n=t_len)
        flutter = 1.0 + 0.5 * np.sin(2 * np.pi * rng.uniform(1.0, 8.0) * t + rng.uniform(0, 6))
        sig = pink * flutter
        out[i] = sig / (np.abs(sig).max() + 1e-9) * 0.7
    return out.astype(np.float32)


def combine_speech_noise(
    speech: np.ndarray,
    noise: np.ndarray,
    snr_high: float = 25.0,
    snr_low: float = -5.0,
    seed: int = 2,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Mix at per-utterance uniform-random SNR in [snr_low, snr_high] dB."""
    rng = np.random.RandomState(seed)
    speech_rms = np.sqrt(np.mean(speech**2, axis=1, keepdims=True))
    noise_rms = np.sqrt(np.mean(noise**2, axis=1, keepdims=True))
    snr = rng.rand(speech.shape[0], 1) * (snr_high - snr_low) + snr_low
    noise_scale = speech_rms / (10 ** (snr / 20)) / (noise_rms + 1e-12)
    noisy = speech + noise_scale * noise
    return speech.astype(np.float32), noisy.astype(np.float32), snr


def load_audio_data(
    sample_duration: float = 1.0,
    num_samples: int = 1,
    sample_rate: int = 16000,
    snr_high: float = 25.0,
    snr_low: float = -5.0,
    seed: int = 42,
    source: str = "synthetic",
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(clean, noisy, snr) batches from the deterministic synthetic generator.

    Only ``source="synthetic"`` exists here; streaming real speech needs the
    network and is not part of this package.
    """
    if source != "synthetic":
        raise ValueError(f"only source='synthetic' is available, got {source!r}")
    speech = synth_speech(num_samples, sample_duration, sample_rate, seed=seed)
    noise = synth_noise(num_samples, sample_duration, sample_rate, seed=seed + 1)
    return combine_speech_noise(speech, noise, snr_high, snr_low, seed=seed + 2)

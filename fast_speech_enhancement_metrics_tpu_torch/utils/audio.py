"""Deterministic synthetic speech/noise generation, SNR mixing, and the HF loaders.

The port's own copy of the synthetic generator: harmonic "speech" with
pitch/amplitude modulation and pauses, plus coloured noise, mixed at a
per-utterance SNR with RMS-based mixing math. The same seed gives the same
arrays as the JAX package's generator, so tests and benches on either side
score identical audio. ``load_audio_data(source="hf")`` streams the
reference's real speech and noise sets with ``datasets`` instead (network
required); when the stream or the package is missing it warns and returns
the synthetic batch, as the JAX package does.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from fast_speech_enhancement_metrics_tpu_torch.ops.resample import resample


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
    """(clean, noisy, snr) batches, shaped like the reference's loader.

    ``source="synthetic"`` (default) uses the deterministic generators, so
    tests and benches run offline; ``"hf"`` streams real speech and noise
    from the HF hub (``load_hf_speech`` / ``load_hf_noise``), and without
    the network or the ``datasets`` package (an ``ImportError`` or an
    ``OSError``, which the hub's and ``datasets``' errors are) warns
    (``RuntimeWarning``) and falls back to the synthetic batch; any other
    error propagates. Any other source raises ``ValueError``.
    """
    if source not in ("synthetic", "hf"):
        raise ValueError(f"source must be 'synthetic' or 'hf', got {source!r}")
    if source == "hf":
        try:
            speech = load_hf_speech(num_samples, sample_duration, sample_rate)
            noise = load_hf_noise(num_samples, sample_duration, sample_rate)
            return combine_speech_noise(speech, noise, snr_high, snr_low, seed=seed + 2)
        except (ImportError, OSError) as e:  # no datasets package / no network, hub or dataset
            warnings.warn(
                f"HF streaming unavailable ({type(e).__name__}: {e}); falling back to synthetic audio",
                RuntimeWarning,
                stacklevel=2,
            )
    speech = synth_speech(num_samples, sample_duration, sample_rate, seed=seed)
    noise = synth_noise(num_samples, sample_duration, sample_rate, seed=seed + 1)
    return combine_speech_noise(speech, noise, snr_high, snr_low, seed=seed + 2)


def _clip(item, sample_rate: int) -> np.ndarray:
    """One streamed clip as float32 numpy at ``sample_rate``: resampled on a
    CPU tensor by ``ops/resample.py`` (the loaders are host code; the
    metrics copy their batches to the device)."""
    audio = np.asarray(item["audio"]["array"], dtype=np.float32)
    orig_sr = int(item["audio"]["sampling_rate"])
    if orig_sr != sample_rate:
        audio = resample(torch.from_numpy(audio)[None], orig_sr, sample_rate)[0].numpy()
    return audio


def load_hf_noise(num_samples: int, duration_s: float, sample_rate: int = 16000) -> np.ndarray:
    """Stream the reference's noise set (nccratliri wing-flap noise):
    resample, concatenate clips until ``num_samples * duration_s`` seconds
    are on hand, tile if the whole set is shorter, and reshape to
    (num_samples, T): the reference's concat-then-chop semantics."""
    from datasets import load_dataset

    target_len = int(duration_s * sample_rate)
    total = num_samples * target_len
    stream = load_dataset("nccratliri/wing-flap-noise-audio-examples", split="train", streaming=True)
    parts, have = [], 0
    for item in stream:
        audio = _clip(item, sample_rate)
        parts.append(audio)
        have += len(audio)
        if have >= total:
            break
    noises = np.concatenate(parts) if parts else np.zeros(1, np.float32)
    if len(noises) < total:
        noises = np.tile(noises, total // len(noises) + 1)
    return noises[:total].reshape(num_samples, target_len)


def load_hf_speech(num_samples: int, duration_s: float, sample_rate: int = 16000) -> np.ndarray:
    """Stream real utterances from MLCommons peoples_speech (the reference's
    speech source): resample to the target rate and tile or crop each clip
    to exactly ``duration_s`` seconds."""
    from datasets import load_dataset

    target_len = int(duration_s * sample_rate)
    out = np.zeros((num_samples, target_len), dtype=np.float32)
    stream = load_dataset("MLCommons/peoples_speech", "clean", split="train", streaming=True)
    for i, item in enumerate(stream):
        if i >= num_samples:
            break
        audio = _clip(item, sample_rate)
        reps = -(-target_len // max(len(audio), 1))
        out[i] = np.tile(audio, reps)[:target_len]
    return out

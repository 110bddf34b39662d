"""The one traffic generator: a mix file of parameters -> a pool of calls.

A mix (``traffic/<name>.json``) fixes the work and the seed fills it in:

* ``pairs_per_call``: (clean, denoised) pairs in one public call;
* ``form``: ``"array"`` (two (pairs, samples) float32 arrays, every pair of
  a call one length) or ``"list"`` (two lists of 1-D float32 arrays);
* ``lengths``: ``{"kind": "fixed", "seconds": s}``; ``{"kind":
  "lognormal_quantiles", "median_s", "sigma", "min_s", "max_s",
  "layout_seed"}``: the N = pool_calls x pairs_per_call quantiles of a
  log-normal clipped to [min_s, max_s], in whole samples; or ``{"kind":
  "listed", "samples": [...], "layout_seed"}``: N lengths as listed (a
  test set's own, say). Both are dealt into calls by a permutation fixed by
  ``layout_seed``. Every seed gets the same calls of the same lengths; the
  seed orders them and makes the audio;
* ``pool_calls``: distinct calls made at set-up and cycled in the window;
* ``sample_rate``, ``snr_db`` ([low, high]): the mixing of speech and noise;
* ``trace_calls``: calls under the profiler in a ``--trace 1`` run.

The audio is the synthetic speech + coloured noise of the port's
``utils/audio.py`` (harmonic stacks with pitch and amplitude modulation,
fricative bursts and pauses; pink noise with flutter; mixed at an SNR
uniform in ``snr_db``), rewritten for torch and made on the device from the
seed, then copied to host memory once, as a user's loader hands it over.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
import statistics

import numpy as np
import torch


def derived_seed(seed: int, purpose: str) -> int:
    """A 63-bit seed for one use of the run's seed (any integer)."""
    digest = hashlib.sha256(f"{seed}/{purpose}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


@dataclasses.dataclass
class Call:
    """One public call's arguments and what it scores."""

    clean: object  # (pairs, samples) array, or a list of 1-D arrays
    denoised: object
    lengths: tuple[int, ...]  # samples of each pair
    sample_rate: int

    @property
    def audio_s(self) -> float:
        """Seconds of denoised audio the call scores."""
        return sum(self.lengths) / self.sample_rate


@dataclasses.dataclass
class Pool:
    calls: list[Call]
    order: list[int]  # pool indices in the order the window cycles them

    def warmup_indices(self) -> list[int]:
        """Pool indices whose calls cover every shape the window sends: each
        distinct tuple of lengths once, and at least two calls."""
        seen, out = set(), []
        for i, call in enumerate(self.calls):
            if call.lengths not in seen:
                seen.add(call.lengths)
                out.append(i)
        while len(out) < 2:
            out.append(len(out) % len(self.calls))
        return out


def call_lengths(traffic: dict) -> list[tuple[int, ...]]:
    """The samples of every pair of every pool call (the same for all seeds)."""
    sr = traffic["sample_rate"]
    pairs, n_calls = traffic["pairs_per_call"], traffic["pool_calls"]
    spec = traffic["lengths"]
    if spec["kind"] == "fixed":
        return [(int(round(spec["seconds"] * sr)),) * pairs for _ in range(n_calls)]
    n = pairs * n_calls
    if spec["kind"] == "lognormal_quantiles":
        normal = statistics.NormalDist()
        seconds = [
            min(spec["max_s"], max(spec["min_s"], spec["median_s"] * math.exp(spec["sigma"] * normal.inv_cdf((i + 0.5) / n))))
            for i in range(n)
        ]
        samples = np.array([int(round(s * sr)) for s in seconds])
    elif spec["kind"] == "listed":
        samples = np.array(spec["samples"], dtype=np.int64)
        if samples.shape != (n,) or samples.min() < 1:
            raise ValueError(f"listed lengths: {n} positive lengths wanted, got {samples.shape[0]}")
    else:
        raise ValueError(f"unknown lengths kind: {spec['kind']!r}")
    dealt = samples[np.random.RandomState(spec["layout_seed"]).permutation(n)]
    return [tuple(int(v) for v in dealt[i * pairs:(i + 1) * pairs]) for i in range(n_calls)]


def _uniform(gen: torch.Generator, lo: float, hi: float, rows: int) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(rows, 1, generator=gen, device=gen.device, dtype=torch.float64)


def _masked_max_abs(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.amax(torch.abs(x) * mask, dim=1, keepdim=True)


def _masked_rms(x: torch.Tensor, mask: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(torch.square(x) * mask, dim=1, keepdim=True) / lengths)


def synth_speech(gen: torch.Generator, mask: torch.Tensor, sr: int) -> torch.Tensor:
    """(rows, T) float64 speech-like rows, each normalised over its own
    length (``mask``), zero past it."""
    rows, t_len = mask.shape
    dev = gen.device
    t = torch.arange(t_len, device=dev, dtype=torch.float64)[None] / sr
    f0_base = _uniform(gen, 90, 220, rows)
    f0 = f0_base * (1.0 + 0.08 * torch.sin(2 * math.pi * _uniform(gen, 0.3, 1.5, rows) * t + _uniform(gen, 0, 6, rows)))
    phase = 2 * math.pi * torch.cumsum(f0, dim=1) / sr
    voiced = torch.zeros(rows, t_len, device=dev, dtype=torch.float64)
    for h in range(1, 12):
        amp = torch.exp(-0.5 * torch.square((h * f0_base - _uniform(gen, 400, 2600, rows)) / 700.0)) + 0.15 / h
        voiced += amp * torch.sin(h * phase + _uniform(gen, 0, 6, rows))
    envelope = (0.5 * (1 + torch.sin(2 * math.pi * _uniform(gen, 2.5, 5.5, rows) * t + _uniform(gen, 0, 6, rows)))) ** 1.5
    # pauses of up to ~1.3 s: each row starts voiced, so a short one is never silent throughout
    gate_phase = _uniform(gen, 0, 6, rows)
    gate_phase = torch.where(torch.sin(gate_phase) > -0.7, gate_phase, gate_phase + math.pi)
    gate = (torch.sin(2 * math.pi * _uniform(gen, 0.2, 0.5, rows) * t + gate_phase) > -0.7).double()
    white = torch.randn(rows, 1, t_len, generator=gen, device=dev, dtype=torch.float64) * 0.1
    hann = torch.hann_window(64, periodic=False, dtype=torch.float64, device=dev)
    unvoiced = torch.nn.functional.conv1d(white, (hann - hann.mean())[None, None], padding=32)[:, 0, :t_len]
    sig = (voiced * envelope + unvoiced * (1 - envelope) * 2.0) * gate * mask
    return sig / (_masked_max_abs(sig, mask) + 1e-9) * _uniform(gen, 0.3, 0.9, rows)


def synth_noise(gen: torch.Generator, mask: torch.Tensor, sr: int) -> torch.Tensor:
    """(rows, T) float64 pink-ish noise with slow flutter, normalised to a
    peak of 0.7 over each row's length."""
    rows, t_len = mask.shape
    dev = gen.device
    t = torch.arange(t_len, device=dev, dtype=torch.float64)[None] / sr
    spec = torch.fft.rfft(torch.randn(rows, t_len, generator=gen, device=dev, dtype=torch.float64), dim=1)
    freqs = torch.fft.rfftfreq(t_len, 1 / sr, device=dev, dtype=torch.float64)
    pink = torch.fft.irfft(spec / torch.clamp(freqs, min=30.0) ** 0.5, n=t_len, dim=1)
    flutter = 1.0 + 0.5 * torch.sin(2 * math.pi * _uniform(gen, 1.0, 8.0, rows) * t + _uniform(gen, 0, 6, rows))
    sig = pink * flutter * mask
    return sig / (_masked_max_abs(sig, mask) + 1e-9) * 0.7


def synth_pairs(gen: torch.Generator, lengths: tuple[int, ...], sr: int, snr_db) -> tuple[torch.Tensor, torch.Tensor]:
    """(clean, noisy) float32 (rows, max length) on the generator's device:
    speech, and speech plus noise at an SNR uniform in ``snr_db``."""
    dev = gen.device
    n = torch.tensor(lengths, device=dev, dtype=torch.float64)[:, None]
    mask = (torch.arange(max(lengths), device=dev)[None] < n).double()
    speech = synth_speech(gen, mask, sr)
    noise = synth_noise(gen, mask, sr)
    snr = _uniform(gen, snr_db[0], snr_db[1], len(lengths))
    scale = _masked_rms(speech, mask, n) / (10 ** (snr / 20)) / (_masked_rms(noise, mask, n) + 1e-12)
    return speech.float(), (speech + scale * noise).float()


def make_pool(traffic: dict, seed: int, device: torch.device) -> Pool:
    """The pool of calls of ``traffic`` for ``seed``, made on ``device`` and
    held in host memory as the public call takes it."""
    sr = traffic["sample_rate"]
    gen = torch.Generator(device=device)
    gen.manual_seed(derived_seed(seed, "audio"))
    calls = []
    for lengths in call_lengths(traffic):
        clean, noisy = (a.cpu().numpy() for a in synth_pairs(gen, lengths, sr, traffic["snr_db"]))
        if traffic["form"] == "array":
            calls.append(Call(clean, noisy, lengths, sr))
        elif traffic["form"] == "list":
            calls.append(Call([clean[i, :n].copy() for i, n in enumerate(lengths)],
                              [noisy[i, :n].copy() for i, n in enumerate(lengths)], lengths, sr))
        else:
            raise ValueError(f"unknown traffic form: {traffic['form']!r}")
    order = np.random.default_rng(derived_seed(seed, "order")).permutation(len(calls)).tolist()
    return Pool(calls, order)

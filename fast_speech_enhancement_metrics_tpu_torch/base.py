"""Base runtime: device placement, input preparation, in-graph resampling.

PyTorch counterpart of the JAX package's ``base.py``. A metric is a plain
function ``_compute(clean, denoised) -> dict[str, (B,) tensor]`` on tensors
already on the metric's device and at ``EXPECTED_SAMPLING_RATE``:

* inputs (torch tensors, numpy arrays or lists) are coerced to one float32
  tensor on the metric's device; 1-D inputs are a batch of one,
* resampling to the metric's rate happens on the device, before the metric,
* ``__call__`` makes one device->host copy per call (the score vectors,
  stacked) instead of one per utterance,
* ``compute_ragged`` scores variable-length utterances grouped by exact
  length, so no padding ever reaches a metric.

Metrics run on ``torch.device("cuda")`` unless the caller names another
device; on a machine without CUDA that default raises.
"""

from __future__ import annotations

import abc
from typing import Any

import numpy as np
import torch

from fast_speech_enhancement_metrics_tpu_torch.ops.resample import resample


def _to_tensor(audio: Any) -> torch.Tensor:
    """Accept torch tensors, numpy arrays and (nested) lists of numbers."""
    if isinstance(audio, torch.Tensor):
        return audio.detach()
    return torch.from_numpy(np.asarray(audio))


def _is_ragged(audio: Any) -> bool:
    """True for a list/tuple of 1-D utterances with differing lengths."""
    if not isinstance(audio, (list, tuple)) or len(audio) < 2:
        return False
    lengths = set()
    for a in audio:
        if np.isscalar(a) or (hasattr(a, "ndim") and a.ndim != 1):
            return False
        try:
            lengths.add(len(a))
        except TypeError:
            return False
    return len(lengths) > 1


def _resolve_device(device: torch.device | str | None) -> torch.device:
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"metric device {device} requested but CUDA is not available; "
            "pass device='cpu' to score on the CPU"
        )
    return device


class BaseMetric(abc.ABC):
    """Template for all metrics.

    Subclasses implement ``_compute(clean, denoised) -> dict[str, (B,) tensor]``
    on audio already at ``EXPECTED_SAMPLING_RATE``. ``__call__`` returns
    ``list[dict[str, float]]``, one dict per utterance.
    """

    higher_is_better: bool
    EXPECTED_SAMPLING_RATE: int
    #: metric consumes only the denoised signal (non-intrusive, e.g. DNSMOS)
    NON_INTRUSIVE: bool = False

    def __init__(
        self,
        sample_rate: int = 16000,
        device: torch.device | str | None = None,
        mesh: None = None,
        dtype: torch.dtype = torch.float32,
    ):
        """``mesh``: the JAX package's device mesh keyword; the port's
        multi-device layer is not ported yet (ROADMAP.md §A, ``parallel/``),
        so only ``None`` is taken. ``dtype``: the JAX package's parameter
        dtype keyword (its SpeechBERTScore loads a checkpoint's weights in
        it); the port keeps its parameters in float32, so only
        ``torch.float32`` is taken."""
        if mesh is not None:
            raise NotImplementedError(
                "mesh: the port's multi-device layer (parallel/, ROADMAP.md §A) is not ported yet; "
                "pass mesh=None"
            )
        if dtype != torch.float32:
            raise NotImplementedError(
                f"dtype={dtype}: the port keeps parameters in float32 only; pass dtype=torch.float32 "
                "(SpeechBERTScore's act_dtype runs its activations in bf16)"
            )
        self.sample_rate = sample_rate
        self.mesh = mesh
        self.dtype = dtype
        self.device = _resolve_device(device)

    def _on_cuda(self) -> bool:
        """True when this metric computes on a CUDA device: gates the kernel
        paths that the ``"auto"`` policies pick."""
        return self.device.type == "cuda"

    # -- input pipeline -----------------------------------------------------

    def prepare_audio(self, audio: Any) -> torch.Tensor:
        a = _to_tensor(audio)
        if a.ndim == 1:
            a = a[None, :]
        if a.ndim != 2:
            raise ValueError(f"audio must be 1-D or 2-D, got shape {tuple(a.shape)}")
        return a.to(device=self.device, dtype=torch.float32).contiguous()

    def prepare_inputs(self, clean_speech, denoised_speech):
        if clean_speech is not None:
            c = _to_tensor(clean_speech)
            d = _to_tensor(denoised_speech)
            if c.shape != d.shape:
                raise ValueError(
                    "`clean_speech` and `denoised_speech` should have the same shape."
                )
        clean = None if clean_speech is None else self.prepare_audio(clean_speech)
        denoised = self.prepare_audio(denoised_speech)
        return clean, denoised

    def _compute_resampled(self, clean, denoised):
        if self.sample_rate != self.EXPECTED_SAMPLING_RATE:
            if clean is not None:
                clean = resample(clean, self.sample_rate, self.EXPECTED_SAMPLING_RATE)
            denoised = resample(denoised, self.sample_rate, self.EXPECTED_SAMPLING_RATE)
        return self._compute(clean, denoised)

    # -- compute ------------------------------------------------------------

    @abc.abstractmethod
    def _compute(self, clean: torch.Tensor | None, denoised: torch.Tensor) -> dict[str, torch.Tensor]:
        """Inputs (B, T) at EXPECTED_SAMPLING_RATE. Returns (B,) tensors."""

    def _run_prepared(self, clean, denoised) -> dict[str, torch.Tensor]:
        """Score audio already on the device. Subclasses may override it to
        run their own execution plan; the default resamples and runs
        ``_compute``."""
        return self._compute_resampled(clean, denoised)

    def compute(self, clean_speech, denoised_speech) -> dict[str, torch.Tensor]:
        """Functional API: a dict of per-utterance score tensors on the device."""
        clean, denoised = self.prepare_inputs(clean_speech, denoised_speech)
        return self._run_prepared(clean, denoised)

    @staticmethod
    def _to_host(scores: dict[str, torch.Tensor]) -> list[dict[str, float]]:
        """One device->host copy of all score vectors -> one dict per row."""
        keys = list(scores)
        host = torch.stack([scores[k].float() for k in keys]).cpu().numpy()
        return [
            {k: float(host[i, row]) for i, k in enumerate(keys)}
            for row in range(host.shape[1])
        ]

    def __call__(self, clean_speech, denoised_speech) -> list[dict[str, float]]:
        if _is_ragged(denoised_speech):
            return self.compute_ragged(clean_speech, denoised_speech)
        return self._to_host(self.compute(clean_speech, denoised_speech))

    def compute_ragged(self, clean_speech, denoised_speech) -> list[dict[str, float]]:
        """Score variable-length utterances.

        Utterances are grouped by exact length and each group runs as one
        batched evaluation; no padding ever reaches a metric (zero padding
        changes PESQ/STOI/LSD values). ``__call__`` routes list inputs with
        unequal lengths here.
        """
        den = [_to_tensor(d) for d in denoised_speech]
        if any(d.ndim != 1 for d in den):
            raise ValueError("ragged inputs must be sequences of 1-D utterances")
        if clean_speech is None:
            cln = [None] * len(den)
        else:
            cln = [_to_tensor(c) for c in clean_speech]
            if len(cln) != len(den) or any(c.shape != d.shape for c, d in zip(cln, den)):
                raise ValueError(
                    "`clean_speech` and `denoised_speech` should have the "
                    "same per-utterance shapes."
                )

        groups: dict[int, list[int]] = {}
        for i, d in enumerate(den):
            groups.setdefault(d.shape[0], []).append(i)

        results: list[dict[str, float] | None] = [None] * len(den)
        for idxs in groups.values():
            d = torch.stack([den[i].float() for i in idxs])
            c = None if clean_speech is None else torch.stack([cln[i].float() for i in idxs])
            rows = self._to_host(self.compute(c, d))
            for row, i in zip(rows, idxs):
                results[i] = row
        return results  # type: ignore[return-value]

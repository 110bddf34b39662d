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
  length, so no padding ever reaches a metric,
* under a ``torch.distributed`` ``DeviceMesh`` (``parallel/``) each rank
  scores its contiguous share of the batch over the ``data`` axis as a
  one-device call, and ``compute`` all-gathers the score vectors.
* while a ``torch.profiler`` session records, the entry, the exit and each
  ragged group are spans, and the host-to-device bytes a count
  (``tracing.py``).

Metrics run on ``torch.device("cuda")`` unless the caller names another
device; on a machine without CUDA that default raises.
"""

from __future__ import annotations

import abc
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from fast_speech_enhancement_metrics_tpu_torch import tracing
from fast_speech_enhancement_metrics_tpu_torch.ops.resample import resample
from fast_speech_enhancement_metrics_tpu_torch.parallel.mesh import axis_size, mesh_device


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
        mesh=None,
        dtype: torch.dtype = torch.float32,
    ):
        """``mesh``: a ``("data", "model")`` ``DeviceMesh``
        (``parallel.create_mesh``); the metric then runs on this rank's
        device, and every rank must make the same calls with the same
        batch. ``dtype``: the JAX package's parameter dtype keyword (its
        SpeechBERTScore loads a checkpoint's weights in it); the port keeps
        its parameters in float32, so only ``torch.float32`` is taken."""
        if mesh is not None:
            if device is not None:
                raise ValueError("pass device or mesh, not both: under a mesh the device is the rank's own")
            device = mesh_device(mesh)
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

    def _data_axis_size(self) -> int:
        return axis_size(self.mesh, "data")

    def prepare_audio(self, audio: Any) -> torch.Tensor:
        """(B, T) float32 on the metric's device. Under a mesh, the batch is
        padded to a multiple of the ``data`` axis with replicas of its last
        row (real audio, sliced off again in ``compute``), and this rank
        keeps its contiguous ``B / data`` rows."""
        a = _to_tensor(audio)
        if a.ndim == 1:
            a = a[None, :]
        if a.ndim != 2:
            raise ValueError(f"audio must be 1-D or 2-D, got shape {tuple(a.shape)}")
        n = self._data_axis_size()
        if n > 1:
            if a.shape[0] % n:
                a = torch.cat([a, a[-1:].expand(n - a.shape[0] % n, -1)])
            rows = a.shape[0] // n
            first = self.mesh.get_local_rank("data") * rows
            a = a[first:first + rows]
        out = a.to(device=self.device, dtype=torch.float32).contiguous()
        if a.device.type != "cuda" and out.device.type == "cuda":
            tracing.count("h2d_bytes", out.numel() * out.element_size())
        return out

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
        """Functional API: a dict of per-utterance score tensors on the device
        (under a mesh, all B rows on every rank)."""
        with tracing.span("fsem.entry"):
            clean, denoised = self.prepare_inputs(clean_speech, denoised_speech)
        scores = self._run_prepared(clean, denoised)
        n = self._data_axis_size()
        if n == 1:
            return scores
        keys = list(scores)
        local = torch.stack([scores[k].float() for k in keys])
        parts = [torch.empty_like(local) for _ in range(n)]
        dist.all_gather(parts, local, group=self.mesh.get_group("data"))
        d = _to_tensor(denoised_speech)
        full = torch.cat(parts, dim=1)[:, : 1 if d.ndim == 1 else d.shape[0]]  # the pad rows go
        return {k: full[i] for i, k in enumerate(keys)}

    @staticmethod
    def _to_host(scores: dict[str, torch.Tensor]) -> list[dict[str, float]]:
        """One device->host copy of all score vectors -> one dict per row."""
        with tracing.span("fsem.exit"):
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
            with tracing.span("fsem.ragged_group"):
                d = torch.stack([den[i].float() for i in idxs])
                c = None if clean_speech is None else torch.stack([cln[i].float() for i in idxs])
                rows = self._to_host(self.compute(c, d))
            for row, i in zip(rows, idxs):
                results[i] = row
        return results  # type: ignore[return-value]

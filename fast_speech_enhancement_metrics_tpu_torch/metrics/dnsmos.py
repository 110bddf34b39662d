"""DNSMOS (non-intrusive SIG/BAK/OVRL MOS).

Counterpart of the JAX package's ``metrics/dnsmos.py`` (Microsoft's
DNS-Challenge ``sig_bak_ovr.onnx`` pipeline, its segmentation fixed to exact
1 s hops):

* repeat-double the utterance until it reaches 9.01 s,
* slide 9.01 s windows at a 1 s hop,
* run the DNSMOS net on every window, apply the per-dimension polynomial
  calibration ``c + b1*x + b2*x^2``, average over windows.

All utterances' windows go through one batched net call. The default
``window_plan="shared_exact"`` runs the conv trunk once over each whole
signal plus per-window edge strips (``models/dnsmos_net.py``). There is no
hand kernel on this path: the convs are cuDNN's, the STFT and MLP cuBLAS
float32 matmuls, all with TF32 off.
"""

from __future__ import annotations

import numpy as np
import torch

from fast_speech_enhancement_metrics_tpu_torch.base import BaseMetric
from fast_speech_enhancement_metrics_tpu_torch.models.dnsmos_net import (
    DEFAULT_CHECKPOINT,
    MXU_CONV_PACK,
    WINOGRAD_CONV_PACK,
    dnsmos_net,
    dnsmos_net_shared,
    dnsmos_net_windowed_exact,
    load_params,
)
from fast_speech_enhancement_metrics_tpu_torch.ops.resample import resample
from fast_speech_enhancement_metrics_tpu_torch.ops.stft import frame

INPUT_LENGTH_S = 9.01
PRECISIONS = (None, "default", "high", "highest")

#: polynomial MOS calibration (SIG, BAK, OVR) from Microsoft's DNSMOS release
POLY_C = np.array([0.0052439, -0.39604546, 0.04602535], dtype=np.float32)
POLY_B1 = np.array([1.22083953, 1.60915514, 1.11546468], dtype=np.float32)
POLY_B2 = np.array([-0.08397278, -0.13166888, -0.06766283], dtype=np.float32)


class DNSMOS(BaseMetric):
    higher_is_better = True
    EXPECTED_SAMPLING_RATE = 16000
    NON_INTRUSIVE = True

    def __init__(
        self,
        sample_rate: int = 16000,
        checkpoint=DEFAULT_CHECKPOINT,
        segment_chunk: int | None = None,
        precision: str | None = "default",
        conv_dtype: torch.dtype | None = None,
        conv_pack: str | tuple | None = None,
        host_chunk: int | None = None,
        shared_conv: bool = False,
        window_plan: str = "shared_exact",
        **kw,
    ):
        """Keywords as in the JAX package:

        * ``segment_chunk``: windows per net call on the ``"per_window"``
          plan (caps device memory; same scores);
        * ``precision``: the JAX package's MXU pass count; ``"default"``
          and ``"highest"`` both run float32 convs with TF32 off here;
        * ``conv_dtype``: ``torch.bfloat16`` runs the trunk's activations in
          bf16 with float32 accumulation (see ``models/dnsmos_net.py``);
        * ``conv_pack``: ``"mxu"``, ``"winograd"`` or a per-layer tuple,
          the JAX package's TPU conv layouts of identical math; validated,
          and the same convolution runs;
        * ``host_chunk``: utterances (shared plans) or windows
          (``"per_window"``) per net call in a host loop, calibrated on the
          host in float64;
        * ``shared_conv=True`` (needs ``host_chunk``): the approximate
          shared-trunk plan without edge strips;
        * ``window_plan``: ``"shared_exact"`` (shared trunk + per-window
          edge strips, the per-window scores up to reassociation) or
          ``"per_window"`` (every window through the whole net).
        """
        super().__init__(sample_rate, **kw)
        self.window = int(INPUT_LENGTH_S * self.EXPECTED_SAMPLING_RATE)  # 144160
        self.hop = self.EXPECTED_SAMPLING_RATE
        self.segment_chunk = segment_chunk
        if precision not in PRECISIONS:
            raise ValueError(f"unknown precision: {precision!r} (use one of {PRECISIONS})")
        self.precision = precision
        if conv_dtype not in (None, torch.float32, torch.bfloat16):
            raise ValueError(f"conv_dtype must be None, torch.float32 or torch.bfloat16, got {conv_dtype}")
        self.conv_dtype = conv_dtype
        if conv_pack == "mxu":
            conv_pack = MXU_CONV_PACK
        elif conv_pack == "winograd":
            conv_pack = WINOGRAD_CONV_PACK
        elif isinstance(conv_pack, str):
            raise ValueError(
                f"unknown conv_pack: {conv_pack!r} "
                "(use 'mxu', 'winograd', a per-layer tuple, or None)"
            )
        self.conv_pack = conv_pack
        self.shared_conv = shared_conv
        if window_plan not in ("shared_exact", "per_window"):
            raise ValueError(f"unknown window_plan: {window_plan!r}")
        self.window_plan = window_plan
        self.host_chunk = host_chunk
        #: device memory cap (GB) for the shared_exact trunk's conv0 feature
        #: map; larger batches split into equal row chunks
        self.shared_chunk_gb = 6.0
        if shared_conv and host_chunk is None:
            raise ValueError("shared_conv requires host_chunk (utterances per step)")
        if host_chunk is not None and self.mesh is not None:
            raise ValueError("host_chunk is a single-device execution plan; use segment_chunk with a mesh")
        # under a mesh every rank holds the whole (small) net: replicated
        self.params = load_params(checkpoint, self.device)
        #: the calibration polynomial's coefficients on the device, made once
        #: here: a copy from the host inside a call would sync it
        self._poly = torch.from_numpy(np.stack([POLY_C, POLY_B1, POLY_B2])).to(self.device)

    # -- segmentation -----------------------------------------------------------

    def _tile_to_window(self, audio: torch.Tensor) -> torch.Tensor:
        """Repeat-double (B, T) audio until T >= 9.01 s (the reference's
        while-loop as a power-of-two tile count)."""
        t = audio.shape[1]
        if t == 0:
            raise ValueError("DNSMOS needs non-empty audio")
        reps = 1
        while t * reps < self.window:
            reps *= 2
        return audio.repeat(1, reps) if reps > 1 else audio

    def _segment(self, audio: torch.Tensor) -> torch.Tensor:
        """(B, T) -> (B, S, window): repeat-double to >= 9.01 s, then unfold."""
        return frame(self._tile_to_window(audio), self.window, self.hop)

    def _num_windows(self, audio: torch.Tensor) -> int:
        return (audio.shape[1] - self.window) // self.hop + 1

    def _shared_chunk_rows(self, batch: int, frames: int) -> int | None:
        """Rows per trunk call on the shared_exact plan: None (one call) when
        the conv0 feature map (B, 128, frames, 161) fits ``shared_chunk_gb``,
        else the fewest equal row chunks under it, rounded down to a
        multiple of 8 rows when the batch affords it."""
        bytes_per = self.conv_dtype.itemsize if self.conv_dtype is not None else 4
        fm_gb = batch * frames * 161 * 128 * bytes_per / 1e9
        cap = self.shared_chunk_gb
        if fm_gb <= cap or batch <= 1:
            return None
        n_chunks = int(-(-fm_gb // cap))
        per_chunk = max(1, -(-batch // n_chunks))
        aligned = per_chunk // 8 * 8
        return aligned if (batch >= 16 and aligned >= 8) else per_chunk

    @staticmethod
    def _chunked(net, rows: torch.Tensor, chunk: int) -> torch.Tensor:
        """``net`` over row chunks of ``rows`` (a multiple of ``chunk``),
        outputs concatenated."""
        return torch.cat([net(rows[i : i + chunk]) for i in range(0, rows.shape[0], chunk)], dim=0)

    @staticmethod
    def _tile_rows(rows: torch.Tensor, chunk: int) -> torch.Tensor:
        """Pad the rows to a multiple of ``chunk`` by tiling them (any chunk,
        also one above twice the row count)."""
        n = rows.shape[0]
        pad = (-n) % chunk
        if not pad:
            return rows
        reps = -(-pad // n)
        return torch.cat([rows] * (reps + 1), dim=0)[: n + pad]

    # -- host-chunked plans -------------------------------------------------------

    def _host_scores(self, raw: torch.Tensor) -> dict[str, torch.Tensor]:
        """(B, S, 3) raw scores -> calibrated window means, in float64 on the
        host, as float32 tensors on the metric's device."""
        raw = raw.double().cpu().numpy()
        calibrated = POLY_C + POLY_B1 * raw + POLY_B2 * raw**2
        scores = torch.from_numpy(calibrated.mean(axis=1).astype(np.float32)).to(self.device)
        return {"SIG": scores[:, 0], "BAK": scores[:, 1], "OVRL": scores[:, 2]}

    def _run_shared(self, denoised: torch.Tensor, net_fn) -> dict[str, torch.Tensor]:
        """A shared-trunk plan (exact or approximate ``net_fn``), utterance
        chunks of ``host_chunk`` rows in a host loop."""
        audio = self._tile_to_window(denoised)
        num_windows = self._num_windows(audio)
        batch = audio.shape[0]

        def net(rows):
            return net_fn(self.params, rows, num_windows, self.hop // 160, self.conv_dtype)

        raw = self._chunked(net, self._tile_rows(audio, self.host_chunk), self.host_chunk)[:batch]
        return self._host_scores(raw)

    def _run_prepared(self, clean, denoised):
        if self.host_chunk is None:
            return super()._run_prepared(clean, denoised)
        if self.sample_rate != self.EXPECTED_SAMPLING_RATE:
            denoised = resample(denoised, self.sample_rate, self.EXPECTED_SAMPLING_RATE)
        if self.shared_conv:
            return self._run_shared(denoised, dnsmos_net_shared)
        if self.window_plan == "shared_exact":
            return self._run_shared(denoised, dnsmos_net_windowed_exact)
        segments = self._segment(denoised)
        batch, num_segments = segments.shape[:2]
        windows = self._tile_rows(segments.reshape(-1, self.window), self.host_chunk)
        raw = self._chunked(lambda w: dnsmos_net(self.params, w, self.conv_dtype), windows, self.host_chunk)
        return self._host_scores(raw[: batch * num_segments].reshape(batch, num_segments, 3))

    # -- in-graph plans -------------------------------------------------------------

    def _calibrate(self, raw: torch.Tensor, batch: int, num_windows: int) -> dict[str, torch.Tensor]:
        """(B*S, 3) raw float32 scores -> calibrated window means in float32."""
        c, b1, b2 = self._poly
        calibrated = c + b1 * raw + b2 * torch.square(raw)
        scores = calibrated.reshape(batch, num_windows, 3).mean(dim=1)
        return {"SIG": scores[:, 0], "BAK": scores[:, 1], "OVRL": scores[:, 2]}

    def _compute(self, clean, denoised):
        del clean  # non-intrusive
        batch = denoised.shape[0]
        if self.window_plan == "shared_exact":
            audio = self._tile_to_window(denoised)
            num_windows = self._num_windows(audio)

            def net(rows):
                return dnsmos_net_windowed_exact(self.params, rows, num_windows, self.hop // 160, self.conv_dtype)

            chunk = self._shared_chunk_rows(batch, audio.shape[1] // 160 - 1)
            if chunk is not None and batch > chunk:
                pad = (-batch) % chunk
                if pad:
                    audio = torch.cat([audio, audio[:pad]], dim=0)
                raw = self._chunked(net, audio, chunk)[:batch]
            else:
                raw = net(audio)
            return self._calibrate(raw.reshape(-1, 3), batch, num_windows)

        segments = self._segment(denoised)
        num_segments = segments.shape[1]
        windows = segments.reshape(-1, self.window)
        n = windows.shape[0]
        chunk = self.segment_chunk
        if chunk is not None and n > chunk:
            pad = (-n) % chunk
            if pad:
                windows = torch.cat([windows, windows[:pad]], dim=0)
            raw = self._chunked(lambda w: dnsmos_net(self.params, w, self.conv_dtype), windows, chunk)[:n]
        else:
            raw = dnsmos_net(self.params, windows, self.conv_dtype)
        return self._calibrate(raw.float(), batch, num_segments)

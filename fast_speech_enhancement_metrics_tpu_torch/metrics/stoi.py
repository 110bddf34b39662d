"""STOI / ESTOI (Taal short-time objective intelligibility).

Counterpart of the JAX package's ``metrics/stoi.py`` (itself matching
pystoi to abs 5e-4):

* 10 kHz, 256-sample Hann frames, hop 128,
* silent-frame removal: drop frames >40 dB below the loudest clean frame,
  overlap-add the survivors back into a signal,
* 512-point STFT (window center-padded), 15 one-third-octave bands from
  150 Hz, sqrt of band energies,
* sliding 30-frame segments; STOI normalizes per (band, segment) with a
  clip at -15 dB SDR; ESTOI additionally normalizes across bands,
* score = mean segment correlation.

Every shape is fixed by the input length: silent-frame removal is a
stable-argsort compaction (kept frames first, tail zeroed) and each
utterance's kept length rides along as a ``lengths`` vector and masks.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch
import torch.nn.functional as F

from fast_speech_enhancement_metrics_tpu_torch.base import BaseMetric
from fast_speech_enhancement_metrics_tpu_torch.ops.dft import framed_rdft_center_half
from fast_speech_enhancement_metrics_tpu_torch.ops.stft import hann_window
from fast_speech_enhancement_metrics_tpu_torch.ops.stoi_fused import stoi_segment_sums

_NO_SEGMENTS = "Not enough non-silent frames. Please check your sound files"


def third_octave_band_matrix(
    num_bands: int = 15,
    min_frequency: float = 150.0,
    n_fft: int = 512,
    sample_rate: int = 10000,
) -> np.ndarray:
    """0/1 matrix mapping rFFT bins to 1/3-octave bands (float64-derived)."""
    num_frequencies = n_fft // 2 + 1
    freqs = np.linspace(0, sample_rate // 2, num_frequencies, dtype=np.float64)
    k = np.arange(num_bands, dtype=np.float64)
    f_low = min_frequency * 2.0 ** ((2 * k - 1) / 6)
    f_high = min_frequency * 2.0 ** ((2 * k + 1) / 6)
    obm = np.zeros((num_bands, num_frequencies), dtype=np.float64)
    for i in range(num_bands):
        lo = int(np.argmin(np.abs(freqs - f_low[i])))
        hi = int(np.argmin(np.abs(freqs - f_high[i])))
        obm[i, lo:hi] = 1.0
    return obm.astype(np.float32)


class STOI(BaseMetric):
    higher_is_better = True
    EXPECTED_SAMPLING_RATE = 10000

    def __init__(self, sample_rate: int = 10000, segment_impl: str = "auto", **kw):
        """``segment_impl``: "fused" (kernel A6, ``ops/stoi_fused.py``: the
        (B, n_seg, 15, 30) segment tensor is never built; its plain version
        on the CPU), "xla" (materialized segments + masked reductions), or
        "auto" (fused on a CUDA device, xla otherwise)."""
        super().__init__(sample_rate, **kw)
        assert segment_impl in ("auto", "fused", "xla")
        self.segment_impl = segment_impl
        self.win_length = 256
        self.hop = self.win_length // 2
        self.n_fft = 512
        self.num_octave_bands = 15
        self.N = 30  # frames per intermediate-intelligibility segment
        self.beta = -15.0  # lower SDR clip bound (dB)
        self.dynamic_range = 40.0
        self.obm = third_octave_band_matrix(
            self.num_octave_bands, 150.0, self.n_fft, self.EXPECTED_SAMPLING_RATE
        )
        # asymmetric Hann used by pystoi
        self.window = hann_window(self.win_length + 1)[1:]
        # STFT window: the 256-tap window center-padded to 512 (torch.stft rule)
        self.stft_window = np.pad(self.window, (128, 128))
        # bins past the top 1/3-octave band (~4.3 kHz, bin 219) never reach a
        # band sum: trim them out of the DFT matmul
        top_bin = int(np.flatnonzero(self.obm.any(axis=0))[-1]) + 1
        self.dft_bins = -(-top_bin // 32) * 32
        self._wa = torch.from_numpy(self.window[: self.hop].copy()).to(self.device)
        self._wb = torch.from_numpy(self.window[self.hop :].copy()).to(self.device)
        self._obm_t = torch.from_numpy(
            np.ascontiguousarray(self.obm[:, : self.dft_bins].T)
        ).to(self.device)

    # -- silent-frame removal (fixed shapes) -----------------------------------

    def _remove_silent_frames(self, clean, denoised):
        """Chunk-space formulation: frame f = [chunk_f | chunk_{f+1}] of the
        hop-sized chunk grid, so frame energies decompose into per-chunk
        partial sums and the overlap-add output gathers raw chunks (window
        halves applied after the gather)."""
        hop, wl = self.hop, self.win_length
        batch, t = clean.shape
        n_frames = 1 + (t - wl) // hop
        n_chunks = n_frames + 1
        wa, wb = self._wa, self._wb

        def chunks_of(x):
            pad = n_chunks * hop - t
            if pad > 0:
                x = F.pad(x, (0, pad))
            return x[:, : n_chunks * hop].reshape(batch, n_chunks, hop)

        xc, xd = chunks_of(clean), chunks_of(denoised)

        # frame energy^2 = ||chunk_f * w_a||^2 + ||chunk_{f+1} * w_b||^2
        e_a = torch.sum((xc * wa) ** 2, dim=2)  # (B, C)
        e_b = torch.sum((xc * wb) ** 2, dim=2)
        energies = 20.0 * torch.log10(torch.sqrt(e_a[:, :-1] + e_b[:, 1:]) + 1e-9)
        keep = (
            torch.amax(energies, dim=1, keepdim=True) - self.dynamic_range - energies
        ) < 0  # (B, F)
        num_kept = torch.sum(keep, dim=1)  # (B,)

        # stable compaction: kept frames to the front, original order preserved
        order = torch.argsort((~keep).to(torch.int32), dim=1, stable=True)
        slot_valid = (
            torch.arange(n_frames, device=clean.device)[None, :] < num_kept[:, None]
        )[:, :, None]

        # 50%-overlap OLA over kept frames: out chunk j sums the w_b half of
        # kept frame j-1 (raw chunk order[j-1]+1) and the w_a half of kept
        # frame j (raw chunk order[j])
        idx = order[:, :, None].expand(batch, n_frames, hop)

        def ola(xx):
            a = torch.gather(xx, 1, idx) * wa * slot_valid
            b = torch.gather(xx, 1, idx + 1) * wb * slot_valid
            out = F.pad(a, (0, 0, 0, 1)) + F.pad(b, (0, 0, 1, 0))
            return out.reshape(batch, -1)

        lengths = (num_kept + 1) * hop
        return ola(xc), ola(xd), lengths

    # -- spectral front-end ---------------------------------------------------

    def _band_envelopes(self, speech, lengths):
        """(2B, T') -> sqrt third-octave band energies (2B, F_spec, 15), masked."""
        re, im = framed_rdft_center_half(
            speech, self.n_fft, self.hop, window=self.stft_window, n_bins=self.dft_bins
        )
        power = re * re + im * im  # (2B, F_spec, dft_bins)
        spec_lengths = 1 + torch.div(lengths - self.n_fft, self.hop, rounding_mode="floor")
        t_idx = torch.arange(power.shape[1], device=power.device)
        valid = t_idx[None, :] < spec_lengths[:, None]
        power = power * valid[:, :, None]
        return torch.sqrt(power @ self._obm_t)  # (2B, F_spec, 15)

    # -- segment machinery ----------------------------------------------------

    @staticmethod
    def _segments(tob, n_seg, n_frames):
        """(B, F, 15) -> (B, n_seg, 15, N) sliding windows over the frame axis."""
        return torch.stack([tob[:, m : m + n_seg, :] for m in range(n_frames)], dim=-1)

    @staticmethod
    def _normalize(x, dim):
        x = x - torch.mean(x, dim=dim, keepdim=True)
        norm = torch.linalg.vector_norm(x, dim=dim, keepdim=True)
        return x / torch.clamp(norm, min=1e-30)

    def _equalize_clip(self, clean_seg, denoised_seg):
        consts = torch.linalg.vector_norm(clean_seg, dim=3, keepdim=True) / (
            torch.linalg.vector_norm(denoised_seg, dim=3, keepdim=True) + 1e-9
        )
        normalized = denoised_seg * consts
        clip_value = 10.0 ** (-self.beta / 20.0)
        return torch.minimum(normalized, clean_seg * (1.0 + clip_value))

    # -- main -----------------------------------------------------------------

    def compute(self, clean_speech, denoised_speech):
        scores = super().compute(clean_speech, denoised_speech)
        num_segments = scores.pop("_num_segments", None)
        if num_segments is not None and bool((num_segments == 0).any()):
            warnings.warn(_NO_SEGMENTS, RuntimeWarning, stacklevel=2)
        return scores

    def _envelopes(self, clean, denoised):
        """(B, T) pairs at 10 kHz -> clean and denoised band envelopes, each
        (B, F_spec, 15) and contiguous, and the (B,) valid segment counts."""
        batch = clean.shape[0]
        c_sig, d_sig, lengths = self._remove_silent_frames(clean, denoised)
        speech = torch.cat([c_sig, d_sig], dim=0)
        tob = self._band_envelopes(speech, torch.cat([lengths, lengths]))
        num_segments = torch.clamp(
            torch.div(lengths - self.n_fft, self.hop, rounding_mode="floor") - self.N + 2,
            min=0,
        )
        return tob[:batch].contiguous(), tob[batch:].contiguous(), num_segments

    def _use_fused(self) -> bool:
        if self.segment_impl == "auto":
            return self._on_cuda()
        return self.segment_impl == "fused"

    def _compute(self, clean, denoised):
        assert clean is not None
        batch = clean.shape[0]
        n_frames_sig = 1 + (clean.shape[1] - self.win_length) // self.hop
        # reconstructed signal has (F+1)*hop samples -> F-2 STFT frames
        n_spec = 1 + ((n_frames_sig + 1) * self.hop - self.n_fft) // self.hop
        n_seg = n_spec - self.N + 1
        if n_seg <= 0:
            warnings.warn(_NO_SEGMENTS, RuntimeWarning, stacklevel=2)
            zero = clean.new_zeros(batch)
            return {"STOI": zero, "ESTOI": zero}

        tob_c, tob_d, num_segments = self._envelopes(clean, denoised)

        if self._use_fused():
            stoi_sum, estoi_sum = stoi_segment_sums(
                tob_c, tob_d, num_segments, n=self.N, num_bands=self.num_octave_bands
            )
            stoi = stoi_sum / self.num_octave_bands
            estoi = estoi_sum / self.N
        else:
            clean_seg = self._segments(tob_c, n_seg, self.N)  # (B, n_seg, 15, N)
            denoised_seg = self._segments(tob_d, n_seg, self.N)

            equalized = self._equalize_clip(clean_seg, denoised_seg)
            clean_stoi = self._normalize(clean_seg, dim=3)
            equalized = self._normalize(equalized, dim=3)
            clean_estoi = self._normalize(self._normalize(clean_seg, dim=3), dim=2)
            denoised_estoi = self._normalize(self._normalize(denoised_seg, dim=3), dim=2)

            seg_mask = (
                torch.arange(n_seg, device=clean.device)[None, :] < num_segments[:, None]
            ).to(clean.dtype)[:, :, None, None]
            stoi = torch.sum(clean_stoi * equalized * seg_mask, dim=(1, 2, 3)) / self.num_octave_bands
            estoi = torch.sum(clean_estoi * denoised_estoi * seg_mask, dim=(1, 2, 3)) / self.N

        # an utterance whose surviving frames yield zero segments scores 0.0
        # (warned host-side in ``compute`` from _num_segments)
        safe = torch.clamp(num_segments, min=1).to(stoi.dtype)
        has_seg = num_segments > 0
        return {
            "STOI": torch.where(has_seg, stoi / safe, 0.0),
            "ESTOI": torch.where(has_seg, estoi / safe, 0.0),
            "_num_segments": num_segments,
        }

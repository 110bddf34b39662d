"""PESQ (ITU-T P.862 wideband MOS-LQO).

Counterpart of the JAX package's ``metrics/pesq.py`` (which follows the ITU
P.862 reference implementation minus time alignment, with an IIR level
alignment): joint range equalization, 325-3250 Hz band level alignment to
1e7 power, tapered pre-emphasis, 512/256 Hann power spectrogram, 49-band
Bark pooling with power-density correction, silent-frame band/frame power
equalization, Zwicker loudness, deadzoned disturbance, width-weighted
symmetric (L2) and asymmetric (L1) norms, 20/10 overlapping L6-RMS
aggregation, and the P.862 logistic MOS mapping.

Both IIR filters run as truncated-impulse FIR matmuls (``ops/iir.py``), the
spectrogram as framed-DFT matmuls (``ops/dft.py``) and the Bark pooling as
one (2B F, 256) x (256, 49) matmul, all float32 with TF32 off; the
clean/denoised pair rides one doubled batch (2B) through filter, STFT, Bark
pooling and loudness. There is no hand kernel on this path.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from scipy.signal import butter

from fast_speech_enhancement_metrics_tpu_torch.base import BaseMetric
from fast_speech_enhancement_metrics_tpu_torch.ops.bark import bark_constants
from fast_speech_enhancement_metrics_tpu_torch.ops.dft import correlation_lags, framed_spectrogram
from fast_speech_enhancement_metrics_tpu_torch.ops.iir import lfilter_fir
from fast_speech_enhancement_metrics_tpu_torch.ops.stft import device_table
from fast_speech_enhancement_metrics_tpu_torch.ops.stft import frame as frame_op

#: pre-emphasis biquad of the ITU reference
PRE_EMPHASIS_B = (2.740826, -5.4816519, 2.740826)
PRE_EMPHASIS_A = (1.0, -1.9444777, 0.94597794)
PRECISIONS = ("high", "highest")
#: 15-sample raised ramps applied to the signal edges before pre-emphasis
#: (P.862 taper)
TAPER = np.arange(1, 16, dtype=np.float32) / 16.0


@functools.lru_cache(maxsize=None)
def _fbank_t(nbarks: int, nfreqs: int) -> np.ndarray:
    """(nfreqs, nbarks) Bark pooling matrix, transposed for ``power @ fbank``."""
    return np.ascontiguousarray(bark_constants(nbarks, nfreqs)["fbank"].T)


class PESQ(BaseMetric):
    higher_is_better = True
    EXPECTED_SAMPLING_RATE = 16000

    def __init__(
        self,
        sample_rate: int = 16000,
        precision: str = "high",
        time_align: bool = False,
        max_delay_s: float = 0.1,
        **kw,
    ):
        """``precision``: the JAX package's MXU pass count for the filters,
        the DFT and the Bark pooling ("high" bf16x3, "highest" bf16x6); here
        both run float32 matmuls with TF32 off.

        ``time_align=True`` first estimates one delay per utterance (the
        cross-correlation argmax over +-``max_delay_s``) and shifts the
        denoised signal by it, the vacated samples zero: the constant-delay
        case (a resampler, codec or DAW offset), not P.862's per-interval
        alignment."""
        super().__init__(sample_rate, **kw)
        if precision not in PRECISIONS:
            raise ValueError(f"unknown precision: {precision!r} (use one of {PRECISIONS})")
        self.nbarks = 49
        self.n_fft = 512
        self.hop = 256
        self.precision = precision
        self.time_align = time_align
        self.max_delay = int(max_delay_s * self.EXPECTED_SAMPLING_RATE)

        # 325-3250 Hz band-power filter for level alignment (P.862 quirk
        # constants included: +5120 sample count, /1.04684 correction)
        b, a = butter(5, [325, 3250], fs=self.EXPECTED_SAMPLING_RATE, btype="band")
        self.power_filter = (tuple(np.float32(b)), tuple(np.float32(a)))

        self.consts = bark_constants(self.nbarks, self.n_fft // 2)

    def _const(self, name: str) -> torch.Tensor:
        return device_table(self.consts[name], self.device)

    # -- time-domain conditioning --------------------------------------------

    @staticmethod
    def _equalize_ranges(clean, noisy):
        max_value = torch.maximum(
            torch.amax(torch.abs(clean), dim=1, keepdim=True),
            torch.amax(torch.abs(noisy), dim=1, keepdim=True),
        )
        return clean / max_value, noisy / max_value

    def _align_level(self, speech):
        """Scale so the 325-3250 Hz band power is 1e7 (P.862 level alignment)."""
        filtered = lfilter_fir(speech, self.power_filter[0], self.power_filter[1])
        power = torch.sum(torch.square(filtered), dim=1, keepdim=True)
        power = power / (speech.shape[1] + 5120) / 1.04684
        return speech * torch.sqrt(1e7 / power)

    def _pre_emphasize(self, speech):
        taper = device_table(TAPER, speech.device)
        edge = torch.ones(speech.shape[1], dtype=speech.dtype, device=speech.device)
        edge[:15] = taper
        edge[-15:] = torch.flip(taper, dims=(0,))
        return lfilter_fir(speech * edge, PRE_EMPHASIS_B, PRE_EMPHASIS_A)

    # -- spectral path --------------------------------------------------------

    def _bark_bands(self, speech):
        """(2B, T) -> (2B, F, 49) Bark-pooled power densities."""
        speech = self._align_level(speech)
        speech = self._pre_emphasize(speech)

        # P.862 alignment quirk: pad *by* (not to a multiple of) T % 256
        pad_amount = speech.shape[1] % self.hop
        if pad_amount > 0:
            speech = F.pad(speech, (0, pad_amount))

        power = framed_spectrogram(speech, self.n_fft, self.hop, center=False, power=2.0)
        # drop the energy (DC) feature and the last bin; pool bins 1..255
        # onto Bark bands
        power = F.pad(power[:, :, 1:-1], (1, 0))
        bark = power @ device_table(_fbank_t(self.nbarks, self.n_fft // 2), self.device)
        return bark * self._const("pow_dens")

    # -- perceptual model -----------------------------------------------------

    def _audible_frame_power(self, bark, threshold_factor):
        audible = bark > self._const("thresholds") * threshold_factor
        return torch.sum(bark * audible, dim=2, keepdim=True)  # (B, F, 1)

    def _mean_audible_band_power(self, bark, frame_is_silent):
        mask = (bark > self._const("thresholds") * 100.0) & (~frame_is_silent)
        return torch.mean(bark * mask, dim=1)  # (B, 49)

    def _equalize_bark_bands(self, clean_bark, noisy_bark):
        frame_is_silent = self._audible_frame_power(clean_bark, 1e2) < 1e7

        mean_clean = self._mean_audible_band_power(clean_bark, frame_is_silent)
        mean_noisy = self._mean_audible_band_power(noisy_bark, frame_is_silent)

        band_ratio = (mean_noisy + 1000.0) / (mean_clean + 1000.0)
        band_ratio = torch.clamp(band_ratio, 0.01, 100.0)
        eq_clean = band_ratio[:, None, :] * clean_bark

        frame_ratio = (self._audible_frame_power(eq_clean, 1.0) + 5e3) / (
            self._audible_frame_power(noisy_bark, 1.0) + 5e3
        )
        # one-step exponential smoothing along frames (P.862), on the
        # unclipped previous ratio
        frame_ratio = torch.cat(
            [frame_ratio[:, :1], 0.8 * frame_ratio[:, 1:] + 0.2 * frame_ratio[:, :-1]], dim=1
        )
        frame_ratio = torch.clamp(frame_ratio, 3e-4, 5.0)
        return eq_clean, frame_ratio * noisy_bark

    def _loudness(self, bark):
        """Zwicker loudness law."""
        thresholds = self._const("thresholds")
        exp = self._const("zwicker_exp")
        loud = (2.0 * thresholds) ** exp * ((0.5 + 0.5 * bark / thresholds) ** exp - 1.0)
        loud = torch.where(bark <= thresholds, 0.0, loud)
        return loud * 1.866055e-01  # Sl_16k

    def _weighted_norm(self, x, p):
        """Band-width-weighted p-norm over Bark bands 1.. (P.862)."""
        total = self.consts["total_width"]
        scaled = (self._const("width_bark") * x / total ** (1.0 / p))[:, :, 1:]
        return total * torch.sum(torch.abs(scaled) ** p, dim=2) ** (1.0 / p)

    @staticmethod
    def _overlapping_sums(disturbance):
        """20-frame windows, hop 10: L6 mean per window, then RMS over windows."""
        frames = frame_op(disturbance, 20, 10)
        psqm = torch.mean(frames**6, dim=2) ** (1.0 / 6.0)
        return torch.sqrt(torch.mean(torch.square(psqm), dim=1))

    # -- time alignment (opt-in; see __init__) --------------------------------

    def _align_delay(self, clean, denoised):
        """Shift ``denoised`` by the per-utterance cross-correlation argmax
        over lags in [-max_delay, +max_delay]; vacated samples are zero."""
        n_lags = self.max_delay + 1
        # r_pos[l] = sum_t c[t-l] d[t]: peak at l = delay of d AFTER c;
        # r_neg[l] the mirror (d ahead of c)
        (r_pos,) = correlation_lags(clean, (denoised,), n_lags)
        (r_neg,) = correlation_lags(denoised, (clean,), n_lags)
        abs_pos, abs_neg = torch.abs(r_pos), torch.abs(r_neg)
        # argmax gives the first maximum on a tie, as jnp.argmax does
        i_pos = torch.argmax(abs_pos, dim=-1, keepdim=True)
        i_neg = torch.argmax(abs_neg, dim=-1, keepdim=True)
        take_pos = torch.gather(abs_pos, 1, i_pos) >= torch.gather(abs_neg, 1, i_neg)
        delay = torch.where(take_pos, i_pos, -i_neg)  # (B, 1) samples, d vs c

        t = denoised.shape[-1]
        m = self.max_delay
        # remove the delay: row r reads padded[r, m + delay_r + j]
        padded = F.pad(denoised, (m, m))
        idx = m + delay + torch.arange(t, device=denoised.device)[None, :]
        return torch.gather(padded, 1, idx)

    # -- main -----------------------------------------------------------------

    def _compute(self, clean, denoised):
        assert clean is not None
        batch = clean.shape[0]

        if self.time_align:
            denoised = self._align_delay(clean, denoised)

        clean, noisy = self._equalize_ranges(clean, denoised)
        bark = self._bark_bands(torch.cat([clean, noisy], dim=0))
        eq_clean, eq_noisy = self._equalize_bark_bands(bark[:batch], bark[batch:])

        loudness = self._loudness(torch.cat([eq_clean, eq_noisy], dim=0))
        clean_loud, noisy_loud = loudness[:batch], loudness[batch:]

        deadzone = 0.25 * torch.minimum(clean_loud, noisy_loud)
        raw = noisy_loud - clean_loud
        disturbance = torch.sign(raw) * torch.clamp(torch.abs(raw) - deadzone, min=0.0)

        symmetric = torch.clamp(self._weighted_norm(disturbance, 2.0), min=1e-20)

        asym_scaling = ((eq_noisy + 50.0) / (eq_clean + 50.0)) ** 1.2
        asym_scaling = torch.where(asym_scaling < 3.0, 0.0, asym_scaling)
        asym_scaling = torch.clamp(asym_scaling, max=12.0)
        asymmetric = torch.clamp(self._weighted_norm(disturbance * asym_scaling, 1.0), min=1e-20)

        weight = ((self._audible_frame_power(eq_clean, 1.0)[..., 0] + 1e5) / 1e7) ** 0.04
        symmetric = torch.clamp(symmetric / weight, max=45.0)
        asymmetric = torch.clamp(asymmetric / weight, max=45.0)

        sym_dist = self._overlapping_sums(symmetric)
        asym_dist = self._overlapping_sums(asymmetric)

        mos = 4.5 - 0.1 * sym_dist - 0.0309 * asym_dist
        mos = 0.999 + 4.0 / (1.0 + torch.exp(-1.3669 * mos + 3.8224))
        return {"PESQ": mos}

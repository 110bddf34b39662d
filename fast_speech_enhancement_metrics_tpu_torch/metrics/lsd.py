"""Log-Spectral Distance (urgent2025 recipe).

Counterpart of the JAX package's ``metrics/lsd.py``:

* project the denoised signal onto the clean signal (least-squares scale),
* centered STFT, n_fft = 0.032*sr, hop = 0.016*sr, Hann window, constant pad,
* LSD = mean_t sqrt(mean_f [log(|C|^2 / (|D|+eps)^2 + eps)]^2).
"""

from __future__ import annotations

import torch

from fast_speech_enhancement_metrics_tpu_torch.base import BaseMetric
from fast_speech_enhancement_metrics_tpu_torch.ops.dft import framed_spectrogram
from fast_speech_enhancement_metrics_tpu_torch.ops.lsd_fused import lsd_scores


class LSD(BaseMetric):
    higher_is_better = False
    EXPECTED_SAMPLING_RATE = 16000

    def __init__(self, sample_rate: int = 16000, spectral_impl: str = "auto", **kw):
        """``spectral_impl``: "fused" (kernels A1-A3, ``ops/lsd_fused.py``:
        the spectrogram never reaches device memory; their plain versions
        on the CPU), "xla" (framed-DFT matmuls + elementwise epilogue), or
        "auto" (fused on a CUDA device, xla otherwise). The fused path
        scores every clip length: hop-aligned clips take A1, the others A2,
        or A3 past 1023 frames."""
        super().__init__(sample_rate, **kw)
        self.nfft = int(self.EXPECTED_SAMPLING_RATE * 0.032)
        self.hop = int(self.EXPECTED_SAMPLING_RATE * 0.016)
        self.p = 2
        self.eps = 1e-8
        assert spectral_impl in ("auto", "fused", "xla")
        self.spectral_impl = spectral_impl

    def _use_fused(self) -> bool:
        if self.spectral_impl == "auto":
            return self._on_cuda()
        return self.spectral_impl == "fused"

    def _compute(self, clean, denoised):
        assert clean is not None
        batch = clean.shape[0]

        if self._use_fused():
            return {
                "LSD": lsd_scores(
                    clean, denoised, self.nfft, self.hop, self.eps,
                    denoised_scale="auto",
                )
            }
        scale = torch.sum(clean * denoised, dim=1, keepdim=True) / (
            torch.sum(denoised * denoised, dim=1, keepdim=True) + self.eps
        )
        denoised = denoised * scale

        speech = torch.cat([clean, denoised], dim=0)
        # magnitude spectrogram, frames-major: (2B, F_frames, nfft//2+1)
        mag = framed_spectrogram(speech, self.nfft, self.hop, center=True, power=1.0)
        c, d = mag[:batch], mag[batch:]

        log_ratio = torch.log(c * c / torch.square(d + self.eps) + self.eps)
        lsd = torch.mean(torch.sqrt(torch.mean(log_ratio**self.p, dim=2)), dim=1)
        return {"LSD": lsd}

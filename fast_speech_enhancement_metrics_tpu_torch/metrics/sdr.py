"""SDR (signal-to-distortion ratio) via Toeplitz least squares.

Counterpart of the JAX package's ``metrics/sdr.py`` (the Scheibler fast-SDR
formulation):

* L2-normalize both signals (clamped at 1e-6),
* auto/cross-correlation at 512 lags,
* solve the 512-tap symmetric Toeplitz normal equations,
* SDR = 10*log10(coh / (1 - coh)) with 1e-8 floors.
"""

from __future__ import annotations

import torch

from fast_speech_enhancement_metrics_tpu_torch.base import BaseMetric
from fast_speech_enhancement_metrics_tpu_torch.ops.dft import correlation_lags
from fast_speech_enhancement_metrics_tpu_torch.ops.levinson_pallas import levinson_solve_fused
from fast_speech_enhancement_metrics_tpu_torch.ops.sdr_corr_fused import correlation_lags_fused
from fast_speech_enhancement_metrics_tpu_torch.ops.sdr_corr_gram import correlation_lags_gram
from fast_speech_enhancement_metrics_tpu_torch.ops.toeplitz import (
    levinson_solve,
    symmetric_toeplitz_solve,
)


class SDR(BaseMetric):
    higher_is_better = True
    EXPECTED_SAMPLING_RATE = 16000

    def __init__(
        self,
        sample_rate: int = 16000,
        solver: str = "levinson",
        precision: str | None = "high",
        corr_impl: str = "auto",
        **kw,
    ):
        """``precision``: the JAX package's class for its "xla" correlation
        matmuls ("high" bf16x3, the default, or "highest" float32). The
        port's "xla" path computes them in float32 with TF32 off, at least
        as tight as either class, so here it only gates "auto", as in the
        JAX package: gram_x4 is taken at "high" only.

        ``zero_mean`` (False) and ``load_diag`` (None), attributes as in the
        JAX package: set them to remove each signal's mean before the
        correlations, and to add ``load_diag`` to the autocorrelation at lag
        0 (diagonal loading of the Toeplitz system).

        ``corr_impl``: "gram_x4" (kernel A4, ``ops/sdr_corr_gram.py``:
        correlate the raw signals, then normalize; on a CUDA card shifted
        Gram matrices on the bf16 tensor cores with the signals' bf16
        halves K-stacked, hh + hl + lh + ll, the JAX kernel's four-term
        class; on the CPU the float32 plain correlation), "gram" and
        "gram_x1" (the same with the JAX kernel's reduced product classes,
        split x3 and x1: hh + hl + lh, or hh alone, one and three bf16
        products fewer per term; never chosen by "auto", which keeps the
        four-term class), "xla" (normalize, then overlap-save DFT
        matmuls), or "auto" (gram_x4 on a CUDA device at precision "high",
        xla otherwise), or
        "fused" (kernel A10, ``ops/sdr_corr_fused.py``: normalize, then
        the chunk spectra as a bf16x3 tensor-core product and their
        products reduced on chip).

        ``solver``: "levinson" (kernel A5 on a CUDA device, its plain
        version elsewhere), "levinson_xla" (the plain recursion everywhere),
        or "cholesky" (Cholesky + triangular solves, LU for rows whose
        Cholesky fails)."""
        super().__init__(sample_rate, **kw)
        self.filter_length = 512
        self.zero_mean = False
        self.load_diag = None
        self.precision = precision
        assert corr_impl in ("auto", "gram", "gram_x1", "gram_x4", "fused", "xla")
        self.corr_impl = corr_impl
        assert solver in ("levinson", "levinson_xla", "cholesky")
        self.solver = solver

    def _centred(self, speech):
        if self.zero_mean:
            return speech - torch.mean(speech, dim=-1, keepdim=True)
        return speech

    def _preprocess(self, speech):
        speech = self._centred(speech)
        norm = torch.clamp(torch.linalg.vector_norm(speech, dim=-1, keepdim=True), min=1e-6)
        return speech / norm

    def _compute(self, clean, denoised):
        assert clean is not None
        corr_len = self.filter_length

        impl = self.corr_impl
        if impl == "auto":
            impl = "gram_x4" if self._on_cuda() and self.precision == "high" else "xla"
        if impl.startswith("gram"):
            # correlate the RAW signals and normalize the correlations
            # afterwards: the same formula as normalize-first for any signal
            # with ||x|| >= 1e-6 (correlations are bilinear, the coherence
            # ratio is scale-invariant), without normalized copies
            split = {"gram": "x3", "gram_x1": "x1", "gram_x4": "x4"}[impl]
            c, d = self._centred(clean), self._centred(denoised)
            r0, b = correlation_lags_gram(c, d, corr_len, split)
            nc2 = torch.clamp(r0[..., 0:1], min=1e-12)  # = clip(||c||, 1e-6)^2
            nd2 = torch.clamp(torch.sum(d * d, dim=-1, keepdim=True), min=1e-12)
            r0 = r0 / nc2
            b = b / torch.sqrt(nc2 * nd2)
        else:
            c = self._preprocess(clean)
            d = self._preprocess(denoised)
            if impl == "fused":
                r0, b = correlation_lags_fused(c, d, corr_len)
            else:
                r0, b = correlation_lags(c, (c, d), corr_len)

        if self.load_diag is not None:
            r0 = r0.clone()
            r0[..., 0] += self.load_diag

        if self.solver == "levinson":
            sol = levinson_solve_fused(r0.contiguous(), b.contiguous())
        elif self.solver == "levinson_xla":
            sol = levinson_solve(r0, b)
        else:
            sol = symmetric_toeplitz_solve(r0, b)
        coh = torch.sum(b * sol, dim=-1)

        ratio = coh / torch.clamp(1.0 - coh, min=1e-8)
        sdr = 10.0 * torch.log10(torch.clamp(ratio, min=1e-8))
        return {"SDR": sdr}

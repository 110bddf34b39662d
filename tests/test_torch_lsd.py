"""PyTorch port, LSD: kernel A1's plain version and the metric against JAX.

The JAX side runs on the CPU: its Pallas kernel in interpret mode, its
metric through the XLA path that ``"auto"`` picks there. Tolerance: the
LSD contract, rtol/atol 2e-4.
"""

import numpy as np
import pytest
import torch

from fast_speech_enhancement_metrics_tpu import LSD as JaxLSD
from fast_speech_enhancement_metrics_tpu.ops.lsd_fused import lsd_scores as jax_lsd_scores
from fast_speech_enhancement_metrics_tpu_torch import LSD
from fast_speech_enhancement_metrics_tpu_torch.ops import lsd_fused
from fast_speech_enhancement_metrics_tpu_torch.utils.audio import load_audio_data


def _pairs(seconds, rows=3, seed=42):
    clean, noisy, _ = load_audio_data(seconds, rows, 16000, seed=seed)
    return clean, noisy


@pytest.mark.parametrize("t", [16384, 32768])
def test_lsd_kernel_plain_matches_pallas_kernel(t):
    """Hop-aligned clips with an 8-aligned chunk count take the JAX
    package's raw whole-signal kernel (A1) there."""
    clean, noisy = _pairs(t / 16000)
    ours = lsd_fused.lsd_scores(torch.from_numpy(clean), torch.from_numpy(noisy), 512, 256, 1e-8)
    theirs = jax_lsd_scores(clean, noisy, 512, 256, 1e-8, interpret=True, denoised_scale="auto")
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("impl", ["auto", "xla", "fused"])
def test_lsd_metric_matches_jax(speech_data, impl):
    clean, noisy = speech_data["speech"], speech_data["noisy_speech"]
    ours = [r["LSD"] for r in LSD(device="cpu", spectral_impl=impl)(clean, noisy)]
    theirs = [r["LSD"] for r in JaxLSD()(clean, noisy)]
    np.testing.assert_allclose(ours, theirs, rtol=2e-4, atol=2e-4)


def test_lsd_identical_inputs_beat_noisy(speech_data):
    clean, noisy = speech_data["speech"], speech_data["noisy_speech"]
    metric = LSD(device="cpu")
    same = metric(clean, clean)
    theirs = JaxLSD()(clean, clean)
    np.testing.assert_allclose([r["LSD"] for r in same], [r["LSD"] for r in theirs], rtol=2e-4, atol=2e-4)
    assert all(s["LSD"] < n["LSD"] for s, n in zip(same, metric(clean, noisy)))


def test_lsd_48k_input_resamples():
    clean, noisy = _pairs(1.0, rows=2)
    c48, d48 = np.repeat(clean, 3, axis=1), np.repeat(noisy, 3, axis=1)
    ours = [r["LSD"] for r in LSD(sample_rate=48000, device="cpu")(c48, d48)]
    theirs = [r["LSD"] for r in JaxLSD(sample_rate=48000)(c48, d48)]
    np.testing.assert_allclose(ours, theirs, rtol=2e-4, atol=2e-4)


def test_lsd_auto_takes_plain_path_for_unaligned_clips():
    """A clip that is not hop-aligned needs kernel A2: ``lsd_scores`` says
    so. On the CPU ``"auto"`` scores it on the framed-DFT path; on a CUDA
    device ``"auto"`` means the kernel whatever the length, so such a clip
    raises there instead of leaving the kernel path."""
    clean, noisy = _pairs(1.0, rows=2)  # 16000 % 256 != 0
    ct, nt = torch.from_numpy(clean), torch.from_numpy(noisy)
    with pytest.raises(NotImplementedError, match="A2"):
        lsd_fused.lsd_scores(ct, nt, 512, 256, 1e-8)
    with pytest.raises(NotImplementedError, match="A2"):
        lsd_fused.lsd_scores(torch.zeros(1, 512), torch.zeros(1, 512), 512, 256, 1e-8, denoised_scale=None)
    assert not LSD(device="cpu")._use_fused()
    ours = [r["LSD"] for r in LSD(device="cpu")(clean, noisy)]
    theirs = [r["LSD"] for r in JaxLSD()(clean, noisy)]
    np.testing.assert_allclose(ours, theirs, rtol=2e-4, atol=2e-4)

    on_card = LSD(device="cpu")
    on_card._on_cuda = lambda: True
    assert on_card._use_fused()
    with pytest.raises(NotImplementedError, match="A2"):
        on_card._compute(ct, nt)


def test_lsd_kernel_wrapper_rejects_other_devices():
    x = torch.zeros(1, 512, device="meta")
    with pytest.raises(ValueError, match="device"):
        lsd_fused.lsd_wholesig_raw(x, x, 256, 1e-8)

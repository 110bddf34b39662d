"""PyTorch port, base runtime: input handling, ragged batches, device policy,
and the port's independence from JAX."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import fast_speech_enhancement_metrics_tpu as jax_pkg
from fast_speech_enhancement_metrics_tpu import LSD as JaxLSD
from fast_speech_enhancement_metrics_tpu_torch import LSD, SDR, STOI, SpeechBERTScore
from fast_speech_enhancement_metrics_tpu_torch.base import _is_ragged
from fast_speech_enhancement_metrics_tpu_torch.models.hubert import HubertConfig, init_params
from fast_speech_enhancement_metrics_tpu_torch.ops.resample import resample
from fast_speech_enhancement_metrics_tpu_torch.utils import audio as pt_audio
from fast_speech_enhancement_metrics_tpu.utils import audio as jax_audio

REPO = Path(__file__).resolve().parents[1]


def test_synthetic_audio_matches_jax_generator():
    ours = pt_audio.load_audio_data(0.5, 3, 16000, seed=7)
    theirs = jax_audio.load_audio_data(0.5, 3, 16000, seed=7)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="synthetic"):
        pt_audio.load_audio_data(source="hf")


def test_numpy_torch_and_list_inputs_agree(speech_data):
    clean, noisy = speech_data["speech"][:2], speech_data["noisy_speech"][:2]
    metric = LSD(device="cpu")
    from_numpy = metric(clean, noisy)
    from_torch = metric(torch.from_numpy(clean), torch.from_numpy(noisy))
    from_list = metric(clean.tolist(), noisy.tolist())
    from_f64 = metric(clean.astype(np.float64), noisy.astype(np.float64))
    for other in (from_torch, from_list, from_f64):
        for a, b in zip(from_numpy, other):
            assert a["LSD"] == pytest.approx(b["LSD"], rel=1e-6)


def test_1d_input_returns_single_result(speech_data):
    results = LSD(device="cpu")(speech_data["speech"][0], speech_data["noisy_speech"][0])
    assert len(results) == 1 and isinstance(results[0]["LSD"], float)
    theirs = JaxLSD()(speech_data["speech"][0], speech_data["noisy_speech"][0])
    assert results[0]["LSD"] == pytest.approx(theirs[0]["LSD"], rel=2e-4, abs=2e-4)


def test_mismatched_shapes_raise():
    with pytest.raises(ValueError, match="same shape"):
        LSD(device="cpu")(np.zeros((2, 1000), np.float32), np.zeros((2, 999), np.float32))


def test_3d_input_raises():
    with pytest.raises(ValueError, match="1-D or 2-D"):
        LSD(device="cpu")(np.zeros((1, 2, 100), np.float32), np.zeros((1, 2, 100), np.float32))


def test_compute_returns_device_tensors(speech_data):
    scores = SDR(device="cpu").compute(speech_data["speech"], speech_data["noisy_speech"])
    assert set(scores) == {"SDR"}
    assert isinstance(scores["SDR"], torch.Tensor) and scores["SDR"].shape == (4,)


def test_resample_path_matches_native_rate(speech_data):
    """48 kHz input equals resampling to 16 kHz by hand, then scoring."""
    clean48 = np.repeat(speech_data["speech"][:2], 3, axis=1)
    noisy48 = np.repeat(speech_data["noisy_speech"][:2], 3, axis=1)
    via_metric = SDR(sample_rate=48000, device="cpu")(clean48, noisy48)
    manual = SDR(device="cpu")(
        resample(torch.from_numpy(clean48), 48000, 16000),
        resample(torch.from_numpy(noisy48), 48000, 16000),
    )
    for a, b in zip(via_metric, manual):
        assert a["SDR"] == pytest.approx(b["SDR"], abs=1e-3)


def test_ragged_lengths_match_per_utterance_calls():
    rs = np.random.RandomState(33)
    lens = [16000, 24000, 16000, 9137]
    clean = [rs.randn(t).astype(np.float32) for t in lens]
    noisy = [c + 0.3 * rs.randn(len(c)).astype(np.float32) for c in clean]
    assert _is_ragged(noisy)
    for metric in (LSD(device="cpu"), SDR(device="cpu")):
        ragged = metric(clean, noisy)
        assert len(ragged) == len(lens)
        for i, (c, d) in enumerate(zip(clean, noisy)):
            single = metric(c, d)[0]
            for k, v in single.items():
                assert ragged[i][k] == pytest.approx(v, rel=1e-4, abs=1e-3)
    with pytest.raises(ValueError, match="same per-utterance shapes"):
        LSD(device="cpu")(clean, noisy[:-1] + [noisy[-1][:-1]])


def test_ragged_equal_lengths_take_batched_path():
    rs = np.random.RandomState(34)
    clean = [rs.randn(16000).astype(np.float32) for _ in range(3)]
    noisy = [c + 0.1 * rs.randn(16000).astype(np.float32) for c in clean]
    assert not _is_ragged(noisy)
    assert len(LSD(device="cpu")(clean, noisy)) == 3


def test_base_keywords_construct():
    """The JAX package's ``dtype`` and ``mesh=None`` keywords construct every
    metric, SpeechBERTScore included, and ``dtype`` is kept."""
    assert SDR(device="cpu", dtype=torch.float32).dtype == torch.float32
    assert STOI(device="cpu", mesh=None).mesh is None
    config = HubertConfig(hidden_size=32, num_hidden_layers=1, num_attention_heads=2, intermediate_size=64,
                          conv_dim=(8, 8), conv_kernel=(10, 3), conv_stride=(5, 2), num_conv_pos_embeddings=4,
                          num_conv_pos_embedding_groups=2)
    sbs = SpeechBERTScore(device="cpu", params=init_params(torch.Generator().manual_seed(0), config), config=config,
                          output_layer=1, dtype=torch.float32)
    assert sbs.dtype == torch.float32 and sbs.mesh is None


@pytest.mark.parametrize("cls", [LSD, SDR, STOI, SpeechBERTScore], ids=lambda c: c.__name__)
def test_mesh_other_than_none_raises(cls):
    """A mesh sets the metric's device to the rank's own: a mesh beside an
    explicit device raises, naming both."""
    with pytest.raises(ValueError, match="device or mesh"):
        cls(device="cpu", mesh=object())


@pytest.mark.parametrize("cls", [LSD, SDR, STOI, SpeechBERTScore], ids=lambda c: c.__name__)
def test_dtype_other_than_float32_raises(cls):
    """The port's parameters are float32 only: a bf16 ``dtype`` raises rather
    than be stored and ignored (the JAX SpeechBERTScore loads a checkpoint's
    weights in it)."""
    with pytest.raises(NotImplementedError, match="float32"):
        cls(device="cpu", dtype=torch.bfloat16)


@pytest.mark.parametrize("cls", [LSD, SDR, STOI, SpeechBERTScore], ids=lambda c: c.__name__)
def test_non_intrusive_is_false(cls):
    assert cls.NON_INTRUSIVE is False
    assert getattr(jax_pkg, cls.__name__).NON_INTRUSIVE is False


def test_compute_goes_through_run_prepared(speech_data):
    """``compute`` (and so ``__call__``) hands the prepared audio to
    ``_run_prepared``, which a subclass may override."""
    calls = []

    class Shifted(SDR):
        def _run_prepared(self, clean, denoised):
            calls.append((tuple(clean.shape), tuple(denoised.shape)))
            return {"SDR": super()._run_prepared(clean, denoised)["SDR"] + 1.0}

    clean, noisy = speech_data["speech"], speech_data["noisy_speech"]
    got = Shifted(device="cpu")(clean, noisy)
    assert calls == [(clean.shape, noisy.shape)]
    for a, b in zip(got, SDR(device="cpu")(clean, noisy)):
        assert a["SDR"] == pytest.approx(b["SDR"] + 1.0, abs=1e-5)


def test_default_device_is_cuda():
    """Entry points run on the card: with no device they pick CUDA, and
    raise where there is none rather than carry on on the CPU."""
    if torch.cuda.is_available():
        assert LSD().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            LSD()
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            SDR(device="cuda")


def _run(code_or_args, cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    return subprocess.run(
        [sys.executable, *code_or_args], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=120,
    )


def test_port_and_chip_smoke_import_no_jax(tmp_path):
    """Importing every module of the port, and chip_smoke.py, loads neither
    jax nor any module of the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import fast_speech_enhancement_metrics_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [n for n in sys.modules if n == 'jax' or n.startswith('jax.') or n.startswith('jaxlib')\n"
        "       or n == 'fast_speech_enhancement_metrics_tpu'\n"
        "       or n.startswith('fast_speech_enhancement_metrics_tpu.')]\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    out = _run(["-c", code], cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_chip_smoke_fails_without_cuda_or_without_the_repo(tmp_path):
    """With no card, or from a directory holding only the script, the smoke
    run exits non-zero and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("this box has a CUDA card; the no-card branch cannot run here")
    out = _run([str(REPO / "chip_smoke.py")], cwd=REPO)
    assert out.returncode != 0 and '"ok"' not in out.stdout
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(REPO / "chip_smoke.py", lone)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, str(lone)], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout

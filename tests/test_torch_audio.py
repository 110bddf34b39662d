"""PyTorch port, the HF audio loaders against the JAX package's, offline.

A fake ``datasets`` module stands in for the HF streams: each
``load_dataset`` call yields four clips, shorter and longer than the
requested duration, at 16 kHz (the loaders' output is bit for bit the JAX
package's) or at 22.05 kHz (resampled by each package's own
``ops/resample.py``: rtol 1e-5 with an absolute floor of 1e-5 of the
output's scale, ``test_resample_matches_jax``'s tolerance). A
missing ``datasets`` package or a ``load_dataset`` that raises an
``OSError`` makes ``load_audio_data(source="hf")`` warn and return the
synthetic batch in both packages; in the port any other error (a fault of
its own resampling or clip handling) propagates.
"""

import sys
import types

import numpy as np
import pytest

from fast_speech_enhancement_metrics_tpu.utils import audio as jax_audio
from fast_speech_enhancement_metrics_tpu_torch.utils import audio as pt_audio

DURATION = 0.5
CLIP_SECONDS = (0.15, 0.85, 0.25, 0.6)  # 3.7 durations in all


def _fake_datasets(rate: int, calls: list):
    def load_dataset(name, *config, split, streaming):
        calls.append((name, config, split, streaming))
        rs = np.random.RandomState(len(name))
        for seconds in CLIP_SECONDS:
            yield {"audio": {"array": rs.randn(int(seconds * rate)).astype(np.float64) * 0.1,
                             "sampling_rate": rate}}

    module = types.ModuleType("datasets")
    module.load_dataset = load_dataset
    return module


def _close(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("loader", ["load_hf_noise", "load_hf_speech"])
@pytest.mark.parametrize("rows", [3, 6])
@pytest.mark.parametrize("rate", [16000, 22050])
def test_hf_loaders_match_jax(monkeypatch, loader, rows, rate):
    """Noise: clips concatenated until rows x T samples are on hand (6 rows
    tile the 3.7 durations); speech: each clip tiled or cropped to T, the
    rows past the stream's four clips zero."""
    calls = []
    monkeypatch.setitem(sys.modules, "datasets", _fake_datasets(rate, calls))
    ours = getattr(pt_audio, loader)(rows, DURATION, 16000)
    theirs = getattr(jax_audio, loader)(rows, DURATION, 16000)
    assert ours.shape == (rows, int(DURATION * 16000))
    if rate == 16000:
        np.testing.assert_array_equal(ours, theirs)
    else:
        _close(ours, theirs)
    assert calls[0] == calls[1] and calls[0][2:] == ("train", True)
    assert calls[0][0] == ("nccratliri/wing-flap-noise-audio-examples" if loader == "load_hf_noise"
                           else "MLCommons/peoples_speech")
    if loader == "load_hf_speech" and rows == 6:
        assert not ours[4:].any()


def test_hf_source_matches_jax(monkeypatch):
    monkeypatch.setitem(sys.modules, "datasets", _fake_datasets(16000, []))
    ours = pt_audio.load_audio_data(DURATION, 3, 16000, seed=5, source="hf")
    theirs = jax_audio.load_audio_data(DURATION, 3, 16000, seed=5, source="hf")
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
    synthetic = pt_audio.load_audio_data(DURATION, 3, 16000, seed=5)
    assert not np.array_equal(ours[0], synthetic[0])


def _raising_datasets(error: Exception):
    def load_dataset(*args, **kw):
        raise error

    module = types.ModuleType("datasets")
    module.load_dataset = load_dataset
    return module


@pytest.mark.parametrize("missing", ["package", "network", "dataset"])
def test_hf_source_falls_back_to_synthetic_with_a_warning(monkeypatch, missing):
    if missing == "package":
        monkeypatch.setitem(sys.modules, "datasets", None)  # the import raises ModuleNotFoundError
    else:
        error = ConnectionError("no network") if missing == "network" else FileNotFoundError("no such dataset")
        monkeypatch.setitem(sys.modules, "datasets", _raising_datasets(error))
    match = {"package": "ModuleNotFoundError", "network": "ConnectionError", "dataset": "FileNotFoundError"}
    synthetic = pt_audio.load_audio_data(DURATION, 2, 16000, seed=9)
    for pkg in (pt_audio, jax_audio):
        with pytest.warns(RuntimeWarning, match=match[missing]):
            got = pkg.load_audio_data(DURATION, 2, 16000, seed=9, source="hf")
        for a, b in zip(got, synthetic):
            np.testing.assert_array_equal(a, b)


def test_hf_source_raises_its_own_faults(monkeypatch):
    """A fault past the stream (here the resampler's) is not taken for a
    missing network: it propagates, and no synthetic batch is scored as
    "hf"."""
    def broken_resample(*args, **kw):
        raise ValueError("resampler fault")

    monkeypatch.setitem(sys.modules, "datasets", _fake_datasets(22050, []))
    monkeypatch.setattr(pt_audio, "resample", broken_resample)
    with pytest.raises(ValueError, match="resampler fault"):
        pt_audio.load_audio_data(DURATION, 2, 16000, seed=9, source="hf")


def test_hf_source_raises_on_a_malformed_clip(monkeypatch):
    def load_dataset(*args, **kw):
        yield {"audio": {"array": np.zeros(100)}}  # no sampling_rate

    module = types.ModuleType("datasets")
    module.load_dataset = load_dataset
    monkeypatch.setitem(sys.modules, "datasets", module)
    with pytest.raises(KeyError, match="sampling_rate"):
        pt_audio.load_audio_data(DURATION, 2, 16000, seed=9, source="hf")

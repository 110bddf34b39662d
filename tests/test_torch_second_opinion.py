"""PyTorch port, three-way agreement: the port on the CPU vs the float64
oracles (``tests/oracles/``) vs ``tests/second_opinion/``, a torch
transcription of the reference's own implementation.

The port of ``tests/test_second_opinion.py``, at its tolerances, the
reference's published agreement class: PESQ abs 5e-3, STOI/ESTOI abs 5e-4.
STOI's oracles take 10 kHz audio made by the port's own resampler.
"""

import numpy as np
import pytest
import torch

from fast_speech_enhancement_metrics_tpu_torch import PESQ, STOI
from fast_speech_enhancement_metrics_tpu_torch.ops.resample import resample
from tests.oracles.pesq_oracle import pesq_oracle
from tests.oracles.stoi_oracle import stoi_oracle
from tests.second_opinion.pesq_torch import pesq_torch_oracle
from tests.second_opinion.stoi_torch import stoi_torch_oracle


@pytest.fixture(scope="module")
def fixture_audio(speech_data):
    return speech_data["speech"][:4], speech_data["noisy_speech"][:4]


def test_pesq_three_way(fixture_audio):
    clean, noisy = fixture_audio
    ours = np.array([r["PESQ"] for r in PESQ(device="cpu")(clean, noisy)])
    oracle = np.asarray(pesq_oracle(clean, noisy))
    second = pesq_torch_oracle(clean, noisy)

    # the two independent oracles agree almost exactly (both float64)
    assert np.max(np.abs(oracle - second)) < 1e-6, (oracle, second)
    assert np.max(np.abs(ours - second)) < 5e-3, (ours, second)
    assert np.max(np.abs(ours - oracle)) < 5e-3, (ours, oracle)


def test_stoi_three_way(fixture_audio):
    clean, noisy = fixture_audio
    results = STOI(sample_rate=16000, device="cpu")(clean, noisy)
    ours_stoi = np.array([r["STOI"] for r in results])
    ours_estoi = np.array([r["ESTOI"] for r in results])

    c10 = resample(torch.from_numpy(clean), 16000, 10000).numpy()
    d10 = resample(torch.from_numpy(noisy), 16000, 10000).numpy()
    oracle_stoi, oracle_estoi = (np.asarray(a) for a in stoi_oracle(c10, d10))
    second_stoi, second_estoi = stoi_torch_oracle(c10, d10)

    assert np.max(np.abs(oracle_stoi - second_stoi)) < 1e-8
    assert np.max(np.abs(oracle_estoi - second_estoi)) < 1e-8
    for ours, want in ((ours_stoi, second_stoi), (ours_estoi, second_estoi),
                       (ours_stoi, oracle_stoi), (ours_estoi, oracle_estoi)):
        assert np.max(np.abs(ours - want)) < 5e-4, (ours, want)

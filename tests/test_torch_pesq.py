"""PyTorch port, PESQ: the metric, its IIR filters and Bark tables against the
JAX package and the float64 oracle on the CPU. Tolerances: abs 1e-3 MOS
against the JAX metric (both float32 on the CPU), abs 5e-3 against the
oracle (the JAX package's own contract, tests/test_pesq.py); the filters at
float32 round-off; the host-built tables bit for bit."""

import numpy as np
import pytest
import scipy.signal
import torch

from fast_speech_enhancement_metrics_tpu import PESQ as JaxPESQ
from fast_speech_enhancement_metrics_tpu.ops import bark as jax_bark
from fast_speech_enhancement_metrics_tpu.ops import iir as jax_iir
from fast_speech_enhancement_metrics_tpu_torch import PESQ
from fast_speech_enhancement_metrics_tpu_torch.metrics import pesq as pesq_mod
from fast_speech_enhancement_metrics_tpu_torch.ops import bark, iir
from tests.oracles.pesq_oracle import pesq_oracle

#: the injected delay of the time-alignment checks (75 ms at 16 kHz, inside
#: the +-100 ms search window), as tests/test_pesq.py
SHIFT = 1200


def _mos(results):
    return np.array([r["PESQ"] for r in results])


def _silent_frames(clean, noisy):
    """Per utterance, the number of frames that the port's silent-frame test
    (audible clean power < 1e7) calls silent."""
    m = PESQ(device="cpu")
    c, d = m._equalize_ranges(torch.from_numpy(clean), torch.from_numpy(noisy))
    bark_c = m._bark_bands(torch.cat([c, d]))[: len(clean)]
    return (m._audible_frame_power(bark_c, 1e2)[..., 0] < 1e7).sum(dim=1).tolist()


@pytest.fixture(scope="module")
def pairs(speech_data):
    return np.asarray(speech_data["speech"]), np.asarray(speech_data["noisy_speech"])


@pytest.fixture(scope="module")
def jax_scores(pairs):
    return _mos(JaxPESQ()(*pairs))


@pytest.fixture(scope="module")
def port_scores(pairs):
    return _mos(PESQ(device="cpu")(*pairs))


def test_pesq_matches_jax(pairs, jax_scores, port_scores):
    diff = np.abs(port_scores - jax_scores)
    assert np.all(diff <= 1e-3), (
        f"per utterance |port - JAX| {diff.tolist()}; silent clean frames {_silent_frames(*pairs)}"
    )


def test_pesq_matches_oracle(pairs, port_scores):
    np.testing.assert_allclose(port_scores, pesq_oracle(*pairs), atol=5e-3)


@pytest.mark.parametrize("precision", ["high", "highest"])
def test_pesq_precisions_are_float32(pairs, port_scores, precision):
    """Both precisions run float32 matmuls with TF32 off: the same scores."""
    np.testing.assert_array_equal(_mos(PESQ(device="cpu", precision=precision)(*pairs)), port_scores)


def test_pesq_rejects_unknown_precision():
    with pytest.raises(ValueError, match="precision"):
        PESQ(device="cpu", precision="bf16")


def test_pesq_identical_inputs(pairs):
    for score in _mos(PESQ(device="cpu")(pairs[0], pairs[0])):
        assert score > 4.0  # clean-vs-clean scores near the 4.55 ceiling


def test_pesq_range(port_scores):
    assert np.all((port_scores > 0.99) & (port_scores < 4.56))


def test_pesq_single_utterance(pairs, jax_scores):
    results = PESQ(device="cpu")(pairs[0][0], pairs[1][0])
    assert len(results) == 1
    assert results[0]["PESQ"] == pytest.approx(float(pesq_oracle(pairs[0][:1], pairs[1][:1])[0]), abs=5e-3)
    assert results[0]["PESQ"] == pytest.approx(float(jax_scores[0]), abs=1e-3)


def test_pesq_ragged_matches_per_length(pairs):
    """Unequal lengths are scored per length group, no padding."""
    clean = [pairs[0][0], pairs[0][1][:40000], pairs[0][2]]
    noisy = [pairs[1][0], pairs[1][1][:40000], pairs[1][2]]
    ragged = _mos(PESQ(device="cpu")(clean, noisy))
    want = np.concatenate([
        _mos(JaxPESQ()(np.stack([clean[0], clean[2]]), np.stack([noisy[0], noisy[2]]))),
        _mos(JaxPESQ()(clean[1], noisy[1])),
    ])[[0, 2, 1]]
    np.testing.assert_allclose(ragged, want, atol=1e-3)


def _shifted(noisy):
    delayed = np.concatenate([np.zeros_like(noisy[:, :SHIFT]), noisy[:, :-SHIFT]], axis=1)
    advanced = np.concatenate([noisy[:, SHIFT:], np.zeros_like(noisy[:, :SHIFT])], axis=1)
    return {"delayed": delayed, "advanced": advanced, "none": noisy}


@pytest.mark.parametrize("case", ["delayed", "advanced", "none"])
def test_pesq_time_align_matches_jax(pairs, case):
    """The aligned metric on an injected delay of +-1200 samples (and none)
    against the JAX package's aligned metric."""
    clean, noisy = pairs[0][:2], _shifted(pairs[1][:2])[case]
    port = _mos(PESQ(device="cpu", time_align=True)(clean, noisy))
    want = _mos(JaxPESQ(time_align=True)(clean, noisy))
    np.testing.assert_allclose(port, want, atol=1e-3)


def test_pesq_time_align_undoes_the_shift(pairs, port_scores):
    """As tests/test_pesq.py: the unaligned metric collapses under the shift
    (on the high-SNR utterance), the aligned one recovers the unshifted
    score up to the zero-filled tail (the advanced case loses the first
    75 ms outright), and a zero delay reproduces the default."""
    clean = pairs[0][:2]
    shifted = _shifted(pairs[1][:2])
    base = port_scores[:2]
    broken = _mos(PESQ(device="cpu")(clean, shifted["delayed"]))
    aligned = PESQ(device="cpu", time_align=True)
    assert broken[0] < base[0] - 0.5
    np.testing.assert_allclose(_mos(aligned(clean, shifted["delayed"])), base, atol=0.1)
    np.testing.assert_allclose(_mos(aligned(clean, shifted["advanced"])), base, atol=0.25)
    np.testing.assert_allclose(_mos(aligned(clean, shifted["none"])), base, atol=1e-5)


def test_pesq_align_delay_finds_the_injected_delay(pairs):
    """The estimated shift moves the delayed signal back: its first
    T - SHIFT samples are the undelayed ones."""
    clean, noisy = (torch.from_numpy(a[:2]) for a in pairs)
    delayed = torch.from_numpy(_shifted(pairs[1][:2])["delayed"])
    back = PESQ(device="cpu", time_align=True)._align_delay(clean, delayed)
    torch.testing.assert_close(back[:, : -SHIFT], noisy[:, : -SHIFT], rtol=0, atol=0)
    assert torch.all(back[:, -SHIFT:] == 0)


_FILTERS = {
    "level": tuple(tuple(np.float32(c)) for c in scipy.signal.butter(5, [325, 3250], fs=16000, btype="band")),
    "pre_emphasis": (pesq_mod.PRE_EMPHASIS_B, pesq_mod.PRE_EMPHASIS_A),
}


@pytest.mark.parametrize("name", sorted(_FILTERS))
@pytest.mark.parametrize("length", [16000, 5000])
def test_lfilter_fir_and_fft_match_scipy_and_jax(name, length):
    """Both IIR forms against scipy.signal.lfilter (float64) at float32
    round-off of the output's scale, and against the JAX package's."""
    b, a = _FILTERS[name]
    x = np.random.RandomState(3).randn(2, length).astype(np.float32)
    want = scipy.signal.lfilter(np.asarray(b, np.float64), np.asarray(a, np.float64), x.astype(np.float64))
    scale = np.abs(want).max()
    xt = torch.from_numpy(x)
    for got, jax_got in (
        (iir.lfilter_fir(xt, b, a), jax_iir.lfilter_fir(x, b, a)),
        (iir.lfilter_fft(xt, b, a), jax_iir.lfilter_fft(x, b, a)),
    ):
        assert got.dtype == torch.float32 and got.shape == x.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * scale)
        np.testing.assert_allclose(got.numpy(), np.asarray(jax_got), rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("name", sorted(_FILTERS))
def test_impulse_response_and_tables_bit_equal_jax(name):
    b, a = _FILTERS[name]
    key = (tuple(np.asarray(b)), tuple(np.asarray(a)))
    np.testing.assert_array_equal(iir._impulse_response(*key, 768), jax_iir._impulse_response(*key, 768))
    np.testing.assert_array_equal(iir._freq_response(*key, 1 << 15), jax_iir._freq_response(*key, 1 << 15))


def test_impulse_response_asserts_decay():
    """The truncation check: a pole at 0.999 has not decayed in 768 taps."""
    with pytest.raises(AssertionError, match="not decayed"):
        iir._impulse_response((1.0,), (1.0, -0.999), 768)


@pytest.mark.parametrize("nbarks,nfreqs", [(49, 256), (24, 128), (64, 256)])
def test_bark_constants_bit_equal_jax(nbarks, nfreqs):
    got = bark.bark_constants(nbarks, nfreqs)
    want = jax_bark.bark_constants(nbarks, nfreqs)
    assert sorted(got) == sorted(want)
    for k in want:
        assert type(got[k]) is type(want[k]), k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k


def test_bark_itu_tables_bit_equal_jax():
    names = [n for n in dir(jax_bark) if n.isupper()]
    assert len(names) >= 10
    for n in names:
        np.testing.assert_array_equal(getattr(bark, n), getattr(jax_bark, n), err_msg=n)
    for nbarks in (49, 30):
        np.testing.assert_array_equal(bark.interp_table(bark.CENTRE_OF_BAND_HZ_16K, nbarks),
                                      jax_bark.interp_table(jax_bark.CENTRE_OF_BAND_HZ_16K, nbarks))


def test_pesq_default_device_is_cuda():
    """The entry point runs on the card by default and raises where there is
    none; ``device="cpu"`` takes the plain path."""
    if torch.cuda.is_available():
        assert PESQ().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            PESQ()
    assert PESQ(device="cpu").device.type == "cpu"

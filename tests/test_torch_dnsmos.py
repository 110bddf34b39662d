"""PyTorch port, DNSMOS: the metric and its net against the JAX package and
the float64 oracle on the CPU, every window plan and execution plan, and
the weight layouts. Tolerances: 2e-4 against the JAX metric (both float32
on the CPU), 5e-4 against the oracle (tests/test_dnsmos.py), 1e-5 between
plans of the same function, the bf16 trunk within 0.04 / 0.04 / 0.02 of
float32 (the JAX package's bf16 class), the weights byte for byte."""

import numpy as np
import pytest
import torch

from fast_speech_enhancement_metrics_tpu import DNSMOS as JaxDNSMOS
from fast_speech_enhancement_metrics_tpu.models.dnsmos_net import DEFAULT_CHECKPOINT as JAX_CHECKPOINT
from fast_speech_enhancement_metrics_tpu.utils import convert_dnsmos as jax_convert
from fast_speech_enhancement_metrics_tpu.utils.audio import load_audio_data
from fast_speech_enhancement_metrics_tpu_torch import DNSMOS
from fast_speech_enhancement_metrics_tpu_torch.models import dnsmos_net
from fast_speech_enhancement_metrics_tpu_torch.utils import convert_dnsmos
from tests.oracles.dnsmos_oracle import dnsmos_oracle

KEYS = ("SIG", "BAK", "OVRL")


def _scores(results):
    return np.array([[r[k] for k in KEYS] for r in results])


@pytest.fixture(scope="module")
def noisy(speech_data):
    return np.asarray(speech_data["noisy_speech"])  # 4 x 4 s: tiled to 16 s, 7 windows


@pytest.fixture(scope="module")
def highest(noisy):
    return _scores(DNSMOS(device="cpu", precision="highest")(None, noisy))


@pytest.fixture(scope="module")
def jax_highest(noisy):
    return _scores(JaxDNSMOS(precision="highest")(None, noisy))


def test_dnsmos_matches_jax(highest, jax_highest):
    np.testing.assert_allclose(highest, jax_highest, rtol=0, atol=2e-4)


def test_dnsmos_matches_oracle(noisy, highest):
    oracle = dnsmos_oracle(noisy[:2])  # float64, window by window: two utterances
    np.testing.assert_allclose(highest[:2], np.stack([oracle[k] for k in KEYS], axis=1), rtol=0, atol=5e-4)


def test_dnsmos_default_precision_matches_highest(noisy, highest):
    """"default" and "highest" both run float32 convs with TF32 off."""
    np.testing.assert_array_equal(_scores(DNSMOS(device="cpu")(None, noisy)), highest)


def test_dnsmos_ignores_clean(speech_data, noisy, highest):
    with_clean = _scores(DNSMOS(device="cpu", precision="highest")(speech_data["speech"], noisy))
    np.testing.assert_array_equal(with_clean, highest)


def test_dnsmos_range(highest):
    assert np.all((highest >= 1.0) & (highest <= 5.0))


@pytest.mark.parametrize("duration_s", [4, 10, 16])
def test_dnsmos_shared_exact_equals_per_window(duration_s):
    """The shared trunk + edge strips reproduce every window's own zero
    padding: the per-window plan's scores up to reassociation."""
    _, noisy, _ = load_audio_data(duration_s, 3, 16000)
    exact = _scores(DNSMOS(device="cpu", window_plan="per_window", precision="highest")(None, noisy))
    fast = _scores(DNSMOS(device="cpu", window_plan="shared_exact", precision="highest")(None, noisy))
    np.testing.assert_allclose(fast, exact, rtol=0, atol=1e-5)


def test_dnsmos_per_window_matches_jax(noisy):
    port = _scores(DNSMOS(device="cpu", window_plan="per_window")(None, noisy[:2]))
    np.testing.assert_allclose(port, _scores(JaxDNSMOS(window_plan="per_window")(None, noisy[:2])), atol=2e-4)


def test_dnsmos_segment_chunking_matches(noisy):
    """Window chunks on the per-window plan (the last one padded by tiling
    windows) give the one-call scores."""
    full = _scores(DNSMOS(device="cpu", window_plan="per_window")(None, noisy[:2]))
    chunked = _scores(DNSMOS(device="cpu", window_plan="per_window", segment_chunk=6)(None, noisy[:2]))
    np.testing.assert_allclose(chunked, full, rtol=0, atol=1e-5)


@pytest.mark.parametrize("plan,chunk", [("shared_exact", 3), ("shared_exact", 9), ("per_window", 10)])
def test_dnsmos_host_chunk_matches(noisy, highest, plan, chunk):
    """The host loop (rows padded by tiling, also for a chunk above twice
    the rows; calibration in float64 on the host) against the in-graph
    shared_exact plan."""
    host = _scores(DNSMOS(device="cpu", precision="highest", window_plan=plan, host_chunk=chunk)(None, noisy))
    np.testing.assert_allclose(host, highest, rtol=0, atol=1e-5)


def test_dnsmos_shared_exact_row_chunking_matches():
    """The auto row-chunk path (forced by a tiny cap: rows padded with the
    first rows) against the one-call path, bf16 trunk, as tests/test_dnsmos.py."""
    noisy = (0.1 * np.random.RandomState(9).randn(12, 160000)).astype(np.float32)
    fused = DNSMOS(device="cpu", conv_dtype=torch.bfloat16)
    chunky = DNSMOS(device="cpu", conv_dtype=torch.bfloat16)
    chunky.shared_chunk_gb = 1e-3
    assert chunky._shared_chunk_rows(12, 999) == 1
    np.testing.assert_allclose(_scores(chunky(None, noisy)), _scores(fused(None, noisy)), rtol=0, atol=5e-5)


@pytest.mark.parametrize("batch,frames,conv_dtype,want", [
    (64, 1599, None, 32), (64, 1599, torch.bfloat16, None), (17, 6000, None, 8),
    (12, 12000, None, 6), (1, 100000, None, None),
])
def test_dnsmos_row_chunk_rule_matches_jax(batch, frames, conv_dtype, want):
    """The 6 GB rule on the conv0 map: 64 x 16 s in float32 (8.4 GB) takes
    two chunks of 32 rows; rounding to 8 rows goes down."""
    assert DNSMOS(device="cpu", conv_dtype=conv_dtype)._shared_chunk_rows(batch, frames) == want


def test_dnsmos_shared_conv_close(noisy, highest):
    """The approximate shared-trunk plan: within 0.12 of the exact one, and
    the JAX package's approximation at 2e-4."""
    shared = _scores(DNSMOS(device="cpu", host_chunk=4, shared_conv=True)(None, noisy))
    np.testing.assert_allclose(shared, highest, rtol=0, atol=0.12)
    jax_shared = _scores(JaxDNSMOS(host_chunk=4, shared_conv=True)(None, noisy))
    np.testing.assert_allclose(shared, jax_shared, rtol=0, atol=2e-4)


def test_dnsmos_bf16_convs_in_class(noisy, highest):
    """conv_dtype=torch.bfloat16 within the JAX package's bf16 class of the
    float32 scores."""
    fast = _scores(DNSMOS(device="cpu", conv_dtype=torch.bfloat16)(None, noisy))
    err = np.abs(fast - highest).max(axis=0)
    assert np.all(err <= np.array([0.04, 0.04, 0.02])), err


@pytest.mark.parametrize("conv_pack", ["mxu", "winograd", (1, 2, 2, 4, 4, 4, 2)])
def test_dnsmos_conv_pack_runs_the_same_convolution(noisy, highest, conv_pack):
    got = _scores(DNSMOS(device="cpu", precision="highest", conv_pack=conv_pack)(None, noisy))
    np.testing.assert_array_equal(got, highest)


@pytest.mark.parametrize("kw", [{"conv_pack": "tpu"}, {"window_plan": "strips"}, {"shared_conv": True},
                                {"precision": "fp8"}, {"conv_dtype": torch.float16}])
def test_dnsmos_rejects_bad_keywords(kw):
    with pytest.raises(ValueError):
        DNSMOS(device="cpu", **kw)


def test_dnsmos_rejects_empty_audio():
    """A zero-length clip never reaches 9.01 s by repetition."""
    with pytest.raises(ValueError, match="non-empty"):
        DNSMOS(device="cpu")(None, np.zeros((2, 0), np.float32))


def test_dnsmos_resampled_input_matches_jax():
    """48 kHz input, resampled to 16 kHz on the device first."""
    _, noisy, _ = load_audio_data(2, 2, 48000)
    port = _scores(DNSMOS(device="cpu", sample_rate=48000)(None, noisy))
    np.testing.assert_allclose(port, _scores(JaxDNSMOS(sample_rate=48000)(None, noisy)), rtol=0, atol=2e-4)


def test_checkpoint_is_byte_identical():
    assert dnsmos_net.DEFAULT_CHECKPOINT.read_bytes() == JAX_CHECKPOINT.read_bytes()


def _synthetic_state_dict(seed=0):
    """A seeded DNSMOS-shaped torch state dict (the reference layout)."""
    gen = torch.Generator().manual_seed(seed)
    sd = {
        "conv_real_stft.weight": torch.randn(161, 320, 1, generator=gen),
        "conv_imag_stft.weight": torch.randn(161, 320, 1, generator=gen),
    }
    cin = 1
    for idx, cout in zip(convert_dnsmos.CONV_INDICES, dnsmos_net.CONV_CHANNELS):
        sd[f"conv_layers.{idx}.weight"] = torch.randn(cout, cin, 3, 3, generator=gen)
        sd[f"conv_layers.{idx}.bias"] = torch.randn(cout, generator=gen)
        cin = cout
    for idx, (fin, fout) in zip(convert_dnsmos.DENSE_INDICES, ((64, 128), (128, 64), (64, 3))):
        sd[f"output_layers.{idx}.weight"] = torch.randn(fout, fin, generator=gen)
        sd[f"output_layers.{idx}.bias"] = torch.randn(fout, generator=gen)
    return sd


def test_convert_state_dict_matches_jax():
    sd = _synthetic_state_dict()
    got, want = convert_dnsmos.convert_state_dict(sd), jax_convert.convert_state_dict(sd)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_layout_maps_round_trip():
    """State dict -> npz layout -> the port's layout gives the state dict's
    own tensors: OIHW convs, (out, in) dense layers, the STFT's (161, 320)."""
    sd = _synthetic_state_dict(seed=1)
    port = convert_dnsmos.npz_to_torch_layout(convert_dnsmos.convert_state_dict(sd))
    assert np.array_equal(port["stft_real"], sd["conv_real_stft.weight"][:, :, 0].numpy())
    assert np.array_equal(port["stft_imag"], sd["conv_imag_stft.weight"][:, :, 0].numpy())
    for n, idx in enumerate(convert_dnsmos.CONV_INDICES):
        assert np.array_equal(port[f"conv{n}_w"], sd[f"conv_layers.{idx}.weight"].numpy())
        assert np.array_equal(port[f"conv{n}_b"], sd[f"conv_layers.{idx}.bias"].numpy())
    for n, idx in enumerate(convert_dnsmos.DENSE_INDICES):
        assert np.array_equal(port[f"dense{n}_w"], sd[f"output_layers.{idx}.weight"].numpy())
        assert np.array_equal(port[f"dense{n}_b"], sd[f"output_layers.{idx}.bias"].numpy())
    assert all(v.flags["C_CONTIGUOUS"] and v.dtype == np.float32 for v in port.values())


def test_load_params_maps_the_checkpoint():
    params = dnsmos_net.load_params()
    with np.load(str(JAX_CHECKPOINT)) as data:
        for k, v in data.items():
            got = params[k].numpy()
            if k.startswith("conv") and k.endswith("_w"):
                got = got.transpose(2, 3, 1, 0)  # OIHW -> HWIO
            elif got.ndim == 2:
                got = got.T
            np.testing.assert_array_equal(got, v, err_msg=k)


def test_dnsmos_default_device_is_cuda():
    """The entry point runs on the card by default and raises where there is
    none; ``device="cpu"`` takes the plain path."""
    if torch.cuda.is_available():
        assert DNSMOS().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            DNSMOS()
    assert DNSMOS(device="cpu").device.type == "cpu"

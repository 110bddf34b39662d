"""PyTorch port, SpeechBERTScore: the whole metric on the CPU against JAX.

The small HuBERT config of tests/test_torch_hubert.py with the JAX
package's ``init_params``; F1 atol 2e-4 on the shared 4 x 4 s fixture, on
the float32 path ("auto" off the card), on the block path (kernels
A7 + A8 as plain versions; Pallas in interpret mode on the JAX side), on
the whole-layer path (A11) and the int8 screening path (A12), and
on 2 x 0.5 s clips for the long-audio paths: "sdpa" (kernel A9's plain
version) in each softmax mode against the JAX metric's "sdpa" (its Pallas
kernel in interpret mode), and "flash" (A15's plain version) against the
JAX metric's exact "sdpa", since the JAX flash kernel runs only on a TPU.
Without a checkpoint both packages fall back to the converter (here fed a
saved small random HF model, never the network) and agree at F1 atol 2e-4.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from fast_speech_enhancement_metrics_tpu import SpeechBERTScore as JaxSpeechBERTScore
from fast_speech_enhancement_metrics_tpu.metrics import speechbertscore as jax_sbs_mod
from fast_speech_enhancement_metrics_tpu.models import hubert as jax_hubert
from fast_speech_enhancement_metrics_tpu.ops import sdpa_pallas as jax_sdpa
from fast_speech_enhancement_metrics_tpu.utils import convert_hubert as jax_convert_hubert
from fast_speech_enhancement_metrics_tpu.utils.audio import load_audio_data
from fast_speech_enhancement_metrics_tpu_torch import SpeechBERTScore
from fast_speech_enhancement_metrics_tpu_torch.metrics import speechbertscore as sbs_mod
from fast_speech_enhancement_metrics_tpu_torch.models import hubert
from fast_speech_enhancement_metrics_tpu_torch.utils import convert_hubert

SMALL = dict(
    hidden_size=64, num_hidden_layers=3, num_attention_heads=4, intermediate_size=256,
    conv_dim=(32, 32, 32), conv_kernel=(10, 3, 3), conv_stride=(5, 2, 2),
    num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
)


@pytest.fixture(scope="module")
def small():
    jcfg = jax_hubert.HubertConfig(**SMALL)
    params = jax.tree.map(np.asarray, jax_hubert.init_params(jax.random.key(0), jcfg))
    return jcfg, params, hubert.HubertConfig(**SMALL)


def _f1(rows):
    return np.array([r["SpeechBERTScore"] for r in rows])


@pytest.mark.parametrize("impl", ["auto", "block_ffn", "layer_block", "block_int8"])
def test_metric_matches_jax(speech_data, small, impl):
    jcfg, params, cfg = small
    clean, noisy = speech_data["speech"], speech_data["noisy_speech"]
    ours = SpeechBERTScore(device="cpu", params=params, config=cfg, output_layer=3, attention_impl=impl)(clean, noisy)
    theirs = JaxSpeechBERTScore(params=params, config=jcfg, output_layer=3, attention_impl=impl)(clean, noisy)
    np.testing.assert_allclose(_f1(ours), _f1(theirs), atol=2e-4, rtol=0)
    assert np.all(_f1(ours) <= 1.0)


@pytest.fixture
def jax_sdpa_interpret(monkeypatch):
    """The JAX package's sdpa kernel in interpret mode (the JAX package picks
    it only on a TPU, where it compiles)."""
    monkeypatch.setattr(jax_sdpa, "sdpa", functools.partial(jax_sdpa.sdpa, interpret=True))


@pytest.mark.parametrize("impl,softmax", [("sdpa", "exp2"), ("sdpa", "exact"), ("sdpa_exp2_bf16", "exp2"),
                                          ("flash", "exp2")])
def test_long_audio_paths_match_jax(small, jax_sdpa_interpret, impl, softmax):
    jcfg, params, cfg = small
    clean, noisy, _ = load_audio_data(0.5, 2, 16000)
    kw = dict(params=params, output_layer=3, softmax=softmax)
    ours = SpeechBERTScore(device="cpu", config=cfg, attention_impl=impl, **kw)(clean, noisy)
    jax_impl, jax_softmax = ("sdpa", "exact") if impl == "flash" else (impl, softmax)
    theirs = JaxSpeechBERTScore(config=jcfg, attention_impl=jax_impl, **{**kw, "softmax": jax_softmax})(clean, noisy)
    np.testing.assert_allclose(_f1(ours), _f1(theirs), atol=2e-4, rtol=0)


def test_identical_inputs_score_one(speech_data, small):
    _, params, cfg = small
    clean = speech_data["speech"]
    rows = SpeechBERTScore(device="cpu", params=params, config=cfg, output_layer=3)(clean, clean)
    np.testing.assert_allclose(_f1(rows), 1.0, atol=1e-5)


@pytest.mark.parametrize("chunking", [{"batch_chunk": 2}, {"host_chunk": 2}, {"host_chunk": 3}])
def test_chunking_gives_the_same_scores(speech_data, small, chunking):
    _, params, cfg = small
    clean, noisy = speech_data["speech"], speech_data["noisy_speech"]
    kw = dict(device="cpu", params=params, config=cfg, output_layer=3)
    full = SpeechBERTScore(**kw)(clean, noisy)
    chunked = SpeechBERTScore(**chunking, **kw)(clean, noisy)
    np.testing.assert_allclose(_f1(chunked), _f1(full), atol=1e-6, rtol=0)


def test_resolve_impl_on_a_card():
    """On a CUDA device "auto" takes the block kernels at 799 frames, A9
    ("sdpa") at 1500 frames or past 4 GB of logits (at any precision), and
    A15 ("flash") past 40 000 frames; off the card it is the float32 path."""
    cfg = hubert.HubertConfig(**{**SMALL, "hidden_size": 128, "num_attention_heads": 2})
    params = hubert.init_params(torch.Generator().manual_seed(0), cfg)
    metric = SpeechBERTScore(device="cpu", params=params, config=cfg)
    assert metric._resolve_impl(16 * 16000, 64) == "einsum"
    metric._on_cuda = lambda: True
    assert metric._resolve_impl(16 * 16000, 64) == "block_ffn"
    assert metric._resolve_impl(1500 * 320, 2) == "sdpa"
    assert metric._resolve_impl(16 * 16000, 1024) == "sdpa"  # 1024 x 2 x 799^2 x 4 B = 5.2 GB
    assert metric._resolve_impl(41000 * 320, 2) == "flash"
    exact = SpeechBERTScore(device="cpu", params=params, config=cfg, precision="highest")
    exact._on_cuda = lambda: True
    assert exact._resolve_impl(16 * 16000, 64) == "einsum"
    assert exact._resolve_impl(1500 * 320, 2) == "sdpa"
    assert (exact.gelu, exact.softmax, metric.gelu, metric.softmax) == ("erf", "exact", "tanh", "exp2")


@pytest.mark.parametrize("impl", ["auto", "block_ffn"])
def test_resolve_impl_raises_for_heads_the_kernel_lacks(small, impl):
    """The JAX rule takes the block path for any head width; on a CUDA
    device the kernels take heads of up to 128, so a config with heads of
    16 takes the block path there, and one with heads of 144 raises (naming
    the limit) instead of leaving the kernel path."""
    _, params, cfg = small
    metric = SpeechBERTScore(device="cpu", params=params, config=cfg, attention_impl=impl)
    assert metric._resolve_impl(16 * 16000, 8) == ("einsum" if impl == "auto" else "block_ffn")
    metric._on_cuda = lambda: True
    assert metric._resolve_impl(16 * 16000, 8) == "block_ffn"
    wide_cfg = hubert.HubertConfig(**{**SMALL, "hidden_size": 288, "num_attention_heads": 2})
    wide = SpeechBERTScore(device="cpu", params=hubert.init_params(torch.Generator().manual_seed(0), wide_cfg),
                           config=wide_cfg, attention_impl=impl)
    wide._on_cuda = lambda: True
    with pytest.raises(NotImplementedError, match="at most 128"):
        wide._resolve_impl(16 * 16000, 8)
    einsum = SpeechBERTScore(device="cpu", params=params, config=cfg, attention_impl="einsum")
    einsum._on_cuda = lambda: True
    assert einsum._resolve_impl(16 * 16000, 8) == "einsum"


def test_unported_paths_and_missing_weights_raise(tmp_path, small):
    """Every attention path of the JAX package is ported: "layer_block" and
    "block_int8" resolve to themselves on a card; an unknown path raises
    ValueError and a missing checkpoint FileNotFoundError."""
    _, params, cfg = small
    for impl in ("layer_block", "block_int8"):
        metric = SpeechBERTScore(device="cpu", params=params, config=cfg, attention_impl=impl)
        metric._on_cuda = lambda: True
        assert metric._resolve_impl(16 * 16000, 8) == impl
    with pytest.raises(ValueError):
        SpeechBERTScore(device="cpu", params=params, config=cfg, attention_impl="nope")
    with pytest.raises(FileNotFoundError, match="mhubert"):
        SpeechBERTScore(device="cpu", checkpoint=tmp_path / "mhubert147.npz")


@pytest.fixture(scope="module")
def saved_hf_model(tmp_path_factory):
    """A small random HF ``HubertModel`` saved with ``save_pretrained``: the
    stand-in for mHuBERT-147 on the hub."""
    from transformers import HubertConfig as HFConfig
    from transformers import HubertModel

    torch.manual_seed(2)
    model = HubertModel(HFConfig(**{**SMALL, "conv_pos_batch_norm": True})).eval()
    path = tmp_path_factory.mktemp("hf_hubert")
    model.save_pretrained(path)
    return str(path)


@pytest.fixture
def no_default_checkpoint(monkeypatch, tmp_path):
    """Both packages' default checkpoint missing, the hub offline."""
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setenv("TRANSFORMERS_OFFLINE", "1")
    monkeypatch.setattr(sbs_mod, "DEFAULT_CHECKPOINT", tmp_path / "absent" / "mhubert147.npz")
    monkeypatch.setattr(jax_sbs_mod, "DEFAULT_CHECKPOINT", tmp_path / "absent" / "mhubert147.npz")


def test_missing_checkpoint_falls_back_to_the_converter(speech_data, saved_hf_model, no_default_checkpoint,
                                                        monkeypatch):
    """No checkpoint anywhere: both packages convert the HF model (here the
    saved small one), take its config, and agree at F1 atol 2e-4."""
    from transformers import AutoConfig

    names = []
    for module, convert in ((convert_hubert, convert_hubert.convert_pretrained),
                            (jax_convert_hubert, jax_convert_hubert.convert_pretrained)):
        monkeypatch.setattr(module, "convert_pretrained",
                            lambda name, convert=convert: names.append(name) or convert(saved_hf_model))
    clean, noisy = speech_data["speech"], speech_data["noisy_speech"]
    ours_metric = SpeechBERTScore(device="cpu", output_layer=2)
    theirs_metric = JaxSpeechBERTScore(output_layer=2)
    assert names == [convert_hubert.MHUBERT_147] * 2
    assert ours_metric.config == convert_hubert.config_from_hf(AutoConfig.from_pretrained(saved_hf_model))
    assert ours_metric.config != hubert.MHUBERT_147_CONFIG and repr(ours_metric.config) == repr(theirs_metric.config)
    ours, theirs = _f1(ours_metric(clean, noisy)), _f1(theirs_metric(clean, noisy))
    np.testing.assert_allclose(ours, theirs, atol=2e-4, rtol=0)
    assert np.all(np.isfinite(ours)) and np.all(ours <= 1.0)


def test_failed_conversion_raises_file_not_found(no_default_checkpoint, monkeypatch):
    """The converter failing: both packages raise FileNotFoundError chained
    from its error; the port's message names its own converter CLI."""

    def offline(name):
        raise OSError(f"{name} is not in the hub cache")

    monkeypatch.setattr(convert_hubert, "convert_pretrained", offline)
    monkeypatch.setattr(jax_convert_hubert, "convert_pretrained", offline)
    cli = "fast_speech_enhancement_metrics_tpu_torch.utils.convert_hubert"
    with pytest.raises(FileNotFoundError, match=cli) as ours:
        SpeechBERTScore(device="cpu")
    assert isinstance(ours.value.__cause__, OSError)
    with pytest.raises(FileNotFoundError) as theirs:
        JaxSpeechBERTScore()
    assert isinstance(theirs.value.__cause__, OSError)


def test_named_missing_checkpoint_raises_before_conversion(tmp_path, monkeypatch):
    calls = []
    monkeypatch.setattr(convert_hubert, "convert_pretrained", lambda *a: calls.append(a))
    with pytest.raises(FileNotFoundError, match="not found"):
        SpeechBERTScore(device="cpu", checkpoint=tmp_path / "nope.npz")
    assert calls == []


def test_checkpoint_route_equals_params_route(speech_data, small, tmp_path, monkeypatch):
    """``checkpoint=`` (a ``save_params`` file) scores as ``params=`` does,
    bit for bit; ``params=`` wins over every load."""
    _, params, cfg = small
    path = tmp_path / "small.npz"
    convert_hubert.save_params(params, str(path))
    clean, noisy = speech_data["speech"][:2], speech_data["noisy_speech"][:2]
    via_file = _f1(SpeechBERTScore(device="cpu", checkpoint=path, config=cfg, output_layer=2)(clean, noisy))
    monkeypatch.setattr(convert_hubert, "load_params", lambda *a: pytest.fail("params= must not load"))
    via_params = _f1(SpeechBERTScore(device="cpu", checkpoint=tmp_path / "nope.npz", params=params, config=cfg,
                                     output_layer=2)(clean, noisy))
    np.testing.assert_array_equal(via_file, via_params)

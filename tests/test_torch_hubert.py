"""PyTorch port, HuBERT encoder: hidden states against the JAX package.

A small config (hidden 64, 4 heads, FFN 256, three 32-channel convs, 3
layers) on 1 s of audio, with the JAX package's ``init_params`` carried
across by ``from_jax_params``. The float32 path (einsum, erf) agrees at
atol 1e-4. The block path (kernels A7 + A8; their plain versions here,
the Pallas kernels in interpret mode on the JAX side) rounds to bf16 at the
same places; a bf16 rounding that flips between the two (their fp32 sums
differ in order) moves one residual by one bf16 step, up to 1.6e-2 at
|x| ~ 4, and such flips add up over layers: one layer is held at atol
1e-2, three at the JAX block tests' bf16 class (max 3e-2) with a median
of at most 1e-4. The long-audio paths ("sdpa*": kernel A9, "flash": A15,
plain versions here; the JAX sdpa kernel in interpret mode) agree at atol
1e-4 in float32 (precision "highest") and at the bf16 class at the default
precision, where q, k, v go to the kernel in bf16. The converter
(``convert_pretrained``, ``main``) on a saved small random HF model equals
the JAX package's bit for bit.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from fast_speech_enhancement_metrics_tpu.models import hubert as jax_hubert
from fast_speech_enhancement_metrics_tpu.ops import sdpa_pallas as jax_sdpa
from fast_speech_enhancement_metrics_tpu.utils import convert_hubert as jax_convert_hubert
from fast_speech_enhancement_metrics_tpu.utils.convert_hubert import save_params as jax_save_params
from fast_speech_enhancement_metrics_tpu_torch.models import hubert
from fast_speech_enhancement_metrics_tpu_torch.ops import conv_gelu, numerics
from fast_speech_enhancement_metrics_tpu_torch.utils import convert_hubert

SMALL = dict(
    hidden_size=64, num_hidden_layers=3, num_attention_heads=4, intermediate_size=256,
    conv_dim=(32, 32, 32), conv_kernel=(10, 3, 3), conv_stride=(5, 2, 2),
    num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
)
AUDIO = np.random.RandomState(1).randn(2, 16000).astype(np.float32)


def _setup(seed=0, bn=False, **overrides):
    jcfg = jax_hubert.HubertConfig(**{**SMALL, **overrides})
    params = jax.tree.map(np.asarray, jax_hubert.init_params(jax.random.key(seed), jcfg))
    if bn:  # a batch-norm positional conv's pre-affine, folded at conversion
        rs = np.random.RandomState(3)
        params["pos_conv"]["bn_scale"] = (1 + 0.3 * rs.randn(64)).astype(np.float32)
        params["pos_conv"]["bn_shift"] = (0.3 * rs.randn(64)).astype(np.float32)
    return jcfg, params, hubert.from_jax_params(params, hubert.HubertConfig(**{**SMALL, **overrides}))


def _ours(enc, **kw):
    return hubert.hubert_hidden_state(enc, torch.from_numpy(AUDIO), **kw).numpy()


@pytest.mark.parametrize("layer", [0, 3])
@pytest.mark.parametrize("softmax", ["exact", "exp2"])
def test_hidden_state_float32_matches_jax(layer, softmax):
    jcfg, params, enc = _setup()
    theirs = jax_hubert.hubert_hidden_state(params, AUDIO, jcfg, output_layer=layer, precision="highest",
                                            gelu="erf", softmax=softmax)
    np.testing.assert_allclose(_ours(enc, output_layer=layer, softmax=softmax), np.asarray(theirs), atol=1e-4, rtol=0)


def _block_path_diff(gelu, layer, seed=0):
    """|port - JAX| of the block path's hidden state after ``layer`` layers."""
    jcfg, params, enc = _setup(seed=seed)
    theirs = np.asarray(jax_hubert.hubert_hidden_state(
        params, AUDIO, jcfg, output_layer=layer, precision="highest", attention_impl="block_ffn",
        gelu=gelu, softmax="exp2"))
    ours = _ours(enc, output_layer=layer, attention_impl="block_ffn", gelu=gelu, softmax="exp2")
    return np.abs(ours - theirs)


@pytest.mark.parametrize("gelu", ["tanh", "erf"])
def test_hidden_state_block_path_matches_jax(gelu):
    """One layer within 1e-2; three within the bf16 class (3e-2), where
    only single flipped roundings (under 1e-4 of the values) pass 1e-2."""
    for layer, max_tol in ((1, 1e-2), (3, 3e-2)):
        diff = _block_path_diff(gelu, layer)
        stats = (layer, diff.max(), np.median(diff), np.mean(diff > 1e-2))
        assert diff.max() <= max_tol and np.median(diff) <= 1e-4 and np.mean(diff > 1e-2) <= 1e-4, stats


@pytest.fixture
def jax_sdpa_interpret(monkeypatch):
    monkeypatch.setattr(jax_sdpa, "sdpa", functools.partial(jax_sdpa.sdpa, interpret=True))


@pytest.mark.parametrize("impl", ["sdpa", "sdpa_exp2", "flash"])
@pytest.mark.parametrize("precision", ["highest", "default"])
def test_hidden_state_long_audio_paths_match_jax(jax_sdpa_interpret, impl, precision):
    """"flash" against the JAX exact "sdpa" (the JAX flash kernel runs only on a TPU)."""
    jcfg, params, enc = _setup()
    jax_impl = "sdpa" if impl == "flash" else impl
    theirs = np.asarray(jax_hubert.hubert_hidden_state(params, AUDIO, jcfg, output_layer=2, precision=precision,
                                                       attention_impl=jax_impl, softmax="exact"))
    ours = _ours(enc, output_layer=2, precision=precision, attention_impl=impl, softmax="exact")
    diff = np.abs(ours - theirs)
    if precision == "highest":
        assert diff.max() <= 1e-4, diff.max()
    else:
        assert diff.max() <= 3e-2 and np.median(diff) <= 1e-4, (diff.max(), np.median(diff))


def test_hidden_state_block_matches_jax():
    """"block": A7, then the plain FFN (erf GELU), as in the JAX package."""
    jcfg, params, enc = _setup()
    theirs = np.asarray(jax_hubert.hubert_hidden_state(params, AUDIO, jcfg, output_layer=1, precision="highest",
                                                       attention_impl="block", softmax="exp2"))
    diff = np.abs(_ours(enc, output_layer=1, attention_impl="block", softmax="exp2") - theirs)
    assert diff.max() <= 1e-2 and np.median(diff) <= 1e-4, (diff.max(), np.median(diff))


def test_hidden_state_batch_norm_pos_conv():
    jcfg, params, enc = _setup(bn=True)
    theirs = jax_hubert.hubert_hidden_state(params, AUDIO, jcfg, output_layer=2, precision="highest")
    np.testing.assert_allclose(_ours(enc, output_layer=2), np.asarray(theirs), atol=1e-4, rtol=0)


def test_hidden_state_pre_ln_layer_norm_features():
    """hubert-large's structure: layer-norm conv features, conv bias, pre-LN
    layers with the encoder LayerNorm after the last one."""
    jcfg, params, enc = _setup(feat_extract_norm="layer", conv_bias=True, do_stable_layer_norm=True)
    theirs = jax_hubert.hubert_hidden_state(params, AUDIO, jcfg, output_layer=3, precision="highest")
    np.testing.assert_allclose(_ours(enc, output_layer=3), np.asarray(theirs), atol=1e-4, rtol=0)
    with pytest.raises(ValueError, match="pre-LN"):
        _ours(enc, output_layer=1, attention_impl="block_ffn")


def test_hidden_state_pre_ln_flash(jax_sdpa_interpret):
    """HuBERT-xlarge's structure takes the long-audio kernels too."""
    jcfg, params, enc = _setup(feat_extract_norm="layer", conv_bias=True, do_stable_layer_norm=True)
    theirs = jax_hubert.hubert_hidden_state(params, AUDIO, jcfg, output_layer=3, precision="highest",
                                            attention_impl="sdpa", softmax="exact")
    ours = _ours(enc, output_layer=3, precision="highest", attention_impl="flash")
    np.testing.assert_allclose(ours, np.asarray(theirs), atol=1e-4, rtol=0)


def test_bf16_activations_return_float32():
    _, _, enc = _setup()
    full = _ours(enc, output_layer=2)
    half = _ours(enc, output_layer=2, act_dtype=torch.bfloat16)
    assert half.dtype == np.float32 and np.isfinite(half).all()
    assert np.median(np.abs(full - half)) < 5e-2


def test_npz_round_trip_from_jax(tmp_path):
    """JAX ``save_params`` -> the port's ``load_params`` gives the same
    parameters and hidden states."""
    jcfg, params, enc = _setup(bn=True)
    path = str(tmp_path / "hubert.npz")
    jax_save_params(params, path)
    loaded = convert_hubert.load_params(path)
    flat_a, flat_b = jax.tree.leaves(params), jax.tree.leaves(loaded)
    assert len(flat_a) == len(flat_b)
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)
    enc2 = hubert.from_jax_params(loaded, enc.config)
    np.testing.assert_array_equal(_ours(enc, output_layer=1), _ours(enc2, output_layer=1))
    convert_hubert.save_params(loaded, str(tmp_path / "again.npz"))
    again = convert_hubert.load_params(str(tmp_path / "again.npz"))
    for a, b in zip(flat_b, jax.tree.leaves(again)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("overrides", [{}, {"conv_pos_batch_norm": True}])
def test_hf_state_dict_fold_matches_jax(overrides):
    """The numpy fold of an HF state dict equals the JAX package's."""
    from transformers import HubertConfig as HFConfig
    from transformers import HubertModel

    from fast_speech_enhancement_metrics_tpu.utils.convert_hubert import config_from_hf as jax_config_from_hf

    torch.manual_seed(0)
    model = HubertModel(HFConfig(**{**SMALL, "intermediate_size": 96, **overrides})).eval()
    state = model.state_dict()
    theirs = jax_hubert.convert_hf_hubert(state, jax_config_from_hf(model.config))
    ours = convert_hubert.convert_hf_hubert(state, convert_hubert.config_from_hf(model.config))
    assert jax.tree.structure(jax.tree.map(np.asarray, theirs)) == jax.tree.structure(ours)
    for a, b in zip(jax.tree.leaves(theirs), jax.tree.leaves(ours)):
        np.testing.assert_array_equal(np.asarray(a), b)


@pytest.fixture(scope="module")
def saved_hf_model(tmp_path_factory):
    """A small random HF ``HubertModel`` (batch-norm positional conv, as
    mHuBERT-147's) saved with ``save_pretrained``: the hub model's stand-in."""
    from transformers import HubertConfig as HFConfig
    from transformers import HubertModel

    torch.manual_seed(1)
    model = HubertModel(HFConfig(**{**SMALL, "intermediate_size": 96, "conv_pos_batch_norm": True})).eval()
    path = tmp_path_factory.mktemp("hf_hubert")
    model.save_pretrained(path)
    return str(path)


@pytest.fixture
def hf_offline(monkeypatch):
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setenv("TRANSFORMERS_OFFLINE", "1")


def test_convert_pretrained_matches_jax(saved_hf_model, hf_offline):
    """``convert_pretrained`` on a saved model: the JAX package's pytree bit
    for bit, and an equal config."""
    ours, cfg = convert_hubert.convert_pretrained(saved_hf_model)
    theirs, jcfg = jax_convert_hubert.convert_pretrained(saved_hf_model)
    assert repr(cfg) == repr(jcfg) and cfg.conv_dim == SMALL["conv_dim"] and cfg.intermediate_size == 96
    assert jax.tree.structure(jax.tree.map(np.asarray, theirs)) == jax.tree.structure(ours)
    assert "bn_scale" in ours["pos_conv"]
    for a, b in zip(jax.tree.leaves(theirs), jax.tree.leaves(ours)):
        assert b.dtype == np.float32
        np.testing.assert_array_equal(np.asarray(a), b)


def test_converter_main_round_trip(saved_hf_model, hf_offline, tmp_path, capsys):
    """``main`` writes the npz that ``load_params`` reads back leaf for leaf,
    and prints the JAX package's line."""
    out = str(tmp_path / "ours.npz")
    convert_hubert.main(saved_hf_model, out)
    ours_line = capsys.readouterr().out.strip()
    jax_convert_hubert.main(saved_hf_model, str(tmp_path / "theirs.npz"))
    theirs_line = capsys.readouterr().out.strip()
    assert ours_line.startswith(f"wrote {out}: ") and " M parameters, config=HubertConfig(" in ours_line
    assert ours_line.replace("ours.npz", "theirs.npz") == theirs_line
    params, _ = convert_hubert.convert_pretrained(saved_hf_model)
    loaded = convert_hubert.load_params(out)
    assert jax.tree.structure(loaded) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(loaded)):
        np.testing.assert_array_equal(a, b)


def test_init_params_layout_and_seed():
    cfg = hubert.HubertConfig(**SMALL)
    a = hubert.init_params(torch.Generator().manual_seed(0), cfg)
    b = hubert.init_params(torch.Generator().manual_seed(0), cfg)
    ref = jax.tree.map(np.asarray, jax_hubert.init_params(jax.random.key(0), jax_hubert.HubertConfig(**SMALL)))
    assert jax.tree.structure(a) == jax.tree.structure(ref)
    for x, y, r in zip(jax.tree.leaves(a), jax.tree.leaves(b), jax.tree.leaves(ref)):
        assert x.shape == r.shape and x.dtype == np.float32
        np.testing.assert_array_equal(x, y)


# -- convs 1-6 on the conv_gelu kernel: the rule, and the CPU path it leaves alone --

WIDE = dict(SMALL, conv_dim=(64, 64, 64), conv_kernel=(10, 3, 2))  # convs 1-2 are the kernel's shape on a card


@pytest.mark.parametrize("device_type,dtype,stride,width,c_in,c_out,want", [
    ("cuda", torch.float32, 2, 3, 512, 512, True),
    ("cuda", torch.float32, 2, 2, 512, 512, True),
    ("cuda", torch.float32, 2, 3, 64, 64, True),
    ("cuda", torch.float32, 2, 2, 64, 512, True),
    ("cpu", torch.float32, 2, 3, 512, 512, False),
    ("meta", torch.float32, 2, 3, 512, 512, False),
    ("cuda", torch.bfloat16, 2, 3, 512, 512, False),
    ("cuda", torch.float16, 2, 3, 512, 512, False),
    ("cuda", torch.float64, 2, 3, 512, 512, False),
    ("cuda", torch.float32, 5, 10, 1, 512, False),  # conv 0
    ("cuda", torch.float32, 1, 3, 512, 512, False),
    ("cuda", torch.float32, 2, 4, 512, 512, False),
    ("cuda", torch.float32, 2, 1, 512, 512, False),
    ("cuda", torch.float32, 2, 3, 32, 32, False),  # the small config's channels
    ("cuda", torch.float32, 2, 3, 96, 512, False),
    ("cuda", torch.float32, 2, 3, 512, 96, False),
])
def test_conv_gelu_dispatch_rule(device_type, dtype, stride, width, c_in, c_out, want):
    """The kernel engages on what the call shows alone: a CUDA device,
    float32, stride 2, width 2 or 3, channels multiples of 64."""
    assert conv_gelu.engages(device_type, dtype, stride, width, c_in, c_out) is want


@pytest.mark.parametrize("rule,device_type,dtype,stride,width,c_in,c_out,want", [
    ("ln", "cuda", torch.float32, 2, 3, 512, 512, True),  # WavLM's convs 1-4
    ("ln", "cuda", torch.float32, 2, 2, 512, 512, True),  # convs 5-6
    ("ln", "cuda", torch.float32, 2, 3, 64, 128, True),  # a cluster of one block
    ("ln", "cuda", torch.float32, 2, 3, 512, 1024, True),  # of eight
    ("ln", "cpu", torch.float32, 2, 3, 512, 512, False),
    ("ln", "cuda", torch.bfloat16, 2, 3, 512, 512, False),
    ("ln", "cuda", torch.float32, 5, 10, 1, 512, False),  # conv 0 is the other kernel's
    ("ln", "cuda", torch.float32, 2, 3, 512, 64, False),  # outputs not a multiple of 128
    ("ln", "cuda", torch.float32, 2, 3, 512, 384 + 64, False),
    ("ln", "cuda", torch.float32, 2, 3, 512, 1152, False),  # a cluster of nine
    ("ln", "cuda", torch.float32, 2, 3, 96, 512, False),
    ("ln", "cuda", torch.float32, 1, 3, 512, 512, False),
    ("ln", "cuda", torch.float32, 2, 4, 512, 512, False),
    ("conv0", "cuda", torch.float32, 5, 10, 1, 512, True),  # WavLM's conv 0
    ("conv0", "cpu", torch.float32, 5, 10, 1, 512, False),
    ("conv0", "meta", torch.float32, 5, 10, 1, 512, False),
    ("conv0", "cuda", torch.bfloat16, 5, 10, 1, 512, False),
    ("conv0", "cuda", torch.float64, 5, 10, 1, 512, False),
    ("conv0", "cuda", torch.float32, 5, 10, 1, 256, False),
    ("conv0", "cuda", torch.float32, 5, 10, 2, 512, False),
    ("conv0", "cuda", torch.float32, 4, 10, 1, 512, False),
    ("conv0", "cuda", torch.float32, 5, 8, 1, 512, False),
    ("conv0", "cuda", torch.float32, 2, 3, 512, 512, False),  # convs 1-6 are the other kernel's
])
def test_conv_ln_gelu_dispatch_rules(rule, device_type, dtype, stride, width, c_in, c_out, want):
    """The LayerNorm kernels engage on what the call shows alone: convs 1-6
    as FE's rule, outputs in 1 to 8 blocks of 128; conv 0 at its one shape;
    a CUDA device and float32 for both."""
    fn = conv_gelu.engages_ln if rule == "ln" else conv_gelu.engages_conv0_ln
    assert fn(device_type, dtype, stride, width, c_in, c_out) is want


def _feature_encoder_before_kernel(enc, audio, gelu):
    """``feature_encoder`` as it was before convs 1-6 had a kernel: every
    layer on ``F.conv1d`` and its passes."""
    config = enc.config
    x = audio[:, None, :]
    for i, layer in enumerate(enc.feature_encoder):
        with hubert._conv_flags():
            x = torch.nn.functional.conv1d(x, layer["w"].to(x.dtype), stride=config.conv_stride[i])
        if "b" in layer:
            x = x + layer["b"].to(x.dtype)[:, None]
        if config.feat_extract_norm == "group" and i == 0:
            xf = x.float()
            mean = torch.mean(xf, dim=2, keepdim=True)
            var = torch.clamp(torch.mean(xf * xf, dim=2, keepdim=True) - mean * mean, min=0.0)
            xf = (xf - mean) * torch.rsqrt(var + config.layer_norm_eps)
            x = (xf * layer["norm_scale"].float()[:, None] + layer["norm_bias"].float()[:, None]).to(x.dtype)
        elif config.feat_extract_norm == "layer":
            x = numerics.layer_norm(x.transpose(1, 2), layer["norm_scale"], layer["norm_bias"],
                                    config.layer_norm_eps).transpose(1, 2)
        x = numerics.gelu(x, gelu)
    return x.transpose(1, 2)


@pytest.mark.parametrize("gelu", ["erf", "tanh"])
@pytest.mark.parametrize("overrides", [{}, WIDE, dict(WIDE, feat_extract_norm="layer")])
def test_feature_encoder_on_cpu_is_the_pre_kernel_path(overrides, gelu):
    _, _, enc = _setup(**overrides)
    audio = torch.from_numpy(AUDIO)
    got = hubert.feature_encoder(enc, audio, gelu=gelu)
    assert torch.equal(got, _feature_encoder_before_kernel(enc, audio, gelu))


#: the layer-norm encoder at WavLM's conv widths (512 channels, conv 0 of width 10 and stride 5)
LN_WIDE = dict(SMALL, conv_dim=(512, 512, 512), conv_kernel=(10, 3, 2), feat_extract_norm="layer")


@pytest.mark.parametrize("overrides,dtype,routed", [
    (WIDE, torch.float32, {"conv_gelu": [1, 2]}),
    (WIDE, torch.bfloat16, {}),
    (LN_WIDE, torch.float32, {"conv0_ln_gelu": [0], "conv_ln_gelu": [1, 2]}),
    (LN_WIDE, torch.bfloat16, {}),
    (dict(LN_WIDE, conv_bias=True), torch.float32, {}),
    (dict(WIDE, feat_extract_norm="layer"), torch.float32, {}),  # 64 outputs: no cluster of 128s
])
def test_feature_encoder_routes_eligible_layers(monkeypatch, overrides, dtype, routed):
    """With the device check pretended away, each layer reaches the kernel
    its rule names with its operands (convs 1-6 their cached pieces, conv
    0 its weights, contiguous as converted): the group-norm
    encoder's convs 1-2 (no norm, no bias) ``conv_gelu`` and its conv 0
    (GroupNorm) cuDNN; the layer-norm encoder's conv 0 ``conv0_ln_gelu``
    and convs 1-2 ``conv_ln_gelu``. Nothing in bf16, with a conv bias or
    off the kernels' shapes. The wrappers' plain versions give the
    pre-kernel path bit for bit."""
    _, _, enc = _setup(**overrides)
    calls = {}

    for name in ("engages", "engages_ln", "engages_conv0_ln"):
        rule = getattr(conv_gelu, name)
        monkeypatch.setattr(conv_gelu, name, lambda device_type, *args, rule=rule: rule("cuda", *args))

    def plain(name, fn):
        def wrapper(x, w, *args, pieces=None):
            calls.setdefault(name, []).append(w if name == "conv0_ln_gelu" else pieces)
            return fn(x, w, *args)
        return wrapper

    stride0 = conv_gelu.CONV0_SHAPE[2]
    monkeypatch.setattr(conv_gelu, "conv_gelu", plain("conv_gelu", conv_gelu._conv_gelu_plain))
    monkeypatch.setattr(conv_gelu, "conv_ln_gelu", plain("conv_ln_gelu", functools.partial(
        lambda x, w, *args: conv_gelu._conv_ln_gelu_plain(x, w, *args, conv_gelu.STRIDE))))
    monkeypatch.setattr(conv_gelu, "conv0_ln_gelu", plain("conv0_ln_gelu", functools.partial(
        lambda x, w, *args: conv_gelu._conv_ln_gelu_plain(x, w, *args, stride0))))
    audio = torch.from_numpy(AUDIO).to(dtype)
    got = hubert.feature_encoder(enc, audio, gelu="tanh")
    assert calls.keys() == routed.keys()
    for name, layers in routed.items():
        want = [enc.feature_encoder[i]["w"] if name == "conv0_ln_gelu" else enc.conv_pieces(i) for i in layers]
        assert len(calls[name]) == len(want) and all(p is q for p, q in zip(calls[name], want))
        assert all(w.is_contiguous() for w in calls[name])
    assert torch.equal(got, _feature_encoder_before_kernel(enc, audio, "tanh"))


def test_conv_pieces_sum_to_the_weights_and_are_cached():
    _, _, enc = _setup(**WIDE)
    pieces = enc.conv_pieces(1)
    w = enc.feature_encoder[1]["w"]
    assert pieces.dtype == torch.bfloat16 and tuple(pieces.shape) == (3, 3, 64, 64)
    assert torch.equal((pieces[0].float() + pieces[1].float()) + pieces[2].float(), w.permute(2, 0, 1))
    assert enc.conv_pieces(1) is pieces
    enc.float()  # moving or casting the module drops the cache
    assert enc.conv_pieces(1) is not pieces


@pytest.mark.parametrize("gelu", ["erf", "tanh"])
def test_conv_gelu_pieces_arithmetic_is_float32_class(gelu):
    """The kernel's bf16x6 sum (its float64 twin) against a float64 conv:
    within float32 rounding of the products' magnitudes."""
    rs = np.random.RandomState(4)
    x = torch.from_numpy(rs.randn(2, 64, 101).astype(np.float32))
    w = torch.from_numpy((rs.randn(64, 64, 3) / 14).astype(np.float32))
    want = numerics.gelu(torch.nn.functional.conv1d(x.double(), w.double(), stride=2), gelu)
    bound = torch.nn.functional.conv1d(x.double().abs(), w.double().abs(), stride=2)
    got = conv_gelu._conv_gelu_pieces_reference(x, w, gelu)
    assert bool(torch.all((got - want).abs() <= 2.0**-22 * bound))
    plain = conv_gelu.conv_gelu(x, w, gelu)
    assert plain.dtype == torch.float32 and bool(torch.all((plain.double() - want).abs() <= 2.0**-18 * bound))


def _ln64(y, scale, shift, eps=1e-5):
    """LayerNorm over the channels of (B, C, T) float64."""
    mean = y.mean(dim=1, keepdim=True)
    var = ((y - mean) ** 2).mean(dim=1, keepdim=True)
    return (y - mean) * torch.rsqrt(var + eps) * scale.double()[:, None] + shift.double()[:, None]


@pytest.mark.parametrize("gelu", ["erf", "tanh"])
@pytest.mark.parametrize("c_in,width,stride,t_in", [(64, 3, 2, 101), (128, 2, 2, 64), (1, 10, 5, 1003)])
def test_conv_ln_gelu_arithmetic_is_float32_class(c_in, width, stride, t_in, gelu):
    """The LayerNorm kernels' arithmetic in float64 (``_conv_ln_gelu_reference``:
    the conv's six piece products at stride 2 or conv 0's plain products,
    the two-pass statistics, the affine, the GELU) against conv +
    LayerNorm + GELU in float64: within float32 rounding of the conv,
    carried through the norm (a frame's largest |conv| term over its
    deviation, times (2 + its largest |normed value|) for the mean's and
    the deviation's share, times the scale), as is the plain version
    (float32: ``F.conv1d``, ``numerics.layer_norm``, the GELU; 0.04-0.17
    of the bound here, the model under 0.002)."""
    rs = np.random.RandomState(6)
    c_out = 128
    x = torch.from_numpy(rs.randn(2, c_in, t_in).astype(np.float32))
    w = torch.from_numpy((rs.randn(c_out, c_in, width) / np.sqrt(c_in * width)).astype(np.float32))
    scale = torch.from_numpy((1 + 0.1 * rs.randn(c_out)).astype(np.float32))
    shift = torch.from_numpy((0.1 * rs.randn(c_out)).astype(np.float32))
    conv = torch.nn.functional.conv1d(x.double(), w.double(), stride=stride)
    normed = _ln64(conv, torch.ones(c_out), torch.zeros(c_out))
    want = numerics.gelu(_ln64(conv, scale, shift), gelu)
    terms = torch.nn.functional.conv1d(x.double().abs(), w.double().abs(), stride=stride).amax(dim=1, keepdim=True)
    sigma = (conv - conv.mean(dim=1, keepdim=True)).pow(2).mean(dim=1, keepdim=True).sqrt()
    bound = 1.2 * 2.0**-22 * terms / sigma * (2 + normed.abs().amax(dim=1, keepdim=True)) * scale.abs().max()
    got = conv_gelu._conv_ln_gelu_reference(x, w, scale, shift, 1e-5, gelu, stride)
    assert bool(torch.all((got - want).abs() <= bound))
    plain = conv_gelu._conv_ln_gelu_plain(x, w, scale, shift, 1e-5, gelu, stride)
    assert plain.dtype == torch.float32 and bool(torch.all((plain.double() - want).abs() <= bound))
    wrapper = conv_gelu.conv0_ln_gelu if stride == 5 else conv_gelu.conv_ln_gelu  # on the CPU: the plain version
    assert torch.equal(wrapper(x, w, scale, shift, 1e-5, gelu), plain)


if __name__ == "__main__":
    # the block path's readings over seeds: JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_hubert.py
    for seed in range(4):
        for gelu in ("tanh", "erf"):
            for layer in (1, 3):
                diff = _block_path_diff(gelu, layer, seed)
                print(f"seed {seed} gelu {gelu} layers {layer}: max {diff.max():.4g} median {np.median(diff):.3g} "
                      f"over 1e-2: {int((diff > 1e-2).sum())} of {diff.size}")

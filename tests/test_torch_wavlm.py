"""PyTorch port, WavLM (SpeechBERTScore's WavLM-Large): the encoder against
the benchmark's plain reference and Hugging Face ``WavLMModel``.

A small WavLM (hidden 64, 4 heads of 16, FFN 128, three 32-channel convs
with a LayerNorm each, 3 pre-LN layers, 16 buckets up to a distance of 20)
on 0.25 s of audio: 199 frames, so offsets past 20 take the saturated
buckets and the last 128-query tile is ragged. HF's random init draws the
bucket table at N(0, 0.02), where the bias barely moves a logit; the tests
redraw it at N(0, 1), the gate's weights at N(0, 1/16) and its constants
around 1, so that the bias and its gate matter, and every planted fault
below moves the hidden state by 1.5e-2 or more.

Tolerances: the plain float32 route ("einsum") differs from the reference
and from HF by the order of float32 sums only (2.3e-6 at |x| ~ 3.7 after 3
layers): atol 2e-5. The kernel route's plain version ("relpos_block" on the
CPU) rounds u, qkv with the gate logits, the probabilities, the context and
the FFN hidden to bf16, the class of kernels A7 / A8 (1.1e-3 here): atol
5e-3, and 2e-3 for F1, a mean of cosines. No JAX here: the JAX package has
no WavLM.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from fast_speech_enhancement_metrics_tpu_torch import SpeechBERTScore, tracing
from fast_speech_enhancement_metrics_tpu_torch.models import hubert
from fast_speech_enhancement_metrics_tpu_torch.ops import conv_gelu, relpos_attention
from fast_speech_enhancement_metrics_tpu_torch.utils import convert_hubert
from portbench.reference import wavlm as reference

transformers = pytest.importorskip("transformers")

TINY = dict(hidden_size=64, num_hidden_layers=3, num_attention_heads=4, intermediate_size=128,
            conv_dim=(32, 32, 32), conv_kernel=(10, 3, 3), conv_stride=(5, 2, 2), feat_extract_norm="layer",
            do_stable_layer_norm=True, num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
            num_buckets=16, max_bucket_distance=20, conv_bias=False)
AUDIO = torch.from_numpy(np.random.RandomState(1).randn(2, 4000).astype(np.float32))
F32_ATOL = 2e-5
BF16_ATOL = 5e-3
F1_BF16_ATOL = 2e-3
REF_KEYS = ("conv_stride", "layer_norm_eps", "num_conv_pos_embeddings", "num_conv_pos_embedding_groups",
            "num_attention_heads", "num_buckets", "max_bucket_distance", "num_hidden_layers")


def _hf_model(seed=0):
    torch.manual_seed(seed)
    model = transformers.WavLMModel(transformers.WavLMConfig(**TINY)).eval()
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "rel_attn_embed" in name:
                p.copy_(torch.randn(p.shape, generator=g))
            elif "gru_rel_pos_linear.weight" in name:
                p.copy_(torch.randn(p.shape, generator=g) / 4)
            elif "gru_rel_pos_const" in name:
                p.copy_(1 + 0.5 * torch.randn(p.shape, generator=g))
            elif p.dim() == 1:
                p.add_(0.1 * torch.randn(p.shape, generator=g))
            elif "q_proj" in name or "k_proj" in name:
                p.mul_(3)
    return model


@pytest.fixture(scope="module")
def tiny():
    """(HF model, its hidden states of AUDIO, converted params, config, reference config)."""
    model = _hf_model()
    cfg = convert_hubert.config_from_hf(model.config)
    params = convert_hubert.convert_hf_hubert(model.state_dict(), cfg)
    with torch.no_grad():
        hf = model(AUDIO, output_hidden_states=True).hidden_states
    return model, hf, params, cfg, {k: getattr(cfg, k) for k in REF_KEYS}


def _ours(params, cfg, layers, **kw):
    return hubert.hubert_hidden_state(hubert.from_jax_params(params, cfg), AUDIO, output_layer=layers, **kw)


def _ref(params, rcfg, layers, gelu="erf"):
    with reference.float32_exact():
        return reference.hidden_state(reference.on_device(params, "cpu"), rcfg, AUDIO, layers, gelu)


def test_buckets_match_hf():
    """The port's and the reference's bucket functions against HF's
    ``_relative_positions_bucket``, at WavLM-Large's 320 buckets up to 800
    and at the tests' 16 up to 20 (exact, log-spaced and saturated)."""
    offsets = torch.arange(-3000, 3001)
    for buckets, distance in ((320, 800), (16, 20)):
        att = transformers.models.wavlm.modeling_wavlm.WavLMAttention(64, 4, num_buckets=buckets,
                                                                       max_distance=distance)
        want = att._relative_positions_bucket(offsets)
        assert torch.equal(relpos_attention.relative_position_buckets(offsets, buckets, distance), want)
        assert torch.equal(reference.relative_buckets(offsets, buckets, distance), want)


@pytest.mark.parametrize("layers", [1, 2, 3])
@pytest.mark.parametrize("softmax", ["exact", "exp2"])
def test_float32_route_matches_reference_and_hf(tiny, layers, softmax):
    """The plain float32 route's hidden state after each layer equals the
    reference's and HF's ``hidden_states[layers]`` (no final LayerNorm
    before the last of the model's layers: 3 of 3 takes it)."""
    _, hf, params, cfg, rcfg = tiny
    ours = _ours(params, cfg, layers, softmax=softmax)
    want = _ref(params, rcfg, layers)
    torch.testing.assert_close(want, hf[layers], rtol=0, atol=F32_ATOL)
    torch.testing.assert_close(ours, want, rtol=0, atol=F32_ATOL)


@pytest.mark.parametrize("layers", [1, 3])
@pytest.mark.parametrize("softmax", ["exp2", "exact"])
def test_kernel_route_plain_version_matches_reference(tiny, layers, softmax):
    """The ``relpos_block`` route (the kernels' plain versions on the CPU)
    in the bf16 class of the reference and of HF, in both softmax modes the
    route takes by default and at "exact"."""
    _, hf, params, cfg, rcfg = tiny
    ours = _ours(params, cfg, layers, softmax=softmax, attention_impl="relpos_block")
    want = _ref(params, rcfg, layers)
    torch.testing.assert_close(ours, want, rtol=0, atol=BF16_ATOL)
    torch.testing.assert_close(ours, hf[layers], rtol=0, atol=BF16_ATOL)


@pytest.mark.parametrize("route", [dict(precision="highest"), dict(precision="default", attention_impl="relpos_block")])
def test_f1_matches_reference(tiny, route):
    """F1 through the public call, float32 route and kernel route, against
    the reference's scores (at each route's GELU: erf at "highest", tanh at
    the default precision)."""
    _, _, params, cfg, rcfg = tiny
    clean, noisy = AUDIO[:1].numpy(), (AUDIO[1:] * 0.3 + AUDIO[:1]).numpy()
    metric = SpeechBERTScore(params=params, config=cfg, output_layer=2, device="cpu", **route)
    got = [r["SpeechBERTScore"] for r in metric(clean, noisy)]
    with reference.float32_exact():
        want = reference.scores(reference.on_device(params, "cpu"), rcfg, torch.from_numpy(clean),
                                torch.from_numpy(noisy), 2, gelu=metric.gelu)
    atol = F32_ATOL if route["precision"] == "highest" else F1_BF16_ATOL
    np.testing.assert_allclose(got, [w["SpeechBERTScore"] for w in want], rtol=0, atol=atol)


def _fault_gap(params, cfg, rcfg, layers, monkeypatch, fault):
    want = _ref(params, rcfg, layers)
    if fault == "bias_dropped":
        params = copy.deepcopy(params)
        params["rel_embed"] = params["rel_embed"] * 0
    elif fault == "gate_one":
        monkeypatch.setattr(relpos_attention, "gate",
                            lambda u, *a: torch.ones(u.shape[0], cfg.num_attention_heads, u.shape[1]))
    elif fault == "gate_from_q":
        original = relpos_attention.gate
        qw, qb = (torch.from_numpy(params["layers"][0][k]) for k in ("q_w", "q_b"))
        monkeypatch.setattr(relpos_attention, "gate", lambda u, *a: original(u @ qw + qb, *a))
    return (_ours(params, cfg, layers, softmax="exact") - want).abs().max().item()


@pytest.mark.parametrize("fault", ["bias_dropped", "gate_one", "gate_from_q"])
def test_planted_faults_fail_the_comparison(tiny, monkeypatch, fault):
    """The bias dropped, the gate held at 1, or the gate computed from q
    instead of the normed input u (one layer, whose q weights the fault
    reads): each leaves the float32 tolerance by a factor of 100 and the
    kernel route's bf16 one too."""
    _, _, params, cfg, rcfg = tiny
    gap = _fault_gap(params, cfg, rcfg, 1 if fault == "gate_from_q" else 3, monkeypatch, fault)
    assert gap > 100 * F32_ATOL and gap > BF16_ATOL, gap


def test_dropped_bias_fails_the_kernel_route(tiny):
    _, _, params, cfg, rcfg = tiny
    dropped = copy.deepcopy(params)
    dropped["rel_embed"] = dropped["rel_embed"] * 0
    gap = (_ours(dropped, cfg, 3, attention_impl="relpos_block") - _ref(params, rcfg, 3)).abs().max().item()
    assert gap > 5 * BF16_ATOL, gap


def test_converter_carries_the_gate_and_table(tiny, tmp_path, monkeypatch):
    """``convert_pretrained`` on a saved ``WavLMModel`` (offline): the
    relative-bias config, the gate leaves of every layer (the weight (hd, 8)
    transposed), layer 0's table, the weight norm folded; the same tree as
    ``convert_hf_hubert``."""
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setenv("TRANSFORMERS_OFFLINE", "1")
    model, _, params, cfg, _ = tiny
    model.save_pretrained(tmp_path)
    got, got_cfg = convert_hubert.convert_pretrained(str(tmp_path))
    assert got_cfg == cfg and cfg.relative_position_bias and (cfg.num_buckets, cfg.max_bucket_distance) == (16, 20)
    assert got["rel_embed"].shape == (16, 4) and "bn_scale" not in got["pos_conv"]
    sd = model.state_dict()
    for i, layer in enumerate(got["layers"]):
        assert layer["gate_w"].shape == (16, 8) and layer["gate_const"].shape == (4,)
        hf_gate = sd[f"encoder.layers.{i}.attention.gru_rel_pos_linear.weight"].numpy()
        np.testing.assert_array_equal(layer["gate_w"], hf_gate.T)
    for a, b in zip(convert_hubert._leaves(got), convert_hubert._leaves(params)):
        np.testing.assert_array_equal(a, b)


def test_init_params_layout():
    """A relative-bias config's ``init_params`` carries the gate leaves and
    the table; other configs' are as before, with no gate leaf."""
    cfg = hubert.HubertConfig(**{k: v for k, v in TINY.items()}, relative_position_bias=True)
    params = hubert.init_params(torch.Generator().manual_seed(0), cfg)
    assert params["rel_embed"].shape == (16, 4)
    assert {"gate_w", "gate_b", "gate_const"} <= set(params["layers"][0])
    assert params["layers"][0]["gate_w"].shape == (16, 8)
    plain = hubert.init_params(torch.Generator().manual_seed(0), hubert.HubertConfig())
    assert "rel_embed" not in plain and "gate_w" not in plain["layers"][0]
    assert hubert.WAVLM_LARGE_CONFIG.hidden_size // hubert.WAVLM_LARGE_CONFIG.num_attention_heads == 64


def test_routes_of_a_relative_bias_config(tiny):
    """On a card "auto" takes "relpos_block" at every length (799 frames,
    1500, past 40 000) at the default precision and "einsum" at "highest"
    and off the card; A9, A15 and the post-LN blocks raise, naming the
    reason; "relpos_block" is refused for a config without the bias."""
    _, _, params, cfg, _ = tiny
    metric = SpeechBERTScore(params=params, config=cfg, device="cpu")
    assert metric._resolve_impl(16 * 16000, 64) == "einsum"
    metric._on_cuda = lambda: True
    for samples in (16 * 16000, 1500 * 320, 41000 * 320):
        assert metric._resolve_impl(samples, 64) == "relpos_block"
    exact = SpeechBERTScore(params=params, config=cfg, device="cpu", precision="highest")
    exact._on_cuda = lambda: True
    assert exact._resolve_impl(16 * 16000, 64) == "einsum"
    for impl in ("sdpa", "flash", "block_ffn", "layer_block"):
        with pytest.raises(ValueError, match="no relative-position bias"):
            SpeechBERTScore(params=params, config=cfg, device="cpu", attention_impl=impl)._resolve_impl(16000, 2)
    small = hubert.HubertConfig(hidden_size=64, num_attention_heads=4, intermediate_size=128, conv_dim=(32, 32, 32),
                                conv_kernel=(10, 3, 3), conv_stride=(5, 2, 2), num_conv_pos_embeddings=16,
                                num_conv_pos_embedding_groups=4, num_hidden_layers=1)
    plain = SpeechBERTScore(params=hubert.init_params(torch.Generator().manual_seed(0), small), config=small,
                            device="cpu", attention_impl="relpos_block")
    with pytest.raises(ValueError, match="relative-bias"):
        plain._resolve_impl(16000, 2)


@pytest.mark.parametrize("dtype,want", [(torch.float32, {"conv0_ln_gelu": 1, "conv_ln_gelu": 6}),
                                        (torch.bfloat16, {})])
def test_wavlm_large_conv_encoder_reaches_the_ln_kernels(monkeypatch, dtype, want):
    """WavLM-Large's seven convs (512 channels; widths 10, 3, 3, 3, 3, 2, 2)
    with the card's rules pretended: conv 0 reaches ``conv0_ln_gelu`` and
    convs 1-6 ``conv_ln_gelu``, FE's plain epilogue none; the act_bf16
    control keeps every conv on ``F.conv1d`` and its passes. The wrappers'
    plain versions give the CPU path bit for bit."""
    cfg = dataclasses.replace(hubert.WAVLM_LARGE_CONFIG, hidden_size=64, num_hidden_layers=1, num_attention_heads=4,
                              intermediate_size=64, num_conv_pos_embedding_groups=4)
    enc = hubert.from_jax_params(hubert.init_params(torch.Generator().manual_seed(0), cfg), cfg)
    audio = AUDIO.to(dtype)
    want_out = hubert.feature_encoder(enc, audio, gelu="tanh")
    calls = {}
    for name in ("engages", "engages_ln", "engages_conv0_ln"):
        rule = getattr(conv_gelu, name)
        monkeypatch.setattr(conv_gelu, name, lambda device_type, *args, rule=rule: rule("cuda", *args))
    for name, stride in (("conv_gelu", None), ("conv_ln_gelu", 2), ("conv0_ln_gelu", 5)):
        def plain(x, w, *args, name=name, stride=stride, **_):
            calls[name] = calls.get(name, 0) + 1
            if stride is None:
                return conv_gelu._conv_gelu_plain(x, w, *args)
            return conv_gelu._conv_ln_gelu_plain(x, w, *args, stride)
        monkeypatch.setattr(conv_gelu, name, plain)
    got = hubert.feature_encoder(enc, audio, gelu="tanh")
    assert calls == want
    assert torch.equal(got, want_out)


def test_bias_counter_and_span(tiny):
    """While a profiler records, each layer of the plain route counts the
    gated bias it builds (rows x heads x T^2 floats) and opens the span
    ``fsem.hubert.relpos_attn``."""
    _, _, params, cfg, _ = tiny
    tracing.counts.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        ours = _ours(params, cfg, 2)
    frames = ours.shape[1]
    assert tracing.counts["relpos_bias_bytes"] == 2 * 2 * 4 * frames * frames * 4
    assert sum(e.name == "fsem.hubert.relpos_attn" for e in prof.events()) == 2
    tracing.counts.clear()


@pytest.mark.parametrize("softmax", ["exp2", "exact"])
def test_prenorm_layer_is_its_three_stages(tiny, softmax):
    """``prenorm_layer`` is ``prenorm_in``, ``relpos_attention`` and
    ``prenorm_out`` in turn (the card route's three launches), bit for bit
    on the CPU, where each stage is its plain version."""
    _, _, params, cfg, _ = tiny
    enc = hubert.from_jax_params(params, cfg)
    packed = enc.packed_prenorm(0, softmax)
    heads, eps = cfg.num_attention_heads, cfg.layer_norm_eps
    x = torch.from_numpy(np.random.RandomState(5).randn(2, 199, cfg.hidden_size).astype(np.float32))
    vec = relpos_attention.offset_bias(enc.rel_embed, 199, cfg.num_buckets, cfg.max_bucket_distance,
                                       1.0 if softmax == "exact" else relpos_attention.LOG2E)
    qkvg = relpos_attention.prenorm_in(x, packed, eps)
    assert torch.equal(qkvg, relpos_attention._prenorm_in_plain(x, packed, eps))
    ctx = relpos_attention.relpos_attention(qkvg, packed[2], vec, heads, softmax)
    out = relpos_attention.prenorm_out(x, ctx, packed, eps)
    assert torch.equal(out, relpos_attention._prenorm_out_plain(x, ctx, packed, eps, "tanh"))
    assert torch.equal(out, relpos_attention.prenorm_layer(x, packed, vec, heads, eps, softmax, "tanh"))


def test_prenorm_stages_raise_off_the_cpu_and_the_card(tiny):
    """A device with neither kernels nor plain versions raises, naming it."""
    _, _, params, cfg, _ = tiny
    packed = hubert.from_jax_params(params, cfg).packed_prenorm(0, "exp2")
    x = torch.empty(2, 8, cfg.hidden_size, device="meta")
    with pytest.raises(ValueError, match="no pre-LN layer kernels for device meta"):
        relpos_attention.prenorm_in(x, packed, cfg.layer_norm_eps)
    with pytest.raises(ValueError, match="no pre-LN layer kernels for device meta"):
        relpos_attention.prenorm_out(x, x.to(torch.bfloat16), packed, cfg.layer_norm_eps)

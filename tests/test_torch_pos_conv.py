"""PyTorch port, the positional conv stage's kernel (``ops/pos_conv.py``) on the CPU.

The kernel itself runs only on a card (``tests/test_torch_kernels_cuda.py``);
here: the rule by which the encoder takes it, the weights' pieces in the
layout the kernel reads, the kernel's arithmetic (its float64 twin) against
a float64 conv, and the encoder on the CPU, which keeps the plain path bit
for bit.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from fast_speech_enhancement_metrics_tpu_torch.models import hubert
from fast_speech_enhancement_metrics_tpu_torch.ops import numerics, pos_conv

# hidden 96 / 128 in 2 groups: 48 / 64 channels a group, the kernel's two
# instantiations, at the kernel's width of 128
CONFIGS = {
    48: hubert.HubertConfig(hidden_size=96, num_hidden_layers=1, num_attention_heads=4, intermediate_size=128,
                            conv_dim=(32, 32, 32), conv_kernel=(10, 3, 3), conv_stride=(5, 2, 2),
                            num_conv_pos_embedding_groups=2),
    64: hubert.HubertConfig(hidden_size=128, num_hidden_layers=1, num_attention_heads=4, intermediate_size=128,
                            conv_dim=(32, 32, 32), conv_kernel=(10, 3, 3), conv_stride=(5, 2, 2),
                            num_conv_pos_embedding_groups=2),
}
AUDIO = np.random.RandomState(1).randn(2, 16000).astype(np.float32)


def _encoder(cg, bn, seed=0):
    config = CONFIGS[cg]
    params = hubert.init_params(torch.Generator().manual_seed(seed), config)
    d = config.hidden_size
    rs = np.random.RandomState(seed + 5)
    params["pos_conv"]["b"] = (0.1 * rs.randn(d)).astype(np.float32)
    if bn:  # a batch-norm positional conv's pre-affine, as mHuBERT-147's
        params["pos_conv"]["bn_scale"] = (1 + 0.3 * rs.randn(d)).astype(np.float32)
        params["pos_conv"]["bn_shift"] = (0.3 * rs.randn(d)).astype(np.float32)
    return hubert.from_jax_params(params, config)


def _operands(cg, bn, t, groups=2, seed=0):
    rs = np.random.RandomState(seed)
    d = groups * cg
    x = torch.from_numpy(rs.randn(2, t, d).astype(np.float32))
    w = torch.from_numpy((rs.randn(d, cg, pos_conv.WIDTH) / np.sqrt(cg * pos_conv.WIDTH)).astype(np.float32))
    b = torch.from_numpy((0.1 * rs.randn(d)).astype(np.float32))
    scale = torch.from_numpy((1 + 0.3 * rs.randn(d)).astype(np.float32)) if bn else None
    shift = torch.from_numpy((0.3 * rs.randn(d)).astype(np.float32)) if bn else None
    return x, w, b, scale, shift


@pytest.mark.parametrize("device_type,dtype,stride,width,channels,groups,want", [
    ("cuda", torch.float32, 1, 128, 768, 16, True),  # mHuBERT-147, HuBERT base
    ("cuda", torch.float32, 1, 128, 1024, 16, True),  # HuBERT large, WavLM-Large
    ("cuda", torch.float32, 1, 128, 96, 2, True),
    ("cuda", torch.float32, 1, 128, 128, 2, True),
    ("cpu", torch.float32, 1, 128, 768, 16, False),
    ("meta", torch.float32, 1, 128, 768, 16, False),
    ("cuda", torch.bfloat16, 1, 128, 768, 16, False),  # act_dtype=bfloat16
    ("cuda", torch.float16, 1, 128, 768, 16, False),
    ("cuda", torch.float64, 1, 128, 768, 16, False),
    ("cuda", torch.float32, 2, 128, 768, 16, False),
    ("cuda", torch.float32, 1, 127, 768, 16, False),
    ("cuda", torch.float32, 1, 16, 64, 4, False),  # the small test config
    ("cuda", torch.float32, 1, 64, 768, 16, False),
    ("cuda", torch.float32, 1, 128, 512, 16, False),  # 32 a group
    ("cuda", torch.float32, 1, 128, 1280, 16, False),  # 80 a group
    ("cuda", torch.float32, 1, 128, 770, 16, False),  # not whole groups
    ("cuda", torch.float32, 1, 128, 768, 0, False),
])
def test_pos_conv_dispatch_rule(device_type, dtype, stride, width, channels, groups, want):
    """The kernel engages on what the call shows alone: a CUDA device,
    float32, stride 1, width 128, 48 or 64 channels a group."""
    assert pos_conv.engages(device_type, dtype, stride, width, channels, groups) is want


@pytest.mark.parametrize("cg", pos_conv.GROUP_CHANNELS)
def test_split_pieces_layout_and_sum(cg):
    """Piece q of w[g c_g + o, 8 p + e, j] at [g, j, q, p, o, e]; the pieces
    are the bf16 split of w (each the rest's bf16 rounding) and add up to w
    exactly."""
    groups, k = 3, pos_conv.WIDTH
    _, w, _, _, _ = _operands(cg, False, 8, groups=groups)
    pieces = pos_conv.split_pieces(w, groups)
    assert pieces.dtype == torch.bfloat16 and pieces.is_contiguous()
    assert tuple(pieces.shape) == (groups, k, 3, cg // 8, cg, 8)
    p = pieces.float()
    rs = np.random.RandomState(0)
    for _ in range(64):
        g, j, pp, o, e = (int(rs.randint(n)) for n in (groups, k, cg // 8, cg, 8))
        v = w[g * cg + o, 8 * pp + e, j]
        rest = v
        for q in range(3):
            assert p[g, j, q, pp, o, e] == rest.to(torch.bfloat16).float()
            rest = rest - p[g, j, q, pp, o, e]
    # every element: the three pieces sum to w exactly
    total = (p[:, :, 0] + p[:, :, 1]) + p[:, :, 2]  # (g, j, p, o, e)
    want = w.reshape(groups, cg, cg // 8, 8, k).permute(0, 4, 2, 1, 3)
    assert torch.equal(total, want)


def _want64(x, w, b, groups, scale, shift):
    """The stage in float64 from the float32 BN input, and the magnitudes
    of the conv's products, the float32 class's scale."""
    pos_in = x if scale is None else x * scale + shift
    k = w.shape[2]
    conv = F.conv1d(pos_in.double().transpose(1, 2), w.double(), padding=k // 2, groups=groups)
    mag = F.conv1d(pos_in.double().abs().transpose(1, 2), w.double().abs(), padding=k // 2, groups=groups)
    conv, mag = conv.transpose(1, 2)[:, :-1], mag.transpose(1, 2)[:, :-1]
    return x.double() + F.gelu(conv + b.double()), mag


@pytest.mark.parametrize("t", [37, 38])
@pytest.mark.parametrize("bn", [False, True])
@pytest.mark.parametrize("cg", pos_conv.GROUP_CHANNELS)
def test_pos_conv_pieces_arithmetic_is_float32_class(cg, bn, t):
    """The kernel's arithmetic (pieces, six products, 16-channel partials,
    BN, bias, erf GELU, residual, the even width's trim), its float64 twin,
    against a float64 conv: within float32 rounding of the products'
    magnitudes, as the plain float32 path (F.conv1d) is."""
    x, w, b, scale, shift = _operands(cg, bn, t)
    want, mag = _want64(x, w, b, 2, scale, shift)
    # float32 rounding of the output and of the running sum of 128 c_g / 16
    # partials (each within 2^-24 of its value), at the products' magnitudes
    limit = 2.0**-24 * (4 * want.abs() + 2 * mag)
    got = pos_conv._pos_conv_pieces_reference(x, w, b, 2, scale, shift)
    assert got.shape == x.shape and got.dtype == torch.float32
    assert bool(torch.all((got.double() - want).abs() <= limit))
    plain = pos_conv.pos_conv(x, w, b, 2, scale, shift)  # the CPU takes the plain version
    assert plain.shape == x.shape and bool(torch.all((plain.double() - want).abs() <= limit))


def _pos_stage_before_kernel(enc, x):
    """``hubert_hidden_state``'s positional conv stage as it was before the
    kernel: BN affine, F.conv1d over transposed views, the trim, + b, the
    exact GELU, + x."""
    config, pc = enc.config, enc.pos_conv
    pos_in = x
    if "bn_scale" in pc:
        pos_in = x * pc["bn_scale"] + pc["bn_shift"]
    with hubert._conv_flags():
        pos = F.conv1d(pos_in.transpose(1, 2), pc["w"], padding=config.num_conv_pos_embeddings // 2,
                       groups=config.num_conv_pos_embedding_groups).transpose(1, 2)
    if config.num_conv_pos_embeddings % 2 == 0:
        pos = pos[:, :-1, :]
    return x + F.gelu(pos + pc["b"])


def _stage_input(enc, audio):
    fp, config = enc.feature_projection, enc.config
    x = hubert.feature_encoder(enc, audio)
    x = numerics.layer_norm(x, fp["ln_s"], fp["ln_b"], config.layer_norm_eps)
    return torch.matmul(x, fp["w"]) + fp["b"]


@pytest.mark.parametrize("bn", [False, True])
@pytest.mark.parametrize("cg", pos_conv.GROUP_CHANNELS)
def test_hidden_state_on_cpu_is_the_pre_kernel_path(cg, bn):
    """On the CPU the encoder keeps the plain steps: its output before the
    layers equals the stage as it was, bit for bit."""
    enc = _encoder(cg, bn)
    audio = torch.from_numpy(AUDIO)
    enc_ln, config = enc.encoder_ln, enc.config
    want = numerics.layer_norm(_pos_stage_before_kernel(enc, _stage_input(enc, audio)), enc_ln["s"], enc_ln["b"],
                               config.layer_norm_eps)
    assert torch.equal(hubert.hubert_hidden_state(enc, audio, output_layer=0), want)


@pytest.mark.parametrize("dtype,routed", [(torch.float32, 1), (torch.bfloat16, 0)])
def test_hidden_state_routes_the_stage(monkeypatch, dtype, routed):
    """With the device check pretended away, the encoder sends the stage to
    ``pos_conv`` with its cached pieces and BN vectors in float32, and
    keeps the plain steps in bf16 activations."""
    enc = _encoder(48, True)
    rule, calls = pos_conv.engages, []

    def on_card(device_type, *args):
        return rule("cuda", *args)

    def plain(x, w, b, groups, bn_scale=None, bn_shift=None, pieces=None):
        calls.append((pieces, bn_scale, bn_shift, groups))
        return pos_conv._pos_conv_plain(x, w, b, groups, bn_scale, bn_shift)

    audio = torch.from_numpy(AUDIO)
    want = hubert.hubert_hidden_state(enc, audio, output_layer=1, act_dtype=dtype)
    monkeypatch.setattr(pos_conv, "engages", on_card)
    monkeypatch.setattr(pos_conv, "pos_conv", plain)
    got = hubert.hubert_hidden_state(enc, audio, output_layer=1, act_dtype=dtype)
    assert len(calls) == routed
    pc = enc.pos_conv
    assert all(p is enc.pos_pieces() and s is pc["bn_scale"] and h is pc["bn_shift"] and g == 2
               for p, s, h, g in calls)
    assert torch.equal(got, want)


def test_pos_pieces_are_cached():
    enc = _encoder(64, False)
    pieces = enc.pos_pieces()
    assert tuple(pieces.shape) == (2, 128, 3, 8, 64, 8)
    assert torch.equal(pieces, pos_conv.split_pieces(enc.pos_conv["w"], 2))
    assert enc.pos_pieces() is pieces
    enc.float()  # moving or casting the module drops the cache
    assert enc.pos_pieces() is not pieces


def test_pos_conv_takes_bn_vectors_together():
    x, w, b, scale, _ = _operands(48, True, 9)
    with pytest.raises(ValueError, match="together"):
        pos_conv.pos_conv(x, w, b, 2, bn_scale=scale)

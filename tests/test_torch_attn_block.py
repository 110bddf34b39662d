"""PyTorch port, kernels A7 (attention block), A8 (FFN block), A11 (the whole
layer) and A12 (int8 attention block): their plain versions against the
JAX package's Pallas kernels in interpret mode.

Both sides emulate the same bf16 roundings with fp32 accumulation, so A7,
A8 and A11 agree far inside the block's bf16 class: max abs 1e-2, median
abs 1e-4. A12 is held at the bf16 class itself (max 3e-2, median 1e-3):
its integer products are exact on both sides, but a probability that
rounds to the other side of a .5 step of 127 pn moves one int8 value. The
packing's q-scale fold must match the JAX packing exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_speech_enhancement_metrics_tpu.ops import attn_block_pallas as jax_blocks
from fast_speech_enhancement_metrics_tpu_torch.ops import attn_block_pallas, numerics

D, HEADS, FFN, T = 64, 4, 256, 43  # T deliberately not a multiple of 8 or 16


#: (d, heads) of the parity cases: heads of 16, 80 (HuBERT-xlarge's width)
#: and 12 (not a multiple of 8 or 16: the kernels' zero-padded paths)
WIDTHS = [(64, 4), (160, 2), (48, 4)]


def _params(seed=7, d=D):
    rs = np.random.RandomState(seed)
    p = {k: rs.randn(d, d) * 0.1 for k in ("q_w", "k_w", "v_w", "o_w")}
    p.update({k: rs.randn(d) * 0.1 for k in ("q_b", "k_b", "v_b", "o_b", "ff_b2")})
    p.update(ff_w1=rs.randn(d, FFN) * 0.1, ff_b1=rs.randn(FFN) * 0.1, ff_w2=rs.randn(FFN, d) * 0.1,
             ln1_s=1 + 0.1 * rs.randn(d), ln1_b=0.1 * rs.randn(d),
             ln2_s=1 + 0.1 * rs.randn(d), ln2_b=0.1 * rs.randn(d))
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = (np.random.RandomState(seed + 1).randn(2, T, d) * 0.5).astype(np.float32)
    return p, x


def _close(ours, theirs):
    diff = np.abs(np.asarray(ours, dtype=np.float32) - np.asarray(theirs, dtype=np.float32))
    assert diff.max() <= 1e-2 and np.median(diff) <= 1e-4, (diff.max(), np.median(diff))


@pytest.mark.parametrize("softmax", ["exp2", "exact", "exp2_bf16"])
def test_attn_block_plain_matches_pallas(softmax):
    p, x = _params()
    theirs = jax_blocks.attn_block({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                                   HEADS, 1e-5, softmax=softmax, interpret=True)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    packed = attn_block_pallas.pack_attn_block_params(tp, HEADS, softmax)
    ours = attn_block_pallas.attn_block(torch.from_numpy(x), packed, HEADS, 1e-5, softmax=softmax)
    assert ours.dtype == torch.float32 and ours.shape == x.shape
    _close(ours.numpy(), theirs)


@pytest.mark.parametrize("gelu", ["tanh", "erf"])
def test_ffn_block_plain_matches_pallas(gelu):
    p, x = _params(seed=9)
    theirs = jax_blocks.ffn_block({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                                  1e-5, gelu=gelu, interpret=True)
    packed = attn_block_pallas.pack_ffn_block_params({k: torch.from_numpy(v) for k, v in p.items()})
    ours = attn_block_pallas.ffn_block(torch.from_numpy(x), packed, 1e-5, gelu=gelu)
    _close(ours.numpy(), theirs)


def test_bf16_input_keeps_dtype():
    """A bf16 activation stream stays bf16 through both blocks."""
    p, x = _params(seed=3)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    xb = torch.from_numpy(x).to(torch.bfloat16)
    y = attn_block_pallas.attn_block(xb, attn_block_pallas.pack_attn_block_params(tp, HEADS, "exp2"), HEADS, 1e-5)
    y = attn_block_pallas.ffn_block(y, attn_block_pallas.pack_ffn_block_params(tp), 1e-5)
    assert y.dtype == torch.bfloat16 and torch.isfinite(y.float()).all()


@pytest.mark.parametrize("softmax", ["exp2", "exact"])
def test_packing_folds_the_q_scale_like_jax(softmax):
    """Same fp32 fold of the attention scale (and log2 e) into q before the
    bf16 cast; the JAX packing interleaves heads as [q|k|v] per head, the
    port keeps [q heads | k heads | v heads]."""
    p, _ = _params()
    wqkv_j, bqkv_j, wo_j, bo_j, lns_j, lnb_j = (
        np.asarray(a.astype(jnp.float32)) for a in
        jax_blocks.pack_attn_block_params({k: jnp.asarray(v) for k, v in p.items()}, HEADS, softmax)
    )
    packed = attn_block_pallas.pack_attn_block_params({k: torch.from_numpy(v) for k, v in p.items()}, HEADS, softmax)
    wqkv, bqkv, wo, bo, lns, lnb = (a.float().numpy() for a in packed)
    hd = D // HEADS
    # JAX column of (part, head, i) is head * 3 hd + part * hd + i
    order = [h * 3 * hd + part * hd + i for part in range(3) for h in range(HEADS) for i in range(hd)]
    np.testing.assert_array_equal(wqkv, wqkv_j[:, order])
    np.testing.assert_array_equal(bqkv, bqkv_j[0, order])
    for ours, theirs in ((wo, wo_j), (bo, bo_j[0]), (lns, lns_j[0]), (lnb, lnb_j[0])):
        np.testing.assert_array_equal(ours, theirs)


def test_block_wrappers_reject_other_devices():
    p, x = _params()
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    meta = torch.zeros(2, T, D, device="meta")
    with pytest.raises(ValueError, match="device"):
        attn_block_pallas.attn_block(meta, attn_block_pallas.pack_attn_block_params(tp, HEADS, "exp2"), HEADS, 1e-5)
    with pytest.raises(ValueError, match="device"):
        attn_block_pallas.ffn_block(meta, attn_block_pallas.pack_ffn_block_params(tp), 1e-5)
    with pytest.raises(ValueError, match="softmax"):
        attn_block_pallas.pack_attn_block_params(tp, HEADS, "exp")
    with pytest.raises(ValueError, match="device"):
        attn_block_pallas.layer_block(meta, attn_block_pallas.pack_attn_block_params(tp, HEADS, "exp2"),
                                      attn_block_pallas.pack_ffn_block_params(tp), HEADS, 1e-5)
    with pytest.raises(ValueError, match="quant"):
        attn_block_pallas.pack_attn_block_params(tp, HEADS, "exp2", quant="int4")


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_block_input_check_rejects_a_misaligned_view(x_dtype):
    """The kernels read x in 16-byte vectors and through TMA: a contiguous
    view that starts off a 16-byte boundary is refused before any launch."""
    p, _ = _params()
    packed = attn_block_pallas.pack_ffn_block_params({k: torch.from_numpy(v) for k, v in p.items()})
    flat = torch.zeros(2 * T * D + 1, dtype=x_dtype)
    attn_block_pallas._check_block_input(flat[:-1].view(2, T, D), packed)
    with pytest.raises(ValueError, match="aligned"):
        attn_block_pallas._check_block_input(flat[1:].view(2, T, D), packed)


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_gemm_plain_composes_the_ffn_block(x_dtype):
    """The GEMM's plain version is A8's two products: W_1 with the tanh GELU
    rounded to bf16, then W_2 in fp32; with the residual LayerNorm they give
    the FFN block's plain version bit for bit (and so, through it, the JAX
    kernel's function)."""
    p, x = _params(seed=11)
    w1, b1, w2, b2, lns, lnb = attn_block_pallas.pack_ffn_block_params({k: torch.from_numpy(v) for k, v in p.items()})
    x = torch.from_numpy(x).to(x_dtype)
    xb = x.to(torch.bfloat16).reshape(-1, D)
    hidden = attn_block_pallas.gemm(xb, w1, b1, "gelu_bf16")
    y = attn_block_pallas.gemm(hidden, w2, b2, "f32")
    assert hidden.dtype == torch.bfloat16 and y.dtype == torch.float32 and y.shape == (2 * T, D)
    got = numerics.layer_norm(y + xb.float(), lns, lnb, 1e-5).reshape(x.shape).to(x_dtype)
    assert torch.equal(got, attn_block_pallas.ffn_block(x, (w1, b1, w2, b2, lns, lnb), 1e-5))
    with pytest.raises(ValueError, match="epilogue"):
        attn_block_pallas.gemm(xb, w1, b1, "gelu")


@pytest.mark.parametrize("d,heads", WIDTHS)
@pytest.mark.parametrize("softmax", ["exp2", "exact"])
def test_layer_block_plain_matches_pallas(softmax, d, heads):
    """A11's plain version against the JAX whole-layer kernel, at every
    head-width class the card's A11 takes."""
    p, x = _params(seed=13, d=d)
    theirs = jax_blocks.layer_block({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), heads, 1e-5,
                                    softmax=softmax, gelu="tanh", interpret=True)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    ours = attn_block_pallas.layer_block(torch.from_numpy(x), attn_block_pallas.pack_attn_block_params(tp, heads, softmax),
                                         attn_block_pallas.pack_ffn_block_params(tp), heads, 1e-5, softmax, "tanh")
    assert ours.dtype == torch.float32 and ours.shape == x.shape
    _close(ours.numpy(), theirs)


def _bf16_class(ours, theirs):
    diff = np.abs(np.asarray(ours, dtype=np.float32) - np.asarray(theirs, dtype=np.float32))
    assert diff.max() <= 3e-2 and np.median(diff) <= 1e-3, (diff.max(), np.median(diff))


@pytest.mark.parametrize("d,heads", WIDTHS)
@pytest.mark.parametrize("softmax", ["exp2", "exact", "exp2_bf16"])
def test_attn_block_int8_plain_matches_pallas(softmax, d, heads, monkeypatch):
    """A12's plain version against the JAX kernel with ``quant="int8"``, at
    heads of 16, 80 and 12, in the bf16 class.

    In exp2_bf16 the interpret kernel keeps the bf16 exponential in fp32
    (XLA's excess precision: ``p / l`` reads the exponential before its
    bf16 rounding). At heads of 80 that alone moves the block 4.6e-2, so
    there the port as it is is held in the JAX package's int8 screening
    class (max 0.5, median 0.05), and in addition, with that rounding
    dropped as the reference computes, in the bf16 class."""
    p, x = _params(seed=21, d=d)
    theirs = jax_blocks.attn_block({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), heads, 1e-5,
                                   softmax=softmax, interpret=True, quant="int8")
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    packed = attn_block_pallas.pack_attn_block_params(tp, heads, softmax, quant="int8")

    def ours():
        out = attn_block_pallas.attn_block(torch.from_numpy(x), packed, heads, 1e-5, softmax, quant="int8")
        assert out.dtype == torch.float32 and out.shape == x.shape
        return out.numpy()

    if softmax != "exp2_bf16" or (d, heads) != (160, 2):
        _bf16_class(ours(), theirs)
        return
    diff = np.abs(ours() - np.asarray(theirs, dtype=np.float32))
    assert diff.max() < 0.5 and np.median(diff) < 0.05, (diff.max(), np.median(diff))
    monkeypatch.setattr(numerics, "exp2_bf16", lambda s: torch.exp(
        numerics.round_bf16(numerics.round_bf16(s) * numerics.LN2_BF16)))
    _bf16_class(ours(), theirs)


def test_int8_packing_quantizes_the_fp32_fold_like_jax():
    p, _ = _params()
    wq_j, bq_j, wo_j, bo_j, _, _ = (np.asarray(a).astype(np.float32) for a in jax_blocks.pack_attn_block_params(
        {k: jnp.asarray(v) for k, v in p.items()}, HEADS, "exp2", quant="int8"))
    wq, bq, wo, bo, _, _ = (a.float().numpy() for a in attn_block_pallas.pack_attn_block_params(
        {k: torch.from_numpy(v) for k, v in p.items()}, HEADS, "exp2", quant="int8"))
    hd = D // HEADS
    order = [h * 3 * hd + part * hd + i for part in range(3) for h in range(HEADS) for i in range(hd)]
    np.testing.assert_array_equal(wq, wq_j[:, order].T)
    np.testing.assert_array_equal(bq, bq_j[:, order])
    np.testing.assert_array_equal(wo, wo_j.T)
    np.testing.assert_array_equal(bo, bo_j)


def test_int8_v_scale_covers_the_padded_rows(monkeypatch):
    """T = 43 (the JAX kernel pads 5 zero rows, whose v is b_v) with every
    real key's v near 0.1 b_v: v's column scale comes from |b_v|, and the
    plain version agrees with JAX only with that term."""
    rs = np.random.RandomState(5)
    p, _ = _params(seed=5)
    a = (0.5 * rs.randn(D)).astype(np.float32)
    p["v_b"] = (3.0 * rs.randn(D)).astype(np.float32)
    p["v_w"] = np.outer(a, -0.9 * p["v_b"] / np.dot(a, a)).astype(np.float32)
    x = np.broadcast_to(a, (2, T, D)).copy()
    theirs = jax_blocks.attn_block({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), HEADS, 1e-5,
                                   softmax="exp2", interpret=True, quant="int8")
    packed = attn_block_pallas.pack_attn_block_params({k: torch.from_numpy(v) for k, v in p.items()}, HEADS,
                                                      "exp2", quant="int8")

    def ours():
        return attn_block_pallas.attn_block(torch.from_numpy(x), packed, HEADS, 1e-5, "exp2", quant="int8").numpy()

    _bf16_class(ours(), theirs)
    monkeypatch.setattr(attn_block_pallas, "_v_scales", lambda v, b_v, t: torch.clamp(
        torch.amax(torch.abs(v), dim=-2, keepdim=True) / 127.0, min=1e-12))
    with pytest.raises(AssertionError):
        _bf16_class(ours(), theirs)


def test_gemm_i8_plain_is_the_int8_blocks_product():
    """The int8 GEMM's plain version gives the QKV projection of A12's plain
    version bit for bit: the quantized x, the int8 weights, ((acc sx) sw) + b
    in fp32. Off the card and the CPU its wrapper raises."""
    p, x = _params(seed=23)
    wq_t, bq2, _, _, _, _ = attn_block_pallas.pack_attn_block_params(
        {k: torch.from_numpy(v) for k, v in p.items()}, HEADS, "exp2", quant="int8")
    xq, sx = attn_block_pallas._quant_rows(attn_block_pallas.round_bf16(torch.from_numpy(x)))
    xq, sx = xq.reshape(-1, D).to(torch.int8), sx.reshape(-1)
    got = attn_block_pallas.gemm_i8(xq, wq_t, sx, bq2[1].contiguous(), bq2[0].contiguous())
    want = attn_block_pallas._dot_i8(xq.float(), wq_t.t().float()) * sx[:, None] * bq2[1] + bq2[0]
    assert got.dtype == torch.float32 and got.shape == (2 * T, 3 * D)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="device"):
        attn_block_pallas.gemm_i8(xq.to("meta"), wq_t, sx, bq2[1], bq2[0])


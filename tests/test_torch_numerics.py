"""PyTorch port, the float32 class's split (``ops/numerics.py::split3``) and the layouts built on it.

One three-piece split serves every bf16x6 kernel's operands: its pieces are
bf16 and add up to x exactly in float32, and the conv, positional conv,
attention and LSD split passes lay out those pieces as each kernel reads
them (the latter two on the CPU, where their plain versions run).

This file imports no JAX, so it runs without tests/conftest.py.
"""

import numpy as np
import pytest
import torch

from fast_speech_enhancement_metrics_tpu_torch.ops import conv_gelu, lsd_fused, numerics, pos_conv, sdpa_pallas


def _values(shape, seed):
    """float32 values whose pieces are all normal: binary exponents -60 .. 60."""
    rs = np.random.RandomState(seed)
    x = rs.choice([-1.0, 1.0], shape) * rs.uniform(1.0, 2.0, shape) * np.exp2(rs.randint(-60, 60, shape))
    return torch.from_numpy(x.astype(np.float32))


def _bits(t: torch.Tensor) -> np.ndarray:
    """The bf16 pieces as float32 numpy values (exact)."""
    return t.float().numpy()


@pytest.mark.parametrize("shape", [(7,), (3, 50, 16), (2, 3, 5, 80)])
def test_split3_pieces_are_bf16_and_sum_exactly(shape):
    x = _values(shape, len(shape))
    x0, x1, x2 = numerics.split3(x)
    assert all(p.dtype == torch.bfloat16 and p.shape == x.shape for p in (x0, x1, x2))
    assert torch.equal(x0, x.to(torch.bfloat16))
    assert torch.equal(x1, (x - x0.float()).to(torch.bfloat16))
    assert torch.equal((x0.float() + x1.float()) + x2.float(), x)
    assert torch.all(x1.float().abs() <= 2.0**-8 * x0.float().abs())
    assert torch.all(x2.float().abs() <= 2.0**-8 * x1.float().abs())


def test_conv_gelu_pieces_layout():
    """(C_out, C_in, k) -> (3, k, C_out, C_in): piece q of w[o, c, j] at [q, j, o, c]."""
    w = _values((8, 6, 3), 1)
    pieces = [_bits(p) for p in numerics.split3(w)]
    got = conv_gelu.split_pieces(w)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (3, 3, 8, 6)
    want = np.zeros((3, 3, 8, 6), np.float32)
    for q in range(3):
        for o in range(8):
            for c in range(6):
                for j in range(3):
                    want[q, j, o, c] = pieces[q][o, c, j]
    np.testing.assert_array_equal(_bits(got), want)


def test_pos_conv_pieces_layout():
    """(C, c_g, k) in g groups -> (g, k, 3, c_g / 8, c_g, 8): piece q of
    w[g c_g + o, 8 p + e, j] at [g, j, q, p, o, e]."""
    groups, cg, k = 2, 16, 4
    w = _values((groups * cg, cg, k), 2)
    pieces = [_bits(p) for p in numerics.split3(w)]
    got = pos_conv.split_pieces(w, groups)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (groups, k, 3, cg // 8, cg, 8)
    want = np.zeros((groups, k, 3, cg // 8, cg, 8), np.float32)
    for g in range(groups):
        for j in range(k):
            for q in range(3):
                for p in range(cg // 8):
                    for o in range(cg):
                        for e in range(8):
                            want[g, j, q, p, o, e] = pieces[q][g * cg + o, 8 * p + e, j]
    np.testing.assert_array_equal(_bits(got), want)


@pytest.mark.parametrize("d", [20, 64, 80])
def test_sdpa_split_pieces_layout(d):
    """q, k, v (B, H, T, D) -> (3 tensors, 3 pieces, B H T, D_p): piece q of
    tensor i's row r at [i, q, r, :D], zeros past D, D_p 64 or 128."""
    qkv = [_values((2, 3, 5, d), 10 + i) for i in range(3)]
    got = sdpa_pallas.split_pieces(*qkv)
    d_p = 64 if d <= 64 else 128
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (3, 3, 30, d_p)
    want = np.zeros((3, 3, 30, d_p), np.float32)
    for i, x in enumerate(qkv):
        for q, piece in enumerate(numerics.split3(x)):
            rows = _bits(piece).reshape(30, d)
            for r in range(30):
                want[i, q, r, :d] = rows[r]
    np.testing.assert_array_equal(_bits(got), want)


def test_lsd_split_pieces_layout():
    """clean, denoised (B, T) -> (6, B, row_len): the planes [c0, c1, c2,
    d0, d1, d2], zeros past T; no scale partials without ``eps``."""
    c, d = _values((2, 300), 20), _values((2, 300), 21)
    got, partial = lsd_fused.split_pieces(c, d, 304)
    assert partial is None
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (6, 2, 304)
    want = np.zeros((6, 2, 304), np.float32)
    for s, x in enumerate((c, d)):
        for q, piece in enumerate(numerics.split3(x)):
            want[3 * s + q, :, :300] = _bits(piece)
    np.testing.assert_array_equal(_bits(got), want)


def test_products_are_the_six_of_order_at_most_two_small_terms_first():
    assert sorted(numerics.PRODUCTS) == sorted((a, b) for a in range(3) for b in range(3) if a + b <= 2)
    assert [a + b for a, b in numerics.PRODUCTS] == [2, 2, 2, 1, 1, 0]

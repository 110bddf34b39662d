"""PyTorch port, long-audio attention: kernels A9 (sdpa) and A15 (flash_sdpa),
their plain versions on the CPU.

A9's plain version against the JAX package's ``sdpa`` in interpret mode,
at T in {70, 128, 259} (below, at and above one 128-key pad quantum) and
heads of 16, 64 and 80, in all three softmax modes: float32 atol 2e-6,
bf16 the block tests' bf16 class (max 3e-2, median 1e-3) per query row,
each error over its row's max|want| (an attention context is far below
the ~1 of a LayerNorm output in most rows). A15's plain version (the
upstream flash kernel's online softmax; the JAX kernel itself runs only on
a TPU) against a float64 softmax of the same inputs at the same
tolerances.

The float32 arm's dataflow (``_sdpa_f32_pieces_reference``: q, k, v and p
split in three bf16 pieces, each product the six piece products of order
<= 2) against the same JAX kernel at 2e-6 in the three modes, and against
a float64 softmax at 5e-7 (the float32 plain version reaches 3.9e-7 there)
in "exact", "exp2" and the online mode, at T in {37, 259, 1100} and heads
of 16, 64 and 80; its online mode also against A15's plain version on
query slices. In ``exp2_bf16`` each logit is rounded to bf16, a step
function: where two float32 sums of one logit straddle a step, p differs
by a bf16 step, so that mode is held at 2e-6 plus
``_exp2_bf16_tie_allowance`` (0 in rows with no logit within round-off of
a step).

One seam: ``exp2_bf16`` is ``jnp.exp2`` of a bf16 array, whose value is a
bf16 (op by op, the port's function bit for bit, tested below). Inside a
jitted graph, as the interpret-mode kernel runs, XLA on the CPU may keep
that exponential in float32 and never round it (excess precision). So the
float32 ``exp2_bf16`` cases hold the port at 2e-6 against the JAX kernel run
in a subprocess with ``XLA_FLAGS=--xla_allow_excess_precision=false``, which
makes XLA round it as the op does.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_speech_enhancement_metrics_tpu.ops import sdpa_pallas as jax_sdpa
from fast_speech_enhancement_metrics_tpu_torch.ops import numerics, sdpa_pallas

CASES = [(70, 16), (128, 64), (259, 80), (259, 16), (70, 80)]
#: the float32 arm's dataflow: T under one 64-key tile, ragged, and many tiles
TWIN_CASES = [(t, d) for t in (37, 259, 1100) for d in (16, 64, 80)]
TWIN_SEED = 4


def _qkv(t, d, seed=0, b=1, h=2):
    rs = np.random.RandomState(seed)
    return [(0.8 * rs.randn(b, h, t, d)).astype(np.float32) for _ in range(3)]


def _bf16_class(got, want):
    """Per query row: each error over its row's max|want| (see the module docstring)."""
    want = np.asarray(want, np.float32)
    rel = np.abs(np.asarray(got, np.float32) - want) / np.abs(want).max(-1, keepdims=True)
    assert rel.max() <= 3e-2 and np.median(rel) <= 1e-3, (rel.max(), np.median(rel))


_STRICT_JAX = """
import sys
import numpy as np
import jax.numpy as jnp
from fast_speech_enhancement_metrics_tpu.ops.sdpa_pallas import sdpa
inputs = np.load(sys.argv[1])
out = {}
for i in range(len(inputs.files) // 3):
    q, k, v = (jnp.asarray(inputs[f"{n}{i}"]) for n in "qkv")
    out[f"o{i}"] = np.asarray(sdpa(q, k, v, q.shape[-1] ** -0.5, interpret=True, softmax="exp2_bf16"))
np.savez(sys.argv[2], **out)
"""


def _strict_exp2_bf16(tmp, cases, seed):
    """The JAX kernel's float32 exp2_bf16 outputs for every case of
    ``cases`` (inputs ``_qkv(t, d, seed)``), with XLA's excess precision off
    (see the module docstring)."""
    np.savez(tmp / "in.npz",
             **{f"{n}{i}": a for i, (t, d) in enumerate(cases) for n, a in zip("qkv", _qkv(t, d, seed))})
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"{os.environ.get('XLA_FLAGS', '')} --xla_allow_excess_precision=false".strip(),
               PYTHONPATH=os.pathsep.join(filter(None, [str(root), os.environ.get("PYTHONPATH")])))
    subprocess.run([sys.executable, "-c", _STRICT_JAX, str(tmp / "in.npz"), str(tmp / "out.npz")],
                   cwd=root, env=env, check=True, timeout=600)
    out = np.load(tmp / "out.npz")
    return {case: out[f"o{i}"] for i, case in enumerate(cases)}


@pytest.fixture(scope="module")
def strict_exp2_bf16(tmp_path_factory):
    return _strict_exp2_bf16(tmp_path_factory.mktemp("strict_sdpa"), CASES, 0)


@pytest.fixture(scope="module")
def strict_exp2_bf16_twin(tmp_path_factory):
    return _strict_exp2_bf16(tmp_path_factory.mktemp("strict_sdpa_twin"), TWIN_CASES, TWIN_SEED)


@pytest.mark.parametrize("softmax", ["exact", "exp2", "exp2_bf16"])
@pytest.mark.parametrize("t,d", CASES)
def test_sdpa_plain_matches_pallas_float32(t, d, softmax, strict_exp2_bf16):
    q, k, v = _qkv(t, d)
    scaling = d**-0.5
    if softmax == "exp2_bf16":  # see the module docstring
        theirs = strict_exp2_bf16[(t, d)]
    else:
        theirs = jax_sdpa.sdpa(*(jnp.asarray(a) for a in (q, k, v)), scaling, interpret=True, softmax=softmax)
    ours = sdpa_pallas.sdpa(*(torch.from_numpy(a) for a in (q, k, v)), scaling, softmax=softmax)
    assert ours.dtype == torch.float32 and ours.shape == q.shape
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=2e-6, rtol=0)


def test_exp2_bf16_is_jnp_exp2_of_bf16():
    x = np.linspace(-100.0, 60.0, 40001).astype(np.float32)
    want = np.asarray(jnp.exp2(jnp.asarray(x).astype(jnp.bfloat16)).astype(jnp.float32))
    np.testing.assert_array_equal(numerics.softmax_p(torch.from_numpy(x)[None], "exp2_bf16")[0].numpy(), want)


@pytest.mark.parametrize("softmax", ["exact", "exp2", "exp2_bf16"])
@pytest.mark.parametrize("t,d", CASES[:3])
def test_sdpa_plain_matches_pallas_bf16(t, d, softmax):
    q, k, v = _qkv(t, d, seed=1)
    scaling = d**-0.5
    theirs = jax_sdpa.sdpa(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), scaling, interpret=True,
                           softmax=softmax)
    ours = sdpa_pallas.sdpa(*(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)), scaling,
                            softmax=softmax)
    assert ours.dtype == torch.bfloat16
    _bf16_class(ours.float().numpy(), np.asarray(theirs.astype(jnp.float32)))


def test_bf16_class_per_row_catches_one_bad_query_tile():
    """Why the class holds per query row: a 4 % rescale of one head's last
    64 queries passes the absolute bf16 class (the rows that fix on one key
    reach max|v|, most rows are far smaller) and fails the per-row one."""
    g = torch.Generator().manual_seed(7)
    q, k, v = ((torch.randn(1, 4, 1300, 64, generator=g) * 1.2).to(torch.bfloat16) for _ in range(3))
    want = sdpa_pallas._sdpa_plain(q, k, v, 0.125, "exp2").float()
    bad = want.clone()
    bad[0, 2, -64:] *= 1.04
    bad = bad.to(torch.bfloat16).float()
    diff = (bad - want).abs()
    assert diff.max() <= 3e-2 and diff.median() <= 1e-3
    with pytest.raises(AssertionError):
        _bf16_class(bad.numpy(), want.numpy())
    _bf16_class(want.to(torch.bfloat16).float().numpy(), want.numpy())


def test_sdpa_scales_q_in_its_dtype():
    """In bf16 the scale itself rounds to bf16 (0.125 log2 e -> 0.1806640625)
    before the product, as the JAX wrapper's ``q * jnp.asarray(scaling, q.dtype)``."""
    q = torch.ones(1, 1, 1, 64, dtype=torch.bfloat16)
    assert sdpa_pallas._scaled_q(q, 0.125, "exp2")[0, 0, 0, 0].item() == 0.1806640625
    assert sdpa_pallas._scaled_q(q.float(), 0.125, "exact")[0, 0, 0, 0].item() == 0.125


def _softmax64(q, k, v, scaling):
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64), k.astype(np.float64)) * scaling
    p = np.exp(s - s.max(-1, keepdims=True))
    return np.einsum("bhqk,bhkd->bhqd", p / p.sum(-1, keepdims=True), v.astype(np.float64))


@pytest.mark.parametrize("t,d", [(70, 16), (259, 64), (700, 80)])
def test_flash_plain_matches_float64_softmax(t, d):
    q, k, v = _qkv(t, d, seed=2)
    scaling = d**-0.5
    want = _softmax64(q, k, v, scaling)
    ours = sdpa_pallas.flash_sdpa(*(torch.from_numpy(a) for a in (q, k, v)), scaling)
    np.testing.assert_allclose(ours.numpy(), want, atol=2e-6, rtol=0)
    qkv_bf16 = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    half = sdpa_pallas.flash_sdpa(*qkv_bf16, scaling)
    assert half.dtype == torch.bfloat16
    _bf16_class(half.float().numpy(), _softmax64(*(a.float().numpy() for a in qkv_bf16), scaling))


def test_flash_plain_on_a_query_slice():
    """Queries are independent: a slice of them against all keys gives the
    same rows (how the card's check holds A15 at 40 999 frames)."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(600, 64, seed=3))
    full = sdpa_pallas.flash_sdpa(q, k, v, 0.125)
    part = sdpa_pallas._flash_sdpa_plain(q[:, :, -100:], k, v, 0.125)
    torch.testing.assert_close(part, full[:, :, -100:], rtol=0, atol=1e-6)


def test_sdpa_wrappers_reject_bad_inputs():
    q = torch.zeros(1, 2, 8, 16, device="meta")
    with pytest.raises(ValueError, match="device"):
        sdpa_pallas.sdpa(q, q, q, 0.25)
    with pytest.raises(ValueError, match="device"):
        sdpa_pallas.flash_sdpa(q, q, q, 0.25)
    x = torch.zeros(1, 2, 8, 16)
    with pytest.raises(ValueError, match="softmax"):
        sdpa_pallas.sdpa(x, x, x, 0.25, softmax="exp")
    with pytest.raises(ValueError, match="shapes"):
        sdpa_pallas.sdpa(x, x[:, :1], x, 0.25)
    with pytest.raises(ValueError, match="query block"):
        sdpa_pallas.sdpa(x, x, x, 0.25, block_q=64)
    assert sdpa_pallas.sdpa(x, x, x, 0.25, block_q=sdpa_pallas.KERNEL_BLOCK_Q).shape == x.shape


@pytest.mark.parametrize("softmax", ["exact", "exp2", "exp2_bf16"])
@pytest.mark.parametrize("t,d", TWIN_CASES)
def test_sdpa_f32_pieces_reference_matches_pallas(t, d, softmax, strict_exp2_bf16_twin):
    q, k, v = _qkv(t, d, seed=TWIN_SEED)
    scaling = d**-0.5
    if softmax == "exp2_bf16":  # see the module docstring
        theirs = strict_exp2_bf16_twin[(t, d)]
    else:
        theirs = np.asarray(jax_sdpa.sdpa(*(jnp.asarray(a) for a in (q, k, v)), scaling, interpret=True,
                                          softmax=softmax))
    qkv = [torch.from_numpy(a) for a in (q, k, v)]
    ours = sdpa_pallas._sdpa_f32_pieces_reference(*qkv, scaling, softmax)
    assert ours.dtype == torch.float32 and ours.shape == q.shape
    limit = np.full(q.shape, 2e-6)
    if softmax == "exp2_bf16":
        limit = limit + sdpa_pallas._exp2_bf16_tie_allowance(*qkv, scaling, torch.from_numpy(theirs)).numpy()
    err = np.abs(ours.numpy().astype(np.float64) - theirs)
    assert np.all(err <= limit), (err.max(), np.max(err - limit))


@pytest.mark.parametrize("softmax", ["exact", "exp2", "online"])
@pytest.mark.parametrize("t,d", TWIN_CASES)
def test_sdpa_f32_pieces_reference_matches_float64_softmax(t, d, softmax):
    q, k, v = _qkv(t, d, seed=TWIN_SEED)
    ours = sdpa_pallas._sdpa_f32_pieces_reference(*(torch.from_numpy(a) for a in (q, k, v)), d**-0.5, softmax)
    np.testing.assert_allclose(ours.numpy(), _softmax64(q, k, v, d**-0.5), atol=5e-7, rtol=0)


@pytest.mark.parametrize("t,d", TWIN_CASES)
def test_sdpa_f32_pieces_reference_online_matches_flash_plain(t, d):
    """The online mode (64-key tiles, O kept unnormalised) against A15's
    plain version (128-key blocks, normalised at every block) on query slices."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(t, d, seed=TWIN_SEED))
    ours = sdpa_pallas._sdpa_f32_pieces_reference(q, k, v, d**-0.5, "online")
    for sl in (slice(0, 32), slice(max(0, t - 40), t)):
        torch.testing.assert_close(ours[:, :, sl], sdpa_pallas._flash_sdpa_plain(q[:, :, sl], k, v, d**-0.5),
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("d", [16, 64, 80, 128])
def test_split_pieces_reassemble_exactly(d):
    """x0 + x1 + x2 == x in float32 for values whose pieces are normal
    (binary exponents -100 .. 100: a nonzero piece is at least 2^-23 of
    x's exponent), and
    the split pass's planes: (q, k, v) x 3 pieces of (B H T, D_p) bf16, the
    head zero-padded to 64 or 128 columns."""
    rs = np.random.RandomState(d)
    shape = (2, 3, 50, d)
    x = (rs.choice([-1.0, 1.0], shape) * rs.uniform(1.0, 2.0, shape) * np.exp2(rs.randint(-100, 100, shape)))
    x = x.astype(np.float32)
    x = torch.from_numpy(x)
    x0, x1, x2 = numerics.split3(x)
    assert all(a.dtype == torch.bfloat16 for a in (x0, x1, x2))
    x0, x1, x2 = (a.float() for a in (x0, x1, x2))
    assert torch.equal((x0 + x1) + x2, x)
    pieces = sdpa_pallas.split_pieces(x, 2 * x, -x)
    d_p = 64 if d <= 64 else 128
    assert pieces.dtype == torch.bfloat16 and pieces.shape == (3, 3, 2 * 3 * 50, d_p)
    assert not torch.any(pieces[..., d:])
    for i, scale in enumerate((1, 2, -1)):
        total = (pieces[i, 0].float() + pieces[i, 1].float()) + pieces[i, 2].float()
        assert torch.equal(total[:, :d], scale * x.reshape(-1, d))

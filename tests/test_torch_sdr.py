"""PyTorch port, SDR: kernels A4 (in its three split modes), A5 and A10
(plain versions) and the metric against JAX on the CPU. Tolerances:
correlations atol 2e-4 of max|r_auto| (as tests/test_ops.py holds the Gram
kernel), A10's 2e-3 of max|r| (as
tests/test_ops.py holds the fused kernel, whose chunk DFT is bf16x3),
Levinson solutions 2e-3 (as tests/test_ops.py holds the Levinson kernel),
SDR atol 1e-2 dB."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.linalg import solve_toeplitz

from fast_speech_enhancement_metrics_tpu import SDR as JaxSDR
from fast_speech_enhancement_metrics_tpu.ops import sdr_corr_fused as jax_corr_fused
from fast_speech_enhancement_metrics_tpu.ops.levinson_pallas import (
    levinson_solve_fused as jax_levinson_fused,
)
from fast_speech_enhancement_metrics_tpu.ops.sdr_corr_gram import (
    correlation_lags_gram as jax_corr_gram,
)
from fast_speech_enhancement_metrics_tpu.ops.toeplitz import levinson_solve as jax_levinson
from fast_speech_enhancement_metrics_tpu_torch import SDR
from fast_speech_enhancement_metrics_tpu_torch.ops import levinson_pallas, sdr_corr_fused, sdr_corr_gram
from fast_speech_enhancement_metrics_tpu_torch.ops.dft import correlation_lags


@pytest.mark.parametrize("t", [16384, 7000, 150])
def test_corr_kernel_plain_matches_pallas_kernel(t):
    rs = np.random.RandomState(23)
    c = rs.randn(3, t).astype(np.float32)
    d = (0.8 * c + 0.3 * rs.randn(3, t)).astype(np.float32)
    ra, rc = sdr_corr_gram.correlation_lags_gram(torch.from_numpy(c), torch.from_numpy(d), 512)
    ja, jc = jax_corr_gram(c, d, 512, split="x4", interpret=True)
    scale = float(np.abs(np.asarray(ja)).max())
    np.testing.assert_allclose(ra.numpy(), np.asarray(ja), atol=2e-4 * scale)
    np.testing.assert_allclose(rc.numpy(), np.asarray(jc), atol=2e-4 * scale)


@pytest.mark.parametrize("split", ["x3", "x1"])
@pytest.mark.parametrize("t", [16384, 7000])
def test_corr_split_plain_matches_pallas_kernel(t, split):
    """The reduced product classes: the plain correlation summed over the
    bf16 halves against the JAX kernel in that split mode, 2e-4 of max|r|."""
    rs = np.random.RandomState(28)
    c = rs.randn(3, t).astype(np.float32)
    d = (0.8 * c + 0.3 * rs.randn(3, t)).astype(np.float32)
    ra, rc = sdr_corr_gram.correlation_lags_gram(torch.from_numpy(c), torch.from_numpy(d), 512, split=split)
    ja, jc = jax_corr_gram(c, d, 512, split=split, interpret=True)
    scale = float(np.abs(np.asarray(ja)).max())
    np.testing.assert_allclose(ra.numpy(), np.asarray(ja), atol=2e-4 * scale)
    np.testing.assert_allclose(rc.numpy(), np.asarray(jc), atol=2e-4 * scale)


def test_corr_split_x4_plain_is_the_plain_correlation():
    """split="x4" (the default) is the float32 plain correlation, bit for
    bit; x3 and x1 differ from it by the dropped bf16 terms only."""
    rs = np.random.RandomState(29)
    c = torch.from_numpy(rs.randn(2, 9000).astype(np.float32))
    d = torch.from_numpy(rs.randn(2, 9000).astype(np.float32))
    want = correlation_lags(c, (c, d), 512)
    for got in (sdr_corr_gram.correlation_lags_gram(c, d, 512), sdr_corr_gram.correlation_lags_gram(c, d, 512, "x4")):
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    scale = want[0].abs().max().item()
    for split, tol in (("x3", 1e-4), ("x1", 1e-2)):
        got = sdr_corr_gram.correlation_lags_gram(c, d, 512, split)
        assert not torch.equal(got[0], want[0])
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=tol * scale)
    with pytest.raises(ValueError, match="split"):
        sdr_corr_gram.correlation_lags_gram(c, d, 512, "x2")


def _jax_hi_lo(x):
    """The JAX kernels' split (``hi_lo`` in ``_gram_kernel``, ``dot3`` in
    ``_corr_kernel``): bf16 halves of a float32 array."""
    xh = x.astype(jnp.bfloat16)
    return xh, (x - xh.astype(jnp.float32)).astype(jnp.bfloat16)


def _jax_gram_operands(c, d, split):
    """The K-stacked operands of the JAX ``_gram_kernel`` (ops/sdr_corr_gram.py:
    the frames, the shifted right operand [C_0..C_4 | D_0..D_4] and the
    concatenations at :102-124) over a whole row, one frame block."""
    t = c.shape[-1]
    frames = -(-t // 128)
    cc = jnp.pad(jnp.asarray(c), (0, frames * 128 - t)).reshape(frames, 128)
    dc = jnp.pad(jnp.asarray(d), (0, frames * 128 - t)).reshape(frames, 128)

    def shifts(x):  # row f of shift s holds frame f + s, zeros past the last
        xp = jnp.pad(x, ((0, 4), (0, 0)))
        return [xp[s:s + frames] for s in range(5)]

    b_op = jnp.concatenate(shifts(cc) + shifts(dc), axis=1)
    ah, al = _jax_hi_lo(cc)
    bh, bl = _jax_hi_lo(b_op)
    if split == "x4":
        return jnp.concatenate([ah, ah, al, al], axis=0), jnp.concatenate([bh, bl, bh, bl], axis=0)
    if split == "x3":
        return jnp.concatenate([ah, ah, al], axis=0), jnp.concatenate([bh, bl, bh], axis=0)
    return ah, bh


def _bits(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("t", [1000 + 37, 500])
def test_split_halves_are_jax_halves(t):
    """The split pass's plain version (the halves the A4 and A10 kernels
    read): per signal the JAX kernels' bf16 hi and lo, zeros past T."""
    rs = np.random.RandomState(40)
    c, d = rs.randn(2, t).astype(np.float32), rs.randn(2, t).astype(np.float32)
    row_len = -(-t // 512) * 512
    got = sdr_corr_gram.split_halves(torch.from_numpy(c), torch.from_numpy(d), row_len).float().numpy()
    assert got.shape == (4, 2, row_len)
    for p, x in enumerate((c, c, d, d)):
        want = _bits(_jax_hi_lo(jnp.asarray(x))[p % 2])
        np.testing.assert_array_equal(got[p, :, :t], want)
        assert not got[p, :, t:].any()


@pytest.mark.parametrize("split", ["x4", "x3", "x1"])
def test_gram_operands_are_jax_stacking(split):
    """A4's K-stacked operands, as the kernel's TMA boxes read them from the
    halves (``_gram_operands``), equal the JAX kernel's: the clean frames
    [ch, ch, cl, cl] and the shifted targets [yh, yl, yh, yl] (x3 the first
    three, x1 the first), bit for bit."""
    rs = np.random.RandomState(41)
    t = 128 * 9 + 37
    c, d = rs.randn(2, t).astype(np.float32), rs.randn(2, t).astype(np.float32)
    halves = sdr_corr_gram.split_halves(torch.from_numpy(c), torch.from_numpy(d), -(-t // 128) * 128)
    a, b = sdr_corr_gram._gram_operands(halves, split)
    assert len(sdr_corr_gram.K_STACK[split]) == {"x4": 4, "x3": 3, "x1": 1}[split]
    for row in range(2):
        ja, jb = _jax_gram_operands(c[row], d[row], split)
        np.testing.assert_array_equal(a[row].float().numpy(), _bits(ja))
        np.testing.assert_array_equal(b[row].float().numpy(), _bits(jb))


@pytest.mark.parametrize("t", [16000, 16000 + 37, 500])
def test_gram_decomposition_is_the_correlation(t):
    """The shifted Grams and the epilogue's diagonal sums (``_gram_reference``,
    the kernel's indexing: k ranges, two row halves, U_a + L_{a+1}) in
    float64 on the raw signals are the correlation: against a direct
    float64 sum to 1e-12 and ``ops/dft.py::correlation_lags`` (float32) to
    2e-6 of max|r|, at T a multiple of 128, not one, and under 5 frames."""
    rs = np.random.RandomState(42)
    c, d = rs.randn(2, t), rs.randn(2, t)
    row_len = -(-t // 128) * 128
    zeros = np.zeros((2, row_len))
    planes = torch.from_numpy(np.stack([np.pad(c, ((0, 0), (0, row_len - t))), zeros,
                                        np.pad(d, ((0, 0), (0, row_len - t))), zeros]))
    direct_a = np.array([[c[b, :t - l] @ c[b, l:] if l < t else 0.0 for l in range(512)] for b in range(2)])
    direct_c = np.array([[c[b, :t - l] @ d[b, l:] if l < t else 0.0 for l in range(512)] for b in range(2)])
    scale = np.abs(direct_a).max()
    plain = correlation_lags(torch.from_numpy(c).float(), (torch.from_numpy(c).float(), torch.from_numpy(d).float()),
                             512)
    for split_frames in (32, 64, row_len // 128):
        ra, rc = sdr_corr_gram._gram_reference(planes, "x1", split_frames)
        np.testing.assert_allclose(ra.numpy(), direct_a, rtol=0, atol=1e-12 * scale)
        np.testing.assert_allclose(rc.numpy(), direct_c, rtol=0, atol=1e-12 * scale)
        np.testing.assert_allclose(ra.numpy(), plain[0].double().numpy(), rtol=0, atol=2e-6 * scale)
        np.testing.assert_allclose(rc.numpy(), plain[1].double().numpy(), rtol=0, atol=2e-6 * scale)


@pytest.mark.parametrize("split", ["x4", "x3", "x1"])
def test_gram_reference_matches_pallas_kernel(split):
    """The kernel's arithmetic on the halves in each split against the JAX
    kernel in that mode (interpret mode), 2e-5 of max|r_auto|: the same
    bf16 products, summed in another order."""
    rs = np.random.RandomState(43)
    t = 128 * 20 + 37
    c = rs.randn(2, t).astype(np.float32)
    d = (0.8 * c + 0.3 * rs.randn(2, t)).astype(np.float32)
    halves = sdr_corr_gram.split_halves(torch.from_numpy(c), torch.from_numpy(d), -(-t // 128) * 128)
    ra, rc = sdr_corr_gram._gram_reference(halves, split, 64)
    ja, jc = jax_corr_gram(c, d, 512, split=split, interpret=True)
    scale = float(np.abs(np.asarray(ja)).max())
    np.testing.assert_allclose(ra.numpy(), np.asarray(ja), rtol=0, atol=2e-5 * scale)
    np.testing.assert_allclose(rc.numpy(), np.asarray(jc), rtol=0, atol=2e-5 * scale)


@pytest.mark.parametrize("batch,frames", [(64, 2000), (1, 2000), (64, 2001), (3, 4), (1, 1)])
@pytest.mark.parametrize("split", ["x4", "x3", "x1"])
def test_gram_k_ranges_cover_the_frames(batch, frames, split):
    """The k ranges the wrapper hands the kernel: whole stages, every frame
    in exactly one range, the last range not empty."""
    split_frames, n = sdr_corr_gram._gram_k_ranges(batch, frames, split, 132)
    assert split_frames % sdr_corr_gram._STAGE_FRAMES[split] == 0
    assert (n - 1) * split_frames < frames <= n * split_frames


def test_fused_table_halves_are_jax_operand():
    """A10's table operand: ``_table_halves`` is the JAX kernel's pre-split
    [wh; wl; wh] (ops/sdr_corr_fused.py), columns in the kernel's tile
    order (each 64-bin tile's re columns, then its x2 columns) and
    transposed, bit for bit; the order is a permutation."""
    h = 512
    w = jnp.asarray(jax_corr_fused._packed_corr_matrix(h))
    wh = w.astype(jnp.bfloat16)
    wl = (w - wh.astype(jnp.float32)).astype(jnp.bfloat16)
    ws = _bits(jnp.concatenate([wh, wl, wh], axis=0))  # (3h, 2h)
    cols = sdr_corr_fused._table_columns(h).numpy()
    assert sorted(cols) == list(range(2 * h))
    np.testing.assert_array_equal(cols[:128], np.r_[0:64, h:h + 64])
    got = sdr_corr_fused._table_halves(h).float().numpy()  # (2, 2h, h)
    np.testing.assert_array_equal(got[0].T, ws[:h][:, cols])
    np.testing.assert_array_equal(got[1].T, ws[h:2 * h][:, cols])
    np.testing.assert_array_equal(got[0].T, ws[2 * h:][:, cols])


def test_fused_lag_matrix_is_unpack_and_inverse_dft():
    """A10's tail folds the unpack and the inverse DFT into one (3h, L)
    matrix: on random partials it gives the JAX package's unpack and
    einsums (ops/sdr_corr_fused.py) to 1e-5 of max|r| (float32 sums
    reordered)."""
    h, lags = 64, 64
    rs = np.random.RandomState(45)
    partial = rs.randn(3, 2, 6, h).astype(np.float32)
    ra, rc = sdr_corr_fused._lags_from_partials(torch.from_numpy(partial), lags)
    s = partial.sum(axis=1).astype(np.float64)
    icos, isin = (np.asarray(a, np.float64) for a in jax_corr_fused._inverse_lag_matrices(h, lags))
    for got, (p1, p2, q) in ((ra, s[:, 0:3].transpose(1, 0, 2)), (rc, s[:, 3:6].transpose(1, 0, 2))):
        s_re = np.concatenate([p1[:, :1], p1[:, 1:] + p2[:, 1:], p2[:, :1]], axis=1)
        s_im = np.concatenate([np.zeros_like(q[:, :1]), q[:, 1:], np.zeros_like(q[:, :1])], axis=1)
        want = s_re @ icos - s_im @ isin
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("t", [16384, 7000 + 37, 300])
def test_fused_dft_reference_matches_pallas_kernel(t):
    """A10's kernel arithmetic (``_corr_dft_reference``: groups of 127
    windows from the chunk before, 64-bin tiles of the permuted table,
    xh wh + xh wl + xl wh) gives the JAX fused kernel's correlations
    (interpret mode) to 2e-5 of max|r_auto|: the same bf16x3 class,
    grouped and summed in another order."""
    rs = np.random.RandomState(44)
    c = rs.randn(2, t).astype(np.float32)
    d = (0.6 * c + 0.4 * rs.randn(2, t)).astype(np.float32)
    halves = sdr_corr_gram.split_halves(torch.from_numpy(c), torch.from_numpy(d), -(-t // 512) * 512)
    ra, rc = sdr_corr_fused._lags_from_partials(sdr_corr_fused._corr_dft_reference(halves, 512).float(), 512)
    ja, jc = jax_corr_fused.correlation_lags_fused(c, d, 512, interpret=True)
    scale = float(np.abs(np.asarray(ja)).max())
    np.testing.assert_allclose(ra.numpy(), np.asarray(ja), rtol=0, atol=2e-5 * scale)
    np.testing.assert_allclose(rc.numpy(), np.asarray(jc), rtol=0, atol=2e-5 * scale)


def _spd_rows(n, rows=5, seed=11):
    """Decaying SPD Toeplitz rows, condition numbers 17..759. Two float32
    orderings of the recursion differ by about cond x 1e-7 relative, so the
    2e-3 tolerance holds the algorithm and not the round-off luck (the
    noisier rows of tests/test_ops.py reach cond 2e4)."""
    rs = np.random.RandomState(seed)
    r = (0.9 ** np.arange(n))[None] * rs.uniform(0.5, 20.0, (rows, 1))
    r = r + 0.002 * rs.randn(rows, n) * r[:, :1]
    r[:, 0] = np.abs(r[:, 0]) + 1.0
    return r.astype(np.float32), rs.randn(rows, n).astype(np.float32)


def test_levinson_kernel_plain_matches_pallas_kernel():
    r, b = _spd_rows(128)
    ours = levinson_pallas.levinson_solve_fused(torch.from_numpy(r), torch.from_numpy(b)).numpy()
    theirs = np.asarray(jax_levinson_fused(r, b, interpret=True))
    for i in range(len(r)):
        want = solve_toeplitz(r[i].astype(np.float64), b[i].astype(np.float64))
        np.testing.assert_allclose(ours[i], theirs[i], rtol=2e-3, atol=2e-3 * np.abs(want).max())
        np.testing.assert_allclose(ours[i], want, rtol=2e-3, atol=2e-3 * np.abs(want).max())


@pytest.mark.parametrize("variant", levinson_pallas.VARIANTS)
def test_levinson_variant_plain_matches_pallas_variant(variant):
    """Each variant's plain version (A5's recursion, or the two-step one
    for "double") against the JAX kernel of that variant in interpret mode
    and against a float64 direct solve, at 2e-3 of max|x|."""
    r, b = _spd_rows(128, seed=13)
    ours = levinson_pallas.levinson_solve_fused(torch.from_numpy(r), torch.from_numpy(b), variant=variant).numpy()
    theirs = np.asarray(jax_levinson_fused(r, b, interpret=True, variant=variant))
    for i in range(len(r)):
        want = solve_toeplitz(r[i].astype(np.float64), b[i].astype(np.float64))
        np.testing.assert_allclose(ours[i], theirs[i], rtol=2e-3, atol=2e-3 * np.abs(want).max())
        np.testing.assert_allclose(ours[i], want, rtol=2e-3, atol=2e-3 * np.abs(want).max())


def test_levinson_double_plain_is_another_reassociation():
    """The two-step plain version takes an odd and an even step count and
    differs from the one-step recursion only by round-off."""
    for n in (96, 97):
        r, b = _spd_rows(n, rows=3, seed=14)
        single = levinson_pallas.levinson_solve_fused(torch.from_numpy(r), torch.from_numpy(b)).numpy()
        double = levinson_pallas._levinson_double_plain(torch.from_numpy(r), torch.from_numpy(b)).numpy()
        np.testing.assert_allclose(double, single, rtol=0, atol=1e-4 * np.abs(single).max())
        assert not np.array_equal(double, single)
    with pytest.raises(ValueError, match="variant"):
        levinson_pallas.levinson_solve_fused(torch.zeros(1, 32), torch.zeros(1, 32), variant="quad")


def test_levinson_kernel_plain_matches_scan_at_512():
    r, b = _spd_rows(512, rows=3, seed=12)
    ours = levinson_pallas.levinson_solve_fused(torch.from_numpy(r), torch.from_numpy(b)).numpy()
    theirs = np.asarray(jax_levinson(r, b))
    np.testing.assert_allclose(ours, theirs, rtol=2e-3, atol=2e-3 * np.abs(theirs).max())


@pytest.mark.parametrize("variant,n", [
    pytest.param("vpu", 96, id="96"), pytest.param("vpu", 128, id="128"), pytest.param("vpu", 512, id="512"),
    ("flat", 96), ("flat", 128), ("dotreduce", 96), ("dotreduce", 128), ("double", 96), ("double", 97),
    ("double", 128),
])
def test_levinson_warp_order_reference_matches_jax(variant, n):
    """The dataflow each Levinson kernel computes on the card, bit for bit
    (``_warp_twin``: lane l holds elements l, l + 32, ..., each lane sums
    its registers as a halving tree, then the xor butterfly; no fused
    multiply-adds): A5's ``_levinson_warp_order_reference`` ("vpu", and
    "dotreduce", whose split butterfly adds the same pairs), its unphased
    order ("flat") and ``_levinson_double_warp_reference`` ("double"; 95,
    96 and 127 steps: an odd count ends on A5's single step, an even one on
    a round). Each against the JAX kernel of its variant in interpret mode,
    its plain version and a float64 direct solve, at 2e-3 of max|x| on
    systems of cond below 1e3. The JAX kernels take orders that are
    multiples of 128, so at n = 96 and 97 the JAX side is the JAX package's
    XLA recursion (``ops/toeplitz.py::levinson_solve``)."""
    r, b = _spd_rows(n, rows=4, seed=16)
    ours = levinson_pallas._warp_twin(variant)(torch.from_numpy(r), torch.from_numpy(b)).numpy()
    theirs = np.asarray(jax_levinson_fused(r, b, interpret=True, variant=variant) if n % 128 == 0
                        else jax_levinson(r, b))
    plain = levinson_pallas.levinson_solve_fused(torch.from_numpy(r), torch.from_numpy(b), variant=variant).numpy()
    exact = np.stack([solve_toeplitz(r[i].astype(np.float64), b[i].astype(np.float64)) for i in range(len(r))])
    for want in (theirs, plain, exact):
        np.testing.assert_allclose(ours, want, rtol=2e-3, atol=2e-3 * np.abs(want).max())


def test_levinson_twins_are_distinct_orders():
    """The three orders are the same recursion summed differently: the
    unphased ("flat") and two-step ("double") twins agree with A5's to
    round-off and are not its bits at SDR's order."""
    r, b = _spd_rows(512, rows=2, seed=18)
    r, b = torch.from_numpy(r), torch.from_numpy(b)
    a5 = levinson_pallas._warp_twin("vpu")(r, b)
    assert levinson_pallas._warp_twin("dotreduce") is levinson_pallas._levinson_warp_order_reference
    for variant in ("flat", "double"):
        other = levinson_pallas._warp_twin(variant)(r, b)
        torch.testing.assert_close(other, a5, rtol=0, atol=1e-4 * a5.abs().max().item())
        assert not torch.equal(other, a5)


@pytest.mark.parametrize("m", [1, 2, 5, 16, 17, 32])
def test_levinson_lane_tree_order(m):
    """A lane's sum (``_lane_tree``): a[i] + a[i + m // 2] level by level,
    an odd length's last element carried up; at m = 5: ((a0 + a2) + (a1 +
    a3)) + a4. Small integers make every partial sum exact, so the result
    is the sum whatever the order; the m = 5 case pins the order with
    values whose sum depends on it (added left to right they give 2^-24)."""
    a = torch.arange(m, dtype=torch.float32)
    assert levinson_pallas._lane_tree(a[None])[0, 0].item() == m * (m - 1) / 2
    if m == 5:
        v = torch.tensor([[1.0, 2.0 ** -24, -1.0, 2.0 ** -24, 0.0]])
        assert levinson_pallas._lane_tree(v)[0, 0].item() == 2.0 ** -23


def test_levinson_zero_system_is_guarded():
    """r0[0] == 0 (an all-zero signal) solves the identity system, finitely."""
    x = levinson_pallas.levinson_solve_fused(torch.zeros(2, 64), torch.ones(2, 64))
    assert torch.isfinite(x).all()


@pytest.mark.parametrize(
    "kw",
    [{}, {"solver": "cholesky"}, {"solver": "levinson_xla"}, {"corr_impl": "gram_x4"}, {"corr_impl": "gram"},
     {"corr_impl": "gram_x1"}],
    ids=["auto", "cholesky", "levinson_xla", "gram_x4", "gram", "gram_x1"],
)
def test_sdr_metric_matches_jax(speech_data, kw):
    """The JAX metric on the CPU takes its XLA correlations, or, for the
    reduced classes, the Pallas kernel in interpret mode in the same mode."""
    clean, noisy = speech_data["speech"], speech_data["noisy_speech"]
    ours = [r["SDR"] for r in SDR(device="cpu", **kw)(clean, noisy)]
    jax_kw = {"solver": kw["solver"]} if "solver" in kw else {}
    if kw.get("corr_impl") in ("gram", "gram_x1"):
        jax_kw["corr_impl"] = kw["corr_impl"]
    theirs = [r["SDR"] for r in JaxSDR(**jax_kw)(clean, noisy)]
    np.testing.assert_allclose(ours, theirs, atol=1e-2)


@pytest.mark.parametrize("precision", ["highest", "high"])
def test_sdr_precision_matches_jax(speech_data, precision):
    """``precision`` is taken as the JAX metric takes it; on the CPU both
    metrics score on their "xla" paths, the port's in float32."""
    clean, noisy = speech_data["speech"], speech_data["noisy_speech"]
    ours = [r["SDR"] for r in SDR(device="cpu", precision=precision)(clean, noisy)]
    theirs = [r["SDR"] for r in JaxSDR(precision=precision)(clean, noisy)]
    np.testing.assert_allclose(ours, theirs, atol=1e-2)


@pytest.mark.parametrize(
    "attr,value,corr_impl",
    [("zero_mean", True, "auto"), ("zero_mean", True, "gram_x4"), ("load_diag", 1e-3, "auto")],
    ids=["zero_mean", "zero_mean-gram_x4", "load_diag"],
)
def test_sdr_zero_mean_and_load_diag_match_jax(attr, value, corr_impl):
    """Each attribute, set after construction on both metrics, changes the
    score as it does on the JAX metric (1e-2 dB); the signals carry a DC
    offset, so that removing the mean matters."""
    rs = np.random.RandomState(30)
    clean = (rs.randn(3, 16000) + 0.4).astype(np.float32)
    noisy = (clean + 0.6 * rs.randn(3, 16000)).astype(np.float32)
    kw = {} if corr_impl == "auto" else {"corr_impl": corr_impl}
    ours, theirs = SDR(device="cpu", **kw), JaxSDR(**kw)
    setattr(ours, attr, value)
    setattr(theirs, attr, value)
    got = np.array([r["SDR"] for r in ours(clean, noisy)])
    np.testing.assert_allclose(got, [r["SDR"] for r in theirs(clean, noisy)], atol=1e-2)
    unset = np.array([r["SDR"] for r in SDR(device="cpu", **kw)(clean, noisy)])
    assert np.all(np.abs(got - unset) > 1e-3), (got, unset)


def test_sdr_gram_semantics_match_jax_gram_kernel():
    """Raw-signal correlation + normalization fold, at a non-unit scale."""
    rs = np.random.RandomState(24)
    clean = (5.0 * rs.randn(3, 16000)).astype(np.float32)
    noisy = clean + 1.5 * rs.randn(3, 16000).astype(np.float32)
    ours = [r["SDR"] for r in SDR(device="cpu", corr_impl="gram_x4")(clean, noisy)]
    theirs = [r["SDR"] for r in JaxSDR(corr_impl="gram_x4")(clean, noisy)]
    np.testing.assert_allclose(ours, theirs, atol=1e-2)


def test_sdr_self_reference_saturates(speech_data):
    for r in SDR(device="cpu")(speech_data["speech"], speech_data["speech"]):
        assert r["SDR"] > 40.0


@pytest.mark.parametrize("impl", ["fused", "gram", "gram_x1"])
def test_sdr_corr_modes_match_jax(impl):
    """Every corr_impl of the JAX package is ported now: fused (A10) scores
    a noisy pair as the default path does, and gram / gram_x1 (A4 in split
    x3 / x1) as the JAX metric in that mode does, at 1e-2 dB, on raw
    signals of a non-unit scale (the normalization fold)."""
    rs = np.random.RandomState(25)
    clean = rs.randn(2, 5000).astype(np.float32)
    noisy = (clean + 0.5 * rs.randn(2, 5000)).astype(np.float32)
    ours = [r["SDR"] for r in SDR(device="cpu", corr_impl=impl)(clean, noisy)]
    if impl == "fused":
        np.testing.assert_allclose(ours, [r["SDR"] for r in SDR(device="cpu")(clean, noisy)], atol=1e-2)
        return
    clean, noisy = 3.0 * clean, 3.0 * noisy
    ours = [r["SDR"] for r in SDR(device="cpu", corr_impl=impl)(clean, noisy)]
    theirs = [r["SDR"] for r in JaxSDR(corr_impl=impl)(clean, noisy)]
    np.testing.assert_allclose(ours, theirs, atol=1e-2)


@pytest.mark.parametrize("t", [16384, 7000, 300])
def test_fused_corr_plain_matches_pallas_kernel(t):
    """T % 512 == 0 takes the JAX raw variant, the others its padded one."""
    rs = np.random.RandomState(26)
    c = rs.randn(3, t).astype(np.float32)
    d = (0.6 * c + 0.4 * rs.randn(3, t)).astype(np.float32)
    ra, rc = sdr_corr_fused.correlation_lags_fused(torch.from_numpy(c), torch.from_numpy(d), 512)
    ja, jc = jax_corr_fused.correlation_lags_fused(c, d, 512, interpret=True)
    scale = float(np.abs(np.asarray(ja)).max())
    np.testing.assert_allclose(ra.numpy(), np.asarray(ja), atol=2e-3 * scale)
    np.testing.assert_allclose(rc.numpy(), np.asarray(jc), atol=2e-3 * scale)


def test_fused_corr_matches_direct_correlation():
    """The plain partials against a float64 direct sum, over several groups
    (chunk_block 4) and a ragged tail."""
    rs = np.random.RandomState(27)
    c = rs.randn(2, 64 * 37 + 5)
    d = rs.randn(2, c.shape[1])
    ra, rc = sdr_corr_fused.correlation_lags_fused(torch.tensor(c, dtype=torch.float32),
                                                   torch.tensor(d, dtype=torch.float32), 64, chunk_block=4)
    t = c.shape[1]
    want_a = np.array([[np.dot(c[b, :t - l], c[b, l:]) for l in range(64)] for b in range(2)])
    want_c = np.array([[np.dot(c[b, :t - l], d[b, l:]) for l in range(64)] for b in range(2)])
    np.testing.assert_allclose(ra.numpy(), want_a, atol=1e-5 * np.abs(want_a).max())
    np.testing.assert_allclose(rc.numpy(), want_c, atol=1e-5 * np.abs(want_a).max())


def test_fused_corr_table_is_jax_table():
    np.testing.assert_array_equal(sdr_corr_fused._packed_corr_matrix(512), jax_corr_fused._packed_corr_matrix(512))


@pytest.mark.parametrize("seconds", [4, 4 + 100 / 16000])
def test_sdr_fused_metric_matches_jax(seconds):
    from fast_speech_enhancement_metrics_tpu.utils.audio import load_audio_data

    clean, noisy, _ = load_audio_data(seconds, 3, 16000)
    ours = [r["SDR"] for r in SDR(device="cpu", corr_impl="fused")(clean, noisy)]
    theirs = [r["SDR"] for r in JaxSDR(corr_impl="fused")(clean, noisy)]
    np.testing.assert_allclose(ours, theirs, atol=1e-2)


def test_sdr_kernel_wrappers_reject_other_devices():
    x = torch.zeros(1, 512, device="meta")
    with pytest.raises(ValueError, match="device"):
        sdr_corr_gram.correlation_lags_gram(x, x, 512)
    with pytest.raises(ValueError, match="device"):
        levinson_pallas.levinson_solve_fused(x, x)
    with pytest.raises(ValueError, match="device"):
        sdr_corr_fused.correlation_lags_fused(x, x, 512)

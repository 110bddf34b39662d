"""PyTorch port, LSD: the plain versions of kernels A1-A3 and the metric against JAX.

The JAX side runs on the CPU: its Pallas kernel in interpret mode, its
metric through the XLA path that ``"auto"`` picks there. Tolerance: the
LSD contract, rtol/atol 2e-4. The CUDA frame-tile kernel's tables, split
and dataflow (``_lsd_tiles_reference``) are held against the plain
versions here; the kernel itself on the card in
``test_torch_kernels_cuda.py``.
"""

import numpy as np
import pytest
import torch

from fast_speech_enhancement_metrics_tpu import LSD as JaxLSD
from fast_speech_enhancement_metrics_tpu.ops.lsd_fused import _lsd_framed as jax_lsd_framed
from fast_speech_enhancement_metrics_tpu.ops.lsd_fused import lsd_scores as jax_lsd_scores
from fast_speech_enhancement_metrics_tpu_torch import LSD
from fast_speech_enhancement_metrics_tpu_torch.ops import lsd_fused
from fast_speech_enhancement_metrics_tpu_torch.utils.audio import load_audio_data
from tests.oracles.lsd_oracle import lsd_oracle


def _pairs(seconds, rows=3, seed=42):
    clean, noisy, _ = load_audio_data(seconds, rows, 16000, seed=seed)
    return clean, noisy


@pytest.mark.parametrize("t", [16384, 32768])
def test_lsd_kernel_plain_matches_pallas_kernel(t):
    """Hop-aligned clips with an 8-aligned chunk count take the JAX
    package's raw whole-signal kernel (A1) there."""
    clean, noisy = _pairs(t / 16000)
    ours = lsd_fused.lsd_scores(torch.from_numpy(clean), torch.from_numpy(noisy), 512, 256, 1e-8)
    theirs = jax_lsd_scores(clean, noisy, 512, 256, 1e-8, interpret=True, denoised_scale="auto")
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("impl", ["auto", "xla", "fused"])
def test_lsd_metric_matches_jax(speech_data, impl):
    clean, noisy = speech_data["speech"], speech_data["noisy_speech"]
    ours = [r["LSD"] for r in LSD(device="cpu", spectral_impl=impl)(clean, noisy)]
    theirs = [r["LSD"] for r in JaxLSD()(clean, noisy)]
    np.testing.assert_allclose(ours, theirs, rtol=2e-4, atol=2e-4)


def test_lsd_identical_inputs_beat_noisy(speech_data):
    clean, noisy = speech_data["speech"], speech_data["noisy_speech"]
    metric = LSD(device="cpu")
    same = metric(clean, clean)
    theirs = JaxLSD()(clean, clean)
    np.testing.assert_allclose([r["LSD"] for r in same], [r["LSD"] for r in theirs], rtol=2e-4, atol=2e-4)
    assert all(s["LSD"] < n["LSD"] for s, n in zip(same, metric(clean, noisy)))


def test_lsd_48k_input_resamples():
    clean, noisy = _pairs(1.0, rows=2)
    c48, d48 = np.repeat(clean, 3, axis=1), np.repeat(noisy, 3, axis=1)
    ours = [r["LSD"] for r in LSD(sample_rate=48000, device="cpu")(c48, d48)]
    theirs = [r["LSD"] for r in JaxLSD(sample_rate=48000)(c48, d48)]
    np.testing.assert_allclose(ours, theirs, rtol=2e-4, atol=2e-4)


def test_lsd_auto_takes_plain_path_for_unaligned_clips():
    """A clip that is not hop-aligned: ``lsd_scores`` scores it (kernel A2's
    route) as the JAX package does. On the CPU the metric's ``"auto"`` is
    the framed-DFT path; on a CUDA device it is the kernel route, which now
    takes A2 for such a clip instead of raising."""
    clean, noisy = _pairs(1.0, rows=2)  # 16000 % 256 != 0
    ct, nt = torch.from_numpy(clean), torch.from_numpy(noisy)
    ours = lsd_fused.lsd_scores(ct, nt, 512, 256, 1e-8)
    theirs = jax_lsd_scores(clean, noisy, 512, 256, 1e-8, interpret=True, denoised_scale="auto")
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=2e-4, atol=2e-4)
    assert not LSD(device="cpu")._use_fused()
    ours = [r["LSD"] for r in LSD(device="cpu")(clean, noisy)]
    theirs = [r["LSD"] for r in JaxLSD()(clean, noisy)]
    np.testing.assert_allclose(ours, theirs, rtol=2e-4, atol=2e-4)

    on_card = LSD(device="cpu")
    on_card._on_cuda = lambda: True
    assert on_card._use_fused()
    routes = []
    real = lsd_fused.lsd_wholesig
    lsd_fused.lsd_wholesig = lambda *a: routes.append("A2") or real(*a)
    try:
        got = on_card._compute(ct, nt)["LSD"]
    finally:
        lsd_fused.lsd_wholesig = real
    assert routes == ["A2"]
    np.testing.assert_allclose(got.numpy(), ours, rtol=2e-4, atol=2e-4)


def _noise_pairs(t, rows=3, seed=0):
    rs = np.random.RandomState(seed)
    clean = rs.randn(rows, t).astype(np.float32)
    return clean, (0.7 * clean + 0.5 * rs.randn(rows, t)).astype(np.float32)


@pytest.mark.parametrize("t", [16000, 16100, 32768 + 7])
def test_lsd_a2_plain_matches_pallas_kernel(t):
    """Clips that are not hop-aligned take A2 in both packages.

    Seeded noise pairs: the JAX kernel's chunk DFT is bf16x3, and on a
    synthetic-speech frame with deep spectral nulls that alone moves its
    score 1.4e-3 from the float64 oracle (16100 samples, seed 42, row 2),
    where the port's float32 DFT stays within 1e-5; the oracle case below
    holds the port on speech."""
    clean, noisy = _noise_pairs(t)
    ours = lsd_fused.lsd_scores(torch.from_numpy(clean), torch.from_numpy(noisy), 512, 256, 1e-8)
    theirs = jax_lsd_scores(clean, noisy, 512, 256, 1e-8, interpret=True, denoised_scale="auto")
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("t", [16100, 32768 + 7])
def test_lsd_a2_plain_matches_oracle_on_speech(t):
    clean, noisy = _pairs(t / 16000)
    clean, noisy = clean[:, :t], noisy[:, :t]
    ours = lsd_fused.lsd_scores(torch.from_numpy(clean), torch.from_numpy(noisy), 512, 256, 1e-8)
    np.testing.assert_allclose(ours.numpy(), lsd_oracle(clean, noisy), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("t", [16000, 16384])
def test_lsd_a3_plain_matches_pallas_kernel(t):
    """A3's plain version against the JAX frame-blocked kernel at a small
    block, so that the kernel's several blocks and ragged last one are
    exercised on a short clip."""
    clean, noisy = _pairs(t / 16000, rows=2)
    clean, noisy = clean[:, :t], noisy[:, :t]
    ours = lsd_fused._lsd_framed_plain(torch.from_numpy(clean), torch.from_numpy(noisy), 256, 1e-8)
    theirs = jax_lsd_framed(clean, noisy, 512, 256, 1e-8, 8, "high", True)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("t", [16000, 16384])
def test_lsd_prescaled_matches_pallas_kernel(t):
    """``denoised_scale=None``: the caller has scaled; both take A2."""
    clean, noisy = _pairs(t / 16000, rows=2)
    clean, noisy = clean[:, :t], (0.8 * noisy[:, :t]).astype(np.float32)
    ours = lsd_fused.lsd_scores(torch.from_numpy(clean), torch.from_numpy(noisy), 512, 256, 1e-8, denoised_scale=None)
    theirs = jax_lsd_scores(clean, noisy, 512, 256, 1e-8, interpret=True, denoised_scale=None)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=2e-4, atol=2e-4)


def test_lsd_long_clip_routes_to_a3():
    """Past 1023 frames ``lsd_scores`` takes A3's route, with A2's value."""
    t = 256 * 1030 + 7
    rs = np.random.RandomState(3)
    c = torch.tensor(rs.randn(1, t), dtype=torch.float32)
    d = 0.6 * c + torch.tensor(rs.randn(1, t), dtype=torch.float32)
    routes = []
    real = lsd_fused.lsd_framed
    lsd_fused.lsd_framed = lambda *a: routes.append("A3") or real(*a)
    try:
        got = lsd_fused.lsd_scores(c, d, 512, 256, 1e-8)
    finally:
        lsd_fused.lsd_framed = real
    assert routes == ["A3"]
    scale = torch.sum(c * d, dim=1) / (torch.sum(d * d, dim=1) + 1e-8)
    want = lsd_fused._lsd_wholesig_plain(c, d * scale[:, None], 256, 1e-8)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_lsd_kernel_wrapper_rejects_other_devices():
    x = torch.zeros(1, 512, device="meta")
    for wrapper in (lsd_fused.lsd_wholesig_raw, lsd_fused.lsd_wholesig, lsd_fused.lsd_framed):
        with pytest.raises(ValueError, match="device"):
            wrapper(x, x, 256, 1e-8)


@pytest.mark.parametrize("t", [256 * 16, 256 * 40])
def test_lsd_ct_plain_matches_pallas_kernel(t):
    """A13's plain version against the JAX factorized kernel in interpret
    mode, on noise pairs (A2's precedent: the JAX chunk DFT is bf16x3)."""
    clean, noisy = _noise_pairs(t, seed=4)
    ours = lsd_fused.lsd_scores(torch.from_numpy(clean), torch.from_numpy(noisy), 512, 256, 1e-8, dft_impl="ct")
    theirs = jax_lsd_scores(clean, noisy, 512, 256, 1e-8, interpret=True, denoised_scale="auto", dft_impl="ct")
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("scale", [None, (0.8, 1.3)])
def test_lsd_ct_plain_matches_dense_on_speech(scale):
    """The factorized DFT is the dense chunk DFT reassociated: A13's plain
    version against A1's (a computed scale) or A2's (a given one)."""
    clean, noisy = _pairs(256 * 64 / 16000, rows=2)
    ct, nt = torch.from_numpy(clean), torch.from_numpy(noisy)
    given = "auto" if scale is None else torch.tensor(scale)
    got = lsd_fused.lsd_scores(ct, nt, 512, 256, 1e-8, denoised_scale=given, dft_impl="ct")
    want = lsd_fused.lsd_scores(ct, nt, 512, 256, 1e-8, denoised_scale=given)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("seed", [0, 1])
def test_lsd_ct_fft_reference_matches_rfft(seed):
    """A13's chunk FFT on the card as a torch dataflow
    (``_ct_fft_reference``: the three folds, a DFT8 over n1, the W64
    twiddles, the first half of a DFT8 over n2), run in float32 on speech
    chunks and on noise, against ``torch.fft.rfft`` of the zero-padded
    chunks in float64: within 1e-5 of max|X| (float32 round-off is about
    1e-7), the Nyquist bin included."""
    clean, noisy = _pairs(256 * 16 / 16000, rows=2, seed=seed)
    rs = np.random.RandomState(seed)
    chunks = torch.from_numpy(np.concatenate([clean, noisy, rs.randn(2, 256 * 16).astype(np.float32)]))
    chunks = chunks.reshape(6, 16, 256)
    zre, zim, nyq = lsd_fused._ct_fft_reference(chunks)
    want = torch.fft.rfft(torch.nn.functional.pad(chunks.double(), (0, 256)), dim=-1)
    scale = want.abs().max().item()
    for got, exact in ((zre, want.real[..., :256]), (zim, want.imag[..., :256]), (nyq[..., 0], want.real[..., 256])):
        assert (got.double() - exact).abs().max().item() <= 1e-5 * scale


@pytest.mark.parametrize("t,scale", [(256 * 16, None), (256 * 40, None), (256 * 16, (0.8, 1.3, 1.0))])
def test_lsd_ct_fft_reference_matches_pallas_kernel(t, scale):
    """The scores of A13's FFT dataflow (``_lsd_ct_fft_reference``) against
    the JAX factorized kernel in interpret mode, with the scale computed or
    given, rtol/atol 2e-4."""
    clean, noisy = _noise_pairs(t, seed=6)
    given = None if scale is None else torch.tensor(scale)[:, None]
    ours = lsd_fused._lsd_ct_fft_reference(torch.from_numpy(clean), torch.from_numpy(noisy), 256, 1e-8, given)
    theirs = jax_lsd_scores(clean, noisy, 512, 256, 1e-8, interpret=True,
                            denoised_scale="auto" if scale is None else np.asarray(scale, np.float32), dft_impl="ct")
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=2e-4, atol=2e-4)


def test_lsd_ct_tables_are_jax_tables():
    from fast_speech_enhancement_metrics_tpu.ops.lsd_fused import _ct_constants as jax_ct_constants

    for ours, theirs in zip(lsd_fused._ct_constants(), jax_ct_constants()):
        np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("t,scale,want", [
    (256 * 16, "auto", "A13"),
    (256 * 16, "tensor", "A13"),
    (256 * 16, None, "A2"),  # pre-scaled: no scale to apply
    (256 * 12, "auto", "A1"),  # 12 chunks: not a multiple of 8
    (256 * 16 + 5, "auto", "A2"),  # not hop-aligned
    (256 * 1024, "auto", "A1"),  # F + 1 = 1026 frames, past MAX_WHOLESIG_CHUNKS
])
def test_lsd_ct_route_follows_jax_conditions(t, scale, want):
    """``dft_impl="ct"`` takes A13 only where the JAX package takes its
    factorized kernel; elsewhere the dense routes."""
    c = torch.zeros(1, t)
    given = torch.ones(1) if scale == "tensor" else scale
    routes = []
    names = {"lsd_wholesig_ct": "A13", "lsd_wholesig_raw": "A1", "lsd_wholesig": "A2", "lsd_framed": "A3"}
    real = {name: getattr(lsd_fused, name) for name in names}
    for name, kid in names.items():
        setattr(lsd_fused, name, lambda *a, kid=kid, **k: routes.append(kid) or torch.zeros(1))
    try:
        lsd_fused.lsd_scores(c, c, 512, 256, 1e-8, denoised_scale=given, dft_impl="ct")
    finally:
        for name, fn in real.items():
            setattr(lsd_fused, name, fn)
    assert routes == [want]
    with pytest.raises(ValueError, match="dft_impl"):
        lsd_fused.lsd_scores(c, c, 512, 256, 1e-8, dft_impl="fft")


def _near_clean(clean, seed=0):
    """clean + 1e-3 max|clean| Gaussian noise (torch.Generator ``seed``):
    a pair whose log ratios sit near 0, where the chunk DFT's precision
    class shows."""
    c = torch.from_numpy(clean)
    g = torch.Generator().manual_seed(seed)
    return (c + 1e-3 * c.abs().max() * torch.randn(c.shape, generator=g)).numpy()


def test_lsd_tile_table_is_float64_build():
    """The frame-tile kernel's table: tile t's rows [re 64 | im 64] are the
    cos / sin columns of bins 62 t - 1 .. 62 t + 62, straight from the DFT
    formula in float64, bit for bit; its bins 0..255 are the plain
    version's packed table."""
    from fast_speech_enhancement_metrics_tpu_torch.ops.dft import _chunk_rdft_matrix_packed

    table = lsd_fused._tile_table()
    assert table.shape == (640, 256) and table.dtype == np.float32
    n = np.arange(256, dtype=np.float64)
    packed = _chunk_rdft_matrix_packed(512)
    for t in range(5):
        for j in range(64):
            k = 62 * t - 1 + j
            np.testing.assert_array_equal(table[128 * t + j], np.cos(-2.0 * np.pi * n * k / 512).astype(np.float32))
            np.testing.assert_array_equal(table[128 * t + 64 + j], np.sin(-2.0 * np.pi * n * k / 512).astype(np.float32))
            if 0 <= k < 256:
                np.testing.assert_array_equal(table[128 * t + j], packed[:, k])
                np.testing.assert_array_equal(table[128 * t + 64 + j], packed[:, 256 + k])


def test_lsd_tile_table_pieces_add_back():
    """Its three bf16 pieces add back to the float32 table within one ulp."""
    table = lsd_fused._tile_table()
    pieces = lsd_fused._tile_table_pieces()
    assert pieces.shape == (3, 640, 256) and pieces.dtype == torch.bfloat16
    back = pieces.double().sum(dim=0).numpy()
    assert np.all(np.abs(back - table) <= np.spacing(np.abs(table)))
    # each piece is what remains after the ones before it, rounded
    p0, p1, p2 = (p.double().numpy() for p in pieces)
    assert np.all(np.abs(p1) <= np.spacing(np.abs(p0).astype(np.float32)) * 2**16)
    assert np.all(np.abs(p2) <= np.abs(p1) * 2.0**-7)


@pytest.mark.parametrize("scaled", [False, True])
def test_lsd_split_pieces_plain(scaled):
    """The split's plain version: six planes [c0, c1, c2, d0, d1, d2], zeros
    past T, each signal's three pieces adding back to it exactly (for these
    normal floats); with ``eps`` the denoised signal scaled by the sixteen
    slice partials added in order."""
    clean, noisy = _noise_pairs(1000, rows=2, seed=5)
    c, d = torch.from_numpy(clean), torch.from_numpy(noisy)
    pieces, partial = lsd_fused.split_pieces(c, d, 1024, 1e-8 if scaled else None)
    assert pieces.shape == (6, 2, 1024) and pieces.dtype == torch.bfloat16
    assert torch.all(pieces[:, :, 1000:] == 0)
    want_d = d
    if scaled:
        assert partial.shape == (2, 16, 2)
        torch.testing.assert_close(partial.sum(dim=1)[:, 0], torch.sum(c * d, dim=1), rtol=1e-5, atol=1e-4)
        scale = lsd_fused._scale_from_partials(partial, 1e-8)
        torch.testing.assert_close(scale[:, 0], torch.sum(c * d, dim=1) / torch.sum(d * d, dim=1), rtol=1e-5, atol=0)
        want_d = d * scale
    else:
        assert partial is None
    back = pieces.double().reshape(2, 3, 2, 1024).sum(dim=1)[..., :1000]
    assert torch.equal(back[0], c.double()) and torch.equal(back[1], want_d.double())


#: (samples, scaled before the kernel, near-clean pair): A1's main shape and
#: its group boundaries (F = 127, 128 and 254 frames), A2's unaligned
#: shapes down to a clip shorter than a hop, and the near-clean pairs
TILE_CASES = [
    (16 * 16000, False, False),
    (256 * 126, False, False),
    (256 * 127, False, False),
    (256 * 253, False, False),
    (16 * 16000 + 100, True, False),
    (1000, True, False),
    (100, True, False),
    (16 * 16000, False, True),
    (16 * 16000 + 100, True, True),
]


@pytest.mark.parametrize("t,scaled,near_clean", TILE_CASES)
def test_lsd_tile_dataflow_matches_plain(t, scaled, near_clean):
    """The CUDA frame-tile kernel's dataflow in torch (``_lsd_tiles_reference``,
    from the wrapper's own split and table): bf16x6 chunk products, 62
    output bins + 2 halo bins a tile, the absolute bin's sign, five
    partials per frame added in tile order and the finalize, against A1's
    (raw pairs, the scale from the split's partials) or A2's (pre-scaled
    pairs) plain version, atol 2e-4 (about 1e-5 is expected)."""
    clean, noisy = _pairs(t / 16000 + 0.01, rows=2)
    clean = np.ascontiguousarray(clean[:, :t])
    noisy = _near_clean(clean) if near_clean else np.ascontiguousarray(noisy[:, :t])
    c, d = torch.from_numpy(clean), torch.from_numpy(noisy)
    row_len = -(-t // 256) * 256
    if scaled:
        scale = torch.sum(c * d, dim=1, keepdim=True) / (torch.sum(d * d, dim=1, keepdim=True) + 1e-8)
        d = d * scale
        want = lsd_fused._lsd_wholesig_plain(c, d, 256, 1e-8)
        pieces, _ = lsd_fused.split_pieces(c, d, row_len)
    else:
        want = lsd_fused._lsd_wholesig_raw_plain(c, d, 256, 1e-8)
        pieces, _ = lsd_fused.split_pieces(c, d, row_len, 1e-8)
    got = lsd_fused._lsd_tiles_reference(pieces, t, 1e-8)
    assert got.shape == (2,) and bool(torch.all(torch.isfinite(got)))
    torch.testing.assert_close(got, want, rtol=0, atol=2e-4)

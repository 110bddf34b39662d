"""PyTorch port, CUDA kernels against their plain versions on the card.

Marked ``cuda``: these need an NVIDIA GPU and skip elsewhere. On a machine
with a card run them as

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

(``--noconftest`` leaves out tests/conftest.py, which sets up JAX; this
file needs only PyTorch and the port.)

Small shapes; the main-path shapes are held by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

from fast_speech_enhancement_metrics_tpu_torch import LSD, SDR, STOI, SpeechBERTScore
from fast_speech_enhancement_metrics_tpu_torch.models import hubert
from fast_speech_enhancement_metrics_tpu_torch.models.hubert import HubertConfig, init_params
from fast_speech_enhancement_metrics_tpu_torch.ops import (
    attn_block_pallas,
    conv_gelu,
    cuda_lib,
    levinson_pallas,
    lsd_fused,
    numerics,
    pos_conv,
    relpos_attention,
    sdpa_pallas,
    sdr_corr_fused,
    sdr_corr_gram,
    stoi_fused,
    toeplitz,
)
from fast_speech_enhancement_metrics_tpu_torch.ops.numerics import LOG2E
from fast_speech_enhancement_metrics_tpu_torch.utils.audio import load_audio_data

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _audio(dev, rows=3, t=32768, seed=0):
    rs = np.random.RandomState(seed)
    c = rs.randn(rows, t).astype(np.float32)
    d = (0.7 * c + 0.5 * rs.randn(rows, t)).astype(np.float32)
    return torch.from_numpy(c).to(dev), torch.from_numpy(d).to(dev)


def test_lsd_kernel_matches_plain(dev):
    c, d = _audio(dev)
    before = cuda_lib.launch_counts[lsd_fused.KERNEL]
    got = lsd_fused.lsd_wholesig_raw(c, d, 256, 1e-8)
    assert cuda_lib.launch_counts[lsd_fused.KERNEL] == before + 1
    want = lsd_fused._lsd_wholesig_raw_plain(c, d, 256, 1e-8)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("split", ["x4", "x3", "x1"])
@pytest.mark.parametrize("t", [32768, 7000, 150])
def test_corr_kernel_matches_plain(dev, t, split):
    """A4 in each split mode against its plain version (the plain
    correlation summed over the bf16 halves for x3 and x1), counted under
    the mode's own name."""
    c, d = _audio(dev, t=t)
    before = dict(cuda_lib.launch_counts)
    ra, rc = sdr_corr_gram.correlation_lags_gram(c, d, 512, split)
    assert {k: cuda_lib.launch_counts[k] - before.get(k, 0) for k in sdr_corr_gram.KERNELS.values()} == {
        k: int(s == split) for s, k in sdr_corr_gram.KERNELS.items()}
    pa, pc = sdr_corr_gram._correlation_lags_plain(c, d, 512, split)
    scale = pa.abs().max().item()
    torch.testing.assert_close(ra, pa, rtol=0, atol=2e-4 * scale)
    torch.testing.assert_close(rc, pc, rtol=0, atol=2e-4 * scale)


#: SDR's main shape (16 s at 16 kHz), its unaligned neighbours and a clip
#: shorter than the five frames of the Gram's shifts
CORR_LENGTHS = [16 * 16000, 16 * 16000 + 100, 16 * 16000 + 37, 500]


def _twice_equal(fn, *args):
    """Two launches give the same bits; returns the first result."""
    first = [x.clone() for x in fn(*args)]
    second = fn(*args)
    for a, b in zip(first, second):
        assert torch.equal(a, b), "two launches differ"
    return first


@pytest.mark.parametrize("split", ["x4", "x3", "x1"])
@pytest.mark.parametrize("t", CORR_LENGTHS)
@pytest.mark.parametrize("rows", [1, 64])
def test_corr_kernel_main_shapes(dev, rows, t, split):
    """A4 on the tensor cores at SDR's shapes: one launch under the mode's
    own counter per call, 2e-4 of max|r_auto| from its plain version (x4:
    the float32 correlation, so the four-term bf16 class), bit-identical
    from launch to launch."""
    c, d = _audio(dev, rows=rows, t=t, seed=rows + t)
    before = dict(cuda_lib.launch_counts)
    ra, rc = _twice_equal(sdr_corr_gram.correlation_lags_gram, c, d, 512, split)
    assert {k: cuda_lib.launch_counts[k] - before.get(k, 0) for k in sdr_corr_gram.KERNELS.values()} == {
        k: 2 * int(s == split) for s, k in sdr_corr_gram.KERNELS.items()}
    pa, pc = sdr_corr_gram._correlation_lags_plain(c, d, 512, split)
    scale = pa.abs().max().item()
    torch.testing.assert_close(ra, pa, rtol=0, atol=2e-4 * scale)
    torch.testing.assert_close(rc, pc, rtol=0, atol=2e-4 * scale)


@pytest.mark.parametrize("lo", [True, False])
@pytest.mark.parametrize("t", [16 * 16000 + 37, 500])
def test_split_halves_kernel_is_plain(dev, t, lo):
    """The split pass of A4 and A10 writes the plain version's bf16 halves
    bit for bit, zeros past T (lo=False: the hi planes only)."""
    c, d = _audio(dev, rows=3, t=t, seed=t)
    row_len = -(-t // 512) * 512
    before = cuda_lib.launch_counts[sdr_corr_gram.KERNEL_SPLIT]
    got = sdr_corr_gram.split_halves(c, d, row_len, lo)
    assert cuda_lib.launch_counts[sdr_corr_gram.KERNEL_SPLIT] == before + 1
    want = sdr_corr_gram._split_halves_plain(c, d, row_len)
    planes = [0, 1, 2, 3] if lo else [0, 2]
    assert torch.equal(got[planes].view(torch.int16), want[planes].view(torch.int16))


@pytest.mark.parametrize("n", [128, 512])
def test_levinson_kernel_matches_plain(dev, n):
    rs = np.random.RandomState(11)
    r = (0.9 ** np.arange(n))[None] * rs.uniform(0.5, 20.0, (5, 1))
    r[:, 0] += 1.0
    b = rs.randn(5, n)
    r0 = torch.tensor(r, dtype=torch.float32, device=dev)
    bt = torch.tensor(b, dtype=torch.float32, device=dev)
    got = levinson_pallas.levinson_solve_fused(r0, bt)
    want = toeplitz.levinson_solve(r0, bt)
    torch.testing.assert_close(got, want, rtol=2e-3, atol=2e-3 * want.abs().max().item())


@pytest.mark.parametrize("variant", levinson_pallas.VARIANTS)
@pytest.mark.parametrize("n", [128, 512, 96])
def test_levinson_variant_kernels_match_plain(dev, variant, n):
    """A5 and the A14 variants against their plain versions (odd and even
    step counts for "double"); each counts under its own name."""
    rs = np.random.RandomState(12)
    r = (0.9 ** np.arange(n))[None] * rs.uniform(0.5, 20.0, (5, 1))
    r[:, 0] += 1.0
    r0 = torch.tensor(r, dtype=torch.float32, device=dev)
    bt = torch.tensor(rs.randn(5, n), dtype=torch.float32, device=dev)
    kname = levinson_pallas.KERNELS[variant]
    before = cuda_lib.launch_counts[kname]
    got = levinson_pallas.levinson_solve_fused(r0, bt, variant=variant)
    assert cuda_lib.launch_counts[kname] == before + 1
    want = levinson_pallas.levinson_solve_fused(r0.cpu(), bt.cpu(), variant=variant).to(dev)
    torch.testing.assert_close(got, want, rtol=2e-3, atol=2e-3 * want.abs().max().item())
    if variant in ("flat", "flat_u4", "flat_u8"):  # one recursion, only unrolled; A5 sums in another order
        assert torch.equal(got, levinson_pallas.levinson_solve_fused(r0, bt, variant="flat"))
        a5 = levinson_pallas.levinson_solve_fused(r0, bt)
        assert (a5 - got).abs().max().item() <= 2e-3 * got.abs().max().item()


def test_stoi_kernel_matches_plain(dev):
    rs = np.random.RandomState(5)
    tob_c = torch.tensor(np.abs(rs.randn(3, 300, 15)), dtype=torch.float32, device=dev)
    tob_d = tob_c + torch.tensor(np.abs(rs.randn(3, 300, 15)), dtype=torch.float32, device=dev)
    nseg = torch.tensor([271, 200, 3], dtype=torch.int32, device=dev)
    s, e = stoi_fused.stoi_segment_sums(tob_c, tob_d, nseg)
    ps, pe = stoi_fused._stoi_segment_sums_plain(tob_c, tob_d, nseg, 30, 15)
    per = nseg.float()
    torch.testing.assert_close(s / 15 / per, ps / 15 / per, rtol=0, atol=5e-4)
    torch.testing.assert_close(e / 30 / per, pe / 30 / per, rtol=0, atol=5e-4)


@pytest.mark.parametrize("batch", [1, 64])
@pytest.mark.parametrize("n", [96, 128, 512, 1024])
def test_levinson_warp_kernel_main_shapes(dev, n, batch):
    """A5 (one warp per system) at SDR's order and around it: one launch,
    within 2e-3 of max|x| of the plain version, two launches bit-equal, and
    bit for bit its warp-order reference run on the card."""
    rs = np.random.RandomState(15)
    r = (0.9 ** np.arange(n))[None] * rs.uniform(0.5, 20.0, (batch, 1))
    r[:, 0] += 1.0
    r0 = torch.tensor(r, dtype=torch.float32, device=dev)
    bt = torch.tensor(rs.randn(batch, n), dtype=torch.float32, device=dev)
    before = cuda_lib.launch_counts[levinson_pallas.KERNEL]
    got = levinson_pallas.levinson_solve_fused(r0, bt)
    assert cuda_lib.launch_counts[levinson_pallas.KERNEL] == before + 1
    want = toeplitz.levinson_solve(r0, bt)
    torch.testing.assert_close(got, want, rtol=2e-3, atol=2e-3 * want.abs().max().item())
    assert torch.equal(got, levinson_pallas.levinson_solve_fused(r0, bt))
    assert torch.equal(got, levinson_pallas._levinson_warp_order_reference(r0, bt))


@pytest.mark.parametrize("variant", [v for v in levinson_pallas.VARIANTS if v != "vpu"])
@pytest.mark.parametrize("n", [96, 128, 512, 1024])
def test_levinson_a14_kernels_are_their_twins(dev, n, variant):
    """Each A14 kernel (one warp per system, as A5) at SDR's order and
    around it: one launch of its own counter, bit for bit its torch twin
    (``_warp_twin``) run on the card, two launches bit-equal, within 2e-3
    of max|x| of its plain version; "dotreduce" also bit for bit A5."""
    rs = np.random.RandomState(19)
    r = (0.9 ** np.arange(n))[None] * rs.uniform(0.5, 20.0, (8, 1))
    r[:, 0] += 1.0
    r0 = torch.tensor(r, dtype=torch.float32, device=dev)
    bt = torch.tensor(rs.randn(8, n), dtype=torch.float32, device=dev)
    kname = levinson_pallas.KERNELS[variant]
    before = cuda_lib.launch_counts[kname]
    got = levinson_pallas.levinson_solve_fused(r0, bt, variant=variant)
    assert cuda_lib.launch_counts[kname] == before + 1
    assert torch.equal(got, levinson_pallas.levinson_solve_fused(r0, bt, variant=variant))
    assert torch.equal(got, levinson_pallas._warp_twin(variant)(r0, bt))
    want = levinson_pallas._plain(variant)(r0, bt)
    torch.testing.assert_close(got, want, rtol=2e-3, atol=2e-3 * want.abs().max().item())
    if variant == "dotreduce":
        assert torch.equal(got, levinson_pallas.levinson_solve_fused(r0, bt))


@pytest.mark.parametrize("frames", [300, 1247])
def test_stoi_kernel_ragged_segments(dev, frames):
    """A6 on rows whose segment counts are 0, end mid-tile, fill every
    position and are 3: within 5e-4 per segment of the plain version and of
    its two-stage dataflow, two launches bit-equal, and the same bits when
    every frame past a row's last segment is NaN or inf (a tile past the
    row's last segment exits early, a later segment of a live tile is
    skipped)."""
    rs = np.random.RandomState(6)
    rows = 64 if frames > 1000 else 4
    tob_c = torch.tensor(np.abs(rs.randn(rows, frames, 15)), dtype=torch.float32, device=dev)
    tob_d = tob_c + torch.tensor(np.abs(rs.randn(rows, frames, 15)), dtype=torch.float32, device=dev)
    full = frames - 29
    nseg = torch.tensor(([0, 100, full, 3] * (rows // 4)), dtype=torch.int32, device=dev)
    before = cuda_lib.launch_counts[stoi_fused.KERNEL]
    s, e = stoi_fused.stoi_segment_sums(tob_c, tob_d, nseg)
    assert cuda_lib.launch_counts[stoi_fused.KERNEL] == before + 1
    s2, e2 = stoi_fused.stoi_segment_sums(tob_c, tob_d, nseg)
    assert torch.equal(s, s2) and torch.equal(e, e2)
    per = torch.clamp(nseg, min=1).float()
    for ws, we in (stoi_fused._stoi_segment_sums_plain(tob_c, tob_d, nseg, 30, 15),
                   stoi_fused._stoi_two_stage_reference(tob_c, tob_d, nseg)):
        torch.testing.assert_close(s / 15 / per, ws / 15 / per, rtol=0, atol=5e-4)
        torch.testing.assert_close(e / 30 / per, we / 30 / per, rtol=0, atol=5e-4)
    assert s[0].item() == 0.0 and e[0].item() == 0.0
    poisoned_c, poisoned_d = tob_c.clone(), tob_d.clone()
    for row, count in enumerate(nseg.tolist()):
        poisoned_c[row, count + 29:], poisoned_d[row, count + 29:] = float("nan"), float("inf")
    s3, e3 = stoi_fused.stoi_segment_sums(poisoned_c, poisoned_d, nseg)
    assert torch.equal(s3, s) and torch.equal(e3, e)


@pytest.mark.parametrize("t", [32768 + 7, 16100, 300])
def test_lsd_a2_a3_kernels_match_plain(dev, t):
    c, d = _audio(dev, t=t)
    for wrapper, plain, kname in (
        (lsd_fused.lsd_wholesig, lsd_fused._lsd_wholesig_plain, lsd_fused.KERNEL_A2),
        (lsd_fused.lsd_framed, lsd_fused._lsd_framed_plain, lsd_fused.KERNEL_A3),
    ):
        before = cuda_lib.launch_counts[kname]
        got = wrapper(c, d, 256, 1e-8)
        assert cuda_lib.launch_counts[kname] == before + 1
        torch.testing.assert_close(got, plain(c, d, 256, 1e-8), rtol=2e-4, atol=2e-4)


#: the frame-tile kernel's shapes: A1's main shape and its group boundaries
#: (F = 127, 128 and 254 frames), A2's main shape, A3's (20 s + 100), and
#: clips shorter than a hop
LSD_TILE_LENGTHS = [16 * 16000, 256 * 126, 256 * 127, 256 * 253, 16 * 16000 + 100, 20 * 16000 + 100, 200]


def _lsd_twice_equal(fn, *args):
    """Two launches give the same bits; returns the first result."""
    first = fn(*args).clone()
    assert torch.equal(first, fn(*args)), "two launches differ"
    return first


@pytest.mark.parametrize("t", LSD_TILE_LENGTHS)
@pytest.mark.parametrize("rows", [1, 64])
def test_lsd_tile_kernel_main_shapes(dev, rows, t):
    """A1 (hop-aligned raw pairs), A2 and A3 on the tensor-core frame-tile
    kernel: one launch of each wrapper's counter per call, rtol/atol 2e-4
    from its plain version and from the kernel's dataflow in torch
    (``_lsd_tiles_reference``), bit-identical from launch to launch."""
    c, d = _audio(dev, rows=rows, t=t, seed=rows + t)
    cases = [(lsd_fused.lsd_wholesig, lsd_fused._lsd_wholesig_plain, lsd_fused.KERNEL_A2, None),
             (lsd_fused.lsd_framed, lsd_fused._lsd_framed_plain, lsd_fused.KERNEL_A3, None)]
    if t % 256 == 0:
        cases.append((lsd_fused.lsd_wholesig_raw, lsd_fused._lsd_wholesig_raw_plain, lsd_fused.KERNEL, 1e-8))
    row_len = -(-t // 256) * 256
    for wrapper, plain, kname, split_eps in cases:
        before = cuda_lib.launch_counts[kname]
        got = _lsd_twice_equal(wrapper, c, d, 256, 1e-8)
        assert cuda_lib.launch_counts[kname] == before + 2
        torch.testing.assert_close(got, plain(c, d, 256, 1e-8), rtol=2e-4, atol=2e-4)
        pieces, _ = lsd_fused.split_pieces(c, d, row_len, split_eps)
        torch.testing.assert_close(got, lsd_fused._lsd_tiles_reference(pieces, t, 1e-8), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("t", [16 * 16000, 16 * 16000 + 100])
def test_lsd_tile_kernel_near_clean_pair(dev, t):
    """A near-clean pair (speech + 1e-3 max|speech| Gaussian noise,
    torch.Generator seed 0), where the chunk DFT's precision class shows:
    A1 (hop-aligned) or A2 and A3 within atol 2e-4 of their plain versions."""
    clean, _, _ = load_audio_data(t / 16000 + 0.01, 4, 16000)
    c = torch.from_numpy(np.ascontiguousarray(clean[:, :t]))
    g = torch.Generator().manual_seed(0)
    d = (c + 1e-3 * c.abs().max() * torch.randn(c.shape, generator=g)).to(dev)
    c = c.to(dev)
    if t % 256 == 0:
        cases = [(lsd_fused.lsd_wholesig_raw, lsd_fused._lsd_wholesig_raw_plain)]
    else:
        cases = [(lsd_fused.lsd_wholesig, lsd_fused._lsd_wholesig_plain),
                 (lsd_fused.lsd_framed, lsd_fused._lsd_framed_plain)]
    for wrapper, plain in cases:
        torch.testing.assert_close(wrapper(c, d, 256, 1e-8), plain(c, d, 256, 1e-8), rtol=0, atol=2e-4)


@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("t", [16 * 16000 + 37, 500])
def test_lsd_split_kernel_is_plain(dev, t, scaled):
    """The three-piece split pass of A1-A3 writes the plain version's bf16
    pieces bit for bit, zeros past T; with A1's scale, d scaled by the
    sixteen partials (returned by the kernel) added in order."""
    c, d = _audio(dev, rows=3, t=t, seed=t)
    row_len = -(-t // 256) * 256
    before = cuda_lib.launch_counts[lsd_fused.KERNEL_SPLIT]
    got, partial = lsd_fused.split_pieces(c, d, row_len, 1e-8 if scaled else None)
    assert cuda_lib.launch_counts[lsd_fused.KERNEL_SPLIT] == before + 1
    scale = lsd_fused._scale_from_partials(partial.cpu(), 1e-8) if scaled else None
    want = lsd_fused._split_pieces_plain(c.cpu(), d.cpu(), row_len, scale)
    assert torch.equal(got.cpu().view(torch.int16), want.view(torch.int16))


def _lsd_f64(c, d_scaled, hop=256, eps=1e-8):
    """LSD of pre-scaled pairs in float64: framed rfft of the centered,
    periodic-Hann-windowed frames."""
    c, d_scaled = c.double(), d_scaled.double()
    t = c.shape[1]
    frames = 1 + t // hop
    win = torch.hann_window(2 * hop, periodic=True, dtype=torch.float64, device=c.device)

    def power(x):
        xp = torch.nn.functional.pad(x, (hop, (frames + 1) * hop - t - hop))
        return torch.fft.rfft(xp.unfold(-1, 2 * hop, hop)[:, :frames] * win, dim=-1).abs() ** 2

    dm = torch.sqrt(power(d_scaled)) + eps
    lr = torch.log(power(c) / (dm * dm) + eps)
    return torch.sqrt(torch.mean(lr * lr, dim=-1)).mean(dim=-1)


@pytest.mark.parametrize("t,scale", [(256 * 64, None), (256 * 64, "given"), (256 * 8, None), (256 * 1016, None)])
def test_lsd_ct_kernel_matches_plain(dev, t, scale):
    """A13 (the float32 FFT kernel) against its plain version and against
    A1 (or A2 with a given scale), rtol/atol 2e-4, two launches bit-equal;
    on near-clean pairs of three noise seeds (c + 1e-3 max|c| noise) also
    within 2e-4 of a float64 LSD."""
    c, d = _audio(dev, t=t)
    given = None if scale is None else torch.tensor([0.7, 1.0, 1.3], device=dev)
    before = cuda_lib.launch_counts[lsd_fused.KERNEL_A13]
    got = lsd_fused.lsd_wholesig_ct(c, d, 256, 1e-8, given)
    assert cuda_lib.launch_counts[lsd_fused.KERNEL_A13] == before + 1
    assert torch.equal(got, lsd_fused.lsd_wholesig_ct(c, d, 256, 1e-8, given))
    want = lsd_fused._lsd_wholesig_ct_plain(c, d, 256, 1e-8, None if given is None else given[:, None])
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
    dense = (lsd_fused.lsd_wholesig_raw(c, d, 256, 1e-8) if given is None
             else lsd_fused.lsd_wholesig(c, d * given[:, None], 256, 1e-8))
    torch.testing.assert_close(got, dense, rtol=2e-4, atol=2e-4)
    for seed in range(3):
        g = torch.Generator().manual_seed(seed)
        near = (c + 1e-3 * c.abs().max() * torch.randn(c.shape, generator=g).to(dev)).contiguous()
        got = lsd_fused.lsd_wholesig_ct(c, near, 256, 1e-8, given)
        assert torch.equal(got, lsd_fused.lsd_wholesig_ct(c, near, 256, 1e-8, given))
        s_ = (given[:, None] if given is not None else
              torch.sum(c * near, dim=1, keepdim=True) / (torch.sum(near * near, dim=1, keepdim=True) + 1e-8))
        want = lsd_fused._lsd_wholesig_ct_plain(c, near, 256, 1e-8, s_)
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
        torch.testing.assert_close(got.double(), _lsd_f64(c, near * s_), rtol=0, atol=2e-4)


def _block_params(d, ffn, seed, qk_scale=0.12):
    rs = np.random.RandomState(seed)
    p = {k: rs.randn(d, d) * (qk_scale if k in ("q_w", "k_w") else 0.05) for k in ("q_w", "k_w", "v_w", "o_w")}
    p.update({k: rs.randn(d) * 0.1 for k in ("q_b", "k_b", "v_b", "o_b", "ff_b2")})
    p.update(ff_w1=rs.randn(d, ffn) * 0.05, ff_b1=rs.randn(ffn) * 0.1, ff_w2=rs.randn(ffn, d) * 0.05,
             ln1_s=1 + 0.1 * rs.randn(d), ln1_b=0.1 * rs.randn(d), ln2_s=1 + 0.1 * rs.randn(d), ln2_b=0.1 * rs.randn(d))
    return {k: torch.tensor(v, dtype=torch.float32) for k, v in p.items()}


def _bf16_class(got, want):
    """The JAX block tests' bf16 class: max abs 3e-2, median abs 1e-3."""
    diff = (got.float() - want.float()).abs()
    assert diff.max().item() <= 3e-2 and diff.median().item() <= 1e-3, (diff.max().item(), diff.median().item())


def _context_class(got, want):
    """The bf16 class per query row of an attention context, each error over
    its row's max|want|: a context is a weighted mean of v, far below the
    ~1 of a LayerNorm output in most rows."""
    row = want.float().abs().amax(-1, keepdim=True)
    rel = (got.float() - want.float()).abs() / row
    assert rel.max().item() <= 3e-2 and rel.median().item() <= 1e-3, (rel.max().item(), rel.median().item())


@pytest.mark.parametrize("softmax", ["exp2", "exact", "exp2_bf16"])
@pytest.mark.parametrize("t", [43, 130, 799])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attn_block_kernel_matches_plain(dev, softmax, t, dtype):
    """Heads of 64; M = 2 T rows of the products is no multiple of their
    128-row tiles, and T = 799 (the main path's) leaves the attention's last
    128-query tile ragged."""
    d, heads = 128, 2
    p = _block_params(d, 256, seed=t)
    x = torch.tensor(np.random.RandomState(1).randn(2, t, d), dtype=dtype)
    packed = attn_block_pallas.pack_attn_block_params(p, heads, softmax)
    before = cuda_lib.launch_counts[attn_block_pallas.KERNEL_A7]
    got = attn_block_pallas.attn_block(x.to(dev), tuple(a.to(dev) for a in packed), heads, 1e-5, softmax=softmax)
    assert cuda_lib.launch_counts[attn_block_pallas.KERNEL_A7] == before + 1
    assert got.dtype == dtype
    _bf16_class(got.cpu(), attn_block_pallas.attn_block(x, packed, heads, 1e-5, softmax=softmax))


@pytest.mark.parametrize("d,heads", [(64, 2), (160, 2), (96, 1), (96, 8)])
def test_attn_block_kernel_any_head_width(dev, d, heads):
    """Heads of 32, 80, 96 and 12 (not a multiple of 8: q, k, v and the
    context go through zero-padded copies to the same attention kernel)."""
    p = _block_params(d, 128, seed=d)
    x = torch.tensor(np.random.RandomState(4).randn(2, 70, d), dtype=torch.float32)
    for softmax in ("exp2", "exact"):
        packed = attn_block_pallas.pack_attn_block_params(p, heads, softmax)
        before = cuda_lib.launch_counts[attn_block_pallas.KERNEL_A7]
        got = attn_block_pallas.attn_block(x.to(dev), tuple(a.to(dev) for a in packed), heads, 1e-5,
                                           softmax=softmax)
        assert cuda_lib.launch_counts[attn_block_pallas.KERNEL_A7] == before + 1
        _bf16_class(got.cpu(), attn_block_pallas.attn_block(x, packed, heads, 1e-5, softmax=softmax))


#: (d, heads): heads of 64, 80 (HuBERT-xlarge), 96 and 12 (not a multiple of
#: 8 or 16: the kernels' zero-padded paths)
HEAD_WIDTHS = [(128, 2), (160, 2), (96, 1), (96, 8)]


@pytest.mark.parametrize("softmax", ["exp2", "exact", "exp2_bf16"])
@pytest.mark.parametrize("t", [43, 130, 799])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,heads", HEAD_WIDTHS)
def test_attn_block_int8_kernel_matches_plain(dev, softmax, t, dtype, d, heads):
    """A12 against its plain version in the bf16 class (T = 43 and 130 are
    not multiples of 8: v's column scales cover |b_v|; 799, the main path's,
    leaves the last 128-key tile ragged), and against A7 in the JAX
    package's int8 screening class (max 0.5, median 0.05)."""
    p = _block_params(d, 256, seed=t + 1)
    x = torch.tensor(np.random.RandomState(6).randn(2, t, d), dtype=dtype)
    packed = attn_block_pallas.pack_attn_block_params(p, heads, softmax, quant="int8")
    before = cuda_lib.launch_counts[attn_block_pallas.KERNEL_A12]
    got = attn_block_pallas.attn_block(x.to(dev), tuple(a.to(dev) for a in packed), heads, 1e-5, softmax,
                                       quant="int8")
    assert cuda_lib.launch_counts[attn_block_pallas.KERNEL_A12] == before + 1
    assert got.dtype == dtype
    _bf16_class(got.cpu(), attn_block_pallas.attn_block(x, packed, heads, 1e-5, softmax, quant="int8"))
    a7 = attn_block_pallas.attn_block(x.to(dev), tuple(a.to(dev) for a in attn_block_pallas.pack_attn_block_params(
        p, heads, softmax)), heads, 1e-5, softmax)
    diff = (got.float() - a7.float()).abs()
    assert diff.max().item() < 0.5 and diff.median().item() < 0.05, (diff.max().item(), diff.median().item())


@pytest.mark.parametrize("softmax", ["exp2", "exact", "exp2_bf16"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,heads,t", [(128, 2, 43), (160, 2, 130), (96, 1, 70), (96, 8, 70)])
def test_layer_block_kernel_matches_plain_and_a7_a8(dev, softmax, dtype, d, heads, t):
    """A11 against A7 then A8 bit for bit (it chains their launches, LN1
    written once in bf16, which A8 rounds its input to anyway), heads of
    64, 80, 96 and 12; and against its plain version in the bf16 class."""
    p = _block_params(d, 256, seed=d + t)
    x = torch.tensor(np.random.RandomState(7).randn(3, t, d), dtype=dtype)
    attn_ops = tuple(a.to(dev) for a in attn_block_pallas.pack_attn_block_params(p, heads, softmax))
    ffn_ops = tuple(a.to(dev) for a in attn_block_pallas.pack_ffn_block_params(p))
    xd = x.to(dev)
    before = dict(cuda_lib.launch_counts)
    got = attn_block_pallas.layer_block(xd, attn_ops, ffn_ops, heads, 1e-5, softmax)
    counts = {k: cuda_lib.launch_counts[k] - before.get(k, 0) for k in (attn_block_pallas.KERNEL_A11,
                                                                        attn_block_pallas.KERNEL_A7,
                                                                        attn_block_pallas.KERNEL_A8)}
    assert counts == {attn_block_pallas.KERNEL_A11: 1, attn_block_pallas.KERNEL_A7: 0, attn_block_pallas.KERNEL_A8: 0}
    assert got.dtype == dtype
    separate = attn_block_pallas.ffn_block(attn_block_pallas.attn_block(xd, attn_ops, heads, 1e-5, softmax),
                                           ffn_ops, 1e-5)
    assert torch.equal(got, separate), (got.float() - separate.float()).abs().max().item()
    want = attn_block_pallas.layer_block(x, tuple(a.cpu() for a in attn_ops), tuple(a.cpu() for a in ffn_ops),
                                         heads, 1e-5, softmax)
    _bf16_class(got.cpu(), want)


@pytest.mark.parametrize("m,n,k", [(130, 2304, 768), (1000, 136, 96)])
def test_gemm_i8_kernel_matches_plain(dev, m, n, k):
    """A12's int8 GEMM alone against its plain version exactly: the integer
    products are exact and the dequantization ((acc sa) sb) + bias runs in
    the same fp32 steps. M, N and K not multiples of the tiles (128 x 256,
    k blocks of 128)."""
    rs = np.random.RandomState(m + n)
    a = torch.tensor(rs.randint(-127, 128, (m, k)), dtype=torch.int8, device=dev)
    b_t = torch.tensor(rs.randint(-127, 128, (n, k)), dtype=torch.int8, device=dev)
    sa = torch.tensor(rs.rand(m) * 1e-2, dtype=torch.float32, device=dev)
    sb = torch.tensor(rs.rand(n) * 1e-2, dtype=torch.float32, device=dev)
    bias = torch.tensor(rs.randn(n), dtype=torch.float32, device=dev)
    before = cuda_lib.launch_counts[attn_block_pallas.KERNEL_GEMM_I8]
    got = attn_block_pallas.gemm_i8(a, b_t, sa, sb, bias)
    assert cuda_lib.launch_counts[attn_block_pallas.KERNEL_GEMM_I8] == before + 1
    want = attn_block_pallas._gemm_i8_plain(a.cpu(), b_t.cpu(), sa.cpu(), sb.cpu(), bias.cpu())
    assert got.dtype == torch.float32 and got.shape == (m, n)
    assert torch.equal(got.cpu(), want)


_DIV_RN_CHECK = r"""
#include <cstdint>
#include "common.cuh"
// thread b: the significand b of [1, 2) against every a of [1, 2) in a0 .. a0 + n_a
__global__ void sweep(uint32_t a0, uint32_t n_a, unsigned long long* bad) {
  const float b = __uint_as_float(0x3f800000u | (blockIdx.x * blockDim.x + threadIdx.x)), r = __frcp_rn(b);
  unsigned n = 0;
  for (uint32_t i = a0; i < a0 + n_a; ++i) {
    const float a = __uint_as_float(0x3f800000u | i);
    n += fsem::div_rn(a, b, r) != __fdiv_rn(a, b);
  }
  if (n) atomicAdd(bad, n);
}
__global__ void pairs(const float* a, const float* b, int n, unsigned long long* bad) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n && fsem::div_rn(a[i], b[i], __frcp_rn(b[i])) != __fdiv_rn(a[i], b[i])) atomicAdd(bad, 1ull);
}
extern "C" int div_rn_sweep(uint32_t a0, uint32_t n_a, unsigned long long* bad) {
  sweep<<<(1 << 23) / 256, 256>>>(a0, n_a, bad);
  return cudaDeviceSynchronize();
}
extern "C" int div_rn_pairs(const float* a, const float* b, int n, unsigned long long* bad) {
  pairs<<<(n + 255) / 256, 256>>>(a, b, n, bad);
  return cudaDeviceSynchronize();
}
// every 32-bit pattern d: fsem::rcp_rn(d) has __frcp_rn(d)'s bits (NaN for NaN)
__global__ void rcp_sweep(uint32_t hi, unsigned long long* bad) {
  const uint32_t bits = (hi << 24) | (blockIdx.x * blockDim.x + threadIdx.x);
  const float d = __uint_as_float(bits), got = fsem::rcp_rn(d), want = __frcp_rn(d);
  const bool same = __float_as_uint(got) == __float_as_uint(want) || (got != got && want != want);
  if (!same) atomicAdd(bad, 1ull);
}
extern "C" int rcp_rn_sweep(unsigned long long* bad) {
  for (uint32_t hi = 0; hi < 256; ++hi) rcp_sweep<<<(1 << 24) / 256, 256>>>(hi, bad);
  return cudaDeviceSynchronize();
}
"""


@pytest.fixture(scope="module")
def div_rn_lib(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import ctypes
    import subprocess

    out = tmp_path_factory.mktemp("div_rn")
    (out / "check.cu").write_text(_DIV_RN_CHECK)
    subprocess.run([cuda_lib._nvcc(), *cuda_lib.COMPILE_FLAGS, "-shared", "-I", str(cuda_lib.CSRC_DIR),
                    str(out / "check.cu"), "-o", str(out / "check.so")], check=True, capture_output=True)
    lib = ctypes.CDLL(str(out / "check.so"))
    lib.div_rn_sweep.argtypes = (ctypes.c_uint32, ctypes.c_uint32, ctypes.c_void_p)
    lib.div_rn_pairs.argtypes = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p)
    lib.rcp_rn_sweep.argtypes = (ctypes.c_void_p,)
    return lib


def test_div_rn_is_fdiv_rn_on_every_significand_pair(div_rn_lib):
    """A12's divisions x / s and p / l (``common.cuh::div_rn``) round as
    ``__fdiv_rn`` for every pair of fp32 significands: a / b for every a and
    b of [1, 2), 2^46 pairs. A quotient of normal operands scales with them
    by powers of two, so this holds wherever the residual a - q b stays
    normal."""
    bad = torch.zeros(1, dtype=torch.int64, device="cuda")
    chunk = 1 << 16
    for a0 in range(0, 1 << 23, chunk):
        assert div_rn_lib.div_rn_sweep(a0, chunk, bad.data_ptr()) == 0
    assert bad.item() == 0


def test_rcp_rn_is_frcp_rn_on_every_input(div_rn_lib):
    """A5's reciprocal (``common.cuh::rcp_rn``, __frcp_rn's fast path
    without its branch) has __frcp_rn's bits on all 2^32 inputs."""
    bad = torch.zeros(1, dtype=torch.int64, device="cuda")
    assert div_rn_lib.rcp_rn_sweep(bad.data_ptr()) == 0
    assert bad.item() == 0


def test_div_rn_is_fdiv_rn_in_a12s_ranges(div_rn_lib):
    """The same on 2^24 random pairs of each of A12's two divisions at the
    scales they take, where the residual stays normal: x / s with s =
    max|x| / 127 from 1e-12 up, and p / l with p from the clamped exp2's
    2^-100 up and l the sum of up to 800 such p. (A smaller p, exact mode's
    tail, gives a quotient that quantizes to 0 either way.)"""
    gen = torch.Generator(device="cuda").manual_seed(11)
    n = 1 << 24

    def uniform(lo, hi):
        return lo + (hi - lo) * torch.rand(n, generator=gen, device="cuda")

    s = torch.exp2(uniform(-39.8, 40.0))
    x = s * 127 * uniform(-1.0, 1.0)
    p = torch.exp2(uniform(-100.0, 60.0))
    l = p * uniform(1.0, 800.0)
    for a, b in ((x, s), (p, l)):
        bad = torch.zeros(1, dtype=torch.int64, device="cuda")
        assert div_rn_lib.div_rn_pairs(a.data_ptr(), b.data_ptr(), n, bad.data_ptr()) == 0
        assert bad.item() == 0


def _qkv(dev, shape, dtype, seed=0):
    rs = np.random.RandomState(seed)
    return [torch.tensor(0.8 * rs.randn(*shape), dtype=dtype, device=dev) for _ in range(3)]


@pytest.mark.parametrize("softmax", ["exp2", "exp2_bf16", "exact"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [32, 64, 80, 128, 36])
@pytest.mark.parametrize("t", [37, 259, 2999])
def test_sdpa_kernel_matches_plain(dev, softmax, dtype, d, t):
    """Heads of 32, 64, 80 and 128 (one or two 64-column TMA boxes) and 36
    (bf16: zero-padded to 40 by the wrapper; float32: to 64 by the split
    pass); T under one key tile, ragged, and 2999 (a ring of stages walked
    many times)."""
    q, k, v = _qkv(dev, (2, 3, t, d), dtype)
    before = cuda_lib.launch_counts[sdpa_pallas.KERNEL_A9]
    got = sdpa_pallas.sdpa(q, k, v, d**-0.5, softmax=softmax)
    assert cuda_lib.launch_counts[sdpa_pallas.KERNEL_A9] == before + 1
    assert got.dtype == dtype
    want = sdpa_pallas._sdpa_plain(q, k, v, d**-0.5, softmax)
    if dtype == torch.float32 and softmax == "exp2_bf16":
        # exp2_bf16 rounds each logit to bf16, a step function: where the
        # kernel's bf16x6 sum and the plain version's cuBLAS float32 sum of
        # one logit straddle a step, p differs by a whole bf16 step. The tie
        # allowance is that jump, and 0 in every row with no logit within
        # 2^-20 sum_i |q_i k_i| of a step; every element beyond 2e-5 must lie
        # in a row where it is not 0
        allowance = sdpa_pallas._exp2_bf16_tie_allowance(q, k, v, d**-0.5, want)
        _within(got, want, 2e-5 + allowance)
        over = torch.abs(got.double() - want.double()) > 2e-5
        tie_rows = torch.any(allowance > 0, dim=-1, keepdim=True)
        assert not torch.any(over & ~tie_rows), (
            f"{int(over.sum())} elements over 2e-5, {int((over & ~tie_rows).sum())} in rows without a tie")
    elif dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=0, atol=2e-5)
    else:
        _context_class(got, want)


def _within(got, want, limit):
    err = torch.abs(got.double() - want.double())
    assert torch.all(err <= limit), (err.max().item(), torch.max(err - limit).item())


@pytest.mark.parametrize("softmax", ["exp2", "exp2_bf16", "exact", "online"])
@pytest.mark.parametrize("d", [16, 36, 64, 80, 128])
@pytest.mark.parametrize("t", [37, 259, 1100])
def test_sdpa_f32_kernel_matches_twin(dev, softmax, d, t):
    """The float32 arm (A9's modes through ``sdpa``, the online one through
    ``flash_sdpa``) against its torch dataflow ``_sdpa_f32_pieces_reference``
    at 2e-6, a tenth of the plain version's tolerance (exp2_bf16: plus the
    tie allowance); one launch of the split pass and one of the kernel."""
    q, k, v = _qkv(dev, (2, 3, t, d), torch.float32, seed=2)
    kname = sdpa_pallas.KERNEL_A15 if softmax == "online" else sdpa_pallas.KERNEL_A9
    before = (cuda_lib.launch_counts[kname], cuda_lib.launch_counts[sdpa_pallas.KERNEL_SPLIT])
    if softmax == "online":
        got = sdpa_pallas.flash_sdpa(q, k, v, d**-0.5)
    else:
        got = sdpa_pallas.sdpa(q, k, v, d**-0.5, softmax=softmax)
    assert (cuda_lib.launch_counts[kname], cuda_lib.launch_counts[sdpa_pallas.KERNEL_SPLIT]) == (
        before[0] + 1, before[1] + 1)
    want = sdpa_pallas._sdpa_f32_pieces_reference(q, k, v, d**-0.5, softmax)
    limit = 2e-6
    if softmax == "exp2_bf16":
        limit = limit + sdpa_pallas._exp2_bf16_tie_allowance(q, k, v, d**-0.5, want)
    _within(got, want, limit)
    assert torch.equal(got, sdpa_pallas.flash_sdpa(q, k, v, d**-0.5) if softmax == "online"
                       else sdpa_pallas.sdpa(q, k, v, d**-0.5, softmax=softmax))


@pytest.mark.parametrize("d", [16, 36, 64, 80, 128])
@pytest.mark.parametrize("t", [37, 2999])
def test_sdpa_f32_split_kernel_is_plain(dev, d, t):
    """The float32 arm's split pass bit for bit its plain version (the
    padded columns zeros), one launch counted."""
    q, k, v = _qkv(dev, (2, 3, t, d), torch.float32, seed=3)
    before = cuda_lib.launch_counts[sdpa_pallas.KERNEL_SPLIT]
    got = sdpa_pallas.split_pieces(q, k, v)
    assert cuda_lib.launch_counts[sdpa_pallas.KERNEL_SPLIT] == before + 1
    want = sdpa_pallas._split_pieces_plain(q, k, v)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [32, 64, 80, 128])
@pytest.mark.parametrize("t", [37, 1100, 2999])
def test_flash_kernel_matches_plain_on_query_slices(dev, dtype, d, t):
    """T = 37 (one ragged tile, padded to 512: three whole tiles skipped),
    1100 (padded to 1536: three skipped) and 2999 (to 3072: none)."""
    q, k, v = _qkv(dev, (1, 2, t, d), dtype, seed=1)
    before = cuda_lib.launch_counts[sdpa_pallas.KERNEL_A15]
    got = sdpa_pallas.flash_sdpa(q, k, v, d**-0.5)
    assert cuda_lib.launch_counts[sdpa_pallas.KERNEL_A15] == before + 1
    for sl in (slice(0, 128), slice(max(0, t - 128), t)):
        want = sdpa_pallas._flash_sdpa_plain(q[:, :, sl], k, v, d**-0.5)
        if dtype == torch.float32:
            torch.testing.assert_close(got[:, :, sl], want, rtol=0, atol=2e-5)
        else:
            _context_class(got[:, :, sl], want)


@pytest.mark.parametrize("t", [512 * 300, 512 * 300 + 100, 700])
def test_fused_corr_kernel_matches_plain(dev, t):
    c, d = _audio(dev, t=t)
    kname = sdr_corr_fused.KERNEL_A10_RAW if t % 512 == 0 else sdr_corr_fused.KERNEL_A10
    before = cuda_lib.launch_counts[kname]
    ra, rc = sdr_corr_fused.correlation_lags_fused(c, d, 512)
    assert cuda_lib.launch_counts[kname] == before + 1
    pa, pc = sdr_corr_gram._correlation_lags_plain(c, d, 512)
    scale = pa.abs().max().item()
    torch.testing.assert_close(ra, pa, rtol=0, atol=2e-4 * scale)
    torch.testing.assert_close(rc, pc, rtol=0, atol=2e-4 * scale)


@pytest.mark.parametrize("t", CORR_LENGTHS)
@pytest.mark.parametrize("rows", [1, 64])
def test_fused_corr_kernel_main_shapes(dev, rows, t):
    """A10's chunk DFT on the tensor cores at SDR's shapes, on normalised
    signals as SDR(corr_impl="fused") feeds it: one launch of the raw or
    padded counter per call, 2e-4 of max|r_auto| from its plain version,
    bit-identical from launch to launch."""
    c, d = _audio(dev, rows=rows, t=t, seed=rows + t + 1)
    c, d = (x / torch.linalg.vector_norm(x, dim=-1, keepdim=True) for x in (c, d))
    kname = sdr_corr_fused.KERNEL_A10_RAW if t % 512 == 0 else sdr_corr_fused.KERNEL_A10
    before = cuda_lib.launch_counts[kname]
    ra, rc = _twice_equal(sdr_corr_fused.correlation_lags_fused, c, d, 512)
    assert cuda_lib.launch_counts[kname] == before + 2
    pa, pc = sdr_corr_fused._correlation_lags_fused_plain(c, d, 512)
    scale = pa.abs().max().item()
    torch.testing.assert_close(ra, pa, rtol=0, atol=2e-4 * scale)
    torch.testing.assert_close(rc, pc, rtol=0, atol=2e-4 * scale)


@pytest.mark.parametrize("t", [43, 799])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ffn_block_kernel_matches_plain(dev, dtype, t):
    """M = 2 T rows, no multiple of the products' 128-row tiles."""
    d, ffn = 128, 256
    p = _block_params(d, ffn, seed=3)
    x = torch.tensor(np.random.RandomState(2).randn(2, t, d), dtype=dtype)
    packed = attn_block_pallas.pack_ffn_block_params(p)
    before = cuda_lib.launch_counts[attn_block_pallas.KERNEL_A8]
    got = attn_block_pallas.ffn_block(x.to(dev), tuple(a.to(dev) for a in packed), 1e-5)
    assert cuda_lib.launch_counts[attn_block_pallas.KERNEL_A8] == before + 1
    _bf16_class(got.cpu(), attn_block_pallas.ffn_block(x, packed, 1e-5))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_kernels_refuse_a_misaligned_x(dev, dtype):
    """A contiguous x that starts off a 16-byte boundary raises ValueError
    before any launch, and the card goes on working."""
    d, ffn = 128, 256
    packed = tuple(a.to(dev) for a in attn_block_pallas.pack_ffn_block_params(_block_params(d, ffn, seed=3)))
    x = torch.randn(2 * 43 * d + 1, device=dev).to(dtype)[1:].view(2, 43, d)
    before = cuda_lib.launch_counts[attn_block_pallas.KERNEL_A8]
    with pytest.raises(ValueError, match="aligned"):
        attn_block_pallas.ffn_block(x, packed, 1e-5)
    assert cuda_lib.launch_counts[attn_block_pallas.KERNEL_A8] == before
    got = attn_block_pallas.ffn_block(x.clone(), packed, 1e-5)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()


@pytest.mark.parametrize("epilogue", attn_block_pallas.GEMM_EPILOGUES)
@pytest.mark.parametrize("m,n,k", [(1598, 384, 128), (77, 160, 96), (300, 264, 3072)])
def test_gemm_kernel_matches_plain(dev, m, n, k, epilogue):
    """The products of A7 and A8 alone, against the plain version: fp32 out
    to 1e-4 of max|c| (sums in another order), bf16 out within one bf16 ulp
    (2^-7 relative: a sum a little off a rounding boundary can round to the
    next value). M, N and K not multiples of the tiles (128 x 256, k
    blocks of 64)."""
    rs = np.random.RandomState(m + n)
    a = torch.tensor(rs.randn(m, k), dtype=torch.bfloat16, device=dev)
    b = torch.tensor(rs.randn(k, n) * k**-0.5, dtype=torch.bfloat16, device=dev)
    bias = torch.tensor(rs.randn(n), dtype=torch.float32, device=dev)
    before = cuda_lib.launch_counts[attn_block_pallas.KERNEL_GEMM]
    got = attn_block_pallas.gemm(a, b, bias, epilogue)
    assert cuda_lib.launch_counts[attn_block_pallas.KERNEL_GEMM] == before + 1
    want = attn_block_pallas._gemm_plain(a, b, bias, epilogue)
    assert got.dtype == want.dtype and got.shape == (m, n)
    scale = want.float().abs().max().item()
    if epilogue == "f32":
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * scale)
    else:
        torch.testing.assert_close(got.float(), want.float(), rtol=2**-7, atol=1e-4 * scale)


def test_speechbertscore_on_card_matches_cpu(dev):
    """The block path (A7 + A8 on every layer) through ``__call__`` against
    the CPU plain path, F1 atol 2e-4."""
    config = HubertConfig(hidden_size=128, num_hidden_layers=3, num_attention_heads=2,
                          intermediate_size=256, conv_dim=(32, 32, 32), conv_kernel=(10, 3, 3),
                          conv_stride=(5, 2, 2), num_conv_pos_embeddings=16,
                          num_conv_pos_embedding_groups=4)
    params = init_params(torch.Generator().manual_seed(0), config)
    clean, noisy, _ = load_audio_data(1.0, 2, 16000)
    kw = dict(params=params, config=config, output_layer=3)
    before = dict(cuda_lib.launch_counts)
    on_card = SpeechBERTScore(device=dev, **kw)(clean, noisy)
    for kname in (attn_block_pallas.KERNEL_A7, attn_block_pallas.KERNEL_A8):
        assert cuda_lib.launch_counts[kname] == before.get(kname, 0) + 3
    on_cpu = SpeechBERTScore(device="cpu", attention_impl="block_ffn", **kw)(clean, noisy)
    for a, b in zip(on_card, on_cpu):
        assert a["SpeechBERTScore"] == pytest.approx(b["SpeechBERTScore"], abs=2e-4)


@pytest.mark.parametrize("impl,kname", [("layer_block", attn_block_pallas.KERNEL_A11),
                                        ("block_int8", attn_block_pallas.KERNEL_A12)])
def test_speechbertscore_layer_and_int8_paths_on_card(dev, impl, kname):
    """The whole-layer (A11) and int8 (A12) paths through ``__call__``
    against the CPU plain path, F1 atol 2e-4; one launch per layer and no
    A7 / A8."""
    config = HubertConfig(hidden_size=128, num_hidden_layers=3, num_attention_heads=2,
                          intermediate_size=256, conv_dim=(32, 32, 32), conv_kernel=(10, 3, 3),
                          conv_stride=(5, 2, 2), num_conv_pos_embeddings=16,
                          num_conv_pos_embedding_groups=4)
    params = init_params(torch.Generator().manual_seed(0), config)
    clean, noisy, _ = load_audio_data(1.0, 2, 16000)
    kw = dict(params=params, config=config, output_layer=3, attention_impl=impl)
    before = dict(cuda_lib.launch_counts)
    on_card = SpeechBERTScore(device=dev, **kw)(clean, noisy)
    for k, n in ((kname, 3), (attn_block_pallas.KERNEL_A7, 0), (attn_block_pallas.KERNEL_A8, 0)):
        assert cuda_lib.launch_counts[k] == before.get(k, 0) + n
    on_cpu = SpeechBERTScore(device="cpu", **kw)(clean, noisy)
    for a, b in zip(on_card, on_cpu):
        assert a["SpeechBERTScore"] == pytest.approx(b["SpeechBERTScore"], abs=2e-4)


@pytest.mark.parametrize("impl", ["sdpa", "flash"])
def test_speechbertscore_long_audio_paths_on_card(dev, impl):
    """The sdpa and flash paths through ``__call__`` against the CPU plain
    path, F1 atol 2e-4; one launch per layer."""
    config = HubertConfig(hidden_size=160, num_hidden_layers=2, num_attention_heads=2,
                          intermediate_size=256, conv_dim=(32, 32, 32), conv_kernel=(10, 3, 3),
                          conv_stride=(5, 2, 2), num_conv_pos_embeddings=16,
                          num_conv_pos_embedding_groups=4)
    params = init_params(torch.Generator().manual_seed(0), config)
    clean, noisy, _ = load_audio_data(1.0, 2, 16000)
    kw = dict(params=params, config=config, output_layer=2, attention_impl=impl)
    kname = sdpa_pallas.KERNEL_A9 if impl == "sdpa" else sdpa_pallas.KERNEL_A15
    before = cuda_lib.launch_counts[kname]
    on_card = SpeechBERTScore(device=dev, **kw)(clean, noisy)
    assert cuda_lib.launch_counts[kname] == before + 2
    on_cpu = SpeechBERTScore(device="cpu", **kw)(clean, noisy)
    for a, b in zip(on_card, on_cpu):
        assert a["SpeechBERTScore"] == pytest.approx(b["SpeechBERTScore"], abs=2e-4)


@pytest.mark.parametrize("t", [32768, 30000])
def test_metrics_on_card_match_cpu(dev, t):
    """The metrics through ``__call__`` on the card against the CPU plain
    path; 30000 samples is not hop-aligned, so LSD takes kernel A2 there."""
    clean, noisy, _ = load_audio_data(t / 16000, 3, 16000)
    kname = lsd_fused.KERNEL if t % 256 == 0 else lsd_fused.KERNEL_A2
    before = cuda_lib.launch_counts[kname]
    for cls, kw, tol in ((LSD, {}, 2e-4), (SDR, {}, 1e-2), (SDR, {"corr_impl": "fused"}, 1e-2),
                         (STOI, {"sample_rate": 16000}, 5e-4)):
        on_card = cls(device=dev, **kw)(clean, noisy)
        on_cpu = cls(device="cpu", **kw)(clean, noisy)
        for a, b in zip(on_card, on_cpu):
            for k, v in b.items():
                assert a[k] == pytest.approx(v, rel=tol if cls is LSD else 0, abs=tol)
    assert cuda_lib.launch_counts[kname] == before + 1


# -- the conv encoder's convs 1-6 (conv_gelu.cu) --


def _conv_inputs(dev, rows, c_in, c_out, width, t_in, seed=0):
    """x like the encoder's GELU outputs, He-scaled weights."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.nn.functional.gelu(torch.randn(rows, c_in, t_in, device=dev, generator=g))
    w = torch.randn(c_out, c_in, width, device=dev, generator=g) * (c_in * width) ** -0.5
    return x, w


def _check_conv_gelu(dev, rows, c_in, c_out, width, t_in, gelu):
    """Against a float64 conv + GELU, max |err| over max |ref| at most twice
    cuDNN float32's (TF32 off) on the same inputs; a second launch bit-equal;
    one launch counted each."""
    x, w = _conv_inputs(dev, rows, c_in, c_out, width, t_in)
    pieces = conv_gelu.split_pieces(w)
    before = cuda_lib.launch_counts[conv_gelu.KERNEL]
    got = conv_gelu.conv_gelu(x, w, gelu, pieces=pieces)
    again = conv_gelu.conv_gelu(x, w, gelu, pieces=pieces)
    torch.cuda.synchronize()
    assert cuda_lib.launch_counts[conv_gelu.KERNEL] == before + 2
    assert got.shape == (rows, c_out, (t_in - width) // 2 + 1) and torch.equal(got, again)
    want = numerics.gelu(torch.nn.functional.conv1d(x.double(), w.double(), stride=2), gelu)
    library = conv_gelu._conv_gelu_plain(x, w, gelu)
    scale = want.abs().max()
    err = ((got.double() - want).abs().max() / scale).item()
    err_library = ((library.double() - want).abs().max() / scale).item()
    assert err <= 2 * err_library, (err, err_library)


@pytest.mark.parametrize("gelu", ["erf", "tanh"])
@pytest.mark.parametrize("channels", [64, 512])
@pytest.mark.parametrize("t_in,width", [(t, k) for t in (2, 3, 4, 5, 127, 1001) for k in (2, 3) if t >= k])
def test_conv_gelu_kernel_against_float64(dev, t_in, width, channels, gelu):
    _check_conv_gelu(dev, 2, channels, channels, width, t_in, gelu)


@pytest.mark.parametrize("rows", [2, 64])
def test_conv_gelu_kernel_main_shape(dev, rows):
    """Conv 1 of mHuBERT-147 on 16 s (51 199 frames in, 25 599 out)."""
    _check_conv_gelu(dev, rows, 512, 512, 3, 51199, "tanh")


@pytest.mark.parametrize("c_in,c_out", [(64, 512), (512, 64), (192, 128)])
def test_conv_gelu_kernel_unequal_channels(dev, c_in, c_out):
    _check_conv_gelu(dev, 3, c_in, c_out, 3, 300, "erf")


def test_feature_encoder_takes_conv_gelu_in_float32_only(dev, monkeypatch):
    """mHuBERT-147's encoder on the card: six launches in float32, within
    its float32 class of the cuDNN path; none with bf16 activations."""
    enc = hubert.from_jax_params(init_params(torch.Generator().manual_seed(0))).to(dev)
    audio = _audio(dev, rows=2, t=16000)[0]
    before = cuda_lib.launch_counts[conv_gelu.KERNEL]
    with torch.inference_mode():
        got = hubert.feature_encoder(enc, audio, gelu="tanh")
        assert cuda_lib.launch_counts[conv_gelu.KERNEL] == before + 6
        hubert.feature_encoder(enc, audio.to(torch.bfloat16), gelu="tanh")
        assert cuda_lib.launch_counts[conv_gelu.KERNEL] == before + 6
        monkeypatch.setattr(conv_gelu, "engages", lambda *args: False)
        want = hubert.feature_encoder(enc, audio, gelu="tanh")
    assert cuda_lib.launch_counts[conv_gelu.KERNEL] == before + 6
    assert not cuda_lib.launch_counts[conv_gelu.KERNEL_LN] and not cuda_lib.launch_counts[conv_gelu.KERNEL_CONV0]
    assert ((got - want).abs().max() / want.abs().max()).item() < 1e-5


# -- the layer-norm encoder's convs: conv_gelu.cu with the LayerNorm fused --


def _norm_params(dev, c_out, seed=1):
    """The LayerNorm's scale 1 + N(0, 0.01) and shift N(0, 0.01), as the benchmark draws them."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return 1 + 0.1 * torch.randn(c_out, device=dev, generator=g), 0.1 * torch.randn(c_out, device=dev, generator=g)


def _conv_ln_gelu64(x, w, scale, shift, gelu, stride, eps=1e-5):
    """conv + LayerNorm over channels + GELU in float64."""
    y = torch.nn.functional.conv1d(x.double(), w.double(), stride=stride)
    mean = y.mean(dim=1, keepdim=True)
    y = (y - mean) * torch.rsqrt(((y - mean) ** 2).mean(dim=1, keepdim=True) + eps)
    return numerics.gelu(y * scale.double()[:, None] + shift.double()[:, None], gelu)


def _check_ln_kernel(kernel, name, x, w, scale, shift, gelu, stride):
    """``kernel`` (a wrapper of x, w, scale, shift, eps, gelu) against the
    float64 chain: max |err| over max |ref| at most twice cuDNN float32's +
    ``numerics.layer_norm``'s on the same inputs (rows in groups of 8); a
    second launch bit-equal; one launch counted each."""
    before = cuda_lib.launch_counts[name]
    got = kernel(x, w, scale, shift, 1e-5, gelu)
    again = kernel(x, w, scale, shift, 1e-5, gelu)
    torch.cuda.synchronize()
    assert cuda_lib.launch_counts[name] == before + 2
    c_out, _, width = w.shape
    assert got.shape == (x.shape[0], c_out, (x.shape[2] - width) // stride + 1) and torch.equal(got, again)
    del again
    err = err_library = scale_max = 0.0
    for r in range(0, x.shape[0], 8):
        want = _conv_ln_gelu64(x[r:r + 8], w, scale, shift, gelu, stride)
        library = conv_gelu._conv_ln_gelu_plain(x[r:r + 8], w, scale, shift, 1e-5, gelu, stride)
        scale_max = max(scale_max, want.abs().max().item())
        err = max(err, (got[r:r + 8].double() - want).abs().max().item())
        err_library = max(err_library, (library.double() - want).abs().max().item())
        del want, library
    assert err <= 2 * err_library, (err / scale_max, err_library / scale_max)


def _check_conv_ln_gelu(dev, rows, c_in, c_out, width, t_in, gelu):
    x, w = _conv_inputs(dev, rows, c_in, c_out, width, t_in)
    pieces = conv_gelu.split_pieces(w)
    _check_ln_kernel(lambda *args: conv_gelu.conv_ln_gelu(*args, pieces=pieces), conv_gelu.KERNEL_LN, x, w,
                     *_norm_params(dev, c_out), gelu, 2)


@pytest.mark.parametrize("gelu", ["erf", "tanh"])
@pytest.mark.parametrize("t_in,width", [(t, k) for t in (2, 3, 5, 257, 258, 259, 1001) for k in (2, 3) if t >= k])
def test_conv_ln_gelu_kernel_against_float64(dev, t_in, width, gelu):
    """WavLM's widths (512 channels, clusters of 4 blocks) at T_out of 1 to
    500, ending mid-tile, and odd T_in (rows at every 4-byte offset)."""
    _check_conv_ln_gelu(dev, 2, 512, 512, width, t_in, gelu)


@pytest.mark.parametrize("c_in,c_out", [(64, 128), (512, 1024), (192, 384), (512, 256)])
def test_conv_ln_gelu_kernel_cluster_sizes(dev, c_in, c_out):
    """Clusters of 1, 8, 3 and 2 blocks a frame."""
    _check_conv_ln_gelu(dev, 3, c_in, c_out, 3, 301, "erf")


@pytest.mark.parametrize("rows", [2, 64])
def test_conv_ln_gelu_kernel_main_shape(dev, rows):
    """Conv 1 of WavLM-Large on 16 s (51 199 frames in, 25 599 out)."""
    _check_conv_ln_gelu(dev, rows, 512, 512, 3, 51199, "tanh")


@pytest.mark.parametrize("gelu", ["erf", "tanh"])
@pytest.mark.parametrize("t_in", [10, 14, 15, 329, 334, 16000 + 3, 16 * 16000])
def test_conv0_ln_gelu_kernel_against_float64(dev, t_in, gelu):
    """Conv 0 of the layer-norm encoder on speech-scaled samples at T_out
    of 1 to 51 199: one tile (64 frames), one frame into the next, 16 s."""
    g = torch.Generator(device=dev).manual_seed(2)
    x = 0.1 * torch.randn(2, 1, t_in, device=dev, generator=g)
    w = torch.randn(512, 1, 10, device=dev, generator=g) * 0.2 ** 0.5
    _check_ln_kernel(conv_gelu.conv0_ln_gelu, conv_gelu.KERNEL_CONV0, x, w, *_norm_params(dev, 512), gelu, 5)


def _feature_encoder64(enc, audio, gelu):
    """The layer-norm encoder in float64."""
    x = audio.double()[:, None]
    for i, layer in enumerate(enc.feature_encoder):
        x = _conv_ln_gelu64(x, layer["w"], layer["norm_scale"], layer["norm_bias"], gelu, enc.config.conv_stride[i])
    return x.transpose(1, 2)


def test_wavlm_feature_encoder_on_the_ln_kernels(dev, monkeypatch):
    """WavLM-Large's conv encoder on the card at 2 x 16 s: conv 0 on its
    kernel, convs 1-6 on conv_gelu.cu's LayerNorm epilogue, none of FE's
    plain launches; within 1e-4 of a float64 encoder over its largest
    magnitude (the SBS cell's features_gap limit) and within cuDNN
    float32's distance; no launch with bf16 activations."""
    params = init_params(torch.Generator().manual_seed(0), hubert.WAVLM_LARGE_CONFIG)
    rs = np.random.RandomState(5)
    for layer in params["feature_encoder"]:  # the benchmark's draws: He-normal convs, affine 1 + N(0, 0.01), N(0, 0.01)
        k, c_in, c_out = layer["w"].shape
        layer["w"] = (rs.randn(k, c_in, c_out) * (2.0 / (k * c_in)) ** 0.5).astype(np.float32)
        layer["norm_scale"] = (1 + 0.1 * rs.randn(c_out)).astype(np.float32)
        layer["norm_bias"] = (0.1 * rs.randn(c_out)).astype(np.float32)
    enc = hubert.from_jax_params(params, hubert.WAVLM_LARGE_CONFIG).to(dev)
    audio = torch.from_numpy(load_audio_data(16, 2, 16000)[0]).to(dev)
    kernels = (conv_gelu.KERNEL_CONV0, conv_gelu.KERNEL_LN, conv_gelu.KERNEL)
    before = [cuda_lib.launch_counts[k] for k in kernels]
    with torch.inference_mode():
        got = hubert.feature_encoder(enc, audio, gelu="tanh")
        assert [cuda_lib.launch_counts[k] - n for k, n in zip(kernels, before)] == [1, 6, 0]
        hubert.feature_encoder(enc, audio.to(torch.bfloat16), gelu="tanh")
        assert [cuda_lib.launch_counts[k] - n for k, n in zip(kernels, before)] == [1, 6, 0]
        monkeypatch.setattr(conv_gelu, "engages_ln", lambda *args: False)
        monkeypatch.setattr(conv_gelu, "engages_conv0_ln", lambda *args: False)
        library = hubert.feature_encoder(enc, audio, gelu="tanh")
        want = _feature_encoder64(enc, audio, "tanh")
    top = want.abs().max()
    gap, gap_library = (((y.double() - want).abs().max() / top).item() for y in (got, library))
    assert gap <= 1e-4 and gap <= gap_library, (gap, gap_library)


# -- the positional conv stage (pos_conv.cu) --


def _pos_inputs(dev, rows, frames, channels, bn, seed=0):
    """N(0, 1) activations, weights N(0, 1 / (128 c_g)) in 16 groups, bias
    N(0, 0.01), BN scale 1 + N(0, 0.09) and shift N(0, 0.09) (or none)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    cg = channels // 16
    x = torch.randn(rows, frames, channels, device=dev, generator=g)
    w = torch.randn(channels, cg, pos_conv.WIDTH, device=dev, generator=g) * (cg * pos_conv.WIDTH) ** -0.5
    b = 0.1 * torch.randn(channels, device=dev, generator=g)
    scale = 1 + 0.3 * torch.randn(channels, device=dev, generator=g) if bn else None
    shift = 0.3 * torch.randn(channels, device=dev, generator=g) if bn else None
    return x, w, b, scale, shift


def _check_pos_conv(dev, rows, frames, channels, bn):
    """Against a float64 stage, max |err| over max |ref| at most twice
    cuDNN float32's (TF32 off, the stage's passes) on the same inputs; a
    second launch bit-equal; one launch counted each."""
    x, w, b, scale, shift = _pos_inputs(dev, rows, frames, channels, bn)
    pieces = pos_conv.split_pieces(w, 16)
    before = cuda_lib.launch_counts[pos_conv.KERNEL]
    got = pos_conv.pos_conv(x, w, b, 16, scale, shift, pieces=pieces)
    again = pos_conv.pos_conv(x, w, b, 16, scale, shift, pieces=pieces)
    torch.cuda.synchronize()
    assert cuda_lib.launch_counts[pos_conv.KERNEL] == before + 2
    assert got.shape == x.shape and torch.equal(got, again)
    pos_in = x if scale is None else x * scale + shift
    conv = torch.nn.functional.conv1d(pos_in.double().transpose(1, 2), w.double(), padding=pos_conv.WIDTH // 2,
                                      groups=16)
    want = x.double() + torch.nn.functional.gelu(conv.transpose(1, 2)[:, :-1] + b.double())
    library = pos_conv._pos_conv_plain(x, w, b, 16, scale, shift)
    top = want.abs().max()
    err = ((got.double() - want).abs().max() / top).item()
    err_library = ((library.double() - want).abs().max() / top).item()
    assert err <= 2 * err_library, (err, err_library)


@pytest.mark.parametrize("frames", [1, 2, 37, 64, 65, 256, 257, 300])
@pytest.mark.parametrize("bn", [True, False])
@pytest.mark.parametrize("channels", [768, 1024])
def test_pos_conv_kernel_against_float64(dev, channels, bn, frames):
    _check_pos_conv(dev, 2, frames, channels, bn)


@pytest.mark.parametrize("rows,frames,channels,bn", [(64, 799, 768, True), (64, 799, 1024, False),
                                                     (16, 2999, 768, True), (3, 799, 1024, True)])
def test_pos_conv_kernel_main_shapes(dev, rows, frames, channels, bn):
    """The SpeechBERTScore cells' row chunks: mHuBERT-147 at 16 s (BN),
    WavLM-Large, mHuBERT-147 at 60 s."""
    _check_pos_conv(dev, rows, frames, channels, bn)


@pytest.mark.parametrize("which,seconds", [("mhubert", 1.0), ("wavlm", 1.0), ("mhubert", 60.0)])
def test_speechbertscore_launches_pos_conv_once_a_row_chunk(dev, monkeypatch, which, seconds):
    """Each SpeechBERTScore configuration through the public call: one PC
    launch a row chunk (two chunks here), F1 within 1e-4 of the cuDNN stage;
    bf16 activations launch none."""
    config = hubert.WAVLM_LARGE_CONFIG if which == "wavlm" else hubert.MHUBERT_147_CONFIG
    layer = 14 if which == "wavlm" else 8
    params = init_params(torch.Generator().manual_seed(0), config)
    params["layers"] = params["layers"][:layer]
    pairs = 2 if seconds > 1 else 4
    clean, noisy, _ = load_audio_data(seconds, pairs, 16000)
    kw = dict(params=params, config=config, output_layer=layer, device=dev, batch_chunk=pairs)
    before = cuda_lib.launch_counts[pos_conv.KERNEL]
    got = np.array([r["SpeechBERTScore"] for r in SpeechBERTScore(**kw)(clean, noisy)])
    assert cuda_lib.launch_counts[pos_conv.KERNEL] == before + 2
    SpeechBERTScore(act_dtype=torch.bfloat16, **kw)(clean, noisy)
    assert cuda_lib.launch_counts[pos_conv.KERNEL] == before + 2
    monkeypatch.setattr(pos_conv, "engages", lambda *args: False)
    want = np.array([r["SpeechBERTScore"] for r in SpeechBERTScore(**kw)(clean, noisy)])
    assert cuda_lib.launch_counts[pos_conv.KERNEL] == before + 2
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_hidden_state_takes_pos_conv_in_float32_only(dev, monkeypatch):
    """mHuBERT-147's encoder output before the layers on the card: one
    launch in float32, within its float32 class of the cuDNN stage; none
    with bf16 activations."""
    params = init_params(torch.Generator().manual_seed(0))
    rs = np.random.RandomState(0)
    params["pos_conv"]["bn_scale"] = (1 + 0.3 * rs.randn(768)).astype(np.float32)
    params["pos_conv"]["bn_shift"] = (0.3 * rs.randn(768)).astype(np.float32)
    enc = hubert.from_jax_params(params).to(dev)
    audio = _audio(dev, rows=2, t=16000)[0]
    before = cuda_lib.launch_counts[pos_conv.KERNEL]
    with torch.inference_mode():
        got = hubert.hubert_hidden_state(enc, audio, output_layer=0)
        assert cuda_lib.launch_counts[pos_conv.KERNEL] == before + 1
        hubert.hubert_hidden_state(enc, audio, output_layer=0, act_dtype=torch.bfloat16)
        assert cuda_lib.launch_counts[pos_conv.KERNEL] == before + 1
        monkeypatch.setattr(pos_conv, "engages", lambda *args: False)
        want = hubert.hubert_hidden_state(enc, audio, output_layer=0)
    assert cuda_lib.launch_counts[pos_conv.KERNEL] == before + 1
    assert ((got - want).abs().max() / want.abs().max()).item() < 1e-5


#: WavLM-Large's attention: d 1024, 16 heads of 64, 320 buckets up to 800
RP_D, RP_HEADS = 1024, 16


def _relpos_inputs(dev, rows, t, softmax, seed=0):
    g = torch.Generator().manual_seed(seed)
    qkvg = 0.7 * torch.randn(rows, t, 3 * RP_D + relpos_attention.gate_columns(RP_HEADS), generator=g)
    qkvg[..., :RP_D] *= (RP_D // RP_HEADS) ** -0.5  # q pre-scaled, as the route's packing folds it
    qkvg = qkvg.to(torch.bfloat16)
    const = 1 + 0.1 * torch.randn(RP_HEADS, generator=g)
    vec = relpos_attention.offset_bias(torch.randn(320, RP_HEADS, generator=g), t, 320, 800,
                                       1.0 if softmax == "exact" else LOG2E)
    return qkvg.to(dev), const.to(dev), vec.to(dev)


@pytest.mark.parametrize("softmax", ["exp2", "exact", "exp2_bf16"])
@pytest.mark.parametrize("rows,t", [(64, 799), (32, 2999), (3, 300)])
def test_relpos_kernel_matches_plain(dev, rows, t, softmax):
    """The gated relative-position attention at WavLM's width on the cell's
    row chunk (64 x 799), on 32 x 2999 (offsets past 800: saturated
    buckets) and at a T that is no multiple of 128, against its plain
    version (run on the card) in A9's per-row class; two launches
    bit-equal. exp2_bf16 rounds each logit to bf16, a step function: the
    error beyond the tie allowance (``_exp2_bf16_tie_allowance``, the jump
    of p where the two float32 sums of a logit straddle a step) is held to
    the class."""
    qkvg, const, vec = _relpos_inputs(dev, rows, t, softmax)
    before = cuda_lib.launch_counts[relpos_attention.KERNEL]
    got = relpos_attention.relpos_attention(qkvg, const, vec, RP_HEADS, softmax)
    assert cuda_lib.launch_counts[relpos_attention.KERNEL] == before + 1
    want = relpos_attention._relpos_attention_plain(qkvg, const, vec, RP_HEADS, softmax)
    if softmax == "exp2_bf16":
        allowance = relpos_attention._exp2_bf16_tie_allowance(qkvg, const, vec, RP_HEADS, want)
        excess = torch.clamp((got.double() - want.double()).abs() - allowance, min=0.0)
        got = (want.double() + excess).float()
    _context_class(got, want)
    assert torch.equal(relpos_attention.relpos_attention(qkvg, const, vec, RP_HEADS, softmax),
                       relpos_attention.relpos_attention(qkvg, const, vec, RP_HEADS, softmax))


@pytest.mark.parametrize("softmax", ["exp2", "exact", "exp2_bf16"])
@pytest.mark.parametrize("t", [799, 300])
def test_relpos_kernel_with_zero_bias_is_a9(dev, t, softmax):
    """With a zero bias the kernel is A9's (so A7's) attention bit for bit on
    the same pre-scaled q, k, v: one body in flash_sm90.cuh, the bias a
    compile-time branch."""
    qkvg, const, vec = _relpos_inputs(dev, 2, t, softmax, seed=1)
    hd = RP_D // RP_HEADS
    q, k, v = (qkvg[..., i * RP_D:(i + 1) * RP_D].reshape(2, t, RP_HEADS, hd).transpose(1, 2).contiguous()
               for i in range(3))
    a9 = sdpa_pallas._launch(sdpa_pallas.KERNEL_A9, q, k, v, sdpa_pallas.SOFTMAX_MODES.index(softmax), t, 1.0, 0.0)
    got = relpos_attention.relpos_attention(qkvg, const, torch.zeros_like(vec), RP_HEADS, softmax)
    assert torch.equal(got, a9.transpose(1, 2).reshape(2, t, RP_D))


def _prenorm_params(d, heads, ffn, seed):
    p = _block_params(d, ffn, seed, qk_scale=0.04)
    rs = np.random.RandomState(seed + 1)
    p.update(gate_w=torch.tensor(rs.randn(d // heads, 8) / 8, dtype=torch.float32),
             gate_b=torch.tensor(rs.randn(8) * 0.1, dtype=torch.float32),
             gate_const=torch.tensor(1 + 0.1 * rs.randn(heads), dtype=torch.float32))
    return p


@pytest.mark.parametrize("softmax", ["exp2", "exact"])
@pytest.mark.parametrize("rows,t", [(2, 799), (3, 130)])
def test_prenorm_layer_kernels_match_plain(dev, softmax, rows, t):
    """One pre-LN WavLM-Large layer on its three launches (LN1 + the QKV
    and gate product, the attention, W_o + residual + LN2 + the FFN +
    residual) against the plain version. The output is the residual
    stream, not a LayerNorm's (|x| up to ~10 here), so the bf16 class is
    taken relative to its largest magnitude: max 4e-3 (one bf16 step
    there), median 4e-4 (measured 1.4e-3 / 1.4e-4 on the card)."""
    p = _prenorm_params(RP_D, RP_HEADS, 4096, seed=t)
    packed = relpos_attention.pack_prenorm_layer(p, RP_HEADS, softmax)
    vec = relpos_attention.offset_bias(torch.tensor(np.random.RandomState(2).randn(320, RP_HEADS),
                                                    dtype=torch.float32), t, 320, 800,
                                       1.0 if softmax == "exact" else LOG2E)
    x = torch.tensor(np.random.RandomState(3).randn(rows, t, RP_D), dtype=torch.float32)
    counts = [cuda_lib.launch_counts[k] for k in (relpos_attention.KERNEL_IN, relpos_attention.KERNEL,
                                                   relpos_attention.KERNEL_OUT)]
    got = relpos_attention.prenorm_layer(x.to(dev), tuple(a.to(dev) for a in packed), vec.to(dev), RP_HEADS, 1e-5,
                                         softmax)
    assert [cuda_lib.launch_counts[k] for k in (relpos_attention.KERNEL_IN, relpos_attention.KERNEL,
                                                relpos_attention.KERNEL_OUT)] == [n + 1 for n in counts]
    want = relpos_attention.prenorm_layer(x, packed, vec, RP_HEADS, 1e-5, softmax)
    rel = (got.cpu() - want).abs() / want.abs().max()
    assert rel.max().item() <= 4e-3 and rel.median().item() <= 4e-4, (rel.max().item(), rel.median().item())


def test_wavlm_public_call_takes_the_relpos_kernel(dev):
    """SpeechBERTScore on WavLM-Large (layer 14) through the public call:
    one relpos launch a layer, none of A7 / A8 / A9 / A15, and F1 within
    2e-3 of the float32 route on the card."""
    params = init_params(torch.Generator().manual_seed(0), hubert.WAVLM_LARGE_CONFIG)
    params["layers"] = params["layers"][:14]
    clean, noisy, _ = load_audio_data(2, 2, 16000)
    metric = SpeechBERTScore(params=params, config=hubert.WAVLM_LARGE_CONFIG, output_layer=14, device=dev)
    cuda_lib.launch_counts.clear()
    got = np.array([r["SpeechBERTScore"] for r in metric(clean, noisy)])
    counts = dict(cuda_lib.launch_counts)
    assert counts.get(relpos_attention.KERNEL) == 14
    # the conv encoder: conv 0 and convs 1-6 on the LayerNorm kernels, once a row chunk
    assert (counts.get(conv_gelu.KERNEL_CONV0), counts.get(conv_gelu.KERNEL_LN), counts.get(conv_gelu.KERNEL)) == (
        1, 6, None)
    assert not any(counts.get(k) for k in (attn_block_pallas.KERNEL_A7, attn_block_pallas.KERNEL_A8,
                                           sdpa_pallas.KERNEL_A9, sdpa_pallas.KERNEL_A15))
    exact = SpeechBERTScore(params=params, config=hubert.WAVLM_LARGE_CONFIG, output_layer=14, device=dev,
                            precision="highest", gelu="tanh")
    want = np.array([r["SpeechBERTScore"] for r in exact(clean, noisy)])
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)

"""PyTorch port, STOI/ESTOI: kernel A6 (plain version) and the metric against
JAX on the CPU. Tolerance: the STOI contract, atol 5e-4 per score (segment
sums divided by bands or frames and by the segment count)."""

import warnings

import numpy as np
import pytest
import torch

from fast_speech_enhancement_metrics_tpu import STOI as JaxSTOI
from fast_speech_enhancement_metrics_tpu.ops.stoi_fused import (
    stoi_segment_sums as jax_segment_sums,
)
from fast_speech_enhancement_metrics_tpu_torch import STOI
from fast_speech_enhancement_metrics_tpu_torch.ops import stoi_fused
from fast_speech_enhancement_metrics_tpu_torch.utils.audio import load_audio_data


def _scores(results):
    return np.array([[r["STOI"], r["ESTOI"]] for r in results])


@pytest.mark.parametrize("frames,cap", [(200, None), (45, 3), (29, None)])
def test_segment_kernel_plain_matches_pallas_kernel(frames, cap):
    rs = np.random.RandomState(5)
    tob_c = np.abs(rs.randn(3, frames, 15)).astype(np.float32)
    tob_d = (tob_c + 0.5 * np.abs(rs.randn(3, frames, 15))).astype(np.float32)
    full = max(frames - 29, 0)
    nseg = np.array([full, max(full - 7, 0), full if cap is None else cap], np.int32)
    s, e = stoi_fused.stoi_segment_sums(
        torch.from_numpy(tob_c), torch.from_numpy(tob_d), torch.from_numpy(nseg)
    )
    js, je = jax_segment_sums(tob_c, tob_d, nseg, interpret=True)
    per = np.maximum(nseg, 1)
    np.testing.assert_allclose(s.numpy() / 15 / per, np.asarray(js) / 15 / per, atol=5e-4)
    np.testing.assert_allclose(e.numpy() / 30 / per, np.asarray(je) / 30 / per, atol=5e-4)


@pytest.mark.parametrize("frames,counts", [(200, (0, 100, 171, 3)), (93, (64, 0, 30, 64)), (29, (0, 0, 0, 0))])
def test_segment_two_stage_reference_matches_pallas_kernel(frames, counts):
    """A6's dataflow on the card (``_stoi_two_stage_reference``: tiles of 64
    segments, stage-1 statistics per (segment, band), stage-2 band sums per
    (segment, frame), the tiles' early exit) against the JAX kernel in
    interpret mode and the plain version, at 5e-4 per segment after the
    metric's division; rows whose segment counts are 0, end mid-tile, fill
    every position, or end on a tile's edge."""
    rs = np.random.RandomState(7)
    tob_c = np.abs(rs.randn(4, frames, 15)).astype(np.float32)
    tob_d = (tob_c + 0.5 * np.abs(rs.randn(4, frames, 15))).astype(np.float32)
    nseg = np.array(counts, np.int32)
    s, e = stoi_fused._stoi_two_stage_reference(
        torch.from_numpy(tob_c), torch.from_numpy(tob_d), torch.from_numpy(nseg)
    )
    js, je = jax_segment_sums(tob_c, tob_d, nseg, interpret=True)
    ps, pe = stoi_fused.stoi_segment_sums(torch.from_numpy(tob_c), torch.from_numpy(tob_d), torch.from_numpy(nseg))
    per = np.maximum(nseg, 1)
    for ws, we in ((np.asarray(js), np.asarray(je)), (ps.numpy(), pe.numpy())):
        np.testing.assert_allclose(s.numpy() / 15 / per, ws / 15 / per, rtol=0, atol=5e-4)
        np.testing.assert_allclose(e.numpy() / 30 / per, we / 30 / per, rtol=0, atol=5e-4)
    assert (s.numpy()[nseg == 0] == 0).all() and (e.numpy()[nseg == 0] == 0).all()


def test_segment_two_stage_reference_skips_tiles_past_the_last_segment():
    """The early exit: envelopes past a row's last valid segment (and its
    29 frames) do not change the sums, not even when they are not finite."""
    rs = np.random.RandomState(8)
    tob_c = torch.from_numpy(np.abs(rs.randn(2, 300, 15)).astype(np.float32))
    tob_d = tob_c + torch.from_numpy(np.abs(rs.randn(2, 300, 15)).astype(np.float32))
    nseg = torch.tensor([70, 130], dtype=torch.int32)
    s, e = stoi_fused._stoi_two_stage_reference(tob_c, tob_d, nseg)
    poisoned_c, poisoned_d = tob_c.clone(), tob_d.clone()
    poisoned_c[0, 128:], poisoned_d[0, 128:] = float("nan"), float("inf")  # row 0: tiles 2.. exit early
    s2, e2 = stoi_fused._stoi_two_stage_reference(poisoned_c, poisoned_d, nseg)
    assert torch.equal(s2, s) and torch.equal(e2, e)


@pytest.mark.parametrize("impl", ["auto", "xla", "fused"])
def test_stoi_16k_matches_jax(speech_data, impl):
    clean, noisy = speech_data["speech"], speech_data["noisy_speech"]
    ours = STOI(sample_rate=16000, segment_impl=impl, device="cpu")(clean, noisy)
    theirs = JaxSTOI(sample_rate=16000)(clean, noisy)
    np.testing.assert_allclose(_scores(ours), _scores(theirs), atol=5e-4)


def test_stoi_native_rate_matches_jax():
    clean, noisy, _ = load_audio_data(3, 3, 10000)
    ours = STOI(device="cpu")(clean, noisy)
    theirs = JaxSTOI()(clean, noisy)
    np.testing.assert_allclose(_scores(ours), _scores(theirs), atol=5e-4)
    same = _scores(STOI(device="cpu")(clean, clean))
    assert np.all(same > 0.999)


def test_stoi_too_short_warns_and_scores_zero():
    """Fewer frames than one segment: the fixed-shape n_seg <= 0 path."""
    rs = np.random.RandomState(1)
    clean = rs.randn(2, 3000).astype(np.float32)
    with pytest.warns(RuntimeWarning, match="non-silent"):
        results = STOI(device="cpu")(clean, clean + 0.1)
    assert all(r["STOI"] == 0.0 and r["ESTOI"] == 0.0 for r in results)


@pytest.mark.parametrize("impl", ["xla", "fused"])
def test_stoi_mostly_silent_warns_and_scores_zero(impl):
    """Silent-frame removal leaves too few frames for one segment: the
    data-dependent num_segments == 0 path, warned from ``compute``."""
    rng = np.random.RandomState(3)
    clean = np.full((2, 160000), 1e-7, dtype=np.float32)
    clean[:, :2000] = rng.randn(2, 2000).astype(np.float32)
    noisy = clean + 1e-9 * rng.randn(2, 160000).astype(np.float32)
    with pytest.warns(RuntimeWarning, match="non-silent"):
        results = STOI(sample_rate=16000, segment_impl=impl, device="cpu")(clean, noisy)
    assert all(r["STOI"] == 0.0 and r["ESTOI"] == 0.0 for r in results)


def test_stoi_silent_input_is_finite():
    silent = np.zeros((2, 40000), dtype=np.float32) + 1e-10
    noise = np.random.RandomState(0).randn(2, 40000).astype(np.float32) * 1e-8
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        results = STOI(sample_rate=16000, device="cpu")(silent, noise)
    assert np.all(np.isfinite(_scores(results)))


def test_stoi_kernel_wrapper_rejects_other_devices():
    x = torch.zeros(1, 40, 15, device="meta")
    with pytest.raises(ValueError, match="device"):
        stoi_fused.stoi_segment_sums(x, x, torch.zeros(1, dtype=torch.int32))

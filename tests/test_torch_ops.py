"""PyTorch port, DSP substrate: tables and transforms against the JAX package.

Inputs are made from a seed with numpy and handed to both packages; the JAX
side runs on the CPU. The port's host-built tables must be bit-equal to the
JAX package's; its float32 transforms agree at rtol 1e-5 (with an absolute
floor of 1e-5 of the output's scale for bins near zero).
"""

import numpy as np
import pytest
import torch

from fast_speech_enhancement_metrics_tpu.metrics import stoi as jax_stoi
from fast_speech_enhancement_metrics_tpu.ops import dft as jax_dft
from fast_speech_enhancement_metrics_tpu.ops import resample as jax_resample
from fast_speech_enhancement_metrics_tpu.ops import stft as jax_stft
from fast_speech_enhancement_metrics_tpu.ops import toeplitz as jax_toeplitz
from fast_speech_enhancement_metrics_tpu_torch.metrics import stoi as pt_stoi
from fast_speech_enhancement_metrics_tpu_torch.ops import dft as pt_dft
from fast_speech_enhancement_metrics_tpu_torch.ops import resample as pt_resample
from fast_speech_enhancement_metrics_tpu_torch.ops import stft as pt_stft
from fast_speech_enhancement_metrics_tpu_torch.ops import toeplitz as pt_toeplitz

STOI_WINDOW = np.pad(jax_stft.hann_window(257)[1:], (128, 128))
STOI_KEY = tuple(STOI_WINDOW.astype(np.float64).tolist())


def _close(got, want, rtol=1e-5):
    got = np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(np.abs(want).max(), 1e-30))


TABLES = {
    "rdft_512": lambda m: m._rdft_matrices(512),
    "rdft_1024": lambda m: m._rdft_matrices(1024),
    "chunk_rdft_packed_512": lambda m: m._chunk_rdft_matrix_packed(512),
    "split_window_chunk_stoi": lambda m: m._split_window_chunk_matrices(512, STOI_KEY, 224),
    "inverse_lag_512": lambda m: m._inverse_lag_matrices(512, 512),
}


@pytest.mark.parametrize("name", sorted(TABLES))
def test_dft_tables_bit_equal(name):
    ours, theirs = TABLES[name](pt_dft), TABLES[name](jax_dft)
    ours = ours if isinstance(ours, tuple) else (ours,)
    theirs = theirs if isinstance(theirs, tuple) else (theirs,)
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("rates", [(16000, 10000), (48000, 16000), (8000, 16000)])
def test_resample_tables_bit_equal(rates):
    ours = pt_resample._block_resample_matrix(*rates)
    theirs = jax_resample._block_resample_matrix(*rates)
    assert np.array_equal(ours[0], theirs[0]) and ours[1:] == theirs[1:]
    k_ours = pt_resample.sinc_resample_kernel(*rates)
    k_theirs = jax_resample.sinc_resample_kernel(*rates)
    assert np.array_equal(k_ours[0], k_theirs[0]) and k_ours[1:] == k_theirs[1:]


def test_stoi_tables_bit_equal():
    assert np.array_equal(pt_stoi.third_octave_band_matrix(), jax_stoi.third_octave_band_matrix())
    ours = pt_stoi.STOI(device="cpu")
    theirs = jax_stoi.STOI()
    assert np.array_equal(ours.window, theirs.window)
    assert np.array_equal(ours.stft_window, theirs.stft_window)
    assert ours.dft_bins == theirs.dft_bins
    for n, periodic in ((256, True), (257, True), (512, False)):
        assert np.array_equal(pt_stft.hann_window(n, periodic), jax_stft.hann_window(n, periodic))


@pytest.mark.parametrize("length,frame_length,hop", [(1000, 256, 128), (1000, 512, 256), (100, 256, 128)])
def test_frame_matches_jax(length, frame_length, hop):
    x = np.random.RandomState(0).randn(3, length).astype(np.float32)
    ours = pt_stft.frame(torch.from_numpy(x), frame_length, hop).numpy()
    theirs = np.asarray(jax_stft.frame(x, frame_length, hop))
    assert pt_stft.num_frames(length, frame_length, hop) == jax_stft.num_frames(length, frame_length, hop)
    np.testing.assert_array_equal(ours, theirs)


STFT_CASES = {  # n_fft, hop, win_length, center, window, input rank
    "centered": (512, 256, None, True, None, 2),
    "short_window": (512, 160, 400, False, None, 2),
    "short_window_centered_1d": (512, 128, 300, True, None, 1),
    "custom_window_1d": (256, 64, None, False, "custom", 1),
    "hop_past_frame": (128, 200, None, False, None, 2),
}


def _stft_case(name):
    n_fft, hop, win_length, center, window, rank = STFT_CASES[name]
    x = np.random.RandomState(12).randn(*((3, 3001) if rank == 2 else (3001,))).astype(np.float32)
    if window == "custom":
        window = np.random.RandomState(13).uniform(0.1, 1.0, n_fft).astype(np.float32)
    return x, dict(n_fft=n_fft, hop=hop, win_length=win_length, center=center, window=window)


@pytest.mark.parametrize("name", sorted(STFT_CASES))
def test_stft_matches_jax_and_torch_stft(name):
    """The port's ``stft`` against JAX's and against ``torch.stft`` (constant
    padding, frames moved before bins), rtol/atol 1e-5 of the output's scale."""
    x, kw = _stft_case(name)
    ours = pt_stft.stft(torch.from_numpy(x), **kw)
    theirs = np.asarray(jax_stft.stft(x, **kw))
    assert ours.dtype == torch.complex64
    _close(ours.real, theirs.real)
    _close(ours.imag, theirs.imag)
    win_length = kw["win_length"] or kw["n_fft"]
    window = torch.hann_window(win_length) if kw["window"] is None else torch.from_numpy(kw["window"])
    ref = torch.stft(torch.from_numpy(x), kw["n_fft"], kw["hop"], win_length, window=window, center=kw["center"],
                     pad_mode="constant", return_complex=True).transpose(-1, -2)
    _close(ours.real, ref.real)
    _close(ours.imag, ref.imag)


@pytest.mark.parametrize("power", [1.0, 2.0, 0.5])
@pytest.mark.parametrize("name", ["centered", "short_window_centered_1d", "hop_past_frame"])
def test_spectrogram_matches_jax(name, power):
    x, kw = _stft_case(name)
    ours = pt_stft.spectrogram(torch.from_numpy(x), power=power, **kw)
    _close(ours, jax_stft.spectrogram(x, power=power, **kw))
    assert ours.dtype == torch.float32


def test_stft_gapped_frames_match_the_jax_gather():
    """hop > n_fft: ``unfold`` gives the frames JAX's gather fallback takes."""
    x = np.random.RandomState(14).randn(2, 1000).astype(np.float32)
    ours = pt_stft.frame(torch.from_numpy(x), 64, 150).numpy()
    np.testing.assert_array_equal(ours, np.asarray(jax_stft.frame(x, 64, 150)))
    assert ours.shape == (2, 7, 64)
    win = pt_stft._window_cache(400, 512, True)
    assert pt_stft._window_cache(400, 512, True) is win
    np.testing.assert_array_equal(win, jax_stft._window_cache(400, 512, True))


@pytest.mark.parametrize(
    "n_fft,hop,center,window",
    [(512, 256, True, None), (512, 128, False, None), (256, 128, False, None), (512, 128, False, "stoi")],
)
def test_framed_rdft_matches_jax(n_fft, hop, center, window):
    x = np.random.RandomState(7).randn(3, 4000).astype(np.float32)
    win = STOI_WINDOW if window == "stoi" else None
    re, im = pt_dft.framed_rdft(torch.from_numpy(x), n_fft, hop, center=center, window=win)
    jre, jim = jax_dft.framed_rdft(x, n_fft, hop, center=center, window=win, precision="highest")
    _close(re, jre)
    _close(im, jim)
    mag = pt_dft.framed_spectrogram(torch.from_numpy(x), n_fft, hop, center=center, window=win, power=1.0)
    jmag = jax_dft.framed_spectrogram(x, n_fft, hop, center=center, window=win, power=1.0, precision="highest")
    _close(mag, jmag)


def test_framed_rdft_short_input():
    re, im = pt_dft.framed_rdft(torch.zeros(2, 100), 512, 256)
    assert re.shape == (2, 0, 257) and im.shape == (2, 0, 257)


@pytest.mark.parametrize("length", [3000, 7 * 128 + 512])
def test_framed_rdft_center_half_matches_jax(length):
    x = np.random.RandomState(8).randn(3, length).astype(np.float32)
    re, im = pt_dft.framed_rdft_center_half(torch.from_numpy(x), 512, 128, STOI_WINDOW, n_bins=224)
    jre, jim = jax_dft.framed_rdft_center_half(x, 512, 128, STOI_WINDOW, precision="highest", n_bins=224)
    _close(re, jre)
    _close(im, jim)


@pytest.mark.parametrize("t,n_lags", [(4000, 512), (4096, 512), (1000, 128), (300, 512)])
def test_correlation_lags_matches_jax(t, n_lags):
    rs = np.random.RandomState(9)
    c = rs.randn(3, t).astype(np.float32)
    d = rs.randn(3, t).astype(np.float32)
    ct = torch.from_numpy(c)
    r0, b = pt_dft.correlation_lags(ct, (ct, torch.from_numpy(d)), n_lags)
    jr0, jb = jax_dft.correlation_lags(c, (c, d), n_lags, precision="highest")
    # an all-to-all sum over T terms: the absolute floor scales with max|r0|
    scale = float(np.abs(np.asarray(jr0)).max())
    np.testing.assert_allclose(r0.numpy(), np.asarray(jr0), rtol=1e-5, atol=1e-5 * scale)
    np.testing.assert_allclose(b.numpy(), np.asarray(jb), rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.parametrize("rates,length", [((16000, 10000), 16000), ((48000, 16000), 9001), ((8000, 16000), 4000)])
def test_resample_matches_jax(rates, length):
    x = np.random.RandomState(3).randn(2, length).astype(np.float32)
    ours = pt_resample.resample(torch.from_numpy(x), *rates)
    theirs = jax_resample.resample(x, *rates, precision="highest")
    _close(ours, theirs)


def test_resample_identity():
    x = torch.randn(2, 100)
    assert pt_resample.resample(x, 16000, 16000) is x


def _spd_rows(n, rows=5, seed=11):
    rs = np.random.RandomState(seed)
    r = (0.9 ** np.arange(n))[None] * rs.uniform(0.5, 20.0, (rows, 1))
    r = r + 0.01 * rs.randn(rows, n) * r[:, :1]
    r[:, 0] = np.abs(r[:, 0]) + 1.0
    return r.astype(np.float32), rs.randn(rows, n).astype(np.float32)


@pytest.mark.parametrize("solver", ["levinson_solve", "symmetric_toeplitz_solve"])
def test_toeplitz_solvers_match_jax(solver):
    r, b = _spd_rows(64)
    ours = getattr(pt_toeplitz, solver)(torch.from_numpy(r), torch.from_numpy(b)).numpy()
    theirs = np.asarray(getattr(jax_toeplitz, solver)(r, b))
    np.testing.assert_allclose(ours, theirs, rtol=2e-3, atol=2e-3 * np.abs(theirs).max())


def test_symmetric_toeplitz_solve_falls_back_to_lu():
    """An indefinite row fails Cholesky and is solved by LU instead."""
    r, b = _spd_rows(16, rows=2)
    r[1, 0] = -r[1, 0]  # negative diagonal: not positive definite
    sol = pt_toeplitz.symmetric_toeplitz_solve(torch.from_numpy(r), torch.from_numpy(b)).numpy()
    idx = np.abs(np.arange(16)[None, :] - np.arange(16)[:, None])
    for i in range(2):
        want = np.linalg.solve(r[i][idx].astype(np.float64), b[i].astype(np.float64))
        np.testing.assert_allclose(sol[i], want, rtol=1e-3, atol=1e-3 * np.abs(want).max())


def test_device_table_is_cached_per_device():
    table = pt_dft._rdft_matrices(64)[0]
    a = pt_stft.device_table(table, torch.device("cpu"))
    assert pt_stft.device_table(table, torch.device("cpu")) is a
    np.testing.assert_array_equal(a.numpy(), table)

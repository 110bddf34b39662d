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

from fast_speech_enhancement_metrics_tpu_torch import LSD, SDR, STOI
from fast_speech_enhancement_metrics_tpu_torch.ops import (
    cuda_lib,
    levinson_pallas,
    lsd_fused,
    sdr_corr_gram,
    stoi_fused,
    toeplitz,
)
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


@pytest.mark.parametrize("t", [32768, 7000, 150])
def test_corr_kernel_matches_plain(dev, t):
    c, d = _audio(dev, t=t)
    ra, rc = sdr_corr_gram.correlation_lags_gram(c, d, 512)
    pa, pc = sdr_corr_gram._correlation_lags_plain(c, d, 512)
    scale = pa.abs().max().item()
    torch.testing.assert_close(ra, pa, rtol=0, atol=2e-4 * scale)
    torch.testing.assert_close(rc, pc, rtol=0, atol=2e-4 * scale)


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


@pytest.mark.parametrize("t", [32768, 30000])
def test_metrics_on_card_match_cpu(dev, t):
    """The metrics through ``__call__`` on the card against the CPU plain
    path; 30000 samples is not hop-aligned, so LSD on the card raises
    there (kernel A2 is not ported) unless asked for its framed-DFT path."""
    clean, noisy, _ = load_audio_data(t / 16000, 3, 16000)
    aligned = t % 256 == 0
    if not aligned:
        with pytest.raises(NotImplementedError, match="A2"):
            LSD(device=dev)(clean, noisy)
    lsd_kw = {} if aligned else {"spectral_impl": "xla"}
    for cls, kw, tol in ((LSD, lsd_kw, 2e-4), (SDR, {}, 1e-2), (STOI, {"sample_rate": 16000}, 5e-4)):
        on_card = cls(device=dev, **kw)(clean, noisy)
        on_cpu = cls(device="cpu", **kw)(clean, noisy)
        for a, b in zip(on_card, on_cpu):
            for k, v in b.items():
                assert a[k] == pytest.approx(v, rel=tol if cls is LSD else 0, abs=tol)

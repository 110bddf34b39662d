"""The FLOP and byte counts against hand reckonings written out here."""

from __future__ import annotations

import json
from pathlib import Path

import pytest

from portbench import harness
from portbench.peaks import PEAKS, least_seconds
from portbench.systems import dnsmos, speechbertscore

ROOT = Path(__file__).resolve().parents[2]
SBS = json.loads((ROOT / "portbench/configs/sbs-mhubert147.json").read_text())
DNS = json.loads((ROOT / "portbench/configs/dnsmos-p835.json").read_text())
H100 = PEAKS["NVIDIA H100 80GB HBM3"]
SIXTEEN_S = 16 * 16000


def test_mhubert147_flops_at_16_s():
    # conv encoder: 51 199, 25 599, 12 799, 6 399, 3 199, 1 599, 799 frames
    conv = (2 * 51199 * 512 * 1 * 10 + 2 * 25599 * 512 * 512 * 3 + 2 * 12799 * 512 * 512 * 3
            + 2 * 6399 * 512 * 512 * 3 + 2 * 3199 * 512 * 512 * 3 + 2 * 1599 * 512 * 512 * 2
            + 2 * 799 * 512 * 512 * 2)
    projection = 2 * 799 * 512 * 768
    positional = 2 * 799 * 768 * 48 * 128  # 16 groups of 48 channels, 128 taps
    layer = 2 * 799 * 768 * 2304 + 4 * 799 * 799 * 768 + 2 * 799 * 768 * 768 + 4 * 799 * 768 * 3072
    row = conv + projection + positional + 8 * layer
    flops, frames = speechbertscore.row_flops(SBS["model"], 8, SIXTEEN_S)
    assert frames == 799
    assert flops == pytest.approx(row, rel=1e-12)
    assert 192e9 < row < 195e9  # "about 193 GFLOP a 16 s row"
    pair = 2 * row + 2 * 799 * 799 * 768  # both rows and F1's similarity product
    assert speechbertscore.call_flops(SBS, [SIXTEEN_S] * 64) == pytest.approx(64 * pair, rel=1e-12)


def test_dnsmos_flops_at_16_s():
    f = 1599  # 1 600 chunks of 160 samples, 320-sample frames
    stft = 2 * f * 320 * 322
    trunk = (2 * f * 161 * 9 * (1 * 128 + 128 * 64 + 64 * 64 + 64 * 32)
             + 2 * 799 * 80 * 9 * 32 * 32 + 2 * 399 * 40 * 9 * 32 * 32 + 2 * 199 * 20 * 9 * 32 * 64)
    mlp = 7 * 2 * (64 * 128 + 128 * 64 + 64 * 3)  # 7 windows of 9.01 s at 1 s hops
    assert dnsmos.clip_flops(DNS, SIXTEEN_S) == pytest.approx(stft + trunk + mlp, rel=1e-12)
    assert 68e9 < stft + trunk + mlp < 70e9  # "about 69 GFLOP a 16 s clip"
    # a 2 s clip is doubled to 16 s before it is scored
    assert dnsmos.clip_flops(DNS, 2 * 16000) == dnsmos.clip_flops(DNS, SIXTEEN_S)


@pytest.mark.parametrize("which, want_ms", [("a7", 0.3709), ("a8", 0.4879)])
def test_attn_block_least_time(which, want_ms):
    """A7 and A8 on one mHuBERT-147 layer at 64 x 799 x 768: the bounds of
    PERF.md's kernel table, both set by operations."""
    r = harness.reader("attn_block_roofline")
    shape = (64, 799, 768)
    counts = r.a7(shape, 768) if which == "a7" else r.a8(shape, 768, 3072)
    assert least_seconds(*counts, H100) * 1e3 == pytest.approx(want_ms, abs=1e-4)
    assert counts[0] / H100["bf16_flops"] > counts[1] / H100["bytes_per_s"]

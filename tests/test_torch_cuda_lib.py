"""PyTorch port, the seam between the wrappers in ``ops/`` and their kernels (``ops/cuda_lib.py``).

On the CPU: ``dispatch``'s device rule, every public kernel wrapper raising
its own ``no ... for device meta`` through it, and ``launch``'s count of
launches against a stand-in library (the kernels themselves run only on a
card: ``tests/test_torch_kernels_cuda.py``, which also checks the counts
there).

This file imports no JAX, so it runs without tests/conftest.py.
"""

import contextlib
import re
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from fast_speech_enhancement_metrics_tpu_torch import tracing
from fast_speech_enhancement_metrics_tpu_torch.ops import (
    attn_block_pallas,
    conv_gelu,
    cuda_lib,
    levinson_pallas,
    lsd_fused,
    pos_conv,
    relpos_attention,
    sdpa_pallas,
    sdr_corr_fused,
    sdr_corr_gram,
    stoi_fused,
)

OPS_DIR = Path(cuda_lib.__file__).parent


def _meta(*shape, dtype=torch.float32):
    return torch.empty(*shape, device="meta", dtype=dtype)


#: (module, wrapper, its call on meta tensors, the ``what`` of its message)
WRAPPERS = [
    (lsd_fused, "split_pieces", lambda: lsd_fused.split_pieces(_meta(2, 1000), _meta(2, 1000), 1024),
     "split kernel"),
    (lsd_fused, "lsd_wholesig", lambda: lsd_fused.lsd_wholesig(_meta(2, 1000), _meta(2, 1000), 256, 1e-8),
     "LSD kernel"),
    (lsd_fused, "lsd_framed", lambda: lsd_fused.lsd_framed(_meta(2, 1000), _meta(2, 1000), 256, 1e-8),
     "LSD kernel"),
    (lsd_fused, "lsd_wholesig_raw", lambda: lsd_fused.lsd_wholesig_raw(_meta(2, 1024), _meta(2, 1024), 256, 1e-8),
     "LSD kernel"),
    (lsd_fused, "lsd_wholesig_ct", lambda: lsd_fused.lsd_wholesig_ct(_meta(2, 1024), _meta(2, 1024), 256, 1e-8),
     "LSD kernel"),
    (sdr_corr_gram, "split_halves", lambda: sdr_corr_gram.split_halves(_meta(2, 1000), _meta(2, 1000), 1024),
     "split kernel"),
    (sdr_corr_gram, "correlation_lags_gram",
     lambda: sdr_corr_gram.correlation_lags_gram(_meta(2, 1000), _meta(2, 1000), 512), "correlation kernel"),
    (sdr_corr_fused, "correlation_lags_fused",
     lambda: sdr_corr_fused.correlation_lags_fused(_meta(2, 1000), _meta(2, 1000), 512), "correlation kernel"),
    (levinson_pallas, "levinson_solve_fused",
     lambda: levinson_pallas.levinson_solve_fused(_meta(2, 512), _meta(2, 512)), "Levinson kernel"),
    (stoi_fused, "stoi_segment_sums",
     lambda: stoi_fused.stoi_segment_sums(_meta(2, 60, 15), _meta(2, 60, 15), _meta(2, dtype=torch.int32)),
     "STOI kernel"),
    (sdpa_pallas, "split_pieces", lambda: sdpa_pallas.split_pieces(*(_meta(1, 2, 70, 64) for _ in range(3))),
     "split kernel"),
    (sdpa_pallas, "sdpa", lambda: sdpa_pallas.sdpa(*(_meta(1, 2, 70, 64) for _ in range(3)), 0.125),
     "attention kernel"),
    (sdpa_pallas, "flash_sdpa", lambda: sdpa_pallas.flash_sdpa(*(_meta(1, 2, 70, 64) for _ in range(3)), 0.125),
     "attention kernel"),
    (attn_block_pallas, "gemm",
     lambda: attn_block_pallas.gemm(_meta(8, 64, dtype=torch.bfloat16), _meta(64, 32, dtype=torch.bfloat16),
                                    _meta(32)), "GEMM kernel"),
    (attn_block_pallas, "gemm_i8",
     lambda: attn_block_pallas.gemm_i8(_meta(8, 64, dtype=torch.int8), _meta(32, 64, dtype=torch.int8), _meta(8),
                                       _meta(32), _meta(32)), "int8 GEMM kernel"),
    (attn_block_pallas, "attn_block", lambda: attn_block_pallas.attn_block(_meta(2, 8, 64), (), 4, 1e-5),
     "attention-block kernel"),
    (attn_block_pallas, "attn_block int8",
     lambda: attn_block_pallas.attn_block(_meta(2, 8, 64), (), 4, 1e-5, quant="int8"), "attention-block kernel"),
    (attn_block_pallas, "ffn_block", lambda: attn_block_pallas.ffn_block(_meta(2, 8, 64), (), 1e-5),
     "FFN-block kernel"),
    (attn_block_pallas, "layer_block", lambda: attn_block_pallas.layer_block(_meta(2, 8, 64), (), (), 4, 1e-5),
     "layer kernel"),
    (relpos_attention, "relpos_attention",
     lambda: relpos_attention.relpos_attention(_meta(2, 8, 3 * 64 + 8, dtype=torch.bfloat16), _meta(4),
                                               _meta(4, 256), 4), "relative-position attention kernel"),
    (relpos_attention, "prenorm_in", lambda: relpos_attention.prenorm_in(_meta(2, 8, 64), (), 1e-5),
     "pre-LN layer kernels"),
    (relpos_attention, "prenorm_out",
     lambda: relpos_attention.prenorm_out(_meta(2, 8, 64), _meta(2, 8, 64, dtype=torch.bfloat16), (), 1e-5),
     "pre-LN layer kernels"),
    (conv_gelu, "conv_gelu", lambda: conv_gelu.conv_gelu(_meta(2, 64, 101), _meta(64, 64, 3)), "conv_gelu kernel"),
    (conv_gelu, "conv_ln_gelu",
     lambda: conv_gelu.conv_ln_gelu(_meta(2, 64, 101), _meta(128, 64, 3), _meta(128), _meta(128), 1e-5),
     "conv_ln_gelu kernel"),
    (conv_gelu, "conv0_ln_gelu",
     lambda: conv_gelu.conv0_ln_gelu(_meta(2, 1, 1000), _meta(512, 1, 10), _meta(512), _meta(512), 1e-5),
     "conv0_ln_gelu kernel"),
    (pos_conv, "pos_conv", lambda: pos_conv.pos_conv(_meta(2, 40, 96), _meta(96, 48, 128), _meta(96), 2),
     "pos_conv kernel"),
]


@pytest.mark.parametrize("module,name,call,what", WRAPPERS, ids=[f"{m.__name__.split('.')[-1]}.{n}"
                                                                for m, n, _, _ in WRAPPERS])
def test_wrapper_raises_on_a_device_with_neither_version(module, name, call, what):
    """A device that is neither the CPU nor a card has no plain version and
    no kernel: each wrapper raises, naming what it lacks and the device."""
    with pytest.raises(ValueError, match=f"^no {re.escape(what)} for device meta$"):
        call()


def test_every_module_that_dispatches_has_a_case():
    dispatching = {p.stem for p in OPS_DIR.glob("*.py") if "cuda_lib.dispatch(" in p.read_text()}
    covered = {m.__name__.split(".")[-1] for m, _, _, _ in WRAPPERS}
    assert dispatching == covered


def test_device_rules_live_in_cuda_lib():
    """No module of ``ops/`` but ``cuda_lib`` writes the device rule's error
    or counts a launch itself."""
    for p in OPS_DIR.glob("*.py"):
        if p.stem != "cuda_lib":
            text = p.read_text()
            assert "for device" not in text and "launch_counts" not in text, p.name


@pytest.mark.parametrize("device,want", [("cpu", "plain"), ("cuda", "kernel"), ("cuda:1", "kernel")])
def test_dispatch_takes_the_plain_version_on_the_cpu_and_the_kernel_on_a_card(device, want):
    got = cuda_lib.dispatch("test kernel", torch.device(device), lambda a, b: ("plain", a, b),
                            lambda a, b: ("kernel", a, b), 1, 2)
    assert got == (want, 1, 2)


class _FakeLibrary:
    """Stands in for the built library: every entry point returns ``err``."""

    def __init__(self, err: int):
        self.calls = []
        self.err = err

    def __getattr__(self, name):
        if name == "fsem_error_string":
            return lambda err: b"stand-in error"
        return lambda *args: self.calls.append((name, args)) or self.err


@pytest.fixture
def fake_card(monkeypatch):
    """``launch`` against a stand-in library and stream, with the counter cleared."""

    def install(err=0):
        lib = _FakeLibrary(err)
        monkeypatch.setattr(cuda_lib, "_library", lambda: lib)
        monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
        monkeypatch.setattr(torch.cuda, "current_stream", lambda device: SimpleNamespace(cuda_stream=7))
        return lib

    saved = dict(cuda_lib.launch_counts)
    cuda_lib.launch_counts.clear()
    yield install
    cuda_lib.launch_counts.clear()
    cuda_lib.launch_counts.update(saved)


@pytest.mark.parametrize("count,key", [(None, "gemm"), ("flash_sdpa", "flash_sdpa")])
def test_launch_counts_each_launch_under_the_kernels_name(fake_card, count, key):
    lib = fake_card()
    t = torch.zeros(4)
    for _ in range(3):
        cuda_lib.launch("gemm", torch.device("cuda"), t, 5, 0.5, count=count)
    assert cuda_lib.launch_counts is tracing.launch_counts
    assert dict(cuda_lib.launch_counts) == {key: 3}
    assert lib.calls == [("fsem_gemm", (t.data_ptr(), 5, 0.5, 7))] * 3


def test_a_failed_launch_raises_and_counts_nothing(fake_card):
    fake_card(err=700)
    with pytest.raises(RuntimeError, match="CUDA kernel gemm failed to launch: stand-in error"):
        cuda_lib.launch("gemm", torch.device("cuda"), torch.zeros(4))
    assert sum(cuda_lib.launch_counts.values()) == 0

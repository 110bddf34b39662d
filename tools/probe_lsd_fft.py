"""Split A13's device time (LSD's float32 FFT kernel, csrc/lsd_fused.cu's fft::) by phase on one CUDA card.

Usage, from the repository root, on a machine with a CUDA card:

    python3 tools/probe_lsd_fft.py [--rounds N]

Builds variants of ``csrc/lsd_fused.cu`` into small libraries of their own
(under the package's git-ignored ``_build_probe/``), each with one change
to the FFT kernel, and launches their ``fsem_lsd_wholesig_ct`` entry point
on LSD's main shape (64 x 16 s at 16 kHz, raw pairs, the scale computed by
the entry point's own pass) in turns, N rounds, with the card kept busy
while the host enqueues (as ``tools/time_lsd.py``'s ``device_ms``). The
variants: the kernel as it is; without phase (3) (the frame combine, Hann
and log ratio); without phases (2) and (3); without any of the three (the
loads, the barriers, the scale pass and the finalize remain); phase (3)'s
quotient by IEEE ``/`` in place of ``common.cuh::div_rn``; phase (3)'s log
by ``__logf`` (MUFU). The variants without phases compute wrong scores:
their times bound what each phase costs, not what it would cost alone.
Prints the card's name and power limit, then one JSON line a variant: its
median device time (the scale pass, the FFT kernel and the finalize) and
its largest difference from the plain version. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from fast_speech_enhancement_metrics_tpu_torch.ops import cuda_lib, lsd_fused  # noqa: E402
from fast_speech_enhancement_metrics_tpu_torch.utils.audio import load_audio_data  # noqa: E402

BATCH, SECONDS, RATE, HOP, EPS = 64, 16, 16000, 256, 1e-8
# the text each variant changes in the kernel's source
PHASE1 = "    {\n      const int j1 = tid / (8 * kItems) & 1"
PHASE2 = "    for (int r = 0; r < kItems * 64 / kThreads; ++r) {"
PHASE3 = "    const int q = kStepChunks * s + warp % kStepChunks, h = warp / kStepChunks;\n    if (q >= 1) {"
QUOTIENT = "logf(fsem::div_rn(p[0], dd, fsem::rcp_rn(dd)) + eps)"


def variants(src: str) -> dict[str, str]:
    for anchor in (PHASE1, PHASE2, PHASE3, QUOTIENT):
        if anchor not in src:
            raise SystemExit(f"probe_lsd_fft: the kernel source no longer holds {anchor!r}")
    no3 = src.replace(PHASE3, PHASE3.replace("if (q >= 1)", "if (false && q >= 1)"))
    no23 = no3.replace(PHASE2, PHASE2.replace("r < kItems", "r < 0 * kItems"))
    return {
        "kernel": src,
        "without_phase3": no3,
        "without_phases23": no23,
        "without_phases123": no23.replace(PHASE1, PHASE1.replace("    {\n", "    if (false) {\n", 1)),
        "ieee_division": src.replace(QUOTIENT, "logf(p[0] / dd + eps)"),
        "mufu_log": src.replace(QUOTIENT, "__logf(fsem::div_rn(p[0], dd, fsem::rcp_rn(dd)) + eps)"),
    }


def build(texts: dict[str, str]) -> dict:
    out = cuda_lib.PACKAGE_DIR / "_build_probe"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for tag, text in texts.items():
        (out / f"{tag}.cu").write_text(text)
        procs[tag] = subprocess.Popen(
            [cuda_lib._nvcc(), *cuda_lib.ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-shared",
             f"-I{cuda_lib.CSRC_DIR}", str(out / f"{tag}.cu"), "-o", str(out / f"lib{tag}.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for tag, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"probe_lsd_fft: nvcc failed on {tag}:\n{log}")
        fn = ctypes.CDLL(str(out / f"lib{tag}.so")).fsem_lsd_wholesig_ct
        fn.argtypes = (ctypes.c_void_p,) * 8 + (ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p)
        fn.restype = ctypes.c_int
        fns[tag] = fn
    return fns


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe_lsd_fft: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0], flush=True)
    fns = build(variants((cuda_lib.CSRC_DIR / "lsd_fused.cu").read_text()))
    dev = torch.device("cuda", 0)
    c, d, _ = load_audio_data(SECONDS, BATCH, RATE)
    c, d = torch.from_numpy(c).to(dev), torch.from_numpy(d).to(dev)
    nc = c.shape[1] // HOP
    tw, w0, _ = (torch.from_numpy(a).to(dev) for a in lsd_fused._ct_constants())
    scale_partial = torch.empty(BATCH, 16, 2, device=dev)
    partial = torch.empty(BATCH, -(-(nc + 1) // lsd_fused._CT_TILE_FRAMES), device=dev)
    out = torch.empty(BATCH, device=dev)
    want = lsd_fused._lsd_wholesig_ct_plain(c, d, HOP, EPS)

    def call(fn):
        err = fn(c.data_ptr(), d.data_ptr(), None, tw.data_ptr(), w0.data_ptr(), scale_partial.data_ptr(),
                 partial.data_ptr(), out.data_ptr(), BATCH, nc, EPS, torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise SystemExit(f"probe_lsd_fft: launch failed ({err})")

    errs = {}
    for tag, fn in fns.items():
        call(fn)
        torch.cuda.synchronize()
        errs[tag] = (out - want).abs().max().item()
    times = {tag: [] for tag in fns}
    for _ in range(args.rounds):
        for tag, fn in fns.items():
            torch.cuda._sleep(1_000_000)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            call(fn)
            end.record()
            end.synchronize()
            times[tag].append(start.elapsed_time(end))
    for tag in fns:
        print(json.dumps({"variant": tag, "device_ms": statistics.median(times[tag]), "err_vs_plain": errs[tag]}),
              flush=True)


if __name__ == "__main__":
    main()

"""Build, load and launch the package's hand-written CUDA kernels.

The kernel sources under ``csrc/`` are compiled by ``nvcc`` for Hopper
(``sm_90a``) at first use: one ``nvcc -c`` per source, all started
together, then one link into a shared library with a plain C interface,
loaded with ctypes. The library's name carries a hash of the sources and
flags, so an edited source is rebuilt and a built one is reused. The build
directory (``_build/`` in the package) is generated and not tracked.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; ``launch`` raises if that is not 0, and else adds
one to ``launch_counts`` under the kernel's name (the counter lives with
the port's other spans and counters in ``tracing.py``). ``dispatch`` is the
wrappers' device rule: a CPU tensor takes the plain version, a CUDA tensor
the kernel, and any other device raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from fast_speech_enhancement_metrics_tpu_torch.tracing import launch_counts

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
HEADERS = (
    "common.cuh", "block_tiles.cuh", "block_stages.cuh", "sm90.cuh", "flash_sm90.cuh", "flash_f32_sm90.cuh",
    "gemm_sm90.cuh", "sdr_halves.cuh", "levinson.cuh",
)
SOURCES = (
    "runtime.cu", "lsd_fused.cu", "sdr_corr_gram.cu", "levinson.cu", "stoi_fused.cu",
    "attn_block.cu", "sdpa.cu", "sdpa_f32.cu", "sdr_corr_fused.cu", "layer_block.cu",
    "attn_block_int8.cu", "levinson_flat.cu", "levinson_dotreduce.cu", "levinson_double.cu", "conv_gelu.cu",
    "relpos_attn.cu", "pos_conv.cu",
)
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    # (clean, denoised, bf16 pieces, bf16 tile table pieces, scale partials,
    #  frame partials, out, batch, chunks, eps, stream)
    "fsem_lsd_wholesig_raw": (_P,) * 7 + (_I, _I, _F, _P),
    # (clean, denoised, bf16 pieces, bf16 tile table pieces, frame partials,
    #  out, batch, samples, eps, stream)
    "fsem_lsd_wholesig": (_P,) * 6 + (_I, _L, _F, _P),
    # (clean, denoised, scale partials or null, bf16 pieces, batch, samples,
    #  row length, eps, stream)
    "fsem_lsd_split": (_P,) * 4 + (_I, _L, _L, _F, _P),
    # (clean, denoised, scale or null, fold twiddles, branch DFT table, scale
    #  partials, tile partials, out, batch, chunks, eps, stream)
    "fsem_lsd_wholesig_ct": (_P,) * 8 + (_I, _I, _F, _P),
    # (clean, denoised, bf16 halves, k-range partials, r_auto, r_cross, batch,
    #  samples, split terms 4 / 3 / 1, frames per k range, k ranges, stream)
    "fsem_correlation_lags_gram": (_P,) * 6 + (_I, _L, _I, _I, _I, _P),
    # (clean, denoised, bf16 halves, batch, samples, row length, lo planes, stream)
    "fsem_split_halves": (_P, _P, _P, _I, _L, _L, _I, _P),
    # (r0, b, x, batch, order, variant, stream)
    "fsem_levinson_solve": (_P, _P, _P, _I, _I, _I, _P),
    # (tob clean, tob denoised, num_segments, tile partials, out, batch, frames, stream)
    "fsem_stoi_segment_sums": (_P, _P, _P, _P, _P, _I, _I, _P),
    # (x, wqkv, bqkv, wo, bo, ln scale, ln shift, bf16 x, qkv, ctx, y, padded
    #  q / k / v / context, out, rows, frames, width, heads, softmax mode, x and
    #  out are bf16, eps, stream)
    "fsem_attn_block": (_P,) * 13 + (_I,) * 6 + (_F, _P),
    # (x, A7's six operands, A8's six, bf16 x, qkv, ctx, y, h, hidden, padded
    #  q / k / v / context, out, rows, frames, width, heads, ffn, softmax mode,
    #  x and out are bf16, eps, stream)
    "fsem_layer_block": (_P,) * 21 + (_I,) * 7 + (_F, _P),
    # (x, int8 wqkv (3d, d), [bqkv; column scales], int8 wo (d, d), [bo; column
    #  scales], ln scale, ln shift, x / ctx int8, row scales, qkv fp32, q / k
    #  int8 head-major, their scales, v column scales, v int8 transposed, ctx
    #  fp32, y, out, rows, frames, width, heads, softmax mode, x and out are
    #  bf16, eps, stream)
    "fsem_attn_block_int8": (_P,) * 17 + (_I,) * 6 + (_F, _P),
    # (a, bt, sa, sb, bias, c, M, N, K, stream)
    "fsem_gemm_i8": (_P,) * 6 + (_I,) * 3 + (_P,),
    # (x, w1, b1, w2, b2, ln scale, ln shift, bf16 x, hidden, y, out, rows,
    #  width, ffn, x and out are bf16, eps, stream)
    "fsem_ffn_block": (_P,) * 11 + (_I,) * 4 + (_F, _P),
    # (a, b, bias, c, M, N, K, epilogue, stream)
    "fsem_gemm": (_P,) * 4 + (_I,) * 4 + (_P,),
    # (q, k, v, out, batch, heads, frames, keys walked, head width, softmax
    #  mode, logit scale, row-sum pad, stream); bf16
    "fsem_sdpa": (_P,) * 4 + (_I,) * 6 + (_F, _F, _P),
    # (q, k, v, bf16 pieces, rows, head width, padded head width, stream)
    "fsem_sdpa_f32_split": (_P,) * 4 + (_L, _I, _I, _P),
    # (bf16 pieces, out, batch, heads, frames, keys walked, head width,
    #  softmax mode, logit scale, row-sum pad, stream); float32
    "fsem_sdpa_f32": (_P,) * 2 + (_I,) * 6 + (_F, _F, _P),
    # (clean, denoised, bf16 halves, bf16 table halves, partials, batch,
    #  samples, lags, chunk groups, stream)
    "fsem_corr_fused": (_P,) * 5 + (_I, _L, _I, _I, _P),
    # (x, bf16 weight pieces, LayerNorm scale or null, shift or null, out,
    #  batch, input channels, output channels, input frames, width, gelu, eps,
    #  stream)
    "fsem_conv_gelu": (_P,) * 5 + (_I,) * 6 + (_F, _P),
    # (x, weights, LayerNorm scale, shift, out, batch, input frames, gelu,
    #  eps, stream)
    "fsem_conv0_ln_gelu": (_P,) * 5 + (_I,) * 3 + (_F, _P),
    # (qkvg, gate constants, offset bias, ctx, rows, frames, width, heads,
    #  qkvg columns, offset half-length, softmax mode, stream)
    "fsem_relpos_attention": (_P,) * 4 + (_I,) * 7 + (_P,),
    # (x, ln1 scale, ln1 shift, wqkvg, bqkvg, bf16 u, qkvg, rows, width,
    #  qkvg columns, eps, stream)
    "fsem_prenorm_in": (_P,) * 7 + (_I,) * 3 + (_F, _P),
    # (x, ctx, wo, bo, ln2 scale, ln2 shift, w1, b1, w2, b2, y, bf16 u,
    #  hidden, out, rows, width, ffn, eps, stream)
    "fsem_prenorm_out": (_P,) * 14 + (_I,) * 3 + (_F, _P),
    # (x, bf16 weight pieces, bn scale or null, bn shift or null, bias, out,
    #  batch, frames, channels, groups, stream)
    "fsem_pos_conv": (_P,) * 6 + (_I,) * 4 + (_P,),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    return str(Path(home) / "bin" / "nvcc")


def library_path() -> Path:
    """Where the library built from the current sources and flags lives."""
    digest = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
    for name in HEADERS + SOURCES:
        digest.update(name.encode())
        digest.update((CSRC_DIR / name).read_bytes())
    return BUILD_DIR / f"libfsem_kernels_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile and link the kernel library unless it is already built.

    Raises ``RuntimeError`` with the compiler's output if a source fails.
    Each source's compiler output (``-Xptxas -v``: registers, shared
    memory, spills), then its wall time from the start of the build, is
    kept beside the library as ``<source>.log``.
    """
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}"
    jobs = []
    for name in SOURCES:
        stem = Path(name).stem
        obj = BUILD_DIR / f"{stem}.{tag}.o"
        log_path = BUILD_DIR / f"{stem}.log"
        with open(log_path, "w") as log:
            proc = subprocess.Popen(
                [nvcc, *COMPILE_FLAGS, "-c", str(CSRC_DIR / name), "-o", str(obj)],
                stdout=log, stderr=subprocess.STDOUT,
            )
        jobs.append((name, obj, log_path, proc))
    t0, pending = time.perf_counter(), list(jobs)
    while pending:  # each source's wall time, appended to its log
        for job in [j for j in pending if j[3].poll() is not None]:
            pending.remove(job)
            with open(job[2], "a") as log:
                log.write(f"nvcc wall seconds: {time.perf_counter() - t0:.1f}\n")
        time.sleep(0.05)
    failed = []
    for name, _, log_path, proc in jobs:
        if proc.returncode != 0:
            failed.append(f"--- {name}\n{log_path.read_text()}")
    objs = [str(obj) for _, obj, _, _ in jobs]
    try:
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp = so.with_name(f"{so.name}.{tag}.tmp")
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *objs],
            capture_output=True, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
        os.replace(tmp, so)
    finally:
        for obj in objs:
            Path(obj).unlink(missing_ok=True)
    return so


def _library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.fsem_error_string.argtypes = (ctypes.c_int,)
            lib.fsem_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def launch(name: str, device: torch.device, *args, count: str | None = None) -> None:
    """Call C entry point ``fsem_<name>`` on ``device``'s current stream and
    add one to ``launch_counts[count]`` (``count`` defaults to ``name``; a
    wrapper passes it where one entry point serves several kernels).

    ``args`` are the entry point's arguments before the stream: tensors
    (passed as device pointers), ints and floats. Raises ``RuntimeError``
    when the launch reports an error, and then counts nothing.
    """
    lib = _library()
    fn = getattr(lib, f"fsem_{name}")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        c_args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
        err = fn(*c_args, stream)
    if err != 0:
        msg = lib.fsem_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: {msg} ({err})")
    launch_counts[count or name] += 1


def dispatch(what: str, device: torch.device, plain, kernel, *args):
    """The wrappers' device rule: ``plain(*args)`` on a CPU device,
    ``kernel(*args)`` on a CUDA device; any other device raises
    ``ValueError("no <what> for device <device>")``."""
    if device.type == "cpu":
        return plain(*args)
    if device.type != "cuda":
        raise ValueError(f"no {what} for device {device}")
    return kernel(*args)


def check_operand(t: torch.Tensor, what: str, device: torch.device, dtype: torch.dtype, ndim: int) -> None:
    """Raise ``ValueError`` unless ``t`` is a contiguous ``ndim``-D tensor of
    ``dtype`` on ``device`` — what a kernel entry point reads raw."""
    if t.device != device or t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(
            f"{what}: need a contiguous {ndim}-D {dtype} tensor on {device}, got "
            f"{tuple(t.shape)} {t.dtype} on {t.device} (contiguous={t.is_contiguous()})"
        )

"""Time the Hopper GEMM of kernels A7 and A8 (and its int8 arm, A12's) at the main path's products.

Usage, from the repository root, on a machine with a CUDA card:

    python3 tools/time_gemm.py

For each product of one mHuBERT-147 layer at SpeechBERTScore's 64 x 16 s
shape (M = 64 x 799 = 51 136 rows; QKV 2304 x 768, W_o 768 x 768, W_1
3072 x 768 with the tanh GELU, W_2 768 x 3072), prints one JSON line: the
median time of one launch of ``attn_block_pallas.gemm`` (CUDA events around each of 10 launches after 3 warm-ups), the same
for ``torch.nn.functional.linear`` in bf16 on the same operands (the
library yardstick, with its bias in bf16; for W_1 followed by
``F.gelu``), the least time the bf16 tensor cores need for its 2 M N K
operations at 989 TFLOP/s, and the largest difference from the plain
version over the first 512 rows. Then the same for A12's int8 GEMM
(``attn_block_pallas.gemm_i8``) at the layer's QKV and W_o products on
random int8 operands and scales: its time, ``torch._int_mm`` with the same
dequantization ((acc sa) sb + bias) and alone, the least time of 2 M N K
operations on the int8 tensor cores at 1979 TOP/s, and whether it equals
its plain version over the first 512 rows. The first line is the card's
name and power limit. Needs a CUDA card.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from fast_speech_enhancement_metrics_tpu_torch.ops import attn_block_pallas, cuda_lib  # noqa: E402

PEAK_BF16_TC_FLOPS = 989e12  # H100 SXM, dense, at the full 700 W limit
PEAK_INT8_TC_OPS = 1979e12
M = 64 * 799
#: (product, N, K, epilogue)
PRODUCTS = (("qkv", 2304, 768, "bf16"), ("w_o", 768, 768, "f32"), ("w_1", 3072, 768, "gelu_bf16"),
            ("w_2", 768, 3072, "f32"))


def cuda_ms(fn, warmup: int = 3, reps: int = 10) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("time_gemm: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0], flush=True)
    cuda_lib.build()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    fn = torch.nn.functional
    for name, n, k, epi in PRODUCTS:
        a = torch.randn(M, k, generator=gen, device=dev).to(torch.bfloat16)
        b = (torch.randn(k, n, generator=gen, device=dev) * k**-0.5).to(torch.bfloat16)
        bias = torch.randn(n, generator=gen, device=dev) * 0.02
        want = attn_block_pallas._gemm_plain(a[:512], b, bias, epi).float()
        row = {"product": name, "M": M, "N": n, "K": k, "epilogue": epi,
               "bound_ms": 2 * M * n * k / PEAK_BF16_TC_FLOPS * 1e3}
        got = attn_block_pallas.gemm(a, b, bias, epi)
        row["max_abs_err"] = (got[:512].float() - want).abs().max().item()
        row["ms"] = cuda_ms(lambda: attn_block_pallas.gemm(a, b, bias, epi))
        w_t, b16 = b.t().contiguous(), bias.to(torch.bfloat16)
        if epi == "gelu_bf16":
            row["library_ms"] = cuda_ms(lambda: fn.gelu(fn.linear(a, w_t, b16), approximate="tanh"))
        else:
            row["library_ms"] = cuda_ms(lambda: fn.linear(a, w_t, b16))
        print(json.dumps(row), flush=True)
        del a, b, got
    for name, n, k in (("qkv", 2304, 768), ("w_o", 768, 768)):
        a = torch.randint(-127, 128, (M, k), generator=gen, device=dev, dtype=torch.int8)
        b_t = torch.randint(-127, 128, (n, k), generator=gen, device=dev, dtype=torch.int8)
        sa = torch.rand(M, generator=gen, device=dev) * 1e-2
        sb = torch.rand(n, generator=gen, device=dev) * 1e-2
        bias = torch.randn(n, generator=gen, device=dev) * 0.02
        got = attn_block_pallas.gemm_i8(a, b_t, sa, sb, bias)
        want = attn_block_pallas._gemm_i8_plain(a[:512], b_t, sa[:512], sb, bias)
        row = {"product": name, "int8": True, "M": M, "N": n, "K": k,
               "bound_ms": 2 * M * n * k / PEAK_INT8_TC_OPS * 1e3, "equal_to_plain": torch.equal(got[:512], want),
               "ms": cuda_ms(lambda: attn_block_pallas.gemm_i8(a, b_t, sa, sb, bias)),
               "int_mm_dequant_ms": cuda_ms(lambda: torch._int_mm(a, b_t.t()).float() * sa[:, None] * sb + bias),
               "int_mm_ms": cuda_ms(lambda: torch._int_mm(a, b_t.t()))}
        print(json.dumps(row), flush=True)
        del a, b_t, got


if __name__ == "__main__":
    main()

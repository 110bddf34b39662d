"""Hold the bf16 A9 kernel's worst query row against a float64 evaluation of the same function.

Usage, from the repository root, on a machine with a CUDA card:

    python3 tools/attention_row_witness.py [--against DIR]

A9's ``exp2_bf16`` softmax rounds each logit to bf16 before the exponent,
so a logit that sits on a bf16 rounding boundary can round either way
depending on the order its 64 products are summed in, and its probability
moves by 2^(ulp of the logit). This tool decides, for the query row where
the kernel is farthest from its plain version, which side is right: it
evaluates that row in float64 (the logits exact, the mode's roundings
applied to them, sums in float64) and prints one JSON line per input set
with each version's error over the row's max|context|: this checkout's
kernel, with ``--against`` the kernel of the checkout at DIR on the same
inputs (both libraries loaded into this process, as
``tools/time_attention.py`` does), and the plain float32 version. It also
counts the row's keys whose bf16 logit differs between float32 and
float64 sums, and the share of the row's weight they carry.

Input sets, 16 x 12 heads x 2999 frames x 64, N(0, 1.2^2) in bf16:
``shared7`` is what ``chip_smoke.py``'s A9 check drew while every A7 head
width drew from its one generator (seed 7; that draw put one row at 6.7e-2
of its max, over the class's 3e-2); ``a9`` is what it draws now, from a
generator of its own. The first line is the card's name and power limit.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

from fast_speech_enhancement_metrics_tpu_torch.models import hubert  # noqa: E402
from fast_speech_enhancement_metrics_tpu_torch.ops import sdpa_pallas  # noqa: E402
from fast_speech_enhancement_metrics_tpu_torch.ops.numerics import LN2_BF16  # noqa: E402
from time_attention import kernel_library  # noqa: E402

SHAPE = (16, 12, 2999, 64)
MODE = "exp2_bf16"
#: chip_smoke.py's seed of A9's own generator
A9_SEED = 9


def shared7_inputs(dev):
    """Replay chip_smoke.py's draws from its generator seeded 7 up to A9's
    inputs, with A7's four extra head widths all drawing from it."""
    gen = torch.Generator(device=dev).manual_seed(7)

    def rnd(*shape, scale):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    cfg = hubert.MHUBERT_147_CONFIG
    d, ffn, frames = cfg.hidden_size, cfg.intermediate_size, 799
    for _ in range(4):
        rnd(d, d, scale=1.0)
    for _ in range(5):
        rnd(d, scale=1.0)
    rnd(d, ffn, scale=1.0), rnd(ffn, scale=1.0), rnd(ffn, d, scale=1.0)
    for _ in range(4):
        rnd(d, scale=1.0)
    rnd(64, frames, d, scale=1.0)
    for d_w in (768, 1280, 768, 768):
        for _ in range(4):
            rnd(d_w, d_w, scale=1.0)
        for _ in range(6):
            rnd(d_w, scale=1.0)
        rnd(8, frames, d_w, scale=1.0)
    return [rnd(*SHAPE, scale=1.2).to(torch.bfloat16) for _ in range(3)]


def a9_inputs(dev):
    gen = torch.Generator(device=dev).manual_seed(A9_SEED)
    return [(torch.randn(*SHAPE, generator=gen, device=dev) * 1.2).to(torch.bfloat16) for _ in range(3)]


def bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(t.dtype)


def other_bf16(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """For float64 ``x``: the one of the two bf16 values around it that it
    does not round to, and how far ``x`` lies from their midpoint in units
    of their spacing (0: on the midpoint, 0.5: on a bf16 value)."""
    r = bf16(x)
    e = torch.floor(torch.log2(torch.abs(r).clamp_min(1e-30)))
    ulp = torch.exp2(e - 7)
    toward_zero = torch.abs(x) < torch.abs(r)
    spacing = torch.where(toward_zero & (torch.abs(r) == torch.exp2(e)), ulp / 2, ulp)
    other = r + torch.sign(x - r) * spacing
    return other, torch.abs(torch.abs(x - r) - spacing / 2) / spacing


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", type=Path, help="another checkout whose kernel runs on the same inputs")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("attention_row_witness: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0], flush=True)
    libs = {"this": kernel_library(ROOT, "this")}
    if args.against is not None:
        libs["against"] = kernel_library(args.against.resolve(), "against")
    dev = torch.device("cuda", 0)
    b, h, t, d = SHAPE
    scale = d**-0.5
    l_pad = sdpa_pallas._pad_keys_l(t, MODE)
    for name, draw in (("shared7", shared7_inputs), ("a9", a9_inputs)):
        q, k, v = draw(dev)
        qs = sdpa_pallas._scaled_q(q, scale, MODE)
        outs = {}
        for lib_name, lib in libs.items():
            out = torch.empty_like(q)
            lib.launch("sdpa", dev, qs, k, v, out, b, h, t, t, d, sdpa_pallas.SOFTMAX_MODES.index(MODE), 1.0, l_pad)
            outs[lib_name] = out
        plain = sdpa_pallas._sdpa_plain(q, k, v, scale, MODE)
        row_max = torch.amax(torch.abs(plain.float()), dim=-1, keepdim=True)
        rel = torch.amax(torch.abs(outs["this"].float() - plain.float()) / row_max, dim=-1)
        bi, hi, ti = (int(i) for i in torch.unravel_index(torch.argmax(rel), rel.shape))
        # the worst row in float64: exact logits, the mode's roundings, float64 sums
        q_row, k_bh, v_bh = qs[bi, hi, ti].double(), k[bi, hi].double(), v[bi, hi].double()
        s64 = k_bh @ q_row
        s32 = k_bh.float() @ q_row.float()
        p64 = bf16(torch.exp(bf16(bf16(torch.clamp(s64, -100.0, 60.0)) * LN2_BF16)))
        ctx64 = (p64 @ v_bh) / (p64.sum() + l_pad)
        ref_max = torch.max(torch.abs(ctx64)).item()
        flipped = bf16(torch.clamp(s32, -100.0, 60.0)).double() != bf16(torch.clamp(s64, -100.0, 60.0))
        row = {"inputs": name, "shape": list(SHAPE), "softmax": MODE, "row": [bi, hi, ti],
               "row_max_abs_context": ref_max,
               "keys_whose_bf16_logit_flips_fp32_vs_fp64": int(flipped.sum().item()),
               "weight_share_of_flipped_keys": (p64[flipped].sum() / p64.sum()).item(),
               "max_logit": s64.max().item()}
        versions = {f"kernel_{lib_name}": out[bi, hi, ti] for lib_name, out in outs.items()}
        versions["plain_fp32"] = plain[bi, hi, ti]
        for label, got in versions.items():
            row[f"{label}_vs_plain_over_row_max"] = (torch.max(torch.abs(got.float() - plain[bi, hi, ti].float()))
                                                     / row_max[bi, hi, ti, 0]).item()
            row[f"{label}_vs_fp64_over_row_max"] = torch.max(torch.abs(got.double() - ctx64)).item() / ref_max
        row["fp64_rounded_to_bf16_vs_fp64_over_row_max"] = torch.max(torch.abs(bf16(ctx64) - ctx64)).item() / ref_max
        # which single rounding, turned the other way, brings the float64
        # context to the kernel's: the bf16 logit, or the bf16 probability, of
        # each of the 16 keys nearest such a midpoint
        clamped = torch.clamp(s64, -100.0, 60.0)
        s_other, s_dist = other_bf16(clamped)
        e64 = torch.exp(bf16(bf16(clamped) * LN2_BF16))
        p_other, p_dist = other_bf16(e64)
        got = outs["this"][bi, hi, ti].double()
        best = None
        for kind, dist, alt in (("logit", s_dist, bf16(torch.exp(bf16(s_other * LN2_BF16)))), ("probability", p_dist, p_other)):
            for j in torch.argsort(dist)[:16].tolist():
                p = p64.clone()
                p[j] = alt[j]
                err = torch.max(torch.abs(got - (p @ v_bh) / (p.sum() + l_pad))).item() / ref_max
                if best is None or err < best["kernel_this_vs_that_fp64_over_row_max"]:
                    best = {"kind": kind, "key": j, "distance_from_midpoint": dist[j].item(),
                            "weight_share": (p64[j] / p64.sum()).item(),
                            "kernel_this_vs_that_fp64_over_row_max": err}
        row["best_single_rounding_turned"] = best
        print(json.dumps(row), flush=True)
        del q, k, v, qs, plain, outs


if __name__ == "__main__":
    main()

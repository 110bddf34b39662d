"""Where DNSMOS's float32 program and its plain reference part, row by row:
on the card with cuDNN as the program sets it, held to its deterministic
algorithms, and switched off, and on the host.

    python3 -m portbench.diagnose_dnsmos --seeds 2147488003,2147488016 [--rows 3]

For each seed: the pool of ``dnsmos.eval64x16s``, every call scored by the
program and the reference on the card; in the call with the widest gap,
the ``rows`` widest rows are followed through each mode. A card mode scores
that whole call again (the timed batch, so cuDNN sees the timed shapes) with
the program's conv flags (``models.hubert._conv_flags``, which
``models.dnsmos_net`` imports) and the reference both under it:
``"cudnn"`` as the program ships (TF32 off), ``"deterministic"`` (cuDNN's
deterministic algorithms, ``torch.use_deterministic_algorithms``), and
``"no_cudnn"`` (PyTorch's own convolutions); ``"per_window"`` scores it
with the program's other window plan (every window through the whole
net). ``"host"`` scores the rows on the CPU. One JSON line per seed: each
mode's gap per row (the widest over SIG, BAK, OVRL), and each side's
card-to-host gap. ``--save`` keeps the rows' audio in
``portbench/_runs/dnsmos_rows_<seed>.npy``. The benchmark's runs never run
this. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def _gap(a: dict, b: dict) -> float:
    return max(abs(a[k] - b[k]) for k in ("SIG", "BAK", "OVRL"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--rows", type=int, default=3)
    ap.add_argument("--save", action="store_true")
    args = ap.parse_args(argv)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")  # for deterministic cuBLAS, before CUDA starts

    import torch

    from fast_speech_enhancement_metrics_tpu_torch.models import dnsmos_net, hubert
    from portbench import harness, traffic
    from portbench.systems import dnsmos

    if not torch.cuda.is_available():
        print("portbench.diagnose_dnsmos: needs a CUDA card", file=sys.stderr)
        return 2
    card, host = torch.device("cuda"), torch.device("cpu")
    torch.set_num_threads(8)
    cell = harness.load_cell("dnsmos.eval64x16s")
    weights = dnsmos.make_weights(cell.config, 0, card)
    modes = {
        "cudnn": dict(enabled=True, allow_tf32=False),
        "deterministic": dict(enabled=True, deterministic=True, allow_tf32=False),
        "no_cudnn": dict(enabled=False),
    }
    shipped = hubert._conv_flags
    for seed in (int(s) for s in args.seeds.split(",")):
        pool = traffic.make_pool(cell.traffic, seed, card)
        program = dnsmos.build_metric(cell.config, weights, card, None)
        reference = dnsmos.Reference(cell.config, weights, card)
        widest = []
        for i, call in enumerate(pool.calls):
            got, want = program(call.clean, call.denoised), reference.scores(None, call.denoised)
            widest.append((max(_gap(g, w) for g, w in zip(got, want)), i))
        _, i = max(widest)
        call = pool.calls[i]
        out = {"seed": seed, "call": i, "call_gaps": [g for g, _ in sorted(widest, key=lambda x: x[1])]}
        scored = {}
        for mode, flags in modes.items():
            torch.use_deterministic_algorithms(mode == "deterministic", warn_only=True)
            hubert._conv_flags = dnsmos_net._conv_flags = lambda flags=flags: torch.backends.cudnn.flags(**flags)
            with torch.backends.cudnn.flags(**flags):
                scored[mode] = (program(call.clean, call.denoised), reference.scores(None, call.denoised))
        torch.use_deterministic_algorithms(False)
        hubert._conv_flags = dnsmos_net._conv_flags = shipped
        per_window = dnsmos.build_metric(dict(cell.config, metric_kwargs={"window_plan": "per_window"}), weights,
                                         card, None)
        scored["per_window"] = (per_window(call.clean, call.denoised), scored["cudnn"][1])
        got, want = scored["cudnn"]
        rows = sorted(range(len(got)), key=lambda r: -_gap(got[r], want[r]))[:args.rows]
        out["rows"] = rows
        for mode, (g, w) in scored.items():
            out[mode] = [_gap(g[r], w[r]) for r in rows]
        cpu_program = dnsmos.build_metric(cell.config, weights, host, None)
        cpu_reference = dnsmos.Reference(cell.config, weights, host)
        g_host = cpu_program(call.clean[rows], call.denoised[rows])
        w_host = cpu_reference.scores(None, call.denoised[rows])
        out["host"] = [_gap(a, b) for a, b in zip(g_host, w_host)]
        out["program_card_vs_host"] = [_gap(got[r], a) for r, a in zip(rows, g_host)]
        out["reference_card_vs_host"] = [_gap(want[r], b) for r, b in zip(rows, w_host)]
        out["scores_cudnn"] = [[got[r], want[r]] for r in rows]
        if args.save:
            harness.RUNS_DIR.mkdir(exist_ok=True)
            np.save(harness.RUNS_DIR / f"dnsmos_rows_{seed}.npy", call.denoised[rows])
        print(json.dumps(out), flush=True)
        del program, per_window, reference, cpu_program, cpu_reference
    return 0


if __name__ == "__main__":
    sys.exit(main())

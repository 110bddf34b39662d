"""Small cells for the CPU tests: the real configurations, traffic cut to a
few seconds of audio."""

from __future__ import annotations

import json

import torch

from portbench import harness

SEED = 2**31 + 11


#: every configuration under every mix (None: ``RAGGED``), cells of BENCHMARK.json or not
PAIRS = {"sbs.eval64x16s": ("sbs-mhubert147", "eval64x16s"), "dnsmos.eval64x16s": ("dnsmos-p835", "eval64x16s"),
         "sbs.ragged": ("sbs-mhubert147", None), "dnsmos.ragged": ("dnsmos-p835", None)}

#: a ragged mix for the tests of the list path: 3 pairs of 0.5-2 s a call
RAGGED = {"pairs_per_call": 3, "form": "list", "pool_calls": 2, "sample_rate": 16000, "snr_db": [-5.0, 25.0],
          "trace_calls": 1, "lengths": {"kind": "listed", "samples": [8000, 12001, 16000, 20003, 27000, 32000],
                                        "layout_seed": 0}}


def tiny_cell(name: str, pairs: int = 2, seconds: float = 1.0) -> harness.Cell:
    """The cell ``name`` (a key of ``PAIRS``) with its traffic cut to two
    short calls: the fixed mix to ``pairs`` pairs of ``seconds``."""
    with open(harness.ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    config, mix = PAIRS[name]
    cell = harness.make_cell(bench, name, config, mix or "eval64x16s")
    if mix is None:
        cell.traffic = json.loads(json.dumps(RAGGED))
        return cell
    cell.traffic.update(pool_calls=2, trace_calls=1, pairs_per_call=pairs)
    cell.traffic["lengths"]["seconds"] = seconds
    return cell


def run_tiny(name: str, trace: bool = False, variant: str | None = None, seed: int = SEED, **size) -> dict:
    torch.set_num_threads(4)
    return harness.run_cell(tiny_cell(name, **size), seed, 0.01, trace, torch.device("cpu"), variant=variant)

"""The profiled stretch: torch.profiler's trace reduced to spans.

The benchmark's own ranges (``torch.profiler.record_function``) mark each
public call (``portbench.call``), each batched evaluation
(``portbench.eval``) and the program's functions that a configuration names
under ``trace_ranges``. A device operation belongs to a range when the host
call that launched it (the CUDA runtime event of the same correlation id)
lies inside the range on the host's clock.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
from pathlib import Path

CALL_RANGE = "portbench.call"
EVAL_RANGE = "portbench.eval"
DEVICE_CATEGORIES = {"kernel": "kernel", "gpu_memcpy": "memcpy", "gpu_memset": "memset"}


@dataclasses.dataclass(frozen=True)
class Span:
    name: str
    start: float  # microseconds
    end: float


@dataclasses.dataclass(frozen=True)
class DeviceOp:
    name: str
    kind: str  # "kernel", "memcpy" or "memset"
    start: float
    end: float
    launch: float | None  # host time of the launching runtime call


@dataclasses.dataclass
class Trace:
    device_ops: list[DeviceOp]
    ranges: list[Span]  # the benchmark's record_function ranges, host side
    host_ops: list[Span]  # ranges and PyTorch's CPU operators, host side

    @classmethod
    def from_chrome(cls, events: list[dict]) -> "Trace":
        launch_at: dict = {}
        for e in events:
            if e.get("ph") == "X" and e.get("cat", "").lower() in ("cuda_runtime", "cuda_driver"):
                corr = e.get("args", {}).get("correlation")
                if corr is not None:
                    launch_at[corr] = float(e["ts"])
        ops, ranges, host = [], [], []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            cat = e.get("cat", "").lower()
            start = float(e["ts"])
            end = start + float(e["dur"])
            if cat in DEVICE_CATEGORIES:
                corr = e.get("args", {}).get("correlation")
                ops.append(DeviceOp(e["name"], DEVICE_CATEGORIES[cat], start, end, launch_at.get(corr)))
            elif cat == "user_annotation":
                ranges.append(Span(e["name"], start, end))
                host.append(Span(e["name"], start, end))
            elif cat == "cpu_op":
                host.append(Span(e["name"], start, end))
        ops.sort(key=lambda o: o.start)
        return cls(ops, ranges, host)

    @classmethod
    def from_profiler(cls, prof, path: Path) -> "Trace":
        path.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(path))
        with open(path) as f:
            data = json.load(f)
        return cls.from_chrome(data["traceEvents"] if isinstance(data, dict) else data)

    # -- the stretch: the public calls' own time ---------------------------------

    def calls(self) -> list[tuple[float, float]]:
        """The public calls' spans, in order (they do not overlap)."""
        return sorted((r.start, r.end) for r in self.ranges if r.name == CALL_RANGE)

    def stretch_us(self) -> float:
        """The profiled stretch's length: the sum of the calls' spans; the
        harness's own steps between calls are not in it."""
        return sum(b - a for a, b in self.calls())

    def ops_in_stretch(self) -> list[DeviceOp]:
        calls = self.calls()
        if not calls:
            return []
        starts = [a for a, _ in calls]

        def inside(o):
            i = bisect.bisect_right(starts, o.end) - 1
            return i >= 0 and o.start < calls[i][1]

        return [o for o in self.device_ops if inside(o)]

    def busy_intervals(self) -> list[tuple[float, float]]:
        """The union of the device operations' intervals, clipped to the calls."""
        calls = self.calls()
        merged: list[list[float]] = []
        for o in self.ops_in_stretch():
            for a, b in calls:
                a, b = max(o.start, a), min(o.end, b)
                if a >= b:
                    continue
                if merged and a <= merged[-1][1]:
                    merged[-1][1] = max(merged[-1][1], b)
                else:
                    merged.append([a, b])
        return [(a, b) for a, b in merged]

    def ops_under(self, range_name: str) -> list[DeviceOp]:
        """Device operations launched inside a range of this name."""
        union: list[list[float]] = []  # ranges of one name may nest: their union
        for a, b in sorted((r.start, r.end) for r in self.ranges if r.name == range_name):
            if union and a <= union[-1][1]:
                union[-1][1] = max(union[-1][1], b)
            else:
                union.append([a, b])
        starts = [a for a, _ in union]
        out = []
        for o in self.ops_in_stretch():
            if o.launch is None:
                continue
            i = bisect.bisect_right(starts, o.launch) - 1
            if i >= 0 and o.launch <= union[i][1]:
                out.append(o)
        return out

    # -- the breakdown ----------------------------------------------------------

    def top_ops(self, n: int = 10) -> list[list]:
        """The ``n`` device operations (by name) that took the most seconds."""
        total: dict[str, float] = {}
        for o in self.ops_in_stretch():
            total[o.name] = total.get(o.name, 0.0) + (o.end - o.start) * 1e-6
        return [[k[:160], v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list[list]:
        """The ``n`` longest stretches inside the calls with nothing on the
        device, each named by the innermost host range or operator running
        at its midpoint."""
        busy = self.busy_intervals()
        gaps = []
        for start, end in self.calls():
            at = start
            for a, b in busy:
                if b <= start or a >= end:
                    continue
                if a > at:
                    gaps.append((at, a))
                at = max(at, b)
            if end > at:
                gaps.append((at, end))
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:n]
        out = []
        for a, b in gaps:
            mid = (a + b) / 2
            holding = [h for h in self.host_ops if h.start <= mid <= h.end]
            name = min(holding, key=lambda h: h.end - h.start).name if holding else "host"
            out.append([name[:160], (b - a) * 1e-6])
        return out

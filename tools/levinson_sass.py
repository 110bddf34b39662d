"""Count the SASS instructions of the Levinson warp kernels' step loops (A5 and the A14 variants) at SDR's order.

Usage, from the repository root, on a machine with the CUDA toolkit:

    python3 tools/levinson_sass.py [--order N]

Builds the package's kernel library (``ops/cuda_lib.py``, as the metrics
do) and disassembles it with ``cuobjdump -sass``. For each Levinson kernel
at order N (default 512: P = N / 32 registers a lane) it finds the loops
(a branch back to a lower address closes one) and prints one JSON line:
the kernel, its instruction count, and per loop, in address order, its
body's length in instructions and its counts of float32 adds and
multiplies, shuffles, shared-memory loads, selects, the reciprocal's
approximation (``MUFU.RCP``) and register moves. A5's and "dotreduce"'s loops are the phases
(the last one at all P registers), "double"'s the phases of its rounds of
two steps, the "flat" kernels' one loop of U steps. With a kernel's device
time (``tools/time_levinson_stoi.py``) the step loop's length gives the
cycles the warp spends per instruction. Needs nvcc and cuobjdump, not a
card.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from fast_speech_enhancement_metrics_tpu_torch.ops import cuda_lib  # noqa: E402

KERNELS = {
    "vpu": "levinson_warp_kernelILi{P}EE",
    "flat": "levinson_flat_warp_kernelILi{P}ELi1EE",
    "flat_u4": "levinson_flat_warp_kernelILi{P}ELi4EE",
    "flat_u8": "levinson_flat_warp_kernelILi{P}ELi8EE",
    "dotreduce": "levinson_dotreduce_warp_kernelILi{P}EE",
    "double": "levinson_double_warp_kernelILi{P}EE",
}
CLASSES = {
    "fadd": ("FADD",), "fmul": ("FMUL",), "shfl": ("SHFL",), "lds": ("LDS",), "sel": ("SEL", "FSEL"),
    "mufu_rcp": ("MUFU.RCP",), "mov": ("MOV",),
}
LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?);")


def functions(sass: str) -> dict[str, list[tuple[int, str]]]:
    """Mangled name -> [(address, instruction)] of every function."""
    out = {}
    for chunk in sass.split("Function : ")[1:]:
        name, body = chunk.split("\n", 1)
        out[name.strip()] = [(int(a, 16), ins.strip()) for a, ins in LINE.findall(body)]
    return out


def loops(code: list[tuple[int, str]]) -> list[list[str]]:
    """The bodies of the loops: each backward branch closes the
    instructions from its target up to itself."""
    index = {addr: i for i, (addr, _) in enumerate(code)}
    bodies = []
    for i, (addr, ins) in enumerate(code):
        m = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", ins)
        if m and int(m.group(1), 16) < addr and int(m.group(1), 16) in index:
            bodies.append([c for _, c in code[index[int(m.group(1), 16)]:i + 1]])
    return bodies


def classes(body: list[str]) -> dict[str, int]:
    ops = [re.sub(r"^@!?U?P\w+\s+", "", ins).split()[0] for ins in body]
    return {k: sum(any(op == p or op.startswith(p + ".") for p in pre) for op in ops) for k, pre in CLASSES.items()}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--order", type=int, default=512)
    args = ap.parse_args()
    p = args.order // 32
    so = cuda_lib.build()
    cuobjdump = shutil.which("cuobjdump") or str(Path(cuda_lib._nvcc()).with_name("cuobjdump"))
    funcs = functions(subprocess.run([cuobjdump, "-sass", str(so)], capture_output=True, text=True,
                                     check=True).stdout)
    for variant, pattern in KERNELS.items():
        key = pattern.format(P=p)
        names = [n for n in funcs if key in n]
        if len(names) != 1:
            raise SystemExit(f"levinson_sass: {len(names)} functions match {key}")
        code = funcs[names[0]]
        print(json.dumps({"variant": variant, "order": args.order, "function": names[0],
                          "instructions": len(code),
                          "loops": [{"length": len(b), **classes(b)} for b in loops(code)]}), flush=True)


if __name__ == "__main__":
    main()

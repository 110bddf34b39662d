"""Batched Levinson-Durbin Toeplitz solve: CUDA kernels A5 and A14 and their plain versions.

Counterpart of the JAX package's ``ops/levinson_pallas.py``
(``levinson_solve_fused``) and its variants, one recursion with its
reductions reassociated: ``"vpu"`` (A5), and the A14 variants ``"flat"``,
``"flat_u4"``, ``"flat_u8"``, ``"dotreduce"`` and ``"double"``. The CUDA
kernels (``csrc/levinson.cu``) run the whole n - 1 step recursion in one
launch with every carry in registers; the r0[0] normalization (with its
zero guard) happens inside the kernel. Each runs one warp per row, lane l
holding coefficients l, l + 32, ..., and each computes a torch dataflow
bit for bit (``_warp_twin``): A5 and "dotreduce"
``_levinson_warp_order_reference``, the three "flat" kernels its
``phased=False`` order, "double" ``_levinson_double_warp_reference``.
Each variant counts its launches under its own name (``KERNELS``).

Plain versions: ``ops/toeplitz.py::levinson_solve`` for ``"vpu"``,
``"flat*"`` and ``"dotreduce"`` (the same recursion as tensor ops; those
variants differ only in how the reductions are summed), and
``_levinson_double_plain`` for ``"double"``, whose two-step update is
another function of the same state.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from fast_speech_enhancement_metrics_tpu_torch.ops import cuda_lib
from fast_speech_enhancement_metrics_tpu_torch.ops.toeplitz import levinson_solve

KERNEL = "levinson_solve"  # A5
#: the JAX package's variant names, in the order of the C entry point's ids
VARIANTS = ("vpu", "dotreduce", "flat", "flat_u4", "flat_u8", "double")
#: launch counter of each variant: A5 ("vpu") and the A14 kernels
KERNELS = {v: KERNEL if v == "vpu" else f"levinson_{v}" for v in VARIANTS}


def _guard(d: torch.Tensor) -> torch.Tensor:
    return torch.where(d.abs() < 1e-30, torch.full_like(d, 1e-30), d)


def _lane_tree(a: torch.Tensor) -> torch.Tensor:
    """(..., m) -> (..., 1): A5's halving tree, a[i] + a[i + m // 2], an odd
    m's last element carried up a level."""
    while a.shape[-1] > 1:
        m = a.shape[-1]
        h = m // 2
        a = torch.cat([a[..., :h] + a[..., h:2 * h], a[..., 2 * h:]], dim=-1)
    return a


def _warp_dot(a: torch.Tensor, c: torch.Tensor, active: int) -> torch.Tensor:
    """<a, c> over (B, n) in A5's order: element 32 i + l lies in register
    i of lane l; each lane sums its first ``active`` registers' products
    with ``_lane_tree`` (the later ones hold zeros), then the xor butterfly
    adds lane l + o to lane l for o = 16, 8, 4, 2, 1 (float addition
    commutes, so every lane holds these bits)."""
    lanes = (a * c).reshape(a.shape[0], -1, 32)[:, :active].transpose(1, 2)
    lanes = _lane_tree(lanes)[..., 0]
    for o in (16, 8, 4, 2, 1):
        lanes = lanes[:, :o] + lanes[:, o:2 * o]
    return lanes


def _levinson_warp_order_reference(r0: torch.Tensor, b: torch.Tensor, phased: bool = True) -> torch.Tensor:
    """A5's kernel (``csrc/levinson.cu``, ``levinson_warp_kernel``) in torch
    float32, for the tests: the recursion of ``toeplitz.levinson_solve``
    with each product and sum rounded where the kernel rounds it (no fused
    multiply-adds), the reciprocal of the guarded denominator multiplied in,
    and both dot products in ``_warp_dot``'s order: <r1, v> over the
    k // 32 + 1 registers that hold elements 0 .. k before step k, <r1, y>
    over the (k + 1) // 32 + 1 that the step writes. It is also the
    "dotreduce" kernel's order: its split butterfly adds the same pairs.
    ``phased=False``: the "flat" kernels' order, both sums over all n // 32
    registers at every step. r0, b: (B, n), n a multiple of 32."""
    batch, n = r0.shape
    assert n % 32 == 0
    r_first = r0[:, :1]
    safe0 = torch.where(r_first.abs() < 1e-30, torch.ones_like(r_first), r_first)
    r1 = F.pad(r0[:, 1:] / safe0, (0, 1))
    bn = b / safe0
    u = F.pad(torch.ones_like(r_first), (0, n - 1))
    x = F.pad(bn[:, :1], (0, n - 1))
    v, y = u, x

    def shift(a):
        return F.pad(a, (1, 0))[:, :-1]

    for k in range(n - 1):
        if phased:
            ef, ry = _warp_dot(r1, v, k // 32 + 1), _warp_dot(r1, y, (k + 1) // 32 + 1)
        else:
            ef, ry = _warp_dot(r1, v, n // 32), _warp_dot(r1, y, n // 32)
        g, gy = shift(v), shift(y)
        mu = bn[:, k + 1:k + 2] - ry
        recip = 1.0 / _guard(1.0 - ef * ef)
        u_new = (u - ef * g) * recip
        v_new = (g - ef * u) * recip
        x = x + mu * v_new
        y = gy + mu * u_new
        u, v = u_new, v_new
    return x


def _levinson_double_warp_reference(r0: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The "double" kernel (``levinson_double_warp_kernel``) in torch
    float32, bit for bit: ``_levinson_double_plain``'s two-step rounds with
    each product and sum rounded where the kernel rounds it, the five sums
    of a round in ``_warp_dot``'s order over the A = (k + 2) // 32 + 1
    registers that the round at k writes, and an odd last step as A5's
    single step over all registers. Takes any n >= 2 (an order that is not
    a multiple of 32 runs on registers padded with zeros, and an even step
    count ends on a round), so that both endings can be held on the CPU;
    the kernel takes n = 32 P, an odd step count."""
    batch, n = r0.shape
    width = -(-n // 32)
    pad = 32 * width - n
    r_first = r0[:, :1]
    safe0 = torch.where(r_first.abs() < 1e-30, torch.ones_like(r_first), r_first)
    r1 = F.pad(r0[:, 1:] / safe0, (0, 1 + pad))
    r2 = F.pad(r1[:, 1:], (0, 1))  # r1 shifted left: the kernel's r0[j + 2] / r0[0]
    bn = F.pad(b / safe0, (0, pad))
    u = F.pad(torch.ones_like(r_first), (0, n + pad - 1))
    x = F.pad(bn[:, :1], (0, n + pad - 1))
    v, y = u, x

    def shift(a, by=1):
        return F.pad(a, (by, 0))[:, :-by]

    steps = n - 1
    for i in range(steps // 2):
        k = 2 * i
        active = min((k + 2) // 32 + 1, width)
        ef1, p, uu = _warp_dot(r1, v, active), _warp_dot(r2, v, active), _warp_dot(r1, u, active)
        mu1 = bn[:, k + 1:k + 2] - _warp_dot(r1, y, active)
        q2 = bn[:, k + 2:k + 3] - _warp_dot(r2, y, active)
        rho1 = 1.0 / _guard(1.0 - ef1 * ef1)
        ef2 = rho1 * (p - ef1 * uu)
        rho2 = 1.0 / _guard(1.0 - ef2 * ef2)
        mu2 = q2 - (mu1 * rho1) * (uu - ef1 * p)
        sv, ssv, su, ssy = shift(v), shift(v, 2), shift(u), shift(y, 2)
        u1 = (u - ef1 * sv) * rho1
        v1 = (sv - ef1 * u) * rho1
        g2 = rho1 * (ssv - ef1 * su)
        su1 = rho1 * (su - ef1 * ssv)
        u2 = (u1 - ef2 * g2) * rho2
        v2 = (g2 - ef2 * u1) * rho2
        x = (x + mu1 * v1) + mu2 * v2
        y = (ssy + mu1 * su1) + mu2 * u2
        u, v = u2, v2
    if steps % 2:
        k = steps - 1
        ef, ry = _warp_dot(r1, v, width), _warp_dot(r1, y, width)
        recip = 1.0 / _guard(1.0 - ef * ef)
        x = x + (bn[:, k + 1:k + 2] - ry) * ((shift(v) - ef * u) * recip)
    return x[:, :n]


def _warp_twin(variant: str):
    """The torch dataflow that ``variant``'s kernel computes bit for bit."""
    if variant == "double":
        return _levinson_double_warp_reference
    if variant.startswith("flat"):
        return functools.partial(_levinson_warp_order_reference, phased=False)
    return _levinson_warp_order_reference


def _levinson_double_plain(r0: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of the ``"double"`` variant: two recursion steps per
    round from five reductions of the current state (JAX
    ``_levinson_kernel_double``), with r2 the left-shifted r1:

        ef1 = <r1,v>   p = <r2,v>   uu = <r1,u>
        mu1 = bn[k+1] - <r1,y>      q2 = bn[k+2] - <r2,y>
        rho1 = 1 / (1 - ef1^2)      ef2 = rho1 (p - ef1 uu)
        rho2 = 1 / (1 - ef2^2)      mu2 = q2 - mu1 rho1 (uu - ef1 p)

    then the composed update on S(v), S^2(v), S(u), S^2(y) (S the right
    shift); an odd last step is the single step."""
    n = r0.shape[-1]
    r_first = r0[..., :1]
    safe0 = torch.where(r_first.abs() < 1e-30, torch.ones_like(r_first), r_first)
    r1 = F.pad(r0[..., 1:] / safe0, (0, 1))  # (..., n), last lane 0
    r2 = F.pad(r1[..., 1:], (0, 1))
    bn = b / safe0

    def dot(a, c):
        return torch.sum(a * c, dim=-1, keepdim=True)

    def shift(a):
        return F.pad(a, (1, 0))[..., :-1]

    u = F.pad(torch.ones_like(r_first), (0, n - 1))
    x = F.pad(bn[..., :1], (0, n - 1))
    v, y = u, x
    steps = n - 1
    for i in range(steps // 2):
        k = 2 * i
        ef1, p, uu = dot(r1, v), dot(r2, v), dot(r1, u)
        mu1 = bn[..., k + 1:k + 2] - dot(r1, y)
        q2 = bn[..., k + 2:k + 3] - dot(r2, y)
        rho1 = 1.0 / _guard(1.0 - ef1 * ef1)
        ef2 = rho1 * (p - ef1 * uu)
        rho2 = 1.0 / _guard(1.0 - ef2 * ef2)
        mu2 = q2 - mu1 * rho1 * (uu - ef1 * p)
        sv, su, ssy = shift(v), shift(u), shift(shift(y))
        ssv = shift(sv)
        u1 = (u - ef1 * sv) * rho1
        v1 = (sv - ef1 * u) * rho1
        g2 = rho1 * (ssv - ef1 * su)
        u2 = (u1 - ef2 * g2) * rho2
        v2 = (g2 - ef2 * u1) * rho2
        x = x + mu1 * v1 + mu2 * v2
        su1 = rho1 * (su - ef1 * ssv)
        y = ssy + mu1 * su1 + mu2 * u2
        u, v = u2, v2
    if steps % 2:
        k = steps - 1
        ef = dot(r1, v)
        mu = bn[..., k + 1:k + 2] - dot(r1, y)
        recip = 1.0 / _guard(1.0 - ef * ef)
        g = shift(v)
        x = x + mu * ((g - ef * u) * recip)
    return x


def _plain(variant: str):
    return _levinson_double_plain if variant == "double" else levinson_solve


def _levinson_solve_cuda(r0: torch.Tensor, b: torch.Tensor, variant: str) -> torch.Tensor:
    dev = r0.device
    cuda_lib.check_operand(r0, "r0", dev, torch.float32, 2)
    cuda_lib.check_operand(b, "b", dev, torch.float32, 2)
    batch, n = r0.shape
    if n % 32 or not 32 <= n <= 1024:
        raise NotImplementedError(f"the Levinson kernel takes orders 32..1024 in steps of 32, got {n}")
    if batch == 0:
        raise ValueError("need at least one row")
    x = torch.empty_like(r0)
    cuda_lib.launch(KERNEL, dev, r0, b, x, batch, n, VARIANTS.index(variant), count=KERNELS[variant])
    return x


def levinson_solve_fused(r0: torch.Tensor, b: torch.Tensor, variant: str = "vpu") -> torch.Tensor:
    """Kernel A5 / A14 wrapper: solve T(r0) x = b, r0, b (B, n) float32 -> x (B, n).

    ``variant`` is one of ``VARIANTS``. CPU tensors take the variant's plain
    version; CUDA tensors launch its kernel (or raise); any other device
    raises.
    """
    assert r0.ndim == 2 and b.shape == r0.shape
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    return cuda_lib.dispatch("Levinson kernel", r0.device, lambda: _plain(variant)(r0, b),
                             lambda: _levinson_solve_cuda(r0, b, variant))

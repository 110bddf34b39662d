"""Symmetric Toeplitz solves: Levinson-Durbin recursion and Cholesky.

Counterpart of the JAX package's ``ops/toeplitz.py``. ``levinson_solve`` is
the plain version of the Levinson kernel (``ops/levinson_pallas.py``): the
same recursion, one Python loop step per order. ``symmetric_toeplitz_solve``
builds the full matrix and solves by Cholesky, recomputing any row whose
Cholesky fails with a general LU solve.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def levinson_solve(r0: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve T(r0) x = b by batched Levinson-Durbin, r0, b: (..., n).

    Alongside the forward vector ``u`` the recursion carries its reversal
    ``v`` and the reversal ``y`` of the running solution ``x``, so every
    step is a fixed-width update:

        ef    = <r[1:], v>          ex  = <r[1:], y>
        g     = shift_right(v)
        u'    = (u - ef*g) / (1 - ef^2)
        v'    = (g - ef*u) / (1 - ef^2)
        x'    = x + (b[n] - ex) * v'
        y'    = shift_right(y) + (b[n] - ex) * u'
    """
    n = r0.shape[-1]
    r_first = r0[..., :1]
    # guard zero leading autocorrelation (all-zero signal): identity system
    safe0 = torch.where(r_first.abs() < 1e-30, torch.ones_like(r_first), r_first)
    r1 = r0[..., 1:] / safe0  # normalized tail, (..., n-1)
    bn = b / safe0

    u = F.pad(torch.ones_like(r_first), (0, n - 1))
    x = F.pad(bn[..., :1], (0, n - 1))
    v, y = u, x

    def shift_right(a):
        return F.pad(a, (1, 0))[..., :-1]

    for k in range(1, n):
        ef = torch.sum(r1 * v[..., : n - 1], dim=-1, keepdim=True)
        ex = torch.sum(r1 * y[..., : n - 1], dim=-1, keepdim=True)
        denom = 1.0 - ef * ef
        denom = torch.where(denom.abs() < 1e-30, torch.full_like(denom, 1e-30), denom)
        g = shift_right(v)
        u_new = (u - ef * g) / denom
        v_new = (g - ef * u) / denom
        mu = bn[..., k : k + 1] - ex
        x = x + mu * v_new
        y = shift_right(y) + mu * u_new
        u, v = u_new, v_new
    return x


def symmetric_toeplitz_solve(r0: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve T(r0) x = b for batched first rows r0: (..., n), b: (..., n)."""
    n = r0.shape[-1]
    idx = torch.as_tensor(
        np.abs(np.arange(n)[None, :] - np.arange(n)[:, None]), device=r0.device
    )
    r_matrix = r0[..., idx]  # (..., n, n)

    chol, info = torch.linalg.cholesky_ex(r_matrix)
    y = torch.linalg.solve_triangular(chol, b[..., None], upper=False)
    sol = torch.linalg.solve_triangular(chol.mT, y, upper=True)[..., 0]

    bad = torch.isnan(sol).any(dim=-1, keepdim=True) | (info != 0)[..., None]
    if bool(bad.any()):
        general = torch.linalg.solve(r_matrix, b[..., None])[..., 0]
        sol = torch.where(bad, general, sol)
    return sol

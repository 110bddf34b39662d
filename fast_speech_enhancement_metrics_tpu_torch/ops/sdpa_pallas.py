"""Long-audio attention: CUDA kernels A9 (``sdpa``) and A15 (``flash_sdpa``) and their plain versions.

Counterparts of the JAX package's ``ops/sdpa_pallas.py::sdpa`` (A9,
``_sdpa_kernel``) and of ``models/hubert.py::_flash_sdpa`` (A15, the
upstream ``jax.experimental.pallas.ops.tpu.flash_attention`` kernel), over
(B, H, T, D) inputs, non-causal, the output in q's dtype.

A9 (``sdpa``), seam by seam as in JAX: q is scaled in q's dtype before the
kernel (``q * scaling`` with the scale rounded to q's dtype, times log2 e
for the exp2 modes), the logits are fp32, keys past T are masked, the
softmax is ``"exact"`` (exp(s - rowmax)), ``"exp2"`` (2^clamp(s, -100, 60))
or ``"exp2_bf16"`` (``jnp.exp2`` of the clamped logit in bf16, i.e.
bf16(exp(bf16(bf16(s) * bf16(ln 2))))); l sums p in fp32, p is cast to v's
dtype for the P V product, and the output is (o / l) in q's dtype. The JAX
kernel pads the keys to a multiple of 128 and masks them to -inf before the
clamp, so in the exp2 modes each padded key adds p(-100) to l: both
versions add that as ``l_pad``.

A15 (``flash_sdpa``) follows the upstream kernel: T padded to a multiple of
512 with the padded keys masked out of every real query; ``scaling``
multiplies the fp32 logits (not q); per key block of 128 the running max
m, p = exp(s - m_next), l_next = sum(p) + exp(m_prev - m_next) l_prev, and
the accumulator stays normalised: acc = acc * (l_corr / l_next) + (bf16(p)
V) / l_next; the output is acc in q's dtype.

The CUDA kernels are ``csrc/sdpa.cu`` (bf16, on ``csrc/flash_sm90.cuh``:
TMA, wgmma, the softmax in registers, 128 queries a block) and
``csrc/sdpa_f32.cu`` (float32, the ``precision="highest"`` arm, on
``csrc/flash_f32_sm90.cuh``: the same block shape on bf16x6 products, the
TPU's arithmetic at "highest"). The bf16 kernel reads rows of 16-byte
multiples: a head width that is not a multiple of 8 is zero-padded to one
first (the zero columns add nothing to q k^T, and give output columns that
are cut off). The float32 arm runs a split pass first (``split_pieces``):
q (scaled), k and v as three bf16 pieces each, x = x0 + x1 + x2, the head
zero-padded to 64 or 128 columns; the kernel forms each product as the six
piece products of order <= 2, small terms first
(``_sdpa_f32_pieces_reference`` is that dataflow in torch). CPU tensors
take the plain versions; CUDA tensors launch the kernels or raise.
"""

from __future__ import annotations

import functools

import torch

from fast_speech_enhancement_metrics_tpu_torch.ops import cuda_lib
from fast_speech_enhancement_metrics_tpu_torch.ops.attention_core import (
    LOG2E,
    MAX_HEAD_DIM,
    SOFTMAX_MODES,
    softmax_p,
)

KERNEL_A9 = "sdpa"
KERNEL_A15 = "flash_sdpa"
#: the float32 arm's split pass (``split_pieces``)
KERNEL_SPLIT = "sdpa_f32_split"
#: key padding quanta: A9's lane tile, the flash kernel's sequence block
SDPA_KEY_QUANTUM, FLASH_KEY_QUANTUM = 128, 512
#: the flash kernel's key block (BlockSizes.get_default's block_k)
FLASH_BLOCK_K = 128
#: A9's query block in the CUDA kernels, both arms (the JAX signature's ``block_q``)
KERNEL_BLOCK_Q = 128
#: the float32 arm's key tile (its online softmax rescales once a tile)
F32_BLOCK_K = 64
#: the bf16 kernel's head widths are multiples of this (16-byte TMA rows)
_BF16_HEAD_QUANTUM = 8
#: the float32 arm's pieces per operand and its six products of order <= 2,
#: (piece of q or p, piece of k or v), small terms first
_PIECES = 3
_PRODUCTS = ((1, 1), (0, 2), (2, 0), (0, 1), (1, 0), (0, 0))
_ONLINE = 3
_IO_DTYPES = (torch.float32, torch.bfloat16)


def _pad_keys_l(t: int, softmax: str) -> float:
    """What the JAX kernel's padded keys (T up to a multiple of 128, masked to
    -inf, clamped to -100) add to each row sum."""
    n_pad = -(-t // SDPA_KEY_QUANTUM) * SDPA_KEY_QUANTUM - t
    if softmax == "exact" or n_pad == 0:
        return 0.0
    p_pad = softmax_p(torch.tensor([-100.0]), softmax).item()
    return n_pad * p_pad


@functools.lru_cache(maxsize=None)
def _scale_tensor(scaling: float, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The 0-d scale in ``dtype`` on ``device``, made once: a copy from the
    host inside a call would sync it."""
    return torch.tensor(scaling, dtype=dtype, device=device)


def _scaled_q(q: torch.Tensor, scaling: float, softmax: str) -> torch.Tensor:
    """q * scaling in q's dtype (the scale rounded to it), as the JAX wrapper does."""
    if softmax != "exact":
        scaling = scaling * LOG2E
    return q * _scale_tensor(scaling, q.dtype, q.device)


def _check_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v: need equal (B, H, T, D) shapes, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in _IO_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v: need one dtype of {_IO_DTYPES}, got {q.dtype}, {k.dtype}, {v.dtype}")


def _sdpa_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scaling: float,
                softmax: str = "exact") -> torch.Tensor:
    """Plain PyTorch version of kernel A9. Runs (B H) slices in chunks of
    about 2 GB of fp32 logits."""
    b, h, t, d = q.shape
    qs = _scaled_q(q, scaling, softmax).reshape(b * h, t, d).float()
    kf, vf = k.reshape(b * h, t, d).float(), v.reshape(b * h, t, d).float()
    l_pad = _pad_keys_l(t, softmax)
    out = torch.empty(b * h, t, d, dtype=q.dtype, device=q.device)
    step = max(1, (2 << 30) // (4 * t * t))
    for i in range(0, b * h, step):
        s = torch.matmul(qs[i:i + step], kf[i:i + step].transpose(-1, -2))  # fp32 logits
        p = softmax_p(s, softmax)
        l = torch.sum(p, dim=-1, keepdim=True) + l_pad
        o = torch.matmul(p.to(v.dtype).float(), vf[i:i + step])
        out[i:i + step] = (o / l).to(q.dtype)
    return out.reshape(b, h, t, d)


def _flash_sdpa_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scaling: float) -> torch.Tensor:
    """Plain PyTorch version of kernel A15: the upstream flash kernel's
    online softmax over key blocks of 128 of the keys padded to 512. q may
    hold fewer queries than k and v have keys (a slice of the queries)."""
    tk = k.shape[2]
    n_keys = -(-tk // FLASH_KEY_QUANTUM) * FLASH_KEY_QUANTUM
    qf, kf, vf = q.float(), k.float(), v.float()
    shape = q.shape[:3] + (1,)
    m = torch.full(shape, float("-inf"), device=q.device)
    l = torch.zeros(shape, device=q.device)
    acc = torch.zeros(q.shape, device=q.device)
    for k0 in range(0, n_keys, FLASH_BLOCK_K):
        if k0 >= tk:  # an all-padded block: p = 0, every row keeps m and l
            p = torch.zeros(shape[:3] + (FLASH_BLOCK_K,), device=q.device)
            vb = torch.zeros(q.shape[:2] + (FLASH_BLOCK_K, q.shape[3]), device=q.device)
            m_next = m
        else:
            s = torch.matmul(qf, kf[:, :, k0:k0 + FLASH_BLOCK_K].transpose(-1, -2)) * scaling
            vb = vf[:, :, k0:k0 + FLASH_BLOCK_K]
            m_next = torch.maximum(m, torch.amax(s, dim=-1, keepdim=True))
            p = torch.exp(s - m_next)
        l_corr = torch.exp(m - m_next) * l
        l_next = torch.sum(p, dim=-1, keepdim=True) + l_corr
        inv = torch.where(l_next == 0.0, torch.ones_like(l_next), 1.0 / l_next)
        acc = acc * (l_corr * inv) + torch.matmul(p.to(v.dtype).float(), vb) * inv
        m, l = m_next, l_next
    return acc.to(q.dtype)


def _split3(x: torch.Tensor) -> list[torch.Tensor]:
    """The three bf16 pieces of a float32 tensor, as float32: x0 = bf16(x),
    x1 = bf16(x - x0), x2 = bf16(x - x0 - x1) (each difference exact)."""
    pieces = []
    for _ in range(_PIECES):
        piece = x.to(torch.bfloat16).float()
        pieces.append(piece)
        x = x - piece
    return pieces


def _head_box(d: int) -> int:
    """The float32 arm's padded head width: one or two 64-column TMA boxes."""
    return 64 if d <= 64 else 128


def _split_pieces_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain version of the split pass: (B, H, T, D) float32 q, k, v -> (3
    tensors, 3 pieces, B H T, D_p) bf16, D_p = ``_head_box(D)``, the padded
    columns zeros."""
    d = q.shape[-1]
    return torch.stack([torch.stack(_split3(torch.nn.functional.pad(x.reshape(-1, d).float(),
                                                                    (0, _head_box(d) - d))))
                        for x in (q, k, v)]).to(torch.bfloat16)


def split_pieces(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The float32 arm's split pass: (B, H, T, D) float32 q, k, v (q already
    scaled) -> their bf16 pieces, as ``_split_pieces_plain``. CPU tensors
    take the plain version; on a CUDA tensor the kernel
    (``csrc/sdr_halves.cuh``, ``halves::split_rows<3>``)."""
    if q.device.type == "cpu":
        return _split_pieces_plain(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"no split kernel for device {q.device}")
    for name, a in (("q", q), ("k", k), ("v", v)):
        cuda_lib.check_operand(a, name, q.device, torch.float32, 4)
        if a.shape != q.shape or a.data_ptr() % 16:
            raise ValueError(f"{name}: need the shape {tuple(q.shape)}, 16-byte aligned")
    d = q.shape[-1]
    rows = q.numel() // d
    out = torch.empty(3, _PIECES, rows, _head_box(d), dtype=torch.bfloat16, device=q.device)
    cuda_lib.launch("sdpa_f32_split", q.device, q, k, v, out, rows, d, _head_box(d))
    cuda_lib.launch_counts[KERNEL_SPLIT] += 1
    return out


def _six_products(a: list[torch.Tensor], b: list[torch.Tensor]) -> torch.Tensor:
    """sum a_i b_j over ``_PRODUCTS``, in float32, small terms first."""
    acc = torch.matmul(a[_PRODUCTS[0][0]], b[_PRODUCTS[0][1]])
    for i, j in _PRODUCTS[1:]:
        acc = acc + torch.matmul(a[i], b[j])
    return acc


def _sdpa_f32_pieces_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scaling: float,
                               mode: str) -> torch.Tensor:
    """The float32 arm's dataflow in torch, for the tests (never on the main
    path): q (scaled as ``_scaled_q`` in A9's modes), k and v split in three
    bf16 pieces; S the six piece products; per key tile of ``F32_BLOCK_K``
    p as the kernel forms it (mode "online": s *= scaling, the running max,
    l and O rescaled by exp(m - m_next)), p split in three pieces and P V
    the six piece products into a tile partial added to O; out O / (l +
    l_pad) (online: O / l). ``mode``: one of ``SOFTMAX_MODES`` or "online"."""
    t = q.shape[2]
    online = mode == "online"
    qs = q.float() if online else _scaled_q(q.float(), scaling, mode)
    qp, kp, vp = _split3(qs), _split3(k.float()), _split3(v.float())
    s = _six_products(qp, [x.transpose(-1, -2) for x in kp])
    if online:
        s = s * scaling
    else:
        p_all = softmax_p(s, mode)
    shape = q.shape[:3] + (1,)
    m = torch.full(shape, float("-inf"), device=q.device)
    l = torch.zeros(shape, device=q.device)
    o = torch.zeros(q.shape, device=q.device)
    for k0 in range(0, t, F32_BLOCK_K):
        corr = 1.0
        if online:
            st = s[..., k0:k0 + F32_BLOCK_K]
            m_next = torch.maximum(m, torch.amax(st, dim=-1, keepdim=True))
            corr = torch.exp(m - m_next)
            p = torch.exp(st - m_next)
            m = m_next
        else:
            p = p_all[..., k0:k0 + F32_BLOCK_K]
        l = l * corr + torch.sum(p, dim=-1, keepdim=True)
        o = o * corr + _six_products(_split3(p), [x[:, :, k0:k0 + F32_BLOCK_K] for x in vp])
    return o / (l if online else l + _pad_keys_l(t, mode))


def _exp2_bf16_tie_allowance(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scaling: float,
                             want: torch.Tensor) -> torch.Tensor:
    """For the tests: how far two float32 evaluations of A9's ``exp2_bf16``
    mode may lie apart beyond round-off. The mode rounds each logit to bf16,
    a step function, so two float32 sums of one logit (the plain version's
    and the float32 arm's bf16x6) that straddle a step give p one bf16 step
    apart. Per output element: sum over the keys whose logit lies within
    2^-20 sum_i |q_i k_i| of a step (16 float32 ulps of that sum's scale) of
    dp_k (|v_k| + |want|) / l, in float64, with dp_k p's jump across that
    interval; 0 in a row with no such key."""
    qs = _scaled_q(q.float(), scaling, "exp2_bf16").double()
    kt = k.double().transpose(-1, -2)
    s = torch.matmul(qs, kt)
    delta = 2.0**-20 * torch.matmul(qs.abs(), kt.abs())
    p_lo, p_mid, p_hi = (softmax_p(x.float(), "exp2_bf16").double() for x in (s - delta, s, s + delta))
    dp = p_hi - p_lo
    l = torch.sum(p_mid, dim=-1, keepdim=True) + _pad_keys_l(q.shape[2], "exp2_bf16")
    return (torch.matmul(dp, v.double().abs()) + torch.sum(dp, dim=-1, keepdim=True) * want.double().abs()) / l


def _aligned(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(kernel: str, q, k, v, mode: int, n_keys: int, scale: float, l_pad: float) -> torch.Tensor:
    b, h, t, d = q.shape
    if d > MAX_HEAD_DIM:
        raise ValueError(f"the attention kernels take heads of at most {MAX_HEAD_DIM}, got {d}")
    if b * h * t == 0 or d == 0:
        raise ValueError(f"need a non-empty (B, H, T, D) input, got {tuple(q.shape)}")
    if q.dtype == torch.float32:
        pieces = split_pieces(*(_aligned(a) for a in (q, k, v)))
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        cuda_lib.launch("sdpa_f32", q.device, pieces, out, b, h, t, n_keys, d, mode, scale, l_pad)
        cuda_lib.launch_counts[kernel] += 1
        return out
    pad = -d % _BF16_HEAD_QUANTUM
    q, k, v = (_aligned(torch.nn.functional.pad(a, (0, pad)) if pad else a) for a in (q, k, v))
    for name, a in (("k", k), ("v", v)):
        cuda_lib.check_operand(a, name, q.device, q.dtype, 4)
    out = torch.empty_like(q)
    cuda_lib.launch("sdpa", q.device, q, k, v, out, b, h, t, n_keys, d + pad, mode, scale, l_pad)
    cuda_lib.launch_counts[kernel] += 1
    return out[..., :d].contiguous() if pad else out


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scaling: float, block_q: int | None = None,
         softmax: str = "exact") -> torch.Tensor:
    """Kernel A9 wrapper: softmax((q * scaling) k^T) v over (B, H, T, D),
    bf16 or float32, in q's dtype. ``block_q`` is the JAX signature's query
    block; the CUDA kernels' is fixed (``KERNEL_BLOCK_Q``), and another
    value raises."""
    if block_q not in (None, KERNEL_BLOCK_Q):
        raise ValueError(f"the sdpa kernel's query block is {KERNEL_BLOCK_Q}, got block_q={block_q}")
    if softmax not in SOFTMAX_MODES:
        raise ValueError(f"softmax must be one of {SOFTMAX_MODES}, got {softmax!r}")
    _check_qkv(q, k, v)
    if q.device.type == "cpu":
        return _sdpa_plain(q, k, v, scaling, softmax)
    if q.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {q.device}")
    t = q.shape[2]
    return _launch(KERNEL_A9, _scaled_q(q, scaling, softmax), k, v, SOFTMAX_MODES.index(softmax), t, 1.0,
                   _pad_keys_l(t, softmax))


def flash_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scaling: float) -> torch.Tensor:
    """Kernel A15 wrapper: the flash kernel's exact online softmax over
    (B, H, T, D), bf16 or float32, in q's dtype."""
    _check_qkv(q, k, v)
    if q.device.type == "cpu":
        return _flash_sdpa_plain(q, k, v, scaling)
    if q.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {q.device}")
    t = q.shape[2]
    n_keys = -(-t // FLASH_KEY_QUANTUM) * FLASH_KEY_QUANTUM
    return _launch(KERNEL_A15, q, k, v, _ONLINE, n_keys, float(scaling), 0.0)

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
``csrc/attention_core.cuh``, 64 queries a block). The bf16 kernel reads
rows of 16-byte multiples: a head width that is not a multiple of 8 is
zero-padded to one first (the zero columns add nothing to q k^T, and give
output columns that are cut off). CPU tensors take the plain versions; CUDA
tensors launch the kernels or raise.
"""

from __future__ import annotations

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
#: key padding quanta: A9's lane tile, the flash kernel's sequence block
SDPA_KEY_QUANTUM, FLASH_KEY_QUANTUM = 128, 512
#: the flash kernel's key block (BlockSizes.get_default's block_k)
FLASH_BLOCK_K = 128
#: A9's query block in the CUDA kernels (the JAX signature's ``block_q``):
#: the float32 arm's, and the bf16 arm's
KERNEL_BLOCK_Q, KERNEL_BLOCK_Q_BF16 = 64, 128
#: the bf16 kernel's head widths are multiples of this (16-byte TMA rows)
_BF16_HEAD_QUANTUM = 8
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


def _scaled_q(q: torch.Tensor, scaling: float, softmax: str) -> torch.Tensor:
    """q * scaling in q's dtype (the scale rounded to it), as the JAX wrapper does."""
    if softmax != "exact":
        scaling = scaling * LOG2E
    return q * torch.tensor(scaling, dtype=q.dtype, device=q.device)


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


def _aligned(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(kernel: str, q, k, v, mode: int, n_keys: int, scale: float, l_pad: float) -> torch.Tensor:
    b, h, t, d = q.shape
    if d > MAX_HEAD_DIM:
        raise ValueError(f"the attention kernels take heads of at most {MAX_HEAD_DIM}, got {d}")
    if b * h * t == 0 or d == 0:
        raise ValueError(f"need a non-empty (B, H, T, D) input, got {tuple(q.shape)}")
    bf16 = q.dtype == torch.bfloat16
    pad = -d % _BF16_HEAD_QUANTUM if bf16 else 0
    q, k, v = (_aligned(torch.nn.functional.pad(a, (0, pad)) if pad else a) for a in (q, k, v))
    for name, a in (("k", k), ("v", v)):
        cuda_lib.check_operand(a, name, q.device, q.dtype, 4)
    out = torch.empty_like(q)
    cuda_lib.launch("sdpa" if bf16 else "sdpa_f32", q.device, q, k, v, out, b, h, t, n_keys, d + pad, mode, scale,
                    l_pad)
    cuda_lib.launch_counts[kernel] += 1
    return out[..., :d].contiguous() if pad else out


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scaling: float, block_q: int | None = None,
         softmax: str = "exact") -> torch.Tensor:
    """Kernel A9 wrapper: softmax((q * scaling) k^T) v over (B, H, T, D),
    bf16 or float32, in q's dtype. ``block_q`` is the JAX signature's query
    block; the CUDA kernel's is fixed (``KERNEL_BLOCK_Q_BF16`` for bf16,
    ``KERNEL_BLOCK_Q`` for float32), and another value raises."""
    kernel_block_q = KERNEL_BLOCK_Q_BF16 if q.dtype == torch.bfloat16 else KERNEL_BLOCK_Q
    if block_q not in (None, kernel_block_q):
        raise ValueError(f"the sdpa kernel's query block is {kernel_block_q}, got block_q={block_q}")
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

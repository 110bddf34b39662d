"""x + gelu(conv_g(bn(x)) + b) in float32: the HuBERT / WavLM positional conv stage on a CUDA kernel.

No Pallas kernel of the JAX package computes this: its
``hubert_hidden_state`` leaves the grouped conv to XLA, which the TPU runs
at "highest" as bf16x6 MXU passes. The port's kernel (``csrc/pos_conv.cu``)
is that class on the H100's bf16 tensor cores, with the stage's elementwise
tail fused: the batch-norm affine (mHuBERT-147), the zero padding of 64
frames a side, the even width's dropped frame, the bias, the exact GELU and
the residual. w is split once into three bf16 pieces (``split_pieces``,
cached by ``models/hubert.py``), bn(x) inside the kernel, each product the
six piece products of order <= 2, each 16-channel step of a tap a float32
partial of its own. cuDNN's float32 conv runs on the CUDA cores, and its
TF32 mode misses the float32 class.

``engages`` is the rule by which ``hubert_hidden_state`` takes the kernel;
it reads only what the call can observe. ``pos_conv`` on a CPU tensor is
the plain version, ``_pos_conv_plain``: the stage's own steps on
``F.conv1d``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from fast_speech_enhancement_metrics_tpu_torch.ops import cuda_lib, numerics

KERNEL = "pos_conv"
STRIDE = 1
#: the conv width the kernel is built for (even: the last output frame is dropped)
WIDTH = 128
#: channels a group the kernel is built for: mHuBERT-147 / HuBERT base 48, HuBERT large / WavLM-Large 64
GROUP_CHANNELS = (48, 64)
#: input channels of one partial: one k16 step of the tensor cores
STEP_CHANNELS = 16


def engages(device_type: str, dtype: torch.dtype, stride: int, width: int, channels: int, groups: int) -> bool:
    """Whether a positional conv of this shape runs on the kernel: on a CUDA
    device, float32 activations, stride 1, width 128, and 48 or 64 channels
    a group (multiples of 16, the kernel's two instantiations)."""
    return (device_type == "cuda" and dtype == torch.float32 and stride == STRIDE and width == WIDTH
            and groups > 0 and channels % groups == 0 and channels // groups in GROUP_CHANNELS)


def split_pieces(w: torch.Tensor, groups: int) -> torch.Tensor:
    """(C, C / groups, k) float32 weights -> their three bf16 pieces as the
    kernel reads them, (groups, k, 3, c_g / 8, c_g, 8): for group g and tap
    j, piece q of w[g c_g + o, 8 p + e, j] at [g, j, q, p, o, e] (each tap's
    three pieces one contiguous block, each piece panels of 8 input channels
    with the c_g output channels as rows)."""
    c, cg, k = w.shape
    per_tap = w.reshape(groups, cg, cg, k).permute(0, 3, 2, 1)  # (g, j, c, o)
    per_tap = per_tap.reshape(groups, k, cg // 8, 8, cg).transpose(3, 4)  # (g, j, p, o, e)
    return torch.stack(numerics.split3(per_tap), dim=2).contiguous()


def _pos_conv_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, groups: int,
                    bn_scale: torch.Tensor | None = None, bn_shift: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version, the encoder's own steps: BN affine, the grouped
    conv (cuDNN, TF32 off, on a card) over transposed views, the even
    width's last frame dropped, + b, the exact GELU, + x."""
    dt = x.dtype
    pos_in = x
    if bn_scale is not None:
        pos_in = x * bn_scale.to(dt) + bn_shift.to(dt)
    k = w.shape[2]
    with numerics.conv_flags():
        pos = F.conv1d(pos_in.transpose(1, 2), w.to(dt), padding=k // 2, groups=groups).transpose(1, 2)
    if k % 2 == 0:
        pos = pos[:, :-1, :]
    return x + F.gelu(pos + b.to(dt))


def _pos_conv_pieces_reference(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, groups: int,
                               bn_scale: torch.Tensor | None = None,
                               bn_shift: torch.Tensor | None = None) -> torch.Tensor:
    """The kernel's arithmetic, its products in float64: bn(x) in float32
    (zero padding after it), x and w split into three pieces each, per tap
    and 16-channel step the six piece products of order <= 2 summed into a
    partial rounded to float32 and added to a float32 sum in the kernel's
    order (taps outer, steps inner), then + b, the exact GELU and + x in
    float32; the frames of the unpadded input alone."""
    bsz, t, c = x.shape
    cg, k = w.shape[1], w.shape[2]
    pos_in = x if bn_scale is None else x * bn_scale + bn_shift
    xp = [F.pad(p.double(), (0, 0, k // 2, k // 2)).reshape(bsz, t + k, groups, cg) for p in numerics.split3(pos_in)]
    wp = [p.double().reshape(groups, cg, cg, k) for p in numerics.split3(w)]  # (g, o, c, j)
    acc = torch.zeros(bsz, t, groups, cg, dtype=torch.float32)
    for j in range(k):
        for c0 in range(0, cg, STEP_CHANNELS):
            part = sum(torch.einsum("btgc,goc->btgo", xp[a][:, j:j + t, :, c0:c0 + STEP_CHANNELS],
                                    wp[q][:, :, c0:c0 + STEP_CHANNELS, j]) for a, q in numerics.PRODUCTS)
            acc = acc + part.float()
    return x + F.gelu(acc.reshape(bsz, t, c) + b)


def pos_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, groups: int,
             bn_scale: torch.Tensor | None = None, bn_shift: torch.Tensor | None = None,
             pieces: torch.Tensor | None = None) -> torch.Tensor:
    """x + gelu(conv1d(bn(x), w, padding=k // 2, groups)[:T] + b), exact
    GELU: x (B, T, C) float32 channels last, w (C, C / groups, k), b (C,),
    the BN affine ``bn_scale`` / ``bn_shift`` (C,) or neither; the result is
    (B, T, C). On the card ``pieces`` (``split_pieces(w, groups)``, made
    here when not given) is what the kernel reads; ``engages`` must hold."""
    if (bn_scale is None) != (bn_shift is None):
        raise ValueError("bn_scale and bn_shift come together")
    return cuda_lib.dispatch("pos_conv kernel", x.device, lambda: _pos_conv_plain(x, w, b, groups, bn_scale, bn_shift),
                             lambda: _pos_conv_cuda(x, w, b, groups, bn_scale, bn_shift, pieces))


def _pos_conv_cuda(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, groups: int, bn_scale: torch.Tensor | None,
                   bn_shift: torch.Tensor | None, pieces: torch.Tensor | None) -> torch.Tensor:
    c, cg, k = w.shape
    if not engages(x.device.type, x.dtype, STRIDE, k, c, groups):
        raise ValueError(f"no pos_conv kernel for {x.dtype} on {x.device} with weights {tuple(w.shape)} in {groups} "
                         f"groups: float32 on CUDA, width {WIDTH}, {GROUP_CHANNELS} channels a group")
    if x.dim() != 3 or x.shape[2] != c or x.shape[1] < 1:
        raise ValueError(f"x must be (B, T, {c}), got {tuple(x.shape)}")
    if pieces is None:
        pieces = split_pieces(w, groups)
    cuda_lib.check_operand(x, "x", x.device, torch.float32, 3)
    cuda_lib.check_operand(pieces, "pieces", x.device, torch.bfloat16, 6)
    if tuple(pieces.shape) != (groups, k, 3, cg // 8, cg, 8):
        raise ValueError(f"pieces must be ({groups}, {k}, 3, {cg // 8}, {cg}, 8), got {tuple(pieces.shape)}")
    vectors = [b] + ([] if bn_scale is None else [bn_scale, bn_shift])
    for name, v in zip(("b", "bn_scale", "bn_shift"), vectors):
        cuda_lib.check_operand(v, name, x.device, torch.float32, 1)
        if v.shape[0] != c:
            raise ValueError(f"{name} must be ({c},), got {tuple(v.shape)}")
    if any(t.data_ptr() % 16 for t in (x, pieces, *vectors)):
        raise ValueError("x, pieces, b and the BN vectors must start 16-byte aligned: the kernel reads them in "
                         "16-byte runs")
    bsz, t, _ = x.shape
    out = torch.empty_like(x)
    cuda_lib.launch(KERNEL, x.device, x, pieces, bn_scale, bn_shift, b, out, bsz, t, c, groups)
    return out

"""gelu(conv1d(x, w, stride 2)) in float32: the HuBERT conv encoder's convs 1-6 on a CUDA kernel.

No Pallas kernel of the JAX package computes this: its ``feature_encoder``
leaves the convs to XLA, which the TPU runs at "highest" as bf16x6 MXU
passes. The port's kernel (``csrc/conv_gelu.cu``) is that class on the
H100's bf16 tensor cores: w split once into three bf16 pieces
(``split_pieces``, cached per layer by ``models/hubert.py``), x split inside
the kernel, each product the six piece products of order <= 2 summed in
float32, the GELU applied in the epilogue. cuDNN's float32 conv runs on the
CUDA cores, and its TF32 mode misses the encoder's float32 class.

``engages`` is the rule by which ``feature_encoder`` takes the kernel; it
reads only what the call can observe. ``conv_gelu`` on a CPU tensor is the
plain version: ``F.conv1d`` then ``F.gelu``, the encoder's own steps.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from fast_speech_enhancement_metrics_tpu_torch.ops import cuda_lib

KERNEL = "conv_gelu"
STRIDE = 2
WIDTHS = (2, 3)
#: channel counts the kernel takes on both sides: multiples of this
CHANNEL_MULTIPLE = 64
GELUS = ("erf", "tanh")


def engages(device_type: str, dtype: torch.dtype, stride: int, width: int, c_in: int, c_out: int) -> bool:
    """Whether a conv of this shape, followed by a GELU, runs on the kernel:
    on a CUDA device, float32 activations, stride 2, width 2 or 3, and input
    and output channels multiples of 64."""
    return (device_type == "cuda" and dtype == torch.float32 and stride == STRIDE and width in WIDTHS
            and c_in > 0 and c_out > 0 and c_in % CHANNEL_MULTIPLE == 0 and c_out % CHANNEL_MULTIPLE == 0)


def _split3(t: torch.Tensor) -> list[torch.Tensor]:
    """t's three bf16 pieces, t0 = bf16(t), t1 = bf16(t - t0), t2 = bf16(t - t0 - t1),
    rounded to nearest even; each difference is exact in float32, and t0 + t1 + t2 == t."""
    pieces, rest = [], t.float()
    for _ in range(3):
        pieces.append(rest.to(torch.bfloat16))
        rest = rest - pieces[-1].float()
    return pieces


def split_pieces(w: torch.Tensor) -> torch.Tensor:
    """(C_out, C_in, k) float32 weights -> their three bf16 pieces (``_split3``)
    as the kernel reads them, (3, k, C_out, C_in)."""
    return torch.stack(_split3(w.permute(2, 0, 1))).contiguous()


def _gelu(x: torch.Tensor, gelu: str) -> torch.Tensor:
    return F.gelu(x, approximate="tanh" if gelu == "tanh" else "none")


def _conv_gelu_plain(x: torch.Tensor, w: torch.Tensor, gelu: str) -> torch.Tensor:
    """Plain PyTorch version: the stride-2 conv (cuDNN, TF32 off, on a card) then the GELU."""
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        y = F.conv1d(x, w.to(x.dtype), stride=STRIDE)
    return _gelu(y, gelu)


def _conv_gelu_pieces_reference(x: torch.Tensor, w: torch.Tensor, gelu: str) -> torch.Tensor:
    """The kernel's arithmetic in float64: x and w split into three pieces
    each, the six piece products of order <= 2 summed, then the GELU."""
    xp = [p.double() for p in _split3(x)]
    wp = [p.double() for p in _split3(w)]
    y = sum(F.conv1d(xp[a], wp[b], stride=STRIDE) for a, b in ((1, 1), (0, 2), (2, 0), (0, 1), (1, 0), (0, 0)))
    return _gelu(y, gelu)


def conv_gelu(x: torch.Tensor, w: torch.Tensor, gelu: str = "erf", pieces: torch.Tensor | None = None) -> torch.Tensor:
    """gelu(conv1d(x, w, stride=2)), no padding, no bias: x (B, C_in, T_in)
    float32, w (C_out, C_in, k), k 2 or 3, T_in >= k; ``gelu`` "erf" or
    "tanh". On the card ``pieces`` (``split_pieces(w)``, made here when not
    given) is what the kernel reads; C_in and C_out multiples of 64."""
    if gelu not in GELUS:
        raise ValueError(f"gelu must be one of {GELUS}, got {gelu!r}")
    if x.device.type == "cpu":
        return _conv_gelu_plain(x, w, gelu)
    c_out, c_in, width = w.shape
    if not engages(x.device.type, x.dtype, STRIDE, width, c_in, c_out):
        raise ValueError(f"no conv_gelu kernel for {x.dtype} on {x.device} with weights {tuple(w.shape)}: "
                         f"float32 on CUDA, width in {WIDTHS}, channels multiples of {CHANNEL_MULTIPLE}")
    if x.dim() != 3 or x.shape[1] != c_in or x.shape[2] < width:
        raise ValueError(f"x must be (B, {c_in}, T >= {width}), got {tuple(x.shape)}")
    if pieces is None:
        pieces = split_pieces(w)
    cuda_lib.check_operand(x, "x", x.device, torch.float32, 3)
    cuda_lib.check_operand(pieces, "pieces", x.device, torch.bfloat16, 4)
    if x.data_ptr() % 16:
        raise ValueError("x must start 16-byte aligned: the kernel copies its rows in aligned 16-byte runs")
    if tuple(pieces.shape) != (3, width, c_out, c_in):
        raise ValueError(f"pieces must be (3, {width}, {c_out}, {c_in}), got {tuple(pieces.shape)}")
    b, _, t_in = x.shape
    out = torch.empty(b, c_out, (t_in - width) // STRIDE + 1, device=x.device, dtype=torch.float32)
    cuda_lib.launch(KERNEL, x.device, x, pieces, out, b, c_in, c_out, t_in, width, GELUS.index(gelu))
    cuda_lib.launch_counts[KERNEL] += 1
    return out

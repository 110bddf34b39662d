"""gelu(conv1d(x, w)) in float32, with or without a LayerNorm over channels: the HuBERT conv encoder on CUDA kernels.

No Pallas kernel of the JAX package computes this: its ``feature_encoder``
leaves the convs to XLA, which the TPU runs at "highest" as bf16x6 MXU
passes. The port's kernel for convs 1-6 (``csrc/conv_gelu.cu``) is that
class on the H100's bf16 tensor cores: w split once into three bf16 pieces
(``split_pieces``, cached per layer by ``models/hubert.py``), x split inside
the kernel, each product the six piece products of order <= 2 summed in
float32 (``ops/numerics.py``), the GELU applied in the epilogue. cuDNN's
float32 conv runs on the CUDA cores, and its TF32 mode misses the
encoder's float32 class.

The layer-norm encoder (WavLM) normalises every conv's output over its
channels before the GELU. There the same kernel takes convs 1-6 with the
LayerNorm in its epilogue (``conv_ln_gelu``: the blocks of a frame's
channels run as one cluster and exchange their partial sums), and conv 0,
whose one input channel the tensor-core kernel does not take, runs on a
direct float32 kernel with the same epilogue (``conv0_ln_gelu``). No pass
over the encoder's activations is left outside the conv kernels.

``engages``, ``engages_ln`` and ``engages_conv0_ln`` are the rules by which
``feature_encoder`` takes the kernels; they read only what the call can
observe. Each wrapper on a CPU tensor is its plain version: ``F.conv1d``,
then ``numerics.layer_norm`` over channels where there is one, then the
GELU, the encoder's own steps.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from fast_speech_enhancement_metrics_tpu_torch.ops import cuda_lib, numerics

KERNEL = "conv_gelu"
#: convs 1-6 with the LayerNorm fused (the same entry point, counted apart)
KERNEL_LN = "conv_ln_gelu"
#: conv 0 of the layer-norm encoder
KERNEL_CONV0 = "conv0_ln_gelu"
STRIDE = 2
WIDTHS = (2, 3)
#: channel counts the kernel takes on both sides: multiples of this
CHANNEL_MULTIPLE = 64
#: with the LayerNorm, output channels come in blocks of this many, a cluster
#: of at most ``LN_MAX_BLOCKS`` blocks a frame
LN_BLOCK = 128
LN_MAX_BLOCKS = 8
#: conv 0's shape, the one the direct kernel takes: (input channels, width,
#: stride, output channels)
CONV0_SHAPE = (1, 10, 5, 512)
GELUS = ("erf", "tanh")


def engages(device_type: str, dtype: torch.dtype, stride: int, width: int, c_in: int, c_out: int) -> bool:
    """Whether a conv of this shape, followed by a GELU, runs on the kernel:
    on a CUDA device, float32 activations, stride 2, width 2 or 3, and input
    and output channels multiples of 64."""
    return (device_type == "cuda" and dtype == torch.float32 and stride == STRIDE and width in WIDTHS
            and c_in > 0 and c_out > 0 and c_in % CHANNEL_MULTIPLE == 0 and c_out % CHANNEL_MULTIPLE == 0)


def engages_ln(device_type: str, dtype: torch.dtype, stride: int, width: int, c_in: int, c_out: int) -> bool:
    """Whether a conv of this shape, followed by a LayerNorm over its
    channels and a GELU, runs on the kernel with the LayerNorm fused: as
    ``engages``, and output channels a multiple of 128, at most 8 x 128."""
    return (engages(device_type, dtype, stride, width, c_in, c_out)
            and c_out % LN_BLOCK == 0 and c_out <= LN_BLOCK * LN_MAX_BLOCKS)


def engages_conv0_ln(device_type: str, dtype: torch.dtype, stride: int, width: int, c_in: int, c_out: int) -> bool:
    """Whether a conv of this shape, followed by a LayerNorm over its
    channels and a GELU, runs on the direct conv 0 kernel: on a CUDA device,
    float32 activations, 1 input channel, width 10, stride 5, 512 outputs."""
    return device_type == "cuda" and dtype == torch.float32 and (c_in, width, stride, c_out) == CONV0_SHAPE


def split_pieces(w: torch.Tensor) -> torch.Tensor:
    """(C_out, C_in, k) float32 weights -> their three bf16 pieces (``numerics.split3``)
    as the kernel reads them, (3, k, C_out, C_in)."""
    return torch.stack(numerics.split3(w.permute(2, 0, 1))).contiguous()


def _conv_gelu_plain(x: torch.Tensor, w: torch.Tensor, gelu: str) -> torch.Tensor:
    """Plain PyTorch version: the stride-2 conv (cuDNN, TF32 off, on a card) then the GELU."""
    with numerics.conv_flags():
        y = F.conv1d(x, w.to(x.dtype), stride=STRIDE)
    return numerics.gelu(y, gelu)


def _conv_ln_gelu_plain(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor, eps: float,
                        gelu: str, stride: int) -> torch.Tensor:
    """Plain PyTorch version of both LayerNorm kernels: the conv (cuDNN, TF32
    off, on a card), ``numerics.layer_norm`` over channels, the GELU."""
    with numerics.conv_flags():
        y = F.conv1d(x, w.to(x.dtype), stride=stride)
    return numerics.gelu(numerics.layer_norm(y.transpose(1, 2), scale, shift, eps).transpose(1, 2), gelu)


def _pieces_conv64(x: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
    """The conv as the tensor-core kernel forms it, in float64: x and w
    split into three pieces each, the six piece products of order <= 2 summed."""
    xp = [p.double() for p in numerics.split3(x)]
    wp = [p.double() for p in numerics.split3(w)]
    return sum(F.conv1d(xp[a], wp[b], stride=stride) for a, b in numerics.PRODUCTS)


def _conv_gelu_pieces_reference(x: torch.Tensor, w: torch.Tensor, gelu: str) -> torch.Tensor:
    """The kernel's arithmetic in float64: x and w split into three pieces
    each, the six piece products of order <= 2 summed, then the GELU."""
    return numerics.gelu(_pieces_conv64(x, w, STRIDE), gelu)


def _conv_ln_gelu_reference(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor, eps: float,
                            gelu: str, stride: int) -> torch.Tensor:
    """The LayerNorm kernels' arithmetic in float64: the conv (at stride 2
    the six piece products of ``conv_ln_gelu``, at conv 0's stride the
    unsplit products of ``conv0_ln_gelu``), per frame the mean over
    channels, then the mean of the centred squares, (v - mean) rsqrt(var +
    eps) scale + shift, the GELU."""
    y = _pieces_conv64(x, w, stride) if stride == STRIDE else F.conv1d(x.double(), w.double(), stride=stride)
    mean = y.mean(dim=1, keepdim=True)
    var = ((y - mean) ** 2).mean(dim=1, keepdim=True)
    y = (y - mean) * torch.rsqrt(var + eps) * scale.double()[:, None] + shift.double()[:, None]
    return numerics.gelu(y, gelu)


def conv_gelu(x: torch.Tensor, w: torch.Tensor, gelu: str = "erf", pieces: torch.Tensor | None = None) -> torch.Tensor:
    """gelu(conv1d(x, w, stride=2)), no padding, no bias: x (B, C_in, T_in)
    float32, w (C_out, C_in, k), k 2 or 3, T_in >= k; ``gelu`` "erf" or
    "tanh". On the card ``pieces`` (``split_pieces(w)``, made here when not
    given) is what the kernel reads; C_in and C_out multiples of 64."""
    _check_gelu(gelu)
    return cuda_lib.dispatch("conv_gelu kernel", x.device, lambda: _conv_gelu_plain(x, w, gelu),
                             lambda: _conv_gelu_cuda(x, w, None, None, 0.0, gelu, pieces))


def conv_ln_gelu(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor, eps: float,
                 gelu: str = "erf", pieces: torch.Tensor | None = None) -> torch.Tensor:
    """gelu(LayerNorm_channels(conv1d(x, w, stride=2))), no padding, no
    bias: as ``conv_gelu``, the LayerNorm's ``scale`` and ``shift`` (C_out,)
    and ``eps`` applied per frame over the C_out channels; on the card C_out
    a multiple of 128, at most 1024."""
    _check_gelu(gelu)
    return cuda_lib.dispatch("conv_ln_gelu kernel", x.device,
                             lambda: _conv_ln_gelu_plain(x, w, scale, shift, eps, gelu, STRIDE),
                             lambda: _conv_gelu_cuda(x, w, scale, shift, eps, gelu, pieces))


def conv0_ln_gelu(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor, eps: float,
                  gelu: str = "erf") -> torch.Tensor:
    """gelu(LayerNorm_channels(conv1d(x, w, stride=5))), the layer-norm
    encoder's conv 0: x (B, 1, T_in) float32, T_in >= 10, w (512, 1, 10),
    the LayerNorm's ``scale`` and ``shift`` (512,) and ``eps``."""
    _check_gelu(gelu)
    stride = CONV0_SHAPE[2]
    return cuda_lib.dispatch("conv0_ln_gelu kernel", x.device,
                             lambda: _conv_ln_gelu_plain(x, w, scale, shift, eps, gelu, stride),
                             lambda: _conv0_ln_gelu_cuda(x, w, scale, shift, eps, gelu))


def _check_gelu(gelu: str) -> None:
    if gelu not in GELUS:
        raise ValueError(f"gelu must be one of {GELUS}, got {gelu!r}")


def _check_norm(scale: torch.Tensor, shift: torch.Tensor, x: torch.Tensor, c_out: int) -> None:
    for t, what in ((scale, "scale"), (shift, "shift")):
        cuda_lib.check_operand(t, what, x.device, torch.float32, 1)
        if t.shape[0] != c_out:
            raise ValueError(f"{what} must be ({c_out},), got {tuple(t.shape)}")


def _conv_gelu_cuda(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor | None, shift: torch.Tensor | None,
                    eps: float, gelu: str, pieces: torch.Tensor | None) -> torch.Tensor:
    c_out, c_in, width = w.shape
    norm = scale is not None
    rule = engages_ln if norm else engages
    if not rule(x.device.type, x.dtype, STRIDE, width, c_in, c_out):
        raise ValueError(f"no {KERNEL_LN if norm else KERNEL} kernel for {x.dtype} on {x.device} with weights "
                         f"{tuple(w.shape)}: float32 on CUDA, width in {WIDTHS}, channels multiples of "
                         f"{CHANNEL_MULTIPLE}" + (f", outputs of {LN_BLOCK}, at most "
                                                  f"{LN_BLOCK * LN_MAX_BLOCKS}" if norm else ""))
    if x.dim() != 3 or x.shape[1] != c_in or x.shape[2] < width:
        raise ValueError(f"x must be (B, {c_in}, T >= {width}), got {tuple(x.shape)}")
    if pieces is None:
        pieces = split_pieces(w)
    cuda_lib.check_operand(x, "x", x.device, torch.float32, 3)
    cuda_lib.check_operand(pieces, "pieces", x.device, torch.bfloat16, 4)
    if norm:
        _check_norm(scale, shift, x, c_out)
    if x.data_ptr() % 16:
        raise ValueError("x must start 16-byte aligned: the kernel copies its rows in aligned 16-byte runs")
    if tuple(pieces.shape) != (3, width, c_out, c_in):
        raise ValueError(f"pieces must be (3, {width}, {c_out}, {c_in}), got {tuple(pieces.shape)}")
    b, _, t_in = x.shape
    out = torch.empty(b, c_out, (t_in - width) // STRIDE + 1, device=x.device, dtype=torch.float32)
    cuda_lib.launch(KERNEL, x.device, x, pieces, scale, shift, out, b, c_in, c_out, t_in, width, GELUS.index(gelu),
                    float(eps), count=KERNEL_LN if norm else KERNEL)
    return out


def _conv0_ln_gelu_cuda(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor, eps: float,
                        gelu: str) -> torch.Tensor:
    c_in, width, stride, c_out = CONV0_SHAPE
    if not engages_conv0_ln(x.device.type, x.dtype, stride, w.shape[2], w.shape[1], w.shape[0]):
        raise ValueError(f"no {KERNEL_CONV0} kernel for {x.dtype} on {x.device} with weights {tuple(w.shape)}: "
                         f"float32 on CUDA, weights ({c_out}, {c_in}, {width})")
    if x.dim() != 3 or x.shape[1] != c_in or x.shape[2] < width:
        raise ValueError(f"x must be (B, {c_in}, T >= {width}), got {tuple(x.shape)}")
    x, w = x.contiguous(), w.contiguous()
    cuda_lib.check_operand(w, "w", x.device, torch.float32, 3)
    _check_norm(scale, shift, x, c_out)
    b, _, t_in = x.shape
    out = torch.empty(b, c_out, (t_in - width) // stride + 1, device=x.device, dtype=torch.float32)
    cuda_lib.launch(KERNEL_CONV0, x.device, x, w, scale, shift, out, b, t_in, GELUS.index(gelu), float(eps))
    return out

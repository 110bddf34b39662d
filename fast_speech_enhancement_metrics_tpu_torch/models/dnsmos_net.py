"""DNSMOS P.835 network in PyTorch.

Counterpart of the JAX package's ``models/dnsmos_net.py``. Architecture
contract (Microsoft DNS-Challenge ``sig_bak_ovr.onnx``): a learned 320-point
STFT (real/imag at 161 bins), log power spectrum, a 7-layer 3x3 CNN with
three 2x2 max-pools, global max over all (time, freq) positions, and a
3-layer MLP emitting raw SIG/BAK/OVR.

Activations are NCHW with H = time and W = frequency (the JAX package's are
NHWC), so its time-axis slices ``x[:, t0:t1, :, :]`` are ``x[:, :, t0:t1, :]``
here. Convolutions are ``F.conv2d`` with ``padding=1`` ("SAME" for 3x3),
under cuDNN with TF32 off (``ops/numerics.py::conv_flags``): a float32
conv is float32 on the card as on the CPU. The learned STFT and the output
MLP always run in float32.

``conv_dtype=torch.bfloat16`` runs the trunk's activations in bf16 with
float32 accumulation (cuDNN bf16 convs). Such a conv rounds its output to
bf16 before the bias is added, where the JAX package adds the bias to the
float32 conv output; the bias is then added in float32 and the sum rounded
to bf16 once, then the ReLU, which gives the JAX package's bias, ReLU and
cast of that bf16 output.

Parameters come from the committed ``.npz`` (JAX layouts), mapped at load
time to OIHW conv weights and ``(out, in)`` matmul weights
(``utils/convert_dnsmos.py::npz_to_torch_layout``).

While a ``torch.profiler`` session records, the learned STFT features, the
trunk and the edge strips are spans (``tracing.py``).
"""

from __future__ import annotations

import functools
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from fast_speech_enhancement_metrics_tpu_torch import tracing
from fast_speech_enhancement_metrics_tpu_torch.ops import numerics
from fast_speech_enhancement_metrics_tpu_torch.utils.convert_dnsmos import npz_to_torch_layout

#: cuDNN's flags around the trunk's convs (TF32 off), looked up at each use
_conv_flags = numerics.conv_flags

DEFAULT_CHECKPOINT = Path(__file__).parent.parent / "checkpoints" / "dnsmos_sig_bak_ovr.npz"

#: channel widths of the 7 conv layers
CONV_CHANNELS = (128, 64, 64, 32, 32, 32, 64)
#: conv layer indices followed by a 2x2 max-pool
POOL_AFTER = frozenset({3, 4, 5})
#: the JAX package's MXU width-packing factors per conv layer
#: (``conv_pack="mxu"``): TPU layout work of identical math, which the
#: port accepts and runs as the same convolution
MXU_CONV_PACK = (8, 2, 2, 4, 4, 4, 2)
#: ``conv_pack="winograd"``: Winograd F(2x2, 3x3) on convs 1-6 in the JAX
#: package, the same convolution here
WINOGRAD_CONV_PACK = (1, "w", "w", "w", "w", "w", "w")


@functools.lru_cache(maxsize=None)
def _load_arrays(path: str) -> dict[str, np.ndarray]:
    with np.load(path) as data:
        return npz_to_torch_layout(dict(data))


def load_params(path: str | Path = DEFAULT_CHECKPOINT, device: torch.device | str = "cpu") -> dict[str, torch.Tensor]:
    """Load the DNSMOS weights in the port's layouts (float32, on ``device``)."""
    return {k: torch.from_numpy(v).to(device) for k, v in _load_arrays(str(path)).items()}


def _max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2/2 max pool over (time, freq), odd edges dropped (floor), as the
    JAX package's slice plus ``reduce_window``."""
    return F.max_pool2d(x, 2, 2)


def _log_power_features(params: dict, audio: torch.Tensor) -> torch.Tensor:
    """(N, T) -> (N, frames, 161) log power via the learned STFT, in float32.

    The 320-sample frames overlap 50% (hop 160), so frame f is
    [chunk_f | chunk_{f+1}] of the (T/160, 160) chunk reshape: one packed
    (160, 644) matmul on the chunks, [real_top | imag_top | real_bot |
    imag_bot], and a sum of adjacent chunks' halves.
    """
    with tracing.span("fsem.dnsmos.features"):
        n_chunks = audio.shape[1] // 160
        f = n_chunks - 1
        chunks = audio[:, : n_chunks * 160].reshape(audio.shape[0], n_chunks, 160)
        real_w, imag_w = params["stft_real"], params["stft_imag"]  # (161, 320)
        w = torch.cat([real_w[:, :160], imag_w[:, :160], real_w[:, 160:], imag_w[:, 160:]], dim=0).t()
        a = chunks @ w
        nb = real_w.shape[0]
        real = a[:, :f, 0 * nb : 1 * nb] + a[:, 1:, 2 * nb : 3 * nb]
        imag = a[:, :f, 1 * nb : 2 * nb] + a[:, 1:, 3 * nb : 4 * nb]
        power = torch.square(real) + torch.square(imag)
        return torch.log10(torch.clamp(power, min=1e-12))


def _conv_layer(params: dict, x: torch.Tensor, n: int) -> torch.Tensor:
    """relu(conv3x3_SAME(x) + b), in x's dtype."""
    w, b = params[f"conv{n}_w"], params[f"conv{n}_b"]
    if x.dtype == torch.float32:
        return torch.relu_(F.conv2d(x, w, b, padding=1))
    y = F.conv2d(x, w.to(x.dtype), padding=1)
    # a bf16 tensor plus a float32 one adds in float32 and rounds once on
    # the store; rounding commutes with the ReLU
    y.add_(b[:, None, None])
    return torch.relu_(y)


def _output_mlp(params: dict, pooled: torch.Tensor) -> torch.Tensor:
    """(..., 64) float32 -> (..., 3) raw SIG/BAK/OVR."""
    h = torch.relu(F.linear(pooled, params["dense0_w"], params["dense0_b"]))
    h = torch.relu(F.linear(h, params["dense1_w"], params["dense1_b"]))
    return F.linear(h, params["dense2_w"], params["dense2_b"])


def _trunk_conv0_5(params: dict, z: torch.Tensor, conv_dtype) -> torch.Tensor:
    """(N, 1, T, 161) -> (N, 32, T/4, 40): convs 0-5 and the first two pools."""
    if conv_dtype is not None:
        z = z.to(conv_dtype)
    for n in range(4):
        z = _conv_layer(params, z, n)
    z = _max_pool_2x2(z)
    z = _conv_layer(params, z, 4)
    z = _max_pool_2x2(z)
    return _conv_layer(params, z, 5)


def _pool3_phases(params: dict, x: torch.Tensor) -> list[torch.Tensor]:
    """Pool 3 + conv 6 on the two pool grids of the shared trunk: phase 0
    from time row 0, phase 1 from time row 1 -> two (N, 64, P, 20) maps."""
    return [_conv_layer(params, _max_pool_2x2(x[:, :, phase:, :]), 6) for phase in (0, 1)]


def dnsmos_net_shared(
    params: dict,
    audio: torch.Tensor,
    num_windows: int,
    frames_per_hop: int = 100,
    conv_dtype=None,
) -> torch.Tensor:
    """Shared-conv evaluation of all 9.01 s windows of (B, T) audio at once:
    (B, S, 3) raw scores.

    Consecutive windows overlap 8.01 s of 9.01 s and the 1 s hop is exactly
    100 STFT frames, so convs 0-5 and the first two pools run once over the
    full signal; the third time-pool needs two phases (the window offset on
    its input grid is 100/4 = 25, odd). Window k reads 112 pooled cells
    from (100k - 100k mod 8) / 8 in its phase. Deviates from per-window
    evaluation only through window-boundary context (each window's own
    zero padding is not applied).
    """
    if frames_per_hop % 4 != 0:
        raise ValueError(
            "shared-conv mode needs the hop to be a multiple of 4 STFT frames "
            f"(two pool-grid phases); got frames_per_hop={frames_per_hop}"
        )
    with _conv_flags():
        feats = _log_power_features(params, audio)
        with tracing.span("fsem.dnsmos.trunk"):
            phases = _pool3_phases(params, _trunk_conv0_5(params, feats[:, None], conv_dtype))
        window_cells = 900 // 8  # 112 pooled cells per 9.01 s window
        pooled = []
        for k in range(num_windows):
            start_frame = k * frames_per_hop
            phase = (start_frame % 8) // 4
            j0 = (start_frame - start_frame % 8) // 8
            pooled.append(torch.amax(phases[phase][:, :, j0 : j0 + window_cells], dim=(2, 3)))
        pooled = torch.stack(pooled, dim=1).float()  # (B, S, 64)
        return _output_mlp(params, pooled)


#: geometry of the exact windowed evaluation (the JAX package's
#: ``models/dnsmos_net.py``). A 9.01 s window is 900 STFT frames -> 112
#: pool-3 cells. A final cell's receptive field reaches +-18 input frames,
#: so only cells {0, 1, 2} and {110, 111} see the per-window zero padding;
#: the others are the same math on the same inputs in the shared trunk.
_WINDOW_FRAMES = 900
_CELLS_PER_WINDOW = 112
_EDGE_LEFT_CELLS = 3
_EDGE_RIGHT_CELLS = 2
#: edge strips (in frames) whose own zero padding reproduces the window's
#: edge cells: the left one keeps the window's pool grids (a multiple of
#: 8), the right one starts on the window's pool-3 grid
_LEFT_STRIP = 48
_RIGHT_STRIP = 44


def dnsmos_net_windowed_exact(
    params: dict,
    audio: torch.Tensor,
    num_windows: int,
    frames_per_hop: int = 100,
    conv_dtype=None,
) -> torch.Tensor:
    """Exact windowed DNSMOS of (B, T) audio with the conv trunk shared:
    the (B, S, 3) raw scores of ``dnsmos_net`` on every 9.01 s window, up to
    float reassociation.

    * convs 0-5 (+ pools 1-2) run once over the full signal, pool 3 + conv 6
      on its two phases (see ``dnsmos_net_shared``),
    * per-window edge strips (48 and 44 of 900 frames) re-run the stack with
      the window's zero padding to give its 5 boundary cells,
    * per-window global max over the interior cells of the shared maps and
      the strips' edge cells -> MLP.
    """
    if frames_per_hop % 4 != 0:
        raise ValueError(
            "exact shared-conv mode needs the hop to be a multiple of 4 STFT "
            f"frames (pool-grid alignment); got frames_per_hop={frames_per_hop}"
        )
    with _conv_flags():
        feats = _log_power_features(params, audio)  # (B, Tf, 161)
        batch = feats.shape[0]
        with tracing.span("fsem.dnsmos.trunk"):
            phases = _pool3_phases(params, _trunk_conv0_5(params, feats[:, None], conv_dtype))

        def edge_cells(start: int, length: int) -> torch.Tensor:
            """Per-window feature strips through the stack with the window's
            own zero padding: (B*S, 64, cells, 20)."""
            strip = torch.stack(
                [feats[:, k * frames_per_hop + start : k * frames_per_hop + start + length]
                 for k in range(num_windows)],
                dim=1,
            ).reshape(batch * num_windows, 1, length, feats.shape[2])
            z = _max_pool_2x2(_trunk_conv0_5(params, strip, conv_dtype))
            return _conv_layer(params, z, 6)

        with tracing.span("fsem.dnsmos.edges"):
            left = edge_cells(0, _LEFT_STRIP)[:, :, :_EDGE_LEFT_CELLS]
            right = edge_cells(_WINDOW_FRAMES - _RIGHT_STRIP, _RIGHT_STRIP)[:, :, -_EDGE_RIGHT_CELLS:]
        left_max = torch.amax(left, dim=(2, 3)).reshape(batch, num_windows, -1)
        right_max = torch.amax(right, dim=(2, 3)).reshape(batch, num_windows, -1)

        interior = []
        for k in range(num_windows):
            start = k * frames_per_hop
            j0 = start // 8
            cells = phases[(start % 8) // 4][
                :, :, j0 + _EDGE_LEFT_CELLS : j0 + _CELLS_PER_WINDOW - _EDGE_RIGHT_CELLS
            ]
            interior.append(torch.amax(cells, dim=(2, 3)))
        interior = torch.stack(interior, dim=1)  # (B, S, 64)

        pooled = torch.maximum(torch.maximum(interior, left_max), right_max).float()
        return _output_mlp(params, pooled)


def dnsmos_net(params: dict, audio: torch.Tensor, conv_dtype=None) -> torch.Tensor:
    """(N, 144160) audio windows at 16 kHz -> (N, 3) raw SIG/BAK/OVR."""
    with _conv_flags():
        x = _log_power_features(params, audio)[:, None]  # (N, 1, frames, 161)
        with tracing.span("fsem.dnsmos.trunk"):
            if conv_dtype is not None:
                x = x.to(conv_dtype)
            for n in range(len(CONV_CHANNELS)):
                x = _conv_layer(params, x, n)
                if n in POOL_AFTER:
                    x = _max_pool_2x2(x)
        pooled = torch.amax(x, dim=(2, 3)).float()  # global max -> (N, 64)
        return _output_mlp(params, pooled)

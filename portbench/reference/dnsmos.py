"""Plain reference of DNSMOS P.835 (SIG / BAK / OVRL): float32 PyTorch, TF32 off.

Microsoft DNS-Challenge's ``dnsmos_local.py`` pipeline on ``sig_bak_ovr``:
the clip is repeated (doubled) until it reaches 9.01 s, every 9.01 s window
that fits is taken at exact 1 s hops (as the upstream
fast_speech_enhancement_metrics does: it documents a bug in Microsoft's
original segmentation and fixes it so), and every window goes through the
whole net on its own:
a learned STFT (320-tap frames at a 160 hop, real and imaginary parts at 161
bins), the log10 power, seven 3x3 convs with ReLU and zero padding, a 2x2
max-pool after the fourth, fifth and sixth, a global max over time and
frequency, and a three-layer MLP. Each raw score is calibrated by
Microsoft's polynomial and the clip's score is the mean over its windows.

The weights are read with numpy from the ``.npz`` the program also ships
(the ONNX release converted: learned STFT (320, 161), convs HWIO, dense (in,
out)) and laid out here again. Nothing here imports the program under test.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.hubert import float32_exact

SAMPLE_RATE = 16000
WINDOW = int(9.01 * SAMPLE_RATE)  # 144160 samples
HOP = SAMPLE_RATE
#: Microsoft's calibration polynomials c + b1 x + b2 x^2 for SIG, BAK, OVRL
POLY = {"SIG": (0.0052439, 1.22083953, -0.08397278),
        "BAK": (-0.39604546, 1.60915514, -0.13166888),
        "OVRL": (0.04602535, 1.11546468, -0.06766283)}
POOL_AFTER = (3, 4, 5)


def load(path: str, device) -> dict[str, torch.Tensor]:
    """The ``.npz`` weights as float32 tensors in PyTorch's layouts."""
    with np.load(path) as data:
        raw = {k: np.asarray(data[k], dtype=np.float32) for k in data.files}
    out = {}
    for name, w in raw.items():
        if name.startswith("conv") and name.endswith("_w"):
            w = w.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        elif name.startswith(("stft_", "dense")) and name.endswith(("_w", "real", "imag")):
            w = w.T  # (in, out) -> (out, in)
        out[name] = torch.from_numpy(np.ascontiguousarray(w)).to(device)
    return out


def tile(audio: torch.Tensor) -> torch.Tensor:
    """(T,) -> the clip doubled until it holds at least one window."""
    while audio.shape[0] < WINDOW:
        audio = torch.cat([audio, audio])
    return audio


def raw_scores(w: dict, windows: torch.Tensor) -> torch.Tensor:
    """(N, WINDOW) -> (N, 3) raw SIG, BAK, OVR."""
    frames = windows.unfold(1, 320, 160)  # (N, 900, 320)
    real = frames @ w["stft_real"].T
    imag = frames @ w["stft_imag"].T
    x = torch.log10(torch.clamp(real * real + imag * imag, min=1e-12))[:, None]  # (N, 1, 900, 161)
    for n in range(7):
        x = torch.relu(F.conv2d(x, w[f"conv{n}_w"], w[f"conv{n}_b"], padding=1))
        if n in POOL_AFTER:
            x = F.max_pool2d(x, 2)
    h = x.amax(dim=(2, 3))
    h = torch.relu(F.linear(h, w["dense0_w"], w["dense0_b"]))
    h = torch.relu(F.linear(h, w["dense1_w"], w["dense1_b"]))
    return F.linear(h, w["dense2_w"], w["dense2_b"])


def clip_scores(w: dict, audio: torch.Tensor, block: int = 32) -> dict[str, float]:
    """One clip (T,) -> {"SIG", "BAK", "OVRL"}, windows ``block`` at a time."""
    with float32_exact(), torch.inference_mode():
        x = tile(audio.float())
        windows = x.unfold(0, WINDOW, HOP)
        raw = torch.cat([raw_scores(w, windows[i:i + block]) for i in range(0, windows.shape[0], block)])
        out = {}
        for j, key in enumerate(("SIG", "BAK", "OVRL")):
            c, b1, b2 = POLY[key]
            out[key] = float((c + b1 * raw[:, j] + b2 * raw[:, j] ** 2).mean())
    return out

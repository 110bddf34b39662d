"""DNSMOS weight layouts: the torch checkpoint, the ``.npz`` and the port's.

Counterpart of the JAX package's ``utils/convert_dnsmos.py``. The DNSMOS
weights come from Microsoft's DNS-Challenge ONNX release
(``sig_bak_ovr.onnx``), re-expressed upstream as a torch state dict
(``SIG_BAK_OVR.pt``, not in this repository). Two maps:

* ``convert_state_dict``: the torch state dict -> the ``.npz`` layout that
  the JAX package and the committed checkpoint use (learned-STFT Conv1d
  ``(161, 320, 1)`` -> ``(320, 161)`` matmul weights, Conv2d OIHW -> HWIO,
  Linear ``(out, in)`` -> ``(in, out)``);
* ``npz_to_torch_layout``: the ``.npz`` layout -> the port's (HWIO -> OIHW
  for ``F.conv2d``, every matmul weight ``(in, out)`` -> ``(out, in)`` for
  ``F.linear``), which ``models/dnsmos_net.py`` applies at load time.

Usage::

    python -m fast_speech_enhancement_metrics_tpu_torch.utils.convert_dnsmos \\
        <SIG_BAK_OVR.pt> <output.npz>
"""

from __future__ import annotations

import sys

import numpy as np

#: torch Sequential indices of the 7 conv / 3 dense layers in the state dict
CONV_INDICES = (0, 2, 4, 6, 9, 12, 15)
DENSE_INDICES = (0, 2, 4)


def convert_state_dict(state_dict) -> dict[str, np.ndarray]:
    """Map a torch DNSMOS state dict to the ``.npz`` parameter layout."""

    def to_np(t):
        return np.ascontiguousarray(t.detach().cpu().numpy().astype(np.float32))

    params: dict[str, np.ndarray] = {
        # (161, 320, 1) conv1d -> (320, 161) matmul
        "stft_real": to_np(state_dict["conv_real_stft.weight"])[:, :, 0].T,
        "stft_imag": to_np(state_dict["conv_imag_stft.weight"])[:, :, 0].T,
    }
    for n, idx in enumerate(CONV_INDICES):
        w = to_np(state_dict[f"conv_layers.{idx}.weight"])  # (O, I, H, W)
        params[f"conv{n}_w"] = w.transpose(2, 3, 1, 0)  # -> HWIO
        params[f"conv{n}_b"] = to_np(state_dict[f"conv_layers.{idx}.bias"])
    for n, idx in enumerate(DENSE_INDICES):
        w = to_np(state_dict[f"output_layers.{idx}.weight"])  # (out, in)
        params[f"dense{n}_w"] = w.T
        params[f"dense{n}_b"] = to_np(state_dict[f"output_layers.{idx}.bias"])
    return params


def npz_to_torch_layout(params: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Map ``.npz``-layout parameters to the port's: conv weights HWIO ->
    OIHW, the learned STFT's and the dense layers' ``(in, out)`` -> ``(out,
    in)``; biases as they are."""
    out = {}
    for name, w in params.items():
        if name.startswith("conv") and name.endswith("_w"):
            w = w.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        elif name.startswith(("stft_", "dense")) and w.ndim == 2:
            w = w.T
        out[name] = np.ascontiguousarray(w, dtype=np.float32)
    return out


def main(src: str, dst: str) -> None:
    import torch

    state_dict = torch.load(src, map_location="cpu", weights_only=True)
    params = convert_state_dict(state_dict)
    np.savez(dst, **params)
    total = sum(v.size for v in params.values())
    print(f"wrote {dst}: {len(params)} tensors, {total} parameters")


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])

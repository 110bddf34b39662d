"""fast_speech_enhancement_metrics_tpu_torch: the metrics on PyTorch and CUDA.

The PyTorch/CUDA port of ``fast_speech_enhancement_metrics_tpu`` for NVIDIA
Hopper (H100). Each metric class is callable as
``metric(clean, denoised) -> list[dict[str, float]]`` and runs on
``torch.device("cuda")`` unless given another ``device``. Every kernel the
JAX package wrote in Pallas for the TPU is, on the ported paths, a CUDA
kernel under ``csrc/``, built by ``nvcc`` at first use; each keeps a plain
PyTorch version beside it, which CPU tensors take.

All six metrics are ported: LSD, SDR, STOI/ESTOI, PESQ, DNSMOS and
SpeechBERTScore. PESQ and DNSMOS have no hand kernel (the JAX package has no
Pallas kernel on their paths): their filters, DFTs and convolutions are
float32 cuBLAS / cuDNN calls with TF32 off.
"""

from fast_speech_enhancement_metrics_tpu_torch.base import BaseMetric
from fast_speech_enhancement_metrics_tpu_torch.metrics.dnsmos import DNSMOS
from fast_speech_enhancement_metrics_tpu_torch.metrics.lsd import LSD
from fast_speech_enhancement_metrics_tpu_torch.metrics.pesq import PESQ
from fast_speech_enhancement_metrics_tpu_torch.metrics.sdr import SDR
from fast_speech_enhancement_metrics_tpu_torch.metrics.speechbertscore import SpeechBERTScore
from fast_speech_enhancement_metrics_tpu_torch.metrics.stoi import STOI

__all__ = ["BaseMetric", "DNSMOS", "LSD", "PESQ", "SDR", "STOI", "SpeechBERTScore"]

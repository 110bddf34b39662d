"""PyTorch port, SNR monotonicity: every DSP metric of the port on the CPU
scores +10 dB SNR mixtures better than -5 dB mixtures, in the direction of
``higher_is_better``, on the fixtures of ``tests/test_high_vs_low_snr.py``.
"""

import numpy as np
import pytest

from fast_speech_enhancement_metrics_tpu_torch import LSD, PESQ, SDR, STOI

METRICS = [PESQ, STOI, SDR, LSD]


@pytest.mark.parametrize("metric_cls", METRICS)
def test_high_vs_low_snr(metric_cls, high_snr_speech_data, low_snr_speech_data):
    metric = metric_cls(device="cpu")
    high = metric(high_snr_speech_data["speech"], high_snr_speech_data["noisy_speech"])
    low = metric(low_snr_speech_data["speech"], low_snr_speech_data["noisy_speech"])
    for key in high[0]:
        high_mean = np.mean([r[key] for r in high])
        low_mean = np.mean([r[key] for r in low])
        if metric.higher_is_better:
            assert high_mean > low_mean, key
        else:
            assert high_mean < low_mean, key

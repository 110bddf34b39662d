"""The systems under test, one module per configuration's ``system``."""

from __future__ import annotations

import torch


def allow_tf32() -> None:
    """A control: TF32 on in the program's float32 matmuls and cuDNN convs,
    the step below float32 with TF32 off, for the rest of the process. The
    program fixes its conv flags in ``models.hubert._conv_flags`` (which
    ``models.dnsmos_net`` imports); both names are replaced here."""
    from fast_speech_enhancement_metrics_tpu_torch.models import dnsmos_net, hubert

    def flags():
        return torch.backends.cudnn.flags(enabled=True, allow_tf32=True)

    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    hubert._conv_flags = dnsmos_net._conv_flags = flags

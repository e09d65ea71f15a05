"""Device resolution (counterpart of paddle_tpu/core/device.py).

The reference resolves a Place to a jax.Device and quietly lands on the CPU
when no accelerator is present.  The port does not: its entry points run on
``cuda`` unless the caller asks for the CPU, and asking for CUDA on a machine
without it is an error — a serving run that silently fell back to the CPU
would report CPU numbers as the card's.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raises when CUDA is absent); ``"cpu"`` -> CPU;
    ``"cuda"``/``"cuda:N"``/``"gpu"``/``torch.device`` as given.  Raises
    RuntimeError when CUDA is requested (explicitly or by default) and
    ``torch.cuda.is_available()`` is False."""
    if isinstance(device, str) and device.split(":")[0] == "gpu":
        device = "cuda" + device[3:]
    try:
        dev = torch.device("cuda" if device is None else device)
    except RuntimeError as e:
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'") from e
    if dev.type == "cuda" and not torch.cuda.is_available():
        hint = (" (no device was given, and the default is cuda; pass "
                "device='cpu' to run on the CPU)" if device is None else "")
        raise RuntimeError(f"CUDA device requested but torch.cuda.is_available() "
                           f"is False{hint}")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    return dev

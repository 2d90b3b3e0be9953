"""Which version of a kernel a wrapper runs.

A tensor on the CPU takes the kernel's plain PyTorch version; a tensor on
the card takes the CUDA kernel, which launches or raises. There is no
fallback, and no switch: the device of the tensor decides alone.
"""

from __future__ import annotations

import torch


def takes_kernel(t: torch.Tensor) -> bool:
    """True for a tensor on the card, False for one on the CPU."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {t.device}")
    return True


def check_same_device(*tensors: torch.Tensor) -> None:
    """Raise unless every operand of a kernel lies on one device: a
    kernel dereferences each pointer on the card it runs on."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"kernel operands lie on several devices: "
                         f"{sorted(map(str, devices))}")

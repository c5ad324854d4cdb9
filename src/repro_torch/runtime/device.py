"""Device resolution for every entry point of the port.

Entry points run on the card unless the caller asks for the CPU: ``None``
means ``"cuda"``, and a CUDA device with no card raises.  Nothing falls back
to the CPU quietly.  The one exception is the dry world
(``roofline/dry.py::dry_world``), where every tensor is a fake: there the
card is its stand-in device, with no card present.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.roofline import dry

__all__ = ["resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dry.active():
        return dry.stand_in_device()
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is available; "
            "pass device='cpu' to run the plain PyTorch path on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev

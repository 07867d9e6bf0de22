"""The port's device rule.

``device=None`` means the card: ``torch.device("cuda")``, with the
current device's index. Without CUDA that raises; the port never falls back to the CPU on its own. Callers
that want the CPU (the tests) pass ``device="cpu"``.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device to run on, a CUDA one with its index: tensors report
    an indexed device, and ``torch.device("cuda")`` does not compare
    equal to ``torch.device("cuda:0")``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: pass device='cpu' to run the "
                "port on the CPU"
            )
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device

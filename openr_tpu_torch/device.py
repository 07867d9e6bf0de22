"""The port's device rule.

``device=None`` means the card: ``torch.device("cuda")``. Without CUDA
that raises; the port never falls back to the CPU on its own. Callers
that want the CPU (the tests) pass ``device="cpu"``.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: pass device='cpu' to run the "
                "port on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)

"""Host-to-device copies through one pinned host buffer, and deferred
device-to-host copies into pinned host memory.

The resident state of a route build (the dense snapshot's metric rows,
the sliced-ELL bands and their patched rows, the warm solve's increase
edges, the source batch, the KSP2 edge masks) crosses to the card through
an ``UploadStager``: one pinned buffer, each upload one ``non_blocking``
copy on the current stream, where a copy from pageable numpy memory
would be bounced by CUDA through a buffer of its own. A ``Readback``
is the way back: one ``non_blocking`` copy into pinned host memory that
the caller reaps when it needs the bytes.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from openr_tpu_torch.ops import dispatch_accounting as da


class UploadStager:
    """Host-to-device copies of int32 arrays through one pinned host
    buffer, issued ``non_blocking`` on the current stream.

    ``upload`` packs its arrays into the buffer (each at a 16-byte
    boundary) and copies them in one transfer; before it writes the
    buffer it waits for the previous copy out of it to land, so a copy
    never reads bytes that were overwritten. ``bytes`` counts what was
    uploaded, by the kind each array was given. On a CPU device each
    array is copied into a fresh tensor, never aliasing the numpy
    array."""

    _ALIGN = 4  # int32 elements

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self._buf: Optional[torch.Tensor] = None
        self._landed = None
        self.bytes: Dict[str, int] = {}

    def upload(self, items: Sequence[Tuple[str, np.ndarray]]) -> List[torch.Tensor]:
        arrays = [np.ascontiguousarray(a, dtype=np.int32) for _, a in items]
        for (kind, _), a in zip(items, arrays):
            self.bytes[kind] = self.bytes.get(kind, 0) + a.nbytes
        if self.device.type != "cuda":
            return [torch.from_numpy(a.copy()).to(self.device) for a in arrays]
        offsets = []
        total = 0
        for a in arrays:
            offsets.append(total)
            total += -(-a.size // self._ALIGN) * self._ALIGN
        if self._landed is not None:
            self._landed.synchronize()
        if self._buf is None or self._buf.numel() < total:
            size = max(total, 2 * (0 if self._buf is None else self._buf.numel()))
            self._buf = torch.empty(max(size, 1), dtype=torch.int32, pin_memory=True)
        host = self._buf.numpy()
        for a, off in zip(arrays, offsets):
            host[off : off + a.size] = a.reshape(-1)
        dev = self._buf[: max(total, 1)].to(self.device, non_blocking=True)
        self._landed = torch.cuda.Event()
        self._landed.record(torch.cuda.current_stream(self.device))
        return [dev[off : off + a.size].view(a.shape) for a, off in zip(arrays, offsets)]


class Readback:
    """A device-to-host copy of one tensor, in flight until reaped.

    On a CUDA device the copy goes ``non_blocking`` into a fresh pinned
    host tensor on the current stream, and an event marks its end: the
    host goes on (tracing, a next dispatch) while it lands, and ``reap``
    waits for the event. A pageable destination would make CUDA bounce
    the bytes through a buffer of its own. On a CPU device the tensor is
    copied at once. ``tensor`` stays the device tensor, for consumers
    that chain further device work off it."""

    def __init__(self, tensor: torch.Tensor):
        self.tensor = tensor
        self._done = None
        if tensor.device.type == "cuda":
            self._host = torch.empty(tensor.shape, dtype=tensor.dtype, pin_memory=True)
            self._host.copy_(tensor, non_blocking=True)
            self._done = torch.cuda.Event()
            self._done.record(torch.cuda.current_stream(tensor.device))
        else:
            self._host = tensor.detach().clone()

    def reap(self) -> np.ndarray:
        """The host copy as a numpy array, once it has landed. The array
        shares the pinned tensor's memory and keeps it alive. Counted as
        one blocking sync (``ops.blocking_syncs``)."""
        da.note_blocking_sync()
        if self._done is not None:
            self._done.synchronize()
            self._done = None
        return self._host.numpy()

"""Hand-written CUDA kernels of the port, and their launch counts.

``LAUNCHES[name]`` goes up by one each time a wrapper launches kernel
``name`` on the card, and nowhere else: a plain version run on CPU
tensors does not count. ``chip_smoke.py`` zeroes the counts before a
route build or a route sweep and reads them after, to show the main
path went through the kernels. ``note_launch`` is the one place a wrapper
counts a launch: it also counts one ``ops.host_dispatches`` in the
dispatch accounting (``ops/dispatch_accounting.py``). A launch made while a
CUDA graph is being captured (``ops/aot_cache.py``) runs nothing yet: it
goes to the capture's tally, and every replay of the graph adds the tally
(``add_replayed``).
"""

from __future__ import annotations

from typing import Dict

from openr_tpu_torch.ops import dispatch_accounting

LAUNCHES: Dict[str, int] = {
    "minplus": 0,
    "ell_band_relax": 0,
    "ell_band_relax_masked": 0,
    "ell_live_slots": 0,
    "rev_band_relax": 0,
    "batched_minplus": 0,
    "batched_minplus_t": 0,
}


def note_launch(name: str) -> None:
    """Count one launch of kernel ``name`` on the card (into the capture's
    tally while a graph is being captured)."""
    tally = dispatch_accounting.current_capture()
    if tally is not None:
        tally.launches[name] = tally.launches.get(name, 0) + 1
    else:
        LAUNCHES[name] += 1
    dispatch_accounting.count_dispatch()


def add_replayed(launches: Dict[str, int]) -> None:
    """Count the launches one replay of a captured graph made."""
    for name, n in launches.items():
        LAUNCHES[name] += n


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0

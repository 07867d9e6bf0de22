"""Measured per-shape selection among the hand kernels' launch plans.

Port note: the counterpart of ``openr_tpu/ops/autotune.py``. The
reference picks, per ``(platform, kernel, shape)``, between its XLA
formulation and its Pallas kernel. On the card the port's candidates are
hand kernels only: each kernel's launch plans (``minplus.minplus_plan``,
``ell_relax.launch_plan``, ``rev_relax.launch_plan``) under
the named variants of ``_FAMILY_CANDIDATES``, and for ``grouped_minplus``
its two kernels, ``batched_minplus`` and ``batched_minplus_t``. A torch-op
formulation is never a candidate on the card: the plain version
(``"plain"``) is one only for CPU tensors.

``impl="auto"`` resolves, before a cache key is formed, to the winner for
the dispatch's shape: measured once (CUDA events, one warm-up, the best of
``reps``; never inside a capture of the executable cache), memoized in the
process and persisted as JSON under ``aot_cache.cache_dir()``
(``OPENR_CACHE_DIR``) in ``autotune_torch.json``, keyed on the card's name.
The reference's ``autotune.json`` may sit in the same directory; it is
never read or written here. The winner reaches the kernel wrappers through
``using(family, variant)``, a thread-local the wrappers read with
``current_variant``; a dispatch's tag carries the winner (``tag@variant``),
so ``"auto"`` never appears in a cache key.

The measurer is injectable (``Autotuner(measure=...)``) so tests drive
deterministic winner selection without timing noise.
"""

from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager
from typing import Callable, Dict, Iterator, Optional, Tuple

import torch

from openr_tpu_torch.ops import dispatch_accounting as da
from openr_tpu_torch.ops.aot_cache import cache_dir
from openr_tpu_torch.telemetry import get_registry

_PERSIST_FILE = "autotune_torch.json"

# kernel family -> legal winner names. "plan" is each kernel's heuristic
# launch plan (what runs without "auto"); "plain", the plain torch
# version, is legal only on the CPU. Persistence is keyed on the family
# and every loaded entry is validated against it: unknown families and
# out-of-family winners are dropped on load (re-measured), never fatal.
_FAMILY_CANDIDATES = {
    # k_warps forced to 1/2/4 (the split rule as the plan's), or K unsplit
    "minplus": ("plan", "warps1", "warps2", "warps4", "nosplit", "plain"),
    # runX: the run of batch rows a block walks (rev_band_relax);
    # threadsX: a wide band row's threads (ell_band_relax). The masked
    # relax, measured under none of them, keeps its own plan.
    "ell_relax": ("plan", "run1", "run4", "run16", "threads32", "threads256",
                  "plain"),
    "grouped_minplus": ("batched_minplus", "batched_minplus_t", "plain"),
}
_DEFAULT = {"minplus": "plan", "ell_relax": "plan",
            "grouped_minplus": "batched_minplus"}

_SCHEMA_VERSION = 1

_TLS = threading.local()


def current_variant(family: str) -> str:
    """The variant a kernel wrapper of ``family`` launches on this thread
    (the family's default outside ``using``)."""
    got = getattr(_TLS, family, None)
    return _DEFAULT[family] if got is None else got


@contextmanager
def using(family: str, variant: str) -> Iterator[None]:
    """Launch ``family``'s kernels as ``variant`` inside the block."""
    if variant not in _FAMILY_CANDIDATES[family]:
        raise ValueError(f"autotune: {variant!r} is not a {family} candidate")
    prev = getattr(_TLS, family, None)
    setattr(_TLS, family, variant)
    try:
        yield
    finally:
        setattr(_TLS, family, prev)


def platform_name(device) -> str:
    """The persistence key's platform: the card's name, or ``cpu``."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return dev.type


def _valid_entry(key: str, entry) -> Optional[Tuple[str, str]]:
    """(family, winner) when the persisted entry is adoptable, else None.
    Keys are ``platform:family:shape``; an entry's ``family`` field must
    agree with the key, and ``plain`` is adoptable only for ``cpu``."""
    if not isinstance(entry, dict):
        return None
    winner = entry.get("winner")
    parts = key.rsplit(":", 2)
    if len(parts) != 3 or not isinstance(winner, str):
        return None
    platform, family, _shape = parts
    if family not in _FAMILY_CANDIDATES:
        return None
    if winner not in _FAMILY_CANDIDATES[family]:
        return None
    if winner == "plain" and platform != "cpu":
        return None
    tagged = entry.get("family")
    if tagged is not None and tagged != family:
        return None
    return family, winner


def _parse_persisted(data) -> Dict[str, Dict]:
    """``{"version": 1, "winners": {...}}``; invalid or unknown entries
    are dropped (those keys re-measure)."""
    if not isinstance(data, dict):
        return {}
    winners = data.get("winners", data)
    if not isinstance(winners, dict):
        return {}
    out: Dict[str, Dict] = {}
    for key, entry in winners.items():
        ok = _valid_entry(key, entry)
        if ok is None:
            continue
        family, winner = ok
        out[key] = {"family": family, "winner": winner,
                    "ms": entry.get("ms", {})}
    return out


def _default_measure(thunk: Callable[[], None], device=None, reps: int = 3) -> float:
    """Best-of-``reps`` ms after one untimed warm-up: CUDA events on the
    current stream for a card, the host clock otherwise."""
    thunk()
    best = float("inf")
    dev = torch.device(device) if device is not None else torch.device("cpu")
    for _ in range(reps):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            thunk()
            end.record()
            end.synchronize()
            ms = float(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            thunk()
            ms = (time.perf_counter() - t0) * 1000.0
        best = min(best, ms)
    return best


class Autotuner:
    def __init__(self, measure: Optional[Callable] = None, persist: bool = True):
        self._measure = measure or _default_measure
        self._persist = persist
        self._winners: Dict[str, str] = {}
        self._timings: Dict[str, Dict[str, float]] = {}
        self._loaded = False
        self._lock = threading.Lock()

    def _path(self) -> Optional[str]:
        d = cache_dir()
        return os.path.join(d, _PERSIST_FILE) if d else None

    def _load(self) -> None:
        if self._loaded:
            return
        self._loaded = True
        path = self._path() if self._persist else None
        if path and os.path.exists(path):
            try:
                with open(path) as f:
                    data = json.load(f)
                self._winners.update({
                    k: v["winner"] for k, v in _parse_persisted(data).items()
                })
            except Exception:  # noqa: BLE001 - the cache is best-effort
                pass

    def _save(self, key: str, winner: str, timings: Dict[str, float]) -> None:
        path = self._path() if self._persist else None
        if not path:
            return
        try:
            winners = {}
            if os.path.exists(path):
                with open(path) as f:
                    winners = _parse_persisted(json.load(f))
            family = key.rsplit(":", 2)[1]
            winners[key] = {"family": family, "winner": winner, "ms": timings}
            with open(path, "w") as f:
                json.dump({"version": _SCHEMA_VERSION, "winners": winners},
                          f, indent=1, sort_keys=True)
        except Exception:  # noqa: BLE001 - the cache is best-effort
            pass

    def timings(self) -> Dict[str, Dict[str, float]]:
        """The ms of every candidate this process measured, by key."""
        with self._lock:
            return {k: dict(v) for k, v in self._timings.items()}

    def winners(self) -> Dict[str, str]:
        with self._lock:
            return dict(self._winners)

    def record(self, family: str, shape_key: str, winner: str, device,
               timings: Optional[Dict[str, float]] = None) -> None:
        """Adopt an externally measured winner, memoized and persisted as a
        ``pick`` result is."""
        if (winner not in _FAMILY_CANDIDATES.get(family, ())
                or (winner == "plain" and torch.device(device).type != "cpu")):
            raise ValueError(f"autotune: {winner!r} for {family} on {device}")
        self._load()
        key = f"{platform_name(device)}:{family}:{shape_key}"
        with self._lock:
            self._winners[key] = winner
        self._save(key, winner, timings or {})

    def pick(self, family: str, shape_key: str,
             candidates: Dict[str, Callable[[], None]], device) -> str:
        """Winner name for (platform, family, shape): memoized, then
        persisted, then measured. ``candidates`` maps names of the family
        to thunks; ``plain`` is refused for a card."""
        dev = torch.device(device)
        for name in candidates:
            if name not in _FAMILY_CANDIDATES[family]:
                raise ValueError(f"autotune: {name!r} is not a {family} candidate")
            if name == "plain" and dev.type != "cpu":
                raise ValueError("autotune: the plain version is no candidate on a card")
        if da.current_capture() is not None:
            raise RuntimeError("autotune: no measurement inside a capture")
        self._load()
        key = f"{platform_name(dev)}:{family}:{shape_key}"
        with self._lock:
            got = self._winners.get(key)
        if got in candidates:
            return got
        reg = get_registry()
        timings: Dict[str, float] = {}
        for name, thunk in candidates.items():
            try:
                timings[name] = float(self._measure(thunk, dev))
            except Exception:  # noqa: BLE001 - a disqualified candidate
                reg.counter_bump("ops.autotune_disqualified")
        winner = min(timings, key=timings.get) if timings else next(iter(candidates))
        with self._lock:
            self._winners[key] = winner
            self._timings[key] = timings
        self._save(key, winner, timings)
        reg.counter_bump("ops.autotune_measurements")
        return winner


_TUNER = Autotuner()


def get_autotuner() -> Autotuner:
    return _TUNER


def set_autotuner(tuner: Autotuner) -> None:
    global _TUNER
    _TUNER = tuner


def _candidates(family: str, device) -> Tuple[str, ...]:
    names = _FAMILY_CANDIDATES[family]
    if torch.device(device).type == "cpu":
        return names
    return tuple(n for n in names if n != "plain")


def _probe_fill(shape, device) -> torch.Tensor:
    from openr_tpu_torch.ops.minplus import INF

    return torch.full(shape, INF // 2, dtype=torch.int32, device=device)


def resolve_minplus(shape: Tuple[int, ...], device) -> str:
    """The measured winner for the dense min-plus contraction at this
    ``[S, N] x [N, N]`` shape (``spf``'s loops call this when the impl is
    "auto")."""
    from openr_tpu_torch.ops.minplus import minplus, minplus_plain

    s, n = int(shape[0]), int(shape[-1])
    a = _probe_fill((s, n), device)
    b = _probe_fill((n, n), device)

    def thunk(name):
        if name == "plain":
            return lambda: minplus_plain(a, b)

        def run():
            with using("minplus", name):
                minplus(a, b)

        return run

    return _TUNER.pick("minplus", f"{s}x{n}",
                       {c: thunk(c) for c in _candidates("minplus", device)}, device)


def resolve_grouped(shape: Tuple[int, int, int, int], device) -> str:
    """The measured winner between the two grouped contraction kernels
    for one representative ``[B, G, S] x [G, S, R]`` block."""
    from openr_tpu_torch.ops import grouped_minplus as gm

    b, g, s, r = (int(x) for x in shape)
    gath = _probe_fill((g, b, s), device)
    gath_t = _probe_fill((g, s, b), device)
    w = _probe_fill((g, s, r), device)
    runs = {
        "batched_minplus": lambda: gm.batched_minplus(gath, w),
        "batched_minplus_t": lambda: gm.batched_minplus_t(gath_t, w),
        "plain": lambda: gm.batched_minplus_plain(gath, w),
    }
    return _TUNER.pick(
        "grouped_minplus", f"{b}x{g}x{s}x{r}",
        {c: runs[c] for c in _candidates("grouped_minplus", device)}, device,
    )


# batch rows of the sliced-ELL probe: enough that a run length matters
_ELL_PROBE_ROWS = 256


def resolve_ell_relax(shape: Tuple[int, int], device) -> str:
    """The measured winner for the sliced-ELL relaxes at this
    ``(n_pad, k_slot)`` band geometry: one step of ``ell_band_relax`` and
    one of ``rev_band_relax`` over a synthetic band of ``n_pad`` rows and
    ``k`` slots at 256 batch rows. The batch extent is left out of the key,
    as the reference leaves it out: it varies by dispatch while the band
    geometry does not."""
    from openr_tpu_torch.ops.ell_relax import ell_band_relax, ell_band_relax_plain
    from openr_tpu_torch.ops.rev_relax import rev_band_relax, rev_band_relax_plain

    n, k = (int(x) for x in shape)
    d = _probe_fill((_ELL_PROBE_ROWS, n), device)
    src = torch.zeros((n, k), dtype=torch.int32, device=device)
    w = _probe_fill((n, k), device)
    ov = torch.zeros((n,), dtype=torch.bool, device=device)
    t_ids = torch.zeros((_ELL_PROBE_ROWS,), dtype=torch.int32, device=device)
    out = torch.empty_like(d)

    def thunk(name):
        if name == "plain":
            def plain():
                ell_band_relax_plain(d, src, w, ov, 0)
                rev_band_relax_plain(d, src, w, t_ids, ov, 0)
            return plain

        def run():
            with using("ell_relax", name):
                ell_band_relax(d, src, w, ov, 0, out=out)
                rev_band_relax(d, src, w, t_ids, ov, 0, out=out)

        return run

    return _TUNER.pick("ell_relax", f"{n}x{k}",
                       {c: thunk(c) for c in _candidates("ell_relax", device)}, device)

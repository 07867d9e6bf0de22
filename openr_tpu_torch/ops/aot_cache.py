"""The committed executable cache: a warm dispatch replays a captured CUDA
graph.

Port note: the counterpart of ``openr_tpu/ops/aot_cache.py``. Where the
reference lowers and compiles a jitted body once per shape key and then
calls the compiled executable, the port captures the body's kernel
launches and torch ops once per key into a ``torch.cuda.CUDAGraph`` and
replays it: a hit costs the copy of the per-event inputs, one graph launch
and the copy of the outputs, with no Python walk of the body.

Keying: ``(tag, sorted statics, signature)``, the signature being the
nesting of the dynamic arguments and each leaf's shape, dtype and device
(a Python scalar leaf by its value). The statics are baked into the
capture; the dynamic tensors are read from the shared input buffers.

On the card a miss warms the body up eagerly on a side stream (the kernel
library's lazy ``nvcc`` build and load, the autotuner's measurements), then
captures it (``capture_error_mode="thread_local"``, so another thread's
launches do not break it) into one memory pool that every graph of the
device shares (``torch.cuda.graph_pool_handle()``), ending the capture
with a copy of the body's outputs into shared output buffers, then replays
it. A hit copies each dynamic tensor into its input buffer (skipped when
the caller passed that buffer), replays, and returns COPIES of the output
buffers: a replay rewrites them, so two replays would otherwise hand out
the same storage, and the route engine's invariants (nothing resident
changed in place before an event commits; the retry ladder re-dispatches
against an untouched ``DR``; a speculation valid only while ``self._dr is
spec.dr_ref``) rest on fresh tensors.

Buffers are shared, not a key's own: one input and one output buffer for
each shape, dtype and device and each repeat of that signature among a
body's leaves, so a 10 000-node engine's keys all read their ``DR`` from
one 10112 x 10112 buffer and write it into another. A key pins no tensor:
the body's own outputs are dropped after the capture, so the pool's memory
serves the next capture, and graphs of the pool reuse each other's memory.
That is safe because nothing of the pool outlives a replay (its outputs
are copied out before the next replay starts), replays and captures run
one at a time (one lock), and each replay's stream waits for the previous
replay's copy-out (an event), whichever thread's stream that ran on.

The map is a least-recently-used one, bounded by keys and by the bytes of
its shared buffers (``AotDispatchCache``): an evicted key takes with it
every buffer no remaining key reads, so the shapes of a superseded layout
go as their keys age out.

On the CPU there is no graph: the cache keeps the same key table, bounds,
counters and shared buffers, and runs the body eagerly into the output
buffers, returning copies of them, so the CPU tests exercise the keying,
the eviction, the counters and the aliasing rule.

A body is captured inside ``dispatch_accounting.capturing()``: its kernel
launches go to the capture's tally and are added to ``kernels.LAUNCHES`` and
``ops.host_dispatches`` on every replay, and a host sync inside it raises
(on the CPU too, where nothing else would notice). A key whose capture
raises is poisoned and the call runs the same body eagerly, as the
reference's fallback does: it launches the same hand kernels.

Counters: ``ops.aot_compiles`` (captures), ``ops.aot_hits``,
``ops.aot_fallbacks``, ``ops.aot_evictions``; every call counts one
``count_dispatch``. Inside ``direct()`` a call runs its body eagerly and
touches none of them (the comparison of a cached run with the bodies
called directly).
"""

from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch

from openr_tpu_torch.ops import dispatch_accounting as da
from openr_tpu_torch.telemetry import get_registry
from openr_tpu_torch.telemetry.profiler import get_profiler

_UNCAPTURABLE = object()  # poison marker: the capture raised once

# one replay (copy in, replay, copy out) or capture at a time: the keys
# share their buffers and the graph pool
_REPLAY_LOCK = threading.RLock()

_TLS = threading.local()


@contextmanager
def direct() -> Iterator[None]:
    """Call every body eagerly inside the block (this thread only)."""
    prev = getattr(_TLS, "direct", False)
    _TLS.direct = True
    try:
        yield
    finally:
        _TLS.direct = prev


def _first_device(leaves: List[torch.Tensor]) -> Optional[torch.device]:
    return leaves[0].device if leaves else None


def _profiled(tag: str, thunk, device=None):
    """Run one dispatch under device-time attribution: host wall time
    always, the device time at the profiler's sampling cadence (two CUDA
    events on the current stream), both folded into the active event
    window's stage table. A disabled profiler is the bare call."""
    prof = get_profiler()
    if not prof.enabled:
        return thunk()
    with prof.annotate(tag):
        start = prof.start(tag, device)
        t0 = time.perf_counter()
        out = thunk()
        host_ms = (time.perf_counter() - t0) * 1000.0
    device_ms = prof.on_dispatch(tag, out, host_ms, start=start)
    da.attribute_stage(tag, host_ms, device_ms)
    return out


def cache_dir() -> Optional[str]:
    """Directory the persistent artifacts (the autotuner's winners) live
    in. None when ``OPENR_CACHE_DIR`` is unset: in memory only, no disk
    writes."""
    d = os.environ.get("OPENR_CACHE_DIR")
    if not d:
        return None
    os.makedirs(d, exist_ok=True)
    return d


def _flatten(x: Any, leaves: List[torch.Tensor]) -> Any:
    """The nesting of ``x`` with every tensor replaced by a marker and
    appended to ``leaves`` (tuples and lists nest; anything else is a
    constant of the spec)."""
    if isinstance(x, torch.Tensor):
        leaves.append(x)
        return "T"
    if isinstance(x, (tuple, list)) and not hasattr(x, "_fields"):
        return (type(x).__name__, tuple(_flatten(e, leaves) for e in x))
    return ("C", x)


def _unflatten(spec: Any, it) -> Any:
    if spec == "T":
        return next(it)
    kind, body = spec
    if kind == "C":
        return body
    items = [_unflatten(e, it) for e in body]
    return tuple(items) if kind == "tuple" else items


def _leaf_sig(t: torch.Tensor) -> Tuple:
    return (tuple(t.shape), str(t.dtype), str(t.device))


def signature(dyn_args: Tuple) -> Tuple:
    """The nesting of the dynamic arguments and each tensor leaf's shape,
    dtype and device."""
    leaves: List[torch.Tensor] = []
    spec = _flatten(tuple(dyn_args), leaves)
    return (spec, tuple(_leaf_sig(t) for t in leaves))


class _Executable:
    """One key's capture: the shared input and output buffers it reads and
    writes, the graph (None on the CPU) and the launches the capture
    saw."""

    __slots__ = ("tag", "spec", "inputs", "in_keys", "graph", "fn", "statics",
                 "out_spec", "outputs", "out_keys", "launches", "dispatches",
                 "device")

    def __init__(self, tag, spec, inputs, in_keys, fn, statics, device):
        self.tag = tag
        self.spec = spec
        self.inputs = inputs
        self.in_keys = in_keys
        self.graph = None
        self.fn = fn
        self.statics = statics
        self.out_spec = None
        self.outputs: List[torch.Tensor] = []
        self.out_keys: List[Tuple] = []
        self.launches: Dict[str, int] = {}
        self.dispatches = 0
        self.device = device

    def _args(self):
        return _unflatten(self.spec, iter(self.inputs))


def _buffer_keys(leaves: List[torch.Tensor]) -> List[Tuple]:
    """``(signature, repeat)`` of each leaf: the n-th leaf of one shape,
    dtype and device among a body's inputs (or outputs) takes the n-th
    shared buffer of that signature."""
    seen: Dict[Tuple, int] = {}
    keys = []
    for t in leaves:
        sig = _leaf_sig(t)
        rep = seen.get(sig, 0)
        seen[sig] = rep + 1
        keys.append((sig, rep))
    return keys


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


# the executable cache's bounds: keys, and bytes of shared buffers (a
# 10 000-node engine's keys number about 100 and share about 1 GB)
MAX_ENTRIES = 256
MAX_BYTES = 4 << 30


class AotDispatchCache:
    """Process-global (tag, statics, signature) -> captured graph map,
    least recently used first out.

    A key pins no tensor of its own: its bodies read shared input buffers
    and write shared output buffers, one for each leaf signature (and
    repeat), so a 10 000-node engine's keys all write their ``DR`` into one
    10112 x 10112 buffer. The map is bounded: past ``max_entries`` keys, or
    past ``max_bytes`` of shared buffers, the least recently used keys go
    (``ops.aot_evictions``), and with them every buffer no remaining key
    reads (a superseded layout's shapes), and a device's graph pool once
    it has no key left."""

    def __init__(self, max_entries: int = MAX_ENTRIES,
                 max_bytes: int = MAX_BYTES) -> None:
        self.max_entries = max_entries
        self.max_bytes = max_bytes
        self._exes: "OrderedDict[Tuple, Any]" = OrderedDict()
        self._lock = threading.Lock()
        # (shape, dtype, device) and repeat -> the buffer every key of that
        # leaf signature reads (inputs) or writes (outputs), with the
        # number of keys that use it
        self._inputs: Dict[Tuple, torch.Tensor] = {}
        self._outputs: Dict[Tuple, torch.Tensor] = {}
        self._refs: Dict[Tuple, int] = {}
        self._pools: Dict[str, Any] = {}
        # device -> the event the last replay's copy-out recorded: the
        # next replay's stream waits on it (keys share buffers and pool)
        self._tail: Dict[str, Any] = {}
        self._pool_bytes: Dict[str, int] = {}
        # tag -> [replays, bytes copied in, bytes copied out]
        self._copies: Dict[str, List[int]] = {}
        # tag -> the exception of its last poisoned capture
        self._poisoned: Dict[str, str] = {}

    def stats(self) -> Dict[str, Any]:
        """Entries and the counters; the bytes of the shared input and
        output buffers (``input_bytes``, ``output_bytes``), the growth of
        the device's reserved memory over the captures (``pool_bytes``:
        the graph pools and what the warm-ups left cached), by tag the
        bytes a replay copies in and out on average (``copies``), and, by
        tag, why a capture was poisoned."""
        reg = get_registry()
        with self._lock:
            copies = {
                tag: {"replays": r, "in_bytes": i // max(r, 1), "out_bytes": o // max(r, 1)}
                for tag, (r, i, o) in self._copies.items()
            }
            return {
                "entries": len(self._exes),
                "compiles": int(reg.counter_get("ops.aot_compiles")),
                "hits": int(reg.counter_get("ops.aot_hits")),
                "fallbacks": int(reg.counter_get("ops.aot_fallbacks")),
                "evictions": int(reg.counter_get("ops.aot_evictions")),
                "pool_bytes": sum(self._pool_bytes.values()),
                "input_bytes": sum(_nbytes(t) for t in self._inputs.values()),
                "output_bytes": sum(_nbytes(t) for t in self._outputs.values()),
                "copies": copies,
                "poisoned": dict(self._poisoned),
            }

    def clear(self) -> None:
        """Drop every key, its graph and buffers (their memory goes back to
        the allocator once no caller holds a result)."""
        with self._lock:
            self._exes.clear()
            self._poisoned.clear()
            self._inputs.clear()
            self._outputs.clear()
            self._refs.clear()
            self._pools.clear()
            self._tail.clear()
            self._pool_bytes.clear()
            self._copies.clear()

    # -- buffers and bounds ------------------------------------------------

    def _buffer_bytes(self) -> int:
        return (sum(_nbytes(t) for t in self._inputs.values())
                + sum(_nbytes(t) for t in self._outputs.values()))

    def _shared(self, table, kind, leaves, keys) -> List[torch.Tensor]:
        """The shared buffers of ``kind`` for these leaves (made on first
        use, outside any capture), each referenced once more."""
        out = []
        with self._lock:
            for t, bk in zip(leaves, keys):
                buf = table.get(bk)
                if buf is None:
                    buf = table[bk] = torch.empty_like(
                        t, memory_format=torch.contiguous_format)
                self._refs[(kind, bk)] = self._refs.get((kind, bk), 0) + 1
                out.append(buf)
        return out

    def _release(self, exe: "_Executable") -> None:
        """Drop ``exe``'s references; a buffer no key reads goes (caller
        holds the lock)."""
        for kind, table, keys in (("in", self._inputs, exe.in_keys),
                                  ("out", self._outputs, exe.out_keys)):
            for bk in keys:
                left = self._refs.get((kind, bk), 0) - 1
                if left <= 0:
                    self._refs.pop((kind, bk), None)
                    table.pop(bk, None)
                else:
                    self._refs[(kind, bk)] = left

    def _insert(self, key, exe: "_Executable") -> None:
        """Add ``exe`` as the most recently used key, then evict the least
        recently used keys while a bound is passed (never the new one)."""
        evicted = 0
        with self._lock:
            self._exes[key] = exe
            self._exes.move_to_end(key)
            while len(self._exes) > 1 and (
                len(self._exes) > self.max_entries
                or self._buffer_bytes() > self.max_bytes
            ):
                _old, gone = self._exes.popitem(last=False)
                evicted += 1
                if isinstance(gone, _Executable):
                    self._release(gone)
            live = {str(e.device) for e in self._exes.values()
                    if isinstance(e, _Executable)}
            for name in [d for d in self._pools if d not in live]:
                self._pools.pop(name)
                self._tail.pop(name, None)
                self._pool_bytes.pop(name, None)
        if evicted:
            get_registry().counter_bump("ops.aot_evictions", evicted)

    def _pool(self, device: torch.device):
        name = str(device)
        if name not in self._pools:
            self._pools[name] = torch.cuda.graph_pool_handle()
        return self._pools[name]

    # -- running -----------------------------------------------------------

    def _copy_in(self, exe: "_Executable", leaves: List[torch.Tensor]) -> int:
        moved = 0
        for buf, x in zip(exe.inputs, leaves):
            if x.data_ptr() != buf.data_ptr():
                buf.copy_(x)
                moved += _nbytes(buf)
        return moved

    def _order(self, device) -> None:
        """Make the current stream wait for the last replay on ``device``
        (another thread's stream may still be reading the shared
        buffers)."""
        ev = self._tail.get(str(device))
        if ev is not None:
            torch.cuda.current_stream(device).wait_event(ev)

    def _mark(self, device) -> None:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(device))
        self._tail[str(device)] = ev

    def _run_eager(self, exe: "_Executable") -> None:
        """The CPU's stand-in for a replay: the body into the shared
        output buffers, its launches counted as a capture's are."""
        with da.capturing() as tally:
            out = exe.fn(*exe._args(), **exe.statics)
        exe.launches = dict(tally.launches)
        exe.dispatches = tally.dispatches
        leaves: List[torch.Tensor] = []
        exe.out_spec = _flatten(out, leaves)
        if not exe.out_keys:
            exe.out_keys = _buffer_keys(leaves)
            exe.outputs = self._shared(self._outputs, "out", leaves, exe.out_keys)
        for buf, t in zip(exe.outputs, leaves):
            buf.copy_(t)

    def _run(self, exe: "_Executable", leaves: List[torch.Tensor]):
        """Copy in, replay (the CPU: run eagerly), and return copies of the
        outputs: a replay rewrites the shared outputs, so nothing handed
        out may be one of them."""
        from openr_tpu_torch.kernels import add_replayed

        cuda = exe.graph is not None
        with _REPLAY_LOCK:
            if cuda:
                self._order(exe.device)
            moved = self._copy_in(exe, leaves)
            if cuda:
                exe.graph.replay()
            else:
                self._run_eager(exe)
            out = [t.clone() for t in exe.outputs]
            if cuda:
                self._mark(exe.device)
        with self._lock:
            c = self._copies.setdefault(exe.tag, [0, 0, 0])
            c[0] += 1
            c[1] += moved
            c[2] += sum(_nbytes(t) for t in out)
        if exe.dispatches:
            da.count_dispatch(exe.dispatches)
        add_replayed(exe.launches)
        return _unflatten(exe.out_spec, iter(out))

    def _lookup(self, tag: str, dyn_args: Tuple, statics: Dict[str, Any]):
        leaves: List[torch.Tensor] = []
        spec = _flatten(tuple(dyn_args), leaves)
        try:
            key = (tag, tuple(sorted(statics.items())),
                   (spec, tuple(_leaf_sig(t) for t in leaves)))
            hash(key)
        except TypeError:
            return None, None, spec, leaves  # unhashable statics: eager
        with self._lock:
            exe = self._exes.get(key)
            if exe is not None:
                self._exes.move_to_end(key)
        return key, exe, spec, leaves

    def _new(self, tag, fn, spec, leaves, statics) -> "_Executable":
        in_keys = _buffer_keys(leaves)
        inputs = self._shared(self._inputs, "in", leaves, in_keys)
        return _Executable(tag, spec, inputs, in_keys, fn, statics,
                           _first_device(leaves))

    def _capture(self, exe: "_Executable", leaves) -> None:
        """On the card: a warm-up on a side stream, then the capture of the
        body and of the copy of its outputs into the shared output buffers
        (the body's own outputs are dropped, so the pool's memory serves
        the next capture), and no replay (the caller replays)."""
        device = exe.device
        fn, statics = exe.fn, exe.statics
        with _REPLAY_LOCK:
            self._order(device)
            self._copy_in(exe, leaves)
            reserved0 = torch.cuda.memory_reserved(device)
            cur = torch.cuda.current_stream(device)
            side = torch.cuda.Stream(device)
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                warm = fn(*exe._args(), **statics)
            cur.wait_stream(side)
            warm_leaves: List[torch.Tensor] = []
            exe.out_spec = _flatten(warm, warm_leaves)
            exe.out_keys = _buffer_keys(warm_leaves)
            exe.outputs = self._shared(self._outputs, "out", warm_leaves, exe.out_keys)
            del warm, warm_leaves
            graph = torch.cuda.CUDAGraph()
            with da.capturing() as tally:
                with torch.cuda.graph(graph, pool=self._pool(device),
                                      capture_error_mode="thread_local"):
                    out = fn(*exe._args(), **statics)
                    got: List[torch.Tensor] = []
                    if _flatten(out, got) != exe.out_spec or [
                        _leaf_sig(t) for t in got
                    ] != [_leaf_sig(t) for t in exe.outputs]:
                        raise RuntimeError("capture and warm-up outputs differ")
                    for buf, t in zip(exe.outputs, got):
                        buf.copy_(t)
                    del out, got
            exe.graph = graph
            exe.launches = dict(tally.launches)
            exe.dispatches = tally.dispatches
            self._mark(device)
            grown = max(0, torch.cuda.memory_reserved(device) - reserved0)
            with self._lock:
                self._pool_bytes[str(device)] = self._pool_bytes.get(str(device), 0) + grown

    def _poison(self, key, exe, exc: BaseException) -> None:
        with self._lock:
            if exe is not None:
                self._release(exe)
            self._exes[key] = _UNCAPTURABLE
            self._poisoned[key[0]] = f"{type(exc).__name__}: {exc}"[:400]

    def _build(self, key, tag, fn, spec, leaves, statics):
        """The key's executable: on the card captured (not yet replayed)
        and kept; on the CPU returned unkept (its first run keeps it). None
        after poisoning the key."""
        exe = self._new(tag, fn, spec, leaves, statics)
        if exe.device is None or exe.device.type != "cuda":
            return exe
        try:
            self._capture(exe, leaves)
        except Exception as exc:  # noqa: BLE001 - poison + the eager body
            self._poison(key, exe, exc)
            return None
        self._insert(key, exe)
        get_registry().counter_bump("ops.aot_compiles")
        return exe

    def _first_run(self, key, exe, leaves):
        """The CPU's first run of a key, the capture's own check: a body
        that raises (a host sync inside it) poisons the key."""
        try:
            out = self._run(exe, leaves)
        except Exception as exc:  # noqa: BLE001 - poison + the eager body
            self._poison(key, exe, exc)
            return False, None
        self._insert(key, exe)
        get_registry().counter_bump("ops.aot_compiles")
        return True, out

    def call(self, tag: str, fn, dyn_args: Tuple, statics: Dict[str, Any]):
        """Dispatch ``fn(*dyn_args, **statics)`` through the captured
        graph of this key, capturing it on the first miss."""
        reg = get_registry()
        da.count_dispatch()
        if getattr(_TLS, "direct", False):
            return fn(*dyn_args, **statics)
        key, exe, spec, leaves = self._lookup(tag, dyn_args, statics)
        device = _first_device(leaves)
        if key is not None and exe is not None and exe is not _UNCAPTURABLE:
            reg.counter_bump("ops.aot_hits")
            return _profiled(tag, lambda: self._run(exe, leaves), device)
        if key is not None and exe is None:
            exe = self._build(key, tag, fn, spec, leaves, statics)
            if exe is not None and exe.graph is not None:
                return _profiled(tag, lambda: self._run(exe, leaves), device)
            if exe is not None:
                ok, out = _profiled(tag, lambda: self._first_run(key, exe, leaves), device)
                if ok:
                    return out
        reg.counter_bump("ops.aot_fallbacks")
        return _profiled(tag, lambda: fn(*dyn_args, **statics), device)

    def warm(self, tag: str, fn, dyn_args: Tuple,
             statics: Dict[str, Any]) -> bool:
        """Capture this key's executable (on the CPU: run it once) without
        returning a result: the engine's prewarm. False when the key is
        poisoned or its capture raised."""
        key, exe, spec, leaves = self._lookup(tag, dyn_args, statics)
        if key is None or exe is _UNCAPTURABLE:
            return False
        if exe is not None:
            return True
        exe = self._build(key, tag, fn, spec, leaves, statics)
        if exe is not None and exe.graph is None:
            return self._first_run(key, exe, leaves)[0]
        return exe is not None


_CACHE = AotDispatchCache()


def get_aot_cache() -> AotDispatchCache:
    return _CACHE


def aot_call(tag: str, fn, dyn_args: Tuple, statics: Dict[str, Any]):
    return _CACHE.call(tag, fn, dyn_args, statics)

"""Runtime-inert annotation API the static checkers key on.

Port note: a copy of ``openr_tpu/analysis/annotations.py``; nothing left out.
The lint engine and the race sanitizer that read these markers stay in
``openr_tpu.analysis``; the port carries the markers only.

The lint rules need ground truth that types alone cannot carry: which
attributes are device-resident buffers, which functions run inside a
solve window, which cold-rebuild paths must drain the pending delta
first, and which plain-Python wrappers donate specific parameters into
a jitted dispatch. These decorators record exactly that — as function /
class attributes at runtime (free after import; nothing on the hot
path reads them) and as names the AST pass recognizes syntactically.

The decorators MUST stay dependency-free (no jax, no numpy): annotated
modules import this at module load, including under ``make
lint-analysis`` which never touches an accelerator runtime.
"""

from __future__ import annotations

from typing import Callable, TypeVar

F = TypeVar("F", bound=Callable)
C = TypeVar("C", bound=type)

#: attribute names the markers are stored under (shared with the AST
#: rules so both sides agree on one spelling)
SOLVE_WINDOW_ATTR = "__openr_solve_window__"
COMMITTED_DISPATCH_ATTR = "__openr_committed_dispatch__"
RESIDENT_ATTR = "__openr_resident_buffers__"
REQUIRES_DRAIN_ATTR = "__openr_requires_drain__"
DONATES_ATTR = "__openr_donates__"
FAULT_BOUNDARY_ATTR = "__openr_fault_boundary__"
MIRROR_ATTR = "__openr_host_mirrors__"
FLIGHT_CALLBACK_ATTR = "__openr_flight_callback__"
THREAD_CONFINED_ATTR = "__openr_thread_confined__"
GUARDED_BY_ATTR = "__openr_guarded_by__"
HANDOFF_ATTR = "__openr_handoff__"
RUNS_ON_ATTR = "__openr_runs_on__"


def solve_window(fn: F) -> F:
    """Mark a function as solve-window code: it runs between a churn
    dispatch and its commit, where any host synchronization
    (``np.asarray`` on a device array, ``jax.device_get``,
    ``.block_until_ready()``, ``float()`` on an Array) serializes the
    device pipeline. The ``host-sync-in-window`` rule flags those call
    forms in the function's direct body."""
    try:
        setattr(fn, SOLVE_WINDOW_ATTR, True)
    except AttributeError:
        # jit-wrapped callables may reject attributes; the static
        # checker reads the decorator syntactically either way
        pass
    return fn


def committed_dispatch(fn: F) -> F:
    """Mark a function as committed-dispatch code: it lives on the
    event path between SUBMIT (program launches) and REAP (async
    readback drain), where the host may touch the device only through
    the sanctioned ``ops.dispatch_accounting`` helpers
    (``count_dispatch`` / ``kick_async`` / ``reap_read``). The
    ``committed-dispatch`` rule flags raw ``jax.device_get`` /
    ``.block_until_ready()`` / device-scalar coercion forms in the
    function's direct body — each one is an unaccounted host round
    trip that serializes the event window."""
    try:
        setattr(fn, COMMITTED_DISPATCH_ATTR, True)
    except AttributeError:
        pass
    return fn


def resident_buffers(*attr_names: str) -> Callable[[C], C]:
    """Class decorator registering device-RESIDENT buffer attributes
    (``_packed_dev``-style state that later dispatches re-read). The
    ``donation-hazard`` rule flags any of these flowing into a donating
    dispatch or being read after donation."""

    def deco(cls: C) -> C:
        merged = tuple(getattr(cls, RESIDENT_ATTR, ())) + attr_names
        setattr(cls, RESIDENT_ATTR, merged)
        return cls

    return deco


def mirrored_by(**mirrors: str) -> Callable[[C], C]:
    """Class decorator declaring, per ``@resident_buffers`` name, the
    settle-on-success host mirror (an attribute name) or the rebuild
    recipe (a prose description) that makes the buffer healable after
    silent corruption or device loss. The ``mirror-coverage`` rule
    requires every registered resident buffer to appear here or carry
    an in-source audited suppression — a resident with neither is
    unhealable state waiting to strand a quarantined engine."""

    def deco(cls: C) -> C:
        merged = dict(getattr(cls, MIRROR_ATTR, {}))
        merged.update(mirrors)
        setattr(cls, MIRROR_ATTR, merged)
        return cls

    return deco


def requires_drain(drain_call: str) -> Callable[[F], F]:
    """Mark a method that replaces resident state wholesale (a cold
    rebuild): it must invoke ``drain_call`` (e.g. ``flush``) before any
    write to a resident buffer, so a caller-held ``PendingDelta``
    resolves instead of dangling over freed device state. Checked by
    ``donation-hazard``."""

    def deco(fn: F) -> F:
        try:
            setattr(fn, REQUIRES_DRAIN_ATTR, drain_call)
        except AttributeError:
            pass
        return fn

    return deco


def fault_boundary(fn: F) -> F:
    """Mark a function as a degradation-ladder rung or fault-supervisor
    catch site: it may be re-entered after a mid-flight failure, so the
    buffers it touches must still be valid on the SECOND attempt. The
    ``donation-hazard`` rule therefore flags *any* donation inside a
    fault boundary (a deeper rung would re-dispatch against an already
    invalidated buffer), and the ``span-discipline`` rule accepts its
    close-in-except + re-raise shape as a protected exit path."""
    try:
        setattr(fn, FAULT_BOUNDARY_ATTR, True)
    except AttributeError:
        pass
    return fn


def flight_callback(fn: F) -> F:
    """Mark a function as an anomaly-trigger / flight-recorder callback
    that runs on the wave loop or another dispatch-adjacent thread. A
    post-mortem dump is file I/O plus a full counter snapshot, so a
    callback body must never synchronize with the device — the
    ``span-discipline`` rule flags raw host-sync forms
    (``jax.device_get``, ``.block_until_ready()``, device-scalar
    coercion) in its direct body. Dump deferral lives in
    ``telemetry.flight._fire``; this marker keeps callback authors
    honest about everything else."""
    try:
        setattr(fn, FLIGHT_CALLBACK_ATTR, True)
    except AttributeError:
        pass
    return fn


def thread_confined(role: str, *attr_names: str):
    """Declare thread confinement for the ``shared-state`` rule.

    Two forms:

    - **class decorator** ``@thread_confined("evb:Decision", "_attr",
      ...)`` — the named instance attributes are only ever touched
      while the object is driven by the given role (the role names
      come from ``python -m openr_tpu.analysis --roles``). The rule
      exempts those attributes from cross-role conviction; the runtime
      sanitizer (:mod:`openr_tpu.analysis.racedep`) can still convict
      the claim if it is a lie.
    - **method decorator** ``@thread_confined("wave-loop")`` (no attr
      names) — pins the method's may-run-on role set to exactly this
      role, overriding inference. For callbacks reached through
      registries the static pass cannot see.
    """

    def deco(obj):
        if isinstance(obj, type) or attr_names:
            merged = dict(getattr(obj, THREAD_CONFINED_ATTR, {}))
            for a in attr_names:
                merged[a] = role
            try:
                setattr(obj, THREAD_CONFINED_ATTR, merged)
            except AttributeError:
                pass
        else:
            try:
                setattr(obj, THREAD_CONFINED_ATTR, {"__method__": role})
            except AttributeError:
                pass
        return obj

    return deco


def guarded_by(lock_id: str, *attr_names: str) -> Callable[[C], C]:
    """Class decorator declaring that the named instance attributes are
    always accessed under the given lock class (``"Class._lock"`` —
    identity shared with the ``lock-order`` rule). The ``shared-state``
    rule exempts the attributes AND trusts the declaration enough to
    skip held-lock reconstruction at sites its with-stack tracking
    cannot see (callbacks invoked under a caller's lock). Audited by
    the runtime sanitizer, which observes the locks actually held."""

    def deco(cls: C) -> C:
        merged = dict(getattr(cls, GUARDED_BY_ATTR, {}))
        for a in attr_names:
            merged[a] = lock_id
        setattr(cls, GUARDED_BY_ATTR, merged)
        return cls

    return deco


def handoff(*attr_names: str) -> Callable[[C], C]:
    """Class decorator declaring publish-once-then-immutable handoff
    attributes: written by one role (usually ``__init__`` or a single
    setup method) before any other role can observe the object, never
    mutated after publication. The classic safe patterns — config
    snapshots, frozen route products swapped in whole — are handoffs,
    not races; this names them so the ``shared-state`` rule does not
    cry wolf."""

    def deco(cls: C) -> C:
        merged = tuple(getattr(cls, HANDOFF_ATTR, ())) + attr_names
        setattr(cls, HANDOFF_ATTR, merged)
        return cls

    return deco


def runs_on(role: str) -> Callable[[C], C]:
    """Class decorator pinning EVERY method of the class to one thread
    role. For handler classes reached through dynamic dispatch the
    static pass cannot resolve (the ctrl server's ``getattr`` method
    lookup runs each handler on a per-connection socketserver thread).
    Methods of a ``@runs_on("ctrl")`` class seed the role fixpoint with
    that role, so attribute accesses they make — and calls they fan out
    into the rest of the tree — carry ctrl-thread provenance."""

    def deco(cls: C) -> C:
        setattr(cls, RUNS_ON_ATTR, role)
        return cls

    return deco


def donates(*param_names: str) -> Callable[[F], F]:
    """Mark a plain-Python wrapper whose named parameters are forwarded
    into a ``donate_argnums`` position of a jitted dispatch (the array
    is invalid after the call). Lets the ``donation-hazard`` rule check
    cross-module call sites without whole-program type inference."""

    def deco(fn: F) -> F:
        try:
            setattr(fn, DONATES_ATTR, tuple(param_names))
        except AttributeError:
            pass
        return fn

    return deco

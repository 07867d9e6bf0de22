"""Link-time extension point for external route-origination backends.

The reference exposes ``pluginStart(PluginArgs)`` / ``pluginStop()`` as a
default-no-op hook that vendors override at link time (reference:
openr/plugin/Plugin.h:24-34, default impl openr/plugin/Plugin.cpp:11-19,
invoked from Main.cpp:595-601 when BGP peering is enabled). A plugin
receives the prefix-update queue (to originate prefixes), the
static-routes queue (to inject routes into Decision), a reader of
Decision's route updates, and the parsed config.

Python has no link-time substitution, so the hook is a process-wide
registration: call :func:`register_plugin` before the daemon starts.
This is also the registration point for alternate SPF solver backends
(a device solver as a drop-in SpfSolver): see
:func:`openr_tpu_torch.decision.spf_solver.register_spf_backend`.

Port note: a copy of ``openr_tpu/plugin.py``; nothing left out. The
backend registry it names is ``openr_tpu_torch.decision.spf_solver``'s.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

from openr_tpu_torch.messaging.queue import ReplicateQueue, RQueue


@dataclass
class PluginArgs:
    """reference: openr/plugin/Plugin.h:24 PluginArgs."""

    prefix_updates_queue: ReplicateQueue
    static_routes_queue: ReplicateQueue
    route_updates_reader: RQueue
    config: Any = None
    # the resolved BGP peering section (config.bgp_config.BgpConfig) —
    # what a BGP speaker plugin peers from; None when BGP peering is
    # disabled (the reference only calls pluginStart when it is
    # enabled, Main.cpp:595-601)
    bgp_config: Any = None
    ssl_context: Any = None  # parity slot; TLS is handled by ctrl server


_registered_start: Optional[Callable[[PluginArgs], None]] = None
_registered_stop: Optional[Callable[[], None]] = None


def register_plugin(
    start: Callable[[PluginArgs], None],
    stop: Optional[Callable[[], None]] = None,
) -> None:
    """Install the process-wide plugin. Must be called before the daemon
    (OpenrNode) starts; replaces any previous registration."""
    global _registered_start, _registered_stop
    _registered_start = start
    _registered_stop = stop


def unregister_plugin() -> None:
    global _registered_start, _registered_stop
    _registered_start = None
    _registered_stop = None


def has_plugin() -> bool:
    return _registered_start is not None


def plugin_start(args: PluginArgs) -> None:
    """reference: pluginStart — no-op unless a plugin is registered."""
    if _registered_start is not None:
        _registered_start(args)


def plugin_stop() -> None:
    """reference: pluginStop."""
    if _registered_stop is not None:
        _registered_stop()

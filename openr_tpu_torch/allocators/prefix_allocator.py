"""PrefixAllocator: plug-and-play per-node prefix assignment.

Behavioral parity with the reference ``openr/allocators/PrefixAllocator``
(PrefixAllocator.h:35, PrefixAllocator.cpp:90-260): three allocation
modes —

* **static** (``staticAllocation``): the node->prefix map comes from
  config and/or the ``e2e-network-allocations`` KvStore key, updated
  live;
* **dynamic root** (``dynamicAllocationRootNode``): seed prefix + alloc
  length come from config, a unique sub-prefix index is elected via
  RangeAllocator consensus over the KvStore;
* **dynamic leaf** (``dynamicAllocationLeafNode``): allocation params
  are learned from the ``e2e-network-prefix`` KvStore key (value
  ``"<seed-prefix>,<alloc-len>"``) and re-elections follow param
  changes.

The elected prefix is advertised through the PrefixManager, programmed
on the loopback via netlink (old addresses are removed on change —
reference applyMyPrefix/withdrawMyPrefix), and the elected index is
persisted so restarts re-claim the same sub-prefix
(reference loadPrefixIndexFromDisk/savePrefixIndexToDisk).

Port note: a copy of ``openr_tpu/allocators/prefix_allocator.py``;
nothing left out.
"""

from __future__ import annotations

import json
from typing import Callable, Dict, Optional, Tuple

from openr_tpu_torch.monitor.monitor import push_log_sample
from openr_tpu_torch.allocators.range_allocator import RangeAllocator
from openr_tpu_torch.types import BinaryAddress, IpPrefix, PrefixEntry, PrefixType
from openr_tpu_torch.utils.eventbase import OpenrEventBase

ALLOC_PREFIX_MARKER = "allocprefix:"  # reference: Constants kPrefixAllocMarker
# reference: Constants.h:112 kSeedPrefixAllocParamKey
SEED_ALLOC_PARAM_KEY = "e2e-network-prefix"
# reference: Constants.h:117 kStaticPrefixAllocParamKey
STATIC_ALLOC_KEY = "e2e-network-allocations"
PERSIST_KEY = "prefix-allocator-index"

AllocParams = Tuple[IpPrefix, int]  # (seed prefix, alloc prefix length)


def sub_prefix(seed: IpPrefix, alloc_len: int, index: int) -> IpPrefix:
    """Carve the index-th /alloc_len prefix out of the seed prefix."""
    assert alloc_len >= seed.prefix_length
    addr_bits = len(seed.prefix_address.addr) * 8
    base = int.from_bytes(seed.prefix_address.addr, "big")
    offset = index << (addr_bits - alloc_len)
    return IpPrefix(
        prefix_address=BinaryAddress(
            addr=(base | offset).to_bytes(addr_bits // 8, "big")
        ),
        prefix_length=alloc_len,
    )


def prefix_contains(outer: IpPrefix, inner: IpPrefix) -> bool:
    """True when ``inner`` lies within ``outer``'s address space."""
    if len(outer.prefix_address.addr) != len(inner.prefix_address.addr):
        return False
    if inner.prefix_length < outer.prefix_length:
        return False
    bits = outer.prefix_length
    o = int.from_bytes(outer.prefix_address.addr, "big")
    i = int.from_bytes(inner.prefix_address.addr, "big")
    shift = 8 * len(outer.prefix_address.addr) - bits
    return (o >> shift) == (i >> shift)


def parse_alloc_params(text: str) -> AllocParams:
    """Parse ``"fc00:cafe::/56,64"`` (reference: PrefixAllocator.cpp
    parseParamsStr)."""
    seed_str, _, len_str = text.partition(",")
    seed = IpPrefix.from_str(seed_str.strip())
    alloc_len = int(len_str.strip())
    if alloc_len < seed.prefix_length:
        raise ValueError(
            f"alloc length /{alloc_len} shorter than seed "
            f"/{seed.prefix_length}"
        )
    return seed, alloc_len


class PrefixAllocator:
    def __init__(
        self,
        my_node_name: str,
        evb: OpenrEventBase,
        kvstore_client,
        prefix_manager,
        seed_prefix: Optional[IpPrefix] = None,
        alloc_prefix_len: int = 64,
        static_prefixes: Optional[Dict[str, IpPrefix]] = None,
        netlink=None,
        loopback_if: str = "lo",
        config_store=None,
        area: str = "0",
        on_allocated: Optional[Callable[[Optional[IpPrefix]], None]] = None,
        log_sample_queue=None,
    ):
        self._node = my_node_name
        self._evb = evb
        self._client = kvstore_client
        self._prefix_manager = prefix_manager
        self._log_sample_queue = log_sample_queue
        self._netlink = netlink
        self._loopback_if = loopback_if
        self._config_store = config_store
        self._area = area
        self._on_allocated = on_allocated
        self.allocated_prefix: Optional[IpPrefix] = None
        self._programmed_prefix: Optional[IpPrefix] = None
        # every seed this allocator has worked under: the loopback sync
        # treats addresses inside these spaces as ours to clean up
        self._known_seeds: set = set()
        self._alloc_params: Optional[AllocParams] = None
        self._range_allocator: Optional[RangeAllocator] = None
        self._alloc_token: Optional[object] = None
        self._static_mode = static_prefixes is not None
        self._stopped = False

        if self._static_mode:
            # static mode: allocation from config, live-updatable via the
            # e2e-network-allocations key (reference: staticAllocation)
            prefix = static_prefixes.get(my_node_name)
            if prefix is not None:
                self._evb.run_in_event_base(lambda: self._apply(prefix))
            if self._client is not None:
                self._client.subscribe_key(
                    area, STATIC_ALLOC_KEY, self._on_static_alloc_update
                )
            return

        if seed_prefix is not None:
            # dynamic root: params from config
            self.update_alloc_params(seed_prefix, alloc_prefix_len)
            return

        # dynamic leaf: params learned from the KvStore
        # (reference: dynamicAllocationLeafNode)
        assert self._client is not None, "leaf mode needs a KvStore client"
        self._client.subscribe_key(
            area, SEED_ALLOC_PARAM_KEY, self._on_alloc_param_update
        )
        existing = self._client.get_key(area, SEED_ALLOC_PARAM_KEY)
        if existing is not None and existing.value is not None:
            self._on_alloc_param_update(SEED_ALLOC_PARAM_KEY, existing)

    def stop(self) -> None:
        self._stopped = True
        self._alloc_token = None
        if self._range_allocator is not None:
            self._range_allocator.stop()

    # -- public -----------------------------------------------------------

    def get_alloc_params(self) -> Optional[AllocParams]:
        return self._alloc_params

    def update_alloc_params(
        self,
        seed_prefix: Optional[IpPrefix],
        alloc_prefix_len: int = 64,
    ) -> None:
        """(Re)start allocation from new params; ``None`` seed withdraws
        the current allocation. reference: PrefixAllocator.cpp
        startAllocation — 'can be called again with new prefix or
        std::nullopt'."""
        new_params = (
            None
            if seed_prefix is None
            else (seed_prefix, alloc_prefix_len)
        )
        if new_params == self._alloc_params and new_params is not None:
            return
        if new_params != self._alloc_params:  # None -> None is a no-op
            self._log_prefix_event(
                "ALLOC_PARAMS_UPDATE",
                old_params=(
                    f"{self._alloc_params[0].to_str()},"
                    f"{self._alloc_params[1]}"
                    if self._alloc_params
                    else ""
                ),
                new_params=(
                    f"{seed_prefix.to_str()},{alloc_prefix_len}"
                    if seed_prefix is not None
                    else ""
                ),
            )
        if self._range_allocator is not None:
            self._range_allocator.stop()
            self._range_allocator = None
        self._alloc_token = None
        self._evb.run_immediately_or_in_event_base(self._withdraw)
        self._alloc_params = new_params
        if new_params is None:
            return

        seed, alloc_len = new_params
        self._known_seeds.add(seed)
        count = 1 << (alloc_len - seed.prefix_length)
        init_index = None
        if self._config_store is not None:
            persisted = self._config_store.load(PERSIST_KEY)
            # resume only if the persisted index was elected under the
            # SAME params (reference: loadPrefixIndexFromDisk)
            if (
                isinstance(persisted, (list, tuple))
                and len(persisted) == 3
                and persisted[0] == seed.to_str()
                and persisted[1] == alloc_len
                and 0 <= persisted[2] < count
            ):
                init_index = persisted[2]
        # bind the params generation into the callback: a claim that
        # resolves after the next update_alloc_params/stop must not
        # apply a stale index against the new seed space
        token = object()
        self._alloc_token = token
        self._range_allocator = RangeAllocator(
            self._evb,
            self._client,
            self._node,
            f"{ALLOC_PREFIX_MARKER}{seed.to_str()}/{alloc_len}:",
            (0, count - 1),
            lambda index: self._on_index(index, token, new_params),
            area=self._area,
        )
        self._range_allocator.start_allocator(init_value=init_index)

    # -- KvStore-driven updates ------------------------------------------

    def _on_alloc_param_update(self, key, value) -> None:
        """reference: PrefixAllocator.cpp processAllocParamUpdate."""
        del key
        if self._stopped or value is None or value.value is None:
            return
        try:
            seed, alloc_len = parse_alloc_params(
                value.value.decode("utf-8")
            )
        except (ValueError, UnicodeDecodeError):
            return  # malformed params: keep the current allocation
        self.update_alloc_params(seed, alloc_len)

    def _on_static_alloc_update(self, key, value) -> None:
        """reference: PrefixAllocator.cpp processStaticPrefixAllocUpdate.
        Value: JSON ``{node_name: "prefix/len", ...}``."""
        del key
        if self._stopped or value is None or value.value is None:
            return
        try:
            allocations = json.loads(value.value.decode("utf-8"))
            mine = allocations.get(self._node)
        except (ValueError, UnicodeDecodeError, AttributeError):
            return
        if mine is None:
            self._evb.run_immediately_or_in_event_base(self._withdraw)
            return
        try:
            prefix = IpPrefix.from_str(mine)
        except ValueError:
            return
        self._evb.run_immediately_or_in_event_base(
            lambda: self._apply(prefix)
        )

    # -- internals --------------------------------------------------------

    def _log_prefix_event(self, event: str, **fields) -> None:
        """reference: PrefixAllocator.cpp logPrefixEvent —
        PREFIX_ELECTED / PREFIX_UPDATED / PREFIX_LOST /
        ALLOC_PARAMS_UPDATE samples toward the Monitor."""
        push_log_sample(
            self._log_sample_queue,
            node_name=self._node,
            event=event,
            **fields,
        )

    def _on_index(
        self,
        index: Optional[int],
        token: object,
        params: AllocParams,
    ) -> None:
        if token is not self._alloc_token:
            return  # stale allocator generation
        if index is None:
            self._withdraw()
            return
        seed, alloc_len = params
        if self._config_store is not None:
            self._config_store.store(
                PERSIST_KEY, [seed.to_str(), alloc_len, index]
            )
        self._apply(sub_prefix(seed, alloc_len, index))

    def _apply(self, prefix: IpPrefix) -> None:
        if prefix == self.allocated_prefix:
            return
        old = self.allocated_prefix
        self._log_prefix_event(
            "PREFIX_UPDATED" if old else "PREFIX_ELECTED",
            prefix=prefix.to_str(),
            old_prefix=old.to_str() if old else "",
        )
        # the loopback sweep happens once, in the sync below — not in
        # the intermediate withdraw too; the UPDATED sample above covers
        # the old prefix, so the withdraw does not log a separate LOST
        self._withdraw(sync_loopback=False, log=False)
        self.allocated_prefix = prefix
        self._prefix_manager.advertise_prefixes(
            [
                PrefixEntry(
                    prefix=prefix, type=PrefixType.PREFIX_ALLOCATOR
                )
            ]
        )
        self._sync_loopback_address(prefix)
        if self._on_allocated is not None:
            self._on_allocated(prefix)

    def _withdraw(
        self, sync_loopback: bool = True, log: bool = True
    ) -> None:
        had = self.allocated_prefix is not None
        if had:
            if log:
                self._log_prefix_event(
                    "PREFIX_LOST", prefix=self.allocated_prefix.to_str()
                )
            self._prefix_manager.withdraw_prefixes([self.allocated_prefix])
            self.allocated_prefix = None
        if sync_loopback:
            self._sync_loopback_address(None)
        if had and self._on_allocated is not None:
            self._on_allocated(None)

    def _sync_loopback_address(
        self, prefix: Optional[IpPrefix]
    ) -> None:
        """Program the new prefix on the loopback and remove stale ones
        (reference: PrefixAllocator.cpp:780 syncIfaceAddrs — add the
        desired set, delete everything else in scope). "In scope" here
        means: the previously programmed address, plus any kernel
        address that lies inside a seed prefix this allocator has been
        configured with — so a restarted daemon cleans up a prior
        incarnation's allocation without ever touching unrelated
        addresses (::1, operator-configured loopbacks)."""
        if self._netlink is None or prefix == self._programmed_prefix:
            return
        stale = set()
        if self._programmed_prefix is not None:
            stale.add(self._programmed_prefix)
        try:
            existing = self._netlink.get_ifaddresses(self._loopback_if)
        except Exception:
            existing = []
        for addr in existing:
            for seed in self._known_seeds:
                if prefix_contains(seed, addr) and addr != prefix:
                    stale.add(addr)
                    break
        for addr in stale:
            if addr == prefix:
                continue
            try:
                self._netlink.del_ifaddress(self._loopback_if, addr)
            except Exception:
                pass
        self._programmed_prefix = None
        if prefix is not None:
            if prefix in existing:
                # already programmed (restart re-claiming the same
                # index): adopt it — the Linux add would EEXIST
                self._programmed_prefix = prefix
                return
            try:
                self._netlink.add_ifaddress(self._loopback_if, prefix)
                self._programmed_prefix = prefix
            except Exception:
                pass

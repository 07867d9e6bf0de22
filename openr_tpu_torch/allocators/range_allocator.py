"""RangeAllocator: distributed value election over the KvStore.

Behavioral parity with the reference ``openr/allocators/RangeAllocator``
(RangeAllocator.h:29): a node claims a value in [start, end] by
advertising ``<key_prefix><value> -> <node_name>``; the KvStore merge
ordering (version, then originatorId) is the consensus arbiter — two
same-version claims resolve deterministically to the higher node name,
and the loser detects the loss and proposes a different value with
backoff. Initial proposal is a deterministic hash of the node name so
disjoint nodes usually avoid collisions outright.

Port note: a copy of ``openr_tpu/allocators/range_allocator.py``;
nothing left out. Its generator is seeded by the node name, so both
packages draw the same values.
"""

from __future__ import annotations

import hashlib
import random
from typing import Callable, Optional, Tuple

from openr_tpu_torch.types import Value
from openr_tpu_torch.utils.eventbase import OpenrEventBase

# Claims are TTL'd so an abandoned allocator's key ages out of the
# flooded store instead of living forever
# (reference: Constants.h:195 kRangeAllocTtl = 5min).
RANGE_ALLOC_TTL_MS = 300_000

# a released claim's tombstone ages out fast so the value frees up in
# seconds, not kRangeAllocTtl
RELEASE_TOMBSTONE_TTL_MS = 1_000


class RangeAllocator:
    def __init__(
        self,
        evb: OpenrEventBase,
        kvstore_client,
        my_node_name: str,
        key_prefix: str,
        allocator_range: Tuple[int, int],
        callback: Callable[[Optional[int]], None],
        area: str = "0",
        retry_interval_s: float = 0.05,
        override_owner: bool = False,
        rand_seed: Optional[int] = None,
    ):
        self._evb = evb
        self._client = kvstore_client
        self._node = my_node_name
        self._key_prefix = key_prefix
        self._start, self._end = allocator_range
        assert self._end >= self._start
        self._callback = callback
        self._area = area
        self._retry_interval = retry_interval_s
        self._override_owner = override_owner
        self._rng = random.Random(
            rand_seed if rand_seed is not None else my_node_name
        )
        self._my_value: Optional[int] = None
        self._allocated = False
        self._stopped = False
        self._refresh_timer = None
        self._client.subscribe_key_filter(self._on_publication)

    # -- public -----------------------------------------------------------

    def start_allocator(self, init_value: Optional[int] = None) -> None:
        """reference: RangeAllocator.h:69 startAllocator."""
        value = (
            init_value
            if init_value is not None
            and self._start <= init_value <= self._end
            else self._initial_proposal()
        )
        self._evb.run_immediately_or_in_event_base(
            lambda: self._try_claim(value)
        )

    def stop(self) -> None:
        """Stop claiming: unsubscribe and best-effort release the claim
        so other nodes can re-elect the value immediately instead of
        waiting out RANGE_ALLOC_TTL_MS (reference:
        RangeAllocator-inl.h:75-86 stop — unsubscribeKey + unsetKey).
        Release = flood a short-TTL empty tombstone at a bumped
        version; _try_claim recognizes empty values as free. TTL expiry
        remains the fallback if the tombstone is lost."""
        self._stopped = True
        if self._refresh_timer is not None:
            self._refresh_timer.cancel()
            self._refresh_timer = None
        unsubscribe = getattr(
            self._client, "unsubscribe_key_filter", None
        )
        if unsubscribe is not None:
            unsubscribe(self._on_publication)
        # release on the EVENT BASE thread: the claim FSM (_try_claim's
        # get/set) runs there, so scheduling the release serializes it
        # after any in-flight claim write — otherwise a claim landing
        # just after a caller-thread release check would stay locked for
        # the full TTL. _my_value is read inside the closure, on the evb,
        # so an in-flight _try_claim's freshly-claimed value is seen.
        self._evb.run_immediately_or_in_event_base(self._release_claim)

    def _release_claim(self) -> None:
        value = self._my_value  # evb thread: serialized after claim FSM
        clear = getattr(self._client, "clear_key", None)
        if value is None or clear is None:
            return
        try:
            # only release a claim the LOCAL store says is ours — a
            # peer may have just won the tie-break. A winning claim
            # still in flight from another node can slip this check
            # (eventually-consistent store); the cost is one bounded
            # re-election flap on that node, traded against freeing
            # the value ~300x faster than TTL ageout on every clean
            # shutdown.
            stored = self._client.get_key(
                self._area, self._key_for(value)
            )
            if (
                stored is not None
                and stored.value == self._node.encode()
                and stored.originator_id == self._node
            ):
                clear(
                    self._area,
                    self._key_for(value),
                    b"",
                    ttl=RELEASE_TOMBSTONE_TTL_MS,
                )
        except Exception:
            pass  # best-effort; TTL expiry is the fallback

    def get_value(self) -> Optional[int]:
        return self._my_value if self._allocated else None

    def is_range_consumed(self) -> bool:
        """reference: RangeAllocator.h:90 isRangeConsumed."""
        owned = self._client.dump_all_with_prefix(self._area, self._key_prefix)
        return len(owned) >= (self._end - self._start + 1)

    # -- internals --------------------------------------------------------

    def _key_for(self, value: int) -> str:
        return f"{self._key_prefix}{value}"

    def _initial_proposal(self) -> int:
        size = self._end - self._start + 1
        digest = int.from_bytes(
            hashlib.sha256(self._node.encode()).digest()[:8], "big"
        )
        return self._start + digest % size

    def _try_claim(self, value: int) -> None:
        if self._stopped:
            return
        existing = self._client.get_key(self._area, self._key_for(value))
        # an empty value is a release tombstone (stop() above): the
        # value is free — claim PAST the tombstone's version
        tombstone = (
            existing is not None and existing.value == b""
        )
        foreign = (
            existing is not None
            and not tombstone
            and existing.value is not None
            and existing.value != self._node.encode()
        )
        if foreign and not self._override_owner:
            self._try_next(value)
            return
        self._my_value = value
        self._allocated = False
        # claim at the SAME version as a foreign owner: the merge ordering
        # breaks the tie by originator id, deterministically, on every
        # store in the network. Fresh keys start at version 1; a release
        # tombstone is outbid at version+1.
        version = existing.version if foreign else (
            1 if existing is None
            else existing.version + 1 if tombstone
            else existing.version
        )
        self._client.set_key(
            self._area,
            self._key_for(value),
            self._node.encode(),
            version=version,
            ttl=RANGE_ALLOC_TTL_MS,
        )
        self._evb.schedule_timeout(
            self._retry_interval, lambda: self._verify_claim(value)
        )

    def _verify_claim(self, value: int) -> None:
        if self._stopped or self._my_value != value:
            return
        stored = self._client.get_key(self._area, self._key_for(value))
        if (
            stored is not None
            and stored.value == self._node.encode()
            and stored.originator_id == self._node
        ):
            if not self._allocated:
                self._allocated = True
                self._start_ttl_refresh()
                self._callback(value)
        else:
            self._my_value = None
            self._try_next(value)

    def _start_ttl_refresh(self) -> None:
        """Keep our claim's TTL fresh while we own it. Deliberately NOT
        client.persist_key: ownership enforcement would bump the version
        to win the key back, overriding the same-version originator-id
        consensus that makes the allocator converge. A ttl-only refresh
        (bumped ttlVersion, value=None) preserves the merge ordering."""
        if self._refresh_timer is not None:
            return
        interval = RANGE_ALLOC_TTL_MS / 1000.0 / 3.0
        self._refresh_timer = self._evb.schedule_periodic(
            interval, self._refresh_claim_ttl, jitter_first=True
        )

    def _refresh_claim_ttl(self) -> None:
        if self._stopped or self._my_value is None or not self._allocated:
            return
        # not ours anymore -> no-op; the publication path handles the loss
        self._client.refresh_ttl(
            self._area, self._key_for(self._my_value), RANGE_ALLOC_TTL_MS
        )

    def _try_next(self, failed_value: int) -> None:
        if self._stopped:
            return
        size = self._end - self._start + 1
        step = 1 + self._rng.randrange(max(1, size // 8))
        nxt = self._start + (failed_value - self._start + step) % size
        self._evb.schedule_timeout(
            self._retry_interval, lambda: self._try_claim(nxt)
        )

    def _on_publication(self, area: str, key: str, value: Optional[Value]):
        if (
            self._stopped
            or area != self._area
            or self._my_value is None
            or key != self._key_for(self._my_value)
        ):
            return
        if value is None or value.value == b"":
            # true expiry (pub.expired_keys) or a peer's release
            # tombstone: the value is FREE — re-claim the same value
            # (moving to a different one would churn allocations, e.g.
            # a network-wide SR label change, for no reason)
            claimed = self._my_value
            self._evb.run_immediately_or_in_event_base(
                lambda: self._try_claim(claimed)
            )
            return
        if value.value is None:
            # ttl-only refresh (ours or a peer's): carries no ownership
            # information — NOT an expiry. Re-claiming here would churn
            # the allocation every refresh interval.
            return
        if value.value != self._node.encode():
            # a higher-precedence claim may have taken our value — but the
            # publication can be stale (an interleaved losing claim that
            # merged momentarily before ours). Confirm against the store.
            stored = self._client.get_key(self._area, key)
            if stored is not None and stored.value == self._node.encode():
                return  # stale: we still own it
            lost = self._my_value
            self._my_value = None
            was_allocated = self._allocated
            self._allocated = False
            if was_allocated:
                self._callback(None)
            self._try_next(lost)

"""KvStore wire types: versioned values, publications, sync params.

Port note: a copy of ``openr_tpu/types/kvstore.py``; nothing left out.

Schema parity with the reference IDL ``openr/if/KvStore.thrift``.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set

# TTL value indicating a key never expires.
# reference: openr/common/Constants.h kTtlInfinity
TTL_INFINITY = -(2 ** 31)

DEFAULT_AREA = "0"


@dataclass
class Value:
    """A versioned, TTL'd value. The CRDT unit of the flooded LSDB.

    Merge ordering: (version, originatorId, value) — see
    ``openr_tpu_torch.kvstore.store.merge_key_values``.
    reference: openr/if/KvStore.thrift:21-41
    """

    version: int = 0
    originator_id: str = ""
    value: Optional[bytes] = None
    ttl: int = TTL_INFINITY
    ttl_version: int = 0
    hash: Optional[int] = None


@dataclass
class Publication:
    """A batch of updated key/values flooded between stores.

    reference: openr/if/KvStore.thrift:229+
    """

    key_vals: Dict[str, Value] = field(default_factory=dict)
    expired_keys: List[str] = field(default_factory=list)
    nodes: Optional[List[str]] = None
    tobe_updated_keys: Optional[List[str]] = None
    flood_root_id: Optional[str] = None
    area: str = DEFAULT_AREA
    # in-process only (never serialized): the telemetry trace born at
    # set_key_vals, carried to Decision for span accumulation
    trace: Optional[object] = None


@dataclass
class KeySetParams:
    """reference: openr/if/KvStore.thrift:62+"""

    key_vals: Dict[str, Value] = field(default_factory=dict)
    solicit_response: bool = True
    originator_id: str = ""
    flood_root_id: Optional[str] = None
    timestamp_ms: Optional[int] = None


@dataclass
class KeyGetParams:
    keys: List[str] = field(default_factory=list)


@dataclass
class KeyDumpParams:
    """reference: openr/if/KvStore.thrift:91+"""

    prefix: str = ""
    originator_ids: Set[str] = field(default_factory=set)
    keys: Optional[List[str]] = None
    # if set, only respond with values whose (version, originator, value)
    # hash differs from the one supplied here (anti-entropy sync)
    key_val_hashes: Optional[Dict[str, Value]] = None


class KvStorePeerState(enum.IntEnum):
    """Per-peer sync FSM. reference: openr/kvstore/KvStore.h:46-50"""

    IDLE = 0
    SYNCING = 1
    INITIALIZED = 2


@dataclass
class PeerSpec:
    """How to reach a peer store. reference: openr/if/KvStore.thrift:119+"""

    peer_addr: str = ""
    ctrl_port: int = 0
    state: KvStorePeerState = KvStorePeerState.IDLE

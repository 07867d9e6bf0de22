"""Framework-wide constants (reference: openr/common/Constants.h).

Port note: a copy of ``openr_tpu/utils/constants.py``; nothing left out.
"""

from __future__ import annotations

# key markers in the flooded store (reference: Constants.h kAdjDbMarker /
# kPrefixDbMarker)
ADJ_DB_MARKER = "adj:"
PREFIX_DB_MARKER = "prefix:"
FIB_TIME_MARKER = "fibtime:"

PREFIX_NAME_SEPARATOR = ":"

DEFAULT_AREA = "0"

# default ports (reference: Constants.h:254-263)
CTRL_PORT = 2018
KVSTORE_PORT = 60002
FIB_AGENT_PORT = 60100
SPARK_MCAST_PORT = 6666

# debounce window for route rebuilds (reference: common/Flags.cpp:87-96)
DECISION_DEBOUNCE_MIN_MS = 10
DECISION_DEBOUNCE_MAX_MS = 250

# KvStore timers (reference: Constants.h)
KVSTORE_DB_SYNC_INTERVAL_S = 60
TTL_DECREMENT_MS = 1  # floor applied when re-flooding TTLs
# finite TTL for withdraw tombstones so delete markers age out of every
# store instead of accumulating (reference: clearKey floods with the
# key's finite TTL, Constants.h kKvStoreDbTtl)
KVSTORE_TOMBSTONE_TTL_MS = 300_000

# default best-route-selection metrics assigned at prefix origination.
# Non-zero so a re-originated copy (distance+1) still clears the
# zero-metric selection sentinel yet always loses to the original
# (reference: Constants.h:244-245 kDefaultPathPreference /
# kDefaultSourcePreference, applied in buildOriginatedPrefixDb)
DEFAULT_PATH_PREFERENCE = 1000
DEFAULT_SOURCE_PREFERENCE = 200

# MPLS label ranges (reference: Constants.h kSrGlobalRange / kSrLocalRange)
SR_GLOBAL_RANGE = (101, 49999)
SR_LOCAL_RANGE = (50000, 59999)
MPLS_LABEL_MAX = (1 << 20) - 1


def is_mpls_label_valid(label: int) -> bool:
    """Label fits in 20 bits. The reference deliberately does NOT reject
    the reserved 0-15 range (reference: openr/common/Util.h:284
    isMplsLabelValid, '(mplsLabel & 0xfff00000) == 0'). Label 0 is
    filtered by the MPLS label-route loops (buildRouteDb's 'topLabel == 0'
    guards); the unicast PUSH path intentionally accepts it — the
    reference pushes a 0 node label too (Decision.cpp:1287-1292)."""
    return 0 <= label <= MPLS_LABEL_MAX

"""LSDB key naming helpers.

Port note: a copy of ``openr_tpu/utils/keys.py``; nothing left out.

reference: openr/common/Constants.h markers, openr/common/Util.cpp
getNodeNameFromKey, and the PrefixKey class
(openr/common/Util.h / PrefixKey: "prefix:<node>:<area>:[<prefix>]").
"""

from __future__ import annotations

import re
from typing import Optional, Tuple

from openr_tpu_torch.types import IpPrefix
from openr_tpu_torch.utils.constants import (
    ADJ_DB_MARKER,
    FIB_TIME_MARKER,
    PREFIX_DB_MARKER,
)

_PER_PREFIX_KEY_RE = re.compile(
    r"^prefix:(?P<node>[^:]+):(?P<area>[^:]+):\[(?P<prefix>[^\]]+)\]$"
)


def adj_key(node: str) -> str:
    return f"{ADJ_DB_MARKER}{node}"


def prefix_db_key(node: str) -> str:
    return f"{PREFIX_DB_MARKER}{node}"


def per_prefix_key(node: str, area: str, prefix: IpPrefix) -> str:
    return f"{PREFIX_DB_MARKER}{node}:{area}:[{prefix.to_str()}]"


def fib_time_key(node: str) -> str:
    return f"{FIB_TIME_MARKER}{node}"


def get_node_name_from_key(key: str) -> str:
    """reference: openr/common/Util.cpp:1040 getNodeNameFromKey"""
    parts = key.split(":")
    return parts[1] if len(parts) >= 2 else ""


def parse_per_prefix_key(key: str) -> Optional[Tuple[str, str, IpPrefix]]:
    """(node, area, prefix) for per-prefix keys, else None."""
    m = _PER_PREFIX_KEY_RE.match(key)
    if m is None:
        return None
    try:
        prefix = IpPrefix.from_str(m.group("prefix"))
    except ValueError:
        return None
    return (m.group("node"), m.group("area"), prefix)


def is_adj_key(key: str) -> bool:
    return key.startswith(ADJ_DB_MARKER)


def is_prefix_key(key: str) -> bool:
    return key.startswith(PREFIX_DB_MARKER)


def is_fib_time_key(key: str) -> bool:
    return key.startswith(FIB_TIME_MARKER)

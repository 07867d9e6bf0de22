"""Thrift CompactProtocol struct codec for the KvStore wire surface.

The reference's peer channel exchanges thrift structs serialized with
``TCompactProtocol`` (reference IDL: openr/if/KvStore.thrift; service:
openr/if/OpenrCtrl.thrift KvStoreService). ``openr_tpu_torch.utils.wire`` is
the framework's own self-describing codec; THIS module is the
interop path — it produces and consumes the exact compact-protocol
bytes a reference node emits, so an openr-tpu daemon can sit on the
wire with stock Open/R peers.

Implemented from the thrift compact protocol specification
(thrift/doc/specs/thrift-compact-protocol.md):

- unsigned LEB128 varints; zigzag(i16/i32/i64) for integer values
- struct field header: ``(delta << 4) | type`` when the field-id delta
  from the previous field is in [1, 15], else ``0x00 | type`` followed
  by the zigzag-varint field id
- BOOL is carried in the field-header type nibble (1=true, 2=false);
  standalone bools (collection elements) are one byte 1/2
- binary/string: varint byte-length + payload
- list/set: ``(size << 4) | elem_type`` when size < 15, else
  ``0xF0 | elem_type`` + varint size
- map: empty maps are the single byte 0x00, otherwise varint size +
  one byte ``(key_type << 4) | value_type``
- nested structs recurse; every struct ends with STOP (0x00)

Fields are written in IDL *declaration* order (the generated reference
serializers emit in declaration order, which for these structs differs
from field-id order — the IDL comments call the numbering out as
deliberate); the decoder accepts any order, per the spec.

Port note: a copy of ``openr_tpu/utils/thrift_compact.py``; nothing left out.
Its lazy type imports resolve in the port's ``types`` and ``dual``
packages, so both packages encode the same bytes.
"""

from __future__ import annotations

import struct as _struct
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

# compact-protocol wire types
T_STOP = 0x00
T_TRUE = 0x01
T_FALSE = 0x02
T_BYTE = 0x03
T_I16 = 0x04
T_I32 = 0x05
T_I64 = 0x06
T_DOUBLE = 0x07
T_BINARY = 0x08  # also string
T_LIST = 0x09
T_SET = 0x0A
T_MAP = 0x0B
T_STRUCT = 0x0C

# type descriptors: ("i64",) | ("i32",) | ("i16",) | ("byte",) |
# ("bool",) | ("string",) | ("binary",) | ("list", elem) |
# ("set", elem) | ("map", key, val) | ("struct", StructSchema)
_WIRE_TYPE = {
    "bool": T_TRUE,  # placeholder; bools resolve per-value in headers
    "byte": T_BYTE,
    "i16": T_I16,
    "i32": T_I32,
    "i64": T_I64,
    "double": T_DOUBLE,
    "string": T_BINARY,
    "binary": T_BINARY,
    "list": T_LIST,
    "set": T_SET,
    "map": T_MAP,
    "struct": T_STRUCT,
}


@dataclass(frozen=True)
class Field:
    """One IDL field: id, type descriptor, python key. ``optional``
    fields are skipped when the value is None; required fields with
    value None raise."""

    fid: int
    ftype: Tuple
    name: str
    optional: bool = False


@dataclass(frozen=True)
class StructSchema:
    name: str
    fields: Tuple[Field, ...]  # IDL declaration order

    def by_id(self) -> Dict[int, Field]:
        return {f.fid: f for f in self.fields}


class _Writer:
    def __init__(self):
        self.buf = bytearray()

    def byte(self, b: int) -> None:
        self.buf.append(b & 0xFF)

    def varint(self, n: int) -> None:
        assert n >= 0, n
        while True:
            if n < 0x80:
                self.buf.append(n)
                return
            self.buf.append((n & 0x7F) | 0x80)
            n >>= 7

    def zigzag(self, n: int, bits: int) -> None:
        mask = (1 << bits) - 1
        self.varint(((n << 1) ^ (n >> (bits - 1))) & mask)

    def binary(self, b: bytes) -> None:
        self.varint(len(b))
        self.buf.extend(b)


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def byte(self) -> int:
        b = self.data[self.pos]
        self.pos += 1
        return b

    def varint(self) -> int:
        out = 0
        shift = 0
        while True:
            b = self.byte()
            out |= (b & 0x7F) << shift
            if not b & 0x80:
                return out
            shift += 7
            if shift > 70:
                raise ValueError("varint too long")

    def zigzag(self, bits: int) -> int:
        u = self.varint()
        n = (u >> 1) ^ -(u & 1)
        # normalize to signed range
        if n >= 1 << (bits - 1):
            n -= 1 << bits
        return n

    def binary(self) -> bytes:
        n = self.varint()
        out = self.data[self.pos : self.pos + n]
        if len(out) != n:
            raise ValueError("truncated binary")
        self.pos += n
        return bytes(out)


def _wire_type_of(ftype: Tuple, value: Any) -> int:
    if ftype[0] == "bool":
        return T_TRUE if value else T_FALSE
    return _WIRE_TYPE[ftype[0]]


def _write_value(w: _Writer, ftype: Tuple, value: Any) -> None:
    kind = ftype[0]
    if kind == "bool":
        w.byte(T_TRUE if value else T_FALSE)  # standalone (collection)
    elif kind == "byte":
        w.byte(value & 0xFF)
    elif kind in ("i16", "i32", "i64"):
        bits = {"i16": 16, "i32": 32, "i64": 64}[kind]
        w.zigzag(int(value), bits)
    elif kind == "double":
        # 8 bytes BIG-endian: fbthrift's CompactProtocol kept the
        # pre-spec big-endian double encoding (a documented divergence
        # from the Apache compact spec's little-endian), and THIS
        # codec's contract is byte-exact fbthrift interop — the wire
        # the reference's stack actually emits
        w.buf.extend(_struct.pack(">d", float(value)))
    elif kind == "string":
        w.binary(value.encode("utf-8"))
    elif kind == "binary":
        w.binary(bytes(value))
    elif kind in ("list", "set"):
        elem = ftype[1]
        items = sorted(value) if kind == "set" else list(value)
        et = _WIRE_TYPE[elem[0]] if elem[0] != "bool" else T_TRUE
        if len(items) < 15:
            w.byte((len(items) << 4) | et)
        else:
            w.byte(0xF0 | et)
            w.varint(len(items))
        for item in items:
            _write_value(w, elem, item)
    elif kind == "map":
        ktype, vtype = ftype[1], ftype[2]
        if not value:
            w.byte(0)
            return
        w.varint(len(value))
        kt = _WIRE_TYPE[ktype[0]] if ktype[0] != "bool" else T_TRUE
        vt = _WIRE_TYPE[vtype[0]] if vtype[0] != "bool" else T_TRUE
        w.byte((kt << 4) | vt)
        # deterministic output: sort keys (maps are unordered on the
        # wire; reference emits hash-map order, any order decodes)
        for k in sorted(value):
            _write_value(w, ktype, k)
            _write_value(w, vtype, value[k])
    elif kind == "struct":
        _write_struct(w, ftype[1], value)
    else:
        raise TypeError(f"unsupported type {kind}")


def _write_struct(w: _Writer, schema: StructSchema, values: Dict) -> None:
    last_fid = 0
    for f in schema.fields:
        value = values.get(f.name)
        if value is None:
            if f.optional:
                continue
            raise ValueError(f"{schema.name}.{f.name} is required")
        wtype = _wire_type_of(f.ftype, value)
        delta = f.fid - last_fid
        if 0 < delta <= 15:
            w.byte((delta << 4) | wtype)
        else:
            w.byte(wtype)
            w.zigzag(f.fid, 16)
        if f.ftype[0] != "bool":  # bool value rode in the header
            _write_value(w, f.ftype, value)
        last_fid = f.fid
    w.byte(T_STOP)


def _skip(r: _Reader, wtype: int, standalone: bool = False) -> None:
    """``standalone`` distinguishes the two bool encodings: a FIELD
    bool rides entirely in the field-header nibble (zero value bytes),
    while a collection/map ELEMENT bool is one byte (01/02). Skipping
    with the wrong context desyncs every subsequent byte."""
    if wtype in (T_TRUE, T_FALSE):
        if standalone:
            r.byte()
        return
    if wtype == T_BYTE:
        r.byte()
    elif wtype in (T_I16, T_I32, T_I64):
        r.varint()
    elif wtype == T_DOUBLE:
        if r.pos + 8 > len(r.data):
            raise ValueError("truncated double")
        r.pos += 8
    elif wtype == T_BINARY:
        r.binary()
    elif wtype in (T_LIST, T_SET):
        head = r.byte()
        size = head >> 4
        et = head & 0x0F
        if size == 15:
            size = r.varint()
        for _ in range(size):
            _skip(r, et, standalone=True)
    elif wtype == T_MAP:
        size = r.varint()
        if size:
            head = r.byte()
            for _ in range(size):
                _skip(r, head >> 4, standalone=True)
                _skip(r, head & 0x0F, standalone=True)
    elif wtype == T_STRUCT:
        while True:
            b = r.byte()
            if b == T_STOP:
                return
            wt = b & 0x0F
            if (b >> 4) == 0:
                r.zigzag(16)
            _skip(r, wt)
    else:
        raise ValueError(f"cannot skip wire type {wtype}")


def _read_value(
    r: _Reader, ftype: Tuple, wtype: int, standalone: bool = False
) -> Any:
    kind = ftype[0]
    if kind == "bool":
        # field context: the value IS the header nibble (zero bytes);
        # collection/map element context (standalone): one byte 01/02.
        # The elem-type nibble is T_TRUE in both cases, so the caller's
        # context flag — not the wire type — must decide.
        if standalone:
            return r.byte() == T_TRUE
        return wtype == T_TRUE
    if kind == "byte":
        b = r.byte()
        return b - 256 if b >= 128 else b
    if kind in ("i16", "i32", "i64"):
        return r.zigzag({"i16": 16, "i32": 32, "i64": 64}[kind])
    if kind == "double":
        raw = r.data[r.pos : r.pos + 8]
        if len(raw) != 8:
            raise ValueError("truncated double")
        r.pos += 8
        return _struct.unpack(">d", raw)[0]
    if kind == "string":
        return r.binary().decode("utf-8")
    if kind == "binary":
        return r.binary()
    if kind in ("list", "set"):
        head = r.byte()
        size = head >> 4
        if size == 15:
            size = r.varint()
        elem = ftype[1]
        items = [
            _read_value(r, elem, head & 0x0F, standalone=True)
            for _ in range(size)
        ]
        return set(items) if kind == "set" else items
    if kind == "map":
        size = r.varint()
        out: Dict = {}
        if size == 0:
            return out
        head = r.byte()
        for _ in range(size):
            k = _read_value(r, ftype[1], head >> 4, standalone=True)
            v = _read_value(r, ftype[2], head & 0x0F, standalone=True)
            out[k] = v
        return out
    if kind == "struct":
        return _read_struct(r, ftype[1])
    raise TypeError(f"unsupported type {kind}")


def _read_struct(r: _Reader, schema: StructSchema) -> Dict:
    fields = schema.by_id()
    out: Dict = {}
    last_fid = 0
    while True:
        head = r.byte()
        if head == T_STOP:
            return out
        wtype = head & 0x0F
        delta = head >> 4
        fid = last_fid + delta if delta else r.zigzag(16)
        last_fid = fid
        f = fields.get(fid)
        if f is None:
            _skip(r, wtype)  # forward compatibility: unknown field
            continue
        out[f.name] = _read_value(r, f.ftype, wtype)


def encode(schema: StructSchema, values: Dict) -> bytes:
    """Serialize ``values`` (a plain dict keyed by field name) as one
    compact-protocol struct."""
    w = _Writer()
    _write_struct(w, schema, values)
    return bytes(w.buf)


def decode(schema: StructSchema, data: bytes) -> Dict:
    """Parse one compact-protocol struct into a dict keyed by field
    name. Unknown fields are skipped (forward compatibility); absent
    fields are absent from the dict (callers apply IDL defaults)."""
    return _read_struct(_Reader(data), schema)


# -- KvStore.thrift schemas (field ids + declaration order verbatim) -----

# reference: openr/if/KvStore.thrift:21-41
VALUE = StructSchema(
    "Value",
    (
        Field(1, ("i64",), "version"),
        Field(3, ("string",), "originatorId"),
        Field(2, ("binary",), "value", optional=True),
        Field(4, ("i64",), "ttl"),
        Field(5, ("i64",), "ttlVersion"),
        Field(6, ("i64",), "hash", optional=True),
    ),
)

# reference: openr/if/KvStore.thrift:62-85
KEY_SET_PARAMS = StructSchema(
    "KeySetParams",
    (
        Field(2, ("map", ("string",), ("struct", VALUE)), "keyVals"),
        Field(3, ("bool",), "solicitResponse"),
        Field(5, ("list", ("string",)), "nodeIds", optional=True),
        Field(6, ("string",), "floodRootId", optional=True),
        Field(7, ("i64",), "timestamp_ms", optional=True),
    ),
)

# reference: openr/if/KvStore.thrift:87-89
KEY_GET_PARAMS = StructSchema(
    "KeyGetParams", (Field(1, ("list", ("string",)), "keys"),)
)

# reference: openr/if/KvStore.thrift:91-115
KEY_DUMP_PARAMS = StructSchema(
    "KeyDumpParams",
    (
        Field(1, ("string",), "prefix"),
        Field(3, ("set", ("string",)), "originatorIds"),
        Field(6, ("bool",), "ignoreTtl"),
        Field(7, ("bool",), "doNotPublishValue"),
        Field(
            2,
            ("map", ("string",), ("struct", VALUE)),
            "keyValHashes",
            optional=True,
        ),
        Field(4, ("i32",), "oper", optional=True),
        Field(5, ("list", ("string",)), "keys", optional=True),
    ),
)

# reference: openr/if/KvStore.thrift:229-254
PUBLICATION = StructSchema(
    "Publication",
    (
        Field(2, ("map", ("string",), ("struct", VALUE)), "keyVals"),
        Field(3, ("list", ("string",)), "expiredKeys"),
        Field(4, ("list", ("string",)), "nodeIds", optional=True),
        Field(5, ("list", ("string",)), "tobeUpdatedKeys", optional=True),
        Field(6, ("string",), "floodRootId", optional=True),
        Field(7, ("string",), "area"),
    ),
)

# reference: openr/if/KvStore.thrift:205-219 (KvStoreRequest; the DUAL
# and flood-topo arms are carried by the framework's own RPC surface)
KV_STORE_REQUEST = StructSchema(
    "KvStoreRequest",
    (
        Field(1, ("i32",), "cmd"),
        Field(11, ("string",), "area"),
        Field(
            2, ("struct", KEY_SET_PARAMS), "keySetParams", optional=True
        ),
        Field(
            3, ("struct", KEY_GET_PARAMS), "keyGetParams", optional=True
        ),
        Field(
            6, ("struct", KEY_DUMP_PARAMS), "keyDumpParams", optional=True
        ),
    ),
)

# Command enum values (KvStore.thrift:47-52)
CMD_KEY_SET = 1
CMD_KEY_DUMP = 3


# -- dataclass adapters --------------------------------------------------


def _value_to_wire(v) -> Dict:
    out = {
        "version": v.version,
        "originatorId": v.originator_id,
        "ttl": v.ttl,
        "ttlVersion": v.ttl_version,
    }
    if v.value is not None:
        out["value"] = v.value
    if v.hash is not None:
        out["hash"] = v.hash
    return out


def _value_from_wire(d: Dict):
    from openr_tpu_torch.types import Value

    return Value(
        version=d.get("version", 0),
        originator_id=d.get("originatorId", ""),
        value=d.get("value"),
        ttl=d.get("ttl", 0),
        ttl_version=d.get("ttlVersion", 0),
        hash=d.get("hash"),
    )


def encode_value(v) -> bytes:
    return encode(VALUE, _value_to_wire(v))


def decode_value(data: bytes):
    return _value_from_wire(decode(VALUE, data))


def _publication_to_wire(pub) -> Dict:
    out: Dict = {
        "keyVals": {
            k: _value_to_wire(v) for k, v in pub.key_vals.items()
        },
        "expiredKeys": list(pub.expired_keys),
        "area": pub.area,
    }
    if pub.nodes is not None:
        out["nodeIds"] = list(pub.nodes)
    if pub.tobe_updated_keys is not None:
        out["tobeUpdatedKeys"] = list(pub.tobe_updated_keys)
    if pub.flood_root_id is not None:
        out["floodRootId"] = pub.flood_root_id
    return out


def _publication_from_wire(d: Dict):
    from openr_tpu_torch.types import Publication

    return Publication(
        key_vals={
            k: _value_from_wire(v)
            for k, v in d.get("keyVals", {}).items()
        },
        expired_keys=list(d.get("expiredKeys", [])),
        nodes=d.get("nodeIds"),
        tobe_updated_keys=d.get("tobeUpdatedKeys"),
        flood_root_id=d.get("floodRootId"),
        area=d.get("area", "0"),
    )


def encode_publication(pub) -> bytes:
    return encode(PUBLICATION, _publication_to_wire(pub))


def decode_publication(data: bytes):
    return _publication_from_wire(decode(PUBLICATION, data))


def _key_set_params_to_wire(p) -> Dict:
    """Our KeySetParams.originator_id rides the wire as the reference's
    ``nodeIds`` traversal list (the reference appends each hop's node id
    for loop suppression; the framework tracks only the sender)."""
    out: Dict = {
        "keyVals": {
            k: _value_to_wire(v) for k, v in p.key_vals.items()
        },
        "solicitResponse": p.solicit_response,
    }
    if p.originator_id:
        out["nodeIds"] = [p.originator_id]
    if p.flood_root_id is not None:
        out["floodRootId"] = p.flood_root_id
    if p.timestamp_ms is not None:
        out["timestamp_ms"] = p.timestamp_ms
    return out


def _key_set_params_from_wire(d: Dict):
    from openr_tpu_torch.types import KeySetParams

    node_ids = d.get("nodeIds") or []
    return KeySetParams(
        key_vals={
            k: _value_from_wire(v)
            for k, v in d.get("keyVals", {}).items()
        },
        solicit_response=d.get("solicitResponse", True),
        originator_id=node_ids[-1] if node_ids else "",
        flood_root_id=d.get("floodRootId"),
        timestamp_ms=d.get("timestamp_ms"),
    )


def encode_key_set_params(p) -> bytes:
    return encode(KEY_SET_PARAMS, _key_set_params_to_wire(p))


def decode_key_set_params(data: bytes):
    return _key_set_params_from_wire(decode(KEY_SET_PARAMS, data))


def _key_dump_params_to_wire(p) -> Dict:
    out: Dict = {
        "prefix": p.prefix,
        "originatorIds": set(p.originator_ids),
        "ignoreTtl": True,
        "doNotPublishValue": False,
    }
    if p.key_val_hashes is not None:
        out["keyValHashes"] = {
            k: _value_to_wire(v) for k, v in p.key_val_hashes.items()
        }
    if p.keys is not None:
        out["keys"] = list(p.keys)
    return out


def _key_dump_params_from_wire(d: Dict):
    from openr_tpu_torch.types import KeyDumpParams

    hashes = d.get("keyValHashes")
    return KeyDumpParams(
        prefix=d.get("prefix", ""),
        originator_ids=set(d.get("originatorIds", ())),
        keys=d.get("keys"),
        key_val_hashes=(
            {k: _value_from_wire(v) for k, v in hashes.items()}
            if hashes is not None
            else None
        ),
    )


def encode_key_dump_params(p) -> bytes:
    return encode(KEY_DUMP_PARAMS, _key_dump_params_to_wire(p))


def decode_key_dump_params(data: bytes):
    return _key_dump_params_from_wire(decode(KEY_DUMP_PARAMS, data))


# -- Network.thrift schemas (shared by FibService and Spark wires) -------

# reference: openr/if/Network.thrift:55-58
BINARY_ADDRESS = StructSchema(
    "BinaryAddress",
    (
        Field(1, ("binary",), "addr"),
        Field(3, ("string",), "ifName", optional=True),
    ),
)

# reference: openr/if/Network.thrift:60-63
IP_PREFIX = StructSchema(
    "IpPrefix",
    (
        Field(1, ("struct", BINARY_ADDRESS), "prefixAddress"),
        Field(2, ("i16",), "prefixLength"),
    ),
)

# reference: openr/if/Network.thrift:47-53
MPLS_ACTION = StructSchema(
    "MplsAction",
    (
        Field(1, ("i32",), "action"),
        Field(2, ("i32",), "swapLabel", optional=True),
        Field(3, ("list", ("i32",)), "pushLabels", optional=True),
    ),
)

# reference: openr/if/Network.thrift:65-96 (metric is field 51,
# area 53, neighborNodeName 54 — deliberately sparse ids)
NEXT_HOP = StructSchema(
    "NextHopThrift",
    (
        Field(1, ("struct", BINARY_ADDRESS), "address"),
        Field(2, ("i32",), "weight"),
        Field(3, ("struct", MPLS_ACTION), "mplsAction", optional=True),
        Field(51, ("i32",), "metric"),
        Field(53, ("string",), "area", optional=True),
        Field(54, ("string",), "neighborNodeName", optional=True),
    ),
)

# reference: openr/if/Network.thrift:121-135 (field 2 deprecated)
UNICAST_ROUTE = StructSchema(
    "UnicastRoute",
    (
        Field(1, ("struct", IP_PREFIX), "dest"),
        Field(3, ("i32",), "adminDistance", optional=True),
        Field(4, ("list", ("struct", NEXT_HOP)), "nextHops"),
        Field(5, ("i32",), "prefixType", optional=True),
        Field(6, ("binary",), "data", optional=True),
        Field(7, ("bool",), "doNotInstall"),
    ),
)

# reference: openr/if/Network.thrift:98-104
MPLS_ROUTE = StructSchema(
    "MplsRoute",
    (
        Field(1, ("i32",), "topLabel"),
        Field(3, ("i32",), "adminDistance", optional=True),
        Field(4, ("list", ("struct", NEXT_HOP)), "nextHops"),
    ),
)


def _bin_addr_to_wire(a) -> Dict:
    out: Dict = {"addr": a.addr}
    if a.if_name is not None:
        out["ifName"] = a.if_name
    return out


def _bin_addr_from_wire(d: Dict):
    from openr_tpu_torch.types import BinaryAddress

    return BinaryAddress(addr=d.get("addr", b""), if_name=d.get("ifName"))


def _ip_prefix_to_wire(p) -> Dict:
    return {
        "prefixAddress": _bin_addr_to_wire(p.prefix_address),
        "prefixLength": p.prefix_length,
    }


def _ip_prefix_from_wire(d: Dict):
    from openr_tpu_torch.types import IpPrefix

    return IpPrefix(
        prefix_address=_bin_addr_from_wire(d.get("prefixAddress", {})),
        prefix_length=d.get("prefixLength", 0),
    )


def _next_hop_to_wire(nh) -> Dict:
    out: Dict = {
        "address": _bin_addr_to_wire(nh.address),
        "weight": nh.weight,
        "metric": nh.metric,
    }
    if nh.area is not None:
        out["area"] = nh.area
    if nh.neighbor_node_name is not None:
        out["neighborNodeName"] = nh.neighbor_node_name
    if nh.mpls_action is not None:
        act: Dict = {"action": int(nh.mpls_action.action)}
        if nh.mpls_action.swap_label is not None:
            act["swapLabel"] = nh.mpls_action.swap_label
        if nh.mpls_action.push_labels is not None:
            act["pushLabels"] = list(nh.mpls_action.push_labels)
        out["mplsAction"] = act
    return out


def _next_hop_from_wire(d: Dict):
    from openr_tpu_torch.types import MplsAction, MplsActionCode, NextHop

    action = None
    act = d.get("mplsAction")
    if act is not None:
        action = MplsAction(
            action=MplsActionCode(act.get("action", 0)),
            swap_label=act.get("swapLabel"),
            push_labels=(
                tuple(act["pushLabels"])
                if act.get("pushLabels") is not None
                else None
            ),
        )
    return NextHop(
        address=_bin_addr_from_wire(d.get("address", {})),
        weight=d.get("weight", 0),
        mpls_action=action,
        metric=d.get("metric", 0),
        area=d.get("area"),
        neighbor_node_name=d.get("neighborNodeName"),
    )


def _unicast_route_to_wire(r) -> Dict:
    out: Dict = {
        "dest": _ip_prefix_to_wire(r.dest),
        "nextHops": [_next_hop_to_wire(nh) for nh in r.next_hops],
        "doNotInstall": r.do_not_install,
    }
    if r.admin_distance is not None:
        out["adminDistance"] = int(r.admin_distance)
    if r.prefix_type is not None:
        out["prefixType"] = int(r.prefix_type)
    if r.data is not None:
        out["data"] = r.data
    return out


def _unicast_route_from_wire(d: Dict):
    from openr_tpu_torch.types import AdminDistance, PrefixType, UnicastRoute

    return UnicastRoute(
        dest=_ip_prefix_from_wire(d.get("dest", {})),
        next_hops=tuple(
            _next_hop_from_wire(nh) for nh in d.get("nextHops", [])
        ),
        admin_distance=(
            AdminDistance(d["adminDistance"])
            if d.get("adminDistance") is not None
            else None
        ),
        prefix_type=(
            PrefixType(d["prefixType"])
            if d.get("prefixType") is not None
            else None
        ),
        data=d.get("data"),
        do_not_install=d.get("doNotInstall", False),
    )


def _mpls_route_to_wire(r) -> Dict:
    out: Dict = {
        "topLabel": r.top_label,
        "nextHops": [_next_hop_to_wire(nh) for nh in r.next_hops],
    }
    if r.admin_distance is not None:
        out["adminDistance"] = int(r.admin_distance)
    return out


def _mpls_route_from_wire(d: Dict):
    from openr_tpu_torch.types import AdminDistance, MplsRoute

    return MplsRoute(
        top_label=d.get("topLabel", 0),
        next_hops=tuple(
            _next_hop_from_wire(nh) for nh in d.get("nextHops", [])
        ),
        admin_distance=(
            AdminDistance(d["adminDistance"])
            if d.get("adminDistance") is not None
            else None
        ),
    )


# -- Lsdb.thrift schemas (the ctrl surface's adjacency/prefix dumps) -----

# reference: openr/if/Lsdb.thrift Adjacency (ids 1,2,3,5,4,6,7,8,9,10,11
# — declaration order has nextHopV4 at id 5 between 3 and 4)
ADJACENCY = StructSchema(
    "Adjacency",
    (
        Field(1, ("string",), "otherNodeName"),
        Field(2, ("string",), "ifName"),
        Field(3, ("struct", BINARY_ADDRESS), "nextHopV6"),
        Field(5, ("struct", BINARY_ADDRESS), "nextHopV4"),
        Field(4, ("i32",), "metric"),
        Field(6, ("i32",), "adjLabel"),
        Field(7, ("bool",), "isOverloaded"),
        Field(8, ("i32",), "rtt"),
        Field(9, ("i64",), "timestamp"),
        Field(10, ("i64",), "weight"),
        Field(11, ("string",), "otherIfName"),
    ),
)

# reference: openr/if/Lsdb.thrift AdjacencyDatabase (perfEvents omitted)
ADJACENCY_DATABASE = StructSchema(
    "AdjacencyDatabase",
    (
        Field(1, ("string",), "thisNodeName"),
        Field(2, ("bool",), "isOverloaded"),
        Field(3, ("list", ("struct", ADJACENCY)), "adjacencies"),
        Field(4, ("i32",), "nodeLabel"),
        Field(6, ("string",), "area"),
    ),
)

# reference: openr/if/Lsdb.thrift PrefixMetrics
PREFIX_METRICS = StructSchema(
    "PrefixMetrics",
    (
        Field(1, ("i32",), "version"),
        Field(2, ("i32",), "path_preference"),
        Field(3, ("i32",), "source_preference"),
        Field(4, ("i32",), "distance"),
    ),
)

# reference: openr/if/Lsdb.thrift PrefixEntry (declaration order
# 1,2,3,4,7,5,6,8,9,10,11,12; deprecated mv/ephemeral omitted)
PREFIX_ENTRY = StructSchema(
    "PrefixEntry",
    (
        Field(1, ("struct", IP_PREFIX), "prefix"),
        Field(2, ("i32",), "type"),
        Field(3, ("binary",), "data", optional=True),
        Field(4, ("i32",), "forwardingType"),
        Field(7, ("i32",), "forwardingAlgorithm"),
        Field(8, ("i64",), "minNexthop", optional=True),
        Field(9, ("i32",), "prependLabel", optional=True),
        Field(10, ("struct", PREFIX_METRICS), "metrics"),
        Field(11, ("set", ("string",)), "tags"),
        Field(12, ("list", ("string",)), "area_stack"),
    ),
)

# reference: openr/if/Lsdb.thrift PrefixDatabase (numbering intentional:
# 1,3,5,7; perfEvents omitted)
PREFIX_DATABASE = StructSchema(
    "PrefixDatabase",
    (
        Field(1, ("string",), "thisNodeName"),
        Field(3, ("list", ("struct", PREFIX_ENTRY)), "prefixEntries"),
        Field(5, ("bool",), "deletePrefix"),
        Field(7, ("string",), "area"),
    ),
)

# reference: openr/if/Fib.thrift RouteDatabase (perfEvents omitted)
ROUTE_DATABASE = StructSchema(
    "RouteDatabase",
    (
        Field(1, ("string",), "thisNodeName"),
        Field(4, ("list", ("struct", UNICAST_ROUTE)), "unicastRoutes"),
        Field(5, ("list", ("struct", MPLS_ROUTE)), "mplsRoutes"),
    ),
)

# reference: openr/if/KvStore.thrift PeerSpec
PEER_SPEC = StructSchema(
    "PeerSpec",
    (
        Field(1, ("string",), "peerAddr"),
        Field(2, ("string",), "cmdUrl"),
        Field(4, ("i32",), "ctrlPort"),
    ),
)

# reference: openr/if/Spark.thrift OpenrVersions
OPENR_VERSIONS = StructSchema(
    "OpenrVersions",
    (
        Field(1, ("i32",), "version"),
        Field(2, ("i32",), "lowestSupportedVersion"),
    ),
)

# reference: openr/if/OpenrCtrl.thrift exception OpenrError
OPENR_ERROR = StructSchema(
    "OpenrError", (Field(1, ("string",), "message"),)
)


def _adjacency_to_wire(a) -> Dict:
    return {
        "otherNodeName": a.other_node_name,
        "ifName": a.if_name,
        "nextHopV6": _bin_addr_to_wire(a.next_hop_v6),
        "nextHopV4": _bin_addr_to_wire(a.next_hop_v4),
        "metric": int(a.metric),
        "adjLabel": int(a.adj_label),
        "isOverloaded": bool(a.is_overloaded),
        "rtt": int(a.rtt),
        "timestamp": int(a.timestamp),
        "weight": int(a.weight),
        "otherIfName": a.other_if_name,
    }


def _adjacency_from_wire(d: Dict):
    from openr_tpu_torch.types import Adjacency

    return Adjacency(
        other_node_name=d.get("otherNodeName", ""),
        if_name=d.get("ifName", ""),
        next_hop_v6=_bin_addr_from_wire(d.get("nextHopV6", {})),
        next_hop_v4=_bin_addr_from_wire(d.get("nextHopV4", {})),
        metric=d.get("metric", 1),
        adj_label=d.get("adjLabel", 0),
        is_overloaded=d.get("isOverloaded", False),
        rtt=d.get("rtt", 0),
        timestamp=d.get("timestamp", 0),
        weight=d.get("weight", 1),
        other_if_name=d.get("otherIfName", ""),
    )


def adjacency_db_to_wire(db) -> Dict:
    return {
        "thisNodeName": db.this_node_name,
        "isOverloaded": bool(db.is_overloaded),
        "adjacencies": [
            _adjacency_to_wire(a) for a in db.adjacencies
        ],
        "nodeLabel": int(db.node_label),
        "area": db.area,
    }


def adjacency_db_from_wire(d: Dict):
    from openr_tpu_torch.types import AdjacencyDatabase

    return AdjacencyDatabase(
        this_node_name=d.get("thisNodeName", ""),
        is_overloaded=d.get("isOverloaded", False),
        adjacencies=tuple(
            _adjacency_from_wire(a) for a in d.get("adjacencies", [])
        ),
        node_label=d.get("nodeLabel", 0),
        area=d.get("area", "0"),
    )


def _prefix_entry_to_wire(e) -> Dict:
    out: Dict = {
        "prefix": _ip_prefix_to_wire(e.prefix),
        "type": int(e.type.value if hasattr(e.type, "value") else e.type),
        "forwardingType": int(
            e.forwarding_type.value
            if hasattr(e.forwarding_type, "value")
            else e.forwarding_type
        ),
        "forwardingAlgorithm": int(
            e.forwarding_algorithm.value
            if hasattr(e.forwarding_algorithm, "value")
            else e.forwarding_algorithm
        ),
        "metrics": {
            "version": e.metrics.version,
            "path_preference": e.metrics.path_preference,
            "source_preference": e.metrics.source_preference,
            "distance": e.metrics.distance,
        },
        "tags": sorted(e.tags),
        "area_stack": list(e.area_stack),
    }
    if e.data is not None:
        out["data"] = e.data
    if e.min_nexthop is not None:
        out["minNexthop"] = int(e.min_nexthop)
    if e.prepend_label is not None:
        out["prependLabel"] = int(e.prepend_label)
    return out


def _prefix_entry_from_wire(d: Dict):
    from openr_tpu_torch.types import (
        PrefixEntry,
        PrefixForwardingAlgorithm,
        PrefixForwardingType,
        PrefixMetrics,
        PrefixType,
    )

    m = d.get("metrics", {})
    return PrefixEntry(
        prefix=_ip_prefix_from_wire(d.get("prefix", {})),
        type=PrefixType(d.get("type", PrefixType.DEFAULT.value)),
        forwarding_type=PrefixForwardingType(d.get("forwardingType", 0)),
        forwarding_algorithm=PrefixForwardingAlgorithm(
            d.get("forwardingAlgorithm", 0)
        ),
        min_nexthop=d.get("minNexthop"),
        prepend_label=d.get("prependLabel"),
        metrics=PrefixMetrics(
            version=m.get("version", 1),
            path_preference=m.get("path_preference", 0),
            source_preference=m.get("source_preference", 0),
            distance=m.get("distance", 0),
        ),
        tags=tuple(sorted(d.get("tags", ()))),
        area_stack=tuple(d.get("area_stack", ())),
        data=d.get("data"),
    )


def prefix_db_to_wire(db) -> Dict:
    return {
        "thisNodeName": db.this_node_name,
        "prefixEntries": [
            _prefix_entry_to_wire(e) for e in db.prefix_entries
        ],
        "deletePrefix": bool(db.delete_prefix),
        "area": db.area,
    }


def prefix_db_from_wire(d: Dict):
    from openr_tpu_torch.types import PrefixDatabase

    return PrefixDatabase(
        this_node_name=d.get("thisNodeName", ""),
        prefix_entries=tuple(
            _prefix_entry_from_wire(e) for e in d.get("prefixEntries", [])
        ),
        delete_prefix=d.get("deletePrefix", False),
        area=d.get("area", "0"),
    )


def route_db_to_wire(db) -> Dict:
    return {
        "thisNodeName": db.this_node_name,
        "unicastRoutes": [
            _unicast_route_to_wire(r) for r in db.unicast_routes
        ],
        "mplsRoutes": [_mpls_route_to_wire(r) for r in db.mpls_routes],
    }


def route_db_from_wire(d: Dict):
    from openr_tpu_torch.types.fib import RouteDatabase

    return RouteDatabase(
        this_node_name=d.get("thisNodeName", ""),
        unicast_routes=[
            _unicast_route_from_wire(r)
            for r in d.get("unicastRoutes", [])
        ],
        mpls_routes=[
            _mpls_route_from_wire(r) for r in d.get("mplsRoutes", [])
        ],
    )


# -- Dual.thrift schemas (flood-optimization over the peer wire) ---------

# reference: openr/if/Dual.thrift:24-31
DUAL_MESSAGE = StructSchema(
    "DualMessage",
    (
        Field(1, ("string",), "dstId"),
        Field(2, ("i64",), "distance"),
        Field(3, ("i32",), "type"),
    ),
)

# reference: openr/if/Dual.thrift:33-38
DUAL_MESSAGES = StructSchema(
    "DualMessages",
    (
        Field(1, ("string",), "srcId"),
        Field(2, ("list", ("struct", DUAL_MESSAGE)), "messages"),
    ),
)

# reference: openr/if/KvStore.thrift:155-165
FLOOD_TOPO_SET_PARAMS = StructSchema(
    "FloodTopoSetParams",
    (
        Field(1, ("string",), "rootId"),
        Field(2, ("string",), "srcId"),
        Field(3, ("bool",), "setChild"),
        Field(4, ("bool",), "allRoots", optional=True),
    ),
)


def dual_messages_to_wire(src_id: str, msgs) -> Dict:
    return {
        "srcId": src_id,
        "messages": [
            {
                "dstId": m.dst_id,
                "distance": int(m.distance),
                "type": int(m.type),
            }
            for m in msgs
        ],
    }


def dual_messages_from_wire(d: Dict):
    from openr_tpu_torch.dual.dual import DualMessage, DualMessageType

    return d.get("srcId", ""), [
        DualMessage(
            dst_id=m.get("dstId", ""),
            distance=m.get("distance", 0),
            type=DualMessageType(m.get("type", 1)),
        )
        for m in d.get("messages", [])
    ]


# -- OpenrCtrl tail surface (perf, links, spark, spt, rib policy, ---------
# -- advertised/received routes, build info, areas, config) ---------------

# reference: openr/if/Lsdb.thrift:24-32
PERF_EVENT = StructSchema(
    "PerfEvent",
    (
        Field(1, ("string",), "nodeName"),
        Field(2, ("string",), "eventDescr"),
        Field(3, ("i64",), "unixTs"),
    ),
)

PERF_EVENTS = StructSchema(
    "PerfEvents",
    (Field(1, ("list", ("struct", PERF_EVENT)), "events"),),
)

# reference: openr/if/Fib.thrift:36-39
PERF_DATABASE = StructSchema(
    "PerfDatabase",
    (
        Field(1, ("string",), "thisNodeName"),
        Field(2, ("list", ("struct", PERF_EVENTS)), "eventInfo"),
    ),
)

# reference: openr/if/Lsdb.thrift:47-52
INTERFACE_INFO = StructSchema(
    "InterfaceInfo",
    (
        Field(1, ("bool",), "isUp"),
        Field(2, ("i64",), "ifIndex"),
        Field(5, ("list", ("struct", IP_PREFIX)), "networks"),
    ),
)

# reference: openr/if/LinkMonitor.thrift:18-23
INTERFACE_DETAILS = StructSchema(
    "InterfaceDetails",
    (
        Field(1, ("struct", INTERFACE_INFO), "info"),
        Field(2, ("bool",), "isOverloaded"),
        Field(3, ("i32",), "metricOverride", optional=True),
        Field(4, ("i64",), "linkFlapBackOffMs", optional=True),
    ),
)

# reference: openr/if/LinkMonitor.thrift:25-30 (numbering 1,3,6 is the
# IDL's own)
DUMP_LINKS_REPLY = StructSchema(
    "DumpLinksReply",
    (
        Field(1, ("string",), "thisNodeName"),
        Field(3, ("bool",), "isOverloaded"),
        Field(6, ("map", ("string",), ("struct", INTERFACE_DETAILS)),
              "interfaceDetails"),
    ),
)

# reference: openr/if/LinkMonitor.thrift:67-85
BUILD_INFO = StructSchema(
    "BuildInfo",
    (
        Field(1, ("string",), "buildUser"),
        Field(2, ("string",), "buildTime"),
        Field(3, ("i64",), "buildTimeUnix"),
        Field(4, ("string",), "buildHost"),
        Field(5, ("string",), "buildPath"),
        Field(6, ("string",), "buildRevision"),
        Field(7, ("i64",), "buildRevisionCommitTimeUnix"),
        Field(8, ("string",), "buildUpstreamRevision"),
        Field(9, ("i64",), "buildUpstreamRevisionCommitTimeUnix"),
        Field(10, ("string",), "buildPackageName"),
        Field(11, ("string",), "buildPackageVersion"),
        Field(12, ("string",), "buildPackageRelease"),
        Field(13, ("string",), "buildPlatform"),
        Field(14, ("string",), "buildRule"),
        Field(15, ("string",), "buildType"),
        Field(16, ("string",), "buildTool"),
        Field(17, ("string",), "buildMode"),
    ),
)

# reference: openr/if/Spark.thrift:141-171
SPARK_NEIGHBOR = StructSchema(
    "SparkNeighbor",
    (
        Field(1, ("string",), "nodeName"),
        Field(2, ("string",), "state"),
        Field(3, ("string",), "area"),
        Field(4, ("struct", BINARY_ADDRESS), "transportAddressV6"),
        Field(5, ("struct", BINARY_ADDRESS), "transportAddressV4"),
        Field(6, ("i32",), "openrCtrlThriftPort"),
        Field(7, ("i32",), "kvStoreCmdPort"),
        Field(8, ("string",), "remoteIfName"),
        Field(9, ("string",), "localIfName"),
        Field(10, ("i64",), "rttUs"),
        Field(11, ("i32",), "label"),
    ),
)

# reference: openr/if/KvStore.thrift:201-204
AREAS_CONFIG = StructSchema(
    "AreasConfig",
    (Field(1, ("set", ("string",)), "areas"),),
)

# reference: openr/if/KvStore.thrift:171-180
SPT_INFO = StructSchema(
    "SptInfo",
    (
        Field(1, ("bool",), "passive"),
        Field(2, ("i64",), "cost"),
        Field(3, ("string",), "parent", optional=True),
        Field(4, ("set", ("string",)), "children"),
    ),
)

# reference: openr/if/Dual.thrift:42-48
DUAL_PER_NEIGHBOR_COUNTERS = StructSchema(
    "DualPerNeighborCounters",
    (
        Field(1, ("i64",), "pktSent"),
        Field(2, ("i64",), "pktRecv"),
        Field(3, ("i64",), "msgSent"),
        Field(4, ("i64",), "msgRecv"),
    ),
)

# reference: openr/if/Dual.thrift:51-60
DUAL_PER_ROOT_COUNTERS = StructSchema(
    "DualPerRootCounters",
    (
        Field(1, ("i64",), "querySent"),
        Field(2, ("i64",), "queryRecv"),
        Field(3, ("i64",), "replySent"),
        Field(4, ("i64",), "replyRecv"),
        Field(5, ("i64",), "updateSent"),
        Field(6, ("i64",), "updateRecv"),
        Field(7, ("i64",), "totalSent"),
        Field(8, ("i64",), "totalRecv"),
    ),
)

# reference: openr/if/Dual.thrift:72-75
DUAL_COUNTERS = StructSchema(
    "DualCounters",
    (
        Field(1, ("map", ("string",),
                 ("struct", DUAL_PER_NEIGHBOR_COUNTERS)),
              "neighborCounters"),
        Field(2, ("map", ("string",),
                 ("map", ("string",),
                  ("struct", DUAL_PER_ROOT_COUNTERS))),
              "rootCounters"),
    ),
)

# reference: openr/if/KvStore.thrift:188-197
SPT_INFOS = StructSchema(
    "SptInfos",
    (
        Field(1, ("map", ("string",), ("struct", SPT_INFO)), "infos"),
        Field(2, ("struct", DUAL_COUNTERS), "counters"),
        Field(3, ("string",), "floodRootId", optional=True),
        Field(4, ("set", ("string",)), "floodPeers"),
    ),
)

# reference: openr/if/OpenrCtrl.thrift:31-68
NODE_AND_AREA = StructSchema(
    "NodeAndArea",
    (
        Field(1, ("string",), "node"),
        Field(2, ("string",), "area"),
    ),
)

ADVERTISED_ROUTE = StructSchema(
    "AdvertisedRoute",
    (
        Field(1, ("i32",), "key"),
        Field(2, ("struct", PREFIX_ENTRY), "route"),
    ),
)

ADVERTISED_ROUTE_DETAIL = StructSchema(
    "AdvertisedRouteDetail",
    (
        Field(1, ("struct", IP_PREFIX), "prefix"),
        Field(2, ("i32",), "bestKey"),
        Field(3, ("list", ("i32",)), "bestKeys"),
        Field(4, ("list", ("struct", ADVERTISED_ROUTE)), "routes"),
    ),
)

ADVERTISED_ROUTE_FILTER = StructSchema(
    "AdvertisedRouteFilter",
    (
        Field(1, ("list", ("struct", IP_PREFIX)), "prefixes",
              optional=True),
        Field(2, ("i32",), "prefixType", optional=True),
    ),
)

RECEIVED_ROUTE = StructSchema(
    "ReceivedRoute",
    (
        Field(1, ("struct", NODE_AND_AREA), "key"),
        Field(2, ("struct", PREFIX_ENTRY), "route"),
    ),
)

RECEIVED_ROUTE_DETAIL = StructSchema(
    "ReceivedRouteDetail",
    (
        Field(1, ("struct", IP_PREFIX), "prefix"),
        Field(2, ("struct", NODE_AND_AREA), "bestKey"),
        Field(3, ("list", ("struct", NODE_AND_AREA)), "bestKeys"),
        Field(4, ("list", ("struct", RECEIVED_ROUTE)), "routes"),
    ),
)

RECEIVED_ROUTE_FILTER = StructSchema(
    "ReceivedRouteFilter",
    (
        Field(1, ("list", ("struct", IP_PREFIX)), "prefixes",
              optional=True),
        Field(2, ("string",), "nodeName", optional=True),
        Field(3, ("string",), "areaName", optional=True),
    ),
)

# reference: openr/if/OpenrCtrl.thrift:84-162 (RibPolicy family)
RIB_ROUTE_MATCHER = StructSchema(
    "RibRouteMatcher",
    (Field(1, ("list", ("struct", IP_PREFIX)), "prefixes",
           optional=True),),
)

RIB_ROUTE_ACTION_WEIGHT = StructSchema(
    "RibRouteActionWeight",
    (
        Field(2, ("i32",), "default_weight"),
        Field(3, ("map", ("string",), ("i32",)), "area_to_weight"),
        Field(4, ("map", ("string",), ("i32",)), "neighbor_to_weight"),
    ),
)

RIB_ROUTE_ACTION = StructSchema(
    "RibRouteAction",
    (Field(1, ("struct", RIB_ROUTE_ACTION_WEIGHT), "set_weight",
           optional=True),),
)

RIB_POLICY_STATEMENT = StructSchema(
    "RibPolicyStatement",
    (
        Field(1, ("string",), "name"),
        Field(2, ("struct", RIB_ROUTE_MATCHER), "matcher"),
        Field(3, ("struct", RIB_ROUTE_ACTION), "action"),
    ),
)

RIB_POLICY = StructSchema(
    "RibPolicy",
    (
        Field(1, ("list", ("struct", RIB_POLICY_STATEMENT)),
              "statements"),
        Field(2, ("i32",), "ttl_secs"),
    ),
)

# reference: openr/if/OpenrConfig.thrift:176-180
AREA_CONFIG = StructSchema(
    "AreaConfig",
    (
        Field(1, ("string",), "area_id"),
        Field(2, ("list", ("string",)), "interface_regexes"),
        Field(3, ("list", ("string",)), "neighbor_regexes"),
    ),
)

# reference: openr/if/OpenrConfig.thrift:24-38
KVSTORE_CONFIG = StructSchema(
    "KvstoreConfig",
    (
        Field(1, ("i32",), "key_ttl_ms"),
        Field(2, ("i32",), "sync_interval_s"),
        Field(3, ("i32",), "ttl_decrement_ms"),
        Field(8, ("bool",), "enable_flood_optimization",
              optional=True),
        Field(9, ("bool",), "is_flood_root", optional=True),
    ),
)

# reference: openr/if/OpenrConfig.thrift:40-47
LINK_MONITOR_CONFIG = StructSchema(
    "LinkMonitorConfig",
    (
        Field(1, ("i32",), "linkflap_initial_backoff_ms"),
        Field(2, ("i32",), "linkflap_max_backoff_ms"),
        Field(3, ("bool",), "use_rtt_metric"),
        Field(4, ("list", ("string",)), "include_interface_regexes"),
        Field(5, ("list", ("string",)), "exclude_interface_regexes"),
        Field(6, ("list", ("string",)),
              "redistribute_interface_regexes"),
    ),
)

# reference: openr/if/OpenrConfig.thrift:57-68
SPARK_CONFIG = StructSchema(
    "SparkConfig",
    (
        Field(1, ("i32",), "neighbor_discovery_port"),
        Field(2, ("i32",), "hello_time_s"),
        Field(3, ("i32",), "fastinit_hello_time_ms"),
        Field(4, ("i32",), "keepalive_time_s"),
        Field(5, ("i32",), "hold_time_s"),
        Field(6, ("i32",), "graceful_restart_time_s"),
    ),
)

# reference: openr/if/OpenrConfig.thrift:70-74
WATCHDOG_CONFIG = StructSchema(
    "WatchdogConfig",
    (
        Field(1, ("i32",), "interval_s"),
        Field(2, ("i32",), "thread_timeout_s"),
        Field(3, ("i32",), "max_memory_mb"),
    ),
)

# reference: openr/if/OpenrConfig.thrift:238-314. The field ids cover
# the surface this framework models; ids absent here (BGP translation,
# originated prefixes, eor, prefix allocation details) are simply not
# emitted — a stock decoder applies IDL defaults, the same
# forward-compatibility contract this codec's own decoder honours.
OPENR_CONFIG = StructSchema(
    "OpenrConfig",
    (
        Field(1, ("string",), "node_name"),
        Field(2, ("string",), "domain"),
        Field(3, ("list", ("struct", AREA_CONFIG)), "areas"),
        Field(4, ("string",), "listen_addr"),
        Field(5, ("i32",), "openr_ctrl_port"),
        Field(6, ("bool",), "dryrun", optional=True),
        Field(7, ("bool",), "enable_v4", optional=True),
        Field(8, ("bool",), "enable_netlink_fib_handler",
              optional=True),
        Field(11, ("i32",), "prefix_forwarding_type"),
        Field(12, ("i32",), "prefix_forwarding_algorithm"),
        Field(13, ("bool",), "enable_segment_routing", optional=True),
        Field(15, ("struct", KVSTORE_CONFIG), "kvstore_config"),
        Field(16, ("struct", LINK_MONITOR_CONFIG),
              "link_monitor_config"),
        Field(17, ("struct", SPARK_CONFIG), "spark_config"),
        Field(18, ("bool",), "enable_watchdog", optional=True),
        Field(19, ("struct", WATCHDOG_CONFIG), "watchdog_config",
              optional=True),
        Field(22, ("bool",), "enable_ordered_fib_programming",
              optional=True),
        Field(24, ("bool",), "enable_rib_policy"),
        Field(51, ("bool",), "enable_best_route_selection"),
    ),
)

"""Canonical binary wire codec for openr-tpu message types.

Port note: a copy of ``openr_tpu/utils/wire.py``; nothing left out.

Plays the role the thrift binary protocol plays in the reference
(``openr/if/*.thrift`` generated serializers): every schema type in
``openr_tpu_torch.types`` round-trips through a deterministic, compact binary
encoding. Determinism matters because the KvStore CRDT merge breaks ties on
the *serialized value bytes* (reference: openr/kvstore/KvStore.cpp:263
``mergeKeyValues`` comparing ``value_ref()->compare(...)``), so two nodes
encoding the same logical object must produce identical bytes.

Encoding (tag byte + payload):
  N             None
  T / F         bool
  I <zigzag>    int (varint, zigzag for negatives)
  S <len> utf8  str
  B <len> raw   bytes
  L <n> items   list / tuple
  D <n> k v...  dict, entries sorted by encoded key
  O <name> <n> fields   dataclass: class name + field values in field order

Decoding is schema-directed: ``loads(data, cls)`` rebuilds ``cls`` using its
dataclass field types (Optional / Tuple / List / Dict supported), so frozen
dataclasses and IntEnums come back as the right Python types.
"""

from __future__ import annotations

import dataclasses
import enum
import typing
from typing import Any, Dict, Tuple, get_args, get_origin, get_type_hints


#: per-class field-order memo for the encode path (field order is
#: static; ``dataclasses.fields`` rebuilds the tuple on every call)
_FIELDS_MEMO: Dict[type, tuple] = {}


def _encode_varint(n: int, out: bytearray) -> None:
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _zigzag(n: int) -> int:
    return (n << 1) ^ (n >> 127) if n < 0 else (n << 1)


def _unzigzag(n: int) -> int:
    return (n >> 1) ^ -(n & 1)


def _encode(obj: Any, out: bytearray) -> None:
    if obj is None:
        out.append(ord("N"))
    elif obj is True:
        out.append(ord("T"))
    elif obj is False:
        out.append(ord("F"))
    elif isinstance(obj, enum.IntEnum):
        out.append(ord("I"))
        _encode_varint(_zigzag(int(obj)), out)
    elif isinstance(obj, int):
        out.append(ord("I"))
        _encode_varint(_zigzag(obj), out)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        out.append(ord("S"))
        _encode_varint(len(raw), out)
        out.extend(raw)
    elif isinstance(obj, (bytes, bytearray)):
        out.append(ord("B"))
        _encode_varint(len(obj), out)
        out.extend(obj)
    elif isinstance(obj, (list, tuple)):
        out.append(ord("L"))
        _encode_varint(len(obj), out)
        for item in obj:
            _encode(item, out)
    elif isinstance(obj, (dict,)):
        entries = []
        for k, v in obj.items():
            kb = bytearray()
            _encode(k, kb)
            vb = bytearray()
            _encode(v, vb)
            entries.append((bytes(kb), bytes(vb)))
        entries.sort()
        out.append(ord("D"))
        _encode_varint(len(entries), out)
        for kb, vb in entries:
            out.extend(kb)
            out.extend(vb)
    elif isinstance(obj, (set, frozenset)):
        items = []
        for item in obj:
            ib = bytearray()
            _encode(item, ib)
            items.append(bytes(ib))
        items.sort()
        out.append(ord("L"))
        _encode_varint(len(items), out)
        for ib in items:
            out.extend(ib)
    elif dataclasses.is_dataclass(obj):
        out.append(ord("O"))
        name = type(obj).__name__.encode("utf-8")
        _encode_varint(len(name), out)
        out.extend(name)
        flds = _FIELDS_MEMO.get(type(obj))
        if flds is None:
            flds = dataclasses.fields(obj)
            _FIELDS_MEMO[type(obj)] = flds
        _encode_varint(len(flds), out)
        for f in flds:
            _encode(getattr(obj, f.name), out)
    else:
        raise TypeError(f"wire: cannot encode {type(obj)!r}")


def dumps(obj: Any) -> bytes:
    out = bytearray()
    _encode(obj, out)
    return bytes(out)


class _Reader:
    __slots__ = ("data", "pos")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def byte(self) -> int:
        b = self.data[self.pos]
        self.pos += 1
        return b

    def varint(self) -> int:
        shift = 0
        result = 0
        while True:
            b = self.byte()
            result |= (b & 0x7F) << shift
            if not b & 0x80:
                return result
            shift += 7

    def raw(self, n: int) -> bytes:
        chunk = self.data[self.pos : self.pos + n]
        self.pos += n
        return chunk


#: per-class (type hints, fields) memo. ``get_type_hints`` re-evaluates
#: every stringified annotation (PEP 563) on each call — decoding one
#: 1000-adjacency AdjacencyDatabase would pay that eval per nested
#: Adjacency. Hints and field order are static per class; cache them.
_CLASS_MEMO: Dict[type, Tuple[Dict[str, Any], tuple]] = {}


def _class_memo(tp: type) -> Tuple[Dict[str, Any], tuple]:
    memo = _CLASS_MEMO.get(tp)
    if memo is None:
        memo = (get_type_hints(tp), dataclasses.fields(tp))
        _CLASS_MEMO[tp] = memo
    return memo


def _is_optional(tp) -> Tuple[bool, Any]:
    if get_origin(tp) is typing.Union:
        args = [a for a in get_args(tp) if a is not type(None)]
        if len(args) == 1:
            return True, args[0]
    return False, tp


def _decode(r: _Reader, tp: Any) -> Any:
    tag = r.byte()
    if tag == ord("N"):
        return None
    _, tp = _is_optional(tp)
    if tag == ord("T"):
        return True
    if tag == ord("F"):
        return False
    if tag == ord("I"):
        val = _unzigzag(r.varint())
        if isinstance(tp, type) and issubclass(tp, enum.IntEnum):
            return tp(val)
        return val
    if tag == ord("S"):
        return r.raw(r.varint()).decode("utf-8")
    if tag == ord("B"):
        return bytes(r.raw(r.varint()))
    if tag == ord("L"):
        n = r.varint()
        origin = get_origin(tp)
        args = get_args(tp)
        if origin in (list, typing.List):
            elem = args[0] if args else Any
            return [_decode(r, elem) for _ in range(n)]
        if origin in (set, frozenset):
            elem = args[0] if args else Any
            return {_decode(r, elem) for _ in range(n)}
        # default: tuple (covers Tuple[X, ...] and untyped)
        if args and len(args) == 2 and args[1] is Ellipsis:
            elem = args[0]
            return tuple(_decode(r, elem) for _ in range(n))
        elem_types = list(args) if args else [Any] * n
        if len(elem_types) < n:
            elem_types += [Any] * (n - len(elem_types))
        return tuple(_decode(r, elem_types[i]) for i in range(n))
    if tag == ord("D"):
        n = r.varint()
        args = get_args(tp)
        kt, vt = (args[0], args[1]) if len(args) == 2 else (Any, Any)
        return {_decode(r, kt): _decode(r, vt) for _ in range(n)}
    if tag == ord("O"):
        name = r.raw(r.varint()).decode("utf-8")
        nfields = r.varint()
        if not (dataclasses.is_dataclass(tp) and isinstance(tp, type)):
            raise TypeError(f"wire: object {name!r} but target type is {tp!r}")
        if tp.__name__ != name:
            raise TypeError(f"wire: expected {tp.__name__!r}, found {name!r}")
        hints, flds = _class_memo(tp)
        values: Dict[str, Any] = {}
        for i in range(nfields):
            if i < len(flds):
                f = flds[i]
                values[f.name] = _decode(r, hints.get(f.name, Any))
            else:  # forward compat: ignore unknown trailing fields
                _decode(r, Any)
        return tp(**values)
    raise ValueError(f"wire: bad tag {tag!r} at {r.pos - 1}")


def loads(data: bytes, cls: Any) -> Any:
    r = _Reader(data)
    obj = _decode(r, cls)
    if r.pos != len(data):
        raise ValueError(f"wire: trailing bytes ({len(data) - r.pos})")
    return obj


def generate_hash(version: int, originator_id: str, value: bytes | None) -> int:
    """Stable hash over (version, originatorId, value) used by KvStore
    anti-entropy sync. reference: openr/common/Util.h generateHash.

    64-bit FNV-1a over the canonical encoding; signed-int64 result so it can
    ride in the same field the reference uses (thrift i64).
    """
    payload = dumps([version, originator_id, value])
    h = 0xCBF29CE484222325
    for b in payload:
        h ^= b
        h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    # to signed 64-bit
    return h - (1 << 64) if h >= (1 << 63) else h

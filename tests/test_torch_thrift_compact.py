"""The port's Thrift CompactProtocol codec (``utils/thrift_compact.py``)
and Spark's thrift wire (``spark/thrift_wire.py``) against
``openr_tpu``'s, on the same inputs.

Each case builds the same value in both packages' types, and the bar is
bit-identity: the port's encoder must write the reference's bytes (the
golden vectors of ``tests/test_thrift_compact.py`` among them), and each
package must decode the other's bytes into its own equal value.
"""

from __future__ import annotations

import random
from types import SimpleNamespace

import pytest

import openr_tpu.types as jax_types
from openr_tpu.dual import dual as jax_dual
from openr_tpu.models import topologies as jax_topologies
from openr_tpu.types import fib as jax_fib
from openr_tpu.utils import thrift_compact as jax_tc
import openr_tpu_torch.types as port_types
from openr_tpu_torch.dual import dual as port_dual
from openr_tpu_torch.models import topologies as port_topologies
from openr_tpu_torch.types import fib as port_fib
from openr_tpu_torch.utils import thrift_compact as port_tc

PKGS = {
    "port": SimpleNamespace(tc=port_tc, T=port_types, fib=port_fib, dual=port_dual,
                            topologies=port_topologies),
    "jax": SimpleNamespace(tc=jax_tc, T=jax_types, fib=jax_fib, dual=jax_dual,
                           topologies=jax_topologies),
}


def both(make):
    """``make(pkg)`` in each package: (port value, reference value)."""
    return make(PKGS["port"]), make(PKGS["jax"])


# -- the golden vectors of tests/test_thrift_compact.py ---------------------

VALUE_GOLDEN = bytes([
    0x16, 0x02, 0x28, 0x05, 0x6E, 0x6F, 0x64, 0x65, 0x31, 0x08, 0x04, 0x02,
    0x68, 0x69, 0x26, 0xFF, 0xFF, 0xFF, 0xFF, 0x0F, 0x16, 0x00, 0x00,
])
EMPTY_PUBLICATION_GOLDEN = bytes([0x2B, 0x00, 0x19, 0x08, 0x48, 0x01, 0x30, 0x00])


def _value(p):
    return p.T.Value(version=1, originator_id="node1", value=b"hi",
                     ttl=p.T.TTL_INFINITY, ttl_version=0)


def _key_set_params(p):
    return p.T.KeySetParams(
        key_vals={"k": p.T.Value(version=2, originator_id="a", value=b"\x01", ttl=100,
                                 ttl_version=1, hash=42)},
        solicit_response=False, originator_id="a")


def _publication_full(p):
    return p.T.Publication(
        key_vals={
            f"adj:node-{i}": p.T.Value(version=i + 1, originator_id=f"node-{i}",
                                       value=bytes(range(i % 7)), ttl=3600_000,
                                       ttl_version=i, hash=(-1) ** i * i * 7919)
            for i in range(20)
        },
        expired_keys=["prefix:gone", "adj:dead"], nodes=["a", "b", "c"],
        tobe_updated_keys=["k1"], flood_root_id="root-1", area="area-51")


def _key_dump_params(p):
    return p.T.KeyDumpParams(
        prefix="adj:", originator_ids={"n1", "n2"}, keys=["adj:.*", "prefix:.*"],
        key_val_hashes={"adj:n1": p.T.Value(version=4, originator_id="n1", ttl=100,
                                            hash=123)})


CODECS = {
    # name: (make, encode, decode)
    "value": (_value, "encode_value", "decode_value"),
    "empty_publication": (lambda p: p.T.Publication(area="0"), "encode_publication",
                          "decode_publication"),
    "key_set_params": (_key_set_params, "encode_key_set_params", "decode_key_set_params"),
    "bool_true_in_header": (lambda p: p.T.KeySetParams(solicit_response=True),
                            "encode_key_set_params", "decode_key_set_params"),
    "publication_full": (_publication_full, "encode_publication", "decode_publication"),
    "key_dump_params": (_key_dump_params, "encode_key_dump_params",
                        "decode_key_dump_params"),
    "large_collections": (lambda p: p.T.Publication(
        expired_keys=[f"key-{i:04d}" for i in range(300)], area="0"),
        "encode_publication", "decode_publication"),
}


@pytest.mark.parametrize("name", sorted(CODECS))
def test_typed_codecs_write_the_same_bytes_and_read_each_other(name):
    make, enc, dec = CODECS[name]
    port_v, jax_v = both(make)
    port_bytes = getattr(port_tc, enc)(port_v)
    jax_bytes = getattr(jax_tc, enc)(jax_v)
    assert port_bytes == jax_bytes
    assert getattr(port_tc, dec)(jax_bytes) == port_v
    assert getattr(jax_tc, dec)(port_bytes) == jax_v


def test_golden_vectors():
    port_v, _ = both(_value)
    assert port_tc.encode_value(port_v) == VALUE_GOLDEN
    assert port_tc.decode_value(VALUE_GOLDEN) == port_v
    pub = port_types.Publication(area="0")
    assert port_tc.encode_publication(pub) == EMPTY_PUBLICATION_GOLDEN
    assert port_tc.encode_key_set_params(port_types.KeySetParams(solicit_response=True)) \
        == bytes([0x2B, 0x00, 0x11, 0x00])


@pytest.mark.parametrize("version", (0, 1, 2**31, 2**62))
def test_negative_and_large_ints(version):
    for ttl in (port_types.TTL_INFINITY, -1, 0, 1, 2**40):
        port_v, jax_v = both(lambda p: p.T.Value(version=version, originator_id="x", ttl=ttl))
        data = port_tc.encode_value(port_v)
        assert data == jax_tc.encode_value(jax_v)
        assert jax_tc.decode_value(data) == jax_v
        assert port_tc.decode_value(data) == port_v


def test_kvstore_request_envelope():
    req = {"cmd": port_tc.CMD_KEY_DUMP, "area": "0",
           "keyDumpParams": {"prefix": "", "originatorIds": set(), "ignoreTtl": True,
                             "doNotPublishValue": False}}
    data = port_tc.encode(port_tc.KV_STORE_REQUEST, req)
    assert data == jax_tc.encode(jax_tc.KV_STORE_REQUEST, req)
    assert port_tc.decode(port_tc.KV_STORE_REQUEST, data) == \
        jax_tc.decode(jax_tc.KV_STORE_REQUEST, data)


def test_bool_collections_and_their_skip():
    def schemas(tc):
        bag = tc.StructSchema("BoolBag", (tc.Field(1, ("list", ("bool",)), "flags"),
                                          tc.Field(2, ("string",), "tag", optional=True)))
        older = tc.StructSchema("Older", (tc.Field(2, ("string",), "tag", optional=True),))
        return bag, older

    data = {"flags": [True, False, True], "tag": "x"}
    (pb, po), (jb, jo) = schemas(port_tc), schemas(jax_tc)
    enc = port_tc.encode(pb, data)
    assert enc == jax_tc.encode(jb, data) == bytes(
        [0x19, 0x31, 0x01, 0x02, 0x01, 0x18, 0x01, 0x78, 0x00])
    assert port_tc.decode(po, enc) == jax_tc.decode(jo, enc) == {"tag": "x"}


def test_forward_compat_and_errors():
    def stream(tc):
        w = tc._Writer()
        w.byte(0x16)
        w.zigzag(9, 64)
        w.byte(0x0C)
        w.zigzag(100, 16)
        w.byte(0x16)
        w.zigzag(7, 64)
        w.byte(0x00)
        w.byte(0x08)
        w.zigzag(3, 16)
        w.binary(b"peer")
        w.byte(0x16)
        w.zigzag(60_000, 64)
        w.byte(0x00)
        return bytes(w.buf)

    data = stream(port_tc)
    assert data == stream(jax_tc)
    v = port_tc.decode_value(data)
    assert (v.version, v.originator_id, v.ttl) == (9, "peer", 60_000)
    assert jax_tc.decode_value(data).originator_id == "peer"
    with pytest.raises(ValueError):
        port_tc.encode(port_tc.VALUE, {"version": 1})
    short = port_tc.encode_value(port_types.Value(version=1, originator_id="n", ttl=5))[:-3]
    with pytest.raises((ValueError, IndexError)):
        port_tc.decode_value(short)
    with pytest.raises((ValueError, IndexError)):
        jax_tc.decode_value(short)


# -- the LSDB, route and DUAL schemas ----------------------------------------


def _fabric(p):
    return p.topologies.fat_tree(1, ssw_per_plane=2, fsw_per_pod=2, rsw_per_pod=3)


def _route_db(p):
    T = p.T
    nh = [T.NextHop(address=T.BinaryAddress.from_str(f"fe80::{i}"), weight=i, metric=i + 1,
                    area="0", neighbor_node_name=f"n{i}",
                    mpls_action=T.MplsAction(T.MplsActionCode.PUSH, push_labels=(100 + i,))
                    if i % 2 else None)
          for i in range(1, 4)]
    return p.fib.RouteDatabase(
        this_node_name="me",
        unicast_routes=[T.UnicastRoute(dest=T.IpPrefix.from_str(f"fd00:{i}::/64"),
                                       next_hops=tuple(nh[:i + 1]))
                        for i in range(3)],
        mpls_routes=[T.MplsRoute(top_label=60000 + i, next_hops=tuple(nh[i:]))
                     for i in range(2)])


def test_lsdb_schemas_write_the_same_bytes_and_read_each_other():
    port_topo, jax_topo = both(_fabric)
    assert sorted(port_topo.adj_dbs) == sorted(jax_topo.adj_dbs)
    for name in sorted(port_topo.adj_dbs):
        for schema, to_wire, from_wire, dbs in (
                ("ADJACENCY_DATABASE", "adjacency_db_to_wire", "adjacency_db_from_wire",
                 "adj_dbs"),
                ("PREFIX_DATABASE", "prefix_db_to_wire", "prefix_db_from_wire",
                 "prefix_dbs")):
            port_db = getattr(port_topo, dbs)[name]
            jax_db = getattr(jax_topo, dbs)[name]
            data = port_tc.encode(getattr(port_tc, schema), getattr(port_tc, to_wire)(port_db))
            assert data == jax_tc.encode(getattr(jax_tc, schema),
                                         getattr(jax_tc, to_wire)(jax_db)), (name, schema)
            assert getattr(port_tc, from_wire)(port_tc.decode(getattr(port_tc, schema),
                                                              data)) == port_db
            assert getattr(jax_tc, from_wire)(jax_tc.decode(getattr(jax_tc, schema),
                                                            data)) == jax_db


def test_route_database_and_dual_messages():
    port_db, jax_db = both(_route_db)
    data = port_tc.encode(port_tc.ROUTE_DATABASE, port_tc.route_db_to_wire(port_db))
    assert data == jax_tc.encode(jax_tc.ROUTE_DATABASE, jax_tc.route_db_to_wire(jax_db))
    assert port_tc.route_db_from_wire(port_tc.decode(port_tc.ROUTE_DATABASE, data)) == port_db
    assert jax_tc.route_db_from_wire(jax_tc.decode(jax_tc.ROUTE_DATABASE, data)) == jax_db

    def msgs(p):
        return [p.dual.DualMessage(dst_id=f"root-{i}", distance=i * 3, type=t)
                for i, t in enumerate(p.dual.DualMessageType)]

    port_m, jax_m = both(msgs)
    data = port_tc.encode(port_tc.DUAL_MESSAGES, port_tc.dual_messages_to_wire("src", port_m))
    assert data == jax_tc.encode(jax_tc.DUAL_MESSAGES, jax_tc.dual_messages_to_wire("src", jax_m))
    assert port_tc.dual_messages_from_wire(port_tc.decode(port_tc.DUAL_MESSAGES, data)) == \
        ("src", port_m)
    assert jax_tc.dual_messages_from_wire(jax_tc.decode(jax_tc.DUAL_MESSAGES, data)) == \
        ("src", jax_m)


# -- randomized schemas: the fuzz of tests/test_thrift_compact.py -------------


def _random_type(rng, depth):
    kinds = ["bool", "byte", "i16", "i32", "i64", "string", "binary"]
    if depth < 2:
        kinds += ["list", "set", "map", "struct"]
    kind = rng.choice(kinds)
    if kind in ("list", "set"):
        return (kind, _random_type(rng, 2 if kind == "set" else depth + 1))
    if kind == "map":
        return ("map", _random_type(rng, 2), _random_type(rng, depth + 1))
    if kind == "struct":
        return ("struct", _random_fields(rng, depth + 1))
    return (kind,)


def _random_fields(rng, depth=0):
    """A schema as plain tuples: (fid, type, name, optional) each, a
    nested struct's type holding its own fields."""
    fields, fid = [], 0
    for _ in range(rng.randint(1, 5)):
        fid += rng.randint(1, 40)
        fields.append((fid, _random_type(rng, depth), f"f{fid}", rng.random() < 0.3))
    return tuple(fields)


def _schema(tc, fields, name="S"):
    def ftype(t):
        if t[0] == "struct":
            return ("struct", _schema(tc, t[1]))
        return (t[0],) + tuple(ftype(x) for x in t[1:])

    return tc.StructSchema(name, tuple(tc.Field(fid, ftype(t), n, optional=o)
                                       for fid, t, n, o in fields))


def _random_value(rng, t):
    kind = t[0]
    if kind == "bool":
        return rng.random() < 0.5
    if kind == "byte":
        return rng.randint(-128, 127)
    if kind in ("i16", "i32", "i64"):
        bits = {"i16": 15, "i32": 31, "i64": 63}[kind]
        return rng.randint(-(2 ** bits), 2 ** bits - 1)
    if kind == "string":
        return "".join(rng.choice("abcdefg é中") for _ in range(rng.randint(0, 20)))
    if kind == "binary":
        return bytes(rng.randint(0, 255) for _ in range(rng.randint(0, 40)))
    if kind == "list":
        return [_random_value(rng, t[1]) for _ in range(rng.randint(0, 17))]
    if kind == "set":
        return {_random_value(rng, t[1]) for _ in range(rng.randint(0, 17))}
    if kind == "map":
        return {_random_value(rng, t[1]): _random_value(rng, t[2])
                for _ in range(rng.randint(0, 9))}
    return _struct_value(rng, t[1])


def _struct_value(rng, fields):
    return {n: _random_value(rng, t) for fid, t, n, o in fields
            if not (o and rng.random() < 0.4)}


@pytest.mark.parametrize("seed", (0xC0DEC, 0x5EED))
def test_random_schemas_write_the_same_bytes_and_skip_unknown_fields(seed):
    rng = random.Random(seed)
    for _ in range(100):
        fields = _random_fields(rng)
        value = _struct_value(rng, fields)
        sentinel = max(f[0] for f in fields) + 1
        full = fields + ((sentinel, ("i32",), "sentinel", False),)
        value["sentinel"] = 777
        data = port_tc.encode(_schema(port_tc, full), value)
        assert data == jax_tc.encode(_schema(jax_tc, full), value)
        assert port_tc.decode(_schema(port_tc, full), data) == value
        assert jax_tc.decode(_schema(jax_tc, full), data) == value
        # a reader that knows only the trailing sentinel skips the rest
        reduced = ((sentinel, ("i32",), "sentinel", False),)
        assert port_tc.decode(_schema(port_tc, reduced), data) == {"sentinel": 777}

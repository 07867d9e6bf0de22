"""The port's configuration (``config/config.py``) and BGP peering
configuration (``config/bgp_config.py``) against ``openr_tpu``'s.

The same JSON documents go through both packages: a valid one must parse
to the same ``to_dict()`` (so JSON round-trips, ``enable_solver_mesh``
included), and each package must load the other's serialization; an
invalid one must be refused by both with the same message. The queries
(area and interface matching, flood rate, resolved BGP peers) must
answer alike. The legacy flag shim (``config/gflags.py``) is not ported.
"""

from __future__ import annotations

import json

import pytest

from openr_tpu.config import bgp_config as jax_bgp
from openr_tpu.config import config as jax_config
from openr_tpu_torch.config import bgp_config as port_bgp
from openr_tpu_torch.config import config as port_config

BGP = {"router_id": "10.0.0.1", "local_as": 65001, "hold_time": 90,
       "peer_groups": [{"name": "spine", "remote_as": 65000, "next_hop_self": True,
                        "bgp_peer_timers": {"hold_time_seconds": 90, "keep_alive_seconds": 30},
                        "add_path": "BOTH"}],
       "peers": [{"peer_addr": "10.0.1.2", "peer_group_name": "spine"},
                 {"peer_addr": "fc00::2", "remote_as": 65002,
                  "advertise_link_bandwidth": "AGGREGATE", "pre_filter": {"max_routes": 500}},
                 {"peer_addr": "10.0.9.0/24", "remote_as": 65003, "is_passive": True}]}

VALID = {
    "minimal": {"node_name": "node-1"},
    "areas": {"node_name": "fc001",
              "areas": [{"area_id": "spine", "neighbor_regexes": ["ssw.*"],
                         "include_interface_regexes": ["eth.*"]},
                        {"area_id": "pod", "neighbor_regexes": ["rsw-.*"],
                         "exclude_interface_regexes": ["eth99"]}],
              "enable_v4": True, "prefix_forwarding_type": "SR_MPLS"},
    "ksp2": {"node_name": "n", "prefix_forwarding_algorithm": "KSP2_ED_ECMP",
             "prefix_forwarding_type": "SR_MPLS", "enable_segment_routing": True,
             "node_label": 101},
    "modules": {"node_name": "n2",
                "spark": {"hello_time_s": 5.0, "keepalive_time_s": 1.0, "hold_time_s": 10.0,
                          "graceful_restart_time_s": 30.0, "wire_format": "thrift"},
                "kvstore": {"flood_msg_per_sec": 100, "flood_msg_burst_size": 50,
                            "enable_flood_optimization": True, "is_flood_root": True},
                "decision": {"debounce_min_ms": 5, "debounce_max_ms": 100,
                             "enable_bgp_route_programming": False},
                "link_monitor": {"use_rtt_metric": True},
                "watchdog": {"interval_s": 5.0},
                "prefix_alloc": {"enabled": True, "seed_prefix": "fd00:cafe::/56",
                                 "alloc_prefix_len": 64, "set_loopback_addr": True},
                "enable_solver_mesh": True, "solver_backend": "host"},
    "bgp": {"node_name": "n1", "bgp_config": BGP},
}

INVALID = {
    "no_node_name": {"node_name": ""},
    "bad_charset": {"node_name": "bad name"},
    "colon": {"node_name": "bad:name"},
    "duplicate_areas": {"node_name": "n", "areas": [{"area_id": "a"}, {"area_id": "a"}]},
    "hold_time": {"node_name": "n", "spark": {"keepalive_time_s": 5.0, "hold_time_s": 10.0}},
    "wire_format": {"node_name": "n", "spark": {"wire_format": "xml"}},
    "ksp2_without_sr": {"node_name": "n", "prefix_forwarding_algorithm": "KSP2_ED_ECMP"},
    "partial_flood_rate": {"node_name": "n", "kvstore": {"flood_msg_per_sec": 100}},
    "debounce": {"node_name": "n", "decision": {"debounce_min_ms": 300}},
    "seed_prefix": {"node_name": "n", "prefix_alloc": {"enabled": True,
                                                       "seed_prefix": "fd00::/64",
                                                       "alloc_prefix_len": 48}},
    "bgp_router_id": {"node_name": "n", "bgp_config": {"router_id": "", "local_as": 0}},
    "bgp_remote_as": {"node_name": "n", "bgp_config": {
        "router_id": "1.1.1.1", "local_as": 1, "peers": [{"peer_addr": "10.0.0.2"}]}},
    "bgp_unknown_group": {"node_name": "n", "bgp_config": {
        "router_id": "1.1.1.1", "local_as": 1,
        "peers": [{"peer_addr": "10.0.0.2", "remote_as": 1, "peer_group_name": "missing"}]}},
    "bgp_prefix_not_passive": {"node_name": "n", "bgp_config": {
        "router_id": "1.1.1.1", "local_as": 1,
        "peers": [{"peer_addr": "10.0.0.0/24", "remote_as": 2}]}},
    "bgp_duplicate_peers": {"node_name": "n", "bgp_config": {
        "router_id": "1.1.1.1", "local_as": 1,
        "peers": [{"peer_addr": "10.0.0.2", "remote_as": 1},
                  {"peer_addr": "10.0.0.2", "remote_as": 2}]}},
}


@pytest.mark.parametrize("name", sorted(VALID))
def test_valid_documents_parse_and_serialize_as_the_reference(name, tmp_path):
    doc = json.loads(json.dumps(VALID[name]))
    port_cfg = port_config.OpenrConfig.from_dict(doc)
    jax_cfg = jax_config.OpenrConfig.from_dict(json.loads(json.dumps(VALID[name])))
    port_dict = port_cfg.to_dict()
    assert json.dumps(port_dict, sort_keys=True) == json.dumps(jax_cfg.to_dict(), sort_keys=True)
    # each package loads the other's serialization, from a file too
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(port_dict))
    assert jax_config.OpenrConfig.from_file(str(path)).to_dict() == jax_cfg.to_dict()
    path.write_text(json.dumps(jax_cfg.to_dict()))
    assert port_config.OpenrConfig.from_file(str(path)).to_dict() == port_dict
    assert port_cfg.area_ids() == jax_cfg.area_ids()
    assert port_cfg.is_bgp_peering_enabled() == jax_cfg.is_bgp_peering_enabled()
    assert port_cfg.kvstore.flood_rate() == jax_cfg.kvstore.flood_rate()
    for nbr in ("ssw-1-2", "rsw-0-1", "other"):
        assert port_cfg.area_for_neighbor(nbr) == jax_cfg.area_for_neighbor(nbr)
    for area_p, area_j in zip(port_cfg.areas, jax_cfg.areas):
        for iface in ("eth0", "eth99", "lo", "po1"):
            assert area_p.matches_interface(iface) == area_j.matches_interface(iface)


@pytest.mark.parametrize("name", sorted(INVALID))
def test_invalid_documents_are_refused_as_by_the_reference(name):
    errors = []
    for config, bgp in ((port_config, port_bgp), (jax_config, jax_bgp)):
        with pytest.raises((config.ConfigError, bgp.BgpConfigError)) as info:
            config.OpenrConfig.from_dict(json.loads(json.dumps(INVALID[name])))
        errors.append((type(info.value).__name__, str(info.value)))
    assert errors[0] == errors[1]


def test_bgp_config_resolves_peers_as_the_reference():
    port_cfg = port_bgp.BgpConfig.from_dict(json.loads(json.dumps(BGP)))
    jax_cfg = jax_bgp.BgpConfig.from_dict(json.loads(json.dumps(BGP)))
    assert (port_cfg.listen_port, port_cfg.eor_time_s) == (jax_cfg.listen_port, jax_cfg.eor_time_s)
    port_peers, jax_peers = port_cfg.resolved_peers(), jax_cfg.resolved_peers()
    assert [repr(p) for p in port_peers] == [repr(p) for p in jax_peers]
    assert port_peers[0].remote_as == 65000 and port_peers[0].add_path.name == "BOTH"
    assert port_peers[1].advertise_link_bandwidth.name == "AGGREGATE"
    # a peer's own value beats its group's
    cfgs = [b.BgpConfig(router_id="1.1.1.1", local_as=65001,
                        peer_groups=[b.PeerGroup(name="g", remote_as=65000, local_as=64999)],
                        peers=[b.BgpPeer(peer_addr="10.0.0.9", peer_group_name="g",
                                         local_as=65010)])
            for b in (port_bgp, jax_bgp)]
    (pp,), (jp,) = cfgs[0].resolved_peers(), cfgs[1].resolved_peers()
    assert (pp.local_as, pp.remote_as) == (jp.local_as, jp.remote_as) == (65010, 65000)
    for b in (port_bgp, jax_bgp):
        with pytest.raises(b.BgpConfigError, match="3x"):
            b.BgpPeerTimers(hold_time_seconds=20, keep_alive_seconds=10).validate()

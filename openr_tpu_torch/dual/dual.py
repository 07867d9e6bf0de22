"""DUAL: Diffusing Update Algorithm (loop-free distributed shortest paths).

Behavioral parity with the reference ``openr/dual/Dual.{h,cpp}`` (EIGRP's
DUAL per the JJGLA'93 paper), which KvStore uses to constrain flooding to
a per-root spanning tree (reference: KvStore.h:202 DualNode inheritance):

- feasibility condition: a neighbor is adoptable by *local* computation
  only if its reported distance is strictly below the feasible distance
  AND it attains the current minimum (Dual.cpp:149 meetFeasibleCondition)
- otherwise a *diffusing* computation starts: the node freezes its
  reported distance at the value via its CURRENT successor (infinity if
  the successor died — this poisons downstream instead of counting up),
  queries every up neighbor, and stays ACTIVE until the last reply
  (Dual.cpp:214 diffusingComputation, :636 processReply)
- a query from the current successor received while passive joins the
  diffusion and defers its reply until convergence (the "cornet" stack);
  all other queries are answered immediately (Dual.cpp:597 processQuery)
- the ACTIVE0-3 sub-state machine tracks how the computation originated
  (Dual.cpp:20 DualStateMachine::processEvent)
- per-root trees: DualNode coordinates one Dual per root and elects the
  flood root as the smallest ready root id; sptPeers = {parent} ∪ children
  (children are registered by dependents via flood-topo messages)

Message types (reference: openr/if/Dual.thrift): UPDATE / QUERY / REPLY.

Port note: a copy of ``openr_tpu/dual/dual.py``; nothing left out. The
port's KvStore imports it lazily for its flood optimisation, as the
reference's does.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set, Tuple

INFINITY = (1 << 63) - 1


class DualMessageType(enum.IntEnum):
    UPDATE = 1
    QUERY = 2
    REPLY = 3


@dataclass
class DualMessage:
    """reference: openr/if/Dual.thrift:24 DualMessage."""

    dst_id: str  # the root this message concerns
    distance: int
    type: DualMessageType


# outgoing message batches: neighbor -> [messages]
MsgsToSend = Dict[str, List[DualMessage]]


class DualState(enum.IntEnum):
    """reference: Dual.h DualState."""

    ACTIVE0 = 0
    ACTIVE1 = 1
    ACTIVE2 = 2
    ACTIVE3 = 3
    PASSIVE = 4


class DualEvent(enum.IntEnum):
    """reference: Dual.h DualEvent."""

    QUERY_FROM_SUCCESSOR = 0
    LAST_REPLY = 1
    INCREASE_D = 2
    OTHERS = 3


class DualStateMachine:
    """reference: Dual.cpp:20 DualStateMachine::processEvent."""

    def __init__(self) -> None:
        self.state = DualState.PASSIVE

    def process_event(self, event: DualEvent, fc: bool = True) -> None:
        s, e = self.state, event
        if s == DualState.PASSIVE:
            if fc:
                return
            self.state = (
                DualState.ACTIVE3
                if e == DualEvent.QUERY_FROM_SUCCESSOR
                else DualState.ACTIVE1
            )
        elif s == DualState.ACTIVE0:
            if e == DualEvent.LAST_REPLY:
                self.state = DualState.PASSIVE if fc else DualState.ACTIVE2
        elif s == DualState.ACTIVE1:
            if e == DualEvent.INCREASE_D:
                self.state = DualState.ACTIVE0
            elif e == DualEvent.LAST_REPLY:
                self.state = DualState.PASSIVE
            elif e == DualEvent.QUERY_FROM_SUCCESSOR:
                self.state = DualState.ACTIVE2
        elif s == DualState.ACTIVE2:
            if e == DualEvent.LAST_REPLY:
                self.state = DualState.PASSIVE if fc else DualState.ACTIVE3
        elif s == DualState.ACTIVE3:
            if e == DualEvent.LAST_REPLY:
                self.state = DualState.PASSIVE
            elif e == DualEvent.INCREASE_D:
                self.state = DualState.ACTIVE2


@dataclass
class NeighborInfo:
    """reference: Dual.h NeighborInfo."""

    report_distance: int = INFINITY
    expect_reply: bool = False
    need_to_reply: bool = False


def _add(d1: int, d2: int) -> int:
    """Saturating add (reference: Dual.cpp:393 addDistances)."""
    if d1 == INFINITY or d2 == INFINITY:
        return INFINITY
    return d1 + d2


class Dual:
    """One node's DUAL instance for one root (reference: Dual.h:66)."""

    def __init__(
        self,
        node_id: str,
        root_id: str,
        local_distances: Optional[Dict[str, int]] = None,
        nexthop_change_cb: Optional[
            Callable[[Optional[str], Optional[str]], None]
        ] = None,
    ):
        self.node_id = node_id
        self.root_id = root_id
        self.local_distances: Dict[str, int] = dict(local_distances or {})
        self.neighbor_infos: Dict[str, NeighborInfo] = {
            n: NeighborInfo() for n in self.local_distances
        }
        self.sm = DualStateMachine()
        self._cb = nexthop_change_cb
        self.children_: Set[str] = set()
        # the reply-owed stack: queries whose replies are pending
        self.cornet: List[str] = []
        if node_id == root_id:
            self.distance = 0
            self.report_distance = 0
            self.feasible_distance = 0
            self.nexthop: Optional[str] = node_id
        else:
            self.distance = INFINITY
            self.report_distance = INFINITY
            self.feasible_distance = INFINITY
            self.nexthop = None

    # -- state helpers ----------------------------------------------------

    @property
    def state(self) -> DualState:
        return self.sm.state

    def _neighbor_up(self, neighbor: str) -> bool:
        return self.local_distances.get(neighbor, INFINITY) != INFINITY

    def _set_nexthop(self, new_nh: Optional[str]) -> None:
        if new_nh != self.nexthop:
            old = self.nexthop
            self.nexthop = new_nh
            if self._cb is not None:
                self._cb(old, new_nh)

    def get_min_distance(self) -> int:
        """reference: Dual.cpp:84 getMinDistance."""
        if self.node_id == self.root_id:
            return 0
        dmin = INFINITY
        for n, ld in self.local_distances.items():
            rd = self.neighbor_infos[n].report_distance
            dmin = min(dmin, _add(ld, rd))
        return dmin

    def route_affected(self) -> bool:
        """reference: Dual.cpp:100 routeAffected."""
        if not self.local_distances:
            return False
        if self.nexthop == self.node_id:
            return False  # I am the root
        dmin = self.get_min_distance()
        if self.distance != dmin:
            return True
        if dmin == INFINITY:
            return False  # no valid route, nothing new
        if self.nexthop is None:
            return True
        # nexthop no longer on a min-distance path?
        min_nexthops = {
            n
            for n, ld in self.local_distances.items()
            if _add(ld, self.neighbor_infos[n].report_distance) == dmin
        }
        return self.nexthop not in min_nexthops

    def meet_feasible_condition(self) -> Tuple[bool, Optional[str], int]:
        """FC: some up neighbor with rd < FD attaining the minimum.
        reference: Dual.cpp:149 meetFeasibleCondition."""
        dmin = self.get_min_distance()
        for n in sorted(self.local_distances):
            ld = self.local_distances[n]
            if ld == INFINITY:
                continue
            rd = self.neighbor_infos[n].report_distance
            if rd < self.feasible_distance and _add(ld, rd) == dmin:
                return True, n, dmin
        return False, None, dmin

    # -- message emission -------------------------------------------------

    def _emit(self, msgs: MsgsToSend, neighbor: str,
              mtype: DualMessageType, distance: int) -> None:
        msgs.setdefault(neighbor, []).append(
            DualMessage(dst_id=self.root_id, distance=distance, type=mtype)
        )

    def flood_updates(self, msgs: MsgsToSend) -> None:
        """reference: Dual.cpp:172 floodUpdates."""
        for n, ld in self.local_distances.items():
            if ld == INFINITY:
                continue
            self._emit(msgs, n, DualMessageType.UPDATE, self.report_distance)

    def send_reply(self, msgs: MsgsToSend) -> None:
        """Pop the reply-owed stack (reference: Dual.cpp:567 sendReply)."""
        assert self.cornet, "send_reply with empty cornet"
        dst = self.cornet.pop()
        if not self._neighbor_up(dst):
            # owed a reply but the link is down on our end: defer until
            # the link comes back (peerUp flushes need_to_reply)
            self.neighbor_infos.setdefault(dst, NeighborInfo()).need_to_reply = True
            return
        self._emit(msgs, dst, DualMessageType.REPLY, self.report_distance)

    # -- computations -----------------------------------------------------

    def local_computation(
        self, new_nexthop: str, new_distance: int, msgs: MsgsToSend
    ) -> None:
        """reference: Dual.cpp:192 localComputation."""
        same_rd = new_distance == self.report_distance
        self._set_nexthop(new_nexthop)
        self.distance = new_distance
        self.report_distance = new_distance
        self.feasible_distance = new_distance
        if not same_rd:
            self.flood_updates(msgs)

    def diffusing_computation(self, msgs: MsgsToSend) -> bool:
        """Freeze the reported distance at the value via the CURRENT
        successor (infinity when it died — poisoning downstream rather
        than counting up) and query all up neighbors.
        reference: Dual.cpp:214 diffusingComputation."""
        assert self.nexthop is not None
        ld = self.local_distances.get(self.nexthop, INFINITY)
        rd = self.neighbor_infos[self.nexthop].report_distance
        new_distance = _add(ld, rd)
        self.distance = new_distance
        self.report_distance = new_distance
        self.feasible_distance = new_distance

        success = False
        for n, cost in self.local_distances.items():
            if cost == INFINITY:
                continue
            self._emit(msgs, n, DualMessageType.QUERY, self.report_distance)
            self.neighbor_infos[n].expect_reply = True
            success = True
        return success

    def try_local_or_diffusing(
        self, event: DualEvent, need_reply: bool, msgs: MsgsToSend
    ) -> None:
        """reference: Dual.cpp:249 tryLocalOrDiffusing."""
        if not self.route_affected():
            if need_reply:
                self.send_reply(msgs)
            return
        fc, new_nh, new_dist = self.meet_feasible_condition()
        if fc:
            self.local_computation(new_nh, new_dist, msgs)
            if need_reply:
                self.send_reply(msgs)
        else:
            if need_reply and event != DualEvent.QUERY_FROM_SUCCESSOR:
                # queries from non-successors are answered before diffusing
                self.send_reply(msgs)
            if self.nexthop is None:
                # nowhere to even freeze a distance from: unreachable
                self.distance = INFINITY
                self.report_distance = INFINITY
                self.feasible_distance = INFINITY
                return
            if self.diffusing_computation(msgs):
                self.sm.process_event(event, False)
            if self.nexthop is not None and not self._neighbor_up(self.nexthop):
                self._set_nexthop(None)

    # -- peer events ------------------------------------------------------

    def peer_up(self, neighbor: str, cost: int, msgs: MsgsToSend) -> None:
        """reference: Dual.cpp:401 peerUp."""
        if self.nexthop == neighbor:
            # non-graceful bounce: as-if a peer-down had happened first
            self._set_nexthop(None)
            self.distance = INFINITY
        self.local_distances[neighbor] = cost
        self.neighbor_infos.setdefault(neighbor, NeighborInfo())

        if self.sm.state == DualState.PASSIVE:
            self.try_local_or_diffusing(DualEvent.OTHERS, False, msgs)
        else:
            if self.neighbor_infos[neighbor].expect_reply:
                # the neighbor we awaited came back: treat as its reply
                self.process_reply(
                    neighbor,
                    DualMessage(
                        dst_id=self.root_id,
                        distance=self.neighbor_infos[neighbor].report_distance,
                        type=DualMessageType.REPLY,
                    ),
                    msgs,
                )
        # introduce ourselves
        self._emit(msgs, neighbor, DualMessageType.UPDATE,
                   self.report_distance)
        if self.neighbor_infos[neighbor].need_to_reply:
            self.neighbor_infos[neighbor].need_to_reply = False
            self._emit(msgs, neighbor, DualMessageType.REPLY,
                       self.report_distance)

    def peer_down(self, neighbor: str, msgs: MsgsToSend) -> None:
        """reference: Dual.cpp:466 peerDown."""
        self.remove_child(neighbor)
        self.local_distances[neighbor] = INFINITY
        info = self.neighbor_infos.setdefault(neighbor, NeighborInfo())
        info.report_distance = INFINITY
        if self.sm.state == DualState.PASSIVE:
            self.try_local_or_diffusing(DualEvent.INCREASE_D, False, msgs)
        else:
            self.sm.process_event(DualEvent.INCREASE_D)
            if info.expect_reply:
                # a dead neighbor's reply is an implicit infinity reply
                self.process_reply(
                    neighbor,
                    DualMessage(
                        dst_id=self.root_id,
                        distance=INFINITY,
                        type=DualMessageType.REPLY,
                    ),
                    msgs,
                )

    def peer_cost_change(self, neighbor: str, cost: int,
                         msgs: MsgsToSend) -> None:
        """reference: Dual.cpp:505 peerCostChange."""
        event = (
            DualEvent.INCREASE_D
            if cost > self.local_distances.get(neighbor, INFINITY)
            else DualEvent.OTHERS
        )
        self.local_distances[neighbor] = cost
        self.neighbor_infos.setdefault(neighbor, NeighborInfo())
        if self.sm.state == DualState.PASSIVE:
            self.try_local_or_diffusing(event, False, msgs)
        else:
            if self.nexthop == neighbor:
                self.distance = _add(
                    cost, self.neighbor_infos[neighbor].report_distance
                )
            self.sm.process_event(event)

    # -- message processing -----------------------------------------------

    def process_update(self, neighbor: str, msg: DualMessage,
                       msgs: MsgsToSend) -> None:
        """reference: Dual.cpp:530 processUpdate."""
        self.neighbor_infos.setdefault(
            neighbor, NeighborInfo()
        ).report_distance = msg.distance
        if neighbor not in self.local_distances:
            return  # UPDATE before LINK-UP
        if self.sm.state == DualState.PASSIVE:
            self.try_local_or_diffusing(DualEvent.OTHERS, False, msgs)
        else:
            if self.nexthop == neighbor:
                self.distance = _add(
                    self.local_distances[neighbor], msg.distance
                )
            self.sm.process_event(DualEvent.OTHERS)

    def process_query(self, neighbor: str, msg: DualMessage,
                      msgs: MsgsToSend) -> None:
        """reference: Dual.cpp:597 processQuery."""
        self.neighbor_infos.setdefault(
            neighbor, NeighborInfo()
        ).report_distance = msg.distance
        self.cornet.append(neighbor)
        event = (
            DualEvent.QUERY_FROM_SUCCESSOR
            if self.nexthop == neighbor
            else DualEvent.OTHERS
        )
        if self.sm.state == DualState.PASSIVE:
            self.try_local_or_diffusing(event, True, msgs)
        else:
            if self.nexthop == neighbor:
                self.distance = _add(
                    self.local_distances.get(neighbor, INFINITY),
                    self.neighbor_infos[neighbor].report_distance,
                )
            self.sm.process_event(event)
            self.send_reply(msgs)

    def process_reply(self, neighbor: str, msg: DualMessage,
                      msgs: MsgsToSend) -> None:
        """reference: Dual.cpp:636 processReply."""
        info = self.neighbor_infos.setdefault(neighbor, NeighborInfo())
        if not info.expect_reply:
            return  # late reply after we declared the link down: ignore
        info.report_distance = msg.distance
        info.expect_reply = False
        if any(i.expect_reply for i in self.neighbor_infos.values()):
            return
        # last reply: free to pick the optimal successor; FD resets
        self.sm.process_event(DualEvent.LAST_REPLY, True)
        dmin = INFINITY
        new_nh: Optional[str] = None
        for n in sorted(self.local_distances):
            d = _add(
                self.local_distances[n],
                self.neighbor_infos[n].report_distance,
            )
            if d < dmin:
                dmin = d
                new_nh = n
        same_rd = dmin == self.report_distance
        self.distance = dmin
        self.report_distance = dmin
        self.feasible_distance = dmin
        self._set_nexthop(new_nh)
        if not same_rd:
            self.flood_updates(msgs)
        if self.cornet:
            self.send_reply(msgs)

    # -- spanning tree ----------------------------------------------------

    def add_child(self, child: str) -> None:
        """reference: Dual.cpp:337 addChild."""
        self.children_.add(child)

    def remove_child(self, child: str) -> None:
        self.children_.discard(child)

    def children(self) -> Set[str]:
        return set(self.children_)

    def has_valid_route(self) -> bool:
        return (
            self.sm.state == DualState.PASSIVE
            and self.nexthop is not None
            and self.distance < INFINITY
        )

    def spt_peers(self) -> Set[str]:
        """Parent + children: the links flooding rides.
        reference: Dual.cpp:380 sptPeers."""
        if not self.has_valid_route():
            return set()
        peers = self.children()
        peers.add(self.nexthop)
        return peers


class DualNode:
    """Multi-root coordinator (reference: DualNode in Dual.h, which
    KvStoreDb inherits): one Dual per root, flood-root election as the
    smallest ready root id, message fan-in/out."""

    def __init__(
        self,
        node_id: str,
        is_root: bool = False,
        nexthop_change_cb: Optional[
            Callable[[str, Optional[str], Optional[str]], None]
        ] = None,
    ):
        self.node_id = node_id
        self.is_root = is_root
        self.duals: Dict[str, Dual] = {}
        self._peers: Dict[str, int] = {}
        self._cb = nexthop_change_cb
        if is_root:
            self._get_or_create(node_id)

    def _get_or_create(self, root_id: str) -> Dual:
        dual = self.duals.get(root_id)
        if dual is None:
            cb = None
            if self._cb is not None:
                cb = lambda old, new, root=root_id: self._cb(root, old, new)
            dual = self.duals[root_id] = Dual(
                self.node_id, root_id, dict(self._peers), cb
            )
        return dual

    # -- peer lifecycle ---------------------------------------------------

    def peer_up(self, neighbor: str, cost: int) -> MsgsToSend:
        self._peers[neighbor] = cost
        msgs: MsgsToSend = {}
        for dual in self.duals.values():
            dual.peer_up(neighbor, cost, msgs)
        return msgs

    def peer_down(self, neighbor: str) -> MsgsToSend:
        self._peers.pop(neighbor, None)
        msgs: MsgsToSend = {}
        for dual in self.duals.values():
            dual.peer_down(neighbor, msgs)
        return msgs

    def peer_cost_change(self, neighbor: str, cost: int) -> MsgsToSend:
        self._peers[neighbor] = cost
        msgs: MsgsToSend = {}
        for dual in self.duals.values():
            dual.peer_cost_change(neighbor, cost, msgs)
        return msgs

    # -- messages ---------------------------------------------------------

    def process_message(self, neighbor: str, msg: DualMessage) -> MsgsToSend:
        dual = self._get_or_create(msg.dst_id)
        msgs: MsgsToSend = {}
        if msg.type == DualMessageType.UPDATE:
            dual.process_update(neighbor, msg, msgs)
        elif msg.type == DualMessageType.QUERY:
            dual.process_query(neighbor, msg, msgs)
        elif msg.type == DualMessageType.REPLY:
            dual.process_reply(neighbor, msg, msgs)
        return msgs

    # -- introspection ----------------------------------------------------

    def get_dual(self, root_id: str) -> Optional[Dual]:
        return self.duals.get(root_id)

    def pick_flood_root(self) -> Optional[str]:
        """Smallest ready root id (reference: DualNode flood-root pick)."""
        candidates = [
            root
            for root, dual in self.duals.items()
            if dual.has_valid_route() or root == self.node_id
        ]
        return min(candidates) if candidates else None

    def spt_peers(self, root_id: str) -> Set[str]:
        dual = self.duals.get(root_id)
        if dual is None:
            return set()
        if self.node_id == root_id:
            return dual.children()
        return dual.spt_peers()

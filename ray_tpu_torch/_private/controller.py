"""Controller: the cluster control plane (GCS-equivalent).

Reference parity: src/ray/gcs/gcs_server/gcs_server.h — node membership,
actor directory (gcs_actor_manager.h) with max_restarts handling, named
actors, internal KV (kv_manager), pubsub broker, and the cluster-wide task
scheduler (a centralized stand-in for the reference's distributed
lease-based dispatch; daemons still own local worker pools).

Runs inside the head process's event loop; daemons and clients reach it
over its RpcServer.
"""

from __future__ import annotations

import asyncio
import logging
import os
import time
from typing import Any, Dict, List, Optional, Tuple

from .config import FN_STORE_PREFIX
from .protocol import ClientPool, RpcServer
from ..exceptions import ActorDiedError, InfeasibleResourceError, TaskError

logger = logging.getLogger(__name__)


class NodeEntry:
    __slots__ = ("node_id", "addr", "resources_total", "resources_avail",
                 "labels", "alive", "num_running", "last_heartbeat",
                 "sync_version", "view", "draining", "commands",
                 "cmd_seq")

    def __init__(self, node_id: str, addr: Tuple[str, int],
                 resources: Dict[str, float], labels: Dict[str, str]):
        self.node_id = node_id
        self.addr = tuple(addr)
        self.resources_total = dict(resources)
        self.resources_avail = dict(resources)
        self.labels = labels or {}
        self.alive = True
        self.num_running = 0
        self.last_heartbeat = time.monotonic()
        # Resource/stats gossip (reference parity: ray_syncer.h:39-83 —
        # versioned per-node snapshots, only deltas cross the wire):
        # the daemon's last-synced view and the version we acked.
        self.sync_version = 0
        self.view: Dict[str, Any] = {}
        # Draining: excluded from scheduling; terminated by the
        # autoscaler once idle (reference: DrainRaylet / autoscaler v2
        # drain-before-terminate).
        self.draining = False
        # Commands queued for the daemon, piggybacked on heartbeat
        # replies (reference: syncer command channel). Sequence-numbered
        # and re-delivered until the daemon acks — a dropped reply must
        # not lose a drain/set_resource.
        self.commands: List[dict] = []
        self.cmd_seq = 0

    def fits(self, req: Dict[str, float]) -> bool:
        for k, v in req.items():
            if self.resources_avail.get(k, 0.0) + 1e-9 < v:
                return False
        return True

    def feasible(self, req: Dict[str, float]) -> bool:
        for k, v in req.items():
            if self.resources_total.get(k, 0.0) + 1e-9 < v:
                return False
        return True

    def acquire(self, req: Dict[str, float]) -> None:
        for k, v in req.items():
            self.resources_avail[k] = self.resources_avail.get(k, 0.0) - v
        self.num_running += 1

    def release(self, req: Dict[str, float]) -> None:
        for k, v in req.items():
            self.resources_avail[k] = min(
                self.resources_total.get(k, 0.0),
                self.resources_avail.get(k, 0.0) + v)
        self.num_running = max(0, self.num_running - 1)

    def utilization(self) -> float:
        fracs = []
        for k, total in self.resources_total.items():
            if total > 0:
                fracs.append(1.0 - self.resources_avail.get(k, 0.0) / total)
        return max(fracs) if fracs else 0.0


def _pick_hybrid(fitting: List["NodeEntry"]) -> "NodeEntry":
    """Hybrid-lite placement, shared by the scheduler and the lease
    grantor: pack onto the most-utilized node below 50% utilization,
    else spread to the least utilized (reference:
    src/ray/raylet/scheduling/policy/hybrid_scheduling_policy.h:61)."""
    below = [n for n in fitting if n.utilization() < 0.5]
    if below:
        return max(below, key=lambda n: n.utilization())
    return min(fitting, key=lambda n: n.utilization())


class ActorEntry:
    __slots__ = ("actor_id", "name", "namespace", "state", "addr", "node_id",
                 "worker_id", "creation_spec", "max_restarts", "restarts",
                 "death_cause", "waiters", "lifetime")

    def __init__(self, actor_id: str, spec: dict):
        self.actor_id = actor_id
        self.name = spec.get("actor_name")
        self.namespace = spec.get("namespace", "default")
        self.state = "PENDING"          # PENDING -> ALIVE -> RESTARTING/DEAD
        self.addr: Optional[Tuple[str, int]] = None
        self.node_id: Optional[str] = None
        self.worker_id: Optional[str] = None
        self.creation_spec = spec
        self.max_restarts = spec.get("max_restarts", 0)
        self.restarts = 0
        self.death_cause = ""
        self.lifetime = spec.get("lifetime")
        self.waiters: List[asyncio.Event] = []


class Controller:
    def __init__(self, session_name: str, persist_path: Optional[str] = None):
        self.session_name = session_name
        # Durable control plane (reference parity: gcs_table_storage.h:213,
        # redis_store_client.h:111): actors, named actors, KV, and PG
        # definitions are written through to SQLite so a controller
        # restart resumes with live actor addresses and named lookups
        # intact. Disable with persist_path="" for throwaway controllers.
        if persist_path is None:
            from .config import get_config, session_dir
            persist_path = (get_config().gcs_persist_path
                            or os.path.join(session_dir(session_name),
                                            "gcs.db"))
        self.store = None
        if persist_path:
            from .gcs_store import GcsStore
            self.store = GcsStore(persist_path)
        self.server = RpcServer()
        self.server.register_object(self)
        self.pool = ClientPool()
        self.address: Optional[Tuple[str, int]] = None
        self.nodes: Dict[str, NodeEntry] = {}
        self.actors: Dict[str, ActorEntry] = {}
        self.named_actors: Dict[Tuple[str, str], str] = {}
        self.kv: Dict[str, bytes] = {}
        # worker leases: lease_id -> {node_id, req, worker_id,
        #                             owner_addr, granted_at}
        self.leases: Dict[str, dict] = {}
        # Resource blocks delegated to daemons for LOCAL lease granting
        # (distributed dispatch — reference parity: the raylet owns its
        # local dispatch, cluster_task_manager.h:45; here the controller
        # pre-acquires a block so daemon grants never double-book
        # against the scheduled path): (node_id, req_key) -> slot count.
        self.delegations: Dict[tuple, int] = {}
        self._reclaim_timer_armed = False   # re-pump while work pends
        self._pg_reserve_tasks: set = set()  # in-flight bundle 2PCs
        self.subscribers: Dict[str, List[Tuple[str, int]]] = {}
        self.pending: List[dict] = []          # specs waiting for resources
        self._spread_cursor = 0                # SPREAD round-robin state
        # task_id -> (node_id, resources, spec)
        self.running: Dict[str, Tuple[str, Dict[str, float], dict]] = {}
        # task-event table backing the state API (reference: GCS task
        # manager, src/ray/gcs/gcs_server/gcs_task_manager.h) — bounded
        self.task_events: "Dict[str, dict]" = {}
        self.task_events_cap = 10000
        self.node_timeout_s = 10.0
        self.placement_groups: Dict[str, Any] = {}
        self.pending_pgs: List[Any] = []
        # With an autoscaler attached, infeasible demand queues (waiting
        # for scale-up) instead of failing fast.
        self.autoscaling_enabled = False
        self._sched_event = asyncio.Event()
        self._sched_task: Optional[asyncio.Task] = None
        self._health_task: Optional[asyncio.Task] = None
        self._closed = False

    async def start(self, host=None, port: int = 0):
        self._restore_state()
        self.address = await self.server.start(host, port)
        self._sched_task = asyncio.ensure_future(self._schedule_loop())
        self._health_task = asyncio.ensure_future(self._health_loop())
        return self.address

    async def stop(self):
        self._closed = True
        if self._sched_task:
            self._sched_task.cancel()
        if self._health_task:
            self._health_task.cancel()
        await self.server.stop()
        await self.pool.close_all()
        if self.store is not None:
            self.store.close()

    # -------------------------------------------------------- persistence

    def _persist_actor(self, entry: "ActorEntry",
                       with_spec: bool = False) -> None:
        """Write-through actor state. The creation spec (which embeds the
        pickled class + args, potentially MBs) is immutable — it is
        written ONCE (with_spec=True at registration) into its own row so
        state transitions only re-serialize the small mutable fields."""
        if self.store is None:
            return
        if with_spec:
            self.store.put("actor_specs", entry.actor_id,
                           entry.creation_spec)
        self.store.put("actors", entry.actor_id, {
            "actor_id": entry.actor_id, "name": entry.name,
            "namespace": entry.namespace, "state": entry.state,
            "addr": entry.addr, "node_id": entry.node_id,
            "worker_id": entry.worker_id,
            "max_restarts": entry.max_restarts, "restarts": entry.restarts,
            "death_cause": entry.death_cause, "lifetime": entry.lifetime,
        })

    def _restore_state(self) -> None:
        """Reload durable tables after a restart. ALIVE actors keep their
        addresses (their worker processes are still up); PENDING/RESTARTING
        actors re-enter the scheduling queue; nodes re-register themselves
        via the heartbeat path (rpc_heartbeat -> 'unknown' -> daemon
        re-registers)."""
        if self.store is None:
            return
        specs = dict(self.store.items("actor_specs"))
        for _, data in self.store.items("actors"):
            entry = ActorEntry(data["actor_id"],
                               specs.get(data["actor_id"], {}))
            entry.name = data["name"]
            entry.namespace = data["namespace"]
            entry.state = data["state"]
            entry.addr = tuple(data["addr"]) if data["addr"] else None
            entry.node_id = data["node_id"]
            entry.worker_id = data["worker_id"]
            entry.max_restarts = data["max_restarts"]
            entry.restarts = data["restarts"]
            entry.death_cause = data["death_cause"]
            entry.lifetime = data["lifetime"]
            self.actors[entry.actor_id] = entry
            if entry.name and entry.state != "DEAD":
                self.named_actors[(entry.namespace, entry.name)] = \
                    entry.actor_id
            if entry.state in ("PENDING", "RESTARTING"):
                spec = dict(entry.creation_spec)
                spec["is_restart"] = entry.state == "RESTARTING"
                self.pending.append(spec)
        for key, actor_id in self.store.items("named_actors"):
            ns, _, name = key.partition("\x00")
            self.named_actors[(ns, name)] = actor_id
        for key, value in self.store.items("kv"):
            self.kv[key] = value
        for pg_id, data in self.store.items("placement_groups"):
            from .placement import PlacementGroupEntry
            pg = PlacementGroupEntry(pg_id, data["bundles"],
                                     data["strategy"], data["name"])
            self.placement_groups[pg_id] = pg
            if data.get("state") == "CREATED":
                # Keep the old placement: bundle reservations are
                # re-acquired per node as each daemon re-registers
                # (rpc_register_node) — re-placing would double-book.
                pg.state = "CREATED"
                for b, nid in zip(pg.bundles, data.get("assignments", [])):
                    b.node_id = nid
            elif data.get("state") in ("FAILED", "REMOVED"):
                # restored only so status queries answer; no reservations,
                # never re-placed
                pg.state = data["state"]
            else:
                self.pending_pgs.append(pg)   # re-place on live nodes
        if self.pending or self.pending_pgs:
            self._sched_event.set()

    def _persist_pg(self, pg) -> None:
        if self.store is None:
            return
        self.store.put("placement_groups", pg.pg_id, {
            "bundles": [dict(b.resources) for b in pg.bundles],
            "strategy": pg.strategy, "name": pg.name,
            "state": pg.state,
            "assignments": [b.node_id for b in pg.bundles],
        })

    def _persist_named(self, namespace: str, name: str,
                       actor_id: Optional[str]) -> None:
        if self.store is None:
            return
        key = f"{namespace}\x00{name}"
        if actor_id is None:
            self.store.delete("named_actors", key)
        else:
            self.store.put("named_actors", key, actor_id)

    # ------------------------------------------------------------- nodes

    async def rpc_register_node(self, node_id: str, addr, resources,
                                labels=None, pg_bundles=None) -> dict:
        node = NodeEntry(node_id, addr, resources, labels)
        prior = self.nodes.get(node_id)
        if prior is not None:
            # A re-registering node (health-blip recovery) keeps its
            # undelivered command queue and drain state — at-least-once
            # delivery must survive the dead-mark/re-register cycle.
            node.commands = prior.commands
            node.cmd_seq = prior.cmd_seq
            node.draining = prior.draining
        self.nodes[node_id] = node
        # Delegated-bundle reconciliation against the daemon's committed
        # ledger (pg_bundles; None = old-protocol daemon, trust our own
        # table). Three cases:
        #  - both sides agree -> re-acquire the reservation;
        #  - we expect a bundle the daemon does NOT hold (daemon process
        #    restarted) -> the group lost state: re-place the whole PG;
        #  - the daemon holds bundles for a PG we dropped/never created
        #    (removed while it was partitioned) -> tell it to release.
        release_pgs: List[str] = []
        reported = None if pg_bundles is None else set(pg_bundles)
        for pg in list(self.placement_groups.values()):
            if pg.state == "RESERVING":
                # mid-2PC: the pump already deducted these bundles from
                # the OLD NodeEntry; the fresh one must carry the same
                # deduction or a later commit/rollback corrupts the
                # books (daemon ledger audit doesn't apply — nothing is
                # committed daemon-side yet)
                for b in pg.bundles:
                    if b.node_id == node_id:
                        node.acquire(b.resources)
                continue
            if pg.state != "CREATED":
                continue
            on_node = [b for b in pg.bundles if b.node_id == node_id]
            if not on_node:
                continue
            if reported is not None and pg.pg_id not in reported:
                # daemon lost the reservation: release every node's part
                # and send the group back through placement
                for b in pg.bundles:
                    holder = self.nodes.get(b.node_id or "")
                    if holder is not None and b.node_id != node_id:
                        holder.release(b.resources)
                    b.node_id = None
                pg.state = "PENDING"
                if pg not in self.pending_pgs:
                    self.pending_pgs.append(pg)
                self._persist_pg(pg)
                continue
            for b in on_node:
                node.acquire(b.resources)
        if reported:
            known = {pg.pg_id for pg in self.placement_groups.values()
                     if pg.state in ("CREATED", "RESERVING")}
            release_pgs = [pid for pid in reported if pid not in known]
        logger.info("node %s registered at %s with %s",
                    node_id[:8], addr, resources)
        self._sched_event.set()
        # Actors this (possibly restarted) controller believes live on the
        # node: the daemon compares against what it actually hosts and
        # reports the dead ones — actors that died while the controller
        # was down must not stay ALIVE forever. Their creation resources
        # are re-acquired here (the fresh NodeEntry starts fully free) and
        # the running-table entry rebuilt so a later death releases them.
        expected = []
        for a in self.actors.values():
            if a.node_id == node_id and a.state == "ALIVE":
                expected.append(a.actor_id)
                task_id = a.creation_spec.get("task_id")
                if task_id and task_id not in self.running:
                    req = dict(a.creation_spec.get("resources") or {})
                    sched = (a.creation_spec.get("scheduling") or {})
                    pg = self.placement_groups.get(
                        sched.get("placement_group") or "")
                    if pg is None:
                        node.acquire(req)
                    elif pg.state == "CREATED" \
                            and task_id not in pg.task_usage:
                        # re-acquire bundle-internal usage so restored
                        # bundles don't look empty and oversubscribe
                        _, bidx = pg.resolve_bundle(
                            sched.get("bundle_index", -1), req)
                        if bidx is not None:
                            pg.acquire_for_task(task_id, bidx, req)
                        node.num_running += 1
                    else:
                        continue
                    self.running[task_id] = (node_id, req,
                                             a.creation_spec)
        return {"session_name": self.session_name,
                "expected_actors": expected,
                "release_pgs": release_pgs}

    async def rpc_unregister_node(self, node_id: str) -> None:
        node = self.nodes.get(node_id)
        if node:
            node.alive = False
            await self._on_node_death(node_id)

    async def rpc_heartbeat(self, node_id: str, num_workers: int = 0,
                            sync_version: int = 0,
                            view: Optional[dict] = None,
                            cmd_ack: int = 0) -> dict:
        node = self.nodes.get(node_id)
        if node and node.alive:
            node.last_heartbeat = time.monotonic()
            if view is not None and sync_version > node.sync_version:
                self._apply_node_view(node, view)
                node.sync_version = sync_version
            # at-least-once command delivery: drop acked, resend the rest
            node.commands = [c for c in node.commands
                             if c["seq"] > cmd_ack]
            return {"status": "ok", "sync_ack": node.sync_version,
                    "commands": list(node.commands)}
        # Either a restarted controller doesn't know this node yet, or
        # the health loop declared it dead during a blip — both ways the
        # daemon must re-register to rejoin (a dead-marked entry must not
        # swallow heartbeats forever).
        return {"status": "unknown"}

    def _apply_node_view(self, node: NodeEntry, view: dict) -> None:
        """Fold a daemon's versioned state snapshot into the cluster view
        (reference parity: ray_syncer RESOURCE_VIEW receiver side)."""
        node.view = view
        if view.get("draining"):
            # drain state gossiped back (e.g. after a controller restart
            # re-registered the node with a fresh entry): never resume
            # scheduling onto a node the operator drained
            node.draining = True
        new_total = view.get("resources_total")
        if new_total is not None and new_total != node.resources_total:
            # Dynamic resource change (chip lost, user set_resource):
            # shift availability by the delta so in-flight acquisitions
            # stay accounted.
            for k in set(new_total) | set(node.resources_total):
                if k not in new_total:
                    node.resources_avail.pop(k, None)   # deleted resource
                    continue
                delta = (new_total.get(k, 0.0)
                         - node.resources_total.get(k, 0.0))
                if delta:
                    node.resources_avail[k] = \
                        node.resources_avail.get(k, 0.0) + delta
            node.resources_total = dict(new_total)
            self._sched_event.set()   # freed capacity may place work

    async def rpc_drain_node(self, node_id: str) -> dict:
        """Start draining: no new work is scheduled here; the daemon is
        told via the heartbeat command channel; the autoscaler terminates
        it once idle. (Reference: autoscaler v2 drain-before-terminate.)"""
        node = self.nodes.get(node_id)
        if node is None or not node.alive:
            return {"status": "not_found"}
        if not node.draining:
            node.draining = True
            self._queue_command(node, {"type": "drain"})
        return {"status": "draining"}

    def _queue_command(self, node: NodeEntry, cmd: dict) -> None:
        node.cmd_seq += 1
        cmd["seq"] = node.cmd_seq
        node.commands.append(cmd)

    async def rpc_set_node_resource(self, node_id: str, name: str,
                                    capacity: float) -> dict:
        """Route a dynamic resource update to a node via the command
        channel; the daemon applies it locally and gossips the new totals
        back on its next heartbeat."""
        if name in ("CPU", "GPU", "memory") or name.startswith("GPU-"):
            # deleting/overriding builtin capacity would wedge scheduling
            # cluster-wide (reference set_resource has the same guard)
            return {"status": "rejected",
                    "error": f"cannot override builtin resource {name!r}"}
        node = self.nodes.get(node_id)
        if node is None or not node.alive:
            return {"status": "not_found"}
        self._queue_command(node, {"type": "set_resource", "name": name,
                                   "capacity": float(capacity)})
        return {"status": "queued"}

    async def _on_node_death(self, node_id: str) -> None:
        # leases on the dead node are void; clients discover via
        # ConnectionLost and fall back to the scheduled path
        for lease_id, lease in list(self.leases.items()):
            if lease["node_id"] == node_id:
                del self.leases[lease_id]
        # delegated lease blocks die with the node (their slots were
        # acquired on the now-gone NodeEntry; nothing to release)
        for key in [k for k in self.delegations if k[0] == node_id]:
            del self.delegations[key]
        # Placement groups with a bundle on the dead node become FAILED:
        # their gang guarantee is broken. Reservations on surviving nodes
        # are returned.
        for pg in list(self.placement_groups.values()):
            if pg.state == "CREATED" and any(
                    b.node_id == node_id for b in pg.bundles):
                for b in pg.bundles:
                    if b.node_id != node_id:
                        node = self.nodes.get(b.node_id)
                        if node is not None:
                            node.release(b.resources)
                pg.fail(f"bundle node {node_id[:8]} died")
                self._persist_pg(pg)
        for actor in list(self.actors.values()):
            if actor.node_id == node_id and actor.state == "ALIVE":
                await self._handle_actor_death(
                    actor.actor_id, f"node {node_id[:8]} died")
        # Fail in-flight normal tasks on the node; owners may retry.
        # Actor creations in flight are routed through actor-death handling
        # so max_restarts applies (resubmitted elsewhere if budget remains).
        from ..exceptions import WorkerCrashedError
        for task_id, (nid, req, spec) in list(self.running.items()):
            if nid != node_id:
                continue
            if spec.get("is_actor_creation"):
                await self._handle_actor_death(
                    spec["actor_id"],
                    f"node {node_id[:8]} died during actor creation")
            else:
                self.running.pop(task_id, None)
                await self._fail_task(spec, WorkerCrashedError(
                    f"node {node_id[:8]} died while running task"))
        self._sched_event.set()

    async def _health_loop(self) -> None:
        """Node failure detector (reference parity:
        src/ray/gcs/gcs_server/gcs_health_check_manager.h:45 — missed
        heartbeats trigger an ACTIVE probe before the node is declared
        dead: a daemon whose heartbeat path is wedged, e.g. its monitor
        loop stuck behind a slow spill, is not the same as a dead
        daemon, and killing its actors would be an unforced error)."""
        while not self._closed:
            await asyncio.sleep(2.0)
            try:
                await self._reap_dead_client_leases()
            except Exception:
                logger.exception("lease reap failed")
            now = time.monotonic()
            stale = [n for n in self.nodes.values()
                     if n.alive and now - n.last_heartbeat
                     > self.node_timeout_s]
            if not stale:
                continue
            # probe concurrently: a correlated failure of many nodes
            # must not serialize 2s timeouts per dead node
            verdicts = await asyncio.gather(
                *(self._probe_node(n) for n in stale))
            for node, ok in zip(stale, verdicts):
                if not node.alive:
                    continue        # died during the probe round
                if ok:
                    logger.warning(
                        "node %s missed heartbeats for %.0fs but "
                        "answers probes; keeping alive",
                        node.node_id[:8], now - node.last_heartbeat)
                    node.last_heartbeat = time.monotonic()
                    continue
                logger.warning("node %s missed heartbeats for %.0fs "
                               "and failed the probe; marking dead",
                               node.node_id[:8],
                               now - node.last_heartbeat)
                node.alive = False
                await self._on_node_death(node.node_id)

    async def _probe_node(self, node: NodeEntry) -> bool:
        """One direct health probe of the daemon's RPC server."""
        try:
            await asyncio.wait_for(
                self.pool.get(node.addr).call("node_stats"), timeout=2.0)
            return True
        except Exception:
            return False

    async def rpc_get_session_info(self) -> dict:
        """Bootstrap info for drivers attaching via init(address=...)."""
        head_addr = None
        for node in self.nodes.values():
            if node.alive:
                head_addr = list(node.addr)
                break
        return {"session_name": self.session_name,
                "head_daemon_addr": head_addr}

    async def rpc_list_nodes(self) -> List[dict]:
        return [{
            "node_id": n.node_id, "addr": n.addr, "alive": n.alive,
            "resources_total": n.resources_total,
            "resources_available": n.resources_avail,
            "labels": n.labels,
            "draining": n.draining,
            # gossiped daemon-side stats (workers, store bytes, spills…)
            "stats": n.view.get("stats", {}),
        } for n in self.nodes.values()]

    async def rpc_cluster_resources(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for n in self.nodes.values():
            if n.alive:
                for k, v in n.resources_total.items():
                    out[k] = out.get(k, 0.0) + v
        return out

    async def rpc_available_resources(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for n in self.nodes.values():
            if n.alive:
                for k, v in n.resources_avail.items():
                    out[k] = out.get(k, 0.0) + v
        return out

    # ---------------------------------------------------------- scheduling

    async def rpc_submit_tasks(self, specs: List[dict]) -> List[dict]:
        """Batched submission: one RPC for a burst of specs (the client
        coalesces same-tick submits). Per-spec error isolation: a spec
        that fails mid-batch must not poison the already-queued ones."""
        out = []
        for spec in specs:
            try:
                out.append(await self.rpc_submit_task(spec))
            except Exception as e:
                logger.exception("batched submit of %s failed",
                                 spec.get("task_id", "?")[:12])
                out.append({"status": "error", "error": repr(e)})
        return out

    async def rpc_submit_task(self, spec: dict) -> dict:
        if spec.get("is_actor_creation") and spec.get("actor_name") \
                and not spec.get("is_restart"):
            key = (spec.get("namespace", "default"), spec["actor_name"])
            if key in self.named_actors:
                await self._fail_task(spec, ValueError(
                    f"actor name {spec['actor_name']!r} already taken "
                    f"in namespace {key[0]!r}"))
                return {"status": "rejected"}
            self.named_actors[key] = spec["actor_id"]
            # NOT persisted here: the pending queue is volatile, so a
            # restart before dispatch must drop the claim with the task —
            # the name is written with the ActorEntry at registration.
        self._task_event(spec["task_id"], "PENDING_SCHEDULING", spec=spec)
        self.pending.append(spec)
        self._sched_event.set()
        return {"status": "queued"}

    def _task_event(self, task_id: str, state: str, spec: dict = None,
                    node_id: str = None, error: str = None) -> None:
        import time as _time
        ev = self.task_events.get(task_id)
        if ev is None:
            if len(self.task_events) >= self.task_events_cap:
                # evict terminal entries first (oldest insertion order);
                # live PENDING/RUNNING events must survive churn
                budget = self.task_events_cap // 10
                victims = [k for k, e in self.task_events.items()
                           if e["state"] in ("FINISHED", "FAILED")]
                for key in victims[:budget]:
                    del self.task_events[key]
                if len(self.task_events) >= self.task_events_cap:
                    for key in list(self.task_events)[:budget]:
                        del self.task_events[key]
            ev = self.task_events[task_id] = {
                "task_id": task_id, "name": "", "type": "NORMAL_TASK",
                "state": "", "node_id": None, "error": None,
                "start_time": None, "end_time": None,
                "creation_time": _time.time()}
        if spec is not None:
            ev["name"] = spec.get("name", "")
            ev["type"] = ("ACTOR_CREATION_TASK"
                          if spec.get("is_actor_creation")
                          else "NORMAL_TASK")
        ev["state"] = state
        if node_id is not None:
            ev["node_id"] = node_id
        if state == "RUNNING":
            ev["start_time"] = _time.time()
        if state in ("FINISHED", "FAILED"):
            ev["end_time"] = _time.time()
        if error is not None:
            ev["error"] = error

    # --------------------------------------------------------- autoscaler

    async def rpc_set_autoscaling(self, enabled: bool) -> None:
        self.autoscaling_enabled = bool(enabled)
        if enabled:
            self._sched_event.set()

    async def rpc_pending_demand(self) -> dict:
        """Unmet demand + node load, the reconciler's input (reference
        parity: autoscaler/v2 ResourceDemandScheduler inputs —
        instance_manager/reconciler.py:53)."""
        return {
            # PG-scheduled tasks draw from their group's reservation, not
            # cluster capacity — counting them would launch nodes they
            # can never use.
            "task_demands": [
                dict(s.get("resources") or {}) for s in self.pending
                if not (s.get("scheduling") or {}).get("placement_group")],
            "pg_demands": [{
                "pg_id": pg.pg_id,
                "strategy": pg.strategy,
                "bundles": [dict(b.resources) for b in pg.bundles],
            } for pg in self.pending_pgs],
            "nodes": [{
                "node_id": n.node_id,
                "alive": n.alive,
                "num_running": n.num_running,
                # placed PG bundles pin a node even when quiet: the gang
                # reservation must survive until the PG is removed
                "num_pg_bundles": sum(
                    1 for pg in self.placement_groups.values()
                    if pg.state == "CREATED"
                    for b in pg.bundles if b.node_id == n.node_id),
                "resources_total": dict(n.resources_total),
                "resources_avail": dict(n.resources_avail),
                "labels": dict(n.labels),
                "draining": n.draining,
            } for n in self.nodes.values()],
        }

    async def rpc_list_tasks(self, filters: dict = None) -> List[dict]:
        events = list(self.task_events.values())
        for key, val in (filters or {}).items():
            events = [e for e in events if e.get(key) == val]
        return events

    async def _schedule_loop(self) -> None:
        while not self._closed:
            await self._sched_event.wait()
            self._sched_event.clear()
            await self._pump()

    async def _pump(self) -> None:
        # Placement groups first: gang reservations beat individual tasks.
        still_pg: List[Any] = []
        for pg in self.pending_pgs:
            nodes = [n for n in self.nodes.values() if not n.draining]
            chosen, reason = pg.choose_nodes(nodes)
            if chosen is not None:
                # Optimistically deduct controller-side availability NOW
                # (nothing else may hand these resources out during the
                # daemon round-trips), then confirm the reservation on
                # the owning daemons in the background so one slow
                # daemon never stalls task scheduling.
                pg.commit(chosen, {n.node_id: n for n in nodes})
                pg.state = "RESERVING"
                task = asyncio.ensure_future(
                    self._finish_pg_reserve(pg, chosen))
                self._pg_reserve_tasks.add(task)
                task.add_done_callback(self._pg_reserve_tasks.discard)
            elif reason == "" or self.autoscaling_enabled:
                if reason:
                    pg.failure_reason = reason   # surfaced to autoscaler
                still_pg.append(pg)       # retry when resources free up
            else:
                pg.fail(reason)
                self._persist_pg(pg)
        self.pending_pgs = still_pg

        still_pending: List[dict] = []
        for spec in self.pending:
            # PG tasks wait until their PG's daemon reservation confirms
            sched = spec.get("scheduling") or {}
            pg = self.placement_groups.get(
                sched.get("placement_group") or "")
            if pg is not None and pg.state in ("PENDING", "RESERVING"):
                still_pending.append(spec)
                continue
            placed = await self._try_place(spec)
            if placed is None:
                still_pending.append(spec)
        self.pending = still_pending

        if (still_pending or still_pg) and self.delegations:
            # Scheduled work is waiting while daemons sit on delegated
            # lease blocks: command them to return free slots now
            # (spill-back pressure — the reference raylet spills queued
            # work instead; here capacity flows back to the global
            # scheduler). A single command only frees what is idle at
            # that instant — slots still backing live leases free up
            # later — so keep re-pumping (and re-commanding) on a short
            # timer until either the work places or the delegations are
            # gone.
            for node_id in {k[0] for k in self.delegations}:
                node = self.nodes.get(node_id)
                if node is None or not node.alive:
                    continue
                # only command nodes whose daemons report FREE block
                # slots (gossiped stat, ~0.5s stale; the re-pump timer
                # re-checks): reclaiming from a daemon whose slots all
                # back live leases frees nothing and just churns its
                # delegate/return cycle
                stats = (node.view or {}).get("stats", {})
                if stats.get("lease_block_free", 1) <= 0:
                    continue
                if not any(c.get("type") == "reclaim_lease_blocks"
                           for c in node.commands):
                    self._queue_command(
                        node, {"type": "reclaim_lease_blocks"})
            if not self._reclaim_timer_armed:
                self._reclaim_timer_armed = True

                def _rearm() -> None:
                    self._reclaim_timer_armed = False
                    self._sched_event.set()

                asyncio.get_running_loop().call_later(1.0, _rearm)

    async def _try_place(self, spec: dict) -> Optional[str]:
        req = dict(spec.get("resources") or {})
        strategy = spec.get("scheduling") or {}
        candidates = [n for n in self.nodes.values()
                      if n.alive and not n.draining]
        if strategy.get("type") == "node_affinity":
            target = [n for n in candidates
                      if n.node_id == strategy.get("node_id")]
            if not target and not strategy.get("soft"):
                await self._fail_task(
                    spec, InfeasibleResourceError(
                        f"node {strategy.get('node_id')} not found"))
                return "failed"
            if target:
                candidates = target
        pg_id = strategy.get("placement_group")
        if pg_id is not None:
            return await self._place_in_pg(spec, pg_id,
                                           strategy.get("bundle_index", -1),
                                           req)
        if not any(n.feasible(req) for n in candidates):
            # Infeasible for the (possibly affinity-narrowed) candidates.
            # Fail only if NO schedulable node could ever satisfy it —
            # an affinity target that is currently too small may grow
            # (set_resource) while other nodes stay feasible: keep waiting.
            schedulable = [n for n in self.nodes.values()
                           if n.alive and not n.draining]
            if all(not n.feasible(req) for n in schedulable):
                if self.autoscaling_enabled:
                    return None     # wait: the autoscaler may add a node
                await self._fail_task(spec, InfeasibleResourceError(
                    f"no node can ever satisfy {req} "
                    f"(cluster: {await self.rpc_cluster_resources()})"))
                return "failed"
            return None
        fitting = [n for n in candidates if n.fits(req)]
        if not fitting:
            return None
        if strategy.get("type") == "spread":
            # SPREAD strategy: true round-robin over fitting nodes
            # (reference scheduling_policy.h SpreadSchedulingPolicy) —
            # utilization-based picks degenerate to packing for
            # zero-resource requests, which never move utilization
            fitting.sort(key=lambda n: n.node_id)
            self._spread_cursor += 1
            node = fitting[self._spread_cursor % len(fitting)]
        else:
            node = _pick_hybrid(fitting)
        node.acquire(req)
        return await self._dispatch(spec, node,
                                    lambda: node.release(req))

    async def _place_in_pg(self, spec: dict, pg_id: str,
                           bundle_index: int, req: dict) -> Optional[str]:
        """Place a task inside a placement group bundle: resources come from
        the bundle's reservation, not from node-available accounting."""
        from ..exceptions import PlacementGroupUnavailableError
        pg = self.placement_groups.get(pg_id)
        if pg is None or pg.state in ("REMOVED", "FAILED"):
            await self._fail_task(spec, PlacementGroupUnavailableError(
                f"placement group {pg_id[:12]} "
                f"{'not found' if pg is None else pg.state.lower()}"
                + (f": {pg.failure_reason}" if pg and pg.failure_reason else "")))
            return "failed"
        node_id, bidx = pg.resolve_bundle(bundle_index, req)
        if node_id == "__pending__":
            return None
        if node_id is None:
            await self._fail_task(spec, PlacementGroupUnavailableError(
                f"no bundle in {pg_id[:12]} can hold {req} "
                f"(bundle_index={bundle_index})"))
            return "failed"
        node = self.nodes.get(node_id)
        if node is None or not node.alive:
            await self._fail_task(spec, PlacementGroupUnavailableError(
                f"placement group {pg_id[:12]} bundle node died"))
            return "failed"
        pg.acquire_for_task(spec["task_id"], bidx, req)
        node.num_running += 1

        def cleanup():
            pg.release_for_task(spec["task_id"])
            node.num_running = max(0, node.num_running - 1)

        return await self._dispatch(spec, node, cleanup)

    async def _dispatch(self, spec: dict, node: NodeEntry,
                        cleanup) -> Optional[str]:
        """Send the spec to the node's daemon; on connection failure, undo
        the resource acquisition (cleanup), mark the node dead, and leave
        the spec pending (the caller's pump retains it)."""
        self.running[spec["task_id"]] = (node.node_id,
                                         dict(spec.get("resources") or {}),
                                         spec)
        self._task_event(spec["task_id"], "RUNNING", node_id=node.node_id)
        if spec.get("is_actor_creation"):
            self._register_pending_actor(spec, node.node_id)
        try:
            await self.pool.get(node.addr).call("execute_task", spec=spec)
        except Exception as e:
            logger.warning("dispatch to node %s failed: %r",
                           node.node_id[:8], e)
            cleanup()
            self.running.pop(spec["task_id"], None)
            node.alive = False
            await self._on_node_death(node.node_id)
            self._sched_event.set()
            return None
        return node.node_id

    async def _fail_task(self, spec: dict, error: Exception) -> None:
        self._task_event(spec["task_id"], "FAILED", error=repr(error))
        if spec.get("is_actor_creation"):
            # Release the claimed name and mark the directory entry dead so
            # the name can be reused and get_actor fails fast.
            actor_id = spec.get("actor_id")
            name = spec.get("actor_name")
            if name:
                key = (spec.get("namespace", "default"), name)
                if self.named_actors.get(key) == actor_id:
                    del self.named_actors[key]
            entry = self.actors.get(actor_id)
            if entry is not None and entry.state != "DEAD":
                entry.state = "DEAD"
                entry.death_cause = str(error)
                for ev in entry.waiters:
                    ev.set()
                entry.waiters.clear()
        try:
            await self.pool.get(spec["owner_addr"]).oneway(
                "object_ready", error=error, task_id=spec["task_id"],
                object_ids=spec.get("return_ids") or [spec["return_id"]])
        except Exception:
            pass

    # ------------------------------------------------------------- leases

    async def rpc_lease_worker(self, resources: dict,
                               runtime_env: Optional[dict] = None,
                               owner_addr=None) -> dict:
        """Grant a worker lease for client-direct task submission
        (reference parity: lease-based dispatch,
        normal_task_submitter.h:72-140). Resources stay acquired for the
        lease's lifetime; release_lease (or node death) returns them."""
        req = dict(resources or {})
        candidates = [n for n in self.nodes.values()
                      if n.alive and not n.draining and n.fits(req)]
        if not candidates:
            return {"status": "unavailable"}
        node = _pick_hybrid(candidates)
        # acquire BEFORE awaiting the daemon: a concurrent lease request
        # must not pass fits() against unreserved capacity (TOCTOU)
        node.acquire(req)
        try:
            reply = await self.pool.get(node.addr).call(
                "reserve_worker", runtime_env=runtime_env)
        except Exception:
            node.release(req)
            node.alive = False
            await self._on_node_death(node.node_id)
            return {"status": "unavailable"}
        if reply.get("status") != "ok":
            node.release(req)
            return {"status": "unavailable",
                    "error": reply.get("error")}
        import uuid
        lease_id = uuid.uuid4().hex
        self.leases[lease_id] = {
            "node_id": node.node_id, "req": req,
            "worker_id": reply["worker_id"],
            "owner_addr": tuple(owner_addr) if owner_addr else None,
            "granted_at": time.monotonic(),
        }
        return {"status": "ok", "lease_id": lease_id,
                "worker_addr": list(reply["addr"]),
                "worker_id": reply["worker_id"],
                "daemon_addr": list(node.addr),
                "node_id": node.node_id}

    @staticmethod
    def _delegation_key(node_id: str, req: Dict[str, float]) -> tuple:
        return (node_id, tuple(sorted(req.items())))

    async def rpc_delegate_resources(self, node_id: str, resources: dict,
                                     count: int) -> dict:
        """Grant a daemon a block of resource slots for LOCAL lease
        dispatch (distributed dispatch — reference parity: the raylet's
        LocalTaskManager dispatches with no GCS round-trip,
        local_task_manager.h:102; our daemon holds a pre-acquired block
        instead, so the controller's scheduled path and the daemon's
        local grants can never double-book one node)."""
        node = self.nodes.get(node_id)
        if node is None or not node.alive or node.draining:
            return {"granted": 0}
        req = dict(resources or {})
        granted = 0
        while granted < count and node.fits(req):
            node.acquire(req)
            granted += 1
        if granted:
            key = self._delegation_key(node_id, req)
            self.delegations[key] = self.delegations.get(key, 0) + granted
        return {"granted": granted}

    async def rpc_return_delegation(self, node_id: str, resources: dict,
                                    count: int) -> None:
        """A daemon hands back unused delegated slots (idle shrink)."""
        req = dict(resources or {})
        key = self._delegation_key(node_id, req)
        n = min(int(count), self.delegations.get(key, 0))
        if n <= 0:
            return
        self.delegations[key] -= n
        if self.delegations[key] == 0:
            del self.delegations[key]
        node = self.nodes.get(node_id)
        if node is not None and node.alive:
            for _ in range(n):
                node.release(req)
        self._sched_event.set()

    async def rpc_release_lease(self, lease_id: str) -> None:
        await self._release_lease(lease_id, terminate=False)

    async def _release_lease(self, lease_id: str,
                             terminate: bool = False) -> None:
        """terminate=True kills the leased worker instead of re-pooling
        it: used when the OWNER (not the client's pump) initiates the
        release, so a still-alive pump can never race a daemon dispatch
        onto the same worker — its next run_task fails cleanly and falls
        back through the fate RPC."""
        ent = self.leases.pop(lease_id, None)
        if ent is None:
            return
        node = self.nodes.get(ent["node_id"])
        if node is not None and node.alive:
            node.release(ent["req"])
            try:
                await self.pool.get(node.addr).oneway(
                    "destroy_worker" if terminate else "release_worker",
                    worker_id=ent["worker_id"])
            except Exception:
                pass
        self._sched_event.set()

    LEASE_PROBE_AGE_S = 10.0
    LEASE_RECLAIM_SCORE = 4    # dead probe = +2, slow probe = +1

    async def _reap_dead_client_leases(self) -> None:
        """A client that crashed (or whose pump teardown lost the
        release_lease) must not pin CPU + a 'leased' worker forever
        (reference parity: leased workers are returned when the owning
        core worker dies, normal_task_submitter.h). Probe owners of
        mature leases and reclaim on accumulated evidence: a REFUSED
        connection means the process is gone (+2 per round — reclaim
        after 2 rounds, ~12 s), while a TIMEOUT may just be a
        GIL-starved-but-alive driver loop (+1 — reclaim only after ~4
        unresponsive rounds, ~28 s). Reclaim kills the worker (see
        _release_lease) so a zombie pump can never double-dispatch."""
        now = time.monotonic()
        mature = [(lid, l) for lid, l in self.leases.items()
                  if l["owner_addr"] is not None
                  and now - l["granted_at"] > self.LEASE_PROBE_AGE_S]
        if not mature:
            return
        owners = {l["owner_addr"] for _, l in mature}
        verdict: Dict[tuple, str] = {}

        async def _probe(addr: tuple) -> None:
            try:
                await asyncio.wait_for(
                    self.pool.get(addr).call("ping"), timeout=5.0)
                verdict[addr] = "ok"
            except (asyncio.TimeoutError, TimeoutError):
                # Must precede OSError: on py>=3.11 asyncio.TimeoutError
                # IS builtin TimeoutError, a subclass of OSError — a
                # GIL-busy-but-alive driver would otherwise score 'dead'.
                verdict[addr] = "slow"
            except (ConnectionError, OSError):
                verdict[addr] = "dead"      # nothing listening: definitive
            except Exception:
                verdict[addr] = "slow"      # hang/timeout: ambiguous

        await asyncio.gather(*(_probe(a) for a in owners))
        for lease_id, lease in mature:
            v = verdict.get(lease["owner_addr"], "ok")
            if v == "ok":
                lease["reclaim_score"] = 0
                continue
            lease["reclaim_score"] = (
                lease.get("reclaim_score", 0) + (2 if v == "dead" else 1))
            if lease["reclaim_score"] < self.LEASE_RECLAIM_SCORE:
                continue
            logger.warning(
                "reclaiming lease %s: owner %s unreachable "
                "(score %d, last probe %s)",
                lease_id[:8], lease["owner_addr"],
                lease["reclaim_score"], v)
            await self._release_lease(lease_id, terminate=True)

    async def rpc_task_event_push(self, task_id: str, name: str,
                                  state: str, node_id: str = None) -> None:
        """Worker-pushed task events for lease-dispatched tasks (the
        controller never sees those specs; reference parity:
        task_event_buffer.h workers reporting to the GCS task manager)."""
        self._task_event(task_id, state,
                         spec={"name": name} if name else None,
                         node_id=node_id)

    async def rpc_task_event_push_batch(self, events: list,
                                        node_id: str = None) -> None:
        """Batched form (one frame per lease-dispatched batch)."""
        for ev in events:
            self._task_event(ev["task_id"], ev["state"],
                             spec={"name": ev["name"]}
                             if ev.get("name") else None,
                             node_id=node_id)

    async def rpc_task_finished(self, task_id: str, node_id: str) -> None:
        self._task_event(task_id, "FINISHED")
        entry = self.running.pop(task_id, None)
        if entry is not None:
            nid, req, spec = entry
            node = self.nodes.get(nid)
            pg_id = (spec.get("scheduling") or {}).get("placement_group")
            pg = self.placement_groups.get(pg_id) if pg_id else None
            if pg is not None:
                pg.release_for_task(task_id)
                if node is not None:
                    node.num_running = max(0, node.num_running - 1)
            elif node is not None:
                node.release(req)
        self._sched_event.set()

    # -------------------------------------------------------------- actors

    def _register_pending_actor(self, spec: dict, node_id: str) -> None:
        # Name uniqueness was checked/claimed at submission (rpc_submit_task).
        actor_id = spec["actor_id"]
        entry = self.actors.get(actor_id)
        created = entry is None
        if created:
            entry = ActorEntry(actor_id, spec)
            self.actors[actor_id] = entry
        entry.node_id = node_id
        self._persist_actor(entry, with_spec=created)
        if created and entry.name:
            self._persist_named(entry.namespace, entry.name, actor_id)

    async def rpc_actor_started(self, actor_id: str, addr,
                                worker_id: str, spec: dict = None,
                                node_id: str = None) -> dict:
        entry = self.actors.get(actor_id)
        if entry is None and spec is not None and node_id is not None:
            # daemon-local creation (distributed dispatch): the daemon
            # granted from its delegated block and this report is the
            # controller's FIRST sight of the actor — registration is
            # off the creation critical path (reference parity:
            # gcs_actor_scheduler learns lease results after the fact)
            self._register_pending_actor(spec, node_id)
            entry = self.actors.get(actor_id)
        if entry is None or entry.state == "DEAD":
            # never resurrect a DEAD actor (e.g. killed mid-restart)
            return {"status": "superseded"}
        if entry.state == "RESTARTING" and worker_id == entry.worker_id:
            # A pre-death incarnation re-announcing itself (e.g. its node
            # rejoined after a blip) while a restart is already queued:
            # accepting it would run two live instances. The daemon kills
            # the stale worker on this reply.
            return {"status": "superseded"}
        if entry.state == "ALIVE" and entry.worker_id is not None \
                and worker_id != entry.worker_id:
            # Same race, later: the replacement is already ALIVE when the
            # stale incarnation re-announces — it must not hijack the
            # directory entry.
            return {"status": "superseded"}
        entry.addr = tuple(addr)
        entry.worker_id = worker_id
        entry.state = "ALIVE"
        self._persist_actor(entry)
        for ev in entry.waiters:
            ev.set()
        entry.waiters.clear()
        return {"status": "ok"}

    async def rpc_actor_creation_failed(self, actor_id: str,
                                        reason: str) -> None:
        await self._handle_actor_death(actor_id, reason, restartable=False)

    async def rpc_actor_died(self, actor_id: str, reason: str) -> None:
        await self._handle_actor_death(actor_id, reason)

    async def _handle_actor_death(self, actor_id: str, reason: str,
                                  restartable: bool = True) -> None:
        entry = self.actors.get(actor_id)
        if entry is None or entry.state == "DEAD":
            return
        # Release creation-task resources tied to this actor.
        task_id = entry.creation_spec.get("task_id")
        await self.rpc_task_finished(task_id, entry.node_id or "")
        if restartable and entry.restarts < entry.max_restarts:
            entry.restarts += 1
            entry.state = "RESTARTING"
            entry.addr = None
            self._persist_actor(entry)
            logger.info("restarting actor %s (%d/%d): %s", actor_id[:8],
                        entry.restarts, entry.max_restarts, reason)
            spec = dict(entry.creation_spec)
            spec["is_restart"] = True
            self.pending.append(spec)
            self._sched_event.set()
        else:
            entry.state = "DEAD"
            entry.death_cause = reason
            self._persist_actor(entry)
            for ev in entry.waiters:
                ev.set()
            entry.waiters.clear()
            if entry.name:
                self.named_actors.pop((entry.namespace, entry.name), None)
                self._persist_named(entry.namespace, entry.name, None)
            if entry.addr is None:
                # Never came up: resolve the owner's creation ref with the
                # death cause so nothing blocks on it.
                await self._fail_task(entry.creation_spec,
                                      ActorDiedError(actor_id, reason))

    async def rpc_get_actor_info(self, actor_id: str,
                                 wait: bool = True) -> Optional[dict]:
        entry = self.actors.get(actor_id)
        if entry is None:
            # May not be registered yet (submit in flight): wait briefly.
            if wait:
                for _ in range(200):
                    await asyncio.sleep(0.02)
                    entry = self.actors.get(actor_id)
                    if entry is not None:
                        break
            if entry is None:
                return None
        while wait and entry.state in ("PENDING", "RESTARTING"):
            ev = asyncio.Event()
            entry.waiters.append(ev)
            try:
                await asyncio.wait_for(ev.wait(), timeout=120.0)
            except asyncio.TimeoutError:
                return {"state": entry.state, "addr": None,
                        "death_cause": "timeout waiting for actor start"}
        return {"state": entry.state, "addr": entry.addr,
                "node_id": entry.node_id, "worker_id": entry.worker_id,
                "death_cause": entry.death_cause, "name": entry.name}

    async def rpc_get_named_actor(self, name: str,
                                  namespace: str = "default") -> Optional[dict]:
        actor_id = self.named_actors.get((namespace, name))
        if actor_id is None:
            return None
        info = await self.rpc_get_actor_info(actor_id, wait=True)
        if info is None or info.get("state") == "DEAD":
            return None
        info["actor_id"] = actor_id
        return info

    async def rpc_kill_actor(self, actor_id: str,
                             no_restart: bool = True) -> bool:
        entry = self.actors.get(actor_id)
        if entry is None:
            return False
        if no_restart:
            entry.max_restarts = entry.restarts  # disable further restarts
        if entry.state == "ALIVE" and entry.node_id:
            node = self.nodes.get(entry.node_id)
            if node is not None:
                try:
                    await self.pool.get(node.addr).call(
                        "kill_actor_worker", actor_id=actor_id)
                except Exception:
                    pass
        await self._handle_actor_death(
            actor_id, "killed via ray_tpu_torch.kill()", restartable=not no_restart)
        return True

    async def rpc_list_actors(self) -> List[dict]:
        return [{
            "actor_id": a.actor_id, "name": a.name, "namespace": a.namespace,
            "state": a.state, "node_id": a.node_id, "restarts": a.restarts,
            "class_name": a.creation_spec.get("class_name"),
            "death_cause": a.death_cause,
        } for a in self.actors.values()]

    # --------------------------------------------------------- placement groups

    async def _finish_pg_reserve(self, pg, chosen: List[str]) -> None:
        """Background completion of a PG reservation: two-phase
        prepare/commit on every owning daemon (reference parity: GCS
        drives PrepareBundleResources/CommitBundleResources on raylets,
        gcs_placement_group_scheduler; the daemons' committed ledgers
        are what controller-restart reconciliation audits). On refusal
        the optimistic controller-side deduction rolls back and the PG
        re-enters the pending queue."""
        ok = await self._reserve_bundles_2pc(pg, chosen)
        if pg.state != "RESERVING":
            # removed/failed while we were on the wire: undo daemon state
            for nid in set(chosen):
                node = self.nodes.get(nid)
                if node is not None:
                    try:
                        await self.pool.get(node.addr).oneway(
                            "release_bundles", pg_id=pg.pg_id)
                    except Exception:
                        pass
            return
        if ok:
            pg.state = "CREATED"
            pg._wake()
            self._persist_pg(pg)
        else:
            # roll back the optimistic deduction WITHOUT mark_removed
            # (that would wake ready() waiters with a dead state)
            for b in pg.bundles:
                node = self.nodes.get(b.node_id)
                if node is not None:
                    node.release(b.resources)
                b.node_id = None
            pg.state = "PENDING"
            self.pending_pgs.append(pg)
        self._sched_event.set()

    async def _reserve_bundles_2pc(self, pg, chosen: List[str]) -> bool:
        by_node: Dict[str, list] = {}
        for b, nid in zip(pg.bundles, chosen):
            by_node.setdefault(nid, []).append(
                {"index": b.index, "resources": b.resources})

        async def _rpc(nid: str, method: str, **kw) -> bool:
            node = self.nodes.get(nid)
            if node is None or not node.alive:
                return False
            try:
                reply = await asyncio.wait_for(
                    self.pool.get(node.addr).call(
                        method, pg_id=pg.pg_id, **kw),
                    timeout=10.0)
                return bool(reply and reply.get("ok"))
            except Exception:
                return False

        nids = list(by_node)
        # concurrent prepares: serial rounds would add O(nodes) latency
        # AND let early prepares expire their daemon-side TTL before
        # the commit round reaches them
        acks = await asyncio.gather(
            *(_rpc(nid, "prepare_bundles", bundles=by_node[nid])
              for nid in nids))
        if not all(acks):
            await asyncio.gather(
                *(_rpc(nid, "release_bundles")
                  for nid, ok in zip(nids, acks) if ok))
            return False
        commits = await asyncio.gather(
            *(_rpc(nid, "commit_bundles") for nid in nids))
        if not all(commits):
            # a daemon died or expired its prepare mid-2PC: tear the
            # whole reservation down (committed daemons drop their
            # ledger entries) and let the pump retry
            await asyncio.gather(*(_rpc(nid, "release_bundles")
                                   for nid in nids))
            return False
        return True

    async def rpc_create_placement_group(self, pg_id: str, bundles,
                                         strategy: str = "PACK",
                                         name: str = "") -> dict:
        from .placement import PlacementGroupEntry
        pg = PlacementGroupEntry(pg_id, bundles, strategy, name)
        self.placement_groups[pg_id] = pg
        self.pending_pgs.append(pg)
        self._persist_pg(pg)
        self._sched_event.set()
        return {"placement_group_id": pg_id}

    async def rpc_pg_wait_ready(self, pg_id: str,
                                timeout: Optional[float] = None) -> dict:
        pg = self.placement_groups.get(pg_id)
        if pg is None:
            return {"state": "NOT_FOUND"}
        while pg.state in ("PENDING", "RESERVING"):
            ev = asyncio.Event()
            pg.waiters.append(ev)
            try:
                await asyncio.wait_for(ev.wait(), timeout=timeout or 120.0)
            except asyncio.TimeoutError:
                # Still pending at the deadline. If the scheduler has
                # recorded an infeasibility note, surface it so callers
                # can distinguish "cluster busy" from "can never fit on
                # current nodes".
                return {"state": pg.state, "timeout": True,
                        "reason": pg.failure_reason or "timeout"}
        return {"state": pg.state, "reason": pg.failure_reason}

    async def rpc_remove_placement_group(self, pg_id: str) -> bool:
        pg = self.placement_groups.get(pg_id)
        if pg is None:
            return False
        if pg in self.pending_pgs:
            self.pending_pgs.remove(pg)
        # Kill actors created inside this PG (reference semantics: removing
        # a PG stops its leaseholders).
        for actor in list(self.actors.values()):
            sched = (actor.creation_spec.get("scheduling") or {})
            if sched.get("placement_group") == pg_id \
                    and actor.state in ("ALIVE", "PENDING", "RESTARTING"):
                await self.rpc_kill_actor(actor.actor_id, no_restart=True)
        if pg.state in ("CREATED", "RESERVING"):
            # RESERVING: the in-flight _finish_pg_reserve sees the state
            # change and tells the daemons to drop their ledger entries
            pg.release_all(self.nodes)
            for b in pg.bundles:
                node = self.nodes.get(b.node_id or "")
                if node is not None:
                    try:
                        await self.pool.get(node.addr).oneway(
                            "release_bundles", pg_id=pg_id)
                    except Exception:
                        pass
        else:
            pg.mark_removed()       # wakes any pg.ready() waiters
        # Drop the entry so long-lived drivers creating/removing many PGs
        # (e.g. Tune sweeps) don't grow the table without bound. pop():
        # concurrent removals may race past the None check above.
        self.placement_groups.pop(pg_id, None)
        if self.store is not None:
            self.store.delete("placement_groups", pg_id)
        self._sched_event.set()
        return True

    async def rpc_placement_group_table(self) -> Dict[str, dict]:
        return {pg_id: pg.to_dict()
                for pg_id, pg in self.placement_groups.items()}

    # ------------------------------------------------------------------ kv

    async def rpc_kv_put(self, key: str, value: bytes,
                         overwrite: bool = True) -> bool:
        if not overwrite and key in self.kv:
            return False
        self.kv[key] = value
        if self.store is not None:
            self.store.put("kv", key, value)
        if key.startswith(FN_STORE_PREFIX):
            self._check_fn_store_growth()
        return True

    def _check_fn_store_growth(self) -> None:
        """Warn (once per doubling) when exported code blobs exceed
        fn_store_max_bytes.

        Exports are content-addressed and live for the session (reference
        parity: function_manager.py — GCS fn exports are never evicted
        mid-job, since queued specs may reference any of them). Unbounded
        growth here means a driver is re-capturing fresh state inside a
        decorator loop; surface that loudly instead of evicting blobs out
        from under queued tasks."""
        from .config import get_config
        limit = get_config().fn_store_max_bytes
        total = sum(len(v) for k, v in self.kv.items()
                    if k.startswith(FN_STORE_PREFIX))
        warned = getattr(self, "_fn_store_warned_at", 0)
        if total > limit and total >= 2 * max(warned, limit // 2):
            self._fn_store_warned_at = total
            logger.warning(
                "function store holds %.1f MB of exported code blobs "
                "(> %.1f MB): a driver may be re-creating remote "
                "functions with fresh captured state in a loop",
                total / 1e6, limit / 1e6)

    async def rpc_kv_get(self, key: str) -> Optional[bytes]:
        return self.kv.get(key)

    async def rpc_kv_del(self, key: str) -> bool:
        existed = self.kv.pop(key, None) is not None
        if existed and self.store is not None:
            self.store.delete("kv", key)
        return existed

    async def rpc_kv_keys(self, prefix: str = "") -> List[str]:
        return [k for k in self.kv if k.startswith(prefix)]

    # -------------------------------------------------------------- pubsub

    async def rpc_subscribe(self, topic: str, addr) -> None:
        subs = self.subscribers.setdefault(topic, [])
        if tuple(addr) not in subs:        # idempotent: clients refresh
            subs.append(tuple(addr))

    async def rpc_publish(self, topic: str, message) -> int:
        subs = self.subscribers.get(topic, [])
        delivered = 0
        for addr in list(subs):
            try:
                await self.pool.get(addr).oneway(
                    "pubsub_message", topic=topic, message=message)
                delivered += 1
            except Exception:
                subs.remove(addr)
        return delivered

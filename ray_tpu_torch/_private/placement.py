"""Placement groups: controller-side bundle reservation (two-phase).

Reference parity: src/ray/gcs/gcs_server/gcs_placement_group_manager.h:232
and the bundle scheduling policies (policy/bundle_scheduling_policy.h:82-106
— PACK / SPREAD / STRICT_PACK / STRICT_SPREAD). Our controller owns all
resource accounting, so prepare/commit is atomic by construction; the
prepare/commit split is kept in the data model for when daemons hold
authoritative local state.

Tasks/actors scheduled into a PG consume from the bundle's reservation,
not from node-available resources.
"""

from __future__ import annotations

import asyncio
from typing import Dict, List, Optional, Tuple

VALID_STRATEGIES = ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD")


class Bundle:
    __slots__ = ("index", "resources", "node_id", "available")

    def __init__(self, index: int, resources: Dict[str, float]):
        self.index = index
        self.resources = dict(resources)
        self.node_id: Optional[str] = None
        self.available = dict(resources)   # remaining capacity inside bundle

    def fits(self, req: Dict[str, float]) -> bool:
        return all(self.available.get(k, 0.0) + 1e-9 >= v
                   for k, v in req.items())

    def acquire(self, req: Dict[str, float]) -> None:
        for k, v in req.items():
            self.available[k] = self.available.get(k, 0.0) - v

    def release(self, req: Dict[str, float]) -> None:
        for k, v in req.items():
            self.available[k] = min(self.resources.get(k, 0.0),
                                    self.available.get(k, 0.0) + v)


class PlacementGroupEntry:
    def __init__(self, pg_id: str, bundles: List[Dict[str, float]],
                 strategy: str, name: str = ""):
        if strategy not in VALID_STRATEGIES:
            raise ValueError(f"invalid strategy {strategy!r}; "
                             f"one of {VALID_STRATEGIES}")
        self.pg_id = pg_id
        self.strategy = strategy
        self.name = name
        self.bundles = [Bundle(i, b) for i, b in enumerate(bundles)]
        self.state = "PENDING"           # PENDING | CREATED | REMOVED | FAILED
        self.failure_reason = ""
        self.waiters: List[asyncio.Event] = []
        # task_id -> (bundle_index, resources) for release on completion
        self.task_usage: Dict[str, Tuple[int, Dict[str, float]]] = {}

    # ------------------------------------------------------------ placement

    def choose_nodes(self, nodes: List):
        """Pick a node per bundle from the controller's availability
        view WITHOUT committing. Returns (chosen, "") on success or
        (None, reason) — "" retry later, non-empty never placeable.
        """
        alive = [n for n in nodes if n.alive]
        # Each attempt re-derives the infeasibility note from the CURRENT
        # nodes — clear any stale reason from earlier cluster states.
        self.failure_reason = ""
        # Infeasibility note (every strategy): a bundle larger than every
        # CURRENT node's total capacity. Reference semantics keep the PG
        # PENDING (the cluster may grow / late nodes may register), so this
        # is retryable — the reason is recorded for ready()-timeout
        # messages and the state API.
        for i, b in enumerate(self.bundles):
            if alive and not any(
                    all(n.resources_total.get(k, 0.0) + 1e-9 >= v
                        for k, v in b.resources.items()) for n in alive):
                self.failure_reason = (
                    f"bundle {i} {b.resources} exceeds every alive node's "
                    f"total capacity (cluster may still be scaling up)")
                return None, ""
        # Work on a scratch copy of availability so failed prepares roll back.
        scratch = {n.node_id: dict(n.resources_avail) for n in alive}

        def fits(node, req):
            return all(scratch[node.node_id].get(k, 0.0) + 1e-9 >= v
                       for k, v in req.items())

        def take(node, req):
            for k, v in req.items():
                scratch[node.node_id][k] = \
                    scratch[node.node_id].get(k, 0.0) - v

        chosen: List[Optional[str]] = [None] * len(self.bundles)
        if self.strategy in ("STRICT_PACK", "PACK"):
            # Try to fit everything on one node first.
            packed = None
            for n in alive:
                ok = True
                snap = dict(scratch[n.node_id])
                for b in self.bundles:
                    if fits(n, b.resources):
                        take(n, b.resources)
                    else:
                        ok = False
                        break
                if ok:
                    packed = n.node_id
                    break
                scratch[n.node_id] = snap
            if packed is not None:
                chosen = [packed] * len(self.bundles)
            elif self.strategy == "STRICT_PACK":
                if not self._feasible_on_one_node(alive):
                    self.failure_reason = (
                        "STRICT_PACK infeasible on current nodes: no "
                        "single node can hold all bundles")
                return None, ""         # retry when resources free up
            else:
                # PACK soft-fallback: greedy first-fit across nodes.
                chosen = self._greedy(alive, scratch, fits, take)
                if chosen is None:
                    return None, ""
        elif self.strategy in ("STRICT_SPREAD", "SPREAD"):
            used_nodes: set = set()
            for i, b in enumerate(self.bundles):
                cand = [n for n in alive
                        if n.node_id not in used_nodes and fits(n, b.resources)]
                if not cand and self.strategy == "SPREAD":
                    cand = [n for n in alive if fits(n, b.resources)]
                if not cand:
                    if self.strategy == "STRICT_SPREAD" \
                            and len(alive) < len(self.bundles):
                        self.failure_reason = (
                            "STRICT_SPREAD infeasible on current nodes: "
                            f"{len(self.bundles)} bundles > "
                            f"{len(alive)} nodes")
                    return None, ""     # retry when nodes join/free up
                node = max(cand, key=lambda n: sum(
                    scratch[n.node_id].get(k, 0.0) for k in b.resources))
                chosen[i] = node.node_id
                used_nodes.add(node.node_id)
                take(node, b.resources)

        return chosen, ""

    def commit(self, chosen: List[str], nodes_by_id: Dict) -> None:
        """Deduct the chosen bundles from the controller's node
        availability and pin the assignments (does NOT flip state —
        the caller sets CREATED once the daemon-side reservation is
        confirmed)."""
        for b, node_id in zip(self.bundles, chosen):
            b.node_id = node_id
            node = nodes_by_id.get(node_id)
            if node is not None:
                node.acquire(b.resources)

    def _wake(self) -> None:
        for ev in self.waiters:
            ev.set()
        self.waiters.clear()

    def fail(self, reason: str) -> None:
        self.state = "FAILED"
        self.failure_reason = reason
        self._wake()

    def mark_removed(self) -> None:
        self.state = "REMOVED"
        self._wake()

    def _greedy(self, alive, scratch, fits, take):
        chosen = []
        for b in self.bundles:
            cand = [n for n in alive if fits(n, b.resources)]
            if not cand:
                return None
            node = cand[0]
            chosen.append(node.node_id)
            take(node, b.resources)
        return chosen

    def _feasible_on_one_node(self, alive) -> bool:
        total: Dict[str, float] = {}
        for b in self.bundles:
            for k, v in b.resources.items():
                total[k] = total.get(k, 0.0) + v
        return any(all(n.resources_total.get(k, 0.0) + 1e-9 >= v
                       for k, v in total.items()) for n in alive)

    # ------------------------------------------------------------ task use

    def resolve_bundle(self, bundle_index: int, req: Dict[str, float]):
        """Pick a bundle for a task. Returns (node_id, bundle_index) or
        ('__pending__', None) while the PG is still being placed, or
        (None, None) if the PG is gone/unsatisfiable."""
        if self.state == "PENDING":
            return "__pending__", None
        if self.state != "CREATED":
            return None, None
        def exceeds_total(b):
            return any(b.resources.get(k, 0.0) + 1e-9 < v
                       for k, v in req.items())

        if bundle_index is not None and bundle_index >= 0:
            if bundle_index >= len(self.bundles):
                return None, None
            b = self.bundles[bundle_index]
            if exceeds_total(b):
                return None, None          # can never fit: fail fast
            return (b.node_id, b.index) if b.fits(req) else ("__pending__", None)
        for b in self.bundles:
            if b.fits(req):
                return b.node_id, b.index
        if all(exceeds_total(b) for b in self.bundles):
            return None, None
        return "__pending__", None

    def acquire_for_task(self, task_id: str, bundle_index: int,
                         req: Dict[str, float]) -> None:
        b = self.bundles[bundle_index]
        b.acquire(req)
        self.task_usage[task_id] = (bundle_index, dict(req))

    def release_for_task(self, task_id: str) -> None:
        entry = self.task_usage.pop(task_id, None)
        if entry is not None:
            self.bundles[entry[0]].release(entry[1])

    def release_all(self, nodes_by_id: Dict) -> None:
        """Return every bundle's reservation to its node (PG removal)."""
        for b in self.bundles:
            node = nodes_by_id.get(b.node_id)
            if node is not None:
                node.release(b.resources)
        self.mark_removed()

    def to_dict(self) -> dict:
        return {
            "placement_group_id": self.pg_id,
            "name": self.name,
            "strategy": self.strategy,
            "state": self.state,
            "bundles": [{"bundle_index": b.index, "resources": b.resources,
                         "node_id": b.node_id} for b in self.bundles],
        }

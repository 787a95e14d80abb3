"""Placement group public API.

Reference parity: python/ray/util/placement_group.py:145 (placement_group,
PlacementGroup.ready/wait, remove_placement_group, placement_group_table).
The port's copy of ``ray_tpu/util/placement_group.py``; the reference's
pod-slice gang helper (``tpu_pod_placement_group``) spans several hosts
and waits for the multi-card slice (ROADMAP.md section A9).
"""

from __future__ import annotations

from typing import Dict, List, Optional

from .._private import state
from .._private.ids import PlacementGroupID


class PlacementGroup:
    def __init__(self, pg_id: str, bundles: List[Dict[str, float]],
                 strategy: str):
        self.id = pg_id
        self.bundle_specs = bundles
        self.strategy = strategy

    def ready(self, timeout: Optional[float] = None) -> bool:
        """Block until all bundles are reserved. Returns True if CREATED."""
        client = state.current_client()
        if getattr(client, "is_local_mode", False):
            return True
        reply = client.loop_runner.run_sync(
            client._controller().call("pg_wait_ready", pg_id=self.id,
                                      timeout=timeout),
            timeout=(timeout + 5.0) if timeout else None)
        if reply.get("state") == "FAILED" or (
                reply.get("timeout") and reply.get("reason")
                not in (None, "", "timeout")):
            # FAILED, or timed out while infeasible on the current nodes
            # (the PG itself stays PENDING server-side, matching the
            # reference: the cluster may still scale up).
            from ..exceptions import PlacementGroupUnavailableError
            raise PlacementGroupUnavailableError(
                f"placement group not placeable: {reply.get('reason')}")
        return reply.get("state") == "CREATED"

    def wait(self, timeout_seconds: Optional[float] = None) -> bool:
        try:
            return self.ready(timeout=timeout_seconds)
        except Exception:
            return False

    def __reduce__(self):
        return (PlacementGroup, (self.id, self.bundle_specs, self.strategy))

    def __repr__(self):
        return f"PlacementGroup({self.id[:12]}, {self.strategy}, " \
               f"{len(self.bundle_specs)} bundles)"


def placement_group(bundles: List[Dict[str, float]],
                    strategy: str = "PACK",
                    name: str = "") -> PlacementGroup:
    if not bundles or any(not b for b in bundles):
        raise ValueError("bundles must be a non-empty list of non-empty "
                         "resource dicts")
    from .._private.placement import VALID_STRATEGIES
    if strategy not in VALID_STRATEGIES:
        raise ValueError(f"invalid strategy {strategy!r}; "
                         f"one of {VALID_STRATEGIES}")
    client = state.current_client()
    pg_id = PlacementGroupID.generate().hex()
    pg = PlacementGroup(pg_id, [dict(b) for b in bundles], strategy)
    if getattr(client, "is_local_mode", False):
        client.placement_groups[pg_id] = pg
        return pg
    client.loop_runner.run_sync(client._controller().call(
        "create_placement_group", pg_id=pg_id,
        bundles=[dict(b) for b in bundles], strategy=strategy, name=name))
    return pg


def remove_placement_group(pg: PlacementGroup) -> None:
    client = state.current_client()
    if getattr(client, "is_local_mode", False):
        client.placement_groups.pop(pg.id, None)
        return
    client.loop_runner.run_sync(client._controller().call(
        "remove_placement_group", pg_id=pg.id))


def placement_group_table() -> Dict[str, dict]:
    client = state.current_client()
    if getattr(client, "is_local_mode", False):
        return {pg_id: {"state": "CREATED"}
                for pg_id in client.placement_groups}
    return client.loop_runner.run_sync(
        client._controller().call("placement_group_table"))


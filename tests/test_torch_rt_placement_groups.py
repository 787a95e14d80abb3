"""Placement groups: reserve/commit, strategies, task placement, removal.

Modeled on python/ray/tests/test_placement_group*.py."""

import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.exceptions import PlacementGroupUnavailableError
from ray_tpu_torch.util import (placement_group, remove_placement_group,
                          placement_group_table,
                          PlacementGroupSchedulingStrategy)


@pytest.fixture(scope="module")
def ray_start():
    ray_tpu_torch.init(num_cpus=8)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def test_pack_pg_reserves_and_schedules(ray_start):
    pg = placement_group([{"CPU": 2}, {"CPU": 2}], strategy="PACK")
    assert pg.ready(timeout=30)
    avail = ray_tpu_torch.available_resources()
    assert avail["CPU"] <= 4.0 + 1e-9  # 8 total - 4 reserved

    @ray_tpu_torch.remote(num_cpus=2)
    def where():
        return ray_tpu_torch.get_runtime_context().get_node_id()

    strat = PlacementGroupSchedulingStrategy(pg, 0)
    node = ray_tpu_torch.get(where.options(scheduling_strategy=strat).remote(),
                       timeout=60)
    assert node is not None
    remove_placement_group(pg)
    time.sleep(0.3)
    assert ray_tpu_torch.available_resources()["CPU"] >= 7.9


def test_strict_spread_needs_enough_nodes(ray_start):
    pg = placement_group([{"CPU": 1}] * 3, strategy="STRICT_SPREAD")
    # unsatisfiable on a 1-node cluster — satisfiability cannot
    # change while we wait, so a short timeout keeps the semantics
    with pytest.raises(PlacementGroupUnavailableError):
        pg.ready(timeout=5)

    n1 = ray_tpu_torch.add_fake_node(num_cpus=2)
    n2 = ray_tpu_torch.add_fake_node(num_cpus=2)
    try:
        pg2 = placement_group([{"CPU": 1}] * 3, strategy="STRICT_SPREAD")
        assert pg2.ready(timeout=60)
        table = placement_group_table()
        nodes = {b["node_id"] for b in table[pg2.id]["bundles"]}
        assert len(nodes) == 3, "STRICT_SPREAD must use distinct nodes"
        remove_placement_group(pg2)
    finally:
        ray_tpu_torch.remove_node(n1)
        ray_tpu_torch.remove_node(n2)


def test_strict_pack_one_node(ray_start):
    n1 = ray_tpu_torch.add_fake_node(num_cpus=4, resources={"tag_sp": 1.0})
    try:
        pg = placement_group([{"CPU": 2}, {"CPU": 2}], strategy="STRICT_PACK")
        assert pg.ready(timeout=60)
        table = placement_group_table()
        nodes = {b["node_id"] for b in table[pg.id]["bundles"]}
        assert len(nodes) == 1
        remove_placement_group(pg)
    finally:
        ray_tpu_torch.remove_node(n1)


def test_pg_infeasible_raises_on_timeout(ray_start):
    # Infeasible-on-current-nodes PGs stay PENDING (the cluster may still
    # scale up), but ready() surfaces the recorded reason at the deadline.
    pg = placement_group([{"CPU": 512}], strategy="STRICT_PACK")
    with pytest.raises(PlacementGroupUnavailableError):
        pg.ready(timeout=5)


def test_actor_in_pg(ray_start):
    pg = placement_group([{"CPU": 1}], strategy="PACK")
    assert pg.ready(timeout=30)

    @ray_tpu_torch.remote(num_cpus=1)
    class A:
        def ping(self):
            return "pong"

    a = A.options(scheduling_strategy=PlacementGroupSchedulingStrategy(pg, 0)
                  ).remote()
    assert ray_tpu_torch.get(a.ping.remote(), timeout=60) == "pong"
    # Removing the PG kills its actors.
    remove_placement_group(pg)
    time.sleep(1.0)
    with pytest.raises(ray_tpu_torch.exceptions.ActorDiedError):
        ray_tpu_torch.get(a.ping.remote(), timeout=30)


def test_pg_bundle_capacity_enforced(ray_start):
    pg = placement_group([{"CPU": 1}], strategy="PACK")
    assert pg.ready(timeout=30)

    @ray_tpu_torch.remote(num_cpus=2)
    def big():
        return 1

    strat = PlacementGroupSchedulingStrategy(pg, 0)
    with pytest.raises(PlacementGroupUnavailableError):
        ray_tpu_torch.get(big.options(scheduling_strategy=strat).remote(),
                    timeout=30)
    remove_placement_group(pg)

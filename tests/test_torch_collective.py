"""ray_tpu_torch.util.collective (host collectives over the port's
runtime) against ray_tpu.util.collective: ``test_collective.py``'s
``test_host_collectives`` mirrored, then allreduce, allgather,
broadcast and reducescatter of trees of torch tensors and numpy arrays.

Every reduction is bit-equal (no tolerance) to a numpy fold in rank
order and to ``ray_tpu.util.collective._tree_reduce`` (``jax.tree_util``
over ``functools.reduce``) on the same numpy inputs: both fold left in
rank order, one float32 operation per element and step."""

import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu.util.collective import collective as jcol
from ray_tpu_torch.util import collective as col
from ray_tpu_torch.util.collective import collective as pcol

WORLD = 3
OPS = {"sum": np.add, "product": np.multiply, "min": np.minimum,
       "max": np.maximum}


@pytest.fixture(scope="module")
def ray_start():
    rt.init(num_cpus=4)
    yield rt
    rt.shutdown()


@rt.remote
class CollectiveWorker:
    def __init__(self, rank, world):
        self.rank = rank
        self.world = world

    def setup(self, group):
        from ray_tpu_torch.util import collective as col
        col.init_collective_group(self.world, self.rank, group_name=group)
        return True

    def do_allreduce(self, group):
        from ray_tpu_torch.util import collective as col
        return col.allreduce(np.full((4,), float(self.rank + 1)),
                             group_name=group)

    def do_allgather(self, group):
        from ray_tpu_torch.util import collective as col
        return col.allgather(self.rank * 10, group_name=group)

    def do_broadcast(self, group):
        from ray_tpu_torch.util import collective as col
        return col.broadcast(f"from-{self.rank}", src_rank=2,
                             group_name=group)

    def do_sendrecv(self, group):
        from ray_tpu_torch.util import collective as col
        if self.rank == 0:
            col.send({"x": 42}, dst_rank=1, group_name=group)
            return None
        elif self.rank == 1:
            return col.recv(src_rank=0, group_name=group)
        return None

    def call(self, name, group, *args, **kwargs):
        from ray_tpu_torch.util import collective as col
        return getattr(col, name)(*args, group_name=group, **kwargs)

    def destroy(self, group):
        from ray_tpu_torch.util import collective as col
        col.destroy_collective_group(group)
        return True


def _tree(rank, seed=0):
    """A gradient-like tree: torch leaves, numpy leaves, nesting."""
    g = np.random.default_rng(seed + rank)
    f = lambda *s: g.standard_normal(s).astype(np.float32)
    return {"w": torch.from_numpy(f(5, 3)),
            "layers": [torch.from_numpy(f(7)), f(2, 2)],
            "pair": (f(3), torch.from_numpy(f(1)))}


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_numpy(v) for v in tree)
    return tree.numpy() if isinstance(tree, torch.Tensor) else tree


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _assert_bit_equal(got, want):
    gl, wl = _leaves(_numpy(got)), _leaves(_numpy(want))
    assert len(gl) == len(wl)
    for a, b in zip(gl, wl):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def _group(name):
    workers = [CollectiveWorker.remote(r, WORLD) for r in range(WORLD)]
    assert all(rt.get([w.setup.remote(name) for w in workers], timeout=120))
    return workers


def _end(workers, name):
    assert all(rt.get([w.destroy.remote(name) for w in workers],
                      timeout=60))
    for w in workers:
        rt.kill(w)


# ------------------------------------------------------ no runtime needed


@pytest.mark.parametrize("op", sorted(OPS))
def test_tree_reduce_bit_equal_to_reference(op):
    parts = [_tree(r, seed=3) for r in range(4)]
    got = pcol._tree_reduce(op, parts)
    assert isinstance(got["w"], torch.Tensor)
    assert isinstance(got["layers"][1], np.ndarray)
    assert isinstance(got["pair"], tuple)
    ref = jcol._tree_reduce(OPS[op], [_numpy(p) for p in parts])
    _assert_bit_equal(got, ref)
    fold = _numpy(parts[0])
    for p in parts[1:]:
        fold = jcol._tree_reduce(OPS[op], [fold, _numpy(p)])
    _assert_bit_equal(got, fold)


def test_tree_reduce_bare_leaves_and_none():
    assert pcol._tree_reduce("sum", [None, None]) is None
    assert pcol._tree_reduce("max", [1.5, 2.5, 0.5]) == 2.5
    t = pcol._tree_reduce("sum", [torch.ones(2), torch.ones(2)])
    assert torch.equal(t, torch.full((2,), 2.0))


# ------------------------------------------------------------ the runtime


def test_host_collectives(ray_start):
    workers = _group("g1")
    sums = rt.get([w.do_allreduce.remote("g1") for w in workers],
                  timeout=120)
    for s in sums:
        np.testing.assert_allclose(s, np.full((4,), 6.0))  # 1+2+3
    gathered = rt.get([w.do_allgather.remote("g1") for w in workers],
                      timeout=120)
    assert all(g == [0, 10, 20] for g in gathered)
    bcast = rt.get([w.do_broadcast.remote("g1") for w in workers],
                   timeout=120)
    assert bcast == ["from-2"] * WORLD
    out = rt.get([w.do_sendrecv.remote("g1") for w in workers],
                 timeout=120)
    assert out[1] == {"x": 42}
    _end(workers, "g1")


@pytest.mark.parametrize("op", sorted(OPS))
def test_allreduce_tensor_trees(ray_start, op):
    name = f"tree-{op}"
    workers = _group(name)
    trees = [_tree(r) for r in range(WORLD)]
    got = rt.get([w.call.remote("allreduce", name, trees[r], op=op)
                  for r, w in enumerate(workers)], timeout=120)
    ref = jcol._tree_reduce(OPS[op], [_numpy(t) for t in trees])
    for g in got:
        assert isinstance(g["w"], torch.Tensor)
        _assert_bit_equal(g, ref)
    _end(workers, name)


def test_allgather_broadcast_reducescatter_trees(ray_start):
    workers = _group("g2")
    trees = [_tree(r, seed=11) for r in range(WORLD)]
    gathered = rt.get([w.call.remote("allgather", "g2", trees[r])
                       for r, w in enumerate(workers)], timeout=120)
    for g in gathered:
        assert len(g) == WORLD
        for r in range(WORLD):
            _assert_bit_equal(g[r], trees[r])
    bcast = rt.get([w.call.remote("broadcast", "g2", trees[r], src_rank=1)
                    for r, w in enumerate(workers)], timeout=120)
    for b in bcast:
        _assert_bit_equal(b, trees[1])
    rows = [torch.arange(12, dtype=torch.float32).reshape(6, 2) * (r + 1)
            for r in range(WORLD)]
    shards = rt.get([w.call.remote("reducescatter", "g2", rows[r])
                     for r, w in enumerate(workers)], timeout=120)
    total = (rows[0] + rows[1]) + rows[2]
    for r, s in enumerate(shards):
        assert torch.equal(s, total[2 * r:2 * r + 2])
    assert rt.get([w.call.remote("barrier", "g2") for w in workers],
                  timeout=60) == [None] * WORLD
    _end(workers, "g2")


def test_declared_group_autojoins_and_name_is_reusable(ray_start):
    """create_collective_group declares the members; their first op
    joins; after teardown the name can be declared again."""
    for attempt in range(2):
        workers = [CollectiveWorker.remote(r, WORLD) for r in range(WORLD)]
        col.create_collective_group(workers, WORLD, [2, 0, 1],
                                    group_name="decl")
        vals = rt.get([w.call.remote("allgather", "decl", i)
                       for i, w in enumerate(workers)], timeout=120)
        # declared ranks [2, 0, 1]: rank r holds worker ranks.index(r)
        assert vals[0] == [1, 2, 0], (attempt, vals)
        _end(workers, "decl")

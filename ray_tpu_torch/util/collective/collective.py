"""Host-side actor collectives (cross-process, object-store transport).

The port's copy of ``ray_tpu/util/collective/collective.py`` (reference
parity: ray.util.collective's group management + GLOO backend,
python/ray/util/collective/collective.py:123-625,
collective_group/gloo_collective_group.py): rendezvous through a named
actor instead of Redis; payloads move through the shm object store.
This is the control-plane collective for host coordination (Train
worker groups exchanging addresses and metrics, RLlib learners
averaging gradients).

Payloads are trees (dicts, lists and tuples) of torch tensors, numpy
arrays or numbers. A CUDA tensor that crosses the object store comes
back on the CPU: the caller moves a result back to its device.
"""

from __future__ import annotations

import functools
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch


class ReduceOp:
    SUM = "sum"
    PRODUCT = "product"
    MIN = "min"
    MAX = "max"


_PAIRWISE = {
    ReduceOp.SUM: (np.add, torch.add),
    ReduceOp.PRODUCT: (np.multiply, torch.mul),
    ReduceOp.MIN: (np.minimum, torch.minimum),
    ReduceOp.MAX: (np.maximum, torch.maximum),
}


def _tree_reduce(op: str, parts: List[Any]):
    """Elementwise-reduce matching trees (dicts, lists and tuples of
    tensors, arrays or numbers, e.g. whole gradient trees, or bare
    leaves), folding left in the order given: ``jax.tree_util.tree_map``
    over ``functools.reduce`` in the reference."""
    first = parts[0]
    if isinstance(first, dict):
        return {k: _tree_reduce(op, [p[k] for p in parts]) for k in first}
    if isinstance(first, (list, tuple)):
        out = [_tree_reduce(op, list(leaves)) for leaves in zip(*parts)]
        return type(first)(out) if isinstance(first, list) else tuple(out)
    if first is None:
        return None
    np_op, torch_op = _PAIRWISE[op]
    if isinstance(first, torch.Tensor):
        return functools.reduce(torch_op, parts)
    return functools.reduce(np_op, parts)


class _GroupActor:
    """Rendezvous + reduction point for one collective group (async actor)."""

    def __init__(self, world_size: int,
                 declared_ranks: Optional[Dict[str, int]] = None):
        import asyncio
        self.world_size = world_size
        # actor_id -> rank, set by create_collective_group so member
        # actors can auto-join without an explicit init call.
        self.declared_ranks = declared_ranks or {}
        self._ops: Dict[str, dict] = {}
        self._mailbox: Dict[tuple, Any] = {}
        self._lock = asyncio.Lock()
        self._events: Dict[str, Any] = {}
        self._departed: set = set()

    async def deregister(self, rank: int) -> int:
        """A rank leaving the group (destroy is collective). Returns the
        number of ranks still registered — the caller that drops it to
        zero kills the rendezvous actor, so teardown by a fast-finishing
        rank can't yank the mailbox out from under peers mid-send."""
        self._departed.add(rank)
        return self.world_size - len(self._departed)

    async def remaining(self) -> int:
        return self.world_size - len(self._departed)

    async def declared_rank_of(self, actor_id: str):
        return self.declared_ranks.get(actor_id)

    async def get_world_size(self) -> int:
        return self.world_size

    async def _op_slot(self, key: str):
        import asyncio
        async with self._lock:
            slot = self._ops.get(key)
            if slot is None:
                slot = {"parts": {}, "event": asyncio.Event(), "result": None}
                self._ops[key] = slot
            return slot

    async def contribute(self, key: str, rank: int, payload,
                         op: Optional[str], mode: str):
        """All ranks call; returns the collective result for this op key.

        Reduction ops fold contributions into a running accumulator in
        RANK order (deterministic fp results); out-of-order arrivals are
        buffered until their turn, so memory is O(pending prefix gap),
        typically one payload, instead of the old O(world x payload).
        Only allgather inherently retains every part.
        """
        import asyncio
        slot = await self._op_slot(key)
        seen = slot.setdefault("seen", set())
        if rank in seen:
            raise ValueError(
                f"rank {rank} contributed twice to collective {key!r} "
                f"(duplicate rank assignment or replayed call)")
        seen.add(rank)
        if mode in ("allreduce", "reducescatter"):
            reduce_op = (ReduceOp.SUM if mode == "reducescatter"
                         else (op or ReduceOp.SUM))
            buf = slot.setdefault("buffer", {})
            buf[rank] = payload
            nxt = slot.setdefault("next_rank", 0)
            while nxt in buf:
                part = buf.pop(nxt)
                acc = slot.get("acc")
                slot["acc"] = part if acc is None else _tree_reduce(
                    reduce_op, [acc, part])
                nxt += 1
            slot["next_rank"] = nxt
        elif mode == "allgather":
            slot["parts"][rank] = payload
        elif mode == "broadcast":
            if rank == int(op or 0):
                slot["acc"] = payload
        if len(seen) == self.world_size:
            if mode in ("allreduce", "reducescatter"):
                slot["result"] = slot.pop("acc")
            elif mode == "allgather":
                slot["result"] = [slot["parts"][r]
                                  for r in range(self.world_size)]
            elif mode == "broadcast":
                slot["result"] = slot.pop("acc")
            elif mode == "barrier":
                slot["result"] = True
            slot["event"].set()
        await asyncio.wait_for(slot["event"].wait(), timeout=300.0)
        result = slot["result"]
        slot.setdefault("claimed", 0)
        slot["claimed"] += 1
        if slot["claimed"] >= self.world_size:
            self._ops.pop(key, None)
        if mode == "reducescatter":
            # Each rank gets its shard of the reduced tensor.
            if isinstance(result, torch.Tensor):
                return torch.tensor_split(result, self.world_size,
                                          dim=0)[rank].clone()
            arr = np.asarray(result)
            return np.array_split(arr, self.world_size, axis=0)[rank]
        return result

    async def post(self, dst_rank: int, tag: str, payload):
        import asyncio
        key = (dst_rank, tag)
        self._mailbox[key] = payload
        ev = self._events.pop(key, None)
        if ev is not None:
            ev.set()
        return True

    async def take(self, dst_rank: int, tag: str):
        import asyncio
        key = (dst_rank, tag)
        if key not in self._mailbox:
            ev = self._events.setdefault(key, asyncio.Event())
            await asyncio.wait_for(ev.wait(), timeout=300.0)
        return self._mailbox.pop(key)


class _GroupHandle:
    def __init__(self, actor, world_size: int, rank: int, name: str):
        self.actor = actor
        self.world_size = world_size
        self.rank = rank
        self.name = name
        self.op_counter = 0
        self.send_tags: Dict[int, int] = {}
        self.recv_tags: Dict[int, int] = {}


_groups: Dict[str, _GroupHandle] = {}
_groups_lock = threading.Lock()


def _group_actor_name(group_name: str) -> str:
    return f"__collective_group__{group_name}"


def init_collective_group(world_size: int, rank: int,
                          backend: str = "host",
                          group_name: str = "default") -> None:
    """Join a collective group (all members must call this)."""
    import ray_tpu_torch as rt

    name = _group_actor_name(group_name)
    actor = None
    if rank == 0:
        _reap_stale_group(name)
        GroupActor = rt.remote(_GroupActor)
        actor = GroupActor.options(name=name, lifetime="detached").remote(
            world_size)
    else:
        # Bind only to a FRESH group actor (remaining == world_size).
        # A stale actor from a previous run can briefly hold the name
        # while rank 0 reaps + recreates it; binding to that one would
        # leave this member holding a dead handle (TOCTOU), so keep
        # polling until the fresh incarnation appears.
        deadline = time.time() + 60
        while time.time() < deadline:
            try:
                candidate = rt.get_actor(name)
                remaining = rt.get(candidate.remaining.remote(),
                                        timeout=10)
                world = rt.get(candidate.get_world_size.remote(),
                                    timeout=10)
                if remaining == world == world_size:
                    actor = candidate
                    break
            except Exception:
                pass
            time.sleep(0.2)
        if actor is None:
            raise TimeoutError(
                f"collective group {group_name!r} rendezvous timed out")
    with _groups_lock:
        _groups[group_name] = _GroupHandle(actor, world_size, rank,
                                           group_name)


def create_collective_group(actors, world_size: int, ranks: List[int],
                            backend: str = "host",
                            group_name: str = "default") -> None:
    """Declarative variant (reference collective.py:160): the caller
    declares the members and their ranks; member actors then auto-join on
    their first collective op (or call init_collective_group explicitly)."""
    import ray_tpu_torch as rt
    if len(actors) != world_size or len(ranks) != world_size:
        raise ValueError(
            f"need exactly world_size={world_size} actors and ranks "
            f"(got {len(actors)} actors, {len(ranks)} ranks)")
    if sorted(ranks) != list(range(world_size)):
        raise ValueError(f"ranks must be a permutation of 0..{world_size-1}, "
                         f"got {ranks}")
    declared = {a._actor_id: r for a, r in zip(actors, ranks)}
    name = _group_actor_name(group_name)
    _reap_stale_group(name)
    GroupActor = rt.remote(_GroupActor)
    h = GroupActor.options(name=name, lifetime="detached").remote(
        world_size, declared)
    # Surface creation failures (e.g. a live group already owns the name)
    # instead of silently letting members autojoin a stale actor.
    rt.get(h.get_world_size.remote(), timeout=60)


def _reap_stale_group(name: str) -> None:
    """If a previous group actor with this name is dead, or its teardown
    has begun (any member deregistered — including the case where a peer
    crashed and the survivors drained partway), kill it so the name is
    reusable. Only a fully-registered live group (remaining == world_size)
    is left alone — creating over it then fails loudly."""
    import ray_tpu_torch as rt
    try:
        existing = rt.get_actor(name)
    except Exception:
        return
    try:
        remaining = rt.get(existing.remaining.remote(), timeout=10)
        world = rt.get(existing.get_world_size.remote(), timeout=10)
        stale = remaining < world
    except Exception:
        stale = True          # dead/unresponsive actor holds the name
    if stale:
        try:
            rt.kill(existing)
        except Exception:
            pass


def _handle(group_name: str) -> _GroupHandle:
    h = _groups.get(group_name)
    if h is None:
        h = _try_autojoin(group_name)
    if h is None:
        raise RuntimeError(
            f"collective group {group_name!r} not initialized in this "
            f"process; call init_collective_group first (or declare it "
            f"with create_collective_group)")
    return h


def _try_autojoin(group_name: str) -> Optional[_GroupHandle]:
    """Inside an actor declared via create_collective_group: look up our
    rank from the group actor and join."""
    import ray_tpu_torch as rt
    actor_id = rt.get_runtime_context().get_actor_id()
    if actor_id is None:
        return None
    try:
        group_actor = rt.get_actor(_group_actor_name(group_name))
        rank = rt.get(group_actor.declared_rank_of.remote(actor_id),
                           timeout=30)
    except Exception:
        return None
    if rank is None:
        return None
    world_size = rt.get(group_actor.get_world_size.remote(), timeout=30)
    with _groups_lock:
        h = _groups.setdefault(
            group_name, _GroupHandle(group_actor, world_size, rank,
                                     group_name))
    return h


def _run_op(group_name: str, payload, op, mode: str):
    import ray_tpu_torch as rt
    h = _handle(group_name)
    key = f"{mode}:{h.op_counter}"
    h.op_counter += 1
    return rt.get(h.actor.contribute.remote(key, h.rank, payload, op,
                                                 mode), timeout=300)


def allreduce(tensor, group_name: str = "default",
              op: str = ReduceOp.SUM):
    return _run_op(group_name, tensor, op, "allreduce")


def allgather(tensor, group_name: str = "default") -> List:
    return _run_op(group_name, tensor, None, "allgather")


def reducescatter(tensor, group_name: str = "default"):
    return _run_op(group_name, tensor, None, "reducescatter")


def broadcast(tensor, src_rank: int = 0, group_name: str = "default"):
    return _run_op(group_name, tensor, src_rank, "broadcast")


def barrier(group_name: str = "default") -> None:
    _run_op(group_name, None, None, "barrier")


def send(tensor, dst_rank: int, group_name: str = "default") -> None:
    import ray_tpu_torch as rt
    h = _handle(group_name)
    tag = h.send_tags.get(dst_rank, 0)
    h.send_tags[dst_rank] = tag + 1
    rt.get(h.actor.post.remote(dst_rank,
                                    f"{h.rank}->{dst_rank}:{tag}", tensor),
                timeout=300)


def recv(src_rank: int, group_name: str = "default"):
    import ray_tpu_torch as rt
    h = _handle(group_name)
    tag = h.recv_tags.get(src_rank, 0)
    h.recv_tags[src_rank] = tag + 1
    return rt.get(h.actor.take.remote(h.rank,
                                           f"{src_rank}->{h.rank}:{tag}"),
                       timeout=300)


def destroy_collective_group(group_name: str = "default") -> None:
    """Collective teardown: each rank deregisters; whichever rank drops
    the registration count to zero kills the detached rendezvous actor.
    If a member crashed without deregistering, the count never reaches
    zero and the actor outlives the group — _reap_stale_group then
    detects the partial teardown (remaining < world_size) and reclaims
    the name on the next create/init with this group name."""
    import ray_tpu_torch as rt
    with _groups_lock:
        h = _groups.pop(group_name, None)
    if h is not None:
        try:
            remaining = rt.get(h.actor.deregister.remote(h.rank),
                                    timeout=30)
            if remaining <= 0:
                rt.kill(rt.get_actor(
                    _group_actor_name(group_name)))
        except Exception:
            pass

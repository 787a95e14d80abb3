"""The port's actor runtime held against the JAX package's: the same
serialized bytes, the same arena layout, the same placement decisions
and every public name of ``ray_tpu.__all__``."""

import os

import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu._native import arena as jax_arena
from ray_tpu._private import placement as jax_placement
from ray_tpu._private import serialization as jax_ser
from ray_tpu_torch._native import arena as port_arena
from ray_tpu_torch._private import placement as port_placement
from ray_tpu_torch._private import serialization as port_ser

_RNG = np.random.default_rng(0)
VALUES = {
    "f32": _RNG.standard_normal((64, 33)).astype(np.float32),
    "i8_fortran": np.asfortranarray(
        _RNG.integers(-128, 127, (17, 9), dtype=np.int8)),
    "big_f64": _RNG.standard_normal(40_000),
    "nested": {"a": [1, 2.5, "x", None], "b": {"c": (b"\x00\x01", True)},
               "arr": np.arange(12, dtype=np.int64).reshape(3, 4)},
    "bytes": b"\x00rtpu" * 1000,
    "str_list": ["alpha", "beta", "gamma"] * 5,
}


@pytest.mark.parametrize("name", sorted(VALUES))
def test_serialized_bytes_identical(name):
    """Everything but a torch tensor takes the reference's stream, byte
    for byte, out-of-band buffers included."""
    v = VALUES[name]
    ref, port = jax_ser.serialize(v), port_ser.serialize(v)
    assert port.to_flat() == ref.to_flat()
    assert len(port.buffers) == len(ref.buffers)
    back = port_ser.SerializedObject.from_flat(ref.to_flat()).deserialize()
    if isinstance(v, np.ndarray):
        np.testing.assert_array_equal(back, v)


def test_arena_written_by_port_reads_in_reference():
    if not (port_arena.available() and jax_arena.available()):
        pytest.skip("g++ could not build the arena here")
    name = f"rtpu_parity_{os.getpid()}_{_RNG.integers(1 << 30)}"
    a = port_arena.Arena.create(name, 1 << 22)
    assert a is not None
    try:
        payloads = {f"{i:032x}": _RNG.bytes(int(n))
                    for i, n in enumerate((1, 100, 4096, 70_000))}
        for oid, data in payloads.items():
            buf = a.create_buffer(oid, len(data))
            buf[:] = data
            buf.release()
            a.seal(oid)
        b = jax_arena.Arena.attach(name)
        assert b is not None
        try:
            assert b.stats() == a.stats()
            for oid, data in payloads.items():
                ref = b.get(oid)
                assert ref is not None, oid
                assert bytes(ref.buf) == data
                ref.release()
        finally:
            b.detach()
    finally:
        a.unlink()
        a.detach()


class _Node:
    def __init__(self, node_id, resources):
        self.node_id = node_id
        self.alive = True
        self.resources_total = dict(resources)
        self.resources_avail = dict(resources)


NODE_TABLE = [("n0", {"CPU": 4.0, "GPU": 1.0}), ("n1", {"CPU": 2.0}),
              ("n2", {"CPU": 8.0, "GPU": 2.0}), ("n3", {"CPU": 3.0})]
BUNDLE_SETS = {
    "small": [{"CPU": 1.0}] * 3,
    "gpu": [{"CPU": 1.0, "GPU": 1.0}, {"CPU": 2.0}],
    "wide": [{"CPU": 3.0}, {"CPU": 3.0}, {"CPU": 2.0}, {"CPU": 1.0}],
    "too_many": [{"CPU": 1.0}] * 5,
}


@pytest.mark.parametrize("bundles", sorted(BUNDLE_SETS))
@pytest.mark.parametrize("strategy", ["PACK", "SPREAD", "STRICT_PACK",
                                      "STRICT_SPREAD"])
def test_placement_choices_match(strategy, bundles):
    def choose(mod):
        nodes = [_Node(i, r) for i, r in NODE_TABLE]
        pg = mod.PlacementGroupEntry("pg", BUNDLE_SETS[bundles], strategy)
        return pg.choose_nodes(nodes), pg.failure_reason

    assert choose(port_placement) == choose(jax_placement)


def test_public_names():
    missing = [n for n in ray_tpu.__all__ if not hasattr(ray_tpu_torch, n)]
    assert not missing, missing
    assert set(ray_tpu.__all__) <= set(ray_tpu_torch.__all__)

"""ctypes binding for the C++ shared-memory arena store.

Reference parity: the plasma client's create/seal/get/release surface
(src/ray/object_manager/plasma/client.h) over the native arena in
src/arena_store.cc. Buffers returned are zero-copy memoryviews into the
mapped segment; Ref keeps the refcount held until closed/GC'd.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

from . import load_library

ID_LEN = 32


def _lib():
    lib = load_library("libarena", "arena_store.cc")
    if lib is None:
        return None
    if not getattr(lib, "_arena_configured", False):
        u64, i64, vp, cp = (ctypes.c_uint64, ctypes.c_int64,
                            ctypes.c_void_p, ctypes.c_char_p)
        lib.arena_create.restype = vp
        lib.arena_create.argtypes = [cp, u64, u64]
        lib.arena_attach.restype = vp
        lib.arena_attach.argtypes = [cp]
        lib.arena_alloc.restype = i64
        lib.arena_alloc.argtypes = [vp, cp, u64]
        lib.arena_seal.argtypes = [vp, cp]
        lib.arena_get.argtypes = [vp, cp, ctypes.POINTER(u64),
                                  ctypes.POINTER(u64)]
        lib.arena_release.argtypes = [vp, cp]
        lib.arena_delete.argtypes = [vp, cp]
        lib.arena_contains.argtypes = [vp, cp]
        lib.arena_evict.restype = u64
        lib.arena_evict.argtypes = [vp, u64, ctypes.c_char_p, u64,
                                    ctypes.POINTER(u64)]
        lib.arena_stats.argtypes = [vp, ctypes.POINTER(u64),
                                    ctypes.POINTER(u64),
                                    ctypes.POINTER(u64)]
        lib.arena_stats_ext.argtypes = [vp, ctypes.POINTER(u64)]
        lib.arena_base.restype = vp
        lib.arena_base.argtypes = [vp]
        lib.arena_detach.argtypes = [vp]
        lib.arena_unlink.argtypes = [cp]
        lib._arena_configured = True
    return lib


def available() -> bool:
    import os
    if os.environ.get("RAY_TPU_DISABLE_NATIVE_ARENA"):
        return False
    return _lib() is not None


def _id_bytes(object_id: str) -> bytes:
    b = object_id.encode()[:ID_LEN]
    return b.ljust(ID_LEN, b"0")


class Ref:
    """Held reference to a sealed object; zero-copy view into the arena."""

    def __init__(self, arena: "Arena", object_id: str, offset: int,
                 size: int):
        self._arena = arena
        self._id = object_id
        self.size = size
        addr = arena._base + offset
        self._view = memoryview(
            (ctypes.c_char * size).from_address(addr)).cast("B")
        self._released = False

    @property
    def buf(self) -> memoryview:
        return self._view

    def release(self) -> None:
        if not self._released:
            self._released = True
            self._view.release()
            self._arena.release(self._id)

    # plasma-client parity: dropping the last Python ref releases the pin
    def __del__(self):
        try:
            self.release()
        except Exception:
            pass


class Arena:
    def __init__(self, handle, name: str):
        lib = _lib()
        self._h = handle
        self.name = name
        self._base = lib.arena_base(handle)

    # -- lifecycle ----------------------------------------------------------
    @classmethod
    def create(cls, name: str, size: int,
               capacity: Optional[int] = None) -> Optional["Arena"]:
        lib = _lib()
        if lib is None:
            return None
        if capacity is None:
            # ~1 slot per 16KiB of heap, clamped — the table must stay a
            # small fraction of the segment (each slot is ~72 bytes)
            capacity = max(1024, min(262144, size // 16384))
        h = lib.arena_create(name.encode(), size, capacity)
        return cls(h, name) if h else None

    @classmethod
    def attach(cls, name: str) -> Optional["Arena"]:
        lib = _lib()
        if lib is None:
            return None
        h = lib.arena_attach(name.encode())
        return cls(h, name) if h else None

    @classmethod
    def create_or_attach(cls, name: str,
                         size: int) -> Tuple[Optional["Arena"], bool]:
        """Returns (arena, created_by_us)."""
        a = cls.create(name, size)
        if a is not None:
            return a, True
        return cls.attach(name), False

    def detach(self) -> None:
        if self._h:
            _lib().arena_detach(self._h)
            self._h = None

    def unlink(self) -> None:
        _lib().arena_unlink(self.name.encode())

    # -- object ops ---------------------------------------------------------
    def create_buffer(self, object_id: str,
                      size: int) -> Optional[memoryview]:
        off = _lib().arena_alloc(self._h, _id_bytes(object_id), size)
        if off < 0:
            return None
        return memoryview(
            (ctypes.c_char * size).from_address(self._base + off)).cast("B")

    def seal(self, object_id: str) -> None:
        _lib().arena_seal(self._h, _id_bytes(object_id))

    def get(self, object_id: str) -> Optional[Ref]:
        off = ctypes.c_uint64()
        size = ctypes.c_uint64()
        rc = _lib().arena_get(self._h, _id_bytes(object_id),
                              ctypes.byref(off), ctypes.byref(size))
        if rc != 0:
            return None
        return Ref(self, object_id, off.value, size.value)

    def release(self, object_id: str) -> None:
        _lib().arena_release(self._h, _id_bytes(object_id))

    def delete(self, object_id: str) -> bool:
        return _lib().arena_delete(self._h, _id_bytes(object_id)) == 0

    def contains(self, object_id: str) -> bool:
        return bool(_lib().arena_contains(self._h, _id_bytes(object_id)))

    def evict(self, needed: int, max_ids: int = 1024) -> Tuple[int, list]:
        out = ctypes.create_string_buffer(max_ids * ID_LEN)
        n = ctypes.c_uint64()
        reclaimed = _lib().arena_evict(self._h, needed, out, max_ids,
                                       ctypes.byref(n))
        ids = [out.raw[i * ID_LEN:(i + 1) * ID_LEN].decode()
               for i in range(min(n.value, max_ids))]
        return reclaimed, ids

    def stats(self) -> dict:
        """Native counters maintained inside the C++ arena (reference
        parity role: src/ray/stats/metric_defs.h — the native stats
        source feeding the per-node metrics pipeline)."""
        out = (ctypes.c_uint64 * 8)()
        _lib().arena_stats_ext(self._h, out)
        return {"bytes_allocated": out[0], "heap_capacity": out[1],
                "num_objects": out[2], "allocs": out[3],
                "alloc_fails": out[4], "frees": out[5],
                "coalesces": out[6], "crash_sweeps": out[7]}

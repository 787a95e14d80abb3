"""Object stores: per-process memory store + per-node shared-memory store.

Reference parity:
- memory store: src/ray/core_worker/store_provider/memory_store/memory_store.h
  (small objects / direct-call returns live in the owner process).
- shm store: src/ray/object_manager/plasma/store.h — ours maps each large
  object to one POSIX shared-memory segment (multiprocessing.shared_memory)
  registered with the node daemon, which owns lifecycle (free/unlink) and
  serves cross-node fetches. Readers attach and deserialize zero-copy:
  numpy arrays reference the mapped segment directly.
"""

from __future__ import annotations

import asyncio
import hashlib
import functools as _functools
import os
import threading
from multiprocessing import resource_tracker, shared_memory
from typing import Any, Dict, Optional, Tuple

from .serialization import SerializedObject

_MISSING = object()

# ------------------------------------------------------------------ arena
# Native C++ shared-memory arena (src/arena_store.cc) — the plasma-
# equivalent data plane. One arena per session machine-wide; the first
# node daemon creates it, workers/drivers attach lazily. When the native
# lib is unavailable (or the arena is full), the per-object-segment path
# below is the fallback.

ARENA_DEFAULT_BYTES = int(os.environ.get("RAY_TPU_ARENA_BYTES",
                                         256 << 20))

_arenas: Dict[str, Any] = {}      # attached arenas by segment name


def arena_name_for(session_name: str) -> str:
    # full session name (timestamp+pid): arena names must never collide
    # across concurrent sessions on one machine
    return f"rtpu_{session_name}_arena"


def _native_arena_mod():
    if os.environ.get("RAY_TPU_DISABLE_NATIVE_ARENA"):
        return None
    try:
        from .._native import arena as native_arena
    except Exception:
        return None
    return native_arena if native_arena.available() else None


def attach_arena(name: str):
    mod = _native_arena_mod()
    if mod is None:
        return None
    a = _arenas.get(name)
    if a is None:
        a = mod.Arena.attach(name)
        if a is not None:
            _arenas[name] = a
    return a


def create_arena(session_name: str) -> Optional[Any]:
    """Daemon-side: create the session arena, or attach if another
    daemon on this machine already created it."""
    mod = _native_arena_mod()
    if mod is None:
        return None
    name = arena_name_for(session_name)
    a = _arenas.get(name)
    if a is None:
        a, _ = mod.Arena.create_or_attach(name, ARENA_DEFAULT_BYTES)
        if a is not None:
            _arenas[name] = a
    return a


def unlink_session_arena(session_name: str) -> None:
    """Session-wide teardown (driver shutdown): remove the arena segment.
    Node-level daemon stops must NOT do this — other daemons of the same
    session still serve objects out of it."""
    name = arena_name_for(session_name)
    _arenas.pop(name, None)
    try:
        from .._native.arena import Arena, available
        if available():
            a = Arena.attach(name)
            if a is not None:
                a.unlink()
                a.detach()
    except Exception:
        pass


def segment_name(session_name: str, object_id: str) -> str:
    """Canonical shm segment name (POSIX shm names cap ~250 chars and must
    be unique machine-wide). Hash the id rather than truncate it:
    structured ids (e.g. streaming items "<gen_id>_<n>") differ only past
    the truncation point and would collide."""
    digest = hashlib.sha1(object_id.encode()).hexdigest()[:24]
    return f"rtpu_{session_name[:8]}_{digest}"


class _ViewTolerantSharedMemory(shared_memory.SharedMemory):
    """SharedMemory whose teardown tolerates live zero-copy views.

    Readers deserialize directly out of the mapping (numpy arrays view
    shm.buf), so at GC time the handle can be collected while exported
    views still exist — stock close() then raises "BufferError: cannot
    close exported pointers exist". Skipping the eager close is safe:
    the OS mapping is released once the mmap object and every view into
    it are collected.
    """

    def close(self):
        try:
            super().close()
        except BufferError:
            # Views still alive: the mmap must be left to the GC, but the
            # fd is released NOW — mmap holds its own dup of it, so
            # skipping os.close here would leak one fd per segment until
            # EMFILE takes down the process's sockets.
            self._buf = None
            self._mmap = None
            fd = getattr(self, "_fd", -1)
            if fd >= 0:
                try:
                    os.close(fd)
                except OSError:
                    pass
                self._fd = -1


def create_untracked_shm(name: str, size: int) -> shared_memory.SharedMemory:
    """Create a shm segment not owned by this process's resource tracker.

    Workers create segments but the node daemon owns their lifecycle; without
    unregistering, a worker exiting would unlink segments that must outlive it.
    """
    shm = _ViewTolerantSharedMemory(name=name, create=True, size=size)
    try:
        resource_tracker.unregister(shm._name, "shared_memory")  # type: ignore[attr-defined]
    except Exception:
        pass
    return shm


def _unlink_shm(name: str) -> None:
    """Unlink a segment without touching any resource tracker.

    Both create_untracked_shm and attach_shm unregister from the tracker
    (segment lifecycle belongs to the node daemon, not to whichever process
    happens to exit first), so SharedMemory.unlink()'s internal unregister
    would hit a tracker cache miss. Unlink at the POSIX level instead.
    """
    try:
        from multiprocessing import shared_memory as _sm
        _sm._posixshmem.shm_unlink("/" + name if not name.startswith("/")
                                   else name)
    except FileNotFoundError:
        pass
    except Exception:
        pass


def attach_shm(name: str) -> shared_memory.SharedMemory:
    shm = _ViewTolerantSharedMemory(name=name)
    try:
        resource_tracker.unregister(shm._name, "shared_memory")  # type: ignore[attr-defined]
    except Exception:
        pass
    return shm


class ShmLocation:
    """Where a large object's bytes live: a segment on some node."""

    __slots__ = ("node_addr", "shm_name", "size")

    def __init__(self, node_addr: Tuple[str, int], shm_name: str, size: int):
        self.node_addr = tuple(node_addr)
        self.shm_name = shm_name
        self.size = size

    def __reduce__(self):
        return (ShmLocation, (self.node_addr, self.shm_name, self.size))


class MemoryStoreEntry:
    __slots__ = ("serialized", "location", "value", "has_value", "is_error",
                 "shm_keepalive")

    def __init__(self):
        self.serialized: Optional[SerializedObject] = None
        self.location: Optional[ShmLocation] = None
        self.value: Any = _MISSING
        self.has_value = False
        self.is_error = False
        self.shm_keepalive = None  # keeps mapped segment alive while value cached


class MemoryStore:
    """Owner-process store: inline values or locations of shm-backed ones."""

    def __init__(self):
        self._entries: Dict[str, MemoryStoreEntry] = {}
        self._events: Dict[str, asyncio.Event] = {}

    def contains(self, object_id: str) -> bool:
        return object_id in self._entries

    def put_serialized(self, object_id: str, serialized: SerializedObject) -> None:
        entry = self._entries.setdefault(object_id, MemoryStoreEntry())
        self._clear_error(entry)
        entry.serialized = serialized
        self._signal(object_id)

    def put_value(self, object_id: str, value: Any,
                  serialized: Optional[SerializedObject] = None) -> None:
        entry = self._entries.setdefault(object_id, MemoryStoreEntry())
        self._clear_error(entry)
        entry.value = value
        entry.has_value = True
        entry.serialized = serialized
        self._signal(object_id)

    def put_location(self, object_id: str, location: ShmLocation) -> None:
        entry = self._entries.setdefault(object_id, MemoryStoreEntry())
        self._clear_error(entry)
        entry.location = location
        self._signal(object_id)

    @staticmethod
    def _clear_error(entry: MemoryStoreEntry) -> None:
        # A successful (retried) result replaces a previously stored error.
        if entry.is_error:
            entry.is_error = False
            entry.has_value = False
            entry.value = _MISSING

    def put_error(self, object_id: str, error: Exception) -> None:
        """Store an exception as the object's value (raised on get)."""
        entry = self._entries.setdefault(object_id, MemoryStoreEntry())
        entry.value = error
        entry.has_value = True
        entry.is_error = True
        self._signal(object_id)

    def get_entry(self, object_id: str) -> Optional[MemoryStoreEntry]:
        return self._entries.get(object_id)

    def delete(self, object_id: str) -> Optional[MemoryStoreEntry]:
        self._events.pop(object_id, None)
        return self._entries.pop(object_id, None)

    def _signal(self, object_id: str) -> None:
        ev = self._events.get(object_id)
        if ev is not None:
            ev.set()

    async def wait_available(self, object_id: str,
                             timeout: Optional[float] = None) -> bool:
        if object_id in self._entries:
            return True
        ev = self._events.setdefault(object_id, asyncio.Event())
        try:
            await asyncio.wait_for(ev.wait(), timeout)
            return True
        except asyncio.TimeoutError:
            return False
        finally:
            if object_id in self._entries:
                self._events.pop(object_id, None)

    def __len__(self) -> int:
        return len(self._entries)


class ShmStoreEntry:
    __slots__ = ("shm_name", "size", "sealed", "shm", "pinned")

    def __init__(self, shm_name: str, size: int):
        self.shm_name = shm_name
        self.size = size
        self.sealed = False
        self.shm: Optional[shared_memory.SharedMemory] = None
        self.pinned = 0


class NodeObjectStore:
    """Node-daemon-side registry of shm segments holding sealed objects.

    Spilling (reference parity: src/ray/raylet/local_object_manager.h:113
    SpillObjects + python/ray/_private/external_storage.py): under arena
    pressure, sealed objects are copied to disk files and their arena/
    segment copies freed; entries become "spill:<path>" and reads restore
    from disk transparently.
    """

    def __init__(self, session_name: str, spill_dir: Optional[str] = None):
        self.session_name = session_name
        self._entries: Dict[str, ShmStoreEntry] = {}
        self._seq = 0
        from .config import session_dir
        # RAY_TPU_SPILL_STORAGE may be a URI (gs://bucket/prefix,
        # mock://spill, custom://...) — remote spill rides the same
        # pyarrow-fs layer as checkpoints (train/storage.py), matching
        # the reference's external storage backends
        # (python/ray/_private/external_storage.py:72,272,482 —
        # filesystem / S3-smart_open / mock)
        self.spill_dir = (spill_dir
                          or os.environ.get("RAY_TPU_SPILL_STORAGE")
                          or os.path.join(
                              session_dir(session_name), "spill"))
        from ..train.storage import is_uri
        self._spill_remote = is_uri(self.spill_dir)
        # Per-store namespace in the remote key: every node may share
        # one RAY_TPU_SPILL_STORAGE prefix, and object ids alias across
        # nodes (staged foreign copies carry the owner's id) — without
        # the namespace, node B freeing its staged copy would delete
        # node A's spilled primary.
        import uuid as _uuid
        self._spill_ns = _uuid.uuid4().hex[:12]
        self.bytes_spilled = 0
        self.objects_spilled = 0
        self._spill_lock = threading.Lock()
        # plasma-equivalent arena: first daemon on the machine creates
        # it; lifetime is session-wide (unlink_session_arena at driver
        # shutdown), NOT tied to this daemon
        self.arena = create_arena(session_name)

    def segment_name(self, object_id: str) -> str:
        return segment_name(self.session_name, object_id)

    def register(self, object_id: str, shm_name: str, size: int) -> None:
        entry = ShmStoreEntry(shm_name, size)
        entry.sealed = True
        self._entries[object_id] = entry

    def contains(self, object_id: str) -> bool:
        e = self._entries.get(object_id)
        return e is not None and e.sealed

    def get(self, object_id: str) -> Optional[ShmStoreEntry]:
        return self._entries.get(object_id)

    def size_of(self, object_id: str) -> Optional[int]:
        e = self._entries.get(object_id)
        return e.size if e is not None and e.sealed else None

    def read_bytes(self, object_id: str) -> Optional[bytes]:
        """Copy an object's flat bytes out (for cross-node transfer)."""
        return self.read_range(object_id, 0, None)

    def read_range(self, object_id: str, offset: int,
                   length: Optional[int]) -> Optional[bytes]:
        """Copy out `length` bytes at `offset` (None = to the end) without
        materializing the rest — the chunked-transfer read primitive.

        Retries once on a miss: a concurrent spill may move the bytes from
        shm to disk between the prefix check and the read."""
        for _ in range(2):
            entry = self._entries.get(object_id)
            if entry is None or not entry.sealed:
                return None
            end = entry.size if length is None else min(offset + length,
                                                        entry.size)
            shm_name = entry.shm_name
            if shm_name.startswith("spill:"):
                path = shm_name[len("spill:"):]
                try:
                    if "://" in path:      # remote spill backend
                        return _external_read(path, offset, end - offset)
                    with open(path, "rb") as f:
                        f.seek(offset)
                        return f.read(end - offset)
                except OSError:
                    return None
            if shm_name.startswith("arena:"):
                _, arena_seg, oid = shm_name.split(":", 2)
                arena = attach_arena(arena_seg)
                ref = arena.get(oid) if arena is not None else None
                if ref is None:
                    continue  # raced with a spill; re-read the entry
                try:
                    return bytes(ref.buf[offset:end])
                finally:
                    ref.release()
            try:
                if entry.shm is None:
                    entry.shm = attach_shm(shm_name)
                return bytes(entry.shm.buf[offset:end])
            except FileNotFoundError:
                continue  # raced with a spill
        return None

    # ------------------------------------------------------------- spilling

    def spill(self, object_id: str) -> bool:
        """Copy one sealed object to disk and free its shm copy."""
        with self._spill_lock:
            entry = self._entries.get(object_id)
            if entry is None or not entry.sealed \
                    or entry.shm_name.startswith("spill:"):
                return False
            data = self.read_bytes(object_id)
            if data is None:
                return False
            if self._spill_remote:
                path = (self.spill_dir.rstrip("/") + "/"
                        + self._spill_ns + "/" + object_id)
                try:
                    _external_write(path, data)
                except Exception:
                    return False       # backend down: keep the shm copy
            else:
                os.makedirs(self.spill_dir, exist_ok=True)
                path = os.path.join(self.spill_dir, object_id)
                tmp = path + ".tmp"
                with open(tmp, "wb") as f:
                    f.write(data)
                os.replace(tmp, path)
            old_name = entry.shm_name
            # publish the new location BEFORE freeing the shm copy so a
            # concurrent reader either sees the old (still-valid) copy or
            # the spill file, never neither
            entry.shm_name = f"spill:{path}"
            self._free_shm_copy(old_name, entry)
            self.bytes_spilled += entry.size
            self.objects_spilled += 1
            return True

    def spill_until(self, bytes_needed: int,
                    arena_only: bool = True) -> int:
        """Spill oldest-registered objects until roughly `bytes_needed`
        bytes of shm have been released. arena_only counts (and spills)
        only arena-backed entries — the deficit callers compute is arena
        space, which freeing per-object segments can't satisfy. Returns
        bytes spilled (approximate LRU: registration order)."""
        released = 0
        for object_id in list(self._entries):
            if released >= bytes_needed:
                break
            entry = self._entries.get(object_id)
            if entry is None or entry.shm_name.startswith("spill:"):
                continue
            if arena_only and not entry.shm_name.startswith("arena:"):
                continue
            if self.spill(object_id):
                released += entry.size
        return released

    def arena_pressure(self):
        """(allocated, capacity) of the arena, or None without one."""
        if self.arena is None:
            return None
        try:
            st = self.arena.stats()
            return st["bytes_allocated"], st["heap_capacity"]
        except Exception:
            return None

    def native_stats(self) -> dict:
        """Operation counters maintained INSIDE the C++ arena (allocs,
        failures, coalesces, crash sweeps) — the native end of the
        metrics pipeline. Empty without a native arena."""
        if self.arena is None:
            return {}
        try:
            return self.arena.stats()
        except Exception:
            return {}

    def _free_shm_copy(self, shm_name: str, entry: ShmStoreEntry) -> None:
        if shm_name.startswith("arena:"):
            _, arena_seg, oid = shm_name.split(":", 2)
            arena = attach_arena(arena_seg)
            if arena is not None:
                arena.delete(oid)
            return
        if entry.shm is not None:
            try:
                entry.shm.close()
            except Exception:
                pass
            entry.shm = None
        _unlink_shm(shm_name)

    def free(self, object_id: str) -> None:
        entry = self._entries.pop(object_id, None)
        if entry is None:
            return
        if entry.shm_name.startswith("spill:"):
            path = entry.shm_name[len("spill:"):]
            try:
                if "://" in path:
                    _external_delete(path)
                else:
                    os.unlink(path)
            except Exception:
                pass
            return
        self._free_shm_copy(entry.shm_name, entry)

    def free_all(self) -> None:
        for object_id in list(self._entries):
            self.free(object_id)

    @property
    def num_objects(self) -> int:
        return len(self._entries)

    @property
    def bytes_used(self) -> int:
        return sum(e.size for e in self._entries.values())


def write_to_shm(object_id: str, serialized: SerializedObject,
                 session_name: str,
                 arena_room=None) -> Tuple[str, int]:
    """Write `serialized` into shared memory for other processes.

    Preferred path: allocate+seal inside the native arena (one mmap per
    process for ALL objects). On a full arena, `arena_room(nbytes)` (if
    given) may free space by asking the daemon to spill — the allocation
    is retried once after it. Final fallback (native lib missing or still
    full): one POSIX segment per object. Returns (shm_name, size) where
    an arena-backed name is "arena:<segment>:<object_id>". Caller must
    register it with the node daemon.
    """
    size = serialized.flat_size()
    arena = attach_arena(arena_name_for(session_name))
    if arena is not None:
        buf = arena.create_buffer(object_id, size)
        if buf is None and arena_room is not None:
            try:
                arena_room(size)
            except Exception:
                pass
            else:
                buf = arena.create_buffer(object_id, size)
        if buf is not None:
            try:
                serialized.write_flat(buf)
            except BaseException:
                # reclaim the unsealed slot — eviction never touches
                # unsealed objects, so leaking it would be permanent
                buf.release()
                arena.delete(object_id)
                raise
            buf.release()
            arena.seal(object_id)
            return f"arena:{arena.name}:{object_id}", size
    name = segment_name(session_name, object_id)
    shm = create_untracked_shm(name, size)
    try:
        serialized.write_flat(shm.buf)
    finally:
        shm.close()
    return name, size


def read_from_shm(shm_name: str, size: int):
    """Map a sealed object and deserialize zero-copy.

    Returns (value, keepalive, holds_tensors). The keepalive (arena Ref
    or shm handle) must outlive the value — numpy arrays view into the
    mapping. A value that holds tensors is a copy and must not be cached.
    """
    if shm_name.startswith("arena:"):
        _, arena_seg, object_id = shm_name.split(":", 2)
        arena = attach_arena(arena_seg)
        ref = arena.get(object_id) if arena is not None else None
        if ref is None:
            raise FileNotFoundError(
                f"object {object_id[:12]} not in arena {arena_seg}")
        serialized = SerializedObject.from_flat(ref.buf[:size])
        return serialized.deserialize(), ref, serialized.holds_tensors
    shm = attach_shm(shm_name)
    serialized = SerializedObject.from_flat(shm.buf[:size])
    value = serialized.deserialize()
    return value, shm, serialized.holds_tensors

@_functools.lru_cache(maxsize=32)
def _spill_fs_for(base_uri: str):
    from ..train.storage import get_fs_and_path
    return get_fs_and_path(base_uri)


def _spill_fs_and_path(uri: str):
    """Resolve + CACHE the filesystem by URI base: chunked reads hit
    this once per chunk, and rebuilding a cloud FileSystem (auth,
    channel setup) per chunk would dominate the transfer."""
    base, _, name = uri.rpartition("/")
    fs, dir_path = _spill_fs_for(base)
    return fs, dir_path.rstrip("/") + "/" + name


def _external_write(uri: str, data: bytes) -> None:
    """Spill to a remote backend through the pyarrow-fs layer."""
    fs, fs_path = _spill_fs_and_path(uri)
    parent = fs_path.rsplit("/", 1)[0]
    try:
        fs.create_dir(parent, recursive=True)
    except Exception:
        pass
    with fs.open_output_stream(fs_path) as f:
        f.write(data)


def _external_read(uri: str, offset: int = 0,
                   length: int = None) -> bytes:
    """Ranged read from the spill backend: chunked cross-node transfers
    call this once per chunk — seek+read, never a full-object
    download per chunk."""
    fs, fs_path = _spill_fs_and_path(uri)
    with fs.open_input_file(fs_path) as f:
        if offset:
            f.seek(offset)
        return f.read(length)


def _external_delete(uri: str) -> None:
    fs, fs_path = _spill_fs_and_path(uri)
    fs.delete_file(fs_path)

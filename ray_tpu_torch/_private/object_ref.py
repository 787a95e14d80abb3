"""ObjectRef: a first-class future for a value owned by some process.

Reference parity: ray.ObjectRef (python/ray/includes/object_ref.pxi) and the
ownership model of src/ray/core_worker/reference_count.h — the process that
created a ref (by task submission or put) owns the value and serves it to
borrowers; borrowers notify the owner on deserialize/del so the owner can
free the value when the distributed count reaches zero.
"""

from __future__ import annotations

from typing import Optional, Tuple


class ObjectRef:
    __slots__ = ("id", "owner_addr", "_client", "__weakref__")

    def __init__(self, object_id: str, owner_addr: Tuple[str, int],
                 _client=None, _borrowed: bool = False):
        self.id = object_id
        self.owner_addr = tuple(owner_addr) if owner_addr else None
        if _client is None:
            from . import state
            _client = state.current_client_or_none()
        self._client = _client
        if _client is not None:
            _client.ref_counter.add_local_ref(self.id, self.owner_addr,
                                              borrowed=_borrowed)

    def hex(self) -> str:
        return self.id

    def future(self):
        """Return a concurrent.futures.Future resolving to the value."""
        return self._client.as_future(self)

    def __await__(self):
        """Allow `await ref` inside async actors."""
        return self._client.aio_get(self).__await__()

    def __reduce__(self):
        return (_deserialize_ref, (self.id, self.owner_addr))

    def __eq__(self, other) -> bool:
        return isinstance(other, ObjectRef) and other.id == self.id

    def __hash__(self) -> int:
        return hash(self.id)

    def __repr__(self) -> str:
        return f"ObjectRef({self.id[:16]})"

    def __del__(self):
        client = self._client
        if client is not None:
            try:
                client.ref_counter.remove_local_ref(self.id)
            except Exception:
                pass


def _deserialize_ref(object_id: str, owner_addr) -> ObjectRef:
    return ObjectRef(object_id, owner_addr, _borrowed=True)

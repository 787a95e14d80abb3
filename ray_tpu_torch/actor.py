"""@ray_tpu_torch.remote for classes: ActorClass / ActorHandle / ActorMethod.

Reference parity: python/ray/actor.py (ActorClass._remote :324,
ActorHandle :900+). Actor method calls are direct RPCs to the hosting
worker (one round trip, result inline) — see core.py submit_actor_task.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional

from ._private import state
from .remote_function import normalize_scheduling, validate_options


class ActorMethod:
    def __init__(self, handle: "ActorHandle", name: str,
                 opts: Optional[Dict[str, Any]] = None):
        self._handle = handle
        self._name = name
        self._opts = opts or {}

    def remote(self, *args, **kwargs):
        client = state.current_client()
        return client.submit_actor_task(
            self._handle._actor_id, self._name, args, kwargs, self._opts)

    def options(self, **opts):
        """Per-call options; num_returns="streaming" returns an
        ObjectRefGenerator of the method's yields."""
        merged = dict(self._opts)
        merged.update(validate_options(opts))
        return ActorMethod(self._handle, self._name, merged)

    def bind(self, *args):
        """Build a compiled-graph node from this method (reference:
        python/ray/dag class_node.py — actor_method.bind)."""
        raise NotImplementedError(
            "compiled graphs are not ported to ray_tpu_torch yet "
            "(ROADMAP.md section A8: dag/)")

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"actor method {self._name!r} cannot be called directly; "
            f"use .remote().")


class ActorHandle:
    def __init__(self, actor_id: str, class_name: str = "Actor"):
        self._actor_id = actor_id
        self._class_name = class_name

    def __getattr__(self, name: str) -> ActorMethod:
        if name.startswith("_"):
            raise AttributeError(name)
        return ActorMethod(self, name)

    def __reduce__(self):
        return (ActorHandle, (self._actor_id, self._class_name))

    def __repr__(self):
        return f"ActorHandle({self._class_name}, {self._actor_id[:12]})"

    def __eq__(self, other):
        return (isinstance(other, ActorHandle)
                and other._actor_id == self._actor_id)

    def __hash__(self):
        return hash(self._actor_id)


class ActorClass:
    def __init__(self, cls, opts: Optional[Dict[str, Any]] = None):
        self._cls = cls
        self._opts = validate_options(opts or {})
        self._cls_blob: Optional[bytes] = None   # cached cloudpickle of cls
        self._cls_hash: Optional[str] = None     # sha1, computed with blob
        functools.update_wrapper(self, cls, updated=[])

    def remote(self, *args, **kwargs) -> ActorHandle:
        client = state.current_client()
        if self._cls_blob is None and not getattr(client, "is_local_mode", False):
            import hashlib
            from ._private.serialization import serialize_code
            self._cls_blob = serialize_code(self._cls)
            self._cls_hash = hashlib.sha1(self._cls_blob).hexdigest()
        actor_id, creation_ref = client.create_actor(
            self._cls, args, kwargs, normalize_scheduling(self._opts),
            cls_blob=self._cls_blob, cls_hash=self._cls_hash)
        handle = ActorHandle(actor_id, self._cls.__name__)
        handle._creation_ref = creation_ref  # keeps creation errors reachable
        return handle

    def options(self, **opts) -> "ActorClass":
        merged = dict(self._opts)
        merged.update(validate_options(opts))
        return ActorClass(self._cls, merged)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"actor class {self._cls.__name__!r} cannot be instantiated "
            f"directly; use .remote().")

    @property
    def cls(self):
        return self._cls

"""Unique identifiers for objects, tasks, actors, nodes, placement groups.

Reference parity: ray's binary IDs (src/ray/common/id.h). Ours are 16-byte
random IDs wrapped in typed classes; hex form is used on the wire for
readability. Object IDs embed no lineage info — ownership metadata travels
in the ObjectRef itself.
"""

from __future__ import annotations

import os


class BaseID:
    __slots__ = ("_hex",)
    PREFIX = "id"

    def __init__(self, hex_str: str):
        self._hex = hex_str

    @classmethod
    def generate(cls) -> "BaseID":
        return cls(os.urandom(16).hex())

    @classmethod
    def from_hex(cls, hex_str: str) -> "BaseID":
        return cls(hex_str)

    def hex(self) -> str:
        return self._hex

    def __eq__(self, other) -> bool:
        return type(other) is type(self) and other._hex == self._hex

    def __hash__(self) -> int:
        return hash((self.PREFIX, self._hex))

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self._hex[:12]})"

    def __reduce__(self):
        return (type(self), (self._hex,))


class ObjectID(BaseID):
    PREFIX = "obj"


class TaskID(BaseID):
    PREFIX = "task"


class ActorID(BaseID):
    PREFIX = "actor"


class NodeID(BaseID):
    PREFIX = "node"


class WorkerID(BaseID):
    PREFIX = "worker"


class PlacementGroupID(BaseID):
    PREFIX = "pg"


class JobID(BaseID):
    PREFIX = "job"

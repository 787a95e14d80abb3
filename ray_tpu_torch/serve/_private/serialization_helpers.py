"""Blob helpers shared by api.py (driver) and replica.py (worker)."""

from __future__ import annotations


def serialize_callable(func_or_class) -> bytes:
    from ..._private.serialization import serialize_code
    return serialize_code(func_or_class)


def serialize_args(args, kwargs) -> bytes:
    from ..._private.serialization import serialize
    return serialize((args, kwargs)).to_flat()


def deserialize_args(blob: bytes):
    from ..._private.serialization import SerializedObject
    return SerializedObject.from_flat(blob).deserialize()

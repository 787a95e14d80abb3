"""Serialization: cloudpickle for code, pickle-5 out-of-band for data.

Reference parity: python/ray/_private/serialization.py — but there is no
custom binary format here; numpy arrays and torch tensors ride as
out-of-band buffers so they can live zero-copy in shared memory. The
port's copy of ``ray_tpu/_private/serialization.py``: byte for byte the
same stream for everything but torch tensors, which the reference never
sees. Device state never crosses processes (each worker owns the GPUs
it was pinned to), so a tensor is written as its raw bytes with a dtype
tag (bfloat16 and the fp8 types have no numpy type):

- a CUDA tensor is copied to the host and arrives as a CPU tensor, as a
  ``jax.Array`` arrives as numpy in the reference;
- a non-contiguous tensor is made contiguous, and ``requires_grad`` (and
  a Parameter's class) is dropped;
- a tensor read back is a copy, never a view of the buffer it came
  from: torch has no read-only tensors, so a view of the shared-memory
  arena would let one ``get`` change what the next one returns.
"""

from __future__ import annotations

import io
import pickle
import sys
from typing import Any, List, Sequence, Tuple

import cloudpickle

# Objects whose serialized size is at or below this are returned inline in
# RPC replies and stored in the owner's memory store; larger ones go to the
# node shared-memory store. (Ray: max_direct_call_object_size, 100KB.)
INLINE_OBJECT_LIMIT = 100 * 1024


class SerializedObject:
    """A serialized value: pickle stream + out-of-band buffers."""

    __slots__ = ("data", "buffers", "holds_tensors")

    def __init__(self, data: bytes, buffers: Sequence[Any],
                 holds_tensors: bool = False):
        self.data = data
        self.buffers = list(buffers)
        #: the value holds a torch tensor, so it must not be cached and
        #: handed out twice (see the module docstring). Set by
        #: serialize(), and by deserialize() for bytes from elsewhere.
        self.holds_tensors = holds_tensors

    @property
    def total_size(self) -> int:
        return len(self.data) + sum(len(b) for b in self.buffers)

    def deserialize(self) -> Any:
        unpickler = _Unpickler(io.BytesIO(self.data), buffers=self.buffers)
        value = unpickler.load()
        self.holds_tensors = self.holds_tensors or unpickler.read_tensor
        return value

    # -- flat byte layout (for shm segments / network transfer) --
    # u32 nbuf | u64 len * (nbuf+1) | data | buffers...
    def to_flat(self) -> bytes:
        out = io.BytesIO()
        lens = [len(self.data)] + [len(b) for b in self.buffers]
        out.write(len(self.buffers).to_bytes(4, "little"))
        for n in lens:
            out.write(n.to_bytes(8, "little"))
        out.write(self.data)
        for b in self.buffers:
            out.write(b if isinstance(b, bytes) else bytes(b))
        return out.getvalue()

    def flat_size(self) -> int:
        return 4 + 8 * (1 + len(self.buffers)) + self.total_size

    def write_flat(self, view: memoryview) -> int:
        lens = [len(self.data)] + [len(b) for b in self.buffers]
        off = 0
        view[off:off + 4] = len(self.buffers).to_bytes(4, "little")
        off += 4
        for n in lens:
            view[off:off + 8] = n.to_bytes(8, "little")
            off += 8
        view[off:off + len(self.data)] = self.data
        off += len(self.data)
        for b in self.buffers:
            bl = len(b)
            view[off:off + bl] = b if isinstance(b, (bytes, memoryview)) else bytes(b)
            off += bl
        return off

    @classmethod
    def from_flat(cls, view) -> "SerializedObject":
        """Parse from a buffer; returned buffers are zero-copy views."""
        view = memoryview(view)
        nbuf = int.from_bytes(view[0:4], "little")
        off = 4
        lens = []
        for _ in range(nbuf + 1):
            lens.append(int.from_bytes(view[off:off + 8], "little"))
            off += 8
        data = bytes(view[off:off + lens[0]])
        off += lens[0]
        buffers = []
        for n in lens[1:]:
            buffers.append(view[off:off + n])
            off += n
        return cls(data, buffers)


def _rebuild_tensor(buf, dtype: str, shape: Tuple[int, ...]):
    """Unpickle a tensor from its raw bytes: one copy out of `buf`."""
    import numpy as np
    import torch
    raw = np.frombuffer(buf, dtype=np.uint8)
    out = torch.empty(raw.size, dtype=torch.uint8)
    out.numpy()[:] = raw
    return out.view(getattr(torch, dtype)).reshape(shape)


class _Unpickler(pickle.Unpickler):
    """Notes whether the stream rebuilds a tensor."""

    read_tensor = False

    def find_class(self, module, name):
        if name == "_rebuild_tensor" and module == __name__:
            self.read_tensor = True
        return super().find_class(module, name)


class _Pickler(cloudpickle.CloudPickler):
    """cloudpickle with torch tensors as raw out-of-band bytes."""

    wrote_tensor = False

    def reducer_override(self, obj):
        torch = sys.modules.get("torch")
        if (torch is not None and isinstance(obj, torch.Tensor)
                and obj.layout == torch.strided and not obj.is_quantized
                and type(obj) in (torch.Tensor, torch.nn.Parameter)):
            self.wrote_tensor = True
            t = obj.detach()
            if t.device.type != "cpu":
                t = t.cpu()
            flat = t.contiguous().reshape(-1)
            return (_rebuild_tensor,
                    (pickle.PickleBuffer(flat.view(torch.uint8).numpy()),
                     str(t.dtype).rpartition(".")[2], tuple(t.shape)))
        return super().reducer_override(obj)


def _dumps(value: Any, buffer_callback=None) -> Tuple[bytes, bool]:
    """The pickle stream, and whether it holds a tensor."""
    with io.BytesIO() as file:
        pickler = _Pickler(file, protocol=5, buffer_callback=buffer_callback)
        pickler.dump(value)
        return file.getvalue(), pickler.wrote_tensor


def serialize(value: Any) -> SerializedObject:
    buffers: List[pickle.PickleBuffer] = []
    try:
        data, tensors = _dumps(value, buffer_callback=buffers.append)
    except TypeError:
        # Some objects reject out-of-band buffers; retry without.
        buffers = []
        data, tensors = _dumps(value)
    return SerializedObject(data, [b.raw() for b in buffers], tensors)


def serialize_code(obj: Any) -> bytes:
    """Serialize a function/class definition (no out-of-band split)."""
    return cloudpickle.dumps(obj)


def deserialize_code(data: bytes) -> Any:
    return pickle.loads(data)

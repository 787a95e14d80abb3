"""Host-RAM KV tier and the preemption victim policy.

The port's own copy of ``ray_tpu/llm/_internal/kv_offload.py`` (this
package imports nothing from the JAX package). The paged allocator stops
at device memory; this module is the tier below it. A preempted decoding
slot's KV pages are gathered on the device, copied to pinned host memory
without blocking, and the request parks here until pages free up; the
engine then writes the pages back and the stream resumes token-exact
(sampling noise is keyed on (seed, absolute token index)).

Host-side only: it holds the host tensors the engine's copies stream
into and the CUDA event that marks them done, and never launches device
work. The engine owns every copy; this module owns accounting, storage
and the deterministic victim order.

Victim order (`pick_victim`): lowest `Request.priority` first, then the
youngest request (latest `submitted_at`: the oldest keeps its progress),
then the request id, so the order is total and the same victim keeps
losing under sustained pressure (no preemption livelock).
"""

from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

# page dtypes numpy cannot name without ml_dtypes, by the name numpy
# gives them with it: (numpy type of their raw bits, torch dtype). Host
# copies of such pages stay CPU tensors.
TENSOR_DTYPES = {
    "bfloat16": (np.uint16, torch.bfloat16),
    "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
    "float8_e5m2": (np.uint8, torch.float8_e5m2),
}
_TENSOR_ONLY = tuple(tdt for _, tdt in TENSOR_DTYPES.values())


def host_array(t: torch.Tensor) -> Any:
    """A CPU tensor as the host tier keeps it: numpy sharing its memory
    where numpy has the dtype, else the tensor itself (bf16, fp8)."""
    return t if t.dtype in _TENSOR_ONLY else t.numpy()


def host_tensor(arr: Any) -> torch.Tensor:
    """A host page array (numpy or a CPU tensor) as a CPU tensor of its
    dtype, sharing memory where it can. A numpy array of bf16 or fp8
    (made where ml_dtypes is installed) is read through its raw bits."""
    if isinstance(arr, torch.Tensor):
        return arr
    raw = TENSOR_DTYPES.get(arr.dtype.name)
    if raw is not None:
        arr = arr.view(raw[0])
    if not arr.flags.writeable:       # torch.from_numpy wants writable
        arr = arr.copy()
    t = torch.from_numpy(arr)
    return t.view(raw[1]) if raw is not None else t


def host_dtype(arr: Any) -> Optional[torch.dtype]:
    """The torch dtype of a host page array (None: no torch dtype)."""
    if isinstance(arr, torch.Tensor):
        return arr.dtype
    raw = TENSOR_DTYPES.get(arr.dtype.name)
    if raw is not None:
        return raw[1]
    try:
        return torch.from_numpy(np.empty(0, arr.dtype)).dtype
    except TypeError:
        return None


def nbytes(arr: Any) -> int:
    """Bytes of a numpy array or a tensor."""
    if isinstance(arr, torch.Tensor):
        return arr.numel() * arr.element_size()
    return int(arr.nbytes)


@dataclasses.dataclass(eq=False)          # identity compares: fields
class ParkedSequence:                     # hold arrays
    """One preempted request in the host tier.

    `position` and `last_token` are the slot's decode state at the
    (drained) spill point: `position` tokens have KV in the spilled
    pages, `last_token` is the newest sampled token, whose KV is not
    written yet. A restored slot resumes from exactly that state.

    The KV arrives in two phases. While the device-to-host copies run,
    `*_pending` hold the pinned CPU tensors they stream into and `done`
    the CUDA event recorded after them (None on the CPU, where the
    gather already is a host tensor). `materialize()` waits on the event
    and moves them to `*_host` (numpy where the dtype allows it, else
    CPU tensors). The port does not pad the gathered page ids (the
    reference pads them to a power of two only to reuse compiled
    programs), so the arrays hold exactly `n_pages` pages.

    Quantized pools (kv_kind "int8"/"fp8") spill as stored: one-byte
    value pages plus their float32 scale pages (`k_scales_*`,
    `v_scales_*`, shaped (L, n_pages, page, H)). A restore or import
    into an engine of another kind is refused, never reinterpreted."""
    request: Any                        # engine Request (not finished)
    seed: int                           # resolved per-request seed
    position: int                       # tokens whose KV was spilled
    last_token: int                     # pending token at restore
    n_pages: int                        # pages in k/v
    reason: str
    parked_at: float = dataclasses.field(default_factory=time.monotonic)
    k_host: Optional[Any] = None        # (L, n_pages, page, H, D)
    v_host: Optional[Any] = None
    k_pending: Optional[torch.Tensor] = None    # d2h copies in flight
    v_pending: Optional[torch.Tensor] = None
    kv_kind: str = "f32"                # page storage kind
    k_scales_host: Optional[Any] = None    # (L, n_pages, page, H) f32
    v_scales_host: Optional[Any] = None
    k_scales_pending: Optional[torch.Tensor] = None
    v_scales_pending: Optional[torch.Tensor] = None
    done: Optional[Any] = None          # torch.cuda.Event after the copies

    def idle_s(self, now: Optional[float] = None) -> float:
        """Seconds since the request parked."""
        now = time.monotonic() if now is None else now
        return max(now - self.parked_at, 0.0)

    def materialize(self) -> None:
        """Finish the migration: wait for the copies (the engine lets
        this sync through an armed dispatch guard) and keep the host
        arrays as the canonical store."""
        if self.k_host is not None:
            return
        if self.done is not None:
            self.done.synchronize()
            self.done = None
        self.k_host = host_array(self.k_pending)
        self.v_host = host_array(self.v_pending)
        self.k_pending = self.v_pending = None
        if self.k_scales_pending is not None:
            self.k_scales_host = host_array(self.k_scales_pending)
            self.v_scales_host = host_array(self.v_scales_pending)
            self.k_scales_pending = self.v_scales_pending = None

    def payload_bytes(self) -> int:
        """Host bytes this sequence pins (the `kv_host_bytes_used`
        gauge): per-page bytes of k (and of its scales) times n_pages,
        times two for v; the same number in both phases."""
        total = 0
        for pair in ((self.k_host, self.k_pending),
                     (self.k_scales_host, self.k_scales_pending)):
            for arr in pair:
                if arr is not None and len(arr.shape) > 1:
                    per = nbytes(arr) // max(int(arr.shape[1]), 1)
                    total += 2 * per * self.n_pages
                    break
        return total


class HostKVTier:
    """Bounded host-RAM store of spilled KV page sets, keyed by request
    id, in FIFO order (the engine restores the longest-parked session
    first). Capacity is enforced at park time: a tier that cannot hold
    the victim makes the preemption fail, and the engine falls back to
    its exhaustion path instead of growing host memory without bound."""

    def __init__(self, capacity_pages: Optional[int] = None):
        if capacity_pages is not None and capacity_pages < 1:
            raise ValueError("capacity_pages must be >= 1 or None")
        self.capacity_pages = capacity_pages
        self._entries: "OrderedDict[str, ParkedSequence]" = OrderedDict()
        self.used_pages = 0
        # host bytes pinned by parked payloads; each entry's size is
        # kept at park time so removal subtracts what was added
        self.used_bytes = 0
        self._entry_bytes: Dict[str, int] = {}
        self.spills_total = 0
        self.restores_total = 0
        self.spilled_pages_total = 0
        self.restored_pages_total = 0
        self.dropped_total = 0          # abort/deadline while parked
        self.exports_total = 0          # shipped to another engine

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, request_id: str) -> bool:
        return request_id in self._entries

    def entries(self) -> List[ParkedSequence]:
        """FIFO view (restore order)."""
        return list(self._entries.values())

    def can_store(self, n_pages: int) -> bool:
        return (self.capacity_pages is None
                or self.used_pages + n_pages <= self.capacity_pages)

    def park(self, parked: ParkedSequence,
             count_spill: bool = True) -> None:
        """count_spill=False is the import path: a session shipped from
        another engine parks here to await its restore, but was never
        spilled off this device."""
        rid = parked.request.request_id
        if rid in self._entries:
            raise ValueError(f"request {rid!r} already parked")
        if not self.can_store(parked.n_pages):
            raise MemoryError(
                f"host KV tier full: need {parked.n_pages} pages, "
                f"{self.capacity_pages - self.used_pages} of "
                f"{self.capacity_pages} free")
        self._entries[rid] = parked
        self.used_pages += parked.n_pages
        self._entry_bytes[rid] = parked.payload_bytes()
        self.used_bytes += self._entry_bytes[rid]
        if count_spill:
            self.spills_total += 1
            self.spilled_pages_total += parked.n_pages

    def _forget_bytes(self, request_id: str) -> None:
        self.used_bytes -= self._entry_bytes.pop(request_id, 0)

    def pop(self, request_id: str) -> ParkedSequence:
        """Remove for a restore (counts into restores_total)."""
        parked = self._entries.pop(request_id)
        self.used_pages -= parked.n_pages
        self._forget_bytes(request_id)
        self.restores_total += 1
        self.restored_pages_total += parked.n_pages
        return parked

    def export(self, request_id: str) -> ParkedSequence:
        """Remove for shipping to another engine: neither a restore nor
        a drop (the session continues elsewhere)."""
        parked = self._entries.pop(request_id)
        self.used_pages -= parked.n_pages
        self._forget_bytes(request_id)
        self.exports_total += 1
        return parked

    def drop(self, request_id: str) -> Optional[ParkedSequence]:
        """Remove without restoring (abort or deadline while parked)."""
        parked = self._entries.pop(request_id, None)
        if parked is not None:
            self.used_pages -= parked.n_pages
            self._forget_bytes(request_id)
            self.dropped_total += 1
        return parked

    def stats(self) -> Dict[str, Any]:
        return {
            "host_pages_used": self.used_pages,
            "host_bytes_used": self.used_bytes,
            "host_pages_capacity": self.capacity_pages,
            "parked_sessions": len(self._entries),
            "spills_total": self.spills_total,
            "restores_total": self.restores_total,
            "spilled_pages_total": self.spilled_pages_total,
            "restored_pages_total": self.restored_pages_total,
            "parked_dropped_total": self.dropped_total,
            "session_exports_total": self.exports_total,
        }


def victim_order_key(slot) -> tuple:
    """Total preemption order over candidate slots: lowest priority
    loses first, then the youngest request (latest submitted_at), then
    the request id."""
    req = slot.request
    return (int(getattr(req, "priority", 0)),
            -float(getattr(req, "submitted_at", 0.0)),
            str(req.request_id))


def pick_victim(slots: Sequence[Any], protect: Sequence[int] = (),
                spill_ok: bool = True) -> Optional[Any]:
    """The next slot to preempt, or None. Candidates are occupied slots
    outside `protect`; with spill_ok=False (no host tier) only
    prefilling slots qualify: they requeue without host storage (they
    emitted nothing yet), while a decoding slot can only spill."""
    protect = set(protect)
    cands = [s for s in slots
             if s.request is not None and s.index not in protect
             and (spill_ok or not s.ready)]
    if not cands:
        return None
    return min(cands, key=victim_order_key)


__all__ = ["HostKVTier", "ParkedSequence", "TENSOR_DTYPES", "host_array",
           "host_dtype", "host_tensor", "nbytes", "pick_victim",
           "victim_order_key"]

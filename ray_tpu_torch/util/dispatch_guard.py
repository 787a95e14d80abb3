"""Runtime check of the engine's dispatch discipline.

The port of ``ray_tpu/util/jax_guard.py``: a steady pure-decode tick
must make no host-to-device copy (the decode loop is device-resident:
tokens and positions feed back on the device), capture no new CUDA graph
(the counterpart of a new XLA compile) and read back once, through the
engine's ``_read_tokens``::

    with dispatch_guard(engine=eng) as report:
        for _ in range(32):
            eng.step()

Armed on an engine for the block:

- every upload the engine makes goes through ``_dev`` or a static-buffer
  fill, and both report here: the first raises GuardViolation at its own
  line (the counterpart of ``jax.transfer_guard_host_to_device``);
- every graph capture reports here; more than `max_captures` raise
  GuardViolation when the block exits (the counterpart of the compile
  sentinel), so a warm-up section can pass a budget;
- every readback through ``_read_tokens`` is counted; on a CUDA device
  the block also runs under ``torch.cuda.set_sync_debug_mode("error")``,
  lifted only inside the engine's sanctioned syncs (``_read_tokens`` and
  a graph capture), so a stray ``.item()`` or ``.cpu()`` raises at its
  own line.

On a CUDA device the block holds the engine's step lock, which every
engine on the card shares (``engine.make_lock``): the sync debug mode
is process-wide, so no other engine may work on the card while it is
set, and the block's steps run on the thread that entered it.

``raise_on_violation=False`` collects the report without raising (sync
debug mode "warn"). A capture budget exceeded lands in the engine's
flight recorder as a "guard_violation" event (which black-boxes a
bundle), in either mode, as the JAX guard records its compile budget.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import List

import torch

__all__ = ["GuardViolation", "GuardReport", "dispatch_guard"]


class GuardViolation(RuntimeError):
    """A steady section broke the engine's dispatch discipline."""


@dataclasses.dataclass
class GuardReport:
    """What the guard saw: uploads and captures by what they were, and
    the readbacks through ``_read_tokens``."""
    uploads: List[str] = dataclasses.field(default_factory=list)
    captures: List[str] = dataclasses.field(default_factory=list)
    readbacks: int = 0


class _Armed:
    """The guard as the engine sees it (``engine._guard``)."""

    def __init__(self, report: GuardReport, strict: bool, sync_mode):
        self.report = report
        self.strict = strict
        self.sync_mode = sync_mode     # None off CUDA

    def upload(self, what: str) -> None:
        self.report.uploads.append(what)
        if self.strict:
            raise GuardViolation(f"host-to-device copy ({what}) inside a "
                                 f"dispatch_guard block")

    def capture(self, what: str) -> None:
        self.report.captures.append(what)

    def readback(self) -> None:
        self.report.readbacks += 1

    @contextlib.contextmanager
    def sync_allowed(self):
        if self.sync_mode is None:
            yield
            return
        torch.cuda.set_sync_debug_mode(0)
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(self.sync_mode)


@contextlib.contextmanager
def dispatch_guard(max_captures: int = 0, *, engine,
                   raise_on_violation: bool = True):
    """Arm the guard on `engine` for the block; yields its GuardReport.
    max_captures: graph captures tolerated before GuardViolation (0 for
    a steady section). raise_on_violation=False: report only."""
    if engine._guard is not None:
        raise RuntimeError("a dispatch_guard is already armed on this "
                           "engine")
    report = GuardReport()
    cuda = engine.device.type == "cuda"
    mode = ("error" if raise_on_violation else "warn") if cuda else None
    with (engine._step_lock if cuda else contextlib.nullcontext()):
        engine._guard = _Armed(report, raise_on_violation, mode)
        prev = torch.cuda.get_sync_debug_mode() if cuda else None
        if cuda:
            torch.cuda.set_sync_debug_mode(mode)
        try:
            yield report
        finally:
            engine._guard = None
            if cuda:
                torch.cuda.set_sync_debug_mode(prev)
    if len(report.captures) > max_captures:
        recorder = getattr(getattr(engine, "telemetry", None), "recorder",
                           None)
        if recorder is not None:
            recorder.record("guard_violation", cause="capture",
                            n_captures=len(report.captures),
                            budget=max_captures, first=report.captures[0])
    if raise_on_violation and len(report.captures) > max_captures:
        raise GuardViolation(
            f"{len(report.captures)} CUDA graph capture(s) inside a "
            f"dispatch_guard block (budget {max_captures}): "
            f"{report.captures[:8]}")

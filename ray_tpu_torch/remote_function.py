"""@ray_tpu_torch.remote for functions.

Reference parity: python/ray/remote_function.py (RemoteFunction._remote :303)
and option handling (_private/ray_option_utils.py).
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional

from ._private import state

_VALID_OPTS = {
    "num_cpus", "num_gpus", "num_tpus", "memory", "resources", "name",
    "max_retries", "num_returns", "scheduling_strategy", "runtime_env",
    "max_concurrency", "max_restarts", "lifetime", "namespace",
    "placement_group", "placement_group_bundle_index",
    "_generator_backpressure_num_objects",
    "concurrency_groups", "concurrency_group",
}


def validate_options(opts: Dict[str, Any]) -> Dict[str, Any]:
    if opts.get("num_tpus"):
        from ._private.core import NUM_TPUS_REFUSED
        raise ValueError(NUM_TPUS_REFUSED)
    bad = set(opts) - _VALID_OPTS
    if bad:
        raise ValueError(f"unknown option(s): {sorted(bad)}")
    return opts


def normalize_scheduling(opts: Dict[str, Any]) -> Dict[str, Any]:
    """Fold placement_group/scheduling_strategy objects into a plain dict."""
    opts = dict(opts)
    strategy = opts.get("scheduling_strategy")
    pg = opts.pop("placement_group", None)
    if pg is not None and strategy is not None:
        raise ValueError(
            "placement_group and scheduling_strategy are mutually "
            "exclusive (use PlacementGroupSchedulingStrategy)")
    if pg is not None and strategy is None:
        strategy = {"type": "placement_group",
                    "placement_group": getattr(pg, "id", pg),
                    "bundle_index": opts.pop("placement_group_bundle_index", -1)}
    elif isinstance(strategy, str):
        # reference parity: the literals "DEFAULT" and "SPREAD"
        # (python/ray/util/scheduling_strategies.py SchedulingStrategyT)
        if strategy == "DEFAULT":
            strategy = None
        elif strategy == "SPREAD":
            strategy = {"type": "spread"}
        else:
            raise ValueError(
                f"unknown scheduling_strategy {strategy!r} "
                f"(strings: 'DEFAULT' | 'SPREAD')")
    elif strategy is not None and not isinstance(strategy, dict):
        strategy = strategy.to_dict()
    opts["scheduling_strategy"] = strategy
    return opts


class RemoteFunction:
    def __init__(self, fn, opts: Optional[Dict[str, Any]] = None):
        self._fn = fn
        self._opts = validate_options(opts or {})
        self._fn_blob: Optional[bytes] = None   # cached cloudpickle of fn
        self._fn_hash: Optional[str] = None     # sha1, computed with blob
        functools.update_wrapper(self, fn)

    def remote(self, *args, **kwargs):
        client = state.current_client()
        if self._fn_blob is None and not getattr(client, "is_local_mode", False):
            import hashlib
            from ._private.serialization import serialize_code
            self._fn_blob = serialize_code(self._fn)
            self._fn_hash = hashlib.sha1(self._fn_blob).hexdigest()
        return client.submit_task(self._fn, args, kwargs,
                                  normalize_scheduling(self._opts),
                                  fn_blob=self._fn_blob,
                                  fn_hash=self._fn_hash)

    def options(self, **opts) -> "RemoteFunction":
        merged = dict(self._opts)
        merged.update(validate_options(opts))
        return RemoteFunction(self._fn, merged)

    def bind(self, *args, **kwargs):
        """Build a task-DAG node (reference: fn.bind -> FunctionNode);
        execute durably with ray_tpu_torch.workflow.run(...)."""
        raise NotImplementedError(
            "task DAGs and workflows are not ported to ray_tpu_torch yet "
            "(ROADMAP.md section A8: dag/, workflow/)")

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"remote function {self._fn.__name__!r} cannot be called "
            f"directly; use .remote().")

    @property
    def func(self):
        """The underlying Python function (for local execution/tests)."""
        return self._fn

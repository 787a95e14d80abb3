"""Model multiplexing: many models per replica with per-replica LRU.

Reference parity: serve/multiplex.py (_ModelMultiplexWrapper) and
serve/api.py get_multiplexed_model_id. A handle tagged with
.options(multiplexed_model_id=...) carries the id in request metadata;
inside the replica, the @serve.multiplexed loader resolves/loads the
model, evicting least-recently-used ones beyond the cap.
"""

from __future__ import annotations

import asyncio
import collections
import functools
import inspect
from typing import Any, Callable, Optional

from ._private.replica import current_request_context


def get_multiplexed_model_id() -> str:
    """Inside a replica: the model id the current request was tagged
    with (empty string if untagged)."""
    ctx = current_request_context()
    if isinstance(ctx, dict):
        return ctx.get("multiplexed_model_id") or ""
    return ""


class _ModelCache:
    def __init__(self, loader: Callable, max_models: int):
        self.loader = loader
        self.max_models = max_models
        self.cache: "collections.OrderedDict[str, Any]" = \
            collections.OrderedDict()
        self._loads: dict = {}

    async def load(self, instance, model_id: str) -> Any:
        if model_id in self.cache:
            self.cache.move_to_end(model_id)
            return self.cache[model_id]
        pending = self._loads.get(model_id)
        if pending is not None:
            return await pending

        async def _load():
            if instance is not None:
                model = self.loader(instance, model_id)
            else:
                model = self.loader(model_id)
            if inspect.isawaitable(model):
                model = await model
            while len(self.cache) >= self.max_models:
                old_id, old = self.cache.popitem(last=False)
                del_fn = getattr(old, "__del__", None)
                del old
            self.cache[model_id] = model
            return model

        task = asyncio.ensure_future(_load())
        self._loads[model_id] = task
        try:
            return await task
        finally:
            self._loads.pop(model_id, None)


def multiplexed(_fn=None, *, max_num_models_per_replica: int = 3):
    """Decorator on an async loader `(self, model_id) -> model`."""

    def wrap(fn):
        attr = f"__serve_multiplex_cache_{fn.__name__}"

        @functools.wraps(fn)
        async def wrapper(*args):
            if len(args) == 2:
                instance, model_id = args
                cache = getattr(instance, attr, None)
                if cache is None:
                    cache = _ModelCache(fn, max_num_models_per_replica)
                    setattr(instance, attr, cache)
                return await cache.load(instance, model_id)
            (model_id,) = args
            cache = getattr(wrapper, "_cache", None)
            if cache is None:
                cache = wrapper._cache = _ModelCache(
                    fn, max_num_models_per_replica)
            return await cache.load(None, model_id)

        return wrapper

    if _fn is not None:
        return wrap(_fn)
    return wrap

"""Process-global runtime state (the connected client, if any)."""

from __future__ import annotations

from typing import Optional

_client = None


def set_client(client) -> None:
    global _client
    _client = client


def current_client_or_none():
    return _client


def current_client():
    if _client is None:
        raise RuntimeError(
            "ray_tpu_torch is not initialized; call ray_tpu_torch.init() first.")
    return _client


def is_initialized() -> bool:
    return _client is not None

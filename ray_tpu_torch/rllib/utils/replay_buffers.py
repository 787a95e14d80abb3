"""Replay buffers for off-policy algorithms (a copy of
``ray_tpu/rllib/utils/replay_buffers.py``: numpy only).

Reference parity: rllib/utils/replay_buffers/episode_replay_buffer.py —
simplified to a transition-level uniform ring buffer (numpy, preallocated
on first add) feeding DQN/SAC minibatches.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


class ReplayBuffer:
    """Uniform-sampling ring buffer over transition dicts."""

    def __init__(self, capacity: int = 100_000, seed: int = 0):
        self.capacity = int(capacity)
        self._store: Optional[Dict[str, np.ndarray]] = None
        self._size = 0
        self._cursor = 0
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return self._size

    def add_batch(self, batch: Dict[str, np.ndarray]) -> None:
        """batch: dict of arrays with a shared leading dim N."""
        n = len(next(iter(batch.values())))
        if self._store is None:
            self._store = {
                k: np.empty((self.capacity,) + np.asarray(v).shape[1:],
                            dtype=np.asarray(v).dtype)
                for k, v in batch.items()}
        if n >= self.capacity:                 # keep only the newest
            for k, v in batch.items():
                self._store[k][:] = np.asarray(v)[-self.capacity:]
            self._size = self.capacity
            self._cursor = 0
            return
        end = self._cursor + n
        for k, v in batch.items():
            v = np.asarray(v)
            if end <= self.capacity:
                self._store[k][self._cursor:end] = v
            else:
                split = self.capacity - self._cursor
                self._store[k][self._cursor:] = v[:split]
                self._store[k][:end - self.capacity] = v[split:]
        self._cursor = end % self.capacity
        self._size = min(self._size + n, self.capacity)

    def sample(self, n: int) -> Dict[str, np.ndarray]:
        if self._size == 0:
            raise ValueError("cannot sample from an empty replay buffer")
        idx = self._rng.integers(0, self._size, size=n)
        return {k: v[idx] for k, v in self._store.items()}

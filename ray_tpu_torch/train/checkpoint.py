"""Checkpoint = a directory on storage; manager keeps top-K.

The port's copy of ``ray_tpu/train/checkpoint.py`` (reference parity:
python/ray/train/_checkpoint.py, the directory-on-storage abstraction,
and _internal/checkpoint_manager.py, top-K retention). Where the JAX
package saves a pytree with orbax, ``save_pytree`` writes the tree's
tensors and arrays into one safetensors file with
``models/checkpoint_io.write_safetensors`` and its structure into a
small JSON file beside it; ``load_pytree`` reads them back with
``SafeTensorsFile``, tensors onto the card unless told otherwise.
Plain files work too.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import time
from typing import Any, Dict, List, Optional, Tuple


# remote path -> downloaded local dir; one download per path per process,
# all removed at interpreter exit
_DOWNLOAD_CACHE: Dict[str, str] = {}


def _purge_download_cache() -> None:
    for local in _DOWNLOAD_CACHE.values():
        shutil.rmtree(local, ignore_errors=True)
    _DOWNLOAD_CACHE.clear()


import atexit
atexit.register(_purge_download_cache)


class Checkpoint:
    """A handle to a checkpoint directory — local, or on any storage
    the pyarrow-fs layer resolves (gs://, s3://, mock://; see
    storage.py — reference parity: train/_checkpoint.py Checkpoint
    (path, filesystem))."""

    def __init__(self, path: str):
        from .storage import is_uri
        self.path = path if is_uri(path) else os.path.abspath(path)

    @property
    def is_remote(self) -> bool:
        from .storage import is_uri
        return is_uri(self.path)

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        return cls(path)

    def as_directory(self) -> str:
        """A LOCAL directory with this checkpoint's content.

        Remote checkpoints are downloaded ONCE per remote path into a
        process-wide cached temp dir removed at interpreter exit
        (repeated pack()/load_pytree() calls must not re-download or
        leak temp dirs; a per-instance finalizer would dangle the
        returned path when the Checkpoint itself is short-lived)."""
        if not self.is_remote:
            return self.path
        local = _DOWNLOAD_CACHE.get(self.path)
        if local is None or not os.path.isdir(local):
            local = self.to_directory()
            _DOWNLOAD_CACHE[self.path] = local
        return local

    def to_directory(self, dest: Optional[str] = None) -> str:
        dest = dest or tempfile.mkdtemp(prefix="rtpu_ckpt_")
        if self.is_remote:
            from .storage import download_dir
            return download_dir(self.path, dest)
        if os.path.abspath(dest) != self.path:
            shutil.copytree(self.path, dest, dirs_exist_ok=True)
        return dest

    # -- tensor-tree helpers (safetensors + a JSON structure) --

    @classmethod
    def save_pytree(cls, tree: Any, path: str) -> "Checkpoint":
        """Write `tree` (dicts with str keys, lists and tuples over torch
        tensors on any device, numpy arrays and JSON scalars) under
        ``path/pytree``: ``tensors.safetensors`` with every tensor and
        array leaf, bit for bit, and ``tree.json`` with the structure."""
        from ..models.checkpoint_io import write_safetensors
        path = os.path.abspath(path)
        target = os.path.join(path, _PYTREE_DIR)
        os.makedirs(target, exist_ok=True)
        tensors: Dict[str, Any] = {}
        structure = _encode_tree(tree, (), tensors)
        write_safetensors(os.path.join(target, _TENSORS_FILE), tensors)
        with open(os.path.join(target, _TREE_FILE), "w") as f:
            json.dump(structure, f)
        return cls(path)

    def load_pytree(self, abstract_tree: Any = None, device=None) -> Any:
        """The tree `save_pytree` wrote. Torch leaves come back on
        `device` (None: the card, raising without one, as the port's
        entry points do; "cpu" for the host), numpy leaves as numpy
        arrays. With `abstract_tree`, each tensor leaf takes the device
        and dtype of the tensor at the same place in it."""
        from ..models.checkpoint_io import SafeTensorsFile
        from ..models.training import resolve_device
        dev = resolve_device(device, "Checkpoint.load_pytree")
        target = os.path.join(self.as_directory(), _PYTREE_DIR)
        with open(os.path.join(target, _TREE_FILE)) as f:
            structure = json.load(f)
        st = SafeTensorsFile(os.path.join(target, _TENSORS_FILE))
        return _decode_tree(structure, st, dev, abstract_tree)

    def pack(self) -> "PackedCheckpoint":
        """Serialize the directory to bytes so the checkpoint can cross
        host boundaries through the object store (workers may run on a
        different machine than the driver; remote checkpoints are
        downloaded driver-side first, so workers never need storage
        credentials — or, for mock://, the driver's in-memory fs)."""
        import io
        import tarfile
        buf = io.BytesIO()
        with tarfile.open(fileobj=buf, mode="w") as tar:
            tar.add(self.as_directory(), arcname=".")
        return PackedCheckpoint(buf.getvalue())

    def __reduce__(self):
        return (Checkpoint, (self.path,))

    def __repr__(self):
        return f"Checkpoint({self.path})"


_PYTREE_DIR = "pytree"
_TENSORS_FILE = "tensors.safetensors"
_TREE_FILE = "tree.json"


def _encode_tree(node: Any, path: Tuple[str, ...],
                 tensors: Dict[str, Any]) -> Any:
    """The JSON structure of `node`; its tensor and array leaves go into
    `tensors` under their paths joined by "/"."""
    import numpy as np
    import torch
    if isinstance(node, dict):
        return {"dict": [[str(k), _encode_tree(v, path + (str(k),), tensors)]
                         for k, v in node.items()]}
    if isinstance(node, (list, tuple)):
        kind = "list" if isinstance(node, list) else "tuple"
        return {kind: [_encode_tree(v, path + (str(i),), tensors)
                       for i, v in enumerate(node)]}
    if isinstance(node, (torch.Tensor, np.ndarray, np.generic)):
        name = "/".join(path) or "."
        if name in tensors:
            raise ValueError(f"two leaves of the tree share the path {name!r}")
        is_torch = isinstance(node, torch.Tensor)
        tensors[name] = node if is_torch else np.asarray(node)
        return {"torch" if is_torch else "numpy": name,
                "scalar": isinstance(node, np.generic)}
    if node is None or isinstance(node, (bool, int, float, str)):
        return {"value": node}
    raise TypeError(f"save_pytree cannot store a {type(node).__name__} "
                    f"leaf at {'/'.join(path)!r}")


def _decode_tree(node: Dict[str, Any], st, device, like: Any = None) -> Any:
    import numpy as np
    import torch
    if "dict" in node:
        return {k: _decode_tree(v, st, device,
                                None if like is None else like[k])
                for k, v in node["dict"]}
    for kind in ("list", "tuple"):
        if kind in node:
            out = [_decode_tree(v, st, device,
                                None if like is None else like[i])
                   for i, v in enumerate(node[kind])]
            return out if kind == "list" else tuple(out)
    if "value" in node:
        return node["value"]
    if "numpy" in node:
        arr = np.array(st.read(node["numpy"]))
        if st.info(node["numpy"])[1] == torch.bfloat16:
            raise TypeError("a numpy bfloat16 leaf cannot be restored "
                            "without ml_dtypes; save it as a tensor")
        return arr[()] if node["scalar"] else arr
    t = st.tensor(node["torch"])
    if isinstance(like, torch.Tensor):
        return t.to(device=like.device, dtype=like.dtype)
    return t.to(device)


class PackedCheckpoint:
    """Checkpoint content as bytes (tar), produced worker-side by
    Checkpoint.pack(); materialized driver-side into storage."""

    def __init__(self, blob: bytes):
        self.blob = blob

    def unpack_into(self, dest: str) -> Checkpoint:
        import io
        import tarfile
        os.makedirs(dest, exist_ok=True)
        with tarfile.open(fileobj=io.BytesIO(self.blob), mode="r") as tar:
            tar.extractall(dest, filter="data")
        return Checkpoint(dest)


class CheckpointManager:
    """Tracks reported checkpoints, retains top-K by score (or recency)."""

    def __init__(self, storage_path: str, num_to_keep: Optional[int] = None,
                 score_attribute: Optional[str] = None,
                 score_order: str = "max"):
        from .storage import StorageContext
        self.storage_path = storage_path
        self.storage = StorageContext(storage_path)
        self.num_to_keep = num_to_keep
        self.score_attribute = score_attribute
        self.score_order = score_order
        self.checkpoints: List[Tuple[float, Checkpoint, Dict]] = []
        self._counter = 0
        self.storage.ensure_dir()

    def register(self, checkpoint: Checkpoint,
                 metrics: Optional[Dict] = None) -> Checkpoint:
        """Persist a reported checkpoint into storage and apply retention."""
        from .storage import join
        metrics = metrics or {}
        self._counter += 1
        name = f"checkpoint_{self._counter:06d}"
        meta = {k: v for k, v in metrics.items()
                if isinstance(v, (int, float, str, bool))}
        if self.storage.is_remote:
            # materialize locally, stamp metrics, upload as one unit
            local = tempfile.mkdtemp(prefix="rtpu_ckpt_up_")
            try:
                if isinstance(checkpoint, PackedCheckpoint):
                    checkpoint.unpack_into(local)
                else:
                    shutil.copytree(checkpoint.path, local,
                                    dirs_exist_ok=True)
                with open(os.path.join(local, ".metrics.json"), "w") as f:
                    json.dump(meta, f)
                persisted = Checkpoint(
                    self.storage.persist_dir(local, name))
            finally:
                shutil.rmtree(local, ignore_errors=True)
        else:
            dest = join(self.storage_path, name)
            if isinstance(checkpoint, PackedCheckpoint):
                persisted = checkpoint.unpack_into(dest)
            else:
                if checkpoint.path != dest:
                    shutil.copytree(checkpoint.path, dest,
                                    dirs_exist_ok=True)
                persisted = Checkpoint(dest)
            with open(os.path.join(dest, ".metrics.json"), "w") as f:
                json.dump(meta, f)
        if self.score_attribute and self.score_attribute in metrics:
            score = float(metrics[self.score_attribute])
            if self.score_order == "min":
                score = -score
        else:
            score = float(self._counter)      # recency
        self.checkpoints.append((score, persisted, metrics))
        self._apply_retention()
        return persisted

    def _apply_retention(self) -> None:
        if self.num_to_keep is None:
            return
        while len(self.checkpoints) > self.num_to_keep:
            worst_idx = min(range(len(self.checkpoints)),
                            key=lambda i: self.checkpoints[i][0])
            _, ckpt, _ = self.checkpoints.pop(worst_idx)
            self.storage.delete(ckpt.path)

    @property
    def latest(self) -> Optional[Checkpoint]:
        return self.checkpoints[-1][1] if self.checkpoints else None

    @property
    def best(self) -> Optional[Checkpoint]:
        if not self.checkpoints:
            return None
        return max(self.checkpoints, key=lambda c: c[0])[1]

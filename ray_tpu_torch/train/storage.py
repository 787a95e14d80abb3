"""Checkpoint/result storage over pyarrow filesystems.

Reference parity: python/ray/train/_internal/storage.py:358
(StorageContext: resolves storage_path into (pyarrow.fs.FileSystem,
fs_path); all train/tune checkpoint IO rides it so runs can write to
gs://, s3://, or any fsspec filesystem). The port's copy of
``ray_tpu/train/storage.py``: the runtime's object spilling and
runtime envs resolve URIs through it.

Schemes:
  /abs/path, file://...  -> LocalFileSystem
  mock://...             -> process-local in-memory fs (tests; the
                            reference uses the same scheme name)
  gs://, s3://, hdfs://  -> pyarrow.fs.FileSystem.from_uri
  custom://              -> register_filesystem("custom", factory)
"""

from __future__ import annotations

import os
import posixpath
from typing import Callable, Dict, Optional, Tuple

_CUSTOM_FS: Dict[str, Callable] = {}
_MOCK_FS = None   # singleton so every caller in-process shares state


def register_filesystem(scheme: str, factory: Callable) -> None:
    """factory() -> pyarrow-compatible FileSystem for `scheme://`."""
    _CUSTOM_FS[scheme] = factory


def is_uri(path: str) -> bool:
    return "://" in (path or "")


def _mock_fs():
    """In-memory filesystem (fsspec memory fs behind the pyarrow
    facade) — one instance per process, like the reference's
    mock:// test filesystem."""
    global _MOCK_FS
    if _MOCK_FS is None:
        import fsspec
        from pyarrow.fs import FSSpecHandler, PyFileSystem
        _MOCK_FS = PyFileSystem(FSSpecHandler(
            fsspec.filesystem("memory")))
    return _MOCK_FS


def get_fs_and_path(path: str) -> Tuple["object", str]:
    """Resolve a storage path/URI to (pyarrow FileSystem, fs path)."""
    from pyarrow import fs as pafs
    if not is_uri(path):
        return pafs.LocalFileSystem(), os.path.abspath(path)
    scheme, rest = path.split("://", 1)
    if scheme == "file":
        return pafs.LocalFileSystem(), os.path.abspath("/" + rest.lstrip("/"))
    if scheme == "mock":
        return _mock_fs(), rest
    if scheme in _CUSTOM_FS:
        return _CUSTOM_FS[scheme](), rest
    fs, fs_path = pafs.FileSystem.from_uri(path)
    return fs, fs_path


def upload_dir(local_dir: str, dest_uri: str) -> None:
    """Recursively copy a local directory to storage."""
    fs, dest = get_fs_and_path(dest_uri)
    fs.create_dir(dest, recursive=True)
    for root, _dirs, files in os.walk(local_dir):
        rel = os.path.relpath(root, local_dir)
        remote_root = dest if rel == "." else posixpath.join(
            dest, rel.replace(os.sep, "/"))
        if rel != ".":
            fs.create_dir(remote_root, recursive=True)
        for name in files:
            with open(os.path.join(root, name), "rb") as src, \
                    fs.open_output_stream(
                        posixpath.join(remote_root, name)) as out:
                while True:
                    chunk = src.read(4 << 20)
                    if not chunk:
                        break
                    out.write(chunk)


def download_dir(src_uri: str, local_dir: str) -> str:
    """Recursively copy a storage directory to a local one."""
    from pyarrow.fs import FileSelector
    fs, src = get_fs_and_path(src_uri)
    os.makedirs(local_dir, exist_ok=True)
    infos = fs.get_file_info(FileSelector(src, recursive=True))
    # some backends (fsspec memory fs) report absolute-normalized paths;
    # compute relatives scheme-agnostically
    src_norm = src.strip("/")
    for info in infos:
        p = info.path.strip("/")
        if p == src_norm or not p.startswith(src_norm + "/"):
            continue
        rel = p[len(src_norm) + 1:]
        target = os.path.join(local_dir, *rel.split("/"))
        if info.type.name == "Directory":
            os.makedirs(target, exist_ok=True)
            continue
        os.makedirs(os.path.dirname(target), exist_ok=True)
        with fs.open_input_stream(info.path) as src_f, \
                open(target, "wb") as out:
            while True:
                chunk = src_f.read(4 << 20)
                if not chunk:
                    break
                out.write(chunk)
    return local_dir


def delete_dir(uri: str) -> None:
    fs, path = get_fs_and_path(uri)
    try:
        fs.delete_dir(path)
    except FileNotFoundError:
        pass


def exists(uri: str) -> bool:
    fs, path = get_fs_and_path(uri)
    info = fs.get_file_info([path])[0]
    return info.type.name != "NotFound"


def join(base: str, *parts: str) -> str:
    """Path join that works for both URIs and local paths."""
    if is_uri(base):
        return posixpath.join(base, *parts)
    return os.path.join(base, *parts)


class StorageContext:
    """Resolved storage for one run: `storage_path/experiment_name`.

    Mirrors the reference StorageContext's role (storage.py:358):
    everything that persists run artifacts asks this object where and
    how, so local paths and cloud URIs behave identically."""

    def __init__(self, storage_path: str,
                 experiment_name: Optional[str] = None):
        self.storage_path = storage_path
        self.experiment_name = experiment_name
        self.run_path = (join(storage_path, experiment_name)
                         if experiment_name else storage_path)
        self.fs, self.fs_path = get_fs_and_path(self.run_path)

    @property
    def is_remote(self) -> bool:
        return is_uri(self.run_path) and not self.run_path.startswith(
            "file://")

    def ensure_dir(self, *parts: str) -> str:
        target = join(self.run_path, *parts)
        fs, path = get_fs_and_path(target)
        fs.create_dir(path, recursive=True)
        return target

    def persist_dir(self, local_dir: str, *parts: str) -> str:
        """Upload (or copy) a local directory under the run path;
        returns its storage path/URI."""
        dest = join(self.run_path, *parts)
        if self.is_remote:
            upload_dir(local_dir, dest)
        else:
            import shutil
            if os.path.abspath(local_dir) != os.path.abspath(dest):
                shutil.copytree(local_dir, dest, dirs_exist_ok=True)
        return dest

    def fetch_dir(self, storage_dir: str, local_dest: str) -> str:
        if is_uri(storage_dir):
            return download_dir(storage_dir, local_dest)
        import shutil
        if os.path.abspath(storage_dir) != os.path.abspath(local_dest):
            shutil.copytree(storage_dir, local_dest, dirs_exist_ok=True)
        return local_dest

    def delete(self, storage_dir: str) -> None:
        if is_uri(storage_dir):
            delete_dir(storage_dir)
        else:
            import shutil
            shutil.rmtree(storage_dir, ignore_errors=True)

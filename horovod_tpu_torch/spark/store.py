"""Store abstraction: where estimators keep data, checkpoints and logs.

Counterpart of :mod:`horovod_tpu.spark.store`, with the same layout, so
each package reads the other's Store.  Reference:
spark/common/store.py:32-150 — ``Store`` defines train-data
/ checkpoint / logs paths; ``FilesystemStore`` implements them on a
local or network filesystem, and ``HDFSStore``/``S3Store`` layer
protocol-prefixed remote filesystems over the same structure.  Here
the remote stores ride fsspec (one engine for
``s3://``, ``hdfs://``, ``gs://``, ``memory://``, ...), and
``Store.create`` dispatches on the URL scheme exactly like the
reference's factory.
"""

import os
import posixpath
import shutil
from typing import Optional


class Store:
    def get_train_data_path(self, idx=None) -> str:
        raise NotImplementedError()

    def get_val_data_path(self, idx=None) -> str:
        raise NotImplementedError()

    def get_test_data_path(self, idx=None) -> str:
        raise NotImplementedError()

    def get_checkpoint_path(self, run_id: str) -> str:
        raise NotImplementedError()

    def get_logs_path(self, run_id: str) -> str:
        raise NotImplementedError()

    def exists(self, path: str) -> bool:
        raise NotImplementedError()

    def read(self, path: str) -> bytes:
        raise NotImplementedError()

    def open_read(self, path: str):
        """Binary read handle; default materializes via read()."""
        import io
        return io.BytesIO(self.read(path))

    def write(self, path: str, data: bytes):
        raise NotImplementedError()

    def list(self, path: str, pattern: str) -> list:
        """Paths under ``path`` matching the glob ``pattern``."""
        raise NotImplementedError()

    def delete(self, path: str):
        raise NotImplementedError()

    @staticmethod
    def create(prefix_path: str, *args, **kwargs) -> "Store":
        """Dispatch on the URL scheme (reference: store.py Store.create
        returning HDFSStore/LocalStore by prefix)."""
        scheme = ""
        if "://" in prefix_path:
            scheme = prefix_path.split("://", 1)[0].lower()
        if scheme in ("", "file"):
            return FilesystemStore(prefix_path.split("://", 1)[-1],
                                   *args, **kwargs)
        if scheme == "hdfs":
            return HDFSStore(prefix_path, *args, **kwargs)
        if scheme in ("s3", "s3a", "s3n"):
            return S3Store(prefix_path, *args, **kwargs)
        if scheme in ("gs", "gcs"):
            return GCSStore(prefix_path, *args, **kwargs)
        return FsspecStore(prefix_path, *args, **kwargs)


class FilesystemStore(Store):
    """Plain-filesystem store (reference: spark/common/store.py
    LocalStore/FilesystemStore semantics — fixed subdirectory layout
    under a prefix path)."""

    def __init__(self, prefix_path: str,
                 train_path: Optional[str] = None,
                 val_path: Optional[str] = None,
                 test_path: Optional[str] = None,
                 runs_path: Optional[str] = None):
        self.prefix_path = prefix_path
        self._train = train_path or os.path.join(prefix_path,
                                                 "intermediate_train_data")
        self._val = val_path or os.path.join(prefix_path,
                                             "intermediate_val_data")
        self._test = test_path or os.path.join(prefix_path,
                                               "intermediate_test_data")
        self._runs = runs_path or os.path.join(prefix_path, "runs")
        os.makedirs(prefix_path, exist_ok=True)

    def _idx(self, base: str, idx) -> str:
        return base if idx is None else f"{base}.{idx}"

    def get_train_data_path(self, idx=None) -> str:
        return self._idx(self._train, idx)

    def get_val_data_path(self, idx=None) -> str:
        return self._idx(self._val, idx)

    def get_test_data_path(self, idx=None) -> str:
        return self._idx(self._test, idx)

    def get_run_path(self, run_id: str) -> str:
        return os.path.join(self._runs, run_id)

    def get_checkpoint_path(self, run_id: str) -> str:
        return os.path.join(self.get_run_path(run_id), "checkpoint")

    def get_logs_path(self, run_id: str) -> str:
        return os.path.join(self.get_run_path(run_id), "logs")

    def exists(self, path: str) -> bool:
        return os.path.exists(path)

    def read(self, path: str) -> bytes:
        with open(path, "rb") as f:
            return f.read()

    def open_read(self, path: str):
        return open(path, "rb")

    def write(self, path: str, data: bytes):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)

    def list(self, path: str, pattern: str) -> list:
        import glob
        return sorted(glob.glob(os.path.join(path, pattern)))

    def delete(self, path: str):
        if os.path.isdir(path):
            shutil.rmtree(path)
        elif os.path.exists(path):
            os.remove(path)


class FsspecStore(Store):
    """Store over any fsspec filesystem URL (``s3://bucket/prefix``,
    ``hdfs://namenode/path``, ``gs://...``, ``memory://...``).

    Reference: spark/common/store.py:32-150 — HDFSStore/S3Store give
    the Estimator remote data/checkpoint/log roots; fsspec provides
    the same reach with one implementation (plus GCS).  ``storage_options`` forwards
    credentials/endpoints to the underlying filesystem (the analog of
    the reference's hdfs_driver/connection args).
    """

    def __init__(self, prefix_url: str,
                 train_path: Optional[str] = None,
                 val_path: Optional[str] = None,
                 test_path: Optional[str] = None,
                 runs_path: Optional[str] = None,
                 storage_options: Optional[dict] = None):
        self.prefix_path = prefix_url
        self._storage_options = storage_options or {}
        # Paths are plain URL strings (fsspec filesystems strip their
        # own protocol), and the filesystem connects LAZILY on first
        # I/O — constructing a store must not require the protocol
        # driver or credentials (mirrors the reference, where Store
        # objects are built on the Spark driver and only workers
        # touch HDFS/S3).
        self.__fs = None
        root = prefix_url.rstrip("/")
        join = posixpath.join
        self._train = train_path or join(root,
                                         "intermediate_train_data")
        self._val = val_path or join(root, "intermediate_val_data")
        self._test = test_path or join(root, "intermediate_test_data")
        self._runs = runs_path or join(root, "runs")

    @property
    def _fs(self):
        if self.__fs is None:
            import fsspec
            self.__fs, _ = fsspec.core.url_to_fs(
                self.prefix_path, **self._storage_options)
        return self.__fs

    def __getstate__(self):
        # Filesystem handles don't pickle reliably; workers reconnect.
        state = dict(self.__dict__)
        state["_FsspecStore__fs"] = None
        return state

    def _idx(self, base: str, idx) -> str:
        return base if idx is None else f"{base}.{idx}"

    def get_train_data_path(self, idx=None) -> str:
        return self._idx(self._train, idx)

    def get_val_data_path(self, idx=None) -> str:
        return self._idx(self._val, idx)

    def get_test_data_path(self, idx=None) -> str:
        return self._idx(self._test, idx)

    def get_run_path(self, run_id: str) -> str:
        return posixpath.join(self._runs, run_id)

    def get_checkpoint_path(self, run_id: str) -> str:
        return posixpath.join(self.get_run_path(run_id), "checkpoint")

    def get_logs_path(self, run_id: str) -> str:
        return posixpath.join(self.get_run_path(run_id), "logs")

    def exists(self, path: str) -> bool:
        return self._fs.exists(path)

    def read(self, path: str) -> bytes:
        return self._fs.cat_file(path)

    def open_read(self, path: str):
        """Streaming read handle (object stores range-read through it
        instead of materializing the whole blob)."""
        return self._fs.open(path, "rb")

    def write(self, path: str, data: bytes):
        parent = posixpath.dirname(path)
        if parent:
            try:
                self._fs.makedirs(parent, exist_ok=True)
            except Exception:
                pass  # object stores have no real directories
        self._fs.pipe_file(path, data)

    def list(self, path: str, pattern: str) -> list:
        # glob() returns [] for missing paths — no exists() round trip
        # on the per-epoch training hot path.
        return sorted(self._fs.glob(posixpath.join(path, pattern)))

    def delete(self, path: str):
        if self._fs.exists(path):
            self._fs.rm(path, recursive=True)


class HDFSStore(FsspecStore):
    """``hdfs://`` store (reference: spark/common/store.py HDFSStore)."""
    SCHEME = ("hdfs",)

    def __init__(self, prefix_url: str, *args, **kwargs):
        _check_scheme(prefix_url, self.SCHEME, type(self).__name__)
        super().__init__(prefix_url, *args, **kwargs)


class S3Store(FsspecStore):
    """``s3://`` store (reference: spark/common/store.py S3Store via
    s3fs)."""
    SCHEME = ("s3", "s3a", "s3n")

    def __init__(self, prefix_url: str, *args, **kwargs):
        _check_scheme(prefix_url, self.SCHEME, type(self).__name__)
        super().__init__(prefix_url, *args, **kwargs)


class GCSStore(FsspecStore):
    """``gs://`` store — no reference analog; the JAX package added it
    for the object store beside its pods."""
    SCHEME = ("gs", "gcs")

    def __init__(self, prefix_url: str, *args, **kwargs):
        _check_scheme(prefix_url, self.SCHEME, type(self).__name__)
        super().__init__(prefix_url, *args, **kwargs)


def _check_scheme(url: str, schemes, cls_name: str):
    scheme = url.split("://", 1)[0].lower() if "://" in url else ""
    if scheme not in schemes:
        raise ValueError(
            f"{cls_name} requires a {'/'.join(schemes)}:// URL, got "
            f"{url!r}; use Store.create() for scheme dispatch")

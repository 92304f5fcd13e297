"""Checkpoint manifest: the single durable commit record.

A checkpoint step lives in its own directory::

    <root>/step-0000000042/
        shard-00000-of-00004.bin
        shard-00001-of-00004.bin
        ...
        MANIFEST.json          # present <=> the step is committed

``MANIFEST.json`` is written ONLY by the commit arbiter (rank 0, after
every rank's shard landed) via temp-file + fsync + atomic rename, so
its presence is the all-or-nothing commit bit: a crash at any earlier
point leaves shard files but no manifest, and the step is invisible to
restore.  The manifest carries the world layout (which rank owned
which items) and every shard's checksum, so restore at a different
world size can redistribute, and a corrupt shard is detected before
its bytes are trusted.

Counterpart of :mod:`horovod_tpu.checkpoint.manifest`, copied: the
elastic driver scans ``committed_steps`` at start.
"""

import json
import logging
import os
import re
from typing import Dict, List, Optional

from ..common import failpoints as _fp

logger = logging.getLogger("horovod_tpu_torch.checkpoint")

FORMAT_VERSION = 1
MANIFEST_NAME = "MANIFEST.json"
_STEP_DIR_RE = re.compile(r"^step-(\d{10})$")


def step_dir(root: str, step: int) -> str:
    return os.path.join(root, "step-%010d" % step)


def shard_name(rank: int, world_size: int) -> str:
    return "shard-%05d-of-%05d.bin" % (rank, world_size)


def assign_shards(item_names: List[str], world_size: int
                  ) -> Dict[str, int]:
    """Deterministic item → owning-rank partition: sorted names,
    round-robin.  Every rank computes the same layout from the same
    (replicated) item dict; the manifest records it so restore never
    has to re-derive it."""
    return {name: i % world_size
            for i, name in enumerate(sorted(item_names))}


class Manifest:
    """Parsed MANIFEST.json.  ``shards`` is a list of per-rank dicts:
    ``{"rank", "filename", "sha256", "nbytes", "items"}``."""

    def __init__(self, step: int, world_size: int,
                 shards: List[dict], layout: Dict[str, int],
                 meta: Optional[dict] = None):
        self.step = step
        self.world_size = world_size
        self.shards = shards
        self.layout = layout
        self.meta = meta or {}

    def to_dict(self) -> dict:
        return {"format": FORMAT_VERSION, "step": self.step,
                "world_size": self.world_size, "shards": self.shards,
                "layout": self.layout, "meta": self.meta}

    @classmethod
    def from_dict(cls, d: dict) -> "Manifest":
        if d.get("format") != FORMAT_VERSION:
            raise ValueError("unsupported checkpoint manifest format %r"
                             % d.get("format"))
        for field in ("step", "world_size", "shards", "layout"):
            if field not in d:
                raise ValueError("manifest missing field %r" % field)
        return cls(int(d["step"]), int(d["world_size"]),
                   list(d["shards"]), dict(d["layout"]),
                   d.get("meta") or {})


def fsync_dir(path: str):
    """Durably record a rename in its parent directory (POSIX: the
    rename itself may sit in the directory's page cache)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return  # platform without directory fds
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def write_manifest(directory: str, manifest: Manifest,
                   rank: int = None) -> str:
    """Atomically publish the manifest: temp file + fsync + rename +
    directory fsync.  THE commit point of the whole checkpoint."""
    if _fp.ENABLED:
        # Failpoint site: the global commit publish.  error()/crash()
        # model the arbiter dying after every shard landed but before
        # the commit bit — the step must stay invisible; delay() widens
        # the window a concurrent restore might race.
        _fp.maybe_fail("ckpt.manifest_publish", rank=rank)
    path = os.path.join(directory, MANIFEST_NAME)
    tmp = path + ".tmp"
    data = json.dumps(manifest.to_dict(), indent=1, sort_keys=True)
    with open(tmp, "w") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    fsync_dir(directory)
    return path


def read_manifest(directory: str) -> Manifest:
    """Parse the step directory's manifest; raises ``FileNotFoundError``
    when the step was never committed and ``ValueError`` when the
    manifest bytes are malformed (a torn non-atomic copy, a truncated
    transfer — the caller treats both as "not a valid checkpoint")."""
    path = os.path.join(directory, MANIFEST_NAME)
    with open(path) as f:
        raw = f.read()
    try:
        return Manifest.from_dict(json.loads(raw))
    except (json.JSONDecodeError, TypeError, KeyError) as e:
        raise ValueError("corrupt manifest %s: %s" % (path, e))


def list_step_dirs(root: str) -> List[int]:
    """Steps with a step directory under ``root`` (committed or not),
    ascending.  Committedness is decided by ``read_manifest``."""
    try:
        names = os.listdir(root)
    except OSError:
        return []
    steps = []
    for n in names:
        m = _STEP_DIR_RE.match(n)
        if m:
            steps.append(int(m.group(1)))
    return sorted(steps)


def committed_steps(root: str) -> List[int]:
    """Steps whose manifest exists and parses, ascending (checksum
    verification is the reader's job — this is the cheap scan)."""
    out = []
    for step in list_step_dirs(root):
        try:
            read_manifest(step_dir(root, step))
        except (OSError, ValueError):
            continue
        out.append(step)
    return out

"""Tuned-profile artifact: the frozen output of a TuningSession.

A profile is one JSON document describing the winning knob
configuration per cycle-class plus the process-wide worker knobs, with
enough provenance (world size, strategy, sample counts, objective
scores) for ``tools/tune_report.py`` to pretty-print it and diff two
rounds.  Deliberately stdlib-only: ``common/env.py`` loads profiles at
knob-parse time, before the rest of the package imports.

Schema (PROFILE_VERSION 1)::

    {
      "version": 1,
      "kind": "horovod_tpu_tuned_profile",
      "world_size": 8,
      "strategy": "grid",
      "frozen_at_unix": 1754400000.0,
      "classes": {
        "dense":  {"knobs": {"fusion_mb": 32.0, ...},
                   "score_bytes_per_s": 1.2e9,
                   "samples": 9, "rounds": 72},
        "sparse": {...}            # absent when no sparse traffic ran
      },
      "worker": {"cycle_time_ms": 1.0, "coalesce": true,
                 "replay_warmup": 3}
    }

Counterpart of :mod:`horovod_tpu.tune.profile`, copied: the same schema
and the same ``kind``, so either package loads the other's profile.
"""

import dataclasses
import json
import os
import tempfile
import time
from typing import Dict, Optional

PROFILE_VERSION = 1
PROFILE_KIND = "horovod_tpu_tuned_profile"


@dataclasses.dataclass
class TunedProfile:
    world_size: int = 0
    strategy: str = "grid"
    frozen_at_unix: float = 0.0
    # class name -> {"knobs": {...}, "score_bytes_per_s": float,
    #                "samples": int, "rounds": int}
    classes: Dict[str, dict] = dataclasses.field(default_factory=dict)
    # process-wide worker knobs (cycle_time_ms, coalesce, replay_warmup)
    worker: Dict[str, object] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict:
        return {
            "version": PROFILE_VERSION,
            "kind": PROFILE_KIND,
            "world_size": self.world_size,
            "strategy": self.strategy,
            "frozen_at_unix": self.frozen_at_unix,
            "classes": self.classes,
            "worker": self.worker,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "TunedProfile":
        if not isinstance(d, dict) or d.get("kind") != PROFILE_KIND:
            raise ValueError("not a tuned-profile document")
        if int(d.get("version", -1)) > PROFILE_VERSION:
            raise ValueError(
                "tuned profile version %r is newer than this runtime "
                "understands (%d)" % (d.get("version"), PROFILE_VERSION))
        return cls(
            world_size=int(d.get("world_size", 0)),
            strategy=str(d.get("strategy", "")),
            frozen_at_unix=float(d.get("frozen_at_unix", 0.0)),
            classes=dict(d.get("classes") or {}),
            worker=dict(d.get("worker") or {}),
        )

    def fusion_bytes_for(self, cls_name: str) -> Optional[int]:
        sec = self.classes.get(cls_name) or {}
        mb = (sec.get("knobs") or {}).get("fusion_mb")
        return int(float(mb) * 1024 * 1024) if mb is not None else None


def save_profile(profile: TunedProfile, path: str) -> str:
    """Atomic write (temp + fsync + rename — the checkpoint shard
    discipline): a crash mid-save must never leave a torn profile for
    the next restart to trust."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=".tune-profile-", dir=d)
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(profile.to_dict(), f, indent=2, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return path


def load_profile(path: str) -> TunedProfile:
    """Load + validate; raises (ValueError/OSError) on anything that
    is not a complete, parseable profile — callers decide whether a
    bad profile means "re-search" or "config error"."""
    with open(path) as f:
        return TunedProfile.from_dict(json.load(f))


def try_load_profile(path: Optional[str]) -> Optional[TunedProfile]:
    """Best-effort load for the knob-parse path: a missing file simply
    means "tune from scratch and write it here"; a corrupt one is
    ignored with the same semantics (the freeze will overwrite it)."""
    if not path:
        return None
    try:
        return load_profile(path)
    except (OSError, ValueError, TypeError):
        return None


def diff_profiles(a: TunedProfile, b: TunedProfile) -> dict:
    """Structured diff of two profiles: per-class knob deltas plus the
    objective movement (tools/tune_report.py renders it)."""
    out = {"world_size": (a.world_size, b.world_size),
           "strategy": (a.strategy, b.strategy),
           "classes": {}, "worker": {}}
    for cls_name in sorted(set(a.classes) | set(b.classes)):
        sa = a.classes.get(cls_name) or {}
        sb = b.classes.get(cls_name) or {}
        ka, kb = sa.get("knobs") or {}, sb.get("knobs") or {}
        knob_deltas = {}
        for k in sorted(set(ka) | set(kb)):
            if ka.get(k) != kb.get(k):
                knob_deltas[k] = (ka.get(k), kb.get(k))
        score_a = sa.get("score_bytes_per_s")
        score_b = sb.get("score_bytes_per_s")
        delta_pct = None
        if score_a and score_b:
            delta_pct = (float(score_b) - float(score_a)) \
                / float(score_a) * 100.0
        out["classes"][cls_name] = {
            "knob_deltas": knob_deltas,
            "score_bytes_per_s": (score_a, score_b),
            "score_delta_pct": delta_pct,
            "only_in": ("a" if cls_name not in b.classes else
                        "b" if cls_name not in a.classes else None),
        }
    for k in sorted(set(a.worker) | set(b.worker)):
        if a.worker.get(k) != b.worker.get(k):
            out["worker"][k] = (a.worker.get(k), b.worker.get(k))
    return out


def new_profile(world_size: int, strategy: str) -> TunedProfile:
    return TunedProfile(world_size=world_size, strategy=strategy,
                        frozen_at_unix=time.time())

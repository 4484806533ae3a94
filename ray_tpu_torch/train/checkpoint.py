"""Checkpoints: directory-backed artifacts + top-k retention. The port's
copy of ``ray_tpu/train/checkpoint.py`` (pure Python).

Reference parity: ray.train.Checkpoint (python/ray/train/_checkpoint.py
— a directory + filesystem abstraction), CheckpointManager top-k
retention (train/_internal/checkpoint_manager.py), CheckpointConfig
(air/config.py). Filesystem scope this round: local/shared paths (the
reference reaches s3/gcs through pyarrow.fs; the seam here is the same —
`Checkpoint.path` is opaque to everything above it).
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import tempfile
from contextlib import contextmanager


class Checkpoint:
    """A directory of training artifacts. Cheap value object: holds a
    path, never reads it eagerly."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        if not os.path.isdir(path):
            raise ValueError(f"not a directory: {path}")
        return cls(path)

    def to_directory(self, dest: str | None = None) -> str:
        """Materialize into `dest` (copy); default a fresh temp dir."""
        dest = dest or tempfile.mkdtemp(prefix="ckpt_")
        os.makedirs(dest, exist_ok=True)
        for name in os.listdir(self.path):
            src = os.path.join(self.path, name)
            dst = os.path.join(dest, name)
            if os.path.isdir(src):
                shutil.copytree(src, dst, dirs_exist_ok=True)
            else:
                shutil.copy2(src, dst)
        return dest

    @contextmanager
    def as_directory(self):
        """Read-only view; local checkpoints are yielded in place."""
        yield self.path

    def __repr__(self):
        return f"Checkpoint({self.path})"


@dataclasses.dataclass
class CheckpointConfig:
    """Reference: ray.train.CheckpointConfig (air/config.py)."""

    num_to_keep: int | None = None  # None = keep all
    checkpoint_score_attribute: str | None = None
    checkpoint_score_order: str = "max"  # "max" | "min"
    # Tune class-trainable driver: ship a checkpoint every N iterations
    # (reference: CheckpointConfig.checkpoint_frequency) — large states
    # need not ride the session queue + disk every step
    checkpoint_frequency: int = 1


@dataclasses.dataclass
class _Tracked:
    checkpoint: Checkpoint
    metrics: dict
    index: int

    def score(self, attr: str | None):
        if attr is None:
            return self.index  # recency
        v = self.metrics.get(attr)
        return self.index if v is None else v


class CheckpointManager:
    """Registers reported checkpoints into `experiment_dir`, keeps the
    top-k by score (or the k most recent), deletes the rest.

    Reference: train/_internal/checkpoint_manager.py."""

    def __init__(self, experiment_dir: str,
                 config: CheckpointConfig | None = None):
        self.dir = os.path.abspath(experiment_dir)
        os.makedirs(self.dir, exist_ok=True)
        self.config = config or CheckpointConfig()
        self._tracked: list[_Tracked] = []
        self._index = self._restore_index()

    def _restore_index(self) -> int:
        mx = -1
        for name in os.listdir(self.dir):
            if name.startswith("checkpoint_"):
                try:
                    idx = int(name.split("_")[1])
                except (IndexError, ValueError):
                    continue
                mx = max(mx, idx)
                meta = os.path.join(self.dir, name, ".metrics.json")
                metrics = {}
                if os.path.exists(meta):
                    with open(meta) as f:
                        metrics = json.load(f)
                self._tracked.append(_Tracked(
                    Checkpoint(os.path.join(self.dir, name)), metrics, idx))
        self._tracked.sort(key=lambda t: t.index)
        return mx + 1

    def register(self, checkpoint: Checkpoint, metrics: dict | None = None
                 ) -> Checkpoint:
        """Move/copy a reported checkpoint into the experiment dir and
        apply the retention policy. Returns the persisted Checkpoint."""
        metrics = dict(metrics or {})
        idx = self._index
        self._index += 1
        dest = os.path.join(self.dir, f"checkpoint_{idx:06d}")
        if os.path.abspath(checkpoint.path) != dest:
            # same-filesystem move when possible, copy otherwise
            try:
                os.rename(checkpoint.path, dest)
            except OSError:
                checkpoint.to_directory(dest)
        with open(os.path.join(dest, ".metrics.json"), "w") as f:
            json.dump(_json_safe(metrics), f)
        persisted = Checkpoint(dest)
        self._tracked.append(_Tracked(persisted, metrics, idx))
        self._enforce_retention()
        return persisted

    def _enforce_retention(self):
        k = self.config.num_to_keep
        if k is None or len(self._tracked) <= k:
            return
        attr = self.config.checkpoint_score_attribute
        reverse = self.config.checkpoint_score_order == "max"
        ranked = sorted(self._tracked, key=lambda t: t.score(attr),
                        reverse=reverse)
        keep = set(id(t) for t in ranked[:k])
        # never delete the most recent (resume anchor), reference keeps it
        keep.add(id(self._tracked[-1]))
        for t in list(self._tracked):
            if id(t) not in keep:
                shutil.rmtree(t.checkpoint.path, ignore_errors=True)
                self._tracked.remove(t)

    def latest(self) -> Checkpoint | None:
        return self._tracked[-1].checkpoint if self._tracked else None

    def best(self) -> Checkpoint | None:
        if not self._tracked:
            return None
        attr = self.config.checkpoint_score_attribute
        reverse = self.config.checkpoint_score_order == "max"
        return sorted(self._tracked, key=lambda t: t.score(attr),
                      reverse=reverse)[0].checkpoint


def _json_safe(d: dict) -> dict:
    out = {}
    for k, v in d.items():
        try:
            json.dumps(v)
            out[k] = v
        except (TypeError, ValueError):
            out[k] = repr(v)
    return out

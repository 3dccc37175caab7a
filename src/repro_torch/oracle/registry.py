"""Versioned predictor snapshots with atomic swap, the port of
``repro.oracle.registry``.

The serving side of the oracle: every refit *publishes* a new immutable
:class:`Snapshot` and swaps the current-version pointer atomically (one
reference assignment under a lock), so concurrent readers — scheduler
ETC rows mid-sweep, decision sweeps mid-flight — always see a complete
fitted model, never a half-updated one.  With a ``root`` directory the
registry also persists each snapshot through
:mod:`repro_torch.core.predictors.persist` (``.npz`` + ``.json``, temp-file +
``os.replace``) and maintains a ``CURRENT.json`` pointer with the same
discipline, so a crashed process resumes from the last fully-published
version via :meth:`PredictorRegistry.load`.  The bundle format is the
reference's, so a directory written by either package loads in the other.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import threading
from typing import Optional

from repro_torch.core.predictors.persist import (load_predictor,
                                                 save_predictor)
from repro_torch.obs.trace import NULL_TRACER


@dataclasses.dataclass(frozen=True)
class Snapshot:
    """One published predictor version (immutable)."""
    version: int
    model: object
    tag: str = ""
    meta: dict = dataclasses.field(default_factory=dict)


class PredictorRegistry:
    """In-process registry of fitted-predictor versions.

    ``publish`` is the only mutating operation; ``current()`` is a
    lock-free read of the last fully-published snapshot (publication
    happens-before the pointer swap).  ``keep`` bounds the in-memory
    history; on-disk bundles are kept for every version.
    """

    CURRENT = "CURRENT.json"

    def __init__(self, root: Optional[str] = None, keep: int = 8):
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        self.root = root
        self.keep = keep
        self.obs = NULL_TRACER           # set by simulate_stream
        self._lock = threading.Lock()
        self._history: dict[int, Snapshot] = {}
        self._current: Optional[Snapshot] = None
        self._next_version = 0           # monotonic: never re-minted

    # -- reads ------------------------------------------------------------
    @property
    def version(self) -> int:
        """Current version, or -1 before the first publish."""
        snap = self._current
        return -1 if snap is None else snap.version

    def current(self) -> Snapshot:
        snap = self._current
        if snap is None:
            raise LookupError("registry is empty — publish a model first")
        return snap

    def get(self, version: int) -> Snapshot:
        """A specific published version (in-memory history, falling back
        to the on-disk bundle when a ``root`` is configured)."""
        snap = self._history.get(version)
        if snap is not None:
            return snap
        if self.root is not None:
            base = self._base(version)
            if os.path.exists(f"{base}.json"):
                return Snapshot(version, load_predictor(base),
                                tag="loaded")
        raise LookupError(f"version {version} not in registry "
                          f"(have {sorted(self._history)})")

    # -- writes -----------------------------------------------------------
    def publish(self, model, tag: str = "",
                meta: Optional[dict] = None,
                ts: float = 0.0) -> int:
        """Register ``model`` as the next version and atomically swap the
        current pointer to it; returns the new version number.  Versions
        come from a monotonic counter — publishing after a rollback
        mints a *fresh* number rather than overwriting the rolled-past
        snapshot (history and on-disk bundles stay intact).  ``ts`` is
        the caller's clock reading for the publish instant a live
        tracer records (virtual time from the oracle's refit path)."""
        with self._lock:
            v = self._next_version
            self._next_version += 1
            snap = Snapshot(v, model, tag, dict(meta or {}))
            if self.root is not None:
                self._persist(snap)
            self._history[v] = snap
            while len(self._history) > self.keep:
                del self._history[min(self._history)]
            self._current = snap                 # the atomic swap
        if self.obs.enabled:
            self.obs.instant("oracle", "registry_publish", float(ts),
                             args={"version": v, "tag": tag})
        return v

    def rollback(self, version: int) -> Snapshot:
        """Point ``current`` back at an older published version (the
        history keeps it addressable; no new version is minted)."""
        snap = self.get(version)
        with self._lock:
            self._history[version] = snap
            self._current = snap
            if self.root is not None:
                self._write_pointer(version, snap.tag)
        return snap

    # -- persistence ------------------------------------------------------
    def _base(self, version: int) -> str:
        return os.path.join(self.root, f"v{version:05d}")

    def _persist(self, snap: Snapshot) -> None:
        os.makedirs(self.root, exist_ok=True)
        save_predictor(snap.model, self._base(snap.version))
        self._write_pointer(snap.version, snap.tag)

    def _write_pointer(self, version: int, tag: str) -> None:
        fd, tmp = tempfile.mkstemp(dir=self.root, prefix=".tmp-")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump({"version": version, "tag": tag}, f)
            os.replace(tmp, os.path.join(self.root, self.CURRENT))
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    @classmethod
    def load(cls, root: str, keep: int = 8) -> "PredictorRegistry":
        """Rebuild a registry from a persisted directory: the
        ``CURRENT.json`` pointer names the version to resume serving."""
        with open(os.path.join(root, cls.CURRENT)) as f:
            ptr = json.load(f)
        reg = cls(root=root, keep=keep)
        v = int(ptr["version"])
        snap = Snapshot(v, load_predictor(reg._base(v)),
                        tag=str(ptr.get("tag", "")))
        reg._history[v] = snap
        reg._current = snap
        # resume the counter past every bundle on disk, not just the
        # current pointer (it may have been rolled back)
        published = [int(f[1:-5]) for f in os.listdir(root)
                     if f.startswith("v") and f.endswith(".json")]
        reg._next_version = max(published, default=v) + 1
        return reg

"""The index's numbering under a window's mutation log (`window.py`),
replayed.

Point numbers: the base points are 0..n-1, point p of the run's pushed
stream is n + p. A table maps each position, the id the index gives a
live point, to its point number: a push appends the point numbers
n + first ..; a delete removes the listed positions, and the survivors
shift down, as `IVFADCIndex.delete` renumbers. Version v is the state
after the log's first v mutations; the replay only moves forward.
"""

from __future__ import annotations

import numpy as np


class Replay:
    def __init__(self, n: int, log: list):
        self.n = n
        self.log = list(log)
        ends = [m[1] + m[2] for m in self.log if m[0] == "push"]
        self.n_all = n + max(ends, default=0)     # every point ever held
        self.version = 0
        self.table = np.arange(n, dtype=np.int64)
        self.live = np.zeros(self.n_all, bool)
        self.live[:n] = True
        self.strays = 0          # delete ids that named no position

    @property
    def pushes(self) -> list:
        """(first, count) of every push in the log."""
        return [(m[1], m[2]) for m in self.log if m[0] == "push"]

    def advance(self, version: int) -> "Replay":
        """Apply the log up to `version`."""
        if version < self.version:
            raise ValueError(f"replay is at version {self.version}, "
                             f"asked for {version}")
        while self.version < version:
            self._apply(self.log[self.version])
            self.version += 1
        return self

    def at_end(self) -> "Replay":
        return self.advance(len(self.log))

    def _apply(self, m: tuple) -> None:
        if m[0] == "push":
            pts = self.n + np.arange(m[1], m[1] + m[2], dtype=np.int64)
            self.table = np.concatenate([self.table, pts])
            self.live[pts] = True
        elif m[0] == "delete":
            ids = np.unique(np.asarray(m[1], np.int64))
            ok = (ids >= 0) & (ids < self.table.size)
            self.strays += int((~ok).sum())
            self.live[self.table[ids[ok]]] = False
            self.table = np.delete(self.table, ids[ok])
        else:
            raise ValueError(f"unknown mutation {m[0]!r}")

    def points(self, ids: np.ndarray) -> np.ndarray:
        """Positions -> point numbers at this version; -1 for an id that
        names no position."""
        ids = np.asarray(ids, np.int64)
        ok = (ids >= 0) & (ids < self.table.size)
        out = np.full(ids.shape, -1, np.int64)
        out[ok] = self.table[ids[ok]]
        return out

    def positions(self, points: np.ndarray) -> np.ndarray:
        """Point numbers -> positions at this version; -1 for a point that
        is not live (or no point)."""
        inv = np.full(self.n_all, -1, np.int64)
        inv[self.table] = np.arange(self.table.size)
        points = np.asarray(points, np.int64)
        ok = (points >= 0) & (points < self.n_all)
        out = np.full(points.shape, -1, np.int64)
        out[ok] = inv[points[ok]]
        return out

"""Crash-safe, resumable sweep ledger — the port's copy of
``lightgbm_tpu/sweep/ledger.py`` (numpy only, the same behaviour and the
same bytes on both codecs).

The R workflow checkpoints its 108x9 ``paramGrid`` data.frame after every
config with ``save(paramGrid, file=...)`` "if lgb crashes"
(r/gridsearchCV.R:118) and resumes with ``load(...)``.  This module keeps
that contract, with:

* **atomic saves** — every write goes to a ``.tmp-`` sibling in the
  SAME directory, is fsynced, then ``os.replace``d into place (the r13
  checkpoint protocol), so a kill mid-save can never corrupt the ledger
  a resume depends on;
* **sentinel-proof leaderboard** — rows still carrying the -1 "crashed/
  unfinished" sentinel are excluded from ranking, so an interrupted
  config can never be handed to auto-promotion as the "winner";
* **codec by suffix** — ``.RData`` paths read/write R's actual
  serialization (byte-compatible with R's ``save()`` / ``load()``
  checkpoint, :mod:`..utils.rdata`), anything else is JSON.  A ledger
  saved by either package resumes in the other.

Ledger writes are byte-deterministic for a given row state (the JSON
``saved_at`` stamp comes from the injectable ``clock``; the RData gzip
wrapper pins mtime=0), so interrupted and resumed ledgers compare to
uninterrupted ones as files.
"""

from __future__ import annotations

import hashlib
import itertools
import json
import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

RESULT_COLUMNS = ("iteration", "score")
SENTINEL = -1.0  # paramGrid.RData's marker for crashed/unfinished rows


def expand_grid(**axes: Sequence[Any]) -> List[Dict[str, Any]]:
    """R ``expand.grid`` equivalent: cartesian product, first axis fastest
    (R's column-major convention, so row order matches the reference grid)."""
    names = list(axes.keys())
    values = [list(axes[n]) for n in names]
    rows = []
    for combo in itertools.product(*reversed(values)):
        row = dict(zip(reversed(names), combo))
        rows.append({n: row[n] for n in names})
    return rows


def grid_digest(grid: List[Dict[str, Any]], **extra: Any) -> str:
    """Stable content hash of a config grid (+ run statics like nfold /
    seed / rounds) — the compatibility key hyper-batch checkpoints carry
    so a resume against a DIFFERENT sweep definition restarts cleanly
    instead of restoring foreign state."""
    doc = {"grid": [{k: row[k] for k in sorted(row)} for row in grid]}
    doc.update({k: extra[k] for k in sorted(extra)})
    return hashlib.sha256(
        json.dumps(doc, sort_keys=True, default=float).encode()
    ).hexdigest()


class SweepLedger:
    """Resumable grid ledger: one record per config with status + results.

    ``clock`` stamps the JSON codec's ``saved_at`` field; the default is
    a bare wall-clock reference, injectable for deterministic runs.
    """

    def __init__(self, grid: List[Dict[str, Any]], path: Optional[str] = None,
                 *, clock: Callable[[], float] = time.time):
        self.path = path
        self.clock = clock
        self.rows: List[Dict[str, Any]] = []
        for cfg in grid:
            row = {c: SENTINEL for c in RESULT_COLUMNS}
            row.update(cfg)
            self.rows.append(row)
        if path and os.path.exists(path):
            self._merge_existing(path)

    @staticmethod
    def _is_rdata(path: str) -> bool:
        return path.lower().endswith(".rdata")

    def _merge_existing(self, path: str) -> None:
        if self._is_rdata(path):
            from ..utils.rdata import read_rdata
            dfs = read_rdata(path)
            df = dfs.get("paramGrid") or next(iter(dfs.values()), {})
            cols = list(df.keys())
            nrow = len(df[cols[0]]) if cols else 0
            saved_rows = [{c: df[c][i] for c in cols} for i in range(nrow)]
        else:
            with open(path) as f:
                saved = json.load(f)
            saved_rows = saved.get("rows", [])
        for i, srow in enumerate(saved_rows):
            if i >= len(self.rows):
                break
            mine = {k: v for k, v in self.rows[i].items()
                    if k not in RESULT_COLUMNS}
            theirs = {k: v for k, v in srow.items() if k not in RESULT_COLUMNS}
            if self._cfg_equal(mine, theirs) and \
                    srow.get("iteration", SENTINEL) != SENTINEL:
                merged = dict(self.rows[i])
                merged.update({c: srow[c] for c in RESULT_COLUMNS
                               if c in srow})
                self.rows[i] = merged

    @staticmethod
    def _cfg_equal(a: Dict[str, Any], b: Dict[str, Any]) -> bool:
        """Config equality across serializations (R numerics come back as
        floats: num_leaves 31 vs 31.0 must still match)."""
        if set(a) != set(b):
            return False
        for k in a:
            x, y = a[k], b[k]
            if isinstance(x, (int, float)) and isinstance(y, (int, float)):
                if abs(float(x) - float(y)) > 1e-9 * max(1.0, abs(float(x))):
                    return False
            elif x != y:
                return False
        return True

    def done(self, i: int) -> bool:
        return self.rows[i]["iteration"] != SENTINEL

    def pending(self) -> List[int]:
        """Indices still carrying the sentinel (the resume work list)."""
        return [i for i in range(len(self.rows)) if not self.done(i)]

    def record(self, i: int, best_iter: int, best_score: float) -> None:
        self.rows[i]["iteration"] = int(best_iter)
        self.rows[i]["score"] = float(best_score)
        self.save()

    def save(self) -> None:
        """Atomic, durable write: tmp sibling -> fsync -> ``os.replace`` — a
        kill at any byte of the save leaves the previous ledger intact."""
        if not self.path:
            return
        tmp = os.path.join(
            os.path.dirname(self.path) or ".",
            f".tmp-{os.path.basename(self.path)}")
        try:
            if self._is_rdata(self.path):
                from ..utils.rdata import write_rdata
                cols = list(self.rows[0].keys()) if self.rows else []
                write_rdata(tmp, "paramGrid",
                            {c: [r[c] for r in self.rows] for c in cols})
                fd = os.open(tmp, os.O_RDONLY)
                try:
                    os.fsync(fd)
                finally:
                    os.close(fd)
            else:
                with open(tmp, "w") as f:
                    json.dump({"rows": self.rows, "saved_at": self.clock()},
                              f, indent=1)
                    f.flush()
                    os.fsync(f.fileno())
            os.replace(tmp, self.path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)

    def leaderboard(self) -> List[Dict[str, Any]]:
        """COMPLETED rows ordered by score descending (scores are
        sign-flipped so higher is better — the R convention;
        r/gridsearchCV.R:122).  Rows still carrying a sentinel in EITHER
        result column are excluded: a crashed/unfinished config must
        never rank as the winning configuration handed to
        auto-promotion."""
        return sorted((r for r in self.rows
                       if r["iteration"] != SENTINEL
                       and r["score"] != SENTINEL),
                      key=lambda r: -r["score"])

    def to_numpy(self):
        cols = list(self.rows[0].keys())
        return cols, np.array([[r[c] for c in cols] for r in self.rows],
                              dtype=np.float64)

"""Streaming-update journal: checkpoint + replay = exactly-once recovery.

Every micro-batch is logged before it is applied (write-ahead).  Restart
= restore the latest state snapshot, then replay the entries with id >=
the snapshot's step.  The records are the reference's JSONL, one batch a
line: ``{"id", "edges": [[src, dst, add, weight]], "features": [[vertex,
[values]]]}``; a float32 feature value goes through ``tolist()`` as a
double and comes back bit-identical, so either package replays the
other's journal.
"""
from __future__ import annotations

import json
import os

import numpy as np

from repro_torch.core.graph import EdgeUpdate, FeatureUpdate, UpdateBatch


def _encode(batch: UpdateBatch) -> dict:
    return {
        "edges": [[e.src, e.dst, int(e.add), float(e.weight)]
                  for e in batch.edges],
        "features": [[f.vertex, np.asarray(f.value).tolist()]
                     for f in batch.features],
    }


def _decode(d: dict) -> UpdateBatch:
    return UpdateBatch(
        edges=[EdgeUpdate(int(s), int(t), bool(a), float(w))
               for s, t, a, w in d["edges"]],
        features=[FeatureUpdate(int(v), np.asarray(x, dtype=np.float32))
                  for v, x in d["features"]])


class UpdateJournal:
    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._fh = open(path, "a")
        self.next_id = self._scan_len()

    def _scan_len(self) -> int:
        with open(self.path) as f:
            return sum(1 for _ in f)

    def append(self, batch: UpdateBatch) -> int:
        """Write-ahead log one batch (flushed and fsynced); returns its
        journal id."""
        rec = {"id": self.next_id, **_encode(batch)}
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()
        os.fsync(self._fh.fileno())
        self.next_id += 1
        return rec["id"]

    def replay(self, from_id: int):
        """Yield (id, batch) for the entries with id >= ``from_id``."""
        with open(self.path) as f:
            for line in f:
                rec = json.loads(line)
                if rec["id"] >= from_id:
                    yield rec["id"], _decode(rec)

    def truncate(self, n: int) -> None:
        """Discard the entries with id >= ``n`` (rollback of the log tail),
        so that the next append gets id ``n``.  The kept lines go to a
        temporary file that replaces the log atomically: a crash in the
        rewrite never destroys the committed log."""
        if n >= self.next_id:
            return
        self._fh.close()
        with open(self.path) as f:
            keep = [line for line in f if json.loads(line)["id"] < n]
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            f.writelines(keep)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)
        self._fh = open(self.path, "a")
        self.next_id = n

    def close(self):
        self._fh.close()

"""Sweep-cell checkpointing: preemption-safe table sweeps.

Port of ``mrgan_tpu/utils/checkpoint.py``. Every completed sweep cell
{table, modality, percent, ...} -> per-fold errors is appended to a JSONL
file as soon as it finishes; re-running the same command skips completed
cells. Records carry a provenance stamp (``utils/stamp.py``).

One fault of the original is not copied (``ROADMAP.md`` A7): it collects
the generator versions stamped in the file but never checks them, so a
resumed sweep could mix cells of two synthetic generators. Given the
run's ``generator``, this checkpoint refuses a file stamped with any other.
"""

import json
import os

from .stamp import generator_of


class SweepCheckpoint:
    """Append-only {cell-key -> result} store backed by a JSONL file."""

    def __init__(self, path, generator=None):
        self.path = path
        self._done = {}
        self.generators = set()  # generator versions seen in the file
        if path and os.path.exists(path):
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    rec = json.loads(line)
                    self._done[self._key(rec["cell"])] = rec["result"]
                    self.generators.add(generator_of(rec))
        other = self.generators - {generator}
        if generator is not None and other:
            raise ValueError(
                "checkpoint %s holds cells of generator %s; this run's data "
                "is %r, and mixing them would compare two datasets: use "
                "another --checkpoint file" % (path, sorted(other), generator))

    @staticmethod
    def _key(cell):
        return json.dumps(cell, sort_keys=True)

    def get(self, **cell):
        return self._done.get(self._key(cell))

    def record(self, result, stamp=None, **cell):
        self._done[self._key(cell)] = result
        if self.path:
            rec = {"cell": cell, "result": result}
            if stamp:
                rec["stamp"] = stamp
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")
                f.flush()
                os.fsync(f.fileno())
        return result


def file_generators(path):
    """The set of generator versions stamped in a checkpoint JSONL file
    (empty for no path or an absent file; "unstamped" counts rows without
    a stamp)."""
    gens = set()
    if path and os.path.exists(path):
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    gens.add(generator_of(json.loads(line)))
    return gens

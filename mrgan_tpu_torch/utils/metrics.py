"""Structured metric stream (JSONL) + the reference's stdout table format.

Port of ``mrgan_tpu/utils/metrics.py``, copied line for line: the table
CLIs of both packages print the same strings for the same calls (held
by ``tests/test_torch_cli.py``). The reference logs by print/flush only
(mr_gan.py:226-228, 258-261); every metric event also lands in a JSONL
stream so plots and tables regenerate from logs.
"""

import json
import sys
import time


class MetricStream:
    def __init__(self, path=None):
        self.path = path
        self._f = open(path, "a") if path else None

    def emit(self, event, **fields):
        if self._f is None:
            return
        rec = {"t": time.time(), "event": event, **fields}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self):
        if self._f:
            self._f.close()
            self._f = None


# ---------------------------------------------------------------------------
# Reference-format stdout (mr_gan.py:246-261 prints, py2 `print a, b` spacing)
# ---------------------------------------------------------------------------

def p(*items):
    """py2-style print: space-joined str()s."""
    print(" ".join(str(i) for i in items))
    sys.stdout.flush()


def header(title):
    p("")
    p("-" * 25, title, "-" * 25)
    p("-" * 100)


def modality_header(name):
    p("-" * 25, name, "modality", "-" * 25)


def subheader(text):
    p("-" * 15, text, "-" * 15)


def fold_result(err, prefix=None):
    items = [] if prefix is None else [prefix]
    p(*items, "Test error:", err, "Test accuracy:", 1.0 - err)


def cell_average(errors, loo=False):
    import numpy as np

    label = "Average leave-one-object-out error:" if loo else "Average error:"
    p(label, np.mean(errors), "Average accuracy:",
      np.mean(1.0 - np.asarray(errors)))

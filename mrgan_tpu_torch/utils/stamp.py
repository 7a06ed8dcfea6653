"""Provenance stamps for sweep artifacts.

Port of ``mrgan_tpu/utils/stamp.py``. Every checkpointed cell carries

    {"generator": <data.synthetic.GENERATOR_VERSION or "real">,
     "git": <short sha>, "round": <MRGAN_ROUND env, if set>}

so that comparisons can refuse a set mixed from two data generations.
"""

import os
import subprocess


def _git_sha():
    try:
        return subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=10,
        ).stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"  # stamps must never break a sweep


def current(synthetic):
    """The provenance stamp for cells produced by this process.

    ``synthetic``: whether the data was the synthetic generator's, as the
    loader decided it (``data.mreo.uses_synthetic``), not as a flag asked
    for it: a run without ``--synthetic`` and without the processed
    pickles trains on synthetic data too.
    """
    from ..data import synthetic as synth

    stamp = {
        "generator": synth.GENERATOR_VERSION if synthetic else "real",
        "git": _git_sha(),
    }
    rnd = os.environ.get("MRGAN_ROUND")
    if rnd:
        stamp["round"] = rnd
    return stamp


def generator_of(record):
    """The generator version a checkpoint JSONL record was produced under
    ("unstamped" for a record without a stamp)."""
    return (record.get("stamp") or {}).get("generator", "unstamped")

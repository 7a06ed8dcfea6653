"""The readings that a cell's correctness limits are set from, at the cell's
own size, several seeds in one process:

- sound: the program's numbers against the plain reference (float32,
  TF32 off), as a run's check computes them;
- control: the reference computed with TF32 on, put in the program's
  place, against the float32 reference;
- half_batch (training cells): the reference with each batch's first half
  only, against the full one (the fault of a step that leaves half of its
  batch out).

    python3 benchmarks/control.py --workload fmgan_m5.loo72 \
        --seeds 11 12 13 --control-seeds 11 12 13 [--out FILE]

Each reading is one JSON line on standard output (and in ``--out``). The
benchmark's own runs do not run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
sys.path.insert(0, str(BENCH_DIR))
sys.path.insert(1, str(ROOT))

import torch  # noqa: E402

import checks  # noqa: E402
import harness  # noqa: E402


def training_readings(obj, control):
    if obj.reading is None:
        obj.call()
    ref = obj.reference()
    out = {"sound": checks.training_numbers(obj.reading, ref),
           "sound_loss_by_step": _loss_by_step(obj.reading, ref),
           "sound_by_leaf": _by_leaf(obj.reading, ref)}
    if control:
        tf32 = obj.reference(tf32=True)
        out["control"] = checks.training_numbers(tf32, ref)
        out["control_loss_by_step"] = _loss_by_step(tf32, ref)
        out["half_batch"] = checks.training_numbers(
            obj.reference(half_batch=True), ref)
    return out


def _by_leaf(a, b):
    """{leaf: [worst fold's first-gradient gap, change gap]}."""
    names = sorted(b["grad"])
    grad = checks.leaf_gaps(a["grad"], b["grad"])
    change = checks.leaf_gaps(a["change"], b["change"])
    return {n: [float(grad[i].max()), float(change[i].max())]
            for i, n in enumerate(names)}


def _loss_by_step(a, b):
    gap = (a["loss"] - b["loss"]).abs() / b["loss"].abs()
    return gap.reshape(gap.shape[0], -1).max(dim=1).values.tolist()


def score_readings(obj, control):
    for _ in range(obj.mix["sets"] * 2):
        obj.call()
    out = {"sound": obj.numbers(range(len(obj.answers)))}
    if control:
        gap = 0.0
        for k in range(obj.mix["sets"]):
            ref = obj.reference_logits(k)
            served = obj.reference_logits(k, tf32=True).argmax(dim=-1)
            gap = max(gap, checks.answer_gap(ref, served))
        out["control"] = {"answer_gap": gap}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    ap.add_argument("--root", default=str(ROOT))
    args = ap.parse_args(argv)
    cell = harness.Cell(args.workload, args.root)
    lines = []
    for seed in sorted(set(args.seeds) | set(args.control_seeds)):
        t0 = time.perf_counter()
        obj = cell.driver.Cell(cell.cfg, cell.mix, seed, args.device)
        control = seed in args.control_seeds
        if obj.unit == "pokes":
            rec = score_readings(obj, control)
        else:
            rec = training_readings(obj, control)
        rec.update(workload=args.workload, seed=seed,
                   seconds=time.perf_counter() - t0)
        if torch.device(args.device).type == "cuda":
            rec["device"] = torch.cuda.get_device_name(0)
        line = json.dumps(rec)
        print(line, flush=True)
        lines.append(line)
        del obj
        if torch.device(args.device).type == "cuda":
            torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

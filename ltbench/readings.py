"""The readings that the limits of a cell's output check are set from, on
the card, in one process: one set-up of the cell, then for each seed the
frames and pixels that a run of that seed would check (as if its window
held ``--jobs`` jobs), rendered by

- the program (``program``): the lower readings;
- the reference in bfloat16 in the program's place (``control``): the
  upper readings;
- the program with a fault of ``ltbench.faults`` planted (``fault:<name>``),

each compared with the float32 reference.  One JSON line a reading.

    python3 ltbench/readings.py --workload <cell> --seeds 1,2,3 \\
        [--control-seeds 4,5,6] [--fault-seeds 7,8,9] [--jobs 200]
"""

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _seeds(text):
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=_seeds, default=[])
    p.add_argument("--control-seeds", type=_seeds, default=[])
    p.add_argument("--fault-seeds", type=_seeds, default=[])
    p.add_argument("--jobs", type=int, default=200)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    from ltbench import faults, seeds
    from ltbench.registry import Registry

    dev = torch.device("cuda")
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    reg = Registry(ROOT)
    spec = reg.cell(args.workload)
    traffic = reg.traffic(spec["traffic"])
    work = reg.workload(args.workload)
    sess = reg.module("entries", traffic["entry"]).Session(
        reg, reg.config(spec["config"]), traffic, dev)

    def sample(seed):
        n_pix = min(int(work["check"]["pixels"]), sess.pixels)
        ids = torch.as_tensor(np.sort(seeds.rng(seed, seeds.SAMPLE).choice(
            sess.pixels, n_pix, replace=False)), device=dev)
        frames = np.sort(seeds.rng(seed, seeds.JOB).choice(
            args.jobs, int(work["check"]["frames"]), replace=False))
        return ids, [seeds.part_seed(seed, seeds.JOB, int(f)) for f in frames]

    def program(seed, fault=None):
        ids, fseeds = sample(seed)
        with (faults.FAULTS[fault]() if fault else contextlib.nullcontext()):
            got = torch.stack([sess.pick(sess.job(s), ids) for s in fseeds])
        return got, ids, fseeds

    runs = [(s, "program", None) for s in args.seeds]
    runs += [(s, "control", None) for s in args.control_seeds]
    runs += [(s, f"fault:{f}", f) for s in args.fault_seeds
             for f in faults.FAULTS]
    for seed, kind, fault in runs:
        t0 = time.perf_counter()
        if kind == "control":
            ids, fseeds = sample(seed)
            got = sess.reference_pixels(fseeds, ids, dtype=torch.bfloat16)
        else:
            got, ids, fseeds = program(seed, fault)
        want = sess.reference_pixels(fseeds, ids)
        numbers = sess.compare(got, want)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "kind": kind, **numbers,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

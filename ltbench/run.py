"""Run one cell of the benchmark once and print its result line.

    python3 ltbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  Needs a CUDA card (and as many as the cell
asks for); without one it fails and prints no result.  The last line of
standard output is the result, one JSON object; the numbers compared with
the reference, each beside its limit, are the last lines of standard
error and the result's last key, ``check``."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# the top-level modules that may not be loaded when the result is printed
FORBIDDEN = ("jax", "jaxlib", "flax", "light_transport_tpu")


def _args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    args = _args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from ltbench import harness
    from ltbench.registry import Registry

    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card only",
              file=sys.stderr)
        return 2
    chips = int(Registry(ROOT).cell(args.workload)["chips"])
    if torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA devices, found "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = harness.run(ROOT, args.workload, args.seed, args.seconds,
                         bool(args.trace), device="cuda", t_start=T_START)
    found = forbidden_modules()
    if found:
        print(f"modules loaded that the benchmark may not load: {found}",
              file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

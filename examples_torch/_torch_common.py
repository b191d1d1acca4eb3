"""Shared helpers of the PyTorch port's example drivers: PNG output through
``light_transport_tpu_torch.utils.png``, the one-line JSON report, a timer,
``timed_twice`` and the drivers' command line.

Each driver in this directory has a ``main()`` that runs it at the JAX
driver's sizes (``examples/<name>.py``) on the card, and a ``run(...)``
that takes those sizes, the seeds, the device and the output directory
as arguments and returns the report lines it printed.
"""

import argparse
import importlib.util
import json
import os
import sys
import time

import numpy as np
import torch

# make `python examples_torch/foo.py` work from anywhere: the package lives
# one level up from this file
ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, ROOT)

from light_transport_tpu_torch.utils.png import write_png  # noqa: E402

OUT_DIR = os.path.join(ROOT, "artifacts", "examples_torch")

# the drivers, one for each of examples/*.py under the same name
DRIVERS = ("adaptive_compare", "bdpt_cornell", "dof_compare", "glossy_mis",
           "hard_shadow", "lts_cornell", "photon_mcml", "point_light",
           "ray_tracing", "refraction", "sampler_compare", "soft_shadow")


def load(name: str):
    """Import driver ``name`` of this directory as ``examples_torch.<name>``
    (a name no other module of the repo takes)."""
    key = f"examples_torch.{name}"
    if key not in sys.modules:
        here = os.path.dirname(os.path.abspath(__file__))
        if here not in sys.path:
            sys.path.insert(0, here)
        spec = importlib.util.spec_from_file_location(
            key, os.path.join(here, f"{name}.py"))
        module = importlib.util.module_from_spec(spec)
        sys.modules[key] = module
        spec.loader.exec_module(module)
    return sys.modules[key]


def to_numpy(x) -> np.ndarray:
    """A tensor on any device (or an array) as a numpy array; reading it
    back waits for the card."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save_image(img, name: str, gamma: float = 1.0,
               out_dir: str = OUT_DIR) -> str:
    """Clip, apply ``gamma`` and write a PNG into ``out_dir``; returns the
    path."""
    os.makedirs(out_dir, exist_ok=True)
    arr = np.clip(to_numpy(img).astype(np.float32), 0.0, 1.0)
    if gamma != 1.0:
        arr = arr ** (1.0 / gamma)
    return write_png(os.path.join(out_dir, name), arr)


def report(name: str, seconds: float, **extra) -> dict:
    """Print the one-line machine-readable summary of the JAX drivers and
    return it."""
    line = {"example": name, "seconds": round(seconds, 3), **extra}
    print(json.dumps(line), flush=True)
    return line


def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class timer:
    """Host-clock seconds of a block, the card's queue drained at both
    ends."""

    def __enter__(self):
        _sync()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *a):
        _sync()
        self.seconds = time.perf_counter() - self.t0


def timed_twice(fn):
    """Run ``fn`` twice: returns ``(result, first_seconds,
    steady_seconds)``.  The first call pays the kernels' build and first
    use; the second is the steady number.  A failure raises."""
    with timer() as t1:
        fn()
    with timer() as t2:
        result = fn()
    return result, t1.seconds, t2.seconds


def parse_args(argv=None, doc=None, quick=False):
    """The drivers' command line: ``--device`` (default ``cuda``: the
    card; ``cpu`` only when asked), ``--out-dir`` and, where the driver
    has one, ``--quick``."""
    p = argparse.ArgumentParser(description=doc)
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: cuda)")
    p.add_argument("--out-dir", default=OUT_DIR,
                   help="where the PNGs go (default: artifacts/"
                        "examples_torch)")
    if quick:
        p.add_argument("--quick", action="store_true",
                       help="the driver's smaller variant")
    return p.parse_args(argv)

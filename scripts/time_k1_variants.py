#!/usr/bin/env python3
"""Time variants of the photon kernel K1 against each other inside one run
on an NVIDIA GPU.

Usage, from the repository root:

    python3 scripts/time_k1_variants.py NAME=SOURCE.cu[:FLAG,...] ...

Each source is a version of ``light_transport_tpu_torch/csrc/photon_kernel.cu``
with the same C interface; it is built with the package's nvcc flags (and
the given extra flags, e.g. ``-maxrregcount=48``) into a library of its
own, all builds at once.  For each variant the script prints ptxas's
report for its main-path kernel, holds its state and counters bitwise
against the first variant's (full_scale and bench mode, two blocks of
2^19 lanes, k=64, in-kernel Philox), then times the full_scale block (in-
kernel Philox and uniforms read) and the bench block by chip_smoke.py's
phase-7 split, and runs phase 6's main path (full_scale, 1e7 photons,
2^19 lanes) for its steady steps/s, in turns: first to last, then last to
first.  The last line is one JSON object with every variant's numbers and
the card.
"""

import ctypes
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from light_transport_tpu_torch.core.config import MediumConfig  # noqa: E402
from light_transport_tpu_torch.models.presets import full_scale  # noqa: E402
from light_transport_tpu_torch.ops import _build  # noqa: E402
from light_transport_tpu_torch.ops import photon_kernel as pk  # noqa: E402
from light_transport_tpu_torch.scene.medium import LayeredMedium  # noqa: E402
from light_transport_tpu_torch.tally.tallies import PhotonTallies  # noqa: E402

OUT = _build.BUILD_DIR / "variants"
# names a variant's main-path kernel may have in ptxas's report, newest
# template first (N_PHASE 2, in-kernel Philox, staged deposits)
MAIN_NAMES = ("photon_block_kernelILi2ELb0ELb1E",
              "photon_block_kernelILi2ELb0E", "photon_block_kernel")


def build(name, src, flags):
    """nvcc ``src`` with the package's flags plus ``flags``; returns the
    library's path and ptxas's report."""
    OUT.mkdir(parents=True, exist_ok=True)
    lib = OUT / f"{name}.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-o", str(lib),
           str(src)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{res.stdout}\n"
                           f"{res.stderr}")
    return lib, res.stdout + res.stderr


def load(path):
    lib = ctypes.CDLL(str(path))
    lib.photon_block_launch.argtypes = [ctypes.c_void_p] * 20
    lib.photon_block_launch.restype = ctypes.c_int
    lib.photon_kernel_error_string.argtypes = [ctypes.c_int]
    lib.photon_kernel_error_string.restype = ctypes.c_char_p
    return lib


def install(lib):
    """Route photon_block's launches to ``lib``."""
    _build._loaded["photon_kernel"] = lib


def main_report(log_text):
    for name in MAIN_NAMES:
        try:
            return name, cs.ptxas_report(log_text, name)
        except AssertionError:
            continue
    raise AssertionError("no photon_block_kernel in ptxas's report")


def run_blocks(medium, cfg, bench):
    """Two Philox blocks from the zero state; the state, counters and
    tallies after them."""
    eng = pk.PhotonKernelEngine(medium, cfg, cs.MAIN_LANES, bench_mode=bench,
                                k_steps=64, device=cs.DEV)
    state = eng.zero_state()
    tallies = PhotonTallies.zeros(cfg, cs.DEV)
    quota = torch.full((eng.n_tiles,), 0 if bench else cs.TILE + cs.TILE // 2,
                       dtype=torch.int32, device=cs.DEV)
    counters = []
    for b in range(2):
        c = pk.photon_block(eng.plan, state, quota, tallies, 9 + b, b)
        counters.append(c)
        quota = c[:, 3].to(torch.int32)
    torch.cuda.synchronize()
    return state, torch.cat(counters), tallies


def main_path_rate():
    """Phase 6's run (full_scale, 1e7 photons): steady steps/s, ms a
    block and occupancy."""
    m, cfg = full_scale(cs.DEV)
    cfg = dataclasses.replace(cfg, n_photons=10_000_000)
    timings = {}
    pk.simulate_kernel(m, cfg, seed=0, lanes=cs.MAIN_LANES, timings=timings,
                       device=cs.DEV)
    return (timings["steady_steps_per_sec"], timings["ms_per_block"],
            timings["steady_occupancy"])


def same_results(name, got, want):
    (sg, cg, tg), (sw, cw, tw) = got, want
    for f, a, c in zip(pk.KernelState._fields, sg, sw):
        cs.check(torch.equal(a.view(torch.int32), c.view(torch.int32)),
                 f"{name}: {f} differs from the first variant")
    cs.check(torch.equal(cg, cw), f"{name}: counters differ")
    worst = 0.0
    for g in cs.GRIDS:
        a, c = getattr(tg, g).double(), getattr(tw, g).double()
        err = float((a - c).abs().max())
        cs.check(err <= 2e-4 * max(float(c.abs().max()), 1e-30),
                 f"{name}: {g} err {err}")
        worst = max(worst, err)
    return worst


def main():
    if not torch.cuda.is_available():
        print("time_k1_variants: no CUDA device", file=sys.stderr)
        return 1
    variants = []
    for arg in sys.argv[1:]:
        name, spec = arg.split("=", 1)
        src, _, flags = spec.partition(":")
        variants.append((name, Path(src), [f for f in flags.split(",") if f]))
    card = cs.smi()
    print(f"card: {card}", flush=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(variants)) as pool:  # one nvcc per variant
        built = list(pool.map(lambda v: build(*v), variants))
    print(f"built {len(built)} variants ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    libs = {}
    sms = torch.cuda.get_device_properties(cs.DEV).multi_processor_count
    n_tiles = cs.MAIN_LANES // cs.TILE
    out = {"card": card, "variants": {}}
    for (name, src, flags), (path, text) in zip(variants, built):
        kname, (regs, stack, st, ld) = main_report(text)
        # resident 256-thread blocks per SM from the registers (allocated
        # in 8s per thread; 65,536 a SM; at most 8 such blocks)
        blocks = min(8, 65536 // (math.ceil(regs / 8) * 8 * cs.TILE))
        print(f"{name} ({src}{' ' + ' '.join(flags) if flags else ''}): "
              f"{kname}: {regs} registers, {stack} B stack, spills {st}/{ld} "
              f"B; {blocks} blocks per SM by registers, "
              f"{n_tiles / (blocks * sms):.3f} waves", flush=True)
        libs[name] = load(path)
        out["variants"][name] = {"source": str(src), "flags": flags,
                                 "registers": regs, "stack": stack,
                                 "spill_stores": st, "spill_loads": ld,
                                 "blocks_per_sm": blocks}
    # the same results from every variant: the stream and the adds
    m_fs, cfg_fs = full_scale(cs.DEV)
    m_b = LayeredMedium.build([MediumConfig(mu_a=1.0, mu_s=9.0, g=0.9,
                                            n=1.37)], device=cs.DEV)
    cfg_b = cs.PhotonRunConfig(nr=64, nz=64, dr=0.01, dz=0.01)
    first = None
    for name, lib in libs.items():
        install(lib)
        got = (run_blocks(m_fs, cfg_fs, False), run_blocks(m_b, cfg_b, True))
        if first is None:
            first = got
            continue
        err = same_results(name + " full_scale", got[0], first[0])
        same_results(name + " bench", got[1], first[1])
        print(f"{name}: state and counters bitwise equal to "
              f"{next(iter(libs))}'s (full_scale, bench); max grid err {err}",
              flush=True)
    # timed in turns: first to last, then last to first
    order = list(libs) + list(reversed(libs))
    runs = {name: [] for name in libs}
    for name in order:
        install(libs[name])
        sp = cs.k1_split()
        sp["rate"], sp["ms_per_block"], sp["occupancy"] = main_path_rate()
        runs[name].append(sp)
        print(f"{name}: block {sp['ms_philox']:.4f} ms Philox, "
              f"{sp['ms_fed']:.4f} ms uniforms read, bench block "
              f"{sp['ms_bench']:.4f} ms; live {sp['live']:.4f}; quota / bench "
              f"per executed lane-step {sp['ns_quota'] / sp['ns_bench']:.4f}; "
              f"main path {sp['rate']:.4e} steps/s, {sp['ms_per_block']:.4f} "
              f"ms/block, occupancy {sp['occupancy']:.4f}", flush=True)
    for name, sps in runs.items():
        rec = out["variants"][name]
        for key in ("ms_philox", "ms_fed", "ms_bench", "live", "rz_share",
                    "vol_share", "steps", "rate", "ms_per_block",
                    "occupancy"):
            rec[key] = [sp[key] for sp in sps]
        rec["quota_over_bench"] = [sp["ns_quota"] / sp["ns_bench"]
                                   for sp in sps]
        bound, old, terms = cs.k1_bound(sps[0])
        rec["bound_ms"], rec["bound_by"], rec["old_bound_ms"] = (
            bound[0], terms["by"], old)
        rec["bound_terms_ms"] = {k: v for k, v in terms.items() if k != "by"}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's photon and render paths on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases (each prints its result and time; any failure raises, and the
script exits non-zero without the final result line):

  1. the card (nvidia-smi name and power limit) and the torch/CUDA versions
  2. build every kernel from light_transport_tpu_torch/csrc/ (one nvcc per
     source, all started together) and print ptxas's reports
  3. photon kernel against its plain PyTorch version on the same uniforms:
     bench mode, stride-1 quota mode, and full_scale's configuration at
     the main path's shapes (2^19 lanes, k=64)
  4. physics through the Philox kernel: van de Hulst and the MCML slab
  5. engine parity: simulate_kernel against api.simulate (the superstep
     engine), chi-squared on the coarse-binned (r,z) grid
  6. photon main path: the full_scale preset at its full widths, 1e7
     photons
  7. bench mode: bench_kernel throughput, and kernel against plain time
     per block at the main path's shapes
  8. the intersector kernels K3 (dense) and K4 (gather) against their
     plain versions, nearest and any hit, on real ray batches: camera and
     bounce-1 rays of the glass preset (K3), camera and incoherent
     interior rays of the soft-shadow scene (K4), inactive lanes in all
  9. the glass preset at its preset size (100x100, 4 spp, depth 3)
     rendered through K3 and through the plain intersector from the same
     uniforms
 10. render main path: the soft-shadow scene (123,204 triangles, 241
     clusters) at 400x400, 10 spp, depth 3 through K4, and a subset of
     its lanes re-traced through the plain intersector

The line before the last is the card's name and power limit; the last
line is {"ok": true, "device": {...}}.
"""

import contextlib
import dataclasses
from concurrent.futures import ThreadPoolExecutor
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

import light_transport_tpu_torch as lt
from light_transport_tpu_torch.core.config import (
    MediumConfig,
    PhotonRunConfig,
    RenderConfig,
)
from light_transport_tpu_torch.integrators import path_tracer as pt
from light_transport_tpu_torch.models.presets import (
    full_scale,
    glass_scene,
    multilayer_mismatch,
)
from light_transport_tpu_torch.ops import _build
from light_transport_tpu_torch.ops import intersect_kernel as ik
from light_transport_tpu_torch.ops import photon_kernel as pk
from light_transport_tpu_torch.scene.cornell import sphere_triangles
from light_transport_tpu_torch.scene.geometry import (
    TriangleMesh,
    concat_meshes,
    quad_triangles,
)
from light_transport_tpu_torch.scene.material import (
    Material,
    MaterialTable,
    presets,
)
from light_transport_tpu_torch.scene.medium import LayeredMedium
from light_transport_tpu_torch.scene.scene import Scene
from light_transport_tpu_torch.tally.stats import (
    binomial_stderr,
    chi2_counts,
    mc_parity_3sigma,
)
from light_transport_tpu_torch.tally.tallies import PhotonTallies

DEV = torch.device("cuda", 0)
TILE = pk.TILE_LANES
# full_scale's recorded physics (1e8 photons, artifacts/full_scale_run.json)
FULL_SCALE_RD = 0.26239074
FULL_SCALE_N = 100_000_000
MAIN_LANES = 1 << 19  # the main path's lanes (phases 3, 6 and 7)
GRIDS = ("absorb_rz", "detector_xy", "absorb_xyz", "refl_r", "trans_r")
# NVIDIA's H100 SXM data sheet: FP32 on the CUDA cores, HBM3 bandwidth
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# operations per live photon step, counted from csrc/photon_kernel.cu's
# scatter step: ~130 FP32 (log1pf, cosf, two sqrtf, two divides, the hop,
# the HG sample and the frame rotation) and ~130 32-bit integer (two
# Philox4x32-10 evaluations), all counted against the FP32 rate
PHOTON_OPS_PER_STEP = 260
# operations per ray-triangle pair of the intersector: 22 multiplies, 16
# adds, one divide and six compares (csrc/intersect_kernel.cu)
PAIR_OPS = 45
SOFT_SHADOW_CFG = RenderConfig(width=400, height=400, spp=10, max_depth=3,
                               f_distance=3.5)


def log(phase, msg, t0=None):
    took = f" ({time.perf_counter() - t0:.2f} s)" if t0 is not None else ""
    print(f"[{phase}] {msg}{took}", flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Mean device time of ``fn()`` over ``reps`` calls, by CUDA events."""
    fn()  # warm
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


# --------------------------------------------------------------------------
# phase 3: kernel against plain on the same uniforms
# --------------------------------------------------------------------------

def compare_blocks(name, medium, cfg, bench, lanes, k_steps, quota_per_tile,
                   seed=7):
    """Two blocks on both sides from the same state and uniforms (block 2
    starts from the plain block-1 state).  Returns (max abs grid error,
    diverged lanes)."""
    eng = pk.PhotonKernelEngine(medium, cfg, lanes, bench_mode=bench,
                                k_steps=k_steps, tile_lanes=TILE, device=DEV)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(seed)
    state = eng.zero_state()
    quota = torch.full((eng.n_tiles,), quota_per_tile, dtype=torch.int32,
                       device=DEV)
    worst = 0.0
    n_div_all = 0
    for b in range(2):
        u = torch.rand((eng.plan.n_draws, lanes), generator=gen, device=DEV)
        sk, sp = state.clone(), state.clone()
        tk, tp = PhotonTallies.zeros(cfg, DEV), PhotonTallies.zeros(cfg, DEV)
        ck = pk.photon_block(eng.plan, sk, quota, tk, seed, b, u)  # kernel
        cp = pk.photon_block_reference(eng.plan, sp, quota, tp, u)  # plain
        torch.cuda.synchronize()
        ok = torch.ones(lanes, dtype=torch.bool, device=DEV)
        for a, c in zip(sk, sp):
            ok &= torch.isclose(a.double(), c.double(), rtol=1e-4, atol=1e-6)
        n_div = int((~ok).sum())
        n_div_all = max(n_div_all, n_div)
        ck, cp = ck.cpu().numpy(), cp.cpu().numpy()
        check(n_div <= 1e-3 * lanes, f"{name} block {b}: {n_div} lanes diverged")
        check((ck[:, 0] == cp[:, 0]).all(), f"{name} block {b}: launched")
        check(abs(ck[:, 2].sum() - cp[:, 2].sum()) <= n_div * k_steps,
              f"{name} block {b}: steps {ck[:, 2].sum()} vs {cp[:, 2].sum()}")
        if not bench:
            check((ck[:, 3] == cp[:, 3]).all(), f"{name} block {b}: quota")
            check(np.allclose(ck[:, 4].sum(), cp[:, 4].sum(), rtol=1e-4),
                  f"{name} block {b}: absorbed")
            for g in GRIDS:
                if ((g == "detector_xy" and cfg.detector_nx == 0)
                        or (g == "absorb_xyz" and cfg.vol_nx == 0)):
                    continue
                a = getattr(tk, g).double()
                c = getattr(tp, g).double()
                err = float((a - c).abs().max())
                scale = float(c.abs().max())
                check(err <= 2e-4 * max(scale, 1e-30),
                      f"{name} block {b}: {g} err {err} vs max {scale}")
                worst = max(worst, err)
        state = sp
        quota = torch.as_tensor(cp[:, 3], dtype=torch.int32, device=DEV)
    return worst, n_div_all


def phase3():
    results = {}
    m_ml, _ = multilayer_mismatch(DEV)
    bench_cfg = PhotonRunConfig(nr=64, nz=64, dr=0.01, dz=0.01)
    m_b = LayeredMedium.build([MediumConfig(mu_a=1.0, mu_s=9.0, g=0.9,
                                            n=1.37)], device=DEV)
    t0 = time.perf_counter()
    results["bench"] = compare_blocks("bench", m_b, bench_cfg, True,
                                      TILE * 64, 32, 0)
    log(3, f"bench mode (2 blocks, {TILE * 64} lanes, k=32): max grid err "
           f"{results['bench'][0]}, diverged lanes {results['bench'][1]}", t0)
    t0 = time.perf_counter()
    flat_cfg = PhotonRunConfig(n_photons=0, nr=64, nz=100, dr=0.01, dz=0.005,
                               detector_nx=64, detector_extent=0.5,
                               vol_nx=16, vol_ny=16, vol_nz=16, vol_dx=0.05,
                               vol_dy=0.05, vol_dz=0.05)
    results["flat"] = compare_blocks("flat", m_ml, flat_cfg, False, TILE * 64,
                                     32, TILE + TILE // 2)
    log(3, f"stride-1 quota mode, multilayer medium (2 blocks, "
           f"{TILE * 64} lanes, k=32): max grid err {results['flat'][0]}, "
           f"diverged lanes {results['flat'][1]}", t0)
    t0 = time.perf_counter()
    # the main path's shapes (phase 6): every lane starts at r = 0, so the
    # first (r,z) bins take the atomics' full contention
    m_fs, fs_cfg = full_scale(DEV)
    results["full_scale"] = compare_blocks("full_scale", m_fs, fs_cfg, False,
                                           MAIN_LANES, 64,
                                           TILE + TILE // 2)
    log(3, f"full_scale config (2 blocks, {MAIN_LANES} lanes, k=64): max "
           f"grid err {results['full_scale'][0]}, diverged lanes "
           f"{results['full_scale'][1]}", t0)
    return max(r[0] for r in results.values())


# --------------------------------------------------------------------------
# phases 4-7
# --------------------------------------------------------------------------

def phase4():
    n = 1_000_000
    t0 = time.perf_counter()
    m = LayeredMedium.build([MediumConfig(mu_a=1.0, mu_s=9.0, g=0.0, n=1.0)],
                            device=DEV)
    cfg = PhotonRunConfig(n_photons=n, nr=50, nz=50, dr=0.002, dz=0.002)
    t = pk.simulate_kernel(m, cfg, seed=1, device=DEV)
    rd = t.total_reflectance()
    check(t.n_launched == n, f"van de Hulst launched {t.n_launched}")
    check(mc_parity_3sigma(rd, 0.41550, binomial_stderr(0.41550, n),
                           abs_floor=1e-3), f"van de Hulst R_d {rd}")
    log(4, f"van de Hulst 1e6: R_d {rd:.5f} (0.41550), launched "
           f"{t.n_launched}, energy {t.energy_total():.6f}", t0)
    t0 = time.perf_counter()
    m = LayeredMedium.build([MediumConfig(mu_a=10.0, mu_s=90.0, g=0.75, n=1.0,
                                          thickness=0.02)], device=DEV)
    t = pk.simulate_kernel(m, cfg, seed=2, device=DEV)
    r, tt = t.total_reflectance(), t.total_transmittance()
    check(t.n_launched == n, f"MCML slab launched {t.n_launched}")
    check(mc_parity_3sigma(r, 0.09739, binomial_stderr(0.09739, n),
                           abs_floor=1e-3), f"MCML slab R {r}")
    check(mc_parity_3sigma(tt, 0.66096, binomial_stderr(0.66096, n),
                           abs_floor=2e-3), f"MCML slab T {tt}")
    log(4, f"MCML slab 1e6: R {r:.5f} (0.09739), T {tt:.5f} (0.66096), "
           f"launched {t.n_launched}", t0)


def phase5():
    n = 200_000
    t0 = time.perf_counter()
    m = LayeredMedium.build([MediumConfig(mu_a=1.0, mu_s=9.0, g=0.7, n=1.37)],
                            n_above=1.0, device=DEV)
    cfg = PhotonRunConfig(n_photons=n, nr=32, nz=32, dr=0.02, dz=0.02)
    t_k = pk.simulate_kernel(m, cfg, seed=11, device=DEV)
    t_x = lt.simulate(m, cfg, seed=12, device=DEV)
    a = t_k.absorb_rz.double().cpu().numpy().reshape(8, 4, 8, 4).sum((1, 3))
    b = t_x.absorb_rz.double().cpu().numpy().reshape(8, 4, 8, 4).sum((1, 3))
    chi2, dof = chi2_counts(a.reshape(-1), b.reshape(-1), min_expected=50.0)
    se = binomial_stderr(t_x.total_reflectance(), n) * math.sqrt(2.0)
    r_ok = mc_parity_3sigma(t_k.total_reflectance(), t_x.total_reflectance(),
                            se, abs_floor=1e-3)
    log(5, f"kernel vs superstep 2e5: chi2/dof {chi2 / max(dof, 1):.3f} "
           f"(dof {dof}), R_d {t_k.total_reflectance():.5f} vs "
           f"{t_x.total_reflectance():.5f}, launched {t_k.n_launched} / "
           f"{t_x.n_launched}", t0)
    check(chi2 / max(dof, 1) < 1.5, f"chi2/dof {chi2 / max(dof, 1)}")
    check(r_ok, "R_d parity")
    check(t_k.n_launched == n and t_x.n_launched == n, "launch counts")


def phase6():
    m, cfg = full_scale(DEV)
    n = 10_000_000
    cfg = dataclasses.replace(cfg, n_photons=n)
    timings = {}
    pk.LAUNCHES = 0
    t0 = time.perf_counter()
    t = pk.simulate_kernel(m, cfg, seed=0, lanes=MAIN_LANES, timings=timings,
                           device=DEV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = pk.LAUNCHES
    rd = t.total_reflectance()
    se = math.sqrt(binomial_stderr(FULL_SCALE_RD, n) ** 2
                   + binomial_stderr(FULL_SCALE_RD, FULL_SCALE_N) ** 2)
    vol = float(t.absorb_xyz.double().sum())
    finite = all(bool(torch.isfinite(getattr(t, f)).all())
                 for f in GRIDS + ("specular", "absorbed"))
    log(6, f"full_scale 1e7: launched {t.n_launched}, energy "
           f"{t.energy_total():.8f}, R_d {rd:.6f} (TPU 1e8 {FULL_SCALE_RD}, "
           f"3 sigma {3 * se:.6f}), A {t.total_absorption():.6f}, "
           f"vol/absorbed {vol / float(t.absorbed):.5f}, finite {finite}")
    rz = t.absorb_rz.double()
    vol3 = t.absorb_xyz.double()
    c = vol3.shape[0] // 2
    log(6, f"deposit concentration: (r,z) column r < dr holds "
           f"{float(rz[0].sum() / rz.sum()):.4f} of the grid's weight, its "
           f"hottest bin {float(rz.max() / rz.sum()):.5f}; the volume's 2x2 "
           f"axial columns hold "
           f"{float(vol3[c - 1:c + 1, c - 1:c + 1].sum() / vol3.sum()):.4f}")
    log(6, f"steady {timings['steady_steps_per_sec']:.4e} steps/s, "
           f"{timings['ms_per_block']:.3f} ms/block, occupancy "
           f"{timings['steady_occupancy']:.4f}, steady blocks "
           f"{timings['steady_blocks']}, first chunk "
           f"{timings['compile_plus_first_chunk_s']:.2f} s, wall {wall:.2f} s, "
           f"kernel launches {launches}")
    check(t.n_launched == n, f"launched {t.n_launched}")
    check(abs(t.energy_total() - 1.0) < 1e-4, f"energy {t.energy_total()}")
    check(mc_parity_3sigma(rd, FULL_SCALE_RD, se), f"R_d {rd}")
    check(abs(vol / float(t.absorbed) - 1.0) < 0.01, "volume vs absorbed")
    check(finite, "non-finite tally")
    check(launches > 0, "the main path launched no kernel")
    return launches, timings


def phase7():
    m_b = LayeredMedium.build([MediumConfig(mu_a=1.0, mu_s=9.0, g=0.9,
                                            n=1.37)], device=DEV)
    cfg_b = PhotonRunConfig(nr=64, nz=64, dr=0.01, dz=0.01)
    lanes, k, blocks = 1 << 20, 64, 40
    pk.bench_kernel(m_b, cfg_b, 0, lanes, 2, k, device=DEV)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    t = pk.bench_kernel(m_b, cfg_b, 1, lanes, blocks, k, device=DEV)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    check(t.n_steps == lanes * k * blocks, f"bench steps {t.n_steps}")
    log(7, f"bench_kernel: {t.n_steps / dt:.4e} steps/s ({lanes} lanes, "
           f"k={k}, {blocks} blocks, {dt:.3f} s)")
    # the same on full_scale's medium: bench mode keeps no tallies, so the
    # gap to phase 6's steady rate is the tallies' and the ranking's cost
    m_fs, cfg_fs = full_scale(DEV)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    t = pk.bench_kernel(m_fs, cfg_fs, 2, lanes, blocks, k, device=DEV)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    log(7, f"bench_kernel on full_scale's medium: {t.n_steps / dt:.4e} "
           f"steps/s ({dt:.3f} s)")

    # kernel against plain time per block at the main path's shapes
    m, cfg = full_scale(DEV)
    lanes = MAIN_LANES
    eng = pk.PhotonKernelEngine(m, cfg, lanes, bench_mode=False,
                                k_steps=pk.K_STEPS, device=DEV)
    tallies = PhotonTallies.zeros(cfg, DEV)
    quota = torch.full((eng.n_tiles,), 1 << 30, dtype=torch.int32, device=DEV)
    state = eng.zero_state()
    gen = torch.Generator(device=DEV)
    gen.manual_seed(3)
    u = torch.rand((eng.plan.n_draws, lanes), generator=gen, device=DEV)
    pk.photon_block(eng.plan, state, quota, tallies, 5, 0)  # fill the lanes
    ms_k = cuda_ms(lambda: pk.photon_block(eng.plan, state, quota, tallies,
                                           5, 1), 10)
    ms_ku = cuda_ms(lambda: pk.photon_block(eng.plan, state, quota, tallies,
                                            5, 1, u), 10)
    ms_p = cuda_ms(lambda: pk.photon_block_reference(eng.plan, state, quota,
                                                     tallies, u), 2)
    ms_k2 = cuda_ms(lambda: pk.photon_block(eng.plan, state, quota, tallies,
                                            5, 1), 10)
    log(7, f"full_scale block ({lanes} lanes, k={eng.k_steps}): kernel "
           f"{ms_k:.3f} / {ms_k2:.3f} ms (Philox), {ms_ku:.3f} ms (uniforms "
           f"read), plain {ms_p:.3f} ms")
    # the bound of one such block: its live steps' operations, or its bytes
    # (state read and written, quota, counters, every tally grid read and
    # written once)
    steps = float(pk.photon_block(eng.plan, state, quota, tallies, 5, 1)[
        :, 2].sum())
    grids = sum(getattr(tallies, g).numel() * getattr(tallies, g)
                .element_size() for g in GRIDS)
    nbytes = 2 * 36 * lanes + 4 * eng.n_tiles + 40 * eng.n_tiles + 2 * grids
    bound = bound_ms(steps * PHOTON_OPS_PER_STEP, nbytes)
    log(7, f"bound: {steps:.0f} live steps x {PHOTON_OPS_PER_STEP} ops, "
           f"{nbytes / 1e6:.1f} MB: {bound[0]:.4f} ms ({bound[1]})")
    return min(ms_k, ms_k2), ms_p, bound


# --------------------------------------------------------------------------
# phases 8-10: the render slice
# --------------------------------------------------------------------------

def bound_ms(ops, nbytes):
    """(least time in ms, what bounds it) for ``ops`` FP32 operations and
    ``nbytes`` moved at the card's published peaks."""
    t_ops, t_bytes = ops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def time_once(fn):
    """Device time of one call of ``fn()`` by CUDA events (no warm-up: the
    plain versions compile nothing)."""
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b)


KERNELS = {  # wrapper -> (plain version, index of its pair-count operand)
    "intersect_dense": (ik.intersect_dense_reference, 3),
    "intersect_gather": (ik.intersect_gather_reference, 4),
}


@contextlib.contextmanager
def plain_intersector():
    """Both intersector wrappers replaced by their plain versions (the
    dispatch reaches them through the module's globals).  Fails if a
    kernel launched meanwhile: a dispatch that bound the wrappers
    elsewhere would otherwise compare the kernel with itself."""
    saved = {name: getattr(ik, name) for name in KERNELS}
    before = dict(ik.LAUNCHES)
    try:
        for name, (ref, _) in KERNELS.items():
            setattr(ik, name, lambda *a, _ref=ref: _ref(*a[:-1]))
        yield
    finally:
        for name, fn in saved.items():
            setattr(ik, name, fn)
    check(ik.LAUNCHES == before,
          f"the plain intersector launched kernels: {before} -> "
          f"{ik.LAUNCHES}")


def launch_counted(name, fn, args):
    """``fn(*args)``, failing unless it launched ``name``'s kernel once."""
    before = ik.LAUNCHES[name]
    out = fn(*args)
    check(ik.LAUNCHES[name] == before + (args[0].shape[0] > 0),
          f"{name}: the call launched no kernel")
    return out


def compare_launch(label, args, got, want):
    """One launch's (best_t, best_tri) from the kernel against its plain
    version on the same operands, to phase 8's limits; returns the
    largest |t| difference where both hit (0 for an any-hit launch, whose
    t and triangle are whichever hit the kernel found first)."""
    any_hit = bool(args[-1])
    (tk, ck), (tp, cp) = got, want
    vk, vp = ck >= 0, cp >= 0
    if not any_hit:
        vk, vp = vk & (tk < ik.BIG), vp & (tp < ik.BIG)
    n = tk.shape[0]
    n_bad = int((vk != vp).sum())
    both = vk & vp
    dt = (tk[both] - tp[both]).abs()
    rel = float((dt / tp[both].abs()).max()) if dt.numel() else 0.0
    same = float((ck[both] == cp[both]).float().mean()) if dt.numel() else 1.0
    err = float(dt.max()) if dt.numel() and not any_hit else 0.0
    log(10, f"{label}: {n} rays, hit {float(vp.float().mean()):.4f}; "
            f"mismatches {n_bad}" + ("" if any_hit else
            f", max |dt| {err:.3e} (rel {rel:.3e}), same triangle "
            f"{same:.6f}"))
    check(n_bad <= 1e-3 * n, f"{label}: {n_bad} hit mismatches")
    if not any_hit:
        check(rel <= 1e-5, f"{label}: t differs by rel {rel}")
        check(same >= 0.999, f"{label}: same triangle on {same}")
    return err


class Recorder:
    """Wraps an intersector wrapper while installed: CUDA events around
    each launch, the admitted (tile, cluster) pairs of each, and the
    operands of each, for holding the kernel against its plain version on
    the heaviest launches.  Fails if a call it sees launches no kernel."""

    def __init__(self, name):
        self.name = name
        self.events, self.pairs, self.launched = [], [], []

    def __call__(self, *args):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = launch_counted(self.name, self.wrapped, args)
        b.record()
        self.events.append((a, b))
        self.pairs.append(args[KERNELS[self.name][1]].sum())
        self.launched.append((self.pairs[-1], args))
        return out

    def __enter__(self):
        self.wrapped = getattr(ik, self.name)
        setattr(ik, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(ik, self.name, self.wrapped)

    def summary(self):
        torch.cuda.synchronize()
        ms = [a.elapsed_time(b) for a, b in self.events]
        pairs = [int(p) for p in self.pairs]
        return len(ms), sum(ms) / max(len(ms), 1), pairs

    def kernel_and_plain(self):
        """The nearest-hit and the any-hit launch that admitted the most
        pairs, each through the kernel and through its plain version on
        the same operands, held to phase 8's limits.  Returns the kernel's
        ms (mean of 5 after a warm launch), the plain version's ms (one
        call), the bound, the admitted pairs and the largest |t|
        difference of the nearest-hit one."""
        plain = KERNELS[self.name][0]
        held = {}
        for any_hit in (False, True):
            runs = [pa for pa in self.launched if bool(pa[1][-1]) == any_hit]
            if not runs:
                continue
            args = max(runs, key=lambda pa: int(pa[0]))[1]
            got = launch_counted(self.name, self.wrapped, args)
            want = []
            ms_p = time_once(lambda: want.append(plain(*args[:-1])))
            mode = "any-hit" if any_hit else "nearest"
            err = compare_launch(
                f"{self.name}, heaviest {mode} launch of the run "
                f"({int(args[KERNELS[self.name][1]].sum())} pairs)", args,
                got, want[0])
            held[any_hit] = (args, ms_p, err)
        args, ms_p, err = held[False]
        ms = cuda_ms(lambda: self.wrapped(*args), 5)
        feats, w_c = args[0], args[2]
        pairs = int(args[KERNELS[self.name][1]].sum())
        lists = sum(x.numel() * x.element_size() for x in args[3:-1])
        nbytes = (feats.numel() * 4 + args[1].numel() * 4
                  + w_c.numel() * 4 + lists + feats.shape[0] * 8)
        return ms, ms_p, bound_ms(
            pairs * ik.RAY_TILE * ik.TRI_TILE * PAIR_OPS, nbytes), pairs, err


def compare_hits(label, scene, o, d, active, max_dist):
    """Nearest and any-hit queries of one ray batch through the kernels and
    through the plain versions; returns the largest |t| difference where
    both hit."""
    from light_transport_tpu_torch.ops.dispatch import (
        scene_intersect,
        scene_occluded,
    )

    n = o.shape[0]
    recs = [Recorder(name) for name in KERNELS]
    with recs[0], recs[1]:
        hk = scene_intersect(scene, o, d, active=active)
        ok = scene_occluded(scene, o, d, max_dist, active=active)
    with plain_intersector():
        hp = scene_intersect(scene, o, d, active=active)
        op = scene_occluded(scene, o, d, max_dist, active=active)
    torch.cuda.synchronize()
    n_valid = int((hk.valid != hp.valid).sum())
    n_occ = int((ok != op).sum())
    both = hk.valid & hp.valid
    dt = (hk.t[both] - hp.t[both]).abs()
    rel = float((dt / hp.t[both].abs()).max()) if int(both.sum()) else 0.0
    same_tri = float((hk.tri[both] == hp.tri[both]).float().mean()) \
        if int(both.sum()) else 1.0
    check(any(r.events for r in recs), f"{label}: no kernel launched")
    pairs = {r.name: r.summary()[2] for r in recs if r.events}
    log(8, f"{label}: {n} rays ({int(active.sum())} active), hit "
           f"{float(hp.valid.float().mean()):.4f}, occluded "
           f"{float(op.float().mean()):.4f}; valid mismatches {n_valid}, "
           f"any-hit mismatches {n_occ}, max rel dt {rel:.3e}, same "
           f"triangle {same_tri:.6f}; admitted (tile, cluster) pairs per "
           f"launch {pairs}")
    check(n_valid <= 1e-3 * n, f"{label}: {n_valid} valid mismatches")
    check(n_occ <= 1e-3 * n, f"{label}: {n_occ} any-hit mismatches")
    check(rel <= 1e-5, f"{label}: t differs by rel {rel}")
    check(same_tri >= 0.999, f"{label}: same triangle on {same_tri}")
    check(not bool(hk.valid[~active].any()), f"{label}: inactive lane hit")
    return float(dt.max()) if dt.numel() else 0.0


def soft_shadow_scene():
    """examples/soft_shadow.py's scene from the port's modules: a
    123,200-triangle turquoise sphere on a floor under a 3x3 area light."""
    sph = sphere_triangles(center=(0, 1, 0), radius=1.5, n_theta=176,
                           n_phi=352)
    floor = quad_triangles((-8, -0.5, -8), (-8, -0.5, 8), (8, -0.5, 8),
                           (8, -0.5, -8))
    lq = quad_triangles((-1.5, 6, -1.5), (1.5, 6, -1.5), (1.5, 6, 1.5),
                        (-1.5, 6, 1.5))
    mesh = concat_meshes([
        TriangleMesh.build(sph, np.zeros(len(sph), np.int32), device=DEV),
        TriangleMesh.build(floor, np.asarray([1, 1], np.int32), device=DEV),
        TriangleMesh.build(lq, np.asarray([2, 2], np.int32),
                           np.asarray([True, True]), device=DEV),
    ])
    mats = MaterialTable.build([
        Material(color=presets.TURQUOISE),
        Material(color=presets.WHITE_2),
        Material(color=presets.WHITE, emission=8.0),
    ], device=DEV)
    return Scene.build(mesh, mats, camera=[0.0, 1.0, 7.0]).with_bvh()


def generator(seed):
    gen = torch.Generator(device=DEV)
    gen.manual_seed(seed)
    return gen


def phase8(glass, soft):
    """Kernels against plain on real ray batches."""
    err = {}
    scene, cfg = glass
    t0 = time.perf_counter()
    o, d, u = pt._camera_lanes(scene, cfg, generator(1))
    active = torch.ones(o.shape[0], dtype=torch.bool, device=DEV)
    active[::11] = False
    e1 = compare_hits("glass camera rays (K3)", scene, o, d, active, 20.0)
    state, _ = pt._bounce(scene, cfg, pt.PathState.initial(o, d), u[:, 0], 0)
    md = torch.rand(o.shape[0], generator=generator(2), device=DEV) * 15.0
    e2 = compare_hits("glass bounce-1 rays (K3)", scene, state.origin,
                      state.direction, state.alive, md)
    err["intersect_dense"] = max(e1, e2)
    log(8, "K3 done", t0)
    t0 = time.perf_counter()
    scene = soft
    n = 16384
    cam_cfg = dataclasses.replace(SOFT_SHADOW_CFG, width=128, height=128,
                                  spp=1)
    o, d, _ = pt._camera_lanes(scene, cam_cfg, generator(3))
    active = torch.ones(n, dtype=torch.bool, device=DEV)
    active[::9] = False
    e1 = compare_hits("soft-shadow camera rays (K4)", scene, o, d, active,
                      8.0)
    g = generator(4)
    lo = torch.tensor([-2.0, -0.5, -2.0], device=DEV)
    hi = torch.tensor([2.0, 3.0, 2.0], device=DEV)
    o = lo + (hi - lo) * torch.rand((n, 3), generator=g, device=DEV)
    d = torch.nn.functional.normalize(
        torch.randn((n, 3), generator=g, device=DEV), dim=-1)
    md = 0.5 + 7.5 * torch.rand(n, generator=g, device=DEV)
    e2 = compare_hits("soft-shadow interior rays (K4)", scene, o, d, active,
                      md)
    err["intersect_gather"] = max(e1, e2)
    log(8, f"K4 done; largest |t| difference per kernel {err}", t0)


def phase9(glass):
    """The glass preset through K3 and through the plain intersector."""
    scene, cfg = glass
    t0 = time.perf_counter()
    for name in ik.LAUNCHES:
        ik.LAUNCHES[name] = 0
    with Recorder("intersect_dense") as rec:
        img = pt.render_image(scene, cfg, seed=5)
        torch.cuda.synchronize()
    launches = dict(ik.LAUNCHES)
    wall = time.perf_counter() - t0
    with plain_intersector():
        img_p = pt.render_image(scene, cfg, seed=5)
    diff = float((img - img_p).abs().mean())
    n, ms, pairs = rec.summary()
    log(9, f"glass {cfg.width}x{cfg.height}x{cfg.spp} depth {cfg.max_depth}"
           f" ({scene.mesh.num_triangles} triangles): mean |K3 - plain| "
           f"{diff:.3e}, image mean {float(img.mean()):.5f}, K3 launches "
           f"{launches['intersect_dense']} at {ms:.3f} ms each, admitted "
           f"pairs per launch {pairs}, K4 launches "
           f"{launches['intersect_gather']}, render wall {wall:.2f} s", t0)
    check(bool(torch.isfinite(img).all()), "glass image not finite")
    check(float(img.min()) >= 0.0 and float(img.max()) <= 1.0,
          "glass image outside [0, 1]")
    check(diff < 2e-3, f"glass K3 vs plain image diff {diff}")
    check(launches["intersect_dense"] > 0, "the glass render launched no K3")
    return launches["intersect_dense"], rec


def phase10(scene):
    """The soft-shadow scene at 400x400, 10 spp, depth 3 through K4."""
    cfg = SOFT_SHADOW_CFG
    n_lanes = cfg.width * cfg.height * cfg.spp
    n_clusters = -(-scene.mesh.num_triangles // ik.TRI_TILE)
    for name in ik.LAUNCHES:
        ik.LAUNCHES[name] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img, samples = pt.render_image(scene, cfg, seed=0, return_samples=True)
    torch.cuda.synchronize()
    wall1 = time.perf_counter() - t0
    launches = dict(ik.LAUNCHES)
    t0 = time.perf_counter()
    with Recorder("intersect_gather") as rec:
        img2 = lt.render(scene, cfg, seed=0)
        torch.cuda.synchronize()
    wall2 = time.perf_counter() - t0
    n, ms, pairs = rec.summary()
    log(10, f"soft shadow {cfg.width}x{cfg.height}x{cfg.spp} depth "
            f"{cfg.max_depth} ({scene.mesh.num_triangles} triangles, "
            f"{n_lanes} lanes): first render {wall1:.3f} s, second "
            f"{wall2:.3f} s; K4 launches {launches['intersect_gather']} "
            f"(K3 {launches['intersect_dense']}), {ms:.3f} ms per launch by "
            f"CUDA events, admitted (tile, cluster) pairs per launch {pairs}"
            f" of {(n_lanes // ik.RAY_TILE) * n_clusters}")
    # re-trace every 97th lane through the plain intersector
    t0 = time.perf_counter()
    o, d, u = pt._camera_lanes(scene, cfg, pt._generator(scene, 0))
    lanes = torch.arange(0, n_lanes, 97, device=DEV)
    with plain_intersector():
        rad_p, _ = pt.trace_paths(scene, cfg, o[lanes], d[lanes], u[lanes])
    # lane (s, i, j) of the render is samples[i, j, s]
    rad_k = samples.permute(2, 0, 1, 3).reshape(-1, 3)[lanes]
    close = torch.isclose(rad_k, rad_p, rtol=1e-3, atol=1e-6).all(dim=1)
    frac = float(close.float().mean())
    mean = float(img.mean())
    log(10, f"plain re-trace of {lanes.shape[0]} lanes: {frac:.5f} within "
            f"rtol 1e-3; image mean {mean:.5f}, two renders equal "
            f"{bool(torch.equal(img, img2))}", t0)
    check(bool(torch.isfinite(img).all()), "soft-shadow image not finite")
    check(mean > 0.0, "soft-shadow image is black")
    check(frac >= 0.99, f"plain re-trace: {frac} of lanes agree")
    check(launches["intersect_gather"] > 0, "the render launched no K4")
    profile_render(scene, cfg, wall2)
    return launches["intersect_gather"], rec, (wall1, wall2)


def profile_render(scene, cfg, wall):
    """Where a render's device time goes: one more render under
    torch.profiler, device time by kernel, and the device's busy share of
    the unprofiled render's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        lt.render(scene, cfg, seed=0)
        torch.cuda.synchronize()
    # the device's own kernel records (the aten ops above them repeat
    # their children's device time)
    by_kernel = sorted(((e.self_device_time_total, e.count, e.key)
                        for e in prof.key_averages()
                        if e.device_type == DeviceType.CUDA
                        and e.self_device_time_total > 0), reverse=True)
    busy = sum(t for t, _, _ in by_kernel) / 1e3  # ms
    log(10, f"profiled render: device busy {busy:.1f} ms = "
            f"{busy / (wall * 1e3):.3f} of the unprofiled render's wall "
            f"{wall * 1e3:.1f} ms; {len(by_kernel)} kernels, the top ten:")
    for t, count, key in by_kernel[:10]:
        print(f"    {t / 1e3:9.3f} ms {t / 1e3 / busy:6.3f} x{count:<5d} "
              f"{key[:90]}", flush=True)
    check(busy > 0, "the profiler saw no device time")


def kernel_entry(name, source, replaces, launches, err, ms, plain_ms, bound,
                 library_ms=None):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0],
            "bound_by": bound[1], "library_ms": library_ms}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    card = smi()
    log(1, f"{card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
           f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    names = ["photon_kernel", "intersect_kernel"]
    with ThreadPoolExecutor(len(names)) as pool:  # one nvcc per source
        libs = list(pool.map(_build.build, names))
    log(2, f"built {', '.join(p.name for p in libs)}", t0)
    for lib in libs:
        report = Path(str(lib) + ".log")
        if report.exists():
            print(report.read_text().strip(), flush=True)
    max_err = phase3()
    phase4()
    phase5()
    launches, _ = phase6()
    ms, plain_ms, bound = phase7()
    t0 = time.perf_counter()
    glass = glass_scene(device=DEV)
    soft = soft_shadow_scene()
    log(8, f"scenes built: glass {glass[0].mesh.num_triangles} triangles, "
           f"soft shadow {soft.mesh.num_triangles}", t0)
    phase8(glass, soft)
    k3_launches, k3 = phase9(glass)
    k4_launches, k4, _ = phase10(soft)
    entries = [kernel_entry(
        "photon_block", "light_transport_tpu_torch/csrc/photon_kernel.cu",
        "light_transport_tpu/ops/pallas/photon_kernel.py:204", launches,
        max_err, ms, plain_ms, bound)]
    for rec, launched, replaces in (
            (k3, k3_launches,
             "light_transport_tpu/ops/pallas/intersect_kernel.py:67"),
            (k4, k4_launches,
             "light_transport_tpu/ops/pallas/intersect_kernel.py:129")):
        ms, plain_ms, bound, pairs, err = rec.kernel_and_plain()
        log(10, f"{rec.name} on its heaviest nearest-hit launch ({pairs} "
                f"pairs): kernel {ms:.3f} ms, plain "
                f"{plain_ms:.3f} ms, bound {bound[0]:.4f} ms ({bound[1]})")
        entries.append(kernel_entry(
            rec.name, "light_transport_tpu_torch/csrc/intersect_kernel.cu",
            replaces, launched, err, ms, plain_ms, bound))
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

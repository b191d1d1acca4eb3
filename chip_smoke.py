#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's photon and render paths and its feature
probes on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases (each prints its result and time; any failure raises, and the
script exits non-zero without the final result line):

  1. the card (nvidia-smi name and power limit) and the torch/CUDA versions
  2. build every kernel from light_transport_tpu_torch/csrc/ (one nvcc per
     source, all started together) and print ptxas's reports
  3. photon kernel against its plain PyTorch version on the same uniforms:
     bench mode, stride-1 quota mode, and full_scale's configuration at
     the main path's shapes (2^19 lanes, k=64); then the kernel with its
     in-kernel Philox against the kernel fed philox_uniforms at those
     shapes, full_scale and bench mode (state and counters bitwise)
  4. physics through the Philox kernel: van de Hulst and the MCML slab
  5. engine parity: simulate_kernel against api.simulate (the superstep
     engine), chi-squared on the coarse-binned (r,z) grid
  6. photon main path: the full_scale preset at its full widths, 1e7
     photons
  7. bench mode: bench_kernel throughput; the full_scale block at the
     main path's shapes timed with in-kernel Philox, with its uniforms
     read and through the plain version; the split against a bench-mode
     block on the same medium and the share of warp-steps with a
     phase-matched lane; K1's registers, stack and spills (ptxas), its
     resident blocks per SM and waves; its bound, term by term
  8. the intersector kernels K3 (dense), the cull kernel and K4 (gather)
     against their plain versions, nearest and any hit, on real ray
     batches, every launch held bitwise: camera and bounce-1 rays of the
     glass preset and camera and interior rays of the 15-cluster
     soft-shadow layout (7,572 triangles; K3), camera and interior rays of
     the soft-shadow scene (the cull and K4), inactive lanes in all
  9. the glass preset at its preset size (100x100, 4 spp, depth 3): a
     fresh scene's first and second render (host clock) and the device's
     busy share under the profiler, then a render through K3 (each launch
     timed and held bitwise) against the plain intersector from the same
     uniforms; K3's query split (each part under the profiler and by CUDA
     events, the launches a query) on the glass and 15-cluster batches;
     K3's pieces per block swept on the heaviest launches
 10. render main path: the soft-shadow scene (123,204 triangles, 241
     clusters) at 400x400, 10 spp, depth 3 through the cull kernel and K4,
     their heaviest launches held bitwise against the plain versions, K4's
     chunk size swept on its heaviest launches, a subset of the render's
     lanes re-traced through the plain intersector, and a profile
 11. the big-mesh scene of scripts/bench_treelet_render.py (a
     4,202,100-triangle sphere in the Cornell box, 4,202,118 triangles)
     built from the port's modules, each build step timed (the 32-byte
     node records of K5 among them); the treelet kernels K5 and K5r
     against the plain roped walk on its camera, bounce-1 and shadow rays
     (every 9th lane inactive), nearest and any hit, through the
     single-launch, sorted single-launch (the dispatch's route:
     ops/raysort.sorted_apply around one K5 launch), wavefront and queued
     drivers (each timed by the host clock); per K5 launch of the sorted
     driver its node visits, the share of them whose next node is the
     adjacent record and its largest per-ray visits; K5/K5r's block and
     resident blocks per SM, and per K5r launch of the wavefront its node
     visits, the share of them read from shared memory and the treelets
     staged per block; one wavefront query under torch's sync debug mode
     "error" (no host sync between its passes) and the queued driver's
     syncs counted; the dispatch of that scene without treelet tables
     (one K5 launch per query) and without a BVH (refused on the card)
 12. big-mesh render main path: that scene at 256x256, 2 spp, depth 3
     through the dispatch's default route (every query one sorted K5
     launch, or the camera rays through K5 and the bounce and shadow
     rays through the K5r wavefront), its launches counted from 0; then
     both routes rendered in turns (wavefront, single, single,
     wavefront), each turn's image bitwise the main path's, with its
     second-call wall, host syncs, device busy, launches and device time
     by kernel; the heaviest K5 launch (single route) and K5r launch
     (wavefront route, from the lane state it started from) re-run
     through the plain walk, K5's lone slowest ray timed; a subset of
     the main path's lanes re-traced through the plain walk, and a
     profile
 13. the feature probes P1-P10 (csrc/probe_kernels.cu): the entry point
     of ops/feature_probes.py runs each in a subprocess of its own (its
     launches counted from 0 there), then each kernel here against its
     plain version on the reference probe's inputs, timed by CUDA events
     (100 calls back to back) and under the profiler (device time a call)
     beside an empty kernel launched the same way, the plain version and,
     where one exists, a single PyTorch call of the same function; P8
     also on a seeded random table, within a stated tolerance, and timed
     beside the cast to bf16 and the matmul together; P9's device time
     beside repeat's and an empty kernel's, the floor no launch beats
 14. the photon leftovers: phase 6's main path killed at 64 blocks with a
     snapshot every 2nd chunk (utils/checkpoint, in a temporary directory
     the phase removes) and resumed to the end, its counters bitwise and
     its grids within 2^-16 of each bin of phase 6's (float atomics add in
     the card's order; an unbroken rerun is logged beside it); the
     snapshot's bytes and ms a save (device -> host copy, then write);
     steady steps/s with a snapshot every 16th chunk and without, in
     turns; simulate_resumable at 1e6 photons in 10 batches broken after
     4 and resumed, bitwise the unbroken run; the 18 hg_sweep
     configurations through simulate_kernel at 1e5 photons (exact
     launches, energy within 1e-4, the albedo-0.9 g = 0 cell against van
     de Hulst's 0.41550, the six g = 0 cells against the superstep engine
     within their combined 3 sigma); a superstep of the superstep engine
     at the sweep's lanes (host time, device time, launches); the phase's
     wall time

The line before the last is the card's name and power limit; the last
line is {"ok": true, "device": {...}}.
"""

import contextlib
import ctypes
import dataclasses
import functools
from concurrent.futures import ThreadPoolExecutor
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
import warnings
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
    hg_sweep,
    multilayer_mismatch,
)
from light_transport_tpu_torch.accel import bvh as bvh_mod
from light_transport_tpu_torch.ops import _build
from light_transport_tpu_torch.ops import dispatch
from light_transport_tpu_torch.ops import feature_probes as fp
from light_transport_tpu_torch.ops import intersect_kernel as ik
from light_transport_tpu_torch.ops import photon_kernel as pk
from light_transport_tpu_torch.ops import raysort
from light_transport_tpu_torch.ops import treelet_kernel as tk
from light_transport_tpu_torch.scene.cornell import (
    cornell_box_scene,
    sphere_triangles,
)
from light_transport_tpu_torch.scene.geometry import (
    TriangleMesh,
    concat_meshes,
    quad_triangles,
    uv_sphere_triangles,
)
from light_transport_tpu_torch.scene.lights import sample_light_points
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
from light_transport_tpu_torch.transport.photon import (
    run_fixed_steps,
    simulate_photons,
)
from light_transport_tpu_torch.utils import checkpoint as ckpt

DEV = torch.device("cuda", 0)
TILE = pk.TILE_LANES
# full_scale's recorded physics (1e8 photons, artifacts/full_scale_run.json)
FULL_SCALE_RD = 0.26239074
FULL_SCALE_N = 100_000_000
MAIN_LANES = 1 << 19  # the main path's lanes (phases 3, 6, 7 and 14)
MAIN_N = 10_000_000  # the main path's photons (phases 6 and 14)
GRIDS = ("absorb_rz", "detector_xy", "absorb_xyz", "refl_r", "trans_r")
# NVIDIA's H100 SXM data sheet: FP32 on the CUDA cores (an FMA counted as
# two operations), HBM3 bandwidth
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
PEAK_BF16 = 989e12  # dense, on the tensor cores
# K1's bound per live photon step, counted from csrc/photon_kernel.cu's
# scatter step (the costlier of its two branches) for every live step.
# FP32: 73 adds, multiplies, compares, min/max and selects of its own, and
# the accurate library calls as their usual sequences count, an FMA as
# two: log1pf ~30, cosf (|phi| < 2 pi) ~28, three divides ~10 and two
# sqrtf ~8 each -> 177, at the published 67e12/s.  Philox: 5 words, 1.25
# groups of 10 rounds of two 32x32 products, each a high and a low
# multiply -> 50 multiplies, at 64 per SM-clock.  SFU: a reciprocal for
# each divide, a reciprocal square root for each sqrtf -> 5, at 16 per
# SM-clock.  The term that takes longest bounds the block.
K1_FP32_PER_STEP = 177
K1_IMUL_PER_STEP = 50
K1_SFU_PER_STEP = 5
# the bound before this count: 260 operations per live step (two Philox
# groups and ~130 FP32), all at the FP32 rate; kept to read the gap both ways
K1_OLD_OPS_PER_STEP = 260
# NVIDIA's H100 SXM: 132 SMs at a 1.98 GHz boost clock; per SM-clock 64
# 32-bit integer multiplies and 16 SFU results (the CUDA programming guide's
# throughput table for compute capability 9.0)
H100_SMS = 132
H100_CLOCK = 1.98e9
PEAK_IMUL = 64 * H100_SMS * H100_CLOCK
PEAK_SFU = 16 * H100_SMS * H100_CLOCK
# one FP32 instruction per lane per clock, 128 lanes an SM (33.4e12/s): the
# peak for counts that take every add, multiply, min/max and compare as one
# operation.  Every kernel builds with -fmad=false, so none of those is an
# FMA, and the data sheet's PEAK_FP32 counts an FMA as two
PEAK_FP32_ISSUE = 128 * H100_SMS * H100_CLOCK
# operations per ray-triangle pair of the intersector: 22 multiplies, 16
# adds, one divide and six compares (csrc/intersect_kernel.cu)
PAIR_OPS = 45
# operations per (ray, cluster box) slab test of the cull: 6 subtracts, 6
# multiplies, 10 min/max and 3 compares (csrc/intersect_kernel.cu)
CULL_OPS = 25
SOFT_SHADOW_CFG = RenderConfig(width=400, height=400, spp=10, max_depth=3,
                               f_distance=3.5)
# operations of the treelet walk, counted from csrc/treelet_kernel.cu: a
# node visit's slab test (6 subtracts, 6 multiplies, 12 min/max, 4
# compares) and a triangle test's Moller-Trumbore (27 multiplies, 18 adds
# and subtracts, a divide, 8 compares and an abs)
NODE_OPS = 28
TRI_OPS = 55
# bytes the treelet walk must move: what it reads of a node record (K5
# one 32-byte record, accel/bvh.node_records32; K5r 48 of a 64-byte fused
# record), the 36 of a triangle it tests, and per ray its feature rows and
# outputs (K5: 11 floats in, best_t, best_tri and visits out; K5r: 10
# floats and the cursor, best_t and best_tri in, those three and visits
# out)
NODE_BYTES = {"treelet_walk": 32, "treelet_resume": 48}
TRI_BYTES = 36
RAY_BYTES = {"treelet_walk": 44 + 12, "treelet_resume": 52 + 16}
# what a K5 visit read from the fused records before the 32-byte ones
FUSED_NODE_BYTES = 48


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


def compare_stream(name, medium, cfg, bench, lanes, k_steps, quota_per_tile,
                   seed=9):
    """Two blocks of the kernel with its in-kernel Philox against the
    kernel fed ``philox_uniforms`` of the same seed and block: state and
    counters bitwise, grids within 2e-4 x max (the atomics' order is
    free).  Returns the max grid error."""
    eng = pk.PhotonKernelEngine(medium, cfg, lanes, bench_mode=bench,
                                k_steps=k_steps, tile_lanes=TILE, device=DEV)
    sk, su = eng.zero_state(), eng.zero_state()
    tk, tu = PhotonTallies.zeros(cfg, DEV), PhotonTallies.zeros(cfg, DEV)
    quota = torch.full((eng.n_tiles,), quota_per_tile, dtype=torch.int32,
                       device=DEV)
    worst = 0.0
    for b in range(2):
        u = pk.philox_uniforms(eng.plan, seed + b, b, lanes, device=DEV)
        ck = pk.photon_block(eng.plan, sk, quota, tk, seed + b, b)
        cu = pk.photon_block(eng.plan, su, quota, tu, seed + b, b, u)
        torch.cuda.synchronize()
        for f, a, c in zip(pk.KernelState._fields, sk, su):
            check(torch.equal(a.view(torch.int32), c.view(torch.int32)),
                  f"{name} block {b}: {f} differs between Philox and "
                  f"philox_uniforms")
        check(torch.equal(ck, cu), f"{name} block {b}: counters differ")
        if not bench:
            for g in GRIDS:
                a, c = getattr(tk, g).double(), getattr(tu, g).double()
                err = float((a - c).abs().max())
                scale = float(c.abs().max())
                check(err <= 2e-4 * max(scale, 1e-30),
                      f"{name} block {b}: {g} err {err} vs max {scale}")
                worst = max(worst, err)
        quota = ck[:, 3].to(torch.int32)
    return worst


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
    # the cached Philox groups give the stream philox_uniforms computes
    t0 = time.perf_counter()
    err = compare_stream("stream full_scale", m_fs, fs_cfg, False, MAIN_LANES,
                         64, TILE + TILE // 2)
    compare_stream("stream bench", m_b, bench_cfg, True, MAIN_LANES, 64, 0)
    log(3, f"in-kernel Philox against philox_uniforms fed (2 blocks, "
           f"{MAIN_LANES} lanes, k=64; full_scale and bench mode): state and "
           f"counters bitwise, max grid err {err}", t0)
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
    """The photon main path; returns its kernel launches, timings and
    tallies (phase 14 holds its resumed run against them)."""
    m, cfg = full_scale(DEV)
    n = MAIN_N
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
    return launches, timings, t


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

    split = k1_split()
    ms_k, ms_ku = split["ms_philox"], split["ms_fed"]
    ms_p = cuda_ms(lambda: pk.photon_block_reference(
        split["plan"], split["state"], split["quota"], split["tallies"],
        split["u"]), 2)
    log(7, f"full_scale block ({MAIN_LANES} lanes, k={split['plan'].k_steps})"
           f": kernel {ms_k:.4f} ms (Philox), {ms_ku:.4f} ms (uniforms read), "
           f"plain {ms_p:.3f} ms")
    log(7, f"split: quota block {split['ns_quota']:.4f} ns per executed "
           f"lane-step ({split['live']:.4f} live), bench mode on full_scale's "
           f"medium {split['ns_bench']:.4f} ns ({split['ms_bench']:.4f} ms a "
           f"block): quota / bench {split['ns_quota'] / split['ns_bench']:.4f}"
           f"; uniforms read / Philox {ms_ku / ms_k:.4f}; warp-steps with a "
           f"phase-matched lane (from the block's phase draws): (r,z) "
           f"{split['rz_share']:.4f}, volume {split['vol_share']:.4f}")
    res = k1_residency(split["plan"])
    log(7, f"K1 main-path kernel: {res['registers']} registers, "
           f"{res['stack']} B stack, spill stores {res['spill_st']} B, loads "
           f"{res['spill_ld']} B (ptxas); {res['blocks_per_sm']} resident "
           f"{TILE}-lane blocks per SM: {res['waves']:.3f} waves a block of "
           f"{MAIN_LANES // TILE} tiles on {res['sms']} SMs")
    bound, old, terms = k1_bound(split)
    log(7, f"bound: {split['steps']:.0f} live steps: FP32 "
           f"{terms['fp32']:.4f} ms, Philox multiplies {terms['imul']:.4f} ms,"
           f" SFU {terms['sfu']:.4f} ms, bytes {terms['bytes']:.4f} ms -> "
           f"{bound[0]:.4f} ms ({bound[1]}: {terms['by']}); the old count "
           f"({K1_OLD_OPS_PER_STEP} ops a step at the FP32 rate) {old:.4f} ms")
    return ms_k, ms_p, bound, old


def k1_split(reps=10):
    """The full_scale block at the main path's shapes (lanes filled by one
    block first), timed by CUDA events: with in-kernel Philox and with
    uniforms read; a bench-mode block on full_scale's medium; the live
    steps of one block; and the share of warp-steps in which some lane's
    deposit phase matches, from the block's phase draws."""
    m, cfg = full_scale(DEV)
    lanes = MAIN_LANES
    eng = pk.PhotonKernelEngine(m, cfg, lanes, bench_mode=False,
                                k_steps=pk.K_STEPS, device=DEV)
    plan, k = eng.plan, eng.k_steps
    tallies = PhotonTallies.zeros(cfg, DEV)
    quota = torch.full((eng.n_tiles,), 1 << 30, dtype=torch.int32, device=DEV)
    state = eng.zero_state()
    gen = torch.Generator(device=DEV)
    gen.manual_seed(3)
    u = torch.rand((plan.n_draws, lanes), generator=gen, device=DEV)
    pk.photon_block(plan, state, quota, tallies, 5, 0)  # fill the lanes
    ms_k = cuda_ms(lambda: pk.photon_block(plan, state, quota, tallies, 5,
                                           1), reps)
    ms_ku = cuda_ms(lambda: pk.photon_block(plan, state, quota, tallies, 5,
                                            1, u), reps)
    ms_k2 = cuda_ms(lambda: pk.photon_block(plan, state, quota, tallies, 5,
                                            1), reps)
    steps = float(pk.photon_block(plan, state, quota, tallies, 5, 1)[
        :, 2].sum())
    bench = pk.PhotonKernelEngine(m, cfg, lanes, bench_mode=True, k_steps=k,
                                  device=DEV)
    b_state = bench.zero_state()
    b_quota = torch.zeros((bench.n_tiles,), dtype=torch.int32, device=DEV)
    ms_b = cuda_ms(lambda: pk.photon_block(bench.plan, b_state, b_quota,
                                           tallies, 7, 1), reps)
    # phase-matched warp-steps: a warp's k steps hold k / stride windows,
    # and in each some lane matches on as many steps as the warp has
    # distinct phases
    d = pk.philox_uniforms(plan, 5, 1, lanes, device=DEV)

    def share(row, stride):
        ph = torch.clamp((d[row] * float(stride)).long(), max=stride - 1)
        hit = torch.zeros((lanes // 32, stride), device=DEV)
        hit.scatter_(1, ph.view(-1, 32), 1.0)
        return float(hit.sum(1).mean()) / stride

    executed = float(lanes * k)
    return {"plan": plan, "state": state, "quota": quota, "tallies": tallies,
            "u": u, "ms_philox": min(ms_k, ms_k2), "ms_fed": ms_ku,
            "ms_bench": ms_b, "steps": steps, "live": steps / executed,
            "ns_quota": min(ms_k, ms_k2) * 1e6 / executed,
            "ns_bench": ms_b * 1e6 / executed,
            "rz_share": share(0, plan.stride),
            "vol_share": share(1, plan.vol_stride)}


def ptxas_report(log_text, kernel):
    """(registers, stack, spill stores, spill loads) that ptxas reported
    for the first entry function whose name contains ``kernel``."""
    blocks = log_text.split("Compiling entry function")[1:]
    for b in blocks:
        if kernel in b.split("\n", 1)[0]:
            regs = re.search(r"Used (\d+) registers", b)
            frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                              r"stores, (\d+) bytes spill loads", b)
            return (int(regs.group(1)), *(int(x) for x in frame.groups()))
    raise AssertionError(f"ptxas reported no entry function {kernel}")


# the main path's K1 instantiation: N_PHASE 2, in-kernel Philox, staged
K1_MAIN = "photon_block_kernelILi2ELb0ELb1E"


def k1_residency(plan):
    """K1's registers, stack and spills on the main path (ptxas), its
    resident blocks per SM (the occupancy API) and the waves of a
    full_scale block."""
    text = Path(str(_build.build("photon_kernel")) + ".log").read_text()
    regs, stack, spill_st, spill_ld = ptxas_report(text, K1_MAIN)
    api = pk.kernel_residency(plan, MAIN_LANES)
    check(api["registers"] == regs, f"registers: API {api['registers']}, "
                                    f"ptxas {regs}")
    sms = torch.cuda.get_device_properties(DEV).multi_processor_count
    return {"registers": regs, "stack": stack, "spill_st": spill_st,
            "spill_ld": spill_ld, "blocks_per_sm": api["blocks_per_sm"],
            "sms": sms, "waves": MAIN_LANES // TILE
            / (api["blocks_per_sm"] * sms)}


def k1_bound(split):
    """K1's bound for the timed block: the longest of its FP32, Philox
    multiply, SFU and bytes terms; and the old count's bound."""
    plan, steps, t = split["plan"], split["steps"], split["tallies"]
    grids = sum(getattr(t, g).numel() * getattr(t, g).element_size()
                for g in GRIDS)
    n_tiles = MAIN_LANES // TILE
    # state read and written, quota, counters, every tally grid read and
    # written once
    nbytes = 2 * 36 * MAIN_LANES + 4 * n_tiles + 40 * n_tiles + 2 * grids
    terms = {"fp32": steps * K1_FP32_PER_STEP / PEAK_FP32 * 1e3,
             "imul": steps * K1_IMUL_PER_STEP / PEAK_IMUL * 1e3,
             "sfu": steps * K1_SFU_PER_STEP / PEAK_SFU * 1e3,
             "bytes": nbytes / PEAK_BYTES * 1e3}
    by = max(terms, key=terms.get)
    terms["by"] = by
    bound = (terms[by], "bytes" if by == "bytes" else "operations")
    old = bound_ms(steps * K1_OLD_OPS_PER_STEP, nbytes, PEAK_FP32)[0]
    return bound, old, terms


# --------------------------------------------------------------------------
# phases 8-10: the render slice
# --------------------------------------------------------------------------

def bound_ms(ops, nbytes, peak=PEAK_FP32_ISSUE):
    """(least time in ms, what bounds it) for ``ops`` operations at
    ``peak`` per second (FP32 instructions unless given) and ``nbytes``
    moved, at the card's published peaks."""
    t_ops, t_bytes = ops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
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


def dense_pairs(args):
    """The (tile, cluster) pairs K3's launch on ``args`` admits: its cull
    is inside the launch, so the plain mask counts them."""
    feats, tminmax, _, c_lo, c_hi = args[:5]
    return ik.tile_cluster_mask(feats[:, 6:9], feats[:, 0:3], tminmax, c_lo,
                                c_hi).sum()


KERNELS = {  # kernel -> (its wrapper in ik, plain version, admitted pairs)
    "intersect_dense": ("intersect_dense_keys",
                        ik.intersect_dense_keys_reference, dense_pairs),
    "intersect_gather": ("intersect_gather", ik.intersect_gather_reference,
                         lambda args: args[4].sum()),
}
# K4's chunk sizes timed on the heaviest launches (phase 10)
CHUNK_SWEEP = (1, 2, 4, 8, 16, 32)
# K3's pieces per block timed on the heaviest launches (phase 9)
PIECES_SWEEP = (1, 2, 4)


def as_hits(out):
    """A wrapper's result as (best_t, best_tri): K3 returns keys."""
    return ik.unpack_hit_keys(out) if isinstance(out, torch.Tensor) else out


@contextlib.contextmanager
def plain_intersector():
    """The intersector wrappers and the cull replaced by their plain
    versions (the dispatch reaches them through the module's globals).
    Fails if a kernel launched meanwhile: a dispatch that bound the
    wrappers elsewhere would otherwise compare the kernel with itself."""
    names = [w for w, _, _ in KERNELS.values()] + ["tile_cull"]
    saved = {name: getattr(ik, name) for name in names}
    before = dict(ik.LAUNCHES)
    try:
        for wrapper, ref, _ in KERNELS.values():
            setattr(ik, wrapper, lambda *a, _ref=ref: _ref(*a[:-1]))
        ik.tile_cull = ik.tile_cull_reference
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


def compare_launch(label, args, got, want, exact=False):
    """One launch's (best_t, best_tri) from the kernel against its plain
    version on the same operands, to phase 8's limits, or with ``exact``
    bitwise (nearest hit: t and triangle of every ray; any hit: the
    hit mask); returns the largest |t| difference where both hit (0 for
    an any-hit launch, whose t and triangle are whichever hit the kernel
    found first)."""
    any_hit = bool(args[-1])
    (tk, ck), (tp, cp) = as_hits(got), as_hits(want)
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
    if exact:
        check(n_bad == 0, f"{label}: not bitwise, {n_bad} hit mismatches")
        check(any_hit or (torch.equal(tk.view(torch.int32),
                                      tp.view(torch.int32))
                          and torch.equal(ck, cp)),
              f"{label}: t or triangle not bitwise")
    return err


class Recorder:
    """Wraps an intersector wrapper while installed: CUDA events around
    each launch, the admitted (tile, cluster) pairs of each, and the
    operands of each, for holding the kernel against its plain version
    (bitwise) on every launch or the heaviest.  Fails if a call it sees
    launches no kernel."""

    def __init__(self, name):
        self.name = name
        self.wrapper, self.plain, self.count_pairs = KERNELS[name]
        self.events, self.pairs, self.launched = [], [], []

    def __call__(self, *args):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = launch_counted(self.name, self.wrapped, args)
        b.record()
        self.events.append((a, b))
        self.pairs.append(self.count_pairs(args))
        self.launched.append((self.pairs[-1], args))
        return out

    def __enter__(self):
        self.wrapped = getattr(ik, self.wrapper)
        setattr(ik, self.wrapper, self)
        return self

    def __exit__(self, *exc):
        setattr(ik, self.wrapper, self.wrapped)

    def summary(self):
        torch.cuda.synchronize()
        ms = [a.elapsed_time(b) for a, b in self.events]
        pairs = [int(p) for p in self.pairs]
        return len(ms), sum(ms) / max(len(ms), 1), pairs

    def per_tile(self):
        """Each K4 launch's admitted clusters per tile: (mean, max)."""
        cnts = [a[4] for _, a in self.launched]
        return [(round(float(c.float().mean()), 2), int(c.max()))
                for c in cnts]

    def hold_every(self, label):
        """Every recorded launch again through the kernel and through its
        plain version on the same operands, bitwise."""
        for k, (pairs, args) in enumerate(self.launched):
            mode = "any-hit" if args[-1] else "nearest"
            compare_launch(f"{label}, {self.name} launch {k} ({mode}, "
                           f"{int(pairs)} pairs)", args,
                           launch_counted(self.name, self.wrapped, args),
                           self.plain(*args[:-1]), exact=True)

    def heaviest(self, any_hit):
        """The operands of the launch of that mode that admitted the most
        pairs (None if there was none)."""
        runs = [pa for pa in self.launched if bool(pa[1][-1]) == any_hit]
        return max(runs, key=lambda pa: int(pa[0]))[1] if runs else None

    def kernel_and_plain(self):
        """The nearest-hit and the any-hit launch that admitted the most
        pairs, each through the kernel and through its plain version on
        the same operands, held bitwise.  Returns the kernel's ms (mean of
        5 after a warm launch), the plain version's ms (one call), the
        bound, the admitted pairs and the largest |t| difference of the
        nearest-hit one."""
        held = {}
        for any_hit in (False, True):
            args = self.heaviest(any_hit)
            if args is None:
                continue
            got = launch_counted(self.name, self.wrapped, args)
            want = []
            ms_p = time_once(lambda: want.append(self.plain(*args[:-1])))
            mode = "any-hit" if any_hit else "nearest"
            err = compare_launch(
                f"{self.name}, heaviest {mode} launch of the run "
                f"({int(self.count_pairs(args))} pairs)", args, got, want[0],
                exact=True)
            held[any_hit] = (args, ms_p, err)
        args, ms_p, err = held[False]
        ms = cuda_ms(lambda: self.wrapped(*args), 5)
        return (ms, ms_p, self.bound(args), int(self.count_pairs(args)), err,
                self.bound(args, PEAK_FP32)[0])

    def bound(self, args, peak=PEAK_FP32_ISSUE):
        """The bound of one launch on ``args``: its admitted pairs'
        operations (and for K3 its cull's slab tests, every ray against
        every box) at ``peak`` or its operands' bytes: the rays' features
        and intervals, the records, K3's boxes or K4's id lists, and a key
        a ray."""
        feats, recs = args[0], args[2]
        ops = int(self.count_pairs(args)) * ik.RAY_TILE * ik.TRI_TILE * PAIR_OPS
        if self.name == "intersect_dense":
            ops += feats.shape[0] * recs.shape[0] * CULL_OPS
        lists = sum(x.numel() * x.element_size() for x in args[3:-1])
        nbytes = (feats.numel() * 4 + args[1].numel() * 4
                  + recs.numel() * 4 + lists + feats.shape[0] * 8)
        return bound_ms(ops, nbytes, peak)

    def mean_bound(self):
        """The bound averaged over every launch the recorder saw."""
        return sum(self.bound(a)[0] for _, a in self.launched) / max(
            len(self.launched), 1)


class CullRecorder:
    """Wraps ``ik.tile_cull`` while installed: CUDA events around each
    launch and its operands and results, for holding the cull kernel
    against the plain cull (tile_cluster_mask + cluster_ids): equal counts
    and equal first-``cnt`` ids per tile."""

    name = "tile_cull"

    def __init__(self):
        self.events, self.launched = [], []

    def __call__(self, *args):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = launch_counted(self.name, self.wrapped, args)
        b.record()
        self.events.append((a, b))
        self.launched.append((args, out))
        return out

    def __enter__(self):
        self.wrapped = ik.tile_cull
        ik.tile_cull = self
        return self

    def __exit__(self, *exc):
        ik.tile_cull = self.wrapped

    def summary(self):
        torch.cuda.synchronize()
        ms = [a.elapsed_time(b) for a, b in self.events]
        return len(ms), sum(ms) / max(len(ms), 1)

    @staticmethod
    def hold(label, args, got):
        """One launch's (ids, cnt) against the plain cull's; returns the
        plain version's ms."""
        want = []
        ms_p = time_once(lambda: want.append(ik.tile_cull_reference(*args)))
        (ids, cnt), (ids_p, cnt_p) = got, want[0]
        take = (torch.arange(ids.shape[1], device=DEV)[None, :]
                < cnt[:, None])
        n_cnt = int((cnt != cnt_p).sum())
        same = n_cnt == 0 and torch.equal(ids[take], ids_p[take])
        log(10, f"{label}: {cnt.shape[0]} tiles, admitted {int(cnt.sum())} "
                f"pairs (plain {int(cnt_p.sum())}); counts differ on "
                f"{n_cnt} tiles, ids equal {same}")
        check(same, f"{label}: the cull kernel differs from the plain cull")
        return ms_p

    def hold_every(self, label):
        for k, (args, got) in enumerate(self.launched):
            self.hold(f"{label}, tile_cull launch {k}", args, got)

    def kernel_and_plain(self):
        """The launch that admitted the most pairs, again through the
        kernel and through the plain cull.  Returns the kernel's ms (mean
        of 5 after a warm launch), the plain cull's ms (one call) and the
        bound."""
        args = max(self.launched, key=lambda ag: int(ag[1][1].sum()))[0]
        got = launch_counted(self.name, self.wrapped, args)
        ms_p = self.hold("tile_cull, heaviest launch of the run", args, got)
        ms = cuda_ms(lambda: self.wrapped(*args), 5)
        return ms, ms_p, self.bound(args, got), self.bound(args, got,
                                                           PEAK_FP32)[0]

    @staticmethod
    def bound(args, got, peak=PEAK_FP32_ISSUE):
        """Each ray's slab test against every box at ``peak``, or the
        bytes: each ray's origin, direction and interval, the boxes, the
        admitted ids and the counts."""
        feats, c_lo = args[0], args[2]
        n, c = feats.shape[0], c_lo.shape[0]
        nbytes = n * 8 * 4 + c * 6 * 4 + int(got[1].sum()) * 4 + n // 128 * 4
        return bound_ms(n * c * CULL_OPS, nbytes, peak)

    def mean_bound(self):
        return sum(self.bound(a, g)[0] for a, g in self.launched) / max(
            len(self.launched), 1)


def compare_hits(label, scene, o, d, active, max_dist, kernel):
    """Nearest and any-hit queries of one ray batch through the kernels and
    through the plain versions, failing unless ``kernel`` (and no other
    intersector kernel) ran; every launch of the cull and of K3 or K4 is
    held bitwise against its plain version.  Returns the largest |t|
    difference where both hit, and the recorders."""
    from light_transport_tpu_torch.ops.dispatch import (
        scene_intersect,
        scene_occluded,
    )

    n = o.shape[0]
    recs = [Recorder(name) for name in KERNELS]
    with recs[0], recs[1], CullRecorder() as cull:
        hk = scene_intersect(scene, o, d, active=active)
        ok = scene_occluded(scene, o, d, max_dist, active=active)
        # each launch again, held bitwise
        cull.hold_every(label)
        for r in recs:
            r.hold_every(label)
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
    check([r.name for r in recs if r.events] == [kernel],
          f"{label}: expected launches of {kernel} alone")
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
    return (float(dt.max()) if dt.numel() else 0.0), recs


def soft_shadow_scene(n_theta=176, n_phi=352):
    """examples/soft_shadow.py's scene from the port's modules: a
    123,200-triangle turquoise sphere on a floor under a 3x3 area light.
    At n_theta=44, n_phi=88 the sphere has 7,568 triangles: 7,572 in all,
    15 clusters, the top of K3's range."""
    sph = sphere_triangles(center=(0, 1, 0), radius=1.5, n_theta=n_theta,
                           n_phi=n_phi)
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


def glass_batches(glass):
    """The glass preset's camera rays (every 11th lane inactive) and
    bounce-1 rays, each as (label, o, d, active, any-hit distance)."""
    scene, cfg = glass
    o, d, u = pt._camera_lanes(scene, cfg, generator(1))
    active = torch.ones(o.shape[0], dtype=torch.bool, device=DEV)
    active[::11] = False
    state, _ = pt._bounce(scene, cfg, pt.PathState.initial(o, d), u[:, 0], 0)
    md = torch.rand(o.shape[0], generator=generator(2), device=DEV) * 15.0
    return [("glass camera rays", o, d, active, 20.0),
            ("glass bounce-1 rays", state.origin, state.direction,
             state.alive, md)]


def shadow_batches(scene, label):
    """16,384 camera rays (128x128, 1 spp) and 16,384 interior rays of a
    soft-shadow layout, every 9th lane inactive, each as (label, o, d,
    active, any-hit distance)."""
    n = 16384
    cam_cfg = dataclasses.replace(SOFT_SHADOW_CFG, width=128, height=128,
                                  spp=1)
    o, d, _ = pt._camera_lanes(scene, cam_cfg, generator(3))
    active = torch.ones(n, dtype=torch.bool, device=DEV)
    active[::9] = False
    g = generator(4)
    lo = torch.tensor([-2.0, -0.5, -2.0], device=DEV)
    hi = torch.tensor([2.0, 3.0, 2.0], device=DEV)
    oi = lo + (hi - lo) * torch.rand((n, 3), generator=g, device=DEV)
    di = torch.nn.functional.normalize(
        torch.randn((n, 3), generator=g, device=DEV), dim=-1)
    md = 0.5 + 7.5 * torch.rand(n, generator=g, device=DEV)
    return [(f"{label} camera rays", o, d, active, 8.0),
            (f"{label} interior rays", oi, di, active, md)]


# --------------------------------------------------------------------------
# K3's query split and the glass render's walls (phase 9;
# scripts/time_k3_split.py runs the same against an older tree)
# --------------------------------------------------------------------------

# the functions of ops/intersect_kernel that a cluster query may call, each
# timed on its own operands (those a tree does not call are skipped)
QUERY_PARTS = ("ray_features", "tile_cluster_mask", "cluster_weights",
               "intersect_dense", "intersect_dense_keys", "unpack_hit_keys")
SPLIT_REPS = 20


def device_profile(fn):
    """(device ms, kernel launches, {kernel: (ms, launches)}) of one
    ``fn()`` under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = {e.key: (e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0}
    return (sum(ms for ms, _ in rows.values()),
            sum(c for _, c in rows.values()), rows)


def capture_queries(ikm, scene, o, d, active, max_dist):
    """The cluster queries the dispatch makes for one ray batch (nearest,
    then any hit): ``ikm.intersect_rays_pallas``'s operands after the
    coherence sort."""
    calls, fn = [], ikm.intersect_rays_pallas

    def spy(*a, **k):
        calls.append((a, k))
        return fn(*a, **k)

    ikm.intersect_rays_pallas = spy
    try:
        dispatch.scene_intersect(scene, o, d, active=active)
        dispatch.scene_occluded(scene, o, d, max_dist, active=active)
    finally:
        ikm.intersect_rays_pallas = fn
    return calls


def query_split(ikm, call):
    """One cluster query: the whole of it, then each QUERY_PARTS function
    it called, again on the operands it was given, each under
    torch.profiler (device ms, launches) and by CUDA events (ms a call,
    mean of SPLIT_REPS back to back); K3's own kernel from the whole
    query's profile."""
    a, k = call
    seen = {}
    saved = {n: getattr(ikm, n) for n in QUERY_PARTS if hasattr(ikm, n)}

    def spy(name, f):
        def g(*x, **y):
            seen.setdefault(name, []).append((x, y))
            return f(*x, **y)
        return g

    for n, f in saved.items():
        setattr(ikm, n, spy(n, f))
    try:
        ikm.intersect_rays_pallas(*a, **k)
    finally:
        for n, f in saved.items():
            setattr(ikm, n, f)
    out = {}
    runs = [("query", lambda: ikm.intersect_rays_pallas(*a, **k))]
    runs += [(n, lambda f=saved[n], cs=cs: [f(*x, **y) for x, y in cs])
             for n, cs in seen.items()]
    for name, fn in runs:
        ms, launches, rows = device_profile(fn)
        out[name] = (round(ms, 4), launches, round(cuda_ms(fn, SPLIT_REPS),
                                                     4))
        if name == "query":
            k3 = [v for key, v in rows.items() if "intersect_dense" in key]
            out["K3 kernel"] = (round(sum(v[0] for v in k3), 4),
                                sum(v[1] for v in k3), None)
    return out


def log_split(phase, ikm, scene, batches, tag=""):
    """query_split of every cluster query the dispatch makes for each
    batch, one line a query."""
    for label, o, d, active, md in batches:
        for call, mode in zip(capture_queries(ikm, scene, o, d, active, md),
                              ("nearest", "any-hit")):
            split = query_split(ikm, call)
            log(phase, f"{tag}K3 query split, {label} ({mode}, "
                       f"{call[0][0].shape[0]} rays): part: (profiler ms, "
                       f"launches, events ms a call) "
                       + json.dumps(split))


def glass_walls(ikm, glass, phase, tag=""):
    """The glass preset rendered twice from a scene not rendered before
    (host clock to synchronize: the first call builds the scene's
    tables), its K3 launches, then once under torch.profiler for the
    device's busy share of the second call's wall.  Returns (first,
    second) in s and the busy ms."""
    scene, cfg = glass
    walls = []
    for _ in range(2):
        ikm.LAUNCHES["intersect_dense"] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pt.render_image(scene, cfg, seed=5)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    launches = ikm.LAUNCHES["intersect_dense"]
    by_kernel = profile_render(scene, cfg, walls[1], phase=phase)
    busy = sum(t for t, _, _ in by_kernel) / 1e3
    k3 = [(t, c) for t, c, key in by_kernel if "intersect_dense" in key]
    log(phase, f"{tag}glass render: first call {walls[0]:.4f} s, second "
               f"{walls[1]:.4f} s, K3 launches a render {launches}, K3 "
               f"under the profiler {sum(t for t, _ in k3) / 1e3:.4f} ms in "
               f"{sum(c for _, c in k3)} launches; device busy {busy:.3f} "
               f"ms = {busy / (walls[1] * 1e3):.3f} of the second call, "
               f"{sum(c for _, c, _ in by_kernel)} launches")
    return walls, busy, k3


def phase8(glass, mid, soft):
    """Kernels against plain on real ray batches; returns K3's recorders
    of the 15-cluster batches (phase 9 sweeps on their launches)."""
    err = {}
    t0 = time.perf_counter()
    e3, mid_recs = [], []
    for label, o, d, active, md in glass_batches(glass):
        e3.append(compare_hits(f"{label} (K3)", glass[0], o, d, active, md,
                               "intersect_dense")[0])
    for label, o, d, active, md in shadow_batches(mid, "15-cluster"):
        e, recs = compare_hits(f"{label} (K3)", mid, o, d, active, md,
                               "intersect_dense")
        e3.append(e)
        mid_recs.append(recs[0])
    err["intersect_dense"] = max(e3)
    log(8, "K3 done", t0)
    t0 = time.perf_counter()
    err["intersect_gather"] = max(
        compare_hits(f"{label} (K4)", soft, o, d, active, md,
                     "intersect_gather")[0]
        for label, o, d, active, md in shadow_batches(soft, "soft-shadow"))
    log(8, f"K4 done; largest |t| difference per kernel {err}", t0)
    return mid_recs


def phase9(glass, mid, mid_recs):
    """The glass preset through K3: the walls of a fresh scene's first and
    second render and its device busy share, one render with every K3
    launch timed and held bitwise and its image against the plain
    intersector's, K3's query split, and the pieces-per-block sweep.
    Returns K3's launches a render, its recorder and its ms a launch
    under the profiler."""
    scene, cfg = glass
    t0 = time.perf_counter()
    walls, busy, k3_prof = glass_walls(ik, glass_scene(device=DEV), 9)
    prof_ms = sum(t for t, _ in k3_prof) / 1e3 / max(
        sum(c for _, c in k3_prof), 1)
    for name in ik.LAUNCHES:
        ik.LAUNCHES[name] = 0
    with Recorder("intersect_dense") as rec:
        img = pt.render_image(scene, cfg, seed=5)
        torch.cuda.synchronize()
    launches = dict(ik.LAUNCHES)
    with plain_intersector():
        img_p = pt.render_image(scene, cfg, seed=5)
    diff = float((img - img_p).abs().mean())
    n, ms, pairs = rec.summary()
    log(9, f"glass {cfg.width}x{cfg.height}x{cfg.spp} depth {cfg.max_depth}"
           f" ({scene.mesh.num_triangles} triangles): mean |K3 - plain| "
           f"{diff:.3e}, image mean {float(img.mean()):.5f}, K3 launches "
           f"{launches['intersect_dense']} at {ms:.4f} ms each by CUDA "
           f"events ({prof_ms:.4f} under the profiler), admitted pairs per "
           f"launch {pairs}, K4 launches {launches['intersect_gather']}; "
           f"K3 at {ik.DENSE_PIECES} piece(s) a block, resident blocks per "
           f"SM {ik.dense_blocks_per_sm()}", t0)
    check(bool(torch.isfinite(img).all()), "glass image not finite")
    check(float(img.min()) >= 0.0 and float(img.max()) <= 1.0,
          "glass image outside [0, 1]")
    check(diff < 2e-3, f"glass K3 vs plain image diff {diff}")
    check(launches["intersect_dense"] > 0, "the glass render launched no K3")
    rec.hold_every("glass render")
    t0 = time.perf_counter()
    log_split(9, ik, scene, glass_batches(glass))
    log_split(9, ik, mid, shadow_batches(mid, "15-cluster"))
    log(9, "K3 query split", t0)
    sweep_pieces("glass render", rec.launched)
    sweep_pieces("15-cluster batches",
                 [pa for r in mid_recs for pa in r.launched])
    return launches["intersect_dense"], rec, prof_ms


def sweep_pieces(label, launched):
    """K3 on the heaviest nearest-hit and any-hit launch of ``launched``
    at each pieces-per-block of PIECES_SWEEP: the keys held bitwise
    against DENSE_PIECES's (any hit: the hit mask), then ms a launch under
    the profiler (mean of 10), resident blocks per SM and ms by CUDA events
    (mean of 10 back to back)."""
    for any_hit in (False, True):
        runs = [pa for pa in launched if bool(pa[1][-1]) == any_hit]
        pairs, args = max(runs, key=lambda pa: int(pa[0]))
        want = ik.intersect_dense_keys(*args[:5], any_hit=any_hit)
        times = {}
        for pieces in PIECES_SWEEP:
            def fn():
                return ik.intersect_dense_keys(*args[:5], any_hit=any_hit,
                                               pieces=pieces)
            got = fn()
            check(torch.equal(got, want) if not any_hit else
                  torch.equal(got != ik.NO_HIT_KEY, want != ik.NO_HIT_KEY),
                  f"K3 at {pieces} pieces a block: differs")
            _, _, rows = device_profile(lambda: [fn() for _ in range(10)])
            k3 = [v for key, v in rows.items() if "intersect_dense" in key]
            times[pieces] = (
                round(sum(v[0] for v in k3) / max(sum(v[1] for v in k3), 1),
                      4), ik.dense_blocks_per_sm(pieces),
                round(cuda_ms(fn, 10), 4))
        mode = "any-hit" if any_hit else "nearest"
        log(9, f"K3 pieces sweep, {label}, heaviest {mode} launch "
               f"({int(pairs)} pairs, {args[0].shape[0]} rays): by pieces a "
               f"block (profiler ms a launch, resident blocks per SM, events "
               f"ms): {times}")


def phase10(scene):
    """The soft-shadow scene at 400x400, 10 spp, depth 3 through the cull
    kernel and K4."""
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
    with Recorder("intersect_gather") as rec, CullRecorder() as cull:
        img2 = lt.render(scene, cfg, seed=0)
        torch.cuda.synchronize()
    wall2 = time.perf_counter() - t0
    n, ms, pairs = rec.summary()
    blocks = ik.gather_blocks_per_sm()
    log(10, f"soft shadow {cfg.width}x{cfg.height}x{cfg.spp} depth "
            f"{cfg.max_depth} ({scene.mesh.num_triangles} triangles, "
            f"{n_lanes} lanes): first render {wall1:.3f} s, second "
            f"{wall2:.3f} s; K4 launches {launches['intersect_gather']} "
            f"(K3 {launches['intersect_dense']}, cull "
            f"{launches['tile_cull']}), {ms:.3f} ms per launch by CUDA "
            f"events, cull {cull.summary()[1]:.3f} ms per query; admitted "
            f"(tile, cluster) pairs per launch {pairs} of "
            f"{(n_lanes // ik.RAY_TILE) * n_clusters}; admitted per tile "
            f"(mean, max) per launch {rec.per_tile()}; CHUNK "
            f"{ik.GATHER_CHUNK}, K4 resident blocks per SM {blocks} "
            f"({blocks * ik.RAY_TILE // 32} warps)")
    check(blocks * ik.RAY_TILE // 32 >= 20,
          f"K4 keeps {blocks} blocks per SM: fewer than 20 warps")
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
    check(launches["tile_cull"] == launches["intersect_gather"],
          "the render's K4 launches were not fed by the cull kernel")
    cull.hold_every("soft-shadow render")
    sweep_chunk(rec)
    profile_render(scene, cfg, wall2, show=("tile_cull",))
    return launches, rec, cull, (wall1, wall2)


def sweep_chunk(rec):
    """K4 on the render's heaviest nearest-hit and any-hit launches at each
    chunk size of CHUNK_SWEEP and at one block per tile (chunk = C): ms
    per launch by CUDA events (mean of 3 after a warm launch)."""
    for any_hit in (False, True):
        runs = [a for _, a in rec.launched if bool(a[-1]) == any_hit]
        args = max(runs, key=lambda a: int(a[4].sum()))
        c = args[2].shape[0]
        times = {chunk: round(cuda_ms(lambda: ik.intersect_gather_keys(
            *args[:5], any_hit=any_hit, chunk=chunk), 3), 3)
            for chunk in (*CHUNK_SWEEP, c)}
        mode = "any-hit" if any_hit else "nearest"
        log(10, f"K4 chunk sweep, heaviest {mode} launch "
                f"({int(args[4].sum())} pairs): ms per launch by chunk "
                f"{times}")


def profile_render(scene, cfg, wall, phase=10, show=(), host_top=0):
    """Where a render's device time goes: one more render under
    torch.profiler, device time by kernel, and the device's busy share of
    the unprofiled render's wall time.  Kernels whose name holds one of
    ``show`` are printed after the top ten if they are not in it."""
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
    log(phase, f"profiled render: device busy {busy:.1f} ms = "
            f"{busy / (wall * 1e3):.3f} of the unprofiled render's wall "
            f"{wall * 1e3:.1f} ms; {sum(c for _, c, _ in by_kernel)} "
            f"launches of {len(by_kernel)} kernels, the top ten:")
    rest = [k for k in by_kernel[10:] if any(w in k[2] for w in show)]
    for k, (t, count, key) in enumerate(by_kernel[:10] + rest):
        if k == 10:
            print("    and below the top ten:", flush=True)
        print(f"    {t / 1e3:9.3f} ms {t / 1e3 / busy:6.3f} x{count:<5d} "
              f"{key[:90]}", flush=True)
    check(busy > 0, "the profiler saw no device time")
    for w in show:
        check(any(w in key for _, _, key in by_kernel),
              f"the profile holds no {w}")
    if host_top:  # the host's own time by operator
        ops = sorted(((e.self_cpu_time_total, e.count, e.key)
                      for e in prof.key_averages()
                      if e.self_cpu_time_total > 0), reverse=True)
        total = sum(t for t, _, _ in ops) / 1e3
        log(phase, f"host time under the profiler {total:.1f} ms by "
                   f"operator, the top {host_top}: " + "; ".join(
                       f"{key[:40]} {t / 1e3:.2f} ms x{c}"
                       for t, c, key in ops[:host_top]))
    return by_kernel


# --------------------------------------------------------------------------
# phases 11-12: the big-mesh render slice
# --------------------------------------------------------------------------

BIG_SIZE, BIG_SPP, BIG_DEPTH = 256, 2, 3
TREELET_KERNELS = {  # wrapper -> plain version
    "treelet_walk": tk.treelet_walk_reference,
    "treelet_resume": tk.treelet_resume_reference,
}


def big_mesh_scene():
    """scripts/bench_treelet_render.py's scene at its defaults, from the
    port's modules: the Cornell box without its cone (18 triangles) and a
    4,202,100-triangle UV sphere (mat 0) at (0, -4.5, 0), radius 2.9, the
    camera at (0, 0, 8).  ``with_bvh()`` attaches the treelet tables on the
    card.  Returns (scene, cfg, seconds per build step)."""
    timings = {}
    t0 = time.perf_counter()
    base, cfg = cornell_box_scene(width=BIG_SIZE, height=BIG_SIZE,
                                  spp=BIG_SPP, max_depth=BIG_DEPTH,
                                  include_cone=False, device=DEV)
    dim = 7.5
    tris = uv_sphere_triangles(center=(0.0, -dim + 3.0, 0.0), radius=2.9,
                               n_theta=1450, n_phi=1450)
    sphere = TriangleMesh.build(tris, np.zeros(len(tris), np.int32),
                                device=DEV)
    del tris
    mesh = concat_meshes([base.mesh, sphere])
    scene = Scene.build(mesh, base.materials, camera=[0.0, 0.0, dim + 0.5])
    torch.cuda.synchronize()
    timings["mesh_s"] = time.perf_counter() - t0
    scene = scene.with_bvh(timings=timings)
    torch.cuda.synchronize()
    timings["total_s"] = time.perf_counter() - t0
    return scene, cfg, timings


@contextlib.contextmanager
def plain_treelet():
    """Both treelet wrappers replaced by their plain versions (the drivers
    reach them through the module's globals); fails if a kernel launched
    meanwhile."""
    saved = {name: getattr(tk, name) for name in TREELET_KERNELS}
    before = dict(tk.LAUNCHES)
    try:
        for name, ref in TREELET_KERNELS.items():
            setattr(tk, name,
                    lambda *a, _ref=ref, **k: _ref(*a))
        yield
    finally:
        for name, fn in saved.items():
            setattr(tk, name, fn)
    check(tk.LAUNCHES == before,
          f"the plain walk launched kernels: {before} -> {tk.LAUNCHES}")


def same_hits(label, got, want):
    """Bitwise equal hits (a Hit or an any-hit mask) and per-ray visits;
    returns the number of hits."""
    (hk, sk), (hp, sp) = got, want
    if isinstance(hk, torch.Tensor):
        check(torch.equal(hk, hp), f"{label}: any-hit masks differ in "
                                   f"{int((hk != hp).sum())} rays")
        n_hit = int(hp.sum())
    else:
        for k in ("valid", "tri", "t"):
            a, b = getattr(hk, k), getattr(hp, k)
            check(torch.equal(a, b),
                  f"{label}: {k} differs in {int((a != b).sum())} rays")
        n_hit = int(hp.valid.sum())
    check(torch.equal(sk["visits"], sp["visits"]),
          f"{label}: visits differ in "
          f"{int((sk['visits'] != sp['visits']).sum())} rays")
    return n_hit


def big_mesh_batches(scene, cfg):
    """Phase 11's ray batches of the big scene: 65,536 camera rays, the
    bounce-1 rays of those paths and shadow rays from the bounce-1 origins
    to area-uniform light points, every 9th lane inactive.  Returns the
    camera rays and a list of (label, origins, directions, nearest-hit
    t_max, any-hit t_max, active lanes)."""
    cam_cfg = dataclasses.replace(cfg, spp=1)  # 65,536 camera rays
    o, d, u = pt._camera_lanes(scene, cam_cfg, generator(11))
    n = o.shape[0]
    active = torch.ones(n, dtype=torch.bool, device=DEV)
    active[::9] = False
    inf = torch.full((n,), float("inf"), device=DEV)
    g = generator(12)
    batches = [("camera rays", o, d, inf,
                5.0 + 10.0 * torch.rand(n, generator=g, device=DEV), active)]
    state, _ = pt._bounce(scene, cfg, pt.PathState.initial(o, d), u[:, 0], 0,
                          coherent=True)
    act1 = active & state.alive
    batches.append(("bounce-1 rays", state.origin, state.direction, inf,
                    0.5 + 14.5 * torch.rand(n, generator=g, device=DEV),
                    act1))
    # shadow rays from the bounce-1 origins to area-uniform light points
    lp, _, _, _ = sample_light_points(
        scene.lights, *torch.rand((3, n), generator=g, device=DEV))
    to_light = lp - state.origin
    dist = torch.linalg.vector_norm(to_light, dim=-1)
    sd = to_light / dist[:, None]
    md = dist * (1.0 - 1e-3)
    batches.append(("shadow rays", state.origin, sd, md, md, act1))
    return (o, d, active), batches


def sorted_single(mesh):
    """The dispatch's single-launch route (ops/dispatch._bvh_query with
    TREELET_WAVEFRONT off) as a driver: ops/raysort.sorted_apply around
    one K5 launch, the lanes whose t_max is -inf given to the sort as
    inactive, as the dispatch gives them; the per-ray visits come back
    through the sort beside the hits."""
    def run(o, d, tables, t_max, any_hit=False, with_stats=False):
        def one(o_, d_, t_):
            hit, stats = tk.intersect_bvh_treelet(
                o_, d_, tables, t_max=t_, any_hit=any_hit, with_stats=True)
            parts = (hit,) if any_hit else tuple(hit)
            return (*parts, stats["visits"])
        out = raysort.sorted_apply(one, mesh, o, d, t_max,
                                   inactive=t_max == float("-inf"))
        hit = out[0] if any_hit else tk.Hit(*out[:3])
        return hit, {"visits": out[-1], "passes": 1}
    return run


def log_k5(phase, label, rec):
    """Per K5 launch a recorder saw: ms by CUDA events, node visits, the
    share of them whose next node is the adjacent record (what fetching
    that record ahead would serve), leaf visits, triangle tests and the
    largest per-ray visits."""
    n, _, counts = rec.summary()
    ms = [a.elapsed_time(b) for a, b in rec.events]
    rows = [f"{t:.4f} ms/{c[0]}/{c[5] / max(c[0], 1):.3f}/{c[1]}/{c[2]}/"
            f"{v}" for t, c, v in zip(ms, counts, rec.max_visits())]
    log(phase, f"{label}: K5 launches (events/node visits/share to the "
               f"adjacent record/leaf visits/triangle tests/largest per-ray "
               f"visits): "
               + " ".join(rows))


def phase11(scene, cfg):
    """K5 and K5r against the plain walk on the big scene's own rays."""
    tables = scene.treelet
    t0 = time.perf_counter()
    (o, d, active), batches = big_mesh_batches(scene, cfg)
    n = o.shape[0]
    cfg_k = treelet_residency(tables.T)
    log(11, f"K5/K5r: {cfg_k['block']} threads a block; K5 reads 32-byte "
            f"node records and a leaf's row in 16-byte loads; K5r's bounded "
            f"passes "
            f"stage one treelet of {tables.T * 64} bytes a block, its "
            f"unbounded pass reads global memory; resident blocks per SM: K5 "
            f"{cfg_k['k5_blocks']}, K5r bounded {cfg_k['bounded_blocks']}, "
            f"unbounded {cfg_k['last_blocks']}")
    drivers = {
        "single": tk.intersect_bvh_treelet,
        "sorted single": sorted_single(scene.mesh),
        "wavefront": functools.partial(
            tk.intersect_bvh_treelet_wavefront,
            loads_per_pass=dispatch.WAVEFRONT_LOADS_PER_PASS,
            max_passes=dispatch.WAVEFRONT_MAX_PASSES),
        "queued": tk.intersect_bvh_treelet_queued,
    }
    plain_ms = {}
    for label, bo, bd, t_near, t_any, act in batches:
        for any_hit, t_hi in ((False, t_near), (True, t_any)):
            t_hi = torch.where(act, t_hi, float("-inf"))
            mode = "any hit" if any_hit else "nearest"
            with plain_treelet():
                walks = bvh_mod.PLAIN_WALKS
                t1 = time.perf_counter()
                want = tk.intersect_bvh_treelet(bo, bd, tables, t_max=t_hi,
                                                any_hit=any_hit,
                                                with_stats=True)
                torch.cuda.synchronize()
                plain_ms[(label, mode)] = (time.perf_counter() - t1) * 1e3
                check(bvh_mod.PLAIN_WALKS == walks + 1, "no plain walk ran")
            parts = []
            for name, fn in drivers.items():
                before = dict(tk.LAUNCHES)
                t1 = time.perf_counter()
                got = fn(bo, bd, tables, t_max=t_hi, any_hit=any_hit,
                         with_stats=True)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t1) * 1e3
                launched = {k: tk.LAUNCHES[k] - before[k] for k in before}
                check(sum(launched.values()) > 0, f"{name}: no kernel")
                n_hit = same_hits(f"{label}, {mode}, {name}", got, want)
                parts.append(f"{name} {ms:.1f} ms ({got[1]['passes']} "
                             f"passes)")
            vis = want[1]["visits"]
            log(11, f"{label}, {mode}: {n} rays ({int(act.sum())} active), "
                    f"{n_hit} hit; bitwise equal to the plain walk "
                    f"({plain_ms[(label, mode)]:.0f} ms) in valid, tri, t "
                    f"and visits (mean {float(vis.float().mean()):.1f}, max "
                    f"{int(vis.max())}) through " + ", ".join(parts))
            # the sorted single launch and the wavefront once more, each
            # launch counted
            with TreeletRecorder("treelet_walk") as rec:
                got = drivers["sorted single"](bo, bd, tables, t_max=t_hi,
                                               any_hit=any_hit,
                                               with_stats=True)
            same_hits(f"{label}, {mode}, sorted single (counted)", got, want)
            log_k5(11, f"{label}, {mode}, sorted single", rec)
            with TreeletRecorder("treelet_resume") as rec:
                got = drivers["wavefront"](bo, bd, tables, t_max=t_hi,
                                           any_hit=any_hit, with_stats=True)
            same_hits(f"{label}, {mode}, wavefront (counted)", got, want)
            log_staging(rec, cfg_k)
    check_no_sync(batches, tables)
    # a BVH without tables (with_bvh(treelet=False)) walks through one K5
    # launch per query; a big mesh without a BVH raises on the card
    bare = dataclasses.replace(scene, treelet=None)
    before, walks = dict(tk.LAUNCHES), bvh_mod.PLAIN_WALKS
    hit = dispatch.scene_intersect(bare, o, d, active=active)
    occ = dispatch.scene_occluded(bare, o, d, 10.0, active=active)
    check(bvh_mod.PLAIN_WALKS == walks, "the plain walk ran on the card")
    check(tk.LAUNCHES["treelet_walk"] == before["treelet_walk"] + 2
          and tk.LAUNCHES["treelet_resume"] == before["treelet_resume"],
          f"no tables: launches {before} -> {tk.LAUNCHES}")
    t_act = torch.where(active, float("inf"), float("-inf"))
    with plain_treelet():
        want = tk.intersect_bvh_treelet(o, d, tables, t_max=t_act)
        want_occ = tk.intersect_bvh_treelet(
            o, d, tables, t_max=torch.where(active, 10.0, float("-inf")),
            any_hit=True)
    for k in ("valid", "tri", "t"):
        check(torch.equal(getattr(hit, k), getattr(want, k)),
              f"no tables: {k} differs from the plain walk")
    check(torch.equal(occ, want_occ), "no tables: any-hit masks differ")
    try:
        dispatch.scene_intersect(dataclasses.replace(bare, bvh=None), o[:8],
                                 d[:8])
        check(False, "a big mesh without a BVH did not raise on the card")
    except ValueError:
        pass
    log(11, "without tables: one K5 launch per query, bitwise equal to the "
            "plain walk; without a BVH: refused")
    log(11, "K5 and K5r done", t0)


def lanes_copy(lanes):
    return tk.Lanes(*(t.clone() for t in lanes))


def cuda_ms_each(setup, fn, reps):
    """Mean device time of ``fn()`` over ``reps`` calls, each after
    ``setup()`` (untimed), by CUDA events behind a spin kernel so that the
    host's launch time falls outside the events; one warm call first."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    total = 0.0
    for r in range(reps + 1):
        setup()
        torch.cuda._sleep(200_000)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        total += a.elapsed_time(b) if r else 0.0
    return total / reps


def treelet_residency(T):
    """Threads a block of the treelet kernels and the resident blocks per
    SM of K5 and of K5r's bounded and unbounded passes at ``T`` nodes a
    treelet (CUDA's occupancy calculator)."""
    out = (ctypes.c_int * 4)()
    lib = _build.load_treelet_kernel()
    rc = lib.treelet_blocks_per_sm(T, out)
    check(rc == 0, f"treelet_blocks_per_sm: CUDA error {rc}")
    return dict(zip(("block", "k5_blocks", "bounded_blocks", "last_blocks"),
                    out))


def log_staging(rec, cfg_k):
    """Per K5r launch a recorder saw: node visits, the share of them read
    from shared memory and the treelets staged per block."""
    _, _, counts = rec.summary()
    rows = []
    for c, args in zip(counts, rec.launched):
        blocks = -(-args[0].shape[1] // cfg_k["block"])
        rows.append(f"{c[0]}/{c[3] / max(c[0], 1):.3f}/"
                    f"{c[4] / blocks:.2f}")
    log(11, f"  K5r launches (node visits/share from shared memory/"
            f"treelets staged per block): {' '.join(rows)}")


def check_no_sync(batches, tables):
    """One wavefront query under torch's sync debug mode "error": any read
    back to the host between its passes raises.  The queued driver, whose
    contract is a host check every passes_per_sync passes, is counted in
    "warn" mode beside it."""
    label, bo, bd, t_near, _, act = batches[1]
    t_hi = torch.where(act, t_near, float("-inf"))
    fn = functools.partial(
        tk.intersect_bvh_treelet_wavefront, bo, bd, tables, t_max=t_hi,
        loads_per_pass=dispatch.WAVEFRONT_LOADS_PER_PASS,
        max_passes=dispatch.WAVEFRONT_MAX_PASSES)
    fn()
    torch.cuda.synchronize()
    before = tk.LAUNCHES["treelet_resume"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    except RuntimeError as e:
        raise AssertionError(f"the wavefront driver synced the host: {e}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    launched = tk.LAUNCHES["treelet_resume"] - before
    torch.cuda.synchronize()
    queued = count_syncs(lambda: tk.intersect_bvh_treelet_queued(
        bo, bd, tables, t_max=t_hi))
    log(11, f"{label}, nearest: the wavefront driver ran {launched} K5r "
            f"launches under sync debug mode \"error\" with no host sync; "
            f"the queued driver syncs {queued} times")


def count_syncs(fn, where=None):
    """Host syncs torch reports (sync debug mode "warn") while ``fn()``
    runs; with a dict ``where``, counted by the file and line that made
    them as well."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    if where is not None:
        for w in syncs:
            key = f"{Path(w.filename).name}:{w.lineno}"
            where[key] = where.get(key, 0) + 1
    return len(syncs)


class TreeletRecorder:
    """Wraps a treelet wrapper while installed: CUDA events around each
    launch, the launch's own counts (node visits, leaf visits, triangle
    tests, node visits from shared memory, treelets staged, node visits
    whose next node is the adjacent record), its operands (for K5r a copy of
    the lane state and gate it started from) and, for K5, its per-ray
    visits, for holding the kernel against the plain walk on the heaviest
    launch.  Fails if a call it sees launches no kernel."""

    def __init__(self, name):
        self.name = name
        self.resume = name == "treelet_resume"
        self.events, self.counts, self.launched = [], [], []
        self.visits = []  # K5: each launch's per-ray visits

    def __call__(self, *args):
        counts = torch.zeros((tk.N_COUNTS,), dtype=torch.int64, device=DEV)
        if self.resume:  # the state the launch starts from
            feats, tables, perm, lanes, ml, any_hit, (g_in, _) = args
            self.launched.append((feats, tables, perm, lanes_copy(lanes), ml,
                                  any_hit, None if g_in is None
                                  else g_in.clone()))
        else:
            self.launched.append(args)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        before = tk.LAUNCHES[self.name]
        a.record()
        out = self.wrapped(*args, counts=counts)
        b.record()
        check(tk.LAUNCHES[self.name] == before + (args[0].shape[1] > 0),
              f"{self.name}: the call launched no kernel")
        self.events.append((a, b))
        self.counts.append(counts)
        if not self.resume:
            self.visits.append(out[2])
        return out

    def max_visits(self):
        """K5: each launch's largest per-ray visits."""
        return [int(v.max()) if v.numel() else 0 for v in self.visits]

    def __enter__(self):
        self.wrapped = getattr(tk, self.name)
        setattr(tk, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(tk, self.name, self.wrapped)

    def summary(self):
        torch.cuda.synchronize()
        ms = [a.elapsed_time(b) for a, b in self.events]
        counts = [c.tolist() for c in self.counts]
        return len(ms), sum(ms) / max(len(ms), 1), counts

    def _run(self, args, plain=False, counts=None):
        """One launch (or its plain version) on ``args``; K5r on a copy of
        the lane state it started from.  Returns (cursor or None, best_t,
        best_tri, visits, lanes left unfinished or None)."""
        if not self.resume:
            fn = TREELET_KERNELS[self.name] if plain else functools.partial(
                self.wrapped, counts=counts)
            return (None, *fn(*args), None)
        feats, tables, perm, lanes, ml, any_hit, g_in = args
        out = torch.zeros((1,), dtype=torch.int32, device=DEV)
        fn = TREELET_KERNELS[self.name] if plain else functools.partial(
            self.wrapped, counts=counts)
        got = fn(feats, tables, perm, lanes_copy(lanes), ml, any_hit,
                 (g_in, out))
        return (*got, out)

    def kernel_and_plain(self):
        """The launch with the most node visits, through the kernel and
        through the plain walk on the same operands, bitwise (K5r: in
        cursor, best_t, best_tri, visits and the lanes it leaves
        unfinished).  Returns the kernel's ms (mean of 5 after a warm
        launch, each from the same state), the plain walk's ms (one call),
        the bound, the launch's counts and the largest |t| difference where
        both hit (0 when bitwise)."""
        _, _, counts = self.summary()
        k = max(range(len(counts)), key=lambda i: counts[i][0])
        args = self.launched[k]
        c = torch.zeros((tk.N_COUNTS,), dtype=torch.int64, device=DEV)
        got = self._run(args, counts=c)
        want = []
        ms_p = time_once(lambda: want.append(self._run(args, plain=True)))
        want = want[0]
        torch.cuda.synchronize()
        check(c.tolist() == counts[k],
              f"{self.name}: re-run counts {c.tolist()} vs {counts[k]}")
        for name, a, b in zip(("cursor", "best_t", "best_tri", "visits",
                               "unfinished lanes"), got, want):
            if a is not None and not torch.equal(a, b):
                check(False, f"{self.name}, heaviest launch: {name} differs "
                             f"in {int((a != b).sum())} rays")
        # the launch's own visits: K5r adds them to what the lanes had
        before = args[3].visits if self.resume else 0
        check(int((want[3] - before).sum()) == counts[k][0],
              f"{self.name}: node visits {counts[k][0]} vs the plain walk's "
                  f"{int((want[3] - before).sum())}")
        bt_k, bi_k = got[1], got[2]
        both = (bi_k >= 0) & (want[2] >= 0)
        err = float((bt_k[both] - want[1][both]).abs().max()) \
            if int(both.sum()) else 0.0
        ms = cuda_ms_each(lambda: None, lambda: self._run(args), 5) \
            if not self.resume else self.resume_ms(args, 5)
        nodes, leaves, tris, smem, staged, adjacent = counts[k]
        rays = args[0].shape[1]
        bound = self.bound(counts[k], rays)
        old = self.bound(counts[k], rays, PEAK_FP32)[0]
        mode = "any hit" if args[5 if self.resume else 2] else "nearest"
        log(12, f"{self.name}, heaviest launch of the render ({mode}, "
                f"{rays} rays, {nodes} node visits ({smem} from shared "
                f"memory, {adjacent} to the adjacent record), {leaves} leaf "
                f"visits, "
                f"{tris} triangle tests, {staged} treelets staged): bitwise "
                f"equal to the plain walk; kernel {ms:.4f} ms, plain "
                f"{ms_p:.1f} ms, bound {bound[0]:.4f} ms ({bound[1]}; at the "
                f"data sheet's FP32 rate {old:.4f} ms)")
        if not self.resume:
            self.k5_diagnostic(args, counts[k], int(want[3].max()), ms)
        return ms, ms_p, bound, counts[k], err

    def k5_diagnostic(self, args, counts, max_visits, ms):
        """Beside K5's bound: the bytes its 32-byte records make it read
        (one a visit, the bound's count) against the 48 the fused records
        took, the share of its visits to the adjacent
        record, its largest per-ray visits, and the diagnostic "largest
        visits x one visit's time on a lone ray", the lone ray being the
        launch's slowest, walked alone in a launch of one block (the other
        lanes dead)."""
        feats, tables, any_hit = args
        nodes, _, tris, _, _, adjacent = counts
        rays = feats.shape[1]
        tail = tris * TRI_BYTES + rays * RAY_BYTES["treelet_walk"]
        _, _, visits = self.wrapped(feats, tables, any_hit)
        slow = int(torch.argmax(visits))
        lone = torch.zeros((16, tk.DEFAULT_R), dtype=torch.float32,
                           device=DEV)
        lone[:, 0] = feats[:, slow]
        lone[5, 1:] = 1.0  # dead lanes, as _make_feats pads
        lone[6:8, 1:] = 1e20
        lone[8, 1:] = 1.0
        lone[10, 1:] = float("-inf")
        _, _, lv = self.wrapped(lone, tables, any_hit)
        check(int(lv[0]) == max_visits, f"lone ray: {int(lv[0])} visits, "
                                        f"{max_visits} in the launch")
        lone_ms = cuda_ms_each(lambda: None, lambda: self.wrapped(
            lone, tables, any_hit), 5)
        per_visit = lone_ms / max_visits
        fused = nodes * FUSED_NODE_BYTES + tail
        log(12, f"treelet_walk diagnostics of that launch: the 32-byte "
                f"records make it read "
                f"{(nodes * NODE_BYTES['treelet_walk'] + tail) / 1e6:.3f} MB, "
                f"the bound's count (the fused records read "
                f"{fused / 1e6:.3f} MB at 48 bytes a visit, "
                f"{bound_ms(0, fused)[0]:.4f} ms at the memory rate); "
                f"{adjacent / max(nodes, 1):.3f} of "
                f"its visits go on to the adjacent record; largest per-ray "
                f"visits {max_visits}; that ray alone {lone_ms:.4f} ms = "
                f"{per_visit * 1e6:.1f} ns a visit; diagnostic (not a bound): "
                f"largest visits x a lone visit = "
                f"{max_visits * per_visit:.4f} ms against the launch's "
                f"{ms:.4f} ms")

    def resume_ms(self, args, reps):
        """K5r's device time on ``args``, each launch from the same lane
        state (restored outside the timed span)."""
        feats, tables, perm, lanes, ml, any_hit, g_in = args
        work = lanes_copy(lanes)
        out = torch.zeros((1,), dtype=torch.int32, device=DEV)

        def setup():
            for dst, src in zip(work, lanes):
                dst.copy_(src)
        return cuda_ms_each(setup, lambda: self.wrapped(
            feats, tables, perm, work, ml, any_hit, (g_in, out)), reps)

    def bound(self, counts, rays, peak=PEAK_FP32_ISSUE):
        """The bound of one launch from its node visits and triangle tests
        (at ``peak``) and its rays."""
        nodes, _, tris = counts[:3]
        return bound_ms(nodes * NODE_OPS + tris * TRI_OPS,
                        nodes * NODE_BYTES[self.name] + tris * TRI_BYTES
                        + rays * RAY_BYTES[self.name], peak)

    def mean_bound(self):
        """The bound averaged over every launch the recorder saw."""
        _, _, counts = self.summary()
        return sum(self.bound(c, a[0].shape[1])[0] for c, a in
                   zip(counts, self.launched)) / max(len(counts), 1)


# the dispatch's two routes for big-mesh bounce and shadow rays
# (dispatch.TREELET_WAVEFRONT), and the order phase 12 renders them in
ROUTES = {"wavefront": True, "single": False}
ROUTE_TURNS = ("wavefront", "single", "single", "wavefront")


@contextlib.contextmanager
def treelet_route(name):
    """dispatch.TREELET_WAVEFRONT set for route ``name``, restored after."""
    saved = dispatch.TREELET_WAVEFRONT
    dispatch.TREELET_WAVEFRONT = ROUTES[name]
    try:
        yield
    finally:
        dispatch.TREELET_WAVEFRONT = saved


def zero_counts():
    for name in tk.LAUNCHES:
        tk.LAUNCHES[name] = 0
    for name in ik.LAUNCHES:
        ik.LAUNCHES[name] = 0
    bvh_mod.PLAIN_WALKS = 0


def check_route(name, launches):
    """A big-mesh render's counts, set to 0 just before it: K5 launched,
    K5r exactly on the wavefront route, no plain walk and no cluster
    kernel."""
    check(launches["treelet_walk"] > 0, f"{name} route: no K5 launched")
    if ROUTES[name]:
        check(launches["treelet_resume"] > 0,
              f"{name} route: no K5r launched")
    else:
        check(launches["treelet_resume"] == 0,
              f"{name} route: K5r launched {launches['treelet_resume']} "
              f"times")
    check(bvh_mod.PLAIN_WALKS == 0,
          f"{name} route: the plain walk ran {bvh_mod.PLAIN_WALKS} times")
    check(sum(ik.LAUNCHES.values()) == 0,
          f"{name} route: the cluster kernels launched: {ik.LAUNCHES}")


def route_turn(scene, cfg, name, ref):
    """One turn of route ``name``: a render with the counts set to 0
    before it (its image bitwise ``ref``), the second call's wall, the
    host syncs of a third and a fourth under the profiler.  Returns the
    turn's numbers."""
    with treelet_route(name):
        zero_counts()
        img = lt.render(scene, cfg, seed=0)
        torch.cuda.synchronize()
        launched = dict(tk.LAUNCHES)
        check_route(name, launched)
        check(torch.equal(img, ref),
              f"the {name} route's image differs from the main path's")
        t0 = time.perf_counter()
        lt.render(scene, cfg, seed=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        syncs = count_syncs(lambda: lt.render(scene, cfg, seed=0))
        busy, n_launch, rows = device_profile(
            lambda: lt.render(scene, cfg, seed=0))
    by_cat = {}
    for key, (ms, c) in rows.items():
        cat = kernel_category(key)
        t, n = by_cat.get(cat, (0.0, 0))
        by_cat[cat] = (t + ms, n + c)
    return {"launched": launched, "wall": wall, "syncs": syncs,
            "busy": busy, "launches": n_launch, "by_cat": by_cat}


def log_routes(turns):
    """Each route's turns side by side, and which route wins on device
    busy and on launches (the wall is host-noisy: its spread is given)."""
    per = {}
    for name, r in turns:
        per.setdefault(name, []).append(r)
    for name, rs in per.items():
        def each(fmt, fn):
            return ", ".join(fmt.format(fn(r)) for r in rs)
        log(12, f"{name} route, {len(rs)} turns: second-call wall "
                f"{each('{:.2f}', lambda r: r['wall'] * 1e3)} ms; device "
                f"busy {each('{:.3f}', lambda r: r['busy'])} ms (share "
                f"{each('{:.3f}', lambda r: r['busy'] / r['wall'] / 1e3)}); "
                f"launches {each('{}', lambda r: r['launches'])}; host "
                f"syncs {each('{}', lambda r: r['syncs'])}; treelet "
                f"launches {rs[0]['launched']}; device ms by kernel (first "
                f"turn): " + ", ".join(
                    f"{k} {v[0]:.3f} (x{v[1]})"
                    for k, v in sorted(rs[0]["by_cat"].items())))
    mean = {name: {k: sum(r[k] for r in rs) / len(rs)
                   for k in ("busy", "launches", "wall")}
            for name, rs in per.items()}
    for key in ("busy", "launches", "wall"):
        win = min(mean, key=lambda n_: mean[n_][key])
        log(12, f"route by mean {key}: " + ", ".join(
            f"{n_} {v[key]:.4f}" for n_, v in mean.items())
            + f"; lower: {win}")
    return per


def phase12(scene, cfg):
    """The big-mesh render through the dispatch's default route (the main
    path), then both routes in turns, the heaviest launches held against
    the plain walk, a re-trace and a profile."""
    n_lanes = cfg.width * cfg.height * cfg.spp
    main = "wavefront" if dispatch.TREELET_WAVEFRONT else "single"
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img, samples = pt.render_image(scene, cfg, seed=0, return_samples=True)
    torch.cuda.synchronize()
    wall1 = time.perf_counter() - t0
    launches = dict(tk.LAUNCHES)
    check_route(main, launches)
    log(12, f"main path: the {main} route (dispatch.TREELET_WAVEFRONT = "
            f"{dispatch.TREELET_WAVEFRONT}); first render {wall1:.3f} s; "
            f"launches counted from 0: {launches}")
    turns = [(name, route_turn(scene, cfg, name, img))
             for name in ROUTE_TURNS]
    per = log_routes(turns)
    wave_launches = per["wavefront"][0]["launched"]
    sync_at = {}
    with treelet_route(main):
        count_syncs(lambda: lt.render(scene, cfg, seed=0), sync_at)
    log(12, f"host syncs of a {main}-route render by place: "
            + ", ".join(f"{k} x{v}" for k, v in sorted(sync_at.items())))
    recs = {}
    for name, kernels in (("single", ("treelet_walk",)),
                          ("wavefront", ("treelet_walk", "treelet_resume"))):
        with treelet_route(name), contextlib.ExitStack() as stack:
            rs = [stack.enter_context(TreeletRecorder(k)) for k in kernels]
            t0 = time.perf_counter()
            lt.render(scene, cfg, seed=0)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        check(bvh_mod.PLAIN_WALKS == 0, "the plain walk ran in the render")
        for rec in rs:
            n, ms, counts = rec.summary()
            log(12, f"{name} route, {rec.name}: {n} launches, {ms:.4f} ms "
                    f"per launch by CUDA events, {sum(c[0] for c in counts)} "
                    f"node visits in all (per launch "
                    f"{[c[0] for c in counts]}); render with events around "
                    f"every launch {wall:.3f} s")
            if not rec.resume:
                log_k5(12, f"{name} route", rec)
        recs[name] = dict(zip(kernels, rs))
    # re-trace every 97th lane of the main path through the plain walk
    t0 = time.perf_counter()
    o, d, u = pt._camera_lanes(scene, cfg, pt._generator(scene, 0))
    lanes = torch.arange(0, n_lanes, 97, device=DEV)
    with plain_treelet():
        rad_p, _ = pt.trace_paths(scene, cfg, o[lanes], d[lanes], u[lanes])
    check(bvh_mod.PLAIN_WALKS > 0, "the re-trace ran no plain walk")
    rad_k = samples.permute(2, 0, 1, 3).reshape(-1, 3)[lanes]
    close = torch.isclose(rad_k, rad_p, rtol=1e-3, atol=1e-6).all(dim=1)
    frac = float(close.float().mean())
    mean = float(img.mean())
    log(12, f"plain re-trace of {lanes.shape[0]} lanes: {frac:.5f} within "
            f"rtol 1e-3; image mean {mean:.5f}; both routes' images bitwise "
            f"the main path's", t0)
    check(bool(torch.isfinite(img).all()), "big-mesh image not finite")
    check(mean > 0.0, "big-mesh image is black")
    check(frac >= 0.99, f"plain re-trace: {frac} of lanes agree")
    wall2 = min(r["wall"] for r in per[main])
    with treelet_route(main):
        profile_render(scene, cfg, wall2, phase=12, host_top=8)
    # each kernel's device time a launch under the profiler: K5 on the
    # single route, K5r on the wavefront route (first turn of each)
    prof_ms = {}
    for name, route, cat in (("treelet_walk", "single", "K5"),
                             ("treelet_resume", "wavefront", "K5r")):
        t, c = per[route][0]["by_cat"][cat]
        prof_ms[name] = t / max(c, 1)
        log(12, f"{name} under the profiler ({route} route): {c} launches, "
                f"{prof_ms[name]:.4f} ms per launch ({t:.3f} ms in all)")
    k5_launches = {"treelet_walk": launches["treelet_walk"],
                   "treelet_resume": wave_launches["treelet_resume"]}
    k5_recs = (recs["single"]["treelet_walk"],
               recs["wavefront"]["treelet_resume"])
    return k5_launches, k5_recs, prof_ms


def kernel_category(key):
    """A profiler kernel name's part of a treelet query: K5, K5r, sort,
    gather (index ops), reduce, or other."""
    if "treelet_walk32<" in key:
        return "K5"
    if "treelet_walk<" in key:
        return "K5r"
    low = key.lower()
    if "radixsort" in low or "sort" in low:
        return "sort"
    if "index" in low or "gather" in low:
        return "gather"
    if "reduce" in low:
        return "reduce"
    return "other"


# --------------------------------------------------------------------------
# phase 13: the feature probes
# --------------------------------------------------------------------------

PROBE_DEFS = {  # each probe's def line in scripts/probe_treelet_features.py
    "p_while": 42, "p_while_vec_carry": 71, "p_dma_smem": 103,
    "p_red_when": 131, "p_red_dma": 153, "p_red_smem_dma": 182,
    "p_onehot": 213, "p_when_mm": 251, "p_reshape_8x128": 300,
    "p_packed_pair_flush": 322,
}
PROBE_REPS = 100


def probe_work(name, args):
    """(operations, their peak rate, bytes) that the probe's function needs
    on these inputs: every input byte the output depends on read once, the
    output written once.  The one-hot gather (P7) and histogram (P10) need
    only their adds, not the dense contractions the kernels compute them
    by."""
    out = math.prod(fp.SPECS[name][1]) * 4
    nb = [a.numel() * a.element_size() for a in args]
    if name == "p_while":
        n = max(int(args[0][0, 0]), 0)
        return n * (n + 1) // 2, PEAK_FP32_ISSUE, nb[0] + out
    if name == "p_while_vec_carry":
        steps = max(10 - int(args[0].to(torch.int32).min()), 0)
        return 2 * steps * args[0].numel(), PEAK_FP32_ISSUE, nb[0] + out
    if name == "p_dma_smem":
        return 0, PEAK_FP32_ISSUE, nb[0] + nb[1] // args[1].shape[0] + out
    if name == "p_red_when":
        return args[0].numel(), PEAK_FP32_ISSUE, nb[0] + out
    if name in ("p_red_dma", "p_red_smem_dma"):
        return (args[0].numel(), PEAK_FP32_ISSUE,
                nb[0] + nb[1] // args[1].shape[0] + out)
    if name == "p_onehot":  # the three chunk rows, two adds per column
        return (2 * args[0].numel(), PEAK_FP32_ISSUE,
                nb[0] + 3 * nb[1] // 128 + out)
    if name == "p_when_mm":
        if int(args[0][0]) <= 0:
            return 0, PEAK_FP32_ISSUE, nb[0] + out
        return 2 * 128 * 128 * 256, PEAK_BF16, nb[0] + nb[1] // 2 + out
    if name == "p_reshape_8x128":
        return 0, PEAK_FP32_ISSUE, nb[0] + out
    if name == "p_packed_pair_flush":  # two bin adds a record, one a bin
        return 2 * args[2].numel() + out // 4, PEAK_FP32_ISSUE, sum(nb) + out
    raise KeyError(name)


def probe_library(name, args):
    """One PyTorch call of the probe's function on its inputs, checked
    once against the plain version, as a zero-argument callable for
    timing; None where no single call computes it."""
    want = fp.PLAIN[name](*args)
    if name == "p_dma_smem":
        idx, tab = args
        call = lambda: torch.index_select(tab, 0, idx)  # noqa: E731
        got = call()[0]
    elif name == "p_when_mm":  # the product of the bf16 operand
        a = args[1][1].to(torch.bfloat16)
        call = lambda: torch.matmul(a, a.T)  # noqa: E731
        got = call().float()
    elif name == "p_reshape_8x128":
        x = args[0]
        call = lambda: x.view(1, 1024).repeat(8, 1)  # noqa: E731
        got = call()
    elif name == "p_packed_pair_flush":
        ib, jb, v = args
        idx = (ib.long(), jb.long())
        got = torch.zeros_like(want).index_put_(idx, v, accumulate=True)
        grid = torch.zeros_like(want)
        call = lambda: grid.index_put_(idx, v, accumulate=True)  # noqa: E731
    else:
        return None
    torch.cuda.synchronize()
    if name == "p_packed_pair_flush":  # v itself, not its bf16 halves
        err = float((got - want).abs().max())
        check(err <= fp.FLUSH_REL_TOL * float(want.abs().max()),
              f"{name}: index_put_ differs by {err}")
    else:
        check(torch.equal(got, want), f"{name}: the library call differs")
    return call


def phase13():
    """The feature probes through their entry point, then kernel against
    plain and timed; returns their kernel entries."""
    t0 = time.perf_counter()
    records = fp.run_all("cuda")
    for r in records:
        print("    " + json.dumps(r), flush=True)
    failed = [r for r in records if not r["ok"]]
    check(not failed, f"probes failed: {failed}")
    check([r["probe"] for r in records] == list(fp.NAMES), "probes missing")
    check(all(r["launches"] == 1 for r in records),
          "a probe's run did not launch its kernel once")
    log(13, f"entry point: {len(records)} probes, each in a subprocess, "
            f"each its kernel's one launch, each passing its check", t0)
    t0 = time.perf_counter()
    empty = cuda_ms(lambda: fp.empty_launch(DEV), PROBE_REPS)
    empty_dev = probe_device_ms(lambda: fp.empty_launch(DEV))
    entries = []
    for r in records:
        name = r["probe"]
        args = fp.inputs(name, DEV)
        wrapper, plain = fp.WRAPPERS[name], fp.PLAIN[name]
        got = wrapper(*args)
        torch.cuda.synchronize()
        bitwise, err = fp.agree(name, got, plain(*args))
        fp.check(name, args, got)
        if name in ("p_red_when", "p_when_mm"):  # the branch not taken
            other = (torch.zeros_like(args[0]), *args[1:])  # min 0, flag 0
            fp.agree(name, wrapper(*other), plain(*other))
        if name == "p_when_mm":
            log(13, p8_random(wrapper, plain, args))
        ms = cuda_ms(lambda: wrapper(*args), PROBE_REPS)
        plain_ms = cuda_ms(lambda: plain(*args), 20)
        lib = probe_library(name, args)
        lib_ms = cuda_ms(lib, PROBE_REPS) if lib is not None else None
        dev_ms = probe_device_ms(lambda: wrapper(*args))
        lib_dev = probe_device_ms(lib) if lib is not None else None
        ops, peak, nbytes = probe_work(name, args)
        bound = bound_ms(ops, nbytes, peak)
        same = ("bitwise equal to" if bitwise
                else "within 2^-16 of the largest bin of")
        if name == "p_when_mm":  # the yardstick's operand is cast already
            a32 = args[1][1]
            pair = lambda: torch.matmul(  # noqa: E731
                *(lambda a: (a, a.T))(a32.to(torch.bfloat16)))
            log(13, f"p_when_mm beside its yardsticks, device time a call "
                    f"under the profiler: kernel {dev_ms:.5f} ms, bf16 "
                    f"matmul {lib_dev:.5f} ms, cast to bf16 then matmul "
                    f"{probe_device_ms(pair):.5f} ms; by CUDA events: "
                    f"kernel {ms:.5f}, matmul {lib_ms:.5f}, cast then "
                    f"matmul {cuda_ms(pair, PROBE_REPS):.5f} ms")
        if name == "p_reshape_8x128":  # the floor no launch beats, beside
            floor = probe_device_ms(lambda: fp.empty_launch(DEV))
            log(13, f"p_reshape_8x128 beside its yardsticks, device time a "
                    f"call under the profiler: kernel {dev_ms:.5f} ms, "
                    f"repeat {lib_dev:.5f} ms, empty kernel {floor:.5f} ms "
                    f"(kernel / repeat {dev_ms / lib_dev:.3f})")
        log(13, f"{name}: kernel {same} its plain version (max abs err "
                f"{err:.3e}); kernel {ms:.5f} ms a launch by CUDA events over"
                f" {PROBE_REPS} launches, an empty kernel launched the same "
                f"way {empty:.5f} ms (at this size the time is launch "
                f"overhead); plain {plain_ms:.5f} ms; library "
                + (f"{lib_ms:.5f} ms" if lib_ms is not None else "none")
                + f"; bound {bound[0]:.3e} ms ({bound[1]}: {ops} ops, "
                f"{nbytes} bytes); device time a call under the profiler "
                f"over {PROBE_REPS} calls: kernel {dev_ms:.5f} ms, empty "
                f"kernel {empty_dev:.5f} ms, library "
                + (f"{lib_dev:.5f} ms" if lib_dev is not None else "none"))
        entries.append(kernel_entry(
            name, "light_transport_tpu_torch/csrc/probe_kernels.cu",
            f"scripts/probe_treelet_features.py:{PROBE_DEFS[name]}",
            r["launches"], err, ms, plain_ms, bound, lib_ms))
    log(13, "probes timed", t0)
    return entries


# P8 on a random table: each output is a sum of 256 bf16 products (exact
# in float32), added in another order by the tensor cores than by the
# plain float32 matmul.  Each of the 255 additions errs by at most 2^-24
# of sum |a_ik a_jk| rounded to nearest (the plain matmul), 2^-23 if the
# tensor cores truncate, so the two lie within 255 x (2^-23 + 2^-24) <
# 2^-14 of that sum of each other
P8_RANDOM_TOL = 2.0 ** -14


def p8_random(wrapper, plain, args):
    """P8's kernel against its plain version on a seeded random table
    (flag 1): within P8_RANDOM_TOL of (|A| |A|^T) elementwise."""
    tab = torch.randn((2, 128, 256), generator=generator(13), device=DEV)
    got, want = wrapper(args[0], tab), plain(args[0], tab)
    a = tab[1].to(torch.bfloat16).to(torch.float32).abs()
    scale = a @ a.T
    err = (got - want).abs()
    worst = float((err / scale).max())
    check(bool((err <= P8_RANDOM_TOL * scale).all()),
          f"p_when_mm on a random table: error {worst:.3e} of sum |a a| "
          f"> {P8_RANDOM_TOL:.3e}")
    return (f"p_when_mm on a seeded random table: max abs err "
            f"{float(err.max()):.3e}, at most {worst:.3e} of sum |a_ik a_jk| "
            f"(limit 2^-14), bitwise equal in "
            f"{int((got == want).sum())} of {got.numel()} outputs")


def probe_device_ms(fn):
    """Device ms a call of ``fn()`` under torch.profiler, over PROBE_REPS
    calls back to back (every kernel a call launches counted)."""
    return device_profile(lambda: [fn() for _ in range(PROBE_REPS)])[0] / \
        PROBE_REPS


def log_gap(name, launches, ms, bound):
    """What a kernel loses on its main path against its bound: launches x
    (mean time - mean bound), the order of the redesigns."""
    log("gap", f"{name}: {launches} launches x ({ms:.4f} ms - {bound:.4f} "
               f"ms) = {launches * (ms - bound):.3f} ms")


def kernel_entry(name, source, replaces, launches, err, ms, plain_ms, bound,
                 library_ms=None):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0],
            "bound_by": bound[1], "library_ms": library_ms}


# --------------------------------------------------------------------------
# phase 14: checkpoints and the HG sweep
# --------------------------------------------------------------------------

# the main path killed at this many blocks, snapshotting every 2nd chunk
KILL_BLOCKS = 64
HG_N = 100_000
VAN_DE_HULST_RD = 0.41550


@contextlib.contextmanager
def timed_saves(record):
    """Route ``simulate_kernel``'s snapshots through a wrapper that appends
    each save's host-clock seconds to ``record``."""
    save = ckpt.save_kernel_checkpoint

    def timed(*args):
        t0 = time.perf_counter()
        save(*args)
        record.append((time.perf_counter() - t0, args))

    ckpt.save_kernel_checkpoint = timed
    try:
        yield
    finally:
        ckpt.save_kernel_checkpoint = save


class Killed(Exception):
    """Stands for a run killed after a snapshot."""


@contextlib.contextmanager
def killed_after(batches):
    """Make ``simulate_resumable`` raise Killed once the snapshot of
    ``batches`` finished batches is written."""
    save = ckpt.save_tallies

    def save_then_die(path, tallies, seed, batches_done):
        save(path, tallies, seed, batches_done)
        if batches_done == batches:
            raise Killed

    ckpt.save_tallies = save_then_die
    try:
        yield
    finally:
        ckpt.save_tallies = save


def differing_fields(a, b):
    """Fields of two tallies that are not bitwise equal."""
    return [f.name for f in dataclasses.fields(a)
            if not torch.equal(getattr(a, f.name), getattr(b, f.name))]


# a resumed run's grids against an unbroken run's: the float atomics add
# each bin's deposits in the card's order, which changes from run to run
# (two unbroken runs differ by about an ulp of their hottest bins); a
# block lost or replayed moves a hot bin by ~1/150 of itself
RESUME_GRID_RTOL = 2.0 ** -16


def grid_diffs(a, b):
    """{grid: (bitwise-equal share of bins, max abs difference, max
    difference relative to the larger of the two bins)}."""
    out = {}
    for g in GRIDS:
        x, y = getattr(a, g).double(), getattr(b, g).double()
        d = (x - y).abs()
        rel = d / torch.maximum(x.abs(), y.abs()).clamp_min(1e-300)
        out[g] = (float((x == y).double().mean()), float(d.max()),
                  float(rel.max()))
    return out


def phase14_resume(t6, t6_timings, tmp):
    """The main path killed at KILL_BLOCKS blocks (a snapshot every 2nd
    chunk), then resumed to the end: counters and grids against phase 6's
    run; the snapshot's bytes and cost; steady steps/s with a snapshot
    every 16th chunk beside runs without, in turns."""
    m, cfg = full_scale(DEV)
    cfg = dataclasses.replace(cfg, n_photons=MAIN_N)
    kw = dict(seed=0, lanes=MAIN_LANES, device=DEV)
    path = os.path.join(tmp, "full_scale.npz")
    path16 = os.path.join(tmp, "every16.npz")
    saves = []
    t0 = time.perf_counter()
    with timed_saves(saves):
        part = pk.simulate_kernel(m, cfg, max_blocks=KILL_BLOCKS,
                                  checkpoint_path=path, checkpoint_every=2,
                                  **kw)
        n_killed = len(saves)
        pk.LAUNCHES = 0
        got = pk.simulate_kernel(m, cfg, checkpoint_path=path,
                                 checkpoint_every=2, **kw)
        resumed_launches = pk.LAUNCHES
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    nbytes = os.path.getsize(path)
    check(part.n_launched < MAIN_N, "the killed run was not cut short")
    check(n_killed == KILL_BLOCKS // (2 * 4),  # chunks of 4 blocks
          f"{n_killed} snapshots before the kill")
    # the snapshot's two parts, on the last save's operands
    args = saves[-1][1]
    copy_s, write_s = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        arrays = ckpt.kernel_snapshot(*args[1:])
        t2 = time.perf_counter()
        ckpt.write_snapshot(os.path.join(tmp, "timed.npz"), arrays)
        copy_s.append(t2 - t1)
        write_s.append(time.perf_counter() - t2)
    per_save = [s for s, _ in saves]
    log(14, f"full_scale 1e7 killed at {KILL_BLOCKS} blocks (launched "
            f"{part.n_launched}, {n_killed} snapshots), resumed to the end "
            f"({resumed_launches} launches, {len(saves) - n_killed} "
            f"snapshots): launched {got.n_launched}, steps {got.n_steps} "
            f"(phase 6: {t6.n_launched}, {t6.n_steps}); {wall:.2f} s for "
            f"both; snapshot {nbytes} bytes, {1e3 * min(per_save):.1f}-"
            f"{1e3 * max(per_save):.1f} ms a save ({len(saves)} saves), of "
            f"which device -> host copy {1e3 * min(copy_s):.1f}-"
            f"{1e3 * max(copy_s):.1f} ms and write "
            f"{1e3 * min(write_s):.1f}-{1e3 * max(write_s):.1f} ms")
    # turns: without snapshots, a snapshot every 16th chunk, twice each
    rates, reruns = {}, []
    for every in (None, 16, 16, None):
        timings, saves16 = {}, []
        with timed_saves(saves16):
            t = pk.simulate_kernel(
                m, cfg, timings=timings,
                checkpoint_path=path16 if every else None,
                checkpoint_every=every or 16, **kw)
        if every is None:
            reruns.append(t)
        elif saves16:  # the next turn starts anew
            os.remove(path16)
        check(not set(differing_fields(t, t6)) - set(GRIDS),
              "an unbroken rerun's counters differ from phase 6's")
        rates.setdefault(every, []).append(
            (timings["steady_steps_per_sec"], len(saves16)))
    log(14, f"steady steps/s (snapshots a run): phase 6 without snapshots "
            f"{t6_timings['steady_steps_per_sec']:.4e}; in turns without "
            f"{[f'{r:.4e}' for r, _ in rates[None]]}, every 16th chunk "
            f"{[f'{r:.4e} ({n})' for r, n in rates[16]]}")
    # counters bitwise; the grids to RESUME_GRID_RTOL a bin
    counters = ("launched", "steps", "specular", "absorbed")
    differ = differing_fields(got, t6)
    check(not set(differ) & set(counters), f"resumed counters differ: "
                                           f"{differ}")
    d_res, d_run = grid_diffs(got, t6), grid_diffs(reruns[0], t6)
    log(14, f"resumed against phase 6, per grid (bitwise-equal share of "
            f"bins, max abs difference, max relative): {d_res}; an unbroken "
            f"rerun against phase 6: {d_run}")
    for g in GRIDS:
        check(d_res[g][2] <= RESUME_GRID_RTOL,
              f"{g}: the resumed run differs from phase 6's by "
              f"{d_res[g][2]:.3e} of a bin (an unbroken rerun by "
              f"{d_run[g][2]:.3e})")


def phase14_resumable(tmp):
    """``simulate_resumable`` at 1e6 photons in 10 batches, interrupted
    after 4 and resumed, against an unbroken run, on the MCML slab (its
    photons leave within tens of steps, and the superstep engine's
    supersteps cost host time: four-step rounds)."""
    m = LayeredMedium.build([MediumConfig(mu_a=10.0, mu_s=90.0, g=0.75,
                                          n=1.0, thickness=0.02)],
                            device=DEV)
    cfg = PhotonRunConfig(n_photons=1_000_000, nr=50, nz=50, dr=0.002,
                          dz=0.002, steps_per_batch=4)
    kw = dict(seed=3, n_batches=10, lanes=1 << 17)
    t0 = time.perf_counter()
    full = ckpt.simulate_resumable(m, cfg,
                                   checkpoint_path=os.path.join(tmp, "a"),
                                   **kw)
    t_full = time.perf_counter() - t0
    path = os.path.join(tmp, "b")
    try:
        with killed_after(4):
            ckpt.simulate_resumable(m, cfg, checkpoint_path=path, **kw)
        check(False, "simulate_resumable was not interrupted")
    except Killed:
        pass
    _, _, done = ckpt.load_tallies(path, DEV)
    resumed = ckpt.simulate_resumable(m, cfg, checkpoint_path=path, **kw)
    differ = differing_fields(resumed, full)
    n = cfg.n_photons
    r, tt = full.total_reflectance(), full.total_transmittance()
    log(14, f"simulate_resumable 1e6 in 10 batches: unbroken {t_full:.2f} s, "
            f"interrupted after {done} and resumed: fields not bitwise equal "
            f"{differ}; launched {resumed.n_launched}, R {r:.5f} (0.09739), "
            f"T {tt:.5f} (0.66096), energy {full.energy_total():.8f}", t0)
    check(done == 4, f"the interrupted run saved {done} batches")
    check(differ == [], f"resumed differs from unbroken in {differ}")
    check(full.n_launched == n, "launch count")
    check(mc_parity_3sigma(r, 0.09739, binomial_stderr(0.09739, n),
                           abs_floor=1e-3), f"MCML slab R {r}")
    check(mc_parity_3sigma(tt, 0.66096, binomial_stderr(0.66096, n),
                           abs_floor=2e-3), f"MCML slab T {tt}")


def phase14_hg_sweep():
    """Each of the 18 hg_sweep configurations through ``simulate_kernel``
    at 1e5 photons: exact launches, energy closed; the albedo-0.9 g = 0
    cell against van de Hulst; the g = 0 cells against the superstep
    engine at the same count."""
    t0 = time.perf_counter()
    rows = []
    for i, (label, m, cfg) in enumerate(hg_sweep(device=DEV)):
        cfg = dataclasses.replace(cfg, n_photons=HG_N)
        t1 = time.perf_counter()
        t = pk.simulate_kernel(m, cfg, seed=100 + i, device=DEV)
        rd = t.total_reflectance()
        row = f"{label}: R_d {rd:.5f}, energy {t.energy_total():.8f}, " \
              f"{time.perf_counter() - t1:.2f} s"
        check(t.n_launched == HG_N, f"{label}: launched {t.n_launched}")
        check(abs(t.energy_total() - 1.0) < 1e-4,
              f"{label}: energy {t.energy_total()}")
        if float(m.g[0]) == 0.0:
            t1 = time.perf_counter()
            s = simulate_photons(m, cfg, 200 + i, lanes=1 << 17, device=DEV)
            rs = s.total_reflectance()
            se = math.hypot(binomial_stderr(rd, HG_N),
                            binomial_stderr(rs, HG_N))
            row += f"; superstep R_d {rs:.5f} (3 sigma {3 * se:.5f}, " \
                   f"{time.perf_counter() - t1:.2f} s)"
            check(s.n_launched == HG_N, f"{label}: superstep launches")
            check(mc_parity_3sigma(rd, rs, se),
                  f"{label}: kernel R_d {rd} vs superstep {rs}")
            if float(m.mu_a[0]) == 10.0 and float(m.mu_s[0]) == 90.0:
                se_v = binomial_stderr(VAN_DE_HULST_RD, HG_N)
                row += f"; van de Hulst {VAN_DE_HULST_RD}"
                check(mc_parity_3sigma(rd, VAN_DE_HULST_RD, se_v,
                                       abs_floor=1e-3),
                      f"{label}: R_d {rd} vs van de Hulst")
        rows.append(row)
        log(14, "hg_sweep " + row)
    log(14, f"hg_sweep: {len(rows)} configurations", t0)
    check(len(rows) == 18, f"hg_sweep gave {len(rows)} configurations")
    # what a superstep of the plain engine costs at the sweep's lanes: the
    # long-lived cells' tails take thousands of them
    steps = 50
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    run_fixed_steps(m, cfg, 1, HG_N, steps, device=DEV)
    torch.cuda.synchronize()
    host = (time.perf_counter() - t1) / steps * 1e3
    busy, launches, _ = device_profile(
        lambda: run_fixed_steps(m, cfg, 1, HG_N, steps, device=DEV))
    log(14, f"superstep engine, {HG_N} lanes: {host:.3f} ms a superstep by "
            f"the host clock, {busy / steps:.3f} ms of device time and "
            f"{launches / steps:.0f} kernel launches a superstep")


def phase14(t6, t6_timings):
    """The photon leftovers on the card: checkpointed runs and the HG
    sweep."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="lt_ckpt_") as tmp:
        phase14_resume(t6, t6_timings, tmp)
        phase14_resumable(tmp)
    phase14_hg_sweep()
    log(14, "phase 14 wall time", t0)


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
    names = ["photon_kernel", "intersect_kernel", "treelet_kernel",
             "probe_kernels"]
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
    launches, t6_timings, t6 = phase6()
    ms, plain_ms, bound, old_bound = phase7()
    log_gap("photon_block", launches, ms, bound[0])
    log_gap("photon_block (old bound)", launches, ms, old_bound)
    t0 = time.perf_counter()
    glass = glass_scene(device=DEV)
    mid = soft_shadow_scene(n_theta=44, n_phi=88)
    soft = soft_shadow_scene()
    log(8, f"scenes built: glass {glass[0].mesh.num_triangles} triangles, "
           f"15-cluster layout {mid.mesh.num_triangles}, soft shadow "
           f"{soft.mesh.num_triangles}", t0)
    mid_recs = phase8(glass, mid, soft)
    k3_launches, k3, k3_prof_ms = phase9(glass, mid, mid_recs)
    k4_launches, k4, cull, _ = phase10(soft)
    entries = [kernel_entry(
        "photon_block", "light_transport_tpu_torch/csrc/photon_kernel.cu",
        "light_transport_tpu/ops/pallas/photon_kernel.py:204", launches,
        max_err, ms, plain_ms, bound)]
    for rec, launched, replaces in (
            (k3, k3_launches,
             "light_transport_tpu/ops/pallas/intersect_kernel.py:67"),
            (k4, k4_launches["intersect_gather"],
             "light_transport_tpu/ops/pallas/intersect_kernel.py:129")):
        ms, plain_ms, bound, pairs, err, old = rec.kernel_and_plain()
        log(10, f"{rec.name} on its heaviest nearest-hit launch ({pairs} "
                f"pairs): kernel {ms:.3f} ms, plain "
                f"{plain_ms:.3f} ms, bound {bound[0]:.4f} ms ({bound[1]}; at "
                f"the data sheet's FP32 rate, an FMA counted as two, "
                f"{old:.4f} ms)")
        entries.append(kernel_entry(
            rec.name, "light_transport_tpu_torch/csrc/intersect_kernel.cu",
            replaces, launched, err, ms, plain_ms, bound))
        log_gap(rec.name, launched, rec.summary()[1], rec.mean_bound())
    log_gap("intersect_dense (profiler)", k3_launches, k3_prof_ms,
            k3.mean_bound())
    ms, plain_ms, bound, old = cull.kernel_and_plain()
    log(10, f"tile_cull on its heaviest query: kernel {ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms, bound {bound[0]:.4f} ms ({bound[1]}; at the "
            f"data sheet's FP32 rate {old:.4f} ms)")
    # not a TPU kernel: it replaces the XLA cull in front of K4
    entries.append(kernel_entry(
        "tile_cull", "light_transport_tpu_torch/csrc/intersect_kernel.cu",
        "light_transport_tpu/ops/pallas/intersect_kernel.py:276",
        k4_launches["tile_cull"], 0.0, ms, plain_ms, bound))
    log_gap("tile_cull", k4_launches["tile_cull"], cull.summary()[1],
            cull.mean_bound())
    del glass, mid, soft, mid_recs, k3, k4, cull
    scene, cfg, timings = big_mesh_scene()
    tab = scene.treelet
    check(tab is not None, "with_bvh attached no treelet tables")
    log(11, f"big-mesh scene: {scene.mesh.num_triangles} triangles, "
            f"{tab.num_nodes} BVH nodes, {tab.n_treelets} treelets of "
            f"{tab.T}, node and leaf records {tab.nbytes / 1e9:.3f} GB, "
            f"K5's 32-byte node records "
            f"{tab.node32.numel() * 4 / 1e6:.1f} MB; seconds: mesh "
            f"{timings['mesh_s']:.1f}, tree build {timings['build_s']:.1f}, "
            f"skip ropes {timings['skip_s']:.2f}, fused and 32-byte records "
            f"{timings['records_s']:.1f}, all {timings['total_s']:.1f}")
    check(tab.node is scene.bvh.node_rec and tab.leaf is scene.bvh.leaf_rec
          and tab.node32 is scene.bvh.node32,
          "the treelet tables copied the BVH's records")
    phase11(scene, cfg)
    k5_launches, recs, prof_ms = phase12(scene, cfg)
    for rec in recs:
        ms, plain_ms, bound, _, err = rec.kernel_and_plain()
        entries.append(kernel_entry(
            rec.name, "light_transport_tpu_torch/csrc/treelet_kernel.cu",
            "light_transport_tpu/ops/pallas/treelet_kernel.py:204",
            k5_launches[rec.name], err, ms, plain_ms, bound))
        log_gap(rec.name, k5_launches[rec.name], rec.summary()[1],
                rec.mean_bound())
        log_gap(f"{rec.name} (profiler)", k5_launches[rec.name],
                prof_ms[rec.name], rec.mean_bound())
    entries += phase13()
    phase14(t6, t6_timings)
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

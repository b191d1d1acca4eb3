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
     de Hulst's 0.41550, the g = 0 cells against the superstep engine
     within their combined 3 sigma, but for mu_a 0.1, mu_s 90, whose
     drain tail there takes minutes); a superstep of the superstep engine
     at the sweep's lanes (host time, device time, launches); the phase's
     wall time
 15. the sharded runs and the split Fresnel tracer (parallel/mesh.py,
     fresnel_mode="split"), each where its scene or run is at hand:
     after phase 10, render_sharded of the soft-shadow scene at 1 and 2
     shards (15d: bitwise phase 10's image at one shard, within JAX's
     2e-5 at two, launches of the cull kernel and K4 counted), the split
     tracer on the glass preset (15e: the card through K3 against the CPU
     through the plain versions from uniforms drawn once on the CPU, its
     mean radiance against the stochastic tracer's on the same lanes,
     iterations, K3 launches, host syncs and walls) and
     render_progressive in both Fresnel modes against a render of four
     times the samples regrouped into passes (15f); after phase 12,
     render_sharded of the big mesh (15d, K5 launches counted); after
     phase 14, phase 6's run through simulate_pallas_sharded in a
     one-rank NCCL group (15a: K1 launches counted, counters bitwise
     phase 6's, grids within 2^-16 of each bin beside an unbroken rerun,
     steady steps/s beside phase 6's), over two virtual shards on the
     card (15b: R_d within 3 sigma of phase 6's) and simulate_sharded
     (the superstep engine) over two shards against phase 5 (15c)
 16. the Whitted integrator, point lights and analytic primitives, each
     render's first and second wall, kernel launches, host syncs (by
     place) and device busy time under torch.profiler: after 15e, the
     hard-shadow preset (16a, card against CPU), Whitted on the soft-
     shadow scene through the cull kernel and K4 (16b, K4's and the
     cull's launches and mean time by CUDA events, a crop against the
     plain intersector), Whitted on glass through K3 (16c: the tree at
     depth 3 and the queue at depth 6 against the plain intersector, the
     queue against the tree at depth 3, supersteps), the point-light
     preset through the path tracer (16d, card against CPU) and the
     analytic sphere, diffuse and mirror, Whitted and path tracer (16e,
     card against CPU); after 15d's big mesh, that render with one point
     light (one more K5 launch a bounce; the bounce-1 point-light shadow
     rays bitwise the plain walk; a plain re-trace) and Whitted on the
     big mesh through K5 (a crop against the plain walk)
 17. the path tracer's remaining modes and the adaptive integrator, each
     render's walls, kernel launches, host syncs (by place) and device
     busy time as in 16: after 16e, the glass preset with transmittance
     shadows through K3 (17a: 15 launches, every one held bitwise, card
     against CPU) and tests/test_media.py's slab against exp(-sigma_t L);
     the soft-shadow scene with the Sobol' sampler and a lens through
     the cull kernel and K4 (17b: the Sobol' build bitwise the CPU's on
     all 1.6M lanes and timed alone, a crop against the plain
     intersector), examples/dof_compare.py's Cornell focused and
     misfocused and tests/test_dof.py's emitter; four progressive Sobol'
     passes of glass against one render of four times the samples (17c);
     lts_scene and glass with the watertight test (17d: no kernel, card
     against CPU, the shared-edge rays); the adaptive integrator on
     glass with both samplers (17e: the budget exact, every pixel
     explored; with Sobol' each round's allocation and then the image
     against the CPU's from the card's allocations); after 16's big
     mesh, that render with transmittance shadows through K5 (15
     launches, a crop bitwise the plain walk).  Comparisons that would
     take minutes at full width run on a contiguous crop of the render's
     lanes
 18. BDPT and the control variates, each render's walls, kernel launches,
     host syncs and device busy time as in 16: after 17e, BDPT on
     examples/bdpt_cornell.py's Cornell box (18a: one lanes dict drawn on
     the CPU and rendered on both devices, lanes and a crop's splat plane
     against the CPU beside a second card run of it, the unclipped image
     mean against the path tracer's within 3 sigma), on point_light_scene
     and examples/point_light.py's mixed scene (18b: the family and
     q_point, card against CPU), on glass through K3 (18c: the launches
     counted from integrators/bdpt.py's loops, every one held bitwise),
     on the soft-shadow scene at 4 spp through the cull kernel and K4
     (18d: the body's peak memory, a crop bitwise the plain
     intersector), render_cv exact on examples/lts_cornell.py's Cornell
     box and on glass at 8 spp, and 2,048 glass lanes' scores on the
     card against the CPU's and exact against fd (18f); after 17's big
     mesh, BDPT on it through K5 (18e: a crop bitwise the plain walk)
 19. the front ends (scripts/smoke_phase19.py runs it alone): after 18,
     render_bdpt_sharded at 1, 2 and 3 shards (19a), the CLI (19b), the
     soft-shadow sphere through an OBJ file (19c), the GUI server (19d)
     and the profiling helpers (19e)
 20. the glossy BSDF, the emission modes, the surface detectors and the
     example drivers (scripts/smoke_phase20.py runs it alone), after 19:
     examples/glossy_mis.py's plate (shininess 400) under
     emission_mode nee, mis and always, card against CPU; the glass
     preset with GLOSSY_MAT walls through K3 (every launch held bitwise,
     card against CPU), BDPT (every launch bitwise, card against CPU) and
     Whitted (against the plain intersector) on it; the soft-shadow scene
     with a glossy sphere through the cull kernel and K4, lanes
     72,000-87,999 re-traced through the plain intersector (20a);
     render_with_detectors on glass, its image bitwise render_image's,
     one record tallied on both devices and the card's trace against the
     CPU's, coplanar ties counted (20b); every examples_torch driver's
     main() at the JAX drivers' sizes, photon_mcml at 1e5 photons a run
     (20c: JSON lines, walls, K3 and K4 launches)
 21. tail compaction (RenderConfig.compact_tail; scripts/smoke_phase21.py
     runs it alone), after 20: each scene's lanes traced at full width and
     by trace_paths_compact, every lane bitwise, the widths by bounce the
     halving rule on the live counts, the live share per segment,
     launches and CUDA-event ms by kernel and width; then render_image
     and api.render with compact_tail=True, first and second walls, host
     syncs by place, device busy under the profiler, images bitwise: the
     fix1 Cornell box 300x300x50 d8 on the brute force (21a, the widths
     also the rule on the TraceRecord.alive counts), glass 100x100x16 d8
     through K3 (21b: every K3 launch at each width bitwise its plain
     version, api.render against render_image_compact, the detectors
     with and without the flag), the soft-shadow scene at depth 8 through
     the cull kernel and K4 (21c: K4 by width, the crop's lanes live after
     the first shrink bitwise the plain intersector); after 18's big
     mesh, that scene at depth 8 through K5 (21d) and one compacted
     render on the K5r wavefront route, bitwise
 22. the split tracer's stack_size and max_iters and the Whitted queue's
     weight_cutoff (scripts/smoke_phase22.py runs it alone), after 21c:
     glass 100x100x16 at depth 8 through trace_paths_split at stack_size
     1, 2 and the default (22a: iterations, K3 launches, the wall; a
     second run bitwise the first with every K3 launch held bitwise
     against the plain version; the card against the CPU on 20,000 lanes;
     the lane mean against trace_paths' from the same uniforms; stack
     size 1 apart from the default, so the full-stack fallback ran), at
     stack_size 2 cut at max_iters 3 (22b, card against CPU), and the
     Whitted queue on glass 100x100 at depth 4 at the default cutoff and
     at 1e-5 against the unrolled tree (22c: supersteps, K3 launches
     held bitwise, the tight cutoff within tests/test_whitted.py's
     limits)

The line before the last is the card's name and power limit; the last
line is {"ok": true, "device": {...}}.
"""

import contextlib
import ctypes
import dataclasses
import functools
from concurrent.futures import ThreadPoolExecutor
import io
import json
import math
import os
import re
import socket
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
from light_transport_tpu_torch.core import rng
from light_transport_tpu_torch.integrators import adaptive as ad
from light_transport_tpu_torch.integrators import bdpt as tb
from light_transport_tpu_torch.integrators import control_variates as cv
from light_transport_tpu_torch.integrators import path_tracer as pt
from light_transport_tpu_torch.integrators import whitted as tw
from light_transport_tpu_torch.models.presets import (
    full_scale,
    glass_scene,
    hard_shadow_scene,
    hg_sweep,
    lts_scene,
    multilayer_mismatch,
    point_light_scene,
)
from light_transport_tpu_torch.accel import bvh as bvh_mod
from light_transport_tpu_torch.ops import _build
from light_transport_tpu_torch.ops import dispatch
from light_transport_tpu_torch.ops import feature_probes as fp
from light_transport_tpu_torch.ops import intersect as ops_intersect
from light_transport_tpu_torch.ops import intersect_kernel as ik
from light_transport_tpu_torch.ops import photon_kernel as pk
from light_transport_tpu_torch.ops import qmc
from light_transport_tpu_torch.ops import raysort
from light_transport_tpu_torch.ops import treelet_kernel as tk
from light_transport_tpu_torch.parallel import mesh as pm
from light_transport_tpu_torch.scene.analytic import AnalyticPrims
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
    MATERIAL_FIELDS,
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
    return m, cfg, t_x


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
        ik.tile_cull = lambda *a, counts=None: ik.tile_cull_reference(*a)
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


def compare_launch(label, args, got, want, exact=False, quiet=False):
    """One launch's (best_t, best_tri) from the kernel against its plain
    version on the same operands, to phase 8's limits, or with ``exact``
    bitwise (nearest hit: t and triangle of every ray; any hit: the
    hit mask); returns the largest |t| difference where both hit (0 for
    an any-hit launch, whose t and triangle are whichever hit the kernel
    found first); ``quiet`` logs nothing."""
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
    if not quiet:
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

    def hold_every(self, label, quiet=False):
        """Every recorded launch again through the kernel and through its
        plain version on the same operands, bitwise (``quiet``: without a
        log line a launch).  Returns the number of kernel launches held
        (calls with rays)."""
        for k, (pairs, args) in enumerate(self.launched):
            mode = "any-hit" if args[-1] else "nearest"
            compare_launch(f"{label}, {self.name} launch {k} ({mode}, "
                           f"{int(pairs)} pairs)", args,
                           launch_counted(self.name, self.wrapped, args),
                           self.plain(*args[:-1]), exact=True, quiet=quiet)
        return sum(args[0].shape[0] > 0 for _, args in self.launched)

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

    def __call__(self, *args, counts=None):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = launch_counted(
            self.name, lambda *a: self.wrapped(*a, counts=counts), args)
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


def soft_shadow_scene(n_theta=176, n_phi=352, sphere=None):
    """examples/soft_shadow.py's scene from the port's modules: a
    123,200-triangle turquoise sphere on a floor under a 3x3 area light.
    At n_theta=44, n_phi=88 the sphere has 7,568 triangles: 7,572 in all,
    15 clusters, the top of K3's range.  ``sphere``: a TriangleMesh of
    material 0 in place of the built sphere."""
    floor = quad_triangles((-8, -0.5, -8), (-8, -0.5, 8), (8, -0.5, 8),
                           (8, -0.5, -8))
    lq = quad_triangles((-1.5, 6, -1.5), (1.5, 6, -1.5), (1.5, 6, 1.5),
                        (-1.5, 6, 1.5))
    if sphere is None:
        sph = sphere_triangles(center=(0, 1, 0), radius=1.5,
                               n_theta=n_theta, n_phi=n_phi)
        sphere = TriangleMesh.build(sph, np.zeros(len(sph), np.int32),
                                    device=DEV)
    mesh = concat_meshes([
        sphere,
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
    o, d, u = pt._camera_lanes(scene, cfg, 1)
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
    o, d, _ = pt._camera_lanes(scene, cam_cfg, 3)
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
    o, d, u = pt._camera_lanes(scene, cfg, 0)
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
    return launches, rec, cull, img


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
    o, d, u = pt._camera_lanes(scene, cam_cfg, 11)
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
            parts = (hit,) if any_hit else tuple(hit)[:3]
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
    o, d, u = pt._camera_lanes(scene, cfg, 0)
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
    return k5_launches, k5_recs, prof_ms, img


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
# the g = 0 cell (mu_a, mu_s) of albedo 0.9989 that the superstep engine
# does not run: its drain tail took 123.15 s of phase 14 at ~10 ms a
# superstep (NVIDIA H100 80GB HBM3, 700.00 W), for a check the other five
# g = 0 cells make in 1.2-16.1 s each
SUPERSTEP_SKIP = (0.1, 90.0)


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
    cell against van de Hulst; the g = 0 cells but SUPERSTEP_SKIP against
    the superstep engine at the same count."""
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
        skip = all(math.isclose(float(x[0]), v, rel_tol=1e-6)
                   for x, v in zip((m.mu_a, m.mu_s), SUPERSTEP_SKIP))
        if float(m.g[0]) == 0.0 and skip:
            row += ("; superstep engine not run: its drain tail took "
                    "123.15 s (~10 ms a superstep, NVIDIA H100 80GB HBM3, "
                    "700.00 W)")
        elif float(m.g[0]) == 0.0:
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


# --------------------------------------------------------------------------
# phase 15: the sharded runs and the split Fresnel tracer
# --------------------------------------------------------------------------

SPLIT_PASSES = 4
# JAX's own tolerance for a sharded render (tests/test_sharding.py:60)
SHARDED_ATOL = 2e-5


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def counters_equal(a, b):
    return all(torch.equal(getattr(a, f), getattr(b, f))
               for f in ("launched", "steps", "specular", "absorbed"))


def phase15_photon(t5, t6, t6_timings, launches6):
    """15a: the photon main path through simulate_pallas_sharded in a
    one-rank NCCL group, against phase 6's run; 15b: the same run over two
    virtual shards on the card; 15c: simulate_sharded (the superstep
    engine) over two shards against phase 5's run."""
    m, cfg = full_scale(DEV)
    n = MAIN_N
    cfg = dataclasses.replace(cfg, n_photons=n)
    t0 = time.perf_counter()
    mesh = pm.init_multihost(f"localhost:{free_port()}", 1, 0)
    log("15a", f"init_multihost: one-rank {torch.distributed.get_backend()} "
               f"group, mesh {mesh.n_shards} shard on {mesh.devices[0]} "
               f"[{smi()}]", t0)
    timings = {}
    pk.LAUNCHES = 0
    t0 = time.perf_counter()
    t = pm.simulate_pallas_sharded(m, cfg, seed=0, mesh=mesh,
                                   lanes_per_device=MAIN_LANES,
                                   timings=timings)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = pk.LAUNCHES
    rerun = pk.simulate_kernel(m, cfg, seed=0, lanes=MAIN_LANES, device=DEV)
    d_sh, d_run = grid_diffs(t, t6), grid_diffs(rerun, t6)
    log("15a", f"sharded K1, 1 shard: launched {t.n_launched}, steps "
               f"{t.n_steps}, kernel launches {launches} (phase 6 "
               f"{launches6}), counters bitwise phase 6's "
               f"{counters_equal(t, t6)}; steady "
               f"{timings['steady_steps_per_sec']:.4e} steps/s (phase 6 "
               f"{t6_timings['steady_steps_per_sec']:.4e}), "
               f"{timings['ms_per_block']:.3f} ms/block, wall {wall:.2f} s "
               f"[{smi()}]")
    log("15a", f"against phase 6, per grid (bitwise-equal share, max abs, "
               f"max rel): {d_sh}; an unbroken simulate_kernel rerun "
               f"against phase 6: {d_run}")
    check(t.n_launched == n, f"15a launched {t.n_launched}")
    check(launches > 0, "15a: the sharded run launched no K1")
    check(counters_equal(t, t6), "15a: counters differ from phase 6's")
    check(launches == launches6, "15a: not phase 6's kernel launches")
    for g, (_, _, rel) in d_sh.items():
        check(rel <= RESUME_GRID_RTOL,
              f"15a {g}: {rel} of a bin from phase 6's")
    rd6 = t6.total_reflectance()
    se = binomial_stderr(rd6, n) * math.sqrt(2.0)
    timings = {}
    pk.LAUNCHES = 0
    t0 = time.perf_counter()
    t2 = pm.simulate_pallas_sharded(m, cfg, seed=0, mesh=pm.make_mesh(2),
                                    lanes_per_device=MAIN_LANES,
                                    timings=timings)
    torch.cuda.synchronize()
    log("15b", f"sharded K1, 2 virtual shards on the card: launched "
               f"{t2.n_launched}, kernel launches {pk.LAUNCHES}, R_d "
               f"{t2.total_reflectance():.6f} (phase 6 {rd6:.6f}, 3 sigma "
               f"{3 * se:.6f}), energy {t2.energy_total():.8f}, steady "
               f"{timings['steady_steps_per_sec']:.4e} steps/s [{smi()}]",
        t0)
    check(t2.n_launched == n, f"15b launched {t2.n_launched}")
    check(pk.LAUNCHES > 0, "15b: no K1 launched")
    check(mc_parity_3sigma(t2.total_reflectance(), rd6, se),
          f"15b R_d {t2.total_reflectance()}")
    m5, cfg5, tx5 = t5
    n5 = cfg5.n_photons
    t0 = time.perf_counter()
    tx = pm.simulate_sharded(m5, cfg5, seed=13, mesh=pm.make_mesh(2))
    torch.cuda.synchronize()
    rd5 = tx5.total_reflectance()
    se5 = binomial_stderr(rd5, n5) * math.sqrt(2.0)
    log("15c", f"simulate_sharded (superstep engine) 2e5 over 2 shards: "
               f"launched {tx.n_launched}, R_d {tx.total_reflectance():.5f} "
               f"(phase 5 {rd5:.5f}, 3 sigma {3 * se5:.5f}), energy "
               f"{tx.energy_total():.6f} [{smi()}]", t0)
    check(tx.n_launched == n5, f"15c launched {tx.n_launched}")
    check(mc_parity_3sigma(tx.total_reflectance(), rd5, se5, abs_floor=1e-3),
          f"15c R_d {tx.total_reflectance()}")
    torch.distributed.destroy_process_group()


def phase15_render(label, scene, cfg, ref, counts, names):
    """15d: render_sharded at 1 and 2 shards, two calls each, against the
    main path's render_image (``ref``): bitwise at one shard, within JAX's
    2e-5 at two; the first call's kernel launches counted from 0
    (``counts`` is the module's LAUNCHES, ``names`` the kernels that must
    launch)."""
    for k in (1, 2):
        for name in counts:
            counts[name] = 0
        walls = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            img = pm.render_sharded(scene, cfg, seed=0, mesh=pm.make_mesh(k))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            if len(walls) == 1:
                launched = dict(counts)
        err = float((img - ref).abs().max())
        same = bool(torch.equal(img, ref))
        log("15d", f"{label} render_sharded at {k} shard(s): bitwise "
                   f"render_image {same}, max abs diff {err:.3g}, launches "
                   f"{launched}, first call {walls[0]:.4f} s, second "
                   f"{walls[1]:.4f} s [{smi()}]")
        for name in names:
            check(launched[name] > 0, f"15d {label}, {k}: no {name} launch")
        if k == 1:
            check(same, f"15d {label}: one shard not bitwise render_image")
        check(err <= SHARDED_ATOL, f"15d {label}, {k} shards: {err}")


def pass_images(samples, k):
    """A render's (H, W, k * spp, 3) samples regrouped into k passes of spp
    samples: the k pass images (k, H, W, 3), each clipped to [0, 1] as a
    render clips its image (render_progressive's estimator)."""
    h, w, n, _ = samples.shape
    return samples.reshape(h, w, k, n // k, 3).mean(3).clamp(0, 1).permute(
        2, 0, 1, 3)


def passes_stderr(imgs):
    """Standard error of the mean of k pass images' average (k, H, W, 3):
    each pixel's spread over the passes, pixels independent."""
    x = imgs.double().mean(dim=-1)
    return math.sqrt(float(x.var(dim=0).sum()) / x.shape[0]) / x[0].numel()


def phase15_split(glass):
    """15e: the split tracer on the glass preset, the card (K3) against
    the CPU (plain versions) from uniforms drawn once on the CPU, and its
    image mean against the stochastic render's; 15f: render_progressive,
    stochastic and split, against a render of SPLIT_PASSES times the
    samples."""
    scene, cfg = glass
    scene_cpu, _ = glass_scene(device="cpu")
    split_cfg = dataclasses.replace(cfg, fresnel_mode="split")
    o, d, u = pt._camera_lanes(scene_cpu, cfg, 7)
    ik.LAUNCHES["intersect_dense"] = 0
    stats = {}
    t0 = time.perf_counter()
    rad = pt.trace_paths_split(scene, cfg, o.to(DEV), d.to(DEV), u.to(DEV),
                               stats=stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k3 = ik.LAUNCHES["intersect_dense"]
    t0 = time.perf_counter()
    rad_cpu = pt.trace_paths_split(scene_cpu, cfg, o, d, u)
    cpu_s = time.perf_counter() - t0
    rad_st = pt.trace_paths(scene, cfg, o.to(DEV), d.to(DEV), u.to(DEV))[0]
    rad, rad_st = rad.cpu(), rad_st.cpu()
    close = torch.isclose(rad, rad_cpu, rtol=1e-3, atol=1e-6).all(dim=1)
    frac = float(close.float().mean())
    img, img_st = pt._to_image(rad, cfg)[0], pt._to_image(rad_st, cfg)[0]
    img_err = float((img - pt._to_image(rad_cpu, cfg)[0]).abs().mean())
    log("15e", f"split tracer, glass {cfg.width}x{cfg.height}x{cfg.spp} "
               f"depth {cfg.max_depth}: {stats['iterations']} iterations, "
               f"K3 launches {k3}, card {wall:.3f} s, CPU (plain) "
               f"{cpu_s:.2f} s; card against CPU: {frac:.5f} of lanes "
               f"within rtol 1e-3, mean abs image diff {img_err:.3g} "
               f"[{smi()}]")
    check(k3 > 0, "15e: the split tracer launched no K3")
    check(frac >= 0.99, f"15e: {frac} of lanes agree with the CPU")
    check(img_err < 2e-3, f"15e: mean abs image diff {img_err}")
    # both estimators have the same mean before the image's [0, 1] clip;
    # after it the split's lower variance loses less to the clip, so the
    # clipped means are logged and the unclipped ones held, lane by lane
    # on the same uniforms
    diff = (rad - rad_st).double().mean(dim=1)
    se = float(diff.std()) / math.sqrt(diff.numel())
    se_img = passes_stderr(pass_images(pt._to_image(rad_st, cfg)[1],
                                       cfg.spp))
    log("15e", f"mean radiance before the clip: split "
               f"{float(rad.double().mean()):.5f}, stochastic "
               f"{float(rad_st.double().mean()):.5f}, paired difference "
               f"{float(diff.mean()):.5f} (standard error {se:.5f}); "
               f"clipped image means {float(img.mean()):.5f} and "
               f"{float(img_st.mean()):.5f} (standard error {se_img:.6f})")
    check(bool(torch.isfinite(img).all()), "15e: split image not finite")
    check(abs(float(diff.mean())) < 4 * se,
          f"15e: split against stochastic {float(diff.mean())} +- {se}")
    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pt.render_image_split(scene, split_cfg, seed=3)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    syncs = count_syncs(lambda: lt.render(scene, split_cfg, seed=3))
    log("15e", f"render_image_split: first call {walls[0]:.4f} s, second "
               f"{walls[1]:.4f} s, host syncs a render {syncs} [{smi()}]")
    wide = dataclasses.replace(cfg, spp=cfg.spp * SPLIT_PASSES)
    ow, dw, uw = pt._camera_lanes(scene, wide, 11)
    for c in (cfg, split_cfg):
        if c.fresnel_mode == "split":
            rad_w = pt.trace_paths_split(scene, wide, ow, dw, uw)
        else:
            rad_w = pt.trace_paths(scene, wide, ow, dw, uw)[0]
        ref_img, samples = pt._to_image(rad_w, wide)
        ref = pass_images(samples, SPLIT_PASSES)
        se = passes_stderr(ref) * math.sqrt(2.0)
        ik.LAUNCHES["intersect_dense"] = 0
        t0 = time.perf_counter()
        prog = pt.render_progressive(scene, c, seed=12,
                                     n_passes=SPLIT_PASSES)
        torch.cuda.synchronize()
        k3 = ik.LAUNCHES["intersect_dense"]
        mean, want = float(prog.mean()), float(ref.mean())
        log("15f", f"render_progressive, {SPLIT_PASSES} passes, "
                   f"{c.fresnel_mode}: K3 launches {k3}, mean {mean:.5f} "
                   f"against a {wide.spp}-spp render's {want:.5f} in "
                   f"{SPLIT_PASSES} "
                   f"passes (combined standard error {se:.6f}; clipped as "
                   f"one image {float(ref_img.mean()):.5f}) [{smi()}]", t0)
        check(k3 > 0, "15f: the progressive render launched no K3")
        check(bool(torch.isfinite(prog).all()), "15f: not finite")
        check(float(prog.min()) >= 0.0 and float(prog.max()) <= 1.0,
              "15f: outside [0, 1]")
        check(abs(mean - want) < 4 * se, f"15f {c.fresnel_mode}: mean {mean}")

# --------------------------------------------------------------------------
# phase 16: the Whitted integrator, point lights, analytic primitives
# --------------------------------------------------------------------------

# 15e's limits for a card against the CPU: pixels (or lanes) within 1e-3,
# mean absolute difference
CPU_PIXELS, CPU_WITHIN, CPU_MEAN = 0.995, 1e-3, 1e-3
# PERF.md's render parity, for a kernel against its plain version
PLAIN_PIXELS, PLAIN_WITHIN, PLAIN_MEAN = 0.99, 1e-3, 2e-3
# contiguous lanes of a render re-traced through a plain version or on the
# CPU, where the full width would take minutes there
CROP_SOFT = 16_000  # soft shadow: rows 180-219 of 400
CROP_ROWS = (150, 250)  # 400x400 Whitted renders rendered again on the CPU
CROP_CPU = 20_000  # path renders traced again on the CPU
CROP_BIG = 2_048  # big-mesh Whitted through the plain walk
WHITTED_QUEUE_ATOL = 6e-3  # tests/test_whitted.py's queue-against-tree


def device_busy(fn):
    """(device ms, kernel launches) of one ``fn()`` under torch.profiler,
    the device's activity only (a render's host events would take the
    profiler seconds to sort)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    return (sum(e.self_device_time_total for e in rows) / 1e3,
            sum(e.count for e in rows))


def render_numbers(label, fn, phase=16):
    """A render ``fn()`` twice, its kernel launches counted from 0 on the
    first call; its host syncs on a third and its device busy time under
    torch.profiler on a fourth.  Returns (first image, launches, second
    wall in s)."""
    t_all = time.perf_counter()
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = fn()
    torch.cuda.synchronize()
    wall1 = time.perf_counter() - t0
    launched = {k: v for k, v in {**ik.LAUNCHES, **tk.LAUNCHES}.items()
                if v}
    check(bvh_mod.PLAIN_WALKS == 0, f"{phase} {label}: the plain walk ran")
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall2 = time.perf_counter() - t0
    where = {}
    syncs = count_syncs(fn, where)
    busy, n_launch = device_busy(fn)
    log(phase, f"{label}: first call {wall1:.4f} s, second {wall2:.4f} s; "
            f"kernel launches {launched}; host syncs {syncs}; device busy "
            f"{busy:.3f} ms under the profiler ({busy / (wall2 * 1e3):.3f} "
            f"of the second call's wall), {n_launch} launches; syncs by "
            f"place " + ", ".join(f"{k} x{v}" for k, v in sorted(
                where.items())) + f" [{smi()}]", t_all)
    check(bool(torch.isfinite(img).all()), f"{phase} {label}: not finite")
    return img, launched, wall2


def parity(label, got, want, limits, phase=16):
    """Pixels (rows of 3) of ``got`` within ``limits[1]`` of ``want`` in
    every channel, at least a share ``limits[0]`` of them, and a mean
    absolute difference under ``limits[2]``."""
    share, within, mean = limits
    g = got.reshape(-1, 3).double().cpu()
    w = want.reshape(-1, 3).double().cpu()
    diff = (g - w).abs()
    frac = float((diff <= within).all(dim=1).double().mean())
    mad = float(diff.mean())
    log(phase, f"{label}: {frac:.5f} of {g.shape[0]} pixels within "
               f"{within}, mean abs diff {mad:.3g}, max "
               f"{float(diff.max()):.3g}")
    check(frac >= share, f"{phase} {label}: {frac} of pixels within "
                         f"{within}")
    check(mad < mean, f"{phase} {label}: mean abs diff {mad}")


def whitted_crop(scene, cfg, lo, n, queue=False):
    """Lanes ``lo`` to ``lo + n`` of ``render_whitted``'s primary rays
    traced by the unrolled tree (or the queue), clipped as the render
    clips."""
    o, d = tw._primary_rays(scene, cfg)
    o, d = o[lo:lo + n], d[lo:lo + n]
    trace = tw.trace_whitted_queue if queue else tw.trace_whitted
    return trace(scene, o, d, cfg.max_depth).clamp(0.0, 1.0)


def whitted_render(scene, cfg):
    return lt.render(scene, cfg, seed=0, integrator="whitted")


def whitted_against_cpu(label, img, scene_cpu, cfg):
    """Rows CROP_ROWS of a card's 400x400 Whitted image against the same
    rows rendered on the CPU, to 15e's limits."""
    lo, hi = (r * cfg.width for r in CROP_ROWS)
    t0 = time.perf_counter()
    cpu = whitted_crop(scene_cpu, cfg, lo, hi - lo)
    log(16, f"{label}: CPU render of lanes {lo}-{hi} (rows {CROP_ROWS[0]}-"
            f"{CROP_ROWS[1] - 1}, a crop) {time.perf_counter() - t0:.2f} s")
    parity(f"{label} card against CPU (crop)", img.reshape(-1, 3)[lo:hi],
           cpu, (CPU_PIXELS, CPU_WITHIN, CPU_MEAN))


def phase16a():
    """The hard-shadow preset (16 triangles: the brute force, no kernel)
    on the card against the port's CPU render of the same rays."""
    scene, cfg = hard_shadow_scene(device=DEV)
    img, launched, _ = render_numbers(
        f"16a hard_shadow_scene {cfg.width}x{cfg.height} Whitted depth "
        f"{cfg.max_depth}", lambda: whitted_render(scene, cfg))
    check(not launched, f"16a: kernels launched {launched}")
    whitted_against_cpu("16a hard_shadow_scene", img,
                        hard_shadow_scene(device="cpu")[0], cfg)
    check(float(img.mean()) > 0.01, "16a: black image")


def phase16b(soft):
    """Whitted on the soft-shadow scene through the cull kernel and K4,
    a crop held against the plain intersector."""
    cfg = dataclasses.replace(SOFT_SHADOW_CFG, spp=1)
    img, launched, _ = render_numbers(
        f"16b soft shadow {cfg.width}x{cfg.height} Whitted depth "
        f"{cfg.max_depth}", lambda: whitted_render(soft, cfg))
    for name in ("tile_cull", "intersect_gather"):
        check(launched.get(name, 0) > 0, f"16b: no {name} launch")
    t0 = time.perf_counter()
    with Recorder("intersect_gather") as rec, CullRecorder() as cull:
        whitted_render(soft, cfg)
        torch.cuda.synchronize()
    n, ms, pairs = rec.summary()
    nc, cull_ms = cull.summary()
    log(16, f"16b K4: {n} launches, {ms:.4f} ms mean by CUDA events, "
            f"admitted pairs per launch {pairs}; cull: {nc} launches, "
            f"{cull_ms:.4f} ms mean [{smi()}]", t0)
    lo = 180 * cfg.width
    t0 = time.perf_counter()
    with plain_intersector():
        plain = whitted_crop(soft, cfg, lo, CROP_SOFT)
    log(16, f"16b plain intersector on lanes {lo}-{lo + CROP_SOFT} "
            f"(a crop) {time.perf_counter() - t0:.2f} s")
    parity("16b kernels against the plain intersector (crop)",
           img.reshape(-1, 3)[lo:lo + CROP_SOFT], plain,
           (PLAIN_PIXELS, PLAIN_WITHIN, PLAIN_MEAN))


def phase16c(glass):
    """Whitted on the glass preset through K3: the unrolled tree at depth
    3, the queue (on ops/lanestack) at depth 6, both against the plain
    intersector; the queue at depth 3 against the tree."""
    scene, cfg = glass
    cfg3 = dataclasses.replace(cfg, max_depth=3)
    cfg6 = dataclasses.replace(cfg, max_depth=6)
    n = cfg.width * cfg.height
    imgs = {}
    for c in (cfg3, cfg6):
        imgs[c.max_depth], launched, _ = render_numbers(
            f"16c glass {c.width}x{c.height} Whitted depth {c.max_depth} "
            f"({'queue' if c.max_depth > tw.UNROLL_MAX_DEPTH else 'tree'})",
            lambda c=c: whitted_render(scene, c))
        check(launched.get("intersect_dense", 0) > 0, "16c: no K3 launch")
    o, d = tw._primary_rays(scene, cfg3)
    stats = {}
    tw.trace_whitted_queue(scene, o, d, 6, stats=stats)
    tree = tw.trace_whitted(scene, o, d, 3)
    qstats = {}
    queue = tw.trace_whitted_queue(scene, o, d, 3, stats=qstats)
    err = float((queue - tree).abs().max())
    log(16, f"16c the queue: {stats['supersteps']} supersteps at depth 6, "
            f"{qstats['supersteps']} at depth 3; queue against tree at "
            f"depth 3 max abs diff {err:.3g} (limit {WHITTED_QUEUE_ATOL})")
    check(err <= WHITTED_QUEUE_ATOL, f"16c: queue against tree {err}")
    t0 = time.perf_counter()
    with plain_intersector():
        plain3 = whitted_crop(scene, cfg3, 0, n)
        plain6 = whitted_crop(scene, cfg6, 0, n, queue=True)
    log(16, f"16c plain intersector, both depths, every lane "
            f"{time.perf_counter() - t0:.2f} s")
    parity("16c tree (depth 3) against the plain intersector", imgs[3],
           plain3, (PLAIN_PIXELS, PLAIN_WITHIN, PLAIN_MEAN))
    parity("16c queue (depth 6) against the plain intersector", imgs[6],
           plain6, (PLAIN_PIXELS, PLAIN_WITHIN, PLAIN_MEAN))


def paths_against_cpu(label, scene, scene_cpu, cfg, seed, phase=16):
    """The path tracer on the card (every lane) and on the CPU (the first
    CROP_CPU lanes) from uniforms drawn once on the CPU."""
    o, d, u = pt._camera_lanes(scene_cpu, cfg, seed)
    rad = pt.trace_paths(scene, cfg, o.to(DEV), d.to(DEV), u.to(DEV))[0]
    t0 = time.perf_counter()
    k = min(CROP_CPU, o.shape[0])
    rad_cpu = pt.trace_paths(scene_cpu, cfg, o[:k], d[:k], u[:k])[0]
    log(phase, f"{label}: CPU trace of lanes 0-{k} of {o.shape[0]} "
               f"{time.perf_counter() - t0:.2f} s")
    parity(f"{label} card against CPU (lanes' radiance)", rad[:k], rad_cpu,
           (CPU_PIXELS, CPU_WITHIN, CPU_MEAN), phase)


def phase16d():
    """The point-light preset through the path tracer (28 triangles: the
    brute force, no kernel), card against CPU."""
    scene, cfg = point_light_scene(device=DEV)
    img, launched, _ = render_numbers(
        f"16d point_light_scene {cfg.width}x{cfg.height}x{cfg.spp} depth "
        f"{cfg.max_depth} (path tracer)", lambda: lt.render(scene, cfg))
    # the Cornell box's 28 triangles take the brute force
    check(not launched, f"16d: kernels launched {launched}")
    check(float(img.mean()) > 0.01, "16d: black image")
    paths_against_cpu("16d point_light_scene", scene,
                      point_light_scene(device="cpu")[0], cfg, 7)


def analytic_scene(sphere_mat, device):
    """tests/test_analytic.py's scene: a floor, a ceiling light and one
    analytic sphere of material ``sphere_mat``, at 400x400, 8 spp, depth
    3."""
    floor = quad_triangles((-20, -1, -20), (-20, -1, 20), (20, -1, 20),
                           (20, -1, -20))
    lq = quad_triangles((-2, 8, -3), (2, 8, -3), (2, 8, 1), (-2, 8, 1))
    mesh = TriangleMesh.build(np.concatenate([floor, lq]),
                              np.asarray([0, 0, 1, 1], np.int32),
                              np.asarray([False, False, True, True]),
                              device=device)
    mats = MaterialTable.build([
        Material(color=presets.GREY),
        Material(color=presets.WHITE, emission=6.0), sphere_mat],
        device=device)
    prims = AnalyticPrims.build(spheres=[((0.0, 0.0, -1.0), 1.0, 2)],
                                device=device)
    scene = Scene.build(mesh, mats, camera=[0.0, 1.0, 6.0], analytic=prims)
    cfg = RenderConfig(width=400, height=400, spp=8, max_depth=3,
                       f_distance=3.0)
    return scene, cfg


ANALYTIC_SPHERES = {
    "diffuse": Material(color=presets.TURQUOISE),
    "mirror": Material(color=presets.SILVER, is_diffuse=False,
                       is_mirror=True, reflection=1.0),
}


def phase16e():
    """The analytic sphere, diffuse and mirror: Whitted and the path
    tracer, card against CPU."""
    for name, mat in ANALYTIC_SPHERES.items():
        scene, cfg = analytic_scene(mat, DEV)
        scene_cpu, _ = analytic_scene(mat, "cpu")
        img, _, _ = render_numbers(
            f"16e analytic {name} sphere {cfg.width}x{cfg.height} Whitted "
            f"depth {cfg.max_depth}", lambda: whitted_render(scene, cfg))
        whitted_against_cpu(f"16e {name} sphere Whitted", img, scene_cpu,
                            cfg)
        img, _, _ = render_numbers(
            f"16e analytic {name} sphere {cfg.width}x{cfg.height}x"
            f"{cfg.spp} depth {cfg.max_depth} (path tracer)",
            lambda: lt.render(scene, cfg))
        check(float(img.mean()) > 0.01, f"16e {name}: black image")
        paths_against_cpu(f"16e {name} sphere", scene, scene_cpu, cfg, 9)


def phase16(glass, soft):
    """16a-16e but the big mesh (phase16_big, after phase 12)."""
    t0 = time.perf_counter()
    phase16a()
    phase16b(soft)
    phase16c(glass)
    phase16d()
    phase16e()
    wall = time.perf_counter() - t0
    log(16, f"16a-16e done", t0)
    return wall


def point_light_shadow_rays(scene, cfg):
    """The point-light shadow query of bounce 1 of phase 11's 65,536
    camera lanes, as the path tracer makes it: (origins, directions,
    max_dist, active, the dispatch's answer)."""
    cam_cfg = dataclasses.replace(cfg, spp=1)
    o, d, u = pt._camera_lanes(scene, cam_cfg, 11)
    state, _ = pt._bounce(scene, cfg, pt.PathState.initial(o, d), u[:, 0], 0,
                          coherent=True)
    calls, fn = [], pt.scene_occluded

    def spy(*a, **k):
        out = fn(*a, **k)
        calls.append((a, k, out))
        return out

    pt.scene_occluded = spy
    try:
        pt._bounce(scene, cfg, state, u[:, 1], 1)
    finally:
        pt.scene_occluded = fn
    check(len(calls) == 2, f"bounce 1 made {len(calls)} any-hit queries")
    (_, bo, bd, md), k, occ = calls[1]  # the area light's, then the point's
    return bo, bd, md, k["active"], occ


def phase16_big(scene, cfg):
    """The big-mesh render with one point light (one more K5 any-hit
    launch a bounce), its bounce-1 point-light shadow rays against the
    plain walk bitwise, a re-trace; then Whitted on the big mesh through
    K5, a crop against the plain walk."""
    t0 = time.perf_counter()
    lit = scene.with_point_lights([[0.0, 3.0, 0.0]], [[50.0, 50.0, 50.0]])
    img, launched, _ = render_numbers(
        f"16d big mesh {cfg.width}x{cfg.height}x{cfg.spp} depth "
        f"{cfg.max_depth} with a point light (path tracer)",
        lambda: lt.render(lit, cfg, seed=0))
    check(launched.get("treelet_walk", 0) == 3 * cfg.max_depth,
          f"16d: K5 launches {launched}, expected {3 * cfg.max_depth}")
    check(sum(ik.LAUNCHES.values()) == 0, "16d: cluster kernels launched")
    bo, bd, md, act, occ = point_light_shadow_rays(lit, cfg)
    t_hi = torch.where(act, md, float("-inf"))
    with plain_treelet():
        want = tk.intersect_bvh_treelet(bo, bd, lit.treelet, t_max=t_hi,
                                        any_hit=True, with_stats=True)
    got = sorted_single(lit.mesh)(bo, bd, lit.treelet, t_max=t_hi,
                                  any_hit=True, with_stats=True)
    n_hit = same_hits("16d point-light shadow rays", got, want)
    check(torch.equal(occ, got[0]), "16d: the dispatch's answer differs")
    log(16, f"16d point-light shadow rays of bounce 1: {bo.shape[0]} rays "
            f"({int(act.sum())} active), {n_hit} occluded; bitwise equal "
            f"to the plain walk in the mask and per-ray visits")
    n_lanes = cfg.width * cfg.height * cfg.spp
    o, d, u = pt._camera_lanes(lit, cfg, 0)
    lanes = torch.arange(0, n_lanes, 97, device=DEV)
    with plain_treelet():
        rad_p, _ = pt.trace_paths(lit, cfg, o[lanes], d[lanes], u[lanes])
    _, samples = pt.render_image(lit, cfg, seed=0, return_samples=True)
    rad_k = samples.permute(2, 0, 1, 3).reshape(-1, 3)[lanes]
    close = torch.isclose(rad_k, rad_p, rtol=1e-3, atol=1e-6).all(dim=1)
    frac = float(close.float().mean())
    log(16, f"16d big mesh with a point light: plain re-trace of "
            f"{lanes.shape[0]} lanes {frac:.5f} within rtol 1e-3; image "
            f"mean {float(img.mean()):.5f}")
    check(frac >= 0.99, f"16d big mesh: {frac} of lanes agree")
    wcfg = dataclasses.replace(cfg, spp=1)
    img, launched, _ = render_numbers(
        f"16d big mesh {wcfg.width}x{wcfg.height} Whitted depth "
        f"{wcfg.max_depth}", lambda: whitted_render(scene, wcfg))
    check(launched.get("treelet_walk", 0) > 0, "16d Whitted: no K5")
    lo = (wcfg.height // 2) * wcfg.width
    t1 = time.perf_counter()
    with plain_treelet():
        plain = whitted_crop(scene, wcfg, lo, CROP_BIG)
    log(16, f"16d plain walk on lanes {lo}-{lo + CROP_BIG} (a crop) "
            f"{time.perf_counter() - t1:.2f} s")
    parity("16d big-mesh Whitted against the plain walk (crop)",
           img.reshape(-1, 3)[lo:lo + CROP_BIG], plain,
           (PLAIN_PIXELS, PLAIN_WITHIN, PLAIN_MEAN))
    wall = time.perf_counter() - t0
    log(16, "16d big mesh done", t0)
    return wall


# --------------------------------------------------------------------------
# phase 17: transmittance shadows, the Sobol' sampler and the thin lens,
# progressive Sobol' passes, the watertight test, the adaptive integrator
# --------------------------------------------------------------------------

# tests/test_media.py's slab: extinction and thickness
SLAB_SIGMA_A, SLAB_SIGMA_S, SLAB_T = (2.0, 0.5, 0.1), 0.3, 0.5
SLAB_LANES = 65_536
SOBOL_SOFT_CFG = dataclasses.replace(SOFT_SHADOW_CFG, sampler="sobol",
                                     aperture=0.1, focus_distance=0.0)
# examples/dof_compare.py: the aperture and the two focus distances (on
# the cone, and in front of everything)
DOF_APERTURE, DOF_FOCUS = 0.35, (8.0, 2.5)
# tests/test_qmc.py:123-140's tolerance on the progressive samples
PROG_ATOL = 1e-6
PROG_PASSES = 4
ADAPTIVE_ROUNDS = 4


def transmittance_cfg(cfg):
    return dataclasses.replace(cfg, shadow_mode="transmittance")


def slab_scene(sigma_a=(0.0, 0.0, 0.0), sigma_s=0.0, slab=True,
               emission=50.0):
    """tests/test_media.py's shadow scene: a diffuse floor at y = 0, a
    small emitter at y = 3 facing down, and a glass slab (ior 1) spanning
    y in [1, 1.5] between them."""
    half, s = 50.0, 0.1
    tris = [quad_triangles((-half, 0.0, -half), (-half, 0.0, half),
                           (half, 0.0, half), (half, 0.0, -half)),
            quad_triangles((-s, 3.0, -s), (s, 3.0, -s), (s, 3.0, s),
                           (-s, 3.0, s))]
    mat_id, is_light = [0, 0, 1, 1], [0, 0, 1, 1]
    if slab:
        tris += [quad_triangles((-half, 1.0, -half), (half, 1.0, -half),
                                (half, 1.0, half), (-half, 1.0, half)),
                 quad_triangles((-half, 1.5, -half), (-half, 1.5, half),
                                (half, 1.5, half), (half, 1.5, -half))]
        mat_id += [2, 2, 2, 2]
        is_light += [0, 0, 0, 0]
    mesh = TriangleMesh.build(np.concatenate(tris),
                              np.asarray(mat_id, np.int32),
                              np.asarray(is_light, bool), device=DEV)
    glass = Material(color=presets.WHITE, ior=1.0, transmission=1.0,
                     is_diffuse=False, is_mirror=False,
                     sigma_a=tuple(sigma_a), sigma_s=sigma_s)
    mats = MaterialTable.build([
        Material(color=presets.WHITE),
        Material(color=presets.WHITE, emission=emission), glass],
        device=DEV)
    return Scene.build(mesh, mats, camera=[0.0, 5.0, 0.0])


def slab_direct(scene, n=SLAB_LANES, seed=2):
    """Bounce-0 NEE at the floor under the slab (depth 1: the direct term
    alone), averaged over ``n`` lanes."""
    cfg = RenderConfig(width=1, height=1, spp=1, max_depth=1,
                       shadow_mode="transmittance")
    o = torch.tensor([[0.0, 0.8, 0.0]], device=DEV).repeat(n, 1)
    d = torch.tensor([[0.0, -1.0, 0.0]], device=DEV).repeat(n, 1)
    u = rng.path_uniforms(generator(seed), n, 1)
    return pt.trace_paths(scene, cfg, o, d, u)[0].double().mean(dim=0)


def phase17_slab():
    """17a: tests/test_media.py's slab on the card against the closed form
    exp(-sigma_t L): a vertical segment through it, one that ends inside
    it, and the floor's direct light through it against the clear slab's."""
    t0 = time.perf_counter()
    scene = slab_scene(SLAB_SIGMA_A, SLAB_SIGMA_S)
    sig_t = np.asarray(SLAB_SIGMA_A) + SLAB_SIGMA_S
    o = torch.tensor([[0.0, 0.01, 0.0]] * 3, device=DEV)
    d = torch.tensor([[0.0, 1.0, 0.0]] * 3, device=DEV)
    tr = dispatch.scene_transmittance(
        scene, o, d, torch.tensor([2.8, 1.19, 0.5], device=DEV)).cpu()
    want = np.stack([np.exp(-sig_t * SLAB_T), np.exp(-sig_t * 0.2),
                     np.ones(3)])
    err = float(np.abs(tr.numpy() / want - 1.0).max())
    clear = slab_direct(slab_scene())
    tinted = slab_direct(slab_scene(SLAB_SIGMA_A, SLAB_SIGMA_S))
    ratio = (tinted / clear).cpu().numpy()
    r_err = float(np.abs(ratio / np.exp(-sig_t * SLAB_T) - 1.0).max())
    log(17, f"17a slab (tests/test_media.py): transmittance through it "
            f"{tr[0].tolist()}, ending 0.2 inside {tr[1].tolist()}, short "
            f"{tr[2].tolist()}: max rel err against exp(-sigma_t L) "
            f"{err:.3g} (limit 1e-3); floor's direct light through it over "
            f"the clear slab's on {SLAB_LANES} lanes {ratio.tolist()}, max "
            f"rel err {r_err:.3g} (limit 5e-3) [{smi()}]", t0)
    check(err <= 1e-3, f"17a slab: transmittance off by {err}")
    check(r_err <= 5e-3, f"17a slab: direct light ratio off by {r_err}")


def phase17a(glass):
    """17a: the glass preset with transmittance shadows through K3 (each
    bounce one nearest-hit query, three march queries and the close-out),
    every K3 launch held bitwise, the card against the CPU; then the
    slab."""
    scene, cfg = glass
    tcfg = transmittance_cfg(cfg)
    label = (f"17a glass {tcfg.width}x{tcfg.height}x{tcfg.spp} depth "
             f"{tcfg.max_depth}, transmittance shadows")
    img, launched, _ = render_numbers(
        label, lambda: lt.render(scene, tcfg, seed=0), 17)
    k3 = launched.get("intersect_dense", 0)
    check(k3 == 5 * tcfg.max_depth, f"17a glass: {k3} K3 launches, "
                                    f"expected {5 * tcfg.max_depth}")
    check(set(launched) == {"intersect_dense"}, f"17a glass: {launched}")
    opaque = lt.render(scene, cfg, seed=0)
    log(17, f"17a glass image mean {float(img.mean()):.5f}, with opaque "
            f"shadows {float(opaque.mean()):.5f}")
    check(float(img.mean()) > float(opaque.mean()),
          "17a glass: transmittance let no light through the glass")
    t0 = time.perf_counter()
    with Recorder("intersect_dense") as rec:
        lt.render(scene, tcfg, seed=0)
        torch.cuda.synchronize()
    n, ms, pairs = rec.summary()
    log(17, f"17a glass: {n} K3 launches, {ms:.4f} ms mean by CUDA events, "
            f"admitted pairs per launch {pairs}", t0)
    rec.hold_every("17a glass transmittance")
    paths_against_cpu("17a glass transmittance", scene,
                      glass_scene(device="cpu")[0], tcfg, 7, phase=17)
    phase17_slab()


def phase17_big(scene, cfg):
    """17a: the big mesh with transmittance shadows through K5 (five
    sorted launches a bounce), a crop of its lanes through K5 and through
    the plain walk bitwise, and the render's own lanes there."""
    t0 = time.perf_counter()
    tcfg = transmittance_cfg(cfg)
    img, launched, _ = render_numbers(
        f"17a big mesh {tcfg.width}x{tcfg.height}x{tcfg.spp} depth "
        f"{tcfg.max_depth}, transmittance shadows",
        lambda: lt.render(scene, tcfg, seed=0), 17)
    k5 = launched.get("treelet_walk", 0)
    check(k5 == 5 * tcfg.max_depth,
          f"17a big mesh: {k5} K5 launches, expected {5 * tcfg.max_depth}")
    check(set(launched) == {"treelet_walk"}, f"17a big mesh: {launched}")
    o, d, u = pt._camera_lanes(scene, tcfg, 0)
    lo = (tcfg.height // 2) * tcfg.width
    sl = slice(lo, lo + CROP_BIG)
    rad_k = pt.trace_paths(scene, tcfg, o[sl], d[sl], u[sl])[0]
    with plain_treelet():
        rad_p = pt.trace_paths(scene, tcfg, o[sl], d[sl], u[sl])[0]
    check(bvh_mod.PLAIN_WALKS > 0, "17a big mesh: the crop ran no plain walk")
    same = torch.equal(rad_k, rad_p)
    _, samples = pt.render_image(scene, tcfg, seed=0, return_samples=True)
    rad_r = samples.permute(2, 0, 1, 3).reshape(-1, 3)[sl]
    log(17, f"17a big mesh: lanes {lo}-{lo + CROP_BIG} (a crop) through K5 "
            f"and through the plain walk bitwise equal {same}; image mean "
            f"{float(img.mean()):.5f}")
    check(same, "17a big mesh: the crop differs from the plain walk")
    parity("17a big mesh render against its crop re-traced", rad_r, rad_k,
           (PLAIN_PIXELS, PLAIN_WITHIN, PLAIN_MEAN), 17)
    log(17, "17a big mesh done", t0)
    return time.perf_counter() - t0


def sobol_build(cfg, seed, device):
    """The Sobol' render's random inputs: u_aa, uniforms and lens points."""
    bits = qmc.seed_bits(seed)
    u_aa, u = qmc.render_uniforms(bits, cfg.height, cfg.width, cfg.spp,
                                  cfg.max_depth, device=device)
    lens = qmc.render_pair(bits, cfg.height, cfg.width, cfg.spp,
                           qmc.LENS_PAIR, device=device)
    return u_aa, u, lens


def region_mse(img, ref):
    """examples/dof_compare.py's MSE against the pinhole image over the
    centre (the cone) and the border (the walls)."""
    d2 = ((img - ref) ** 2).mean(dim=-1)
    h, w = d2.shape
    border = torch.ones((h, w), dtype=torch.bool, device=d2.device)
    border[h // 4: 3 * h // 4, w // 4: 3 * w // 4] = False
    return (float(d2[h // 3: 2 * h // 3, w // 3: 2 * w // 3].mean()),
            float(d2[border].mean()))


def emitter_scene(half=1.2):
    """tests/test_dof.py's scene: a bright square emitter at z = 0 facing a
    camera at z = 6, on black."""
    quad = quad_triangles((-half, -half, 0.0), (half, -half, 0.0),
                          (half, half, 0.0), (-half, half, 0.0))
    mesh = TriangleMesh.build(quad, np.zeros(2, np.int32),
                              np.asarray([True, True]), device=DEV)
    mats = MaterialTable.build(
        [Material(color=presets.WHITE, emission=50.0)], device=DEV)
    return Scene.build(mesh, mats, camera=[0.0, 0.0, 6.0])


def phase17b(soft):
    """17b: the soft-shadow scene with the Sobol' sampler and the lens
    through the cull kernel and K4; the card's Sobol' build bitwise the
    CPU's on every lane and timed alone; a crop against the plain
    intersector; the depth of field of examples/dof_compare.py and of
    tests/test_dof.py."""
    cfg = SOBOL_SOFT_CFG
    n = cfg.width * cfg.height * cfg.spp
    img, launched, _ = render_numbers(
        f"17b soft shadow {cfg.width}x{cfg.height}x{cfg.spp} depth "
        f"{cfg.max_depth}, sampler sobol, aperture {cfg.aperture}",
        lambda: lt.render(soft, cfg, seed=0), 17)
    for name in ("tile_cull", "intersect_gather"):
        check(launched.get(name, 0) == 2 * cfg.max_depth,
              f"17b: {launched}, expected {2 * cfg.max_depth} {name}")
    t0 = time.perf_counter()
    with Recorder("intersect_gather") as rec, CullRecorder() as cull:
        lt.render(soft, cfg, seed=0)
        torch.cuda.synchronize()
    n_k4, k4_ms, pairs = rec.summary()
    n_c, cull_ms = cull.summary()
    log(17, f"17b K4: {n_k4} launches, {k4_ms:.3f} ms mean by CUDA events, "
            f"admitted pairs per launch {pairs}; cull: {n_c} launches, "
            f"{cull_ms:.4f} ms mean [{smi()}]", t0)
    del rec, cull
    t0 = time.perf_counter()
    build = functools.partial(sobol_build, cfg, 0, DEV)
    ms = cuda_ms(build, 3)
    busy, n_launch = device_busy(build)
    card = [x.cpu() for x in build()]
    t1 = time.perf_counter()
    host = sobol_build(cfg, 0, "cpu")
    cpu_s = time.perf_counter() - t1
    same = [torch.equal(a, b) for a, b in zip(card, host)]
    log(17, f"17b the Sobol' build alone ({n} lanes: jitter, "
            f"{cfg.max_depth} x {rng.NUM_U} path uniforms, lens): "
            f"{ms:.3f} ms by CUDA events, {busy:.3f} ms busy under the "
            f"profiler, {n_launch} launches; on the CPU {cpu_s:.2f} s; card "
            f"bitwise the CPU (jitter, uniforms, lens) {same} [{smi()}]", t0)
    check(all(same), f"17b: the card's Sobol' points differ from the CPU's")
    o, d, u = pt._camera_lanes(soft, cfg, 0)
    check(torch.equal(u.cpu(), host[1]), "17b: the render's uniforms differ")
    lo = (cfg.height * 9 // 20) * cfg.width  # from row 180 of 400
    t0 = time.perf_counter()
    with plain_intersector():
        rad_p = pt.trace_paths(soft, cfg, o[lo:lo + CROP_SOFT],
                               d[lo:lo + CROP_SOFT], u[lo:lo + CROP_SOFT])[0]
    log(17, f"17b plain intersector on lanes {lo}-{lo + CROP_SOFT} (a crop)",
        t0)
    _, samples = pt.render_image(soft, cfg, seed=0, return_samples=True)
    rad_k = samples.permute(2, 0, 1, 3).reshape(-1, 3)[lo:lo + CROP_SOFT]
    parity("17b kernels against the plain intersector (crop)", rad_k, rad_p,
           (PLAIN_PIXELS, PLAIN_WITHIN, PLAIN_MEAN), 17)
    del o, d, u, samples, card, host
    # examples/dof_compare.py's Cornell configuration
    scene, dcfg = cornell_box_scene(width=150, height=150, spp=32,
                                    max_depth=3, device=DEV)
    dcfg = dataclasses.replace(dcfg, sampler="sobol")
    ref, _, _ = render_numbers(
        f"17b Cornell {dcfg.width}x{dcfg.height}x{dcfg.spp} depth "
        f"{dcfg.max_depth} sobol, pinhole", lambda: lt.render(scene, dcfg),
        17)
    mse = {}
    for focus in DOF_FOCUS:
        c = dataclasses.replace(dcfg, aperture=DOF_APERTURE,
                                focus_distance=focus)
        img_f, _, _ = render_numbers(
            f"17b Cornell sobol, aperture {DOF_APERTURE}, focus {focus}",
            lambda c=c: lt.render(scene, c), 17)
        mse[focus] = region_mse(img_f, ref)
    sharp, blur = mse[DOF_FOCUS[0]], mse[DOF_FOCUS[1]]
    log(17, f"17b depth of field against the pinhole (centre, border MSE): "
            f"focus {DOF_FOCUS[0]} {sharp}, focus {DOF_FOCUS[1]} {blur}")
    check(blur[0] > 5 * sharp[0] and blur[1] > 5 * sharp[1],
          f"17b: the misfocused render is not blurred: {mse}")
    # tests/test_dof.py:40-66's footprints, with the Sobol' points (the
    # uniform stream's misfocused footprint sits at the rule's edge: 150
    # and 151 pixels against 1.5 x 100 on the CPU)
    em = emitter_scene()
    ecfg = RenderConfig(width=48, height=48, spp=16, max_depth=1,
                        sampler="sobol")

    def lit(**kw):
        im = lt.render(em, dataclasses.replace(ecfg, **kw), seed=0)
        return int((im.mean(dim=-1) > 0.05).sum())

    base, focused = lit(), lit(aperture=0.25, focus_distance=6.0)
    blurred = lit(aperture=0.25, focus_distance=2.0)
    wider = lit(aperture=0.5, focus_distance=2.0)
    log(17, f"17b tests/test_dof.py's emitter, lit pixels: pinhole {base}, "
            f"focused {focused}, misfocused {blurred}, wider {wider}")
    check(base > 20 and abs(focused - base) < 0.3 * base
          and blurred > 1.5 * base and wider > blurred,
          "17b: the emitter's footprints break tests/test_dof.py's rule")


def phase17c(glass):
    """17c: PROG_PASSES progressive Sobol' passes of glass against one
    Sobol' render of PROG_PASSES times the samples, regrouped into passes:
    equal up to the per-pass clip."""
    scene, cfg = glass
    c = dataclasses.replace(cfg, sampler="sobol")
    wide = dataclasses.replace(c, spp=c.spp * PROG_PASSES)
    zero_counts()
    t0 = time.perf_counter()
    prog = pt.render_progressive(scene, c, seed=3, n_passes=PROG_PASSES)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k3 = ik.LAUNCHES["intersect_dense"]
    _, samples = pt.render_image(scene, wide, seed=3, return_samples=True)
    want = pass_images(samples, PROG_PASSES).mean(dim=0)
    err = float((prog - want).abs().max())
    log(17, f"17c progressive Sobol' glass, {PROG_PASSES} passes of "
            f"{c.spp} spp: {wall:.4f} s, K3 launches {k3}; against one "
            f"{wide.spp}-spp render in {PROG_PASSES} clipped passes max abs "
            f"diff {err:.3g} (limit {PROG_ATOL}); means "
            f"{float(prog.mean()):.5f} and {float(want.mean()):.5f}")
    check(k3 == PROG_PASSES * 2 * c.max_depth, f"17c: {k3} K3 launches")
    check(err <= PROG_ATOL, f"17c: progressive passes differ by {err}")


def fan_rays(device):
    """tests/test_intersect.py:141-166: 24 fan triangles and rays at every
    shared edge (four radii) and at the shared centre."""
    ang = np.linspace(0, 2 * np.pi, 25)
    rim = np.stack([np.cos(ang), np.sin(ang), np.zeros_like(ang)], -1)
    tris = np.stack([np.zeros((24, 3)), rim[:-1], rim[1:]], axis=1)
    mesh = TriangleMesh.build(tris.astype(np.float32),
                              np.zeros(24, np.int32), device=device)
    radii = np.asarray([1e-4, 0.25, 0.5 + 1e-7, 0.999], np.float32)
    a = ang[:-1]
    pts = np.concatenate(
        [np.stack([r * np.cos(a), r * np.sin(a), np.zeros_like(a)], -1)
         for r in radii] + [np.zeros((1, 3))]).astype(np.float32)
    cam = np.asarray([0.3, -0.2, 3.0], np.float32)
    dd = pts - cam
    d = dd / np.linalg.norm(dd, axis=1, keepdims=True)
    o = np.tile(cam, (len(pts), 1))
    return (mesh, torch.from_numpy(o).to(device),
            torch.from_numpy(d.astype(np.float32)).to(device))


def phase17d():
    """17d: watertight scenes (the brute force in plain torch, no kernel):
    lts_scene 256x256x8 and glass 100x100x4, the card against the CPU on a
    crop; the shared-edge crack check on the card."""
    scenes = {
        "lts_scene 256x256x8": lambda dev: lts_scene(
            width=256, height=256, spp=8, device=dev),
        "glass 100x100x4": lambda dev: glass_scene(device=dev),
    }
    for name, make in scenes.items():
        scene, cfg = make(DEV)
        wt = scene.with_watertight()
        img, launched, _ = render_numbers(
            f"17d {name} depth {cfg.max_depth}, watertight",
            lambda: lt.render(wt, cfg, seed=0), 17)
        check(not launched, f"17d {name}: kernels launched {launched}")
        mt = lt.render(scene, cfg, seed=0)
        log(17, f"17d {name}: image mean {float(img.mean()):.5f}, "
                f"Möller–Trumbore's {float(mt.mean()):.5f}, mean abs diff "
                f"{float((img - mt).abs().mean()):.3g}")
        paths_against_cpu(f"17d {name} watertight", wt,
                          make("cpu")[0].with_watertight(), cfg, 5,
                          phase=17)
    mesh, o, d = fan_rays(DEV)
    hw = ops_intersect.intersect_rays_watertight(o, d, mesh)
    hm = ops_intersect.intersect_rays(o, d, mesh)
    log(17, f"17d shared-edge rays (tests/test_intersect.py): watertight "
            f"hits {int(hw.valid.sum())} of {o.shape[0]}, Möller–Trumbore "
            f"{int(hm.valid.sum())}")
    check(bool(hw.valid.all()), "17d: a shared-edge ray fell through")


@contextlib.contextmanager
def adaptive_allocs(pinned=None):
    """Records each round's weights and allocation of the adaptive renders
    made meanwhile (``integrators/adaptive._integer_alloc``), or with
    ``pinned`` hands the rounds those allocations in turn."""
    real, seen = ad._integer_alloc, []

    def alloc(w, budget):
        a = real(w, budget) if pinned is None else pinned[len(seen)][1].to(
            w.device)
        seen.append((w, a))
        return a

    ad._integer_alloc = alloc
    try:
        yield seen
    finally:
        ad._integer_alloc = real


def phase17e():
    """17e: examples/adaptive_compare.py's configuration, glass 96x96, 16
    spp, depth 5 in ADAPTIVE_ROUNDS rounds, both samplers: the budget
    exact, every pixel explored.  With Sobol' the card against the CPU:
    each round's allocation from the card's weights, then the image from
    the card's allocations (a free-running CPU render allocates from its
    own float sums, which differ from the card's in the last bits; a
    round's rounded cumulative targets turn such a difference into other
    sample counts)."""
    scene, cfg = glass_scene(96, 96, 16, 5, device=DEV)
    for sampler in ("uniform", "sobol"):
        c = dataclasses.replace(cfg, sampler=sampler)
        img, launched, _ = render_numbers(
            f"17e adaptive glass {c.width}x{c.height}x{c.spp} depth "
            f"{c.max_depth}, {ADAPTIVE_ROUNDS} rounds, sampler {sampler}",
            lambda: lt.render(scene, c, seed=0, integrator="adaptive"), 17)
        k3 = launched.get("intersect_dense", 0)
        check(k3 == ADAPTIVE_ROUNDS * 2 * c.max_depth,
              f"17e {sampler}: {k3} K3 launches")
        with adaptive_allocs() as allocs:
            img, counts = ad.render_adaptive(scene, c, 0, ADAPTIVE_ROUNDS,
                                             return_counts=True)
        total, least = int(counts.sum()), int(counts.min())
        log(17, f"17e {sampler}: samples {total} (budget "
                f"{c.width * c.height * c.spp}), per pixel {least} to "
                f"{int(counts.max())}; image mean {float(img.mean()):.5f}")
        check(total == c.width * c.height * c.spp, f"17e: budget {total}")
        check(least >= c.spp // ADAPTIVE_ROUNDS, f"17e: a pixel got {least}")
        if sampler != "sobol":
            continue
        budget = total // ADAPTIVE_ROUNDS
        for r, (w, a) in enumerate(allocs):
            a_cpu = ad._integer_alloc(w.cpu(), budget)
            off = (a_cpu - a.cpu()).abs()
            log(17, f"17e round {r}: the CPU's allocation from the card's "
                    f"weights equal on {float((off == 0).double().mean()):.5f}"
                    f" of pixels, off by at most {int(off.max())}")
            check(int(a_cpu.sum()) == budget and int(off.max()) <= 1
                  and float((off == 0).double().mean()) >= 0.99,
                  f"17e round {r}: the allocations differ")
        t0 = time.perf_counter()
        scene_cpu, _ = glass_scene(96, 96, 16, 5, device="cpu")
        with adaptive_allocs(allocs):
            img_cpu, counts_cpu = ad.render_adaptive(
                scene_cpu, c, 0, ADAPTIVE_ROUNDS, return_counts=True)
        log(17, f"17e sobol on the CPU from the card's allocations "
                f"{time.perf_counter() - t0:.2f} s; count maps equal "
                f"{torch.equal(counts.cpu(), counts_cpu)}")
        check(torch.equal(counts.cpu(), counts_cpu), "17e: count maps differ")
        parity("17e adaptive sobol card against CPU", img, img_cpu,
               (0.99, CPU_WITHIN, CPU_MEAN), 17)


def phase17(glass, soft):
    """17a-17e but the big mesh (phase17_big, after phase 12)."""
    t0 = time.perf_counter()
    phase17a(glass)
    phase17b(soft)
    phase17c(glass)
    phase17d()
    phase17e()
    wall = time.perf_counter() - t0
    log(17, "17a-17e done", t0)
    return wall


# --------------------------------------------------------------------------
# phase 18: BDPT and the control variates
# --------------------------------------------------------------------------

# examples/bdpt_cornell.py:23, examples/point_light.py:26-27 and :51-68,
# examples/lts_cornell.py:26
BDPT_CORNELL = dict(width=96, height=96, spp=16, max_depth=4)
BDPT_POINT = dict(width=192, height=192, spp=16, max_depth=4)
MIXED_LIGHT = ([[0.0, 3.0, 0.0]], [[40.0, 40.0, 40.0]])
CV_CORNELL = dict(width=150, height=150, spp=12, max_depth=4)
CV_GLASS_SPP = 8
GRAD_LANES = 2_048  # glass lanes scored on both devices and by fd
# card against CPU on the score: every slot within GRAD_ATOL + GRAD_RTOL
# |g| on >= CPU_PIXELS of the lanes (a lane whose path flips a branch on an
# ulp scores another path)
GRAD_ATOL, GRAD_RTOL = 1e-4, 1e-3
# tests/test_control_variates.py:31-44: fd step, closeness, share of slots
FD_STEP_TEST, FD_CLOSE, FD_SHARE = 1e-3, 5e-2, 0.9
# a splat plane run twice on the card: each bin within this share of its
# value (its adds are float atomics in the card's order, all of them >= 0)
SPLAT_RERUN_REL = 2.0 ** -16


def bdpt_queries(depth, family, n_point=0):
    """(nearest-hit, any-hit) queries of one BDPT render, by
    integrators/bdpt.py's loops: the two walks; s=1 to the area lights;
    s=1 to each point light; the s>=2 connections within the depth; the
    t=1 splats (light tracing on)."""
    nearest = 2 * depth
    any_hit = ((depth if family != "point" else 0)
               + (depth * n_point if family != "area" else 0)
               + depth * (depth - 1) // 2 + depth)
    return nearest, any_hit


def bdpt_render(scene, cfg, seed=0):
    return lt.render(scene, cfg, seed=seed, integrator="bdpt")


def lanes_on(lanes, device, sl=slice(None)):
    return {k: v[sl].to(device) for k, v in lanes.items()}


def bdpt_body(scene, cfg, lanes, family, q):
    return tb._bdpt_body(scene, cfg, lanes, None, True, family, q)


def splat_rerun(label, scene, cfg, lanes, family, q, phase=18):
    """One lane set's splat plane twice on the card: the largest relative
    difference of a bin; fails past SPLAT_RERUN_REL."""
    a = bdpt_body(scene, cfg, lanes, family, q)[1].double()
    b = bdpt_body(scene, cfg, lanes, family, q)[1].double()
    big = torch.maximum(a.abs(), b.abs())
    rel = float(((a - b).abs() / torch.where(big > 0, big, 1.0)).max())
    log(phase, f"{label}: splat plane rerun on the card, largest "
               f"relative difference of a bin {rel:.3g} (limit "
               f"{SPLAT_RERUN_REL:.3g}), bitwise {torch.equal(a, b)}")
    check(rel <= SPLAT_RERUN_REL, f"{label}: splat rerun differs by {rel}")
    return a.float()


def bdpt_against_cpu(label, scene, scene_cpu, cfg, seed=0, phase=18):
    """One lanes dict drawn on the CPU, rendered whole on the card and its
    first CROP_CPU lanes on the CPU: per-lane radiance to 15e's limits,
    the crop's splat plane (in image units) too, beside a second card run
    of it.  Returns the card's (lanes, radiance, splat) of the whole dict
    and the family."""
    family, q = tb._light_family(scene_cpu)
    lanes = tb._bdpt_lane_uniforms(scene_cpu, cfg, seed, family)
    n = lanes["o"].shape[0]
    card = lanes_on(lanes, DEV)
    rad, splat = bdpt_body(scene, cfg, card, family, q)
    k = min(CROP_CPU, n)
    crop = lanes_on(lanes, "cpu", slice(0, k))
    t0 = time.perf_counter()
    rad_cpu, splat_cpu = bdpt_body(scene_cpu, cfg, crop, family, q)
    log(phase, f"{label}: CPU BDPT of lanes 0-{k} of {n} "
               f"{time.perf_counter() - t0:.2f} s")
    parity(f"{label} card against CPU (lanes' radiance)", rad[:k], rad_cpu,
           (CPU_PIXELS, CPU_WITHIN, CPU_MEAN), phase)
    splat_k = splat_rerun(label, scene, cfg, lanes_on(crop, DEV), family, q,
                          phase)
    parity(f"{label} card against CPU (the crop's splat plane / {k})",
           splat_k / k, splat_cpu / k, (CPU_PIXELS, CPU_WITHIN, CPU_MEAN),
           phase)
    return card, rad, splat, family, q


def lane_means(rad, splat, n_pix):
    """A BDPT render's unclipped image mean (over pixels and channels):
    ``mean_l(rad_l) + sum(splat) / (n * n_pix)``."""
    n = rad.shape[0]
    return (float(rad.double().mean()) + float(splat.double().sum())
            / (3 * n * n_pix))


def bdpt_mean_against_pt(label, scene, cfg, card, rad, splat, family, q):
    """The BDPT render's unclipped image mean against the path tracer's at
    the same size (``emission_mode="nee"``: the transport BDPT targets,
    light through specular chains included), within 3 sigma: sigma^2 the
    path tracer's per-pixel sample variance over spp and pixels^2 plus
    the BDPT mean's from its spp sample layers (each layer one lane a
    pixel with its own light paths, rendered on its own, splats
    included: iid estimates of the mean)."""
    n_pix = cfg.width * cfg.height
    pcfg = dataclasses.replace(cfg, emission_mode="nee")
    _, samples = pt.render_image(scene, pcfg, seed=1, return_samples=True)
    m_pt = float(samples.double().mean())
    se_pt = pixel_sigma(samples)
    layers = [lane_means(*bdpt_body(
        scene, cfg, lanes_on(card, DEV, slice(k * n_pix, (k + 1) * n_pix)),
        family, q), n_pix) for k in range(cfg.spp)]
    se_bd = float(np.std(layers, ddof=1)) / cfg.spp ** 0.5
    m_bd = lane_means(rad, splat, n_pix)
    bound = 3.0 * (se_pt ** 2 + se_bd ** 2) ** 0.5
    log(18, f"{label}: unclipped image mean BDPT {m_bd:.6f} (standard error "
            f"{se_bd:.3g} from its {cfg.spp} sample layers, whose means "
            f"average {float(np.mean(layers)):.6f}), path tracer (emission_"
            f"mode nee) {m_pt:.6f} (standard error {se_pt:.3g} from the "
            f"per-pixel sample variance); difference {abs(m_bd - m_pt):.3g}, "
            f"3 sigma {bound:.3g}")
    check(abs(m_bd - m_pt) <= bound, f"{label}: BDPT and PT means differ")


def check_bdpt_launches(label, launched, want):
    check(launched == want, f"{label}: kernel launches {launched}, "
                            f"expected {want}")


def phase18a():
    """18a: BDPT on examples/bdpt_cornell.py's Cornell box (the brute
    force, no kernel): card against CPU, its mean against the path
    tracer's."""
    scene, cfg = cornell_box_scene(**BDPT_CORNELL, device=DEV)
    label = (f"18a Cornell {cfg.width}x{cfg.height}x{cfg.spp} depth "
             f"{cfg.max_depth} BDPT")
    img, launched, _ = render_numbers(label, lambda: bdpt_render(scene, cfg),
                                      18)
    check_bdpt_launches("18a", launched, {})
    scene_cpu = cornell_box_scene(**BDPT_CORNELL, device="cpu")[0]
    card, rad, splat, family, q = bdpt_against_cpu("18a Cornell", scene,
                                                   scene_cpu, cfg)
    log(18, f"18a family {family}, queries (nearest, any-hit) "
            f"{bdpt_queries(cfg.max_depth, family)}; image mean "
            f"{float(img.mean()):.5f}")
    bdpt_mean_against_pt("18a Cornell", scene, cfg, card, rad, splat,
                         family, q)


def phase18b():
    """18b: BDPT on point_light_scene (the point family) and on the
    Cornell box with examples/point_light.py's point light (the mixed
    family), 192x192x16 at depth 4 (the brute force, no kernel)."""
    def point(dev):
        return point_light_scene(**BDPT_POINT, device=dev)

    def mixed(dev):
        s, c = cornell_box_scene(**BDPT_POINT, device=dev)
        return s.with_point_lights(*MIXED_LIGHT), c

    for name, make, want in (("point_light_scene", point, "point"),
                             ("mixed", mixed, "mixed")):
        scene, cfg = make(DEV)
        family, q = tb._light_family(scene)
        queries = bdpt_queries(cfg.max_depth, family,
                               scene.point_lights.num)
        label = (f"18b {name} {cfg.width}x{cfg.height}x{cfg.spp} depth "
                 f"{cfg.max_depth} BDPT, family {family}, q_point {q:.6f}")
        img, launched, _ = render_numbers(
            label, lambda: bdpt_render(scene, cfg), 18)
        check_bdpt_launches(f"18b {name}", launched, {})
        log(18, f"18b {name}: family {family}, q_point {q}, queries "
                f"(nearest, any-hit) {queries}; image mean "
                f"{float(img.mean()):.5f}")
        check(family == want, f"18b {name}: family {family}")
        check(float(img.mean()) > 0.01, f"18b {name}: black image")
        bdpt_against_cpu(f"18b {name}", scene, make("cpu")[0], cfg)


def phase18c(glass):
    """18c: BDPT on the glass preset through K3, every launch held bitwise
    against its plain version, the card against the CPU."""
    scene, cfg = glass
    nq = sum(bdpt_queries(cfg.max_depth, "area"))
    label = (f"18c glass {cfg.width}x{cfg.height}x{cfg.spp} depth "
             f"{cfg.max_depth} BDPT")
    img, launched, _ = render_numbers(label, lambda: bdpt_render(scene, cfg),
                                      18)
    check_bdpt_launches("18c", launched, {"intersect_dense": nq})
    t0 = time.perf_counter()
    with Recorder("intersect_dense") as rec:
        bdpt_render(scene, cfg)
        torch.cuda.synchronize()
    n, ms, pairs = rec.summary()
    log(18, f"18c glass: {n} K3 launches, {ms:.4f} ms mean by CUDA events, "
            f"admitted pairs per launch {pairs}; image mean "
            f"{float(img.mean()):.5f}", t0)
    rec.hold_every("18c glass BDPT")
    bdpt_against_cpu("18c glass", scene, glass_scene(device="cpu")[0], cfg)


def phase18d(soft):
    """18d: BDPT on the soft-shadow scene at 4 spp through the cull kernel
    and K4; lanes 72,000-87,999 re-traced through the plain intersector,
    bitwise."""
    cfg = dataclasses.replace(SOFT_SHADOW_CFG, spp=4)
    nq = sum(bdpt_queries(cfg.max_depth, "area"))
    img, launched, _ = render_numbers(
        f"18d soft shadow {cfg.width}x{cfg.height}x{cfg.spp} depth "
        f"{cfg.max_depth} BDPT", lambda: bdpt_render(soft, cfg), 18)
    check_bdpt_launches("18d", launched,
                        {"tile_cull": nq, "intersect_gather": nq})
    t0 = time.perf_counter()
    with Recorder("intersect_gather") as rec, CullRecorder() as cull:
        bdpt_render(soft, cfg)
        torch.cuda.synchronize()
    n, ms, pairs = rec.summary()
    nc, cull_ms = cull.summary()
    log(18, f"18d K4: {n} launches, {ms:.4f} ms mean by CUDA events, "
            f"admitted pairs per launch {pairs}; cull: {nc} launches, "
            f"{cull_ms:.4f} ms mean; image mean {float(img.mean()):.5f} "
            f"[{smi()}]", t0)
    lanes = tb._bdpt_lane_uniforms(soft, cfg, 0, "area")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    rad, _ = bdpt_body(soft, cfg, lanes, "area", 0.0)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    # a vertex: 24 floats (pos, ns, diffuse, beta, emit, spec, win, the
    # two densities, shin) and 3 bools; two subpaths of max_depth each
    vbytes = 99 * 2 * cfg.max_depth * rad.shape[0]
    log(18, f"18d device memory of the body on {rad.shape[0]} lanes: peak "
            f"{peak / 1e9:.3f} GB above its inputs, of it the two walks' "
            f"vertices {vbytes / 1e9:.3f} GB [{smi()}]")
    lo = 180 * cfg.width
    sl = slice(lo, lo + CROP_SOFT)
    t0 = time.perf_counter()
    with plain_intersector():
        rad_p, _ = bdpt_body(soft, cfg, lanes_on(lanes, DEV, sl), "area",
                             0.0)
    same = torch.equal(rad[sl], rad_p)
    log(18, f"18d plain intersector on lanes {sl.start}-{sl.stop} (a crop): "
            f"bitwise the render's lanes {same}, max abs diff "
            f"{float((rad[sl] - rad_p).abs().max()):.3g}", t0)
    check(same, "18d: the crop differs from the plain intersector")


def phase18_big(scene, cfg):
    """18e: BDPT on the big mesh through K5 (one sorted launch a query);
    lanes 32,768-34,815 bitwise the plain walk."""
    t0 = time.perf_counter()
    nq = sum(bdpt_queries(cfg.max_depth, "area"))
    img, launched, _ = render_numbers(
        f"18e big mesh {cfg.width}x{cfg.height}x{cfg.spp} depth "
        f"{cfg.max_depth} BDPT", lambda: bdpt_render(scene, cfg), 18)
    check_bdpt_launches("18e", launched, {"treelet_walk": nq})
    lanes = tb._bdpt_lane_uniforms(scene, cfg, 0, "area")
    rad, _ = bdpt_body(scene, cfg, lanes, "area", 0.0)
    lo = (cfg.height // 2) * cfg.width
    sl = slice(lo, lo + CROP_BIG)
    crop = lanes_on(lanes, DEV, sl)
    rad_k, _ = bdpt_body(scene, cfg, crop, "area", 0.0)
    with plain_treelet():
        rad_p, _ = bdpt_body(scene, cfg, crop, "area", 0.0)
    check(bvh_mod.PLAIN_WALKS > 0, "18e: the crop ran no plain walk")
    same = torch.equal(rad_k, rad_p) and torch.equal(rad[sl], rad_k)
    log(18, f"18e big mesh: lanes {sl.start}-{sl.stop} (a crop) through K5 "
            f"and through the plain walk, and the render's own lanes there, "
            f"bitwise equal {same}; image mean {float(img.mean()):.5f}", t0)
    check(same, "18e: the crop differs from the plain walk")
    return time.perf_counter() - t0


def pixel_sigma(samples):
    """The standard error of an image mean from its per-pixel sample
    variance: samples (H, W, spp, 3) -> float."""
    s = samples.double().mean(dim=-1)
    n_pix = s.shape[0] * s.shape[1]
    return float(s.var(dim=2).sum()) ** 0.5 / (s.shape[2] ** 0.5 * n_pix)


def cv_numbers(label, out):
    """A CV render's checks: finite, the CV image's mean within 3 sigma of
    the plain one's; the singular pixels' share and the per-pixel
    variance ratio (printed, no gate)."""
    hw = out.samples.shape[:2]
    p = hw[0] * hw[1]
    samples = out.samples.reshape(p, -1, 3)
    corrected, _ = cv.cv_correct(samples, -0.5 * out.grad_log_pdf.reshape(
        p, samples.shape[1], -1))
    v_plain = float(samples.double().var(dim=1).mean())
    v_cv = float(corrected.double().var(dim=1).mean())
    sigma = pixel_sigma(out.samples)
    m_plain, m_cv = float(out.image_plain.mean()), float(out.image_cv.mean())
    log(18, f"{label}: image means plain {m_plain:.6f}, CV {m_cv:.6f} "
            f"(difference {abs(m_cv - m_plain):.3g}, 3 sigma {3 * sigma:.3g}"
            f"); singular pixels {float(out.singular.double().mean()):.5f}; "
            f"per-pixel sample variance plain {v_plain:.6g}, CV {v_cv:.6g} "
            f"(ratio {v_plain / max(v_cv, 1e-300):.4f})")
    check(bool(torch.isfinite(out.image_cv).all()), f"{label}: not finite")
    check(abs(m_cv - m_plain) <= 3 * sigma, f"{label}: CV mean off")


def phase18f(glass):
    """18f: render_cv exact on examples/lts_cornell.py's Cornell box (no
    kernel) and on glass at 8 spp (K3 on the forward pass only); the
    score of GRAD_LANES glass lanes on the card against the CPU's from
    the same uniforms, and exact against fd."""
    scene, cfg = cornell_box_scene(**CV_CORNELL, device=DEV)
    out, launched, _ = render_numbers(
        f"18f render_cv exact Cornell {cfg.width}x{cfg.height}x{cfg.spp} "
        f"depth {cfg.max_depth}", lambda: cv.render_cv(scene, cfg, 0).image_cv,
        18)
    check_bdpt_launches("18f Cornell", launched, {})
    cv_numbers("18f Cornell", cv.render_cv(scene, cfg, 0))
    gscene, gcfg = glass
    gcfg = dataclasses.replace(gcfg, spp=CV_GLASS_SPP)
    _, launched, _ = render_numbers(
        f"18f render_cv exact glass {gcfg.width}x{gcfg.height}x{gcfg.spp} "
        f"depth {gcfg.max_depth}",
        lambda: cv.render_cv(gscene, gcfg, 0).image_cv, 18)
    check_bdpt_launches("18f glass", launched,
                        {"intersect_dense": 2 * gcfg.max_depth})
    cv_numbers("18f glass", cv.render_cv(gscene, gcfg, 0))

    # the render's first GRAD_LANES lanes, drawn on the CPU
    scene_cpu = glass_scene(device="cpu")[0]
    n = gcfg.width * gcfg.height * gcfg.spp
    u_aa, uni, _ = cv._cv_lane_uniforms(scene_cpu, gcfg, 0, n)
    o, d = pt.camera_rays(scene_cpu, gcfg, u_aa)
    o, d, uni = o[:GRAD_LANES], d[:GRAD_LANES], uni[:GRAD_LANES]
    zero_counts()
    t0 = time.perf_counter()
    r_k, _, g_k = cv.grad_log_pdf_exact(gscene, gcfg, o.to(DEV), d.to(DEV),
                                        uni.to(DEV))
    torch.cuda.synchronize()
    wall_ex, k3_ex = time.perf_counter() - t0, ik.LAUNCHES["intersect_dense"]
    r_c, _, g_c = cv.grad_log_pdf_exact(scene_cpu, gcfg, o, d, uni)
    g_k, g_c = g_k.cpu(), g_c
    ok = ((g_k - g_c).abs() <= GRAD_ATOL + GRAD_RTOL * g_c.abs()).all(dim=1)
    frac = float(ok.double().mean())
    log(18, f"18f score of {GRAD_LANES} glass lanes, card against CPU from "
            f"the same uniforms: {frac:.5f} of lanes within {GRAD_ATOL} + "
            f"{GRAD_RTOL} |g| on every slot, max abs diff "
            f"{float((g_k - g_c).abs().max()):.3g}, radiance max abs diff "
            f"{float((r_k.cpu() - r_c).abs().max()):.3g}; exact on the card "
            f"{wall_ex:.4f} s, K3 launches {k3_ex}")
    check(frac >= CPU_PIXELS, f"18f: the card's score differs on {1 - frac}")
    check(k3_ex == 2 * gcfg.max_depth, f"18f exact: {k3_ex} K3 launches")
    zero_counts()
    t0 = time.perf_counter()
    _, _, g_f = cv.grad_log_pdf_fd(gscene, gcfg, o.to(DEV), d.to(DEV),
                                   uni.to(DEV), step=FD_STEP_TEST)
    torch.cuda.synchronize()
    wall_fd, k3_fd = time.perf_counter() - t0, ik.LAUNCHES["intersect_dense"]
    close = torch.isclose(g_k, g_f.cpu(), rtol=FD_CLOSE, atol=FD_CLOSE)
    share = float(close.double().mean())
    log(18, f"18f fd (step {FD_STEP_TEST}) on the card: {wall_fd:.4f} s, K3 "
            f"launches {k3_fd} ((4 D + 1) x {2 * gcfg.max_depth}); exact "
            f"against fd {share:.5f} of slots within {FD_CLOSE} (limit "
            f"{FD_SHARE})")
    check(k3_fd == (4 * gcfg.max_depth + 1) * 2 * gcfg.max_depth,
          f"18f fd: {k3_fd} K3 launches")
    check(share > FD_SHARE, f"18f: exact against fd on {share}")


def phase18(glass, soft):
    """18a-18d and 18f (18e after phase 12: phase18_big)."""
    t0 = time.perf_counter()
    phase18a()
    phase18b()
    phase18c(glass)
    phase18d(soft)
    phase18f(glass)
    wall = time.perf_counter() - t0
    log(18, "18a-18d, 18f done", t0)
    return wall


# --------------------------------------------------------------------------
# phase 19: the front ends and the sharded BDPT render
# --------------------------------------------------------------------------

BDPT_SHARDS = (1, 2, 3)  # 3 pads 2 lanes of a 40,000- or 640,000-lane render
BDPT_SHARD_ATOL = 5e-6  # tests/test_sharding.py:76 (splat plane and image)
# K3 launches of one CLI render of the glass preset (100x100x4, depth 3)
CLI_K3 = {"path": 6, "adaptive": 24, "whitted": 45, "bdpt": 15, "cv": 6}
CLI_PHOTONS = 100_000
GUI_STATS = ["preset", "integrator", "size", "spp", "max_depth", "seed",
             "triangles", "elapsed_s", "mean"]
PROFILE_RTOL, PROFILE_ATOL_MS = 0.1, 2.0  # timed against CUDA events


@contextlib.contextmanager
def assembled():
    """Each (radiance, splat) a BDPT render hands to ``_bdpt_assemble``
    while installed, in call order."""
    calls = []
    orig = tb._bdpt_assemble

    def spy(cfg, radiance, splat):
        calls.append((radiance, splat))
        return orig(cfg, radiance, splat)

    tb._bdpt_assemble = spy
    try:
        yield calls
    finally:
        tb._bdpt_assemble = orig


def phase19a_one(label, scene, cfg, names):
    """render_bdpt_sharded at BDPT_SHARDS virtual shards against one
    unsharded ``_bdpt_body`` on the same lanes: radiance rows bitwise at
    one shard and within SHARDED_ATOL at more (the bitwise share logged),
    the splat plane (in image units) and the image within
    BDPT_SHARD_ATOL beside an unsharded rerun's spread, and 15 launches
    of each kernel in ``names`` a shard, counted from 0."""
    family, q = tb._light_family(scene)
    n = cfg.width * cfg.height * cfg.spp
    nq = sum(bdpt_queries(cfg.max_depth, family))
    lanes = tb._bdpt_lane_uniforms(scene, cfg, 0, family)
    rad0, splat0 = bdpt_body(scene, cfg, lanes, family, q)
    splat_rerun = float((bdpt_body(scene, cfg, lanes, family, q)[1]
                         - splat0).abs().max()) / n
    ref = tb._bdpt_assemble(cfg, rad0, splat0)
    for k in BDPT_SHARDS:
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with assembled() as calls:
            img = pm.render_bdpt_sharded(scene, cfg, 0, mesh=pm.make_mesh(k))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = {m: c for m, c in ik.LAUNCHES.items() if c}
        rad, splat = calls[0]
        rows = float((rad == rad0).all(dim=1).double().mean())
        rad_err = float((rad - rad0).abs().max())
        splat_err = float((splat - splat0).abs().max()) / n
        img_err = float((img - ref).abs().max())
        log(19, f"19a {label} render_bdpt_sharded at {k} shard(s) ({n} "
                f"lanes, {(-n) % k} pad): radiance rows bitwise the "
                f"unsharded body's on {rows:.6f}, max abs diff {rad_err:.3g}"
                f"; splat plane / n max abs diff {splat_err:.3g} (the "
                f"unsharded body's rerun {splat_rerun:.3g}), image "
                f"{img_err:.3g}; launches {launched}; wall {wall:.4f} s "
                f"[{smi()}]")
        check(launched == {m: nq * k for m in names},
              f"19a {label}, {k}: launches {launched}, expected {nq} of "
              f"{names} a shard")
        if k == 1:
            check(torch.equal(rad, rad0), f"19a {label}: one shard's "
                                          f"radiance rows not bitwise")
        check(rad_err <= SHARDED_ATOL, f"19a {label}, {k}: rows {rad_err}")
        check(splat_err <= BDPT_SHARD_ATOL and img_err <= BDPT_SHARD_ATOL,
              f"19a {label}, {k}: splat {splat_err}, image {img_err}")
        check(bool(torch.isfinite(img).all()), f"19a {label}: not finite")


def phase19a(glass, soft):
    """19a: the sharded BDPT render on glass (K3) and on the soft-shadow
    scene at 4 spp (the cull kernel and K4, phase 18d's lanes)."""
    t0 = time.perf_counter()
    for label, scene, cfg, names in (
            ("glass", *glass, ("intersect_dense",)),
            ("soft shadow", soft, dataclasses.replace(SOFT_SHADOW_CFG,
                                                      spp=4),
             ("tile_cull", "intersect_gather"))):
        phase19a_one(f"{label} {cfg.width}x{cfg.height}x{cfg.spp} d"
                     f"{cfg.max_depth}", scene, cfg, names)
    log(19, "19a done", t0)


def quantized_match(label, got, first, second):
    """PNG pixels ``got`` against the API image ``first`` quantized as the
    CLI writes it: equal when a rerun of the API call (``second``) is
    bitwise ``first``; else within one level (a rerun's float atomics
    move a value across a level), the levels that differ logged beside
    the rerun's."""
    from light_transport_tpu_torch.utils.png import quantize

    qa, qb = quantize(first).astype(int), quantize(second).astype(int)
    diff = np.abs(got.astype(int) - qa)
    exact = bool(torch.equal(first, second))
    log(19, f"{label}: PNG pixels against the API image quantized: "
            f"{int((diff > 0).sum())} values differ (max {int(diff.max())}); "
            f"the API rerun bitwise {exact}, its quantized values differing "
            f"{int((qa != qb).sum())}")
    check(got.shape == qa.shape, f"{label}: shape {got.shape}")
    check(int(diff.max()) <= (0 if exact else 1), f"{label}: PNG differs")


def cli_line(args):
    """``cli.main(args)``; returns its standard output."""
    from light_transport_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(args)
    check(rc == 0, f"cli {args}: exit {rc}")
    return buf.getvalue()


def phase19b(glass, tmp):
    """19b: the CLI on the card (no ``--device``): ``render --preset
    glass`` with each integrator at the preset's size, ``--preview``,
    ``--sharded --integrator bdpt``; ``simulate --preset demo`` against
    api.simulate, and ``--checkpoint`` run, then resumed."""
    import base64

    from light_transport_tpu_torch.utils.png import decode_png

    scene, cfg = glass
    direct = {
        "path": lambda: lt.render(scene, cfg, seed=0),
        "adaptive": lambda: lt.render(scene, cfg, seed=0,
                                      integrator="adaptive"),
        "whitted": lambda: lt.render(scene, cfg, seed=0,
                                     integrator="whitted"),
        "bdpt": lambda: bdpt_render(scene, cfg),
        "cv": lambda: cv.render_cv(scene, cfg, 0).image_cv,
        "bdpt --sharded": lambda: pm.render_bdpt_sharded(scene, cfg, 0),
    }
    for name, fn in direct.items():
        integ, *extra = name.split()
        out = os.path.join(tmp, f"{integ}{len(extra)}.png")
        args = ["render", "--preset", "glass", "--integrator", integ,
                "--seed", "0", "--out", out, *extra]
        if name == "path":
            args.append("--preview")
        zero_counts()
        t0 = time.perf_counter()
        cli_line(args)
        wall = time.perf_counter() - t0
        launched = {m: c for m, c in ik.LAUNCHES.items() if c}
        with open(out, "rb") as f:
            png = decode_png(f.read())
        log(19, f"19b cli {' '.join(args[:5] + extra)}: {wall:.3f} s, "
                f"launches {launched}")
        check(launched == {"intersect_dense": CLI_K3[integ]},
              f"19b {name}: launches {launched}")
        quantized_match(f"19b {name}", png, fn(), fn())
        if name == "path":
            page = open(os.path.splitext(out)[0] + ".html").read()
            b64 = re.search(r'base64,([^"]+)"', page).group(1)
            same = np.array_equal(decode_png(base64.b64decode(b64)), png)
            log(19, f"19b --preview: {len(page)} bytes of HTML, its image "
                    f"the PNG's {same}")
            check(same and "triangles" in page, "19b: the preview")

    from light_transport_tpu_torch import cli
    from light_transport_tpu_torch.transport import photon as ph
    from light_transport_tpu_torch.models.presets import demo_homogeneous

    def sim_json(extra):
        t0 = time.perf_counter()
        d = json.loads(cli_line(["simulate", "--preset", "demo",
                                 "--photons", str(CLI_PHOTONS), "--seed",
                                 "0", *extra]).strip().splitlines()[-1])
        return d, time.perf_counter() - t0

    got, wall = sim_json([])
    medium, pcfg = demo_homogeneous(device=DEV)
    pcfg = dataclasses.replace(pcfg, n_photons=CLI_PHOTONS)
    t0 = time.time()
    want = cli.simulate_summary(lt.simulate(medium, pcfg, seed=0), t0)
    same = {k: got[k] == want[k] for k in want if k != "seconds"}
    rel = max(abs(got[k] - want[k]) / max(abs(want[k]), 1e-300)
              for k in same)
    log(19, f"19b cli simulate --preset demo --photons {CLI_PHOTONS}: "
            f"{got}; CLI {wall:.3f} s, api.simulate {want['seconds']:.3f} "
            f"s; keys {list(got) == list(want)}, values equal {same}, max "
            f"relative difference {rel:.3g}")
    check(list(got) == list(want), "19b simulate: the JSON keys")
    check(got["photons"] == CLI_PHOTONS and same["photons"]
          and same["steps"], "19b simulate: photons or steps differ")
    check(rel <= 1e-9, f"19b simulate: differs from api.simulate by {rel}")
    check(abs(got["energy"] - 1.0) <= 1e-4, f"19b energy {got['energy']}")

    ck = os.path.join(tmp, "run.npz")
    first, wall1 = sim_json(["--checkpoint", ck])
    runs = [0]
    orig = ph.simulate_photons

    def counted(*a, **k):
        runs[0] += 1
        return orig(*a, **k)

    ph.simulate_photons = counted
    try:
        again, wall2 = sim_json(["--checkpoint", ck])
    finally:
        ph.simulate_photons = orig
    first.pop("seconds"), again.pop("seconds")
    log(19, f"19b cli simulate --checkpoint: {wall1:.3f} s, "
            f"{os.path.getsize(ck)} bytes of snapshot; resumed from it in "
            f"{wall2:.3f} s with {runs[0]} batches run, the same line "
            f"{again == first}; energy {first['energy']}")
    check(again == first and runs[0] == 0, "19b: the resumed run differs")
    check(abs(first["energy"] - 1.0) <= 1e-4, "19b checkpoint: energy")


def write_obj(path, tris):
    """(T, 3, 3) float64 triangles as an OBJ: three ``v`` records a
    triangle (exact decimal round trip) and one ``f``."""
    with open(path, "w") as f:
        f.write("".join(f"v {x!r} {y!r} {z!r}\n"
                        for x, y, z in tris.reshape(-1, 3).tolist()))
        f.write("".join(f"f {3 * i + 1} {3 * i + 2} {3 * i + 3}\n"
                        for i in range(tris.shape[0])))


def phase19c(soft, tmp):
    """19c: the soft-shadow sphere through an OBJ file and ``load_obj``:
    the mesh's fields bitwise the built mesh's, and phase 10's scene with
    it rendered (400x400x4, depth 3, through the cull kernel and K4)
    bitwise the original scene's render."""
    from light_transport_tpu_torch.scene.objio import load_obj

    t0 = time.perf_counter()
    sph = sphere_triangles(center=(0, 1, 0), radius=1.5, n_theta=176,
                           n_phi=352)
    path = os.path.join(tmp, "sphere.obj")
    write_obj(path, sph)
    t1 = time.perf_counter()
    mesh, dim = load_obj(path)
    t2 = time.perf_counter()
    built = TriangleMesh.build(sph, np.zeros(len(sph), np.int32), device=DEV)
    same = {f: bool(torch.equal(getattr(mesh, f), getattr(built, f)))
            for f in ("v0", "e1", "e2", "normal", "centroid", "mat_id",
                      "is_light")}
    log(19, f"19c OBJ of {len(sph)} triangles, {os.path.getsize(path)} "
            f"bytes: written {t1 - t0:.2f} s, load_obj {t2 - t1:.2f} s on "
            f"{mesh.device}; dimension {dim}; fields bitwise the built "
            f"mesh's {same}")
    check(all(same.values()) and mesh.device == DEV, "19c: the OBJ mesh")
    check(dim == float(np.abs(sph).max()), f"19c: dimension {dim}")
    scene = soft_shadow_scene(sphere=mesh)
    cfg = dataclasses.replace(SOFT_SHADOW_CFG, spp=4)
    want = lt.render(soft, cfg, seed=0)
    zero_counts()
    got = lt.render(scene, cfg, seed=0)
    torch.cuda.synchronize()
    launched = {m: c for m, c in ik.LAUNCHES.items() if c}
    equal = bool(torch.equal(got, want))
    log(19, f"19c the OBJ scene at {cfg.width}x{cfg.height}x{cfg.spp} depth "
            f"{cfg.max_depth}: launches {launched}, bitwise the soft-shadow "
            f"scene's render {equal}, image mean {float(got.mean()):.5f}",
        t0)
    check(launched == {"tile_cull": 2 * cfg.max_depth,
                       "intersect_gather": 2 * cfg.max_depth},
          f"19c: launches {launched}")
    check(equal, "19c: the OBJ scene renders another image")


def phase19d(glass):
    """19d: the GUI server on the card: the form, a glass render at the
    preset's size, /img.png against the API image, /stats.json, and a bad
    request answered with 500 while the server keeps serving."""
    import urllib.error
    import urllib.request

    from light_transport_tpu_torch import gui
    from light_transport_tpu_torch.utils.png import decode_png

    def get(path):
        return urllib.request.urlopen(
            f"http://127.0.0.1:{srv.server_port}{path}", timeout=300).read()

    t0 = time.perf_counter()
    srv = gui.serve(port=0, background=True)
    try:
        check(b"<form" in get("/"), "19d: no form")
        zero_counts()
        t1 = time.perf_counter()
        page = get("/render?preset=glass&integrator=path&seed=0").decode()
        wall = time.perf_counter() - t1
        launched = {m: c for m, c in ik.LAUNCHES.items() if c}
        stats = json.loads(get("/stats.json"))
        log(19, f"19d GUI /render?preset=glass: {wall:.3f} s, launches "
                f"{launched}; stats {stats}")
        check("elapsed_s" in page, "19d: the page has no stats")
        check(launched == {"intersect_dense": CLI_K3["path"]},
              f"19d: launches {launched}")
        check(list(stats) == GUI_STATS and stats["size"] == "100x100"
              and stats["triangles"] == glass[0].mesh.num_triangles,
              f"19d: stats {stats}")
        scene, cfg = glass
        quantized_match("19d /img.png", decode_png(get("/img.png")),
                        lt.render(scene, cfg, seed=0),
                        lt.render(scene, cfg, seed=0))
        try:
            get("/render?preset=nope")
            check(False, "19d: a bad request was answered")
        except urllib.error.HTTPError as e:
            body = e.read().decode()
            check(e.code == 500 and "unknown preset" in body,
                  f"19d: bad request {e.code} {body[:80]}")
        check(b"<form" in get("/"), "19d: the server stopped serving")
        log(19, "19d bad request: 500 with the error in the page, the "
                "server still serves", t0)
    finally:
        srv.shutdown()
        srv.server_close()


def phase19e(glass):
    """19e: utils.profiling on the glass render: ``timed`` and
    ``compile_and_steady`` against CUDA events around the same calls,
    and ``trace`` writing a Chrome trace that names K3."""
    from light_transport_tpu_torch.utils import profiling

    scene, cfg = glass

    def fn():
        return lt.render(scene, cfg, seed=0)

    def with_events(call):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        out = call()
        b.record()
        torch.cuda.synchronize()
        return out, a.elapsed_time(b)

    t0 = time.perf_counter()
    (img, secs), ev_ms = with_events(lambda: profiling.timed(fn))
    # events around each call compile_and_steady times: the render waits
    # on the host, so other calls' times would spread as its walls do
    events = []

    def fn_events():
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        events.append((a, b))
        return out

    first, best = profiling.compile_and_steady(fn_events)
    torch.cuda.synchronize()
    steady = min(a.elapsed_time(b) for a, b in events[1:])
    log(19, f"19e timed {secs * 1e3:.3f} ms, CUDA events around it "
            f"{ev_ms:.3f} ms; compile_and_steady first {first * 1e3:.3f} "
            f"ms, best steady {best * 1e3:.3f} ms, CUDA events' best of "
            f"the same 3 calls {steady:.3f} ms [{smi()}]")
    check(img.is_cuda and bool(torch.isfinite(img).all()), "19e: the image")
    for label, host, dev in (("timed", secs * 1e3, ev_ms),
                             ("best steady", best * 1e3, steady)):
        check(abs(host - dev) <= PROFILE_RTOL * dev + PROFILE_ATOL_MS,
              f"19e {label}: {host} ms against events' {dev} ms")
    with tempfile.TemporaryDirectory() as d:
        with profiling.trace(d):
            fn()
            torch.cuda.synchronize()
        files = os.listdir(d)
        text = Path(d, files[0]).read_text() if files else ""
    named = text.count("intersect_dense_kernel")
    log(19, f"19e trace: {files}, {len(text)} bytes, K3 "
            f"(intersect_dense_kernel) named {named} times", t0)
    check(len(files) == 1 and named > 0, "19e: the trace names no K3")


def phase19(glass, soft):
    """19a-19e."""
    t0 = time.perf_counter()
    phase19a(glass, soft)
    with tempfile.TemporaryDirectory() as tmp:
        phase19b(glass, tmp)
        phase19c(soft, tmp)
    phase19d(glass)
    phase19e(glass)
    wall = time.perf_counter() - t0
    log(19, f"phase 19 in all {wall:.2f} s")
    return wall


# --------------------------------------------------------------------------
# phase 20: the glossy BSDF, the emission modes, the surface detectors and
# the example drivers
# --------------------------------------------------------------------------

PLATE = dict(width=96, height=96, spp=16, max_depth=3, shininess=400.0)
PLATE_MODES = ("nee", "mis", "always")
SOFT_CROP = slice(72_000, 88_000)  # the glossy soft shadow's re-traced lanes
DETECTOR_RTOL = 1e-5  # energy of one record tallied on the card and the CPU
PHASE20_PHOTONS = 100_000  # photon_mcml in phase 20 (its main(): 1e6)
# drivers whose scenes take the cluster intersector: K3, or the cull and K4
DRIVER_KERNELS = {"adaptive_compare": {"intersect_dense"},
                  "hard_shadow": {"intersect_dense"},
                  "ray_tracing": {"intersect_dense"},
                  "refraction": {"intersect_dense"},
                  "soft_shadow": {"tile_cull", "intersect_gather"}}


def glossy_materials(scene, row):
    """``scene`` with material row ``row`` replaced by GLOSSY_MAT (the
    mesh, its derived tables and the lights unchanged)."""
    mats = scene.materials
    g = MaterialTable.build([presets.GLOSSY_MAT], device=scene.device)
    fields = {}
    for f in MATERIAL_FIELDS:
        col = getattr(mats, f).clone()
        col[row] = getattr(g, f)[0]
        fields[f] = col
    return dataclasses.replace(scene, materials=MaterialTable(**fields))


def phase20_plate():
    """20a: examples/glossy_mis.py's plate (shininess 400, 4 triangles:
    the brute force) under nee, mis and always, card against CPU."""
    from light_transport_tpu_torch.models.presets import glossy_plate_scene

    scene, cfg = glossy_plate_scene(**PLATE, device=DEV)
    scene_cpu = glossy_plate_scene(**PLATE, device="cpu")[0]
    means = {}
    for mode in PLATE_MODES:
        c = dataclasses.replace(cfg, emission_mode=mode)
        t0 = time.perf_counter()
        zero_counts()
        img = lt.render(scene, c, seed=0)
        launched = {k: v for k, v in ik.LAUNCHES.items() if v}
        means[mode] = float(img.mean())
        log(20, f"20a glossy plate {c.width}x{c.height}x{c.spp} depth "
                f"{c.max_depth}, shininess {PLATE['shininess']}, emission_"
                f"mode {mode}: image mean {means[mode]:.5f}, launches "
                f"{launched}", t0)
        check(not launched, f"20a plate: kernels launched {launched}")
        check(bool(torch.isfinite(img).all()), "20a plate: not finite")
        paths_against_cpu(f"20a glossy plate {mode}", scene, scene_cpu, c,
                          0, phase=20)
    check(means["always"] > means["nee"] and means["mis"] > 0.0,
          f"20a plate: image means {means}")


def phase20_glass(glass, glossy, glossy_cpu):
    """20a: glass with glossy white walls through K3 (every launch held
    bitwise, card against CPU); BDPT (launches from integrators/bdpt.py's
    loops, every one held bitwise, card against CPU) and Whitted (45
    launches, every lane against the plain intersector) on it."""
    scene, cfg = glossy
    label = (f"20a glossy glass {cfg.width}x{cfg.height}x{cfg.spp} depth "
             f"{cfg.max_depth} (emission_mode {cfg.emission_mode})")
    img, launched, _ = render_numbers(
        label, lambda: lt.render(scene, cfg, seed=0), 20)
    check(launched == {"intersect_dense": 2 * cfg.max_depth},
          f"20a glossy glass: launches {launched}")
    diffuse = lt.render(glass[0], cfg, seed=0)
    log(20, f"20a glossy glass image mean {float(img.mean()):.5f}, the "
            f"preset's diffuse walls {float(diffuse.mean()):.5f}")
    check(not torch.equal(img, diffuse), "20a: the glossy walls changed "
                                         "nothing")
    t0 = time.perf_counter()
    with Recorder("intersect_dense") as rec:
        lt.render(scene, cfg, seed=0)
        torch.cuda.synchronize()
    n, ms, pairs = rec.summary()
    log(20, f"20a glossy glass: {n} K3 launches, {ms:.4f} ms mean by CUDA "
            f"events, admitted pairs per launch {pairs}", t0)
    rec.hold_every("20a glossy glass")
    paths_against_cpu("20a glossy glass", scene, glossy_cpu, cfg, 7,
                      phase=20)

    nq = sum(bdpt_queries(cfg.max_depth, "area"))
    img, launched, _ = render_numbers(
        f"20a glossy glass {cfg.width}x{cfg.height}x{cfg.spp} depth "
        f"{cfg.max_depth} BDPT", lambda: bdpt_render(scene, cfg), 20)
    check_bdpt_launches("20a BDPT", launched, {"intersect_dense": nq})
    with Recorder("intersect_dense") as rec:
        bdpt_render(scene, cfg)
        torch.cuda.synchronize()
    rec.hold_every("20a glossy glass BDPT")
    bdpt_against_cpu("20a glossy glass BDPT", scene, glossy_cpu, cfg,
                     phase=20)

    cfg3 = dataclasses.replace(cfg, max_depth=3)
    img, launched, _ = render_numbers(
        f"20a glossy glass {cfg3.width}x{cfg3.height} Whitted depth 3",
        lambda: whitted_render(scene, cfg3), 20)
    check(launched == {"intersect_dense": 45},
          f"20a Whitted: launches {launched}")
    t0 = time.perf_counter()
    with plain_intersector():
        plain = whitted_crop(scene, cfg3, 0, cfg3.width * cfg3.height)
    log(20, f"20a Whitted plain intersector, every lane", t0)
    parity("20a glossy glass Whitted against the plain intersector", img,
           plain, (PLAIN_PIXELS, PLAIN_WITHIN, PLAIN_MEAN), 20)


def phase20_soft(soft):
    """20a: the soft-shadow scene with a glossy sphere at 400x400x10,
    depth 3, through the cull kernel and K4; lanes 72,000-87,999
    re-traced through the plain intersector."""
    scene = glossy_materials(soft, 0)
    cfg = SOFT_SHADOW_CFG
    label = (f"20a glossy soft shadow {cfg.width}x{cfg.height}x{cfg.spp} "
             f"depth {cfg.max_depth}")
    _, launched, _ = render_numbers(
        label, lambda: lt.render(scene, cfg, seed=0), 20)
    want = {"tile_cull": 2 * cfg.max_depth,
            "intersect_gather": 2 * cfg.max_depth}
    check(launched == want, f"20a glossy soft shadow: launches {launched}")
    img, samples = pt.render_image(scene, cfg, seed=0, return_samples=True)
    o, d, u = pt._camera_lanes(scene, cfg, 0)
    t0 = time.perf_counter()
    with plain_intersector():
        rad_p, _ = pt.trace_paths(scene, cfg, o[SOFT_CROP], d[SOFT_CROP],
                                  u[SOFT_CROP])
    rad_k = samples.permute(2, 0, 1, 3).reshape(-1, 3)[SOFT_CROP]
    close = torch.isclose(rad_k, rad_p, rtol=1e-3, atol=1e-6).all(dim=1)
    frac = float(close.float().mean())
    diffuse = lt.render(soft, cfg, seed=0)
    log(20, f"20a glossy soft shadow: plain intersector on lanes "
            f"{SOFT_CROP.start}-{SOFT_CROP.stop - 1}: {frac:.5f} within "
            f"rtol 1e-3, bitwise {torch.equal(rad_k, rad_p)}; image mean "
            f"{float(img.mean()):.5f} (diffuse sphere "
            f"{float(diffuse.mean()):.5f}) [{smi()}]", t0)
    check(frac >= PLAIN_PIXELS, f"20a glossy soft shadow: {frac} of lanes")
    check(bool(torch.isfinite(img).all()) and not torch.equal(img, diffuse),
          "20a glossy soft shadow: the image")


def coplanar_ties(scene_cpu, rays, tri_a, tri_b):
    """Lanes whose (N, depth) triangle records differ, and how many of them
    differ first at a tie: the ray of that bounce (``rays``, the CPU's)
    meets both triangles at the same distance (float64 Moller-Trumbore,
    within 1e-6), as the glass's coplanar triangles of opposite facing
    do, so an ulp of the ray decides between them."""
    differ = (tri_a != tri_b).numpy()
    lanes = np.nonzero(differ.any(axis=1))[0]
    first = differ[lanes].argmax(axis=1)
    a = tri_a.numpy()[lanes, first]
    b = tri_b.numpy()[lanes, first]
    o = np.stack([r[0].double().numpy() for r in rays], 1)[lanes, first]
    d = np.stack([r[1].double().numpy() for r in rays], 1)[lanes, first]
    verts = scene_cpu.mesh.vertices()

    def mt(v):
        e1, e2 = v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]
        p = np.cross(d, e2)
        det = (e1 * p).sum(1)
        s_ = o - v[:, 0]
        q = np.cross(s_, e1)
        return (e2 * q).sum(1) / det, (s_ * p).sum(1) / det, \
            (d * q).sum(1) / det

    with np.errstate(divide="ignore", invalid="ignore"):
        ta, ua, va = mt(verts[a])
        tb, ub, vb = mt(verts[b])
    tie = ((a >= 0) & (b >= 0)
           & (np.minimum(ua, ub) >= -1e-6) & (np.minimum(va, vb) >= -1e-6)
           & (np.maximum(ua + va, ub + vb) <= 1 + 1e-6)
           & (np.abs(ta - tb) <= 1e-6 * np.maximum(1.0, np.abs(ta))))
    return len(lanes), int(tie.sum())


def phase20b(glass, glass_cpu):
    """20b: render_with_detectors on glass through K3: its image bitwise
    render_image's; one trace's record tallied on the card and on the
    CPU (hits bitwise, energy within DETECTOR_RTOL); the card's record
    against the CPU's from the same uniforms."""
    scene, cfg = glass
    t0 = time.perf_counter()
    zero_counts()
    img, energy, hits = pt.render_with_detectors(scene, cfg, seed=0)
    torch.cuda.synchronize()
    launched = {k: v for k, v in ik.LAUNCHES.items() if v}
    same = torch.equal(img, pt.render_image(scene, cfg, seed=0))
    n_tri = scene.mesh.num_triangles
    log(20, f"20b render_with_detectors glass {cfg.width}x{cfg.height}x"
            f"{cfg.spp} depth {cfg.max_depth}: launches {launched}, image "
            f"bitwise render_image's {same}; hits {int(hits.sum())} on "
            f"{int((hits > 0).sum())} of {n_tri} triangles, energy "
            f"{float(energy.sum()):.4f}", t0)
    check(same, "20b: the detectors' image differs from render_image's")
    check(launched == {"intersect_dense": 2 * cfg.max_depth},
          f"20b: launches {launched}")
    check(bool(((energy > 0) <= (hits > 0)).all()), "20b: energy, no hits")
    o, d, u = pt._camera_lanes(glass_cpu, cfg, 0)
    k = CROP_CPU
    _, rec = pt.trace_paths(scene, cfg, o[:k].to(DEV), d[:k].to(DEV),
                            u[:k].to(DEV))
    # the CPU's trace bounce by bounce (trace_paths' loop), keeping the rays
    state, recs, rays = pt.PathState.initial(o[:k], d[:k]), [], []
    for b in range(cfg.max_depth):
        rays.append((state.origin, state.direction))
        state, r = pt._bounce(glass_cpu, cfg, state, u[:k, b], b)
        recs.append(r)
    rec_cpu = pt.TraceRecord(*(torch.stack(x, dim=1) for x in zip(*recs)))
    e_card, h_card = pt.surface_detector_tally(rec, n_tri)
    e_host, h_host = pt.surface_detector_tally(
        pt.TraceRecord(*(x.cpu() for x in rec)), n_tri)
    e_card, h_card = e_card.cpu(), h_card.cpu()
    rel = float(((e_card - e_host).abs()
                 / e_host.abs().clamp(min=1e-30)).max())
    e_cpu, h_cpu = pt.surface_detector_tally(rec_cpu, n_tri)
    same_tri = float((rec.tri.cpu() == rec_cpu.tri).double().mean())
    n_apart, n_ties = coplanar_ties(glass_cpu, rays, rec.tri.cpu(),
                                    rec_cpu.tri)
    h_diff = int((h_card - h_cpu).abs().sum())
    e_rel = float((e_card.double().sum() - e_cpu.double().sum()).abs()
                  / e_cpu.double().sum())
    log(20, f"20b lanes 0-{k}: the card's record tallied on the card and "
            f"on the CPU: hits bitwise {torch.equal(h_card, h_host)}, "
            f"energy largest relative difference {rel:.3g} (limit "
            f"{DETECTOR_RTOL}); against the CPU's trace of the same "
            f"uniforms: records on the same triangle {same_tri:.6f}, the "
            f"first differing record of {n_ties} of the {n_apart} lanes "
            f"apart a coplanar tie, hits bitwise "
            f"{torch.equal(h_card, h_cpu)} ({h_diff} of {int(h_cpu.sum())} "
            f"differ), total energy relative difference {e_rel:.3g}")
    check(torch.equal(h_card, h_host), "20b: hits of one record differ")
    check(rel <= DETECTOR_RTOL, f"20b: energy of one record off by {rel}")
    check(same_tri >= PLAIN_PIXELS, f"20b: {same_tri} of records agree")
    check(e_rel <= CPU_MEAN, f"20b: total energy off by {e_rel}")


def driver_numbers(line):
    out = []

    def walk(x):
        if isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif isinstance(x, (int, float)) and not isinstance(x, bool):
            out.append(float(x))

    walk({k: v for k, v in line.items() if k != "example"})
    return out


def phase20c(tmp):
    """20c: every examples_torch driver's main() on the card at the JAX
    driver's sizes (photon_mcml at PHASE20_PHOTONS), into ``tmp``: its
    JSON lines (printed by the driver), wall and launches by kernel."""
    sys.path.insert(0, str(Path(__file__).resolve().parent
                           / "examples_torch"))
    import _torch_common

    walls = {}
    for name in _torch_common.DRIVERS:
        module = _torch_common.load(name)
        zero_counts()
        t0 = time.perf_counter()
        if name == "photon_mcml":
            lines = module.run(n_photons=PHASE20_PHOTONS, out_dir=tmp)
        else:
            lines = module.main(["--out-dir", tmp])
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        launched = {k: v for k, v in ik.LAUNCHES.items() if v}
        cut = (f"; cut: {PHASE20_PHOTONS} photons a run (main(): "
               f"{module.N})" if name == "photon_mcml" else "")
        log(20, f"20c {name}: {len(lines)} JSON lines, wall "
                f"{walls[name]:.2f} s, K3 launches "
                f"{launched.get('intersect_dense', 0)}, K4 launches "
                f"{launched.get('intersect_gather', 0)} (cull "
                f"{launched.get('tile_cull', 0)}){cut} [{smi()}]")
        check(set(launched) == DRIVER_KERNELS.get(name, set()),
              f"20c {name}: launches {launched}")
        for line in lines:
            nums = driver_numbers(line)
            check(nums and all(math.isfinite(v) for v in nums),
                  f"20c {name}: {line}")
        if name == "glossy_mis":
            check(lines[0]["rmse_ratio"] > 1.0,
                  f"20c glossy_mis: MIS no closer to the truth than NEE "
                  f"{lines[0]['rmse_ratio']}")
    pngs = sorted(os.listdir(tmp))
    log(20, f"20c the drivers wrote {len(pngs)} PNGs; walls in all "
            f"{sum(walls.values()):.2f} s")
    return walls


def phase20(glass, soft):
    """20a-20c."""
    t0 = time.perf_counter()
    glass_cpu = glass_scene(device="cpu")[0]
    glossy = (glossy_materials(glass[0], 0), glass[1])
    glossy_cpu = glossy_materials(glass_cpu, 0)
    phase20_plate()
    phase20_glass(glass, glossy, glossy_cpu)
    phase20_soft(soft)
    phase20b(glass, glass_cpu)
    with tempfile.TemporaryDirectory() as tmp:
        phase20c(tmp)
    wall = time.perf_counter() - t0
    log(20, f"phase 20 in all {wall:.2f} s")
    return wall


# --------------------------------------------------------------------------
# phase 21: tail compaction (RenderConfig.compact_tail)
# --------------------------------------------------------------------------

# scripts/bench_compact_tail.py:17-36: the fix1 configuration
FIX1 = dict(width=300, height=300, spp=50, max_depth=8)
COMPACT_DEPTH = 8
GLASS_COMPACT = (100, 100, 16, COMPACT_DEPTH)
# trace_paths_compact's defaults (JAX's)
COMPACT_SEGMENT, COMPACT_MIN_WIDTH = 2, 1 << 13
# the kernel wrappers whose launches phase 21 times at each lane width:
# (module, wrapper, its LAUNCHES key)
WIDTH_WRAPPERS = ((ik, "intersect_dense_keys", "intersect_dense"),
                  (ik, "tile_cull", "tile_cull"),
                  (ik, "intersect_gather", "intersect_gather"),
                  (tk, "treelet_walk", "treelet_walk"),
                  (tk, "treelet_resume", "treelet_resume"))


def halving_widths(counts, n0, depth, segment=COMPACT_SEGMENT,
                   min_width=COMPACT_MIN_WIDTH):
    """trace_paths_compact's lane width at every bounce, by its rule, from
    the live count after each bounce (``counts[b]``, read where a segment
    ends)."""
    widths, width, b = [], n0, 0
    while b < depth:
        seg = min(segment, depth - b)
        widths += [width] * seg
        b += seg
        if b >= depth or width <= min_width:
            continue
        new_w = width
        while new_w > min_width and counts[b - 1] <= new_w // 2:
            new_w //= 2
        width = new_w
    return widths


class WidthLog:
    """While installed, ``path_tracer._bounce`` notes each bounce's lane
    width (with ``keep_alive``, also the alive mask it returns), and every
    kernel wrapper of WIDTH_WRAPPERS is timed by CUDA events, its
    launches (the wrapper's own count) filed under the width of the
    bounce that made them.  A recorder installed inside it wraps the
    timed wrappers, so its own work stays out of the times; calls that
    reach them after the log is removed are not timed."""

    def __init__(self, keep_alive=False):
        self.keep_alive = keep_alive
        self.widths, self.alive, self.launches = [], [], []
        self.width = None
        self.active = True

    def __enter__(self):
        self.saved = [(pt, "_bounce", pt._bounce)] + [
            (m, attr, getattr(m, attr)) for m, attr, _ in WIDTH_WRAPPERS]
        bounce = pt._bounce

        def spy(scene, cfg, state, *args, **kw):
            self.width = state.alive.shape[0]
            self.widths.append(self.width)
            out = bounce(scene, cfg, state, *args, **kw)
            if self.keep_alive:
                self.alive.append(out[0].alive)
            return out

        pt._bounce = spy
        for m, attr, name in WIDTH_WRAPPERS:
            setattr(m, attr, self._timed(m, name, getattr(m, attr)))
        return self

    def _timed(self, module, name, fn):
        def call(*args, **kw):
            if not self.active:
                return fn(*args, **kw)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            before = module.LAUNCHES[name]
            a.record()
            out = fn(*args, **kw)
            b.record()
            if module.LAUNCHES[name] > before:
                self.launches.append((name, self.width, a, b))
            return out
        return call

    def __exit__(self, *exc):
        self.active = False
        for m, attr, fn in self.saved:
            setattr(m, attr, fn)

    def by_width(self):
        """{width: {kernel: (launches, ms by events)}}, widths in order."""
        torch.cuda.synchronize()
        out = {}
        for name, w, a, b in self.launches:
            n, ms = out.setdefault(w, {}).get(name, (0, 0.0))
            out[w][name] = (n + 1, ms + a.elapsed_time(b))
        return out


def launched_now():
    return {k: v for k, v in {**ik.LAUNCHES, **tk.LAUNCHES}.items() if v}


def compact_pair(label, scene, cfg, seed=0, hold=None):
    """Phase 21 on one scene: the full-width trace of the render's lanes
    (its TraceRecord and, by WidthLog, the alive mask after each bounce),
    then ``trace_paths_compact`` of the same lanes under WidthLog
    (launches and CUDA-event ms by kernel and width; ``hold()``, if given,
    is a recorder installed around it), every lane bitwise the full width
    and the widths the halving rule on the live counts.  Then the user's
    two renders, ``render_image`` and ``api.render`` with
    ``compact_tail=True``: first calls, second calls in turns (compact,
    full), host syncs by place on a third call and device busy time under
    the profiler on a fourth, the images bitwise.  Returns the numbers."""
    t_all = time.perf_counter()
    n0 = cfg.width * cfg.height * cfg.spp
    depth = cfg.max_depth
    flagged = dataclasses.replace(cfg, compact_tail=True)
    o, d, u = pt._camera_lanes(scene, cfg, seed)
    zero_counts()
    with WidthLog(keep_alive=True) as wl_full:
        rad_full, rec = pt.trace_paths(scene, cfg, o, d, u)
    full_launched = launched_now()
    record_alive = rec.alive.sum(dim=0).tolist()
    del rec
    live_after = [int(a.sum()) for a in wl_full.alive]
    zero_counts()
    stats = {}
    with WidthLog() as wl, contextlib.ExitStack() as stack:
        recorder = stack.enter_context(hold()) if hold else None
        rad_c = pt.trace_paths_compact(scene, cfg, o, d, u, stats=stats)
    comp_launched = launched_now()
    check(bvh_mod.PLAIN_WALKS == 0, f"21 {label}: the plain walk ran")
    n_apart = int((rad_c != rad_full).any(dim=1).sum())
    per_width = wl.by_width()
    full_ms = {k: v for ks in wl_full.by_width().values()
               for k, v in ks.items()}
    widths = wl.widths
    share = [round(a / w, 4) for a, w in zip(stats["alive"],
                                              stats["widths"])]
    log(21, f"{label} ({n0} lanes, depth {depth}): widths by bounce "
            f"{widths}; live count read after each segment "
            f"{stats['alive']} (share of the width {share}); live after "
            f"each bounce at full width {live_after}, TraceRecord.alive "
            f"counts {record_alive}; lanes apart from the full width "
            f"{n_apart} of {n0}; launches full width {full_launched}, "
            f"compact {comp_launched}; (launches, ms by CUDA events) at "
            f"full width " + ", ".join(f"{k} {n} {ms:.3f}"
                                       for k, (n, ms) in full_ms.items())
            + "; compact by width: " + "; ".join(
                f"{w}: " + ", ".join(f"{k} {n} {ms:.3f}"
                                     for k, (n, ms) in ks.items())
                for w, ks in per_width.items()))
    check(n_apart == 0 and torch.equal(rad_c, rad_full),
          f"21 {label}: {n_apart} lanes differ from the full width")
    check(widths == halving_widths(live_after, n0, depth),
          f"21 {label}: widths {widths} against the rule on {live_after}")
    check(stats["widths"] == widths[::COMPACT_SEGMENT],
          f"21 {label}: stats widths {stats['widths']}")
    check(min(widths) < n0, f"21 {label}: the width never shrank")
    del rad_c
    fns = {"full": lambda: pt.render_image(scene, cfg, seed),
           "compact": lambda: lt.render(scene, flagged, seed)}
    walls, imgs = {}, {}
    for k, name in enumerate(("full", "compact", "compact", "full")):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = fns[name]()
        torch.cuda.synchronize()
        walls.setdefault(name, []).append(time.perf_counter() - t0)
        imgs.setdefault(name, img)
    check(torch.equal(imgs["compact"], imgs["full"]),
          f"21 {label}: the compact image differs from the full width's")
    syncs, where, busy = {}, {}, {}
    for name, fn in fns.items():
        where[name] = {}
        syncs[name] = count_syncs(fn, where[name])
        busy[name] = device_busy(fn)
    log(21, f"{label}: walls (first, second call) full "
            f"{walls['full'][0]:.4f}, {walls['full'][1]:.4f} s; compact "
            f"{walls['compact'][0]:.4f}, {walls['compact'][1]:.4f} s "
            f"(second calls compact/full "
            f"{walls['compact'][1] / walls['full'][1]:.3f}); device busy "
            f"under the profiler full {busy['full'][0]:.3f} ms "
            f"({busy['full'][1]} launches), compact "
            f"{busy['compact'][0]:.3f} ms ({busy['compact'][1]} launches); "
            f"host syncs full {syncs['full']}, compact {syncs['compact']}; "
            f"compact's by place " + ", ".join(
                f"{k} x{v}" for k, v in sorted(where["compact"].items()))
            + f"; images bitwise; image mean {float(imgs['full'].mean()):.5f}"
            f" [{smi()}]", t_all)
    check(bool(torch.isfinite(imgs["full"]).all()),
          f"21 {label}: not finite")
    return dict(o=o, d=d, u=u, rad=rad_full, widths=widths,
                live=wl_full.alive, record_alive=record_alive,
                full_launched=full_launched, comp_launched=comp_launched,
                per_width=per_width, full_ms=full_ms, recorder=recorder,
                img=imgs["full"],
                walls=walls, busy=busy, syncs=syncs)


def phase21a():
    """21a: scripts/bench_compact_tail.py's fix1 configuration, the Cornell
    box 300x300x50 at depth 8, rr_start 5, emission_mode "always": 4.5M
    lanes on the brute force, no kernel; the widths the halving rule on the
    full-width trace's own TraceRecord.alive counts."""
    scene, cfg = cornell_box_scene(**FIX1, device=DEV)
    cfg = dataclasses.replace(cfg, rr_start=5, emission_mode="always")
    r = compact_pair(f"21a fix1 {cfg.width}x{cfg.height}x{cfg.spp} depth "
                     f"{cfg.max_depth}", scene, cfg, seed=1)
    n0 = cfg.width * cfg.height * cfg.spp
    want = halving_widths(r["record_alive"], n0, cfg.max_depth)
    check(r["widths"] == want, f"21a: widths {r['widths']} against the "
                               f"rule on TraceRecord.alive {want}")
    check(not r["full_launched"] and not r["comp_launched"],
          f"21a: kernels launched {r['comp_launched']}")


def phase21b(glass):
    """21b: the glass preset at 100x100x16, depth 8, over K3: every K3
    launch of the compacted trace held bitwise against its plain version
    at its width; api.render with the flag against render_image_compact;
    render_with_detectors with the flag against it without."""
    scene, _ = glass
    cfg = glass_scene(*GLASS_COMPACT, device=DEV)[1]
    label = (f"21b glass {cfg.width}x{cfg.height}x{cfg.spp} depth "
             f"{cfg.max_depth}")
    r = compact_pair(label, scene, cfg, seed=0,
                     hold=lambda: Recorder("intersect_dense"))
    for launched in (r["full_launched"], r["comp_launched"]):
        check(set(launched) == {"intersect_dense"}
              and launched["intersect_dense"] == 2 * cfg.max_depth,
              f"21b: launches {launched}")
    r["recorder"].hold_every(f"21b compact {label}")
    flagged = dataclasses.replace(cfg, compact_tail=True)
    check(torch.equal(lt.render(scene, flagged, seed=0),
                      pt.render_image_compact(scene, cfg, 0)),
          "21b: api.render with compact_tail is not render_image_compact")
    # the energy tally adds by float atomics in the card's order: held to
    # DETECTOR_RTOL, beside a second run without the flag
    (img, energy, hits), (img_f, energy_f, hits_f), (_, energy_r, _) = (
        pt.render_with_detectors(scene, c, seed=0)
        for c in (cfg, flagged, cfg))

    def rel(e):
        return float(((e - energy).abs()
                      / energy.abs().clamp(min=1e-30)).max())

    log(21, f"21b: every K3 launch of the compacted trace bitwise its plain "
            f"version; api.render with the flag bitwise "
            f"render_image_compact; render_with_detectors with the flag: "
            f"image bitwise {torch.equal(img, img_f)}, hits bitwise "
            f"{torch.equal(hits, hits_f)}, energy within rel "
            f"{rel(energy_f):.3g} (a second run without it {rel(energy_r):.3g})")
    check(torch.equal(img, img_f) and torch.equal(hits, hits_f),
          "21b: render_with_detectors' image or hits changed with the flag")
    check(rel(energy_f) <= DETECTOR_RTOL,
          f"21b: detector energy apart by {rel(energy_f)} with the flag")


def phase21c(soft):
    """21c: the soft-shadow scene at 400x400x10, depth 8, over the cull
    kernel and K4: K4's launches and ms at each width; the lanes of
    400x400's rows 180-219 (lanes 72,000-87,999) still live after the
    first shrink re-traced through the plain intersector, bitwise."""
    cfg = dataclasses.replace(SOFT_SHADOW_CFG, max_depth=COMPACT_DEPTH)
    r = compact_pair(f"21c soft shadow {cfg.width}x{cfg.height}x{cfg.spp} "
                     f"depth {cfg.max_depth}", soft, cfg, seed=0)
    for launched in (r["full_launched"], r["comp_launched"]):
        check(set(launched) == {"tile_cull", "intersect_gather"}
              and launched["tile_cull"] == launched["intersect_gather"]
              == 2 * cfg.max_depth, f"21c: launches {launched}")
    k4 = {w: ks.get("intersect_gather", (0, 0.0))
          for w, ks in r["per_width"].items()}
    comp_ms = sum(ms for _, ms in k4.values())
    full_ms = r["full_ms"]["intersect_gather"][1]
    log(21, f"21c: K4 by width (launches, ms by CUDA events, ms a launch): "
            + "; ".join(f"{w}: {n}, {ms:.3f}, {ms / max(n, 1):.3f}"
                        for w, (n, ms) in k4.items())
            + f"; K4 in all {comp_ms:.3f} ms compacted, {full_ms:.3f} ms at "
            f"full width ({comp_ms / full_ms:.3f})")
    widths = r["widths"]
    first = next(b for b, w in enumerate(widths) if w < widths[0])
    crop = torch.zeros_like(r["live"][0])
    crop[SOFT_CROP] = True
    lanes = torch.nonzero(crop & r["live"][first - 1]).squeeze(1)
    t0 = time.perf_counter()
    with plain_intersector():
        rad_p, _ = pt.trace_paths(soft, cfg, r["o"][lanes], r["d"][lanes],
                                  r["u"][lanes])
    n_apart = int((rad_p != r["rad"][lanes]).any(dim=1).sum())
    log(21, f"21c: {lanes.shape[0]} lanes of {SOFT_CROP.start}-"
            f"{SOFT_CROP.stop - 1} live after bounce {first - 1} (the first "
            f"shrink, to {widths[first]}) re-traced through the plain "
            f"intersector: {n_apart} apart from the compacted render", t0)
    check(lanes.shape[0] > 0 and n_apart == 0,
          f"21c: {n_apart} of {lanes.shape[0]} crop lanes differ")


def phase21(glass, soft):
    """21a-21c (21d after the big mesh)."""
    t0 = time.perf_counter()
    phase21a()
    phase21b(glass)
    phase21c(soft)
    wall = time.perf_counter() - t0
    log(21, f"21a-21c in {wall:.2f} s")
    return wall


def phase21_big(scene, cfg):
    """21d: the big mesh at 256x256x2, depth 8, over K5 (bounce 0 the
    coherent batch), compact bitwise full width; then one compacted
    render on the K5r wavefront route beside it, bitwise."""
    t0 = time.perf_counter()
    cfg = dataclasses.replace(cfg, max_depth=COMPACT_DEPTH)
    label = (f"21d big mesh {cfg.width}x{cfg.height}x{cfg.spp} depth "
             f"{cfg.max_depth}")
    r = compact_pair(label, scene, cfg, seed=0)
    for launched in (r["full_launched"], r["comp_launched"]):
        check(set(launched) == {"treelet_walk"},
              f"21d: launches {launched}")
    flagged = dataclasses.replace(cfg, compact_tail=True)
    t1 = time.perf_counter()
    with treelet_route("wavefront"):
        zero_counts()
        img = lt.render(scene, flagged, seed=0)
        torch.cuda.synchronize()
        launched = launched_now()
        check_route("wavefront", launched)
        t2 = time.perf_counter()
        lt.render(scene, flagged, seed=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t2
        syncs = count_syncs(lambda: lt.render(scene, flagged, seed=0))
        busy = device_busy(lambda: lt.render(scene, flagged, seed=0))
    log(21, f"21d wavefront route, compacted: launches {launched}, second "
            f"call {wall:.4f} s, host syncs {syncs}, device busy "
            f"{busy[0]:.3f} ms ({busy[1]} launches); image bitwise the "
            f"single route's full width {torch.equal(img, r['img'])} "
            f"[{smi()}]", t1)
    check(torch.equal(img, r["img"]),
          "21d: the wavefront route's compacted image differs")
    wall = time.perf_counter() - t0
    log(21, f"21d in {wall:.2f} s")
    return wall


# --------------------------------------------------------------------------
# phase 22: the split tracer's stack and bound, the Whitted queue's cutoff
# --------------------------------------------------------------------------

# phase 21b's glass: 160,000 lanes at depth 8, where a lane's stack of 1 or
# 2 slots fills (along one branch a lane pushes up to depth - 1 times)
SPLIT_DEEP = (100, 100, 16, 8)
SPLIT_STACKS = (1, 2, None)  # None: the default, min(depth, 6)
SPLIT_CUT = dict(stack_size=2, max_iters=3)
QUEUE_DEPTH = 4
QUEUE_CUTOFFS = (tw.WEIGHT_CUTOFF, 1e-5)
# tests/test_whitted.py:166-169: the queue at the tight cutoff against the
# unrolled tree, the 95th percentile and the largest absolute difference
TIGHT_P95, TIGHT_MAX = 2e-3, 5e-2


def split_run(scene, cfg, lanes, **kw):
    """``trace_paths_split`` of ``lanes`` (origins, directions, uniforms
    on the card), K3's count set to 0 just before it: (radiance,
    iterations, K3 launches, wall by the host clock)."""
    ik.LAUNCHES["intersect_dense"] = 0
    stats = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rad = pt.trace_paths_split(scene, cfg, *lanes, stats=stats, **kw)
    torch.cuda.synchronize()
    return (rad, stats["iterations"], ik.LAUNCHES["intersect_dense"],
            time.perf_counter() - t0)


def split_against_cpu(label, rad, scene_cpu, cfg, cpu_lanes, **kw):
    """The first CROP_CPU lanes traced again on the CPU (plain versions)
    from the same uniforms, held to 15e's limits: >= 0.99 of lanes within
    rtol 1e-3, and the image of those lanes (CROP_CPU / pixels samples a
    pixel) within a mean absolute difference of 2e-3."""
    k = CROP_CPU
    t0 = time.perf_counter()
    rad_cpu = pt.trace_paths_split(scene_cpu, cfg,
                                   *(x[:k] for x in cpu_lanes), **kw)
    cpu_s = time.perf_counter() - t0
    got = rad[:k].cpu()
    frac = float(torch.isclose(got, rad_cpu, rtol=1e-3,
                               atol=1e-6).all(dim=1).float().mean())
    part = dataclasses.replace(cfg, spp=k // (cfg.width * cfg.height))
    img_err = float((pt._to_image(got, part)[0]
                     - pt._to_image(rad_cpu, part)[0]).abs().mean())
    log(22, f"{label}: card against CPU on lanes 0-{k - 1}: {frac:.5f} of "
            f"lanes within rtol 1e-3, mean abs image diff {img_err:.3g} "
            f"(CPU {cpu_s:.2f} s)")
    check(frac >= 0.99, f"{label}: {frac} of lanes agree with the CPU")
    check(img_err < 2e-3, f"{label}: mean abs image diff {img_err}")


def phase22_split(glass):
    """22a: the split tracer on glass 100x100x16 at depth 8 at stack_size
    1, 2 and the default, from uniforms drawn once on the CPU: iterations,
    K3 launches and the wall of a run; a second run under the recorder,
    bitwise the first, every K3 launch of it held bitwise against the
    plain version; the card against the CPU; the lane mean against
    trace_paths' from the same uniforms within 4 standard errors + 1e-3
    (tests/test_path_tracer.py:259-273); stack_size 1 apart from the
    default on some lanes (its fallback ran).  22b: stack_size 2 cut at
    max_iters 3, card against CPU, each lane at most the uncut run's."""
    scene = glass[0]
    cfg = glass_scene(*SPLIT_DEEP, device=DEV)[1]
    scene_cpu = glass_scene(device="cpu")[0]
    cpu_lanes = pt._camera_lanes(scene_cpu, cfg, 22)
    lanes = tuple(x.to(DEV) for x in cpu_lanes)
    st = pt.trace_paths(scene, cfg, *lanes)[0].double().mean(dim=1)
    se = float(st.std()) / math.sqrt(st.numel())
    size = f"{cfg.width}x{cfg.height}x{cfg.spp} depth {cfg.max_depth}"
    out = {}
    for stack in SPLIT_STACKS:
        S = stack if stack is not None else min(cfg.max_depth, 6)
        label = f"22a glass {size}, stack_size {stack} (S = {S})"
        rad, iters, k3, wall = split_run(scene, cfg, lanes, stack_size=stack)
        with Recorder("intersect_dense") as rec:
            again = pt.trace_paths_split(scene, cfg, *lanes, stack_size=stack)
        held = rec.hold_every(label, quiet=True)
        mean = float(rad.double().mean())
        log(22, f"{label}: {iters} iterations, K3 launches {k3}, wall "
                f"{wall:.3f} s; a second run bitwise the first "
                f"{torch.equal(again, rad)}, its {held} K3 launches each "
                f"bitwise the plain version; lane mean {mean:.5f}, "
                f"trace_paths' {float(st.mean()):.5f} (limit 4 se + 1e-3 = "
                f"{4 * se + 1e-3:.5f}) [{smi()}]")
        check(0 < k3 <= 2 * iters, f"{label}: {k3} K3 launches")
        check(held == k3, f"{label}: the recorder saw {held} of {k3}")
        check(torch.equal(again, rad), f"{label}: a second run differs")
        check(bool(torch.isfinite(rad).all()), f"{label}: not finite")
        check(abs(mean - float(st.mean())) < 4 * se + 1e-3,
              f"{label}: mean {mean} against {float(st.mean())} +- {se}")
        split_against_cpu(label, rad, scene_cpu, cfg, cpu_lanes,
                          stack_size=stack)
        out[stack] = rad
    apart = int(((out[1] - out[None]).abs().amax(dim=1) > 1e-6).sum())
    log(22, f"22a: stack_size 1 apart from the default on {apart} of "
            f"{st.numel()} lanes (by more than 1e-6)")
    check(apart > 0, "22a: stack_size 1 gave the default's radiance")
    label = f"22b glass {size}, stack_size 2, max_iters 3"
    rad, iters, k3, wall = split_run(scene, cfg, lanes, **SPLIT_CUT)
    below = bool((rad <= out[2]).all())
    log(22, f"{label}: {iters} iterations, K3 launches {k3}, wall "
            f"{wall:.3f} s, lane mean {float(rad.double().mean()):.5f}; "
            f"every lane at most the uncut run's {below} [{smi()}]")
    check(iters == 3 and 0 < k3 <= 6, f"{label}: {iters} iterations, {k3}")
    check(below, f"{label}: a lane gathered more than the uncut run")
    split_against_cpu(label, rad, scene_cpu, cfg, cpu_lanes, **SPLIT_CUT)


def phase22_queue(glass):
    """22c: the Whitted queue on glass 100x100 at depth 4 at the default
    cutoff and at 1e-5 against the unrolled tree from the same primary
    rays: supersteps, K3 launches, the 95th percentile and the largest
    absolute difference (at 1e-5 within tests/test_whitted.py's limits);
    every K3 launch of the tree and of both queues held bitwise against
    the plain version."""
    scene, cfg = glass
    cfg = dataclasses.replace(cfg, max_depth=QUEUE_DEPTH)
    o, d = tw._primary_rays(scene, cfg)
    label = f"22c glass {cfg.width}x{cfg.height} Whitted depth {QUEUE_DEPTH}"
    ik.LAUNCHES["intersect_dense"] = 0
    with Recorder("intersect_dense") as rec:
        tree = tw.trace_whitted(scene, o, d, QUEUE_DEPTH)
    k3 = ik.LAUNCHES["intersect_dense"]
    held = rec.hold_every(f"{label} tree", quiet=True)
    log(22, f"{label}, the unrolled tree: K3 launches {k3}, each bitwise "
            f"the plain version ({held} held)")
    check(k3 > 0 and held == k3, f"{label}: tree {k3} K3, {held} held")
    steps = {}
    for cut in QUEUE_CUTOFFS:
        ik.LAUNCHES["intersect_dense"] = 0
        stats = {}
        with Recorder("intersect_dense") as rec:
            queue = tw.trace_whitted_queue(scene, o, d, QUEUE_DEPTH,
                                           weight_cutoff=cut, stats=stats)
        k3 = ik.LAUNCHES["intersect_dense"]
        held = rec.hold_every(f"{label} queue {cut}", quiet=True)
        err = (queue - tree).abs().flatten()
        p95, top = float(torch.quantile(err, 0.95)), float(err.max())
        steps[cut] = stats["supersteps"]
        log(22, f"{label}, the queue at weight_cutoff {cut}: "
                f"{steps[cut]} supersteps, K3 launches {k3}, each bitwise "
                f"the plain version ({held} held); against the tree: 95th "
                f"percentile {p95:.3g}, max {top:.3g} [{smi()}]")
        check(k3 > 0 and held == k3, f"{label} {cut}: {k3} K3, {held} held")
        if cut < tw.WEIGHT_CUTOFF:
            check(p95 < TIGHT_P95, f"{label} {cut}: 95th percentile {p95}")
            check(top < TIGHT_MAX, f"{label} {cut}: max {top}")
    check(steps[1e-5] >= steps[tw.WEIGHT_CUTOFF],
          f"{label}: supersteps {steps}")


def phase22(glass):
    """22a-22c; returns the phase's wall time."""
    t0 = time.perf_counter()
    phase22_split(glass)
    phase22_queue(glass)
    wall = time.perf_counter() - t0
    log(22, f"phase 22 in all {wall:.2f} s")
    return wall


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
    t5 = phase5()
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
    k4_launches, k4, cull, img10 = phase10(soft)
    phase15_render("soft shadow", soft, SOFT_SHADOW_CFG, img10, ik.LAUNCHES,
                   ("tile_cull", "intersect_gather"))
    phase15_split(glass)
    wall16 = phase16(glass, soft)
    wall17 = phase17(glass, soft)
    wall18 = phase18(glass, soft)
    phase19(glass, soft)
    phase20(glass, soft)
    wall21 = phase21(glass, soft)
    phase22(glass)
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
    k5_launches, recs, prof_ms, img12 = phase12(scene, cfg)
    phase15_render("big mesh", scene, cfg, img12, tk.LAUNCHES,
                   ("treelet_walk",))
    wall16 += phase16_big(scene, cfg)
    log(16, f"phase 16 in all {wall16:.2f} s")
    wall17 += phase17_big(scene, cfg)
    log(17, f"phase 17 in all {wall17:.2f} s")
    wall18 += phase18_big(scene, cfg)
    log(18, f"phase 18 in all {wall18:.2f} s")
    wall21 += phase21_big(scene, cfg)
    log(21, f"phase 21 in all {wall21:.2f} s")
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
    phase15_photon(t5, t6, t6_timings, launches)
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

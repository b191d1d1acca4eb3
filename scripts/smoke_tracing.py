#!/usr/bin/env python3
"""The render's own spans and counters (``utils.profiling``) on an NVIDIA
GPU, on one frame of each cell of the benchmark.

Usage, from the repository root:

    python3 scripts/smoke_tracing.py [seed]

For each cell of ``BENCHMARK.json`` the cell's scene and frame settings
are built as the benchmark builds them (``ltbench/entries/render.py``).
One frame renders through ``api.render`` untraced, and the same frame
again under ``torch.profiler`` (CPU and CUDA).  Checked, failing on any
difference:

- the two images are bitwise equal;
- untraced, the cull kernel gets no accumulator;
- traced, every call of the cull gets one, and the kernel's counts (the
  accumulator's change over the call) equal torch's own sums on the
  call's output and operands: ``cnt.sum()`` and the rays with
  ``t_max > t_min``;
- traced, every call of K4 gets one too, and its count of the groups it
  tested equals the plain count (``ik.gather_group_count``) in a
  nearest-hit query and is at most that in an any-hit query;
- the frame log's record equals those sums by query kind, and its
  ``bounce_lanes`` the lane widths of the frame's bounces.

Prints one JSON line a cell (the record, the calls, the ratios the
benchmark's metrics take from it), then the card's name and power
limit.
"""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from light_transport_tpu_torch.integrators import (  # noqa: E402
    path_tracer as pt,
)
from light_transport_tpu_torch.ops import _build  # noqa: E402
from light_transport_tpu_torch.ops import intersect_kernel as ik  # noqa: E402
from light_transport_tpu_torch.utils import profiling  # noqa: E402
from ltbench.registry import Registry  # noqa: E402


def check(cond, what):
    if not cond:
        raise RuntimeError(f"check failed: {what}")


class Calls:
    """``ik.intersect_rays_pallas``, ``ik.tile_cull``,
    ``ik.intersect_gather`` and ``pt._bounce`` wrapped while installed:
    each cull and K4 call's query kind, accumulator, its change over the
    call and the plain sums, and each bounce's lane width."""

    def __init__(self):
        self.kind, self.culls, self.gathers, self.lanes = None, [], [], []

    def __enter__(self):
        self.saved = (ik.intersect_rays_pallas, ik.tile_cull,
                      ik.intersect_gather, pt._bounce)
        pallas, cull, gather, bounce = self.saved

        def pallas_kind(*a, any_hit=False, **kw):
            self.kind = "any" if any_hit else "nearest"
            return pallas(*a, any_hit=any_hit, **kw)

        def cull_counted(feats, tminmax, c_lo, c_hi, counts=None):
            before = None if counts is None else counts.clone()
            ids, cnt = cull(feats, tminmax, c_lo, c_hi, counts=counts)
            want = torch.stack([cnt.sum(dtype=torch.int64),
                                (tminmax[:, 1] > tminmax[:, 0]).sum()])
            self.culls.append((self.kind, counts is not None,
                               None if counts is None else counts - before,
                               want))
            return ids, cnt

        def gather_counted(feats, tminmax, recs, ids, cnt, any_hit=False,
                           **kw):
            counts = kw.get("counts")
            before = None if counts is None else counts.clone()
            out = gather(feats, tminmax, recs, ids, cnt, any_hit, **kw)
            plain = ik.gather_group_count(feats, tminmax, ids, cnt,
                                          *kw["groups"])
            self.gathers.append((self.kind, counts is not None,
                                 None if counts is None else counts - before,
                                 int(plain)))
            return out

        def bounce_width(scene, cfg, state, *a, **kw):
            self.lanes.append(state.alive.shape[0])
            return bounce(scene, cfg, state, *a, **kw)

        ik.intersect_rays_pallas = pallas_kind
        ik.tile_cull = cull_counted
        ik.intersect_gather = gather_counted
        pt._bounce = bounce_width
        return self

    def __exit__(self, *exc):
        (ik.intersect_rays_pallas, ik.tile_cull, ik.intersect_gather,
         pt._bounce) = self.saved


def one_cell(reg, cell, seed, dev):
    spec = reg.cell(cell)
    traffic = reg.traffic(spec["traffic"])
    sess = reg.module("entries", traffic["entry"]).Session(
        reg, reg.config(spec["config"]), traffic, dev)
    sess.job(seed + 1)  # warm
    with Calls() as off:
        plain = sess.job(seed)
    torch.cuda.synchronize()
    check(off.culls and not any(c[1] for c in off.culls + off.gathers),
          f"{cell}: an untraced cull or K4 got an accumulator")
    n_log = len(profiling.frames())
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with Calls() as on:
        with torch.profiler.profile(activities=acts):
            traced = sess.job(seed)
            torch.cuda.synchronize()
    check(torch.equal(plain, traced),
          f"{cell}: the traced image differs from the untraced")
    check(all(c[1] for c in on.culls),
          f"{cell}: a traced cull got no accumulator")
    got = torch.stack([c[2] for c in on.culls]).tolist()
    want = torch.stack([c[3] for c in on.culls]).tolist()
    for k, (g, w) in enumerate(zip(got, want)):
        check(g == w, f"{cell}: cull call {k} ({on.culls[k][0]}) counted "
                      f"{g}, torch's sums {w}")
    check(len(on.gathers) == len(on.culls) and all(c[1] for c in on.gathers),
          f"{cell}: a traced K4 got no accumulator")
    groups = [int(c[2]) for c in on.gathers]
    for k, (kind, _, _, plain) in enumerate(on.gathers):
        check(groups[k] == plain if kind == "nearest" else groups[k] <= plain,
              f"{cell}: K4 call {k} ({kind}) tested {groups[k]} groups, "
              f"the plain count {plain}")
    log = profiling.frames()
    check(len(log) == min(n_log + 1, profiling.FRAME_LOG_LEN),
          f"{cell}: the traced frame logged {len(log) - n_log} records")
    rec = log[-1]
    for kind in profiling.QUERY_KINDS:
        pairs = sum(w[0] for c, w in zip(on.culls, want) if c[0] == kind)
        live = sum(w[1] for c, w in zip(on.culls, want) if c[0] == kind)
        tested = sum(g for c, g in zip(on.gathers, groups) if c[0] == kind)
        check((rec[f"pairs.{kind}"], rec[f"live_rays.{kind}"],
               rec[f"groups.{kind}"]) == (pairs, live, tested),
              f"{cell}: the {kind} record {rec} against sums {pairs}, "
              f"{live}, {tested}")
    check(rec["bounce_lanes"] == sum(on.lanes),
          f"{cell}: bounce_lanes {rec['bounce_lanes']} against "
          f"{sum(on.lanes)}")
    pairs = rec["pairs.nearest"] + rec["pairs.any"]
    live = rec["live_rays.nearest"] + rec["live_rays.any"]
    return {"cell": cell, "seed": seed, "record": rec,
            "calls": [[c[0]] + w for c, w in zip(on.culls, want)],
            "widths": on.lanes,
            "groups": [[c[0], g, c[3]] for c, g in zip(on.gathers, groups)],
            "isect_tests_per_ray": pairs * ik.RAY_TILE * ik.TRI_TILE / live,
            "isect_issued_tests_per_ray": (
                (rec["groups.nearest"] + rec["groups.any"]) * 32
                * ik.GROUP_TRIS / live),
            "live_lane_pct": 100.0 * rec["live_rays.nearest"]
            / rec["bounce_lanes"],
            "images_bitwise": True}


def main():
    seed = int(sys.argv[1]) if len(sys.argv) > 1 else 4300000001
    if not torch.cuda.is_available():
        print("smoke_tracing: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    _build.build("intersect_kernel")
    reg = Registry(ROOT)
    for w in reg.benchmark["workloads"]:
        print(json.dumps(one_cell(reg, w["name"], seed, dev)), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Sharded runs: photon quotas and camera lanes split over shards.

The counterpart of ``light_transport_tpu.parallel.mesh``.  JAX runs one
controller over a mesh of devices with ``shard_map`` and ``psum``; here
each process drives one device (one card per process, as NCCL requires)
and holds ``local_shards`` shards of a ``batch`` axis of
``world_size * local_shards`` shards.  Local shard ``i`` has the global
index ``rank * local_shards + i``; more shards than devices repeat the
devices in turn (the counterpart of XLA's
``--xla_force_host_platform_device_count``, which JAX's tests use for an
8-device CPU mesh), so one card or the CPU can run several shards.

Every per-shard function takes its shard's global index and the shard
count explicitly, so one process can hold the whole split.  Tallies are
summed onto the first local device in shard order, then, when a process
group is initialized, by ``torch.distributed.all_reduce(SUM)``.  Ranks do
not wait for each other between chunks: each runs its shards to the end
and they meet at that one reduction.

Seeds: shard ``idx`` of a run of ``seed`` draws from
:func:`shard_seed` ``(seed, idx) = (seed + idx * 999983) & 0x7FFFFFFF``
(the port's stand-in for JAX's ``fold_in``), so shard 0 draws the
unsharded run's stream.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from light_transport_tpu_torch.core.config import PhotonRunConfig, RenderConfig
from light_transport_tpu_torch.tally.tallies import PhotonTallies

BATCH = "batch"
SHARD_SEED_STRIDE = 999_983


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The shards this process holds: ``devices[i]`` runs local shard
    ``i``, global index ``rank * len(devices) + i``."""

    devices: Tuple[torch.device, ...]
    axis: str = BATCH
    rank: int = 0
    world_size: int = 1

    @property
    def local_shards(self) -> int:
        return len(self.devices)

    @property
    def n_shards(self) -> int:
        return self.world_size * self.local_shards

    def shard_index(self, i: int) -> int:
        return self.rank * self.local_shards + i


def _group() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def make_mesh(n_devices: Optional[int] = None, axis: str = BATCH,
              device_type: str = "cuda") -> Mesh:
    """The mesh of this process: its device (the current card, or the
    CPU), held by ``n_devices`` shards (default one a device), and the
    rank and world size of the process group, if one is initialized."""
    if device_type == "cuda":
        own = [torch.device("cuda", torch.cuda.current_device())]
    else:
        own = [torch.device(device_type)]
    n = n_devices or len(own)
    rank = world = None
    if _group():
        import torch.distributed as dist

        rank, world = dist.get_rank(), dist.get_world_size()
    return Mesh(devices=tuple(own[i % len(own)] for i in range(n)),
                axis=axis, rank=rank or 0, world_size=world or 1)


def init_multihost(coordinator: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None,
                   device_type: str = "cuda") -> Mesh:
    """Join the process group and return the global mesh.

    NCCL on the card (one card a process, ``cuda:{local_rank}``, with
    ``LOCAL_RANK`` from the environment or else the rank modulo the
    host's cards), gloo on the CPU.  ``coordinator`` (``host:port``)
    with ``num_processes`` and ``process_id`` gives a ``tcp://`` address;
    without it the group reads ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``
    and ``WORLD_SIZE`` from the environment (``env://``)."""
    import torch.distributed as dist

    if coordinator is not None:
        kw = dict(init_method=f"tcp://{coordinator}",
                  world_size=num_processes, rank=process_id)
    else:
        kw = dict(init_method="env://")
    if device_type == "cuda":
        rank = process_id if process_id is not None else int(
            os.environ.get("RANK", "0"))
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, **kw)
    return make_mesh(device_type=device_type)


def shard_seed(seed: int, idx: int) -> int:
    """Seed of shard ``idx`` of a run of ``seed``."""
    return (int(seed) + int(idx) * SHARD_SEED_STRIDE) & 0x7FFFFFFF


def shard_quota(n: int, idx: int, n_shards: int) -> int:
    """Photons of shard ``idx``: ``n // n_shards``, and shard 0 also takes
    the remainder, so exactly ``n`` launch."""
    share = n // n_shards
    return share + (n - share * n_shards if idx == 0 else 0)


def reduce_tallies(parts: List[PhotonTallies], mesh: Mesh) -> PhotonTallies:
    """The shards' tallies summed in shard order (onto the first part's
    device), then over the process group when one is initialized."""
    total = functools.reduce(PhotonTallies.merge, parts)
    if _group():
        import torch.distributed as dist

        for f in dataclasses.fields(total):
            dist.all_reduce(getattr(total, f.name).reshape(-1),
                            op=dist.ReduceOp.SUM)
    return total


# --------------------------------------------------------------------------
# the superstep engine
# --------------------------------------------------------------------------

def simulate_sharded(medium, cfg: PhotonRunConfig, seed: int = 0,
                     mesh: Optional[Mesh] = None,
                     lanes_per_device: int = 16384) -> PhotonTallies:
    """Photon run over the mesh on the superstep engine: each shard runs
    its :func:`shard_quota` from :func:`shard_seed` through
    :func:`_simulate_dynamic_quota`; the tallies are summed over the
    shards.  The mesh defaults to the medium's device."""
    mesh = mesh or make_mesh(device_type=medium.device.type)
    n_sh = mesh.n_shards
    # every shard runs with the largest share's lanes, as JAX's static
    # per-device shape does
    bound = shard_quota(cfg.n_photons, 0, n_sh)
    local_cfg = dataclasses.replace(cfg, n_photons=bound)
    parts = []
    for i, dev in enumerate(mesh.devices):
        idx = mesh.shard_index(i)
        parts.append(_simulate_dynamic_quota(
            medium.to(dev), local_cfg, shard_seed(seed, idx),
            shard_quota(cfg.n_photons, idx, n_sh), lanes_per_device))
    return reduce_tallies(parts, mesh)


def _simulate_dynamic_quota(medium, cfg: PhotonRunConfig, seed: int,
                            quota: int, lanes: int,
                            max_supersteps: int = 100_000) -> PhotonTallies:
    """``transport.photon.simulate_photons`` for one shard: ``quota``
    photons on ``min(lanes, cfg.n_photons)`` lanes, rounds of
    ``cfg.steps_per_batch`` supersteps until the quota is spent and every
    lane is dead (one readback a round), at most ``max_supersteps``; no
    drain compaction."""
    from light_transport_tpu_torch.transport.photon import (
        PhotonState,
        _run_rounds,
    )

    dev = medium.device
    lanes = min(lanes, cfg.n_photons)
    round_len = max(1, cfg.steps_per_batch)
    state = PhotonState.dead(lanes, dev)
    tallies = PhotonTallies.zeros(cfg, dev)
    q = torch.tensor(quota, dtype=torch.int64, device=dev)
    step = 0
    while step < max_supersteps and bool((q > 0) | state.alive.any()):
        state, tallies, q, step = _run_rounds(
            seed, state, tallies, q, step, medium, cfg, round_len,
            max_supersteps)
    return tallies


# --------------------------------------------------------------------------
# the photon kernel (K1)
# --------------------------------------------------------------------------

def shard_lanes(n_photons: int, n_shards: int, lanes: int,
                tile_lanes: int) -> int:
    """Lanes a shard: ``lanes``, but no more than whole tiles of its
    share (at least one tile)."""
    per = max(n_photons // n_shards, 1)
    return min(lanes, max(tile_lanes, (per // tile_lanes) * tile_lanes))


def tile_quotas(n_photons: int, n_tiles: int, idx: int,
                n_shards: int) -> np.ndarray:
    """Shard ``idx``'s slice of the exact split of ``n_photons`` over the
    ``n_shards * n_tiles`` tiles of the mesh: ``base`` each, one more on
    the first ``rem`` tiles."""
    total = n_shards * n_tiles
    base = n_photons // total
    rem = n_photons - base * total
    if base + 1 >= 2 ** 31:
        raise ValueError("per-tile quota must fit in int32")
    q = np.full((total,), base, np.int32)
    q[:rem] += 1
    return q[idx * n_tiles:(idx + 1) * n_tiles]


def simulate_pallas_sharded(medium, cfg: PhotonRunConfig, seed: int = 0,
                            mesh: Optional[Mesh] = None,
                            lanes_per_device: Optional[int] = None,
                            k_steps: Optional[int] = None,
                            chunk_blocks: int = 4,
                            max_blocks: int = 200_000,
                            timings: Optional[dict] = None) -> PhotonTallies:
    """The photon kernel (``ops.photon_kernel``, K1 on the card, its plain
    version on the CPU) over the mesh.

    The launch budget is split exactly over every tile of every shard
    (:func:`tile_quotas`).  Shard ``idx`` runs block ``b`` from
    ``block_seed(shard_seed(seed, idx), b)`` with the global block index
    ``b``, so one shard is ``simulate_kernel(seed, lanes, k_steps,
    chunk_blocks)`` itself.  Each chunk dispatches every unfinished
    local shard's ``chunk_blocks`` blocks, then reads their ``more`` flags
    (quota left or a lane alive) back once; a finished shard runs no more
    blocks.  ``timings`` receives ``simulate_kernel``'s steady-state keys
    over all local shards."""
    from light_transport_tpu_torch.ops import photon_kernel as pk

    mesh = mesh or make_mesh(device_type=medium.device.type)
    n_sh = mesh.n_shards
    k_steps = k_steps or pk.K_STEPS
    lanes = shard_lanes(cfg.n_photons, n_sh,
                        lanes_per_device or (1 << 17), pk.TILE_LANES)
    engines = {dev: pk.PhotonKernelEngine(medium.to(dev), cfg, lanes,
                                          bench_mode=False, k_steps=k_steps,
                                          device=dev)
               for dev in dict.fromkeys(mesh.devices)}
    shards = []
    for i, dev in enumerate(mesh.devices):
        eng = engines[dev]
        idx = mesh.shard_index(i)
        shards.append(dict(
            eng=eng, seed=shard_seed(seed, idx), state=eng.zero_state(),
            tallies=PhotonTallies.zeros(cfg, dev),
            quota=torch.as_tensor(tile_quotas(cfg.n_photons, eng.n_tiles,
                                              idx, n_sh), device=dev)))

    def sync():
        for dev in engines:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def steps():
        return sum(s["tallies"].n_steps for s in shards)

    t0 = time.perf_counter()
    t1 = s1 = None
    c1 = blocks = 0
    live = list(shards)
    for c in range(0, max_blocks, chunk_blocks):
        for s in live:
            for b in range(c, min(c + chunk_blocks, max_blocks)):
                counters = s["eng"].run_block(
                    s["state"], s["tallies"], pk.block_seed(s["seed"], b),
                    s["quota"], b)
                s["quota"] = s["eng"].accumulate(s["tallies"], counters)
        blocks = min(c + chunk_blocks, max_blocks)
        more = torch.stack([(s["quota"] > 0).any()
                            | (s["state"].w > 0.0).any()
                            for s in live]).tolist()  # one readback
        if t1 is None:
            sync()
            t1, s1, c1 = time.perf_counter(), steps(), blocks
        live = [s for s, m in zip(live, more) if m]
        if not live:
            break
    if timings is not None and t1 is not None:
        sync()
        pk.steady_timings(timings, t0, t1, time.perf_counter(), s1, steps(),
                          blocks - c1, lanes * len(shards), k_steps)
    return reduce_tallies([s["tallies"] for s in shards], mesh)


# --------------------------------------------------------------------------
# the camera render
# --------------------------------------------------------------------------

def render_sharded(scene, cfg: RenderConfig, seed: int = 0,
                   mesh: Optional[Mesh] = None,
                   ray_chunk: Optional[int] = None):
    """Camera render with the lanes split over the mesh.

    The lanes and their uniforms are drawn at full width as
    ``path_tracer.render_image`` draws them (through its
    ``_camera_lanes``: the Sobol' sampler and the thin lens included),
    padded to a multiple of the
    shard count (origin 0, direction (0, 0, 1), uniforms 0.5) and cut
    into contiguous shards; each shard is traced on its own (through
    ``trace_paths_split`` when ``cfg.fresnel_mode="split"``), and the
    radiance, gathered in lane order over the process group if there is
    one, forms the image as ``render_image`` forms it.  The mesh defaults
    to the scene's device, and every shard traces on it."""
    from light_transport_tpu_torch.integrators import path_tracer as pt

    pt._check_config(cfg)
    mesh = mesh or make_mesh(device_type=scene.device.type)
    if any(d != scene.device for d in mesh.devices):
        raise ValueError(f"render_sharded traces on the scene's device "
                         f"{scene.device}; the mesh holds {mesh.devices}")
    n = cfg.height * cfg.width * cfg.spp
    n_sh = mesh.n_shards
    pad = (-n) % n_sh
    origins, directions, uniforms = pt._camera_lanes(scene, cfg, seed)
    if pad:
        z3 = torch.zeros((pad, 3), dtype=origins.dtype, device=origins.device)
        up = z3.clone()
        up[:, 2] = 1.0
        origins = torch.cat([origins, z3])
        directions = torch.cat([directions, up])
        uniforms = torch.cat([uniforms, torch.full(
            (pad,) + tuple(uniforms.shape[1:]), 0.5, dtype=uniforms.dtype,
            device=uniforms.device)])
    per = (n + pad) // n_sh
    parts = []
    for i in range(mesh.local_shards):
        sl = slice(mesh.shard_index(i) * per, (mesh.shard_index(i) + 1) * per)
        o, d, u = origins[sl], directions[sl], uniforms[sl]
        if cfg.fresnel_mode == "split":
            rad = pt.trace_paths_split(scene, cfg, o, d, u,
                                       ray_chunk=ray_chunk)
        else:
            rad = pt.trace_paths(scene, cfg, o, d, u, ray_chunk=ray_chunk)[0]
        parts.append(rad)
    radiance = torch.cat(parts)
    if mesh.world_size > 1:
        import torch.distributed as dist

        out = [torch.empty_like(radiance) for _ in range(mesh.world_size)]
        dist.all_gather(out, radiance)
        radiance = torch.cat(out)
    return pt._to_image(radiance[:n], cfg)[0]


def render_bdpt_sharded(scene, cfg: RenderConfig, seed: int = 0,
                        mesh: Optional[Mesh] = None,
                        ray_chunk: Optional[int] = None,
                        light_tracing: bool = True):
    """BDPT render with the camera and light-walk lanes split over the
    mesh (every (s, t) strategy; area, point and mixed light families).

    The lanes dict is drawn at full width as ``bdpt.render_bdpt`` draws it
    (``bdpt._bdpt_lane_uniforms``), so every lane's transport is the
    unsharded render's.  It is padded to a multiple of the shard count
    (``mask`` False, uniforms 0, direction (0, 0, 1)) and cut into
    contiguous shards, each run through ``bdpt._bdpt_body``, which bars
    the pad lanes from splatting.  The radiance rows are gathered in lane
    order over the process group if there is one; the splat planes are
    summed over the local shards in shard order, then by
    ``all_reduce(SUM)``, so splat pixels match the unsharded scatter to
    float tolerance, not bitwise.  The mesh defaults to the scene's
    device, and every shard traces on it."""
    from light_transport_tpu_torch.integrators import bdpt as B

    mesh = mesh or make_mesh(device_type=scene.device.type)
    if any(d != scene.device for d in mesh.devices):
        raise ValueError(f"render_bdpt_sharded traces on the scene's device "
                         f"{scene.device}; the mesh holds {mesh.devices}")
    mode, q_point = B._light_family(scene)
    n = cfg.height * cfg.width * cfg.spp
    n_sh = mesh.n_shards
    pad = (-n) % n_sh
    lanes = B._bdpt_lane_uniforms(scene, cfg, seed, mode)
    if pad:
        lanes = {k: torch.cat([v, v.new_zeros((pad,) + tuple(v.shape[1:]))])
                 for k, v in lanes.items()}
        # keep the pad lanes' camera rays well formed (unit direction);
        # their rows are cut away and their walks splat nothing
        lanes["d"][n:, 2] = 1.0
    per = (n + pad) // n_sh
    rads, splat = [], None
    for i in range(mesh.local_shards):
        lo = mesh.shard_index(i) * per
        shard = {k: v[lo:lo + per] for k, v in lanes.items()}
        rad, sp = B._bdpt_body(scene, cfg, shard, ray_chunk, light_tracing,
                               mode, q_point)
        rads.append(rad)
        splat = sp if splat is None else splat + sp
    radiance = torch.cat(rads)
    if mesh.world_size > 1:
        import torch.distributed as dist

        out = [torch.empty_like(radiance) for _ in range(mesh.world_size)]
        dist.all_gather(out, radiance)
        radiance = torch.cat(out)
        dist.all_reduce(splat, op=dist.ReduceOp.SUM)
    return B._bdpt_assemble(cfg, radiance[:n], splat)

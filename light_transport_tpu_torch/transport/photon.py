"""Photon Monte Carlo superstep engine for layered media (plain torch).

The per-photon random walk is a vectorized population of lanes advanced
in lockstep supersteps — the MCML hop-drop-spin cycle as masked ops:

  hop   : sample optical depth tau = -ln(1-u); move min(tau/mu_t, boundary)
  drop  : deposit w * mu_a/mu_t into the (r, z) absorption grid
  spin  : Henyey-Greenstein deflection (analytic inverse CDF)
  bounce: Fresnel reflect/refract at layer interfaces, with the remaining
          optical depth carried across the interface (MCML "sleft"); exit
          tallies at top/bottom
  roulette + respawn: dead lanes reload fresh photons from the quota

Uniforms for superstep ``s`` come from a ``torch.Generator`` seeded from
(seed, s), so a run is a pure function of its seed.  Tallies are updated
in place (the grids are large; a functional update would copy them every
step).  This engine reaches no hand-written kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from light_transport_tpu_torch.core.config import PhotonRunConfig
from light_transport_tpu_torch.core.rng import fold_seed
from light_transport_tpu_torch.ops import sampling
from light_transport_tpu_torch.scene.medium import LayeredMedium
from light_transport_tpu_torch.tally.tallies import PhotonTallies

# uniform slots per lane per superstep
_U_TAU, _U_HG, _U_PHI, _U_FRESNEL, _U_RR = range(5)
_NUM_U = 5


@dataclasses.dataclass
class PhotonState:
    pos: torch.Tensor  # (N, 3); z increases into the medium, surface at z=0
    dir: torch.Tensor  # (N, 3) unit
    w: torch.Tensor  # (N,) packet weight
    layer: torch.Tensor  # (N,) int32 current layer
    tau: torch.Tensor  # (N,) leftover optical depth of an interrupted hop
    alive: torch.Tensor  # (N,) bool

    @staticmethod
    def dead(n: int, device="cuda") -> "PhotonState":
        f32 = torch.float32
        d = torch.zeros((n, 3), dtype=f32, device=device)
        d[:, 2] = 1.0
        return PhotonState(
            pos=torch.zeros((n, 3), dtype=f32, device=device),
            dir=d,
            w=torch.zeros((n,), dtype=f32, device=device),
            layer=torch.zeros((n,), dtype=torch.int32, device=device),
            tau=torch.zeros((n,), dtype=f32, device=device),
            alive=torch.zeros((n,), dtype=torch.bool, device=device),
        )

    def select(self, idx: torch.Tensor) -> "PhotonState":
        return PhotonState(**{f.name: getattr(self, f.name)[idx]
                              for f in dataclasses.fields(self)})


def step_uniforms(seed: int, step: int, n: int, device) -> torch.Tensor:
    """(n, 5) uniforms of superstep ``step`` from a generator seeded with
    ``core.rng.fold_seed(seed, step)``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(fold_seed(seed, step))
    return torch.rand((n, _NUM_U), generator=gen, device=device)


def _grid_indices(pos, cfg: PhotonRunConfig):
    r = torch.sqrt(pos[:, 0] ** 2 + pos[:, 1] ** 2)
    ir = torch.clamp(r / cfg.dr, 0, cfg.nr - 1).to(torch.int64)
    iz = torch.clamp(pos[:, 2] / cfg.dz, 0, cfg.nz - 1).to(torch.int64)
    return ir, iz


def superstep(
    state: PhotonState,
    tallies: PhotonTallies,
    u: torch.Tensor,  # (N, 5) uniforms for this superstep
    medium: LayeredMedium,
    cfg: PhotonRunConfig,
    quota: torch.Tensor,  # () int64: photons still allowed to launch
) -> Tuple[PhotonState, PhotonTallies, torch.Tensor]:
    """One lockstep hop-drop-spin event per lane.  Returns (state, tallies,
    quota); ``tallies`` is updated in place and returned."""
    num_layers = medium.num_layers
    f32 = torch.float32

    # ---- respawn dead lanes from the quota --------------------------------
    dead = ~state.alive
    order = torch.cumsum(dead.to(torch.int64), 0)  # 1-based rank, exact
    respawn = dead & (order <= quota)
    n_respawn = respawn.sum()
    r_sp = sampling.schlick_r0(medium.n_above, medium.n[0])
    w0 = 1.0 - r_sp
    pos = torch.where(respawn[:, None], 0.0, state.pos)
    up = torch.tensor([0.0, 0.0, 1.0], dtype=f32, device=pos.device)
    direc = torch.where(respawn[:, None], up, state.dir)
    w = torch.where(respawn, w0, state.w)
    layer = torch.where(respawn, 0, state.layer).to(torch.int32)
    tau = torch.where(respawn, 0.0, state.tau)
    alive = state.alive | respawn
    quota = quota - n_respawn
    tallies.specular += n_respawn.double() * r_sp.double()
    tallies.launched += n_respawn
    tallies.steps += alive.sum()

    # ---- hop ---------------------------------------------------------------
    li = layer.long()
    mu_t = medium.mu_t[li]
    mu_a = medium.mu_a[li]
    g = medium.g[li]
    tau_new = torch.where(tau > 0.0, tau, -torch.log1p(-u[:, _U_TAU]))
    s = tau_new / torch.clamp(mu_t, min=1e-12)

    uz = direc[:, 2]
    z = pos[:, 2]
    zb = torch.where(uz > 0.0, medium.z_bot[li], medium.z_top[li])
    flat = torch.abs(uz) < 1e-12
    safe_uz = torch.where(flat, 1.0, uz)
    db = torch.where(flat, float("inf"), (zb - z) / safe_uz)
    db = torch.clamp(db, min=0.0)
    hits_boundary = alive & (db < s)

    dist = torch.minimum(s, db)
    pos = torch.where(alive[:, None], pos + direc * dist[:, None], pos)
    # leftover optical depth carried across the interface (MCML sleft)
    tau = torch.where(hits_boundary, tau_new - db * mu_t, 0.0)

    # ---- drop + spin (scatter lanes) ---------------------------------------
    scatters = alive & ~hits_boundary
    ir, iz = _grid_indices(pos, cfg)
    albedo_comp = mu_a / torch.clamp(mu_t, min=1e-12)
    dw = torch.where(scatters, w * albedo_comp, 0.0)
    tallies.absorb_rz.index_put_((ir, iz), dw, accumulate=True)
    tallies.absorbed += dw.double().sum()
    if cfg.vol_nx > 0:
        # 3-D cartesian volume: x/y centered on the beam axis, z downward;
        # clips into edge cells like the (r, z) grid's overflow bins
        vx = torch.clamp(pos[:, 0] / cfg.vol_dx + 0.5 * cfg.vol_nx,
                         0, cfg.vol_nx - 1).to(torch.int64)
        vy = torch.clamp(pos[:, 1] / cfg.vol_dy + 0.5 * cfg.vol_ny,
                         0, cfg.vol_ny - 1).to(torch.int64)
        vz = torch.clamp(pos[:, 2] / cfg.vol_dz,
                         0, cfg.vol_nz - 1).to(torch.int64)
        tallies.absorb_xyz.index_put_((vx, vy, vz), dw, accumulate=True)
    w = w - dw

    cos_hg = sampling.sample_henyey_greenstein(g, u[:, _U_HG])
    new_dir_scatter = sampling.scatter_direction(direc, cos_hg, u[:, _U_PHI])

    # roulette (after drop, MCML convention)
    low_w = scatters & (w < cfg.weight_threshold)
    survive = u[:, _U_RR] < cfg.rr_survive
    w = torch.where(low_w & survive, w / cfg.rr_survive, w)
    alive = alive & ~(low_w & ~survive)

    # ---- boundary (Fresnel) lanes ------------------------------------------
    going_down = uz > 0.0
    next_layer = torch.where(going_down, li + 1, li - 1)
    n1 = medium.n[li]
    # neighbor index via padded table [n_above, n_0..n_{L-1}, n_below]
    n_padded = torch.cat([medium.n_above[None], medium.n, medium.n_below[None]])
    n2 = n_padded[torch.clamp(next_layer, -1, num_layers) + 1]
    cos_i = torch.abs(uz)
    refl_p = sampling.fresnel_dielectric(cos_i, n1, n2)
    do_reflect = u[:, _U_FRESNEL] < refl_p

    # reflected: flip z component, stay in layer, keep leftover tau
    dir_reflect = direc * torch.tensor([1.0, 1.0, -1.0], dtype=f32,
                                       device=direc.device)
    # transmitted: Snell in the meridional plane
    eta = n1 / n2
    sin_t2 = eta**2 * (1.0 - cos_i**2)
    cos_t = torch.sqrt(torch.clamp(1.0 - sin_t2, min=0.0))
    dir_transmit = torch.stack(
        [direc[:, 0] * eta, direc[:, 1] * eta, torch.sign(uz) * cos_t], dim=-1)
    exits = hits_boundary & ~do_reflect & (
        (next_layer < 0) | (next_layer >= num_layers))
    exit_top = exits & ~going_down
    exit_bot = exits & going_down
    tallies.refl_r.index_put_((ir,), torch.where(exit_top, w, 0.0).double(),
                              accumulate=True)
    tallies.trans_r.index_put_((ir,), torch.where(exit_bot, w, 0.0).double(),
                               accumulate=True)
    if cfg.detector_nx > 0:
        # cartesian exit-detector image over the top surface
        nx = cfg.detector_nx
        half = cfg.detector_extent
        scale = nx / (2.0 * half)
        ix = torch.clamp((pos[:, 0] + half) * scale, 0, nx - 1).to(torch.int64)
        iy = torch.clamp((pos[:, 1] + half) * scale, 0, nx - 1).to(torch.int64)
        tallies.detector_xy.index_put_(
            (ix, iy), torch.where(exit_top, w, 0.0), accumulate=True)

    transmit_inside = hits_boundary & ~do_reflect & ~exits

    # ---- merge -------------------------------------------------------------
    new_dir = torch.where(
        scatters[:, None], new_dir_scatter,
        torch.where((hits_boundary & do_reflect)[:, None], dir_reflect,
                    torch.where(hits_boundary[:, None], dir_transmit, direc)))
    new_layer = torch.where(transmit_inside, next_layer, li).to(torch.int32)
    alive = alive & ~exits

    # nudge boundary-lane z off the interface to dodge f32 re-hit loops
    z_adj = torch.where(hits_boundary & alive,
                        pos[:, 2] + torch.sign(new_dir[:, 2]) * 1e-7, pos[:, 2])
    pos = torch.cat([pos[:, :2], z_adj[:, None]], dim=1)

    new_state = PhotonState(pos=pos, dir=new_dir, w=w, layer=new_layer,
                            tau=tau, alive=alive)
    return new_state, tallies, quota


def _run_rounds(seed, state, tallies, quota, step, medium, cfg, length, cap):
    """``length`` supersteps, none past ``cap``; uniforms key on the global
    step index, so round length never changes the stream."""
    n = state.w.shape[0]
    for s in range(step, min(step + length, cap)):
        u = step_uniforms(seed, s, n, state.w.device)
        state, tallies, quota = superstep(state, tallies, u, medium, cfg,
                                          quota)
    return state, tallies, quota, min(step + length, cap)


def simulate_photons(
    medium: LayeredMedium,
    cfg: PhotonRunConfig,
    seed: int = 0,
    lanes: int = 16384,
    max_supersteps: int = 100_000,
    compact_drain: bool | None = None,
    min_lanes: int = 65536,
    device=None,
) -> PhotonTallies:
    """Run exactly ``cfg.n_photons`` photons to completion (unbiased: the
    loop continues until every launched photon has exited or died).

    * **Main phase** (quota remaining): every lane respawns from the quota
      as it dies; the termination check runs once per
      ``cfg.steps_per_batch`` round.
    * **Drain phase** (quota exhausted): the live lanes are compacted
      (stable, live first) down to the next power of two >= the live
      count, and run in 4x-length rounds, several per host check.
      ``compact_drain=None`` enables it at >= 2^16 lanes.
    """
    device = torch.device(device) if device is not None else medium.device
    medium = medium.to(device)
    lanes = min(lanes, cfg.n_photons)
    if compact_drain is None:
        compact_drain = lanes >= 65536
    round_len = max(1, cfg.steps_per_batch)

    state = PhotonState.dead(lanes, device)
    tallies = PhotonTallies.zeros(cfg, device)
    quota = torch.tensor(cfg.n_photons, dtype=torch.int64, device=device)
    step = 0
    while step < max_supersteps and int(quota) > 0:  # one sync per round
        state, tallies, quota, step = _run_rounds(
            seed, state, tallies, quota, step, medium, cfg, round_len,
            max_supersteps)

    n_lanes = lanes
    drain_len = round_len * 4
    rounds_per_sync = 4
    while step < max_supersteps:
        n_alive = int(state.alive.sum())  # one sync per batch of rounds
        if n_alive == 0:
            break
        if compact_drain:
            target = max(min_lanes, 1 << (max(n_alive, 1) - 1).bit_length())
            target = min(target, n_lanes)
            if target != n_lanes:
                state = _compact(state, target)
                n_lanes = target
        for _ in range(rounds_per_sync):
            state, tallies, quota, step = _run_rounds(
                seed, state, tallies, quota, step, medium, cfg, drain_len,
                max_supersteps)
    return tallies


def _compact(state: PhotonState, target: int) -> PhotonState:
    # live lanes first (stable: preserves relative order), then slice
    order = torch.argsort((~state.alive).to(torch.int8), stable=True)[:target]
    return state.select(order)


def run_fixed_steps(medium: LayeredMedium, cfg: PhotonRunConfig, seed: int,
                    lanes: int, n_steps: int, device=None):
    """``n_steps`` supersteps with unconditional respawn (unbounded quota).
    Returns (state, tallies); ``tallies.steps`` counts the lane events."""
    device = torch.device(device) if device is not None else medium.device
    medium = medium.to(device)
    state = PhotonState.dead(lanes, device)
    tallies = PhotonTallies.zeros(cfg, device)
    quota = torch.tensor(2**31 - 1, dtype=torch.int64, device=device)
    for s in range(n_steps):
        u = step_uniforms(seed, s, lanes, device)
        state, tallies, _ = superstep(state, tallies, u, medium, cfg, quota)
    return state, tallies

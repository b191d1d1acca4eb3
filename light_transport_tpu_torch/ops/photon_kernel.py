"""The fused MCML photon block: hand-written CUDA kernel plus its plain
PyTorch version, and the quota / bench engines built on them.

One *block* runs ``k_steps`` hop-drop-spin supersteps on every lane with
the photon state held in registers (``csrc/photon_kernel.cu``):

* **Quota mode.** At block start the dead lanes of each tile respawn,
  ranked 1-based in lane order against the tile's launch quota; then a
  per-lane random phase is drawn for the strided spatial deposits (a
  second one for the volume when ``vol_stride != tally_stride``).  With
  ``cfg.respawn_windows = N`` the roulette/absorption-dead lanes respawn
  again at every Nth stride window; lanes that exited in this block wait.
* **Bench mode.** Every dead lane respawns at every step, with no quota;
  only the counters are kept.
* **Tallies.** A scattering lane whose phase matches ``step % stride``
  adds ``dw * stride`` into the (r, z) grid (``vol_stride`` likewise for
  the volume); an exiting lane adds its weight into the exit-by-radius
  table and, at the top surface, the detector image.  On the card the
  strided deposits are kept per lane and added at the end of their
  window (the same adds), the exits at the event, all by atomic adds; the
  plain version uses ``index_put_(accumulate=True)``.
* **Counters.** Each block returns ``(n_tiles, 5)`` float64 per-tile
  ``launched, specular, steps, quota, absorbed``, folded by the engine
  into exact int64 / float64 tallies.

Uniform draw ``d`` of a lane sits at ``u[d, lane]``: draws 0 (and 1) are
the phase draws in quota mode, then superstep ``s`` takes draws
``n_phase + 5 s + j`` for j = tau, HG, phi, Fresnel, roulette.  The
kernel makes them with an in-kernel Philox4x32-10 unless the caller
hands it ``u``; the plain version always takes ``u`` (drawn from a
``torch.Generator`` when the caller gives none).  :func:`philox_uniforms`
computes the kernel's own stream in plain PyTorch.

:func:`photon_block` runs the plain version for tensors on the CPU and
the kernel for tensors on a CUDA device; it has no other path.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from light_transport_tpu_torch.core.config import PhotonRunConfig
from light_transport_tpu_torch.scene.medium import LayeredMedium
from light_transport_tpu_torch.tally.tallies import PhotonTallies

K_STEPS = 32  # supersteps fused per block
TILE_LANES = 256  # lanes per tile (one CUDA thread block; the kernel's
# launch bound, so the most a tile may have on the card)
MAX_LAYERS = 8  # layers the kernel's by-value medium table holds

# kernel launches made through photon_block (read and reset by callers)
LAUNCHES = 0

_TWO_PI_F32 = float(np.float32(2.0 * math.pi))


class KernelState(NamedTuple):
    """Flat ``(lanes,)`` photon state; lane order is the JAX engine's
    row-major ``(rows, 128)`` order."""

    px: torch.Tensor
    py: torch.Tensor
    pz: torch.Tensor
    dx: torch.Tensor
    dy: torch.Tensor
    dz: torch.Tensor
    w: torch.Tensor
    tau: torch.Tensor
    layer: torch.Tensor  # int32

    @staticmethod
    def zeros(lanes: int, device) -> "KernelState":
        def z():
            return torch.zeros((lanes,), dtype=torch.float32, device=device)

        return KernelState(z(), z(), z(), z(), z(), z() + 1.0, z(), z(),
                           torch.zeros((lanes,), dtype=torch.int32,
                                       device=device))

    def clone(self) -> "KernelState":
        return KernelState(*(t.clone() for t in self))


def n_draws(k_steps: int, bench_mode: bool, vol_phase: bool = False) -> int:
    """Uniforms one lane takes per block: 5 per superstep plus the
    deposit phase draw(s) in quota mode."""
    if bench_mode:
        return 5 * k_steps
    return 5 * k_steps + 1 + (1 if vol_phase else 0)


@dataclasses.dataclass(frozen=True)
class BlockPlan:
    """Everything static about one block: the per-layer tables (computed
    in Python doubles, used as float32) and the tally geometry."""

    num_layers: int
    mu_t: tuple
    inv_mu_t: tuple
    albedo_a: tuple
    g: tuple
    one_m_g2: tuple
    one_p_g2: tuple
    inv_2g: tuple
    z_top: tuple
    z_bot: tuple
    eta_dn: tuple
    eta_up: tuple
    r_sp: float
    w0: float
    bench_mode: bool
    k_steps: int
    stride: int
    vol_stride: int
    sep_vol_phase: bool
    respawn_windows: int
    tile_lanes: int
    nr: int
    nz: int
    inv_dr: float
    inv_dz: float
    det_nx: int
    det_half: float
    det_scale: float
    vol_nx: int
    vol_ny: int
    vol_nz: int
    inv_vdx: float
    inv_vdy: float
    inv_vdz: float
    wthresh: float
    rr_surv: float

    @property
    def n_phase(self) -> int:
        return 0 if self.bench_mode else (2 if self.sep_vol_phase else 1)

    @property
    def n_draws(self) -> int:
        return n_draws(self.k_steps, self.bench_mode, self.sep_vol_phase)

    @staticmethod
    def build(medium: LayeredMedium, cfg: PhotonRunConfig, bench_mode: bool,
              k_steps: int, stride: int, vol_stride: int,
              tile_lanes: int) -> "BlockPlan":
        def vals(t):
            return tuple(float(v) for v in t.detach().cpu().tolist())

        mu_t, mu_a, g_tab, n_tab = (vals(medium.mu_t), vals(medium.mu_a),
                                    vals(medium.g), vals(medium.n))
        z_top, z_bot = vals(medium.z_top), vals(medium.z_bot)
        n_above, n_below = float(medium.n_above), float(medium.n_below)
        num_layers = len(mu_t)
        if num_layers > MAX_LAYERS:
            raise ValueError(f"{num_layers} layers: the photon kernel holds "
                             f"at most {MAX_LAYERS}")
        r_sp = ((n_above - n_tab[0]) / (n_above + n_tab[0])) ** 2

        def n_of(l):
            if l < 0:
                return n_above
            if l >= num_layers:
                return n_below
            return n_tab[l]

        return BlockPlan(
            num_layers=num_layers,
            mu_t=mu_t,
            inv_mu_t=tuple(1.0 / max(m, 1e-12) for m in mu_t),
            albedo_a=tuple(a / max(m, 1e-12) for a, m in zip(mu_a, mu_t)),
            g=g_tab,
            one_m_g2=tuple(1.0 - gg * gg for gg in g_tab),
            one_p_g2=tuple(1.0 + gg * gg for gg in g_tab),
            inv_2g=tuple(0.5 / (1.0 if abs(gg) < 1e-3 else gg)
                         for gg in g_tab),
            z_top=z_top, z_bot=z_bot,
            eta_dn=tuple(n_tab[l] / n_of(l + 1) for l in range(num_layers)),
            eta_up=tuple(n_tab[l] / n_of(l - 1) for l in range(num_layers)),
            r_sp=r_sp, w0=1.0 - r_sp,
            bench_mode=bench_mode, k_steps=k_steps, stride=stride,
            vol_stride=vol_stride,
            sep_vol_phase=(cfg.vol_nx > 0 and vol_stride != stride
                           and not bench_mode),
            respawn_windows=0 if bench_mode else int(cfg.respawn_windows),
            tile_lanes=tile_lanes,
            nr=cfg.nr, nz=cfg.nz, inv_dr=1.0 / cfg.dr, inv_dz=1.0 / cfg.dz,
            det_nx=cfg.detector_nx, det_half=cfg.detector_extent,
            det_scale=(cfg.detector_nx / (2.0 * cfg.detector_extent)
                       if cfg.detector_nx > 0 else 0.0),
            vol_nx=cfg.vol_nx, vol_ny=cfg.vol_ny, vol_nz=cfg.vol_nz,
            inv_vdx=1.0 / cfg.vol_dx, inv_vdy=1.0 / cfg.vol_dy,
            inv_vdz=1.0 / cfg.vol_dz,
            wthresh=cfg.weight_threshold, rr_surv=cfg.rr_survive,
        )


def block_uniforms(plan: BlockPlan, seed: int, lanes: int,
                   device) -> torch.Tensor:
    """``(n_draws, lanes)`` uniforms for one block from a generator seeded
    with the block's seed."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & 0x7FFFFFFFFFFFFFFF)
    return torch.rand((plan.n_draws, lanes), generator=gen, device=device)


# --------------------------------------------------------------------------
# the kernel's Philox4x32-10 stream in plain PyTorch
# --------------------------------------------------------------------------

_M32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _mulhilo(a: torch.Tensor, m: int):
    """(high, low) 32-bit words of ``a * m`` for int64 ``a`` in [0, 2^32):
    the product is taken in 16-bit halves, so no partial overflows int64."""
    ah, al = a >> 16, a & 0xFFFF
    mh, ml = m >> 16, m & 0xFFFF
    mid = ah * ml + al * mh  # < 2^33
    low = al * ml + ((mid & 0xFFFF) << 16)  # < 2^33
    return ah * mh + (mid >> 16) + (low >> 32), low & _M32


def philox4x32_10(counter, key):
    """Philox4x32-10 (Random123's) of ``counter``, four int64 tensors of
    32-bit words, under ``key``, two ints; returns the four output words.
    The round is the kernel's ``philox4x32_10``."""
    c0, c1, c2, c3 = counter
    k0, k1 = key[0] & _M32, key[1] & _M32
    for _ in range(10):
        hi0, lo0 = _mulhilo(c0, _PHILOX_M[0])
        hi1, lo1 = _mulhilo(c2, _PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _PHILOX_W[0]) & _M32, (k1 + _PHILOX_W[1]) & _M32
    return c0, c1, c2, c3


def philox_uniforms(plan: BlockPlan, seed: int, block_index: int, lanes: int,
                    device=None) -> torch.Tensor:
    """The ``(n_draws, lanes)`` float32 uniforms the kernel draws inside
    for one block: draw ``d`` of lane ``l`` is word ``d & 3`` of the group
    at counter ``(l, block_index, d >> 2, 0)`` under key ``(seed lo, seed
    hi)``, mapped as ``(word >> 8) * 2^-24``.  Fed to the kernel as ``u``,
    it gives the kernel's own stream bit for bit."""
    n_groups = (plan.n_draws + 3) // 4
    i64 = torch.int64
    lane = torch.arange(lanes, dtype=i64, device=device)[None, :]
    group = torch.arange(n_groups, dtype=i64, device=device)[:, None]
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    words = philox4x32_10(
        (lane.expand(n_groups, lanes),
         torch.full_like(group, int(block_index) & 0x7FFFFFFF)
         .expand(n_groups, lanes),
         group.expand(n_groups, lanes),
         torch.zeros((n_groups, lanes), dtype=i64, device=device)),
        (seed & _M32, seed >> 32))
    # (n_groups, 4, lanes) -> draws in order, 24 high bits of each word
    u = torch.stack(words, dim=1).reshape(4 * n_groups, lanes)[:plan.n_draws]
    return (u >> 8).to(torch.float32) * 2.0 ** -24


# --------------------------------------------------------------------------
# plain PyTorch version
# --------------------------------------------------------------------------

def _bin(v: torch.Tensor, n: int) -> torch.Tensor:
    """Truncating float -> int bin, clipped to [0, n-1].  The clamp runs in
    float before the cast (an out-of-range cast is undefined); values in
    range bin as ``clip(int(v))`` does."""
    return torch.clamp(v, 0.0, float(n - 1)).to(torch.int64)


def photon_block_reference(plan: BlockPlan, state: KernelState,
                           quota: torch.Tensor, tallies: PhotonTallies,
                           u: torch.Tensor) -> torch.Tensor:
    """One block in plain PyTorch.  ``state`` is updated in place and the
    block's deposits are added into ``tallies``; returns the ``(n_tiles,
    5)`` float64 counters.  ``quota``: ``(n_tiles,)`` int32 launch budget
    (ignored in bench mode); ``u``: ``(n_draws, lanes)`` float32."""
    p = plan
    dev = state.w.device
    f32 = torch.float32
    lanes = state.w.shape[0]
    T = p.tile_lanes
    n_tiles = lanes // T

    def tab(v):
        return torch.tensor(v, dtype=f32, device=dev)

    mu_t, inv_mu_t, albedo_a = tab(p.mu_t), tab(p.inv_mu_t), tab(p.albedo_a)
    g_tab, one_m_g2, one_p_g2 = tab(p.g), tab(p.one_m_g2), tab(p.one_p_g2)
    inv_2g, z_top, z_bot = tab(p.inv_2g), tab(p.z_top), tab(p.z_bot)
    eta_dn, eta_up = tab(p.eta_dn), tab(p.eta_up)
    w0 = float(np.float32(p.w0))

    x, y, z, ux, uy, uz, w, tau = (t.clone() for t in state[:8])
    layer = state.layer.long()
    q = quota.to(torch.int64).clone()
    launches = torch.zeros((lanes,), dtype=torch.int64, device=dev)
    steps = torch.zeros((lanes,), dtype=torch.int64, device=dev)
    absorbed = torch.zeros((lanes,), dtype=f32, device=dev)
    exited = torch.zeros((lanes,), dtype=torch.bool, device=dev)
    rz = tallies.absorb_rz.view(-1)
    vol = tallies.absorb_xyz.view(-1) if p.vol_nx > 0 else None
    det = tallies.detector_xy.view(-1) if p.det_nx > 0 else None

    def respawn(eligible=None):
        nonlocal x, y, z, ux, uy, uz, w, tau, layer, q, launches
        dead = w <= 0.0
        if eligible is not None:
            dead = dead & eligible
        if p.bench_mode:
            can = dead
        else:
            dt = dead.view(n_tiles, T)
            rank = torch.cumsum(dt.to(torch.int64), 1)  # 1-based, lane order
            can_t = dt & (rank <= q[:, None])
            q = q - can_t.sum(1)
            can = can_t.view(-1)
        zero = torch.zeros((), dtype=f32, device=dev)
        x, y, z = (torch.where(can, zero, t) for t in (x, y, z))
        ux, uy = torch.where(can, zero, ux), torch.where(can, zero, uy)
        uz = torch.where(can, zero + 1.0, uz)
        w = torch.where(can, zero + w0, w)
        tau = torch.where(can, zero, tau)
        layer = torch.where(can, 0, layer)
        launches = launches + can

    phase = phase_v = None
    if not p.bench_mode:
        respawn()
        phase = torch.clamp((u[0] * float(p.stride)).to(torch.int64),
                            max=p.stride - 1)
        if p.sep_vol_phase:
            phase_v = torch.clamp((u[1] * float(p.vol_stride))
                                  .to(torch.int64), max=p.vol_stride - 1)
        else:
            phase_v = phase

    for s in range(p.k_steps):
        if (p.respawn_windows and s % p.stride == 0 and s > 0
                and (s // p.stride) % p.respawn_windows == 0):
            respawn(eligible=~exited)
        if p.bench_mode:
            respawn()
        alive = w > 0.0
        steps = steps + alive
        b = p.n_phase + 5 * s
        u_tau, u_hg, u_phi, u_fr, u_rr = u[b], u[b + 1], u[b + 2], u[b + 3], u[b + 4]

        # ---- hop -----------------------------------------------------------
        g_l = g_tab[layer]
        tau_new = torch.where(tau > 0.0, tau, -torch.log1p(-u_tau))
        s_len = tau_new * inv_mu_t[layer]
        zb = torch.where(uz > 0.0, z_bot[layer], z_top[layer])
        flat = torch.abs(uz) < 1e-12
        safe_uz = torch.where(flat, 1.0, uz)
        db = torch.where(flat, float("inf"),
                         torch.clamp((zb - z) / safe_uz, min=0.0))
        hits_b = alive & (db < s_len)
        dist = torch.minimum(s_len, db)
        x = torch.where(alive, x + ux * dist, x)
        y = torch.where(alive, y + uy * dist, y)
        z = torch.where(alive, z + uz * dist, z)
        tau = torch.where(hits_b, tau_new - db * mu_t[layer], 0.0)

        # ---- drop + spin (scatter lanes) -----------------------------------
        scat = alive & ~hits_b
        dw = torch.where(scat, w * albedo_a[layer], 0.0)
        w = w - dw
        absorbed = absorbed + dw

        frac = one_m_g2[layer] / (1.0 - g_l + 2.0 * g_l * u_hg)
        cos_t = torch.clamp(
            torch.where(torch.abs(g_l) < 1e-3, 2.0 * u_hg - 1.0,
                        (one_p_g2[layer] - frac * frac) * inv_2g[layer]),
            -1.0, 1.0)
        sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
        phi = _TWO_PI_F32 * u_phi
        # sin from cos + the half-range sign of phi (phi is uniform, so the
        # pairing is exact)
        cp = torch.cos(phi)
        sp = torch.sqrt(torch.clamp(1.0 - cp * cp, min=0.0))
        sp = torch.where(u_phi <= 0.5, sp, -sp)
        # rotate about the current direction (branchless frame)
        sgn = torch.where(uz >= 0.0, 1.0, -1.0).to(f32)
        a = -1.0 / (sgn + uz)
        bb = ux * uy * a
        t1x = 1.0 + sgn * ux * ux * a
        t1y = sgn * bb
        t1z = -sgn * ux
        t2x = bb
        t2y = sgn + uy * uy * a
        t2z = -uy
        ndx = sin_t * cp * t1x + sin_t * sp * t2x + cos_t * ux
        ndy = sin_t * cp * t1y + sin_t * sp * t2y + cos_t * uy
        ndz = sin_t * cp * t1z + sin_t * sp * t2z + cos_t * uz

        # roulette after drop
        low = scat & (w < p.wthresh)
        surv = u_rr < p.rr_surv
        w = torch.where(low & surv, w * (1.0 / p.rr_surv), w)
        w = torch.where(low & ~surv, 0.0, w)

        # ---- boundary lanes --------------------------------------------------
        going_down = uz > 0.0
        next_layer = torch.where(going_down, layer + 1, layer - 1)
        eta = torch.where(going_down, eta_dn[layer], eta_up[layer])
        cos_i = torch.abs(uz)
        sin_t2 = eta * eta * (1.0 - cos_i * cos_i)
        tir = sin_t2 >= 1.0
        cos_tr = torch.sqrt(torch.clamp(1.0 - sin_t2, min=0.0))
        rs = (eta * cos_i - cos_tr) / torch.clamp(eta * cos_i + cos_tr,
                                                  min=1e-12)
        rp = (eta * cos_tr - cos_i) / torch.clamp(eta * cos_tr + cos_i,
                                                  min=1e-12)
        refl_p = torch.where(tir, 1.0,
                             torch.clamp(0.5 * (rs * rs + rp * rp), 0.0, 1.0))
        do_refl = u_fr < refl_p
        exits = hits_b & ~do_refl & ((next_layer < 0)
                                     | (next_layer >= p.num_layers))
        exit_top = exits & ~going_down
        refr = hits_b & ~do_refl
        transmit_in = refr & ~exits

        # ---- merge direction / layer ---------------------------------------
        ux = torch.where(scat, ndx, torch.where(refr, ux * eta, ux))
        uy = torch.where(scat, ndy, torch.where(refr, uy * eta, uy))
        new_uz_b = torch.where(do_refl, -uz, torch.sign(uz) * cos_tr)
        uz = torch.where(scat, ndz, torch.where(hits_b, new_uz_b, uz))
        layer = torch.where(transmit_in, next_layer, layer)

        # ---- tallies ---------------------------------------------------------
        if not p.bench_mode:
            sel = scat & (phase == s % p.stride)
            if bool(sel.any()):
                xs, ys, zs = x[sel], y[sel], z[sel]
                ir = _bin(torch.sqrt(xs * xs + ys * ys) * p.inv_dr, p.nr)
                iz = _bin(zs * p.inv_dz, p.nz)
                rz.index_put_((ir * p.nz + iz,), dw[sel] * float(p.stride),
                              accumulate=True)
            if vol is not None:
                sel_v = scat & (phase_v == s % p.vol_stride)
                if bool(sel_v.any()):
                    vx = _bin(x[sel_v] * p.inv_vdx + 0.5 * p.vol_nx, p.vol_nx)
                    vy = _bin(y[sel_v] * p.inv_vdy + 0.5 * p.vol_ny, p.vol_ny)
                    vz = _bin(z[sel_v] * p.inv_vdz, p.vol_nz)
                    vol.index_put_(((vx * p.vol_ny + vy) * p.vol_nz + vz,),
                                   dw[sel_v] * float(p.vol_stride),
                                   accumulate=True)
            if bool(exits.any()):
                xe, ye = x[exits], y[exits]
                ir = _bin(torch.sqrt(xe * xe + ye * ye) * p.inv_dr, p.nr)
                top = exit_top[exits]
                we = w[exits].double()
                tallies.refl_r.index_put_((ir[top],), we[top],
                                          accumulate=True)
                tallies.trans_r.index_put_((ir[~top],), we[~top],
                                           accumulate=True)
                if det is not None and bool(top.any()):
                    ix = _bin((xe[top] + p.det_half) * p.det_scale, p.det_nx)
                    iy = _bin((ye[top] + p.det_half) * p.det_scale, p.det_nx)
                    det.index_put_((ix * p.det_nx + iy,), w[exits][top],
                                   accumulate=True)
            exited = exited | exits

        w = torch.where(exits, 0.0, w)  # the lane dies on exit
        # nudge off the interface
        z = torch.where(hits_b & (w > 0.0), z + torch.sign(uz) * 1e-6, z)

    for dst, src in zip(state, (x, y, z, ux, uy, uz, w, tau, layer)):
        dst.copy_(src)
    launched_t = launches.view(n_tiles, T).sum(1).double()
    return torch.stack([
        launched_t,
        launched_t * p.r_sp,
        steps.view(n_tiles, T).sum(1).double(),
        q.double() if not p.bench_mode else quota.double(),
        absorbed.view(n_tiles, T).double().sum(1),
    ], dim=1)


# --------------------------------------------------------------------------
# CUDA kernel binding
# --------------------------------------------------------------------------

class _MediumTab(ctypes.Structure):
    _fields_ = [("num_layers", ctypes.c_int)] + [
        (name, ctypes.c_float * MAX_LAYERS)
        for name in ("mu_t", "inv_mu_t", "albedo_a", "g", "one_m_g2",
                     "one_p_g2", "inv_2g", "z_top", "z_bot", "eta_dn",
                     "eta_up")
    ] + [("w0", ctypes.c_float)]


class _BlockParams(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int) for n in (
        "lanes", "tile_lanes", "k_steps", "stride", "vol_stride",
        "respawn_windows", "bench_mode", "n_phase", "sep_vol_phase",
        "nr", "nz", "det_nx", "vol_nx", "vol_ny", "vol_nz", "block_index")
    ] + [(n, ctypes.c_float) for n in (
        "inv_dr", "inv_dz", "det_half", "det_scale", "inv_vdx", "inv_vdy",
        "inv_vdz", "half_vnx", "half_vny", "wthresh", "rr_surv", "inv_rr")
    ] + [("r_sp", ctypes.c_double), ("seed", ctypes.c_uint64)]


def _structs(plan: BlockPlan, lanes: int, seed: int, block_index: int):
    med = _MediumTab()
    med.num_layers = plan.num_layers
    for name in ("mu_t", "inv_mu_t", "albedo_a", "g", "one_m_g2", "one_p_g2",
                 "inv_2g", "z_top", "z_bot", "eta_dn", "eta_up"):
        arr = getattr(med, name)
        for i, v in enumerate(getattr(plan, name)):
            arr[i] = v
    med.w0 = plan.w0
    prm = _BlockParams(
        lanes=lanes, tile_lanes=plan.tile_lanes, k_steps=plan.k_steps,
        stride=plan.stride, vol_stride=plan.vol_stride,
        respawn_windows=plan.respawn_windows,
        bench_mode=int(plan.bench_mode), n_phase=plan.n_phase,
        sep_vol_phase=int(plan.sep_vol_phase), nr=plan.nr, nz=plan.nz,
        det_nx=plan.det_nx, vol_nx=plan.vol_nx, vol_ny=plan.vol_ny,
        vol_nz=plan.vol_nz, block_index=int(block_index) & 0x7FFFFFFF,
        inv_dr=plan.inv_dr, inv_dz=plan.inv_dz, det_half=plan.det_half,
        det_scale=plan.det_scale, inv_vdx=plan.inv_vdx,
        inv_vdy=plan.inv_vdy, inv_vdz=plan.inv_vdz,
        half_vnx=0.5 * plan.vol_nx, half_vny=0.5 * plan.vol_ny,
        wthresh=plan.wthresh, rr_surv=plan.rr_surv,
        inv_rr=1.0 / plan.rr_surv, r_sp=plan.r_sp,
        seed=int(seed) & 0xFFFFFFFFFFFFFFFF)
    return med, prm


def _check(t: torch.Tensor, dtype, shape, name: str):
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected {dtype} {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _launch_kernel(plan: BlockPlan, state: KernelState, quota: torch.Tensor,
                   tallies: PhotonTallies, seed: int, block_index: int,
                   u: Optional[torch.Tensor]) -> torch.Tensor:
    global LAUNCHES
    from light_transport_tpu_torch.ops._build import load_photon_kernel

    lanes = state.w.shape[0]
    T = plan.tile_lanes
    if T % 32 or not 32 <= T <= TILE_LANES or lanes % T:
        raise ValueError(f"tile_lanes={T} must be a multiple of 32 in "
                         f"[32, {TILE_LANES}] dividing lanes={lanes}")
    n_tiles = lanes // T
    for name, t in zip(KernelState._fields, state):
        _check(t, torch.int32 if name == "layer" else torch.float32,
               (lanes,), name)
    _check(quota, torch.int32, (n_tiles,), "quota")
    if u is not None:
        _check(u, torch.float32, (plan.n_draws, lanes), "u")
    if not plan.bench_mode:
        _check(tallies.absorb_rz, torch.float32, (plan.nr, plan.nz),
               "absorb_rz")
        _check(tallies.refl_r, torch.float64, (plan.nr,), "refl_r")
        _check(tallies.trans_r, torch.float64, (plan.nr,), "trans_r")
        if plan.det_nx > 0:
            _check(tallies.detector_xy, torch.float32,
                   (plan.det_nx, plan.det_nx), "detector_xy")
        if plan.vol_nx > 0:
            _check(tallies.absorb_xyz, torch.float32,
                   (plan.vol_nx, plan.vol_ny, plan.vol_nz), "absorb_xyz")

    def ptr(t, on=True):
        return ctypes.c_void_p(t.data_ptr() if on else 0)

    quota_mode = not plan.bench_mode
    counters = torch.empty((n_tiles, 5), dtype=torch.float64,
                           device=state.w.device)
    med, prm = _structs(plan, lanes, seed, block_index)
    lib = load_photon_kernel()
    stream = torch.cuda.current_stream(state.w.device).cuda_stream
    rc = lib.photon_block_launch(
        ctypes.byref(med), ctypes.byref(prm),
        *(ptr(t) for t in state),
        ptr(quota),
        ctypes.c_void_p(u.data_ptr() if u is not None else 0),
        ptr(tallies.absorb_rz, quota_mode),
        ptr(tallies.absorb_xyz, quota_mode and plan.vol_nx > 0),
        ptr(tallies.detector_xy, quota_mode and plan.det_nx > 0),
        ptr(tallies.refl_r, quota_mode),
        ptr(tallies.trans_r, quota_mode),
        ptr(counters),
        ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"photon_block_launch failed: CUDA error {rc} "
                           f"({lib.photon_kernel_error_string(rc).decode()})")
    LAUNCHES += 1
    return counters


def kernel_residency(plan: BlockPlan, lanes: int) -> dict:
    """The card's residency for the kernel a Philox block of ``plan``
    launches: resident tiles per SM and registers per thread."""
    from light_transport_tpu_torch.ops._build import load_photon_kernel

    lib = load_photon_kernel()
    _, prm = _structs(plan, lanes, 0, 0)
    out = (ctypes.c_int * 2)()
    rc = lib.photon_block_residency(ctypes.byref(prm), out)
    if rc != 0:
        raise RuntimeError(f"photon_block_residency failed: CUDA error {rc} "
                           f"({lib.photon_kernel_error_string(rc).decode()})")
    return {"blocks_per_sm": out[0], "registers": out[1]}


def photon_block(plan: BlockPlan, state: KernelState, quota: torch.Tensor,
                 tallies: PhotonTallies, seed: int, block_index: int = 0,
                 u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Run one block: on the card through the CUDA kernel, for CPU tensors
    through :func:`photon_block_reference`.  ``state`` is updated in place;
    returns the ``(n_tiles, 5)`` float64 counters."""
    dev = state.w.device
    if dev.type == "cuda":
        return _launch_kernel(plan, state, quota, tallies, seed, block_index,
                              u)
    if dev.type != "cpu":
        raise ValueError(f"photon_block: unsupported device {dev}")
    if u is None:
        u = block_uniforms(plan, seed, state.w.shape[0], dev)
    return photon_block_reference(plan, state, quota, tallies, u)


# --------------------------------------------------------------------------
# engines
# --------------------------------------------------------------------------

class PhotonKernelEngine:
    """Block plan, state and counter fold around :func:`photon_block`."""

    def __init__(self, medium: LayeredMedium, cfg: PhotonRunConfig,
                 lanes: int, bench_mode: bool = True,
                 k_steps: int = K_STEPS, tile_lanes: int = TILE_LANES,
                 device=None):
        if lanes % tile_lanes:
            raise ValueError(f"lanes={lanes} must be a multiple of "
                             f"tile_lanes={tile_lanes}")
        self.device = (torch.device(device) if device is not None
                       else medium.device)
        self.cfg = cfg
        self.lanes = lanes
        self.tile_lanes = tile_lanes
        self.n_tiles = lanes // tile_lanes
        self.bench_mode = bench_mode
        self.stride = max(1, int(cfg.tally_stride))
        self.vol_stride = max(1, int(cfg.vol_stride or self.stride))
        # strided deposit windows tile the block exactly: round it up
        need = math.lcm(self.stride, self.vol_stride)
        if k_steps % need:
            k_steps = ((k_steps + need - 1) // need) * need
        self.k_steps = k_steps
        if cfg.respawn_windows and not bench_mode and self.stride < 2:
            raise ValueError(
                "respawn_windows requires the windowed tally mode "
                "(tally_stride >= 2)")
        self.plan = BlockPlan.build(medium, cfg, bench_mode, k_steps,
                                    self.stride, self.vol_stride, tile_lanes)

    def zero_state(self) -> KernelState:
        return KernelState.zeros(self.lanes, self.device)

    def run_block(self, state: KernelState, tallies: PhotonTallies,
                  seed: int, quota: torch.Tensor, block_index: int = 0,
                  u: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One block: respawn + ``k_steps`` supersteps, deposits into
        ``tallies``.  Returns the per-tile counters."""
        return photon_block(self.plan, state, quota, tallies, seed,
                            block_index, u)

    @staticmethod
    def accumulate(tallies: PhotonTallies, counters: torch.Tensor) -> torch.Tensor:
        """Fold a block's counters into ``tallies`` (int64 / float64);
        returns the next per-tile quota (int32)."""
        tallies.launched += counters[:, 0].sum().to(torch.int64)
        tallies.specular += counters[:, 1].sum()
        tallies.steps += counters[:, 2].sum().to(torch.int64)
        tallies.absorbed += counters[:, 4].sum()
        return counters[:, 3].to(torch.int32)


def block_seed(seed: int, block: int) -> int:
    """Seed of block ``block`` of a run: ``seed + block * 65537`` masked to
    31 bits."""
    return (int(seed) + int(block) * 65537) & 0x7FFFFFFF


def bench_kernel(medium: LayeredMedium, cfg: PhotonRunConfig, seed: int,
                 lanes: int, n_blocks: int, k_steps: int = K_STEPS,
                 tile_lanes: int = TILE_LANES, device=None) -> PhotonTallies:
    """Throughput run: ``n_blocks * k_steps`` supersteps with free respawn
    (every lane live every step); only the counters are kept."""
    eng = PhotonKernelEngine(medium, cfg, lanes, bench_mode=True,
                             k_steps=k_steps, tile_lanes=tile_lanes,
                             device=device)
    state = eng.zero_state()
    tallies = PhotonTallies.zeros(cfg, eng.device)
    quota = torch.zeros((eng.n_tiles,), dtype=torch.int32, device=eng.device)
    for b in range(n_blocks):
        counters = eng.run_block(state, tallies, block_seed(seed, b), quota, b)
        eng.accumulate(tallies, counters)
    return tallies


def _medium_table(medium: LayeredMedium) -> tuple:
    """The medium's layer table as exact Python floats."""
    return tuple((f.name, getattr(medium, f.name).detach().cpu().tolist())
                 for f in dataclasses.fields(medium))


def simulate_kernel(medium: LayeredMedium, cfg: PhotonRunConfig, seed: int,
                    lanes: int = 1 << 17,
                    max_blocks: int = 200_000,
                    k_steps: int = K_STEPS,
                    chunk_blocks: int = 4,
                    timings: dict = None,
                    tile_lanes: int = TILE_LANES,
                    uniforms=None,
                    checkpoint_path: Optional[str] = None,
                    checkpoint_every: int = 16,
                    device=None) -> PhotonTallies:
    """Unbiased run of ``cfg.n_photons`` through per-tile launch quotas.

    Blocks run in chunks of ``chunk_blocks``; the termination check (all
    quota spent and every lane dead) reads back once per chunk.  Block
    ``b`` draws from seed ``block_seed(seed, b)``.  ``uniforms``: optional
    ``fn(block, block_seed, n_draws, lanes) -> (n_draws, lanes)`` tensor
    that replaces the generator (tests use it to feed both packages the
    same numbers).  ``timings`` receives the steady-state keys of the JAX
    engine (compile_plus_first_chunk_s, steady_s, steady_steps,
    steady_steps_per_sec, steady_blocks, steady_occupancy, ms_per_block),
    counted from the end of this call's first chunk.

    ``checkpoint_path``: after every ``checkpoint_every``-th chunk that
    leaves work to do, the lane state, tallies, quota, next block index
    and seed are snapshotted there (``utils/checkpoint``), at the
    termination check's own read-back.  A run stopped after some chunks
    (killed, or bounded by ``max_blocks``) and called again with the same
    arguments resumes from its last snapshot and gives the counters and
    tallies of an unbroken run.  A snapshot of another seed, lane count,
    ``k_steps``, ``chunk_blocks``, ``tile_lanes``, config, medium or
    device type is ignored and the run starts over.  ``uniforms`` cannot
    be checkpointed (a function has no fingerprint).
    """
    if checkpoint_path is not None and uniforms is not None:
        raise ValueError("checkpoint_path with uniforms=: a uniforms "
                         "function cannot be fingerprinted")
    if checkpoint_every < 1:
        raise ValueError(f"checkpoint_every={checkpoint_every} must be >= 1")
    lanes = min(lanes, max(tile_lanes,
                           (cfg.n_photons // tile_lanes) * tile_lanes))
    eng = PhotonKernelEngine(medium, cfg, lanes, bench_mode=False,
                             k_steps=k_steps, tile_lanes=tile_lanes,
                             device=device)
    dev = eng.device
    base = cfg.n_photons // eng.n_tiles
    rem = cfg.n_photons - base * eng.n_tiles
    if base + 1 >= 2 ** 31:
        raise ValueError("per-tile quota must fit in int32")
    quota_h = np.full((eng.n_tiles,), base, np.int32)
    quota_h[:rem] += 1  # exact integer split of the launch budget
    quota = torch.as_tensor(quota_h, device=dev)
    state = eng.zero_state()
    tallies = PhotonTallies.zeros(cfg, dev)
    start = 0
    if checkpoint_path is not None:
        from light_transport_tpu_torch.utils import checkpoint as ckpt

        # everything the resumed streams, shapes and physics depend on
        fingerprint = (f"kernel-v1|dev={dev.type}|seed={seed}|lanes={lanes}"
                       f"|k={eng.k_steps}|cb={chunk_blocks}|tile={tile_lanes}"
                       f"|cfg={cfg}|medium={_medium_table(medium)}")
        loaded = ckpt.load_kernel_checkpoint(checkpoint_path, fingerprint,
                                             dev)
        if loaded is not None:
            state, tallies, quota, start = loaded

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    t1 = s1 = None
    c1 = blocks = start
    chunks = 0
    for c in range(start, max_blocks, chunk_blocks):
        for b in range(c, min(c + chunk_blocks, max_blocks)):
            bs = block_seed(seed, b)
            u = (None if uniforms is None
                 else uniforms(b, bs, eng.plan.n_draws, lanes))
            counters = eng.run_block(state, tallies, bs, quota, b, u)
            quota = eng.accumulate(tallies, counters)
            blocks = b + 1
        more = bool((quota > 0).any() | (state.w > 0.0).any())  # syncs
        chunks += 1
        if t1 is None:
            sync()
            t1 = time.perf_counter()
            s1 = tallies.n_steps
            c1 = blocks
        if not more:
            break
        if checkpoint_path is not None and chunks % checkpoint_every == 0:
            ckpt.save_kernel_checkpoint(checkpoint_path, state, tallies,
                                        quota, blocks, seed, fingerprint)
    if timings is not None and t1 is not None:
        sync()
        t_end = time.perf_counter()
        s_end = tallies.n_steps
        steady_blocks = blocks - c1
        timings["compile_plus_first_chunk_s"] = t1 - t0
        timings["steady_s"] = t_end - t1
        timings["steady_steps"] = s_end - s1
        timings["steady_steps_per_sec"] = (s_end - s1) / max(t_end - t1, 1e-9)
        timings["steady_blocks"] = steady_blocks
        timings["steady_occupancy"] = (
            (s_end - s1) / max(steady_blocks * lanes * eng.k_steps, 1))
        timings["ms_per_block"] = (t_end - t1) / max(steady_blocks, 1) * 1e3
    return tallies

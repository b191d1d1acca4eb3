"""The photon slice end to end: the port's quota engine (``simulate_kernel``,
plain path on the CPU) against the JAX package's ``simulate_pallas``
(interpret mode), fed the same per-block uniforms.

JAX draws block ``b``'s uniforms from ``fold_in(key(0), seed_b)`` with
``seed_b = (seed + b * 65537) & 0x7FFFFFFF`` at ``chunk_blocks=1``; the
port's ``uniforms`` hook rebuilds exactly those.  The medium is the
short-lived MCML slab, so one 8192-lane wave launches every photon in
block 0 and the run ends when the longest life does.
"""

import dataclasses
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from light_transport_tpu.core.config import MediumConfig as JMediumConfig
from light_transport_tpu.core.config import PhotonRunConfig as JRunConfig
from light_transport_tpu.ops.pallas.photon_kernel import (
    LANES, ROWS, simulate_pallas,
)
from light_transport_tpu.scene.medium import LayeredMedium as JMedium
from light_transport_tpu_torch.core.config import MediumConfig, PhotonRunConfig
from light_transport_tpu_torch.ops.photon_kernel import simulate_kernel
from light_transport_tpu_torch.scene.medium import LayeredMedium
from light_transport_tpu_torch.utils import interop

torch.set_num_threads(1)

TILE = ROWS * LANES
SEED = 21
N_PHOTONS = 8000


# XLA's lowest backend level and its classic CPU emitters: together they
# compile the interpret-mode kernel in a third of the default time
CHEAP_COMPILE = {"xla_backend_optimization_level": 0,
                 "xla_cpu_use_fusion_emitters": False}


def cheap_xla_compiles():
    """``simulate_pallas`` builds its jits inside, so the compile options
    reach them through ``jax.jit``."""
    return mock.patch.object(
        jax, "jit", functools.partial(jax.jit, compiler_options=CHEAP_COMPILE))


@functools.partial(jax.jit, static_argnums=(1, 2),
                   compiler_options=CHEAP_COMPILE)
def _jax_uniforms(seed, n_draws, lanes):
    key = jax.random.fold_in(jax.random.key(0), seed)
    return jax.random.uniform(key, (n_draws, lanes // LANES, LANES),
                              jnp.float32)


def jax_uniforms(block, seed, n_draws, lanes):
    u = _jax_uniforms(jnp.asarray(seed, jnp.int32), n_draws, lanes)
    return torch.from_numpy(np.asarray(u).reshape(n_draws, lanes).copy())


@pytest.fixture(scope="module")
def slab_runs():
    with cheap_xla_compiles():
        return _slab_runs()


def _slab_runs():
    jm = JMedium.build([JMediumConfig(mu_a=10.0, mu_s=90.0, g=0.75, n=1.0,
                                      thickness=0.02)])
    jcfg = JRunConfig(n_photons=N_PHOTONS, nr=16, nz=16, dr=0.01,
                      dz=0.002, detector_nx=8, detector_extent=0.2)
    jt = simulate_pallas(jm, jcfg, seed=SEED, lanes=TILE, k_steps=16,
                         chunk_blocks=1)
    m = interop.medium_from_numpy(
        {k: np.asarray(getattr(jm, k)) for k in interop.MEDIUM_FIELDS},
        device="cpu")
    cfg = PhotonRunConfig(**dataclasses.asdict(jcfg))
    timings = {}
    t = simulate_kernel(m, cfg, seed=SEED, lanes=TILE, k_steps=16,
                        chunk_blocks=1, tile_lanes=TILE,
                        uniforms=jax_uniforms, timings=timings)
    return t, jt, timings


def test_slice_launch_counts_exact(slab_runs):
    t, jt, timings = slab_runs
    assert t.n_launched == jt.n_launched == N_PHOTONS
    assert timings["steady_blocks"] >= 1


def test_slice_tallies_match_jax(slab_runs):
    t, jt, _ = slab_runs
    for k in ("refl_r", "trans_r", "absorb_rz", "detector_xy"):
        a = getattr(t, k).double().numpy()
        b = np.asarray(getattr(jt, k), np.float64)
        assert b.max() > 0, k
        assert np.abs(a - b).max() <= 2e-4 * b.max(), k
    for v in ("total_reflectance", "total_transmittance",
              "total_absorption", "specular_reflectance"):
        assert getattr(t, v)() == pytest.approx(getattr(jt, v)(), rel=1e-4), v
    # a diverged lane changes at most its own steps
    assert abs(t.n_steps - jt.n_steps) <= 1e-3 * jt.n_steps


def test_full_scale_shaped_run_closes_energy():
    """full_scale's tally shape (windowed strides, separate volume phase,
    per-window respawn, detector) at a CPU size: launch count exact and
    energy closed."""
    m = LayeredMedium.build([MediumConfig(mu_a=2.0, mu_s=48.0, g=0.9,
                                          n=1.37)], device="cpu")
    cfg = PhotonRunConfig(n_photons=600, nr=16, nz=16, dr=0.05, dz=0.05,
                          detector_nx=16, detector_extent=1.28,
                          vol_nx=8, vol_ny=8, vol_nz=8, vol_dx=0.2,
                          vol_dy=0.2, vol_dz=0.2, tally_stride=8,
                          vol_stride=16, respawn_windows=1)
    t = simulate_kernel(m, cfg, seed=4, lanes=256, k_steps=64,
                        chunk_blocks=2, tile_lanes=256)
    assert t.n_launched == cfg.n_photons
    assert abs(t.energy_total() - 1.0) < 5e-3, t.energy_total()
    vol = float(t.absorb_xyz.double().sum())
    assert abs(vol / float(t.absorbed) - 1.0) < 0.1
    assert float(t.detector_xy.double().sum()) > 0

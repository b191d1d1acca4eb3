"""The port's superstep engine against the JAX package's, and the MCML
golden values through the port's ``api.simulate`` on the CPU.

``superstep`` takes its (N, 5) uniforms as an argument on both sides, so
both are fed the same numpy uniforms.  Tolerances: XLA on the CPU
contracts a*b+c into FMAs and its log1p/cos/sqrt differ from torch's by
an ulp or two, which moves a rare lane past a branch; so state is compared
at ``rtol=1e-5, atol=1e-6`` on >= 99.9 % of lanes, grids within
``1e-5 * max``, and the quota and counters exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from light_transport_tpu.core.config import MediumConfig as JMediumConfig
from light_transport_tpu.core.config import PhotonRunConfig as JRunConfig
from light_transport_tpu.scene.medium import LayeredMedium as JMedium
from light_transport_tpu.tally.tallies import PhotonTallies as JTallies
from light_transport_tpu.tally.tallies import counter_value
from light_transport_tpu.transport import photon as jphoton
from light_transport_tpu_torch.api import simulate
from light_transport_tpu_torch.core.config import MediumConfig, PhotonRunConfig
from light_transport_tpu_torch.scene.medium import LayeredMedium
from light_transport_tpu_torch.tally.stats import (
    binomial_stderr,
    mc_parity_3sigma,
)
from light_transport_tpu_torch.tally.tallies import PhotonTallies
from light_transport_tpu_torch.transport import photon
from light_transport_tpu_torch.utils import interop

torch.set_num_threads(1)

N_LANES = 4096
N_STEPS = 8
QUOTA = 5000  # runs out mid-chain, so the respawn ranks matter


# XLA's lowest backend level: a quick compile, and no fused roundings that
# torch does not make (at XLA's default level the jitted step moves ~0.5 %
# of lanes past rtol 1e-5 within 8 steps)
CHEAP_COMPILE = {"xla_backend_optimization_level": 0,
                 "xla_llvm_disable_expensive_passes": True}


def run_chain():
    """8 chained supersteps on both sides from the same uniforms."""
    layers = [
        JMediumConfig(mu_a=3.0, mu_s=17.0, g=0.8, n=1.4, thickness=0.05),
        JMediumConfig(mu_a=1.0, mu_s=9.0, g=0.0, n=1.0, thickness=0.05),
        JMediumConfig(mu_a=2.0, mu_s=18.0, g=0.7, n=1.37, thickness=0.1),
    ]
    jm = JMedium.build(layers, n_above=1.0, n_below=1.2)
    jcfg = JRunConfig(nr=16, nz=16, dr=0.01, dz=0.01, detector_nx=8,
                      detector_extent=0.1, vol_nx=4, vol_ny=4, vol_nz=4,
                      vol_dx=0.05, vol_dy=0.05, vol_dz=0.05)
    cfg = PhotonRunConfig(**dataclasses.asdict(jcfg))
    m = interop.medium_from_numpy(
        {k: np.asarray(getattr(jm, k)) for k in interop.MEDIUM_FIELDS},
        device="cpu")
    step = jax.jit(jphoton.superstep, static_argnums=4,
                   compiler_options=CHEAP_COMPILE)
    rng = np.random.default_rng(7)
    js, jt = jphoton.PhotonState.dead(N_LANES), JTallies.zeros(jcfg)
    jq = jnp.asarray(QUOTA, jnp.int32)
    s = interop.photon_state_from_numpy(
        **{k: np.asarray(v) for k, v in js._asdict().items()}, device="cpu")
    t = PhotonTallies.zeros(cfg, device="cpu")
    q = torch.tensor(QUOTA, dtype=torch.int64)
    for _ in range(N_STEPS):
        u = rng.random((N_LANES, 5), dtype=np.float32)
        js, jt, jq = step(js, jt, jnp.asarray(u), jm, jcfg, jq)
        s, t, q = photon.superstep(s, t, torch.from_numpy(u), m, cfg, q)
    return s, t, int(q), js, jt, int(jq)


@pytest.fixture(scope="module")
def chained():
    return run_chain()


def test_superstep_state_matches_jax(chained):
    s, _, _, js, _, _ = chained
    ours = interop.photon_state_to_numpy(s)
    ok = np.ones(N_LANES, bool)
    for k in ("pos", "dir", "w", "tau"):
        close = np.isclose(ours[k], np.asarray(getattr(js, k)), rtol=1e-5,
                           atol=1e-6)
        ok &= close.all(axis=1) if close.ndim == 2 else close
    ok &= ours["layer"] == np.asarray(js.layer)
    ok &= ours["alive"] == np.asarray(js.alive)
    assert (~ok).sum() <= 1e-3 * N_LANES, int((~ok).sum())
    assert 0 < s.alive.sum() < N_LANES  # the chain exercised deaths


def test_superstep_tallies_and_quota_match_jax(chained):
    _, t, q, _, jt, jq = chained
    assert q == jq == 0
    assert t.n_launched == counter_value(jt.launched) == QUOTA
    assert t.n_steps == counter_value(jt.steps)
    for k in ("refl_r", "trans_r", "absorb_rz", "detector_xy", "absorb_xyz"):
        a = getattr(t, k).double().numpy()
        b = np.asarray(getattr(jt, k), np.float64)
        assert b.max() > 0, k
        assert np.abs(a - b).max() <= 1e-5 * b.max(), k
    for k in ("specular", "absorbed"):
        np.testing.assert_allclose(float(getattr(t, k)),
                                   float(getattr(jt, k)), rtol=1e-5)


N_PHOTONS = 10_000


def run(layers, seed=0, **kw):
    m = LayeredMedium.build(layers, **kw, device="cpu")
    cfg = PhotonRunConfig(n_photons=N_PHOTONS, nr=50, nz=50, dr=0.002,
                          dz=0.002)
    return simulate(m, cfg, seed=seed)


def test_van_de_hulst_isotropic_semi_infinite():
    # albedo 0.9, g=0, matched boundaries: R_d = 0.41550 (van de Hulst)
    res = run([MediumConfig(mu_a=1.0, mu_s=9.0, g=0.0, n=1.0)])
    se = binomial_stderr(0.41550, N_PHOTONS)
    assert mc_parity_3sigma(res.total_reflectance(), 0.41550, se,
                            abs_floor=1e-3), res.total_reflectance()
    assert res.n_launched == N_PHOTONS


def test_giovanelli_specular_and_reflectance():
    # mu_a=10, mu_s=90, g=0, n_rel=1.5: specular 0.04 at launch, total
    # reflectance 0.2600 (Giovanelli 1955)
    res = run([MediumConfig(mu_a=10.0, mu_s=90.0, g=0.0, n=1.5)],
              n_above=1.0)
    np.testing.assert_allclose(res.specular_reflectance(), 0.04, atol=1e-6)
    r_total = res.specular_reflectance() + res.total_reflectance()
    se = binomial_stderr(0.26, N_PHOTONS)
    assert mc_parity_3sigma(r_total, 0.2600, se, abs_floor=2e-3), r_total
    assert res.n_launched == N_PHOTONS


def test_energy_conservation_and_exact_launches():
    res = run(
        [MediumConfig(mu_a=1.0, mu_s=10.0, g=0.7, n=1.4, thickness=0.05),
         MediumConfig(mu_a=2.0, mu_s=20.0, g=0.5, n=1.3, thickness=0.05)],
        n_above=1.0, n_below=1.0)
    assert abs(res.energy_total() - 1.0) < 5e-3, res.energy_total()
    assert res.n_launched == N_PHOTONS


def test_drain_compaction_keeps_launches_and_energy():
    m = LayeredMedium.build([MediumConfig(mu_a=1.0, mu_s=9.0, g=0.0)],
                            device="cpu")
    cfg = PhotonRunConfig(n_photons=4000, nr=8, nz=8, dr=0.05, dz=0.05)
    t = photon.simulate_photons(m, cfg, seed=3, lanes=1024,
                                compact_drain=True, min_lanes=64)
    assert t.n_launched == 4000
    assert abs(t.energy_total() - 1.0) < 5e-3


def test_run_fixed_steps_counts():
    m = LayeredMedium.build([MediumConfig(mu_a=1.0, mu_s=9.0, g=0.5)],
                            device="cpu")
    _, t = photon.run_fixed_steps(m, PhotonRunConfig(nr=16, nz=16), seed=0,
                                  lanes=512, n_steps=32)
    assert t.n_steps == 512 * 32  # every lane live every step
    assert t.n_launched > 0

"""The port's photon block (plain PyTorch version) against the JAX
package's fused Pallas kernel, run in interpret mode on the CPU with
pre-drawn uniforms (``hw_prng=False``).

Both sides take the same uniforms: JAX's threefry draws for the block,
rebuilt here exactly as ``PallasPhotonEngine.run_block`` makes them and
handed to the port as numpy.  One 8192-lane tile (the port's
``tile_lanes`` equals JAX's tile, so the respawn ranks agree), k_steps
16, two blocks; block 2 starts from JAX's block-1 state and quota.

Tolerances: float32 transcendentals differ by an ulp between XLA and
torch, which can flip a rare branch, so lanes are compared with
``rtol=1e-4, atol=1e-6`` on >= 99.9 % of lanes; grids within 2e-4 * max
(the bf16 hi/lo error of JAX's one-hot flush, as tests/test_photon.py
bounds it); counters exact, or within what the diverged lanes explain.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from light_transport_tpu.core.config import MediumConfig as JMediumConfig
from light_transport_tpu.core.config import PhotonRunConfig as JRunConfig
from light_transport_tpu.ops.pallas.photon_kernel import (
    LANES, ROWS, PallasPhotonEngine, _n_draws,
)
from light_transport_tpu.scene.medium import LayeredMedium as JMedium
from light_transport_tpu.tally.tallies import PhotonTallies as JTallies
from light_transport_tpu.tally.tallies import counter_value
from light_transport_tpu_torch.core.config import PhotonRunConfig
from light_transport_tpu_torch.ops import photon_kernel as pk
from light_transport_tpu_torch.tally.tallies import PhotonTallies
from light_transport_tpu_torch.utils import interop

torch.set_num_threads(1)

K = 16
TILE = ROWS * LANES
# a semi-infinite mismatched medium (Fresnel and TIR at the surface);
# short-lived (albedo 0.3), so roulette deaths inside the first stride
# window give the per-window respawn lanes to rank.  One layer keeps the
# interpret-mode compile short; layer crossings and bottom exits are held
# against JAX by test_torch_photon.py and test_torch_slice.py.
LAYERS = [JMediumConfig(mu_a=7.0, mu_s=3.0, g=0.9, n=1.37)]
_GRIDS = dict(nr=16, nz=16, dr=0.03, dz=0.03, detector_nx=8,
              detector_extent=0.3, vol_nx=4, vol_ny=4, vol_nz=4,
              vol_dx=0.08, vol_dy=0.08, vol_dz=0.08)
CONFIGS = {
    "bench": (True, dict(nr=16, nz=16)),
    "flat": (False, dict(n_photons=12_000, **_GRIDS)),
    "windowed": (False, dict(n_photons=20_000, tally_stride=8, vol_stride=16,
                             respawn_windows=1, **_GRIDS)),
}


# XLA's lowest backend level and its classic CPU emitters: together they
# compile the interpret-mode kernel in a third of the default time, and
# make fewer fused roundings that torch does not make
CHEAP_COMPILE = {"xla_backend_optimization_level": 0,
                 "xla_cpu_use_fusion_emitters": False}


def jax_uniforms(seed, n_draws):
    """A block's uniforms, drawn as ``PallasPhotonEngine.run_block`` draws
    them with ``hw_prng=False``."""
    key = jax.random.fold_in(jax.random.key(0), jnp.asarray(seed, jnp.int32))
    return jax.random.uniform(key, (n_draws, ROWS, LANES), jnp.float32)


def jax_medium():
    return JMedium.build(LAYERS, n_above=1.0)


def port_medium(jm):
    return interop.medium_from_numpy(
        {k: np.asarray(getattr(jm, k)) for k in interop.MEDIUM_FIELDS})


def run_pair(name):
    """Run JAX and the port on both blocks of one configuration."""
    bench, kw = CONFIGS[name]
    jcfg = JRunConfig(**kw)
    cfg = PhotonRunConfig(**dataclasses.asdict(jcfg))
    jm = jax_medium()
    jeng = PallasPhotonEngine(jm, jcfg, TILE, bench_mode=bench, k_steps=K,
                              hw_prng=False)
    eng = pk.PhotonKernelEngine(port_medium(jm), cfg, TILE, bench_mode=bench,
                                k_steps=K, tile_lanes=TILE)
    assert eng.k_steps == jeng.k_steps
    assert eng.plan.n_draws == _n_draws(K, bench, jeng.sep_vol_phase)
    jstate = jeng.zero_state()
    jquota = jnp.full(
        (1, 1), jnp.inf if bench else float(jcfg.n_photons), jnp.float32)

    @functools.partial(jax.jit, compiler_options=CHEAP_COMPILE)
    def jax_block(jstate, seed, jquota):
        # one compile for the block, its tallies and its uniforms
        jstate, outs, jcounters = jeng.run_block(jstate, seed, jquota)
        jt = jeng.accumulate(JTallies.zeros(jcfg), outs, jcounters)
        return jstate, jt, jcounters, jax_uniforms(seed, eng.plan.n_draws)

    out = []
    for b in range(2):
        seed = 1234 + b * 65537
        state = interop.kernel_state_from_numpy([np.asarray(a) for a in jstate])
        quota = torch.tensor([0 if bench else int(np.asarray(jquota)[0, 0])],
                             dtype=torch.int32)
        jstate, jt, jcounters, u = jax_block(jstate, jnp.int32(seed), jquota)
        jquota = jcounters[:, 3:4]
        tallies = PhotonTallies.zeros(cfg)
        u = torch.from_numpy(np.asarray(u).reshape(-1, TILE).copy())
        counters = eng.run_block(state, tallies, seed, quota, b, u)
        eng.accumulate(tallies, counters)
        out.append(dict(name=name, bench=bench, state=state, tallies=tallies,
                        counters=counters.numpy(),
                        jstate=[np.asarray(a).reshape(-1) for a in jstate],
                        jt=jt, jcounters=np.asarray(jcounters, np.float64)))
    return out


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def blocks(request):
    return run_pair(request.param)


def _diverged(blk):
    ok = np.ones(TILE, bool)
    rows = interop.kernel_state_to_numpy(blk["state"])
    for a, b in zip(rows, blk["jstate"]):
        ok &= np.isclose(a.reshape(-1), b, rtol=1e-4, atol=1e-6)
    return int((~ok).sum())


def test_block_state_matches_jax(blocks):
    for blk in blocks:
        n_div = _diverged(blk)
        assert n_div <= 1e-3 * TILE, (blk["name"], n_div)


def test_block_counters_match_jax(blocks):
    for blk in blocks:
        c, j = blk["counters"][0], blk["jcounters"][0]
        n_div = _diverged(blk)
        assert c[0] == j[0], (blk["name"], "launched", c[0], j[0])
        # a diverged lane changes at most its own live steps in the block
        assert abs(c[2] - j[2]) <= n_div * K, (blk["name"], c[2], j[2])
        np.testing.assert_allclose(c[1], j[1], rtol=1e-6)
        if not blk["bench"]:
            assert c[3] == j[3], (blk["name"], "quota", c[3], j[3])
            np.testing.assert_allclose(c[4], j[4], rtol=1e-4)
    if blocks[0]["name"] == "windowed":
        # block 1 starts all-dead: launches beyond one tile come from the
        # per-window respawn
        assert blocks[0]["counters"][0][0] > TILE


def test_block_tallies_match_jax(blocks):
    for blk in blocks:
        if blk["bench"]:
            continue
        t, jt = blk["tallies"], blk["jt"]
        for name in ("absorb_rz", "detector_xy", "absorb_xyz", "refl_r"):
            a = getattr(t, name).double().numpy()
            b = np.asarray(getattr(jt, name), np.float64)
            assert b.max() > 0, (blk["name"], name)
            assert np.abs(a - b).max() <= 2e-4 * b.max(), (blk["name"], name)
        assert float(t.trans_r.abs().max()) == 0.0  # semi-infinite
        assert t.n_launched == counter_value(jt.launched)
        assert t.n_steps == counter_value(jt.steps)


def test_photon_block_rejects_bad_tiles():
    jm = jax_medium()
    cfg = PhotonRunConfig(nr=8, nz=8)
    with pytest.raises(ValueError, match="tile_lanes"):
        pk.PhotonKernelEngine(port_medium(jm), cfg, 1000, tile_lanes=256)
    with pytest.raises(ValueError, match="respawn_windows"):
        pk.PhotonKernelEngine(port_medium(jm),
                              PhotonRunConfig(respawn_windows=1), 256,
                              bench_mode=False)

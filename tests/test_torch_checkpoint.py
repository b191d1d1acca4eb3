"""The port's checkpoints (``utils/checkpoint``, ``simulate_kernel``'s
``checkpoint_path``) and ``models/presets.hg_sweep``, held as
``tests/test_utils.py`` holds the JAX package's.

Plain torch on the CPU: the superstep engine and the kernel engine's plain
block (``photon_block_reference``, each block drawing from
``block_uniforms`` of its block seed).  The only JAX use is a file written
by JAX's ``save_tallies`` and JAX's ``hg_sweep``; neither compiles
anything.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from light_transport_tpu.models.presets import hg_sweep as jax_hg_sweep
from light_transport_tpu.tally.tallies import PhotonTallies as JTallies
from light_transport_tpu.utils.checkpoint import (
    save_tallies as jax_save_tallies,
)
from light_transport_tpu_torch.core.config import MediumConfig, PhotonRunConfig
from light_transport_tpu_torch.models.presets import hg_sweep
from light_transport_tpu_torch.ops import photon_kernel as pk
from light_transport_tpu_torch.scene.medium import LayeredMedium
from light_transport_tpu_torch.tally.tallies import PhotonTallies
from light_transport_tpu_torch.transport import photon
from light_transport_tpu_torch.utils import checkpoint as ckpt
from light_transport_tpu_torch.utils import interop

CPU = "cpu"
# the kernel engine's run: a mismatched boundary, every tally, windowed
# deposits with respawn at every window
KCFG = PhotonRunConfig(n_photons=8_000, nr=16, nz=16, dr=0.03, dz=0.03,
                       detector_nx=8, detector_extent=0.5,
                       vol_nx=4, vol_ny=4, vol_nz=4,
                       vol_dx=0.1, vol_dy=0.1, vol_dz=0.1,
                       tally_stride=4, vol_stride=8, respawn_windows=1)
KW = dict(lanes=1024, k_steps=16, chunk_blocks=2, device=CPU)


def medium(mu_s=8.0):
    return LayeredMedium.build(
        [MediumConfig(mu_a=2.0, mu_s=mu_s, g=0.5, n=1.37)], device=CPU)


def random_tallies(seed=0, nr=8, nz=8):
    rng = np.random.default_rng(seed)
    t = PhotonTallies.zeros(PhotonRunConfig(nr=nr, nz=nz), CPU)
    for f in dataclasses.fields(t):
        v = getattr(t, f.name)
        if v.dtype == torch.int64:
            v.fill_(int(rng.integers(2 ** 40)))
        else:
            v.copy_(torch.from_numpy(rng.random(tuple(v.shape))))
    return t


def assert_tallies_equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert x.dtype == y.dtype, f.name
        assert torch.equal(x, y), f.name


def test_save_load_roundtrip_suffixless(tmp_path):
    t = random_tallies()
    p = str(tmp_path / "ckpt")  # no extension
    ckpt.save_tallies(p, t, seed=5, batches_done=3)
    assert os.path.exists(p + ".npz")
    assert not os.path.exists(p + ".npz.tmp")
    for path in (p, p + ".npz"):
        loaded, seed, batches = ckpt.load_tallies(path, device=CPU)
        assert (seed, batches) == (5, 3)
        assert_tallies_equal(loaded, t)


def test_resumable_killed_and_resumed_matches_unbroken(tmp_path,
                                                       monkeypatch):
    # short rounds: the drain checks for live lanes every 64 steps
    cfg = PhotonRunConfig(n_photons=1_203, nr=8, nz=8, steps_per_batch=4)
    m = medium()
    full = ckpt.simulate_resumable(m, cfg, seed=7,
                                   checkpoint_path=str(tmp_path / "a"),
                                   n_batches=4, lanes=256)
    assert full.n_launched == cfg.n_photons

    class Killed(Exception):
        pass

    save = ckpt.save_tallies

    def save_then_die(path, tallies, seed, batches_done):
        save(path, tallies, seed, batches_done)
        if batches_done == 2:
            raise Killed

    monkeypatch.setattr(ckpt, "save_tallies", save_then_die)
    with pytest.raises(Killed):
        ckpt.simulate_resumable(m, cfg, seed=7,
                                checkpoint_path=str(tmp_path / "b"),
                                n_batches=4, lanes=256)
    monkeypatch.setattr(ckpt, "save_tallies", save)
    ran = []
    run = photon.simulate_photons

    def spy(medium, cfg, seed, **kw):
        ran.append(seed)
        return run(medium, cfg, seed, **kw)

    monkeypatch.setattr(photon, "simulate_photons", spy)
    resumed = ckpt.simulate_resumable(m, cfg, seed=7,
                                      checkpoint_path=str(tmp_path / "b"),
                                      n_batches=4, lanes=256)
    assert ran == [ckpt.batch_seed(7, 2), ckpt.batch_seed(7, 3)]
    assert_tallies_equal(resumed, full)
    # a snapshot of another seed is ignored: the run starts over
    ran.clear()
    ckpt.simulate_resumable(m, dataclasses.replace(cfg, n_photons=8), seed=8,
                            checkpoint_path=str(tmp_path / "b"),
                            n_batches=4, lanes=256)
    assert ran == [ckpt.batch_seed(8, b) for b in range(4)]


def test_accumulate_counters_exact_past_2_24():
    cfg = PhotonRunConfig(n_photons=0, nr=4, nz=4)
    one = PhotonTallies.zeros(cfg, CPU)
    one.launched += 60_000
    one.steps += 2 ** 31 - 1
    one.absorb_rz += 0.25
    total = PhotonTallies.zeros(cfg, CPU)
    for _ in range(400):
        total = ckpt.accumulate(total, one)
    assert total.n_launched == 400 * 60_000 > 2 ** 24
    assert total.n_steps == 400 * (2 ** 31 - 1)
    assert torch.equal(total.absorb_rz, torch.full((4, 4), 100.0))


def test_kernel_killed_and_resumed_matches_unbroken(tmp_path):
    m = medium()
    t_ref = {}
    ref = pk.simulate_kernel(m, KCFG, seed=5, timings=t_ref, **KW)
    assert ref.n_launched == KCFG.n_photons
    path = str(tmp_path / "kernel_run")
    partial = pk.simulate_kernel(m, KCFG, seed=5, max_blocks=6,
                                 checkpoint_path=path, checkpoint_every=1,
                                 **KW)
    assert partial.n_launched < KCFG.n_photons  # stopped early
    t_res = {}
    resumed = pk.simulate_kernel(m, KCFG, seed=5, checkpoint_path=path,
                                 checkpoint_every=1, timings=t_res, **KW)
    assert_tallies_equal(resumed, ref)
    # timings count from the end of this call's first chunk
    cb = KW["chunk_blocks"]
    assert 6 + cb + t_res["steady_blocks"] == cb + t_ref["steady_blocks"]
    assert t_res["steady_steps"] < resumed.n_steps - partial.n_steps


def test_kernel_snapshot_of_other_run_refused(tmp_path):
    """A snapshot of another seed, config or medium is not resumed: the
    run starts over and gives what a run without a snapshot gives."""
    m = medium()
    path = str(tmp_path / "other")
    kw1 = dict(KW, chunk_blocks=1)
    for what, kw in (
            ("seed", dict(seed=6)),
            ("config", dict(cfg=dataclasses.replace(KCFG, rr_survive=0.2))),
            ("medium", dict(medium=medium(mu_s=9.0)))):
        pk.simulate_kernel(m, KCFG, seed=5, max_blocks=2,
                           checkpoint_path=path, checkpoint_every=1, **kw1)
        args = dict(dict(medium=m, cfg=KCFG, seed=5, max_blocks=2), **kw)
        got = pk.simulate_kernel(**args, checkpoint_path=path,
                                 checkpoint_every=1, **kw1)
        fresh = pk.simulate_kernel(**args, **kw1)
        assert got.n_launched > 0, what
        assert_tallies_equal(got, fresh)


def test_kernel_checkpoint_with_uniforms_raises(tmp_path):
    with pytest.raises(ValueError, match="uniforms"):
        pk.simulate_kernel(medium(), KCFG, seed=5,
                           checkpoint_path=str(tmp_path / "x"),
                           uniforms=lambda b, s, n, lanes: None, **KW)


def test_load_tallies_of_jax_file(tmp_path):
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    arrays = {
        "refl_r": rng.random(8, dtype=np.float32),
        "trans_r": rng.random(8, dtype=np.float32),
        "absorb_rz": rng.random((8, 8), dtype=np.float32),
        "specular": np.float32(rng.random()),
        "launched": np.asarray([7.0, 1234.0], np.float32),
        "steps": np.asarray([65_535.0, 65_535.0], np.float32),
        "detector_xy": rng.random((4, 4), dtype=np.float32),
        "absorb_xyz": rng.random((2, 3, 4), dtype=np.float32),
        "absorbed": np.float32(rng.random()),
    }
    path = str(tmp_path / "jax_run")
    jax_save_tallies(path, JTallies(**{k: jnp.asarray(v)
                                       for k, v in arrays.items()}),
                     seed=11, batches_done=4)
    loaded, seed, batches = ckpt.load_tallies(path, device=CPU)
    assert (seed, batches) == (11, 4)
    assert loaded.n_launched == 7 * 65_536 + 1234
    assert_tallies_equal(loaded, interop.tallies_from_numpy(arrays, CPU))


def test_hg_sweep_matches_jax():
    got = list(hg_sweep(device=CPU))
    want = list(jax_hg_sweep())
    assert len(got) == len(want) == 18
    for (label, m, cfg), (j_label, j_m, j_cfg) in zip(got, want):
        assert label == j_label
        assert dataclasses.asdict(cfg) == dataclasses.asdict(j_cfg)
        j = {k: np.asarray(getattr(j_m, k)) for k in interop.MEDIUM_FIELDS}
        for k, v in interop.medium_to_numpy(m).items():
            assert v.dtype == j[k].dtype and np.array_equal(v, j[k]), (
                label, k)

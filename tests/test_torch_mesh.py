"""The port's sharded runs (``parallel.mesh``) on the CPU: the mesh and
its split, the superstep engine and the photon kernel's plain version over
8 shards against JAX's ``simulate_sharded`` on the conftest's 8-device CPU
mesh and against each other, one shard of the kernel engine bitwise
``simulate_kernel``, the sharded render against ``render_image``, and a
two-process gloo group.

Tolerances are ``tests/test_sharding.py``'s: exact launch counts, energy
within 1e-2 (5e-3 for the kernel engine), R_d and absorption within 3
sigma (+1e-3), absorption chi2/dof < 1.5.  The sharded render is bitwise
``render_image`` at 2 and 8 shards on the CPU (JAX's own test allows
2e-5).
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from light_transport_tpu.core import config as jconfig
from light_transport_tpu.parallel import mesh as jmesh
from light_transport_tpu.scene.medium import LayeredMedium as JMedium
from light_transport_tpu_torch.core.config import (
    MediumConfig,
    MeshTopology,
    PhotonRunConfig,
)
from light_transport_tpu_torch.integrators import bdpt
from light_transport_tpu_torch.integrators import path_tracer as pt
from light_transport_tpu_torch.models import presets
from light_transport_tpu_torch.ops import photon_kernel as pk
from light_transport_tpu_torch.parallel import mesh as pm
from light_transport_tpu_torch.scene.medium import LayeredMedium
from light_transport_tpu_torch.tally.stats import (
    binomial_stderr,
    chi2_counts,
    mc_parity_3sigma,
)
from light_transport_tpu_torch.transport import photon

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAYER = dict(mu_a=1.0, mu_s=9.0, g=0.7, n=1.37)
N = 40_000
CFG = dict(n_photons=N, nr=16, nz=16, dr=0.05, dz=0.05)


def cpu_mesh(n):
    return pm.make_mesh(n, device_type="cpu")


def medium(**layer):
    return LayeredMedium.build([MediumConfig(**layer)], device="cpu")


@pytest.fixture(scope="module")
def runs():
    """40,000 photons over 8 shards: the port's superstep engine and JAX's
    ``simulate_sharded`` (4096 lanes a shard each), and the port's kernel
    engine at k=8."""
    jm = JMedium.build([jconfig.MediumConfig(**LAYER)])
    jt = jmesh.simulate_sharded(jm, jconfig.PhotonRunConfig(**CFG),
                                jax.random.key(9), mesh=jmesh.make_mesh(8),
                                lanes_per_device=4096)
    cfg = PhotonRunConfig(**CFG)
    tx = pm.simulate_sharded(medium(**LAYER), cfg, seed=9, mesh=cpu_mesh(8),
                             lanes_per_device=4096)
    tp = pm.simulate_pallas_sharded(medium(**LAYER), cfg, seed=7,
                                    mesh=cpu_mesh(8), k_steps=8)
    return dict(jax=(jt.total_reflectance(), jt.total_absorption()), xla=tx,
                kernel=tp)


def test_mesh_topology_defaults_match_jax():
    ours = dataclasses.asdict(MeshTopology())
    assert ours == dataclasses.asdict(jconfig.MeshTopology())
    assert ours == {"batch_axis": pm.BATCH, "n_devices": None}


def test_make_mesh_and_the_split():
    m = cpu_mesh(3)
    assert m.devices == (torch.device("cpu"),) * 3
    assert (m.rank, m.world_size, m.n_shards) == (0, 1, 3)
    assert [m.shard_index(i) for i in range(3)] == [0, 1, 2]
    assert cpu_mesh(None).n_shards == 1
    two = pm.Mesh(devices=m.devices[:2], rank=1, world_size=3)
    assert two.n_shards == 6 and [two.shard_index(i) for i in (0, 1)] == [
        2, 3]
    # exact quota: the remainder goes to shard 0 / the first tiles
    assert [pm.shard_quota(10_001, i, 8) for i in range(8)] == [1251] + [
        1250] * 7
    q = np.concatenate([pm.tile_quotas(10_001, 5, i, 8) for i in range(8)])
    assert q.sum() == 10_001 and q[0] == q.max() and q[-1] == q.min()
    assert pm.shard_seed(5, 0) == 5 and pm.shard_seed(5, 2) == 5 + 1_999_966
    assert pm.shard_seed(2 ** 31 - 1, 1) == (2 ** 31 - 1 + 999_983) % 2 ** 31
    assert pm.shard_lanes(N, 8, 1 << 17, 256) == 4864
    # each shard's superstep stream is its own on the CPU too
    u = [photon.step_uniforms(pm.shard_seed(5, i), 0, 8, "cpu")
         for i in range(2)]
    assert not torch.equal(u[0], u[1])


def test_sharded_simulate_launches_exact_quota():
    cfg = PhotonRunConfig(n_photons=10_001, nr=16, nz=16)
    res = pm.simulate_sharded(medium(mu_a=1.0, mu_s=9.0, g=0.5, n=1.0), cfg,
                              seed=0, mesh=cpu_mesh(8), lanes_per_device=512)
    assert res.n_launched == 10_001
    assert abs(res.energy_total() - 1.0) < 1e-2


def test_sharded_matches_jax_sharded(runs):
    tx, (rd_j, a_j) = runs["xla"], runs["jax"]
    assert tx.n_launched == N
    se = binomial_stderr(rd_j, N) * np.sqrt(2)
    assert abs(tx.total_reflectance() - rd_j) < 3 * se + 1e-3, (
        tx.total_reflectance(), rd_j, se)
    assert abs(tx.total_absorption() - a_j) < 3 * se + 1e-3, (
        tx.total_absorption(), a_j)


def test_kernel_sharded_matches_superstep_sharded(runs):
    tp, tx = runs["kernel"], runs["xla"]
    assert tp.n_launched == N
    assert abs(tp.energy_total() - 1.0) < 5e-3
    a = tp.absorb_rz.double().numpy().reshape(8, 2, 8, 2).sum((1, 3))
    b = tx.absorb_rz.double().numpy().reshape(8, 2, 8, 2).sum((1, 3))
    chi2, dof = chi2_counts(a.reshape(-1), b.reshape(-1), min_expected=50.0)
    assert chi2 / max(dof, 1) < 1.5, (chi2, dof)
    se = binomial_stderr(tx.total_reflectance(), N) * np.sqrt(2)
    assert mc_parity_3sigma(tp.total_reflectance(), tx.total_reflectance(),
                            se, abs_floor=1e-3)


def test_kernel_one_shard_is_simulate_kernel():
    """Shard 0's seeds, quota split, lanes and blocks are
    ``simulate_kernel``'s: every field bitwise."""
    m = medium(**LAYER)
    cfg = PhotonRunConfig(n_photons=3_001, nr=8, nz=8, dr=0.05, dz=0.05,
                          detector_nx=4, vol_nx=4, vol_ny=4, vol_nz=4,
                          tally_stride=2)
    timings = {}
    a = pm.simulate_pallas_sharded(m, cfg, seed=3, mesh=cpu_mesh(1),
                                   lanes_per_device=1024, k_steps=8,
                                   chunk_blocks=2, timings=timings)
    b = pk.simulate_kernel(m, cfg, 3, lanes=1024, k_steps=8, chunk_blocks=2,
                           device="cpu")
    for f in dataclasses.fields(a):
        assert torch.equal(getattr(a, f.name), getattr(b, f.name)), f.name
    assert a.n_launched == 3_001 and timings["steady_blocks"] > 0


@pytest.mark.parametrize("n_shards", [2, 8])
def test_sharded_render_is_render_image(n_shards):
    """286 lanes: 8 shards pad 2 lanes.  Bitwise on the CPU, with either
    Fresnel mode."""
    scene, cfg = presets.lts_scene(width=13, height=11, spp=2, max_depth=3,
                                   device="cpu")
    img = pm.render_sharded(scene, cfg, seed=3, mesh=cpu_mesh(n_shards))
    ref = pt.render_image(scene, cfg, seed=3)
    assert img.shape == (11, 13, 3)
    assert torch.equal(img, ref)
    split = dataclasses.replace(cfg, fresnel_mode="split")
    assert torch.equal(
        pm.render_sharded(scene, split, seed=3, mesh=cpu_mesh(n_shards)),
        pt.render_image_split(scene, split, seed=3))


RANK_CODE = """
import json, sys, torch
from light_transport_tpu_torch.core.config import MediumConfig, PhotonRunConfig
from light_transport_tpu_torch.models import presets
from light_transport_tpu_torch.parallel import mesh as pm
from light_transport_tpu_torch.scene.medium import LayeredMedium
torch.set_num_threads(1)
port, rank = sys.argv[1], int(sys.argv[2])
mesh = pm.init_multihost(f"localhost:{port}", 2, rank, device_type="cpu")
m = LayeredMedium.build([MediumConfig(mu_a=1.0, mu_s=9.0, g=0.5)],
                        device="cpu")
t = pm.simulate_sharded(m, PhotonRunConfig(n_photons=4096, nr=8, nz=8),
                        seed=4, mesh=mesh, lanes_per_device=512)
scene, cfg = presets.lts_scene(width=5, height=3, spp=1, max_depth=2,
                               device="cpu")
img = pm.render_sharded(scene, cfg, seed=2, mesh=mesh)
bimg = pm.render_bdpt_sharded(scene, cfg, seed=3, mesh=mesh)
print(json.dumps(dict(shards=mesh.n_shards, launched=t.n_launched,
                      steps=t.n_steps, refl=t.refl_r.tolist(),
                      rz=t.absorb_rz.double().sum().item(),
                      img=img.flatten().tolist(),
                      bdpt=bimg.flatten().tolist())))
torch.distributed.destroy_process_group()
"""


def test_two_process_gloo_group():
    """``init_multihost`` + ``simulate_sharded``, ``render_sharded`` and
    ``render_bdpt_sharded`` in two gloo ranks of one shard each: both
    ranks hold the same result, that of two shards in one process."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", RANK_CODE, str(port),
                               str(r)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, cwd=ROOT,
                              env=env) for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err[-2000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            p.kill()
    assert outs[0] == outs[1]
    got = outs[0]
    assert got["shards"] == 2 and got["launched"] == 4096
    m = medium(mu_a=1.0, mu_s=9.0, g=0.5, n=1.0)
    t = pm.simulate_sharded(m, PhotonRunConfig(n_photons=4096, nr=8, nz=8),
                            seed=4, mesh=cpu_mesh(2), lanes_per_device=512)
    assert got["steps"] == t.n_steps
    np.testing.assert_allclose(got["refl"], t.refl_r.numpy(), rtol=1e-12)
    np.testing.assert_allclose(got["rz"], t.absorb_rz.double().sum().item(),
                               rtol=1e-12)
    scene, cfg = presets.lts_scene(width=5, height=3, spp=1, max_depth=2,
                                   device="cpu")
    ref = pt.render_image(scene, cfg, seed=2).flatten().tolist()
    assert got["img"] == ref
    # BDPT: the gloo sum of the two ranks' splat planes is the in-process
    # sum of two shards'
    two = pm.render_bdpt_sharded(scene, cfg, seed=3, mesh=cpu_mesh(2))
    assert got["bdpt"] == two.flatten().tolist()
    np.testing.assert_allclose(
        np.reshape(got["bdpt"], (3, 5, 3)),
        bdpt.render_bdpt(scene, cfg, seed=3).numpy(), rtol=0, atol=5e-6)

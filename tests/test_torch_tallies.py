"""The port's configuration, medium, tallies, statistics, presets and
interop against the JAX package, and the port's independence from JAX."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import light_transport_tpu.core.config as jconfig
import light_transport_tpu.models.presets as jpresets
import light_transport_tpu.tally.stats as jstats
from light_transport_tpu.scene.medium import LayeredMedium as JMedium
from light_transport_tpu.tally.tallies import PhotonTallies as JTallies
from light_transport_tpu.tally.tallies import counter_from_sum, counter_value
from light_transport_tpu_torch.core import config
from light_transport_tpu_torch.models import presets
from light_transport_tpu_torch.scene.medium import LayeredMedium
from light_transport_tpu_torch.tally import stats
from light_transport_tpu_torch.tally.tallies import PhotonTallies
from light_transport_tpu_torch.utils import interop

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name", ["MediumConfig", "PhotonRunConfig",
                                  "RenderConfig"])
def test_config_fields_and_defaults_match_jax(name):
    ours = dataclasses.fields(getattr(config, name))
    theirs = dataclasses.fields(getattr(jconfig, name))
    assert [f.name for f in ours] == [f.name for f in theirs]
    for a, b in zip(ours, theirs):
        assert a.default == b.default, (name, a.name)


LAYER_SETS = {
    "semi_infinite": ([jconfig.MediumConfig(mu_a=1.0, mu_s=9.0, g=0.0)], {}),
    "three_layers": ([
        jconfig.MediumConfig(mu_a=1.0, mu_s=100.0, g=0.9, n=1.4,
                             thickness=0.1),
        jconfig.MediumConfig(mu_a=1.0, mu_s=10.0, g=0.0, n=1.0,
                             thickness=0.1),
        jconfig.MediumConfig(mu_a=2.0, mu_s=10.0, g=0.7, n=1.37,
                             thickness=0.2)], dict(n_above=1.1, n_below=1.3)),
}


@pytest.mark.parametrize("which", sorted(LAYER_SETS))
def test_medium_build_matches_jax(which):
    layers, kw = LAYER_SETS[which]
    jm = JMedium.build(layers, **kw)
    m = LayeredMedium.build(
        [config.MediumConfig(**dataclasses.asdict(l)) for l in layers], **kw,
        device="cpu")
    assert m.num_layers == jm.num_layers
    for k in interop.MEDIUM_FIELDS:
        a, b = getattr(m, k).numpy(), np.asarray(getattr(jm, k))
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    back = interop.medium_from_numpy(interop.medium_to_numpy(m), device="cpu")
    for k in interop.MEDIUM_FIELDS:
        assert torch.equal(getattr(back, k), getattr(m, k)), k


@pytest.mark.parametrize("name", ["demo", "multilayer", "full_scale"])
def test_presets_match_jax(name):
    jm, jcfg = jpresets.PRESETS[name]()
    m, cfg = presets.PRESETS[name](device="cpu")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    for k in interop.MEDIUM_FIELDS:
        np.testing.assert_array_equal(getattr(m, k).numpy(),
                                      np.asarray(getattr(jm, k)), err_msg=k)


def test_int64_counters_match_two_word_counters():
    """The JAX package keeps launched/steps as exact two-word f32 counters;
    the port's int64 counts must carry the same values both ways, past the
    2^24 point where a single f32 loses integers."""
    rng = np.random.default_rng(0)
    parts = rng.integers(0, 2 ** 24, size=300).astype(np.float32)
    c = np.asarray(counter_from_sum(parts))
    exact = int(parts.astype(np.int64).sum())
    assert counter_value(c) == exact > 2 ** 31
    assert interop.counter_to_int(c) == exact
    np.testing.assert_array_equal(interop.int_to_counter(exact), c)


def test_tallies_round_trip_through_jax_layout():
    cfg = config.PhotonRunConfig(nr=8, nz=6, detector_nx=4, vol_nx=2,
                                 vol_ny=3, vol_nz=2)
    jcfg = jconfig.PhotonRunConfig(**dataclasses.asdict(cfg))
    jz = JTallies.zeros(jcfg)
    t = PhotonTallies.zeros(cfg, device="cpu")
    for k in interop.TALLY_FIELDS:
        assert tuple(getattr(t, k).shape) == (
            () if k in ("launched", "steps") else np.shape(getattr(jz, k))), k
    rng = np.random.default_rng(1)
    d = {k: rng.random(np.shape(getattr(jz, k))).astype(np.float32)
         for k in interop.TALLY_FIELDS}
    d["launched"] = interop.int_to_counter(123_456_789_012)
    d["steps"] = interop.int_to_counter(2 ** 40 - 1)
    t = interop.tallies_from_numpy(d, device="cpu")
    assert t.n_launched == 123_456_789_012
    assert t.n_steps == 2 ** 40 - 1
    back = interop.tallies_to_numpy(t)
    for k in interop.TALLY_FIELDS:
        np.testing.assert_array_equal(back[k], d[k], err_msg=k)
    merged = t.merge(t)
    assert merged.n_launched == 2 * t.n_launched
    assert merged.energy_total() == pytest.approx(t.energy_total())


def test_stats_match_jax():
    rng = np.random.default_rng(2)
    a, b = rng.random(50) * 100, rng.random(50) * 100 + 20
    assert stats.image_mae(a, b) == jstats.image_mae(a, b)
    assert stats.chi2_counts(a, b) == jstats.chi2_counts(a, b)
    for args in [(0.41, 0.4155, 0.002), (0.2, 0.26, 0.01, 3.0, 1e-3)]:
        assert (stats.mc_parity_3sigma(*args)
                == jstats.mc_parity_3sigma(*args))
    for p, n in [(0.4155, 1e5), (0.0, 1e4), (1.0, 10)]:
        assert stats.binomial_stderr(p, n) == jstats.binomial_stderr(p, n)
    with pytest.raises(ValueError):
        stats.chi2_counts([1.0], [1.0])


def test_port_imports_without_jax():
    """The port and every example driver of ``examples_torch/`` must import
    with jax unavailable (only its tests use JAX)."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['flax'] = None\n"
        "sys.modules['light_transport_tpu'] = None\n"
        "import light_transport_tpu_torch\n"
        "import light_transport_tpu_torch.api\n"
        "import light_transport_tpu_torch.ops.photon_kernel\n"
        "import light_transport_tpu_torch.ops._build\n"
        "import light_transport_tpu_torch.transport.photon\n"
        "import light_transport_tpu_torch.models.presets\n"
        "import light_transport_tpu_torch.parallel.mesh\n"
        "import light_transport_tpu_torch.tally.stats\n"
        "import light_transport_tpu_torch.utils.interop\n"
        "import light_transport_tpu_torch.utils.checkpoint\n"
        "import light_transport_tpu_torch.accel.bvh\n"
        "import light_transport_tpu_torch.accel.native\n"
        "import light_transport_tpu_torch.core.math\n"
        "import light_transport_tpu_torch.core.rng\n"
        "import light_transport_tpu_torch.integrators.path_tracer\n"
        "import light_transport_tpu_torch.integrators.whitted\n"
        "import light_transport_tpu_torch.integrators.adaptive\n"
        "import light_transport_tpu_torch.integrators.bdpt\n"
        "import light_transport_tpu_torch.integrators.control_variates\n"
        "import light_transport_tpu_torch.ops.dispatch\n"
        "import light_transport_tpu_torch.ops.feature_probes\n"
        "import light_transport_tpu_torch.ops.intersect\n"
        "import light_transport_tpu_torch.ops.lanestack\n"
        "import light_transport_tpu_torch.ops.qmc\n"
        "import light_transport_tpu_torch.ops.intersect_kernel\n"
        "import light_transport_tpu_torch.ops.raysort\n"
        "import light_transport_tpu_torch.ops.treelet_kernel\n"
        "import light_transport_tpu_torch.ops.sampling\n"
        "import light_transport_tpu_torch.scene.analytic\n"
        "import light_transport_tpu_torch.scene.cornell\n"
        "import light_transport_tpu_torch.scene.geometry\n"
        "import light_transport_tpu_torch.scene.glass\n"
        "import light_transport_tpu_torch.scene.lights\n"
        "import light_transport_tpu_torch.scene.material\n"
        "import light_transport_tpu_torch.scene.scene\n"
        "import light_transport_tpu_torch.scene.objio\n"
        "import light_transport_tpu_torch.utils.profiling\n"
        "import light_transport_tpu_torch.utils.png\n"
        "import light_transport_tpu_torch.cli\n"
        "import light_transport_tpu_torch.gui\n"
        "sys.modules['_common'] = None\n"
        "sys.modules['bench_mis_ab'] = None\n"
        "sys.path.insert(0, 'examples_torch')\n"
        "import _torch_common\n"
        "drivers = [_torch_common.load(n) for n in _torch_common.DRIVERS]\n"
        "assert len(drivers) == 12\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'flax'))\n"
        "               for m, v in sys.modules.items() if v is not None)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"

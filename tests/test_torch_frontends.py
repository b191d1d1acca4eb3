"""The port's front ends and small helpers on the CPU: ``scene.objio``
against JAX's parser and loader, ``henyey_greenstein_pdf`` and
``TriangleMesh.area`` against JAX's, ``utils.profiling``, the CLI
(``render`` with every integrator, ``--sharded``, ``--preview``;
``simulate`` plain, sharded and resumable), the GUI server, and the PNG
encoder against ``plt.imsave``.

The CLI's and the GUI's outputs are held to the direct port calls on the
same seed: the PNG's pixels equal the API image quantized as
``plt.imsave`` quantizes, and the JSON line equals the summary of
``api.simulate``'s tallies.  JAX runs only its OBJ parser, its mesh
constructor, its HG pdf op by op (eagerly), and its CLI's JSON printer
over a stub run (for its keys).  Tolerances: the
parser, the mesh fields and the areas bitwise; the HG pdf within rtol
1e-6.
"""

import dataclasses
import inspect
import io
import json
import os
import urllib.error
import urllib.request

import matplotlib
import numpy as np
import pytest
import torch

from light_transport_tpu import cli as jcli
from light_transport_tpu import api as japi
from light_transport_tpu.core import config as jconfig
from light_transport_tpu.models import presets as jpresets
from light_transport_tpu.ops import sampling as jsampling
from light_transport_tpu.scene import geometry as jgeometry
from light_transport_tpu.scene import objio as jobjio
from light_transport_tpu_torch import api, cli, gui
from light_transport_tpu_torch.accel import native
from light_transport_tpu_torch.integrators import control_variates as cv
from light_transport_tpu_torch.models import presets
from light_transport_tpu_torch.ops import sampling
from light_transport_tpu_torch.parallel import mesh as pm
from light_transport_tpu_torch.scene import geometry, objio
from light_transport_tpu_torch.utils import checkpoint, interop, profiling
from light_transport_tpu_torch.utils.png import decode_png, encode_png, quantize

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

torch.set_num_threads(1)

OBJ = """# a cube's two faces, a triangle and a pentagon, every index syntax
v 0.0 0.0 0.0
v 1.0 0.0 0.0
v 1.0 1.0 0.0
v 0.0 1.0 0.0
vt 0.0 0.0
vn 0.0 0.0 1.0
f 1/1/1 2/1/1 3/1/1 4/1/1
v 0.0 0.0 -2.5
v 1.0 0.0 -2.5
v 1.5 0.5 -2.5
v 1.0 1.0 -2.5
v 0.0 1.0 -2.5
f -5//1 -4//1 -3//1 -2//1 -1//1
f 1/1 5 -1
g ignored
f 2 6 7
"""
# JAX's keys of the GUI's stats (light_transport_tpu/gui.py:138-148)
GUI_STATS = ["preset", "integrator", "size", "spp", "max_depth", "seed",
             "triangles", "elapsed_s", "mean"]
LTS = ["--preset", "lts", "--width", "12", "--height", "10", "--spp", "4",
       "--max-depth", "2", "--device", "cpu"]


@pytest.fixture(scope="module")
def obj_path(tmp_path_factory):
    p = tmp_path_factory.mktemp("obj") / "shape.obj"
    p.write_text(OBJ)
    return str(p)


def lts(**over):
    scene, cfg = presets.lts_scene(device="cpu")
    return scene, dataclasses.replace(cfg, width=12, height=10, spp=4,
                                      max_depth=2, **over)


def read_png(path):
    with open(path, "rb") as f:
        return decode_png(f.read())


def test_parse_obj_matches_jax(obj_path):
    """v/vt/vn indices, negative indices and polygon fans: the same
    float64 (T, 3, 3) array as JAX's parser."""
    got = objio.parse_obj(obj_path)
    want = jobjio.parse_obj(obj_path)
    assert got.dtype == np.float64 and got.shape == (7, 3, 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[2], [[0, 0, -2.5], [1, 0, -2.5],
                                           [1.5, 0.5, -2.5]])
    assert objio.reference_obj_path("cow.obj") is None or os.path.exists(
        objio.reference_obj_path("cow.obj"))


def test_load_obj_fields_match_jax(obj_path):
    """``load_obj``'s mesh fields and dimension equal JAX's, carried over
    through ``utils.interop``'s field lists; the mesh lands on the asked
    device and dtype."""
    mesh, dim = objio.load_obj(obj_path, mat_id=3, device="cpu")
    jmesh, jdim = jobjio.load_obj(obj_path, mat_id=3)
    assert dim == jdim == 2.5
    want = {k: np.asarray(getattr(jmesh, k)) for k in geometry.MESH_FIELDS}
    got = interop._arrays(mesh, geometry.MESH_FIELDS)
    for k in geometry.MESH_FIELDS:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert mesh.device.type == "cpu" and mesh.v0.dtype == torch.float32
    m64, _ = objio.load_obj(obj_path, dtype=torch.float64, device="cpu")
    assert m64.v0.dtype == torch.float64
    assert inspect.signature(objio.load_obj).parameters[
        "device"].default == "cuda"


def test_hg_pdf_matches_jax_and_integrates():
    """``henyey_greenstein_pdf`` within rtol 1e-6 of JAX's op by op,
    including the clamped denominator at g = 1, cos = 1; it integrates to
    1 over the sphere.  (Compiled, XLA rounds ``1 + g^2 - 2 g cos`` apart
    by up to 7.1e-6 relative where it cancels, near |g| = |cos| = 1.)"""
    r = np.random.default_rng(0)
    cos = r.uniform(-1, 1, 4096).astype(np.float32)
    g = r.uniform(-0.95, 0.95, 4096).astype(np.float32)
    cos[:4], g[:4] = [1.0, -1.0, 0.3, 1.0], [1.0, -1.0, 0.0, 0.999]
    want = np.asarray(jsampling.henyey_greenstein_pdf(cos, g))
    got = sampling.henyey_greenstein_pdf(torch.from_numpy(cos),
                                         torch.from_numpy(g)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    mu = torch.linspace(-1, 1, 200001, dtype=torch.float64)
    for gv in (-0.7, 0.0, 0.5, 0.9):
        p = sampling.henyey_greenstein_pdf(mu, torch.tensor(gv,
                                                            dtype=mu.dtype))
        assert abs(2 * np.pi * torch.trapezoid(p, mu).item() - 1) < 1e-4


def test_area_matches_jax_and_helpers():
    """``TriangleMesh.area`` bitwise JAX's (float64 on host copies);
    ``native.available`` is a query; the subpackages re-export JAX's
    public names."""
    from light_transport_tpu.scene.cornell import sphere_triangles as jsph
    from light_transport_tpu_torch import (
        accel, core, integrators, ops, parallel, scene, tally, transport)

    tris = jsph(center=(1, 2, 3), radius=2.0, n_theta=24, n_phi=48)
    mat = np.zeros(len(tris), np.int32)
    got = geometry.TriangleMesh.build(tris, mat, device="cpu").area()
    want = jgeometry.TriangleMesh.build(tris, mat).area()
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got.sum(), 4 * np.pi * 4.0, rtol=0.02)
    assert isinstance(native.available(), bool)
    names = {accel: ["BVH", "build", "intersect_bvh", "occluded_bvh"],
             core: ["config", "math", "rng"],
             integrators: ["render_adaptive", "camera_rays", "render_image",
                           "trace_paths"],
             ops: ["Hit", "intersect_rays", "occluded", "plane_intersect",
                   "sphere_intersect", "aabb_intersect"],
             parallel: ["make_mesh", "render_sharded", "simulate_sharded",
                        "render_bdpt_sharded"],
             scene: ["BSDF_DIFFUSE", "BSDF_MIRROR", "BSDF_NONE",
                     "BSDF_TRANSMISSIVE", "Color", "Material",
                     "MaterialTable", "presets", "TriangleMesh",
                     "LightTable", "Scene", "cornell_box_scene",
                     "LayeredMedium"],
             tally: ["PhotonTallies", "chi2_counts", "image_mae",
                     "mc_parity_3sigma"],
             transport: ["PhotonState", "run_fixed_steps",
                         "simulate_photons", "superstep"]}
    for mod, ns in names.items():
        for n in ns:
            assert hasattr(mod, n), (mod.__name__, n)


def test_profiling_helpers(tmp_path):
    """``StepTimer``, ``timed`` and ``compile_and_steady`` on torch
    (``tests/test_utils.py:72-83``), and ``trace`` writing a Chrome trace
    that names the ops it saw."""
    t = profiling.StepTimer()
    for _ in range(3):
        with t.step():
            pass
    assert len(t.times) == 3 and t.steps_per_sec() > 0
    x = torch.ones(8)
    out, s = profiling.timed(lambda a: {"y": (a * 2, [a + 1])}, x)
    assert torch.equal(out["y"][0], x * 2) and s >= 0
    t_compile, t_steady = profiling.compile_and_steady(lambda a: a * 2, x)
    assert t_compile > 0 and t_steady > 0
    with profiling.trace(None) as prof:
        assert prof is None
    with profiling.trace(str(tmp_path / "tr")) as prof:
        torch.mm(torch.ones(16, 16), torch.ones(16, 16))
    files = os.listdir(tmp_path / "tr")
    assert len(files) == 1 and files[0].endswith(".json")
    assert "aten::mm" in (tmp_path / "tr" / files[0]).read_text()


def test_cli_render_every_integrator(tmp_path, capsys):
    """``render`` writes the PNG of the direct port call's image for each
    integrator (``cv`` through ``render_cv(...).image_cv``), and
    ``--preview`` its HTML index; without ``--device`` it asks for the
    card."""
    for integ in ("path", "adaptive", "whitted", "bdpt", "cv"):
        out = str(tmp_path / f"{integ}.png")
        assert cli.main(["render", *LTS, "--integrator", integ, "--seed",
                         "3", "--out", out]) == 0
        scene, cfg = lts()
        if integ == "cv":
            want = cv.render_cv(scene, cfg, 3).image_cv
        else:
            want = api.render(scene, cfg, seed=3, integrator=integ)
        assert np.array_equal(read_png(out), quantize(want)), integ
    assert cli.main(["render", *LTS, "--preview", "--out",
                     str(tmp_path / "p.png")]) == 0
    page = (tmp_path / "p.html").read_text()
    assert "light_transport_tpu_torch render" in page
    assert "triangles" in page and "elapsed_s" in page
    assert "data:image/png;base64," in page
    assert "wrote" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        cli.main(["render", *LTS, "--sharded", "--integrator", "whitted"])
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            cli.main(["render", "--preset", "lts", "--out",
                      str(tmp_path / "x.png")])


def test_cli_sharded_render_and_simulate(tmp_path, capsys, monkeypatch):
    """``--sharded`` renders through ``render_sharded`` and
    ``render_bdpt_sharded``; ``simulate`` prints the summary of
    ``api.simulate`` (and of ``simulate_sharded``,
    ``simulate_resumable``), with JAX's CLI's keys."""
    scene, cfg = lts()
    for integ, fn in (("path", pm.render_sharded),
                      ("bdpt", pm.render_bdpt_sharded)):
        out = str(tmp_path / f"s_{integ}.png")
        assert cli.main(["render", *LTS, "--sharded", "--integrator", integ,
                         "--seed", "2", "--out", out]) == 0
        assert np.array_equal(read_png(out), quantize(fn(scene, cfg, 2)))
    capsys.readouterr()

    def line(args):
        assert cli.main(["simulate", "--preset", "demo", "--photons",
                         "4000", "--seed", "1", "--device", "cpu",
                         *args]) == 0
        d = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert d.pop("seconds") > 0
        return d

    medium, pcfg = presets.demo_homogeneous(device="cpu")
    pcfg = dataclasses.replace(pcfg, n_photons=4000)
    want = cli.simulate_summary(api.simulate(medium, pcfg, seed=1), 0.0)
    del want["seconds"]
    got = line([])
    assert got == want and got["photons"] == 4000
    assert abs(got["energy"] - 1.0) < 0.02
    want_sh = cli.simulate_summary(pm.simulate_sharded(medium, pcfg, 1), 0)
    del want_sh["seconds"]
    assert line(["--sharded"]) == want_sh
    ck = str(tmp_path / "run.npz")
    first = line(["--checkpoint", ck])
    assert os.path.exists(ck) and line(["--checkpoint", ck]) == first
    res = checkpoint.simulate_resumable(medium, pcfg, 1,
                                        str(tmp_path / "b.npz"))
    want_ck = cli.simulate_summary(res, 0.0)
    del want_ck["seconds"]
    assert first == want_ck

    # JAX's keys, from its CLI's printer over a stub run
    class Stub:
        n_launched, n_steps = 1, 2

        def __getattr__(self, name):
            return lambda: 0.5

    monkeypatch.setitem(jpresets.PRESETS, "demo",
                        lambda: (None, jconfig.PhotonRunConfig()))
    monkeypatch.setattr(japi, "simulate", lambda *a, **k: Stub())
    assert jcli.main(["simulate", "--preset", "demo"]) == 0
    jkeys = list(json.loads(capsys.readouterr().out.strip()
                            .splitlines()[-1]))
    assert list(cli.simulate_summary(Stub(), 0.0)) == jkeys


def _get(port, path):
    return urllib.request.urlopen(
        f"http://127.0.0.1:{port}{path}", timeout=60).read()


def test_gui_roundtrip_and_bad_request():
    """The server (``tests/test_gui.py``): the form, a render whose
    ``/img.png`` decodes to the API image, ``/stats.json`` with JAX's
    keys, the clamps, and an error shown in the page while the server
    keeps serving; ``serve`` defaults to the card."""
    assert inspect.signature(gui.serve).parameters["device"].default \
        == "cuda"
    srv = gui.serve(port=0, background=True, device="cpu")
    try:
        port = srv.server_port
        home = _get(port, "/").decode()
        assert "<form" in home and "preset" in home and "integrator" in home
        page = _get(port, "/render?preset=lts&width=12&height=10&spp=4"
                          "&max_depth=2&seed=1&integrator=path"
                          "&emission_mode=nee").decode()
        assert "elapsed_s" in page and "triangles" in page
        scene, cfg = lts(emission_mode="nee")
        want = quantize(api.render(scene, cfg, seed=1))
        assert np.array_equal(decode_png(_get(port, "/img.png")), want)
        stats = json.loads(_get(port, "/stats.json"))
        assert list(stats) == GUI_STATS
        assert stats["size"] == "12x10" and stats["triangles"] > 0
        assert 0.0 < stats["mean"] < 1.0
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(port, "/render?preset=nope")
        assert e.value.code == 500
        assert "unknown preset" in e.value.read().decode()
        assert b"<form" in _get(port, "/")
        # the clamps: width to [1, 1024], depth to [1, 16]
        _get(port, "/render?preset=lts&width=-3&height=2&spp=1"
                   "&max_depth=99")
        stats = json.loads(_get(port, "/stats.json"))
        assert stats["size"] == "1x2" and stats["max_depth"] == 16
    finally:
        srv.shutdown()
        srv.server_close()


def test_gui_run_render_cv():
    """``cv`` routes through ``render_cv`` as the CLI's does."""
    stats = gui.run_render({"preset": "lts", "width": "12", "height": "10",
                            "spp": "4", "max_depth": "2", "seed": "0",
                            "integrator": "cv"}, device="cpu")
    assert list(stats) == GUI_STATS
    assert stats["integrator"] == "cv" and 0.0 < stats["mean"] < 1.0
    scene, cfg = lts()
    want = quantize(cv.render_cv(scene, cfg, 0).image_cv)
    assert np.array_equal(decode_png(gui._State.png), want)


def test_png_pixels_equal_imsave():
    """The stdlib encoder's pixels equal ``plt.imsave``'s for the same
    float32 image (values outside [0, 1], 0.999 -> 254, 1.0 -> 255), as
    matplotlib reads both files back, and as the port's decoder reads
    its own."""
    r = np.random.default_rng(1)
    img = r.uniform(-0.2, 1.2, (23, 17, 3)).astype(np.float32)
    img[0, :3, 0] = [0.999, 1.0, 0.5]
    buf = io.BytesIO()
    plt.imsave(buf, np.clip(img, 0, 1), format="png")
    buf.seek(0)
    theirs = np.round(plt.imread(buf) * 255)
    png = encode_png(img)
    ours = decode_png(png)
    assert ours.dtype == np.uint8 and ours.shape == (23, 17, 4)
    np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(
        np.round(plt.imread(io.BytesIO(png)) * 255), theirs)
    assert list(ours[0, :3, 0]) == [254, 255, 127]
    assert (ours[..., 3] == 255).all()
    np.testing.assert_array_equal(decode_png(encode_png(torch.from_numpy(
        img))), ours)

"""The port's glossy (modified-Phong) BSDF, ``emission_mode`` ``"mis"`` and
``"always"``, and the surface detectors against the JAX package on the
CPU.

- The sampling functions (``sample_phong_lobe``, ``phong_pdf``,
  ``glossy_mix``, ``glossy_pdf``, ``glossy_f``) on numpy inputs at
  shininess 0.1, 1, 24, 80 and 400, with directions at ``cos = 0`` and
  below the horizon, where the guarded ``pow`` gives exactly 0.
- Two glossy scenes, built on both sides and their tables held bitwise:
  (a) the glossy plate of ``scripts/bench_mis_ab.py``'s recipe at
  shininess 400 (4 triangles) and (b) the Cornell box with a glossy cone
  (28 triangles), both on the brute force.  Each is traced from the same
  uniforms under ``emission_mode`` ``first_hit``, ``nee``, ``mis`` and
  ``always``: one bounce and the whole trace.
- BDPT's ``_bdpt_body`` on scene (b) from one numpy lanes dict, area and
  mixed families (JAX's eager); Whitted's tree on scene (b) from JAX's
  jittered camera rays.
- ``surface_detector_tally`` on the same trace record on both sides, then
  the port's ``render_with_detectors`` against ``tests/test_detectors.py``'s
  rules.

The JAX traces compile at the tests' ``CHEAP_COMPILE`` level; JAX's BDPT
runs eagerly and its Whitted in pieces (as ``tests/test_torch_bdpt.py``
and ``tests/test_torch_whitted.py`` run them).  Tolerances:

- directions of ``sample_phong_lobe`` within atol 2e-6 (the frame, sqrt,
  cos and sin of the two libraries); ``glossy_mix`` within rtol 1e-6;
  ``phong_pdf``, ``glossy_pdf`` and ``glossy_f`` within rtol
  ``(n + 1) * 2^-23 + 1e-6`` at shininess ``n`` (``pow(c, n)`` multiplies
  an ulp of ``c`` by ``n``) plus atol ``(n + 2) * 2^-126``, the
  normalization times the smallest normal float32 (XLA's CPU code flushes
  a subnormal ``pow`` such as ``0.01^24`` to 0, torch keeps it), and
  exactly 0 (``glossy_f`` exactly ``kd / pi``)
  where ``cos <= 0``;
- traces: >= 99 % of lanes within rtol 1e-4, atol 1e-6 (the state after
  one bounce and the radiance, prev_pdf, log_pdf and incident power of
  the whole trace), the same triangle on >= 99 % of the records, image
  means within 1e-3 (``tests/test_torch_render.py``'s);
- BDPT: every lane within rtol 1e-4, atol 1e-6, splats within rtol 1e-5,
  atol 1e-6; Whitted: atol 1e-4 on every pixel;
- detectors: hits bitwise, energy within rtol 1e-5 (the scatter-adds sum
  in another order).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from light_transport_tpu.core import math as jlm
from light_transport_tpu.core.config import RenderConfig as JRenderConfig
from light_transport_tpu.integrators import bdpt as jb
from light_transport_tpu.integrators import path_tracer as jpt
from light_transport_tpu.integrators import whitted as jw
from light_transport_tpu.ops import sampling as jsamp
from light_transport_tpu.scene import geometry as jgeo
from light_transport_tpu.scene import material as jmat
from light_transport_tpu.scene.cornell import cornell_box_scene as jcornell
from light_transport_tpu.scene.scene import Scene as JScene
from light_transport_tpu_torch.integrators import bdpt as tb
from light_transport_tpu_torch.integrators import path_tracer as pt
from light_transport_tpu_torch.integrators import whitted as tw
from light_transport_tpu_torch.models import presets
from light_transport_tpu_torch.ops import sampling
from light_transport_tpu_torch.scene.cornell import cornell_box_scene
from light_transport_tpu_torch.scene.material import BSDF_GLOSSY
from light_transport_tpu_torch.scene.material import presets as mp
from light_transport_tpu_torch.utils import interop
from test_torch_analytic import jax_scene_tables
from test_torch_bdpt import lanes_np
from test_torch_render import (
    CHEAP_COMPILE,
    jax_uniforms,
    lanes_close,
    port_cfg,
)
from test_torch_whitted import jax_pieces

torch.set_num_threads(1)

SHININESS = (0.1, 1.0, 24.0, 80.0, 400.0)
MODES = ("first_hit", "nee", "mis", "always")
MIXED_LIGHT = ([[0.0, 3.0, 0.0]], [[40.0, 40.0, 40.0]])


def t(a):
    return torch.from_numpy(np.array(a, copy=True))


def jax_plate(width, height, spp, max_depth, shininess=400.0, half=3.0,
              power=60.0):
    """``scripts/bench_mis_ab.py:52-90``'s glossy plate, written here with
    the JAX package's modules (the port's is
    ``presets.glossy_plate_scene``)."""
    C = jmat.Color.of
    glossy = jmat.Material(color=C((0, 0, 0), (0.05, 0.05, 0.05),
                                   (0.90, 0.90, 0.90)),
                           shininess=shininess, is_diffuse=False,
                           is_glossy=True)
    source = jmat.Material(color=C((1, 1, 1), (1, 1, 1), (1, 1, 1)),
                           shininess=1, emission=power / (4.0 * half * half))
    s = 3.0 * 0.70710678
    plate = jgeo.TriangleMesh.build(
        jgeo.quad_triangles((-3.0, -s, s), (3.0, -s, s), (3.0, s, -s),
                            (-3.0, s, -s)), np.zeros(2, np.int32))
    lights = jgeo.TriangleMesh.build(
        jgeo.quad_triangles((-half, 6.0, -half), (half, 6.0, -half),
                            (half, 6.0, half), (-half, 6.0, half)),
        np.full(2, 1, np.int32), np.ones(2, bool))
    scene = JScene.build(jgeo.concat_meshes([plate, lights]),
                         jmat.MaterialTable.build([glossy, source]),
                         camera=[0.0, 0.0, 9.0])
    return scene, JRenderConfig(width=width, height=height, spp=spp,
                                max_depth=max_depth, f_distance=4.5)


# scene -> (how JAX makes it, how the port makes it) at the traces' size
SCENES = {
    "plate": (lambda **k: jax_plate(**k, shininess=400.0),
              lambda **k: presets.glossy_plate_scene(**k, shininess=400.0,
                                                     device="cpu")),
    "cornell": (lambda **k: jcornell(**k,
                                     cone_material=jmat.presets.GLOSSY_MAT),
                lambda **k: cornell_box_scene(**k, cone_material=mp.GLOSSY_MAT,
                                              device="cpu")),
}
TRACE_SIZE = dict(width=16, height=16, spp=2, max_depth=3)


def sampling_inputs(seed=5, n=2048):
    """Lanes for every shininess: random axes and normals, directions near
    the axis (so ``cos^400`` is not 0) and anywhere, and rows with ``w``
    exactly perpendicular to the axis (``cos = 0``) or opposite it."""
    r = np.random.default_rng(seed)

    def unit(v):
        return v / np.linalg.norm(v, axis=-1, keepdims=True)

    m = n * len(SHININESS)
    axis = unit(r.normal(size=(m, 3)))
    spread = np.choose(r.integers(0, 4, m), [0.003, 0.03, 0.3, 3.0])
    w = unit(axis + spread[:, None] * r.normal(size=(m, 3)))
    ez, ex = np.eye(3)[2], np.eye(3)[0]
    axis[0::16], w[0::16] = ez, ex  # cos exactly 0
    axis[1::16], w[1::16] = ez, -ez  # below the horizon
    w[2::16] = -axis[2::16]
    n_s = unit(axis + 0.5 * r.normal(size=(m, 3)))
    kd, ks = r.random((m, 3)), r.random((m, 3))
    kd[3::64] = ks[3::64] = 0.0  # black: glossy_mix is 0
    u0, u1 = r.random(m), r.random(m)
    u0[4::64], u0[5::64] = 0.0, 1.0
    shin = np.repeat(np.float32(SHININESS), n)
    f32 = np.float32
    return dict(axis=axis.astype(f32), w=w.astype(f32), n_s=n_s.astype(f32),
                kd=kd.astype(f32), ks=ks.astype(f32), u0=u0.astype(f32),
                u1=u1.astype(f32), shin=shin)


def sampling_outputs(s, x):
    """The five functions of sampling module ``s`` on inputs ``x``."""
    return dict(
        lobe=s.sample_phong_lobe(x["axis"], x["shin"], x["u0"], x["u1"]),
        phong_pdf=s.phong_pdf(x["axis"], x["w"], x["shin"]),
        mix=s.glossy_mix(x["kd"], x["ks"]),
        glossy_pdf=s.glossy_pdf(x["kd"], x["ks"], x["shin"], x["n_s"],
                                x["axis"], x["w"]),
        glossy_f=s.glossy_f(x["kd"], x["ks"], x["shin"], x["axis"], x["w"]))


def test_glossy_sampling_matches_jax():
    x = sampling_inputs()
    want = jax.jit(functools.partial(sampling_outputs, jsamp),
                   compiler_options=CHEAP_COMPILE)(
        {k: jnp.asarray(v) for k, v in x.items()})
    want = {k: np.asarray(v) for k, v in want.items()}
    got = {k: v.numpy() for k, v in sampling_outputs(
        sampling, {k: t(v) for k, v in x.items()}).items()}
    np.testing.assert_allclose(got["lobe"], want["lobe"], rtol=0, atol=2e-6)
    np.testing.assert_allclose(got["mix"], want["mix"], rtol=1e-6, atol=0)
    rtol = (x["shin"] + 1.0) * 2.0 ** -23 + 1e-6
    for k in ("phong_pdf", "glossy_pdf", "glossy_f"):
        g, w = got[k], want[k]
        r = rtol if g.ndim == 1 else rtol[:, None]
        floor = (x["shin"] + 2.0) * np.finfo(np.float32).tiny
        bad = np.abs(g - w) > r * np.abs(w) + (
            floor if g.ndim == 1 else floor[:, None])
        assert not bad.any(), (k, x["shin"][bad.reshape(len(r), -1).any(1)])
    # cos <= 0: the guarded pow is exactly 0 on both sides
    cos = np.sum(x["axis"] * x["w"], axis=-1)
    back = cos <= 0.0
    assert back[0::16].all() and back[1::16].all() and back.mean() > 0.1
    for out in (got, want):
        assert not out["phong_pdf"][back].any()
        np.testing.assert_array_equal(
            out["glossy_f"][back], (x["kd"] * np.float32(jlm.INV_PI))[back])
    assert (got["phong_pdf"][~back] > 0).mean() > 0.5
    # the lobe's directions are unit vectors about their axis
    np.testing.assert_allclose(np.linalg.norm(got["lobe"], axis=-1), 1.0,
                               atol=1e-5)


def test_glossy_scene_tables_match_jax():
    """Both glossy scenes built by each package from the same arrays: the
    port's tables are JAX's bit for bit."""
    for name, (jbuild, tbuild) in SCENES.items():
        js, jcfg = jbuild(**TRACE_SIZE)
        scene, cfg = tbuild(**TRACE_SIZE)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg), name
        ours, theirs = interop.scene_to_numpy(scene), jax_scene_tables(js)
        for table in ("mesh", "materials", "lights"):
            for k, v in theirs[table].items():
                a = ours[table][k]
                assert a.dtype == v.dtype and a.shape == v.shape, (name, k)
                np.testing.assert_array_equal(a, v, err_msg=f"{name} {k}")
        np.testing.assert_array_equal(ours["camera"], theirs["camera"])
        assert (scene.materials.bsdf == BSDF_GLOSSY).any(), name


@functools.lru_cache(maxsize=None)
def traces(name):
    """JAX's and the port's one bounce and whole trace of scene ``name``
    under every emission mode, from the same uniforms."""
    js, jcfg0 = SCENES[name][0](**TRACE_SIZE)
    scene = interop.scene_from_numpy(jax_scene_tables(js), device="cpu")
    u_aa, uni = jax_uniforms(jax.random.key(11), jcfg0)
    ua, un = interop.uniforms_from_numpy(u_aa, uni, device="cpu")
    out = {}
    for mode in MODES:
        jcfg = dataclasses.replace(jcfg0, emission_mode=mode)

        def jax_side(js, u_aa, uni):
            o, d = jpt.camera_rays(js, jcfg, u_aa)
            state, _ = jpt._bounce(js, jcfg, jpt.PathState.initial(o, d),
                                   uni[:, 0], 0, None)
            return (state,) + tuple(jpt.trace_paths(js, jcfg, o, d, uni))

        jstate, jrad, jrec = jax.jit(
            jax_side, compiler_options=CHEAP_COMPILE)(js, u_aa, uni)
        cfg = port_cfg(jcfg)
        o, d = pt.camera_rays(scene, cfg, ua)
        state, _ = pt._bounce(scene, cfg, pt.PathState.initial(o, d),
                              un[:, 0], 0)
        rad, rec = pt.trace_paths(scene, cfg, o, d, un)
        out[mode] = dict(cfg=cfg, jstate=jstate, jrad=np.asarray(jrad),
                         jrec=jrec, state=state, rad=rad.numpy(), rec=rec)
    return js, scene, out


@pytest.mark.parametrize("name", sorted(SCENES))
def test_glossy_traces_match_jax(name):
    _, scene, out = traces(name)
    means = {}
    for mode, r in out.items():
        s, js = r["state"], r["jstate"]
        ok = np.ones(s.alive.shape[0], bool)
        for f in ("origin", "direction", "throughput", "radiance",
                  "prev_pdf"):
            ok &= lanes_close(getattr(s, f).numpy(), getattr(js, f))
        for f in ("alive", "emit_ok"):
            ok &= getattr(s, f).numpy() == np.asarray(getattr(js, f))
        assert ok.mean() >= 0.99, (mode, ok.mean())
        close = lanes_close(r["rad"], r["jrad"])
        assert close.mean() >= 0.99, (mode, close.mean())
        rec, jrec = r["rec"], r["jrec"]
        for f in ("log_pdf", "incident"):
            assert lanes_close(getattr(rec, f).numpy(),
                               getattr(jrec, f)).mean() >= 0.99, (mode, f)
        assert (rec.tri.numpy() == np.asarray(jrec.tri)).mean() >= 0.99
        img = pt._to_image(torch.from_numpy(r["rad"]), r["cfg"])[0].numpy()
        jimg = np.asarray(jpt._to_image(r["jrad"], r["cfg"])[0])
        assert abs(img.mean() - jimg.mean()) < 1e-3, mode
        means[mode] = float(r["rad"].mean())
    # the glossy branch ran: lanes that hit a glossy surface took a
    # sampled direction with a positive pdf
    glossy = scene.materials.bsdf[scene.mesh.mat_id.long()] == BSDF_GLOSSY
    first = out["nee"]["rec"].tri[:, 0].long()
    on_glossy = (first >= 0) & glossy[first.clamp(min=0)]
    assert int(on_glossy.sum()) >= 5
    assert (out["nee"]["state"].prev_pdf[on_glossy] > 0).float().mean() > 0.5
    # "always" adds every emitter hit on top of NEE, "mis" weights them
    assert means["always"] > means["nee"] > 0
    assert means["mis"] != means["nee"]


@pytest.fixture(scope="module", params=["area", "mixed"])
def glossy_body(request):
    """JAX's eager ``_bdpt_body`` and the port's on one numpy lanes dict:
    scene (b) at 8x8x2, depth 3, with the mixed family's point light at
    (0, 3, 0), I = 40."""
    js, jcfg = jcornell(width=8, height=8, spp=2, max_depth=3,
                        cone_material=jmat.presets.GLOSSY_MAT)
    if request.param == "mixed":
        js = js.with_point_lights(*MIXED_LIGHT)
    family, q = jb._light_family(js)
    assert family == request.param
    draws = lanes_np(jcfg, family, 21)
    u_aa = draws.pop("u_aa")
    o, d = jpt.camera_rays(js, jcfg, jnp.asarray(u_aa))
    jl = {k: jnp.asarray(v) for k, v in draws.items()}
    jl.update(o=o, d=d, mask=jnp.ones(o.shape[0], bool))
    want = jb._bdpt_body(js, jcfg, jl, None, True, family,
                         jnp.asarray(q, jnp.float32))
    scene = interop.scene_from_numpy(jax_scene_tables(js), device="cpu")
    tl = {k: t(v) for k, v in draws.items()}
    tl.update(o=t(o), d=t(d), mask=torch.ones(o.shape[0], dtype=torch.bool))
    cfg = port_cfg(jcfg)
    got = tb._bdpt_body(scene, cfg, tl, None, True, family, q)
    cam = tb.generate_camera_subpaths(scene, cfg, tl["o"], tl["d"],
                                      tl["cam_u"])
    return dict(glossy_vertices=int((cam.spec > 0).any(-1).sum()),
                want=[np.asarray(w) for w in want],
                got=[g.numpy() for g in got])


def test_glossy_bdpt_matches_jax(glossy_body):
    (want_rad, want_splat), (rad, splat) = (glossy_body["want"],
                                            glossy_body["got"])
    close = np.isclose(rad, want_rad, rtol=1e-4, atol=1e-6).all(axis=1)
    assert close.all(), np.nonzero(~close)[0]
    np.testing.assert_allclose(splat, want_splat, rtol=1e-5, atol=1e-6)
    assert rad.max() > 0.0 and splat.max() > 0.0
    # camera vertices on the glossy cone (ks is kept at glossy vertices)
    assert glossy_body["glossy_vertices"] >= 8


def test_glossy_whitted_matches_jax():
    """``trace_whitted`` at depth 3 on scene (b) from JAX's jittered
    camera rays: JAX shades the glossy cone by its Phong terms and reads
    no ``is_glossy``, and so does the port."""
    js, jcfg = jcornell(width=16, height=16, spp=1, max_depth=3,
                        cone_material=jmat.presets.GLOSSY_MAT)
    n = jcfg.width * jcfg.height
    u_aa = jax.random.uniform(jax.random.key(4), (n, 2))
    o, d = jax.jit(lambda u: jpt.camera_rays(js, jcfg, u),
                   compiler_options=CHEAP_COMPILE)(u_aa)
    scene = interop.scene_from_numpy(jax_scene_tables(js), device="cpu")
    with jax_pieces():
        want = np.asarray(jw.trace_whitted(js, o, d, 3))
    got = tw.trace_whitted(scene, t(o), t(d), 3).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert got.mean() > 0.05


def test_surface_detector_tally_matches_jax():
    """One trace record of scene (b) per mode, tallied on each side."""
    js, scene, out = traces("cornell")
    n_tri = scene.mesh.num_triangles
    for mode, r in out.items():
        jenergy, jhits = jpt.surface_detector_tally(r["jrec"], n_tri)
        energy, hits = pt.surface_detector_tally(r["rec"], n_tri)
        np.testing.assert_array_equal(hits.numpy(), np.asarray(jhits))
        np.testing.assert_allclose(energy.numpy(), np.asarray(jenergy),
                                   rtol=1e-5, atol=0)
        assert hits.dtype == torch.int32 and int(hits.sum()) > 0


def test_render_with_detectors_rules():
    """``tests/test_detectors.py:20``'s rules on the port alone, scene (b)
    at 16x16x4, depth 3: the image is ``render_image``'s bit for bit,
    energy only where there are hits, and the back wall (triangles 4 and
    5) takes more than 5 % of the primary hits."""
    scene, cfg = SCENES["cornell"][1](width=16, height=16, spp=4,
                                      max_depth=3)
    img, energy, hits = pt.render_with_detectors(scene, cfg, seed=0)
    t_ = scene.mesh.num_triangles
    assert energy.shape == hits.shape == (t_,)
    assert int(hits.sum()) > 0 and bool((hits >= 0).all())
    assert int(hits[4] + hits[5]) > 16 * 16 * 4 * 0.05
    assert bool(((energy > 0) <= (hits > 0)).all())
    assert torch.equal(img, pt.render_image(scene, cfg, seed=0))
    assert float(energy[(scene.mesh.mat_id == 3)].sum()) > 0  # the cone

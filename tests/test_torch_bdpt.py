"""The port's BDPT against the JAX package on the CPU: ``_bdpt_body`` from
one lanes dict made by numpy in the area, point and mixed light families
(light tracing on and off), ``cam_side_mis`` and ``light_side_mis`` on
the same vertices, ``_light_family`` on the three kinds of scene; then
the port alone: the MIS partitions of unity of ``tests/test_bdpt.py``,
the render against the path tracer, and ``api.render``'s rules.

JAX's ``_bdpt_body`` runs eagerly (one run a scene and mode, shared by
the tests through module fixtures).  Tolerances: every lane's radiance
within rtol 1e-4, atol 1e-6 and the splat plane within rtol 1e-5, atol
1e-6 (the scatter-adds sum in another order); the MIS sums within rtol
1e-5; the partitions within rtol 1e-4 (``tests/test_bdpt.py``'s).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from light_transport_tpu.integrators import bdpt as jb
from light_transport_tpu.integrators.path_tracer import camera_rays as jcam
from light_transport_tpu.models import presets as jpresets
from light_transport_tpu.scene.cornell import cornell_box_scene as jcornell
from light_transport_tpu_torch import api
from light_transport_tpu_torch.integrators import bdpt as tb
from light_transport_tpu_torch.integrators import path_tracer as pt
from light_transport_tpu_torch.models import presets
from light_transport_tpu_torch.scene.cornell import cornell_box_scene
from light_transport_tpu_torch.scene.lights import sample_light_points
from light_transport_tpu_torch.utils import interop
from test_torch_analytic import jax_scene_tables
from test_torch_render import port_cfg

torch.set_num_threads(1)


def t(a):
    return torch.from_numpy(np.array(a, copy=True))


def mixed_jax_scene(depth):
    """``examples/point_light.py:51-68``'s mixed scene: the Cornell box
    with its panel and a point light at (0, 3, 0), I = 40."""
    js, jcfg = jcornell(width=4, height=4, spp=2, max_depth=depth)
    return js.with_point_lights([[0.0, 3.0, 0.0]], [[40.0, 40.0, 40.0]]), jcfg


SCENES = {
    "area": lambda: jcornell(width=4, height=4, spp=2, max_depth=3),
    "point": lambda: jpresets.point_light_scene(4, 4, 2, 2),
    "mixed": lambda: mixed_jax_scene(2),
}


def lanes_np(cfg, mode, seed):
    """A lanes dict's draws from numpy: the jitter, the walks' and the NEE
    uniforms, and the family's origin uniforms."""
    n = cfg.width * cfg.height * cfg.spp
    r = np.random.default_rng(seed)

    def f(*shape):
        return r.random(shape, dtype=np.float32)

    lanes = dict(u_aa=f(n, 2), cam_u=f(n, cfg.max_depth, 2),
                 light_u=f(n, cfg.max_depth, 2), ul=f(n, cfg.max_depth, 3))
    for name, k in tb.FAMILY_DRAWS[mode]:
        lanes[name] = f(n, k) if k > 1 else f(n)
    return lanes


@pytest.fixture(scope="module", params=sorted(SCENES))
def body(request):
    """JAX's ``_bdpt_body`` (eager) and the port's on the same lanes, with
    light tracing and, for the area family, without."""
    mode = request.param
    js, jcfg = SCENES[mode]()
    family, q = jb._light_family(js)
    assert family == mode
    draws = lanes_np(jcfg, mode, 14)
    o, d = jcam(js, jcfg, jnp.asarray(draws.pop("u_aa")))
    jl = {k: jnp.asarray(v) for k, v in draws.items()}
    jl.update(o=o, d=d, mask=jnp.ones(o.shape[0], bool))
    scene = interop.scene_from_numpy(jax_scene_tables(js), device="cpu")
    cfg = port_cfg(jcfg)
    tl = {k: t(v) for k, v in draws.items()}
    tl.update(o=t(o), d=t(d), mask=torch.ones(o.shape[0], dtype=torch.bool))
    runs = {}
    for lt in ((True, False) if mode == "area" else (True,)):
        want = jb._bdpt_body(js, jcfg, jl, None, lt, mode,
                             jnp.asarray(q, jnp.float32))
        got = tb._bdpt_body(scene, cfg, tl, None, lt, mode, q)
        runs[lt] = ([np.asarray(w) for w in want], [g.numpy() for g in got])
    return dict(mode=mode, js=js, scene=scene, cfg=cfg, lanes=tl, runs=runs)


def test_bdpt_body_matches_jax(body):
    for lt, ((want_rad, want_splat), (rad, splat)) in body["runs"].items():
        close = np.isclose(rad, want_rad, rtol=1e-4, atol=1e-6).all(axis=1)
        assert close.all(), (body["mode"], lt, np.nonzero(~close)[0])
        np.testing.assert_allclose(splat, want_splat, rtol=1e-5, atol=1e-6)
        assert rad.max() > 0.0
        assert (splat.max() > 0.0) == lt
    if body["mode"] == "area":
        # light tracing moves energy between the lanes and the splats
        rad_on, rad_off = body["runs"][True][1][0], body["runs"][False][1][0]
        assert not np.array_equal(rad_on, rad_off)
    # the mask gates the splats and nothing else
    lanes = dict(body["lanes"], mask=torch.zeros_like(body["lanes"]["mask"]))
    mode, q = tb._light_family(body["scene"])
    rad, splat = tb._bdpt_body(body["scene"], body["cfg"], lanes, None, True,
                               mode, q)
    assert not splat.any()
    np.testing.assert_array_equal(rad.numpy(), body["runs"][True][1][0])


def random_vertices(r, n, length, module):
    """A Vertices of random geometry and densities, some zero (delta)."""
    def f(*shape):
        return r.random(shape, dtype=np.float32)

    zero = f(n, length) < 0.3
    fields = dict(
        pos=4.0 * f(n, length, 3) - 2.0, ns=f(n, length, 3) - 0.5,
        diffuse=f(n, length, 3), beta=f(n, length, 3),
        pdf_fwd=np.where(zero, 0.0, f(n, length)).astype(np.float32),
        pdf_rev=np.where(f(n, length) < 0.3, 0.0,
                         f(n, length)).astype(np.float32),
        valid=f(n, length) < 0.9, is_light=f(n, length) < 0.2,
        is_delta=f(n, length) < 0.2, emit=f(n, length, 3),
        spec=np.where(f(n, length, 1) < 0.5, 0.0,
                      f(n, length, 3)).astype(np.float32),
        shin=8.0 * f(n, length), win=f(n, length, 3) - 0.5)
    for k in ("ns", "win"):
        fields[k] /= np.linalg.norm(fields[k], axis=-1, keepdims=True)
    if module is jb:
        return jb.Vertices(**{k: jnp.asarray(v) for k, v in fields.items()})
    return tb.Vertices(**{k: t(v) for k, v in fields.items()})


def test_mis_sums_match_jax():
    """``cam_side_mis`` at every junction, with and without light tracing
    and ``s1_ratio``; ``light_side_mis`` at every end, with ``skip_s0``,
    a per-lane delta origin and a per-lane NEE ratio."""
    # the fixtures' lane count and depth: JAX's eager ops are compiled
    n, length = 32, 3
    r = np.random.default_rng(9)
    jv, tv = (random_vertices(np.random.default_rng(2), n, length, m)
              for m in (jb, tb))
    dens = [r.random(n, dtype=np.float32) for _ in range(3)]
    dens[0][::5] = 0.0
    l0 = dict(pos=r.random((n, 3), dtype=np.float32) + 2.0,
              ns=np.tile(np.float32([0.0, -1.0, 0.0]), (n, 1)))
    od = r.random(n) < 0.4
    ratio = (1.0 + r.random(n)).astype(np.float32)
    for j in range(length):
        for lt in (True, False):
            for s1 in (None, 1.25):
                want = jb.cam_side_mis(jv, j, jnp.asarray(dens[0]),
                                       jnp.asarray(dens[1]), lt, s1)
                got = tb.cam_side_mis(tv, j, t(dens[0]), t(dens[1]), lt, s1)
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           rtol=1e-5)
    jl0 = {k: jnp.asarray(v) for k, v in l0.items()}
    tl0 = {k: t(v) for k, v in l0.items()}
    for end in range(1, length):
        for skip, delta, nee in ((False, False, 1.0), (True, False, 2.0),
                                 (False, od, ratio)):
            want = jb.light_side_mis(
                jv, jl0, 0.25, end, jnp.asarray(dens[2]),
                jnp.asarray(dens[0]), skip_s0=skip,
                origin_delta=jnp.asarray(delta),
                nee_pick_ratio=jnp.asarray(nee))
            per_lane = isinstance(delta, np.ndarray)
            got = tb.light_side_mis(
                tv, tl0, 0.25, end, t(dens[2]), t(dens[0]), skip_s0=skip,
                origin_delta=t(delta) if per_lane else delta,
                nee_pick_ratio=t(nee) if per_lane else nee)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5)


def camera_walk(cfg, scene, seed, depth):
    """64 camera lanes (8x8x1) and their camera subpaths, drawn from a
    generator; NEE points on the light from the same generator."""
    g = torch.Generator().manual_seed(seed)
    o, d = pt.camera_rays(scene, cfg, torch.rand((64, 2), generator=g))
    cam = tb.generate_camera_subpaths(
        scene, cfg, o, d, torch.rand((64, depth, 2), generator=g))
    ul = torch.rand((64, 3), generator=g)
    lp, ln, _, pdf_pos = sample_light_points(scene.lights, ul[:, 0],
                                             ul[:, 1], ul[:, 2])
    return cam, lp, ln, pdf_pos


def set_row(x, k, v):
    x = x.clone()
    x[:, k] = v
    return x


def fake_light_walk(cam, rows):
    """A Vertices like ``cam``, zero but for ``rows``: {index: (pos, ns,
    pdf_fwd, valid)}."""
    z = dict(pos=cam.pos * 0.0, ns=cam.ns * 0.0, pdf_fwd=cam.pdf_fwd * 0.0,
             valid=cam.valid & False)
    for k, (pos, ns, fwd, valid) in rows.items():
        z["pos"] = set_row(z["pos"], k, pos)
        z["ns"] = set_row(z["ns"], k, ns)
        z["pdf_fwd"] = set_row(z["pdf_fwd"], k, fwd)
        z["valid"] = set_row(z["valid"], k, valid)
    return tb.Vertices(
        diffuse=cam.diffuse * 0.0, beta=cam.beta * 0.0,
        pdf_rev=cam.pdf_rev * 0.0, is_light=cam.is_light & False,
        is_delta=cam.is_delta & False, emit=cam.emit * 0.0,
        spec=cam.spec * 0.0, shin=cam.shin * 0.0, win=cam.win * 0.0, **z)


def camera_area_pdf(scene, cfg, v1, ns1):
    dir_cp = (v1 - scene.camera) / torch.linalg.norm(
        v1 - scene.camera, dim=-1, keepdim=True)
    return tb._to_area(tb._camera_pdf_dir(scene, cfg, dir_cp),
                       scene.camera.expand_as(v1), v1, ns1)


@pytest.mark.parametrize("case", ["s1", "s2", "cap"])
def test_mis_partition_of_unity(case):
    """``tests/test_bdpt.py:109-452`` on the port: the balance-heuristic
    weights of every sampled strategy of one path sum to 1.  ``s1``: the
    2-segment path camera -> v1 -> L (s=1 t=2, s=0 t=3, s=2 t=1); ``s2``:
    camera -> v1 -> m -> L (s=2 t=2, s=1 t=3, s=0 t=4, s=3 t=1); ``cap``:
    that path at max_depth 2 (s=1 t=3, s=2 t=2, s=3 t=1, no s'=0)."""
    depth = {"s1": 2, "s2": 3, "cap": 2}[case]
    scene, cfg = cornell_box_scene(width=8, height=8, spp=1,
                                   max_depth=depth, include_cone=False,
                                   device="cpu")
    cam, lp, ln, pdf_pos = camera_walk(cfg, scene, 7 + depth, depth)
    pdf_light = 1.0 / float(scene.lights.total_area)
    zeros = torch.zeros(64)
    v1, ns1 = cam.pos[:, 0], cam.ns[:, 0]
    cam_v1 = camera_area_pdf(scene, cfg, v1, ns1)
    l0 = dict(pos=lp, ns=ln)
    if case == "s1":
        usable = cam.valid[:, 0] & ~cam.is_delta[:, 0] & ~cam.is_light[:, 0]
        qs_rev = tb._diffuse_pdf_area(ns1, v1, lp, ln)  # v1 -> L
        pt_rev = tb._diffuse_pdf_area(ln, lp, v1, ns1)  # L emits -> v1
        w_a = 1.0 / (1.0 + tb.cam_side_mis(cam, 0, pt_rev, zeros, True)
                     + tb._remap(qs_rev) / tb._remap(pdf_pos))
        cam_b = cam._replace(
            pos=set_row(cam.pos, 1, lp), ns=set_row(cam.ns, 1, ln),
            pdf_fwd=set_row(cam.pdf_fwd, 1, qs_rev),
            valid=set_row(cam.valid, 1, cam.valid[:, 0]),
            is_delta=set_row(cam.is_delta, 1, False))
        w_b = 1.0 / (1.0 + tb.cam_side_mis(cam_b, 1, pdf_light, pt_rev,
                                           True))
        lv = fake_light_walk(cam, {0: (v1, ns1, pt_rev, cam.valid[:, 0])})
        w_c = 1.0 / (1.0 + tb.light_side_mis(lv, l0, pdf_light, 1, cam_v1,
                                             qs_rev))
        total = w_a + w_b + w_c
        assert int(usable.sum()) > 24
    else:
        m, nsm = cam.pos[:, 1], cam.ns[:, 1]
        usable = (cam.valid[:, 0] & cam.valid[:, 1] & ~cam.is_delta[:, 0]
                  & ~cam.is_delta[:, 1] & ~cam.is_light[:, 0]
                  & ~cam.is_light[:, 1])
        p_m = cam.pdf_fwd[:, 1]
        # at depth 2 the walk never records pdf_rev[0]: the closed form
        p_mv1 = (cam.pdf_rev[:, 0] if case == "s2"
                 else tb._diffuse_pdf_area(nsm, m, v1, ns1))
        p_ml = tb._diffuse_pdf_area(nsm, m, lp, ln)
        p_lm = tb._diffuse_pdf_area(ln, lp, m, nsm)
        cap = case == "cap"
        lv_a = fake_light_walk(cam, {0: (m, nsm, p_lm, cam.valid[:, 1])})
        w_a = 1.0 / (1.0 + tb.cam_side_mis(cam, 0, p_mv1, zeros, True)
                     + tb.light_side_mis(lv_a, l0, pdf_light, 1, p_m, p_ml,
                                         skip_s0=cap))
        denom_b = tb.cam_side_mis(cam, 1, p_lm, p_mv1, True)
        if not cap:
            denom_b = denom_b + tb._remap(p_ml) / tb._remap(pdf_pos)
        w_b = 1.0 / (1.0 + denom_b)
        lv_d = fake_light_walk(cam, {0: (m, nsm, p_lm, cam.valid[:, 1]),
                                     1: (v1, ns1, p_mv1, cam.valid[:, 1])})
        w_d = 1.0 / (1.0 + tb.light_side_mis(lv_d, l0, pdf_light, 2, cam_v1,
                                             p_m, skip_s0=cap))
        total = w_a + w_b + w_d
        if not cap:
            cam_c = cam._replace(
                pos=set_row(cam.pos, 2, lp), ns=set_row(cam.ns, 2, ln),
                pdf_fwd=set_row(cam.pdf_fwd, 2, p_ml),
                valid=set_row(cam.valid, 2, cam.valid[:, 1]),
                is_delta=set_row(cam.is_delta, 2, False))
            total = total + 1.0 / (1.0 + tb.cam_side_mis(
                cam_c, 2, pdf_light, p_lm, True))
        assert int(usable.sum()) > 20
    np.testing.assert_allclose(total[usable].numpy(), 1.0, rtol=1e-4)


def test_light_families_and_their_walks():
    """Area-only, point-only and mixed scenes pick the JAX package's family
    and probability (the mixed one clamped into [0.05, 0.95]); each
    family's walk from a generator is its walk from the same draws, and
    the area walk starts on the ceiling panel with ``Le * A * pi``
    (``tests/test_bdpt.py``'s subpath checks)."""
    cases = {
        "area": jcornell(width=4, height=4, spp=1, max_depth=2)[0],
        "point": jpresets.point_light_scene(4, 4, 1, 2)[0],
        "mixed": mixed_jax_scene(2)[0],
        "mixed, clamped": jcornell(width=4, height=4, spp=1, max_depth=2)[
            0].with_point_lights([[0.0, 3.0, 0.0]], [[1e4, 1e4, 1e4]]),
    }
    walks = {"area": (tb.generate_light_subpaths, tb._light_subpaths_area),
             "point": (tb.generate_light_subpaths_point,
                       tb._light_subpaths_point),
             "mixed": (tb.generate_light_subpaths_mixed,
                       tb._light_subpaths_mixed)}
    cfg = dataclasses.replace(port_cfg(jcornell(width=4, height=4)[1]),
                              max_depth=2)
    uni = torch.rand((64, 2, 2), generator=torch.Generator().manual_seed(1))
    for name, js in cases.items():
        scene = interop.scene_from_numpy(jax_scene_tables(js), device="cpu")
        want = jb._light_family(js)
        family, q = tb._light_family(scene)
        assert family == want[0] == name.split(",")[0], name
        assert q == pytest.approx(want[1], rel=1e-12), name
        drawn, taking = walks[family]
        extra = (q,) if family == "mixed" else ()
        got = drawn(scene, cfg, torch.Generator().manual_seed(5), 64, uni,
                    *extra)
        draws = tb._origin_draws(torch.Generator().manual_seed(5), 64,
                                 family, torch.float32)
        same = taking(scene, cfg, *draws.values(), uni, *extra)
        for a, b in zip(got[0], same[0]):
            assert torch.equal(a, b), name
        if name == "area":
            lv, l0 = got
            assert torch.allclose(l0["pos"][:, 1], torch.tensor(7.5),
                                  atol=1e-4)
            ok = lv.valid[:, 0]
            assert float(ok.double().mean()) > 0.6
            torch.testing.assert_close(
                lv.beta[:, 0][ok], torch.full_like(lv.beta[:, 0][ok],
                                                   800.0 * np.pi), rtol=1e-4,
                atol=0.0)
    assert q == 0.95


def test_render_bdpt_against_the_path_tracer():
    """On the cone-free Cornell box both estimators are unbiased: the
    image means agree within 3 sigma of the per-pixel sample spread, with
    light tracing and without; the render is a function of its seed."""
    scene, cfg = cornell_box_scene(width=12, height=12, spp=16, max_depth=3,
                                   include_cone=False, device="cpu")
    img_pt, samples = pt.render_image(scene, cfg, 0, return_samples=True)
    sigma = float(samples.mean(dim=-1).std()) / samples[..., 0].numel() ** 0.5
    for lt in (True, False):
        img = tb.render_bdpt(scene, cfg, seed=1, light_tracing=lt)
        assert torch.isfinite(img).all() and img.shape == (12, 12, 3)
        diff = abs(float(img.mean()) - float(img_pt.mean()))
        assert diff < 3.0 * sigma, (lt, diff, sigma)
    assert torch.equal(img, tb.render_bdpt(scene, cfg, seed=1,
                                           light_tracing=False))
    assert not torch.equal(img, tb.render_bdpt(scene, cfg, seed=2,
                                               light_tracing=False))


def test_api_render_bdpt():
    scene, cfg = presets.point_light_scene(6, 6, 2, 2, device="cpu")
    img = api.render(scene, cfg, seed=3, integrator="bdpt")
    assert img.shape == (6, 6, 3) and torch.isfinite(img).all()
    assert torch.equal(img, tb.render_bdpt(scene, cfg, 3))
    assert float(img.mean()) > 0.0
    for change in (dict(aperture=0.1), dict(sampler="sobol"),
                   dict(emission_mode="mis", nee_mode="all")):
        with pytest.raises(ValueError):
            api.render(scene, dataclasses.replace(cfg, **change),
                       integrator="bdpt")

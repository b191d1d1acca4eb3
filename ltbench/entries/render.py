"""Camera frames through ``light_transport_tpu_torch.api.render``: a job
is one frame of the configuration's scene at the traffic's settings.

The scene is built from the configuration's arrays with the program's
own builders (``TriangleMesh.build``, ``MaterialTable.build``,
``Scene.build(...).with_bvh()``, treelet tables included where the
program attaches them).  The output check works sampled pixels of
sampled frames out again with the configuration's reference and compares
them with the program's, by each pixel's gap (its largest channel
difference): ``pixels_off``, the share of the pixels whose gap passes one
8-bit level (1/255), and ``gap_p95``, the 95th percentile of the gaps.
A path whose hit lands on the other side of a triangle edge in the two
intersectors' rounding moves its pixel by up to its whole contribution;
such pixels are rare (at most 1 in 1,024 on the card), and both numbers
stand firm against them, where a mean would not."""

from __future__ import annotations

import time

import torch

from ltbench.scene import scene_arrays, render_settings

OFF_LEVEL = 1.0 / 255.0


def _material(m: dict):
    from light_transport_tpu_torch.scene.material import Color, Material

    kw = {k: (tuple(v) if isinstance(v, list) else v) for k, v in m.items()
          if k not in ("name", "ambient", "diffuse", "specular")}
    return Material(color=Color.of(m["ambient"], m["diffuse"],
                                   m["specular"]), **kw)


class Session:
    """The program's side of a render cell."""

    def __init__(self, registry, config: dict, traffic: dict, device):
        from light_transport_tpu_torch import api
        from light_transport_tpu_torch.core.config import RenderConfig
        from light_transport_tpu_torch.scene.geometry import TriangleMesh
        from light_transport_tpu_torch.scene.material import MaterialTable
        from light_transport_tpu_torch.scene.scene import Scene

        self.api = api
        self.registry = registry
        self.config = config
        self.device = torch.device(device)
        self.arrays = scene_arrays(registry, config)
        self.render = render_settings(config, traffic)
        self.integrator = traffic["integrator"]
        a = self.arrays
        t0 = time.perf_counter()
        mesh = TriangleMesh.build(a.vertices, a.mat_id, a.is_light,
                                  device=self.device)
        mats = MaterialTable.build([_material(m) for m in a.materials],
                                   device=self.device)
        self.scene = Scene.build(mesh, mats, camera=a.camera).with_bvh()
        self._sync()
        self.scene_build_s = time.perf_counter() - t0
        self.num_triangles = mesh.num_triangles
        self.cfg = RenderConfig(**self.render)
        r = self.render
        self.pixels = int(r["width"]) * int(r["height"])
        self.samples_per_job = self.pixels * int(r["spp"])

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def job(self, seed: int):
        # the module attribute, looked up at each call: a traced run wraps it
        return self.api.render(self.scene, self.cfg, seed=seed,
                               integrator=self.integrator)

    def pick(self, frame, ids):
        """The checked pixels of a frame, ``(P, 3)`` on the device."""
        return frame.reshape(-1, 3).index_select(0, ids)

    def release(self):
        """Drop the program's scene and tables."""
        self.scene = None

    # --- the output check --------------------------------------------------
    def reference_pixels(self, frame_seeds, pixel_ids, dtype=torch.float32):
        """``(F, P, 3)`` float32 pixels of the configuration's reference,
        computed in ``dtype``, on the device."""
        ref = self.registry.module("reference", self.config["reference"])
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        scene = ref.build(self.arrays, self.device, dtype=dtype)
        return torch.stack([ref.render_pixels(scene, self.render, s,
                                              pixel_ids)
                            for s in frame_seeds])

    @staticmethod
    def compare(got, want) -> dict:
        """The numbers compared: got and want ``(F, P, 3)``; a channel
        that is not finite counts as off by 1."""
        diff = (got.float() - want.float()).abs()
        gap = torch.where(torch.isfinite(diff), diff, 1.0).amax(-1)
        return {"pixels_off": float((gap > OFF_LEVEL).float().mean()),
                "gap_p95": float(torch.quantile(gap.reshape(-1).cpu(),
                                                0.95))}

    @staticmethod
    def failed(got) -> int:
        """Jobs whose checked pixels are not all finite: ``got`` (J, P, 3)."""
        return int((~torch.isfinite(got).reshape(got.shape[0], -1)
                    .all(dim=1)).sum())

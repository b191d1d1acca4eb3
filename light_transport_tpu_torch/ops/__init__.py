from light_transport_tpu_torch.ops.intersect import (  # noqa: F401
    Hit,
    intersect_rays,
    occluded,
    plane_intersect,
    sphere_intersect,
    aabb_intersect,
)

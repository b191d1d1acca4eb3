from light_transport_tpu_torch.accel.bvh import (  # noqa: F401
    BVH,
    build,
    intersect_bvh,
    occluded_bvh,
)

from light_transport_tpu_torch.integrators.adaptive import (  # noqa: F401
    render_adaptive,
)
from light_transport_tpu_torch.integrators.path_tracer import (  # noqa: F401
    camera_rays,
    render_image,
    trace_paths,
)

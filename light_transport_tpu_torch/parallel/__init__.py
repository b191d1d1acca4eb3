"""Sharded photon runs and renders (``parallel.mesh``)."""

from light_transport_tpu_torch.parallel.mesh import (  # noqa: F401
    make_mesh,
    render_bdpt_sharded,
    render_sharded,
    simulate_sharded,
)

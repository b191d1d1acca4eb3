"""light_transport_tpu_torch — the PyTorch/CUDA port of light_transport_tpu.

Photon transport (layered media, the MCML superstep engine in plain
torch, ``simulate``, and the fused photon block as a hand-written CUDA
kernel for Hopper, ``ops.photon_kernel.simulate_kernel``) and the camera
render (``render``: the NEE path tracer, the adaptive, Whitted and BDPT
integrators, and ``integrators.control_variates``, over the
cluster-culled intersector's CUDA kernels in ``ops.intersect_kernel`` and
the treelet walks of ``ops.treelet_kernel``).  ``parallel.mesh`` shards
both over devices and processes; ``cli`` and ``gui`` are the front ends.
Every kernel has its plain PyTorch version, which runs for tensors on the
CPU.  Constructors and entry points build on the card unless given
``device="cpu"``.
"""

__version__ = "0.1.0"

from light_transport_tpu_torch.api import render, simulate  # noqa: F401

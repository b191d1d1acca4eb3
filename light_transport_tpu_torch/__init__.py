"""light_transport_tpu_torch — the PyTorch/CUDA port of light_transport_tpu.

Two slices: photon transport (layered media, the MCML superstep engine in
plain torch, ``simulate``, and the fused photon block as a hand-written
CUDA kernel for Hopper, ``ops.photon_kernel.simulate_kernel``) and the
camera render (the NEE path tracer, ``render``, over the cluster-culled
intersector whose two CUDA kernels are in ``ops.intersect_kernel``).
``parallel.mesh`` shards both over devices and processes.
Every kernel has its plain PyTorch version, which runs for tensors on the
CPU.  Constructors and entry points build on the card unless given
``device="cpu"``.
"""

__version__ = "0.1.0"

from light_transport_tpu_torch.api import render, simulate  # noqa: F401

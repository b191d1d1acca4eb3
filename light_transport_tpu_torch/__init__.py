"""light_transport_tpu_torch — the PyTorch/CUDA port of light_transport_tpu.

The photon-transport slice: layered media, the MCML superstep engine in
plain torch (``simulate``), and the fused photon block as a hand-written
CUDA kernel for Hopper (``ops.photon_kernel.simulate_kernel``), with its
plain PyTorch version for tensors on the CPU.
"""

__version__ = "0.1.0"

from light_transport_tpu_torch.api import simulate  # noqa: F401

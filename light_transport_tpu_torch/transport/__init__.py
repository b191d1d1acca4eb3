from light_transport_tpu_torch.transport.photon import (  # noqa: F401
    PhotonState,
    run_fixed_steps,
    simulate_photons,
    superstep,
)

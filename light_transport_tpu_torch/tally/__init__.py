from light_transport_tpu_torch.tally.tallies import PhotonTallies  # noqa: F401
from light_transport_tpu_torch.tally.stats import (  # noqa: F401
    chi2_counts,
    image_mae,
    mc_parity_3sigma,
)

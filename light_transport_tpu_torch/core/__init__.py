from light_transport_tpu_torch.core import config, math, rng  # noqa: F401

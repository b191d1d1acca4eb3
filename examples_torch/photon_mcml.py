"""Photon Monte Carlo in layered media (MCML-style hop-drop-spin), the port
of examples/photon_mcml.py.

Runs the three validation media whose diffuse reflectance and
transmittance have published golden values through ``api.simulate`` (the
superstep engine), then a fluence map:

- van de Hulst semi-infinite slab (a=0.9, g=0):      R_d = 0.41550
- MCML finite slab (d=0.02cm, mu_a=10, mu_s=90, g=0.75):
                                      R_d = 0.09739, T_t = 0.66096
- Giovanelli mismatched boundary (n=1.5, a=0.9):     R_total = 0.26

Each run is held to its golden values within 3 binomial standard errors
plus ``tests/test_photon.py``'s floors; a run off its values raises.
"""

import numpy as np

from _torch_common import OUT_DIR, parse_args, report, save_image, timer

from light_transport_tpu_torch.api import simulate
from light_transport_tpu_torch.core.config import (
    MediumConfig,
    PhotonRunConfig,
)
from light_transport_tpu_torch.scene.medium import LayeredMedium
from light_transport_tpu_torch.tally.stats import (
    binomial_stderr,
    mc_parity_3sigma,
)

N = 1_000_000
CASES = (
    ("van_de_hulst", [MediumConfig(mu_a=1.0, mu_s=9.0, g=0.0, n=1.0)],
     {"R_d": 0.41550}),
    ("mcml_slab",
     [MediumConfig(mu_a=10.0, mu_s=90.0, g=0.75, n=1.0, thickness=0.02)],
     {"R_d": 0.09739, "T_t": 0.66096}),
    ("giovanelli", [MediumConfig(mu_a=1.0, mu_s=9.0, g=0.0, n=1.5)],
     {"R_total": 0.26}),
)
# the absolute floors of tests/test_photon.py's golden-value checks
FLOORS = {"R_d": 1e-3, "T_t": 2e-3, "R_total": 2e-3}


def check_golden(name, measured, golden, n_photons):
    """Raise unless every golden value is within 3 binomial standard
    errors at ``n_photons`` plus its floor."""
    for key, want in golden.items():
        se = binomial_stderr(want, n_photons)
        if not mc_parity_3sigma(measured[key], want, se,
                                abs_floor=FLOORS[key]):
            raise RuntimeError(
                f"photon_{name}: {key} = {measured[key]:.5f} is off its "
                f"golden value {want} by more than 3 x {se:.3g} + "
                f"{FLOORS[key]}")


def run(n_photons=N, fluence_grid=(256, 256), seed=0, fluence_seed=1,
        device="cuda", out_dir=OUT_DIR):
    lines = []
    for name, layers, golden in CASES:
        medium = LayeredMedium.build(layers, device=device)
        with timer() as t:
            res = simulate(medium, PhotonRunConfig(n_photons=n_photons),
                           seed=seed)
        r_d = float(res.total_reflectance())
        measured = {"R_d": r_d, "T_t": float(res.total_transmittance()),
                    "R_total": r_d + res.specular_reflectance()}
        lines.append(report(
            f"photon_{name}", t.seconds, n_photons=n_photons,
            **{k: round(v, 5) for k, v in measured.items()}, golden=golden))
        check_golden(name, measured, golden, n_photons)

    # fluence map of a tissue-like medium (the full_scale preset's medium
    # on a smaller grid)
    medium = LayeredMedium.build(
        [MediumConfig(mu_a=0.5, mu_s=50.0, g=0.9, n=1.37)], device=device)
    nr, nz = fluence_grid
    cfg = PhotonRunConfig(n_photons=n_photons, nr=nr, nz=nz, dr=0.005,
                          dz=0.005)
    with timer() as t:
        res = simulate(medium, cfg, seed=fluence_seed)
    flu = np.asarray(res.fluence_rz(cfg))
    # an all-zero or constant grid gives a black image, not a crash
    floor = flu[flu > 0].min() if np.any(flu > 0) else 1.0
    img = np.log10(np.maximum(flu, floor)).T
    span = img.max() - img.min()
    img = (img - img.min()) / (span if span > 0 else 1.0)
    p = save_image(np.repeat(img[:, :, None], 3, axis=2),
                   "photon_fluence.png", out_dir=out_dir)
    lines.append(report("photon_fluence", t.seconds, n_photons=n_photons,
                        grid=[cfg.nr, cfg.nz], image=p))
    return lines


def main(argv=None):
    args = parse_args(argv, __doc__)
    return run(device=args.device, out_dir=args.out_dir)


if __name__ == "__main__":
    main()

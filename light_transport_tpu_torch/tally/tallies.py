"""Detector tallies for the photon engines.

MCML-style detectors: radial diffuse reflectance/transmittance, an (r, z)
absorption grid, a 3-D cartesian absorption volume, a cartesian exit
detector image and the launch specular reflectance.

Counters (photons launched, lane steps) are exact int64 counts.  The
scalar weights (``specular``, ``absorbed``) and the exit-by-radius tables
are float64: they are folded from thousands of per-tile partials per
block, and energy closure is read from them.  The spatial grids stay
float32.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from light_transport_tpu_torch.core.config import PhotonRunConfig


@dataclasses.dataclass
class PhotonTallies:
    """Raw (unnormalized) accumulated photon weight.

    Normalization follows MCML conventions: divide by photons launched
    (and cell volume for fluence).  The last radial bin is an overflow bin.
    """

    refl_r: torch.Tensor  # (nr,) f64 diffuse reflectance weight by radius
    trans_r: torch.Tensor  # (nr,) f64 transmittance weight by exit radius
    absorb_rz: torch.Tensor  # (nr, nz) f32 absorbed weight
    specular: torch.Tensor  # () f64 specular reflectance weight at launch
    launched: torch.Tensor  # () int64 photons launched
    steps: torch.Tensor  # () int64 lane events processed
    # cartesian exit-detector image over the top surface; (nx, nx), or
    # (1, 1) when disabled
    detector_xy: torch.Tensor
    # 3-D cartesian absorbed-weight volume; (vol_nx, vol_ny, vol_nz), or
    # (1, 1, 1) when disabled
    absorb_xyz: torch.Tensor
    # scalar absorbed weight (f64): the grids lose tiny increments to f32
    # swamping in hot cells, so energy accounting reads this one
    absorbed: torch.Tensor  # () f64

    @staticmethod
    def zeros(cfg: PhotonRunConfig, device="cpu") -> "PhotonTallies":
        nx = max(cfg.detector_nx, 1)
        vshape = (max(cfg.vol_nx, 1), max(cfg.vol_ny, 1), max(cfg.vol_nz, 1))
        f32, f64, i64 = torch.float32, torch.float64, torch.int64
        return PhotonTallies(
            refl_r=torch.zeros((cfg.nr,), dtype=f64, device=device),
            trans_r=torch.zeros((cfg.nr,), dtype=f64, device=device),
            absorb_rz=torch.zeros((cfg.nr, cfg.nz), dtype=f32, device=device),
            specular=torch.zeros((), dtype=f64, device=device),
            launched=torch.zeros((), dtype=i64, device=device),
            steps=torch.zeros((), dtype=i64, device=device),
            detector_xy=torch.zeros((nx, nx), dtype=f32, device=device),
            absorb_xyz=torch.zeros(vshape, dtype=f32, device=device),
            absorbed=torch.zeros((), dtype=f64, device=device),
        )

    def merge(self, other: "PhotonTallies") -> "PhotonTallies":
        """Combine two tally sets (every field adds)."""
        return PhotonTallies(**{
            f.name: getattr(self, f.name) + getattr(other, f.name)
            for f in dataclasses.fields(self)})

    # --- exact counter views -------------------------------------------------

    @property
    def n_launched(self) -> int:
        return int(self.launched)

    @property
    def n_steps(self) -> int:
        return int(self.steps)

    # --- normalized views (host-side convenience) ---------------------------

    def total_reflectance(self) -> float:
        """Diffuse reflectance R_d per launched photon."""
        return float(self.refl_r.sum()) / max(self.n_launched, 1)

    def total_transmittance(self) -> float:
        return float(self.trans_r.sum()) / max(self.n_launched, 1)

    def total_absorption(self) -> float:
        return float(self.absorbed) / max(self.n_launched, 1)

    def total_absorption_grid(self) -> float:
        """Grid-summed absorption (cross-check of the spatial tally)."""
        return float(self.absorb_rz.double().sum()) / max(self.n_launched, 1)

    def specular_reflectance(self) -> float:
        return float(self.specular) / max(self.n_launched, 1)

    def energy_total(self) -> float:
        """R_sp + R_d + A + T — 1 in expectation."""
        return (
            self.specular_reflectance()
            + self.total_reflectance()
            + self.total_absorption()
            + self.total_transmittance()
        )

    def fluence_rz(self, cfg: PhotonRunConfig, mu_a_grid=None) -> np.ndarray:
        """Fluence phi(r, z) = A_rz / (dV * N * mu_a)  [1/cm^2 per photon].

        ``mu_a_grid``: (nz,) absorption coefficient per depth bin (None
        returns A_rz / (dV * N), the absorbed energy density).
        """
        ir = np.arange(cfg.nr)
        # annular cell volume: 2 pi (ir + 0.5) dr^2 dz
        dv = 2.0 * np.pi * (ir + 0.5) * cfg.dr**2 * cfg.dz
        a = self.absorb_rz.cpu().numpy().astype(np.float64)
        n = max(self.n_launched, 1)
        dens = a / (dv[:, None] * n)
        if mu_a_grid is not None:
            dens = dens / np.maximum(np.asarray(mu_a_grid)[None, :], 1e-12)
        return dens

    def fluence_xyz(self, cfg: PhotonRunConfig, mu_a: float = None) -> np.ndarray:
        """3-D fluence phi(x, y, z) = A_xyz / (dV * N * mu_a) [1/cm^2/photon]
        (absorbed energy density when ``mu_a`` is None)."""
        dv = cfg.vol_dx * cfg.vol_dy * cfg.vol_dz
        n = max(self.n_launched, 1)
        dens = self.absorb_xyz.cpu().numpy().astype(np.float64) / (dv * n)
        if mu_a is not None:
            dens = dens / max(mu_a, 1e-12)
        return dens

    def reflectance_r(self, cfg: PhotonRunConfig) -> np.ndarray:
        """R_d(r) per unit area [1/cm^2]."""
        ir = np.arange(cfg.nr)
        da = 2.0 * np.pi * (ir + 0.5) * cfg.dr**2
        n = max(self.n_launched, 1)
        return self.refl_r.cpu().numpy() / (da * n)

"""Typed configuration objects.

Field names and defaults equal ``light_transport_tpu.core.config`` so a
configuration means the same run in both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Camera-render settings; the screen bounds derive from the aspect
    ratio.  The port renders every value but ``compact_tail=True``, which
    raises at render time."""

    width: int = 150
    height: int = 150
    spp: int = 12
    max_depth: int = 4
    f_distance: float = 5.0
    # Russian roulette starts after this bounce
    rr_start: int = 3
    rr_floor: float = 0.05
    # 'first_hit' | 'always' | 'nee' | 'mis' (see path_tracer._bounce)
    emission_mode: str = "first_hit"
    # 'one': one shadow ray to a random area-weighted light point;
    # 'all': one shadow ray per light triangle at its centroid
    nee_mode: str = "one"
    # 'opaque': any surface blocks a shadow ray; 'transmittance': glass
    # attenuates it (ops.dispatch.scene_transmittance)
    shadow_mode: str = "opaque"
    # 'stochastic': one Fresnel branch sampled per transmissive hit;
    # 'split': both followed (path_tracer.trace_paths_split)
    fresnel_mode: str = "stochastic"
    # 'uniform': torch.Generator draws; 'sobol': ops.qmc's scrambled points
    sampler: str = "uniform"
    compact_tail: bool = False
    # thin-lens radius (0: a pinhole) and focus distance (0 or less: the
    # screen plane)
    aperture: float = 0.0
    focus_distance: float = 0.0
    seed: int = 0

    @property
    def aspect_ratio(self) -> float:
        return self.width / self.height

    @property
    def screen_bounds(self) -> Tuple[float, float, float, float]:
        """(left, right, top, bottom)."""
        ar = self.aspect_ratio
        return (-1.0, 1.0, 1.0 / ar, -1.0 / ar)


@dataclasses.dataclass(frozen=True)
class MediumConfig:
    """One homogeneous layer of a participating medium (MCML convention).

    mu_a, mu_s in 1/cm; g = Henyey-Greenstein anisotropy; n = refractive
    index.
    """

    mu_a: float = 0.1
    mu_s: float = 10.0
    g: float = 0.9
    n: float = 1.0
    thickness: float = float("inf")  # cm


@dataclasses.dataclass(frozen=True)
class PhotonRunConfig:
    """Photon Monte Carlo run settings."""

    n_photons: int = 100_000
    # supersteps per round of simulate_photons: the termination check runs
    # between rounds only
    steps_per_batch: int = 16
    weight_threshold: float = 1e-4
    rr_survive: float = 0.1  # MCML roulette survival probability
    # fluence grid (r, z) in cm
    nr: int = 64
    nz: int = 64
    dr: float = 0.01
    dz: float = 0.01
    # optional cartesian exit-detector image above the surface; 0 disables it
    detector_nx: int = 0
    detector_extent: float = 1.0  # half-extent in cm
    # optional 3-D cartesian absorption volume; 0 disables it.  x/y centered
    # on the beam axis, z from the surface down; out-of-volume deposits clip
    # into edge cells (as the (r, z) grid's overflow bins do)
    vol_nx: int = 0
    vol_ny: int = 0
    vol_nz: int = 0
    vol_dx: float = 0.01
    vol_dy: float = 0.01
    vol_dz: float = 0.01
    # kernel-engine spatial-tally stride: the (r,z)/volume grids take every
    # Nth superstep's deposit, scaled by N (unbiased stratified thinning).
    # Exits, the absorbed scalar and all counters stay exact every step.
    # 1 = deposit every step (the MCML convention; the superstep engine
    # always deposits every step)
    tally_stride: int = 1
    # separate stride for the 3-D volume deposits (0 = same as tally_stride)
    vol_stride: int = 0
    # kernel engine: respawn roulette/absorption-dead lanes against the
    # launch quota every N stride windows instead of only at block start
    # (0 = block start only).  Lanes that died by exit wait for the next
    # block.  Requires tally_stride >= 2.
    respawn_windows: int = 0
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class MeshTopology:
    """Device-mesh description for sharded runs (``parallel.mesh``).

    Only data parallelism is needed for Monte Carlo transport: photon and
    pixel batches shard over ``batch_axis``; the scene and medium tables
    are replicated; tallies are summed over the shards.
    """

    batch_axis: str = "batch"
    n_devices: Optional[int] = None  # None = every device of the process

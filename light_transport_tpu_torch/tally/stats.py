"""Statistical parity utilities.

Generalizes the reference's only quantitative check — the image-MAE
cross-validation between two estimators (LTS.ipynb cells 37-38:
``np.mean(np.abs(image - image_ver1))``) — into reusable chi-squared / 3-sigma
Monte Carlo parity tests (SURVEY.md §4).
"""

from __future__ import annotations

import numpy as np


def image_mae(a, b) -> float:
    """The reference's estimator cross-check metric (LTS.ipynb cell 37)."""
    return float(np.mean(np.abs(np.asarray(a) - np.asarray(b))))


def chi2_counts(counts, expected, min_expected: float = 10.0):
    """Pearson chi-squared over bins with sufficient expectation.

    Returns ``(chi2, dof)``; a healthy sampler satisfies
    chi2 < dof + k*sqrt(2 dof) for small k.
    """
    counts = np.asarray(counts, np.float64)
    expected = np.asarray(expected, np.float64)
    mask = expected >= min_expected
    if int(mask.sum()) < 2:
        raise ValueError(
            f"chi2_counts: only {int(mask.sum())} bin(s) have expected >= "
            f"{min_expected} — too few for a chi-squared test (the "
            f"documented dof bound would be NaN or unsatisfiable)")
    chi2 = float(np.sum((counts[mask] - expected[mask]) ** 2 / expected[mask]))
    dof = int(mask.sum()) - 1
    return chi2, dof


def mc_parity_3sigma(estimate, truth, std_err, sigmas: float = 3.0,
                     abs_floor: float = 0.0):
    """True when |estimate - truth| <= sigmas * std_err + abs_floor."""
    return bool(
        abs(float(estimate) - float(truth))
        <= sigmas * float(std_err) + abs_floor
    )


def binomial_stderr(p_hat: float, n: float) -> float:
    """Standard error of a per-photon probability estimated from n photons.

    The estimate is floored at 1/n (one event), not a fixed tiny constant:
    with zero observed events the plug-in sqrt(p(1-p)/n) collapses to ~0
    and a 3-sigma parity test would spuriously reject rare-event truths
    that are statistically consistent with seeing nothing."""
    n = max(float(n), 1.0)
    p = min(max(float(p_hat), 1.0 / n), 1.0 - 1.0 / n)
    return float(np.sqrt(p * (1 - p) / n))

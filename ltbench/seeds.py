"""Seeds of a run's parts, all from ``--seed``: each (seed, part, index)
gives its own 63-bit generator seed, so warm-up, timed and traced frames
never share a stream, and the same ``--seed`` gives the same frames."""

from __future__ import annotations

import numpy as np

WARMUP, JOB, TRACE, SAMPLE = 1, 2, 3, 4


def part_seed(seed: int, part: int, index: int = 0) -> int:
    state = np.random.SeedSequence([int(seed) & 0xFFFFFFFFFFFFFFFF, part,
                                    int(index)])
    return int(state.generate_state(1, np.uint64)[0]) & 0x7FFFFFFFFFFFFFFF


def rng(seed: int, part: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence(
        [int(seed) & 0xFFFFFFFFFFFFFFFF, part]))

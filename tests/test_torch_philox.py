"""The photon kernel's Philox4x32-10 stream in plain form: the generator
against Random123's known answers, the draw layout of
``philox_uniforms``, and the kernel's group schedule.

``csrc/photon_kernel.cu`` draws uniform ``d`` of lane ``l`` as word
``d & 3`` of the Philox group at counter ``(l, block, d >> 2, 0)``.  Its
step loop dispatches on the word offset ``(n_phase + s) & 3`` and keeps
the groups a step does not use up for the next, evaluating them in pairs;
``_kernel_schedule`` below mirrors that loop.  The card holds the kernel
itself against ``philox_uniforms`` bit for bit (``chip_smoke.py`` phase
3).  Plain Python and torch only: no JAX.
"""

import numpy as np
import pytest
import torch

from light_transport_tpu_torch.core.config import PhotonRunConfig
from light_transport_tpu_torch.models.presets import full_scale
from light_transport_tpu_torch.ops import photon_kernel as pk

M32 = 0xFFFFFFFF

# Random123's known-answer vectors for philox4x32-10: counter, key, output
KNOWN_ANSWERS = {
    "zeros": ((0, 0, 0, 0), (0, 0),
              (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    "ones": ((M32, M32, M32, M32), (M32, M32),
             (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    "pi": ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
           (0xA4093822, 0x299F31D0),
           (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
}


def _philox_scalar(ctr, key):
    """Philox4x32-10 on Python ints, written from Random123's round."""
    c0, c1, c2, c3 = ctr
    k0, k1 = key
    for _ in range(10):
        p0, p1 = 0xD2511F53 * c0, 0xCD9E8D57 * c2
        c0, c1, c2, c3 = ((p1 >> 32) ^ c1 ^ k0, p1 & M32,
                          (p0 >> 32) ^ c3 ^ k1, p0 & M32)
        k0, k1 = (k0 + 0x9E3779B9) & M32, (k1 + 0xBB67AE85) & M32
    return c0, c1, c2, c3


@pytest.mark.parametrize("name", sorted(KNOWN_ANSWERS))
def test_philox_known_answers(name):
    ctr, key, want = KNOWN_ANSWERS[name]
    assert _philox_scalar(ctr, key) == want
    got = pk.philox4x32_10(
        tuple(torch.tensor([c], dtype=torch.int64) for c in ctr), key)
    assert tuple(int(w) for w in got) == want


def _plans():
    """A small plan of each phase count: bench (0), quota (1), quota with
    a separate volume phase (2)."""
    m, cfg = full_scale("cpu")
    k = 7  # not a multiple of 4: the unrolled loop's ragged end
    small = PhotonRunConfig(nr=8, nz=8, vol_nx=4, vol_ny=4, vol_nz=4,
                            tally_stride=1, vol_stride=1)
    return {
        0: pk.BlockPlan.build(m, small, True, k, 1, 1, 8),
        1: pk.BlockPlan.build(m, small, False, k, 1, 1, 8),
        2: pk.BlockPlan.build(m, cfg, False, k, cfg.tally_stride,
                              cfg.vol_stride, 8),
    }


def test_draw_layout():
    lanes, seed, block = 8, (0x89ABCDEF << 32) | 0x01234567, 5
    for n_phase, plan in _plans().items():
        assert plan.n_phase == n_phase
        assert plan.n_draws == 5 * plan.k_steps + n_phase
        u = pk.philox_uniforms(plan, seed, block, lanes)
        assert u.dtype == torch.float32
        assert tuple(u.shape) == (plan.n_draws, lanes)
        want = np.empty((plan.n_draws, lanes), np.float32)
        for lane in range(lanes):
            for g in range((plan.n_draws + 3) // 4):
                words = _philox_scalar((lane, block, g, 0),
                                       (seed & M32, seed >> 32))
                for j, w in enumerate(words):
                    if 4 * g + j < plan.n_draws:
                        want[4 * g + j, lane] = (w >> 8) * 2.0 ** -24
        np.testing.assert_array_equal(u.numpy(), want)
        assert float(u.min()) >= 0.0 and float(u.max()) < 1.0


def _kernel_schedule(n_phase, k_steps, alive):
    """The kernel's step loop in plain form: the Philox cache (``grp``,
    ``grp1``) and the groups each word offset evaluates.  Returns the groups
    evaluated, in order, as (step, group) (step -1: block start), and the
    draws each live step takes."""
    evaluated, taken = [], {}
    grp = grp1 = None
    if n_phase > 0:  # the phase draws: group 0, and group 1 with two
        evaluated.append((-1, 0))
        grp = 0
        if n_phase == 2:
            evaluated.append((-1, 1))
            grp1 = 1
    for s in range(k_steps):
        base = n_phase + 5 * s
        off, g = (n_phase + s) & 3, base >> 2
        assert off == base & 3
        a, b = grp, grp1  # every lane fills the cache, live or dead
        if off == 0:
            a, b = g, g + 1
            evaluated += [(s, g), (s, g + 1)]
            grp = b
        elif off == 1:
            b, grp1 = g + 1, g + 2
            evaluated += [(s, g + 1), (s, g + 2)]
            grp = b
        elif off == 2:
            grp = grp1
        else:
            b = g + 1
            evaluated.append((s, g + 1))
        if alive[s]:
            taken[s] = ([4 * a + j for j in range(off, 4)]
                        + [4 * b + j for j in range(off + 1)])
    return evaluated, taken


def test_group_schedule():
    k = 64
    rng = np.random.default_rng(0)
    patterns = [np.ones(k, bool)] + [rng.random(k) < p
                                     for p in (0.9, 0.7, 0.5, 0.2)]
    patterns.append(np.arange(k) % 9 < 5)
    for n_phase in (0, 1, 2):
        for alive in patterns:
            evaluated, taken = _kernel_schedule(n_phase, k, alive)
            # every live step takes exactly its five draws
            assert sorted(taken) == [s for s in range(k) if alive[s]]
            for s, draws in taken.items():
                base = n_phase + 5 * s
                assert draws == list(range(base, base + 5))
            # each group once, in order, whatever the lane's dead runs: the
            # groups of the block's draws, and with two phase draws one more
            groups = [g for _, g in evaluated]
            assert groups == list(range(len(groups)))
            n_draws = n_phase + 5 * k
            assert len(groups) == (n_draws + 3) // 4 + (n_phase == 2)
            # no step evaluates more than two groups
            per_step = np.bincount([s for s, _ in evaluated if s >= 0],
                                   minlength=k)
            assert per_step.max() == 2
        assert len(_kernel_schedule(n_phase, k, np.ones(k, bool))[0]) == (
            80, 81, 82)[n_phase]

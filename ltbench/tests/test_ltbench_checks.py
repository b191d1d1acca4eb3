"""The output check fails what it must: the control (the reference in
bfloat16 in the program's place) and each fault planted under a run come
out not correct by each cell's limits, on small cuts of the cells."""

import pytest
import torch

import tiny
from ltbench import faults, harness, seeds
from ltbench.registry import Registry

CELLS = ["soft_shadow_123k.frames_d3", "soft_shadow_123k.frames_d8_compact"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


def _failing(numbers, limits):
    return [k for k in numbers if numbers[k] > limits[k]]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(root, cell):
    reg = Registry(root)
    spec = reg.cell(cell)
    traffic = reg.traffic(spec["traffic"])
    sess = reg.module("entries", traffic["entry"]).Session(
        reg, reg.config(spec["config"]), traffic, "cpu")
    limits = reg.workload(cell)["limits"]
    for seed in (11, 2**31 + 5, 987654321):
        ids = torch.arange(sess.pixels)
        fs = [seeds.part_seed(seed, seeds.JOB, k) for k in range(2)]
        control = sess.reference_pixels(fs, ids, dtype=torch.bfloat16)
        numbers = sess.compare(control, sess.reference_pixels(fs, ids))
        assert _failing(numbers, limits), (seed, numbers)


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(root, cell, fault):
    with faults.FAULTS[fault]():
        res = harness.run(root, cell, 31337, 0.2, False, device="cpu")
    assert res["correct"] is False, res["check"]

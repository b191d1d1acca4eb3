"""The port's feature probes (``ops/feature_probes.py``) against the
reference probes of ``scripts/probe_treelet_features.py`` on the CPU.

Each reference probe runs unchanged, its ``pallas_call`` forced into
interpret mode and its inputs and output captured.  The port builds the
same inputs bitwise, its plain version reproduces the captured output
bitwise, and its own entry point passes its check.  The reference's P10
assertion (1e-6 relative) fails in interpret mode by design of the probe,
at 2.733e-06; the test expects that failure and still holds the port to
the captured output.
"""

import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.experimental import pallas

from light_transport_tpu_torch.ops import _build
from light_transport_tpu_torch.ops import feature_probes as fp

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def reference():
    spec = importlib.util.spec_from_file_location(
        "probe_treelet_features", ROOT / "scripts" / "probe_treelet_features.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == jax.numpy.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int32 if t.element_size() == 4
                               else torch.int16).numpy()


@pytest.mark.parametrize("name", fp.NAMES)
def test_probe_matches_reference(name, reference, monkeypatch):
    captured = []
    interpret_call = pallas.pallas_call

    def capture(kernel, **kw):
        call = interpret_call(kernel, **{**kw, "interpret": True})

        def run(*args):
            out = call(*args)
            captured.append((args, out))
            return out
        return run

    monkeypatch.setattr(pallas, "pallas_call", capture)
    if name == "p_packed_pair_flush":
        with pytest.raises(AssertionError) as failed:
            reference.PROBES[name]()
        assert 2.7e-6 < float(str(failed.value)) < 2.8e-6
    else:
        reference.PROBES[name]()
    (args, out), = captured
    args = [_torch(a) for a in args]
    ours = fp.inputs(name, "cpu")
    assert len(ours) == len(args)
    for a, b in zip(ours, args):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(_bits(a), _bits(b))
    got = fp.PLAIN[name](*args)
    want = _torch(out)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(_bits(got), _bits(want))
    # on CPU tensors the wrapper is the plain version, and the entry point
    # holds it to the reference's check
    record = fp.run_probe(name, "cpu")
    assert record["ok"] and record["bitwise"] and record["launches"] == 0
    if name == "p_packed_pair_flush":
        assert record["rel_err_vs_f64"] == pytest.approx(2.733e-6, rel=1e-3)
    # the library's C launch function takes the operands, output and stream
    assert _build.PROBE_OPERANDS[name] == len(fp.SPECS[name][0])

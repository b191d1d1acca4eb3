"""The feature probes P1-P10: ten small CUDA kernels, each exercising one
Hopper mechanism that the redesigned render and photon kernels build on,
with their plain PyTorch versions and an entry point.

The counterpart of ``scripts/probe_treelet_features.py``, whose ten Pallas
probes each checked one Mosaic feature the TPU's treelet kernel needed.
Here each probe computes the same function on the same inputs through the
Hopper counterpart of that feature (``csrc/probe_kernels.cu``):

==  ======================  ============================================
P1  p_while                 nested loops whose trip count is read on the
                            device
P2  p_while_vec_carry       a block-uniform loop, ``__syncthreads_or``
P3  p_dma_smem              a TMA bulk copy at an index read on the
                            device, waited on through an ``mbarrier``
P4  p_red_when              a block minimum, then a block-uniform branch
P5  p_red_dma               a block minimum as the bulk copy's index
P6  p_red_smem_dma          the same through a ``__shared__`` scalar
P7  p_onehot                a bf16 one-hot gather on the tensor cores
                            (``mma.sync``), exact through a 3-chunk split
P8  p_when_mm               a device flag, a 128 KiB bulk copy into opt-in
                            dynamic shared memory, a bf16 ``mma`` product
P9  p_reshape_8x128         an (8, 128) -> (1, 1024) relayout through
                            shared memory
P10 p_packed_pair_flush     a 2-D histogram by a bf16 hi/lo one-hot
                            contraction on the tensor cores (K2's flush)
==  ======================  ============================================

Per probe: ``inputs(name, device)`` builds the reference's inputs with
numpy, ``<name>_reference`` is the plain version, ``<name>`` the wrapper,
and ``check(name, args, out)`` the reference probe's own assertion.  P10's
check departs from the reference's: the reference rounds the low half of
each value to bf16, which K2 states as ~2^-16 relative accuracy, while its
assertion asks for 1e-6 and fails in Pallas's interpret mode (2.733e-06);
here it holds the result to 2^-16 of the largest bin against the float64
sum and reports the error.

The wrappers launch their kernel for CUDA tensors and run the plain
version for CPU tensors; they have no other path.  ``LAUNCHES`` counts the
kernel launches of each.

Run ``python -m light_transport_tpu_torch.ops.feature_probes [name]
[--device cpu]``: with a name, one probe in this process; without, every
probe in a subprocess of its own with a timeout (a faulting kernel poisons
its process's CUDA context, and a bulk copy whose ``mbarrier`` never
completes hangs), one JSON line each, exiting non-zero if any failed.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

MODULE = "light_transport_tpu_torch.ops.feature_probes"
_ROOT = Path(__file__).resolve().parents[2]

# the tables of P3, P5 and P6: (slices, 8, 128) float32
_SLICES = 4
# P7: table width and cursors; P10: histogram bins and records
_T, _R = 512, 256
_NI, _NJ, _ROWS, _LANES = 64, 128, 8, 128
# P10's bound on |kernel - f64 sum| relative to the largest bin: the bf16
# rounding of the low half (photon_kernel.py's K2 docstring, ~2^-16)
FLUSH_REL_TOL = 2.0 ** -16
# seconds a probe's subprocess may take: start-up, the card, the library's
# load; a bulk copy that never completes traps after about two seconds
PROBE_TIMEOUT_S = 120.0

# each probe's operands as (dtype, shape), then its float32 output's shape
SPECS = {
    "p_while": (((torch.int32, (1, 1)),), (8, 128)),
    "p_while_vec_carry": (((torch.float32, (1, _R)),), (1, _R)),
    "p_dma_smem": (((torch.int32, (1,)),
                    (torch.float32, (_SLICES, 8, 128))), (8, 128)),
    "p_red_when": (((torch.int32, (8, 128)),), (8, 128)),
    "p_red_dma": (((torch.int32, (8, 128)),
                   (torch.float32, (_SLICES, 8, 128))), (8, 128)),
    "p_red_smem_dma": (((torch.int32, (8, 128)),
                        (torch.float32, (_SLICES, 8, 128))), (8, 128)),
    "p_onehot": (((torch.int32, (1, _R)), (torch.bfloat16, (128, _T))),
                 (1, _R)),
    "p_when_mm": (((torch.int32, (1,)), (torch.float32, (2, 128, 256))),
                  (128, 128)),
    "p_reshape_8x128": (((torch.float32, (8, 128)),), (8, 1024)),
    "p_packed_pair_flush": (((torch.int32, (_ROWS, _LANES)),
                             (torch.int32, (_ROWS, _LANES)),
                             (torch.float32, (_ROWS, _LANES))), (_NI, _NJ)),
}
NAMES = tuple(SPECS)

# kernel launches made through the wrappers (read and reset by callers)
LAUNCHES = {name: 0 for name in NAMES}


# --------------------------------------------------------------------------
# inputs, as scripts/probe_treelet_features.py builds them
# --------------------------------------------------------------------------

def _table():
    return np.arange(_SLICES * 8 * 128, dtype=np.float32).reshape(_SLICES, 8,
                                                                  128)


def _min_at_2():
    idxv = np.full((8, 128), 7, np.int32)
    idxv[3, 17] = 2
    return idxv


def _bf16(a) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float32).to(torch.bfloat16)


def _onehot_inputs():
    """P7's cursors and its (128, T) bf16 table whose rows 0-2 hold the
    hi, mid and lo chunks of T random values; the split must be exact."""
    rng = np.random.default_rng(0)
    vals = torch.from_numpy(rng.normal(size=(_T,)).astype(np.float32) * 37.3)
    hi = _bf16(vals)
    r1 = vals - hi.float()
    mid = _bf16(r1)
    lo = _bf16(r1 - mid.float())
    if not torch.equal(hi.float() + mid.float() + lo.float(), vals):
        raise AssertionError("host 3-chunk split not exact")
    tab_t = torch.zeros((128, _T), dtype=torch.bfloat16)
    tab_t[0], tab_t[1], tab_t[2] = hi, mid, lo
    cursors = rng.integers(0, _T, size=(1, _R)).astype(np.int32)
    return cursors, tab_t


def _flush_inputs():
    rng = np.random.default_rng(0)
    ib = rng.integers(0, _NI, (_ROWS, _LANES)).astype(np.int32)
    jb = rng.integers(0, _NJ, (_ROWS, _LANES)).astype(np.int32)
    v = rng.normal(size=(_ROWS, _LANES)).astype(np.float32)
    return ib, jb, v


_INPUTS = {
    "p_while": lambda: (np.array([[5]], np.int32),),
    "p_while_vec_carry": lambda: (
        np.where(np.arange(_R) == 3, 5.0, 0.0).astype(np.float32)[None],),
    "p_dma_smem": lambda: (np.array([2], np.int32), _table()),
    "p_red_when": lambda: (np.full((8, 128), 7, np.int32),),
    "p_red_dma": lambda: (_min_at_2(), _table()),
    "p_red_smem_dma": lambda: (_min_at_2(), _table()),
    "p_onehot": _onehot_inputs,
    "p_when_mm": lambda: (np.array([1], np.int32),
                          np.ones((2, 128, 256), np.float32)),
    "p_reshape_8x128": lambda: (
        np.arange(8 * 128, dtype=np.float32).reshape(8, 128),),
    "p_packed_pair_flush": _flush_inputs,
}


def inputs(name: str, device="cuda") -> tuple:
    """The reference probe's inputs for ``name`` as tensors on ``device``."""
    return tuple(torch.as_tensor(a).to(device).contiguous()
                 for a in _INPUTS[name]())


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------

def p_while_reference(n):
    """P1: (8, 128) filled with sum_{i < n} i, each term counted up by an
    inner loop, in float32 as the TPU kernel's nested while loops."""
    count = int(n[0, 0])
    acc = np.float32(0.0)
    i = 0
    while i < count:
        add, c = np.float32(0.0), i
        while c > 0:
            c, add = c - 1, add + np.float32(1.0)
        i, acc = i + 1, acc + add
    return torch.full((8, 128), float(acc), dtype=torch.float32,
                      device=n.device)


def p_while_vec_carry_reference(x):
    """P2: every lane steps ``acc += cur; cur += 1`` while ANY lane's cursor
    is below 10 (no per-lane mask)."""
    cur = x.to(torch.int32)
    acc = torch.zeros_like(x)
    while bool((cur < 10).any()):
        cur, acc = cur + 1, acc + cur.to(torch.float32)
    return acc


def _slice(tab, i: int):
    if not 0 <= i < tab.shape[0]:
        raise IndexError(f"table index {i} outside 0..{tab.shape[0] - 1}")
    return tab[i].clone()


def p_dma_smem_reference(idx, tab):
    """P3: ``tab[idx[0]]``."""
    return _slice(tab, int(idx[0]))


def p_red_when_reference(x):
    """P4: ones if min(x) > 3, else zeros, (8, 128)."""
    out = torch.zeros((8, 128), dtype=torch.float32, device=x.device)
    if int(x.min()) > 3:
        out.fill_(1.0)
    return out


def p_red_dma_reference(idxv, tab):
    """P5: ``tab[min(idxv)]``."""
    return _slice(tab, int(idxv.min()))


# P6 computes P5's function; only the kernel's path to the index differs
p_red_smem_dma_reference = p_red_dma_reference


def p_onehot_reference(cursors, tab_t):
    """P7: q = tab_t @ onehot(cursors) in float32 (one nonzero product per
    column, so exact), returned as (q0 + q1) + q2."""
    t = tab_t.shape[1]
    onehot = (torch.arange(t, device=cursors.device)[:, None]
              == cursors).to(torch.float32)
    q = tab_t[:3].to(torch.float32) @ onehot
    return (q[0:1] + q[1:2]) + q[2:3]


def p_when_mm_reference(flag, tab):
    """P8: if flag > 0, A = bf16(tab[1]) and (A A^T)[:, :128] summed in
    float32; else zeros."""
    if int(flag[0]) <= 0:
        return torch.zeros((128, 128), dtype=torch.float32, device=tab.device)
    a = tab[1].to(torch.bfloat16).to(torch.float32)
    return (a @ a.T)[:, :128].contiguous()


def p_reshape_8x128_reference(x):
    """P9: (8, 128) -> (1, 1024), broadcast to (8, 1024)."""
    return x.reshape(1, 1024).expand(8, 1024).contiguous()


def p_packed_pair_flush_reference(ib, jb, v):
    """P10: the (64, 128) histogram of the records (ib, jb, v) as two
    one-hot contractions over the 1024 records, of v's bf16 high half and
    of its low half rounded to bf16, each summed in float32."""
    dev = v.device
    ibf, jbf, vf = ib.reshape(1, -1), jb.reshape(1, -1), v.reshape(1, -1)
    vhi = vf.to(torch.bfloat16).to(torch.float32)
    vlo = vf - vhi
    a = (torch.arange(_NI, device=dev)[:, None] == ibf).to(torch.float32)
    m = torch.arange(_NJ, device=dev)[:, None] == jbf
    vh = torch.where(m, vhi, 0.0).to(torch.bfloat16).to(torch.float32)
    vl = torch.where(m, vlo, 0.0).to(torch.bfloat16).to(torch.float32)
    return a @ vh.T + a @ vl.T


PLAIN = {name: globals()[f"{name}_reference"] for name in NAMES}


# --------------------------------------------------------------------------
# the reference probes' checks
# --------------------------------------------------------------------------

def _require(cond, what):
    if not cond:
        raise AssertionError(what)


def _check_slice2(args, out):
    _require(torch.allclose(out, args[1][2]), f"not tab[2]: {out[0, :4]}")


def _check_onehot(args, out):
    cursors, tab_t = args
    recon = (tab_t[0].float() + tab_t[1].float()) + tab_t[2].float()
    want = recon[cursors[0].long()]
    _require(torch.equal(out[0], want), f"{out[0, :4]} vs {want[:4]}")


def _check_flush(args, out):
    ib, jb, v = (a.cpu().numpy() for a in args)
    vhi = torch.from_numpy(v).to(torch.bfloat16).float().numpy()
    want = np.zeros((_NI, _NJ), np.float64)
    np.add.at(want, (ib, jb), vhi.astype(np.float64)
              + (v - vhi).astype(np.float64))
    got = out.cpu().double().numpy()
    err = float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))
    _require(err < FLUSH_REL_TOL, f"relative error {err} >= 2^-16")
    return {"rel_err_vs_f64": err}


_CHECKS = {
    "p_while": lambda a, o: _require(float(o[0, 0]) == 10.0,
                                     f"out[0, 0] = {float(o[0, 0])}"),
    "p_while_vec_carry": lambda a, o: _require(
        float(o[0, 0]) == 45.0 and float(o[0, 3]) == 95.0,
        f"out[0, :6] = {o[0, :6].tolist()}"),
    "p_dma_smem": _check_slice2,
    "p_red_when": lambda a, o: _require(float(o[0, 0]) == 1.0,
                                        f"out[0, 0] = {float(o[0, 0])}"),
    "p_red_dma": _check_slice2,
    "p_red_smem_dma": _check_slice2,
    "p_onehot": _check_onehot,
    "p_when_mm": lambda a, o: _require(float(o[0, 0]) == 256.0,
                                       f"out[0, 0] = {float(o[0, 0])}"),
    "p_reshape_8x128": lambda a, o: _require(
        torch.equal(o[0].cpu(), torch.arange(1024, dtype=torch.float32)),
        f"out[0, :6] = {o[0, :6].tolist()}"),
    "p_packed_pair_flush": _check_flush,
}


def check(name: str, args, out) -> dict:
    """The reference probe's assertion on ``out`` (P10: 2^-16 of the
    largest bin against the float64 sum); raises AssertionError, returns
    what it measured."""
    return _CHECKS[name](args, out) or {}


def agree(name: str, got, want):
    """Kernel output ``got`` against the plain version's ``want``: equal
    bit for bit, or for P10 within 2^-16 of the largest bin (the tensor
    cores round sums of several records in a bin their own way).  Raises
    AssertionError; returns (bitwise, max |got - want|)."""
    _require(got.shape == want.shape and got.dtype == want.dtype,
             f"{name}: {got.dtype} {tuple(got.shape)} vs {want.dtype} "
             f"{tuple(want.shape)}")
    bitwise = torch.equal(got.view(torch.int32), want.view(torch.int32))
    err = float((got.double() - want.double()).abs().max())
    if name == "p_packed_pair_flush":
        tol = FLUSH_REL_TOL * float(want.abs().max())
        _require(err <= tol, f"{name}: max abs err {err} > {tol}")
    else:
        _require(bitwise, f"{name}: not bitwise equal (max abs err {err})")
    return bitwise, err


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------

def _call(name, *args):
    """Check ``args`` against ``name``'s spec, then launch its kernel for
    CUDA tensors or run its plain version for CPU tensors."""
    specs, out_shape = SPECS[name]
    if len(args) != len(specs):
        raise ValueError(f"{name}: expected {len(specs)} operands, got "
                         f"{len(args)}")
    dev = args[0].device
    for k, (t, (dtype, shape)) in enumerate(zip(args, specs)):
        if t.device != dev:
            raise ValueError(f"{name} operand {k}: on {t.device}, operand 0 "
                             f"on {dev}")
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name} operand {k}: expected {dtype} {shape},"
                             f" got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} operand {k}: must be contiguous")
    if dev.type == "cpu":
        return PLAIN[name](*args)
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    for k, t in enumerate(args):
        # bulk copies and 16-byte vector loads need aligned operands
        if t.data_ptr() % 16:
            raise ValueError(f"{name} operand {k}: must start on a 16-byte "
                             "boundary")
    from light_transport_tpu_torch.ops._build import load_probe_kernels

    lib = load_probe_kernels()
    out = torch.empty(out_shape, dtype=torch.float32, device=dev)
    vp = ctypes.c_void_p
    rc = getattr(lib, f"{name}_launch")(
        *(vp(t.data_ptr()) for t in (*args, out)),
        vp(torch.cuda.current_stream(dev).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"{name}_launch failed: CUDA error {rc} "
                           f"({lib.probe_kernel_error_string(rc).decode()})")
    LAUNCHES[name] += 1
    return out


def p_while(n):
    """P1 (int32 (1, 1) trip count) -> (8, 128)."""
    return _call("p_while", n)


def p_while_vec_carry(x):
    """P2 ((1, 256) float32 start cursors) -> (1, 256)."""
    return _call("p_while_vec_carry", x)


def p_dma_smem(idx, tab):
    """P3 (int32 (1,) index, (4, 8, 128) table) -> (8, 128)."""
    return _call("p_dma_smem", idx, tab)


def p_red_when(x):
    """P4 ((8, 128) int32) -> (8, 128)."""
    return _call("p_red_when", x)


def p_red_dma(idxv, tab):
    """P5 ((8, 128) int32 indices, (4, 8, 128) table) -> (8, 128)."""
    return _call("p_red_dma", idxv, tab)


def p_red_smem_dma(idxv, tab):
    """P6 (as P5) -> (8, 128)."""
    return _call("p_red_smem_dma", idxv, tab)


def p_onehot(cursors, tab_t):
    """P7 ((1, 256) int32 cursors, (128, 512) bf16 table) -> (1, 256)."""
    return _call("p_onehot", cursors, tab_t)


def p_when_mm(flag, tab):
    """P8 (int32 (1,) flag, (2, 128, 256) float32) -> (128, 128)."""
    return _call("p_when_mm", flag, tab)


def p_reshape_8x128(x):
    """P9 ((8, 128) float32) -> (8, 1024)."""
    return _call("p_reshape_8x128", x)


def p_packed_pair_flush(ib, jb, v):
    """P10 ((8, 128) int32 i and j bins, (8, 128) float32 values) ->
    (64, 128)."""
    return _call("p_packed_pair_flush", ib, jb, v)


WRAPPERS = {name: globals()[name] for name in NAMES}


def empty_launch(device="cuda"):
    """One launch of an empty kernel of the probes' block shape through
    the same ctypes path: the yardstick for the probes' times, which at
    their sizes are launch overhead."""
    from light_transport_tpu_torch.ops._build import load_probe_kernels

    lib = load_probe_kernels()
    dev = torch.device(device)
    rc = lib.probe_empty_launch(
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"probe_empty_launch failed: CUDA error {rc} "
                           f"({lib.probe_kernel_error_string(rc).decode()})")


# --------------------------------------------------------------------------
# entry point
# --------------------------------------------------------------------------

def run_probe(name: str, device="cuda") -> dict:
    """One probe through its wrapper on ``device``, its launches counted
    from 0, held to the reference probe's check and to the plain version
    on the same inputs.  Raises AssertionError on a failure; returns the
    record that the entry point prints."""
    dev = torch.device(device)
    args = inputs(name, dev)
    LAUNCHES[name] = 0
    out = WRAPPERS[name](*args)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    launches = LAUNCHES[name]
    measured = check(name, args, out)
    bitwise, err = agree(name, out, PLAIN[name](*args))
    return {"probe": name, "ok": True, "device": str(dev),
            "launches": launches, "bitwise": bitwise, "max_abs_err": err,
            **measured}


def run_all(device="cuda") -> list:
    """Each probe by ``run_probe`` in a subprocess of its own, in turn;
    one record each, ``{"probe", "ok": False, "error"}`` for a probe
    whose process failed or outlived ``PROBE_TIMEOUT_S`` (and was
    killed)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(_ROOT), env.get("PYTHONPATH")) if p)
    records = []
    for name in NAMES:
        cmd = [sys.executable, "-m", MODULE, name, "--device", str(device)]
        try:
            r = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=PROBE_TIMEOUT_S, env=env)
        except subprocess.TimeoutExpired:
            records.append({"probe": name, "ok": False,
                            "error": f"timed out after {PROBE_TIMEOUT_S} s"})
            continue
        lines = r.stdout.strip().splitlines()
        if r.returncode == 0 and lines:
            records.append(json.loads(lines[-1]))
        else:
            tail = (r.stderr or r.stdout).strip().splitlines()[-3:]
            records.append({"probe": name, "ok": False,
                            "error": f"exit {r.returncode}: "
                                     + " | ".join(tail)})
    return records


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Run the feature probes P1-P10: one in this process, "
                    "or each in a subprocess of its own.")
    p.add_argument("name", nargs="?", choices=NAMES)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    if a.name is not None:
        print(json.dumps(run_probe(a.name, a.device)), flush=True)
        return 0
    records = run_all(a.device)
    for r in records:
        print(json.dumps(r), flush=True)
    return 0 if all(r["ok"] for r in records) else 1


if __name__ == "__main__":
    sys.exit(main())

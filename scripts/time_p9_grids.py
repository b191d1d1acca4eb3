#!/usr/bin/env python3
"""Time grids of the feature probe P9 (the (8, 128) -> (8, 1024) relayout)
against each other, against the shipped kernel and against the one PyTorch
call of the same function, inside one run on an NVIDIA GPU.

Usage, from the repository root:

    python3 scripts/time_p9_grids.py [--rounds N]

The grids below are written out in this script's own CUDA source, built
with the package's nvcc flags: one block of 256 threads storing eight
float4 each, eight blocks of 256 threads storing one output row each, and
32 blocks of 64 threads storing one float4 each.  Each loads its float4 of
``x`` through the read-only path; none stages through shared memory.
Each is held bitwise against ``p_reshape_8x128_reference``; then every
grid, the shipped kernel (``feature_probes.p_reshape_8x128``),
``x.view(1, 1024).repeat(8, 1)`` and an empty kernel are timed in turns
(first to last, then last to first, ``--rounds`` times): device time a
call under the profiler and by CUDA events, each over 100 calls back to
back.  The last line is one JSON object with every reading and the card.
"""

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from light_transport_tpu_torch.ops import _build  # noqa: E402
from light_transport_tpu_torch.ops import feature_probes as fp  # noqa: E402

OUT = _build.BUILD_DIR / "p9_grids"
SOURCE = r"""
#include <cuda_runtime.h>

// one block of 256 threads, eight 16-byte stores a thread
__global__ void __launch_bounds__(256) one_block(const float* __restrict__ x,
                                                 float* __restrict__ out) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(x) + threadIdx.x);
#pragma unroll
  for (int r = 0; r < 8; ++r)
    reinterpret_cast<float4*>(out)[r * 256 + threadIdx.x] = v;
}

// eight blocks of 256 threads, block r writing output row r
__global__ void __launch_bounds__(256) row_blocks(const float* __restrict__ x,
                                                  float* __restrict__ out) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(x) + threadIdx.x);
  reinterpret_cast<float4*>(out)[blockIdx.x * 256 + threadIdx.x] = v;
}

// 32 blocks of 64 threads, one float4 of one row a thread
__global__ void __launch_bounds__(64) small_blocks(const float* __restrict__ x,
                                                   float* __restrict__ out) {
  const int g = blockIdx.x * 64 + threadIdx.x;  // output float4 g
  const float4 v = __ldg(reinterpret_cast<const float4*>(x) + (g & 255));
  reinterpret_cast<float4*>(out)[g] = v;
}

static cudaStream_t as_stream(void* s) { return (cudaStream_t)s; }

extern "C" int one_block_launch(const float* x, float* out, void* s) {
  one_block<<<1, 256, 0, as_stream(s)>>>(x, out);
  return (int)cudaGetLastError();
}
extern "C" int row_blocks_launch(const float* x, float* out, void* s) {
  row_blocks<<<8, 256, 0, as_stream(s)>>>(x, out);
  return (int)cudaGetLastError();
}
extern "C" int small_blocks_launch(const float* x, float* out, void* s) {
  small_blocks<<<32, 64, 0, as_stream(s)>>>(x, out);
  return (int)cudaGetLastError();
}
"""
GRIDS = ("one_block", "row_blocks", "small_blocks")


def build():
    """nvcc the grids' source with the package's flags; returns the bound
    library and ptxas's report."""
    OUT.mkdir(parents=True, exist_ok=True)
    src, lib = OUT / "p9_grids.cu", OUT / "p9_grids.so"
    src.write_text(SOURCE)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{res.stdout}\n{res.stderr}")
    so = ctypes.CDLL(str(lib))
    for name in GRIDS:
        fn = getattr(so, f"{name}_launch")
        fn.argtypes = [ctypes.c_void_p] * 3
        fn.restype = ctypes.c_int
    return so, res.stdout + res.stderr


def launcher(so, name, x, out):
    fn = getattr(so, f"{name}_launch")
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    px, po = ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(out.data_ptr())

    def call():
        rc = fn(px, po, stream)
        if rc != 0:
            raise RuntimeError(f"{name}: CUDA error {rc}")
    return call


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_p9_grids: no CUDA device", file=sys.stderr)
        return 1
    card = cs.smi()
    so, report = build()
    print(report.strip(), flush=True)
    (x,) = fp.inputs("p_reshape_8x128", cs.DEV)
    want = fp.p_reshape_8x128_reference(x)
    calls = {}
    for name in GRIDS:
        out = torch.full_like(want, float("nan"))
        calls[name] = launcher(so, name, x, out)
        calls[name]()
        torch.cuda.synchronize()
        cs.check(torch.equal(out, want), f"{name}: not bitwise equal")
        print(f"{name}: bitwise equal to the plain version", flush=True)
    got = fp.p_reshape_8x128(x)
    torch.cuda.synchronize()
    cs.check(torch.equal(got, want), "shipped P9: not bitwise equal")
    calls["shipped"] = lambda: fp.p_reshape_8x128(x)
    calls["repeat"] = lambda: x.view(1, 1024).repeat(8, 1)
    calls["empty"] = lambda: fp.empty_launch(cs.DEV)
    order = list(calls)
    readings = {name: {"device_ms": [], "events_ms": []} for name in order}
    for r in range(args.rounds):
        for name in (order if r % 2 == 0 else order[::-1]):
            dev = cs.probe_device_ms(calls[name])
            ev = cs.cuda_ms(calls[name], cs.PROBE_REPS)
            readings[name]["device_ms"].append(dev)
            readings[name]["events_ms"].append(ev)
            print(f"round {r} {name}: device {dev:.5f} ms a call (profiler),"
                  f" {ev:.5f} ms by CUDA events", flush=True)
    print(card)
    print(json.dumps({"card": card, "readings": readings}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

// The feature probes P1-P10 for NVIDIA Hopper (sm_90a).
//
// Replaces the ten Pallas probes of scripts/probe_treelet_features.py, each
// of which checked one Mosaic feature that the TPU's treelet kernel needed.
// Each kernel here computes its probe's function on its probe's shapes
// through the Hopper counterpart of that feature: loops whose trip counts
// are read on the device, block-uniform loops and branches, TMA bulk
// copies completed through an mbarrier, and bf16 products on the tensor
// cores (mma.sync.m16n8k16) with one-hot operands built in registers.
// These are the mechanisms the redesigned K1, K4 and K5 build on: TMA
// staging of a cluster's weights or a treelet, tensor-core histogram
// flushes in place of atomics, lockstep walks of a ray tile.
//
// Every kernel but P8 and P9 runs as one block of 256 threads (8 warps).
// At these sizes (4 KiB to 192 KiB moved) a launch costs more than the
// work, so what bounds each probe on the card is the launch; the kernels
// are written to be right and to show the mechanism plainly, not to be
// fast.  P8 is split over 64 blocks of 4 warps, P9 over 8 blocks of 256
// threads (see there).
//
// Every launch function returns cudaGetLastError() after its launch.  A
// table index outside the table traps (as torch's device-side index
// check does), and a bulk copy that never completes its mbarrier traps
// after ~2^32 cycles instead of hanging.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -fmad=false.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSlice = 8 * 128;  // floats in one (8, 128) table slice
constexpr int kSlices = 4;       // slices in P3/P5/P6's table
constexpr uint32_t kBf16One = 0x3F80u;

// ---------------------------------------------------------------------------
// mbarrier, TMA bulk copy and mma helpers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One thread: an mbarrier expecting `arrivals` arrivals, made visible to
// the other threads and to the async proxy (the caller syncs the block
// after).
__device__ __forceinline__ void mbar_init(uint64_t* bar,
                                          uint32_t arrivals = 1) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(arrivals)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// One thread: arrive on `bar` expecting `bytes` of transactions, then copy
// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global
// `src` to shared `dst` by TMA; the copy's completion counts the bytes off
// the barrier.  The expected bytes are set before the copy is issued.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Every thread: wait for phase `parity` of `bar` to complete.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const long long t0 = clock64();
  uint32_t done = 0;
  while (true) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1LL << 32)) __trap();
  }
}

// D += A B for one m16n8k16 tile: A (16x16, row) and B (16x8, col) bf16 in
// the PTX fragment layout, D float32.  With g = lane / 4 and t = lane % 4:
// a[0] = A[g][2t, 2t+1], a[1] = A[g+8][2t, 2t+1], a[2] = A[g][2t+8, 2t+9],
// a[3] = A[g+8][2t+8, 2t+9]; b[0] = B[2t, 2t+1][g], b[1] = B[2t+8, 2t+9][g];
// d[0, 1] = D[g][2t, 2t+1], d[2, 3] = D[g+8][2t, 2t+1].  The lower 16 bits
// of a register hold the element of lower k.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(uint32_t lo, uint32_t hi) {
  return lo | (hi << 16);
}

__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// Minimum of v within each warp by shuffles; lane 0 of each warp writes
// its warp's minimum to warp_min, and the block syncs.
__device__ __forceinline__ void warp_minima(int v, int* warp_min) {
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(kFull, v, o));
  if ((threadIdx.x & 31) == 0) warp_min[threadIdx.x >> 5] = v;
  __syncthreads();
}

__device__ __forceinline__ int min_of(const int* warp_min) {
  int m = warp_min[0];
  for (int w = 1; w < kWarps; ++w) m = min(m, warp_min[w]);
  return m;
}

// Minimum of this thread's four of the 1024 int32s of x.
__device__ __forceinline__ int thread_min4(const int* x) {
  const int4 v = reinterpret_cast<const int4*>(x)[threadIdx.x];
  return min(min(v.x, v.y), min(v.z, v.w));
}

// Thread 0 copies table slice `idx` into `buf` by TMA; every thread then
// waits and stores its float4 of the slice to out.  `bar` must be
// initialised and the block synced.
__device__ __forceinline__ void copy_slice(int idx, const float* tab,
                                           float* buf, uint64_t* bar,
                                           float* out) {
  if (threadIdx.x == 0) {
    if (idx < 0 || idx >= kSlices) __trap();
    bulk_load(buf, tab + static_cast<size_t>(idx) * kSlice,
              kSlice * sizeof(float), bar);
  }
  mbar_wait(bar, 0);
  reinterpret_cast<float4*>(out)[threadIdx.x] =
      reinterpret_cast<const float4*>(buf)[threadIdx.x];
}

// ---------------------------------------------------------------------------
// P1 p_while (probe_treelet_features.py:42): out (8, 128) = sum_{i<n} i by
// two nested loops, the outer one's trip count n read from device memory
// in its condition.  Each thread runs both loops and stores four values.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
    p_while_kernel(const int* __restrict__ n, float* __restrict__ out) {
  int i = 0;
  float acc = 0.0f;
  while (i < *n) {
    int c = i;
    float add = 0.0f;
    while (c > 0) {
      c -= 1;
      add += 1.0f;
    }
    i += 1;
    acc += add;
  }
  reinterpret_cast<float4*>(out)[threadIdx.x] = make_float4(acc, acc, acc,
                                                            acc);
}

// ---------------------------------------------------------------------------
// P2 p_while_vec_carry (:71): a (1, 256) state, one lane per thread,
// stepped acc += cur, cur += 1 while ANY lane's cursor is below 10.  The
// loop condition is __syncthreads_or, so the loop is block-uniform and a
// finished lane keeps stepping, as the TPU's vector carry does (a
// per-thread loop would stop lane 3 at 35 where the probe wants 95).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
    p_while_vec_carry_kernel(const float* __restrict__ x,
                             float* __restrict__ out) {
  int cur = static_cast<int>(x[threadIdx.x]);
  float acc = 0.0f;
  while (__syncthreads_or(cur < 10)) {
    acc += static_cast<float>(cur);
    cur += 1;
  }
  out[threadIdx.x] = acc;
}

// ---------------------------------------------------------------------------
// P3 p_dma_smem (:103): out = tab[idx], idx read on the device by thread
// 0, which issues one 4 KiB TMA bulk copy of that slice into shared memory
// and arrives on the mbarrier with its expected bytes; every thread waits
// on the barrier's phase 0 and stores from shared memory.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
    p_dma_smem_kernel(const int* __restrict__ idx,
                      const float* __restrict__ tab, float* __restrict__ out) {
  __shared__ __align__(128) float buf[kSlice];
  __shared__ __align__(8) uint64_t bar;
  if (threadIdx.x == 0) mbar_init(&bar);
  __syncthreads();
  copy_slice(threadIdx.x == 0 ? *idx : 0, tab, buf, &bar, out);
}

// ---------------------------------------------------------------------------
// P4 p_red_when (:131): out = 1 if min(x) > 3 else 0.  The block minimum by
// warp shuffles, then the eight warp minima through shared memory, which
// every thread reads, so the branch is block-uniform.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
    p_red_when_kernel(const int* __restrict__ x, float* __restrict__ out) {
  __shared__ int warp_min[kWarps];
  warp_minima(thread_min4(x), warp_min);
  const int m = min_of(warp_min);
  float4* o = reinterpret_cast<float4*>(out) + threadIdx.x;
  if (m > 3)
    *o = make_float4(1.0f, 1.0f, 1.0f, 1.0f);
  else
    *o = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// ---------------------------------------------------------------------------
// P5 p_red_dma (:153): out = tab[min(idxv)].  Thread 0 combines the warp
// minima and uses the result directly as the TMA copy's index.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
    p_red_dma_kernel(const int* __restrict__ idxv,
                     const float* __restrict__ tab, float* __restrict__ out) {
  __shared__ __align__(128) float buf[kSlice];
  __shared__ __align__(8) uint64_t bar;
  __shared__ int warp_min[kWarps];
  if (threadIdx.x == 0) mbar_init(&bar);
  warp_minima(thread_min4(idxv), warp_min);  // syncs the block
  copy_slice(threadIdx.x == 0 ? min_of(warp_min) : 0, tab, buf, &bar, out);
}

// ---------------------------------------------------------------------------
// P6 p_red_smem_dma (:182): as P5, with the index passed through a scalar
// scratch: thread 0 writes the minimum to a __shared__ int, the block
// syncs, every thread re-reads it, and thread 0 copies at the value it
// re-read.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
    p_red_smem_dma_kernel(const int* __restrict__ idxv,
                          const float* __restrict__ tab,
                          float* __restrict__ out) {
  __shared__ __align__(128) float buf[kSlice];
  __shared__ __align__(8) uint64_t bar;
  __shared__ int warp_min[kWarps];
  __shared__ int ss;
  if (threadIdx.x == 0) mbar_init(&bar);
  warp_minima(thread_min4(idxv), warp_min);
  if (threadIdx.x == 0) ss = min_of(warp_min);
  __syncthreads();
  const int idx = ss;
  copy_slice(idx, tab, buf, &bar, out);
}

// ---------------------------------------------------------------------------
// P7 p_onehot (:213): out[c] = (q0 + q1) + q2 with q = tabT onehot(cursors),
// tabT (128, 512) bf16 holding a value's hi, mid and lo chunks in rows
// 0-2.  On the tensor cores: M = rows 0-15 of tabT (A read from global as
// bf16 pairs), N = the 256 cursors in 32 tiles of 8 (four per warp), K =
// the 512 table columns in 32 steps of 16.  The one-hot B operand never
// exists in memory: each thread builds its fragment from its column's
// cursor.  Each column of q has one nonzero product, so q is exact, and
// the three rows are summed in the reference's order after shuffles.
// ---------------------------------------------------------------------------
constexpr int kT7 = 512;
constexpr int kR7 = 256;

__global__ void __launch_bounds__(kThreads)
    p_onehot_kernel(const int* __restrict__ cursors,
                    const uint16_t* __restrict__ tab_t,
                    float* __restrict__ out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  constexpr int kTiles = kR7 / 8 / kWarps;  // n-tiles per warp
  int cur[kTiles];
  for (int j = 0; j < kTiles; ++j)
    cur[j] = cursors[(warp * kTiles + j) * 8 + g];
  float d[kTiles][4] = {};
  const uint32_t* row_g = reinterpret_cast<const uint32_t*>(tab_t + g * kT7);
  const uint32_t* row_g8 =
      reinterpret_cast<const uint32_t*>(tab_t + (g + 8) * kT7);
  for (int k0 = 0; k0 < kT7; k0 += 16) {
    const int ka = k0 + 2 * t, kb = ka + 8;
    const uint32_t a[4] = {__ldg(row_g + ka / 2), __ldg(row_g8 + ka / 2),
                           __ldg(row_g + kb / 2), __ldg(row_g8 + kb / 2)};
    for (int j = 0; j < kTiles; ++j) {
      const uint32_t b[2] = {
          pack_bf16(cur[j] == ka ? kBf16One : 0u,
                    cur[j] == ka + 1 ? kBf16One : 0u),
          pack_bf16(cur[j] == kb ? kBf16One : 0u,
                    cur[j] == kb + 1 ? kBf16One : 0u)};
      mma_bf16(d[j], a, b);
    }
  }
  // q rows 0, 1, 2 of columns 2t, 2t+1 sit in d[.][0..1] of lanes t, 4+t
  // and 8+t
  for (int j = 0; j < kTiles; ++j) {
    float s[2];
    for (int e = 0; e < 2; ++e) {
      const float q0 = __shfl_sync(kFull, d[j][e], t);
      const float q1 = __shfl_sync(kFull, d[j][e], 4 + t);
      const float q2 = __shfl_sync(kFull, d[j][e], 8 + t);
      s[e] = (q0 + q1) + q2;
    }
    if (lane < 4)
      reinterpret_cast<float2*>(out)[((warp * kTiles + j) * 8 + 2 * t) / 2] =
          make_float2(s[0], s[1]);
  }
}

// ---------------------------------------------------------------------------
// P8 p_when_mm (:251): if flag > 0, out = (A A^T)[:, :128] with A =
// bf16(tab[1]) (128 x 256), summed in float32 on the tensor cores; else
// zeros.  The flag is read on the device by every thread, so the branch is
// block-uniform.
//
// A grid of 8 x 8 blocks of 4 warps, each block one 16 x 16 tile of the
// output (rows r0.., columns c0..).  The tile needs rows r0..r0+15 of A and
// rows c0..c0+15 (B = A^T: B[k][n] = A[n][k]); thread 0 copies those two
// 16 KiB row ranges (one on the diagonal) into shared memory by TMA bulk
// copies completing one mbarrier, while every thread reads the flag.  The
// block converts each element to bf16 once, into rows padded to 264
// elements (528 bytes: the eight 16-byte row addresses of an ldmatrix fall
// on eight different groups of four banks, so the loads are free of bank
// conflicts); warp w then takes k in [64w, 64w + 64): four k-steps of one
// ldmatrix.x4 for A's fragment, one for two n-tiles of B's and two
// mma.sync.m16n8k16, and the four partial tiles are added in warp order.
// The copies land in the block's shared memory, so a block
// waits for them whichever way it branches.  Its 48.5 KiB of dynamic
// shared memory are above the 48 KiB default and need the opt-in
// attribute set at launch.
// ---------------------------------------------------------------------------
constexpr int kM8 = 128;       // rows of A and of the output
constexpr int kK8 = 256;       // columns of A
constexpr int kTile8 = 16;     // a block's output tile
constexpr int kThreads8 = 128;
constexpr int kWarps8 = kThreads8 / 32;
constexpr int kLd8 = kK8 + 8;  // bf16 row stride in shared memory
constexpr uint32_t kRows8 = kTile8 * kK8 * sizeof(float);  // 16 KiB
constexpr uint32_t kSmem8 = 2 * kRows8 + 2 * kTile8 * kLd8 * 2;

// Four 8 x 8 bf16 matrices from shared memory: lanes 8i..8i+7 give the row
// addresses of matrix i, and r[i] receives each thread's pair of it in the
// mma fragment layout (row lane / 4, columns 2 (lane % 4) and the next).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(row)));
}

__global__ void __launch_bounds__(kThreads8)
    p_when_mm_kernel(const int* __restrict__ flag,
                     const float* __restrict__ tab, float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem8[];
  float* stage = reinterpret_cast<float*>(smem8);  // 2 x 16 rows, float32
  __nv_bfloat16* a16 =
      reinterpret_cast<__nv_bfloat16*>(smem8 + 2 * kRows8);  // 32 x kLd8
  __shared__ __align__(16) float part[kWarps8][kTile8][kTile8];
  __shared__ __align__(8) uint64_t bar;
  const int r0 = blockIdx.y * kTile8, c0 = blockIdx.x * kTile8;
  const bool diag = r0 == c0;
  const float* a = tab + kM8 * kK8;  // tab[1]
  if (threadIdx.x == 0) mbar_init(&bar, diag ? 1 : 2);
  __syncthreads();
  if (threadIdx.x == 0) {
    bulk_load(stage, a + r0 * kK8, kRows8, &bar);
    if (!diag) bulk_load(stage + kTile8 * kK8, a + c0 * kK8, kRows8, &bar);
  }
  const int f = *flag;
  mbar_wait(&bar, 0);
  if (f > 0) {
    const int rows = diag ? kTile8 : 2 * kTile8;
    for (int q = threadIdx.x; q < rows * kK8 / 4; q += kThreads8) {
      const int row = q / (kK8 / 4), c4 = q % (kK8 / 4);
      const float4 v = reinterpret_cast<const float4*>(stage)[q];
      const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
      *reinterpret_cast<uint2*>(a16 + row * kLd8 + 4 * c4) =
          make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                     *reinterpret_cast<const uint32_t*>(&hi));
    }
    __syncthreads();
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const __nv_bfloat16* arow = a16 + (lane & 15) * kLd8 + (lane >> 4) * 8;
    const int mat = lane >> 3;
    const __nv_bfloat16* brow =
        a16 + ((diag ? 0 : kTile8) + (mat >> 1) * 8 + (lane & 7)) * kLd8 +
        (mat & 1) * 8;
    float d[2][4] = {};
    for (int k0 = warp * (kK8 / kWarps8); k0 < (warp + 1) * (kK8 / kWarps8);
         k0 += 16) {
      uint32_t af[4], bf[4];
      ldmatrix_x4(af, arow + k0);
      ldmatrix_x4(bf, brow + k0);
      const uint32_t b0[2] = {bf[0], bf[1]}, b1[2] = {bf[2], bf[3]};
      mma_bf16(d[0], af, b0);
      mma_bf16(d[1], af, b1);
    }
    const int g = lane >> 2, t = lane & 3;
    for (int j = 0; j < 2; ++j) {
      *reinterpret_cast<float2*>(&part[warp][g][j * 8 + 2 * t]) =
          make_float2(d[j][0], d[j][1]);
      *reinterpret_cast<float2*>(&part[warp][g + 8][j * 8 + 2 * t]) =
          make_float2(d[j][2], d[j][3]);
    }
    __syncthreads();
    const int row = threadIdx.x / (kTile8 / 2);
    const int col = 2 * (threadIdx.x % (kTile8 / 2));
    float2 sum = *reinterpret_cast<const float2*>(&part[0][row][col]);
    for (int w = 1; w < kWarps8; ++w) {
      const float2 p = *reinterpret_cast<const float2*>(&part[w][row][col]);
      sum.x += p.x;
      sum.y += p.y;
    }
    *reinterpret_cast<float2*>(out + (r0 + row) * kM8 + c0 + col) = sum;
  } else if (threadIdx.x < kTile8 * kTile8 / 4) {
    const int row = threadIdx.x / (kTile8 / 4), c4 = threadIdx.x % (kTile8 / 4);
    reinterpret_cast<float4*>(out + (r0 + row) * kM8 + c0)[c4] =
        make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

// ---------------------------------------------------------------------------
// P9 p_reshape_8x128 (:300): (8, 128) -> (1, 1024), broadcast to (8, 1024),
// so out[r, :] = x.reshape(-1).  On a row-major array the TPU's sublane-
// major relayout is the identity (flat index s * 128 + l is both the read
// and the write), so nothing is staged: block r writes output row r, and
// its thread i loads x's float4 i through the read-only path and stores it
// in one 16-byte store.  36 KB moved bound it at ~1e-5 ms, far below a
// launch; what the card spends is one load's latency and the launch.
// Eight blocks of one store a thread beat one block of eight stores a
// thread on an H100 (scripts/time_p9_grids.py; PERF.md).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
    p_reshape_8x128_kernel(const float* __restrict__ x,
                           float* __restrict__ out) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(x) + threadIdx.x);
  reinterpret_cast<float4*>(out)[blockIdx.x * (kSlice / 4) + threadIdx.x] = v;
}

// ---------------------------------------------------------------------------
// P10 p_packed_pair_flush (:322): the (64, 128) histogram of 1024 records
// (i, j, v) as A VH^T + A VL^T, A (64 x 1024) the one-hot of i, VH and VL
// (128 x 1024) v's bf16 high half and its low half rounded to bf16 where
// j matches, each product summed in float32 on the tensor cores.  As bf16
// tiles the operands would take 384 KiB; here the records are staged in
// shared memory as (i, j, hi, lo), 12 KiB, and each thread builds its A
// and B fragments in registers from the four records of a k-step it
// holds.  Warp w takes i-bins 16(w % 4)..+15 and j-bins 64(w / 4)..+63
// (8 n-tiles), K = the 1024 records in 64 steps of 16, with separate high
// and low accumulators added at the end as the reference adds its two
// products.  A bin that several records share is summed in the tensor
// cores' own rounding, so it can differ from the plain version's float32
// sum in the last bits; K2 states the split's accuracy as ~2^-16.
// ---------------------------------------------------------------------------
constexpr int kNI = 64;
constexpr int kNJ = 128;
constexpr int kRec = 1024;
static_assert(kNI == 16 * 4 && kNJ == 64 * 2,
              "eight warps, each 16 i-bins by 64 j-bins");

__global__ void __launch_bounds__(kThreads)
    p_packed_pair_flush_kernel(const int* __restrict__ ib,
                               const int* __restrict__ jb,
                               const float* __restrict__ v,
                               float* __restrict__ out) {
  __shared__ int s_i[kRec];
  __shared__ int s_j[kRec];
  __shared__ uint16_t s_hi[kRec];
  __shared__ uint16_t s_lo[kRec];
  for (int r = threadIdx.x; r < kRec; r += kThreads) {
    const float f = v[r];
    const __nv_bfloat16 hi = __float2bfloat16_rn(f);
    s_i[r] = ib[r];
    s_j[r] = jb[r];
    s_hi[r] = __bfloat16_as_ushort(hi);
    s_lo[r] = static_cast<uint16_t>(bf16_bits(f - __bfloat162float(hi)));
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int i_lo = (warp % 4) * 16 + g, i_hi = i_lo + 8;
  const int j0 = (warp / 4) * 64 + g;
  constexpr int kTiles = 8;
  float dh[kTiles][4] = {};
  float dl[kTiles][4] = {};
  for (int k0 = 0; k0 < kRec; k0 += 16) {
    const int ka = k0 + 2 * t, kb = ka + 8;
    const int r[4] = {ka, ka + 1, kb, kb + 1};
    int ri[4], rj[4];
    uint32_t rh[4], rl[4];
    for (int e = 0; e < 4; ++e) {
      ri[e] = s_i[r[e]];
      rj[e] = s_j[r[e]];
      rh[e] = s_hi[r[e]];
      rl[e] = s_lo[r[e]];
    }
    const uint32_t a[4] = {
        pack_bf16(ri[0] == i_lo ? kBf16One : 0u,
                  ri[1] == i_lo ? kBf16One : 0u),
        pack_bf16(ri[0] == i_hi ? kBf16One : 0u,
                  ri[1] == i_hi ? kBf16One : 0u),
        pack_bf16(ri[2] == i_lo ? kBf16One : 0u,
                  ri[3] == i_lo ? kBf16One : 0u),
        pack_bf16(ri[2] == i_hi ? kBf16One : 0u,
                  ri[3] == i_hi ? kBf16One : 0u)};
    for (int n = 0; n < kTiles; ++n) {
      const int j = j0 + n * 8;
      const uint32_t bh[2] = {
          pack_bf16(rj[0] == j ? rh[0] : 0u, rj[1] == j ? rh[1] : 0u),
          pack_bf16(rj[2] == j ? rh[2] : 0u, rj[3] == j ? rh[3] : 0u)};
      const uint32_t bl[2] = {
          pack_bf16(rj[0] == j ? rl[0] : 0u, rj[1] == j ? rl[1] : 0u),
          pack_bf16(rj[2] == j ? rl[2] : 0u, rj[3] == j ? rl[3] : 0u)};
      mma_bf16(dh[n], a, bh);
      mma_bf16(dl[n], a, bl);
    }
  }
  for (int n = 0; n < kTiles; ++n) {
    const int col = (warp / 4) * 64 + n * 8 + 2 * t;
    *reinterpret_cast<float2*>(out + i_lo * kNJ + col) =
        make_float2(dh[n][0] + dl[n][0], dh[n][1] + dl[n][1]);
    *reinterpret_cast<float2*>(out + i_hi * kNJ + col) =
        make_float2(dh[n][2] + dl[n][2], dh[n][3] + dl[n][3]);
  }
}

__global__ void __launch_bounds__(kThreads) probe_empty_kernel() {}

inline cudaStream_t as_stream(void* s) { return static_cast<cudaStream_t>(s); }

}  // namespace

extern "C" int p_while_launch(const int* n, float* out, void* stream) {
  p_while_kernel<<<1, kThreads, 0, as_stream(stream)>>>(n, out);
  return (int)cudaGetLastError();
}

extern "C" int p_while_vec_carry_launch(const float* x, float* out,
                                        void* stream) {
  p_while_vec_carry_kernel<<<1, kThreads, 0, as_stream(stream)>>>(x, out);
  return (int)cudaGetLastError();
}

extern "C" int p_dma_smem_launch(const int* idx, const float* tab, float* out,
                                 void* stream) {
  p_dma_smem_kernel<<<1, kThreads, 0, as_stream(stream)>>>(idx, tab, out);
  return (int)cudaGetLastError();
}

extern "C" int p_red_when_launch(const int* x, float* out, void* stream) {
  p_red_when_kernel<<<1, kThreads, 0, as_stream(stream)>>>(x, out);
  return (int)cudaGetLastError();
}

extern "C" int p_red_dma_launch(const int* idxv, const float* tab, float* out,
                                void* stream) {
  p_red_dma_kernel<<<1, kThreads, 0, as_stream(stream)>>>(idxv, tab, out);
  return (int)cudaGetLastError();
}

extern "C" int p_red_smem_dma_launch(const int* idxv, const float* tab,
                                     float* out, void* stream) {
  p_red_smem_dma_kernel<<<1, kThreads, 0, as_stream(stream)>>>(idxv, tab,
                                                                 out);
  return (int)cudaGetLastError();
}

extern "C" int p_onehot_launch(const int* cursors, const uint16_t* tab_t,
                               float* out, void* stream) {
  p_onehot_kernel<<<1, kThreads, 0, as_stream(stream)>>>(cursors, tab_t, out);
  return (int)cudaGetLastError();
}

extern "C" int p_when_mm_launch(const int* flag, const float* tab, float* out,
                                void* stream) {
  // without the opt-in the launch is refused and never runs
  cudaError_t err = cudaFuncSetAttribute(
      p_when_mm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem8);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(kM8 / kTile8, kM8 / kTile8);
  p_when_mm_kernel<<<grid, kThreads8, kSmem8, as_stream(stream)>>>(flag, tab,
                                                                   out);
  return (int)cudaGetLastError();
}

extern "C" int p_reshape_8x128_launch(const float* x, float* out,
                                      void* stream) {
  p_reshape_8x128_kernel<<<8, kThreads, 0, as_stream(stream)>>>(x, out);
  return (int)cudaGetLastError();
}

extern "C" int p_packed_pair_flush_launch(const int* ib, const int* jb,
                                          const float* v, float* out,
                                          void* stream) {
  p_packed_pair_flush_kernel<<<1, kThreads, 0, as_stream(stream)>>>(ib, jb, v,
                                                                    out);
  return (int)cudaGetLastError();
}

extern "C" int probe_empty_launch(void* stream) {
  probe_empty_kernel<<<1, kThreads, 0, as_stream(stream)>>>();
  return (int)cudaGetLastError();
}

extern "C" const char* probe_kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

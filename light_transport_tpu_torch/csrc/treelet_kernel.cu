// Roped BVH walk for NVIDIA Hopper (sm_90a): the treelet kernels K5 and K5r.
//
// Replaces the TPU kernel `_kernel` of light_transport_tpu/ops/pallas/
// treelet_kernel.py:204 in both of its modes:
//   * resume=False (K5, pallas_call at :425): every ray walked from the BVH
//     root to the end in one launch -> treelet_walk32<any_hit>, its own
//     kernel over 32-byte node records (below, "K5");
//   * resume=True (K5r, pallas_call at :505): every ray resumed from its
//     cursor, best_t and best_tri, optionally bounded to `max_loads`
//     treelets of T nodes -> treelet_walk<any_hit, staged>.
//
// What it computes.  The stackless roped walk of accel/bvh.roped_walk (the
// plain PyTorch version): at a node whose box the ray enters (slab test,
// entry clamped to 0, entry <= best_t, exit >= 0) an interior node advances
// the cursor to node + 1 and a leaf tests its triangles (Moller-Trumbore,
// |det| > 1e-12, t_min < t < best_t) in order, keeping a strictly nearer
// hit; every other node follows its rope.  The cursor only moves forward
// in depth-first order, so a ray passes through each treelet (T contiguous
// nodes) at most once, in ascending order.  Any hit: the ray stops after
// the leaf of its first hit.  Resume mode: the treelet the ray starts the
// launch in counts as its first load; the ray stops with its cursor on the
// first node of treelet number max_loads + 1 (max_loads = 0: no bound).
// The arithmetic follows the plain version op for op, without FMA
// contraction (-fmad=false), so the two agree bitwise in t, triangle and
// per-ray node visits, whatever the schedule below.
//
// K5r's design.  One thread walks one ray, in blocks of 256 threads; it is
// the TPU design mapped to Hopper:
//   * Treelets in shared memory.  A block is a tile of lanes in the order
//     of `perm`, which the wavefront driver sorts by cursor.  In a bounded
//     pass (max_loads >= 1) the block stages the treelet of its lowest
//     live cursor, T rows of 64 bytes (32 KB at T = 512), with one TMA
//     bulk copy (cp.async.bulk) completing an mbarrier; its lanes read the
//     node records of that treelet from shared memory and every other
//     record, and the leaf triangles, from global memory.  The unbounded
//     last pass, whose few live lanes are spread over the whole BVH (0.5 %
//     of its node visits fall in a block's lowest treelet), reads global
//     memory only.  The TPU tile's hops (lanes walk only inside the staged
//     treelet, then the block stages the next) lose on the H100: the last
//     pass's few live blocks each hop hundreds of treelets in series
//     (PERF.md, section 6).
//   * Lane state in place.  Thread i walks lane perm[i]: it reads that
//     lane's feature rows, cursor, best_t and best_tri, and writes cursor,
//     best_t and best_tri back at the lane and adds its node visits there.
//     The driver sorts only the permutation.
//   * A gate on the device.  A launch given `gate_in` returns at once when
//     that word is 0; with `gate_out` it adds the lanes it leaves unfinished
//     (cursor < M) there.  The driver chains one word per pass, so the
//     passes after the last live one cost a launch each and no host read.
// Each block adds its node visits, leaf visits, triangle tests, node visits
// served from shared memory and treelets staged to five counters.
//
// What bounds K5r.  Each node visit reads 48 bytes and each triangle test
// 36 bytes at addresses that depend on the ray; in global memory these are
// dependent loads whose latency, not the card's bandwidth or FP32 rate,
// sets the time of a launch's slowest ray.  Staging serves the early,
// coherent passes from shared memory (87-100 % of their node visits), but
// those records are the top of the tree, which the L1 and L2 caches hold
// anyway: staged, the passes are no faster than through the caches.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -fmad=false.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;
constexpr int kWarps = kBlock / 32;
constexpr int kMaxLeaf = 4;
constexpr int kRowVecs = 4;  // float4 per node record (64 bytes)
constexpr int kCounts = 5;
constexpr float kDetEps = 1e-12f;

// ---------------------------------------------------------------------------
// mbarrier and TMA bulk copy (as csrc/intersect_kernel.cu's K4 ring)
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One thread: an mbarrier expecting one arrival, made visible to the async
// proxy (the caller syncs the block after).
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(1)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// One thread: arrive on `bar` expecting `bytes` of transactions, then copy
// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global
// `src` to shared `dst` by TMA.
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

// Wait for phase `parity` of `bar`; traps after ~2^32 cycles instead of
// hanging the card.
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

// ---------------------------------------------------------------------------
// the walk
// ---------------------------------------------------------------------------

// Moller-Trumbore for one triangle, in the order of accel/bvh._mt_single:
// cross products as (a_y b_z - a_z b_y, ...), dot products as
// (x + y) + z.
__device__ __forceinline__ void mt_test(float ox, float oy, float oz,
                                        float dx, float dy, float dz,
                                        const float (&tri)[9], float tmin,
                                        float& best_t, int32_t& best_tri,
                                        int32_t id) {
  const float v0x = tri[0], v0y = tri[1], v0z = tri[2];
  const float e1x = tri[3], e1y = tri[4], e1z = tri[5];
  const float e2x = tri[6], e2y = tri[7], e2z = tri[8];
  const float px = dy * e2z - dz * e2y;
  const float py = dz * e2x - dx * e2z;
  const float pz = dx * e2y - dy * e2x;
  const float det = (e1x * px + e1y * py) + e1z * pz;
  const bool ok = fabsf(det) > kDetEps;
  const float inv = ok ? 1.0f / det : 0.0f;
  const float tx = ox - v0x, ty = oy - v0y, tz = oz - v0z;
  const float u = ((tx * px + ty * py) + tz * pz) * inv;
  const float qx = ty * e1z - tz * e1y;
  const float qy = tz * e1x - tx * e1z;
  const float qz = tx * e1y - ty * e1x;
  const float v = ((dx * qx + dy * qy) + dz * qz) * inv;
  const float t = ((e2x * qx + e2y * qy) + e2z * qz) * inv;
  const bool valid = ok && u >= 0.0f && u <= 1.0f && v >= 0.0f &&
                     u + v <= 1.0f && t > tmin && t < best_t;
  if (valid && t < best_t) {
    best_t = t;
    best_tri = id;
  }
}

__device__ __forceinline__ void mt_single(float ox, float oy, float oz,
                                          float dx, float dy, float dz,
                                          const float* __restrict__ tri,
                                          float tmin, float& best_t,
                                          int32_t& best_tri, int32_t id) {
  float v[9];
#pragma unroll
  for (int j = 0; j < 9; ++j) v[j] = __ldg(tri + j);
  mt_test(ox, oy, oz, dx, dy, dz, v, tmin, best_t, best_tri, id);
}

struct Params {
  const float* feats;  // (16, n) rows [o, d, 1/d, t_min, t_max, 0...]
  int n;
  const int64_t* perm;  // thread i walks lane perm[i]
  const float4* node;   // (m, 16) [min3, max3, first, count, skip, 0...]
  const float* leaf;    // (m, leaf_w) [v0, e1, e2] per triangle
  int leaf_w, max_leaf, m, T, max_loads;
  int32_t* cursor;  // read and written at the lane
  float* best_t;    // read and written at the lane
  int32_t* best_tri;
  int32_t* visits;         // added to at the lane
  const int32_t* gate_in;  // return at once when *gate_in == 0
  int32_t* gate_out;       // lanes left with cursor < m, added to
  unsigned long long* counts;  // kCounts counters, added to
};

// The lowest value of the block; every thread gets it.  `red` holds kWarps
// ints.
__device__ __forceinline__ int block_min(int v, int* red) {
  const int m = __reduce_min_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
  __syncthreads();
  int a = INT_MAX;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) a = min(a, red[w]);
  return a;
}

template <bool kAnyHit, bool kStaged>
__global__ void __launch_bounds__(kBlock) treelet_walk(Params p) {
  extern __shared__ __align__(128) float4 staged[];  // kStaged: T rows
  __shared__ __align__(8) uint64_t bar;
  __shared__ unsigned long long block_counts[kCounts + 1];
  __shared__ int red[kWarps];
  // the gate: a word that every thread reads, so the return is uniform
  if (p.gate_in != nullptr && *p.gate_in == 0) return;
  if (threadIdx.x <= kCounts) block_counts[threadIdx.x] = 0;
  if (kStaged && threadIdx.x == 0) mbar_init(&bar);
  __syncthreads();

  const int m = p.m, n = p.n, T = p.T;
  const int i = blockIdx.x * kBlock + threadIdx.x;
  int64_t lane = -1;
  if (i < n) lane = p.perm[i];
  int32_t cursor = m;
  if (lane >= 0) cursor = p.cursor[lane];
  const bool started = cursor < m;  // lanes finished before stay as are
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  float ix = 0.f, iy = 0.f, iz = 0.f, tmin = 0.f, best_t = 0.f;
  int32_t best_tri = -1;
  if (started) {
    const float* f = p.feats + lane;
    ox = f[0]; oy = f[n]; oz = f[2 * n];
    dx = f[3 * n]; dy = f[4 * n]; dz = f[5 * n];
    ix = f[6 * n]; iy = f[7 * n]; iz = f[8 * n];
    tmin = f[9 * n];
    best_t = p.best_t[lane];
    best_tri = p.best_tri[lane];
  }
  // the lane's treelet for the max_loads bound: [tbase, tbase + T)
  int tbase = started ? cursor - cursor % T : 0;
  int loads = 1;
  bool live = started;
  unsigned int n_node = 0, n_leaf = 0, n_tri = 0, n_smem = 0, n_staged = 0;
  const float4* node = p.node;
  // the staged treelet: node rows [base, base + rows)
  int base = 0, rows = 0;
  if (kStaged) {
    const int cur = block_min(started ? cursor / T : INT_MAX, red);
    if (cur != INT_MAX) {
      base = cur * T;
      rows = min(T, m - base);
      if (threadIdx.x == 0) {
        bulk_load(staged, node + (size_t)base * kRowVecs,
                  (uint32_t)rows * kRowVecs * 16u, &bar);
        n_staged = 1;
      }
      mbar_wait(&bar, 0);
    }
  }
  while (live) {
    const unsigned int off = (unsigned int)(cursor - base);
    float4 a, b, c;
    if (kStaged && off < (unsigned int)rows) {
      const float4* rec = staged + (size_t)off * kRowVecs;
      a = rec[0];  // min x y z, max x
      b = rec[1];  // max y z, first, count
      c = rec[2];  // skip, 0...
      ++n_smem;
    } else {
      const float4* rec = node + (size_t)kRowVecs * cursor;
      a = __ldg(rec);
      b = __ldg(rec + 1);
      c = __ldg(rec + 2);
    }
    const int32_t first = __float_as_int(b.z);
    const int32_t count = __float_as_int(b.w);
    const int32_t skip = __float_as_int(c.x);
    const float t1x = (a.x - ox) * ix, t2x = (a.w - ox) * ix;
    const float t1y = (a.y - oy) * iy, t2y = (b.x - oy) * iy;
    const float t1z = (a.z - oz) * iz, t2z = (b.y - oz) * iz;
    float tn = fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)),
                     fminf(t1z, t2z));
    const float tf = fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)),
                           fmaxf(t1z, t2z));
    tn = fmaxf(tn, 0.0f);
    const bool hit_box = tn <= tf && tn <= best_t && tf >= 0.0f;
    ++n_node;
    if (hit_box && count > 0) {
      ++n_leaf;
      const float* lrec = p.leaf + (size_t)cursor * p.leaf_w;
#pragma unroll
      for (int k = 0; k < kMaxLeaf; ++k) {
        if (k >= p.max_leaf || k >= count) break;
        ++n_tri;
        mt_single(ox, oy, oz, dx, dy, dz, lrec + 9 * k, tmin, best_t,
                  best_tri, first + k);
      }
    }
    int32_t nxt = (hit_box && count == 0) ? cursor + 1 : skip;
    if (kAnyHit && best_tri >= 0) nxt = m;
    cursor = nxt;
    if (nxt >= m) {
      live = false;
    } else if (p.max_loads > 0 &&
               (unsigned int)(nxt - tbase) >= (unsigned int)T) {
      tbase = nxt - nxt % T;
      if (++loads > p.max_loads) live = false;
    }
  }

  if (started) {
    p.cursor[lane] = cursor;
    p.best_t[lane] = best_t;
    p.best_tri[lane] = best_tri;
    p.visits[lane] += (int32_t)n_node;
  }
  // per-warp sums into shared memory, one global add per counter per block
  const unsigned int mine[kCounts + 1] = {
      n_node, n_leaf, n_tri, n_smem, n_staged,
      (unsigned int)(lane >= 0 && cursor < m)};
#pragma unroll
  for (int k = 0; k <= kCounts; ++k) {
    const unsigned int w = __reduce_add_sync(0xffffffffu, mine[k]);
    if ((threadIdx.x & 31) == 0 && w)
      atomicAdd(&block_counts[k], (unsigned long long)w);
  }
  __syncthreads();
  if (threadIdx.x < kCounts && block_counts[threadIdx.x])
    atomicAdd(&p.counts[threadIdx.x], block_counts[threadIdx.x]);
  if (p.gate_out != nullptr && threadIdx.x == kCounts &&
      block_counts[kCounts])
    atomicAdd(p.gate_out, (int32_t)block_counts[kCounts]);
}

template <bool kAnyHit, bool kStaged>
int launch(const Params& p, cudaStream_t stream) {
  const size_t smem = kStaged ? (size_t)p.T * kRowVecs * sizeof(float4) : 0;
  auto kernel = treelet_walk<kAnyHit, kStaged>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (p.n + kBlock - 1) / kBlock;
  kernel<<<blocks, kBlock, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

bool valid(int max_leaf, int T, int max_loads) {
  return max_leaf >= 1 && max_leaf <= kMaxLeaf && T >= 1 && max_loads >= 0 &&
         (size_t)T * kRowVecs * sizeof(float4) <= 227 * 1024;
}

// Resident blocks per SM of one K5r instance (nearest hit) at T nodes a
// treelet.
template <bool kStaged>
cudaError_t blocks_per_sm(int T, int* out) {
  const size_t smem = kStaged ? (size_t)T * kRowVecs * sizeof(float4) : 0;
  auto kernel = treelet_walk<false, kStaged>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel, kBlock,
                                                      smem);
  return e;
}

// ---------------------------------------------------------------------------
// K5: the walk from the root over 32-byte node records
// ---------------------------------------------------------------------------
//
// Replaces the TPU kernel `_kernel` with resume=False
// (light_transport_tpu/ops/pallas/treelet_kernel.py:204, pallas_call at
// :425): every ray of the batch walked from the root to the end in one
// launch.  Since the dispatch sends every big-mesh query through one
// coherence-sorted launch (ops/dispatch.py), K5 carries the camera grid and
// the incoherent bounce and shadow rays alike.
//
// What bounds it on this card.  A thread walks one ray; each node visit
// needs the node's record, whose address is known only once the visit
// before has ended (the cursor moves to node + 1 or to the rope `skip`,
// read from the record).  So a ray's walk is a chain of dependent loads,
// and a launch lasts about as long as its slowest rays' chains (hundreds
// of visits, each a trip to L2 or to HBM; a lone ray takes ~0.31 us a
// visit on an H100 at 700 W), not as long as its bytes take at the card's
// bandwidth or its slab tests at its FP32 rate.
//
// What the design does about it.
//   * 32-byte records (accel/bvh.node_records32): [min x y z, max x]
//     [max y z, skip, first << 3 | count], the box floats the same bits as
//     the 64-byte fused records, so the slab test is unchanged.  A visit
//     reads one 32-byte sector instead of 48 bytes over two, and the table
//     is half the size (84.6 MB on the 4.2M-triangle mesh against 169 MB),
//     so more of the upper tree stays in the 50 MB L2.
//   * A leaf's triangles in one go: the first 9 * count floats of its row
//     in 16-byte loads, all issued before the first test, so a leaf visit
//     waits one trip for its triangles however many it holds.
//   * No shared memory and no barrier in the walk: its order, and so every
//     result, is the plain walk's.  Four counters (node visits, leaf
//     visits, triangle tests, and visits whose next node is the adjacent
//     record, cursor + 1) are summed per warp and added once per block.
// Measured and removed (PERF.md, section 6): holding the record after the
// cursor (or the three after it) so that a descent would wait for no new
// load, fetching the rope's target before the box test, and loading a
// leaf's row before its box test; each was slower on the card.

constexpr int kWalkCounts = 6;  // kCounts' five, then adjacent visits
constexpr int kAdjacentCount = 5;

struct WalkParams {
  const float* feats;  // (16, n) rows [o, d, 1/d, t_min, t_max, 0...]
  int n;
  const float4* node;  // (m, 8): two float4 a node
  const float* leaf;   // (m, leaf_w) [v0, e1, e2] per triangle
  int leaf_w, max_leaf, m;
  float* best_t;
  int32_t* best_tri;
  int32_t* visits;
  unsigned long long* counts;  // kWalkCounts counters, added to
};

__device__ __forceinline__ float part(const float4& q, int c) {
  return c == 0 ? q.x : c == 1 ? q.y : c == 2 ? q.z : q.w;
}

// The first `count` triangles of a leaf row into v (rows start on a
// 16-byte boundary: leaf_w is a multiple of 8).
__device__ __forceinline__ void load_leaf(const float* __restrict__ lrec,
                                          int count,
                                          float (&v)[kMaxLeaf][9]) {
  constexpr int kVecs = (9 * kMaxLeaf + 3) / 4;
  float4 q[kVecs];
#pragma unroll
  for (int i = 0; i < kVecs; ++i)
    q[i] = 4 * i < 9 * count
               ? __ldg(reinterpret_cast<const float4*>(lrec) + i)
               : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int k = 0; k < kMaxLeaf; ++k)
#pragma unroll
    for (int j = 0; j < 9; ++j)
      v[k][j] = part(q[(9 * k + j) / 4], (9 * k + j) % 4);
}

template <bool kAnyHit>
__global__ void __launch_bounds__(kBlock) treelet_walk32(WalkParams p) {
  __shared__ unsigned long long block_counts[kWalkCounts];
  if (threadIdx.x < kWalkCounts) block_counts[threadIdx.x] = 0;
  __syncthreads();
  const int m = p.m, n = p.n;
  const int i = blockIdx.x * kBlock + threadIdx.x;
  unsigned int n_node = 0, n_leaf = 0, n_tri = 0, n_adjacent = 0;
  if (i < n) {
    const float* f = p.feats + i;
    const float ox = f[0], oy = f[n], oz = f[2 * n];
    const float dx = f[3 * n], dy = f[4 * n], dz = f[5 * n];
    const float ix = f[6 * n], iy = f[7 * n], iz = f[8 * n];
    const float tmin = f[9 * n];
    float best_t = f[10 * n];
    int32_t best_tri = -1;
    int32_t cursor = 0;
    while (true) {
      const float4* rec = p.node + 2 * (size_t)cursor;
      const float4 a = __ldg(rec);      // min x y z, max x
      const float4 b = __ldg(rec + 1);  // max y z, skip, first << 3 | count
      const int32_t skip = __float_as_int(b.z);
      const int32_t packed = __float_as_int(b.w);
      const int32_t first = packed >> 3;
      const int32_t count = min(packed & 7, p.max_leaf);
      const float t1x = (a.x - ox) * ix, t2x = (a.w - ox) * ix;
      const float t1y = (a.y - oy) * iy, t2y = (b.x - oy) * iy;
      const float t1z = (a.z - oz) * iz, t2z = (b.y - oz) * iz;
      float tn = fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)),
                       fminf(t1z, t2z));
      const float tf = fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)),
                             fmaxf(t1z, t2z));
      tn = fmaxf(tn, 0.0f);
      const bool hit_box = tn <= tf && tn <= best_t && tf >= 0.0f;
      ++n_node;
      if (hit_box && count > 0) {
        ++n_leaf;
        float v[kMaxLeaf][9];
        load_leaf(p.leaf + (size_t)cursor * p.leaf_w, count, v);
#pragma unroll
        for (int k = 0; k < kMaxLeaf; ++k) {
          if (k >= count) break;
          ++n_tri;
          mt_test(ox, oy, oz, dx, dy, dz, v[k], tmin, best_t, best_tri,
                  first + k);
        }
      }
      int32_t nxt = (hit_box && count == 0) ? cursor + 1 : skip;
      if (kAnyHit && best_tri >= 0) nxt = m;
      if (nxt >= m) break;
      n_adjacent += nxt == cursor + 1;
      cursor = nxt;
    }
    p.best_t[i] = best_t;
    p.best_tri[i] = best_tri;
    p.visits[i] = (int32_t)n_node;
  }
  const unsigned int mine[4] = {n_node, n_leaf, n_tri, n_adjacent};
  const int slot[4] = {0, 1, 2, kAdjacentCount};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const unsigned int w = __reduce_add_sync(0xffffffffu, mine[k]);
    if ((threadIdx.x & 31) == 0 && w)
      atomicAdd(&block_counts[slot[k]], (unsigned long long)w);
  }
  __syncthreads();
  if (threadIdx.x < kWalkCounts && block_counts[threadIdx.x])
    atomicAdd(&p.counts[threadIdx.x], block_counts[threadIdx.x]);
}

template <bool kAnyHit>
int launch_walk32(const WalkParams& p, cudaStream_t stream) {
  const int blocks = (p.n + kBlock - 1) / kBlock;
  treelet_walk32<kAnyHit><<<blocks, kBlock, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// K5: every lane from the root over the 32-byte records `node` (m x 8
// floats); best_t, best_tri and visits written per lane.  counts:
// kWalkCounts int64 counters, added to.
extern "C" int treelet_walk_launch(const float* feats, int n,
                                   const float* node, const float* leaf,
                                   int leaf_w, int max_leaf, int m,
                                   int any_hit, float* best_t,
                                   int32_t* best_tri, int32_t* visits,
                                   long long* counts, void* stream) {
  if (max_leaf < 1 || max_leaf > kMaxLeaf || m < 1)
    return (int)cudaErrorInvalidValue;
  WalkParams p{feats, n, reinterpret_cast<const float4*>(node), leaf,
               leaf_w, max_leaf, m, best_t, best_tri, visits,
               reinterpret_cast<unsigned long long*>(counts)};
  auto s = (cudaStream_t)stream;
  return any_hit ? launch_walk32<true>(p, s) : launch_walk32<false>(p, s);
}

// K5r: thread i resumes lane perm[i] (int64 ids) and updates its cursor,
// best_t, best_tri and visits in place; a bounded pass (max_loads > 0)
// stages the block's lowest treelet.  gate_in (may be null): return at
// once when it holds 0; gate_out (may be null): add the lanes left
// unfinished.
extern "C" int treelet_resume_launch(
    const float* feats, int n, const int64_t* perm, const float* node,
    const float* leaf, int leaf_w, int max_leaf, int m, int T, int max_loads,
    int any_hit, int32_t* cursor, float* best_t, int32_t* best_tri,
    int32_t* visits, const int32_t* gate_in, int32_t* gate_out,
    long long* counts, void* stream) {
  if (!valid(max_leaf, T, max_loads)) return (int)cudaErrorInvalidValue;
  Params p{feats, n, perm, reinterpret_cast<const float4*>(node), leaf,
           leaf_w, max_leaf, m, T, max_loads, cursor, best_t, best_tri,
           visits, gate_in, gate_out,
           reinterpret_cast<unsigned long long*>(counts)};
  auto s = (cudaStream_t)stream;
  if (max_loads > 0)
    return any_hit ? launch<true, true>(p, s) : launch<false, true>(p, s);
  return any_hit ? launch<true, false>(p, s) : launch<false, false>(p, s);
}

// Threads a block, then the resident blocks per SM of K5 and of K5r's
// bounded (staged) and unbounded passes at T nodes a treelet.
extern "C" int treelet_blocks_per_sm(int T, int* out) {
  out[0] = kBlock;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[1], treelet_walk32<false>, kBlock, 0);
  if (e == cudaSuccess) e = blocks_per_sm<true>(T, &out[2]);
  if (e == cudaSuccess) e = blocks_per_sm<false>(T, &out[3]);
  return (int)e;
}

extern "C" const char* treelet_kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

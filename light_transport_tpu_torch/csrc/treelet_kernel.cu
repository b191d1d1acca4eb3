// Roped BVH walk for NVIDIA Hopper (sm_90a): the treelet kernels K5 and K5r.
//
// Replaces the TPU kernel `_kernel` of light_transport_tpu/ops/pallas/
// treelet_kernel.py:204 in both of its modes:
//   * resume=False (K5, pallas_call at :425): every ray walked from the BVH
//     root to the end in one launch -> treelet_walk<any_hit, false>;
//   * resume=True (K5r, pallas_call at :505): every ray resumed from its
//     cursor, best_t and best_tri, optionally bounded to `max_loads`
//     treelets of T nodes -> treelet_walk<any_hit, true>.
//
// What it computes.  The stackless roped walk of accel/bvh.roped_walk (the
// plain PyTorch version): at a node whose box the ray enters (slab test,
// entry clamped to 0, entry <= best_t, exit >= 0) an interior node advances
// the cursor to node + 1 and a leaf tests its triangles (Moller-Trumbore,
// |det| > 1e-12, t_min < t < best_t) in order, keeping a strictly nearer
// hit; every other node follows its rope.  The cursor only moves forward
// in depth-first order.  Any hit: the ray stops after the leaf of its first
// hit.  Resume mode: the treelet the ray starts the launch in counts as its
// first load; the ray stops with its cursor on the first node of treelet
// number max_loads + 1 (max_loads = 0: no bound).  The arithmetic follows
// the plain version op for op, without FMA contraction (-fmad=false), so
// the two agree bitwise in t, triangle and per-ray node visits.
//
// Design.  The TPU kernel staged one treelet per 256-ray tile in VMEM,
// hopped the whole tile to the lowest cursor and fetched node rows with a
// one-hot bf16 matmul.  None of that is needed here: one thread is one ray,
// its cursor, best_t and best_tri stay in registers for the whole walk,
// and it gathers the 48 bytes it uses of its node's 64-byte record (three
// float4 through the read-only cache) and, only at a leaf whose box it
// enters, the 36 bytes of each triangle it tests.  Blocks of 128 threads.
// Each block adds its node visits, leaf visits and triangle tests to three
// counters, from which the caller computes the kernel's bound.
//
// What bounds it.  Each node visit reads 48 bytes and each triangle test
// 36 bytes, at addresses that depend on the ray: dependent gathers whose
// latency, not the card's bandwidth or FP32 rate, sets the time unless
// enough rays are in flight.  The wavefront driver
// sorts rays by cursor between passes so that the rays of a warp walk
// nearby nodes.  Staging treelets in shared memory and prefetching with
// cp.async or TMA are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -fmad=false.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 128;
constexpr int kMaxLeaf = 4;
constexpr float kDetEps = 1e-12f;

// Moller-Trumbore for one triangle, in the order of accel/bvh._mt_single:
// cross products as (a_y b_z - a_z b_y, ...), dot products as
// (x + y) + z.
__device__ __forceinline__ void mt_single(float ox, float oy, float oz,
                                          float dx, float dy, float dz,
                                          const float* __restrict__ tri,
                                          float tmin, float& best_t,
                                          int32_t& best_tri, int32_t id) {
  const float v0x = __ldg(tri + 0), v0y = __ldg(tri + 1), v0z = __ldg(tri + 2);
  const float e1x = __ldg(tri + 3), e1y = __ldg(tri + 4), e1z = __ldg(tri + 5);
  const float e2x = __ldg(tri + 6), e2y = __ldg(tri + 7), e2z = __ldg(tri + 8);
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

// feats: (16, n) rows [o, d, 1/d, t_min, t_max, 0...].  node: (m, 16)
// records [min3, max3, first, count, skip (int bitcasts), 0...]; leaf:
// (m, leaf_w) [v0, e1, e2] per triangle.  counts: node visits, leaf
// visits, triangle tests, added to.
template <bool kAnyHit, bool kResume>
__global__ void __launch_bounds__(kBlock)
    treelet_walk(const float* __restrict__ feats, int n,
                 const float4* __restrict__ node,
                 const float* __restrict__ leaf, int leaf_w, int max_leaf,
                 int m, int T, int max_loads, const int32_t* cursor_in,
                 const float* best_t_in, const int32_t* best_tri_in,
                 int32_t* cursor_out, float* best_t_out, int32_t* best_tri_out,
                 int32_t* visits_out, unsigned long long* counts) {
  __shared__ unsigned long long block_counts[3];
  if (threadIdx.x < 3) block_counts[threadIdx.x] = 0;
  __syncthreads();
  const int i = blockIdx.x * kBlock + threadIdx.x;
  unsigned int n_node = 0, n_leaf = 0, n_tri = 0;
  if (i < n) {
    const float ox = feats[i], oy = feats[n + i], oz = feats[2 * n + i];
    const float dx = feats[3 * n + i], dy = feats[4 * n + i],
                dz = feats[5 * n + i];
    const float ix = feats[6 * n + i], iy = feats[7 * n + i],
                iz = feats[8 * n + i];
    const float tmin = feats[9 * n + i];
    int32_t cursor = kResume ? cursor_in[i] : 0;
    float best_t = kResume ? best_t_in[i] : feats[10 * n + i];
    int32_t best_tri = kResume ? best_tri_in[i] : -1;
    int treelet = kResume ? cursor / T : 0;
    int loads = 1;
    while (cursor < m) {
      const float4* rec = node + 4 * (size_t)cursor;
      const float4 a = __ldg(rec);      // min x y z, max x
      const float4 b = __ldg(rec + 1);  // max y z, first, count
      const float4 c = __ldg(rec + 2);  // skip, 0...
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
        const float* lrec = leaf + (size_t)cursor * leaf_w;
#pragma unroll
        for (int k = 0; k < kMaxLeaf; ++k) {
          if (k >= max_leaf || k >= count) break;
          ++n_tri;
          mt_single(ox, oy, oz, dx, dy, dz, lrec + 9 * k, tmin, best_t,
                    best_tri, first + k);
        }
      }
      int32_t nxt = (hit_box && count == 0) ? cursor + 1 : skip;
      if (kAnyHit && best_tri >= 0) nxt = m;
      if (kResume && max_loads > 0 && nxt < m && nxt / T != treelet) {
        treelet = nxt / T;
        if (++loads > max_loads) {
          cursor = nxt;
          break;
        }
      }
      cursor = nxt;
    }
    if (kResume) cursor_out[i] = cursor;
    best_t_out[i] = best_t;
    best_tri_out[i] = best_tri;
    visits_out[i] = (int32_t)n_node;
  }
  // per-warp sums into shared memory, one global add per counter per block
  const unsigned int w_node = __reduce_add_sync(0xffffffffu, n_node);
  const unsigned int w_leaf = __reduce_add_sync(0xffffffffu, n_leaf);
  const unsigned int w_tri = __reduce_add_sync(0xffffffffu, n_tri);
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(&block_counts[0], (unsigned long long)w_node);
    atomicAdd(&block_counts[1], (unsigned long long)w_leaf);
    atomicAdd(&block_counts[2], (unsigned long long)w_tri);
  }
  __syncthreads();
  if (threadIdx.x < 3) atomicAdd(&counts[threadIdx.x], block_counts[threadIdx.x]);
}

template <bool kAnyHit, bool kResume>
void launch(const float* feats, int n, const float* node, const float* leaf,
            int leaf_w, int max_leaf, int m, int T, int max_loads,
            const int32_t* cursor_in, const float* best_t_in,
            const int32_t* best_tri_in, int32_t* cursor_out, float* best_t_out,
            int32_t* best_tri_out, int32_t* visits_out,
            unsigned long long* counts, cudaStream_t stream) {
  const int blocks = (n + kBlock - 1) / kBlock;
  treelet_walk<kAnyHit, kResume><<<blocks, kBlock, 0, stream>>>(
      feats, n, reinterpret_cast<const float4*>(node), leaf, leaf_w, max_leaf,
      m, T, max_loads, cursor_in, best_t_in, best_tri_in, cursor_out,
      best_t_out, best_tri_out, visits_out, counts);
}

}  // namespace

extern "C" int treelet_walk_launch(
    const float* feats, int n, const float* node, const float* leaf,
    int leaf_w, int max_leaf, int m, int T, int max_loads, int any_hit,
    int resume, const int32_t* cursor_in, const float* best_t_in,
    const int32_t* best_tri_in, int32_t* cursor_out, float* best_t_out,
    int32_t* best_tri_out, int32_t* visits_out, long long* counts,
    void* stream) {
  if (max_leaf < 1 || max_leaf > kMaxLeaf || T < 1 || max_loads < 0)
    return (int)cudaErrorInvalidValue;
  auto* c = reinterpret_cast<unsigned long long*>(counts);
  auto s = (cudaStream_t)stream;
  if (resume) {
    if (any_hit)
      launch<true, true>(feats, n, node, leaf, leaf_w, max_leaf, m, T,
                         max_loads, cursor_in, best_t_in, best_tri_in,
                         cursor_out, best_t_out, best_tri_out, visits_out, c,
                         s);
    else
      launch<false, true>(feats, n, node, leaf, leaf_w, max_leaf, m, T,
                          max_loads, cursor_in, best_t_in, best_tri_in,
                          cursor_out, best_t_out, best_tri_out, visits_out, c,
                          s);
  } else {
    if (any_hit)
      launch<true, false>(feats, n, node, leaf, leaf_w, max_leaf, m, T, 0,
                          nullptr, nullptr, nullptr, nullptr, best_t_out,
                          best_tri_out, visits_out, c, s);
    else
      launch<false, false>(feats, n, node, leaf, leaf_w, max_leaf, m, T, 0,
                           nullptr, nullptr, nullptr, nullptr, best_t_out,
                           best_tri_out, visits_out, c, s);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* treelet_kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Cluster-culled brute-force ray-triangle intersection for NVIDIA Hopper
// (sm_90a): nearest hit or any hit.
//
// Replaces the two TPU kernels of light_transport_tpu/ops/pallas/
// intersect_kernel.py:
//   * `_kernel` (K3): the dense (ray tile x triangle cluster) grid that
//     skips the pairs a per-tile cull mask rejects -> intersect_dense_kernel;
//   * `_gather_kernel` (K4): K3's math over each ray tile's compacted list
//     of admitted cluster ids -> intersect_gather_kernel.
// Both entry points share one device function and one launch interface.
//
// What they compute.  Moller-Trumbore as four dot products of a ray's
// features [d, o x d, o, 1] with a triangle's packed weight columns
// (ops/intersect_kernel.pack_tri_weights): det, u*det, v*det, t*det.  A hit
// needs |det| > 1e-12, u >= 0, v >= 0, u + v <= 1 and t_min < t < t_max;
// each ray keeps the nearest, the lowest triangle index winning a tie
// (clusters in ascending order, triangles in ascending order, strict <).
// The TPU kernels ran the dots as (R,16)x(16,2048) f32 HIGHEST matmuls and
// kept a running minimum per lane column; here each thread runs the dots
// element by element in the fixed order of the plain PyTorch version
// (ops/intersect_kernel._cluster_hits), all in FP32 on the CUDA cores: no
// tensor cores, TF32 or bf16 (bf16 passes put 9 % of silhouette rays on
// the wrong triangle on the TPU).
//
// Design.  One CUDA block is one 128-ray tile (the TPU's RAY_TILE, so the
// cull masks agree tile for tile); one thread is one ray, its ten features
// and running minimum in registers.  For each admitted 512-triangle cluster
// the block stages the 19 non-zero weight rows (of 64) into 38 KB of shared
// memory, then every thread walks the 512 triangles; all threads read the
// same address at once, a broadcast.  In any-hit mode a ray stops testing
// at its first hit and the block leaves once every ray has one.
//
// What bounds it.  Operations: each ray-triangle pair costs 22
// multiplies, 16 adds, a divide and six compares from registers and shared
// memory; device memory sees each cluster's 38 KB once per admitted tile
// (L2-resident for all but the largest meshes).  The cull decides the
// pairs: camera tiles admit a few clusters, incoherent bounce tiles many.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -fmad=false.  No FMA contraction: PyTorch rounds
//        every product, and the kernel is held to it triangle for triangle.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRayTile = 128;
constexpr int kTriTile = 512;
constexpr int kBlocks = 4;     // det, u, v, t weight blocks
constexpr int kFeat = 16;      // feature width of the packed weights
constexpr int kStaged = 19;    // non-zero weight rows staged per cluster
constexpr float kBig = 3.0e38f;
constexpr float kDetEps = 1e-12f;

// Staged row sr of the shared buffer <- (feature row, weight block):
// det rows 0-2 of block 0, u rows 0-5 of block 1, v rows 0-5 of block 2,
// t rows 6-9 of block 3.
__device__ __forceinline__ void staged_source(int sr, int& row, int& blk) {
  if (sr < 3) {
    row = sr;
    blk = 0;
  } else if (sr < 9) {
    row = sr - 3;
    blk = 1;
  } else if (sr < 15) {
    row = sr - 9;
    blk = 2;
  } else {
    row = sr - 15 + 6;
    blk = 3;
  }
}

// w: (C, 16, 4 * 512) f32, w[c][r][b * 512 + k] = weight row r of block b
// for triangle c * 512 + k.
__device__ __forceinline__ void stage_cluster(const float* __restrict__ w,
                                              int cid, float* s) {
  const float* wc = w + (size_t)cid * kFeat * kBlocks * kTriTile;
  for (int i = threadIdx.x; i < kStaged * kTriTile; i += blockDim.x) {
    int row, blk;
    staged_source(i / kTriTile, row, blk);
    s[i] = wc[row * kBlocks * kTriTile + blk * kTriTile + i % kTriTile];
  }
}

__device__ __forceinline__ void test_cluster(const float* s, const float* f,
                                             float tmin, float tmax, int base,
                                             bool any_hit, float& best_t,
                                             int& best_tri) {
  const float* sd = s;
  const float* su = s + 3 * kTriTile;
  const float* sv = s + 9 * kTriTile;
  const float* st = s + 15 * kTriTile;
  for (int k = 0; k < kTriTile; ++k) {
    const float det = (f[0] * sd[k] + f[1] * sd[kTriTile + k])
                      + f[2] * sd[2 * kTriTile + k];
    float un = f[0] * su[k] + f[1] * su[kTriTile + k];
    un = un + f[2] * su[2 * kTriTile + k];
    un = un + f[3] * su[3 * kTriTile + k];
    un = un + f[4] * su[4 * kTriTile + k];
    un = un + f[5] * su[5 * kTriTile + k];
    float vn = f[0] * sv[k] + f[1] * sv[kTriTile + k];
    vn = vn + f[2] * sv[2 * kTriTile + k];
    vn = vn + f[3] * sv[3 * kTriTile + k];
    vn = vn + f[4] * sv[4 * kTriTile + k];
    vn = vn + f[5] * sv[5 * kTriTile + k];
    float tn = f[6] * st[k] + f[7] * st[kTriTile + k];
    tn = tn + f[8] * st[2 * kTriTile + k];
    tn = tn + f[9] * st[3 * kTriTile + k];
    const bool ok = fabsf(det) > kDetEps;
    const float inv = ok ? 1.0f / det : 0.0f;
    const float u = un * inv;
    const float v = vn * inv;
    const float t = tn * inv;
    const bool valid = ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f &&
                       t > tmin && t < tmax;
    if (valid && t < best_t) {
      best_t = t;
      best_tri = base + k;
      if (any_hit) return;
    }
  }
}

// kGather = false: `list` is the (tiles, C) int32 cull mask and every
// cluster is visited in order, the rejected ones skipped.  kGather = true:
// `list` holds each tile's admitted cluster ids, ascending, `cnt` of them.
template <bool kGather>
__global__ void __launch_bounds__(kRayTile)
    intersect_kernel(const float* __restrict__ feats,
                     const float* __restrict__ tminmax,
                     const float* __restrict__ w,
                     const int32_t* __restrict__ list,
                     const int32_t* __restrict__ cnt, int n_clusters,
                     int any_hit, float* __restrict__ out_t,
                     int32_t* __restrict__ out_tri) {
  __shared__ float s[kStaged * kTriTile];
  const int tile = blockIdx.x;
  const size_t ray = (size_t)tile * kRayTile + threadIdx.x;
  float f[10];
#pragma unroll
  for (int k = 0; k < 10; ++k) f[k] = feats[ray * kFeat + k];
  const float tmin = tminmax[2 * ray];
  const float tmax = tminmax[2 * ray + 1];
  float best_t = kBig;
  int best_tri = -1;
  const int32_t* row = list + (size_t)tile * n_clusters;
  const int n = kGather ? cnt[tile] : n_clusters;
  for (int k = 0; k < n; ++k) {
    if (!kGather && row[k] == 0) continue;  // uniform across the block
    const int cid = kGather ? row[k] : k;
    // one barrier: the previous cluster's readers are done, and in any-hit
    // mode the tile leaves once every ray has its hit
    if (__syncthreads_and(any_hit && best_tri >= 0)) break;
    stage_cluster(w, cid, s);
    __syncthreads();
    if (!(any_hit && best_tri >= 0))
      test_cluster(s, f, tmin, tmax, cid * kTriTile, any_hit != 0, best_t,
                   best_tri);
  }
  out_t[ray] = best_t;
  out_tri[ray] = best_tri;
}

}  // namespace

extern "C" int intersect_dense_launch(const float* feats,
                                      const float* tminmax, const float* w,
                                      const int32_t* mask, int n_tiles,
                                      int n_clusters, int any_hit,
                                      float* out_t, int32_t* out_tri,
                                      void* stream) {
  intersect_kernel<false><<<n_tiles, kRayTile, 0, (cudaStream_t)stream>>>(
      feats, tminmax, w, mask, nullptr, n_clusters, any_hit, out_t, out_tri);
  return (int)cudaGetLastError();
}

extern "C" int intersect_gather_launch(const float* feats,
                                       const float* tminmax, const float* w,
                                       const int32_t* ids, const int32_t* cnt,
                                       int n_tiles, int n_clusters,
                                       int any_hit, float* out_t,
                                       int32_t* out_tri, void* stream) {
  intersect_kernel<true><<<n_tiles, kRayTile, 0, (cudaStream_t)stream>>>(
      feats, tminmax, w, ids, cnt, n_clusters, any_hit, out_t, out_tri);
  return (int)cudaGetLastError();
}

extern "C" const char* intersect_kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

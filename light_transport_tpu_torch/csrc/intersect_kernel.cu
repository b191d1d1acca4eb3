// Cluster-culled brute-force ray-triangle intersection for NVIDIA Hopper
// (sm_90a): nearest hit or any hit, and the cull that feeds it.
//
// Replaces the two TPU kernels of light_transport_tpu/ops/pallas/
// intersect_kernel.py and the XLA cull in front of the second:
//   * `_kernel` (K3): the dense (ray tile x triangle cluster) grid that
//     skips the pairs a per-tile cull mask rejects -> intersect_dense_kernel,
//     which runs the cull itself;
//   * `_gather_kernel` (K4): K3's math over each ray tile's compacted list
//     of admitted cluster ids -> intersect_gather_kernel;
//   * `_tile_cluster_mask` and the argsort that compacts it (XLA ops,
//     :276) -> tile_cull_kernel, which writes K4's id lists directly.
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
// K4.  What bounds it is instruction throughput: each ray-triangle test
// is ~60 FP32 instructions from registers plus its weights from shared
// memory, and 19 scalar shared loads per test (the (C, 16, 2048) weight
// layout) cap a 132-SM card near 1.7 tests per SM-clock.  So the weights
// come as
// triangle-major records (ops/intersect_kernel.cluster_records, built once
// per scene): 20 floats a triangle, five 128-bit broadcast loads a test.
// A block is one (ray tile, chunk of at most `chunk` admitted clusters);
// blocks past a tile's count leave at once, so a tile that admits many
// clusters spreads over many SMs.  Thread 0 streams the chunk's clusters
// in 128-triangle pieces (10,240 B) through a ring of kStages
// shared-memory stages by TMA (cp.async.bulk completing an mbarrier), so
// piece p + 1 arrives while piece p is tested; the ring's 20 KB leave room
// for 10 blocks (40 warps) per SM at 47 registers a thread.  Blocks merge
// through one 64-bit atomicMin per ray on the key (order-preserving bits
// of t) << 32 | triangle index: the lexicographic minimum of (t, index) is
// exactly the sequential strict-< scan over ascending clusters.  The
// caller unpacks the keys.
//
// K3 (below 16 clusters: 49 to 7,680 triangles).  The TPU kernel ran one
// grid step per (tile, cluster) behind a mask computed by XLA ops.  Here
// one launch does the cull and the tests: block (tile, y) takes
// `pieces` consecutive 128-triangle pieces of one cluster (K4's records),
// so the glass preset's 313 tiles x 1 cluster make 1,252 blocks of 128
// tests a thread at one piece a block, where one block a tile made 313
// blocks of 512 serial tests (~9.5 warps an SM, latency-bound).  Each
// block first runs its rays' slab test against its cluster's box
// (tile_cull_kernel's arithmetic) and leaves unless one of them enters
// (__syncthreads_or): it admits exactly the plain mask's pairs.  Rays with
// an empty interval (inactive lanes) test nothing, and a block whose rays
// all have nothing to test leaves.  Thread 0 then copies each piece
// (10,240 B) into shared memory by one cp.async.bulk on an mbarrier of its
// own, and every thread tests it by broadcast loads, as K4 does: on an
// H100 this ran 25-35 % faster than every thread reading the records
// through L1 (chip_smoke.py phase 9, a build that had both).  The pieces
// merge by K4's keys, so K3 is bitwise the sequential scan.  Any hit: a
// thread stops at its first hit, and rays another block has hit test no
// more.  At one piece a block it holds 42 registers a thread, 10 resident
// blocks per SM.
//
// The cull.  One block per 128-ray tile, one thread per ray: each thread
// runs its ray's slab test against every cluster box, the boxes read as
// broadcasts from shared memory in pieces of 512; a tile admits a cluster
// if any of its rays does (warp OR-reduction, then an OR in shared
// memory).  It writes each tile's admitted ids, ascending, and their
// count.  Its arithmetic is the plain version's (tile_cluster_mask) op for
// op; min.NaN / max.NaN propagate a NaN as torch.minimum and amax do, so a
// NaN admits exactly what it admits there (nothing).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -fmad=false.  No FMA contraction: PyTorch rounds
//        every product, and the kernels are held to it triangle for
//        triangle.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRayTile = 128;
constexpr int kTriTile = 512;
constexpr int kFeat = 16;      // feature width of a ray
constexpr float kBig = 3.0e38f;
constexpr float kDetEps = 1e-12f;

// K4's records and ring; K3's pieces
constexpr int kRecFloats = 20;               // 19 weights and a pad
constexpr int kRecVecs = kRecFloats / 4;     // float4 loads per record
constexpr int kPieceTris = 128;              // triangles per piece
constexpr int kPieces = kTriTile / kPieceTris;
constexpr int kStages = 2;
constexpr uint32_t kPieceBytes = kPieceTris * kRecFloats * sizeof(float);
constexpr int kRingBytes = kStages * kPieceBytes;
constexpr long long kNoHit = 0x7fffffffffffffffLL;

// the cull's boxes staged per round
constexpr int kBoxPiece = 512;
constexpr int kBoxWords = kBoxPiece / 32;

// ---------------------------------------------------------------------------
// mbarrier and TMA bulk copy (as csrc/probe_kernels.cu's P3/P5/P6)
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
// The cull
// ---------------------------------------------------------------------------

// torch.minimum / torch.maximum: a NaN operand gives NaN
__device__ __forceinline__ float min_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// A ray's origin and the reciprocals of its direction, each component of
// magnitude below 1e-20 replaced by +-1e-20 (tile_cluster_mask's guard).
__device__ __forceinline__ void slab_ray(const float* fr, float* o,
                                         float* inv) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float d = fr[i];
    o[i] = fr[6 + i];
    inv[i] = 1.0f / (fabsf(d) < 1e-20f ? (d < 0.0f ? -1e-20f : 1e-20f) : d);
  }
}

// Does the ray enter the box lo-hi within [tmin, tmax]?  tile_cluster_mask
// op for op.
__device__ __forceinline__ bool slab_enters(const float* o, const float* inv,
                                            float lx, float ly, float lz,
                                            float hx, float hy, float hz,
                                            float tmin, float tmax) {
  const float t1x = (lx - o[0]) * inv[0], t2x = (hx - o[0]) * inv[0];
  const float t1y = (ly - o[1]) * inv[1], t2y = (hy - o[1]) * inv[1];
  const float t1z = (lz - o[2]) * inv[2], t2z = (hz - o[2]) * inv[2];
  const float tn = max_nan(max_nan(min_nan(t1x, t2x), min_nan(t1y, t2y)),
                           min_nan(t1z, t2z));
  const float tf = min_nan(min_nan(max_nan(t1x, t2x), max_nan(t1y, t2y)),
                           max_nan(t1z, t2z));
  return tn <= tf && tf >= tmin && tn <= tmax;
}

// c_lo, c_hi: (C, 3) box corners.  ids: (tiles, C), of which each tile's
// first cnt[tile] entries are written: its admitted ids, ascending.
// counts: null, or two int64 counters to which each block adds its tile's
// admitted count and its rays with tmax > tmin.
__global__ void __launch_bounds__(kRayTile)
    tile_cull_kernel(const float* __restrict__ feats,
                     const float* __restrict__ tminmax,
                     const float* __restrict__ c_lo,
                     const float* __restrict__ c_hi, int n_clusters,
                     int32_t* __restrict__ ids, int32_t* __restrict__ cnt,
                     unsigned long long* __restrict__ counts) {
  __shared__ float4 box[2 * kBoxPiece];  // (lo.xyz, hi.x), (hi.yz, -, -)
  __shared__ unsigned words[kBoxWords];  // admitted bits of the piece
  const int tile = blockIdx.x;
  const size_t ray = (size_t)tile * kRayTile + threadIdx.x;
  float o[3], inv[3];
  slab_ray(feats + ray * kFeat, o, inv);
  const float tmin = tminmax[2 * ray];
  const float tmax = tminmax[2 * ray + 1];
  int32_t* out = ids + (size_t)tile * n_clusters;
  int n_adm = 0;  // the same in every thread
  for (int c0 = 0; c0 < n_clusters; c0 += kBoxPiece) {
    const int nb = min(kBoxPiece, n_clusters - c0);
    for (int j = threadIdx.x; j < nb; j += kRayTile) {
      const float* lo = c_lo + (size_t)(c0 + j) * 3;
      const float* hi = c_hi + (size_t)(c0 + j) * 3;
      box[2 * j] = make_float4(lo[0], lo[1], lo[2], hi[0]);
      box[2 * j + 1] = make_float4(hi[1], hi[2], 0.0f, 0.0f);
    }
    if (threadIdx.x < kBoxWords) words[threadIdx.x] = 0u;
    __syncthreads();
    for (int j0 = 0; j0 < nb; j0 += 32) {
      const int jn = min(32, nb - j0);
      unsigned bits = 0u;
      for (int b = 0; b < jn; ++b) {
        const float4 p = box[2 * (j0 + b)];
        const float4 q = box[2 * (j0 + b) + 1];
        if (slab_enters(o, inv, p.x, p.y, p.z, p.w, q.x, q.y, tmin, tmax))
          bits |= 1u << b;
      }
      bits = __reduce_or_sync(0xffffffffu, bits);
      if ((threadIdx.x & 31) == 0 && bits) atomicOr(&words[j0 / 32], bits);
    }
    __syncthreads();
    // compaction: thread i writes boxes i, i + 128, ... of the piece at
    // their rank among the admitted
    int before = 0, total = 0;
    for (int w = 0; w < kBoxWords; ++w) total += __popc(words[w]);
    for (int j = threadIdx.x, w = 0; j < nb; j += kRayTile) {
      for (; w < j / 32; ++w) before += __popc(words[w]);
      const unsigned word = words[j / 32];
      if ((word >> (j % 32)) & 1u)
        out[n_adm + before + __popc(word & ((1u << (j % 32)) - 1u))] = c0 + j;
    }
    n_adm += total;
    __syncthreads();  // the next piece overwrites box and words
  }
  if (threadIdx.x == 0) cnt[tile] = n_adm;
  if (counts != nullptr) {  // the same in every thread of the block
    const int live = __syncthreads_count(tmax > tmin);
    if (threadIdx.x == 0) {
      atomicAdd(&counts[0], (unsigned long long)n_adm);
      atomicAdd(&counts[1], (unsigned long long)live);
    }
  }
}

// ---------------------------------------------------------------------------
// K4: the gather kernel
// ---------------------------------------------------------------------------

// Key of a hit: the order-preserving bits of t (-0 read as +0) above the
// triangle index; as int64 the keys order as (t, index).
__device__ __forceinline__ long long hit_key(float t, int tri) {
  const int b = __float_as_int(t == 0.0f ? 0.0f : t);
  const unsigned s = static_cast<unsigned>(b < 0 ? b ^ 0x7fffffff : b);
  return static_cast<long long>((static_cast<unsigned long long>(s) << 32) |
                                static_cast<unsigned>(tri));
}

// One record r (five float4s): sd0 sd1 sd2 su0 | su1 su2 su3 su4 |
// su5 sv0 sv1 sv2 | sv3 sv4 sv5 st0 | st1 st2 st3 pad, the plain version's
// operations (ops/intersect_kernel._cluster_hits) in its order.  Returns
// valid; t in `t`.
__device__ __forceinline__ bool test_record(const float4* r, const float* f,
                                            float tmin, float tmax, float& t) {
  const float4 a = r[0], b = r[1], c = r[2], d = r[3], e = r[4];
  const float det = (f[0] * a.x + f[1] * a.y) + f[2] * a.z;
  float un = f[0] * a.w + f[1] * b.x;
  un = un + f[2] * b.y;
  un = un + f[3] * b.z;
  un = un + f[4] * b.w;
  un = un + f[5] * c.x;
  float vn = f[0] * c.y + f[1] * c.z;
  vn = vn + f[2] * c.w;
  vn = vn + f[3] * d.x;
  vn = vn + f[4] * d.y;
  vn = vn + f[5] * d.z;
  float tn = f[6] * d.w + f[7] * e.x;
  tn = tn + f[8] * e.y;
  tn = tn + f[9] * e.z;
  const bool ok = fabsf(det) > kDetEps;
  const float inv = ok ? 1.0f / det : 0.0f;
  const float u = un * inv;
  const float v = vn * inv;
  t = tn * inv;
  return ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > tmin &&
         t < tmax;
}

// Thread 0: piece p of the chunk (cluster list[p / kPieces], its triangles
// (p % kPieces) * kPieceTris on) into ring stage p % kStages by TMA.
__device__ __forceinline__ void load_piece(int p, const int32_t* list,
                                           int n_clusters,
                                           const float* __restrict__ recs,
                                           float4* ring, uint64_t* full) {
  const int cid = list[p / kPieces];
  if (cid < 0 || cid >= n_clusters) __trap();
  const float* src = recs + ((size_t)cid * kTriTile +
                             (size_t)(p % kPieces) * kPieceTris) * kRecFloats;
  const int s = p % kStages;
  bulk_load(ring + (size_t)s * kPieceTris * kRecVecs, src, kPieceBytes,
            &full[s]);
}

// recs: (C, 512, 20) triangle-major records.  Block (tile, y) tests the
// tile's admitted clusters y * chunk ... y * chunk + chunk - 1 and merges
// each ray's nearest (any-hit: first) hit into keys[ray] (kNoHit on entry).
__global__ void __launch_bounds__(kRayTile)
    intersect_gather_kernel(const float* __restrict__ feats,
                            const float* __restrict__ tminmax,
                            const float* __restrict__ recs,
                            const int32_t* __restrict__ ids,
                            const int32_t* __restrict__ cnt, int n_clusters,
                            int chunk, int any_hit,
                            long long* __restrict__ keys) {
  extern __shared__ __align__(128) float4 ring[];  // kStages pieces
  __shared__ __align__(8) uint64_t full[kStages];
  const int tile = blockIdx.x;
  const int first = blockIdx.y * chunk;
  const int n_tile = cnt[tile];
  if (first >= n_tile) return;  // uniform: past the tile's list
  const int n_pieces = min(chunk, n_tile - first) * kPieces;
  const int32_t* list = ids + (size_t)tile * n_clusters + first;
  if (threadIdx.x == 0)
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s]);
  __syncthreads();
  if (threadIdx.x == 0)
    for (int p = 0; p < kStages && p < n_pieces; ++p)
      load_piece(p, list, n_clusters, recs, ring, full);
  const size_t ray = (size_t)tile * kRayTile + threadIdx.x;
  float f[10];
#pragma unroll
  for (int k = 0; k < 10; ++k) f[k] = feats[ray * kFeat + k];
  const float tmin = tminmax[2 * ray];
  const float tmax = tminmax[2 * ray + 1];
  float best_t = kBig;
  int best_tri = -1;
  bool done = false;  // any-hit mode: this ray has a hit
  for (int p = 0; p < n_pieces; ++p) {
    const int s = p % kStages;
    // any-hit mode: a ray another block has already hit tests no more
    if (any_hit && !done && p % kPieces == 0)
      done = *reinterpret_cast<volatile long long*>(keys + ray) != kNoHit;
    mbar_wait(&full[s], (p / kStages) & 1);
    if (!done) {
      const float4* r = ring + (size_t)s * kPieceTris * kRecVecs;
      const int base =
          list[p / kPieces] * kTriTile + (p % kPieces) * kPieceTris;
#pragma unroll 2
      for (int k = 0; k < kPieceTris; ++k) {
        float t;
        if (test_record(r + k * kRecVecs, f, tmin, tmax, t) && t < best_t) {
          best_t = t;
          best_tri = base + k;
          if (any_hit) {
            done = true;
            break;
          }
        }
      }
    }
    // every thread is past stage s; in any-hit mode the block leaves once
    // every ray has a hit (done stays false in nearest mode)
    if (__syncthreads_and(done)) {
      // the copies in flight must land before the block's shared memory
      // is released
      if (threadIdx.x == 0)
        for (int q = p + 1; q < p + kStages && q < n_pieces; ++q)
          mbar_wait(&full[q % kStages], (q / kStages) & 1);
      break;
    }
    if (threadIdx.x == 0 && p + kStages < n_pieces)
      load_piece(p + kStages, list, n_clusters, recs, ring, full);
  }
  if (best_tri >= 0) atomicMin(keys + ray, hit_key(best_t, best_tri));
}

// ---------------------------------------------------------------------------
// K3: the dense kernel
// ---------------------------------------------------------------------------

// recs: (C, 512, 20) triangle-major records; c_lo, c_hi: (C, 3) boxes.
// Block (tile, y) takes pieces y * pieces ... y * pieces + pieces - 1 of
// the C * kPieces (pieces divides kPieces: one cluster a block), copied
// into `staged` by TMA, and merges each ray's nearest (any-hit: first)
// hit into keys[ray] (kNoHit on entry).
__global__ void __launch_bounds__(kRayTile)
    intersect_dense_kernel(const float* __restrict__ feats,
                           const float* __restrict__ tminmax,
                           const float* __restrict__ recs,
                           const float* __restrict__ c_lo,
                           const float* __restrict__ c_hi, int pieces,
                           int any_hit, long long* __restrict__ keys) {
  extern __shared__ __align__(128) float4 staged[];  // `pieces` pieces
  __shared__ __align__(8) uint64_t full[kPieces];
  const int tile = blockIdx.x;
  const int p0 = blockIdx.y * pieces;  // first piece, of the mesh's
  const int cid = p0 / kPieces;
  const size_t ray = (size_t)tile * kRayTile + threadIdx.x;
  const float* fr = feats + ray * kFeat;
  const float tmin = tminmax[2 * ray];
  const float tmax = tminmax[2 * ray + 1];
  // the cull: the block runs only if one of its rays enters the box
  {
    float o[3], inv[3];
    slab_ray(fr, o, inv);
    const float* lo = c_lo + (size_t)cid * 3;
    const float* hi = c_hi + (size_t)cid * 3;
    if (!__syncthreads_or(slab_enters(o, inv, lo[0], lo[1], lo[2], hi[0],
                                      hi[1], hi[2], tmin, tmax)))
      return;
  }
  // an empty interval (an inactive lane) holds no hit; in any-hit mode a
  // ray another block has hit needs no more
  bool done = !(tmin < tmax);
  if (any_hit && !done)
    done = *reinterpret_cast<volatile long long*>(keys + ray) != kNoHit;
  if (__syncthreads_and(done)) return;
  if (threadIdx.x == 0)
    for (int q = 0; q < pieces; ++q) {
      mbar_init(&full[q]);
      bulk_load(staged + (size_t)q * kPieceTris * kRecVecs,
                recs + (size_t)(p0 + q) * kPieceTris * kRecFloats,
                kPieceBytes, &full[q]);
    }
  __syncthreads();  // the barriers exist before anyone waits on them
  float f[10];
#pragma unroll
  for (int k = 0; k < 10; ++k) f[k] = fr[k];
  float best_t = kBig;
  int best_tri = -1;
  for (int q = 0; q < pieces; ++q) {
    if (any_hit && !done && q > 0)
      done = *reinterpret_cast<volatile long long*>(keys + ray) != kNoHit;
    // thread 0 waits for every copy: they must land before the block's
    // shared memory is released
    if (!done || threadIdx.x == 0) mbar_wait(&full[q], 0);
    if (done) continue;
    const float4* r = staged + (size_t)q * kPieceTris * kRecVecs;
    const int base = (p0 + q) * kPieceTris;
#pragma unroll 2
    for (int k = 0; k < kPieceTris; ++k) {
      float t;
      if (test_record(r + k * kRecVecs, f, tmin, tmax, t) && t < best_t) {
        best_t = t;
        best_tri = base + k;
        if (any_hit) {
          done = true;
          break;
        }
      }
    }
  }
  if (best_tri >= 0) atomicMin(keys + ray, hit_key(best_t, best_tri));
}

}  // namespace

// keys: (n_tiles * 128,) int64, kNoHit on entry.  pieces: 1, 2 or 4.
extern "C" int intersect_dense_launch(const float* feats,
                                      const float* tminmax, const float* recs,
                                      const float* c_lo, const float* c_hi,
                                      int n_tiles, int n_clusters, int pieces,
                                      int any_hit, long long* keys,
                                      void* stream) {
  if (pieces < 1 || kPieces % pieces != 0 ||
      n_clusters * (kPieces / pieces) > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(n_tiles, n_clusters * (kPieces / pieces));
  intersect_dense_kernel<<<grid, kRayTile, pieces * kPieceBytes,
                           (cudaStream_t)stream>>>(
      feats, tminmax, recs, c_lo, c_hi, pieces, any_hit, keys);
  return (int)cudaGetLastError();
}

// K3's resident blocks per SM at its block size and `pieces` pieces of
// shared memory.
extern "C" int intersect_dense_blocks_per_sm(int pieces, int* blocks) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, intersect_dense_kernel, kRayTile, pieces * kPieceBytes);
}

// counts: null, or (2,) int64 added to (see tile_cull_kernel).
extern "C" int tile_cull_launch(const float* feats, const float* tminmax,
                                const float* c_lo, const float* c_hi,
                                int n_tiles, int n_clusters, int32_t* ids,
                                int32_t* cnt, long long* counts,
                                void* stream) {
  tile_cull_kernel<<<n_tiles, kRayTile, 0, (cudaStream_t)stream>>>(
      feats, tminmax, c_lo, c_hi, n_clusters, ids, cnt,
      reinterpret_cast<unsigned long long*>(counts));
  return (int)cudaGetLastError();
}

// keys: (n_tiles * 128,) int64, kNoHit on entry.
extern "C" int intersect_gather_launch(const float* feats,
                                       const float* tminmax, const float* recs,
                                       const int32_t* ids, const int32_t* cnt,
                                       int n_tiles, int n_clusters, int chunk,
                                       int any_hit, long long* keys,
                                       void* stream) {
  const int n_chunks = chunk > 0 ? (n_clusters + chunk - 1) / chunk : 0;
  if (chunk < 1 || n_chunks > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(n_tiles, n_chunks);
  intersect_gather_kernel<<<grid, kRayTile, kRingBytes,
                            (cudaStream_t)stream>>>(
      feats, tminmax, recs, ids, cnt, n_clusters, chunk, any_hit, keys);
  return (int)cudaGetLastError();
}

// K4's resident blocks per SM at its block size and ring.
extern "C" int intersect_gather_blocks_per_sm(int* blocks) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, intersect_gather_kernel, kRayTile, kRingBytes);
}

extern "C" const char* intersect_kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Fused MCML photon block for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel light_transport_tpu/ops/pallas/photon_kernel.py
// `_make_kernel` -> `kernel_body` (the fused hop-drop-spin superstep) and
// its in-kernel histogram flush `_onehot_pair_flush` (the bf16 hi/lo one-hot
// contractions that fold per-lane records into the (r,z) grid, the detector
// image and the exit-by-radius table).
//
// Design.  One thread is one photon lane; its state (position, direction,
// weight, leftover optical depth, layer) stays in registers for all k_steps
// supersteps, so device memory sees 36 bytes per lane read and written once
// per block.  One CUDA block is one tile of `tile_lanes` lanes: the quota
// respawn ranks the tile's dead lanes in lane order with a warp-shuffle scan
// plus shared memory (the TPU kernel used triangular matmuls for the same
// prefix sum).  Uniforms come from an in-kernel Philox4x32-10, counter
// (global lane, block index, draw >> 2), word draw & 3; a caller may hand
// pre-drawn uniforms instead (`u`, shape (n_draws, lanes)).
//
// Tallies.  The TPU kernel staged deposit and exit records and flushed them
// as one-hot matmuls; here each record is an atomicAdd at the event: float
// into the (r,z) grid, the volume and the detector, double into the exit
// tables.  The sums equal the TPU kernel's up to float reassociation.
//
// What bounds it.  Per-lane arithmetic: each live step costs one log1pf, one
// cosf, two sqrtf, several divides, two Philox evaluations (20 rounds of
// 32-bit multiplies) and the frame rotation, in lanes that diverge between
// the scatter and the boundary branch.  Device-memory bytes are negligible.
// The second cost is the atomics: every photon starts at r = 0, so the first
// (r,z) and volume bins are hot spots that serialize in L2.  Warp-aggregated
// or shared-memory-privatised atomics would address that; this first kernel
// keeps the plain form.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -fmad=false.  No fast math: log1pf, cosf, sqrtf and
//        the divides stay the accurate ones PyTorch's CUDA kernels use.  No
//        FMA contraction: PyTorch rounds every product, so with contraction
//        an ulp of difference, amplified where the step is ill-conditioned
//        (sqrt(1 - cos^2) near cos = +-1, grazing refraction), moved ~0.1 %
//        of lanes past rtol 1e-4 within one 32-step block.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define MAX_LAYERS 8

struct MediumTab {
  int num_layers;
  float mu_t[MAX_LAYERS];
  float inv_mu_t[MAX_LAYERS];
  float albedo_a[MAX_LAYERS];
  float g[MAX_LAYERS];
  float one_m_g2[MAX_LAYERS];
  float one_p_g2[MAX_LAYERS];
  float inv_2g[MAX_LAYERS];
  float z_top[MAX_LAYERS];
  float z_bot[MAX_LAYERS];
  float eta_dn[MAX_LAYERS];
  float eta_up[MAX_LAYERS];
  float w0;
};

struct BlockParams {
  int lanes, tile_lanes, k_steps, stride, vol_stride, respawn_windows;
  int bench_mode, n_phase, sep_vol_phase;
  int nr, nz, det_nx, vol_nx, vol_ny, vol_nz, block_index;
  float inv_dr, inv_dz, det_half, det_scale, inv_vdx, inv_vdy, inv_vdz;
  float half_vnx, half_vny, wthresh, rr_surv, inv_rr;
  double r_sp;
  uint64_t seed;
};

static __device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                                      uint32_t k1) {
  const uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
  const uint32_t W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint32_t hi0 = __umulhi(M0, c.x), lo0 = M0 * c.x;
    const uint32_t hi1 = __umulhi(M1, c.z), lo1 = M1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
    k0 += W0;
    k1 += W1;
  }
  return c;
}

// uniform in [0, 1) from the 24 high bits of a 32-bit word
static __device__ __forceinline__ float u01(uint32_t bits) {
  return (float)(bits >> 8) * 5.9604644775390625e-08f;
}

// word i (0..7) of the two consecutive Philox groups a, b
static __device__ __forceinline__ uint32_t pick(uint4 a, uint4 b, int i) {
  const uint4 v = i < 4 ? a : b;
  const int j = i & 3;
  return j == 0 ? v.x : (j == 1 ? v.y : (j == 2 ? v.z : v.w));
}

// truncating float -> bin, clipped to [0, n-1] (clamped in float first)
static __device__ __forceinline__ int bin_of(float v, int n) {
  return (int)fminf(fmaxf(v, 0.f), (float)(n - 1));
}

// inclusive block-wide prefix sum of v over threads in lane order; `total`
// receives the block sum.  Every thread of the block must call it.
static __device__ int block_scan(int v, int* warp_tot, int& total) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += t;
  }
  if (lane == 31) warp_tot[wid] = v;
  __syncthreads();
  if (wid == 0) {
    int t = lane < nw ? warp_tot[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int s = __shfl_up_sync(0xffffffffu, t, o);
      if (lane >= o) t += s;
    }
    warp_tot[lane] = t;
  }
  __syncthreads();
  const int incl = v + (wid > 0 ? warp_tot[wid - 1] : 0);
  total = warp_tot[nw - 1];
  __syncthreads();
  return incl;
}

struct Lane {
  float x, y, z, ux, uy, uz, w, tau;
  int layer;
  int launches;

  __device__ __forceinline__ void launch(float w0) {
    x = y = z = 0.f;
    ux = uy = 0.f;
    uz = 1.f;
    w = w0;
    tau = 0.f;
    layer = 0;
    ++launches;
  }
};

// quota-ranked respawn of the tile's dead (and eligible) lanes
static __device__ __forceinline__ void quota_respawn(Lane& L, bool eligible,
                                                     int& quota, float w0,
                                                     int* warp_tot) {
  const bool dead = (L.w <= 0.f) && eligible;
  int total;
  const int rank = block_scan(dead ? 1 : 0, warp_tot, total);
  if (dead && rank <= quota) L.launch(w0);
  quota -= min(total, max(quota, 0));
}

__global__ void photon_block_kernel(
    const MediumTab med, const BlockParams p, float* __restrict__ px,
    float* __restrict__ py, float* __restrict__ pz, float* __restrict__ pdx,
    float* __restrict__ pdy, float* __restrict__ pdz, float* __restrict__ pw,
    float* __restrict__ ptau, int* __restrict__ player,
    const int* __restrict__ quota_in, const float* __restrict__ u,
    float* __restrict__ rz, float* __restrict__ vol, float* __restrict__ det,
    double* __restrict__ refl, double* __restrict__ trans,
    double* __restrict__ counters) {
  __shared__ int warp_tot[32];
  __shared__ int red_i[64];
  __shared__ double red_d[32];

  const int gl = blockIdx.x * blockDim.x + threadIdx.x;
  const uint32_t k0 = (uint32_t)p.seed, k1 = (uint32_t)(p.seed >> 32);
  const uint32_t blk = (uint32_t)p.block_index;
  const size_t lanes = (size_t)p.lanes;

  Lane L;
  L.x = px[gl];
  L.y = py[gl];
  L.z = pz[gl];
  L.ux = pdx[gl];
  L.uy = pdy[gl];
  L.uz = pdz[gl];
  L.w = pw[gl];
  L.tau = ptau[gl];
  L.layer = player[gl];
  L.launches = 0;
  int quota = quota_in[blockIdx.x];  // passed through in bench mode
  int steps = 0;
  float absorbed = 0.f;
  bool exited = false;
  int phase = 0, phase_v = 0;

  if (!p.bench_mode) {
    quota_respawn(L, true, quota, med.w0, warp_tot);
    float u0, u1;
    if (u != nullptr) {
      u0 = u[gl];
      u1 = p.sep_vol_phase ? u[lanes + gl] : 0.f;
    } else {
      const uint4 a = philox4x32_10(make_uint4(gl, blk, 0u, 0u), k0, k1);
      u0 = u01(a.x);
      u1 = u01(a.y);
    }
    phase = min((int)(u0 * (float)p.stride), p.stride - 1);
    phase_v = p.sep_vol_phase
                  ? min((int)(u1 * (float)p.vol_stride), p.vol_stride - 1)
                  : phase;
  }

  for (int s = 0; s < p.k_steps; ++s) {
    if (p.respawn_windows > 0 && s > 0 && s % p.stride == 0 &&
        (s / p.stride) % p.respawn_windows == 0)
      quota_respawn(L, !exited, quota, med.w0, warp_tot);  // block-uniform
    if (p.bench_mode && L.w <= 0.f) L.launch(med.w0);
    if (!(L.w > 0.f)) {
      L.tau = 0.f;  // a dead lane's step only clears its leftover depth
      continue;
    }
    ++steps;

    float u_tau, u_hg, u_phi, u_fr, u_rr;
    const int base = p.n_phase + 5 * s;
    if (u != nullptr) {
      const float* ub = u + (size_t)base * lanes + gl;
      u_tau = ub[0];
      u_hg = ub[lanes];
      u_phi = ub[2 * lanes];
      u_fr = ub[3 * lanes];
      u_rr = ub[4 * lanes];
    } else {
      const uint32_t g = (uint32_t)base >> 2;
      const int off = base & 3;
      const uint4 a = philox4x32_10(make_uint4(gl, blk, g, 0u), k0, k1);
      const uint4 b = philox4x32_10(make_uint4(gl, blk, g + 1u, 0u), k0, k1);
      u_tau = u01(pick(a, b, off));
      u_hg = u01(pick(a, b, off + 1));
      u_phi = u01(pick(a, b, off + 2));
      u_fr = u01(pick(a, b, off + 3));
      u_rr = u01(pick(a, b, off + 4));
    }

    // ---- hop ---------------------------------------------------------------
    const int l = L.layer;
    const float tau_new = L.tau > 0.f ? L.tau : -log1pf(-u_tau);
    const float s_len = tau_new * med.inv_mu_t[l];
    const float zb = L.uz > 0.f ? med.z_bot[l] : med.z_top[l];
    const bool flat = fabsf(L.uz) < 1e-12f;
    const float db =
        flat ? INFINITY : fmaxf((zb - L.z) / (flat ? 1.f : L.uz), 0.f);
    const bool hits_b = db < s_len;
    const float dist = fminf(s_len, db);
    L.x = L.x + L.ux * dist;
    L.y = L.y + L.uy * dist;
    L.z = L.z + L.uz * dist;
    L.tau = hits_b ? tau_new - db * med.mu_t[l] : 0.f;

    if (!hits_b) {
      // ---- drop --------------------------------------------------------------
      const float dw = L.w * med.albedo_a[l];
      L.w = L.w - dw;
      absorbed += dw;
      if (!p.bench_mode) {
        if (phase == s % p.stride) {
          const float r = sqrtf(L.x * L.x + L.y * L.y);
          const int ir = bin_of(r * p.inv_dr, p.nr);
          const int iz = bin_of(L.z * p.inv_dz, p.nz);
          atomicAdd(rz + ir * p.nz + iz, dw * (float)p.stride);
        }
        if (vol != nullptr && phase_v == s % p.vol_stride) {
          const int vx = bin_of(L.x * p.inv_vdx + p.half_vnx, p.vol_nx);
          const int vy = bin_of(L.y * p.inv_vdy + p.half_vny, p.vol_ny);
          const int vz = bin_of(L.z * p.inv_vdz, p.vol_nz);
          atomicAdd(vol + ((size_t)vx * p.vol_ny + vy) * p.vol_nz + vz,
                    dw * (float)p.vol_stride);
        }
      }
      // ---- spin (Henyey-Greenstein) -------------------------------------------
      const float g_l = med.g[l];
      float cos_t;
      if (fabsf(g_l) < 1e-3f) {
        cos_t = 2.f * u_hg - 1.f;
      } else {
        const float frac =
            med.one_m_g2[l] / (1.f - g_l + 2.f * g_l * u_hg);
        cos_t = (med.one_p_g2[l] - frac * frac) * med.inv_2g[l];
      }
      cos_t = fminf(fmaxf(cos_t, -1.f), 1.f);
      const float sin_t = sqrtf(fmaxf(0.f, 1.f - cos_t * cos_t));
      const float phi = 6.28318548202514648f * u_phi;  // float(2 pi)
      // sin from cos + the half-range sign of phi (phi is uniform)
      const float cp = cosf(phi);
      float sp = sqrtf(fmaxf(0.f, 1.f - cp * cp));
      if (!(u_phi <= 0.5f)) sp = -sp;
      // rotate about the current direction (branchless frame)
      const float ux = L.ux, uy = L.uy, uz = L.uz;
      const float sgn = uz >= 0.f ? 1.f : -1.f;
      const float a = -1.f / (sgn + uz);
      const float b = ux * uy * a;
      const float t1x = 1.f + sgn * ux * ux * a, t1y = sgn * b,
                  t1z = -sgn * ux;
      const float t2x = b, t2y = sgn + uy * uy * a, t2z = -uy;
      const float sc = sin_t * cp, ss = sin_t * sp;
      L.ux = sc * t1x + ss * t2x + cos_t * ux;
      L.uy = sc * t1y + ss * t2y + cos_t * uy;
      L.uz = sc * t1z + ss * t2z + cos_t * uz;
      // roulette after drop
      if (L.w < p.wthresh) L.w = u_rr < p.rr_surv ? L.w * p.inv_rr : 0.f;
    } else {
      // ---- boundary: Fresnel reflect / refract / exit --------------------------
      const bool going_down = L.uz > 0.f;
      const int next = going_down ? l + 1 : l - 1;
      const float eta = going_down ? med.eta_dn[l] : med.eta_up[l];
      const float cos_i = fabsf(L.uz);
      const float sin_t2 = eta * eta * (1.f - cos_i * cos_i);
      const bool tir = sin_t2 >= 1.f;
      const float cos_tr = sqrtf(fmaxf(1.f - sin_t2, 0.f));
      const float rs =
          (eta * cos_i - cos_tr) / fmaxf(eta * cos_i + cos_tr, 1e-12f);
      const float rp =
          (eta * cos_tr - cos_i) / fmaxf(eta * cos_tr + cos_i, 1e-12f);
      const float refl_p =
          tir ? 1.f : fminf(fmaxf(0.5f * (rs * rs + rp * rp), 0.f), 1.f);
      if (u_fr < refl_p) {
        L.uz = -L.uz;
      } else {
        L.ux = L.ux * eta;
        L.uy = L.uy * eta;
        L.uz = (L.uz > 0.f ? 1.f : (L.uz < 0.f ? -1.f : 0.f)) * cos_tr;
        if (next < 0 || next >= med.num_layers) {
          if (!p.bench_mode) {
            const float r = sqrtf(L.x * L.x + L.y * L.y);
            const int ir = bin_of(r * p.inv_dr, p.nr);
            if (going_down) {
              atomicAdd(trans + ir, (double)L.w);
            } else {
              atomicAdd(refl + ir, (double)L.w);
              if (det != nullptr) {
                const int ix = bin_of((L.x + p.det_half) * p.det_scale,
                                      p.det_nx);
                const int iy = bin_of((L.y + p.det_half) * p.det_scale,
                                      p.det_nx);
                atomicAdd(det + ix * p.det_nx + iy, L.w);
              }
            }
          }
          exited = true;
          L.w = 0.f;  // the lane dies on exit
        } else {
          L.layer = next;
        }
      }
      // nudge off the interface
      if (L.w > 0.f)
        L.z = L.z + (L.uz > 0.f ? 1.f : (L.uz < 0.f ? -1.f : 0.f)) * 1e-6f;
    }
  }

  px[gl] = L.x;
  py[gl] = L.y;
  pz[gl] = L.z;
  pdx[gl] = L.ux;
  pdy[gl] = L.uy;
  pdz[gl] = L.uz;
  pw[gl] = L.w;
  ptau[gl] = L.tau;
  player[gl] = L.layer;

  // ---- per-tile counters: launched, specular, steps, quota, absorbed -----------
  int n_l = L.launches, n_s = steps;
  double ab = (double)absorbed;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    n_l += __shfl_down_sync(0xffffffffu, n_l, o);
    n_s += __shfl_down_sync(0xffffffffu, n_s, o);
    ab += __shfl_down_sync(0xffffffffu, ab, o);
  }
  if (lane == 0) {
    red_i[wid] = n_l;
    red_i[32 + wid] = n_s;
    red_d[wid] = ab;
  }
  __syncthreads();
  if (wid == 0) {
    n_l = lane < nw ? red_i[lane] : 0;
    n_s = lane < nw ? red_i[32 + lane] : 0;
    ab = lane < nw ? red_d[lane] : 0.0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      n_l += __shfl_down_sync(0xffffffffu, n_l, o);
      n_s += __shfl_down_sync(0xffffffffu, n_s, o);
      ab += __shfl_down_sync(0xffffffffu, ab, o);
    }
    if (lane == 0) {
      double* c = counters + (size_t)blockIdx.x * 5;
      c[0] = (double)n_l;
      c[1] = (double)n_l * p.r_sp;
      c[2] = (double)n_s;
      c[3] = (double)quota;
      c[4] = ab;
    }
  }
}

extern "C" int photon_block_launch(
    const MediumTab* med, const BlockParams* p, float* px, float* py,
    float* pz, float* pdx, float* pdy, float* pdz, float* pw, float* ptau,
    int* player, const int* quota, const float* u, float* rz, float* vol,
    float* det, double* refl, double* trans, double* counters,
    void* stream) {
  const dim3 grid(p->lanes / p->tile_lanes), block(p->tile_lanes);
  photon_block_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      *med, *p, px, py, pz, pdx, pdy, pdz, pw, ptau, player, quota, u, rz,
      vol, det, refl, trans, counters);
  return (int)cudaGetLastError();
}

extern "C" const char* photon_kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

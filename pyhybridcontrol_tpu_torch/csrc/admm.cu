// Batched σ=0 ADMM kernels for Hopper (sm_90a), with a plain C interface
// loaded through ctypes by pyhybridcontrol_tpu_torch/ops/_build.py.
//
// Replaces the two Pallas TPU kernels of pyhybridcontrol_tpu/ops/pallas_admm.py:
//   K1 phc_admm_k1 <- _admm_kernel      (launched by _pallas_run)
//   K2 phc_admm_k2 <- _admm_wave_kernel (launched by _pallas_wave_run)
// The plain torch versions beside them are admm_solve_plain and
// admm_wave_plain in ops/cuda_admm.py; both compute the same function.
//
// Design: one thread block per problem (batch column). The constant
// matrices Â_G (mGp×nr) and Mᵀ (nr×(mGp+nr)) -- plus M2ᵀ for K2's stiff
// probe phase -- are staged once per block in dynamic shared memory, laid
// out so that neighbouring threads read neighbouring words. The iterates
// (z, y, w and the bounds) live in shared memory for the whole solve; only
// the results go back to device memory. Each iteration is
//   t  = Â_Gᵀ w_G + d∘w_B − q̂   (split-K over S slices, then a row reduce)
//   ẑ  = M t, fused with the over-relaxed projection and dual update of
//        each row by the thread that owns it.
// Products are plain fp32 FMAs (no tensor cores, no TF32); the stats
// reductions (objective, certificate support/gap sums) accumulate in fp64.
//
// What bounds it on the H100: a config-1 B&B wave is 32 problems × 800
// dependent iterations, so it runs on 32 of 132 SMs and is latency-bound
// (three __syncthreads per iteration). The N=20 batch (nr=64, mGp=200)
// is ~59 kFLOP per iteration per problem, ~24 GFLOP for B=4096 × 100
// iterations. Every FMA reads one shared-memory word, which caps the
// kernel near 32 FMA/clock/SM (~17 TFLOP/s on 132 SMs), a quarter of the
// fp32 FMA peak; below that cap, one 256-thread block per SM (staged
// constants and iterates take up to 197 KB of the 227 KB a block may use)
// hides too little shared-memory latency across the barriers, so it runs
// well under it (measured times in PERF.md). Making it fast (register-blocking
// several problems per block, wgmma or 3xTF32 with the batch as the N
// dimension, CUDA graphs around the wave loop) is later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define PHC_BLOCK 256
#define PHC_BIG 1e30f

namespace {

// per-row constant vectors, packed [dbox, dbox_inv, rhoB, rhoB_inv, EB_inv,
// Dc_inv | rhoG, rhoG_inv, EG_inv] (see ops/cuda_admm.py _layout)
struct Vec {
  const float *dbox, *dboxi, *rhoB, *rhoBi, *ebi, *dci, *rhoG, *rhoGi, *egi;
};

__device__ __forceinline__ Vec unpack_vec(const float* v, int nr, int mGp) {
  Vec c;
  c.dbox = v;
  c.dboxi = v + nr;
  c.rhoB = v + 2 * nr;
  c.rhoBi = v + 3 * nr;
  c.ebi = v + 4 * nr;
  c.dci = v + 5 * nr;
  c.rhoG = v + 6 * nr;
  c.rhoGi = v + 6 * nr + mGp;
  c.egi = v + 6 * nr + 2 * mGp;
  return c;
}

// shared-memory carve-up, in floats
struct Smem {
  float *AG, *MT, *MT2;                                 // constants
  float *zG, *yG, *wG, *lG, *uG, *ztG, *dyG;            // mGp each
  float *zB, *yB, *wB, *lB, *uB, *lBp, *uBp, *ztB, *dyB, *q, *t, *x, *Px,
      *Aty, *Atdy;                                      // nr each
  float* part;                                          // S·nr split-K sums
};

__host__ __device__ inline int split_k(int nr) {
  int s = PHC_BLOCK / nr;
  return s < 1 ? 1 : (s > 8 ? 8 : s);
}

__host__ __device__ inline size_t smem_floats(int nr, int mGp, int wave,
                                              int stiff) {
  size_t R = (size_t)mGp + nr;
  size_t n = (size_t)mGp * nr + (size_t)nr * R;
  if (wave && stiff) n += (size_t)nr * R;
  n += 7 * (size_t)mGp + 16 * (size_t)nr + (size_t)split_k(nr) * nr;
  return n;
}

__device__ Smem carve(float* base, int nr, int mGp, int wave, int stiff) {
  Smem s;
  size_t R = (size_t)mGp + nr;
  float* p = base;
  s.AG = p;  p += (size_t)mGp * nr;
  s.MT = p;  p += (size_t)nr * R;
  s.MT2 = nullptr;
  if (wave && stiff) { s.MT2 = p; p += (size_t)nr * R; }
  float** g[] = {&s.zG, &s.yG, &s.wG, &s.lG, &s.uG, &s.ztG, &s.dyG};
  for (float** a : g) { *a = p; p += mGp; }
  float** b[] = {&s.zB, &s.yB, &s.wB, &s.lB, &s.uB, &s.lBp, &s.uBp, &s.ztB,
                 &s.dyB, &s.q, &s.t, &s.x, &s.Px, &s.Aty, &s.Atdy};
  for (float** a : b) { *a = p; p += nr; }
  p += nr;  // spare row keeps the layout in step with smem_floats
  s.part = p;
  return s;
}

__device__ __forceinline__ float clipf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);  // jnp.clip / torch.clamp order
}

// `iters` σ=0 iterations from the iterates in shared memory, then -- if
// `final_half` -- one more half step whose ẑ and δy go to ztG/ztB, dyG/dyB
// (the iterates stay those of the last full iteration). Mirrors _phase of
// the reference and of ops/cuda_admm.py.
__device__ void phase(const Smem& s, const float* MT, const float* rhoG,
                      const float* rhoGi, const float* rhoB,
                      const float* rhoBi, const float* dbox, const float* lB,
                      const float* uB, int nr, int mGp, int iters, float alpha,
                      bool final_half) {
  const int tid = threadIdx.x;
  const int R = mGp + nr;
  const int S = split_k(nr);
  for (int i = tid; i < mGp; i += PHC_BLOCK)
    s.wG[i] = rhoG[i] * s.zG[i] - s.yG[i];
  for (int j = tid; j < nr; j += PHC_BLOCK)
    s.wB[j] = rhoB[j] * s.zB[j] - s.yB[j];
  __syncthreads();
  for (int k = 0; k <= iters; ++k) {
    const bool last = (k == iters);
    if (last && !final_half) break;
    // t = Â_Gᵀ w_G (S partial sums per column) ...
    for (int idx = tid; idx < nr * S; idx += PHC_BLOCK) {
      const int j = idx % nr, sl = idx / nr;
      float acc = 0.f;
      for (int i = sl; i < mGp; i += S) acc = fmaf(s.AG[i * nr + j], s.wG[i], acc);
      s.part[sl * nr + j] = acc;
    }
    __syncthreads();
    // ... + d∘w_B − q̂
    for (int j = tid; j < nr; j += PHC_BLOCK) {
      float acc = 0.f;
      for (int sl = 0; sl < S; ++sl) acc += s.part[sl * nr + j];
      s.t[j] = acc + dbox[j] * s.wB[j] - s.q[j];
    }
    __syncthreads();
    // ẑ = M t, row r owned by one thread, fused with its z/y update
    for (int r = tid; r < R; r += PHC_BLOCK) {
      float u = 0.f;
      for (int c = 0; c < nr; ++c) u = fmaf(MT[c * R + r], s.t[c], u);
      const bool g = r < mGp;
      const int i = g ? r : r - mGp;
      float* zv = g ? s.zG : s.zB;
      float* yv = g ? s.yG : s.yB;
      const float rho = g ? rhoG[i] : rhoB[i];
      const float rhoi = g ? rhoGi[i] : rhoBi[i];
      const float lo = g ? s.lG[i] : lB[i];
      const float hi = g ? s.uG[i] : uB[i];
      const float z = zv[i], y = yv[i];
      const float zr = alpha * u + (1.f - alpha) * z;
      const float zn = clipf(zr + y * rhoi, lo, hi);
      const float dy = rho * (zr - zn);
      if (last) {
        (g ? s.ztG : s.ztB)[i] = u;
        (g ? s.dyG : s.dyB)[i] = dy;
      } else {
        const float yn = y + dy;
        zv[i] = zn;
        yv[i] = yn;
        (g ? s.wG : s.wB)[i] = rho * zn - yn;
      }
    }
    __syncthreads();
  }
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_down_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ double warp_sum(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// (8,) stats of one problem: obj, r_prim, r_rel, r_dual, infeasibility
// certificate, 0, 0, 0 -- in original units. Mirrors _stats.
__device__ void stats(const Smem& s, const float* P, const Vec& c,
                      const float* lB, const float* uB, int nr, int mGp,
                      float cinv, float* out) {
  const int tid = threadIdx.x;
  for (int j = tid; j < nr; j += PHC_BLOCK) {
    float px = 0.f, aty = 0.f, atdy = 0.f;
    for (int k = 0; k < nr; ++k) px = fmaf(P[j * nr + k], s.x[k], px);
    for (int i = 0; i < mGp; ++i) {
      const float a = s.AG[i * nr + j];
      aty = fmaf(a, s.yG[i], aty);
      atdy = fmaf(a, s.dyG[i], atdy);
    }
    s.Px[j] = px;
    s.Aty[j] = aty + c.dbox[j] * s.yB[j];
    s.Atdy[j] = atdy + c.dbox[j] * s.dyB[j];
  }
  __syncthreads();
  if (tid < 32) {
    float r_prim = 0.f, r_rel = 0.f, r_dual = 0.f, dy_norm = 0.f, atdy = 0.f;
    double xpx = 0.0, qx = 0.0, support = 0.0, gap = 0.0;
    const int R = mGp + nr;
    for (int r = tid; r < R; r += 32) {
      const bool g = r < mGp;
      const int i = g ? r : r - mGp;
      const float zt = g ? s.ztG[i] : s.ztB[i];
      const float lo = g ? s.lG[i] : lB[i];
      const float hi = g ? s.uG[i] : uB[i];
      const float ei = g ? c.egi[i] : c.ebi[i];
      const float dy = g ? s.dyG[i] : s.dyB[i];
      const float viol = fabsf(zt - clipf(zt, lo, hi)) * ei;
      r_prim = fmaxf(r_prim, viol);
      r_rel = fmaxf(r_rel, viol / fmaxf(1.f, fabsf(zt * ei)));
      dy_norm = fmaxf(dy_norm, fabsf(dy));
      const double dyp = (double)fmaxf(dy, 0.f), dyn = (double)fminf(dy, 0.f);
      const bool finu = hi < 0.9f * PHC_BIG, finl = lo > -0.9f * PHC_BIG;
      support += (finu ? 0.0 : dyp) + (finl ? 0.0 : -dyn);
      gap += (finu ? (double)hi * dyp : 0.0) + (finl ? (double)lo * dyn : 0.0);
      if (!g) {
        const float x = s.x[i], q = s.q[i];
        r_dual = fmaxf(r_dual, fabsf((s.Px[i] + q + s.Aty[i]) * c.dci[i]));
        atdy = fmaxf(atdy, fabsf(s.Atdy[i]));
        xpx += (double)x * (double)s.Px[i];
        qx += (double)q * (double)x;
      }
    }
    r_prim = warp_max(r_prim);
    r_rel = warp_max(r_rel);
    r_dual = warp_max(r_dual);
    dy_norm = warp_max(dy_norm);
    atdy = warp_max(atdy);
    xpx = warp_sum(xpx);
    qx = warp_sum(qx);
    support = warp_sum(support);
    gap = warp_sum(gap);
    if (tid == 0) {
      const double eps_c = 1e-4, dn = (double)dy_norm;
      const bool cert = dn > 1e-12 && (double)atdy <= eps_c * dn &&
                        support <= eps_c * dn && gap <= -eps_c * dn;
      out[0] = (float)((0.5 * xpx + qx) * (double)cinv);
      out[1] = r_prim;
      out[2] = r_rel;
      out[3] = r_dual;
      out[4] = cert ? 1.f : 0.f;
      out[5] = out[6] = out[7] = 0.f;
    }
  }
  __syncthreads();
}

__device__ void stage(float* dst, const float* src, size_t n) {
  for (size_t i = threadIdx.x; i < n; i += PHC_BLOCK) dst[i] = src[i];
}

// load one problem's data and its initial (clipped) iterates
__device__ void load_problem(const Smem& s, int b, int nr, int mGp,
                             const float* q, const float* lG, const float* uG,
                             const float* lB, const float* uB,
                             const float* z0G, const float* y0G,
                             const float* z0B, const float* y0B) {
  const size_t oG = (size_t)b * mGp, oB = (size_t)b * nr;
  for (int i = threadIdx.x; i < mGp; i += PHC_BLOCK) {
    const float lo = lG[oG + i], hi = uG[oG + i];
    s.lG[i] = lo;
    s.uG[i] = hi;
    s.zG[i] = clipf(z0G ? z0G[oG + i] : 0.f, lo, hi);
    s.yG[i] = y0G ? y0G[oG + i] : 0.f;
  }
  for (int j = threadIdx.x; j < nr; j += PHC_BLOCK) {
    const float lo = lB[oB + j], hi = uB[oB + j];
    s.lB[j] = lo;
    s.uB[j] = hi;
    s.q[j] = q[oB + j];
    s.zB[j] = clipf(z0B ? z0B[oB + j] : 0.f, lo, hi);
    s.yB[j] = y0B ? y0B[oB + j] : 0.f;
  }
}

// write x = ẑ_B / d, the iterates, and the stats of one problem
__device__ void store_result(const Smem& s, const Vec& c, const float* P,
                             const float* lB, const float* uB, int b, int nr,
                             int mGp, float cinv, float* x, float* zG,
                             float* yG, float* zB, float* yB, float* st) {
  const size_t oG = (size_t)b * mGp, oB = (size_t)b * nr;
  for (int j = threadIdx.x; j < nr; j += PHC_BLOCK) {
    const float xv = s.ztB[j] * c.dboxi[j];
    s.x[j] = xv;
    x[oB + j] = xv;
    zB[oB + j] = s.zB[j];
    yB[oB + j] = s.yB[j];
  }
  for (int i = threadIdx.x; i < mGp; i += PHC_BLOCK) {
    zG[oG + i] = s.zG[i];
    yG[oG + i] = s.yG[i];
  }
  __syncthreads();
  stats(s, P, c, lB, uB, nr, mGp, cinv, st + (size_t)b * 8);
}

__global__ void __launch_bounds__(PHC_BLOCK)
admm_k1_kernel(const float* __restrict__ q, const float* __restrict__ lG,
               const float* __restrict__ uG, const float* __restrict__ lB,
               const float* __restrict__ uB, const float* __restrict__ z0G,
               const float* __restrict__ y0G, const float* __restrict__ z0B,
               const float* __restrict__ y0B, const float* __restrict__ AG,
               const float* __restrict__ MT, const float* __restrict__ P,
               const float* __restrict__ vec, float* x, float* zG, float* yG,
               float* zB, float* yB, float* st, int nr, int mGp, int iters,
               float alpha, float cinv) {
  extern __shared__ float smem[];
  const Smem s = carve(smem, nr, mGp, 0, 0);
  const Vec c = unpack_vec(vec, nr, mGp);
  const int b = blockIdx.x;
  const size_t R = (size_t)mGp + nr;
  stage(s.AG, AG, (size_t)mGp * nr);
  stage(s.MT, MT, (size_t)nr * R);
  load_problem(s, b, nr, mGp, q, lG, uG, lB, uB, z0G, y0G, z0B, y0B);
  __syncthreads();
  phase(s, s.MT, c.rhoG, c.rhoGi, c.rhoB, c.rhoBi, c.dbox, s.lB, s.uB, nr,
        mGp, iters, alpha, true);
  store_result(s, c, P, s.lB, s.uB, b, nr, mGp, cinv, x, zG, yG, zB, yB, st);
}

__global__ void __launch_bounds__(PHC_BLOCK)
admm_k2_kernel(const float* __restrict__ q, const float* __restrict__ lG,
               const float* __restrict__ uG, const float* __restrict__ lB,
               const float* __restrict__ uB, const float* __restrict__ z0G,
               const float* __restrict__ y0G, const float* __restrict__ z0B,
               const float* __restrict__ y0B, const float* __restrict__ AG,
               const float* __restrict__ MT, const float* __restrict__ P,
               const float* __restrict__ vec, const float* __restrict__ binm,
               const float* __restrict__ MT2, const float* __restrict__ vec2,
               float* x, float* zG, float* yG, float* zB, float* yB,
               float* st, float* xp, float* zGp, float* yGp, float* zBp,
               float* yBp, float* stp, int nr, int mGp, int iters, int p1,
               int p2, float alpha, float alpha2, float cinv) {
  extern __shared__ float smem[];
  const int stiff = p1 > 0;
  const Smem s = carve(smem, nr, mGp, 1, stiff);
  const Vec c = unpack_vec(vec, nr, mGp);
  const Vec c2 = unpack_vec(vec2, nr, mGp);
  const int b = blockIdx.x;
  const size_t R = (size_t)mGp + nr;
  stage(s.AG, AG, (size_t)mGp * nr);
  stage(s.MT, MT, (size_t)nr * R);
  if (stiff) stage(s.MT2, MT2, (size_t)nr * R);
  load_problem(s, b, nr, mGp, q, lG, uG, lB, uB, z0G, y0G, z0B, y0B);
  __syncthreads();

  // ---- relaxation ----
  phase(s, s.MT, c.rhoG, c.rhoGi, c.rhoB, c.rhoBi, c.dbox, s.lB, s.uB, nr,
        mGp, iters, alpha, true);
  store_result(s, c, P, s.lB, s.uB, b, nr, mGp, cinv, x, zG, yG, zB, yB, st);

  // ---- probe bounds: binaries fixed to the rounded relaxation ----
  // ztB is E_box·x; clip to the node box first so fixed binaries keep
  // their value, round half to even (rintf == jnp.round == torch.round)
  for (int j = threadIdx.x; j < nr; j += PHC_BLOCK) {
    float lo = s.lB[j], hi = s.uB[j];
    if (binm[j] > 0.f) {
      const float xo = clipf(s.ztB[j], lo, hi) * c.ebi[j];
      const float pv = rintf(clipf(xo, 0.f, 1.f)) / c.ebi[j];
      lo = pv;
      hi = pv;
    }
    s.lBp[j] = lo;
    s.uBp[j] = hi;
    s.zB[j] = clipf(s.zB[j], lo, hi);
  }
  __syncthreads();

  // ---- probe: stiff-ρ then base-ρ, warm-chained in shared memory ----
  if (stiff)
    phase(s, s.MT2, c2.rhoG, c2.rhoGi, c2.rhoB, c2.rhoBi, c.dbox, s.lBp,
          s.uBp, nr, mGp, p1, alpha2, false);
  phase(s, s.MT, c.rhoG, c.rhoGi, c.rhoB, c.rhoBi, c.dbox, s.lBp, s.uBp, nr,
        mGp, p2, alpha, true);
  store_result(s, c, P, s.lBp, s.uBp, b, nr, mGp, cinv, xp, zGp, yGp, zBp,
               yBp, stp);
}

int set_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

}  // namespace

extern "C" {

// dynamic shared memory one block of K1 (wave=0) or K2 (wave=1) needs
int phc_admm_smem_bytes(int nr, int mGp, int wave, int stiff) {
  return (int)(smem_floats(nr, mGp, wave, stiff) * sizeof(float));
}

const char* phc_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int phc_admm_k1(const float* q, const float* lG, const float* uG,
                const float* lB, const float* uB, const float* z0G,
                const float* y0G, const float* z0B, const float* y0B,
                const float* AG, const float* MT, const float* P,
                const float* vec, float* x, float* zG, float* yG, float* zB,
                float* yB, float* st, int B, int nr, int mGp, int iters,
                float alpha, float cinv, void* stream) {
  const size_t bytes = smem_floats(nr, mGp, 0, 0) * sizeof(float);
  int rc = set_smem((const void*)admm_k1_kernel, bytes);
  if (rc) return rc;
  admm_k1_kernel<<<B, PHC_BLOCK, bytes, (cudaStream_t)stream>>>(
      q, lG, uG, lB, uB, z0G, y0G, z0B, y0B, AG, MT, P, vec, x, zG, yG, zB,
      yB, st, nr, mGp, iters, alpha, cinv);
  return (int)cudaGetLastError();
}

int phc_admm_k2(const float* q, const float* lG, const float* uG,
                const float* lB, const float* uB, const float* z0G,
                const float* y0G, const float* z0B, const float* y0B,
                const float* AG, const float* MT, const float* P,
                const float* vec, const float* binm, const float* MT2,
                const float* vec2, float* x, float* zG, float* yG, float* zB,
                float* yB, float* st, float* xp, float* zGp, float* yGp,
                float* zBp, float* yBp, float* stp, int B, int nr, int mGp,
                int iters, int p1, int p2, float alpha, float alpha2,
                float cinv, void* stream) {
  const size_t bytes = smem_floats(nr, mGp, 1, p1 > 0) * sizeof(float);
  int rc = set_smem((const void*)admm_k2_kernel, bytes);
  if (rc) return rc;
  admm_k2_kernel<<<B, PHC_BLOCK, bytes, (cudaStream_t)stream>>>(
      q, lG, uG, lB, uB, z0G, y0G, z0B, y0B, AG, MT, P, vec, binm, MT2, vec2,
      x, zG, yG, zB, yB, st, xp, zGp, yGp, zBp, yBp, stp, nr, mGp, iters, p1,
      p2, alpha, alpha2, cinv);
  return (int)cudaGetLastError();
}

}  // extern "C"

// K1's split-precision leading iterations for Hopper (sm_90a): the bf16
// 3-pass products on the tensor cores. Plain C interface, loaded through
// ctypes by pyhybridcontrol_tpu_torch/ops/_build.py.
//
// Replaces the `iters_lo` phase of the Pallas TPU kernel `_admm_kernel`
// (pyhybridcontrol_tpu/ops/pallas_admm.py: `_mm3`, `_bf16_split` and the
// `half_lo` loop of `_phase`). The plain torch version beside it is
// admm_solve_plain(low_frac=) in ops/cuda_admm.py.
//
// What it computes: `iters` sigma=0 ADMM iterations in which each of the two
// products is  A.b ~= Ahi.bhi + Ahi.blo + Alo.bhi  with
// hi = bf16(a), lo = bf16(a - hi), bf16 inputs and fp32 accumulation. The
// constants are split once on the host side of the call; the iterate
// operand is split at every product. The z/y update is fp32. Only the
// iterates (zG, yG, zB, yB) leave the kernel: the full-precision tail, the
// final half step and the stats are K1 itself (phc_admm_k1 in admm.cu),
// launched warm from these iterates by the wrapper.
//
// Design: the products are matrix products only if the batch is a matrix
// dimension, so one block owns a tile of 16 problems (the N of every
// product) and runs nvcuda::wmma 16x16x16 bf16 MMAs: t = A_G^T w_G is
// (nr x mG)(mG x 16), u = M t is ((mG+nr) x nr)(nr x 16). nr and mG are
// multiples of 16 (the wrapper pads with zero rows and columns, which are
// inert). The hi/lo bf16 pairs of A_G^T and M sit in shared memory (as
// many bytes as K1's fp32 copies), the iterate tile stays in shared memory
// in fp32, laid out [row][problem], and is split to bf16 hi/lo where a
// product reads it. The t product has few output tiles, so its K range is
// split over the warps and the partial tiles are summed in the elementwise
// pass that adds d.w_B - q and splits t; each u tile is updated (clip,
// dual step) by the warp that computed it, straight from its accumulator.
//
// What bounds it on the H100: at the bench-primary shape (nr=64, mG=208,
// B=4096, 100 iterations) the three passes are ~75 GFLOP of bf16 MMA,
// ~0.08 ms at the 989 TFLOP/s peak, against ~19 MB of inputs and outputs
// (~0.006 ms at 3.35 TB/s); so operations bound it, and the kernel is far
// from that bound: wmma fragments are
// loaded from shared memory for every MMA, one block of 8 warps per SM
// (222 KB of shared memory), four block-wide barriers per iteration.
// wgmma with the constants resident in registers/shared descriptors and
// TMA loads are later work (measured times in PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#define PHC_MIX_T 16       // problems per block: the N of every product
#define PHC_MIX_WARPS 8
#define PHC_MIX_BLOCK (32 * PHC_MIX_WARPS)

namespace {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

struct Dims {
  int nr, mG, R, nT, kT, ksplit, slots;
};

__host__ __device__ inline Dims make_dims(int nr, int mG) {
  Dims d;
  d.nr = nr;
  d.mG = mG;
  d.R = nr + mG;
  d.nT = nr / 16;   // output row tiles of t
  d.kT = mG / 16;   // K tiles of the t product
  d.ksplit = d.nT >= PHC_MIX_WARPS ? 1 : PHC_MIX_WARPS / d.nT;
  if (d.ksplit > d.kT) d.ksplit = d.kT;
  d.slots = d.nT * d.ksplit;
  if (d.slots < PHC_MIX_WARPS) d.slots = PHC_MIX_WARPS;
  return d;
}

__host__ __device__ inline size_t smem_bytes(const Dims& d) {
  const size_t T = PHC_MIX_T;
  size_t b = 0;
  b += 2 * ((size_t)d.nr * d.mG + (size_t)d.R * d.nr) * sizeof(bf16);  // A, M
  b += 2 * ((size_t)d.mG * T + (size_t)d.nr * T) * sizeof(bf16);       // w, t
  b += (4 * (size_t)d.mG + 5 * (size_t)d.nr) * T * sizeof(float);      // tile
  b += (size_t)d.slots * 256 * sizeof(float);                          // stage
  return b;
}

struct Smem {
  bf16 *Ahi, *Alo, *Mhi, *Mlo, *whi, *wlo, *thi, *tlo;
  float *zG, *yG, *lG, *uG, *zB, *yB, *lB, *uB, *q, *stage;
};

// every piece is a multiple of 32 bytes (nr, mG multiples of 16), which is
// the alignment wmma wants of a fragment pointer
__device__ Smem carve(unsigned char* base, const Dims& d) {
  const size_t T = PHC_MIX_T;
  Smem s;
  bf16* h = reinterpret_cast<bf16*>(base);
  s.Ahi = h;  h += (size_t)d.nr * d.mG;
  s.Alo = h;  h += (size_t)d.nr * d.mG;
  s.Mhi = h;  h += (size_t)d.R * d.nr;
  s.Mlo = h;  h += (size_t)d.R * d.nr;
  s.whi = h;  h += (size_t)d.mG * T;
  s.wlo = h;  h += (size_t)d.mG * T;
  s.thi = h;  h += (size_t)d.nr * T;
  s.tlo = h;  h += (size_t)d.nr * T;
  float* f = reinterpret_cast<float*>(h);
  float** g[] = {&s.zG, &s.yG, &s.lG, &s.uG};
  for (float** a : g) { *a = f; f += (size_t)d.mG * T; }
  float** b[] = {&s.zB, &s.yB, &s.lB, &s.uB, &s.q};
  for (float** a : b) { *a = f; f += (size_t)d.nr * T; }
  s.stage = f;
  return s;
}

__device__ __forceinline__ float clipf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);  // jnp.clip / torch.clamp order
}

__device__ __forceinline__ void split_bf16(float v, bf16* hi, bf16* lo) {
  const bf16 h = __float2bfloat16_rn(v);
  *hi = h;
  *lo = __float2bfloat16_rn(v - __bfloat162float(h));
}

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

// acc += Ahi.bhi + Ahi.blo + Alo.bhi over K tiles [k0, k1); A is row-major
// with leading dimension lda, the operand tile [K][16 problems]
__device__ __forceinline__ void mma3(FragC& acc, const bf16* Ahi,
                                     const bf16* Alo, int lda, const bf16* bhi,
                                     const bf16* blo, int k0, int k1) {
  FragA ah, al;
  FragB bh, bl;
  for (int kt = k0; kt < k1; ++kt) {
    wmma::load_matrix_sync(ah, Ahi + kt * 16, lda);
    wmma::load_matrix_sync(al, Alo + kt * 16, lda);
    wmma::load_matrix_sync(bh, bhi + (size_t)kt * 16 * PHC_MIX_T, PHC_MIX_T);
    wmma::load_matrix_sync(bl, blo + (size_t)kt * 16 * PHC_MIX_T, PHC_MIX_T);
    wmma::mma_sync(acc, ah, bh, acc);
    wmma::mma_sync(acc, ah, bl, acc);
    wmma::mma_sync(acc, al, bh, acc);
  }
}

// global (B, rows) batch-first -> shared [row][problem]; problems past the
// end of the batch get zero data (l = u = 0: inert)
__device__ void load_tile(float* dst, const float* src, int rows, int b0,
                          int B, float fill) {
  for (int idx = threadIdx.x; idx < rows * PHC_MIX_T; idx += PHC_MIX_BLOCK) {
    const int p = idx / rows, i = idx % rows, b = b0 + p;
    dst[i * PHC_MIX_T + p] =
        (src != nullptr && b < B) ? src[(size_t)b * rows + i] : fill;
  }
}

__device__ void store_tile(float* dst, const float* src, int rows, int b0,
                           int B) {
  for (int idx = threadIdx.x; idx < rows * PHC_MIX_T; idx += PHC_MIX_BLOCK) {
    const int p = idx / rows, i = idx % rows, b = b0 + p;
    if (b < B) dst[(size_t)b * rows + i] = src[i * PHC_MIX_T + p];
  }
}

__global__ void __launch_bounds__(PHC_MIX_BLOCK)
admm_mixed_kernel(const float* __restrict__ q, const float* __restrict__ lG,
                  const float* __restrict__ uG, const float* __restrict__ lB,
                  const float* __restrict__ uB, const float* __restrict__ z0G,
                  const float* __restrict__ y0G, const float* __restrict__ z0B,
                  const float* __restrict__ y0B, const bf16* __restrict__ Ahi,
                  const bf16* __restrict__ Alo, const bf16* __restrict__ Mhi,
                  const bf16* __restrict__ Mlo, const float* __restrict__ vec,
                  float* zG, float* yG, float* zB, float* yB, int B, int nr,
                  int mG, int iters, float alpha) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const Dims d = make_dims(nr, mG);
  const Smem s = carve(smem_raw, d);
  const int T = PHC_MIX_T;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b0 = blockIdx.x * T;
  // per-row constants, packed as for K1: [dbox, 1/dbox, rhoB, 1/rhoB, 1/E_B,
  // 1/(D c) | rhoG, 1/rhoG, 1/E_G]
  const float* dbox = vec;
  const float* rhoB = vec + 2 * nr;
  const float* rhoBi = vec + 3 * nr;
  const float* rhoG = vec + 6 * nr;
  const float* rhoGi = vec + 6 * nr + mG;

  for (int i = tid; i < nr * mG; i += PHC_MIX_BLOCK) {
    s.Ahi[i] = Ahi[i];
    s.Alo[i] = Alo[i];
  }
  for (int i = tid; i < d.R * nr; i += PHC_MIX_BLOCK) {
    s.Mhi[i] = Mhi[i];
    s.Mlo[i] = Mlo[i];
  }
  load_tile(s.lG, lG, mG, b0, B, 0.f);
  load_tile(s.uG, uG, mG, b0, B, 0.f);
  load_tile(s.zG, z0G, mG, b0, B, 0.f);
  load_tile(s.yG, y0G, mG, b0, B, 0.f);
  load_tile(s.lB, lB, nr, b0, B, 0.f);
  load_tile(s.uB, uB, nr, b0, B, 0.f);
  load_tile(s.zB, z0B, nr, b0, B, 0.f);
  load_tile(s.yB, y0B, nr, b0, B, 0.f);
  load_tile(s.q, q, nr, b0, B, 0.f);
  __syncthreads();
  for (int idx = tid; idx < mG * T; idx += PHC_MIX_BLOCK)
    s.zG[idx] = clipf(s.zG[idx], s.lG[idx], s.uG[idx]);
  for (int idx = tid; idx < nr * T; idx += PHC_MIX_BLOCK)
    s.zB[idx] = clipf(s.zB[idx], s.lB[idx], s.uB[idx]);
  __syncthreads();

  for (int k = 0; k < iters; ++k) {
    // 1. w_G = rho z - y, split to bf16 hi/lo
    for (int idx = tid; idx < mG * T; idx += PHC_MIX_BLOCK) {
      const int i = idx / T;
      split_bf16(rhoG[i] * s.zG[idx] - s.yG[idx], s.whi + idx, s.wlo + idx);
    }
    __syncthreads();
    // 2. partial tiles of A_G^T w_G: output tile jt, K slice ks
    for (int job = warp; job < d.nT * d.ksplit; job += PHC_MIX_WARPS) {
      const int jt = job / d.ksplit, ks = job % d.ksplit;
      FragC acc;
      wmma::fill_fragment(acc, 0.f);
      mma3(acc, s.Ahi + (size_t)jt * 16 * mG, s.Alo + (size_t)jt * 16 * mG, mG,
           s.whi, s.wlo, ks * d.kT / d.ksplit, (ks + 1) * d.kT / d.ksplit);
      wmma::store_matrix_sync(s.stage + (size_t)job * 256, acc, 16,
                              wmma::mem_row_major);
    }
    __syncthreads();
    // 3. t = sum of the partials + d o w_B - q, split to bf16 hi/lo
    for (int idx = tid; idx < nr * T; idx += PHC_MIX_BLOCK) {
      const int j = idx / T, p = idx % T;
      const float* part =
          s.stage + (size_t)(j / 16) * d.ksplit * 256 + (j % 16) * 16 + p;
      float acc = 0.f;
      for (int ks = 0; ks < d.ksplit; ++ks) acc += part[ks * 256];
      const float wB = rhoB[j] * s.zB[idx] - s.yB[idx];
      split_bf16(acc + dbox[j] * wB - s.q[idx], s.thi + idx, s.tlo + idx);
    }
    __syncthreads();
    // 4. u = M t, one 16-row tile per warp, then that tile's z/y update
    for (int rt = warp; rt < d.R / 16; rt += PHC_MIX_WARPS) {
      FragC acc;
      wmma::fill_fragment(acc, 0.f);
      mma3(acc, s.Mhi + (size_t)rt * 16 * nr, s.Mlo + (size_t)rt * 16 * nr, nr,
           s.thi, s.tlo, 0, nr / 16);
      float* st = s.stage + warp * 256;
      wmma::store_matrix_sync(st, acc, 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int row = rt * 16 + e / 16, p = e % 16;
        const bool g = row < mG;
        const int i = g ? row : row - mG;
        const int at = i * T + p;
        float* zv = g ? s.zG : s.zB;
        float* yv = g ? s.yG : s.yB;
        const float rho = g ? rhoG[i] : rhoB[i];
        const float rhoi = g ? rhoGi[i] : rhoBi[i];
        const float lo = (g ? s.lG : s.lB)[at], hi = (g ? s.uG : s.uB)[at];
        const float z = zv[at], y = yv[at];
        const float zr = alpha * st[e] + (1.f - alpha) * z;
        const float zn = clipf(zr + y * rhoi, lo, hi);
        zv[at] = zn;
        yv[at] = y + rho * (zr - zn);
      }
      __syncwarp();
    }
    __syncthreads();
  }

  store_tile(zG, s.zG, mG, b0, B);
  store_tile(yG, s.yG, mG, b0, B);
  store_tile(zB, s.zB, nr, b0, B);
  store_tile(yB, s.yB, nr, b0, B);
}

}  // namespace

extern "C" {

// dynamic shared memory one block needs (nr, mG multiples of 16)
int phc_admm_mixed_smem_bytes(int nr, int mG) {
  return (int)smem_bytes(make_dims(nr, mG));
}

const char* phc_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int phc_admm_k1_mixed(const float* q, const float* lG, const float* uG,
                      const float* lB, const float* uB, const float* z0G,
                      const float* y0G, const float* z0B, const float* y0B,
                      const void* Ahi, const void* Alo, const void* Mhi,
                      const void* Mlo, const float* vec, float* zG, float* yG,
                      float* zB, float* yB, int B, int nr, int mG, int iters,
                      float alpha, void* stream) {
  if (nr < 16 || mG < 16 || nr % 16 || mG % 16)
    return (int)cudaErrorInvalidValue;
  const size_t bytes = smem_bytes(make_dims(nr, mG));
  if (bytes > 48 * 1024) {
    int rc = (int)cudaFuncSetAttribute(
        (const void*)admm_mixed_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (rc) return rc;
  }
  const int grid = (B + PHC_MIX_T - 1) / PHC_MIX_T;
  admm_mixed_kernel<<<grid, PHC_MIX_BLOCK, bytes, (cudaStream_t)stream>>>(
      q, lG, uG, lB, uB, z0G, y0G, z0B, y0B, (const bf16*)Ahi,
      (const bf16*)Alo, (const bf16*)Mhi, (const bf16*)Mlo, vec, zG, yG, zB,
      yB, B, nr, mG, iters, alpha);
  return (int)cudaGetLastError();
}

}  // extern "C"

// K1's split-precision leading iterations for Hopper (sm_90a): the bf16
// 3-pass products on the tensor cores through mma.sync. Plain C interface,
// loaded through ctypes by pyhybridcontrol_tpu_torch/ops/_build.py.
//
// Replaces the `iters_lo` phase of the Pallas TPU kernel `_admm_kernel`
// (pyhybridcontrol_tpu/ops/pallas_admm.py: `_mm3`, `_bf16_split` and the
// `half_lo` loop of `_phase`). The plain torch version beside it is
// admm_solve_plain(low_frac=) in ops/cuda_admm.py (`_mixed_plain`).
//
// What it computes: `iters` sigma=0 ADMM iterations in which each of the two
// products is  A.b ~= Ahi.bhi + Ahi.blo + Alo.bhi  with
// hi = bf16(a), lo = bf16(a - hi), bf16 inputs and fp32 accumulation. The
// constants are split once on the host side of the call; the iterate
// operand is split at every product. The z/y update is fp32, in the order of
// `_phase`. The inputs are the packed arrays of `_pack` (l_G is the constant
// -BIG of the one-sided G rows, as in K1, and is not passed). Only the
// iterates (zG, yG, zB, yB) leave the kernel: the full-precision tail, the
// final half step and the stats are K1 itself (phc_admm_k1 in admm.cu),
// launched warm from these iterates by the wrapper.
//
// A one-pass variant (template parameter PASSES = 1, entry point
// phc_admm_k1_mixed_1pass) keeps the Ahi.bhi pass alone: the reference's
// XLA "default" precision, one bf16 pass of the TPU's MXU a product
// (BoxQP.precision = "default" there and in the port). It stages no lo
// constants and writes no lo operands; the layout is the same.
//
// Design. The batch is the N of every product, so a block owns a tile of T
// problems (T = 16 or 32, a template parameter; ops/cuda_admm.plan_mixed
// picks T = 32 where T = 16 would take two rounds of blocks) and has one
// warp per 16 rows of u = M t: R/16 warps (R = mG + nr). Products are
// mma.sync m16n8k16 bf16 -> fp32, whose accumulator layout is fixed (lane l
// holds rows l/4 and l/4+8, problems 2(l%4) and 2(l%4)+1 of each n8 tile),
// so a lane's (row, problem) elements of u are the same in every iteration:
// its z, y and u live in registers for the whole solve, the update is
// applied straight from the accumulators, and the warp then writes the next
// product's operand (w_G = rho z - y split to bf16 hi/lo, or
// d o (rho_B z_B - y_B) in fp32 for the box rows) to shared memory. The
// t = A_G^T w_G product (nr x mG by mG x T) is dealt as (row tile, K slice)
// jobs over the same warps; one pass sums the K-slice partials, adds
// d o w_B - q and splits t. So an iteration has three barriers. Each A
// fragment loaded feeds T/8 MMAs.
//
// Shared memory: the bf16 hi/lo constants with row strides 8 elements over
// a multiple of 16 (the 8 rows of an ldmatrix phase fall in 8 different
// 16-byte bank groups), both operand tiles [k][problem] with XOR-swizzled
// 16-byte chunks (read by ldmatrix.trans, written as bf16 pairs, both
// conflict-free), and in accumulator order the K-slice partials, d o w_B,
// q and l_B, plus (rho, 1/rho, d) per row of u. A CPU test checks the
// congruences. At nr=64, mG=208, T=32: 230,144 bytes a block.
//
// Registers. Five of a block's 17 warps share one SM sub-partition's 16,384
// registers, so a thread has 96 at most (not the 120 that 65,536 / 544
// would give). The lane's z, y, u take 48 at T = 32; l_B, rho, 1/rho and
// d are read from shared memory once an iteration, only one B fragment is
// live at a time, and every shared-memory access goes through a 32-bit
// address. PERF.md has ptxas's report for both instantiations.
//
// What bounds it on the H100: at the bench-primary shape (nr=64, mG=208,
// B=4096, 100 iterations) the three passes are ~75 GFLOP of bf16 MMA,
// ~0.08 ms at the 989 TFLOP/s dense peak, against ~19 MB of inputs and
// outputs (~0.006 ms at 3.35 TB/s): operations bound it. T = 32 there is 128
// blocks on 132 SMs, one round, one block of 544 threads per SM. The kernel
// is bound by latency, not by the tensor cores: a warp's MMAs run as chains
// of three dependent passes behind ldmatrix loads, between three
// block-wide barriers. Measured times and the per-iteration split are in
// PERF.md. Left for later: the t product's A fragments resident in
// registers, wgmma with the constants in shared-memory descriptors, TMA
// staging, clusters sharing the constants, a persistent grid, packing in
// the kernel, and K1's tail and stats fused in.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

#define PHC_BIG 1e30f  // ops/admm.py BIG: l_G of every G row (G x <= h)
#define BIG4 make_float4(-PHC_BIG, -PHC_BIG, -PHC_BIG, -PHC_BIG)

// the widest block each instantiation is compiled for (17 and 20 warps); a
// thread may then have 96 registers: 5 warps share one SM sub-partition
template <int T>
struct MaxThreads;
template <>
struct MaxThreads<16> {
  static constexpr int value = 640;
};
template <>
struct MaxThreads<32> {
  static constexpr int value = 544;
};

struct Dims {
  int nr, mG, R, warps, nT, kT, ksplit, jobs;
};

__host__ __device__ inline Dims make_dims(int nr, int mG) {
  Dims d;
  d.nr = nr;
  d.mG = mG;
  d.R = nr + mG;
  d.warps = d.R / 16;  // one per 16 rows of u
  d.nT = nr / 16;      // row tiles of t
  d.kT = mG / 16;      // K tiles of the t product
  int ks = d.warps / d.nT;
  if (ks < 1) ks = 1;
  if (ks > d.kT) ks = d.kT;
  d.ksplit = ks;  // K slices per row tile of t
  d.jobs = d.nT * ks;
  return d;
}

// row strides (bf16 elements) of A_G^T and M: 8 over a multiple of 16, so
// the 8 rows (16 bytes each) of an ldmatrix phase fall in 8 different
// 16-byte bank groups of the 128-byte line
__host__ __device__ inline int stride_a(const Dims& d) { return d.mG + 8; }
__host__ __device__ inline int stride_m(const Dims& d) { return d.nr + 8; }

// element (r, p) of an operand tile [rows][T problems], bf16, unpadded: the
// 16-byte chunks of a row are XOR-swizzled by the row's place in its run of
// 128-byte lines, which spreads both an ldmatrix.trans phase (8 rows, one
// chunk each) and a warp's pair stores (8 rows, 4 words each) over all
// banks
template <int T>
__device__ __forceinline__ int swz(int r, int p) {
  constexpr int L = 64 / T;  // rows per 128-byte line
  constexpr int C = T / 8;   // 16-byte chunks per row
  return r * T + ((((p >> 3) ^ ((r / L) % C))) << 3) + (p & 7);
}

// shared memory: byte addresses (from `base`) of the bf16 tiles and of the
// fp32 arrays kept in accumulator order ([tile][n8 tile][lane] float4s)
struct Smem {
  uint32_t Ahi, Alo, Mhi, Mlo;  // A_G^T (nr x mG), M (R x nr), padded rows
  uint32_t whi, wlo, thi, tlo;  // operand tiles w (mG x T), t (nr x T), swz
  uint32_t part, dwb, q, lb;    // K-slice partials of t, d o w_B, q, l_B
  uint32_t rows;                // per row of u: (rho, 1/rho, d_box, 0)
  uint32_t end;
};

// every piece is a multiple of 16 bytes (ldmatrix rows, float4 accesses)
__host__ __device__ inline Smem carve(uint32_t base, const Dims& d, int T) {
  Smem s;
  uint32_t o = base;
  s.Ahi = o;  o += 2 * d.nr * stride_a(d);
  s.Alo = o;  o += 2 * d.nr * stride_a(d);
  s.Mhi = o;  o += 2 * d.R * stride_m(d);
  s.Mlo = o;  o += 2 * d.R * stride_m(d);
  s.whi = o;  o += 2 * d.mG * T;
  s.wlo = o;  o += 2 * d.mG * T;
  s.thi = o;  o += 2 * d.nr * T;
  s.tlo = o;  o += 2 * d.nr * T;
  s.part = o; o += 4 * d.jobs * 16 * T;
  s.dwb = o;  o += 4 * d.nr * T;
  s.q = o;    o += 4 * d.nr * T;
  s.lb = o;   o += 4 * d.nr * T;
  s.rows = o; o += 16 * d.R;
  s.end = o;
  return s;
}

__host__ __device__ inline size_t smem_bytes(const Dims& d, int T) {
  return carve(0, d, T).end;
}

__device__ __forceinline__ float clipf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);  // jnp.clip / torch.clamp order
}

// (a, b) -> bf16 hi and lo pairs as the operand tiles hold them (a in the
// low half): hi = bf16(v), lo = bf16(v - hi)
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// shared-memory accesses by 32-bit address (volatile: kept in program order
// between the barriers, never hoisted out of the iteration loop)
__device__ __forceinline__ void sts_b32(uint32_t a, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(a), "r"(v));
}

__device__ __forceinline__ void sts_f4(uint32_t a, float x, float y, float z,
                                       float w) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(a), "f"(x),
               "f"(y), "f"(z), "f"(w));
}

__device__ __forceinline__ float4 lds_f4(uint32_t a) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(a));
  return v;
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a.b, one m16n8k16 bf16 MMA with fp32 accumulation
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc += A.B over the K tiles [k0, k1) as the 3-pass product Ahi.Bhi +
// Alo.Bhi + Ahi.Blo (no lo.lo pass), or Ahi.Bhi alone (PASSES = 1; a_lo,
// b_lo unread). a_hi/a_lo: this lane's row address in
// K tile 0 of a 16-row A tile (row lane % 16, 8 columns on for lanes 16-31),
// so one ldmatrix.x4 gives the m16k16 fragment; b_hi/b_lo: the operand
// tile, K rows of T problems (swz), read transposed as two n8 fragments per
// ldmatrix.x4.trans. One B fragment is live at a time.
template <int T, int PASSES>
__device__ __forceinline__ void product(float (&acc)[T / 8][4], uint32_t a_hi,
                                        uint32_t a_lo, uint32_t b_hi,
                                        uint32_t b_lo, int k0, int k1,
                                        int lane) {
  const int kr = lane & 15, kc = (lane >> 4) * 8;
#pragma unroll 1
  for (int kt = k0; kt < k1; ++kt) {
    uint32_t ah[4], al[4], b[4];
    ldsm_x4(ah, a_hi + 32u * kt);
    if constexpr (PASSES == 3) ldsm_x4(al, a_lo + 32u * kt);
#pragma unroll
    for (int np = 0; np < T / 16; ++np) {
      // 16 rows further is a whole number of swizzle periods
      const uint32_t bo = 2u * (kt * 16 * T + swz<T>(kr, np * 16 + kc));
      ldsm_x4_t(b, b_hi + bo);
      mma_bf16(acc[2 * np], ah, b[0], b[1]);
      mma_bf16(acc[2 * np + 1], ah, b[2], b[3]);
      if constexpr (PASSES == 3) {
        mma_bf16(acc[2 * np], al, b[0], b[1]);
        mma_bf16(acc[2 * np + 1], al, b[2], b[3]);
        ldsm_x4_t(b, b_lo + bo);
        mma_bf16(acc[2 * np], ah, b[0], b[1]);
        mma_bf16(acc[2 * np + 1], ah, b[2], b[3]);
      }
    }
  }
}

// global bf16 (rows, cols) row-major -> shared with row stride `stride`,
// 16 bytes at a time (cols is a multiple of 16)
__device__ void stage(unsigned char* dst, const bf16* __restrict__ src,
                      int rows, int cols, int stride) {
  const int per = cols / 8;
  for (int v = threadIdx.x; v < rows * per; v += blockDim.x) {
    const int r = v / per, c = v % per;
    reinterpret_cast<uint4*>(dst + 2 * (size_t)r * stride)[c] =
        reinterpret_cast<const uint4*>(src + (size_t)r * cols)[c];
  }
}

// a lane's place in the block: its warp's 16 rows of u (G rows, or box
// rows: mG is a multiple of 16) and its elements [n8 tile nt][c], row
// i0 + 8 (c >> 1) of that block of rows, problem nt * 8 + 2 (lane % 4) +
// (c & 1)
struct Lane {
  int warp, lane, i0;
  bool box;
  uint32_t row;   // address of (rho, 1/rho, d) of row i0; + 128: i0 + 8
  uint32_t slot;  // byte offset of a box lane's float4s in accumulator order
};

template <int T>
__device__ __forceinline__ Lane place(int tid, uint32_t base, const Dims& d,
                                      const Smem& s) {
  Lane p;
  p.warp = tid >> 5;
  p.lane = tid & 31;
  p.box = p.warp * 16 >= d.mG;
  p.i0 = p.warp * 16 - (p.box ? d.mG : 0) + (p.lane >> 2);
  p.row = base + s.rows + 16u * (p.warp * 16 + (p.lane >> 2));
  p.slot = 16u * (p.box ? (p.warp - d.mG / 16) * (T / 8) * 32 + p.lane : 0);
  return p;
}

// a value read anew through an opaque move: what an iteration computes
// from it is not hoisted out of the loop into registers that would stay
// live across it (the lane's state needs them)
__device__ __forceinline__ uint32_t opaque(uint32_t v) {
  uint32_t r;
  asm volatile("mov.b32 %0, %1;\n" : "=r"(r) : "r"(v));
  return r;
}

// the next product's operand from the lane's z, y: w_G = rho z - y split
// to bf16 hi/lo (hi alone for PASSES = 1), or d o (rho_B z_B - y_B) in fp32
// for the box rows
template <int T, int PASSES>
__device__ __forceinline__ void emit(uint32_t base, const Smem& s,
                                     const Lane& p, const float4 (&rc)[2],
                                     const float (&z)[T / 8][4],
                                     const float (&y)[T / 8][4]) {
  if (!p.box) {
#pragma unroll
    for (int nt = 0; nt < T / 8; ++nt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t at =
            2u * swz<T>(p.i0 + 8 * h, nt * 8 + 2 * (p.lane & 3));
        uint32_t wh, wl;
        split2(rc[h].x * z[nt][2 * h] - y[nt][2 * h],
               rc[h].x * z[nt][2 * h + 1] - y[nt][2 * h + 1], wh, wl);
        sts_b32(base + s.whi + at, wh);
        if constexpr (PASSES == 3) sts_b32(base + s.wlo + at, wl);
      }
    }
  } else {
#pragma unroll
    for (int nt = 0; nt < T / 8; ++nt) {
      float e[4];
#pragma unroll
      for (int c = 0; c < 4; ++c)
        e[c] = rc[c >> 1].z * (rc[c >> 1].x * z[nt][c] - y[nt][c]);
      sts_f4(base + s.dwb + p.slot + 512u * nt, e[0], e[1], e[2], e[3]);
    }
  }
}

// d (the shape's dims) and s (the shared-memory layout from address 0) come
// as parameters: the constant bank holds them, not registers
template <int T, int PASSES>
__global__ void __launch_bounds__(MaxThreads<T>::value, 1)
admm_mixed_kernel(const float* __restrict__ q, const float* __restrict__ uG,
                  const float* __restrict__ lB, const float* __restrict__ uB,
                  const float* __restrict__ z0G, const float* __restrict__ y0G,
                  const float* __restrict__ z0B, const float* __restrict__ y0B,
                  const bf16* __restrict__ Ahi, const bf16* __restrict__ Alo,
                  const bf16* __restrict__ Mhi, const bf16* __restrict__ Mlo,
                  const float* __restrict__ vec, float* zG, float* yG,
                  float* zB, float* yB, const Dims d, const Smem s, int B,
                  int iters, float alpha) {
  constexpr int NT = T / 8;  // n8 tiles of the problem tile
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t sb = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const int nr = d.nr, mG = d.mG;
  const int items = d.nT * NT * 32;  // float4 items of t in accumulator order

  {
    const int b0 = blockIdx.x * T;
    stage(smem_raw + s.Ahi, Ahi, nr, mG, stride_a(d));
    stage(smem_raw + s.Mhi, Mhi, d.R, nr, stride_m(d));
    if constexpr (PASSES == 3) {
      stage(smem_raw + s.Alo, Alo, nr, mG, stride_a(d));
      stage(smem_raw + s.Mlo, Mlo, d.R, nr, stride_m(d));
    }
    // per row of u: (rho, 1/rho, d_box, 0), from vec packed as for K1:
    // [dbox, 1/dbox, rhoB, 1/rhoB, 1/E_B, 1/(D c) | rhoG, 1/rhoG, 1/E_G]
    float4* const rows4 = reinterpret_cast<float4*>(smem_raw + s.rows);
    for (int r = threadIdx.x; r < d.R; r += blockDim.x) {
      const int j = r - mG;
      rows4[r] = r < mG ? make_float4(vec[6 * nr + r], vec[6 * nr + mG + r],
                                      0.f, 0.f)
                        : make_float4(vec[2 * nr + j], vec[3 * nr + j],
                                      vec[j], 0.f);
    }
    // q and l_B in accumulator order (problems past the end of the batch: 0)
    float4* const q4 = reinterpret_cast<float4*>(smem_raw + s.q);
    float4* const lb4 = reinterpret_cast<float4*>(smem_raw + s.lb);
    for (int v = threadIdx.x; v < items; v += blockDim.x) {
      const int ln = v & 31, nt = (v >> 5) % NT, jt = (v >> 5) / NT;
      const int j = jt * 16 + (ln >> 2), b = b0 + nt * 8 + 2 * (ln & 3);
      float e[4], l[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int bc = b + (c & 1);
        const size_t at = (size_t)bc * nr + j + 8 * (c >> 1);
        e[c] = bc < B ? q[at] : 0.f;
        l[c] = bc < B ? lB[at] : 0.f;
      }
      q4[v] = make_float4(e[0], e[1], e[2], e[3]);
      lb4[v] = make_float4(l[0], l[1], l[2], l[3]);
    }
  }
  __syncthreads();

  // the lane's z, y and u stay in registers for the whole solve; l_B is
  // read from the box lane's slots of s.lb, l_G is the constant -BIG
  float z[NT][4], y[NT][4], hi[NT][4];
  {
    const Lane p = place<T>(threadIdx.x, sb, d, s);
    const int b0 = blockIdx.x * T, rows = p.box ? nr : mG;
    const float* usrc = p.box ? uB : uG;
    const float* zsrc = p.box ? z0B : z0G;
    const float* ysrc = p.box ? y0B : y0G;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float4 l4 =
          p.box ? lds_f4(sb + s.lb + p.slot + 512u * nt) : BIG4;
      const float lo[4] = {l4.x, l4.y, l4.z, l4.w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int b = b0 + nt * 8 + 2 * (p.lane & 3) + (c & 1);
        const size_t at = (size_t)b * rows + p.i0 + 8 * (c >> 1);
        const bool in = b < B;
        hi[nt][c] = in ? usrc[at] : 0.f;
        z[nt][c] = clipf(in && zsrc ? zsrc[at] : 0.f, lo[c], hi[nt][c]);
        y[nt][c] = in && ysrc ? ysrc[at] : 0.f;
      }
    }
    const float4 rc[2] = {lds_f4(p.row), lds_f4(p.row + 128u)};
    emit<T, PASSES>(sb, s, p, rc, z, y);
  }
  __syncthreads();

  for (int k = 0; k < iters; ++k) {
    const int tid = (int)opaque(threadIdx.x);
    const uint32_t base = opaque(sb);
    const Lane p = place<T>(tid, base, d, s);
    // 1. partial tiles of t = A_G^T w_G: row tile jt, K slice ks
    for (int job = p.warp; job < d.jobs; job += d.warps) {
      const int jt = job / d.ksplit, ks = job % d.ksplit;
      const uint32_t a =
          2u * ((jt * 16 + (p.lane & 15)) * stride_a(d) + (p.lane >> 4) * 8);
      float acc[NT][4] = {};
      product<T, PASSES>(acc, base + s.Ahi + a, base + s.Alo + a,
                         base + s.whi,
                 base + s.wlo, ks * d.kT / d.ksplit,
                 (ks + 1) * d.kT / d.ksplit, p.lane);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        sts_f4(base + s.part + 16u * ((job * NT + nt) * 32 + p.lane),
               acc[nt][0], acc[nt][1], acc[nt][2], acc[nt][3]);
    }
    __syncthreads();
    // 2. t = sum of the partials + d o w_B - q, split to bf16 hi/lo
    for (int v = tid; v < items; v += blockDim.x) {
      const int ln = v & 31, nt = (v >> 5) % NT, jt = (v >> 5) / NT;
      const uint32_t pa =
          base + s.part + 16u * ((jt * d.ksplit * NT + nt) * 32 + ln);
      float4 a = lds_f4(pa);
      for (int ks = 1; ks < d.ksplit; ++ks) {
        const float4 b = lds_f4(pa + 16u * ks * NT * 32);
        a.x += b.x;
        a.y += b.y;
        a.z += b.z;
        a.w += b.w;
      }
      const float4 dw = lds_f4(base + s.dwb + 16u * v);
      const float4 qq = lds_f4(base + s.q + 16u * v);
      const int j = jt * 16 + (ln >> 2), pp = nt * 8 + 2 * (ln & 3);
      uint32_t th, tl;
      split2(a.x + dw.x - qq.x, a.y + dw.y - qq.y, th, tl);
      sts_b32(base + s.thi + 2u * swz<T>(j, pp), th);
      if constexpr (PASSES == 3)
        sts_b32(base + s.tlo + 2u * swz<T>(j, pp), tl);
      split2(a.z + dw.z - qq.z, a.w + dw.w - qq.w, th, tl);
      sts_b32(base + s.thi + 2u * swz<T>(j + 8, pp), th);
      if constexpr (PASSES == 3)
        sts_b32(base + s.tlo + 2u * swz<T>(j + 8, pp), tl);
    }
    __syncthreads();
    // 3. u = M t for this warp's rows, then the z/y update from the
    // accumulators (alpha relaxation, clip, dual step), then the operand
    float acc[NT][4] = {};
    {
      const uint32_t a = 2u * ((p.warp * 16 + (p.lane & 15)) * stride_m(d) +
                               (p.lane >> 4) * 8);
      product<T, PASSES>(acc, base + s.Mhi + a, base + s.Mlo + a,
                         base + s.thi,
                 base + s.tlo, 0, nr / 16, p.lane);
    }
    const float4 rc[2] = {lds_f4(p.row), lds_f4(p.row + 128u)};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float4 l4 =
          p.box ? lds_f4(base + s.lb + p.slot + 512u * nt) : BIG4;
      const float lo[4] = {l4.x, l4.y, l4.z, l4.w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float rho = rc[c >> 1].x, rhoi = rc[c >> 1].y;
        const float zr = alpha * acc[nt][c] + (1.f - alpha) * z[nt][c];
        const float zn = clipf(zr + y[nt][c] * rhoi, lo[c], hi[nt][c]);
        y[nt][c] = y[nt][c] + rho * (zr - zn);
        z[nt][c] = zn;
      }
    }
    emit<T, PASSES>(base, s, p, rc, z, y);
    __syncthreads();
  }

  {
    const Lane p = place<T>((int)opaque(threadIdx.x), sb, d, s);
    const int b0 = (int)opaque(blockIdx.x) * T, rows = p.box ? nr : mG;
    float* zdst = p.box ? zB : zG;
    float* ydst = p.box ? yB : yG;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int b = b0 + nt * 8 + 2 * (p.lane & 3) + (c & 1);
        if (b < B) {
          const size_t at = (size_t)b * rows + p.i0 + 8 * (c >> 1);
          zdst[at] = z[nt][c];
          ydst[at] = y[nt][c];
        }
      }
    }
  }
}

template <int T, int PASSES>
int launch(const float* q, const float* uG, const float* lB, const float* uB,
           const float* z0G, const float* y0G, const float* z0B,
           const float* y0B, const void* Ahi, const void* Alo,
           const void* Mhi, const void* Mlo, const float* vec, float* zG,
           float* yG, float* zB, float* yB, int B, int nr, int mG, int iters,
           float alpha, cudaStream_t st) {
  const Dims d = make_dims(nr, mG);
  const int threads = 32 * d.warps;
  if (threads > MaxThreads<T>::value) return (int)cudaErrorInvalidValue;
  const Smem s = carve(0, d, T);
  int rc = (int)cudaFuncSetAttribute(
      (const void*)admm_mixed_kernel<T, PASSES>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s.end);
  if (rc) return rc;
  const int grid = (B + T - 1) / T;
  admm_mixed_kernel<T, PASSES><<<grid, threads, s.end, st>>>(
      q, uG, lB, uB, z0G, y0G, z0B, y0B, (const bf16*)Ahi, (const bf16*)Alo,
      (const bf16*)Mhi, (const bf16*)Mlo, vec, zG, yG, zB, yB, d, s, B, iters,
      alpha);
  return (int)cudaGetLastError();
}

// the instantiation of tile width T (16 or 32) and PASSES
template <int PASSES>
int dispatch(const float* q, const float* uG, const float* lB,
             const float* uB, const float* z0G, const float* y0G,
             const float* z0B, const float* y0B, const void* Ahi,
             const void* Alo, const void* Mhi, const void* Mlo,
             const float* vec, float* zG, float* yG, float* zB, float* yB,
             int B, int nr, int mG, int iters, float alpha, int T,
             cudaStream_t st) {
  if (B < 1 || nr < 16 || mG < 16 || nr % 16 || mG % 16)
    return (int)cudaErrorInvalidValue;
  if (T == 16)
    return launch<16, PASSES>(q, uG, lB, uB, z0G, y0G, z0B, y0B, Ahi, Alo,
                              Mhi, Mlo, vec, zG, yG, zB, yB, B, nr, mG,
                              iters, alpha, st);
  if (T == 32)
    return launch<32, PASSES>(q, uG, lB, uB, z0G, y0G, z0B, y0B, Ahi, Alo,
                              Mhi, Mlo, vec, zG, yG, zB, yB, B, nr, mG,
                              iters, alpha, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dynamic shared memory one block of tile T needs (nr, mG multiples of 16)
int phc_admm_mixed_smem_bytes(int nr, int mG, int T) {
  return (int)smem_bytes(make_dims(nr, mG), T);
}

const char* phc_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// the split phase of three bf16 passes a product
int phc_admm_k1_mixed(const float* q, const float* uG,
                      const float* lB, const float* uB, const float* z0G,
                      const float* y0G, const float* z0B, const float* y0B,
                      const void* Ahi, const void* Alo, const void* Mhi,
                      const void* Mlo, const float* vec, float* zG, float* yG,
                      float* zB, float* yB, int B, int nr, int mG, int iters,
                      float alpha, int T, void* stream) {
  return dispatch<3>(q, uG, lB, uB, z0G, y0G, z0B, y0B, Ahi, Alo, Mhi, Mlo,
                     vec, zG, yG, zB, yB, B, nr, mG, iters, alpha, T,
                     (cudaStream_t)stream);
}

// the same with one bf16 pass a product (Alo, Mlo unread)
int phc_admm_k1_mixed_1pass(const float* q, const float* uG,
                            const float* lB, const float* uB,
                            const float* z0G, const float* y0G,
                            const float* z0B, const float* y0B,
                            const void* Ahi, const void* Alo,
                            const void* Mhi, const void* Mlo,
                            const float* vec, float* zG, float* yG,
                            float* zB, float* yB, int B, int nr, int mG,
                            int iters, float alpha, int T, void* stream) {
  return dispatch<1>(q, uG, lB, uB, z0G, y0G, z0B, y0B, Ahi, Alo, Mhi, Mlo,
                     vec, zG, yG, zB, yB, B, nr, mG, iters, alpha, T,
                     (cudaStream_t)stream);
}

}  // extern "C"

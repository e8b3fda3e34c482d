// Batched σ=0 ADMM kernels for Hopper (sm_90a), with a plain C interface
// loaded through ctypes by pyhybridcontrol_tpu_torch/ops/_build.py.
//
// Replaces the two Pallas TPU kernels of pyhybridcontrol_tpu/ops/pallas_admm.py:
//   K1 phc_admm_k1 <- _admm_kernel      (launched by _pallas_run)
//   K2 phc_admm_k2 <- _admm_wave_kernel (launched by _pallas_wave_run)
// The plain torch versions beside them are admm_solve_plain and
// admm_wave_plain in ops/cuda_admm.py; both compute the same function.
//
// Each iteration is two products and an elementwise update,
//   t = Â_Gᵀ w_G + d∘w_B − q̂          (nr outputs, depth mGp)
//   ẑ = M t, then the over-relaxed projection and dual step of each row
//                                      (R = mGp+nr outputs, depth nr)
// in exact fp32 FMAs on the CUDA cores (the B&B path takes no TF32 and no
// bf16); the stats reductions (objective, certificate sums) are fp64.
//
// What bounds it on the H100. The work is compute: 2·nr·(2·mGp+nr) FLOP
// per problem and iteration against a few KB of input per problem, so the
// roofline bound is operations over the 67 TFLOP/s fp32 peak. What a kernel
// of plain FMAs meets first is the shared-memory pipe: one SM starts 4 warp
// FMAs a clock but serves one 128-byte shared-memory wavefront a clock. With
// one problem per block both products are matrix-vector: every FMA needs a
// matrix word (a wavefront per warp-wide load) and an iterate word (a
// broadcast, still a load to issue), two loads per FMA, so the pipe caps the
// kernel near 1/8 of the FMA peak (~8 TFLOP/s); three barriers an iteration,
// serial chains of nr FMAs and idle threads in the larger product keep a
// one-problem block at a quarter of that.
//
// The design:
//  - A block owns a tile of PB problems (template parameter: 8, 4 or 1; the
//    wrapper's plan picks the largest that leaves ~2 blocks per SM and
//    fits). Iterates lie in shared memory problem-fastest ([row][PB]), so
//    one 16-byte load brings four problems of a row. A thread accumulates a
//    register tile of RT rows × PB problems: a matrix word feeds PB FMAs, an
//    iterate vector RT. Loads issued per FMA: PB=8 3/8 and 3/16 (the
//    two products), PB=4 2/4 and 2/8, PB=1 2/1 as before -- that
//    instantiation serves batches too small to fill the card, where the
//    dependent chain of one iteration, not throughput, sets the time.
//  - Work is dealt in warp tasks: a warp takes RT·32/KS output rows (4 of t,
//    16 of ẑ) and splits the depth over KS lane groups (interleaved, so the
//    lanes of a group read neighbouring words; the row strides of Â_G and Mᵀ
//    are padded so that the groups hit different banks). The partial sums
//    are reduced inside the product by a shuffle reduce-scatter, after which
//    every lane owns a share of the task's outputs and runs their update: no
//    reduce pass, two barriers an iteration, and the serial FMA chain of an
//    output falls from nr to nr/KS. The block has as many warps (8-12, up to
//    18 for a tile of 8; the plan's choice from the shape) as divides the
//    tasks of both products best: 9 at N=10 (R = 136 is 8 more than a
//    multiple of 32: 8 and 8.5 of 9 warps at work), 17 at N=20 with a tile
//    of 8 (16 and 16.5 of 17). Measured: with one block per SM (N=20, where
//    the constants take 127 KB) warps in flight count for more than loads
//    per FMA -- tasks of 8 and 32 rows (RT 2 and 4, 9 warps) took 1.82 ms
//    where these take 1.58 (K1, B=4096, 100 iterations).
//  - M2ᵀ and the stiff ρ are staged over Mᵀ and ρ just before the stiff
//    probe phase and Mᵀ comes back after it (from L2, twice per block), so
//    K2 needs no more shared memory than K1.
//  - Packing is done here: the kernels read q, h, lb, ub in original units
//    and the warm iterates through row strides (the public (B, m+n) layout,
//    or the split-precision phase's padded arrays), apply cost_scale·D, E
//    and the ±BIG clamp with the same single multiplications as the plain
//    version's _pack, and write x·D, z and y in the public layout. l_G is
//    the constant −BIG and is not read.
//  - Stats run over the whole block: P̂x, Âᵀy and Âᵀδy are three more
//    products of the same routine (P̂ᵀ read from L2, coalesced), the row
//    reductions are split over all threads and combined across warps in
//    shared memory, sums in fp64.
//  - Streamed variant (template flag STREAM) for shapes whose constants do
//    not fit a block: the tile's iterates stay in shared memory, Â_G, Mᵀ
//    and K2's M2ᵀ are read from device memory (L2 holds them: config 2's
//    are ~1.5 MB of the H100's 50 MB) in the same padded layout as the
//    staged copies, so the products are the same code on another pointer.
//    The plan (ops/cuda_admm.py) takes it only where a tile of one problem
//    with staged constants would not fit.
//  - Split mode (template flag SPLIT of K1 and of `phase`): the first
//    iters_lo iterations take each product as the reference's _mm3 does,
//    hi = bf16(a), lo = bf16(a − hi), Ahi·bhi + Ahi·blo + Alo·bhi with fp32
//    accumulation, on the CUDA cores (each bf16×bf16 product is exact in
//    fp32); then the full-precision iterations, the half step and the
//    stats as usual. It serves the split-precision phase (low_frac) at the
//    shapes the tensor-core kernel of admm_mixed.cu refuses (N ≥ 22 of the
//    double integrator); the operand splits are recomputed per use, three
//    FMAs per product term: simple, right, and about 4× the work of a
//    full-precision iteration.
// What is left: the matrix words of a thread's slice are the same in every
// iteration and could live in registers (needs compile-time nr, mGp: one
// build per shape); constants are staged with plain loads (cp.async.bulk
// would overlap them with the first iterations); a second tile per block
// sharing the constants (more warps in flight at N=20); tensor cores for an
// exact fp32 product (3×TF32 or bf16 splits, the batch as the N dimension).
// Measured times are in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#define PHC_BIG 1e30f
#define PHC_RED 16  // floats of reduction workspace per warp and problem

// One launch's arguments; ops/cuda_admm.py mirrors the layout field by
// field (ctypes.Structure), so the order here is part of the interface.
struct PhcAdmmArgs {
  // problem data in original units: q (B,n), h (B,m), lb/ub (B,n)
  const float *q, *h, *lb, *ub;
  // warm iterates (null: cold), G rows and box rows apart
  const float *z0G, *y0G, *z0B, *y0B;
  // constants: Â_G (mGp,nr) and Mᵀ (nr,R) with the padded row strides
  // stride_A(nr) and stride_M(R), P̂ᵀ (nr,nr), the per-row vectors
  // vec = [dbox, 1/dbox, ρ_B, 1/ρ_B, 1/E_B, 1/(D·c) | ρ_G, 1/ρ_G, 1/E_G]
  // and io = [c·D, E_B, D | E_G] (nr, nr, nr, mGp)
  const float *AG, *MT, *PT, *vec, *io;
  // K2: binary mask (nr), stiff Mᵀ and vec
  const float *binm, *MT2, *vec2;
  // results: x (B,n), z and y (B,m+n), stats (B,8); K2: the probe's too
  float *x, *z, *y, *st, *xp, *zp, *yp, *stp;
  // row strides (in floats; 0 for a row shared by the batch) of q, h, lb,
  // ub and of the four warm arrays
  int sq, sh, slb, sub, sz0G, sy0G, sz0B, sy0B;
  // iters_lo: split-mode iterations (K1) before the `iters` full ones
  int B, n, m, nr, mGp, iters, iters_lo, p1, p2;
  float alpha, alpha2, cinv;
};

namespace {

typedef PhcAdmmArgs Args;

// tile shapes per problem-tile width: product A (t = Â_Gᵀw, depth mGp) and
// product B (ẑ = M t, depth nr); RT rows per thread, depth over KS lanes;
// WARPS: the most warps a block may have (the register budget follows)
template <int PB> struct Cfg;
template <> struct Cfg<8> {
  enum { A_RT = 1, A_KS = 8, B_RT = 2, B_KS = 4, WARPS = 18 };
};
template <> struct Cfg<4> {
  enum { A_RT = 1, A_KS = 8, B_RT = 2, B_KS = 4, WARPS = 12 };
};
template <> struct Cfg<1> {
  enum { A_RT = 1, A_KS = 8, B_RT = 1, B_KS = 2, WARPS = 12 };
};
__host__ __device__ inline int max_warps(int PB) {
  return PB == 8 ? (int)Cfg<8>::WARPS
                 : (PB == 4 ? (int)Cfg<4>::WARPS : (int)Cfg<1>::WARPS);
}

// shared-memory row strides: Â_G rows so that the KS=8 lane groups of
// product A hit different banks, Mᵀ rows so that two groups 1 row apart do
__host__ __device__ inline int stride_A(int nr) {
  return nr + 4;                                      // ≡ 4 mod 8
}
__host__ __device__ inline int stride_M(int R) {
  return R + (48 - R % 32) % 32;                      // ≡ 16 mod 32
}

// streamed: Â_G and Mᵀ stay in device memory and take no shared memory
__host__ __device__ inline size_t smem_floats(int nr, int mGp, int PB,
                                              bool streamed) {
  const size_t R = (size_t)mGp + nr;
  const size_t consts = streamed ? 0
                        : (size_t)mGp * stride_A(nr) +
                              (size_t)nr * stride_M((int)R);
  return consts + 3 * R + 2 * (size_t)nr +
         (size_t)PB * (6 * R + 6 * (size_t)nr + PHC_RED * max_warps(PB));
}

// shared-memory carve-up; per-problem arrays are [row][PB]
struct Smem {
  float *AG, *MT;                    // constants, padded row strides AS, RS
                                     // (device memory, read only, if STREAM)
  float *rho, *rhoi, *einv;          // R each: G rows then box rows
  float *dbox, *dboxi;               // nr each
  float *z, *y, *w, *lo, *hi, *dy;   // R·PB each; w holds ẑ after a half step
  float *q, *t, *x, *Px, *Aty, *Atdy;  // nr·PB each
  float *red;                        // PHC_RED·(most warps)·PB
  int AS, RS;
};

template <int PB, bool STREAM>
__device__ __forceinline__ Smem carve(float* p, const Args& a) {
  Smem s;
  const int nr = a.nr, mGp = a.mGp, R = mGp + nr;
  s.AS = stride_A(nr);
  s.RS = stride_M(R);
  if constexpr (STREAM) {
    s.AG = const_cast<float*>(a.AG);
    s.MT = const_cast<float*>(a.MT);
  } else {
    s.AG = p;  p += (size_t)mGp * s.AS;
    s.MT = p;  p += (size_t)nr * s.RS;
  }
  s.rho = p;  p += R;
  s.rhoi = p;  p += R;
  s.einv = p;  p += R;
  s.dbox = p;  p += nr;
  s.dboxi = p;  p += nr;
  s.z = p;  p += R * PB;
  s.y = p;  p += R * PB;
  s.w = p;  p += R * PB;
  s.lo = p;  p += R * PB;
  s.hi = p;  p += R * PB;
  s.dy = p;  p += R * PB;
  s.q = p;  p += nr * PB;
  s.t = p;  p += nr * PB;
  s.x = p;  p += nr * PB;
  s.Px = p;  p += nr * PB;
  s.Aty = p;  p += nr * PB;
  s.Atdy = p;  p += nr * PB;
  s.red = p;
  return s;
}

__device__ __forceinline__ float clipf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);  // jnp.clip / torch.clamp order
}

// W consecutive floats, W·4-byte aligned (W = 1, 2, 4, 8)
template <int W>
__device__ __forceinline__ void vload(float (&d)[W], const float* p) {
  if constexpr (W == 1) {
    d[0] = *p;
  } else if constexpr (W == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    d[0] = v.x;  d[1] = v.y;
  } else {
#pragma unroll
    for (int i = 0; i < W; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + i);
      d[i] = v.x;  d[i + 1] = v.y;  d[i + 2] = v.z;  d[i + 3] = v.w;
    }
  }
}

template <int W>
__device__ __forceinline__ void vstore(float* p, const float (&d)[W]) {
  if constexpr (W == 1) {
    *p = d[0];
  } else if constexpr (W == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(d[0], d[1]);
  } else {
#pragma unroll
    for (int i = 0; i < W; i += 4)
      *reinterpret_cast<float4*>(p + i) =
          make_float4(d[i], d[i + 1], d[i + 2], d[i + 3]);
  }
}

// hi = bf16(x), lo = bf16(x − hi) as floats (x − hi is exact in fp32)
__device__ __forceinline__ void bf16_split(float x, float& hi, float& lo) {
  hi = __bfloat162float(__float2bfloat16_rn(x));
  lo = __bfloat162float(__float2bfloat16_rn(x - hi));
}

// Shuffle reduce-scatter of N partial sums over the lane groups that differ
// in the lane bits M, M/2, ..., G: while more than one sum is live, each
// step sends one half and keeps the other (`off` moves to the kept half);
// once one is left, a butterfly add, after which the lane whose bit is 0
// stays the owner. On return the lane owns sums [off, off + max(N/KS, 1)).
template <int N, int M, int G>
struct Reduce {
  static __device__ __forceinline__ void run(float* acc, int lane, int& off,
                                             bool& owner) {
    if constexpr (M >= G) {
      const bool bit = (lane & M) != 0;
      if constexpr (N > 1) {
        constexpr int H = N / 2;
#pragma unroll
        for (int i = 0; i < H; ++i) {
          const float a = acc[i], b = acc[i + H];
          acc[i] = (bit ? b : a) +
                   __shfl_xor_sync(0xffffffffu, bit ? a : b, M);
        }
        off += bit ? H : 0;
        Reduce<H, M / 2, G>::run(acc, lane, off, owner);
      } else {
        acc[0] += __shfl_xor_sync(0xffffffffu, acc[0], M);
        owner = owner && !bit;
        Reduce<1, M / 2, G>::run(acc, lane, off, owner);
      }
    }
  }
};

// out[o][p] = Σ_c Mat[c·stride + o] · vec[c·PB + p] for o < O, p < PB, depth
// K (a multiple of KS), dealt over the block in warp tasks; epi(o, p, v)
// receives W = min(PB, max(RT·PB/KS, 1)) sums of row o, problems p..p+W-1.
// SPLIT: each term as the three bf16 products hi·hi + hi·lo + lo·hi.
// Every warp must call it (shuffles); barriers are the caller's.
template <int PB, int RT, int KS, bool SPLIT = false, class Epi>
__device__ __forceinline__ void product(const float* __restrict__ Mat,
                                        int stride,
                                        const float* __restrict__ vec, int K,
                                        int O, Epi epi) {
  constexpr int G = 32 / KS, RPT = RT * G, N = RT * PB;
  constexpr int NF = (N / KS > 0) ? N / KS : 1;
  constexpr int W = NF < PB ? NF : PB;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int ks = lane / G, rgl = lane % G;
  const int ntasks = (O + RPT - 1) / RPT;
  for (int task = warp; task < ntasks; task += nw) {
    int o0 = task * RPT + rgl * RT;
    const bool valid = o0 < O;   // O is a multiple of 8: whole groups
    if (!valid) o0 = 0;
    float acc[N];
#pragma unroll
    for (int i = 0; i < N; ++i) acc[i] = 0.f;
    const float* mp = Mat + (size_t)ks * stride + o0;
    const float* vp = vec + ks * PB;
#pragma unroll 4
    for (int c = ks; c < K; c += KS) {
      float a[RT], v[PB];
      vload<RT>(a, mp);
      vload<PB>(v, vp);
      if constexpr (SPLIT) {
        float ah[RT], al[RT];
#pragma unroll
        for (int r = 0; r < RT; ++r) bf16_split(a[r], ah[r], al[r]);
#pragma unroll
        for (int p = 0; p < PB; ++p) {
          float vh, vl;
          bf16_split(v[p], vh, vl);
#pragma unroll
          for (int r = 0; r < RT; ++r) {
            float& c = acc[r * PB + p];
            c = fmaf(ah[r], vh, c);
            c = fmaf(ah[r], vl, c);
            c = fmaf(al[r], vh, c);
          }
        }
      } else {
#pragma unroll
        for (int r = 0; r < RT; ++r)
#pragma unroll
          for (int p = 0; p < PB; ++p)
            acc[r * PB + p] = fmaf(a[r], v[p], acc[r * PB + p]);
      }
      mp += (size_t)KS * stride;
      vp += KS * PB;
    }
    int off = 0;
    bool owner = valid;
    Reduce<N, 16, G>::run(acc, lane, off, owner);
    if (owner) {
#pragma unroll
      for (int e0 = 0; e0 < NF; e0 += W) {
        float v[W];
#pragma unroll
        for (int i = 0; i < W; ++i) v[i] = acc[e0 + i];
        const int e = off + e0;
        epi(o0 + e / PB, e % PB, v);
      }
    }
  }
}

// `iters` σ=0 iterations from the iterates in shared memory, then -- if
// `final_half` -- one more half step whose ẑ goes to s.w and δy to s.dy
// (the iterates stay those of the last full iteration). SPLIT: both
// products in split mode. Mirrors _phase of the reference and of
// ops/cuda_admm.py. Ends on a barrier.
template <int PB, bool SPLIT>
__device__ __forceinline__ void phase(const Smem& s, int nr, int mGp,
                                      int iters, float alpha,
                                      bool final_half) {
  typedef Cfg<PB> C;
  const int R = mGp + nr;
  for (int idx = threadIdx.x; idx < R * PB; idx += blockDim.x)
    s.w[idx] = s.rho[idx / PB] * s.z[idx] - s.y[idx];
  __syncthreads();
  for (int k = 0; k <= iters; ++k) {
    const bool last = (k == iters);
    if (last && !final_half) break;
    // t = Â_Gᵀ w_G + d∘w_B − q̂
    product<PB, C::A_RT, C::A_KS, SPLIT>(
        s.AG, s.AS, s.w, mGp, nr, [&](int j, int p, const auto& v) {
          constexpr int W = sizeof(v) / sizeof(float);
          const int o = j * PB + p;
          float wb[W], q[W], t[W];
          vload<W>(wb, s.w + mGp * PB + o);
          vload<W>(q, s.q + o);
          const float d = s.dbox[j];
#pragma unroll
          for (int i = 0; i < W; ++i) t[i] = v[i] + d * wb[i] - q[i];
          vstore<W>(s.t + o, t);
        });
    __syncthreads();
    // ẑ = M t, fused with the update of the rows a lane owns
    product<PB, C::B_RT, C::B_KS, SPLIT>(
        s.MT, s.RS, s.t, nr, R, [&](int r, int p, const auto& u) {
          constexpr int W = sizeof(u) / sizeof(float);
          const int o = r * PB + p;
          float z[W], y[W], lo[W], hi[W], wn[W];
          vload<W>(z, s.z + o);
          vload<W>(y, s.y + o);
          vload<W>(lo, s.lo + o);
          vload<W>(hi, s.hi + o);
          const float rho = s.rho[r], rhoi = s.rhoi[r];
#pragma unroll
          for (int i = 0; i < W; ++i) {
            const float zr = alpha * u[i] + (1.f - alpha) * z[i];
            const float zn = clipf(zr + y[i] * rhoi, lo[i], hi[i]);
            const float dy = rho * (zr - zn);
            if (last) {
              wn[i] = u[i];
              y[i] = dy;
            } else {
              z[i] = zn;
              y[i] = y[i] + dy;
              wn[i] = rho * zn - y[i];
            }
          }
          vstore<W>(s.w + o, wn);
          if (last) {
            vstore<W>(s.dy + o, y);
          } else {
            vstore<W>(s.z + o, z);
            vstore<W>(s.y + o, y);
          }
        });
    __syncthreads();
  }
}

__device__ __forceinline__ float group_max(float v, int from) {
  for (int o = 16; o >= from; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ double group_sum(double v, int from) {
  for (int o = 16; o >= from; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// (8,) stats of each problem of the tile: obj, r_prim, r_rel, r_dual,
// infeasibility certificate, 0, 0, 0 -- in original units. Mirrors _stats.
// Reads ẑ from s.w, δy from s.dy, x̃ from s.x. Ends on a barrier.
template <int PB>
__device__ __forceinline__ void stats(const Smem& s, const Args& a, int b0,
                                      float* st) {
  typedef Cfg<PB> C;
  const int nr = a.nr, mGp = a.mGp, R = mGp + nr;
  const float* dci = a.vec + 5 * nr;
  // P̂x (P̂ᵀ from device memory, neighbouring lanes neighbouring words),
  // Âᵀy and Âᵀδy
  product<PB, C::A_RT, C::A_KS>(
      a.PT, nr, s.x, nr, nr, [&](int j, int p, const auto& v) {
        constexpr int W = sizeof(v) / sizeof(float);
        vstore<W>(s.Px + j * PB + p, v);
      });
  product<PB, C::A_RT, C::A_KS>(
      s.AG, s.AS, s.y, mGp, nr, [&](int j, int p, const auto& v) {
        constexpr int W = sizeof(v) / sizeof(float);
        const int o = j * PB + p;
        float yb[W], r[W];
        vload<W>(yb, s.y + mGp * PB + o);
#pragma unroll
        for (int i = 0; i < W; ++i) r[i] = v[i] + s.dbox[j] * yb[i];
        vstore<W>(s.Aty + o, r);
      });
  product<PB, C::A_RT, C::A_KS>(
      s.AG, s.AS, s.dy, mGp, nr, [&](int j, int p, const auto& v) {
        constexpr int W = sizeof(v) / sizeof(float);
        const int o = j * PB + p;
        float yb[W], r[W];
        vload<W>(yb, s.dy + mGp * PB + o);
#pragma unroll
        for (int i = 0; i < W; ++i) r[i] = v[i] + s.dbox[j] * yb[i];
        vstore<W>(s.Atdy + o, r);
      });
  __syncthreads();
  // row reductions: thread (p, rows p-strided), then lanes of one p, then
  // warps through shared memory
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = blockDim.x >> 5;
  const int p = tid % PB;
  float r_prim = 0.f, r_rel = 0.f, r_dual = 0.f, dy_norm = 0.f, atdy = 0.f;
  double xpx = 0.0, qx = 0.0, support = 0.0, gap = 0.0;
  for (int r = tid / PB; r < R; r += blockDim.x / PB) {
    const int o = r * PB + p;
    const float zt = s.w[o], lo = s.lo[o], hi = s.hi[o], ei = s.einv[r];
    const float dy = s.dy[o];
    const float viol = fabsf(zt - clipf(zt, lo, hi)) * ei;
    r_prim = fmaxf(r_prim, viol);
    r_rel = fmaxf(r_rel, viol / fmaxf(1.f, fabsf(zt * ei)));
    dy_norm = fmaxf(dy_norm, fabsf(dy));
    const double dyp = (double)fmaxf(dy, 0.f), dyn = (double)fminf(dy, 0.f);
    const bool finu = hi < 0.9f * PHC_BIG, finl = lo > -0.9f * PHC_BIG;
    support += (finu ? 0.0 : dyp) + (finl ? 0.0 : -dyn);
    gap += (finu ? (double)hi * dyp : 0.0) + (finl ? (double)lo * dyn : 0.0);
    if (r >= mGp) {
      const int j = r - mGp, oj = j * PB + p;
      const float x = s.x[oj], q = s.q[oj], px = s.Px[oj];
      r_dual = fmaxf(r_dual, fabsf((px + q + s.Aty[oj]) * dci[j]));
      atdy = fmaxf(atdy, fabsf(s.Atdy[oj]));
      xpx += (double)x * (double)px;
      qx += (double)q * (double)x;
    }
  }
  r_prim = group_max(r_prim, PB);
  r_rel = group_max(r_rel, PB);
  r_dual = group_max(r_dual, PB);
  dy_norm = group_max(dy_norm, PB);
  atdy = group_max(atdy, PB);
  xpx = group_sum(xpx, PB);
  qx = group_sum(qx, PB);
  support = group_sum(support, PB);
  gap = group_sum(gap, PB);
  if (lane < PB) {
    float* f = s.red + (size_t)(warp * PB + p) * PHC_RED;
    double* d = reinterpret_cast<double*>(f);   // 8-byte aligned: PHC_RED even
    d[0] = xpx;  d[1] = qx;  d[2] = support;  d[3] = gap;
    f[8] = r_prim;  f[9] = r_rel;  f[10] = r_dual;  f[11] = dy_norm;
    f[12] = atdy;
  }
  __syncthreads();
  if (tid < PB && b0 + tid < a.B) {
    r_prim = r_rel = r_dual = dy_norm = atdy = 0.f;
    xpx = qx = support = gap = 0.0;
    for (int w = 0; w < nw; ++w) {
      const float* f = s.red + (size_t)(w * PB + tid) * PHC_RED;
      const double* d = reinterpret_cast<const double*>(f);
      xpx += d[0];  qx += d[1];  support += d[2];  gap += d[3];
      r_prim = fmaxf(r_prim, f[8]);
      r_rel = fmaxf(r_rel, f[9]);
      r_dual = fmaxf(r_dual, f[10]);
      dy_norm = fmaxf(dy_norm, f[11]);
      atdy = fmaxf(atdy, f[12]);
    }
    const double eps_c = 1e-4, dn = (double)dy_norm;
    const bool cert = dn > 1e-12 && (double)atdy <= eps_c * dn &&
                      support <= eps_c * dn && gap <= -eps_c * dn;
    float* out = st + (size_t)(b0 + tid) * 8;
    out[0] = (float)((0.5 * xpx + qx) * (double)a.cinv);
    out[1] = r_prim;
    out[2] = r_rel;
    out[3] = r_dual;
    out[4] = cert ? 1.f : 0.f;
    out[5] = out[6] = out[7] = 0.f;
  }
  __syncthreads();
}

// `count` floats (a multiple of 4) of a constant, already in its padded
// layout, from device memory into shared memory
__device__ __forceinline__ void stage(float* dst, const float* src,
                                      int count) {
  for (int i = 4 * threadIdx.x; i < count; i += 4 * blockDim.x)
    *reinterpret_cast<float4*>(dst + i) =
        *reinterpret_cast<const float4*>(src + i);
}

// ρ and 1/ρ of all R rows from a packed per-row vector
__device__ __forceinline__ void stage_rho(const Smem& s, const float* vec,
                                          int nr, int mGp) {
  for (int r = threadIdx.x; r < mGp + nr; r += blockDim.x) {
    const bool g = r < mGp;
    s.rho[r] = g ? vec[6 * nr + r] : vec[2 * nr + r - mGp];
    s.rhoi[r] = g ? vec[6 * nr + mGp + r] : vec[3 * nr + r - mGp];
  }
}

// constants (Â_G and Mᵀ unless STREAM), then the tile's problems: scaled
// data, bounds and the clipped initial iterates. Rows past m and n and
// problems past B are inert (l = u = 0, q = 0).
template <int PB, bool STREAM>
__device__ __forceinline__ void load_tile(const Smem& s, const Args& a,
                                          int b0) {
  const int nr = a.nr, mGp = a.mGp, R = mGp + nr, n = a.n, m = a.m;
  if constexpr (!STREAM) {
    stage(s.AG, a.AG, mGp * s.AS);
    stage(s.MT, a.MT, nr * s.RS);
  }
  stage_rho(s, a.vec, nr, mGp);
  for (int r = threadIdx.x; r < R; r += blockDim.x)
    s.einv[r] = r < mGp ? a.vec[6 * nr + 2 * mGp + r] : a.vec[4 * nr + r - mGp];
  for (int j = threadIdx.x; j < nr; j += blockDim.x) {
    s.dbox[j] = a.vec[j];
    s.dboxi[j] = a.vec[nr + j];
  }
  const float *qsc = a.io, *eb = a.io + nr, *eg = a.io + 3 * nr;
  for (int idx = threadIdx.x; idx < R * PB; idx += blockDim.x) {
    const int p = idx / R, r = idx % R;   // rows fastest: coalesced reads
    const size_t b = (size_t)b0 + p;
    const bool live = b < (size_t)a.B;
    float lo = 0.f, hi = 0.f, z0 = 0.f, y0 = 0.f;
    if (r < mGp) {
      if (live && r < m) {
        lo = -PHC_BIG;
        hi = a.h[b * a.sh + r] * eg[r];
        if (a.z0G) z0 = a.z0G[b * a.sz0G + r];
        if (a.y0G) y0 = a.y0G[b * a.sy0G + r];
      }
    } else {
      const int j = r - mGp;
      float q = 0.f;
      if (live && j < n) {
        lo = clipf(a.lb[b * a.slb + j] * eb[j], -PHC_BIG, PHC_BIG);
        hi = clipf(a.ub[b * a.sub + j] * eb[j], -PHC_BIG, PHC_BIG);
        q = a.q[b * a.sq + j] * qsc[j];
        if (a.z0B) z0 = a.z0B[b * a.sz0B + j];
        if (a.y0B) y0 = a.y0B[b * a.sy0B + j];
      }
      s.q[j * PB + p] = q;
    }
    const int o = r * PB + p;
    s.lo[o] = lo;
    s.hi[o] = hi;
    s.z[o] = clipf(z0, lo, hi);
    s.y[o] = y0;
  }
}

// x̃ = ẑ_B / d into s.x; x = D·x̃, z and y (public layout) and the stats
// of the tile's problems to device memory
template <int PB>
__device__ __forceinline__ void store_tile(const Smem& s, const Args& a,
                                           int b0, float* x, float* z,
                                           float* y, float* st) {
  const int nr = a.nr, mGp = a.mGp, R = mGp + nr, n = a.n, m = a.m;
  const int mt = m + n;
  const float* dsc = a.io + 2 * nr;
  for (int idx = threadIdx.x; idx < R * PB; idx += blockDim.x) {
    const int p = idx / R, r = idx % R;
    const size_t b = (size_t)b0 + p;
    const bool live = b < (size_t)a.B;
    const int o = r * PB + p;
    if (r < mGp) {
      if (live && r < m) {
        z[b * mt + r] = s.z[o];
        y[b * mt + r] = s.y[o];
      }
    } else {
      const int j = r - mGp;
      const float xv = s.w[o] * s.dboxi[j];
      s.x[j * PB + p] = xv;
      if (live && j < n) {
        x[b * n + j] = dsc[j] * xv;
        z[b * mt + m + j] = s.z[o];
        y[b * mt + m + j] = s.y[o];
      }
    }
  }
  __syncthreads();
  stats<PB>(s, a, b0, st);
}

// K1 (WAVE false) or K2 on the tile of blockIdx.x; SPLIT (K1 only): the
// first iters_lo iterations in split mode
template <int PB, bool STREAM, bool WAVE, bool SPLIT>
__device__ __forceinline__ void solve_tile(const Args& a) {
  extern __shared__ __align__(16) float smem[];
  const int nr = a.nr, mGp = a.mGp;
  const Smem s = carve<PB, STREAM>(smem, a);
  const int b0 = blockIdx.x * PB;
  load_tile<PB, STREAM>(s, a, b0);
  __syncthreads();

  // ---- relaxation ----
  if constexpr (SPLIT) phase<PB, true>(s, nr, mGp, a.iters_lo, a.alpha, false);
  phase<PB, false>(s, nr, mGp, a.iters, a.alpha, true);
  store_tile<PB>(s, a, b0, a.x, a.z, a.y, a.st);
  if constexpr (WAVE) {
    // ---- probe bounds: binaries fixed to the rounded relaxation ----
    // ẑ_B is E_box·x; clip to the node box first so fixed binaries keep
    // their value, round half to even (rintf == jnp.round == torch.round)
    const float* ebi = s.einv + mGp;
    for (int idx = threadIdx.x; idx < nr * PB; idx += blockDim.x) {
      const int j = idx / PB, o = mGp * PB + idx;
      float lo = s.lo[o], hi = s.hi[o];
      if (a.binm[j] > 0.f) {
        const float xo = clipf(s.w[o], lo, hi) * ebi[j];
        const float pv = rintf(clipf(xo, 0.f, 1.f)) / ebi[j];
        lo = pv;
        hi = pv;
        s.lo[o] = lo;
        s.hi[o] = hi;
      }
      s.z[o] = clipf(s.z[o], lo, hi);
    }
    // ---- probe: stiff-ρ then base-ρ, warm-chained in shared memory ----
    if (a.p1 > 0) {
      // M2ᵀ and the stiff ρ take Mᵀ's and ρ's place for this phase only
      // (streamed: the phase reads M2ᵀ where it lies)
      Smem s2 = s;
      if constexpr (STREAM)
        s2.MT = const_cast<float*>(a.MT2);
      else
        stage(s.MT, a.MT2, nr * s.RS);
      stage_rho(s, a.vec2, nr, mGp);
      __syncthreads();
      phase<PB, false>(s2, nr, mGp, a.p1, a.alpha2, false);
      if constexpr (!STREAM) stage(s.MT, a.MT, nr * s.RS);
      stage_rho(s, a.vec, nr, mGp);
    }
    __syncthreads();
    phase<PB, false>(s, nr, mGp, a.p2, a.alpha, true);
    store_tile<PB>(s, a, b0, a.xp, a.zp, a.yp, a.stp);
  }
}

template <int PB, bool STREAM, bool SPLIT>
__global__ void __launch_bounds__(Cfg<PB>::WARPS * 32)
admm_k1_kernel(const Args a) {
  solve_tile<PB, STREAM, false, SPLIT>(a);
}

template <int PB, bool STREAM>
__global__ void __launch_bounds__(Cfg<PB>::WARPS * 32)
admm_k2_kernel(const Args a) {
  solve_tile<PB, STREAM, true, false>(a);
}

template <int PB, bool STREAM, bool WAVE, bool SPLIT>
int launch(const Args& a, int threads, cudaStream_t stream) {
  const size_t bytes = smem_floats(a.nr, a.mGp, PB, STREAM) * sizeof(float);
  void (*kernel)(const Args);
  if constexpr (WAVE)
    kernel = admm_k2_kernel<PB, STREAM>;
  else
    kernel = admm_k1_kernel<PB, STREAM, SPLIT>;
  if (bytes > 48 * 1024) {
    const int rc = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (rc) return rc;
  }
  kernel<<<(a.B + PB - 1) / PB, threads, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

// the instantiation of one tile width: staged or streamed, split or not
template <int PB, bool WAVE>
int launch_variant(const Args& a, bool streamed, cudaStream_t st,
                   int threads) {
  if constexpr (WAVE) {
    return streamed ? launch<PB, true, true, false>(a, threads, st)
                    : launch<PB, false, true, false>(a, threads, st);
  } else {
    const bool split = a.iters_lo > 0;
    if (streamed)
      return split ? launch<PB, true, false, true>(a, threads, st)
                   : launch<PB, true, false, false>(a, threads, st);
    return split ? launch<PB, false, false, true>(a, threads, st)
                 : launch<PB, false, false, false>(a, threads, st);
  }
}

template <bool WAVE>
int launch_pb(const Args& a, int pb, int streamed, int threads,
              void* stream) {
  if (threads < 32 || threads > max_warps(pb) * 32 || threads % 32)
    return (int)cudaErrorInvalidConfiguration;
  if (a.iters_lo < 0 || (WAVE && a.iters_lo != 0))
    return (int)cudaErrorInvalidValue;      // split mode is K1's alone
  cudaStream_t st = (cudaStream_t)stream;
  switch (pb) {
    case 1: return launch_variant<1, WAVE>(a, streamed != 0, st, threads);
    case 4: return launch_variant<4, WAVE>(a, streamed != 0, st, threads);
    case 8: return launch_variant<8, WAVE>(a, streamed != 0, st, threads);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dynamic shared memory one block of K1 or K2 needs with a tile of pb
// problems, constants staged (streamed = 0) or read from device memory
// (the same for both kernels: M2ᵀ is staged over Mᵀ)
int phc_admm_smem_bytes(int nr, int mGp, int pb, int streamed) {
  return (int)(smem_floats(nr, mGp, pb, streamed != 0) * sizeof(float));
}

const char* phc_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// K1 on a batch: `a` as the wrapper filled it (a->iters_lo > 0: split
// mode first); pb, streamed and threads from its plan
int phc_admm_k1(const PhcAdmmArgs* a, int pb, int streamed, int threads,
                void* stream) {
  return launch_pb<false>(*a, pb, streamed, threads, stream);
}

// K2 (relaxation, probe bounds, two-phase probe) on a batch
int phc_admm_k2(const PhcAdmmArgs* a, int pb, int streamed, int threads,
                void* stream) {
  return launch_pb<true>(*a, pb, streamed, threads, stream);
}

}  // extern "C"

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
//    two products), PB=4 2/4 and 2/8, PB=1 2/1 and 2/4 -- that
//    instantiation serves batches too small to fill the card, where the
//    dependent chain of one iteration, not throughput, sets the time. Its
//    ẑ = M t takes four rows a thread and the depth over 8 lane groups:
//    serial chains of nr/8 FMAs, not nr/2 (PERF.md has the times).
//  - Work is dealt in warp tasks: a warp takes RT·32/KS output rows (4 of t,
//    16 of ẑ) and splits the depth over KS lane groups (the lanes of a
//    group read neighbouring words; the row strides of Â_G and Mᵀ are
//    padded so that the groups hit different banks), interleaved over the
//    depth; the rows of t and Mᵀ lie permuted (t_row) so that each group of
//    ẑ = M t sums a contiguous run of variables. The partial sums
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
//  - Streamed variant (template flag STREAM): the tile's iterates stay in
//    shared memory, Â_G, Mᵀ and K2's M2ᵀ are read from device memory (L2
//    holds them) in the same padded layout as the staged copies, so the
//    products are the same code on another pointer. Every block reads the
//    whole matrix set in every iteration, so L2's rate bounds it (1.4 to
//    5.9 TB/s of constants on the real frames, 3-30x its bound: PERF.md). The
//    plan (ops/cuda_admm.py) takes it only for shapes no cluster of 16 holds;
//    chip_smoke.py forces it to hold the resident variant against it.
//  - Resident variant (the cl_* functions and *_resident_kernel, kept apart
//    from the block's: folded into one body, the block variants lost
//    registers and occupancy) for shapes whose constants do not fit one
//    block: a thread-block cluster of C CTAs (2-16) owns one tile, and each
//    CTA keeps a slice of the constants in its shared memory for the whole
//    launch, copied once with cp.async.bulk (completion on an mbarrier).
//    The slices follow the output rows: a CTA owns whole warp tasks of both
//    products (deal_start), i.e. the columns of Â_G of its rows of t and
//    the columns of Mᵀ of its rows of ẑ, each with a padded stride of its
//    own width (same bank rule). Per-row state (z, y, l, u, δy, ρ) lives
//    only on the CTA that owns the row; w (ẑ after a half step) and t are
//    needed whole as the depth vectors of the next product, so after each
//    product a CTA sends its rows into every other CTA's copy (distributed
//    shared memory: w's, a contiguous run, by one bulk copy a CTA; t's,
//    rows t_row apart, by st.async stores), each completing bytes on the
//    receiver's mbarrier, and a CTA waits for the bytes of the others. No
//    cluster barrier runs inside the iterations: its release fence is what
//    costs (0.39-0.72 µs a barrier, 0.04-0.05 relaxed; PERF.md). Every
//    output is the same task of the same routine over the same depth in the
//    same order, so x, z and y are bitwise those of the other variants at
//    the same tile; the stats sum each CTA's rows, then rank 0 sums the
//    CTAs (fp64, another order). K2's stiff phase copies each CTA's M2ᵀ
//    slice over its Mᵀ slice and back, as the staged variant does. The plan
//    takes the largest tile that, over the smallest cluster whose CTAs hold
//    it, still gives ~2 CTAs per SM: an iteration's exchange and waits cost
//    about as much for a tile of 8 as for 1.
//  - Split mode (template parameter LO of K1 and of `phase`: 3 or 1 bf16
//    passes; 0 is full precision): the first iters_lo iterations take each
//    product as the reference's _mm3 does, hi = bf16(a), lo = bf16(a − hi),
//    Ahi·bhi + Ahi·blo + Alo·bhi with fp32 accumulation, on the CUDA cores
//    (each bf16×bf16 product is exact in fp32); then the full-precision
//    iterations, the half step and the stats as usual. It serves the
//    split-precision phase (low_frac) at the shapes the tensor-core kernel
//    of admm_mixed.cu refuses (N ≥ 22 of the double integrator); the
//    operand splits are recomputed per use, three FMAs per product term:
//    simple, right, and about 4× the work of a full-precision iteration.
//    LO = 1 (entry point phc_admm_k1_1pass) keeps the Ahi·bhi pass alone:
//    the reference's XLA "default" precision (one bf16 MXU pass).
// What is left: tensor cores for the exact products (3×TF32 or bf16 splits,
// the batch as the N dimension, wgmma with the resident slices behind
// descriptors); fewer bytes between the CTAs (w's box rows are needed by
// the CTA that owns the matching row of t only); matrix words of a
// thread's slice in registers (one build per shape); the split mode's
// products on the tensor cores above N=21. Measured times are in PERF.md.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define PHC_BIG 1e30f
#define PHC_RED 16  // floats of reduction workspace per warp and problem

namespace cg = cooperative_groups;

// One launch's arguments; ops/cuda_admm.py mirrors the layout field by
// field (ctypes.Structure), so the order here is part of the interface.
struct PhcAdmmArgs {
  // problem data in original units: q (B,n), h (B,m), lb/ub (B,n)
  const float *q, *h, *lb, *ub;
  // warm iterates (null: cold), G rows and box rows apart
  const float *z0G, *y0G, *z0B, *y0B;
  // constants: Â_G (mGp,nr) and Mᵀ (nr,R) with the padded row strides
  // stride_A(nr) and stride_M(R) (resident variant: the C slices one after
  // the other, each with the strides of its own width), P̂ᵀ (nr,nr), the
  // per-row vectors
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

// output rows of one warp task: product A (rows of t) and B (rows of ẑ),
// RT·32/KS of every Cfg below; the resident variant deals whole tasks
constexpr int TASK_A = 4, TASK_B = 16;

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
  enum { A_RT = 1, A_KS = 8, B_RT = 4, B_KS = 8, WARPS = 12 };
};
template <int PB> struct TaskRows {
  static_assert(Cfg<PB>::A_RT * 32 / Cfg<PB>::A_KS == TASK_A &&
                    Cfg<PB>::B_RT * 32 / Cfg<PB>::B_KS == TASK_B,
                "warp tasks of every tile must cover TASK_A / TASK_B rows");
};
template struct TaskRows<8>;
template struct TaskRows<4>;
template struct TaskRows<1>;

__host__ __device__ inline int max_warps(int PB) {
  return PB == 8 ? (int)Cfg<8>::WARPS
                 : (PB == 4 ? (int)Cfg<4>::WARPS : (int)Cfg<1>::WARPS);
}

// the most warps a CTA of the resident variant may have: fewer than a
// block's at a tile of 8 (its CTAs own fewer tasks), so that K2's three
// phases fit in 128 registers, not 96, and do not spill
constexpr int RESIDENT_WARPS_8 = 16;
__host__ __device__ inline int resident_warps(int PB) {
  return PB == 8 ? RESIDENT_WARPS_8 : max_warps(PB);
}

__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }

// shared-memory row strides: Â_G rows so that the KS=8 lane groups of
// product A hit different banks, Mᵀ rows so that two groups 1 row apart do
__host__ __device__ inline int stride_A(int nr) {
  return nr + 4;                                      // ≡ 4 mod 8
}
__host__ __device__ inline int stride_M(int R) {
  return R + (48 - R % 32) % 32;                      // ≡ 16 mod 32
}

// the same rule for a resident CTA's slice of w columns (a multiple of 4:
// ≡ 4 mod 8 with the least padding; stride_M serves every multiple of 8)
__host__ __device__ inline int slice_stride_A(int w) {
  return w + (12 - w % 8) % 8;
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

// first warp task of rank k when n tasks are dealt to C CTAs: contiguous
// runs, the first n % C ranks one task more (so rank 0 owns the most)
__host__ __device__ inline int deal_start(int n, int C, int k) {
  return k * (n / C) + imin(k, n % C);
}

// The rows a CTA owns. A block of the staged or streamed variant owns
// every row (C = 1); a CTA of a cluster owns whole warp tasks of both
// products: tasks [a0, a1) of product A are the rows [jA, jA + nA) of t,
// tasks [b0, b1) of product B the rows [rB, rB + nB) of ẑ (the last task
// may run past R: its lanes there are idle).
struct Part {
  int a0, a1, b0, b1, jA, nA, rB, nB;
};

__host__ __device__ inline Part part_of(int nr, int mGp, int C, int k) {
  Part q;
  const int R = mGp + nr;
  const int na = nr / TASK_A;
  const int nb = (R + TASK_B - 1) / TASK_B;
  q.a0 = deal_start(na, C, k);
  q.a1 = deal_start(na, C, k + 1);
  q.b0 = deal_start(nb, C, k);
  q.b1 = deal_start(nb, C, k + 1);
  q.jA = TASK_A * q.a0;
  q.nA = TASK_A * (q.a1 - q.a0);
  q.rB = TASK_B * q.b0;
  q.nB = imin(TASK_B * q.b1, R) - q.rB;
  return q;
}

// the resident variant with C CTAs a tile: what one CTA needs (every CTA
// takes rank 0's, the largest part): three mbarriers, the slices of Â_G and
// Mᵀ,
// ρ, 1/ρ, 1/E of its rows of ẑ, d_box of its rows of t, 1/d_box, and per
// problem w and the gather buffer (R), t and x (nr), z, y, l, u, δy of its
// rows of ẑ, q, P̂x, Âᵀy, Âᵀδy of its rows of t, and the reductions of the
// warps and of the cluster's CTAs
__host__ __device__ inline size_t cluster_smem_floats(int nr, int mGp, int PB,
                                                      int C) {
  const Part q = part_of(nr, mGp, C, 0);
  const size_t R = (size_t)mGp + nr;
  const size_t consts = (size_t)mGp * slice_stride_A(q.nA) +
                        (size_t)nr * stride_M(q.nB);
  return 8 + consts + 3 * (size_t)q.nB + (size_t)q.nA + (size_t)nr +
         (size_t)PB * (2 * R + 2 * (size_t)nr + 5 * (size_t)q.nB +
                       4 * (size_t)q.nA + PHC_RED * (resident_warps(PB) + C));
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

// hi = bf16(x) as a float
__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// hi = bf16(x), lo = bf16(x − hi) as floats (x − hi is exact in fp32)
__device__ __forceinline__ void bf16_split(float x, float& hi, float& lo) {
  hi = bf16_round(x);
  lo = bf16_round(x - hi);
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

// out[o][p] = Σ_c Mat[c·stride + o − col0] · vec[c·PB + p] for the rows o
// of warp tasks [t0, t1) (o < O), p < PB, depth K (a multiple of KS), the
// tasks dealt over the block's warps; Mat holds the columns from col0 on
// (a CTA's slice; 0: the whole matrix). epi(o, p, v) receives W =
// min(PB, max(RT·PB/KS, 1)) sums of row o, problems p..p+W-1.
// LO = 3: each term as the three bf16 products hi·hi + hi·lo + lo·hi;
// LO = 1: as hi·hi alone; LO = 0: the fp32 product.
// Every warp must call it (shuffles); barriers are the caller's.
template <int PB, int RT, int KS, int LO = 0, class Epi>
__device__ __forceinline__ void product(const float* __restrict__ Mat,
                                        int stride,
                                        const float* __restrict__ vec, int K,
                                        int O, int t0, int t1, int col0,
                                        Epi epi) {
  constexpr int G = 32 / KS, RPT = RT * G, N = RT * PB;
  constexpr int NF = (N / KS > 0) ? N / KS : 1;
  constexpr int W = NF < PB ? NF : PB;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int ks = lane / G, rgl = lane % G;
  for (int task = t0 + warp; task < t1; task += nw) {
    int o0 = task * RPT + rgl * RT;
    const bool valid = o0 < O;   // O is a multiple of 8: whole groups
    if (!valid) o0 = col0;
    float acc[N];
#pragma unroll
    for (int i = 0; i < N; ++i) acc[i] = 0.f;
    const float* mp = Mat + (size_t)ks * stride + (o0 - col0);
    const float* vp = vec + ks * PB;
#pragma unroll 4
    for (int c = ks; c < K; c += KS) {
      float a[RT], v[PB];
      vload<RT>(a, mp);
      vload<PB>(v, vp);
      if constexpr (LO == 1) {
        float ah[RT];
#pragma unroll
        for (int r = 0; r < RT; ++r) ah[r] = bf16_round(a[r]);
#pragma unroll
        for (int p = 0; p < PB; ++p) {
          const float vh = bf16_round(v[p]);
#pragma unroll
          for (int r = 0; r < RT; ++r)
            acc[r * PB + p] = fmaf(ah[r], vh, acc[r * PB + p]);
        }
      } else if constexpr (LO == 3) {
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


template <int PB, int RT, int KS, int LO = 0, class Epi>
__device__ __forceinline__ void product(const float* __restrict__ Mat,
                                        int stride,
                                        const float* __restrict__ vec, int K,
                                        int O, Epi epi) {
  constexpr int RPT = RT * (32 / KS);
  product<PB, RT, KS, LO>(Mat, stride, vec, K, O, 0, (O + RPT - 1) / RPT,
                             0, epi);
}

// Row of t (and of Mᵀ, laid out to match by ops/cuda_admm.py) that holds
// variable j: ẑ = M t deals its depth to KS lane groups, one row in KS
// each, and this order makes those rows a contiguous run of variables. Terms
// that cancel sit next to each other in ẑ = M t (a variable's column and its
// neighbours'); dealt out in variable order they fell into different
// groups, whose partial sums grew large and rounded: on config 3's blocked
// DEWH frame x came out ~7x further from fp64 than the plain version's
// after one half step, and on config 4b's wave x was 7.3e-4 from the plain
// version, whose own x moves 1.2e-4 under a one-ulp change of q̂ (PERF.md).
template <int KS>
__device__ __forceinline__ int t_row(int j, int nr) {
  const int kc = nr / KS;
  return (j % kc) * KS + j / kc;
}

// `iters` σ=0 iterations from the iterates in shared memory, then -- if
// `final_half` -- one more half step whose ẑ goes to s.w and δy to s.dy
// (the iterates stay those of the last full iteration). LO > 0: both
// products in split mode of LO passes. Mirrors _phase of the reference and
// of ops/cuda_admm.py. Ends on a barrier.
template <int PB, int LO>
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
    product<PB, C::A_RT, C::A_KS, LO>(
        s.AG, s.AS, s.w, mGp, nr, [&](int j, int p, const auto& v) {
          constexpr int W = sizeof(v) / sizeof(float);
          const int o = j * PB + p;
          float wb[W], q[W], t[W];
          vload<W>(wb, s.w + mGp * PB + o);
          vload<W>(q, s.q + o);
          const float d = s.dbox[j];
#pragma unroll
          for (int i = 0; i < W; ++i) t[i] = v[i] + d * wb[i] - q[i];
          vstore<W>(s.t + t_row<C::B_KS>(j, nr) * PB + p, t);
        });
    __syncthreads();
    // ẑ = M t, fused with the update of the rows a lane owns
    product<PB, C::B_RT, C::B_KS, LO>(
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

// K1 (WAVE false) or K2 on the tile of blockIdx.x; LO > 0 (K1 only): the
// first iters_lo iterations in split mode of LO passes
template <int PB, bool STREAM, bool WAVE, int LO>
__device__ __forceinline__ void solve_tile(const Args& a) {
  extern __shared__ __align__(16) float smem[];
  const int nr = a.nr, mGp = a.mGp;
  const Smem s = carve<PB, STREAM>(smem, a);
  const int b0 = blockIdx.x * PB;
  load_tile<PB, STREAM>(s, a, b0);
  __syncthreads();

  // ---- relaxation ----
  if constexpr (LO > 0)
    phase<PB, LO>(s, nr, mGp, a.iters_lo, a.alpha, false);
  phase<PB, 0>(s, nr, mGp, a.iters, a.alpha, true);
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
      phase<PB, 0>(s2, nr, mGp, a.p1, a.alpha2, false);
      if constexpr (!STREAM) stage(s.MT, a.MT, nr * s.RS);
      stage_rho(s, a.vec, nr, mGp);
    }
    __syncthreads();
    phase<PB, 0>(s, nr, mGp, a.p2, a.alpha, true);
    store_tile<PB>(s, a, b0, a.xp, a.zp, a.yp, a.stp);
  }
}

// ---- the resident variant: one tile over a thread-block cluster ----
// The same iteration as `phase`, `stats`, `load_tile`, `store_tile` and
// `solve_tile` above, kept apart from them: folded into one body with the
// block's, the staged K2 at a tile of 4 took 126 registers where it takes
// 74, one block an SM where it holds two, and its wave ran 45% slower.

// shared-memory carve-up of a cluster's CTA; per-problem arrays are
// [row][PB], "own" arrays hold the rows of the CTA's Part; every array has
// the size of rank 0's part, so that w, t, g and red lie at the same
// offsets in every CTA of the cluster
struct CSmem {
  float *AG, *MT;                    // this CTA's slices, row strides AS, RS
  float *rho, *rhoi, *einv;          // own rows of ẑ: G rows then box rows
  float *dbox;                       // own rows of t
  float *dboxi;                      // nr
  float *z, *y, *lo, *hi, *dy;       // own rows of ẑ, ·PB
  float *w, *g;                      // R·PB: w holds ẑ after a half step; g
                                     // gathers y and δy for the stats
  float *q, *Px, *Aty, *Atdy;        // own rows of t, ·PB
  float *t, *x;                      // nr·PB each
  float *red;                        // PHC_RED·(most warps + C)·PB
  uint64_t* bar;                     // mbarriers: bulk copies, t's, w's
  int AS, RS;
};

template <int PB>
__device__ __forceinline__ CSmem cl_carve(float* p, const Args& a,
                                          const Part& own, int C) {
  CSmem s;
  const int nr = a.nr, mGp = a.mGp, R = mGp + nr;
  const Part big = part_of(nr, mGp, C, 0);
  const int nA = big.nA, nB = big.nB;
  s.bar = reinterpret_cast<uint64_t*>(p);  p += 8;
  s.w = p;  p += R * PB;
  s.t = p;  p += nr * PB;
  s.g = p;  p += R * PB;
  s.red = p;  p += PHC_RED * (resident_warps(PB) + C) * PB;
  s.z = p;  p += nB * PB;
  s.y = p;  p += nB * PB;
  s.lo = p;  p += nB * PB;
  s.hi = p;  p += nB * PB;
  s.dy = p;  p += nB * PB;
  s.q = p;  p += nA * PB;
  s.Px = p;  p += nA * PB;
  s.Aty = p;  p += nA * PB;
  s.Atdy = p;  p += nA * PB;
  s.x = p;  p += nr * PB;
  s.rho = p;  p += nB;
  s.rhoi = p;  p += nB;
  s.einv = p;  p += nB;
  s.dbox = p;  p += nA;
  s.dboxi = p;  p += nr;
  s.AS = slice_stride_A(own.nA);
  s.RS = stride_M(own.nB);
  s.AG = p;  p += (size_t)mGp * s.AS;
  s.MT = p;
  return s;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// one thread copies `count` floats (a multiple of 4) of the device layout
// into shared memory with bulk copies that complete on `bar` (the caller
// announced the bytes with bar_expect)
__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          int count, uint64_t* bar) {
  constexpr int CHUNK = 8192;          // floats a copy
  for (int i = 0; i < count; i += CHUNK) {
    const int bytes = 4 * imin(CHUNK, count - i);
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst + i)),
        "l"(src + i), "r"(bytes), "r"(smem_addr(bar))
        : "memory");
  }
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also expects `bytes` of bulk copies; before async
// writes over shared memory the generic proxy has read, a proxy fence
__device__ __forceinline__ void bar_expect(uint64_t* bar, int bytes) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// every thread: wait for the phase of parity `parity` to complete
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// a cluster barrier (arrive.release, wait.acquire: the writes into other
// CTAs' shared memory are seen after it)
__device__ __forceinline__ void cluster_sync() { cg::this_cluster().sync(); }

// A CTA writes what it computed into every other CTA's shared memory
// (distributed shared memory), all threads together: `count` floats (a
// multiple of 4) from src to the same place as dst in the others (dst: an
// address in this CTA's shared memory); seen after a cluster barrier
__device__ __forceinline__ void publish(float* dst, const float* src,
                                        int count) {
  cg::cluster_group cl = cg::this_cluster();
  const int C = (int)cl.num_blocks(), me = (int)cl.block_rank();
  const int n4 = count / 4;
  for (int i = threadIdx.x; i < (C - 1) * n4; i += blockDim.x) {
    const int k = i / n4, e = 4 * (i - k * n4);
    int r = me + 1 + k;                // the others, starting past this one
    if (r >= C) r -= C;
    *reinterpret_cast<float4*>(cl.map_shared_rank(dst + e, r)) =
        *reinterpret_cast<const float4*>(src + e);
  }
}

// In the iterations the CTAs exchange t and w without a barrier: each
// store into another CTA (st.async, or a bulk copy) completes bytes on that
// CTA's mbarrier of t (bar[1]) or of w (bar[2]), where its thread 0
// announced what it expects from the others in this round, and a CTA waits
// for that phase. A round's sends follow the sender's wait for the other
// vector from every CTA, which those sent after their last read of this
// one: one buffer each is enough, and no release fence is paid.
__device__ __forceinline__ uint32_t mapa(const void* p, int rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(a)
               : "r"(smem_addr(p)), "r"(rank));
  return a;
}

template <int V>
__device__ __forceinline__ void st_async(uint32_t a, const float* v,
                                         uint32_t bar) {
  if constexpr (V == 1) {
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
        "[%2];\n" ::"r"(a),
        "r"(__float_as_uint(v[0])), "r"(bar)
        : "memory");
  } else {
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], "
        "{%1, %2, %3, %4}, [%5];\n" ::"r"(a),
        "r"(__float_as_uint(v[0])), "r"(__float_as_uint(v[1])),
        "r"(__float_as_uint(v[2])), "r"(__float_as_uint(v[3])), "r"(bar)
        : "memory");
  }
}

// this CTA's round of one exchange: thread 0 announces the bytes the
// others send (one arrival)
__device__ __forceinline__ void expect_bytes(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// the own rows of t (PB floats at t_row) into every other CTA, completing
// bytes on their mbarrier `bar`
template <int PB, int KS>
__device__ __forceinline__ void send_t(float* t, const Part& pt, int nr,
                                       uint64_t* bar) {
  constexpr int V = PB < 4 ? PB : 4, NV = PB / V;
  cg::cluster_group cl = cg::this_cluster();
  const int C = (int)cl.num_blocks(), me = (int)cl.block_rank();
  const int n = pt.nA * NV;
  for (int i = threadIdx.x; i < (C - 1) * n; i += blockDim.x) {
    const int k = i / n, e = i - k * n;
    int r = me + 1 + k;
    if (r >= C) r -= C;
    const int o = t_row<KS>(pt.jA + e / NV, nr) * PB + V * (e % NV);
    st_async<V>(mapa(t + o, r), t + o, mapa(bar, r));
  }
}

// `count` floats (a multiple of 4, 16-byte aligned) at p into every other
// CTA, one bulk copy each (thread k sends to the k-th next rank), completing
// bytes on their mbarrier `bar`. The caller has fenced its writes of p for
// the async proxy and passed a barrier.
__device__ __forceinline__ void send(float* p, int count, uint64_t* bar) {
  cg::cluster_group cl = cg::this_cluster();
  const int C = (int)cl.num_blocks(), me = (int)cl.block_rank();
  if ((int)threadIdx.x < C - 1) {
    int r = me + 1 + (int)threadIdx.x;
    if (r >= C) r -= C;
    asm volatile(
        "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::"
        "bytes [%0], [%1], %2, [%3];\n" ::"r"(mapa(p, r)),
        "r"(smem_addr(p)), "r"(4 * count), "r"(mapa(bar, r))
        : "memory");
  }
}

// `iters` iterations and the final half step as `phase` does, on the rows
// of the Part; w and t reach the other CTAs through the exchange above
// (`parity`: the exchanges' phase, carried from one call to the next).
// Ends on a cluster barrier.
template <int PB, int LO>
__device__ __forceinline__ void cl_phase(const CSmem& s, const Part& pt,
                                         int nr, int mGp, int iters,
                                         float alpha, bool final_half,
                                         uint32_t& parity) {
  typedef Cfg<PB> C;
  const int R = mGp + nr;
  for (int idx = threadIdx.x; idx < pt.nB * PB; idx += blockDim.x)
    s.w[pt.rB * PB + idx] = s.rho[idx / PB] * s.z[idx] - s.y[idx];
  __syncthreads();
  publish(s.w + pt.rB * PB, s.w + pt.rB * PB, pt.nB * PB);
  cluster_sync();
  for (int k = 0; k <= iters; ++k) {
    const bool last = (k == iters);
    if (last && !final_half) break;
    // t = Â_Gᵀ w_G + d∘w_B − q̂ on the own rows of t
    product<PB, C::A_RT, C::A_KS, LO>(
        s.AG, s.AS, s.w, mGp, nr, pt.a0, pt.a1, pt.jA,
        [&](int j, int p, const auto& v) {
          constexpr int W = sizeof(v) / sizeof(float);
          const int o = j * PB + p, ol = (j - pt.jA) * PB + p;
          float wb[W], q[W], t[W];
          vload<W>(wb, s.w + mGp * PB + o);
          vload<W>(q, s.q + ol);
          const float d = s.dbox[j - pt.jA];
#pragma unroll
          for (int i = 0; i < W; ++i) t[i] = v[i] + d * wb[i] - q[i];
          vstore<W>(s.t + t_row<C::B_KS>(j, nr) * PB + p, t);
        });
    __syncthreads();
    if (threadIdx.x == 0) expect_bytes(s.bar + 1, 4 * (nr - pt.nA) * PB);
    send_t<PB, C::B_KS>(s.t, pt, nr, s.bar + 1);
    bar_wait(s.bar + 1, parity & 1);
    // ẑ = M t on the own rows, fused with their update
    product<PB, C::B_RT, C::B_KS, LO>(
        s.MT, s.RS, s.t, nr, R, pt.b0, pt.b1, pt.rB,
        [&](int r, int p, const auto& u) {
          constexpr int W = sizeof(u) / sizeof(float);
          const int o = (r - pt.rB) * PB + p;
          float z[W], y[W], lo[W], hi[W], wn[W];
          vload<W>(z, s.z + o);
          vload<W>(y, s.y + o);
          vload<W>(lo, s.lo + o);
          vload<W>(hi, s.hi + o);
          const float rho = s.rho[r - pt.rB], rhoi = s.rhoi[r - pt.rB];
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
          vstore<W>(s.w + r * PB + p, wn);
          if (last) {
            vstore<W>(s.dy + o, y);
          } else {
            vstore<W>(s.z + o, z);
            vstore<W>(s.y + o, y);
          }
        });
    // w's rows leave by bulk copy (async proxy): fence the writes first
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (threadIdx.x == 0) expect_bytes(s.bar + 2, 4 * (R - pt.nB) * PB);
    send(s.w + pt.rB * PB, pt.nB * PB, s.bar + 2);
    bar_wait(s.bar + 2, parity & 1);
    parity ^= 1;
  }
  cluster_sync();
}

// one reduction record: four fp64 sums, then five fp32 maxima
__device__ __forceinline__ void record_put(float* f, double xpx, double qx,
                                           double support, double gap,
                                           float r_prim, float r_rel,
                                           float r_dual, float dy_norm,
                                           float atdy) {
  double* d = reinterpret_cast<double*>(f);   // 8-byte aligned: PHC_RED even
  d[0] = xpx;  d[1] = qx;  d[2] = support;  d[3] = gap;
  f[8] = r_prim;  f[9] = r_rel;  f[10] = r_dual;  f[11] = dy_norm;
  f[12] = atdy;
}

// the records f[0], f[stride], ... f[(count-1)·stride], in order
__device__ __forceinline__ void record_sum(const float* f, int count,
                                           int stride, double& xpx,
                                           double& qx, double& support,
                                           double& gap, float& r_prim,
                                           float& r_rel, float& r_dual,
                                           float& dy_norm, float& atdy) {
  r_prim = r_rel = r_dual = dy_norm = atdy = 0.f;
  xpx = qx = support = gap = 0.0;
  for (int w = 0; w < count; ++w, f += stride) {
    const double* d = reinterpret_cast<const double*>(f);
    xpx += d[0];  qx += d[1];  support += d[2];  gap += d[3];
    r_prim = fmaxf(r_prim, f[8]);
    r_rel = fmaxf(r_rel, f[9]);
    r_dual = fmaxf(r_dual, f[10]);
    dy_norm = fmaxf(dy_norm, f[11]);
    atdy = fmaxf(atdy, f[12]);
  }
}

// the own rows of src (a per-row array of the Part) into dst (R·PB) of
// every CTA of the cluster (seen after a cluster barrier)
template <int PB>
__device__ __forceinline__ void gather(float* dst, const float* src,
                                       const Part& pt) {
  for (int idx = threadIdx.x; idx < pt.nB * PB; idx += blockDim.x)
    dst[pt.rB * PB + idx] = src[idx];
  publish(dst + pt.rB * PB, src, pt.nB * PB);
}

// `stats` of a cluster's tile: P̂x, Âᵀy, Âᵀδy on the own rows of t (y and
// δy gathered whole into g first), each CTA's row reductions over its own
// rows, then rank 0 sums the CTAs' records in rank order. Ends on a
// cluster barrier.
template <int PB>
__device__ __forceinline__ void cl_stats(const CSmem& s, const Part& pt,
                                         const Args& a, int b0, float* st) {
  typedef Cfg<PB> C;
  const int nr = a.nr, mGp = a.mGp, R = mGp + nr;
  const float* dci = a.vec + 5 * nr;
  gather<PB>(s.g, s.y, pt);
  cluster_sync();
  product<PB, C::A_RT, C::A_KS>(
      a.PT, nr, s.x, nr, nr, pt.a0, pt.a1, 0,
      [&](int j, int p, const auto& v) {
        constexpr int W = sizeof(v) / sizeof(float);
        vstore<W>(s.Px + (j - pt.jA) * PB + p, v);
      });
  product<PB, C::A_RT, C::A_KS>(
      s.AG, s.AS, s.g, mGp, nr, pt.a0, pt.a1, pt.jA,
      [&](int j, int p, const auto& v) {
        constexpr int W = sizeof(v) / sizeof(float);
        float yb[W], r[W];
        vload<W>(yb, s.g + mGp * PB + j * PB + p);
#pragma unroll
        for (int i = 0; i < W; ++i) r[i] = v[i] + s.dbox[j - pt.jA] * yb[i];
        vstore<W>(s.Aty + (j - pt.jA) * PB + p, r);
      });
  cluster_sync();
  gather<PB>(s.g, s.dy, pt);
  cluster_sync();
  product<PB, C::A_RT, C::A_KS>(
      s.AG, s.AS, s.g, mGp, nr, pt.a0, pt.a1, pt.jA,
      [&](int j, int p, const auto& v) {
        constexpr int W = sizeof(v) / sizeof(float);
        float yb[W], r[W];
        vload<W>(yb, s.g + mGp * PB + j * PB + p);
#pragma unroll
        for (int i = 0; i < W; ++i) r[i] = v[i] + s.dbox[j - pt.jA] * yb[i];
        vstore<W>(s.Atdy + (j - pt.jA) * PB + p, r);
      });
  __syncthreads();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = blockDim.x >> 5;
  const int p = tid % PB;
  float r_prim = 0.f, r_rel = 0.f, r_dual = 0.f, dy_norm = 0.f, atdy = 0.f;
  double xpx = 0.0, qx = 0.0, support = 0.0, gap = 0.0;
  for (int i = tid / PB; i < pt.nB; i += blockDim.x / PB) {
    const int o = i * PB + p;
    const float zt = s.w[(pt.rB + i) * PB + p], lo = s.lo[o], hi = s.hi[o];
    const float ei = s.einv[i], dy = s.dy[o];
    const float viol = fabsf(zt - clipf(zt, lo, hi)) * ei;
    r_prim = fmaxf(r_prim, viol);
    r_rel = fmaxf(r_rel, viol / fmaxf(1.f, fabsf(zt * ei)));
    dy_norm = fmaxf(dy_norm, fabsf(dy));
    const double dyp = (double)fmaxf(dy, 0.f), dyn = (double)fminf(dy, 0.f);
    const bool finu = hi < 0.9f * PHC_BIG, finl = lo > -0.9f * PHC_BIG;
    support += (finu ? 0.0 : dyp) + (finl ? 0.0 : -dyn);
    gap += (finu ? (double)hi * dyp : 0.0) + (finl ? (double)lo * dyn : 0.0);
  }
  for (int i = tid / PB; i < pt.nA; i += blockDim.x / PB) {
    const int j = pt.jA + i, oj = i * PB + p;
    const float x = s.x[j * PB + p], q = s.q[oj], px = s.Px[oj];
    r_dual = fmaxf(r_dual, fabsf((px + q + s.Aty[oj]) * dci[j]));
    atdy = fmaxf(atdy, fabsf(s.Atdy[oj]));
    xpx += (double)x * (double)px;
    qx += (double)q * (double)x;
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
  if (lane < PB)
    record_put(s.red + (size_t)(warp * PB + p) * PHC_RED, xpx, qx, support,
               gap, r_prim, r_rel, r_dual, dy_norm, atdy);
  __syncthreads();
  // this CTA's record into rank 0's slots, then rank 0 sums them
  cg::cluster_group cl = cg::this_cluster();
  const int nc = (int)cl.num_blocks();
  float* slots = s.red + (size_t)resident_warps(PB) * PB * PHC_RED;
  const bool live = tid < PB && b0 + tid < a.B;
  if (live) {
    record_sum(s.red + (size_t)tid * PHC_RED, nw, PB * PHC_RED, xpx, qx,
               support, gap, r_prim, r_rel, r_dual, dy_norm, atdy);
    record_put(cl.map_shared_rank(
                   slots + (size_t)(cl.block_rank() * PB + tid) * PHC_RED, 0),
               xpx, qx, support, gap, r_prim, r_rel, r_dual, dy_norm, atdy);
  }
  cluster_sync();
  if (live && cl.block_rank() == 0) {
    record_sum(slots + (size_t)tid * PHC_RED, nc, PB * PHC_RED, xpx, qx,
               support, gap, r_prim, r_rel, r_dual, dy_norm, atdy);
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
  cluster_sync();
}

// ρ and 1/ρ of the own rows of ẑ from a packed per-row vector
__device__ __forceinline__ void cl_stage_rho(const CSmem& s, const float* vec,
                                             const Part& pt, int nr,
                                             int mGp) {
  for (int i = threadIdx.x; i < pt.nB; i += blockDim.x) {
    const int r = pt.rB + i;
    const bool g = r < mGp;
    s.rho[i] = g ? vec[6 * nr + r] : vec[2 * nr + r - mGp];
    s.rhoi[i] = g ? vec[6 * nr + mGp + r] : vec[3 * nr + r - mGp];
  }
}

// `load_tile` on the own rows (the CTA's slices of the constants arrive by
// bulk copy): scaled data, bounds and the clipped initial iterates
template <int PB>
__device__ __forceinline__ void cl_load_tile(const CSmem& s, const Part& pt,
                                             const Args& a, int b0) {
  const int nr = a.nr, mGp = a.mGp, n = a.n, m = a.m;
  cl_stage_rho(s, a.vec, pt, nr, mGp);
  for (int i = threadIdx.x; i < pt.nB; i += blockDim.x) {
    const int r = pt.rB + i;
    s.einv[i] = r < mGp ? a.vec[6 * nr + 2 * mGp + r]
                        : a.vec[4 * nr + r - mGp];
  }
  for (int j = threadIdx.x; j < nr; j += blockDim.x) {
    if (j >= pt.jA && j < pt.jA + pt.nA) s.dbox[j - pt.jA] = a.vec[j];
    s.dboxi[j] = a.vec[nr + j];
  }
  const float *qsc = a.io, *eb = a.io + nr, *eg = a.io + 3 * nr;
  for (int idx = threadIdx.x; idx < pt.nB * PB; idx += blockDim.x) {
    const int p = idx / pt.nB, i = idx % pt.nB;   // rows fastest: coalesced
    const int r = pt.rB + i;
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
      if (live && j < n) {
        lo = clipf(a.lb[b * a.slb + j] * eb[j], -PHC_BIG, PHC_BIG);
        hi = clipf(a.ub[b * a.sub + j] * eb[j], -PHC_BIG, PHC_BIG);
        if (a.z0B) z0 = a.z0B[b * a.sz0B + j];
        if (a.y0B) y0 = a.y0B[b * a.sy0B + j];
      }
    }
    const int o = i * PB + p;
    s.lo[o] = lo;
    s.hi[o] = hi;
    s.z[o] = clipf(z0, lo, hi);
    s.y[o] = y0;
  }
  for (int idx = threadIdx.x; idx < pt.nA * PB; idx += blockDim.x) {
    const int p = idx / pt.nA, i = idx % pt.nA;
    const int j = pt.jA + i;
    const size_t b = (size_t)b0 + p;
    s.q[i * PB + p] =
        b < (size_t)a.B && j < n ? a.q[b * a.sq + j] * qsc[j] : 0.f;
  }
}

// x̃ = ẑ_B / d into s.x (every row); x = D·x̃, z and y of the own rows and
// the stats of the tile's problems to device memory
template <int PB>
__device__ __forceinline__ void cl_store_tile(const CSmem& s, const Part& pt,
                                              const Args& a, int b0, float* x,
                                              float* z, float* y, float* st) {
  const int nr = a.nr, mGp = a.mGp, n = a.n, m = a.m;
  const int mt = m + n;
  const float* dsc = a.io + 2 * nr;
  for (int idx = threadIdx.x; idx < pt.nB * PB; idx += blockDim.x) {
    const int p = idx / pt.nB, i = idx % pt.nB;
    const int r = pt.rB + i;
    const size_t b = (size_t)b0 + p;
    const bool live = b < (size_t)a.B;
    const int o = i * PB + p;
    if (r < mGp) {
      if (live && r < m) {
        z[b * mt + r] = s.z[o];
        y[b * mt + r] = s.y[o];
      }
    } else {
      const int j = r - mGp;
      if (live && j < n) {
        x[b * n + j] = dsc[j] * (s.w[r * PB + p] * s.dboxi[j]);
        z[b * mt + m + j] = s.z[o];
        y[b * mt + m + j] = s.y[o];
      }
    }
  }
  for (int idx = threadIdx.x; idx < nr * PB; idx += blockDim.x)
    s.x[idx] = s.w[mGp * PB + idx] * s.dboxi[idx / PB];
  __syncthreads();
  cl_stats<PB>(s, pt, a, b0, st);
}

// `solve_tile` for rank `block_rank` of the cluster of blockIdx.x: the
// CTA's slices of Â_G and Mᵀ (and M2ᵀ for K2's stiff phase) by bulk copy
template <int PB, bool WAVE, int LO>
__device__ __forceinline__ void cl_solve_tile(const Args& a) {
  extern __shared__ __align__(16) float smem[];
  const int nr = a.nr, mGp = a.mGp;
  cg::cluster_group cl = cg::this_cluster();
  const int C = (int)cl.num_blocks(), rank = (int)cl.block_rank();
  const Part pt = part_of(nr, mGp, C, rank);
  const CSmem s = cl_carve<PB>(smem, a, pt, C);
  const int b0 = (blockIdx.x / C) * PB;
  // where this CTA's slices lie in the device layout
  size_t offA = 0, offM = 0;
  for (int k = 0; k < rank; ++k) {
    const Part o = part_of(nr, mGp, C, k);
    offA += (size_t)mGp * slice_stride_A(o.nA);
    offM += (size_t)nr * stride_M(o.nB);
  }
  const int nAG = mGp * s.AS, nMT = nr * s.RS;
  uint32_t parity = 0, xpar = 0;     // bulk copies', exchanges' phases
  if (threadIdx.x == 0)
    for (int i = 0; i < 3; ++i) bar_init(s.bar + i);
  __syncthreads();
  if (threadIdx.x == 0) {
    bar_expect(s.bar, 4 * (nAG + nMT));
    bulk_copy(s.AG, a.AG + offA, nAG, s.bar);
    bulk_copy(s.MT, a.MT + offM, nMT, s.bar);
  }
  cl_load_tile<PB>(s, pt, a, b0);
  bar_wait(s.bar, parity);
  parity ^= 1;
  cluster_sync();     // every CTA started: distributed memory is safe

  // ---- relaxation ----
  if constexpr (LO > 0)
    cl_phase<PB, LO>(s, pt, nr, mGp, a.iters_lo, a.alpha, false, xpar);
  cl_phase<PB, 0>(s, pt, nr, mGp, a.iters, a.alpha, true, xpar);
  cl_store_tile<PB>(s, pt, a, b0, a.x, a.z, a.y, a.st);
  if constexpr (WAVE) {
    // ---- probe bounds on the own box rows (as `solve_tile`) ----
    for (int idx = threadIdx.x; idx < pt.nB * PB; idx += blockDim.x) {
      const int i = idx / PB, r = pt.rB + i, p = idx % PB;
      if (r < mGp) continue;
      const int j = r - mGp;
      float lo = s.lo[idx], hi = s.hi[idx];
      if (a.binm[j] > 0.f) {
        const float xo = clipf(s.w[r * PB + p], lo, hi) * s.einv[i];
        const float pv = rintf(clipf(xo, 0.f, 1.f)) / s.einv[i];
        lo = pv;
        hi = pv;
        s.lo[idx] = lo;
        s.hi[idx] = hi;
      }
      s.z[idx] = clipf(s.z[idx], lo, hi);
    }
    // ---- probe: stiff-ρ then base-ρ; the M2ᵀ slice over the Mᵀ one ----
    if (a.p1 > 0) {
      if (threadIdx.x == 0) {
        bar_expect(s.bar, 4 * nMT);
        bulk_copy(s.MT, a.MT2 + offM, nMT, s.bar);
      }
      cl_stage_rho(s, a.vec2, pt, nr, mGp);
      bar_wait(s.bar, parity);
      parity ^= 1;
      __syncthreads();
      cl_phase<PB, 0>(s, pt, nr, mGp, a.p1, a.alpha2, false, xpar);
      if (threadIdx.x == 0) {
        bar_expect(s.bar, 4 * nMT);
        bulk_copy(s.MT, a.MT + offM, nMT, s.bar);
      }
      cl_stage_rho(s, a.vec, pt, nr, mGp);
      bar_wait(s.bar, parity);
      parity ^= 1;
    }
    __syncthreads();
    cl_phase<PB, 0>(s, pt, nr, mGp, a.p2, a.alpha, true, xpar);
    cl_store_tile<PB>(s, pt, a, b0, a.xp, a.zp, a.yp, a.stp);
  }
}

// threads a CTA of the resident variant may have
template <int PB> struct ResidentThreads {
  enum { N = 32 * (PB == 8 ? RESIDENT_WARPS_8 : (int)Cfg<PB>::WARPS) };
};

template <int PB, int LO>
__global__ void __launch_bounds__(ResidentThreads<PB>::N)
admm_k1_resident_kernel(const Args a) {
  cl_solve_tile<PB, false, LO>(a);
}

template <int PB>
__global__ void __launch_bounds__(ResidentThreads<PB>::N)
admm_k2_resident_kernel(const Args a) {
  cl_solve_tile<PB, true, 0>(a);
}

template <int PB, bool STREAM, int LO>
__global__ void __launch_bounds__(Cfg<PB>::WARPS * 32)
admm_k1_kernel(const Args a) {
  solve_tile<PB, STREAM, false, LO>(a);
}

template <int PB, bool STREAM>
__global__ void __launch_bounds__(Cfg<PB>::WARPS * 32)
admm_k2_kernel(const Args a) {
  solve_tile<PB, STREAM, true, 0>(a);
}

// cudaFuncSetAttribute of a kernel for `bytes` of dynamic shared memory and,
// above 8 CTAs, a non-portable cluster size
template <class F>
int allow(F kernel, size_t bytes, int cluster) {
  if (bytes > 48 * 1024) {
    const int rc = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (rc) return rc;
  }
  if (cluster > 8)
    return (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return 0;
}

template <int PB, bool STREAM, bool WAVE, int LO>
int launch(const Args& a, int threads, cudaStream_t stream) {
  const size_t bytes = smem_floats(a.nr, a.mGp, PB, STREAM) * sizeof(float);
  void (*kernel)(const Args);
  if constexpr (WAVE)
    kernel = admm_k2_kernel<PB, STREAM>;
  else
    kernel = admm_k1_kernel<PB, STREAM, LO>;
  const int rc = allow(kernel, bytes, 1);
  if (rc) return rc;
  kernel<<<(a.B + PB - 1) / PB, threads, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

// the resident variant over clusters of `cluster` CTAs; or, if
// `max_clusters`, how many such clusters the card holds at once
// (cudaOccupancyMaxActiveClusters)
template <int PB, bool WAVE, int LO>
int launch_resident(const Args& a, int threads, int cluster,
                    cudaStream_t stream, int* max_clusters) {
  const size_t bytes =
      cluster_smem_floats(a.nr, a.mGp, PB, cluster) * sizeof(float);
  void (*kernel)(const Args);
  if constexpr (WAVE)
    kernel = admm_k2_resident_kernel<PB>;
  else
    kernel = admm_k1_resident_kernel<PB, LO>;
  int rc = allow(kernel, bytes, cluster);
  if (rc) return rc;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(((a.B + PB - 1) / PB) * cluster), 1, 1);
  cfg.blockDim = dim3((unsigned)threads, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (max_clusters) {
    cfg.gridDim = dim3((unsigned)cluster, 1, 1);
    return (int)cudaOccupancyMaxActiveClusters(max_clusters,
                                               (const void*)kernel, &cfg);
  }
  rc = (int)cudaLaunchKernelEx(&cfg, kernel, a);
  return rc ? rc : (int)cudaGetLastError();
}

// K1 of one tile width and split mode: staged, streamed or resident
template <int PB, int LO>
int launch_k1(const Args& a, bool streamed, int cluster, cudaStream_t st,
              int threads, int* maxc) {
  if (cluster > 1)
    return launch_resident<PB, false, LO>(a, threads, cluster, st, maxc);
  if (maxc) return (int)cudaErrorInvalidValue;
  return streamed ? launch<PB, true, false, LO>(a, threads, st)
                  : launch<PB, false, false, LO>(a, threads, st);
}

// the instantiation of one tile width: staged, streamed or resident; K1 in
// split mode of `passes` (3 or 1) bf16 passes or not
template <int PB, bool WAVE>
int launch_variant(const Args& a, bool streamed, int cluster,
                   cudaStream_t st, int threads, int* maxc, int passes) {
  if constexpr (WAVE) {
    if (cluster > 1)
      return launch_resident<PB, true, 0>(a, threads, cluster, st, maxc);
    if (maxc) return (int)cudaErrorInvalidValue;
    return streamed ? launch<PB, true, true, 0>(a, threads, st)
                    : launch<PB, false, true, 0>(a, threads, st);
  } else {
    if (a.iters_lo == 0)
      return launch_k1<PB, 0>(a, streamed, cluster, st, threads, maxc);
    return passes == 1
               ? launch_k1<PB, 1>(a, streamed, cluster, st, threads, maxc)
               : launch_k1<PB, 3>(a, streamed, cluster, st, threads, maxc);
  }
}

// a cluster size the resident variant takes at this shape: 2 to 16, and
// every CTA owns at least one warp task of each product
bool cluster_ok(int nr, int mGp, int cluster) {
  if (cluster == 1) return true;
  if (cluster != 2 && cluster != 4 && cluster != 8 && cluster != 16)
    return false;
  return nr / TASK_A >= cluster &&
         (mGp + nr + TASK_B - 1) / TASK_B >= cluster;
}

template <bool WAVE>
int launch_pb(const Args& a, int pb, int streamed, int cluster, int threads,
              void* stream, int* maxc, int passes = 3) {
  if (threads < 32 || threads % 32 ||
      threads > (cluster > 1 ? resident_warps(pb) : max_warps(pb)) * 32)
    return (int)cudaErrorInvalidConfiguration;
  if (a.iters_lo < 0 || (WAVE && a.iters_lo != 0))
    return (int)cudaErrorInvalidValue;      // split mode is K1's alone
  if (passes != 1 && passes != 3) return (int)cudaErrorInvalidValue;
  if (!cluster_ok(a.nr, a.mGp, cluster) || (cluster > 1 && streamed))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (pb) {
    case 1: return launch_variant<1, WAVE>(a, streamed != 0, cluster, st,
                                           threads, maxc, passes);
    case 4: return launch_variant<4, WAVE>(a, streamed != 0, cluster, st,
                                           threads, maxc, passes);
    case 8: return launch_variant<8, WAVE>(a, streamed != 0, cluster, st,
                                           threads, maxc, passes);
  }
  return (int)cudaErrorInvalidValue;
}

// `iters` cluster barriers, nothing else: what one costs, with release /
// acquire semantics (as the kernels' barriers) or relaxed (no fence)
__global__ void cluster_sync_kernel(int iters, int relaxed) {
  cg::cluster_group cl = cg::this_cluster();
  if (relaxed) {
    for (int i = 0; i < iters; ++i)
      asm volatile("barrier.cluster.arrive.relaxed;\n"
                   "barrier.cluster.wait;\n" ::: "memory");
  } else {
    for (int i = 0; i < iters; ++i) cl.sync();
  }
}

}  // namespace

extern "C" {

// dynamic shared memory one block of K1 or K2 needs with a tile of pb
// problems, constants staged (streamed = 0), read from device memory
// (streamed = 1) or dealt over a cluster of `cluster` CTAs (cluster > 1;
// per CTA); the same for both kernels: M2ᵀ is staged over Mᵀ
int phc_admm_smem_bytes(int nr, int mGp, int pb, int streamed, int cluster) {
  if (cluster > 1)
    return (int)(cluster_smem_floats(nr, mGp, pb, cluster) * sizeof(float));
  return (int)(smem_floats(nr, mGp, pb, streamed != 0) * sizeof(float));
}

const char* phc_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// K1 on a batch: `a` as the wrapper filled it (a->iters_lo > 0: split
// mode of three bf16 passes first); pb, streamed, cluster and threads from
// its plan
int phc_admm_k1(const PhcAdmmArgs* a, int pb, int streamed, int cluster,
                int threads, void* stream) {
  return launch_pb<false>(*a, pb, streamed, cluster, threads, stream,
                          nullptr);
}

// the same with a split mode of one bf16 pass (Ahi·bhi alone)
int phc_admm_k1_1pass(const PhcAdmmArgs* a, int pb, int streamed,
                      int cluster, int threads, void* stream) {
  return launch_pb<false>(*a, pb, streamed, cluster, threads, stream,
                          nullptr, 1);
}

// K2 (relaxation, probe bounds, two-phase probe) on a batch
int phc_admm_k2(const PhcAdmmArgs* a, int pb, int streamed, int cluster,
                int threads, void* stream) {
  return launch_pb<true>(*a, pb, streamed, cluster, threads, stream,
                         nullptr);
}

// clusters of the resident K1 (wave 0; split: split mode of that many bf16
// passes, 3 or 1, 0: none) or K2 with this shape, tile, cluster size and
// threads that the card holds at once (cudaOccupancyMaxActiveClusters; 0:
// it cannot run), or −(CUDA error)
int phc_admm_max_clusters(int wave, int split, int nr, int mGp, int pb,
                          int cluster, int threads) {
  PhcAdmmArgs a = {};
  a.B = pb;
  a.nr = nr;
  a.mGp = mGp;
  a.iters_lo = split ? 1 : 0;
  int n = 0;
  const int rc = wave ? launch_pb<true>(a, pb, 0, cluster, threads, nullptr,
                                        &n)
                      : launch_pb<false>(a, pb, 0, cluster, threads, nullptr,
                                         &n, split == 1 ? 1 : 3);
  return rc ? -rc : n;
}

// `clusters` clusters of `cluster` CTAs of `threads` threads, each passing
// `iters` cluster barriers (the barrier microbenchmark; relaxed: without
// the release / acquire fence)
int phc_cluster_sync_bench(int cluster, int clusters, int threads, int iters,
                           int relaxed, void* stream) {
  int rc = allow(cluster_sync_kernel, 0, cluster);
  if (rc) return rc;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(cluster * clusters), 1, 1);
  cfg.blockDim = dim3((unsigned)threads, 1, 1);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  rc = (int)cudaLaunchKernelEx(&cfg, cluster_sync_kernel, iters, relaxed);
  return rc ? rc : (int)cudaGetLastError();
}

}  // extern "C"

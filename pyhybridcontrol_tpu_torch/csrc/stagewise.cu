// The stagewise frame's kernels for Hopper (sm_90a), with a plain C
// interface loaded through ctypes by pyhybridcontrol_tpu_torch/ops/_build.py:
// K4, the block-tridiagonal sweep, and K5, the fused stagewise ADMM loop
// that runs K4's sweep as its inner routine.
//
// ---- K4: the sweep -------------------------------------------------------
//
// No TPU kernel stands behind it: the reference solves K ξ = r in every
// stagewise ADMM iteration with two length-N lax.scan sweeps that XLA
// compiles into one device loop (_solve_K in
// pyhybridcontrol_tpu/ops/stagewise.py). Written as torch ops the same
// sweeps cost about 5·N dependent launches an iteration; this kernel is one.
// Its plain version is _solve_K in pyhybridcontrol_tpu_torch/ops/stagewise.py
// and computes the same function.
//
// What it computes, for each of P problems: x = K⁻¹ r from the prepared
// block LU factors (shared by every problem, fp32 copies of the host fp64
// factorization),
//   forward   y_k = r_k − L_k y_{k−1}            k = 0 … N−1, y_{−1} = 0
//   backward  x_k = U⁻¹_k y_k − C_k x_{k+1}       k = N−1 … 0, x_N = 0
// r and x are (P, N, b), L, U⁻¹ and C (N, b, b), all fp32 and contiguous.
// Each block row is summed in fp32 in column order (j = 0 … b−1), as the
// plain version's rows are, so the two round alike up to the order of the
// library's matrix-vector products.
//
// What bounds it on the H100. The bytes are few (r and x once, 3·N·b² words
// of factors once: 0.11 MB at P=64, N=120, b=5, 0.03 µs at 3.35 TB/s) and
// so are the operations (4·N·b² a problem), so neither roofline bound says
// anything. What bounds it is the dependent chain: 2·N stages, each a
// b-row matrix-vector product on the previous stage's result.
//
// The design (sweep_rows below, which K5 runs too, up to BMAX 16):
//  - One warp per problem. Lane i owns rows i, i+32, … of each block; the
//    block size is bounded at compile time (BMAX: 8, 16, 32, 64 or 128, the
//    smallest at or above b) so that the column loops unroll, and the lanes
//    past b idle.
//  - The previous stage's vector is broadcast from its owners' registers by
//    __shfl_sync, one shuffle a column, so a stage costs b shuffles and a
//    chain of b FMAs a row, and no barrier.
//  - Both sweeps run in the same launch, out of shared memory: each warp
//    first copies its problem's r there (N·b words, 16-byte loads where
//    aligned), the forward sweep overwrites r_k with y_k in place, and after
//    one __syncwarp the backward sweep reads y_k back as broadcasts and
//    writes x_k to device memory. No device-memory load is on the chain.
//  - The factors: a block stages L, U⁻¹ and C in shared memory (3·N·b² words,
//    36 KB at N=120, b=5; 16-byte loads, four in flight a thread) where they
//    fit beside the warps' buffers, and reads them through L1/L2 otherwise
//    (STAGED = false). The wrapper's plan (ops/cuda_stagewise.plan_sweep)
//    picks BMAX, the variant and the warps a block (4, 2 or 1) from the
//    shapes alone. Shared-memory arrays start at multiples of 4 words.
//  - Above BMAX 16 (the wide sweep, "the wide sweep" below) a lane owns
//    R = BMAX/32 rows and a block's b² coefficients no longer fit a lane's
//    registers, so the design changes: the factors are packed by block
//    column-major (conflict-free, one 128-byte line a warp and column);
//    where they are not staged, a ring of D stage blocks in shared memory
//    is kept filled by bulk copies (TMA) D stages ahead of the chain; and
//    U⁻¹_k y_k, which needs only the forward sweep's y, is a pass of its
//    own between the sweeps (in K5 over every warp of the slot), so that
//    the backward chain is x_k = a_k − C_k x_{k+1}. The sums are the same
//    in the same order, so the outputs are what the row-major sweep gave.
//
// ---- K5: the stagewise ADMM loop -----------------------------------------
//
// What it replaces: the reference's jax.lax.fori_loop over the stagewise
// ADMM iteration (stagewise_admm_solve, pyhybridcontrol_tpu/ops/stagewise.py,
// loop at :1011, body :987-1009), plain XLA, no Pallas. Its plain version is
// _admm_iterations in pyhybridcontrol_tpu_torch/ops/stagewise.py (torch ops
// around the plain sweeps, ~51 launches an iteration plus the sweeps').
//
// What it computes, for P problems of horizon N, block b and m rows a
// stage, in groups of S scenarios that share a consensus prox (S = 1
// without one), `iters` iterations of
//   t  = σx − q + Aᵀ(ρz − y) + Aextᵀ(ρₑz_e − y_e)
//   x  = K⁻¹t − KiU·(Cw·(Aext·K⁻¹t))          (the bordered Woodbury x-update)
//   zr = αAx + (1−α)z
//   z  = box(zr + y/ρ) on hard rows; the penalty prox on soft rows; the
//        p-weighted group mean over the scenarios on the trailing n_cons
//        rows (with a group mean)
//   y  = y + ρ(zr − z)
//   z_e = min(αAext·x + (1−α)z_e + y_e/ρₑ, u_e), y_e likewise (one-sided)
// from the warm (x, z, y, z_e, y_e), returning them with the last
// iteration's dy and dy_e. A ξ_k-rows = J ξ_k + M_k ξ_{k−1}: J (m, b) is
// shared; M_k = Mc for k ≥ 1 (the dynamics' −A and the inequalities' E on
// x_k) minus tie[k, j] on the blocking rows' column blk[j]; M_0 multiplies
// data (x_0) and is zero. All fp32; the wrapper (ops/cuda_stagewise.py)
// packs the constants.
//
// What bounds it on the H100. Per iteration and problem the work is a
// sweep (2·N dependent stages) and O(N·m·b) row work; the bytes are the
// state once in and out per launch (4–5 MB at config 6's wave). So the
// bound is the chain: `iters` sweeps in sequence, ~9 µs an iteration at
// N=120 by K4's reckoned floor, against ~1 ms an iteration that the torch
// loop around K4 cost on the host.
//
// The design:
//  - One CTA per problem (scenario), a node's S scenarios one thread-block
//    cluster (S ≤ 8, the portable size). Warp 0 runs the sweep
//    (sweep_rows, K4's code) out of shared memory; the factors are staged
//    there once per launch where they fit (STAGED), not once per
//    iteration. A CTA of its own per scenario keeps every sweep warp alone
//    with its SM's shared-memory pipe, and spreads the row work over S
//    SMs a node (one CTA holding a node's 8 scenarios ran its sweeps at
//    half K4's pace and its rows on 8 SMs of 132).
//  - The state lives on chip for the launch: z, y, l and u in shared
//    memory by row then stage (37 KB a scenario at config 6), so the 32
//    stages of a warp read one row from 32 banks.
//  - Row work is owned stage by stage: thread k owns stage k (k, k + 32·W,
//    … past the CTA's threads) and every row of it through every
//    iteration; only the owner reads or writes a row's z, y, l, u. It
//    computes its rows' zr and updates, then at once their new w = ρz − y
//    into Jᵀw (its t_k) and, for k ≥ 1, M_kᵀw (t_{k−1}'s share, kept
//    apart in `mb` and added by the sweep as it reads t_{k−1}): no pass
//    reads z and y twice.
//  - Barriers an iteration: the block's after the sweep (x and the
//    Woodbury coefficient in shared memory); then, with a group mean, one
//    cluster barrier (release/acquire) after the row work, past which each
//    CTA reads the consensus rows' zr + y/ρ of its peers from their shared
//    memory (double-buffered by iteration, so that no second cluster
//    barrier guards the overwrite), else the block's where the extra rows
//    need the CTA's sums of Aext·x; and the block's once t is complete.
//    The extra rows' z_e, y_e are kept in every thread of the CTA, each
//    computing the same update from the same sums in the same order.
//  - J and Mc are staged with rows padded to BMAX words and read as
//    16-byte broadcasts.
//  - That is the shared variant, and it needs a scenario's state in one
//    CTA's shared memory (N ≲ 700 at b=5, 240 at b=13) and a group in one
//    portable cluster (S ≤ 8). Past either, the same kernel runs in its
//    FLEX instantiations (below the layout): a group of S > 8 scenarios
//    one portable cluster of ⌈S/spc⌉ CTAs with spc = ⌈S/8⌉ scenarios a
//    CTA (each on its own share of the CTA's warps, their sweeps side by
//    side as K4 runs one problem a warp), so that a B&B wave's clusters
//    run in one wave on the card (clusters of 16 left a wave of 8 nodes
//    two waves), the group mean over the node's members alone; and the
//    state in device memory in the same layout, so that a warp's stages
//    coalesce, where the slots do not fit. The bound stays the chain; the
//    state's loads move off chip, the factors come through L2 once they
//    no longer fit beside it.
//
// K5 at any b and r (the runtime-r path, RDYN). The register path holds
// six bmax-wide arrays a thread in its row work and the extra rows in
// kRMax-sized registers, which caps it at bmax 16 (231–249 registers
// there) and r ≤ 4. Past either the same kernel runs its runtime-r
// instantiations:
//  - z_e, y_e, the Woodbury coefficient corr and wsum = Aext·K⁻¹t are
//    r-word arrays. wsum takes one warp a row of Aext, corr one thread a
//    row of Cw, then x is corrected in place; pe = Aext·x is summed in the
//    register path's order (each thread its stages, a warp's lanes, the
//    warps in turn) by one warp that emulates the slot's warps, and the
//    same warp updates that row's z_e, y_e. Four barriers an iteration
//    more; at r = 1 every sum is the register path's, in its order.
//  - Aext and KiU, Cw, and the r-vectors (with ρₑ) lie in shared memory
//    where they fit beside the state, else in device memory (ext's bits,
//    which the plan sets by size; no cap on r).
//  - Above bmax 16 (WIDE) the row work changes layout: a stage's rows over
//    its lane group, each row's J ξ_k + M_k ξ_{k−1} summed over the b
//    columns of x where it lies, its w = ρz − y kept in an array beside z;
//    then, after the group's __syncwarp, the stage's columns over the
//    same lanes in fours, each summing its share of t_k and mb_{k−1} over
//    the rows. J and Mc are rows of b words (in shared memory where they
//    fit). No thread holds a bmax-wide array; the sweep is K4's wide
//    sweep: warp 0's forward sweep through its ring (unstaged; the ring's
//    fills run on across the iterations, so the next iteration's first
//    blocks land during the row work), a barrier, U⁻¹_k y_k over all the
//    slot's warps, a barrier, warp 0's backward sweep.

// K5's horizon variant (PHC_SW_PART 3, stagewise_horizon.cu), the global
// variant redesigned where a scenario's horizon outgrows a CTA: one
// problem (S = 1, no extra rows, bmax 8 or 16) a cluster of C CTAs
// (C = 2, 4 or 8, portable), CTA c owning the window of stages
// [c·N/C, (c+1)·N/C). The window's factors (staged where they fit), its
// z, y, l, u, t, mb and x live in its shared memory for the launch, and
// its rows are dealt over its own threads: the row work runs on C SMs, no
// state word and no staged factor is read from device memory on the chain.
// Across a window's first stage s: its rows need x_{s−1}, which the CTA
// before pushes into a halo (xh) after its backward sweep, and stage s's
// M_sᵀw goes into that CTA's mb over DSMEM; cluster barriers after the
// sweeps and after the rows order both. Two sweeps, by launch argument:
//  - sequential: warp 0 of CTA c runs its window's forward stages once CTA
//    c−1 has handed it y_{s−1} (b words stored over DSMEM, then one remote
//    mbarrier arrive, release at cluster scope; every lane waits on the
//    phase of the iteration, acquire at cluster scope), and hands its last
//    y on; the backward sweep runs in reverse window order with x_{e}. The
//    stages are sweep_rows' stages in its order (window_forward and
//    window_backward are its halves over a window, from a carry), and the
//    row work is the global variant's, so at the same lanes a stage the
//    outputs are the global variant's bit for bit. The chain stays 2·N
//    stages, plus 2·(C−1) handoffs.
//  - parallel (the reference's parallel_sweeps=True, another algorithm):
//    every window sweeps from a zero carry at once (N/C stages), publishes
//    its last y⁰ (first x⁰), and after a cluster barrier warp 0 of each CTA
//    composes its carry from the earlier (later) windows' with the host's
//    window maps, Π_k = (−L_k)⋯(−L_s) and Ψ_k = (−C_k)⋯(−C_{e−1}) (fp64
//    products rounded to fp32, ops/stagewise.window_maps); every thread
//    then corrects y_k += Π_k·carry (x_k += Ψ_k·carry) with no chain. Its
//    plain version is ops/stagewise._solve_K_windowed inside
//    _admm_iterations.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

// Which of K5's instantiations this library holds (admm_dispatch): 0, this
// source built alone, K4 and K5's register path at bmax 8 and 16; 1
// (stagewise_wide.cu) K5 at bmax 32, 64 and 128; 2 (stagewise_extra.cu)
// K5's runtime-r path at bmax 8 and 16; 3 (stagewise_horizon.cu) K5's
// horizon variant. PHC_SW_PAR 1: parts 0 to 2 with the parallel sweep in
// place of the sequential one (stagewise_par.cu, stagewise_wide_par.cu,
// stagewise_extra_par.cu; no K4). Seven libraries, so that nvcc builds the
// parts side by side.
#ifndef PHC_SW_PART
#define PHC_SW_PART 0
#endif
#ifndef PHC_SW_PAR
#define PHC_SW_PAR 0
#endif

#include <cstddef>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 4;
constexpr int kRMax = 4;          // extra rows K5's register path takes
constexpr int kMaxCluster = 16;   // CTAs a K5 cluster (non-portable above 8)
// K5's parallel sweep: this library's instantiations run it (PHC_SW_PAR),
// over at most kMaxWindows windows a problem
constexpr bool kPar = PHC_SW_PAR != 0;
constexpr int kMaxWindows = 8;
// K5's runtime-r path (any number of extra rows; every bmax above 16):
// the bit that selects it, and the arrays it reads from device memory
// where they do not fit beside the state (the plan sets them by size)
constexpr int kExtRt = 1;    // r at runtime: z_e, y_e, sv, corr in arrays
constexpr int kExtAK = 2;    // Aext and KiU read from device memory
constexpr int kExtCw = 4;    // Cw read from device memory
constexpr int kExtVec = 8;   // ρₑ, and z_e, y_e, sv, corr in ext_ws
constexpr int kExtJM = 16;   // bmax above 16: J and Mc in device memory
// the most threads a K5 CTA has: 512 at BMAX 8, 256 at 16 (the per-stage
// register arrays double)
constexpr int admm_max_threads(int bmax) { return bmax <= 8 ? 512 : 256; }

__host__ __device__ inline size_t pad4(size_t n) { return (n + 3) & ~size_t(3); }

// dst[0:n] = src[0:n] by the threads tid, tid+step, …: 16-byte moves with
// four loads in flight a thread where both ends are 16-byte aligned
__device__ inline void copy_in(float* dst, const float* __restrict__ src,
                               int n, int tid, int step) {
  if (((reinterpret_cast<uintptr_t>(dst) |
        reinterpret_cast<uintptr_t>(src)) & 15) == 0) {
    const int n4 = n >> 2;
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int i = tid; i < n4; i += 4 * step) {
      float4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (i + u * step < n4) v[u] = __ldg(s4 + i + u * step);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (i + u * step < n4) d4[i + u * step] = v[u];
    }
    for (int i = 4 * n4 + tid; i < n; i += step) dst[i] = __ldg(src + i);
  } else {
    for (int i = tid; i < n; i += step) dst[i] = __ldg(src + i);
  }
}

// K4's sweep for one problem, run by one whole warp: x = K⁻¹ r with r in
// ys (shared memory, N·b words, overwritten by y), plus add[k·b + i] on
// each r_k row where ADD (K5's M-part of t, kept apart); x (N·b words) in
// shared or device memory. NB columns a row: B0 where the block size is
// known at compile time (B0 = b), else BMAX, the columns past b then
// adding fmaf(0, 0) — the sums are those of the b columns, in column
// order, bit for bit. Up to BMAX 16 a lane holds its row of the next
// stage's factors (and of y) in registers while the current stage's chain
// runs, so that no load waits on it, and the lanes past b compute along
// (their coefficients and values are 0) so that the warp never diverges
// on the chain: a stage is NB shuffles issued together, NB dependent
// FMAs and a subtraction.
template <int BMAX, int B0, bool ADD>
__device__ inline void sweep_rows(float* ys, const float* add,
                                  const float* L, const float* U,
                                  const float* C, float* xp, int N, int b,
                                  int lane) {
  constexpr int NB = B0 ? B0 : BMAX;
  const int bb = b * b;
  const bool row = lane < b;
  const int lo = row ? lane * b : 0;   // this lane's row of a factor block

  // ---- forward sweep: y_k = r_k − L_k y_{k−1}, in place over r_k ----
  float Lc[NB], Ln[NB];
  float rc = 0.0f, rn = 0.0f;
#pragma unroll
  for (int j = 0; j < NB; ++j) Lc[j] = (row && j < b) ? L[lo + j] : 0.0f;
  if (row) rc = ADD ? ys[lane] + add[lane] : ys[lane];
  float prev = 0.0f;
#pragma unroll 2
  for (int k = 0; k < N; ++k) {
    if (k + 1 < N) {
      const float* Lk = L + (size_t)(k + 1) * bb + lo;
#pragma unroll
      for (int j = 0; j < NB; ++j) Ln[j] = (row && j < b) ? Lk[j] : 0.0f;
      const int e = (k + 1) * b + lane;
      if (row) rn = ADD ? ys[e] + add[e] : ys[e];
    }
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < NB; ++j)
      acc = fmaf(Lc[j], __shfl_sync(kFull, prev, j), acc);
    prev = rc - acc;     // exactly 0 past b: no branch before the shuffles
    if (row) ys[k * b + lane] = prev;
#pragma unroll
    for (int j = 0; j < NB; ++j) Lc[j] = Ln[j];
    rc = rn;
  }
  __syncwarp();

  // ---- backward sweep: x_k = U⁻¹_k y_k − C_k x_{k+1} ----
  float Uc[NB], Cc[NB], yc[NB], Un[NB], Cn[NB], yn[NB];
  {
    const size_t o = (size_t)(N - 1) * bb + lo;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      Uc[j] = (row && j < b) ? U[o + j] : 0.0f;
      Cc[j] = (row && j < b) ? C[o + j] : 0.0f;
      yc[j] = j < b ? ys[(N - 1) * b + j] : 0.0f;
    }
  }
  float nxt = 0.0f;
#pragma unroll 2
  for (int k = N - 1; k >= 0; --k) {
    if (k >= 1) {
      const size_t o = (size_t)(k - 1) * bb + lo;
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        Un[j] = (row && j < b) ? U[o + j] : 0.0f;
        Cn[j] = (row && j < b) ? C[o + j] : 0.0f;
        yn[j] = j < b ? ys[(k - 1) * b + j] : 0.0f;
      }
    }
    float a = 0.0f, c = 0.0f;
#pragma unroll
    for (int j = 0; j < NB; ++j) a = fmaf(Uc[j], yc[j], a);
#pragma unroll
    for (int j = 0; j < NB; ++j)
      c = fmaf(Cc[j], __shfl_sync(kFull, nxt, j), c);
    nxt = a - c;         // exactly 0 past b
    if (row) xp[(size_t)k * b + lane] = nxt;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      Uc[j] = Un[j];
      Cc[j] = Cn[j];
      yc[j] = yn[j];
    }
  }
}

// ---- the wide sweep (BMAX 32 to 128) ----
//
// The wrapper packs each factor (L, U⁻¹, C) for it by stage block, each
// block column-major (element (i, j) at j·b + i) and padded to a multiple
// of 4 words (ops/cuda_stagewise.pack_wide): lane i's reads of a column are
// consecutive words, so a warp's read of one column is one 128-byte line
// and hits 32 banks (row-major blocks put the 32 lanes b words apart, a
// 32-way bank conflict at b = 32, 64 and 128), and every block starts
// 16-byte aligned, as a bulk copy needs.
__host__ __device__ inline size_t wide_block(int b) {
  return pad4((size_t)b * b);
}

// words of one factor array as the kernels read it: N·b² words up to bmax
// 16, N packed blocks above
__host__ __device__ inline size_t factor_words(int N, int b, int bmax) {
  return bmax <= 16 ? pad4((size_t)N * b * b) : (size_t)N * wide_block(b);
}

// words of a ring of D packed blocks in shared memory behind its D
// mbarriers (two words each); none without a ring
__host__ __device__ inline size_t ring_words(int D, int b) {
  return D ? pad4(2 * (size_t)D) + (size_t)D * wide_block(b) : 0;
}

// A ring of D stage blocks (D = 2, 4 or 8) in shared memory that lane 0 of
// the one warp reading it keeps filled by bulk copies (TMA, one elected
// thread, completion on the slot's mbarrier) from the packed factors in
// device memory, where they are not staged. The fills run in a fixed
// sequence n = 0, 1, …: the parts in the order the warp reads them (L
// forward, in K4 U⁻¹ forward, C backward), over and over. The warp waits
// for fill n, reads its slot and only then (every lane's reads used, after
// a __syncwarp) lane 0 issues fill n + D into the same slot: a slot has one
// fill in flight at most, so the phase to wait for is (n div D) mod 2. No
// fill is issued at or past `stop`, so none is in flight when the kernel
// ends.
struct FactorRing {
  float* buf;                  // D blocks of bs words
  unsigned long long* bar;     // D mbarriers
  const float *p0, *p1, *p2;   // the parts (no array: the ring stays in
                               // registers, not in local memory)
  size_t bs;
  int parts, N, lgD;
  unsigned bytes, n, stop;     // bytes a block, the next fill read, the end
  unsigned nf;                 // lane 0: the next fill to issue, its part
  int fp, fk;                  // and stage
};

__device__ inline unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ inline FactorRing ring_of(float* base, int D, int b, int N,
                                     const float* p0, const float* p1,
                                     const float* p2, int parts,
                                     unsigned stop) {
  FactorRing g;
  g.bar = reinterpret_cast<unsigned long long*>(base);
  g.buf = base + pad4(2 * (size_t)D);
  g.p0 = p0;
  g.p1 = p1;
  g.p2 = p2;
  g.bs = wide_block(b);
  g.parts = parts;
  g.N = N;
  g.lgD = D >= 8 ? 3 : (D >= 4 ? 2 : 1);
  g.bytes = (unsigned)(sizeof(float) * g.bs);
  g.n = 0;
  g.stop = stop;
  g.nf = 0;
  g.fp = 0;
  g.fk = 0;
  return g;
}

// lane 0: the next fill into its slot, and the cursor past it
__device__ inline void ring_fill(FactorRing& g) {
  const float* src = (g.fp == 0 ? g.p0 : g.fp == 1 ? g.p1 : g.p2) +
                     (size_t)g.fk * g.bs;
  const unsigned slot = g.nf & ((1u << g.lgD) - 1u);
  const unsigned bar = smem_u32(g.bar + slot);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(bar), "r"(g.bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      ::"r"(smem_u32(g.buf + slot * g.bs)), "l"(src), "r"(g.bytes),
        "r"(bar)
      : "memory");
  ++g.nf;
  const bool back = g.fp == g.parts - 1;     // the last part runs backward
  if (back ? --g.fk < 0 : ++g.fk == g.N) {
    g.fp = g.fp + 1 == g.parts ? 0 : g.fp + 1;
    g.fk = g.fp == g.parts - 1 ? g.N - 1 : 0;
  }
}

// the ring's mbarriers initialised and its first D fills issued (lane 0),
// before any lane waits
__device__ inline void ring_start(FactorRing& g, int lane) {
  if (lane == 0) {
    for (int s = 0; s < (1 << g.lgD); ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   ::"r"(smem_u32(g.bar + s)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    while (g.nf < (1u << g.lgD) && g.nf < g.stop) ring_fill(g);
  }
  __syncwarp();
}

// the slot of fill g.n, once its bytes have landed (every lane waits)
__device__ inline const float* ring_wait(const FactorRing& g) {
  const unsigned slot = g.n & ((1u << g.lgD) - 1u);
  const unsigned bar = smem_u32(g.bar + slot);
  const unsigned parity = (g.n >> g.lgD) & 1u;
  unsigned done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
  return g.buf + slot * g.bs;
}

// fill g.n read by every lane: lane 0 refills its slot with fill n + D
__device__ inline void ring_next(FactorRing& g, int lane) {
  __syncwarp();
  if (lane == 0 && g.nf < g.stop) ring_fill(g);
  ++g.n;
}

// The wide sweep's three passes (the factors packed; lane i owns rows i,
// i + 32, …, R = BMAX/32 of them, each read at its row clamped into the
// block, so that the rows past b read valid words that no one uses). Each
// row is summed over its b columns in column order with no predicate on
// the chain, the previous stage's vector read back from shared memory as
// broadcasts (no shuffles); the coefficients past b that the row-major
// sweep summed as well were zeros times zeros (the vector past b is 0),
// which leave a sum as it is but for a −0 they turn into +0: one add of +0
// does the same (pad_zero). So every output is bit for bit what it was. A
// pass reads its blocks from the ring g where RING, else from F (staged in
// shared memory, or in device memory).
template <int BMAX>
__device__ inline void pad_zero(float (&v)[BMAX / 32], int b) {
  if (b < BMAX)
#pragma unroll
    for (int t = 0; t < BMAX / 32; ++t) v[t] = __fadd_rn(v[t], 0.0f);
}

// a lane's rows of a block, clamped into it: ic[t] = min(32·t + lane, b − 1)
template <int R>
__device__ inline void lane_rows(int (&ic)[R], int lane, int b) {
#pragma unroll
  for (int t = 0; t < R; ++t) ic[t] = min(t * 32 + lane, b - 1);
}

// acc[t] += Σ_{j<b} blk[j·b + ic[t]] · v[j] in column order, v read as
// broadcasts (0 where zero: a chain's first stage)
template <int R>
__device__ inline void row_sums(float (&acc)[R], const float* blk,
                                const float* v, bool zero,
                                const int (&ic)[R], int b) {
#pragma unroll 16
  for (int j = 0; j < b; ++j) {
    const float vj = zero ? 0.0f : v[j];
#pragma unroll
    for (int t = 0; t < R; ++t)
      acc[t] = fmaf(blk[j * b + ic[t]], vj, acc[t]);
  }
}

// forward: y_k = r_k − L_k y_{k−1} in place over r_k (ys), plus add where
// ADD (K5's M part of t); y_{k−1} read back from ys, after the __syncwarp
// that ends each stage
template <int BMAX, bool ADD, bool RING>
__device__ inline void wide_forward(float* ys, const float* add,
                                    const float* F, FactorRing* g, int N,
                                    int b, int lane) {
  constexpr int R = BMAX / 32;
  const size_t bs = wide_block(b);
  int ic[R];
  lane_rows<R>(ic, lane, b);
  for (int k = 0; k < N; ++k) {
    const float* Lk = RING ? ring_wait(*g) : F + (size_t)k * bs;
    float acc[R] = {};
    row_sums<R>(acc, Lk, k ? ys + (k - 1) * b : ys, k == 0, ic, b);
    pad_zero<BMAX>(acc, b);
    float* yk = ys + k * b;
#pragma unroll
    for (int t = 0; t < R; ++t) {
      const int i = t * 32 + lane;
      if (i < b) {
        const float rk = ADD ? yk[i] + add[k * b + i] : yk[i];
        yk[i] = rk - acc[t];
      }
    }
    __syncwarp();                // y_k in place before the next stage
    if (RING) ring_next(*g, lane);
  }
}

// a_k = U⁻¹_k y_k over stages k0, k0 + step, … (one warp a stage; from the
// ring (K4) in its order), in place over y_k: no stage depends on another,
// so the product is off the chain
template <int BMAX, bool RING>
__device__ inline void wide_u_pass(float* ys, const float* F, FactorRing* g,
                                   int N, int b, int k0, int step,
                                   int lane) {
  constexpr int R = BMAX / 32;
  const size_t bs = wide_block(b);
  int ic[R];
  lane_rows<R>(ic, lane, b);
  for (int k = k0; k < N; k += step) {
    const float* Uk = RING ? ring_wait(*g) : F + (size_t)k * bs;
    float* yk = ys + k * b;
    float a[R] = {};
    row_sums<R>(a, Uk, yk, false, ic, b);
    pad_zero<BMAX>(a, b);
    __syncwarp();                // every lane's y_k read before a_k lands
#pragma unroll
    for (int t = 0; t < R; ++t) {
      const int i = t * 32 + lane;
      if (i < b) yk[i] = a[t];
    }
    if (RING) ring_next(*g, lane);
  }
}

// backward: x_k = a_k − C_k x_{k+1} (a_k in ys), x_k into xp and over a_k
// in ys, where the next stage reads it back
template <int BMAX, bool RING>
__device__ inline void wide_backward(float* ys, const float* F,
                                     FactorRing* g, float* xp, int N, int b,
                                     int lane) {
  constexpr int R = BMAX / 32;
  const size_t bs = wide_block(b);
  int ic[R];
  lane_rows<R>(ic, lane, b);
  for (int k = N - 1; k >= 0; --k) {
    const float* Ck = RING ? ring_wait(*g) : F + (size_t)k * bs;
    float c[R] = {};
    row_sums<R>(c, Ck, k < N - 1 ? ys + (k + 1) * b : ys, k == N - 1, ic,
                b);
    pad_zero<BMAX>(c, b);
#pragma unroll
    for (int t = 0; t < R; ++t) {
      const int i = t * 32 + lane;
      if (i < b) {
        const float x = ys[k * b + i] - c[t];
        xp[(size_t)k * b + i] = x;
        ys[k * b + i] = x;
      }
    }
    __syncwarp();                // x_k in place before the next stage
    if (RING) ring_next(*g, lane);
  }
}

template <int BMAX, int B0, bool STAGED>
__global__ void __launch_bounds__(32 * kMaxWarps)
sw_solve_k_kernel(const float* __restrict__ r, const float* __restrict__ Lg,
                  const float* __restrict__ Ug, const float* __restrict__ Cg,
                  float* __restrict__ x, int P, int N, int b) {
  extern __shared__ __align__(16) float smem[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float* L = Lg;
  const float* U = Ug;
  const float* C = Cg;
  float* ys = smem;
  if (STAGED) {
    const int n = N * b * b;
    const size_t np = pad4(n);
    copy_in(smem, Lg, n, threadIdx.x, blockDim.x);
    copy_in(smem + np, Ug, n, threadIdx.x, blockDim.x);
    copy_in(smem + 2 * np, Cg, n, threadIdx.x, blockDim.x);
    L = smem;
    U = smem + np;
    C = smem + 2 * np;
    ys = smem + 3 * np;
  }
  const int p = blockIdx.x * warps + warp;
  ys += warp * pad4((size_t)N * b);
  if (p < P) copy_in(ys, r + (size_t)p * N * b, N * b, lane, 32);
  __syncthreads();
  if (p >= P) return;  // whole warps leave, after the block's only barrier
  sweep_rows<BMAX, B0, false>(ys, nullptr, L, U, C, x + (size_t)p * N * b,
                              N, b, lane);
}

// K4 at BMAX 32 to 128, on the packed factors: one warp a problem, its
// forward sweep, the U pass (a_k = U⁻¹_k y_k, stage after stage, no chain
// between them) and the backward sweep out of its r/y buffer in shared
// memory. The factors staged in shared memory (STAGED), else streamed
// through the warp's ring of `ring` blocks behind its buffer (fills: L
// forward, U⁻¹ forward, C backward).
template <int BMAX, bool STAGED>
__global__ void __launch_bounds__(32 * kMaxWarps)
sw_solve_k_wide_kernel(const float* __restrict__ r,
                       const float* __restrict__ Lg,
                       const float* __restrict__ Ug,
                       const float* __restrict__ Cg, float* __restrict__ x,
                       int P, int N, int b, int ring) {
  extern __shared__ __align__(16) float smem[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const size_t fw = factor_words(N, b, BMAX), yn = pad4((size_t)N * b);
  const float* L = Lg;
  const float* U = Ug;
  const float* C = Cg;
  float* ys = smem;
  if (STAGED) {
    copy_in(smem, Lg, (int)fw, threadIdx.x, blockDim.x);
    copy_in(smem + fw, Ug, (int)fw, threadIdx.x, blockDim.x);
    copy_in(smem + 2 * fw, Cg, (int)fw, threadIdx.x, blockDim.x);
    L = smem;
    U = smem + fw;
    C = smem + 2 * fw;
    ys = smem + 3 * fw;
  }
  const int p = blockIdx.x * warps + warp;
  ys += warp * (yn + ring_words(STAGED ? 0 : ring, b));
  if (p < P) copy_in(ys, r + (size_t)p * N * b, N * b, lane, 32);
  __syncthreads();
  if (p >= P) return;  // whole warps leave, after the block's only barrier
  float* xp = x + (size_t)p * N * b;
  if constexpr (STAGED) {
    wide_forward<BMAX, false, false>(ys, nullptr, L, nullptr, N, b, lane);
    __syncwarp();
    wide_u_pass<BMAX, false>(ys, U, nullptr, N, b, 0, 1, lane);
    __syncwarp();
    wide_backward<BMAX, false>(ys, C, nullptr, xp, N, b, lane);
  } else {
    FactorRing g = ring_of(ys + yn, ring, b, N, L, U, C, 3, 3u * N);
    ring_start(g, lane);
    wide_forward<BMAX, false, true>(ys, nullptr, nullptr, &g, N, b, lane);
    __syncwarp();
    wide_u_pass<BMAX, true>(ys, nullptr, &g, N, b, 0, 1, lane);
    __syncwarp();
    wide_backward<BMAX, true>(ys, nullptr, &g, xp, N, b, lane);
  }
}

// K4's dynamic shared memory a block: the factors when staged, then a
// warp's r/y buffer and, with a ring (unstaged above bmax 16), its ring
size_t smem_bytes(int N, int b, int warps, int staged, int bmax, int ring) {
  return sizeof(float) *
         ((staged ? 3 * factor_words(N, b, bmax) : 0) +
          (size_t)warps * (pad4((size_t)N * b) + ring_words(ring, b)));
}

// a ring's depth: 2, 4 or 8 blocks where bmax is above 16 and the factors
// are not staged, none else
bool ring_ok(int bmax, int staged, int ring) {
  return bmax > 16 && !staged ? ring == 2 || ring == 4 || ring == 8
                              : ring == 0;
}

template <int BMAX, int B0, bool STAGED>
int launch(const float* r, const float* L, const float* U, const float* C,
           float* x, int P, int N, int b, int warps, int ring,
           cudaStream_t stream) {
  const size_t bytes = smem_bytes(N, b, warps, STAGED, BMAX, ring);
  const int blocks = (P + warps - 1) / warps;
  if constexpr (BMAX <= 16) {
    auto kernel = sw_solve_k_kernel<BMAX, B0, STAGED>;
    if (bytes > 48 * 1024) {
      const int rc = (int)cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
      if (rc) return rc;
    }
    kernel<<<blocks, 32 * warps, bytes, stream>>>(r, L, U, C, x, P, N, b);
  } else {
    auto kernel = sw_solve_k_wide_kernel<BMAX, STAGED>;
    if (bytes > 48 * 1024) {
      const int rc = (int)cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
      if (rc) return rc;
    }
    kernel<<<blocks, 32 * warps, bytes, stream>>>(r, L, U, C, x, P, N, b,
                                                  ring);
  }
  return (int)cudaGetLastError();
}

// b = 5 (every model of the repo on the stagewise frame) has an
// instantiation of its own, with no padded column on the chain
template <int BMAX>
int launch_b(const float* r, const float* L, const float* U, const float* C,
             float* x, int P, int N, int b, int warps, int staged, int ring,
             cudaStream_t stream) {
  if (BMAX == 8 && b == 5)
    return staged ? launch<8, 5, true>(r, L, U, C, x, P, N, b, warps, 0,
                                       stream)
                  : launch<8, 5, false>(r, L, U, C, x, P, N, b, warps, 0,
                                        stream);
  return staged ? launch<BMAX, 0, true>(r, L, U, C, x, P, N, b, warps, ring,
                                        stream)
                : launch<BMAX, 0, false>(r, L, U, C, x, P, N, b, warps, ring,
                                         stream);
}

// ---- K5 ------------------------------------------------------------------

}  // namespace

extern "C" {

// the arguments of K5 (ops/cuda_stagewise.py mirrors it field by field).
// Per problem, contiguous: q, x0, x (P, N, b); l, u, z0, y0, z, y, dy
// (P, N, m); ze0, ye0, ext_u, ze, ye, dye (P, n_ext). Constants: L, U, C
// (N, b, b); J, Mc (m, b); tie (N, n_blk) and blk (n_blk) the blocking
// rows' coefficients and columns; rows (3, m, N): ρ, the soft rows' linear
// and quadratic penalties, by row then stage; Aext (n_ext, N, b), KiU
// (N, b, n_ext), Cw (n_ext, n_ext), rho_e (n_ext); gM (S, S, N) the group
// mean's weights (mean = 1; problem p is scenario p mod S of its group).
// ext 0 runs the register path (n_ext ≤ 4, bmax 8 or 16); else kExtRt and
// the placement bits; ext_ws (P, 4·pad4(n_ext)) holds the runtime-r
// path's vectors where kExtVec is set. ring: the depth of the factor ring
// of a slot's sweep warp where bmax is above 16 and the factors are not
// staged (2, 4 or 8), else 0. windows: 0 for the sequential sweep; the
// parallel sweep's C ≥ 1 windows (the libraries built with PHC_SW_PAR),
// Pi and Psi its window maps (N, b, b), row-major up to bmax 16,
// column-major above.
struct PhcSwAdmmArgs {
  const float* q;
  const float* l;
  const float* u;
  const float* x0;
  const float* z0;
  const float* y0;
  const float* ze0;
  const float* ye0;
  const float* ext_u;
  const float* L;
  const float* U;
  const float* C;
  const float* J;
  const float* Mc;
  const float* tie;
  const int* blk;
  const float* rows;
  const float* Aext;
  const float* KiU;
  const float* Cw;
  const float* rho_e;
  const float* gM;
  float* x;
  float* z;
  float* y;
  float* dy;
  float* ze;
  float* ye;
  float* dye;
  int P, N, b, m, S, n_blk, blk0, n_ext, n_cons, mean, iters;
  float sigma, alpha;
  float* ext_ws;
  int ext;
  int ring;
  const float* Pi;
  const float* Psi;
  int windows;
};

}  // extern "C"

namespace {

// words of J and of Mc in shared memory: rows of bmax words up to bmax 16
// (read as 16-byte broadcasts into registers), rows of b words above
// (read where they lie), none where ext reads them from device memory
__host__ __device__ inline size_t jm_words(int m, int b, int bmax, int ext) {
  return bmax <= 16 ? pad4((size_t)m * bmax)
                    : (ext & kExtJM ? 0 : pad4((size_t)m * b));
}

// words of a scenario's Woodbury coefficient and extra-row vectors in
// shared memory: kRMax on the register path; corr, sv, z_e and y_e (r
// each) on the runtime-r path, none where they are in ext_ws
__host__ __device__ inline size_t vec_words(int r, int ext) {
  return !ext ? kRMax : (ext & kExtVec ? 0 : 4 * pad4(r));
}

// word offsets of a K5 CTA's shared memory; every array starts at a
// multiple of 4 words: the constants, the scenario's group-mean weights,
// its z, y, l, u (by row, then stage; above bmax 16 also w = ρz − y), t
// (y in place), mb, x, the consensus rows' buffers (two, with a group
// mean), the Woodbury coefficient and the per-warp sums (the register
// path) or the runtime-r vectors; ext's arrays in device memory take none.
// The parallel sweep's carries (C·b words, `windows` C) come last; the
// sweep warp's factor ring (above bmax 16 unstaged) lies behind them, from
// `total` on (admm_smem_bytes)
struct AdmmLayout {
  size_t L, U, C, J, Mc, tie, blk, Aext, KiU, Cw, rho_e, gM, z, y, l, u, w,
      t, mb, xb, cb, corr, red, cw, total;
};

__host__ __device__ inline AdmmLayout admm_layout(int N, int b, int m, int S,
                                                  int n_blk, int r,
                                                  int n_cons, int mean,
                                                  int warps, int staged,
                                                  int bmax, int ext,
                                                  int windows = 0) {
  AdmmLayout a;
  size_t o = 0;
  const size_t f = staged ? pad4((size_t)N * b * b) : 0;
  const size_t zn = pad4((size_t)m * N), tn = pad4((size_t)N * b);
  const bool ak = !(ext & kExtAK);              // Aext and KiU staged
  a.L = o; o += f;
  a.U = o; o += f;
  a.C = o; o += f;
  a.J = o; o += jm_words(m, b, bmax, ext);
  a.Mc = o; o += jm_words(m, b, bmax, ext);
  a.tie = o; o += pad4((size_t)N * n_blk);
  a.blk = o; o += pad4(n_blk);
  a.Aext = o; o += ak ? pad4((size_t)r * N * b) : 0;
  a.KiU = o; o += ak ? pad4((size_t)N * b * r) : 0;
  a.Cw = o; o += ext & kExtCw ? 0 : pad4((size_t)r * r);
  a.rho_e = o; o += ext & kExtVec ? 0 : pad4(r);
  a.gM = o; o += mean ? pad4((size_t)S * N) : 0;
  a.z = o; o += zn;
  a.y = o; o += zn;
  a.l = o; o += zn;
  a.u = o; o += zn;
  a.w = o; o += bmax > 16 ? zn : 0;
  a.t = o; o += tn;
  a.mb = o; o += tn;
  a.xb = o; o += tn;
  a.cb = o; o += mean ? 2 * pad4((size_t)N * n_cons) : 0;
  a.corr = o; o += vec_words(r, ext);
  a.red = o; o += ext ? 0 : (size_t)kRMax * warps;
  a.cw = o; o += pad4((size_t)windows * b);
  a.total = o;
  return a;
}

// row i of a matrix staged with rows of BMAX words: 16-byte broadcasts
template <int BMAX>
__device__ inline void load_row(float (&v)[BMAX], const float* rowp) {
  const float4* p4 = reinterpret_cast<const float4*>(rowp);
#pragma unroll
  for (int c4 = 0; c4 < BMAX / 4; ++c4) {
    const float4 w = p4[c4];
    v[4 * c4] = w.x;
    v[4 * c4 + 1] = w.y;
    v[4 * c4 + 2] = w.z;
    v[4 * c4 + 3] = w.w;
  }
}

// x_k = (K⁻¹t)_k − KiU_k·corr (the Woodbury term; corr is 0 before the
// first iteration, which leaves the warm x as it is)
template <int BMAX>
__device__ inline void x_stage(float (&xk)[BMAX], const float* xb,
                               const float* KiU, const float* corr, int k,
                               int b, int r) {
#pragma unroll
  for (int c = 0; c < BMAX; ++c) {
    xk[c] = 0.0f;
    if (c < b) {
      float cr = 0.0f;
      for (int j = 0; j < r; ++j)
        cr = fmaf(KiU[(k * b + c) * r + j], corr[j], cr);
      xk[c] = xb[k * b + c] - cr;
    }
  }
}

// one row's w into t_k's Jᵀw (acc) and, at k ≥ 1, t_{k−1}'s M_kᵀw (mm),
// over the NB columns (B0 where b is known at compile time)
template <int BMAX, int NB>
__device__ inline void row_transpose(float (&acc)[BMAX], float (&mm)[BMAX],
                                     const float (&jr)[BMAX],
                                     const float (&mr)[BMAX], float w,
                                     int k, int i, const float* tie,
                                     const int* blk, int n_blk, int blk0) {
#pragma unroll
  for (int c = 0; c < NB; ++c) acc[c] = fmaf(jr[c], w, acc[c]);
  if (k >= 1) {
#pragma unroll
    for (int c = 0; c < NB; ++c) mm[c] = fmaf(mr[c], w, mm[c]);
    const int j = i - blk0;
    if (j >= 0 && j < n_blk) {
      const int cj = blk[j];
      const float tw = -tie[k * n_blk + j];
#pragma unroll
      for (int c = 0; c < BMAX; ++c)
        if (c == cj) mm[c] = fmaf(tw, w, mm[c]);
    }
  }
}

// t_k += Aext_kᵀ(ρₑz_e − y_e)
template <int BMAX>
__device__ inline void add_ext(float (&acc)[BMAX], const float* Aext,
                               const float* rho_e, const float (&ze)[kRMax],
                               const float (&ye)[kRMax], int k, int N, int b,
                               int r) {
#pragma unroll
  for (int j = 0; j < kRMax; ++j) {
    if (j < r) {
      const float we = rho_e[j] * ze[j] - ye[j];
#pragma unroll
      for (int c = 0; c < BMAX; ++c)
        if (c < b) acc[c] = fmaf(Aext[(j * N + k) * b + c], we, acc[c]);
    }
  }
}

// v summed over the tps lanes of each aligned group of a warp (tps a
// power of 2 up to 32), every lane of the group left with the sum
template <int BMAX>
__device__ inline void group_sum(float (&v)[BMAX], int tps) {
  for (int o = tps >> 1; o > 0; o >>= 1)
#pragma unroll
    for (int c = 0; c < BMAX; ++c) v[c] += __shfl_xor_sync(kFull, v[c], o);
}

// add_ext of the runtime-r path: z_e and y_e in arrays, r at runtime, the
// same sums in the same order
template <int BMAX>
__device__ inline void add_ext_rt(float (&acc)[BMAX], const float* Aext,
                                  const float* rho_e, const float* ze,
                                  const float* ye, int k, int N, int b,
                                  int r) {
  for (int j = 0; j < r; ++j) {
    const float we = rho_e[j] * ze[j] - ye[j];
#pragma unroll
    for (int c = 0; c < BMAX; ++c)
      if (c < b) acc[c] = fmaf(Aext[(j * N + k) * b + c], we, acc[c]);
  }
}

// Σ_c a[c]·x[c] over the b columns in order (16-byte loads where b is a
// multiple of 4; a and x then 16-byte aligned)
__device__ inline float dot_cols(const float* a, const float* x, int b) {
  float s = 0.0f;
  if ((b & 3) == 0) {
    for (int c = 0; c < b; c += 4) {
      const float4 u = *reinterpret_cast<const float4*>(a + c);
      const float4 v = *reinterpret_cast<const float4*>(x + c);
      s = fmaf(u.x, v.x, s);
      s = fmaf(u.y, v.y, s);
      s = fmaf(u.z, v.z, s);
      s = fmaf(u.w, v.w, s);
    }
  } else {
    for (int c = 0; c < b; ++c) s = fmaf(a[c], x[c], s);
  }
  return s;
}

// four entries of a row from c0 on (16-byte loads where b is a multiple of
// 4), zero past b
__device__ inline float4 load4(const float* row, int c0, int b) {
  if ((b & 3) == 0) return *reinterpret_cast<const float4*>(row + c0);
  return make_float4(c0 < b ? row[c0] : 0.0f, c0 + 1 < b ? row[c0 + 1] : 0.0f,
                     c0 + 2 < b ? row[c0 + 2] : 0.0f,
                     c0 + 3 < b ? row[c0 + 3] : 0.0f);
}

// ---- K5's grouped and global-state variants (FLEX) ----
//
// Where a node's S scenarios are more than a portable cluster holds, or a
// scenario's state outgrows a CTA's shared memory, the same iteration runs
// with a placement chosen at launch (AdmmFlex):
//  - spc scenarios a CTA, a group one cluster of C ≤ 16 CTAs (above 8 a
//    non-portable size), C·spc ≥ S: scenario s of a group in CTA s / spc,
//    slot s mod spc; the slots past S (a group that does not divide evenly)
//    pass the barriers and compute nothing. The CTA's warps are dealt to
//    the slots in turn (warp w to slot w mod spc), so that the slots'
//    sweep warps (their first) are warps 0 … spc−1, one a scheduler; each
//    slot is, to its threads, the whole CTA of the shared variant.
//  - place 0: every scenario array in shared memory, one slot after the
//    other behind the constants; place 1: z, y, l and u in device memory
//    (the wrapper's scratch, by row then stage as in shared memory, so that
//    a warp's 32 stages read 128 contiguous bytes; only their owner thread
//    reads or writes them, so no barrier is added); place 2: also t, mb, x,
//    the consensus buffers, and the horizon-sized constants (ties, Aext,
//    KiU) read where they lie. Words of scratch a problem: flex_layout.
//  - the group mean runs over the members of the scenario's node alone:
//    the wrapper's member lists (ops/cuda_stagewise.group_members: for
//    each stage the run of stages it lies in, for each scenario of a run
//    the list of its row's nonzero (t, weight) pairs in ascending t),
//    staged behind the constants where they fit, else read from device
//    memory. A node at wide_tree's branch steps has ~11 members of 64, and
//    a slot's row of S·N weights would not fit beside its state. A CTA
//    computes each of its nodes' means once, over all its threads (the
//    root's 64 members no longer wait on one lane that also carries a
//    stage of 32), into the free half of the node's first scenario's
//    buffer, one block barrier before its slots read them. A peer
//    scenario's buffer is read over DSMEM (place < 2) or from the scratch
//    through L2 (place 2, after a fence), at an address from a table of
//    the S buffers, four members' loads issued before their sums. The sum
//    runs in scenario order with the zero weights left out, so a launch
//    is deterministic and each element's sum is the one over all S
//    scenarios that skips zero weights, whichever thread sums it.
struct AdmmFlex {
  int spc;          // scenarios a CTA
  int cluster;      // CTAs a group (1 without a group mean)
  int place;        // 0, 1 or 2 (above)
  float* scratch;   // device memory, gwords words a problem (place ≥ 1)
  const int* members;   // the member lists in device memory (a group mean)
  int lwords;       // their words staged in shared memory (0: read there)
};

// word offsets of a FLEX CTA's shared memory (the constants, the lwords
// staged words of the member lists and, with a group mean, the address of
// each of the group's S consensus buffers (two words each), then spc
// slots of `slot` words) and of a problem's scratch: z … cb (w with z
// above bmax 16) in
// the slot or in the scratch by place, corr and red in the slot (the
// runtime-r vectors in ext_ws where ext says so), then the slot's factor
// ring (ring blocks, above bmax 16 unstaged) and the parallel sweep's
// carries (C·b words, `windows` C)
struct FlexLayout {
  size_t L, U, C, J, Mc, tie, blk, Aext, KiU, Cw, rho_e, lists, peers, slots,
      slot, z, y, l, u, w, t, mb, xb, cb, corr, red, ring, cw, gwords, total;
};

__host__ __device__ inline FlexLayout flex_layout(int N, int b, int m,
                                                  int n_blk, int r,
                                                  int n_cons, int mean,
                                                  int warps_slot, int staged,
                                                  int bmax, int spc,
                                                  int place, int ext,
                                                  int ring, int lwords,
                                                  int S, int windows) {
  FlexLayout a;
  size_t o = 0;
  const size_t f = staged ? pad4((size_t)N * b * b) : 0;
  const bool hz = place < 2;                    // horizon constants staged
  const bool hx = hz && !(ext & kExtAK);        // Aext and KiU staged
  const size_t jn = jm_words(m, b, bmax, ext);
  a.L = o; o += f;
  a.U = o; o += f;
  a.C = o; o += f;
  a.J = o; o += jn;
  a.Mc = o; o += jn;
  a.tie = o; o += hz ? pad4((size_t)N * n_blk) : 0;
  a.blk = o; o += pad4(n_blk);
  a.Aext = o; o += hx ? pad4((size_t)r * N * b) : 0;
  a.KiU = o; o += hx ? pad4((size_t)N * b * r) : 0;
  a.Cw = o; o += ext & kExtCw ? 0 : pad4((size_t)r * r);
  a.rho_e = o; o += ext & kExtVec ? 0 : pad4(r);
  a.lists = o; o += pad4(lwords);
  a.peers = o; o += mean ? pad4(2 * (size_t)S) : 0;
  a.slots = o;
  const size_t zn = pad4((size_t)m * N), tn = pad4((size_t)N * b);
  const size_t cn = mean ? 2 * pad4((size_t)N * n_cons) : 0;
  size_t sl = 0, g = 0;
  size_t& zo = place >= 1 ? g : sl;             // z, y, l, u
  size_t& to = place >= 2 ? g : sl;             // t, mb, x, cb
  a.z = zo; zo += zn;
  a.y = zo; zo += zn;
  a.l = zo; zo += zn;
  a.u = zo; zo += zn;
  a.w = zo; zo += bmax > 16 ? zn : 0;
  a.t = to; to += tn;
  a.mb = to; to += tn;
  a.xb = to; to += tn;
  a.cb = to; to += cn;
  a.corr = sl; sl += vec_words(r, ext);
  a.red = sl; sl += ext ? 0 : (size_t)kRMax * warps_slot;
  a.ring = sl; sl += ring_words(ring, b);
  a.cw = sl; sl += pad4((size_t)windows * b);
  a.slot = sl;
  a.gwords = g;
  a.total = o + (size_t)spc * sl;
  return a;
}

// The wide row work (bmax above 16): a stage's arrays as the kernel placed
// them (shared or device memory), and the lane jl of the stage's group of
// tps lanes.
struct WideRows {
  const float *J, *Mc, *tie;
  const int* blk;
  const float *Aext, *rho_e, *ze, *ye, *q, *rho, *lin, *quad;
  float *x, *t, *mb, *w, *z, *y, *l, *u, *dy;
  int N, b, m, mc, nb, blk0, nc, r, tps, jl;
  float sigma, alpha;
  size_t p;
};

// the stage's columns over the group's lanes in fours (4·jl, 4·jl + 4·tps,
// …), each column's share of t_k = σx_k − q_k + Σ_i J_iᵀw_i and, with
// k ≥ 1, of mb_{k−1} = Σ_i M_kᵀw_i (Mc's rows, then the blocking rows'
// −tie[k, j] on column blk[j]), summed over the rows in order, w from
// s.w. mode 0: the warm t (every row, then the extra rows' term); 1: an
// iteration's rows [0, mc); 2: the consensus rows [mc, m) added to the t
// already there, with the extra rows' term (no M part)
__device__ inline void wide_cols(const WideRows& s, int k, int mode) {
  const int N = s.N, b = s.b;
  const int i0 = mode == 2 ? s.mc : 0, i1 = mode == 0 ? s.m : s.mc;
  const int i2 = mode == 2 ? s.m : i1;
  const bool mpart = mode < 2 && k >= 1;
  for (int c0 = 4 * s.jl; c0 < b; c0 += 4 * s.tps) {
    float t4[4], m4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int c = c0 + u;
      t4[u] = mode < 2 && c < b
                  ? s.sigma * s.x[k * b + c] - __ldg(s.q + k * b + c)
                  : 0.0f;
    }
    for (int i = i0; i < i2; ++i) {
      const float w = s.w[i * N + k];
      const float4 jv = load4(s.J + (size_t)i * b, c0, b);
      t4[0] = fmaf(jv.x, w, t4[0]);
      t4[1] = fmaf(jv.y, w, t4[1]);
      t4[2] = fmaf(jv.z, w, t4[2]);
      t4[3] = fmaf(jv.w, w, t4[3]);
      if (mpart) {
        const float4 mv = load4(s.Mc + (size_t)i * b, c0, b);
        m4[0] = fmaf(mv.x, w, m4[0]);
        m4[1] = fmaf(mv.y, w, m4[1]);
        m4[2] = fmaf(mv.z, w, m4[2]);
        m4[3] = fmaf(mv.w, w, m4[3]);
      }
    }
    if (mpart)
      for (int jb = 0; jb < s.nb; ++jb) {
        const int cj = s.blk[jb] - c0;
        if (cj < 0 || cj > 3 || s.blk0 + jb >= i1) continue;
        const float tw = -s.tie[k * s.nb + jb];
        const float w = s.w[(s.blk0 + jb) * N + k];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (u == cj) m4[u] = fmaf(tw, w, m4[u]);
      }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int c = c0 + u;
      if (c >= b) continue;
      if (mode == 2) t4[u] += s.t[k * b + c];
      if (mode != 1)
        for (int q = 0; q < s.r; ++q)
          t4[u] = fmaf(s.Aext[(q * N + k) * b + c],
                       s.rho_e[q] * s.ze[q] - s.ye[q], t4[u]);
      s.t[k * b + c] = t4[u];
      if (mpart) s.mb[(k - 1) * b + c] = m4[u];
    }
  }
}

// the stage's rows over the group's lanes (lane jl owns rows jl, jl + tps,
// …), each row's J ξ_k + M_k ξ_{k−1} summed over its b columns from x
// where it lies, then the row's update (the narrow row work's, term for
// term: kept apart so that the register path's code stays as it was),
// its w = ρz − y into s.w; the consensus rows leave their zr + y/ρ in cb
__device__ inline void wide_rows(const WideRows& s, int k, float* cb,
                                 bool last) {
  const int N = s.N, b = s.b;
  const float* xk = s.x + k * b;
  for (int i = s.jl; i < s.m; i += s.tps) {
    const float ax = dot_cols(s.J + (size_t)i * b, xk, b);
    float am = 0.0f;
    if (k >= 1) {
      const float* xm = xk - b;
      am = dot_cols(s.Mc + (size_t)i * b, xm, b);
      const int jb = i - s.blk0;
      if (jb >= 0 && jb < s.nb)
        am = fmaf(-s.tie[k * s.nb + jb], xm[s.blk[jb]], am);
    }
    const int o = i * N + k;
    const float z = s.z[o], y = s.y[o], rho = __ldg(s.rho + o);
    const float lo = s.l[o], hi = s.u[o];
    const float lin = __ldg(s.lin + o), quad = __ldg(s.quad + o);
    const float zr = s.alpha * (ax + am) + (1.0f - s.alpha) * z;
    const float sv = zr + y / rho;
    const float tt = (rho * (sv - hi) - lin) / (rho + 2.0f * quad);
    const float zsoft = sv > hi ? hi + fmaxf(tt, 0.0f) : fmaxf(sv, lo);
    const float zbox = fminf(fmaxf(sv, lo), hi);
    const bool cons = i >= s.mc;
    const float zn = (lin > 0.0f || quad > 0.0f) ? zsoft : zbox;
    const float yn = y + rho * (zr - zn);
    if (cons) cb[k * s.nc + (i - s.mc)] = sv;
    if (last && !cons) s.dy[(s.p * N + k) * s.m + i] = yn - y;
    s.z[o] = cons ? zr : zn;
    s.y[o] = cons ? y : yn;
    if (!cons) s.w[o] = rho * zn - yn;
  }
}

// the group mean of one consensus element over a member list (words
// [q0, q1) of ml: (t, weight) pairs in ascending t): Σ w_t·v_t in the
// list's order, v_t at peers[t] + e (L2: read through L2, the scratch of
// place 2; else a generic load, DSMEM or this CTA's shared memory).
// kMembers members a step: their loads issued first (past the list's end
// the step reloads its first member), then their sums in order
constexpr int kMembers = 4;
template <bool L2>
__device__ inline float member_sum(const int* ml, int q0, int q1,
                                   float* const* peers, size_t e) {
  float zn = 0.0f;
  for (int q = q0; q < q1; q += 2 * kMembers) {
    float wt[kMembers], v[kMembers];
#pragma unroll
    for (int u = 0; u < kMembers; ++u) {
      const int2 tw = *reinterpret_cast<const int2*>(
          ml + (q + 2 * u < q1 ? q + 2 * u : q));
      const float* pv = peers[tw.x] + e;
      wt[u] = __int_as_float(tw.y);
      v[u] = L2 ? __ldcg(pv) : *pv;
    }
#pragma unroll
    for (int u = 0; u < kMembers; ++u)
      if (q + 2 * u < q1) zn = fmaf(wt[u], v[u], zn);
  }
  return zn;
}

// the first of the scenarios s0 … s of a CTA whose member list at stage k
// is scenario s's (the scenarios of one node share one list): both words,
// in one load, since an empty list (an all-zero row) begins where the
// next one does
__device__ inline int node_first(const int* ml, int k, int s, int s0) {
  const int2* run = reinterpret_cast<const int2*>(ml + ml[k]);
  const int2 q = run[s];
  while (run[s0].x != q.x || run[s0].y != q.y) ++s0;
  return s0;
}

// the first stage of window c of C over N stages (window c is
// [hz_lo(N, C, c), hz_lo(N, C, c + 1)), one stage longer than the
// shortest where C does not divide N)
__host__ __device__ inline int hz_lo(int N, int C, int c) {
  return (int)((long long)c * N / C);
}

// sweep_rows' forward half over a window of n stages (L its first stage's
// block), y_{s−1} from `cin` (b words; none: a zero carry): the same sums
// in the same order, so that from the true carry y is sweep_rows' bit for
// bit. The schedule differs: the next stage's loads are issued with no
// branch around them (the last stage reloads its own, unused) and r_k + its
// M part is added only after the stage's chain, so that no instruction in
// front of the shuffles waits on a load (a warp issues in order)
template <int BMAX, int B0>
__device__ inline void window_forward(float* ys, const float* add,
                                      const float* L, int n, int b, int lane,
                                      const float* cin) {
  constexpr int NB = B0 ? B0 : BMAX;
  const int bb = b * b;
  const bool row = lane < b;
  const int lo = row ? lane * b : 0;
  const int lr = row ? lane : 0;
  float Lc[NB], Ln[NB];
#pragma unroll
  for (int j = 0; j < NB; ++j) Lc[j] = (row && j < b) ? L[lo + j] : 0.0f;
  float rc = row ? ys[lr] + add[lr] : 0.0f;
  float prev = (cin && row) ? cin[lane] : 0.0f;
#pragma unroll 2
  for (int k = 0; k < n; ++k) {
    const int kn = k + 1 < n ? k + 1 : k;
    const float* Lk = L + (size_t)kn * bb + lo;
#pragma unroll
    for (int j = 0; j < NB; ++j) Ln[j] = (row && j < b) ? Lk[j] : 0.0f;
    const float yv = row ? ys[kn * b + lr] : 0.0f;
    const float av = row ? add[kn * b + lr] : 0.0f;
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < NB; ++j)
      acc = fmaf(Lc[j], __shfl_sync(kFull, prev, j), acc);
    prev = rc - acc;
    if (row) ys[k * b + lane] = prev;
#pragma unroll
    for (int j = 0; j < NB; ++j) Lc[j] = Ln[j];
    rc = yv + av;
  }
}

// sweep_rows' backward half over a window of n stages (U, C its first
// stage's blocks), x_e from `cin` (none: a zero carry), x into xp; the
// previous stage's loads with no branch around them, as window_forward's
template <int BMAX, int B0>
__device__ inline void window_backward(const float* ys, const float* U,
                                       const float* C, float* xp, int n,
                                       int b, int lane, const float* cin) {
  constexpr int NB = B0 ? B0 : BMAX;
  const int bb = b * b;
  const bool row = lane < b;
  const int lo = row ? lane * b : 0;
  float Uc[NB], Cc[NB], yc[NB], Un[NB], Cn[NB], yn[NB];
  {
    const size_t o = (size_t)(n - 1) * bb + lo;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      Uc[j] = (row && j < b) ? U[o + j] : 0.0f;
      Cc[j] = (row && j < b) ? C[o + j] : 0.0f;
      yc[j] = j < b ? ys[(n - 1) * b + j] : 0.0f;
    }
  }
  float nxt = (cin && row) ? cin[lane] : 0.0f;
#pragma unroll 2
  for (int k = n - 1; k >= 0; --k) {
    const int kp = k >= 1 ? k - 1 : 0;
    const size_t o = (size_t)kp * bb + lo;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      Un[j] = (row && j < b) ? U[o + j] : 0.0f;
      Cn[j] = (row && j < b) ? C[o + j] : 0.0f;
      yn[j] = j < b ? ys[kp * b + j] : 0.0f;
    }
    float a = 0.0f, c = 0.0f;
#pragma unroll
    for (int j = 0; j < NB; ++j) a = fmaf(Uc[j], yc[j], a);
#pragma unroll
    for (int j = 0; j < NB; ++j)
      c = fmaf(Cc[j], __shfl_sync(kFull, nxt, j), c);
    nxt = a - c;
    if (row) xp[(size_t)k * b + lane] = nxt;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      Uc[j] = Un[j];
      Cc[j] = Cn[j];
      yc[j] = yn[j];
    }
  }
}

// one warp: the register path's Woodbury coefficient corr = Cw·(Aext·x)
// over r ≤ kRMax extra rows, the sums Aext·x over the lanes by shuffles
// (xb, Aext, Cw, corr, N, b, r and lane in scope). A macro, not a
// function: both sweeps share its text and the sequential instantiations
// keep their machine code (an inlined function moves their registers)
#define PHC_WOODBURY_CORR                                                   \
  float sv[kRMax];                                                          \
  _Pragma("unroll")                                                         \
  for (int e = 0; e < kRMax; ++e) sv[e] = 0.0f;                             \
  for (int e = lane; e < N * b; e += 32) {                                  \
    const float xe = xb[e];                                                 \
    _Pragma("unroll")                                                       \
    for (int q = 0; q < kRMax; ++q)                                         \
      if (q < r) sv[q] = fmaf(Aext[q * N * b + e], xe, sv[q]);              \
  }                                                                         \
  _Pragma("unroll")                                                         \
  for (int q = 0; q < kRMax; ++q)                                           \
    _Pragma("unroll")                                                       \
    for (int o = 16; o > 0; o >>= 1)                                        \
      sv[q] += __shfl_xor_sync(kFull, sv[q], o);                            \
  if (lane < r) {                                                           \
    float cv = 0.0f;                                                        \
    _Pragma("unroll")                                                       \
    for (int q = 0; q < kRMax; ++q)                                         \
      if (q < r) cv = fmaf(Cw[lane * r + q], sv[q], cv);                    \
    corr[lane] = cv;                                                        \
  }

// ---- K5's parallel sweep (PAR: the reference's parallel_sweeps=True) ----
//
// Inside the main kernel (below) the horizon of a slot's problem in C
// windows (hz_lo), C ≤ 8 from the slot's warps, warp w sweeping windows w,
// w + W, …: each window's forward sweep from a zero carry (y⁰), a slot
// barrier, one warp composing the carries into every window with Π at the
// window ends (win_carries, the recurrence of the horizon variant's
// hz_carry, from shared memory), a barrier, every thread correcting
// y_k += Π_k·carry (win_correct), and the same backward with Ψ. The maps
// Π and Ψ ((N, b, b) each, ops/stagewise.window_maps, one pair per prep
// shared by every problem) are read through L2, row-major up to bmax 16,
// column-major above (as the wide factors, so that a warp's lanes read a
// column as consecutive words). The chain is 2·⌈N/C⌉ stages plus 2·(C−1)
// carry steps, against 2·N.

// the window of stage k among C windows over N stages (hz_lo's inverse;
// (k + 1)·C stays far below 2³¹ at any horizon K5 plans)
__device__ inline int win_of(int k, int N, int C) {
  return ((k + 1) * C - 1) / N;
}

// one warp: the carry into each of the C windows, cw[c·b … c·b + b) (zero
// into the first window, forward; into the last, backward), composed over
// the windows in chain order, carry ← M·carry + v at the stage that ends
// (forward: y⁰ at a window's last stage, Π there) or begins (backward: x⁰
// at a window's first stage, Ψ there) the window before it in the chain.
// Up to bmax 16 lane i holds row i of the next step's map in registers
// while the current step runs, the carry in lanes < b (shuffles); above,
// a lane's rows R = BMAX/32 (clamped into the block), the carry read back
// from cw as broadcasts
template <int BMAX>
__device__ inline void win_carries(float* cw, const float* maps,
                                   const float* v, int N, int C, int b,
                                   int lane, bool forward) {
  if (C < 2) return;
  const int bb = b * b;
  const int first = forward ? 0 : C - 1;
  // step t carries from window src(t) into dst(t), at stage at(t)
  auto at = [&](int t) {
    return forward ? hz_lo(N, C, t + 1) - 1 : hz_lo(N, C, C - 1 - t);
  };
  auto dst = [&](int t) { return forward ? t + 1 : C - 2 - t; };
  if constexpr (BMAX <= 16) {
    const bool row = lane < b;
    const int lo = row ? lane * b : 0;
    float Mc[BMAX], Mn[BMAX];
    int k = at(0);
#pragma unroll
    for (int j = 0; j < BMAX; ++j)
      Mc[j] = (row && j < b) ? __ldg(maps + (size_t)k * bb + lo + j) : 0.0f;
    float vc = row ? v[k * b + lane] : 0.0f;
    float cv = 0.0f;
    if (row) cw[first * b + lane] = 0.0f;
    for (int t = 0; t < C - 1; ++t) {
      const int kn = at(t + 1 < C - 1 ? t + 1 : t);
#pragma unroll
      for (int j = 0; j < BMAX; ++j)
        Mn[j] = (row && j < b) ? __ldg(maps + (size_t)kn * bb + lo + j)
                               : 0.0f;
      const float vn = row ? v[kn * b + lane] : 0.0f;
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < BMAX; ++j)
        acc = fmaf(Mc[j], __shfl_sync(kFull, cv, j), acc);
      cv = row ? acc + vc : 0.0f;
      if (row) cw[dst(t) * b + lane] = cv;
#pragma unroll
      for (int j = 0; j < BMAX; ++j) Mc[j] = Mn[j];
      vc = vn;
    }
  } else {
    constexpr int R = BMAX / 32;
    int ic[R];
    lane_rows<R>(ic, lane, b);
    for (int i = lane; i < b; i += 32) cw[first * b + i] = 0.0f;
    __syncwarp();
    for (int t = 0; t < C - 1; ++t) {
      const int k = at(t);
      const float* M = maps + (size_t)k * bb;     // column-major
      const float* cin = cw + (forward ? t : C - 1 - t) * b;
      float acc[R] = {};
      for (int l = 0; l < b; ++l) {
        const float cl = cin[l];
#pragma unroll
        for (int q = 0; q < R; ++q)
          acc[q] = fmaf(__ldg(M + (size_t)l * b + ic[q]), cl, acc[q]);
      }
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int i = q * 32 + lane;
        if (i < b) cw[dst(t) * b + i] = acc[q] + v[k * b + i];
      }
      __syncwarp();
    }
  }
}

// every thread of the slot: v_k += maps_k·carry_{window of k} over the
// stages that have a carry (every window but the first, forward; but the
// last, backward); CM: the maps column-major (above bmax 16)
template <bool CM>
__device__ inline void win_correct(float* v, const float* maps,
                                   const float* cw, int N, int C, int b,
                                   int tid, int T, bool forward) {
  const int k0 = forward ? hz_lo(N, C, 1) : 0;
  const int k1 = forward ? N : hz_lo(N, C, C - 1);
  for (int e = k0 * b + tid; e < k1 * b; e += T) {
    const int k = e / b, i = e - k * b;
    const float* M = maps + (size_t)k * b * b;
    const float* c = cw + win_of(k, N, C) * b;
    float acc = 0.0f;
    for (int l = 0; l < b; ++l)
      acc = fmaf(__ldg(M + (CM ? (size_t)l * b + i : (size_t)i * b + l)),
                 c[l], acc);
    v[e] += acc;
  }
}

// RDYN: the runtime-r path (see "K5 at any b and r" in the header). Above
// bmax 16 (WIDE) it also runs the row work that holds no bmax-wide array
// in a thread. PAR: the parallel sweep (above win_carries) in place of the
// sequential one, in instantiations of their own (the libraries built with
// PHC_SW_PAR), so that the sequential ones keep their machine code.
template <int BMAX, int B0, bool STAGED, bool FLEX, bool RDYN, bool PAR>
__global__ void __launch_bounds__(BMAX <= 8 ? 512 : 256)
sw_admm_kernel(const PhcSwAdmmArgs a, int tps, AdmmFlex fx) {
  constexpr bool WIDE = BMAX > 16;
  static_assert(RDYN || !WIDE, "bmax above 16 runs the runtime-r path");
  extern __shared__ __align__(16) float smem[];
  const int N = a.N, b = a.b, m = a.m, S = a.S, r = a.n_ext;
  const int nb = a.n_blk, nc = a.n_cons;
  const int ext = RDYN ? a.ext : 0;             // placements (kExt…)
  const int mc = a.mean ? m - nc : m;           // first group-mean row
  // the CTA's threads (tc of TC) and, with FLEX, its slot j: the slot's
  // threads are to it what a CTA's are to the shared variant (tid of T)
  const int spc = FLEX ? fx.spc : 1;
  const int tc = threadIdx.x, TC = blockDim.x;
  const int j = FLEX ? (tc >> 5) % spc : 0;
  const int tid = FLEX ? ((tc >> 5) / spc) * 32 + (tc & 31) : tc;
  const int T = TC / spc, W = T >> 5;
  const int warp = tid >> 5, lane = tid & 31;
  const int G = T / tps;                        // stages a round
  const int g = tid / tps, jl = tid - g * tps;  // group, lane in the group
  constexpr int NB = B0 ? B0 : BMAX;            // columns a row's products
  // this slot's problem p, its scenario s in the group; with FLEX a group
  // is a cluster of fx.cluster CTAs, spc scenarios each
  const int C = FLEX && a.mean ? fx.cluster : 1;
  const size_t grp = FLEX ? blockIdx.x / C : 0;
  const int crank = FLEX ? (int)(blockIdx.x - grp * C) : 0;
  const int s = FLEX ? crank * spc + j
                     : (a.mean ? (int)(blockIdx.x % S) : 0);
  const bool live = !FLEX || s < S;             // slots past S idle
  const size_t p = FLEX ? grp * S + s : blockIdx.x;
  // above bmax 16 unstaged: the depth of the sweep warp's factor ring (0
  // in the parallel sweep's plans: its windows read the factors where
  // they lie)
  constexpr bool RING = WIDE && !STAGED;
  const int ring = RING ? a.ring : 0;
  const int nwin = PAR ? a.windows : 0;         // the parallel sweep's C

  // ---- where every array lies ----
  size_t oL, oU, oC, oJ, oMc, otie, oblk, oAext, oKiU, oCw, orho;
  float *zs, *ysc, *ls, *us, *wb, *tb, *mb, *xb, *cb0, *corr, *red, *rb, *cw;
  const float* gM;                              // gM[s, t, k] at [t·N + k]
  size_t fslots = 0, fslot = 0, fcb = 0, fgw = 0, flists = 0, fpeers = 0;
  bool hz = true;                               // horizon constants staged
  if constexpr (FLEX) {
    const FlexLayout f = flex_layout(N, b, m, nb, r, nc, a.mean, W, STAGED,
                                     BMAX, spc, fx.place, ext, ring,
                                     fx.lwords, S, nwin);
    oL = f.L; oU = f.U; oC = f.C; oJ = f.J; oMc = f.Mc; otie = f.tie;
    oblk = f.blk; oAext = f.Aext; oKiU = f.KiU; oCw = f.Cw; orho = f.rho_e;
    fslots = f.slots; fslot = f.slot; fcb = f.cb; fgw = f.gwords;
    flists = f.lists;
    fpeers = f.peers;
    hz = fx.place < 2;
    float* sl = smem + f.slots + (size_t)j * f.slot;
    float* gl = fx.place >= 1 ? fx.scratch + (live ? p : 0) * f.gwords : sl;
    float* zb = fx.place >= 1 ? gl : sl;
    float* tbase = fx.place >= 2 ? gl : sl;
    zs = zb + f.z; ysc = zb + f.y; ls = zb + f.l; us = zb + f.u;
    wb = zb + f.w;
    tb = tbase + f.t; mb = tbase + f.mb; xb = tbase + f.xb;
    cb0 = tbase + f.cb;
    corr = sl + f.corr; red = sl + f.red;
    if constexpr (RING) rb = sl + f.ring;
    cw = sl + f.cw;
    gM = nullptr;                               // the member lists instead
  } else {
    const AdmmLayout lay = admm_layout(N, b, m, S, nb, r, nc, a.mean, W,
                                       STAGED, BMAX, ext, nwin);
    oL = lay.L; oU = lay.U; oC = lay.C; oJ = lay.J; oMc = lay.Mc;
    otie = lay.tie; oblk = lay.blk; oAext = lay.Aext; oKiU = lay.KiU;
    oCw = lay.Cw; orho = lay.rho_e;
    zs = smem + lay.z; ysc = smem + lay.y; ls = smem + lay.l;
    us = smem + lay.u; wb = smem + lay.w; tb = smem + lay.t;
    mb = smem + lay.mb;
    xb = smem + lay.xb; cb0 = smem + lay.cb; corr = smem + lay.corr;
    red = smem + lay.red;
    if constexpr (RING) rb = smem + lay.total;
    cw = smem + lay.cw;
    gM = smem + lay.gM;
  }
  // the runtime-r path's vectors, r words each: the Woodbury coefficient,
  // wsum = Aext·K⁻¹t, z_e and y_e (in the slot, or in ext_ws)
  if constexpr (RDYN)
    if (ext & kExtVec) corr = a.ext_ws + (live ? p : 0) * 4 * pad4(r);
  float* wsum = corr + pad4(r);
  float* zev = corr + 2 * pad4(r);
  float* yev = corr + 3 * pad4(r);

  // ---- constants into shared memory, once per launch ----
  const float* L = a.L;
  const float* U = a.U;
  const float* Cf = a.C;
  if (STAGED) {
    // above bmax 16 the packed blocks, b even (no padding between them)
    copy_in(smem + oL, a.L, N * b * b, tc, TC);
    copy_in(smem + oU, a.U, N * b * b, tc, TC);
    copy_in(smem + oC, a.C, N * b * b, tc, TC);
    L = smem + oL;
    U = smem + oU;
    Cf = smem + oC;
  }
  float* J = smem + oJ;
  float* Mc = smem + oMc;
  if constexpr (WIDE) {
    if (!(ext & kExtJM)) {
      copy_in(J, a.J, m * b, tc, TC);
      copy_in(Mc, a.Mc, m * b, tc, TC);
    }
  } else {
    for (int e = tc; e < m * BMAX; e += TC) {
      const int i = e / BMAX, c = e - i * BMAX;
      J[e] = c < b ? __ldg(a.J + i * b + c) : 0.0f;
      Mc[e] = c < b ? __ldg(a.Mc + i * b + c) : 0.0f;
    }
  }
  // above bmax 16: rows of b words, in shared or device memory
  const float* Jw = WIDE && (ext & kExtJM) ? a.J : J;
  const float* Mw = WIDE && (ext & kExtJM) ? a.Mc : Mc;
  const float* tie = hz ? smem + otie : a.tie;
  int* blk = reinterpret_cast<int*>(smem + oblk);
  if (nb && hz) copy_in(smem + otie, a.tie, N * nb, tc, TC);
  for (int e = tc; e < nb; e += TC) blk[e] = __ldg(a.blk + e);
  const float* Aext = hz ? smem + oAext : a.Aext;
  const float* KiU = hz ? smem + oKiU : a.KiU;
  float* Cw = smem + oCw;
  float* rho_e = smem + orho;
  // the runtime-r path's own (ext's arrays read where they lie), apart
  // from the register path's, whose loads stay those of shared memory
  const bool hx = hz && !(ext & kExtAK);        // Aext and KiU staged
  const float* Aext_r = hx ? Aext : a.Aext;
  const float* KiU_r = hx ? KiU : a.KiU;
  const float* Cw_r = ext & kExtCw ? a.Cw : Cw;
  const float* rho_r = ext & kExtVec ? a.rho_e : rho_e;
  if (r) {
    if (hx) {
      copy_in(smem + oAext, a.Aext, r * N * b, tc, TC);
      copy_in(smem + oKiU, a.KiU, N * b * r, tc, TC);
    }
    if (!(ext & kExtCw)) copy_in(Cw, a.Cw, r * r, tc, TC);
    if (!(ext & kExtVec)) copy_in(rho_e, a.rho_e, r, tc, TC);
  }
  if (!FLEX && a.mean)
    copy_in(smem + (gM - smem), a.gM + (size_t)s * S * N, S * N, tc, TC);
  // the group mean's member lists (FLEX), staged where the plan fits
  // them, and the address of scenario t's consensus buffers: over DSMEM in
  // CTA t / spc, slot t mod spc (place < 2; this CTA's own directly), or
  // in its scratch (place 2)
  const int* ml = nullptr;
  float** peers = nullptr;
  if constexpr (FLEX) {
    ml = fx.members;
    if (a.mean && fx.lwords) {
      copy_in(smem + flists, reinterpret_cast<const float*>(fx.members),
              fx.lwords, tc, TC);
      ml = reinterpret_cast<const int*>(smem + flists);
    }
    peers = reinterpret_cast<float**>(smem + fpeers);
    if (a.mean)
      for (int t = tc; t < S; t += TC) {
        const int rt = t / spc;
        float* pt = smem + fslots + (size_t)(t - rt * spc) * fslot + fcb;
        peers[t] = !hz ? fx.scratch + (grp * S + t) * fgw + fcb
                   : rt == crank
                       ? pt
                       : cg::this_cluster().map_shared_rank(pt, (unsigned)rt);
      }
  }

  // ---- the warm state ----
  const size_t ncb = pad4((size_t)N * nc);
  const float* rho_t = a.rows;
  const float* lin_t = rho_t + (size_t)m * N;
  const float* quad_t = lin_t + (size_t)m * N;
  const float* qp = a.q + p * N * b;
  if (live) {
    for (int e = tid; e < N * b; e += T) {
      xb[e] = __ldg(a.x0 + p * N * b + e);
      mb[e] = 0.0f;
    }
    if constexpr (RDYN) {
      for (int q = tid; q < r; q += T) {
        zev[q] = __ldg(a.ze0 + p * r + q);
        yev[q] = __ldg(a.ye0 + p * r + q);
      }
    } else {
      if (tid < kRMax) corr[tid] = 0.0f;
    }
    for (int k = g; k < N; k += G) {
      const size_t o = (p * N + k) * m;
      for (int i = jl; i < m; i += tps) {
        zs[i * N + k] = __ldg(a.z0 + o + i);
        ysc[i * N + k] = __ldg(a.y0 + o + i);
        ls[i * N + k] = __ldg(a.l + o + i);
        us[i * N + k] = __ldg(a.u + o + i);
      }
    }
  }
  float ze[kRMax], ye[kRMax];
#pragma unroll
  for (int e = 0; e < kRMax; ++e) {
    ze[e] = !RDYN && live && e < r ? __ldg(a.ze0 + p * r + e) : 0.0f;
    ye[e] = !RDYN && live && e < r ? __ldg(a.ye0 + p * r + e) : 0.0f;
  }
  // the sweep warp's factor ring (RING): its fills run L forward, C
  // backward, iteration after iteration, the next iteration's first blocks
  // in flight during this one's row work; 2·N·iters fills in all
  FactorRing fr{};
  if constexpr (RING && !PAR)
    if (live && warp == 0) {
      fr = ring_of(rb, ring, b, N, a.L, a.C, nullptr, 2,
                   2u * (unsigned)N * (unsigned)a.iters);
      ring_start(fr, lane);
    }
  __syncthreads();

  // ---- above bmax 16: the row work in two passes a stage (WideRows) ----
  WideRows wr{};
  if constexpr (WIDE)
    wr = WideRows{Jw, Mw, tie, blk, Aext_r, rho_r, zev, yev, qp, rho_t, lin_t,
                  quad_t, xb, tb, mb, wb, zs, ysc, ls, us, a.dy,
                  N, b, m, mc, nb, a.blk0, nc, r, tps, jl, a.sigma, a.alpha,
                  p};

  // ---- t of the warm state, above bmax 16 ----
  if constexpr (WIDE) if (live) {
    for (int k0 = 0; k0 < N; k0 += G) {
      const int k = k0 + g;
      if (k < N)
        for (int i = jl; i < m; i += tps) {
          const int o = i * N + k;
          wb[o] = __ldg(rho_t + o) * zs[o] - ysc[o];
        }
      __syncwarp();
      if (k < N) wide_cols(wr, k, 0);
    }
  }

  // ---- t of the warm state ----
  // A stage's rows are dealt to the tps lanes of its group (lane jl owns
  // rows jl, jl + tps, …); the rounds over the stages are as many for
  // every lane, so that the group sums reach every lane of a warp. (The
  // runtime-r path's x is corrected in place, so x_stage adds nothing.)
  if constexpr (!WIDE) if (live) {
    for (int k0 = 0; k0 < N; k0 += G) {
      const int k = k0 + g;
      const bool on = k < N;
      float xk[BMAX], acc[BMAX], mm[BMAX], jr[BMAX], mr[BMAX];
#pragma unroll
      for (int c = 0; c < BMAX; ++c) acc[c] = mm[c] = 0.0f;
      if (on) {
        x_stage<BMAX>(xk, xb, KiU, corr, k, b, RDYN ? 0 : r);
        if (jl == 0) {
#pragma unroll
          for (int c = 0; c < BMAX; ++c)
            if (c < b) acc[c] = a.sigma * xk[c] - __ldg(qp + k * b + c);
          if constexpr (RDYN)
            add_ext_rt<BMAX>(acc, Aext_r, rho_r, zev, yev, k, N, b, r);
          else
            add_ext<BMAX>(acc, Aext, rho_e, ze, ye, k, N, b, r);
        }
        for (int i = jl; i < m; i += tps) {
          load_row<BMAX>(jr, J + i * BMAX);
          load_row<BMAX>(mr, Mc + i * BMAX);
          const float w =
              __ldg(rho_t + i * N + k) * zs[i * N + k] - ysc[i * N + k];
          row_transpose<BMAX, NB>(acc, mm, jr, mr, w, k, i, tie, blk, nb,
                                  a.blk0);
        }
      }
      group_sum<BMAX>(acc, tps);
      group_sum<BMAX>(mm, tps);
      if (on && jl == 0) {
#pragma unroll
        for (int c = 0; c < BMAX; ++c) {
          if (c < b) {
            tb[k * b + c] = acc[c];
            if (k >= 1) mb[(k - 1) * b + c] = mm[c];
          }
        }
      }
    }
  }
  __syncthreads();

  for (int it = 0; it < a.iters; ++it) {
    const bool last = it == a.iters - 1;
    float* cb = cb0 + (it & 1) * ncb;           // this iteration's buffer
    // ---- x = K⁻¹t (the slot's warp 0), the Woodbury coefficient ----
    if constexpr (PAR) {
      // the parallel sweep: the windows from a zero carry, the carries
      // (one warp), every stage corrected; above bmax 16 the U pass over
      // the slot's warps between the two, as in the sequential sweep
      const int C = nwin, bb = b * b;
      const size_t fs = WIDE ? wide_block(b) : (size_t)bb;  // a stage's
      if (live)                                               // block
        for (int c = warp; c < C; c += W) {
          const int s0 = hz_lo(N, C, c), n = hz_lo(N, C, c + 1) - s0;
          if constexpr (WIDE)
            wide_forward<BMAX, true, false>(tb + s0 * b, mb + s0 * b,
                                            L + s0 * fs, nullptr, n, b,
                                            lane);
          else
            window_forward<BMAX, B0>(tb + s0 * b, mb + s0 * b, L + s0 * fs,
                                     n, b, lane, nullptr);
        }
      __syncthreads();
      if (live && warp == 0)
        win_carries<BMAX>(cw, a.Pi, tb, N, C, b, lane, true);
      __syncthreads();
      if (live) win_correct<WIDE>(tb, a.Pi, cw, N, C, b, tid, T, true);
      __syncthreads();
      if constexpr (WIDE) {
        if (live)
          wide_u_pass<BMAX, false>(tb, U, nullptr, N, b, warp, W, lane);
        __syncthreads();
      }
      if (live)
        for (int c = warp; c < C; c += W) {
          const int s0 = hz_lo(N, C, c), n = hz_lo(N, C, c + 1) - s0;
          if constexpr (WIDE)
            wide_backward<BMAX, false>(tb + s0 * b, Cf + s0 * fs, nullptr,
                                       xb + s0 * b, n, b, lane);
          else
            window_backward<BMAX, B0>(tb + s0 * b, U + s0 * fs, Cf + s0 * fs,
                                      xb + s0 * b, n, b, lane, nullptr);
        }
      __syncthreads();
      if (live && warp == 0)
        win_carries<BMAX>(cw, a.Psi, xb, N, C, b, lane, false);
      __syncthreads();
      if (live) win_correct<WIDE>(xb, a.Psi, cw, N, C, b, tid, T, false);
      // the register path's Woodbury coefficient, from the corrected x
      if constexpr (!RDYN) if (r) {
        __syncthreads();
        if (live && warp == 0) {
          PHC_WOODBURY_CORR
        }
      }
    } else if constexpr (WIDE) {
      // the forward sweep (warp 0), a_k = U⁻¹_k y_k over the slot's
      // warps, the backward sweep (warp 0)
      if (live && warp == 0)
        wide_forward<BMAX, true, RING>(tb, mb, L, &fr, N, b, lane);
      __syncthreads();
      if (live)
        wide_u_pass<BMAX, false>(tb, U, nullptr, N, b, warp, W, lane);
      __syncthreads();
      if (live && warp == 0)
        wide_backward<BMAX, RING>(tb, Cf, &fr, xb, N, b, lane);
    } else if (live && warp == 0) {
      sweep_rows<BMAX, B0, true>(tb, mb, L, U, Cf, xb, N, b, lane);
      if (!RDYN && r) {
        __syncwarp();
        PHC_WOODBURY_CORR
      }
    }
    __syncthreads();

    // ---- the runtime-r path: the Woodbury term and the extra rows ----
    // Each sum in the register path's order: wsum[q] over the lanes of one
    // warp (warp w takes rows q ≡ w of Aext), corr[q] over Cw's row q; x
    // then corrected in place; and pe[q] = Aext_q·x as the register path
    // sums it (each thread its stages, the lanes of a warp, the warps in
    // order), one warp emulating the slot's warps in turn, followed at
    // once by the row's z_e, y_e update (the rows below read neither)
    if constexpr (RDYN) if (r) {
      if (live)
        for (int q = warp; q < r; q += W) {
          float s = 0.0f;
          for (int e = lane; e < N * b; e += 32)
            s = fmaf(Aext_r[(size_t)q * N * b + e], xb[e], s);
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
          if (lane == 0) wsum[q] = s;
        }
      __syncthreads();
      if (live)
        for (int q = tid; q < r; q += T) {
          float cv = 0.0f;
          for (int e = 0; e < r; ++e)
            cv = fmaf(Cw_r[(size_t)q * r + e], wsum[e], cv);
          corr[q] = cv;
        }
      __syncthreads();
      if (live)
        for (int e = tid; e < N * b; e += T) {
          float cr = 0.0f;
          for (int q = 0; q < r; ++q)
            cr = fmaf(KiU_r[(size_t)e * r + q], corr[q], cr);
          xb[e] = xb[e] - cr;
        }
      __syncthreads();
      if (live)
        for (int q = warp; q < r; q += W) {
          float axe = 0.0f;
          for (int w = 0; w < W; ++w) {
            const int t = w * 32 + lane, gt = t / tps;
            float s = 0.0f;
            if (t == gt * tps)
              for (int k = gt; k < N; k += G)
                for (int c = 0; c < b; ++c)
                  s = fmaf(Aext_r[(q * N + k) * b + c], xb[k * b + c], s);
#pragma unroll
            for (int o = 16; o > 0; o >>= 1)
              s += __shfl_xor_sync(kFull, s, o);
            axe += s;
          }
          if (lane == 0) {
            const float zr = a.alpha * axe + (1.0f - a.alpha) * zev[q];
            const float zn = fminf(zr + yev[q] / rho_r[q],
                                   __ldg(a.ext_u + p * r + q));
            const float yn = yev[q] + rho_r[q] * (zr - zn);
            if (last) a.dye[p * r + q] = yn - yev[q];
            zev[q] = zn;
            yev[q] = yn;
          }
        }
    }

    // ---- the rows: zr, the z and y updates, and the new w into t ----
    if constexpr (WIDE) if (live) {
      for (int k0 = 0; k0 < N; k0 += G) {
        const int k = k0 + g;
        if (k < N) wide_rows(wr, k, cb, last);
        __syncwarp();
        if (k < N) wide_cols(wr, k, 1);
      }
    }
    float pe[kRMax];
#pragma unroll
    for (int e = 0; e < kRMax; ++e) pe[e] = 0.0f;
    if constexpr (!WIDE) if (live) {
      for (int k0 = 0; k0 < N; k0 += G) {
        const int k = k0 + g;
        const bool on = k < N;
        float xk[BMAX], xm[BMAX], acc[BMAX], mm[BMAX], jr[BMAX], mr[BMAX];
#pragma unroll
        for (int c = 0; c < BMAX; ++c) acc[c] = mm[c] = 0.0f;
        if (on) {
          x_stage<BMAX>(xk, xb, KiU, corr, k, b, RDYN ? 0 : r);
          if (k >= 1) {
            x_stage<BMAX>(xm, xb, KiU, corr, k - 1, b, RDYN ? 0 : r);
          } else {
#pragma unroll
            for (int c = 0; c < BMAX; ++c) xm[c] = 0.0f;
          }
          if (jl == 0) {
#pragma unroll
            for (int q = 0; q < kRMax; ++q)
              if (!RDYN && q < r)
#pragma unroll
                for (int c = 0; c < BMAX; ++c)
                  if (c < b)
                    pe[q] = fmaf(Aext[(q * N + k) * b + c], xk[c], pe[q]);
#pragma unroll
            for (int c = 0; c < BMAX; ++c)
              if (c < b) acc[c] = a.sigma * xk[c] - __ldg(qp + k * b + c);
          }
          for (int i = jl; i < m; i += tps) {
            load_row<BMAX>(jr, J + i * BMAX);
            load_row<BMAX>(mr, Mc + i * BMAX);
            // J ξ_k and M_k ξ_{k−1} in two chains
            float ax = 0.0f, am = 0.0f;
#pragma unroll
            for (int c = 0; c < NB; ++c) ax = fmaf(jr[c], xk[c], ax);
            if (k >= 1) {
#pragma unroll
              for (int c = 0; c < NB; ++c) am = fmaf(mr[c], xm[c], am);
              const int jb = i - a.blk0;
              if (jb >= 0 && jb < nb) {
                const int cj = blk[jb];
                float xv = 0.0f;
#pragma unroll
                for (int c = 0; c < BMAX; ++c)
                  if (c == cj) xv = xm[c];
                am = fmaf(-tie[k * nb + jb], xv, am);
              }
            }
            const int o = i * N + k;
            const float z = zs[o], y = ysc[o], rho = __ldg(rho_t + o);
            const float lo = ls[o], hi = us[o];
            const float lin = __ldg(lin_t + o), quad = __ldg(quad_t + o);
            const float zr = a.alpha * (ax + am) + (1.0f - a.alpha) * z;
            const float sv = zr + y / rho;
            // every row kind computed, one kept: no divergence in a group
            // the penalty prox: min lin·t + quad·t² + ρ/2(z−s)², t = (z−u)₊
            const float tt = (rho * (sv - hi) - lin) / (rho + 2.0f * quad);
            const float zsoft =
                sv > hi ? hi + fmaxf(tt, 0.0f) : fmaxf(sv, lo);
            const float zbox = fminf(fmaxf(sv, lo), hi);
            const bool cons = i >= mc;   // the group mean waits for every
                                         // scenario (phase below)
            const float zn = (lin > 0.0f || quad > 0.0f) ? zsoft : zbox;
            const float yn = y + rho * (zr - zn);
            if (cons) cb[k * nc + (i - mc)] = sv;
            if (last && !cons) a.dy[(p * N + k) * m + i] = yn - y;
            zs[o] = cons ? zr : zn;
            ysc[o] = cons ? y : yn;
            row_transpose<BMAX, NB>(acc, mm, jr, mr,
                                    cons ? 0.0f : rho * zn - yn, k, i, tie,
                                    blk, nb, a.blk0);
          }
        }
        group_sum<BMAX>(acc, tps);
        group_sum<BMAX>(mm, tps);
        if (on && jl == 0) {
#pragma unroll
          for (int c = 0; c < BMAX; ++c) {
            if (c < b) {
              tb[k * b + c] = acc[c];
              if (k >= 1) mb[(k - 1) * b + c] = mm[c];
            }
          }
        }
      }
      if (!RDYN && r) {
#pragma unroll
        for (int q = 0; q < kRMax; ++q)
#pragma unroll
          for (int o = 16; o > 0; o >>= 1)
            pe[q] += __shfl_xor_sync(kFull, pe[q], o);
        if (lane < r) {
          float v = 0.0f;
#pragma unroll
          for (int q = 0; q < kRMax; ++q)
            if (q == lane) v = pe[q];
          red[warp * kRMax + lane] = v;
        }
      }
    }
    if (a.mean) {
      // place 2: the consensus buffers are in device memory, read by the
      // peers through L2
      if (FLEX && !hz) __threadfence();
      cg::this_cluster().sync();   // every scenario's zr + y/ρ is out
    } else if (r) {
      __syncthreads();
    } else {
      __syncthreads();
      continue;                    // t is complete
    }

    // ---- the extra rows (every thread of the slot, the same sums) ----
    if (!RDYN && live) {
#pragma unroll
      for (int q = 0; q < kRMax; ++q) {
        if (q < r) {
          float axe = 0.0f;
          for (int w = 0; w < W; ++w) axe += red[w * kRMax + q];
          const float zr = a.alpha * axe + (1.0f - a.alpha) * ze[q];
          const float zn = fminf(zr + ye[q] / rho_e[q],
                                 __ldg(a.ext_u + p * r + q));
          const float yn = ye[q] + rho_e[q] * (zr - zn);
          if (last && tid == 0) a.dye[p * r + q] = yn - ye[q];
          ze[q] = zn;
          ye[q] = yn;
        }
      }
    }
    // ---- the group mean over the scenarios' buffers, and t completed ----
    cg::cluster_group cl = cg::this_cluster();
    if constexpr (FLEX) if (a.mean) {
      // each node's means once a CTA, over all its threads: its first
      // scenario here (node_first) sums them into its buffers' free half
      // (the peers read only the half of `it`; the next iteration's rows
      // refill it), where the node's other scenarios here read them
      for (int q = tc; q < spc * N * nc; q += TC) {
        const int jq = q / (N * nc), k = (q - jq * N * nc) / nc;
        const int jc = q - jq * N * nc - k * nc, sq = crank * spc + jq;
        if (sq >= S || node_first(ml, k, sq, crank * spc) != sq) continue;
        const int2 qr = *reinterpret_cast<const int2*>(ml + ml[k] + 2 * sq);
        const size_t e = (size_t)(it & 1) * ncb + k * nc + jc;
        peers[sq][(size_t)((it + 1) & 1) * ncb + k * nc + jc] =
            hz ? member_sum<false>(ml, qr.x, qr.y, peers, e)
               : member_sum<true>(ml, qr.x, qr.y, peers, e);
      }
      __syncthreads();
    }
    if (live) {
      for (int k0 = 0; k0 < N; k0 += G) {
        const int k = k0 + g;
        const bool on = k < N;
        float acc[WIDE ? 1 : BMAX], jr[WIDE ? 1 : BMAX];
        if constexpr (!WIDE) {
#pragma unroll
          for (int c = 0; c < BMAX; ++c) acc[c] = 0.0f;
        }
        if (on && a.mean) {
          // FLEX: the means' CTA copy, at the first scenario of the node
          const float* mn = nullptr;
          if constexpr (FLEX)
            mn = peers[node_first(ml, k, s, crank * spc)] +
                 (size_t)((it + 1) & 1) * ncb;
          for (int i = mc + (jl + tps - mc % tps) % tps; i < m; i += tps) {
            const int jc = i - mc;   // the consensus rows this lane owns
            float zn = 0.0f;
            if constexpr (FLEX) {
              zn = mn[k * nc + jc];
            } else {
              for (int t = 0; t < S; ++t) {
                const float* cbt =
                    t == s ? cb : cl.map_shared_rank(cb, (unsigned)t);
                zn = fmaf(gM[t * N + k], cbt[k * nc + jc], zn);
              }
            }
            const int o = i * N + k;
            const float zr = zs[o], y = ysc[o], rho = __ldg(rho_t + o);
            const float yn = y + rho * (zr - zn);
            if (last) a.dy[(p * N + k) * m + i] = yn - y;
            zs[o] = zn;
            ysc[o] = yn;
            if constexpr (WIDE) {
              wb[o] = rho * zn - yn;
            } else {
              // the consensus rows have no M part: Jᵀw alone
              load_row<BMAX>(jr, J + i * BMAX);
              const float w = rho * zn - yn;
#pragma unroll
              for (int c = 0; c < NB; ++c) acc[c] = fmaf(jr[c], w, acc[c]);
            }
          }
        }
        if constexpr (WIDE) {
          __syncwarp();
          if (on) wide_cols(wr, k, 2);
        } else {
          if (a.mean) group_sum<BMAX>(acc, tps);
          if (on && jl == 0) {
#pragma unroll
            for (int c = 0; c < BMAX; ++c)
              if (c < b) acc[c] += tb[k * b + c];
            if constexpr (RDYN)
              add_ext_rt<BMAX>(acc, Aext_r, rho_r, zev, yev, k, N, b, r);
            else
              add_ext<BMAX>(acc, Aext, rho_e, ze, ye, k, N, b, r);
#pragma unroll
            for (int c = 0; c < BMAX; ++c)
              if (c < b) tb[k * b + c] = acc[c];
          }
        }
      }
    }
    __syncthreads();
  }

  // ---- out: x, z, y (and dy, dy_e when no iteration ran) ----
  if (live) {
    if constexpr (RDYN) {           // x is corrected in place
      for (int e = tid; e < N * b; e += T) a.x[p * N * b + e] = xb[e];
    }
    for (int k = g; k < N; k += G) {
      if (!RDYN && jl == 0) {
        float xk[WIDE ? 1 : BMAX];
        if constexpr (!WIDE) {
          x_stage<BMAX>(xk, xb, KiU, corr, k, b, r);
#pragma unroll
          for (int c = 0; c < BMAX; ++c)
            if (c < b) a.x[(p * N + k) * b + c] = xk[c];
        }
      }
      const size_t o = (p * N + k) * m;
      for (int i = jl; i < m; i += tps) {
        a.z[o + i] = zs[i * N + k];
        a.y[o + i] = ysc[i * N + k];
        if (a.iters == 0) a.dy[o + i] = 0.0f;
      }
    }
    if constexpr (RDYN) {
      for (int q = tid; q < r; q += T) {
        a.ze[p * r + q] = zev[q];
        a.ye[p * r + q] = yev[q];
        if (a.iters == 0) a.dye[p * r + q] = 0.0f;
      }
    } else if (tid == 0) {
#pragma unroll
      for (int q = 0; q < kRMax; ++q) {
        if (q < r) {
          a.ze[p * r + q] = ze[q];
          a.ye[p * r + q] = ye[q];
          if (a.iters == 0) a.dye[p * r + q] = 0.0f;
        }
      }
    }
  }
  // the peers may still read this CTA's consensus buffer
  if (a.mean) cg::this_cluster().sync();
}

size_t admm_smem_bytes(int N, int b, int m, int S, int n_blk, int r,
                       int n_cons, int mean, int warps, int staged,
                       int windows, int bmax, int ext, int ring) {
  return sizeof(float) * (pad4((size_t)windows * b) +
                          admm_layout(N, b, m, S, n_blk, r, n_cons, mean,
                                      warps, staged, bmax, ext).total +
                          ring_words(ring, b));
}

// one CTA a problem, 32·warps threads in groups of tps a stage, clusters of
// S CTAs with a group mean
template <int BMAX, int B0, bool STAGED, bool RDYN>
int launch_admm(const PhcSwAdmmArgs& a, int warps, int tps,
                cudaStream_t stream) {
  auto kernel = sw_admm_kernel<BMAX, B0, STAGED, false, RDYN, kPar>;
  const size_t bytes = admm_smem_bytes(a.N, a.b, a.m, a.S, a.n_blk, a.n_ext,
                                       a.n_cons, a.mean, warps, STAGED,
                                       a.windows, BMAX, a.ext, a.ring);
  if (bytes > 48 * 1024) {
    const int rc = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (rc) return rc;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)a.P, 1, 1);
  cfg.blockDim = dim3((unsigned)(32 * warps), 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)(a.mean ? a.S : 1);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const AdmmFlex none = {1, 1, 0, nullptr};
  const int rc = (int)cudaLaunchKernelEx(&cfg, kernel, a, tps, none);
  return rc ? rc : (int)cudaGetLastError();
}

// b = 5 has an instantiation of its own on the register path; the
// runtime-r path runs it in bmax 8's (the padded columns add exact zeros)
template <int BMAX, bool RDYN>
int launch_admm_b(const PhcSwAdmmArgs& a, int warps, int tps, int staged,
                  cudaStream_t s) {
  if constexpr (BMAX == 8 && !RDYN)
    if (a.b == 5)
      return staged ? launch_admm<8, 5, true, RDYN>(a, warps, tps, s)
                    : launch_admm<8, 5, false, RDYN>(a, warps, tps, s);
  return staged ? launch_admm<BMAX, 0, true, RDYN>(a, warps, tps, s)
                : launch_admm<BMAX, 0, false, RDYN>(a, warps, tps, s);
}

size_t flex_smem_bytes(const PhcSwAdmmArgs& a, int warps, int staged,
                       int bmax, const AdmmFlex& fx) {
  return sizeof(float) * flex_layout(a.N, a.b, a.m, a.n_blk, a.n_ext,
                                     a.n_cons, a.mean, warps / fx.spc,
                                     staged, bmax, fx.spc, fx.place,
                                     a.ext, a.ring,
                                     a.mean ? fx.lwords : 0, a.S,
                                     a.windows).total;
}

// a FLEX launch: groups of S scenarios over clusters of fx.cluster CTAs
// of fx.spc scenarios each (one CTA a problem without a group mean); or,
// if `max_clusters`, how many such clusters the card holds at once
// (cudaOccupancyMaxActiveClusters)
template <int BMAX, int B0, bool STAGED, bool RDYN>
int launch_flex(const PhcSwAdmmArgs& a, int warps, int tps,
                const AdmmFlex& fx, cudaStream_t stream, int* max_clusters) {
  auto kernel = sw_admm_kernel<BMAX, B0, STAGED, true, RDYN, kPar>;
  const size_t bytes = flex_smem_bytes(a, warps, STAGED, BMAX, fx);
  if (bytes > 48 * 1024) {
    const int rc = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (rc) return rc;
  }
  const int C = a.mean ? fx.cluster : 1;
  if (C > 8) {
    const int rc = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (rc) return rc;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(a.mean ? a.P / a.S * C : a.P), 1, 1);
  cfg.blockDim = dim3((unsigned)(32 * warps), 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (max_clusters) {
    cfg.gridDim = dim3((unsigned)C, 1, 1);
    return (int)cudaOccupancyMaxActiveClusters(max_clusters,
                                               (const void*)kernel, &cfg);
  }
  const int rc = (int)cudaLaunchKernelEx(&cfg, kernel, a, tps, fx);
  return rc ? rc : (int)cudaGetLastError();
}

template <int BMAX, bool RDYN>
int launch_flex_b(const PhcSwAdmmArgs& a, int warps, int tps, int staged,
                  const AdmmFlex& fx, cudaStream_t s, int* maxc) {
  if constexpr (BMAX == 8 && !RDYN)
    if (a.b == 5)
      return staged
                 ? launch_flex<8, 5, true, RDYN>(a, warps, tps, fx, s, maxc)
                 : launch_flex<8, 5, false, RDYN>(a, warps, tps, fx, s, maxc);
  return staged
             ? launch_flex<BMAX, 0, true, RDYN>(a, warps, tps, fx, s, maxc)
             : launch_flex<BMAX, 0, false, RDYN>(a, warps, tps, fx, s, maxc);
}

// the checks common to every K5 launch: the register path up to kRMax
// extra rows at bmax 8 and 16; the runtime-r path with known placement
// bits (J and Mc in device memory only above bmax 16, the vectors there
// only with ext_ws)
bool admm_args_ok(const PhcSwAdmmArgs* a, int warps, int tps, int staged,
                  int bmax) {
  const int e = a->ext;
  const bool ext_ok =
      e ? (e & kExtRt) && !(e & ~31) && (bmax > 16 || !(e & kExtJM)) &&
              (!(e & kExtVec) || a->ext_ws)
        : a->n_ext <= kRMax && bmax <= 16;
  // the parallel sweep's libraries: 1 to kMaxWindows windows (at most N),
  // their maps beyond one, no factor ring; the others: no windows
  const bool sweep_ok =
      kPar ? a->windows >= 1 && a->windows <= kMaxWindows &&
                 a->windows <= a->N && a->ring == 0 &&
                 (a->windows == 1 || (a->Pi && a->Psi))
           : a->windows == 0 && ring_ok(bmax, staged, a->ring);
  return !(a->P < 1 || a->N < 1 || a->b < 1 || a->b > bmax || a->m < 1 ||
           a->S < 1 || a->P % a->S || a->n_ext < 0 || !ext_ok ||
           a->iters < 0 || warps < 1 ||
           32 * warps > admm_max_threads(bmax) || tps < 1 || tps > 32 ||
           (tps & (tps - 1)) || !sweep_ok ||
           (bmax > 16 && staged && (a->b & 1)) ||
           (a->mean && (a->n_cons < 1 || a->n_cons > a->m)));
}

// the placement of a FLEX launch: a cluster of at most 16 CTAs whose slots
// cover the group with no CTA left empty, whole warps a slot, scratch
// where a place keeps arrays in device memory, member lists with a group
// mean
bool flex_ok(const PhcSwAdmmArgs* a, int warps, const AdmmFlex& fx) {
  if (fx.spc < 1 || warps % fx.spc || fx.place < 0 || fx.place > 2 ||
      (fx.place && !fx.scratch) || fx.lwords < 0 ||
      (a->mean && !fx.members))
    return false;
  if (!a->mean) return fx.spc == 1 && fx.cluster == 1 && a->S == 1;
  return fx.cluster >= 1 && fx.cluster <= kMaxCluster &&
         fx.cluster * fx.spc >= a->S && (fx.cluster - 1) * fx.spc < a->S;
}

// Each library holds one part of K5's instantiations (PHC_SW_PART, the
// head of the file): this source alone the register path at bmax 8 and 16,
// stagewise_wide.cu bmax 32 to 128, stagewise_extra.cu the runtime-r path
// at bmax 8 and 16; each with the sequential sweep, or the parallel one
// where built with PHC_SW_PAR (kPar; admm_args_ok checks the windows). A
// launch of another part's is refused.
int admm_dispatch(const PhcSwAdmmArgs* a, int warps, int tps, int staged,
                  int bmax, cudaStream_t s) {
#if PHC_SW_PART == 0
  if (!a->ext) switch (bmax) {
      case 8: return launch_admm_b<8, false>(*a, warps, tps, staged, s);
      case 16: return launch_admm_b<16, false>(*a, warps, tps, staged, s);
    }
#elif PHC_SW_PART == 1
  if (a->ext) switch (bmax) {
      case 32: return launch_admm_b<32, true>(*a, warps, tps, staged, s);
      case 64: return launch_admm_b<64, true>(*a, warps, tps, staged, s);
      case 128: return launch_admm_b<128, true>(*a, warps, tps, staged, s);
    }
#elif PHC_SW_PART == 2
  if (a->ext) switch (bmax) {
      case 8: return launch_admm_b<8, true>(*a, warps, tps, staged, s);
      case 16: return launch_admm_b<16, true>(*a, warps, tps, staged, s);
    }
#endif
  return (int)cudaErrorInvalidValue;
}

int flex_dispatch(const PhcSwAdmmArgs* a, int warps, int tps, int staged,
                  int bmax, const AdmmFlex& fx, cudaStream_t s, int* maxc) {
  const PhcSwAdmmArgs& r = *a;
#if PHC_SW_PART == 0
  if (!a->ext) switch (bmax) {
      case 8: return launch_flex_b<8, false>(r, warps, tps, staged, fx, s,
                                             maxc);
      case 16: return launch_flex_b<16, false>(r, warps, tps, staged, fx, s,
                                               maxc);
    }
#elif PHC_SW_PART == 1
  if (a->ext) switch (bmax) {
      case 32: return launch_flex_b<32, true>(r, warps, tps, staged, fx, s,
                                              maxc);
      case 64: return launch_flex_b<64, true>(r, warps, tps, staged, fx, s,
                                              maxc);
      case 128: return launch_flex_b<128, true>(r, warps, tps, staged, fx,
                                                s, maxc);
    }
#elif PHC_SW_PART == 2
  if (a->ext) switch (bmax) {
      case 8: return launch_flex_b<8, true>(r, warps, tps, staged, fx, s,
                                            maxc);
      case 16: return launch_flex_b<16, true>(r, warps, tps, staged, fx, s,
                                              maxc);
    }
#endif
  return (int)cudaErrorInvalidValue;
}

#if PHC_SW_PART == 3
// ---- K5's horizon variant (the head of the file) ----

// the launch's own arguments beside PhcSwAdmmArgs: the window maps of the
// parallel sweep ((N, b, b) each, read through L2 off the chain), the
// windows a problem and the sweep
struct HorizonArgs {
  const float* Pi;    // Π_k = (−L_k)⋯(−L_s), s the first stage of k's window
  const float* Psi;   // Ψ_k = (−C_k)⋯(−C_{e−1}), e the end of k's window
  int C;              // CTAs a cluster, one window each
  int parallel;       // 0: the sequential sweep, 1: the parallel one
};

// word offsets of a horizon CTA's shared memory, every CTA of a cluster
// alike (windows of up to nw stages), so that a peer's array lies at the
// same offset: the two handoff mbarriers (forward in, backward in), the
// window's factors when staged, J and Mc (rows of bmax words), z, y, l, u
// (by row, then stage), t (y in place), mb, x, five b-word vectors (the
// halo x_{s−1}, the carries in (y_{s−1}, x_e) and, for the parallel
// sweep, the window's published y⁰ at its last stage and x⁰ at its
// first) and, for the parallel sweep, the carries' maps (Π at each
// window's last stage and Ψ at each window's first: 2·C blocks of b²) and
// the peers' published vectors a carry reads (C·b words)
struct HorizonLayout {
  size_t bar, L, U, C, J, Mc, z, y, l, u, t, mb, xb, xh, yin, xin, py, px,
      cm, vb, total;
};

__host__ __device__ inline HorizonLayout horizon_layout(int nw, int b, int m,
                                                        int staged, int bmax,
                                                        int C) {
  HorizonLayout a;
  size_t o = 0;
  const size_t f = staged ? pad4((size_t)nw * b * b) : 0;
  const size_t zn = pad4((size_t)m * nw), tn = pad4((size_t)nw * b);
  const size_t vn = pad4(b);
  a.bar = o; o += 4;
  a.L = o; o += f;
  a.U = o; o += f;
  a.C = o; o += f;
  a.J = o; o += pad4((size_t)m * bmax);
  a.Mc = o; o += pad4((size_t)m * bmax);
  a.z = o; o += zn;
  a.y = o; o += zn;
  a.l = o; o += zn;
  a.u = o; o += zn;
  a.t = o; o += tn;
  a.mb = o; o += tn;
  a.xb = o; o += tn;
  a.xh = o; o += vn;
  a.yin = o; o += vn;
  a.xin = o; o += vn;
  a.py = o; o += vn;
  a.px = o; o += vn;
  a.cm = o; o += pad4((size_t)2 * C * b * b);
  a.vb = o; o += pad4((size_t)C * b);
  a.total = o;
  return a;
}

// every calling thread waits for the completion of phase `parity` of the
// mbarrier (acquire at cluster scope: a peer's stores before its arrive
// are visible after); a handoff that never comes traps (a launch error)
// rather than hang the card
__device__ inline void hz_wait(unsigned long long* bar, unsigned parity) {
  const unsigned a = smem_u32(bar);
  unsigned done;
  for (unsigned spins = 0;; ++spins) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
    if (done) return;
    if (spins > (1u << 28)) __trap();
  }
}

// one thread: b words of src into `dst` of the cluster's CTA `rank` (the
// same offset there), then one arrive on that CTA's mbarrier `bar`
// (release at cluster scope, after the stores)
__device__ inline void hz_hand(const float* src, float* dst,
                               unsigned long long* bar, int b, int rank) {
  float* rd = cg::this_cluster().map_shared_rank(dst, (unsigned)rank);
  for (int j = 0; j < b; ++j) rd[j] = src[j];
  unsigned rb;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(rb) : "r"(smem_u32(bar)), "r"(rank));
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];"
               ::"r"(rb) : "memory");
}

// warp 0, lanes < b: the carry into a window, composed over the windows
// before it (forward: j = 0 … c−1, Π at window j's last stage, each
// window's published y⁰) or after it (backward: j = C−1 … c+1, Ψ at its
// first stage, its published x⁰): carry = M_j·carry + v_j from zero, as
// _solve_K_windowed composes them; into `out`. The maps are staged (cm:
// window j's Π at block j, its Ψ at block C + j), and the peers' vectors
// are copied into vb over DSMEM, one word a lane, before the chain starts
// (one round trip, not one a step)
template <int BMAX>
__device__ inline void hz_carry(float* out, const float* cm, float* vb,
                                const float* pub, int C, int c, int b,
                                int lane, bool forward) {
  cg::cluster_group cl = cg::this_cluster();
  const bool row = lane < b;
  const int steps = forward ? c : C - 1 - c;
  for (int e = lane; e < steps * b; e += 32) {
    const int t = e / b;
    vb[e] = cl.map_shared_rank(pub, (unsigned)(forward ? t : C - 1 - t))
                [e - t * b];
  }
  __syncwarp();
  float cv = 0.0f;
  for (int t = 0; t < steps; ++t) {
    const int j = forward ? t : C - 1 - t;
    const float* M = cm + (size_t)(forward ? j : C + j) * b * b +
                     (row ? lane * b : 0);
    float acc = 0.0f;
#pragma unroll
    for (int l = 0; l < BMAX; ++l) {
      const float w = __shfl_sync(kFull, cv, l);
      if (row && l < b) acc = fmaf(M[l], w, acc);
    }
    cv = row ? acc + vb[t * b + lane] : 0.0f;
  }
  if (row) out[lane] = cv;
}

// every thread of the CTA: v_k += maps_k·carry over the window's n stages
// (v (n, b) in shared memory, maps from the window's first stage s)
__device__ inline void hz_correct(float* v, const float* maps,
                                  const float* carry, int s, int n, int b,
                                  int tid, int T) {
  for (int e = tid; e < n * b; e += T) {
    const int kl = e / b;
    const float* M = maps + ((size_t)(s + kl) * b + (e - kl * b)) * b;
    float acc = 0.0f;
    for (int l = 0; l < b; ++l) acc = fmaf(__ldg(M + l), carry[l], acc);
    v[e] = v[e] + acc;
  }
}

template <int BMAX, int B0, bool STAGED>
__global__ void __launch_bounds__(BMAX <= 8 ? 512 : 256)
sw_admm_horizon_kernel(const PhcSwAdmmArgs a, int tps, HorizonArgs h) {
  extern __shared__ __align__(16) float smem[];
  const int N = a.N, b = a.b, m = a.m, nb = a.n_blk, C = h.C;
  const int tid = threadIdx.x, T = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int G = T / tps;                        // stages a round
  const int g = tid / tps, jl = tid - g * tps;  // group, lane in the group
  constexpr int NB = B0 ? B0 : BMAX;
  cg::cluster_group cl = cg::this_cluster();
  const int c = (int)cl.block_rank();           // this CTA's window
  const size_t p = blockIdx.x / C;
  const int s0 = hz_lo(N, C, c), n = hz_lo(N, C, c + 1) - s0;
  const int np = c ? s0 - hz_lo(N, C, c - 1) : 0;   // the window before
  const HorizonLayout lay = horizon_layout((N + C - 1) / C, b, m, STAGED,
                                           BMAX, C);
  unsigned long long* bar =                     // [0] y in, [1] x in
      reinterpret_cast<unsigned long long*>(smem + lay.bar);
  float* zs = smem + lay.z;
  float* ysc = smem + lay.y;
  float* ls = smem + lay.l;
  float* us = smem + lay.u;
  float* tb = smem + lay.t;
  float* mb = smem + lay.mb;
  float* xb = smem + lay.xb;
  float* xh = smem + lay.xh;
  float* yin = smem + lay.yin;
  float* xin = smem + lay.xin;
  float* py = smem + lay.py;
  float* px = smem + lay.px;
  const int nw = (N + C - 1) / C;

  // ---- constants into shared memory, once per launch ----
  const size_t fo = (size_t)s0 * b * b;         // the window's factors
  const float* L = a.L + fo;
  const float* U = a.U + fo;
  const float* Cf = a.C + fo;
  if (STAGED) {
    copy_in(smem + lay.L, L, n * b * b, tid, T);
    copy_in(smem + lay.U, U, n * b * b, tid, T);
    copy_in(smem + lay.C, Cf, n * b * b, tid, T);
    L = smem + lay.L;
    U = smem + lay.U;
    Cf = smem + lay.C;
  }
  float* J = smem + lay.J;
  float* Mc = smem + lay.Mc;
  for (int e = tid; e < m * BMAX; e += T) {
    const int i = e / BMAX, cc = e - i * BMAX;
    J[e] = cc < b ? __ldg(a.J + i * b + cc) : 0.0f;
    Mc[e] = cc < b ? __ldg(a.Mc + i * b + cc) : 0.0f;
  }
  const float* tie = a.tie;
  const int* blk = a.blk;
  float* cm = smem + lay.cm;                    // the carries' maps
  float* vb = smem + lay.vb;                    // and the peers' vectors
  if (h.parallel)
    for (int e = tid; e < 2 * C * b * b; e += T) {
      const int q = e / (b * b), j = q % C;
      const int k = q < C ? hz_lo(N, C, j + 1) - 1 : hz_lo(N, C, j);
      cm[e] = __ldg((q < C ? h.Pi : h.Psi) + (size_t)k * b * b +
                    (e - q * b * b));
    }

  // ---- the warm state of the window ----
  const float* rho_t = a.rows;
  const float* lin_t = rho_t + (size_t)m * N;
  const float* quad_t = lin_t + (size_t)m * N;
  const float* qp = a.q + p * N * b;
  for (int e = tid; e < n * b; e += T) {
    xb[e] = __ldg(a.x0 + (p * N + s0) * b + e);
    mb[e] = 0.0f;
  }
  for (int kl = g; kl < n; kl += G) {
    const size_t o = (p * N + s0 + kl) * m;
    for (int i = jl; i < m; i += tps) {
      zs[i * nw + kl] = __ldg(a.z0 + o + i);
      ysc[i * nw + kl] = __ldg(a.y0 + o + i);
      ls[i * nw + kl] = __ldg(a.l + o + i);
      us[i * nw + kl] = __ldg(a.u + o + i);
    }
  }
  if (tid == 0) {
    for (int q = 0; q < 2; ++q)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   ::"r"(smem_u32(bar + q)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // every CTA of the cluster running, its mb zeroed and its barriers set,
  // before a peer writes into it
  cl.sync();
  // stage s0's M part goes to the window before, at its last stage
  float* mb_prev = c ? cl.map_shared_rank(mb, (unsigned)(c - 1)) +
                           (size_t)(np - 1) * b
                     : nullptr;

  // ---- t of the warm state (as the global variant's) ----
  for (int k0 = 0; k0 < n; k0 += G) {
    const int kl = k0 + g, k = s0 + kl;
    const bool on = kl < n;
    float xk[BMAX], acc[BMAX], mm[BMAX], jr[BMAX], mr[BMAX];
#pragma unroll
    for (int cc = 0; cc < BMAX; ++cc) acc[cc] = mm[cc] = 0.0f;
    if (on) {
#pragma unroll
      for (int cc = 0; cc < BMAX; ++cc) xk[cc] = cc < b ? xb[kl * b + cc] : 0.0f;
      if (jl == 0) {
#pragma unroll
        for (int cc = 0; cc < BMAX; ++cc)
          if (cc < b) acc[cc] = a.sigma * xk[cc] - __ldg(qp + k * b + cc);
      }
      for (int i = jl; i < m; i += tps) {
        load_row<BMAX>(jr, J + i * BMAX);
        load_row<BMAX>(mr, Mc + i * BMAX);
        const float w =
            __ldg(rho_t + i * N + k) * zs[i * nw + kl] - ysc[i * nw + kl];
        row_transpose<BMAX, NB>(acc, mm, jr, mr, w, k, i, tie, blk, nb,
                                a.blk0);
      }
    }
    group_sum<BMAX>(acc, tps);
    group_sum<BMAX>(mm, tps);
    if (on && jl == 0) {
      float* mo = kl ? mb + (kl - 1) * b : mb_prev;
#pragma unroll
      for (int cc = 0; cc < BMAX; ++cc) {
        if (cc < b) {
          tb[kl * b + cc] = acc[cc];
          if (k >= 1) mo[cc] = mm[cc];
        }
      }
    }
  }
  cl.sync();

  for (int it = 0; it < a.iters; ++it) {
    const bool last = it == a.iters - 1;
    const unsigned par = (unsigned)it & 1u;     // the handoffs' phase
    // ---- x = K⁻¹t over the windows ----
    if (!h.parallel) {
      if (warp == 0) {
        if (c > 0) hz_wait(bar, par);
        window_forward<BMAX, B0>(tb, mb, L, n, b, lane, c > 0 ? yin : nullptr);
        __syncwarp();
        if (c < C - 1 && lane == 0) hz_hand(tb + (n - 1) * b, yin, bar, b, c + 1);
        if (c < C - 1) hz_wait(bar + 1, par);
        window_backward<BMAX, B0>(tb, U, Cf, xb, n, b, lane,
                                  c < C - 1 ? xin : nullptr);
        __syncwarp();
        if (c > 0 && lane == 0) hz_hand(xb, xin, bar + 1, b, c - 1);
      }
    } else {
      if (warp == 0) {
        window_forward<BMAX, B0>(tb, mb, L, n, b, lane, nullptr);
        __syncwarp();
        if (lane < b) py[lane] = tb[(n - 1) * b + lane];
      }
      cl.sync();                        // every window's y⁰ published
      if (warp == 0) hz_carry<BMAX>(yin, cm, vb, py, C, c, b, lane, true);
      __syncthreads();
      if (c > 0) hz_correct(tb, h.Pi, yin, s0, n, b, tid, T);
      __syncthreads();
      if (warp == 0) {
        window_backward<BMAX, B0>(tb, U, Cf, xb, n, b, lane, nullptr);
        __syncwarp();
        if (lane < b) px[lane] = xb[lane];
      }
      cl.sync();                        // every window's x⁰ published
      if (warp == 0) hz_carry<BMAX>(xin, cm, vb, px, C, c, b, lane, false);
      __syncthreads();
      if (c < C - 1) hz_correct(xb, h.Psi, xin, s0, n, b, tid, T);
      __syncthreads();
    }
    // x_{e−1} into the next window's halo
    if (c < C - 1 && warp == 0 && lane < b)
      cl.map_shared_rank(xh, (unsigned)(c + 1))[lane] = xb[(n - 1) * b + lane];
    cl.sync();                          // x and the halos complete

    // ---- the window's rows: zr, z, y and the new w into t and mb ----
    for (int k0 = 0; k0 < n; k0 += G) {
      const int kl = k0 + g, k = s0 + kl;
      const bool on = kl < n;
      float xk[BMAX], xm[BMAX], acc[BMAX], mm[BMAX], jr[BMAX], mr[BMAX];
#pragma unroll
      for (int cc = 0; cc < BMAX; ++cc) acc[cc] = mm[cc] = 0.0f;
      if (on) {
        const float* xmp = kl ? xb + (kl - 1) * b : xh;
#pragma unroll
        for (int cc = 0; cc < BMAX; ++cc) {
          xk[cc] = cc < b ? xb[kl * b + cc] : 0.0f;
          xm[cc] = cc < b && k >= 1 ? xmp[cc] : 0.0f;
        }
        if (jl == 0) {
#pragma unroll
          for (int cc = 0; cc < BMAX; ++cc)
            if (cc < b) acc[cc] = a.sigma * xk[cc] - __ldg(qp + k * b + cc);
        }
        for (int i = jl; i < m; i += tps) {
          load_row<BMAX>(jr, J + i * BMAX);
          load_row<BMAX>(mr, Mc + i * BMAX);
          // J ξ_k and M_k ξ_{k−1} in two chains
          float ax = 0.0f, am = 0.0f;
#pragma unroll
          for (int cc = 0; cc < NB; ++cc) ax = fmaf(jr[cc], xk[cc], ax);
          if (k >= 1) {
#pragma unroll
            for (int cc = 0; cc < NB; ++cc) am = fmaf(mr[cc], xm[cc], am);
            const int jb = i - a.blk0;
            if (jb >= 0 && jb < nb) {
              const int cj = blk[jb];
              float xv = 0.0f;
#pragma unroll
              for (int cc = 0; cc < BMAX; ++cc)
                if (cc == cj) xv = xm[cc];
              am = fmaf(-tie[k * nb + jb], xv, am);
            }
          }
          const int o = i * nw + kl;
          const int og = i * N + k;
          const float z = zs[o], y = ysc[o], rho = __ldg(rho_t + og);
          const float lo = ls[o], hi = us[o];
          const float lin = __ldg(lin_t + og), quad = __ldg(quad_t + og);
          const float zr = a.alpha * (ax + am) + (1.0f - a.alpha) * z;
          const float sv = zr + y / rho;
          const float tt = (rho * (sv - hi) - lin) / (rho + 2.0f * quad);
          const float zsoft = sv > hi ? hi + fmaxf(tt, 0.0f) : fmaxf(sv, lo);
          const float zbox = fminf(fmaxf(sv, lo), hi);
          const float zn = (lin > 0.0f || quad > 0.0f) ? zsoft : zbox;
          const float yn = y + rho * (zr - zn);
          if (last) a.dy[(p * N + k) * m + i] = yn - y;
          zs[o] = zn;
          ysc[o] = yn;
          row_transpose<BMAX, NB>(acc, mm, jr, mr, rho * zn - yn, k, i, tie,
                                  blk, nb, a.blk0);
        }
      }
      group_sum<BMAX>(acc, tps);
      group_sum<BMAX>(mm, tps);
      if (on && jl == 0) {
        float* mo = kl ? mb + (kl - 1) * b : mb_prev;
#pragma unroll
        for (int cc = 0; cc < BMAX; ++cc) {
          if (cc < b) {
            tb[kl * b + cc] = acc[cc];
            if (k >= 1) mo[cc] = mm[cc];
          }
        }
      }
    }
    cl.sync();                          // t and the peers' M parts complete
  }

  // ---- out: x, z, y (and dy when no iteration ran) ----
  for (int kl = g; kl < n; kl += G) {
    const int k = s0 + kl;
    if (jl == 0)
      for (int cc = 0; cc < b; ++cc)
        a.x[(p * N + k) * b + cc] = xb[kl * b + cc];
    const size_t o = (p * N + k) * m;
    for (int i = jl; i < m; i += tps) {
      a.z[o + i] = zs[i * nw + kl];
      a.y[o + i] = ysc[i * nw + kl];
      if (a.iters == 0) a.dy[o + i] = 0.0f;
    }
  }
}

size_t horizon_smem_bytes(int N, int b, int m, int staged, int bmax, int C) {
  return sizeof(float) *
         horizon_layout((N + C - 1) / C, b, m, staged, bmax, C).total;
}

// P problems, one cluster of h.C CTAs each; or, if `max_clusters`, how
// many such clusters the card holds at once
template <int BMAX, int B0, bool STAGED>
int launch_horizon(const PhcSwAdmmArgs& a, const HorizonArgs& h, int warps,
                   int tps, cudaStream_t stream, int* max_clusters) {
  auto kernel = sw_admm_horizon_kernel<BMAX, B0, STAGED>;
  const size_t bytes = horizon_smem_bytes(a.N, a.b, a.m, STAGED, BMAX, h.C);
  if (bytes > 48 * 1024) {
    const int rc = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (rc) return rc;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(a.P * h.C), 1, 1);
  cfg.blockDim = dim3((unsigned)(32 * warps), 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)h.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (max_clusters) {
    cfg.gridDim = dim3((unsigned)h.C, 1, 1);
    return (int)cudaOccupancyMaxActiveClusters(max_clusters,
                                               (const void*)kernel, &cfg);
  }
  const int rc = (int)cudaLaunchKernelEx(&cfg, kernel, a, tps, h);
  return rc ? rc : (int)cudaGetLastError();
}

// the horizon variant's shapes: one problem a cluster of 1, 2, 4 or 8
// CTAs (portable) with no group mean and no extra rows, on the register
// path's bounds, and the window maps with the parallel sweep
int horizon_dispatch(const PhcSwAdmmArgs* a, const HorizonArgs& h, int warps,
                     int tps, int staged, int bmax, cudaStream_t s,
                     int* maxc) {
  if (!admm_args_ok(a, warps, tps, staged, bmax) || a->S != 1 || a->mean ||
      a->n_ext || a->ext || bmax > 16 ||
      !(h.C == 1 || h.C == 2 || h.C == 4 || h.C == 8) || h.C > a->N ||
      (h.parallel && !maxc && (!h.Pi || !h.Psi)))
    return (int)cudaErrorInvalidValue;
  if (bmax == 8 && a->b == 5)
    return staged ? launch_horizon<8, 5, true>(*a, h, warps, tps, s, maxc)
                  : launch_horizon<8, 5, false>(*a, h, warps, tps, s, maxc);
  if (bmax == 8)
    return staged ? launch_horizon<8, 0, true>(*a, h, warps, tps, s, maxc)
                  : launch_horizon<8, 0, false>(*a, h, warps, tps, s, maxc);
  return staged ? launch_horizon<16, 0, true>(*a, h, warps, tps, s, maxc)
                : launch_horizon<16, 0, false>(*a, h, warps, tps, s, maxc);
}
#endif

}  // namespace

extern "C" {

#if PHC_SW_PART == 0 && !PHC_SW_PAR
// dynamic shared memory of one block: the warps' r/y buffers (and rings),
// and the three factor arrays when staged (each array padded to a
// multiple of 4 words; above bmax 16 N packed blocks, each padded)
int phc_sw_smem_bytes(int N, int b, int warps, int staged, int bmax,
                      int ring) {
  return (int)smem_bytes(N, b, warps, staged, bmax, ring);
}

// x = K⁻¹ r for P problems; bmax = the compiled bound on b (8, 16, 32, 64
// or 128, at least b); above 16 the factors packed (wide_block) and, not
// staged, read through a ring of `ring` blocks a warp (ring_ok)
int phc_sw_solve_k(const float* r, const float* L, const float* U,
                   const float* C, float* x, int P, int N, int b, int warps,
                   int staged, int bmax, int ring, void* stream) {
  if (P < 1 || N < 1 || b < 1 || b > bmax || warps < 1 ||
      warps > kMaxWarps || !ring_ok(bmax, staged, ring))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (bmax) {
    case 8: return launch_b<8>(r, L, U, C, x, P, N, b, warps, staged, 0, s);
    case 16: return launch_b<16>(r, L, U, C, x, P, N, b, warps, staged, 0,
                                 s);
    case 32: return launch_b<32>(r, L, U, C, x, P, N, b, warps, staged, ring,
                                 s);
    case 64: return launch_b<64>(r, L, U, C, x, P, N, b, warps, staged, ring,
                                 s);
    case 128: return launch_b<128>(r, L, U, C, x, P, N, b, warps, staged,
                                   ring, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
#endif

// dynamic shared memory of one K5 CTA (admm_layout)
int phc_sw_admm_smem_bytes(int N, int b, int m, int S, int n_blk, int n_ext,
                           int n_cons, int mean, int warps, int staged,
                           int bmax, int ext, int ring, int windows) {
  return (int)admm_smem_bytes(N, b, m, S, n_blk, n_ext, n_cons, mean, warps,
                              staged, windows, bmax, ext, ring);
}

// K5: a->iters stagewise ADMM iterations for a->P problems in one launch,
// one CTA of 32·warps threads a problem, a stage's rows over the tps lanes
// of a group (a power of 2 up to 32), clusters of a->S CTAs with a group
// mean; bmax = the compiled bound on b (8, 16, 32, 64 or 128, the part's)
int phc_sw_admm(const PhcSwAdmmArgs* a, int warps, int tps, int staged,
                int bmax, void* stream) {
  if (!admm_args_ok(a, warps, tps, staged, bmax) || a->S > 8)
    return (int)cudaErrorInvalidValue;
  return admm_dispatch(a, warps, tps, staged, bmax, (cudaStream_t)stream);
}

// dynamic shared memory of one FLEX CTA (flex_layout; lists the member
// lists' words it stages, S the group's scenarios, windows the parallel
// sweep's), and the words of device memory a problem's scratch takes;
// warps = the CTA's
int phc_sw_admm_flex_smem_bytes(int N, int b, int m, int n_blk, int n_ext,
                                int n_cons, int mean, int warps, int staged,
                                int bmax, int spc, int place, int ext,
                                int ring, int lists, int S, int windows) {
  return (int)(sizeof(float) *
               flex_layout(N, b, m, n_blk, n_ext, n_cons, mean, warps / spc,
                           staged, bmax, spc, place, ext, ring,
                           mean ? lists : 0, S, windows).total);
}

long long phc_sw_admm_flex_scratch_words(int N, int b, int m, int n_cons,
                                         int mean, int place, int bmax) {
  return (long long)flex_layout(N, b, m, 0, 0, n_cons, mean, 1, 0, bmax, 1,
                                place, 0, 0, 0, 1, 0).gwords;
}

// K5's FLEX variants (grouped, global state): as phc_sw_admm, with spc
// scenarios a CTA, groups of a->S over clusters of `cluster` CTAs, arrays
// placed by `place`, `scratch` the device memory of place ≥ 1, `members`
// the group mean's member lists (lwords of their words staged, 0: read
// from device memory)
int phc_sw_admm_flex(const PhcSwAdmmArgs* a, int warps, int tps, int staged,
                     int bmax, int spc, int cluster, int place,
                     float* scratch, const int* members, int lwords,
                     void* stream) {
  const AdmmFlex fx = {spc, cluster, place, scratch, members, lwords};
  if (!admm_args_ok(a, warps, tps, staged, bmax) || !flex_ok(a, warps, fx))
    return (int)cudaErrorInvalidValue;
  return flex_dispatch(a, warps, tps, staged, bmax, fx, (cudaStream_t)stream,
                       nullptr);
}

// clusters of a FLEX plan the card holds at once, or −(the CUDA error)
int phc_sw_admm_max_clusters(const PhcSwAdmmArgs* a, int warps, int tps,
                             int staged, int bmax, int spc, int cluster,
                             int place, int lwords) {
  float dummy = 0.0f;
  const int none = 0;
  const AdmmFlex fx = {spc, cluster, place, &dummy, &none, lwords};
  if (!admm_args_ok(a, warps, tps, staged, bmax) || !flex_ok(a, warps, fx))
    return -(int)cudaErrorInvalidValue;
  int n = 0;
  const int rc = flex_dispatch(a, warps, tps, staged, bmax, fx, nullptr, &n);
  return rc ? -rc : n;
}

#if PHC_SW_PART == 3
// dynamic shared memory of one CTA of the horizon variant (horizon_layout)
int phc_sw_admm_horizon_smem_bytes(int N, int b, int m, int staged, int bmax,
                                   int C) {
  return (int)horizon_smem_bytes(N, b, m, staged, bmax, C);
}

// K5's horizon variant: a->iters iterations for a->P problems (S = 1, no
// extra rows), one cluster of C CTAs a problem, CTA c the window of stages
// [c·N/C, (c+1)·N/C); the sequential sweep, or with `parallel` the
// windowed one on the window maps Pi and Psi ((N, b, b) each)
int phc_sw_admm_horizon(const PhcSwAdmmArgs* a, const float* Pi,
                        const float* Psi, int warps, int tps, int staged,
                        int bmax, int C, int parallel, void* stream) {
  const HorizonArgs h = {Pi, Psi, C, parallel};
  return horizon_dispatch(a, h, warps, tps, staged, bmax,
                          (cudaStream_t)stream, nullptr);
}

// clusters of a horizon plan the card holds at once, or −(the CUDA error)
int phc_sw_admm_horizon_max_clusters(const PhcSwAdmmArgs* a, int warps,
                                     int tps, int staged, int bmax, int C) {
  const HorizonArgs h = {nullptr, nullptr, C, 0};
  int n = 0;
  const int rc = horizon_dispatch(a, h, warps, tps, staged, bmax, nullptr,
                                  &n);
  return rc ? -rc : n;
}
#endif

const char* phc_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

// K6: the stagewise sweep x = K⁻¹r at any block size b and any horizon N,
// sequential or over C windows, for Hopper (sm_90a), with a plain C
// interface loaded through ctypes by pyhybridcontrol_tpu_torch/ops/_build.py.
//
// What it replaces. No TPU kernel stands behind it. The reference solves
// K ξ = r in every stagewise ADMM iteration with two lax.scan sweeps
// (_solve_K, pyhybridcontrol_tpu/ops/stagewise.py:586) or, with
// parallel_sweeps=True, with log-depth prefixes over affine maps
// (_solve_K_assoc, :632), both plain XLA that take any b. On the card the
// port runs the torch ADMM loop (_admm_iterations) around this kernel
// wherever K5, the fused loop, has no instantiation (b above 128, a tree
// whose group would leave a scenario under a warp) and for the group mean
// over ranks; K4 takes the sequential sweep where one block holds a
// problem's r/y, this kernel the rest. Its plain versions are _solve_K
// (C = 1) and _solve_K_windowed (C > 1) in
// pyhybridcontrol_tpu_torch/ops/stagewise.py.
//
// What it computes, for each of P problems, from the block LU factors
// (L, U⁻¹, C), each (N, b, b) and shared by every problem:
//   forward   y_k = r_k − L_k y_{k−1}            k = 0 … N−1, y_{−1} = 0
//   backward  x_k = U⁻¹_k y_k − C_k x_{k+1}       k = N−1 … 0, x_N = 0
// With C windows (stage bounds w_c = c·N div C, as horizon_windows gives
// them) the algorithm of K5's parallel sweep: every window sweeps forward
// from a zero carry (y⁰); the carries compose once, along the chain of
// windows (carry_{c+1} = Π_{e_c−1}·carry_c + y⁰_{e_c−1} from carry_0 = 0,
// window 0 first); every stage is corrected, y_k = y⁰_k + Π_k·carry; every
// window sweeps backward from a zero carry (x⁰); the carries compose once
// backward (carry_{c−1} = Ψ_{s_c}·carry_c + x⁰_{s_c}, the last window
// first); x_k = x⁰_k + Ψ_k·carry. Π and Ψ are (N, b, b)
// (ops/stagewise.window_maps). Every output row is summed in fp32 FMAs in
// column order (j = 0 … b−1) from zero, then subtracted from r_k
// (forward) or from U⁻¹_k y_k (backward), or added to y⁰ or x⁰ (the
// corrections), as the plain version's addmm computes it; no TF32. The
// first stage of a sweep and the first carry step multiply a zero vector:
// they are not computed, and r − (+0), x − (+0) and (+0) + v are kept as
// they round (r, x, and v with −0 made +0), so that the outputs are those
// of the first K6 bit for bit.
//
// What bounds it on the H100. Per problem the sweeps are 2·N dependent
// stages, each a b-row matrix-vector product on the previous stage's
// vector, b FMAs deep; the bytes are r and x once and the factors once
// (3·N·b² words, 7.4 MB at N = 24, b = 160, shared by every problem). The
// chain bounds it: 2·N stages of b dependent FMAs and one exchange, or
// with C windows 2·⌈N/C⌉ stages plus 2·(C−1) carry steps and the
// corrections off the chain.
//
// The design. One algorithm in two kernels, by b (the plan,
// ops/cuda_stagewise.plan_sweep_any, picks from the shapes alone):
//
//  - k6_wide (b above 32, or a horizon whose factors do not fit one CTA):
//    a thread-block cluster of CL CTAs (the fewest, a power of 2 up to 16,
//    that leave a CTA at most 16 rows; 16 is the non-portable size) takes
//    a group of G problems and one window; CTA q owns rows
//    [q·R, q·R + R) of every stage, R = ⌈b/CL⌉, one thread a row of one
//    problem. Its row slices of the factors and maps are read from a
//    packing of row slices (ops/cuda_stagewise.pack_slices: array, stage,
//    CTA, R rows of a stride RS ≥ b words whose quarter is odd, so that
//    eight rows' 16-byte reads cover the 32 banks), so that a slice is one
//    bulk copy. "ring": a ring of D slices in shared memory (a step reads
//    one or two), filled by bulk copies (TMA, completion on the slot's
//    mbarrier) that lane 0 of a producer warp issues in the order the
//    steps read them, D slices ahead, as soon as a step frees a slot: no
//    factor word is loaded on the chain, and the factors are read once a
//    cluster, not once a problem. "l2": where not two slices fit beside
//    the vectors (b above ~660), the same loop reads its slices from
//    device memory (16-byte loads through the read-only path). Each row
//    product loads the next 8 columns' operands while the FMAs of these 8
//    run; the forward step's two products (L_k y_{k−1} and U⁻¹_{k−1}
//    y_{k−1}) read the vector once. The previous stage's vector of every
//    problem of the group lies in each CTA's shared memory (a problem's
//    vector every odd_quads(b) words), double-buffered; each thread sends
//    its row of the new vector to every CTA of the cluster with st.async,
//    whose bytes complete on the receiver's mbarrier, so a stage ends on
//    a block barrier and a wait for the whole vector, with no cluster
//    barrier. U⁻¹_k y_k is taken in the forward sweep, one stage behind
//    the chain, and kept in x's buffer by the thread that owns its row, so
//    that the backward sweep is one chain (C_k x_{k+1}) and no CTA reads y
//    of rows it does not own. Over windows a cluster takes one window of a
//    group: window 0's cluster composes the forward carries after its own
//    sweep, the last window's the backward ones, each carry once; a window
//    waits for its carry, corrects its stages (with U⁻¹y taken one stage
//    behind) and sweeps backward. The windows' last y⁰ and first x⁰ and
//    the carries pass through a workspace in device memory the wrapper
//    keeps per shape ((4, P, C, b) words and the counters); where every
//    cluster of the launch is resident on the card at once
//    (cudaOccupancyMaxActiveClusters, checked before the launch) the sweep
//    is one launch, each hand-over a release/acquire counter in device
//    memory (epoch-stamped, so never reset); the plan makes a group as
//    large as puts the clusters in one wave where the ring still fits.
//    Where they are not all resident (P = 64 at b = 256 over 5 windows:
//    64 problems' vectors leave no room for a ring, so 40 clusters of 16
//    CTAs), five launches on the caller's stream, one a phase (forward
//    sweeps; forward carries; corrections and backward sweeps; backward
//    carries; corrections).
//  - k6_narrow (b up to 32, the whole horizon's factors, and over windows
//    its maps, in one CTA's shared memory): the arrays staged by one bulk
//    copy each, the CTA's r and its intermediate y⁰, U⁻¹y and x⁰ in
//    shared memory too; a slot of L lanes (b rounded up to a power of 2)
//    one problem and window, several slots a warp; a stage ends on a
//    __syncwarp of the slot's lanes, the slot's vector in shared memory.
//    Over windows every window of a problem lies in one CTA: the phases
//    are separated by block barriers, window 0's slot composes the forward
//    carries and the last window's the backward ones, through shared
//    memory.
//
// What holds a k6_wide stage back on the H100 (the stamps below; PERF.md
// §7): each thread's b-deep FMA chain with its operands from shared
// memory, about three times the FMAs' own latency, then the exchange (the
// sends and the wait for the last CTA's rows); the ring's wait is a few
// hundred cycles of bookkeeping once every slice has landed.
//
//  Stamps: with a stamps buffer, thread 0 of every CTA of k6_wide adds the
//  cycles of each step it waits for its slot, runs its FMAs, sends its row
//  (and stores its outputs) and waits at the step's end for the CTA and
//  the whole vector (five counters, the last the steps).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 256;
constexpr int kPhases = 6;
// the multi-launch form's launches: the phases of each (bit masks)
constexpr int kLaunchPhases[5] = {1, 2, 4 | 8, 16, 32};
// counters a (group, window) in device memory, each CTA of a cluster adds 1
enum { kFwdDone = 0, kFwdCarry = 1, kBwdDone = 2, kBwdCarry = 3 };

__host__ __device__ inline size_t pad4(size_t n) { return (n + 3) / 4 * 4; }

// words of one packed b×b block (column-major, padded to a multiple of 4)
__host__ __device__ inline size_t block_words(int b) {
  return pad4((size_t)b * b);
}

// n rounded up to a multiple of 4 words whose quarter is odd
__host__ __device__ inline size_t odd_quads(size_t n) {
  const size_t w = pad4(n);
  return (w / 4) % 2 ? w : w + 4;
}

// window c's stages [s, e) of a horizon of N in C windows (hz_lo)
__host__ __device__ inline void window(int N, int C, int c, int& s, int& e) {
  s = (int)((long long)c * N / C);
  e = (int)((long long)(c + 1) * N / C);
}

// words of a k6_wide CTA's shared memory: D + 2 mbarriers (the ring's,
// the exchange's), the ring of D slices (R·RS words each), three vector
// buffers (two for the exchange, one for a carry) of G problems' vectors
// (odd_quads(b) words each)
__host__ __device__ inline size_t wide_smem_words(int b, int R, int RS, int G,
                                                  int D) {
  return pad4(2 * ((size_t)D + 2)) + (size_t)D * R * RS +
         3 * (size_t)G * odd_quads(b);
}

// words of a k6_narrow CTA's shared memory: its mbarrier, the staged
// arrays (L, U⁻¹, C and over windows Π, Ψ), its problems' r and x (G·N·b
// words each) and per slot four L-word vectors (the two of the exchange,
// the window's end, its carry; a slot's stride 4·L + 1 words, so that the
// slots of a warp read their vectors from different banks)
__host__ __device__ inline size_t narrow_smem_words(int N, int b, int C,
                                                    int L, int G) {
  return 4 + (size_t)(C > 1 ? 5 : 3) * N * block_words(b) +
         2 * pad4((size_t)G * N * b) + (size_t)G * C * (4 * L + 1);
}

// ---- PTX: mbarriers, bulk copies, counters in device memory ----------------

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// one arrival, announcing `bytes` to come on the mbarrier's phase
__device__ __forceinline__ void mbar_arrive(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// every calling thread waits for phase `parity` of the mbarrier to
// complete; a copy that never lands traps (a launch error) rather than
// hang the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned a = smem_u32(bar);
  unsigned done;
  for (unsigned spins = 0;; ++spins) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
    if (done) return;
    if (spins > (1u << 28)) __trap();
  }
}

// thread 0: wait until the counter reaches `target` (acquire at gpu
// scope); a hand-over that never comes traps
__device__ __forceinline__ void flag_wait(const unsigned* f,
                                          unsigned target) {
  for (unsigned spins = 0;; ++spins) {
    unsigned v;
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                 : "=r"(v) : "l"(f) : "memory");
    if ((int)(v - target) >= 0) return;
    if (spins > (1u << 24)) __trap();
    __nanosleep(64);
  }
}

// thread 0, after a barrier that every writing thread of the CTA passed:
// the CTA's writes released at gpu scope, then the counter advanced
__device__ __forceinline__ void flag_post(unsigned* f) {
  __threadfence();
  atomicAdd(f, 1u);
}

// ---- the row products ------------------------------------------------------

// 16 and 4 bytes from shared memory (ld.shared: the operands' address
// space is not left to the compiler to infer through the ring's pointers;
// volatile, so that the loads stay where the pipeline issues them)
__device__ __forceinline__ float4 lds4(const float* p) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(smem_u32(p)));
  return v;
}

__device__ __forceinline__ float lds1(const float* p) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(smem_u32(p)));
  return v;
}

template <bool L2>
__device__ __forceinline__ float4 ld4(const float* p) {
  if (L2) return __ldg(reinterpret_cast<const float4*>(p));
  return lds4(p);
}

template <bool L2>
__device__ __forceinline__ float ld1(const float* p) {
  return L2 ? __ldg(p) : lds1(p);
}

__device__ __forceinline__ float comp(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// the operands of 8 columns of one or two row products (y: of a second
// vector)
template <bool TWOV>
struct Cols8 {
  float4 a[2], c[2], x[2], y[TWOV ? 2 : 1];
};

// SAME: both products read the one vector va (then vb is not read)
template <bool L2, bool TWO, bool SAME>
__device__ __forceinline__ void load8(Cols8<TWO && !SAME>& o, const float* A,
                                      const float* va, const float* B,
                                      const float* vb, int j) {
  o.a[0] = ld4<L2>(A + j);
  o.a[1] = ld4<L2>(A + j + 4);
  if constexpr (TWO) {
    o.c[0] = ld4<L2>(B + j);
    o.c[1] = ld4<L2>(B + j + 4);
  }
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    o.x[m] = lds4(va + j + 4 * m);
    if constexpr (TWO && !SAME) o.y[m] = lds4(vb + j + 4 * m);
  }
}

template <bool TWO, bool SAME>
__device__ __forceinline__ void fma8(const Cols8<TWO && !SAME>& o, float& sa,
                                     float& sb) {
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const float v = comp(o.x[jj / 4], jj % 4);
    sa = fmaf(comp(o.a[jj / 4], jj % 4), v, sa);
    if constexpr (TWO && SAME)
      sb = fmaf(comp(o.c[jj / 4], jj % 4), v, sb);
    else if constexpr (TWO)
      sb = fmaf(comp(o.c[jj / 4], jj % 4), comp(o.y[jj / 4], jj % 4), sb);
  }
}

// sa = Σ_j A[j]·va[j] and, with TWO, sb = Σ_j B[j]·vb[j], j = 0 … b−1 in
// order from zero (A, B one row of a slice, va, vb a problem's vector,
// each 16-byte aligned; SAME: vb is va); the operands of the next 8
// columns are loaded while the FMAs of these 8 run
template <bool L2, bool TWO, bool SAME = false>
__device__ __forceinline__ void dots(const float* A, const float* va,
                                     const float* B, const float* vb, int b,
                                     float& sa, float& sb) {
  sa = sb = 0.0f;
  const int b8 = b & ~7;
  int j = 0;
  if (b8) {
    Cols8<TWO && !SAME> p, q;
    load8<L2, TWO, SAME>(p, A, va, B, vb, 0);
    for (; j + 16 <= b8; j += 16) {
      load8<L2, TWO, SAME>(q, A, va, B, vb, j + 8);
      fma8<TWO, SAME>(p, sa, sb);
      if (j + 16 < b8) load8<L2, TWO, SAME>(p, A, va, B, vb, j + 16);
      fma8<TWO, SAME>(q, sa, sb);
    }
    if (j < b8) {
      fma8<TWO, SAME>(p, sa, sb);
      j += 8;
    }
  }
  for (; j < b; ++j) {
    sa = fmaf(ld1<L2>(A + j), lds1(va + j), sa);
    if (TWO) sb = fmaf(ld1<L2>(B + j), lds1((SAME ? va : vb) + j), sb);
  }
}

// ---- k6_wide ---------------------------------------------------------------

struct WideArgs {
  const float* r;      // (P, N, b)
  float* x;            // (P, N, b): y⁰, U⁻¹y, then x, by stage and row
  const float* F;      // factor slices (3, N, CL, R, RS): L, U⁻¹, C
  const float* M;      // map slices (2, N, CL, R, RS): Π, Ψ (C > 1)
  float* ends;         // (2, P, C, b): each window's last y⁰, first x⁰
  float* carries;      // (2, P, C, b): the carries into each window
  unsigned* flags;     // (groups, C, 4) counters; null: no hand-over waits
  unsigned long long* stamps;  // null, or five cycle counters
  int P, N, b, C, CL, R, RS, G, D;
  unsigned target;     // a counter's value once every CTA of its cluster
                       // advanced it in this launch (epoch · CL)
  int phases;          // bit mask of the phases this launch runs
};

// steps of phase `ph` for the window c of ne stages (0: the CTA does not
// run it): 0 forward sweep (and U⁻¹y one stage behind in window 0), 1 the
// forward carries (window 0), 2 the corrections of y with U⁻¹y one stage
// behind (windows after 0), 3 the backward sweep, 4 the backward carries
// (the last window), 5 the corrections of x (windows before the last)
__device__ __forceinline__ int phase_steps(const WideArgs& a, int ph, int c,
                                           int ne) {
  if (!((a.phases >> ph) & 1)) return 0;
  const int C = a.C;
  switch (ph) {
    case 0: return ne + (c == 0);
    case 1: return C > 1 && c == 0 ? C - 1 : 0;
    case 2: return c > 0 ? ne + 1 : 0;
    case 3: return ne;
    case 4: return C > 1 && c == C - 1 ? C - 1 : 0;
    default: return C > 1 && c < C - 1 ? ne : 0;
  }
}

// the slices step t of phase ph reads (p0, p1; null: none), CTA q's rows
__device__ __forceinline__ void fill_of(const WideArgs& a, int ph, int t,
                                        int c, int s, int e, int q,
                                        const float*& p0, const float*& p1) {
  const size_t slw = (size_t)a.R * a.RS;
  auto at = [&](const float* base, int arr, int k) {
    return base + (((size_t)arr * a.N + k) * a.CL + q) * slw;
  };
  const int ne = e - s;
  int ws, we;
  p0 = p1 = nullptr;
  switch (ph) {
    case 0:
      if (t >= 1 && t < ne) p0 = at(a.F, 0, s + t);
      if (c == 0 && t >= 1) p1 = at(a.F, 1, s + t - 1);
      break;
    case 1:
      if (t >= 1) {
        window(a.N, a.C, t, ws, we);
        p0 = at(a.M, 0, we - 1);
      }
      break;
    case 2:
      if (t < ne) p0 = at(a.M, 0, s + t);
      if (t >= 1) p1 = at(a.F, 1, s + t - 1);
      break;
    case 3:
      if (t >= 1) p0 = at(a.F, 2, e - 1 - t);
      break;
    case 4:
      if (t >= 1) {
        window(a.N, a.C, a.C - 1 - t, ws, we);
        p0 = at(a.M, 1, ws);
      }
      break;
    default:
      p0 = at(a.M, 1, s + t);
  }
}

// The ring's producer (lane 0 of the CTA's last warp, which has no rows of
// its own): the slices of the CTA's steps in order, each into slot
// `issued` mod D on that slot's mbarrier, until D slices are in flight or
// landed and unread (`used`: the slices the CTA's steps have read so far).
// A slot is refilled only after the step that read it ended on the CTA's
// barrier, so one copy at most is in flight a slot, and the parity to wait
// for is (slice div D) mod 2. The producer refills while the other warps
// run the next step.
struct RingCursor {
  int ph, t, sub, issued;
};

__device__ void ring_fill(const WideArgs& a, RingCursor& rc, int used, int c,
                          int s, int e, int q, float* ring, uint64_t* bar) {
  const size_t slw = (size_t)a.R * a.RS;
  const unsigned bytes = (unsigned)(sizeof(float) * slw);
  while (rc.issued < used + a.D && rc.ph < kPhases) {
    if (rc.t >= phase_steps(a, rc.ph, c, e - s)) {
      ++rc.ph;
      rc.t = rc.sub = 0;
      continue;
    }
    const float *p0, *p1;
    fill_of(a, rc.ph, rc.t, c, s, e, q, p0, p1);
    const float* src = rc.sub == 0   ? (p0 ? p0 : p1)
                       : rc.sub == 1 ? (p0 ? p1 : nullptr)
                                     : nullptr;
    if (!src) {
      ++rc.t;
      rc.sub = 0;
      continue;
    }
    uint64_t* bb = bar + rc.issued % a.D;
    mbar_arrive(bb, bytes);
    bulk_copy(ring + (size_t)(rc.issued % a.D) * slw, src, bytes, bb);
    ++rc.issued;
    ++rc.sub;
  }
}

// window c's carry (forward: half 0, backward: half 1) of the group's
// problems into the vector buffer dst (a problem's vector every cs words)
__device__ void load_carry(const WideArgs& a, const float* src, int c, int g0,
                           float* dst, size_t cs) {
  const int b = a.b;
  for (int idx = threadIdx.x; idx < a.G * b; idx += blockDim.x) {
    const int g = idx / b, j = idx % b, p = g0 + g;
    dst[g * cs + j] =
        p < a.P ? __ldcg(src + ((size_t)p * a.C + c) * b + j) : 0.0f;
  }
}

// a float into the shared memory of a CTA of the cluster (address `a`),
// completing its bytes on that CTA's mbarrier (address `bar`)
__device__ __forceinline__ void st_async(unsigned a, float v, unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];" ::"r"(a),
      "r"(__float_as_uint(v)), "r"(bar)
      : "memory");
}

// The exchange (CL > 1). The stages that exchange their vectors are
// counted (xc) across the phases: exchange xc writes buffer xc mod 2 of
// every CTA and completes its bytes on that CTA's mbarrier xc mod 2, for
// which thread 0 announces the whole vector (every CTA's rows) once a
// phase, and every thread waits for phase (xc div 2) mod 2. A CTA sends
// exchange xc only after it received all of exchange xc − 1, which every
// thread of every CTA sent after its last read of buffer xc mod 2: two
// buffers are enough, and no cluster barrier runs inside the sweep.
template <bool RING>
__global__ void __launch_bounds__(kMaxThreads) k6_wide(const WideArgs a) {
  extern __shared__ __align__(16) float sm[];
  constexpr bool L2 = !RING;
  cg::cluster_group cluster = cg::this_cluster();
  const int CL = a.CL, C = a.C, N = a.N, b = a.b, R = a.R, RS = a.RS;
  const int q = (int)cluster.block_rank();
  const int cid = (int)(blockIdx.x / CL), grp = cid / C, c = cid % C;
  int s, e;
  window(N, C, c, s, e);
  const int ne = e - s, g0 = grp * a.G;
  const size_t cs = odd_quads(b), vbw = (size_t)a.G * cs;
  const size_t slw = (size_t)R * RS, PCb = (size_t)a.P * C * b;
  const int r0 = q * R, rq = max(0, min(R, b - r0)), units = a.G * rq;
  const int tid = threadIdx.x, T = blockDim.x;
  const int TC = RING ? T - 32 : T;  // the threads with rows
  const bool producer = RING && tid == TC;
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm);  // the ring's D
  uint64_t* xbar = bar + a.D;                        // the exchange's 2
  float* ring = sm + pad4(2 * ((size_t)a.D + 2));
  float* vec = ring + (RING ? (size_t)a.D * slw : 0);
  unsigned* flg = a.flags ? a.flags + (size_t)grp * C * 4 : nullptr;
  const unsigned xbytes = (unsigned)(sizeof(float) * a.G * b);

  RingCursor cur{0, 0, 0, 0};
  int used = 0, rs = 0;  // the slices read, the slot of the next
  unsigned rp = 0;       // and its parity
  int xc = 0;            // the exchanges so far
  if (tid == 0) {
    for (int i = 0; i < (RING ? a.D : 0) + (CL > 1 ? 2 : 0); ++i)
      mbar_init(bar + (RING ? 0 : a.D) + i);
    mbar_fence_init();
  }
  // every CTA of the cluster started (its shared memory may be written)
  // and the mbarriers initialised
  if (CL > 1) cluster.sync(); else __syncthreads();
  if (producer) ring_fill(a, cur, used, c, s, e, q, ring, bar);
  if (CL > 1 && tid == 0) {
    mbar_arrive(xbar, xbytes);
    mbar_arrive(xbar + 1, xbytes);
  }

  const bool stamp = a.stamps != nullptr && tid == 0;
  unsigned long long st[5] = {0, 0, 0, 0, 0};
  auto sync_block = [&]() {
    if (T == 32) __syncwarp(); else __syncthreads();
  };
  // step (ph, t)'s slices: the ring slots once landed, or the slices in
  // device memory
  auto land = [&]() -> const float* {
    const unsigned long long t0 = stamp ? clock64() : 0;
    mbar_wait(bar + rs, rp);
    if (stamp) st[0] += clock64() - t0;
    const float* p = ring + (size_t)rs * slw;
    ++used;
    if (++rs == a.D) {
      rs = 0;
      rp ^= 1u;
    }
    return p;
  };
  auto slices = [&](int ph, int t, const float*& A0, const float*& A1) {
    fill_of(a, ph, t, c, s, e, q, A0, A1);
    if (RING) {
      if (A0) A0 = land();
      if (A1) A1 = land();
    }
  };
  // the step's end: every thread of the CTA past its reads, the freed
  // slots refilled; where the step exchanged its vectors, the whole new
  // vector in, and that mbarrier's next phase announced
  auto step_end = [&](bool exch) {
    const unsigned long long t0 = stamp ? clock64() : 0;
    sync_block();
    if (producer) ring_fill(a, cur, used, c, s, e, q, ring, bar);
    if (exch) {
      if (CL > 1) {
        mbar_wait(xbar + (xc & 1), (unsigned)((xc >> 1) & 1));
        if (tid == 0) mbar_arrive(xbar + (xc & 1), xbytes);
      }
      ++xc;
    }
    if (stamp) {
      st[3] += clock64() - t0;
      st[4] += 1;
    }
  };
  // problem g's row i into the exchange's buffer of every CTA (CL = 1: its
  // own)
  auto put = [&](int g, int i, float v) {
    float* local = vec + (xc & 1) * vbw + g * cs + i;
    if (CL == 1) {
      *local = v;
      return;
    }
    const unsigned la = smem_u32(local), lb = smem_u32(xbar + (xc & 1));
    for (int rr = 0; rr < CL; ++rr) {
      unsigned da, db;
      asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                   : "=r"(da) : "r"(la), "r"(rr));
      asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                   : "=r"(db) : "r"(lb), "r"(rr));
      st_async(da, v, db);
    }
  };
  // problem g's vector the last exchange brought
  auto prev = [&](int g) { return vec + ((xc + 1) & 1) * vbw + g * cs; };
  auto tick = [&]() -> unsigned long long { return stamp ? clock64() : 0; };
  auto at = [&](int p, int k, int i) {
    return (size_t)p * N * b + (size_t)k * b + i;
  };
  const int U0 = tid < TC ? tid : units;  // the producer has no rows

  // 0: the forward sweep of the window from a zero carry; window 0 also
  // U⁻¹_{k−1} y_{k−1} one stage behind (and after its last stage)
  if (phase_steps(a, 0, c, ne)) {
    for (int t = 0; t < ne + (c == 0); ++t) {
      const float *A0, *A1;
      slices(0, t, A0, A1);
      const int k = s + t;
      const bool out = t < ne;
      for (int u = U0; u < units; u += TC) {
        const int g = u / rq, il = u % rq, i = r0 + il, p = g0 + g;
        const bool ok = p < a.P;
        const float rv = out && ok ? __ldg(a.r + at(p, k, i)) : 0.0f;
        const unsigned long long t1 = tick();
        const float* v = prev(g);
        float sa, sb;
        if (A0 && A1)
          dots<L2, true, true>(A0 + il * RS, v, A1 + il * RS, v, b, sa, sb);
        else if (A0)
          dots<L2, false>(A0 + il * RS, v, nullptr, nullptr, b, sa, sb);
        else if (A1)
          dots<L2, false>(A1 + il * RS, v, nullptr, nullptr, b, sb, sa);
        const unsigned long long t2 = tick();
        const float y = A0 ? rv - sa : rv;
        if (out) put(g, i, y);
        if (ok) {
          if (A1) a.x[at(p, k - 1, i)] = sb;
          if (out && c > 0) a.x[at(p, k, i)] = y;
          if (out && C > 1 && t == ne - 1)
            a.ends[((size_t)p * C + c) * b + i] = y;
        }
        if (stamp) {
          st[1] += t2 - t1;
          st[2] += clock64() - t2;
        }
      }
      step_end(out);
    }
    if (flg && tid == 0 && C > 1 && c >= 1 && c <= C - 2)
      flag_post(flg + c * 4 + kFwdDone);
  }

  // 1: the forward carries, composed once (window 0's cluster):
  // carry_{t+1} = Π_{e_t−1}·carry_t + y⁰_{e_t−1}, carry_0 = 0
  if (phase_steps(a, 1, c, ne)) {
    if (flg && tid == 0)
      for (int w = 1; w <= C - 2; ++w) flag_wait(flg + w * 4 + kFwdDone,
                                                 a.target);
    __syncthreads();
    for (int t = 0; t < C - 1; ++t) {
      const float *A0, *A1;
      slices(1, t, A0, A1);
      for (int u = U0; u < units; u += TC) {
        const int g = u / rq, il = u % rq, i = r0 + il, p = g0 + g;
        const bool ok = p < a.P;
        const float ev =
            ok ? __ldcg(a.ends + ((size_t)p * C + t) * b + i) : 0.0f;
        float sa, sb;
        if (A0)
          dots<L2, false>(A0 + il * RS, prev(g), nullptr, nullptr, b, sa, sb);
        const float o = A0 ? sa + ev : __fadd_rn(0.0f, ev);
        put(g, i, o);
        if (ok) __stcg(a.carries + ((size_t)p * C + t + 1) * b + i, o);
      }
      step_end(true);
      if (flg && tid == 0) flag_post(flg + (t + 1) * 4 + kFwdCarry);
    }
  }

  // 2: the window's carry in; y_k = y⁰_k + Π_k·carry over its stages,
  // U⁻¹_{k−1} y_{k−1} one stage behind
  if (phase_steps(a, 2, c, ne)) {
    if (flg && tid == 0) flag_wait(flg + c * 4 + kFwdCarry, a.target);
    __syncthreads();
    load_carry(a, a.carries, c, g0, vec + 2 * vbw, cs);
    __syncthreads();
    for (int t = 0; t <= ne; ++t) {
      const float *A0, *A1;
      slices(2, t, A0, A1);
      const int k = s + t;
      for (int u = U0; u < units; u += TC) {
        const int g = u / rq, il = u % rq, i = r0 + il, p = g0 + g;
        const bool ok = p < a.P;
        const float y0 = A0 && ok ? a.x[at(p, k, i)] : 0.0f;
        const float* cv = vec + 2 * vbw + g * cs;
        const unsigned long long t1 = tick();
        float sa, sb;
        if (A0 && A1)
          dots<L2, true>(A0 + il * RS, cv, A1 + il * RS, prev(g), b, sa, sb);
        else if (A0)
          dots<L2, false>(A0 + il * RS, cv, nullptr, nullptr, b, sa, sb);
        else
          dots<L2, false>(A1 + il * RS, prev(g), nullptr, nullptr, b, sb, sa);
        const unsigned long long t2 = tick();
        if (A0) put(g, i, y0 + sa);
        if (A1 && ok) a.x[at(p, k - 1, i)] = sb;
        if (stamp) {
          st[1] += t2 - t1;
          st[2] += clock64() - t2;
        }
      }
      step_end(t < ne);
    }
  }

  // 3: the backward sweep from a zero carry, x_k = U⁻¹_k y_k − C_k x_{k+1}
  // (U⁻¹_k y_k from x's buffer, where the thread that owns the row put it)
  if (phase_steps(a, 3, c, ne)) {
    for (int t = 0; t < ne; ++t) {
      const float *A0, *A1;
      slices(3, t, A0, A1);
      const int k = e - 1 - t;
      for (int u = U0; u < units; u += TC) {
        const int g = u / rq, il = u % rq, i = r0 + il, p = g0 + g;
        const bool ok = p < a.P;
        const float sv = ok ? a.x[at(p, k, i)] : 0.0f;
        const unsigned long long t1 = tick();
        float sa, sb;
        if (A0)
          dots<L2, false>(A0 + il * RS, prev(g), nullptr, nullptr, b, sa, sb);
        const unsigned long long t2 = tick();
        const float xv = A0 ? sv - sa : sv;
        put(g, i, xv);
        if (ok) {
          a.x[at(p, k, i)] = xv;
          if (C > 1 && t == ne - 1)
            a.ends[PCb + ((size_t)p * C + c) * b + i] = xv;
        }
        if (stamp) {
          st[1] += t2 - t1;
          st[2] += clock64() - t2;
        }
      }
      step_end(true);
    }
    if (flg && tid == 0 && C > 1 && c >= 1 && c <= C - 2)
      flag_post(flg + c * 4 + kBwdDone);
  }

  // 4: the backward carries, composed once (the last window's cluster):
  // carry_{w−1} = Ψ_{s_w}·carry_w + x⁰_{s_w}, w = C−1 … 1, carry_{C−1} = 0
  if (phase_steps(a, 4, c, ne)) {
    if (flg && tid == 0)
      for (int w = 1; w <= C - 2; ++w) flag_wait(flg + w * 4 + kBwdDone,
                                                 a.target);
    __syncthreads();
    for (int t = 0; t < C - 1; ++t) {
      const float *A0, *A1;
      slices(4, t, A0, A1);
      const int w = C - 1 - t;
      for (int u = U0; u < units; u += TC) {
        const int g = u / rq, il = u % rq, i = r0 + il, p = g0 + g;
        const bool ok = p < a.P;
        const float ev =
            ok ? __ldcg(a.ends + PCb + ((size_t)p * C + w) * b + i) : 0.0f;
        float sa, sb;
        if (A0)
          dots<L2, false>(A0 + il * RS, prev(g), nullptr, nullptr, b, sa, sb);
        const float o = A0 ? sa + ev : __fadd_rn(0.0f, ev);
        put(g, i, o);
        if (ok) __stcg(a.carries + PCb + ((size_t)p * C + w - 1) * b + i, o);
      }
      step_end(true);
      if (flg && tid == 0) flag_post(flg + (w - 1) * 4 + kBwdCarry);
    }
  }

  // 5: the window's carry in; x_k = x⁰_k + Ψ_k·carry over its stages
  if (phase_steps(a, 5, c, ne)) {
    if (flg && tid == 0) flag_wait(flg + c * 4 + kBwdCarry, a.target);
    __syncthreads();
    load_carry(a, a.carries + PCb, c, g0, vec + 2 * vbw, cs);
    __syncthreads();
    for (int t = 0; t < ne; ++t) {
      const float *A0, *A1;
      slices(5, t, A0, A1);
      const int k = s + t;
      for (int u = U0; u < units; u += TC) {
        const int g = u / rq, il = u % rq, i = r0 + il, p = g0 + g;
        float sa, sb;
        dots<L2, false>(A0 + il * RS, vec + 2 * vbw + g * cs, nullptr,
                        nullptr, b, sa, sb);
        if (p < a.P) {
          float* px = a.x + at(p, k, i);
          *px = *px + sa;
        }
      }
      step_end(false);
    }
  }

  if (stamp)
    for (int k = 0; k < 5; ++k) atomicAdd(a.stamps + k, st[k]);
  // no CTA leaves while a peer may still write into its shared memory
  if (CL > 1) cluster.sync();
}

// ---- k6_narrow -------------------------------------------------------------

struct NarrowArgs {
  const float* r;  // (P, N, b)
  float* x;        // (P, N, b)
  const float* F;  // packed (3, N, block_words(b)): L, U⁻¹, C (column-major)
  const float* M;  // packed (2, N, block_words(b)): Π, Ψ (C > 1)
  int P, N, b, C, G;
};

// Σ_j A(i, j)·v[j], j = 0 … b−1 in order from zero, A one packed block
// (column-major: a slot's lanes read a column as consecutive words);
// unrolled to the slot's L ≥ b lanes, so that the loads of every column
// are issued before the first FMA
template <int L>
__device__ __forceinline__ float col_dot(const float* A, const float* v,
                                         int b, int i) {
  float a[L], w[L];
#pragma unroll
  for (int j = 0; j < L; ++j)
    if (j < b) {
      a[j] = lds1(A + (size_t)j * b + i);
      w[j] = lds1(v + j);
    }
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < L; ++j)
    if (j < b) s = fmaf(a[j], w[j], s);
  return s;
}

template <int L>
__global__ void __launch_bounds__(kMaxThreads) k6_narrow(const NarrowArgs a) {
  extern __shared__ __align__(16) float sm[];
  const int b = a.b, N = a.N, C = a.C;
  const size_t bw = block_words(b), aw = (size_t)N * bw;
  const size_t nb = (size_t)N * b, gnb = pad4((size_t)a.G * nb);
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm);
  float* Fs = sm + 4;
  float* Ms = Fs + 3 * aw;
  float* rs = Fs + (C > 1 ? 5 : 3) * aw;  // the CTA's problems' r
  float* xs = rs + gnb;                    // and their y⁰, U⁻¹y, x⁰
  float* slots = xs + gnb;
  const int tid = threadIdx.x;
  const int u = tid / L, i = tid % L;  // slot u: problem gl, window c
  const int gl = u / C, c = u % C;
  const int p = blockIdx.x * a.G + gl;
  const bool live = gl < a.G && p < a.P, row = live && i < b;
  const unsigned mask =
      L == 32 ? 0xffffffffu : ((1u << L) - 1u) << ((tid % 32) / L * L);
  // a slot's vectors: the exchange's two, the window's end, its carry
  float* vec = slots + (size_t)u * (4 * L + 1);
  float* endv = vec + 2 * L;
  float* cin = vec + 3 * L;
  auto slot_of = [&](int w) {
    return slots + (size_t)(gl * C + w) * (4 * L + 1);
  };
  if (tid == 0) {
    mbar_init(bar);
    mbar_fence_init();
    const unsigned fb = (unsigned)(sizeof(float) * 3 * aw);
    const unsigned mb = C > 1 ? (unsigned)(sizeof(float) * 2 * aw) : 0u;
    mbar_arrive(bar, fb + mb);
    bulk_copy(Fs, a.F, fb, bar);
    if (mb) bulk_copy(Ms, a.M, mb, bar);
  }
  {
    const size_t o = (size_t)blockIdx.x * a.G * nb, all = (size_t)a.P * nb;
    for (size_t k = tid; k < (size_t)a.G * nb; k += blockDim.x)
      rs[k] = o + k < all ? __ldg(a.r + o + k) : 0.0f;
  }
  __syncthreads();
  mbar_wait(bar, 0);
  const float *Lf = Fs, *Uf = Fs + aw, *Cf = Fs + 2 * aw;
  const float *Pi = Ms, *Psi = Ms + aw;
  int s, e;
  window(N, C, c, s, e);
  const int ne = e - s;
  float* xg = a.x + (size_t)p * nb;  // the problem's x in device memory
  const float* rp = rs + (size_t)gl * nb;
  float* xp = xs + (size_t)gl * nb;

  // the forward sweep from a zero carry (window 0: U⁻¹y one stage behind)
  if (live)
    for (int t = 0; t < ne + (c == 0); ++t) {
      const int k = s + t;
      const float* vp = vec + ((t + 1) & 1) * L;
      if (row) {
        if (c == 0 && t >= 1)
          xp[(size_t)(k - 1) * b + i] =
              col_dot<L>(Uf + (size_t)(k - 1) * bw, vp, b, i);
        if (t < ne) {
          const float rv = rp[(size_t)k * b + i];
          const float y =
              t >= 1 ? rv - col_dot<L>(Lf + (size_t)k * bw, vp, b, i) : rv;
          if (c > 0) xp[(size_t)k * b + i] = y;
          if (t == ne - 1) endv[i] = y;
          vec[(t & 1) * L + i] = y;
        }
      }
      __syncwarp(mask);
    }
  if (C > 1) {
    __syncthreads();
    // the forward carries, once, by window 0's slot into each window's
    if (live && c == 0)
      for (int t = 0; t < C - 1; ++t) {
        if (row) {
          int ws, we;
          window(N, C, t, ws, we);
          const float ev = slot_of(t)[2 * L + i];
          const float o =
              t >= 1 ? col_dot<L>(Pi + (size_t)(we - 1) * bw,
                               vec + ((t + 1) & 1) * L, b, i) + ev
                     : __fadd_rn(0.0f, ev);
          slot_of(t + 1)[3 * L + i] = o;
          vec[(t & 1) * L + i] = o;
        }
        __syncwarp(mask);
      }
    __syncthreads();
    // windows after the first: y corrected, U⁻¹y one stage behind
    if (live && c > 0)
      for (int t = 0; t <= ne; ++t) {
        const int k = s + t;
        if (row) {
          if (t >= 1)
            xp[(size_t)(k - 1) * b + i] = col_dot<L>(
                Uf + (size_t)(k - 1) * bw, vec + ((t + 1) & 1) * L, b, i);
          if (t < ne)
            vec[(t & 1) * L + i] = xp[(size_t)k * b + i] +
                                   col_dot<L>(Pi + (size_t)k * bw, cin, b, i);
        }
        __syncwarp(mask);
      }
  }
  // the backward sweep from a zero carry (x final where no correction
  // follows: one window, or the last)
  const bool last = c == C - 1;
  if (live)
    for (int t = 0; t < ne; ++t) {
      const int k = e - 1 - t;
      if (row) {
        const float sv = xp[(size_t)k * b + i];
        const float xv =
            t >= 1 ? sv - col_dot<L>(Cf + (size_t)k * bw,
                                  vec + ((t + 1) & 1) * L, b, i)
                   : sv;
        if (last)
          xg[(size_t)k * b + i] = xv;
        else
          xp[(size_t)k * b + i] = xv;
        vec[(t & 1) * L + i] = xv;
        if (t == ne - 1) endv[i] = xv;
      }
      __syncwarp(mask);
    }
  if (C > 1) {
    __syncthreads();
    // the backward carries, once, by the last window's slot
    if (live && c == C - 1)
      for (int t = 0; t < C - 1; ++t) {
        const int w = C - 1 - t;
        if (row) {
          int ws, we;
          window(N, C, w, ws, we);
          const float ev = slot_of(w)[2 * L + i];
          const float o =
              t >= 1 ? col_dot<L>(Psi + (size_t)ws * bw,
                               vec + ((t + 1) & 1) * L, b, i) + ev
                     : __fadd_rn(0.0f, ev);
          slot_of(w - 1)[3 * L + i] = o;
          vec[(t & 1) * L + i] = o;
        }
        __syncwarp(mask);
      }
    __syncthreads();
    if (row && !last)
      for (int k = s; k < e; ++k)
        xg[(size_t)k * b + i] = xp[(size_t)k * b + i] +
                                col_dot<L>(Psi + (size_t)k * bw, cin, b, i);
  }
}

// ---- launches --------------------------------------------------------------

// a kernel's attributes as last set (the largest dynamic shared memory, a
// non-portable cluster allowed), so that a launch sets them only where it
// asks for more; and the clusters the card holds at once by configuration
// (cudaOccupancyMaxActiveClusters), asked once each
struct KernelAttrs {
  const void* kernel;
  size_t bytes;
  bool wide;
};
KernelAttrs g_attrs[16];
int g_nattrs = 0;

struct Resident {
  const void* kernel;
  int cluster, threads;
  size_t bytes;
  int clusters;
};
Resident g_resident[64];
int g_nresident = 0;

template <typename Kernel>
int allow(Kernel kernel, size_t bytes, int cluster) {
  const void* k = (const void*)kernel;
  KernelAttrs* at = nullptr;
  for (int i = 0; i < g_nattrs; ++i)
    if (g_attrs[i].kernel == k) at = g_attrs + i;
  if (!at) {
    if (g_nattrs == 16) return (int)cudaErrorInvalidValue;
    at = g_attrs + g_nattrs++;
    *at = KernelAttrs{k, 48 * 1024, false};
  }
  int rc = 0;
  if (bytes > at->bytes) {
    rc = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (!rc) at->bytes = bytes;
  }
  if (!rc && cluster > 8 && !at->wide) {
    rc = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (!rc) at->wide = true;
  }
  return rc;
}

// the clusters of `cfg`'s shape the card holds at once
int resident_clusters(const void* kernel, const cudaLaunchConfig_t& cfg,
                      int cluster, int* out) {
  for (int i = 0; i < g_nresident; ++i) {
    const Resident& r = g_resident[i];
    if (r.kernel == kernel && r.cluster == cluster &&
        r.threads == (int)cfg.blockDim.x && r.bytes == cfg.dynamicSmemBytes) {
      *out = r.clusters;
      return 0;
    }
  }
  cudaLaunchConfig_t probe = cfg;
  probe.gridDim = dim3((unsigned)cluster, 1, 1);
  const int rc = (int)cudaOccupancyMaxActiveClusters(out, kernel, &probe);
  if (!rc && g_nresident < 64)
    g_resident[g_nresident++] = Resident{kernel, cluster,
                                         (int)cfg.blockDim.x,
                                         cfg.dynamicSmemBytes, *out};
  return rc;
}

// k6_wide: one launch where every cluster is resident at once (or C = 1),
// else one launch a phase; the launches into *launches
template <bool RING>
int launch_wide(WideArgs a, int threads, unsigned epoch, int force_multi,
                int* launches, cudaStream_t stream) {
  auto kernel = k6_wide<RING>;
  const size_t bytes =
      sizeof(float) * wide_smem_words(a.b, a.R, a.RS, a.G, RING ? a.D : 0);
  int rc = allow(kernel, bytes, a.CL);
  if (rc) return rc;
  const long long groups = (a.P + a.G - 1) / a.G;
  const long long blocks = groups * a.C * a.CL;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks, 1, 1);
  cfg.blockDim = dim3((unsigned)threads, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)a.CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  bool one = a.C == 1;
  if (!one && !force_multi && a.flags) {
    int resident = 0;
    rc = resident_clusters((const void*)kernel, cfg, a.CL, &resident);
    if (rc) return rc;
    one = groups * a.C <= resident;
  }
  if (one) {
    a.phases = (1 << kPhases) - 1;
    if (a.C == 1) a.flags = nullptr;
    a.target = epoch * (unsigned)a.CL;
    *launches = 1;
    rc = (int)cudaLaunchKernelEx(&cfg, kernel, a);
    return rc ? rc : (int)cudaGetLastError();
  }
  a.flags = nullptr;
  *launches = 0;
  for (int m : kLaunchPhases) {
    a.phases = m;
    rc = (int)cudaLaunchKernelEx(&cfg, kernel, a);
    if (!rc) rc = (int)cudaGetLastError();
    if (rc) return rc;
    ++*launches;
  }
  return 0;
}

template <int L>
int launch_narrow(const NarrowArgs& a, int threads, size_t bytes,
                  int* launches, cudaStream_t s) {
  const int rc = allow(k6_narrow<L>, bytes, 1);
  if (rc) return rc;
  k6_narrow<L><<<(unsigned)((a.P + a.G - 1) / a.G), threads, bytes, s>>>(a);
  *launches = 1;
  return (int)cudaGetLastError();
}


}  // namespace

extern "C" {

// shared memory bytes of a K6 CTA (ops/cuda_stagewise.any_smem_bytes
// mirrors it): variant 0 (narrow) from N, b, C, lanes a slot, problems a
// CTA; 1 (ring) and 2 (l2) from b, rows a CTA, problems a cluster and the
// ring's depth
int phc_k6_smem_bytes(int variant, int N, int b, int C, int lanes, int rows,
                      int G, int ring) {
  if (variant == 0)
    return (int)(sizeof(float) * narrow_smem_words(N, b, C, lanes, G));
  return (int)(sizeof(float) * wide_smem_words(b, rows, (int)odd_quads(b), G,
                                               variant == 1 ? ring : 0));
}

// x = K⁻¹ r for P problems of horizon N and block b over C windows (1:
// the sequential sweep). variant 0 (k6_narrow): F the packed factors (3,
// N, block_words(b)) and M the packed maps (2, N, block_words(b)), `lanes`
// a slot, G problems a CTA; 1 (ring) and 2 (l2) (k6_wide): F and M the
// row slices (n, N, cluster, rows, odd_quads(b)), G problems a cluster,
// `ring` slices; `work` the workspace ((4, P, C, b) words, then
// (⌈P/G⌉, C, 4) counters) for C > 1, `epoch` this call's (counted from 1
// since the counters were zeroed), `force_multi` the five-launch form
// even where one launch fits; `stamps` null or five counters. The
// launches made into *launches.
int phc_sw_solve_k_any(const float* r, float* x, const float* F,
                       const float* M, float* work,
                       unsigned long long* stamps, int P, int N, int b,
                       int C, int variant, int cluster, int rows, int G,
                       int lanes, int ring, int threads,
                       unsigned epoch, int force_multi, int* launches,
                       void* stream) {
  if (P < 1 || N < 1 || b < 1 || C < 1 || C > N || G < 1 || threads < 32 ||
      threads > kMaxThreads || threads % 32 || !launches ||
      (C > 1 && !M) || variant < 0 || variant > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (variant == 0) {
    if (lanes < 1 || lanes > 32 || 32 % lanes || b > lanes ||
        (long long)G * C * lanes > threads)
      return (int)cudaErrorInvalidValue;
    const size_t bytes = sizeof(float) * narrow_smem_words(N, b, C, lanes, G);
    const NarrowArgs na{r, x, F, M, P, N, b, C, G};
    switch (lanes) {
      case 1: return launch_narrow<1>(na, threads, bytes, launches, s);
      case 2: return launch_narrow<2>(na, threads, bytes, launches, s);
      case 4: return launch_narrow<4>(na, threads, bytes, launches, s);
      case 8: return launch_narrow<8>(na, threads, bytes, launches, s);
      case 16: return launch_narrow<16>(na, threads, bytes, launches, s);
      case 32: return launch_narrow<32>(na, threads, bytes, launches, s);
    }
    return (int)cudaErrorInvalidValue;
  }
  if (cluster < 1 || cluster > 16 || (cluster & (cluster - 1)) ||
      rows < 1 || (long long)rows * cluster < b ||
      (variant == 1 && ring < 2) || (C > 1 && !work) ||
      (variant == 1 &&
       (size_t)rows * odd_quads(b) * sizeof(float) >= (1u << 20)))
    return (int)cudaErrorInvalidValue;
  const size_t pcb = (size_t)P * C * b;
  WideArgs a{};
  a.r = r;
  a.x = x;
  a.F = F;
  a.M = M;
  a.ends = work;
  a.carries = work ? work + 2 * pcb : nullptr;
  a.flags = work ? reinterpret_cast<unsigned*>(work + 4 * pcb) : nullptr;
  a.stamps = stamps;
  a.P = P;
  a.N = N;
  a.b = b;
  a.C = C;
  a.CL = cluster;
  a.R = rows;
  a.RS = (int)odd_quads(b);
  a.G = G;
  a.D = variant == 1 ? ring : 0;
  return variant == 1
             ? launch_wide<true>(a, threads, epoch, force_multi, launches, s)
             : launch_wide<false>(a, threads, epoch, force_multi, launches, s);
}

const char* phc_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

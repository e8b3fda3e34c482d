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
// from a zero carry (y⁰); the carry into window c composes through the
// window maps Π of the windows before it (carry ← Π_{e−1}·carry + y⁰_{e−1},
// from zero); every stage is corrected, y_k = y⁰_k + Π_k·carry; every
// window sweeps backward from a zero carry (x⁰); the carry into window c
// composes through Ψ of the windows after it (carry ← Ψ_s·carry + x⁰_s);
// x_k = x⁰_k + Ψ_k·carry. Π and Ψ are (N, b, b) (ops/stagewise.window_maps,
// fp64 products rounded to fp32). r and x are (P, N, b) fp32; every b×b
// block of L, U⁻¹, C, Π and Ψ is read packed column-major, element (i, j)
// at word j·b + i of a block of pad4(b²) words (ops/cuda_stagewise
// pack_wide), so that the threads of a warp read a column as consecutive
// words. Each block row is summed in fp32 FMAs in column order (j = 0 …
// b−1), then subtracted from r_k (forward) or from U⁻¹_k y_k (backward),
// as the plain version's addmm computes it; no TF32.
//
// What bounds it on the H100. Per problem the sweeps are 2·N dependent
// stages, each a b-row matrix-vector product on the previous stage's
// vector; the bytes are r and x once and the factors (3·N·b² words, 7.4 MB
// at N = 24, b = 160, read by every problem through L2). The chain bounds
// it: 2·N stages, or with C windows 2·⌈N/C⌉ stages plus 2·(C−1) carry
// steps and two corrections off the chain.
//
// The design (a simple kernel; its speed is later work):
//  - r, y and x live in device memory, never a problem's whole vector in
//    shared memory, which is what limits K4 (one block's r/y buffer) and K5
//    (bmax 128): shared memory holds four b-word vectors (the previous
//    stage's, the current one, and the backward sweep's y_k prefetched one
//    stage ahead), so a CTA takes any b up to ~14,500.
//  - One CTA a (problem, window), b rows dealt over its threads (row i to
//    thread i mod T, T = b rounded up to a warp, at most 256); the previous
//    stage's vector broadcast from shared memory; one block barrier a stage
//    (the vectors double-buffered). The thread that writes a row of y reads
//    it back in the backward sweep and writes x over it in place, so x's
//    buffer carries y between the sweeps and no scratch of P·N·b is needed.
//  - Windowed, three launches on the caller's stream: (1) the windows'
//    forward sweeps, each window's last y⁰ also into `yend` (P, C, b);
//    (2) each CTA composes its window's carry from `yend` and Π (steps 2 of
//    the algorithm, done by each window for itself: c b×b products, no
//    launch or grid barrier of its own), corrects its stages in place, then
//    sweeps backward from zero, its first x⁰ also into `xbeg`; (3) each CTA
//    composes its carry from `xbeg` and Ψ and corrects its stages. Separate
//    launches rather than a cluster of C CTAs: they take any C and any P
//    with no cluster or co-residency limit, and the two side buffers keep a
//    window's in-place corrections from racing its neighbours' reads.
//  - The composition runs in the plain version's order (window 0 first
//    forward, the last window first backward), so kernel and plain version
//    round alike up to the order of the library's products.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kMaxThreads = 256;

// words of one packed b×b block (column-major, padded to a multiple of 4)
__host__ __device__ inline size_t block_words(int b) {
  return ((size_t)b * b + 3) / 4 * 4;
}

// loads of a block row a thread keeps in flight at once
constexpr int kBatch = 16;

// Σ_j A(i, j)·v[j], j = 0 … b−1 in order, A one packed block: the row's
// words loaded kBatch at a time into registers before their FMAs, so that
// kBatch L2 reads overlap (a loop of load-then-FMA waits one L2 latency a
// column)
__device__ __forceinline__ float row_dot(const float* __restrict__ A,
                                         const float* v, int b, int i) {
  float s = 0.0f;
  for (int j0 = 0; j0 < b; j0 += kBatch) {
    float a[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      a[u] = j0 + u < b ? __ldg(A + (size_t)(j0 + u) * b + i) : 0.0f;
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (j0 + u < b) s = fmaf(a[u], v[j0 + u], s);
  }
  return s;
}

// row_dot(A, v) − row_dot(B, w), both blocks' loads in flight together
// (each sum in column order)
__device__ __forceinline__ float row_dot2(const float* __restrict__ A,
                                          const float* v,
                                          const float* __restrict__ B,
                                          const float* w, int b, int i) {
  float s = 0.0f, t = 0.0f;
  for (int j0 = 0; j0 < b; j0 += kBatch) {
    float a[kBatch], c[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const bool in = j0 + u < b;
      a[u] = in ? __ldg(A + (size_t)(j0 + u) * b + i) : 0.0f;
      c[u] = in ? __ldg(B + (size_t)(j0 + u) * b + i) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (j0 + u < b) {
        s = fmaf(a[u], v[j0 + u], s);
        t = fmaf(c[u], w[j0 + u], t);
      }
  }
  return s - t;
}

// window c's stages [s, e) of a horizon of N in C windows (hz_lo)
__device__ __forceinline__ void window(int N, int C, int c, int& s, int& e) {
  s = (int)((long long)c * N / C);
  e = (int)((long long)(c + 1) * N / C);
}

// y⁰ over stages [s, e) from a zero carry, into y (the problem's x buffer);
// the last stage's vector also into `end` where given. sm: 2·b words.
__device__ void forward(const float* __restrict__ r,
                        const float* __restrict__ L, float* y, float* end,
                        int s, int e, int b, size_t ld, float* sm) {
  float* prev = sm;
  float* cur = sm + b;
  for (int i = threadIdx.x; i < b; i += blockDim.x) prev[i] = 0.0f;
  __syncthreads();
  for (int k = s; k < e; ++k) {
    const float* Lk = L + (size_t)k * ld;
    for (int i = threadIdx.x; i < b; i += blockDim.x) {
      const float v = __ldg(r + (size_t)k * b + i) - row_dot(Lk, prev, b, i);
      cur[i] = v;
      y[(size_t)k * b + i] = v;
      if (end != nullptr && k == e - 1) end[i] = v;
    }
    __syncthreads();
    float* t = prev;
    prev = cur;
    cur = t;
  }
}

// x⁰ over stages [s, e) from a zero carry, reading y from x's buffer and
// writing x over it in place; the first stage's vector also into `beg`
// where given. sm: 4·b words (y_k and the next y prefetched, x_{k+1}, x_k).
__device__ void backward(const float* __restrict__ U,
                         const float* __restrict__ Cf, float* x, float* beg,
                         int s, int e, int b, size_t ld, float* sm) {
  float* ycur = sm;
  float* ynext = sm + b;
  float* xprev = sm + 2 * b;
  float* xcur = sm + 3 * b;
  for (int i = threadIdx.x; i < b; i += blockDim.x) {
    ycur[i] = x[(size_t)(e - 1) * b + i];
    xprev[i] = 0.0f;
  }
  __syncthreads();
  for (int k = e - 1; k >= s; --k) {
    if (k > s)
      for (int i = threadIdx.x; i < b; i += blockDim.x)
        ynext[i] = x[(size_t)(k - 1) * b + i];
    const float* Uk = U + (size_t)k * ld;
    const float* Ck = Cf + (size_t)k * ld;
    for (int i = threadIdx.x; i < b; i += blockDim.x) {
      const float v = row_dot2(Uk, ycur, Ck, xprev, b, i);
      xcur[i] = v;
      x[(size_t)k * b + i] = v;
      if (beg != nullptr && k == s) beg[i] = v;
    }
    __syncthreads();
    float* t = ycur;
    ycur = ynext;
    ynext = t;
    t = xprev;
    xprev = xcur;
    xcur = t;
  }
}

// the carry composed over the chain of windows `from`, `from + step`, …
// (`count` of them) from zero: carry ← M_at(w)·carry + v_w, M the maps
// (packed), `at(w)` the stage whose map a window applies, v the side
// buffer (C, b); returns the buffer of sm (2·b words) that holds it
template <typename At>
__device__ float* compose(const float* __restrict__ M,
                          const float* __restrict__ v, int from, int step,
                          int count, At at, int b, size_t ld, float* sm) {
  float* prev = sm;
  float* cur = sm + b;
  for (int i = threadIdx.x; i < b; i += blockDim.x) prev[i] = 0.0f;
  __syncthreads();
  for (int n = 0, w = from; n < count; ++n, w += step) {
    const float* Mk = M + (size_t)at(w) * ld;
    for (int i = threadIdx.x; i < b; i += blockDim.x)
      cur[i] = row_dot(Mk, prev, b, i) + __ldg(v + (size_t)w * b + i);
    __syncthreads();
    float* t = prev;
    prev = cur;
    cur = t;
  }
  return prev;
}

// the stages [s, e) of x's buffer plus M_k·carry (every (stage, row) pair
// dealt over the CTA's threads)
__device__ void correct(const float* __restrict__ M, const float* carry,
                        float* x, int s, int e, int b, size_t ld) {
  const int n = (e - s) * b;
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    const int k = s + t / b, i = t % b;
    x[(size_t)k * b + i] += row_dot(M + (size_t)k * ld, carry, b, i);
  }
}

// C = 1: both sweeps of one problem a CTA
__global__ void __launch_bounds__(kMaxThreads)
    sw_any_sequential(const float* __restrict__ r,
                      const float* __restrict__ L,
                      const float* __restrict__ U,
                      const float* __restrict__ Cf, float* __restrict__ x,
                      int N, int b) {
  extern __shared__ float sm[];
  const size_t ld = block_words(b);
  const size_t off = (size_t)blockIdx.x * N * b;
  forward(r + off, L, x + off, nullptr, 0, N, b, ld, sm);
  backward(U, Cf, x + off, nullptr, 0, N, b, ld, sm);
}

// windowed, launch 1: CTA p·C + c sweeps window c of problem p forward
// from a zero carry; its last y⁰ into yend
__global__ void __launch_bounds__(kMaxThreads)
    sw_any_forward(const float* __restrict__ r, const float* __restrict__ L,
                   float* __restrict__ x, float* __restrict__ yend, int N,
                   int b, int C) {
  extern __shared__ float sm[];
  const int p = blockIdx.x / C, c = blockIdx.x % C;
  int s, e;
  window(N, C, c, s, e);
  const size_t off = (size_t)p * N * b;
  forward(r + off, L, x + off, yend + ((size_t)p * C + c) * b, s, e, b,
          block_words(b), sm);
}

// windowed, launch 2: the carry into window c through Π of the windows
// before it, the window's stages corrected, its backward sweep from a
// zero carry; its first x⁰ into xbeg
__global__ void __launch_bounds__(kMaxThreads)
    sw_any_backward(const float* __restrict__ U,
                    const float* __restrict__ Cf,
                    const float* __restrict__ Pi,
                    const float* __restrict__ yend, float* __restrict__ x,
                    float* __restrict__ xbeg, int N, int b, int C) {
  extern __shared__ float sm[];
  const int p = blockIdx.x / C, c = blockIdx.x % C;
  int s, e;
  window(N, C, c, s, e);
  const size_t ld = block_words(b);
  float* xp = x + (size_t)p * N * b;
  if (c > 0) {
    const float* carry = compose(
        Pi, yend + (size_t)p * C * b, 0, 1, c,
        [N, C](int w) {
          int ws, we;
          window(N, C, w, ws, we);
          return we - 1;
        },
        b, ld, sm);
    correct(Pi, carry, xp, s, e, b, ld);
    __syncthreads();
  }
  backward(U, Cf, xp, xbeg + ((size_t)p * C + c) * b, s, e, b, ld, sm);
}

// windowed, launch 3: the carry into window c through Ψ of the windows
// after it (the last window first), the window's stages corrected
__global__ void __launch_bounds__(kMaxThreads)
    sw_any_fix(const float* __restrict__ Psi, const float* __restrict__ xbeg,
               float* __restrict__ x, int N, int b, int C) {
  extern __shared__ float sm[];
  const int p = blockIdx.x / C, c = blockIdx.x % C;
  if (c == C - 1) return;
  int s, e;
  window(N, C, c, s, e);
  const size_t ld = block_words(b);
  const float* carry = compose(
      Psi, xbeg + (size_t)p * C * b, C - 1, -1, C - 1 - c,
      [N, C](int w) {
        int ws, we;
        window(N, C, w, ws, we);
        return ws;
      },
      b, ld, sm);
  correct(Psi, carry, x + (size_t)p * N * b, s, e, b, ld);
}

size_t smem_bytes(int b) { return sizeof(float) * 4 * (size_t)b; }

template <typename Kernel>
int allow(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

extern "C" {

// x = K⁻¹ r for P problems of horizon N and block b, the factors L, U, C
// packed (pack_wide); C = `windows` windows (1: the sequential sweep; else
// the window maps Pi and Psi, packed like the factors, and the side
// buffers yend and xbeg, (P, windows, b) each); `threads` a CTA (a
// multiple of 32, at most 256)
int phc_sw_solve_k_any(const float* r, const float* L, const float* U,
                       const float* C, const float* Pi, const float* Psi,
                       float* x, float* yend, float* xbeg, int P, int N,
                       int b, int windows, int threads, void* stream) {
  if (P < 1 || N < 1 || b < 1 || windows < 1 || windows > N ||
      threads < 32 || threads > kMaxThreads || threads % 32 ||
      (windows > 1 && (!Pi || !Psi || !yend || !xbeg)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t bytes = smem_bytes(b);
  int rc;
  if (windows == 1) {
    if ((rc = allow(sw_any_sequential, bytes))) return rc;
    sw_any_sequential<<<P, threads, bytes, s>>>(r, L, U, C, x, N, b);
    return (int)cudaGetLastError();
  }
  const long long blocks = (long long)P * windows;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if ((rc = allow(sw_any_forward, bytes)) ||
      (rc = allow(sw_any_backward, bytes)) || (rc = allow(sw_any_fix, bytes)))
    return rc;
  sw_any_forward<<<(unsigned)blocks, threads, bytes, s>>>(r, L, x, yend, N,
                                                          b, windows);
  if ((rc = (int)cudaGetLastError())) return rc;
  sw_any_backward<<<(unsigned)blocks, threads, bytes, s>>>(
      U, C, Pi, yend, x, xbeg, N, b, windows);
  if ((rc = (int)cudaGetLastError())) return rc;
  sw_any_fix<<<(unsigned)blocks, threads, bytes, s>>>(Psi, xbeg, x, N, b,
                                                      windows);
  return (int)cudaGetLastError();
}

const char* phc_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

// K4: the block-tridiagonal sweep of the stagewise frame for Hopper
// (sm_90a), with a plain C interface loaded through ctypes by
// pyhybridcontrol_tpu_torch/ops/_build.py.
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
// The design:
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

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 4;

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

template <int BMAX, bool STAGED>
__global__ void __launch_bounds__(32 * kMaxWarps)
sw_solve_k_kernel(const float* __restrict__ r, const float* __restrict__ Lg,
                  const float* __restrict__ Ug, const float* __restrict__ Cg,
                  float* __restrict__ x, int P, int N, int b) {
  constexpr int R = (BMAX + 31) / 32;           // rows a lane owns
  extern __shared__ __align__(16) float smem[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int bb = b * b;
  const float* L = Lg;
  const float* U = Ug;
  const float* C = Cg;
  float* ys = smem;
  if (STAGED) {
    const int n = N * bb;
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
  float* xp = x + (size_t)p * N * b;

  // ---- forward sweep: y_k = r_k − L_k y_{k−1}, in place over r_k ----
  float prev[R];
#pragma unroll
  for (int t = 0; t < R; ++t) prev[t] = 0.0f;
  for (int k = 0; k < N; ++k) {
    const float* Lk = L + (size_t)k * bb;
    float* yk = ys + k * b;
    float acc[R];
#pragma unroll
    for (int t = 0; t < R; ++t) acc[t] = 0.0f;
#pragma unroll
    for (int s = 0; s < R; ++s) {
#pragma unroll
      for (int l = 0; l < (BMAX - 32 * s < 32 ? BMAX - 32 * s : 32); ++l) {
        const int j = s * 32 + l;
        if (j < b) {  // uniform over the warp
          const float yj = __shfl_sync(kFull, prev[s], l);
#pragma unroll
          for (int t = 0; t < R; ++t) {
            const int i = t * 32 + lane;
            if (i < b) acc[t] = fmaf(Lk[i * b + j], yj, acc[t]);
          }
        }
      }
    }
#pragma unroll
    for (int t = 0; t < R; ++t) {
      const int i = t * 32 + lane;
      if (i < b) {
        prev[t] = yk[i] - acc[t];
        yk[i] = prev[t];
      } else {
        prev[t] = 0.0f;
      }
    }
  }
  __syncwarp();

  // ---- backward sweep: x_k = U⁻¹_k y_k − C_k x_{k+1} ----
  float nxt[R];
#pragma unroll
  for (int t = 0; t < R; ++t) nxt[t] = 0.0f;
  for (int k = N - 1; k >= 0; --k) {
    const float* Uk = U + (size_t)k * bb;
    const float* Ck = C + (size_t)k * bb;
    const float* yk = ys + k * b;
    float a[R], c[R];
#pragma unroll
    for (int t = 0; t < R; ++t) {
      a[t] = 0.0f;
      c[t] = 0.0f;
    }
#pragma unroll
    for (int j = 0; j < BMAX; ++j) {
      if (j < b) {
        const float yj = yk[j];
#pragma unroll
        for (int t = 0; t < R; ++t) {
          const int i = t * 32 + lane;
          if (i < b) a[t] = fmaf(Uk[i * b + j], yj, a[t]);
        }
      }
    }
#pragma unroll
    for (int s = 0; s < R; ++s) {
#pragma unroll
      for (int l = 0; l < (BMAX - 32 * s < 32 ? BMAX - 32 * s : 32); ++l) {
        const int j = s * 32 + l;
        if (j < b) {
          const float xj = __shfl_sync(kFull, nxt[s], l);
#pragma unroll
          for (int t = 0; t < R; ++t) {
            const int i = t * 32 + lane;
            if (i < b) c[t] = fmaf(Ck[i * b + j], xj, c[t]);
          }
        }
      }
    }
#pragma unroll
    for (int t = 0; t < R; ++t) {
      const int i = t * 32 + lane;
      if (i < b) {
        nxt[t] = a[t] - c[t];
        xp[(size_t)k * b + i] = nxt[t];
      } else {
        nxt[t] = 0.0f;
      }
    }
  }
}

size_t smem_bytes(int N, int b, int warps, int staged) {
  return sizeof(float) * ((staged ? 3 * pad4((size_t)N * b * b) : 0) +
                          (size_t)warps * pad4((size_t)N * b));
}

template <int BMAX, bool STAGED>
int launch(const float* r, const float* L, const float* U, const float* C,
           float* x, int P, int N, int b, int warps, cudaStream_t stream) {
  auto kernel = sw_solve_k_kernel<BMAX, STAGED>;
  const size_t bytes = smem_bytes(N, b, warps, STAGED);
  if (bytes > 48 * 1024) {
    const int rc = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (rc) return rc;
  }
  const int blocks = (P + warps - 1) / warps;
  kernel<<<blocks, 32 * warps, bytes, stream>>>(r, L, U, C, x, P, N, b);
  return (int)cudaGetLastError();
}

template <int BMAX>
int launch_b(const float* r, const float* L, const float* U, const float* C,
             float* x, int P, int N, int b, int warps, int staged,
             cudaStream_t stream) {
  return staged ? launch<BMAX, true>(r, L, U, C, x, P, N, b, warps, stream)
                : launch<BMAX, false>(r, L, U, C, x, P, N, b, warps, stream);
}

}  // namespace

extern "C" {

// dynamic shared memory of one block: the warps' r/y buffers, and the three
// factor arrays when staged (each array padded to a multiple of 4 words)
int phc_sw_smem_bytes(int N, int b, int warps, int staged) {
  return (int)smem_bytes(N, b, warps, staged);
}

// x = K⁻¹ r for P problems; bmax = the compiled bound on b (8, 16, 32, 64
// or 128, at least b)
int phc_sw_solve_k(const float* r, const float* L, const float* U,
                   const float* C, float* x, int P, int N, int b, int warps,
                   int staged, int bmax, void* stream) {
  if (P < 1 || N < 1 || b < 1 || b > bmax || warps < 1 || warps > kMaxWarps)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (bmax) {
    case 8: return launch_b<8>(r, L, U, C, x, P, N, b, warps, staged, s);
    case 16: return launch_b<16>(r, L, U, C, x, P, N, b, warps, staged, s);
    case 32: return launch_b<32>(r, L, U, C, x, P, N, b, warps, staged, s);
    case 64: return launch_b<64>(r, L, U, C, x, P, N, b, warps, staged, s);
    case 128: return launch_b<128>(r, L, U, C, x, P, N, b, warps, staged, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* phc_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

// Batched multi-adapter LoRA delta (Punica/S-LoRA BGMV) for Hopper
// (sm_90a): out[n] = scale * (x[n] . A[t[n]]) . B[t[n]], one adapter per
// row, chosen by the row's task id.
//
// Replaces the Pallas TPU kernel multi_lora_pallas
// (src/repro/kernels/multi_lora/multi_lora.py:51, kernel body _kernel at
// :28, pallas_call at :60; wrapper ops.py:14).  The encoder's batched
// multi-task forward applies it on the q and v projections of every layer
// (src/repro/classifiers/encoder.py:151).
//
// What bounds it on an H100: bytes, narrowly.  At the encoder path's shape
// (N = 30 720 rows, din = dout = 768, r = 32, float32) x and out are 94 MB
// each and the adapters 2.5 MB; the 2 * N * r * (din + dout) = 3.0 GFLOP
// take 0.045 ms at the 67 TFLOP/s float32 FMA rate against 0.057 ms for
// the bytes at 3.35 TB/s.
//
// Design (the gather form: each row tile reads only its own adapters, not
// the TPU's loop over all T with a mask): one block of 256 threads per
// tile of 32 rows.  Thread 0 lists the distinct valid task ids of the tile
// with a 32-bit row mask each; rows whose id is outside [0, T) are in no
// list and come out exact zeros.  Shrink: x is staged in 64-column chunks
// in shared memory (float32), and for each task of the tile its A chunk
// (64 x r) too; thread (row group, j) accumulates column j of h for its
// rows of that task, in float32, over din in order.  h (32 x r) stays in
// shared memory and is never rounded to the input dtype.  Expand: threads
// own output columns; for each task of the tile they read B[t][j][c] once
// (coalesced, from L2) and update the 32 row accumulators of that task's
// rows (a uniform predicate from the row mask).  The store multiplies by
// scale and casts, as the TPU kernel's finish step.  Rows are sorted by
// task on the encoder path, so a tile holds one task (two at a boundary);
// a shuffled layout costs one pass per distinct task in the tile.  The N
// edge is masked: no multiple of 32 is assumed.  Tensor cores (wgmma) and
// the segmented (SGMV) form for sorted rows are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int BN = 32;             // rows per block (one bit each in a mask)
constexpr int THREADS = 256;
constexpr int DC = 64;             // din columns staged per chunk
constexpr int MAX_R = 64;          // largest adapter rank
constexpr int MAX_U = 8;           // shrink rows per thread: BN / (THREADS / MAX_R)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename E> __device__ __forceinline__ E from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

template <typename E>
__global__ void __launch_bounds__(THREADS) multi_lora_kernel(
    const E* __restrict__ x, const E* __restrict__ a,
    const E* __restrict__ b, const int* __restrict__ ids,
    E* __restrict__ out, int N, int din, int dout, int T, int r,
    float scale) {
  __shared__ float xs[BN][DC + 1];
  __shared__ float as[DC * MAX_R];
  __shared__ float hs[BN][MAX_R + 1];
  __shared__ int uniq[BN];
  __shared__ unsigned umask[BN];
  __shared__ int nuniq;

  const int tid = threadIdx.x;
  const size_t row0 = (size_t)blockIdx.x * BN;

  if (tid == 0) {
    int n = 0;
    for (int i = 0; i < BN; ++i) {
      const size_t row = row0 + i;
      const int t = row < (size_t)N ? ids[row] : -1;
      if (t < 0 || t >= T) continue;
      int u = 0;
      while (u < n && uniq[u] != t) ++u;
      if (u == n) {
        uniq[n] = t;
        umask[n] = 0u;
        ++n;
      }
      umask[u] |= 1u << i;
    }
    nuniq = n;
  }
  __syncthreads();
  const int nu = nuniq;

  // shrink: thread (rg, j) owns column j of h for rows rg, rg + nrg, ...
  const int nrg = THREADS / r;       // >= 4 for r <= 64
  const int rg = tid / r;
  const int j = tid - rg * r;
  const bool active = rg < nrg;
  float acc[MAX_U];
#pragma unroll
  for (int u = 0; u < MAX_U; ++u) acc[u] = 0.f;

  for (int k0 = 0; k0 < din && nu > 0; k0 += DC) {
    const int kc = min(DC, din - k0);
    for (int idx = tid; idx < BN * DC; idx += THREADS) {
      const int i = idx / DC, k = idx - i * DC;
      const size_t row = row0 + i;
      xs[i][k] = (row < (size_t)N && k < kc) ? to_f(x[row * din + k0 + k])
                                              : 0.f;
    }
    for (int ui = 0; ui < nu; ++ui) {
      const unsigned m = umask[ui];
      const E* at = a + ((size_t)uniq[ui] * din + k0) * r;
      for (int idx = tid; idx < kc * r; idx += THREADS) as[idx] = to_f(at[idx]);
      __syncthreads();
      if (active) {
        bool own[MAX_U];
        int rows[MAX_U];
#pragma unroll
        for (int u = 0; u < MAX_U; ++u) {
          const int i = rg + u * nrg;
          own[u] = i < BN && ((m >> i) & 1u);
          rows[u] = min(i, BN - 1);
        }
        for (int k = 0; k < kc; ++k) {
          const float av = as[k * r + j];
#pragma unroll
          for (int u = 0; u < MAX_U; ++u)
            if (own[u]) acc[u] = fmaf(xs[rows[u]][k], av, acc[u]);
        }
      }
      __syncthreads();
    }
  }
  if (active) {
#pragma unroll
    for (int u = 0; u < MAX_U; ++u) {
      const int i = rg + u * nrg;
      if (i < BN) hs[i][j] = acc[u];
    }
  }
  __syncthreads();

  // expand: thread owns output column c for all 32 rows of the tile
  for (int c = tid; c < dout; c += THREADS) {
    float y[BN];
#pragma unroll
    for (int i = 0; i < BN; ++i) y[i] = 0.f;
    for (int ui = 0; ui < nu; ++ui) {
      const unsigned m = umask[ui];
      const E* bt = b + (size_t)uniq[ui] * r * dout + c;
      for (int jj = 0; jj < r; ++jj) {
        const float bv = to_f(bt[(size_t)jj * dout]);
#pragma unroll
        for (int i = 0; i < BN; ++i)
          if ((m >> i) & 1u) y[i] = fmaf(hs[i][jj], bv, y[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < BN; ++i) {
      const size_t row = row0 + i;
      if (row < (size_t)N) out[row * dout + c] = from_f<E>(y[i] * scale);
    }
  }
}

template <typename E>
int launch(const void* x, const void* a, const void* b, const void* ids,
           void* out, int N, int din, int dout, int T, int r, float scale,
           cudaStream_t stream) {
  const int grid = (N + BN - 1) / BN;
  multi_lora_kernel<E><<<grid, THREADS, 0, stream>>>(
      static_cast<const E*>(x), static_cast<const E*>(a),
      static_cast<const E*>(b), static_cast<const int*>(ids),
      static_cast<E*>(out), N, din, dout, T, r, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (N, din); a: (T, din, r); b: (T, r, dout); ids: (N,) int32 task id
// per row (any order; ids outside [0, T) give zero rows); out: (N, dout).
// All contiguous; x/a/b/out share one dtype (is_bf16: bfloat16, else
// float32); 1 <= r <= 64.  Returns cudaGetLastError() after the launch.
extern "C" int multi_lora_fwd(const void* x, const void* a, const void* b,
                              const void* ids, void* out, int N, int din,
                              int dout, int T, int r, float scale,
                              int is_bf16, void* stream) {
  if (N < 0 || din <= 0 || dout <= 0 || T < 0 || r <= 0 || r > MAX_R)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(x, a, b, ids, out, N, din, dout, T, r, scale,
                                 s);
  return launch<float>(x, a, b, ids, out, N, din, dout, T, r, scale, s);
}

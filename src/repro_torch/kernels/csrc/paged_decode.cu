// Paged (block-table) GQA decode attention for Hopper (sm_90a): one new
// query token per row against that row's KV blocks in the shared pool.
//
// Replaces: the Pallas TPU kernel paged_flash_decode
//   (src/repro/kernels/flash_decode/ops.py:150, kernel body _paged_kernel
//   at :97, pallas_call at :193).
//
// What bounds it on an H100: bytes.  Each (row, KV head) reads its live
// K and V once — 2 * kv_len * hd * sizeof(T) — and does 4 * G * hd FLOPs
// per key, far below the ~295 FLOP/byte ridge.  The least time is the
// live KV bytes over 3.35 TB/s.
//
// Design: one thread block per (row b, KV head h); the G = Hq/Hkv query
// heads of that KV head share every K/V load.  The block loads its row's
// kv_len and block-table entries itself (the TPU kernel took them through
// scalar prefetch) and walks only the live blocks: nothing builds the
// gathered (B, max_blocks*block_tokens, Hkv, hd) view.  Pass 1 writes the
// G x kv_len float32 scores, scaled by 1/sqrt(hd), into dynamic shared
// memory (3 x 512 x 4 B = 6 KB at the fleet's max_seq 512), one warp per
// key.  Then each row of scores takes its exact max and sum — one final
// float32 softmax, as the reference's op order (ops.py:129-138) — and the
// probabilities are rounded to the value dtype.  Pass 2 reads the live V
// blocks once more and accumulates P.V in float32.  A row with
// kv_len == 0 writes exact zeros.  Freed scheduler slots decode at
// kv_len 1 against an all-zero table row: they read the trash block 0,
// which always exists.  Table entries are clamped into the pool, so a bad
// table cannot fault.  An online softmax would save the score buffer but
// diverged from the reference by ~4e-3 in bf16 on the TPU.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_HD = 128;        // head_dim limit: 4 values per lane

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kpool,
                    const T* __restrict__ vpool, const int* __restrict__ tbl,
                    const int* __restrict__ kv_len, T* __restrict__ out,
                    int Hq, int Hkv, int hd, int num_blocks, int blk,
                    int max_blocks, float scale) {
  extern __shared__ float smem[];
  const int G = Hq / Hkv;
  const int S = max_blocks * blk;    // table capacity in tokens
  float* qs = smem;                  // [G][hd] query rows
  float* ps = smem + G * hd;         // [G][S] scores, then probabilities

  const int b = blockIdx.x / Hkv;
  const int h = blockIdx.x % Hkv;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const size_t row_off = ((size_t)b * Hq + (size_t)h * G) * hd;
  T* o = out + row_off;              // heads h*G .. h*G+G-1 of row b

  const int L = min(max(kv_len[b], 0), S);
  if (L == 0) {
    for (int i = tid; i < G * hd; i += THREADS) o[i] = from_f<T>(0.f);
    return;
  }
  for (int i = tid; i < G * hd; i += THREADS) qs[i] = to_f(q[row_off + i]);
  __syncthreads();

  const int* trow = tbl + (size_t)b * max_blocks;
  const size_t tok_stride = (size_t)Hkv * hd;   // one token in the pool

  // pass 1: scores, one warp per key, lanes split head_dim
  for (int t = warp; t < L; t += WARPS) {
    const int phys = min(max(trow[t / blk], 0), num_blocks - 1);
    const T* kr = kpool + ((size_t)phys * blk + t % blk) * tok_stride +
                  (size_t)h * hd;
    float kreg[MAX_HD / 32];
#pragma unroll
    for (int i = 0; i < MAX_HD / 32; ++i) {
      const int d = lane + 32 * i;
      kreg[i] = d < hd ? to_f(kr[d]) : 0.f;
    }
    for (int g = 0; g < G; ++g) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < MAX_HD / 32; ++i) {
        const int d = lane + 32 * i;
        if (d < hd) part = fmaf(qs[g * hd + d], kreg[i], part);
      }
      part = warp_sum(part);
      if (lane == 0) ps[g * S + t] = part * scale;
    }
  }
  __syncthreads();

  // one float32 softmax per query head over the live keys; masked keys
  // of the reference contribute exp(NEG_INF - max) == 0 to its sum
  for (int g = warp; g < G; g += WARPS) {
    float* pr = ps + g * S;
    float mx = -INFINITY;
    for (int t = lane; t < L; t += 32) mx = fmaxf(mx, pr[t]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int t = lane; t < L; t += 32) {
      const float e = expf(pr[t] - mx);
      pr[t] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int t = lane; t < L; t += 32)
      pr[t] = to_f(from_f<T>(pr[t] / sum));   // probs in the value dtype
  }
  __syncthreads();

  // pass 2: out[g, d] = sum_t p[g, t] * v[t, d], float32 accumulation
  for (int i = tid; i < G * hd; i += THREADS) {
    const int g = i / hd;
    const int d = i % hd;
    const float* pr = ps + g * S;
    float acc = 0.f;
    for (int t = 0; t < L; ++t) {
      const int phys = min(max(trow[t / blk], 0), num_blocks - 1);
      const T* vr = vpool + ((size_t)phys * blk + t % blk) * tok_stride +
                    (size_t)h * hd;
      acc = fmaf(pr[t], to_f(vr[d]), acc);
    }
    o[i] = from_f<T>(acc);
  }
}

template <typename T>
int launch(const void* q, const void* kpool, const void* vpool,
           const void* tbl, const void* kv_len, void* out, int B, int Hq,
           int Hkv, int hd, int num_blocks, int blk, int max_blocks,
           float scale, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  paged_decode_kernel<T><<<B * Hkv, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kpool),
      static_cast<const T*>(vpool), static_cast<const int*>(tbl),
      static_cast<const int*>(kv_len), static_cast<T*>(out), Hq, Hkv, hd,
      num_blocks, blk, max_blocks, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared-memory bytes one block needs; the wrapper checks it against the
// 227 KB a block may use on Hopper.
extern "C" long long paged_decode_smem_bytes(int Hq, int Hkv, int hd,
                                             int blk, int max_blocks) {
  const long long G = Hq / Hkv;
  return (G * hd + G * (long long)max_blocks * blk) * (long long)sizeof(float);
}

// q: (B, Hq, hd); kpool/vpool: (num_blocks, blk, Hkv, hd); tbl:
// (B, max_blocks) int32; kv_len: (B,) int32; out: (B, Hq, hd).  All
// contiguous; q/pools/out share one dtype (is_bf16: bfloat16, else
// float32).  Returns cudaGetLastError() after the launch.
extern "C" int paged_decode_fwd(const void* q, const void* kpool,
                                const void* vpool, const void* tbl,
                                const void* kv_len, void* out, int B, int Hq,
                                int Hkv, int hd, int num_blocks, int blk,
                                int max_blocks, int is_bf16, void* stream) {
  if (hd <= 0 || hd > MAX_HD || Hkv <= 0 || Hq % Hkv != 0 ||
      num_blocks <= 0 || blk <= 0 || max_blocks <= 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaGetLastError();
  const float scale = (float)(1.0 / sqrt((double)hd));
  const size_t smem =
      (size_t)paged_decode_smem_bytes(Hq, Hkv, hd, blk, max_blocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, kpool, vpool, tbl, kv_len, out, B, Hq,
                                 Hkv, hd, num_blocks, blk, max_blocks, scale,
                                 smem, s);
  return launch<float>(q, kpool, vpool, tbl, kv_len, out, B, Hq, Hkv, hd,
                       num_blocks, blk, max_blocks, scale, smem, s);
}

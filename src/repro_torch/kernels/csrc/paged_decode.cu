// Paged (block-table) GQA attention for Hopper (sm_90a): W new query
// positions per row (W = 1: a decode step; W = 1 + k: the speculative
// verify of a pending token and k draft proposals) against that row's KV
// blocks in the shared pool.
//
// Replaces two Pallas TPU kernels, with one kernel body:
//   paged_flash_decode (src/repro/kernels/flash_decode/ops.py:150, kernel
//   body _paged_kernel at :97, pallas_call at :193), and
//   paged_flash_verify (ops.py:257, kernel body _paged_verify_kernel at
//   :208, pallas_call at :306).
//
// What bounds it on an H100: bytes.  Each (row, KV head) reads its live
// K and V once — 2 * kv_len * hd * sizeof(T) — and does 4 * W * G * hd
// FLOPs per key, far below the ~295 FLOP/byte ridge.  The least time is
// the live KV bytes over 3.35 TB/s.
//
// Design ("W rides in the q tile", as on the TPU): one thread block per
// (row b, KV head h); the W x G query rows of that KV head (G = Hq/Hkv)
// share every K/V load, and position t masks at its own frontier
// kv_len - W + t + 1.  The block loads its row's kv_len and block-table
// entries itself (the TPU kernel took them through scalar prefetch) and
// walks only the live blocks: nothing builds the gathered
// (B, max_blocks*block_tokens, Hkv, hd) view.  Pass 1 writes each query
// row's float32 scores, scaled by 1/sqrt(hd), into dynamic shared memory
// (W x 3 x 512 x 4 B = 30 KB at smollm's G = 3, max_seq 512, W = 5), one
// warp per key.  Then each row of scores takes its exact max and sum over
// its frontier — one final float32 softmax, as the reference's op order
// (ops.py:129-138) — and the probabilities are rounded to the value
// dtype.  Pass 2 reads the live V blocks once more and accumulates P.V in
// float32.  Decode is the W = 1 case of the same code, so every query row
// runs the same loops in the same order whatever W is: verify position t
// equals a decode step at kv_len - W + t + 1 bitwise.  A row whose
// frontier is <= 0 writes exact zeros; a frontier beyond the table is
// clamped to it.  Freed scheduler slots run at pos 0 against an all-zero
// table row: they read the trash block 0, which always exists.  Table
// entries are clamped into the pool, so a bad table cannot fault.  An
// online softmax would save the score buffer but diverged from the
// reference by ~4e-3 in bf16 on the TPU.

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

// Keys position t of the W new entries attends to: k < kv_len - W + t + 1,
// clamped into [0, S] (decode is W = 1: k < kv_len).
__device__ __forceinline__ int frontier(int kvl, int W, int t, int S) {
  return min(max(kvl - W + t + 1, 0), S);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
paged_attn_kernel(const T* __restrict__ q, const T* __restrict__ kpool,
                  const T* __restrict__ vpool, const int* __restrict__ tbl,
                  const int* __restrict__ kv_len, T* __restrict__ out, int W,
                  int Hq, int Hkv, int hd, int num_blocks, int blk,
                  int max_blocks, float scale) {
  extern __shared__ float smem[];
  const int G = Hq / Hkv;
  const int R = W * G;               // query rows: row = t * G + g
  const int S = max_blocks * blk;    // table capacity in tokens
  float* qs = smem;                  // [R][hd] query rows
  float* ps = smem + R * hd;         // [R][S] scores, then probabilities

  const int b = blockIdx.x / Hkv;
  const int h = blockIdx.x % Hkv;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int kvl = kv_len[b];
  // q and out are (B, W, Hq, hd): row (t, g) is head h*G + g of position
  // t, at element ((b*W + t)*Hq + h*G + g)*hd
  const size_t head0 = (size_t)b * W * Hq + (size_t)h * G;

  for (int i = tid; i < R * hd; i += THREADS) {
    const int row = i / hd;
    const int t = row / G;
    qs[i] = to_f(q[(head0 + (size_t)t * Hq + (row - t * G)) * hd + i % hd]);
  }
  __syncthreads();

  const int* trow = tbl + (size_t)b * max_blocks;
  const size_t tok_stride = (size_t)Hkv * hd;   // one token in the pool
  const int L_max = frontier(kvl, W, W - 1, S); // the last position's

  // pass 1: scores, one warp per key, lanes split head_dim; key k is seen
  // by the positions t >= k - kvl + W (k < L_max <= S), i.e. the rows
  // from (k - kvl + W) * G on
  for (int k = warp; k < L_max; k += WARPS) {
    const int phys = min(max(trow[k / blk], 0), num_blocks - 1);
    const T* kr = kpool + ((size_t)phys * blk + k % blk) * tok_stride +
                  (size_t)h * hd;
    float kreg[MAX_HD / 32];
#pragma unroll
    for (int i = 0; i < MAX_HD / 32; ++i) {
      const int d = lane + 32 * i;
      kreg[i] = d < hd ? to_f(kr[d]) : 0.f;
    }
    for (int row = max(k - kvl + W, 0) * G; row < R; ++row) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < MAX_HD / 32; ++i) {
        const int d = lane + 32 * i;
        if (d < hd) part = fmaf(qs[row * hd + d], kreg[i], part);
      }
      part = warp_sum(part);
      if (lane == 0) ps[row * S + k] = part * scale;
    }
  }
  __syncthreads();

  // one float32 softmax per query row over the keys of its frontier;
  // masked keys of the reference contribute exp(NEG_INF - max) == 0
  for (int row = warp; row < R; row += WARPS) {
    const int L = frontier(kvl, W, row / G, S);
    float* pr = ps + row * S;
    float mx = -INFINITY;
    for (int k = lane; k < L; k += 32) mx = fmaxf(mx, pr[k]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int k = lane; k < L; k += 32) {
      const float e = expf(pr[k] - mx);
      pr[k] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int k = lane; k < L; k += 32)
      pr[k] = to_f(from_f<T>(pr[k] / sum));   // probs in the value dtype
  }
  __syncthreads();

  // pass 2: out[row, d] = sum_k p[row, k] * v[k, d], float32 accumulation;
  // a row whose frontier is 0 sums nothing and writes exact zeros
  for (int i = tid; i < R * hd; i += THREADS) {
    const int row = i / hd;
    const int d = i % hd;
    const int t = row / G;
    const int L = frontier(kvl, W, t, S);
    const float* pr = ps + row * S;
    float acc = 0.f;
    for (int k = 0; k < L; ++k) {
      const int phys = min(max(trow[k / blk], 0), num_blocks - 1);
      const T* vr = vpool + ((size_t)phys * blk + k % blk) * tok_stride +
                    (size_t)h * hd;
      acc = fmaf(pr[k], to_f(vr[d]), acc);
    }
    out[(head0 + (size_t)t * Hq + (row - t * G)) * hd + d] = from_f<T>(acc);
  }
}

template <typename T>
int launch(const void* q, const void* kpool, const void* vpool,
           const void* tbl, const void* kv_len, void* out, int B, int W,
           int Hq, int Hkv, int hd, int num_blocks, int blk, int max_blocks,
           float scale, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_attn_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  paged_attn_kernel<T><<<B * Hkv, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kpool),
      static_cast<const T*>(vpool), static_cast<const int*>(tbl),
      static_cast<const int*>(kv_len), static_cast<T*>(out), W, Hq, Hkv, hd,
      num_blocks, blk, max_blocks, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q: (B, W, Hq, hd) — W = 1 is a decode step, W > 1 the speculative
// verify of W new positions whose K/V are already in the pool at
// kv_len - W .. kv_len - 1; kpool/vpool: (num_blocks, blk, Hkv, hd); tbl:
// (B, max_blocks) int32; kv_len: (B,) int32, the TOTAL length including
// the W new entries; out: (B, W, Hq, hd).  All contiguous; q/pools/out
// share one dtype (is_bf16: bfloat16, else float32).  Shared memory is
// W * (Hq / Hkv) * (hd + max_blocks * blk) * 4 bytes; the wrapper checks it
// against the 227 KB a block may use.  Returns cudaGetLastError() after
// the launch.
extern "C" int paged_attn_fwd(const void* q, const void* kpool,
                              const void* vpool, const void* tbl,
                              const void* kv_len, void* out, int B, int W,
                              int Hq, int Hkv, int hd, int num_blocks,
                              int blk, int max_blocks, int is_bf16,
                              void* stream) {
  if (W <= 0 || hd <= 0 || hd > MAX_HD || Hkv <= 0 || Hq % Hkv != 0 ||
      num_blocks <= 0 || blk <= 0 || max_blocks <= 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaGetLastError();
  const float scale = (float)(1.0 / sqrt((double)hd));
  const size_t smem = (size_t)W * (Hq / Hkv) *
                      (hd + (size_t)max_blocks * blk) * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, kpool, vpool, tbl, kv_len, out, B, W, Hq,
                                 Hkv, hd, num_blocks, blk, max_blocks, scale,
                                 smem, s);
  return launch<float>(q, kpool, vpool, tbl, kv_len, out, B, W, Hq, Hkv, hd,
                       num_blocks, blk, max_blocks, scale, smem, s);
}

// Paged (block-table) absorbed-latent MLA attention for Hopper (sm_90a):
// W new query positions per row (W = 1: a decode step; W = 1 + k: the
// speculative verify of a pending token and k draft proposals) against
// that row's compressed latent cache (c_kv and the shared rope key) in
// the block pool.
//
// Replaces two Pallas TPU kernels, with one kernel body:
//   paged_flash_decode_mla (src/repro/kernels/flash_decode/ops.py:367,
//   kernel body _paged_mla_kernel at :322, pallas_call at :412), and
//   paged_flash_verify_mla (ops.py:473, kernel body
//   _paged_mla_verify_kernel at :428, pallas_call at :521).
//
// Computes, for each row b, position t and query head h over the keys
// k < kv_len - W + t + 1 (position t's causal frontier):
//   s[h][k] = (dot(q_lat[t][h], ckv[k]) + dot(q_rope[t][h], krope[k])) * scale
//   p[h][:] = softmax(s[h][:]) in float32, rounded to the cache dtype
//   ctx[t][h][:] = sum_k p[h][k] * ckv[k][:]
// the reference's op order (ops.py:343-363, layers.py:294-307).  The
// caller applies Wv_b and wo.
//
// What bounds it on an H100: at full width (128 heads, r = 512, rh = 64)
// a key costs 128 * (2 * 576 + 2 * 512) ~ 279 KFLOP per position against
// 1152 B of latent in bf16: ~242 FLOP/B, near the card's ~295 FLOP/B bf16
// ridge (W = 5 positions: ~1200 FLOP/B, above it).  The least time is
// therefore the larger of the bytes (live latent once + q + out) over
// 3.35 TB/s and the FLOPs over 989 TFLOP/s.  This kernel runs float32 FMAs
// on the CUDA cores, not the tensor cores, so it is far from that bound;
// mma/wgmma and TMA are later work.
//
// Why the TPU layout is not copied: the TPU kernel keeps all (padded)
// heads' scores and a float32 copy of the whole latent cache in VMEM,
// (Hp, max_seq) + (max_seq, r) float32 = 256 KB + 1 MB at max_seq 512,
// beyond the 227 KB of shared memory a Hopper block may use.  Its verify
// puts all W positions in one tile; here a 16-head tile of one position
// already takes ~70 KB, W = 5 of them ~348 KB.
//
// Design: one thread block per (row b, position t, tile of HT = 16 query
// heads); the last tile of a position is masked when H is not a multiple
// of HT.  Decode is the W = 1 case: every block runs the same body at its
// position's frontier, so verify position t equals a decode step at
// kv_len - W + t + 1 bitwise.  The cost of that simplicity: the W blocks of
// a row each re-read the live latent (through L2); sharing each streamed
// block across the W positions, as the TPU kernel does, is later work.
// The block loads its row's kv_len and table entries itself (the TPU
// kernel took them through scalar prefetch), clamps table entries into the
// pool, and walks only the live blocks: nothing builds the gathered
// (B, max_seq, r) view.  Shared memory holds the tile's float32 queries
// (HT x (r + rh)) and its float32 scores (HT x max_seq): 36 KB + 32 KB at
// full width.  Pass 1: one warp per key; each lane keeps r/32 latent and
// rh/32 rope values of the key in registers and the warp reduces one dot
// product per head.  Softmax: one warp per head, exact max and sum,
// probabilities rounded to the cache dtype.  Pass 2: re-read the live c_kv
// rows (the tiles of a row share them through L2); each thread owns latent
// columns and keeps HT float32 accumulators per column, so each latent
// value is loaded once per block.  A frontier <= 0 writes exact zeros; a
// frontier beyond the table is clamped to it.  Freed scheduler slots run at
// pos 0 against an all-zero table row and read the trash block 0, which
// always exists.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int HT = 16;                     // query heads per block
constexpr int MAX_R = 512;                 // latent rank: 16 values per lane
constexpr int MAX_RH = 128;                // rope width: 4 values per lane
constexpr int COLS = (MAX_R + THREADS - 1) / THREADS;  // pass-2 columns

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
paged_mla_decode_kernel(const T* __restrict__ q_lat,
                        const T* __restrict__ q_rope,
                        const T* __restrict__ ckv,
                        const T* __restrict__ krope,
                        const int* __restrict__ tbl,
                        const int* __restrict__ kv_len, T* __restrict__ out,
                        int W, int H, int r, int rh, int num_blocks, int blk,
                        int max_blocks, float scale) {
  extern __shared__ float smem[];
  const int S = max_blocks * blk;          // table capacity in tokens
  float* ql = smem;                        // [HT][r]  latent queries
  float* qr = ql + HT * r;                 // [HT][rh] rope queries
  float* ps = qr + HT * rh;                // [HT][S]  scores, then probs

  const int tiles = (H + HT - 1) / HT;
  const int bt = blockIdx.x / tiles;       // (row b, position t) = bt
  const int b = bt / W;
  const int t_pos = bt % W;
  const int h0 = (blockIdx.x % tiles) * HT;
  const int nh = min(HT, H - h0);          // live heads of this tile
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const size_t head0 = (size_t)bt * H + h0;  // q/out are (B, W, H, r|rh)
  T* o = out + head0 * r;

  // position t attends to keys < kv_len - W + t + 1 (decode, W = 1:
  // keys < kv_len), clamped into the table
  const int L = min(max(kv_len[b] - W + t_pos + 1, 0), S);
  if (L == 0) {
    for (int i = tid; i < nh * r; i += THREADS) o[i] = from_f<T>(0.f);
    return;
  }
  for (int i = tid; i < nh * r; i += THREADS)
    ql[i] = to_f(q_lat[head0 * r + i]);
  for (int i = tid; i < nh * rh; i += THREADS)
    qr[i] = to_f(q_rope[head0 * rh + i]);
  __syncthreads();

  const int* trow = tbl + (size_t)b * max_blocks;

  // pass 1: scores, one warp per key, lanes split the latent and rope dims
  for (int t = warp; t < L; t += WARPS) {
    const int phys = min(max(trow[t / blk], 0), num_blocks - 1);
    const size_t tok = (size_t)phys * blk + t % blk;
    const T* cr = ckv + tok * r;
    const T* kr = krope + tok * rh;
    float creg[MAX_R / 32];
    float kreg[MAX_RH / 32];
#pragma unroll
    for (int i = 0; i < MAX_R / 32; ++i) {
      const int d = lane + 32 * i;
      creg[i] = d < r ? to_f(cr[d]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < MAX_RH / 32; ++i) {
      const int d = lane + 32 * i;
      kreg[i] = d < rh ? to_f(kr[d]) : 0.f;
    }
    for (int h = 0; h < nh; ++h) {
      float s_lat = 0.f, s_rope = 0.f;
#pragma unroll
      for (int i = 0; i < MAX_R / 32; ++i) {
        const int d = lane + 32 * i;
        if (d < r) s_lat = fmaf(ql[h * r + d], creg[i], s_lat);
      }
#pragma unroll
      for (int i = 0; i < MAX_RH / 32; ++i) {
        const int d = lane + 32 * i;
        if (d < rh) s_rope = fmaf(qr[h * rh + d], kreg[i], s_rope);
      }
      s_lat = warp_sum(s_lat);
      s_rope = warp_sum(s_rope);
      if (lane == 0) ps[h * S + t] = (s_lat + s_rope) * scale;
    }
  }
  __syncthreads();

  // one float32 softmax per query head over the live keys; masked keys of
  // the reference contribute exp(NEG_INF - max) == 0 to its sum
  for (int h = warp; h < nh; h += WARPS) {
    float* pr = ps + h * S;
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
      pr[t] = to_f(from_f<T>(pr[t] / sum));   // probs in the cache dtype
  }
  __syncthreads();

  // pass 2: ctx[h][d] = sum_t p[h][t] * ckv[t][d], float32 accumulation;
  // thread tid owns columns d = tid + THREADS * j
  float acc[COLS][HT];
#pragma unroll
  for (int j = 0; j < COLS; ++j)
#pragma unroll
    for (int h = 0; h < HT; ++h) acc[j][h] = 0.f;
  for (int t = 0; t < L; ++t) {
    const int phys = min(max(trow[t / blk], 0), num_blocks - 1);
    const T* cr = ckv + ((size_t)phys * blk + t % blk) * r;
    float c[COLS];
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      const int d = tid + THREADS * j;
      c[j] = d < r ? to_f(cr[d]) : 0.f;
    }
#pragma unroll
    for (int h = 0; h < HT; ++h) {
      if (h < nh) {
        const float p = ps[h * S + t];
#pragma unroll
        for (int j = 0; j < COLS; ++j) acc[j][h] = fmaf(p, c[j], acc[j][h]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < COLS; ++j) {
    const int d = tid + THREADS * j;
    if (d < r) {
#pragma unroll
      for (int h = 0; h < HT; ++h)
        if (h < nh) o[(size_t)h * r + d] = from_f<T>(acc[j][h]);
    }
  }
}

template <typename T>
int launch(const void* q_lat, const void* q_rope, const void* ckv,
           const void* krope, const void* tbl, const void* kv_len, void* out,
           int B, int W, int H, int r, int rh, int num_blocks, int blk,
           int max_blocks, float scale, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_mla_decode_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int tiles = (H + HT - 1) / HT;
  paged_mla_decode_kernel<T><<<B * W * tiles, THREADS, smem, stream>>>(
      static_cast<const T*>(q_lat), static_cast<const T*>(q_rope),
      static_cast<const T*>(ckv), static_cast<const T*>(krope),
      static_cast<const int*>(tbl), static_cast<const int*>(kv_len),
      static_cast<T*>(out), W, H, r, rh, num_blocks, blk, max_blocks, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q_lat: (B, W, H, r); q_rope: (B, W, H, rh) — W = 1 is a decode step,
// W > 1 the speculative verify of W new positions whose latents are
// already in the pool at kv_len - W .. kv_len - 1; ckv: (num_blocks, blk,
// r); krope: (num_blocks, blk, rh); tbl: (B, max_blocks) int32; kv_len:
// (B,) int32, the TOTAL length including the W new entries; out:
// (B, W, H, r).  All contiguous; queries, pools and out share one dtype
// (is_bf16: bfloat16, else float32).  Returns cudaGetLastError() after the
// launch.
extern "C" int paged_mla_fwd(const void* q_lat, const void* q_rope,
                             const void* ckv, const void* krope,
                             const void* tbl, const void* kv_len, void* out,
                             int B, int W, int H, int r, int rh,
                             int num_blocks, int blk, int max_blocks,
                             int is_bf16, float scale, void* stream) {
  if (W <= 0 || H <= 0 || r <= 0 || r > MAX_R || rh <= 0 || rh > MAX_RH ||
      num_blocks <= 0 || blk <= 0 || max_blocks <= 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaGetLastError();
  const size_t smem =
      (size_t)HT * (r + rh + (size_t)max_blocks * blk) * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(q_lat, q_rope, ckv, krope, tbl, kv_len, out,
                                 B, W, H, r, rh, num_blocks, blk, max_blocks,
                                 scale, smem, s);
  return launch<float>(q_lat, q_rope, ckv, krope, tbl, kv_len, out, B, W, H,
                       r, rh, num_blocks, blk, max_blocks, scale, smem, s);
}

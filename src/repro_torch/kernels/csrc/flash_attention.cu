// Flash attention forward for Hopper (sm_90a): tiled online-softmax GQA
// attention with causal, sliding-window, per-batch length masks and a
// query offset.
//
// Replaces: the Pallas TPU kernel flash_attention_folded
//   (src/repro/kernels/flash_attention/flash_attention.py:102, pallas_call
//   at :144; wrapper src/repro/kernels/flash_attention/ops.py:23).
//
// What bounds it on an H100: at the fleet's prefill shapes (B=1, S<=479,
// 15 query heads over 5 KV heads, head_dim 64) the work is
// ~4*hd*S^2/2*Hq FLOPs against ~S*(Hq+2*Hkv)*hd*2 bytes of q/k/v/out, so
// the tensor-core roofline would be compute; this first version runs its
// products as float32 FMAs on the CUDA cores (67 TFLOP/s peak, not the
// tensor cores' 989) and is bounded by that and by its low occupancy.
//
// Design: one thread block per (b*Hq + h, tile of BQ query rows), one
// thread per query row.  The KV head is h / (Hq/Hkv), as in the TPU
// kernel's index map.  The block walks BK-key tiles of K and V through
// shared memory (widened to float32 on load); each thread keeps its query
// row and its output accumulator in registers and carries the running
// max / sum of the online softmax, exactly as the TPU kernel carries
// (m, l, acc) across its sequential KV grid axis.  Tiles that causality
// or the window mask out entirely are never loaded; the rest are masked
// per element by causal, window, lens and q_offset.  A query row with no
// visible key writes zeros (l == 0), like the TPU kernel.  Output is
// written in the input dtype.  mma.sync / wgmma and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;             // query rows per block (one per thread)
constexpr int BK = 32;             // keys per shared-memory tile
constexpr float M_INIT = -1e30f;   // running-max start, as the TPU kernel

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

// HDP: head_dim rounded up to the instantiated width (64 or 128); lanes
// d >= hd hold zeros, so the unrolled loops keep q and acc in registers.
template <typename T, int HDP>
__global__ void __launch_bounds__(BQ)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const int* __restrict__ lens,
                       T* __restrict__ out, int Sq, int Skv, int Hq, int Hkv,
                       int hd, int causal, int window, int q_offset,
                       float scale) {
  __shared__ float ks[BK][HDP];
  __shared__ float vs[BK][HDP];
  __shared__ float ss[BQ][BK + 1];   // +1: conflict-free per-row columns

  const int bh = blockIdx.x;
  const int b = bh / Hq;
  const int h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x;
  const int q_lo = blockIdx.y * BQ;
  const int row = q_lo + tid;
  const bool live = row < Sq;
  const int qpos = row + q_offset;   // absolute position of this query

  // keys this tile of queries can see at all (whole-tile skipping)
  int kv_len = Skv;
  if (lens != nullptr) kv_len = min(Skv, max(lens[b], 0));
  int k_end = kv_len;
  if (causal) k_end = min(k_end, min(q_lo + BQ, Sq) - 1 + q_offset + 1);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q_lo + q_offset - window + 1);
  k_begin = (k_begin / BK) * BK;

  float qr[HDP];
  float acc[HDP];
  const size_t q_off = ((size_t)(b * Sq + row) * Hq + h) * hd;
#pragma unroll
  for (int d = 0; d < HDP; ++d) {
    qr[d] = (live && d < hd) ? to_f(q[q_off + d]) : 0.f;
    acc[d] = 0.f;
  }
  float m = M_INIT;
  float l = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();                 // the previous tile is consumed
    for (int i = tid; i < BK * HDP; i += BQ) {
      const int j = i / HDP;
      const int d = i % HDP;
      const int key = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (key < Skv && d < hd) {
        const size_t off = ((size_t)(b * Skv + key) * Hkv + hk) * hd + d;
        kv = to_f(k[off]);
        vv = to_f(v[off]);
      }
      ks[j][d] = kv;
      vs[j][d] = vv;
    }
    __syncthreads();

    float tile_max = -INFINITY;
    for (int j = 0; j < BK; ++j) {
      const int key = k0 + j;
      bool ok = live && key < kv_len;
      if (causal) ok = ok && key <= qpos;
      if (window > 0) ok = ok && key > qpos - window;
      float s = -INFINITY;           // masked: exp() gives exactly 0
      if (ok) {
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < HDP; ++d) dot = fmaf(qr[d], ks[j][d], dot);
        s = dot * scale;
      }
      ss[tid][j] = s;
      tile_max = fmaxf(tile_max, s);
    }
    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);
    float l_tile = 0.f;
#pragma unroll
    for (int d = 0; d < HDP; ++d) acc[d] *= alpha;
    for (int j = 0; j < BK; ++j) {
      const float p = expf(ss[tid][j] - m_new);
      l_tile += p;
#pragma unroll
      for (int d = 0; d < HDP; ++d) acc[d] = fmaf(p, vs[j][d], acc[d]);
    }
    l = l * alpha + l_tile;
    m = m_new;
  }

  if (!live) return;
  const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
  for (int d = 0; d < HDP; ++d)
    if (d < hd) out[q_off + d] = from_f<T>(acc[d] * inv);
}

template <typename T, int HDP>
void launch(const void* q, const void* k, const void* v, const void* lens,
            void* out, int B, int Sq, int Skv, int Hq, int Hkv, int hd,
            int causal, int window, int q_offset, float scale,
            cudaStream_t stream) {
  dim3 grid(B * Hq, (Sq + BQ - 1) / BQ);
  flash_attention_kernel<T, HDP><<<grid, BQ, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(lens),
      static_cast<T*>(out), Sq, Skv, Hq, Hkv, hd, causal, window, q_offset,
      scale);
}

}  // namespace

// q: (B, Sq, Hq, hd), k/v: (B, Skv, Hkv, hd), out: (B, Sq, Hq, hd), all
// contiguous in one dtype (is_bf16: bfloat16, else float32); lens: (B,)
// int32 or null.  Returns cudaGetLastError() after the launch.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, const void* lens,
                                   void* out, int B, int Sq, int Skv, int Hq,
                                   int Hkv, int hd, int causal, int window,
                                   int q_offset, int is_bf16, void* stream) {
  if (hd <= 0 || hd > 128 || Hkv <= 0 || Hq % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0) return (int)cudaGetLastError();
  const float scale = (float)(1.0 / sqrt((double)hd));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (hd <= 64)
      launch<__nv_bfloat16, 64>(q, k, v, lens, out, B, Sq, Skv, Hq, Hkv, hd,
                                causal, window, q_offset, scale, s);
    else
      launch<__nv_bfloat16, 128>(q, k, v, lens, out, B, Sq, Skv, Hq, Hkv, hd,
                                 causal, window, q_offset, scale, s);
  } else {
    if (hd <= 64)
      launch<float, 64>(q, k, v, lens, out, B, Sq, Skv, Hq, Hkv, hd, causal,
                        window, q_offset, scale, s);
    else
      launch<float, 128>(q, k, v, lens, out, B, Sq, Skv, Hq, Hkv, hd, causal,
                         window, q_offset, scale, s);
  }
  return (int)cudaGetLastError();
}

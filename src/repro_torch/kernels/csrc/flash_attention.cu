// Flash attention forward for Hopper (sm_90a): online-softmax GQA
// attention with causal, sliding-window, per-batch length masks and a
// query offset.
//
// Replaces: the Pallas TPU kernel flash_attention_folded
//   (src/repro/kernels/flash_attention/flash_attention.py:102, pallas_call
//   at :144; wrapper src/repro/kernels/flash_attention/ops.py:23).
//
// What bounds it on an H100: at the fleet's prefill shapes (B=1, S<=479,
// 15 query heads over 5 KV heads, head_dim 64) the bytes (q, k, v and out
// once, ~0.73 us at 3.35 TB/s) outweigh the causal FLOPs (~0.45 us at
// 989 TFLOP/s bf16), and both are far below what the card really waits
// on: latency — the launch, the Q load, and up to 8 key tiles that the
// last query tile walks in series.  Measured, the time tracks the
// instructions each SM issues for the heaviest tile, so the design spreads
// that tile over 8 warps and keeps its whole K/V stream in flight.
//
// Design of the bfloat16 body (the one the fleets run): one CTA of 8 warps
// per (query tile of TQ = 64 rows, query head h, row b), the q tiles
// launched in reverse so the heaviest causal tiles start first.  The KV
// head is h / (Hq/Hkv), as in the TPU kernel's index map.  Warps 2w and
// 2w + 1 share the 16 query rows of row warp w (the M of
// mma.sync.m16n8k16) and split each 128-key stage into two 64-key halves.
//   1. Q and the first stages of 128 keys of K and V are issued as
//      cp.async copies (16 bytes a thread; bf16 as stored, never widened)
//      into dynamic shared memory, rows padded by 16 bytes so ldmatrix is
//      free of bank conflicts and head_dim zero-padded to 32, 64 or 128.
//      The ring holds 5 stages where head_dim <= 64 (the fleet's longest
//      prefill, 479 keys, is in flight at once) and 3 at 128.  Rows past
//      the end (queries >= Sq, keys >= the row's visible length) are
//      zero-filled with cp.async src-size 0: 0 x NaN from stale shared
//      memory would poison P.V.  A head_dim whose row is not a multiple of
//      16 bytes (hd 20 in bf16) takes scalar loads into the same layout.
//   2. Each warp loads its Q rows once into A fragments (ldmatrix), then
//      walks its halves of the stages, one barrier a stage: S = Q.K^T on
//      mma.sync (float32 accumulate; a k-step's K fragments loaded
//      together, the next k-step's during this one's mma), masked per
//      element only on tiles that cross a causal, window or length edge;
//      the running max and sum of the online softmax live in registers
//      (quad shuffles for the row max, O rescaled only when a row's max
//      moved); p = 2^(s * log2(e)/sqrt(hd) - m) in float32 is summed
//      unrounded into l, converted to bf16 A fragments in registers (S's
//      accumulator layout is P.V's A layout), and O += P.V runs on
//      mma.sync with V through ldmatrix.trans.  A warp skips tiles its 16
//      rows cannot see.
//   3. The second warp of each pair hands its (m, l, O) to the first
//      through shared memory, which merges them; out = O / max(l, 1e-30)
//      in the input dtype: a query row that sees no key writes zeros
//      (l == 0), like the TPU kernel.
// Whole stages that causality, the window or lens mask out are never
// loaded; a CTA that sees no key at all writes zeros and returns.  The
// bf16 rounding of the unnormalised p differs from the plain version's
// rounding of the normalised probabilities by about one bf16 ulp.
//
// The float32 body keeps the first version's design (one thread per query
// row, K/V tiles in shared memory, FMA chains on the CUDA cores, no TF32):
// the reduced float32 fleets run it and must equal the CPU token for token.
// wgmma, TMA and warp specialisation are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float M_INIT = -1e30f;   // running-max start, as the TPU kernel

// ---------------------------------------------------------------------------
// bfloat16 body: tensor-core tiles over a cp.async K/V ring
// ---------------------------------------------------------------------------

constexpr int TQ = 64;             // query rows per CTA: 4 row warps x 16
constexpr int KSPLIT = 2;          // warp groups splitting each stage's keys
constexpr int TK = 64;             // keys per warp and stage
constexpr int SK = TK * KSPLIT;    // keys per ring stage
constexpr int THREADS = 128 * KSPLIT;
constexpr int PAD = 8;             // bf16 padding per shared row (16 bytes)

// head_dim rounded up to the instantiated width (32, 64 or 128)
__host__ __device__ constexpr int head_pad(int hd) {
  return hd <= 32 ? 32 : hd <= 64 ? 64 : 128;
}
// Ring stages: all four stages of the fleet's longest prefill (479 keys)
// in flight at once where head_dim <= 64; three at 128, where five would
// not fit in shared memory.
__host__ __device__ constexpr int ring_stages(int hdp) {
  return hdp <= 64 ? 5 : 3;
}
// Shared-memory carve of one CTA, in bytes: Q [TQ] then the K ring and
// the V ring [stages][SK], each row head_pad + PAD bf16.  ops.py:
// flash_geometry is the same formula; the entry point refuses a launch
// given less.
__host__ __device__ constexpr size_t tc_smem(int hdp) {
  return (size_t)(TQ + 2 * ring_stages(hdp) * SK) * (hdp + PAD) * 2;
}

using bf16 = __nv_bfloat16;

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// every copy group but the newest STAGES - 2 has landed
template <int STAGES>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const bf16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const bf16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// D = A (16x16 bf16, row) * B (16x8 bf16, col) + D, float32 accumulate
__device__ __forceinline__ void mma_16816(float* d, const uint32_t* a,
                                          const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
// 2^x (ex2.approx, flush-to-zero): 2^-inf is exactly 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Copies rows [row0, min(row0 + NROWS, n_read)) of head_dim hd, row r at
// src + r * row_stride, into dst (shared, HDP + PAD elements a row); rows
// at or beyond n_valid are zero-filled.  Rows from n_read on, which no warp
// reads, and columns [hd, HDP + PAD) are left as they are.  The 16-byte
// copies walk a compile-time grid of HDP / 8 chunks a row (shifts, not
// divisions) and skip the chunks past hd.
template <int HDP, int NROWS>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          int row0, int n_valid, int n_read,
                                          size_t row_stride, int hd,
                                          bool vec) {
  constexpr int STRIDE = HDP + PAD;
  constexpr int CPR = HDP / 8;     // 16-byte chunks a padded row
  const int n_rows = min(NROWS, n_read - row0);
  if (vec) {
    const int nv = hd / 8;
    const bf16* base = src + (size_t)row0 * row_stride;
#pragma unroll
    for (int j = 0; j < (NROWS * CPR + THREADS - 1) / THREADS; ++j) {
      const int i = threadIdx.x + j * THREADS;
      const int r = i / CPR, c = i % CPR;
      if (r >= n_rows || c >= nv) continue;
      bf16* d = dst + r * STRIDE + c * 8;
      if (row0 + r < n_valid)
        cp_async16(d, base + (size_t)r * row_stride + c * 8, 16);
      else
        cp_async16(d, src, 0);
    }
  } else {
    for (int i = threadIdx.x; i < n_rows * hd; i += THREADS) {
      const int r = i / hd, c = i - r * hd;
      const int row = row0 + r;
      dst[r * STRIDE + c] = row < n_valid ? src[(size_t)row * row_stride + c]
                                          : __float2bfloat16(0.f);
    }
  }
}

template <int HDP>
__global__ void __launch_bounds__(THREADS)
flash_attention_tc_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v,
                          const int* __restrict__ lens,
                          bf16* __restrict__ out, int Sq, int Skv, int Hq,
                          int Hkv, int hd, int causal, int window,
                          int q_offset, float scale_log2, int vec) {
  constexpr int STAGES = ring_stages(HDP);
  constexpr int STRIDE = HDP + PAD;
  constexpr int KS_D = HDP / 16;   // k-steps of S = Q.K^T over head_dim
  constexpr int NT_D = HDP / 8;    // 8-column tiles of O
  constexpr int NT_K = TK / 8;     // 8-key tiles of S
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + TQ * STRIDE;
  bf16* vs = ks + STAGES * SK * STRIDE;

  const int qt = gridDim.x - 1 - blockIdx.x;   // heaviest tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x;
  // warps KSPLIT*w .. KSPLIT*w + KSPLIT - 1 (on different sub-partitions
  // of the SM) share the 16 rows of row warp w, group kh taking keys
  // [kh*TK, (kh+1)*TK) of each stage
  const int warp = (tid / 32) / KSPLIT;
  const int kh = (tid / 32) % KSPLIT;
  const int lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;
  const int q_lo = qt * TQ;
  const int q_last = min(q_lo + TQ, Sq) - 1;

  // keys this tile of queries can see at all (whole-tile skipping)
  int kv_len = Skv;
  if (lens != nullptr) kv_len = min(Skv, max(lens[b], 0));
  int k_end = kv_len;
  if (causal) k_end = min(k_end, q_last + q_offset + 1);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q_lo + q_offset - window + 1);
  k_begin = (k_begin / TK) * TK;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + SK - 1) / SK : 0;

  const size_t q_stride = (size_t)Hq * hd;     // one query row
  const size_t kv_stride = (size_t)Hkv * hd;   // one key row
  const bf16* qb = q + (size_t)b * Sq * q_stride + (size_t)h * hd;
  bf16* ob = out + (size_t)b * Sq * q_stride + (size_t)h * hd;
  const bf16* kb = k + (size_t)b * Skv * kv_stride + (size_t)hk * hd;
  const bf16* vb = v + (size_t)b * Skv * kv_stride + (size_t)hk * hd;
  const int r0 = q_lo + warp * 16 + g;         // this thread's rows r0, r0+8

  if (n_tiles == 0) {              // no query of the tile sees a key
    for (int i = tid; i < TQ * hd; i += THREADS) {
      const int r = i / hd, c = i - r * hd;
      if (q_lo + r < Sq)
        ob[(size_t)(q_lo + r) * q_stride + c] = __float2bfloat16(0.f);
    }
    return;
  }

  // zeros in the padding columns [hd, HDP) of Q and of every ring stage;
  // the loads never write there
  const int padw = HDP - hd;
  for (int i = tid; i < (TQ + 2 * STAGES * SK) * padw; i += THREADS) {
    const int r = i / padw;
    qs[r * STRIDE + hd + (i - r * padw)] = __float2bfloat16(0.f);
  }

  // Q and the first STAGES - 1 K/V tiles; Q lands with tile 0's group
  // keys any warp reads: up to k_end rounded up to a warp's TK keys
  const int k_read = k_begin + (k_end - k_begin + TK - 1) / TK * TK;
  load_rows<HDP, TQ>(qs, qb, q_lo, Sq, q_lo + TQ, q_stride, hd, vec);
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_tiles) {
      load_rows<HDP, SK>(ks + s * SK * STRIDE, kb, k_begin + s * SK, kv_len,
                         k_read, kv_stride, hd, vec);
      load_rows<HDP, SK>(vs + s * SK * STRIDE, vb, k_begin + s * SK, kv_len,
                         k_read, kv_stride, hd, vec);
    }
    cp_commit();
  }

  // keys the warp's 16 rows can see (warp-level tile skipping)
  const int w_first = q_lo + warp * 16;
  const int w_last = min(w_first + 15, Sq - 1);
  const bool w_live = w_first < Sq;
  int wk_end = kv_len;
  if (causal) wk_end = min(wk_end, w_last + q_offset + 1);
  int wk_begin = 0;
  if (window > 0) wk_begin = max(0, w_first + q_offset - window + 1);

  uint32_t qf[KS_D][4];
  float o[NT_D][4];
#pragma unroll
  for (int n = 0; n < NT_D; ++n)
    o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = M_INIT, m1 = M_INIT;  // running max of rows r0, r0 + 8 (log2)
  float l0 = 0.f, l1 = 0.f;        // this thread's share of the row sums

  // ldmatrix lane roles: lanes 8j..8j+7 address the rows of matrix j
  const int lr = lane & 7, lj = lane >> 3;

  for (int i = 0; i < n_tiles; ++i) {
    // tile i has landed, and every warp is past tile i - 1, whose stage
    // the next copy overwrites: one barrier a tile
    cp_wait<STAGES>();
    __syncthreads();
    const int nxt = i + STAGES - 1;
    if (nxt < n_tiles) {
      const int st = nxt % STAGES;
      load_rows<HDP, SK>(ks + st * SK * STRIDE, kb, k_begin + nxt * SK,
                         kv_len, k_read, kv_stride, hd, vec);
      load_rows<HDP, SK>(vs + st * SK * STRIDE, vb, k_begin + nxt * SK,
                         kv_len, k_read, kv_stride, hd, vec);
    }
    cp_commit();
    if (i == 0) {
      // A fragments of Q: matrices (rows 0-7 | 8-15) x (cols 0-7 | 8-15)
#pragma unroll
      for (int kk = 0; kk < KS_D; ++kk)
        ldsm_x4(qf[kk], qs + (warp * 16 + (lj & 1) * 8 + lr) * STRIDE +
                            kk * 16 + (lj >> 1) * 8);
    }
    const int k0 = k_begin + i * SK + kh * TK;
    if (w_live && k0 < wk_end && k0 + TK > wk_begin) {
      const bf16* kt = ks + ((i % STAGES) * SK + kh * TK) * STRIDE;
      const bf16* vt = vs + ((i % STAGES) * SK + kh * TK) * STRIDE;
      float s[NT_K][4];
#pragma unroll
      for (int n = 0; n < NT_K; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      // S = Q.K^T.  One ldmatrix.x4 gives the B fragments of two key
      // tiles; a k-step's four are loaded together, the next k-step's
      // while this one's mma.sync run, so no mma waits on its own load
      uint32_t kf[2][NT_K / 2][4];
#pragma unroll
      for (int np = 0; np < NT_K / 2; ++np)
        ldsm_x4(kf[0][np], kt + (np * 16 + (lj >> 1) * 8 + lr) * STRIDE +
                               (lj & 1) * 8);
#pragma unroll
      for (int kk = 0; kk < KS_D; ++kk) {
        if (kk + 1 < KS_D) {
#pragma unroll
          for (int np = 0; np < NT_K / 2; ++np)
            ldsm_x4(kf[(kk + 1) & 1][np],
                    kt + (np * 16 + (lj >> 1) * 8 + lr) * STRIDE +
                        (kk + 1) * 16 + (lj & 1) * 8);
        }
#pragma unroll
        for (int np = 0; np < NT_K / 2; ++np) {
          mma_16816(s[2 * np], qf[kk], kf[kk & 1][np]);
          mma_16816(s[2 * np + 1], qf[kk], kf[kk & 1][np] + 2);
        }
      }
      // V's B fragments (ldmatrix.trans) of the first k-step land while
      // the softmax runs; VB = 2 buffers prefetch one k-step ahead (one
      // buffer at HDP 128, for registers)
      constexpr int VB = HDP >= 128 ? 1 : 2;
      uint32_t vf[VB][NT_D / 2][4];
#pragma unroll
      for (int dp = 0; dp < NT_D / 2; ++dp)
        ldsm_x4_t(vf[0][dp], vt + ((lj & 1) * 8 + lr) * STRIDE + dp * 16 +
                                 (lj >> 1) * 8);
      // mask where the tile crosses an edge of the warp's rows; the row
      // max is taken on the raw dots (the scale is positive) and the scale
      // rides in the exponent's fma: p = 2^(s * scale_log2 - m)
      const bool edge =
          k0 + TK > kv_len || (causal && k0 + TK - 1 > w_first + q_offset) ||
          (window > 0 && k0 <= w_last + q_offset - window);
      if (edge) {
#pragma unroll
        for (int n = 0; n < NT_K; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + n * 8 + 2 * tq + (e & 1);
            const int qp = r0 + (e >> 1) * 8 + q_offset;
            bool ok = key < kv_len;
            if (causal) ok = ok && key <= qp;
            if (window > 0) ok = ok && key > qp - window;
            if (!ok) s[n][e] = -INFINITY;    // exp2 gives exactly 0
          }
        }
      }
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int n = 0; n < NT_K; ++n) {
        mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
        mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
      }
      const float mn0 = fmaxf(m0, quad_max(mx0) * scale_log2);
      const float mn1 = fmaxf(m1, quad_max(mx1) * scale_log2);
      if (!__all_sync(0xffffffffu, mn0 == m0 && mn1 == m1)) {
        // some row's max moved: rescale its running sum and output
        const float a0 = ex2(m0 - mn0), a1 = ex2(m1 - mn1);
        m0 = mn0;
        m1 = mn1;
        l0 *= a0;
        l1 *= a1;
#pragma unroll
        for (int n = 0; n < NT_D; ++n) {
          o[n][0] *= a0;
          o[n][1] *= a0;
          o[n][2] *= a1;
          o[n][3] *= a1;
        }
      }
#pragma unroll
      for (int n = 0; n < NT_K; ++n) {
        s[n][0] = ex2(fmaf(s[n][0], scale_log2, -mn0));
        s[n][1] = ex2(fmaf(s[n][1], scale_log2, -mn0));
        s[n][2] = ex2(fmaf(s[n][2], scale_log2, -mn1));
        s[n][3] = ex2(fmaf(s[n][3], scale_log2, -mn1));
        l0 += s[n][0] + s[n][1];
        l1 += s[n][2] + s[n][3];
      }
      // O += P.V: S's accumulators of key tiles 2kk, 2kk+1 are the A
      // fragment of k-step kk
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk) {
        const int nk = VB == 1 ? kk : kk + 1;    // the k-step to load now
        if (nk > 0 && nk < TK / 16) {
#pragma unroll
          for (int dp = 0; dp < NT_D / 2; ++dp)
            ldsm_x4_t(vf[nk % VB][dp],
                      vt + (nk * 16 + (lj & 1) * 8 + lr) * STRIDE + dp * 16 +
                          (lj >> 1) * 8);
        }
        uint32_t pa[4];
        pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
        for (int dp = 0; dp < NT_D / 2; ++dp) {
          mma_16816(o[2 * dp], pa, vf[kk % VB][dp]);
          mma_16816(o[2 * dp + 1], pa, vf[kk % VB][dp] + 2);
        }
      }
    }
  }

  // groups 1 .. KSPLIT-1 hand their (m, l, O) to group 0 through the
  // dead ring, slot [kh - 1][row warp][value][lane]: lane x holds the same
  // rows and columns in every group, and lane-minor stores are free of
  // bank conflicts.  No exchange when only group 0 read keys.
  constexpr int NV = 4 + 4 * NT_D;
  constexpr int SLOT = 4 * NV * 32;
  static_assert((KSPLIT - 1) * SLOT * 4 <= (TQ + 2 * STAGES * SK) * STRIDE * 2,
                "the exchange must fit in the ring");
  const bool exchange = KSPLIT > 1 && k_read - k_begin > TK;
  if (kh > 0 && !exchange) return;
  if (exchange) {
    float* x0 = reinterpret_cast<float*>(smem) + warp * NV * 32 + lane;
    __syncthreads();               // every warp is done with the ring
    if (kh > 0) {
      float* xs = x0 + (kh - 1) * SLOT;
      xs[0] = m0;
      xs[32] = m1;
      xs[64] = l0;
      xs[96] = l1;
#pragma unroll
      for (int n = 0; n < NT_D; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) xs[(4 + 4 * n + e) * 32] = o[n][e];
    }
    __syncthreads();
    if (kh > 0) return;
#pragma unroll
    for (int j = 0; j < KSPLIT - 1; ++j) {
      const float* xs = x0 + j * SLOT;
      const float mb0 = xs[0], mb1 = xs[32];
      const float mn0 = fmaxf(m0, mb0), mn1 = fmaxf(m1, mb1);
      const float fa0 = ex2(m0 - mn0), fb0 = ex2(mb0 - mn0);
      const float fa1 = ex2(m1 - mn1), fb1 = ex2(mb1 - mn1);
      m0 = mn0;
      m1 = mn1;
      l0 = l0 * fa0 + xs[64] * fb0;
      l1 = l1 * fa1 + xs[96] * fb1;
#pragma unroll
      for (int n = 0; n < NT_D; ++n) {
        o[n][0] = o[n][0] * fa0 + xs[(4 + 4 * n) * 32] * fb0;
        o[n][1] = o[n][1] * fa0 + xs[(5 + 4 * n) * 32] * fb0;
        o[n][2] = o[n][2] * fa1 + xs[(6 + 4 * n) * 32] * fb1;
        o[n][3] = o[n][3] * fa1 + xs[(7 + 4 * n) * 32] * fb1;
      }
    }
  }

  // out = O / max(l, 1e-30); rows that saw no key (l == 0) write zeros
  const float inv0 = 1.f / fmaxf(quad_sum(l0), 1e-30f);
  const float inv1 = 1.f / fmaxf(quad_sum(l1), 1e-30f);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + half * 8;
    if (row >= Sq) continue;
    const float inv = half ? inv1 : inv0;
    bf16* orow = ob + (size_t)row * q_stride;
#pragma unroll
    for (int n = 0; n < NT_D; ++n) {
      const int d = n * 8 + 2 * tq;
      const float x0 = o[n][2 * half] * inv, x1 = o[n][2 * half + 1] * inv;
      if (d + 1 < hd && (hd & 1) == 0) {
        *reinterpret_cast<__nv_bfloat162*>(orow + d) =
            __floats2bfloat162_rn(x0, x1);
      } else {
        if (d < hd) orow[d] = __float2bfloat16(x0);
        if (d + 1 < hd) orow[d + 1] = __float2bfloat16(x1);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// float32 body: one thread per query row, FMA chains (no TF32)
// ---------------------------------------------------------------------------

constexpr int BQ = 64;             // query rows per block (one per thread)
constexpr int BK = 32;             // keys per shared-memory tile

// HDP: head_dim rounded up to the instantiated width (64 or 128); lanes
// d >= hd hold zeros, so the unrolled loops keep q and acc in registers.
template <int HDP>
__global__ void __launch_bounds__(BQ)
flash_attention_f32_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const int* __restrict__ lens,
                           float* __restrict__ out, int Sq, int Skv, int Hq,
                           int Hkv, int hd, int causal, int window,
                           int q_offset, float scale) {
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
    qr[d] = (live && d < hd) ? q[q_off + d] : 0.f;
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
        kv = k[off];
        vv = v[off];
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
    if (d < hd) out[q_off + d] = acc[d] * inv;
}

template <int HDP>
int launch_tc(const void* q, const void* k, const void* v, const void* lens,
              void* out, int B, int Sq, int Skv, int Hq, int Hkv, int hd,
              int causal, int window, int q_offset, int smem_bytes,
              cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      flash_attention_tc_kernel<HDP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  const float scale_log2 = (float)(1.4426950408889634 / sqrt((double)hd));
  // 16-byte copies need 16-byte rows and 16-byte aligned tensors
  const int vec = (hd * 2) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(v) % 16 == 0;
  dim3 grid((Sq + TQ - 1) / TQ, Hq, B);
  flash_attention_tc_kernel<HDP><<<grid, THREADS, smem_bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const int*>(lens),
      static_cast<bf16*>(out), Sq, Skv, Hq, Hkv, hd, causal, window,
      q_offset, scale_log2, vec);
  return (int)cudaGetLastError();
}

template <int HDP>
int launch_f32(const void* q, const void* k, const void* v, const void* lens,
               void* out, int B, int Sq, int Skv, int Hq, int Hkv, int hd,
               int causal, int window, int q_offset, cudaStream_t stream) {
  const float scale = (float)(1.0 / sqrt((double)hd));
  dim3 grid(B * Hq, (Sq + BQ - 1) / BQ);
  flash_attention_f32_kernel<HDP><<<grid, BQ, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int*>(lens),
      static_cast<float*>(out), Sq, Skv, Hq, Hkv, hd, causal, window,
      q_offset, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q: (B, Sq, Hq, hd), k/v: (B, Skv, Hkv, hd), out: (B, Sq, Hq, hd), all
// contiguous in one dtype (is_bf16: bfloat16, else float32); lens: (B,)
// int32 or null.  smem_bytes: the bf16 body's dynamic shared memory from
// ops.py:flash_geometry (a launch given less than the kernel's carve is
// refused with cudaErrorInvalidValue); the float32 body uses static
// shared memory and ignores it.  Returns cudaGetLastError() after the
// launch.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, const void* lens,
                                   void* out, int B, int Sq, int Skv, int Hq,
                                   int Hkv, int hd, int causal, int window,
                                   int q_offset, int is_bf16, int smem_bytes,
                                   void* stream) {
  if (hd <= 0 || hd > 128 || Hkv <= 0 || Hq % Hkv != 0 || B < 0 ||
      B > 65535 || Hq > 65535 || Sq < 0 || Skv < 0 || q_offset < 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    const int hdp = head_pad(hd);
    if (smem_bytes < 0 || (size_t)smem_bytes < tc_smem(hdp))
      return (int)cudaErrorInvalidValue;
    if (hdp == 32)
      return launch_tc<32>(q, k, v, lens, out, B, Sq, Skv, Hq, Hkv, hd,
                           causal, window, q_offset, smem_bytes, s);
    if (hdp == 64)
      return launch_tc<64>(q, k, v, lens, out, B, Sq, Skv, Hq, Hkv, hd,
                           causal, window, q_offset, smem_bytes, s);
    return launch_tc<128>(q, k, v, lens, out, B, Sq, Skv, Hq, Hkv, hd,
                          causal, window, q_offset, smem_bytes, s);
  }
  if (hd <= 64)
    return launch_f32<64>(q, k, v, lens, out, B, Sq, Skv, Hq, Hkv, hd,
                          causal, window, q_offset, s);
  return launch_f32<128>(q, k, v, lens, out, B, Sq, Skv, Hq, Hkv, hd, causal,
                         window, q_offset, s);
}

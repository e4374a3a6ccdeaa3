// Batched multi-adapter LoRA delta (Punica/S-LoRA SGMV) for Hopper
// (sm_90a): out[n] = scale * (x[n] . A[t[n]]) . B[t[n]], one adapter per
// row, chosen by the row's task id.
//
// Replaces the Pallas TPU kernel multi_lora_pallas
// (src/repro/kernels/multi_lora/multi_lora.py:51, kernel body _kernel at
// :28, pallas_call at :60; wrapper ops.py:14).  The encoder's batched
// multi-task forward applies it on the q and v projections of every layer
// (src/repro/classifiers/encoder.py:151), with rows sorted by task in T
// runs of B * S rows.
//
// What bounds it on an H100: bytes.  At the encoder path's shape (N =
// 30 720 rows, din = dout = 768, r = 32, float32) x and out are 94.4 MB
// each and the adapters 1.0 MB: 0.0567 ms at 3.35 TB/s.  The
// 2 * N * r * (din + dout) = 3.0 GFLOP would take 0.045 ms on the float32
// FMA units alone, so a CUDA-core body sits on the bound with no room to
// hide its loads; this one puts the products on the tensor cores.
//
// Design (the segmented form: a tile of BM = 128 contiguous rows, all its
// rows of one task handled together):
//  * Tasks.  The tile's distinct valid ids are found in parallel: each
//    round one block-wide minimum (__reduce_min_sync per warp, then the
//    warps' minima) of the ids above the last one found.  A sorted tile
//    costs two rounds.  Ids outside [0, T) are in no round.
//  * One pass per task u of the tile, fused shrink and expand, through one
//    cp.async ring (16-byte copies where rows and pointers are 16-byte
//    aligned, zero-filled past every edge; element copies otherwise).
//    Shrink jobs bring 128 bytes of every row of x (32 float32 or 64 bf16
//    columns) and the matching rows of A[u]; each warp owns 16 rows and
//    accumulates its h = x . A[u] (16 x r, float32) in registers over din.
//    Expand jobs bring 64 columns of B[u]; the warp multiplies its h by
//    them, scales, casts, and writes the 16 x 64 result into its own
//    shared-memory tile, from which the rows of task u go out as whole
//    row segments, 16 bytes a lane (a store straight from the
//    accumulators covers 8 rows x 32 or 16 bytes, and such scattered
//    writes cost more time than the arithmetic).  x is read from HBM once
//    per task of the tile (once on the sorted path: its 6 144-row runs
//    are 48 whole tiles), out is written once, A[u] and B[u] once per
//    tile from L2.  A warp with no row of u skips the pass's arithmetic;
//    rows of other tasks are computed there but never stored.  Rows with
//    an invalid id are written as zeros.  A mixed tile (a run boundary,
//    shuffled ids) costs one pass over x per distinct task.
//  * Products: mma.sync.m16n8k8 TF32 with float32 accumulation.  float32
//    operands are split, v = hi + lo, both TF32, and each product is
//    lo.hi + hi.lo + hi.hi (3xTF32): ~21 significant bits, float32
//    accuracy where one TF32 pass errs by ~5e-4.  bf16 operands are exact
//    in TF32, so the bf16 shrink takes one pass; its float32 h is split
//    for the expand (h.lo.B + h.hi.B), never rounded.
//  * h never leaves registers: the shrink's accumulator layout is the
//    expand's A fragment once the rank axis is permuted within each group
//    of 8 (logical k = t <-> column 2t, k = t + 4 <-> 2t + 1); the B
//    fragments read B's rows in that order.
//  * Shared memory: a ring stage holds max(x chunk + A chunk, B chunk),
//    rows padded so fragment reads hit 32 distinct banks (19 456 to
//    27 648 B by rank), plus 16 x 72 elements of staging per warp (36 864
//    B float32, 18 432 B bf16).  The ring takes as many stages, 2 to 4, as
//    keep two CTAs of 256 threads on an SM (registers capped at 128):
//    3 stages and 107 520 B at float32 r = 32, 2 stages at r = 64.  r is
//    rounded up to 8, 16, 32 or 64 (zero-filled columns of A and rows of
//    B), so rank 64 is one template of 8 fragments, not chunked.
//  The geometry is mirrored by ops.py:lora_geometry, and a launch given
//  less dynamic shared memory than it needs is refused.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int BM = 16 * WARPS;     // rows per tile: 16 per warp
constexpr int NC = 64;             // dout columns per expand job
constexpr int OS = NC + 8;         // output staging row stride (elements)
constexpr int MAX_R = 64;
constexpr int MAX_STAGES = 4;
// dynamic shared memory per CTA that keeps two CTAs on one SM (228 KB,
// less 1 KB reserved and the static arrays of each)
constexpr int SMEM_TWO_CTAS = 114688;
constexpr unsigned NONE = 0xffffffffu;

using bf16 = __nv_bfloat16;

// rank rounded up to the instantiated width (8 * NT)
__host__ __device__ constexpr int rank_pad(int r) {
  return r <= 8 ? 8 : r <= 16 ? 16 : r <= 32 ? 32 : 64;
}
// a shrink job brings 128 bytes of every row of the tile
template <typename E>
__host__ __device__ constexpr int k_chunk() { return 128 / (int)sizeof(E); }
// row strides padded by 16 bytes: x fragment reads fall on words 4g + t
// (float32) or 4g + t/2 (bf16), B fragment reads on 8t + g or 8t + g/2
template <typename E>
__host__ __device__ constexpr int x_stride() {
  return k_chunk<E>() + 16 / (int)sizeof(E);
}
template <typename E>
__host__ __device__ constexpr int b_stride() { return NC + 16 / (int)sizeof(E); }
// A chunk row stride: 8 or 24 (mod 32) words for float32 and 8, 24, 40 or
// 56 (mod 64) halves for bf16, so the 4 k rows x 8 columns of a fragment
// read fall in distinct banks
__host__ __device__ constexpr int a_stride(int r_pad) {
  return r_pad % 16 == 8 ? r_pad : r_pad + 8;
}
template <typename E>
__host__ __device__ constexpr int x_bytes() {
  return BM * x_stride<E>() * (int)sizeof(E);
}
template <typename E>
__host__ __device__ constexpr int stage_bytes(int r_pad) {
  const int xa =
      x_bytes<E>() + k_chunk<E>() * a_stride(r_pad) * (int)sizeof(E);
  const int bb = r_pad * b_stride<E>() * (int)sizeof(E);
  const int m = xa > bb ? xa : bb;
  return (m + 127) / 128 * 128;
}
// each warp's 16 x NC output staging tile
template <typename E>
__host__ __device__ constexpr int out_bytes() {
  return WARPS * 16 * OS * (int)sizeof(E);
}
// the most ring stages (at most 4, at least 2) that keep two CTAs per SM
template <typename E>
__host__ __device__ constexpr int ring_stages(int r_pad) {
  int s = MAX_STAGES;
  while (s > 2 && s * stage_bytes<E>(r_pad) + out_bytes<E>() > SMEM_TWO_CTAS)
    --s;
  return s;
}
template <typename E>
__host__ __device__ constexpr int smem_need(int r_pad) {
  return ring_stages<E>(r_pad) * stage_bytes<E>(r_pad) + out_bytes<E>();
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename E> __device__ __forceinline__ E from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);
}

// two neighbouring columns in one shared-memory store (8 or 4 bytes):
// words 8g + 2t of each half warp (float32) or 4g + t (bf16), no conflict
__device__ __forceinline__ void store2(float* w, float v0, float v1) {
  *reinterpret_cast<float2*>(w) = make_float2(v0, v1);
}
__device__ __forceinline__ void store2(bf16* w, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(w) = __floats2bfloat162_rn(v0, v1);
}

// v = hi + lo to ~21 bits, both TF32 (the 10 explicit mantissa bits kept,
// the 13 below them cleared): hi is exact, v - hi is exact in float32,
// and only its truncation to TF32 errs, by < 2^-20 |v|.  Two logic ops
// and a subtraction, where a conversion (cvt.rna.tf32.f32) per half
// issues at a lower rate and showed in the kernel's time.
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(v) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi)) & 0xffffe000u;
}

// D = A (16x8 tf32, row) * B (8x8 tf32, col) + D, float32 accumulate
__device__ __forceinline__ void mma(float* d, const uint32_t* a, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

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
template <int STAGES>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2) : "memory");
}

// rows x cols of a row-major global matrix (row stride gs elements; rows
// >= nr and columns >= nc read as zeros) into shared memory of row stride
// ss.  cols is a multiple of 16 bytes.  vec: 16-byte cp.async (rows and
// the pointer 16-byte aligned); else element copies.
template <typename E>
__device__ __forceinline__ void load_tile(E* s, int ss, const E* g,
                                          size_t gs, int rows, int cols,
                                          int nr, int nc, bool vec) {
  constexpr int V = 16 / (int)sizeof(E);
  if (vec) {
    const int upr = cols / V;
    for (int i = threadIdx.x; i < rows * upr; i += THREADS) {
      const int rr = i / upr, c = (i - rr * upr) * V;
      const int n = rr < nr ? min(max(nc - c, 0), V) : 0;
      cp_async16(s + rr * ss + c, n ? g + rr * gs + c : g,
                 n * (int)sizeof(E));
    }
  } else {
    for (int i = threadIdx.x; i < rows * cols; i += THREADS) {
      const int rr = i / cols, c = i - rr * cols;
      s[rr * ss + c] = rr < nr && c < nc ? g[rr * gs + c] : from_f<E>(0.f);
    }
  }
}

template <typename E, int NT>
__global__ void __launch_bounds__(THREADS, 2) multi_lora_kernel(
    const E* __restrict__ x, const E* __restrict__ a,
    const E* __restrict__ b, const int* __restrict__ ids,
    E* __restrict__ out, int N, int din, int dout, int T, int r,
    float scale, int vx, int va, int vb, int vo) {
  constexpr int RP = 8 * NT;                      // padded rank
  constexpr int STAGES = ring_stages<E>(RP);
  constexpr int KC = k_chunk<E>();                // din columns per job
  constexpr int XS = x_stride<E>();               // x chunk row stride
  constexpr int AS = a_stride(RP);                // A chunk row stride
  constexpr int BS = b_stride<E>();               // B chunk row stride
  constexpr int SB = stage_bytes<E>(RP);
  constexpr bool EXACT = sizeof(E) == 2;          // bf16: exact in TF32
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ unsigned wmin[2][BM / 32];
  __shared__ int tasks[BM];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const long row0 = (long)blockIdx.x * BM;

  // the tile's distinct valid task ids, ascending: one block-wide minimum
  // of the ids above the last one found per round
  unsigned mine = NONE;
  if (tid < BM && row0 + tid < N) {
    const int v = ids[row0 + tid];
    if (v >= 0 && v < T) mine = (unsigned)v;
  }
  int ntasks = 0;
  for (int prev = -1;; ++ntasks) {
    if (tid < BM) {
      const unsigned c = mine != NONE && (int)mine > prev ? mine : NONE;
      const unsigned m = __reduce_min_sync(0xffffffffu, c);
      if (lane == 0) wmin[ntasks & 1][warp] = m;
    }
    __syncthreads();
    unsigned m = NONE;
#pragma unroll
    for (int w = 0; w < BM / 32; ++w) m = min(m, wmin[ntasks & 1][w]);
    if (m == NONE) break;
    if (tid == 0) tasks[ntasks] = (int)m;
    prev = (int)m;
  }
  // this thread's fragment rows: g and g + 8 of the warp's 16
  const long ra = row0 + 16 * warp + g, rb = ra + 8;
  const int ta = ra < N ? ids[ra] : -1;
  const int tb = rb < N ? ids[rb] : -1;

  const int nrows = N - row0 < BM ? (int)(N - row0) : BM;
  const int nk = (din + KC - 1) / KC, ne = (dout + NC - 1) / NC;
  const int per = nk + ne, njobs = ntasks * per;

  auto issue = [&](int j) {
    if (j < njobs) {
      const int p = j / per, q = j - p * per, u = tasks[p];
      unsigned char* st = smem + (j % STAGES) * SB;
      if (q < nk) {
        const int k0 = q * KC;
        load_tile<E>(reinterpret_cast<E*>(st), XS,
                     x + (size_t)row0 * din + k0, din, BM, KC, nrows,
                     din - k0, vx);
        load_tile<E>(reinterpret_cast<E*>(st + x_bytes<E>()), AS,
                     a + ((size_t)u * din + k0) * r, r, KC, RP, din - k0, r,
                     va);
      } else {
        const int n0 = (q - nk) * NC;
        load_tile<E>(reinterpret_cast<E*>(st), BS,
                     b + (size_t)u * r * dout + n0, dout, RP, NC, r,
                     dout - n0, vb);
      }
    }
    cp_commit();
  };

  float h[NT][4];                 // h = x . A[u] of the warp's 16 rows
  E* ws = reinterpret_cast<E*>(smem + STAGES * SB) + warp * 16 * OS;

#pragma unroll 1
  for (int j = 0; j < STAGES - 1; ++j) issue(j);
#pragma unroll 1
  for (int j = 0; j < njobs; ++j) {
    cp_wait<STAGES>();
    __syncthreads();
    issue(j + STAGES - 1);
    const int p = j / per, q = j - p * per, u = tasks[p];
    const bool oa = ta == u, ob = tb == u;
    if (!__any_sync(0xffffffffu, oa || ob)) continue;
    const unsigned char* st = smem + (j % STAGES) * SB;
    if (q < nk) {
      // shrink: h += x[:, k0:k0+KC] . A[u][k0:k0+KC]
      if (q == 0) {
#pragma unroll
        for (int n = 0; n < NT; ++n)
          h[n][0] = h[n][1] = h[n][2] = h[n][3] = 0.f;
      }
      const E* xs = reinterpret_cast<const E*>(st) + (16 * warp + g) * XS + t;
      const E* as = reinterpret_cast<const E*>(st + x_bytes<E>()) + t * AS + g;
#pragma unroll
      for (int ks = 0; ks < KC / 8; ++ks) {
        const float xv[4] = {to_f(xs[8 * ks]), to_f(xs[8 * XS + 8 * ks]),
                             to_f(xs[8 * ks + 4]),
                             to_f(xs[8 * XS + 8 * ks + 4])};
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (EXACT) hi[i] = __float_as_uint(xv[i]);
          else split(xv[i], hi[i], lo[i]);
        }
        const E* ak = as + 8 * ks * AS;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const float b0 = to_f(ak[8 * n]), b1 = to_f(ak[4 * AS + 8 * n]);
          if (EXACT) {
            mma(h[n], hi, __float_as_uint(b0), __float_as_uint(b1));
          } else {
            uint32_t b0h, b0l, b1h, b1l;
            split(b0, b0h, b0l);
            split(b1, b1h, b1l);
            mma(h[n], lo, b0h, b1h);
            mma(h[n], hi, b0l, b1l);
            mma(h[n], hi, b0h, b1h);
          }
        }
      }
    } else {
      // expand: y = h . B[u][:, n0:n0+64], rank permuted within each 8
      const int n0 = (q - nk) * NC;
      float y[NC / 8][4];
#pragma unroll
      for (int n = 0; n < NC / 8; ++n) y[n][0] = y[n][1] = y[n][2] = y[n][3] = 0.f;
      const E* bs = reinterpret_cast<const E*>(st) + 2 * t * BS + g;
#pragma unroll
      for (int kk = 0; kk < NT; ++kk) {
        // accumulator (g, 2t) (g, 2t+1) (g+8, 2t) (g+8, 2t+1) as the A
        // fragment (g, k) (g+8, k) (g, k+4) (g+8, k+4): k = t <-> 2t
        const float hv[4] = {h[kk][0], h[kk][2], h[kk][1], h[kk][3]};
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) split(hv[i], hi[i], lo[i]);
        const E* bk = bs + 8 * kk * BS;
#pragma unroll
        for (int n = 0; n < NC / 8; ++n) {
          const float b0 = to_f(bk[8 * n]), b1 = to_f(bk[BS + 8 * n]);
          if (EXACT) {
            mma(y[n], lo, __float_as_uint(b0), __float_as_uint(b1));
            mma(y[n], hi, __float_as_uint(b0), __float_as_uint(b1));
          } else {
            uint32_t b0h, b0l, b1h, b1l;
            split(b0, b0h, b0l);
            split(b1, b1h, b1l);
            mma(y[n], lo, b0h, b1h);
            mma(y[n], hi, b0l, b1l);
            mma(y[n], hi, b0h, b1h);
          }
        }
      }
      // the rows of task u through the warp's staging tile: whole row
      // segments of NC columns, 16 bytes a lane where out allows it
#pragma unroll
      for (int n = 0; n < NC / 8; ++n) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          store2(ws + (g + 8 * half) * OS + 8 * n + 2 * t,
                 y[n][2 * half] * scale, y[n][2 * half + 1] * scale);
        }
      }
      __syncwarp();
      // row i of the warp is owned (task u) as lane 4i's oa, 4(i-8)'s ob
      const unsigned own = (__ballot_sync(0xffffffffu, oa) & 0x11111111u) |
                           ((__ballot_sync(0xffffffffu, ob) & 0x11111111u)
                            << 1);
      auto owned = [&](int i) {
        return (own >> (i < 8 ? 4 * i : 4 * (i - 8) + 1)) & 1u;
      };
      E* orow = out + (size_t)(row0 + 16 * warp) * dout + n0;
      if (vo && n0 + NC <= dout) {
        constexpr int V = 16 / (int)sizeof(E), UPR = NC / V;
#pragma unroll
        for (int k = 0; k < 16 * UPR / 32; ++k) {
          const int i = k * (32 / UPR) + lane / UPR, c = (lane % UPR) * V;
          if (owned(i))
            *reinterpret_cast<uint4*>(orow + (size_t)i * dout + c) =
                *reinterpret_cast<const uint4*>(ws + i * OS + c);
        }
      } else {
        for (int k = lane; k < 16 * NC; k += 32) {
          const int i = k / NC, c = k - i * NC;
          if (owned(i) && n0 + c < dout) orow[(size_t)i * dout + c] = ws[i * OS + c];
        }
      }
      __syncwarp();
    }
  }
  cp_wait<2>();                   // wait_group 0: no copy outlives the block
  // rows whose id is outside [0, T): exact zeros
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const long row = half ? rb : ra;
    const int v = half ? tb : ta;
    if (row < N && (v < 0 || v >= T))
      for (int c = t; c < dout; c += 4)
        out[(size_t)row * dout + c] = from_f<E>(0.f);
  }
}

template <typename E, int NT>
int launch(const void* x, const void* a, const void* b, const void* ids,
           void* out, int N, int din, int dout, int T, int r, float scale,
           int smem_bytes, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      multi_lora_kernel<E, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (e != cudaSuccess) return (int)e;
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const size_t esz = sizeof(E);
  const int vx = aligned(x) && din * esz % 16 == 0;
  const int va = aligned(a) && r * esz % 16 == 0;
  const int vb = aligned(b) && dout * esz % 16 == 0;
  const int vo = aligned(out) && dout * esz % 16 == 0;
  const int grid = (N + BM - 1) / BM;
  multi_lora_kernel<E, NT><<<grid, THREADS, smem_bytes, stream>>>(
      static_cast<const E*>(x), static_cast<const E*>(a),
      static_cast<const E*>(b), static_cast<const int*>(ids),
      static_cast<E*>(out), N, din, dout, T, r, scale, vx, va, vb, vo);
  return (int)cudaGetLastError();
}

template <typename E>
int launch_rank(const void* x, const void* a, const void* b, const void* ids,
                void* out, int N, int din, int dout, int T, int r,
                float scale, int smem_bytes, cudaStream_t s) {
  if (smem_bytes < smem_need<E>(rank_pad(r))) return (int)cudaErrorInvalidValue;
  switch (rank_pad(r)) {
    case 8:
      return launch<E, 1>(x, a, b, ids, out, N, din, dout, T, r, scale,
                          smem_bytes, s);
    case 16:
      return launch<E, 2>(x, a, b, ids, out, N, din, dout, T, r, scale,
                          smem_bytes, s);
    case 32:
      return launch<E, 4>(x, a, b, ids, out, N, din, dout, T, r, scale,
                          smem_bytes, s);
    default:
      return launch<E, 8>(x, a, b, ids, out, N, din, dout, T, r, scale,
                          smem_bytes, s);
  }
}

}  // namespace

// x: (N, din); a: (T, din, r); b: (T, r, dout); ids: (N,) int32 task id
// per row (any order; ids outside [0, T) give zero rows); out: (N, dout).
// All contiguous; x/a/b/out share one dtype (is_bf16: bfloat16, else
// float32); 1 <= r <= 64.  smem_bytes: the dynamic shared memory from
// ops.py:lora_geometry (less than the kernel needs is refused with
// cudaErrorInvalidValue).  Returns cudaGetLastError() after the launch.
extern "C" int multi_lora_fwd(const void* x, const void* a, const void* b,
                              const void* ids, void* out, int N, int din,
                              int dout, int T, int r, float scale,
                              int is_bf16, int smem_bytes, void* stream) {
  if (N < 0 || din <= 0 || dout <= 0 || T < 0 || r <= 0 || r > MAX_R)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_rank<bf16>(x, a, b, ids, out, N, din, dout, T, r, scale,
                             smem_bytes, s);
  return launch_rank<float>(x, a, b, ids, out, N, din, dout, T, r, scale,
                            smem_bytes, s);
}

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
// the live KV bytes over 3.35 TB/s; at the serving shapes (a few hundred
// live keys a row) that is well under a microsecond, so what the card
// really waits on is latency: dependent loads and barriers.
//
// Design: the keys of one (row b, KV head h) are split over a thread-block
// cluster.  The launch geometry comes from the table width alone (the
// wrapper's ops.py:paged_geometry): C = min(8, max_blocks) CTAs of a
// cluster, CTA rank c owning table blocks [c*P, min((c+1)*P, max_blocks))
// with P = ceil(max_blocks / C).  The grid is (C, Hkv, B) in clusters of
// (C, 1, 1).  The W x G query rows of the KV head (G = Hq/Hkv; row = t*G +
// g) share every K/V load, and position t masks at its own frontier
// kv_len - W + t + 1.  Each CTA:
//   1. reads its span's table entries (clamped into the pool) and the
//      query rows (16-byte loads where rows and tensors allow);
//   2. streams its live K tokens through a four-stage cp.async ring of
//      CH-token chunks (16-byte copies; a head_dim whose row is not a
//      multiple of 16 bytes takes scalar loads into the same layout) and
//      writes float32 scores, scaled by 1/sqrt(hd), for its span: bf16 on
//      tensor cores (mma.sync.m16n8k16, fp32 accumulate; the rows padded
//      to 16, head_dim to 16 with zeros), float32 as FMA chains on the
//      CUDA cores (no TF32);
//   3. takes ONE exact float32 softmax across the cluster through
//      distributed shared memory: each CTA stores its row maxima into every
//      rank's shared memory, cluster.sync(), takes the global max
//      (order-free), e = exp(s - m) and local sums, stores the sums the
//      same way, cluster.sync(), l = the sum of the C local sums in rank
//      order, and p = round_T(e / l) — the probabilities in the value
//      dtype before P.V, as the reference's op order (ops.py:129-138).
//      The first V chunks stream in meanwhile;
//   4. accumulates its partial P.V in float32 (bf16: p as the A operand
//      of mma.sync), stores each element's partial into the shared memory
//      of the rank that owns that slice of the output, cluster.sync(), and
//      sums its own slice over the C partials in rank order, casts and
//      stores it.
//   Each CTA only ever writes to other ranks' shared memory (stores do not
//   wait on the remote latency), and reads its own; three cluster barriers
//   order it all, and an arrive at the start, waited on before the first
//   remote store, makes sure every rank of the cluster has started.
// No online softmax (it diverged from the reference by ~4e-3 in bf16 on
// the TPU), no second launch and no workspace in device memory.
//
// Why verify position t equals a decode launch at its frontier, bitwise:
// C and P depend only on max_blocks, so both run the same spans; a query
// row's arithmetic depends only on that row, its frontier and the keys
// (chunks start at span-relative multiples of CH whatever W is); in
// mma.sync each output element depends only on its row of A and its
// column of B; every reduction order is fixed by key index and rank.
// A row whose frontier is <= 0 writes exact zeros; a frontier beyond the
// table is clamped to it.  Freed scheduler slots run at pos 0 against an
// all-zero table row: they read the trash block 0, which always exists.
// Table entries are clamped into the pool, so a bad table cannot fault.
// A CTA whose span holds no live key takes part in every barrier.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_HD = 128;
constexpr int MAX_CLUSTER = 8;     // the portable cluster size
constexpr int CH = 32;             // tokens per ring stage
constexpr int STAGES = 4;           // ring stages: STAGES - 1 chunks in flight

__host__ __device__ constexpr size_t up(size_t x, size_t a) {
  return (x + a - 1) / a * a;
}

// Shared-memory carve of one CTA, in bytes.  ops.py:paged_geometry is the
// one formula the wrapper uses; the entry point refuses a launch whose
// dynamic shared memory is smaller than this carve.
//   [0]:  query rows [R16][stride] in T (phase 1), then the partial P.V
//         [R][hd] in float32 (phase 3)
//   ps:   scores, then probabilities, [R][sps] float32
//   ring: K chunks (phase 1), then V chunks (phases 2-3),
//         [STAGES][CH][stride] in T
//   red:  every rank's row maxima, then row sums, [2][MAX_CLUSTER][R]
//         float32, written by the ranks themselves
//   recv: every rank's partial P.V of this CTA's output slice,
//         [C][ceil(R*hd / C)] float32 (<= R*hd + MAX_CLUSTER floats),
//         written by the ranks themselves
//   tb:   the span's physical block ids, [P] int32
struct Carve {
  int stride, sps;
  size_t ps, ring, red, recv, tb, total;
};

__host__ __device__ inline Carve carve(int R, int hd, int esz, int span,
                                       int P) {
  Carve c;
  c.stride = (int)up(hd, 16) + 16 / esz;   // 16 bytes of padding a row
  c.sps = (int)up(span, CH) + 4;
  const size_t q_bytes = up(up(R, 16) * c.stride * esz, 16);
  const size_t o_bytes = up((size_t)R * hd * 4, 16);
  c.ps = q_bytes > o_bytes ? q_bytes : o_bytes;
  c.ring = c.ps + up((size_t)R * c.sps * 4, 16);
  c.red = c.ring + up((size_t)STAGES * CH * c.stride * esz, 16);
  c.recv = c.red + up((size_t)2 * MAX_CLUSTER * R * 4, 16);
  c.tb = c.recv + up(((size_t)R * hd + MAX_CLUSTER) * 4, 16);
  c.total = c.tb + up((size_t)P * 4, 16);
  return c;
}

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
// every copy group but the newest STAGES - 1 has landed
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 1) : "memory");
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
__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

// Copies span tokens [j0, j0 + CH) of one pool into a ring stage; tokens
// at or beyond n_live are zero-filled.
template <typename T>
__device__ __forceinline__ void load_chunk(T* dst, const T* __restrict__ pool,
                                           const int* tb, int j0, int n_live,
                                           int blk, size_t tok_stride,
                                           size_t head_off, int hd,
                                           int stride, bool vec) {
  if (vec) {
    constexpr int PER = 16 / sizeof(T);
    const int nv = hd / PER;
    for (int i = threadIdx.x; i < CH * nv; i += THREADS) {
      const int tok = i / nv, v = i - tok * nv;
      const int j = j0 + tok;
      T* d = dst + tok * stride + v * PER;
      if (j < n_live) {
        const T* s = pool + ((size_t)tb[j / blk] * blk + j % blk) * tok_stride +
                     head_off + v * PER;
        cp_async16(d, s, 16);
      } else {
        cp_async16(d, pool, 0);
      }
    }
  } else {
    for (int i = threadIdx.x; i < CH * hd; i += THREADS) {
      const int tok = i / hd, dd = i - tok * hd;
      const int j = j0 + tok;
      dst[tok * stride + dd] =
          j < n_live ? pool[((size_t)tb[j / blk] * blk + j % blk) * tok_stride +
                            head_off + dd]
                     : from_f<T>(0.f);
    }
  }
}

// Scores of query rows x the CH keys of one K chunk, into ps columns
// [col0, col0 + CH): s = (q . k) * scale.
__device__ __forceinline__ void chunk_scores(const __nv_bfloat16* qs,
                                             const __nv_bfloat16* ks,
                                             float* ps, int R, int hd,
                                             int stride, int sps, int col0,
                                             float scale) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const int n_mt = (R + 15) / 16;
  const int ksteps = (hd + 15) / 16;
  for (int u = warp; u < n_mt * (CH / 8); u += WARPS) {
    const int mt = u / (CH / 8), nt = u % (CH / 8);
    float c[4] = {0.f, 0.f, 0.f, 0.f};
    const __nv_bfloat16* qa = qs + (mt * 16 + g) * stride + tq * 2;
    const __nv_bfloat16* kb = ks + (nt * 8 + g) * stride + tq * 2;
    for (int kk = 0; kk < ksteps; ++kk) {
      uint32_t a[4], b[2];
      a[0] = *reinterpret_cast<const uint32_t*>(qa + kk * 16);
      a[1] = *reinterpret_cast<const uint32_t*>(qa + 8 * stride + kk * 16);
      a[2] = *reinterpret_cast<const uint32_t*>(qa + kk * 16 + 8);
      a[3] = *reinterpret_cast<const uint32_t*>(qa + 8 * stride + kk * 16 + 8);
      b[0] = *reinterpret_cast<const uint32_t*>(kb + kk * 16);
      b[1] = *reinterpret_cast<const uint32_t*>(kb + kk * 16 + 8);
      mma_16816(c, a, b);
    }
    const int r0 = mt * 16 + g, col = col0 + nt * 8 + tq * 2;
    if (r0 < R) {
      ps[r0 * sps + col] = c[0] * scale;
      ps[r0 * sps + col + 1] = c[1] * scale;
    }
    if (r0 + 8 < R) {
      ps[(r0 + 8) * sps + col] = c[2] * scale;
      ps[(r0 + 8) * sps + col + 1] = c[3] * scale;
    }
  }
}

__device__ __forceinline__ void chunk_scores(const float* qs, const float* ks,
                                             float* ps, int R, int hd,
                                             int stride, int sps, int col0,
                                             float scale) {
  for (int i = threadIdx.x; i < R * CH; i += THREADS) {
    const int r = i / CH, j = i - r * CH;
    const float* qr = qs + r * stride;
    const float* kr = ks + j * stride;
    float acc = 0.f;
    for (int d = 0; d < hd; ++d) acc = fmaf(qr[d], kr[d], acc);
    ps[r * sps + col0 + j] = acc * scale;
  }
}

// os[R][hd] += p[:, col0:col0+CH] . V chunk, float32 accumulation
__device__ __forceinline__ void chunk_pv(const float* ps,
                                         const __nv_bfloat16* vs, float* os,
                                         int R, int hd, int stride, int sps,
                                         int col0) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const int n_mt = (R + 15) / 16, n_nt = (hd + 7) / 8;
  for (int u = warp; u < n_mt * n_nt; u += WARPS) {
    const int mt = u / n_nt, nt = u % n_nt;
    const int r0 = mt * 16 + g, r1 = r0 + 8;
    const int d0 = nt * 8 + tq * 2;
    float c[4];
    c[0] = (r0 < R && d0 < hd) ? os[r0 * hd + d0] : 0.f;
    c[1] = (r0 < R && d0 + 1 < hd) ? os[r0 * hd + d0 + 1] : 0.f;
    c[2] = (r1 < R && d0 < hd) ? os[r1 * hd + d0] : 0.f;
    c[3] = (r1 < R && d0 + 1 < hd) ? os[r1 * hd + d0 + 1] : 0.f;
#pragma unroll
    for (int kk = 0; kk < CH / 16; ++kk) {
      const int k0 = col0 + kk * 16 + tq * 2;
      uint32_t a[4], b[2];
      a[0] = r0 < R ? pack_bf16(ps[r0 * sps + k0], ps[r0 * sps + k0 + 1]) : 0u;
      a[1] = r1 < R ? pack_bf16(ps[r1 * sps + k0], ps[r1 * sps + k0 + 1]) : 0u;
      a[2] = r0 < R ? pack_bf16(ps[r0 * sps + k0 + 8], ps[r0 * sps + k0 + 9])
                    : 0u;
      a[3] = r1 < R ? pack_bf16(ps[r1 * sps + k0 + 8], ps[r1 * sps + k0 + 9])
                    : 0u;
      const __nv_bfloat16* vb = vs + (kk * 16 + tq * 2) * stride + nt * 8 + g;
      b[0] = pack_bf16(vb[0], vb[stride]);
      b[1] = pack_bf16(vb[8 * stride], vb[9 * stride]);
      mma_16816(c, a, b);
    }
    if (r0 < R && d0 < hd) os[r0 * hd + d0] = c[0];
    if (r0 < R && d0 + 1 < hd) os[r0 * hd + d0 + 1] = c[1];
    if (r1 < R && d0 < hd) os[r1 * hd + d0] = c[2];
    if (r1 < R && d0 + 1 < hd) os[r1 * hd + d0 + 1] = c[3];
  }
}

__device__ __forceinline__ void chunk_pv(const float* ps, const float* vs,
                                         float* os, int R, int hd, int stride,
                                         int sps, int col0) {
  for (int i = threadIdx.x; i < R * hd; i += THREADS) {
    const int r = i / hd, d = i - r * hd;
    const float* pr = ps + r * sps + col0;
    float acc = os[i];
    for (int j = 0; j < CH; ++j) acc = fmaf(pr[j], vs[j * stride + d], acc);
    os[i] = acc;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
paged_attn_kernel(const T* __restrict__ q, const T* __restrict__ kpool,
                  const T* __restrict__ vpool, const int* __restrict__ tbl,
                  const int* __restrict__ kv_len, T* __restrict__ out, int W,
                  int Hq, int Hkv, int hd, int num_blocks, int blk,
                  int max_blocks, int P, float scale, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int c = (int)cluster.block_rank();
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;

  const int G = Hq / Hkv;
  const int R = W * G;                 // query rows: row = t * G + g
  const int S = max_blocks * blk;      // table capacity in tokens
  const int span = P * blk;
  const Carve cv = carve(R, hd, (int)sizeof(T), span, P);
  const int stride = cv.stride, sps = cv.sps;
  T* qs = reinterpret_cast<T*>(smem);
  float* os = reinterpret_cast<float*>(smem);
  float* ps = reinterpret_cast<float*>(smem + cv.ps);
  T* ring = reinterpret_cast<T*>(smem + cv.ring);
  float* gmax = reinterpret_cast<float*>(smem + cv.red);  // [rank][row]
  float* gsum = gmax + MAX_CLUSTER * R;                    // [rank][row]
  float* recv = reinterpret_cast<float*>(smem + cv.recv);
  int* tb = reinterpret_cast<int*>(smem + cv.tb);

  const int kvl = kv_len[b];
  const int s0 = c * span;             // first token of this CTA's span
  // span-local live tokens of the last position (the widest frontier)
  const int n_live = min(max(frontier(kvl, W, W - 1, S) - s0, 0), span);
  const int nch = (n_live + CH - 1) / CH;
  // q and out are (B, W, Hq, hd): row (t, g) is head h*G + g of position
  // t, at element ((b*W + t)*Hq + h*G + g)*hd
  const size_t head0 = (size_t)b * W * Hq + (size_t)h * G;
  const size_t tok_stride = (size_t)Hkv * hd;   // one token in the pool
  const size_t head_off = (size_t)h * hd;
  const int* trow = tbl + (size_t)b * max_blocks;
  const int R16 = (R + 15) / 16 * 16;

  // phase 0: the span's table entries, the query rows (zero-padded to 16
  // rows and the ring's stride), zeros in the ring's padding columns
  for (int i = tid; i < P; i += THREADS) {
    const int blkidx = c * P + i;
    tb[i] = blkidx < max_blocks ? min(max(trow[blkidx], 0), num_blocks - 1)
                                : 0;
  }
  for (int i = tid; i < R16 * stride; i += THREADS) {
    const int row = i / stride, d = i - row * stride;
    if (row >= R || d >= hd) qs[i] = from_f<T>(0.f);
  }
  if (vec) {                           // 16-byte loads
    constexpr int PER = 16 / sizeof(T);
    const int nv = hd / PER;
    for (int i = tid; i < R * nv; i += THREADS) {
      const int row = i / nv, v = i - row * nv;
      const int t = row / G;
      *reinterpret_cast<uint4*>(qs + row * stride + v * PER) =
          *reinterpret_cast<const uint4*>(
              q + (head0 + (size_t)t * Hq + (row - t * G)) * hd + v * PER);
    }
  } else {
    for (int i = tid; i < R * hd; i += THREADS) {
      const int row = i / hd, d = i - row * hd;
      const int t = row / G;
      qs[row * stride + d] =
          q[(head0 + (size_t)t * Hq + (row - t * G)) * hd + d];
    }
  }
  // every rank must have started before any writes to its shared memory
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  for (int i = tid; i < STAGES * CH * (stride - hd); i += THREADS) {
    const int tok = i / (stride - hd);
    ring[tok * stride + hd + (i - tok * (stride - hd))] = from_f<T>(0.f);
  }
  __syncthreads();

  // phase 1: scores over the live K chunks, STAGES - 1 chunks in flight
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < nch)
      load_chunk(ring + i * CH * stride, kpool, tb, i * CH, n_live, blk,
                 tok_stride, head_off, hd, stride, vec);
    cp_commit();
  }
  for (int i = 0; i < nch; ++i) {
    const int j = i + STAGES - 1;
    if (j < nch)
      load_chunk(ring + (j % STAGES) * CH * stride, kpool, tb, j * CH, n_live,
                 blk, tok_stride, head_off, hd, stride, vec);
    cp_commit();
    cp_wait();
    __syncthreads();
    chunk_scores(qs, ring + (i % STAGES) * CH * stride, ps, R, hd, stride,
                 sps, i * CH, scale);
    __syncthreads();
  }

  // phase 2: the first V chunks stream in while the cluster agrees on the
  // softmax; the query rows are dead, their space becomes the partial P.V
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < nch)
      load_chunk(ring + i * CH * stride, vpool, tb, i * CH, n_live, blk,
                 tok_stride, head_off, hd, stride, vec);
    cp_commit();
  }
  for (int i = tid; i < R * hd; i += THREADS) os[i] = 0.f;
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  for (int r = warp; r < R; r += WARPS) {
    const int n = min(max(frontier(kvl, W, r / G, S) - s0, 0), span);
    float mx = -INFINITY;
    for (int j = lane; j < n; j += 32) mx = fmaxf(mx, ps[r * sps + j]);
    mx = warp_max(mx);
    if (lane < C) *cluster.map_shared_rank(gmax + c * R + r, lane) = mx;
  }
  cluster.sync();
  for (int r = warp; r < R; r += WARPS) {
    const int n = min(max(frontier(kvl, W, r / G, S) - s0, 0), span);
    float mx = -INFINITY;
    for (int cc = 0; cc < C; ++cc) mx = fmaxf(mx, gmax[cc * R + r]);
    float sum = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float e = expf(ps[r * sps + j] - mx);
      ps[r * sps + j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    if (lane < C) *cluster.map_shared_rank(gsum + c * R + r, lane) = sum;
  }
  cluster.sync();
  for (int r = warp; r < R; r += WARPS) {
    const int n = min(max(frontier(kvl, W, r / G, S) - s0, 0), span);
    float l = 0.f;
    for (int cc = 0; cc < C; ++cc) l += gsum[cc * R + r];   // rank order
    for (int j = lane; j < nch * CH; j += 32)
      ps[r * sps + j] = j < n ? to_f(from_f<T>(ps[r * sps + j] / l)) : 0.f;
  }
  __syncthreads();

  // phase 3: the partial P.V over the live V chunks
  for (int i = 0; i < nch; ++i) {
    const int j = i + STAGES - 1;
    if (j < nch)
      load_chunk(ring + (j % STAGES) * CH * stride, vpool, tb, j * CH, n_live,
                 blk, tok_stride, head_off, hd, stride, vec);
    cp_commit();
    cp_wait();
    __syncthreads();
    chunk_pv(ps, ring + (i % STAGES) * CH * stride, os, R, hd, stride, sps,
             i * CH);
    __syncthreads();
  }

  // phase 4: each rank's partial of every output element goes to the
  // rank that owns the element's slice; the owner sums its slice over the
  // C partials in rank order, casts and stores it.  Rows whose frontier
  // is 0 store exact zeros.  After the barrier no CTA touches another's
  // shared memory, so none has to wait for the others to finish.
  const int E = R * hd;
  const int per = (E + C - 1) / C;
  for (int e = tid; e < E; e += THREADS) {
    const int owner = e / per;
    *cluster.map_shared_rank(recv + c * per + (e - owner * per), owner) =
        os[e];
  }
  cluster.sync();
  const int e1 = min(E, (c + 1) * per);
  for (int e = c * per + tid; e < e1; e += THREADS) {
    const int row = e / hd, d = e - row * hd;
    const int t = row / G;
    float acc = 0.f;
    if (frontier(kvl, W, t, S) > 0) {
      const int k = e - c * per;
      acc = recv[k];
      for (int cc = 1; cc < C; ++cc) acc += recv[cc * per + k];  // rank order
    }
    out[(head0 + (size_t)t * Hq + (row - t * G)) * hd + d] = from_f<T>(acc);
  }
}

template <typename T>
int launch(const void* q, const void* kpool, const void* vpool,
           const void* tbl, const void* kv_len, void* out, int B, int W,
           int Hq, int Hkv, int hd, int num_blocks, int blk, int max_blocks,
           int C, int P, float scale, size_t smem, int vec,
           cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      paged_attn_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, Hkv, B);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, paged_attn_kernel<T>,
                         static_cast<const T*>(q),
                         static_cast<const T*>(kpool),
                         static_cast<const T*>(vpool),
                         static_cast<const int*>(tbl),
                         static_cast<const int*>(kv_len), static_cast<T*>(out),
                         W, Hq, Hkv, hd, num_blocks, blk, max_blocks, P, scale,
                         vec);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// q: (B, W, Hq, hd) — W = 1 is a decode step, W > 1 the speculative
// verify of W new positions whose K/V are already in the pool at
// kv_len - W .. kv_len - 1; kpool/vpool: (num_blocks, blk, Hkv, hd); tbl:
// (B, max_blocks) int32; kv_len: (B,) int32, the TOTAL length including
// the W new entries; out: (B, W, Hq, hd).  All contiguous; q/pools/out
// share one dtype (is_bf16: bfloat16, else float32).  cluster, span and
// smem_bytes come from ops.py:paged_geometry (cluster = min(8,
// max_blocks), span = ceil(max_blocks / cluster) table blocks per CTA);
// a launch whose smem_bytes is below the kernel's carve is refused with
// cudaErrorInvalidValue.  Returns cudaGetLastError() after the launch.
extern "C" int paged_attn_fwd(const void* q, const void* kpool,
                              const void* vpool, const void* tbl,
                              const void* kv_len, void* out, int B, int W,
                              int Hq, int Hkv, int hd, int num_blocks,
                              int blk, int max_blocks, int is_bf16,
                              int cluster, int span, int smem_bytes,
                              void* stream) {
  if (W <= 0 || hd <= 0 || hd > MAX_HD || Hkv <= 0 || Hq % Hkv != 0 ||
      num_blocks <= 0 || blk <= 0 || max_blocks <= 0 || B < 0 ||
      B > 65535 || Hkv > 65535 || cluster <= 0 || cluster > MAX_CLUSTER ||
      span <= 0 || (long long)cluster * span < max_blocks || smem_bytes < 0)
    return (int)cudaErrorInvalidValue;
  const int esz = is_bf16 ? 2 : 4;
  const Carve cv = carve(W * (Hq / Hkv), hd, esz, span * blk, span);
  if ((size_t)smem_bytes < cv.total) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaGetLastError();
  const float scale = (float)(1.0 / sqrt((double)hd));
  // 16-byte copies need 16-byte token rows and 16-byte aligned tensors
  const int vec = (hd * esz) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(kpool) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(vpool) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, kpool, vpool, tbl, kv_len, out, B, W, Hq,
                                 Hkv, hd, num_blocks, blk, max_blocks, cluster,
                                 span, scale, (size_t)smem_bytes, vec, s);
  return launch<float>(q, kpool, vpool, tbl, kv_len, out, B, W, Hq, Hkv, hd,
                       num_blocks, blk, max_blocks, cluster, span, scale,
                       (size_t)smem_bytes, vec, s);
}

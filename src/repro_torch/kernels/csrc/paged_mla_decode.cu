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
//   s[k] = (dot(q_lat[t][h], ckv[k]) + dot(q_rope[t][h], krope[k])) * scale
//   p = softmax(s) in float32 (one exact pass, no online rescaling),
//       rounded to the cache dtype
//   ctx[t][h][:] = sum_k p[k] * ckv[k][:], accumulated in float32
// the reference's op order (ops.py:343-363, layers.py:294-307).  The
// caller applies Wv_b and wo.
//
// What bounds it on an H100: every query head of a row shares one latent
// key, so the live latent (kv_len * (r + rh) * sizeof(T)) is the only
// large input.  At full width (128 heads, r = 512, rh = 64, bf16) a key
// costs 128 * (2 * 576 + 2 * 512) ~ 279 KFLOP per position against 1152 B:
// ~242 FLOP/B, just under the ~295 FLOP/B bf16 ridge (W = 5: ~1200
// FLOP/B, above it).  The least time, the larger of the bytes over 3.35
// TB/s and the FLOPs over 989 TFLOP/s, is about a microsecond at the
// serving shapes (a few hundred live keys a row), so what the card really
// waits on is latency: the table -> latent dependency, the first stages'
// loads, the cluster barriers and the exchange of partial sums.
//
// Design: the keys of row b are split over a thread-block cluster, as the
// GQA kernel (paged_decode.cu) splits them, with the W x H query rows of
// the row cut into row tiles.  The launch geometry comes from the wrapper
// (ops.py:mla_geometry): C = min(8, max_blocks) CTAs of a cluster, CTA
// rank c owning table blocks [c*P, min((c+1)*P, max_blocks)) with
// P = ceil(max_blocks / C); RT in {64, 32, 16} query rows a tile, rows
// flattened as row = t*H + h, each masked at its own frontier; NS ring
// stages of CH = 16 tokens.  The grid is (C, ceil(W*H / RT), B) in
// clusters of (C, 1, 1).  The live ranks of a tile are those whose span
// holds a key of its widest row.  Each CTA:
//   0. reads its span's table entries (clamped into the pool) and starts
//      the cp.async copies of its first NS - 1 stages (every stage when the
//      span's live stages fit in the ring: the span is then resident),
//      ckv and krope rows together (tails zero-filled with src-size 0:
//      0 x NaN from stale shared memory would poison the output); after a
//      cluster barrier the live ranks copy the query tile [q_lat | 0 |
//      q_rope | 0] once per cluster, each an RT / L share of the rows with
//      cp.async.bulk multicast into every live rank, completing on an
//      mbarrier.  A tile whose keys all lie in rank 0's span runs on rank
//      0 alone ("solo"): the other ranks leave at once and rank 0 takes no
//      cluster barrier;
//   1. writes float32 scores for its span, stage by stage.  bf16:
//      mma.sync.m16n8k16 with float32 accumulation over k = r + rh; two
//      warps per 16-row m-tile split the k-steps in fixed halves, each
//      holding its half of the query fragments in registers for the whole
//      phase, running a fixed 20 k-steps without branches (steps past the
//      half take zero fragments) on four accumulator chains per n-tile,
//      with the key fragment loaded a step ahead; the halves meet in
//      shared memory on a named barrier of the pair.  float32: FMA chains
//      on the CUDA cores (no TF32), each thread 1 key x RT/16 rows;
//   2. takes ONE exact float32 softmax across the cluster through
//      distributed shared memory: each CTA stores its row maxima into every
//      rank's shared memory, cluster.sync(), takes the global max
//      (order-free), e = exp(s - m) and local sums, stores the sums the
//      same way, cluster.sync(), l = the sum of the C local sums in rank
//      order, p = round_T(e / l).  Solo: the same in the CTA.  Meanwhile
//      the first ckv stages stream in again unless the span is resident;
//   3. accumulates its partial RT x r P.V in registers: warp w owns
//      columns [64w, 64w + 64); bf16 takes p as the A operand of mma.sync
//      and ckv through ldmatrix.trans, float32 runs FMA chains.  Solo:
//      stored straight to out.  Else cluster.sync() (no rank reads its
//      queries, scores or ring after it), each live rank stores its
//      partials from registers, 16 bytes a store, through distributed
//      shared memory into the rank that owns those columns (rank c owns
//      [c*Wc, (c+1)*Wc), Wc = 64 at r = 512, C = 8), into a receive
//      buffer that aliases the query/score/ring region, cluster.sync(),
//      and each rank sums its columns over the live ranks' partials in
//      rank order, casts and stores them.
// No second launch, no workspace in device memory.  Shared memory per CTA
// (bf16, r 512, rh 64): 74 752 B of queries at RT = 64, RT x (span + 8)
// float32 scores, 18 688 B a ring stage; the float32 partials take
// 131 072 B at C = 8 in the same bytes, so a table of up to ~19 000
// tokens fits.
//
// Why verify position t equals a decode launch at its frontier, bitwise:
// C and P depend only on max_blocks, so both run the same spans, and the
// ring's stages start at span-relative multiples of CH whatever W is; a
// query row's arithmetic depends only on that row, its frontier and the
// keys (the k-step halves, the 20 steps and the accumulation chains are
// fixed by r and rh, never by RT, NS or W; a key beyond a row's frontier
// enters P.V with p = 0 exactly); in mma.sync each output element depends
// only on its row of A and its column of B; every reduction order is fixed
// by key index and rank, and a rank that is dead for a tile contributes
// exact zeros (-inf to the max, 0 to the sums and partials), so leaving it
// out, as solo tiles and the exchange do, changes no value.  Decode is
// the W = 1 case of the same body.
// A row whose frontier is <= 0 writes exact zeros; a frontier beyond the
// table is clamped to it.  Freed scheduler slots run at pos 0 against an
// all-zero table row: they read the trash block 0, which always exists.
// Table entries are clamped into the pool, so a bad table cannot fault.
// A CTA whose span holds no live key takes part in every barrier of a
// tile that is not solo.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_R = 512;           // latent rank: 8 warps x 64 columns
constexpr int MAX_RH = 128;          // rope width
constexpr int MAX_CLUSTER = 8;       // the portable cluster size
constexpr int CH = 16;               // tokens per ring stage
constexpr int MAX_STAGES = 8;        // ring stages: NS - 1 in flight
constexpr int COLS_PER_WARP = 64;    // P.V output columns a warp owns
// k-steps of 16 a warp holds in registers: half of (MAX_R + MAX_RH) / 16
constexpr int KH_MAX = (MAX_R + MAX_RH) / 32;

__host__ __device__ constexpr size_t up(size_t x, size_t a) {
  return (x + a - 1) / a * a;
}

// Shared-memory carve of one CTA, in bytes.  ops.py:mla_geometry is the
// one formula the wrapper uses; the entry point refuses a launch whose
// dynamic shared memory is smaller than this carve.  A token or query row
// is [ckv | 0 to rp | krope | 0 to kp | 16 bytes], ks elements.
//   [0]:  query rows [RT][ks] in T, then scores ps and the ring; from the
//         partial exchange on, the receive buffer recv [C][RT][wc] float32
//         (written by the ranks themselves), in the same bytes
//   ps:   scores, then probabilities, [RT][sps] float32
//   ring: [NS][CH][ks] in T, NS stages (2 <= NS <= MAX_STAGES)
//   red:  every rank's row maxima, then row sums, [2][MAX_CLUSTER][RT]
//         float32, written by the ranks themselves
//   tb:   the span's physical block ids, [P] int32
//   bar:  the query tile's mbarrier, 8 bytes (16 reserved)
struct Carve {
  int rp, kp, ks, sps, wc;
  size_t ps, ring, red, tb, bar, total;
};

__host__ __device__ inline Carve carve(int RT, int r, int rh, int esz,
                                       int span, int P, int C, int NS) {
  Carve c;
  c.rp = (int)up(r, 16);
  c.kp = c.rp + (int)up(rh, 16);
  c.ks = c.kp + 16 / esz;
  c.sps = (int)up(span, CH) + 8;
  const int r8 = (int)up(r, 8);
  c.wc = (int)up((r8 + C - 1) / C, 8);
  c.ps = up((size_t)RT * c.ks * esz, 16);
  c.ring = c.ps + up((size_t)RT * c.sps * 4, 16);
  const size_t a_end = c.ring + up((size_t)NS * CH * c.ks * esz, 16);
  const size_t recv = up((size_t)C * RT * c.wc * 4, 16);
  c.red = a_end > recv ? a_end : recv;
  c.tb = c.red + up((size_t)2 * MAX_CLUSTER * RT * 4, 16);
  c.bar = c.tb + up((size_t)P * 4, 16);
  c.total = c.bar + 16;
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
// every copy group but the newest n (0 <= n < MAX_STAGES) has landed
__device__ __forceinline__ void cp_wait(int n) {
  switch (n) {
#define MLA_WAIT(k) \
  case k:           \
    asm volatile("cp.async.wait_group " #k ";\n" ::: "memory"); break;
    MLA_WAIT(0) MLA_WAIT(1) MLA_WAIT(2) MLA_WAIT(3) MLA_WAIT(4) MLA_WAIT(5)
    MLA_WAIT(6)
#undef MLA_WAIT
    default:
      asm volatile("cp.async.wait_group 7;\n" ::: "memory");
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t* d, const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(s)
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t* d, const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(s)
      : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          (unsigned)__cvta_generic_to_shared(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"((unsigned)__cvta_generic_to_shared(bar)),
      "r"(parity)
      : "memory");
}
// bytes (a multiple of 16) from global src to the same shared-memory
// offset as dst in every CTA of mask, completing on each one's bar
__device__ __forceinline__ void bulk_multicast(void* dst, const void* src,
                                               int bytes, uint64_t* bar,
                                               uint16_t mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1], %2, [%3], %4;\n" ::"r"(
          (unsigned)__cvta_generic_to_shared(dst)),
      "l"(src), "r"(bytes), "r"((unsigned)__cvta_generic_to_shared(bar)),
      "h"(mask)
      : "memory");
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
__device__ __forceinline__ uint32_t pack_bf16(float2 v) {
  __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ void store4(float* o, float4 v) {
  *reinterpret_cast<float4*>(o) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* o, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(o) = u;
}

// out row qrow0 + rr, columns [col, col + 4) that lie below r, from v
// (zeros when dead); rows past nrows are not stored
template <typename T>
__device__ __forceinline__ void store_row(T* out, size_t qrow0, int rr,
                                          int nrows, int col, int r,
                                          float4 v, bool dead) {
  if (rr >= nrows) return;
  if (dead) v = make_float4(0.f, 0.f, 0.f, 0.f);
  T* o = out + (qrow0 + rr) * r + col;
  if (r % 4 == 0 && col + 4 <= r) {
    store4(o, v);
  } else {
    const float a4[4] = {v.x, v.y, v.z, v.w};
    for (int u = 0; u < 4 && col + u < r; ++u) o[u] = from_f<T>(a4[u]);
  }
}

// Copies span tokens [j0, j0 + CH) into a ring stage: ckv to columns
// [0, r), and with the rope krope to [rp, rp + rh); tokens at or beyond
// n_live are zero-filled.  Padding columns are never written.
template <typename T>
__device__ __noinline__ void load_stage(T* dst, const T* __restrict__ ckv,
                                           const T* __restrict__ krope,
                                           const int* tb, int j0, int n_live,
                                           int blk, int r, int rh, int rp,
                                           int ks, bool rope, bool vec) {
  if (vec) {
    constexpr int PER = 16 / sizeof(T);
    const int nvc = r / PER;
    const int nv = nvc + (rope ? rh / PER : 0);
    for (int i = threadIdx.x; i < CH * nv; i += THREADS) {
      const int tok = i / nv, v = i - tok * nv;
      const int j = j0 + tok;
      const bool lat = v < nvc;
      T* d = dst + tok * ks + (lat ? v * PER : rp + (v - nvc) * PER);
      if (j < n_live) {
        const size_t row = (size_t)tb[j / blk] * blk + j % blk;
        const T* s = lat ? ckv + row * r + v * PER
                         : krope + row * rh + (v - nvc) * PER;
        cp_async16(d, s, 16);
      } else {
        cp_async16(d, ckv, 0);
      }
    }
  } else {
    const int nd = r + (rope ? rh : 0);
    for (int i = threadIdx.x; i < CH * nd; i += THREADS) {
      const int tok = i / nd, dd = i - tok * nd;
      const int j = j0 + tok;
      const bool lat = dd < r;
      T v = from_f<T>(0.f);
      if (j < n_live) {
        const size_t row = (size_t)tb[j / blk] * blk + j % blk;
        v = lat ? ckv[row * r + dd] : krope[row * rh + (dd - r)];
      }
      dst[tok * ks + (lat ? dd : rp + dd - r)] = v;
    }
  }
}

template <typename T, int RT>
__global__ void __launch_bounds__(THREADS, 1)
paged_mla_kernel(const T* __restrict__ q_lat, const T* __restrict__ q_rope,
                 const T* __restrict__ ckv, const T* __restrict__ krope,
                 const int* __restrict__ tbl, const int* __restrict__ kv_len,
                 T* __restrict__ out, int W, int H, int r, int rh,
                 int num_blocks, int blk, int max_blocks, int P, int NS,
                 float scale, int vec) {
  constexpr bool BF16 = std::is_same<T, __nv_bfloat16>::value;
  constexpr int MT = RT / 16;          // m-tiles of 16 rows
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int c = (int)cluster.block_rank();
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;

  const int rows = W * H;              // query rows of b: row = t * H + h
  const int row0 = blockIdx.y * RT;
  const int nrows = min(RT, rows - row0);
  const int S = max_blocks * blk;      // table capacity in tokens
  const int span = P * blk;
  const Carve cv = carve(RT, r, rh, (int)sizeof(T), span, P, C, NS);
  const int rp = cv.rp, kp = cv.kp, ks = cv.ks, sps = cv.sps, wc = cv.wc;
  T* qs = reinterpret_cast<T*>(smem);
  float* ps = reinterpret_cast<float*>(smem + cv.ps);
  T* ring = reinterpret_cast<T*>(smem + cv.ring);
  float* recv = reinterpret_cast<float*>(smem);
  float* gmax = reinterpret_cast<float*>(smem + cv.red);  // [rank][row]
  float* gsum = gmax + MAX_CLUSTER * RT;                   // [rank][row]
  int* tb = reinterpret_cast<int*>(smem + cv.tb);
  uint64_t* qbar = reinterpret_cast<uint64_t*>(smem + cv.bar);

  const int kvl = kv_len[b];
  const int s0 = c * span;             // first token of this CTA's span
  // span-local keys of tile row rr (0 past the tile's last row)
  auto row_live = [&](int rr) {
    if (rr >= nrows) return 0;
    const int f = frontier(kvl, W, (row0 + rr) / H, S);
    return min(max(f - s0, 0), span);
  };
  // tile row rr attends to no key: its output is exact zeros
  auto row_dead = [&](int rr) {
    return frontier(kvl, W, (row0 + rr) / H, S) == 0;
  };
  // the tile's last row has its widest frontier
  const int n_live = row_live(nrows - 1);
  const int nch = (n_live + CH - 1) / CH;
  // all live stages fit in the ring: phase 3 reuses them, no re-stream
  const bool resident = nch <= NS;
  // live ranks: those whose span holds a key of the tile's widest row
  // (rank c is live exactly when nch > 0).  A tile whose keys all lie in
  // rank 0's span runs on rank 0 alone ("solo"): no exchange, the others
  // leave after phase 0.  Its arithmetic is the cluster path's with the
  // dead ranks' exact zeros left out, so it agrees bitwise.
  const int L =
      min(C, (frontier(kvl, W, (row0 + nrows - 1) / H, S) + span - 1) / span);
  const bool solo = L <= 1;
  // a solo tile touches no other CTA's shared memory: the idle ranks leave
  // at once, and rank 0 waits on no cluster barrier
  if (solo && c > 0) return;
  const size_t qrow0 = (size_t)b * rows + row0;   // q and out: (B*W*H, r|rh)
  const int* trow = tbl + (size_t)b * max_blocks;

  // phase 0: the span's table entries; zeros in the query tile's padding
  // rows and columns and in the ring's padding columns; the query rows.
  // With 16-byte rows each rank copies every C-th row once, multicast
  // into all C ranks (cp.async.bulk, completing on qbar): the cluster
  // reads its query tile from L2 once, not C times.
  for (int i = tid; i < P; i += THREADS) {
    const int bi = c * P + i;
    tb[i] = bi < max_blocks ? min(max(trow[bi], 0), num_blocks - 1) : 0;
  }
  if (vec && tid == 0) {
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the first NS - 1 stages (all of a resident span) start now, under the
  // zeroing and the cluster barrier
  for (int i = 0; i < NS - 1; ++i) {
    if (i < nch)
      load_stage(ring + i * CH * ks, ckv, krope, tb, i * CH, n_live, blk, r,
                 rh, rp, ks, true, vec);
    cp_commit();
  }
  if (resident && nch == NS)
    load_stage(ring + (NS - 1) * CH * ks, ckv, krope, tb, (NS - 1) * CH,
               n_live, blk, r, rh, rp, ks, true, vec);
  const int npad = (rp - r) + (kp - rp - rh);   // padding columns a row
  for (int i = tid; i < (RT - nrows) * kp; i += THREADS)
    qs[(nrows + i / kp) * ks + i % kp] = from_f<T>(0.f);
  for (int i = tid; i < nrows * npad; i += THREADS) {
    const int rr = i / npad, k = i - rr * npad;
    qs[rr * ks + (k < rp - r ? r + k : rp + rh + k - (rp - r))] =
        from_f<T>(0.f);
  }
  for (int i = tid; i < NS * CH * npad; i += THREADS) {
    const int tok = i / npad, k = i - tok * npad;
    ring[tok * ks + (k < rp - r ? r + k : rp + rh + k - (rp - r))] =
        from_f<T>(0.f);
  }
  if (!vec) {
    for (int i = tid; i < nrows * (r + rh); i += THREADS) {
      const int rr = i / (r + rh), d = i - rr * (r + rh);
      qs[rr * ks + (d < r ? d : rp + d - r)] =
          d < r ? q_lat[(qrow0 + rr) * r + d]
                : q_rope[(qrow0 + rr) * rh + d - r];
    }
  }
  // every rank has started and initialised its barrier before any rank
  // writes to its shared memory
  if (!solo) cluster.sync();
  if (vec && nch > 0) {              // the live ranks share the tile
    if (tid == 0) mbar_expect_tx(qbar, nrows * (r + rh) * (int)sizeof(T));
    const uint16_t all = (uint16_t)((1u << L) - 1);
    for (int i = tid; i < 2 * nrows; i += THREADS) {
      const int rr = i >> 1;
      if (rr % L != c) continue;
      if (i & 1)
        bulk_multicast(qs + rr * ks + rp, q_rope + (qrow0 + rr) * rh,
                       rh * (int)sizeof(T), qbar, all);
      else
        bulk_multicast(qs + rr * ks, q_lat + (qrow0 + rr) * r,
                       r * (int)sizeof(T), qbar, all);
    }
  }

  // phase 1: scores over the live stages, NS - 1 stages in flight; a span
  // whose live stages all fit was loaded at once and is waited on once
  if (resident) asm volatile("cp.async.wait_all;\n" ::: "memory");
  if (vec && nch > 0) mbar_wait(qbar, 0);
  __syncthreads();
  // the next stage into the ring (not resident): NS - 1 stages in flight,
  // stage i landed and visible to every thread
  auto next_stage = [&](int i, bool rope) {
    const int j = i + NS - 1;
    if (j < nch)
      load_stage(ring + (j % NS) * CH * ks, ckv, krope, tb, j * CH, n_live,
                 blk, r, rh, rp, ks, rope, vec);
    cp_commit();
    cp_wait(NS - 1);
    __syncthreads();
  };
  if constexpr (BF16) {
    // warp = (m-tile mt, k half kh); the half's query fragments live in
    // registers for the whole phase; the two warps of an m-tile meet on
    // named barrier 1 + mt
    const int nk = kp / 16, nkh = (nk + 1) / 2;
    const int mt = warp >> 1, kh = warp & 1;
    const bool active = mt < MT;
    const int k_lo = kh ? nkh : 0, k_n = kh ? nk - nkh : nkh;
    // KH_MAX k-steps whatever k_n, without branches: the steps past k_n
    // take zero query fragments (and a key fragment from a valid address),
    // so they add exact zeros
    uint32_t af[KH_MAX][4];
    if (active && nch > 0) {
      const T* a_ptr = qs + (mt * 16 + (lane & 15)) * ks + (lane >> 4) * 8 +
                       k_lo * 16;
#pragma unroll
      for (int kk = 0; kk < KH_MAX; ++kk) {
        ldsm_x4(af[kk], a_ptr + min(kk, k_n - 1) * 16);
        if (kk >= k_n) af[kk][0] = af[kk][1] = af[kk][2] = af[kk][3] = 0u;
      }
    }
    const int b_off = ((lane & 7) + (lane >> 4) * 8) * ks +
                      ((lane >> 3) & 1) * 8 + k_lo * 16;
    const int r0 = mt * 16 + g;
    for (int i = 0; i < nch; ++i) {
      if (!resident) next_stage(i, true);
      if (active) {
        const T* kb = ring + (i % NS) * CH * ks + b_off;
        float acc[2][4][4];            // [n-tile][k-step mod 4][fragment]
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int p = 0; p < 4; ++p)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[n][p][e] = 0.f;
        uint32_t bf[2][4];             // key fragments, one k-step ahead
        ldsm_x4(bf[0], kb);
#pragma unroll
        for (int kk = 0; kk < KH_MAX; ++kk) {
          if (kk + 1 < KH_MAX)
            ldsm_x4(bf[(kk + 1) & 1], kb + min(kk + 1, k_n - 1) * 16);
          mma_16816(acc[0][kk & 3], af[kk], bf[kk & 1]);
          mma_16816(acc[1][kk & 3], af[kk], bf[kk & 1] + 2);
        }
        float sc[2][4];                // [n-tile][fragment]
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sc[n][e] = (acc[n][0][e] + acc[n][1][e]) +
                       (acc[n][2][e] + acc[n][3][e]);
        if (kh == 0) {                 // the low half goes first
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            const int col = i * CH + n * 8 + tq * 2;
            *reinterpret_cast<float2*>(ps + r0 * sps + col) =
                make_float2(sc[n][0], sc[n][1]);
            *reinterpret_cast<float2*>(ps + (r0 + 8) * sps + col) =
                make_float2(sc[n][2], sc[n][3]);
          }
        }
        asm volatile("bar.sync %0, 64;\n" ::"r"(1 + mt) : "memory");
        if (kh == 1) {                 // s = (low + high) * scale
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            const int col = i * CH + n * 8 + tq * 2;
            float2* p0 = reinterpret_cast<float2*>(ps + r0 * sps + col);
            float2* p1 = reinterpret_cast<float2*>(ps + (r0 + 8) * sps + col);
            const float2 lo0 = *p0, lo1 = *p1;
            *p0 = make_float2((lo0.x + sc[n][0]) * scale,
                              (lo0.y + sc[n][1]) * scale);
            *p1 = make_float2((lo1.x + sc[n][2]) * scale,
                              (lo1.y + sc[n][3]) * scale);
          }
        }
      }
      if (!resident) __syncthreads();  // the ring slot is read
    }
  } else {
    // thread = (key jk of the stage, row group rg): rows rg + 16 m
    const int jk = tid % CH, rg = tid / CH;
    for (int i = 0; i < nch; ++i) {
      if (!resident) next_stage(i, true);
      const float* kr = reinterpret_cast<const float*>(ring) +
                        ((i % NS) * CH + jk) * ks;
      float acc[MT];
#pragma unroll
      for (int m = 0; m < MT; ++m) acc[m] = 0.f;
      for (int d = 0; d < kp; d += 4) {
        const float4 k4 = *reinterpret_cast<const float4*>(kr + d);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const float4 q4 = *reinterpret_cast<const float4*>(
              reinterpret_cast<const float*>(qs) + (rg + 16 * m) * ks + d);
          acc[m] = fmaf(q4.x, k4.x, acc[m]);
          acc[m] = fmaf(q4.y, k4.y, acc[m]);
          acc[m] = fmaf(q4.z, k4.z, acc[m]);
          acc[m] = fmaf(q4.w, k4.w, acc[m]);
        }
      }
#pragma unroll
      for (int m = 0; m < MT; ++m)
        ps[(rg + 16 * m) * sps + i * CH + jk] = acc[m] * scale;
      if (!resident) __syncthreads();  // the ring slot is read
    }
  }
  // every copy has landed (a dead rank receives no query rows): nothing
  // may land in the bytes the receive buffer reuses
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // phase 2: the first ckv stages stream in while the cluster agrees on
  // the softmax
  for (int i = 0; i < NS - 1 && !resident; ++i) {
    if (i < nch)
      load_stage(ring + i * CH * ks, ckv, krope, tb, i * CH, n_live, blk, r,
                 rh, rp, ks, false, vec);
    cp_commit();
  }
  for (int rr = warp; rr < RT; rr += WARPS) {
    const int n = row_live(rr);
    float mx = -INFINITY;
    for (int j = lane; j < n; j += 32) mx = fmaxf(mx, ps[rr * sps + j]);
    mx = warp_max(mx);
    if (solo)
      gmax[rr] = mx;
    else if (lane < C)
      *cluster.map_shared_rank(gmax + c * RT + rr, lane) = mx;
  }
  if (solo)
    __syncthreads();
  else
    cluster.sync();
  for (int rr = warp; rr < RT; rr += WARPS) {
    const int n = row_live(rr);
    float mx = -INFINITY;
    for (int cc = 0; cc < (solo ? 1 : C); ++cc)
      mx = fmaxf(mx, gmax[cc * RT + rr]);
    float sum = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float e = expf(ps[rr * sps + j] - mx);
      ps[rr * sps + j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    if (solo)
      gsum[rr] = sum;
    else if (lane < C)
      *cluster.map_shared_rank(gsum + c * RT + rr, lane) = sum;
  }
  if (solo)
    __syncthreads();
  else
    cluster.sync();
  for (int rr = warp; rr < RT; rr += WARPS) {
    const int n = row_live(rr);
    float l = 0.f;
    for (int cc = 0; cc < (solo ? 1 : C); ++cc)   // rank order
      l += gsum[cc * RT + rr];
    for (int j = lane; j < nch * CH; j += 32)
      ps[rr * sps + j] = j < n ? to_f(from_f<T>(ps[rr * sps + j] / l)) : 0.f;
  }
  __syncthreads();

  // phase 3: the partial P.V over the live stages, in registers; warp w
  // owns columns [64 w, 64 w + 64) of up(r, 8)
  const int r8 = (r + 7) / 8 * 8;
  const int c_lo = warp * COLS_PER_WARP;
  if constexpr (BF16) {
    constexpr int NT = COLS_PER_WARP / 8;     // n-tiles of 8 columns
    const int nt_live = min(NT, max(0, (r8 - c_lo) / 8));
    float acc[MT][NT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;
    // ldmatrix.trans rows: tokens (lane & 7) + 8 ((lane >> 3) & 1), columns
    // c_lo + 8 (lane >> 4) + 16 pair
    const int v_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * ks + c_lo +
                      (lane >> 4) * 8;
    for (int i = 0; i < nch; ++i) {
      if (!resident) next_stage(i, false);
      if (nt_live > 0) {
        uint32_t a[MT][4];
        const int k0 = i * CH + tq * 2;
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const float* p0 = ps + (m * 16 + g) * sps + k0;
          const float* p1 = p0 + 8 * sps;
          a[m][0] = pack_bf16(*reinterpret_cast<const float2*>(p0));
          a[m][1] = pack_bf16(*reinterpret_cast<const float2*>(p1));
          a[m][2] = pack_bf16(*reinterpret_cast<const float2*>(p0 + 8));
          a[m][3] = pack_bf16(*reinterpret_cast<const float2*>(p1 + 8));
        }
        // every n-tile pair without branches: a pair past nt_live reads a
        // valid one and multiplies zeros (its columns are never stored)
        const T* vb = ring + (i % NS) * CH * ks + v_off;
        uint32_t bf[NT / 2][4];
#pragma unroll
        for (int pr = 0; pr < NT / 2; ++pr) {
          ldsm_x4_t(bf[pr], vb + min(pr, (nt_live - 1) / 2) * 16);
          if (2 * pr >= nt_live)
            bf[pr][0] = bf[pr][1] = bf[pr][2] = bf[pr][3] = 0u;
        }
#pragma unroll
        for (int pr = 0; pr < NT / 2; ++pr) {
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            mma_16816(acc[m][2 * pr], a[m], bf[pr]);
            mma_16816(acc[m][2 * pr + 1], a[m], bf[pr] + 2);
          }
        }
      }
      if (!resident) __syncthreads();
    }
    // no rank reads its queries, scores or ring past this barrier: the
    // receive buffer may overwrite them
    if (!solo) cluster.sync();
    // lanes tq and tq ^ 1 swap halves so that each holds 4 consecutive
    // columns of one row: even tq row g, odd tq row g + 8.  Solo: stored
    // straight to out; else, from a live rank, into the owner's receive
    // buffer (16 bytes a store)
    const bool odd = tq & 1;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      if (n < nt_live && (solo || c < L)) {
        const int col = c_lo + n * 8 + (tq & 2) * 2;
        const int owner = col / wc, lc = col - owner * wc;
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const float* f = acc[m][n];
          const float s0 = __shfl_xor_sync(0xffffffffu, odd ? f[0] : f[2], 1);
          const float s1 = __shfl_xor_sync(0xffffffffu, odd ? f[1] : f[3], 1);
          const float4 v = odd ? make_float4(s0, s1, f[2], f[3])
                               : make_float4(f[0], f[1], s0, s1);
          const int rr = m * 16 + g + (odd ? 8 : 0);
          if (solo)
            store_row(out, qrow0, rr, nrows, col, r, v, row_dead(rr));
          else
            *reinterpret_cast<float4*>(cluster.map_shared_rank(
                recv + ((size_t)c * RT + rr) * wc + lc, owner)) = v;
        }
      }
    }
  } else {
    // thread: columns c_lo + 2 lane and + 1, every row
    const int col = c_lo + 2 * lane;
    const bool live = col < r8;
    float acc[RT][2];
#pragma unroll
    for (int m = 0; m < RT; ++m) acc[m][0] = acc[m][1] = 0.f;
    for (int i = 0; i < nch; ++i) {
      if (!resident) next_stage(i, false);
      if (live) {
        const float* vs = reinterpret_cast<const float*>(ring) +
                          (i % NS) * CH * ks + col;
        for (int jj = 0; jj < CH; jj += 4) {
          float2 v[4];
#pragma unroll
          for (int u = 0; u < 4; ++u)
            v[u] = *reinterpret_cast<const float2*>(vs + (jj + u) * ks);
#pragma unroll
          for (int m = 0; m < RT; ++m) {
            const float4 p4 = *reinterpret_cast<const float4*>(
                ps + m * sps + i * CH + jj);
            acc[m][0] = fmaf(p4.x, v[0].x, acc[m][0]);
            acc[m][1] = fmaf(p4.x, v[0].y, acc[m][1]);
            acc[m][0] = fmaf(p4.y, v[1].x, acc[m][0]);
            acc[m][1] = fmaf(p4.y, v[1].y, acc[m][1]);
            acc[m][0] = fmaf(p4.z, v[2].x, acc[m][0]);
            acc[m][1] = fmaf(p4.z, v[2].y, acc[m][1]);
            acc[m][0] = fmaf(p4.w, v[3].x, acc[m][0]);
            acc[m][1] = fmaf(p4.w, v[3].y, acc[m][1]);
          }
        }
      }
      if (!resident) __syncthreads();
    }
    if (!solo) cluster.sync();
    if (live && (solo || c < L)) {
      const int owner = col / wc, lc = col - owner * wc;
#pragma unroll
      for (int m = 0; m < RT; ++m) {
        if (solo) {
          if (m < nrows && col < r) {
            T* o = out + (qrow0 + m) * r + col;
            const bool dead = row_dead(m);
            o[0] = from_f<T>(dead ? 0.f : acc[m][0]);
            if (col + 1 < r) o[1] = from_f<T>(dead ? 0.f : acc[m][1]);
          }
        } else {
          float* d = cluster.map_shared_rank(
              recv + ((size_t)c * RT + m) * wc + lc, owner);
          *reinterpret_cast<float2*>(d) = make_float2(acc[m][0], acc[m][1]);
        }
      }
    }
  }
  if (solo) return;
  cluster.sync();

  // this rank's columns [c wc, (c + 1) wc), 4 at a time: the live ranks'
  // partials summed in rank order (a dead rank's are exact zeros), cast
  // and stored; rows whose frontier is 0 store exact zeros.  After the
  // barrier no CTA touches another's shared memory.
  const int cbase = c * wc;
  const int nq = max(0, min(wc, r8 - cbase)) / 4;   // column quads
  for (int e = tid; e < nrows * nq; e += THREADS) {
    const int rr = e / nq, k = (e - rr * nq) * 4;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    if (!row_dead(rr)) {
      acc = *reinterpret_cast<const float4*>(recv + (size_t)rr * wc + k);
      for (int cc = 1; cc < L; ++cc) {                    // rank order
        const float4 v = *reinterpret_cast<const float4*>(
            recv + ((size_t)cc * RT + rr) * wc + k);
        acc.x += v.x;
        acc.y += v.y;
        acc.z += v.z;
        acc.w += v.w;
      }
    }
    store_row(out, qrow0, rr, nrows, cbase + k, r, acc, false);
  }
}

template <typename T, int RT>
int launch(const void* q_lat, const void* q_rope, const void* ckv,
           const void* krope, const void* tbl, const void* kv_len, void* out,
           int B, int W, int H, int r, int rh, int num_blocks, int blk,
           int max_blocks, float scale, int C, int P, int NS, size_t smem,
           int vec, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      paged_mla_kernel<T, RT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, (W * H + RT - 1) / RT, B);
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
  e = cudaLaunchKernelEx(&cfg, paged_mla_kernel<T, RT>,
                         static_cast<const T*>(q_lat),
                         static_cast<const T*>(q_rope),
                         static_cast<const T*>(ckv),
                         static_cast<const T*>(krope),
                         static_cast<const int*>(tbl),
                         static_cast<const int*>(kv_len), static_cast<T*>(out),
                         W, H, r, rh, num_blocks, blk, max_blocks, P, NS,
                         scale, vec);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// q_lat: (B, W, H, r); q_rope: (B, W, H, rh) — W = 1 is a decode step,
// W > 1 the speculative verify of W new positions whose latents are
// already in the pool at kv_len - W .. kv_len - 1; ckv: (num_blocks, blk,
// r); krope: (num_blocks, blk, rh); tbl: (B, max_blocks) int32; kv_len:
// (B,) int32, the TOTAL length including the W new entries; out:
// (B, W, H, r).  All contiguous; queries, pools and out share one dtype
// (is_bf16: bfloat16, else float32).  cluster, span, row_tile, stages and
// smem_bytes come from ops.py:mla_geometry (cluster = min(8, max_blocks),
// span = ceil(max_blocks / cluster) table blocks per CTA, row_tile in
// {16, 32, 64}, 64 only for bf16, 2 <= stages <= 8 ring stages); a launch
// whose smem_bytes is below the kernel's carve is refused with
// cudaErrorInvalidValue.  Returns
// cudaGetLastError() after the launch.
extern "C" int paged_mla_fwd(const void* q_lat, const void* q_rope,
                             const void* ckv, const void* krope,
                             const void* tbl, const void* kv_len, void* out,
                             int B, int W, int H, int r, int rh,
                             int num_blocks, int blk, int max_blocks,
                             int is_bf16, float scale, int cluster, int span,
                             int row_tile, int stages, int smem_bytes,
                             void* stream) {
  if (W <= 0 || H <= 0 || r <= 0 || r > MAX_R || rh <= 0 || rh > MAX_RH ||
      num_blocks <= 0 || blk <= 0 || max_blocks <= 0 || B < 0 ||
      B > 65535 || cluster <= 0 || cluster > MAX_CLUSTER || span <= 0 ||
      (long long)cluster * span < max_blocks || smem_bytes < 0 ||
      stages < 2 || stages > MAX_STAGES ||
      !(row_tile == 16 || row_tile == 32 || (row_tile == 64 && is_bf16)) ||
      ((long long)W * H + row_tile - 1) / row_tile > 65535)
    return (int)cudaErrorInvalidValue;
  const int esz = is_bf16 ? 2 : 4;
  const Carve cv =
      carve(row_tile, r, rh, esz, span * blk, span, cluster, stages);
  if ((size_t)smem_bytes < cv.total) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaGetLastError();
  // 16-byte copies need 16-byte latent and rope rows and aligned tensors
  const int vec = (r * esz) % 16 == 0 && (rh * esz) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(q_lat) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(q_rope) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(ckv) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(krope) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)smem_bytes;
#define MLA_ARGS                                                             \
  q_lat, q_rope, ckv, krope, tbl, kv_len, out, B, W, H, r, rh, num_blocks,   \
      blk, max_blocks, scale, cluster, span, stages, smem, vec, s
  if (is_bf16) {
    if (row_tile == 64) return launch<__nv_bfloat16, 64>(MLA_ARGS);
    if (row_tile == 32) return launch<__nv_bfloat16, 32>(MLA_ARGS);
    return launch<__nv_bfloat16, 16>(MLA_ARGS);
  }
  if (row_tile == 32) return launch<float, 32>(MLA_ARGS);
  return launch<float, 16>(MLA_ARGS);
#undef MLA_ARGS
}

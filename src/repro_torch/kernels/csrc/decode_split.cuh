// The split-KV decode body for Hopper, shared by flash_decode.cu (contiguous
// ring cache) and flash_decode_paged.cu (paged pool), so both compute with
// the same plan, tiles, products and merge: the paged kernel at page 64 and
// one query token gives results bitwise equal to flash_decode over the
// gathered pages.
//
// The work. A unit is (batch row b, kv head h, row tile): the q rows of a
// GQA group (times the T query tokens of a paged call, row = g T + t),
// FEW_ROWS a unit in the few-row body, taken where a group has up to
// FEW_ROWS rows (few_row_body), ROW_TILE a unit in the many-row body. The
// key positions are cut into KEY_TILE-key tiles, and a unit's tiles into
// n_splits splits of tiles_per_split consecutive tiles (the caller's count,
// the decode policy's: core.autotune plans it from the units, the tile
// count and the SM count only, never from the lengths, which stay on the
// device). One block per (unit, split) clips its split's tiles to the live
// ones (live_tiles: the tiles that hold a key some row of the unit sees); a
// block left with none loads nothing.
//
// A block is one producer warp and four consumer warps:
//   - the producer's lane 0 TMA-loads each tile's K and V into a ring of
//     STAGES stages (full / empty mbarriers), the 128-byte swizzle, one box
//     of 64 columns a row at head_dim 64, two at 128, four at 256.
//     Contiguous: one box of KEY_TILE rows of a rank-4 map over (D, S, Hkv,
//     B); a ragged last tile zero-fills within its head. Paged: a rank-4
//     map over (D, page, Hkv, P) and KEY_TILE / box_rows boxes a tile,
//     box_rows = gcd(page, 64), so a box never crosses a page; its outer
//     coordinate is the physical page id read from page_table[b, j] (the
//     Pallas index map's pt_ref[b_, j_]).
//     The split's first tile is issued before the length arrives (ring
//     position 0; released unread when it is not the block's).
//   - the consumers run both products on tensor cores with mma.sync
//     m16n8k16 (bf16 operands, fp32 accumulators) fed by ldmatrix from the
//     swizzled tiles, each fragment read two steps before its products: S =
//     Q K^T with the q rows as M (padded to 16 with zeros), and O += P V
//     with P rounded to bf16 straight from S's accumulator registers (its
//     layout is the A fragment's). wgmma is not used: its M is 64 rows, and
//     decode has 4-16 rows a unit. A warp takes 16 rows and a WK-key slice
//     of each tile: the few-row body (WK 16) gives the four warps the same
//     16 rows and four slices, so a tile keeps them all busy; the many-row
//     body (WK 32) gives each 16-row group of its 32 rows two warps.
//   - scores are scaled, soft-capped (cap tanh(s / cap), a template
//     parameter) before masking, masked to -1e30, and an online softmax
//     (exponentials as ex2 of (s - m) log2 e) keeps each warp's rows'
//     (m, l, O) in fp32 registers; a tile that leaves a row's max where it
//     was rescales the row by exactly 1 (ex2 of m log2 e less its rounded
//     product is not 1), so a tile the row cannot see adds nothing and a
//     verify row of T tokens, whose unit reads the tiles of its last
//     token, has the bits of the 1-token step at its position; at the end
//     of the split a row's slices are merged in warp order in shared
//     memory.
//   - with one split (core.autotune.plan_decode's choice whenever the unit
//     has fewer than 16 tiles) the block writes the output in bf16. With
//     more, the split's partial (O, m, l) goes to an fp32 workspace, and the
//     last block of a unit to finish (an atomic ticket, reset to 0 by that
//     block for the next call, so CUDA-graph replays stay right) merges the
//     unit's splits in index order with the log-sum-exp combine of the
//     reference's combine_splits (the max re-anchored at the row's sink
//     when sinks are given; den > 0 else zero) and writes the output. A
//     split whose m is the mask value adds nothing and is passed over, so a
//     block that loaded nothing writes no O. Both ways a row is normalised
//     as (a O) / den with one correctly rounded reciprocal of den.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "gemm_sm90.cuh"

namespace decode_split {

using sm90::smem_addr;

constexpr int KEY_TILE = 64;        // keys a tile
constexpr int FEW_ROWS = 16;        // q rows a unit of the few-row body
constexpr int ROW_TILE = 32;        // q rows a unit of the many-row body
constexpr int CONSUMER_WARPS = 4;
constexpr int CONSUMERS = 32 * CONSUMER_WARPS;
constexpr int THREADS = CONSUMERS + 32;   // and one producer warp
constexpr float MASK_VALUE = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory: the ring's stages (a K tile, then a V tile, each D/64
// boxes of KEY_TILE rows by 128 bytes), the barriers, the merge's flag and,
// at head_dim 256 (QSMEM), the unit's q rows. The warps' merge at the end
// of a split reuses the ring.
template <int D>
struct Layout {
  static constexpr int STAGES = D == 64 ? 6 : 3;   // (K, V) tiles in the ring
  static constexpr int BOXES = D / 64;
  static constexpr int BOX = KEY_TILE * 128;
  static constexpr int TILE = BOXES * BOX;
  static constexpr int STAGE = 2 * TILE;
  static constexpr int BAR_OFF = STAGES * STAGE;
  static constexpr int SCRATCH_OFF = BAR_OFF + 2 * STAGES * 8;
  // Below head_dim 256 q's A fragments stay in registers for the whole
  // split (D / 4 a thread). At 256 those 64 registers beside O's 128 would
  // spill, so the unit's rows go to shared memory once, QROW bytes apart
  // (16 bytes of padding put the eight rows of an ldmatrix in distinct
  // banks), and each k-step's fragment is read by ldmatrix with K's.
  static constexpr bool QSMEM = D > 128;
  static constexpr int QROW = 2 * D + 16;
  static constexpr int Q_OFF = SCRATCH_OFF + 16;
  static constexpr int SMEM =
      (QSMEM ? Q_OFF + ROW_TILE * QROW : SCRATCH_OFF + 16) + 1024;
  static_assert(CONSUMER_WARPS * 16 * (D + 2) * 4 <= BAR_OFF,
                "the cross-warp merge fits in the ring");
  static_assert(SMEM <= 232448, "fits one SM's shared memory");
};

struct Params {
  CUtensorMap k, v;          // contiguous: (D, S, Hkv, B); paged: (D, page,
                             // Hkv, P)
  const __nv_bfloat16* q;    // (B, Hkv, R, D)
  const int* lengths;        // (B,)
  const int* page_table;     // (B, MP); paged only
  const void* sinks;         // (Hkv, R) fp32, or bf16 (sinks_bf16), or null
  __nv_bfloat16* out;        // (B, Hkv, R, D)
  float* o_ws;               // (units, n_splits, rw, D)
  float* m_ws;               // (units, n_splits, rw)
  float* l_ws;
  int* tickets;              // (units,), 0 between calls
  int hkv, rows, n_rt, rw;   // R; row tiles a head; workspace rows a unit
  int keys, n_tiles;         // key positions (slots, or MP * page); tiles
  int n_splits, tps;
  int q_tokens;              // T (1 for the contiguous kernel)
  int page_size, max_pages, box_rows;   // paged only
  int sinks_bf16;
  float scale, softcap;      // softcap <= 0: none
  int window;                // <= 0: none
};

// The live key tiles [lo, hi) of a unit whose rows are r0 .. r0 + nr - 1:
// those that hold a key some row sees. Paged: row r (token t = r mod T)
// sees positions k <= length - T + t and, with a window, within `window`
// of it. Contiguous ring: while the cache has not wrapped (length <= S)
// slot k holds position k and is seen when k < length (and within the
// window of length - 1); once wrapped every slot holds a position.
template <bool PAGED>
__device__ __forceinline__ void live_tiles(const Params& p, int length,
                                           int r0, int nr, int& lo, int& hi) {
  int k_lo, k_hi;
  if (PAGED) {
    const int T = p.q_tokens;
    const int t0 = r0 % T;
    const bool wraps = nr >= T || t0 + nr - 1 >= T;
    const int t_min = wraps ? 0 : t0, t_max = wraps ? T - 1 : t0 + nr - 1;
    const int hz0 = length - T;
    k_hi = min(p.keys, hz0 + t_max + 1);
    k_lo = p.window > 0 ? max(0, hz0 + t_min - p.window + 1) : 0;
  } else {
    k_hi = length <= 0 ? 0 : min(length, p.keys);
    k_lo = p.window > 0 && length <= p.keys ? max(0, length - p.window) : 0;
  }
  if (k_lo >= k_hi) {
    lo = hi = 0;
    return;
  }
  lo = k_lo / KEY_TILE;
  hi = (k_hi + KEY_TILE - 1) / KEY_TILE;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The weight of a partial whose max is m in a sum re-anchored at mt.
__device__ __forceinline__ float weight(float m, float mt) {
  return ex2((m - mt) * LOG2E);
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
}

__device__ __forceinline__ uint32_t pack2(float x, float y) {
  const __nv_bfloat162 b = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&b);
}

// The address of (key, column d) of a tile under the 128-byte swizzle: the
// 16-byte chunk d / 8 of a 64-column box's row is stored at chunk
// (d / 8) ^ (key mod 8).
__device__ __forceinline__ uint32_t swz(uint32_t tile, int key, int d) {
  return tile + (d / 64) * (KEY_TILE * 128) + key * 128 +
         ((((d % 64) / 8) ^ (key % 8)) * 16);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c (16 x 8, fp32) += a (16 x 16, bf16) b (16 x 8, bf16). Fragments: a[0]
// (row l/4, k 2(l%4) +0/1), a[1] row + 8, a[2] k + 8, a[3] both; b[0] (k
// 2(l%4) +0/1, column l/4), b[1] k + 8; c[0..1] (row l/4, columns 2(l%4)
// +0/1), c[2..3] row + 8.
__device__ __forceinline__ void mma(float* c, const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Physical page of box j of key tile t (page 0, the null page, past the
// table: those keys are masked).
__device__ __forceinline__ int page_id(const Params& p, int b, int t, int j) {
  const int k = t * KEY_TILE + j * p.box_rows;
  return k < p.keys
             ? __ldg(p.page_table + (size_t)b * p.max_pages + k / p.page_size)
             : 0;
}

// The block's tiles: its split's (from split * tps), clipped to the live
// ones; t0 the first, n of them (0: nothing to load).
template <bool PAGED>
__device__ __forceinline__ void block_tiles(const Params& p, int length,
                                            int split, int r0, int nr,
                                            int& t0, int& n) {
  int lo, hi;
  live_tiles<PAGED>(p, length, r0, nr, lo, hi);
  const int a = split * p.tps;
  t0 = max(a, lo);
  n = max(0, min(min(p.n_tiles, a + p.tps), hi) - t0);
}

// The producer loads the split's first tile before the length arrives.
// When that tile is not the block's first (nothing to load, or the window
// starts later), it takes ring position 0 and the block's tiles start at
// position 1: the offset of the block's tiles in the ring.
__device__ __forceinline__ int ring_offset(const Params& p, int split, int t0,
                                           int n) {
  return n == 0 || t0 != split * p.tps ? 1 : 0;
}

__device__ __forceinline__ void mbar_arrive_n(uint64_t* bar, int count) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// Lane 0 of the producer: key tile t into ring position j (the stage must
// be free). Paged: box i of the tile from physical page ids[i].
template <int D, bool PAGED>
__device__ __forceinline__ void issue(const Params& p, unsigned char* smem,
                                      uint64_t* full, int j, int t, int b,
                                      int h, const int (&ids)[8]) {
  using L = Layout<D>;
  const int stage = j % L::STAGES;
  unsigned char* ks = smem + stage * L::STAGE;
  unsigned char* vs = ks + L::TILE;
  sm90::mbar_expect_tx(&full[stage], L::STAGE);
  const int k0 = t * KEY_TILE;
#pragma unroll
  for (int x = 0; x < L::BOXES; ++x) {
    if (!PAGED) {
      sm90::tma_load_4d(ks + x * L::BOX, &p.k, &full[stage], 64 * x, k0, h,
                        b);
      sm90::tma_load_4d(vs + x * L::BOX, &p.v, &full[stage], 64 * x, k0, h,
                        b);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (i * p.box_rows >= KEY_TILE) break;
        const int off = (k0 + i * p.box_rows) % p.page_size;
        const int dst = x * L::BOX + i * p.box_rows * 128;
        sm90::tma_load_4d(ks + dst, &p.k, &full[stage], 64 * x, off, h,
                          ids[i]);
        sm90::tma_load_4d(vs + dst, &p.v, &full[stage], 64 * x, off, h,
                          ids[i]);
      }
    }
  }
}

// The producer warp: the block's tiles into the ring, lane 0 issuing. The
// split's first tile goes out as soon as its page ids are known (at once
// for the contiguous kernel), before the length decides the block's tiles:
// the lanes read the length and the first two tiles' page ids in one round
// trip, and each next tile's ids while lane 0 waits for a free stage.
template <int D, bool PAGED>
__device__ __forceinline__ void produce(const Params& p, unsigned char* smem,
                                        uint64_t* full, uint64_t* empty,
                                        int b, int h, int split, int r0,
                                        int nr, int lane) {
  constexpr int STAGES = Layout<D>::STAGES;
  const int a = split * p.tps;
  const int boxes = PAGED ? KEY_TILE / p.box_rows : 1;   // at most 8
  // lanes 0-7: tile a's boxes; lanes 8-15: tile a + 1's
  int pid = 0;
  if (PAGED && lane < 16 && lane % 8 < boxes)
    pid = page_id(p, b, a + lane / 8, lane % 8);
  const int length = __ldg(p.lengths + b);
  int ids[8] = {};
  if (PAGED) {
#pragma unroll
    for (int j = 0; j < 8; ++j) ids[j] = __shfl_sync(0xffffffffu, pid, j);
  }
  if (lane == 0) {
    prefetch_map(&p.k);
    prefetch_map(&p.v);
    issue<D, PAGED>(p, smem, full, 0, a, b, h, ids);
  }
  int t0, n;
  block_tiles<PAGED>(p, length, split, r0, nr, t0, n);
  const int off = ring_offset(p, split, t0, n);
  if (off && lane == 0) {
    // the early tile is not the block's: let it land, then free its stage
    sm90::mbar_wait(&full[0], 0);
    mbar_arrive_n(&empty[0], CONSUMER_WARPS);
  }
  // the next tile to issue: the block's second, or its first after an
  // early tile that was not its own
  const int next = off ? t0 : t0 + 1;
  if (PAGED) {
    pid = __shfl_sync(0xffffffffu, pid, 8 + lane % 8);   // tile a + 1's ids
    if (next != a + 1 && next < t0 + n && lane < boxes)
      pid = page_id(p, b, next, lane);
  }
  for (int i = off ? 0 : 1; i < n; ++i) {
    if (PAGED) {
#pragma unroll
      for (int j = 0; j < 8; ++j) ids[j] = __shfl_sync(0xffffffffu, pid, j);
      if (i + 1 < n && lane < boxes) pid = page_id(p, b, t0 + i + 1, lane);
    }
    if (lane == 0) {
      const int j = i + off;
      sm90::mbar_wait(&empty[j % STAGES], ((j / STAGES) & 1) ^ 1);
      issue<D, PAGED>(p, smem, full, j, t0 + i, b, h, ids);
    }
    __syncwarp();
  }
}

// The sink of row r of head h (the caller checks p.sinks).
__device__ __forceinline__ float row_sink(const Params& p, int h, int r) {
  const int i = h * p.rows + r;
  return p.sinks_bf16
             ? __bfloat162float(static_cast<const __nv_bfloat16*>(p.sinks)[i])
             : static_cast<const float*>(p.sinks)[i];
}

// A row's normalisation from a lone split's (m, l): the split's weight a
// and the inverse of the denominator (0 for a row that sees no key and has
// no sink), the output being (a O) inv: the merge's arithmetic with one
// split.
__device__ __forceinline__ void one_split(const Params& p, int h, int row,
                                          float m, float l, float& a,
                                          float& inv) {
  const float sink = p.sinks != nullptr ? row_sink(p, h, row) : 0.f;
  const float mt = p.sinks != nullptr ? fmaxf(m, sink) : m;
  a = m != MASK_VALUE ? weight(m, mt) : 0.f;
  float den = l * a;
  if (p.sinks != nullptr) den += weight(sink, mt);
  inv = p.sinks != nullptr || den > 0.f ? __frcp_rn(den) : 0.f;
}

// Merge the unit's splits (index order) into rows r0 .. r0 + nr - 1 of the
// output: the last block of the unit, all consumer threads, each on 8
// columns of a row. A split whose m is the mask value is passed over by a
// select, not a branch, so every load of a split is issued at once (its O
// was not written when it loaded nothing).
template <int D>
__device__ __forceinline__ void merge(const Params& p, int unit, int bh,
                                      int h, int r0, int nr) {
  const int ns = p.n_splits;
  const size_t base = (size_t)unit * ns;
  constexpr int CH = D / 8;   // 8-column chunks of a row
  for (int c = threadIdx.x; c < nr * CH; c += CONSUMERS) {
    const int r = c / CH, d0 = (c % CH) * 8;
    float mt = MASK_VALUE, sink = 0.f;
#pragma unroll 8
    for (int s = 0; s < ns; ++s)
      mt = fmaxf(mt, __ldcg(p.m_ws + (base + s) * p.rw + r));
    if (p.sinks != nullptr) {
      sink = row_sink(p, h, r0 + r);
      mt = fmaxf(mt, sink);
    }
    float den = 0.f, acc[8] = {};
#pragma unroll 4
    for (int s = 0; s < ns; ++s) {
      const size_t row = (base + s) * p.rw + r;
      const float ms = __ldcg(p.m_ws + row);
      const float ls = __ldcg(p.l_ws + row);
      const float4* o = reinterpret_cast<const float4*>(p.o_ws + row * D + d0);
      const float4 x0 = __ldcg(o), x1 = __ldcg(o + 1);
      const float x[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
      const bool live = ms != MASK_VALUE;
      const float a = weight(ms, mt);
      den = live ? fmaf(ls, a, den) : den;
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] = live ? fmaf(a, x[i], acc[i]) : acc[i];
    }
    if (p.sinks != nullptr) den += weight(sink, mt);
    const float inv = p.sinks != nullptr || den > 0.f ? __frcp_rn(den) : 0.f;
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = pack2(acc[2 * i] * inv, acc[2 * i + 1] * inv);
    *reinterpret_cast<uint4*>(p.out + ((size_t)bh * p.rows + r0 + r) * D +
                              d0) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// The kernel body. WK: keys of a tile a consumer warp takes, so KS =
// KEY_TILE / WK warps share each 16-row group, and a unit has 16 (4 / KS)
// rows: the few-row body WK 16 (16 rows, four 16-key slices), the many-row
// body WK 32 (32 rows, two 32-key slices a row group); CAP: the soft cap is
// on (a template parameter, so the uncapped body carries no tanh).
template <int D, int WK, bool PAGED, bool CAP>
__device__ __forceinline__ void body(const Params& p) {
  using L = Layout<D>;
  constexpr int STAGES = L::STAGES;
  constexpr int KS = KEY_TILE / WK;                  // warps a row group
  constexpr int RB = 16 * (CONSUMER_WARPS / KS);     // q rows a unit
  static_assert(RB == (WK == 16 ? FEW_ROWS : ROW_TILE), "the unit's rows");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* empty = full + STAGES;
  int* s_last = reinterpret_cast<int*>(smem + L::SCRATCH_OFF);

  const int split = blockIdx.x % p.n_splits;
  const int unit = blockIdx.x / p.n_splits;
  const int bh = unit / p.n_rt;           // b * Hkv + h
  const int h = bh % p.hkv, b = bh / p.hkv;
  const int r0 = (unit % p.n_rt) * RB;
  const int nr = min(RB, p.rows - r0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == CONSUMER_WARPS) {
    produce<D, PAGED>(p, smem, full, empty, b, h, split, r0, nr, lane);
    return;
  }

  const int g = lane / 4, q4 = lane % 4;
  const int rw0 = 16 * (warp / KS);    // the warp's first row
  const int kw0 = WK * (warp % KS);    // its first key in a tile
  const size_t ws = (size_t)unit * p.n_splits + split;
  float* ow = p.o_ws + ws * p.rw * D;
  float* mw = p.m_ws + ws * p.rw;
  float* lw = p.l_ws + ws * p.rw;
  // q's A fragments, read with the length: k-step kk holds columns
  // 16 kk + 2 q4 (+1, +8, +9) of rows g and g + 8; rows past the unit's
  // are zeros. QSMEM: the unit's RB rows into shared memory instead, 16
  // bytes a thread a step.
  uint32_t qa[L::QSMEM ? 1 : D / 16][4];
  const __nv_bfloat16* qg = p.q + ((size_t)bh * p.rows + r0) * D;
  const uint32_t qsm = smem_addr(smem + L::Q_OFF);
  if constexpr (L::QSMEM) {
    for (int i = threadIdx.x; i < RB * D / 8; i += CONSUMERS) {
      const int row = i / (D / 8), c = i % (D / 8);
      const uint4* src = reinterpret_cast<const uint4*>(qg + (size_t)row * D);
      const uint4 x = row < nr ? __ldg(src + c) : make_uint4(0u, 0u, 0u, 0u);
      *reinterpret_cast<uint4*>(smem + L::Q_OFF + row * L::QROW + 16 * c) = x;
    }
    consumer_sync();
  } else {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = rw0 + g + 8 * (i % 2);
        const int col = 16 * kk + 8 * (i / 2) + 2 * q4;
        qa[kk][i] = row < nr ? __ldg(reinterpret_cast<const unsigned int*>(
                                   qg + (size_t)row * D + col))
                             : 0u;
      }
  }
  // QSMEM: the A fragment of k-step kk for the warp's 16 rows (ldmatrix
  // x4: rows 0-7 and 8-15 at columns 16 kk, then both at 16 kk + 8)
  auto qaddr = [&](int kk) {
    return qsm + (rw0 + (lane & 7) + (((lane >> 3) & 1) << 3)) * L::QROW +
           2 * (16 * kk + ((lane >> 4) << 3));
  };
  const int length = __ldg(p.lengths + b);
  int t0, n;
  block_tiles<PAGED>(p, length, split, r0, nr, t0, n);
  const int off = ring_offset(p, split, t0, n);

  if (n > 0) {
    // what decides a key's mask for the thread's rows g, g + 8
    int hz[2] = {0, 0};
    int pos = length - 1, cur = 0;
    if (PAGED) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        hz[hh] = length - p.q_tokens + (r0 + rw0 + g + 8 * hh) % p.q_tokens;
    } else if (pos >= 0) {
      cur = pos % p.keys;
    }
    const float inv_cap = CAP ? 1.f / p.softcap : 0.f;

    float m[2] = {MASK_VALUE, MASK_VALUE}, l[2] = {0.f, 0.f};
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;

    for (int i = 0; i < n; ++i) {
      const int stage = (i + off) % STAGES;
      sm90::mbar_wait(&full[stage], ((i + off) / STAGES) & 1);
      const uint32_t ks = smem_addr(smem + stage * L::STAGE);
      const uint32_t vs = ks + L::TILE;
      // S = Q K^T over the warp's WK keys. ldmatrix and mma are issued in
      // program order, so each K fragment is read two steps before its
      // products; with one 16-key slice (WK == 16) the even and odd
      // k-steps go to two sums, so four products are in flight, not two.
      constexpr int JP = WK / 16, NKF = (D / 16) * JP;
      constexpr bool TWO = JP == 1;
      auto kaddr = [&](int idx) {
        return swz(ks, kw0 + 16 * (idx % JP) + (lane & 7) + ((lane >> 4) << 3),
                   16 * (idx / JP) + (((lane >> 3) & 1) << 3));
      };
      float s[WK / 2], s2[WK / 2];
#pragma unroll
      for (int j = 0; j < WK / 2; ++j) s[j] = s2[j] = 0.f;
      uint32_t kf[3][4], qf[3][4];
      ldsm_x4(kf[0], kaddr(0));
      ldsm_x4(kf[1], kaddr(1));
      if constexpr (L::QSMEM) {
        ldsm_x4(qf[0], qaddr(0));
        ldsm_x4(qf[1], qaddr(1));
      }
#pragma unroll
      for (int idx = 0; idx < NKF; ++idx) {
        if (idx + 2 < NKF) ldsm_x4(kf[(idx + 2) % 3], kaddr(idx + 2));
        const int kk = idx / JP, jp = idx % JP;
        float* acc = TWO && (kk & 1) ? s2 : s;
        if constexpr (L::QSMEM) {
          // q's fragment two k-steps ahead, as K's
          if (jp == 0 && kk + 2 < D / 16)
            ldsm_x4(qf[(kk + 2) % 3], qaddr(kk + 2));
          mma(acc + 8 * jp, qf[kk % 3], kf[idx % 3][0], kf[idx % 3][1]);
          mma(acc + 8 * jp + 4, qf[kk % 3], kf[idx % 3][2], kf[idx % 3][3]);
        } else {
          mma(acc + 8 * jp, qa[kk], kf[idx % 3][0], kf[idx % 3][1]);
          mma(acc + 8 * jp + 4, qa[kk], kf[idx % 3][2], kf[idx % 3][3]);
        }
      }
      // V's first fragments, read while the softmax runs
      constexpr int NP = D / 16, NVF = (WK / 16) * NP;
      auto vaddr = [&](int idx) {
        return swz(vs, kw0 + 16 * (idx / NP) + (lane & 7) +
                           (((lane >> 3) & 1) << 3),
                   16 * (idx % NP) + ((lane >> 4) << 3));
      };
      uint32_t vf[3][4];
      ldsm_x4_t(vf[0], vaddr(0));
      ldsm_x4_t(vf[1], vaddr(1));
      if (TWO) {
#pragma unroll
        for (int j = 0; j < WK / 2; ++j) s[j] += s2[j];
      }
      // scale, soft cap, mask: entry 4 j + 2 hh + e is row g + 8 hh, key
      // kb + 8 j + 2 q4 + e
      const int kb = (t0 + i) * KEY_TILE + kw0 + 2 * q4;
#pragma unroll
      for (int j = 0; j < WK / 8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int k = kb + 8 * j + e;
            float x = s[4 * j + 2 * hh + e] * p.scale;
            if (CAP) x = p.softcap * tanhf(x * inv_cap);
            bool ok;
            if (PAGED) {
              ok = k < p.keys && k <= hz[hh] &&
                   (p.window <= 0 || hz[hh] - k < p.window);
            } else {
              const int actual =
                  k <= cur ? pos - cur + k : pos - cur - p.keys + k;
              ok = k < p.keys && actual >= 0 && actual <= pos &&
                   (p.window <= 0 || pos - actual < p.window);
            }
            s[4 * j + 2 * hh + e] = ok ? x : MASK_VALUE;
          }
      // the online softmax: a row whose keys so far are all masked has the
      // mask value as its max, and p 0 by this rule; the row's max and sum
      // over the thread's columns as trees
      constexpr int J = WK / 8;
      float alpha[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float t[J];
#pragma unroll
        for (int j = 0; j < J; ++j)
          t[j] = fmaxf(s[4 * j + 2 * hh], s[4 * j + 2 * hh + 1]);
#pragma unroll
        for (int step = 1; step < J; step *= 2)
#pragma unroll
          for (int j = 0; j + step < J; j += 2 * step)
            t[j] = fmaxf(t[j], t[j + step]);
        float mx = t[0];
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float mnew = fmaxf(m[hh], mx);
        const float mu = mnew == MASK_VALUE ? 0.f : mnew * LOG2E;
        alpha[hh] = mnew == m[hh] ? 1.f : ex2(fmaf(m[hh], LOG2E, -mu));
        m[hh] = mnew;
#pragma unroll
        for (int j = 0; j < J; ++j) {
          float& x0 = s[4 * j + 2 * hh];
          float& x1 = s[4 * j + 2 * hh + 1];
          x0 = ex2(fmaf(x0, LOG2E, -mu));
          x1 = ex2(fmaf(x1, LOG2E, -mu));
          t[j] = x0 + x1;
        }
#pragma unroll
        for (int step = 1; step < J; step *= 2)
#pragma unroll
          for (int j = 0; j + step < J; j += 2 * step) t[j] += t[j + step];
        l[hh] = fmaf(l[hh], alpha[hh], t[0]);
      }
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j] *= alpha[0];
        o[4 * j + 1] *= alpha[0];
        o[4 * j + 2] *= alpha[1];
        o[4 * j + 3] *= alpha[1];
      }
      // O += P V: P's A fragment for keys 16 kk .. 16 kk + 15 is S's
      // accumulator of those columns packed in bf16 pairs; V's fragments
      // two steps ahead
      uint32_t pa[WK / 16][4];
#pragma unroll
      for (int kk = 0; kk < WK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[kk][r] = pack2(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
#pragma unroll
      for (int idx = 0; idx < NVF; ++idx) {
        if (idx + 2 < NVF) ldsm_x4_t(vf[(idx + 2) % 3], vaddr(idx + 2));
        const int kk = idx / NP, np = idx % NP;
        mma(o + 8 * np, pa[kk], vf[idx % 3][0], vf[idx % 3][1]);
        mma(o + 8 * np + 4, pa[kk], vf[idx % 3][2], vf[idx % 3][3]);
      }
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(&empty[stage]);
    }

#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
    }
    // the KS warps of each row group merge their key slices in warp order,
    // in the ring's memory (every tile has been read): per warp 16 rows of
    // m, l and O
    consumer_sync();
    float* cm = reinterpret_cast<float*>(smem);
    float* cl = cm + CONSUMER_WARPS * 16;
    float* co = cl + CONSUMER_WARPS * 16;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = warp * 16 + g + 8 * hh;
      if (q4 == 0) {
        cm[r] = m[hh];
        cl[r] = l[hh];
      }
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<float2*>(co + r * D + 8 * j + 2 * q4) =
            make_float2(o[4 * j + 2 * hh], o[4 * j + 2 * hh + 1]);
    }
    consumer_sync();
    // two columns of a row a step: the split's (O, m, l), then the output
    // (one split) or the partial; key slice s of row r sits at
    // (r / 16) KS 16 + 16 s + r mod 16
    __nv_bfloat16* out = p.out + ((size_t)bh * p.rows + r0) * D;
    for (int idx = threadIdx.x; idx < nr * D / 2; idx += CONSUMERS) {
      const int r = idx / (D / 2), c = 2 * (idx % (D / 2));
      const int r16 = (r / 16) * KS * 16 + r % 16;
      float mt = MASK_VALUE;
#pragma unroll
      for (int w = 0; w < KS; ++w) mt = fmaxf(mt, cm[r16 + 16 * w]);
      float acc0 = 0.f, acc1 = 0.f, sum = 0.f;
#pragma unroll
      for (int w = 0; w < KS; ++w) {
        const int rw = r16 + 16 * w;
        const float a = weight(cm[rw], mt);
        acc0 += co[rw * D + c] * a;
        acc1 += co[rw * D + c + 1] * a;
        sum += cl[rw] * a;
      }
      if (p.n_splits == 1) {
        float a, inv;
        one_split(p, h, r0 + r, mt, sum, a, inv);
        *reinterpret_cast<uint32_t*>(out + (size_t)r * D + c) =
            pack2(a * acc0 * inv, a * acc1 * inv);
      } else {
        *reinterpret_cast<float2*>(ow + (size_t)r * D + c) =
            make_float2(acc0, acc1);
        if (c == 0) {
          mw[r] = mt;
          lw[r] = sum;
        }
      }
    }
  } else if (p.n_splits == 1) {
    // no key is seen by any row: zeros (with sinks too)
    uint4* out =
        reinterpret_cast<uint4*>(p.out + ((size_t)bh * p.rows + r0) * D);
    for (int i = threadIdx.x; i < nr * D / 8; i += CONSUMERS)
      out[i] = make_uint4(0u, 0u, 0u, 0u);
  } else {
    // nothing to load: no key of the split is seen by any row
    for (int r = threadIdx.x; r < nr; r += CONSUMERS) {
      mw[r] = MASK_VALUE;
      lw[r] = 0.f;
    }
  }
  if (p.n_splits == 1) return;

  // the ticket: the unit's last block to finish merges its splits (one
  // thread fences for the block after the barrier, as a grid-wide sync
  // does; the merge reads through L2)
  consumer_sync();
  if (threadIdx.x == 0) {
    __threadfence();
    const int last = atomicAdd(p.tickets + unit, 1) == p.n_splits - 1;
    if (last) {
      __threadfence();
      p.tickets[unit] = 0;
    }
    *s_last = last;
  }
  consumer_sync();
  if (!*s_last) return;
  merge<D>(p, unit, bh, h, r0, nr);
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

inline int gcd(int a, int b) { return b == 0 ? a : gcd(b, a % b); }

// A rank-4 bf16 map over a contiguous (outer, mid, rows, D) tensor, boxes
// of 64 columns by box_rows rows of one (outer, mid), the 128-byte swizzle.
inline cudaError_t make_map(CUtensorMap* map, const void* base, int d,
                            int rows, int mid, int outer, int box_rows) {
  const sm90::View4 v = {base, d, rows, mid, outer, (long long)d,
                         (long long)rows * d, (long long)mid * rows * d};
  return sm90::make_map_4d(map, v, box_rows);
}

template <int D, typename Kernel>
cudaError_t run(Kernel kernel, const Params& p, int units,
                cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Layout<D>::SMEM);
  if (err != cudaSuccess) return err;
  kernel<<<units * p.n_splits, THREADS, Layout<D>::SMEM, stream>>>(p);
  return cudaGetLastError();
}

// The few-row body when the q rows of one query token (a GQA group, G =
// R / T) fit in FEW_ROWS, else the many-row body. Chosen by G and not by
// all R rows, a T-token call takes the body of its T = 1 calls, so a
// verify row has the serial step's bits (at G 5, T 4 gives 20 rows).
// Mirrored by kernels/attention/decode.py rows_per_unit.
inline bool few_row_body(const Params& p) {
  return p.rows / p.q_tokens <= FEW_ROWS;
}

// Fills the plan fields of p for `rows` q rows a (b, h) and `keys` key
// positions, the tiles cut into the caller's n_splits splits; returns the
// number of units, or -1 when n_splits is not from 1 to the tile count or
// leaves a split empty (it must be ceil(n_tiles / ceil(n_tiles /
// n_splits)), as core.autotune.split_tiles gives it).
inline int plan(Params& p, int batch, int n_splits) {
  const int rb = few_row_body(p) ? FEW_ROWS : ROW_TILE;
  p.n_rt = (p.rows + rb - 1) / rb;
  p.rw = p.rows < rb ? p.rows : rb;
  p.n_tiles = (p.keys + KEY_TILE - 1) / KEY_TILE;
  const int units = batch * p.hkv * p.n_rt;
  if (n_splits < 1 || n_splits > p.n_tiles) return -1;
  const int tps = (p.n_tiles + n_splits - 1) / n_splits;
  if ((p.n_tiles + tps - 1) / tps != n_splits) return -1;
  p.n_splits = n_splits;
  p.tps = tps;
  return units;
}

}  // namespace decode_split

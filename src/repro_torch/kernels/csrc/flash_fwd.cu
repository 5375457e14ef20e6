// Flash-attention forward for Hopper: causal / windowed MHA and GQA, one
// persistent TMA + wgmma kernel whose softmax weights P go to the second
// product straight from registers.
//
// Replaces the TPU kernel `_fwd_kernel` (src/repro/kernels/attention/
// kernel_fwd.py), launched there by `_flash_fwd`. Same math: scores
// s = (q . k) * scale in fp32, an optional tanh soft cap before masking,
// masked entries at -1e30 with p exactly 0, an online softmax whose running
// (m, l) live in fp32, p rounded to bf16 before p @ v (kernel_fwd.py:101),
// and a store of out = acc / l and lse = m + log(l) in natural-log units
// (l == 0 guarded: a row with no visible key gives out 0, lse -1e30). The
// softmax runs in log2 units (ex2 of s * scale * log2 e - m); lse is
// converted back at the store. Sinks are not taken (the wrapper raises).
//
// What bounds it on an H100: at the training shape of llama-1b (B 4, H 32,
// Hkv 8, S 1024, d 64, causal) its two products per visible (q, k) pair,
// about 17.2 GFLOP of bf16 tensor-core work (17.4 us at 989 TFLOP/s),
// against 42.5 MB of q, k, v, out and lse over HBM (12.7 us at 3.35 TB/s);
// at d 64 the exponentials (one per pair on the special-function unit, 16
// a clock an SM) take about as long as the products. The design (the
// FlashAttention-3 forward's structure on csrc/gemm_sm90.cuh's primitives):
//   - work items of (q tile of 128 rows, query head, batch), the last q
//     tile first under the causal mask (the most key tiles first;
//     kernels/attention/ops.py plan_fwd_blocks computes the same order and
//     key-tile ranges), the query heads of one key head adjacent so that
//     their K/V tiles come from L2; persistent blocks, one per SM, walk the
//     items, so the producer loads the next item's tiles while the
//     consumers finish this one;
//   - one producer thread TMA-loads the q tile (double-buffered across
//     items below d 256) and a ring of four (K, V) tiles (128 keys at d 64;
//     64 at d 128, so that the ring and two q tiles fit in shared memory;
//     at d 256 one q tile and two stages of 64 keys, 192 KB) through
//     rank-4 maps of the strided (d, S, H, B) views, so the packed q|k
//     projection and the v view need no copy and a ragged S zero-fills
//     within its head; its warpgroup gives its registers away with
//     setmaxnreg, and only its barrier waits trap;
//   - two consumer warpgroups, 64 q rows each. S_j = Q K_j^T by wgmma (at
//     d 64 Q is an A fragment in registers, so the product reads only K
//     from shared memory) is issued together with O += P_{j-1} V_{j-1}, and
//     S_j's softmax runs while the second product does. The softmax works
//     on the accumulator layout in log2 units (row max and sum over the
//     quad of lanes that shares a row, as trees; the sum reduced across
//     the quad once, at the store), the mask only on tiles that cross the
//     diagonal, the window's edge or the key length;
//   - P V takes A from registers: the score accumulator, packed to bf16
//     pairs, is the A fragment, so P never goes to shared memory; V is the
//     MN-major B operand (64-column boxes);
//   - O / l rounded to bf16 and stored 16 bytes a lane after a quad
//     transpose, lse per row, while the next item's S_0 runs;
//   - every path through the key-tile loop and through an item ends with no
//     product in flight: an accumulator that ptxas cannot prove free (two
//     score buffers carried across the loop, or an issue and its wait
//     under two branches of one condition) made it serialize every wgmma
//     of the kernel (C7515); no register spill at d 64 or 128. At d 256 a
//     consumer thread holds O (128 fp32), S (32) and P (16 registers) with
//     q read from shared memory, under setmaxnreg's 240.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "gemm_sm90.cuh"

namespace {

using sm90::smem_addr;

constexpr int BQ = 128;          // q rows a work item: two warpgroups of 64
constexpr int CONSUMERS = 2;
constexpr int THREADS = 128 * (1 + CONSUMERS);
constexpr float MASK_VALUE = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory of one block, every tile 1024-byte aligned for the swizzle:
// QBUFS q tiles of D/64 TMA boxes of 64 columns (128 bytes) by BQ rows,
// then the ring's STAGES stages, each a K tile and a V tile of D/64 boxes
// by BKV rows. Below head_dim 256 two q tiles (double-buffered across work
// items) and four stages; at 256 a q tile is 64 KB and a stage of 64 keys
// 64 KB, so one q tile and two stages (192 KB).
template <int D>
struct Layout {
  static constexpr int BKV = D == 64 ? 128 : 64;   // key rows a tile
  static constexpr int STAGES = D == 256 ? 2 : 4;  // (K, V) tiles in the ring
  static constexpr int QBUFS = D == 256 ? 1 : 2;   // q tiles
  static constexpr int BOXES = D / 64;
  static constexpr int QBOX = BQ * 128;
  static constexpr int KBOX = BKV * 128;
  static constexpr int Q_BYTES = BOXES * QBOX;
  static constexpr int KV_BYTES = BOXES * KBOX;
  static constexpr int STAGE = 2 * KV_BYTES;
  static constexpr int ST_OFF = QBUFS * Q_BYTES;
  static constexpr int BAR_OFF = ST_OFF + STAGES * STAGE;
  static constexpr int SMEM = BAR_OFF + (3 * STAGES + 2 * QBUFS) * 8 + 1024;
  static_assert(SMEM <= 232448, "fits one SM's shared memory");
};

struct FwdParams {
  CUtensorMap q, k, v;     // (d, S, H, B) views
  __nv_bfloat16* out;      // (B, H, Sq, D) contiguous
  float* lse;              // (B, H, Sq)
  int batch, h, hkv, sq, skv;
  float scale, softcap;
  int causal, window;      // window <= 0: none
};

// One work item: the q tile at q0 of head h of batch b, and its key tiles
// [lo, lo + n).
struct Item {
  int q0, h, b, lo, n;
};

// Item w: rank w / (B H) of the dispatch order (the last q tile first under
// the causal mask), then batch, then head. Its key tiles run from the
// window's edge (or the first key) to the diagonal (causal) or the last key.
__device__ __forceinline__ Item item_work(const FwdParams& p, int w,
                                          int bkv) {
  const int heads = p.batch * p.h;
  const int rank = w / heads, rest = w % heads;
  const int n_qt = (p.sq + BQ - 1) / BQ;
  Item it;
  it.b = rest / p.h;
  it.h = rest % p.h;
  it.q0 = (p.causal ? n_qt - 1 - rank : rank) * BQ;
  const int q_last = min(it.q0 + BQ, p.sq) - 1;
  const int k_hi = p.causal ? min(p.skv, q_last + 1) : p.skv;
  const int k_lo = p.window > 0 ? max(0, it.q0 - p.window + 1) : 0;
  it.lo = k_lo / bkv;
  it.n = k_lo < k_hi ? (k_hi + bkv - 1) / bkv - it.lo : 0;
  return it;
}

// Whether some pair of the (q tile at q0, key tile at k0) is masked, among
// the q rows below the length.
__device__ __forceinline__ bool tile_masked(const FwdParams& p, int q0,
                                            int k0, int bkv) {
  const int q_last = min(q0 + BQ, p.sq) - 1;
  return k0 + bkv > p.skv || (p.causal && k0 + bkv - 1 > q0) ||
         (p.window > 0 && q_last - k0 >= p.window);
}

// wgmma descriptor of an MN-major tile under the 128-byte swizzle: 64-column
// boxes `box` bytes apart, 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t mn_desc(const void* ptr, int box) {
  auto enc = [](uint64_t x) { return (x & 0x3FFFF) >> 4; };
  return enc(smem_addr(ptr)) | (enc(box) << 16) | (enc(1024) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The consumers' barrier wait: sm90::mbar_wait without its trap. A trap
// in the consumers' code makes ptxas serialize every wgmma of the kernel
// (C7512, "insufficient register resources") and spill; the producer's
// waits keep the trap, so a pipeline that never completes still fails the
// launch (the producer waits on the consumers' releases).
__device__ __forceinline__ void wait_spin(uint64_t* bar, int parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// Zero a register array, each register by its own instruction (plain
// assignments let the compiler copy one zero register into an accumulator
// of an in-flight wgmma, which makes ptxas serialize the products, C7517).
template <int R>
__device__ __forceinline__ void zero(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("mov.b32 %0, 0;" : "=f"(d[i]));
}

__device__ __forceinline__ uint32_t pack2(float x, float y) {
  const __nv_bfloat162 b = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&b);
}

// The 4 x 4 transpose within a quad of lanes (q = lane % 4): before, x[i]
// holds columns 2q, 2q + 1 of 8-column group i; after, columns 2i, 2i + 1
// of group q, so each lane holds one group's 8 columns, a 16-byte store.
__device__ __forceinline__ void quad_transpose(uint32_t (&x)[4], int q) {
  bool hi = q & 1;
  uint32_t r0 = __shfl_xor_sync(0xffffffffu, hi ? x[0] : x[1], 1);
  uint32_t r1 = __shfl_xor_sync(0xffffffffu, hi ? x[2] : x[3], 1);
  x[0] = hi ? r0 : x[0];
  x[1] = hi ? x[1] : r0;
  x[2] = hi ? r1 : x[2];
  x[3] = hi ? x[3] : r1;
  hi = q & 2;
  r0 = __shfl_xor_sync(0xffffffffu, hi ? x[0] : x[2], 2);
  r1 = __shfl_xor_sync(0xffffffffu, hi ? x[1] : x[3], 2);
  x[0] = hi ? r0 : x[0];
  x[1] = hi ? r1 : x[1];
  x[2] = hi ? x[2] : r0;
  x[3] = hi ? x[3] : r1;
}

// A warpgroup's m64nD accumulator (rows `row`, row + 8 of the thread, see
// gemm_sm90.cuh StorePairs) rounded to bf16 and stored row-major with
// D columns, rows at or past `limit` skipped.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst,
                                           const float (&acc)[D / 2], int row,
                                           int limit, int q) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int c = 0; c < D / 32; ++c) {
      uint32_t x[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = 4 * c + i;
        x[i] = pack2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
      quad_transpose(x, q);
      if (row + 8 * h < limit)
        *reinterpret_cast<uint4*>(dst + (size_t)(row + 8 * h) * D +
                                  8 * (4 * c + q)) =
            make_uint4(x[0], x[1], x[2], x[3]);
    }
  }
}

// A ring position: the stage and the parity of its current fill.
template <int D>
struct Ring {
  int stage = 0, phase = 0;
  __device__ __forceinline__ void next() {
    if (++stage == Layout<D>::STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// At head_dim 64 the q tile is an A fragment in registers (16 a thread), so
// the scores read only K from shared memory; at 128 and 256 it would not fit
// beside O (64 and 128 fp32 a thread), and is read from shared memory.
template <int D>
constexpr bool QREGS = D == 64;

template <int D>
using QFrag = uint32_t[QREGS<D> ? D / 16 : 1][4];

// This warpgroup's A fragments of Q: k-step kk holds columns 16 kk + 2 q4
// (+ 1, + 8, + 9) of its rows r and r + 8, read under the swizzle.
template <int D>
__device__ __forceinline__ void load_q(QFrag<D>& qf, const unsigned char* qs,
                                       int r, int q4) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r + 8 * (i % 2), col = 16 * kk + 8 * (i / 2);
      qf[kk][i] = *reinterpret_cast<const uint32_t*>(
          qs + (col / 64) * Layout<D>::QBOX + row * 128 +
          ((((col % 64) / 8) ^ (row % 8)) * 16) + 4 * q4);
    }
}

// Issue S = Q K^T for this warpgroup's 64 q rows (qf, or qs in shared
// memory) by the tile's BKV keys (ks); the first k-step starts the sum
// afresh. Not committed.
template <int D>
__device__ __forceinline__ void issue_scores(
    float (&s)[Layout<D>::BKV / 2], const QFrag<D>& qf,
    const unsigned char* qs, const unsigned char* ks) {
  using L = Layout<D>;
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint64_t kd =
        sm90::smem_desc(ks + (kk / 4) * L::KBOX + (kk % 4) * 32);
    if constexpr (QREGS<D>)
      sm90::WgmmaRS<L::BKV>::template mma<0>(s, qf[kk], kd, kk > 0);
    else
      sm90::Wgmma<L::BKV>::template mma<0>(
          s, sm90::smem_desc(qs + (kk / 4) * L::QBOX + (kk % 4) * 32), kd,
          kk > 0);
  }
}

// Issue O += P V with P's A fragments from registers (k-step kk: keys
// 16 kk .. 16 kk + 15) and V MN-major; accumulate == 0 starts O afresh.
// Not committed.
template <int D>
__device__ __forceinline__ void issue_pv(
    float (&o)[D / 2], const uint32_t (&pa)[Layout<D>::BKV / 16][4],
    const unsigned char* vs, int accumulate) {
  using L = Layout<D>;
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < L::BKV / 16; ++kk)
    sm90::WgmmaRS<D>::template mma<1>(o, pa[kk],
                                      mn_desc(vs + kk * 16 * 128, L::KBOX),
                                      kk > 0 || accumulate);
}

// The consumer warpgroup's state for one work item: the thread's rows
// `row`, row + 8 (entry 4 j + 2 h + e of an accumulator is row + 8 h,
// column 8 j + 2 q4 + e), their running max m (in the units of the capped
// scores, scale not applied without a cap) and partial sum l (this lane's
// columns only).
struct RowState {
  float m[2], l[2];
};

// One score tile in place: the soft cap, the mask (masked tiles only), the
// online softmax. s becomes fp32 p; alpha is the factor that rescales the
// earlier tiles' sums. c: log2 e, times the scale without a cap. The two
// rows' maxima and sums are trees of independent operations (with two warps
// a scheduler, a serial chain's latency would show).
template <int N, bool CAP>
__device__ __forceinline__ void softmax_tile(const FwdParams& p,
                                             float (&s)[N], RowState& st,
                                             float (&alpha)[2], bool masked,
                                             int row, int col0, float c,
                                             float cap_scale) {
  constexpr int J = N / 4;   // 8-column groups of a row
  if (CAP) {
#pragma unroll
    for (int i = 0; i < N; ++i) s[i] = p.softcap * tanhf(s[i] * cap_scale);
  }
  if (masked) {
    // row r sees the columns c = 8 j + e with lo <= c < hi
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row + 8 * h;
      const int hi = (p.causal ? min(p.skv, r + 1) : p.skv) - col0;
      const int lo = p.window > 0 ? r - p.window + 1 - col0 : -(1 << 30);
#pragma unroll
      for (int j = 0; j < J; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (8 * j + e < lo || 8 * j + e >= hi)
            s[4 * j + 2 * h + e] = MASK_VALUE;
    }
  }
  float mx[2][J];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < J; ++j)
      mx[h][j] = fmaxf(s[4 * j + 2 * h], s[4 * j + 2 * h + 1]);
#pragma unroll
  for (int step = 1; step < J; step *= 2)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j + step < J; j += 2 * step)
        mx[h][j] = fmaxf(mx[h][j], mx[h][j + step]);
  float mu[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h][0] = fmaxf(st.m[h], mx[h][0]);
    mx[h][0] = fmaxf(mx[h][0], __shfl_xor_sync(0xffffffffu, mx[h][0], 1));
    mx[h][0] = fmaxf(mx[h][0], __shfl_xor_sync(0xffffffffu, mx[h][0], 2));
    // a row whose scores so far are all masked has the mask value as its
    // max; its p is 0 by this rule, not by ex2 of 0
    mu[h] = mx[h][0] == MASK_VALUE ? 0.f : mx[h][0] * c;
    alpha[h] = ex2(fmaf(st.m[h], c, -mu[h]));
    st.m[h] = mx[h][0];
  }
  float sum[2][4] = {};
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * j + 2 * h + e;
        s[i] = ex2(fmaf(s[i], c, -mu[h]));
        sum[h][(2 * j + e) % 4] += s[i];
      }
#pragma unroll
  for (int h = 0; h < 2; ++h)
    st.l[h] = fmaf(st.l[h], alpha[h],
                   (sum[h][0] + sum[h][1]) + (sum[h][2] + sum[h][3]));
}

// P's A fragments from a tile of fp32 p: k-step kk packs columns
// 16 kk .. 16 kk + 15 (the accumulator of 16 columns, bf16 pairs).
template <int N>
__device__ __forceinline__ void pack_p(uint32_t (&pa)[N / 8][4],
                                       const float (&s)[N]) {
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      pa[kk][r] = pack2(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
}

// Rows h of an accumulator times f[h].
template <int R>
__device__ __forceinline__ void scale_rows(float (&o)[R], const float (&f)[2]) {
#pragma unroll
  for (int j = 0; j < R / 4; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      o[4 * j + 2 * h] *= f[h];
      o[4 * j + 2 * h + 1] *= f[h];
    }
}

// The barriers and buffers the consumers share with the producer.
template <int D>
struct Smem {
  unsigned char* base;
  uint64_t *kfull, *vfull, *empty, *qfull, *qempty;
  __device__ __forceinline__ const unsigned char* k(int stage) const {
    return base + Layout<D>::ST_OFF + stage * Layout<D>::STAGE;
  }
  __device__ __forceinline__ const unsigned char* v(int stage) const {
    return k(stage) + Layout<D>::KV_BYTES;
  }
};

// The store of one work item: l summed over the quad, out = O / l (0 where
// l == 0: a row with no visible key), lse = m + log(l) in natural-log
// units.
template <int D, bool CAP>
__device__ __forceinline__ void store_item(const FwdParams& p, const Item& it,
                                           float (&o)[D / 2], RowState& st,
                                           int row, int q4) {
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    st.l[h] += __shfl_xor_sync(0xffffffffu, st.l[h], 1);
    st.l[h] += __shfl_xor_sync(0xffffffffu, st.l[h], 2);
    inv[h] = st.l[h] == 0.f ? 0.f : 1.f / st.l[h];
  }
  scale_rows(o, inv);
  const size_t bh = (size_t)it.b * p.h + it.h;
  store_rows<D>(p.out + bh * p.sq * D, o, row, p.sq, q4);
  if (q4 == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (row + 8 * h < p.sq)
        p.lse[bh * p.sq + row + 8 * h] =
            st.l[h] == 0.f
                ? MASK_VALUE
                : fmaf(st.m[h], CAP ? 1.f : p.scale, logf(st.l[h]));
  }
}

// The next work item's start: its q tile (the buffer of its turn) as A
// fragments, or in shared memory from head_dim 128, and S_0 = Q K_0^T
// issued and committed.
template <int D>
__device__ __forceinline__ void start_item(
    const Smem<D>& sm, const unsigned char* smem, int& qi, int& qb,
    const unsigned char*& qs, QFrag<D>& qf, float (&s)[Layout<D>::BKV / 2],
    const Ring<D>& cur, int rows0, int warp, int lane, bool leader) {
  using L = Layout<D>;
  qb = qi % L::QBUFS;
  wait_spin(&sm.qfull[qb], (qi / L::QBUFS) & 1);
  ++qi;
  qs = smem + qb * L::Q_BYTES + rows0 * 128;
  if constexpr (QREGS<D>) {
    load_q<D>(qf, smem + qb * L::Q_BYTES, rows0 + 16 * warp + lane / 4,
              lane % 4);
    if (leader) sm90::mbar_arrive(&sm.qempty[qb]);   // q read
  }
  wait_spin(&sm.kfull[cur.stage], cur.phase);
  issue_scores<D>(s, qf, qs, sm.k(cur.stage));
  sm90::wgmma_commit();
}

// Key tile j >= 1 of a work item: s holds P_{j-1} (packed in pa), `cur` is
// tile j's ring position and `prev` tile j-1's. S_j = Q K_j^T and
// O += P_{j-1} V_{j-1} are issued together; S_j's softmax runs while the
// second product does; then O is rescaled and P_j packed.
template <int D, bool CAP>
__device__ __forceinline__ void key_tile(
    const FwdParams& p, const Smem<D>& sm, const Item& it, int j,
    float (&s)[Layout<D>::BKV / 2], float (&o)[D / 2],
    uint32_t (&pa)[Layout<D>::BKV / 16][4], RowState& st, Ring<D>& cur,
    Ring<D>& prev, const QFrag<D>& qf, const unsigned char* qs, int qbuf,
    bool leader, int row, int q4, float c, float cap_scale) {
  constexpr int BKV = Layout<D>::BKV;
  wait_spin(&sm.kfull[cur.stage], cur.phase);
  wait_spin(&sm.vfull[prev.stage], prev.phase);
  issue_scores<D>(s, qf, qs, sm.k(cur.stage));
  sm90::wgmma_commit();
  issue_pv<D>(o, pa, sm.v(prev.stage), j > 1);
  sm90::wgmma_commit();
  sm90::wgmma_wait<1>();            // S_j done
  sm90::fence_regs(s);
  if (!QREGS<D> && j + 1 == it.n && leader)
    sm90::mbar_arrive(&sm.qempty[qbuf]);   // q read
  float alpha[2];
  const int k0 = (it.lo + j) * BKV;
  softmax_tile<BKV / 2, CAP>(p, s, st, alpha,
                             tile_masked(p, it.q0, k0, BKV), row,
                             k0 + 2 * q4, c, cap_scale);
  // the fences keep the softmax before the wait (it runs while
  // P_{j-1} V_{j-1} does) and P_j's packing after it
  sm90::fence_regs(s);
  sm90::wgmma_wait<0>();            // P_{j-1} V_{j-1} done: O and pa free
  sm90::fence_regs(s);
  sm90::fence_regs(o);
  if (leader) sm90::mbar_arrive(&sm.empty[prev.stage]);
  prev = cur;
  cur.next();
  scale_rows(o, alpha);
  pack_p<BKV / 2>(pa, s);
}

template <int D, bool CAP>
__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd_kernel(const __grid_constant__ FwdParams p) {
  using L = Layout<D>;
  constexpr int BKV = L::BKV;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  Smem<D> sm;
  sm.base = smem;
  constexpr int STAGES = L::STAGES, QBUFS = L::QBUFS;
  sm.kfull = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  sm.vfull = sm.kfull + STAGES;
  sm.empty = sm.vfull + STAGES;
  sm.qfull = sm.empty + STAGES;
  sm.qempty = sm.qfull + QBUFS;
  const int items = (p.sq + BQ - 1) / BQ * p.batch * p.h;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&sm.kfull[s], 1);
      sm90::mbar_init(&sm.vfull[s], 1);
      sm90::mbar_init(&sm.empty[s], CONSUMERS);
    }
    for (int s = 0; s < QBUFS; ++s) {
      sm90::mbar_init(&sm.qfull[s], 1);
      sm90::mbar_init(&sm.qempty[s], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread loads each item's q tile into the free one of
    // the QBUFS buffers, then its K and V tiles into the ring
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x != 0) return;
    const int group = p.h / p.hkv;
    Ring<D> ring;
    int qi = 0;
    for (int w = blockIdx.x; w < items; w += gridDim.x) {
      const Item it = item_work(p, w, BKV);
      if (it.n <= 0) continue;
      const int hk = it.h / group, qb = qi % QBUFS;
      sm90::mbar_wait(&sm.qempty[qb], ((qi / QBUFS) & 1) ^ 1);
      ++qi;
      unsigned char* qs = smem + qb * L::Q_BYTES;
      sm90::mbar_expect_tx(&sm.qfull[qb], L::Q_BYTES);
#pragma unroll
      for (int x = 0; x < L::BOXES; ++x)
        sm90::tma_load_4d(qs + x * L::QBOX, &p.q, &sm.qfull[qb], 64 * x,
                          it.q0, it.h, it.b);
      for (int t = 0; t < it.n; ++t) {
        const int k0 = (it.lo + t) * BKV;
        sm90::mbar_wait(&sm.empty[ring.stage], ring.phase ^ 1);
        unsigned char* st = smem + L::ST_OFF + ring.stage * L::STAGE;
        sm90::mbar_expect_tx(&sm.kfull[ring.stage], L::KV_BYTES);
#pragma unroll
        for (int x = 0; x < L::BOXES; ++x)
          sm90::tma_load_4d(st + x * L::KBOX, &p.k, &sm.kfull[ring.stage],
                            64 * x, k0, hk, it.b);
        sm90::mbar_expect_tx(&sm.vfull[ring.stage], L::KV_BYTES);
#pragma unroll
        for (int x = 0; x < L::BOXES; ++x)
          sm90::tma_load_4d(st + L::KV_BYTES + x * L::KBOX, &p.v,
                            &sm.vfull[ring.stage], 64 * x, k0, hk, it.b);
        ring.next();
      }
    }
    // drain: the last releases, so that consumers that never finish trip
    // this thread's trapping wait instead of hanging the card
    for (int i = 0; i < STAGES; ++i) {
      sm90::mbar_wait(&sm.empty[ring.stage], ring.phase ^ 1);
      ring.next();
    }
    for (int i = 0; i < QBUFS; ++i, ++qi)
      sm90::mbar_wait(&sm.qempty[qi % QBUFS], ((qi / QBUFS) & 1) ^ 1);
    return;
  }

  // consumers: warpgroup cw owns q rows [64 cw, 64 cw + 64) of each item
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int cw = wg - 1;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, q4 = lane % 4;
  const bool leader = tid == 0;
  const float c = CAP ? LOG2E : p.scale * LOG2E;
  const float cap_scale = CAP ? p.scale / p.softcap : 0.f;
  float s[BKV / 2], o[D / 2];
  uint32_t pa[BKV / 16][4];
  QFrag<D> qf;
  zero(s);
  zero(o);
  Ring<D> cur;
  int qi = 0;
  // each item's first product S_0 = Q K_0^T is issued before the previous
  // item's last P V completes and runs during its store. Every path through
  // an item ends with no product in flight (ptxas serializes every wgmma
  // of the kernel when it cannot prove an accumulator free, C7515), so the
  // next item's S_0 is waited for after the store; the walk starts at a
  // virtual item before the first, with nothing to compute or store.
  Item it = {};
  const unsigned char* qs = nullptr;
  int qb = 0;
  for (int w = (int)blockIdx.x - (int)gridDim.x; w < items;
       w += gridDim.x) {
    const int row = it.q0 + 64 * cw + 16 * warp + lane / 4;
    RowState st;
    st.m[0] = st.m[1] = MASK_VALUE;
    st.l[0] = st.l[1] = 0.f;
    const int wn = w + gridDim.x;
    Item next = {};
    if (wn < items) next = item_work(p, wn, BKV);
    if (it.n > 0) {
      // tile 0 (S_0 done): its softmax; its P V is issued with S_1
      if (!QREGS<D> && it.n == 1 && leader)
        sm90::mbar_arrive(&sm.qempty[qb]);   // q read
      Ring<D> prev = cur;
      float alpha[2];
      const int k0 = it.lo * BKV;
      softmax_tile<BKV / 2, CAP>(p, s, st, alpha,
                                 tile_masked(p, it.q0, k0, BKV), row,
                                 k0 + 2 * q4, c, cap_scale);
      pack_p<BKV / 2>(pa, s);
      cur.next();
      for (int j = 1; j < it.n; ++j)
        key_tile<D, CAP>(p, sm, it, j, s, o, pa, st, cur, prev, qf, qs, qb,
                         leader, row, q4, c, cap_scale);
      // the last tile's P V
      wait_spin(&sm.vfull[prev.stage], prev.phase);
      issue_pv<D>(o, pa, sm.v(prev.stage), it.n > 1);
      sm90::wgmma_commit();
      if (next.n > 0) {
        start_item<D>(sm, smem, qi, qb, qs, qf, s, cur, 64 * cw, warp, lane,
                      leader);
        sm90::wgmma_wait<1>();        // the last P V done
        sm90::fence_regs(o);
        if (leader) sm90::mbar_arrive(&sm.empty[prev.stage]);
        store_item<D, CAP>(p, it, o, st, row, q4);
        sm90::wgmma_wait<0>();        // the next S_0 done
        sm90::fence_regs(s);
      } else {
        sm90::wgmma_wait<0>();
        sm90::fence_regs(o);
        if (leader) sm90::mbar_arrive(&sm.empty[prev.stage]);
        store_item<D, CAP>(p, it, o, st, row, q4);
      }
    } else {
      if (next.n > 0) {
        start_item<D>(sm, smem, qi, qb, qs, qf, s, cur, 64 * cw, warp, lane,
                      leader);
        sm90::wgmma_wait<0>();
        sm90::fence_regs(s);
      }
      // no key: out 0 (o times l's inverse, 0), lse the mask value
      if (w >= 0) store_item<D, CAP>(p, it, o, st, row, q4);
    }
    it = next;
  }
}

template <int D, bool CAP>
cudaError_t run(const FwdParams& p, cudaStream_t stream) {
  using L = Layout<D>;
  auto kernel = flash_fwd_kernel<D, CAP>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (err != cudaSuccess) return err;
  const long long items = (long long)((p.sq + BQ - 1) / BQ) * p.batch * p.h;
  const int sms = sm90::sm_count();
  kernel<<<(unsigned)(items < sms ? items : sms), THREADS, L::SMEM, stream>>>(
      p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(FwdParams& p, const sm90::View4 (&views)[3],
                   cudaStream_t stream) {
  const int rows[3] = {BQ, Layout<D>::BKV, Layout<D>::BKV};
  CUtensorMap* maps[3] = {&p.q, &p.k, &p.v};
  for (int i = 0; i < 3; ++i) {
    const cudaError_t err = sm90::make_map_4d(maps[i], views[i], rows[i]);
    if (err != cudaSuccess) return err;
  }
  return p.softcap > 0.f ? run<D, true>(p, stream) : run<D, false>(p, stream);
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Strides are in elements; the last dim of q, k and v is contiguous, the
// other strides multiples of 8 and the bases 16-byte aligned (the wrapper
// checks; the map encoder refuses otherwise). out is (B, H, Sq, head_dim)
// bf16 and lse (B, H, Sq) fp32, both contiguous. Returns
// cudaErrorInvalidValue on a head_dim other than 64, 128 or 256 or a group
// that does not divide.
int flash_fwd_launch(const void* q, const void* k, const void* v, void* out,
                     void* lse, int batch, int h, int hkv, int sq, int skv,
                     int head_dim, long long qs_b, long long qs_h,
                     long long qs_s, long long ks_b, long long ks_h,
                     long long ks_s, long long vs_b, long long vs_h,
                     long long vs_s, float scale, float softcap, int causal,
                     int window, void* stream) {
  if (batch < 1 || h < 1 || hkv < 1 || h % hkv || sq < 1 || skv < 1)
    return cudaErrorInvalidValue;
  FwdParams p;
  p.out = static_cast<__nv_bfloat16*>(out);
  p.lse = static_cast<float*>(lse);
  p.batch = batch; p.h = h; p.hkv = hkv; p.sq = sq; p.skv = skv;
  p.scale = scale; p.softcap = softcap;
  p.causal = causal; p.window = window;
  const sm90::View4 views[3] = {
      {q, head_dim, sq, h, batch, qs_s, qs_h, qs_b},
      {k, head_dim, skv, hkv, batch, ks_s, ks_h, ks_b},
      {v, head_dim, skv, hkv, batch, vs_s, vs_h, vs_b}};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) return launch<64>(p, views, st);
  if (head_dim == 128) return launch<128>(p, views, st);
  if (head_dim == 256) return launch<256>(p, views, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"

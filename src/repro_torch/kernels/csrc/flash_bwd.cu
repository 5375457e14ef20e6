// Flash-attention backward for Hopper: causal / windowed MHA and GQA, one
// key-stationary TMA + wgmma kernel and a bytes-bound pass that converts the
// fp32 dq workspace to bf16.
//
// Replaces the TPU kernels `_dq_kernel` and `_dkv_kernel`
// (src/repro/kernels/attention/kernel_bwd.py), launched there by
// `_flash_bwd`. Same math: p is recomputed from the forward's saved fp32
// lse, p = exp(s - lse) with s = (q . k) * scale, soft-capped as in the
// forward when a cap is set; masked entries (causal, window, keys past the
// length) contribute nothing; delta = rowsum(dO . O) comes from a plain
// torch preprocess, as in the reference;
//   ds = p (dp - delta) (1 - tanh^2(s_raw / cap)) scale,  dp = dO . v;
//   dv = sum p^T @ dO, dk = sum ds^T @ q, dq = sum ds @ k.
// The tensor cores take bf16 operands: p and ds are rounded to bf16 before
// their products (the TPU kernels contract them in fp32); every accumulator
// is fp32. GQA: a block walks every query head of its key head and sums the
// group in its fp32 dk/dv registers, so dk and dv are written once, per key
// head, rounded once. dq is summed over key tiles in an fp32 workspace by
// 16-byte atomic adds, in an order that changes from run to run; dk and dv
// are bitwise reproducible.
//
// What bounds it on an H100: at the training shape of llama-1b (B 4, H 32,
// Hkv 8, S 1024, d 64, causal) the five products per visible (q, k) pair
// (s, dp, dv, dk, dq), about 43 GFLOP of bf16 tensor-core work (43 us at 989
// TFLOP/s), against about 68 MB of q, k, v, dO, lse, delta and gradients
// over HBM (20 us at 3.35 TB/s). The design (the FlashAttention-3 backward's
// structure on csrc/gemm_sm90.cuh's primitives):
//   - one block per (key tile of 128 rows, key head, batch), dispatched
//     longest first (kernels/attention/backward.py plan_blocks computes the
//     same order and q-tile ranges); its K and V tiles are TMA-loaded once;
//   - one producer thread keeps a ring of three (q, dO, lse, delta) stages
//     in flight, q and dO by TMA under the 128-byte swizzle and lse and
//     delta by bulk copies, for every query head of the group and every q
//     tile from the causal diagonal to the window's edge or the end; its
//     warpgroup gives its registers away with setmaxnreg;
//   - two consumer warpgroups, 64 key rows each. A q tile (BQ rows: 128 at
//     d 64, 64 at d 128) is taken in chunks of 32 rows: chunk c + 1's
//     S^T = K q^T and dP^T = V dO^T are issued by wgmma before chunk c's
//     P^T and dS^T are computed in registers, so they run meanwhile (the
//     soft cap and the mask decided once a chunk; the mask only on tiles
//     that cross the diagonal, the window's edge or the key length; q rows
//     past the length read lse = +inf, so p = 0). dV += P^T dO runs by
//     wgmma with A from registers: the accumulator layout packed to bf16
//     pairs is the A fragment. At d 64, K and V are A fragments in
//     registers for the scores and dK += dS^T q takes dS^T from registers
//     too, so those products read only q or dO from shared memory, whose
//     bandwidth bounds wgmma with both operands there at these widths; at
//     d 128 they would not fit beside dK and dV, and come from shared
//     memory. dS^T goes to shared memory (double-buffered) for
//     dq = dS K (A transposed): each warpgroup one 64 x 64 sub-tile of the
//     q tile's dq over all 128 keys, added into the workspace by 16-byte
//     atomics straight from the accumulators;
//   - five products per pair (the two-pass design it replaces took seven);
//   - dK and dV rounded once at the end and stored 16 bytes a lane after a
//     quad transpose;
//   - no register spill: a trap in the consumers' barrier waits would make
//     ptxas serialize every wgmma (C7512) and spill, so only the producer's
//     waits trap (see wait_spin).
// q, k, v and dO are read through rank-4 TMA maps (d, S, H, B) with their
// strides, so the packed q|k views and the strided cotangent need no copy,
// and a ragged S zero-fills within its head.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "gemm_sm90.cuh"

namespace {

using sm90::smem_addr;

constexpr int BKT = 128;         // key rows a block: two warpgroups of 64
constexpr int CONSUMERS = 2;
constexpr int THREADS = 128 * (1 + CONSUMERS);
constexpr int STAGES = 3;        // (q, dO, lse, delta) stages in the ring
constexpr int SUB = 64 * 64;     // floats of one dq workspace sub-tile
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory of one block, every tile 1024-byte aligned for the swizzle.
// A q or dO tile is D/64 TMA boxes of 64 columns (128 bytes) by BQ rows; K
// and V the same by BKT rows; dS^T is BQ/64 boxes of 64 q columns by BKT
// key rows (the MN-major A of dq = dS K, and at d 128 the K-major A of
// dK += dS^T q), double-buffered.
template <int D>
struct Layout {
  static constexpr int BQ = D == 64 ? 128 : 64;   // q rows a stage
  static constexpr int NC = 32;                   // q rows a score chunk
  static constexpr int NCH = BQ / NC;
  static constexpr int BOXES = D / 64;
  static constexpr int QSUB = BQ / 64;            // dq sub-tiles along q
  static constexpr int KBOX = BKT * 128;
  static constexpr int QBOX = BQ * 128;
  static constexpr int KV_BYTES = BOXES * KBOX;
  static constexpr int QT_BYTES = BOXES * QBOX;
  static constexpr int DS_BYTES = QSUB * KBOX;
  static constexpr int STAGE = 2 * QT_BYTES;
  static constexpr int K_OFF = 0;
  static constexpr int V_OFF = KV_BYTES;
  static constexpr int DS_OFF = 2 * KV_BYTES;
  static constexpr int ST_OFF = DS_OFF + 2 * DS_BYTES;
  static constexpr int VEC_OFF = ST_OFF + STAGES * STAGE;  // lse, delta
  static constexpr int BAR_OFF = VEC_OFF + STAGES * 2 * BQ * 4;
  static constexpr int SMEM = BAR_OFF + (2 * STAGES + 1) * 8 + 1024;
  static_assert(BOXES * QSUB == CONSUMERS, "a dq sub-tile per warpgroup");
  static_assert(SMEM <= 232448, "fits one SM's shared memory");
};

struct BwdParams {
  CUtensorMap q, k, v, dout;   // (d, S, H, B) views
  const float* lse;            // (B, H, sq_subs * 64): +inf past Sq
  const float* delta;          // (B, H, sq_subs * 64): 0 past Sq
  float* dq_acc;               // (B, H, sq_subs, D / 64, SUB), zeroed
  __nv_bfloat16* dk;           // (B, Hkv, Skv, D) contiguous
  __nv_bfloat16* dv;
  int batch, h, hkv, sq, skv;
  int sq_subs;                 // 64-row sub-tiles a head: Sq padded to BQ
  float scale, softcap;
  int causal, window;          // window <= 0: none
};

// The block's key tile, key head and batch: blocks whose key tiles have
// more q tiles first (ascending key tiles, except a window without the
// causal mask, whose later key tiles see more q rows).
__device__ __forceinline__ void block_work(const BwdParams& p, int& k0,
                                           int& hk, int& b) {
  const int n_kt = (p.skv + BKT - 1) / BKT;
  const int heads = p.batch * p.hkv;
  const int rank = blockIdx.x / heads;
  k0 = (p.window > 0 && !p.causal ? n_kt - 1 - rank : rank) * BKT;
  hk = blockIdx.x % p.hkv;
  b = (blockIdx.x % heads) / p.hkv;
}

// The q tiles [lo, hi) with a visible pair in the key tile at k0: from the
// diagonal (causal) to the window's edge or the end.
template <int BQ>
__device__ __forceinline__ void q_tiles(const BwdParams& p, int k0, int& lo,
                                        int& hi) {
  const int k1 = min(k0 + BKT, p.skv) - 1;
  const int first = p.causal ? k0 : 0;
  int last = p.sq - 1;
  if (p.window > 0) last = min(last, k1 + p.window - 1);
  lo = first / BQ;
  hi = first <= last ? last / BQ + 1 : lo;
}

// Whether some pair of the (q tile at q0, key tile at k0) is masked.
template <int BQ>
__device__ __forceinline__ bool tile_masked(const BwdParams& p, int k0,
                                            int q0) {
  return k0 + BKT > p.skv || (p.causal && q0 < k0 + BKT - 1) ||
         (p.window > 0 && q0 + BQ - 1 - k0 >= p.window);
}

__device__ __forceinline__ bool visible(const BwdParams& p, int qpos,
                                        int kpos) {
  return kpos < p.skv && (!p.causal || qpos >= kpos) &&
         (p.window <= 0 || qpos - kpos < p.window);
}

// wgmma descriptor of an MN-major tile under the 128-byte swizzle: 64-column
// boxes `box` bytes apart, 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t mn_desc(const void* ptr, int box) {
  auto enc = [](uint64_t x) { return (x & 0x3FFFF) >> 4; };
  return enc(smem_addr(ptr)) | (enc(box) << 16) | (enc(1024) << 32) |
         (1ull << 62);
}

// wgmma m64n64k16 with both operands MN-major in shared memory (A and B
// transposed): dq = dS K, A = dS^T as stored, B = K as loaded.
__device__ __forceinline__ void mma_tt(float (&d)[32], uint64_t xd,
                                       uint64_t yd, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14,"
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
      "%28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(xd), "l"(yd), "r"(scale_d));
}

// wgmma m64n32k16, both operands K-major in shared memory: the score
// chunks at head_dim 128.
__device__ __forceinline__ void mma_n32(float (&d)[16], uint64_t xd,
                                        uint64_t yd, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14,"
      "%15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(xd), "l"(yd), "r"(scale_d));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// P^T and dS^T of one score chunk in place: s holds S^T, dp dP^T; entry
// 4 j + 2 hh + e is key row key + 8 hh, q column col0 + 8 j + 2 q4 + e.
// vec holds the stage's lse (+inf past the length), then, BQ floats on,
// delta (0 past the length). CAP: the soft cap's tanh and its derivative;
// MASK: the causal, window and key-length mask (only tiles that cross an
// edge).
template <int NC, int BQ, bool CAP, bool MASK>
__device__ __forceinline__ void p_and_ds(const BwdParams& p,
                                         float (&s)[NC / 2],
                                         float (&dp)[NC / 2],
                                         const float* vec, int col0, int q4,
                                         int qpos0, int key) {
  const float scale = p.scale, scale_l2 = p.scale * LOG2E;
#pragma unroll
  for (int j = 0; j < NC / 8; ++j) {
    const int col = col0 + 8 * j + 2 * q4;
    const float2 lse = *reinterpret_cast<const float2*>(vec + col);
    const float2 del = *reinterpret_cast<const float2*>(vec + BQ + col);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * j + 2 * hh + e;
        const float l2 = (e ? lse.y : lse.x) * LOG2E;
        float pv, f = scale;
        if (CAP) {
          const float th = tanhf(s[i] * scale / p.softcap);
          pv = ex2(p.softcap * th * LOG2E - l2);
          f = (1.f - th * th) * scale;
        } else {
          pv = ex2(fmaf(s[i], scale_l2, -l2));
        }
        if (MASK && !visible(p, qpos0 + col + e, key + 8 * hh)) pv = 0.f;
        s[i] = pv;
        dp[i] = pv * (dp[i] - (e ? del.y : del.x)) * f;
      }
    }
  }
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

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Generic-proxy shared-memory writes (dS^T) made visible to the async
// proxy that wgmma reads its shared-memory operands through.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned) from
// global to shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Zero an accumulator, each register by its own instruction: with plain
// assignments the compiler copies one zero register into the others and
// then uses it as an accumulator of an in-flight wgmma, which makes ptxas
// wait for that wgmma before the next copy (C7517), serializing the
// chunks' products.
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

// Issue chunk c's S^T = K q^T and dP^T = V dO^T (this warpgroup's 64 key
// rows by the chunk's NC q rows) as one wgmma group. REGS: K and V are A
// fragments in registers (kf, vf); else both operands from shared memory.
template <int D, bool REGS, class L>
__device__ __forceinline__ void issue_scores(
    float (&sc)[L::NC / 2], float (&dc)[L::NC / 2],
    const uint32_t (&kf)[REGS ? D / 16 : 1][4],
    const uint32_t (&vf)[REGS ? D / 16 : 1][4], const unsigned char* ks,
    const unsigned char* vs, const unsigned char* qs,
    const unsigned char* dos, int c, int cw) {
  constexpr int NC = L::NC;
  static_assert(NC == 32, "the shared-memory scores are m64n32");
  zero(sc);
  zero(dc);
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int qoff = (kk / 4) * L::QBOX + c * NC * 128 + (kk % 4) * 32;
    if constexpr (REGS) {
      sm90::WgmmaRS<NC>::template mma<0>(sc, kf[kk],
                                         sm90::smem_desc(qs + qoff), 1);
      sm90::WgmmaRS<NC>::template mma<0>(dc, vf[kk],
                                         sm90::smem_desc(dos + qoff), 1);
    } else {
      const int off = (kk / 4) * L::KBOX + cw * 64 * 128 + (kk % 4) * 32;
      mma_n32(sc, sm90::smem_desc(ks + off), sm90::smem_desc(qs + qoff), 1);
      mma_n32(dc, sm90::smem_desc(vs + off), sm90::smem_desc(dos + qoff), 1);
    }
  }
  sm90::wgmma_commit();
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_kernel(const __grid_constant__ BwdParams p) {
  using L = Layout<D>;
  constexpr int BQ = L::BQ;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* empty = full + STAGES;
  uint64_t* kv_full = empty + STAGES;
  int k0, hk, b;
  block_work(p, k0, hk, b);
  int t_lo, t_hi;
  q_tiles<BQ>(p, k0, t_lo, t_hi);
  const int group = p.h / p.hkv;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], CONSUMERS);
    }
    sm90::mbar_init(kv_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread issues every load, the stages' lse and delta
    // rows by bulk copies beside the q and dO tiles
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x != 0) return;
    sm90::mbar_expect_tx(kv_full, 2 * L::KV_BYTES);
#pragma unroll
    for (int x = 0; x < L::BOXES; ++x) {
      sm90::tma_load_4d(smem + L::K_OFF + x * L::KBOX, &p.k, kv_full, 64 * x,
                        k0, hk, b);
      sm90::tma_load_4d(smem + L::V_OFF + x * L::KBOX, &p.v, kv_full, 64 * x,
                        k0, hk, b);
    }
    int stage = 0, phase = 0;
    for (int g = 0; g < group; ++g) {
      const int h = hk * group + g;
      const size_t row0 = ((size_t)b * p.h + h) * p.sq_subs * 64;
      for (int t = t_lo; t < t_hi; ++t) {
        sm90::mbar_wait(&empty[stage], phase ^ 1);
        unsigned char* st = smem + L::ST_OFF + stage * L::STAGE;
        unsigned char* vec = smem + L::VEC_OFF + stage * 2 * BQ * 4;
        sm90::mbar_expect_tx(&full[stage], L::STAGE + 2 * BQ * 4);
#pragma unroll
        for (int x = 0; x < L::BOXES; ++x) {
          sm90::tma_load_4d(st + x * L::QBOX, &p.q, &full[stage], 64 * x,
                            t * BQ, h, b);
          sm90::tma_load_4d(st + L::QT_BYTES + x * L::QBOX, &p.dout,
                            &full[stage], 64 * x, t * BQ, h, b);
        }
        bulk_load(vec, p.lse + row0 + t * BQ, BQ * 4, &full[stage]);
        bulk_load(vec + BQ * 4, p.delta + row0 + t * BQ, BQ * 4,
                  &full[stage]);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    // drain: the last stages' releases, so that consumers that never
    // finish trip this thread's trapping wait instead of hanging the card
    for (int i = 0; i < STAGES; ++i) {
      sm90::mbar_wait(&empty[stage], phase ^ 1);
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    return;
  }

  // consumers: warpgroup cw owns key rows [64 cw, 64 cw + 64) of the tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  constexpr int NC = L::NC, NCH = L::NCH;
  // at head_dim 64 K and V are A fragments in registers for the scores,
  // and dK += dS^T q takes dS^T from registers too; at 128 they would not
  // fit beside the dK and dV accumulators, so both come from shared memory
  constexpr bool REGS = D == 64;
  const int cw = wg - 1;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, q4 = lane % 4;
  const bool leader = tid == 0;
  const int r_tile = 64 * cw + 16 * warp + lane / 4;   // (+ 8) in the tile
  const int key = k0 + r_tile;
  const int qb = cw % L::QSUB, db = cw / L::QSUB;      // the dq sub-tile
  const unsigned char* ks = smem + L::K_OFF;
  const unsigned char* vs = smem + L::V_OFF;
  const float cap = p.softcap;

  float dk[D / 2], dv[D / 2];
  zero(dk);
  zero(dv);
  wait_spin(kv_full, 0);
  // A fragments of K and V (REGS): k-step kk holds columns 16 kk + 2 q4
  // (+ 1, + 8, + 9) of rows r_tile and r_tile + 8, read under the swizzle
  uint32_t kf[REGS ? D / 16 : 1][4], vf[REGS ? D / 16 : 1][4];
  if constexpr (REGS) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = r_tile + 8 * (r % 2), col = 16 * kk + 8 * (r / 2);
        const int off = (col / 64) * L::KBOX + row * 128 +
                        ((((col % 64) / 8) ^ (row % 8)) * 16) + 4 * q4;
        kf[kk][r] = *reinterpret_cast<const uint32_t*>(ks + off);
        vf[kk][r] = *reinterpret_cast<const uint32_t*>(vs + off);
      }
    }
  }
  int stage = 0, phase = 0, buf = 0;
  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    float* acc_head = p.dq_acc + ((size_t)b * p.h + h) * p.sq_subs *
                                     L::BOXES * SUB;
    for (int t = t_lo; t < t_hi; ++t) {
      const int q0 = t * BQ;
      wait_spin(&full[stage], phase);
      const unsigned char* qs = smem + L::ST_OFF + stage * L::STAGE;
      const unsigned char* dos = qs + L::QT_BYTES;
      const float* vec =
          reinterpret_cast<const float*>(smem + L::VEC_OFF +
                                         stage * 2 * BQ * 4);
      const bool masked = tile_masked<BQ>(p, k0, q0);
      unsigned char* dsb = smem + L::DS_OFF + buf * L::DS_BYTES;

      // the q tile in NCH chunks of NC rows. S^T = K q^T and dP^T = V dO^T
      // of chunk c + 1 are issued before chunk c's P^T and dS^T are
      // computed, so they run meanwhile; a ring of two chunks of scores
      float s[2][NC / 2], dp[2][NC / 2];
      issue_scores<D, REGS, L>(s[0], dp[0], kf, vf, ks, vs, qs, dos, 0, cw);
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        if (c + 1 < NCH)
          issue_scores<D, REGS, L>(s[(c + 1) % 2], dp[(c + 1) % 2], kf, vf, ks,
                                   vs, qs, dos, c + 1, cw);
        // chunk c's scores are done; pending after them: chunk c - 1's
        // dV/dK group and chunk c + 1's scores
        if (c == 0 || c + 1 == NCH)
          sm90::wgmma_wait<1>();
        else
          sm90::wgmma_wait<2>();
        float(&sc)[NC / 2] = s[c % 2];
        float(&dc)[NC / 2] = dp[c % 2];
        sm90::fence_regs(sc);
        sm90::fence_regs(dc);

        // P^T and dS^T in registers, the soft cap and the mask decided
        // once a chunk
        if (cap > 0.f) {
          if (masked)
            p_and_ds<NC, BQ, true, true>(p, sc, dc, vec, c * NC, q4, q0, key);
          else
            p_and_ds<NC, BQ, true, false>(p, sc, dc, vec, c * NC, q4, q0,
                                          key);
        } else {
          if (masked)
            p_and_ds<NC, BQ, false, true>(p, sc, dc, vec, c * NC, q4, q0,
                                          key);
          else
            p_and_ds<NC, BQ, false, false>(p, sc, dc, vec, c * NC, q4, q0,
                                           key);
        }
        // the chunk's A fragments: k-step kk, columns 16 kk .. 16 kk + 15
        // (the accumulator of 16 columns packed to bf16 pairs)
        uint32_t pa[NC / 16][4], da[NC / 16][4];
#pragma unroll
        for (int kk = 0; kk < NC / 16; ++kk) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            pa[kk][r] = pack2(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
            da[kk][r] = pack2(dc[8 * kk + 2 * r], dc[8 * kk + 2 * r + 1]);
          }
        }
        // dS^T to shared memory (for dq, and for dK at head_dim 128):
        // global 8-column group jg in box jg / 8, 16-byte chunk jg % 8 of
        // the key row under the swizzle
#pragma unroll
        for (int j = 0; j < NC / 8; ++j) {
          const int jg = c * NC / 8 + j;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int r = r_tile + 8 * hh;
            *reinterpret_cast<uint32_t*>(
                dsb + (jg / 8) * L::KBOX + r * 128 +
                (((jg % 8) ^ (r % 8)) * 16) + q4 * 4) =
                da[j / 2][2 * (j % 2) + hh];
          }
        }
        // dV += P^T dO (and, REGS, dK += dS^T q) with A from registers
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < NC / 16; ++kk) {
          const int row = (c * NC + 16 * kk) * 128;
          sm90::WgmmaRS<D>::template mma<1>(
              dv, pa[kk], mn_desc(dos + row, L::QBOX), 1);
          if constexpr (REGS)
            sm90::WgmmaRS<D>::template mma<1>(
                dk, da[kk], mn_desc(qs + row, L::QBOX), 1);
        }
        sm90::wgmma_commit();
      }
      fence_async_smem();
      bar_sync(1, 128 * CONSUMERS);   // dS^T of both warpgroups written

      // (not REGS: dK += dS^T q, A K-major from shared memory) and this
      // warpgroup's dq sub-tile dS K over all 128 keys (A transposed)
      float dq[32];
      zero(dq);
      sm90::wgmma_fence();
      if constexpr (!REGS) {
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
          sm90::Wgmma<D>::template mma<1>(
              dk,
              sm90::smem_desc(dsb + (kk / 4) * L::KBOX + cw * 64 * 128 +
                              (kk % 4) * 32),
              mn_desc(qs + kk * 2048, L::QBOX), 1);
      }
#pragma unroll
      for (int kk = 0; kk < BKT / 16; ++kk)
        mma_tt(dq, mn_desc(dsb + qb * L::KBOX + kk * 2048, L::KBOX),
               mn_desc(ks + db * L::KBOX + kk * 2048, L::KBOX), 1);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dq);
      sm90::fence_regs(dk);
      sm90::fence_regs(dv);
      if (leader) sm90::mbar_arrive(&empty[stage]);   // q, dO read

      // the dq sub-tile added into the workspace by 16-byte reductions in
      // the accumulator's order (entry 4 j + e of thread tid at
      // 512 j + 4 tid + e), a warp's 32 lanes on 512 contiguous bytes; red,
      // as the float4 atomicAdd compiles to an atom returning old values
      float* dst =
          acc_head + ((size_t)(t * L::QSUB + qb) * L::BOXES + db) * SUB;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"l"(
                         dst + 512 * j + 4 * tid),
                     "f"(dq[4 * j]), "f"(dq[4 * j + 1]), "f"(dq[4 * j + 2]),
                     "f"(dq[4 * j + 3])
                     : "memory");

      buf ^= 1;
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
  }

  const size_t bhk = (size_t)b * p.hkv + hk;
  store_rows<D>(p.dk + bhk * p.skv * D, dk, key, p.skv, q4);
  store_rows<D>(p.dv + bhk * p.skv * D, dv, key, p.skv, q4);
}

// dq (B, H, Sq, D) bf16 from the fp32 workspace: one block of 128 threads
// a 64 x 64 sub-tile, whose thread tid holds what consumer thread tid's
// accumulator held (coalesced 16-byte loads), rounded, quad-transposed and
// stored 16 bytes a lane.
template <int D>
__global__ void __launch_bounds__(128)
    flash_bwd_dq_convert_kernel(const float* __restrict__ acc,
                                __nv_bfloat16* __restrict__ dq, int sq,
                                int sq_subs) {
  constexpr int BOXES = D / 64;
  const int subs = (sq + 63) / 64;
  const int db = blockIdx.x % BOXES;
  const int sub = (blockIdx.x / BOXES) % subs;
  const size_t bh = blockIdx.x / (BOXES * subs);
  const float* src = acc + ((bh * sq_subs + sub) * BOXES + db) * SUB;
  const int tid = threadIdx.x, lane = tid % 32, q4 = lane % 4;
  float4 v[8];
#pragma unroll
  for (int j = 0; j < 8; ++j)
    v[j] = __ldcs(reinterpret_cast<const float4*>(src + 512 * j + 4 * tid));
  const int row = sub * 64 + 16 * (tid / 32) + lane / 4;
  __nv_bfloat16* out = dq + bh * sq * D + db * 64;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      uint32_t x[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 u = v[4 * c + i];
        x[i] = h ? pack2(u.z, u.w) : pack2(u.x, u.y);
      }
      quad_transpose(x, q4);
      if (row + 8 * h < sq)
        *reinterpret_cast<uint4*>(out + (size_t)(row + 8 * h) * D +
                                  8 * (4 * c + q4)) =
            make_uint4(x[0], x[1], x[2], x[3]);
    }
  }
}

template <int D>
cudaError_t launch(BwdParams& p, const sm90::View4 (&views)[4],
                   const float* acc, __nv_bfloat16* dq, int which,
                   cudaStream_t stream) {
  using L = Layout<D>;
  p.sq_subs = (p.sq + L::BQ - 1) / L::BQ * L::QSUB;
  if (which == 1) {
    const long long blocks =
        (long long)p.batch * p.h * ((p.sq + 63) / 64) * L::BOXES;
    flash_bwd_dq_convert_kernel<D>
        <<<(unsigned)blocks, 128, 0, stream>>>(acc, dq, p.sq, p.sq_subs);
    return cudaGetLastError();
  }
  const int rows[4] = {L::BQ, BKT, BKT, L::BQ};
  CUtensorMap* maps[4] = {&p.q, &p.k, &p.v, &p.dout};
  for (int i = 0; i < 4; ++i) {
    const cudaError_t err = sm90::make_map_4d(maps[i], views[i], rows[i]);
    if (err != cudaSuccess) return err;
  }
  auto kernel = flash_bwd_kernel<D>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (err != cudaSuccess) return err;
  const long long blocks =
      (long long)((p.skv + BKT - 1) / BKT) * p.batch * p.hkv;
  kernel<<<(unsigned)blocks, THREADS, L::SMEM, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// which = 0: the main kernel (dk, dv written, dq reduce-added into the
// zeroed fp32 workspace dq_acc); which = 1: dq_acc converted to dq. Strides
// are in elements; the last dim of q, k, v and dout is contiguous, the
// other strides multiples of 8 and the bases 16-byte aligned (the wrapper
// checks; the map encoder refuses otherwise). With Sp = ceil(Sq / BQ) * BQ
// (BQ = 128 at head_dim 64, 64 at 128): lse and delta are (B, H, Sp) fp32,
// +inf and 0 past Sq; dq_acc holds (B, H, Sp / 64, head_dim / 64, 64 * 64)
// floats. Returns cudaErrorInvalidValue on a head_dim other than 64 or 128
// or a group that does not divide.
int flash_bwd_launch(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dq_acc, void* dq, void* dk, void* dv, int which,
                     int batch, int h, int hkv, int sq, int skv, int head_dim,
                     long long qs_b, long long qs_h, long long qs_s,
                     long long ks_b, long long ks_h, long long ks_s,
                     long long vs_b, long long vs_h, long long vs_s,
                     long long os_b, long long os_h, long long os_s,
                     float scale, float softcap, int causal, int window,
                     void* stream) {
  if ((which != 0 && which != 1) || batch < 1 || h < 1 || hkv < 1 ||
      h % hkv || sq < 1 || skv < 1)
    return cudaErrorInvalidValue;
  BwdParams p;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq_acc = static_cast<float*>(dq_acc);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.batch = batch; p.h = h; p.hkv = hkv; p.sq = sq; p.skv = skv;
  p.scale = scale; p.softcap = softcap;
  p.causal = causal; p.window = window;
  const sm90::View4 views[4] = {
      {q, head_dim, sq, h, batch, qs_s, qs_h, qs_b},
      {k, head_dim, skv, hkv, batch, ks_s, ks_h, ks_b},
      {v, head_dim, skv, hkv, batch, vs_s, vs_h, vs_b},
      {dout, head_dim, sq, h, batch, os_s, os_h, os_b}};
  const float* acc = static_cast<const float*>(dq_acc);
  __nv_bfloat16* dqo = static_cast<__nv_bfloat16*>(dq);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) return launch<64>(p, views, acc, dqo, which, st);
  if (head_dim == 128) return launch<128>(p, views, acc, dqo, which, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"

// dB of the fused GEMM for Hopper: dB [, dB2] = prologue(A)^T @ E'^T(g) [, E'^T(g)_2].
//
// Replaces the TPU kernel `_db_kernel` (src/repro/kernels/gemm/backward.py),
// launched there by `_gemm_bwd_db`. Same chain:
//   A tiles   the rmsnorm prologue recomputed on each A tile with the
//             forward's rounding point: x rstd gamma in fp32 (the forward's
//             saved rstd), then rounded to bf16, exactly as gemm_fused.cu
//             normalises A, so An is the forward's An bit for bit; read as
//             A^T in column-major order, so no transposed copy is made;
//   g tiles   the transposed epilogue (gemm_bwd_g.cuh), rounded to bf16 for
//             the tensor cores, where the TPU kernel contracts in fp32;
//   product   dB = An^T @ gbar; for the SwiGLU up-projection dB and dB2
//             accumulate side by side from the same A stream in one launch;
//   dbias     the column sum of g_bias (fp32, before rounding) taken by the
//             blocks of the first K-row band as their g tiles load, reduced
//             across the block in a fixed order and stored with the tile.
//
// What bounds it on an H100: at the training shapes of llama-1b (M = 4096
// tokens contracted, K = 2048 or 8192, N = 512 .. 2 x 8192) the products,
// 2 M N K operations on the tensor cores (989 TFLOP/s bf16), against a few
// tens of MB of A, g, preacts and dB over HBM (3.35 TB/s). The design is the
// forward's: WMMA 16x16x16 bf16 fragments, a 128 x 128 output block (the dual
// output: 128 x 64, two accumulators) over 8 warps, a two-stage shared-memory
// ring filled through registers, the prologue and the transposed epilogue
// applied on the register -> shared store. No wgmma, TMA or warp
// specialisation yet. Ragged M, N and K edges are masked (N and K must be
// multiples of 8).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "gemm_bwd_g.cuh"

using namespace nvcuda;
using namespace gbwd;

namespace {

constexpr int BO = 128;      // output rows (over K)
constexpr int BC = 32;       // contraction depth (over M)
constexpr int THREADS = 256;
constexpr int PAD = 8;
constexpr int LDA = BO + PAD;   // A tile (BC rows of M, BO cols of K), bf16
constexpr int A_ELEMS = BC * LDA;
constexpr int A_VECS = BC * BO / 8 / THREADS;
static_assert(A_VECS * THREADS * 8 == BC * BO, "A tile / threads");

template <int MODE>
struct DbCfg {
  static constexpr bool GATE = MODE == G_GATE;
  static constexpr int BN = GATE ? 64 : 128;          // output cols (over N)
  static constexpr int WO = GATE ? 32 : 64, WN = 32;  // warp tile
  static constexpr int WARPS_N = BN / WN;
  static_assert(32 * (BO / WO) * WARPS_N == THREADS, "warps");
  static constexpr int FO = WO / 16, FN = WN / 16;
  static constexpr int LDG = BN + PAD;                 // g tile (BC x BN)
  static constexpr int LDC = BN + 4;
  static constexpr int G_ELEMS = BC * LDG;
  static constexpr int STREAMS = GATE ? 2 : 1;
  static constexpr int STAGE = A_ELEMS + STREAMS * G_ELEMS;
  static constexpr int PIPE_BYTES = 2 * STAGE * 2;
  static constexpr int C_BYTES = STREAMS * BO * LDC * 4;
  static constexpr int BYTES = PIPE_BYTES > C_BYTES ? PIPE_BYTES : C_BYTES;
  static constexpr int G_VECS = BC * BN / 8 / THREADS;
  static_assert(G_VECS * THREADS * 8 == BC * BN, "g tile / threads");
  // every thread keeps the same 8 columns of the g tile: its dbias partials
  static_assert(THREADS % (BN / 8) == 0, "fixed columns per thread");
};

struct DbArgs {
  GSrc gs;
  const __nv_bfloat16* a;      // (M, K)
  const __nv_bfloat16* gamma;  // (K,) or null
  const float* rstd;           // (M,) the forward's, or null
  __nv_bfloat16* db;           // (K, N)
  __nv_bfloat16* db2;          // (K, N), gate only
  float* dbias;                // (N,) fp32, bias chains only, or null
  int k;
};

template <int MODE>
__global__ void __launch_bounds__(THREADS) gemm_bwd_db_kernel(DbArgs p) {
  using C = DbCfg<MODE>;
  constexpr bool GATE = C::GATE;
  constexpr int BN = C::BN;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* pipe = reinterpret_cast<__nv_bfloat16*>(smem);
  const int n0 = blockIdx.x * BN;
  const int o0 = blockIdx.y * BO;
  const int warp = threadIdx.x / 32;
  const int wo = warp / C::WARPS_N, wn = warp % C::WARPS_N;
  const int m = p.gs.m, n = p.gs.n;
  const bool sum_bias = p.dbias != nullptr && blockIdx.y == 0;

  auto a_s = [&](int s) { return pipe + s * C::STAGE; };
  auto g_s = [&](int s) { return pipe + s * C::STAGE + A_ELEMS; };
  auto g2_s = [&](int s) { return pipe + s * C::STAGE + A_ELEMS + C::G_ELEMS; };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[C::FO][C::FN];
  wmma::fragment<wmma::accumulator, 16, 16, 16, float>
      acc2[GATE ? C::FO : 1][GATE ? C::FN : 1];
#pragma unroll
  for (int i = 0; i < C::FO; ++i)
#pragma unroll
    for (int j = 0; j < C::FN; ++j) {
      wmma::fill_fragment(acc[i][j], 0.f);
      if (GATE) wmma::fill_fragment(acc2[GATE ? i : 0][GATE ? j : 0], 0.f);
    }

  uint4 ra[A_VECS];
  GRaw rg[C::G_VECS];
  float bias_part[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) bias_part[e] = 0.f;

  auto load = [&](int mt) {
    const int mc = mt * BC;
#pragma unroll
    for (int i = 0; i < A_VECS; ++i) {
      const int v = threadIdx.x + i * THREADS;
      const int gm = mc + v / (BO / 8), gk = o0 + (v % (BO / 8)) * 8;
      ra[i] = (gm < m && gk < p.k) ? ld16(p.a + (size_t)gm * p.k + gk)
                                   : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int i = 0; i < C::G_VECS; ++i) {
      const int v = threadIdx.x + i * THREADS;
      g_load<MODE>(p.gs, mc + v / (BN / 8), n0 + (v % (BN / 8)) * 8, rg[i]);
    }
  };
  auto store = [&](int mt, int s) {
    const int mc = mt * BC;
#pragma unroll
    for (int i = 0; i < A_VECS; ++i) {
      const int v = threadIdx.x + i * THREADS;
      const int r = v / (BO / 8), c = (v % (BO / 8)) * 8;
      const int gm = mc + r, gk = o0 + c;
      uint4 val = ra[i];
      if (p.gamma != nullptr && gm < m && gk < p.k) {
        // the forward's prologue (gemm_fused.cu store_a), bit for bit
        const float rs = p.rstd[gm];
        const uint4 graw = ld16(p.gamma + gk);
        __nv_bfloat16* x = reinterpret_cast<__nv_bfloat16*>(&val);
        const __nv_bfloat16* gv = reinterpret_cast<const __nv_bfloat16*>(&graw);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float f = __fmul_rn(__bfloat162float(x[e]), rs);
          x[e] = __float2bfloat16_rn(__fmul_rn(f, __bfloat162float(gv[e])));
        }
      }
      *reinterpret_cast<uint4*>(a_s(s) + r * LDA + c) = val;
    }
#pragma unroll
    for (int i = 0; i < C::G_VECS; ++i) {
      const int v = threadIdx.x + i * THREADS;
      const int r = v / (BN / 8), c = (v % (BN / 8)) * 8;
      float ga[8], ga2[8], gb[8];
      g_transform<MODE>(p.gs, mc + r, n0 + c, rg[i], ga, ga2, gb);
      *reinterpret_cast<uint4*>(g_s(s) + r * C::LDG + c) = pack_bf16(ga);
      if constexpr (GATE)
        *reinterpret_cast<uint4*>(g2_s(s) + r * C::LDG + c) = pack_bf16(ga2);
      if (sum_bias) {
#pragma unroll
        for (int e = 0; e < 8; ++e) bias_part[e] += gb[e];
      }
    }
  };

  const int mt_count = (m + BC - 1) / BC;
  load(0);
  store(0, 0);
  __syncthreads();
  for (int mt = 0; mt < mt_count; ++mt) {
    const int s = mt & 1;
    const bool more = mt + 1 < mt_count;
    if (more) load(mt + 1);
#pragma unroll
    for (int mm = 0; mm < BC; mm += 16) {
      // An^T (K x M) in column-major order is the (M, K) tile row-major
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major> fa[C::FO];
#pragma unroll
      for (int i = 0; i < C::FO; ++i)
        wmma::load_matrix_sync(fa[i], a_s(s) + mm * LDA + wo * C::WO + i * 16,
                               LDA);
#pragma unroll
      for (int j = 0; j < C::FN; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fb;
        wmma::load_matrix_sync(fb, g_s(s) + mm * C::LDG + wn * C::WN + j * 16,
                               C::LDG);
#pragma unroll
        for (int i = 0; i < C::FO; ++i)
          wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
        if constexpr (GATE) {
          wmma::load_matrix_sync(fb, g2_s(s) + mm * C::LDG + wn * C::WN + j * 16,
                                 C::LDG);
#pragma unroll
          for (int i = 0; i < C::FO; ++i)
            wmma::mma_sync(acc2[i][j], fa[i], fb, acc2[i][j]);
        }
      }
    }
    if (more) store(mt + 1, s ^ 1);
    __syncthreads();
  }

  float* cs = reinterpret_cast<float*>(smem);
  float* cs2 = cs + BO * C::LDC;
#pragma unroll
  for (int i = 0; i < C::FO; ++i)
#pragma unroll
    for (int j = 0; j < C::FN; ++j) {
      const int off = (wo * C::WO + i * 16) * C::LDC + wn * C::WN + j * 16;
      wmma::store_matrix_sync(cs + off, acc[i][j], C::LDC, wmma::mem_row_major);
      if constexpr (GATE)
        wmma::store_matrix_sync(cs2 + off, acc2[i][j], C::LDC,
                                wmma::mem_row_major);
    }
  __syncthreads();
  for (int v = threadIdx.x; v < BO * BN / 8; v += THREADS) {
    const int r = v / (BN / 8), c0 = (v % (BN / 8)) * 8;
    const int gk = o0 + r, gn0 = n0 + c0;
    if (gk >= p.k || gn0 >= n) continue;
    const size_t off = (size_t)gk * n + gn0;
    float vals[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) vals[e] = cs[r * C::LDC + c0 + e];
    *reinterpret_cast<uint4*>(p.db + off) = pack_bf16(vals);
    if constexpr (GATE) {
#pragma unroll
      for (int e = 0; e < 8; ++e) vals[e] = cs2[r * C::LDC + c0 + e];
      *reinterpret_cast<uint4*>(p.db2 + off) = pack_bf16(vals);
    }
  }
  if (sum_bias) {
    // THREADS / (BN / 8) threads share each 8-column group: sum their
    // partials in a fixed order, so dbias does not depend on timing
    constexpr int GROUPS = BN / 8, SHARERS = THREADS / GROUPS;
    __syncthreads();
    float* red = cs;   // (SHARERS, BN)
    const int grp = threadIdx.x % GROUPS, who = threadIdx.x / GROUPS;
#pragma unroll
    for (int e = 0; e < 8; ++e) red[who * BN + grp * 8 + e] = bias_part[e];
    __syncthreads();
    for (int c = threadIdx.x; c < BN; c += THREADS) {
      float sum = 0.f;
      for (int w = 0; w < SHARERS; ++w) sum += red[w * BN + c];
      if (n0 + c < n) p.dbias[n0 + c] = sum;
    }
  }
}

template <int MODE>
cudaError_t launch(const DbArgs& p, cudaStream_t stream) {
  using C = DbCfg<MODE>;
  auto kernel = gemm_bwd_db_kernel<MODE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::BYTES);
  if (err != cudaSuccess) return err;
  dim3 grid((p.gs.n + C::BN - 1) / C::BN, (p.k + BO - 1) / BO);
  kernel<<<grid, THREADS, C::BYTES, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// g, preact, preact2: (M, N) bf16 (preacts for the gated chain, else null);
// sin, cos: (M, head_dim) fp32 for rope, else null; a: (M, K) bf16; gamma
// (K,) bf16 and the forward's rstd (M,) fp32 for the rmsnorm prologue, else
// null. Writes db (K, N) bf16, db2 (K, N) for the gated chain, and dbias
// (N,) fp32 when it is not null. `scale` is 1 for a chain without a scale.
int gemm_bwd_db_launch(const void* g, const void* preact, const void* preact2,
                       const void* sin, const void* cos, const void* a,
                       const void* gamma, const void* rstd, void* db,
                       void* db2, void* dbias, float scale, int m, int n,
                       int k, int flags, int head_dim, void* stream) {
  DbArgs p;
  p.gs.g = static_cast<const __nv_bfloat16*>(g);
  p.gs.preact = static_cast<const __nv_bfloat16*>(preact);
  p.gs.preact2 = static_cast<const __nv_bfloat16*>(preact2);
  p.gs.sin = static_cast<const float*>(sin);
  p.gs.cos = static_cast<const float*>(cos);
  p.gs.scale = scale;
  p.gs.m = m;
  p.gs.n = n;
  p.gs.head_dim = head_dim;
  p.a = static_cast<const __nv_bfloat16*>(a);
  p.gamma = static_cast<const __nv_bfloat16*>(gamma);
  p.rstd = static_cast<const float*>(rstd);
  p.db = static_cast<__nv_bfloat16*>(db);
  p.db2 = static_cast<__nv_bfloat16*>(db2);
  p.dbias = static_cast<float*>(dbias);
  p.k = k;
  if ((gamma != nullptr) != (rstd != nullptr)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (flags & EP_GATE_SILU) {
    if (preact == nullptr || preact2 == nullptr || db2 == nullptr ||
        dbias != nullptr)
      return cudaErrorInvalidValue;
    return launch<G_GATE>(p, st);
  }
  if (flags & EP_ROPE) {
    if (sin == nullptr || cos == nullptr || head_dim % 16)
      return cudaErrorInvalidValue;
    return launch<G_ROPE>(p, st);
  }
  return launch<G_PLAIN>(p, st);
}

}  // extern "C"

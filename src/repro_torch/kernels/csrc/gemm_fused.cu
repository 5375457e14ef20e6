// Fused GEMM for Hopper: C = epilogue(prologue(A) @ B [, A @ B2]).
//
// Replaces the TPU kernel `_gemm_kernel` (src/repro/kernels/gemm/kernel.py),
// launched there by `_gemm_pallas`. It computes the same chain:
//   prologue  rmsnorm of each A row in fp32, rounded back to bf16 before the
//             product (kernel.py:111-119); the row statistics come from a
//             small stats pass in this file, the reference's own
//             precomputed-stats path (prologue.py:150-162), because a
//             full-K A tile (the TPU pins block_k = K) does not fit in the
//             227 KB of shared memory a block can use at K = 2048;
//   product   bf16 x bf16 -> fp32 accumulators (two for the gated variant);
//   epilogue  x scale -> + bias -> rope -> silu(acc) * acc2 -> + residual,
//             on the fp32 tile staged through shared memory, so the RoPE
//             partner column (c +- head_dim/2, held by another warp) is
//             readable; BLOCK_N is a multiple of head_dim;
//   save      for the differentiated forward of the gated chain, the two raw
//             fp32 accumulators rounded to bf16 into `preact`/`preact2`
//             (kernel.py:84-90 stores them through the MXU input type), the
//             operands of the backward's silu' (gemm_bwd_da.cu,
//             gemm_bwd_db.cu). The row statistics stay in `rstd` for the
//             backward too.
//
// What bounds it on an H100: at the prefill shapes (M = B*S = 1024, K = 2048,
// N up to 2 x 8192) the tensor cores (989 TFLOP/s bf16); at the decode shapes
// (M = 4) the weight bytes over HBM (3.35 TB/s). This first version is
// simple and right: WMMA 16x16x16 bf16 fragments, a 128x128 (gated: 128x64)
// block tile over 8 warps, a two-stage shared-memory ring filled through
// registers (the next K-tile's global loads are in flight while the current
// one is multiplied; the prologue normalises on the register -> shared-memory
// store). It does not use wgmma, TMA or warp specialisation, and decode
// launches only N / BLOCK_N blocks; both are left to later work. Ragged M, N
// and K edges are masked in the kernel (N and K must be multiples of 8).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

enum : int {
  EP_SCALE = 1,
  EP_BIAS = 2,
  EP_ROPE = 4,
  EP_GATE_SILU = 8,
  EP_RESIDUAL = 16,
};

constexpr int BK = 32;       // K-tile depth (two 16-deep WMMA steps)
constexpr int PAD_AB = 8;    // bf16 padding of the A/B shared tiles
constexpr int PAD_C = 4;     // fp32 padding of the staged output tile

struct GemmArgs {
  const __nv_bfloat16* a;         // (M, K)
  const __nv_bfloat16* b;         // (K, N)
  const __nv_bfloat16* b2;        // (K, N) gated variant only
  __nv_bfloat16* c;               // (M, N)
  const __nv_bfloat16* gamma;     // (K,) rmsnorm scale, or null
  const float* rstd;              // (M,) row statistics, or null
  const __nv_bfloat16* bias;      // (N,)
  const __nv_bfloat16* residual;  // (M, N)
  const float* sin;               // (M, head_dim)
  const float* cos;               // (M, head_dim)
  __nv_bfloat16* preact;          // (M, N) raw acc in bf16, gated only, or null
  __nv_bfloat16* preact2;         // (M, N) raw acc2 in bf16, or null
  float scale;
  int m, n, k;
  int flags;
  int head_dim;
};

// One row's rstd = 1 / sqrt(mean(x^2) + eps), fp32, as models/common.rmsnorm.
__global__ void rms_stats_kernel(const __nv_bfloat16* __restrict__ a,
                                 float* __restrict__ rstd, int k, float eps) {
  const int row = blockIdx.x;
  const __nv_bfloat16* x = a + (size_t)row * k;
  float sum = 0.f;
  for (int c = threadIdx.x * 8; c < k; c += blockDim.x * 8) {
    uint4 raw = *reinterpret_cast<const uint4*>(x + c);
    const __nv_bfloat16* v = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float f = __bfloat162float(v[i]);
      sum += f * f;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  __shared__ float warp_sums[32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) warp_sums[warp] = sum;
  __syncthreads();
  if (warp == 0) {
    const int nwarps = blockDim.x / 32;
    float s = lane < nwarps ? warp_sums[lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) rstd[row] = 1.0f / sqrtf(s / (float)k + eps);
  }
}

__device__ __forceinline__ float silu(float x) { return x / (1.0f + expf(-x)); }

template <int BM, int BN, int WM, int WN, bool GATE>
struct GemmConfig {
  static constexpr int WARPS_M = BM / WM;
  static constexpr int WARPS_N = BN / WN;
  static constexpr int THREADS = 32 * WARPS_M * WARPS_N;
  static constexpr int FM = WM / 16;
  static constexpr int FN = WN / 16;
  static constexpr int LDA = BK + PAD_AB;
  static constexpr int LDB = BN + PAD_AB;
  static constexpr int LDC = BN + PAD_C;
  static constexpr int A_ELEMS = BM * LDA;
  static constexpr int B_ELEMS = BK * LDB;
  static constexpr int STAGE_ELEMS = A_ELEMS + (GATE ? 2 : 1) * B_ELEMS;
  static constexpr int PIPE_BYTES = 2 * STAGE_ELEMS * 2;
  static constexpr int C_BYTES = (GATE ? 2 : 1) * BM * LDC * 4;
  static constexpr int SMEM_BYTES = PIPE_BYTES > C_BYTES ? PIPE_BYTES : C_BYTES;
  static constexpr int A_VECS = BM * BK / 8 / THREADS;  // 16-byte vectors
  static constexpr int B_VECS = BK * BN / 8 / THREADS;
  static_assert(A_VECS * THREADS * 8 == BM * BK, "A tile / threads");
  static_assert(B_VECS * THREADS * 8 == BK * BN, "B tile / threads");
};

template <class Cfg>
__device__ __forceinline__ void load_a(const GemmArgs& p, int m0, int k0,
                                       uint4 (&regs)[Cfg::A_VECS]) {
#pragma unroll
  for (int i = 0; i < Cfg::A_VECS; ++i) {
    const int v = threadIdx.x + i * Cfg::THREADS;
    const int r = v / (BK / 8), c = (v % (BK / 8)) * 8;
    const int gm = m0 + r, gk = k0 + c;
    if (gm < p.m && gk < p.k)
      regs[i] = *reinterpret_cast<const uint4*>(p.a + (size_t)gm * p.k + gk);
    else
      regs[i] = make_uint4(0, 0, 0, 0);
  }
}

template <class Cfg>
__device__ __forceinline__ void load_b(const __nv_bfloat16* b, const GemmArgs& p,
                                       int n0, int k0,
                                       uint4 (&regs)[Cfg::B_VECS]) {
  constexpr int BN = Cfg::LDB - PAD_AB;
#pragma unroll
  for (int i = 0; i < Cfg::B_VECS; ++i) {
    const int v = threadIdx.x + i * Cfg::THREADS;
    const int r = v / (BN / 8), c = (v % (BN / 8)) * 8;
    const int gk = k0 + r, gn = n0 + c;
    if (gk < p.k && gn < p.n)
      regs[i] = *reinterpret_cast<const uint4*>(b + (size_t)gk * p.n + gn);
    else
      regs[i] = make_uint4(0, 0, 0, 0);
  }
}

// Register -> shared store of an A tile, normalising on the way when the
// rmsnorm prologue is on: x * rstd * gamma in fp32, then rounded to bf16.
template <class Cfg>
__device__ __forceinline__ void store_a(const GemmArgs& p, int m0, int k0,
                                        const uint4 (&regs)[Cfg::A_VECS],
                                        __nv_bfloat16* as) {
#pragma unroll
  for (int i = 0; i < Cfg::A_VECS; ++i) {
    const int v = threadIdx.x + i * Cfg::THREADS;
    const int r = v / (BK / 8), c = (v % (BK / 8)) * 8;
    uint4 val = regs[i];
    const int gm = m0 + r, gk = k0 + c;
    if (p.gamma != nullptr && gm < p.m && gk < p.k) {
      const float rs = p.rstd[gm];
      uint4 graw = *reinterpret_cast<const uint4*>(p.gamma + gk);
      __nv_bfloat16* x = reinterpret_cast<__nv_bfloat16*>(&val);
      const __nv_bfloat16* g = reinterpret_cast<const __nv_bfloat16*>(&graw);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        float f = __fmul_rn(__bfloat162float(x[e]), rs);
        x[e] = __float2bfloat16_rn(__fmul_rn(f, __bfloat162float(g[e])));
      }
    }
    *reinterpret_cast<uint4*>(as + r * Cfg::LDA + c) = val;
  }
}

template <class Cfg>
__device__ __forceinline__ void store_b(const uint4 (&regs)[Cfg::B_VECS],
                                        __nv_bfloat16* bs) {
  constexpr int BN = Cfg::LDB - PAD_AB;
#pragma unroll
  for (int i = 0; i < Cfg::B_VECS; ++i) {
    const int v = threadIdx.x + i * Cfg::THREADS;
    const int r = v / (BN / 8), c = (v % (BN / 8)) * 8;
    *reinterpret_cast<uint4*>(bs + r * Cfg::LDB + c) = regs[i];
  }
}

template <int BM, int BN, int WM, int WN, bool GATE>
__global__ void __launch_bounds__(GemmConfig<BM, BN, WM, WN, GATE>::THREADS)
gemm_fused_kernel(GemmArgs p) {
  using Cfg = GemmConfig<BM, BN, WM, WN, GATE>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* pipe = reinterpret_cast<__nv_bfloat16*>(smem);

  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32;
  const int wm = warp / Cfg::WARPS_N, wn = warp % Cfg::WARPS_N;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[Cfg::FM][Cfg::FN];
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc2[GATE ? Cfg::FM : 1]
                                                             [GATE ? Cfg::FN : 1];
#pragma unroll
  for (int i = 0; i < Cfg::FM; ++i)
#pragma unroll
    for (int j = 0; j < Cfg::FN; ++j) {
      wmma::fill_fragment(acc[i][j], 0.f);
      if (GATE) wmma::fill_fragment(acc2[GATE ? i : 0][GATE ? j : 0], 0.f);
    }

  uint4 ra[Cfg::A_VECS], rb[Cfg::B_VECS], rb2[GATE ? Cfg::B_VECS : 1];
  auto stage_a = [&](int s) { return pipe + s * Cfg::STAGE_ELEMS; };
  auto stage_b = [&](int s) { return pipe + s * Cfg::STAGE_ELEMS + Cfg::A_ELEMS; };
  auto stage_b2 = [&](int s) {
    return pipe + s * Cfg::STAGE_ELEMS + Cfg::A_ELEMS + Cfg::B_ELEMS;
  };

  const int nk = (p.k + BK - 1) / BK;
  load_a<Cfg>(p, m0, 0, ra);
  load_b<Cfg>(p.b, p, n0, 0, rb);
  if constexpr (GATE) load_b<Cfg>(p.b2, p, n0, 0, rb2);
  store_a<Cfg>(p, m0, 0, ra, stage_a(0));
  store_b<Cfg>(rb, stage_b(0));
  if constexpr (GATE) store_b<Cfg>(rb2, stage_b2(0));
  __syncthreads();

  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt & 1;
    const bool more = kt + 1 < nk;
    if (more) {  // the next tile's global loads overlap this tile's products
      load_a<Cfg>(p, m0, (kt + 1) * BK, ra);
      load_b<Cfg>(p.b, p, n0, (kt + 1) * BK, rb);
      if constexpr (GATE) load_b<Cfg>(p.b2, p, n0, (kt + 1) * BK, rb2);
    }
    const __nv_bfloat16* as = stage_a(s);
    const __nv_bfloat16* bs = stage_b(s);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>
          fa[Cfg::FM];
#pragma unroll
      for (int i = 0; i < Cfg::FM; ++i)
        wmma::load_matrix_sync(fa[i], as + (wm * WM + i * 16) * Cfg::LDA + kk,
                               Cfg::LDA);
#pragma unroll
      for (int j = 0; j < Cfg::FN; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>
            fb;
        wmma::load_matrix_sync(fb, bs + kk * Cfg::LDB + wn * WN + j * 16,
                               Cfg::LDB);
#pragma unroll
        for (int i = 0; i < Cfg::FM; ++i) wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
        if constexpr (GATE) {
          wmma::load_matrix_sync(fb, stage_b2(s) + kk * Cfg::LDB + wn * WN + j * 16,
                                 Cfg::LDB);
#pragma unroll
          for (int i = 0; i < Cfg::FM; ++i)
            wmma::mma_sync(acc2[i][j], fa[i], fb, acc2[i][j]);
        }
      }
    }
    if (more) {
      store_a<Cfg>(p, m0, (kt + 1) * BK, ra, stage_a(s ^ 1));
      store_b<Cfg>(rb, stage_b(s ^ 1));
      if constexpr (GATE) store_b<Cfg>(rb2, stage_b2(s ^ 1));
    }
    __syncthreads();
  }

  // Stage the fp32 accumulators through shared memory (the pipeline buffers
  // are free: the loop ended on a barrier) and run the epilogue chain.
  float* cs = reinterpret_cast<float*>(smem);
  float* cs2 = cs + BM * Cfg::LDC;
#pragma unroll
  for (int i = 0; i < Cfg::FM; ++i)
#pragma unroll
    for (int j = 0; j < Cfg::FN; ++j) {
      const int off = (wm * WM + i * 16) * Cfg::LDC + wn * WN + j * 16;
      wmma::store_matrix_sync(cs + off, acc[i][j], Cfg::LDC, wmma::mem_row_major);
      if constexpr (GATE)
        wmma::store_matrix_sync(cs2 + off, acc2[i][j], Cfg::LDC, wmma::mem_row_major);
    }
  __syncthreads();

  const bool has_scale = p.flags & EP_SCALE;
  const bool has_bias = p.flags & EP_BIAS;
  const bool has_rope = p.flags & EP_ROPE;
  const bool has_res = p.flags & EP_RESIDUAL;
  const int half = p.head_dim / 2;
  for (int v = threadIdx.x; v < BM * BN / 8; v += Cfg::THREADS) {
    const int r = v / (BN / 8), c0 = (v % (BN / 8)) * 8;
    const int gm = m0 + r, gn0 = n0 + c0;
    if (gm >= p.m || gn0 >= p.n) continue;
    __align__(16) __nv_bfloat16 out[8];
    if (GATE && p.preact != nullptr) {
      __align__(16) __nv_bfloat16 pre[8], pre2[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        pre[e] = __float2bfloat16_rn(cs[r * Cfg::LDC + c0 + e]);
        pre2[e] = __float2bfloat16_rn(cs2[r * Cfg::LDC + c0 + e]);
      }
      const size_t off = (size_t)gm * p.n + gn0;
      *reinterpret_cast<uint4*>(p.preact + off) = *reinterpret_cast<const uint4*>(pre);
      *reinterpret_cast<uint4*>(p.preact2 + off) = *reinterpret_cast<const uint4*>(pre2);
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int c = c0 + e, gn = gn0 + e;
      float u = cs[r * Cfg::LDC + c];
      if (has_scale) u *= p.scale;
      if (has_bias) u += __bfloat162float(p.bias[gn]);
      if (has_rope) {
        // columns are whole heads: n0 and BN are multiples of head_dim
        const int j = c % p.head_dim;
        const int pc = j < half ? c + half : c - half;
        float w = cs[r * Cfg::LDC + pc];
        if (has_scale) w *= p.scale;
        if (has_bias) w += __bfloat162float(p.bias[n0 + pc]);
        const float rot = j < half ? -w : w;
        const size_t t = (size_t)gm * p.head_dim + j;
        u = u * p.cos[t] + rot * p.sin[t];
      }
      if (GATE) {
        float g2 = cs2[r * Cfg::LDC + c];
        if (has_scale) g2 *= p.scale;
        u = silu(u) * g2;
      }
      if (has_res) u += __bfloat162float(p.residual[(size_t)gm * p.n + gn]);
      out[e] = __float2bfloat16_rn(u);
    }
    *reinterpret_cast<uint4*>(p.c + (size_t)gm * p.n + gn0) =
        *reinterpret_cast<const uint4*>(out);
  }
}

template <int BM, int BN, int WM, int WN, bool GATE>
cudaError_t launch(const GemmArgs& p, cudaStream_t stream) {
  using Cfg = GemmConfig<BM, BN, WM, WN, GATE>;
  auto kernel = gemm_fused_kernel<BM, BN, WM, WN, GATE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  dim3 grid((p.n + BN - 1) / BN, (p.m + BM - 1) / BM);
  kernel<<<grid, Cfg::THREADS, Cfg::SMEM_BYTES, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The block width of the non-gated variant: a rope launch needs
// block_n % head_dim == 0, which the wrapper checks against this value.
int gemm_fused_block_n() { return 128; }

// rstd: (M,) fp32 the caller allocates; written when gamma != null.
// preact, preact2: (M, N) bf16 outputs of the gated variant, or null.
int gemm_fused_launch(const void* a, const void* b, const void* b2, void* c,
                      const void* gamma, void* rstd, const void* bias,
                      const void* residual, const void* sin, const void* cos,
                      void* preact, void* preact2, float scale, float eps,
                      int m, int n, int k, int flags, int head_dim,
                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  GemmArgs p;
  p.a = static_cast<const __nv_bfloat16*>(a);
  p.b = static_cast<const __nv_bfloat16*>(b);
  p.b2 = static_cast<const __nv_bfloat16*>(b2);
  p.c = static_cast<__nv_bfloat16*>(c);
  p.gamma = static_cast<const __nv_bfloat16*>(gamma);
  p.rstd = static_cast<const float*>(rstd);
  p.bias = static_cast<const __nv_bfloat16*>(bias);
  p.residual = static_cast<const __nv_bfloat16*>(residual);
  p.sin = static_cast<const float*>(sin);
  p.cos = static_cast<const float*>(cos);
  p.preact = static_cast<__nv_bfloat16*>(preact);
  p.preact2 = static_cast<__nv_bfloat16*>(preact2);
  if ((preact != nullptr) != ((flags & EP_GATE_SILU) && preact2 != nullptr))
    return cudaErrorInvalidValue;
  p.scale = scale;
  p.m = m;
  p.n = n;
  p.k = k;
  p.flags = flags;
  p.head_dim = head_dim;
  if (gamma != nullptr) {
    rms_stats_kernel<<<m, 256, 0, st>>>(p.a, static_cast<float*>(rstd), k, eps);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (flags & EP_GATE_SILU) return launch<128, 64, 32, 32, true>(p, st);
  return launch<128, 128, 64, 32, false>(p, st);
}

}  // extern "C"

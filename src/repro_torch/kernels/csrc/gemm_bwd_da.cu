// dA of the fused GEMM for Hopper: dA = prologue^T(E'^T(g) @ B^T [+ E'^T(g)_2 @ B2^T]).
//
// Replaces the TPU kernel `_da_kernel` (src/repro/kernels/gemm/backward.py),
// launched there by `_gemm_bwd_da`. Same chain:
//   g tiles   the forward epilogue transposed and applied to each g tile as it
//             goes to shared memory (gemm_bwd_g.cuh): silu' and the gate from
//             the forward's saved bf16 preacts, the rope adjoint (a rotation by
//             -theta), the scale; the result is rounded to bf16 for the tensor
//             cores, where the TPU kernel contracts it in fp32;
//   product   dAn = gbar @ B^T (+ gbar2 @ B2^T into the same fp32 accumulator):
//             the (K, N) weight tile is read as B^T in column-major order, so
//             no transposed copy of B is made;
//   norm      with the rmsnorm prologue, the TPU kernel pins its output block
//             to the full K and runs the norm transpose in the store. A full
//             row of 64 x 2048 fp32 is 512 KB, more than the 227 KB of shared
//             memory a block can use, so here the GEMM writes dAn in fp32 and a
//             row pass in this file applies the transpose with the full chain
//             rule (the statistics depend on A), from the forward's saved rstd:
//               ahat = a rstd, dahat = dAn gamma,
//               dA = rstd (dahat - ahat mean_k(dahat ahat)),
//             and writes one dgamma partial row per 32-row block (the caller
//             sums them, as the reference sums its partials with jnp).
//
// What bounds it on an H100: at the training shapes of llama-1b (M = 4096
// tokens, K = 2048 or 8192, N = 512 .. 2 x 8192) the products, 2 M N K
// operations on the tensor cores (989 TFLOP/s bf16), against a few tens of
// MB of g, preacts, B and dA over HBM (3.35 TB/s). This first version is the
// forward's simple design: WMMA 16x16x16 bf16 fragments, a 128 x 128 output
// block over 8 warps, a two-stage shared-memory ring filled through registers
// (the next tile's global loads are in flight while the current one is
// multiplied; the transposed epilogue runs on the register -> shared store).
// No wgmma, TMA or warp specialisation yet. Ragged M, N and K edges are
// masked (N and K must be multiples of 8).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "gemm_bwd_g.cuh"

using namespace nvcuda;
using namespace gbwd;

namespace {

constexpr int BM = 128;      // output rows (over M)
constexpr int BO = 128;      // output columns (over K)
constexpr int BC = 32;       // contraction depth (over N)
constexpr int WM = 64, WO = 32;
constexpr int WARPS_O = BO / WO;
constexpr int THREADS = 32 * (BM / WM) * WARPS_O;
constexpr int FM = WM / 16, FO = WO / 16;
constexpr int PAD = 8;
constexpr int LDG = BC + PAD;   // g tile (BM rows of M, BC cols of N), bf16
constexpr int LDB = BC + PAD;   // B tile (BO rows of K, BC cols of N), bf16
constexpr int LDC = BO + 4;     // staged fp32 output
constexpr int G_ELEMS = BM * LDG;
constexpr int B_ELEMS = BO * LDB;
constexpr int G_VECS = BM * BC / 8 / THREADS;
constexpr int B_VECS = BO * BC / 8 / THREADS;
static_assert(G_VECS * THREADS * 8 == BM * BC, "g tile / threads");
static_assert(B_VECS * THREADS * 8 == BO * BC, "B tile / threads");

template <int MODE>
struct DaSmem {
  static constexpr int STREAMS = MODE == G_GATE ? 2 : 1;
  static constexpr int STAGE = STREAMS * (G_ELEMS + B_ELEMS);
  static constexpr int PIPE_BYTES = 2 * STAGE * 2;
  static constexpr int C_BYTES = BM * LDC * 4;
  static constexpr int BYTES = PIPE_BYTES > C_BYTES ? PIPE_BYTES : C_BYTES;
};

struct DaArgs {
  GSrc gs;
  const __nv_bfloat16* b;    // (K, N)
  const __nv_bfloat16* b2;   // (K, N), gate only
  float* dan;                // (M, K) fp32 when the norm transpose follows
  __nv_bfloat16* da;         // (M, K) bf16 otherwise
  int k;
};

__device__ __forceinline__ uint4 load_b_vec(const __nv_bfloat16* b, int k,
                                            int n, int gk, int gn) {
  if (gk < k && gn < n) return ld16(b + (size_t)gk * n + gn);
  return make_uint4(0, 0, 0, 0);
}

template <int MODE>
__global__ void __launch_bounds__(THREADS) gemm_bwd_da_kernel(DaArgs p) {
  using S = DaSmem<MODE>;
  constexpr bool GATE = MODE == G_GATE;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* pipe = reinterpret_cast<__nv_bfloat16*>(smem);
  const int m0 = blockIdx.y * BM;
  const int o0 = blockIdx.x * BO;
  const int warp = threadIdx.x / 32;
  const int wm = warp / WARPS_O, wo = warp % WARPS_O;
  const int n = p.gs.n;

  auto g_s = [&](int s) { return pipe + s * S::STAGE; };
  auto b_s = [&](int s) { return pipe + s * S::STAGE + G_ELEMS; };
  auto g2_s = [&](int s) { return pipe + s * S::STAGE + G_ELEMS + B_ELEMS; };
  auto b2_s = [&](int s) {
    return pipe + s * S::STAGE + 2 * G_ELEMS + B_ELEMS;
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FO];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FO; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  GRaw rg[G_VECS];
  uint4 rb[B_VECS], rb2[GATE ? B_VECS : 1];

  auto load = [&](int nt) {
    const int n0 = nt * BC;
#pragma unroll
    for (int i = 0; i < G_VECS; ++i) {
      const int v = threadIdx.x + i * THREADS;
      g_load<MODE>(p.gs, m0 + v / (BC / 8), n0 + (v % (BC / 8)) * 8, rg[i]);
    }
#pragma unroll
    for (int i = 0; i < B_VECS; ++i) {
      const int v = threadIdx.x + i * THREADS;
      const int gk = o0 + v / (BC / 8), gn = n0 + (v % (BC / 8)) * 8;
      rb[i] = load_b_vec(p.b, p.k, n, gk, gn);
      if constexpr (GATE) rb2[i] = load_b_vec(p.b2, p.k, n, gk, gn);
    }
  };
  auto store = [&](int nt, int s) {
    const int n0 = nt * BC;
#pragma unroll
    for (int i = 0; i < G_VECS; ++i) {
      const int v = threadIdx.x + i * THREADS;
      const int r = v / (BC / 8), c = (v % (BC / 8)) * 8;
      float ga[8], ga2[8], gb[8];
      g_transform<MODE>(p.gs, m0 + r, n0 + c, rg[i], ga, ga2, gb);
      *reinterpret_cast<uint4*>(g_s(s) + r * LDG + c) = pack_bf16(ga);
      if constexpr (GATE)
        *reinterpret_cast<uint4*>(g2_s(s) + r * LDG + c) = pack_bf16(ga2);
    }
#pragma unroll
    for (int i = 0; i < B_VECS; ++i) {
      const int v = threadIdx.x + i * THREADS;
      const int r = v / (BC / 8), c = (v % (BC / 8)) * 8;
      *reinterpret_cast<uint4*>(b_s(s) + r * LDB + c) = rb[i];
      if constexpr (GATE)
        *reinterpret_cast<uint4*>(b2_s(s) + r * LDB + c) = rb2[i];
    }
  };

  const int nt_count = (n + BC - 1) / BC;
  load(0);
  store(0, 0);
  __syncthreads();
  for (int nt = 0; nt < nt_count; ++nt) {
    const int s = nt & 1;
    const bool more = nt + 1 < nt_count;
    if (more) load(nt + 1);
#pragma unroll
    for (int kk = 0; kk < BC; kk += 16) {
#pragma unroll
      for (int t = 0; t < (GATE ? 2 : 1); ++t) {
        const __nv_bfloat16* gs = t == 0 ? g_s(s) : g2_s(s);
        const __nv_bfloat16* bs = t == 0 ? b_s(s) : b2_s(s);
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fa[FM];
#pragma unroll
        for (int i = 0; i < FM; ++i)
          wmma::load_matrix_sync(fa[i], gs + (wm * WM + i * 16) * LDG + kk, LDG);
#pragma unroll
        for (int j = 0; j < FO; ++j) {
          // B^T (N x K) in column-major order is the (K, N) tile row-major
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::col_major> fb;
          wmma::load_matrix_sync(fb, bs + (wo * WO + j * 16) * LDB + kk, LDB);
#pragma unroll
          for (int i = 0; i < FM; ++i)
            wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
        }
      }
    }
    if (more) store(nt + 1, s ^ 1);
    __syncthreads();
  }

  float* cs = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FO; ++j)
      wmma::store_matrix_sync(cs + (wm * WM + i * 16) * LDC + wo * WO + j * 16,
                              acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();
  for (int v = threadIdx.x; v < BM * BO / 8; v += THREADS) {
    const int r = v / (BO / 8), c0 = (v % (BO / 8)) * 8;
    const int gm = m0 + r, gk0 = o0 + c0;
    if (gm >= p.gs.m || gk0 >= p.k) continue;
    const float* src = cs + r * LDC + c0;
    const size_t off = (size_t)gm * p.k + gk0;
    if (p.dan != nullptr) {
      float4* dst = reinterpret_cast<float4*>(p.dan + off);
      dst[0] = make_float4(src[0], src[1], src[2], src[3]);
      dst[1] = make_float4(src[4], src[5], src[6], src[7]);
    } else {
      float vals[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) vals[e] = src[e];
      *reinterpret_cast<uint4*>(p.da + off) = pack_bf16(vals);
    }
  }
}

// The rmsnorm transpose, one block of 256 threads per NR_ROWS rows: first each
// row's mean_k(dahat ahat) (a warp per row), then each thread walks its own
// columns down the block's rows, writing dA and summing its dgamma partial.
constexpr int NR_ROWS = 32;
constexpr int NR_THREADS = 256;

__global__ void __launch_bounds__(NR_THREADS)
rms_transpose_kernel(const float* __restrict__ dan,
                     const __nv_bfloat16* __restrict__ a,
                     const float* __restrict__ rstd,
                     const __nv_bfloat16* __restrict__ gamma,
                     __nv_bfloat16* __restrict__ da,
                     float* __restrict__ dgamma_part, int m, int k) {
  __shared__ float cterm[NR_ROWS];
  const int r0 = blockIdx.x * NR_ROWS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < NR_ROWS; r += NR_THREADS / 32) {
    const int gm = r0 + r;
    float sum = 0.f;
    if (gm < m) {
      for (int c = lane * 8; c < k; c += 32 * 8) {
        const size_t off = (size_t)gm * k + c;
        const float4 d0 = *reinterpret_cast<const float4*>(dan + off);
        const float4 d1 = *reinterpret_cast<const float4*>(dan + off + 4);
        const float dv[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
        const uint4 araw = ld16(a + off), graw = ld16(gamma + c);
        const __nv_bfloat16* av = reinterpret_cast<const __nv_bfloat16*>(&araw);
        const __nv_bfloat16* gv = reinterpret_cast<const __nv_bfloat16*>(&graw);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          sum += dv[e] * __bfloat162float(gv[e]) * __bfloat162float(av[e]);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) cterm[r] = gm < m ? sum * rstd[gm] / (float)k : 0.f;
  }
  __syncthreads();
  for (int c = threadIdx.x * 8; c < k; c += NR_THREADS * 8) {
    const uint4 graw = ld16(gamma + c);
    const __nv_bfloat16* gv = reinterpret_cast<const __nv_bfloat16*>(&graw);
    float g[8], dg[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      g[e] = __bfloat162float(gv[e]);
      dg[e] = 0.f;
    }
    for (int r = 0; r < NR_ROWS && r0 + r < m; ++r) {
      const int gm = r0 + r;
      const float rs = rstd[gm], ct = cterm[r];
      const size_t off = (size_t)gm * k + c;
      const float4 d0 = *reinterpret_cast<const float4*>(dan + off);
      const float4 d1 = *reinterpret_cast<const float4*>(dan + off + 4);
      const float dv[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
      const uint4 araw = ld16(a + off);
      const __nv_bfloat16* av = reinterpret_cast<const __nv_bfloat16*>(&araw);
      float out[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float ahat = __bfloat162float(av[e]) * rs;
        out[e] = rs * (dv[e] * g[e] - ahat * ct);
        dg[e] += dv[e] * ahat;
      }
      *reinterpret_cast<uint4*>(da + off) = pack_bf16(out);
    }
    float* part = dgamma_part + (size_t)blockIdx.x * k + c;
#pragma unroll
    for (int e = 0; e < 8; ++e) part[e] = dg[e];
  }
}

template <int MODE>
cudaError_t launch(const DaArgs& p, cudaStream_t stream) {
  auto kernel = gemm_bwd_da_kernel<MODE>;
  constexpr int bytes = DaSmem<MODE>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((p.k + BO - 1) / BO, (p.gs.m + BM - 1) / BM);
  kernel<<<grid, THREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// g, preact, preact2: (M, N) bf16 (preacts for the gated chain, else null);
// sin, cos: (M, head_dim) fp32 for rope, else null; b, b2: (K, N) bf16.
// Without gamma: da (M, K) bf16 is written directly. With gamma (the rmsnorm
// prologue): a (M, K) bf16 and the forward's rstd (M,) fp32 are read, dan is
// an (M, K) fp32 scratch, and da plus dgamma_part (ceil(M / 32), K) fp32 are
// written by the row pass. `scale` is 1 for a chain without a scale.
int gemm_bwd_da_launch(const void* g, const void* preact, const void* preact2,
                       const void* sin, const void* cos, const void* b,
                       const void* b2, const void* a, const void* gamma,
                       const void* rstd, void* dan, void* da,
                       void* dgamma_part, float scale, int m, int n, int k,
                       int flags, int head_dim, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  DaArgs p;
  p.gs.g = static_cast<const __nv_bfloat16*>(g);
  p.gs.preact = static_cast<const __nv_bfloat16*>(preact);
  p.gs.preact2 = static_cast<const __nv_bfloat16*>(preact2);
  p.gs.sin = static_cast<const float*>(sin);
  p.gs.cos = static_cast<const float*>(cos);
  p.gs.scale = scale;
  p.gs.m = m;
  p.gs.n = n;
  p.gs.head_dim = head_dim;
  p.b = static_cast<const __nv_bfloat16*>(b);
  p.b2 = static_cast<const __nv_bfloat16*>(b2);
  p.k = k;
  const bool norm = gamma != nullptr;
  p.dan = norm ? static_cast<float*>(dan) : nullptr;
  p.da = static_cast<__nv_bfloat16*>(da);
  cudaError_t err;
  if (flags & EP_GATE_SILU) {
    if (preact == nullptr || preact2 == nullptr || b2 == nullptr)
      return cudaErrorInvalidValue;
    err = launch<G_GATE>(p, st);
  } else if (flags & EP_ROPE) {
    if (sin == nullptr || cos == nullptr || head_dim % 16)
      return cudaErrorInvalidValue;
    err = launch<G_ROPE>(p, st);
  } else {
    err = launch<G_PLAIN>(p, st);
  }
  if (err != cudaSuccess || !norm) return err;
  rms_transpose_kernel<<<(m + NR_ROWS - 1) / NR_ROWS, NR_THREADS, 0, st>>>(
      static_cast<const float*>(dan), static_cast<const __nv_bfloat16*>(a),
      static_cast<const float*>(rstd),
      static_cast<const __nv_bfloat16*>(gamma), p.da,
      static_cast<float*>(dgamma_part), m, k);
  return cudaGetLastError();
}

}  // extern "C"

// dA of the fused GEMM for Hopper:
//   dAn = gbar @ B^T  (+ gbar2 @ B2^T into the same accumulator),
//   dA = prologue^T(dAn).
//
// Replaces the TPU kernel `_da_kernel` (src/repro/kernels/gemm/backward.py),
// launched there by `_gemm_bwd_da`. Same chain, split differently:
//   g side    the transposed epilogue is applied once per element by the
//             operand pass (gemm_bwd_g.cu), which writes gbar = [g_acc |
//             g_acc2] (M, N') in bf16; the TPU kernel applies it to each g
//             tile in the loop and contracts in fp32;
//   product   dAn = gbar @ B^T on the Hopper mainloop (gemm_sm90.cuh): X is
//             gbar, Y is B (K, N) as it lies (rows of N-contiguous weights are
//             the K-major operand), and for the gated chain a second segment
//             contracts gbar's second half against B2 into the same fp32
//             accumulator;
//   norm      with a norm prologue the TPU kernel pins its output block to
//             the full K and runs the norm transpose in the store. A full
//             row of 64 x 2048 fp32 is 512 KB, more than the 227 KB of shared
//             memory a block can use, so here the GEMM writes dAn in fp32 and
//             a row pass in this file applies the transpose with the full
//             chain rule (the statistics depend on A), from the forward's
//             saved statistics (the TPU kernel recomputes them from A):
//               rmsnorm    ahat = a rstd, dahat = dAn gamma,
//                          dA = rstd (dahat - ahat mean_k(dahat ahat));
//               layernorm  ahat = (a - mean) rstd, dahat = dAn gamma,
//                          dA = rstd (dahat - mean_k(dahat)
//                                     - ahat mean_k(dahat ahat)),
//             and writes one dgamma partial row (sum of dAn ahat) per 32-row
//             block, and for layernorm + beta one dbeta partial row (sum of
//             dAn); the caller sums them, as the reference sums its
//             partials with jnp. Layernorm's two row means are summed in
//             the same read of the row as rmsnorm's one.
//
// What bounds it on an H100: operations. At the training shapes of llama-1b
// (M = 4096 tokens, K = 2048 or 8192, N = 512 .. 2 x 8192) the product is
// 2 M N K operations on the tensor cores (989 TFLOP/s bf16) against a few
// tens of MB of gbar, B and dA over HBM (3.35 TB/s); the mainloop keeps the
// tensor cores fed from a TMA ring (wgmma, warp specialisation, persistent
// blocks). The row pass is bound by bytes (dAn, A and dA once: at bert's
// M 4096, K 768 that is 25 MB, 7.5 us). Ragged M and
// K edges are zero-filled by the TMA and masked in the store (N and K must
// be multiples of 8).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_sm90.cuh"

namespace {

template <int BN, bool F32>
__global__ void __launch_bounds__(sm90::THREADS, 1)
gemm_bwd_da_kernel(const __grid_constant__ sm90::Params p) {
  sm90::gemm_body<BN, F32>(p);
}

template <bool F32>
cudaError_t gemm(const sm90::Operand* x, const sm90::Operand* y, int segments,
                 const sm90::Params& p, int tile_n, cudaStream_t stream) {
  const int sms = sm90::sm_count();
  switch (tile_n) {
    case 256:
      return sm90::launch<256>(gemm_bwd_da_kernel<256, F32>, x, y, segments,
                               p, sms, stream);
    case 128:
      return sm90::launch<128>(gemm_bwd_da_kernel<128, F32>, x, y, segments,
                               p, sms, stream);
    case 64:
      return sm90::launch<64>(gemm_bwd_da_kernel<64, F32>, x, y, segments, p,
                              sms, stream);
  }
  return cudaErrorInvalidValue;
}

__device__ __forceinline__ uint4 ld16(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ uint4 pack_bf16(const float (&v)[8]) {
  __align__(16) __nv_bfloat16 out[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) out[e] = __float2bfloat16_rn(v[e]);
  return *reinterpret_cast<const uint4*>(out);
}

// The norm transpose, one block of 256 threads per NR_ROWS rows: first each
// row's means (a warp per row): mean_k(dahat ahat), and for layernorm
// mean_k(dahat) in the same loop; then each thread walks its own columns
// down the block's rows, writing dA and summing its dgamma (and dbeta)
// partial. LN: layernorm (mean read, the centred row), else rmsnorm.
constexpr int NR_ROWS = 32;
constexpr int NR_THREADS = 256;

template <bool LN>
__global__ void __launch_bounds__(NR_THREADS)
norm_transpose_kernel(const float* __restrict__ dan,
                      const __nv_bfloat16* __restrict__ a,
                      const float* __restrict__ mean,
                      const float* __restrict__ rstd,
                      const __nv_bfloat16* __restrict__ gamma,
                      __nv_bfloat16* __restrict__ da,
                      float* __restrict__ dgamma_part,
                      float* __restrict__ dbeta_part, int m, int k) {
  __shared__ float cterm[NR_ROWS], mterm[NR_ROWS];
  const int r0 = blockIdx.x * NR_ROWS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < NR_ROWS; r += NR_THREADS / 32) {
    const int gm = r0 + r;
    const float mu = LN && gm < m ? mean[gm] : 0.f;
    float sum = 0.f, sum_d = 0.f;
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
        for (int e = 0; e < 8; ++e) {
          if constexpr (LN) {
            const float dh = dv[e] * __bfloat162float(gv[e]);
            sum += dh * (__bfloat162float(av[e]) - mu);
            sum_d += dh;
          } else {
            sum += dv[e] * __bfloat162float(gv[e]) * __bfloat162float(av[e]);
          }
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if constexpr (LN) sum_d += __shfl_xor_sync(0xffffffffu, sum_d, off);
    }
    if (lane == 0) {
      cterm[r] = gm < m ? sum * rstd[gm] / (float)k : 0.f;
      mterm[r] = sum_d / (float)k;
    }
  }
  __syncthreads();
  for (int c = threadIdx.x * 8; c < k; c += NR_THREADS * 8) {
    const uint4 graw = ld16(gamma + c);
    const __nv_bfloat16* gv = reinterpret_cast<const __nv_bfloat16*>(&graw);
    float g[8], dg[8], db[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      g[e] = __bfloat162float(gv[e]);
      dg[e] = db[e] = 0.f;
    }
    for (int r = 0; r < NR_ROWS && r0 + r < m; ++r) {
      const int gm = r0 + r;
      const float rs = rstd[gm], ct = cterm[r];
      const float mu = LN ? mean[gm] : 0.f, mt = mterm[r];
      const size_t off = (size_t)gm * k + c;
      const float4 d0 = *reinterpret_cast<const float4*>(dan + off);
      const float4 d1 = *reinterpret_cast<const float4*>(dan + off + 4);
      const float dv[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
      const uint4 araw = ld16(a + off);
      const __nv_bfloat16* av = reinterpret_cast<const __nv_bfloat16*>(&araw);
      float out[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        if constexpr (LN) {
          const float ahat = (__bfloat162float(av[e]) - mu) * rs;
          out[e] = rs * (dv[e] * g[e] - mt - ahat * ct);
          dg[e] += dv[e] * ahat;
          db[e] += dv[e];
        } else {
          const float ahat = __bfloat162float(av[e]) * rs;
          out[e] = rs * (dv[e] * g[e] - ahat * ct);
          dg[e] += dv[e] * ahat;
        }
      }
      *reinterpret_cast<uint4*>(da + off) = pack_bf16(out);
    }
    float* part = dgamma_part + (size_t)blockIdx.x * k + c;
#pragma unroll
    for (int e = 0; e < 8; ++e) part[e] = dg[e];
    if (dbeta_part != nullptr) {
      float* bpart = dbeta_part + (size_t)blockIdx.x * k + c;
#pragma unroll
      for (int e = 0; e < 8; ++e) bpart[e] = db[e];
    }
  }
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// gbar: (M, N') bf16 from the operand pass, N' = 2N when b2 is given (the
// gated chain), else N; b, b2: (K, N) bf16. Without gamma: da (M, K) bf16 is
// written by the GEMM. With gamma (a norm prologue): a (M, K) bf16 and the
// forward's rstd (M,) fp32 are read, with its mean (M,) fp32 for layernorm
// (rmsnorm when null); dan is an (M, K) fp32 scratch, and da plus
// dgamma_part (ceil(M / 32), K) fp32 are written by the row pass, and
// dbeta_part of the same shape when it is not null (layernorm + beta).
// tile_n: the mainloop's tile width, 64, 128 or 256; window: the walk's tile
// rows a group (>= 1). passes: bit 0 runs the GEMM, bit 1 the row pass (3
// for both).
int gemm_bwd_da_launch(const void* gbar, const void* b, const void* b2,
                       const void* a, const void* gamma, const void* mean,
                       const void* rstd, void* dan, void* da,
                       void* dgamma_part, void* dbeta_part, int m, int n,
                       int k, int tile_n, int window, int passes,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool norm = gamma != nullptr;
  if ((norm && (a == nullptr || rstd == nullptr || dan == nullptr ||
                dgamma_part == nullptr)) ||
      (!norm && (mean != nullptr || dbeta_part != nullptr)) ||
      (dbeta_part != nullptr && mean == nullptr))
    return cudaErrorInvalidValue;
  const int segments = b2 != nullptr ? 2 : 1;
  const int ld = segments * n;
  const sm90::Operand x[2] = {
      {gbar, m, n, ld},
      {static_cast<const __nv_bfloat16*>(gbar) + n, m, n, ld}};
  const sm90::Operand y[2] = {{b, k, n, n}, {b2, k, n, n}};
  sm90::Params p{};
  p.group_m = window;
  p.m = m;
  p.n = k;
  p.c = norm ? dan : da;
  p.ldc = k;
  p.n_split = k;
  cudaError_t err = cudaSuccess;
  if (passes & 1) {
    err = norm ? gemm<true>(x, y, segments, p, tile_n, st)
               : gemm<false>(x, y, segments, p, tile_n, st);
    if (err != cudaSuccess) return err;
  }
  if (norm && (passes & 2)) {
    const auto* dn = static_cast<const float*>(dan);
    const auto* av = static_cast<const __nv_bfloat16*>(a);
    const auto* mu = static_cast<const float*>(mean);
    const auto* rs = static_cast<const float*>(rstd);
    const auto* gm = static_cast<const __nv_bfloat16*>(gamma);
    auto* out = static_cast<__nv_bfloat16*>(da);
    auto* dg = static_cast<float*>(dgamma_part);
    auto* dbt = static_cast<float*>(dbeta_part);
    const int blocks = (m + NR_ROWS - 1) / NR_ROWS;
    if (mean != nullptr)
      norm_transpose_kernel<true><<<blocks, NR_THREADS, 0, st>>>(
          dn, av, mu, rs, gm, out, dg, dbt, m, k);
    else
      norm_transpose_kernel<false><<<blocks, NR_THREADS, 0, st>>>(
          dn, av, mu, rs, gm, out, dg, dbt, m, k);
    err = cudaGetLastError();
  }
  return err;
}

}  // extern "C"

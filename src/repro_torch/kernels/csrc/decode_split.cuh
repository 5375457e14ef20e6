// The per-split body of the split-KV decode kernels, shared by
// flash_decode.cu (contiguous ring cache) and flash_decode_paged.cu (paged
// pool), so both compute a split's partial with the same arithmetic: the
// paged kernel at page_size == 64 and one query token gives results bitwise
// equal to flash_decode over the gathered pages.
//
// A split is `bkv` K/V rows staged into shared memory as fp32 and `rows` q
// rows (fp32, also in shared memory). The body computes the scaled (and
// soft-capped) scores, masks them with `valid(r, j)`, and writes the
// split's unnormalised partial: o[r] = sum_j p[r, j] v[j], m[r] = max_j s,
// l[r] = sum_j p[r, j], with p = exp(s - m) on valid entries and 0
// elsewhere. A row with no valid entry gives (0, -1e30, 0), which the
// log-sum-exp combine weights to zero. Everything stays fp32, as in the
// reference's _split_partials (src/repro/kernels/attention/
// kernel_decode.py:64-74).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace decode_split {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr float MASK_VALUE = -1e30f;

// Shared-memory floats of one split: q (rows, D), K (bkv, D + 1) padded
// against bank conflicts, V (bkv, D) and the scores (rows, bkv).
template <int D>
__host__ __device__ constexpr size_t smem_floats(int rows, int bkv) {
  return (size_t)rows * D + (size_t)bkv * (D + 1) + (size_t)bkv * D +
         (size_t)rows * bkv;
}

// Stage `rows` q rows of D bf16 values into fp32 shared memory, 16 bytes
// per thread per step.
template <int D>
__device__ __forceinline__ void stage_q(float* qs, const __nv_bfloat16* q,
                                        int rows) {
  constexpr int VPR = D / 8;
  for (int t = threadIdx.x; t < rows * VPR; t += THREADS) {
    const int r = t / VPR, c = (t % VPR) * 8;
    uint4 raw = *reinterpret_cast<const uint4*>(q + (size_t)r * D + c);
    const __nv_bfloat16* x = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int e = 0; e < 8; ++e) qs[r * D + c + e] = __bfloat162float(x[e]);
  }
}

// Stage the split's K and V rows (K padded to D + 1 floats a row) in one
// loop, so each thread keeps a K and a V load in flight; rows at or past
// `n_valid` are zero-filled without being read.
template <int D>
__device__ __forceinline__ void stage_kv(float* ks, float* vs,
                                         const __nv_bfloat16* k,
                                         const __nv_bfloat16* v, int bkv,
                                         int n_valid) {
  constexpr int VPR = D / 8;
  for (int t = threadIdx.x; t < bkv * VPR; t += THREADS) {
    const int r = t / VPR, c = (t % VPR) * 8;
    uint4 kr = make_uint4(0, 0, 0, 0), vr = make_uint4(0, 0, 0, 0);
    if (r < n_valid) {
      kr = *reinterpret_cast<const uint4*>(k + (size_t)r * D + c);
      vr = *reinterpret_cast<const uint4*>(v + (size_t)r * D + c);
    }
    const __nv_bfloat16* kx = reinterpret_cast<const __nv_bfloat16*>(&kr);
    const __nv_bfloat16* vx = reinterpret_cast<const __nv_bfloat16*>(&vr);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      ks[r * (D + 1) + c + e] = __bfloat162float(kx[e]);
      vs[r * D + c + e] = __bfloat162float(vx[e]);
    }
  }
}

// The split's partial from staged q, K and V (the caller syncs after
// staging). o: (rows, D), m and l: (rows,), each written at row r.
template <int D, class Valid>
__device__ __forceinline__ void partials(const float* qs, const float* ks,
                                         const float* vs, float* ss, int rows,
                                         int bkv, float scale, float softcap,
                                         Valid valid, float* o, float* m,
                                         float* l) {
  for (int t = threadIdx.x; t < rows * bkv; t += THREADS) {
    const int r = t / bkv, j = t % bkv;
    float s = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) s += qs[r * D + d] * ks[j * (D + 1) + d];
    s *= scale;
    if (softcap > 0.f) s = softcap * tanhf(s / softcap);
    ss[r * bkv + j] = valid(r, j) ? s : MASK_VALUE;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < rows; r += WARPS) {
    float mx = MASK_VALUE;
    for (int j = lane; j < bkv; j += 32) mx = fmaxf(mx, ss[r * bkv + j]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
    for (int j = lane; j < bkv; j += 32) {
      const float pv = valid(r, j) ? expf(ss[r * bkv + j] - mx) : 0.f;
      ss[r * bkv + j] = pv;
      sum += pv;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    __syncwarp();
    for (int d = lane; d < D; d += 32) {
      float acc = 0.f;
      for (int j = 0; j < bkv; ++j) acc += ss[r * bkv + j] * vs[j * D + d];
      o[(size_t)r * D + d] = acc;
    }
    if (lane == 0) {
      m[r] = mx;
      l[r] = sum;
    }
  }
}

// A split that no row can see: (0, -1e30, 0) without loading K/V. Equal to
// what partials() computes for a fully masked split.
template <int D>
__device__ __forceinline__ void empty_partials(int rows, float* o, float* m,
                                               float* l) {
  for (int t = threadIdx.x; t < rows * D; t += THREADS) o[t] = 0.f;
  for (int r = threadIdx.x; r < rows; r += THREADS) {
    m[r] = MASK_VALUE;
    l[r] = 0.f;
  }
}

}  // namespace decode_split

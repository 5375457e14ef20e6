// The transposed GEMM epilogue, applied to each tile of the cotangent g as it
// goes from registers to shared memory: the part shared by the two backward
// GEMM kernels (gemm_bwd_da.cu, gemm_bwd_db.cu).
//
// The forward chain is  acc -> x scale -> + bias -> rope -> silu(.) * acc2
// -> + residual  (csrc/gemm_fused.cu). Walked backwards on g, per element,
// as Epilogue._transpose_core (kernels/gemm/epilogue.py) does:
//   G_PLAIN  g_acc = g * scale                       g_bias = g
//   G_ROPE   du = rotation of g by -theta (the partner column c +- hd/2 is
//            read from global memory beside the element's own vector)
//            g_acc = du * scale                      g_bias = du
//   G_GATE   u = preact * scale, v2 = preact2 * scale (the forward's saved
//            raw accumulators, bf16), s = sigmoid(u)
//            g_acc  = s (1 + u (1 - s)) * g * v2 * scale
//            g_acc2 = u s * g * scale
// The residual add transposes to the identity (its cotangent is g itself,
// outside these kernels). g_acc and g_acc2 are rounded to bf16 for the tensor
// cores; g_bias stays fp32 for the dbias column sum.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace gbwd {

enum : int {
  EP_SCALE = 1,
  EP_BIAS = 2,
  EP_ROPE = 4,
  EP_GATE_SILU = 8,
  EP_RESIDUAL = 16,
};

enum : int { G_PLAIN = 0, G_ROPE = 1, G_GATE = 2 };

struct GSrc {
  const __nv_bfloat16* g;        // (M, N) cotangent of the forward output
  const __nv_bfloat16* preact;   // (M, N) saved raw accumulator (gate)
  const __nv_bfloat16* preact2;  // (M, N) saved raw accumulator 2 (gate)
  const float* sin;              // (M, head_dim) duplicated-halves (rope)
  const float* cos;
  float scale;                   // 1 when the chain has no scale
  int m, n, head_dim;
};

// The raw 16-byte vectors one 8-column piece of g needs: g itself, and the
// rope partner vector or the two saved preacts.
struct GRaw {
  uint4 g, x, y;
};

__device__ __forceinline__ uint4 ld16(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint4*>(p);
}

template <int MODE>
__device__ __forceinline__ void g_load(const GSrc& s, int gm, int gn,
                                       GRaw& raw) {
  const uint4 zero = make_uint4(0, 0, 0, 0);
  raw.g = raw.x = raw.y = zero;
  if (gm >= s.m || gn >= s.n) return;
  const size_t off = (size_t)gm * s.n + gn;
  raw.g = ld16(s.g + off);
  if (MODE == G_ROPE) {
    // a vector of 8 lies within one half of a head (head_dim % 16 == 0)
    const int half = s.head_dim / 2;
    raw.x = ld16(s.g + off + ((gn % s.head_dim) < half ? half : -half));
  } else if (MODE == G_GATE) {
    raw.x = ld16(s.preact + off);
    raw.y = ld16(s.preact2 + off);
  }
}

// g_acc (and g_acc2, g_bias) of the 8 elements at (gm, gn .. gn + 7), fp32.
// Elements outside the (M, N) array give zeros.
template <int MODE>
__device__ __forceinline__ void g_transform(const GSrc& s, int gm, int gn,
                                            const GRaw& raw, float (&gacc)[8],
                                            float (&gacc2)[8],
                                            float (&gbias)[8]) {
  const __nv_bfloat16* gv = reinterpret_cast<const __nv_bfloat16*>(&raw.g);
  const __nv_bfloat16* xv = reinterpret_cast<const __nv_bfloat16*>(&raw.x);
  const __nv_bfloat16* yv = reinterpret_cast<const __nv_bfloat16*>(&raw.y);
  const bool in = gm < s.m && gn < s.n;
  if (MODE == G_ROPE) {
    const int half = s.head_dim / 2;
    const int j0 = gn % s.head_dim;
    const float sign = j0 < half ? 1.f : -1.f;
    const size_t t = (size_t)gm * s.head_dim + j0;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      float du = 0.f;
      if (in)
        du = __bfloat162float(gv[e]) * s.cos[t + e] +
             sign * __bfloat162float(xv[e]) * s.sin[t + e];
      gbias[e] = du;
      gacc[e] = du * s.scale;
      gacc2[e] = 0.f;
    }
  } else if (MODE == G_GATE) {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float gy = __bfloat162float(gv[e]);
      const float u = __bfloat162float(xv[e]) * s.scale;
      const float v2 = __bfloat162float(yv[e]) * s.scale;
      const float sg = 1.0f / (1.0f + expf(-u));
      const float du = sg * (1.0f + u * (1.0f - sg)) * (gy * v2);
      const float dv2 = u * sg * gy;
      gacc[e] = du * s.scale;
      gacc2[e] = dv2 * s.scale;
      gbias[e] = 0.f;
    }
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float gy = __bfloat162float(gv[e]);
      gbias[e] = gy;
      gacc[e] = gy * s.scale;
      gacc2[e] = 0.f;
    }
  }
}

__device__ __forceinline__ uint4 pack_bf16(const float (&v)[8]) {
  __align__(16) __nv_bfloat16 out[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) out[e] = __float2bfloat16_rn(v[e]);
  return *reinterpret_cast<const uint4*>(out);
}

}  // namespace gbwd

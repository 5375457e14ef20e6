// The operand pass of the fused GEMM's backward: the chain's elementwise work
// done once per element, ahead of the two products (gemm_bwd_da.cu,
// gemm_bwd_db.cu), which then run on the Hopper mainloop (gemm_sm90.cuh).
//
// Replaces the TPU kernel's operand side of `_da_kernel` and `_db_kernel`
// (src/repro/kernels/gemm/backward.py): the transposed epilogue that both
// run on each g tile as it loads (`epilogue.transpose_tile`), and the norm
// that `_db_kernel` recomputes on each A tile. On the TPU the grid walks the
// tiles in order and each tile is transformed once per output block; on an
// H100 the same recomputation is 16-128 times the work of the pass itself,
// so it is done here once and written out.
//
// The forward chain is  acc -> x scale -> + bias -> rope -> act(.) [* acc2]
// -> + residual  (csrc/gemm_fused.cu), act one of silu, gelu (the tanh form)
// and relu, its code in bits 5-6 of the flags (read here: each code is a
// template instantiation, as in the forward). Walked backwards on g, per
// element, as Epilogue._transpose_core (kernels/gemm/epilogue.py) does:
//   G_PLAIN  g_acc = g * scale                       g_bias = g
//   G_ROPE   du = rotation of g by -theta (the partner column c +- hd/2 of
//            the same head)
//            g_acc = du * scale                      g_bias = du
//   G_ACT    u = preact * scale + bias (the forward's saved raw accumulator,
//            bf16), du = act'(u) g
//            g_acc = du * scale                      g_bias = du
//   G_GATE   u = preact * scale, v2 = preact2 * scale (both saved)
//            g_acc  = act'(u) (g v2) * scale
//            g_acc2 = act(u) g * scale
// with silu'(u) = s (1 + u (1 - s)), s = sigmoid(u); gelu'(u) = 0.5 (1 + t)
// + 0.5 u (1 - t^2) c (1 + 3 0.044715 u^2), t = tanh(c (u + 0.044715 u^3)),
// c = sqrt(2 / pi) (epilogue._act_grad); relu'(u) = [u > 0].
// The residual add transposes to the identity (its cotangent is g itself).
//
// Outputs (M rows of g, N columns; N' = 2N for the gated chain, else N;
// ld_t = M rounded up to 8, so every row starts 16-byte aligned for TMA):
//   gbar      (M, N')   bf16  g_acc | g_acc2 side by side   (dA's X)
//   gbar_t    (N', ld_t) bf16  its transpose                 (dB's Y)
//   a_t       (K, ld_t) bf16  A transposed; with a norm prologue the
//                              forward's An first, bit for bit: rmsnorm
//                              bf16((a rstd) gamma), layernorm
//                              bf16(((a - mean) rstd) gamma [+ beta]) from
//                              the forward's saved statistics  (dB's X)
//   dbias_part (ceil(M / 64), N) fp32, bias chains: g_bias summed over each
//                              64-row block in row order; the caller sums.
//
// What bounds it on an H100: bytes. Per element of g it does a few tens of
// operations (an exponential or a tanh for an activation); it reads g, the
// preacts, the rope tables and A once and writes each output once. Each
// 256-thread block takes a 64 x 64 tile: 16-byte loads and stores along
// rows, the transpose staged in shared memory with its 8-element chunks
// XOR-swizzled by column group, so both the scattered 2-byte writes and the
// 16-byte row reads are free of bank conflicts. N and K must be multiples
// of 8.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// gemm_fused.cu's flags, and the activation's code in bits EP_ACT_SHIFT..
// (kernels/gemm/ops.py chain_flags)
enum : int {
  EP_SCALE = 1,
  EP_BIAS = 2,
  EP_ROPE = 4,
  EP_GATE = 8,
  EP_RESIDUAL = 16,
  EP_ACT_SHIFT = 5,
  EP_ACT_MASK = 3 << EP_ACT_SHIFT,
};

enum : int { ACT_NONE = 0, ACT_SILU = 1, ACT_GELU = 2, ACT_RELU = 3 };

enum : int { G_PLAIN = 0, G_ROPE = 1, G_ACT = 2, G_GATE = 3 };

constexpr int TR = 64;         // rows of M per block (and per dbias partial)
constexpr int TC = 64;         // columns per block
constexpr int THREADS = 256;
constexpr int VECS = TR * TC / 8 / THREADS;   // 8-element vectors a thread
static_assert(VECS * THREADS * 8 == TR * TC, "tile / threads");

struct GSrc {
  const __nv_bfloat16* g;        // (M, N) cotangent of the forward output
  const __nv_bfloat16* preact;   // (M, N) saved raw accumulator (act)
  const __nv_bfloat16* preact2;  // (M, N) saved raw accumulator 2 (gate)
  const float* sin;              // (M, head_dim) duplicated-halves (rope)
  const float* cos;
  const __nv_bfloat16* bias;     // (N,), read by G_ACT (in act's input)
  float scale;                   // 1 when the chain has no scale
  int m, n, head_dim;
};

__device__ __forceinline__ uint4 ld16(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ uint4 pack_bf16(const float (&v)[8]) {
  __align__(16) __nv_bfloat16 out[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) out[e] = __float2bfloat16_rn(v[e]);
  return *reinterpret_cast<const uint4*>(out);
}

__device__ __forceinline__ void unpack8(const float4& lo, const float4& hi,
                                        float (&v)[8]) {
  v[0] = lo.x, v[1] = lo.y, v[2] = lo.z, v[3] = lo.w;
  v[4] = hi.x, v[5] = hi.y, v[6] = hi.z, v[7] = hi.w;
}

// tanh(c (x + 0.044715 x^3)), c = sqrt(2 / pi), with the full tanhf as in
// the forward's gelu
__device__ __forceinline__ float gelu_tanh(float x) {
  const float c = 0.7978845608028654f;
  return tanhf(c * (x + 0.044715f * (x * x * x)));
}

// act(x) of code ACT (the forward's)
template <int ACT>
__device__ __forceinline__ float act_value(float x) {
  if constexpr (ACT == ACT_SILU) return x / (1.0f + expf(-x));
  if constexpr (ACT == ACT_GELU) return x * (0.5f * (1.0f + gelu_tanh(x)));
  return fmaxf(x, 0.0f);
}

// act'(x) of code ACT
template <int ACT>
__device__ __forceinline__ float act_slope(float x) {
  if constexpr (ACT == ACT_SILU) {
    const float sg = 1.0f / (1.0f + expf(-x));
    return sg * (1.0f + x * (1.0f - sg));
  }
  if constexpr (ACT == ACT_GELU) {
    const float c = 0.7978845608028654f;
    const float t = gelu_tanh(x);
    return 0.5f * (1.0f + t) +
           0.5f * x * (1.0f - t * t) * c * (1.0f + 3.0f * 0.044715f * x * x);
  }
  return x > 0.0f ? 1.0f : 0.0f;
}

// g_acc, g_acc2 and g_bias of the 8 elements at (gm, gn .. gn + 7) in fp32;
// zeros outside the (M, N) array.
template <int MODE, int ACT>
__device__ __forceinline__ void g_transform(const GSrc& s, int gm, int gn,
                                            float (&gacc)[8],
                                            float (&gacc2)[8],
                                            float (&gbias)[8]) {
#pragma unroll
  for (int e = 0; e < 8; ++e) gacc[e] = gacc2[e] = gbias[e] = 0.f;
  if (gm >= s.m || gn >= s.n) return;
  const size_t off = (size_t)gm * s.n + gn;
  const uint4 graw = ld16(s.g + off);
  const __nv_bfloat16* gv = reinterpret_cast<const __nv_bfloat16*>(&graw);
  if constexpr (MODE == G_ROPE) {
    // a vector of 8 lies within one half of a head (head_dim % 16 == 0)
    const int half = s.head_dim / 2;
    const int j0 = gn % s.head_dim;
    const bool low = j0 < half;
    const uint4 xraw = ld16(s.g + off + (low ? half : -half));
    const __nv_bfloat16* xv = reinterpret_cast<const __nv_bfloat16*>(&xraw);
    const float sign = low ? 1.f : -1.f;
    const size_t t = (size_t)gm * s.head_dim + j0;
    const float4* sp = reinterpret_cast<const float4*>(s.sin + t);
    const float4* cp = reinterpret_cast<const float4*>(s.cos + t);
    float sn[8], cs[8];
    unpack8(sp[0], sp[1], sn);
    unpack8(cp[0], cp[1], cs);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float du = __bfloat162float(gv[e]) * cs[e] +
                       sign * __bfloat162float(xv[e]) * sn[e];
      gbias[e] = du;
      gacc[e] = du * s.scale;
    }
  } else if constexpr (MODE == G_ACT) {
    const uint4 xraw = ld16(s.preact + off);
    const __nv_bfloat16* xv = reinterpret_cast<const __nv_bfloat16*>(&xraw);
    uint4 braw = make_uint4(0, 0, 0, 0);
    if (s.bias != nullptr) braw = ld16(s.bias + gn);
    const __nv_bfloat16* bv = reinterpret_cast<const __nv_bfloat16*>(&braw);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float u =
          __bfloat162float(xv[e]) * s.scale + __bfloat162float(bv[e]);
      const float du = act_slope<ACT>(u) * __bfloat162float(gv[e]);
      gbias[e] = du;
      gacc[e] = du * s.scale;
    }
  } else if constexpr (MODE == G_GATE) {
    const uint4 xraw = ld16(s.preact + off), yraw = ld16(s.preact2 + off);
    const __nv_bfloat16* xv = reinterpret_cast<const __nv_bfloat16*>(&xraw);
    const __nv_bfloat16* yv = reinterpret_cast<const __nv_bfloat16*>(&yraw);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float gy = __bfloat162float(gv[e]);
      const float u = __bfloat162float(xv[e]) * s.scale;
      const float v2 = __bfloat162float(yv[e]) * s.scale;
      float du, dv2;
      if constexpr (ACT == ACT_SILU) {   // sigmoid shared by act and act'
        const float sg = 1.0f / (1.0f + expf(-u));
        du = sg * (1.0f + u * (1.0f - sg)) * (gy * v2);
        dv2 = u * sg * gy;
      } else {
        du = act_slope<ACT>(u) * (gy * v2);
        dv2 = act_value<ACT>(u) * gy;
      }
      gacc[e] = du * s.scale;
      gacc2[e] = dv2 * s.scale;
    }
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float gy = __bfloat162float(gv[e]);
      gbias[e] = gy;
      gacc[e] = gy * s.scale;
    }
  }
}

// Position of element (r, c) of a TR x TC tile in its transposed staging:
// row c of the transpose, its 8-element chunk r / 8 swizzled by c / 8.
__device__ __forceinline__ int tpos(int r, int c) {
  return c * TR + (((r >> 3) ^ (c >> 3)) << 3) + (r & 7);
}

// Rows [row0, row0 + TC) of a transposed output (ld_t elements a row) from
// `count` staged tiles; tile s lands at rows s * rows_per + row0 + c.
__device__ __forceinline__ void store_transposed(
    const __nv_bfloat16* tiles, int count, __nv_bfloat16* out, int rows_per,
    int row0, int m0, int ld_t) {
  for (int v = threadIdx.x; v < count * TC * (TR / 8); v += THREADS) {
    const int s = v / (TC * (TR / 8)), w = v % (TC * (TR / 8));
    const int c = w / (TR / 8), q = w % (TR / 8);
    const int row = row0 + c, col = m0 + ((q ^ (c >> 3)) << 3);
    // a chunk past M lands in the row's padding (ld_t is M rounded to 8),
    // which no reader looks at
    if (row < rows_per && col < ld_t)
      *reinterpret_cast<uint4*>(out + (size_t)(s * rows_per + row) * ld_t +
                                col) =
          *reinterpret_cast<const uint4*>(tiles + s * TR * TC + c * TR + q * 8);
  }
}

template <int MODE, int ACT, bool BIAS>
__global__ void __launch_bounds__(THREADS)
gemm_bwd_g_kernel(GSrc s, __nv_bfloat16* __restrict__ gbar,
                  __nv_bfloat16* __restrict__ gbar_t,
                  float* __restrict__ dbias_part, int ld_t) {
  constexpr bool GATE = MODE == G_GATE;
  constexpr int STREAMS = GATE ? 2 : 1;
  __shared__ __align__(16) __nv_bfloat16 tiles[STREAMS * TR * TC];
  __shared__ float colsum[BIAS ? TR : 1][BIAS ? TC : 1];
  const int m0 = blockIdx.y * TR, n0 = blockIdx.x * TC;
  const int n2 = STREAMS * s.n;
#pragma unroll
  for (int i = 0; i < VECS; ++i) {
    const int v = threadIdx.x + i * THREADS;
    const int r = v / (TC / 8), c = (v % (TC / 8)) * 8;
    const int gm = m0 + r, gn = n0 + c;
    float ga[8], ga2[8], gb[8];
    g_transform<MODE, ACT>(s, gm, gn, ga, ga2, gb);
    if (gm < s.m && gn < s.n) {
      const size_t off = (size_t)gm * n2 + gn;
      *reinterpret_cast<uint4*>(gbar + off) = pack_bf16(ga);
      if constexpr (GATE)
        *reinterpret_cast<uint4*>(gbar + off + s.n) = pack_bf16(ga2);
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      tiles[tpos(r, c + e)] = __float2bfloat16_rn(ga[e]);
      if constexpr (GATE)
        tiles[TR * TC + tpos(r, c + e)] = __float2bfloat16_rn(ga2[e]);
      if constexpr (BIAS) colsum[r][c + e] = gb[e];
    }
  }
  __syncthreads();
  store_transposed(tiles, STREAMS, gbar_t, s.n, n0, m0, ld_t);
  if constexpr (BIAS) {
    for (int c = threadIdx.x; c < TC; c += THREADS) {
      if (n0 + c >= s.n) continue;
      float sum = 0.f;
      for (int r = 0; r < TR; ++r) sum += colsum[r][c];   // zeros past M
      dbias_part[(size_t)blockIdx.y * s.n + n0 + c] = sum;
    }
  }
}

// A (M, K) -> a_t (K, ld_t), normalised first when gamma is given: the
// forward's prologue (gemm_fused.cu gemm_fused_rows_kernel) bit for bit,
// rmsnorm when mean is null, else layernorm (beta optional), from the
// forward's statistics.
__global__ void __launch_bounds__(THREADS)
gemm_bwd_g_a_kernel(const __nv_bfloat16* __restrict__ a,
                    const __nv_bfloat16* __restrict__ gamma,
                    const __nv_bfloat16* __restrict__ beta,
                    const float* __restrict__ mean,
                    const float* __restrict__ rstd,
                    __nv_bfloat16* __restrict__ a_t, int m, int k, int ld_t) {
  __shared__ __align__(16) __nv_bfloat16 tile[TR * TC];
  const int m0 = blockIdx.y * TR, k0 = blockIdx.x * TC;
#pragma unroll
  for (int i = 0; i < VECS; ++i) {
    const int v = threadIdx.x + i * THREADS;
    const int r = v / (TC / 8), c = (v % (TC / 8)) * 8;
    const int gm = m0 + r, gk = k0 + c;
    uint4 val = make_uint4(0, 0, 0, 0);
    __nv_bfloat16* x = reinterpret_cast<__nv_bfloat16*>(&val);
    if (gm < m && gk < k) {
      val = ld16(a + (size_t)gm * k + gk);
      if (gamma != nullptr) {
        const float rs = rstd[gm];
        const float mu = mean != nullptr ? mean[gm] : 0.f;
        const uint4 graw = ld16(gamma + gk);
        const __nv_bfloat16* gv =
            reinterpret_cast<const __nv_bfloat16*>(&graw);
        uint4 braw = make_uint4(0, 0, 0, 0);
        if (beta != nullptr) braw = ld16(beta + gk);
        const __nv_bfloat16* bv =
            reinterpret_cast<const __nv_bfloat16*>(&braw);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          float f = __bfloat162float(x[e]);
          if (mean != nullptr) f = __fsub_rn(f, mu);
          f = __fmul_rn(__fmul_rn(f, rs), __bfloat162float(gv[e]));
          if (beta != nullptr) f = __fadd_rn(f, __bfloat162float(bv[e]));
          x[e] = __float2bfloat16_rn(f);
        }
      }
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) tile[tpos(r, c + e)] = x[e];
  }
  __syncthreads();
  store_transposed(tile, 1, a_t, k, k0, m0, ld_t);
}

template <int MODE, int ACT, bool BIAS>
cudaError_t launch_g(const GSrc& s, __nv_bfloat16* gbar,
                     __nv_bfloat16* gbar_t, float* dbias_part, int ld_t,
                     cudaStream_t stream) {
  const dim3 grid((s.n + TC - 1) / TC, (s.m + TR - 1) / TR);
  gemm_bwd_g_kernel<MODE, ACT, BIAS>
      <<<grid, THREADS, 0, stream>>>(s, gbar, gbar_t, dbias_part, ld_t);
  return cudaGetLastError();
}

// The activation's instantiation of MODE (G_ACT or G_GATE).
template <int MODE, bool BIAS>
cudaError_t launch_act(int act, const GSrc& s, __nv_bfloat16* gbar,
                       __nv_bfloat16* gbar_t, float* dbias_part, int ld_t,
                       cudaStream_t stream) {
  switch (act) {
    case ACT_SILU:
      return launch_g<MODE, ACT_SILU, BIAS>(s, gbar, gbar_t, dbias_part, ld_t,
                                            stream);
    case ACT_GELU:
      return launch_g<MODE, ACT_GELU, BIAS>(s, gbar, gbar_t, dbias_part, ld_t,
                                            stream);
    case ACT_RELU:
      return launch_g<MODE, ACT_RELU, BIAS>(s, gbar, gbar_t, dbias_part, ld_t,
                                            stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// g: (M, N) bf16; preact: (M, N) bf16, the forward's saved raw accumulator
// of an activation chain, and preact2 the gated chain's second (else null);
// sin, cos: (M, head_dim) fp32 for rope, else null; bias: (N,) bf16 for an
// activation chain with a bias (its transpose reads it), else null; a:
// (M, K) bf16; gamma (K,) bf16 and the forward's rstd (M,) fp32 for a norm
// prologue, with its mean (M,) fp32 for layernorm and beta (K,) bf16 for
// layernorm + beta, else null. Writes gbar (M, N'), gbar_t (N', ld_t) and
// a_t (K, ld_t), bf16, and dbias_part (ceil(M / 64), N) fp32 when it is
// not null (bias chains). flags: the forward's chain bits and activation
// code. `scale` is 1 for a chain without a scale; ld_t >= M, a multiple
// of 8.
int gemm_bwd_g_launch(const void* g, const void* preact, const void* preact2,
                      const void* sin, const void* cos, const void* bias,
                      const void* a, const void* gamma, const void* beta,
                      const void* mean, const void* rstd, void* gbar,
                      void* gbar_t, void* a_t, void* dbias_part, float scale,
                      int m, int n, int k, int ld_t, int flags, int head_dim,
                      void* stream) {
  const int act = (flags & EP_ACT_MASK) >> EP_ACT_SHIFT;
  const bool gate = flags & EP_GATE;
  if ((gamma != nullptr) != (rstd != nullptr) ||
      ((mean != nullptr || beta != nullptr) && gamma == nullptr) ||
      (beta != nullptr && mean == nullptr) || ld_t < m || ld_t % 8 ||
      n % 8 || k % 8 || (gate && act == ACT_NONE) ||
      (preact != nullptr) != (act != ACT_NONE) ||
      (preact2 != nullptr) != gate ||
      (bias != nullptr && (act == ACT_NONE || gate)))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  GSrc s;
  s.g = static_cast<const __nv_bfloat16*>(g);
  s.preact = static_cast<const __nv_bfloat16*>(preact);
  s.preact2 = static_cast<const __nv_bfloat16*>(preact2);
  s.sin = static_cast<const float*>(sin);
  s.cos = static_cast<const float*>(cos);
  s.bias = static_cast<const __nv_bfloat16*>(bias);
  s.scale = scale;
  s.m = m;
  s.n = n;
  s.head_dim = head_dim;
  auto* gb = static_cast<__nv_bfloat16*>(gbar);
  auto* gbt = static_cast<__nv_bfloat16*>(gbar_t);
  auto* part = static_cast<float*>(dbias_part);
  const bool dbias = part != nullptr;
  cudaError_t err;
  if (gate) {
    if (dbias) return cudaErrorInvalidValue;
    err = launch_act<G_GATE, false>(act, s, gb, gbt, part, ld_t, st);
  } else if (act != ACT_NONE) {
    err = dbias ? launch_act<G_ACT, true>(act, s, gb, gbt, part, ld_t, st)
                : launch_act<G_ACT, false>(act, s, gb, gbt, part, ld_t, st);
  } else if (flags & EP_ROPE) {
    if (sin == nullptr || cos == nullptr || head_dim % 16 || n % head_dim)
      return cudaErrorInvalidValue;
    err = dbias ? launch_g<G_ROPE, ACT_NONE, true>(s, gb, gbt, part, ld_t, st)
                : launch_g<G_ROPE, ACT_NONE, false>(s, gb, gbt, part, ld_t,
                                                    st);
  } else {
    err = dbias ? launch_g<G_PLAIN, ACT_NONE, true>(s, gb, gbt, part, ld_t, st)
                : launch_g<G_PLAIN, ACT_NONE, false>(s, gb, gbt, part, ld_t,
                                                     st);
  }
  if (err != cudaSuccess) return err;
  const dim3 grid((k + TC - 1) / TC, (m + TR - 1) / TR);
  gemm_bwd_g_a_kernel<<<grid, THREADS, 0, st>>>(
      static_cast<const __nv_bfloat16*>(a),
      static_cast<const __nv_bfloat16*>(gamma),
      static_cast<const __nv_bfloat16*>(beta),
      static_cast<const float*>(mean), static_cast<const float*>(rstd),
      static_cast<__nv_bfloat16*>(a_t), m, k, ld_t);
  return cudaGetLastError();
}

}  // extern "C"

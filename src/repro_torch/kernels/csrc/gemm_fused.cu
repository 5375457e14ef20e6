// Fused GEMM for Hopper: C = epilogue(prologue(A) @ B [, A @ B2]).
//
// Replaces the TPU kernel `_gemm_kernel` (src/repro/kernels/gemm/kernel.py),
// launched there by `_gemm_pallas`. It computes the same chain:
//   prologue  rmsnorm or layernorm (with or without the beta row) of each A
//             row in fp32, rounded back to bf16 before the product
//             (kernel.py:111-119 through prologue.py: bf16(x * rstd * gamma)
//             or bf16((x - mean) * rstd * gamma [+ beta]), each product and
//             sum rounded apart);
//   product   bf16 x bf16 -> fp32 accumulators (two for the gated variant);
//   epilogue  x scale -> + bias -> rope -> act(acc) [* acc2] -> + residual,
//             act one of silu, gelu (the tanh form) and relu, gated or not
//             (epilogue.py:213-234);
//   save      for the differentiated forward of an activation chain, the
//             raw fp32 accumulator rounded to bf16 into `preact` (and the
//             gate's second into `preact2`; kernel.py:132-136 stores them
//             through the MXU input type), the operands of the backward's
//             act' (gemm_bwd_g.cu). The preact2 store is compiled into the
//             gated store only. The row statistics stay in `rstd` (and
//             `mean`) for the backward too.
//
// What bounds it on an H100: at the prefill and training shapes (M = 1024
// or 4096 tokens, K = 2048, N up to 2 x 8192; the down projection K = 8192)
// the tensor cores, 2 M N K operations at 989 TFLOP/s bf16; at the decode
// shapes (M = 4) the weight bytes over HBM (3.35 TB/s), e.g. 32 MB of the
// down projection's weight in ~10 us. What the design does about it:
//   - the product runs on the Hopper mainloop (gemm_sm90.cuh): TMA loads
//     into a 4-8 stage ring, one producer and two consumer warpgroups
//     issuing wgmma, persistent blocks. B is read as it is stored, (K, N)
//     with N contiguous, through 64-column TMA boxes and wgmma's transposed
//     (MN-major) B: no transposed copy of a weight is ever written;
//   - the activation is a template parameter of the mainloop kernel (one
//     instantiation per code), and the gate and the rope stage of its store
//     are compile-time too, so each store carries its chain's code only;
//   - the gated chain loads B's and B2's columns side by side into one
//     BN-wide tile, so act(acc) * acc2 pairs entry j with entry j + BN/16
//     of the same thread; RoPE's partner column c +- head_dim/2 is entry
//     j +- head_dim/16 of the same thread too (tiles start on whole heads),
//     so the whole chain runs on the accumulators in registers, with no
//     shared-memory staging;
//   - the norm prologue is one bytes-bound row pass before the product
//     (gemm_fused_rows_kernel): it writes rstd (M,) (and for layernorm the
//     mean (M,)) and the normalised An (M, K) in bf16 once, which the
//     mainloop then reads by TMA. Each element is normalised once instead
//     of once per column tile. Layernorm's variance is that of the centred
//     values, a second pass over the row (L2-resident), not E[x^2] -
//     mean^2, which loses the reference's tolerance on rows with a large
//     mean. Unlike the TPU kernel, which keeps An in VMEM, An goes through
//     HBM: 8 MB each way at M 4096, K 2048, ~5 us against the 278 us of
//     the up projection's products;
//   - the tile width (64, 128 or 256) is picked per launch from the tiles
//     against the SMs (kernels/gemm/ops.py plan_gemm). Where one tile row
//     holds all of M (decode's M = 4, a prefill chunk: 16-128 tiles on 132
//     SMs), the contraction is split: each (tile, split) writes its fp32
//     partial sum to a workspace, and gemm_fused_reduce_kernel adds the
//     splits in a fixed order (no atomics, so every call gives the same
//     bits) and runs the chain. The split count depends on the shape and
//     the SM count only. A rope head_dim under 16 (whose partner columns
//     another thread holds) takes the same route with one split.
// Ragged M, N and K edges are zero-filled by the TMA and masked in the store
// (N and K must be multiples of 8).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_sm90.cuh"

namespace {

// The chain's bit flags, and the activation's code in bits
// EP_ACT_SHIFT.. (kernels/gemm/ops.py chain_flags).
enum : int {
  EP_SCALE = 1,
  EP_BIAS = 2,
  EP_ROPE = 4,
  EP_GATE = 8,   // act(acc) * acc2, B2's columns in each tile's second half
  EP_RESIDUAL = 16,
  EP_ACT_SHIFT = 5,
  EP_ACT_MASK = 3 << EP_ACT_SHIFT,
};

enum : int { ACT_NONE = 0, ACT_SILU = 1, ACT_GELU = 2, ACT_RELU = 3 };

// The epilogue chain's operands and output.
struct Chain {
  __nv_bfloat16* out;             // (M, N)
  __nv_bfloat16* preact;          // (M, N) raw acc in bf16 (an activation
                                  // chain's autograd forward), or null
  __nv_bfloat16* preact2;         // (M, N) raw acc2 in bf16 (gated), or null
  const __nv_bfloat16* bias;      // (N,)
  const __nv_bfloat16* residual;  // (M, N)
  const float* sin;               // (M, head_dim)
  const float* cos;               // (M, head_dim)
  float scale;
  int m, n, flags, head_dim;
};

__device__ __forceinline__ float silu(float x) { return x / (1.0f + expf(-x)); }

// jax.nn.gelu(approximate=True), in fp32 with the full tanhf (not
// tanh.approx.f32): x (0.5 (1 + tanh(sqrt(2 / pi) (x + 0.044715 x^3))))
__device__ __forceinline__ float gelu(float x) {
  const float c = 0.7978845608028654f;
  return x * (0.5f * (1.0f + tanhf(c * (x + 0.044715f * (x * x * x)))));
}

// The activation of code ACT, a compile-time constant in every store, so
// each instantiation inlines one function only.
template <int ACT>
__device__ __forceinline__ float act(float x) {
  if constexpr (ACT == ACT_SILU) return silu(x);
  if constexpr (ACT == ACT_GELU) return gelu(x);
  if constexpr (ACT == ACT_RELU) return fmaxf(x, 0.0f);
  return x;
}

__host__ __device__ __forceinline__ int act_code(int flags) {
  return (flags & EP_ACT_MASK) >> EP_ACT_SHIFT;
}

__device__ __forceinline__ float2 bf2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float2 f2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// The chain up to the residual on output columns (col, col + 1) of one
// row, in the reference's order (epilogue.py:213-234): u the accumulator
// there, w the accumulator at the RoPE partner columns (col +- head_dim/2),
// g the gate's second accumulator; jh = col % head_dim for the rope. ACT
// (the flags' activation code), GATE and ROPE (whether the rope stage can
// run) are compile-time, so a store holds the code of its own chain only
// (the stages it cannot run, compiled in behind runtime flags, made the
// gated and gelu stores slower on an H100).
template <int ACT, bool GATE, bool ROPE>
__device__ __forceinline__ float2 chain_value(const Chain& ch, int row,
                                              int col, int jh, float2 u,
                                              float2 w, float2 g) {
  const int f = ch.flags;
  if (f & EP_SCALE) {
    u.x *= ch.scale;
    u.y *= ch.scale;
  }
  // columns of a ragged last tile past N (not stored) read the last pair's
  // bias: the (N,) row ends at column N - 1
  if (f & EP_BIAS) {
    const float2 b = bf2(ch.bias + min(col, ch.n - 2));
    u.x += b.x;
    u.y += b.y;
  }
  if (ROPE && (f & EP_ROPE)) {
    const int half = ch.head_dim / 2;
    const int pc = jh < half ? col + half : col - half;
    if (f & EP_SCALE) {
      w.x *= ch.scale;
      w.y *= ch.scale;
    }
    if (f & EP_BIAS) {
      const float2 b = bf2(ch.bias + min(pc, ch.n - 2));
      w.x += b.x;
      w.y += b.y;
    }
    if (jh < half) {
      w.x = -w.x;
      w.y = -w.y;
    }
    // the rows of a warp past M (their values are not stored) read the
    // last row's table entries: the (M, head_dim) tables end at row M - 1
    const size_t t = (size_t)min(row, ch.m - 1) * ch.head_dim + jh;
    const float2 c = f2(ch.cos + t);
    const float2 s = f2(ch.sin + t);
    u.x = u.x * c.x + w.x * s.x;
    u.y = u.y * c.y + w.y * s.y;
  }
  if constexpr (GATE) {
    if (f & EP_SCALE) {
      g.x *= ch.scale;
      g.y *= ch.scale;
    }
    u.x = act<ACT>(u.x) * g.x;
    u.y = act<ACT>(u.y) * g.y;
  } else {
    u.x = act<ACT>(u.x);
    u.y = act<ACT>(u.y);
  }
  return u;
}

__device__ __forceinline__ uint32_t pack2(float2 v) {
  const __nv_bfloat162 b = __floats2bfloat162_rn(v.x, v.y);
  return *reinterpret_cast<const uint32_t*>(&b);
}

__device__ __forceinline__ float2 shfl_xor(float2 v, int m) {
  return make_float2(__shfl_xor_sync(0xffffffffu, v.x, m),
                     __shfl_xor_sync(0xffffffffu, v.y, m));
}

__device__ __forceinline__ uint32_t shfl_xor(uint32_t v, int m) {
  return __shfl_xor_sync(0xffffffffu, v, m);
}

// The 4 x 4 transpose within a quad of lanes (q = lane % 4): before, x[i]
// holds columns 2q, 2q + 1 of 8-column group i; after, columns 2i, 2i + 1
// of group q, so each lane holds one group's 8 columns, a 16-byte store.
template <class T>
__device__ __forceinline__ void quad_transpose(T (&x)[4], int q) {
  bool hi = q & 1;
  T r0 = shfl_xor(hi ? x[0] : x[1], 1), r1 = shfl_xor(hi ? x[2] : x[3], 1);
  x[0] = hi ? r0 : x[0];
  x[1] = hi ? x[1] : r0;
  x[2] = hi ? r1 : x[2];
  x[3] = hi ? x[3] : r1;
  hi = q & 2;
  r0 = shfl_xor(hi ? x[0] : x[2], 2);
  r1 = shfl_xor(hi ? x[1] : x[3], 2);
  x[0] = hi ? r0 : x[0];
  x[1] = hi ? r1 : x[1];
  x[2] = hi ? x[2] : r0;
  x[3] = hi ? x[3] : r1;
}

// One row's 8 output columns from col (a multiple of 8): + the residual,
// rounded to bf16, stored in 16 bytes; with the raw accumulators' words
// into the preacts (the second one for the gated chain only).
template <bool GATE>
__device__ __forceinline__ void store8(const Chain& ch, int row, int col,
                                       const float2 (&v)[4],
                                       const uint32_t (&p1)[4],
                                       const uint32_t (&p2)[4]) {
  if (row >= ch.m || col >= ch.n) return;
  const size_t off = (size_t)row * ch.n + col;
  float2 u[4] = {v[0], v[1], v[2], v[3]};
  if (ch.flags & EP_RESIDUAL) {
    const uint4 raw = *reinterpret_cast<const uint4*>(ch.residual + off);
    const __nv_bfloat162* r = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(r[i]);
      u[i].x += x.x;
      u[i].y += x.y;
    }
  }
  *reinterpret_cast<uint4*>(ch.out + off) =
      make_uint4(pack2(u[0]), pack2(u[1]), pack2(u[2]), pack2(u[3]));
  if (ch.preact != nullptr) {
    *reinterpret_cast<uint4*>(ch.preact + off) =
        make_uint4(p1[0], p1[1], p1[2], p1[3]);
    if constexpr (GATE)
      *reinterpret_cast<uint4*>(ch.preact2 + off) =
          make_uint4(p2[0], p2[1], p2[2], p2[3]);
  }
}

// The chain on a whole tile of accumulators in registers (see the layout in
// gemm_sm90.cuh StorePairs), four 8-column groups at a time: their values
// up to the residual in registers, a quad transpose, then one 16-byte store
// per lane and row (two-column stores from the accumulator layout took
// most of the epilogue's time). Every acc index is a compile-time constant
// once the loops unroll, so the RoPE and gate partners stay in registers.
// The functor holds a copy of the chain: read through a reference to the
// kernel parameter instead, the fields are loaded again around the stores
// (the compiler cannot rule out that a store wrote them). ACT: the
// activation's code, one instantiation of the mainloop kernel each.
template <int ACT>
struct FusedStore {
  const Chain ch;

  // HD: the rope's head_dim (0: none); GATE: B2's columns in the tile's
  // second half
  template <int BN, int HD, bool GATE>
  __device__ __forceinline__ void tile(float (&acc)[BN / 2], int row,
                                       int tile_col, int q) const {
    static_assert(!HD || (BN % HD == 0 && HD % 16 == 0),
                  "tiles hold whole heads");
    constexpr int GROUPS = GATE ? BN / 16 : BN / 8;   // output groups
    const int out0 = GATE ? tile_col / 2 : tile_col;
    const int lq = q / 2;
    const bool save = ch.preact != nullptr;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // a warp whose 8 rows all lie past M (decode's M = 4 fills one of
      // 16) skips them, together, so its shuffles stay whole
      if (row - (threadIdx.x % 32) / 4 + 8 * h >= ch.m) continue;
#pragma unroll
      for (int c = 0; c < GROUPS / 4; ++c) {
        float2 v[4];
        uint32_t p1[4], p2[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int j = 4 * c + i;
          // group j's RoPE partner, within the same head; the gate's
          // second accumulator BN/2 columns on
          const int jp = !HD ? j
                             : (j * 8) % HD < HD / 2 ? j + HD / 16
                                                     : j - HD / 16;
          const int jg = GATE ? j + BN / 16 : j;
          const float2 u =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
          const float2 g =
              make_float2(acc[4 * jg + 2 * h], acc[4 * jg + 2 * h + 1]);
          p1[i] = pack2(u);
          p2[i] = pack2(g);
          v[i] = chain_value<ACT, GATE, HD != 0>(
              ch, row + 8 * h, out0 + 8 * j + q, HD ? (j * 8) % HD + q : 0,
              u, make_float2(acc[4 * jp + 2 * h], acc[4 * jp + 2 * h + 1]),
              g);
        }
        quad_transpose(v, lq);
        if (save) {
          quad_transpose(p1, lq);
          if constexpr (GATE) quad_transpose(p2, lq);
        }
        store8<GATE>(ch, row + 8 * h, out0 + 8 * (4 * c + lq), v, p1, p2);
      }
    }
  }

  template <int BN>
  __device__ __forceinline__ void operator()(const sm90::Params&,
                                             float (&acc)[BN / 2], int row,
                                             int tile_col, int q,
                                             int) const {
    if (ch.flags & EP_GATE) {
      // tile columns [0, BN/2) are B's, [BN/2, BN) the same columns of B2
      if constexpr (BN >= 128 && ACT != ACT_NONE)
        tile<BN, 0, true>(acc, row, tile_col, q);
      return;
    }
    if constexpr (BN <= 128 && ACT == ACT_NONE) {   // rope: 64 or 128 wide
      if (ch.flags & EP_ROPE) {
        switch (ch.head_dim) {   // under 16: staged, see the entry point
          case 16: tile<BN, 16, false>(acc, row, tile_col, q); return;
          case 32: tile<BN, 32, false>(acc, row, tile_col, q); return;
          case 64: tile<BN, 64, false>(acc, row, tile_col, q); return;
          case 128:
            if constexpr (BN == 128) tile<BN, 128, false>(acc, row, tile_col, q);
            return;
        }
        return;
      }
    }
    tile<BN, 0, false>(acc, row, tile_col, q);
  }
};

template <int BN, int ACT>
__global__ void __launch_bounds__(sm90::THREADS, 1)
gemm_fused_kernel(const __grid_constant__ sm90::Params p,
                  const __grid_constant__ Chain ch) {
  sm90::gemm_body<BN, true>(p, FusedStore<ACT>{ch});
}

// A split launch: each work item's fp32 partial sum, split s at rows
// s * M of the workspace.
template <int BN>
__global__ void __launch_bounds__(sm90::THREADS, 1)
gemm_fused_splitk_kernel(const __grid_constant__ sm90::Params p) {
  sm90::gemm_body<BN, true>(p, sm90::StorePairs<true>{});
}

// The splits summed in order 0, 1, ..., then the chain, one thread per pair
// of output columns. ws: (splits, M, ld) fp32 in the mainloop's raw
// columns: for the gated chain, tile t's B columns at [t bn, t bn + bn/2),
// B2's after them. ACT: the activation's code.
template <int ACT>
__global__ void __launch_bounds__(256)
gemm_fused_reduce_kernel(const float* __restrict__ ws, int splits, int ld,
                         int bn, const Chain ch) {
  const int pairs = ch.n / 2;
  const size_t total = (size_t)ch.m * pairs;
  const size_t plane = (size_t)ch.m * ld;
  const bool gate = ch.flags & EP_GATE, rope = ch.flags & EP_ROPE;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const int row = i / pairs, col = (i % pairs) * 2;
    const int rc = gate ? (col / (bn / 2)) * bn + col % (bn / 2) : col;
    const float* base = ws + (size_t)row * ld;
    auto sum = [&](int c) {
      float2 v = make_float2(0.f, 0.f);
      for (int s = 0; s < splits; ++s) {
        const float2 x =
            *reinterpret_cast<const float2*>(base + s * plane + c);
        v.x += x.x;
        v.y += x.y;
      }
      return v;
    };
    const float2 zero = make_float2(0.f, 0.f);
    float2 w = zero, g = zero;
    const int jh = rope ? col % ch.head_dim : 0;
    if (rope) {
      const int half = ch.head_dim / 2;
      w = sum(jh < half ? rc + half : rc - half);
    }
    if (gate) g = sum(rc + bn / 2);
    const float2 u = sum(rc);
    float2 v = gate ? chain_value<ACT, true, false>(ch, row, col, jh, u, w, g)
                    : chain_value<ACT, false, true>(ch, row, col, jh, u, w, g);
    const size_t off = (size_t)row * ch.n + col;
    if (ch.flags & EP_RESIDUAL) {
      const float2 r = bf2(ch.residual + off);
      v.x += r.x;
      v.y += r.y;
    }
    *reinterpret_cast<uint32_t*>(ch.out + off) = pack2(v);
    if (ch.preact != nullptr) {
      *reinterpret_cast<uint32_t*>(ch.preact + off) = pack2(u);
      if (gate) *reinterpret_cast<uint32_t*>(ch.preact2 + off) = pack2(g);
    }
  }
}

// The norm prologue, one block per row of A, one 8-element vector a thread
// (row_threads(k) threads, whole warps, at most ROW_THREADS; the row is
// read again from L2 for each pass):
//   rmsnorm   rstd = 1 / sqrt(mean(x^2) + eps) in fp32 (as
//             models/common.rmsnorm), An = bf16((x rstd) gamma);
//   layernorm mean = sum(x) / k, then the variance of the centred values,
//             var = sum((x - mean)^2) / k, in a second pass (not E[x^2] -
//             mean^2), rstd = 1 / sqrt(var + eps) (as models/common.
//             layernorm), An = bf16(((x - mean) rstd) gamma [+ beta]).
// An's products and sum are rounded as written (no contraction into an
// FMA): the reference's order and rounding point before the product. rstd
// (M,) and, for layernorm, mean (M,) are written in fp32 for the backward.
constexpr int ROW_THREADS = 256;

inline int row_threads(int k) {
  const int t = (k / 8 + 31) / 32 * 32;
  return t < ROW_THREADS ? t : ROW_THREADS;
}

// The sum of v over the block, in a fixed order (each warp's lanes by xor
// shuffles, then the warps' sums in warp 0); scratch: 33 shared floats,
// free again when it returns.
__device__ __forceinline__ float block_sum(float v, float* scratch) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float s = lane < (int)blockDim.x / 32 ? scratch[lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) scratch[32] = s;
  }
  __syncthreads();
  const float total = scratch[32];
  __syncthreads();
  return total;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&f)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* v = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) f[i] = __bfloat162float(v[i]);
}

__global__ void __launch_bounds__(ROW_THREADS)
gemm_fused_rows_kernel(const __nv_bfloat16* __restrict__ a,
                       const __nv_bfloat16* __restrict__ gamma,
                       const __nv_bfloat16* __restrict__ beta,
                       __nv_bfloat16* __restrict__ an,
                       float* __restrict__ mean_out,
                       float* __restrict__ rstd, int k, float eps,
                       bool layernorm) {
  __shared__ float scratch[33];
  const int row = blockIdx.x, step = blockDim.x * 8;
  const __nv_bfloat16* x = a + (size_t)row * k;
  float f[8];
  float mean = 0.f;
  if (layernorm) {
    float sum = 0.f;
    for (int c = threadIdx.x * 8; c < k; c += step) {
      load8(x + c, f);
#pragma unroll
      for (int i = 0; i < 8; ++i) sum += f[i];
    }
    mean = block_sum(sum, scratch) / (float)k;
  }
  float sq = 0.f;
  for (int c = threadIdx.x * 8; c < k; c += step) {
    load8(x + c, f);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float d = layernorm ? __fsub_rn(f[i], mean) : f[i];
      sq += d * d;
    }
  }
  const float var = block_sum(sq, scratch) / (float)k;
  const float rs = 1.0f / sqrtf(var + eps);
  if (threadIdx.x == 0) {
    rstd[row] = rs;
    if (layernorm) mean_out[row] = mean;
  }
  __nv_bfloat16* y = an + (size_t)row * k;
  for (int c = threadIdx.x * 8; c < k; c += step) {
    float g[8], b[8];
    load8(x + c, f);
    load8(gamma + c, g);
    if (beta != nullptr) load8(beta + c, b);
    uint4 raw;
    __nv_bfloat16* v = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float d = layernorm ? __fsub_rn(f[i], mean) : f[i];
      float o = __fmul_rn(__fmul_rn(d, rs), g[i]);
      if (beta != nullptr) o = __fadd_rn(o, b[i]);
      v[i] = __float2bfloat16_rn(o);
    }
    *reinterpret_cast<uint4*>(y + c) = raw;
  }
}

template <int BN>
cudaError_t product(const sm90::Operand& x, const sm90::Operand* y,
                    int halves, int splits, bool staged,
                    const sm90::Params& p, const Chain& ch,
                    cudaStream_t stream) {
  const int sms = sm90::sm_count();
  if (!staged) {
    switch (act_code(ch.flags)) {
      case ACT_NONE:
        return sm90::launch_mn<BN>(gemm_fused_kernel<BN, ACT_NONE>, x, y,
                                   halves, 1, p, sms, stream, ch);
      case ACT_SILU:
        return sm90::launch_mn<BN>(gemm_fused_kernel<BN, ACT_SILU>, x, y,
                                   halves, 1, p, sms, stream, ch);
      case ACT_GELU:
        return sm90::launch_mn<BN>(gemm_fused_kernel<BN, ACT_GELU>, x, y,
                                   halves, 1, p, sms, stream, ch);
      case ACT_RELU:
        return sm90::launch_mn<BN>(gemm_fused_kernel<BN, ACT_RELU>, x, y,
                                   halves, 1, p, sms, stream, ch);
    }
    return cudaErrorInvalidValue;
  }
  return sm90::launch_mn<BN>(gemm_fused_splitk_kernel<BN>, x, y, halves,
                             splits, p, sms, stream);
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// a (M, K), b and b2 (K, N) bf16 as stored; c (M, N) bf16. With gamma (the
// norm prologue), rstd (M,) fp32 and an (M, K) bf16 are written by the
// row pass, and the product reads an; with mean (M,) fp32 too the norm is
// layernorm (beta (K,) bf16 or null), else rmsnorm. flags: the chain's
// bits and its activation's code (EP_ACT_SHIFT). preact: (M, N) bf16 output
// of an activation chain (the raw accumulator), or null; preact2: the gated
// chain's second, given with preact and only then. tile_n: the mainloop's tile width (64,
// 128 or 256; at least 128 for the gated chain, a multiple of head_dim for
// rope, itself a multiple of 4, and at most 128 then); splits: the
// contraction's split count
// (every split non-empty); window: the walk's tile rows a group (>= 1).
// ws: a (splits, M, n_raw) fp32 workspace when
// splits > 1 or a rope head_dim is no multiple of 16, else null or, at one
// split, a workspace that receives the raw fp32 accumulators (the staged
// route: the caller reads the fp32 product from it); n_raw = N, or for the
// gated chain ceil(N / (tile_n / 2)) * tile_n.
int gemm_fused_launch(const void* a, const void* b, const void* b2, void* c,
                      const void* gamma, const void* beta, void* mean,
                      void* rstd, void* an,
                      const void* bias, const void* residual, const void* sin,
                      const void* cos, void* preact, void* preact2, void* ws,
                      float scale, float eps, int m, int n, int k, int flags,
                      int head_dim, int tile_n, int splits, int window,
                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool gate = flags & EP_GATE;
  if (gate != (b2 != nullptr) ||
      (preact2 != nullptr) != (gate && preact != nullptr) ||
      (preact != nullptr && act_code(flags) == ACT_NONE) || m < 1 || n < 1 || k < 1 || n % 8 ||
      k % 8 || splits < 1 || window < 1 ||
      (gamma != nullptr && (rstd == nullptr || an == nullptr)) ||
      ((beta != nullptr || mean != nullptr) && gamma == nullptr) ||
      (beta != nullptr && mean == nullptr) || (gate && tile_n < 128) ||
      (gate && act_code(flags) == ACT_NONE) ||
      ((flags & EP_ROPE) && act_code(flags) != ACT_NONE))
    return cudaErrorInvalidValue;
  if ((flags & EP_ROPE) && (head_dim % 4 || head_dim < 4 ||
                            tile_n % head_dim || tile_n > 128 ||
                            n % head_dim))
    return cudaErrorInvalidValue;
  const bool staged = splits > 1 || ((flags & EP_ROPE) && head_dim % 16) ||
                      ws != nullptr;
  if (staged && ws == nullptr) return cudaErrorInvalidValue;
  Chain ch;
  ch.out = static_cast<__nv_bfloat16*>(c);
  ch.preact = static_cast<__nv_bfloat16*>(preact);
  ch.preact2 = static_cast<__nv_bfloat16*>(preact2);
  ch.bias = static_cast<const __nv_bfloat16*>(bias);
  ch.residual = static_cast<const __nv_bfloat16*>(residual);
  ch.sin = static_cast<const float*>(sin);
  ch.cos = static_cast<const float*>(cos);
  ch.scale = scale;
  ch.m = m;
  ch.n = n;
  ch.flags = flags;
  ch.head_dim = head_dim;
  if (gamma != nullptr) {
    gemm_fused_rows_kernel<<<m, row_threads(k), 0, st>>>(
        static_cast<const __nv_bfloat16*>(a),
        static_cast<const __nv_bfloat16*>(gamma),
        static_cast<const __nv_bfloat16*>(beta),
        static_cast<__nv_bfloat16*>(an), static_cast<float*>(mean),
        static_cast<float*>(rstd), k, eps, mean != nullptr);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const sm90::Operand x = {gamma != nullptr ? an : a, m, k, k};
  const sm90::Operand y[2] = {{b, k, n, n}, {b2, k, n, n}};
  const int halves = gate ? 2 : 1;
  const int tile_out = tile_n / halves;   // output columns a tile gives
  sm90::Params p{};
  p.group_m = window;
  p.m = m;
  p.n = gate ? (n + tile_out - 1) / tile_out * tile_n : n;
  p.c = ws;
  p.ldc = p.n;
  p.n_split = p.n;
  cudaError_t err = cudaErrorInvalidValue;
  switch (tile_n) {
    case 256: err = product<256>(x, y, halves, splits, staged, p, ch, st);
      break;
    case 128: err = product<128>(x, y, halves, splits, staged, p, ch, st);
      break;
    case 64: err = product<64>(x, y, halves, splits, staged, p, ch, st);
      break;
  }
  if (err != cudaSuccess || !staged) return err;
  const long long pairs = (long long)m * (n / 2);
  const int blocks = (int)((pairs + 255) / 256 < 4096 ? (pairs + 255) / 256
                                                       : 4096);
  const float* partials = static_cast<const float*>(ws);
  switch (act_code(flags)) {
    case ACT_NONE:
      gemm_fused_reduce_kernel<ACT_NONE><<<blocks, 256, 0, st>>>(
          partials, splits, p.n, tile_n, ch);
      break;
    case ACT_SILU:
      gemm_fused_reduce_kernel<ACT_SILU><<<blocks, 256, 0, st>>>(
          partials, splits, p.n, tile_n, ch);
      break;
    case ACT_GELU:
      gemm_fused_reduce_kernel<ACT_GELU><<<blocks, 256, 0, st>>>(
          partials, splits, p.n, tile_n, ch);
      break;
    case ACT_RELU:
      gemm_fused_reduce_kernel<ACT_RELU><<<blocks, 256, 0, st>>>(
          partials, splits, p.n, tile_n, ch);
      break;
  }
  return cudaGetLastError();
}

}  // extern "C"

// Fused dropout + residual add + layernorm for Hopper.
//
// Replaces the TPU kernel `_fused_kernel` (src/repro/kernels/fused_norm/
// kernel.py), launched there by `fused_dropout_residual_layernorm`. Per row:
//   keep  = uniform(lowbias32(idx ^ lowbias32(seed))) >= p,  idx = row*d+col
//   x'    = keep ? x * scale : 0          (scale = 1/(1-p), rounded to fp32)
//   r     = residual + x'                 (fp32)      -> new_residual (x's type)
//   out   = (r - mean) * rsqrt(var + eps) * w + b     -> normed (x's type)
// with mean and var = mean((r - mean)^2) taken in fp32 in two passes. The
// hash is the reference's counter-based lowbias32 in uint32 arithmetic: the
// seed enters as int32 and is cast to uint32 (-1 is 0xFFFFFFFF) and idx
// wraps mod 2^32, as the Pallas kernel's jnp.uint32 arithmetic does, so the
// keep-mask is bit for bit the reference's. With p = 0 no mask is drawn.
//
// What bounds it on an H100: bytes. Two (rows, d) reads and two writes plus
// the (d,) affine vectors, against ~10 operations an element. The design
// keeps the row out of device memory between its passes and keeps enough
// bytes in flight to cover the DRAM latency:
//
// - Up to d = MAX_REG_D the row lives in registers. A row is owned by TPR
//   threads (32-512, the least that hold it at EPT = 16 elements a thread:
//   128, a warpgroup, at d 2048); a block of BLOCK threads holds BLOCK / TPR
//   rows. Slot k of thread t holds VEC elements at column (k TPR + t) VEC:
//   16-byte vectors (4 fp32 or 8 bf16) where d and the four row pointers
//   allow, so each load and store of a warp covers 512 contiguous bytes;
//   single elements otherwise (a view at an odd offset, or d no multiple
//   of VEC), in the same kernel instantiated with VECTOR = false.
// - The grid is persistent: as many blocks as the SMs hold at the block's
//   occupancy. Each row group walks rows at a stride of the grid; every load
//   of a row is issued before the hash, the add and the reductions, and the
//   next row's loads are issued as soon as the current row's values are in
//   registers, so they fly while the current row is reduced and written.
// - Weight and bias are read once a block, into shared memory as fp32.
// - The mean is a warp shuffle tree, then one shared-memory exchange of a
//   scalar among the row's warps behind a named barrier of those warps
//   only; the centered variance is a second pass over the registers, not a
//   second read. Sums run in a fixed order: a thread's slots in column
//   order, the xor tree, the row's warps in order.
// - Rows wider than MAX_REG_D (up to the wrapper's MAX_D) take a second
//   kernel of the same source: a block a row, the row's fp32 sum held in
//   shared memory between the passes.
// new_residual is the plain version's bit for bit (the same __fmul_rn by the
// fp32 scale and __fadd_rn); normed differs only by the order of the row
// sums and rsqrtf.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_sm90.cuh"   // sm90::sm_count

namespace {

constexpr int EPT = 16;                    // row elements a thread holds
constexpr int BLOCK = 256;                 // threads a block (TPR <= BLOCK)
constexpr int MAX_TPR = 512;               // threads a row, widest instance
constexpr int MAX_REG_D = EPT * MAX_TPR;   // widest row held in registers
constexpr int SMEM_THREADS = 256;          // the shared-memory kernel's block
constexpr int SMEM_WARPS = SMEM_THREADS / 32;
constexpr int MAX_SMEM = 232448;           // what a block can use on an H100

struct NormArgs {
  const void* x;         // (rows, d)
  const void* residual;  // (rows, d), x's type
  const void* weight;    // (d,)
  const void* bias;      // (d,)
  void* out;             // (rows, d), x's type
  void* new_residual;    // (rows, d), x's type
  int rows, d;
  uint32_t seed;
  float p, scale, eps;
  int wbf16;             // weight and bias: 0 fp32, 1 bf16
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_float(float& o, float v) { o = v; }
__device__ __forceinline__ void from_float(__nv_bfloat16& o, float v) {
  o = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float load_w(const void* p, int c, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[c])
              : static_cast<const float*>(p)[c];
}

__device__ __forceinline__ uint32_t lowbias32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// x' of one element: the reference's dropout, rounded as it rounds
__device__ __forceinline__ float dropout(float xv, uint32_t idx,
                                         uint32_t seed_mix, const NormArgs& a) {
  if (a.p > 0.f) {
    const uint32_t bits = lowbias32(idx ^ seed_mix);
    const float u = (float)(bits >> 8) * (1.0f / 16777216.0f);
    xv = u >= a.p ? __fmul_rn(xv, a.scale) : 0.f;
  }
  return xv;
}

// N elements of T: one 16-byte vector, or one element
template <typename T, int N>
struct alignas(N * sizeof(T)) Pack {
  T e[N];
};

template <typename T, int N>
__device__ __forceinline__ void load_pack(Pack<T, N>& pk, const T* p) {
  if constexpr (N * sizeof(T) == 16)
    *reinterpret_cast<uint4*>(&pk) = __ldg(reinterpret_cast<const uint4*>(p));
  else
    pk = *reinterpret_cast<const Pack<T, N>*>(p);
}

template <typename T, int N>
__device__ __forceinline__ void store_pack(T* p, const Pack<T, N>& pk) {
  *reinterpret_cast<Pack<T, N>*>(p) = pk;
}

// Issues the loads of thread t's slots of a row of x and of the residual.
template <int TPR, typename T, int VEC, int SLOTS>
__device__ __forceinline__ void load_row(Pack<T, VEC> (&xr)[SLOTS],
                                         Pack<T, VEC> (&rr)[SLOTS],
                                         const T* x, const T* res, size_t base,
                                         int t, int d) {
#pragma unroll
  for (int k = 0; k < SLOTS; ++k) {
    const int c = (k * TPR + t) * VEC;
    if (c < d) {
      load_pack(xr[k], x + base + c);
      load_pack(rr[k], res + base + c);
    }
  }
}

// N fp32 values of shared memory at p (16-byte aligned where N is 4 or 8)
template <int N>
__device__ __forceinline__ void load_affine(float (&v)[N], const float* p) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + i);
      v[i] = q.x;
      v[i + 1] = q.y;
      v[i + 2] = q.z;
      v[i + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = p[i];
  }
}

// Sum of v over the row's WARPS warps, in a fixed order; every thread gets
// the total. red: WARPS floats of this row; bar: its named barrier.
template <int WARPS>
__device__ __forceinline__ float row_sum(float v, float* red, int bar) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  if constexpr (WARPS == 1) {
    return v;
  } else {
    const int warp = (threadIdx.x / 32) % WARPS, lane = threadIdx.x % 32;
    if (lane == 0) red[warp] = v;
    asm volatile("bar.sync %0, %1;" ::"r"(bar), "r"(WARPS * 32) : "memory");
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) t = __fadd_rn(t, red[w]);
    return t;
  }
}

template <typename T, int TPR, bool VECTOR>
__global__ void __launch_bounds__(TPR > BLOCK ? TPR : BLOCK)
    fused_norm_kernel(NormArgs a) {
  constexpr int THREADS = TPR > BLOCK ? TPR : BLOCK;
  constexpr int GROUPS = THREADS / TPR;     // rows a block holds
  constexpr int WARPS = TPR / 32;           // warps a row
  constexpr int VEC = VECTOR ? 16 / (int)sizeof(T) : 1;
  constexpr int SLOTS = EPT / VEC;
  // two exchange buffers a row (mean, variance): a warp that runs ahead
  // into the next row writes the buffer the others have finished reading
  __shared__ float red[GROUPS][2][WARPS];
  const int g = threadIdx.x / TPR, t = threadIdx.x % TPR;
  const int bar = 1 + g;                    // 0 is __syncthreads'
  const int d = a.d;
  const T* x = static_cast<const T*>(a.x);
  const T* res = static_cast<const T*>(a.residual);
  T* out = static_cast<T*>(a.out);
  T* new_res = static_cast<T*>(a.new_residual);

  const uint32_t seed_mix = lowbias32(a.seed);
  const long long stride = (long long)gridDim.x * GROUPS;
  long long row = (long long)blockIdx.x * GROUPS + g;
  Pack<T, VEC> xr[SLOTS], rr[SLOTS];
  if (row < a.rows) load_row<TPR>(xr, rr, x, res, (size_t)row * d, t, d);

  // weight and bias in fp32, once a block (2 d floats of dynamic shared
  // memory), while the first row is in flight: registers are kept for the
  // rows
  extern __shared__ __align__(16) float wb[];
  for (int c = threadIdx.x; c < d; c += THREADS) {
    wb[c] = load_w(a.weight, c, a.wbf16);
    wb[d + c] = load_w(a.bias, c, a.wbf16);
  }
  __syncthreads();

  while (row < a.rows) {
    const size_t base = (size_t)row * d;
    const uint32_t idx0 = (uint32_t)row * (uint32_t)d;   // wraps mod 2^32
    float v[EPT];
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < SLOTS; ++k) {
      const int c = (k * TPR + t) * VEC;
      Pack<T, VEC> nr;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float xv = dropout(to_float(xr[k].e[e]), idx0 + (uint32_t)(c + e),
                                 seed_mix, a);
        const float r = __fadd_rn(to_float(rr[k].e[e]), xv);
        v[k * VEC + e] = c < d ? r : 0.f;
        sum = __fadd_rn(sum, v[k * VEC + e]);
        from_float(nr.e[e], r);
      }
      if (c < d) store_pack(new_res + base + c, nr);
    }
    const long long next = row + stride;
    if (next < a.rows)   // in flight while this row is reduced and stored
      load_row<TPR>(xr, rr, x, res, (size_t)next * d, t, d);
    const float mean = __fdiv_rn(row_sum<WARPS>(sum, red[g][0], bar), (float)d);
    float sq = 0.f;
#pragma unroll
    for (int k = 0; k < SLOTS; ++k) {
      const int c = (k * TPR + t) * VEC;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float cv = __fsub_rn(v[k * VEC + e], mean);
        if (c < d) sq = __fadd_rn(sq, __fmul_rn(cv, cv));
      }
    }
    const float var = __fdiv_rn(row_sum<WARPS>(sq, red[g][1], bar), (float)d);
    const float inv = rsqrtf(__fadd_rn(var, a.eps));
#pragma unroll
    for (int k = 0; k < SLOTS; ++k) {
      const int c = (k * TPR + t) * VEC;
      if (c < d) {
        float w[VEC], b[VEC];
        load_affine<VEC>(w, wb + c);
        load_affine<VEC>(b, wb + d + c);
        Pack<T, VEC> o;
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float cv = __fsub_rn(v[k * VEC + e], mean);
          from_float(o.e[e],
                     __fadd_rn(__fmul_rn(__fmul_rn(cv, inv), w[e]), b[e]));
        }
        store_pack(out + base + c, o);
      }
    }
    row = next;
  }
}

// Sum of v over the block; every thread gets the total. `red` holds
// SMEM_WARPS floats; the trailing barrier lets the caller reuse it.
__device__ __forceinline__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = 0.f;
  for (int w = 0; w < SMEM_WARPS; ++w) t += red[w];
  __syncthreads();
  return t;
}

// Rows wider than MAX_REG_D: a block a row, its fp32 sum r in shared memory
// between the passes, element by element at a stride of the block.
template <typename T>
__global__ void __launch_bounds__(SMEM_THREADS)
    fused_norm_smem_kernel(NormArgs a) {
  extern __shared__ __align__(16) float row_sum_smem[];   // (d,) fp32
  __shared__ float red[SMEM_WARPS];
  const int row = blockIdx.x;
  const size_t base = (size_t)row * a.d;
  const T* x = static_cast<const T*>(a.x) + base;
  const T* res = static_cast<const T*>(a.residual) + base;
  T* new_res = static_cast<T*>(a.new_residual) + base;
  const uint32_t seed_mix = lowbias32(a.seed);
  const uint32_t idx0 = (uint32_t)row * (uint32_t)a.d;   // wraps mod 2^32

  float sum = 0.f;
  for (int c = threadIdx.x; c < a.d; c += SMEM_THREADS) {
    const float xv = dropout(to_float(x[c]), idx0 + (uint32_t)c, seed_mix, a);
    const float r = __fadd_rn(to_float(res[c]), xv);
    from_float(new_res[c], r);
    row_sum_smem[c] = r;
    sum += r;
  }
  const float mean = block_sum(sum, red) / (float)a.d;
  float sq = 0.f;
  for (int c = threadIdx.x; c < a.d; c += SMEM_THREADS) {
    const float cv = row_sum_smem[c] - mean;
    sq += cv * cv;
  }
  const float var = block_sum(sq, red) / (float)a.d;
  const float inv = rsqrtf(var + a.eps);
  T* out = static_cast<T*>(a.out) + base;
  for (int c = threadIdx.x; c < a.d; c += SMEM_THREADS) {
    const float cv = row_sum_smem[c] - mean;
    from_float(out[c], cv * inv * load_w(a.weight, c, a.wbf16) +
                           load_w(a.bias, c, a.wbf16));
  }
}

template <typename T, int TPR, bool VECTOR>
cudaError_t launch_rows(const NormArgs& a, cudaStream_t stream) {
  constexpr int THREADS = TPR > BLOCK ? TPR : BLOCK;
  constexpr int GROUPS = THREADS / TPR;
  auto kernel = fused_norm_kernel<T, TPR, VECTOR>;
  const size_t smem = 2 * sizeof(float) * (size_t)a.d;   // weight, bias
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS,
                                                      smem);
  if (err != cudaSuccess) return err;
  const long long fit =
      (long long)sm90::sm_count() * (per_sm > 0 ? per_sm : 1);
  const long long need = (a.rows + GROUPS - 1) / GROUPS;
  const long long blocks = need < fit ? need : fit;
  if (blocks <= 0) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

// the least threads a row that hold it at EPT elements a thread
template <typename T, bool VECTOR>
cudaError_t launch_width(const NormArgs& a, cudaStream_t stream) {
  if (a.d <= 32 * EPT) return launch_rows<T, 32, VECTOR>(a, stream);
  if (a.d <= 64 * EPT) return launch_rows<T, 64, VECTOR>(a, stream);
  if (a.d <= 128 * EPT) return launch_rows<T, 128, VECTOR>(a, stream);
  if (a.d <= 256 * EPT) return launch_rows<T, 256, VECTOR>(a, stream);
  return launch_rows<T, 512, VECTOR>(a, stream);
}

template <typename T>
cudaError_t launch_smem(const NormArgs& a, cudaStream_t stream) {
  auto kernel = fused_norm_smem_kernel<T>;
  const size_t bytes = sizeof(float) * (size_t)a.d;
  if (bytes > MAX_SMEM - SMEM_WARPS * sizeof(float))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  kernel<<<a.rows, SMEM_THREADS, bytes, stream>>>(a);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T>
cudaError_t dispatch(const NormArgs& a, cudaStream_t stream) {
  if (a.d > MAX_REG_D) return launch_smem<T>(a, stream);
  const bool vector = a.d * sizeof(T) % 16 == 0 && aligned16(a.x) &&
                      aligned16(a.residual) && aligned16(a.out) &&
                      aligned16(a.new_residual);
  return vector ? launch_width<T, true>(a, stream)
                : launch_width<T, false>(a, stream);
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// All tensors contiguous. dtype (x, residual and both outputs) and wdtype
// (weight and bias): 0 fp32, 1 bf16. The int32 seed is reinterpreted as
// uint32; scale is 1/(1-p) rounded to fp32 by the caller.
int fused_norm_launch(const void* x, const void* residual, const void* weight,
                      const void* bias, void* out, void* new_residual,
                      int rows, int d, int seed, float p, float scale,
                      float eps, int dtype, int wdtype, void* stream) {
  if (rows <= 0 || d <= 0 || (wdtype != 0 && wdtype != 1))
    return cudaErrorInvalidValue;
  NormArgs a;
  a.x = x;
  a.residual = residual;
  a.weight = weight;
  a.bias = bias;
  a.out = out;
  a.new_residual = new_residual;
  a.rows = rows;
  a.d = d;
  a.seed = (uint32_t)seed;
  a.p = p;
  a.scale = scale;
  a.eps = eps;
  a.wbf16 = wdtype;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(a, st);
  if (dtype == 1) return dispatch<__nv_bfloat16>(a, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"

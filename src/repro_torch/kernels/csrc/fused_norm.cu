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
// keeps everything but those four streams out of device memory: the mask is
// hashed in registers, and each block owns whole rows, holding the row's
// fp32 sum r in shared memory between the passes (d x 4 bytes: 8 KB at d =
// 2048), so the row is read from device memory once. Threads walk the row
// at a stride of the block, so every load and store is coalesced; the two
// row reductions are a warp shuffle tree and one shared-memory pass.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_SMEM = 232448;   // what a block can use on an H100

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
};

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ uint32_t lowbias32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// Sum of v over the block; every thread gets the total. `red` holds WARPS
// floats; the trailing barrier lets the caller reuse it.
__device__ __forceinline__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = 0.f;
  for (int w = 0; w < WARPS; ++w) t += red[w];
  __syncthreads();
  return t;
}

template <typename T, typename W>
__global__ void __launch_bounds__(THREADS) fused_norm_kernel(NormArgs a) {
  extern __shared__ __align__(16) float row_sum[];   // (d,) fp32
  __shared__ float red[WARPS];
  const int row = blockIdx.x;
  const size_t base = (size_t)row * a.d;
  const T* x = static_cast<const T*>(a.x) + base;
  const T* res = static_cast<const T*>(a.residual) + base;
  T* new_res = static_cast<T*>(a.new_residual) + base;
  const uint32_t seed_mix = lowbias32(a.seed);
  const uint32_t idx0 = (uint32_t)row * (uint32_t)a.d;   // wraps mod 2^32

  float sum = 0.f;
  for (int c = threadIdx.x; c < a.d; c += THREADS) {
    float xv = load(x + c);
    if (a.p > 0.f) {
      const uint32_t bits = lowbias32((idx0 + (uint32_t)c) ^ seed_mix);
      const float u = (float)(bits >> 8) * (1.0f / 16777216.0f);
      xv = u >= a.p ? __fmul_rn(xv, a.scale) : 0.f;
    }
    const float r = __fadd_rn(load(res + c), xv);
    store(new_res + c, r);
    row_sum[c] = r;
    sum += r;
  }
  const float mean = block_sum(sum, red) / (float)a.d;
  float sq = 0.f;
  for (int c = threadIdx.x; c < a.d; c += THREADS) {
    const float cv = row_sum[c] - mean;
    sq += cv * cv;
  }
  const float var = block_sum(sq, red) / (float)a.d;
  const float inv = rsqrtf(var + a.eps);
  const W* w = static_cast<const W*>(a.weight);
  const W* b = static_cast<const W*>(a.bias);
  T* out = static_cast<T*>(a.out) + base;
  for (int c = threadIdx.x; c < a.d; c += THREADS) {
    const float cv = row_sum[c] - mean;
    store(out + c, cv * inv * load(w + c) + load(b + c));
  }
}

template <typename T, typename W>
cudaError_t launch(const NormArgs& a, cudaStream_t stream) {
  auto kernel = fused_norm_kernel<T, W>;
  const size_t bytes = sizeof(float) * (size_t)a.d;
  if (bytes > MAX_SMEM - WARPS * sizeof(float)) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  kernel<<<a.rows, THREADS, bytes, stream>>>(a);
  return cudaGetLastError();
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
  if (rows <= 0 || d <= 0) return cudaErrorInvalidValue;
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && wdtype == 0) return launch<float, float>(a, st);
  if (dtype == 0 && wdtype == 1) return launch<float, __nv_bfloat16>(a, st);
  if (dtype == 1 && wdtype == 0) return launch<__nv_bfloat16, float>(a, st);
  if (dtype == 1 && wdtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(a, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"

// Rotate-half rotary position embedding for Hopper.
//
// Replaces the TPU kernel `_rope_kernel` (src/repro/kernels/rope/kernel.py),
// launched there by `rope_pallas`: out = x * cos + rotate_half(x) * sin, with
// rotate_half(x) = [-x2, x1] over the two halves of the head dim, computed in
// fp32 and stored in x's type. sin and cos are the (S, D) fp32 tables with
// duplicated halves. The backward of the op is this kernel again with the
// sine negated (`sin_sign` = -1): the rotation is orthogonal, so its
// transpose is the rotation by -theta (src/repro/kernels/rope/ops.py:27-29).
//
// What bounds it on an H100: bytes. Each x element is read once and each
// output element written once, 6 operations per pair against 2 x 2 bytes
// (bf16): far below the ~295 operations a byte the card needs before its
// arithmetic is the limit. The design: one thread per (x1, x2) pair of one
// (s, j) position of the (S, D/2) plane; the thread reads its four table
// values once into registers and reuses them for every (b, h) it visits
// (grid.y blocks stride over B x H), so the tables cost S x D x 8 bytes per
// grid.y row instead of per head. x is read through its strides (q and k are
// transposed views of the (B, S, H x D) projection output, last dim
// contiguous), so no copy is made; the output is written contiguous. A warp
// covers 32 neighbouring pairs of one row: both halves' loads and stores are
// coalesced. The products and the sum are rounded separately
// (__fmul_rn/__fadd_rn, no fused multiply-add), as the plain version rounds
// them.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

struct RopeArgs {
  const void* x;        // (B, H, S, D), strides below, last dim contiguous
  const float* sin;     // (S, D) contiguous
  const float* cos;     // (S, D) contiguous
  void* out;            // (B, H, S, D) contiguous
  int b, h, s, d;
  long long sb, sh, ss; // x's strides in elements
  float sin_sign;       // +1 forward, -1 backward
};

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS) rope_kernel(RopeArgs a) {
  const int half = a.d / 2;
  const long long pair = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (pair >= (long long)a.s * half) return;
  const int s = (int)(pair / half), j = (int)(pair % half);
  const float* sr = a.sin + (size_t)s * a.d;
  const float* cr = a.cos + (size_t)s * a.d;
  const float c1 = cr[j], c2 = cr[j + half];
  const float s1 = a.sin_sign * sr[j], s2 = a.sin_sign * sr[j + half];
  const T* x = static_cast<const T*>(a.x);
  T* out = static_cast<T*>(a.out);
  for (int bh = blockIdx.y; bh < a.b * a.h; bh += gridDim.y) {
    const int b = bh / a.h, h = bh % a.h;
    const T* xr = x + b * a.sb + h * a.sh + s * a.ss;
    const float x1 = load(xr + j), x2 = load(xr + j + half);
    T* o = out + (((size_t)b * a.h + h) * a.s + s) * a.d;
    store(o + j, __fadd_rn(__fmul_rn(x1, c1), __fmul_rn(-x2, s1)));
    store(o + j + half, __fadd_rn(__fmul_rn(x2, c2), __fmul_rn(x1, s2)));
  }
}

template <typename T>
cudaError_t launch(const RopeArgs& a, cudaStream_t stream) {
  const long long pairs = (long long)a.s * (a.d / 2);
  const long long tiles = (pairs + THREADS - 1) / THREADS;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  // enough blocks for ~8 waves of 132 SMs; each block's table values are
  // reused across the (b, h) rows its grid.y index visits
  const long long want = (8LL * 132 + tiles - 1) / tiles;
  const int rows = (int)(want < a.b * a.h ? want : a.b * a.h);
  dim3 grid((unsigned)tiles, rows > 65535 ? 65535 : rows);
  rope_kernel<T><<<grid, THREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype 0: fp32, 1: bf16 (x and out alike). D even; strides in elements.
int rope_launch(const void* x, const void* sin, const void* cos, void* out,
                int batch, int heads, int seq, int head_dim, long long sb,
                long long sh, long long ss, float sin_sign, int dtype,
                void* stream) {
  if (head_dim <= 0 || head_dim % 2 || batch <= 0 || heads <= 0 || seq <= 0)
    return cudaErrorInvalidValue;
  RopeArgs a;
  a.x = x;
  a.sin = static_cast<const float*>(sin);
  a.cos = static_cast<const float*>(cos);
  a.out = out;
  a.b = batch;
  a.h = heads;
  a.s = seq;
  a.d = head_dim;
  a.sb = sb;
  a.sh = sh;
  a.ss = ss;
  a.sin_sign = sin_sign;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, st);
  if (dtype == 1) return launch<__nv_bfloat16>(a, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"

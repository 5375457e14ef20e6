// Rotate-half rotary position embedding for Hopper.
//
// Replaces the TPU kernel `_rope_kernel` (src/repro/kernels/rope/kernel.py),
// launched there by `rope_pallas`: out = x * cos + rotate_half(x) * sin, with
// rotate_half(x) = [-x2, x1] over the two halves of the head dim, computed in
// fp32 and stored in x's type. sin and cos are (S, D) fp32 tables; the kernel
// reads both halves of each and does not assume they are equal. The backward
// of the op is this kernel again with the sine negated (`sin_sign` = -1): the
// rotation is orthogonal, so its transpose is the rotation by -theta
// (src/repro/kernels/rope/ops.py:27-29).
//
// What bounds it on an H100: bytes. Each x element is read once and each
// output element written once, 6 operations per pair against 2 x 2 bytes
// (bf16): far below the ~295 operations a byte the card needs before its
// arithmetic is the limit. So the design is a streaming one that keeps
// enough bytes in flight to cover the DRAM latency (3.35 TB/s x ~0.7 us
// over 132 SMs is 16-24 KB an SM):
//
// - A thread owns VEC consecutive elements (16 bytes: 8 bf16 or 4 fp32) of
//   the first half of a (b, h, s) row and the same VEC of the second half,
//   so the rotation needs no exchange. Where the row length, x's strides
//   and the pointers are 16-byte aligned these are single 16-byte loads and
//   stores; otherwise the same kernel, instantiated with VECTOR = false,
//   moves them one element at a time (a view at an odd offset).
// - Threads are laid out in memory order. A block is `rp` row lanes of `nv`
//   threads (nv = vectors in half a row); lane i of a block takes rows
//   i, i + rp, i + 2 rp, ... of a unit, and rows are (b, h) with h fastest.
//   q and k are transposed views of the (B, S, (H + Hkv) x D) projection
//   output, so for one (b, s) the heads lie next to each other: each load
//   instruction of a warp covers 8 heads' halves of one such run (512
//   bytes in bf16 at D 64), and the stores fill whole 128-byte rows of the
//   contiguous (B, H, S, D) output.
// - A unit is one position s and up to UNROLL x rp of its B x H rows (all
//   of them at the main-path shapes). The thread loads its table vectors
//   for s once into registers and reuses them for every row of the unit,
//   then issues the loads of all its UNROLL rows before it uses the first.
// - The grid is persistent: as many blocks as the card's SMs hold at the
//   block's occupancy (cudaOccupancyMaxActiveBlocksPerMultiprocessor), each
//   taking every gridDim-th unit. Indices are 32-bit: a 64-bit division
//   before the first load costs a latency-bound launch its time.
// The products and the sum are rounded separately (__fmul_rn/__fadd_rn, no
// fused multiply-add), as the plain version rounds them, so the result is
// the plain version's bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_sm90.cuh"   // sm90::sm_count

namespace {

constexpr int UNROLL = 4;      // rows a thread loads before it uses one
constexpr int THREADS = 256;   // the most threads a block: nv x rp

struct RopeArgs {
  const void* x;        // (B, H, S, D), strides below, last dim contiguous
  const float* sin;     // (S, D) contiguous
  const float* cos;     // (S, D) contiguous
  void* out;            // (B, H, S, D) contiguous
  int b, h, s, d;
  long long sb, sh, ss; // x's strides in elements
  float sin_sign;       // +1 forward, -1 backward
};

struct Plan {
  int nv;       // threads a row: vectors of VEC elements in half a row
  int rp;       // row lanes a block
  int chunks;   // units a position
  int units;    // positions x chunks
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_float(float& o, float v) { o = v; }
__device__ __forceinline__ void from_float(__nv_bfloat16& o, float v) {
  o = __float2bfloat16_rn(v);
}

// VEC elements of T: one 16-byte vector
template <typename T>
struct alignas(16) Pack {
  static constexpr int VEC = 16 / sizeof(T);
  T e[VEC];
};

// Loads `n` (<= VEC) elements at p into pk: one 16-byte load where VECTOR.
template <bool VECTOR, typename T>
__device__ __forceinline__ void load_pack(Pack<T>& pk, const T* p, int n) {
  if constexpr (VECTOR) {
    *reinterpret_cast<uint4*>(&pk) = __ldg(reinterpret_cast<const uint4*>(p));
  } else {
#pragma unroll
    for (int e = 0; e < Pack<T>::VEC; ++e)
      if (e < n) pk.e[e] = p[e];
  }
}

template <bool VECTOR, typename T>
__device__ __forceinline__ void store_pack(T* p, const Pack<T>& pk, int n) {
  if constexpr (VECTOR) {
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(&pk);
  } else {
#pragma unroll
    for (int e = 0; e < Pack<T>::VEC; ++e)
      if (e < n) p[e] = pk.e[e];
  }
}

// VEC fp32 table values at p (n of them valid)
template <bool VECTOR, int VEC>
__device__ __forceinline__ void load_table(float (&t)[VEC], const float* p,
                                           int n, float sign) {
  if constexpr (VECTOR) {
#pragma unroll
    for (int i = 0; i < VEC; i += 4) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(p + i));
      t[i] = sign * v.x;
      t[i + 1] = sign * v.y;
      t[i + 2] = sign * v.z;
      t[i + 3] = sign * v.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) t[e] = e < n ? sign * __ldg(p + e) : 0.f;
  }
}

template <typename T, bool VECTOR>
__global__ void __launch_bounds__(THREADS) rope_kernel(RopeArgs a, Plan plan) {
  constexpr int VEC = Pack<T>::VEC;
  const int half = a.d / 2;
  const int rows = a.b * a.h;
  const int j = threadIdx.x % plan.nv;      // this thread's vector of a half
  const int lane = threadIdx.x / plan.nv;   // this thread's row lane
  const int col = j * VEC;
  const int n = min(VEC, half - col);       // < VEC only without VECTOR
  const T* x = static_cast<const T*>(a.x);
  T* out = static_cast<T*>(a.out);
  for (int u = blockIdx.x; u < plan.units; u += gridDim.x) {
    const int s = u / plan.chunks;
    const int row0 = (u - s * plan.chunks) * plan.rp * UNROLL + lane;
    float c1[VEC], c2[VEC], s1[VEC], s2[VEC];   // the position's, once
    const float* sr = a.sin + (size_t)s * a.d + col;
    const float* cr = a.cos + (size_t)s * a.d + col;
    load_table<VECTOR, VEC>(c1, cr, n, 1.f);
    load_table<VECTOR, VEC>(c2, cr + half, n, 1.f);
    load_table<VECTOR, VEC>(s1, sr, n, a.sin_sign);
    load_table<VECTOR, VEC>(s2, sr + half, n, a.sin_sign);
    Pack<T> lo[UNROLL], hi[UNROLL];
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {   // every load before the first use
      const int r = row0 + k * plan.rp;
      if (r < rows) {
        const T* xr = x + (long long)(r / a.h) * a.sb +
                      (long long)(r % a.h) * a.sh + (long long)s * a.ss + col;
        load_pack<VECTOR>(lo[k], xr, n);
        load_pack<VECTOR>(hi[k], xr + half, n);
      }
    }
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const int r = row0 + k * plan.rp;
      if (r < rows) {
        Pack<T> o1, o2;
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float x1 = to_float(lo[k].e[e]), x2 = to_float(hi[k].e[e]);
          from_float(o1.e[e], __fadd_rn(__fmul_rn(x1, c1[e]),
                                        __fmul_rn(-x2, s1[e])));
          from_float(o2.e[e], __fadd_rn(__fmul_rn(x2, c2[e]),
                                        __fmul_rn(x1, s2[e])));
        }
        T* o = out + ((size_t)r * a.s + s) * a.d + col;
        store_pack<VECTOR>(o, o1, n);
        store_pack<VECTOR>(o + half, o2, n);
      }
    }
  }
}

template <typename T, bool VECTOR>
cudaError_t launch(const RopeArgs& a, cudaStream_t stream) {
  constexpr int VEC = Pack<T>::VEC;
  const int half = a.d / 2;
  const int rows = a.b * a.h;
  Plan plan;
  plan.nv = (half + VEC - 1) / VEC;
  if (plan.nv > THREADS) return cudaErrorInvalidValue;
  // rp row lanes: enough that UNROLL rows a lane cover a position's rows,
  // within THREADS threads
  const int most = THREADS / plan.nv;
  const int want = (rows + UNROLL - 1) / UNROLL;
  plan.rp = want < most ? want : most;
  plan.chunks = (rows + plan.rp * UNROLL - 1) / (plan.rp * UNROLL);
  if ((long long)a.s * plan.chunks > 0x7fffffffLL) return cudaErrorInvalidValue;
  plan.units = a.s * plan.chunks;
  const int threads = plan.nv * plan.rp;
  auto kernel = rope_kernel<T, VECTOR>;
  int per_sm = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, threads, 0);
  if (err != cudaSuccess) return err;
  const long long fit =
      (long long)sm90::sm_count() * (per_sm > 0 ? per_sm : 1);
  const long long blocks = plan.units < fit ? plan.units : fit;
  if (blocks <= 0) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, threads, 0, stream>>>(a, plan);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T>
cudaError_t dispatch(const RopeArgs& a, cudaStream_t stream) {
  const long long es = sizeof(T);
  const bool vector = (a.d / 2) * es % 16 == 0 && aligned16(a.x) &&
                      aligned16(a.out) && aligned16(a.sin) &&
                      aligned16(a.cos) && a.sb * es % 16 == 0 &&
                      a.sh * es % 16 == 0 && a.ss * es % 16 == 0;
  return vector ? launch<T, true>(a, stream) : launch<T, false>(a, stream);
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
  if (dtype == 0) return dispatch<float>(a, st);
  if (dtype == 1) return dispatch<__nv_bfloat16>(a, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"

// Flash-attention forward for Hopper: causal / windowed MHA and GQA.
//
// Replaces the TPU kernel `_fwd_kernel` (src/repro/kernels/attention/
// kernel_fwd.py), launched there by `_flash_fwd`. Same math: scores
// s = (q . k) * d^-0.5 in fp32, an optional tanh soft cap before masking,
// masked entries at -1e30, an online softmax whose running (m, l) live in
// fp32, p rounded to the value type before p @ v (kernel_fwd.py:101), and a
// store of out = acc / l and lse = m + log(l) (l == 0 guarded). Sinks are not
// taken (the wrapper raises).
//
// What bounds it on an H100: at the prefill shape of llama-1b (B 4, H 32,
// S 256, d 64) neither side is large: about 2.3 GFLOP of causal products and
// 10 MB of q/k/v/out, a few microseconds either way, so launch and per-tile
// latency dominate. The design is the simple one: one block of 4 warps per
// (q-tile of 64 rows, head, batch), a loop over 64-row K/V tiles up to the
// causal horizon, WMMA bf16 products into fp32 fragments staged through
// shared memory, and each warp owning 16 query rows for the softmax and the
// rescaled fp32 output kept in registers. The KV head of query head h is
// h / group. q, k and v are read through their strides, so the model passes
// views of the projection output without a copy.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BQ = 64;
constexpr int BKV = 64;
constexpr int WARPS = 4;        // 16 query rows per warp
constexpr int THREADS = 32 * WARPS;
constexpr float MASK_VALUE = -1e30f;

struct FwdArgs {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* out;   // (B, H, Sq, D) contiguous
  float* lse;           // (B, H, Sq)
  long long qs_b, qs_h, qs_s;
  long long ks_b, ks_h, ks_s;
  long long vs_b, vs_h, vs_s;
  int h, hkv, sq, skv;
  float scale, softcap;
  int causal, window;   // window <= 0: none
};

template <int D>
struct FwdSmem {
  static constexpr int LDQ = D + 8;     // bf16 q/k/v rows
  static constexpr int LDS = BKV + 4;   // fp32 scores
  static constexpr int LDP = BKV + 8;   // bf16 probabilities
  static constexpr int LDO = D + 4;     // fp32 p @ v
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_OFF + BQ * LDQ * 2;
  static constexpr int V_OFF = K_OFF + BKV * LDQ * 2;
  static constexpr int S_OFF = V_OFF + BKV * LDQ * 2;
  static constexpr int P_OFF = S_OFF + BQ * LDS * 4;
  static constexpr int O_OFF = P_OFF + BQ * LDP * 2;
  static constexpr int BYTES = O_OFF + BQ * LDO * 4;
};

// rows x D bf16 tile from a strided (rows, D) view into shared memory; rows
// at or past `limit` are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long row_stride, int row0,
                                          int rows, int limit) {
  constexpr int VPR = D / 8;  // 16-byte vectors per row
  for (int v = threadIdx.x; v < rows * VPR; v += THREADS) {
    const int r = v / VPR, c = (v % VPR) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < limit)
      val = *reinterpret_cast<const uint4*>(src + (row0 + r) * row_stride + c);
    *reinterpret_cast<uint4*>(dst + r * FwdSmem<D>::LDQ + c) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(FwdArgs p) {
  using L = FwdSmem<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem + L::Q_OFF);
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem + L::K_OFF);
  __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(smem + L::V_OFF);
  float* ss = reinterpret_cast<float*>(smem + L::S_OFF);
  __nv_bfloat16* ps = reinterpret_cast<__nv_bfloat16*>(smem + L::P_OFF);
  float* os = reinterpret_cast<float*>(smem + L::O_OFF);

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.h / p.hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = warp * 16;  // this warp's first row in the tile
  constexpr int CPL = D / 32;  // output columns per lane: lane + 32 * j

  const __nv_bfloat16* qg = p.q + b * p.qs_b + h * p.qs_h;
  const __nv_bfloat16* kg = p.k + b * p.ks_b + hk * p.ks_h;
  const __nv_bfloat16* vg = p.v + b * p.vs_b + hk * p.vs_h;
  load_tile<D>(qs, qg, p.qs_s, q0, BQ, p.sq);

  float m[16], l[16], o[16][CPL];
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    m[r] = MASK_VALUE;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < CPL; ++j) o[r][j] = 0.f;
  }

  int kv_end = p.skv;
  if (p.causal) kv_end = min(kv_end, q0 + BQ);
  for (int kv0 = 0; kv0 < kv_end; kv0 += BKV) {
    // the tile skip rule of the reference: wholly outside the window
    if (p.window > 0 && q0 - (kv0 + BKV - 1) >= p.window) continue;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<D>(ks, kg, p.ks_s, kv0, BKV, p.skv);
    load_tile<D>(vs, vg, p.vs_s, kv0, BKV, p.skv);
    __syncthreads();

    // s = q k^T for this warp's 16 rows: K stored (kv, d) row-major is
    // k^T in column-major order.
#pragma unroll
    for (int jn = 0; jn < BKV / 16; ++jn) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < D; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb;
        wmma::load_matrix_sync(fa, qs + row0 * L::LDQ + kk, L::LDQ);
        wmma::load_matrix_sync(fb, ks + jn * 16 * L::LDQ + kk, L::LDQ);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(ss + row0 * L::LDS + jn * 16, acc, L::LDS,
                              wmma::mem_row_major);
    }
    __syncwarp();

    float alpha[16];
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int qpos = q0 + row0 + r;
      float sv[2];
      bool ok[2];
      float mx = MASK_VALUE;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int c = lane + 32 * t, kpos = kv0 + c;
        float s = ss[(row0 + r) * L::LDS + c] * p.scale;
        if (p.softcap > 0.f) s = p.softcap * tanhf(s / p.softcap);
        ok[t] = kpos < p.skv && (!p.causal || qpos >= kpos) &&
                (p.window <= 0 || qpos - kpos < p.window);
        sv[t] = ok[t] ? s : MASK_VALUE;
        mx = fmaxf(mx, sv[t]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      alpha[r] = expf(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const float pv = ok[t] ? expf(sv[t] - m_new) : 0.f;
        sum += pv;
        ps[(row0 + r) * L::LDP + lane + 32 * t] = __float2bfloat16_rn(pv);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[r] = l[r] * alpha[r] + sum;
      m[r] = m_new;
    }
    __syncwarp();

    // p @ v for this warp's rows, then acc = acc * alpha + p @ v
#pragma unroll
    for (int jd = 0; jd < D / 16; ++jd) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < BKV; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, ps + row0 * L::LDP + kk, L::LDP);
        wmma::load_matrix_sync(fb, vs + kk * L::LDQ + jd * 16, L::LDQ);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(os + row0 * L::LDO + jd * 16, acc, L::LDO,
                              wmma::mem_row_major);
    }
    __syncwarp();
#pragma unroll
    for (int r = 0; r < 16; ++r)
#pragma unroll
      for (int j = 0; j < CPL; ++j)
        o[r][j] = o[r][j] * alpha[r] + os[(row0 + r) * L::LDO + lane + 32 * j];
  }

  const size_t bh = (size_t)b * p.h + h;
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int qrow = q0 + row0 + r;
    if (qrow >= p.sq) break;
    const float l_safe = l[r] == 0.f ? 1.f : l[r];
    __nv_bfloat16* orow = p.out + (bh * p.sq + qrow) * D;
#pragma unroll
    for (int j = 0; j < CPL; ++j)
      orow[lane + 32 * j] = __float2bfloat16_rn(o[r][j] / l_safe);
    if (lane == 0) p.lse[bh * p.sq + qrow] = m[r] + logf(l_safe);
  }
}

template <int D>
cudaError_t launch(const FwdArgs& p, int batch, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, FwdSmem<D>::BYTES);
  if (err != cudaSuccess) return err;
  dim3 grid((p.sq + BQ - 1) / BQ, p.h, batch);
  kernel<<<grid, THREADS, FwdSmem<D>::BYTES, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Strides are in elements; the last dim of q, k and v is contiguous.
// head_dim must be 64 or 128 (the wrapper checks); returns
// cudaErrorInvalidValue otherwise.
int flash_fwd_launch(const void* q, const void* k, const void* v, void* out,
                     void* lse, int batch, int h, int hkv, int sq, int skv,
                     int head_dim, long long qs_b, long long qs_h,
                     long long qs_s, long long ks_b, long long ks_h,
                     long long ks_s, long long vs_b, long long vs_h,
                     long long vs_s, float scale, float softcap, int causal,
                     int window, void* stream) {
  FwdArgs p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.lse = static_cast<float*>(lse);
  p.qs_b = qs_b; p.qs_h = qs_h; p.qs_s = qs_s;
  p.ks_b = ks_b; p.ks_h = ks_h; p.ks_s = ks_s;
  p.vs_b = vs_b; p.vs_h = vs_h; p.vs_s = vs_s;
  p.h = h; p.hkv = hkv; p.sq = sq; p.skv = skv;
  p.scale = scale; p.softcap = softcap;
  p.causal = causal; p.window = window;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) return launch<64>(p, batch, st);
  if (head_dim == 128) return launch<128>(p, batch, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"

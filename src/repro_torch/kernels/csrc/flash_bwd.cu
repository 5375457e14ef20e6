// Flash-attention backward for Hopper: causal / windowed MHA and GQA, in two
// passes, one __global__ each.
//
// Replaces the TPU kernels `_dq_kernel` and `_dkv_kernel`
// (src/repro/kernels/attention/kernel_bwd.py), launched there by
// `_flash_bwd`. Same math: p is recomputed from the forward's saved fp32
// lse, p = exp(s - lse) with s = (q . k) * d^-0.5, soft-capped as in the
// forward when a cap is set; masked entries (causal, window, and rows or
// columns past the lengths) contribute nothing; delta = rowsum(dO . O) comes
// from a plain torch preprocess, as in the reference;
//   ds = p (dp - delta) (1 - tanh^2(s_raw / cap)) d^-0.5,  dp = dO . v;
//   pass 0 (dq):   dq = sum over key tiles of ds @ k;
//   pass 1 (dk/dv): dv = sum p^T @ dO, dk = sum ds^T @ q.
// The tensor cores take bf16 operands: p and ds are rounded to bf16 before
// their products (the TPU kernels contract them in fp32); every accumulator
// is fp32. GQA: the reference computes dk/dv per query head and its caller
// sums each group; here one block of the dk/dv pass walks all the query heads
// of its key head and sums the group in its fp32 accumulators, so dk and dv
// are written once, per key head, rounded once.
//
// What bounds it on an H100: at the training shape of llama-1b (B 4, H 32,
// Hkv 8, S 1024, d 64, causal) the five products per (q, k) pair, about 43
// GFLOP of bf16 tensor-core work (43 us at 989 TFLOP/s) against about 40 MB
// of q, k, v, dO, lse, delta and gradients over HBM (12 us at 3.35 TB/s).
// The design is the forward's simple one: blocks of 4 warps, 64-row q and
// key tiles, WMMA 16x16x16 bf16 fragments with fp32 scores staged through
// shared memory, each warp owning 16 rows; the dq pass runs one block per
// (q tile, head, batch) over the key tiles up to the causal horizon, the
// dk/dv pass one block per (key tile, key head, batch) over the q tiles from
// the diagonal on. q, k, v and dO are read through their strides, so views
// need no copy. No wgmma, TMA or warp specialisation yet.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BQ = 64;
constexpr int BKV = 64;
constexpr int WARPS = 4;        // 16 rows per warp
constexpr int THREADS = 32 * WARPS;

struct BwdArgs {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* dout;
  const float* lse;     // (B, H, Sq) contiguous
  const float* delta;   // (B, H, Sq) contiguous
  __nv_bfloat16* dq;    // (B, H, Sq, D) contiguous
  __nv_bfloat16* dk;    // (B, Hkv, Skv, D) contiguous
  __nv_bfloat16* dv;    // (B, Hkv, Skv, D) contiguous
  long long qs_b, qs_h, qs_s;
  long long ks_b, ks_h, ks_s;
  long long vs_b, vs_h, vs_s;
  long long os_b, os_h, os_s;   // dO
  int h, hkv, sq, skv;
  float scale, softcap;
  int causal, window;   // window <= 0: none
};

template <int D>
struct Smem {
  static constexpr int LDQ = D + 8;     // bf16 q/k/v/dO rows
  static constexpr int LDS = 64 + 4;    // fp32 scores (64 columns)
  static constexpr int LDP = 64 + 8;    // bf16 p / ds (64 columns)
  static constexpr int LDO = D + 4;     // fp32 staged gradient rows
  static constexpr int TILE = 64 * LDQ * 2;
  static constexpr int T0 = 0, T1 = TILE, T2 = 2 * TILE, T3 = 3 * TILE;
  static constexpr int S_OFF = 4 * TILE;               // fp32 scores
  static constexpr int DP_OFF = S_OFF + 64 * LDS * 4;  // fp32 dp
  static constexpr int P_OFF = DP_OFF + 64 * LDS * 4;  // bf16 p (dk/dv pass)
  static constexpr int DS_OFF = P_OFF + 64 * LDP * 2;  // bf16 ds
  static constexpr int VEC_OFF = DS_OFF + 64 * LDP * 2;  // fp32 lse, delta
  static constexpr int BYTES = VEC_OFF + 2 * 64 * 4;
  // the staged gradient tile reuses the score buffers after the last tile
  static_assert(64 * LDO * 4 <= 2 * 64 * LDS * 4, "staging fits");
};

template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long row_stride, int row0,
                                          int limit) {
  constexpr int VPR = D / 8;  // 16-byte vectors per row
  for (int v = threadIdx.x; v < 64 * VPR; v += THREADS) {
    const int r = v / VPR, c = (v % VPR) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < limit)
      val = *reinterpret_cast<const uint4*>(src + (row0 + r) * row_stride + c);
    *reinterpret_cast<uint4*>(dst + r * Smem<D>::LDQ + c) = val;
  }
}

__device__ __forceinline__ bool visible(const BwdArgs& p, int qpos, int kpos) {
  return qpos < p.sq && kpos < p.skv && (!p.causal || qpos >= kpos) &&
         (p.window <= 0 || qpos - kpos < p.window);
}

// (p, ds) of one score: p from the capped logit and the saved lse, ds with
// the soft cap's derivative and the logit scale.
__device__ __forceinline__ void p_and_ds(const BwdArgs& p, float s_dot,
                                         float dp, float lse, float delta,
                                         bool ok, float& pv, float& ds) {
  const float sr = s_dot * p.scale;
  float s = sr, factor = 1.f;
  if (p.softcap > 0.f) {
    const float th = tanhf(sr / p.softcap);
    s = p.softcap * th;
    factor = 1.f - th * th;
  }
  pv = ok ? expf(s - lse) : 0.f;
  ds = pv * (dp - delta) * factor * p.scale;
}

// Writes a warp's 16 fp32 rows of `stage` (ld LDO) as bf16 rows of `dst`.
template <int D>
__device__ __forceinline__ void write_rows(__nv_bfloat16* dst,
                                           const float* stage, int row0,
                                           int first, int limit) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    if (first + r >= limit) break;
#pragma unroll
    for (int j = 0; j < D / 32; ++j)
      dst[(size_t)(first + r) * D + lane + 32 * j] = __float2bfloat16_rn(
          stage[(row0 + r) * Smem<D>::LDO + lane + 32 * j]);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_kernel(BwdArgs p) {
  using L = Smem<D>;
  using Frag = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem + L::T0);
  __nv_bfloat16* dos = reinterpret_cast<__nv_bfloat16*>(smem + L::T1);
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem + L::T2);
  __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(smem + L::T3);
  float* ss = reinterpret_cast<float*>(smem + L::S_OFF);
  float* dps = reinterpret_cast<float*>(smem + L::DP_OFF);
  __nv_bfloat16* dss = reinterpret_cast<__nv_bfloat16*>(smem + L::DS_OFF);

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.h / p.hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = warp * 16;
  const size_t bh = (size_t)b * p.h + h;

  load_tile<D>(qs, p.q + b * p.qs_b + h * p.qs_h, p.qs_s, q0, p.sq);
  load_tile<D>(dos, p.dout + b * p.os_b + h * p.os_h, p.os_s, q0, p.sq);
  float lse_r[16], delta_r[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int qrow = q0 + row0 + r;
    lse_r[r] = qrow < p.sq ? p.lse[bh * p.sq + qrow] : 0.f;
    delta_r[r] = qrow < p.sq ? p.delta[bh * p.sq + qrow] : 0.f;
  }
  Frag dq[D / 16];
#pragma unroll
  for (int j = 0; j < D / 16; ++j) wmma::fill_fragment(dq[j], 0.f);

  const __nv_bfloat16* kg = p.k + b * p.ks_b + hk * p.ks_h;
  const __nv_bfloat16* vg = p.v + b * p.vs_b + hk * p.vs_h;
  int kv_end = p.skv;
  if (p.causal) kv_end = min(kv_end, q0 + BQ);
  for (int kv0 = 0; kv0 < kv_end; kv0 += BKV) {
    // the tile skip rule of the reference: wholly outside the window
    if (p.window > 0 && q0 - (kv0 + BKV - 1) >= p.window) continue;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<D>(ks, kg, p.ks_s, kv0, p.skv);
    load_tile<D>(vs, vg, p.vs_s, kv0, p.skv);
    __syncthreads();

    // s = q k^T and dp = dO v^T for this warp's 16 rows: a (kv, d) tile
    // row-major is its transpose in column-major order
#pragma unroll
    for (int jn = 0; jn < BKV / 16; ++jn) {
      Frag acc_s, acc_p;
      wmma::fill_fragment(acc_s, 0.f);
      wmma::fill_fragment(acc_p, 0.f);
#pragma unroll
      for (int kk = 0; kk < D; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb;
        wmma::load_matrix_sync(fa, qs + row0 * L::LDQ + kk, L::LDQ);
        wmma::load_matrix_sync(fb, ks + jn * 16 * L::LDQ + kk, L::LDQ);
        wmma::mma_sync(acc_s, fa, fb, acc_s);
        wmma::load_matrix_sync(fa, dos + row0 * L::LDQ + kk, L::LDQ);
        wmma::load_matrix_sync(fb, vs + jn * 16 * L::LDQ + kk, L::LDQ);
        wmma::mma_sync(acc_p, fa, fb, acc_p);
      }
      wmma::store_matrix_sync(ss + row0 * L::LDS + jn * 16, acc_s, L::LDS,
                              wmma::mem_row_major);
      wmma::store_matrix_sync(dps + row0 * L::LDS + jn * 16, acc_p, L::LDS,
                              wmma::mem_row_major);
    }
    __syncwarp();
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int qpos = q0 + row0 + r;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int c = lane + 32 * t;
        const int i = (row0 + r) * L::LDS + c;
        float pv, ds;
        p_and_ds(p, ss[i], dps[i], lse_r[r], delta_r[r],
                 visible(p, qpos, kv0 + c), pv, ds);
        dss[(row0 + r) * L::LDP + c] = __float2bfloat16_rn(ds);
      }
    }
    __syncwarp();
    // dq += ds @ k
#pragma unroll
    for (int kk = 0; kk < BKV; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
      wmma::load_matrix_sync(fa, dss + row0 * L::LDP + kk, L::LDP);
#pragma unroll
      for (int jd = 0; jd < D / 16; ++jd) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, ks + kk * L::LDQ + jd * 16, L::LDQ);
        wmma::mma_sync(dq[jd], fa, fb, dq[jd]);
      }
    }
  }

  __syncthreads();  // the staging tile overlays every warp's score rows
  float* stage = ss;
#pragma unroll
  for (int jd = 0; jd < D / 16; ++jd)
    wmma::store_matrix_sync(stage + row0 * L::LDO + jd * 16, dq[jd], L::LDO,
                            wmma::mem_row_major);
  __syncwarp();
  write_rows<D>(p.dq + bh * p.sq * D, stage, row0, q0 + row0, p.sq);
}

template <int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkv_kernel(BwdArgs p) {
  using L = Smem<D>;
  using Frag = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem + L::T0);
  __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(smem + L::T1);
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem + L::T2);
  __nv_bfloat16* dos = reinterpret_cast<__nv_bfloat16*>(smem + L::T3);
  float* sts = reinterpret_cast<float*>(smem + L::S_OFF);
  float* dpts = reinterpret_cast<float*>(smem + L::DP_OFF);
  __nv_bfloat16* pts = reinterpret_cast<__nv_bfloat16*>(smem + L::P_OFF);
  __nv_bfloat16* dsts = reinterpret_cast<__nv_bfloat16*>(smem + L::DS_OFF);
  float* lse_s = reinterpret_cast<float*>(smem + L::VEC_OFF);
  float* delta_s = lse_s + 64;

  const int kv0 = blockIdx.x * BKV;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int group = p.h / p.hkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = warp * 16;   // this warp's key rows in the tile

  load_tile<D>(ks, p.k + b * p.ks_b + hk * p.ks_h, p.ks_s, kv0, p.skv);
  load_tile<D>(vs, p.v + b * p.vs_b + hk * p.vs_h, p.vs_s, kv0, p.skv);
  Frag dk[D / 16], dv[D / 16];
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
    wmma::fill_fragment(dk[j], 0.f);
    wmma::fill_fragment(dv[j], 0.f);
  }

  // causal: q tiles from the one holding the diagonal of this key tile on
  const int q_begin = p.causal ? (kv0 / BQ) * BQ : 0;
  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const size_t bh = (size_t)b * p.h + h;
    const __nv_bfloat16* qg = p.q + b * p.qs_b + h * p.qs_h;
    const __nv_bfloat16* og = p.dout + b * p.os_b + h * p.os_h;
    for (int q0 = q_begin; q0 < p.sq; q0 += BQ) {
      // later q tiles lie further outside the window
      if (p.window > 0 && q0 - (kv0 + BKV - 1) >= p.window) break;
      __syncthreads();  // every warp is done with the previous q tile
      load_tile<D>(qs, qg, p.qs_s, q0, p.sq);
      load_tile<D>(dos, og, p.os_s, q0, p.sq);
      if (threadIdx.x < 64) {
        const int qrow = q0 + threadIdx.x;
        lse_s[threadIdx.x] = qrow < p.sq ? p.lse[bh * p.sq + qrow] : 0.f;
        delta_s[threadIdx.x] = qrow < p.sq ? p.delta[bh * p.sq + qrow] : 0.f;
      }
      __syncthreads();

      // s^T = k q^T and dp^T = v dO^T for this warp's 16 key rows
#pragma unroll
      for (int jq = 0; jq < BQ / 16; ++jq) {
        Frag acc_s, acc_p;
        wmma::fill_fragment(acc_s, 0.f);
        wmma::fill_fragment(acc_p, 0.f);
#pragma unroll
        for (int kk = 0; kk < D; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb;
          wmma::load_matrix_sync(fa, ks + row0 * L::LDQ + kk, L::LDQ);
          wmma::load_matrix_sync(fb, qs + jq * 16 * L::LDQ + kk, L::LDQ);
          wmma::mma_sync(acc_s, fa, fb, acc_s);
          wmma::load_matrix_sync(fa, vs + row0 * L::LDQ + kk, L::LDQ);
          wmma::load_matrix_sync(fb, dos + jq * 16 * L::LDQ + kk, L::LDQ);
          wmma::mma_sync(acc_p, fa, fb, acc_p);
        }
        wmma::store_matrix_sync(sts + row0 * L::LDS + jq * 16, acc_s, L::LDS,
                                wmma::mem_row_major);
        wmma::store_matrix_sync(dpts + row0 * L::LDS + jq * 16, acc_p, L::LDS,
                                wmma::mem_row_major);
      }
      __syncwarp();
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const int kpos = kv0 + row0 + r;
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const int c = lane + 32 * t;
          const int i = (row0 + r) * L::LDS + c;
          float pv, ds;
          p_and_ds(p, sts[i], dpts[i], lse_s[c], delta_s[c],
                   visible(p, q0 + c, kpos), pv, ds);
          pts[(row0 + r) * L::LDP + c] = __float2bfloat16_rn(pv);
          dsts[(row0 + r) * L::LDP + c] = __float2bfloat16_rn(ds);
        }
      }
      __syncwarp();
      // dv += p^T @ dO, dk += ds^T @ q
#pragma unroll
      for (int kk = 0; kk < BQ; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fp, fd;
        wmma::load_matrix_sync(fp, pts + row0 * L::LDP + kk, L::LDP);
        wmma::load_matrix_sync(fd, dsts + row0 * L::LDP + kk, L::LDP);
#pragma unroll
        for (int jd = 0; jd < D / 16; ++jd) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
          wmma::load_matrix_sync(fb, dos + kk * L::LDQ + jd * 16, L::LDQ);
          wmma::mma_sync(dv[jd], fp, fb, dv[jd]);
          wmma::load_matrix_sync(fb, qs + kk * L::LDQ + jd * 16, L::LDQ);
          wmma::mma_sync(dk[jd], fd, fb, dk[jd]);
        }
      }
    }
  }

  __syncthreads();  // the staging tile overlays every warp's score rows
  float* stage = sts;
  const size_t bhk = (size_t)b * p.hkv + hk;
#pragma unroll
  for (int jd = 0; jd < D / 16; ++jd)
    wmma::store_matrix_sync(stage + row0 * L::LDO + jd * 16, dk[jd], L::LDO,
                            wmma::mem_row_major);
  __syncwarp();
  write_rows<D>(p.dk + bhk * p.skv * D, stage, row0, kv0 + row0, p.skv);
  __syncwarp();
#pragma unroll
  for (int jd = 0; jd < D / 16; ++jd)
    wmma::store_matrix_sync(stage + row0 * L::LDO + jd * 16, dv[jd], L::LDO,
                            wmma::mem_row_major);
  __syncwarp();
  write_rows<D>(p.dv + bhk * p.skv * D, stage, row0, kv0 + row0, p.skv);
}

template <int D>
cudaError_t launch(const BwdArgs& p, int which, int batch,
                   cudaStream_t stream) {
  constexpr int bytes = Smem<D>::BYTES;
  if (which == 0) {
    auto kernel = flash_bwd_dq_kernel<D>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    dim3 grid((p.sq + BQ - 1) / BQ, p.h, batch);
    kernel<<<grid, THREADS, bytes, stream>>>(p);
  } else {
    auto kernel = flash_bwd_dkv_kernel<D>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    dim3 grid((p.skv + BKV - 1) / BKV, p.hkv, batch);
    kernel<<<grid, THREADS, bytes, stream>>>(p);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// which = 0: the dq pass (writes dq); which = 1: the dk/dv pass (writes dk,
// dv per key head, the GQA group summed). Strides are in elements; the last
// dim of q, k, v and dout is contiguous. head_dim must be 64 or 128 (the
// wrapper checks); returns cudaErrorInvalidValue otherwise.
int flash_bwd_launch(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dq, void* dk, void* dv, int which, int batch,
                     int h, int hkv, int sq, int skv, int head_dim,
                     long long qs_b, long long qs_h, long long qs_s,
                     long long ks_b, long long ks_h, long long ks_s,
                     long long vs_b, long long vs_h, long long vs_s,
                     long long os_b, long long os_h, long long os_s,
                     float scale, float softcap, int causal, int window,
                     void* stream) {
  BwdArgs p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.qs_b = qs_b; p.qs_h = qs_h; p.qs_s = qs_s;
  p.ks_b = ks_b; p.ks_h = ks_h; p.ks_s = ks_s;
  p.vs_b = vs_b; p.vs_h = vs_h; p.vs_s = vs_s;
  p.os_b = os_b; p.os_h = os_h; p.os_s = os_s;
  p.h = h; p.hkv = hkv; p.sq = sq; p.skv = skv;
  p.scale = scale; p.softcap = softcap;
  p.causal = causal; p.window = window;
  if (which != 0 && which != 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) return launch<64>(p, which, batch, st);
  if (head_dim == 128) return launch<128>(p, which, batch, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"

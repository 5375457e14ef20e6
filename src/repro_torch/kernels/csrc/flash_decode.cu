// Split-KV decode attention for Hopper over a contiguous (ring) KV cache.
//
// Replaces the TPU kernel `_decode_kernel` (src/repro/kernels/attention/
// kernel_decode.py), launched there by `flash_decode`, together with the
// log-sum-exp combine that follows it there in jnp: one launch computes the
// output (B, Hkv, G, D) in bf16. Same masks as kernel_decode.py:113-124:
// slot j holds absolute position pos - cur + j (j <= cur) or
// pos - cur - slots + j, where pos = length - 1 and cur = pos mod slots; a
// slot is seen when that position lies in [0, pos] (and within the window).
// The soft cap applies to the scaled logits before masking; masked scores
// are -1e30; an empty row comes out as zeros; sinks join once, in the
// merge. The cache length need not be a multiple of the key tile: the last
// tile masks its tail.
//
// What bounds it on an H100: the bytes of the cache rows the step reads
// (each valid K/V row once) over HBM; at the served decode shape (B 4,
// Hkv 8, G 4, 296 slots, d 64, length 287) about 2.4 MB, 0.71 us at
// 3.35 TB/s, against a few MFLOP of products. Past the bytes, a call this
// small is bound by latency: the launch, the TMA round trip of the first
// tile and each block's walk over its tiles. The design (decode_split.cuh,
// shared with the paged kernel): blocks of (b, kv head, split) over a plan
// that splits a head's key tiles only where each split keeps at least 8
// tiles (at 296 slots one split: no workspace, no merge); one producer
// warp keeps a ring of six TMA-loaded 64-key K/V tiles in flight (three at
// head_dim 128 and 256), the first issued before the length arrives, through a
// rank-4 map over (D, S, Hkv, B) with the 128-byte swizzle; four consumer
// warps run q K^T and P V on tensor cores (mma.sync m16n8k16 fed by
// ldmatrix, the group's q rows padded to 16, each warp 16 keys of a tile)
// with an online softmax in registers and write the output; with several
// splits the last block of each (b, kv head) merges them in index order.
// One launch a call, no plain-torch combine. P is rounded to bf16 before
// P V, as the port's flash forward rounds it.
#include "decode_split.cuh"

namespace {

using decode_split::Params;

template <int D, int WK, bool CAP>
__global__ void __launch_bounds__(decode_split::THREADS)
    flash_decode_kernel(const __grid_constant__ Params p) {
  decode_split::body<D, WK, false, CAP>(p);
}

template <int D, int WK>
cudaError_t dispatch(const Params& p, int units, cudaStream_t stream) {
  if (p.softcap > 0.f)
    return decode_split::run<D>(flash_decode_kernel<D, WK, true>, p,
                                    units, stream);
  return decode_split::run<D>(flash_decode_kernel<D, WK, false>, p,
                                  units, stream);
}

template <int D>
cudaError_t launch(Params& p, int batch, int n_splits, const void* k,
                   const void* v, cudaStream_t stream) {
  const int units = decode_split::plan(p, batch, n_splits);
  if (units < 0) return cudaErrorInvalidValue;
  cudaError_t err = decode_split::make_map(&p.k, k, D, p.keys, p.hkv, batch,
                                           decode_split::KEY_TILE);
  if (err == cudaSuccess)
    err = decode_split::make_map(&p.v, v, D, p.keys, p.hkv, batch,
                                 decode_split::KEY_TILE);
  if (err != cudaSuccess) return err;
  if (decode_split::few_row_body(p))
    return dispatch<D, 16>(p, units, stream);
  return dispatch<D, 32>(p, units, stream);
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q (B, Hkv, G, D), k and v (B, Hkv, slots, D) bf16, contiguous and
// 16-byte aligned; lengths (B,) int32; sinks (Hkv, G) fp32 (bf16 with
// sinks_bf16) or null; out (B, Hkv, G, D) bf16. The fp32 workspaces hold
// (units, n_splits, rw, D) and (units, n_splits, rw) and tickets (units,)
// int32 zeros (left zero), with units = B Hkv ceil(G / rows a unit) and
// rw = min(G, rows a unit); n_splits the key splits, the decode policy's (a
// count below 1, above the tile count or leaving a split empty gives
// cudaErrorInvalidValue, as does a head_dim other than 64, 128 or 256).
int flash_decode_launch(const void* q, const void* k, const void* v,
                        const void* lengths, const void* sinks, void* out,
                        void* o_ws, void* m_ws, void* l_ws, void* tickets,
                        int batch, int hkv, int g, int slots, int head_dim,
                        int n_splits, int sinks_bf16, float scale,
                        float softcap, int window, void* stream) {
  if (batch < 1 || hkv < 1 || g < 1 || slots < 1)
    return cudaErrorInvalidValue;
  Params p = {};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.lengths = static_cast<const int*>(lengths);
  p.sinks = sinks;
  p.sinks_bf16 = sinks_bf16;
  p.out = static_cast<__nv_bfloat16*>(out);
  p.o_ws = static_cast<float*>(o_ws);
  p.m_ws = static_cast<float*>(m_ws);
  p.l_ws = static_cast<float*>(l_ws);
  p.tickets = static_cast<int*>(tickets);
  p.hkv = hkv;
  p.rows = g;
  p.keys = slots;
  p.q_tokens = 1;
  p.scale = scale;
  p.softcap = softcap;
  p.window = window;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) return launch<64>(p, batch, n_splits, k, v, st);
  if (head_dim == 128) return launch<128>(p, batch, n_splits, k, v, st);
  if (head_dim == 256) return launch<256>(p, batch, n_splits, k, v, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"

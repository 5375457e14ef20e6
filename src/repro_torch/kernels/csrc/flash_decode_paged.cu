// Split-KV decode attention for Hopper over a paged KV pool, 1 or T query
// tokens per sequence.
//
// Replaces the TPU kernel `_decode_kernel_paged` (src/repro/kernels/
// attention/kernel_decode.py), launched there by `flash_decode_paged`,
// together with the log-sum-exp combine that follows it there in jnp: one
// launch computes the output (B, Hkv, R, D) in bf16. The whole GQA group,
// times the T query tokens, is packed into the q rows (row = g*T + t), and
// row t attends through position length - T + t: the mask is
// idx <= length - T + t per row (kernel_decode.py:145-160), with the
// sliding window on top. The soft cap applies to the scaled logits before
// masking; masked scores are -1e30; empty rows and never-written null-page
// entries come out as zeros; sinks (one per row) join once, in the merge.
//
// What bounds it on an H100: at the decode and verify shapes (B 8, 4 or 16
// q rows a kv head) the bytes of the valid K/V pages over HBM, each read
// once a step; at the 128-token chunk of chunked prefill (512 q rows a kv
// head) both products on bf16 tensor cores, a fraction of a microsecond,
// so there too the bytes and the latency of a small launch. The design
// (decode_split.cuh, shared with the contiguous kernel, so at page 64 and
// T = 1 the results equal flash_decode's over the gathered pages bit for
// bit): blocks of (b, kv head, row tile, split) over a plan that splits a
// unit's key tiles only where each split keeps at least 8 tiles; one
// producer warp TMA-loads 64-key K/V tiles through a rank-4 map over the
// pool (D, page, Hkv, P), the physical page read from the table as the
// box's outer coordinate, a page smaller than the tile as gcd(page, 64)-row
// boxes, into a ring of six (three at head_dim 128 and 256); the first two
// tiles' page ids and the length come in one round trip, and the first tile goes
// out before the length is known; a block whose tiles all lie past its
// rows' largest horizon, or before their smallest window, computes
// nothing, so the kernel reads no null-page entry past `length` but that
// early tile; four consumer warps run q K^T and P V on tensor cores
// (mma.sync m16n8k16 from ldmatrix): up to 16 q rows with each warp on 16
// keys of a tile, more rows in 32-row units with two warps on each 16
// rows, an online softmax in registers; the block writes the output, or
// with several splits the last block of each (b, kv head, row tile)
// merges them in index order. P is rounded to bf16 before P V.
#include "decode_split.cuh"

namespace {

using decode_split::Params;

template <int D, int WK, bool CAP>
__global__ void __launch_bounds__(decode_split::THREADS)
    flash_decode_paged_kernel(const __grid_constant__ Params p) {
  decode_split::body<D, WK, true, CAP>(p);
}

template <int D, int WK>
cudaError_t dispatch(const Params& p, int units, cudaStream_t stream) {
  if (p.softcap > 0.f)
    return decode_split::run<D>(flash_decode_paged_kernel<D, WK, true>, p,
                                    units, stream);
  return decode_split::run<D>(flash_decode_paged_kernel<D, WK, false>, p,
                                  units, stream);
}

template <int D>
cudaError_t launch(Params& p, int batch, int n_pages, int n_splits,
                   const void* k_pages, const void* v_pages,
                   cudaStream_t stream) {
  const int units = decode_split::plan(p, batch, n_splits);
  if (units < 0) return cudaErrorInvalidValue;
  cudaError_t err = decode_split::make_map(&p.k, k_pages, D, p.page_size,
                                           p.hkv, n_pages, p.box_rows);
  if (err == cudaSuccess)
    err = decode_split::make_map(&p.v, v_pages, D, p.page_size, p.hkv,
                                 n_pages, p.box_rows);
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

// q (B, Hkv, R, D), k_pages and v_pages (n_pages, Hkv, page, D) bf16,
// contiguous and 16-byte aligned; page_table (B, MP) and lengths (B,)
// int32; sinks (Hkv, R) fp32 (bf16 with sinks_bf16) or null; out
// (B, Hkv, R, D) bf16. Workspaces as flash_decode_launch's, with
// units = B Hkv ceil(R / rows a unit). head_dim 64, 128 or 256, a page
// size that is a multiple of 8 up to 128, T dividing R and n_splits as
// flash_decode_launch's (else cudaErrorInvalidValue).
int flash_decode_paged_launch(const void* q, const void* k_pages,
                              const void* v_pages, const void* page_table,
                              const void* lengths, const void* sinks,
                              void* out, void* o_ws, void* m_ws, void* l_ws,
                              void* tickets, int batch, int hkv, int rows,
                              int page_size, int max_pages, int n_pages,
                              int head_dim, int q_tokens, int n_splits,
                              int sinks_bf16, float scale, float softcap,
                              int window, void* stream) {
  if (page_size % 8 != 0 || page_size < 8 || page_size > 128 ||
      q_tokens < 1 || rows < 1 || rows % q_tokens != 0 || max_pages < 1 ||
      batch < 1 || hkv < 1 || n_pages < 1)
    return cudaErrorInvalidValue;
  Params p = {};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.page_table = static_cast<const int*>(page_table);
  p.lengths = static_cast<const int*>(lengths);
  p.sinks = sinks;
  p.sinks_bf16 = sinks_bf16;
  p.out = static_cast<__nv_bfloat16*>(out);
  p.o_ws = static_cast<float*>(o_ws);
  p.m_ws = static_cast<float*>(m_ws);
  p.l_ws = static_cast<float*>(l_ws);
  p.tickets = static_cast<int*>(tickets);
  p.hkv = hkv;
  p.rows = rows;
  p.keys = max_pages * page_size;
  p.q_tokens = q_tokens;
  p.page_size = page_size;
  p.max_pages = max_pages;
  p.box_rows = decode_split::gcd(page_size, decode_split::KEY_TILE);
  p.scale = scale;
  p.softcap = softcap;
  p.window = window;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head_dim == 64)
    return launch<64>(p, batch, n_pages, n_splits, k_pages, v_pages, st);
  if (head_dim == 128)
    return launch<128>(p, batch, n_pages, n_splits, k_pages, v_pages, st);
  if (head_dim == 256)
    return launch<256>(p, batch, n_pages, n_splits, k_pages, v_pages, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"

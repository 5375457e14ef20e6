// Split-KV decode attention for Hopper over a paged KV pool, 1 or T query
// tokens per sequence.
//
// Replaces the TPU kernel `_decode_kernel_paged` (src/repro/kernels/
// attention/kernel_decode.py), launched there by `flash_decode_paged`. For
// each (batch row b, kv head h, page slot j) it writes the unnormalised fp32
// partial (o, m, l) of the q rows over the physical page page_table[b, j];
// the caller merges the page slots with the log-sum-exp combine (plain
// torch, as it is plain jnp in the reference). The whole GQA group, times
// the T query tokens, is packed into the q rows (row = g*T + t), and row t
// attends through position length - T + t: the mask is idx < length for
// T = 1 and idx <= length - T + t per row for T > 1
// (kernel_decode.py:145-160), with the sliding window on top. The soft cap
// is applied to the scaled logits before masking. A fully masked page gives
// (0, -1e30, 0), so empty rows and never-written null-page entries come out
// as zeros after the combine.
//
// Design. The Pallas kernel dereferences the scalar-prefetched page table
// in its K/V BlockSpec index map; here each block reads page_table[b, j]
// itself and computes the page's base address. A page whose first position
// lies past the largest horizon of the block's q rows (or whose last one
// lies before the smallest row's window) writes (0, -1e30, 0) without
// loading K/V, so the block never reads a null-page entry past `length`.
// Chunked prefill packs G*T = 4 x 128 = 512 q rows, too many for one
// block's shared memory in fp32 beside a score tile, so the q rows are
// tiled at ROW_TILE = 64 as a grid dimension; the partial layout
// (B, Hkv, MP, G*T, D) stays whole. The split body (staging, scores, mask,
// max, exp, sum, p @ v) is decode_split.cuh, shared with flash_decode.cu,
// so at page_size 64 and T = 1 the results equal flash_decode's over the
// gathered pages bit for bit.
//
// What bounds it on an H100: at the decode shapes, the bytes of the valid
// K/V pages over HBM (each read once per step); at the chunk shapes
// (T = 128), the operations: p @ v has the fp32 softmax weights as an
// operand and runs at the fp32 CUDA-core rate, while q @ k^T, a product of
// bf16 values accumulated in fp32, could run on the tensor cores. This
// first version is simple: 4 warps, fp32 FMA on shared memory for both
// products, no tensor cores, no TMA and no fused combine.
#include "decode_split.cuh"

namespace {

using decode_split::THREADS;
constexpr int ROW_TILE = 64;

struct PagedArgs {
  const __nv_bfloat16* q;        // (B, Hkv, R, D), R = G * T
  const __nv_bfloat16* k_pages;  // (P, Hkv, page, D)
  const __nv_bfloat16* v_pages;
  const int* page_table;         // (B, MP)
  const int* lengths;            // (B,)
  float* o;                      // (B, Hkv, MP, R, D)
  float* m;                      // (B, Hkv, MP, R)
  float* l;
  int hkv, rows, page_size, max_pages, q_tokens, row_tile, n_row_tiles;
  float scale, softcap;
  int window;                    // <= 0: none
};

// Row r of the tile (global row r0 + r) sees page offset j when the
// position base + j lies at or before its horizon length - T + t and,
// with a window, within `window` of it.
struct RowValid {
  int base, horizon0, r0, q_tokens, window;
  __device__ bool operator()(int r, int j) const {
    const int hz = horizon0 + (r0 + r) % q_tokens;
    const int idx = base + j;
    bool ok = idx <= hz;
    if (window > 0) ok = ok && (hz - idx) < window;
    return ok;
  }
};

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_decode_paged_kernel(PagedArgs p) {
  extern __shared__ __align__(16) float smem[];
  const int ps = p.page_size;
  const int rt = blockIdx.x % p.n_row_tiles;
  const int j = blockIdx.x / p.n_row_tiles;
  const int h = blockIdx.y, b = blockIdx.z;
  const int r0 = rt * p.row_tile;
  const int nr = min(p.row_tile, p.rows - r0);
  const size_t bh = (size_t)b * p.hkv + h;
  const size_t part = (bh * p.max_pages + j) * p.rows + r0;
  float* o = p.o + part * D;
  float* m = p.m + part;
  float* l = p.l + part;

  // the tile's smallest and largest row horizon: t = row mod T runs over
  // the rows r0 .. r0 + nr - 1
  const int T = p.q_tokens;
  const int t0 = r0 % T;
  const bool wraps = nr >= T || t0 + nr - 1 >= T;
  const int t_min = wraps ? 0 : t0;
  const int t_max = wraps ? T - 1 : t0 + nr - 1;
  const int horizon0 = p.lengths[b] - T;
  const int base = j * ps;
  const bool past = base > horizon0 + t_max;
  const bool before = p.window > 0 &&
                      horizon0 + t_min - (base + ps - 1) >= p.window;
  if (past || before) {
    decode_split::empty_partials<D>(nr, o, m, l);
    return;
  }

  float* qs = smem;                        // (nr, D)
  float* ks = qs + nr * D;                 // (page, D + 1): padded rows
  float* vs = ks + ps * (D + 1);           // (page, D)
  float* ss = vs + ps * D;                 // (nr, page) scores, then p
  const int page = p.page_table[(size_t)b * p.max_pages + j];
  const size_t kv0 = ((size_t)page * p.hkv + h) * ps * D;
  decode_split::stage_q<D>(qs, p.q + (bh * p.rows + r0) * D, nr);
  decode_split::stage_kv<D>(ks, vs, p.k_pages + kv0, p.v_pages + kv0, ps, ps);
  __syncthreads();
  decode_split::partials<D>(qs, ks, vs, ss, nr, ps, p.scale, p.softcap,
                            RowValid{base, horizon0, r0, T, p.window}, o, m,
                            l);
}

template <int D>
cudaError_t launch(const PagedArgs& p, int batch, cudaStream_t stream) {
  auto kernel = flash_decode_paged_kernel<D>;
  const size_t bytes =
      sizeof(float) * decode_split::smem_floats<D>(p.row_tile, p.page_size);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(p.max_pages * p.n_row_tiles, p.hkv, batch);
  kernel<<<grid, THREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// All tensors contiguous; head_dim 64 or 128 and a page size that is a
// multiple of 8 up to 128 (else cudaErrorInvalidValue).
int flash_decode_paged_launch(const void* q, const void* k_pages,
                              const void* v_pages, const void* page_table,
                              const void* lengths, void* o, void* m, void* l,
                              int batch, int hkv, int rows, int page_size,
                              int max_pages, int head_dim, int q_tokens,
                              float scale, float softcap, int window,
                              void* stream) {
  if (page_size % 8 != 0 || page_size < 8 || page_size > 128 ||
      q_tokens < 1 || rows % q_tokens != 0 || rows < 1 || max_pages < 1)
    return cudaErrorInvalidValue;
  PagedArgs p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k_pages = static_cast<const __nv_bfloat16*>(k_pages);
  p.v_pages = static_cast<const __nv_bfloat16*>(v_pages);
  p.page_table = static_cast<const int*>(page_table);
  p.lengths = static_cast<const int*>(lengths);
  p.o = static_cast<float*>(o);
  p.m = static_cast<float*>(m);
  p.l = static_cast<float*>(l);
  p.hkv = hkv;
  p.rows = rows;
  p.page_size = page_size;
  p.max_pages = max_pages;
  p.q_tokens = q_tokens;
  p.row_tile = rows < ROW_TILE ? rows : ROW_TILE;
  p.n_row_tiles = (rows + p.row_tile - 1) / p.row_tile;
  p.scale = scale;
  p.softcap = softcap;
  p.window = window;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) return launch<64>(p, batch, st);
  if (head_dim == 128) return launch<128>(p, batch, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"

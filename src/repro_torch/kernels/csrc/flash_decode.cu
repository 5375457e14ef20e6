// Split-KV decode attention for Hopper over a contiguous (ring) KV cache.
//
// Replaces the TPU kernel `_decode_kernel` (src/repro/kernels/attention/
// kernel_decode.py), launched there by `flash_decode`. Grid (split, kv head,
// batch): each block streams one split of `block_kv` cache slots, with the
// whole GQA group packed into its q rows, and writes the split's
// unnormalised partial (o, m, l) in fp32. The caller merges the splits with
// the log-sum-exp combine (plain torch, as it is plain jnp in the
// reference). Same masks as kernel_decode.py:113-124: slot j holds absolute
// position pos - cur + j (j <= cur) or pos - cur - slots + j, where
// pos = length - 1 and cur = pos mod slots; a slot is valid when that
// position lies in [0, pos] (and within the window). q, k, v and p stay in
// fp32 inside a split (kernel_decode.py:64-74); a split with no valid slot
// yields (0, -1e30, 0) and an empty row comes out as zeros after the combine.
// The cache length need not be a multiple of block_kv: the last split masks
// its tail.
//
// What bounds it on an H100: the K/V bytes over HBM (every cache byte is read
// once per step); the products are a few MFLOP. The design spends nothing on
// tensor cores: 4 warps stage the split's K/V rows into shared memory as
// fp32 with coalesced 16-byte loads, compute the G x block_kv scores, and
// each warp owns whole q rows for the softmax and p @ v. That split body
// lives in decode_split.cuh, shared with the paged kernel.
#include "decode_split.cuh"

namespace {

using decode_split::THREADS;

struct DecodeArgs {
  const __nv_bfloat16* q;   // (B, Hkv, G, D)
  const __nv_bfloat16* k;   // (B, Hkv, S, D)
  const __nv_bfloat16* v;
  const int* lengths;       // (B,)
  float* o;                 // (B, Hkv, NS, G, D)
  float* m;                 // (B, Hkv, NS, G)
  float* l;
  int hkv, g, slots, block_kv, n_splits;
  float scale, softcap;
  int window;               // <= 0: none
};

// Slot j of the split is valid for every q row alike.
struct SlotValid {
  const int* valid;
  __device__ bool operator()(int, int j) const { return valid[j] != 0; }
};

template <int D>
__global__ void __launch_bounds__(THREADS) flash_decode_kernel(DecodeArgs p) {
  extern __shared__ __align__(16) float smem[];
  const int bkv = p.block_kv;
  float* qs = smem;                        // (G, D)
  float* ks = qs + p.g * D;                // (bkv, D + 1): padded rows
  float* vs = ks + bkv * (D + 1);          // (bkv, D)
  float* ss = vs + bkv * D;                // (G, bkv) scores, then p
  int* valid = reinterpret_cast<int*>(ss + p.g * bkv);  // (bkv,)

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int s0 = split * bkv;
  const size_t bh = (size_t)b * p.hkv + h;
  const __nv_bfloat16* kg = p.k + (bh * p.slots + s0) * D;
  const __nv_bfloat16* vg = p.v + (bh * p.slots + s0) * D;

  decode_split::stage_q<D>(qs, p.q + bh * p.g * D, p.g);
  decode_split::stage_kv<D>(ks, vs, kg, vg, bkv, min(bkv, p.slots - s0));
  const int length = p.lengths[b];
  const int pos = length - 1;
  const int cur = ((pos % p.slots) + p.slots) % p.slots;
  for (int j = threadIdx.x; j < bkv; j += THREADS) {
    const int idx = s0 + j;
    const int actual = idx <= cur ? pos - cur + idx : pos - cur - p.slots + idx;
    bool ok = idx < p.slots && actual >= 0 && actual <= pos;
    if (p.window > 0) ok = ok && (pos - actual) < p.window;
    valid[j] = ok;
  }
  __syncthreads();

  const size_t part = (bh * p.n_splits + split) * p.g;
  decode_split::partials<D>(qs, ks, vs, ss, p.g, bkv, p.scale, p.softcap,
                            SlotValid{valid}, p.o + part * D, p.m + part,
                            p.l + part);
}

template <int D>
size_t smem_bytes(int g, int bkv) {
  return sizeof(float) * decode_split::smem_floats<D>(g, bkv) +
         sizeof(int) * (size_t)bkv;
}

template <int D>
cudaError_t launch(const DecodeArgs& p, int batch, cudaStream_t stream) {
  auto kernel = flash_decode_kernel<D>;
  const size_t bytes = smem_bytes<D>(p.g, p.block_kv);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(p.n_splits, p.hkv, batch);
  kernel<<<grid, THREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// All tensors contiguous; head_dim 64 or 128 (else cudaErrorInvalidValue).
int flash_decode_launch(const void* q, const void* k, const void* v,
                        const void* lengths, void* o, void* m, void* l,
                        int batch, int hkv, int g, int slots, int head_dim,
                        int block_kv, float scale, float softcap, int window,
                        void* stream) {
  DecodeArgs p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.lengths = static_cast<const int*>(lengths);
  p.o = static_cast<float*>(o);
  p.m = static_cast<float*>(m);
  p.l = static_cast<float*>(l);
  p.hkv = hkv;
  p.g = g;
  p.slots = slots;
  p.block_kv = block_kv;
  p.n_splits = (slots + block_kv - 1) / block_kv;
  p.scale = scale;
  p.softcap = softcap;
  p.window = window;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) return launch<64>(p, batch, st);
  if (head_dim == 128) return launch<128>(p, batch, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"

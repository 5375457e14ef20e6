// dB of the fused GEMM for Hopper: [dB | dB2] = An^T @ [gbar | gbar2].
//
// Replaces the TPU kernel `_db_kernel` (src/repro/kernels/gemm/backward.py),
// launched there by `_gemm_bwd_db`. Same chain, split differently:
//   A side    the norm prologue with the forward's rounding point (rmsnorm
//             x rstd gamma, layernorm (x - mean) rstd gamma [+ beta], in fp32
//             from the forward's statistics, rounded to bf16, so An is the
//             forward's An bit for bit) is applied once per element by the
//             operand pass (gemm_bwd_g.cu), which writes An transposed, a_t
//             (K, M); the TPU kernel recomputes it on every A tile;
//   g side    the transposed epilogue, also from the operand pass, as
//             gbar_t (N', M) = [g_acc | g_acc2]^T in bf16 (N' = 2N for the
//             SwiGLU up-projection), where the TPU kernel contracts in fp32;
//   product   C (K, N') = a_t @ gbar_t^T on the Hopper mainloop
//             (gemm_sm90.cuh), both operands contiguous along M, the
//             contraction; the store sends columns < N to dB and the rest to
//             dB2, so both come from one launch as on the TPU;
//   dbias     the column sum of g_bias is taken by the operand pass in fp32
//             partials (64 rows each), summed by the caller.
//
// What bounds it on an H100: operations. At the training shapes of llama-1b
// (M = 4096 tokens contracted, K = 2048 or 8192, N = 512 .. 2 x 8192) the
// product is 2 M N K operations on the tensor cores (989 TFLOP/s bf16)
// against a few tens of MB of a_t, gbar_t and dB over HBM (3.35 TB/s); the
// mainloop keeps the tensor cores fed from a TMA ring (wgmma, warp
// specialisation, persistent blocks). The narrow outputs (v: 2048 x 512, 64
// tiles of 128 x 128 on 132 SMs) take 64-wide tiles: the caller picks the
// tile width per launch from the tile count against the SMs. Ragged
// edges are zero-filled by the TMA and masked in the store (N and K must be
// multiples of 8).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_sm90.cuh"

namespace {

template <int BN>
__global__ void __launch_bounds__(sm90::THREADS, 1)
gemm_bwd_db_kernel(const __grid_constant__ sm90::Params p) {
  sm90::gemm_body<BN, false>(p);
}

cudaError_t gemm(const sm90::Operand* x, const sm90::Operand* y,
                 const sm90::Params& p, int tile_n, cudaStream_t stream) {
  const int sms = sm90::sm_count();
  switch (tile_n) {
    case 256:
      return sm90::launch<256>(gemm_bwd_db_kernel<256>, x, y, 1, p, sms,
                               stream);
    case 128:
      return sm90::launch<128>(gemm_bwd_db_kernel<128>, x, y, 1, p, sms,
                               stream);
    case 64:
      return sm90::launch<64>(gemm_bwd_db_kernel<64>, x, y, 1, p, sms, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// a_t: (K, ld_t) bf16 and gbar_t: (N', ld_t) bf16 from the operand pass, the
// first M columns of each row valid; N' = 2N when db2 is given (the gated
// chain), else N. Writes db (K, N) bf16 and, for the gated chain, db2 (K, N).
// tile_n: the mainloop's tile width, 64, 128 or 256; window: the walk's tile
// rows a group (>= 1).
int gemm_bwd_db_launch(const void* a_t, const void* gbar_t, void* db,
                       void* db2, int m, int ld_t, int n, int k, int tile_n,
                       int window, void* stream) {
  const int n2 = db2 != nullptr ? 2 * n : n;
  const sm90::Operand x[1] = {{a_t, k, m, ld_t}};
  const sm90::Operand y[1] = {{gbar_t, n2, m, ld_t}};
  sm90::Params p{};
  p.group_m = window;
  p.m = k;
  p.n = n2;
  p.c = db;
  p.c2 = db2;
  p.ldc = n;
  p.n_split = n;
  return gemm(x, y, p, tile_n, static_cast<cudaStream_t>(stream));
}

}  // extern "C"

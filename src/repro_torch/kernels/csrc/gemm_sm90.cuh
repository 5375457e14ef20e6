// One Hopper GEMM mainloop for C = X @ Y^T, shared by the forward fused
// GEMM (gemm_fused.cu) and the GEMM backward kernels (gemm_bwd_da.cu,
// gemm_bwd_db.cu). The attention backward (flash_bwd.cu) uses its
// primitives: the barriers, TMA loads (and the 4-D ones of its strided
// views), the descriptors and wgmma (with A from registers too).
//
//   X (M, Kc) is bf16 and contraction-contiguous ("K-major"). Y is bf16,
//   either K-major, (N, Kc) (the backward), or MN-major, (Kc, N) with N
//   contiguous (the forward's weights as they are stored; Y_MN below).
//   The contraction may run over two segments, (X1, Y1) then (X2, Y2), into
//   the same accumulator: the gated dA contracts [gbar | gbar2] against B and
//   then B2 without a concatenated copy of the weights. An MN-major Y may
//   instead come in two column halves (y_halves == 2): a BN-wide tile holds
//   BN/2 columns of Y1 and the same BN/2 columns of Y2 side by side, so the
//   gated forward's two products are one wgmma of width BN.
//   The fp32 accumulator of each tile goes to an epilogue functor: the
//   backward's stores C row-major in fp32 or bf16 (StorePairs); the forward
//   runs its chain on the registers (gemm_fused.cu).
//   The contraction may also be split (splits > 1): work item (tile, s)
//   contracts stages [s k_per_split, (s + 1) k_per_split) and hands its
//   partial sum to the epilogue with its split index.
//
// The design is the card's usual one (NVIDIA Hopper tuning guide; the CUDA
// programming guide's TMA, wgmma and mbarrier sections):
//   - TMA loads of 128 x 64 X tiles and BN x 64 Y tiles (one 128-byte row of
//     the contraction each, the 128-byte swizzle that wgmma reads) into a
//     ring of 4-8 stages, each stage with a "full" mbarrier (the producer's
//     expected bytes) and an "empty" one (one arrival per consumer);
//   - one producer warpgroup, of which one thread issues the loads, that
//     gives its registers to the consumers with setmaxnreg;
//   - two consumer warpgroups, 64 rows of the tile each, issuing
//     wgmma.mma_async m64nBNk16 straight from shared memory, one group in
//     flight while the previous stage is released;
//   - persistent blocks, one per SM, walking the output tiles in groups of
//     8 tile rows (so a group's Y tiles stay in L2); the producer runs ahead
//     into the next tile while the consumers store this one;
//   - ragged M, N and contraction edges: the TMA fills out-of-range elements
//     with zeros, and the store is masked.
// An MN-major Y stage is BN/64 TMA boxes of 64 columns (128 bytes) by 64
// contraction rows under the same 128-byte swizzle, read by wgmma with its
// B-transpose bit set through a descriptor whose leading offset steps from
// one 64-column box to the next and whose stride steps over 8 contraction
// rows (CUTLASS cute/atom/mma_traits_sm90_gmma.hpp, make_gmma_desc, the
// Major::MN case of the 128-byte swizzle).
// BN (64, 128 or 256) is the caller's choice per launch, from the number of
// tiles against the SMs (kernels/gemm/backward.py pick_tile_n for the
// backward, kernels/gemm/ops.py plan_gemm, with the split, for the forward).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

constexpr int BM = 128;          // rows of C per tile: two warpgroups of 64
constexpr int BK = 64;           // contraction per stage: 128 bytes of bf16
constexpr int CONSUMERS = 2;     // consumer warpgroups
constexpr int THREADS = 128 * (1 + CONSUMERS);
constexpr int GROUP_M = 8;       // tile rows walked together

template <int BN>
struct Tile {
  static_assert(BN == 64 || BN == 128 || BN == 256, "wgmma tile widths");
  static constexpr int X_BYTES = BM * BK * 2;
  static constexpr int Y_BYTES = BN * BK * 2;
  static constexpr int STAGE_BYTES = X_BYTES + Y_BYTES;
  static constexpr int STAGES = (192 * 1024) / STAGE_BYTES;   // 8, 6, 4
  // the stages, 1024 bytes to align them for the swizzle, the barriers
  static constexpr int SMEM = STAGES * STAGE_BYTES + 1024 + 2 * STAGES * 8;
};

// One contraction-contiguous bf16 operand: rows x cols (cols contracted),
// row stride ld elements; base 16-byte aligned and ld * 2 a multiple of 16.
struct Operand {
  const void* base;
  int rows, cols, ld;
};

struct Params {
  CUtensorMap x[2], y[2];   // the two segments' maps (the second unused
  int k_tiles[2];           // when k_tiles[1] == 0); with y_halves == 2 the
                            // one segment's Y halves
  int y_halves;             // 1, or 2 (MN-major Y only)
  int splits, k_per_split;  // contraction split: stages per work item
  int m, n;                 // C's extent (columns of the raw accumulator)
  void* c;                  // columns < n_split: C[r][col] at c + r * ldc
  void* c2;                 // columns >= n_split: at c2 + r * ldc
                            // + col - n_split
  int ldc, n_split;         // (split s of a split launch: rows offset s * m)
};

// ---------------------------------------------------------------------------
// Device side
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Spin until the barrier's phase of the given parity has completed. A wait
// that outlasts ~2^34 cycles (seconds; a load never takes that long) traps,
// so a broken pipeline fails the launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  const long long start = clock64();
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > (1ll << 34)) __trap();
  }
}

// 2-D TMA load of the box at (c0 along the contiguous dim, c1 along rows).
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// 4-D TMA load of the box at (c0, c1, c2, c3), c0 along the contiguous dim
// (the attention backward's (d, S, H, B) views).
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::
          "r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile with the 128-byte
// swizzle: rows of 128 bytes, 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  auto enc = [](uint64_t x) { return (x & 0x3FFFF) >> 4; };
  return enc(smem_addr(p)) | (enc(16) << 16) | (enc(1024) << 32) |
         (1ull << 62);
}

// The same for an MN-major tile: 64-column (128-byte) boxes of BK rows,
// Y_BOX bytes apart (the leading offset), 8-row groups 1024 bytes apart
// (the stride offset).
constexpr int Y_BOX = 64 * BK * 2;

__device__ __forceinline__ uint64_t smem_desc_mn(const void* p) {
  auto enc = [](uint64_t x) { return (x & 0x3FFFF) >> 4; };
  return enc(smem_addr(p)) | (enc(Y_BOX) << 16) | (enc(1024) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accumulator reads or writes across an
// asynchronous wgmma boundary.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma.mma_async m64nBNk16, both operands from shared memory, fp32
// accumulator; scale_d == 0 starts the sum afresh. X is K-major; Y is
// K-major for TB == 0 and MN-major (transposed) for TB == 1.
template <int BN>
struct Wgmma;

template <>
struct Wgmma<64> {
  template <int TB>
  __device__ __forceinline__ static void mma(float (&d)[32], uint64_t xd,
                                             uint64_t yd, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(xd), "l"(yd), "r"(scale_d), "n"(TB));
  }
};

template <>
struct Wgmma<128> {
  template <int TB>
  __device__ __forceinline__ static void mma(float (&d)[64], uint64_t xd,
                                             uint64_t yd, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(xd), "l"(yd), "r"(scale_d), "n"(TB));
  }
};

template <>
struct Wgmma<256> {
  template <int TB>
  __device__ __forceinline__ static void mma(float (&d)[128], uint64_t xd,
                                             uint64_t yd, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83,"
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107,"
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, %131;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(xd), "l"(yd), "r"(scale_d), "n"(TB));
  }
};

// wgmma.mma_async m64nNk16 with A from registers: four 32-bit registers of
// bf16 pairs a thread, in the layout of an m64nN fp32 accumulator's 16
// columns packed pairwise (columns 2 (lane % 4) (+ 1) of rows
// 16 warp + lane / 4, then row + 8, then both again 8 columns on), so a
// product's accumulator rounded to bf16 feeds the next product with no
// shuffle (the attention backward's P and dS). B from shared memory,
// K-major for TB == 0, MN-major for TB == 1.
template <int N>
struct WgmmaRS;

template <>
struct WgmmaRS<32> {
  template <int TB>
  __device__ __forceinline__ static void mma(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t yd, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14,"
      "%15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(yd), "r"(scale_d),
        "n"(TB));
  }
};

template <>
struct WgmmaRS<64> {
  template <int TB>
  __device__ __forceinline__ static void mma(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t yd, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14,"
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
      "%28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(yd), "r"(scale_d),
        "n"(TB));
  }
};

template <>
struct WgmmaRS<128> {
  template <int TB>
  __device__ __forceinline__ static void mma(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t yd, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14,"
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40,"
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53,"
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(yd), "r"(scale_d),
        "n"(TB));
  }
};


// Tile t of the persistent walk -> (tile row, tile column): GROUP_M tile
// rows at a time, column by column within the group.
__device__ __forceinline__ void tile_coords(int t, int tiles_m, int tiles_n,
                                            int& tm, int& tn) {
  const int per_group = GROUP_M * tiles_n;
  const int first = (t / per_group) * GROUP_M;
  const int rows = min(tiles_m - first, GROUP_M);
  const int r = t % per_group;
  tm = first + r % rows;
  tn = r / rows;
}

// Two neighbouring columns of one row of C, masked to (m, n); the partial
// sum of split s goes s * m rows further down.
template <bool F32>
__device__ __forceinline__ void store_pair(const Params& p, int row, int col,
                                           float v0, float v1, int split) {
  if (row >= p.m || col >= p.n) return;
  void* base = p.c;
  if (col >= p.n_split) {
    base = p.c2;
    col -= p.n_split;
  }
  const size_t off = ((size_t)split * p.m + row) * p.ldc + col;
  if (F32) {
    *reinterpret_cast<float2*>(static_cast<float*>(base) + off) =
        make_float2(v0, v1);
  } else {
    *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(base) +
                                       off) = __floats2bfloat162_rn(v0, v1);
  }
}

// The m64nBN accumulator of one consumer warpgroup: thread (warp, lane)
// holds rows 16 warp + lane / 4 (+ 8) and columns 8 j + 2 (lane % 4) (+ 1),
// acc[4 j + 2 h + e] at row + 8 h, column 8 j + 2 (lane % 4) + e. An
// epilogue is called with the first row, the tile's first column, the
// thread's column offset 2 (lane % 4) and the work item's split.
template <bool F32>
struct StorePairs {
  template <int BN>
  __device__ __forceinline__ void operator()(const Params& p,
                                             float (&acc)[BN / 2], int row,
                                             int tile_col, int q,
                                             int split) const {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = tile_col + j * 8 + q;
      store_pair<F32>(p, row, col, acc[4 * j], acc[4 * j + 1], split);
      store_pair<F32>(p, row + 8, col, acc[4 * j + 2], acc[4 * j + 3], split);
    }
  }
};

// The kernel body; a source wraps it in its own __global__ function (so the
// profiler tells the callers apart):
//   __global__ void __launch_bounds__(sm90::THREADS, 1)
//   my_kernel(const __grid_constant__ sm90::Params p) {
//     sm90::gemm_body<BN, Y_MN>(p, epilogue);
//   }
template <int BN, bool Y_MN, class Epilogue>
__device__ __forceinline__ void gemm_body(const Params& p,
                                          const Epilogue& epilogue) {
  using T = Tile<BN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(smem + T::STAGES * T::STAGE_BYTES);
  uint64_t* empty = full + T::STAGES;
  const int tiles_m = (p.m + BM - 1) / BM;
  const int tiles_n = (p.n + BN - 1) / BN;
  const int tiles = tiles_m * tiles_n;
  const int k_tiles = p.k_tiles[0] + p.k_tiles[1];
  const int items = tiles * p.splits;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread keeps the ring full, work item after work item
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int stage = 0, phase = 0;
      for (int w = blockIdx.x; w < items; w += gridDim.x) {
        int tm, tn;
        tile_coords(w % tiles, tiles_m, tiles_n, tm, tn);
        const int kt0 = (w / tiles) * p.k_per_split;
        const int kt1 = min(k_tiles, kt0 + p.k_per_split);
        for (int kt = kt0; kt < kt1; ++kt) {
          const int seg = kt < p.k_tiles[0] ? 0 : 1;
          const int kc = (seg ? kt - p.k_tiles[0] : kt) * BK;
          mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* xs = smem + stage * T::STAGE_BYTES;
          unsigned char* ys = xs + T::X_BYTES;
          mbar_expect_tx(&full[stage], T::STAGE_BYTES);
          tma_load(xs, &p.x[seg], &full[stage], kc, tm * BM);
          if (!Y_MN) {
            tma_load(ys, &p.y[seg], &full[stage], kc, tn * BN);
          } else if (p.y_halves == 1) {
#pragma unroll
            for (int b = 0; b < BN / 64; ++b)
              tma_load(ys + b * Y_BOX, &p.y[seg], &full[stage],
                       tn * BN + b * 64, kc);
          } else if constexpr (BN >= 128) {
            // boxes [0, BN/128) from the first half, the rest the second
#pragma unroll
            for (int b = 0; b < BN / 64; ++b) {
              const int half = b / (BN / 128);
              tma_load(ys + b * Y_BOX, &p.y[half], &full[stage],
                       tn * (BN / 2) + (b % (BN / 128)) * 64, kc);
            }
          }
          if (++stage == T::STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // consumers: warpgroup cw multiplies rows [64 cw, 64 cw + 64) of a tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = wg - 1;
    const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
    const bool leader = threadIdx.x % 128 == 0;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    int stage = 0, phase = 0;
    for (int w = blockIdx.x; w < items; w += gridDim.x) {
      int tm, tn;
      tile_coords(w % tiles, tiles_m, tiles_n, tm, tn);
      const int kt0 = (w / tiles) * p.k_per_split;
      const int kt1 = min(k_tiles, kt0 + p.k_per_split);
      int prev = -1;
      for (int kt = kt0; kt < kt1; ++kt) {
        mbar_wait(&full[stage], phase);
        const unsigned char* xs =
            smem + stage * T::STAGE_BYTES + cw * (T::X_BYTES / CONSUMERS);
        const unsigned char* ys = smem + stage * T::STAGE_BYTES + T::X_BYTES;
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {   // 16 bf16 = 32 bytes a step
          // MN-major: 16 contraction rows of 128 bytes a step
          const uint64_t yd = Y_MN ? smem_desc_mn(ys + kk * 16 * 128)
                                   : smem_desc(ys + kk * 32);
          Wgmma<BN>::template mma<Y_MN ? 1 : 0>(
              acc, smem_desc(xs + kk * 32), yd, kt > kt0 || kk > 0);
        }
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(acc);
        // the previous stage's products are done: hand its buffers back
        if (prev >= 0 && leader) mbar_arrive(&empty[prev]);
        prev = stage;
        if (++stage == T::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (prev >= 0 && leader) mbar_arrive(&empty[prev]);
      const int row = tm * BM + cw * 64 + warp * 16 + lane / 4;
      epilogue.template operator()<BN>(p, acc, row, tn * BN, (lane % 4) * 2,
                                       w / tiles);
    }
  }
}

// The backward's body: C stored row-major in fp32 (F32) or bf16.
template <int BN, bool F32>
__device__ __forceinline__ void gemm_body(const Params& p) {
  gemm_body<BN, false>(p, StorePairs<F32>{});
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// cuTensorMapEncodeTiled is a driver-API function; it is looked up through
// the runtime, so the libraries need no -lcuda.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(ptr)
               : nullptr;
  }();
  return fn;
}

// The TMA map of an operand, boxes of box_rows x BK elements, 128-byte
// swizzle, zeros outside the operand.
inline cudaError_t make_map(CUtensorMap* map, const Operand& op,
                            int box_rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  if (op.base == nullptr || (reinterpret_cast<uintptr_t>(op.base) & 15) ||
      (op.ld * 2) % 16 || op.cols > op.ld || op.rows < 1 || op.cols < 1)
    return cudaErrorInvalidValue;
  const cuuint64_t dims[2] = {(cuuint64_t)op.cols, (cuuint64_t)op.rows};
  const cuuint64_t strides[1] = {(cuuint64_t)op.ld * 2};
  const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                        const_cast<void*>(op.base), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A bf16 4-D view (d, S, H, B) read through its strides (elements; d is
// contiguous), as the attention backward reads q, k, v and dO.
struct View4 {
  const void* base;
  int d, s, h, b;
  long long st_s, st_h, st_b;
};

// Its TMA map: boxes of 64 d-columns (128 bytes) by box_rows rows of one
// head, the 128-byte swizzle, zeros past S within the head (a ragged
// length never reads the next head's rows). TMA's rules: the base 16-byte
// aligned, every stride a multiple of 16 bytes, d a multiple of 64.
inline cudaError_t make_map_4d(CUtensorMap* map, const View4& v,
                               int box_rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  if (v.base == nullptr || (reinterpret_cast<uintptr_t>(v.base) & 15) ||
      v.d % 64 || v.s < 1 || v.h < 1 || v.b < 1 || (v.st_s * 2) % 16 ||
      (v.st_h * 2) % 16 || (v.st_b * 2) % 16)
    return cudaErrorInvalidValue;
  const cuuint64_t dims[4] = {(cuuint64_t)v.d, (cuuint64_t)v.s,
                              (cuuint64_t)v.h, (cuuint64_t)v.b};
  const cuuint64_t strides[3] = {(cuuint64_t)v.st_s * 2,
                                 (cuuint64_t)v.st_h * 2,
                                 (cuuint64_t)v.st_b * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)box_rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(v.base), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

inline int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess || sms < 1)
    return 132;
  return sms;
}

// Launches `kernel` on one block per SM, at most one per work item, with
// the Tile's dynamic shared memory; `args` follow the Params.
template <int BN, typename Kernel, typename... Args>
cudaError_t run(Kernel kernel, const Params& p, int sms, cudaStream_t stream,
                const Args&... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile<BN>::SMEM);
  if (err != cudaSuccess) return err;
  const int items =
      ((p.m + BM - 1) / BM) * ((p.n + BN - 1) / BN) * p.splits;
  kernel<<<items < sms ? items : sms, THREADS, Tile<BN>::SMEM, stream>>>(
      p, args...);
  return cudaGetLastError();
}

// Builds the maps of `segments` (X, Y) pairs for BN-wide tiles and launches
// `kernel` (a __global__ wrapper of gemm_body<BN, F32>) on one block per SM,
// at most one per tile. x[s] and y[s] share their contraction length.
template <int BN, typename Kernel>
cudaError_t launch(Kernel kernel, const Operand* x, const Operand* y,
                   int segments, Params p, int sms, cudaStream_t stream) {
  if (segments < 1 || segments > 2 || p.m < 1 || p.n < 1)
    return cudaErrorInvalidValue;
  for (int s = 0; s < 2; ++s) {
    p.k_tiles[s] = 0;
    if (s >= segments) continue;
    if (x[s].cols != y[s].cols) return cudaErrorInvalidValue;
    cudaError_t err = make_map(&p.x[s], x[s], BM);
    if (err == cudaSuccess) err = make_map(&p.y[s], y[s], BN);
    if (err != cudaSuccess) return err;
    p.k_tiles[s] = (x[s].cols + BK - 1) / BK;
  }
  p.y_halves = 1;
  p.splits = 1;
  p.k_per_split = p.k_tiles[0] + p.k_tiles[1];
  return run<BN>(kernel, p, sms, stream);
}

// The same for one segment with an MN-major Y: y[h] (rows = the
// contraction, cols = N) for each of `halves` column halves, the
// contraction split `splits` ways (every split non-empty).
template <int BN, typename Kernel, typename... Args>
cudaError_t launch_mn(Kernel kernel, const Operand& x, const Operand* y,
                      int halves, int splits, Params p, int sms,
                      cudaStream_t stream, const Args&... args) {
  if (halves < 1 || halves > 2 || (halves == 2 && BN < 128) || p.m < 1 ||
      p.n < 1 || splits < 1)
    return cudaErrorInvalidValue;
  cudaError_t err = make_map(&p.x[0], x, BM);
  for (int h = 0; h < halves && err == cudaSuccess; ++h) {
    if (y[h].rows != x.cols) return cudaErrorInvalidValue;
    err = make_map(&p.y[h], y[h], BK);   // 64-column boxes of BK rows
  }
  if (err != cudaSuccess) return err;
  p.k_tiles[0] = (x.cols + BK - 1) / BK;
  p.k_tiles[1] = 0;
  p.y_halves = halves;
  p.splits = splits;
  p.k_per_split = (p.k_tiles[0] + splits - 1) / splits;
  if ((splits - 1) * p.k_per_split >= p.k_tiles[0])
    return cudaErrorInvalidValue;   // an empty split
  return run<BN>(kernel, p, sms, stream, args...);
}

}  // namespace sm90

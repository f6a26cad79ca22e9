// Building blocks of the port's bf16 kernels for Hopper (sm_90a), shared
// by the flash-attention forward (flash_attention/csrc/flash_fwd.cu, B1)
// and backward (flash_bwd.cu, B2a and B2b), the Mamba2 SSD scan
// (ssm_scan/csrc/ssd_scan.cu, B4) and the RWKV6 scan
// (rwkv6_scan/csrc/rwkv6_scan.cu, B5): mbarriers, TMA loads and stores
// through 4-D tensor maps, wgmma on bf16 with float32 accumulators, the
// swizzled tile layout both name, fragments to and from [64][64] tiles,
// and the order of the persistent blocks' work tiles. nvcc finds this file
// through the -I that kernels/_build.py gives it, and the hash in each
// library's name covers it.
//
// Every kernel built on them has the same shape: a producer warpgroup
// whose first warp keeps TMA loads in flight into mbarrier-guarded
// stages, then consumer warpgroups whose products run on wgmma (two of 64
// rows each; B5 has two that form operands and one that runs the
// products).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {
namespace hopper {

using bf16 = __nv_bfloat16;
constexpr int BLOCK_M = 128;     // rows of a work tile
constexpr int CONSUMERS = 2;     // warpgroups of 64 rows each
constexpr int THREADS = 128 * (1 + CONSUMERS);  // warpgroup 0 loads
constexpr int STAGES = 2;        // tiles in flight in a ring
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// A tile of HD columns is stored as NBOX boxes of [rows][CW] bf16, each box
// as TMA writes it: rows of RB bytes, swizzled over the row (128, 64 or 32
// bytes), which is the layout wgmma's descriptors name. HD is a tile width
// (16, 32, 64 or 128), not necessarily the tensor's head dim: a head dim of
// 112 (kimi-k2) runs the 128-column tiles, the tensor maps' dimension 0 set
// to 112 (`tensor_map`'s `cols`), so TMA fills columns 112..127 with zeros
// on each load and leaves them out of each store. The zeros add nothing to
// q.k, dO.v or any product over hd, the real scale comes in from the caller,
// and the padded output columns are never written. That costs 16/112 = 14 %
// more MMA work and shared memory than exact tiles, and needs no new wgmma
// shape or box count; seven 16-column boxes (the 32-byte swizzle, an m64n112
// `rs`) would have been exact, at seven TMA requests a tile and a new
// instance of every body to check.
template <int HD>
struct Box {
  static constexpr int CW = HD < 64 ? HD : 64;  // columns of one box
  static constexpr int NBOX = HD / CW;
  // a width the boxes do not tile (112 = 64 + 48) would drop its last
  // columns without a word
  static_assert(HD % CW == 0 && HD % 16 == 0, "boxes of CW columns must tile HD");
  static constexpr int RB = CW * 2;             // bytes of a box row
  static constexpr uint64_t LAYOUT = RB == 128 ? 1 : RB == 64 ? 2 : 3;
  static constexpr CUtensorMapSwizzle SWIZZLE =
      RB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
      : RB == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" :: "r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// the transaction bytes of the current phase, without an arrival
__device__ __forceinline__ void bar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// until the phase of the given parity has completed
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  } while (!done);
}

// one box of a 4-D (hd, heads, S, B) tensor map into shared memory,
// completing on `bar`; rows past S arrive as zeros
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int col, int head,
                                         int row, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(col), "r"(head), "r"(row), "r"(b)
      : "memory");
}

// one box of a 4-D map from shared memory, in this thread's bulk group
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int col, int head,
                                          int row, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)), "r"(col),
         "r"(head), "r"(row), "r"(b)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// until at most N committed groups of this warpgroup's wgmma are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// keeps the compiler from touching registers that wgmma owns until here
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j]) :: "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units) and the swizzle layout
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo, uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
       | static_cast<uint64_t>(lbo >> 4) << 16
       | static_cast<uint64_t>(sbo >> 4) << 32 | layout << 62;
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A float32 pair cut into K packed bf16 pairs, the terms whose sum a
// product with a float32 operand runs on (B4, B5): the pair rounded to
// nearest, then what each step leaves cut to bf16 by truncation (a mask
// and a byte permute: integer work at the full rate, where a conversion
// runs at a fraction of it). Each remainder is exact in float32; the first
// is within 2^-9 of the value, each later one within 2^-7 of the one
// before, so three terms leave ~2^-23 of the value, near float32's own.
template <int K>
__device__ __forceinline__ void split(float a, float b, uint32_t (&out)[K]) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  out[0] = *reinterpret_cast<const uint32_t*>(&v);
  const float2 f = __bfloat1622float2(v);
  a -= f.x;
  b -= f.y;
#pragma unroll
  for (int k = 1; k < K; ++k) {
    const uint32_t ua = __float_as_uint(a), ub = __float_as_uint(b);
    out[k] = __byte_perm(ua, ub, 0x7632);  // the high halves: the pair truncated
    a -= __uint_as_float(ua & 0xffff0000u);
    b -= __uint_as_float(ub & 0xffff0000u);
  }
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// wgmma m64nNk16, bf16 in, float32 accumulate, N / 2 accumulators a
// thread: `ss` (N = a tile's rows) reads A and B (both K-major) from
// shared memory, `rs` (N = hd) reads A from registers and B MN-major
// from shared memory
template <int N>
struct Mma;

template <>
struct Mma<16> {  // rs at hd = 16
  // d += A . B, A (64 x 16) from registers, B (16 x 16) MN-major in shared memory
  __device__ __forceinline__ static void rs(float (&d)[8],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
  }
};

template <>
struct Mma<32> {  // rs at hd = 32
  // d += A . B, A (64 x 16) from registers, B (16 x 32) MN-major in shared memory
  __device__ __forceinline__ static void rs(float (&d)[16],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
  }
};

template <>
struct Mma<64> {
  // d (+)= A . B, A (64 x 16) and B (16 x 64) from shared memory; B K-major
  __device__ __forceinline__ static void ss(float (&d)[32], uint64_t da,
                                            uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(acc));
  }
  // d += A . B, A (64 x 16) from registers, B (16 x 64) MN-major in shared memory
  __device__ __forceinline__ static void rs(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
  }
};

template <>
struct Mma<128> {
  // d (+)= A . B, A (64 x 16) and B (16 x 128) from shared memory; B K-major
  __device__ __forceinline__ static void ss(float (&d)[64], uint64_t da,
                                            uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(acc));
  }
  // d += A . B, A (64 x 16) from registers, B (16 x 128) MN-major in shared memory
  __device__ __forceinline__ static void rs(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
  }
};

// x, recomputed where it is used: keeps the compiler from hoisting what is
// derived from it (descriptors, addresses) out of the loops, where it
// would hold registers that the accumulators need
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("" : "+r"(x));
  return x;
}

// An m64nN accumulator rounded to bf16 as the A fragments of the next
// product, one per 16 of its columns. Element i of the accumulator sits at
// row 8 * ((i >> 1) & 1) + g, column 8 * (i >> 2) + 2 * t + (i & 1) of the
// warp's 16 rows (g = lane / 4, t = lane % 4), as the A fragment wants it.
template <int BN>
__device__ __forceinline__ void to_bf16(const float (&sc)[BN / 2],
                                        uint32_t (&pa)[BN / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    pa[kk][0] = pack(sc[8 * kk + 0], sc[8 * kk + 1]);
    pa[kk][1] = pack(sc[8 * kk + 2], sc[8 * kk + 3]);
    pa[kk][2] = pack(sc[8 * kk + 4], sc[8 * kk + 5]);
    pa[kk][3] = pack(sc[8 * kk + 6], sc[8 * kk + 7]);
  }
}

// D (64 x N) = A . B^T over hd, both K-major, 16 columns of hd a step: A is
// the warpgroup's 64 rows of a tile of BLOCK_M rows (a_addr at its first
// row), B a tile of N rows. Within a box the start address moves by 32
// bytes a step.
template <int HD, int N>
__device__ __forceinline__ void issue_ss(float (&d)[N / 2], uint32_t a_addr,
                                         uint32_t b_addr) {
  using C = Box<HD>;
  const uint64_t da = desc(opaque(a_addr), 16, 8 * C::RB, C::LAYOUT);
  const uint64_t db = desc(opaque(b_addr), 16, 8 * C::RB, C::LAYOUT);
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t box = kk * 16 / C::CW, col = (kk * 16 % C::CW) * 2;
    Mma<N>::ss(d, da + ((box * BLOCK_M * C::RB + col) >> 4),
               db + ((box * N * C::RB + col) >> 4), kk > 0);
  }
}

// D (64 x HD) += A . B: A (64 x K) from registers, B a [K rows][HD] tile
// read MN-major, 16 rows a step; the leading byte offset steps from one
// 64-column box to the next
template <int HD, int K>
__device__ __forceinline__ void issue_rs(float (&d)[HD / 2],
                                         const uint32_t (&a)[K / 16][4],
                                         uint32_t b_addr) {
  using C = Box<HD>;
  const uint64_t db = desc(opaque(b_addr), K * C::RB, 8 * C::RB, C::LAYOUT);
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
    Mma<HD>::rs(d, a[kk], db + ((kk * 16 * C::RB) >> 4));
}

// This warp's 16 rows of an m64nHD accumulator, times the scale of each of
// the thread's two rows and rounded to bf16, into rows [row, row + 16) of a
// staging tile of BLOCK_M rows, in the swizzled layout that the store's
// tensor map names
template <int HD>
__device__ __forceinline__ void stage_rows(uint32_t tile, const float (&acc)[HD / 2],
                                           const float (&scale)[2], int row, int g,
                                           int t) {
  using C = Box<HD>;
  const uint32_t row_off = opaque((row + g) * C::RB + 4 * t);
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      uint32_t off = (8 * j / C::CW) * BLOCK_M * C::RB + row_off + 8 * r * C::RB
                   + (8 * j % C::CW) * 2;
      off ^= ((off >> 7) & (C::RB / 16 - 1)) << 4;
      st_shared(tile + off, pack(acc[4 * j + 2 * r] * scale[r],
                                 acc[4 * j + 2 * r + 1] * scale[r]));
    }
}

// Rows [tile_row, tile_row + 16) of a staging tile to rows [row, row + 16)
// of a 4-D map, one TMA store a box, in this thread's bulk group; the store
// writes only the rows below the map's S
template <int HD>
__device__ __forceinline__ void store_rows(const CUtensorMap* map, const bf16* tile,
                                           int tile_row, int head, int row, int b) {
  using C = Box<HD>;
#pragma unroll
  for (int x = 0; x < C::NBOX; ++x)
    tma_store(map, tile + x * BLOCK_M * C::CW + tile_row * C::CW, x * C::CW, head,
              row, b);
}

__device__ __forceinline__ void st_shared4(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n"
               :: "r"(addr), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w) : "memory");
}

// the 128 threads of one warpgroup, on named barrier `id` (B4: consumer
// warpgroup `id` - 1)
__device__ __forceinline__ void sync_consumer(int id) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(id) : "memory");
}

// Lane l's row address in a [64][64] tile for ldmatrix / stmatrix of the
// warp's 16 rows, columns [16 kk, 16 kk + 16): matrix i = l / 8 covers rows
// + 8 (i % 2) and columns + 8 (i / 2), the order of an A fragment's
// registers
__device__ __forceinline__ uint32_t frag_addr(uint32_t tile, int kk, int warp,
                                              int lane) {
  const int i = lane / 8, row = 16 * warp + 8 * (i % 2) + lane % 8;
  const int piece = 2 * kk + i / 2;  // 16-byte piece of the row
  return tile + row * 128 + ((piece ^ (row & 7)) << 4);
}

// the A fragments of this warp's 16 rows of a [64][64] tile, 4 x 16 columns
__device__ __forceinline__ void load_a(uint32_t (&a)[4][4], uint32_t tile, int warp,
                                       int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(a[kk][0]), "=r"(a[kk][1]), "=r"(a[kk][2]), "=r"(a[kk][3])
                 : "r"(frag_addr(tile, kk, warp, lane)) : "memory");
}

// the inverse: fragments laid out as load_a reads them, into the tile
__device__ __forceinline__ void store_a(uint32_t tile, const uint32_t (&a)[4][4],
                                        int warp, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n"
                 :: "r"(frag_addr(tile, kk, warp, lane)), "r"(a[kk][0]),
                    "r"(a[kk][1]), "r"(a[kk][2]), "r"(a[kk][3]) : "memory");
}

// d += A . B, A (64 x 16) and B (16 x 64) both MN-major in shared memory
__device__ __forceinline__ void mma_tt(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "n"(1));
}

// d += A^T . B over 64 rows, A and B [64][64] tiles read MN-major (B4's
// x^T (w o B), B5's K~^T V); the start address moves 16 rows a step
__device__ __forceinline__ void ss_tn(float (&d)[32], uint32_t a, uint32_t b) {
  const uint64_t da = desc(opaque(a), 8192, 1024, 1), db = desc(opaque(b), 8192, 1024, 1);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) mma_tt(d, da + 128 * kk, db + 128 * kk);
}

// One work tile: BLOCK_M query rows of one (b, h). The tiles are numbered
// heaviest first (causal: the last query rows have the most keys), heads
// fastest, so that tiles that share K/V run at the same time.
template <int BN>
struct Work {
  int q0, h, b, n_tiles;
  __device__ __forceinline__ Work(int w, int Sq, int Sk, int H, int B,
                                  int causal) {
    const int nq = (Sq + BLOCK_M - 1) / BLOCK_M;
    h = w % H;
    b = w / H % B;
    q0 = (nq - 1 - w / (H * B)) * BLOCK_M;
    const int k_end = causal ? min(Sk, q0 + BLOCK_M) : Sk;
    n_tiles = (k_end + BN - 1) / BN;
  }
};

// cuTensorMapEncodeTiled, looked up through the CUDA runtime's entry-point
// query, so that the library needs no -lcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
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
               ? reinterpret_cast<EncodeTiled>(ptr) : nullptr;
  }();
  return fn;
}

// The 4-D (hd, heads, S, B) view of a strided (B, S, heads, hd) bf16
// tensor, read in boxes of [rows][CW]. A dimension of extent 1 is never
// stepped over; it gets the stride of a packed tensor, which TMA accepts
// whatever the caller's tensor says. A tensor of fewer than HD columns
// (`cols`) is read in the same boxes, its columns past `cols` as zeros.
template <int HD>
bool tensor_map(CUtensorMap* map, const void* ptr, int heads, int S, int B,
                long long sh, long long ss, long long sb, int rows,
                int cols = HD) {
  using C = Box<HD>;
  const cuuint64_t dims[4] = {(cuuint64_t)cols, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2,
                           (cuuint64_t)sb * 2};
  cuuint64_t packed = (cuuint64_t)cols * 2;
  for (int i = 0; i < 3; ++i) {
    if (dims[i + 1] == 1) strides[i] = packed;
    packed = strides[i] * dims[i + 1];
  }
  const cuuint32_t box[4] = {(cuuint32_t)C::CW, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const EncodeTiled encode = encode_tiled();
  return encode != nullptr
      && encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
                dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                C::SWIZZLE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The persistent grid, one block per SM or one per work tile where there are
// fewer, once the kernel may use `smem` bytes of dynamic shared memory
template <typename Kernel>
cudaError_t persistent_grid(Kernel kernel, int smem, long long n_work,
                            int* grid) {
  int dev, sms;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (n_work > (1ll << 31) - 1) return cudaErrorInvalidValue;
  *grid = n_work < sms ? (int)n_work : sms;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

}  // namespace hopper
}  // namespace

// RWKV6 ("Finch") scan for Hopper (sm_90a), with a plain C interface for
// ctypes.
//
// Replaces: src/repro/kernels/rwkv6_scan/kernel.py:22 `_rwkv_kernel`
// (launched by `rwkv6_scan` at :54, `pl.pallas_call` at :66). Same function:
// per (b, h), from a zero (N, N) state S indexed S[n_k][n_v],
//   y_t = r_t^T (S + (u o k_t) v_t^T),   S <- diag(w_t) S + k_t v_t^T,
// everything in float32 (r, k and v are cast before k_t v_t^T) and y
// written in float32. Unlike the TPU kernel it also writes the final state
// (prefill needs it for the decode cache), takes any T >= 1 without padding
// (a padded step would have w = 0 and wipe the state), and reads r, k, v, w
// and u through their strides.
//
// What bounds it on an H100: at rwkv6-3b's prefill (B=4, T=512, H=40,
// N=64, bf16 r/k/v, float32 w) one call reads ~52 MB and writes ~24 MB (y
// and the state in float32), ~0.023 ms at 3.35 TB/s. Run step by step, the
// recurrence is ~2.3 GFLOP of float32 work on the CUDA cores (~0.035 ms at
// 67 TFLOP/s, more than the bytes); in the chunked form below most of it
// moves onto the tensor cores. The card has only B*H = 160 (b, h) pairs to
// spread over its 132 SMs, and each pair's chunks run in order.
//
// The C entry point chooses the body by the dtype of r, k and v:
//
// * bfloat16 (rwkv6-3b's serving path): the chunked form on wgmma, in
//   namespace hopper below. Each (b, h) is a chain of 64-step chunks that
//   run in order. With S0 the state before a chunk, D_t = prod_{tau<t}
//   w_tau the running product within it (exclusive) and l its valid steps,
//     y_t   = (r_t o D_t)^T S0 + sum_{s<t} A_ts v_s + (sum_n r_tn u_n k_tn) v_t,
//     A_ts  = sum_n r_tn k_sn prod_{s<tau<t} w_tau,n,
//     S_end = diag(D_l) S0 + sum_s (k_s o prod_{s<tau<l} w_tau) v_s^T.
//   Every decay is a product of the w's between two steps that the
//   recurrence applies, never a ratio of two running products, so every
//   factor is <= 1: underflow reaches only what is negligible, and w = 0
//   and w = 1 are exact. A is cut into 16-step sub-chunks: for s in
//   sub-chunk j (last step e_j) and t after it, A = Q^(j) K_j^T with
//   Q^(j)_t = r_t o prod_{e_j<tau<t} w and K_j,s = k_s o prod_{s<tau<=e_j} w;
//   within a sub-chunk A is formed elementwise in float32, and its diagonal
//   is the bonus term. The block's producer warp TMA-loads each chunk's r,
//   k, v and w into a 2-stage mbarrier ring (a tensor that TMA cannot
//   read, such as a k with an n-stride of 2, it loads with plain loads into
//   the same layout). In the consumer warpgroups warp w works on sub-chunk
//   w, lane l on channels 2l and 2l + 1. Two decay warpgroups (rows 0..7
//   and 8..15 of each sub-chunk) form the products of w and write Q^(j),
//   K_j, r o D and K~ = k o prod_{s<tau<l} w to shared memory as bf16
//   terms. The products warpgroup keeps S as a wgmma accumulator, [n_k
//   rows][n_v columns], and runs the chunk's four products on wgmma with
//   float32 accumulators:
//     P2  A  = Q^(j) K_j^T        (j = 0, 1, 2; N = 16 each)   first group
//     P4  S <- D_l o S + K~^T V   (K~ and V read MN-major)     second group
//     P1  y  = (r o D) S0         (S0's terms read MN-major)
//     P3  y += A V                (A from registers)           third group
//   While the first two groups run, the products warpgroup forms A's
//   diagonal block of its sub-chunk from the stage, in registers (each
//   lane's share of every sum, added over the warp by shuffles). It lets
//   the decay warpgroups write the next chunk's Q^(j) and K_j as soon as
//   P2 has read them (before it issues the second group), and its r o D
//   and K~ once P1 and P4 have. Each float32
//   operand is cut into TERMS bf16 terms (its value rounded, then what that
//   leaves truncated, ...); a product of two float32 operands (P1, P2) sums
//   the products of term pairs (qa, qb) with qa + qb < TERMS, one with a
//   bf16 operand (P3, P4: V is exact) the TERMS products of the other's
//   terms. Three terms reach float32's level (tests/test_torch_rwkv6_split.py
//   emulates this arithmetic on the CPU). A chunk's steps past T are zero
//   rows of r, k and v (TMA fills them) and w = 1 in every decay, so the
//   state leaves the last chunk as it was after step T, and their rows of y
//   are not written. Nothing is summed with atomics, so a second run
//   repeats bit for bit. The operand tiles and the ring take ~214 KB of
//   shared memory, so one block fits an SM. The blocks are persistent,
//   at most one an SM, and share the chunks of all chains equally (Plan):
//   a chain cut between two blocks passes its state from one to the next
//   through device memory, so no SM runs a second wave (at rwkv6-3b's
//   prefill, 160 chains of 8 chunks run as 128 blocks of 10, not as 132
//   blocks and then 28 more). Two blocks an SM would need under 113 KB and
//   64 registers a thread each. Within a block, what holds the body back
//   is its ALU work, not the tensor cores or the bytes: the splits into
//   terms of 17 16-row blocks of operands a chunk and the 136 sums of each
//   diagonal block, issued by few warps (a warp or two on each scheduler)
//   whose dependent chains leave most issue slots empty. Four warpgroups
//   (512 threads) share the registers 48 / 120 / 120 / 224.
// * float32 (the float32 path and its checks): one block of 128 threads
//   runs one (b, h) and keeps S in registers for the whole scan, each
//   thread an 8 x 4 tile: rows n = 8i + g (g the lane's row group, 0..7) of
//   four neighbouring columns m. The block works through the steps C at a
//   time:
//   1. stage r, k, v and w of the C steps in shared memory as float32
//      (coalesced rows of 64 per step), and with them c_t = sum_n r_n u_n
//      k_n, the bonus term, which is the same for every column; the loads
//      from device memory were issued into registers before the previous
//      chunk's steps, so their latency hides behind that work;
//   2. each thread runs the C steps with no barrier: per step it loads r_n,
//      k_n and w_n of its 8 rows once for its 4 columns, updates its tile,
//        y_m += r_n S_nm,   S_nm = w_n S_nm + k_n v_m,
//      and stores its 4 partial sums y_m to shared memory; no step waits on
//      another thread, so the loop is loads and FMAs only;
//   3. the block sums the 8 row groups' partials of every (step, column)
//      and writes y_m = that sum + v_m c_t, coalesced.
//   In float32 this is the plain version's r^T (S + (u o k) v^T) with the
//   terms summed in another order.

#include "hopper.cuh"

#include <atomic>

namespace {

constexpr int N = 64;         // head size
constexpr int RG = 8;         // row groups: the lanes that share a column
constexpr int RPT = N / RG;   // rows of S a thread holds
constexpr int CPT = 4;        // columns of S a thread holds
constexpr int NT = RG * N / CPT;  // threads per block
constexpr int C = 32;         // time steps staged in shared memory at once
constexpr int IT = C * N / NT;  // staged (step, row) elements a thread
constexpr unsigned FULL = 0xffffffffu;
// a row of partial sums, padded so that the 8 row groups' float4 stores of
// one column group fall in different banks
constexpr int YLD = N + 4;
// r, k, w, v [C][N]; the partial sums [C][RG][YLD]; c_t's halves [C][2]
constexpr size_t SMEM_FLOATS = 4 * C * N + C * RG * YLD + 2 * C;

struct Params {
  const void* r;     // (B, T, H, N), float32 or bfloat16, as k and v
  const void* k;
  const void* v;
  const float* w;    // (B, T, H, N)
  const float* u;    // (H, N)
  float* y;          // (B, T, H, N), contiguous
  float* s_final;    // (B, H, N, N), contiguous
  int B, T, H;
  long long r_sb, r_st, r_sh, r_sn;  // element strides
  long long k_sb, k_st, k_sh, k_sn;
  long long v_sb, v_st, v_sh, v_sn;
  long long w_sb, w_st, w_sh, w_sn;
  long long u_sh, u_sn;
};

__global__ void __launch_bounds__(NT) rwkv6_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* rs = reinterpret_cast<float*>(smem4);  // [C][N]
  float* ks = rs + C * N;
  float* ws = ks + C * N;
  float* vs = ws + C * N;
  float* ys = vs + C * N;                       // [C][RG][YLD]
  float* cs = ys + C * RG * YLD;                // [C][2]
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int lane = tid % 32, g = lane % RG;
  const int m0 = CPT * (tid / 32 * (32 / RG) + lane / RG);  // first column
  // staging and output: this thread's element sn of steps tid / N + 2 i
  const int sn = tid % N;
  const float* r = static_cast<const float*>(p.r) + b * p.r_sb + h * p.r_sh + sn * p.r_sn;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh + sn * p.k_sn;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh + sn * p.v_sn;
  const float* w = p.w + b * p.w_sb + h * p.w_sh + sn * p.w_sn;
  const float u = p.u[h * p.u_sh + sn * p.u_sn];
  float* y = p.y + ((long long)b * p.T * p.H + h) * N + sn;
  const long long y_st = (long long)p.H * N;

  // the next chunk's elements, loaded ahead; steps past T load step T - 1
  float pr[IT], pk[IT], pv[IT], pw[IT];
  auto prefetch = [&](int t0) {
#pragma unroll
    for (int i = 0; i < IT; ++i) {
      const long long t = min(t0 + tid / N + NT / N * i, p.T - 1);
      pr[i] = r[t * p.r_st];
      pk[i] = k[t * p.k_st];
      pv[i] = v[t * p.v_st];
      pw[i] = w[t * p.w_st];
    }
  };

  float S[RPT][CPT] = {};
  prefetch(0);
  for (int t0 = 0; t0 < p.T; t0 += C) {
    const int steps = min(C, p.T - t0);
    __syncthreads();  // the previous chunk is read
#pragma unroll
    for (int i = 0; i < IT; ++i) {
      const int s = tid / N + NT / N * i;  // the same for the whole warp
      const float rn = pr[i], kn = pk[i];
      rs[s * N + sn] = rn;
      ks[s * N + sn] = kn;
      vs[s * N + sn] = pv[i];
      ws[s * N + sn] = pw[i];
      float ruk = rn * u * kn;
#pragma unroll
      for (int off = 16; off > 0; off /= 2) ruk += __shfl_xor_sync(FULL, ruk, off);
      if (lane == 0) cs[2 * s + sn / 32] = ruk;
    }
    __syncthreads();
    if (t0 + C < p.T) prefetch(t0 + C);
#pragma unroll 2
    for (int s = 0; s < steps; ++s) {
      const float4 vv = *reinterpret_cast<const float4*>(vs + s * N + m0);
      const float vm[CPT] = {vv.x, vv.y, vv.z, vv.w};
      float acc[CPT] = {};
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int n = s * N + RG * i + g;
        const float rn = rs[n], kn = ks[n], wn = ws[n];
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          acc[c] = fmaf(rn, S[i][c], acc[c]);
          S[i][c] = fmaf(kn, vm[c], wn * S[i][c]);
        }
      }
      *reinterpret_cast<float4*>(ys + (s * RG + g) * YLD + m0) =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < C * N / NT; ++i) {
      const int s = tid / N + NT / N * i;
      if (s < steps) {
        float ym = 0.f;
#pragma unroll
        for (int j = 0; j < RG; ++j) ym += ys[(s * RG + j) * YLD + sn];
        y[(t0 + s) * y_st] = fmaf(vs[s * N + sn], cs[2 * s] + cs[2 * s + 1], ym);
      }
    }
  }
  float* sf = p.s_final + ((long long)b * p.H + h) * N * N + m0;
#pragma unroll
  for (int i = 0; i < RPT; ++i)
    *reinterpret_cast<float4*>(sf + (RG * i + g) * N) =
        make_float4(S[i][0], S[i][1], S[i][2], S[i][3]);
}

cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = sizeof(float) * SMEM_FLOATS;
  cudaError_t err = cudaFuncSetAttribute(
      rwkv6_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  rwkv6_kernel<<<dim3(p.H, p.B), NT, smem, stream>>>(p);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// bfloat16 body: TMA into an mbarrier ring, the chunked form on wgmma
// ---------------------------------------------------------------------------

namespace hopper {

constexpr int TERMS = 3;   // bf16 terms of each float32 operand
constexpr int L = 64;      // steps of a chunk: the rows of every tile
constexpr int SUB = 16;    // steps of a sub-chunk
constexpr int TILE = L * 128;        // a [64][64] bf16 tile, rows of 128 bytes
constexpr int W_TILE = L * N * 4;    // a chunk's w, [64][64] float32, unswizzled
constexpr int STAGE = 3 * TILE + W_TILE;  // r, k, v and w of a chunk
// Q^(j) of blocks j = 0, 1, 2 holds only its rows t > e_j: 48, 32 and 16
constexpr int QH_TERM = (48 + 32 + 16) * 128;
constexpr int KJ_TERM = 48 * 128;    // K_j, j = 0, 1, 2: rows 0..47
// byte offsets from the 1024-aligned base: the ring, then each operand's
// TERMS tiles, then float32 vectors and the barriers
constexpr int RD_AT = STAGES * STAGE;           // r o D
constexpr int QH_AT = RD_AT + TERMS * TILE;     // Q^(j)
constexpr int KJ_AT = QH_AT + TERMS * QH_TERM;  // K_j
constexpr int KT_AT = KJ_AT + TERMS * KJ_TERM;  // K~
constexpr int S_AT = KT_AT + TERMS * TILE;      // S0, [n_k][n_v]
// a warp's diagonal block: its SUB (SUB + 1) / 2 = 136 sums (Diagonal),
// added over the warp 32 at a time
constexpr int DG = (SUB * (SUB + 1) / 2 + 31) / 32 * 32;
constexpr int DIAG_AT = S_AT + TERMS * TILE;    // 4 x [DG] float32
constexpr int F_AT = DIAG_AT + 4 * DG * 4;      // 2 x [8][64]: each half sub-chunk's prod w
constexpr int DL_AT = F_AT + 2 * 8 * N * 4;     // [64]: D_l
constexpr int BAR_AT = DL_AT + N * 4;
constexpr int SMEM = 1024 + BAR_AT + 7 * 8;
static_assert(SMEM <= 232448, "more shared memory than a block may have");
constexpr int DECAY = 1, PRODUCTS = 2;  // the consumer warpgroups' named barriers
constexpr int HALF = SUB / 2;           // rows of a sub-chunk a decay warp owns
constexpr int BLOCK_THREADS = 4 * 128;  // producer, two decay, one products warpgroup

// the 256 threads of the two decay warpgroups
__device__ __forceinline__ void sync_decay() {
  asm volatile("bar.sync %0, 256;\n" :: "r"(DECAY) : "memory");
}

struct Bars {
  uint64_t full[STAGES], empty[STAGES];
  uint64_t ready;    // the decay warpgroups have written a chunk's operands
  uint64_t free_qk;  // P2 has read Q^(j) and K_j
  uint64_t free_rk;  // P1 and P4 have read r o D, K~ and S0
};

// byte offset of (row, byte column) in a tile of 128-byte rows in the
// 128-byte swizzle, as TMA writes it and the descriptors name it
__device__ __forceinline__ uint32_t swz(int row, int byte) {
  return row * 128 + ((((byte >> 4) ^ row) & 7) << 4) + (byte & 15);
}

// From a term's base, the offset of the view of Q^(j) whose logical row t
// is row t of the block: its rows t <= e_j fall on other data, which P2
// reads into rows of A that are then overwritten
__device__ __forceinline__ int qh_view(int j) {
  return (j == 0 ? -16 : j == 1 ? 48 - 32 : 80 - 48) * 128;
}

__device__ __forceinline__ float2 mul2(float2 a, float2 b) {
  return make_float2(a.x * b.x, a.y * b.y);
}

// a packed bf16 pair as float32
__device__ __forceinline__ float2 unpack(uint32_t v) {
  return make_float2(__uint_as_float(v << 16), __uint_as_float(v & 0xffff0000u));
}

__device__ __forceinline__ uint32_t ld_shared(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ float2 ld_shared_f2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(addr) : "memory");
  return v;
}

// v's TERMS bf16 terms (split) at shared address `at` + `off` of the TERMS
// tiles, `stride` apart
__device__ __forceinline__ void put(uint32_t at, int stride, uint32_t off, float2 v) {
  uint32_t parts[TERMS];
  split(v.x, v.y, parts);
#pragma unroll
  for (int q = 0; q < TERMS; ++q) st_shared(at + q * stride + off, parts[q]);
}

// d (+)= A . B, A (64 x 16) K-major and B (16 x 64) MN-major, both in
// shared memory
__device__ __forceinline__ void mma_kt(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "n"(1));
}

// columns [16 J, 16 J + 16) of an m64n64 accumulator += A . B^T, A (64 x
// 16) and B (16 rows of 16) both K-major in shared memory
template <int J>
__device__ __forceinline__ void mma16(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[8 * J + 0]), "+f"(d[8 * J + 1]), "+f"(d[8 * J + 2]), "+f"(d[8 * J + 3]),
        "+f"(d[8 * J + 4]), "+f"(d[8 * J + 5]), "+f"(d[8 * J + 6]), "+f"(d[8 * J + 7])
      : "l"(da), "l"(db), "n"(1));
}

// P1: y += (r o D) S0 over n_k, 16 a step: r o D [t][n_k] read K-major
// (the start address moves 32 bytes a step), S0 [n_k][n_v] MN-major (16
// rows a step); the term pairs qa + qb < TERMS
__device__ __forceinline__ void p1(float (&y)[32], uint32_t rd, uint32_t s0) {
#pragma unroll
  for (int qa = 0; qa < TERMS; ++qa)
#pragma unroll
    for (int qb = 0; qa + qb < TERMS; ++qb) {
      const uint64_t da = desc(opaque(rd + qa * TILE), 16, 1024, 1);
      const uint64_t db = desc(opaque(s0 + qb * TILE), 8192, 1024, 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) mma_kt(y, da + 2 * kk, db + 128 * kk);
    }
}

// P2 for block J: A[:, 16 J, 16 J + 16) = Q^(J) K_J^T over n, both read
// K-major; the term pairs qa + qb < TERMS
template <int J>
__device__ __forceinline__ void p2(float (&a)[32], uint32_t qh, uint32_t kj) {
#pragma unroll
  for (int qa = 0; qa < TERMS; ++qa)
#pragma unroll
    for (int qb = 0; qa + qb < TERMS; ++qb) {
      const uint64_t da = desc(opaque(qh + qa * QH_TERM + qh_view(J)), 16, 1024, 1);
      const uint64_t db = desc(opaque(kj + qb * KJ_TERM + J * SUB * 128), 16, 1024, 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) mma16<J>(a, da + 2 * kk, db + 2 * kk);
    }
}

// a where the bits of m are set, b elsewhere: one lop3 on registers (a
// conditional expression here became an indexed load from a stack copy)
__device__ __forceinline__ float pick(uint32_t m, float a, float b) {
  uint32_t r;
  asm("lop3.b32 %0, %1, %2, %3, 0xE4;\n"
      : "=r"(r) : "r"(__float_as_uint(a)), "r"(__float_as_uint(b)), "r"(m));
  return __uint_as_float(r);
}

// One step of reduce_scatter: the lane keeps the half of v[0, 2 OFF) that
// its bit OFF selects and adds the other half of its partner's (lane ^ OFF)
template <int OFF>
__device__ __forceinline__ void scatter_step(float (&v)[32], int lane) {
  const uint32_t up = lane & OFF ? 0xffffffffu : 0u;
#pragma unroll
  for (int i = 0; i < OFF; ++i) {
    const float send = pick(up, v[i], v[i + OFF]);
    const float keep = pick(up, v[i + OFF], v[i]);
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
  }
}

// For 32 values v[i] in each lane of the warp: lane i gets the sum of v[i]
// over the lanes. (Every index is a compile-time constant, so that v stays
// in registers.)
__device__ __forceinline__ float reduce_scatter(float (&v)[32], int lane) {
  scatter_step<16>(v, lane);
  scatter_step<8>(v, lane);
  scatter_step<4>(v, lane);
  scatter_step<2>(v, lane);
  scatter_step<1>(v, lane);
  return v[0];
}

// Row T of the diagonal block and the rows after it, up to END (Diagonal)
template <int T, int END>
__device__ __forceinline__ void diagonal_rows(float* dg, float (&v)[32],
                                              const uint32_t (&r)[SUB],
                                              const float2 (&k)[SUB],
                                              const float2 (&w)[SUB], float2 u,
                                              int lane) {
  float2 q = unpack(r[T]);
#pragma unroll
  for (int d = 0; d <= T; ++d) {
    const int s = T - d, slot = T * (T + 1) / 2 + d;
    const float2 ks = k[s];
    if (d == 0) {
      v[slot % 32] = fmaf(q.x * u.x, ks.x, q.y * u.y * ks.y);
    } else {
      v[slot % 32] = fmaf(q.x, ks.x, q.y * ks.y);
      q = mul2(q, w[s]);
    }
    if (slot % 32 == 31) dg[slot / 32 * 32 + lane] = reduce_scatter(v, lane);
  }
  if constexpr (T + 1 < END) diagonal_rows<T + 1, END>(dg, v, r, k, w, u, lane);
}

// The diagonal block of A for this warp's sub-chunk, in float32: for
// t = 0..15 and s = t, t - 1, ..., 0 in turn (slot t (t + 1) / 2 + t - s),
//   s = t:  sum_n r_tn u_n k_tn          (the bonus term),
//   s < t:  sum_n r_tn k_sn prod_{s<tau<t} w_tau,n.
// Lane l holds channels 2l and 2l + 1 of the sub-chunk's r (packed bf16),
// k and w in registers and forms its share of each sum, walking s down
// with q = r_t o prod_{s<tau<t} w; every 32 slots the warp adds the shares
// (reduce_scatter) and lane i stores slot i of them. No shared memory is
// read. It runs in two parts, rows [0, 11) and [11, 16) (66 and 70
// slots), so that the caller can do something between them; v carries
// the open group of slots from one to the other.
struct Diagonal {
  static_assert(SUB == 16, "the slots are laid out for 16 steps");
  static constexpr int SPLIT = 11, SLOTS = SUB * (SUB + 1) / 2;
  float v[32];
  uint32_t r[SUB];
  float2 k[SUB], w[SUB];

  // r, k and w of rows [t0, t0 + 16) of the stage at `st`, lane l's channels
  __device__ __forceinline__ void load(uint32_t st, int t0, uint32_t col, int lane) {
#pragma unroll
    for (int i = 0; i < SUB; ++i) {
      const uint32_t off = swz(t0 + i, col);
      r[i] = ld_shared(st + off);
      k[i] = unpack(ld_shared(st + TILE + off));
      w[i] = ld_shared_f2(st + 3 * TILE + (t0 + i) * N * 4 + 8 * lane);
    }
  }
  __device__ __forceinline__ void first(float* dg, float2 u, int lane) {
    diagonal_rows<0, SPLIT>(dg, v, r, k, w, u, lane);
  }
  __device__ __forceinline__ void second(float* dg, float2 u, int lane) {
    diagonal_rows<SPLIT, SUB>(dg, v, r, k, w, u, lane);
#pragma unroll
    for (int i = SLOTS % 32; i < 32; ++i) v[i] = 0.f;
    dg[SLOTS / 32 * 32 + lane] = reduce_scatter(v, lane);
  }
};

// S's terms as P1's operand: the accumulator's TERMS bf16 terms (split)
// as A fragments, by stmatrix into [n_k][n_v] tiles
__device__ __forceinline__ void stage_state(uint32_t tiles, const float (&acc)[32],
                                            int warp, int lane) {
  uint32_t sf[TERMS][4][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = 4 * j + 2 * r;
      uint32_t parts[TERMS];
      split(acc[i], acc[i + 1], parts);
#pragma unroll
      for (int q = 0; q < TERMS; ++q) sf[q][j / 2][2 * (j % 2) + r] = parts[q];
    }
#pragma unroll
  for (int q = 0; q < TERMS; ++q) store_a(tiles + q * TILE, sf[q], warp, lane);
}

// The accumulator's share of S ([n_k][n_v], float32) to a chain's state in
// device memory, and back (through L2: another SM may have written it)
__device__ __forceinline__ void store_state(float* sg, const float (&acc)[32], int warp,
                                            int lane) {
  const int g = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<float2*>(sg + (16 * warp + 8 * r + g) * N + 8 * j + 2 * t4) =
          make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
}

__device__ __forceinline__ void load_state(float (&acc)[32], const float* sg, int warp,
                                           int lane) {
  const int g = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 v = __ldcg(reinterpret_cast<const float2*>(
          sg + (16 * warp + 8 * r + g) * N + 8 * j + 2 * t4));
      acc[4 * j + 2 * r] = v.x;
      acc[4 * j + 2 * r + 1] = v.y;
    }
}

// A chunk's 64 rows of a bf16 tensor that TMA cannot read, by the producer
// warp's plain loads into the swizzled layout TMA would give: lane l loads
// channels 2l and 2l + 1 of every row; rows past T are zeros
__device__ __forceinline__ void load_bf16(unsigned char* tile, const void* src,
                                          long long st, long long sn, int t0, int T,
                                          int lane) {
  const unsigned short* at =
      static_cast<const unsigned short*>(src) + 2 * lane * sn + t0 * st;
  const int rows = min(L, T - t0);
#pragma unroll 1
  for (int i = 0; i < L; ++i, at += st)
    *reinterpret_cast<uint32_t*>(tile + swz(i, 4 * lane)) =
        i < rows ? (uint32_t)at[0] | (uint32_t)at[sn] << 16 : 0u;
}

// the same for float32 w, into its unswizzled [64][64] tile
__device__ __forceinline__ void load_f32(unsigned char* tile, const float* src,
                                         long long st, long long sn, int t0, int T,
                                         int lane) {
  const float* at = src + 2 * lane * sn + t0 * st;
  const int rows = min(L, T - t0);
#pragma unroll 1
  for (int i = 0; i < L; ++i, at += st)
    *reinterpret_cast<float2*>(tile + i * N * 4 + 8 * lane) =
        i < rows ? make_float2(at[0], at[sn]) : make_float2(0.f, 0.f);
}

// A block's share of the scan. The B * H chains of (b, h), n_chunks
// chunks each, are laid end to end and cut into segments of `per` chunks,
// one a block (per >= n_chunks, so a chain falls in at most two segments,
// and the blocks of a grid no larger than the SMs carry equal work). A
// chain cut by the end of block q's segment is begun by block q, which
// leaves its state in s_final and raises a flag, and finished by block
// q + 1 from that state. Block q runs the chain it begins first, then its
// whole chains, then the chain it finishes: it waits only at its end, for
// what block q - 1 ran first. Each chunk's arithmetic is that of one
// block per chain, and the state passes through device memory in float32
// as it is, so the result is the same bit for bit.
struct Piece {
  int bh, c0, c1;   // the chain, b * H + h, and its chunks [c0, c1)
  bool resumes;     // c0 > 0: S0 is what the block before left
  bool hands_off;   // c1 < n_chunks: the block after finishes the chain
};

struct Plan {
  int nc, lo, hi;   // chunks a chain; the segment [lo, hi) of all chunks
  __device__ __forceinline__ Plan(int n_chunks, int per, int n_chains, int q)
      : nc(n_chunks), lo(q * per), hi(min(q * per + per, n_chains * n_chunks)) {}
  __device__ __forceinline__ int begun() const { return hi % nc != 0; }
  __device__ __forceinline__ int resumed() const { return lo % nc != 0; }
  __device__ __forceinline__ int whole() const { return hi / nc - (lo + nc - 1) / nc; }
  __device__ __forceinline__ int size() const { return begun() + whole() + resumed(); }
  // the block's k-th piece, in the order it runs them
  __device__ __forceinline__ Piece operator[](int k) const {
    if (k < begun()) return {hi / nc, 0, hi % nc, false, true};
    k -= begun();
    if (k < whole()) return {(lo + nc - 1) / nc + k, 0, nc, false, false};
    return {lo / nc, lo % nc, nc, true, false};
  }
};

// The flags of the chains handed from block q to block q + 1, at [set][q]:
// 1 once block q's state is in s_final, back to 0 once block q + 1 has
// seen it. Calls take the sets in turn, so that calls on other streams
// that run at the same time do not share a flag.
constexpr int HANDOFF_SETS = 8, MAX_GRID = 1024;
__device__ unsigned int handoff[HANDOFF_SETS][MAX_GRID];

__device__ __forceinline__ void raise_flag(unsigned int* f) {
  asm volatile("st.release.gpu.u32 [%0], %1;\n" :: "l"(f), "r"(1u) : "memory");
}

// Until the flag is up, then down again. The block before raises it
// with the first piece it runs, so the wait ends once that block has run
// it. (A bounded wait that traps made ptxas spill the accumulators.)
__device__ __forceinline__ void await_flag(unsigned int* f) {
  unsigned int v;
  do {
    asm volatile("ld.acquire.gpu.u32 %0, [%1];\n" : "=r"(v) : "l"(f) : "memory");
  } while (!v);
  asm volatile("st.relaxed.gpu.u32 [%0], %1;\n" :: "l"(f), "r"(0u) : "memory");
}

// S0 of a piece: zero, or the state that the block before left in
// s_final, once its flag is up
__device__ __forceinline__ void begin_piece(float (&acc)[32], const Piece& pc,
                                            const Params& p, int set, int warp, int lane,
                                            int tid) {
  if (pc.resumes) {
    if (tid == 0) await_flag(&handoff[set][blockIdx.x - 1]);
    sync_consumer(PRODUCTS);
    load_state(acc, p.s_final + (long long)pc.bh * N * N, warp, lane);
  } else {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  }
}

// One block: the pieces of its segment (Plan). Warpgroup 0's first warp
// keeps the ring full; warpgroups 1 and 2 (decay) form each chunk's bf16
// operands; warpgroup 3 (products) runs the chunk's products and holds S
// and y. All four walk the same chunks in the same order; `it` counts
// them for the barriers' phases. `plain`: bits 0..3 for r, k, v and w,
// set where the producer loads the tensor with plain loads instead of its
// tensor map.
__global__ void __launch_bounds__(BLOCK_THREADS, 1)
rwkv6_kernel(const __grid_constant__ CUtensorMap tr,
             const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv,
             const __grid_constant__ CUtensorMap tw, const Params p,
             const int plain, const int per, const int set) {
  extern __shared__ unsigned char smem_raw[];
  // swizzled tiles need 1024-byte alignment
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t sbase = smem_u32(base);
  Bars* bars = reinterpret_cast<Bars*>(base + BAR_AT);
  float* fs = reinterpret_cast<float*>(base + F_AT);
  float* dl = reinterpret_cast<float*>(base + DL_AT);
  const Plan plan((p.T + L - 1) / L, per, p.B * p.H, blockIdx.x);
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      bar_init(&bars->full[s], 32);    // the producer warp's lanes
      bar_init(&bars->empty[s], 12);   // one arrival a consumer warp
    }
    bar_init(&bars->ready, 8);         // the decay warps
    bar_init(&bars->free_qk, 4);       // the products warps
    bar_init(&bars->free_rk, 4);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: lane 0 issues the TMA loads; every lane loads the tensors
    // that have no tensor map, then arrives
    asm volatile("setmaxnreg.dec.sync.aligned.u32 48;\n");
    if (warp == 0) {
      const CUtensorMap* maps[4] = {&tr, &tk, &tv, &tw};
      uint32_t bytes = 0;
#pragma unroll
      for (int x = 0; x < 4; ++x)
        if (!(plain >> x & 1)) bytes += x < 3 ? TILE : W_TILE;
      int it = 0;
      for (int k = 0; k < plan.size(); ++k) {
        const Piece pc = plan[k];
        const int b = pc.bh / p.H, h = pc.bh % p.H;
        for (int c = pc.c0; c < pc.c1; ++c, ++it) {
          const int s = it % STAGES, t0 = c * L;
          unsigned char* st = base + s * STAGE;
          bar_wait(&bars->empty[s], ((it / STAGES) & 1) ^ 1);
          if (lane == 0) {
            bar_expect_tx(&bars->full[s], bytes);
#pragma unroll
            for (int x = 0; x < 4; ++x)
              if (!(plain >> x & 1))
                tma_load(st + x * TILE, maps[x], &bars->full[s], 0, h, t0, b);
          }
          if (plain & 1)
            load_bf16(st, static_cast<const bf16*>(p.r) + b * p.r_sb + h * p.r_sh,
                      p.r_st, p.r_sn, t0, p.T, lane);
          if (plain & 2)
            load_bf16(st + TILE, static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh,
                      p.k_st, p.k_sn, t0, p.T, lane);
          if (plain & 4)
            load_bf16(st + 2 * TILE,
                      static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh, p.v_st,
                      p.v_sn, t0, p.T, lane);
          if (plain & 8)
            load_f32(st + 3 * TILE, p.w + b * p.w_sb + h * p.w_sh, p.w_st, p.w_sn, t0,
                     p.T, lane);
          // plain stores are seen by the async proxy (wgmma reads v) before
          // the arrival releases them
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          bar_arrive(&bars->full[s]);
        }
      }
    }
    return;
  }
  // the consumers: warp w owns sub-chunk w (steps 16 w .. 16 w + 15 of each
  // chunk), lane l channels 2l and 2l + 1, at byte column 4l of a bf16 tile
  // and 8l of the w tile
  const int w = warp;
  const uint32_t col = 4 * lane;

  if (wg <= 2) {
    // decay warpgroups: warp w of warpgroup 1 + half owns rows [8 half,
    // 8 half + 8) of sub-chunk w
    asm volatile("setmaxnreg.dec.sync.aligned.u32 120;\n");
    const int half = wg - 1, row0 = SUB * w + HALF * half;
    const float2 one = make_float2(1.f, 1.f);
    int it = 0;
    for (int k = 0; k < plan.size(); ++k) {
      const Piece pc = plan[k];
      for (int c = pc.c0; c < pc.c1; ++c, ++it) {
        const int s = it % STAGES;
        const uint32_t st = sbase + s * STAGE;
        const int valid = min(L, p.T - c * L) - row0;  // steps before T
        bar_wait(&bars->full[s], (it / STAGES) & 1);
        // r, k and w of each step (w 1 past T); ys[i] = prod_{i<tau<8} w_tau
        // of the half, and the product of the half's 8 to the other warps
        uint32_t rv[HALF];
        float2 kv[HALF], wv[HALF], ys[HALF];
#pragma unroll
        for (int i = 0; i < HALF; ++i) {
          const uint32_t off = swz(row0 + i, col);
          rv[i] = ld_shared(st + off);
          kv[i] = unpack(ld_shared(st + TILE + off));
          wv[i] = i < valid ? ld_shared_f2(st + 3 * TILE + (row0 + i) * N * 4 + 8 * lane)
                            : one;
        }
        ys[HALF - 1] = one;
#pragma unroll
        for (int i = HALF - 1; i > 0; --i) ys[i - 1] = mul2(ys[i], wv[i]);
        float* fc = fs + (it & 1) * 8 * N;  // two buffers: no warp overtakes a reader
        *reinterpret_cast<float2*>(fc + (2 * w + half) * N + 2 * lane) = mul2(ys[0], wv[0]);
        sync_decay();
        if (lane == 0) bar_arrive(&bars->empty[s]);  // r, k and w are read
        float2 Hp[8], F[4];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          Hp[i] = *reinterpret_cast<const float2*>(fc + i * N + 2 * lane);
#pragma unroll
        for (int i = 0; i < 4; ++i) F[i] = mul2(Hp[2 * i], Hp[2 * i + 1]);
        // R = r o prod of w from the sub-chunk's start (exclusive), and
        // K_w = k o prod of w to its end (exclusive): the other half's
        // product enters the second half's R and the first half's K_w
        const float2 into =
            half ? (w == 0 ? Hp[0] : w == 1 ? Hp[2] : w == 2 ? Hp[4] : Hp[6]) : one;
        const float2 after =
            half ? one : (w == 0 ? Hp[1] : w == 1 ? Hp[3] : w == 2 ? Hp[5] : Hp[7]);
        float2 R[HALF], kj[HALF], x = into;
#pragma unroll
        for (int i = 0; i < HALF; ++i) {
          R[i] = mul2(unpack(rv[i]), x);
          kj[i] = mul2(kv[i], mul2(ys[i], after));
          x = mul2(x, wv[i]);
        }
        // before the sub-chunk, after it, all four, and G[j] = prod_{j<i<w} F_i
        float2 pre = one, post = one, all = one, G[3] = {one, one, one};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (i < w) pre = mul2(pre, F[i]);
          if (i > w) post = mul2(post, F[i]);
          all = mul2(all, F[i]);
#pragma unroll
          for (int j = 0; j < 3; ++j)
            if (j < i && i < w) G[j] = mul2(G[j], F[i]);
        }
        // Q^(j) and K_j once the last chunk's P2 has read them, then r o D
        // and K~ once its P1 and P4 have
        bar_wait(&bars->free_qk, (it & 1) ^ 1);
#pragma unroll
        for (int i = 0; i < HALF; ++i) {
          const uint32_t off = swz(row0 + i, col);
#pragma unroll
          for (int j = 0; j < 3; ++j)
            if (j < w) put(sbase + QH_AT + qh_view(j), QH_TERM, off, mul2(R[i], G[j]));
          if (w < 3) put(sbase + KJ_AT, KJ_TERM, off, kj[i]);
        }
        bar_wait(&bars->free_rk, (it & 1) ^ 1);
        if (w == 0 && half == 0) *reinterpret_cast<float2*>(dl + 2 * lane) = all;
#pragma unroll
        for (int i = 0; i < HALF; ++i) {
          const uint32_t off = swz(row0 + i, col);
          put(sbase + RD_AT, TILE, off, mul2(R[i], pre));
          put(sbase + KT_AT, TILE, off, mul2(kj[i], post));
        }
        // the operands are seen by wgmma (the async proxy) before the arrival
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncwarp();
        if (lane == 0) bar_arrive(&bars->ready);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");

  // products warpgroup: the accumulators' element i sits at row 16 w +
  // 8 ((i >> 1) & 1) + g, column 8 (i >> 2) + 2 t4 + (i & 1). One loop
  // over the block's chunks, with the piece (k), the chunk in its chain
  // (c), and the piece's b, h and u carried from one chunk to the next.
  const int g = lane / 4, t4 = lane % 4;
  float* dg = reinterpret_cast<float*>(base + DIAG_AT) + w * DG;
  int k = 0;
  Piece pc = plan[0];
  int c = pc.c0, b = pc.bh / p.H, h = pc.bh % p.H;
  float2 u = make_float2(p.u[h * p.u_sh + 2 * lane * p.u_sn],
                         p.u[h * p.u_sh + (2 * lane + 1) * p.u_sn]);
  float sacc[32];
  begin_piece(sacc, pc, p, set, w, lane, tid);
  stage_state(sbase + S_AT, sacc, w, lane);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  sync_consumer(PRODUCTS);
  for (int it = 0; it < plan.hi - plan.lo; ++it) {
    const int s = it % STAGES;
    const uint32_t st = sbase + s * STAGE;
    bar_wait(&bars->ready, it & 1);               // the operands
    bar_wait(&bars->full[s], (it / STAGES) & 1);  // r, k, v and w
    const float d_lo = dl[16 * w + g], d_hi = dl[16 * w + g + 8];
    float y[32], a[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      sacc[i] *= (i & 2) ? d_hi : d_lo;
      y[i] = 0.f;
      a[i] = 0.f;
    }
    // each in its own register before the fence (the compiler would
    // otherwise copy one zero into them after it, serialising the wgmma)
    fence_regs(sacc);
    fence_regs(y);
    fence_regs(a);
    wgmma_fence();
    p2<0>(a, sbase + QH_AT, sbase + KJ_AT);  // first group: A = Q^(j) K_j^T
    p2<1>(a, sbase + QH_AT, sbase + KJ_AT);
    p2<2>(a, sbase + QH_AT, sbase + KJ_AT);
    wgmma_commit();
    // while it runs: the first rows of A's diagonal block of this
    // sub-chunk, from the stage; then Q^(j) and K_j are free for the
    // decay warpgroups before the second group is issued (issuing blocks
    // until the tensor cores take the products)
    Diagonal diag;
    diag.load(st, SUB * w, col, lane);
    diag.first(dg, u, lane);
    wgmma_wait<0>();
    fence_regs(a);
    __syncwarp();
    if (lane == 0) bar_arrive(&bars->free_qk);
    wgmma_fence();
#pragma unroll
    for (int q = 0; q < TERMS; ++q)  // second: S <- D_l o S + K~^T V, y = (r o D) S0
      ss_tn(sacc, sbase + KT_AT + q * TILE, st + 2 * TILE);
    p1(y, sbase + RD_AT, sbase + S_AT);
    wgmma_commit();
    diag.second(dg, u, lane);
    __syncwarp();  // the diagonal block is written
    // A: blocks before this warp's sub-chunk from P2, its own from the
    // diagonal block (s <= t), zero after; then its terms as A fragments
#pragma unroll
    for (int jb = 0; jb < 4; ++jb) {
      if (jb < w) continue;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int row = 8 * ((e >> 1) & 1) + g;
        const int cl = 8 * ((e >> 2) & 1) + 2 * t4 + (e & 1);
        a[8 * jb + e] =
            jb == w && cl <= row ? dg[row * (row + 1) / 2 + row - cl] : 0.f;
      }
    }
    uint32_t ga[TERMS][4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = 4 * j + 2 * r;
        uint32_t parts[TERMS];
        split(a[i], a[i + 1], parts);
#pragma unroll
        for (int q = 0; q < TERMS; ++q) ga[q][j / 2][2 * (j % 2) + r] = parts[q];
      }
    wgmma_fence();
#pragma unroll
    for (int q = 0; q < TERMS; ++q) issue_rs<64, 64>(y, ga[q], st + 2 * TILE);  // P3
    wgmma_commit();
    wgmma_wait<1>();  // the second group
    fence_regs(sacc);
    __syncwarp();
    if (lane == 0) bar_arrive(&bars->free_rk);
    // where this chunk's y goes, before the piece may change below
    float* yc = p.y + (((long long)b * p.T + c * L) * p.H + h) * N;
    const int rows = p.T - c * L;
    if (++c == pc.c1) {
      // a piece ends: the chain's state, the final state or S0 for the
      // block after, whose flag is raised once every warp's share is out;
      // then the next piece's S0
      store_state(p.s_final + (long long)pc.bh * N * N, sacc, w, lane);
      if (pc.hands_off) {
        __threadfence();
        sync_consumer(PRODUCTS);
        if (tid == 0) raise_flag(&handoff[set][blockIdx.x]);
      }
      if (k + 1 < plan.size()) {
        pc = plan[++k];
        c = pc.c0;
        b = pc.bh / p.H;
        h = pc.bh % p.H;
        u = make_float2(p.u[h * p.u_sh + 2 * lane * p.u_sn],
                        p.u[h * p.u_sh + (2 * lane + 1) * p.u_sn]);
        begin_piece(sacc, pc, p, set, w, lane, tid);
      }
    }
    // S's terms for the next chunk's P1 (this chunk's has read them)
    stage_state(sbase + S_AT, sacc, w, lane);
    // every warp's S terms are in place before the next chunk's P1
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    sync_consumer(PRODUCTS);
    wgmma_wait<0>();
    fence_regs(y);
#pragma unroll
    for (int q = 0; q < TERMS; ++q) fence_regs(ga[q]);
    __syncwarp();
    if (lane == 0) bar_arrive(&bars->empty[s]);
    // y: the rows before T
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = 16 * w + 8 * r + g;
      if (row < rows) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<float2*>(yc + (long long)row * p.H * N + 8 * j + 2 * t4) =
              make_float2(y[4 * j + 2 * r], y[4 * j + 2 * r + 1]);
      }
    }
  }
}

// whether TMA reads the (B, T, H, N) tensor at `ptr` with these element
// strides: a 16-byte aligned base, contiguous channels, and every other
// stride of an extent above 1 a positive multiple of 16 bytes
bool tma_readable(const void* ptr, int elem, long long sb, long long st,
                  long long sh, long long sn, const Params& p) {
  const long long s[3] = {sb, st, sh};
  const int n[3] = {p.B, p.T, p.H};
  if (sn != 1 || reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return false;
  for (int i = 0; i < 3; ++i)
    if (n[i] > 1 && (s[i] <= 0 || s[i] * elem % 16 != 0)) return false;
  return true;
}

// w as a float32 map: the (N, H, T, B) view, read in unswizzled boxes of
// [64 steps][64 channels]; a dimension of extent 1 gets a packed stride
bool w_map(CUtensorMap* map, const Params& p) {
  const cuuint64_t dims[4] = {(cuuint64_t)N, (cuuint64_t)p.H, (cuuint64_t)p.T,
                              (cuuint64_t)p.B};
  cuuint64_t strides[3] = {(cuuint64_t)p.w_sh * 4, (cuuint64_t)p.w_st * 4,
                           (cuuint64_t)p.w_sb * 4};
  cuuint64_t packed = (cuuint64_t)N * 4;
  for (int i = 0; i < 3; ++i) {
    if (dims[i + 1] == 1) strides[i] = packed;
    packed = strides[i] * dims[i + 1];
  }
  const cuuint32_t box[4] = {(cuuint32_t)N, 1, (cuuint32_t)L, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const EncodeTiled encode = encode_tiled();
  return encode != nullptr
      && encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<float*>(p.w), dims,
                strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

cudaError_t launch(const Params& p, cudaStream_t stream) {
  // r, k and v as (N, H, T, B) views in boxes of [64 steps][64 channels],
  // w likewise; a tensor that TMA cannot read goes to the producer's plain
  // loads
  CUtensorMap maps[4] = {};
  const void* ptr[3] = {p.r, p.k, p.v};
  const long long s[3][4] = {{p.r_sb, p.r_st, p.r_sh, p.r_sn},
                             {p.k_sb, p.k_st, p.k_sh, p.k_sn},
                             {p.v_sb, p.v_st, p.v_sh, p.v_sn}};
  int plain = 0;
  for (int x = 0; x < 3; ++x)
    if (!tma_readable(ptr[x], 2, s[x][0], s[x][1], s[x][2], s[x][3], p)
        || !tensor_map<64>(&maps[x], ptr[x], p.H, p.T, p.B, s[x][2], s[x][1], s[x][0], L))
      plain |= 1 << x;
  if (!tma_readable(p.w, 4, p.w_sb, p.w_st, p.w_sh, p.w_sn, p) || !w_map(&maps[3], p))
    plain |= 8;
  // a block an SM at most, each with `per` chunks of the B * H chains
  const long long n_chains = (long long)p.B * p.H, n_chunks = (p.T + L - 1) / L;
  if (n_chains * n_chunks > (1ll << 30)) return cudaErrorInvalidValue;
  int grid;
  const cudaError_t err = persistent_grid(rwkv6_kernel, SMEM, n_chains, &grid);
  if (err != cudaSuccess) return err;
  if (grid > MAX_GRID) grid = MAX_GRID;
  long long per = (n_chains * n_chunks + grid - 1) / grid;
  if (per < n_chunks) per = n_chunks;
  grid = (int)((n_chains * n_chunks + per - 1) / per);
  static std::atomic<unsigned int> calls{0};
  const int set = (int)(calls.fetch_add(1) % HANDOFF_SETS);
  rwkv6_kernel<<<grid, BLOCK_THREADS, SMEM, stream>>>(maps[0], maps[1], maps[2], maps[3],
                                                      p, plain, (int)per, set);
  return cudaGetLastError();
}

}  // namespace hopper

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, for r, k and v; w and u are float32.
// strides: the element strides of r, k, v and w (b, t, h, n) and of u (h,
// n), 18 in all. y: (B, T, H, N) float32 and s_final: (B, H, N, N) float32,
// both contiguous. N must be 64. float32 takes the CUDA-core body, bfloat16
// the wgmma body (any strides: what TMA cannot read is loaded plainly).
// Returns a cudaError_t (0 on success).
extern "C" int rwkv6_scan(const void* r, const void* k, const void* v,
                          const float* w, const float* u, float* y,
                          float* s_final, int dtype, int B, int T, int H,
                          int n, const long long* strides, void* stream) {
  if (B < 1 || T < 1 || H < 1 || B > 65535 || n != N || s_final == nullptr)
    return (int)cudaErrorInvalidValue;
  const long long* s = strides;
  const Params p{r,     k,     v,     w,     u,     y,     s_final, B,     T,
                 H,     s[0],  s[1],  s[2],  s[3],  s[4],  s[5],    s[6],  s[7],
                 s[8],  s[9],  s[10], s[11], s[12], s[13], s[14],   s[15], s[16],
                 s[17]};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch(p, st);
  if (dtype == 1) return (int)hopper::launch(p, st);
  return (int)cudaErrorInvalidValue;
}

// Mamba2 SSD scan for Hopper (sm_90a), with a plain C interface for ctypes.
//
// Replaces: src/repro/kernels/ssm_scan/kernel.py:22 `_ssd_kernel` (launched
// by `ssd_scan` at :70, `pl.pallas_call` at :86). Same function: per
// (b, h), from a zero (P, N) state h,
//   h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T,   y_t = h_t C_t,
// with B and C shared by all heads, everything computed in float32 and y
// written in float32. Unlike the TPU kernel it also writes the final state
// (prefill needs it for the decode cache), reads x, dt, B and C through
// their strides (no moveaxis or padding copies) and takes any T >= 1.
//
// What bounds it on an H100: per layer of zamba2-1.2b's prefill (B=4,
// T=512, H=64, P=N=64, bf16 inputs) it reads ~17 MB and writes ~38 MB (y
// and the state in float32), ~0.017 ms at 3.35 TB/s, and needs ~3.2 GFLOP
// in the chunked form (~0.003 ms at the bf16 tensor-core rate, ~0.008 ms
// as the bf16 body runs it, with three bf16 terms of each float32 operand):
// the bytes.
//
// Design: the TPU kernel walks a sequential (B, H, chunks) grid and keeps
// h in VMEM scratch from one 64-step chunk to the next. On Hopper blocks
// carry nothing, so each (b, h) is walked by one owner that loops over the
// chunks itself and keeps h. A chunk is the chunked SSD form, in log2
// units (cum = the inclusive prefix sum of dt A log2(e) within the chunk):
//   G  = (C B^T) o L o dt,  L[t][s] = 2^(cum[t] - cum[s]) for s <= t,
//   y  = G x + 2^cum o (C h^T),
//   h <- 2^cum[-1] h + x^T (w o B),  w[s] = 2^(cum[-1] - cum[s]) dt[s].
// Only masked (s <= t) exponents are taken, so none overflows. The C entry
// point chooses the body by dtype:
//
// * bfloat16 (zamba2's path; (P, N) = (64, 64) and (32, 16)): the chunk is
//   B1's inner loop (flash_fwd.cu) on the building blocks of hopper.cuh.
//   A block holds two consumer warpgroups, one (b, h) each (heads 2j and
//   2j + 1 of one b; with an odd H the last block holds one), and a
//   producer warpgroup whose one thread TMA-loads each chunk's B and C
//   (once for both heads) and each head's x into a 2-stage mbarrier ring,
//   so chunk c + 1's loads overlap chunk c's products (setmaxnreg: 24
//   registers for the producer, 240 for the consumers). A consumer's 64
//   rows are one chunk, one wgmma M tile, and every product runs on wgmma
//   with float32 accumulators: C B^T from the bf16 inputs, exact, with C's
//   A fragments read once by ldmatrix; C h^T with the same fragments; G x
//   with G in registers and x read MN-major; x^T (w o B) with both operands
//   read MN-major from shared memory (the transpose bits). G, h and w o B
//   are float32, so each is cut into TERMS bf16 terms (hopper.cuh's split:
//   its value rounded, then what that leaves truncated, ...) and its
//   product is the sum of TERMS products, 10 a chunk where the function
//   has 4. Two terms leave ~2^-16 of each operand and broke the
//   elementwise limit at zamba2's prefill shape on an H100; three leave
//   ~2^-23, near what float32 operands would
//   (tests/test_torch_ssd_split.py emulates this arithmetic on the CPU).
//   h lives in the consumer's registers as a wgmma
//   accumulator; after each update its terms go to shared memory by
//   stmatrix as C h^T's B operand, beside w o B's terms, which the consumer
//   writes from the B tile. Within a chunk, the state update and C h^T
//   need no G, so they are issued before G forms on the C B^T accumulator;
//   G x runs while chunk c + 1's cum and w o B form; chunk c + 1's C B^T
//   runs while this chunk's y and h's terms go out. y leaves through a
//   staging tile by TMA stores, which drain while the next chunk runs (plain
//   stores from all SMs at once stalled the consumers). dt is not a TMA box
//   (one head's steps are H elements apart): each warp loads the next
//   chunk's dt with plain loads while this chunk runs, and forms cum by
//   shuffles. Every bf16 tile is [64 rows][64 columns] in the 128-byte
//   swizzle; TMA zero-fills the rows past T (dt = 0 there leaves h as it
//   is) and, at the smoke width, the columns past P or N, so both widths
//   run the same 64 x 64 products and store only what is real. TMA needs x,
//   B and C 16-byte aligned with strides of multiples of 8 elements; the
//   wrapper refuses any other bf16 layout. Nothing is summed with atomics,
//   so a second run repeats bit for bit.
// * float32 (the float32 path and its checks): one block per (h, b), h
//   in shared memory, each chunk's x, B, C and dt staged in shared memory
//   as float32, the four products as float32 FMAs on the CUDA cores, each
//   thread of a 16 x 16 grid owning a strided 4 x 4 (at P = N = 64) tile
//   of each product's output; rows are padded by one float so that a
//   column read hits 16 distinct banks.

#include "hopper.cuh"

namespace {

constexpr int L = 64;    // time steps per chunk (the reference's bt)
constexpr int TT = 16;   // a TT x TT grid of threads covers each product
constexpr int NT = TT * TT;

__device__ __forceinline__ float to_f32(float x) { return x; }

struct Params {
  const void* x;    // (B, T, H, P)
  const void* dt;   // (B, T, H)
  const float* A;   // (H,)
  const void* bm;   // (B, T, N)
  const void* cm;   // (B, T, N)
  float* y;         // (B, T, H, P), contiguous
  float* h_final;   // (B, H, P, N), contiguous, or null
  int B, T, H;
  long long x_sb, x_st, x_sh, x_sp;  // element strides
  long long dt_sb, dt_st, dt_sh;
  long long a_s;
  long long b_sb, b_st, b_sn;
  long long c_sb, c_st, c_sn;
};

// acc[r][c] += sum_k a(ti + TT r, k) * b(k, tj + TT c)
template <int RR, int CC, int K, class FA, class FB>
__device__ __forceinline__ void accumulate(float (&acc)[RR][CC], int ti, int tj,
                                           FA a, FB b) {
#pragma unroll 8
  for (int k = 0; k < K; ++k) {
    float av[RR], bv[CC];
#pragma unroll
    for (int r = 0; r < RR; ++r) av[r] = a(ti + TT * r, k);
#pragma unroll
    for (int c = 0; c < CC; ++c) bv[c] = b(k, tj + TT * c);
#pragma unroll
    for (int r = 0; r < RR; ++r)
#pragma unroll
      for (int c = 0; c < CC; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
  }
}

template <int P, int N>
constexpr size_t smem_floats() {
  // Xs[L][P+1], Bs and Cs [L][N+1], Gs[L][L+1], Hs[P][N+1], cum, dts, ws [L]
  return (size_t)L * (P + 1) + 2 * L * (N + 1) + L * (L + 1) + P * (N + 1) + 3 * L;
}

template <typename T, int P, int N>
__global__ void __launch_bounds__(NT, 2) ssd_kernel(const Params p) {
  static_assert(P % TT == 0 && N % TT == 0, "P and N must be multiples of 16");
  constexpr int LX = P + 1, LB = N + 1, LG = L + 1;
  extern __shared__ float smem[];
  float* Xs = smem;             // x of the chunk
  float* Bs = Xs + L * LX;      // B, then w o B
  float* Cs = Bs + L * LB;      // C
  float* Gs = Cs + L * LB;      // (C B^T) o L o dt
  float* Hs = Gs + L * LG;      // the carried state h[p][n]
  float* cum = Hs + P * LB;     // cumulative dt * A within the chunk
  float* dts = cum + L;         // dt
  float* ws = dts + L;          // exp(cum[L-1] - cum[s]) * dt[s]

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int ti = tid / TT, tj = tid % TT;
  const float A = p.A[h * p.a_s];
  const T* x = static_cast<const T*>(p.x) + b * p.x_sb + h * p.x_sh;
  const T* dt = static_cast<const T*>(p.dt) + b * p.dt_sb + h * p.dt_sh;
  const T* bm = static_cast<const T*>(p.bm) + b * p.b_sb;
  const T* cm = static_cast<const T*>(p.cm) + b * p.c_sb;
  float* y = p.y + ((long long)b * p.T * p.H + h) * P;
  const long long y_st = (long long)p.H * P;

  for (int i = tid; i < P * LB; i += NT) Hs[i] = 0.f;

  for (int t0 = 0; t0 < p.T; t0 += L) {
    const int rows = min(L, p.T - t0);
    __syncthreads();  // the previous chunk is done with Xs, Bs and Hs
    for (int i = tid; i < L * P; i += NT) {
      const int s = i / P, q = i % P;
      Xs[s * LX + q] = s < rows ? to_f32(x[(t0 + s) * p.x_st + q * p.x_sp]) : 0.f;
    }
    for (int i = tid; i < L * N; i += NT) {
      const int s = i / N, n = i % N;
      const bool in = s < rows;
      Bs[s * LB + n] = in ? to_f32(bm[(t0 + s) * p.b_st + n * p.b_sn]) : 0.f;
      Cs[s * LB + n] = in ? to_f32(cm[(t0 + s) * p.c_st + n * p.c_sn]) : 0.f;
    }
    if (tid < L) dts[tid] = tid < rows ? to_f32(dt[(t0 + tid) * p.dt_st]) : 0.f;
    __syncthreads();
    if (tid < 32) {  // warp 0: inclusive prefix sum of dt * A, 2 x 32 steps
      float a0 = dts[tid] * A, a1 = dts[tid + 32] * A;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u0 = __shfl_up_sync(0xffffffffu, a0, off);
        const float u1 = __shfl_up_sync(0xffffffffu, a1, off);
        if (tid >= off) {
          a0 += u0;
          a1 += u1;
        }
      }
      const float first = __shfl_sync(0xffffffffu, a0, 31);
      cum[tid] = a0;
      cum[tid + 32] = a1 + first;
    }
    __syncthreads();
    const float total = cum[L - 1];
    if (tid < L) ws[tid] = expf(total - cum[tid]) * dts[tid];
    {  // G = (C B^T) o L o dt
      float acc[L / TT][L / TT] = {};
      accumulate<L / TT, L / TT, N>(
          acc, ti, tj, [&](int t, int n) { return Cs[t * LB + n]; },
          [&](int n, int s) { return Bs[s * LB + n]; });
#pragma unroll
      for (int r = 0; r < L / TT; ++r)
#pragma unroll
        for (int c = 0; c < L / TT; ++c) {
          const int t = ti + TT * r, s = tj + TT * c;
          Gs[t * LG + s] = s <= t ? acc[r][c] * expf(cum[t] - cum[s]) * dts[s] : 0.f;
        }
    }
    __syncthreads();
    {  // y = G x + exp(cum) o (C h^T); meanwhile B <- w o B (y reads no B)
      float intra[L / TT][P / TT] = {}, inter[L / TT][P / TT] = {};
      accumulate<L / TT, P / TT, L>(
          intra, ti, tj, [&](int t, int s) { return Gs[t * LG + s]; },
          [&](int s, int q) { return Xs[s * LX + q]; });
      accumulate<L / TT, P / TT, N>(
          inter, ti, tj, [&](int t, int n) { return Cs[t * LB + n]; },
          [&](int n, int q) { return Hs[q * LB + n]; });
#pragma unroll
      for (int r = 0; r < L / TT; ++r) {
        const int t = ti + TT * r;
        if (t >= rows) continue;
        const float decay = expf(cum[t]);
#pragma unroll
        for (int c = 0; c < P / TT; ++c)
          y[(t0 + t) * y_st + tj + TT * c] = intra[r][c] + decay * inter[r][c];
      }
      for (int i = tid; i < L * N; i += NT) Bs[(i / N) * LB + i % N] *= ws[i / N];
    }
    __syncthreads();
    {  // h <- exp(total) h + x^T (w o B)
      float acc[P / TT][N / TT] = {};
      accumulate<P / TT, N / TT, L>(
          acc, ti, tj, [&](int q, int s) { return Xs[s * LX + q]; },
          [&](int s, int n) { return Bs[s * LB + n]; });
      const float decay = expf(total);
#pragma unroll
      for (int r = 0; r < P / TT; ++r)
#pragma unroll
        for (int c = 0; c < N / TT; ++c) {
          float* hv = Hs + (ti + TT * r) * LB + tj + TT * c;
          *hv = decay * *hv + acc[r][c];
        }
    }
  }
  if (p.h_final != nullptr) {
    __syncthreads();
    float* hf = p.h_final + ((long long)b * p.H + h) * P * N;
    for (int i = tid; i < P * N; i += NT) hf[i] = Hs[(i / N) * LB + i % N];
  }
}

template <typename T, int P, int N>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<P, N>();
  auto kernel = ssd_kernel<T, P, N>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(p.H, p.B), NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_shape(const Params& p, int P, int N, cudaStream_t stream) {
  if (P == 64 && N == 64) return launch<T, 64, 64>(p, stream);  // zamba2-1.2b
  if (P == 32 && N == 16) return launch<T, 32, 16>(p, stream);  // its smoke width
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// bfloat16 body: TMA into an mbarrier ring, every product on wgmma
// ---------------------------------------------------------------------------

namespace hopper {

constexpr int TERMS = 3;             // bf16 terms of each float32 operand
constexpr int ROWS = 64;             // steps of a chunk: the rows of every tile
constexpr int TILE = ROWS * 64 * 2;  // bytes of a [64][64] bf16 tile
constexpr int STAGE = (2 + CONSUMERS) * TILE;  // B, C, and each head's x
constexpr int Y_TILE = ROWS * 64 * 4;          // a chunk's y, float32
// a consumer's own tiles: h's terms, w o B's terms, y on its way out
constexpr int OWN = 2 * TERMS * TILE + Y_TILE;
constexpr int VEC = 2 * 2 * ROWS;  // a warp's cum and dt (floats), two chunks
constexpr int SMEM = 1024 + STAGES * STAGE + CONSUMERS * OWN
                   + 4 * CONSUMERS * VEC * 4 + 2 * STAGES * 8;

struct Bars {
  uint64_t full[STAGES], empty[STAGES];
};

// d (+)= A . B, A (64 x 16) from registers, B (16 x 64) K-major in shared memory
__device__ __forceinline__ void mma_rk(float (&d)[32], const uint32_t (&a)[4],
                                       uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// d (+)= A . B^T over 64 columns: A's fragments in registers, B a [64][64]
// tile read K-major (C B^T, C h^T); the start address moves 32 bytes a
// 16-column step
__device__ __forceinline__ void rs_nt(float (&d)[32], const uint32_t (&a)[4][4],
                                      uint32_t b, bool overwrite) {
  const uint64_t db = desc(opaque(b), 16, 1024, 1);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) mma_rk(d, a[kk], db + 2 * kk, !(overwrite && kk == 0));
}

// cum of one chunk in log2 units, an inclusive scan of dt A over the warp
// (2 x 32 steps; every warp forms all 64), into cw[0, 64) beside dt in
// cw[64, 128); returns cum[63]
__device__ __forceinline__ float scan(float d0, float d1, float A2, int lane,
                                      float* cw) {
  float a0 = d0 * A2, a1 = d1 * A2;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u0 = __shfl_up_sync(0xffffffffu, a0, off);
    const float u1 = __shfl_up_sync(0xffffffffu, a1, off);
    if (lane >= off) {
      a0 += u0;
      a1 += u1;
    }
  }
  a1 += __shfl_sync(0xffffffffu, a0, 31);
  cw[lane] = a0;
  cw[lane + 32] = a1;
  cw[ROWS + lane] = d0;
  cw[ROWS + lane + 32] = d1;
  __syncwarp();
  return __shfl_sync(0xffffffffu, a1, 31);
}

// w o B's terms, w[s] = 2^(cum[63] - cum[s]) dt[s], from a B tile into
// the TERMS tiles at w_tiles, all in the same swizzled layout: a 16-byte
// piece stays in its row, so the row is its offset / 128
__device__ __forceinline__ void make_w(uint32_t b_tile, uint32_t w_tiles,
                                       const float* cw, float total, int tid) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t off = 16 * (tid + 128 * k);
    const int row = off >> 7;
    const float w = ex2(total - cw[row]) * cw[ROWS + row];
    uint4 v;
    asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(b_tile + off) : "memory");
    const uint32_t in[4] = {v.x, v.y, v.z, v.w};
    uint32_t out[TERMS][4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&in[e]));
      uint32_t parts[TERMS];
      split(f.x * w, f.y * w, parts);
#pragma unroll
      for (int q = 0; q < TERMS; ++q) out[q][e] = parts[q];
    }
#pragma unroll
    for (int q = 0; q < TERMS; ++q)
      st_shared4(w_tiles + q * TILE + off,
                 make_uint4(out[q][0], out[q][1], out[q][2], out[q][3]));
  }
}

// y as a float32 map: the (P, H, T, B) view of the contiguous (B, T, H, P)
// output, stored in boxes of [16 rows][32 columns] (128 bytes, swizzled)
bool y_map(CUtensorMap* map, float* y, int P, int H, int T, int B) {
  const cuuint64_t dims[4] = {(cuuint64_t)P, (cuuint64_t)H, (cuuint64_t)T,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)P * 4, (cuuint64_t)H * P * 4,
                                 (cuuint64_t)T * H * P * 4};
  const cuuint32_t box[4] = {32, 1, 16, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const EncodeTiled encode = encode_tiled();
  return encode != nullptr
      && encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, y, dims, strides, box,
                unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// One block: heads h0 and h0 + 1 (fewer at an odd H's end) of batch row b.
// Warpgroup 0's first thread keeps the ring full; warpgroup 1 + i owns head
// h0 + i and walks its chunks.
__global__ void __launch_bounds__(THREADS, 1)
ssd_kernel(const __grid_constant__ CUtensorMap tx,
           const __grid_constant__ CUtensorMap tb,
           const __grid_constant__ CUtensorMap tc,
           const __grid_constant__ CUtensorMap ty, const Params p, const int P,
           const int N) {
  extern __shared__ unsigned char smem_raw[];
  // swizzled tiles need 1024-byte alignment
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t ring = smem_u32(base);                   // STAGES x {B, C, x...}
  const uint32_t own = ring + STAGES * STAGE;             // per consumer: OWN
  float* vec = reinterpret_cast<float*>(base + STAGES * STAGE + CONSUMERS * OWN);
  Bars* bars = reinterpret_cast<Bars*>(vec + 4 * CONSUMERS * VEC);
  const int h0 = blockIdx.x * CONSUMERS, b = blockIdx.y;
  const int heads = min(CONSUMERS, p.H - h0);
  const int n_chunks = (p.T + ROWS - 1) / ROWS;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      bar_init(&bars->full[s], 1);
      bar_init(&bars->empty[s], 4 * heads);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread loads each chunk's B, C and x tiles
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      for (int c = 0; c < n_chunks; ++c) {
        const int s = c % STAGES;
        unsigned char* st = base + s * STAGE;
        bar_wait(&bars->empty[s], ((c / STAGES) & 1) ^ 1);
        bar_expect(&bars->full[s], (2 + heads) * TILE);
        tma_load(st, &tb, &bars->full[s], 0, 0, c * ROWS, b);
        tma_load(st + TILE, &tc, &bars->full[s], 0, 0, c * ROWS, b);
        for (int i = 0; i < heads; ++i)
          tma_load(st + (2 + i) * TILE, &tx, &bars->full[s], 0, h0 + i, c * ROWS, b);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int ci = wg - 1;
  if (ci >= heads) return;
  const int h = h0 + ci;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const float A2 = p.A[h * p.a_s] * LOG2E;  // log2 units
  const bf16* dtp = static_cast<const bf16*>(p.dt) + b * p.dt_sb + h * p.dt_sh;
  // this warp's cum[64] and dt[64] of chunk c in cw + (c & 1) * VEC / 2
  float* cw = vec + (ci * 4 + warp) * VEC;
  const uint32_t h_tiles = own + ci * OWN;          // h's terms, [p][n] each
  const uint32_t w_tiles = h_tiles + TERMS * TILE;  // w o B's terms, [s][n]
  const uint32_t y_tile = w_tiles + TERMS * TILE;   // [64][32] float32 boxes
  const int r0 = warp * 16 + g;  // this thread's rows of each tile: r0, r0 + 8
  const int y_boxes = P / 32;
  auto dt_at = [&](long long step) {
    return step < p.T ? __bfloat162float(dtp[step * p.dt_st]) : 0.f;
  };

  // h = 0 before the first chunk: its terms too
  for (int i = tid; i < TERMS * TILE / 16; i += 128)
    st_shared4(h_tiles + 16 * i, make_uint4(0, 0, 0, 0));
  float hacc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) hacc[i] = 0.f;
  // chunk 0's cum, C B^T and w o B; chunk 1's dt loading
  float total = scan(dt_at(lane), dt_at(lane + 32), A2, lane, cw);
  float d0 = dt_at(ROWS + lane), d1 = dt_at(ROWS + lane + 32);
  bar_wait(&bars->full[0], 0);
  float sc[32];
  uint32_t ca[4][4];  // C's A fragments of the chunk
  load_a(ca, ring + TILE, warp, lane);
  wgmma_fence();
  rs_nt(sc, ca, ring, true);  // S = C B^T
  wgmma_commit();
  make_w(ring, w_tiles, cw, total, tid);

  // Each chunk: the state update and C h^T need no G, so they run while
  // G forms; G x runs while chunk c + 1's w o B forms; chunk c + 1's
  // C B^T while this chunk's y and h's terms go out.
  for (int c = 0; c < n_chunks; ++c) {
    const int s = c % STAGES, sn = (c + 1) % STAGES, t0 = c * ROWS;
    const bool more = c + 1 < n_chunks;
    const float* cwc = cw + (c & 1) * (VEC / 2);
    const uint32_t x_tile = ring + s * STAGE + (2 + ci) * TILE;
    wgmma_wait<0>();  // C B^T of this chunk
    fence_regs(sc);
    float y[32], yi[32];
    const float decay = ex2(total);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      yi[i] = 0.f;
      hacc[i] *= decay;
    }
    // each in its own register before the fence (the compiler would
    // otherwise copy one zero into them after it, serialising the wgmma)
    fence_regs(yi);
    fence_regs(hacc);
    // this chunk's w o B and the last chunk's h terms are seen by the
    // async proxy, and by all four warps, before the products read them
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    sync_consumer(1 + ci);
    wgmma_fence();
#pragma unroll
    for (int q = 0; q < TERMS; ++q) ss_tn(hacc, x_tile, w_tiles + q * TILE);
#pragma unroll
    for (int q = 0; q < TERMS; ++q) rs_nt(yi, ca, h_tiles + q * TILE, false);
    wgmma_commit();

    // G = S o L o dt on the accumulator: element i sits at row r0 + 8 *
    // ((i >> 1) & 1), column 8 * (i >> 2) + 2 t + (i & 1); then its terms
    // as the A fragments of G x
    const float c_lo = cwc[r0], c_hi = cwc[r0 + 8];
    uint32_t ga[TERMS][4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 8 * j + 2 * t;
      const float2 cs = *reinterpret_cast<const float2*>(cwc + col);
      const float2 ds = *reinterpret_cast<const float2*>(cwc + ROWS + col);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = 4 * j + 2 * r, row = r0 + 8 * r;
        const float cr = r ? c_hi : c_lo;
        const float g0 = col <= row ? sc[i] * ds.x * ex2(cr - cs.x) : 0.f;
        const float g1 = col + 1 <= row ? sc[i + 1] * ds.y * ex2(cr - cs.y) : 0.f;
        uint32_t parts[TERMS];
        split(g0, g1, parts);
#pragma unroll
        for (int q = 0; q < TERMS; ++q) ga[q][j / 2][2 * (j % 2) + r] = parts[q];
      }
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) y[i] = 0.f;
    fence_regs(y);
    wgmma_fence();
#pragma unroll
    for (int q = 0; q < TERMS; ++q) issue_rs<64, 64>(y, ga[q], x_tile);
    wgmma_commit();

    // while it runs: chunk c + 1's cum, and its w o B once every warp's
    // state update has read this chunk's
    const float total_next =
        more ? scan(d0, d1, A2, lane, cw + ((c + 1) & 1) * (VEC / 2)) : 0.f;
    if (more) {
      d0 = dt_at(t0 + 2 * ROWS + lane);
      d1 = dt_at(t0 + 2 * ROWS + 32 + lane);
    }
    wgmma_wait<1>();
    fence_regs(hacc);
    fence_regs(yi);
    fence_regs(ca);
    // every warp's state update and C h^T are done: w o B's and h's
    // tiles are free
    sync_consumer(1 + ci);
    if (more) {
      bar_wait(&bars->full[sn], ((c + 1) / STAGES) & 1);
      make_w(ring + sn * STAGE, w_tiles, cw + ((c + 1) & 1) * (VEC / 2), total_next, tid);
    }
    wgmma_wait<0>();
    fence_regs(y);
#pragma unroll
    for (int q = 0; q < TERMS; ++q) fence_regs(ga[q]);
    if (lane == 0) bar_arrive(&bars->empty[s]);
    if (more) {
      load_a(ca, ring + sn * STAGE + TILE, warp, lane);
      wgmma_fence();
      rs_nt(sc, ca, ring + sn * STAGE, true);  // S = C B^T of chunk c + 1
      wgmma_commit();
    }
    // y = G x + 2^cum o (C h^T) leaves through this warp's 16 rows of the
    // y tile, two [64][32] float32 boxes in the 128-byte swizzle, by one TMA
    // store a box that writes only the rows below T and the columns below
    // P. The warp's stores before must have read them.
    if (lane == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    __syncwarp();
    {
      const float e[2] = {ex2(c_lo), ex2(c_hi)};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = 4 * j + 2 * r, row = r0 + 8 * r;
          uint32_t off = (j / 4) * (ROWS * 128) + row * 128 + (8 * (j % 4) + 2 * t) * 4;
          off ^= ((off >> 7) & 7) << 4;
          asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n"
                       :: "r"(y_tile + off), "f"(fmaf(e[r], yi[i], y[i])),
                          "f"(fmaf(e[r], yi[i + 1], y[i + 1])) : "memory");
        }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncwarp();
    if (lane == 0) {
      for (int x = 0; x < y_boxes; ++x)
        tma_store(&ty, base + (y_tile - ring) + x * (ROWS * 128) + warp * 16 * 128,
                  32 * x, h, t0 + warp * 16, b);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
    if (more) {
      // h's terms for chunk c + 1's C h^T, [p][n] tiles in the 128-byte
      // swizzle, from the accumulator as A fragments (the pairing of G's)
      uint32_t hf[TERMS][4][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = 4 * j + 2 * r;
          uint32_t parts[TERMS];
          split(hacc[i], hacc[i + 1], parts);
#pragma unroll
          for (int q = 0; q < TERMS; ++q) hf[q][j / 2][2 * (j % 2) + r] = parts[q];
        }
#pragma unroll
      for (int q = 0; q < TERMS; ++q) store_a(h_tiles + q * TILE, hf[q], warp, lane);
    }
    total = total_next;
  }
  wgmma_wait<0>();  // nothing is in flight: this tells ptxas so
  if (p.h_final != nullptr) {
    float* hf = p.h_final + ((long long)b * p.H + h) * P * N;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r;
      if (row >= P) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int i = 4 * j + 2 * r, col = 8 * j + 2 * t;
        if (col < N)
          *reinterpret_cast<float2*>(hf + row * N + col) = make_float2(hacc[i], hacc[i + 1]);
      }
    }
  }
  if (lane == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

cudaError_t launch(const Params& p, int P, int N, cudaStream_t stream) {
  // x as a (P, H, T, B) view, B and C as (N, 1, T, B) views, in boxes of
  // [64 steps][64 columns]; y as a (P, H, T, B) float32 view
  CUtensorMap tx, tb, tc, ty;
  if (!tensor_map<64>(&tx, p.x, p.H, p.T, p.B, p.x_sh, p.x_st, p.x_sb, ROWS, P)
      || !tensor_map<64>(&tb, p.bm, 1, p.T, p.B, 0, p.b_st, p.b_sb, ROWS, N)
      || !tensor_map<64>(&tc, p.cm, 1, p.T, p.B, 0, p.c_st, p.c_sb, ROWS, N)
      || !y_map(&ty, p.y, P, p.H, p.T, p.B))
    return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.H + CONSUMERS - 1) / CONSUMERS, p.B);
  ssd_kernel<<<grid, THREADS, SMEM, stream>>>(tx, tb, tc, ty, p, P, N);
  return cudaGetLastError();
}

}  // namespace hopper

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, for x, dt, bm and cm; A is float32.
// strides: the element strides of x (b, t, h, p), dt (b, t, h), A (h),
// bm (b, t, n) and cm (b, t, n), 14 in all. y: (B, T, H, P) float32 and
// h_final: (B, H, P, N) float32 or null, both contiguous. (P, N) must be
// (64, 64) or (32, 16). float32 takes the CUDA-core body; bfloat16 the
// wgmma body, which reads x, bm and cm by TMA: each must be 16-byte
// aligned, contiguous in its last dimension, with its other strides
// multiples of 8 elements. Returns a cudaError_t (0 on success);
// cudaErrorInvalidValue also when a tensor map cannot be encoded.
extern "C" int ssd_scan(const void* x, const void* dt, const float* A,
                        const void* bm, const void* cm, float* y,
                        float* h_final, int dtype, int B, int T, int H, int P,
                        int N, const long long* strides, void* stream) {
  if (B < 1 || T < 1 || H < 1 || B > 65535) return (int)cudaErrorInvalidValue;
  const long long* s = strides;
  const Params p{x,    dt,   A,    bm,    cm,    y,     h_final, B,
                 T,    H,    s[0], s[1],  s[2],  s[3],  s[4],    s[5],
                 s[6], s[7], s[8], s[9],  s[10], s[11], s[12],   s[13]};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool shape = (P == 64 && N == 64) || (P == 32 && N == 16);
  if (dtype == 0) return (int)dispatch_shape<float>(p, P, N, st);
  if (dtype == 1 && shape && s[3] == 1 && s[10] == 1 && s[13] == 1)
    return (int)hopper::launch(p, P, N, st);
  return (int)cudaErrorInvalidValue;
}

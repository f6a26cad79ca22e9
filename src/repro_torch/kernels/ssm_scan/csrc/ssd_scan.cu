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
// in the chunked form. This first kernel runs those products as float32
// FMAs on the CUDA cores (67 TFLOP/s, ~0.05 ms), from shared memory, so
// operations and shared-memory bandwidth bound it, not the bytes.
//
// Design: the TPU kernel walks a sequential (B, H, chunks) grid and keeps
// h in VMEM scratch from one 64-step chunk to the next. On Hopper blocks
// carry nothing, so one block per (h, b) loops over the chunks itself and
// keeps h in shared memory. Each chunk's x, B, C and dt are staged in
// shared memory as float32 (rows past T are zero: dt = 0 leaves h as it
// is), warp 0 forms the cumulative log-decay cum, and the chunk is the
// chunked SSD form, four 64-deep products:
//   G  = (C B^T) o L o dt,  L[t][s] = exp(cum[t] - cum[s]) for s <= t,
//   y  = G x + exp(cum) o (C h^T),
//   h <- exp(cum[-1]) h + (w o x)^T B,  w[s] = exp(cum[-1] - cum[s]) dt[s].
// Each thread of the 16 x 16 thread grid owns a strided 4 x 4 (at P = N =
// 64) register tile of each product's output; rows are padded by one
// float so that a column read hits 16 distinct banks. Only masked (s <= t)
// exponents are taken, so none overflows. The products are the ones that
// later map onto wgmma; this kernel keeps them on the CUDA cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int L = 64;    // time steps per chunk (the reference's bt)
constexpr int TT = 16;   // a TT x TT grid of threads covers each product
constexpr int NT = TT * TT;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, for x, dt, bm and cm; A is float32.
// strides: the element strides of x (b, t, h, p), dt (b, t, h), A (h),
// bm (b, t, n) and cm (b, t, n), 14 in all. y: (B, T, H, P) float32 and
// h_final: (B, H, P, N) float32 or null, both contiguous. (P, N) must be
// (64, 64) or (32, 16). Returns a cudaError_t (0 on success).
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
  if (dtype == 0) return (int)dispatch_shape<float>(p, P, N, st);
  if (dtype == 1) return (int)dispatch_shape<__nv_bfloat16>(p, P, N, st);
  return (int)cudaErrorInvalidValue;
}

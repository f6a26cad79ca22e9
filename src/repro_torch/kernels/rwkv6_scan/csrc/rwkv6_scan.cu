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
// and the state in float32), ~0.023 ms at 3.35 TB/s; its ~2.3 GFLOP of
// float32 work is ~0.035 ms at the CUDA cores' 67 TFLOP/s. But the
// recurrence is sequential in t, and the card has only B*H = 160 (b, h)
// pairs to spread over its 132 SMs, so a block's own step rate sets the
// time: its float32 instructions, and the shared-memory loads that feed
// them (a warp-wide load is one issue slot however many lanes it serves).
//
// Design: the TPU kernel walks a sequential (B, H, chunks) grid and keeps S
// in VMEM scratch from one 64-step chunk to the next, the chunk being MXU
// work. That chunking is for VMEM and the MXU and is not carried over. Here
// one block of 128 threads runs one (b, h) and keeps S in registers for the
// whole scan, each thread an 8 x 4 tile: rows n = 8i + g (g the lane's row
// group, 0..7) of four neighbouring columns m. The block works through the
// steps C at a time:
// 1. stage r, k, v and w of the C steps in shared memory as float32
//    (coalesced rows of 64 per step), and with them c_t = sum_n r_n u_n
//    k_n, the bonus term, which is the same for every column; the loads
//    from device memory were issued into registers before the previous
//    chunk's steps, so their latency hides behind that work;
// 2. each thread runs the C steps with no barrier: per step it loads r_n,
//    k_n and w_n of its 8 rows once for its 4 columns, updates its tile,
//      y_m += r_n S_nm,   S_nm = w_n S_nm + k_n v_m,
//    and stores its 4 partial sums y_m to shared memory; no step waits on
//    another thread, so the loop is loads and FMAs only;
// 3. the block sums the 8 row groups' partials of every (step, column) and
//    writes y_m = that sum + v_m c_t, coalesced.
// In float32 this is the plain version's r^T (S + (u o k) v^T) with the
// terms summed in another order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

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

template <typename T>
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
  const T* r = static_cast<const T*>(p.r) + b * p.r_sb + h * p.r_sh + sn * p.r_sn;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh + sn * p.k_sn;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh + sn * p.v_sn;
  const float* w = p.w + b * p.w_sb + h * p.w_sh + sn * p.w_sn;
  const float u = p.u[h * p.u_sh + sn * p.u_sn];
  float* y = p.y + ((long long)b * p.T * p.H + h) * N + sn;
  const long long y_st = (long long)p.H * N;

  // the next chunk's elements, loaded ahead; steps past T load step T - 1
  T pr[IT], pk[IT], pv[IT];
  float pw[IT];
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
      const float rn = to_f32(pr[i]), kn = to_f32(pk[i]);
      rs[s * N + sn] = rn;
      ks[s * N + sn] = kn;
      vs[s * N + sn] = to_f32(pv[i]);
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

template <typename T>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = sizeof(float) * SMEM_FLOATS;
  auto kernel = rwkv6_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(p.H, p.B), NT, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, for r, k and v; w and u are float32.
// strides: the element strides of r, k, v and w (b, t, h, n) and of u (h,
// n), 18 in all. y: (B, T, H, N) float32 and s_final: (B, H, N, N) float32,
// both contiguous. N must be 64. Returns a cudaError_t (0 on success).
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
  if (dtype == 0) return (int)launch<float>(p, st);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(p, st);
  return (int)cudaErrorInvalidValue;
}

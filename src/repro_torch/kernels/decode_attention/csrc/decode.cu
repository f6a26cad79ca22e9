// Decode attention for Hopper (sm_90a), with a plain C interface for ctypes.
//
// Replaces: src/repro/kernels/decode_attention/kernel.py:23 `_decode_kernel`
// (launched by `decode_attention` at :59). Same function: one query token
// per (b, h) against the KV cache, softmax in float32, q * scale taken in
// float32. Unlike the TPU kernel it takes one length per sequence ((B,)
// int32; a scalar length is broadcast by the caller) and attends over
// min(len_b, S) rows, so ragged prompts, continuous batching and a length
// past the end of the cache all run on this kernel.
//
// What bounds it on an H100: every cached K/V byte is read once and does
// 2 * G operations (G query heads per K/V head, 8 at yi-6b), far below the
// 295 operations a byte at which the tensor cores would become the limit,
// so the bound is the bytes of K/V over 3.35 TB/s.
//
// Design: the TPU kernel runs a sequential (B, H, nk) grid that carries the
// softmax state from one cache block to the next, and reads each K/V row
// once per query head. On Hopper blocks carry nothing and a decode batch has
// only B * KV (b, kv-head) pairs, 16 at yi-6b with B = 4, far fewer than the
// 132 SMs. So the cache is split into 64-row chunks: one block per
// (chunk, kv head, b) serves all G query heads of its group, so each K/V
// row leaves device memory once, and writes an unnormalised partial output
// with its max and sum (float32) to a workspace. A second, small kernel
// combines the partials of each (b, query head). Chunks past a sequence's
// length exit at once. A block issues all its 16-byte K/V loads before it
// uses any, so their latencies overlap. Both kernels read and write the
// stored layouts, the cache slice (B, S, KV, hd) through strides.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BS = 64;   // cache rows per chunk (one block)
constexpr int NT = 128;  // threads per block
constexpr int NW = NT / 32;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// the 16 / sizeof(T) values of one 16-byte load, as floats
__device__ __forceinline__ void unpack(const uint4& u, float* out, float) {
  out[0] = __uint_as_float(u.x);
  out[1] = __uint_as_float(u.y);
  out[2] = __uint_as_float(u.z);
  out[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float* out, __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* lens;
  void* o;
  float* part_o;   // (B, KV, n_chunks, G, hd) unnormalised partial outputs
  float* part_ml;  // (B, KV, n_chunks, G, 2) partial max and sum
  int B, H, KV, S, n_chunks;
  long long q_sb, q_sh;        // element strides of q (B, H, hd)
  long long k_sb, k_ss, k_sh;  // k cache (B, S, KV, hd)
  long long v_sb, v_ss, v_sh;  // v cache (B, S, KV, hd)
  long long o_sb, o_sh;        // o (B, H, hd)
  float scale;
};

__device__ __forceinline__ int seq_len(const Params& p, int b) {
  return min(max(p.lens[b], 0), p.S);
}

template <int HD>
size_t partial_smem_bytes(int G) {
  // Qs[G][HD], Ks[BS][HD+1], Vs[BS][HD], Ss[G][BS]
  return sizeof(float) * (G * HD + BS * (HD + 1) + BS * HD + G * BS);
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT) decode_partial_kernel(const Params p) {
  extern __shared__ float smem[];
  const int G = p.H / p.KV;
  constexpr int KP = HD + 1;
  float* Qs = smem;              // [G][HD]  q * scale
  float* Ks = Qs + G * HD;       // [BS][KP]
  float* Vs = Ks + BS * KP;      // [BS][HD]
  float* Ss = Vs + BS * HD;      // [G][BS]  scores, then probabilities

  const int chunk = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int len = seq_len(p, b);
  const int s0 = chunk * BS;
  if (s0 >= len) return;  // the combine reads only chunks below len
  const int rows = min(BS, len - s0);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + (long long)c * G * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + (long long)s0 * p.k_ss + c * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + (long long)s0 * p.v_ss + c * p.v_sh;

  for (int i = tid; i < G * HD; i += NT) {
    const int g = i / HD, d = i % HD;
    Qs[i] = to_f32(q[g * p.q_sh + d]) * p.scale;
  }
  // K and V rows in 16-byte loads, all issued before any is used; rows
  // past the length stay 0 (their p is 0)
  constexpr int VEC = 16 / sizeof(T);
  constexpr int PER_ROW = HD / VEC;
  constexpr int ITERS = (BS * PER_ROW + NT - 1) / NT;
  uint4 kr[ITERS], vr[ITERS];
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int i = tid + it * NT;
    const int j = i / PER_ROW, d = (i % PER_ROW) * VEC;
    kr[it] = vr[it] = make_uint4(0u, 0u, 0u, 0u);
    if (i < BS * PER_ROW && j < rows) {
      kr[it] = *reinterpret_cast<const uint4*>(k + (long long)j * p.k_ss + d);
      vr[it] = *reinterpret_cast<const uint4*>(v + (long long)j * p.v_ss + d);
    }
  }
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int i = tid + it * NT;
    if (i >= BS * PER_ROW) break;
    const int j = i / PER_ROW, d = (i % PER_ROW) * VEC;
    float kx[VEC], vx[VEC];
    unpack(kr[it], kx, T());
    unpack(vr[it], vx, T());
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      Ks[j * KP + d + e] = kx[e];
      Vs[j * HD + d + e] = vx[e];
    }
  }
  __syncthreads();

  for (int i = tid; i < G * BS; i += NT) {
    const int g = i / BS, j = i % BS;
    float sc = NEG_INF;
    if (j < rows) {
      const float* qg = Qs + g * HD;
      const float* kj = Ks + j * KP;
      sc = 0.f;
#pragma unroll 16
      for (int d = 0; d < HD; ++d) sc += qg[d] * kj[d];
    }
    Ss[i] = sc;
  }
  __syncthreads();

  float* ml = p.part_ml + ((((long long)b * p.KV + c) * p.n_chunks + chunk) * G) * 2;
  for (int g = warp; g < G; g += NW) {
    float* sg = Ss + g * BS;
    float mx = NEG_INF;
    for (int j = lane; j < rows; j += 32) mx = fmaxf(mx, sg[j]);
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
    for (int j = lane; j < BS; j += 32) {
      const float pj = j < rows ? expf(sg[j] - mx) : 0.f;
      sg[j] = pj;
      sum += pj;
    }
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      ml[2 * g] = mx;
      ml[2 * g + 1] = sum;
    }
  }
  __syncthreads();

  float* po = p.part_o + (((long long)b * p.KV + c) * p.n_chunks + chunk) * G * HD;
  for (int i = tid; i < G * HD; i += NT) {
    const int g = i / HD, d = i % HD;
    const float* pg = Ss + g * BS;
    float a = 0.f;
#pragma unroll 16
    for (int j = 0; j < BS; ++j) a += pg[j] * Vs[j * HD + d];
    po[i] = a;
  }
}

// one block per (query head of the group, kv head, b); thread d < HD owns
// output column d
template <typename T, int HD>
__global__ void __launch_bounds__(NT) decode_combine_kernel(const Params p) {
  const int G = p.H / p.KV;
  const int g = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int d = threadIdx.x;
  if (d >= HD) return;
  const int len = seq_len(p, b);
  const int n = (len + BS - 1) / BS;  // chunks that hold rows
  const long long base = ((long long)b * p.KV + c) * p.n_chunks;
  float m = NEG_INF;
  for (int s = 0; s < n; ++s) m = fmaxf(m, p.part_ml[((base + s) * G + g) * 2]);
  float l = 0.f, acc = 0.f;
  for (int s = 0; s < n; ++s) {
    const float w = expf(p.part_ml[((base + s) * G + g) * 2] - m);
    l += w * p.part_ml[((base + s) * G + g) * 2 + 1];
    acc += w * p.part_o[((base + s) * G + g) * HD + d];
  }
  T* o = static_cast<T*>(p.o) + b * p.o_sb + (long long)(c * G + g) * p.o_sh;
  o[d] = from_f32<T>(acc / fmaxf(l, 1e-30f));
}

template <typename T, int HD>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = partial_smem_bytes<HD>(p.H / p.KV);
  auto partial = decode_partial_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      partial, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  partial<<<dim3(p.n_chunks, p.KV, p.B), NT, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine_kernel<T, HD><<<dim3(p.H / p.KV, p.KV, p.B), NT, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(const Params& p, int hd, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(p, stream);
    case 32: return launch<T, 32>(p, stream);
    case 64: return launch<T, 64>(p, stream);
    case 128: return launch<T, 128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Cache rows per chunk: the caller sizes the workspace with it.
extern "C" int decode_chunk_rows() { return BS; }

// dtype: 0 = float32, 1 = bfloat16. lens: (B,) int32 on the device. The
// caches are read 16 bytes at a time: they must be 16-byte aligned with
// strides that are multiples of 16 bytes.
// part_o: (B, KV, ceil(S / chunk rows), H / KV, hd) float32 and part_ml:
// (B, KV, ceil(S / chunk rows), H / KV, 2) float32 scratch on the device.
// Returns a cudaError_t (0 on success).
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const int* lens, void* o, float* part_o,
                                float* part_ml, int dtype, int B, int H,
                                int KV, int S, int hd, long long q_sb,
                                long long q_sh, long long k_sb, long long k_ss,
                                long long k_sh, long long v_sb, long long v_ss,
                                long long v_sh, long long o_sb, long long o_sh,
                                float scale, void* stream) {
  if (B < 1 || H < 1 || KV < 1 || H % KV != 0 || S < 1)
    return (int)cudaErrorInvalidValue;
  const Params p{q,    k,    v,    lens, o,    part_o, part_ml, B,    H,
                 KV,   S,    (S + BS - 1) / BS, q_sb, q_sh, k_sb, k_ss, k_sh,
                 v_sb, v_ss, v_sh, o_sb, o_sh, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch_hd<float>(p, hd, st);
  if (dtype == 1) return (int)dispatch_hd<__nv_bfloat16>(p, hd, st);
  return (int)cudaErrorInvalidValue;
}

// Decode attention for Hopper (sm_90a), with a plain C interface for ctypes.
//
// Replaces: src/repro/kernels/decode_attention/kernel.py:23 `_decode_kernel`
// (launched by `decode_attention` at :59). Same function: one query token
// per (b, h) against the KV cache, softmax in float32, the scale taken in
// float32. The TPU kernel runs a sequential (B, H, nk) grid that carries the
// softmax state (max, sum, accumulator) in VMEM from one cache block to the
// next, and reads each K/V row once per query head. Unlike it, this kernel
// takes one length per sequence ((B,) int32; a scalar length is broadcast by
// the caller) and attends over min(len_b, S) rows, so ragged prompts,
// continuous batching and a length past the end of the cache all run on it;
// a length <= 0 gives a zero row.
//
// What bounds it on an H100: every cached K/V byte is read once and does
// 2 * G operations (G query heads per K/V head, 8 at yi-6b), far below the
// 295 operations a byte at which the tensor cores would become the limit,
// so the bound is the bytes of K/V over 3.35 TB/s: 0.84 us at yi-6b's
// serving shape (2.75 MB). So little data leaves the call's time to fixed
// costs and latency: launches, the wait for the first loads, the hand-off
// of the partial results between blocks.
//
// Design of the bf16 body (namespace hopper): one launch a call. A decode
// batch has only B * KV (b, kv head) pairs, 16 at yi-6b, far fewer than the
// 132 SMs, so the cache is cut into chunks of BS rows and one block takes
// one chunk of one pair for up to 8 query heads of its group (all G at
// yi-6b), so each K/V row leaves device memory once. The block issues every
// K and V load of its chunk (cp.async into padded rows of shared memory, as
// bf16) before it uses any. Its four warps take 16 rows each for
// S = K q^T on mma.sync.m16n8k16 (16 rows x 16 of hd against the 8 heads),
// scale S in float32 after the product, and form P = exp(S - max) in
// float32, from which the sum is taken; P goes to shared memory in bf16
// terms (`split`), and O^T = V^T P^T runs on the same instruction, each
// warp over 16 of hd and all the chunk's rows, V^T read by ldmatrix.trans.
// A sequence whose rows fit one chunk writes o at once. Otherwise each
// block writes its unnormalised o with its max and sum (float32) to a
// workspace, fences and takes a ticket from its pair's counter; the block
// that arrives last combines the pair's chunks in chunk order, so the
// result does not depend on which block came last, writes o and resets the
// counter. At G = 1 (MHA, zamba2) the CUDA cores take the products, each
// lane reading 16 bytes of a K and a V row straight into registers: at
// zamba2's decode shape that took 0.0166 ms against 0.0186 with the n of
// the products padded to 8 (PERF.md, PR 29). Chunks past a sequence's
// length exit at once; the count of chunks comes from `lens` on the device.
// The float32 body is two kernels: a partial kernel on the CUDA cores,
// then a combine kernel.
//
// Head dims 16, 32, 64, 112 and 128, each its own instance of both bodies.
// At hd = 112 (kimi-k2) the tensor-core body has 7 16-column tiles of hd
// for its 4 warps' O^T = V^T P^T, 2 a warp, the 8th (warp 3's second) past
// the end and skipped; a staged row of 112 + 8 bf16 is 15 16-byte pieces,
// odd, as the ldmatrix phases want; each thread issues 7 of the chunk's
// 16-byte K and V pieces. The CUDA-core body of G = 1 gives a row 16 lanes
// of which 14 load.

#include <atomic>

#include "hopper.cuh"

namespace {

constexpr int BS = 64;   // cache rows per chunk (one block)
constexpr int NT = 128;  // threads per block
constexpr int NW = NT / 32;
constexpr float NEG_INF = -1e30f;

// the four values of one 16-byte load
__device__ __forceinline__ void unpack(const uint4& u, float* out) {
  out[0] = __uint_as_float(u.x);
  out[1] = __uint_as_float(u.y);
  out[2] = __uint_as_float(u.z);
  out[3] = __uint_as_float(u.w);
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* lens;
  void* o;
  float* part_o;   // unnormalised partial outputs (layout: each body's own)
  float* part_ml;  // partial max and sum
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

// ---------------------------------------------------------------------------
// float32: a partial kernel on the CUDA cores, then a combine kernel.
// part_o is (B, KV, n_chunks, G, hd) and part_ml (B, KV, n_chunks, G, 2).
// ---------------------------------------------------------------------------

template <int HD>
size_t partial_smem_bytes(int G) {
  // Qs[G][HD], Ks[BS][HD+1], Vs[BS][HD], Ss[G][BS]
  return sizeof(float) * (G * HD + BS * (HD + 1) + BS * HD + G * BS);
}

template <int HD>
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

  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + (long long)c * G * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + (long long)s0 * p.k_ss + c * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + (long long)s0 * p.v_ss + c * p.v_sh;

  for (int i = tid; i < G * HD; i += NT) {
    const int g = i / HD, d = i % HD;
    Qs[i] = q[g * p.q_sh + d] * p.scale;
  }
  // K and V rows in 16-byte loads, all issued before any is used; rows
  // past the length stay 0 (their p is 0)
  constexpr int VEC = 4;
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
    unpack(kr[it], kx);
    unpack(vr[it], vx);
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
template <int HD>
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
  float* o = static_cast<float*>(p.o) + b * p.o_sb + (long long)(c * G + g) * p.o_sh;
  o[d] = acc / fmaxf(l, 1e-30f);
}

template <int HD>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = partial_smem_bytes<HD>(p.H / p.KV);
  auto partial = decode_partial_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      partial, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  partial<<<dim3(p.n_chunks, p.KV, p.B), NT, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine_kernel<HD><<<dim3(p.H / p.KV, p.KV, p.B), NT, 0, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t dispatch_hd(const Params& p, int hd, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<16>(p, stream);
    case 32: return launch<32>(p, stream);
    case 64: return launch<64>(p, stream);
    case 112: return launch<112>(p, stream);
    case 128: return launch<128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// bf16: one launch. part_o is (pair, n_chunks, hd, HEADS) and part_ml (pair,
// n_chunks, 2, HEADS), a pair being (b, kv head, group of HEADS query heads).
// ---------------------------------------------------------------------------

namespace hopper {

constexpr int HEADS = 8;    // query heads a block serves: the n of m16n8k16
constexpr int P_TERMS = 1;  // bf16 terms of P in O^T = V^T P^T (`split`)
constexpr int PAD = 8;      // bf16 after each staged K/V row
constexpr int TICKET_SETS = 8, MAX_PAIRS = 1 << 15;

// The tickets of each pair at [set][pair]: how many of its chunks have
// written their partials in this call; the last one resets it to 0. Calls
// take the sets in turn, so that calls on other streams that run at the
// same time do not share a counter.
__device__ unsigned int tickets[TICKET_SETS][MAX_PAIRS];

template <int HD>
struct Stage {
  // the chunk's K and V rows as stored; a row of HD + PAD bf16 is an odd
  // number of 16-byte pieces, so the 8 rows that an ldmatrix phase reads
  // fall in 8 different bank groups
  bf16 k[BS][HD + PAD];
  bf16 v[BS][HD + PAD];
  uint32_t p[P_TERMS][BS][HEADS / 2];  // P's bf16 terms, [row][head pair]
  float o[HD][HEADS];                  // the chunk's unnormalised o^T
  float ow[NW][HD];                    // G = 1: each warp's o
  float m[NW][HEADS], l[NW][HEADS];    // each warp's max and sum a head
  unsigned int ticket;
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3]) : "r"(addr) : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3]) : "r"(addr) : "memory");
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&b)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(b[0]), "=r"(b[1]) : "r"(addr) : "memory");
}

// d += A . B, A 16 x 16 (row-major fragments), B 16 x 8, bf16 in, float32 sums
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pair_of(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ void unpack_bf16(const uint4& u, float (&out)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// The tensor-core body: the chunk's o^T for the group's heads into st.o,
// each warp's max and sum a head into st.m and st.l.
template <int HD>
__device__ __forceinline__ void mma_body(Stage<HD>& st, const bf16* q, const bf16* k,
                                         const bf16* v, const Params& p, int heads,
                                         int rows, int warp, int lane, int tid) {
  constexpr int LD = HD + PAD;
  constexpr int PIECES = BS * HD / 8 / NT;  // 16-byte pieces a thread, of K and of V
  const uint32_t sk = smem_u32(&st.k[0][0]), sv = smem_u32(&st.v[0][0]);
  // every load of the block before any is used: K's group, then V's; rows
  // past the length arrive as zeros
#pragma unroll
  for (int i = 0; i < PIECES; ++i) {
    const int e = tid + i * NT, j = e / (HD / 8), d = e % (HD / 8) * 8;
    cp_async16(sk + (j * LD + d) * 2, j < rows ? k + j * p.k_ss + d : k, j < rows ? 16 : 0);
  }
  cp_async_commit();
#pragma unroll
  for (int i = 0; i < PIECES; ++i) {
    const int e = tid + i * NT, j = e / (HD / 8), d = e % (HD / 8) * 8;
    cp_async16(sv + (j * LD + d) * 2, j < rows ? v + j * p.v_ss + d : v, j < rows ? 16 : 0);
  }
  cp_async_commit();

  // q^T's B fragments: lane (g, t) holds head g at hd 16 ks + 2 t (+ 8), + 1;
  // heads past the group's are 0
  const int g = lane / 4, t = lane % 4;
  uint32_t qb[HD / 16][2];
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      qb[ks][r] = 0u;
      if (g < heads) {
        const bf16* qd = q + g * p.q_sh + 16 * ks + 8 * r + 2 * t;
        qb[ks][r] = pair_of(qd[0], qd[1]);
      }
    }

  cp_async_wait<1>();
  __syncthreads();
  // S = K q^T over the warp's 16 rows: matrix i = lane / 8 of the A
  // fragment at rows + 8 (i % 2), columns + 8 (i / 2)
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  {
    const int i = lane / 8, row = 16 * warp + 8 * (i % 2) + lane % 8;
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      uint32_t a[4];
      ldsm_x4(a, sk + (row * LD + 16 * ks + 8 * (i / 2)) * 2);
      mma(s, a, qb[ks]);
    }
  }
  // lane (g, t) holds rows g and g + 8 of heads 2 t and 2 t + 1: scaled in
  // float32, rows past the length masked; the max a head over the chunk
  const int r0 = 16 * warp + g;
  float x[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) x[e] = r0 + 8 * (e / 2) < rows ? s[e] * p.scale : NEG_INF;
  float mx[2] = {fmaxf(x[0], x[2]), fmaxf(x[1], x[3])};
#pragma unroll
  for (int off = 4; off < 32; off *= 2)
#pragma unroll
    for (int h = 0; h < 2; ++h) mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], off));
  if (g == 0) {
    st.m[warp][2 * t] = mx[0];
    st.m[warp][2 * t + 1] = mx[1];
  }
  __syncthreads();
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int w = 0; w < NW; ++w) mx[h] = fmaxf(mx[h], st.m[w][2 * t + h]);
  // P in float32, its sum, and its bf16 terms for the product
  float pr[4], sum[2];
#pragma unroll
  for (int e = 0; e < 4; ++e) pr[e] = expf(x[e] - mx[e % 2]);
  sum[0] = pr[0] + pr[2];
  sum[1] = pr[1] + pr[3];
#pragma unroll
  for (int off = 4; off < 32; off *= 2)
#pragma unroll
    for (int h = 0; h < 2; ++h) sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], off);
  if (g == 0) {
    st.l[warp][2 * t] = sum[0];
    st.l[warp][2 * t + 1] = sum[1];
  }
  uint32_t lo[P_TERMS], hi[P_TERMS];
  split(pr[0], pr[1], lo);
  split(pr[2], pr[3], hi);
#pragma unroll
  for (int u = 0; u < P_TERMS; ++u) {
    st.p[u][r0][t] = lo[u];
    st.p[u][r0 + 8][t] = hi[u];
  }
  cp_async_wait<0>();
  __syncthreads();

  // O^T = V^T P^T: warp w takes hd tiles w, w + NW, ... over all rows; a
  // tile past MT (hd = 112: warp 3's second) is skipped
  constexpr int MT = HD / 16, MINE = (MT + NW - 1) / NW;
  float acc[MINE][4] = {};
#pragma unroll
  for (int kk = 0; kk < BS / 16; ++kk) {
    // P^T's B fragments: matrix (lane / 8) % 2 at rows + 8
    uint32_t pb[P_TERMS][2];
    const int prow = 16 * kk + 8 * ((lane / 8) % 2) + lane % 8;
#pragma unroll
    for (int u = 0; u < P_TERMS; ++u) ldsm_x2_t(pb[u], smem_u32(&st.p[u][prow][0]));
    // V^T's A fragments: matrix i = lane / 8 at rows + 8 (i / 2), hd + 8 (i % 2)
    const int i = lane / 8, row = 16 * kk + 8 * (i / 2) + lane % 8;
#pragma unroll
    for (int m = 0; m < MINE; ++m) {
      const int mt = warp + NW * m;
      if (mt < MT) {
        uint32_t a[4];
        ldsm_x4_t(a, sv + (row * LD + 16 * mt + 8 * (i % 2)) * 2);
#pragma unroll
        for (int u = 0; u < P_TERMS; ++u) mma(acc[m], a, pb[u]);
      }
    }
  }
  // lane (g, t) holds hd 16 mt + g (+ 8) of heads 2 t and 2 t + 1
#pragma unroll
  for (int m = 0; m < MINE; ++m) {
    const int mt = warp + NW * m;
    if (mt < MT) {
      *reinterpret_cast<float2*>(&st.o[16 * mt + g][2 * t]) = make_float2(acc[m][0], acc[m][1]);
      *reinterpret_cast<float2*>(&st.o[16 * mt + g + 8][2 * t]) = make_float2(acc[m][2], acc[m][3]);
    }
  }
}

// The CUDA-core body of G = 1: lanes read 16 bytes of a row each, straight
// into registers, and each warp takes 16 rows; the result as mma_body's in
// column 0. A row's lanes are a power of two, so that the shuffles below
// stay within them; at hd = 112 its last 2 of 16 hold zeros.
template <int HD>
__device__ __forceinline__ void simt_body(Stage<HD>& st, const bf16* q, const bf16* k,
                                          const bf16* v, const Params& p, int rows,
                                          int warp, int lane, int tid) {
  constexpr int CPR = HD / 8;                // 16-byte pieces of a row
  constexpr int LPR = CPR > 8 ? 16 : CPR;    // lanes a row
  constexpr int RPP = 32 / LPR;              // rows a warp reads at once
  constexpr int PASSES = BS / NW / RPP;
  static_assert(CPR <= LPR && (LPR == 16 || LPR == CPR), "lanes a row");
  const int col = lane % LPR * 8;
  const bool live = lane % LPR < CPR;        // a lane with a piece of the row
  uint4 kr[PASSES], vr[PASSES];
#pragma unroll
  for (int i = 0; i < PASSES; ++i) {
    const int j = BS / NW * warp + RPP * i + lane / LPR;
    kr[i] = vr[i] = make_uint4(0u, 0u, 0u, 0u);
    if (j < rows && live) {
      kr[i] = *reinterpret_cast<const uint4*>(k + j * p.k_ss + col);
      vr[i] = *reinterpret_cast<const uint4*>(v + j * p.v_ss + col);
    }
  }
  float qf[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) qf[e] = live ? __bfloat162float(q[col + e]) : 0.f;
  float s[PASSES], mx = NEG_INF;
#pragma unroll
  for (int i = 0; i < PASSES; ++i) {
    float kx[8];
    unpack_bf16(kr[i], kx);
    float a = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) a = fmaf(qf[e], kx[e], a);
#pragma unroll
    for (int off = 1; off < LPR; off *= 2) a += __shfl_xor_sync(0xffffffffu, a, off);
    const int j = BS / NW * warp + RPP * i + lane / LPR;
    s[i] = j < rows ? a * p.scale : NEG_INF;
    mx = fmaxf(mx, s[i]);
  }
#pragma unroll
  for (int off = LPR; off < 32; off *= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  if (lane == 0) st.m[warp][0] = mx;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < NW; ++w) mx = fmaxf(mx, st.m[w][0]);
  float l = 0.f, acc[8] = {};
#pragma unroll
  for (int i = 0; i < PASSES; ++i) {
    const float pr = expf(s[i] - mx);
    float vx[8];
    unpack_bf16(vr[i], vx);
    l += pr;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] = fmaf(pr, vx[e], acc[e]);
  }
  // over the warp's rows: the lanes that hold the same columns
#pragma unroll
  for (int off = LPR; off < 32; off *= 2) {
    l += __shfl_xor_sync(0xffffffffu, l, off);
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], off);
  }
  if (lane < CPR) {
#pragma unroll
    for (int e = 0; e < 8; ++e) st.ow[warp][col + e] = acc[e];
  }
  if (lane == 0) st.l[warp][0] = l;
  __syncthreads();
  if (tid < HD) {
    float a = st.ow[0][tid];
#pragma unroll
    for (int w = 1; w < NW; ++w) a += st.ow[w][tid];
    st.o[tid][0] = a;
  }
}

// SIMT: G = 1, on the CUDA cores
template <int HD, bool SIMT>
__global__ void __launch_bounds__(NT) decode_kernel(const Params p, const int set) {
  __shared__ __align__(16) Stage<HD> st;
  const int G = p.H / p.KV, groups = (G + HEADS - 1) / HEADS;
  const int chunk = blockIdx.x, c = blockIdx.y / groups, b = blockIdx.z;
  const int h0 = c * G + blockIdx.y % groups * HEADS;  // the block's first query head
  const int heads = min(HEADS, c * G + G - h0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int len = seq_len(p, b), s0 = chunk * BS;
  bf16* o = static_cast<bf16*>(p.o) + b * p.o_sb + (long long)h0 * p.o_sh;
  if (s0 >= len) {
    // no row to attend: chunk 0 writes the heads' rows as zeros
    if (chunk == 0)
      for (int i = tid; i < heads * HD; i += NT) o[i / HD * p.o_sh + i % HD] = __float2bfloat16(0.f);
    return;
  }
  const int rows = min(BS, len - s0), n = (len + BS - 1) / BS;
  const bf16* q = static_cast<const bf16*>(p.q) + b * p.q_sb + (long long)h0 * p.q_sh;
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.k_sb + (long long)s0 * p.k_ss + c * p.k_sh;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.v_sb + (long long)s0 * p.v_ss + c * p.v_sh;
  if constexpr (SIMT)
    simt_body<HD>(st, q, k, v, p, rows, warp, lane, tid);
  else
    mma_body<HD>(st, q, k, v, p, heads, rows, warp, lane, tid);
  __syncthreads();

  // thread d < HD owns column d of every head: the chunk's max and sum a head
  const int d = tid;
  float mx[HEADS], sum[HEADS];
#pragma unroll
  for (int j = 0; j < HEADS; ++j) {
    mx[j] = st.m[0][j];
    sum[j] = st.l[0][j];
#pragma unroll
    for (int w = 1; w < NW; ++w) {
      mx[j] = fmaxf(mx[j], st.m[w][j]);
      sum[j] += st.l[w][j];
    }
  }
  if (n == 1) {  // the whole sequence: o at once
    if (d < HD)
#pragma unroll
      for (int j = 0; j < HEADS; ++j)
        if (j < heads) o[j * p.o_sh + d] = __float2bfloat16(st.o[d][j] / fmaxf(sum[j], 1e-30f));
    return;
  }
  const long long pair = (long long)b * gridDim.y + blockIdx.y;
  float* po = p.part_o + pair * p.n_chunks * HD * HEADS;
  float* pml = p.part_ml + pair * p.n_chunks * 2 * HEADS;
  if (d < HD) {
    float4* to = reinterpret_cast<float4*>(po + ((long long)chunk * HD + d) * HEADS);
    to[0] = *reinterpret_cast<const float4*>(&st.o[d][0]);
    to[1] = *reinterpret_cast<const float4*>(&st.o[d][4]);
  }
  if (tid < HEADS) {  // the same max and sum, of head tid
    float m = st.m[0][tid], l = st.l[0][tid];
#pragma unroll
    for (int w = 1; w < NW; ++w) {
      m = fmaxf(m, st.m[w][tid]);
      l += st.l[w][tid];
    }
    pml[chunk * 2 * HEADS + tid] = m;
    pml[chunk * 2 * HEADS + HEADS + tid] = l;
  }
  // the partials out before the ticket; the last block's reads after it
  __threadfence();
  __syncthreads();
  if (tid == 0) st.ticket = atomicAdd(&tickets[set][pair], 1u);
  __syncthreads();
  if (st.ticket != (unsigned int)(n - 1)) return;
  __threadfence();
  if (tid == 0) tickets[set][pair] = 0;
  if (d >= HD) return;
  // the pair's chunks in chunk order, read from L2 (unrolled, so that the
  // loads of several chunks are in flight at once)
#pragma unroll
  for (int j = 0; j < HEADS; ++j) mx[j] = NEG_INF;
#pragma unroll 8
  for (int s = 0; s < n; ++s) {
    const float4 a = __ldcg(reinterpret_cast<const float4*>(pml + s * 2 * HEADS));
    const float4 b4 = __ldcg(reinterpret_cast<const float4*>(pml + s * 2 * HEADS + 4));
    const float m8[HEADS] = {a.x, a.y, a.z, a.w, b4.x, b4.y, b4.z, b4.w};
#pragma unroll
    for (int j = 0; j < HEADS; ++j) mx[j] = fmaxf(mx[j], m8[j]);
  }
  float acc[HEADS] = {};
#pragma unroll
  for (int j = 0; j < HEADS; ++j) sum[j] = 0.f;
#pragma unroll 4
  for (int s = 0; s < n; ++s) {
    const float4* ml4 = reinterpret_cast<const float4*>(pml + s * 2 * HEADS);
    const float4* o4 = reinterpret_cast<const float4*>(po + ((long long)s * HD + d) * HEADS);
    const float4 m0 = __ldcg(ml4), m1 = __ldcg(ml4 + 1), l0 = __ldcg(ml4 + 2), l1 = __ldcg(ml4 + 3);
    const float4 o0 = __ldcg(o4), o1 = __ldcg(o4 + 1);
    const float m8[HEADS] = {m0.x, m0.y, m0.z, m0.w, m1.x, m1.y, m1.z, m1.w};
    const float l8[HEADS] = {l0.x, l0.y, l0.z, l0.w, l1.x, l1.y, l1.z, l1.w};
    const float o8[HEADS] = {o0.x, o0.y, o0.z, o0.w, o1.x, o1.y, o1.z, o1.w};
#pragma unroll
    for (int j = 0; j < HEADS; ++j) {
      const float w = expf(m8[j] - mx[j]);
      sum[j] += w * l8[j];
      acc[j] += w * o8[j];
    }
  }
#pragma unroll
  for (int j = 0; j < HEADS; ++j)
    if (j < heads) o[j * p.o_sh + d] = __float2bfloat16(acc[j] / fmaxf(sum[j], 1e-30f));
}

template <int HD>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const int G = p.H / p.KV, groups = (G + HEADS - 1) / HEADS;
  if ((long long)p.B * p.KV * groups > MAX_PAIRS || p.B > 65535)
    return cudaErrorInvalidValue;
  static std::atomic<unsigned int> calls{0};
  const int set = (int)(calls.fetch_add(1) % TICKET_SETS);
  const dim3 grid(p.n_chunks, p.KV * groups, p.B);
  if (G == 1)
    decode_kernel<HD, true><<<grid, NT, 0, stream>>>(p, set);
  else
    decode_kernel<HD, false><<<grid, NT, 0, stream>>>(p, set);
  return cudaGetLastError();
}

cudaError_t dispatch_hd(const Params& p, int hd, cudaStream_t stream) {
  switch (hd) {
    case 16: return hopper::launch<16>(p, stream);
    case 32: return hopper::launch<32>(p, stream);
    case 64: return hopper::launch<64>(p, stream);
    case 112: return hopper::launch<112>(p, stream);
    case 128: return hopper::launch<128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace hopper

}  // namespace

// The workspace of a call, in floats: part_o holds this many, part_ml this
// many / hd * 2. Both bodies fit in it (the bf16 body pads each K/V head's
// group of query heads to a multiple of 8).
extern "C" long long decode_workspace_floats(int B, int H, int KV, int S, int hd) {
  const long long G = H / KV, padded = (G + hopper::HEADS - 1) / hopper::HEADS * hopper::HEADS;
  return (long long)B * KV * padded * ((S + BS - 1) / BS) * hd;
}

// dtype: 0 = float32, 1 = bfloat16. lens: (B,) int32 on the device. The
// caches are read 16 bytes at a time: they must be 16-byte aligned with
// strides that are multiples of 16 bytes. part_o and part_ml: float32
// scratch on the device of the sizes `decode_workspace_floats` gives.
// float32 takes the CUDA-core body (two kernels), bfloat16 the one-launch
// body (tensor cores; CUDA cores at G = 1). Returns a cudaError_t (0 on
// success).
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
  if (dtype == 0) return (int)dispatch_hd(p, hd, st);
  if (dtype == 1) return (int)hopper::dispatch_hd(p, hd, st);
  return (int)cudaErrorInvalidValue;
}

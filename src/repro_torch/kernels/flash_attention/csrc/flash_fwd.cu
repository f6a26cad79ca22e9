// Flash-attention forward for Hopper (sm_90a), with a plain C interface
// for ctypes.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py:32 `_fwd_kernel`
// (launched by `flash_fwd` at :86). Same function: streaming-softmax
// attention that returns O in q's dtype and the float32 log-sum-exp, GQA by
// head index h / (H / KV), a top-left causal mask (key k is seen by query q
// when k <= q) or none, ragged Sq and Sk masked inside the kernel, the
// scores q . k * scale formed in float32.
//
// What bounds it on an H100: the causal work is 2 * B * H * hd * S^2
// operations against the bytes of q, k, v and o. At yi-6b's heads
// (H = 32, KV = 4) that is 0.44 * S operations a byte: at S = 512 the
// card's least time is set by the bytes, from S ~ 700 up by the bf16
// tensor-core rate.
//
// Design: the TPU kernel walks a sequential (B, H, nq, nk) grid and carries
// m, l and the accumulator in VMEM scratch from one grid step to the next.
// On Hopper blocks run in parallel and carry nothing, so one block owns one
// (b, h, 64-row q tile) and loops over the K/V tiles itself; m, l and the
// accumulator stay in registers, so the running softmax never touches
// device memory. Causal blocks stop at the diagonal tile. The kernel reads
// q, k and v in their (B, S, heads, hd) layouts through strides, so the
// caller makes no transposed copies, and the K/V head of a query head is
// picked by index, never repeated. Two bodies:
//
// * bfloat16 (the serving path): the two products run on the tensor cores
//   with mma.sync m16n8k16 (bf16 in, float32 accumulate). Each of 4 warps
//   owns 16 query rows; Q stays in registers as A fragments, 64-row K and V
//   tiles are staged in shared memory (V read transposed by ldmatrix), and
//   the score fragments become the A fragments of P . V in registers. The
//   scale is applied to the float32 scores; P is rounded to bf16 for the
//   second product, as FlashAttention-2 does.
// * float32: the products run on the CUDA cores in float32 over 64-row
//   K/V tiles staged in shared memory, each thread owning 4 rows by hd / 8
//   columns of the accumulator.
//
// TMA loads, warp specialisation and wgmma are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BM = 64;   // query rows per block
constexpr int NT = 128;  // threads per block
constexpr float NEG_INF = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  int B, H, KV, Sq, Sk;
  long long q_sb, q_ss, q_sh;  // element strides of q (B, Sq, H, hd)
  long long k_sb, k_ss, k_sh;  // k (B, Sk, KV, hd)
  long long v_sb, v_ss, v_sh;  // v (B, Sk, KV, hd)
  long long o_sb, o_ss, o_sh;  // o (B, Sq, H, hd)
  float scale;
  int causal;
};

// ---------------------------------------------------------------------------
// float32 body: products on the CUDA cores
// ---------------------------------------------------------------------------

namespace simt {

constexpr int BN = 64;      // key rows per tile
constexpr int QP = BM + 4;  // padded row (floats) of the transposed Q and P tiles
constexpr int KP = BN + 4;  // padded row (floats) of the transposed K tile

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (HD * QP + HD * KP + BN * HD + BN * QP);
}

template <int HD>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(const Params p) {
  // 16 row groups x 8 column lanes
  extern __shared__ float smem[];
  float* Qs = smem;            // [HD][QP]  q^T * scale
  float* Ks = Qs + HD * QP;    // [HD][KP]  k^T
  float* Vs = Ks + HD * KP;    // [BN][HD]
  float* Ps = Vs + BN * HD;    // [BN][QP]  p^T

  constexpr int OC = HD / 8;   // accumulator columns per thread
  constexpr int SC = BN / 8;   // score columns per thread
  const int tid = threadIdx.x;
  const int ty = tid / 8;      // rows ty*4 .. ty*4+3 of the tile
  const int tx = tid % 8;      // columns tx + 8*j
  const int q0 = blockIdx.x * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);

  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + kvh * p.v_sh;

  for (int i = tid; i < BM * HD; i += NT) {
    const int r = i / HD, d = i % HD;
    float x = 0.f;
    if (q0 + r < p.Sq) x = q[(long long)(q0 + r) * p.q_ss + d] * p.scale;
    Qs[d * QP + r] = x;
  }

  float acc[4][OC];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < OC; ++j) acc[i][j] = 0.f;
  }

  // top-left causal: the tile's last query row sees keys up to itself
  const int k_end = p.causal ? min(p.Sk, q0 + BM) : p.Sk;
  for (int k0 = 0; k0 < k_end; k0 += BN) {
    __syncthreads();  // the previous tile's K, V and P are consumed
    for (int i = tid; i < BN * HD; i += NT) {
      const int c = i / HD, d = i % HD;
      float kx = 0.f, vx = 0.f;
      if (k0 + c < p.Sk) {
        kx = k[(long long)(k0 + c) * p.k_ss + d];
        vx = v[(long long)(k0 + c) * p.v_ss + d];
      }
      Ks[d * KP + c] = kx;
      Vs[c * HD + d] = vx;
    }
    __syncthreads();

    float s[4][SC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < SC; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(&Qs[d * QP + ty * 4]);
#pragma unroll
      for (int j = 0; j < SC; ++j) {
        const float kv = Ks[d * KP + tx + 8 * j];
        s[0][j] += qv.x * kv;
        s[1][j] += qv.y * kv;
        s[2][j] += qv.z * kv;
        s[3][j] += qv.w * kv;
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      bool ok[SC];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < SC; ++j) {
        const int kpos = k0 + tx + 8 * j;
        ok[j] = kpos < p.Sk && (!p.causal || kpos <= qpos);
        if (ok[j]) mx = fmaxf(mx, s[i][j]);
      }
      // the 8 lanes tx = 0..7 of one row group are adjacent in the warp
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < SC; ++j) {
        const float pj = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        sum += pj;
        Ps[(tx + 8 * j) * QP + ty * 4 + i] = pj;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < OC; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BN; ++c) {
      const float4 pv = *reinterpret_cast<const float4*>(&Ps[c * QP + ty * 4]);
#pragma unroll
      for (int j = 0; j < OC; ++j) {
        const float vv = Vs[c * HD + tx + 8 * j];
        acc[0][j] += pv.x * vv;
        acc[1][j] += pv.y * vv;
        acc[2][j] += pv.z * vv;
        acc[3][j] += pv.w * vv;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty * 4 + i;
    if (qpos >= p.Sq) continue;
    const float ls = fmaxf(l[i], 1e-30f);
    float* o = static_cast<float*>(p.o) + b * p.o_sb + (long long)qpos * p.o_ss + h * p.o_sh;
#pragma unroll
    for (int j = 0; j < OC; ++j) o[tx + 8 * j] = acc[i][j] / ls;
    if (tx == 0) p.lse[((long long)b * p.H + h) * p.Sq + qpos] = m[i] + logf(ls);
  }
}

template <int HD>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  auto kernel = flash_fwd_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + BM - 1) / BM, p.H, p.B);
  kernel<<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace simt

// ---------------------------------------------------------------------------
// bfloat16 body: products on the tensor cores (mma.sync m16n8k16)
// ---------------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int BN = 64;  // key rows per tile
constexpr int VEC = 8;  // bf16 values per 16-byte load

template <int HD>
struct Tile {
  static constexpr int RS = HD + 8;  // padded row (bf16) of the Q, K, V tiles
  static constexpr size_t smem = sizeof(bf16) * (BM + 2 * BN) * RS;
};

__device__ __forceinline__ void mma(float* c, const uint32_t* a, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 bf16 matrices from shared memory, each transposed
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const bf16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// rows [row0, row0 + rows) of a (rows, HD) tile into shared memory, 16 bytes
// a load; rows at or past `limit` are zero
template <int HD>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long row_stride, int row0,
                                          int rows, int limit) {
  constexpr int PER_ROW = HD / VEC;
  for (int i = threadIdx.x; i < rows * PER_ROW; i += NT) {
    const int r = i / PER_ROW, d = (i % PER_ROW) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < limit)
      val = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * row_stride + d);
    *reinterpret_cast<uint4*>(dst + r * Tile<HD>::RS + d) = val;
  }
}

template <int HD>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(const Params p) {
  constexpr int RS = Tile<HD>::RS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [BM][RS]
  bf16* Ks = Qs + BM * RS;                         // [BN][RS]
  bf16* Vs = Ks + BN * RS;                         // [BN][RS]

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;  // mma fragment row group, thread
  const int q0 = blockIdx.x * BM;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const bf16* q = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.v_sb + kvh * p.v_sh;

  load_tile<HD>(Qs, q, p.q_ss, q0, BM, p.Sq);
  __syncthreads();
  // this warp's 16 query rows as A fragments, one per 16 columns of hd
  uint32_t qa[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const bf16* base = Qs + (warp * 16 + g) * RS + kk * 16 + t * 2;
    qa[kk][0] = ld32(base);
    qa[kk][1] = ld32(base + 8 * RS);
    qa[kk][2] = ld32(base + 8);
    qa[kk][3] = ld32(base + 8 * RS + 8);
  }

  // accumulator: rows (g, g + 8) of the warp, columns nt * 8 + t * 2 + {0, 1}
  float o[HD / 8][4];
#pragma unroll
  for (int nt = 0; nt < HD / 8; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};  // l: this thread's share
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};

  const int k_end = p.causal ? min(p.Sk, q0 + BM) : p.Sk;
  for (int k0 = 0; k0 < k_end; k0 += BN) {
    __syncthreads();  // the previous tile's K and V are consumed
    load_tile<HD>(Ks, k, p.k_ss, k0, BN, p.Sk);
    load_tile<HD>(Vs, v, p.v_ss, k0, BN, p.Sk);
    __syncthreads();

    // S = Q K^T: B fragments straight from the row-major K tile
    float s[BN / 8][4];
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) {
        const bf16* kb = Ks + (nt * 8 + g) * RS + kk * 16 + t * 2;
        mma(s[nt], qa[kk], ld32(kb), ld32(kb + 8));
      }
    }

    // scale, mask, online softmax; s becomes P (float32)
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + nt * 8 + t * 2 + (e & 1);
        const bool ok = col < p.Sk && (!p.causal || col <= row[e >> 1]);
        s[nt][e] = ok ? s[nt][e] * p.scale : NEG_INF;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      // the 4 threads t = 0..3 of a row group share its rows
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      corr[i] = expf(m[i] - m_new);
      m[i] = m_new;
      l[i] *= corr[i];
    }
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + nt * 8 + t * 2 + (e & 1);
        const bool ok = col < p.Sk && (!p.causal || col <= row[e >> 1]);
        s[nt][e] = ok ? expf(s[nt][e] - m[e >> 1]) : 0.f;
        l[e >> 1] += s[nt][e];
      }
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt) {
      o[nt][0] *= corr[0];
      o[nt][1] *= corr[0];
      o[nt][2] *= corr[1];
      o[nt][3] *= corr[1];
    }

    // O += P V: the score fragments of two key n-tiles are the A fragment
    // of one 16-key step; V's B fragments come transposed by ldmatrix
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint32_t pa[4] = {pack(s[2 * kk][0], s[2 * kk][1]),
                              pack(s[2 * kk][2], s[2 * kk][3]),
                              pack(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int nt = 0; nt < HD / 8; nt += 2) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, Vs + (kk * 16 + (lane & 15)) * RS + nt * 8 + (lane >> 4) * 8);
        mma(o[nt], pa, vb[0], vb[1]);
        mma(o[nt + 1], pa, vb[2], vb[3]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    if (row[i] >= p.Sq) continue;
    const float ls = fmaxf(l[i], 1e-30f);
    bf16* out = static_cast<bf16*>(p.o) + b * p.o_sb + (long long)row[i] * p.o_ss + h * p.o_sh;
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt)
      *reinterpret_cast<uint32_t*>(out + nt * 8 + t * 2) =
          pack(o[nt][2 * i] / ls, o[nt][2 * i + 1] / ls);
    if (t == 0) p.lse[((long long)b * p.H + h) * p.Sq + row[i]] = m[i] + logf(ls);
  }
}

template <int HD>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = Tile<HD>::smem;
  auto kernel = flash_fwd_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + BM - 1) / BM, p.H, p.B);
  kernel<<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace tc

cudaError_t dispatch(const Params& p, int dtype, int hd, cudaStream_t st) {
  if (dtype == 0) {
    switch (hd) {
      case 16: return simt::launch<16>(p, st);
      case 32: return simt::launch<32>(p, st);
      case 64: return simt::launch<64>(p, st);
      case 128: return simt::launch<128>(p, st);
    }
  } else if (dtype == 1) {
    switch (hd) {
      case 16: return tc::launch<16>(p, st);
      case 32: return tc::launch<32>(p, st);
      case 64: return tc::launch<64>(p, st);
      case 128: return tc::launch<128>(p, st);
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. The bfloat16 body loads 16 bytes at a
// time: q, k and v must be 16-byte aligned with strides that are multiples
// of 8 elements. Returns a cudaError_t (0 on success).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         float* lse, int dtype, int B, int H, int KV, int Sq,
                         int Sk, int hd, long long q_sb, long long q_ss,
                         long long q_sh, long long k_sb, long long k_ss,
                         long long k_sh, long long v_sb, long long v_ss,
                         long long v_sh, long long o_sb, long long o_ss,
                         long long o_sh, float scale, int causal, void* stream) {
  if (B < 1 || H < 1 || KV < 1 || H % KV != 0 || Sq < 1 || Sk < 1)
    return (int)cudaErrorInvalidValue;
  const Params p{q,    k,    v,    o,    lse,  B,    H,    KV,   Sq,   Sk,
                 q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb,
                 o_ss, o_sh, scale, causal};
  return (int)dispatch(p, dtype, hd, static_cast<cudaStream_t>(stream));
}

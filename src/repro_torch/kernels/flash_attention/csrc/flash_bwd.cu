// Flash-attention backward for Hopper (sm_90a), two kernels with a plain C
// interface for ctypes.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py:138 `_bwd_dq_kernel`
// (B2a) and :181 `_bwd_dkv_kernel` (B2b), both launched by `flash_bwd` at
// :228. Same function: given q, k, v, the forward's output o and float32
// log-sum-exp, and dO, the probabilities are recomputed tile by tile as
// P = exp(q . k * scale - lse) under a top-left causal mask (key k is seen by
// query q when k <= q) or none, dS = P * (dP - delta) * scale with
// dP = dO . v and delta = rowsum(o * dO) (float32, computed by the caller as
// the reference computes it outside its Pallas calls, kernel.py:245), and
//   dQ = dS . K              (B2a, in q's dtype),
//   dK = dS^T . Q, dV = P^T . dO  (B2b, in k's dtype),
// with dK and dV summed over the G = H / KV query heads of each K/V head
// inside the kernel. Ragged Sq and Sk are masked inside the kernels, and
// the scale is applied to the float32 scores, as in the Pallas kernels.
//
// What bounds them on an H100: the causal work is 3 (B2a) and 4 (B2b)
// products of 2 * B * H * hd * S * (S + 1) / 2 operations against the bytes
// of q, k, v, o, dO and the gradients once. At gpt2-124m's training shape
// (B = 8, S = 1024, H = 12, hd = 64) that is ~300 operations a byte, so the
// least time is set by the bf16 tensor-core rate, just.
//
// Design: the TPU kernels walk sequential grids and carry dQ (over the K/V
// blocks) or dK/dV (over the G heads x q blocks) in VMEM scratch from one
// grid step to the next. On Hopper blocks run in parallel and carry
// nothing, so each block owns one output tile and loops over the tiles it
// needs itself, with the sums in registers:
//
// * B2a: one block per (b, h, 64-row q tile) loops over the K/V tiles of
//   K/V head h / G up to the causal diagonal and writes its dQ tile once.
// * B2b: one block per (b, K/V head, 64-row k tile) loops over the G query
//   heads x the q tiles from the diagonal on and writes its dK and dV tiles
//   once.
//
// Every output element is written by exactly one block and no kernel uses
// atomics, so the backward repeats bit for bit. No P matrix is stored. The
// kernels read q, k, v, dO and write the gradients in their (B, S, heads,
// hd) layouts through strides, so the caller makes no transposed copies.
// Two bodies, as in flash_fwd.cu:
//
// * bfloat16 (the training path): the products run on the tensor cores with
//   mma.sync m16n8k16 (bf16 in, float32 accumulate). Each of 4 warps owns
//   16 rows of the block's tile; the four 64-row tiles sit in shared
//   memory; A fragments are read from the row-major tiles, B fragments
//   straight from a row-major tile (the k . q^T kind of product) or
//   transposed by ldmatrix (the P . V kind), and the float32 score
//   fragments turn into the bf16 A fragments of the next product in
//   registers. P and dS are rounded to bf16 before their products, as
//   FlashAttention-2 does.
// * float32: the products run on the CUDA cores in float32 over tiles
//   staged transposed in shared memory, each thread owning 4 rows by hd / 8
//   columns of each sum.
//
// TMA loads, warp specialisation and wgmma are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BM = 64;   // rows of the block's own tile (q for B2a, k for B2b)
constexpr int BN = 64;   // rows of each tile it loops over
constexpr int NT = 128;  // threads per block

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // (B, H, Sq)
  const float* delta;  // (B, H, Sq)
  void* dq;
  void* dk;
  void* dv;
  int B, H, KV, Sq, Sk;
  long long q_sb, q_ss, q_sh;     // element strides of q (B, Sq, H, hd)
  long long k_sb, k_ss, k_sh;     // k (B, Sk, KV, hd)
  long long v_sb, v_ss, v_sh;     // v (B, Sk, KV, hd)
  long long do_sb, do_ss, do_sh;  // dO (B, Sq, H, hd)
  long long dq_sb, dq_ss, dq_sh;  // dQ (B, Sq, H, hd)
  long long dk_sb, dk_ss, dk_sh;  // dK (B, Sk, KV, hd)
  long long dv_sb, dv_ss, dv_sh;  // dV (B, Sk, KV, hd)
  float scale;
  int causal;
};

__device__ __forceinline__ bool seen(const Params& p, int qpos, int kpos) {
  return qpos < p.Sq && kpos < p.Sk && (!p.causal || kpos <= qpos);
}

// ---------------------------------------------------------------------------
// float32 body: products on the CUDA cores
// ---------------------------------------------------------------------------

namespace simt {

constexpr int RP = 64 + 4;  // padded row (floats) of the transposed tiles

// rows [row0, row0 + 64) of a (rows, HD) float32 tile into dst[d][r]
// (transposed, row pitch RP); rows at or past `limit` are zero
template <int HD>
__device__ __forceinline__ void load_t(float* dst, const float* src,
                                       long long row_stride, int row0,
                                       int limit) {
  for (int i = threadIdx.x; i < 64 * HD; i += NT) {
    const int r = i / HD, d = i % HD;
    dst[d * RP + r] = row0 + r < limit ? src[(long long)(row0 + r) * row_stride + d] : 0.f;
  }
}

template <int HD>
constexpr size_t dq_smem() { return sizeof(float) * (4 * HD * RP + BN * RP); }

template <int HD>
__global__ void __launch_bounds__(NT) dq_kernel(const Params p) {
  extern __shared__ float smem[];
  float* Qs = smem;           // [HD][RP]  q^T
  float* Ds = Qs + HD * RP;   // [HD][RP]  dO^T
  float* Ks = Ds + HD * RP;   // [HD][RP]  k^T
  float* Vs = Ks + HD * RP;   // [HD][RP]  v^T
  float* Ss = Vs + HD * RP;   // [BN][RP]  dS^T

  constexpr int OC = HD / 8;  // dQ columns per thread
  constexpr int SC = BN / 8;  // score columns per thread
  const int tid = threadIdx.x;
  const int ty = tid / 8;     // rows ty*4 .. ty*4+3 of the tile
  const int tx = tid % 8;     // columns tx + 8*j
  const int q0 = blockIdx.x * BM;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);

  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* dout = static_cast<const float*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  load_t<HD>(Qs, q, p.q_ss, q0, p.Sq);
  load_t<HD>(Ds, dout, p.do_ss, q0, p.Sq);

  float lse[4], dl[4], acc[4][OC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty * 4 + i;
    const long long at = ((long long)b * p.H + h) * p.Sq + qpos;
    lse[i] = qpos < p.Sq ? p.lse[at] : 0.f;
    dl[i] = qpos < p.Sq ? p.delta[at] : 0.f;
#pragma unroll
    for (int j = 0; j < OC; ++j) acc[i][j] = 0.f;
  }

  const int k_end = p.causal ? min(p.Sk, q0 + BM) : p.Sk;
  for (int k0 = 0; k0 < k_end; k0 += BN) {
    __syncthreads();  // the previous tile's K, V and dS are consumed
    load_t<HD>(Ks, k, p.k_ss, k0, p.Sk);
    load_t<HD>(Vs, v, p.v_ss, k0, p.Sk);
    __syncthreads();

    float s[4][SC], dp[4][SC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < SC; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(&Qs[d * RP + ty * 4]);
      const float4 ov = *reinterpret_cast<const float4*>(&Ds[d * RP + ty * 4]);
#pragma unroll
      for (int j = 0; j < SC; ++j) {
        const float kv = Ks[d * RP + tx + 8 * j];
        const float vv = Vs[d * RP + tx + 8 * j];
        s[0][j] += qv.x * kv;
        s[1][j] += qv.y * kv;
        s[2][j] += qv.z * kv;
        s[3][j] += qv.w * kv;
        dp[0][j] += ov.x * vv;
        dp[1][j] += ov.y * vv;
        dp[2][j] += ov.z * vv;
        dp[3][j] += ov.w * vv;
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < SC; ++j) {
        const bool ok = seen(p, q0 + ty * 4 + i, k0 + tx + 8 * j);
        const float pij = ok ? expf(s[i][j] * p.scale - lse[i]) : 0.f;
        Ss[(tx + 8 * j) * RP + ty * 4 + i] = pij * (dp[i][j] - dl[i]) * p.scale;
      }
    __syncthreads();

    // dQ += dS K, with K[c][d] read from the transposed tile
#pragma unroll 4
    for (int c = 0; c < BN; ++c) {
      const float4 sv = *reinterpret_cast<const float4*>(&Ss[c * RP + ty * 4]);
#pragma unroll
      for (int j = 0; j < OC; ++j) {
        const float kv = Ks[(tx + 8 * j) * RP + c];
        acc[0][j] += sv.x * kv;
        acc[1][j] += sv.y * kv;
        acc[2][j] += sv.z * kv;
        acc[3][j] += sv.w * kv;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty * 4 + i;
    if (qpos >= p.Sq) continue;
    float* dq = static_cast<float*>(p.dq) + b * p.dq_sb + (long long)qpos * p.dq_ss + h * p.dq_sh;
#pragma unroll
    for (int j = 0; j < OC; ++j) dq[tx + 8 * j] = acc[i][j];
  }
}

template <int HD>
constexpr size_t dkv_smem() {
  return sizeof(float) * (4 * HD * RP + 2 * BM * RP + 2 * BN);
}

template <int HD>
__global__ void __launch_bounds__(NT) dkv_kernel(const Params p) {
  extern __shared__ float smem[];
  float* Ks = smem;           // [HD][RP]  k^T (the block's keys)
  float* Vs = Ks + HD * RP;   // [HD][RP]  v^T
  float* Qs = Vs + HD * RP;   // [HD][RP]  q^T (one q tile)
  float* Ds = Qs + HD * RP;   // [HD][RP]  dO^T
  float* Ps = Ds + HD * RP;   // [BN][RP]  P, [query][key]
  float* Ss = Ps + BN * RP;   // [BN][RP]  dS, [query][key]
  float* Ls = Ss + BN * RP;   // [BN]      lse of the q tile
  float* Dl = Ls + BN;        // [BN]      delta of the q tile

  constexpr int OC = HD / 8;
  constexpr int SC = BN / 8;
  const int tid = threadIdx.x;
  const int ty = tid / 8;     // key rows ty*4 .. ty*4+3 of the tile
  const int tx = tid % 8;     // query (or hd) columns tx + 8*j
  const int k0 = blockIdx.x * BM;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int G = p.H / p.KV;

  load_t<HD>(Ks, static_cast<const float*>(p.k) + b * p.k_sb + kvh * p.k_sh, p.k_ss, k0, p.Sk);
  load_t<HD>(Vs, static_cast<const float*>(p.v) + b * p.v_sb + kvh * p.v_sh, p.v_ss, k0, p.Sk);

  float dk[4][OC], dv[4][OC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < OC; ++j) dk[i][j] = dv[i][j] = 0.f;

  // top-left causal: queries before k0 see none of the block's keys
  const int q_begin = p.causal ? k0 : 0;
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
    const float* dout = static_cast<const float*>(p.dout) + b * p.do_sb + h * p.do_sh;
    const float* lse = p.lse + ((long long)b * p.H + h) * p.Sq;
    const float* delta = p.delta + ((long long)b * p.H + h) * p.Sq;
    for (int q0 = q_begin; q0 < p.Sq; q0 += BN) {
      __syncthreads();  // the previous q tile, P and dS are consumed
      load_t<HD>(Qs, q, p.q_ss, q0, p.Sq);
      load_t<HD>(Ds, dout, p.do_ss, q0, p.Sq);
      for (int r = tid; r < BN; r += NT) {
        Ls[r] = q0 + r < p.Sq ? lse[q0 + r] : 0.f;
        Dl[r] = q0 + r < p.Sq ? delta[q0 + r] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T: rows are keys, columns queries
      float s[4][SC], dp[4][SC];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < SC; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < HD; ++d) {
        const float4 kv = *reinterpret_cast<const float4*>(&Ks[d * RP + ty * 4]);
        const float4 vv = *reinterpret_cast<const float4*>(&Vs[d * RP + ty * 4]);
#pragma unroll
        for (int j = 0; j < SC; ++j) {
          const float qv = Qs[d * RP + tx + 8 * j];
          const float ov = Ds[d * RP + tx + 8 * j];
          s[0][j] += kv.x * qv;
          s[1][j] += kv.y * qv;
          s[2][j] += kv.z * qv;
          s[3][j] += kv.w * qv;
          dp[0][j] += vv.x * ov;
          dp[1][j] += vv.y * ov;
          dp[2][j] += vv.z * ov;
          dp[3][j] += vv.w * ov;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < SC; ++j) {
          const int r = tx + 8 * j;
          const bool ok = seen(p, q0 + r, k0 + ty * 4 + i);
          const float pij = ok ? expf(s[i][j] * p.scale - Ls[r]) : 0.f;
          Ps[r * RP + ty * 4 + i] = pij;
          Ss[r * RP + ty * 4 + i] = pij * (dp[i][j] - Dl[r]) * p.scale;
        }
      __syncthreads();

      // dV += P^T dO and dK += dS^T Q, with dO[r][d] and Q[r][d] read from
      // the transposed tiles
#pragma unroll 2
      for (int r = 0; r < BN; ++r) {
        const float4 pv = *reinterpret_cast<const float4*>(&Ps[r * RP + ty * 4]);
        const float4 sv = *reinterpret_cast<const float4*>(&Ss[r * RP + ty * 4]);
#pragma unroll
        for (int j = 0; j < OC; ++j) {
          const float ov = Ds[(tx + 8 * j) * RP + r];
          const float qv = Qs[(tx + 8 * j) * RP + r];
          dv[0][j] += pv.x * ov;
          dv[1][j] += pv.y * ov;
          dv[2][j] += pv.z * ov;
          dv[3][j] += pv.w * ov;
          dk[0][j] += sv.x * qv;
          dk[1][j] += sv.y * qv;
          dk[2][j] += sv.z * qv;
          dk[3][j] += sv.w * qv;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kpos = k0 + ty * 4 + i;
    if (kpos >= p.Sk) continue;
    float* dkp = static_cast<float*>(p.dk) + b * p.dk_sb + (long long)kpos * p.dk_ss + kvh * p.dk_sh;
    float* dvp = static_cast<float*>(p.dv) + b * p.dv_sb + (long long)kpos * p.dv_ss + kvh * p.dv_sh;
#pragma unroll
    for (int j = 0; j < OC; ++j) {
      dkp[tx + 8 * j] = dk[i][j];
      dvp[tx + 8 * j] = dv[i][j];
    }
  }
}

}  // namespace simt

// ---------------------------------------------------------------------------
// bfloat16 body: products on the tensor cores (mma.sync m16n8k16)
// ---------------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int VEC = 8;  // bf16 values per 16-byte load

template <int HD>
struct Tile {
  static constexpr int RS = HD + 8;  // padded row (bf16) of a 64-row tile
  static constexpr size_t tile = sizeof(bf16) * 64 * RS;
  static constexpr size_t smem = 4 * tile + 2 * sizeof(float) * 64;
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

// rows [row0, row0 + 64) of a (rows, HD) tile into shared memory, 16 bytes
// a load; rows at or past `limit` are zero
template <int HD>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long row_stride, int row0,
                                          int limit) {
  constexpr int PER_ROW = HD / VEC;
  for (int i = threadIdx.x; i < 64 * PER_ROW; i += NT) {
    const int r = i / PER_ROW, d = (i % PER_ROW) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < limit)
      val = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * row_stride + d);
    *reinterpret_cast<uint4*>(dst + r * Tile<HD>::RS + d) = val;
  }
}

// A fragment of rows [row, row + 16), columns [col, col + 16) of a
// row-major tile
template <int HD>
__device__ __forceinline__ void a_frag(uint32_t* a, const bf16* tile, int row,
                                       int col) {
  constexpr int RS = Tile<HD>::RS;
  const int g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const bf16* base = tile + (row + g) * RS + col + t * 2;
  a[0] = ld32(base);
  a[1] = ld32(base + 8 * RS);
  a[2] = ld32(base + 8);
  a[3] = ld32(base + 8 * RS + 8);
}

// C[16 x 64] = A_tile[row .. row + 16) . B_tile^T over hd: both tiles row
// major with hd along the row (the S = Q K^T kind of product)
template <int HD>
__device__ __forceinline__ void rows_dot_rows(float (*c)[4], const bf16* A,
                                              int row, const bf16* Bt) {
  constexpr int RS = Tile<HD>::RS;
  const int g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) c[nt][0] = c[nt][1] = c[nt][2] = c[nt][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t a[4];
    a_frag<HD>(a, A, row, kk * 16);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const bf16* bb = Bt + (nt * 8 + g) * RS + kk * 16 + t * 2;
      mma(c[nt], a, ld32(bb), ld32(bb + 8));
    }
  }
}

// acc[16 x HD] += X[16 x 64] . M[64 x HD]: X given as float32 C fragments
// (rounded to bf16 here), M a row-major tile read transposed by ldmatrix
template <int HD>
__device__ __forceinline__ void frags_dot_tile(float (*acc)[4],
                                               const float (*x)[4],
                                               const bf16* M) {
  constexpr int RS = Tile<HD>::RS;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t xa[4] = {pack(x[2 * kk][0], x[2 * kk][1]),
                            pack(x[2 * kk][2], x[2 * kk][3]),
                            pack(x[2 * kk + 1][0], x[2 * kk + 1][1]),
                            pack(x[2 * kk + 1][2], x[2 * kk + 1][3])};
#pragma unroll
    for (int nt = 0; nt < HD / 8; nt += 2) {
      uint32_t mb[4];
      ldmatrix_x4_trans(mb, M + (kk * 16 + (lane & 15)) * RS + nt * 8 + (lane >> 4) * 8);
      mma(acc[nt], xa, mb[0], mb[1]);
      mma(acc[nt + 1], xa, mb[2], mb[3]);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(NT) dq_kernel(const Params p) {
  constexpr int RS = Tile<HD>::RS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [64][RS]
  bf16* Ds = Qs + 64 * RS;                         // dO
  bf16* Ks = Ds + 64 * RS;
  bf16* Vs = Ks + 64 * RS;

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;  // mma fragment row group, thread
  const int q0 = blockIdx.x * BM;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  load_tile<HD>(Qs, static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh, p.q_ss, q0, p.Sq);
  load_tile<HD>(Ds, static_cast<const bf16*>(p.dout) + b * p.do_sb + h * p.do_sh, p.do_ss, q0,
                p.Sq);

  // this thread's rows (g, g + 8) of the warp's 16
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  float lse[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long at = ((long long)b * p.H + h) * p.Sq + row[i];
    lse[i] = row[i] < p.Sq ? p.lse[at] : 0.f;
    dl[i] = row[i] < p.Sq ? p.delta[at] : 0.f;
  }
  float acc[HD / 8][4];
#pragma unroll
  for (int nt = 0; nt < HD / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;

  const int k_end = p.causal ? min(p.Sk, q0 + BM) : p.Sk;
  for (int k0 = 0; k0 < k_end; k0 += BN) {
    __syncthreads();  // the previous tile's K and V are consumed
    load_tile<HD>(Ks, k, p.k_ss, k0, p.Sk);
    load_tile<HD>(Vs, v, p.v_ss, k0, p.Sk);
    __syncthreads();

    float s[8][4], dp[8][4];
    rows_dot_rows<HD>(s, Qs, warp * 16, Ks);   // S = Q K^T
    rows_dot_rows<HD>(dp, Ds, warp * 16, Vs);  // dP = dO V^T
    // s becomes dS = P (dP - delta) scale
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const bool ok = seen(p, row[i], k0 + nt * 8 + t * 2 + (e & 1));
        const float pij = ok ? expf(s[nt][e] * p.scale - lse[i]) : 0.f;
        s[nt][e] = pij * (dp[nt][e] - dl[i]) * p.scale;
      }
    frags_dot_tile<HD>(acc, s, Ks);  // dQ += dS K
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= p.Sq) continue;
    bf16* dq = static_cast<bf16*>(p.dq) + b * p.dq_sb + (long long)row[i] * p.dq_ss + h * p.dq_sh;
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt)
      *reinterpret_cast<uint32_t*>(dq + nt * 8 + t * 2) = pack(acc[nt][2 * i], acc[nt][2 * i + 1]);
  }
}

template <int HD>
__global__ void __launch_bounds__(NT) dkv_kernel(const Params p) {
  constexpr int RS = Tile<HD>::RS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [64][RS], the block's keys
  bf16* Vs = Ks + 64 * RS;
  bf16* Qs = Vs + 64 * RS;                         // one q tile
  bf16* Ds = Qs + 64 * RS;                         // its dO
  float* Ls = reinterpret_cast<float*>(Ds + 64 * RS);  // [64] lse of the q tile
  float* Dl = Ls + 64;                                 // [64] delta

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int k0 = blockIdx.x * BM;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int G = p.H / p.KV;
  load_tile<HD>(Ks, static_cast<const bf16*>(p.k) + b * p.k_sb + kvh * p.k_sh, p.k_ss, k0, p.Sk);
  load_tile<HD>(Vs, static_cast<const bf16*>(p.v) + b * p.v_sb + kvh * p.v_sh, p.v_ss, k0, p.Sk);

  // this thread's key rows (g, g + 8) of the warp's 16
  const int krow[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
  float dk[HD / 8][4], dv[HD / 8][4];
#pragma unroll
  for (int nt = 0; nt < HD / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[nt][e] = dv[nt][e] = 0.f;

  // top-left causal: queries before k0 see none of the block's keys
  const int q_begin = p.causal ? k0 : 0;
  for (int gh = 0; gh < G; ++gh) {
    const int h = kvh * G + gh;
    const bf16* q = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
    const bf16* dout = static_cast<const bf16*>(p.dout) + b * p.do_sb + h * p.do_sh;
    const float* lse = p.lse + ((long long)b * p.H + h) * p.Sq;
    const float* delta = p.delta + ((long long)b * p.H + h) * p.Sq;
    for (int q0 = q_begin; q0 < p.Sq; q0 += BN) {
      __syncthreads();  // the previous q tile is consumed
      load_tile<HD>(Qs, q, p.q_ss, q0, p.Sq);
      load_tile<HD>(Ds, dout, p.do_ss, q0, p.Sq);
      for (int r = threadIdx.x; r < BN; r += NT) {
        Ls[r] = q0 + r < p.Sq ? lse[q0 + r] : 0.f;
        Dl[r] = q0 + r < p.Sq ? delta[q0 + r] : 0.f;
      }
      __syncthreads();

      float s[8][4], dp[8][4];
      rows_dot_rows<HD>(s, Ks, warp * 16, Qs);   // S^T = K Q^T
      rows_dot_rows<HD>(dp, Vs, warp * 16, Ds);  // dP^T = V dO^T
      // s becomes P^T, dp becomes dS^T
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = nt * 8 + t * 2 + (e & 1);
          const bool ok = seen(p, q0 + r, krow[e >> 1]);
          const float pij = ok ? expf(s[nt][e] * p.scale - Ls[r]) : 0.f;
          s[nt][e] = pij;
          dp[nt][e] = pij * (dp[nt][e] - Dl[r]) * p.scale;
        }
      frags_dot_tile<HD>(dv, s, Ds);   // dV += P^T dO
      frags_dot_tile<HD>(dk, dp, Qs);  // dK += dS^T Q
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (krow[i] >= p.Sk) continue;
    bf16* dkp = static_cast<bf16*>(p.dk) + b * p.dk_sb + (long long)krow[i] * p.dk_ss + kvh * p.dk_sh;
    bf16* dvp = static_cast<bf16*>(p.dv) + b * p.dv_sb + (long long)krow[i] * p.dv_ss + kvh * p.dv_sh;
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt) {
      *reinterpret_cast<uint32_t*>(dkp + nt * 8 + t * 2) = pack(dk[nt][2 * i], dk[nt][2 * i + 1]);
      *reinterpret_cast<uint32_t*>(dvp + nt * 8 + t * 2) = pack(dv[nt][2 * i], dv[nt][2 * i + 1]);
    }
  }
}

}  // namespace tc

template <typename Kernel>
cudaError_t launch(Kernel kernel, size_t smem, dim3 grid, const Params& p,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_dq(const Params& p, int dtype, cudaStream_t st) {
  const dim3 grid((p.Sq + BM - 1) / BM, p.H, p.B);
  if (dtype == 0) return launch(&simt::dq_kernel<HD>, simt::dq_smem<HD>(), grid, p, st);
  return launch(&tc::dq_kernel<HD>, tc::Tile<HD>::smem, grid, p, st);
}

template <int HD>
cudaError_t launch_dkv(const Params& p, int dtype, cudaStream_t st) {
  const dim3 grid((p.Sk + BM - 1) / BM, p.KV, p.B);
  if (dtype == 0) return launch(&simt::dkv_kernel<HD>, simt::dkv_smem<HD>(), grid, p, st);
  return launch(&tc::dkv_kernel<HD>, tc::Tile<HD>::smem, grid, p, st);
}

// which: 0 = dQ (B2a), 1 = dK and dV (B2b)
cudaError_t dispatch(const Params& p, int which, int dtype, int hd, cudaStream_t st) {
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  switch (hd) {
    case 16: return which == 0 ? launch_dq<16>(p, dtype, st) : launch_dkv<16>(p, dtype, st);
    case 32: return which == 0 ? launch_dq<32>(p, dtype, st) : launch_dkv<32>(p, dtype, st);
    case 64: return which == 0 ? launch_dq<64>(p, dtype, st) : launch_dkv<64>(p, dtype, st);
    case 128: return which == 0 ? launch_dq<128>(p, dtype, st) : launch_dkv<128>(p, dtype, st);
  }
  return cudaErrorInvalidValue;
}

int entry(int which, const void* q, const void* k, const void* v, const void* dout,
          const float* lse, const float* delta, void* dq, void* dk, void* dv, int dtype,
          int B, int H, int KV, int Sq, int Sk, int hd, const long long* st, float scale,
          int causal, void* stream) {
  if (B < 1 || H < 1 || KV < 1 || H % KV != 0 || Sq < 1 || Sk < 1)
    return (int)cudaErrorInvalidValue;
  const Params p{q,      k,      v,      dout,   lse,    delta,  dq,     dk,     dv,
                 B,      H,      KV,     Sq,     Sk,     st[0],  st[1],  st[2],  st[3],
                 st[4],  st[5],  st[6],  st[7],  st[8],  st[9],  st[10], st[11], st[12],
                 st[13], st[14], st[15], st[16], st[17], st[18], st[19], st[20], scale,
                 causal};
  return (int)dispatch(p, which, dtype, hd, static_cast<cudaStream_t>(stream));
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. `strides` holds 21 element strides, the
// (batch, sequence, head) strides of q, k, v, dO, dQ, dK and dV in that
// order. The bfloat16 body loads and stores 4 to 16 bytes at a time: every
// tensor must be 16-byte aligned with strides that are multiples of 8
// elements. Each returns a cudaError_t (0 on success).
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                            const float* lse, const float* delta, void* dq, int dtype, int B,
                            int H, int KV, int Sq, int Sk, int hd, const long long* strides,
                            float scale, int causal, void* stream) {
  return entry(0, q, k, v, dout, lse, delta, dq, nullptr, nullptr, dtype, B, H, KV, Sq, Sk,
               hd, strides, scale, causal, stream);
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const float* lse, const float* delta, void* dk, void* dv,
                             int dtype, int B, int H, int KV, int Sq, int Sk, int hd,
                             const long long* strides, float scale, int causal,
                             void* stream) {
  return entry(1, q, k, v, dout, lse, delta, nullptr, dk, dv, dtype, B, H, KV, Sq, Sk, hd,
               strides, scale, causal, stream);
}

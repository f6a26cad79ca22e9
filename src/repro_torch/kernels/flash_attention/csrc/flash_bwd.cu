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
// nothing, so each output tile is owned by one block, which loops over the
// tiles it needs itself with the sums in registers: B2a over the K/V tiles
// of K/V head h / G up to the causal diagonal, B2b over the G query heads x
// the q tiles from the diagonal on. Every output element is written by
// exactly one block and no kernel uses atomics, so the backward repeats bit
// for bit; no P matrix is stored. Two kernels and not one: one kernel that
// owns a K/V tile would have to add up each q tile's dQ across the blocks
// that own its keys, by float atomics (whose order changes from run to run)
// or by a semaphore-ordered float32 sum (a zero fill, a convert pass and
// serialised writers). Two kernels recompute S and dP (7 products where
// one kernel runs 5), but each is B1's loop turned one way or the other.
// Two bodies, as in flash_fwd.cu:
//
// * bfloat16 (the training path; hd = 16, 32, 64, 112, 128), on the building
//   blocks of hopper.cuh. Both kernels are persistent, one block per SM
//   walking work tiles of 128 rows, causal ones heaviest first, in snake
//   order. Warpgroup 0 is the producer (setmaxnreg leaves it 24 registers,
//   40 in B2b): TMA loads through 4-D (hd, heads, S, B) tensor maps of the
//   strided layouts into stages guarded by mbarriers, whose ring runs on
//   across work tiles. Two consumer warpgroups (240 registers each, 232 in
//   B2b) own 64 rows each. Every product is wgmma with float32 accumulators
//   in registers: the score-like ones (S, dP, S^T, dP^T) `ss` with both
//   operands K-major in shared memory, the gradient ones `rs` with P or dS
//   rounded to bf16 into A fragments in registers, as FlashAttention-2
//   rounds them, and B read MN-major from the [rows][hd] tile that the `ss`
//   product read K-major. P = 2^(s * scale * log2e - lse * log2e), one FFMA
//   and one ex2 an element; the mask applies only on tiles that cross Sq,
//   Sk or the warpgroup's diagonal. The gradients leave through shared
//   memory in the swizzled layout by TMA stores, which skip the rows past
//   Sq or Sk, as TMA's zero fill masks them on the way in.
//   - B2a: a work tile is 128 query rows of one (b, h); its Q and dO are
//     loaded once, its K and V tiles (128 keys; 64 at hd = 128, where
//     128-key S and dP do not fit beside dQ) stream through a 2-stage ring.
//     Each consumer holds its rows' lse and delta in registers; S and dP
//     issue together, P forms while dP runs, then dQ += dS K.
//   - B2b: a work tile is 128 keys of one (b, K/V head); its K and V are
//     loaded once, and the ring carries each 64-query tile's Q and dO (by
//     TMA) and its lse and delta (loaded by the producer warp's lanes, every
//     load in flight before the first store: rows of Sq floats are not
//     16-byte aligned for TMA). S^T = K Q^T and dP^T = V dO^T take lse and
//     delta by column, that is by query, from the stage; then dV += P^T dO
//     and dK += dS^T Q. A causal q tile that lies wholly before a
//     warpgroup's first key is only released.
//   hd = 112 (kimi-k2) runs the hd = 128 instances on tensor maps whose
//   dimension 0 is 112, the loads' and the dQ, dK and dV stores' alike:
//   TMA zero-fills columns 112..127 of Q, K, V and dO in shared memory, so
//   S, dP and every gradient column below 112 are those of hd = 112, the
//   gradients' columns 112..127 come out 0 and the stores leave them out
//   (hopper.cuh, Box).
// * float32: the products run on the CUDA cores in float32 over tiles
//   staged transposed in shared memory, one block per (b, h, 64-row q tile)
//   (B2a) or per (b, K/V head, 64-row k tile) (B2b), each thread owning 4
//   rows by hd / 8 columns of each sum.

#include "hopper.cuh"

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
// bfloat16 body: TMA into mbarrier rings, wgmma for every product
// ---------------------------------------------------------------------------

namespace hopper {

// The work tile of a block's n-th pass over the grid: the passes run
// forwards and backwards in turn, so that with work tiles numbered heaviest
// first a block that takes a heavy tile in one pass takes a light one in
// the next (the busiest block's share of a causal gpt2-124m backward: 27
// rounds against a mean of 26.2; 30 with every pass forwards)
__device__ __forceinline__ int snake(int n) {
  return n * gridDim.x + (n & 1 ? gridDim.x - 1 - blockIdx.x : blockIdx.x);
}

__device__ __forceinline__ float2 ld_shared_f2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y) : "r"(addr) : "memory");
  return v;
}

// ----- B2a: dQ -------------------------------------------------------------

template <int HD>
struct DqCfg : Box<HD> {
  // keys of a K/V tile: at hd = 128, 128-key S and dP do not fit the
  // consumers' registers beside dQ
  static constexpr int BN = HD == 128 ? 64 : 128;
  static constexpr int Q_BYTES = BLOCK_M * HD * 2;  // Q, dO and dQ tiles
  static constexpr int KV_BYTES = BN * HD * 2;      // one K or V tile
  static constexpr int TILES = 3 * Q_BYTES + 2 * STAGES * KV_BYTES;
  static constexpr int SMEM = 1024 + TILES + 1024;  // alignment, barriers
};

struct DqBarriers {
  uint64_t q_full, q_empty;                        // the work tile's Q and dO
  uint64_t kv_full[STAGES], kv_empty[STAGES];      // the K/V ring
};

// P = exp(S scale - lse) in place, in log2 units (one FFMA and one ex2 an
// element); MASK zeroes the keys past Sk and, causal, past the row
template <int BN, bool MASK>
__device__ __forceinline__ void dq_probs(float (&sc)[BN / 2], float sl2,
                                         const float (&lse2)[2], int k0,
                                         int r_lo, int t, int Sk, int causal) {
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    const float x = ex2(fmaf(sc[i], sl2, -lse2[(i >> 1) & 1]));
    if (MASK) {
      const int col = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
      const int row = r_lo + 8 * ((i >> 1) & 1);
      sc[i] = col >= Sk || (causal && col > row) ? 0.f : x;
    } else {
      sc[i] = x;
    }
  }
}

// dS = P (dP - delta) scale, rounded to bf16 as the A fragments of dS K;
// dls is delta * scale of the thread's two rows
template <int BN>
__device__ __forceinline__ void dq_grads(const float (&sc)[BN / 2],
                                         const float (&dp)[BN / 2], float scale,
                                         const float (&dls)[2],
                                         uint32_t (&da)[BN / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 8 * kk + 2 * e, r = e & 1;
      da[kk][e] = pack(sc[i] * fmaf(dp[i], scale, -dls[r]),
                       sc[i + 1] * fmaf(dp[i + 1], scale, -dls[r]));
    }
}

// Persistent: each block walks the work tiles of 128 query rows of one
// (b, h), heaviest first (Work), in snake order. The producer loads a
// tile's Q and dO once and streams its K/V tiles through the ring, which
// runs on across work tiles. Consumer warpgroup c owns rows [q0 + 64 c,
// q0 + 64 c + 64): for each K/V tile, S = Q K^T and dP = dO V^T (ss), P
// from S while dP runs, dS into bf16 fragments, dQ += dS K (rs, K read
// MN-major from the tile S read K-major).
template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
dq_kernel(const __grid_constant__ CUtensorMap tq,
          const __grid_constant__ CUtensorMap tk,
          const __grid_constant__ CUtensorMap tv,
          const __grid_constant__ CUtensorMap tdo,
          const __grid_constant__ CUtensorMap tdq, const Params p) {
  using C = DqCfg<HD>;
  constexpr int BN = C::BN, CW = C::CW, RB = C::RB;
  extern __shared__ unsigned char smem_raw[];
  // swizzled boxes need 1024-byte alignment
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  bf16* Qs = reinterpret_cast<bf16*>(base);
  bf16* Ds = reinterpret_cast<bf16*>(base + C::Q_BYTES);
  bf16* dQs = reinterpret_cast<bf16*>(base + 2 * C::Q_BYTES);
  bf16* Ks = reinterpret_cast<bf16*>(base + 3 * C::Q_BYTES);
  bf16* Vs = Ks + STAGES * (C::KV_BYTES / 2);
  DqBarriers* bars = reinterpret_cast<DqBarriers*>(base + C::TILES);
  const int n_work = (p.Sq + BLOCK_M - 1) / BLOCK_M * p.H * p.B;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    bar_init(&bars->q_full, 1);
    bar_init(&bars->q_empty, 4 * CONSUMERS);  // one arrival a warp
    for (int s = 0; s < STAGES; ++s) {
      bar_init(&bars->kv_full[s], 1);
      bar_init(&bars->kv_empty[s], 4 * CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread keeps Q, dO and the K/V ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      int kv = 0;  // K/V tiles loaded so far: the ring's position
      for (int n = 0, w = blockIdx.x; w < n_work; w = snake(++n)) {
        const Work<BN> wk(w, p.Sq, p.Sk, p.H, p.B, p.causal);
        const int kvh = wk.h / (p.H / p.KV);
        bar_wait(&bars->q_empty, (n & 1) ^ 1);
        bar_expect(&bars->q_full, 2 * C::Q_BYTES);
#pragma unroll
        for (int x = 0; x < C::NBOX; ++x) {
          tma_load(Qs + x * BLOCK_M * CW, &tq, &bars->q_full, x * CW, wk.h,
                   wk.q0, wk.b);
          tma_load(Ds + x * BLOCK_M * CW, &tdo, &bars->q_full, x * CW, wk.h,
                   wk.q0, wk.b);
        }
        for (int it = 0; it < wk.n_tiles; ++it, ++kv) {
          const int s = kv % STAGES;
          bf16* kd = Ks + s * (C::KV_BYTES / 2);
          bf16* vd = Vs + s * (C::KV_BYTES / 2);
          bar_wait(&bars->kv_empty[s], ((kv / STAGES) & 1) ^ 1);
          bar_expect(&bars->kv_full[s], 2 * C::KV_BYTES);
#pragma unroll
          for (int x = 0; x < C::NBOX; ++x) {
            tma_load(kd + x * BN * CW, &tk, &bars->kv_full[s], x * CW, kvh,
                     it * BN, wk.b);
            tma_load(vd + x * BN * CW, &tv, &bars->kv_full[s], x * CW, kvh,
                     it * BN, wk.b);
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int c = wg - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
    const float sl2 = p.scale * LOG2E;  // scores in log2 units
    const float one[2] = {1.f, 1.f};    // dQ leaves unscaled
    const uint32_t q_addr = smem_u32(Qs) + c * 64 * RB;
    const uint32_t do_addr = smem_u32(Ds) + c * 64 * RB;
    const uint32_t k_base = smem_u32(Ks), v_base = smem_u32(Vs);
    int kv = 0;  // K/V tiles consumed so far
    for (int n = 0, w = blockIdx.x; w < n_work; w = snake(++n)) {
      const Work<BN> wk(w, p.Sq, p.Sk, p.H, p.B, p.causal);
      const int row0 = wk.q0 + c * 64;
      const int r_lo = row0 + warp * 16 + g;  // this thread's rows: r_lo, r_lo + 8
      // the tiles with a key that these rows see; the work's other tiles
      // (causal, 64-key tiles: the first warpgroup's last) are only released
      const int n_mine = p.causal
          ? min(wk.n_tiles, (row0 + 64 + BN - 1) / BN) : wk.n_tiles;
      float lse2[2], dls[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r_lo + 8 * r;
        const long long at = ((long long)wk.b * p.H + wk.h) * p.Sq + row;
        lse2[r] = row < p.Sq ? p.lse[at] * LOG2E : 0.f;
        dls[r] = row < p.Sq ? p.delta[at] * p.scale : 0.f;
      }
      float dq[HD / 2];
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) dq[i] = 0.f;

      bar_wait(&bars->q_full, n & 1);
      for (int it = 0; it < n_mine; ++it) {
        const int s = (kv + it) % STAGES;
        const uint32_t k_addr = k_base + s * C::KV_BYTES;
        float sc[BN / 2], dp[BN / 2];
        uint32_t da[BN / 16][4];
        bar_wait(&bars->kv_full[s], ((kv + it) / STAGES) & 1);
        wgmma_fence();
        issue_ss<HD, BN>(sc, q_addr, k_addr);
        wgmma_commit();
        issue_ss<HD, BN>(dp, do_addr, v_base + s * C::KV_BYTES);
        wgmma_commit();
        wgmma_wait<1>();  // S
        fence_regs(sc);
        const int k0 = it * BN;
        if (k0 + BN > p.Sk || (p.causal && k0 + BN - 1 > row0))
          dq_probs<BN, true>(sc, sl2, lse2, k0, r_lo, t, p.Sk, p.causal);
        else
          dq_probs<BN, false>(sc, sl2, lse2, k0, r_lo, t, p.Sk, p.causal);
        wgmma_wait<0>();  // dP
        fence_regs(dp);
        if (lane == 0 && it == n_mine - 1) bar_arrive(&bars->q_empty);
        dq_grads<BN>(sc, dp, p.scale, dls, da);
        wgmma_fence();
        issue_rs<HD, BN>(dq, da, k_addr);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dq);
        fence_regs(da);
        if (lane == 0) bar_arrive(&bars->kv_empty[s]);
      }
      // a stage is released once its tile has arrived, never before
      if (lane == 0)
        for (int it = kv + n_mine; it < kv + wk.n_tiles; ++it) {
          bar_wait(&bars->kv_full[it % STAGES], (it / STAGES) & 1);
          bar_arrive(&bars->kv_empty[it % STAGES]);
        }
      kv += wk.n_tiles;

      // dQ leaves through this warp's 16 rows of the staging tile, by one
      // TMA store a box that writes only the rows below Sq; the warp's store
      // before must have read them
      if (lane == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      __syncwarp();
      stage_rows<HD>(smem_u32(dQs), dq, one, c * 64 + warp * 16, g, t);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncwarp();
      if (lane == 0) {
        store_rows<HD>(&tdq, dQs, c * 64 + warp * 16, wk.h, row0 + warp * 16, wk.b);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
    }
    if (lane == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// ----- B2b: dK and dV ------------------------------------------------------

// queries of a stage of B2b's ring: 128-query S^T and dP^T beside dK and
// dV need more registers than a consumer has without spilling
constexpr int BQ = 64;

template <int HD>
struct DkvCfg : Box<HD> {
  static constexpr int K_BYTES = BLOCK_M * HD * 2;  // K, V, dK and dV tiles
  static constexpr int Q_BYTES = BQ * HD * 2;       // one Q or dO tile
  static constexpr int TILES = 4 * K_BYTES + 2 * STAGES * Q_BYTES;
  // then lse and delta of each stage, and the barriers
  static constexpr int SMEM = 1024 + TILES + 2 * STAGES * BQ * 4 + 1024;
};

struct DkvBarriers {
  uint64_t kv_full, kv_empty;             // the work tile's K and V
  uint64_t full[STAGES], empty[STAGES];   // the Q, dO, lse, delta ring
};

// One work tile of B2b: BLOCK_M keys of one (b, K/V head), heaviest first
// (causal: the first keys are seen by the most queries), K/V heads fastest.
// Its queries come in tiles of BQ rows from q_tile0 (causal: the first that
// sees a key of it), n_q of them for each of the G query heads.
struct KeyWork {
  int k0, kvh, b, q_tile0, n_q;
  __device__ __forceinline__ KeyWork(int w, int Sq, int KV, int B,
                                     int causal) {
    kvh = w % KV;
    b = w / KV % B;
    k0 = w / (KV * B) * BLOCK_M;
    q_tile0 = causal ? k0 / BQ : 0;
    n_q = max(0, (Sq + BQ - 1) / BQ - q_tile0);
  }
};

// P^T = exp(S^T scale - lse) in place, in log2 units: rows are keys,
// columns queries, so lse (times log2e, from the stage) goes by column.
// MASK zeroes the queries past Sq and, causal, before the key.
template <bool MASK>
__device__ __forceinline__ void dkv_probs(float (&sc)[BQ / 2], float sl2,
                                          uint32_t lse2, int q0, int kr_lo,
                                          int t, int Sq, int causal) {
#pragma unroll
  for (int jj = 0; jj < BQ / 8; ++jj) {
    const float2 l = ld_shared_f2(lse2 + 4 * (8 * jj + 2 * t));
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * jj + e;
      const float x = ex2(fmaf(sc[i], sl2, -(e & 1 ? l.y : l.x)));
      if (MASK) {
        const int col = q0 + 8 * jj + 2 * t + (e & 1);
        const int row = kr_lo + 8 * (e >> 1);
        sc[i] = col >= Sq || (causal && row > col) ? 0.f : x;
      } else {
        sc[i] = x;
      }
    }
  }
}

// dS^T = P^T (dP^T - delta) scale in place in dp; dls is delta times the
// scale of the stage's queries
__device__ __forceinline__ void dkv_grads(const float (&sc)[BQ / 2],
                                          float (&dp)[BQ / 2], float scale,
                                          uint32_t dls, int t) {
#pragma unroll
  for (int jj = 0; jj < BQ / 8; ++jj) {
    const float2 d = ld_shared_f2(dls + 4 * (8 * jj + 2 * t));
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * jj + e;
      dp[i] = sc[i] * fmaf(dp[i], scale, -(e & 1 ? d.y : d.x));
    }
  }
}

// Persistent: each block walks the work tiles (KeyWork) in snake order.
// The producer warp loads a work tile's K and V once, and streams each
// q tile's Q, dO, lse and delta through the ring (over the G query heads x
// the q tiles from the diagonal on), which runs on across work tiles.
// Consumer warpgroup c owns keys [k0 + 64 c, k0 + 64 c + 64): for each q
// tile, S^T = K Q^T and dP^T = V dO^T (ss), P^T from S^T while dP^T runs,
// dS^T, both rounded to bf16 fragments, then dV += P^T dO and dK += dS^T Q
// (rs, dO and Q read MN-major from the tiles S^T and dP^T read K-major). dK
// and dV are summed over the G heads in registers and written once.
template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
dkv_kernel(const __grid_constant__ CUtensorMap tq,
           const __grid_constant__ CUtensorMap tk,
           const __grid_constant__ CUtensorMap tv,
           const __grid_constant__ CUtensorMap tdo,
           const __grid_constant__ CUtensorMap tdk,
           const __grid_constant__ CUtensorMap tdv, const Params p) {
  using C = DkvCfg<HD>;
  constexpr int CW = C::CW, RB = C::RB;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  bf16* Ks = reinterpret_cast<bf16*>(base);
  bf16* Vs = reinterpret_cast<bf16*>(base + C::K_BYTES);
  bf16* dKs = reinterpret_cast<bf16*>(base + 2 * C::K_BYTES);
  bf16* dVs = reinterpret_cast<bf16*>(base + 3 * C::K_BYTES);
  bf16* Qs = reinterpret_cast<bf16*>(base + 4 * C::K_BYTES);  // [STAGES] tiles
  bf16* Ds = Qs + STAGES * (C::Q_BYTES / 2);
  float* Ls = reinterpret_cast<float*>(base + C::TILES);  // [STAGES][BQ] lse log2e
  float* Dl = Ls + STAGES * BQ;                           // [STAGES][BQ] delta scale
  DkvBarriers* bars = reinterpret_cast<DkvBarriers*>(Dl + STAGES * BQ);
  const int n_work = (p.Sk + BLOCK_M - 1) / BLOCK_M * p.KV * p.B;
  const int G = p.H / p.KV;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    bar_init(&bars->kv_full, 1);
    bar_init(&bars->kv_empty, 4 * CONSUMERS);
    for (int s = 0; s < STAGES; ++s) {
      bar_init(&bars->full[s], 32);  // the producer warp's lanes
      bar_init(&bars->empty[s], 4 * CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: warp 0 keeps K, V and the ring full; lane 0 issues the
    // TMA loads, then every lane loads BQ / 32 queries' lse and delta.
    // Those loads and the ring's state need 40 registers, which leaves the
    // consumers 232.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      const uint32_t ls_addr = smem_u32(Ls), dl_addr = smem_u32(Dl);
      int r = 0;  // q tiles loaded so far: the ring's position
      for (int n = 0, w = blockIdx.x; w < n_work; w = snake(++n)) {
        const KeyWork wk(w, p.Sq, p.KV, p.B, p.causal);
        if (lane == 0) {
          bar_wait(&bars->kv_empty, (n & 1) ^ 1);
          bar_expect(&bars->kv_full, 2 * C::K_BYTES);
#pragma unroll
          for (int x = 0; x < C::NBOX; ++x) {
            tma_load(Ks + x * BLOCK_M * CW, &tk, &bars->kv_full, x * CW, wk.kvh,
                     wk.k0, wk.b);
            tma_load(Vs + x * BLOCK_M * CW, &tv, &bars->kv_full, x * CW, wk.kvh,
                     wk.k0, wk.b);
          }
        }
        for (int gh = 0; gh < G; ++gh) {
          const int h = wk.kvh * G + gh;
          const long long row = ((long long)wk.b * p.H + h) * p.Sq;
          for (int j = 0; j < wk.n_q; ++j, ++r) {
            const int s = r % STAGES;
            const int q0 = (wk.q_tile0 + j) * BQ;
            bar_wait(&bars->empty[s], ((r / STAGES) & 1) ^ 1);
            if (lane == 0) {
              bar_expect_tx(&bars->full[s], 2 * C::Q_BYTES);
              bf16* qd = Qs + s * (C::Q_BYTES / 2);
              bf16* dd = Ds + s * (C::Q_BYTES / 2);
#pragma unroll
              for (int x = 0; x < C::NBOX; ++x) {
                tma_load(qd + x * BQ * CW, &tq, &bars->full[s], x * CW, h, q0, wk.b);
                tma_load(dd + x * BQ * CW, &tdo, &bars->full[s], x * CW, h, q0, wk.b);
              }
            }
            // every load in flight before the first store; a query past Sq
            // reads the last one's, which the consumers mask
            float l[BQ / 32], d[BQ / 32];
#pragma unroll
            for (int e = 0; e < BQ / 32; ++e) {
              const int q = min(q0 + 32 * e + lane, p.Sq - 1);
              l[e] = p.lse[row + q];
              d[e] = p.delta[row + q];
            }
#pragma unroll
            for (int e = 0; e < BQ / 32; ++e) {
              const uint32_t at = 4 * (s * BQ + 32 * e + lane);
              st_shared(ls_addr + at, __float_as_uint(l[e] * LOG2E));
              st_shared(dl_addr + at, __float_as_uint(d[e] * p.scale));
            }
            bar_arrive(&bars->full[s]);
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int c = wg - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
    const float sl2 = p.scale * LOG2E;
    const float one[2] = {1.f, 1.f};    // dK and dV leave unscaled
    const uint32_t k_addr = smem_u32(Ks) + c * 64 * RB;
    const uint32_t v_addr = smem_u32(Vs) + c * 64 * RB;
    const uint32_t q_base = smem_u32(Qs), do_base = smem_u32(Ds);
    const uint32_t ls_addr = smem_u32(Ls), dl_addr = smem_u32(Dl);
    int r = 0;  // q tiles consumed so far
    for (int n = 0, w = blockIdx.x; w < n_work; w = snake(++n)) {
      const KeyWork wk(w, p.Sq, p.KV, p.B, p.causal);
      const int kw0 = wk.k0 + c * 64;               // this warpgroup's keys
      const int kr_lo = kw0 + warp * 16 + g;        // this thread's: kr_lo, kr_lo + 8
      // causal: the q tiles before this warpgroup's first key see none of
      // its keys and are only released; the last q tile is seen if any is
      const bool any = wk.n_q > 0
          && !(p.causal && (wk.q_tile0 + wk.n_q) * BQ - 1 < kw0);
      float dk[HD / 2], dv[HD / 2];
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) dk[i] = dv[i] = 0.f;

      bar_wait(&bars->kv_full, n & 1);
      if (!any && lane == 0) bar_arrive(&bars->kv_empty);
      for (int gh = 0; gh < G; ++gh)
        for (int j = 0; j < wk.n_q; ++j, ++r) {
          const int s = r % STAGES;
          const uint32_t ph = (r / STAGES) & 1;
          const int q0 = (wk.q_tile0 + j) * BQ;
          if (p.causal && q0 + BQ - 1 < kw0) {
            if (lane == 0) {
              bar_wait(&bars->full[s], ph);
              bar_arrive(&bars->empty[s]);
            }
            continue;
          }
          const uint32_t q_addr = q_base + s * C::Q_BYTES;
          const uint32_t do_addr = do_base + s * C::Q_BYTES;
          float sc[BQ / 2], dp[BQ / 2];
          uint32_t pa[BQ / 16][4], da[BQ / 16][4];
          bar_wait(&bars->full[s], ph);
          wgmma_fence();
          issue_ss<HD, BQ>(sc, k_addr, q_addr);
          wgmma_commit();
          issue_ss<HD, BQ>(dp, v_addr, do_addr);
          wgmma_commit();
          wgmma_wait<1>();  // S^T
          fence_regs(sc);
          if (q0 + BQ > p.Sq || (p.causal && q0 < kw0 + 63))
            dkv_probs<true>(sc, sl2, ls_addr + 4 * s * BQ, q0, kr_lo, t, p.Sq,
                            p.causal);
          else
            dkv_probs<false>(sc, sl2, ls_addr + 4 * s * BQ, q0, kr_lo, t, p.Sq,
                             p.causal);
          wgmma_wait<0>();  // dP^T
          fence_regs(dp);
          // K and V are read for the last time by the work's last q tile
          if (lane == 0 && gh == G - 1 && j == wk.n_q - 1)
            bar_arrive(&bars->kv_empty);
          dkv_grads(sc, dp, p.scale, dl_addr + 4 * s * BQ, t);
          to_bf16<BQ>(sc, pa);
          to_bf16<BQ>(dp, da);
          wgmma_fence();
          issue_rs<HD, BQ>(dv, pa, do_addr);
          issue_rs<HD, BQ>(dk, da, q_addr);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(dv);
          fence_regs(dk);
          fence_regs(pa);
          fence_regs(da);
          if (lane == 0) bar_arrive(&bars->empty[s]);
        }

      // dK and dV leave through this warp's 16 rows of their staging
      // tiles, by one TMA store a box each that writes only the rows below
      // Sk; the warp's stores before must have read them
      if (lane == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      __syncwarp();
      stage_rows<HD>(smem_u32(dKs), dk, one, c * 64 + warp * 16, g, t);
      stage_rows<HD>(smem_u32(dVs), dv, one, c * 64 + warp * 16, g, t);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncwarp();
      if (lane == 0) {
        store_rows<HD>(&tdk, dKs, c * 64 + warp * 16, wk.kvh, kw0 + warp * 16, wk.b);
        store_rows<HD>(&tdv, dVs, c * 64 + warp * 16, wk.kvh, kw0 + warp * 16, wk.b);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
    }
    if (lane == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// HD is the tile width; `hd` (<= HD) the tensors' head dim, every map's
// dimension 0, past which TMA reads zeros and writes nothing
template <int HD>
cudaError_t launch_dq(const Params& p, cudaStream_t st, int hd) {
  using C = DqCfg<HD>;
  CUtensorMap tq, tk, tv, tdo, tdq;
  if (!tensor_map<HD>(&tq, p.q, p.H, p.Sq, p.B, p.q_sh, p.q_ss, p.q_sb, BLOCK_M, hd)
      || !tensor_map<HD>(&tk, p.k, p.KV, p.Sk, p.B, p.k_sh, p.k_ss, p.k_sb, C::BN, hd)
      || !tensor_map<HD>(&tv, p.v, p.KV, p.Sk, p.B, p.v_sh, p.v_ss, p.v_sb, C::BN, hd)
      || !tensor_map<HD>(&tdo, p.dout, p.H, p.Sq, p.B, p.do_sh, p.do_ss, p.do_sb,
                         BLOCK_M, hd)
      || !tensor_map<HD>(&tdq, p.dq, p.H, p.Sq, p.B, p.dq_sh, p.dq_ss, p.dq_sb, 16,
                         hd))
    return cudaErrorInvalidValue;
  int grid;
  const cudaError_t err = persistent_grid(
      dq_kernel<HD>, C::SMEM,
      (long long)((p.Sq + BLOCK_M - 1) / BLOCK_M) * p.H * p.B, &grid);
  if (err != cudaSuccess) return err;
  dq_kernel<HD><<<grid, THREADS, C::SMEM, st>>>(tq, tk, tv, tdo, tdq, p);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_dkv(const Params& p, cudaStream_t st, int hd) {
  using C = DkvCfg<HD>;
  CUtensorMap tq, tk, tv, tdo, tdk, tdv;
  if (!tensor_map<HD>(&tq, p.q, p.H, p.Sq, p.B, p.q_sh, p.q_ss, p.q_sb, BQ, hd)
      || !tensor_map<HD>(&tk, p.k, p.KV, p.Sk, p.B, p.k_sh, p.k_ss, p.k_sb, BLOCK_M, hd)
      || !tensor_map<HD>(&tv, p.v, p.KV, p.Sk, p.B, p.v_sh, p.v_ss, p.v_sb, BLOCK_M, hd)
      || !tensor_map<HD>(&tdo, p.dout, p.H, p.Sq, p.B, p.do_sh, p.do_ss, p.do_sb, BQ, hd)
      || !tensor_map<HD>(&tdk, p.dk, p.KV, p.Sk, p.B, p.dk_sh, p.dk_ss, p.dk_sb, 16, hd)
      || !tensor_map<HD>(&tdv, p.dv, p.KV, p.Sk, p.B, p.dv_sh, p.dv_ss, p.dv_sb, 16, hd))
    return cudaErrorInvalidValue;
  int grid;
  const cudaError_t err = persistent_grid(
      dkv_kernel<HD>, C::SMEM,
      (long long)((p.Sk + BLOCK_M - 1) / BLOCK_M) * p.KV * p.B, &grid);
  if (err != cudaSuccess) return err;
  dkv_kernel<HD><<<grid, THREADS, C::SMEM, st>>>(tq, tk, tv, tdo, tdk, tdv, p);
  return cudaGetLastError();
}

}  // namespace hopper

template <typename Kernel>
cudaError_t launch(Kernel kernel, size_t smem, dim3 grid, const Params& p,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

// HD is the head dim, TW the bf16 body's tile width (hopper.cuh, Box)
template <int HD, int TW = HD>
cudaError_t launch_dq(const Params& p, int dtype, cudaStream_t st) {
  if (dtype == 1) return hopper::launch_dq<TW>(p, st, HD);
  const dim3 grid((p.Sq + BM - 1) / BM, p.H, p.B);
  return launch(&simt::dq_kernel<HD>, simt::dq_smem<HD>(), grid, p, st);
}

template <int HD, int TW = HD>
cudaError_t launch_dkv(const Params& p, int dtype, cudaStream_t st) {
  if (dtype == 1) return hopper::launch_dkv<TW>(p, st, HD);
  const dim3 grid((p.Sk + BM - 1) / BM, p.KV, p.B);
  return launch(&simt::dkv_kernel<HD>, simt::dkv_smem<HD>(), grid, p, st);
}

// which: 0 = dQ (B2a), 1 = dK and dV (B2b)
cudaError_t dispatch(const Params& p, int which, int dtype, int hd, cudaStream_t st) {
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  switch (hd) {
    case 16: return which == 0 ? launch_dq<16>(p, dtype, st) : launch_dkv<16>(p, dtype, st);
    case 32: return which == 0 ? launch_dq<32>(p, dtype, st) : launch_dkv<32>(p, dtype, st);
    case 64: return which == 0 ? launch_dq<64>(p, dtype, st) : launch_dkv<64>(p, dtype, st);
    // bf16 on 128-column tiles
    case 112: return which == 0 ? launch_dq<112, 128>(p, dtype, st)
                                : launch_dkv<112, 128>(p, dtype, st);
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
// order. The bfloat16 body reads and writes every tensor but lse and delta
// by TMA: each must be 16-byte aligned with strides that are multiples of 8
// elements. Each returns a cudaError_t (0 on success);
// cudaErrorInvalidValue also when a tensor map cannot be encoded.
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

// Flash-attention forward for Hopper (sm_90a), with a plain C interface
// for ctypes.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py:32 `_fwd_kernel`
// (launched by `flash_fwd` at :86, `pl.pallas_call` at :107). Same
// function: streaming-softmax attention that returns O in q's dtype and the
// float32 log-sum-exp, GQA by head index h / (H / KV), a top-left causal
// mask (key k is seen by query q when k <= q) or none, ragged Sq and Sk
// masked inside the kernel, the scores q . k * scale formed in float32.
//
// What bounds it on an H100: the causal work is 2 * B * H * hd * S^2
// operations against the bytes of q, k, v, o and the LSE, each moved once.
// At the main path's shapes the bytes set the card's least time: yi-6b's
// prefill (B=4, S=512, H=32, KV=4, hd=128) moves 38 MB, 0.0113 ms at 3.35
// TB/s, against 0.0087 ms of bf16 tensor-core work; zamba2's prefill (hd=64,
// H=KV=32) 0.0101 against 0.0044; a gpt2-124m train step's forward (B=8,
// S=1024, H=KV=12, hd=64) 0.0151 against 0.0130. Past the device memory,
// every 128 query rows read each K/V tile again from L2 (84 MB at yi-6b's
// shape), and a block that waits on a load or a store leaves its SM idle.
//
// Design: the TPU kernel walks a sequential (B, H, nq, nk) grid and carries
// m, l and the accumulator in VMEM scratch from one grid step to the next.
// On Hopper blocks run in parallel and carry nothing. Two bodies:
//
// * bfloat16 (every model's path; hd = 16, 32, 64, 112, 128): persistent, one
//   block per SM walking work tiles of 128 query rows of one (b, h), the
//   causal ones heaviest first so the light ones fill the end. Warpgroup 0
//   is the producer: one thread TMA-loads each tile's Q and its K/V tiles
//   into a 2-stage ring of mbarrier-guarded stages (setmaxnreg leaves it 24
//   registers), a tile's Q as soon as the last S of the tile before has
//   read its own, so loads overlap the neighbour's products and stores.
//   Two consumer warpgroups (240 registers each) own 64 query rows each:
//   S = Q K^T is wgmma with both operands read from shared memory through
//   descriptors; the online softmax runs on the accumulator fragments in
//   log2 units (scale * log2e folded into one FFMA before ex2; the mask only
//   on tiles that cross Sk or the warpgroup's diagonal; row max and sum over
//   the 4 threads of a row by shuffles); P is rounded to bf16 in registers
//   and is the A operand of O += P V, with V read MN-major from its
//   [keys][hd] rows (the transpose bit). S of tile t+1 is issued with P V
//   of tile t, so the tensor cores work through the softmax. O leaves
//   through shared memory in the swizzled layout by one TMA store a warp,
//   and the LSE goes back to natural log. K/V tiles hold 128 keys, 64 at
//   hd = 128, where 128-key S, P and O do not fit the registers together;
//   there a causal work's last tile lies past the first warpgroup's rows,
//   and that warpgroup only releases it, and O is rescaled only when a
//   row's max grows by more than 2^8.
//   q, k, v and o are read and written through 4-D (hd, heads, S, B)
//   tensor maps of their strided layouts, encoded on the host per call with
//   the 128-, 64- or 32-byte swizzle of a 64-, 32- or 16-column box (hd =
//   128 is two boxes); TMA's zero fill masks the rows past Sq and Sk, and
//   its stores skip them. cuTensorMapEncodeTiled comes from the driver
//   through cudaGetDriverEntryPointByVersion, so the library needs no
//   -lcuda. hd = 112 (kimi-k2) runs the hd = 128 instance on maps whose
//   dimension 0 is 112: TMA zero-fills columns 112..127 of Q, K and V in
//   shared memory and leaves them out of O's store (hopper.cuh, Box), so
//   it has the 128 instance's 64-key tiles, registers and lazy rescaling.
// * float32: one block per (b, h, 64-row q tile) loops over the K/V tiles
//   with m, l and the accumulator in registers, the products on the CUDA
//   cores over 64-row K/V tiles staged in shared memory, each thread
//   owning 4 rows by hd / 8 columns of the accumulator.

#include "hopper.cuh"

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
// bfloat16 body: TMA into an mbarrier ring, wgmma for both products
// ---------------------------------------------------------------------------

namespace hopper {

// B1's tiles, on the box layout of hopper.cuh
template <int HD>
struct Cfg : Box<HD> {
  // keys of a K/V tile: at hd = 128 a 128-key tile's S, P and O do not
  // fit the consumers' registers beside each other
  static constexpr int BN = HD == 128 ? 64 : 128;
  // where rescaling O (hd / 2 multiplies a thread a tile) outweighs the
  // tile's softmax (BN / 2 scores), O is rescaled only when a row's max
  // grows by more than 8 in log2 units; elsewhere the check costs more
  // than it saves
  static constexpr bool LAZY = HD > BN;
  static constexpr int Q_BYTES = BLOCK_M * HD * 2;
  static constexpr int KV_BYTES = BN * HD * 2;  // one K or V tile
  static constexpr int TILES = 2 * Q_BYTES + 2 * STAGES * KV_BYTES;  // Q O K V
  static constexpr int SMEM = 1024 + TILES + 1024;   // alignment, barriers
};

struct Barriers {
  uint64_t q_full, q_empty;
  uint64_t k_full[STAGES], k_empty[STAGES];
  uint64_t v_full[STAGES], v_empty[STAGES];
};

// Online softmax of one tile on the accumulator, in log2 units. Element i
// sits at row r_lo + 8 * ((i >> 1) & 1), key k0 + 8 * (i >> 2) + 2 * t +
// (i & 1); MASK sets the keys the row does not see to -inf. With a
// positive scale (FAST) the max is taken of the raw scores and
// P = 2^(s * sl2 - m) costs one FFMA and one ex2 an element; any other
// scale takes s * sl2 first. With LAZY the running max stays while the
// tile's exceeds it by 8 or less: P stays below 2^8, and O / l and the
// LSE do not depend on which max was subtracted. Leaves P (float32) in
// sc, the running max m and sum l, and O's rescaling in corr.
template <int BN, bool LAZY, bool MASK, bool FAST>
__device__ __forceinline__ void softmax_tile(float (&sc)[BN / 2],
                                             float (&m)[2], float (&l)[2],
                                             float (&corr)[2], float sl2,
                                             int k0, int r_lo, int t, int Sk,
                                             int causal) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    if (!FAST) sc[i] *= sl2;
    if (MASK) {
      const int col = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
      const int row = r_lo + 8 * ((i >> 1) & 1);
      if (col >= Sk || (causal && col > row)) sc[i] = -INFINITY;
    }
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
  }
  float mu[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    // the 4 threads t = 0..3 of a row group share its rows
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float tile_max = FAST ? mx[r] * sl2 : mx[r];
    if (LAZY && m[r] != -INFINITY && tile_max <= m[r] + 8.f) {
      mu[r] = m[r];
      corr[r] = 1.f;
      continue;
    }
    const float m_new = fmaxf(m[r], tile_max);
    mu[r] = m_new == -INFINITY ? 0.f : m_new;  // a row with no key yet
    corr[r] = ex2(m[r] - mu[r]);
    m[r] = m_new;
    l[r] *= corr[r];
  }
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    const float x = FAST ? fmaf(sc[i], sl2, -mu[(i >> 1) & 1])
                         : sc[i] - mu[(i >> 1) & 1];
    sc[i] = ex2(x);
    l[(i >> 1) & 1] += sc[i];
  }
}

// The tile of keys from k0: masked only where it crosses Sk or the
// diagonal of the warpgroup's rows (from row0).
template <int BN, bool LAZY>
__device__ __forceinline__ void softmax(float (&sc)[BN / 2], float (&m)[2],
                                        float (&l)[2], float (&corr)[2],
                                        float sl2, int k0, int row0, int r_lo,
                                        int t, int Sk, int causal) {
  const bool mask = k0 + BN > Sk || (causal && k0 + BN - 1 > row0);
  if (sl2 > 0.f) {
    if (mask) softmax_tile<BN, LAZY, true, true>(sc, m, l, corr, sl2, k0, r_lo, t, Sk, causal);
    else softmax_tile<BN, LAZY, false, true>(sc, m, l, corr, sl2, k0, r_lo, t, Sk, causal);
  } else {
    if (mask) softmax_tile<BN, LAZY, true, false>(sc, m, l, corr, sl2, k0, r_lo, t, Sk, causal);
    else softmax_tile<BN, LAZY, false, false>(sc, m, l, corr, sl2, k0, r_lo, t, Sk, causal);
  }
}

// Persistent: each block walks the work tiles w = blockIdx.x, + gridDim.x,
// ... The producer loads a tile's Q as soon as the consumers' last S of
// the tile before has read theirs, and the K/V ring runs on across tiles,
// so one tile's loads overlap the last products and the stores of the one
// before.
template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 const __grid_constant__ CUtensorMap to, const Params p) {
  using C = Cfg<HD>;
  constexpr int CW = C::CW, RB = C::RB;
  extern __shared__ unsigned char smem_raw[];
  // swizzled boxes need 1024-byte alignment
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  bf16* Qs = reinterpret_cast<bf16*>(base);
  bf16* Os = reinterpret_cast<bf16*>(base + C::Q_BYTES);
  bf16* Ks = reinterpret_cast<bf16*>(base + 2 * C::Q_BYTES);
  bf16* Vs = Ks + STAGES * (C::KV_BYTES / 2);
  Barriers* bars = reinterpret_cast<Barriers*>(base + C::TILES);
  const int n_work = (p.Sq + BLOCK_M - 1) / BLOCK_M * p.H * p.B;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    bar_init(&bars->q_full, 1);
    bar_init(&bars->q_empty, 4 * CONSUMERS);  // one arrival a warp
    for (int s = 0; s < STAGES; ++s) {
      bar_init(&bars->k_full[s], 1);
      bar_init(&bars->v_full[s], 1);
      bar_init(&bars->k_empty[s], 4 * CONSUMERS);
      bar_init(&bars->v_empty[s], 4 * CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread keeps Q and the K/V ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      int kv = 0;  // K/V tiles loaded so far: the ring's position
      for (int w = blockIdx.x, n = 0; w < n_work; w += gridDim.x, ++n) {
        const Work<C::BN> wk(w, p.Sq, p.Sk, p.H, p.B, p.causal);
        const int kvh = wk.h / (p.H / p.KV);
        bar_wait(&bars->q_empty, (n & 1) ^ 1);
        bar_expect(&bars->q_full, C::Q_BYTES);
#pragma unroll
        for (int x = 0; x < C::NBOX; ++x)
          tma_load(Qs + x * BLOCK_M * CW, &tq, &bars->q_full, x * CW, wk.h,
                   wk.q0, wk.b);
        for (int it = 0; it < wk.n_tiles; ++it, ++kv) {
          const int s = kv % STAGES;
          const uint32_t ph = (kv / STAGES) & 1;
          bf16* kd = Ks + s * (C::KV_BYTES / 2);
          bf16* vd = Vs + s * (C::KV_BYTES / 2);
          bar_wait(&bars->k_empty[s], ph ^ 1);
          bar_expect(&bars->k_full[s], C::KV_BYTES);
#pragma unroll
          for (int x = 0; x < C::NBOX; ++x)
            tma_load(kd + x * C::BN * CW, &tk, &bars->k_full[s], x * CW, kvh,
                     it * C::BN, wk.b);
          bar_wait(&bars->v_empty[s], ph ^ 1);
          bar_expect(&bars->v_full[s], C::KV_BYTES);
#pragma unroll
          for (int x = 0; x < C::NBOX; ++x)
            tma_load(vd + x * C::BN * CW, &tv, &bars->v_full[s], x * CW, kvh,
                     it * C::BN, wk.b);
        }
      }
    }
  } else {
    // consumers: warpgroup c owns query rows [q0 + 64 c, q0 + 64 c + 64)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int c = wg - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
    const float sl2 = p.scale * LOG2E;  // scores in log2 units
    const uint32_t q_addr = smem_u32(Qs) + c * 64 * RB;
    const uint32_t k_base = smem_u32(Ks), v_base = smem_u32(Vs);
    const uint32_t o_addr = smem_u32(Os);
    int kv = 0;  // K/V tiles consumed so far
    for (int w = blockIdx.x, n = 0; w < n_work; w += gridDim.x, ++n) {
      const Work<C::BN> wk(w, p.Sq, p.Sk, p.H, p.B, p.causal);
      const int row0 = wk.q0 + c * 64;
      const int r_lo = row0 + warp * 16 + g;  // this thread's rows: r_lo, r_lo + 8
      // the tiles with a key that these rows see; the work's other tiles
      // (causal, 64-key tiles: the first warpgroup's last) are only released
      const int n_mine = p.causal
          ? min(wk.n_tiles, (row0 + 64 + C::BN - 1) / C::BN) : wk.n_tiles;
      float o[HD / 2];
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, corr[2];
      float sc[C::BN / 2];
      uint32_t pa[C::BN / 16][4];

      // Tile it's S is issued together with tile it-1's P V, so that the
      // tensor cores also work through this warpgroup's own softmax. P is
      // carried from one step to the next in float32 (sc, the accumulator's
      // own registers) and rounded to bf16 fragments just before its P V.
      bar_wait(&bars->q_full, n & 1);
      {
        const int s = kv % STAGES;
        bar_wait(&bars->k_full[s], (kv / STAGES) & 1);
        wgmma_fence();
        issue_ss<HD, C::BN>(sc, q_addr, k_base + s * C::KV_BYTES);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);
        if (lane == 0) {
          bar_arrive(&bars->k_empty[s]);
          if (n_mine == 1) bar_arrive(&bars->q_empty);
        }
        softmax<C::BN, C::LAZY>(sc, m, l, corr, sl2, 0, row0, r_lo, t, p.Sk, p.causal);
      }
      for (int it = 1; it < n_mine; ++it) {
        const int s = (kv + it) % STAGES, sp = (kv + it - 1) % STAGES;
        to_bf16<C::BN>(sc, pa);
        bar_wait(&bars->k_full[s], ((kv + it) / STAGES) & 1);
        bar_wait(&bars->v_full[sp], ((kv + it - 1) / STAGES) & 1);
        wgmma_fence();
        issue_ss<HD, C::BN>(sc, q_addr, k_base + s * C::KV_BYTES);
        wgmma_commit();
        issue_rs<HD, C::BN>(o, pa, v_base + sp * C::KV_BYTES);
        wgmma_commit();
        wgmma_wait<1>();  // S of tile it
        fence_regs(sc);
        if (lane == 0) {
          bar_arrive(&bars->k_empty[s]);
          if (it == n_mine - 1) bar_arrive(&bars->q_empty);
        }
        softmax<C::BN, C::LAZY>(sc, m, l, corr, sl2, it * C::BN, row0, r_lo, t, p.Sk,
                p.causal);
        wgmma_wait<0>();  // P V of tile it - 1
        fence_regs(o);
        fence_regs(pa);
        if (lane == 0) bar_arrive(&bars->v_empty[sp]);
        if (!C::LAZY || __any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
          for (int i = 0; i < HD / 2; ++i) o[i] *= corr[(i >> 1) & 1];
        }
      }
      {
        const int sp = (kv + n_mine - 1) % STAGES;
        to_bf16<C::BN>(sc, pa);
        bar_wait(&bars->v_full[sp], ((kv + n_mine - 1) / STAGES) & 1);
        wgmma_fence();
        issue_rs<HD, C::BN>(o, pa, v_base + sp * C::KV_BYTES);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(pa);
        if (lane == 0) bar_arrive(&bars->v_empty[sp]);
      }
      // a stage is released once its tile has arrived, never before
      if (lane == 0)
        for (int it = kv + n_mine; it < kv + wk.n_tiles; ++it) {
          bar_wait(&bars->k_full[it % STAGES], (it / STAGES) & 1);
          bar_arrive(&bars->k_empty[it % STAGES]);
          bar_wait(&bars->v_full[it % STAGES], (it / STAGES) & 1);
          bar_arrive(&bars->v_empty[it % STAGES]);
        }
      kv += wk.n_tiles;

      float inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        const float ls = fmaxf(l[r], 1e-30f);
        inv[r] = 1.f / ls;
        const int row = r_lo + 8 * r;
        if (t == 0 && row < p.Sq)
          p.lse[((long long)wk.b * p.H + wk.h) * p.Sq + row] =
              (m[r] + log2f(ls)) * LN2;
      }
      // O goes out through this warp's 16 rows of the O tile, in the
      // swizzled layout the O map names, by one TMA store a box that writes
      // only the rows below Sq. The warp's store before must have read them.
      if (lane == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      __syncwarp();
      stage_rows<HD>(o_addr, o, inv, c * 64 + warp * 16, g, t);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncwarp();
      if (lane == 0) {
        store_rows<HD>(&to, Os, c * 64 + warp * 16, wk.h, row0 + warp * 16, wk.b);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
    }
    if (lane == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// HD is the tile width; `hd` (<= HD) the tensors' head dim, the maps'
// dimension 0, past which TMA reads zeros and writes nothing
template <int HD>
cudaError_t launch(const Params& p, cudaStream_t stream, int hd = HD) {
  CUtensorMap tq, tk, tv, to;
  if (!tensor_map<HD>(&tq, p.q, p.H, p.Sq, p.B, p.q_sh, p.q_ss, p.q_sb, BLOCK_M, hd)
      || !tensor_map<HD>(&tk, p.k, p.KV, p.Sk, p.B, p.k_sh, p.k_ss, p.k_sb, Cfg<HD>::BN, hd)
      || !tensor_map<HD>(&tv, p.v, p.KV, p.Sk, p.B, p.v_sh, p.v_ss, p.v_sb, Cfg<HD>::BN, hd)
      || !tensor_map<HD>(&to, p.o, p.H, p.Sq, p.B, p.o_sh, p.o_ss, p.o_sb, 16, hd))
    return cudaErrorInvalidValue;
  int grid;
  const cudaError_t err = persistent_grid(
      flash_fwd_kernel<HD>, Cfg<HD>::SMEM,
      (long long)((p.Sq + BLOCK_M - 1) / BLOCK_M) * p.H * p.B, &grid);
  if (err != cudaSuccess) return err;
  flash_fwd_kernel<HD><<<grid, THREADS, Cfg<HD>::SMEM, stream>>>(tq, tk, tv, to, p);
  return cudaGetLastError();
}

}  // namespace hopper

cudaError_t dispatch(const Params& p, int dtype, int hd, cudaStream_t st) {
  if (dtype == 0) {
    switch (hd) {
      case 16: return simt::launch<16>(p, st);
      case 32: return simt::launch<32>(p, st);
      case 64: return simt::launch<64>(p, st);
      case 112: return simt::launch<112>(p, st);
      case 128: return simt::launch<128>(p, st);
    }
  } else if (dtype == 1) {
    switch (hd) {
      case 16: return hopper::launch<16>(p, st);
      case 32: return hopper::launch<32>(p, st);
      case 64: return hopper::launch<64>(p, st);
      case 112: return hopper::launch<128>(p, st, 112);  // 128-column tiles
      case 128: return hopper::launch<128>(p, st);
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. The bfloat16 body reads q, k and v
// and writes o by TMA: each must be 16-byte aligned with strides that are
// multiples of 8 elements. Returns a cudaError_t (0 on success);
// cudaErrorInvalidValue also when a tensor map cannot be encoded.
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

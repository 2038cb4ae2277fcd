// Flash-attention forward for Hopper: GQA, causal flag, runtime sliding
// window, logit softcap, Sq queries over Sk keys; returns o and the fp32
// log-sum-exp.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention.py::flash_attention_fwd (_fa_kernel).
// The Pallas kernel walks the k dimension as a sequential grid axis with
// the softmax state in VMEM scratch.  Blocks on the card run in parallel
// and in no order, so here a block loops over the key tiles itself with
// the online-softmax state (row max, row sum, output accumulator) in
// registers in fp32.  The KV head of q head h is h * Hkv / Hq, so GQA
// never repeats K/V in memory.  Key tiles wholly outside the causal
// triangle or the window are skipped, and the q tiles with the most live
// key tiles are scheduled first.
//
// Cross-attention (Whisper's decoder over 1500 encoder frames) has Sq !=
// Sk: as in the reference, q holds the last Sq of the Sk positions, so
// query i sits at position i + Sk - Sq and the causal mask and the window
// measure from there (a causal mask needs Sq <= Sk, which the wrapper
// checks).  Q, O and the lse are laid out over Sq rows, K and V over Sk.
//
// Bound, at the served prefill shapes (batch 8, 1024 keys, causal):
// operations at head_dim 64 (TinyLlama, 32 q / 4 kv heads) and 128
// (Qwen3-MoE, 64 / 4): the products do ~4·d flops per (query, key) pair
// against K/V read once per group of q heads; bytes at Zamba2's 112 with
// one kv head per q head (MHA), where q, k, v and o are read or written
// once each and the products are smaller than their traffic.
//
// bfloat16 runs on the tensor cores, on what Hopper adds for them:
// - wgmma: S = Q K^T (m64 x BK, both operands in shared memory) and
//   O += P V (m64 x N, P from registers as the A operand, V read
//   MN-major), fp32 accumulators; P is rounded to bf16 between them, as
//   the reference rounds p.astype(v.dtype).
// - TMA: Q, K and V come as 128-byte-swizzled 64-column boxes of a
//   (B*H, S, d) tensor map; rows past S and columns past d arrive as
//   zeros, so any S and any d need no masked load.  One producer thread
//   keeps them in flight through a ring of mbarrier-guarded stages, and
//   setmaxnreg gives its warpgroup's registers to the two consumer
//   warpgroups (64 q rows each).
// - A persistent grid of one block per SM walks the (q tile, head, batch)
//   items, so one item's loads run under the previous item's work.
// - The softmax works on the accumulator fragments: the mask and softcap
//   branch once a tile (masks only on tiles that cross the diagonal, the
//   window edge or S), masked scores are -inf, the scale is folded into
//   one FMA before ex2, and a row's max and sum take two quad shuffles.
// Stored widths D are 64, 128 and 256 (narrower head dims run at 64);
// Zamba2's 112 runs its products at 112.
//
// float32 runs on the FMA pipes (no TF32), so the card-vs-CPU checks hold
// the same arithmetic: one block of 128 threads owns a (batch, head,
// 64-row q tile) and loops over 64-key tiles staged in shared memory;
// each thread computes a 4x8 register tile of scores and a 4x(D/8) tile
// of the output from 16-byte shared-memory vectors, K and Q stored
// transposed.  Its widths are 16, 32, 64, 128 and 256; at 256 its tiles
// take 222,208 B of shared memory, under the 232,448 B a block may use.
//
// Masking matches the Pallas kernel: a masked score adds nothing, and a
// row whose sum stays 0 gives o = 0 and lse = NEG_INF (-1e30).  Rows and
// keys past S (the ragged edge) are masked, so any S works.  Any head_dim
// d <= 256 that is a multiple of 8 works: zeros past d add nothing to q.k
// and give zero output columns, and stores stop at d.
#include <cmath>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kBQ = 64;        // q rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 128;  // 16 row groups x 8 column lanes
constexpr int kLd = 68;        // row stride of the transposed tiles (floats)
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  int hq, hkv, sq, sk, d, window, causal;
  float softcap, scale;
};

template <int D>
constexpr size_t smem_bytes() {
  // Qs[D][kLd] + Ks[D][kLd] + Vs[kBK][D] + Pt[kBK][kLd]
  return sizeof(float) * (2 * D * kLd + kBK * D + kBK * kLd);
}

// Rows [r0, r0 + 64) of a row-major (S, d) matrix into dst[c * kLd + r]
// (transposed) for columns c < D, zero past S and past d.  Consecutive
// threads take consecutive rows, so the transposed shared-memory stores do
// not conflict.
template <int D>
__device__ __forceinline__ void load_transposed(const float* __restrict__ src,
                                                int r0, int s, int d,
                                                float* dst) {
  for (int idx = threadIdx.x; idx < 64 * (D / 4); idx += kThreads) {
    const int r = idx % 64, c = 4 * (idx / 64);
    const float4 f =
        r0 + r < s && c < d
            ? *reinterpret_cast<const float4*>(
                  src + static_cast<size_t>(r0 + r) * d + c)
            : make_float4(0.f, 0.f, 0.f, 0.f);
    dst[c * kLd + r] = f.x;
    dst[(c + 1) * kLd + r] = f.y;
    dst[(c + 2) * kLd + r] = f.z;
    dst[(c + 3) * kLd + r] = f.w;
  }
}

// Rows [r0, r0 + 64) of a row-major (S, d) matrix into dst[r * D + c]
// for columns c < D, zero past S and past d.  Consecutive threads take
// consecutive 16-byte chunks.
template <int D>
__device__ __forceinline__ void load_rows(const float* __restrict__ src,
                                          int r0, int s, int d, float* dst) {
  for (int idx = threadIdx.x; idx < 64 * (D / 4); idx += kThreads) {
    const int r = idx / (D / 4), c = 4 * (idx % (D / 4));
    *reinterpret_cast<float4*>(&dst[r * D + c]) =
        r0 + r < s && c < d
            ? *reinterpret_cast<const float4*>(
                  src + static_cast<size_t>(r0 + r) * d + c)
            : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// Column of score j (0..7) owned by column lane tx: two runs of four.
__device__ __forceinline__ int score_col(int tx, int j) {
  return 32 * (j / 4) + tx * 4 + (j % 4);
}

// Column of output element j (0..D/8-1) owned by column lane tx.
template <int D>
__device__ __forceinline__ int out_col(int tx, int j) {
  constexpr int kDc = D / 8;
  if constexpr (kDc >= 4) {
    return 32 * (j / 4) + tx * 4 + (j % 4);
  } else {
    return tx * kDc + j;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
fa_fwd_kernel(Args a) {
  constexpr int kDc = D / 8;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + D * kLd;
  float* Vs = Ks + D * kLd;
  float* Pt = Vs + kBK * D;

  const int tid = threadIdx.x;
  const int tx = tid % 8;   // column lane: 8 lanes of a warp share 4 rows
  const int ty = tid / 8;   // row group: rows ty*4 .. ty*4+3 of the tile
  const int sq = a.sq, sk = a.sk, d = a.d;
  const int off = sk - sq;   // the position of query row 0
  const int n_qt = (sq + kBQ - 1) / kBQ;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x);
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h * a.hkv / a.hq;
  const int q0 = qt * kBQ;

  const float* Q = static_cast<const float*>(a.q) +
                   static_cast<size_t>(b * a.hq + h) * sq * d;
  const float* K = static_cast<const float*>(a.k) +
                   static_cast<size_t>(b * a.hkv + hk) * sk * d;
  const float* V = static_cast<const float*>(a.v) +
                   static_cast<size_t>(b * a.hkv + hk) * sk * d;
  float* O =
      static_cast<float*>(a.o) + static_cast<size_t>(b * a.hq + h) * sq * d;
  float* L = a.lse + static_cast<size_t>(b * a.hq + h) * sq;

  load_transposed<D>(Q, q0, sq, d, Qs);

  // Live key tiles: keys c with pos - c < window for some position pos >=
  // q0 + off, and (causal) c <= the tile's last position, which is < Sk
  // as Sq <= Sk there.  window >= 1 (wrapper), so never empty.
  const int last_pos = min(q0 + kBQ - 1, sq - 1) + off;
  const int kt_end = (a.causal ? last_pos : sk - 1) / kBK;
  const int lo = q0 + off - a.window + 1;
  const int kt_begin = lo > 0 ? lo / kBK : 0;

  float m[4], l[4], acc[4][kDc];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kDc; ++j) acc[i][j] = 0.f;
  }

  for (int kt = kt_begin; kt <= kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile is no longer read
    load_transposed<D>(K, k0, sk, d, Ks);
    load_rows<D>(V, k0, sk, d, Vs);
    __syncthreads();

    // scores: 4 rows x 8 keys per thread
    float sc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) sc[i][j] = 0.f;
#pragma unroll 16
    for (int c = 0; c < D; ++c) {
      const float4 qv = *reinterpret_cast<const float4*>(&Qs[c * kLd + ty * 4]);
      const float4 ka = *reinterpret_cast<const float4*>(&Ks[c * kLd + tx * 4]);
      const float4 kb =
          *reinterpret_cast<const float4*>(&Ks[c * kLd + 32 + tx * 4]);
      const float qr[4] = {qv.x, qv.y, qv.z, qv.w};
      const float kr[8] = {ka.x, ka.y, ka.z, ka.w, kb.x, kb.y, kb.z, kb.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) sc[i][j] = fmaf(qr[i], kr[j], sc[i][j]);
    }

    // scale, softcap, mask; the softmax runs in base 2 (scores * log2 e)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty * 4 + i + off;   // the query's position
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = k0 + score_col(tx, j);
        float x = sc[i][j] * a.scale;
        if (a.softcap > 0.f) x = a.softcap * tanhf(x / a.softcap);
        const bool live =
            c < sk && (r - c) < a.window && (!a.causal || c <= r);
        sc[i][j] = live ? x * kLog2e : kNegInf;
        mx = fmaxf(mx, sc[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = exp2f(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = sc[i][j] == kNegInf ? 0.f : exp2f(sc[i][j] - m_new);
        sc[i][j] = p;
        psum += p;
      }
      // l is a per-lane partial sum; the row's 8 lanes share m and alpha
      l[i] = l[i] * alpha + psum;
#pragma unroll
      for (int j = 0; j < kDc; ++j) acc[i][j] *= alpha;
      m[i] = m_new;
    }

    // P, transposed, for the PV product
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      *reinterpret_cast<float4*>(&Pt[score_col(tx, j) * kLd + ty * 4]) =
          make_float4(sc[0][j], sc[1][j], sc[2][j], sc[3][j]);
    }
    __syncthreads();

#pragma unroll 8
    for (int c = 0; c < kBK; ++c) {
      const float4 pv = *reinterpret_cast<const float4*>(&Pt[c * kLd + ty * 4]);
      const float pr[4] = {pv.x, pv.y, pv.z, pv.w};
      if constexpr (kDc >= 4) {
        // one float4 of V at a time: at D = 256 no row of V is held in
        // registers beside the 4 x 32 accumulators
#pragma unroll
        for (int g = 0; g < kDc / 4; ++g) {
          const float4 vv =
              *reinterpret_cast<const float4*>(&Vs[c * D + 32 * g + tx * 4]);
          const float vr[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[i][4 * g + j] = fmaf(pr[i], vr[j], acc[i][4 * g + j]);
        }
      } else {
        const float2 vv = *reinterpret_cast<const float2*>(&Vs[c * D + tx * 2]);
        const float vr[2] = {vv.x, vv.y};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) acc[i][j] = fmaf(pr[i], vr[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float lt = l[i];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    lt += __shfl_xor_sync(0xffffffffu, lt, 4);
    const int r = q0 + ty * 4 + i;
    if (r < sq) {
      const float inv = 1.f / (lt == 0.f ? 1.f : lt);
#pragma unroll
      for (int j = 0; j < kDc; ++j) {
        const int col = out_col<D>(tx, j);
        if (col < d) {
          O[static_cast<size_t>(r) * d + col] = acc[i][j] * inv;
        }
      }
      if (tx == 0) L[r] = lt == 0.f ? kNegInf : m[i] * kLn2 + logf(lt);
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16: the online softmax on accumulator fragments
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;
using repro::pack_bf16;

// 2^x on the special-function unit; results below 2^-126 flush to 0.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The online softmax of one lane's two rows of a score tile held in the
// m16n8 accumulator layout: register 4j + e holds the query at position
// pos0 + 8 (e / 2), key k0 + 8j + 2t + e % 2.  Masked scores are -inf, and
// a row with no live key yet subtracts 0, so no element needs a test of its
// own.  The branches on softcap and on the mask are taken once a tile.
struct RowSoftmax {
  bool softcap;
  float cap_in;    // scale / softcap
  float f;         // logits -> base-2 exponents
  float m[2] = {-INFINITY, -INFINITY};   // running max of the logits
  float l[2] = {0.f, 0.f};               // this lane's part of the sums

  __device__ explicit RowSoftmax(const Args& a)
      : softcap(a.softcap > 0.f),
        cap_in(a.scale / (a.softcap > 0.f ? a.softcap : 1.f)),
        f(a.softcap > 0.f ? kLog2e : a.scale * kLog2e) {}

  // Scores -> P in place; alpha: the factor the output rows are rescaled by.
  template <int N>
  __device__ __forceinline__ void step(float (&sc)[N], float (&alpha)[2],
                                       const Args& a, bool masked, int pos0,
                                       int k0, int t) {
    if (softcap) {
#pragma unroll
      for (int j = 0; j < N; ++j) sc[j] = a.softcap * tanhf(sc[j] * cap_in);
    }
    if (masked) {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const int r = pos0 + ((j / 2) % 2) * 8;
        const int c = k0 + 8 * (j / 4) + 2 * t + (j % 2);
        const bool live =
            c < a.sk && (r - c) < a.window && (!a.causal || c <= r);
        sc[j] = live ? sc[j] : -INFINITY;
      }
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < N; ++j) mx[(j / 2) % 2] = fmaxf(mx[(j / 2) % 2], sc[j]);
    float neg_mu[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float mu = mx[r] == -INFINITY ? 0.f : mx[r] * f;
      alpha[r] = ex2(m[r] * f - mu);
      neg_mu[r] = -mu;
      m[r] = mx[r];
    }
    float ps[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < N; ++j) {
      sc[j] = ex2(fmaf(sc[j], f, neg_mu[(j / 2) % 2]));
      ps[(j / 2) % 2] += sc[j];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + ps[r];
  }

  // Sum the row sums over the row's four lanes; the lse of row r (NEG_INF
  // where no key was live), and the factor that normalises its output.
  __device__ __forceinline__ void finish(float (&lse)[2], float (&inv)[2]) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lt = l[r];
      lt += __shfl_xor_sync(0xffffffffu, lt, 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      lse[r] = lt == 0.f ? kNegInf : m[r] * f * kLn2 + logf(lt);
      inv[r] = 1.f / (lt == 0.f ? 1.f : lt);
    }
  }
};

// ---------------------------------------------------------------------------
// bfloat16: wgmma + TMA
// ---------------------------------------------------------------------------
// A persistent grid, one block of three warpgroups on each SM, walks the
// (q tile of 128 rows, head, batch) items in groups of heads whose K and
// V fit in L2 together, heaviest q tile first within a group.  Two consumer
// warpgroups own 64 rows each; one thread of the producer warpgroup keeps
// the TMA loads in flight: each item's Q, and its live K and V tiles
// through a ring of kStages stages that runs on across items, so the next
// item's tiles load while this one finishes.  D (64, 128 or 256) is the
// width the tiles are stored at, zeros past d; N <= D the width of the
// output product (112 for Zamba2's head_dim: no padded columns); BK keys
// a tile.
template <int D>
struct WgTile {
  static constexpr int kBK = D <= 128 ? 128 : 64;   // 256: registers
  static constexpr int kStages = 2;
  static constexpr int kSlabs = D / 64;             // 64-column slabs
  static constexpr int kQBytes = 2 * 64 * D * 2;    // both warpgroups' rows
  static constexpr int kKVBytes = kBK * D * 2;      // one K or V tile
  static constexpr int kThreads = 3 * 128;
  // setmaxnreg: what the producer warpgroup keeps and the consumers take;
  // the block's pool (168 a thread at 384 threads) holds exactly both
  static constexpr int kProducerRegs = 40;
  static constexpr int kConsumerRegs = 232;
  static constexpr size_t kSmemBytes =
      1024 + kQBytes + 2 * kStages * kKVBytes + 64 * 8;
};

struct Maps {
  CUtensorMap q, k, v;   // (d, S, B*H) bf16, 128-byte swizzled boxes
};

// Work item w: the (batch, head) pairs, head fastest, cut into groups of
// ``group``; within a group the q tile (heaviest, i.e. last, first, under
// a causal mask; without one every q tile has the same live key tiles),
// then the pair.  n_qt counts Sq's tiles.  A group's items share its K and
// V tiles through L2.
struct Item {
  int qt, h, b;
};

__device__ __forceinline__ Item item(int w, int n_qt, int hq, int n_bh,
                                     int group) {
  const int k = w / (n_qt * group), r = w % (n_qt * group);
  const int g0 = k * group, size = min(group, n_bh - g0);
  const int bh = g0 + r % size;
  return {n_qt - 1 - r / size, bh % hq, bh / hq};
}

// Live key tiles of the q rows [q0, q0 + 128), at positions from q0 +
// Sk - Sq: keys c with pos - c < window for some position >= the first and
// (causal, Sq <= Sk) c <= the last position; never empty.
template <int BK>
__device__ __forceinline__ void live_tiles(const Args& a, int q0, int& begin,
                                           int& end) {
  const int off = a.sk - a.sq;
  const int last_pos = min(q0 + 127, a.sq - 1) + off;
  end = (a.causal ? last_pos : a.sk - 1) / BK;
  const int lo = q0 + off - a.window + 1;
  begin = lo > 0 ? lo / BK : 0;
}

template <int D, int N>
__global__ void __launch_bounds__(WgTile<D>::kThreads, 1)
fa_wgmma_kernel(const __grid_constant__ Maps maps, Args a, int nb,
                int group) {
  using P = WgTile<D>;
  constexpr int kBK = P::kBK;
  constexpr int kSt = P::kStages;
  extern __shared__ unsigned char smem_raw[];
  // 128-byte swizzled tiles want 1024-byte aligned atoms
  unsigned char* base =
      smem_raw + ((1024 - (repro::smem_u32(smem_raw) & 1023)) & 1023);
  bf16* Qs = reinterpret_cast<bf16*>(base);
  bf16* Ks = reinterpret_cast<bf16*>(base + P::kQBytes);
  bf16* Vs = reinterpret_cast<bf16*>(base + P::kQBytes + kSt * P::kKVBytes);
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + P::kQBytes +
                                               2 * kSt * P::kKVBytes);
  uint64_t* q_full = bars;
  uint64_t* q_empty = bars + 1;
  uint64_t* k_full = bars + 2;
  uint64_t* v_full = k_full + kSt;
  uint64_t* kv_empty = v_full + kSt;

  const int n_qt = (a.sq + 127) / 128;
  const int n_items = n_qt * a.hq * nb;

  if (threadIdx.x == 0) {
    repro::mbar_init(q_full, 1);
    repro::mbar_init(q_empty, 256);
    for (int i = 0; i < kSt; ++i) {
      repro::mbar_init(k_full + i, 1);
      repro::mbar_init(v_full + i, 1);
      repro::mbar_init(kv_empty + i, 256);
    }
    repro::mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // producer: registers go to the consumers; one thread issues the loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        P::kProducerRegs));
    if (threadIdx.x == 256) {
      int it = 0;   // K/V tiles issued so far: ring stage and round
      int n = 0;    // items started so far
      for (int w = blockIdx.x; w < n_items; w += gridDim.x, ++n) {
        const Item job = item(w, n_qt, a.hq, nb * a.hq, group);
        const int q0 = job.qt * 128;
        const int bq = job.b * a.hq + job.h;
        const int bk = job.b * a.hkv + job.h * a.hkv / a.hq;
        int kt_begin, kt_end;
        live_tiles<kBK>(a, q0, kt_begin, kt_end);
        if (n > 0) repro::mbar_wait(q_empty, (n - 1) & 1);
        repro::mbar_expect_tx(q_full, P::kQBytes);
        for (int g = 0; g < 2; ++g)
          for (int c = 0; c < P::kSlabs; ++c)
            repro::tma_load_3d(Qs + (g * P::kSlabs + c) * 64 * 64, &maps.q,
                               q_full, c * 64, q0 + 64 * g, bq);
        for (int kt = kt_begin; kt <= kt_end; ++kt, ++it) {
          const int st = it % kSt, round = it / kSt;
          if (round > 0) repro::mbar_wait(kv_empty + st, (round - 1) & 1);
          repro::mbar_expect_tx(k_full + st, P::kKVBytes);
          for (int c = 0; c < P::kSlabs; ++c)
            repro::tma_load_3d(Ks + (st * P::kSlabs + c) * kBK * 64, &maps.k,
                               k_full + st, c * 64, kt * kBK, bk);
          repro::mbar_expect_tx(v_full + st, P::kKVBytes);
          for (int c = 0; c < P::kSlabs; ++c)
            repro::tma_load_3d(Vs + (st * P::kSlabs + c) * kBK * 64, &maps.v,
                               v_full + st, c * 64, kt * kBK, bk);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        P::kConsumerRegs));
    // consumers: warpgroup wg owns rows q0 + 64 wg .. + 63 of each item
    const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
    const int g = lane / 4, t = lane % 4;
    const bf16* Qw = Qs + wg * P::kSlabs * 64 * 64;
    int it = 0, n = 0;
    for (int w = blockIdx.x; w < n_items; w += gridDim.x, ++n) {
      const Item job = item(w, n_qt, a.hq, nb * a.hq, group);
      const int qw0 = job.qt * 128 + 64 * wg;
      const int row0 = qw0 + warp * 16 + g;   // this lane's rows: +0, +8
      const int pos_w0 = qw0 + a.sk - a.sq;   // position of row qw0
      int kt_begin, kt_end;
      live_tiles<kBK>(a, job.qt * 128, kt_begin, kt_end);

      RowSoftmax sm(a);
      float o[N / 2];
#pragma unroll
      for (int j = 0; j < N / 2; ++j) o[j] = 0.f;

      repro::mbar_wait(q_full, n & 1);
      for (int kt = kt_begin; kt <= kt_end; ++kt, ++it) {
        const int st = it % kSt, parity = (it / kSt) & 1;
        const int k0 = kt * kBK;
        const bf16* Kt = Ks + st * P::kSlabs * kBK * 64;
        const bf16* Vt = Vs + st * P::kSlabs * kBK * 64;

        // S = Q K^T (K-major A and B; 16-deep steps 32 B apart in a row,
        // none past N: columns past d are zeros)
        float sc[kBK / 2];
        repro::mbar_wait(k_full + st, parity);
        repro::wgmma_fence();
#pragma unroll
        for (int kq = 0; kq < N / 16; ++kq) {
          const int c = kq / 4, off = (kq % 4) * 16;
          repro::wgmma_ss<kBK>(
              sc, repro::wgmma_desc(Qw + c * 64 * 64 + off, 16, 1024),
              repro::wgmma_desc(Kt + c * kBK * 64 + off, 16, 1024), kq > 0);
        }
        repro::wgmma_commit();
        repro::wgmma_wait<0>();
#pragma unroll
        for (int j = 0; j < kBK / 2; ++j) repro::fence_reg(sc[j]);
        if (kt == kt_end) repro::mbar_arrive(q_empty);   // Q is read

        // the mask only on tiles that cross the diagonal, the window edge
        // or Sk
        const bool masked = k0 + kBK > a.sk ||
                            (a.causal && k0 + kBK - 1 > pos_w0) ||
                            pos_w0 + 63 - k0 >= a.window;
        float alpha[2];
        sm.step(sc, alpha, a, masked, row0 + a.sk - a.sq, k0, t);
#pragma unroll
        for (int j = 0; j < N / 2; ++j) {
          o[j] *= alpha[(j / 2) % 2];
          repro::fence_reg(o[j]);
        }
        // P as bf16 A fragments (the reference's p.astype(v.dtype)), all
        // written before the fence that lets wgmma read them
        uint32_t pa[kBK / 16][4];
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
            repro::fence_reg(pa[kk][r]);
          }

        // O += P V: V MN-major, 8-key groups 1024 B apart, 64-column
        // slabs kBK * 128 B apart
        repro::mbar_wait(v_full + st, parity);
        repro::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          repro::wgmma_rs<N>(
              o, pa[kk], repro::wgmma_desc(Vt + kk * 16 * 64, kBK * 128, 1024),
              1);
        }
        repro::wgmma_commit();
        repro::wgmma_wait<0>();
#pragma unroll
        for (int j = 0; j < N / 2; ++j) repro::fence_reg(o[j]);
        repro::mbar_arrive(kv_empty + st);
      }

      const size_t bq = static_cast<size_t>(job.b) * a.hq + job.h;
      bf16* O = static_cast<bf16*>(a.o) + bq * a.sq * a.d;
      float* L = a.lse + bq * a.sq;
      float lse[2], inv[2];
      sm.finish(lse, inv);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        if (row >= a.sq) continue;
#pragma unroll
        for (int j = 0; j < N / 8; ++j) {
          const int col = 8 * j + 2 * t;
          if (col < a.d) {   // d is a multiple of 8: col + 1 < d too
            *reinterpret_cast<uint32_t*>(O + static_cast<size_t>(row) * a.d +
                                         col) =
                pack_bf16(o[4 * j + 2 * r] * inv[r],
                          o[4 * j + 2 * r + 1] * inv[r]);
          }
        }
        if (t == 0) L[row] = lse[r];
      }
    }
  }
}

// A (B*H, S, d) bf16 tensor as boxes of 64 columns x ``rows`` rows, read
// with the 128-byte swizzle; rows past S and columns past d read zeros (Q
// is mapped over Sq rows, K and V over Sk: each map its own S).
bool encode_map(CUtensorMap* map, const void* ptr, int bh, int s, int d,
                int rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(s) * d * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(rows), 1};
  return repro::encode_bf16_map(map, ptr, 3, dims, strides, box);
}

using repro::current_device;
using repro::once_per_device;

template <int D, int N = D>
int launch_wgmma(const Args& a, int b, cudaStream_t stream) {
  using P = WgTile<D>;
  int dev = 0;
  int err = current_device(&dev);
  if (err) return err;
  err = once_per_device(dev, [] {
    // a pool smaller than setmaxnreg asks for would stall the consumers
    // for ever: refuse the launch instead
    cudaFuncAttributes attr;
    cudaError_t e = cudaFuncGetAttributes(&attr, fa_wgmma_kernel<D, N>);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (attr.numRegs * P::kThreads <
        128 * P::kProducerRegs + 256 * P::kConsumerRegs) {
      return static_cast<int>(cudaErrorInvalidConfiguration);
    }
    return static_cast<int>(cudaFuncSetAttribute(
        fa_wgmma_kernel<D, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(P::kSmemBytes)));
  });
  if (err) return err;
  const int n_sm = repro::sm_count(dev);
  if (n_sm <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  Maps maps;
  if (!encode_map(&maps.q, a.q, b * a.hq, a.sq, a.d, 64) ||
      !encode_map(&maps.k, a.k, b * a.hkv, a.sk, a.d, P::kBK) ||
      !encode_map(&maps.v, a.v, b * a.hkv, a.sk, a.d, P::kBK)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long items =
      static_cast<long long>((a.sq + 127) / 128) * a.hq * b;
  const int grid = static_cast<int>(items < n_sm ? items : n_sm);
  // heads per group: their K and V, read once per q tile, take at most
  // half of the 50 MB L2 (GQA heads share theirs)
  const double kv_bytes_per_head = 4.0 * a.sk * a.d * a.hkv / a.hq;
  const double fit = 25e6 / kv_bytes_per_head;
  const int bh = b * a.hq;
  const int group = fit < 1.0 ? 1 : (fit > bh ? bh : static_cast<int>(fit));
  fa_wgmma_kernel<D, N><<<grid, P::kThreads, P::kSmemBytes, stream>>>(
      maps, a, b, group);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(const Args& a, int b, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  int dev = 0;
  int err = current_device(&dev);
  if (err) return err;
  err = once_per_device(dev, [] {
    return static_cast<int>(cudaFuncSetAttribute(
        fa_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem)));
  });
  if (err) return err;
  const dim3 grid((a.sq + kBQ - 1) / kBQ, a.hq, b);
  fa_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The smallest instantiated width that holds head_dim d (a multiple of 8,
// 8 .. 256): float32 on the FMA kernel ...
int launch_fp32(const Args& a, int b, cudaStream_t stream) {
  if (a.d <= 16) return launch<16>(a, b, stream);
  if (a.d <= 32) return launch<32>(a, b, stream);
  if (a.d <= 64) return launch<64>(a, b, stream);
  if (a.d <= 128) return launch<128>(a, b, stream);
  return launch<256>(a, b, stream);
}

// ... bfloat16 on the tensor cores.
int launch_bf16(const Args& a, int b, cudaStream_t stream) {
  if (a.d <= 64) return launch_wgmma<64>(a, b, stream);
  if (a.d <= 96) return launch_wgmma<128>(a, b, stream);
  if (a.d <= 112) return launch_wgmma<128, 112>(a, b, stream);
  if (a.d <= 128) return launch_wgmma<128>(a, b, stream);
  return launch_wgmma<256>(a, b, stream);
}

}  // namespace

// q, o: (B, Hq, Sq, d); k, v: (B, Hkv, Sk, d), contiguous, one dtype,
// d <= 256 a multiple of 8; lse: (B, Hq, Sq) fp32; q at the last Sq of the
// Sk positions, Sq <= Sk if causal.  window >= 1 (pass Sk + 64 for "no
// window").
// Returns the CUDA error of the launch (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, float* lse, int b, int hq, int hkv,
                                   int sq, int sk, int d, int window,
                                   int causal, float softcap, float scale,
                                   int dtype, void* stream) {
  if (b == 0 || hq == 0 || sq == 0) return 0;
  if (d < 8 || d > 256 || d % 8 || sk < 1 || (causal && sq > sk)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{q,  k,  v, o,      lse,    hq,      hkv,
               sq, sk, d, window, causal, softcap, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32) return launch_fp32(a, b, st);
  if (dtype == repro::kBFloat16) return launch_bf16(a, b, st);
  return static_cast<int>(cudaErrorInvalidValue);
}


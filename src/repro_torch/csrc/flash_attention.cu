// Flash-attention forward for Hopper: GQA, causal flag, runtime sliding
// window, logit softcap; returns o and the fp32 log-sum-exp.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention.py::flash_attention_fwd (_fa_kernel).
// The Pallas kernel walks the k dimension as a sequential grid axis with
// the softmax state in VMEM scratch.  Blocks on the card run in parallel
// and in no order, so here one block owns one (batch, head, 64-row q
// tile) and loops over the 64-key tiles itself: the Q tile stays in
// shared memory, K and V tiles are staged through shared memory, and the
// online-softmax state (row max, row sum, output accumulator) lives in
// registers in fp32.  The KV head of q head h is h * Hkv / Hq, so GQA
// never repeats K/V in memory.
//
// Bound: operations.  At the model's shapes (head_dim 64, 1024 keys) the
// two products do ~64 flops per byte of q/k/v, and this first version
// does them on the fp32 FMA pipes, not the tensor cores, so it sits far
// from the bf16 tensor-core bound.  What the design does about it: each
// thread computes a 4x8 register tile of scores and a 4x(D/8) tile of the
// output, with every shared-memory read a 16-byte vector (3 vector loads
// per 32 FMAs), K and Q stored transposed so those reads are contiguous;
// key tiles wholly outside the causal triangle or the window are skipped,
// and the q tiles with the most live key tiles are scheduled first.
// Tensor cores (mma / wgmma) and TMA are the next step.
//
// Masking matches the Pallas kernel: masked scores are NEG_INF = -1e30,
// and a row whose sum stays 0 gives o = 0 and lse = m + log 1 = NEG_INF.
// Rows and keys past S (the ragged edge) are masked, so any S works.
//
// Any head_dim d <= 256 that is a multiple of 8 works: the template is
// instantiated at a padded width D in {16, 32, 64, 128, 256}, d is passed
// at run time, loads past d fill zeros (which add nothing to q.k and give
// zero output columns) and stores stop at d.  At D = 256 the tiles take
// 222,208 B of shared memory, under the 232,448 B a block may opt into.
#include "common.cuh"

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
  int hq, hkv, s, d, window, causal;
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
template <typename T, int D>
__device__ __forceinline__ void load_transposed(const T* __restrict__ src,
                                                int r0, int s, int d,
                                                float* dst) {
  constexpr int N = repro::kVec<T>;
  constexpr int kChunks = D / N;
  for (int idx = threadIdx.x; idx < 64 * kChunks; idx += kThreads) {
    const int r = idx % 64, ch = idx / 64;
    float f[N];
    if (r0 + r < s && ch * N < d) {
      repro::unpack<T>(*reinterpret_cast<const uint4*>(
                           src + static_cast<size_t>(r0 + r) * d + ch * N),
                       f);
    } else {
#pragma unroll
      for (int e = 0; e < N; ++e) f[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < N; ++e) dst[(ch * N + e) * kLd + r] = f[e];
  }
}

// Rows [r0, r0 + 64) of a row-major (S, d) matrix into dst[r * D + c]
// for columns c < D, zero past S and past d.  Consecutive threads take
// consecutive 16-byte chunks.
template <typename T, int D>
__device__ __forceinline__ void load_rows(const T* __restrict__ src, int r0,
                                          int s, int d, float* dst) {
  constexpr int N = repro::kVec<T>;
  constexpr int kChunks = D / N;
  for (int idx = threadIdx.x; idx < 64 * kChunks; idx += kThreads) {
    const int r = idx / kChunks, ch = idx % kChunks;
    float f[N];
    if (r0 + r < s && ch * N < d) {
      repro::unpack<T>(*reinterpret_cast<const uint4*>(
                           src + static_cast<size_t>(r0 + r) * d + ch * N),
                       f);
    } else {
#pragma unroll
      for (int e = 0; e < N; ++e) f[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < N; e += 4) {
      *reinterpret_cast<float4*>(&dst[r * D + ch * N + e]) =
          make_float4(f[e], f[e + 1], f[e + 2], f[e + 3]);
    }
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

template <typename T, int D>
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
  const int s = a.s, d = a.d;
  const int n_qt = (s + kBQ - 1) / kBQ;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x);
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h * a.hkv / a.hq;
  const int q0 = qt * kBQ;

  const T* Q = static_cast<const T*>(a.q) +
               static_cast<size_t>(b * a.hq + h) * s * d;
  const T* K = static_cast<const T*>(a.k) +
               static_cast<size_t>(b * a.hkv + hk) * s * d;
  const T* V = static_cast<const T*>(a.v) +
               static_cast<size_t>(b * a.hkv + hk) * s * d;
  T* O = static_cast<T*>(a.o) + static_cast<size_t>(b * a.hq + h) * s * d;
  float* L = a.lse + static_cast<size_t>(b * a.hq + h) * s;

  load_transposed<T, D>(Q, q0, s, d, Qs);

  // Live key tiles: keys c with row - c < window for some row >= q0,
  // and (causal) c <= the tile's last row.  window >= 1 (wrapper).
  const int last_row = min(q0 + kBQ - 1, s - 1);
  const int kt_end = (a.causal ? last_row : s - 1) / kBK;
  const int lo = q0 - a.window + 1;
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
    load_transposed<T, D>(K, k0, s, d, Ks);
    load_rows<T, D>(V, k0, s, d, Vs);
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
      const int r = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = k0 + score_col(tx, j);
        float x = sc[i][j] * a.scale;
        if (a.softcap > 0.f) x = a.softcap * tanhf(x / a.softcap);
        const bool live = c < s && (r - c) < a.window && (!a.causal || c <= r);
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
    if (r < s) {
      const float inv = 1.f / (lt == 0.f ? 1.f : lt);
#pragma unroll
      for (int j = 0; j < kDc; ++j) {
        const int col = out_col<D>(tx, j);
        if (col < d) {
          O[static_cast<size_t>(r) * d + col] =
              repro::from_float<T>(acc[i][j] * inv);
        }
      }
      if (tx == 0) L[r] = lt == 0.f ? kNegInf : m[i] * kLn2 + logf(lt);
    }
  }
}

template <typename T, int D>
int launch(const Args& a, int b, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      fa_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.s + kBQ - 1) / kBQ, a.hq, b);
  fa_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The smallest instantiated width that holds head_dim d.
template <typename T>
int launch_d(const Args& a, int b, cudaStream_t stream) {
  if (a.d < 8 || a.d > 256 || a.d % 8) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (a.d <= 16) return launch<T, 16>(a, b, stream);
  if (a.d <= 32) return launch<T, 32>(a, b, stream);
  if (a.d <= 64) return launch<T, 64>(a, b, stream);
  if (a.d <= 128) return launch<T, 128>(a, b, stream);
  return launch<T, 256>(a, b, stream);
}

}  // namespace

// q, o: (B, Hq, S, d); k, v: (B, Hkv, S, d), contiguous, one dtype,
// d <= 256 a multiple of 8; lse: (B, Hq, S) fp32.  window >= 1 (pass
// S + 64 for "no window").
// Returns the CUDA error of the launch (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, float* lse, int b, int hq, int hkv,
                                   int s, int d, int window, int causal,
                                   float softcap, float scale, int dtype,
                                   void* stream) {
  if (b == 0 || hq == 0 || s == 0) return 0;
  const Args a{q, k, v, o, lse, hq, hkv, s, d, window, causal, softcap, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32) return launch_d<float>(a, b, st);
  if (dtype == repro::kBFloat16) return launch_d<__nv_bfloat16>(a, b, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Mamba2 SSD (state-space duality) chunked scan for Hopper: y only, no
// final state.  Math in fp32; x, B, C in fp32 or bf16, dt and A in fp32,
// y in x's dtype.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py::ssd_scan
// (_ssd_kernel).  For one (batch, head) and one chunk of Q steps, with
// L the inclusive cumsum of dt * A over the chunk:
//   y_i   = sum_{j <= i} (C_i . B_j) exp(L_i - L_j) dt_j x_j
//         + exp(L_i) C_i . state^T
//   state = exp(L_Q) state + sum_j exp(L_Q - L_j) dt_j x_j B_j^T
// The Pallas kernel carries the (P, N) state across a sequential grid axis
// in VMEM scratch.  Blocks on the card run in parallel and in no order, so
// here one block owns one (batch, head) and loops over the chunks itself,
// with the state in shared memory.  The B/C group of head h is h * G / H.
//
// Bound: bytes at the serving shapes (x and y dominate; the Zamba2 prefill
// moves ~0.24 GB for ~30 GFLOP), but this first version does its
// arithmetic on the fp32 FMA pipes, so it is bound by operations in
// practice.  What the design does about it: every product is a 4 x 4
// register tile fed by 16-byte shared-memory reads (C and B stored
// transposed, (N, Q), so those reads are contiguous); the (Q, Q) score
// matrix is never held whole, only one (Q, 32) column tile of it, which
// keeps N = 128 (Mamba2) inside shared memory; score tiles wholly above the
// causal diagonal are skipped.  Tensor cores and the Mamba2 chunk-state /
// state-passing / chunk-scan split are the next step.
//
// Masked scores are set to 0 before the exp, as the reference does, and
// every exponent is <= 0 (dt > 0, A < 0), so nothing overflows.  Chunk
// rows are padded to a multiple of 4 with dt = x = B = C = 0: those rows
// neither decay the state nor add to it, so any chunk length works.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kJT = 32;          // columns j of one score tile
constexpr int kMaxTiles = 2;     // 4 x 4 tiles of y a thread holds
constexpr int kMaxSmem = 232448;  // bytes a block may opt into on sm_90

struct Args {
  const void* x;
  const float* dt;
  const float* a;
  const void* b;
  const void* c;
  void* y;
  int s, h, p, g, n, chunk;
};

// Shared-memory layout, in floats.  qs, the row stride of the (., Q)
// arrays, is 4 more than the padded chunk so the scalar column reads of
// the state update spread over banks.
struct Layout {
  int qp, qs, bt, ct, st, mt, cum, w, total;
};

__host__ __device__ inline Layout layout(int q, int p, int n) {
  Layout l;
  l.qp = (q + 3) / 4 * 4;
  l.qs = l.qp + 4;
  l.bt = l.qp * p;          // Xs [qp][p] = x * dt at offset 0
  l.ct = l.bt + n * l.qs;   // Bt [n][qs]
  l.st = l.ct + n * l.qs;   // Ct [n][qs]
  l.mt = l.st + n * p;      // St [n][p], the state transposed
  l.cum = l.mt + kJT * l.qs;  // Mt [kJT][qs], one score tile transposed
  l.w = l.cum + l.qs;       // cum [qs]
  l.total = l.w + l.qs;     // w [qs]: dt, then exp(L_Q - L_j)
  return l;
}

// Rows [0, rows_pad) of a strided (rows, width) slab into shared memory:
// row-major dst[r * ld + c], optionally scaled by row_scale[r], or
// transposed dst[c * ld + r].  Rows >= rows are zero.  width is a
// multiple of the 16-byte vector.
template <typename T, bool kTransposed>
__device__ __forceinline__ void load_slab(const T* __restrict__ src,
                                          size_t row_stride, int rows,
                                          int rows_pad, int width,
                                          const float* row_scale, float* dst,
                                          int ld) {
  constexpr int N = repro::kVec<T>;
  const int chunks = width / N;
  for (int idx = threadIdx.x; idx < rows_pad * chunks; idx += kThreads) {
    // transposed: consecutive threads take consecutive rows, so the
    // shared-memory stores do not conflict
    const int r = kTransposed ? idx % rows_pad : idx / chunks;
    const int ch = kTransposed ? idx / rows_pad : idx % chunks;
    float f[N];
    if (r < rows) {
      repro::unpack<T>(*reinterpret_cast<const uint4*>(
                           src + static_cast<size_t>(r) * row_stride + ch * N),
                       f);
      if (row_scale != nullptr) {
        const float sc = row_scale[r];
#pragma unroll
        for (int e = 0; e < N; ++e) f[e] *= sc;
      }
    } else {
#pragma unroll
      for (int e = 0; e < N; ++e) f[e] = 0.f;
    }
    if constexpr (kTransposed) {
#pragma unroll
      for (int e = 0; e < N; ++e) dst[(ch * N + e) * ld + r] = f[e];
    } else {
#pragma unroll
      for (int e = 0; e < N; e += 4) {
        *reinterpret_cast<float4*>(&dst[r * ld + ch * N + e]) =
            make_float4(f[e], f[e + 1], f[e + 2], f[e + 3]);
      }
    }
  }
}

__device__ __forceinline__ void outer_acc(float (&acc)[4][4], float4 u,
                                          float4 v) {
  const float ur[4] = {u.x, u.y, u.z, u.w};
  const float vr[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(ur[r], vr[c], acc[r][c]);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_kernel(Args a) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int q = a.chunk, p = a.p, n = a.n;
  const Layout lay = layout(q, p, n);
  const int qp = lay.qp, qs = lay.qs;
  float* Xs = sm;
  float* Bt = sm + lay.bt;
  float* Ct = sm + lay.ct;
  float* St = sm + lay.st;
  float* Mt = sm + lay.mt;
  float* cum = sm + lay.cum;
  float* w = sm + lay.w;

  const int tid = threadIdx.x, lane = tid % 32;
  const int hh = blockIdx.x, b = blockIdx.y;
  const int gg = hh * a.g / a.h;
  const float decay_rate = a.a[hh];
  const size_t x_row = static_cast<size_t>(a.h) * p;   // between steps
  const size_t bc_row = static_cast<size_t>(a.g) * n;
  const size_t x_off = static_cast<size_t>(b) * a.s * x_row +
                       static_cast<size_t>(hh) * p;
  const size_t bc_off = static_cast<size_t>(b) * a.s * bc_row +
                        static_cast<size_t>(gg) * n;
  const T* X = static_cast<const T*>(a.x) + x_off;
  T* Y = static_cast<T*>(a.y) + x_off;
  const T* Bg = static_cast<const T*>(a.b) + bc_off;
  const T* Cg = static_cast<const T*>(a.c) + bc_off;
  const float* DT = a.dt + static_cast<size_t>(b) * a.s * a.h + hh;

  const int p4 = p / 4;
  const int n_ytiles = (qp / 4) * p4;          // 4 rows x 4 columns of y
  const int n_stiles = (n / 4) * p4;           // 4 states x 4 columns
  const int n_mtiles = (qp / 4) * (kJT / 4);   // 4 rows x 4 keys of scores

  for (int i = tid; i < n * p; i += kThreads) St[i] = 0.f;

  for (int t0 = 0; t0 < a.s; t0 += q) {
    for (int i = tid; i < qp; i += kThreads) {
      w[i] = i < q ? DT[static_cast<size_t>(t0 + i) * a.h] : 0.f;
    }
    __syncthreads();  // dt is in w

    // L = inclusive cumsum of dt * A over the chunk, by warp 0 in 32-row
    // segments, while the other warps start the loads
    if (tid < 32) {
      float carry = 0.f;
      for (int base = 0; base < qp; base += 32) {
        const int i = base + lane;
        float v = i < qp ? w[i] * decay_rate : 0.f;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const float u = __shfl_up_sync(0xffffffffu, v, o);
          if (lane >= o) v += u;
        }
        v += carry;
        if (i < qp) cum[i] = v;
        carry = __shfl_sync(0xffffffffu, v, 31);
      }
    }
    load_slab<T, false>(X + t0 * x_row, x_row, q, qp, p, w, Xs, p);
    load_slab<T, true>(Bg + t0 * bc_row, bc_row, q, qp, n, nullptr, Bt, qs);
    load_slab<T, true>(Cg + t0 * bc_row, bc_row, q, qp, n, nullptr, Ct, qs);
    __syncthreads();

    // carried-state term: y_i = exp(L_i) * C_i . state^T (zero state in
    // the first chunk)
    float acc[kMaxTiles][4][4];
#pragma unroll
    for (int k = 0; k < kMaxTiles; ++k) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[k][r][c] = 0.f;
      const int t = tid + k * kThreads;
      if (t0 > 0 && t < n_ytiles) {
        const int i0 = (t / p4) * 4, p0 = (t % p4) * 4;
        for (int c = 0; c < n; ++c) {
          outer_acc(acc[k], ld4(&Ct[c * qs + i0]), ld4(&St[c * p + p0]));
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float e = expf(cum[i0 + r]);
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[k][r][c] *= e;
        }
      }
    }

    // intra-chunk term, one 32-column tile of scores at a time
    for (int jt = 0; jt < qp; jt += kJT) {
      // Mt[jj][i] = (C_i . B_j) exp(L_i - L_j) for j = jt + jj <= i, else 0
      for (int t = tid; t < n_mtiles; t += kThreads) {
        const int i0 = (t / (kJT / 4)) * 4, jj0 = (t % (kJT / 4)) * 4;
        const int j0 = jt + jj0;
        float m[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) m[r][c] = 0.f;
        if (j0 < qp && j0 <= i0 + 3) {
          for (int c = 0; c < n; ++c) {
            outer_acc(m, ld4(&Ct[c * qs + i0]), ld4(&Bt[c * qs + j0]));
          }
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int i = i0 + r, j = j0 + c;
              m[r][c] = j <= i ? m[r][c] * expf(cum[i] - cum[j]) : 0.f;
            }
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          *reinterpret_cast<float4*>(&Mt[(jj0 + c) * qs + i0]) =
              make_float4(m[0][c], m[1][c], m[2][c], m[3][c]);
        }
      }
      __syncthreads();

      // y_i += sum_j Mt[j][i] (x * dt)_j, over the live j of the tile
      const int jn = min(kJT, qp - jt);
#pragma unroll
      for (int k = 0; k < kMaxTiles; ++k) {
        const int t = tid + k * kThreads;
        if (t < n_ytiles) {
          const int i0 = (t / p4) * 4, p0 = (t % p4) * 4;
          const int jmax = min(jn, i0 + 4 - jt);
          for (int jj = 0; jj < jmax; ++jj) {
            outer_acc(acc[k], ld4(&Mt[jj * qs + i0]),
                      ld4(&Xs[(jt + jj) * p + p0]));
          }
        }
      }
      __syncthreads();  // the score tile is no longer read
    }

#pragma unroll
    for (int k = 0; k < kMaxTiles; ++k) {
      const int t = tid + k * kThreads;
      if (t < n_ytiles) {
        const int i0 = (t / p4) * 4, p0 = (t % p4) * 4;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          if (i0 + r < q) {
            T* dst = Y + static_cast<size_t>(t0 + i0 + r) * x_row + p0;
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              dst[c] = repro::from_float<T>(acc[k][r][c]);
            }
          }
        }
      }
    }

    // state update: state = exp(L_Q) state + sum_j exp(L_Q - L_j) (x dt)_j
    // B_j^T.  Padding rows keep L at L_Q, so cum[qp - 1] is L_Q.
    const float tot = cum[qp - 1];
    for (int i = tid; i < qp; i += kThreads) w[i] = expf(tot - cum[i]);
    __syncthreads();  // w is set; every y tile has read the old state
    const float decay = expf(tot);
    for (int t = tid; t < n_stiles; t += kThreads) {
      const int c0 = (t / p4) * 4, p0 = (t % p4) * 4;
      float u[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) u[r][c] = 0.f;
      for (int j = 0; j < qp; ++j) {
        const float wj = w[j];
        float4 xv = ld4(&Xs[j * p + p0]);
        xv = make_float4(xv.x * wj, xv.y * wj, xv.z * wj, xv.w * wj);
        const float4 bv =
            make_float4(Bt[c0 * qs + j], Bt[(c0 + 1) * qs + j],
                        Bt[(c0 + 2) * qs + j], Bt[(c0 + 3) * qs + j]);
        outer_acc(u, bv, xv);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float4* sp = reinterpret_cast<float4*>(&St[(c0 + r) * p + p0]);
        const float4 old = *sp;
        *sp = make_float4(fmaf(old.x, decay, u[r][0]),
                          fmaf(old.y, decay, u[r][1]),
                          fmaf(old.z, decay, u[r][2]),
                          fmaf(old.w, decay, u[r][3]));
      }
    }
    __syncthreads();  // w and the state are no longer read
  }
}

template <typename T>
int launch(const Args& a, int bb, cudaStream_t stream) {
  const Layout lay = layout(a.chunk, a.p, a.n);
  const size_t smem = sizeof(float) * static_cast<size_t>(lay.total);
  if (smem > static_cast<size_t>(kMaxSmem) ||
      (lay.qp / 4) * (a.p / 4) > kThreads * kMaxTiles) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a.h, bb);
  ssd_kernel<T><<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, y: (Bb, S, H, P); dt: (Bb, S, H) fp32; A: (H,) fp32; B, C:
// (Bb, S, G, N); contiguous; x, B, C of one dtype.  S % chunk == 0,
// H % G == 0, P and N multiples of 8.  Returns the CUDA error of the
// launch (0 on success).
extern "C" int ssd_scan_fwd(const void* x, const float* dt, const float* A,
                            const void* B, const void* C, void* y, int bb,
                            int s, int h, int p, int g, int n, int chunk,
                            int dtype, void* stream) {
  if (bb == 0 || s == 0 || h == 0) return 0;
  if (chunk < 1 || s % chunk || g < 1 || h % g || p % 8 || n % 8) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{x, dt, A, B, C, y, s, h, p, g, n, chunk};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32) return launch<float>(a, bb, st);
  if (dtype == repro::kBFloat16) return launch<__nv_bfloat16>(a, bb, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Mamba2 SSD (state-space duality) chunked scan for Hopper: y and, when
// the caller asks, the final state (Bb, H, P, N) in fp32, the state after
// the last chunk (a Mamba2 prefill hands it to decode).  x, B, C in fp32
// or bf16, dt and A in fp32, y in x's dtype.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py::ssd_scan
// (_ssd_kernel).  For one (batch, head) and one chunk of Q steps, with
// L the inclusive cumsum of dt * A over the chunk:
//   y_i   = sum_{j <= i} (C_i . B_j) exp(L_i - L_j) dt_j x_j
//         + exp(L_i) C_i . state^T
//   state = exp(L_Q) state + sum_j exp(L_Q - L_j) dt_j x_j B_j^T
// The Pallas kernel carries the (P, N) state across a sequential grid axis
// in VMEM scratch.  Blocks on the card run in parallel and in no order, so
// the carry is done differently on each path.  The B/C group of head h is
// h * G / H.
//
// Masked scores are set to 0 before the exp, as the reference does, and
// every exponent is <= 0 (dt > 0, A < 0), so nothing overflows.  Chunk
// rows are padded (to 4 rows on the fp32 path, 16 on the bf16 path) with
// dt = x = B = C = 0: those rows neither decay the state nor add to it,
// so any chunk length works.
//
// Bound: bytes at the serving shapes (x and y dominate; the Zamba2 prefill
// moves ~0.24 GB for ~30 GFLOP, ~120 operations a byte against the card's
// ~295 in bf16).
//
// bfloat16: the tensor cores, with the work split the Mamba2 way (Dao &
// Gu 2024, sec. 7) so that every (batch, head, chunk) has blocks of its
// own; three kernels, launched in order on one stream:
// 1. chunk_state_kernel, one block per (b, h, chunk) but the last (with
//    the final state, every chunk):
//    S_c = (x o w)^T B over the chunk's Q rows, w_j = exp(L_Q - L_j) dt_j,
//    a (P, N) product on mma.sync m16n8k16 with fp32 accumulators, written
//    in fp32 to a workspace with exp(L_Q); the last chunk's S_c goes to the
//    final-state output instead.
// 2. state_pass_kernel, parallel over (b, h) and the P * N elements,
//    sequential over the chunks: state_{c+1} = exp(L_Q,c) state_c + S_c in
//    fp32, written over S_c as the state entering chunk c + 1; with the
//    final state, one more step over the last chunk, written over its S_c
//    in the output.  With one chunk and no state, neither kernel runs.
// 3. chunk_scan_kernel, one block per (b, h, chunk): per 16-row block of
//    the chunk, G = C B^T on the tensor cores 16 columns at a time (tiles
//    wholly above the diagonal skipped), scaled in registers by
//    exp(L_i - L_j) dt_j where j <= i and by 0 elsewhere, turned from the
//    accumulator fragment into bf16 A operands (as flash does with P) and
//    multiplied by x; the carried term C state^T, scaled by exp(L_i) in
//    fp32, starts the accumulator.  The four warps take the row blocks in
//    a zig-zag order, so the causal triangle's work is shared evenly; a
//    warp reads its rows of C as A fragments straight from global memory.
// x, B and C are exact in bf16, but x o w, the scaled scores M and the
// carried state are fp32 values: each goes to the tensor cores as a hi
// and a lo bf16 part (16 bits of mantissa, one more MMA with the same B
// fragment), since one bf16 rounding of each moved y by two bf16 ulps at
// Zamba2's shape.  Tiles are staged in shared memory by cp.async, rows
// padded by 16 bytes so ldmatrix's eight row reads fall in distinct
// banks; N is padded with zeros to an instantiated width of 16, 32, 64 or
// 128.  The workspace (fp32 S_c, then the states over them) is Bb * H *
// (nc - 1) * P * N * 4 bytes, written and read back twice: at Zamba2's
// prefill shape 1.7 times the function's own bytes; then exp(L_Q) for
// the nc - 1 chunks, or all nc with the final state.
//
// float32: the FMA kernel, so fp32 stays the exact check.  One block owns
// one (batch, head) and loops over the chunks itself, with the state in
// shared memory; every product is a 4 x 4 register tile fed by 16-byte
// shared-memory reads (C and B stored transposed, (N, Q), so those reads
// are contiguous); the (Q, Q) score matrix is never held whole, only one
// (Q, 32) column tile of it, which keeps N = 128 (Mamba2) inside shared
// memory; score tiles wholly above the causal diagonal are skipped.  The
// final state is the shared-memory state after the last chunk, written
// out (transposed back to (P, N)).
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kJT = 32;          // columns j of one score tile
constexpr int kMaxTiles = 2;     // 4 x 4 tiles of y a thread holds
constexpr int kMaxSmem = 232448;  // bytes a block may opt into on sm_90

struct Args {
  const float* x;
  const float* dt;
  const float* a;
  const float* b;
  const float* c;
  float* y;
  float* state;   // (Bb, H, P, N) or nullptr
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
template <bool kTransposed>
__device__ __forceinline__ void load_slab(const float* __restrict__ src,
                                          size_t row_stride, int rows,
                                          int rows_pad, int width,
                                          const float* row_scale, float* dst,
                                          int ld) {
  constexpr int N = repro::kVec<float>;
  const int chunks = width / N;
  for (int idx = threadIdx.x; idx < rows_pad * chunks; idx += kThreads) {
    // transposed: consecutive threads take consecutive rows, so the
    // shared-memory stores do not conflict
    const int r = kTransposed ? idx % rows_pad : idx / chunks;
    const int ch = kTransposed ? idx / rows_pad : idx % chunks;
    float f[N];
    if (r < rows) {
      repro::unpack<float>(*reinterpret_cast<const uint4*>(
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

  const int tid = threadIdx.x;
  const int hh = blockIdx.x, b = blockIdx.y;
  const int gg = hh * a.g / a.h;
  const float decay_rate = a.a[hh];
  const size_t x_row = static_cast<size_t>(a.h) * p;   // between steps
  const size_t bc_row = static_cast<size_t>(a.g) * n;
  const size_t x_off = static_cast<size_t>(b) * a.s * x_row +
                       static_cast<size_t>(hh) * p;
  const size_t bc_off = static_cast<size_t>(b) * a.s * bc_row +
                        static_cast<size_t>(gg) * n;
  const float* X = a.x + x_off;
  float* Y = a.y + x_off;
  const float* Bg = a.b + bc_off;
  const float* Cg = a.c + bc_off;
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

    // L = inclusive cumsum of dt * A over the chunk, by one thread while
    // the others start the loads: each dt_i A rounded, then added in
    // order in float, the numbers torch.cumsum gives on the card.  Each
    // step's rounding then moves one L_i - L_{i-1}, and every exp(L_i -
    // L_j) sees only the steps between j and i; sums rounded once (in
    // double, as the CPU's cumsum) or a warp's tree scan perturb every
    // difference instead.  On an H100, over Zamba2's 7-layer float32
    // train check, y sits 1.08e-6 from float64 this way against 1.46e-6
    // rounded once, and the gradients 1.12e-4 (the CPU's own: 1.09e-4)
    // against 2.36e-4.
    if (tid == 0) {
      float acc = 0.f;
#pragma unroll 8
      for (int i = 0; i < qp; ++i) {
        acc = __fadd_rn(acc, __fmul_rn(w[i], decay_rate));
        cum[i] = acc;
      }
    }
    load_slab<false>(X + t0 * x_row, x_row, q, qp, p, w, Xs, p);
    load_slab<true>(Bg + t0 * bc_row, bc_row, q, qp, n, nullptr, Bt, qs);
    load_slab<true>(Cg + t0 * bc_row, bc_row, q, qp, n, nullptr, Ct, qs);
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
            float* dst = Y + static_cast<size_t>(t0 + i0 + r) * x_row + p0;
#pragma unroll
            for (int c = 0; c < 4; ++c) dst[c] = acc[k][r][c];
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

  if (a.state != nullptr) {
    float* out = a.state + (static_cast<size_t>(b) * a.h + hh) * p * n;
    for (int i = tid; i < n * p; i += kThreads) {
      out[i] = St[(i % n) * p + i / n];
    }
  }
}

int launch_fma(const Args& a, int bb, cudaStream_t stream) {
  const Layout lay = layout(a.chunk, a.p, a.n);
  const size_t smem = sizeof(float) * static_cast<size_t>(lay.total);
  if (smem > static_cast<size_t>(kMaxSmem) ||
      (lay.qp / 4) * (a.p / 4) > kThreads * kMaxTiles) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a.h, bb);
  ssd_kernel<<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores (chunk state, state passing, chunk scan)
// ---------------------------------------------------------------------------
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 128;   // four warps
constexpr int kWarps = kThreads / 32;
constexpr int kPassThreads = 256;

struct TcArgs {
  const bf16* x;
  const float* dt;
  const float* a;
  const bf16* b;
  const bf16* c;
  bf16* y;
  // S_c, (Bb * H, nc - 1, P, N) fp32; the state passing overwrites slot c
  // with the state entering chunk c + 1
  float* chunk_state;
  // exp(L_Q) of chunk c, (Bb * H, nd): nd = nc - 1, or nc with the final
  // state
  float* decay;
  // (Bb * H, P, N) fp32 or nullptr: S_c of the last chunk, then the state
  // after it
  float* final_state;
  int s, h, p, g, n, chunk, nc;
};

// Chunks whose S_c and exp(L_Q) the chunk state kernel writes.
__host__ __device__ inline int state_chunks(const TcArgs& a) {
  return a.nc - 1 + (a.final_state != nullptr);
}

// Shared memory, in bytes.  Chunk rows are padded to 16 (qp), P to 16
// (pp) and N to the instantiated width kn; each bf16 row is 8 elements
// longer than its width (ldn, ldp).  Both kernels stage B, x (x o w in
// chunk_state_kernel, its hi part), L and dt; then chunk_state_kernel
// the lo part of x o w (up to state_bytes), chunk_scan_kernel the carried
// state as hi + lo (up to bytes).
struct TcLayout {
  int qp, pp, ldn, ldp;
  int b, x, l, dt, xlo, state_bytes, shi, slo, bytes;
};

__host__ __device__ inline TcLayout tc_layout(int q, int p, int kn) {
  TcLayout l;
  l.qp = (q + 15) / 16 * 16;
  l.pp = (p + 15) / 16 * 16;
  l.ldn = kn + 8;
  l.ldp = l.pp + 8;
  l.b = 0;                              // B [qp][ldn]
  l.x = l.b + 2 * l.qp * l.ldn;         // x (or x o w, hi) [qp][ldp]
  l.l = l.x + 2 * l.qp * l.ldp;         // L [qp] fp32
  l.dt = l.l + 4 * l.qp;                // dt [qp] fp32 (then w)
  l.xlo = l.dt + 4 * l.qp;              // x o w, lo [qp][ldp]
  l.state_bytes = l.xlo + 2 * l.qp * l.ldp;
  l.shi = l.xlo;                        // carried state, hi [pp][ldn]
  l.slo = l.shi + 2 * l.pp * l.ldn;     // carried state, lo [pp][ldn]
  l.bytes = l.slo + 2 * l.pp * l.ldn;
  return l;
}

// Workspace layout, in bytes: S_c of the first nc - 1 chunks, then the
// states (fp32), and exp(L_Q) of nc - 1 chunks, or nc with the final
// state (fp32), 256-byte aligned.
struct Workspace {
  size_t decay, bytes;
};

inline Workspace workspace(size_t bh, int nc, int p, int n,
                           bool final_state) {
  const size_t per = bh * static_cast<size_t>(nc - 1);
  Workspace w;
  w.decay = (per * p * n * 4 + 255) / 256 * 256;
  w.bytes = w.decay + bh * static_cast<size_t>(nc - 1 + final_state) * 4;
  return w;
}

// (a, b) as a bf16 pair hi and the bf16 pair lo of what hi leaves:
// hi + lo carries 16 bits of each float's mantissa.
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = repro::pack_bf16(a - hf.x, b - hf.y);
}

// Rows [0, rows_pad) x columns [0, wpad) of a strided bf16 slab into
// shared memory (row stride ld) by cp.async; rows >= rows and columns
// >= width arrive as zeros.  width and wpad are multiples of 8.
__device__ __forceinline__ void load_tile(bf16* dst, int ld, const bf16* src,
                                          size_t stride, int rows,
                                          int rows_pad, int width, int wpad) {
  const int vpr = wpad / 8;
  for (int idx = threadIdx.x; idx < rows_pad * vpr; idx += kThreads) {
    const int r = idx / vpr, v = (idx % vpr) * 8;
    const bool ok = r < rows && v < width;
    repro::cp_async16(dst + r * ld + v, ok ? src + r * stride + v : src, ok);
  }
}

// dt of the chunk's q steps (stride apart) into dts, all threads loading
// at once, then L, the inclusive cumsum of dt * A, into ls, rows [0, qp),
// by warp 0.  Padding rows have dt = 0, so L stays at L_Q there.  Every
// thread of the block calls it.
__device__ __forceinline__ void chunk_cumsum(const float* dt, int stride,
                                             int q, int qp, float a,
                                             float* dts, float* ls) {
  for (int i = threadIdx.x; i < qp; i += kThreads) {
    dts[i] = i < q ? dt[static_cast<size_t>(i) * stride] : 0.f;
  }
  __syncthreads();
  const int lane = threadIdx.x;
  if (lane >= 32) return;
  float carry = 0.f;
  for (int base = 0; base < qp; base += 32) {
    const int i = base + lane;
    float v = i < qp ? dts[i] * a : 0.f;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += u;
    }
    v += carry;
    if (i < qp) ls[i] = v;
    carry = __shfl_sync(0xffffffffu, v, 31);
  }
}

// S_c = (x o w)^T B for one (b, h, chunk c < state_chunks): a (P, N)
// product over the chunk's rows, warp tiles of 16 rows of P by all kN
// columns of N; the last chunk's (final state only) into the output.
template <int kNK>
__global__ void __launch_bounds__(kThreads) chunk_state_kernel(TcArgs a) {
  constexpr int kN = 16 * kNK;
  extern __shared__ __align__(16) unsigned char smem[];
  const TcLayout lay = tc_layout(a.chunk, a.p, kN);
  bf16* Bs = reinterpret_cast<bf16*>(smem + lay.b);
  bf16* Xh = reinterpret_cast<bf16*>(smem + lay.x);
  bf16* Xl = reinterpret_cast<bf16*>(smem + lay.xlo);
  float* Ls = reinterpret_cast<float*>(smem + lay.l);
  float* Ws = reinterpret_cast<float*>(smem + lay.dt);

  const int c = blockIdx.x, hh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q = a.chunk, gg = hh * a.g / a.h;
  const size_t t0 = static_cast<size_t>(b) * a.s + static_cast<size_t>(c) * q;
  load_tile(Bs, lay.ldn, a.b + (t0 * a.g + gg) * a.n,
            static_cast<size_t>(a.g) * a.n, q, lay.qp, a.n, kN);
  load_tile(Xh, lay.ldp, a.x + (t0 * a.h + hh) * a.p,
            static_cast<size_t>(a.h) * a.p, q, lay.qp, a.p, lay.pp);
  repro::cp_async_commit();
  chunk_cumsum(a.dt + t0 * a.h + hh, a.h, q, lay.qp, a.a[hh], Ws, Ls);
  __syncthreads();  // L and dt are in shared memory

  // w_j = exp(L_Q - L_j) dt_j; exp(L_Q) for the state passing
  const float lq = Ls[lay.qp - 1];
  for (int i = tid; i < lay.qp; i += kThreads) {
    Ws[i] = expf(lq - Ls[i]) * Ws[i];
  }
  const size_t bh = static_cast<size_t>(b) * a.h + hh;
  if (tid == 0) a.decay[bh * state_chunks(a) + c] = expf(lq);
  repro::cp_async_wait<0>();
  __syncthreads();  // the tiles have landed, w is set

  // x o w as hi + lo bf16
  const int half = lay.pp / 2;
  for (int idx = tid; idx < lay.qp * half; idx += kThreads) {
    const int r = idx / half;
    const int off = r * lay.ldp + 2 * (idx % half);
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(Xh + off));
    const float w = Ws[r];
    split_bf16(f.x * w, f.y * w, *reinterpret_cast<uint32_t*>(Xh + off),
               *reinterpret_cast<uint32_t*>(Xl + off));
  }
  __syncthreads();

  float* S = c < a.nc - 1
                 ? a.chunk_state + (bh * (a.nc - 1) + c) * a.p * a.n
                 : a.final_state + bh * a.p * a.n;
  const int g = lane / 4, t4 = lane % 4;
  for (int pt = warp; pt < lay.pp / 16; pt += kWarps) {
    float acc[2 * kNK][4];
#pragma unroll
    for (int nt = 0; nt < 2 * kNK; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
    for (int kk = 0; kk < lay.qp; kk += 16) {
      // A = (x o w)^T, stored (j, p): transposed on the way
      const int a_off = (kk + lane % 8 + (lane / 16) * 8) * lay.ldp +
                        pt * 16 + ((lane / 8) % 2) * 8;
      uint32_t ah[4], al[4];
      repro::ldmatrix_x4_trans(ah, Xh + a_off);
      repro::ldmatrix_x4_trans(al, Xl + a_off);
#pragma unroll
      for (int nt = 0; nt < 2 * kNK; nt += 2) {
        // B (K = j, N = n), stored (j, n): transposed on the way
        uint32_t r[4];
        repro::ldmatrix_x4_trans(
            r, Bs + (kk + lane % 16) * lay.ldn + nt * 8 + (lane / 16) * 8);
        repro::mma_bf16(acc[nt], ah, r);
        repro::mma_bf16(acc[nt + 1], ah, r + 2);
        repro::mma_bf16(acc[nt], al, r);
        repro::mma_bf16(acc[nt + 1], al, r + 2);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 2 * kNK; ++nt) {
      const int col = nt * 8 + 2 * t4;
      if (col >= a.n) continue;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = pt * 16 + g + 8 * hr;
        if (row < a.p) {
          *reinterpret_cast<float2*>(S + static_cast<size_t>(row) * a.n +
                                     col) =
              make_float2(acc[nt][2 * hr], acc[nt][2 * hr + 1]);
        }
      }
    }
  }
}

// The state entering chunk c + 1 = exp(L_Q,c) * (the state entering c) +
// S_c, from a zero state, in fp32, written over S_c for the ``steps`` =
// nc - 1 chunks of the workspace; with ``final_state``, one more step
// over the last chunk's S_c there.  One thread owns four consecutive
// elements of one (b, h)'s (P, N) state.
__global__ void __launch_bounds__(kPassThreads)
state_pass_kernel(float* __restrict__ s_c, const float* __restrict__ decay,
                  float* __restrict__ final_state, int pn4, int steps) {
  const int e = blockIdx.y * kPassThreads + threadIdx.x;
  if (e >= pn4) return;
  const size_t bh = blockIdx.x;
  float4* st = reinterpret_cast<float4*>(s_c) + bh * steps * pn4 + e;
  const float* dec = decay + bh * (steps + (final_state != nullptr));
  float4 cur = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = 0; c < steps; ++c) {
    const size_t at = static_cast<size_t>(c) * pn4;
    const float4 v = st[at];
    const float d = dec[c];
    cur = make_float4(fmaf(cur.x, d, v.x), fmaf(cur.y, d, v.y),
                      fmaf(cur.z, d, v.z), fmaf(cur.w, d, v.w));
    st[at] = cur;
  }
  if (final_state != nullptr) {
    float4* fs = reinterpret_cast<float4*>(final_state) + bh * pn4 + e;
    const float4 v = *fs;
    const float d = dec[steps];
    *fs = make_float4(fmaf(cur.x, d, v.x), fmaf(cur.y, d, v.y),
                      fmaf(cur.z, d, v.z), fmaf(cur.w, d, v.w));
  }
}

// y of one (b, h, chunk): per 16-row block, the carried term and the
// masked intra-chunk product, 64 columns of P at a time.
template <int kNK>
__global__ void __launch_bounds__(kThreads) chunk_scan_kernel(TcArgs a) {
  constexpr int kN = 16 * kNK;
  extern __shared__ __align__(16) unsigned char smem[];
  const TcLayout lay = tc_layout(a.chunk, a.p, kN);
  bf16* Bs = reinterpret_cast<bf16*>(smem + lay.b);
  bf16* Xs = reinterpret_cast<bf16*>(smem + lay.x);
  float* Ls = reinterpret_cast<float*>(smem + lay.l);
  float* Ds = reinterpret_cast<float*>(smem + lay.dt);
  bf16* Sh = reinterpret_cast<bf16*>(smem + lay.shi);
  bf16* Sl = reinterpret_cast<bf16*>(smem + lay.slo);

  const int c = blockIdx.x, hh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q = a.chunk, gg = hh * a.g / a.h;
  const size_t t0 = static_cast<size_t>(b) * a.s + static_cast<size_t>(c) * q;
  const size_t bc_row = static_cast<size_t>(a.g) * a.n;
  const size_t x_row = static_cast<size_t>(a.h) * a.p;
  const bf16* Cg = a.c + (t0 * a.g + gg) * a.n;

  load_tile(Bs, lay.ldn, a.b + (t0 * a.g + gg) * a.n, bc_row, q, lay.qp,
            a.n, kN);
  load_tile(Xs, lay.ldp, a.x + (t0 * a.h + hh) * a.p, x_row, q, lay.qp, a.p,
            lay.pp);
  repro::cp_async_commit();
  if (c > 0) {
    // the state entering the chunk, fp32 (p, n), as hi + lo bf16
    const float* st = a.chunk_state +
                      ((static_cast<size_t>(b) * a.h + hh) * (a.nc - 1) +
                       c - 1) * a.p * a.n;
    const int v4 = kN / 4;
    for (int idx = tid; idx < lay.pp * v4; idx += kThreads) {
      const int r = idx / v4, v = (idx % v4) * 4;
      const float4 f =
          r < a.p && v < a.n
              ? __ldg(reinterpret_cast<const float4*>(st + r * a.n + v))
              : make_float4(0.f, 0.f, 0.f, 0.f);
      uint2 hi, lo;
      split_bf16(f.x, f.y, hi.x, lo.x);
      split_bf16(f.z, f.w, hi.y, lo.y);
      *reinterpret_cast<uint2*>(Sh + r * lay.ldn + v) = hi;
      *reinterpret_cast<uint2*>(Sl + r * lay.ldn + v) = lo;
    }
  }
  chunk_cumsum(a.dt + t0 * a.h + hh, a.h, q, lay.qp, a.a[hh], Ds, Ls);
  repro::cp_async_wait<0>();
  __syncthreads();

  const int nrb = lay.qp / 16;

  bf16* Y = a.y + (t0 * a.h + hh) * a.p;
  const int g = lane / 4, t4 = lane % 4;
  for (int idx = warp; idx < nrb; idx += kWarps) {
    // zig-zag: every other group of kWarps row blocks runs backwards, so
    // a warp's long and short rows of the causal triangle pair up
    const int s0 = idx / kWarps * kWarps;
    const int gs = min(kWarps, nrb - s0);
    const int rb = (idx / kWarps) % 2 ? s0 + gs - 1 - (idx - s0) : idx;
    const int i0 = rb * 16;
    // C rows i0 .. i0 + 15 as A operands (K = n), for both products,
    // straight from global memory: a lane's four pairs of the fragment
    // (zeros past the chunk and past N)
    uint32_t cf[kNK][4];
    const bf16* c0 = Cg + static_cast<size_t>(i0 + g) * bc_row;
    const bool in0 = i0 + g < q, in1 = i0 + g + 8 < q;
#pragma unroll
    for (int kk = 0; kk < kNK; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kk * 16 + 2 * t4 + (e / 2) * 8;
        const bool ok = (e % 2 ? in1 : in0) && col < a.n;
        cf[kk][e] = ok ? __ldg(reinterpret_cast<const unsigned int*>(
                             c0 + (e % 2) * 8 * bc_row + col))
                       : 0u;
      }
    }
    const float li[2] = {Ls[i0 + g], Ls[i0 + g + 8]};

    for (int p0 = 0; p0 < lay.pp; p0 += 64) {
      const int npt = min(8, (lay.pp - p0) / 8);  // n8 tiles of y, even
      float acc[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

      if (c > 0) {
        // carried term: exp(L_i) C_i . state^T; the state is stored
        // (p, n), so it is B (K = n, N = p) as it lies, hi then lo
#pragma unroll
        for (int kk = 0; kk < kNK; ++kk) {
#pragma unroll
          for (int nt = 0; nt < 8; nt += 2) {
            if (nt >= npt) break;
            const int off =
                (p0 + nt * 8 + lane % 8 + (lane / 16) * 8) * lay.ldn +
                kk * 16 + ((lane / 8) % 2) * 8;
            uint32_t rh[4], rl[4];
            repro::ldmatrix_x4(rh, Sh + off);
            repro::ldmatrix_x4(rl, Sl + off);
            repro::mma_bf16(acc[nt], cf[kk], rh);
            repro::mma_bf16(acc[nt + 1], cf[kk], rh + 2);
            repro::mma_bf16(acc[nt], cf[kk], rl);
            repro::mma_bf16(acc[nt + 1], cf[kk], rl + 2);
          }
        }
        const float e0 = expf(li[0]), e1 = expf(li[1]);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          acc[nt][0] *= e0;
          acc[nt][1] *= e0;
          acc[nt][2] *= e1;
          acc[nt][3] *= e1;
        }
      }

      for (int jb = 0; jb <= rb; ++jb) {
        const int j0 = jb * 16;
        // G = C_i . B_j for the 16 x 16 tile; B is stored (j, n), so it
        // is the B operand (K = n, N = j) as it lies
        float gt[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int kk = 0; kk < kNK; ++kk) {
          uint32_t r[4];
          repro::ldmatrix_x4(
              r, Bs + (j0 + lane % 8 + (lane / 16) * 8) * lay.ldn + kk * 16 +
                     ((lane / 8) % 2) * 8);
          repro::mma_bf16(gt[0], cf[kk], r);
          repro::mma_bf16(gt[1], cf[kk], r + 2);
        }
        // M = G exp(L_i - L_j) dt_j for j <= i, else 0 (the exponent is
        // set to 0 before the exp where j > i), as hi + lo bf16 A operands
        uint32_t mh[4], ml[4];
#pragma unroll
        for (int ht = 0; ht < 2; ++ht) {
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int i = i0 + g + 8 * hr;
            float m[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int j = j0 + ht * 8 + 2 * t4 + e;
              const bool live = j <= i;
              const float ex = expf(live ? li[hr] - Ls[j] : 0.f);
              m[e] = live ? gt[ht][2 * hr + e] * ex * Ds[j] : 0.f;
            }
            split_bf16(m[0], m[1], mh[2 * ht + hr], ml[2 * ht + hr]);
          }
        }
        // y += M x_j; x is stored (j, p): B (K = j, N = p) transposed
#pragma unroll
        for (int nt = 0; nt < 8; nt += 2) {
          if (nt >= npt) break;
          uint32_t r[4];
          repro::ldmatrix_x4_trans(r, Xs + (j0 + lane % 16) * lay.ldp + p0 +
                                          nt * 8 + (lane / 16) * 8);
          repro::mma_bf16(acc[nt], mh, r);
          repro::mma_bf16(acc[nt + 1], mh, r + 2);
          repro::mma_bf16(acc[nt], ml, r);
          repro::mma_bf16(acc[nt + 1], ml, r + 2);
        }
      }

      // y rows < Q, columns < P (P % 8 == 0: a pair is wholly inside)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int col = p0 + nt * 8 + 2 * t4;
        if (nt >= npt || col >= a.p) continue;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int i = i0 + g + 8 * hr;
          if (i < q) {
            *reinterpret_cast<uint32_t*>(Y + i * x_row + col) =
                repro::pack_bf16(acc[nt][2 * hr], acc[nt][2 * hr + 1]);
          }
        }
      }
    }
  }
}

template <int kNK>
int launch(const TcArgs& a, int bb, cudaStream_t stream) {
  const TcLayout lay = tc_layout(a.chunk, a.p, 16 * kNK);
  if (lay.bytes > kMaxSmem || lay.state_bytes > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int dev = 0;
  int err = repro::current_device(&dev);
  if (err) return err;
  // opt both block kernels into the most shared memory a block may have,
  // once per device; the launch asks for what it needs
  err = repro::once_per_device(dev, [] {
    cudaError_t e = cudaFuncSetAttribute(
        chunk_state_kernel<kNK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (e == cudaSuccess) {
      e = cudaFuncSetAttribute(chunk_scan_kernel<kNK>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSmem);
    }
    return static_cast<int>(e);
  });
  if (err) return err;
  if (state_chunks(a) > 0) {
    chunk_state_kernel<kNK><<<dim3(state_chunks(a), a.h, bb), kThreads,
                              lay.state_bytes, stream>>>(a);
    err = static_cast<int>(cudaGetLastError());
    if (err) return err;
    const int pn4 = a.p * a.n / 4;
    state_pass_kernel<<<dim3(bb * a.h, (pn4 + kPassThreads - 1) /
                                           kPassThreads),
                        kPassThreads, 0, stream>>>(
        a.chunk_state, a.decay, a.final_state, pn4, a.nc - 1);
    err = static_cast<int>(cudaGetLastError());
    if (err) return err;
  }
  chunk_scan_kernel<kNK><<<dim3(a.nc, a.h, bb), kThreads, lay.bytes,
                           stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int launch_bf16(const void* x, const float* dt, const float* A,
                const void* B, const void* C, void* y, float* state,
                void* ws, int bb, int s, int h, int p, int g, int n,
                int chunk, cudaStream_t stream) {
  const int nc = s / chunk;
  const Workspace w =
      workspace(static_cast<size_t>(bb) * h, nc, p, n, state != nullptr);
  unsigned char* base = static_cast<unsigned char*>(ws);
  const TcArgs a{static_cast<const bf16*>(x), dt, A,
                 static_cast<const bf16*>(B), static_cast<const bf16*>(C),
                 static_cast<bf16*>(y), reinterpret_cast<float*>(base),
                 reinterpret_cast<float*>(base + w.decay), state, s, h, p,
                 g, n, chunk, nc};
  const int nk = (n + 15) / 16;   // k16 steps over N
  if (nk <= 1) return launch<1>(a, bb, stream);
  if (nk <= 2) return launch<2>(a, bb, stream);
  if (nk <= 4) return launch<4>(a, bb, stream);
  if (nk <= 8) return launch<8>(a, bb, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace tc
}  // namespace

// Bytes of workspace ssd_scan_fwd needs (0 for float32, and for bfloat16
// with one chunk and no final state).
extern "C" long long ssd_scan_workspace_bytes(int bb, int s, int h, int p,
                                              int n, int chunk, int dtype,
                                              int final_state) {
  if (dtype != repro::kBFloat16 || chunk < 1 || s / chunk < 1 ||
      (s / chunk < 2 && !final_state)) {
    return 0;
  }
  return static_cast<long long>(tc::workspace(static_cast<size_t>(bb) * h,
                                              s / chunk, p, n,
                                              final_state != 0)
                                    .bytes);
}

// x, y: (Bb, S, H, P); dt: (Bb, S, H) fp32; A: (H,) fp32; B, C:
// (Bb, S, G, N); contiguous; x, B, C of one dtype.  S % chunk == 0,
// H % G == 0, P and N multiples of 8.  ``state``: nullptr, or the final
// state (Bb, H, P, N) fp32, 16-byte aligned, which the launch writes.
// ``workspace``: 256-byte aligned, ssd_scan_workspace_bytes() of it with
// the same final-state flag (bfloat16 only).  Returns the CUDA error of
// the launches (0 on success).
extern "C" int ssd_scan_fwd(const void* x, const float* dt, const float* A,
                            const void* B, const void* C, void* y,
                            float* state, void* workspace, int bb, int s,
                            int h, int p, int g, int n, int chunk, int dtype,
                            void* stream) {
  if (bb == 0 || s == 0 || h == 0) return 0;
  if (chunk < 1 || s % chunk || g < 1 || h % g || p % 8 || n % 8) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32) {
    const Args a{static_cast<const float*>(x), dt, A,
                 static_cast<const float*>(B), static_cast<const float*>(C),
                 static_cast<float*>(y), state, s, h, p, g, n, chunk};
    return launch_fma(a, bb, st);
  }
  if (dtype == repro::kBFloat16) {
    return tc::launch_bf16(x, dt, A, B, C, y, state, workspace, bb, s, h, p,
                           g, n, chunk, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Grouped matmul for MoE expert FFNs on Hopper: out[r] = x[r] @ w[e(r)],
// where the rows of x are sorted by expert and cut into blocks of
// ``block_t`` rows, each block owned by the one expert that
// ``block_group_ids`` names.  fp32 accumulation, output in x's dtype.
//
// Replaces the Pallas TPU kernel src/repro/kernels/moe_gmm.py::moe_gmm
// (_gmm_kernel).  The Pallas kernel walks a grid (T/bt, N/bn, K/bk) in
// order, carries the sum over K in VMEM scratch from one grid step to
// the next and picks each step's weight block by a scalar-prefetched
// expert id.  Here one block of threads owns a whole (block_t x BN)
// output tile: it reads its expert id once, loops over K itself with the
// sum in registers, and stores the tile once.  block_t is the block's row
// tile (a template parameter), so no tile ever straddles two experts, and
// an expert that owns no row block is never read.
//
// Bound: operations at the prefill shapes (Qwen3-MoE: 81,920 rows x 4096
// x 1536, ~1 TFLOP a launch against 1.6 GB of weights), bytes at decode
// (1,024 rows: every expert's weights are read for 8 rows each).
//
// bfloat16 runs on the tensor cores through warp-level mma.sync
// (m16n8k16, fp32 accumulators): 128 threads, a (block_t x 128) tile,
// four stages of 32-deep K slices brought into shared memory by cp.async
// (16-byte copies, zero-filled past K and N), fragments read with
// ldmatrix (the weight slice transposed on the way).  Rows are padded by
// 16 bytes so ldmatrix's eight row reads fall in distinct banks.  float32
// runs on the FMA pipes (a 16 x 64 thread grid of register tiles), so
// fp32 products stay in fp32: no TF32.  wgmma, TMA and a persistent
// scheduler are later work.
//
// The tile index runs columns fastest: the blocks in flight share one row
// block of x (read from device memory once) and the few experts whose
// weights they read stay in the 50 MB L2 across those experts' row
// blocks.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float nan_f() {
  return __int_as_float(0x7fc00000);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;   // 0 source bytes: the 16 bytes are zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// c += a (16x16, row) * b (16x8, col), bf16 in, fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores
// ---------------------------------------------------------------------------
template <int BT>
struct MmaTile {
  static constexpr int kBN = 128;
  static constexpr int kBK = 32;
  static constexpr int kStages = 4;
  static constexpr int kBM = BT < 16 ? 16 : BT;   // rows >= BT stay zero
  static constexpr int kWarpsM = BT >= 32 ? 2 : 1;
  static constexpr int kWarpsN = 4 / kWarpsM;
  static constexpr int kWM = kBM / kWarpsM;       // rows of a warp
  static constexpr int kWN = kBN / kWarpsN;       // columns of a warp
  static constexpr int kMT = kWM / 16;            // m16 tiles of a warp
  static constexpr int kNT = kWN / 8;             // n8 tiles of a warp
  static constexpr int kAStride = kBK + 8;        // bf16 elements a row
  static constexpr int kBStride = kBN + 8;
  static constexpr int kAStage = kBM * kAStride;
  static constexpr int kBStage = kBK * kBStride;
  static constexpr int kSmemBytes = kStages * (kAStage + kBStage) * 2;
};

template <int BT>
__global__ void __launch_bounds__(kThreads)
gmm_mma_kernel(const __nv_bfloat16* __restrict__ x,
               const __nv_bfloat16* __restrict__ w,
               const int* __restrict__ gids, __nv_bfloat16* __restrict__ out,
               int k_dim, int n_dim, int n_experts, int n_tiles) {
  using P = MmaTile<BT>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Bs = As + P::kStages * P::kAStage;

  const int tile = blockIdx.x;
  const long long tb = tile / n_tiles;           // row block
  const int n0 = (tile % n_tiles) * P::kBN;
  const long long row0 = tb * BT;
  const int e = gids[tb];
  const int tid = threadIdx.x;

  if (e < 0 || e >= n_experts) {
    // an id outside [0, E): NaN rows, so any check of the output sees it
    for (int i = tid; i < BT * P::kBN; i += kThreads) {
      const int c = n0 + i % P::kBN;
      if (c < n_dim)
        out[(row0 + i / P::kBN) * n_dim + c] = __float2bfloat16_rn(nan_f());
    }
    return;
  }
  const __nv_bfloat16* xb = x + row0 * k_dim;
  const __nv_bfloat16* wb = w + static_cast<long long>(e) * k_dim * n_dim;

  if constexpr (BT < 16) {   // the padding rows of every stage are zeros
    for (int i = tid; i < P::kStages * (16 - BT) * P::kAStride;
         i += kThreads) {
      const int s = i / ((16 - BT) * P::kAStride);
      const int r = i % ((16 - BT) * P::kAStride);
      As[s * P::kAStage + BT * P::kAStride + r] = __float2bfloat16_rn(0.f);
    }
  }

  auto load_stage = [&](int stage, int k0) {
    __nv_bfloat16* as = As + stage * P::kAStage;
    __nv_bfloat16* bs = Bs + stage * P::kBStage;
    constexpr int kAVec = BT * P::kBK / 8;
    for (int v = tid; v < kAVec; v += kThreads) {
      const int r = v / (P::kBK / 8);
      const int c = (v % (P::kBK / 8)) * 8;
      const bool ok = k0 + c < k_dim;
      cp_async16(as + r * P::kAStride + c,
                 ok ? xb + r * static_cast<long long>(k_dim) + k0 + c : xb,
                 ok);
    }
    constexpr int kBVec = P::kBK * P::kBN / 8;
    for (int v = tid; v < kBVec; v += kThreads) {
      const int r = v / (P::kBN / 8);
      const int c = (v % (P::kBN / 8)) * 8;
      const bool ok = k0 + r < k_dim && n0 + c < n_dim;
      cp_async16(bs + r * P::kBStride + c,
                 ok ? wb + static_cast<long long>(k0 + r) * n_dim + n0 + c
                    : wb,
                 ok);
    }
  };

  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp / P::kWarpsN, wn = warp % P::kWarpsN;
  float acc[P::kMT][P::kNT][4];
#pragma unroll
  for (int i = 0; i < P::kMT; ++i)
#pragma unroll
    for (int j = 0; j < P::kNT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  const int nk = (k_dim + P::kBK - 1) / P::kBK;
#pragma unroll
  for (int s = 0; s < P::kStages - 1; ++s) {
    if (s < nk) load_stage(s, s * P::kBK);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<P::kStages - 2>();
    __syncthreads();   // stage kt landed; stage kt-1 is no longer read
    const int nxt = kt + P::kStages - 1;
    if (nxt < nk) load_stage(nxt % P::kStages, nxt * P::kBK);
    cp_async_commit();

    const __nv_bfloat16* as = As + (kt % P::kStages) * P::kAStage;
    const __nv_bfloat16* bs = Bs + (kt % P::kStages) * P::kBStage;
#pragma unroll
    for (int kk = 0; kk < P::kBK; kk += 16) {
      uint32_t a[P::kMT][4], b[P::kNT][2];
#pragma unroll
      for (int i = 0; i < P::kMT; ++i)
        ldmatrix_x4(a[i], as + (wm * P::kWM + i * 16 + lane % 16) *
                                   P::kAStride + kk + (lane / 16) * 8);
#pragma unroll
      for (int j = 0; j < P::kNT; j += 2) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, bs + (kk + lane % 16) * P::kBStride +
                                 wn * P::kWN + j * 8 + (lane / 16) * 8);
        b[j][0] = r[0];
        b[j][1] = r[1];
        b[j + 1][0] = r[2];
        b[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < P::kMT; ++i)
#pragma unroll
        for (int j = 0; j < P::kNT; ++j) mma_bf16(acc[i][j], a[i], b[j]);
    }
  }
  cp_async_wait<0>();

  // c0,c1 at (g, 2t..2t+1); c2,c3 at (g+8, 2t..2t+1); N % 8 == 0, so a
  // pair is wholly inside N or wholly past it
  const int g = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int i = 0; i < P::kMT; ++i) {
#pragma unroll
    for (int j = 0; j < P::kNT; ++j) {
      const int c = n0 + wn * P::kWN + j * 8 + 2 * t4;
      if (c >= n_dim) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm * P::kWM + i * 16 + g + 8 * h;
        if (r >= BT) continue;
        *reinterpret_cast<__nv_bfloat162*>(out + (row0 + r) * n_dim + c) =
            __floats2bfloat162_rn(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// float32: FMA pipes
// ---------------------------------------------------------------------------
template <int BT>
struct FmaTile {
  static constexpr int kBN = 64;
  static constexpr int kBK = 16;
  static constexpr int kTM = BT / 8;                // rows of a thread
  static constexpr int kAStride = kBK + 4;          // 16-byte rows
};

template <int BT>
__global__ void __launch_bounds__(kThreads)
gmm_fma_kernel(const float* __restrict__ x, const float* __restrict__ w,
               const int* __restrict__ gids, float* __restrict__ out,
               int k_dim, int n_dim, int n_experts, int n_tiles) {
  using P = FmaTile<BT>;
  __shared__ __align__(16) float As[BT * P::kAStride];
  __shared__ __align__(16) float Bs[P::kBK * P::kBN];

  const int tile = blockIdx.x;
  const long long tb = tile / n_tiles;
  const int n0 = (tile % n_tiles) * P::kBN;
  const long long row0 = tb * BT;
  const int e = gids[tb];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;   // 4 columns, kTM rows each

  if (e < 0 || e >= n_experts) {
    for (int i = tid; i < BT * P::kBN; i += kThreads) {
      const int c = n0 + i % P::kBN;
      if (c < n_dim) out[(row0 + i / P::kBN) * n_dim + c] = nan_f();
    }
    return;
  }
  const float* xb = x + row0 * k_dim;
  const float* wb = w + static_cast<long long>(e) * k_dim * n_dim;

  float acc[P::kTM][4];
#pragma unroll
  for (int i = 0; i < P::kTM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k0 = 0; k0 < k_dim; k0 += P::kBK) {
    for (int v = tid; v < BT * P::kBK / 4; v += kThreads) {
      const int r = v / (P::kBK / 4);
      const int c = (v % (P::kBK / 4)) * 4;
      *reinterpret_cast<float4*>(As + r * P::kAStride + c) =
          k0 + c < k_dim ? *reinterpret_cast<const float4*>(
                               xb + r * static_cast<long long>(k_dim) + k0 + c)
                         : zero;
    }
    for (int v = tid; v < P::kBK * P::kBN / 4; v += kThreads) {
      const int r = v / (P::kBN / 4);
      const int c = (v % (P::kBN / 4)) * 4;
      *reinterpret_cast<float4*>(Bs + r * P::kBN + c) =
          k0 + r < k_dim && n0 + c < n_dim
              ? *reinterpret_cast<const float4*>(
                    wb + static_cast<long long>(k0 + r) * n_dim + n0 + c)
              : zero;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < P::kBK; ++kk) {
      const float4 b = *reinterpret_cast<const float4*>(Bs + kk * P::kBN +
                                                        tx * 4);
#pragma unroll
      for (int i = 0; i < P::kTM; ++i) {
        const float a = As[(ty * P::kTM + i) * P::kAStride + kk];
        acc[i][0] = fmaf(a, b.x, acc[i][0]);
        acc[i][1] = fmaf(a, b.y, acc[i][1]);
        acc[i][2] = fmaf(a, b.z, acc[i][2]);
        acc[i][3] = fmaf(a, b.w, acc[i][3]);
      }
    }
    __syncthreads();
  }

  const int c = n0 + tx * 4;   // N % 8 == 0: four columns in or out
  if (c >= n_dim) return;
#pragma unroll
  for (int i = 0; i < P::kTM; ++i)
    *reinterpret_cast<float4*>(out + (row0 + ty * P::kTM + i) * n_dim + c) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------
template <int BT>
int launch_mma(const void* x, const void* w, const int* gids, void* out,
               long long n_blocks, int k, int n, int e, cudaStream_t s) {
  using P = MmaTile<BT>;
  // above 48 KB only after an opt-in, which is per device: set it always
  const cudaError_t err = cudaFuncSetAttribute(
      gmm_mma_kernel<BT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      P::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = (n + P::kBN - 1) / P::kBN;
  gmm_mma_kernel<BT><<<static_cast<unsigned>(n_blocks * n_tiles), kThreads,
                       P::kSmemBytes, s>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), gids,
      static_cast<__nv_bfloat16*>(out), k, n, e, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

template <int BT>
int launch_fma(const void* x, const void* w, const int* gids, void* out,
               long long n_blocks, int k, int n, int e, cudaStream_t s) {
  const int n_tiles = (n + FmaTile<BT>::kBN - 1) / FmaTile<BT>::kBN;
  gmm_fma_kernel<BT><<<static_cast<unsigned>(n_blocks * n_tiles), kThreads,
                       0, s>>>(static_cast<const float*>(x),
                               static_cast<const float*>(w), gids,
                               static_cast<float*>(out), k, n, e, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

template <int BT>
int launch(const void* x, const void* w, const int* gids, void* out,
           long long n_blocks, int k, int n, int e, int dtype,
           cudaStream_t s) {
  if (dtype == repro::kBFloat16)
    return launch_mma<BT>(x, w, gids, out, n_blocks, k, n, e, s);
  if (dtype == repro::kFloat32)
    return launch_fma<BT>(x, w, gids, out, n_blocks, k, n, e, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x: (T, K); w: (E, K, N); gids: (T / block_t,) int32; out: (T, N); all
// contiguous, x, w and out 16-byte aligned, K and N multiples of 8,
// block_t one of 8, 16, 32, 64, 128 (checked by the Python wrapper).
// Returns cudaGetLastError().
extern "C" int moe_gmm_fwd(const void* x, const void* w, const void* gids,
                           void* out, long long t, int k, int n, int e,
                           int block_t, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* g = static_cast<const int*>(gids);
  if (t == 0 || n == 0) return static_cast<int>(cudaGetLastError());
  const long long nb = t / block_t;
  switch (block_t) {
    case 8: return launch<8>(x, w, g, out, nb, k, n, e, dtype, s);
    case 16: return launch<16>(x, w, g, out, nb, k, n, e, dtype, s);
    case 32: return launch<32>(x, w, g, out, nb, k, n, e, dtype, s);
    case 64: return launch<64>(x, w, g, out, nb, k, n, e, dtype, s);
    case 128: return launch<128>(x, w, g, out, nb, k, n, e, dtype, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

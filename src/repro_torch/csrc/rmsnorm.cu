// RMSNorm forward for Hopper: y = x * rsqrt(mean(x^2) + eps) * (offset + w).
//
// Replaces the Pallas TPU kernel src/repro/kernels/rmsnorm.py::rmsnorm
// (_rmsnorm_kernel), which normalises blocks of rows padded to a
// multiple of the block.  Here a row belongs to a group of lanes of one
// warp, so no padding is needed.
//
// Bound: bytes.  The kernel reads each row and the weight and writes the
// row, with one fp32 sum of squares and a few flops per element, far
// below the card's ratio of operations to bytes.  So what matters is the
// bytes in flight: 3.35 TB/s times a ~0.7 us load latency is ~18 KB per
// SM.  The design:
// - One pass over device memory (rmsnorm_reg_kernel): a lane issues all
//   of its 16-byte loads of the row before the reduction, keeps them in
//   registers, reduces in fp32 and scales and stores from the registers.
//   A 4096-wide bf16 row is 16 vectors a lane, 8 KB in flight a warp.
// - Narrow rows are packed: a row of at most 16 vectors (D = 128 in bf16,
//   Qwen3's q/k-norm) takes 16 lanes, and a warp does 2 rows, with the
//   shuffle reduction over that width.
// - Wider rows take a whole warp at 8, 16 or 32 vectors a lane; lanes
//   past the row's last vector load nothing.
// - Rows wider than the register budget (more than 32 vectors a lane) and
//   rows that are not whole 16-byte vectors take a two-pass loop
//   (rmsnorm_loop_kernel): the second read comes from L1/L2.  The launch
//   picks by width.
// Statistics are in fp32 and the output has x's dtype, as in the
// reference.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxVecsPerLane = 32;

// kLanes lanes own one row and hold up to kVPL of its 16-byte vectors
// each (a lane's vectors are kLanes apart, so a warp's loads coalesce).
template <typename T, int kLanes, int kVPL>
__global__ void __launch_bounds__(kThreads)
rmsnorm_reg_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   T* __restrict__ out, long long rows, int d, float eps,
                   float offset) {
  constexpr int N = repro::kVec<T>;
  constexpr int kRowsPerWarp = 32 / kLanes;
  const int lane = threadIdx.x % 32;
  const int sub = lane % kLanes;
  const long long row =
      (static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32) *
          kRowsPerWarp +
      lane / kLanes;
  const bool live = row < rows;
  const int nvec = d / N;
  const uint4* xv = reinterpret_cast<const uint4*>(x + (live ? row : 0) * d);

  uint4 v[kVPL];
#pragma unroll
  for (int k = 0; k < kVPL; ++k) {
    const int i = sub + k * kLanes;
    v[k] = live && i < nvec ? xv[i] : make_uint4(0u, 0u, 0u, 0u);
  }
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < kVPL; ++k) {
    float f[N];
    repro::unpack<T>(v[k], f);
#pragma unroll
    for (int j = 0; j < N; ++j) ss += f[j] * f[j];
  }
  // xor offsets below kLanes stay inside the row's aligned group of lanes
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1) {
    ss += __shfl_xor_sync(0xffffffffu, ss, o);
  }
  if (!live) return;
  const float inv = rsqrtf(ss / static_cast<float>(d) + eps);

  const uint4* wv = reinterpret_cast<const uint4*>(w);
  uint4* yv = reinterpret_cast<uint4*>(out + row * d);
#pragma unroll
  for (int k = 0; k < kVPL; ++k) {
    const int i = sub + k * kLanes;
    if (i < nvec) {
      float f[N], g[N];
      repro::unpack<T>(v[k], f);
      repro::unpack<T>(wv[i], g);
#pragma unroll
      for (int j = 0; j < N; ++j) f[j] = f[j] * inv * (offset + g[j]);
      yv[i] = repro::pack<T>(f);
    }
  }
}

// One warp a row, two passes over it: 16-byte vectors (kVecPath) or
// single elements.
template <typename T, bool kVecPath>
__global__ void __launch_bounds__(kThreads)
rmsnorm_loop_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    T* __restrict__ out, long long rows, int d, float eps,
                    float offset) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (row >= rows) return;
  const T* xr = x + row * d;
  T* yr = out + row * d;
  constexpr int N = repro::kVec<T>;

  float ss = 0.f;
  if constexpr (kVecPath) {
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    for (int i = lane; i < d / N; i += 32) {
      float f[N];
      repro::unpack<T>(xv[i], f);
#pragma unroll
      for (int j = 0; j < N; ++j) ss += f[j] * f[j];
    }
  } else {
    for (int i = lane; i < d; i += 32) {
      const float f = repro::to_float<T>(xr[i]);
      ss += f * f;
    }
  }
  ss = repro::warp_sum(ss);
  const float inv = rsqrtf(ss / static_cast<float>(d) + eps);

  if constexpr (kVecPath) {
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    const uint4* wv = reinterpret_cast<const uint4*>(w);
    uint4* yv = reinterpret_cast<uint4*>(yr);
    for (int i = lane; i < d / N; i += 32) {
      float f[N], g[N];
      repro::unpack<T>(xv[i], f);
      repro::unpack<T>(wv[i], g);
#pragma unroll
      for (int j = 0; j < N; ++j) f[j] = f[j] * inv * (offset + g[j]);
      yv[i] = repro::pack<T>(f);
    }
  } else {
    for (int i = lane; i < d; i += 32) {
      const float f = repro::to_float<T>(xr[i]);
      const float g = repro::to_float<T>(w[i]);
      yr[i] = repro::from_float<T>(f * inv * (offset + g));
    }
  }
}

template <typename T>
struct Launcher {
  const T* x;
  const T* w;
  T* out;
  long long rows;
  int d;
  float eps, offset;
  cudaStream_t stream;

  template <int kLanes, int kVPL>
  void reg() const {
    constexpr long long kRows = kWarps * (32 / kLanes);
    const dim3 grid(static_cast<unsigned>((rows + kRows - 1) / kRows));
    rmsnorm_reg_kernel<T, kLanes, kVPL>
        <<<grid, kThreads, 0, stream>>>(x, w, out, rows, d, eps, offset);
  }

  template <bool kVecPath>
  void loop() const {
    const dim3 grid(static_cast<unsigned>((rows + kWarps - 1) / kWarps));
    rmsnorm_loop_kernel<T, kVecPath>
        <<<grid, kThreads, 0, stream>>>(x, w, out, rows, d, eps, offset);
  }

  void operator()(bool vec) const {
    const int nvec = d / repro::kVec<T>;
    if (!vec) return loop<false>();
    if (nvec <= 16) return reg<16, 1>();
    const int per_lane = (nvec + 31) / 32;
    if (per_lane <= 8) return reg<32, 8>();
    if (per_lane <= 16) return reg<32, 16>();
    if (per_lane <= kMaxVecsPerLane) return reg<32, kMaxVecsPerLane>();
    return loop<true>();
  }
};

}  // namespace

// x, out: (rows, d) contiguous; w: (d,).  ``vec`` selects the 16-byte
// paths, which need d a multiple of 16 / sizeof(T) and 16-byte aligned
// pointers (checked by the Python wrapper).  Returns cudaGetLastError().
extern "C" int rmsnorm_fwd(const void* x, const void* w, void* out,
                           long long rows, int d, float eps, float offset,
                           int dtype, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows > 0) {
    if (dtype == repro::kFloat32) {
      Launcher<float>{static_cast<const float*>(x),
                      static_cast<const float*>(w), static_cast<float*>(out),
                      rows, d, eps, offset, s}(vec != 0);
    } else if (dtype == repro::kBFloat16) {
      using bf16 = __nv_bfloat16;
      Launcher<bf16>{static_cast<const bf16*>(x), static_cast<const bf16*>(w),
                     static_cast<bf16*>(out), rows, d, eps, offset, s}(
          vec != 0);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

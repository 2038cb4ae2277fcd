// RMSNorm forward for Hopper: y = x * rsqrt(mean(x^2) + eps) * (offset + w).
//
// Replaces the Pallas TPU kernel src/repro/kernels/rmsnorm.py::rmsnorm
// (_rmsnorm_kernel), which normalises blocks of rows padded to a
// multiple of the block.  Here one warp owns one row, so no padding is
// needed: the grid covers ceil(rows / 4) blocks of four warps.
//
// Bound: bytes.  The kernel reads each row and the weight and writes the
// row, with one fp32 sum of squares and a few flops per element, far
// below the card's ratio of operations to bytes.  So every access is a
// 16-byte vector load or store, neighbouring lanes on neighbouring
// addresses; the second pass over the row (normalise and store) reads it
// again from L1/L2, not from device memory, for the row widths of the
// model zoo (a 2048-wide bf16 row is 4 KB).  Statistics are in fp32 and
// the output has x's dtype, as in the reference.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;

template <typename T, bool kVecPath>
__global__ void __launch_bounds__(kWarps * 32)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ w,
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
void launch(const void* x, const void* w, void* out, long long rows, int d,
            float eps, float offset, int vec, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((rows + kWarps - 1) / kWarps));
  const dim3 block(kWarps * 32);
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  T* op = static_cast<T*>(out);
  if (vec) {
    rmsnorm_kernel<T, true><<<grid, block, 0, stream>>>(xp, wp, op, rows, d,
                                                        eps, offset);
  } else {
    rmsnorm_kernel<T, false><<<grid, block, 0, stream>>>(xp, wp, op, rows, d,
                                                         eps, offset);
  }
}

}  // namespace

// x, out: (rows, d) contiguous; w: (d,).  ``vec`` selects the 16-byte
// path, which needs d a multiple of 16 / sizeof(T) and 16-byte aligned
// pointers (checked by the Python wrapper).  Returns cudaGetLastError().
extern "C" int rmsnorm_fwd(const void* x, const void* w, void* out,
                           long long rows, int d, float eps, float offset,
                           int dtype, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows > 0) {
    if (dtype == repro::kFloat32) {
      launch<float>(x, w, out, rows, d, eps, offset, vec, s);
    } else if (dtype == repro::kBFloat16) {
      launch<__nv_bfloat16>(x, w, out, rows, d, eps, offset, vec, s);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

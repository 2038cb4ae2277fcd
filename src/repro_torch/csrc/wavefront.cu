// The pipeline wavefront of the study's event re-rank, for Hopper.
//
// Replaces the reference's jitted wavefront, _jax_shape_fn in
// src/repro/events/batch.py (a jitted array program, not a Pallas kernel:
// it unrolls the recurrence at trace time into straight-line code per
// shape key), and computes what _wavefront_numpy plus the replay_rows
// epilogue compute.  For record k with the tables (S, L) of its shape key:
//
//   for lv in 0..L-1, for each stage s with ldir[s,lv] >= 0:
//     val = max(dev_end[s], hist[ldep_s[s,lv], ldep_l[s,lv]] or 0)
//           + (ldir == 0 ? tau_f : tau_b)
//     hist[s,lv] = val; dev_end[s] = val
//   body = max_s dev_end[s]
//
// then step_time, bubble, dp_exposed and err from the record's row.
//
// Bound: the dependent chain, not bytes.  A record reads its tables
// (3 x S x L int32, shared by the records of one key) and writes 5 doubles,
// but level lv needs the ends of earlier levels, so the L levels run one
// after another: a shared-memory read, a max, an add and a barrier each.
// The design:
// - One block per record, one thread per stage; dev_end[s] in a register.
// - The block first packs its key's three tables into one int a cell,
//   code = -1 (idle) or ((dep + 1) << 1 | dir), with dep = ldep_l * S +
//   ldep_s the dependency's place in the history (-1: none).  The level
//   loop then has no branch: one read of code, one of the history, a max,
//   an add and selects.
// - Where they fit (S x (L x 12 + 8) bytes: 104 KB at the largest
//   committed shape, S 16 x L 542), the history hist (L x S doubles,
//   level-major so that a level's writes fall in consecutive banks) and
//   the codes live in dynamic shared memory.  The raw tables come in by
//   cp.async, every copy in flight at once, into the space that hist and
//   the codes then take (each code replaces its cell's ldep_l).
// - Larger shapes keep hist and the codes in device-memory scratch that
//   the wrapper allocates (the kShared = false instantiation).
// - One __syncthreads() a level, after its writes: a dependency always
//   lies in an earlier level, so reads and writes of one level never meet.
// - The next level's code is read into a register before this level's
//   barrier, so its latency hides behind it.
// - Mixed shape keys in one launch: the wrapper stacks the batch's unique
//   keys' tables, padded to (S_max, L_max) with -1, and each record carries
//   its key's index; an index outside [0, U) gives a column of NaN.
// Every floating-point step is numpy's: max propagates NaN as np.maximum
// does, and the products and sums are the _rn intrinsics, which the
// compiler never contracts into an FMA.
#include "common.cuh"

namespace {

// np.maximum: NaN if either operand is NaN.
__device__ __forceinline__ double np_max(double a, double b) {
  if (a != a) return a;
  if (b != b) return b;
  return a >= b ? a : b;
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

// n ints from device memory into shared memory, every copy in flight at
// once (16 bytes a copy where both ends and n allow it).
__device__ __forceinline__ void stage_ints(int* dst, const int* src, int n) {
  const bool v16 = n % 4 == 0 && ((reinterpret_cast<uintptr_t>(src) |
                                   reinterpret_cast<uintptr_t>(dst)) &
                                  15) == 0;
  if (v16) {
    for (int i = 4 * threadIdx.x; i < n; i += 4 * blockDim.x)
      repro::cp_async16(dst + i, src + i, true);
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      cp_async4(dst + i, src + i);
  }
}

// Shared memory of the kShared instantiation: ends (S doubles), then hist
// (S x L doubles) and the codes (S x L ints), where the raw tables land
// first (ldir and ldep_s over hist, ldep_l where its codes go).
__host__ __device__ __forceinline__ size_t shared_bytes(int S, int L) {
  return static_cast<size_t>(S) * 8 + static_cast<size_t>(S) * L * 12;
}

template <bool kShared>
__global__ void wavefront_kernel(const int* __restrict__ ldir,
                                 const int* __restrict__ ldep_s,
                                 const int* __restrict__ ldep_l,
                                 const int* __restrict__ key_rows,
                                 const double* __restrict__ rows,
                                 double* __restrict__ out, double* hist_g,
                                 int* code_g, int K, int U, int S, int L) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* const ends = reinterpret_cast<double*>(smem_raw);  // (S,)
  const int k = blockIdx.x;
  const int s = threadIdx.x;
  const int key = key_rows[k];
  if (key < 0 || key >= U) {
    if (s == 0) {
      for (int r = 0; r < 5; ++r)
        out[r * K + k] = __longlong_as_double(0x7ff8000000000000LL);
    }
    return;
  }
  const int SL = S * L;
  const size_t base = static_cast<size_t>(key) * SL;
  double* hist;  // (L, S): the end of the op at (lv, s)
  int* code;     // (S, L): the op at (s, lv), packed
  if constexpr (kShared) {
    hist = ends + S;
    code = reinterpret_cast<int*>(hist + SL);
    int* raw = reinterpret_cast<int*>(hist);
    stage_ints(raw, ldir + base, SL);
    stage_ints(raw + SL, ldep_s + base, SL);
    stage_ints(code, ldep_l + base, SL);
    repro::cp_async_commit();
    repro::cp_async_wait<0>();
    __syncthreads();
    for (int i = threadIdx.x; i < SL; i += blockDim.x) {
      const int d = raw[i], ds = raw[SL + i], dl = code[i];
      code[i] = d < 0 ? -1 : (((ds >= 0 ? dl * S + ds + 1 : 0) << 1) | d);
    }
  } else {
    hist = hist_g + static_cast<size_t>(k) * SL;
    code = code_g + static_cast<size_t>(k) * SL;
    for (int i = threadIdx.x; i < SL; i += blockDim.x) {
      const int d = ldir[base + i], ds = ldep_s[base + i];
      const int dl = ldep_l[base + i];
      code[i] = d < 0 ? -1 : (((ds >= 0 ? dl * S + ds + 1 : 0) << 1) | d);
    }
  }
  __syncthreads();
  const bool on = s < S;  // this thread runs stage s
  const int* my = code + static_cast<size_t>(on ? s : 0) * L;
  const double tau_f = rows[k];
  const double tau_b = rows[K + k];

  double dev_end = 0.0;
  int c = on ? my[0] : -1;
  for (int lv = 0; lv < L; ++lv) {
    const int next = on && lv + 1 < L ? my[lv + 1] : -1;
    const int dep = (c >> 1) - 1;  // c == -1 gives -2: no dependency
    const double h = hist[dep >= 0 ? dep : 0];
    const double v = __dadd_rn(np_max(dev_end, dep >= 0 ? h : 0.0),
                               (c & 1) ? tau_b : tau_f);
    const bool act = c >= 0;
    dev_end = act ? v : dev_end;
    if (on) hist[static_cast<size_t>(lv) * S + s] = act ? v : 0.0;
    __syncthreads();
    c = next;
  }
  if (on) ends[s] = dev_end;
  __syncthreads();
  if (s != 0) return;

  double body = ends[0];
  for (int i = 1; i < S; ++i) body = np_max(body, ends[i]);
  const double t_dp = rows[2 * K + k];
  const double credit = rows[3 * K + k];
  const double nmv = rows[4 * K + k];
  const double analytic = rows[5 * K + k];
  const double busy = __dmul_rn(nmv, __dadd_rn(tau_f, tau_b));
  const double bubble =
      busy > 0.0 ? __dsub_rn(__ddiv_rn(body, busy), 1.0) : 0.0;
  double dp_exposed = np_max(__dsub_rn(t_dp, credit), 0.0);
  dp_exposed = t_dp > 0.0 ? dp_exposed : 0.0;
  const double step = __dadd_rn(body, dp_exposed);
  out[k] = step;
  out[K + k] = body;
  out[2 * K + k] = bubble;
  out[3 * K + k] = dp_exposed;
  out[4 * K + k] = __ddiv_rn(__dsub_rn(step, analytic), analytic);
}

}  // namespace

// Dynamic shared memory of a block that keeps its history and codes
// there (the wrapper compares it with the card's limit).
extern "C" long long wavefront_shared_bytes(int S, int L) {
  return static_cast<long long>(shared_bytes(S, L));
}

// ldir, ldep_s, ldep_l: (U, S, L) int32; key_rows: (K,) int32; rows:
// (6, K) float64; out: (5, K) float64.  hist and code: null to keep both
// in shared memory (wavefront_shared_bytes(S, L) of it), else scratch of
// K x S x L float64 and int32, with S doubles of shared memory.  threads:
// S rounded up to a multiple of 32, at most 1024; S x L below 2^30.
extern "C" int wavefront_fwd(const void* ldir, const void* ldep_s,
                             const void* ldep_l, const void* key_rows,
                             const void* rows, void* out, void* hist,
                             void* code, int K, int U, int S, int L,
                             int threads, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* a = static_cast<const int*>(ldir);
  const int* b = static_cast<const int*>(ldep_s);
  const int* c = static_cast<const int*>(ldep_l);
  const int* kr = static_cast<const int*>(key_rows);
  const double* r = static_cast<const double*>(rows);
  double* o = static_cast<double*>(out);
  if (K <= 0) return static_cast<int>(cudaGetLastError());
  if (hist == nullptr) {
    const int bytes = static_cast<int>(shared_bytes(S, L));
    cudaError_t e = cudaFuncSetAttribute(
        wavefront_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    wavefront_kernel<true><<<K, threads, bytes, st>>>(
        a, b, c, kr, r, o, nullptr, nullptr, K, U, S, L);
  } else {
    wavefront_kernel<false><<<K, threads, S * sizeof(double), st>>>(
        a, b, c, kr, r, o, static_cast<double*>(hist),
        static_cast<int*>(code), K, U, S, L);
  }
  return static_cast<int>(cudaGetLastError());
}

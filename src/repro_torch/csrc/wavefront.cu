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
// Bound: the dependent chain, not bytes.  A record reads its key's tables
// and writes 5 doubles, but level lv needs the ends of earlier levels, so
// the L levels run one after another: a shared-memory read, a max, an add
// and a barrier each.  The design keeps everything else off that chain:
// - Two kernels a launch.  wavefront_pack_kernel, one thread a cell, packs
//   each unique key's three tables once into one int a cell, level-major
//   (U, L, S): code = -1 (idle) or ((dep + 1) << 1 | dir), with dep =
//   ldep_l * S + ldep_s the dependency's place in the history (-1: none).
//   The records of one key read the same codes, and no record packs.
// - wavefront_kernel: a record runs on S threads rounded up to a warp,
//   one a stage, dev_end[s] in a register.  Where S <= 32 a record is one
//   warp and a block holds up to kMaxRecords of them, so the barrier of a
//   level is a __syncwarp; past 32 stages a record is a block and the
//   barrier __syncthreads.
// - Where it fits (S x (12 L + 8) bytes: 104 KB at the largest committed
//   shape, S 16 x L 542), a record's history (L x S doubles, level-major
//   so that a level's writes fall in consecutive banks) and its key's
//   codes (one cp.async copy of L x S ints, every copy in flight at once)
//   live in dynamic shared memory; the next level's code is read before
//   this level's barrier, so its latency hides behind it.
// - Larger shapes keep the history in device-memory scratch that the
//   wrapper allocates (the kShared = false instantiation) and load the
//   codes into registers kChunk levels at a time.
// - A level is branch-free: one code, one double of the history, a max,
//   an add and selects.  A dependency always lies in an earlier level, so
//   the reads and writes of one level never meet: one barrier a level,
//   after its writes.
// - Mixed shape keys in one launch: the wrapper stacks the batch's unique
//   keys' tables, padded to (S_max, L_max) with -1, and each record carries
//   its key's index; an index outside [0, U) gives a column of NaN.
// Every floating-point step is numpy's: max propagates NaN as np.maximum
// does, and the products and sums are the _rn intrinsics, which the
// compiler never contracts into an FMA.
#include "common.cuh"   // cp.async
#include "hopper.cuh"   // once_per_device, current_device

namespace {

// np.maximum: NaN if either operand is NaN (a's if both are).
__device__ __forceinline__ double np_max(double a, double b) {
  return (a >= b || a != a) ? a : b;
}

constexpr int kMaxRecords = 4;   // records (warps) a block, S <= 32
// Where a record's history is in shared memory, its codes are staged
// there too (true), or read as the device-memory route reads them
// (false): staged, the mixed keys' case ran in 0.039 ms of device time
// against 0.052 (launch/wavefront_variants.py).
constexpr bool kStageCodes = true;
// Levels of codes a thread loads into registers at once where they are
// not staged: a level's barrier waited for every load in flight (codes
// loaded 8 levels ahead took ~470 cycles a level), so they come a chunk
// at a time, one wait a chunk.
constexpr int kChunk = 32;

// Shared memory of one record of the kShared instantiation: its ends (S
// doubles), its history (L x S doubles), and its codes (L x S ints) where
// they are staged.
__host__ __device__ __forceinline__ size_t shared_bytes(int S, int L) {
  return static_cast<size_t>(S) * 8 +
         static_cast<size_t>(S) * L * (kStageCodes ? 12 : 8);
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

// code[u, lv, s] from the (U, S, L) tables, one thread a cell.
__global__ void wavefront_pack_kernel(const int* __restrict__ ldir,
                                      const int* __restrict__ ldep_s,
                                      const int* __restrict__ ldep_l,
                                      int* __restrict__ code, int U, int S,
                                      int L) {
  const long long SL = static_cast<long long>(S) * L;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= U * SL) return;
  const long long u = i / SL;
  const int lv = static_cast<int>((i % SL) / S), s = static_cast<int>(i % S);
  const long long src = u * SL + static_cast<long long>(s) * L + lv;
  const int d = ldir[src], ds = ldep_s[src], dl = ldep_l[src];
  code[i] = d < 0 ? -1 : (((ds >= 0 ? dl * S + ds + 1 : 0) << 1) | d);
}

// One level of stage s: the op's end from its code, the stage's last end
// and the history; written to the history (0 where the stage is idle).
__device__ __forceinline__ void level(int c, int lv, int s, int S, bool on,
                                      double tau_f, double tau_b,
                                      double* hist, double& dev_end) {
  const int dep = (c >> 1) - 1;  // c == -1 gives -2: no dependency
  const double h = hist[dep >= 0 ? dep : 0];
  const double v = __dadd_rn(np_max(dev_end, dep >= 0 ? h : 0.0),
                             (c & 1) ? tau_b : tau_f);
  const bool act = c >= 0;
  dev_end = act ? v : dev_end;
  if (on) hist[static_cast<size_t>(lv) * S + s] = act ? v : 0.0;
}

template <bool kShared>
__global__ void wavefront_kernel(const int* __restrict__ code,
                                 const int* __restrict__ key_rows,
                                 const double* __restrict__ rows,
                                 double* __restrict__ out, double* hist_g,
                                 int K, int U, int S, int L, int rt) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int slot = threadIdx.x / rt;         // this block's record
  const int s = threadIdx.x % rt;            // this thread's stage
  const int k = blockIdx.x * (blockDim.x / rt) + slot;
  if (k >= K) return;                        // a whole warp: rt == 32 here
  const bool warp_record = rt == 32;
  auto sync = [warp_record] {
    if (warp_record) {
      __syncwarp();
    } else {
      __syncthreads();   // one record a block
    }
  };
  const int key = key_rows[k];
  if (key < 0 || key >= U) {
    if (s == 0) {
      for (int r = 0; r < 5; ++r)
        out[r * K + k] = __longlong_as_double(0x7ff8000000000000LL);
    }
    return;
  }
  const size_t SL = static_cast<size_t>(S) * L;
  double* const ends = reinterpret_cast<double*>(
      smem_raw + slot * (kShared ? shared_bytes(S, L) : S * sizeof(double)));
  double* const hist = kShared ? ends + S : hist_g + k * SL;  // (L, S)
  const bool on = s < S;  // this thread runs stage s
  const int* const key_code = code + key * SL;   // (L, S)
  const double tau_f = rows[k];
  const double tau_b = rows[K + k];
  double dev_end = 0.0;

  if constexpr (kShared && kStageCodes) {
    // the key's codes into shared memory, every copy in flight at once
    // (16 bytes a copy where both ends and the count allow it)
    int* const codes = reinterpret_cast<int*>(hist + SL);
    if (SL % 4 == 0 && ((reinterpret_cast<uintptr_t>(codes) |
                         reinterpret_cast<uintptr_t>(key_code)) & 15) == 0) {
      for (size_t i = 4 * s; i < SL; i += 4 * rt)
        repro::cp_async16(codes + i, key_code + i, true);
    } else {
      for (size_t i = s; i < SL; i += rt) cp_async4(codes + i, key_code + i);
    }
    repro::cp_async_commit();
    repro::cp_async_wait<0>();
    sync();
    const int* my = codes + (on ? s : 0);   // (lv, s) at my[lv * S]
    int c = on ? my[0] : -1;
    for (int lv = 0; lv < L; ++lv) {
      const int next = on && lv + 1 < L ? my[(lv + 1) * S] : -1;
      level(c, lv, s, S, on, tau_f, tau_b, hist, dev_end);
      sync();
      c = next;
    }
  } else {
    const int* my = key_code + (on ? s : 0);
    for (int lv0 = 0; lv0 < L; lv0 += kChunk) {
      int cc[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j)
        cc[j] = on && lv0 + j < L ? __ldg(my + (lv0 + j) * S) : -1;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        if (lv0 + j < L) {   // the same for every thread of the record
          level(cc[j], lv0 + j, s, S, on, tau_f, tau_b, hist, dev_end);
          sync();
        }
      }
    }
  }
  if (on) ends[s] = dev_end;
  sync();
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

// The device's opt-in shared memory a block, set once as the kShared
// kernel's limit.
int shared_limit(int dev) {
  return repro::once_per_device(dev, [dev] {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev) != cudaSuccess ||
        cudaFuncSetAttribute(wavefront_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             n) != cudaSuccess) {
      return -1;
    }
    return n;
  });
}

}  // namespace

// Dynamic shared memory of one record that keeps its history there (the
// wrapper compares it with the card's limit).
extern "C" long long wavefront_shared_bytes(int S, int L) {
  return static_cast<long long>(shared_bytes(S, L));
}

// ldir, ldep_s, ldep_l: (U, S, L) int32; key_rows: (K,) int32; rows:
// (6, K) float64; out: (5, K) float64; code: scratch of U x S x L int32
// for the packed codes.  hist: null to keep each record's history in
// shared memory (wavefront_shared_bytes(S, L) of it), else scratch of K x
// S x L float64.  S at most 1024, S x L below 2^30.
extern "C" int wavefront_fwd(const void* ldir, const void* ldep_s,
                             const void* ldep_l, const void* key_rows,
                             const void* rows, void* out, void* hist,
                             void* code, int K, int U, int S, int L,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* kr = static_cast<const int*>(key_rows);
  const double* r = static_cast<const double*>(rows);
  double* o = static_cast<double*>(out);
  int* c = static_cast<int*>(code);
  if (K <= 0) return static_cast<int>(cudaGetLastError());
  if (S <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long cells = static_cast<long long>(U) * S * L;
  if (cells > 0) {
    wavefront_pack_kernel<<<static_cast<unsigned>((cells + 255) / 256), 256,
                            0, st>>>(static_cast<const int*>(ldir),
                                     static_cast<const int*>(ldep_s),
                                     static_cast<const int*>(ldep_l), c, U,
                                     S, L);
  }
  const int rt = 32 * ((S + 31) / 32);   // threads a record
  int records = 1;                        // records a block
  if (hist == nullptr) {
    int dev = 0;
    int err = repro::current_device(&dev);
    if (err) return err;
    const int limit = shared_limit(dev);
    if (limit < 0) return static_cast<int>(cudaErrorInvalidValue);
    const long long per = static_cast<long long>(shared_bytes(S, L));
    if (rt == 32) {
      records = static_cast<int>(limit / per < kMaxRecords ? limit / per
                                                           : kMaxRecords);
    }
    if (records < 1 || per > limit) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    wavefront_kernel<true><<<(K + records - 1) / records, rt * records,
                             static_cast<size_t>(per) * records, st>>>(
        c, kr, r, o, nullptr, K, U, S, L, rt);
  } else {
    if (rt == 32) records = kMaxRecords;
    wavefront_kernel<false><<<(K + records - 1) / records, rt * records,
                              S * sizeof(double) * records, st>>>(
        c, kr, r, o, static_cast<double*>(hist), K, U, S, L, rt);
  }
  return static_cast<int>(cudaGetLastError());
}

// Grouped matmul for MoE expert FFNs on Hopper: out[r] = x[r] @ w[e(r)],
// where the rows of x are sorted by expert and cut into blocks of
// ``block_t`` rows, each block owned by the one expert that
// ``block_group_ids`` names.  fp32 accumulation, output in x's dtype.
// An id outside [0, E) gives NaN rows.
//
// Replaces the Pallas TPU kernel src/repro/kernels/moe_gmm.py::moe_gmm
// (_gmm_kernel).  The Pallas kernel walks a grid (T/bt, N/bn, K/bk) in
// order, carries the sum over K in VMEM scratch from one grid step to
// the next and picks each step's weight block by a scalar-prefetched
// expert id.  Here a block of threads owns whole (rows x BN) output
// tiles: it reads the tile's expert id itself, loops over K with the sum
// in registers, and stores the tile once.  A tile never straddles two
// row blocks, so it never straddles two experts, and an expert that owns
// no row block is never read.
//
// Bound: operations at the prefill shapes (Qwen3-MoE: 81,920 rows x 4096
// x 1536, ~1 TFLOP a launch against 1.6 GB of weights), bytes at decode
// (1,024 rows: every expert's weights, 1.6 GB, are read for 8 rows each,
// ~8 operations a byte against the card's ~295).
//
// Which kernel a call reaches (the wrapper, kernels/moe_gmm.py::
// kernel_for, picks it and passes its code):
// - bfloat16, block_t 64 or 128 (prefill): gmm_wgmma_kernel, on what
//   Hopper adds for the tensor cores.  A persistent grid of one block of
//   three warpgroups per SM walks the output tiles (BT x 256).  One thread
//   of the producer warpgroup reads each tile's expert id and keeps TMA
//   loads in flight through a ring of stages of 64-deep K: a (64 x BT) box
//   of x from a 2D map over (K, T), and four (64 x 64) boxes of the
//   expert's weight from a 3D map over w's (N, K, E), the expert picked by
//   the third coordinate.  Both arrive 128-byte swizzled; K and N past
//   their ends arrive as zeros, so ragged K and N need no masked load.
//   The two consumer warpgroups run wgmma m64nNk16 from shared memory (x
//   K-major, the weight MN-major as it lies in w) into fp32 registers:
//   at block_t 128 each owns 64 rows of the tile, at 64 each owns half
//   of its columns.  setmaxnreg moves registers from the producer (40) to
//   the consumers (232).  The epilogue rounds to bf16 into shared memory
//   and one thread per warpgroup stores it with TMA, so the write of one
//   tile runs under the products of the next, whose first stages the
//   producer has already loaded.  The tiles are walked a group of row
//   blocks at a time, row blocks fastest within the group, so the blocks
//   in flight share a few experts' weights in L2; the launch sizes the
//   group from the number of column tiles (1: columns fastest).
// - bfloat16, block_t 8, 16 or 32 (decode): gmm_decode_kernel, built for
//   the bytes.  A persistent grid (kDecodeBlocksPerSm blocks a SM) walks
//   the (row block, 256-column tile) items, columns fastest.  One producer
//   thread keeps TMA loads in flight through a ring of 64-deep K stages
//   that runs on across items: a (64 x BT) box of x and four (64 x 64)
//   boxes of the expert's weight through the same maps as the prefill's,
//   so each weight row arrives 512 contiguous bytes at a time, and the
//   next item's weights stream while this item's epilogue stores.  The
//   ring is as deep as shared memory allows (Little's law in DecTile).
//   Eight consumer warps each own 32 columns of an item and run mma.sync
//   m16n8k16 on the transposed product, out^T = w^T x^T: the weight tile
//   is the 16-row operand (ldmatrix.trans from the swizzled rows) and the
//   row block's 8-32 rows the n8 side, so no padding row is multiplied.
//   Compute is idle at decode (~25 TFLOP/s), so mma.sync is enough.
// - float32, any block_t: gmm_fma_kernel on the FMA pipes (a 16 x 64
//   thread grid of register tiles), so fp32 products stay in fp32: no
//   TF32.  It indexes tiles columns fastest: the blocks in flight share
//   one row block of x and the few experts whose weights they read.
#include <climits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kThreads = 128;


__device__ __forceinline__ float nan_f() {
  return __int_as_float(0x7fc00000);
}

// ---------------------------------------------------------------------------
// bfloat16 prefill: wgmma + TMA
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;
using repro::pack_bf16;

// A tile of BT rows (one row block) x BN columns.  Two consumer
// warpgroups each own a 64 x kWgN part of it; a stage holds 64-deep K
// slices of x (BT x 64) and of the expert's weight (64 x BN), and the
// finished tile leaves through a bf16 copy in shared memory (kCBytes) as
// 64 x 64 boxes.
template <int BT, int BN>
struct WgTile {
  static_assert(BT == 64 || BT == 128, "row tiles of one or two wgmma rows");
  static_assert(BN % 64 == 0, "64-column weight slabs");
  static constexpr int kBK = 64;                     // one 128-byte row
  static constexpr int kSlabs = BN / 64;
  static constexpr int kWgN = BT == 128 ? BN : BN / 2;
  static constexpr int kABytes = BT * kBK * 2;
  static constexpr int kBBytes = kBK * BN * 2;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kCBytes = BT * BN * 2;
  // as many stages as the 227 KB a block may use holds beside the rest
  static constexpr int kStages =
      (232448 - 1024 - kCBytes - 256) / kStageBytes;
  static constexpr int kThreads = 3 * 128;
  // setmaxnreg: what the producer warpgroup keeps and the consumers take;
  // the block's pool (168 a thread at 384 threads) holds exactly both
  static constexpr int kProducerRegs = 40;
  static constexpr int kConsumerRegs = 232;
  static constexpr size_t kSmemBytes = 1024 +
      static_cast<size_t>(kStages) * kStageBytes + kCBytes + 2 * kStages * 8;
};

struct GmmMaps {
  CUtensorMap x;     // (K, T) bf16, boxes of 64 x BT
  CUtensorMap w;     // (N, K, E) bf16, boxes of 64 x 64 x 1
  CUtensorMap out;   // (N, T) bf16, boxes of 64 x 64
};

struct GmmShape {
  int t_blocks;     // row blocks (T / BT)
  int n_tiles;      // column tiles (N / BN, rounded up)
  int k_steps;      // 64-deep K slices (K / 64, rounded up)
  int n, e;
  int tile_group;   // row blocks walked together
};

// Output tile i -> (row block, column tile): groups of ``tile_group`` row
// blocks; within a group the column tile, then the row block fastest.
__device__ __forceinline__ void gmm_tile(int i, const GmmShape& g, int& rb,
                                         int& nt) {
  const int per = g.tile_group * g.n_tiles;
  const int rb0 = (i / per) * g.tile_group, r = i % per;
  const int size = min(g.tile_group, g.t_blocks - rb0);
  nt = r / size;
  rb = rb0 + r % size;
}

template <int BT, int BN>
__global__ void __launch_bounds__(WgTile<BT, BN>::kThreads, 1)
gmm_wgmma_kernel(const __grid_constant__ GmmMaps maps,
                 const int* __restrict__ gids, bf16* __restrict__ out,
                 GmmShape g) {
  using P = WgTile<BT, BN>;
  constexpr int kSt = P::kStages;
  extern __shared__ unsigned char smem_raw[];
  // 128-byte swizzled tiles want 1024-byte aligned atoms
  unsigned char* base =
      smem_raw + ((1024 - (repro::smem_u32(smem_raw) & 1023)) & 1023);
  bf16* As = reinterpret_cast<bf16*>(base);
  bf16* Bs = reinterpret_cast<bf16*>(base + kSt * P::kABytes);
  bf16* Cs = reinterpret_cast<bf16*>(base + kSt * P::kStageBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + kSt * P::kStageBytes +
                                               P::kCBytes);
  uint64_t* empty = full + kSt;
  const int n_tiles = g.t_blocks * g.n_tiles;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kSt; ++i) {
      repro::mbar_init(full + i, 1);
      repro::mbar_init(empty + i, 256);
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
      int it = 0;   // stages issued so far: ring slot and round
      for (int i = blockIdx.x; i < n_tiles; i += gridDim.x) {
        int rb, nt;
        gmm_tile(i, g, rb, nt);
        const int e = gids[rb];
        if (e < 0 || e >= g.e) continue;   // NaN rows: nothing to load
        for (int kt = 0; kt < g.k_steps; ++kt, ++it) {
          const int st = it % kSt, round = it / kSt;
          if (round > 0) repro::mbar_wait(empty + st, (round - 1) & 1);
          // boxes past K or N count in full: TMA writes their zeros
          repro::mbar_expect_tx(full + st, P::kStageBytes);
          repro::tma_load_2d(As + st * (P::kABytes / 2), &maps.x, full + st,
                             kt * P::kBK, rb * BT);
          for (int c = 0; c < P::kSlabs; ++c)
            repro::tma_load_3d(Bs + st * (P::kBBytes / 2) + c * 64 * 64,
                               &maps.w, full + st, nt * BN + c * 64,
                               kt * P::kBK, e);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        P::kConsumerRegs));
    // consumers: warpgroup wg owns rows 64 wg .. +63 of a 128-row tile, or
    // columns kWgN wg .. +kWgN-1 of a 64-row tile
    const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
    const int gq = lane / 4, t = lane % 4;
    const int a_row = BT == 128 ? 64 * wg : 0;
    const int b_col = BT == 128 ? 0 : P::kWgN * wg;
    bf16* Cw = Cs + wg * 64 * P::kWgN;   // this warpgroup's 64-column slabs
    const bool storer = threadIdx.x % 128 == 0;
    int it = 0;
    for (int i = blockIdx.x; i < n_tiles; i += gridDim.x) {
      int rb, nt;
      gmm_tile(i, g, rb, nt);
      const int e = gids[rb];
      // this lane's rows: row and row + 8; its columns col0 + 8 j + 2 t, +1
      const long long row =
          static_cast<long long>(rb) * BT + a_row + warp * 16 + gq;
      const int col0 = nt * BN + b_col;
      if (e < 0 || e >= g.e) {
        // an id outside [0, E): NaN rows, so any check of the output sees it
        const uint32_t nan2 = pack_bf16(nan_f(), nan_f());
#pragma unroll
        for (int r = 0; r < 2; ++r)
          for (int j = 0; j < P::kWgN / 8; ++j) {
            const int col = col0 + 8 * j + 2 * t;
            if (col < g.n)
              *reinterpret_cast<uint32_t*>(out + (row + 8 * r) * g.n + col) =
                  nan2;
          }
        continue;
      }

      float acc[P::kWgN / 2];
#pragma unroll
      for (int j = 0; j < P::kWgN / 2; ++j) acc[j] = 0.f;
      for (int kt = 0; kt < g.k_steps; ++kt, ++it) {
        const int st = it % kSt;
        const bf16* At = As + st * (P::kABytes / 2) + a_row * 64;
        const bf16* Bt = Bs + st * (P::kBBytes / 2) + b_col * 64;
        repro::mbar_wait(full + st, (it / kSt) & 1);
        // x K-major: 16-deep steps 32 B apart in a row; the weight
        // MN-major: 16-row steps 2048 B apart, 8-row groups 1024 B apart,
        // 64-column slabs 8192 B apart
        repro::wgmma_fence();
#pragma unroll
        for (int kq = 0; kq < P::kBK / 16; ++kq)
          repro::wgmma_ss_mn<P::kWgN>(
              acc, repro::wgmma_desc(At + kq * 16, 16, 1024),
              repro::wgmma_desc(Bt + kq * 16 * 64, 64 * 128, 1024), 1);
        repro::wgmma_commit();
        // the stage before this one is read: give it back to the producer
        repro::wgmma_wait<1>();
        if (kt > 0) repro::mbar_arrive(empty + (it - 1) % kSt);
      }
      repro::wgmma_wait<0>();
#pragma unroll
      for (int j = 0; j < P::kWgN / 2; ++j) repro::fence_reg(acc[j]);
      if (g.k_steps > 0) repro::mbar_arrive(empty + (it - 1) % kSt);

      // epilogue: bf16 into this warpgroup's slabs, 128-byte swizzled as
      // the out map reads them (a warp's 8 rows x 4 lanes hit 32 banks),
      // once the previous tile's stores have read them; then one thread
      // stores the slabs with TMA and the next tile starts while they go
      if (storer) repro::bulk_wait_read<0>();
      repro::named_barrier(1 + wg, 128);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int rr = warp * 16 + gq + 8 * r;   // row in the slab; % 8 = gq
#pragma unroll
        for (int j = 0; j < P::kWgN / 8; ++j) {
          unsigned char* slab =
              reinterpret_cast<unsigned char*>(Cw + (j / 8) * 64 * 64);
          *reinterpret_cast<uint32_t*>(slab + rr * 128 +
                                       (((j % 8) ^ gq) << 4) + 4 * t) =
              pack_bf16(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
        }
      }
      repro::fence_proxy_async();
      repro::named_barrier(1 + wg, 128);
      if (storer) {
        const int row0 = rb * BT + a_row;
        for (int c = 0; c < P::kWgN / 64; ++c)
          if (col0 + 64 * c < g.n)   // the map drops columns past N
            repro::tma_store_2d(&maps.out, Cw + c * 64 * 64, col0 + 64 * c,
                                row0);
        repro::bulk_commit();
      }
    }
    if (storer) repro::bulk_wait<0>();
  }
}

// ---------------------------------------------------------------------------
// bfloat16 decode: a persistent grid fed by TMA, mma.sync consumers
// ---------------------------------------------------------------------------
// Column tiles of the decode kernel: 256 columns are 512 contiguous bytes
// of each weight row (four 128-byte TMA boxes side by side).
constexpr int kDecodeBN = 256;
// Persistent blocks a SM: one holds the whole ring (two, each with half of
// it, read no faster once the stages are given back behind a proxy fence;
// launch/gmm_variants.py --decode).
constexpr int kDecodeBlocksPerSm = 1;

// An item is (row block, BN-column tile); a stage holds a 64-deep K slice
// of the row block's x (BT x 64) and of the expert's weight (64 x BN, as
// BN / 64 boxes of 64 x 64), both 128-byte swizzled.  Eight consumer
// warps each own BN / 8 columns of the item and all its BT rows; one
// producer warp issues the loads.
template <int BT, int BN>
struct DecTile {
  static_assert(BT == 8 || BT == 16 || BT == 32, "decode row tiles");
  static_assert(BN % 128 == 0, "16 columns or more a consumer warp");
  static constexpr int kBK = 64;                     // one 128-byte row
  static constexpr int kSlabs = BN / 64;
  static constexpr int kConsumerWarps = 8;
  static constexpr int kThreads = 32 * (kConsumerWarps + 1);
  static constexpr int kWarpN = BN / kConsumerWarps;   // columns of a warp
  static constexpr int kMT = kWarpN / 16;   // m16 tiles: columns of a warp
  static constexpr int kNT = BT / 8;        // n8 tiles: the row block's rows
  static constexpr int kABytes = BT * kBK * 2;
  static constexpr int kBBytes = kBK * BN * 2;
  static constexpr int kStageBytes = kABytes + kBBytes;
  // Little's law: at ~1 us of HBM latency under load (an assumption; the
  // card's is not measured here) each of the 132 SMs must keep 3.35 TB/s
  // x 1 us / 132 = 25 KB in flight to draw its share of the bandwidth.
  // The ring takes what shared memory holds (6 stages of 33-37 KB at BN
  // 256), so 5 stages, ~170 KB, are in flight while one is read: ~7x the
  // share, which lets the SMs still working at the tail of a launch draw
  // the bandwidth the finished ones leave.
  static constexpr int kStages =
      (232448 / kDecodeBlocksPerSm - 1024 - 256) / kStageBytes;
  static_assert(kStages >= 2, "a ring of two stages at least");
  static constexpr size_t kSmemBytes =
      1024 + static_cast<size_t>(kStages) * kStageBytes + 2 * kStages * 8;
};

struct DecodeMaps {
  CUtensorMap x;     // (K, T) bf16, boxes of 64 x BT
  CUtensorMap w;     // (N, K, E) bf16, boxes of 64 x 64 x 1
};

// out[r, c] = sum_k x[r, k] w[e, k, c], computed transposed: the weight
// tile is mma's A operand (16 columns x 16 of K, read with ldmatrix.trans
// from the K-major rows TMA wrote) and the row block's x its B operand (8
// rows x 16 of K), so the BT rows fill mma's n8 side and no padding row is
// multiplied.
template <int BT, int BN>
__global__ void __launch_bounds__(DecTile<BT, BN>::kThreads,
                                  kDecodeBlocksPerSm)
gmm_decode_kernel(const __grid_constant__ DecodeMaps maps,
                  const int* __restrict__ gids, bf16* __restrict__ out,
                  GmmShape g) {
  using P = DecTile<BT, BN>;
  constexpr int kSt = P::kStages;
  extern __shared__ unsigned char smem_raw[];
  // 128-byte swizzled boxes want 1024-byte aligned atoms
  unsigned char* base =
      smem_raw + ((1024 - (repro::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + kSt * P::kStageBytes);
  uint64_t* empty = full + kSt;
  const int n_items = g.t_blocks * g.n_tiles;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kSt; ++i) {
      repro::mbar_init(full + i, 1);
      repro::mbar_init(empty + i, 32 * P::kConsumerWarps);
    }
    repro::mbar_fence_init();
  }
  __syncthreads();

  if (warp == P::kConsumerWarps) {
    // producer: one thread keeps the ring full.  The ring runs on across
    // items, so the next item's weights stream while this one's epilogue
    // stores, and no block drains before its last item.
    if (lane == 0) {
      int it = 0;   // stages issued so far: ring slot and round
      for (int i = blockIdx.x; i < n_items; i += gridDim.x) {
        const int rb = i / g.n_tiles, nt = i % g.n_tiles;
        const int e = gids[rb];
        if (e < 0 || e >= g.e) continue;   // NaN rows: nothing to load
        for (int kt = 0; kt < g.k_steps; ++kt, ++it) {
          const int st = it % kSt, round = it / kSt;
          if (round > 0) repro::mbar_wait(empty + st, (round - 1) & 1);
          unsigned char* s = base + st * P::kStageBytes;
          // boxes past K or N count in full: TMA writes their zeros
          repro::mbar_expect_tx(full + st, P::kStageBytes);
          repro::tma_load_2d(s, &maps.x, full + st, kt * P::kBK, rb * BT);
          for (int c = 0; c < P::kSlabs; ++c)
            repro::tma_load_3d(s + P::kABytes + c * P::kBK * 128, &maps.w,
                               full + st, nt * BN + c * 64, kt * P::kBK, e);
        }
      }
    }
    return;
  }

  // consumers: warp ``warp`` owns columns wn0 .. wn0 + kWarpN - 1 of an item
  const int wn0 = warp * P::kWarpN;
  const int gq = lane / 4, t = lane % 4;
  // ldmatrix: lanes 8q .. 8q + 7 give the rows of matrix q
  const int q = lane / 8, r8 = lane % 8;
  int it = 0;
  for (int i = blockIdx.x; i < n_items; i += gridDim.x) {
    const int rb = i / g.n_tiles, nt = i % g.n_tiles;
    const int e = gids[rb];
    const long long row0 = static_cast<long long>(rb) * BT;
    const int col0 = nt * BN + wn0;
    if (e < 0 || e >= g.e) {
      // an id outside [0, E): NaN rows, so any check of the output sees it
      const uint32_t nan2 = pack_bf16(nan_f(), nan_f());
      for (int v = lane; v < BT * P::kWarpN / 2; v += 32) {
        const int c = col0 + 2 * (v % (P::kWarpN / 2));
        if (c < g.n)
          *reinterpret_cast<uint32_t*>(
              out + (row0 + v / (P::kWarpN / 2)) * g.n + c) = nan2;
      }
      continue;
    }

    float acc[P::kMT][P::kNT][4];
#pragma unroll
    for (int m = 0; m < P::kMT; ++m)
#pragma unroll
      for (int j = 0; j < P::kNT; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[m][j][v] = 0.f;

    for (int kt = 0; kt < g.k_steps; ++kt, ++it) {
      const int st = it % kSt;
      const unsigned char* xs = base + st * P::kStageBytes;
      const unsigned char* ws = xs + P::kABytes;
      repro::mbar_wait(full + st, (it / kSt) & 1);
#pragma unroll
      for (int kk = 0; kk < P::kBK; kk += 32) {
        // B: x rows 8j + r8, K kk + 8q .. +7 (two 16-deep steps); row r of
        // a swizzled box holds 16-byte chunk c at (c ^ (r % 8))
        uint32_t b[P::kNT][4];
#pragma unroll
        for (int j = 0; j < P::kNT; ++j)
          repro::ldmatrix_x4(b[j], xs + (8 * j + r8) * 128 +
                                       (((kk / 8 + q) ^ r8) << 4));
#pragma unroll
        for (int s2 = 0; s2 < 2; ++s2) {
          // A: weight rows (K) k16 + 8 (q / 2) + r8, columns 8 (q % 2) on
          const int kr = kk + 16 * s2 + 8 * (q / 2) + r8;
#pragma unroll
          for (int m = 0; m < P::kMT; ++m) {
            const int col = wn0 + 16 * m + 8 * (q % 2);
            uint32_t a[4];
            repro::ldmatrix_x4_trans(
                a, ws + (col / 64) * (P::kBK * 128) + kr * 128 +
                       ((((col % 64) / 8) ^ (kr % 8)) << 4));
#pragma unroll
            for (int j = 0; j < P::kNT; ++j)
              repro::mma_bf16(acc[m][j], a, &b[j][2 * s2]);
          }
        }
      }
      // give the stage back: the proxy fence orders this thread's ldmatrix
      // reads (generic proxy) before the TMA writes (async proxy) that the
      // producer issues once every consumer has arrived.  Without it, two
      // blocks a SM (3-stage rings) gave outputs that changed from call to
      // call at block_t 16 and 32 (gmm_variants.py --decode --repeat).
      repro::fence_proxy_async();
      repro::mbar_arrive(empty + st);
    }

    // epilogue: acc[m][j] holds out^T at columns col0 + 16 m + gq (+ 8 for
    // v 2, 3), rows 8 j + 2 t (+ 1 for v 1, 3).  Lanes gq and gq ^ 1 swap
    // one value, so each holds two adjacent columns of one row: bf16 pairs.
    // N % 8 == 0, so a pair is wholly inside N or wholly past it.
    const bool odd = gq & 1;
#pragma unroll
    for (int m = 0; m < P::kMT; ++m)
#pragma unroll
      for (int j = 0; j < P::kNT; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float lo = acc[m][j][2 * h], hi = acc[m][j][2 * h + 1];
          const float got = __shfl_xor_sync(0xffffffffu, odd ? lo : hi, 4);
          const int c = col0 + 16 * m + 8 * h + (gq & ~1);
          const long long r = row0 + 8 * j + 2 * t + (odd ? 1 : 0);
          if (c < g.n)
            *reinterpret_cast<uint32_t*>(out + r * g.n + c) =
                odd ? pack_bf16(got, hi) : pack_bf16(lo, got);
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
int launch_fma(const void* x, const void* w, const int* gids, void* out,
               long long n_blocks, int k, int n, int e, cudaStream_t s) {
  const int n_tiles = (n + FmaTile<BT>::kBN - 1) / FmaTile<BT>::kBN;
  gmm_fma_kernel<BT><<<static_cast<unsigned>(n_blocks * n_tiles), kThreads,
                       0, s>>>(static_cast<const float*>(x),
                               static_cast<const float*>(w), gids,
                               static_cast<float*>(out), k, n, e, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

// x (T, K) and w (E, K, N) as tensor maps; a persistent grid of one
// block per SM.  The attribute query, the register-pool check, the
// shared-memory opt-in and the SM count run once per device; only the
// maps are encoded per call.
template <int BT>
int launch_wgmma(const void* x, const void* w, const int* gids, void* out,
                 long long n_blocks, int k, int n, int e, cudaStream_t s) {
  constexpr int BN = 256;
  using P = WgTile<BT, BN>;
  int dev = 0;
  int err = repro::current_device(&dev);
  if (err) return err;
  err = repro::once_per_device(dev, [] {
    // a pool smaller than setmaxnreg asks for would stall the consumers
    // for ever: refuse the launch instead
    cudaFuncAttributes attr;
    cudaError_t e = cudaFuncGetAttributes(&attr, gmm_wgmma_kernel<BT, BN>);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (attr.numRegs * P::kThreads <
        128 * P::kProducerRegs + 256 * P::kConsumerRegs) {
      return static_cast<int>(cudaErrorInvalidConfiguration);
    }
    return static_cast<int>(cudaFuncSetAttribute(
        gmm_wgmma_kernel<BT, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(P::kSmemBytes)));
  });
  if (err) return err;
  const int n_sm = repro::sm_count(dev);
  if (n_sm <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  const int col_tiles = (n + BN - 1) / BN;
  const long long n_tiles = n_blocks * col_tiles;
  if (n_blocks * BT > INT_MAX || n_tiles > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // an empty x or w (K or E 0) has no map: its encoding fails, and the
  // launch is refused
  const cuuint64_t x_dims[2] = {static_cast<cuuint64_t>(k),
                                static_cast<cuuint64_t>(n_blocks) * BT};
  const cuuint64_t x_strides[1] = {static_cast<cuuint64_t>(k) * 2};
  const cuuint32_t x_box[2] = {64, BT};
  const cuuint64_t w_dims[3] = {static_cast<cuuint64_t>(n),
                                static_cast<cuuint64_t>(k),
                                static_cast<cuuint64_t>(e)};
  const cuuint64_t w_strides[2] = {static_cast<cuuint64_t>(n) * 2,
                                   static_cast<cuuint64_t>(n) * k * 2};
  const cuuint32_t w_box[3] = {64, 64, 1};
  const cuuint64_t o_dims[2] = {static_cast<cuuint64_t>(n), x_dims[1]};
  const cuuint64_t o_strides[1] = {static_cast<cuuint64_t>(n) * 2};
  const cuuint32_t o_box[2] = {64, 64};
  GmmMaps maps;
  if (!repro::encode_bf16_map(&maps.x, x, 2, x_dims, x_strides, x_box) ||
      !repro::encode_bf16_map(&maps.w, w, 3, w_dims, w_strides, w_box) ||
      !repro::encode_bf16_map(&maps.out, out, 2, o_dims, o_strides, o_box)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // walk the columns of a row block fastest when it has few column tiles
  // (the tiles in flight then hold whole row blocks, and each block's x
  // rows are read once); when it has many (wide N), walking them first
  // would stream an expert's whole weight for every row block, so 16 row
  // blocks go together (~sqrt(132 x BN / BT): the group that balances the
  // x and weight bytes of the tiles in flight)
  const int tile_group = col_tiles > 8 ? 16 : 1;
  const GmmShape g{static_cast<int>(n_blocks), col_tiles,
                   (k + P::kBK - 1) / P::kBK, n, e, tile_group};
  const int grid = static_cast<int>(n_tiles < n_sm ? n_tiles : n_sm);
  gmm_wgmma_kernel<BT, BN><<<grid, P::kThreads, P::kSmemBytes, s>>>(
      maps, gids, static_cast<bf16*>(out), g);
  return static_cast<int>(cudaGetLastError());
}

// x (T, K) and w (E, K, N) as tensor maps (the prefill's boxes of x are
// BT rows, of w the same 64 x 64 x 1); a persistent grid of
// kDecodeBlocksPerSm blocks a SM.  The shared-memory opt-in and the SM
// count come once per device; only the maps are encoded per call.
template <int BT>
int launch_decode(const void* x, const void* w, const int* gids, void* out,
                  long long n_blocks, int k, int n, int e, cudaStream_t s) {
  using P = DecTile<BT, kDecodeBN>;
  int dev = 0;
  int err = repro::current_device(&dev);
  if (err) return err;
  err = repro::once_per_device(dev, [] {
    return static_cast<int>(cudaFuncSetAttribute(
        gmm_decode_kernel<BT, kDecodeBN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(P::kSmemBytes)));
  });
  if (err) return err;
  const int n_sm = repro::sm_count(dev);
  if (n_sm <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  const int col_tiles = (n + kDecodeBN - 1) / kDecodeBN;
  const long long n_items = n_blocks * col_tiles;
  if (n_blocks * BT > INT_MAX || n_items > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // an empty x or w (K or E 0) has no map: its encoding fails, and the
  // launch is refused
  const cuuint64_t x_dims[2] = {static_cast<cuuint64_t>(k),
                                static_cast<cuuint64_t>(n_blocks) * BT};
  const cuuint64_t x_strides[1] = {static_cast<cuuint64_t>(k) * 2};
  const cuuint32_t x_box[2] = {64, BT};
  const cuuint64_t w_dims[3] = {static_cast<cuuint64_t>(n),
                                static_cast<cuuint64_t>(k),
                                static_cast<cuuint64_t>(e)};
  const cuuint64_t w_strides[2] = {static_cast<cuuint64_t>(n) * 2,
                                   static_cast<cuuint64_t>(n) * k * 2};
  const cuuint32_t w_box[3] = {64, 64, 1};
  DecodeMaps maps;
  if (!repro::encode_bf16_map(&maps.x, x, 2, x_dims, x_strides, x_box) ||
      !repro::encode_bf16_map(&maps.w, w, 3, w_dims, w_strides, w_box)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // items columns fastest: the blocks in flight read a window of
  // consecutive row blocks, each row block's x from L2 after its first
  // column tile, and each expert's weight once
  const GmmShape g{static_cast<int>(n_blocks), col_tiles,
                   (k + P::kBK - 1) / P::kBK, n, e, 1};
  const long long slots = static_cast<long long>(n_sm) * kDecodeBlocksPerSm;
  const int grid = static_cast<int>(n_items < slots ? n_items : slots);
  gmm_decode_kernel<BT, kDecodeBN><<<grid, P::kThreads, P::kSmemBytes, s>>>(
      maps, gids, static_cast<bf16*>(out), g);
  return static_cast<int>(cudaGetLastError());
}

enum Kernel : int { kFma = 0, kDecode = 1, kWgmma = 2 };

}  // namespace

// x: (T, K); w: (E, K, N); gids: (T / block_t,) int32; out: (T, N); all
// contiguous, x, w and out 16-byte aligned, K and N multiples of 8.
// ``kernel`` names the kernel (the wrapper's kernel_for): 0 FMA (float32,
// block_t 8 .. 128), 1 decode (bfloat16, block_t 8, 16, 32: TMA +
// mma.sync), 2 wgmma + TMA (bfloat16, block_t 64, 128); any other pair is
// refused.
// Returns cudaGetLastError().
extern "C" int moe_gmm_fwd(const void* x, const void* w, const void* gids,
                           void* out, long long t, int k, int n, int e,
                           int block_t, int kernel, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* g = static_cast<const int*>(gids);
  if (t == 0 || n == 0) return static_cast<int>(cudaGetLastError());
  const long long nb = t / block_t;
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  switch (kernel) {
    case kFma:
      switch (block_t) {
        case 8: return launch_fma<8>(x, w, g, out, nb, k, n, e, s);
        case 16: return launch_fma<16>(x, w, g, out, nb, k, n, e, s);
        case 32: return launch_fma<32>(x, w, g, out, nb, k, n, e, s);
        case 64: return launch_fma<64>(x, w, g, out, nb, k, n, e, s);
        case 128: return launch_fma<128>(x, w, g, out, nb, k, n, e, s);
        default: return bad;
      }
    case kDecode:
      switch (block_t) {
        case 8: return launch_decode<8>(x, w, g, out, nb, k, n, e, s);
        case 16: return launch_decode<16>(x, w, g, out, nb, k, n, e, s);
        case 32: return launch_decode<32>(x, w, g, out, nb, k, n, e, s);
        default: return bad;
      }
    case kWgmma:
      switch (block_t) {
        case 64:
          return launch_wgmma<64>(x, w, g, out, nb, k, n, e, s);
        case 128:
          return launch_wgmma<128>(x, w, g, out, nb, k, n, e, s);
        default: return bad;
      }
    default: return bad;
  }
}

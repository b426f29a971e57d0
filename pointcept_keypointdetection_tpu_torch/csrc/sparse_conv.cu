// Submanifold sparse conv, forward (B3) and weight gradient (B4): hand-written
// gather-GEMM kernels for Hopper (sm_90a) on the tensor cores.
//
// ---- B3, forward ----
//
// Replaces the Pallas TPU kernel
// pointcept_keypointdetection_tpu/ops/pallas/sparse_conv.py::_conv_kernel
// (reached through fused_subm_conv from ops/sparse.py::_conv_apply):
//     out[i] = sum_d feat_pad[idx[i, d]] @ W[d],   feat_pad[N] = 0,
// with feat [N, Cin], idx int32 [N, K], W [K, Cin, Cout], f32 accumulation,
// f32 or bf16 in and out.
//
// Work sized by hits: the wrapper hands over the map's rulebook
// (kernels/sparse_conv.py::build_rulebook), built once per map.  Its rows are
// sorted by their K-bit hit mask (the bitmask-sorted implicit GEMM of
// TorchSparse++), rows with no hit last, and cut into tiles of TILE sorted
// rows; each busy tile carries the mask of the offsets any of its rows hits,
// in ceil(K / 32) words of 32 bits (word w of tile t at tile_mask[w * tiles +
// t]), so one launch takes any K up to MAX_OFFSETS: the k=5 stem's 125
// offsets as the k=3 convs' 27, the whole sum in one block's registers.
// The kernel is output-stationary: a block owns one busy tile x BN output
// columns and loops over the tile's busy offsets only; tiles past the busy
// ones hold no hit and are not computed (with one split their blocks write
// zeros; with more, the split sum does).  Output rows are written once,
// through the permutation.
//
// Per busy offset the block stages the tile's TILE neighbour indices (the
// rulebook's offset-major copy, read once per block into shared memory), then
// walks Cin in steps of BK: 16-byte cp.async copies gather the A rows (an
// index N, or a channel past Cin, zero-fills) and the [BK, BN] tile of W[d]
// into a ring of STAGES shared-memory stages, so the copies of the next two
// steps are in flight while the tensor cores work on this one.  TMA's tiled
// mode cannot gather rows, hence cp.async.  Four warps own 2 x 2 warp tiles
// of f32 accumulators in registers:
//   bf16: mma.sync.m16n8k16 bf16 -> f32, fragments by ldmatrix;
//   f32:  3xTF32 -- each operand split into a rounded TF32 part and a TF32
//         remainder, three mma.sync.m16n8k8 per product (small x big,
//         big x small, big x big; small x small dropped).  The error is ~3
//         f32 ulps per product, like FFMA's rounding; plain TF32 (~3 decimal
//         digits) would miss the 1e-4 + 1e-4 |x| check against the plain
//         version and the card-against-CPU limits.
// Shared-memory rows are padded so that fragment loads and ldmatrix hit 32
// distinct banks.  BN is 32 at Cout <= 32, else 64: no half-empty tiles at
// C = 32.
//
// Splits: at the deep stages the busy tiles are few (enc4 of the trainer:
// 414 valid rows, 7 busy tiles), too few blocks for 132 SMs.  The offsets are
// then cut into `splits` groups along grid.z, chosen from the busy tiles;
// each group writes an f32 partial sum of the busy rows to a workspace
// [splits, busy_tiles * TILE, Cout], and a second kernel adds the groups in a
// fixed order and writes every output row once through the permutation
// (deterministic, no atomics).
//
// Bound: 2 * hits * Cin * Cout flops; in f32, 3xTF32 triples them at the TF32
// rate (495 TFLOP/s dense), in bf16 at 989 TFLOP/s; the bytes (feat, idx, W
// and out once) bound the narrow levels.
//
// ---- B4, weight gradient ----
//
// Replaces the Pallas TPU kernel
// pointcept_keypointdetection_tpu/ops/pallas/sparse_conv.py::_dw_kernel
// (reached through fused_subm_conv_dw from ops/sparse.py::_subm_conv_sym_bwd):
//     dW[d] = sum_i feat_pad[idx[i, d]]^T grad[i],   feat_pad[N] = 0,
// with feat [N, Cin], idx int32 [N, K], grad [N, Cout] in f32 or bf16 and
// dW [K, Cin, Cout] in f32.
//
// For an offset d this is A_d^T G_d, with A_d the feature rows and G_d the
// gradient rows of d's hit pairs (the rulebook's per-offset lists, as in
// TorchSparse and Minuet): the reduction runs over the hits alone and no
// block compacts anything.  The Pallas kernel keeps dW resident in VMEM and
// adds each row tile's product across a sequential grid; on the card blocks
// run in no order, so a block owns one BT x BT tile of dW[d] (BT = 32 at
// C <= 32, else 64) and one run of d's pairs.  It stages DW_IDX pair indices
// at a time in shared memory and gathers BK pairs per step through the same
// cp.async ring into the same tensor-core core as B3 (A read k-major).
//
// Splits: each offset's pairs are cut into `splits` runs, chosen by the hits
// so that about four blocks run per SM; with more than one run each writes an
// f32 partial dW to a workspace [splits, K, Cin, Cout] and the split sum adds
// them in a fixed order (deterministic, no atomics).
//
// Bound: 2 * hits * Cin * Cout flops as for B3; the bytes (feat, idx, grad
// once, dW once) bound the narrow levels.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tensor_core.cuh"

namespace {

constexpr int TILE = 64;      // B3: sorted rows per block, the rulebook's tile
constexpr int BK = 32;        // reduction depth of one stage: B3 input channels, B4 hit pairs
constexpr int STAGES = 3;     // cp.async ring depth
constexpr int THREADS = 128;  // four warps, 2 x 2 over the block's tile
constexpr int MAX_OFFSETS = 343;  // a 7^3 cube: its offset list and slab plus the ring fit shared memory
constexpr int DW_IDX = 1024;  // B4: hit pairs whose indices a block stages at a time

// One stage of the block's product on one warp: acc[MT][NT] (m16 x n8 tiles
// from row m0, column n0) += A[m0.., 0..BK) * B[0..BK, n0..).  A is a[m * lda
// + k] (row-major, B3) or with A_KMAJOR a[k * lda + m] (B4); B is b[k * ldb +
// n].  Fragment layouts are those of the PTX ISA for mma.m16n8k8 (tf32) and
// mma.m16n8k16 (bf16): g = lane / 4 picks rows (A, C) or columns (B), t =
// lane % 4 the reduction index.
template <typename T, int MT, int NT, bool A_KMAJOR>
__device__ __forceinline__ void mma_stage(float (&acc)[MT][NT][4], const T* a, int lda, const T* b, int ldb,
                                          int m0, int n0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  if constexpr (std::is_same<T, float>::value) {
    // The tensor cores add into their f32 accumulator with truncation; over a
    // long sum into one large accumulator the bias grows (a dW entry summed
    // over ~1,400 hits read 1.3e-5 of max|dW|, against FFMA's 2.8e-6).  So each
    // stage's 12 products go to fresh registers, and those are added to acc
    // with round-to-nearest f32 adds.
    float part[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) part[mt][nt][q] = 0.f;
#pragma unroll
    for (int k0 = 0; k0 < BK; k0 += 8) {
      uint32_t a_big[MT][4], a_small[MT][4], b_big[NT][2], b_small[NT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int m = m0 + mt * 16 + g;
        float v[4];
        if constexpr (A_KMAJOR) {
          v[0] = a[(k0 + t) * lda + m];
          v[1] = a[(k0 + t) * lda + m + 8];
          v[2] = a[(k0 + t + 4) * lda + m];
          v[3] = a[(k0 + t + 4) * lda + m + 8];
        } else {
          v[0] = a[m * lda + k0 + t];
          v[1] = a[(m + 8) * lda + k0 + t];
          v[2] = a[m * lda + k0 + t + 4];
          v[3] = a[(m + 8) * lda + k0 + t + 4];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) split_tf32(v[i], a_big[mt][i], a_small[mt][i]);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int n = n0 + nt * 8 + g;
        split_tf32(b[(k0 + t) * ldb + n], b_big[nt][0], b_small[nt][0]);
        split_tf32(b[(k0 + t + 4) * ldb + n], b_big[nt][1], b_small[nt][1]);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          mma_tf32(part[mt][nt], a_small[mt], b_big[nt]);
          mma_tf32(part[mt][nt], a_big[mt], b_small[nt]);
          mma_tf32(part[mt][nt], a_big[mt], b_big[nt]);
        }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mt][nt][q] += part[mt][nt][q];
  } else {
    static_assert(NT % 2 == 0, "B fragments load two n8 tiles at a time");
    // B4 (A_KMAJOR) sums a dW entry over a run of up to tens of thousands of hit pairs in one block: as
    // in f32, each stage's products go to fresh registers, added to acc with round-to-nearest f32 adds,
    // so that the tensor cores' truncating adds do not bias the long sum (accumulated in place, a run of
    // ~34,000 pairs of the k=5 stem's map read 4.1e-5 of max|dW| against the plain einsum).  B3's sums
    // are short (busy offsets x Cin / 16 adds): in place.
    float part[MT][NT][4];
    if constexpr (A_KMAJOR) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int q = 0; q < 4; ++q) part[mt][nt][q] = 0.f;
    }
#pragma unroll
    for (int k0 = 0; k0 < BK; k0 += 16) {
      uint32_t af[MT][4], bf[NT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        // matrices in register order: (m 0-7, k 0-7), (m 8-15, k 0-7), (m 0-7, k 8-15), (m 8-15, k 8-15)
        if constexpr (A_KMAJOR)
          ldsm_x4_trans(af[mt], a + (k0 + (lane & 7) + (lane >> 4) * 8) * lda + m0 + mt * 16 + ((lane >> 3) & 1) * 8);
        else
          ldsm_x4(af[mt], a + (m0 + mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * lda + k0 + (lane >> 4) * 8);
      }
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2) {
        // matrices: (k 0-7, tile nt), (k 8-15, tile nt), (k 0-7, tile nt+1), (k 8-15, tile nt+1)
        uint32_t r[4];
        ldsm_x4_trans(r, b + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ldb + n0 + nt * 8 + (lane >> 4) * 8);
        bf[nt][0] = r[0];
        bf[nt][1] = r[1];
        bf[nt + 1][0] = r[2];
        bf[nt + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          if constexpr (A_KMAJOR)
            mma_bf16(part[mt][nt], af[mt], bf[nt]);
          else
            mma_bf16(acc[mt][nt], af[mt], bf[nt]);
        }
    }
    if constexpr (A_KMAJOR) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[mt][nt][q] += part[mt][nt][q];
    }
  }
}

template <typename T, int BN>
struct ConvTile {
  static constexpr int VEC = 16 / sizeof(T);  // elements of one cp.async
  static constexpr int LDA = BK + VEC;        // padded A row (f32 36, bf16 40 elements): conflict-free fragments
  static constexpr int LDB = BN + 8;          // padded W row
  static constexpr int STAGE = TILE * LDA + BK * LDB;  // elements of one stage
  static constexpr int MT = TILE / 32, NT = BN / 16;   // m16 x n8 tiles of one warp's 32 x BN/2
  static constexpr int A_COPIES = TILE * BK / VEC / THREADS, B_COPIES = BK * BN / VEC / THREADS;  // per thread
  static_assert(A_COPIES * THREADS * VEC == TILE * BK && B_COPIES * THREADS * VEC == BK * BN, "whole copies");
  // the block's busy offsets (16-byte aligned), their TILE neighbour indices each, then the ring
  __host__ __device__ static constexpr size_t offs_bytes(int offsets) {
    return ((size_t)offsets * sizeof(int) + 15) / 16 * 16;
  }
  static constexpr size_t smem(int offsets) {
    return offs_bytes(offsets) + (size_t)offsets * TILE * sizeof(int) + (size_t)STAGES * STAGE * sizeof(T);
  }
};

// B3.  Block (x, y, z): columns [x * BN, +BN), sorted rows [y * TILE, +TILE),
// offsets [z * per_split, +per_split).  partial == nullptr: one split, the
// result goes to out through perm; else split z writes its f32 sum of the
// busy rows to partial[z] ([busy_tiles * TILE, cout]).
template <typename T, int BN>
__global__ void __launch_bounds__(THREADS) subm_conv_kernel(
    const T* __restrict__ feat, const T* __restrict__ w, T* __restrict__ out, float* __restrict__ partial,
    const int* __restrict__ perm, const int* __restrict__ nbr, const int* __restrict__ tile_mask, int n,
    int kvol, int cin, int cout, int busy_tiles, int per_split) {
  using L = ConvTile<T, BN>;
  extern __shared__ __align__(16) unsigned char smem[];
  int* offs = reinterpret_cast<int*>(smem);  // the block's busy offsets, ascending
  int* slab = reinterpret_cast<int*>(smem + L::offs_bytes(per_split));  // slab[j * TILE + r]: at offs[j]
  T* stages = reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(slab) + (size_t)per_split * TILE * sizeof(int));

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int col0 = blockIdx.x * BN, p0 = blockIdx.y * TILE;
  const int m0 = (warp >> 1) * 32, n0 = (warp & 1) * (BN / 2);

  if ((int)blockIdx.y >= busy_tiles) {  // no row of the tile hits: zeros (one split only)
    for (int e = tid; e < TILE * (BN / 2); e += THREADS) {
      const int p = p0 + e / (BN / 2), c = col0 + (e % (BN / 2)) * 2;
      if (p < n && c < cout) store2(out + (long)perm[p] * cout + c, 0.f, 0.f);
    }
    return;
  }

  // the busy offsets of [d_begin, d_end), word by word of the tile's mask; every thread counts them
  const int tiles = (n + TILE - 1) / TILE;
  const int d_begin = blockIdx.z * per_split, d_end = min(kvol, d_begin + per_split);
  int busy = 0;
  for (int wd = d_begin >> 5; d_end > d_begin && 32 * wd < d_end; ++wd) {
    const int lo = max(d_begin - 32 * wd, 0), hi = min(d_end - 32 * wd, 32);  // 0 <= lo < hi <= 32
    const unsigned span = (hi == 32 ? 0xffffffffu : (1u << hi) - 1u) & ~((1u << lo) - 1u);
    const unsigned word = static_cast<unsigned>(tile_mask[(long)wd * tiles + blockIdx.y]) & span;
    if (tid < 32 && ((word >> tid) & 1u)) offs[busy + __popc(word & ((1u << tid) - 1u))] = 32 * wd + tid;
    busy += __popc(word);
  }
  __syncthreads();
  const long stride = (long)tiles * TILE;  // nbr's row length
  for (int e = tid; e < busy * (TILE / 4); e += THREADS) {
    const int j = e / (TILE / 4), q = e % (TILE / 4);
    reinterpret_cast<int4*>(slab)[e] = reinterpret_cast<const int4*>(nbr + offs[j] * stride + p0)[q];
  }
  __syncthreads();

  const int kchunks = (cin + BK - 1) / BK;
  const int iters = busy * kchunks;
  auto load_stage = [&](int it) {
    const int j = it / kchunks, k0 = (it % kchunks) * BK;
    const int d = offs[j];
    T* as = stages + (it % STAGES) * L::STAGE;
    T* bs = as + TILE * L::LDA;
#pragma unroll
    for (int i = 0; i < L::A_COPIES; ++i) {
      const int e = tid + i * THREADS;
      const int r = e / (BK / L::VEC), c = (e % (BK / L::VEC)) * L::VEC;
      const int src = slab[j * TILE + r];
      const bool ok = (unsigned)src < (unsigned)n && k0 + c < cin;
      cp_async16(as + r * L::LDA + c, ok ? feat + (long)src * cin + k0 + c : feat, ok);
    }
#pragma unroll
    for (int i = 0; i < L::B_COPIES; ++i) {
      const int e = tid + i * THREADS;
      const int kr = e / (BN / L::VEC), c = (e % (BN / L::VEC)) * L::VEC;
      const bool ok = k0 + kr < cin && col0 + c < cout;
      cp_async16(bs + kr * L::LDB + c, ok ? w + ((long)d * cin + k0 + kr) * cout + col0 + c : w, ok);
    }
  };

  float acc[L::MT][L::NT][4];
#pragma unroll
  for (int i = 0; i < L::MT; ++i)
#pragma unroll
    for (int j = 0; j < L::NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < iters) load_stage(s);
    cp_async_commit();
  }
  for (int it = 0; it < iters; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage it is in shared memory for every thread; stage it-1 is free
    const T* as = stages + (it % STAGES) * L::STAGE;
    mma_stage<T, L::MT, L::NT, false>(acc, as, L::LDA, as + TILE * L::LDA, L::LDB, m0, n0, lane);
    if (it + STAGES - 1 < iters) load_stage(it + STAGES - 1);
    cp_async_commit();
  }

  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < L::MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = p0 + m0 + mt * 16 + g + h * 8;
      if (p >= n) continue;
      const long row = partial ? (long)blockIdx.z * busy_tiles * TILE + p : (long)perm[p];
#pragma unroll
      for (int nt = 0; nt < L::NT; ++nt) {
        const int c = col0 + n0 + nt * 8 + 2 * t;
        if (c >= cout) continue;
        if (partial)
          store2(partial + row * cout + c, acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
        else
          store2(out + row * cout + c, acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
      }
    }
}

// out[row(p)][c] = sum_z partial[z][p][c], z in order, for p < summed; zero
// for summed <= p < rows.  row(p) = perm[p] (B3's offset splits, through the
// rulebook's permutation) or p (perm == nullptr: B4's row splits of dW, T =
// float, rows = K * Cin).
template <typename T>
__global__ void sum_splits_kernel(const float* __restrict__ partial, T* __restrict__ out,
                                  const int* __restrict__ perm, long rows, long summed, int cols, int splits) {
  const long total = rows * cols, stride = summed * cols;
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < total; i += (long)gridDim.x * blockDim.x) {
    const long p = i / cols;
    float s = 0.f;
    if (p < summed)
      for (int z = 0; z < splits; ++z) s += partial[z * stride + i];
    store1(out + (perm ? (long)perm[p] : p) * cols + i % cols, s);
  }
}

template <typename T>
void sum_splits(const float* partial, T* out, const int* perm, long rows, long summed, int cols, int splits,
                cudaStream_t s) {
  const long want = (rows * cols + 255) / 256;
  const int blocks = want < 4096 ? (int)(want > 0 ? want : 1) : 4096;
  sum_splits_kernel<T><<<blocks, 256, 0, s>>>(partial, out, perm, rows, summed, cols, splits);
}

template <typename T, int BN>
int launch_fwd(const T* feat, const T* w, T* out, float* workspace, const int* perm, const int* nbr,
               const int* tile_mask, int n, int kvol, int cin, int cout, int busy_tiles, int splits,
               cudaStream_t s) {
  using L = ConvTile<T, BN>;
  auto kernel = subm_conv_kernel<T, BN>;
  static const cudaError_t attr =  // once per instantiation: room for the largest slab
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::smem(MAX_OFFSETS));
  if (attr != cudaSuccess) return (int)attr;
  const int per_split = (kvol + splits - 1) / splits;
  const int tiles = (n + TILE - 1) / TILE;
  const dim3 grid((cout + BN - 1) / BN, splits > 1 ? busy_tiles : tiles, splits);
  if (grid.y > 0)
    kernel<<<grid, THREADS, L::smem(per_split), s>>>(feat, w, out, splits > 1 ? workspace : nullptr, perm, nbr,
                                                      tile_mask, n, kvol, cin, cout, busy_tiles, per_split);
  if (splits > 1) sum_splits<T>(workspace, out, perm, n, (long)busy_tiles * TILE, cout, splits, s);
  return (int)cudaGetLastError();
}

template <typename T, int BT>
struct DwTile {
  static constexpr int VEC = 16 / sizeof(T);
  static constexpr int LD = BT + 8;           // padded row of the A (k-major) and G stages
  static constexpr int STAGE = 2 * BK * LD;   // elements of one stage: A then G
  static constexpr int MT = BT / 32, NT = BT / 16;
  static constexpr int COPIES = BK * BT / VEC / THREADS;  // of A and of G per thread and stage
  static_assert(COPIES * THREADS * VEC == BK * BT, "whole copies");
  static constexpr size_t smem() { return 2 * DW_IDX * sizeof(int) + (size_t)STAGES * STAGE * sizeof(T); }
};

// B4.  Block (x, y, z): dW[d] columns [x * BT, +BT) (Cout), rows [y * BT,
// +BT) (Cin), d = z % kvol, run z / kvol of d's hit pairs.  Run r of d writes
// its f32 sum to dw_out[r] ([kvol, cin, cout] each).
template <typename T, int BT>
__global__ void __launch_bounds__(THREADS) subm_conv_dw_kernel(
    const T* __restrict__ feat, const T* __restrict__ grad, float* __restrict__ dw_out,
    const int* __restrict__ pair_in, const int* __restrict__ pair_out, const int* __restrict__ pair_start,
    int kvol, int cin, int cout, int splits) {
  using L = DwTile<T, BT>;
  extern __shared__ __align__(16) unsigned char smem[];
  int* src_s = reinterpret_cast<int*>(smem);  // feature rows of the staged pairs
  int* dst_s = src_s + DW_IDX;                // their gradient rows
  T* stages = reinterpret_cast<T*>(dst_s + DW_IDX);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int co0 = blockIdx.x * BT, ci0 = blockIdx.y * BT;
  const int d = blockIdx.z % kvol, run = blockIdx.z / kvol;
  const int m0 = (warp >> 1) * (BT / 2), n0 = (warp & 1) * (BT / 2);
  const int first = pair_start[d], count = pair_start[d + 1] - first;
  const int per_run = (count + splits - 1) / splits;
  const int begin = first + min(count, run * per_run), end = first + min(count, (run + 1) * per_run);

  float acc[L::MT][L::NT][4];
#pragma unroll
  for (int i = 0; i < L::MT; ++i)
#pragma unroll
    for (int j = 0; j < L::NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  for (int c0 = begin; c0 < end; c0 += DW_IDX) {
    const int len = min(DW_IDX, end - c0);
    __syncthreads();  // every thread is done with the previous batch's indices and stages
    for (int e = tid; e < len; e += THREADS) {
      src_s[e] = pair_in[c0 + e];
      dst_s[e] = pair_out[c0 + e];
    }
    __syncthreads();
    const int iters = (len + BK - 1) / BK;
    auto load_stage = [&](int it) {
      T* as = stages + (it % STAGES) * L::STAGE;
      T* gs = as + BK * L::LD;
      const int j0 = it * BK;
#pragma unroll
      for (int i = 0; i < L::COPIES; ++i) {
        const int e = tid + i * THREADS;
        const int kr = e / (BT / L::VEC), c = (e % (BT / L::VEC)) * L::VEC;
        const bool in = j0 + kr < len;
        const bool oka = in && ci0 + c < cin, okg = in && co0 + c < cout;
        cp_async16(as + kr * L::LD + c, oka ? feat + (long)src_s[j0 + kr] * cin + ci0 + c : feat, oka);
        cp_async16(gs + kr * L::LD + c, okg ? grad + (long)dst_s[j0 + kr] * cout + co0 + c : grad, okg);
      }
    };
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < iters) load_stage(s);
      cp_async_commit();
    }
    for (int it = 0; it < iters; ++it) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();
      const T* as = stages + (it % STAGES) * L::STAGE;
      mma_stage<T, L::MT, L::NT, true>(acc, as, L::LD, as + BK * L::LD, L::LD, m0, n0, lane);
      if (it + STAGES - 1 < iters) load_stage(it + STAGES - 1);
      cp_async_commit();
    }
    cp_async_wait<0>();
  }

  float* dst = dw_out + ((long)run * kvol + d) * cin * cout;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < L::MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ci = ci0 + m0 + mt * 16 + g + h * 8;
      if (ci >= cin) continue;
#pragma unroll
      for (int nt = 0; nt < L::NT; ++nt) {
        const int co = co0 + n0 + nt * 8 + 2 * t;
        if (co < cout) store2(dst + (long)ci * cout + co, acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
      }
    }
}

template <typename T, int BT>
int launch_dw(const T* feat, const T* grad, float* dw, float* workspace, const int* pair_in, const int* pair_out,
              const int* pair_start, int kvol, int cin, int cout, int splits, cudaStream_t s) {
  using L = DwTile<T, BT>;
  auto kernel = subm_conv_dw_kernel<T, BT>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::smem());
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((cout + BT - 1) / BT, (cin + BT - 1) / BT, kvol * splits);
  kernel<<<grid, THREADS, L::smem(), s>>>(feat, grad, splits > 1 ? workspace : dw, pair_in, pair_out, pair_start,
                                         kvol, cin, cout, splits);
  if (splits > 1) sum_splits<float>(workspace, dw, nullptr, (long)kvol * cin, (long)kvol * cin, cout, splits, s);
  return (int)cudaGetLastError();
}

template <typename T>
int fwd(const void* feat, const void* w, void* out, float* ws, const int* perm, const int* nbr,
        const int* tile_mask, int n, int kvol, int cin, int cout, int busy_tiles, int splits, cudaStream_t s) {
  const T* f = static_cast<const T*>(feat);
  const T* wt = static_cast<const T*>(w);
  T* o = static_cast<T*>(out);
  if (cout <= 32)
    return launch_fwd<T, 32>(f, wt, o, ws, perm, nbr, tile_mask, n, kvol, cin, cout, busy_tiles, splits, s);
  return launch_fwd<T, 64>(f, wt, o, ws, perm, nbr, tile_mask, n, kvol, cin, cout, busy_tiles, splits, s);
}

template <typename T>
int dw_dispatch(const void* feat, const void* grad, float* out, float* ws, const int* pair_in, const int* pair_out,
       const int* pair_start, int kvol, int cin, int cout, int splits, cudaStream_t s) {
  const T* f = static_cast<const T*>(feat);
  const T* g = static_cast<const T*>(grad);
  if (cin <= 32 && cout <= 32)
    return launch_dw<T, 32>(f, g, out, ws, pair_in, pair_out, pair_start, kvol, cin, cout, splits, s);
  return launch_dw<T, 64>(f, g, out, ws, pair_in, pair_out, pair_start, kvol, cin, cout, splits, s);
}

}  // namespace

// feat [n, cin], w [kvol, cin, cout] and out [n, cout] of one dtype (0 = f32,
// 1 = bf16), cin and cout multiples of 8, rows 16-byte aligned; the rulebook's
// perm int32 [n], nbr int32 [kvol, ceil(n / 64) * 64] and tile_mask int32
// [ceil(kvol / 32) * ceil(n / 64)] (word-major), whose first busy_tiles tiles
// hold every row with a hit; with
// splits > 1, workspace is f32 [splits, busy_tiles * 64, cout] (else unused).
// Returns cudaGetLastError().
extern "C" int subm_conv_fwd(const void* feat, const void* w, void* out, void* workspace, const void* perm,
                             const void* nbr, const void* tile_mask, int n, int kvol, int cin, int cout,
                             int busy_tiles, int splits, int dtype, void* stream) {
  const int tiles = (n + TILE - 1) / TILE;
  if (n < 0 || kvol <= 0 || kvol > MAX_OFFSETS || cin <= 0 || cout <= 0 || cin % 8 || cout % 8 ||
      (dtype != 0 && dtype != 1) || tiles > 65535 || busy_tiles < 0 || busy_tiles > tiles || splits < 1 ||
      splits > kvol || (splits > 1 && workspace == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* pm = static_cast<const int*>(perm);
  const int* nb = static_cast<const int*>(nbr);
  const int* tm = static_cast<const int*>(tile_mask);
  float* ws = static_cast<float*>(workspace);
  if (dtype == 0) return fwd<float>(feat, w, out, ws, pm, nb, tm, n, kvol, cin, cout, busy_tiles, splits, s);
  return fwd<__nv_bfloat16>(feat, w, out, ws, pm, nb, tm, n, kvol, cin, cout, busy_tiles, splits, s);
}

// feat [n, cin] and grad [n, cout] of one dtype (0 = f32, 1 = bf16), cin and
// cout multiples of 8, rows 16-byte aligned; the rulebook's hit pairs
// pair_in, pair_out int32 [H] and pair_start int32 [kvol + 1]; dw f32 [kvol,
// cin, cout]; each offset's pairs are cut into `splits` runs, and with
// splits > 1 workspace is f32 [splits, kvol, cin, cout] (else unused).
// Returns cudaGetLastError().
extern "C" int subm_conv_dw(const void* feat, const void* grad, void* dw_out, void* workspace, const void* pair_in,
                            const void* pair_out, const void* pair_start, int n, int kvol, int cin, int cout,
                            int splits, int dtype, void* stream) {
  if (n < 0 || kvol <= 0 || cin <= 0 || cout <= 0 || cin % 8 || cout % 8 || (dtype != 0 && dtype != 1) ||
      splits < 1 || (long)kvol * splits > 65535 || (cin + 31) / 32 > 65535 || (splits > 1 && workspace == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* pi = static_cast<const int*>(pair_in);
  const int* po = static_cast<const int*>(pair_out);
  const int* ps = static_cast<const int*>(pair_start);
  float* out = static_cast<float*>(dw_out);
  float* ws = static_cast<float*>(workspace);
  if (dtype == 0) return dw_dispatch<float>(feat, grad, out, ws, pi, po, ps, kvol, cin, cout, splits, s);
  return dw_dispatch<__nv_bfloat16>(feat, grad, out, ws, pi, po, ps, kvol, cin, cout, splits, s);
}

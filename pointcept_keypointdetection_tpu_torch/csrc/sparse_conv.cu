// Submanifold sparse conv, forward (B3) and weight gradient (B4): hand-written
// gather-GEMM kernels for Hopper (sm_90a).
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
// Tiling: each block owns BM output rows and BN output columns and loops
// over its share of the K offsets.  For an offset it reads the BM neighbour
// indices once, then walks Cin in chunks of BK: the gathered feature rows go
// to shared memory (an index N, or any index outside [0, N), writes zeros; no
// padded copy of feat exists), a [BK, BN] tile of W[d] beside them, and every
// thread accumulates a TM x TN micro-tile in f32 registers with FFMA.  The
// [N, K, Cin] im2col never reaches device memory, and W streams through
// shared memory, since at Cin = Cout = 512 it is 28 MB in f32.
//
// Offsets that no row of the tile hits are skipped (rows in z order, as on
// the pooled stages, share most of their misses).
//
// Splits: at the deep stages (N = 512, Cin = Cout = 512) the output has only
// 64 tiles of BM x BN, too few blocks for 132 SMs.  The offsets are then cut
// into `splits` groups along grid.z; each group writes an f32 partial sum to a
// workspace [splits, N, Cout] that the wrapper allocates, and a second kernel
// adds the groups in a fixed order (deterministic, no atomics).
//
// Bound: 2 * nnz * Cin * Cout flops (nnz = the map's hits); at the PTv3 shapes
// the f32 FFMA rate bounds it, not the bytes.  FFMA rather than TF32 keeps f32
// results within rounding of the plain version; mma.sync/wgmma, and a deeper
// pipeline, are later work.
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
// For an offset d this is a [Cin x N] x [N x Cout] product whose A side is
// gathered.  The Pallas kernel keeps dW resident in VMEM and adds each row
// tile's product to it across a sequential grid; on the card blocks run in
// no order, so nothing may carry over between them.  Here a block owns one
// BM x BN tile of dW[d] (Cin rows, Cout columns) and one contiguous split of
// the N rows.  It walks its split CHUNK rows at a time: each thread reads one
// row's neighbour index, a warp ballot and a prefix over the warps compact
// the rows that hit a neighbour (index < N) into shared memory, and rows
// whose index is the sentinel are skipped instead of gathering a zero row.
// The hit rows are then taken BK at a time: their gathered feature rows and
// their gradient rows go to shared memory, and every thread accumulates a
// TM x TN micro-tile in f32 registers with FFMA.
//
// Splits: the N sum reaches 65,536 rows while a deep stage's dW has many
// tiles and a shallow one's few; the wrapper picks the number of splits so
// that about four blocks run per SM.  With more than one split each writes
// an f32 partial dW to a workspace [splits, K, Cin, Cout] and a second
// kernel adds the splits in a fixed order (deterministic, no atomics).
//
// Bound: 2 * hits * Cin * Cout flops (hits = the map's found neighbours) at
// the f32 FFMA rate; the bytes (feat, idx, grad once, dW once) are far
// smaller.  mma.sync/wgmma and a deeper pipeline are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;   // output rows per block (the wrapper's TILE); B4: Cin rows of a dW tile
constexpr int BN = 64;   // output columns per block (the wrapper's TILE); B4: Cout columns of a dW tile
constexpr int BK = 16;   // input channels per shared-memory step; B4: hit rows per step
constexpr int TM = 4;    // rows per thread
constexpr int TN = 4;    // columns per thread
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256
constexpr int CHUNK = THREADS;                  // B4: rows whose hits one compaction collects
constexpr int WARPS = THREADS / 32;
constexpr int AP = BM + 4;  // padded row of the transposed A tile: a 16B-aligned float4 row, 2-way store conflicts at most

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// partial == nullptr: one group of offsets, the result goes to out in T;
// else group blockIdx.z writes its f32 sum to partial[blockIdx.z].
template <typename T>
__global__ void __launch_bounds__(THREADS) subm_conv_kernel(
    const T* __restrict__ feat, const int* __restrict__ idx, const T* __restrict__ w,
    float* __restrict__ partial, T* __restrict__ out, int n, int kvol, int cin, int cout,
    int per_split) {
  __shared__ int rows[BM];
  __shared__ __align__(16) float as[BK][AP];  // as[c][r]: gathered rows, transposed
  __shared__ __align__(16) float bs[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int d_begin = blockIdx.z * per_split, d_end = min(kvol, d_begin + per_split);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int d = d_begin; d < d_end; ++d) {
    // every read of rows[] for the previous offset happened before the
    // barrier that ends its Cin loop (or before the skip test below)
    int src = n;
    if (tid < BM) {
      const int r = row0 + tid;
      src = r < n ? idx[(long)r * kvol + d] : n;
      rows[tid] = src;
    }
    // a barrier as well: rows[] is complete after it
    if (!__syncthreads_or(tid < BM && (unsigned)src < (unsigned)n)) continue;
    for (int k0 = 0; k0 < cin; k0 += BK) {
      for (int e = tid; e < BM * BK; e += THREADS) {
        const int r = e / BK, c = e % BK;
        const int s = rows[r], kc = k0 + c;
        as[c][r] = ((unsigned)s < (unsigned)n && kc < cin) ? to_f(feat[(long)s * cin + kc]) : 0.f;
      }
      for (int e = tid; e < BK * BN; e += THREADS) {
        const int kr = e / BN, c = e % BN;
        const int kk = k0 + kr, cc = col0 + c;
        bs[kr][c] = (kk < cin && cc < cout) ? to_f(w[((long)d * cin + kk) * cout + cc]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(&as[kk][ty * TM]);
        const float4 b = *reinterpret_cast<const float4*>(&bs[kk][tx * TN]);
        const float av[TM] = {a.x, a.y, a.z, a.w};
        const float bv[TN] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty * TM + i;
    if (r >= n) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + tx * TN + j;
      if (c >= cout) continue;
      if (partial)
        partial[((long)blockIdx.z * n + r) * cout + c] = acc[i][j];
      else
        store(out + (long)r * cout + c, acc[i][j]);
    }
  }
}

// out[i] = sum_z partial[z][i], z in order, for the `total` entries: N * Cout
// of B3's output, or K * Cin * Cout of B4's dW (T = float).
template <typename T>
__global__ void sum_splits_kernel(const float* __restrict__ partial, T* __restrict__ out, long total,
                                  int splits) {
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < total; i += (long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += partial[z * total + i];
    store(out + i, s);
  }
}

template <typename T>
int launch(const T* feat, const int* idx, const T* w, T* out, float* workspace, int n, int kvol,
           int cin, int cout, int splits, cudaStream_t s) {
  const int per_split = (kvol + splits - 1) / splits;
  const dim3 grid((cout + BN - 1) / BN, (n + BM - 1) / BM, splits);
  subm_conv_kernel<T><<<grid, THREADS, 0, s>>>(feat, idx, w, splits > 1 ? workspace : nullptr, out, n,
                                               kvol, cin, cout, per_split);
  if (splits > 1) {
    const long total = (long)n * cout;
    const long want = (total + 255) / 256;
    const int blocks = want < 4096 ? (int)want : 4096;
    sum_splits_kernel<T><<<blocks, 256, 0, s>>>(workspace, out, total, splits);
  }
  return (int)cudaGetLastError();
}

// Split blockIdx.z / kvol writes its f32 sum to dw_out[split] ([kvol, cin, cout] each).
template <typename T>
__global__ void __launch_bounds__(THREADS) subm_conv_dw_kernel(
    const T* __restrict__ feat, const int* __restrict__ idx, const T* __restrict__ grad,
    float* __restrict__ dw_out, int n, int kvol, int cin, int cout, int rows_per_split) {
  __shared__ int src_rows[CHUNK];  // the hit rows' neighbours: rows of feat
  __shared__ int dst_rows[CHUNK];  // the hit rows themselves: rows of grad
  __shared__ int warp_hits[WARPS];
  __shared__ __align__(16) float as[BK][BM];  // as[r][c] = feat[src_rows[r], ci0 + c]
  __shared__ __align__(16) float bs[BK][BN];  // bs[r][c] = grad[dst_rows[r], co0 + c]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  const int co0 = blockIdx.x * BN, ci0 = blockIdx.y * BM;
  const int d = blockIdx.z % kvol, split = blockIdx.z / kvol;
  const int r_begin = split * rows_per_split;
  const int r_end = min(n, r_begin + rows_per_split);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int r0 = r_begin; r0 < r_end; r0 += CHUNK) {
    const int r = r0 + tid;
    const int src = r < r_end ? idx[(long)r * kvol + d] : n;
    const bool hit = (unsigned)src < (unsigned)n;
    const unsigned mask = __ballot_sync(0xffffffffu, hit);
    // every read of warp_hits, src_rows and dst_rows for the previous chunk
    // happened before the last barrier that every thread passed
    if (lane == 0) warp_hits[warp] = __popc(mask);
    __syncthreads();
    int base = 0, total = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const int c = warp_hits[w];
      base += w < warp ? c : 0;
      total += c;
    }
    if (hit) {
      const int pos = base + __popc(mask & ((1u << lane) - 1u));
      src_rows[pos] = src;
      dst_rows[pos] = r;
    }
    __syncthreads();

    for (int k0 = 0; k0 < total; k0 += BK) {
      for (int e = tid; e < BK * BM; e += THREADS) {
        const int kk = e / BM, c = e % BM;
        const int ci = ci0 + c;
        as[kk][c] = (k0 + kk < total && ci < cin) ? to_f(feat[(long)src_rows[k0 + kk] * cin + ci]) : 0.f;
      }
      for (int e = tid; e < BK * BN; e += THREADS) {
        const int kk = e / BN, c = e % BN;
        const int co = co0 + c;
        bs[kk][c] = (k0 + kk < total && co < cout) ? to_f(grad[(long)dst_rows[k0 + kk] * cout + co]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(&as[kk][ty * TM]);
        const float4 b = *reinterpret_cast<const float4*>(&bs[kk][tx * TN]);
        const float av[TM] = {a.x, a.y, a.z, a.w};
        const float bv[TN] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  float* dst = dw_out + ((long)split * kvol + d) * cin * cout;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int ci = ci0 + ty * TM + i;
    if (ci >= cin) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int co = co0 + tx * TN + j;
      if (co < cout) dst[(long)ci * cout + co] = acc[i][j];
    }
  }
}

template <typename T>
int launch_dw(const T* feat, const int* idx, const T* grad, float* dw, float* workspace, int n, int kvol,
              int cin, int cout, int splits, int rows_per_split, cudaStream_t s) {
  const dim3 grid((cout + BN - 1) / BN, (cin + BM - 1) / BM, kvol * splits);
  subm_conv_dw_kernel<T><<<grid, THREADS, 0, s>>>(feat, idx, grad, splits > 1 ? workspace : dw, n, kvol, cin,
                                                  cout, rows_per_split);
  if (splits > 1) {
    const long total = (long)kvol * cin * cout;
    const long want = (total + 255) / 256;
    const int blocks = want < 4096 ? (int)want : 4096;
    sum_splits_kernel<float><<<blocks, 256, 0, s>>>(workspace, dw, total, splits);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// feat [n, cin], w [kvol, cin, cout] and out [n, cout] of one dtype (0 = f32,
// 1 = bf16); idx int32 [n, kvol]; with splits > 1, workspace is f32
// [splits, n, cout] (else unused).  Returns cudaGetLastError().
extern "C" int subm_conv_fwd(const void* feat, const void* idx, const void* w, void* out, void* workspace,
                             int n, int kvol, int cin, int cout, int splits, int dtype, void* stream) {
  if (n < 0 || kvol <= 0 || cin <= 0 || cout <= 0 || (dtype != 0 && dtype != 1) ||
      (n + BM - 1) / BM > 65535 || splits < 1 || splits > kvol || (splits > 1 && workspace == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ix = static_cast<const int*>(idx);
  float* ws = static_cast<float*>(workspace);
  if (dtype == 0)
    return launch(static_cast<const float*>(feat), ix, static_cast<const float*>(w), static_cast<float*>(out),
                  ws, n, kvol, cin, cout, splits, s);
  return launch(static_cast<const __nv_bfloat16*>(feat), ix, static_cast<const __nv_bfloat16*>(w),
                static_cast<__nv_bfloat16*>(out), ws, n, kvol, cin, cout, splits, s);
}

// feat [n, cin] and grad [n, cout] of one dtype (0 = f32, 1 = bf16); idx
// int32 [n, kvol]; dw f32 [kvol, cin, cout]; the N rows are cut into
// `splits` runs of rows_per_split rows, and with splits > 1 workspace is f32
// [splits, kvol, cin, cout] (else unused).  Returns cudaGetLastError().
extern "C" int subm_conv_dw(const void* feat, const void* idx, const void* grad, void* dw, void* workspace,
                            int n, int kvol, int cin, int cout, int splits, int rows_per_split, int dtype,
                            void* stream) {
  if (n < 0 || kvol <= 0 || cin <= 0 || cout <= 0 || (dtype != 0 && dtype != 1) || splits < 1 ||
      (long)kvol * splits > 65535 || (cin + BM - 1) / BM > 65535 || rows_per_split <= 0 ||
      (long)splits * rows_per_split < n || (splits > 1 && workspace == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ix = static_cast<const int*>(idx);
  float* out = static_cast<float*>(dw);
  float* ws = static_cast<float*>(workspace);
  if (dtype == 0)
    return launch_dw(static_cast<const float*>(feat), ix, static_cast<const float*>(grad), out, ws, n, kvol, cin,
                     cout, splits, rows_per_split, s);
  return launch_dw(static_cast<const __nv_bfloat16*>(feat), ix, static_cast<const __nv_bfloat16*>(grad), out, ws,
                   n, kvol, cin, cout, splits, rows_per_split, s);
}

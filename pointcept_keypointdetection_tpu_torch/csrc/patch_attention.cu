// Serialized patch attention, forward (B1) and backward (B2): hand-written
// kernels for Hopper (sm_90a) on the tensor cores.
//
// ---- What they compute ----
//
// B1 replaces the Pallas TPU kernel
// pointcept_keypointdetection_tpu/ops/pallas/patch_attention.py::_attn_kernel
// (reached through _pallas_forward).  Per (patch, head):
//     out = softmax(q k^T * scale, invalid keys at -1e9) v,
// f32 or bf16 in and out, f32 softmax statistics and accumulation.  q, k and
// v are read from qkv [N, 3, H, 16] by strides and out is written as
// [N, H*16]; no transposed copy exists.  For training B1 also writes each
// row's log-sum-exp (lse [N, H] f32) and, in bf16, the output once more in
// f32 (out32); serving passes null pointers.
//
// B2 replaces _attn_bwd_kernel (reached through _pallas_backward, the
// custom_vjp backward).  With P = exp(S - lse), S = q k^T * scale (-1e9 on
// invalid keys) and delta_i = rowsum(dO_i * O_i), O read in f32 (out32):
//     dv = P^T dO,  dS = P * (dO v^T - delta),  dq = dS k * scale,  dk = dS^T q * scale.
// As in the Pallas kernel, dS is not gated by the mask.
//
// Masking: an invalid key scores the finite -1e9, as on the TPU, so a patch
// whose keys are all invalid (dead) gives the mean of v and never NaN; a
// score is one FFMA, s * scale + bias, with (scale, bias) per key: (scale *
// log2(e), 0) valid, (0, -1e9 * log2(e)) invalid, (0, -inf) past the
// patch's end.  f32 cannot hold -1e9 + log(K) apart from -1e9, so a dead
// row's lse reads -1e9 and exp(S - lse) would give 1 instead of 1/K: B2
// recognises the row by its lse (below ALL_MASKED), takes P = exp2(S2 + 1e9 *
// log2(e)) = 1 (S2 is exactly -1e9 * log2(e) on every key) and divides the
// row's gradients by K at the end, as the Pallas softmax's 1/K gives.
//
// ---- Design ----
//
// The Pallas kernel holds a patch in VMEM and contracts it on the MXU.  Here
// a block owns ROWS = 128 stationary rows of one (patch, head), 16 per warp,
// and streams the other side of the patch through shared memory in tiles of
// KT = 64 rows, so a patch of 1024 needs no 1024 x 1024 score block (4 MB in
// f32, beyond a block's 227 KB).  Every product runs on the tensor cores
// with mma.sync (at head dim 16 a wgmma's 64-row tile is too shallow to
// pay):
//   bf16: mma.m16n8k16, bf16 operands, f32 accumulators; fragments by
//         ldmatrix (.trans where the slab is the k-major operand);
//   f32:  3xTF32 as in sparse_conv.cu: each operand split into a TF32 part
//         and a TF32 remainder, three mma.m16n8k8 per product (small x big,
//         big x small, big x big), ~f32 products.
// A warp computes its 16 x KT score slab into registers and feeds the
// probabilities (and dS) to the next product straight from its
// accumulators.  In bf16 the C layout of m16n8k16 is the A layout of the next
// one (FlashAttention-2); P and dS go in as a bf16 high part and a bf16 low
// part, two mma each (the bf16 analogue of 3xTF32, ~16 bits): rounded to bf16
// alone they moved B2's dq and dk by up to half an output ulp against the f32
// plain version, and one element of the trainer's enc0 shape past the bf16
// tolerance of chip_smoke.py.  In f32
// the TF32 A layout of m16n8k8 wants columns t and t + 4 where the
// accumulator holds 2t and 2t + 1, so the reduction index is permuted instead
// of the registers: logical column t is key 2t and t + 4 is key 2t + 1, and
// the B fragment reads the same two keys; a sum is the same in any order of
// its terms, so no shuffle and no trip through shared memory.
//
// The tensor cores truncate as they add into an f32 accumulator, which biased
// long sums (sparse_conv.cu, B4).  So each streamed tile's products (and each
// run of 64 keys of B2's one-pass dq) go into fresh registers and join the
// running sum with round-to-nearest f32 adds; in B1 that is the online-softmax
// rescale, acc = acc * corr + tile.
//
// Loads: a head's row is 16 contiguous elements (64 bytes in f32, 32 in
// bf16) at a stride of 3*H*16.  They come by 16-byte cp.async into a ring of
// shared-memory stages, rows padded (20 f32, 24 bf16 elements) so that
// ldmatrix and the scalar TF32 fragment loads hit 32 distinct banks.  A block
// walks several patches (`items`, chosen by the host so that about two
// blocks per SM cover the grid), and the ring runs on across them: the next
// patch's stationary rows (double-buffered) and tiles are in flight while
// this patch is computed, so a patch of 128, two tiles deep, is not a load
// then a wait then the math.  The few scalars a step also needs (key terms,
// lse, delta) are loaded into registers before the math of an earlier step
// and stored to shared memory after it, so their latency hides too.
//
// Exponentials: log2(e) is folded into the scale and into lse, so every
// exponential is one ex2.approx (relative error ~2^-22).
//
// B2, deterministic without atomics (each output element is summed by one
// warp in a fixed order), in one of two shapes:
//   patch <= ROWS (the trainer's 128): one pass.  The block holds the
//     patch's keys (key-stationary) and streams the queries; per tile of 64
//     queries it computes delta = rowsum(dO * out32) of the tile, each
//     warp's P and dS for its 16 keys (one exponential per score), sums dk
//     and dv, writes dS^T to shared memory, and after a barrier computes dq =
//     dS K of the tile's queries over all keys, a warp per 16 queries x 8
//     columns;
//   patch > ROWS (the bench's 1024): two kernels.  dq (query-stationary,
//     keys streamed) runs first and writes delta once per (row, head) to an
//     f32 scratch [N, H] that the wrapper allocates; dk/dv (key-stationary,
//     queries streamed) reads it.  Each recomputes P: two exponentials per
//     score.
//
// Bound: with the products on the tensor cores, the bytes bound both kernels
// (B1 reads qkv once and writes out, B2 reads qkv, dO, out32, lse and writes
// dqkv), in f32 as in bf16; the exponentials (one per score in B1 and in B2's
// one pass; MUFU gives ~16 per clock per SM) come next.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "tensor_core.cuh"

namespace {

constexpr int D = 16;         // head dim
constexpr int ROWS = 128;     // stationary rows per block: 8 warps x 16
constexpr int THREADS = 256;
constexpr int KT = 64;        // rows of a streamed tile
constexpr int STAGES = 3;     // cp.async ring depth
constexpr int MIN_BLOCKS = 2;  // blocks per SM the registers (128 a thread) must allow
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr float MASKED2 = -1e9f * LOG2E;     // the score of an invalid key, in base-2 units
constexpr float ALL_MASKED = -5e8f;          // an lse below this: every key of the row's patch is invalid

template <typename T>
struct Smem {
  static constexpr bool F32 = std::is_same<T, float>::value;
  static constexpr int VEC = 16 / sizeof(T);   // elements of one cp.async
  static constexpr int CHUNKS = D / VEC;       // copies per row: 4 (f32), 2 (bf16)
  static constexpr int LD = F32 ? D + 4 : D + 8;  // padded row: 80 or 48 bytes
  static constexpr int ROW_SLAB = ROWS * LD;   // elements of the block's stationary rows of one tensor
  static constexpr int TILE = KT * LD;         // elements of one streamed tile of one tensor
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// (x, y) as a bf16 pair high + low: high = bf16(x), low = bf16(x - high); high + low keeps ~16 bits
__device__ __forceinline__ void split_bf16(float x, float y, __nv_bfloat162& high, __nv_bfloat162& low) {
  high = __floats2bfloat162_rn(x, y);
  const float2 h = __bfloat1622float2(high);
  low = __floats2bfloat162_rn(x - h.x, y - h.y);
}
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& high, uint32_t& low) {
  __nv_bfloat162 h, l;
  split_bf16(x, y, h, l);
  high = *reinterpret_cast<uint32_t*>(&h);
  low = *reinterpret_cast<uint32_t*>(&l);
}

// rows [0, NROWS) of a [*, D] slab at src (row stride `stride` elements) into
// dst (row stride LD) by 16-byte cp.async; rows >= count are zero-filled
template <typename T, int NROWS>
__device__ __forceinline__ void copy_rows(T* dst, const T* src, long stride, int count, int tid) {
  using S = Smem<T>;
#pragma unroll
  for (int e = tid; e < NROWS * S::CHUNKS; e += THREADS) {
    const int r = e / S::CHUNKS, c = (e % S::CHUNKS) * S::VEC;
    const bool ok = r < count;
    cp_async16(dst + r * S::LD + c, ok ? src + (long)r * stride + c : src, ok);
  }
}

// ---- fragments of a padded [rows, 16] slab in shared memory ----

// bf16 A (m16 x k16): rows [r0, r0 + 16), all 16 columns
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const __nv_bfloat16* s, int r0, int lane) {
  ldsm_x4(a, s + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * Smem<__nv_bfloat16>::LD + (lane >> 4) * 8);
}
// bf16 B of a product with the slab transposed (n = rows [r0, r0 + 16), k = columns): two n8 tiles
__device__ __forceinline__ void frag_bt(uint32_t (&b)[2][2], const __nv_bfloat16* s, int r0, int lane) {
  uint32_t r[4];
  ldsm_x4(r, s + (r0 + (lane & 7) + (lane >> 4) * 8) * Smem<__nv_bfloat16>::LD + ((lane >> 3) & 1) * 8);
  b[0][0] = r[0], b[0][1] = r[1], b[1][0] = r[2], b[1][1] = r[3];
}
// bf16 B of a product with the slab (k = rows [r0, r0 + 16), n = columns): two n8 tiles
__device__ __forceinline__ void frag_b(uint32_t (&b)[2][2], const __nv_bfloat16* s, int r0, int lane) {
  uint32_t r[4];
  ldsm_x4_trans(r, s + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * Smem<__nv_bfloat16>::LD + (lane >> 4) * 8);
  b[0][0] = r[0], b[0][1] = r[1], b[1][0] = r[2], b[1][1] = r[3];
}

// TF32 A (m16 x k8, k steps kk = 0, 1): rows [r0, r0 + 16), big and small parts
__device__ __forceinline__ void frag_a(uint32_t (&big)[2][4], uint32_t (&small)[2][4], const float* s, int r0,
                                       int g, int t) {
  constexpr int LD = Smem<float>::LD;
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    const float* p = s + (r0 + g) * LD + kk * 8 + t;
    split_tf32(p[0], big[kk][0], small[kk][0]);
    split_tf32(p[8 * LD], big[kk][1], small[kk][1]);
    split_tf32(p[4], big[kk][2], small[kk][2]);
    split_tf32(p[8 * LD + 4], big[kk][3], small[kk][3]);
  }
}
// TF32 B of a product with the slab transposed: n = row r0 + g, k = columns kk * 8 + t, + 4
__device__ __forceinline__ void frag_bt(uint32_t (&big)[2], uint32_t (&small)[2], const float* s, int r0, int kk,
                                        int g, int t) {
  const float* p = s + (r0 + g) * Smem<float>::LD + kk * 8 + t;
  split_tf32(p[0], big[0], small[0]);
  split_tf32(p[4], big[1], small[1]);
}
// TF32 B of a product with the slab, k permuted: k t and t + 4 are rows r0 + 2t and r0 + 2t + 1, n =
// column c0 + g.  Pairs with a TF32 A taken from a C fragment by a_from_c.
__device__ __forceinline__ void frag_b(uint32_t (&big)[2], uint32_t (&small)[2], const float* s, int r0, int c0,
                                       int g, int t) {
  const float* p = s + (r0 + 2 * t) * Smem<float>::LD + c0 + g;
  split_tf32(p[0], big[0], small[0]);
  split_tf32(p[Smem<float>::LD], big[1], small[1]);
}
// TF32 A from one m16 x n8 C fragment (its 8 columns as the k step, in frag_b's permuted order)
__device__ __forceinline__ void a_from_c(uint32_t (&big)[4], uint32_t (&small)[4], const float (&c)[4]) {
  split_tf32(c[0], big[0], small[0]);
  split_tf32(c[2], big[1], small[1]);
  split_tf32(c[1], big[2], small[2]);
  split_tf32(c[3], big[3], small[3]);
}
// bf16 A (m16 x k16) from two m16 x n8 C fragments, as a high and a low part
__device__ __forceinline__ void a_from_c(uint32_t (&high)[4], uint32_t (&low)[4], const float (&c0)[4],
                                         const float (&c1)[4]) {
  split_bf16(c0[0], c0[1], high[0], low[0]);
  split_bf16(c0[2], c0[3], high[1], low[1]);
  split_bf16(c1[0], c1[1], high[2], low[2]);
  split_bf16(c1[2], c1[3], high[3], low[3]);
}

// c += a * b in 3xTF32
__device__ __forceinline__ void mma3(float* c, const uint32_t* a_big, const uint32_t* a_small, const uint32_t* b_big,
                                     const uint32_t* b_small) {
  mma_tf32(c, a_small, b_big);
  mma_tf32(c, a_big, b_small);
  mma_tf32(c, a_big, b_big);
}

// A fragments of a warp's 16 stationary rows of one tensor
template <typename T>
struct RowFrag;
template <>
struct RowFrag<float> {
  uint32_t big[2][4], small[2][4];
  __device__ __forceinline__ void load(const float* s, int r0, int lane) { frag_a(big, small, s, r0, lane >> 2, lane & 3); }
};
template <>
struct RowFrag<__nv_bfloat16> {
  uint32_t a[4];
  __device__ __forceinline__ void load(const __nv_bfloat16* s, int r0, int lane) { frag_a(a, s, r0, lane); }
};

// c[nt] (+)= rows x (tile rows [c0, c0 + 16))^T: the warp's 16 rows against 16 streamed rows, over d
__device__ __forceinline__ void scores16(float (&c)[2][4], const RowFrag<float>& a, const float* tile, int c0,
                                         int lane) {
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      uint32_t bb[2], bs[2];
      frag_bt(bb, bs, tile, c0 + nt * 8, kk, lane >> 2, lane & 3);
      mma3(c[nt], a.big[kk], a.small[kk], bb, bs);
    }
}
__device__ __forceinline__ void scores16(float (&c)[2][4], const RowFrag<__nv_bfloat16>& a,
                                         const __nv_bfloat16* tile, int c0, int lane) {
  uint32_t b[2][2];
  frag_bt(b, tile, c0, lane);
  mma_bf16(c[0], a.a, b[0]);
  mma_bf16(c[1], a.a, b[1]);
}

// o[nd] += c (16 x 16 columns [c0, c0 + 16) of a score slab, as two C fragments) x tile rows [c0, c0 + 16)
__device__ __forceinline__ void weigh16(float (&o)[2][4], const float (&c0f)[4], const float (&c1f)[4],
                                        const float* tile, int c0, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    uint32_t ab[4], as[4];
    a_from_c(ab, as, kk ? c1f : c0f);
#pragma unroll
    for (int nd = 0; nd < 2; ++nd) {
      uint32_t bb[2], bs[2];
      frag_b(bb, bs, tile, c0 + kk * 8, nd * 8, g, t);
      mma3(o[nd], ab, as, bb, bs);
    }
  }
}
// bf16: the weights (P or dS) as high + low parts, two mma each: bf16 alone (8 bits) moved B2's
// dq and dk by up to half an output ulp against the f32 plain version
__device__ __forceinline__ void weigh16(float (&o)[2][4], const float (&c0f)[4], const float (&c1f)[4],
                                        const __nv_bfloat16* tile, int c0, int lane) {
  uint32_t high[4], low[4], b[2][2];
  a_from_c(high, low, c0f, c1f);
  frag_b(b, tile, c0, lane);
#pragma unroll
  for (int nd = 0; nd < 2; ++nd) {
    mma_bf16(o[nd], low, b[nd]);
    mma_bf16(o[nd], high, b[nd]);
  }
}

// ---- The block's pipeline ----

constexpr int MAX_ITEMS = 8;  // patches one block walks

// A block walks `items` patches (its items) of one (head, row block), each in `tiles` streamed
// tiles: steps = items * tiles.  load(s) issues step s's copies NSTAGES - 1 steps ahead into ring
// stage s % NSTAGES, and with an item's first tile the item's stationary rows into buffer item % 2,
// so the next item's loads overlap this item's math.  get(s) loads a thread's few scalars of step s
// into registers before the math of step s - NSTAGES + 1, and put(s, v) stores them to shared
// memory after it, so their latency hides behind that math too.  Two buffers of stationary rows
// suffice when an item has at least NSTAGES - 1 tiles (the host gives a block one item otherwise):
// item j + 1's copies start once item j - 1's last step is done.
template <int NSTAGES, typename Side, typename Load, typename Get, typename Put, typename Math>
__device__ __forceinline__ void pipeline(int steps, Load load, Get get, Put put, Math math) {
#pragma unroll
  for (int s = 0; s < NSTAGES - 1; ++s) {
    if (s < steps) load(s);
    cp_async_commit();
    put(s, get(s));
  }
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<NSTAGES - 2>();
    __syncthreads();  // step s landed for every thread; the stage of step s - 1 is free
    const int next = s + NSTAGES - 1;
    if (next < steps) load(next);
    cp_async_commit();
    const Side v = get(next);
    math(s);
    put(next, v);
  }
  cp_async_wait<0>();
}

// The scale and bias of a key's base-2 score s * scale + bias: (scale * log2(e), 0) for a valid key,
// (0, -1e9 * log2(e)) for an invalid one, (0, -inf) past the patch.
__device__ __forceinline__ float2 key_terms(bool in_patch, bool is_valid, float scale2) {
  return !in_patch ? make_float2(0.f, -INFINITY) : is_valid ? make_float2(scale2, 0.f) : make_float2(0.f, MASKED2);
}
// -lse * log2(e) of a row; -MASKED2 for a row whose keys are all invalid (lse below ALL_MASKED), so
// that its P = exp2(MASKED2 - MASKED2) = 1 on every key, and its gradients are divided by K at the end
__device__ __forceinline__ float neg_lse2(float lse) { return lse < ALL_MASKED ? -MASKED2 : -lse * LOG2E; }

// ---- B1 ----

template <typename T>
struct FwdSmem {
  using S = Smem<T>;
  static constexpr size_t bytes =
      (size_t)(2 * S::ROW_SLAB + 2 * STAGES * S::TILE) * sizeof(T) + STAGES * KT * sizeof(float2);
};

// Block (x, y, z): patches [x * items, +items), head y, queries [z * ROWS, +ROWS) of each; keys streamed.
template <typename T>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) attention_fwd_kernel(
    const T* __restrict__ qkv, const unsigned char* __restrict__ valid, T* __restrict__ out,
    float* __restrict__ lse, float* __restrict__ out32, int heads, int patch, int patches, int items,
    float scale) {
  using S = Smem<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);  // [2][ROW_SLAB]
  T* ks = qs + 2 * S::ROW_SLAB;        // [STAGES][TILE]
  T* vs = ks + STAGES * S::TILE;       // [STAGES][TILE]
  float2* kterms = reinterpret_cast<float2*>(vs + STAGES * S::TILE);  // [STAGES][KT]

  const int tid = threadIdx.x, lane = tid & 31, r0 = (tid >> 5) * 16, g = lane >> 2, t = lane & 3;
  const int h = blockIdx.y, q0 = blockIdx.z * ROWS, p0 = blockIdx.x * items;
  const long pstride = 3L * heads * D;
  const int tiles = (patch + KT - 1) / KT, steps = min(items, patches - p0) * tiles;
  const bool busy = q0 + r0 < patch;  // the warp has a query
  const float scale2 = scale * LOG2E;

  auto load = [&](int s) {
    const int j = s / tiles, k0 = (s % tiles) * KT;
    const long first = (long)(p0 + j) * patch;
    if (k0 == 0)
      copy_rows<T, ROWS>(qs + (j & 1) * S::ROW_SLAB, qkv + (first + q0) * pstride + (long)h * D, pstride,
                         patch - q0, tid);
    const T* kb = qkv + (first + k0) * pstride + (long)(heads + h) * D;
    copy_rows<T, KT>(ks + (s % STAGES) * S::TILE, kb, pstride, patch - k0, tid);
    copy_rows<T, KT>(vs + (s % STAGES) * S::TILE, kb + (long)heads * D, pstride, patch - k0, tid);
  };
  auto get = [&](int s) -> float2 {  // threads < KT: key (s % tiles) * KT + tid
    const int key = (s % tiles) * KT + tid;
    if (tid >= KT || s >= steps || key >= patch) return key_terms(false, false, scale2);
    return key_terms(true, valid[(long)(p0 + s / tiles) * patch + key], scale2);
  };
  auto put = [&](int s, float2 v) {
    if (tid < KT) kterms[(s % STAGES) * KT + tid] = v;
  };

  RowFrag<T> qf;
  float m[2], l[2], acc[2][4];  // l: this thread's columns only, summed over the quad at the end
  auto math = [&](int s) {
    if (!busy) return;
    const int j = s / tiles, i = s % tiles, st = s % STAGES;
    if (i == 0) {
      qf.load(qs + (j & 1) * S::ROW_SLAB, r0, lane);
#pragma unroll
      for (int r = 0; r < 2; ++r) m[r] = -INFINITY, l[r] = 0.f;
#pragma unroll
      for (int nd = 0; nd < 2; ++nd)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;
    }
    const T* kt = ks + st * S::TILE;
    const T* vt = vs + st * S::TILE;
    const float2* terms = kterms + st * KT;
    float sc[4][2][4] = {};  // the 16 x 64 score slab, in chunks of 16 keys
#pragma unroll
    for (int c = 0; c < 4; ++c) scores16(sc[c], qf, kt, c * 16, lane);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const float4 k = *reinterpret_cast<const float4*>(terms + c * 16 + nt * 8 + 2 * t);  // keys 2t, 2t + 1
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float& x = sc[c][nt][e];
          x = (e & 1) ? fmaf(x, k.z, k.w) : fmaf(x, k.x, k.y);
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
    float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);  // finite: a tile holds a key of the patch
      corr[r] = ex2(m[r] - m_new);             // 0 while m is still -inf
      m[r] = m_new;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[c][nt][e] = ex2(sc[c][nt][e] - m[e >> 1]);
          rs[e >> 1] += sc[c][nt][e];
        }
    float o[2][4] = {};  // this tile's P V, in fresh registers
#pragma unroll
    for (int c = 0; c < 4; ++c) weigh16(o, sc[c][0], sc[c][1], vt, c * 16, lane);
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + rs[r];
#pragma unroll
    for (int nd = 0; nd < 2; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nd][e] = acc[nd][e] * corr[e >> 1] + o[nd][e];
    if (i < tiles - 1) return;

    const long first = (long)(p0 + j) * patch;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float sum = l[r] + __shfl_xor_sync(0xffffffffu, l[r], 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const int row = q0 + r0 + g + 8 * r;
      if (row >= patch) continue;
      const float inv = 1.f / sum;
      const long at = (first + row) * heads * D + (long)h * D;
#pragma unroll
      for (int nd = 0; nd < 2; ++nd) {
        const int c = nd * 8 + 2 * t;
        const float a = acc[nd][2 * r] * inv, b = acc[nd][2 * r + 1] * inv;
        store2(out + at + c, a, b);
        if (out32 != nullptr) store2(out32 + at + c, a, b);
      }
      if (lse != nullptr && t == 0) lse[(first + row) * heads + h] = (m[r] + log2f(sum)) * LN2;
    }
  };
  pipeline<STAGES, float2>(steps, load, get, put, math);
}

// ---- B2 ----

template <typename T>
struct DqSmem {
  using S = Smem<T>;
  static constexpr int OLD = Smem<float>::LD;  // padded f32 row of out32
  static constexpr size_t bytes = (size_t)(4 * S::ROW_SLAB + 2 * STAGES * S::TILE) * sizeof(T) +
                                  (size_t)2 * ROWS * OLD * sizeof(float) + STAGES * KT * sizeof(float2) +
                                  2 * ROWS * sizeof(float);
};

// dq.  Block (x, y, z): patches [x * items, +items), head y, queries [z * ROWS, +ROWS); keys
// streamed.  Also writes delta [N, H] for the dk/dv kernel.
template <typename T>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) attention_bwd_dq_kernel(
    const T* __restrict__ qkv, const unsigned char* __restrict__ valid, const float* __restrict__ out32,
    const float* __restrict__ lse, const T* __restrict__ grad, T* __restrict__ dqkv, float* __restrict__ delta,
    int heads, int patch, int patches, int items, float scale) {
  using S = Smem<T>;
  constexpr int OLD = DqSmem<T>::OLD;
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);  // [2][ROW_SLAB]
  T* gs = qs + 2 * S::ROW_SLAB;        // [2][ROW_SLAB]
  T* ks = gs + 2 * S::ROW_SLAB;        // [STAGES][TILE]
  T* vs = ks + STAGES * S::TILE;       // [STAGES][TILE]
  float* os = reinterpret_cast<float*>(vs + STAGES * S::TILE);      // [2][ROWS * OLD]: out32 rows
  float2* kterms = reinterpret_cast<float2*>(os + 2 * ROWS * OLD);  // [STAGES][KT]
  float* rnl = reinterpret_cast<float*>(kterms + STAGES * KT);      // [2][ROWS]: neg_lse2 of a query

  const int tid = threadIdx.x, lane = tid & 31, r0 = (tid >> 5) * 16, g = lane >> 2, t = lane & 3;
  const int h = blockIdx.y, q0 = blockIdx.z * ROWS, p0 = blockIdx.x * items;
  const long pstride = 3L * heads * D, rstride = (long)heads * D;
  const int tiles = (patch + KT - 1) / KT, steps = min(items, patches - p0) * tiles;
  const bool busy = q0 + r0 < patch;
  const float scale2 = scale * LOG2E;

  auto load = [&](int s) {
    const int j = s / tiles, k0 = (s % tiles) * KT;
    const long first = (long)(p0 + j) * patch;
    if (k0 == 0) {
      const long row = first + q0;
      copy_rows<T, ROWS>(qs + (j & 1) * S::ROW_SLAB, qkv + row * pstride + (long)h * D, pstride, patch - q0, tid);
      copy_rows<T, ROWS>(gs + (j & 1) * S::ROW_SLAB, grad + row * rstride + (long)h * D, rstride, patch - q0, tid);
      copy_rows<float, ROWS>(os + (j & 1) * ROWS * OLD, out32 + row * rstride + (long)h * D, rstride, patch - q0,
                             tid);
    }
    const T* kb = qkv + (first + k0) * pstride + (long)(heads + h) * D;
    copy_rows<T, KT>(ks + (s % STAGES) * S::TILE, kb, pstride, patch - k0, tid);
    copy_rows<T, KT>(vs + (s % STAGES) * S::TILE, kb + (long)heads * D, pstride, patch - k0, tid);
  };
  struct Side {
    float2 key;  // threads < KT: key_terms of key (s % tiles) * KT + tid
    float row;   // threads < ROWS, an item's first step: neg_lse2 of query q0 + tid
  };
  auto get = [&](int s) -> Side {
    Side v{key_terms(false, false, scale2), 0.f};
    if (s >= steps) return v;
    const long first = (long)(p0 + s / tiles) * patch;
    const int key = (s % tiles) * KT + tid;
    if (tid < KT && key < patch) v.key = key_terms(true, valid[first + key], scale2);
    if (s % tiles == 0 && tid < ROWS && q0 + tid < patch) v.row = neg_lse2(lse[(first + q0 + tid) * heads + h]);
    return v;
  };
  auto put = [&](int s, const Side& v) {
    if (tid < KT) kterms[(s % STAGES) * KT + tid] = v.key;
    if (s < steps && s % tiles == 0 && tid < ROWS) rnl[((s / tiles) & 1) * ROWS + tid] = v.row;
  };

  RowFrag<T> qf, gf;
  float nl2[2], dl[2], dq[2][4];  // of the rows g, g + 8
  auto math = [&](int s) {
    if (!busy) return;
    const int j = s / tiles, i = s % tiles, st = s % STAGES;
    const long first = (long)(p0 + j) * patch;
    if (i == 0) {
      const T* q = qs + (j & 1) * S::ROW_SLAB;
      const T* gq = gs + (j & 1) * S::ROW_SLAB;
      qf.load(q, r0, lane);
      gf.load(gq, r0, lane);
      // delta = rowsum(dO * out32) of row r0 + lane / 2, columns 8 * (lane % 2) on, then the pair's sum
      const T* gp = gq + (r0 + (lane >> 1)) * S::LD + 8 * (lane & 1);
      const float* op = os + (j & 1) * ROWS * OLD + (r0 + (lane >> 1)) * OLD + 8 * (lane & 1);
      float d = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) d = fmaf(to_f(gp[e]), op[e], d);
      d += __shfl_xor_sync(0xffffffffu, d, 1);
      const int drow = q0 + r0 + (lane >> 1);
      if ((lane & 1) == 0 && drow < patch) delta[(first + drow) * heads + h] = d;
      dl[0] = __shfl_sync(0xffffffffu, d, 2 * g);
      dl[1] = __shfl_sync(0xffffffffu, d, 2 * g + 16);
#pragma unroll
      for (int r = 0; r < 2; ++r) nl2[r] = rnl[(j & 1) * ROWS + r0 + g + 8 * r];
#pragma unroll
      for (int nd = 0; nd < 2; ++nd)
#pragma unroll
        for (int e = 0; e < 4; ++e) dq[nd][e] = 0.f;
    }
    const T* kt = ks + st * S::TILE;
    const T* vt = vs + st * S::TILE;
    const float2* terms = kterms + st * KT;
    float dqt[2][4] = {};  // this tile's dS K, in fresh registers
#pragma unroll
    for (int c0 = 0; c0 < KT; c0 += 16) {
      float sc[2][4] = {}, dp[2][4] = {};
      scores16(sc, qf, kt, c0, lane);
      scores16(dp, gf, vt, c0, lane);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const float4 k = *reinterpret_cast<const float4*>(terms + c0 + nt * 8 + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = (e & 1) ? fmaf(sc[nt][e], k.z, k.w) : fmaf(sc[nt][e], k.x, k.y);
          const float p = ex2(x + nl2[e >> 1]);
          sc[nt][e] = p * (dp[nt][e] - dl[e >> 1]);  // dS
        }
      }
      weigh16(dqt, sc[0], sc[1], kt, c0, lane);
    }
#pragma unroll
    for (int nd = 0; nd < 2; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) dq[nd][e] += dqt[nd][e];
    if (i < tiles - 1) return;

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + r0 + g + 8 * r;
      if (row >= patch) continue;
      const float f = nl2[r] == -MASKED2 ? scale / patch : scale;  // P = 1 in a dead row: 1/K here
      T* dst = dqkv + (first + row) * pstride + (long)h * D;
#pragma unroll
      for (int nd = 0; nd < 2; ++nd) store2(dst + nd * 8 + 2 * t, dq[nd][2 * r] * f, dq[nd][2 * r + 1] * f);
    }
  };
  pipeline<STAGES, Side>(steps, load, get, put, math);
}

template <typename T>
struct DkvSmem {
  using S = Smem<T>;
  static constexpr size_t bytes = (size_t)(4 * S::ROW_SLAB + 2 * STAGES * S::TILE) * sizeof(T) +
                                  STAGES * KT * sizeof(float2) + 2 * ROWS * sizeof(float2);
};

// dk, dv.  Block (x, y, z): patches [x * items, +items), head y, keys [z * ROWS, +ROWS); queries
// streamed with their neg_lse2 (-inf past the patch: P = 0) and delta.
template <typename T>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) attention_bwd_dkdv_kernel(
    const T* __restrict__ qkv, const unsigned char* __restrict__ valid, const float* __restrict__ lse,
    const float* __restrict__ delta, const T* __restrict__ grad, T* __restrict__ dqkv, int heads, int patch,
    int patches, int items, float scale) {
  using S = Smem<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);  // [2][ROW_SLAB]
  T* vs = ks + 2 * S::ROW_SLAB;        // [2][ROW_SLAB]
  T* qs = vs + 2 * S::ROW_SLAB;        // [STAGES][TILE]
  T* gs = qs + STAGES * S::TILE;       // [STAGES][TILE]
  float2* qterms = reinterpret_cast<float2*>(gs + STAGES * S::TILE);  // [STAGES][KT]: (neg_lse2, delta)
  float2* kterms = qterms + STAGES * KT;                              // [2][ROWS]: key_terms of a key

  const int tid = threadIdx.x, lane = tid & 31, r0 = (tid >> 5) * 16, g = lane >> 2, t = lane & 3;
  const int h = blockIdx.y, k0b = blockIdx.z * ROWS, p0 = blockIdx.x * items;
  const long pstride = 3L * heads * D, rstride = (long)heads * D;
  const int tiles = (patch + KT - 1) / KT, steps = min(items, patches - p0) * tiles;
  const bool busy = k0b + r0 < patch;
  const float scale2 = scale * LOG2E;

  auto load = [&](int s) {
    const int j = s / tiles, q0 = (s % tiles) * KT;
    const long first = (long)(p0 + j) * patch;
    if (q0 == 0) {
      const T* kb = qkv + (first + k0b) * pstride + (long)(heads + h) * D;
      copy_rows<T, ROWS>(ks + (j & 1) * S::ROW_SLAB, kb, pstride, patch - k0b, tid);
      copy_rows<T, ROWS>(vs + (j & 1) * S::ROW_SLAB, kb + (long)heads * D, pstride, patch - k0b, tid);
    }
    copy_rows<T, KT>(qs + (s % STAGES) * S::TILE, qkv + (first + q0) * pstride + (long)h * D, pstride, patch - q0,
                     tid);
    copy_rows<T, KT>(gs + (s % STAGES) * S::TILE, grad + (first + q0) * rstride + (long)h * D, rstride, patch - q0,
                     tid);
  };
  struct Side {
    float2 query;  // threads < KT: (neg_lse2, delta) of query (s % tiles) * KT + tid
    float2 key;    // threads < ROWS, an item's first step: key_terms of key k0b + tid
  };
  auto get = [&](int s) -> Side {
    Side v{make_float2(-INFINITY, 0.f), key_terms(false, false, scale2)};
    if (s >= steps) return v;
    const long first = (long)(p0 + s / tiles) * patch;
    const int q = (s % tiles) * KT + tid;
    if (tid < KT && q < patch) {
      const long at = (first + q) * heads + h;
      v.query = make_float2(neg_lse2(lse[at]), delta[at]);
    }
    if (s % tiles == 0 && tid < ROWS) v.key = key_terms(k0b + tid < patch, valid[first + min(k0b + tid, patch - 1)], scale2);
    return v;
  };
  auto put = [&](int s, const Side& v) {
    if (tid < KT) qterms[(s % STAGES) * KT + tid] = v.query;
    if (s < steps && s % tiles == 0 && tid < ROWS) kterms[((s / tiles) & 1) * ROWS + tid] = v.key;
  };

  RowFrag<T> kf, vf;
  float2 kt2[2];  // key_terms of the keys g, g + 8
  float item_f, dk[2][4], dv[2][4];
  auto math = [&](int s) {
    if (!busy) return;
    const int j = s / tiles, i = s % tiles, st = s % STAGES;
    const float2* terms = qterms + st * KT;
    if (i == 0) {
      kf.load(ks + (j & 1) * S::ROW_SLAB, r0, lane);
      vf.load(vs + (j & 1) * S::ROW_SLAB, r0, lane);
#pragma unroll
      for (int r = 0; r < 2; ++r) kt2[r] = kterms[(j & 1) * ROWS + r0 + g + 8 * r];
      item_f = terms[0].x == -MASKED2 ? 1.f / patch : 1.f;  // a dead patch: P = 1 here, 1/K in truth
#pragma unroll
      for (int nd = 0; nd < 2; ++nd)
#pragma unroll
        for (int e = 0; e < 4; ++e) dk[nd][e] = dv[nd][e] = 0.f;
    }
    const T* qt = qs + st * S::TILE;
    const T* gt = gs + st * S::TILE;
    float dkt[2][4] = {}, dvt[2][4] = {};  // this tile's dS^T Q and P^T dO, in fresh registers
#pragma unroll
    for (int c0 = 0; c0 < KT; c0 += 16) {
      float sc[2][4] = {}, dp[2][4] = {};  // S^T and dP^T: the warp's 16 keys x 16 queries
      scores16(sc, kf, qt, c0, lane);
      scores16(dp, vf, gt, c0, lane);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const float4 q = *reinterpret_cast<const float4*>(terms + c0 + nt * 8 + 2 * t);  // queries 2t, 2t + 1
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 k = kt2[e >> 1];
          const float p = ex2(fmaf(sc[nt][e], k.x, k.y) + ((e & 1) ? q.z : q.x));
          sc[nt][e] = p;
          dp[nt][e] = p * (dp[nt][e] - ((e & 1) ? q.w : q.y));  // dS^T
        }
      }
      weigh16(dvt, sc[0], sc[1], gt, c0, lane);
      weigh16(dkt, dp[0], dp[1], qt, c0, lane);
    }
#pragma unroll
    for (int nd = 0; nd < 2; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dk[nd][e] += dkt[nd][e];
        dv[nd][e] += dvt[nd][e];
      }
    if (i < tiles - 1) return;

    const long first = (long)(p0 + j) * patch;
    const float fk = item_f * scale;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = k0b + r0 + g + 8 * r;
      if (row >= patch) continue;
      T* dst = dqkv + (first + row) * pstride + (long)(heads + h) * D;
#pragma unroll
      for (int nd = 0; nd < 2; ++nd) {
        const int c = nd * 8 + 2 * t;
        store2(dst + c, dk[nd][2 * r] * fk, dk[nd][2 * r + 1] * fk);
        store2(dst + (long)heads * D + c, dv[nd][2 * r] * item_f, dv[nd][2 * r + 1] * item_f);
      }
    }
  };
  pipeline<STAGES, Side>(steps, load, get, put, math);
}

// ---- B2 in one pass, where a block holds a patch's keys (patch <= ROWS) ----

template <typename T>
struct FusedSmem {
  using S = Smem<T>;
  static constexpr int STAGES = S::F32 ? 2 : 3;  // ring depth: two f32 blocks per SM fit with 2
  static constexpr int OLD = Smem<float>::LD;     // padded f32 row of out32
  static constexpr int LDS = S::F32 ? KT + 4 : KT + 8;  // padded row of the dS^T tile: conflict-free fragments
  static constexpr int DS_TILES = S::F32 ? 1 : 2;        // bf16: high and low parts
  static constexpr size_t bytes =
      (size_t)(4 * S::ROW_SLAB + 2 * STAGES * S::TILE + DS_TILES * ROWS * LDS) * sizeof(T) +
                                  (size_t)STAGES * KT * OLD * sizeof(float) + STAGES * KT * sizeof(float2) +
                                  2 * ROWS * sizeof(float2);
};

// dq[16 x 8] += dS[m0 .. m0 + 16, keys] K[keys, n0 .. n0 + 8] over keys [k0, k1), from the dS^T tile
// ds (key-major, row LDS; in bf16 its high part, the low part ROWS * LDS further) and the stationary
// key slab ks
template <int LDS>
__device__ __forceinline__ void dq_slab(float (&c)[4], const __nv_bfloat16* ds, const __nv_bfloat16* ks, int m0,
                                        int n0, int k0, int k1, int lane) {
  for (int kk = k0; kk < k1; kk += 16) {
    uint32_t high[4], low[4], b[2][2];
    const __nv_bfloat16* a = ds + (kk + (lane & 7) + (lane >> 4) * 8) * LDS + m0 + ((lane >> 3) & 1) * 8;
    ldsm_x4_trans(high, a);
    ldsm_x4_trans(low, a + ROWS * LDS);
    frag_b(b, ks, kk, lane);
    const uint32_t bn[2] = {n0 ? b[1][0] : b[0][0], n0 ? b[1][1] : b[0][1]};
    mma_bf16(c, low, bn);
    mma_bf16(c, high, bn);
  }
}
template <int LDS>
__device__ __forceinline__ void dq_slab(float (&c)[4], const float* ds, const float* ks, int m0, int n0, int k0,
                                        int k1, int lane) {
  const int g = lane >> 2, t = lane & 3;
  for (int kk = k0; kk < k1; kk += 8) {
    // k permuted as in frag_b: t is key kk + 2t, t + 4 is key kk + 2t + 1
    const float* ap = ds + (kk + 2 * t) * LDS + m0 + g;
    uint32_t ab[4], as[4], bb[2], bs[2];
    split_tf32(ap[0], ab[0], as[0]);
    split_tf32(ap[8], ab[1], as[1]);
    split_tf32(ap[LDS], ab[2], as[2]);
    split_tf32(ap[LDS + 8], ab[3], as[3]);
    frag_b(bb, bs, ks, kk, n0, g, t);
    mma3(c, ab, as, bb, bs);
  }
}

// dq, dk and dv in one pass.  Block (x, y): patches [x * items, +items), head y; the patch's keys
// stationary (16 per warp), queries streamed in tiles of KT.  Per tile: delta = rowsum(dO * out32)
// of its queries; each warp's P and dS for its keys (one exponential per score), dk and dv summed;
// dS^T to shared memory; then dq = dS K of the tile's queries over all keys, a warp per 16 queries
// x 8 columns, in a fixed order.
template <typename T>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) attention_bwd_fused_kernel(
    const T* __restrict__ qkv, const unsigned char* __restrict__ valid, const float* __restrict__ out32,
    const float* __restrict__ lse, const T* __restrict__ grad, T* __restrict__ dqkv, int heads, int patch,
    int patches, int items, float scale) {
  using S = Smem<T>;
  using F = FusedSmem<T>;
  constexpr int NST = F::STAGES, OLD = F::OLD, LDS = F::LDS;
  static_assert(THREADS == 4 * KT && ROWS == 2 * KT, "delta: four threads a query; dq: 4 x 2 warp slabs");
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);  // [2][ROW_SLAB]
  T* vs = ks + 2 * S::ROW_SLAB;        // [2][ROW_SLAB]
  T* qs = vs + 2 * S::ROW_SLAB;        // [NST][TILE]
  T* gs = qs + NST * S::TILE;          // [NST][TILE]
  T* dst = gs + NST * S::TILE;         // [DS_TILES][ROWS][LDS]: dS^T of the tile
  float* os = reinterpret_cast<float*>(dst + F::DS_TILES * ROWS * LDS);  // [NST][KT * OLD]: out32 rows
  float2* qterms = reinterpret_cast<float2*>(os + NST * KT * OLD);    // [NST][KT]: (neg_lse2, delta)
  float2* kterms = qterms + NST * KT;                                 // [2][ROWS]: key_terms of a key

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, r0 = warp * 16, g = lane >> 2, t = lane & 3;
  const int h = blockIdx.y, p0 = blockIdx.x * items;
  const long pstride = 3L * heads * D, rstride = (long)heads * D;
  const int tiles = (patch + KT - 1) / KT, steps = min(items, patches - p0) * tiles;
  const bool busy = r0 < patch;
  const int kmax = min(ROWS, (patch + 15) / 16 * 16);  // keys dq sums over: the busy warps' rows
  const float scale2 = scale * LOG2E;

  auto load = [&](int s) {
    const int j = s / tiles, q0 = (s % tiles) * KT;
    const long first = (long)(p0 + j) * patch;
    if (q0 == 0) {
      const T* kb = qkv + first * pstride + (long)(heads + h) * D;
      copy_rows<T, ROWS>(ks + (j & 1) * S::ROW_SLAB, kb, pstride, patch, tid);
      copy_rows<T, ROWS>(vs + (j & 1) * S::ROW_SLAB, kb + (long)heads * D, pstride, patch, tid);
    }
    const long row = first + q0;
    copy_rows<T, KT>(qs + (s % NST) * S::TILE, qkv + row * pstride + (long)h * D, pstride, patch - q0, tid);
    copy_rows<T, KT>(gs + (s % NST) * S::TILE, grad + row * rstride + (long)h * D, rstride, patch - q0, tid);
    copy_rows<float, KT>(os + (s % NST) * KT * OLD, out32 + row * rstride + (long)h * D, rstride, patch - q0, tid);
  };
  struct Side {
    float nl;    // threads < KT: neg_lse2 of query (s % tiles) * KT + tid (-inf past the patch)
    float2 key;  // threads < ROWS, an item's first step: key_terms of key tid
  };
  auto get = [&](int s) -> Side {
    Side v{-INFINITY, key_terms(false, false, scale2)};
    if (s >= steps) return v;
    const long first = (long)(p0 + s / tiles) * patch;
    const int q = (s % tiles) * KT + tid;
    if (tid < KT && q < patch) v.nl = neg_lse2(lse[(first + q) * heads + h]);
    if (s % tiles == 0 && tid < ROWS) v.key = key_terms(tid < patch, valid[first + min(tid, patch - 1)], scale2);
    return v;
  };
  auto put = [&](int s, const Side& v) {
    if (tid < KT) qterms[(s % NST) * KT + tid].x = v.nl;
    if (s < steps && s % tiles == 0 && tid < ROWS) kterms[((s / tiles) & 1) * ROWS + tid] = v.key;
  };

  RowFrag<T> kf, vf;
  float2 kt2[2];  // key_terms of the keys g, g + 8
  float item_f, dk[2][4], dv[2][4];
  auto math = [&](int s) {
    const int j = s / tiles, i = s % tiles, st = s % NST;
    const long first = (long)(p0 + j) * patch;
    const T* qt = qs + st * S::TILE;
    const T* gt = gs + st * S::TILE;
    const T* kslab = ks + (j & 1) * S::ROW_SLAB;
    float2* terms = qterms + st * KT;
    {  // delta of the tile's queries: four threads a query, four columns each
      const int q = tid >> 2, c = (tid & 3) * 4;
      const T* gp = gt + q * S::LD + c;
      const float* op = os + st * KT * OLD + q * OLD + c;
      float d = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) d = fmaf(to_f(gp[e]), op[e], d);
      d += __shfl_xor_sync(0xffffffffu, d, 1);
      d += __shfl_xor_sync(0xffffffffu, d, 2);
      if ((tid & 3) == 0) terms[q].y = d;
    }
    if (i == 0) item_f = terms[0].x == -MASKED2 ? 1.f / patch : 1.f;  // a dead patch: P = 1 here, 1/K in truth
    __syncthreads();  // delta is in shared memory
    if (busy) {
      if (i == 0) {
        kf.load(kslab, r0, lane);
        vf.load(vs + (j & 1) * S::ROW_SLAB, r0, lane);
#pragma unroll
        for (int r = 0; r < 2; ++r) kt2[r] = kterms[(j & 1) * ROWS + r0 + g + 8 * r];
#pragma unroll
        for (int nd = 0; nd < 2; ++nd)
#pragma unroll
          for (int e = 0; e < 4; ++e) dk[nd][e] = dv[nd][e] = 0.f;
      }
      float dkt[2][4] = {}, dvt[2][4] = {};  // this tile's dS^T Q and P^T dO, in fresh registers
#pragma unroll
      for (int c0 = 0; c0 < KT; c0 += 16) {
        float sc[2][4] = {}, dp[2][4] = {};  // S^T and dP^T: the warp's 16 keys x 16 queries
        scores16(sc, kf, qt, c0, lane);
        scores16(dp, vf, gt, c0, lane);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const float4 q = *reinterpret_cast<const float4*>(terms + c0 + nt * 8 + 2 * t);  // queries 2t, 2t + 1
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 k = kt2[e >> 1];
            const float p = ex2(fmaf(sc[nt][e], k.x, k.y) + ((e & 1) ? q.z : q.x));
            sc[nt][e] = p;
            dp[nt][e] = p * (dp[nt][e] - ((e & 1) ? q.w : q.y));  // dS^T
          }
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            T* at = dst + (r0 + g + 8 * r) * LDS + c0 + nt * 8 + 2 * t;
            if constexpr (S::F32) {
              store2(at, dp[nt][2 * r], dp[nt][2 * r + 1]);
            } else {
              __nv_bfloat162 high, low;
              split_bf16(dp[nt][2 * r], dp[nt][2 * r + 1], high, low);
              *reinterpret_cast<__nv_bfloat162*>(at) = high;
              *reinterpret_cast<__nv_bfloat162*>(at + ROWS * LDS) = low;
            }
          }
        }
        weigh16(dvt, sc[0], sc[1], gt, c0, lane);
        weigh16(dkt, dp[0], dp[1], qt, c0, lane);
      }
#pragma unroll
      for (int nd = 0; nd < 2; ++nd)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dk[nd][e] += dkt[nd][e];
          dv[nd][e] += dvt[nd][e];
        }
    }
    __syncthreads();  // dS^T of the tile is in shared memory
    {  // dq of the tile: warp -> queries (warp % 4) * 16 .., columns (warp / 4) * 8 ..; keys in runs of 64,
       // each in fresh registers
      const int m0 = (warp & 3) * 16, n0 = (warp >> 2) * 8;
      float dq[4] = {};
      for (int k0 = 0; k0 < kmax; k0 += 64) {
        float part[4] = {};
        dq_slab<LDS>(part, dst, kslab, m0, n0, k0, min(k0 + 64, kmax), lane);
#pragma unroll
        for (int e = 0; e < 4; ++e) dq[e] += part[e];
      }
      const float f = scale * item_f;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int q = i * KT + m0 + g + 8 * r;
        if (q < patch) store2(dqkv + (first + q) * pstride + (long)h * D + n0 + 2 * t, dq[2 * r] * f, dq[2 * r + 1] * f);
      }
    }
    if (!busy || i < tiles - 1) return;
    const float fk = item_f * scale;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + g + 8 * r;
      if (row >= patch) continue;
      T* out = dqkv + (first + row) * pstride + (long)(heads + h) * D;
#pragma unroll
      for (int nd = 0; nd < 2; ++nd) {
        const int c = nd * 8 + 2 * t;
        store2(out + c, dk[nd][2 * r] * fk, dk[nd][2 * r + 1] * fk);
        store2(out + (long)heads * D + c, dv[nd][2 * r] * item_f, dv[nd][2 * r + 1] * item_f);
      }
    }
  };
  pipeline<NST, Side>(steps, load, get, put, math);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return bytes > 48 * 1024 ? cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes)
                           : cudaSuccess;
}

// Patches per block: about MIN_BLOCKS blocks per SM in all, each walking several patches so that
// one patch's loads overlap another's math; one where a patch has fewer than STAGES - 1 tiles.
int items_per_block(int patches, int heads, int patch) {
  static const int sms = [] {
    int dev = 0, count = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      count = 132;
    return count;
  }();
  if ((patch + KT - 1) / KT < STAGES - 1) return 1;
  const long work = (long)patches * heads * ((patch + ROWS - 1) / ROWS);
  const long slots = (long)MIN_BLOCKS * sms;
  return (int)std::min<long>(MAX_ITEMS, std::max<long>(1, (work + slots - 1) / slots));
}

template <typename T>
int launch_fwd(const void* qkv, const unsigned char* valid, void* out, float* lse, float* out32, int patches,
               int heads, int patch, float scale, cudaStream_t s) {
  auto kernel = attention_fwd_kernel<T>;
  static const cudaError_t attr = allow_smem(kernel, FwdSmem<T>::bytes);
  if (attr != cudaSuccess) return (int)attr;
  const int items = items_per_block(patches, heads, patch);
  const dim3 grid((patches + items - 1) / items, heads, (patch + ROWS - 1) / ROWS);
  kernel<<<grid, THREADS, FwdSmem<T>::bytes, s>>>(static_cast<const T*>(qkv), valid, static_cast<T*>(out), lse,
                                                  out32, heads, patch, patches, items, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* qkv, const unsigned char* valid, const float* out32, const float* lse, const void* grad,
               void* dqkv, float* delta, int patches, int heads, int patch, float scale, cudaStream_t s) {
  const int items = items_per_block(patches, heads, patch);
  const dim3 grid((patches + items - 1) / items, heads, (patch + ROWS - 1) / ROWS);
  const T* q = static_cast<const T*>(qkv);
  const T* g = static_cast<const T*>(grad);
  T* dst = static_cast<T*>(dqkv);
  if (patch <= ROWS) {  // a block holds the patch's keys: one pass
    auto fused_kernel = attention_bwd_fused_kernel<T>;
    static const cudaError_t attr_fused = allow_smem(fused_kernel, FusedSmem<T>::bytes);
    if (attr_fused != cudaSuccess) return (int)attr_fused;
    fused_kernel<<<grid, THREADS, FusedSmem<T>::bytes, s>>>(q, valid, out32, lse, g, dst, heads, patch, patches,
                                                             items, scale);
    return (int)cudaGetLastError();
  }
  auto dq_kernel = attention_bwd_dq_kernel<T>;
  auto dkdv_kernel = attention_bwd_dkdv_kernel<T>;
  static const cudaError_t attr_dq = allow_smem(dq_kernel, DqSmem<T>::bytes);
  static const cudaError_t attr_dkdv = allow_smem(dkdv_kernel, DkvSmem<T>::bytes);
  if (attr_dq != cudaSuccess) return (int)attr_dq;
  if (attr_dkdv != cudaSuccess) return (int)attr_dkdv;
  dq_kernel<<<grid, THREADS, DqSmem<T>::bytes, s>>>(q, valid, out32, lse, g, dst, delta, heads, patch, patches,
                                                    items, scale);
  dkdv_kernel<<<grid, THREADS, DkvSmem<T>::bytes, s>>>(q, valid, lse, delta, g, dst, heads, patch, patches, items,
                                                       scale);
  return (int)cudaGetLastError();
}

bool bad_args(int n, int heads, int head_dim, int patch, int dtype) {
  return head_dim != D || patch <= 0 || n < 0 || n % patch != 0 || heads <= 0 || heads > 65535 ||
         (patch + ROWS - 1) / ROWS > 65535 || (dtype != 0 && dtype != 1);
}

}  // namespace

// qkv [n, 3, heads, head_dim] and out [n, heads*head_dim] of one dtype
// (0 = f32, 1 = bf16), rows 16-byte aligned; valid bool[n]; lse f32
// [n, heads] or null; out32 f32 [n, heads*head_dim] (the output once more,
// unrounded) or null.  Returns cudaGetLastError().
extern "C" int patch_attention_fwd(const void* qkv, const void* valid, void* out, void* lse, void* out32,
                                   int n, int heads, int head_dim, int patch, float scale, int dtype,
                                   void* stream) {
  if (bad_args(n, heads, head_dim, patch, dtype)) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned char* v = static_cast<const unsigned char*>(valid);
  float* l = static_cast<float*>(lse);
  float* o32 = static_cast<float*>(out32);
  if (dtype == 0) return launch_fwd<float>(qkv, v, out, l, o32, n / patch, heads, patch, scale, s);
  return launch_fwd<__nv_bfloat16>(qkv, v, out, l, o32, n / patch, heads, patch, scale, s);
}

// qkv and dqkv [n, 3, heads, head_dim] and grad (dO) [n, heads*head_dim],
// all of one dtype (0 = f32, 1 = bf16), rows 16-byte aligned; valid bool[n];
// out f32 [n, heads*head_dim] and lse f32 [n, heads] from patch_attention_fwd
// (its out in f32, its out32 in bf16); delta f32 [n, heads], scratch that
// the first kernel writes and the second reads.  Every element of dqkv is
// written.  Returns cudaGetLastError().
extern "C" int patch_attention_bwd(const void* qkv, const void* valid, const void* out, const void* lse,
                                   const void* grad, void* dqkv, void* delta, int n, int heads, int head_dim,
                                   int patch, float scale, int dtype, void* stream) {
  if (bad_args(n, heads, head_dim, patch, dtype) || delta == nullptr) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned char* v = static_cast<const unsigned char*>(valid);
  const float* l = static_cast<const float*>(lse);
  const float* o = static_cast<const float*>(out);
  float* dl = static_cast<float*>(delta);
  if (dtype == 0) return launch_bwd<float>(qkv, v, o, l, grad, dqkv, dl, n / patch, heads, patch, scale, s);
  return launch_bwd<__nv_bfloat16>(qkv, v, o, l, grad, dqkv, dl, n / patch, heads, patch, scale, s);
}

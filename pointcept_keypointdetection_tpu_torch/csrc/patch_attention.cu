// Serialized patch attention, forward and backward: hand-written kernels for Hopper (sm_90a).
//
// The forward replaces the Pallas TPU kernel
// pointcept_keypointdetection_tpu/ops/pallas/patch_attention.py::_attn_kernel
// (reached through _pallas_forward / patch_attention_pallas).  Per (patch,
// head): out = softmax(q k^T * scale, invalid keys set to -1e9) v, all math
// in f32, for input and output in f32 or bf16.  For training it also writes
// each row's log-sum-exp (lse [N, H] f32), which the backward reads so that
// it needs no second max/sum pass, and in bf16 the output once more in f32
// (out32), for the backward's delta; serving passes null pointers.
//
// Layout: q, k and v are read straight from qkv [N, 3, H, D] by strides and
// the result is written to [N, H*D]; no transposed copy exists.
//
// Grid: one block per (patch, head, tile of QT queries).  Four threads share
// a query, each taking every fourth key, with its own online-softmax state
// (running max m, sum l, accumulator acc); the four states merge through warp
// shuffles at the end.  Keys and values stream through shared memory in
// tiles of KT rows, so a patch of 1024 needs no 1024 x 1024 score block.
//
// Masking: an invalid key scores the finite -1e9, as on the TPU, so a patch
// whose keys are all invalid gives the mean of v and never NaN.
//
// Bound: at D = 16 the kernel does 4*K*D flops per query and head and moves
// each q, k, v and output element once; the work is small and the kernel is
// latency-bound.  wgmma/TMA and tuning are later work.
//
// The backward replaces _attn_bwd_kernel (reached through _pallas_backward,
// the custom_vjp _bwd).  With P = exp(S - lse), S = q k^T * scale (-1e9 on
// invalid keys) and delta_i = rowsum(dO_i * O_i) (= rowsum(dP * P)):
//     dv = P^T dO,  dS = P * (dO v^T - delta),  dq = dS k * scale,  dk = dS^T q * scale.
// The Pallas kernel holds a patch's [K, K] probabilities in VMEM and
// contracts them on the MXU; here a block's 227 KB cannot hold the f32
// scores of a patch of 1024 (4 MB), and the reduction over queries (dk, dv)
// and over keys (dq) runs along different axes.  So two kernels, each the
// shape of the forward: dk/dv gives four threads to a key and streams the
// queries (q, dO, lse, delta) through shared memory; dq gives four threads
// to a query and streams the keys.  Each output element is summed by one
// thread group in a fixed order: deterministic, no atomics.  The scores and
// dP are computed in both kernels, ~14*K*D flops per (query, head) against
// the 10*K*D of one fused pass; the bound is the same as the forward's.
//
// delta reads O in f32: the forward's out in f32, its out32 in bf16.  From
// the bf16-rounded O, delta's error, summed over a key's column of P in dk,
// reached two bf16 ulps of dqkv, where the plain version's f32
// rowsum(dP * P) rounds once.
//
// Pitfall: a row whose keys are all invalid has every score at -1e9 and a
// uniform softmax, but f32 cannot hold -1e9 + log(K) apart from -1e9, so its
// lse reads -1e9 and exp(S - lse) would give 1 instead of 1/K.  Such a row
// is recognised by its lse (below ALL_MASKED) and given P = 1/K, as the
// Pallas kernel's softmax gives.  As in the Pallas kernel, dS is not gated
// by the mask.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int D = 16;        // head dim
constexpr int TPQ = 4;       // threads per query
constexpr int QT = 64;       // queries per block
constexpr int KT = 128;      // keys per shared-memory tile
constexpr int DP = D + 4;    // padded shared row: the four key rows a warp reads fall in distinct banks
constexpr int THREADS = QT * TPQ;
constexpr int PER = KT / TPQ;  // keys of one tile per thread
constexpr float MASKED = -1e9f;       // the score of an invalid key
constexpr float ALL_MASKED = -5e8f;   // an lse below this: every key of the row is invalid

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T>
__global__ void __launch_bounds__(THREADS) patch_attention_kernel(
    const T* __restrict__ qkv, const unsigned char* __restrict__ valid, T* __restrict__ out,
    float* __restrict__ lse, float* __restrict__ out32, int heads, int patch, float scale) {
  __shared__ __align__(16) float ks[KT][DP];
  __shared__ __align__(16) float vs[KT][DP];
  __shared__ unsigned char kvalid[KT];

  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int sub = tid % TPQ;
  const int qi = blockIdx.z * QT + tid / TPQ;  // query within the patch
  const bool active = qi < patch;
  const long point_stride = 3L * heads * D;    // elements from one point's qkv to the next
  const long first = (long)blockIdx.x * patch;  // first point of the patch

  float q[D], acc[D];
  const T* qp = qkv + (first + (active ? qi : 0)) * point_stride + (long)h * D;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    q[d] = active ? to_f(qp[d]) * scale : 0.f;
    acc[d] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  for (int k0 = 0; k0 < patch; k0 += KT) {
    const int kt = min(KT, patch - k0);
    __syncthreads();  // the previous tile is consumed
    for (int e = tid; e < kt * D; e += THREADS) {
      const int j = e / D, d = e % D;
      const T* kp = qkv + (first + k0 + j) * point_stride + (long)(heads + h) * D + d;
      ks[j][d] = to_f(kp[0]);
      vs[j][d] = to_f(kp[(long)heads * D]);
    }
    for (int j = tid; j < kt; j += THREADS) kvalid[j] = valid[first + k0 + j];
    __syncthreads();

    float s[PER];
    float tmax = -INFINITY;
#pragma unroll
    for (int t = 0; t < PER; ++t) {
      const int j = sub + t * TPQ;
      float x = -INFINITY;  // past the tile's end: no key
      if (j < kt) {
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) dot = fmaf(q[d], ks[j][d], dot);
        x = kvalid[j] ? dot : MASKED;
      }
      s[t] = x;
      tmax = fmaxf(tmax, x);
    }
    if (tmax > -INFINITY) {
      const float m_new = fmaxf(m, tmax);
      const float corr = expf(m - m_new);  // 0 while m is still -inf
      l *= corr;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] *= corr;
#pragma unroll
      for (int t = 0; t < PER; ++t) {
        const int j = sub + t * TPQ;
        if (j < kt) {
          const float pr = expf(s[t] - m_new);
          l += pr;
#pragma unroll
          for (int d = 0; d < D; ++d) acc[d] = fmaf(pr, vs[j][d], acc[d]);
        }
      }
      m = m_new;
    }
  }

  // merge the TPQ partial states of a query (adjacent lanes of one warp)
#pragma unroll
  for (int off = 1; off < TPQ; off <<= 1) {
    const float m_o = __shfl_xor_sync(0xffffffffu, m, off);
    const float l_o = __shfl_xor_sync(0xffffffffu, l, off);
    const float m_new = fmaxf(m, m_o);
    const float c_s = m == -INFINITY ? 0.f : expf(m - m_new);
    const float c_o = m_o == -INFINITY ? 0.f : expf(m_o - m_new);
    l = l * c_s + l_o * c_o;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const float a_o = __shfl_xor_sync(0xffffffffu, acc[d], off);
      acc[d] = acc[d] * c_s + a_o * c_o;
    }
    m = m_new;
  }

  if (active) {
    const float inv = 1.f / l;
    const long at = (first + qi) * (long)heads * D + (long)h * D;
#pragma unroll
    for (int d = 0; d < D; ++d)
      if (d % TPQ == sub) {
        store(out + at + d, acc[d] * inv);
        if (out32 != nullptr) out32[at + d] = acc[d] * inv;
      }
    if (lse != nullptr && sub == 0) lse[(first + qi) * heads + h] = m + logf(l);
  }
}

// P of one (query, key) score from the query's lse (see the pitfall above).
__device__ __forceinline__ float prob(float s, float lse, float inv_patch) {
  return lse < ALL_MASKED ? inv_patch : expf(s - lse);
}

// dk and dv: one block per (patch, head, tile of QT keys), TPQ threads per
// key, each taking every TPQ-th query of a tile of KT queries in shared memory.
template <typename T>
__global__ void __launch_bounds__(THREADS) attention_bwd_dkdv_kernel(
    const T* __restrict__ qkv, const unsigned char* __restrict__ valid, const float* __restrict__ out,
    const float* __restrict__ lse, const T* __restrict__ grad, T* __restrict__ dqkv, int heads,
    int patch, float scale) {
  __shared__ __align__(16) float qs[KT][DP];  // q * scale
  __shared__ __align__(16) float gs[KT][DP];  // dO
  __shared__ float ls[KT];                    // lse
  __shared__ float deltas[KT];                // rowsum(dO * O)

  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int sub = tid % TPQ;
  const int kj = blockIdx.z * QT + tid / TPQ;  // key within the patch
  const bool active = kj < patch;
  const long point_stride = 3L * heads * D;
  const long row_stride = (long)heads * D;  // of out, grad
  const long first = (long)blockIdx.x * patch;
  const float inv_patch = 1.f / patch;

  float k[D], v[D], dk[D], dv[D];
  const T* kp = qkv + (first + (active ? kj : 0)) * point_stride + (long)(heads + h) * D;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    k[d] = active ? to_f(kp[d]) : 0.f;
    v[d] = active ? to_f(kp[(long)heads * D + d]) : 0.f;
    dk[d] = 0.f;
    dv[d] = 0.f;
  }
  const bool key_valid = active && valid[first + kj];

  for (int q0 = 0; q0 < patch; q0 += KT) {
    const int qt = min(KT, patch - q0);
    __syncthreads();  // the previous tile is consumed
    for (int e = tid; e < qt * D; e += THREADS) {
      const int i = e / D, d = e % D;
      const long row = first + q0 + i;
      qs[i][d] = to_f(qkv[row * point_stride + (long)h * D + d]) * scale;
      gs[i][d] = to_f(grad[row * row_stride + (long)h * D + d]);
    }
    for (int i = tid; i < qt; i += THREADS) {
      const long row = first + q0 + i;
      const T* gp = grad + row * row_stride + (long)h * D;
      const float* op = out + row * row_stride + (long)h * D;
      float delta = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) delta = fmaf(to_f(gp[d]), op[d], delta);
      deltas[i] = delta;
      ls[i] = lse[row * heads + h];
    }
    __syncthreads();

#pragma unroll 4
    for (int t = 0; t < PER; ++t) {
      const int i = sub + t * TPQ;
      if (i < qt) {
        float dot = 0.f, dp = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) {
          dot = fmaf(qs[i][d], k[d], dot);
          dp = fmaf(gs[i][d], v[d], dp);
        }
        const float p = prob(key_valid ? dot : MASKED, ls[i], inv_patch);
        const float ds = p * (dp - deltas[i]);
#pragma unroll
        for (int d = 0; d < D; ++d) {
          dv[d] = fmaf(p, gs[i][d], dv[d]);
          dk[d] = fmaf(ds, qs[i][d], dk[d]);  // qs holds q * scale
        }
      }
    }
  }

#pragma unroll
  for (int off = 1; off < TPQ; off <<= 1) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      dk[d] += __shfl_xor_sync(0xffffffffu, dk[d], off);
      dv[d] += __shfl_xor_sync(0xffffffffu, dv[d], off);
    }
  }
  if (active) {
    T* op = dqkv + (first + kj) * point_stride + (long)(heads + h) * D;
#pragma unroll
    for (int d = 0; d < D; ++d)
      if (d % TPQ == sub) {
        store(op + d, dk[d]);
        store(op + (long)heads * D + d, dv[d]);
      }
  }
}

// dq: one block per (patch, head, tile of QT queries), TPQ threads per query,
// each taking every TPQ-th key of a tile of KT keys in shared memory.
template <typename T>
__global__ void __launch_bounds__(THREADS) attention_bwd_dq_kernel(
    const T* __restrict__ qkv, const unsigned char* __restrict__ valid, const float* __restrict__ out,
    const float* __restrict__ lse, const T* __restrict__ grad, T* __restrict__ dqkv, int heads,
    int patch, float scale) {
  __shared__ __align__(16) float ks[KT][DP];
  __shared__ __align__(16) float vs[KT][DP];
  __shared__ unsigned char kvalid[KT];

  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int sub = tid % TPQ;
  const int qi = blockIdx.z * QT + tid / TPQ;
  const bool active = qi < patch;
  const long point_stride = 3L * heads * D;
  const long row_stride = (long)heads * D;
  const long first = (long)blockIdx.x * patch;
  const long row = first + (active ? qi : 0);
  const float inv_patch = 1.f / patch;

  float q[D], g[D], dq[D];
  float delta = 0.f;
  const T* qp = qkv + row * point_stride + (long)h * D;
  const T* gp = grad + row * row_stride + (long)h * D;
  const float* op = out + row * row_stride + (long)h * D;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    q[d] = active ? to_f(qp[d]) * scale : 0.f;
    g[d] = active ? to_f(gp[d]) : 0.f;
    delta = fmaf(g[d], active ? op[d] : 0.f, delta);
    dq[d] = 0.f;
  }
  const float l = active ? lse[row * heads + h] : 0.f;

  for (int k0 = 0; k0 < patch; k0 += KT) {
    const int kt = min(KT, patch - k0);
    __syncthreads();
    for (int e = tid; e < kt * D; e += THREADS) {
      const int j = e / D, d = e % D;
      const T* kp = qkv + (first + k0 + j) * point_stride + (long)(heads + h) * D + d;
      ks[j][d] = to_f(kp[0]);
      vs[j][d] = to_f(kp[(long)heads * D]);
    }
    for (int j = tid; j < kt; j += THREADS) kvalid[j] = valid[first + k0 + j];
    __syncthreads();

#pragma unroll 4
    for (int t = 0; t < PER; ++t) {
      const int j = sub + t * TPQ;
      if (j < kt) {
        float dot = 0.f, dp = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) {
          dot = fmaf(q[d], ks[j][d], dot);
          dp = fmaf(g[d], vs[j][d], dp);
        }
        const float p = prob(kvalid[j] ? dot : MASKED, l, inv_patch);
        const float ds = p * (dp - delta);
#pragma unroll
        for (int d = 0; d < D; ++d) dq[d] = fmaf(ds, ks[j][d], dq[d]);
      }
    }
  }

#pragma unroll
  for (int off = 1; off < TPQ; off <<= 1) {
#pragma unroll
    for (int d = 0; d < D; ++d) dq[d] += __shfl_xor_sync(0xffffffffu, dq[d], off);
  }
  if (active) {
    T* dst = dqkv + row * point_stride + (long)h * D;
#pragma unroll
    for (int d = 0; d < D; ++d)
      if (d % TPQ == sub) store(dst + d, dq[d] * scale);
  }
}

}  // namespace

// qkv [n, 3, heads, head_dim] and out [n, heads*head_dim] of one dtype
// (0 = f32, 1 = bf16); valid bool[n]; lse f32 [n, heads] or null; out32 f32
// [n, heads*head_dim] (the output once more, unrounded) or null.
// Returns cudaGetLastError().
extern "C" int patch_attention_fwd(const void* qkv, const void* valid, void* out, void* lse, void* out32,
                                   int n, int heads, int head_dim, int patch, float scale, int dtype,
                                   void* stream) {
  if (head_dim != D || patch <= 0 || n % patch != 0 || heads <= 0 || heads > 65535 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  const dim3 grid(n / patch, heads, (patch + QT - 1) / QT);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned char* v = static_cast<const unsigned char*>(valid);
  float* l = static_cast<float*>(lse);
  float* o32 = static_cast<float*>(out32);
  if (dtype == 0)
    patch_attention_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(qkv), v, static_cast<float*>(out), l, o32, heads, patch, scale);
  else
    patch_attention_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(qkv), v, static_cast<__nv_bfloat16*>(out), l, o32, heads, patch,
        scale);
  return (int)cudaGetLastError();
}

namespace {

template <typename T>
void launch_bwd(const void* qkv, const unsigned char* valid, const float* o, const float* lse,
                const void* grad, void* dqkv, dim3 grid, int heads, int patch, float scale,
                cudaStream_t s) {
  const T* q = static_cast<const T*>(qkv);
  const T* g = static_cast<const T*>(grad);
  T* dst = static_cast<T*>(dqkv);
  attention_bwd_dkdv_kernel<T><<<grid, THREADS, 0, s>>>(q, valid, o, lse, g, dst, heads, patch, scale);
  attention_bwd_dq_kernel<T><<<grid, THREADS, 0, s>>>(q, valid, o, lse, g, dst, heads, patch, scale);
}

}  // namespace

// qkv and dqkv [n, 3, heads, head_dim] and grad (dO) [n, heads*head_dim],
// all of one dtype (0 = f32, 1 = bf16); valid bool[n]; out f32
// [n, heads*head_dim] and lse f32 [n, heads] from patch_attention_fwd (its
// out in f32, its out32 in bf16).  Every element of dqkv is written.
// Returns cudaGetLastError().
extern "C" int patch_attention_bwd(const void* qkv, const void* valid, const void* out, const void* lse,
                                   const void* grad, void* dqkv, int n, int heads, int head_dim,
                                   int patch, float scale, int dtype, void* stream) {
  if (head_dim != D || patch <= 0 || n % patch != 0 || heads <= 0 || heads > 65535 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  const dim3 grid(n / patch, heads, (patch + QT - 1) / QT);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned char* v = static_cast<const unsigned char*>(valid);
  const float* l = static_cast<const float*>(lse);
  const float* o = static_cast<const float*>(out);
  if (dtype == 0)
    launch_bwd<float>(qkv, v, o, l, grad, dqkv, grid, heads, patch, scale, s);
  else
    launch_bwd<__nv_bfloat16>(qkv, v, o, l, grad, dqkv, grid, heads, patch, scale, s);
  return (int)cudaGetLastError();
}

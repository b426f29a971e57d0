// Serialized patch attention, forward: a hand-written kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// pointcept_keypointdetection_tpu/ops/pallas/patch_attention.py::_attn_kernel
// (reached through _pallas_forward / patch_attention_pallas).  Per (patch,
// head): out = softmax(q k^T * scale, invalid keys set to -1e9) v, all math
// in f32, for input and output in f32 or bf16.
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

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T>
__global__ void __launch_bounds__(THREADS) patch_attention_kernel(
    const T* __restrict__ qkv, const unsigned char* __restrict__ valid, T* __restrict__ out,
    int heads, int patch, float scale) {
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
        x = kvalid[j] ? dot : -1e9f;
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
    T* op = out + (first + qi) * (long)heads * D + (long)h * D;
#pragma unroll
    for (int d = 0; d < D; ++d)
      if (d % TPQ == sub) store(op + d, acc[d] * inv);
  }
}

}  // namespace

// qkv [n, 3, heads, head_dim] and out [n, heads*head_dim] of one dtype
// (0 = f32, 1 = bf16); valid bool[n].  Returns cudaGetLastError().
extern "C" int patch_attention_fwd(const void* qkv, const void* valid, void* out, int n, int heads,
                                   int head_dim, int patch, float scale, int dtype, void* stream) {
  if (head_dim != D || patch <= 0 || n % patch != 0 || heads <= 0 || heads > 65535 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  const dim3 grid(n / patch, heads, (patch + QT - 1) / QT);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned char* v = static_cast<const unsigned char*>(valid);
  if (dtype == 0)
    patch_attention_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(qkv), v, static_cast<float*>(out), heads, patch, scale);
  else
    patch_attention_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(qkv), v, static_cast<__nv_bfloat16*>(out), heads, patch,
        scale);
  return (int)cudaGetLastError();
}

// K2: cosine (or scaled) window attention, one thread block per
// (window, head), for windows of up to 64 tokens and heads up to 64 wide.
//
// Replaces the Pallas kernels
//   deepfake_tpu/ops/pallas_window_attn.py:1127 pallas_window_attention,
//     routes _run :51 (call :62) and _run_packed :126 (call :132)   [head-major]
//   deepfake_tpu/ops/pallas_window_attn.py:847 pallas_window_attention_nhc_packed,
//     route _run_nhc_packed :816 (call :825)                        [token-major]
// One kernel serves both layouts: the caller passes element strides for the
// window, head and token axes (the head dim is contiguous), so head-major
// [B_, H, N, D] and token-major [B_, N, C] (heads in channel slices, q/k/v
// read straight out of one [B_, N, 3C] qkv tensor) are the same code.
//
// Per block: load q, k, v [N, D] into shared memory as f32; L2-normalise the
// rows of q and k (x * rsqrt(max(|x|^2, 1e-24)), pallas_window_attn.py:34-35)
// and scale the logits by the head's logit_scale, or (cosine = 0) scale q by
// a scalar; add bias[h] and mask[w % n_masks]; max-stabilised f32 softmax
// with the [N, N] logits held in shared memory (9.8 KB at N = 49); PV; store
// in the input type.
//
// What bounds it on the H100: memory. Each block reads 3 * N * D inputs and
// writes N * D outputs, and does ~4 * N^2 * D flops (~0.3 MFLOP at N = 49,
// D = 32) against 25 KB of q/k/v/out in f32: ~12 flop/byte, far under the
// card's ridge. The design keeps the logits out of device memory and reads
// q/k/v once. The TPU kernels' block-diagonal window packing was for the
// 128-wide MXU and is not copied: SIMT dot products need no padding to a
// tile, so a block simply takes one (window, head).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;

struct Args {
  const void* q; const void* k; const void* v;
  int64_t s_w, s_h, s_n;          // q/k/v element strides (head dim contiguous)
  void* out; int64_t o_w, o_h, o_n;
  const float* bias;              // [heads, n, n]
  const float* mask; int n_masks; // [n_masks, n, n] or null
  const float* scales;            // [heads]: logit_scale (cosine) or scalar scale
  int cosine, n, d;
};

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <typename T>
__global__ void __launch_bounds__(THREADS) window_attn(Args g) {
  extern __shared__ float sm[];
  const int N = g.n, D = g.d, DP = D + 1, NP = N + 1;  // +1 pads off bank conflicts
  float* qs = sm;
  float* ks = qs + N * DP;
  float* vs = ks + N * DP;
  float* ps = vs + N * DP;  // [N, NP] logits, then probabilities

  const int w = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t base = (int64_t)w * g.s_w + (int64_t)h * g.s_h;
  const T* Q = static_cast<const T*>(g.q) + base;
  const T* K = static_cast<const T*>(g.k) + base;
  const T* V = static_cast<const T*>(g.v) + base;
  const float scale = g.scales[h];

  for (int idx = tid; idx < N * D; idx += THREADS) {
    const int i = idx / D, c = idx % D;
    const int64_t off = (int64_t)i * g.s_n + c;
    qs[i * DP + c] = to_f(Q[off]);
    ks[i * DP + c] = to_f(K[off]);
    vs[i * DP + c] = to_f(V[off]);
  }
  __syncthreads();

  if (g.cosine) {
    for (int row = warp; row < 2 * N; row += THREADS / 32) {
      float* p = row < N ? qs + row * DP : ks + (row - N) * DP;
      float ss = 0.f;
      for (int c = lane; c < D; c += 32) ss += p[c] * p[c];
      const float inv = rsqrtf(fmaxf(warp_sum(ss), 1e-24f));
      for (int c = lane; c < D; c += 32) p[c] *= inv;
    }
  } else {
    for (int idx = tid; idx < N * D; idx += THREADS) qs[(idx / D) * DP + idx % D] *= scale;
  }
  __syncthreads();

  const float* bias = g.bias + (int64_t)h * N * N;
  const float* mask = g.mask ? g.mask + (int64_t)(w % g.n_masks) * N * N : nullptr;
  for (int idx = tid; idx < N * N; idx += THREADS) {
    const int i = idx / N, j = idx % N;
    const float* qi = qs + i * DP;
    const float* kj = ks + j * DP;
    float s = 0.f;
    for (int c = 0; c < D; ++c) s = fmaf(qi[c], kj[c], s);
    if (g.cosine) s *= scale;
    s += bias[idx];
    if (mask) s += mask[idx];
    ps[i * NP + j] = s;
  }
  __syncthreads();

  for (int i = warp; i < N; i += THREADS / 32) {
    float* p = ps + i * NP;
    float m = -3.402823466e38f;
    for (int j = lane; j < N; j += 32) m = fmaxf(m, p[j]);
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < N; j += 32) {
      const float e = expf(p[j] - m);
      p[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < N; j += 32) p[j] = p[j] / sum;
  }
  __syncthreads();

  T* O = static_cast<T*>(g.out) + (int64_t)w * g.o_w + (int64_t)h * g.o_h;
  for (int idx = tid; idx < N * D; idx += THREADS) {
    const int i = idx / D, c = idx % D;
    const float* pi = ps + i * NP;
    float o = 0.f;
    for (int j = 0; j < N; ++j) o = fmaf(pi[j], vs[j * DP + c], o);
    O[(int64_t)i * g.o_n + c] = from_f<T>(o);
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. grid = (windows, heads). Returns cudaGetLastError().
extern "C" int k2_window_attn(
    int dtype, const void* q, const void* k, const void* v,
    int64_t s_w, int64_t s_h, int64_t s_n,
    void* out, int64_t o_w, int64_t o_h, int64_t o_n,
    const float* bias, const float* mask, int n_masks, const float* scales,
    int cosine, int windows, int heads, int n, int d, void* stream) {
  if (n < 1 || n > 64 || d < 1 || d > 64) return static_cast<int>(cudaErrorInvalidValue);
  Args g{q, k, v, s_w, s_h, s_n, out, o_w, o_h, o_n, bias, mask, n_masks, scales, cosine, n, d};
  const size_t smem = sizeof(float) * (3 * n * (d + 1) + n * (n + 1));
  dim3 grid(windows, heads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(window_attn<float>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    window_attn<float><<<grid, THREADS, smem, s>>>(g);
  } else if (dtype == 1) {
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(window_attn<__nv_bfloat16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
    window_attn<__nv_bfloat16><<<grid, THREADS, smem, s>>>(g);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* k2_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

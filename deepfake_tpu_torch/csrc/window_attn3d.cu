// K3: window attention for Video Swin's large 3D windows (N <= 512 tokens,
// 392 for (8,7,7) windows), head dim 32, token-major. For each (window w,
// head h):
//
//   out = softmax_rows(q.s . k^T + bias[h] + mask[w % n_masks]) . v
//
// Replaces the Pallas kernel
//   deepfake_tpu/ops/pallas_window_attn.py:709 pallas_window_attention_nhc,
//     _nhc_kernel :243 (call :349)
// and, with K4 (ln_linear.cu) for the qkv and proj products around it, the
// attention of pallas_window_attention_nhc_qkv (:548, _nhc_qkv_kernel :364).
// q, k and v are [B_, N, C] with heads in channel slices, read straight out of
// one [B_, N, 3C] qkv tensor by strides (window, head, token; the head dim is
// contiguous), so there is no split copy.
//
// The cast points are the Pallas kernel's inference defaults (mxu_bf16 =
// True, no_max = True): q * bf16(scale) rounded to bf16; bf16 x bf16 dots
// with f32 accumulation; + bias (f32) + mask (bf16 {0, -100}); the
// static-shift softmax e = exp(min(x - 24, 60)) with the 1/rowsum deferred to
// the PV output; the weights cast to bf16 for PV. f32 inputs: all f32.
//
// What bounds it on the H100: by its own inputs and outputs, memory (q, k, v
// and out once in bf16, the f32 bias and the mask once: ~0.79 ms a
// video_swin b8 request, against ~0.47 ms of bf16 tensor-core work and
// ~0.94 ms of exponentials, B_ H N^2 of them at the H100's ~3.9 T/s of ex2:
// FlashAttention-3, Shah et al. 2024, section 3). What the card showed
// (PERF.md, K3 findings): the first design (one block per (window, head),
// mma.sync, bias and mask read from L2 in the inner loop) was set by that
// inner loop's loads and instructions, not by the exponentials; the mask's
// loads alone cost 40% of a shifted launch. This design takes them out of
// the inner loop. What sets it now: filling the bias tiles (~20% of a b8
// request, ~half of a b1 one; in a shifted launch the mask's loads set the
// fill), and per window the products and shared-memory reads; the
// exponentials cost nothing measurable (a build without them ran as fast).
//
// Routes:
//   - bf16 (serving), Hopper: window_attn_tile.cuh's kernel in its
//     STATIC_SHIFT form (shared with K5's forward). One block per (head, a
//     group of G windows that read one mask index, query tile of 64 rows)
//     adds its [64, N] slice of bias[h] and mask[i] once into an f32 tile
//     in shared memory, which every window of the group reads; a producer
//     warp streams q, K and V by TMA; three consumer warpgroups split the
//     keys (wgmma for S and P V, ex2 for the weights). The tile holds
//     (bias + mask) log2 e - 24 log2 e, so a weight is one FMA, one min and
//     one ex2.approx: exp(min(x - 24, 60)) as 2^min(s log2 e + b, 60 log2 e),
//     a few f32 ulps from torch.exp before the bf16 cast (weights below
//     1.2e-38 flush to zero, harmless as the mask's). At b8 a group is the 8
//     windows of a mask index; an unmasked launch groups G consecutive
//     windows, G chosen here (choose_group) to fill the SMs' waves (b1's
//     masked launches have one window a group, so nothing is shared there).
//     L2 reads per video_swin b8 request by the design's count (no counter
//     read them): ~1.7 GB of bias and mask tiles, ~8.4 GB of K and V (once
//     per query tile: 7 times at N = 392) and ~1.2 GB of q and out, ~11.2 GB
//     in all against ~20.7 GB for the first design; chip_smoke.py logs the
//     count per launch (k3_windows_per_block gives G).
//   - f32 (the parity route only; a different kernel from the one that
//     serves): one block of 8 warps per (query tile of 32 rows, window,
//     head), SIMT f32 FMA, K, V and the [32, N] logit tile in shared memory.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "window_attn_tile.cuh"

namespace {

constexpr int D = wtile::D;
constexpr int MAX_N = wtile::MAX_N;
using wtile::Args;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ------------------------------------------------------------- f32: SIMT

namespace simt {

constexpr int MQ = 32, THREADS = 256, DP = D + 1;  // +1 pads off bank conflicts

__host__ __device__ constexpr size_t smem_bytes(int n) {
  return sizeof(float) * (2 * n * DP + MQ * DP + MQ * (n + 1) + MQ);
}

__global__ void __launch_bounds__(THREADS) attn_f32(Args g) {
  extern __shared__ float sm[];
  const int N = g.n, NP = N + 1;
  float* ks = sm;              // [N][DP]
  float* vs = ks + N * DP;     // [N][DP]
  float* qs = vs + N * DP;     // [MQ][DP]
  float* ps = qs + MQ * DP;    // [MQ][NP] logits, then weights
  float* rs = ps + MQ * NP;    // [MQ] deferred 1/rowsum

  const int q0 = blockIdx.x * MQ, w = blockIdx.y, h = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rows = min(MQ, N - q0);
  const int64_t base = (int64_t)w * g.s_w + (int64_t)h * g.s_h;
  const float* Q = static_cast<const float*>(g.q) + base;
  const float* K = static_cast<const float*>(g.k) + base;
  const float* V = static_cast<const float*>(g.v) + base;

  for (int idx = tid; idx < N * D; idx += THREADS) {
    const int j = idx / D, c = idx % D;
    const int64_t off = (int64_t)j * g.s_n + c;
    ks[j * DP + c] = K[off];
    vs[j * DP + c] = V[off];
  }
  for (int idx = tid; idx < MQ * D; idx += THREADS) {
    const int i = idx / D, c = idx % D;
    qs[i * DP + c] = i < rows ? Q[(int64_t)(q0 + i) * g.s_n + c] * g.scale : 0.f;
  }
  __syncthreads();

  const float* bias = g.bias + (int64_t)h * N * N;
  const float* mask =
      g.mask ? static_cast<const float*>(g.mask) + (int64_t)(w % g.n_masks) * N * N : nullptr;
  for (int idx = tid; idx < rows * N; idx += THREADS) {
    const int i = idx / N, j = idx - i * N;
    const float* qi = qs + i * DP;
    const float* kj = ks + j * DP;
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < D; ++c) s = fmaf(qi[c], kj[c], s);
    const int64_t at = (int64_t)(q0 + i) * N + j;
    s += bias[at];
    if (mask) s += mask[at];
    ps[i * NP + j] = s;
  }
  __syncthreads();

  for (int i = warp; i < rows; i += THREADS / 32) {
    float* p = ps + i * NP;
    float sum = 0.f;
    for (int j = lane; j < N; j += 32) {
      const float e = expf(fminf(p[j] - 24.f, 60.f));
      p[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    if (lane == 0) rs[i] = 1.f / sum;
  }
  __syncthreads();

  float* O = static_cast<float*>(g.out) + (int64_t)w * g.o_w + (int64_t)h * g.o_h;
  for (int idx = tid; idx < rows * D; idx += THREADS) {
    const int i = idx / D, c = idx % D;
    const float* pi = ps + i * NP;
    float o = 0.f;
    for (int j = 0; j < N; ++j) o = fmaf(pi[j], vs[j * DP + c], o);
    O[(int64_t)(q0 + i) * g.o_n + c] = o * rs[i];
  }
}

}  // namespace simt

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, size_t smem, cudaStream_t s,
                   const Args& g) {
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, threads, smem, s>>>(g);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// G, the windows a bf16 block takes: it trades the bias tile each block
// loads against the last wave's idle SMs. The cost of a choice is waves x
// (G + 1), the tile counted as one window (on the card, weighting it less or
// more made the b8 request slower).
int choose_group(int windows, int heads, int n, int n_masks, bool masked) {
  const int n_groups = masked ? n_masks : 1, per_group = windows / n_groups;
  const int64_t units = (int64_t)heads * ((n + wtile::BM - 1) / wtile::BM) * n_groups;
  const int64_t sms = hopper::sm_count();
  int64_t best = -1;
  int group = 1;
  for (int gg = 1; gg <= per_group; ++gg) {
    const int64_t splits = (per_group + gg - 1) / gg;
    if (gg > 1 && splits == (per_group + gg - 2) / (gg - 1)) continue;  // same split count
    const int64_t cost = (units * splits + sms - 1) / sms * (gg + 1);
    if (best < 0 || cost < best) {
      best = cost;
      group = gg;
    }
  }
  return group;
}

}  // namespace

// dtype: 0 float32 (SIMT, f32 mask), 1 bfloat16 (Hopper: wgmma and TMA, bf16
// mask). grid = query tiles x heads x window groups on Hopper, (query
// tiles, windows, heads) in SIMT. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments the kernels do not take.
extern "C" int k3_window_attn(
    int dtype, const void* q, const void* k, const void* v,
    int64_t s_w, int64_t s_h, int64_t s_n,
    void* out, int64_t o_w, int64_t o_h, int64_t o_n,
    const float* bias, const void* mask, int n_masks, float scale,
    int windows, int heads, int n, int d, void* stream) {
  if (n < 1 || n > MAX_N || d != D || windows < 1 || windows > 65535 || heads < 1 ||
      heads > 65535 || (mask && (n_masks < 1 || windows % n_masks)))
    return static_cast<int>(cudaErrorInvalidValue);
  Args g{q, k, v, s_w, s_h, s_n, out, o_w, o_h, o_n, bias, mask, mask ? n_masks : 1,
         scale, n};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1) {
    if (!(aligned16(q) && aligned16(k) && aligned16(v) && aligned16(out) && aligned16(bias) &&
          aligned16(mask)) ||
        (s_w | s_h | s_n | o_w | o_h | o_n) % 8)
      return static_cast<int>(cudaErrorInvalidValue);
    err = wtile::launch<wtile::STATIC_SHIFT>(
        g, windows, heads, choose_group(windows, heads, n, g.n_masks, mask != nullptr), s);
  } else if (dtype == 0) {
    dim3 grid((n + simt::MQ - 1) / simt::MQ, windows, heads);
    err = launch(simt::attn_f32, grid, simt::THREADS, simt::smem_bytes(n), s, g);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

// G, the windows a bf16 block takes, for a launch of these arguments: a
// diagnostic (chip_smoke.py's modelled L2 reads, and the test that an
// unmasked launch's windows do not divide into whole groups); no launch
// path calls it
extern "C" int k3_windows_per_block(int windows, int heads, int n, int n_masks, int masked) {
  return choose_group(windows, heads, n, n_masks, masked != 0);
}

extern "C" const char* k3_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

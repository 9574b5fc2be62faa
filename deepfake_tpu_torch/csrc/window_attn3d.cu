// K3: window attention for Video Swin's large 3D windows (any N: 392
// tokens for (8,7,7) windows, 784 for (16,7,7)), head dims 8 to 128 in steps
// of 8, token-major.
// For each (window w, head h):
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
//     count per launch (k3_windows_per_block gives G). Above 512 tokens the
//     body streams each window's keys (window_attn_tile.cuh, attn_bf16_stream).
//     That kernel is built for head dim 32 (every Video Swin head: Swin-S,
//     -B and -L). Other head dims take window_attn_mma.cuh's tensor-core
//     kernel (mma.sync) in bf16, at the same cast points.
//   - f32 (the parity route only; a different kernel from the ones that
//     serve): window_attn_tile.cuh's SIMT kernel, one block of 8
//     warps per (query tile of 32 rows, window, head), K and V streamed in
//     tiles of 64 keys, any N, instances for heads of 32, 64 and 128
//     columns (a narrower head zero-filled to the next).

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "window_attn_mma.cuh"
#include "window_attn_tile.cuh"

namespace {

constexpr int D = wtile::D;
static_assert(D == wtile::mma::WGMMA_D, "the wgmma body's head dim");
using wtile::Args;

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

// dtype: 0 float32 (SIMT, f32 mask), 1 bfloat16 (bf16 mask; at d = 32
// Hopper: wgmma and TMA, else mma.sync, window_attn_mma.cuh). d: the head
// dim, 8 to 128 in steps of 8. grid = query tiles x heads x window groups on Hopper, (query tiles,
// windows, heads) in SIMT. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments the kernels do not take.
extern "C" int k3_window_attn(
    int dtype, const void* q, const void* k, const void* v,
    int64_t s_w, int64_t s_h, int64_t s_n,
    void* out, int64_t o_w, int64_t o_h, int64_t o_n,
    const float* bias, const void* mask, int n_masks, float scale,
    int windows, int heads, int n, int d, void* stream) {
  if (n < 1 || n > 65535 || d < 8 || d > 128 || d % 8 || windows < 1 || windows > 65535 ||
      heads < 1 || heads > 65535 || (mask && (n_masks < 1 || windows % n_masks)))
    return static_cast<int>(cudaErrorInvalidValue);
  Args g{q, k, v, s_w, s_h, s_n, out, o_w, o_h, o_n, bias, mask, mask ? n_masks : 1,
         scale, n};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1 && (!(aligned16(q) && aligned16(k) && aligned16(v) && aligned16(out) &&
                        aligned16(bias) && aligned16(mask)) ||
                      (s_w | s_h | s_n | o_w | o_h | o_n) % 8))
    return static_cast<int>(cudaErrorInvalidValue);
  if (wtile::mma::on_wgmma(dtype, d)) {
    err = wtile::launch<wtile::STATIC_SHIFT>(
        g, windows, heads, choose_group(windows, heads, n, g.n_masks, mask != nullptr), s);
  } else if (dtype == 1) {
    const wtile::mma::MArgs m{static_cast<const wtile::bf16*>(q),
                              static_cast<const wtile::bf16*>(k),
                              static_cast<const wtile::bf16*>(v), s_w, s_h, s_n,
                              static_cast<wtile::bf16*>(out), o_w, o_h, o_n, bias, mask,
                              g.n_masks, nullptr, scale, n, d};
    err = wtile::mma::launch<wtile::mma::M_STATIC_SHIFT, wtile::bf16>(m, windows, heads, s);
  } else if (dtype == 0) {
    err = wtile::simt::launch<wtile::STATIC_SHIFT, float>(g, windows, heads, d, s);
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

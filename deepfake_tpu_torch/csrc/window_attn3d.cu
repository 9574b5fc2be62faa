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
//   - bf16 (serving), Hopper. The windows that read one mask (window w reads
//     mask w % nW, and windows come batch-major, w = b nW + i) share one bias
//     and one mask per head, and every window of an unmasked launch shares
//     the bias. So a block takes (head h, a group of windows that share a
//     mask index i, query tile of 64 rows): it adds its [64, N] slice of
//     bias[h] and of mask[i] once into an f32 tile in shared memory (rows
//     of `pitch` floats, pitch = 8 mod 32, so the 8 rows a warp reads at
//     once fall on distinct banks), and every window of the group reads it. Adding the mask to the bias before the logit changes the
//     association only where the mask is -100; there the weight is below
//     exp(-94) < 1e-40 and adds nothing above f32 rounding. The tile holds
//     (bias + mask) log2 e - 24 log2 e, so a weight is one FMA, one min and
//     one ex2.approx: exp(min(x - 24, 60)) as 2^min(s log2 e + b, 60 log2 e),
//     a few f32 ulps from torch.exp before the bf16 cast (weights below
//     1.2e-38 flush to zero, harmless as the mask's). At b8 a group is the 8
//     windows of a mask index; an unmasked launch groups G consecutive
//     windows, G chosen on the host to fill the SMs' waves (b1's masked
//     launches have one window a group, so nothing is shared there).
//     One producer warp streams each window's q tile [64, 32] and its whole
//     K and V [N, 32] by TMA (3D tensor maps over the qkv column slices,
//     64-byte swizzle, keys past N zero-filled) through a ring of two stages
//     (one where N > ~400 leaves no room) on full/empty mbarriers; every wait
//     traps after 10 s, so a fault in the schedule is a failed launch, not a
//     hang. Three consumer warpgroups split each window's keys in chunks of
//     64 (warpgroup c % 3 takes chunk c): S = (q s) K^T by wgmma m64n64k16
//     with q from registers, the weights, re-packed in registers as the bf16
//     A operand of P V (wgmma m64n32k16, V from shared memory). The static
//     shift needs no row max, so one sweep over the keys does, and the
//     warpgroups' partial outputs and row sums simply add: the others hand
//     theirs to the first through shared memory, which normalises and
//     stores. K and V are read once per (window, head, query tile).
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

#include <atomic>

#include "hopper.cuh"

namespace {

constexpr int D = 32;       // head dim
constexpr int MAX_N = 512;  // tokens per window

struct Args {
  const void* q; const void* k; const void* v;
  int64_t s_w, s_h, s_n;           // q/k/v element strides (head dim contiguous)
  void* out; int64_t o_w, o_h, o_n;
  const float* bias;               // [heads, n, n]
  const void* mask; int n_masks;   // [n_masks, n, n]: bf16 (tensor cores) or f32 (SIMT); or null
  float scale;
  int n;
};

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

// ------------------------------------------------------ bf16: Hopper

namespace hop {

using namespace hopper;
typedef __nv_bfloat16 bf16;

constexpr int BM = 64;                         // query rows of a tile (one wgmma M)
constexpr int KCH = 64;                        // keys of a chunk (wgmma N of S)
constexpr int CONSUMERS = 3;                   // consumer warpgroups
constexpr int THREADS = 128 * CONSUMERS + 32;  // + one producer warp
constexpr int PRODUCER_WARP = 4 * CONSUMERS;
constexpr int ROW_BYTES = D * 2;               // a token's head slice: 64 bytes
constexpr int Q_BYTES = BM * ROW_BYTES;        // 4 KB
constexpr int XCHG = 18;                       // floats a thread hands over: 16 of O, 2 row sums
constexpr int SMEM_MAX = 232448;
constexpr float LOG2E = 1.4426950408889634f;

// what the host decides for a launch
struct Plan {
  int nk;           // keys padded to a multiple of 16
  int kbox, nbox;   // K and V come in nbox TMA boxes of kbox rows
  int kv_bytes;     // K (or V) of one window in shared memory
  int stage_bytes;  // q tile + K + V
  int stages;       // 2, or 1 where two do not fit
  int q_tiles;      // ceil(N / 64)
  int n_groups;     // mask indices (1 without a mask)
  int per_group;    // windows that read one mask index (B_ / n_groups)
  int g;            // windows a block takes (G)
  int splits;       // blocks a group's windows are split over: ceil(per_group / G)
  int heads;
  int pitch;        // floats a tile row: the least >= N that is 8 mod 32
};

__host__ __device__ constexpr int tile_bytes(int pitch) { return pitch * BM * 4; }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
// the static-shift weight exp(min(x - 24, 60)) of a logit x = s + (bias +
// mask), with the tile holding b = (bias + mask) log2 e - 24 log2 e:
// 2^min(s log2 e + b, 60 log2 e)
__device__ __forceinline__ float weight(float s, float b) {
  return ex2(fminf(fmaf(s, LOG2E, b), 60.f * LOG2E));
}

// One chunk of W keys from key kc on: S = (q s) K^T, the weights against
// the bias tile (ta: this thread's row a at key 2 (lane % 4); row b = a + 8
// is 8 rows on), their row sums, and O += P V. The accumulator element
// 4 j + 2 h + e is row 16 warp + lane / 4 + 8 h, key kc + 8 j + 2 (lane % 4)
// + e; elements 4 j .. 4 j + 3 of steps j = 2 s, 2 s + 1 are the A fragment
// of P V's k step s, so P never leaves the registers. Keys past N (the last
// chunk's, and the tile's pad) get weight 0. P V is left in flight: the
// next chunk's wait covers it.
template <int W>
__device__ __forceinline__ void chunk(const uint32_t (&qa)[2][4], const uint8_t* ks,
                                      const uint8_t* vs, int kc, const float* ta, int pitch,
                                      int n, int t4, float (&o)[16], float& sum_a, float& sum_b) {
  float s[W / 2];
  wgmma_fence();
  WgmmaRS<W, 0>::mma(s, qa[0], desc_sw64(ks + kc * ROW_BYTES, 16), 0);
  WgmmaRS<W, 0>::mma(s, qa[1], desc_sw64(ks + kc * ROW_BYTES + 32, 16), 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
  uint32_t p[W / 16][4];
  const bool edge = kc + W > n;  // keys past N in this chunk: weight 0
#pragma unroll
  for (int j = 0; j < W / 8; ++j) {
    const float2 ba = *reinterpret_cast<const float2*>(ta + kc + 8 * j);
    const float2 bb = *reinterpret_cast<const float2*>(ta + 8 * pitch + kc + 8 * j);
    float e0 = weight(s[4 * j], ba.x), e1 = weight(s[4 * j + 1], ba.y);
    float e2 = weight(s[4 * j + 2], bb.x), e3 = weight(s[4 * j + 3], bb.y);
    if (edge) {
      const int key = kc + 8 * j + 2 * t4;
      if (key >= n) e0 = e2 = 0.f;
      if (key + 1 >= n) e1 = e3 = 0.f;
    }
    sum_a += e0 + e1;
    sum_b += e2 + e3;
    p[j >> 1][(j & 1) * 2] = pack_bf16(e0, e1);
    p[j >> 1][(j & 1) * 2 + 1] = pack_bf16(e2, e3);
  }
  wgmma_fence();
#pragma unroll
  for (int st = 0; st < W / 16; ++st)
    WgmmaRS<32, 1>::mma(o, p[st], desc_sw64(vs + (kc + 16 * st) * ROW_BYTES, 512), 1);
  wgmma_commit();
}

// One block per (head, group of windows that share a mask index, query tile
// of 64 rows); see the note at the top. Needs q, k, v 16-byte aligned with
// strides that are multiples of 8 elements (the tensor maps), and out, bias
// and mask as the host checks.
__global__ void __launch_bounds__(THREADS, 1)
    attn_bf16(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
              const __grid_constant__ CUtensorMap tm_v, Args g, Plan p) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 511) & ~static_cast<uintptr_t>(511));
  uint8_t* ring = base;                                        // stages x [q | K | V]
  float* tile = reinterpret_cast<float*>(ring + p.stages * p.stage_bytes);  // [64][pitch]
  float* xchg = reinterpret_cast<float*>(ring + p.stages * p.stage_bytes + tile_bytes(p.pitch));
  uint64_t* full = reinterpret_cast<uint64_t*>(xchg + (CONSUMERS - 1) * XCHG * 128);
  uint64_t* empty = full + p.stages;

  // block x = query tile + q_tiles (head + heads group): the query tiles of a
  // (head, group) run together and share each window's K and V in L2, and
  // every head of a group runs before the next group, so a mask slice is
  // read from device memory once for all heads
  const int N = g.n;
  const int qt = blockIdx.x % p.q_tiles, h = (blockIdx.x / p.q_tiles) % p.heads;
  const int grp = blockIdx.x / p.q_tiles / p.heads;
  const int mi = grp % p.n_groups, split = grp / p.n_groups;
  const int b0 = split * p.g, nw = min(p.g, p.per_group - b0);  // windows mi + b n_groups
  const int q0 = qt * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int i = 0; i < p.stages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, 4 * CONSUMERS);  // lane 0 of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == PRODUCER_WARP) {
    if (lane == 0) {
      const uint32_t tx = Q_BYTES + 2 * p.nbox * p.kbox * ROW_BYTES;
      for (int it = 0; it < nw; ++it) {
        const int sl = it % p.stages;
        if (it >= p.stages) mbar_wait(empty + sl, ((it / p.stages) & 1) ^ 1);
        uint8_t* st = ring + sl * p.stage_bytes;
        const int w = mi + (b0 + it) * p.n_groups, x = h * (int)g.s_h;
        mbar_expect_tx(full + sl, tx);
        tma_load_3d(st, &tm_q, full + sl, x, q0, w);
        for (int b = 0; b < p.nbox; ++b) {
          tma_load_3d(st + Q_BYTES + b * p.kbox * ROW_BYTES, &tm_k, full + sl, x, b * p.kbox, w);
          tma_load_3d(st + Q_BYTES + p.kv_bytes + b * p.kbox * ROW_BYTES, &tm_v, full + sl, x,
                      b * p.kbox, w);
        }
      }
    }
    return;
  }

  // the bias (+ mask) tile: row r (query q0 + r < N), key k < pitch holds
  // (bias + mask) log2 e - 24 log2 e (keys past N 0, never weighted; rows
  // past N are not filled: their outputs are not stored). Each thread takes
  // runs of 4 keys of a row (16 bytes of bias, 8 of mask, where N % 4 == 0;
  // a warp reads and writes 512 consecutive bytes of one or two rows),
  // FILL_U runs at once so that their loads are in flight together.
  {
    constexpr int FILL_U = 4;
    const float* bias = g.bias + (int64_t)h * N * N;
    const bf16* mask =
        g.mask ? static_cast<const bf16*>(g.mask) + (int64_t)mi * N * N : nullptr;
    const int runs = p.pitch / 4, units = min(BM, N - q0) * runs;
    const bool vec = N % 4 == 0;
    for (int u0 = threadIdx.x; u0 < units; u0 += FILL_U * 128 * CONSUMERS) {
      float v[FILL_U][4];
#pragma unroll
      for (int i = 0; i < FILL_U; ++i) {
        const int u = min(u0 + i * 128 * CONSUMERS, units - 1);
        const int rl = u / runs, r = q0 + rl, k = 4 * (u - rl * runs);
        const int64_t at = (int64_t)r * N + k;
        if (vec && k + 3 < N) {
          const float4 b = *reinterpret_cast<const float4*>(bias + at);
          v[i][0] = b.x; v[i][1] = b.y; v[i][2] = b.z; v[i][3] = b.w;
          if (mask) {
            const uint2 m = *reinterpret_cast<const uint2*>(mask + at);
            const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&m.x);
            const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&m.y);
            v[i][0] += __low2float(lo); v[i][1] += __high2float(lo);
            v[i][2] += __low2float(hi); v[i][3] += __high2float(hi);
          }
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            v[i][c] = k + c < N
                          ? bias[at + c] + (mask ? __bfloat162float(mask[at + c]) : 0.f)
                          : 0.f;
        }
      }
#pragma unroll
      for (int i = 0; i < FILL_U; ++i) {
        const int u = u0 + i * 128 * CONSUMERS;
        if (u >= units) break;
        const int rl = u / runs, k = 4 * (u - rl * runs);
#pragma unroll
        for (int c = 0; c < 4; ++c) v[i][c] = fmaf(v[i][c], LOG2E, -24.f * LOG2E);
        *reinterpret_cast<float4*>(tile + rl * p.pitch + k) =
            make_float4(v[i][0], v[i][1], v[i][2], v[i][3]);
      }
    }
  }
  named_sync(1, 128 * CONSUMERS);

  const int wg = threadIdx.x >> 7, t = threadIdx.x & 127;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int row_a = q0 + 16 * (warp & 3) + g8, row_b = row_a + 8;
  const float* ta = tile + (16 * (warp & 3) + g8) * p.pitch + 2 * t4;  // this thread's row a
  // q * scale in bf16, as the Pallas kernel's `q * scale.astype(bf16)`
  const float sc = __bfloat162float(__float2bfloat16(g.scale));
  const int n_chunks = (p.nk + KCH - 1) / KCH;

  for (int it = 0; it < nw; ++it) {
    const int sl = it % p.stages;
    const uint8_t* st = ring + sl * p.stage_bytes;
    const uint8_t* ks = st + Q_BYTES;
    const uint8_t* vs = ks + p.kv_bytes;
    mbar_wait(full + sl, (it / p.stages) & 1);

    // this thread's A fragments of q (rows r, r + 8; head dims 2 t4 + {0, 1}
    // and + 8, for each k step of 16), read through the 64-byte swizzle
    uint32_t qa[2][4];
#pragma unroll
    for (int ks16 = 0; ks16 < 2; ++ks16)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 16 * (warp & 3) + g8 + 8 * (e & 1);
        const int c = 16 * ks16 + 8 * (e >> 1) + 2 * t4;
        const int off = r * ROW_BYTES + ((((c >> 3) ^ (r >> 1)) & 3) << 4) + (c & 7) * 2;
        const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(st + off);
        qa[ks16][e] = pack_bf16(__low2float(x) * sc, __high2float(x) * sc);
      }

    float o[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) o[i] = 0.f;
    float sum_a = 0.f, sum_b = 0.f;
    for (int c = wg; c < n_chunks; c += CONSUMERS) {
      const int kc = c * KCH;
      if (kc + KCH <= p.nk) {
        chunk<KCH>(qa, ks, vs, kc, ta, p.pitch, N, t4, o, sum_a, sum_b);
      } else {
        for (int k16 = kc; k16 < p.nk; k16 += 16)
          chunk<16>(qa, ks, vs, k16, ta, p.pitch, N, t4, o, sum_a, sum_b);
      }
    }
    wgmma_wait<0>();
    fence_regs(o);
    if (lane == 0) mbar_arrive(empty + sl);  // this warp is done with the stage

    // the other warpgroups hand their partial O and row sums to the first
    // (the same rows and columns in the same registers), which adds them,
    // normalises and stores; barrier 2: handed over, 3: taken
    if (wg > 0) {
      float* x = xchg + (wg - 1) * XCHG * 128 + t;
      if (it > 0) named_sync(3, 128 * CONSUMERS);
#pragma unroll
      for (int i = 0; i < 16; ++i) x[i * 128] = o[i];
      x[16 * 128] = sum_a;
      x[17 * 128] = sum_b;
      named_arrive(2, 128 * CONSUMERS);
      continue;
    }
    named_sync(2, 128 * CONSUMERS);
#pragma unroll
    for (int c = 0; c < CONSUMERS - 1; ++c) {
      const float* x = xchg + c * XCHG * 128 + t;
#pragma unroll
      for (int i = 0; i < 16; ++i) o[i] += x[i * 128];
      sum_a += x[16 * 128];
      sum_b += x[17 * 128];
    }
    if (it + 1 < nw) named_arrive(3, 128 * CONSUMERS);
    // a row's sum is spread over the 4 threads of its quad
    sum_a += __shfl_xor_sync(0xffffffffu, sum_a, 1);
    sum_a += __shfl_xor_sync(0xffffffffu, sum_a, 2);
    sum_b += __shfl_xor_sync(0xffffffffu, sum_b, 1);
    sum_b += __shfl_xor_sync(0xffffffffu, sum_b, 2);
    const float ra = 1.f / sum_a, rb = 1.f / sum_b;
    const int w = mi + (b0 + it) * p.n_groups;
    bf16* O = static_cast<bf16*>(g.out) + (int64_t)w * g.o_w + (int64_t)h * g.o_h;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int c = 8 * j + 2 * t4;
      if (row_a < N)
        *reinterpret_cast<__nv_bfloat162*>(O + (int64_t)row_a * g.o_n + c) =
            __floats2bfloat162_rn(o[4 * j] * ra, o[4 * j + 1] * ra);
      if (row_b < N)
        *reinterpret_cast<__nv_bfloat162*>(O + (int64_t)row_b * g.o_n + c) =
            __floats2bfloat162_rn(o[4 * j + 2] * rb, o[4 * j + 3] * rb);
    }
  }
}

}  // namespace hop

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

// the shared memory a plan needs: the slack to align the ring to the 512
// bytes of the swizzle's period, the ring, the bias tile, the hand-over and
// the barriers
int smem_bytes(const hop::Plan& p) {
  return 512 + p.stages * p.stage_bytes + hop::tile_bytes(p.pitch) +
         (hop::CONSUMERS - 1) * hop::XCHG * 128 * 4 + 2 * p.stages * 8;
}

// The schedule of a bf16 launch. Windows w = i + b n_groups share mask i
// (every window shares the bias without a mask); a block takes G of them.
// G trades the bias tile each block loads against the last wave's idle SMs:
// the cost of a choice is waves x (G + 1), the tile counted as one window (on
// the card, weighting it less or more made the b8 request slower).
hop::Plan plan_bf16(int windows, int heads, int n, int n_masks, bool masked) {
  using namespace hop;
  Plan p{};
  p.nk = (n + 15) & ~15;
  p.pitch = n + ((8 - n % 32) % 32 + 32) % 32;
  p.nbox = (p.nk + 255) / 256;
  p.kbox = ((p.nk + p.nbox - 1) / p.nbox + 7) & ~7;
  p.kv_bytes = (p.nbox * p.kbox * ROW_BYTES + 511) & ~511;
  p.stage_bytes = Q_BYTES + 2 * p.kv_bytes;
  p.stages = 2;
  if (smem_bytes(p) > SMEM_MAX) p.stages = 1;
  p.q_tiles = (n + BM - 1) / BM;
  p.n_groups = masked ? n_masks : 1;
  p.per_group = windows / p.n_groups;
  p.heads = heads;
  const int64_t units = (int64_t)heads * p.q_tiles * p.n_groups, sms = hopper::sm_count();
  int64_t best = -1;
  for (int gg = 1; gg <= p.per_group; ++gg) {
    const int64_t splits = (p.per_group + gg - 1) / gg;
    if (gg > 1 && splits == (p.per_group + gg - 2) / (gg - 1)) continue;  // same split count
    const int64_t cost = (units * splits + sms - 1) / sms * (gg + 1);
    if (best < 0 || cost < best) {
      best = cost;
      p.g = gg;
    }
  }
  p.splits = (p.per_group + p.g - 1) / p.g;
  return p;
}

// q, k or v of every window: dims (head columns, tokens, windows), boxes of
// [rows, 32] at (h s_h, token, window), 64-byte swizzled
bool qkv_map(CUtensorMap* map, const void* ptr, const Args& g, int heads, int windows,
             int box_rows) {
  const cuuint64_t dim[3] = {(cuuint64_t)heads * g.s_h, (cuuint64_t)g.n, (cuuint64_t)windows};
  const cuuint64_t stride[2] = {(cuuint64_t)g.s_n * 2, (cuuint64_t)g.s_w * 2};
  const cuuint32_t box[3] = {(cuuint32_t)D, (cuuint32_t)box_rows, 1};
  return hopper::encode_bf16(map, ptr, 3, dim, stride, box, CU_TENSOR_MAP_SWIZZLE_64B);
}

// lets hop::attn_bf16 take up to SMEM_MAX bytes of dynamic shared memory,
// once per device: a launch then sizes its own within that
cudaError_t allow_smem_bf16() {
  static std::atomic<bool> done[hopper::MAX_DEVICES];
  const int slot = hopper::device_slot();
  if (slot >= 0 && done[slot].load(std::memory_order_acquire)) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      hop::attn_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize, hop::SMEM_MAX);
  if (e == cudaSuccess && slot >= 0) done[slot].store(true, std::memory_order_release);
  return e;
}

cudaError_t launch_bf16(const Args& g, int windows, int heads, cudaStream_t s) {
  const hop::Plan p = plan_bf16(windows, heads, g.n, g.n_masks, g.mask != nullptr);
  const int smem = smem_bytes(p);
  if (smem > hop::SMEM_MAX) return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  if (!qkv_map(&tq, g.q, g, heads, windows, hop::BM) ||
      !qkv_map(&tk, g.k, g, heads, windows, p.kbox) ||
      !qkv_map(&tv, g.v, g, heads, windows, p.kbox))
    return cudaErrorInvalidValue;
  const cudaError_t e = allow_smem_bf16();
  if (e != cudaSuccess) return e;
  const int64_t blocks = (int64_t)p.q_tiles * heads * p.n_groups * p.splits;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  hop::attn_bf16<<<(unsigned)blocks, hop::THREADS, smem, s>>>(tq, tk, tv, g, p);
  return cudaGetLastError();
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
    err = launch_bf16(g, windows, heads, s);
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
  return plan_bf16(windows, heads, n, n_masks, masked != 0).g;
}

extern "C" const char* k3_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K6: window attention for the windows above K2's range (N >= 65 tokens, any
// N above that), head dims 8 to 128 in steps of 8, cosine (SwinV2) or
// scaled. For each (window w, head h):
//
//   cosine: out = softmax_rows(scales[h] (q^ . k^T^) + bias[h] + mask[w % n_masks]) . v
//           q^ = q / max(|q|, 1e-12), k^ likewise, per row
//   scaled: out = softmax_rows((q scales[h]) . k^T + bias[h] + mask[w % n_masks]) . v
//
// with the max-stabilised f32 softmax and an exact divide by the row sum.
//
// Replaces the Pallas kernel
//   deepfake_tpu/ops/pallas_window_attn.py:1127 pallas_window_attention,
//     route _run_multihead :179 (_multihead_kernel :149, call :192), taken for
//     N >= 128 (:1155-1164), and, for 64 < N < 128, the routes _run :51 and
//     _run_packed :126 of the same entry and pallas_window_attention_nhc_packed
//     :847 (the same function; K2 takes N <= 64).
// SwinV2 reaches it at windows 9-11 (N = 81-121), 16 (N = 256: SwinV2-B at
// 256^2 runs it in the 22 blocks of stages 0-2) and 24 (N = 576, the
// published 384^2 fine-tunes). The caller passes element strides for the
// window, head and token axes (the head dim is contiguous), so q, k and v are
// read straight out of the [B_, N, 3C] qkv tensor and out is written as
// [B_, N, C] (or any head-major layout): no split or merge copy, in either
// of SwinV2's layouts. The TPU kernel's head grouping (Gh heads whose bias
// fits ~2.5 MB of VMEM) is MXU/VMEM tiling and is not copied.
//
// Cast points (the Pallas kernel's): q, k, v read as f32; the cosine rows
// normalised in f32; logits, bias, mask, softmax and P V in f32; the output
// rounded once to the input type. The mask is f32 (any additive mask).
//
// What bounds it on the H100 (3.35 TB/s, 989 TFLOP/s bf16): bytes. A launch
// reads q, k, v and writes out once (bf16), reads the f32 bias [H, N, N] and
// the f32 mask [nW, N, N] once, and does 4 B_ H N^2 D operations (6 with the
// cosine split below). At SwinV2-B window 16, 256^2, b8, stage 0 (B_ = 128,
// H = 4, 16 masks) moves ~39 MB, ~12 us, against ~7 us of tensor-core work
// with the split; the 22 launches of a request need ~0.10 ms by bytes.
//
// Routes:
//   - bf16 (serving), Hopper (namespace hop): K2's design past 64 tokens,
//     on window_attn_tile.cuh's chunk (the online-max softmax of K5's
//     forward). The first design (one block per (window, 128-row slab,
//     head), mma.sync, bias and mask read from device memory in the inner
//     loop) spent ~19% of an audio request's launches on those loads and
//     6% on the two extra products of its split (tools/k6_step0.py,
//     PERF.md). Now one block per (head, group of G windows that read one
//     mask index, 64-row query tile; G from the host, window_group in
//     ops/window_attn3d_train.py with the block's warpgroups counted) builds
//     its [64, N] slice of bias[h] + mask[i] once, in log2 units, in an f32
//     tile in shared memory (the bias stays f32: SwinV2's runs up to 16, and
//     a bf16 bias would move a weight by several percent), and every window
//     of the group reads it there. The group's windows are dealt out to the
//     block's warpgroups (4 at N = 256, fewer where the tile leaves less
//     room): each takes whole windows, every key, so no warpgroup hands
//     anything to another. Each warpgroup's thread 0 streams its windows'
//     q tile [64, 32] and K and V in key tiles of at most 256 keys by TMA
//     through its own ring (4D tensor maps over the head, token and window
//     axes in stride order, so head-major and token-major views are the same
//     code; 64-byte swizzle; tokens past N zero-filled). Cosine logits reach
//     |scale| = 100, where rounding q^ to bf16 would move a logit by ~100 x
//     2^-9 x |q^ . k|, several percent of a weight: so q^ = q / max(|q|,
//     1e-12) is formed in f32 and split into bf16 hi + lo, S = hi k^T +
//     lo k^T takes two wgmma products (~2^-16 relative), and k, exact in
//     bf16, is not rounded at all: its row norm is applied per key in f32
//     after the product, as the factor scale log2 e / max(|k|, 1e-12) of a
//     logit in log2 units (the design's third product, hi.lo of K2, is not
//     needed). Scaled logits take the bf16 q and k as they are (one product)
//     and scale after. A logit in log2 units is one FMA (S factor + tile),
//     a weight ex2.approx of it less the online row max; the weights are
//     rounded to bf16 for P V (wgmma, V from shared memory); the output is
//     divided by the row sum in f32 and rounded once. Where no tile of N
//     columns fits beside the rings (N > ~700, off every model path), one
//     warpgroup a block refills a tile of one key tile's columns before each
//     key tile, which shares nothing. Every mbarrier wait traps after 10 s
//     (hopper.cuh), so a fault in the schedule is a failed launch.
//   The Hopper route is built for head dim 32 (every SwinV2-B head); other
//     head dims take window_attn_mma.cuh's tensor-core kernel (mma.sync).
//   - f32 (parity runs only): one block per (32-query tile, window, head),
//     SIMT f32 FMA; K and V stream through shared
//     memory in tiles of 128 keys (64 at heads of 128 columns) with an
//     online row max, the [32, 128] logit tile in shared memory. Instances
//     for heads of 32, 64 and 128 columns, a narrower head zero-filled.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <atomic>

#include "window_attn_mma.cuh"
#include "window_attn_tile.cuh"

namespace {

constexpr int D = 32;      // head dim
static_assert(D == wtile::mma::WGMMA_D, "the wgmma kernel's head dim");
constexpr int MIN_N = 65;  // windows of N <= 64 are K2's
typedef __nv_bfloat16 bf16;

struct Args {
  const void* q; const void* k; const void* v;
  int64_t s_w, s_h, s_n;           // q/k/v element strides (head dim contiguous)
  void* out; int64_t o_w, o_h, o_n;
  const float* bias;               // [heads, n, n]
  const float* mask; int n_masks;  // [n_masks, n, n] or null
  const float* scales;             // [heads]: logit scale (cosine) or the scale (scaled)
  int n;
};

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
// the sum over the 4 threads of a quad (the threads that share a row of a
// wgmma accumulator)
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
// the L2 norm's divisor, as the plain version's x / max(|x|, 1e-12)
__device__ __forceinline__ float norm_div(float ss) { return fmaxf(sqrtf(ss), 1e-12f); }

// ------------------------------------------------------------- f32: SIMT

namespace simt {

constexpr int MQ = 32, THREADS = 256;
constexpr int ROWS_PER_WARP = MQ / (THREADS / 32);

// keys a tile: 128, 64 at heads of 128 columns (the shared memory)
__host__ __device__ constexpr int key_tile(int dc) { return dc <= 2 ? 128 : 64; }
template <int DC>
__host__ __device__ constexpr size_t smem_bytes() {
  return sizeof(float) * ((2 * key_tile(DC) + MQ) * (32 * DC + 1) + MQ * (key_tile(DC) + 1));
}

// Any head dim d of 8 to 128 (DC column groups of 32, the columns from d on
// zero-filled, which change neither the norms, q.k nor the kept columns of
// P V)
template <bool COSINE, int DC>
__global__ void __launch_bounds__(THREADS) attn_simt(Args g, int d) {
  constexpr int DW = 32 * DC, DP = DW + 1, KT = key_tile(DC), NP = KT + 1;
  extern __shared__ float sm[];
  const int N = g.n;
  float* ks = sm;              // [KT][DP]
  float* vs = ks + KT * DP;    // [KT][DP]
  float* qs = vs + KT * DP;    // [MQ][DP]
  float* ps = qs + MQ * DP;    // [MQ][NP] logits, then weights, of one key tile

  const int w = blockIdx.x, q0 = blockIdx.y * MQ, h = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rows = min(MQ, N - q0);
  const int64_t base = (int64_t)w * g.s_w + (int64_t)h * g.s_h;
  const float* Q = static_cast<const float*>(g.q) + base;
  const float* K = static_cast<const float*>(g.k) + base;
  const float* V = static_cast<const float*>(g.v) + base;
  const float scale = g.scales[h];

  for (int idx = tid; idx < MQ * DW; idx += THREADS) {
    const int i = idx / DW, c = idx % DW;
    const float x = i < rows && c < d ? Q[(int64_t)(q0 + i) * g.s_n + c] : 0.f;
    qs[i * DP + c] = COSINE ? x : x * scale;
  }
  // a row's L2 norm: lane c holds columns c + 32 u
  auto normalise = [&](float* row) {
    float ss = 0.f;
#pragma unroll
    for (int u = 0; u < DC; ++u) ss += row[lane + 32 * u] * row[lane + 32 * u];
    const float div = norm_div(warp_sum(ss));
#pragma unroll
    for (int u = 0; u < DC; ++u) row[lane + 32 * u] = row[lane + 32 * u] / div;
  };
  if (COSINE) {
    __syncthreads();
    for (int r = warp; r < rows; r += THREADS / 32) normalise(qs + r * DP);
  }

  const float* bias = g.bias + (int64_t)h * N * N;
  const float* mask = g.mask ? g.mask + (int64_t)(w % g.n_masks) * N * N : nullptr;
  // the online softmax of rows warp + 8 i: running max, sum, and lane c's
  // columns c + 32 u of the unnormalised P V
  float m[ROWS_PER_WARP], l[ROWS_PER_WARP], o[ROWS_PER_WARP][DC];
#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int u = 0; u < DC; ++u) o[i][u] = 0.f;
  }
  for (int t0 = 0; t0 < N; t0 += KT) {
    const int nt = min(KT, N - t0);
    __syncthreads();  // the previous tile is consumed (and q is ready)
    for (int idx = tid; idx < nt * DW; idx += THREADS) {
      const int j = idx / DW, c = idx % DW;
      const int64_t off = (int64_t)(t0 + j) * g.s_n + c;
      ks[j * DP + c] = c < d ? K[off] : 0.f;
      vs[j * DP + c] = c < d ? V[off] : 0.f;
    }
    if (COSINE) {
      __syncthreads();
      for (int r = warp; r < nt; r += THREADS / 32) normalise(ks + r * DP);
    }
    __syncthreads();
    for (int idx = tid; idx < rows * nt; idx += THREADS) {
      const int i = idx / nt, j = idx - i * nt;
      const float* qi = qs + i * DP;
      const float* kj = ks + j * DP;
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < DW; ++c) s = fmaf(qi[c], kj[c], s);
      if (COSINE) s *= scale;
      const int64_t at = (int64_t)(q0 + i) * N + t0 + j;
      s += bias[at];
      if (mask) s += mask[at];
      ps[i * NP + j] = s;
    }
    __syncthreads();
#pragma unroll
    for (int ri = 0; ri < ROWS_PER_WARP; ++ri) {
      const int i = warp + ri * (THREADS / 32);
      if (i >= rows) continue;
      float* p = ps + i * NP;
      float mt = -INFINITY;
      for (int j = lane; j < nt; j += 32) mt = fmaxf(mt, p[j]);
      const float mn = fmaxf(m[ri], warp_max(mt));
      const float base_ = mn == -INFINITY ? 0.f : mn;
      const float alpha = expf(m[ri] - base_);  // m = -inf: 0
      float sum = 0.f;
      for (int j = lane; j < nt; j += 32) {
        const float e = expf(p[j] - base_);
        p[j] = e;
        sum += e;
      }
      l[ri] = l[ri] * alpha + warp_sum(sum);
      __syncwarp();
#pragma unroll
      for (int u = 0; u < DC; ++u) {
        float acc = 0.f;
        for (int j = 0; j < nt; ++j) acc = fmaf(p[j], vs[j * DP + lane + 32 * u], acc);
        o[ri][u] = o[ri][u] * alpha + acc;
      }
      m[ri] = mn;
    }
  }

  float* O = static_cast<float*>(g.out) + (int64_t)w * g.o_w + (int64_t)h * g.o_h;
#pragma unroll
  for (int ri = 0; ri < ROWS_PER_WARP; ++ri) {
    const int i = warp + ri * (THREADS / 32);
    if (i >= rows) continue;
#pragma unroll
    for (int u = 0; u < DC; ++u)
      if (lane + 32 * u < d) O[(int64_t)(q0 + i) * g.o_n + lane + 32 * u] = o[ri][u] / l[ri];
  }
}

}  // namespace simt

// ------------------------------------------------------ bf16: Hopper

namespace hop {

using namespace hopper;
using wtile::BM;
using wtile::KCH;
using wtile::LOG2E;
using wtile::Q_BYTES;
using wtile::ROW_BYTES;
using wtile::SMEM_MAX;

constexpr int MAX_CONSUMERS = 4;  // warpgroups a block
constexpr int MAX_KT = 256;       // keys of a key tile (one TMA box)

// what the host decides for a launch
struct Plan {
  int kt, n_kt;          // keys of a key tile (a multiple of 16) and key tiles a window
  int stage_bytes;       // q tile + K tile + V tile, a multiple of 512
  int stages;            // a warpgroup's ring: 2, or 1 where two do not fit
  int consumers;         // warpgroups: 4, 2 or 1
  int sliced;            // the tile holds the current key tile's columns only (1 warpgroup)
  int pitch;             // floats a tile row: 8 mod 32, so a warp's 8 rows fall on distinct banks
  int q_tiles;           // ceil(N / 64)
  int n_groups;          // mask indices (1 without a mask)
  int per_group;         // windows that read one mask index (B_ / n_groups)
  int g;                 // windows a block takes (G)
  int splits;            // blocks a group's windows are split over: ceil(per_group / G)
  int heads;
  int ax_h, ax_n, ax_w;  // the tensor maps' dims (1-3) that are the head, token and window axes
};

// Rows [0, min(64, n - q0)) of the tile: column c < pitch holds
// (bias + mask)[q0 + r][k0 + c] log2 e (0 past n: the chunks weight those
// keys 0); rows past n are not filled (their outputs are not stored). A
// thread takes runs of 4 columns (16-byte loads where n % 4 == 0), FILL_U
// at once so that their loads are in flight together.
__device__ __forceinline__ void fill(float* tile, int pitch, const float* bias, const float* mask,
                                     int q0, int k0, int n, int tid, int threads) {
  constexpr int FILL_U = 4;
  const int runs = pitch / 4, units = min(BM, n - q0) * runs;
  const bool vec = n % 4 == 0;
  for (int u0 = tid; u0 < units; u0 += FILL_U * threads) {
    float v[FILL_U][4];
#pragma unroll
    for (int i = 0; i < FILL_U; ++i) {
      const int u = min(u0 + i * threads, units - 1);
      const int rl = u / runs, k = k0 + 4 * (u - rl * runs);
      const int64_t at = (int64_t)(q0 + rl) * n + k;
      if (vec && k + 3 < n) {
        const float4 b = *reinterpret_cast<const float4*>(bias + at);
        v[i][0] = b.x; v[i][1] = b.y; v[i][2] = b.z; v[i][3] = b.w;
        if (mask) {
          const float4 m = *reinterpret_cast<const float4*>(mask + at);
          v[i][0] += m.x; v[i][1] += m.y; v[i][2] += m.z; v[i][3] += m.w;
        }
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          v[i][c] = k + c < n ? bias[at + c] + (mask ? mask[at + c] : 0.f) : 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < FILL_U; ++i) {
      const int u = u0 + i * threads;
      if (u >= units) break;
      const int rl = u / runs, c = 4 * (u - rl * runs);
      *reinterpret_cast<float4*>(tile + rl * pitch + c) =
          make_float4(v[i][0] * LOG2E, v[i][1] * LOG2E, v[i][2] * LOG2E, v[i][3] * LOG2E);
    }
  }
}

// One block per (head, group of windows that read one mask index, query
// tile of 64 rows); see the note at the top. Warpgroup c takes the group's
// windows c, c + consumers, ..., each over every key tile, through its own
// ring, whose loads its thread 0 issues. Needs q, k, v 16-byte aligned with
// strides that are multiples of 8 elements (the tensor maps), and out, bias
// and mask as the host checks.
template <bool COSINE>
__global__ void __launch_bounds__(128 * MAX_CONSUMERS, 1)
    attn_bf16(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
              const __grid_constant__ CUtensorMap tm_v, Args g, Plan p) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* rings = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 511) & ~static_cast<uintptr_t>(511));
  // consumers x stages x [q | K | V], the tile [64][pitch] (and 16 floats
  // that the last row's last chunk may read past its end), the per-key
  // factors (consumers x stages x [kt]), the barriers (consumers x stages)
  float* tile = reinterpret_cast<float*>(rings + p.consumers * p.stages * p.stage_bytes);
  float* factors = tile + BM * p.pitch + 16;
  uint64_t* full = reinterpret_cast<uint64_t*>(factors + p.consumers * p.stages * p.kt);

  const int N = g.n;
  const int qt = blockIdx.x % p.q_tiles, h = (blockIdx.x / p.q_tiles) % p.heads;
  const int grp = blockIdx.x / p.q_tiles / p.heads;
  const int mi = grp % p.n_groups, b0 = (grp / p.n_groups) * p.g;
  const int nw = min(p.g, p.per_group - b0);  // windows mi + (b0 + j) n_groups
  const int q0 = qt * BM;
  const int wg = threadIdx.x >> 7, t = threadIdx.x & 127;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g8 = lane >> 2, t4 = lane & 3;
  // this warpgroup's windows j = wg, wg + consumers, ... < nw; iteration it
  // is key tile it % n_kt of its window it / n_kt
  const int mine = nw > wg ? (nw - wg + p.consumers - 1) / p.consumers : 0;
  const int total = mine * p.n_kt;
  uint8_t* ring = rings + wg * p.stages * p.stage_bytes;
  uint64_t* fb = full + wg * p.stages;
  float* fk = factors + wg * p.stages * p.kt;
  auto window = [&](int it) { return mi + (b0 + wg + (it / p.n_kt) * p.consumers) * p.n_groups; };

  // iteration it's q tile and K and V tiles into stage it % stages
  auto load = [&](int it) {
    const int sl = it % p.stages;
    uint8_t* st = ring + sl * p.stage_bytes;
    int c[4] = {0, 0, 0, 0};
    c[1 + p.ax_h] = h;
    c[1 + p.ax_w] = window(it);
    mbar_expect_tx(fb + sl, Q_BYTES + 2 * p.kt * ROW_BYTES);
    c[1 + p.ax_n] = q0;
    tma_load_4d(st, &tm_q, fb + sl, c[0], c[1], c[2], c[3]);
    c[1 + p.ax_n] = (it % p.n_kt) * p.kt;
    tma_load_4d(st + Q_BYTES, &tm_k, fb + sl, c[0], c[1], c[2], c[3]);
    tma_load_4d(st + Q_BYTES + p.kt * ROW_BYTES, &tm_v, fb + sl, c[0], c[1], c[2], c[3]);
  };
  if (t == 0) {
    for (int i = 0; i < p.stages; ++i) mbar_init(fb + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int it = 0; it < p.stages && it < total; ++it) load(it);
  }
  const float* bias = g.bias + (int64_t)h * N * N;
  const float* mask = g.mask ? g.mask + (int64_t)mi * N * N : nullptr;
  if (!p.sliced) fill(tile, p.pitch, bias, mask, q0, 0, N, threadIdx.x, 128 * p.consumers);
  __syncthreads();

  const float lsc = g.scales[h] * LOG2E;  // the logit scale (or the scale) in log2 units
  const int ra = 16 * (warp & 3) + g8;    // this thread's rows a = ra, b = ra + 8 of the tile
  uint32_t qa[2][4], ql[2][4];
  for (int j = 0; j < mine; ++j) {
    wtile::State st;
#pragma unroll
    for (int i = 0; i < 16; ++i) st.o[i] = 0.f;
    st.sum_a = st.sum_b = 0.f;
    st.m_a = st.m_b = -INFINITY;
    for (int kt = 0; kt < p.n_kt; ++kt) {
      const int it = j * p.n_kt + kt, sl = it % p.stages, k0 = kt * p.kt;
      const uint8_t* stg = ring + sl * p.stage_bytes;
      const uint8_t* ks = stg + Q_BYTES;
      const uint8_t* vs = ks + p.kt * ROW_BYTES;
      if (p.sliced) {  // one warpgroup: the tile takes this key tile's columns
        fill(tile, p.pitch, bias, mask, q0, k0, N, t, 128);
        named_sync(2 + wg, 128);
      }
      mbar_wait(fb + sl, (it / p.stages) & 1);

      if (kt == 0) {
        // this thread's A fragments of q (rows a, b; head dims 2 t4 + {0, 1}
        // and + 8, for each k step of 16), read through the 64-byte
        // swizzle; cosine: q^ = q / max(|q|, 1e-12) in f32, split into bf16
        // hi + lo
        float x[2][4][2];
        float ss_a = 0.f, ss_b = 0.f;
#pragma unroll
        for (int k16 = 0; k16 < 2; ++k16)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = ra + 8 * (e & 1), c = 16 * k16 + 8 * (e >> 1) + 2 * t4;
            const int off = r * ROW_BYTES + ((((c >> 3) ^ (r >> 1)) & 3) << 4) + (c & 7) * 2;
            qa[k16][e] = *reinterpret_cast<const uint32_t*>(stg + off);
            const float2 f =
                __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&qa[k16][e]));
            x[k16][e][0] = f.x;
            x[k16][e][1] = f.y;
            (e & 1 ? ss_b : ss_a) += f.x * f.x + f.y * f.y;
          }
        if (COSINE) {
          const float ia = 1.f / norm_div(quad_sum(ss_a)), ib = 1.f / norm_div(quad_sum(ss_b));
#pragma unroll
          for (int k16 = 0; k16 < 2; ++k16)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float inv = e & 1 ? ib : ia;
              const float y0 = x[k16][e][0] * inv, y1 = x[k16][e][1] * inv;
              qa[k16][e] = wtile::pack_bf16(y0, y1);
              const float2 hi =
                  __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&qa[k16][e]));
              ql[k16][e] = wtile::pack_bf16(y0 - hi.x, y1 - hi.y);
            }
        }
      }
      if (COSINE) {
        // each key's factor lsc / max(|k|, 1e-12) (keys past N are zeros:
        // their factor is finite and their weight 0); the 4 threads of a
        // quad read one key's 64 bytes (the swizzle only permutes them)
        for (int key = t >> 2; key < p.kt; key += 32) {
          const uint4 u = reinterpret_cast<const uint4*>(ks + key * ROW_BYTES)[t & 3];
          const uint32_t w4[4] = {u.x, u.y, u.z, u.w};
          float ss = 0.f;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float2 f =
                __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w4[i]));
            ss = fmaf(f.x, f.x, fmaf(f.y, f.y, ss));
          }
          ss = quad_sum(ss);
          if ((t & 3) == 0) fk[sl * p.kt + key] = lsc / norm_div(ss);
        }
        named_sync(2 + wg, 128);
      }

      // this key tile's keys, in chunks of 64 (the last ones 16 at a time)
      const int nv = N - k0;  // keys of this tile before N (more than kt but in the last)
      const int nkt = min(p.kt, (nv + 15) & ~15);
      const float* ta = tile + ra * p.pitch + 2 * t4 + (p.sliced ? 0 : k0);
      const float* xk = fk + sl * p.kt + 2 * t4;
      for (int kc = 0; kc < nkt; kc += KCH) {
        if (kc + KCH <= nkt) {
          wtile::chunk<KCH, wtile::MAX_STABLE, COSINE>(qa, ql, ks, vs, kc, ta, p.pitch, nv, t4,
                                                       lsc, xk, st);
        } else {
          for (int k16 = kc; k16 < nkt; k16 += 16)
            wtile::chunk<16, wtile::MAX_STABLE, COSINE>(qa, ql, ks, vs, k16, ta, p.pitch, nv,
                                                        t4, lsc, xk, st);
        }
      }
      wgmma_wait<0>();
      fence_regs(st.o);
      named_sync(2 + wg, 128);  // the warpgroup is done with the stage (and the tile's slice)
      if (t == 0 && it + p.stages < total) load(it + p.stages);
    }

    // the window's output: O divided by the row sums in f32, rounded once
    const float sa = quad_sum(st.sum_a), sb = quad_sum(st.sum_b);
    const int row_a = q0 + ra, row_b = row_a + 8;
    bf16* O = static_cast<bf16*>(g.out) + (int64_t)window(j * p.n_kt) * g.o_w +
              (int64_t)h * g.o_h;
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj) {
      const int c = 8 * jj + 2 * t4;
      if (row_a < N)
        *reinterpret_cast<__nv_bfloat162*>(O + (int64_t)row_a * g.o_n + c) =
            __floats2bfloat162_rn(st.o[4 * jj] / sa, st.o[4 * jj + 1] / sa);
      if (row_b < N)
        *reinterpret_cast<__nv_bfloat162*>(O + (int64_t)row_b * g.o_n + c) =
            __floats2bfloat162_rn(st.o[4 * jj + 2] / sb, st.o[4 * jj + 3] / sb);
    }
  }
}

}  // namespace hop

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// the SIMT kernel at head dim d: the instance of 1, 2 or 4 column groups
template <int DC>
cudaError_t launch_simt_dc(bool cosine, const Args& g, int windows, int heads, int d,
                           cudaStream_t s) {
  constexpr size_t smem = simt::smem_bytes<DC>();
  void (*kernel)(Args, int) = cosine ? simt::attn_simt<true, DC> : simt::attn_simt<false, DC>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<dim3(windows, (g.n + simt::MQ - 1) / simt::MQ, heads), simt::THREADS, smem, s>>>(g, d);
  return cudaGetLastError();
}
cudaError_t launch_simt(bool cosine, const Args& g, int windows, int heads, int d,
                        cudaStream_t s) {
  if (d <= 32) return launch_simt_dc<1>(cosine, g, windows, heads, d, s);
  if (d <= 64) return launch_simt_dc<2>(cosine, g, windows, heads, d, s);
  return launch_simt_dc<4>(cosine, g, windows, heads, d, s);
}

// the least x >= n with x % 32 == 8
constexpr int pitch_of(int n) { return n + ((8 - n % 32) % 32 + 32) % 32; }

// the alignment slack, the rings, the tile and its slack, the per-key
// factors and the barriers
int smem_bytes(const hop::Plan& p) {
  const int slots = p.consumers * p.stages;
  return 512 + slots * p.stage_bytes + (hop::BM * p.pitch + 16) * 4 + slots * p.kt * 4 + slots * 8;
}

// The schedule of a bf16 launch, but for the tensor maps' axes. Keys come
// in key tiles of at most 256 (one TMA box each). The tile holds every key's
// column where it fits beside the rings; the most warpgroups (4, 2, 1) and
// stages (2, 1) that fit are taken. Where no tile of N columns fits (N >
// ~700), one warpgroup a block refills a tile of one key tile's columns
// before each key tile: nothing is shared then.
hop::Plan plan_bf16(int windows, int heads, int n, int n_masks, bool masked, int group) {
  hop::Plan p{};
  const int nk = (n + 15) & ~15;
  p.n_kt = (nk + hop::MAX_KT - 1) / hop::MAX_KT;
  p.kt = ((nk + p.n_kt - 1) / p.n_kt + 15) & ~15;
  p.stage_bytes = (hop::Q_BYTES + 2 * p.kt * hop::ROW_BYTES + 511) & ~511;
  p.q_tiles = (n + hop::BM - 1) / hop::BM;
  p.n_groups = masked ? n_masks : 1;
  p.per_group = windows / p.n_groups;
  p.heads = heads;
  p.g = group < 1 ? 1 : group > p.per_group ? p.per_group : group;
  p.splits = (p.per_group + p.g - 1) / p.g;
  for (p.sliced = 0; p.sliced <= 1; ++p.sliced) {
    p.pitch = pitch_of(p.sliced ? p.kt : n);
    for (p.consumers = p.sliced ? 1 : hop::MAX_CONSUMERS; p.consumers >= 1; p.consumers /= 2)
      for (p.stages = 2; p.stages >= 1; --p.stages)
        if (smem_bytes(p) <= hop::SMEM_MAX) return p;
  }
  p.stages = 0;  // does not fit: refused by the caller
  return p;
}

// q, k or v of every (window, head): dims (head dim, then the head, token
// and window axes in the order of their strides, order[]), boxes of [rows
// tokens, 32] at (0, head, token, window) in that order, 64-byte swizzled
// (the layout wgmma reads, desc_sw64); tokens past N read as zeros
bool qkv_map(CUtensorMap* map, const void* ptr, const Args& g, int heads, int windows,
             const int order[3], int rows) {
  const int64_t st[3] = {g.s_h, g.s_n, g.s_w};
  const int64_t ext[3] = {heads, g.n, windows};
  const int64_t box[3] = {1, rows, 1};
  cuuint64_t dim[4] = {(cuuint64_t)D, 0, 0, 0}, stride[3];
  cuuint32_t b[4] = {(cuuint32_t)D, 1, 1, 1};
  for (int i = 0; i < 3; ++i) {
    const int a = order[i];
    dim[1 + i] = (cuuint64_t)ext[a];
    stride[i] = (cuuint64_t)st[a] * 2;
    b[1 + i] = (cuuint32_t)box[a];
  }
  return hopper::encode_bf16(map, ptr, 4, dim, stride, b, CU_TENSOR_MAP_SWIZZLE_64B);
}

template <bool COSINE>
cudaError_t launch_bf16(const Args& g, int windows, int heads, int group, cudaStream_t s) {
  hop::Plan p = plan_bf16(windows, heads, g.n, g.n_masks, g.mask != nullptr, group);
  if (!p.stages) return cudaErrorInvalidValue;
  // the three outer axes (0 head, 1 token, 2 window) by stride
  int order[3] = {0, 1, 2};
  const int64_t st[3] = {g.s_h, g.s_n, g.s_w};
  for (int i = 0; i < 3; ++i)
    for (int j = i + 1; j < 3; ++j)
      if (st[order[j]] < st[order[i]]) {
        const int x = order[i];
        order[i] = order[j];
        order[j] = x;
      }
  for (int i = 0; i < 3; ++i) {
    if (order[i] == 0) p.ax_h = i;
    if (order[i] == 1) p.ax_n = i;
    if (order[i] == 2) p.ax_w = i;
  }
  CUtensorMap tq, tk, tv;
  if (!qkv_map(&tq, g.q, g, heads, windows, order, hop::BM) ||
      !qkv_map(&tk, g.k, g, heads, windows, order, p.kt) ||
      !qkv_map(&tv, g.v, g, heads, windows, order, p.kt))
    return cudaErrorInvalidValue;
  // the kernel may take up to SMEM_MAX bytes of dynamic shared memory: set
  // once per device
  static std::atomic<bool> done[hopper::MAX_DEVICES];
  const int slot = hopper::device_slot();
  if (slot < 0 || !done[slot].load(std::memory_order_acquire)) {
    const cudaError_t e = cudaFuncSetAttribute(
        hop::attn_bf16<COSINE>, cudaFuncAttributeMaxDynamicSharedMemorySize, hop::SMEM_MAX);
    if (e != cudaSuccess) return e;
    if (slot >= 0) done[slot].store(true, std::memory_order_release);
  }
  const int64_t blocks = (int64_t)p.q_tiles * heads * p.n_groups * p.splits;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  hop::attn_bf16<COSINE><<<(unsigned)blocks, 128 * p.consumers, smem_bytes(p), s>>>(tq, tk, tv,
                                                                                  g, p);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 float32 (SIMT), 1 bfloat16 (Hopper: wgmma and TMA, one block per
// head, query tile and group of `group` windows that read one mask index);
// cosine: 1 cosine, 0 scaled. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments the kernels do not take.
extern "C" int k6_window_attn(int dtype, int cosine, const void* q, const void* k, const void* v,
                              int64_t s_w, int64_t s_h, int64_t s_n, void* out, int64_t o_w,
                              int64_t o_h, int64_t o_n, const float* bias, const float* mask,
                              int n_masks, const float* scales, int windows, int heads, int n,
                              int d, int group, void* stream) {
  if (n < MIN_N || d < 8 || d > 128 || d % 8 || windows < 1 || heads < 1 || heads > 65535 ||
      (mask && (n_masks < 1 || windows % n_masks)))
    return static_cast<int>(cudaErrorInvalidValue);
  Args g{q, k, v, s_w, s_h, s_n, out, o_w, o_h, o_n, bias, mask, mask ? n_masks : 1, scales, n};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1 && (!(aligned16(q) && aligned16(k) && aligned16(v) && aligned16(out) &&
                        aligned16(bias) && aligned16(mask)) ||
                      (s_w | s_h | s_n | o_w | o_h | o_n) % 8))
    return static_cast<int>(cudaErrorInvalidValue);
  if (wtile::mma::on_wgmma(dtype, d)) {
    err = cosine ? launch_bf16<true>(g, windows, heads, group, s)
                 : launch_bf16<false>(g, windows, heads, group, s);
  } else if (dtype == 1) {
    using namespace wtile::mma;
    const MArgs m{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                  static_cast<const bf16*>(v), s_w, s_h, s_n, static_cast<bf16*>(out), o_w,
                  o_h, o_n, bias, mask, g.n_masks, scales, 0.f, n, d};
    err = cosine ? launch<M_COSINE, float>(m, windows, heads, s)
                 : launch<M_SCALED, float>(m, windows, heads, s);
  } else if (dtype == 0) {
    err = launch_simt(cosine, g, windows, heads, d, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

// The warpgroups a bf16 block of a launch at n tokens runs (the windows of
// its group are dealt out to them), for the host's choice of the group
extern "C" int k6_consumers(int n) { return plan_bf16(1, 1, n, 1, false, 1).consumers; }

extern "C" const char* k6_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The Hopper body of the token-major window attention of Video Swin's
// large 3D windows (N <= 512 tokens, 392 for (8,7,7) windows; head dim 32),
// shared by K3 (window_attn3d.cu, serving) and K5's forward
// (window_attn3d_train.cu, training). For each (window w, head h):
//
//   out = softmax_rows(S + bias[h] + mask[w % n_masks]) . v
//
// in one of two forms, a template parameter:
//   STATIC_SHIFT (K3, the Pallas inference defaults mxu_bf16, no_max):
//     S = (q * bf16(scale), rounded to bf16) k^T; the weights
//     exp(min(x - 24, 60)), no row max, 1/rowsum deferred to the output.
//   MAX_STABLE (K5's forward, the Pallas training cast points no_max =
//     False): S = (q k^T) scale, the scale applied in f32 after the product;
//     the max-stabilised softmax exp(x - rowmax).
// Both: bf16 q, k, v; f32 bias; bf16 mask ({0, -100} are exact); bf16 x
// bf16 products with f32 accumulation; the weights rounded to bf16 for P V;
// the output rounded once to bf16.
//
// Design (PERF.md, K3 and K5 findings). The windows that read one mask
// (window w reads mask w % nW, and windows come batch-major, w = b nW + i)
// share one bias and one mask per head, and every window of an unmasked
// launch shares the bias. So a block takes (head h, a group of G windows
// that share a mask index i, query tile of 64 rows): it adds its [64, N]
// slice of bias[h] and of mask[i] once into an f32 tile in shared memory
// (rows of `pitch` floats, pitch = 8 mod 32, so the 8 rows a warp reads at
// once fall on distinct banks), in log2 units, and every window of the group
// reads it there. Adding the mask to the bias before the logit changes the
// association only where the mask is -100; there the weight is below
// exp(-94) < 1e-40 and adds nothing above f32 rounding. G comes from the
// host (one wave planner: choose_group in window_attn3d.cu for K3,
// window_group in ops/window_attn3d_train.py for K5). One producer warp
// streams each window's q tile [64, 32] and its whole K and V [N, 32] by
// TMA (3D tensor maps over the qkv column slices, 64-byte swizzle, keys past
// N zero-filled) through a ring of two stages (one where N > ~400 leaves no
// room) on full/empty mbarriers; every wait traps after 10 s (hopper.cuh),
// so a fault in the schedule is a failed launch, not a hang. Three consumer
// warpgroups split each window's keys in chunks of 64 (warpgroup c % 3
// takes chunk c): S by wgmma m64n64k16 with q from registers, the weights
// re-packed in registers as the bf16 A operand of P V (wgmma m64n32k16, V
// from shared memory).
//   STATIC_SHIFT: the tile holds (bias + mask) log2 e - 24 log2 e, so a
//     weight is one FMA, one min and one ex2.approx: exp(min(x - 24, 60)) as
//     2^min(s log2 e + b, 60 log2 e). No row max: one sweep, and the
//     warpgroups' partial outputs and row sums simply add.
//   MAX_STABLE: the tile holds (bias + mask) log2 e, so a logit in log2
//     units is one FMA, s (scale log2 e) + tile, and a weight 2^(x - m).
//     Each warpgroup keeps an online row max m over its chunks and rescales
//     its partial output and row sums by 2^(m_old - m) when m grows.
// Keys past N get weight 0. The other warpgroups hand their partial O, row
// sums (and, MAX_STABLE, row maxima) to the first through shared memory,
// which adds them (MAX_STABLE: each rescaled by 2^(m_c - m), m the largest),
// normalises and stores. K and V are read once per (window, head, query
// tile).

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <atomic>

#include "hopper.cuh"

namespace wtile {

using namespace hopper;
typedef __nv_bfloat16 bf16;

enum Form { STATIC_SHIFT = 0, MAX_STABLE = 1 };

constexpr int D = 32;                          // head dim
constexpr int MAX_N = 512;                     // tokens per window
constexpr int BM = 64;                         // query rows of a tile (one wgmma M)
constexpr int KCH = 64;                        // keys of a chunk (wgmma N of S)
constexpr int CONSUMERS = 3;                   // consumer warpgroups
constexpr int THREADS = 128 * CONSUMERS + 32;  // + one producer warp
constexpr int PRODUCER_WARP = 4 * CONSUMERS;
constexpr int ROW_BYTES = D * 2;               // a token's head slice: 64 bytes
constexpr int Q_BYTES = BM * ROW_BYTES;        // 4 KB
constexpr int SMEM_MAX = 232448;
constexpr float LOG2E = 1.4426950408889634f;

// floats a thread hands over: 16 of O, 2 row sums (and 2 row maxima)
template <int F>
__host__ __device__ constexpr int xchg_floats() { return F == MAX_STABLE ? 20 : 18; }

struct Args {
  const void* q; const void* k; const void* v;
  int64_t s_w, s_h, s_n;           // q/k/v element strides (head dim contiguous)
  void* out; int64_t o_w, o_h, o_n;
  const float* bias;               // [heads, n, n]
  const void* mask; int n_masks;   // [n_masks, n, n] bf16, or null
  float scale;
  int n;
};

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
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
// the static-shift weight exp(min(x - 24, 60)) of a logit x = s + (bias +
// mask), with the tile holding b = (bias + mask) log2 e - 24 log2 e:
// 2^min(s log2 e + b, 60 log2 e)
__device__ __forceinline__ float weight(float s, float b) {
  return ex2(fminf(fmaf(s, LOG2E, b), 60.f * LOG2E));
}

// The running softmax state of this thread's rows a and b: the partial
// output (accumulator element 4 j + 2 h + e is row a + 8 h), the row sums of
// this thread's keys and, MAX_STABLE, the rows' maxima in log2 units (the
// same in the 4 threads of a quad).
struct State {
  float o[16];
  float sum_a, sum_b;
  float m_a, m_b;
};

// One chunk of W keys from key kc on: S = q K^T, the weights against the
// bias tile (ta: this thread's row a at key 2 (lane % 4); row b = a + 8 is 8
// rows on), their row sums, and O += P V. The accumulator element
// 4 j + 2 h + e is row 16 warp + lane / 4 + 8 h, key kc + 8 j + 2 (lane % 4)
// + e; elements 4 j .. 4 j + 3 of steps j = 2 s, 2 s + 1 are the A fragment
// of P V's k step s, so P never leaves the registers. Keys from n on (the
// last chunk's, and the tile's pad) get weight 0. P V is left in flight: the
// next chunk's wait covers it. MAX_STABLE: a logit in log2 units is
// s xs + tile; with SPLIT (K6's cosine logits), S = (q_hi + q_lo) K^T and
// the factor is per key, xk[key] (this thread's key 2 (lane % 4) at xk).
template <int W, int F, bool SPLIT = false>
__device__ __forceinline__ void chunk(const uint32_t (&qa)[2][4], const uint32_t (&ql)[2][4],
                                      const uint8_t* ks, const uint8_t* vs, int kc,
                                      const float* ta, int pitch, int n, int t4, float xs,
                                      const float* xk, State& st) {
  float s[W / 2];
  wgmma_fence();
  WgmmaRS<W, 0>::mma(s, qa[0], desc_sw64(ks + kc * ROW_BYTES, 16), 0);
  WgmmaRS<W, 0>::mma(s, qa[1], desc_sw64(ks + kc * ROW_BYTES + 32, 16), 1);
  if constexpr (SPLIT) {
    WgmmaRS<W, 0>::mma(s, ql[0], desc_sw64(ks + kc * ROW_BYTES, 16), 1);
    WgmmaRS<W, 0>::mma(s, ql[1], desc_sw64(ks + kc * ROW_BYTES + 32, 16), 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
  uint32_t p[W / 16][4];
  const bool edge = kc + W > n;  // keys past N in this chunk: weight 0
  if constexpr (F == STATIC_SHIFT) {
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
      st.sum_a += e0 + e1;
      st.sum_b += e2 + e3;
      p[j >> 1][(j & 1) * 2] = pack_bf16(e0, e1);
      p[j >> 1][(j & 1) * 2 + 1] = pack_bf16(e2, e3);
    }
  } else {
    // the logits in log2 units and the chunk's row maxima
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int j = 0; j < W / 8; ++j) {
      const float2 ba = *reinterpret_cast<const float2*>(ta + kc + 8 * j);
      const float2 bb = *reinterpret_cast<const float2*>(ta + 8 * pitch + kc + 8 * j);
      float2 f = make_float2(xs, xs);
      if constexpr (SPLIT) f = *reinterpret_cast<const float2*>(xk + kc + 8 * j);
      s[4 * j] = fmaf(s[4 * j], f.x, ba.x);
      s[4 * j + 1] = fmaf(s[4 * j + 1], f.y, ba.y);
      s[4 * j + 2] = fmaf(s[4 * j + 2], f.x, bb.x);
      s[4 * j + 3] = fmaf(s[4 * j + 3], f.y, bb.y);
      if (edge) {
        const int key = kc + 8 * j + 2 * t4;
        if (key >= n) s[4 * j] = s[4 * j + 2] = -INFINITY;
        if (key + 1 >= n) s[4 * j + 1] = s[4 * j + 3] = -INFINITY;
      }
      mx_a = fmaxf(mx_a, fmaxf(s[4 * j], s[4 * j + 1]));
      mx_b = fmaxf(mx_b, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
    // the new maxima; what was summed under the old ones is rescaled (the
    // wait above covers the last chunk's P V, so O is complete here). A row
    // that has seen only -inf keeps base 0.
    fence_regs(st.o);
    const float mn_a = fmaxf(st.m_a, quad_max(mx_a)), mn_b = fmaxf(st.m_b, quad_max(mx_b));
    const float base_a = mn_a == -INFINITY ? 0.f : mn_a;
    const float base_b = mn_b == -INFINITY ? 0.f : mn_b;
    const float al_a = ex2(st.m_a - base_a), al_b = ex2(st.m_b - base_b);  // m = -inf: 0
    st.m_a = mn_a;
    st.m_b = mn_b;
    st.sum_a *= al_a;
    st.sum_b *= al_b;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      st.o[4 * j] *= al_a;
      st.o[4 * j + 1] *= al_a;
      st.o[4 * j + 2] *= al_b;
      st.o[4 * j + 3] *= al_b;
    }
#pragma unroll
    for (int j = 0; j < W / 8; ++j) {
      const float e0 = ex2(s[4 * j] - base_a), e1 = ex2(s[4 * j + 1] - base_a);
      const float e2 = ex2(s[4 * j + 2] - base_b), e3 = ex2(s[4 * j + 3] - base_b);
      st.sum_a += e0 + e1;
      st.sum_b += e2 + e3;
      p[j >> 1][(j & 1) * 2] = pack_bf16(e0, e1);
      p[j >> 1][(j & 1) * 2 + 1] = pack_bf16(e2, e3);
    }
  }
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < W / 16; ++k)
    WgmmaRS<32, 1>::mma(st.o, p[k], desc_sw64(vs + (kc + 16 * k) * ROW_BYTES, 512), 1);
  wgmma_commit();
}

// One block per (head, group of windows that share a mask index, query tile
// of 64 rows); see the note at the top. Needs q, k, v 16-byte aligned with
// strides that are multiples of 8 elements (the tensor maps), and out, bias
// and mask as the host checks.
template <int F>
__global__ void __launch_bounds__(THREADS, 1)
    attn_bf16(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
              const __grid_constant__ CUtensorMap tm_v, Args g, Plan p) {
  constexpr int XCHG = xchg_floats<F>();
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
  // (bias + mask) log2 e (- 24 log2 e, STATIC_SHIFT) (keys past N 0, never
  // weighted; rows past N are not filled: their outputs are not stored).
  // Each thread takes runs of 4 keys of a row (16 bytes of bias, 8 of mask,
  // where N % 4 == 0; a warp reads and writes 512 consecutive bytes of one
  // or two rows), FILL_U runs at once so that their loads are in flight
  // together.
  {
    constexpr int FILL_U = 4;
    constexpr float OFF = F == STATIC_SHIFT ? -24.f * LOG2E : 0.f;
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
        for (int c = 0; c < 4; ++c) v[i][c] = fmaf(v[i][c], LOG2E, OFF);
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
  // STATIC_SHIFT: q * scale in bf16, as the Pallas kernel's
  // `q * scale.astype(bf16)`; MAX_STABLE: the scale in the exponent
  const float sc = __bfloat162float(__float2bfloat16(g.scale));
  const float xs = g.scale * LOG2E;
  const int n_chunks = (p.nk + KCH - 1) / KCH;

  for (int it = 0; it < nw; ++it) {
    const int sl = it % p.stages;
    const uint8_t* stg = ring + sl * p.stage_bytes;
    const uint8_t* ks = stg + Q_BYTES;
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
        if constexpr (F == STATIC_SHIFT) {
          const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(stg + off);
          qa[ks16][e] = pack_bf16(__low2float(x) * sc, __high2float(x) * sc);
        } else {
          qa[ks16][e] = *reinterpret_cast<const uint32_t*>(stg + off);
        }
      }

    State st;
#pragma unroll
    for (int i = 0; i < 16; ++i) st.o[i] = 0.f;
    st.sum_a = st.sum_b = 0.f;
    st.m_a = st.m_b = -INFINITY;
    for (int c = wg; c < n_chunks; c += CONSUMERS) {
      const int kc = c * KCH;
      if (kc + KCH <= p.nk) {
        chunk<KCH, F>(qa, qa, ks, vs, kc, ta, p.pitch, N, t4, xs, nullptr, st);
      } else {
        for (int k16 = kc; k16 < p.nk; k16 += 16)
          chunk<16, F>(qa, qa, ks, vs, k16, ta, p.pitch, N, t4, xs, nullptr, st);
      }
    }
    wgmma_wait<0>();
    fence_regs(st.o);
    if (lane == 0) mbar_arrive(empty + sl);  // this warp is done with the stage

    // the other warpgroups hand their partial O, row sums (and maxima) to
    // the first (the same rows and columns in the same registers), which
    // adds them, normalises and stores; barrier 2: handed over, 3: taken
    if (wg > 0) {
      float* x = xchg + (wg - 1) * XCHG * 128 + t;
      if (it > 0) named_sync(3, 128 * CONSUMERS);
#pragma unroll
      for (int i = 0; i < 16; ++i) x[i * 128] = st.o[i];
      x[16 * 128] = st.sum_a;
      x[17 * 128] = st.sum_b;
      if constexpr (F == MAX_STABLE) {
        x[18 * 128] = st.m_a;
        x[19 * 128] = st.m_b;
      }
      named_arrive(2, 128 * CONSUMERS);
      continue;
    }
    named_sync(2, 128 * CONSUMERS);
    if constexpr (F == STATIC_SHIFT) {
#pragma unroll
      for (int c = 0; c < CONSUMERS - 1; ++c) {
        const float* x = xchg + c * XCHG * 128 + t;
#pragma unroll
        for (int i = 0; i < 16; ++i) st.o[i] += x[i * 128];
        st.sum_a += x[16 * 128];
        st.sum_b += x[17 * 128];
      }
    } else {
      // every part rescaled to the largest maximum m (a warpgroup without
      // keys holds -inf, 0: its factor is 0)
      float m_a = st.m_a, m_b = st.m_b;
#pragma unroll
      for (int c = 0; c < CONSUMERS - 1; ++c) {
        m_a = fmaxf(m_a, xchg[c * XCHG * 128 + t + 18 * 128]);
        m_b = fmaxf(m_b, xchg[c * XCHG * 128 + t + 19 * 128]);
      }
      const float f_a = ex2(st.m_a - m_a), f_b = ex2(st.m_b - m_b);
      st.sum_a *= f_a;
      st.sum_b *= f_b;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        st.o[4 * j] *= f_a;
        st.o[4 * j + 1] *= f_a;
        st.o[4 * j + 2] *= f_b;
        st.o[4 * j + 3] *= f_b;
      }
#pragma unroll
      for (int c = 0; c < CONSUMERS - 1; ++c) {
        const float* x = xchg + c * XCHG * 128 + t;
        const float ca = ex2(x[18 * 128] - m_a), cb = ex2(x[19 * 128] - m_b);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          st.o[4 * j] = fmaf(x[(4 * j) * 128], ca, st.o[4 * j]);
          st.o[4 * j + 1] = fmaf(x[(4 * j + 1) * 128], ca, st.o[4 * j + 1]);
          st.o[4 * j + 2] = fmaf(x[(4 * j + 2) * 128], cb, st.o[4 * j + 2]);
          st.o[4 * j + 3] = fmaf(x[(4 * j + 3) * 128], cb, st.o[4 * j + 3]);
        }
        st.sum_a = fmaf(x[16 * 128], ca, st.sum_a);
        st.sum_b = fmaf(x[17 * 128], cb, st.sum_b);
      }
    }
    if (it + 1 < nw) named_arrive(3, 128 * CONSUMERS);
    // a row's sum is spread over the 4 threads of its quad
    float sum_a = st.sum_a, sum_b = st.sum_b;
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
            __floats2bfloat162_rn(st.o[4 * j] * ra, st.o[4 * j + 1] * ra);
      if (row_b < N)
        *reinterpret_cast<__nv_bfloat162*>(O + (int64_t)row_b * g.o_n + c) =
            __floats2bfloat162_rn(st.o[4 * j + 2] * rb, st.o[4 * j + 3] * rb);
    }
  }
}

// ------------------------------------------------------------------ host

// the shared memory a plan needs: the slack to align the ring to the 512
// bytes of the swizzle's period, the ring, the bias tile, the hand-over and
// the barriers
template <int F>
int smem_bytes(const Plan& p) {
  return 512 + p.stages * p.stage_bytes + tile_bytes(p.pitch) +
         (CONSUMERS - 1) * xchg_floats<F>() * 128 * 4 + 2 * p.stages * 8;
}

// The schedule of a launch: windows w = i + b n_groups share mask i (every
// window shares the bias without a mask); a block takes `group` of them
// (at most per_group).
template <int F>
Plan plan(int windows, int heads, int n, int n_masks, bool masked, int group) {
  Plan p{};
  p.nk = (n + 15) & ~15;
  p.pitch = n + ((8 - n % 32) % 32 + 32) % 32;
  p.nbox = (p.nk + 255) / 256;
  p.kbox = ((p.nk + p.nbox - 1) / p.nbox + 7) & ~7;
  p.kv_bytes = (p.nbox * p.kbox * ROW_BYTES + 511) & ~511;
  p.stage_bytes = Q_BYTES + 2 * p.kv_bytes;
  p.stages = 2;
  if (smem_bytes<F>(p) > SMEM_MAX) p.stages = 1;
  p.q_tiles = (n + BM - 1) / BM;
  p.n_groups = masked ? n_masks : 1;
  p.per_group = windows / p.n_groups;
  p.heads = heads;
  p.g = group < 1 ? 1 : group > p.per_group ? p.per_group : group;
  p.splits = (p.per_group + p.g - 1) / p.g;
  return p;
}

// q, k or v of every window: dims (head columns, tokens, windows), boxes of
// [rows, 32] at (h s_h, token, window), 64-byte swizzled
inline bool qkv_map(CUtensorMap* map, const void* ptr, const Args& g, int heads, int windows,
                    int box_rows) {
  const cuuint64_t dim[3] = {(cuuint64_t)heads * g.s_h, (cuuint64_t)g.n, (cuuint64_t)windows};
  const cuuint64_t stride[2] = {(cuuint64_t)g.s_n * 2, (cuuint64_t)g.s_w * 2};
  const cuuint32_t box[3] = {(cuuint32_t)D, (cuuint32_t)box_rows, 1};
  return encode_bf16(map, ptr, 3, dim, stride, box, CU_TENSOR_MAP_SWIZZLE_64B);
}

// lets attn_bf16<F> take up to SMEM_MAX bytes of dynamic shared memory,
// once per device: a launch then sizes its own within that
template <int F>
cudaError_t allow_smem() {
  static std::atomic<bool> done[MAX_DEVICES];
  const int slot = device_slot();
  if (slot >= 0 && done[slot].load(std::memory_order_acquire)) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(attn_bf16<F>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (e == cudaSuccess && slot >= 0) done[slot].store(true, std::memory_order_release);
  return e;
}

// One launch; the caller has checked the shapes, the alignment and the
// strides (multiples of 8 elements)
template <int F>
cudaError_t launch(const Args& g, int windows, int heads, int group, cudaStream_t s) {
  const Plan p = plan<F>(windows, heads, g.n, g.n_masks, g.mask != nullptr, group);
  const int smem = smem_bytes<F>(p);
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  if (!qkv_map(&tq, g.q, g, heads, windows, BM) || !qkv_map(&tk, g.k, g, heads, windows, p.kbox) ||
      !qkv_map(&tv, g.v, g, heads, windows, p.kbox))
    return cudaErrorInvalidValue;
  const cudaError_t e = allow_smem<F>();
  if (e != cudaSuccess) return e;
  const int64_t blocks = (int64_t)p.q_tiles * heads * p.n_groups * p.splits;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  attn_bf16<F><<<(unsigned)blocks, THREADS, smem, s>>>(tq, tk, tv, g, p);
  return cudaGetLastError();
}

}  // namespace wtile

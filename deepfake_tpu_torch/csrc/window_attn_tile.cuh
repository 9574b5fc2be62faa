// The Hopper body of the token-major window attention of Video Swin's
// large 3D windows (any N: 392 tokens for (8,7,7) windows, 784 for (16,7,7);
// head dim 32; other head dims take the SIMT kernel at the end), shared by
// K3 (window_attn3d.cu, serving) and K5's forward
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
//
// Windows of more than WHOLE_N = 512 tokens (Video Swin-B's (16,7,7), N =
// 784) take attn_bf16_stream: at N = 784 whole K and V (100 KB) and the
// [64, N] f32 tile (207 KB) do not fit in shared memory together. It keeps
// the blocks, the warpgroups' chunks and the arithmetic, and streams each
// window as key tiles of 192 keys. Where N % 8 == 0 the producer also
// loads each key tile's f32 bias and bf16 mask slices by TMA into the
// stage (two stages of 100 KB), and a logit reads them there and adds them
// in f32: the same values as the whole tile, so the f32 route's parity is
// kept (a bf16 tile would round the bias). Otherwise (rows that are no
// 16-byte multiple) a four-stage ring holds K and V only and each
// warpgroup fills an f32 slice, [64, 64], for its own chunk just before the
// chunk (on the card 1.8x the TMA form's time at N = 784, PERF.md). The
// online state carries across key tiles as it does across chunks. The
// windows of a group no longer share the tile: each reads its slices from
// L2. The f32 SIMT parity kernel below (wtile::simt) takes any N by
// streaming K and V in tiles of 64 keys.

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
constexpr int WHOLE_N = 512;                   // windows held whole; longer ones stream
constexpr int SLICE_PITCH = 72;                // floats a row of a streamed launch's slice
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
  int stream;       // N > WHOLE_N: K and V in key tiles of kt keys, the bias by chunk
  int tma;          // streamed, N % 8 == 0: the bias and mask slices by TMA in the stage
  int kt, n_kt;     // keys a key tile, key tiles a window (1 when held whole)
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

// The bias (+ mask) tile as chunk reads it: this thread's rows a and b at
// keys 8 j + 2 (lane % 4) + {0, 1} of the chunk, in log2 units as the
// kernels below keep it. PitchTile: an f32 tile of `pitch` floats a row
// (ta: row a at the chunk's first key, + 2 (lane % 4)).
struct PitchTile {
  const float* ta;
  int pitch;
  __device__ __forceinline__ float2 a(int j) const {
    return *reinterpret_cast<const float2*>(ta + 8 * j);
  }
  __device__ __forceinline__ float2 b(int j) const {
    return *reinterpret_cast<const float2*>(ta + 8 * pitch + 8 * j);
  }
};

// TmaTile: a streamed stage's bias and mask as TMA wrote them, each row 128
// bytes of a box with the 128-byte swizzle (bias f32, boxes of 32 keys;
// mask bf16, boxes of 64 keys; 64 rows a box), read at row a = ra, keys c0
// + 8 j (c0: the chunk's first key in the stage, + 2 (lane % 4)) and turned
// into (bias + mask) log2 e + off
struct TmaTile {
  const uint8_t* bias;
  const uint8_t* mask;  // null without a mask
  int ra, c0;
  float off;
  __device__ __forceinline__ float2 at(int r, int j) const {
    const int c = c0 + 8 * j, cb = c & 31, cm = c & 63;
    const float2 b = *reinterpret_cast<const float2*>(
        bias + (c >> 5) * (BM * 128) + r * 128 + ((((cb >> 2) ^ r) & 7) << 4) + (cb & 3) * 4);
    float x = b.x, y = b.y;
    if (mask) {
      const __nv_bfloat162 m = *reinterpret_cast<const __nv_bfloat162*>(
          mask + (c >> 6) * (BM * 128) + sw128_offset(r, cm));
      x += __low2float(m);
      y += __high2float(m);
    }
    return make_float2(fmaf(x, LOG2E, off), fmaf(y, LOG2E, off));
  }
  __device__ __forceinline__ float2 a(int j) const { return at(ra, j); }
  __device__ __forceinline__ float2 b(int j) const { return at(ra + 8, j); }
};

// chunk for the streamed kernel: the same arithmetic, the bias (+ mask)
// read through a Tile at the chunk's first key (ks, vs and n count keys
// from the stage's first key, as kc does)
template <int W, int F, class Tile>
__device__ __forceinline__ void chunk_tile(const uint32_t (&qa)[2][4], const uint8_t* ks,
                                           const uint8_t* vs, int kc, const Tile& tile, int n,
                                           int t4, float xs, State& st) {
  float s[W / 2];
  wgmma_fence();
  WgmmaRS<W, 0>::mma(s, qa[0], desc_sw64(ks + kc * ROW_BYTES, 16), 0);
  WgmmaRS<W, 0>::mma(s, qa[1], desc_sw64(ks + kc * ROW_BYTES + 32, 16), 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
  uint32_t p[W / 16][4];
  const bool edge = kc + W > n;  // keys past N in this chunk: weight 0
  if constexpr (F == STATIC_SHIFT) {
#pragma unroll
    for (int j = 0; j < W / 8; ++j) {
      const float2 ba = tile.a(j), bb = tile.b(j);
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
      const float2 ba = tile.a(j), bb = tile.b(j);
      s[4 * j] = fmaf(s[4 * j], xs, ba.x);
      s[4 * j + 1] = fmaf(s[4 * j + 1], xs, ba.y);
      s[4 * j + 2] = fmaf(s[4 * j + 2], xs, bb.x);
      s[4 * j + 3] = fmaf(s[4 * j + 3], xs, bb.y);
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

// The first warpgroup adds the others' partial O and row sums (MAX_STABLE:
// each rescaled to the largest row maximum) from the hand-over buffer
template <int F, int XCHG>
__device__ __forceinline__ void combine(State& st, const float* xchg, int t) {
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
}

// Normalises the first warpgroup's rows a and b of window w, head h and
// stores them (rows past N are not stored)
__device__ __forceinline__ void store_rows(const State& st, const Args& g, int w, int h,
                                           int row_a, int row_b, int N, int t4) {
  // a row's sum is spread over the 4 threads of its quad
  float sum_a = st.sum_a, sum_b = st.sum_b;
  sum_a += __shfl_xor_sync(0xffffffffu, sum_a, 1);
  sum_a += __shfl_xor_sync(0xffffffffu, sum_a, 2);
  sum_b += __shfl_xor_sync(0xffffffffu, sum_b, 1);
  sum_b += __shfl_xor_sync(0xffffffffu, sum_b, 2);
  const float ra = 1.f / sum_a, rb = 1.f / sum_b;
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

// A streamed launch's bias (+ mask) slice of one chunk, as the tile above
// holds it but for the 64 keys from k0 only: row r (query q0 + r < N), key
// k0 + c at column c (keys past N 0, never weighted; rows past N not
// filled). The warpgroup's 128 threads fill it, 16-byte loads of the bias,
// 8-byte loads of the mask where N % 4 == 0.
template <int F>
__device__ __forceinline__ void fill_slice(float* slice, const float* bias, const bf16* mask,
                                           int q0, int k0, int N, int t) {
  constexpr float OFF = F == STATIC_SHIFT ? -24.f * LOG2E : 0.f;
  constexpr int RUNS = KCH / 4;  // runs of 4 keys a row
  const int rows = min(BM, N - q0);
  const bool vec = N % 4 == 0;
#pragma unroll
  for (int i = 0; i < BM * RUNS / 128; ++i) {
    const int u = t + 128 * i, rl = u / RUNS, c = 4 * (u % RUNS), k = k0 + c;
    if (rl >= rows) continue;
    const int64_t at = (int64_t)(q0 + rl) * N + k;
    float v[4];
    if (vec && k + 3 < N) {
      const float4 b = *reinterpret_cast<const float4*>(bias + at);
      v[0] = b.x; v[1] = b.y; v[2] = b.z; v[3] = b.w;
      if (mask) {
        const uint2 m = *reinterpret_cast<const uint2*>(mask + at);
        const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&m.x);
        const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&m.y);
        v[0] += __low2float(lo); v[1] += __high2float(lo);
        v[2] += __low2float(hi); v[3] += __high2float(hi);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[j] = k + j < N ? bias[at + j] + (mask ? __bfloat162float(mask[at + j]) : 0.f) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = fmaf(v[j], LOG2E, OFF);
    *reinterpret_cast<float4*>(slice + rl * SLICE_PITCH + c) = make_float4(v[0], v[1], v[2], v[3]);
  }
}

// attn_bf16 for windows of more than WHOLE_N tokens, whose K, V and [64, N]
// f32 tile do not fit in shared memory (N = 784: 100 KB of K and V, 207 KB
// of tile). The same blocks, warpgroups and arithmetic, but the producer
// streams each window as key tiles of kt = 192 keys (with the window's q
// tile) through a ring of four stages, and each warpgroup fills the bias +
// mask slice of its own chunk ([64, 64] f32, the same values in the same log2
// units as the whole tile) just before the chunk, in a slice of its own, so
// the warpgroups need no block-wide barrier. The running softmax state
// carries across a window's key tiles as it does across its chunks; the
// hand-over and the store follow the window's last key tile. The price: a
// group's windows no longer share the tile (each window reads its [64, N]
// slices of bias and mask from L2 once per query tile).
//
// TMA (N % 8 == 0, so that the bias and mask rows are 16-byte multiples):
// the producer also loads each key tile's bias [64, kt] (f32) and mask
// slices (bf16) into the stage, by TMA with the 128-byte swizzle (TmaTile),
// and the warpgroups read them there: no fill and no barrier on the
// consumers' path, the slices prefetched a stage ahead with K and V.
template <int F, bool TMA>
__global__ void __launch_bounds__(THREADS, 1)
    attn_bf16_stream(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_bias,
                     const __grid_constant__ CUtensorMap tm_mask, Args g, Plan p) {
  constexpr int XCHG = xchg_floats<F>();
  constexpr uintptr_t ALIGN = TMA ? 1023 : 511;  // the 128-byte swizzle's period is 1024
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + ALIGN) & ~ALIGN);
  float* slices = reinterpret_cast<float*>(ring + p.stages * p.stage_bytes);  // [3][64][72]
  float* xchg = slices + (TMA ? 0 : CONSUMERS * BM * SLICE_PITCH);
  uint64_t* full = reinterpret_cast<uint64_t*>(xchg + (CONSUMERS - 1) * XCHG * 128);
  uint64_t* empty = full + p.stages;

  const int N = g.n;
  const int qt = blockIdx.x % p.q_tiles, h = (blockIdx.x / p.q_tiles) % p.heads;
  const int grp = blockIdx.x / p.q_tiles / p.heads;
  const int mi = grp % p.n_groups, split = grp / p.n_groups;
  const int b0 = split * p.g, nw = min(p.g, p.per_group - b0);
  const int q0 = qt * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int items = nw * p.n_kt;  // (window, key tile), in that order

  if (threadIdx.x == 0) {
    for (int i = 0; i < p.stages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, 4 * CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == PRODUCER_WARP) {
    if (lane == 0) {
      const bool masked = g.mask != nullptr;
      const uint32_t tx = Q_BYTES + 2 * p.kt * ROW_BYTES +
                          (TMA ? BM * p.kt * (4 + (masked ? 2 : 0)) : 0);
      for (int s = 0; s < items; ++s) {
        const int sl = s % p.stages, it = s / p.n_kt, kt = s - it * p.n_kt;
        if (s >= p.stages) mbar_wait(empty + sl, ((s / p.stages) & 1) ^ 1);
        uint8_t* st = ring + sl * p.stage_bytes;
        const int w = mi + (b0 + it) * p.n_groups, x = h * (int)g.s_h;
        mbar_expect_tx(full + sl, tx);
        tma_load_3d(st, &tm_q, full + sl, x, q0, w);
        tma_load_3d(st + Q_BYTES, &tm_k, full + sl, x, kt * p.kt, w);
        tma_load_3d(st + Q_BYTES + p.kv_bytes, &tm_v, full + sl, x, kt * p.kt, w);
        if constexpr (TMA) {
          uint8_t* tb = st + Q_BYTES + 2 * p.kv_bytes;  // [kt / 32] boxes of [64][32] f32
          for (int b = 0; b < p.kt / 32; ++b)
            tma_load_3d(tb + b * BM * 128, &tm_bias, full + sl, kt * p.kt + 32 * b, q0, h);
          uint8_t* tm = tb + BM * p.kt * 4;  // [kt / 64] boxes of [64][64] bf16
          for (int b = 0; masked && b < p.kt / 64; ++b)
            tma_load_3d(tm + b * BM * 128, &tm_mask, full + sl, kt * p.kt + 64 * b, q0, mi);
        }
      }
    }
    return;
  }

  const int wg = threadIdx.x >> 7, t = threadIdx.x & 127;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int row_a = q0 + 16 * (warp & 3) + g8, row_b = row_a + 8;
  float* slice = slices + wg * BM * SLICE_PITCH;
  const float* ta = slice + (16 * (warp & 3) + g8) * SLICE_PITCH + 2 * t4;
  const float* bias = g.bias + (int64_t)h * N * N;
  const bf16* mask = g.mask ? static_cast<const bf16*>(g.mask) + (int64_t)mi * N * N : nullptr;
  const float sc = __bfloat162float(__float2bfloat16(g.scale));
  const float xs = g.scale * LOG2E;

  uint32_t qa[2][4];
  State st;
  for (int s = 0; s < items; ++s) {
    const int sl = s % p.stages, it = s / p.n_kt, kt = s - it * p.n_kt;
    const uint8_t* stg = ring + sl * p.stage_bytes;
    const uint8_t* ks = stg + Q_BYTES;
    const uint8_t* vs = ks + p.kv_bytes;
    mbar_wait(full + sl, (s / p.stages) & 1);

    if (kt == 0) {  // a new window: its q fragments (as attn_bf16) and a fresh state
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
#pragma unroll
      for (int i = 0; i < 16; ++i) st.o[i] = 0.f;
      st.sum_a = st.sum_b = 0.f;
      st.m_a = st.m_b = -INFINITY;
    }

    // this key tile's chunks c = wg, wg + 3, ... (kt is a multiple of 3
    // chunks, so a warpgroup takes the same chunks of every window as in
    // attn_bf16); keys counted from the tile's first, k0
    const int k0 = kt * p.kt, len = min(p.kt, p.nk - k0), nv = N - k0;
    if constexpr (TMA) {
      const uint8_t* tb = stg + Q_BYTES + 2 * p.kv_bytes;
      const uint8_t* tm = mask ? tb + BM * p.kt * 4 : nullptr;
      const int ra = 16 * (warp & 3) + g8;
      constexpr float OFF = F == STATIC_SHIFT ? -24.f * LOG2E : 0.f;
      for (int kc = wg * KCH; kc < len; kc += CONSUMERS * KCH) {
        if (kc + KCH <= len) {
          chunk_tile<KCH, F>(qa, ks, vs, kc, TmaTile{tb, tm, ra, kc + 2 * t4, OFF}, nv, t4, xs,
                             st);
        } else {
          for (int k16 = kc; k16 < len; k16 += 16)
            chunk_tile<16, F>(qa, ks, vs, k16, TmaTile{tb, tm, ra, k16 + 2 * t4, OFF}, nv, t4,
                              xs, st);
        }
      }
    }
    for (int kc = wg * KCH; !TMA && kc < len; kc += CONSUMERS * KCH) {
      fill_slice<F>(slice, bias, mask, q0, k0 + kc, N, t);
      named_sync(4 + wg, 128);  // the slice is filled
      if (kc + KCH <= len) {
        chunk_tile<KCH, F>(qa, ks, vs, kc, PitchTile{ta, SLICE_PITCH}, nv, t4, xs, st);
      } else {
        for (int k16 = kc; k16 < len; k16 += 16)
          chunk_tile<16, F>(qa, ks, vs, k16, PitchTile{ta + (k16 - kc), SLICE_PITCH}, nv, t4, xs,
                            st);
      }
      named_sync(4 + wg, 128);  // every thread has read the slice
    }
    wgmma_wait<0>();
    fence_regs(st.o);
    if (lane == 0) mbar_arrive(empty + sl);  // this warp is done with the stage
    if (kt + 1 < p.n_kt) continue;

    // the window's last key tile: hand over, add, normalise and store, as
    // attn_bf16
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
    combine<F, XCHG>(st, xchg, t);
    if (it + 1 < nw) named_arrive(3, 128 * CONSUMERS);
    store_rows(st, g, mi + (b0 + it) * p.n_groups, h, row_a, row_b, N, t4);
  }
}

// ------------------------------------------------------------- SIMT

// The f32 parity kernel of K3 (STATIC_SHIFT, f32 mask) and of K5's forward
// (MAX_STABLE, bf16 mask), at every head dim of 1 to 128; a different kernel
// from the ones that serve and train (the wgmma kernels above at D = 32,
// window_attn_mma.cuh's at other head dims). One block of 8 warps per
// (query tile of 32 rows, window, head), SIMT f32 FMA, any N: K
// and V come in tiles of 64 keys through shared memory beside the tile's
// [32, 64] logits; a head is held as DC = 1, 2 or 4 column groups of 32
// (instances 32, 64, 128), the columns from D on zero-filled, so they change
// neither q.k nor the kept columns of P V; warp w keeps the softmax state and
// O[r][lane + 32 u] of rows r = w + 8 i, so STATIC_SHIFT sums its weights and
// MAX_STABLE keeps an online row max, rescaling its sum and O when it grows.
// Logits (q scale) k + bias + mask, then exp(min(x - 24, 60)) or
// exp(x - max); O / rowsum at the end.
namespace simt {

constexpr int MQ = 32, KT = 64, THREADS = 256;

template <int DC>
__host__ __device__ constexpr size_t smem_bytes() {
  return sizeof(float) * (MQ * (32 * DC + 1) + 2 * KT * (32 * DC + 1) + MQ * (KT + 1));
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
__device__ __forceinline__ float to_f32(float m) { return m; }
__device__ __forceinline__ float to_f32(bf16 m) { return __bfloat162float(m); }

template <int F, typename MaskT, int DC>
__global__ void __launch_bounds__(THREADS) attn_simt(Args g, int d) {
  constexpr int DW = 32 * DC, DP = DW + 1;  // +1 pads off bank conflicts
  extern __shared__ float sm[];
  const int N = g.n;
  float* qs = sm;             // [MQ][DP] q * scale
  float* ks = qs + MQ * DP;   // [KT][DP]
  float* vs = ks + KT * DP;   // [KT][DP]
  float* ps = vs + KT * DP;   // [MQ][KT + 1] logits, then weights

  const int q0 = blockIdx.x * MQ, w = blockIdx.y, h = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rows = min(MQ, N - q0);
  const int64_t base = (int64_t)w * g.s_w + (int64_t)h * g.s_h;
  const float* Q = static_cast<const float*>(g.q) + base;
  const float* K = static_cast<const float*>(g.k) + base;
  const float* V = static_cast<const float*>(g.v) + base;
  for (int idx = tid; idx < MQ * DW; idx += THREADS) {
    const int i = idx / DW, c = idx % DW;
    qs[i * DP + c] = i < rows && c < d ? Q[(int64_t)(q0 + i) * g.s_n + c] * g.scale : 0.f;
  }
  const float* bias = g.bias + (int64_t)h * N * N;
  const MaskT* mask =
      g.mask ? static_cast<const MaskT*>(g.mask) + (int64_t)(w % g.n_masks) * N * N : nullptr;

  // rows warp + 8 i: O[.][lane + 32 u], max, sum
  float o[MQ / 8][DC], m[MQ / 8], l[MQ / 8];
#pragma unroll
  for (int i = 0; i < MQ / 8; ++i) {
    l[i] = 0.f;
    m[i] = -INFINITY;
#pragma unroll
    for (int u = 0; u < DC; ++u) o[i][u] = 0.f;
  }
  for (int k0 = 0; k0 < N; k0 += KT) {
    const int kn = min(KT, N - k0);
    __syncthreads();  // the last tile's reads are done (and q is in place)
    for (int idx = tid; idx < kn * DW; idx += THREADS) {
      const int j = idx / DW, c = idx % DW;
      const int64_t off = (int64_t)(k0 + j) * g.s_n + c;
      ks[j * DP + c] = c < d ? K[off] : 0.f;
      vs[j * DP + c] = c < d ? V[off] : 0.f;
    }
    __syncthreads();
    for (int idx = tid; idx < rows * kn; idx += THREADS) {
      const int i = idx / kn, j = idx - i * kn;
      const float* qi = qs + i * DP;
      const float* kj = ks + j * DP;
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < DW; ++c) s = fmaf(qi[c], kj[c], s);
      const int64_t at = (int64_t)(q0 + i) * N + k0 + j;
      ps[i * (KT + 1) + j] = (s + bias[at]) + (mask ? to_f32(mask[at]) : 0.f);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < MQ / 8; ++i) {
      const int r = warp + 8 * i;
      if (r >= rows) break;
      float* p = ps + r * (KT + 1);
      float sum = 0.f;
      if constexpr (F == STATIC_SHIFT) {
        for (int j = lane; j < kn; j += 32) {
          const float e = expf(fminf(p[j] - 24.f, 60.f));
          p[j] = e;
          sum += e;
        }
        l[i] += warp_sum(sum);
      } else {
        float mx = -INFINITY;
        for (int j = lane; j < kn; j += 32) mx = fmaxf(mx, p[j]);
        const float mn = fmaxf(m[i], warp_max(mx)), alpha = expf(m[i] - mn);  // m = -inf: 0
        for (int j = lane; j < kn; j += 32) {
          const float e = expf(p[j] - mn);
          p[j] = e;
          sum += e;
        }
        l[i] = fmaf(l[i], alpha, warp_sum(sum));
#pragma unroll
        for (int u = 0; u < DC; ++u) o[i][u] *= alpha;
        m[i] = mn;
      }
      __syncwarp();
#pragma unroll
      for (int u = 0; u < DC; ++u) {
        float acc = 0.f;
        for (int j = 0; j < kn; ++j) acc = fmaf(p[j], vs[j * DP + lane + 32 * u], acc);
        o[i][u] += acc;
      }
    }
  }
  float* O = static_cast<float*>(g.out) + (int64_t)w * g.o_w + (int64_t)h * g.o_h;
#pragma unroll
  for (int i = 0; i < MQ / 8; ++i) {
    const int r = warp + 8 * i;
    if (r >= rows) continue;
#pragma unroll
    for (int u = 0; u < DC; ++u)
      if (lane + 32 * u < d) O[(int64_t)(q0 + r) * g.o_n + lane + 32 * u] = o[i][u] * (1.f / l[i]);
  }
}

template <int F, typename MaskT, int DC>
cudaError_t launch_dc(const Args& g, int windows, int heads, int d, cudaStream_t s) {
  constexpr size_t smem = smem_bytes<DC>();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        attn_simt<F, MaskT, DC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  attn_simt<F, MaskT, DC><<<dim3((g.n + MQ - 1) / MQ, windows, heads), THREADS, smem, s>>>(g, d);
  return cudaGetLastError();
}

// One launch at head dim d (1 to 128; the instance of d's column groups, 1,
// 2 or 4); the caller has checked the shapes
template <int F, typename MaskT>
cudaError_t launch(const Args& g, int windows, int heads, int d, cudaStream_t s) {
  if (d <= 32) return launch_dc<F, MaskT, 1>(g, windows, heads, d, s);
  if (d <= 64) return launch_dc<F, MaskT, 2>(g, windows, heads, d, s);
  if (d <= 128) return launch_dc<F, MaskT, 4>(g, windows, heads, d, s);
  return cudaErrorInvalidValue;
}

}  // namespace simt

// ------------------------------------------------------------------ host

// the shared memory a plan needs: the slack to align the ring to the 512
// bytes of the swizzle's period, the ring, the bias tile, the hand-over and
// the barriers
template <int F>
int smem_bytes(const Plan& p) {
  const int tile = p.tma ? 0 : p.stream ? CONSUMERS * BM * SLICE_PITCH * 4 : tile_bytes(p.pitch);
  return (p.tma ? 1024 : 512) + p.stages * p.stage_bytes + tile +
         (CONSUMERS - 1) * xchg_floats<F>() * 128 * 4 + 2 * p.stages * 8;
}

// The schedule of a launch: windows w = i + b n_groups share mask i (every
// window shares the bias without a mask); a block takes `group` of them
// (at most per_group). A window of more than WHOLE_N tokens streams
// (attn_bf16_stream): key tiles of three chunks, four stages; two, with
// the bias and mask slices in them, where N % 8 == 0 (TMA).
template <int F>
Plan plan(int windows, int heads, int n, int n_masks, bool masked, int group) {
  Plan p{};
  p.nk = (n + 15) & ~15;
  p.pitch = n + ((8 - n % 32) % 32 + 32) % 32;
  p.stream = n > WHOLE_N;
  if (p.stream) {
    p.kt = CONSUMERS * KCH;
    p.n_kt = (p.nk + p.kt - 1) / p.kt;
    p.nbox = 1;
    p.kbox = p.kt;
    p.kv_bytes = p.kt * ROW_BYTES;  // 12 KB, a multiple of the swizzle's 512
    p.tma = n % 8 == 0;
    // + the bias [64, kt] f32 and mask bf16: 100 KB a stage, a multiple of 1024
    p.stage_bytes = Q_BYTES + 2 * p.kv_bytes + (p.tma ? BM * p.kt * 6 : 0);
    p.stages = p.tma ? 2 : 4;
  } else {
    p.kt = p.nk;
    p.n_kt = 1;
    p.nbox = (p.nk + 255) / 256;
    p.kbox = ((p.nk + p.nbox - 1) / p.nbox + 7) & ~7;
    p.kv_bytes = (p.nbox * p.kbox * ROW_BYTES + 511) & ~511;
    p.stage_bytes = Q_BYTES + 2 * p.kv_bytes;
    p.stages = 2;
    if (smem_bytes<F>(p) > SMEM_MAX) p.stages = 1;
  }
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
// once per device: a launch then sizes its own within that. Static: each
// library that includes this header keeps its own flags (an inline
// function's static would be one object across the process's libraries,
// and a second library's kernels would go without the attribute)
template <int F, int MODE>  // 0: attn_bf16, 1: attn_bf16_stream, 2: its TMA form
static cudaError_t allow_smem() {
  static std::atomic<bool> done[MAX_DEVICES];
  const int slot = device_slot();
  if (slot >= 0 && done[slot].load(std::memory_order_acquire)) return cudaSuccess;
  const cudaError_t e =
      MODE == 0 ? cudaFuncSetAttribute(attn_bf16<F>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       SMEM_MAX)
                : cudaFuncSetAttribute(attn_bf16_stream<F, MODE == 2>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
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
  CUtensorMap tq, tk, tv, tb, tm;
  if (!qkv_map(&tq, g.q, g, heads, windows, BM) || !qkv_map(&tk, g.k, g, heads, windows, p.kbox) ||
      !qkv_map(&tv, g.v, g, heads, windows, p.kbox))
    return cudaErrorInvalidValue;
  tb = tm = tq;  // stand-ins where the kernel reads no bias or mask map
  if (p.tma) {
    // bias [heads, N, N] f32 in boxes of [64 rows, 32 keys], mask [n_masks,
    // N, N] bf16 in boxes of [64, 64], both 128-byte swizzled
    const cuuint64_t n = g.n, bdim[3] = {n, n, (cuuint64_t)heads},
                     mdim[3] = {n, n, (cuuint64_t)g.n_masks};
    const cuuint64_t bstride[2] = {n * 4, n * n * 4}, mstride[2] = {n * 2, n * n * 2};
    const cuuint32_t bbox[3] = {32, BM, 1}, mbox[3] = {64, BM, 1};
    if (!encode(&tb, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, g.bias, 3, bdim, bstride, bbox,
                CU_TENSOR_MAP_SWIZZLE_128B) ||
        (g.mask && !encode_bf16(&tm, g.mask, 3, mdim, mstride, mbox, CU_TENSOR_MAP_SWIZZLE_128B)))
      return cudaErrorInvalidValue;
  }
  const cudaError_t e = p.tma      ? allow_smem<F, 2>()
                        : p.stream ? allow_smem<F, 1>()
                                   : allow_smem<F, 0>();
  if (e != cudaSuccess) return e;
  const int64_t blocks = (int64_t)p.q_tiles * heads * p.n_groups * p.splits;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  if (p.tma)
    attn_bf16_stream<F, true><<<(unsigned)blocks, THREADS, smem, s>>>(tq, tk, tv, tb, tm, g, p);
  else if (p.stream)
    attn_bf16_stream<F, false><<<(unsigned)blocks, THREADS, smem, s>>>(tq, tk, tv, tb, tm, g, p);
  else
    attn_bf16<F><<<(unsigned)blocks, THREADS, smem, s>>>(tq, tk, tv, g, p);
  return cudaGetLastError();
}

}  // namespace wtile

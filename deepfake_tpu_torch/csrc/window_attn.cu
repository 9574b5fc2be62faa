// K2: cosine (or scaled) window attention for windows of up to 64 tokens
// and heads up to 128 wide.
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
// For each (window w, head h): L2-normalise the rows of q and k (x *
// rsqrt(max(|x|^2, 1e-24)), pallas_window_attn.py:34-35) and scale the
// logits by the head's logit_scale, or (cosine = 0) scale the logits by a
// scalar; add bias[h] and mask[w % n_masks]; max-stabilised f32 softmax;
// PV; store in the input type.
//
// What bounds it on the H100: memory. A launch reads q, k, v and writes out
// once, and reads the f32 bias [H, N, N] and mask [nW, N, N] once; it does
// ~4 B_ H N^2 D flops (~12 per byte at N = 49, D = 32), far under the
// card's ridge. A fused b8 request's 24 launches need ~0.06 ms by bytes.
//
// Routes:
//   - bf16 (serving), Hopper. One block (one warpgroup) per (head, group of
//     windows that read one mask index): window w reads mask w % nW and
//     windows come batch-major, so windows i + b nW share bias[h] and
//     mask[i]; an unmasked launch groups G consecutive windows. G is chosen
//     on the host (ops/window_attn_kernel.py::window_group). The block adds
//     bias[h] and mask[i] once into an f32 [64, 64] tile in shared memory,
//     in log2 units (keys past N hold -inf, so padded keys get no weight),
//     and every window of the group reads it there. A window's 49 rows are
//     padded to one 64-row wgmma tile. q, k and v come by TMA (a 4D map per
//     tensor over (head dim, and the head, token and window axes in stride
//     order), box [64 tokens, D]: tokens past N are zero-filled) through a
//     ring of two stages, the next window's loads in flight while this one
//     computes; where D or a stride is not a multiple of 8 elements (no
//     tensor map), the threads load them instead. The threads normalise q
//     and k in f32 and split q^ and k^ into bf16 hi + lo parts: cosine
//     logits reach |scale| = 100, where rounding q^ and k^ to bf16 alone
//     would move a weight by several percent, so q^.k^ = hi.hi + hi.lo +
//     lo.hi (K6's split, ~2^-16 relative). k^ (hi, lo) and V^T go into
//     128-byte-swizzled K-major tiles, q^ into registers as wgmma's A;
//     S = q^ k^T is three wgmma m64n64k16 products per 16 channels (one for
//     scaled logits, which take the bf16 q and k as they are and scale
//     after), f32 accumulation. D is padded to a multiple of 16 with zeros;
//     heads of more than 64 channels take the instance with two 64-column
//     operands of k^ and V^T (S in up to 8 k steps, O as two m64n64
//     products).
//     The softmax is max-stabilised in f32 with ex2, the logit scale folded
//     into the exponent: 2^(s scale log2 e + (bias + mask) log2 e - m). The
//     weights, rounded to bf16, are wgmma's A for P V (m64n64k16, V^T from
//     shared memory); the output is divided by the row sum in f32 and
//     rounded once to bf16 at the store.
//   - f32 (the parity route only; a different kernel from the one that
//     serves): one block per (window, head); q, k, v as f32 in padded
//     shared memory, SIMT dot products for the logits (the [N, N] logits
//     held in shared memory, 9.8 KB at N = 49) and for PV, expf softmax.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <atomic>

#include "hopper.cuh"

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


// ------------------------------------------------------ bf16: Hopper

namespace hop {

using namespace hopper;
typedef __nv_bfloat16 bf16;

constexpr int THREADS = 128;          // one warpgroup
constexpr int BM = 64;                // a window's rows (one wgmma M) and keys (one wgmma N)
constexpr int OPND = BM * 128;        // a [64, 64] bf16 operand, 128-byte swizzled: 8 KB
constexpr int TP = BM + 8;            // f32 tile pitch: the 8 rows a warp reads fall on distinct banks
constexpr int STAGES = 2;
constexpr float LOG2E = 1.4426950408889634f;

// what the host decides for a launch
struct Plan {
  int g;           // windows a block takes (G)
  int n_groups;    // mask indices (1 without a mask)
  int per_group;   // windows that read one mask index
  int heads;
  int tma;         // q, k, v by TMA (else by the threads)
  int land;        // bytes of one landed [64, D] operand, a multiple of 128
  int ax_h, ax_w;  // the tensor maps' dims 1-3 that are the head and window axes
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float ld_bf(const uint8_t* tile, int i) {
  return __bfloat162float(reinterpret_cast<const bf16*>(tile)[i]);
}
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// One block per (head, group of windows that read one mask index); see the
// note at the top. Block x = h + heads (mask index + n_groups split): the
// heads of a group run together, so a mask slice is read from device memory
// once for all of them.
// DT: the head's 64-column tiles, 1 (D <= 64) or 2 (D <= 128); k^ (hi, lo)
// and V^T take DT swizzled operands each, S DT x 4 k steps, O DT products
template <int DT>
__global__ void __launch_bounds__(THREADS)
    attn_bf16(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
              const __grid_constant__ CUtensorMap tm_v, Args g, Plan p) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* khi = base;                  // k^ hi [key][channel], DT swizzled operands
  uint8_t* klo = base + DT * OPND;      // k^ lo
  uint8_t* vt = base + 2 * DT * OPND;   // V^T [channel][key], DT swizzled operands
  float* tile = reinterpret_cast<float*>(base + 3 * DT * OPND);  // [64][TP], log2 units
  uint8_t* land = reinterpret_cast<uint8_t*>(tile + BM * TP);  // STAGES x [q | k | v] [64][D]
  uint64_t* full = reinterpret_cast<uint64_t*>(land + STAGES * 3 * p.land);

  const int N = g.n, D = g.d;
  const int h = blockIdx.x % p.heads, grp = blockIdx.x / p.heads;
  const int mi = grp % p.n_groups, b0 = (grp / p.n_groups) * p.g;
  const int nw = min(p.g, p.per_group - b0);  // windows mi + (b0 + it) n_groups
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31, g8 = lane >> 2, t4 = lane & 3;

  // one window's q, k and v into a stage: TMA boxes [64 tokens, D]
  auto issue = [&](int it) {
    const int sl = it % STAGES, w = mi + (b0 + it) * p.n_groups;
    int c[4] = {0, 0, 0, 0};
    c[1 + p.ax_h] = h;
    c[1 + p.ax_w] = w;
    uint8_t* st = land + sl * 3 * p.land;
    mbar_expect_tx(full + sl, 3 * BM * D * 2);
    tma_load_4d(st, &tm_q, full + sl, c[0], c[1], c[2], c[3]);
    tma_load_4d(st + p.land, &tm_k, full + sl, c[0], c[1], c[2], c[3]);
    tma_load_4d(st + 2 * p.land, &tm_v, full + sl, c[0], c[1], c[2], c[3]);
  };

  if (t == 0) {
    for (int i = 0; i < STAGES; ++i) mbar_init(full + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // channels past D of k^ and rows past D of V^T are never written below:
  // zero them once (k^'s feed the products as zeros; V^T's give output
  // columns that are not stored)
  for (int i = t; i < 3 * DT * OPND / 16; i += THREADS)
    reinterpret_cast<uint4*>(base)[i] = make_uint4(0, 0, 0, 0);
  fence_async_smem();
  __syncthreads();
  if (p.tma && t == 0)
    for (int it = 0; it < min(STAGES, nw); ++it) issue(it);

  // the bias + mask tile: row r, key j < N holds (bias + mask) log2 e (0 in
  // rows past N, whose outputs are not stored); keys past N hold -inf. A
  // thread's FILL loads are issued before any is used, so their latencies
  // overlap.
  {
    constexpr int FILL = 8;
    const float* bias = g.bias + (int64_t)h * N * N;
    const float* mask = g.mask ? g.mask + (int64_t)mi * N * N : nullptr;
    for (int i0 = t; i0 < BM * BM; i0 += FILL * THREADS) {
      float b[FILL], m[FILL];
#pragma unroll
      for (int u = 0; u < FILL; ++u) {
        const int i = i0 + u * THREADS, r = i >> 6, j = i & 63;
        const bool in = r < N && j < N;
        b[u] = in ? bias[r * N + j] : 0.f;
        m[u] = in && mask ? mask[r * N + j] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < FILL; ++u) {
        const int i = i0 + u * THREADS, r = i >> 6, j = i & 63;
        tile[r * TP + j] = j < N ? (b[u] + m[u]) * LOG2E : __int_as_float(0xff800000);  // -inf
      }
    }
  }
  __syncthreads();

  const float lsc = g.scales[h] * LOG2E;  // the logit scale, folded into the exponent
  const int nks = (D + 15) >> 4;          // 16-channel steps of S
  const int row = t >> 1, half = t & 1;   // the row (token) this thread normalises and copies
  const int hd = (D + 1) >> 1, c_lo = half ? hd : 0, c_hi = half ? D : hd;
  const int ra = 16 * warp + g8, rb = ra + 8;  // this thread's accumulator rows
  const float* ta = tile + ra * TP + 2 * t4;

  for (int it = 0; it < nw; ++it) {
    const int sl = it % STAGES;
    const uint8_t* lq = land + sl * 3 * p.land;
    const uint8_t* lk = lq + p.land;
    const uint8_t* lv = lk + p.land;
    const int w = mi + (b0 + it) * p.n_groups;
    if (p.tma) {
      mbar_wait(full + sl, (it / STAGES) & 1);
    } else {
      const int64_t wb = (int64_t)w * g.s_w + (int64_t)h * g.s_h;
      for (int i = t; i < 3 * BM * D; i += THREADS) {
        const int which = i / (BM * D), e = i - which * BM * D, r = e / D, c = e - r * D;
        const bf16* src = static_cast<const bf16*>(which == 0 ? g.q : which == 1 ? g.k : g.v);
        reinterpret_cast<bf16*>(land + sl * 3 * p.land + which * p.land)[e] =
            r < N ? src[wb + (int64_t)r * g.s_n + c] : __float2bfloat16(0.f);
      }
      named_sync(1, THREADS);
    }

    // the row norms of q and k (a row's two threads are lanes 2 r' and
    // 2 r' + 1 of the warp whose accumulator rows hold r')
    float iq = 1.f, ik = 1.f;
    if (g.cosine) {
      float sq = 0.f, sk = 0.f;
      for (int c = c_lo; c < c_hi; ++c) {
        const float a = ld_bf(lq, row * D + c), b = ld_bf(lk, row * D + c);
        sq = fmaf(a, a, sq);
        sk = fmaf(b, b, sk);
      }
      sq += __shfl_xor_sync(0xffffffffu, sq, 1);
      sk += __shfl_xor_sync(0xffffffffu, sk, 1);
      iq = rsqrtf(fmaxf(sq, 1e-24f));
      ik = rsqrtf(fmaxf(sk, 1e-24f));
    }
    // q^ as wgmma's A, hi and lo, for each 16-channel step: rows ra, rb;
    // channels 16 ks + 8 (e >> 1) + 2 t4 + {0, 1}
    const float ia = __shfl_sync(0xffffffffu, iq, (2 * g8) & 31);
    const float ib = __shfl_sync(0xffffffffu, iq, (2 * g8 + 16) & 31);
    uint32_t qh[4 * DT][4], ql[4 * DT][4];
#pragma unroll
    for (int ks = 0; ks < 4 * DT; ++ks)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = (e & 1) ? rb : ra, c = 16 * ks + 8 * (e >> 1) + 2 * t4;
        const float sc = (e & 1) ? ib : ia;
        const float x0 = c < D ? ld_bf(lq, r * D + c) * sc : 0.f;
        const float x1 = c + 1 < D ? ld_bf(lq, r * D + c + 1) * sc : 0.f;
        const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
        qh[ks][e] = *reinterpret_cast<const uint32_t*>(&hi);
        ql[ks][e] = pack_bf16(x0 - __low2float(hi), x1 - __high2float(hi));
      }
    // the previous window's products are done with k^ and V^T
    named_sync(1, THREADS);
    for (int c = c_lo; c < c_hi; ++c) {
      const float x = ld_bf(lk, row * D + c) * ik;
      const bf16 hi = __float2bfloat16(x);
      const int op = (c >> 6) * OPND, cc = c & 63;  // channel c's operand and its column
      *reinterpret_cast<bf16*>(khi + op + sw128_offset(row, cc)) = hi;
      if (g.cosine)
        *reinterpret_cast<bf16*>(klo + op + sw128_offset(row, cc)) =
            __float2bfloat16(x - __bfloat162float(hi));
      *reinterpret_cast<bf16*>(vt + op + sw128_offset(cc, row)) =
          reinterpret_cast<const bf16*>(lv)[row * D + c];
    }
    fence_async_smem();  // the tiles are read by wgmma next
    named_sync(1, THREADS);  // ... and this stage's landed rows are read
    if (p.tma && t == 0 && it + STAGES < nw) issue(it + STAGES);

    // S = q^ k^T (hi.hi + hi.lo + lo.hi), f32
    float s[32];
    wgmma_fence();
    // 16-channel step ks reads operand ks / 4 at byte 32 (ks % 4) of its rows
#pragma unroll
    for (int ks = 0; ks < 4 * DT; ++ks)
      if (ks < nks)
        WgmmaRS<64, 0>::mma(s, qh[ks], desc_sw128(khi + (ks >> 2) * OPND + 32 * (ks & 3)),
                            ks > 0);
    if (g.cosine) {
#pragma unroll
      for (int ks = 0; ks < 4 * DT; ++ks)
        if (ks < nks)
          WgmmaRS<64, 0>::mma(s, qh[ks], desc_sw128(klo + (ks >> 2) * OPND + 32 * (ks & 3)), 1);
#pragma unroll
      for (int ks = 0; ks < 4 * DT; ++ks)
        if (ks < nks)
          WgmmaRS<64, 0>::mma(s, ql[ks], desc_sw128(khi + (ks >> 2) * OPND + 32 * (ks & 3)), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // the logits in log2 units, their row max, the weights and row sums;
    // element 4 j + 2 hh + e is row ra + 8 hh, key 8 j + 2 t4 + e
    float ma = __int_as_float(0xff800000), mb = ma;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 ba = *reinterpret_cast<const float2*>(ta + 8 * j);
      const float2 bb = *reinterpret_cast<const float2*>(ta + 8 * TP + 8 * j);
      s[4 * j] = fmaf(s[4 * j], lsc, ba.x);
      s[4 * j + 1] = fmaf(s[4 * j + 1], lsc, ba.y);
      s[4 * j + 2] = fmaf(s[4 * j + 2], lsc, bb.x);
      s[4 * j + 3] = fmaf(s[4 * j + 3], lsc, bb.y);
      ma = fmaxf(ma, fmaxf(s[4 * j], s[4 * j + 1]));
      mb = fmaxf(mb, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
    ma = quad_max(ma);
    mb = quad_max(mb);
    float suma = 0.f, sumb = 0.f;
    uint32_t pa[4][4];  // the weights as P V's A, one 16-key step each
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float e0 = ex2(s[4 * j] - ma), e1 = ex2(s[4 * j + 1] - ma);
      const float e2 = ex2(s[4 * j + 2] - mb), e3 = ex2(s[4 * j + 3] - mb);
      suma += e0 + e1;
      sumb += e2 + e3;
      pa[j >> 1][(j & 1) * 2] = pack_bf16(e0, e1);
      pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(e2, e3);
    }
    suma = quad_sum(suma);
    sumb = quad_sum(sumb);

    // O's 64-column tile dt from V^T's operand dt
    float o[DT][32];
    wgmma_fence();
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
#pragma unroll
      for (int st = 0; st < 4; ++st)
        WgmmaRS<64, 0>::mma(o[dt], pa[st], desc_sw128(vt + dt * OPND + 32 * st), st > 0);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) fence_regs(o[dt]);

    const float inva = 1.f / suma, invb = 1.f / sumb;
    bf16* O = static_cast<bf16*>(g.out) + (int64_t)w * g.o_w + (int64_t)h * g.o_h;
#pragma unroll
    for (int j = 0; j < 8 * DT; ++j) {
      const int c = 8 * j + 2 * t4;
      if (c >= D) continue;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = hh ? rb : ra;
        if (r >= N) continue;
        const float inv = hh ? invb : inva;
        bf16* at = O + (int64_t)r * g.o_n + c;
        const float* oj = o[j >> 3] + 4 * (j & 7) + 2 * hh;
        const float y0 = oj[0] * inv, y1 = oj[1] * inv;
        if (c + 1 < D && !(D & 1)) {
          *reinterpret_cast<__nv_bfloat162*>(at) = __floats2bfloat162_rn(y0, y1);
        } else {
          at[0] = __float2bfloat16(y0);
          if (c + 1 < D) at[1] = __float2bfloat16(y1);
        }
      }
    }
  }
}

}  // namespace hop

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// q, k or v of every (window, head): dims (head dim, then the head, token
// and window axes in the order of their strides, as TMA wants them), box
// [64 tokens, D], no swizzle; tokens past N are zeros
bool qkv_map(CUtensorMap* map, const void* ptr, const Args& g, int heads, int windows,
             int order[3]) {
  const int64_t st[3] = {g.s_h, g.s_n, g.s_w};
  const int64_t ext[3] = {heads, g.n, windows};
  const int64_t box[3] = {1, hop::BM, 1};
  cuuint64_t dim[4] = {(cuuint64_t)g.d, 0, 0, 0}, stride[3];
  cuuint32_t b[4] = {(cuuint32_t)g.d, 1, 1, 1};
  for (int i = 0; i < 3; ++i) {
    const int a = order[i];
    dim[1 + i] = (cuuint64_t)ext[a];
    stride[i] = (cuuint64_t)st[a] * 2;
    b[1 + i] = (cuuint32_t)box[a];
  }
  return hopper::encode_bf16(map, ptr, 4, dim, stride, b, CU_TENSOR_MAP_SWIZZLE_NONE);
}

// one landed [64, D] operand, in bytes (a multiple of 128, as TMA writes it)
int land_bytes(int d) { return (hop::BM * d * 2 + 127) & ~127; }
// the alignment slack, the operand tiles (DT of each), the bias tile, the
// landing ring and its barriers
int smem_bytes(int land, int dt) {
  return 1024 + 3 * dt * hop::OPND + hop::BM * hop::TP * 4 + hop::STAGES * (3 * land + 8);
}

// lets attn_bf16<DT> take the shared memory of its widest head (64 DT),
// once per device
template <int DT>
cudaError_t allow_smem() {
  static std::atomic<bool> done[hopper::MAX_DEVICES];
  const int slot = hopper::device_slot();
  if (slot >= 0 && done[slot].load(std::memory_order_acquire)) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(hop::attn_bf16<DT>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             smem_bytes(land_bytes(64 * DT), DT));
  if (e == cudaSuccess && slot >= 0) done[slot].store(true, std::memory_order_release);
  return e;
}

cudaError_t launch_bf16(const Args& g, int windows, int heads, int group, cudaStream_t s) {
  hop::Plan p{};
  p.n_groups = g.mask ? g.n_masks : 1;
  p.per_group = windows / p.n_groups;
  p.g = group < 1 ? 1 : (group > p.per_group ? p.per_group : group);
  p.heads = heads;
  p.land = land_bytes(g.d);
  p.tma = g.d % 8 == 0 && (g.s_w | g.s_h | g.s_n) % 8 == 0 && aligned16(g.q) &&
          aligned16(g.k) && aligned16(g.v);
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
    if (order[i] == 2) p.ax_w = i;
  }
  CUtensorMap tq{}, tk{}, tv{};
  if (p.tma && !(qkv_map(&tq, g.q, g, heads, windows, order) &&
                 qkv_map(&tk, g.k, g, heads, windows, order) &&
                 qkv_map(&tv, g.v, g, heads, windows, order)))
    return cudaErrorInvalidValue;
  const int dt = g.d > 64 ? 2 : 1;
  const int smem = smem_bytes(p.land, dt);
  const cudaError_t e = dt == 2 ? allow_smem<2>() : allow_smem<1>();
  if (e != cudaSuccess) return e;
  const int64_t blocks = (int64_t)heads * p.n_groups * ((p.per_group + p.g - 1) / p.g);
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  if (dt == 2)
    hop::attn_bf16<2><<<(unsigned)blocks, hop::THREADS, smem, s>>>(tq, tk, tv, g, p);
  else
    hop::attn_bf16<1><<<(unsigned)blocks, hop::THREADS, smem, s>>>(tq, tk, tv, g, p);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 float32 (SIMT, grid (windows, heads)), 1 bfloat16 (Hopper: wgmma
// and TMA, one block per head and group of `group` windows that read one
// mask index). Returns cudaGetLastError(), or cudaErrorInvalidValue for
// arguments the kernels do not take.
extern "C" int k2_window_attn(
    int dtype, const void* q, const void* k, const void* v,
    int64_t s_w, int64_t s_h, int64_t s_n,
    void* out, int64_t o_w, int64_t o_h, int64_t o_n,
    const float* bias, const float* mask, int n_masks, const float* scales,
    int cosine, int windows, int heads, int n, int d, int group, void* stream) {
  if (n < 1 || n > 64 || d < 1 || d > 128 || windows < 1 || heads < 1 ||
      (mask && (n_masks < 1 || windows % n_masks)))
    return static_cast<int>(cudaErrorInvalidValue);
  Args g{q, k, v, s_w, s_h, s_n, out, o_w, o_h, o_n, bias, mask, n_masks, scales, cosine, n, d};
  const size_t smem = sizeof(float) * (3 * n * (d + 1) + n * (n + 1));
  dim3 grid(windows, heads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(window_attn<float>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    window_attn<float><<<grid, THREADS, smem, s>>>(g);
  } else if (dtype == 1) {
    const cudaError_t e = launch_bf16(g, windows, heads, group, s);
    if (e != cudaSuccess) return static_cast<int>(e);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* k2_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

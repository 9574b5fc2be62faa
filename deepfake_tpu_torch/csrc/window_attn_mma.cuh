// Window attention in bf16 at head dims other than 32, on the tensor cores
// through mma.sync (m16n8k16, bf16 in, f32 accumulate): the forward of K3
// (window_attn3d.cu), K5 (window_attn3d_train.cu) and K6
// (window_attn_multihead.cu), and K5's backward (at the end), for every head
// dim of 1 to 128 but 32, whose Hopper kernels (wgmma + TMA,
// window_attn_tile.cuh and K6's and K5's own) are built for that width
// alone. The forward, for each (window w, head h):
//
//   out = softmax_rows(S + bias[h] + mask[w % n_masks]) . v
//
// in the form of its caller, a template parameter:
//   STATIC_SHIFT (K3): S = (q * bf16(scale), rounded to bf16) k^T; the
//     weights exp(min(x - 24, 60)), no row max, 1/rowsum at the end.
//   MAX_STABLE (K5's forward): S = (q k^T) scale, the scale in f32 after
//     the product; the max-stabilised softmax.
//   SCALED (K6, scaled logits): as MAX_STABLE with the head's scale.
//   COSINE (K6): S = q^ . k^ times the head's logit scale, q^ = q / max(|q|,
//     1e-12) formed in f32 and split into bf16 hi + lo (two products, ~2^-16
//     relative), k exact in bf16 with 1 / max(|k|, 1e-12) applied per key in
//     f32 after the product (K6's Hopper kernel does the same).
// Every form: + bias (f32) + mask; the weights rounded to bf16 for P V (the
// row sums of the unrounded weights), f32 accumulation, the output rounded
// once. The cast points are those of the plain versions, but for the
// weights' rounding in the max-stabilised forms (as on the Hopper route).
//
// Design: a first, simple tensor-core kernel (FlashAttention-2's loop,
// Dao 2023): one block of 4 warps per (64-row query tile, window, head),
// each warp 16 query rows; keys in tiles of 64 through shared memory
// (padded rows: the fragment loads fall on distinct banks), the online
// softmax state in registers across tiles, P passed from S's accumulators
// to P V's A fragments without leaving the registers. The head is held as
// DP = 32, 64 or 128 columns (instances), the columns from d on zero in
// shared memory, so they change neither q.k nor the kept columns of P V.
// Rows of q, k, v and dO come into shared memory 16 bytes at a time where
// the head dim, every stride and every address are multiples of 8 elements
// (16 bytes; MArgs::vec, set by the launch), else element by element with
// the same zero fill (D = 12 with 3 heads: rows of 24 bytes, a qkv row of
// 108 elements); outputs are written in pairs, or one element at a time.
// Bias and mask are read per logit from device memory (L2): nothing is
// shared between the windows of a mask index (the Hopper kernels share a
// tile); that and the thread loads of K and V are what a faster design
// would change. What bounds the function on the H100: bytes (q, k, v, out,
// the bias and the mask once each).

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace wtile {
namespace mma {

typedef __nv_bfloat16 bf16;

enum MForm { M_STATIC_SHIFT = 0, M_MAX_STABLE = 1, M_SCALED = 2, M_COSINE = 3 };

constexpr int BQ = 64, BK = 64, THREADS = 128;

// The one place where the bf16 routes of K3, K5 and K6 split by head dim:
// their Hopper kernels (wgmma + TMA) are built for WGMMA_D columns alone,
// every other head dim runs this file's kernels (dtype 1 is bf16).
constexpr int WGMMA_D = 32;
inline bool on_wgmma(int dtype, int d) { return dtype == 1 && d == WGMMA_D; }

struct MArgs {
  const bf16* q; const bf16* k; const bf16* v;
  int64_t s_w, s_h, s_n;           // q/k/v element strides (head dim contiguous)
  bf16* out; int64_t o_w, o_h, o_n;
  const float* bias;               // [heads, n, n]
  const void* mask; int n_masks;   // [n_masks, n, n] (bf16 or f32), or null
  const float* scales;             // [heads] (SCALED, COSINE), or null
  float scale;                     // STATIC_SHIFT, MAX_STABLE
  int n, d;
  int vec = 0;                     // 16-byte rows and strides (set by launch)
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t pack(bf16 lo, bf16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// eight bf16 of a row from column c on, zeros from column d on: one 16-byte
// load where the rows allow it (vec), else element by element
__device__ __forceinline__ uint4 load8(const bf16* row, int c, int d, bool vec) {
  if (vec) return *reinterpret_cast<const uint4*>(row + c);
  union { uint4 u; unsigned short h[8]; } x;
#pragma unroll
  for (int j = 0; j < 8; ++j) x.h[j] = c + j < d ? __bfloat16_as_ushort(row[c + j]) : 0;
  return x.u;
}
// columns c and c + 1 of a bf16 output row (c even; c + 1 only where it is
// below d): one 4-byte store where the rows allow it (vec)
__device__ __forceinline__ void store2(bf16* p, float x0, float x1, bool second, bool vec) {
  if (vec) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x0, x1);
  } else {
    p[0] = __float2bfloat16(x0);
    if (second) p[1] = __float2bfloat16(x1);
  }
}

// d += a b: a 16 x 16 bf16 (row), b 16 x 8 bf16 (col), d 16 x 8 f32
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int DP>
__host__ __device__ constexpr int row_pitch() { return DP + 8; }  // bf16 a row
template <int F, int DP>
__host__ __device__ constexpr size_t smem_bytes() {
  // q (hi, and lo for COSINE), K, V tiles; K's per-key factor (COSINE)
  return sizeof(bf16) * row_pitch<DP>() * (BQ * (F == M_COSINE ? 2 : 1) + 2 * BK) +
         sizeof(float) * BK;
}

// One block per (64-row query tile, window, head); warp w takes query rows
// 16 w .. 16 w + 15 of the tile. Fragment element e of a thread (lane = 4 g
// + t): accumulator rows g, g + 8 and columns 2 t, 2 t + 1 of each 8-wide
// tile (the mma.sync m16n8k16 layouts).
template <int F, int DP, typename MaskT>
__global__ void __launch_bounds__(THREADS) attn_mma(MArgs a) {
  constexpr int P = row_pitch<DP>(), KS = DP / 16, NO = DP / 8;
  constexpr bool COS = F == M_COSINE;
  constexpr bool MAXF = F != M_STATIC_SHIFT;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);            // [BQ][P] q (q^ hi)
  bf16* ql = qs + BQ * P;                                   // [BQ][P] q^ lo (COSINE)
  bf16* ks = qs + (COS ? 2 : 1) * BQ * P;                   // [BK][P]
  bf16* vs = ks + BK * P;                                   // [BK][P]
  float* kinv = reinterpret_cast<float*>(vs + BK * P);      // [BK] 1 / |k| (COSINE)

  const int N = a.n, D = a.d;
  const int q0 = blockIdx.x * BQ, w = blockIdx.y, h = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int64_t base = (int64_t)w * a.s_w + (int64_t)h * a.s_h;
  const bf16* Q = a.q + base;
  const bf16* K = a.k + base;
  const bf16* V = a.v + base;
  const float* bias = a.bias + (int64_t)h * N * N;
  const MaskT* mask =
      a.mask ? static_cast<const MaskT*>(a.mask) + (int64_t)(w % a.n_masks) * N * N : nullptr;
  const float hs = a.scales ? a.scales[h] : a.scale;  // the head's scale (COSINE: logit scale)

  // q tile into shared memory, the columns from D on and rows past N zero:
  // STATIC_SHIFT q * bf16(scale) rounded to bf16; COSINE q^ as hi + lo
  if (COS) {
    // two threads a row, each half of its columns, then their sum
    const int r = tid >> 1, half = tid & 1, row = q0 + r;
    float ss = 0.f;
    for (int c = half; c < D; c += 2) {
      const float x = row < N ? to_f(Q[(int64_t)row * a.s_n + c]) : 0.f;
      ss = fmaf(x, x, ss);
    }
    ss += __shfl_xor_sync(0xffffffffu, ss, 1);
    const float inv = 1.f / fmaxf(sqrtf(ss), 1e-12f);
    for (int c = half; c < DP; c += 2) {
      const float x = row < N && c < D ? to_f(Q[(int64_t)row * a.s_n + c]) * inv : 0.f;
      const bf16 hi = __float2bfloat16(x);
      qs[r * P + c] = hi;
      ql[r * P + c] = __float2bfloat16(x - __bfloat162float(hi));
    }
  } else {
    const float sc = __bfloat162float(__float2bfloat16(a.scale));
    for (int i = tid; i < BQ * DP; i += THREADS) {
      const int r = i / DP, c = i - r * DP, row = q0 + r;
      bf16 x = __float2bfloat16(0.f);
      if (row < N && c < D) {
        x = Q[(int64_t)row * a.s_n + c];
        if (F == M_STATIC_SHIFT) x = __float2bfloat16(__bfloat162float(x) * sc);
      }
      qs[r * P + c] = x;
    }
  }
  __syncthreads();

  // this warp's q fragments, all k steps
  const int ra = 16 * warp + g;  // tile rows ra and ra + 8
  uint32_t qa[KS][4], qb[COS ? KS : 1][4];
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    const int c = 16 * s + 2 * t;
    qa[s][0] = *reinterpret_cast<const uint32_t*>(qs + ra * P + c);
    qa[s][1] = *reinterpret_cast<const uint32_t*>(qs + (ra + 8) * P + c);
    qa[s][2] = *reinterpret_cast<const uint32_t*>(qs + ra * P + c + 8);
    qa[s][3] = *reinterpret_cast<const uint32_t*>(qs + (ra + 8) * P + c + 8);
    if constexpr (COS) {
      qb[s][0] = *reinterpret_cast<const uint32_t*>(ql + ra * P + c);
      qb[s][1] = *reinterpret_cast<const uint32_t*>(ql + (ra + 8) * P + c);
      qb[s][2] = *reinterpret_cast<const uint32_t*>(ql + ra * P + c + 8);
      qb[s][3] = *reinterpret_cast<const uint32_t*>(ql + (ra + 8) * P + c + 8);
    }
  }

  const int row_a = q0 + ra, row_b = row_a + 8;
  float o[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;

  for (int k0 = 0; k0 < N; k0 += BK) {
    __syncthreads();  // the last tile's reads are done
    // K and V tiles, 8 columns at a time; keys past N and columns past D
    // zero
    for (int i = tid; i < BK * (DP / 8); i += THREADS) {
      const int r = i / (DP / 8), c = (i - r * (DP / 8)) * 8, key = k0 + r;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = kv;
      if (key < N && c < D) {
        kv = load8(K + (int64_t)key * a.s_n, c, D, a.vec);
        vv = load8(V + (int64_t)key * a.s_n, c, D, a.vec);
      }
      *reinterpret_cast<uint4*>(ks + r * P + c) = kv;
      *reinterpret_cast<uint4*>(vs + r * P + c) = vv;
    }
    if (COS) {
      __syncthreads();
      if (tid < BK) {
        float ss = 0.f;
        for (int c = 0; c < DP; ++c) {
          const float x = __bfloat162float(ks[tid * P + c]);
          ss = fmaf(x, x, ss);
        }
        kinv[tid] = 1.f / fmaxf(sqrtf(ss), 1e-12f);
      }
    }
    __syncthreads();

    // S = q k^T for this warp's 16 rows and the tile's 64 keys
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const bf16* kr = ks + (8 * j + g) * P + 2 * t;
#pragma unroll
      for (int st = 0; st < KS; ++st) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kr + 16 * st);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(kr + 16 * st + 8);
        mma16816(s[j], qa[st], b0, b1);
        if constexpr (COS) mma16816(s[j], qb[st], b0, b1);
      }
    }

    // the logits (+ bias + mask), keys past N excluded
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kk = 8 * j + 2 * t + (e & 1), key = k0 + kk, row = e < 2 ? row_a : row_b;
        float x = -INFINITY;
        if (key < N) {
          float sv = s[j][e];
          if (COS) sv *= kinv[kk] * hs;
          else if (F == M_MAX_STABLE || F == M_SCALED) sv *= hs;
          const int rr = row < N ? row : 0;
          const int64_t at = (int64_t)rr * N + key;
          x = sv + bias[at];
          if (mask) x += to_f(mask[at]);
        }
        s[j][e] = x;
        if (e < 2) mx_a = fmaxf(mx_a, x);
        else mx_b = fmaxf(mx_b, x);
      }

    // the weights, their row sums and (max-stabilised) the rescale
    float base_a = 0.f, base_b = 0.f;
    if (MAXF) {
      const float mn_a = fmaxf(m_a, quad_max(mx_a)), mn_b = fmaxf(m_b, quad_max(mx_b));
      base_a = mn_a == -INFINITY ? 0.f : mn_a;
      base_b = mn_b == -INFINITY ? 0.f : mn_b;
      const float al_a = expf(m_a - base_a), al_b = expf(m_b - base_b);  // -inf: 0
      m_a = mn_a;
      m_b = mn_b;
      l_a *= al_a;
      l_b *= al_b;
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        o[j][0] *= al_a;
        o[j][1] *= al_a;
        o[j][2] *= al_b;
        o[j][3] *= al_b;
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[j][e];
        float p;
        if (MAXF) p = expf(x - (e < 2 ? base_a : base_b));   // exp(-inf) = 0
        else p = x == -INFINITY ? 0.f : expf(fminf(x - 24.f, 60.f));
        s[j][e] = p;
        if (e < 2) l_a += p;
        else l_b += p;
      }

    // O += P V: P from S's accumulators (keys 16 kk .. 16 kk + 15 are
    // tiles 2 kk and 2 kk + 1), V's fragments from shared memory
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t pa[4] = {pack(s[2 * kk][0], s[2 * kk][1]), pack(s[2 * kk][2], s[2 * kk][3]),
                              pack(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const bf16* v0 = vs + (16 * kk + 2 * t) * P + g;
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        const bf16* vc = v0 + 8 * j;
        const uint32_t b0 = pack(vc[0], vc[P]);
        const uint32_t b1 = pack(vc[8 * P], vc[9 * P]);
        mma16816(o[j], pa, b0, b1);
      }
    }
  }

  // normalise by the rows' sums (spread over the quad) and store
  const float ia = 1.f / quad_sum(l_a), ib = 1.f / quad_sum(l_b);
  bf16* O = a.out + (int64_t)w * a.o_w + (int64_t)h * a.o_h;
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    const int c = 8 * j + 2 * t;
    if (c >= D) continue;
    if (row_a < N)
      store2(O + (int64_t)row_a * a.o_n + c, o[j][0] * ia, o[j][1] * ia, c + 1 < D, a.vec);
    if (row_b < N)
      store2(O + (int64_t)row_b * a.o_n + c, o[j][2] * ib, o[j][3] * ib, c + 1 < D, a.vec);
  }
}

template <int F, int DP, typename MaskT>
cudaError_t launch_dp(const MArgs& a, int windows, int heads, cudaStream_t s) {
  constexpr size_t smem = smem_bytes<F, DP>();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        attn_mma<F, DP, MaskT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  attn_mma<F, DP, MaskT><<<dim3((a.n + BQ - 1) / BQ, windows, heads), THREADS, smem, s>>>(a);
  return cudaGetLastError();
}

// whether every address is a multiple of 16 bytes
template <typename... T>
inline bool all_aligned16(const T*... p) {
  return ((reinterpret_cast<uintptr_t>(p) % 16 == 0) && ...);
}

// One launch at head dim a.d (1 to 128: the instance of 32, 64 or 128
// columns), q, k, v and out with any strides (the head dim contiguous);
// 16-byte loads where d, the strides and the addresses allow them.
template <int F, typename MaskT>
cudaError_t launch(const MArgs& args, int windows, int heads, cudaStream_t s) {
  if (args.d < 1 || args.d > 128 || windows > 65535 || heads > 65535)
    return cudaErrorInvalidValue;
  MArgs a = args;
  a.vec = a.d % 8 == 0 && (a.s_w | a.s_h | a.s_n | a.o_w | a.o_h | a.o_n) % 8 == 0 &&
          all_aligned16(a.q, a.k, a.v, a.out);
  if (a.d <= 32) return launch_dp<F, 32, MaskT>(a, windows, heads, s);
  if (a.d <= 64) return launch_dp<F, 64, MaskT>(a, windows, heads, s);
  return launch_dp<F, 128, MaskT>(a, windows, heads, s);
}

// ------------------------------------------------------------- backward

// K5's backward at head dims other than 32 (bf16; the Hopper backward in
// window_attn3d_train.cu is built for 32): for each (window, head), with
// P recomputed from q, k and the bias in the compute type (bf16) + mask,
//   dV = P^T dO,  dP = dO V^T,  dS = P (dP - rowsum(dP P)),
//   dQ = dS K s,  dK = dS^T Q s,  dbias[h] = sum of dS over the windows (f32).
// One block of 4 warps per (64-row query tile, window, head), two sweeps
// over the keys in tiles of 64 (FlashAttention-2's backward order turned
// around: the query tile stays, the keys move): sweep 1 keeps each row's
// online max m, sum l and c = sum e dP; sweep 2 forms P and dS, stores dS
// into the window's slot of the partial sums (sum_parts then adds the
// windows into dbias in order), dS K into dq (registers, written once at the end)
// and, through shared memory, P^T dO and dS^T q into dv and dk (atomics,
// zeroed f32 outputs; each warp 16 of the tile's keys). S, dP, dq, dk and
// dv on mma.sync with f32 accumulation; P and dS rounded to bf16 where
// they feed a product (as the Hopper backward), the softmax, its
// statistics and dS itself f32.
struct MBwdArgs {
  const bf16* q; const bf16* k; const bf16* v;
  int64_t s_w, s_h, s_n;
  const bf16* dout; int64_t d_w, d_h, d_n;
  float* dq; float* dk; float* dv;  // f32, the strides g_*; dk, dv zeroed
  int64_t g_w, g_h, g_n;
  const bf16* bias;                 // [heads, n, n] in the compute type
  const bf16* mask; int n_masks;    // [n_masks, n, n] or null
  float* dbias;                     // [heads, n, n] f32
  float* part;                      // [windows, heads, n, n] f32: each window's dS
  float scale;
  int n, d;
  int vec = 0;                      // 16-byte rows and strides (set by launch_bwd)
};

template <int DP>
__host__ __device__ constexpr size_t bwd_smem_bytes() {
  // q, dO, K, V tiles [64][DP + 8]; P and dS tiles [64][72] (bf16)
  return sizeof(bf16) * (4 * BQ * row_pitch<DP>() + 2 * BQ * (BK + 8));
}

// the A fragment (mma.m16n8k16) of rows r0 .. r0 + 15, columns c0 .. c0 + 15
// of a row-major bf16 tile with `pitch` elements a row
__device__ __forceinline__ void frag_a(const bf16* s, int pitch, int r0, int c0, int g, int t,
                                       uint32_t (&a)[4]) {
  const bf16* p = s + (r0 + g) * pitch + c0 + 2 * t;
  a[0] = *reinterpret_cast<const uint32_t*>(p);
  a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * pitch);
  a[2] = *reinterpret_cast<const uint32_t*>(p + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * pitch + 8);
}
// the A fragment of the transpose of such a tile: rows c0 .. c0 + 15 of
// the transpose are columns of the tile
__device__ __forceinline__ void frag_at(const bf16* s, int pitch, int r0, int c0, int g, int t,
                                        uint32_t (&a)[4]) {
  // element (i, j) of the transpose is s[(c0 + j) * pitch + r0 + i]
  const bf16* p = s + (c0 + 2 * t) * pitch + r0 + g;
  a[0] = pack(p[0], p[pitch]);
  a[1] = pack(p[8], p[pitch + 8]);
  a[2] = pack(p[8 * pitch], p[9 * pitch]);
  a[3] = pack(p[8 * pitch + 8], p[9 * pitch + 8]);
}
// the B fragment (k 16 x n 8) whose element (kk, nn) is s[(n0 + nn) * pitch
// + k0 + kk]: a tile read "K-major" (as K for q K^T)
__device__ __forceinline__ void frag_b(const bf16* s, int pitch, int n0, int k0, int g, int t,
                                       uint32_t& b0, uint32_t& b1) {
  const bf16* p = s + (n0 + g) * pitch + k0 + 2 * t;
  b0 = *reinterpret_cast<const uint32_t*>(p);
  b1 = *reinterpret_cast<const uint32_t*>(p + 8);
}
// the B fragment whose element (kk, nn) is s[(k0 + kk) * pitch + n0 + nn]:
// a tile read "MN-major" (as V for P V)
__device__ __forceinline__ void frag_bt(const bf16* s, int pitch, int n0, int k0, int g, int t,
                                        uint32_t& b0, uint32_t& b1) {
  const bf16* p = s + (k0 + 2 * t) * pitch + n0 + g;
  b0 = pack(p[0], p[pitch]);
  b1 = pack(p[8 * pitch], p[9 * pitch]);
}

template <int DP>
__global__ void __launch_bounds__(THREADS) attn_bwd_mma(MBwdArgs a) {
  constexpr int P = row_pitch<DP>(), KS = DP / 16, NO = DP / 8, PT = BK + 8;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [BQ][P]
  bf16* os = qs + BQ * P;                        // [BQ][P] dO
  bf16* ks = os + BQ * P;                        // [BK][P]
  bf16* vs = ks + BK * P;                        // [BK][P]
  bf16* ps = vs + BK * P;                        // [BQ][PT] P (bf16)
  bf16* ds = ps + BQ * PT;                       // [BQ][PT] dS (bf16)

  const int N = a.n, D = a.d;
  const int q0 = blockIdx.x * BQ, w = blockIdx.y, h = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int64_t base = (int64_t)w * a.s_w + (int64_t)h * a.s_h;
  const bf16* Q = a.q + base;
  const bf16* K = a.k + base;
  const bf16* V = a.v + base;
  const bf16* dO = a.dout + (int64_t)w * a.d_w + (int64_t)h * a.d_h;
  const bf16* bias = a.bias + (int64_t)h * N * N;
  const bf16* mask = a.mask ? a.mask + (int64_t)(w % a.n_masks) * N * N : nullptr;
  // this window's dS, every element written once (sum_parts adds the windows)
  float* dbias = a.part + ((int64_t)w * gridDim.z + h) * N * N;
  const int64_t gb = (int64_t)w * a.g_w + (int64_t)h * a.g_h;

  // the query tile's q and dO, 8 columns at a time (zeros past N and D)
  for (int i = tid; i < BQ * (DP / 8); i += THREADS) {
    const int r = i / (DP / 8), c = (i - r * (DP / 8)) * 8, row = q0 + r;
    uint4 qv = make_uint4(0, 0, 0, 0), ov = qv;
    if (row < N && c < D) {
      qv = load8(Q + (int64_t)row * a.s_n, c, D, a.vec);
      ov = load8(dO + (int64_t)row * a.d_n, c, D, a.vec);
    }
    *reinterpret_cast<uint4*>(qs + r * P + c) = qv;
    *reinterpret_cast<uint4*>(os + r * P + c) = ov;
  }

  const int ra = 16 * warp + g, row_a = q0 + ra, row_b = row_a + 8;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f, c_a = 0.f, c_b = 0.f;
  float dq[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;

  for (int sweep = 0; sweep < 2; ++sweep) {
    for (int k0 = 0; k0 < N; k0 += BK) {
      __syncthreads();  // the last tile's reads are done (and q, dO are in place)
      for (int i = tid; i < BK * (DP / 8); i += THREADS) {
        const int r = i / (DP / 8), c = (i - r * (DP / 8)) * 8, key = k0 + r;
        uint4 kv = make_uint4(0, 0, 0, 0), vv = kv;
        if (key < N && c < D) {
          kv = load8(K + (int64_t)key * a.s_n, c, D, a.vec);
          vv = load8(V + (int64_t)key * a.s_n, c, D, a.vec);
        }
        *reinterpret_cast<uint4*>(ks + r * P + c) = kv;
        *reinterpret_cast<uint4*>(vs + r * P + c) = vv;
      }
      __syncthreads();

      // S = q K^T and dP = dO V^T for this warp's 16 rows, 64 keys
      float s[8][4], dp[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      }
#pragma unroll
      for (int st = 0; st < KS; ++st) {
        uint32_t aq[4], ao[4];
        frag_a(qs, P, 16 * warp, 16 * st, g, t, aq);
        frag_a(os, P, 16 * warp, 16 * st, g, t, ao);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          uint32_t b0, b1;
          frag_b(ks, P, 8 * j, 16 * st, g, t, b0, b1);
          mma16816(s[j], aq, b0, b1);
          frag_b(vs, P, 8 * j, 16 * st, g, t, b0, b1);
          mma16816(dp[j], ao, b0, b1);
        }
      }
      // the logits: s scale + bias (compute type) + mask; keys past N -inf
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * j + 2 * t + (e & 1), row = e < 2 ? row_a : row_b;
          float x = -INFINITY;
          if (key < N) {
            const int64_t at = (int64_t)(row < N ? row : 0) * N + key;
            x = s[j][e] * a.scale + __bfloat162float(bias[at]);
            if (mask) x += __bfloat162float(mask[at]);
          }
          s[j][e] = x;
        }
      if (sweep == 0) {
        float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          mx_a = fmaxf(mx_a, fmaxf(s[j][0], s[j][1]));
          mx_b = fmaxf(mx_b, fmaxf(s[j][2], s[j][3]));
        }
        const float mn_a = fmaxf(m_a, quad_max(mx_a)), mn_b = fmaxf(m_b, quad_max(mx_b));
        const float ba = mn_a == -INFINITY ? 0.f : mn_a, bb = mn_b == -INFINITY ? 0.f : mn_b;
        const float al_a = expf(m_a - ba), al_b = expf(m_b - bb);  // m = -inf: 0
        float sl_a = 0.f, sl_b = 0.f, sc_a = 0.f, sc_b = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float e0 = expf(s[j][0] - ba), e1 = expf(s[j][1] - ba);
          const float e2 = expf(s[j][2] - bb), e3 = expf(s[j][3] - bb);
          sl_a += e0 + e1;
          sl_b += e2 + e3;
          sc_a = fmaf(e0, dp[j][0], fmaf(e1, dp[j][1], sc_a));
          sc_b = fmaf(e2, dp[j][2], fmaf(e3, dp[j][3], sc_b));
        }
        l_a = fmaf(l_a, al_a, quad_sum(sl_a));
        l_b = fmaf(l_b, al_b, quad_sum(sl_b));
        c_a = fmaf(c_a, al_a, quad_sum(sc_a));
        c_b = fmaf(c_b, al_b, quad_sum(sc_b));
        m_a = mn_a;
        m_b = mn_b;
        continue;
      }

      // sweep 2: P, dS; dS into the window's slot; P and dS (bf16) into shared memory
      const float rl_a = 1.f / l_a, rl_b = 1.f / l_b;
      const float di_a = c_a * rl_a, di_b = c_b * rl_b;
      const float ba = m_a == -INFINITY ? 0.f : m_a, bb = m_b == -INFINITY ? 0.f : m_b;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kk = 8 * j + 2 * t;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float rl = hh ? rl_b : rl_a, di = hh ? di_b : di_a, b = hh ? bb : ba;
          const float p0 = expf(s[j][2 * hh] - b) * rl, p1 = expf(s[j][2 * hh + 1] - b) * rl;
          const float d0 = p0 * (dp[j][2 * hh] - di), d1 = p1 * (dp[j][2 * hh + 1] - di);
          const int r = ra + 8 * hh, row = q0 + r;
          *reinterpret_cast<uint32_t*>(ps + r * PT + kk) = pack(p0, p1);
          *reinterpret_cast<uint32_t*>(ds + r * PT + kk) = pack(d0, d1);
          if (row < N) {
            const int key = k0 + kk;
            if (key < N) dbias[(int64_t)row * N + key] = d0;
            if (key + 1 < N) dbias[(int64_t)row * N + key + 1] = d1;
          }
        }
      }
      __syncwarp();
      // dq += dS K (this warp's rows; dS from shared memory as A, K as B
      // read MN-major: element (key, d))
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t ad[4];
        frag_a(ds, PT, 16 * warp, 16 * kk, g, t, ad);
#pragma unroll
        for (int j = 0; j < NO; ++j) {
          uint32_t b0, b1;
          frag_bt(ks, P, 8 * j, 16 * kk, g, t, b0, b1);
          mma16816(dq[j], ad, b0, b1);
        }
      }
      __syncthreads();  // every warp's P and dS rows are in place
      // dv += P^T dO, then dk += dS^T q s, for this warp's 16 keys of the
      // tile (rows of the transposes; the query tile's 64 rows are the k
      // steps), each added into its f32 output with atomics
#pragma unroll
      for (int which = 0; which < 2; ++which) {
        const bf16* at = which ? ds : ps;
        const bf16* bt = which ? qs : os;
        float* out = (which ? a.dk : a.dv) + gb;
        const float f = which ? a.scale : 1.f;
        float acc[NO][4];
#pragma unroll
        for (int j = 0; j < NO; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
        for (int st = 0; st < BQ / 16; ++st) {
          uint32_t af[4];
          frag_at(at, PT, 16 * warp, 16 * st, g, t, af);
#pragma unroll
          for (int j = 0; j < NO; ++j) {
            uint32_t b0, b1;
            frag_bt(bt, P, 8 * j, 16 * st, g, t, b0, b1);
            mma16816(acc[j], af, b0, b1);
          }
        }
#pragma unroll
        for (int j = 0; j < NO; ++j) {
          const int c = 8 * j + 2 * t;
          if (c >= D) continue;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int key = k0 + 16 * warp + g + 8 * hh;
            if (key >= N) continue;
            float* o = out + (int64_t)key * a.g_n + c;
            atomicAdd(o, acc[j][2 * hh] * f);
            if (c + 1 < D) atomicAdd(o + 1, acc[j][2 * hh + 1] * f);
          }
        }
      }
    }
  }
  float* dQ = a.dq + gb;
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    const int c = 8 * j + 2 * t;
    if (c >= D) continue;
    if (row_a < N) {
      dQ[(int64_t)row_a * a.g_n + c] = dq[j][0] * a.scale;
      if (c + 1 < D) dQ[(int64_t)row_a * a.g_n + c + 1] = dq[j][1] * a.scale;
    }
    if (row_b < N) {
      dQ[(int64_t)row_b * a.g_n + c] = dq[j][2] * a.scale;
      if (c + 1 < D) dQ[(int64_t)row_b * a.g_n + c + 1] = dq[j][3] * a.scale;
    }
  }
}

// dbias[i] = sum over slots j = 0 .. parts - 1 of part[j][i], in that order:
// the backward's dbias without atomics, the same bits on every run
__global__ void sum_parts(const float* __restrict__ part, float* __restrict__ dbias, int parts,
                          int64_t len) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < len;
       i += (int64_t)gridDim.x * blockDim.x) {
    float acc = 0.f;
    for (int j = 0; j < parts; ++j) acc += part[(int64_t)j * len + i];
    dbias[i] = acc;
  }
}

inline cudaError_t launch_sum_parts(const float* part, float* dbias, int parts, int64_t len,
                                    cudaStream_t s) {
  const int64_t blocks = (len + 255) / 256;
  sum_parts<<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0, s>>>(part, dbias, parts, len);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_bwd_dp(const MBwdArgs& a, int windows, int heads, cudaStream_t s) {
  constexpr size_t smem = bwd_smem_bytes<DP>();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        attn_bwd_mma<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  attn_bwd_mma<DP><<<dim3((a.n + BQ - 1) / BQ, windows, heads), THREADS, smem, s>>>(a);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return launch_sum_parts(a.part, a.dbias, windows, (int64_t)heads * a.n * a.n, s);
}

// One backward launch at head dim a.d (1 to 128), q, k, v and dout with any
// strides (the head dim contiguous); dk and dv zeroed; then sum_parts writes
// dbias from a.part
inline cudaError_t launch_bwd(const MBwdArgs& args, int windows, int heads, cudaStream_t s) {
  if (args.d < 1 || args.d > 128 || windows > 65535 || heads > 65535)
    return cudaErrorInvalidValue;
  MBwdArgs a = args;
  a.vec = a.d % 8 == 0 && (a.s_w | a.s_h | a.s_n | a.d_w | a.d_h | a.d_n) % 8 == 0 &&
          all_aligned16(a.q, a.k, a.v, a.dout);
  if (a.d <= 32) return launch_bwd_dp<32>(a, windows, heads, s);
  if (a.d <= 64) return launch_bwd_dp<64>(a, windows, heads, s);
  return launch_bwd_dp<128>(a, windows, heads, s);
}

}  // namespace mma
}  // namespace wtile

// K6: window attention for the windows above K2's range (N >= 65 tokens, any
// N above that), head dim 32, cosine (SwinV2) or scaled. For each (window w,
// head h):
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
// the f32 mask [nW, N, N] once, and does 4 B_ H N^2 D operations (8 with the
// cosine split below). At SwinV2-B window 16, 256^2, b8, stage 0 (B_ = 128,
// H = 4, 16 masks) moves ~39 MB, ~12 us, against ~9 us of tensor-core work
// with the split; the 22 launches of a request need ~0.10 ms by bytes. The
// cost that the bound does not count is the bias and mask rows that every
// (window, head) block reads from L2: B_ H N^2 x 8 bytes a launch.
//
// Routes:
//   - bf16 (serving): tensor cores, mma.sync m16n8k16 with f32 accumulation.
//     One block of 8 warps per (window, 128-query-row slab, head); each warp
//     takes 16 query rows (a warp whose rows all lie past N only helps load).
//     K and V stream through shared memory in tiles of up to KT = 256 keys
//     (N x 32, keys padded to a multiple of 16 with zero rows), so N has no
//     upper limit; a window of up to 256 tokens is one tile. Each warp walks
//     the keys 16 at a time with an online row max (K5's forward), the
//     weights rounded to bf16 for P V. Cosine logits reach |scale| = 100, and
//     rounding q^ and k^ to bf16 would move a logit by ~100 x 2^-9 x
//     |q^ . k^|, several percent of a weight; so q^ and k^ are split into
//     bf16 hi + lo parts and q^ . k^ = hi.hi + hi.lo + lo.hi (three products,
//     ~2^-16 relative): the K tile is held twice (hi, lo), the q fragments
//     twice. Scaled logits take the bf16 q and k as they are (exact products)
//     and scale after. Keys are permuted within a step (key_of, as K3) so
//     that a thread's four weights of a row are four consecutive keys: their
//     f32 bias and mask are one 16-byte load each, issued a step ahead. The
//     grid runs every window of a head before the next head, so the head's
//     bias stays in L2.
//   - f32 (parity runs only; a different kernel from the one that serves):
//     one block per (32-query tile, window, head), SIMT f32 FMA; K and V
//     stream through shared memory in tiles of 128 keys with an online row
//     max, the [32, 128] logit tile in shared memory.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int D = 32;      // head dim
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
// max / sum over the 4 threads of a quad (the threads that share an mma row)
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
// the L2 norm's divisor, as the plain version's x / max(|x|, 1e-12)
__device__ __forceinline__ float norm_div(float ss) { return fmaxf(sqrtf(ss), 1e-12f); }

// ------------------------------------------------------------- f32: SIMT

namespace simt {

constexpr int MQ = 32, KT = 128, THREADS = 256, DP = D + 1;  // +1 pads off bank conflicts
constexpr int ROWS_PER_WARP = MQ / (THREADS / 32);

__host__ __device__ constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * KT * DP + MQ * DP + MQ * (KT + 1));
}

template <bool COSINE>
__global__ void __launch_bounds__(THREADS) attn_f32(Args g) {
  extern __shared__ float sm[];
  const int N = g.n, NP = KT + 1;
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

  for (int idx = tid; idx < MQ * D; idx += THREADS) {
    const int i = idx / D, c = idx % D;
    const float x = i < rows ? Q[(int64_t)(q0 + i) * g.s_n + c] : 0.f;
    qs[i * DP + c] = COSINE ? x : x * scale;
  }
  if (COSINE) {
    __syncthreads();
    for (int r = warp; r < rows; r += THREADS / 32) {  // a lane per element (D == 32)
      const float val = qs[r * DP + lane];
      qs[r * DP + lane] = val / norm_div(warp_sum(val * val));
    }
  }

  const float* bias = g.bias + (int64_t)h * N * N;
  const float* mask = g.mask ? g.mask + (int64_t)(w % g.n_masks) * N * N : nullptr;
  // the online softmax of rows warp + 8 i: running max, sum, and lane c's
  // column of the unnormalised P V
  float m[ROWS_PER_WARP], l[ROWS_PER_WARP], o[ROWS_PER_WARP];
#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
    o[i] = 0.f;
  }
  for (int t0 = 0; t0 < N; t0 += KT) {
    const int nt = min(KT, N - t0);
    __syncthreads();  // the previous tile is consumed (and q is ready)
    for (int idx = tid; idx < nt * D; idx += THREADS) {
      const int j = idx / D, c = idx % D;
      const int64_t off = (int64_t)(t0 + j) * g.s_n + c;
      ks[j * DP + c] = K[off];
      vs[j * DP + c] = V[off];
    }
    if (COSINE) {
      __syncthreads();
      for (int r = warp; r < nt; r += THREADS / 32) {
        const float val = ks[r * DP + lane];
        ks[r * DP + lane] = val / norm_div(warp_sum(val * val));
      }
    }
    __syncthreads();
    for (int idx = tid; idx < rows * nt; idx += THREADS) {
      const int i = idx / nt, j = idx - i * nt;
      const float* qi = qs + i * DP;
      const float* kj = ks + j * DP;
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < D; ++c) s = fmaf(qi[c], kj[c], s);
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
      // P V: lane c accumulates column c of the row (D == 32)
      float acc = 0.f;
      for (int j = 0; j < nt; ++j) acc = fmaf(p[j], vs[j * DP + lane], acc);
      o[ri] = o[ri] * alpha + acc;
      m[ri] = mn;
    }
  }

  float* O = static_cast<float*>(g.out) + (int64_t)w * g.o_w + (int64_t)h * g.o_h;
#pragma unroll
  for (int ri = 0; ri < ROWS_PER_WARP; ++ri) {
    const int i = warp + ri * (THREADS / 32);
    if (i < rows) O[(int64_t)(q0 + i) * g.o_n + lane] = o[ri] / l[ri];
  }
}

}  // namespace simt

// ------------------------------------------------------ bf16: tensor cores

namespace tc {

constexpr int WARPS = 8, THREADS = 32 * WARPS;
constexpr int SLAB = 16 * WARPS;  // query rows per block
constexpr int KT = 256;           // keys per shared-memory tile
constexpr int LD = D + 8;  // smem row stride in bf16 (80 bytes): the 8 rows of a
                           // fragment load fall on distinct banks

__host__ __device__ constexpr int pad16(int n) { return (n + 15) & ~15; }
// K (hi, and lo for cosine) and V tiles of min(pad16(n), KT) keys
__host__ __device__ constexpr size_t smem_bytes(int n, bool cosine) {
  return sizeof(uint16_t) * (cosine ? 3 : 2) * (pad16(n) < KT ? pad16(n) : KT) * LD;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ uint32_t ld32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}
// x (f32) as bf16 hi + lo, packed pairwise: hi = bf16(x), lo = bf16(x - hi)
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
  hi = pack_bf16(a, b);
  const float2 h = unpack_bf16(hi);
  lo = pack_bf16(a - h.x, b - h.y);
}
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Rows [0, nk) of K into shared memory [nk][LD] (rows >= n zero), with 16-byte
// loads; for cosine each row is L2-normalised in f32 and stored as bf16 hi
// (khi) and lo (klo) parts. The 4 threads of a row are consecutive lanes.
template <bool COSINE>
__device__ __forceinline__ void load_k(uint16_t* khi, uint16_t* klo, const bf16* K, int64_t sn,
                                       int n, int nk, int tid) {
  for (int c = tid; c < nk * (D / 8); c += THREADS) {
    const int j = c / (D / 8), part = (c % (D / 8)) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (j < n) val = *reinterpret_cast<const uint4*>(K + (int64_t)j * sn + part);
    if (!COSINE) {
      *reinterpret_cast<uint4*>(khi + j * LD + part) = val;
      continue;
    }
    const uint32_t u[4] = {val.x, val.y, val.z, val.w};
    float2 x[4];
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[i] = unpack_bf16(u[i]);
      ss += x[i].x * x[i].x + x[i].y * x[i].y;
    }
    const float dv = norm_div(quad_sum(ss));  // nk * 4 is a multiple of 64: whole warps
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) split_bf16(x[i].x / dv, x[i].y / dv, hi[i], lo[i]);
    *reinterpret_cast<uint4*>(khi + j * LD + part) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(klo + j * LD + part) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
}

// rows [0, nk) of V into shared memory [nk][LD], rows >= n zero
__device__ __forceinline__ void load_v(uint16_t* dst, const bf16* V, int64_t sn, int n, int nk,
                                       int tid) {
  for (int c = tid; c < nk * (D / 8); c += THREADS) {
    const int j = c / (D / 8), part = (c % (D / 8)) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (j < n) val = *reinterpret_cast<const uint4*>(V + (int64_t)j * sn + part);
    *reinterpret_cast<uint4*>(dst + j * LD + part) = val;
  }
}

// Key offset, within a step of 16 keys, of k-position p of the mma tiles
// (as K3): thread t4's four weights of a row become the consecutive keys
// 4 t4 .. 4 t4 + 3. K rows (for S) and V rows (for P V) are read in the same
// order, so the sum is unchanged.
__device__ __forceinline__ int key_of(int p) {
  const int q = p & 7;
  return 4 * (q >> 1) + (q & 1) + ((p >> 3) << 1);
}

// f32 bias + mask of one row at keys k4 .. k4 + 3 (float4 loads where vec);
// a key past n, or a row past n, gets -inf and so weight 0
__device__ __forceinline__ void load_add(float (&a)[4], const float* brow, const float* mrow,
                                         bool row_ok, int k4, int n, bool vec) {
  if (row_ok && vec && k4 + 3 < n) {
    const float4 b = *reinterpret_cast<const float4*>(brow + k4);
    a[0] = b.x; a[1] = b.y; a[2] = b.z; a[3] = b.w;
    if (mrow) {
      const float4 m = *reinterpret_cast<const float4*>(mrow + k4);
      a[0] += m.x; a[1] += m.y; a[2] += m.z; a[3] += m.w;
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const bool ok = row_ok && k4 + i < n;
    a[i] = ok ? brow[k4 + i] + (mrow ? mrow[k4 + i] : 0.f) : -INFINITY;
  }
}

// One running (max, scale) update of the online softmax for one row: the
// new max of the row's logits so far and the factor that rescales what was
// summed under the old max. A row that has seen only -inf keeps base 0.
__device__ __forceinline__ float online_max(float& m, float step_max, float& base) {
  const float mn = fmaxf(m, quad_max(step_max));
  base = mn == -INFINITY ? 0.f : mn;
  const float alpha = __expf(m - base);  // m = -inf: 0
  m = mn;
  return alpha;
}

// grid (windows, query slabs of SLAB rows, heads). Needs q, k, v, out, bias
// and mask 16-byte aligned and every stride a multiple of 8 elements (the
// host checks).
template <bool COSINE>
__global__ void __launch_bounds__(THREADS, 2) attn_bf16(Args g) {
  extern __shared__ __align__(16) uint16_t smb[];
  const int N = g.n, NK = pad16(N), TK = min(NK, KT);
  uint16_t* khi = smb;               // [TK][LD]; read in key_of order within a step
  uint16_t* vs = khi + TK * LD;      // [TK][LD]
  uint16_t* klo = vs + TK * LD;      // [TK][LD], cosine only

  const int w = blockIdx.x, h = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t base = (int64_t)w * g.s_w + (int64_t)h * g.s_h;
  const bf16* K = static_cast<const bf16*>(g.k) + base;
  const bf16* V = static_cast<const bf16*>(g.v) + base;

  // a warp whose 16 rows all lie past N computes nothing but loads its share
  // of every key tile
  const int r0 = blockIdx.y * SLAB + warp * 16;
  const bool active = r0 < N;
  const float scale = g.scales[h];
  const int g8 = lane >> 2, t4 = lane & 3;
  const int row_a = r0 + g8, row_b = row_a + 8;
  const bool ok_a = row_a < N, ok_b = row_b < N;

  // q A fragments of rows a, b (two k steps of 16); element e of step s is
  // row (e & 1 ? b : a), columns s * 16 + (e >> 1) * 8 + 2 t4 + {0, 1}
  const bf16* Q = static_cast<const bf16*>(g.q) + base;
  uint32_t qa[2][4], ql[2][4];
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = (e & 1) ? row_b : row_a;
      const int col = s * 16 + (e >> 1) * 8 + 2 * t4;
      qa[s][e] = ((e & 1) ? ok_b : ok_a)
                     ? *reinterpret_cast<const uint32_t*>(Q + (int64_t)row * g.s_n + col)
                     : 0u;
    }
  if (COSINE) {
    float ss_a = 0.f, ss_b = 0.f;
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 x = unpack_bf16(qa[s][e]);
        (e & 1 ? ss_b : ss_a) += x.x * x.x + x.y * x.y;
      }
    const float dv_a = norm_div(quad_sum(ss_a)), dv_b = norm_div(quad_sum(ss_b));
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 x = unpack_bf16(qa[s][e]);
        const float dv = (e & 1) ? dv_b : dv_a;
        split_bf16(x.x / dv, x.y / dv, qa[s][e], ql[s][e]);
      }
  }

  const float* bias = g.bias + (int64_t)h * N * N;
  const float* mask = g.mask ? g.mask + (int64_t)(w % g.n_masks) * N * N : nullptr;
  const bool vec = N % 4 == 0;
  const int kb0 = key_of(g8), kb1 = key_of(8 + g8);  // K rows of this lane's S columns
  const int kv_row = key_of(lane & 15);             // V row this lane addresses for ldmatrix
  const float* brow_a = bias + (int64_t)(ok_a ? row_a : 0) * N;
  const float* brow_b = bias + (int64_t)(ok_b ? row_b : 0) * N;
  const float* mrow_a = mask ? mask + (int64_t)(ok_a ? row_a : 0) * N : nullptr;
  const float* mrow_b = mask ? mask + (int64_t)(ok_b ? row_b : 0) * N : nullptr;

  float o[4][4];
#pragma unroll
  for (int dn = 0; dn < 4; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dn][e] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, sum_a = 0.f, sum_b = 0.f;
  float ba[4], bb[4];  // this step's bias + mask, rows a and b
  load_add(ba, brow_a, mrow_a, ok_a, 4 * t4, N, vec);
  load_add(bb, brow_b, mrow_b, ok_b, 4 * t4, N, vec);

  for (int t0 = 0; t0 < NK; t0 += TK) {
    const int nt = min(TK, NK - t0);
    if (t0) __syncthreads();  // every warp is done with the previous tile
    load_k<COSINE>(khi, klo, K + (int64_t)t0 * g.s_n, g.s_n, N - t0, nt, tid);
    load_v(vs, V + (int64_t)t0 * g.s_n, g.s_n, N - t0, nt, tid);
    __syncthreads();
    if (!active) continue;
    for (int j0 = 0; j0 < nt; j0 += 16) {
      // the next step's bias and mask are in flight while this step computes
      float nba[4], nbb[4];
      const int k4 = t0 + j0 + 16 + 4 * t4;
      load_add(nba, brow_a, mrow_a, ok_a, k4, N, vec);
      load_add(nbb, brow_b, mrow_b, ok_b, k4, N, vec);

      // S for this step's 16 keys, as two n8 tiles; cosine: the small
      // products first, then hi . hi
      float s[2][4];
#pragma unroll
      for (int nt8 = 0; nt8 < 2; ++nt8) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt8][e] = 0.f;
        const int kr = (j0 + (nt8 ? kb1 : kb0)) * LD;
#pragma unroll
        for (int st = 0; st < 2; ++st) {
          const int c0 = kr + st * 16 + 2 * t4;
          const uint32_t bh[2] = {ld32(khi + c0), ld32(khi + c0 + 8)};
          if (COSINE) {
            const uint32_t bl[2] = {ld32(klo + c0), ld32(klo + c0 + 8)};
            mma_bf16(s[nt8], ql[st], bh);
            mma_bf16(s[nt8], qa[st], bl);
          }
          mma_bf16(s[nt8], qa[st], bh);
        }
      }
      // logits (q.k) scale + bias + mask; tile nt8, element i of row a is key
      // 4 t4 + 2 nt8 + i
      float xa[4], xb[4];
#pragma unroll
      for (int nt8 = 0; nt8 < 2; ++nt8)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int c = 2 * nt8 + i;
          xa[c] = s[nt8][i] * scale + ba[c];
          xb[c] = s[nt8][2 + i] * scale + bb[c];
        }
      float base_a, base_b;
      const float al_a = online_max(m_a, fmaxf(fmaxf(xa[0], xa[1]), fmaxf(xa[2], xa[3])), base_a);
      const float al_b = online_max(m_b, fmaxf(fmaxf(xb[0], xb[1]), fmaxf(xb[2], xb[3])), base_b);
      sum_a *= al_a;
      sum_b *= al_b;
#pragma unroll
      for (int dn = 0; dn < 4; ++dn) {
        o[dn][0] *= al_a; o[dn][1] *= al_a;
        o[dn][2] *= al_b; o[dn][3] *= al_b;
      }
      uint32_t pa[4];
#pragma unroll
      for (int nt8 = 0; nt8 < 2; ++nt8) {
        float p[4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int c = 2 * nt8 + i;
          p[i] = __expf(xa[c] - base_a);
          p[2 + i] = __expf(xb[c] - base_b);
        }
        sum_a += p[0] + p[1];
        sum_b += p[2] + p[3];
        pa[nt8 * 2] = pack_bf16(p[0], p[1]);
        pa[nt8 * 2 + 1] = pack_bf16(p[2], p[3]);
      }
#pragma unroll
      for (int dn = 0; dn < 4; ++dn) {
        uint32_t vb[2];
        ldmatrix_x2_trans(vb, vs + (j0 + kv_row) * LD + dn * 8);
        mma_bf16(o[dn], pa, vb);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        ba[c] = nba[c];
        bb[c] = nbb[c];
      }
    }
  }
  if (!active) return;

  const float sa = quad_sum(sum_a), sb = quad_sum(sum_b);
  bf16* O = static_cast<bf16*>(g.out) + (int64_t)w * g.o_w + (int64_t)h * g.o_h;
#pragma unroll
  for (int dn = 0; dn < 4; ++dn) {
    const int c = dn * 8 + 2 * t4;
    if (ok_a)
      *reinterpret_cast<__nv_bfloat162*>(O + (int64_t)row_a * g.o_n + c) =
          __floats2bfloat162_rn(o[dn][0] / sa, o[dn][1] / sa);
    if (ok_b)
      *reinterpret_cast<__nv_bfloat162*>(O + (int64_t)row_b * g.o_n + c) =
          __floats2bfloat162_rn(o[dn][2] / sb, o[dn][3] / sb);
  }
}

}  // namespace tc

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

}  // namespace

// dtype: 0 float32 (SIMT), 1 bfloat16 (tensor cores); cosine: 1 cosine, 0
// scaled. Returns cudaGetLastError(), or cudaErrorInvalidValue for arguments
// the kernels do not take.
extern "C" int k6_window_attn(int dtype, int cosine, const void* q, const void* k, const void* v,
                              int64_t s_w, int64_t s_h, int64_t s_n, void* out, int64_t o_w,
                              int64_t o_h, int64_t o_n, const float* bias, const float* mask,
                              int n_masks, const float* scales, int windows, int heads, int n,
                              int d, void* stream) {
  if (n < MIN_N || d != D || windows < 1 || heads < 1 || heads > 65535 ||
      (mask && (n_masks < 1 || windows % n_masks)))
    return static_cast<int>(cudaErrorInvalidValue);
  Args g{q, k, v, s_w, s_h, s_n, out, o_w, o_h, o_n, bias, mask, mask ? n_masks : 1, scales, n};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1) {
    if (!(aligned16(q) && aligned16(k) && aligned16(v) && aligned16(out) && aligned16(bias) &&
          aligned16(mask)) ||
        (s_w | s_h | s_n | o_w | o_h | o_n) % 8)
      return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid(windows, (n + tc::SLAB - 1) / tc::SLAB, heads);
    const size_t smem = tc::smem_bytes(n, cosine != 0);
    err = cosine ? launch(tc::attn_bf16<true>, grid, tc::THREADS, smem, s, g)
                 : launch(tc::attn_bf16<false>, grid, tc::THREADS, smem, s, g);
  } else if (dtype == 0) {
    const dim3 grid(windows, (n + simt::MQ - 1) / simt::MQ, heads);
    const size_t smem = simt::smem_bytes();
    err = cosine ? launch(simt::attn_f32<true>, grid, simt::THREADS, smem, s, g)
                 : launch(simt::attn_f32<false>, grid, simt::THREADS, smem, s, g);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

extern "C" const char* k6_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

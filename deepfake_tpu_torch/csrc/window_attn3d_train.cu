// K5: training window attention for Video Swin's 3D windows (N <= 512
// tokens, 392 for (8,7,7) windows), head dim 32, token-major, with its
// backward. For each (window w, head h), s = scale:
//
//   forward:  out = softmax_rows((q s) k^T + bias[h] + mask[w % n_masks]) v
//             (the max-stabilised f32 softmax)
//   backward: P recomputed from q, k and the bias in the COMPUTE type;
//             dV = P^T dO;  dP = dO V^T;  dS = P o (dP - rowsum(dP o P));
//             dQ = dS K s;  dK = dS^T Q s;  dbias[h] = sum over windows of dS (f32)
//
// Replaces the Pallas kernels of the training route
//   deepfake_tpu/ops/pallas_window_attn.py:1074 pallas_window_attention_nhc_train,
//     a custom_vjp (:1010-1071) whose forward is _run_nhc (:320, _nhc_kernel
//     :243, cfg no_max=False, mxu_bf16=False) and whose backward is
//     _run_nhc_bwd (:966, _nhc_bwd_kernel :888).
// q, k and v are [B_, N, C] with heads in channel slices, read straight out
// of one [B_, N, 3C] qkv tensor by strides; dq, dk and dv are written into
// one [B_, N, 3C] gradient buffer the same way, so there is no split or
// concat. The mask is read in bf16 ({0, -100} are exact).
//
// Cast points (the Pallas defaults): f32 logits from q s and k; + bias (f32
// in the forward, the bias cast to the compute type in the backward, as
// `_nhc_train_bwd` passes `bias.astype(q.dtype)`) + mask; max-stabilised f32
// softmax; f32 products; outputs cast to the compute type, dbias f32.
//
// What bounds it on the H100 (3.35 TB/s, 989 TFLOP/s bf16), per b8
// micro-batch of Video Swin-S (24 launches each way): the forward moves q, k,
// v and out once (the bytes of K3), ~0.79 ms; the backward moves q, k, v,
// dO in and dq, dk, dv out, with the bias, mask and dbias ~1.35 ms (stage 0:
// 0.16 ms a launch), above its bf16 tensor-core work (10 B_ H N^2 D
// operations, ~1.18 ms). Both are bound by bytes.
//
// Routes:
//   - bf16 (training): tensor cores, mma.sync m16n8k16 with bf16 inputs and
//     f32 accumulation; exponentials by the fast __expf (relative error
//     ~1e-6, far below the bf16 rounding of P and dS). q k^T and dO v^T take
//     the bf16 q, k, v, dO as they are, so their products are exact. P and
//     dS, f32 in the Pallas kernel, are rounded to bf16 where they feed P V,
//     P^T dO, dS K and dS^T Q (the JAX package's opt-in
//     DEEPFAKE_TPU_TRAIN_MXU_BF16=1 discipline, :1113);
//     the softmax, its statistics, dS itself and the dbias sums stay f32.
//     * forward: one block of 8 warps per (window, head), as K3, with an
//       online row max: K and V in shared memory, each warp streams keys 16
//       at a time over 16 query rows; nothing of [N, N] leaves registers.
//     * backward, launch 1 (dq and dbias): one block of 16 warps per (32-row
//       query slab, head, group of G windows): two row groups of 16 rows x
//       eight key groups (every eighth step of 16 keys). A first sweep
//       recomputes the row max, the row sum and rowsum(dP o P) (online, like
//       the forward); the key groups' partials meet in shared memory and are
//       saved as [B_, H, 3, NS] f32 for launch 2. A second sweep forms P, dP
//       and dS, adds dS into the block's f32 [32, N] dbias slab in shared
//       memory and accumulates dq, whose key-group partials are summed in
//       shared memory. The slab's bias rows sit in shared memory for the whole
//       group and the window's mask rows for the window, so the inner loops
//       read nothing from device memory. After its G windows the block adds
//       its slab into dbias with one atomic add per element, so the L2
//       reductions are 1/G of adding every window's dS (G = 16 at stages
//       0-1). The atomics make the order of that sum vary from run to run
//       (f32 rounding only).
//     * backward, launch 2 (dk, dv): one block of 8 warps per (window, head),
//       Q and dO and the row statistics in shared memory; each warp owns 16
//       keys and streams the queries (S^T = K Q^T, from the transposed bias
//       and mask the caller passes), accumulating dK and dV in registers.
//     Both backward launches take keys (launch 1) or queries (launch 2) in
//     K3's key_of order, so a thread's four logits of a row are consecutive
//     columns: one 8-byte bias load, one 8-byte mask load, one 16-byte dbias
//     add.
//   - f32 (parity runs only; a different kernel from the one that trains):
//     SIMT FMA. Forward as K3's f32 route with the row max; backward one
//     block per (16-row query tile, window, head) holding the [16, N] P and
//     dP tiles in shared memory, adding dK, dV and dbias with atomics into
//     zeroed f32 outputs.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int D = 32;       // head dim
constexpr int MAX_N = 512;  // tokens per window
typedef __nv_bfloat16 bf16;

struct FwdArgs {
  const void* q; const void* k; const void* v;
  int64_t s_w, s_h, s_n;           // q/k/v element strides (head dim contiguous)
  void* out; int64_t o_w, o_h, o_n;
  const float* bias;               // [heads, n, n] f32
  const bf16* mask; int n_masks;   // [n_masks, n, n] or null
  float scale;
  int n;
};

struct BwdArgs {
  const void* q; const void* k; const void* v;
  int64_t s_w, s_h, s_n;
  const void* dout; int64_t d_w, d_h, d_n;
  void* dq; void* dk; void* dv;    // share the strides g_*
  int64_t g_w, g_h, g_n;
  const void* bias;                // [heads, n, n] in the compute type
  const void* bias_t;              // its transpose per head (tensor-core route)
  const bf16* mask; const bf16* mask_t; int n_masks;
  float* stats;                    // [windows, heads, 3, ns] (tensor-core route)
  float* dbias;                    // [heads, n, n] f32, zeroed by the caller
  float scale;
  int n, ns, heads, windows, group;
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
__device__ __forceinline__ float mask_at(const bf16* m, int64_t at) {
  return m ? __bfloat162float(m[at]) : 0.f;
}

// ------------------------------------------------------------- f32: SIMT

namespace simt {

constexpr int MQ = 32, THREADS = 256, DP = D + 1;  // +1 pads off bank conflicts

__host__ __device__ constexpr size_t fwd_smem(int n) {
  return sizeof(float) * (2 * n * DP + MQ * DP + MQ * (n + 1) + MQ);
}

__global__ void __launch_bounds__(THREADS) fwd_f32(FwdArgs g) {
  extern __shared__ float sm[];
  const int N = g.n, NP = N + 1;
  float* ks = sm;              // [N][DP]
  float* vs = ks + N * DP;     // [N][DP]
  float* qs = vs + N * DP;     // [MQ][DP] q * scale
  float* ps = qs + MQ * DP;    // [MQ][NP] logits, then weights
  float* rs = ps + MQ * NP;    // [MQ] 1 / rowsum

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
  const bf16* mask = g.mask ? g.mask + (int64_t)(w % g.n_masks) * N * N : nullptr;
  for (int idx = tid; idx < rows * N; idx += THREADS) {
    const int i = idx / N, j = idx - i * N;
    const float* qi = qs + i * DP;
    const float* kj = ks + j * DP;
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < D; ++c) s = fmaf(qi[c], kj[c], s);
    const int64_t at = (int64_t)(q0 + i) * N + j;
    ps[i * NP + j] = (s + bias[at]) + mask_at(mask, at);
  }
  __syncthreads();

  for (int i = warp; i < rows; i += THREADS / 32) {
    float* p = ps + i * NP;
    float m = -INFINITY;
    for (int j = lane; j < N; j += 32) m = fmaxf(m, p[j]);
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < N; j += 32) {
      const float e = expf(p[j] - m);
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

constexpr int BMQ = 16;  // backward query tile: its smem fits N = 512

__host__ __device__ constexpr size_t bwd_smem(int n) {
  return sizeof(float) * (2 * n * DP + 2 * BMQ * DP + 2 * BMQ * (n + 1));
}

// dq is written; dk, dv and dbias are added with atomics into zeroed outputs
__global__ void __launch_bounds__(THREADS) bwd_f32(BwdArgs g) {
  extern __shared__ float sm[];
  const int N = g.n, NP = N + 1;
  float* ks = sm;              // [N][DP]
  float* vs = ks + N * DP;     // [N][DP]
  float* qs = vs + N * DP;     // [BMQ][DP] q * scale
  float* os = qs + BMQ * DP;   // [BMQ][DP] dO
  float* ps = os + BMQ * DP;   // [BMQ][NP] logits, then P
  float* dps = ps + BMQ * NP;  // [BMQ][NP] dP, then dS

  const int q0 = blockIdx.x * BMQ, w = blockIdx.y, h = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rows = min(BMQ, N - q0);
  const int64_t base = (int64_t)w * g.s_w + (int64_t)h * g.s_h;
  const float* Q = static_cast<const float*>(g.q) + base;
  const float* K = static_cast<const float*>(g.k) + base;
  const float* V = static_cast<const float*>(g.v) + base;
  const float* dO = static_cast<const float*>(g.dout) + (int64_t)w * g.d_w + (int64_t)h * g.d_h;

  for (int idx = tid; idx < N * D; idx += THREADS) {
    const int j = idx / D, c = idx % D;
    const int64_t off = (int64_t)j * g.s_n + c;
    ks[j * DP + c] = K[off];
    vs[j * DP + c] = V[off];
  }
  for (int idx = tid; idx < BMQ * D; idx += THREADS) {
    const int i = idx / D, c = idx % D;
    const bool ok = i < rows;
    qs[i * DP + c] = ok ? Q[(int64_t)(q0 + i) * g.s_n + c] * g.scale : 0.f;
    os[i * DP + c] = ok ? dO[(int64_t)(q0 + i) * g.d_n + c] : 0.f;
  }
  __syncthreads();

  const float* bias = static_cast<const float*>(g.bias) + (int64_t)h * N * N;
  const bf16* mask = g.mask ? g.mask + (int64_t)(w % g.n_masks) * N * N : nullptr;
  for (int idx = tid; idx < rows * N; idx += THREADS) {
    const int i = idx / N, j = idx - i * N;
    float s = 0.f, dp = 0.f;
#pragma unroll
    for (int c = 0; c < D; ++c) {
      s = fmaf(qs[i * DP + c], ks[j * DP + c], s);
      dp = fmaf(os[i * DP + c], vs[j * DP + c], dp);
    }
    const int64_t at = (int64_t)(q0 + i) * N + j;
    ps[i * NP + j] = (s + bias[at]) + mask_at(mask, at);
    dps[i * NP + j] = dp;
  }
  __syncthreads();

  // P = e / rowsum(e), e = exp(s - rowmax); dS = P (dP - rowsum(dP P))
  for (int i = warp; i < rows; i += THREADS / 32) {
    float* p = ps + i * NP;
    float* dp = dps + i * NP;
    float m = -INFINITY;
    for (int j = lane; j < N; j += 32) m = fmaxf(m, p[j]);
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < N; j += 32) {
      const float e = expf(p[j] - m);
      p[j] = e;
      sum += e;
    }
    const float r = 1.f / warp_sum(sum);
    float di = 0.f;
    for (int j = lane; j < N; j += 32) {
      const float pj = p[j] * r;
      p[j] = pj;
      di += dp[j] * pj;
    }
    di = warp_sum(di);
    for (int j = lane; j < N; j += 32) dp[j] = p[j] * (dp[j] - di);
  }
  __syncthreads();

  float* dbias = g.dbias + (int64_t)h * N * N;
  for (int idx = tid; idx < rows * N; idx += THREADS) {
    const int i = idx / N, j = idx - i * N;
    atomicAdd(dbias + (int64_t)(q0 + i) * N + j, dps[i * NP + j]);
  }
  const int64_t gb = (int64_t)w * g.g_w + (int64_t)h * g.g_h;
  float* dQ = static_cast<float*>(g.dq) + gb;
  for (int idx = tid; idx < rows * D; idx += THREADS) {
    const int i = idx / D, c = idx % D;
    const float* di = dps + i * NP;
    float a = 0.f;
    for (int j = 0; j < N; ++j) a = fmaf(di[j], ks[j * DP + c], a);
    dQ[(int64_t)(q0 + i) * g.g_n + c] = a * g.scale;
  }
  float* dK = static_cast<float*>(g.dk) + gb;
  float* dV = static_cast<float*>(g.dv) + gb;
  for (int idx = tid; idx < N * D; idx += THREADS) {
    const int j = idx / D, c = idx % D;
    float a = 0.f, b = 0.f;
    for (int i = 0; i < rows; ++i) {
      a = fmaf(dps[i * NP + j], qs[i * DP + c], a);  // dS^T (q s)
      b = fmaf(ps[i * NP + j], os[i * DP + c], b);   // P^T dO
    }
    atomicAdd(dK + (int64_t)j * g.g_n + c, a);
    atomicAdd(dV + (int64_t)j * g.g_n + c, b);
  }
}

}  // namespace simt

// ------------------------------------------------------ bf16: tensor cores

namespace tc {

constexpr int WARPS = 8, THREADS = 32 * WARPS;
constexpr int LD = D + 8;  // smem row stride in bf16 (80 bytes): the 8 rows of a
                           // fragment load fall on distinct banks
// backward launch 1: DQ_ROWS row groups of 16 query rows x DQ_KEYS key groups
constexpr int DQ_ROWS = 2, DQ_KEYS = 8, DQ_THREADS = 32 * DQ_ROWS * DQ_KEYS, SLAB = 16 * DQ_ROWS;

__host__ __device__ constexpr int pad16(int n) { return (n + 15) & ~15; }
// the least x >= n with x % m == r
__host__ __device__ constexpr int at_least(int n, int m, int r) {
  return n <= r ? r : (n - r + m - 1) / m * m + r;
}
// row strides of launch 1's shared slabs. bf16 bias and mask rows: == 16
// (mod 64) elements, so a warp's 8-byte reads (8 rows x 4 key quads) fall on
// distinct banks per half-warp; the f32 dbias rows: == 16 (mod 32), so its
// 16-byte adds fall on distinct banks per quarter-warp
__host__ __device__ constexpr int bslab_ld(int n) { return at_least(n, 64, 16); }
__host__ __device__ constexpr int dslab_ld(int n) { return at_least(n, 32, 16); }
// the window's mask rows, then (after sweep 2) the key groups' dq partials
__host__ __device__ constexpr size_t dq_region(int n) {
  return sizeof(uint16_t) * SLAB * bslab_ld(n) > sizeof(float) * DQ_KEYS * SLAB * D
             ? sizeof(uint16_t) * SLAB * bslab_ld(n)
             : sizeof(float) * DQ_KEYS * SLAB * D;
}
__host__ __device__ constexpr size_t fwd_smem(int n) {
  return sizeof(uint16_t) * 2 * pad16(n) * LD;
}
__host__ __device__ constexpr size_t dq_smem(int n) {
  return sizeof(uint16_t) * 2 * pad16(n) * LD + sizeof(float) * SLAB * dslab_ld(n) +
         sizeof(uint16_t) * SLAB * bslab_ld(n) + dq_region(n) + sizeof(float) * DQ_KEYS * SLAB * 3;
}
__host__ __device__ constexpr size_t dkdv_smem(int n) {
  return sizeof(uint16_t) * 2 * pad16(n) * LD + sizeof(float) * 3 * pad16(n);
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

// A fragments (16 rows x 32 columns, two k steps) of rows r0 + g8 and
// r0 + g8 + 8 of a bf16 [rows, 32] view with row stride sn; rows >= n are 0
__device__ __forceinline__ void load_a(uint32_t (&a)[2][4], const bf16* X, int64_t sn, int r0,
                                       int n, int g8, int t4) {
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + g8 + ((e & 1) ? 8 : 0);
      const int col = s * 16 + (e >> 1) * 8 + 2 * t4;
      a[s][e] = row < n ? *reinterpret_cast<const uint32_t*>(X + (int64_t)row * sn + col) : 0u;
    }
}

// rows [0, nk) of a bf16 [*, 32] view into shared memory [nk][LD], rows >= n
// zero; 16-byte loads (the host checks alignment)
__device__ __forceinline__ void load_rows(uint16_t* dst, const bf16* X, int64_t sn, int n, int nk,
                                          int tid, int threads) {
  for (int c = tid; c < nk * (D / 8); c += threads) {
    const int j = c / (D / 8), part = (c % (D / 8)) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (j < n) val = *reinterpret_cast<const uint4*>(X + (int64_t)j * sn + part);
    *reinterpret_cast<uint4*>(dst + j * LD + part) = val;
  }
}

// the two n8 tiles of (16 rows) x (16 smem rows from j0): acc[nt] = A B^T,
// with B rows j0 + rb[nt] of a [*, LD] tile (rb: this lane's row of each
// n8 tile, in key_of order)
__device__ __forceinline__ void mma_rows(float (&acc)[2][4], const uint32_t (&a)[2][4],
                                         const uint16_t* tile, int j0, int rb0, int rb1,
                                         int t4) {
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
    const uint16_t* r = tile + (j0 + (nt ? rb1 : rb0)) * LD;
#pragma unroll
    for (int st = 0; st < 2; ++st) {
      const uint32_t b[2] = {ld32(r + st * 16 + 2 * t4), ld32(r + st * 16 + 8 + 2 * t4)};
      mma_bf16(acc[nt], a[st], b);
    }
  }
}

// acc[dn] += A (16 x 16, k over tile rows j0 + key_of(0 .. 15)) *
// tile[those rows][dn * 8 ..]; kv_row = key_of(lane & 15)
__device__ __forceinline__ void mma_cols(float (&acc)[4][4], const uint32_t (&a)[4],
                                         const uint16_t* tile, int j0, int kv_row) {
#pragma unroll
  for (int dn = 0; dn < 4; ++dn) {
    uint32_t b[2];
    ldmatrix_x2_trans(b, tile + (j0 + kv_row) * LD + dn * 8);
    mma_bf16(acc[dn], a, b);
  }
}

// S/dP accumulator layout -> the A fragment of the next product (k over the
// 16 columns): tile nt, element i of rows a (i < 2) and b (i >= 2)
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&x)[2][4]) {
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    a[nt * 2] = pack_bf16(x[nt][0], x[nt][1]);
    a[nt * 2 + 1] = pack_bf16(x[nt][2], x[nt][3]);
  }
}

// Key offset, within a step of 16 keys, of k-position p of the mma tiles
// (as K3): thread t4's four weights of a row become the consecutive keys
// 4 t4 .. 4 t4 + 3, so their f32 bias is one 16-byte load and their mask one
// 8-byte load. K rows (for S) and V rows (for P V) are read in the same order.
__device__ __forceinline__ int key_of(int p) {
  const int q = p & 7;
  return 4 * (q >> 1) + (q & 1) + ((p >> 3) << 1);
}

// bias and mask of one row at keys k4 .. k4 + 3; a key past n, or a row past
// n, gets bias -inf and so weight 0
__device__ __forceinline__ void load_add(float (&b)[4], float (&m)[4], const float* brow,
                                         const bf16* mrow, bool row_ok, int k4, int n, bool vec) {
  if (row_ok && vec && k4 + 3 < n) {
    const float4 v = *reinterpret_cast<const float4*>(brow + k4);
    b[0] = v.x; b[1] = v.y; b[2] = v.z; b[3] = v.w;
    if (mrow) {
      const uint2 u = *reinterpret_cast<const uint2*>(mrow + k4);
      const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
      const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
      m[0] = __low2float(lo); m[1] = __high2float(lo);
      m[2] = __low2float(hi); m[3] = __high2float(hi);
    } else {
      m[0] = m[1] = m[2] = m[3] = 0.f;
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const bool ok = row_ok && k4 + i < n;
    b[i] = ok ? brow[k4 + i] : -INFINITY;
    m[i] = ok && mrow ? __bfloat162float(mrow[k4 + i]) : 0.f;
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

// forward: one block per (window, head); K and V in shared memory; each warp
// takes groups of 16 query rows. Needs q, k, v, out, bias and mask 16-byte
// aligned and every stride a multiple of 8 elements (the host checks).
__global__ void __launch_bounds__(THREADS, 2) fwd_bf16(FwdArgs g) {
  extern __shared__ __align__(16) uint16_t smb[];
  const int N = g.n, NK = pad16(N);
  uint16_t* ks = smb;           // [NK][LD]; read in key_of order within a step
  uint16_t* vs = ks + NK * LD;  // [NK][LD]

  const int w = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t base = (int64_t)w * g.s_w + (int64_t)h * g.s_h;
  const bf16* Q = static_cast<const bf16*>(g.q) + base;
  load_rows(ks, static_cast<const bf16*>(g.k) + base, g.s_n, N, NK, tid, THREADS);
  load_rows(vs, static_cast<const bf16*>(g.v) + base, g.s_n, N, NK, tid, THREADS);
  __syncthreads();

  const float* bias = g.bias + (int64_t)h * N * N;
  const bf16* mask = g.mask ? g.mask + (int64_t)(w % g.n_masks) * N * N : nullptr;
  const bool vec = N % 4 == 0;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int kb0 = key_of(g8), kb1 = key_of(8 + g8);
  const int kv_row = key_of(lane & 15);
  bf16* O = static_cast<bf16*>(g.out) + (int64_t)w * g.o_w + (int64_t)h * g.o_h;

  for (int r0 = warp * 16; r0 < N; r0 += WARPS * 16) {
    const int row_a = r0 + g8, row_b = row_a + 8;
    const bool ok_a = row_a < N, ok_b = row_b < N;
    uint32_t qa[2][4];
    load_a(qa, Q, g.s_n, r0, N, g8, t4);
    const float* brow_a = bias + (int64_t)(ok_a ? row_a : 0) * N;
    const float* brow_b = bias + (int64_t)(ok_b ? row_b : 0) * N;
    const bf16* mrow_a = mask ? mask + (int64_t)(ok_a ? row_a : 0) * N : nullptr;
    const bf16* mrow_b = mask ? mask + (int64_t)(ok_b ? row_b : 0) * N : nullptr;

    float o[4][4];
#pragma unroll
    for (int dn = 0; dn < 4; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[dn][e] = 0.f;
    float m_a = -INFINITY, m_b = -INFINITY, sum_a = 0.f, sum_b = 0.f;
    float ba[4], ma[4], bb[4], mb[4];
    load_add(ba, ma, brow_a, mrow_a, ok_a, 4 * t4, N, vec);
    load_add(bb, mb, brow_b, mrow_b, ok_b, 4 * t4, N, vec);

    for (int j0 = 0; j0 < NK; j0 += 16) {
      float nba[4], nma[4], nbb[4], nmb[4];
      const int k4 = j0 + 16 + 4 * t4;
      load_add(nba, nma, brow_a, mrow_a, ok_a, k4, N, vec);
      load_add(nbb, nmb, brow_b, mrow_b, ok_b, k4, N, vec);

      float s[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
        const uint16_t* kr = ks + (j0 + (nt ? kb1 : kb0)) * LD;
#pragma unroll
        for (int st = 0; st < 2; ++st) {
          const uint32_t b[2] = {ld32(kr + st * 16 + 2 * t4), ld32(kr + st * 16 + 8 + 2 * t4)};
          mma_bf16(s[nt], qa[st], b);
        }
      }
      // logits (q.k) s + bias + mask; tile nt, element i of row a is key
      // 4 t4 + 2 nt + i
      float xa[4], xb[4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int c = 2 * nt + i;
          xa[c] = (s[nt][i] * g.scale + ba[c]) + ma[c];
          xb[c] = (s[nt][2 + i] * g.scale + bb[c]) + mb[c];
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
      float p[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int c = 2 * nt + i;
          p[nt][i] = __expf(xa[c] - base_a);
          p[nt][2 + i] = __expf(xb[c] - base_b);
          sum_a += p[nt][i];
          sum_b += p[nt][2 + i];
        }
      uint32_t pa[4];
      pack_a(pa, p);
#pragma unroll
      for (int dn = 0; dn < 4; ++dn) {
        uint32_t vb[2];
        ldmatrix_x2_trans(vb, vs + (j0 + kv_row) * LD + dn * 8);
        mma_bf16(o[dn], pa, vb);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        ba[c] = nba[c]; ma[c] = nma[c]; bb[c] = nbb[c]; mb[c] = nmb[c];
      }
    }

    const float ra = 1.f / quad_sum(sum_a), rb = 1.f / quad_sum(sum_b);
#pragma unroll
    for (int dn = 0; dn < 4; ++dn) {
      const int c = dn * 8 + 2 * t4;
      if (ok_a)
        *reinterpret_cast<__nv_bfloat162*>(O + (int64_t)row_a * g.o_n + c) =
            __floats2bfloat162_rn(o[dn][0] * ra, o[dn][1] * ra);
      if (ok_b)
        *reinterpret_cast<__nv_bfloat162*>(O + (int64_t)row_b * g.o_n + c) =
            __floats2bfloat162_rn(o[dn][2] * rb, o[dn][3] * rb);
    }
  }
}

// four consecutive bf16 values row[k4 .. k4 + 3] as f32; entries at or past
// n read as 0 (8-byte loads where vec: the caller knows the alignment)
__device__ __forceinline__ void load4(float (&v)[4], const uint16_t* row, int k4, int n,
                                      bool vec) {
  if (vec && k4 + 3 < n) {
    const uint2 u = *reinterpret_cast<const uint2*>(row + k4);
    const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
    const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
    v[0] = __low2float(lo); v[1] = __high2float(lo);
    v[2] = __low2float(hi); v[3] = __high2float(hi);
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint16_t u = k4 + i < n ? row[k4 + i] : uint16_t(0);
    v[i] = __bfloat162float(*reinterpret_cast<const bf16*>(&u));
  }
}

// logits x[nt][e] = s[nt][e] * scale + bias + mask of rows a (e < 2) and b
// (e >= 2) at column k4 + 2 nt + (e & 1) (the key_of order), from bf16 rows
// (mask rows may be null); columns at or past n are -inf
__device__ __forceinline__ void logits4(float (&x)[2][4], const float (&s)[2][4], float scale,
                                        const uint16_t* brow_a, const uint16_t* brow_b,
                                        const uint16_t* mrow_a, const uint16_t* mrow_b, int k4,
                                        int n, bool vec) {
  float ba[4], bb[4], ma[4] = {0.f, 0.f, 0.f, 0.f}, mb[4] = {0.f, 0.f, 0.f, 0.f};
  load4(ba, brow_a, k4, n, vec);
  load4(bb, brow_b, k4, n, vec);
  if (mrow_a) {
    load4(ma, mrow_a, k4, n, vec);
    load4(mb, mrow_b, k4, n, vec);
  }
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = 2 * nt + i;
      const bool ok = k4 + c < n;
      x[nt][i] = ok ? (s[nt][i] * scale + ba[c]) + ma[c] : -INFINITY;
      x[nt][2 + i] = ok ? (s[nt][2 + i] * scale + bb[c]) + mb[c] : -INFINITY;
    }
}

// rows [0, SLAB) x columns [0, n) of a bf16 [*, n] matrix from row r0 into a
// shared [SLAB][ld] slab; rows at or past n are 0
__device__ __forceinline__ void load_slab(uint16_t* dst, const bf16* src, int r0, int n, int ld,
                                          int tid) {
  const uint16_t* s = reinterpret_cast<const uint16_t*>(src);
  if (n % 8 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0) {
    for (int i = tid; i < SLAB * (n / 8); i += DQ_THREADS) {
      const int r = i / (n / 8), c = (i % (n / 8)) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r0 + r < n) v = *reinterpret_cast<const uint4*>(s + (int64_t)(r0 + r) * n + c);
      *reinterpret_cast<uint4*>(dst + r * ld + c) = v;
    }
    return;
  }
  for (int i = tid; i < SLAB * n; i += DQ_THREADS) {
    const int r = i / n, c = i - r * n;
    dst[r * ld + c] = r0 + r < n ? s[(int64_t)(r0 + r) * n + c] : uint16_t(0);
  }
}

// backward launch 1: grid (query slabs of SLAB rows, heads, window groups of
// g.group). Warp (rg, kg) owns query rows rg * 16 .. + 15 of the slab and the
// key steps kg, kg + DQ_KEYS, ...; the key groups' row statistics and dq
// partials meet in shared memory. The slab's bias rows stay in shared memory
// for the whole group, the window's mask rows for the window; dS of the
// group's windows sums in the f32 dbias slab, added to dbias once at the end.
__global__ void __launch_bounds__(DQ_THREADS) bwd_dq_bf16(BwdArgs g) {
  extern __shared__ __align__(16) uint16_t smb[];
  const int N = g.n, NK = pad16(N), SL = dslab_ld(N), BL = bslab_ld(N);
  uint16_t* ks = smb;                                         // [NK][LD]
  uint16_t* vs = ks + NK * LD;                                // [NK][LD]
  float* dbs = reinterpret_cast<float*>(vs + NK * LD);        // [SLAB][SL] dbias slab
  uint16_t* bsl = reinterpret_cast<uint16_t*>(dbs + SLAB * SL);  // [SLAB][BL] bias rows
  uint16_t* msl = bsl + SLAB * BL;                            // [SLAB][BL] mask rows, then
  float* dqp = reinterpret_cast<float*>(msl);                 // [DQ_KEYS][SLAB][D] dq partials
  float* stp = reinterpret_cast<float*>(reinterpret_cast<char*>(msl) + dq_region(N));
                                                              // [DQ_KEYS][SLAB][3] m, l, c
  const int h = blockIdx.y;
  const int w0 = blockIdx.z * g.group, w1 = min(w0 + g.group, g.windows);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rg = warp % DQ_ROWS, kg = warp / DQ_ROWS;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int kb0 = key_of(g8), kb1 = key_of(8 + g8), kv_row = key_of(lane & 15);
  const int slab0 = blockIdx.x * SLAB, r0 = slab0 + rg * 16;
  const int lr_a = rg * 16 + g8, lr_b = lr_a + 8;  // rows within the slab
  const int row_a = slab0 + lr_a, row_b = slab0 + lr_b;
  const bool ok_a = row_a < N, ok_b = row_b < N, active = r0 < N;
  const int steps = NK / 16;

  for (int i = tid; i < SLAB * SL; i += DQ_THREADS) dbs[i] = 0.f;
  load_slab(bsl, static_cast<const bf16*>(g.bias) + (int64_t)h * N * N, slab0, N, BL, tid);
  const uint16_t* brow_a = bsl + lr_a * BL;
  const uint16_t* brow_b = bsl + lr_b * BL;
  const uint16_t* mrow_a = g.mask ? msl + lr_a * BL : nullptr;
  const uint16_t* mrow_b = g.mask ? msl + lr_b * BL : nullptr;

  for (int w = w0; w < w1; ++w) {
    const int64_t base = (int64_t)w * g.s_w + (int64_t)h * g.s_h;
    __syncthreads();  // the previous window is done with ks, vs and msl / dqp
    load_rows(ks, static_cast<const bf16*>(g.k) + base, g.s_n, N, NK, tid, DQ_THREADS);
    load_rows(vs, static_cast<const bf16*>(g.v) + base, g.s_n, N, NK, tid, DQ_THREADS);
    if (g.mask) load_slab(msl, g.mask + (int64_t)(w % g.n_masks) * N * N, slab0, N, BL, tid);
    __syncthreads();

    uint32_t qa[2][4], oa[2][4];
    if (active) {
      load_a(qa, static_cast<const bf16*>(g.q) + base, g.s_n, r0, N, g8, t4);
      load_a(oa, static_cast<const bf16*>(g.dout) + (int64_t)w * g.d_w + (int64_t)h * g.d_h,
             g.d_n, r0, N, g8, t4);
      // sweep 1 over this warp's keys: row max m, row sum l and sum(e dP)
      // c, online
      float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f, c_a = 0.f, c_b = 0.f;
      for (int st = kg; st < steps; st += DQ_KEYS) {
        const int j0 = st * 16;
        float sc[2][4], dp[2][4], x[2][4];
        mma_rows(sc, qa, ks, j0, kb0, kb1, t4);
        mma_rows(dp, oa, vs, j0, kb0, kb1, t4);
        logits4(x, sc, g.scale, brow_a, brow_b, mrow_a, mrow_b, j0 + 4 * t4, N, true);
        float base_a, base_b;
        const float al_a = online_max(
            m_a, fmaxf(fmaxf(x[0][0], x[0][1]), fmaxf(x[1][0], x[1][1])), base_a);
        const float al_b = online_max(
            m_b, fmaxf(fmaxf(x[0][2], x[0][3]), fmaxf(x[1][2], x[1][3])), base_b);
        l_a *= al_a; c_a *= al_a;
        l_b *= al_b; c_b *= al_b;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const float ea = __expf(x[nt][i] - base_a), eb = __expf(x[nt][2 + i] - base_b);
            l_a += ea; c_a += ea * dp[nt][i];
            l_b += eb; c_b += eb * dp[nt][2 + i];
          }
      }
      l_a = quad_sum(l_a); c_a = quad_sum(c_a);
      l_b = quad_sum(l_b); c_b = quad_sum(c_b);
      if (t4 == 0) {
        float* pa = stp + (kg * SLAB + lr_a) * 3;
        float* pb = stp + (kg * SLAB + lr_b) * 3;
        pa[0] = m_a; pa[1] = l_a; pa[2] = c_a;
        pb[0] = m_b; pb[1] = l_b; pb[2] = c_b;
      }
    }
    __syncthreads();

    float dq[4][4];
#pragma unroll
    for (int dn = 0; dn < 4; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) dq[dn][e] = 0.f;
    if (active) {
      // the key groups' statistics of rows a and b combined
      float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
      for (int k = 0; k < DQ_KEYS; ++k) {
        mx_a = fmaxf(mx_a, stp[(k * SLAB + lr_a) * 3]);
        mx_b = fmaxf(mx_b, stp[(k * SLAB + lr_b) * 3]);
      }
      float l_a = 0.f, l_b = 0.f, c_a = 0.f, c_b = 0.f;
#pragma unroll
      for (int k = 0; k < DQ_KEYS; ++k) {
        const float* pa = stp + (k * SLAB + lr_a) * 3;
        const float* pb = stp + (k * SLAB + lr_b) * 3;
        const float fa = __expf(pa[0] - mx_a), fb = __expf(pb[0] - mx_b);  // -inf: 0
        l_a += pa[1] * fa; c_a += pa[2] * fa;
        l_b += pb[1] * fb; c_b += pb[2] * fb;
      }
      const float il_a = 1.f / l_a, il_b = 1.f / l_b;
      const float di_a = c_a * il_a, di_b = c_b * il_b;
      if (kg == 0 && t4 == 0) {
        float* st = g.stats + ((int64_t)w * g.heads + h) * 3 * g.ns;
        if (ok_a) { st[row_a] = mx_a; st[g.ns + row_a] = il_a; st[2 * g.ns + row_a] = di_a; }
        if (ok_b) { st[row_b] = mx_b; st[g.ns + row_b] = il_b; st[2 * g.ns + row_b] = di_b; }
      }

      // sweep 2: P, dS; the dbias slab += dS; dq += dS K
      for (int st = kg; st < steps; st += DQ_KEYS) {
        const int j0 = st * 16, k4 = j0 + 4 * t4;
        float sc[2][4], dp[2][4], x[2][4], ds[2][4];
        mma_rows(sc, qa, ks, j0, kb0, kb1, t4);
        mma_rows(dp, oa, vs, j0, kb0, kb1, t4);
        logits4(x, sc, g.scale, brow_a, brow_b, mrow_a, mrow_b, k4, N, true);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            ds[nt][i] = __expf(x[nt][i] - mx_a) * il_a * (dp[nt][i] - di_a);
            ds[nt][2 + i] = __expf(x[nt][2 + i] - mx_b) * il_b * (dp[nt][2 + i] - di_b);
          }
        float* da4 = dbs + lr_a * SL + k4;
        float* db4 = dbs + lr_b * SL + k4;
        if (k4 + 3 < N) {
          float4 va = *reinterpret_cast<float4*>(da4), vb = *reinterpret_cast<float4*>(db4);
          va.x += ds[0][0]; va.y += ds[0][1]; va.z += ds[1][0]; va.w += ds[1][1];
          vb.x += ds[0][2]; vb.y += ds[0][3]; vb.z += ds[1][2]; vb.w += ds[1][3];
          *reinterpret_cast<float4*>(da4) = va;
          *reinterpret_cast<float4*>(db4) = vb;
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (k4 + c < N) {
              da4[c] += ds[c >> 1][c & 1];
              db4[c] += ds[c >> 1][2 + (c & 1)];
            }
        }
        uint32_t da[4];
        pack_a(da, ds);
        mma_cols(dq, da, ks, j0, kv_row);
      }
    }
    __syncthreads();  // every warp is done with msl: it becomes the dq partials
    if (active) {
#pragma unroll
      for (int dn = 0; dn < 4; ++dn) {
        const int c = dn * 8 + 2 * t4;
        *reinterpret_cast<float2*>(dqp + (kg * SLAB + lr_a) * D + c) =
            make_float2(dq[dn][0], dq[dn][1]);
        *reinterpret_cast<float2*>(dqp + (kg * SLAB + lr_b) * D + c) =
            make_float2(dq[dn][2], dq[dn][3]);
      }
    }
    __syncthreads();
    bf16* dQ = static_cast<bf16*>(g.dq) + (int64_t)w * g.g_w + (int64_t)h * g.g_h;
    for (int i = tid; i < SLAB * D / 2; i += DQ_THREADS) {
      const int r = i / (D / 2), c = (i % (D / 2)) * 2;
      if (slab0 + r >= N) continue;
      float2 sum = make_float2(0.f, 0.f);
#pragma unroll
      for (int k = 0; k < DQ_KEYS; ++k) {
        const float2 v = *reinterpret_cast<const float2*>(dqp + (k * SLAB + r) * D + c);
        sum.x += v.x;
        sum.y += v.y;
      }
      *reinterpret_cast<__nv_bfloat162*>(dQ + (int64_t)(slab0 + r) * g.g_n + c) =
          __floats2bfloat162_rn(sum.x * g.scale, sum.y * g.scale);
    }
  }
  __syncthreads();
  float* dbias = g.dbias + (int64_t)h * N * N;
  const int rows = min(SLAB, N - slab0);
  for (int i = tid; i < rows * N; i += DQ_THREADS) {
    const int r = i / N, c = i - r * N;
    atomicAdd(dbias + (int64_t)(slab0 + r) * N + c, dbs[r * SL + c]);
  }
}

// backward launch 2: one block per (window, head); Q, dO and the row
// statistics in shared memory; each warp owns 16 keys at a time and streams
// the queries 16 at a time (in key_of order, so a thread's four queries of a
// key are consecutive: their transposed bias and mask are one 8-byte load,
// their statistics one 16-byte load each): S^T = K Q^T, P^T, dP^T = V dO^T,
// dS^T; dV += P^T dO, dK += dS^T Q.
__global__ void __launch_bounds__(THREADS, 2) bwd_dkdv_bf16(BwdArgs g) {
  extern __shared__ __align__(16) uint16_t smb[];
  const int N = g.n, NQ = pad16(N);
  uint16_t* qs = smb;                                   // [NQ][LD]
  uint16_t* os = qs + NQ * LD;                          // [NQ][LD] dO
  float* sm_m = reinterpret_cast<float*>(os + NQ * LD);  // [NQ] row max
  float* sm_il = sm_m + NQ;                             // [NQ] 1 / rowsum
  float* sm_di = sm_il + NQ;                            // [NQ] rowsum(dP P)

  const int w = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int kb0 = key_of(g8), kb1 = key_of(8 + g8), kv_row = key_of(lane & 15);
  const int64_t base = (int64_t)w * g.s_w + (int64_t)h * g.s_h;
  load_rows(qs, static_cast<const bf16*>(g.q) + base, g.s_n, N, NQ, tid, THREADS);
  load_rows(os, static_cast<const bf16*>(g.dout) + (int64_t)w * g.d_w + (int64_t)h * g.d_h,
            g.d_n, N, NQ, tid, THREADS);
  const float* st = g.stats + ((int64_t)w * g.heads + h) * 3 * g.ns;
  for (int i = tid; i < NQ; i += THREADS) {
    const bool ok = i < N;
    sm_m[i] = ok ? st[i] : 0.f;
    sm_il[i] = ok ? st[g.ns + i] : 0.f;
    sm_di[i] = ok ? st[2 * g.ns + i] : 0.f;
  }
  __syncthreads();

  const uint16_t* bias_t = static_cast<const uint16_t*>(g.bias_t) + (int64_t)h * N * N;
  const uint16_t* mask_t = g.mask_t ? reinterpret_cast<const uint16_t*>(g.mask_t) +
                                          (int64_t)(w % g.n_masks) * N * N
                                    : nullptr;
  const bool vec = N % 4 == 0;
  const bf16* K = static_cast<const bf16*>(g.k) + base;
  const bf16* V = static_cast<const bf16*>(g.v) + base;
  const int64_t gb = (int64_t)w * g.g_w + (int64_t)h * g.g_h;

  for (int j0 = warp * 16; j0 < N; j0 += WARPS * 16) {
    const int key_a = j0 + g8, key_b = key_a + 8;
    const bool ok_a = key_a < N, ok_b = key_b < N;
    uint32_t ka[2][4], va[2][4];
    load_a(ka, K, g.s_n, j0, N, g8, t4);
    load_a(va, V, g.s_n, j0, N, g8, t4);
    const uint16_t* brow_a = bias_t + (int64_t)(ok_a ? key_a : 0) * N;
    const uint16_t* brow_b = bias_t + (int64_t)(ok_b ? key_b : 0) * N;
    const uint16_t* mrow_a = mask_t ? mask_t + (int64_t)(ok_a ? key_a : 0) * N : nullptr;
    const uint16_t* mrow_b = mask_t ? mask_t + (int64_t)(ok_b ? key_b : 0) * N : nullptr;
    float dk[4][4], dv[4][4];
#pragma unroll
    for (int dn = 0; dn < 4; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[dn][e] = dv[dn][e] = 0.f;

    for (int i0 = 0; i0 < NQ; i0 += 16) {
      const int q4 = i0 + 4 * t4;
      float sc[2][4], dp[2][4], x[2][4];
      mma_rows(sc, ka, qs, i0, kb0, kb1, t4);
      mma_rows(dp, va, os, i0, kb0, kb1, t4);
      logits4(x, sc, g.scale, brow_a, brow_b, mrow_a, mrow_b, q4, N, vec);
      const float4 m4 = *reinterpret_cast<const float4*>(sm_m + q4);
      const float4 il4 = *reinterpret_cast<const float4*>(sm_il + q4);
      const float4 di4 = *reinterpret_cast<const float4*>(sm_di + q4);
      const float mq[4] = {m4.x, m4.y, m4.z, m4.w}, ilq[4] = {il4.x, il4.y, il4.z, il4.w};
      const float diq[4] = {di4.x, di4.y, di4.z, di4.w};
      float p[2][4], ds[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 2 * nt + (e & 1);
          const bool ok = (e < 2 ? ok_a : ok_b) && q4 + c < N;
          const float pv = ok ? __expf(x[nt][e] - mq[c]) * ilq[c] : 0.f;
          p[nt][e] = pv;
          ds[nt][e] = pv * (dp[nt][e] - diq[c]);
        }
      uint32_t pa[4], da[4];
      pack_a(pa, p);
      pack_a(da, ds);
      mma_cols(dv, pa, os, i0, kv_row);
      mma_cols(dk, da, qs, i0, kv_row);
    }
    bf16* dK = static_cast<bf16*>(g.dk) + gb;
    bf16* dV = static_cast<bf16*>(g.dv) + gb;
#pragma unroll
    for (int dn = 0; dn < 4; ++dn) {
      const int c = dn * 8 + 2 * t4;
      if (ok_a) {
        *reinterpret_cast<__nv_bfloat162*>(dK + (int64_t)key_a * g.g_n + c) =
            __floats2bfloat162_rn(dk[dn][0] * g.scale, dk[dn][1] * g.scale);
        *reinterpret_cast<__nv_bfloat162*>(dV + (int64_t)key_a * g.g_n + c) =
            __floats2bfloat162_rn(dv[dn][0], dv[dn][1]);
      }
      if (ok_b) {
        *reinterpret_cast<__nv_bfloat162*>(dK + (int64_t)key_b * g.g_n + c) =
            __floats2bfloat162_rn(dk[dn][2] * g.scale, dk[dn][3] * g.scale);
        *reinterpret_cast<__nv_bfloat162*>(dV + (int64_t)key_b * g.g_n + c) =
            __floats2bfloat162_rn(dv[dn][2], dv[dn][3]);
      }
    }
  }
}

}  // namespace tc

template <typename Kernel, typename Args>
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

bool bad_shape(int n, int d, int windows, int heads, const void* mask, int n_masks) {
  return n < 1 || n > MAX_N || d != D || windows < 1 || windows > 65535 || heads < 1 ||
         heads > 65535 || (mask && (n_masks < 1 || windows % n_masks));
}

}  // namespace

// dtype: 0 float32 (SIMT), 1 bfloat16 (tensor cores). Returns
// cudaGetLastError(), or cudaErrorInvalidValue for arguments the kernels do
// not take.
extern "C" int k5_fwd(int dtype, const void* q, const void* k, const void* v, int64_t s_w,
                      int64_t s_h, int64_t s_n, void* out, int64_t o_w, int64_t o_h, int64_t o_n,
                      const float* bias, const void* mask, int n_masks, float scale, int windows,
                      int heads, int n, int d, void* stream) {
  if (bad_shape(n, d, windows, heads, mask, n_masks))
    return static_cast<int>(cudaErrorInvalidValue);
  FwdArgs g{q, k, v, s_w, s_h, s_n, out, o_w, o_h, o_n, bias, static_cast<const bf16*>(mask),
            mask ? n_masks : 1, scale, n};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (!(aligned16(q) && aligned16(k) && aligned16(v) && aligned16(out) && aligned16(bias) &&
          aligned16(mask)) ||
        (s_w | s_h | s_n | o_w | o_h | o_n) % 8)
      return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(
        launch(tc::fwd_bf16, dim3(windows, heads), tc::THREADS, tc::fwd_smem(n), s, g));
  }
  if (dtype == 0)
    return static_cast<int>(launch(simt::fwd_f32,
                                   dim3((n + simt::MQ - 1) / simt::MQ, windows, heads),
                                   simt::THREADS, simt::fwd_smem(n), s, g));
  return static_cast<int>(cudaErrorInvalidValue);
}

// The row-statistics stride the bf16 backward needs: stats holds
// windows * heads * 3 * k5_stats_stride(n) floats.
extern "C" int k5_stats_stride(int n) { return tc::pad16(n); }

// bias (and bias_t, its per-head transpose, bf16 only) in the compute type;
// mask and mask_t bf16 or null; dbias zeroed; for f32, dk and dv zeroed too
// (the SIMT route adds into them). group: windows per block of launch 1.
extern "C" int k5_bwd(int dtype, const void* q, const void* k, const void* v, int64_t s_w,
                      int64_t s_h, int64_t s_n, const void* dout, int64_t d_w, int64_t d_h,
                      int64_t d_n, void* dq, void* dk, void* dv, int64_t g_w, int64_t g_h,
                      int64_t g_n, const void* bias, const void* bias_t, const void* mask,
                      const void* mask_t, int n_masks, float* stats, float* dbias, float scale,
                      int windows, int heads, int n, int d, int group, void* stream) {
  if (bad_shape(n, d, windows, heads, mask, n_masks) || group < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs g{q, k, v, s_w, s_h, s_n, dout, d_w, d_h, d_n, dq, dk, dv, g_w, g_h, g_n, bias, bias_t,
            static_cast<const bf16*>(mask), static_cast<const bf16*>(mask_t), mask ? n_masks : 1,
            stats, dbias, scale, n, tc::pad16(n), heads, windows, group};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (!(aligned16(q) && aligned16(k) && aligned16(v) && aligned16(dout)) || !bias_t ||
        !stats || (mask && !mask_t) || (s_w | s_h | s_n | d_w | d_h | d_n) % 8 ||
        (g_w | g_h | g_n) % 2 || reinterpret_cast<uintptr_t>(dq) % 4 ||
        reinterpret_cast<uintptr_t>(dk) % 4 || reinterpret_cast<uintptr_t>(dv) % 4)
      return static_cast<int>(cudaErrorInvalidValue);
    const int groups = (windows + group - 1) / group;
    if (groups > 65535) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = launch(tc::bwd_dq_bf16, dim3((n + tc::SLAB - 1) / tc::SLAB, heads, groups),
                             tc::DQ_THREADS, tc::dq_smem(n), s, g);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(
        launch(tc::bwd_dkdv_bf16, dim3(windows, heads), tc::THREADS, tc::dkdv_smem(n), s, g));
  }
  if (dtype == 0)
    return static_cast<int>(launch(simt::bwd_f32,
                                   dim3((n + simt::BMQ - 1) / simt::BMQ, windows, heads),
                                   simt::THREADS, simt::bwd_smem(n), s, g));
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* k5_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

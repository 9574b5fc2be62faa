// K5: training window attention for Video Swin's 3D windows (any N: 392
// tokens for (8,7,7) windows, 784 for (16,7,7)), head dims 1 to 128,
// token-major, with its backward. For each (window w, head h), s = scale:
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
//   - bf16 forward (training), Hopper: window_attn_tile.cuh's kernel in its
//     MAX_STABLE form (shared with K3). One block per (head, group of G
//     windows that read one mask index, 64-row query tile; G from the host,
//     window_group in ops/window_attn3d_train.py) builds its [64, N] slice
//     of bias[h] + mask[i] once, in log2 units, in an f32 tile in shared
//     memory that every window of the group reads; a producer warp streams
//     q, K and V by TMA; three consumer warpgroups split the keys in chunks
//     of 64 (wgmma for S and P V), each with an online row max, and the
//     first adds the others' parts, each rescaled by 2^(m_c - m). A logit in
//     log2 units is one FMA, s (scale log2 e) + tile, the scale applied in
//     f32 after the bf16 product (the Pallas kernel's cast point), and a
//     weight ex2.approx of it less the row max; the weights are rounded to
//     bf16 for P V. The first design (one block per (window, head),
//     mma.sync, bias and mask read from device memory in the inner loop)
//     spent 38% of a micro-batch's launches on the mask's loads
//     (tools/k5f_step0.py, PERF.md).
//   - bf16 backward, Hopper (namespace hop): wgmma for every product, TMA
//     for q, k, v and dO, two launches. As in K3, the windows that read one
//     mask index (window w reads mask w % nW, windows come batch-major) share
//     one bias + mask tile per head, built once per block in shared memory,
//     and an unmasked launch groups any G windows (G from the host,
//     window_group in ops/window_attn3d_train.py, to fill the SMs' waves).
//     The tile is bf16 in launch 1: the bias is bf16 at this cast point, so
//     the tile is exact where the mask is 0; where it is -100 the weight is
//     below 1e-40 in either rounding. The tiles, the dbias slab and the row
//     statistics keep each run of 16 columns in the order of the wgmma
//     accumulator (pos_of), so a thread reads its 4 values of a row at once.
//     A weight is P = 2^((x - m) log2 e - log2 l), x = s scale + tile, m
//     the row max and l the row sum, kept apart: folded into one
//     log-sum-exp (m log2 e + log2 l) at the logits of a diverging run
//     (|x| ~ 1e12) log2 l falls below the ulp of m log2 e and a weight of
//     1/N reads 1; and x - m comes before the scaling, exact near the max
//     (an FMA x log2 e - m log2 e rounds m log2 e alone by more than ex2
//     takes there). Three flops and one ex2.approx.
//     * launch 1 (dq, dbias, the row statistics): one block per (head,
//       group, 64-row query tile), three warpgroups and no producer warp
//       (so a thread may keep 168 registers; a producer warp beside them
//       would cap it at 128). Thread 0 streams each window's q and dO tiles
//       and its whole K and V by TMA (3D tensor maps over the column slices
//       of qkv and dout, 64-byte swizzle, rows past N zero-filled) into a
//       ring of stages: one at N = 392, where the tile (51 KB) and the f32
//       dbias slab (102 KB) leave room for one window's K and V, two where
//       they fit. The warpgroups split the keys in chunks of 64. Sweep 1
//       forms S = q K^T and dP = dO V^T (wgmma m64n64k16, q and dO as
//       register A fragments) for the online row max, row sum and
//       rowsum(e dP); the warpgroups combine them through shared
//       memory and save (m, -log2 l, rowsum(dP P)) for launch 2. Sweep 2 forms S
//       and dP again, then P and dS = P (dP - rowsum(dP P)) in f32, adds dS
//       into the block's f32 [64, N] dbias slab, and re-packs dS in registers
//       as the bf16 A operand of dq += dS K (K read MN-major). Holding S and
//       dP of the tile instead (205 KB) does not fit beside the tile, the
//       slab and K and V; the second sweep repeats two products and one pass
//       of exponentials (PERF.md, K5 backward's Step 0). The other
//       warpgroups hand their dq to the first, which refills the stage (the
//       next window's loads start), then adds and stores. After its windows
//       the block stores its slab into a slot of its own in a workspace of
//       partial sums [n_groups splits, heads, N, N] f32; a third small
//       launch (wtile::mma::sum_parts) adds the slots into dbias in slot
//       order, so dbias repeats to the bit. Where the slab does not fit (N >
//       ~440) the block adds dS into its slot per window instead (zeroed
//       first; the thread that owns an element owns it in every window and
//       its adds apply in program order).
//     * launch 2 (dk, dv): one block per (head, group, 64-key tile), two
//       warpgroups and no producer warp: thread 0 streams each window's K
//       and V tiles, its whole q and dO and its row statistics (a bulk copy)
//       into a two-stage ring as stages free up, so that no SM sub-partition
//       holds three warps and a thread may keep ~200 registers (with a
//       producer warp ptxas capped them at 168 and spilled: 8% slower). The
//       block builds the transposed bias + mask tile [64 keys, N queries]
//       once from the untransposed bias and mask. The warpgroups split the
//       queries in chunks of 64: S^T = K q^T, dP^T = V dO^T, P^T and dS^T,
//       then dV += P^T dO and dK += dS^T q from the re-packed registers. dK
//       and dV of the block's keys are complete after each window: no
//       atomics.
//     What sets its time (PERF.md, K5 backward findings, diagnostic
//     builds): neither bytes nor the exponentials. In launch 2 the products
//     dV and dK (8 wgmma m64n32k16 a chunk, B read MN-major) take half the
//     time, twice what S^T and dP^T take for the same operations; in
//     launch 1 the two sweeps' products, the tile reads and the window's
//     exposed load share it with the elementwise work.
//     * above 512 tokens (wtile::WHOLE_N; Video Swin-B's (16,7,7) window, N
//       = 784) neither launch holds a whole window beside its tile: dq_stream
//       and dkdv_stream stream it in tiles of 192 keys (launch 1) or 128
//       queries (launch 2), the block moving through (window, [sweep,] tile)
//       items in step, a bf16 tile of the item's columns filled before each,
//       dS into the block's slot of the partial sums (no slab), the row statistics and dq, dk,
//       dv carried across a window's tiles.
//     Every mbarrier wait traps after 10 s (csrc/hopper.cuh), so a fault in
//     the schedule is a failed launch, not a hang.
//     The cast points are those of the JAX package's opt-in
//     DEEPFAKE_TPU_TRAIN_MXU_BF16=1 discipline (:1113): P and dS, f32 in
//     the Pallas kernel, are rounded to bf16 where they feed P V, P^T dO,
//     dS K and dS^T Q; the softmax, its statistics, dP, dS itself and the
//     dbias sums stay f32.
//   The Hopper routes are built for head dim 32 (every Video Swin head).
//     At other head dims bf16 takes window_attn_mma.cuh's tensor-core
//     kernels (mma.sync), forward and backward.
//   - f32 (parity runs only): SIMT FMA, any N. Forward K3's SIMT kernel
//     (window_attn_tile.cuh) with an online row max; backward one block per (16-row query tile, window,
//     head) sweeping K and V twice in tiles of 64 keys (the row statistics,
//     then P, dS and dq), adding dK, dV and dbias with atomics into zeroed
//     f32 outputs. Instances for heads of 32, 64 and 128 columns, a
//     narrower head zero-filled to the next.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "window_attn_mma.cuh"
#include "window_attn_tile.cuh"

namespace {

constexpr int D = 32;  // head dim
static_assert(D == wtile::mma::WGMMA_D, "the wgmma kernels' head dim");
typedef __nv_bfloat16 bf16;

struct BwdArgs {
  const void* q; const void* k; const void* v;
  int64_t s_w, s_h, s_n;
  const void* dout; int64_t d_w, d_h, d_n;
  void* dq; void* dk; void* dv;    // share the strides g_*
  int64_t g_w, g_h, g_n;
  const void* bias;                // [heads, n, n] in the compute type
  const bf16* mask; int n_masks;
  float* stats;                    // [windows, heads, 3, ns] (Hopper route)
  float* dbias;                    // [heads, n, n] f32, zeroed by the caller
  float* part;                     // [parts, heads, n, n] f32: each block's dS sums (bf16)
  float scale;
  int n, ns, heads, windows, group;
};

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

using wtile::simt::warp_max;
using wtile::simt::warp_sum;

constexpr int BMQ = 16, KT = 64, THREADS = 256, PP = KT + 1;

template <int DC>
__host__ __device__ constexpr size_t bwd_smem() {
  return sizeof(float) * (2 * BMQ * (32 * DC + 1) + 2 * KT * (32 * DC + 1) + 2 * BMQ * PP);
}

// Any N: two sweeps over K and V in tiles of 64 keys. Sweep 1 keeps each
// row's online max m, sum l and c = sum e dP (warp w: rows w and w + 8);
// sweep 2 forms P = e / l and dS = P (dP - c / l), adds dS into dbias and
// dS^T (q s), P^T dO into dk, dv with atomics (zeroed f32 outputs), and
// keeps dq = dS K in registers until it is written. A head is held as DC
// column groups of 32, the columns from d on zero.
template <int DC>
__global__ void __launch_bounds__(THREADS) bwd_simt(BwdArgs g, int d) {
  constexpr int DW = 32 * DC, DP = DW + 1;  // +1 pads off bank conflicts
  extern __shared__ float sm[];
  const int N = g.n;
  float* qs = sm;              // [BMQ][DP] q * scale
  float* os = qs + BMQ * DP;   // [BMQ][DP] dO
  float* ks = os + BMQ * DP;   // [KT][DP]
  float* vs = ks + KT * DP;    // [KT][DP]
  float* ps = vs + KT * DP;    // [BMQ][PP] logits, then P
  float* dps = ps + BMQ * PP;  // [BMQ][PP] dP, then dS

  const int q0 = blockIdx.x * BMQ, w = blockIdx.y, h = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rows = min(BMQ, N - q0);
  const int64_t base = (int64_t)w * g.s_w + (int64_t)h * g.s_h;
  const float* Q = static_cast<const float*>(g.q) + base;
  const float* K = static_cast<const float*>(g.k) + base;
  const float* V = static_cast<const float*>(g.v) + base;
  const float* dO = static_cast<const float*>(g.dout) + (int64_t)w * g.d_w + (int64_t)h * g.d_h;
  for (int idx = tid; idx < BMQ * DW; idx += THREADS) {
    const int i = idx / DW, c = idx % DW;
    const bool ok = i < rows && c < d;
    qs[i * DP + c] = ok ? Q[(int64_t)(q0 + i) * g.s_n + c] * g.scale : 0.f;
    os[i * DP + c] = ok ? dO[(int64_t)(q0 + i) * g.d_n + c] : 0.f;
  }
  const float* bias = static_cast<const float*>(g.bias) + (int64_t)h * N * N;
  const bf16* mask = g.mask ? g.mask + (int64_t)(w % g.n_masks) * N * N : nullptr;
  float* dbias = g.dbias + (int64_t)h * N * N;
  const int64_t gb = (int64_t)w * g.g_w + (int64_t)h * g.g_h;
  float* dK = static_cast<float*>(g.dk) + gb;
  float* dV = static_cast<float*>(g.dv) + gb;

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, cs[2] = {0.f, 0.f};
  float dq[BMQ * DW / THREADS] = {};  // element tid + THREADS e of [BMQ][DW]
  for (int sweep = 0; sweep < 2; ++sweep) {
    for (int k0 = 0; k0 < N; k0 += KT) {
      const int kn = min(KT, N - k0);
      __syncthreads();  // the last tile's reads are done (and q, dO are in place)
      for (int idx = tid; idx < kn * DW; idx += THREADS) {
        const int j = idx / DW, c = idx % DW;
        const int64_t off = (int64_t)(k0 + j) * g.s_n + c;
        ks[j * DP + c] = c < d ? K[off] : 0.f;
        vs[j * DP + c] = c < d ? V[off] : 0.f;
      }
      __syncthreads();
      for (int idx = tid; idx < rows * kn; idx += THREADS) {
        const int i = idx / kn, j = idx - i * kn;
        float sv = 0.f, dp = 0.f;
#pragma unroll
        for (int c = 0; c < DW; ++c) {
          sv = fmaf(qs[i * DP + c], ks[j * DP + c], sv);
          dp = fmaf(os[i * DP + c], vs[j * DP + c], dp);
        }
        const int64_t at = (int64_t)(q0 + i) * N + k0 + j;
        ps[i * PP + j] = (sv + bias[at]) + mask_at(mask, at);
        dps[i * PP + j] = dp;
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = warp + 8 * i;
        if (r >= rows) break;
        float* p = ps + r * PP;
        float* dp = dps + r * PP;
        if (sweep == 0) {
          float mx = -INFINITY;
          for (int j = lane; j < kn; j += 32) mx = fmaxf(mx, p[j]);
          const float mn = fmaxf(m[i], warp_max(mx)), alpha = expf(m[i] - mn);  // m = -inf: 0
          float sl = 0.f, sc = 0.f;
          for (int j = lane; j < kn; j += 32) {
            const float e = expf(p[j] - mn);
            sl += e;
            sc += e * dp[j];
          }
          l[i] = fmaf(l[i], alpha, warp_sum(sl));
          cs[i] = fmaf(cs[i], alpha, warp_sum(sc));
          m[i] = mn;
        } else {
          const float rl = 1.f / l[i], di = cs[i] * rl;
          for (int j = lane; j < kn; j += 32) {
            const float pj = expf(p[j] - m[i]) * rl;
            p[j] = pj;
            dp[j] = pj * (dp[j] - di);
          }
        }
      }
      if (sweep == 0) continue;
      __syncthreads();
      for (int idx = tid; idx < rows * kn; idx += THREADS) {
        const int i = idx / kn, j = idx - i * kn;
        atomicAdd(dbias + (int64_t)(q0 + i) * N + k0 + j, dps[i * PP + j]);
      }
#pragma unroll
      for (int e = 0; e < BMQ * DW / THREADS; ++e) {
        const int i = (tid + THREADS * e) / DW, c = (tid + THREADS * e) % DW;
        if (i >= rows) continue;
        float a = 0.f;
        for (int j = 0; j < kn; ++j) a = fmaf(dps[i * PP + j], ks[j * DP + c], a);
        dq[e] += a;
      }
      for (int idx = tid; idx < kn * DW; idx += THREADS) {
        const int j = idx / DW, c = idx % DW;
        if (c >= d) continue;
        float a = 0.f, b = 0.f;
        for (int i = 0; i < rows; ++i) {
          a = fmaf(dps[i * PP + j], qs[i * DP + c], a);  // dS^T (q s)
          b = fmaf(ps[i * PP + j], os[i * DP + c], b);   // P^T dO
        }
        atomicAdd(dK + (int64_t)(k0 + j) * g.g_n + c, a);
        atomicAdd(dV + (int64_t)(k0 + j) * g.g_n + c, b);
      }
    }
  }
  float* dQ = static_cast<float*>(g.dq) + gb;
#pragma unroll
  for (int e = 0; e < BMQ * DW / THREADS; ++e) {
    const int i = (tid + THREADS * e) / DW, c = (tid + THREADS * e) % DW;
    if (i < rows && c < d) dQ[(int64_t)(q0 + i) * g.g_n + c] = dq[e] * g.scale;
  }
}

template <int DC>
cudaError_t launch_dc(const BwdArgs& g, int d, cudaStream_t s) {
  constexpr size_t smem = bwd_smem<DC>();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        bwd_simt<DC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  bwd_simt<DC><<<dim3((g.n + BMQ - 1) / BMQ, g.windows, g.heads), THREADS, smem, s>>>(g, d);
  return cudaGetLastError();
}

// One launch at head dim d (1 to 128: the instance of 1, 2 or 4 column
// groups of 32)
cudaError_t launch_bwd(const BwdArgs& g, int d, cudaStream_t s) {
  if (d <= 32) return launch_dc<1>(g, d, s);
  if (d <= 64) return launch_dc<2>(g, d, s);
  return launch_dc<4>(g, d, s);
}

}  // namespace simt

// ------------------------------------------------ bf16 backward: Hopper

namespace hop {

using namespace hopper;

constexpr int BM = 64;                      // rows of a block: queries (launch 1), keys (launch 2)
constexpr int KCH = 64;                     // columns of a chunk (wgmma N of S and S^T)
constexpr int ROW_BYTES = D * 2;            // a token's head slice: 64 bytes
constexpr int TILE_BYTES = BM * ROW_BYTES;  // 64 rows of q, dO, K or V: 4 KB
// warpgroups of launch 1 and launch 2; each issues its loads from thread 0
constexpr int C1 = 3, THREADS1 = 128 * C1;
constexpr int C2 = 2, THREADS2 = 128 * C2;
constexpr int SMEM_MAX = 232448;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int STATS = 3;  // row statistics launch 1 saves: m, -log2 l, rowsum(dP P)

// what the host decides for a launch
struct Plan {
  int nk;           // tokens padded to a multiple of 16
  int ns;           // the row statistics' stride: tiles x 64
  int kbox, nbox;   // a window's [N, 32] rows come in nbox TMA boxes of kbox rows
  int rows_bytes;   // those rows in shared memory
  int stage_bytes;  // one stage of the ring
  int stages;       // 2, or 1 where two do not fit
  int slab;         // launch 1: dS sums in a shared f32 slab (else added to dbias per window)
  int tiles;        // ceil(N / 64)
  int n_groups;     // mask indices (1 without a mask)
  int per_group;    // windows that read one mask index (B_ / n_groups)
  int g;            // windows a block takes (G)
  int splits;       // blocks a group's windows are split over: ceil(per_group / G)
  int heads;
  int bpitch;       // bf16 elements a bias tile row: the least >= nk that is 16 mod 32
  int dpitch;       // floats a dbias slab row: the least >= nk that is 16 mod 32
  int stream;       // N > WHOLE_N: the window in tiles of kt keys (launch 1) or queries (2)
  int kt, n_kt;     // rows a streamed tile, tiles a window
};

// The tiles, the dbias slab and the row statistics keep each run of 16
// columns (keys, or queries in launch 2) in the order of the wgmma
// accumulator: the 4 values a thread holds of a row for two consecutive
// 8-column steps (columns 2 t + {0, 1} and 8 + 2 t + {0, 1}, t = lane % 4)
// sit at positions 4 t .. 4 t + 3, so it reads them with one 8-byte load
// (16 for the f32 slab and statistics). pos_of: a column's position within
// its run; col_of: the inverse.
__device__ __forceinline__ int pos_of(int c) {
  return 4 * ((c >> 1) & 3) + 2 * ((c >> 3) & 1) + (c & 1);
}
__device__ __forceinline__ int col_of(int p) {
  return 8 * ((p >> 1) & 1) + 2 * ((p >> 2) & 3) + (p & 1);
}
// four bf16 (positions 4 t .. 4 t + 3 of a run) as f32
__device__ __forceinline__ float4 bf4(const uint16_t* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
__device__ __forceinline__ uint8_t* align512(uint8_t* p) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(p) + 511) &
                                    ~static_cast<uintptr_t>(511));
}
// launch 1's slot of the dS partial sums for head h of group-split grp: the
// blocks of one (head, query tile) write slots 0 .. n_groups splits - 1, and
// wtile::mma::sum_parts adds them into dbias in that order
__device__ __forceinline__ float* block_part(const BwdArgs& g, const Plan& p, int h, int grp) {
  return g.part + ((int64_t)grp * p.heads + h) * g.n * g.n;
}

// this thread's wgmma A fragments (rows 16 (warp % 4) + lane / 4 and + 8,
// two k steps of 16) of a [64, 32] bf16 tile that TMA wrote with the 64-byte
// swizzle
__device__ __forceinline__ void frag_a(uint32_t (&a)[2][4], const uint8_t* tile, int warp,
                                       int lane) {
#pragma unroll
  for (int ks16 = 0; ks16 < 2; ++ks16)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = 16 * (warp & 3) + (lane >> 2) + 8 * (e & 1);
      const int c = 16 * ks16 + 8 * (e >> 1) + 2 * (lane & 3);
      const int off = r * ROW_BYTES + ((((c >> 3) ^ (r >> 1)) & 3) << 4) + (c & 7) * 2;
      a[ks16][e] = *reinterpret_cast<const uint32_t*>(tile + off);
    }
}

// eight bf16 of a uint4 as f32, and back (round to nearest)
__device__ __forceinline__ void unpack8(const uint4& u, float* f) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

// n bf16 of bias (+ mask) at `at` as f32 (16-byte loads; the caller checks
// alignment)
template <int F>
__device__ __forceinline__ void load_sum(const bf16* bias, const bf16* mask, int64_t at,
                                         float* f) {
#pragma unroll
  for (int i = 0; i < F; i += 8) unpack8(*reinterpret_cast<const uint4*>(bias + at + i), f + i);
  if (mask) {
#pragma unroll
    for (int i = 0; i < F; i += 8) {
      float m[8];
      unpack8(*reinterpret_cast<const uint4*>(mask + at + i), m);
#pragma unroll
      for (int c = 0; c < 8; ++c) f[i + c] += m[c];
    }
  }
}

// A tile fill in batches: load(u, f) for FILL_U units, then store(u, f) for
// each, so that a batch's global loads are in flight together
template <int F, class Load, class Store>
__device__ __forceinline__ void fill_batched(int units, int tid, int threads, Load&& load,
                                             Store&& store) {
  constexpr int FILL_U = 4;
  for (int u0 = tid; u0 < units; u0 += FILL_U * threads) {
    float f[FILL_U][F];
#pragma unroll
    for (int i = 0; i < FILL_U; ++i)
      if (u0 + i * threads < units) load(u0 + i * threads, f[i]);
#pragma unroll
    for (int i = 0; i < FILL_U; ++i)
      if (u0 + i * threads < units) store(u0 + i * threads, f[i]);
  }
}

// Launch 1's tile: row r (query q0 + r), key k0 + k (k < pitch) holds bias + mask
// rounded to bf16 for q, k < N; -inf for k >= N (weight 0); 0 for a row past
// N (its dO is zero, so its dS is 0); keys in the accumulator order of each
// run of 16 (pos_of). The bias is bf16 at this cast point, so the tile is
// exact where the mask is 0; where it is -100 the weight is below 1e-40 in
// either rounding. A unit is a run of 16 keys of a row.
__device__ __forceinline__ void fill_rows(uint16_t* tile, const bf16* bias, const bf16* mask,
                                          int q0, int k0, int n, int pitch, int tid,
                                          int threads) {
  const int runs = pitch / 16;
  const bool vec = n % 8 == 0;
  fill_batched<16>(
      BM * runs, tid, threads,
      [&](int u, float* f) {
        const int r = u / runs, k = k0 + 16 * (u - r * runs), q = q0 + r;
        const int64_t at = (int64_t)q * n + k;
        if (q < n && vec && k + 15 < n) {
          load_sum<16>(bias, mask, at, f);
          return;
        }
#pragma unroll
        for (int i = 0; i < 16; ++i)
          f[i] = k + i >= n ? -INFINITY
                 : q >= n   ? 0.f
                            : __bfloat162float(bias[at + i]) +
                                (mask ? __bfloat162float(mask[at + i]) : 0.f);
      },
      [&](int u, const float* f) {
        const int r = u / runs, k = 16 * (u - r * runs);
        uint32_t o[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) o[i] = wtile::pack_bf16(f[col_of(2 * i)], f[col_of(2 * i + 1)]);
        uint4* dst = reinterpret_cast<uint4*>(tile + r * pitch + k);
        dst[0] = make_uint4(o[0], o[1], o[2], o[3]);
        dst[1] = make_uint4(o[4], o[5], o[6], o[7]);
      });
}

// Launch 2's transposed tile: row kl (key k0 + kl), query qo + q (q < pitch,
// qo a multiple of 16; at its position in the accumulator order, pos_of) holds bias[q][k0 + kl] +
// mask[q][k0 + kl] rounded to bf16 for q, key < N, else -inf (weight 0). A
// unit is 8 keys of one query row (16 bytes), written down a column;
// consecutive threads take consecutive queries.
__device__ __forceinline__ void fill_cols(uint16_t* tile, const bf16* bias, const bf16* mask,
                                          int k0, int qo, int n, int pitch, int tid,
                                          int threads) {
  const bool vec = n % 8 == 0;
  fill_batched<8>(
      (BM / 8) * pitch, tid, threads,
      [&](int u, float* f) {
        const int kr = u / pitch, q = qo + u - kr * pitch, k = k0 + 8 * kr;
        const int64_t at = (int64_t)q * n + k;
        if (q < n && vec && k + 7 < n) {
          load_sum<8>(bias, mask, at, f);
          return;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
          f[i] = q < n && k + i < n ? __bfloat162float(bias[at + i]) +
                                          (mask ? __bfloat162float(mask[at + i]) : 0.f)
                                    : -INFINITY;
      },
      [&](int u, const float* f) {
        const int kr = u / pitch, q = u - kr * pitch;
        uint16_t* col = tile + 8 * kr * pitch + (q & ~15) + pos_of(q & 15);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const bf16 b = __float2bfloat16_rn(f[i]);
          col[i * pitch] = *reinterpret_cast<const uint16_t*>(&b);
        }
      });
}

// S = q K^T and dP = dO V^T of one chunk of W keys from kc, for this
// warpgroup's 64 rows: accumulator element 4 j + 2 h + e is row 16 (warp % 4)
// + lane / 4 + 8 h, key kc + 8 j + 2 (lane % 4) + e
template <int W>
__device__ __forceinline__ void s_dp(float (&s)[W / 2], float (&dp)[W / 2],
                                     const uint32_t (&a)[2][4], const uint32_t (&b)[2][4],
                                     const uint8_t* xs, const uint8_t* ys, int kc) {
  wgmma_fence();
  WgmmaRS<W, 0>::mma(s, a[0], desc_sw64(xs + kc * ROW_BYTES, 16), 0);
  WgmmaRS<W, 0>::mma(s, a[1], desc_sw64(xs + kc * ROW_BYTES + 32, 16), 1);
  WgmmaRS<W, 0>::mma(dp, b[0], desc_sw64(ys + kc * ROW_BYTES, 16), 0);
  WgmmaRS<W, 0>::mma(dp, b[1], desc_sw64(ys + kc * ROW_BYTES + 32, 16), 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
  fence_regs(dp);
}

// launch 1, sweep 1: one chunk's logits x = s scale + tile and the online
// row max m, row sum l = sum e and c = sum e dP, e = 2^((x - m) log2 e) (rows
// a and b); ta: this thread's tile row a at position 4 (lane % 4)
template <int W>
__device__ __forceinline__ void stats_chunk(const uint32_t (&qa)[2][4], const uint32_t (&oa)[2][4],
                                            const uint8_t* ks, const uint8_t* vs, int kc,
                                            const uint16_t* ta, int bpitch, float scale,
                                            float (&m)[2], float (&l)[2], float (&c)[2]) {
  float s[W / 2], dp[W / 2];
  s_dp<W>(s, dp, qa, oa, ks, vs, kc);
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int u = 0; u < W / 16; ++u) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 t = bf4(ta + h * 8 * bpitch + kc + 16 * u);
      const int a = 8 * u + 2 * h, b = a + 4;  // steps j = 2 u and 2 u + 1
      s[a] = fmaf(s[a], scale, t.x);
      s[a + 1] = fmaf(s[a + 1], scale, t.y);
      s[b] = fmaf(s[b], scale, t.z);
      s[b + 1] = fmaf(s[b + 1], scale, t.w);
      mx[h] = fmaxf(mx[h], fmaxf(fmaxf(s[a], s[a + 1]), fmaxf(s[b], s[b + 1])));
    }
  }
  float base[2];  // the new max (0 while it is -inf)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float mn = fmaxf(m[h], quad_max(mx[h]));
    base[h] = mn == -INFINITY ? 0.f : mn;
    const float alpha = ex2((m[h] - base[h]) * LOG2E);  // m = -inf: 0
    m[h] = mn;
    l[h] *= alpha;
    c[h] *= alpha;
  }
#pragma unroll
  for (int j = 0; j < W / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int h = i >> 1;
      const float e = ex2((s[4 * j + i] - base[h]) * LOG2E);
      l[h] += e;
      c[h] += e * dp[4 * j + i];
    }
}

// a weight P = 2^((x - m) log2 e + nl) of logit x, from its row's max m
// and nl = -log2 (row sum)
__device__ __forceinline__ float weight(float x, float m, float nl) {
  return ex2(fmaf(x - m, LOG2E, nl));
}

// row r's sweep-1 statistics of the C1 warpgroups (stx: [C1][BM][m, l, c])
// combined: the row max m, nl = -log2 l and D = rowsum(dP P) = c / l
__device__ __forceinline__ void combine_stats(const float* stx, int r, float& m, float& nl,
                                              float& di) {
  float mm = -INFINITY, ll = 0.f, cc = 0.f;
#pragma unroll
  for (int k = 0; k < C1; ++k) mm = fmaxf(mm, stx[(k * BM + r) * 3]);
#pragma unroll
  for (int k = 0; k < C1; ++k) {
    const float* x = stx + (k * BM + r) * 3;
    const float f = ex2((x[0] - mm) * LOG2E);  // a warpgroup without keys: -inf, 0
    ll += x[1] * f;
    cc += x[2] * f;
  }
  m = mm;
  nl = -__log2f(ll);
  di = cc / ll;
}

// launch 1, sweep 2: one chunk's P (weight, from the row's m and nl) and
// dS = P (dP - D) (D = rowsum(dP P)); dS into the dbias slab (sa: this thread's slab row a at
// position 4 (lane % 4)) or, without a slab, into the block's own slot of the
// partial sums (dg: row a at key 2 (lane % 4); rows or keys past n skipped;
// the same thread owns an element in every window); dq += dS K with dS in
// bf16. The product is left in flight: the next chunk's wait covers it.
template <int W, bool SLAB>
__device__ __forceinline__ void ds_chunk(const uint32_t (&qa)[2][4], const uint32_t (&oa)[2][4],
                                         const uint8_t* ks, const uint8_t* vs, int kc,
                                         const uint16_t* ta, int bpitch, float scale,
                                         const float (&rm)[2], const float (&nl)[2],
                                         const float (&di)[2], float (&dq)[16], float* sa,
                                         int dpitch, float* dg, int n, int key0, bool ok_a,
                                         bool ok_b) {
  float s[W / 2], dp[W / 2];
  s_dp<W>(s, dp, qa, oa, ks, vs, kc);
  uint32_t da[W / 16][4];
#pragma unroll
  for (int u = 0; u < W / 16; ++u) {
    float ds[8];  // 4 j' + 2 h + e: step j = 2 u + j', row h, column e
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 t = bf4(ta + h * 8 * bpitch + kc + 16 * u);
      const float tv[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {  // q = 2 j' + e, the position's order
        const int i = 4 * (q >> 1) + 2 * h + (q & 1);
        const float p = weight(fmaf(s[8 * u + i], scale, tv[q]), rm[h], nl[h]);
        ds[i] = p * (dp[8 * u + i] - di[h]);
      }
      if (SLAB) {
        float4* x = reinterpret_cast<float4*>(sa + h * 8 * dpitch + kc + 16 * u);
        float4 v = *x;
        v.x += ds[2 * h];
        v.y += ds[2 * h + 1];
        v.z += ds[4 + 2 * h];
        v.w += ds[4 + 2 * h + 1];
        *x = v;
      } else if (h ? ok_b : ok_a) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int dk = 8 * (q >> 1) + (q & 1), key = key0 + kc + 16 * u + dk;
          // an atomic add without a return (red), into this block's own
          // slot: no other thread touches the element, and one thread's
          // adds to one address apply in program order (the window
          // order), so the sum repeats to the bit; a plain load and
          // store measured 40% slower at N = 784 (the load's latency)
          if (key < n) atomicAdd(dg + h * 8 * n + kc + 16 * u + dk, ds[4 * (q >> 1) + 2 * h + (q & 1)]);
        }
      }
    }
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      da[u][2 * jj] = wtile::pack_bf16(ds[4 * jj], ds[4 * jj + 1]);
      da[u][2 * jj + 1] = wtile::pack_bf16(ds[4 * jj + 2], ds[4 * jj + 3]);
    }
  }
  wgmma_fence();
#pragma unroll
  for (int st = 0; st < W / 16; ++st)
    WgmmaRS<32, 1>::mma(dq, da[st], desc_sw64(ks + (kc + 16 * st) * ROW_BYTES, 512), 1);
  wgmma_commit();
}

// Launch 1 (dq, dbias, the row statistics): one block per (head, group of
// windows that read one mask index, query tile of 64 rows). Thread 0 streams
// each window's q and dO tiles and its whole K and V by TMA; C1 warpgroups
// split the keys in chunks of 64 (warpgroup c % C1 takes chunk c). Sweep 1
// forms S and dP for the row statistics, which the warpgroups combine
// through shared memory; sweep 2 forms them again, then P, dS, the slab's dS
// sums and dq. See the note at the top.
template <bool SLAB>
__global__ void __launch_bounds__(THREADS1, 1)
    dq_bf16(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_o,
            const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
            BwdArgs g, Plan p) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* ring = align512(smem_raw);  // stages x [q | dO | K rows | V rows]
  uint16_t* tile = reinterpret_cast<uint16_t*>(ring + p.stages * p.stage_bytes);  // [64][bpitch]
  float* slab = reinterpret_cast<float*>(tile + BM * p.bpitch);  // [64][dpitch] (SLAB)
  // [stages][C1][64][m, l, c]: with two stages a warpgroup may write the
  // next window's before the others have read this one's; with one, the
  // next window's loads wait for every warpgroup
  float* stx_all = slab + (SLAB ? BM * p.dpitch : 0);
  float* dqx = stx_all + p.stages * C1 * BM * 3;                 // [C1 - 1][16][128] dq hand-over
  uint64_t* full = reinterpret_cast<uint64_t*>(dqx + (C1 - 1) * 16 * 128);

  // block x = tile + tiles (head + heads group), as K3: a group's heads run
  // together, so a mask slice is read from device memory once for all heads
  const int N = g.n;
  const int q0 = BM * (blockIdx.x % p.tiles), h = (blockIdx.x / p.tiles) % p.heads;
  const int grp = blockIdx.x / p.tiles / p.heads;
  const int mi = grp % p.n_groups, split = grp / p.n_groups;
  const int b0 = split * p.g, nw = min(p.g, p.per_group - b0);  // windows mi + b n_groups
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // window it's q and dO tiles and whole K and V into stage it % stages;
  // thread 0 issues them once the stage is free (no producer warp: with
  // three warps on each SM sub-partition a thread may have 168 registers)
  auto load = [&](int it) {
    const int sl = it % p.stages, x = h * D, w = mi + (b0 + it) * p.n_groups;
    uint8_t* st = ring + sl * p.stage_bytes;
    mbar_expect_tx(full + sl, 2 * TILE_BYTES + 2 * p.nbox * p.kbox * ROW_BYTES);
    tma_load_3d(st, &tm_q, full + sl, x, q0, w);
    tma_load_3d(st + TILE_BYTES, &tm_o, full + sl, x, q0, w);
    for (int b = 0; b < p.nbox; ++b) {
      uint8_t* r = st + 2 * TILE_BYTES + b * p.kbox * ROW_BYTES;
      tma_load_3d(r, &tm_k, full + sl, x, b * p.kbox, w);
      tma_load_3d(r + p.rows_bytes, &tm_v, full + sl, x, b * p.kbox, w);
    }
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < p.stages; ++i) mbar_init(full + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int it = 0; it < p.stages && it < nw; ++it) load(it);
  }
  __syncthreads();

  constexpr int CT = 128 * C1;  // every thread
  fill_rows(tile, static_cast<const bf16*>(g.bias) + (int64_t)h * N * N,
            g.mask ? g.mask + (int64_t)mi * N * N : nullptr, q0, 0, N, p.bpitch, threadIdx.x, CT);
  if (SLAB)
    for (int i = threadIdx.x; i < BM * p.dpitch; i += CT) slab[i] = 0.f;
  named_sync(1, CT);

  const int wg = warp >> 2, t = threadIdx.x & 127, t4 = lane & 3;
  const int ra = 16 * (warp & 3) + (lane >> 2);  // this thread's row a in the tile; b = a + 8
  const bool ok_a = q0 + ra < N, ok_b = q0 + ra + 8 < N;
  const uint16_t* ta = tile + ra * p.bpitch + 4 * t4;
  float* sa = slab + ra * p.dpitch + 4 * t4;
  // this block's slot of the partial sums (block_part), row a at key 2 (lane % 4)
  float* dg = block_part(g, p, h, grp) + (int64_t)(q0 + ra) * N + 2 * t4;
  const int n_chunks = (p.nk + KCH - 1) / KCH;

  for (int it = 0; it < nw; ++it) {
    const int sl = it % p.stages;
    uint8_t* st = ring + sl * p.stage_bytes;
    const uint8_t* ks = st + 2 * TILE_BYTES;
    const uint8_t* vs = ks + p.rows_bytes;
    const int w = mi + (b0 + it) * p.n_groups;
    mbar_wait(full + sl, (it / p.stages) & 1);
    uint32_t qa[2][4], oa[2][4];
    frag_a(qa, st, warp, lane);
    frag_a(oa, st + TILE_BYTES, warp, lane);
    float* stx = stx_all + (it % p.stages) * C1 * BM * 3;

    // sweep 1: this warpgroup's keys
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, c[2] = {0.f, 0.f};
    for (int ch = wg; ch < n_chunks; ch += C1) {
      const int kc = ch * KCH;
      if (kc + KCH <= p.nk) {
        stats_chunk<KCH>(qa, oa, ks, vs, kc, ta, p.bpitch, g.scale, m, l, c);
      } else {
        for (int k16 = kc; k16 < p.nk; k16 += 16)
          stats_chunk<16>(qa, oa, ks, vs, k16, ta, p.bpitch, g.scale, m, l, c);
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      l[hh] = quad_sum(l[hh]);
      c[hh] = quad_sum(c[hh]);
      if (t4 == 0) {
        float* x = stx + (wg * BM + ra + 8 * hh) * 3;
        x[0] = m[hh];
        x[1] = l[hh];
        x[2] = c[hh];
      }
    }
    named_sync(1, CT);
    // the warpgroups' statistics combined
    float rm[2], nl[2], di[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) combine_stats(stx, ra + 8 * hh, rm[hh], nl[hh], di[hh]);
    if (wg == 0 && t4 == 0) {  // for launch 2: every row of the tile (< ns), in pos_of order
      float* sg = g.stats + ((int64_t)w * p.heads + h) * STATS * p.ns + q0 + (ra & ~15);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int at = pos_of((ra + 8 * hh) & 15);
        sg[at] = rm[hh];
        sg[p.ns + at] = nl[hh];
        sg[2 * p.ns + at] = di[hh];
      }
    }

    // sweep 2
    float dq[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) dq[i] = 0.f;
    for (int ch = wg; ch < n_chunks; ch += C1) {
      const int kc = ch * KCH;
      if (kc + KCH <= p.nk) {
        ds_chunk<KCH, SLAB>(qa, oa, ks, vs, kc, ta, p.bpitch, g.scale, rm, nl, di, dq, sa,
                            p.dpitch, dg, N, 2 * t4, ok_a, ok_b);
      } else {
        for (int k16 = kc; k16 < p.nk; k16 += 16)
          ds_chunk<16, SLAB>(qa, oa, ks, vs, k16, ta, p.bpitch, g.scale, rm, nl, di, dq, sa,
                             p.dpitch, dg, N, 2 * t4, ok_a, ok_b);
      }
    }
    wgmma_wait<0>();
    fence_regs(dq);
    // the other warpgroups, done with this stage's K and V, hand their dq to
    // the first (barrier 3), which refills the stage, then adds and stores
    if (wg > 0) {
      float* x = dqx + (wg - 1) * 16 * 128 + t;
#pragma unroll
      for (int i = 0; i < 16; ++i) x[i * 128] = dq[i];
      named_arrive(3, CT);
      continue;
    }
    named_sync(3, CT);
    if (threadIdx.x == 0 && it + p.stages < nw) load(it + p.stages);
#pragma unroll
    for (int k = 0; k < C1 - 1; ++k) {
      const float* x = dqx + k * 16 * 128 + t;
#pragma unroll
      for (int i = 0; i < 16; ++i) dq[i] += x[i * 128];
    }
    bf16* dQ = static_cast<bf16*>(g.dq) + (int64_t)w * g.g_w + (int64_t)h * g.g_h;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * t4;
      if (ok_a)
        *reinterpret_cast<__nv_bfloat162*>(dQ + (int64_t)(q0 + ra) * g.g_n + col) =
            __floats2bfloat162_rn(dq[4 * j] * g.scale, dq[4 * j + 1] * g.scale);
      if (ok_b)
        *reinterpret_cast<__nv_bfloat162*>(dQ + (int64_t)(q0 + ra + 8) * g.g_n + col) =
            __floats2bfloat162_rn(dq[4 * j + 2] * g.scale, dq[4 * j + 3] * g.scale);
    }
  }

  if (SLAB) {
    named_sync(2, CT);  // every warpgroup's slab adds are done
    // the slab into this block's slot: plain stores, every element of its rows
    float* part = block_part(g, p, h, grp);
    const int rows = min(BM, N - q0);
    for (int i = threadIdx.x; i < rows * p.nk; i += CT) {
      const int r = i / p.nk, at = i - r * p.nk, k = (at & ~15) + col_of(at & 15);
      if (k < N) part[(int64_t)(q0 + r) * N + k] = slab[r * p.dpitch + at];
    }
  }
}

// launch 2, one chunk of W queries from qc for this warpgroup's 64 keys,
// from S^T = K q^T and dP^T = V dO^T: P^T and dS^T in bf16 as the A operands
// of dV and dK, from the statistics of launch 1 (sts: this thread's position
// 4 (lane % 4) of [m | -log2 l | D], ns apart) and the transposed tile (tt: row a at
// the same position)
template <int W>
__device__ __forceinline__ void dkdv_weights(const float (&s)[W / 2], const float (&dp)[W / 2],
                                             int qc, const uint16_t* tt, int bpitch,
                                             const float* sts, int ns, float scale,
                                             uint32_t (&pa)[W / 16][4], uint32_t (&da)[W / 16][4]) {
#pragma unroll
  for (int u = 0; u < W / 16; ++u) {
    const int q0 = qc + 16 * u;
    const float4 m4 = *reinterpret_cast<const float4*>(sts + q0);
    const float4 nl4 = *reinterpret_cast<const float4*>(sts + ns + q0);
    const float4 di4 = *reinterpret_cast<const float4*>(sts + 2 * ns + q0);
    const float rm[4] = {m4.x, m4.y, m4.z, m4.w}, nl[4] = {nl4.x, nl4.y, nl4.z, nl4.w};
    const float di[4] = {di4.x, di4.y, di4.z, di4.w};
    float pv[8], ds[8];  // 4 j' + 2 h + e: step j = 2 u + j', row h, column e
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 t = bf4(tt + h * 8 * bpitch + q0);
      const float tv[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {  // q = 2 j' + e, the position's order
        const int i = 4 * (q >> 1) + 2 * h + (q & 1);
        pv[i] = weight(fmaf(s[8 * u + i], scale, tv[q]), rm[q], nl[q]);
        ds[i] = pv[i] * (dp[8 * u + i] - di[q]);
      }
    }
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      pa[u][2 * jj] = wtile::pack_bf16(pv[4 * jj], pv[4 * jj + 1]);
      pa[u][2 * jj + 1] = wtile::pack_bf16(pv[4 * jj + 2], pv[4 * jj + 3]);
      da[u][2 * jj] = wtile::pack_bf16(ds[4 * jj], ds[4 * jj + 1]);
      da[u][2 * jj + 1] = wtile::pack_bf16(ds[4 * jj + 2], ds[4 * jj + 3]);
    }
  }
}

// issues dV += P^T dO and dK += dS^T q for the chunk of W queries from qc
// (one commit group, left in flight)
template <int W>
__device__ __forceinline__ void issue_dkdv(const uint32_t (&pa)[W / 16][4],
                                           const uint32_t (&da)[W / 16][4], const uint8_t* qs,
                                           const uint8_t* os, int qc, float (&dk)[16],
                                           float (&dv)[16]) {
  wgmma_fence();
#pragma unroll
  for (int st = 0; st < W / 16; ++st) {
    WgmmaRS<32, 1>::mma(dv, pa[st], desc_sw64(os + (qc + 16 * st) * ROW_BYTES, 512), 1);
    WgmmaRS<32, 1>::mma(dk, da[st], desc_sw64(qs + (qc + 16 * st) * ROW_BYTES, 512), 1);
  }
  wgmma_commit();
}

// Launch 2 (dk, dv): one block per (head, group of windows that read one
// mask index, key tile of 64). Thread 0 streams each window's K and V tiles,
// its whole q and dO and its row statistics (a bulk copy) by TMA; C2
// warpgroups split the queries in chunks of 64. dK and dV of the block's
// keys are complete at the end of a window: no atomics.
__global__ void __launch_bounds__(THREADS2, 1)
    dkdv_bf16(const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
              const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_o,
              BwdArgs g, Plan p) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* ring = align512(smem_raw);  // stages x [K | V | q rows | dO rows | statistics]
  uint16_t* tile = reinterpret_cast<uint16_t*>(ring + p.stages * p.stage_bytes);  // [64][bpitch]
  float* xchg = reinterpret_cast<float*>(tile + BM * p.bpitch);  // [C2 - 1][32][128] dK, dV
  uint64_t* full = reinterpret_cast<uint64_t*>(xchg + (C2 - 1) * 32 * 128);

  const int N = g.n;
  const int k0 = BM * (blockIdx.x % p.tiles), h = (blockIdx.x / p.tiles) % p.heads;
  const int grp = blockIdx.x / p.tiles / p.heads;
  const int mi = grp % p.n_groups, split = grp / p.n_groups;
  const int b0 = split * p.g, nw = min(p.g, p.per_group - b0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int stats_off = 2 * TILE_BYTES + 2 * p.rows_bytes;

  // window it's K and V tiles, q and dO rows and statistics into stage it %
  // stages; thread 0 issues them once the stage is free (no producer warp:
  // with 8 warps a block, no SM sub-partition holds 3, so each thread may
  // have up to 255 registers)
  const uint32_t sbytes = STATS * p.ns * 4;
  auto load = [&](int it) {
    const int sl = it % p.stages, x = h * D, w = mi + (b0 + it) * p.n_groups;
    uint8_t* st = ring + sl * p.stage_bytes;
    mbar_expect_tx(full + sl, 2 * TILE_BYTES + 2 * p.nbox * p.kbox * ROW_BYTES + sbytes);
    tma_load_3d(st, &tm_k, full + sl, x, k0, w);
    tma_load_3d(st + TILE_BYTES, &tm_v, full + sl, x, k0, w);
    for (int b = 0; b < p.nbox; ++b) {
      uint8_t* r = st + 2 * TILE_BYTES + b * p.kbox * ROW_BYTES;
      tma_load_3d(r, &tm_q, full + sl, x, b * p.kbox, w);
      tma_load_3d(r + p.rows_bytes, &tm_o, full + sl, x, b * p.kbox, w);
    }
    bulk_load(st + stats_off, g.stats + ((int64_t)w * p.heads + h) * STATS * p.ns, sbytes,
              full + sl);
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < p.stages; ++i) mbar_init(full + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int it = 0; it < p.stages && it < nw; ++it) load(it);
  }
  __syncthreads();

  constexpr int CT = 128 * C2;
  fill_cols(tile, static_cast<const bf16*>(g.bias) + (int64_t)h * N * N,
            g.mask ? g.mask + (int64_t)mi * N * N : nullptr, k0, 0, N, p.bpitch, threadIdx.x,
            CT);
  named_sync(1, CT);

  const int wg = warp >> 2, t = threadIdx.x & 127, t4 = lane & 3;
  const int ra = 16 * (warp & 3) + (lane >> 2);  // this thread's key a in the tile; b = a + 8
  const uint16_t* tt = tile + ra * p.bpitch + 4 * t4;

  for (int it = 0; it < nw; ++it) {
    const int sl = it % p.stages;
    uint8_t* st = ring + sl * p.stage_bytes;
    const uint8_t* qs = st + 2 * TILE_BYTES;
    const uint8_t* os = qs + p.rows_bytes;
    const float* sts = reinterpret_cast<const float*>(st + stats_off) + 4 * t4;
    const int w = mi + (b0 + it) * p.n_groups;
    mbar_wait(full + sl, (it / p.stages) & 1);
    uint32_t ka[2][4], va[2][4];
    frag_a(ka, st, warp, lane);
    frag_a(va, st + TILE_BYTES, warp, lane);

    float dk[16], dv[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) dk[i] = dv[i] = 0.f;
    // this warpgroup's chunks c = wg, wg + C2, ... of 64 queries (the
    // 16-query runs of a last partial chunk one at a time); dV and dK of a
    // chunk are left in flight: the next chunk's wait covers them
    for (int ch = wg; KCH * ch < p.nk; ch += C2) {
      const int qc = KCH * ch;
      if (qc + KCH <= p.nk) {
        float s[32], dp[32];
        uint32_t pa[4][4], da[4][4];
        s_dp<KCH>(s, dp, ka, va, qs, os, qc);
        dkdv_weights<KCH>(s, dp, qc, tt, p.bpitch, sts, p.ns, g.scale, pa, da);
        issue_dkdv<KCH>(pa, da, qs, os, qc, dk, dv);
      } else {
        for (int q16 = qc; q16 < p.nk; q16 += 16) {
          float s[8], dp[8];
          uint32_t pa[1][4], da[1][4];
          s_dp<16>(s, dp, ka, va, qs, os, q16);
          dkdv_weights<16>(s, dp, q16, tt, p.bpitch, sts, p.ns, g.scale, pa, da);
          issue_dkdv<16>(pa, da, qs, os, q16, dk, dv);
        }
      }
    }
    wgmma_wait<0>();
    fence_regs(dk);
    fence_regs(dv);
    // every warpgroup is done with this stage: it takes the window after
    // next; the others hand their dK and dV to the first
    named_sync(2, CT);
    if (threadIdx.x == 0 && it + p.stages < nw) load(it + p.stages);
    if (wg > 0) {
      float* x = xchg + (wg - 1) * 32 * 128 + t;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        x[i * 128] = dk[i];
        x[(16 + i) * 128] = dv[i];
      }
      named_arrive(3, CT);
      continue;
    }
    named_sync(3, CT);
#pragma unroll
    for (int k = 0; k < C2 - 1; ++k) {
      const float* x = xchg + k * 32 * 128 + t;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        dk[i] += x[i * 128];
        dv[i] += x[(16 + i) * 128];
      }
    }
    const int64_t gb = (int64_t)w * g.g_w + (int64_t)h * g.g_h;
    bf16* dK = static_cast<bf16*>(g.dk) + gb;
    bf16* dV = static_cast<bf16*>(g.dv) + gb;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int key = k0 + ra + 8 * hh;
      if (key >= N) continue;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int col = 8 * j + 2 * t4, i = 4 * j + 2 * hh;
        *reinterpret_cast<__nv_bfloat162*>(dK + (int64_t)key * g.g_n + col) =
            __floats2bfloat162_rn(dk[i] * g.scale, dk[i + 1] * g.scale);
        *reinterpret_cast<__nv_bfloat162*>(dV + (int64_t)key * g.g_n + col) =
            __floats2bfloat162_rn(dv[i], dv[i + 1]);
      }
    }
  }
}

// ------------------------------------------- windows of more than WHOLE_N

// Launch 1 for a window of more than WHOLE_N tokens (N = 784: whole K and V
// take 100 KB, a whole tile 100 KB more): dq_bf16's arithmetic without the
// slab (dS into the block's slot of the partial sums, as dq_bf16 above N ~440), on a window
// streamed as key tiles of kt = 192 keys. An item is (window, sweep, key
// tile); thread 0 loads the q and dO tiles with the key tile's K and V into
// a ring of stages, stages - 1 items ahead. The block moves through the
// items in step: barrier, thread 0 reloads the stage the last item freed,
// every thread fills the key tile's bias + mask tile, barrier, then the
// warpgroups take the tile's chunks (warpgroup c the chunk c, the same
// chunks of a window as dq_bf16). The statistics combine after a window's
// first sweep and dq is handed over and stored after its second, as in
// dq_bf16.
__global__ void __launch_bounds__(THREADS1, 1)
    dq_stream(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_o,
              const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
              BwdArgs g, Plan p) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* ring = align512(smem_raw);  // stages x [q | dO | K tile | V tile]
  uint16_t* tile = reinterpret_cast<uint16_t*>(ring + p.stages * p.stage_bytes);  // [64][bpitch]
  float* stx = reinterpret_cast<float*>(tile + BM * p.bpitch);  // [C1][64][m, l, c]
  float* dqx = stx + p.stages * C1 * BM * 3;                     // [C1 - 1][16][128]
  uint64_t* full = reinterpret_cast<uint64_t*>(dqx + (C1 - 1) * 16 * 128);

  const int N = g.n;
  const int q0 = BM * (blockIdx.x % p.tiles), h = (blockIdx.x / p.tiles) % p.heads;
  const int grp = blockIdx.x / p.tiles / p.heads;
  const int mi = grp % p.n_groups, split = grp / p.n_groups;
  const int b0 = split * p.g, nw = min(p.g, p.per_group - b0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int per_win = 2 * p.n_kt, items = nw * per_win;

  auto load = [&](int s) {
    const int sl = s % p.stages, it = s / per_win, kt = (s - it * per_win) % p.n_kt;
    const int x = h * D, w = mi + (b0 + it) * p.n_groups;
    uint8_t* st = ring + sl * p.stage_bytes;
    mbar_expect_tx(full + sl, 2 * TILE_BYTES + 2 * p.kt * ROW_BYTES);
    tma_load_3d(st, &tm_q, full + sl, x, q0, w);
    tma_load_3d(st + TILE_BYTES, &tm_o, full + sl, x, q0, w);
    tma_load_3d(st + 2 * TILE_BYTES, &tm_k, full + sl, x, kt * p.kt, w);
    tma_load_3d(st + 2 * TILE_BYTES + p.rows_bytes, &tm_v, full + sl, x, kt * p.kt, w);
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < p.stages; ++i) mbar_init(full + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < p.stages - 1 && s < items; ++s) load(s);
  }
  __syncthreads();

  constexpr int CT = 128 * C1;
  const bf16* bias = static_cast<const bf16*>(g.bias) + (int64_t)h * N * N;
  const bf16* mask = g.mask ? g.mask + (int64_t)mi * N * N : nullptr;
  const int wg = warp >> 2, t = threadIdx.x & 127, t4 = lane & 3;
  const int ra = 16 * (warp & 3) + (lane >> 2);
  const bool ok_a = q0 + ra < N, ok_b = q0 + ra + 8 < N;
  const uint16_t* ta = tile + ra * p.bpitch + 4 * t4;
  // this block's slot of the partial sums (block_part), row a at key 2 (lane % 4)
  float* dg = block_part(g, p, h, grp) + (int64_t)(q0 + ra) * N + 2 * t4;

  uint32_t qa[2][4], oa[2][4];
  float m[2], l[2], c[2], rm[2], nl[2], di[2], dq[16];
  for (int s = 0; s < items; ++s) {
    const int sl = s % p.stages, it = s / per_win, sk = s - it * per_win;
    const int sweep = sk / p.n_kt, kt = sk - sweep * p.n_kt;
    const int k0 = kt * p.kt, len = min(p.kt, p.nk - k0);
    named_sync(1, CT);  // item s - 1 is done with its stage and the tile
    if (threadIdx.x == 0 && s + p.stages - 1 < items) load(s + p.stages - 1);
    fill_rows(tile, bias, mask, q0, k0, N, p.bpitch, threadIdx.x, CT);
    named_sync(1, CT);  // the tile is filled
    const uint8_t* st = ring + sl * p.stage_bytes;
    const uint8_t* ks = st + 2 * TILE_BYTES;
    const uint8_t* vs = ks + p.rows_bytes;
    mbar_wait(full + sl, (s / p.stages) & 1);
    if (sk == 0) {
      frag_a(qa, st, warp, lane);
      frag_a(oa, st + TILE_BYTES, warp, lane);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        m[hh] = -INFINITY;
        l[hh] = c[hh] = 0.f;
      }
    }

    if (sweep == 0) {
      for (int kc = wg * KCH; kc < len; kc += C1 * KCH) {
        if (kc + KCH <= len) {
          stats_chunk<KCH>(qa, oa, ks, vs, kc, ta, p.bpitch, g.scale, m, l, c);
        } else {
          for (int k16 = kc; k16 < len; k16 += 16)
            stats_chunk<16>(qa, oa, ks, vs, k16, ta, p.bpitch, g.scale, m, l, c);
        }
      }
      if (kt + 1 < p.n_kt) continue;
      // the window's statistics, combined as in dq_bf16
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        l[hh] = quad_sum(l[hh]);
        c[hh] = quad_sum(c[hh]);
        if (t4 == 0) {
          float* x = stx + (wg * BM + ra + 8 * hh) * 3;
          x[0] = m[hh];
          x[1] = l[hh];
          x[2] = c[hh];
        }
      }
      named_sync(1, CT);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) combine_stats(stx, ra + 8 * hh, rm[hh], nl[hh], di[hh]);
      if (wg == 0 && t4 == 0) {
        const int w = mi + (b0 + it) * p.n_groups;
        float* sg = g.stats + ((int64_t)w * p.heads + h) * STATS * p.ns + q0 + (ra & ~15);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int at = pos_of((ra + 8 * hh) & 15);
          sg[at] = rm[hh];
          sg[p.ns + at] = nl[hh];
          sg[2 * p.ns + at] = di[hh];
        }
      }
#pragma unroll
      for (int i = 0; i < 16; ++i) dq[i] = 0.f;
      continue;
    }

    // sweep 2: keys from k0 (dbias from column k0 of row a)
    for (int kc = wg * KCH; kc < len; kc += C1 * KCH) {
      if (kc + KCH <= len) {
        ds_chunk<KCH, false>(qa, oa, ks, vs, kc, ta, p.bpitch, g.scale, rm, nl, di, dq, nullptr,
                             p.dpitch, dg + k0, N, k0 + 2 * t4, ok_a, ok_b);
      } else {
        for (int k16 = kc; k16 < len; k16 += 16)
          ds_chunk<16, false>(qa, oa, ks, vs, k16, ta, p.bpitch, g.scale, rm, nl, di, dq,
                              nullptr,
                              p.dpitch, dg + k0, N, k0 + 2 * t4, ok_a, ok_b);
      }
    }
    wgmma_wait<0>();  // dq's products read this stage's K
    fence_regs(dq);
    if (kt + 1 < p.n_kt) continue;
    if (wg > 0) {
      float* x = dqx + (wg - 1) * 16 * 128 + t;
#pragma unroll
      for (int i = 0; i < 16; ++i) x[i * 128] = dq[i];
      named_arrive(3, CT);
      continue;
    }
    named_sync(3, CT);
#pragma unroll
    for (int k = 0; k < C1 - 1; ++k) {
      const float* x = dqx + k * 16 * 128 + t;
#pragma unroll
      for (int i = 0; i < 16; ++i) dq[i] += x[i * 128];
    }
    const int w = mi + (b0 + it) * p.n_groups;
    bf16* dQ = static_cast<bf16*>(g.dq) + (int64_t)w * g.g_w + (int64_t)h * g.g_h;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * t4;
      if (ok_a)
        *reinterpret_cast<__nv_bfloat162*>(dQ + (int64_t)(q0 + ra) * g.g_n + col) =
            __floats2bfloat162_rn(dq[4 * j] * g.scale, dq[4 * j + 1] * g.scale);
      if (ok_b)
        *reinterpret_cast<__nv_bfloat162*>(dQ + (int64_t)(q0 + ra + 8) * g.g_n + col) =
            __floats2bfloat162_rn(dq[4 * j + 2] * g.scale, dq[4 * j + 3] * g.scale);
    }
  }
}

// Launch 2 for a window of more than WHOLE_N tokens: dkdv_bf16's arithmetic
// on a window streamed as query tiles of kt = 128 queries (with the block's
// K and V tiles, and the query tile's row statistics by two bulk copies), in
// step as dq_stream: barrier, reload, the transposed bias + mask tile of the
// query tile, barrier, the warpgroups' chunks. dK and dV of the block's keys
// carry across a window's query tiles and are stored after its last one.
__global__ void __launch_bounds__(THREADS2, 1)
    dkdv_stream(const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
                const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_o,
                BwdArgs g, Plan p) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* ring = align512(smem_raw);  // stages x [K | V | q tile | dO tile | statistics]
  uint16_t* tile = reinterpret_cast<uint16_t*>(ring + p.stages * p.stage_bytes);  // [64][bpitch]
  float* xchg = reinterpret_cast<float*>(tile + BM * p.bpitch);  // [C2 - 1][32][128] dK, dV
  uint64_t* full = reinterpret_cast<uint64_t*>(xchg + (C2 - 1) * 32 * 128);

  const int N = g.n;
  const int k0 = BM * (blockIdx.x % p.tiles), h = (blockIdx.x / p.tiles) % p.heads;
  const int grp = blockIdx.x / p.tiles / p.heads;
  const int mi = grp % p.n_groups, split = grp / p.n_groups;
  const int b0 = split * p.g, nw = min(p.g, p.per_group - b0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int stats_off = 2 * TILE_BYTES + 2 * p.rows_bytes;
  const int items = nw * p.n_kt;

  // the statistics of queries qo .. qo + kt that launch 1 wrote (rows < ns)
  auto load = [&](int s) {
    const int sl = s % p.stages, it = s / p.n_kt, qo = (s - it * p.n_kt) * p.kt;
    const int x = h * D, w = mi + (b0 + it) * p.n_groups;
    const uint32_t sb = 4 * min(p.kt, p.ns - qo);
    uint8_t* st = ring + sl * p.stage_bytes;
    mbar_expect_tx(full + sl, 2 * TILE_BYTES + 2 * p.kt * ROW_BYTES + STATS * sb);
    tma_load_3d(st, &tm_k, full + sl, x, k0, w);
    tma_load_3d(st + TILE_BYTES, &tm_v, full + sl, x, k0, w);
    tma_load_3d(st + 2 * TILE_BYTES, &tm_q, full + sl, x, qo, w);
    tma_load_3d(st + 2 * TILE_BYTES + p.rows_bytes, &tm_o, full + sl, x, qo, w);
    const float* sg = g.stats + ((int64_t)w * p.heads + h) * STATS * p.ns + qo;
    for (int i = 0; i < STATS; ++i)
      bulk_load(st + stats_off + 4 * i * p.kt, sg + i * p.ns, sb, full + sl);
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < p.stages; ++i) mbar_init(full + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < p.stages - 1 && s < items; ++s) load(s);
  }
  __syncthreads();

  constexpr int CT = 128 * C2;
  const bf16* bias = static_cast<const bf16*>(g.bias) + (int64_t)h * N * N;
  const bf16* mask = g.mask ? g.mask + (int64_t)mi * N * N : nullptr;
  const int wg = warp >> 2, t = threadIdx.x & 127, t4 = lane & 3;
  const int ra = 16 * (warp & 3) + (lane >> 2);
  const uint16_t* tt = tile + ra * p.bpitch + 4 * t4;

  uint32_t ka[2][4], va[2][4];
  float dk[16], dv[16];
  for (int s = 0; s < items; ++s) {
    const int sl = s % p.stages, it = s / p.n_kt, qt = s - it * p.n_kt;
    const int qo = qt * p.kt, len = min(p.kt, p.nk - qo);
    named_sync(1, CT);  // item s - 1 is done with its stage and the tile
    if (threadIdx.x == 0 && s + p.stages - 1 < items) load(s + p.stages - 1);
    fill_cols(tile, bias, mask, k0, qo, N, p.bpitch, threadIdx.x, CT);
    named_sync(1, CT);  // the tile is filled
    const uint8_t* st = ring + sl * p.stage_bytes;
    const uint8_t* qs = st + 2 * TILE_BYTES;
    const uint8_t* os = qs + p.rows_bytes;
    const float* sts = reinterpret_cast<const float*>(st + stats_off) + 4 * t4;
    mbar_wait(full + sl, (s / p.stages) & 1);
    if (qt == 0) {
      frag_a(ka, st, warp, lane);
      frag_a(va, st + TILE_BYTES, warp, lane);
#pragma unroll
      for (int i = 0; i < 16; ++i) dk[i] = dv[i] = 0.f;
    }
    for (int qc = wg * KCH; qc < len; qc += C2 * KCH) {
      if (qc + KCH <= len) {
        float sv[32], dp[32];
        uint32_t pa[4][4], da[4][4];
        s_dp<KCH>(sv, dp, ka, va, qs, os, qc);
        dkdv_weights<KCH>(sv, dp, qc, tt, p.bpitch, sts, p.kt, g.scale, pa, da);
        issue_dkdv<KCH>(pa, da, qs, os, qc, dk, dv);
      } else {
        for (int q16 = qc; q16 < len; q16 += 16) {
          float sv[8], dp[8];
          uint32_t pa[1][4], da[1][4];
          s_dp<16>(sv, dp, ka, va, qs, os, q16);
          dkdv_weights<16>(sv, dp, q16, tt, p.bpitch, sts, p.kt, g.scale, pa, da);
          issue_dkdv<16>(pa, da, qs, os, q16, dk, dv);
        }
      }
    }
    wgmma_wait<0>();  // the products read this stage's q and dO
    fence_regs(dk);
    fence_regs(dv);
    if (qt + 1 < p.n_kt) continue;
    if (wg > 0) {
      float* x = xchg + (wg - 1) * 32 * 128 + t;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        x[i * 128] = dk[i];
        x[(16 + i) * 128] = dv[i];
      }
      named_arrive(3, CT);
      continue;
    }
    named_sync(3, CT);
#pragma unroll
    for (int k = 0; k < C2 - 1; ++k) {
      const float* x = xchg + k * 32 * 128 + t;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        dk[i] += x[i * 128];
        dv[i] += x[(16 + i) * 128];
      }
    }
    const int w = mi + (b0 + it) * p.n_groups;
    const int64_t gb = (int64_t)w * g.g_w + (int64_t)h * g.g_h;
    bf16* dK = static_cast<bf16*>(g.dk) + gb;
    bf16* dV = static_cast<bf16*>(g.dv) + gb;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int key = k0 + ra + 8 * hh;
      if (key >= N) continue;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int col = 8 * j + 2 * t4, i = 4 * j + 2 * hh;
        *reinterpret_cast<__nv_bfloat162*>(dK + (int64_t)key * g.g_n + col) =
            __floats2bfloat162_rn(dk[i] * g.scale, dk[i + 1] * g.scale);
        *reinterpret_cast<__nv_bfloat162*>(dV + (int64_t)key * g.g_n + col) =
            __floats2bfloat162_rn(dv[i], dv[i + 1]);
      }
    }
  }
}

}  // namespace hop

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

bool bad_shape(int n, int d, int windows, int heads, const void* mask, int n_masks) {
  return n < 1 || n > 65535 || d < 1 || d > 128 || windows < 1 || windows > 65535 ||
         heads < 1 || heads > 65535 || (mask && (n_masks < 1 || windows % n_masks));
}

// the least x >= n with x % m == r (r < m)
constexpr int at_least(int n, int m, int r) { return n + ((r - n % m) % m + m) % m; }

// the shared memory of a plan: the slack that aligns the ring to the
// swizzle's 512 bytes, the ring, the bias tile, launch 1's slab and
// statistics hand-over, the barriers
int smem_bytes(const hop::Plan& p, int launch) {
  using namespace hop;
  int bytes = 512 + p.stages * p.stage_bytes + BM * p.bpitch * 2 + 2 * p.stages * 8;
  if (launch == 1)
    bytes += (p.slab ? BM * p.dpitch * 4 : 0) + p.stages * C1 * BM * 3 * 4 +
             (C1 - 1) * 16 * 128 * 4;
  else
    bytes += (C2 - 1) * 32 * 128 * 4;
  return bytes;
}

// The schedule of a bf16 backward launch (1: dq, 2: dk and dv). Windows w =
// i + b n_groups share mask i (every window shares the bias without a mask);
// a block takes G = group of them (the host's choice, window_group in
// ops/window_attn3d_train.py). Launch 1 keeps its dbias slab in shared memory
// where it fits beside one stage (N <= ~440), else adds dS to its slot of the
// partial sums per window.
hop::Plan plan_bwd(int windows, int heads, int n, int n_masks, bool masked, int group,
                   int launch) {
  using namespace hop;
  Plan p{};
  p.nk = ((n + 15) & ~15);
  p.tiles = (n + BM - 1) / BM;
  p.ns = p.tiles * BM;
  p.nbox = (p.nk + 255) / 256;
  p.kbox = ((p.nk + p.nbox - 1) / p.nbox + 7) & ~7;
  p.rows_bytes = (p.nbox * p.kbox * ROW_BYTES + 511) & ~511;
  p.bpitch = at_least(p.nk, 32, 16);
  p.dpitch = at_least(p.nk, 32, 16);
  p.n_groups = masked ? n_masks : 1;
  p.per_group = windows / p.n_groups;
  p.heads = heads;
  p.g = group < p.per_group ? group : p.per_group;
  p.splits = (p.per_group + p.g - 1) / p.g;
  p.stream = n > wtile::WHOLE_N;
  if (p.stream) {  // dq_stream, dkdv_stream: tiles of 64 rows a warpgroup, three stages
    p.kt = (launch == 1 ? C1 : C2) * KCH;
    p.n_kt = (p.nk + p.kt - 1) / p.kt;
    p.nbox = 1;
    p.kbox = p.kt;
    p.rows_bytes = p.kt * ROW_BYTES;
    p.bpitch = at_least(p.kt, 32, 16);
    p.stage_bytes = 2 * TILE_BYTES + 2 * p.rows_bytes;
    if (launch == 2) p.stage_bytes += (STATS * p.kt * 4 + 511) & ~511;
    p.slab = 0;
    p.stages = 3;
    if (smem_bytes(p, launch) > SMEM_MAX) p.stages = 0;
    return p;
  }
  p.stage_bytes = 2 * TILE_BYTES + 2 * p.rows_bytes;
  if (launch == 2) p.stage_bytes += (STATS * p.ns * 4 + 511) & ~511;
  p.slab = launch == 1;
  for (;;) {  // two stages, then one; launch 1: with the slab first
    for (p.stages = 2; p.stages >= 1; --p.stages)
      if (smem_bytes(p, launch) <= SMEM_MAX) return p;
    if (!p.slab) break;
    p.slab = 0;
  }
  p.stages = 0;  // does not fit: refused by the caller
  return p;
}

// q, k, v (or dO) of every window: dims (head columns, tokens, windows),
// boxes of [rows, 32] at (h * 32, token, window), 64-byte swizzled; tokens
// past n read as zeros
bool rows_map(CUtensorMap* map, const void* ptr, int64_t cols, int n, int windows, int64_t s_n,
              int64_t s_w, int box_rows) {
  const cuuint64_t dim[3] = {(cuuint64_t)cols, (cuuint64_t)n, (cuuint64_t)windows};
  const cuuint64_t stride[2] = {(cuuint64_t)s_n * 2, (cuuint64_t)s_w * 2};
  const cuuint32_t box[3] = {(cuuint32_t)D, (cuuint32_t)box_rows, 1};
  return hopper::encode_bf16(map, ptr, 3, dim, stride, box, CU_TENSOR_MAP_SWIZZLE_64B);
}

cudaError_t launch_bwd_bf16(const BwdArgs& g, cudaStream_t s) {
  const bool masked = g.mask != nullptr;
  const hop::Plan p1 = plan_bwd(g.windows, g.heads, g.n, g.n_masks, masked, g.group, 1);
  const hop::Plan p2 = plan_bwd(g.windows, g.heads, g.n, g.n_masks, masked, g.group, 2);
  if (!p1.stages || !p2.stages) return cudaErrorInvalidValue;
  const int64_t cols = (int64_t)g.heads * g.s_h;
  CUtensorMap q64, o64, kr, vr, k64, v64, qr, orow;
  if (!rows_map(&q64, g.q, cols, g.n, g.windows, g.s_n, g.s_w, hop::BM) ||
      !rows_map(&o64, g.dout, cols, g.n, g.windows, g.d_n, g.d_w, hop::BM) ||
      !rows_map(&kr, g.k, cols, g.n, g.windows, g.s_n, g.s_w, p1.kbox) ||
      !rows_map(&vr, g.v, cols, g.n, g.windows, g.s_n, g.s_w, p1.kbox) ||
      !rows_map(&k64, g.k, cols, g.n, g.windows, g.s_n, g.s_w, hop::BM) ||
      !rows_map(&v64, g.v, cols, g.n, g.windows, g.s_n, g.s_w, hop::BM) ||
      !rows_map(&qr, g.q, cols, g.n, g.windows, g.s_n, g.s_w, p2.kbox) ||
      !rows_map(&orow, g.dout, cols, g.n, g.windows, g.d_n, g.d_w, p2.kbox))
    return cudaErrorInvalidValue;
  const int64_t blocks = (int64_t)p1.tiles * g.heads * p1.n_groups * p1.splits;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  const int smem1 = smem_bytes(p1, 1), smem2 = smem_bytes(p2, 2);
  const int64_t hnn = (int64_t)g.heads * g.n * g.n;
  const int parts = p1.n_groups * p1.splits;
  cudaError_t e;
  if (!p1.slab) {  // the blocks add into their slots
    e = cudaMemsetAsync(g.part, 0, parts * hnn * sizeof(float), s);
    if (e != cudaSuccess) return e;
  }
  if (p1.stream) {
    e = cudaFuncSetAttribute(hop::dq_stream, cudaFuncAttributeMaxDynamicSharedMemorySize, smem1);
    if (e != cudaSuccess) return e;
    hop::dq_stream<<<(unsigned)blocks, hop::THREADS1, smem1, s>>>(q64, o64, kr, vr, g, p1);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    e = wtile::mma::launch_sum_parts(g.part, g.dbias, parts, hnn, s);
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(hop::dkdv_stream, cudaFuncAttributeMaxDynamicSharedMemorySize, smem2);
    if (e != cudaSuccess) return e;
    hop::dkdv_stream<<<(unsigned)blocks, hop::THREADS2, smem2, s>>>(k64, v64, qr, orow, g, p2);
    return cudaGetLastError();
  }
  if (p1.slab) {
    e = cudaFuncSetAttribute(hop::dq_bf16<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem1);
    if (e != cudaSuccess) return e;
    hop::dq_bf16<true><<<(unsigned)blocks, hop::THREADS1, smem1, s>>>(q64, o64, kr, vr, g, p1);
  } else {
    e = cudaFuncSetAttribute(hop::dq_bf16<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem1);
    if (e != cudaSuccess) return e;
    hop::dq_bf16<false><<<(unsigned)blocks, hop::THREADS1, smem1, s>>>(q64, o64, kr, vr, g, p1);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = wtile::mma::launch_sum_parts(g.part, g.dbias, parts, hnn, s);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(hop::dkdv_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize, smem2);
  if (e != cudaSuccess) return e;
  hop::dkdv_bf16<<<(unsigned)blocks, hop::THREADS2, smem2, s>>>(k64, v64, qr, orow, g, p2);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 float32 (SIMT), 1 bfloat16 (at d = 32 Hopper's wgmma and TMA,
// else mma.sync, window_attn_mma.cuh); d: the head dim, 1 to 128.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for arguments the
// kernels do not take.
extern "C" int k5_fwd(int dtype, const void* q, const void* k, const void* v, int64_t s_w,
                      int64_t s_h, int64_t s_n, void* out, int64_t o_w, int64_t o_h, int64_t o_n,
                      const float* bias, const void* mask, int n_masks, float scale, int windows,
                      int heads, int n, int d, int group, void* stream) {
  if (bad_shape(n, d, windows, heads, mask, n_masks))
    return static_cast<int>(cudaErrorInvalidValue);
  const wtile::Args a{q, k, v, s_w, s_h, s_n, out, o_w, o_h, o_n, bias, mask,
                      mask ? n_masks : 1, scale, n};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the Hopper route's TMA needs 16-byte rows and addresses
  if (wtile::mma::on_wgmma(dtype, d) &&
      (!(aligned16(q) && aligned16(k) && aligned16(v) && aligned16(out) && aligned16(bias) &&
         aligned16(mask)) ||
       (s_w | s_h | s_n | o_w | o_h | o_n) % 8 || group < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (wtile::mma::on_wgmma(dtype, d))
    return static_cast<int>(wtile::launch<wtile::MAX_STABLE>(a, windows, heads, group, s));
  if (dtype == 1) {
    const wtile::mma::MArgs m{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                              static_cast<const bf16*>(v), s_w, s_h, s_n,
                              static_cast<bf16*>(out), o_w, o_h, o_n, bias, mask,
                              mask ? n_masks : 1, nullptr, scale, n, d};
    return static_cast<int>(
        wtile::mma::launch<wtile::mma::M_MAX_STABLE, bf16>(m, windows, heads, s));
  }
  if (dtype == 0)
    return static_cast<int>(
        wtile::simt::launch<wtile::MAX_STABLE, bf16>(a, windows, heads, d, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// The row-statistics stride the bf16 backward needs: stats holds
// windows * heads * 3 * k5_stats_stride(n) floats (hop::STATS rows of statistics).
extern "C" int k5_stats_stride(int n) { return (n + hop::BM - 1) / hop::BM * hop::BM; }

// The slots of dS partial sums a bf16 backward needs: part holds
// k5_bwd_parts(...) * heads * n * n floats (0 for f32, whose SIMT kernel adds
// into dbias by atomics). Launch 1's blocks of one (head, query tile) each
// write a slot (wgmma route: n_groups x splits of them; mma.sync: one a window).
extern "C" int k5_bwd_parts(int dtype, int windows, int heads, int n, int d, int n_masks,
                            int masked, int group) {
  if (wtile::mma::on_wgmma(dtype, d)) {
    const hop::Plan p = plan_bwd(windows, heads, n, n_masks, masked != 0, group, 1);
    return p.n_groups * p.splits;
  }
  return dtype == 1 ? windows : 0;
}

// bias in the compute type; mask bf16 or null; dbias zeroed; part: the
// workspace of k5_bwd_parts slots (bf16). dq, dk, dv:
// in bf16 on the Hopper route (dtype 1, d = 32); else (dtype 0, SIMT; or
// bf16 at another head dim, mma.sync, window_attn_mma.cuh) f32, dk and dv
// zeroed (the kernels add into them). d: the head dim, 1 to 128. group:
// windows a bf16 block takes (G).
extern "C" int k5_bwd(int dtype, const void* q, const void* k, const void* v, int64_t s_w,
                      int64_t s_h, int64_t s_n, const void* dout, int64_t d_w, int64_t d_h,
                      int64_t d_n, void* dq, void* dk, void* dv, int64_t g_w, int64_t g_h,
                      int64_t g_n, const void* bias, const void* mask, int n_masks, float* stats,
                      float* dbias, float* part, float scale, int windows, int heads, int n,
                      int d, int group, void* stream) {
  if (bad_shape(n, d, windows, heads, mask, n_masks) || group < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs g{q, k, v, s_w, s_h, s_n, dout, d_w, d_h, d_n, dq, dk, dv, g_w, g_h, g_n, bias,
            static_cast<const bf16*>(mask), mask ? n_masks : 1, stats, dbias, part, scale, n,
            k5_stats_stride(n), heads, windows, group};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wtile::mma::on_wgmma(dtype, d)) {
    if (!(aligned16(q) && aligned16(k) && aligned16(v) && aligned16(dout) && aligned16(bias) &&
          aligned16(mask) && aligned16(stats)) ||
        s_h != D || d_h != D || (s_w | s_n | d_w | d_n) % 8 || (g_w | g_h | g_n) % 2 ||
        reinterpret_cast<uintptr_t>(dq) % 4 || reinterpret_cast<uintptr_t>(dk) % 4 ||
        reinterpret_cast<uintptr_t>(dv) % 4)
      return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(launch_bwd_bf16(g, s));
  }
  if (dtype == 1) {
    const wtile::mma::MBwdArgs m{
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        s_w, s_h, s_n, static_cast<const bf16*>(dout), d_w, d_h, d_n, static_cast<float*>(dq),
        static_cast<float*>(dk), static_cast<float*>(dv), g_w, g_h, g_n,
        static_cast<const bf16*>(bias), static_cast<const bf16*>(mask), mask ? n_masks : 1,
        dbias, part, scale, n, d};
    return static_cast<int>(wtile::mma::launch_bwd(m, windows, heads, s));
  }
  if (dtype == 0) return static_cast<int>(simt::launch_bwd(g, d, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* k5_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K1: Inception-ResNet-v2 residual block as a short sequence of launches of
// one shifted-GEMM kernel over flat frame-major rows.
//
// Replaces the Pallas kernels
//   deepfake_tpu/ops/pallas_inception.py:229 fused_inception_block_a (_kernel_a :197)
//   deepfake_tpu/ops/pallas_inception.py:149 fused_inception_block   (_kernel   :70)
// which run a whole block A / B / C on VMEM-resident row tiles.
//
// What one launch computes, for rows r of [R, *] (R = frames * H * W, row
// index r = (frame, i, j) row-major, channels contiguous):
//
//   acc[r, n] = sum_{taps (oy, ox)} sum_k  A[src(r, oy, ox), k] * W[tap, k, n]
//
// where src(r, oy, ox) = r + oy * W + ox, and the term is zero when
// (i + oy, j + ox) leaves the frame (the Pallas kernel's roll + boundary
// mask, pallas_inception.py:45-67, :172-194). Accumulation is in f32 for
// both input types (preferred_element_type=f32). The epilogue is either
//   mode 0: out = max(scale[n] * acc + bias[n], 0)      (folded BN + ReLU)
//   mode 1: out = x + T(res_scale * (acc + bias[n]))    (+ ReLU if relu)
// and mode 0 may split its columns between two outputs (a branch that goes
// straight to the concat buffer and the start of the next branch), so that
// block B is x@[w0|w1] -> 1x7 taps -> 7x1 taps -> [b0|h]@[w2a;w2b], and
// block A the same with 3x3 tap sets. The concat is never materialised by a
// copy: each branch's last launch writes its column slice of one buffer.
//
// What bounds it on the H100: at b8 x 32 frames the block sequence is
// compute-bound in bf16 (block B ~83 GFLOP per call against ~0.16 GB of
// activations in and out; a fused b8 request's 40 blocks ~2.55 ms by
// operations). What the card showed of the first design (Ampere-style
// tensor-core tiles, a per-element epilogue; PERF.md, K1's Step 0): its 2-byte
// epilogue stores and residual reads took ~23% of its time, its GEMM core
// ran at ~2.7x the conv-by-conv cuBLAS/cuDNN time, and the tap gather's
// predicate ~4%; the intermediates' trips through device memory (~0.03-0.05
// ms a block by the bound) are not where the time goes, so each conv keeps
// its own launch. What the card shows of this design (PERF.md, K1's
// versions): the products are not what sets it (a build without them runs
// ~10% faster); the loads (the tap convs re-read their box once a tap) and
// an epilogue that the next tile's products do not overlap are.
//
// Routes:
//   - bf16 (serving), Hopper: wgmma + TMA, persistent blocks of two
//     consumer warpgroups and a producer warp (the first version, whose
//     consumers issued the loads and skipped the steps past cin, drew
//     ptxas's C7520: its products were serialised). A unit of work
//     is a row tile, a box of [bf frames, bh rows, bw columns] output pixels
//     (at most 128 rows: at the fused path's shapes [1, 5, 25] = 125 rows in
//     block A, [10, 1, 12] = 120 in B, [5, 5, 5] = 125 in C; a 1 x 1 conv
//     reads its rows flat, 128 a tile), and a column tile of BN outputs,
//     planned on the host (ops/inception_block.py: n <= 224 whole, wider n
//     split into equal tiles that are multiples of 8: 256 = 2 x 128, 320 =
//     2 x 160, 1088 = 8 x 136, 2080 = 10 x 208). A block keeps one column
//     tile (the grid is a multiple of the column tiles): its scale and bias
//     are read once. (Keeping the tile's weights in shared memory for all its
//     units, where they fit, measured the same: PERF.md.) The source is a
//     4D tensor map (channels, W, H, frames) whose
//     channel extent is the conv's cin and whose row stride is the buffer's
//     width, so a column slice of the branch buffers is read in place; tap
//     (oy, ox) of a tile is the box at (c0, j0 + ox, i0 + oy, f0), and TMA
//     fills every pixel outside the frame (negative coordinates included)
//     and every channel past cin with zeros: the halo costs no instruction.
//     The taps' weights come K-major ([taps n, cin], made once by the
//     wrapper) by a 2D map. Both land 128-byte swizzled in a ring of stages
//     (as many as fit, up to 8); each consumer warpgroup runs wgmma
//     m64nBNk16 on its 64 rows, four 16-channel steps a chunk (past cin the
//     operands are zeros). Blocks an SM holds: as many as its registers allow (2 at
//     BN <= 64), the ring sized to fit them. The epilogue rounds the
//     warpgroup's [64, BN] tile into shared memory as bf16 and writes it
//     out while the next tile's loads are in flight: mode 0 in 16-byte runs
//     into either split output; mode 1 (the 1 x 1 out conv, rows flat) adds
//     the residual x from a tile the producer loads by TMA during the
//     tile's products, at the Pallas cast point, and leaves the tile to one
//     TMA store, which drains while the warpgroup goes on.
//   - f32 (the parity route): a shared-memory-tiled SIMT GEMM (128x64 tile,
//     8x4 outputs per thread, f32 FMA) with no TF32 rounding.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <atomic>

#include "hopper.cuh"
#include "wgmma_ss.cuh"

namespace {

struct Args {
  const void* a; int64_t lda; int k;   // A rows [rows, lda]; K columns read
  const void* w;                        // [kh * kw, k, n] row-major
  int kh, kw;                           // tap grid, centred
  int rows, h, wd;                      // R rows; frames are h x wd
  int n;                                // output columns
  int mode;                             // 0 affine+relu, 1 residual
  const float* scale;                   // mode 0: [n]
  const float* bias;                    // mode 0: [n]; mode 1: final conv bias [n]
  const void* x; int64_t ldx;           // mode 1: residual input [rows, ldx]
  float res_scale; int relu;            // mode 1
  void* out0; int64_t ld0; int nsplit;  // columns [0, nsplit) -> out0
  void* out1; int64_t ld1;              // columns [nsplit, n) -> out1
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

// The epilogue for one output element (rr, nn) of the launch.
template <typename T>
__device__ __forceinline__ void emit(const Args& g, int rr, int nn, float acc) {
  if (rr >= g.rows || nn >= g.n) return;
  float v;
  if (g.mode == 0) {
    v = fmaxf(acc * g.scale[nn] + g.bias[nn], 0.f);
  } else {
    // the scaled residual is cast to T before the add, as in the Pallas kernel
    const float res = to_f(from_f<T>(g.res_scale * (acc + g.bias[nn])));
    v = to_f(static_cast<const T*>(g.x)[(int64_t)rr * g.ldx + nn]) + res;
    if (g.relu) v = fmaxf(v, 0.f);
  }
  if (nn < g.nsplit) {
    static_cast<T*>(g.out0)[(int64_t)rr * g.ld0 + nn] = from_f<T>(v);
  } else {
    static_cast<T*>(g.out1)[(int64_t)rr * g.ld1 + (nn - g.nsplit)] = from_f<T>(v);
  }
}

// ------------------------------------------------------------- f32: SIMT

namespace simt {

constexpr int BM = 128;  // rows per block
constexpr int BN = 64;   // output columns per block
constexpr int BK = 16;   // reduction slice per smem stage
constexpr int TM = 8;    // rows per thread
constexpr int TN = 4;    // columns per thread
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256

__global__ void __launch_bounds__(THREADS) shifted_gemm_f32(Args g) {
  __shared__ float As[BK][BM + 4];  // k-major: a thread's TM rows are adjacent
  __shared__ __align__(16) float Bs[BK][BN + 4];

  const float* A = static_cast<const float*>(g.a);
  const float* Wt = static_cast<const float*>(g.w);
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;

  // A loader: one row and 8 consecutive k per thread
  const int lr = tid >> 1, lk = (tid & 1) * 8;
  const int r = row0 + lr;
  const int frame_len = g.h * g.wd;
  const bool row_ok = r < g.rows;
  const int p = row_ok ? r % frame_len : 0;
  const int pi = p / g.wd, pj = p % g.wd;
  // B loader: one k and 4 consecutive n per thread
  const int bk = tid / (BN / 4), bn = (tid % (BN / 4)) * 4;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  const int taps = g.kh * g.kw;
  for (int t = 0; t < taps; ++t) {
    const int oy = t / g.kw - g.kh / 2, ox = t % g.kw - g.kw / 2;
    const int si = pi + oy, sj = pj + ox;
    const bool valid = row_ok && si >= 0 && si < g.h && sj >= 0 && sj < g.wd;
    const float* arow = A + (valid ? (int64_t)(r + oy * g.wd + ox) * g.lda : 0);
    const float* wtap = Wt + (int64_t)t * g.k * g.n;
    for (int k0 = 0; k0 < g.k; k0 += BK) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int kk = k0 + lk + i;
        As[lk + i][lr] = (valid && kk < g.k) ? arow[kk] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kk = k0 + bk, nn = col0 + bn + j;
        Bs[bk][bn + j] = (kk < g.k && nn < g.n) ? wtap[(int64_t)kk * g.n + nn] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float a[TM];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = As[kk][ty * TM + i];
        const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * TN]);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          acc[i][0] = fmaf(a[i], b.x, acc[i][0]);
          acc[i][1] = fmaf(a[i], b.y, acc[i][1]);
          acc[i][2] = fmaf(a[i], b.z, acc[i][2]);
          acc[i][3] = fmaf(a[i], b.w, acc[i][3]);
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j)
      emit<float>(g, row0 + ty * TM + i, col0 + tx * TN + j, acc[i][j]);
}

}  // namespace simt

// ------------------------------------------------------ bf16: Hopper

namespace hop {

using namespace hopper;
typedef __nv_bfloat16 bf16;

constexpr int BM = 128;             // rows of a tile: two wgmma M of 64, one a warpgroup
constexpr int KC = 64;              // channels of a k chunk: one 128-byte swizzled row
constexpr int A_BYTES = BM * 128;   // a chunk's A tile [128 rows][64 channels]: 16 KB
constexpr int WARPGROUPS = 2;
constexpr int THREADS = 128 * WARPGROUPS + 32;  // + a producer warp
constexpr int MAX_BN = 224;          // the widest column tile (wgmma_ss.cuh)
constexpr int MAX_STAGES = 8;
constexpr int SMEM_MAX = 232448;    // dynamic shared memory a block may use

// what the host decides for a launch (ops/inception_block.py plans it)
struct Plan {
  int fr, hh, ww;       // the geometry the rows are read in: frames, rows, columns
                        // (a 1 x 1 conv: 1, 1, R, the rows flat)
  int bf, bh, bw;       // a row tile's box: frames, rows, columns (bf bh bw <= 128)
  int th, tw;           // row tiles along the rows and columns
  int n_tiles, units;   // column tiles of BN; units = row tiles x column tiles
  int kchunks, chunks;  // ceil(cin / 64); taps x kchunks, the k chunks of a unit
  int stages, stage_bytes;
  int x_bytes;          // mode 1: the residual tile [128][BN] (else 0)
};

// the epilogue's staging pitch (bf16): a warpgroup's whole [64, BN] tile,
// + 8 so that the rows a warp writes spread over the banks
__host__ __device__ constexpr int staging_pitch(int bn) { return bn + 8; }
// shared memory besides the ring and the residual tile: alignment slack,
// staging, scale and bias, the tile's output rows, barriers
__host__ __device__ constexpr int fixed_smem(int bn) {
  return 1024 + WARPGROUPS * 64 * staging_pitch(bn) * 2 + 2 * MAX_BN * 4 + BM * 4 +
         (2 * MAX_STAGES + 2) * 8;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ void unpack8(const uint4& v, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

// One conv, persistent: block b takes units b, b + grid, ...; a unit is a
// row tile (a [bf, bh, bw] box of output pixels, at most 128 rows) and a
// column tile of BN outputs. See the note at the top.
template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
    conv_bf16(const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_w,
              const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_o,
              Args g, Plan p) {
  constexpr int ACC = BN / 2, SP = staging_pitch(BN);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  bf16* staging = reinterpret_cast<bf16*>(ring + p.stages * p.stage_bytes);  // [wg][64][SP]
  float* sb = reinterpret_cast<float*>(staging + WARPGROUPS * 64 * SP);  // [scale | bias]
  int* rowtab = reinterpret_cast<int*>(sb + 2 * MAX_BN);                 // [128]
  bf16* xbuf = reinterpret_cast<bf16*>(rowtab + BM);                     // [128][BN]
  uint64_t* full = reinterpret_cast<uint64_t*>(reinterpret_cast<uint8_t*>(xbuf) + p.x_bytes);
  uint64_t* empty = full + MAX_STAGES;
  uint64_t* xfull = empty + MAX_STAGES;  // the residual tile has landed
  uint64_t* xempty = xfull + 1;          // both warpgroups are done with it

  const int tid = threadIdx.x, wg = tid >> 7, t128 = tid & 127;
  const int warp = t128 >> 5, lane = tid & 31;
  const int a_rows = p.bf * p.bh * p.bw;
  const uint32_t tx = (uint32_t)(a_rows + BN) * 128;

  if (tid == 0) {
    for (int i = 0; i < p.stages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, WARPGROUPS);
    }
    mbar_init(xfull, 1);
    mbar_init(xempty, WARPGROUPS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // rows of the A tile past the box are never loaded: zeros, once
  if (a_rows < BM)
    for (int s = 0; s < p.stages; ++s)
      for (int i = tid; i < (BM - a_rows) * 8; i += THREADS)
        reinterpret_cast<uint4*>(ring + s * p.stage_bytes + a_rows * 128)[i] =
            make_uint4(0, 0, 0, 0);
  // a block keeps one column tile (the grid is a multiple of the column
  // tiles): its scale and bias, once
  {
    const int n0 = (blockIdx.x % p.n_tiles) * BN;
    for (int c = tid; c < BN; c += THREADS) {
      const int n = n0 + c;
      sb[c] = n < g.n && g.mode == 0 ? g.scale[n] : 0.f;
      sb[MAX_BN + c] = n < g.n ? g.bias[n] : 0.f;
    }
  }
  fence_async_smem();
  __syncthreads();

  // the producer warp's lane 0 issues every load, in the order the
  // consumers take them: per unit (k-th of this block), each k chunk (tap,
  // 64 channels) into the next ring stage once both warpgroups released it,
  // and in mode 1, after the first chunks that fit the ring, the residual
  // tile of x once unit k - 1's epilogue is done with it (the unit's
  // products then hide its latency)
  if (tid >= 128 * WARPGROUPS) {
    if (lane == 0) {
      int q = 0, k = 0;
      for (int u = blockIdx.x; u < p.units; u += gridDim.x, ++k) {
        const int nt = u % p.n_tiles, rt = u / p.n_tiles;
        const int j0 = (rt % p.tw) * p.bw, i0 = (rt / p.tw % p.th) * p.bh;
        const int f0 = rt / (p.tw * p.th) * p.bf;
        const int x_at = min(p.stages, p.chunks) - 1;
        for (int c = 0; c < p.chunks; ++c, ++q) {
          const int sl = q % p.stages;
          if (q >= p.stages) mbar_wait(empty + sl, ((q / p.stages) & 1) ^ 1);
          const int tap = c / p.kchunks, c0 = (c - tap * p.kchunks) * KC;
          const int oy = tap / g.kw - g.kh / 2, ox = tap % g.kw - g.kw / 2;
          uint8_t* st = ring + sl * p.stage_bytes;
          mbar_expect_tx(full + sl, tx);
          // tap (oy, ox) of the tile: the box shifted by the tap; TMA writes
          // zeros for every pixel outside the frame (the halo)
          tma_load_4d(st, &tm_a, full + sl, c0, j0 + ox, i0 + oy, f0);
          tma_load(st + A_BYTES, &tm_w, full + sl, c0, tap * g.n + nt * BN);
          if (g.mode == 1 && c == x_at) {  // a 1 x 1 conv: the rows are flat, j0 the first
            if (k >= 1) mbar_wait(xempty, (k - 1) & 1);
            mbar_expect_tx(xfull, BM * BN * 2);
            tma_load(xbuf, &tm_x, xfull, nt * BN, j0);
          }
        }
      }
    }
    return;
  }

  bf16* st_wg = staging + wg * 64 * SP;
  int* rows_wg = rowtab + 64 * wg;
  float acc[ACC];
  int pos = 0, k = 0;
  for (int u = blockIdx.x; u < p.units; u += gridDim.x, ++k) {
    const int nt = u % p.n_tiles, rt = u / p.n_tiles;
    int prev = -1;
    for (int c = 0; c < p.chunks; ++c, ++pos) {
      const int sl = pos % p.stages;
      mbar_wait(full + sl, (pos / p.stages) & 1);
      const uint8_t* as = ring + sl * p.stage_bytes + wg * 64 * 128;  // this warpgroup's 64 rows
      const uint8_t* ws = ring + sl * p.stage_bytes + A_BYTES;
      // all four 16-channel steps, with no branch between the products:
      // channels past cin are zeros in A and W (TMA)
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        WgmmaSS<BN>::mma(acc, desc_sw128(as + kk * 32), desc_sw128(ws + kk * 32),
                         c > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait<1>();  // the previous chunk's products are done: free its stage
      if (prev >= 0 && t128 == 0) mbar_arrive(empty + prev);
      prev = sl;
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (t128 == 0) mbar_arrive(empty + prev);

    // the epilogue, staged: the warpgroup's [64, BN] tile goes into shared
    // memory as bf16, then out; the next tile's products start at once, its
    // loads already in flight.
    //   mode 0: max(scale acc + bias, 0), with the output row of each tile
    //   row, then out in 16-byte runs (8 threads a row's 128 bytes) into
    //   either split output; the stores are not waited for.
    //   mode 1 (a 1 x 1 conv, rows flat): x + T(res_scale (acc + bias)), the
    //   Pallas kernel's cast point, x from the residual tile, then out by
    //   one TMA store of the whole [64, BN] tile, which the bulk-copy engine
    //   drains while the warpgroup goes on.
    // Two barriers a tile: the last tile's copy is done with the staging
    // rows; this tile's are written.
    if (g.mode == 1 && t128 == 0) bulk_wait_read();
    named_sync(2 + wg, 128);
    const int sp = g.mode == 1 ? BN : SP;  // TMA stores the staging rows dense
    if (g.mode == 1) {
      mbar_wait(xfull, k & 1);
    } else if (t128 < 64) {
      const int j0 = (rt % p.tw) * p.bw, i0 = (rt / p.tw % p.th) * p.bh;
      const int f0 = rt / (p.tw * p.th) * p.bf;
      const int tr = 64 * wg + t128;
      const int fi = tr / (p.bh * p.bw), rem = tr - fi * p.bh * p.bw;
      const int ii = rem / p.bw, jj = rem - ii * p.bw;
      const int f = f0 + fi, y = i0 + ii, x = j0 + jj;
      rows_wg[t128] = tr < a_rows && f < p.fr && y < p.hh && x < p.ww ? (f * p.hh + y) * p.ww + x
                                                                      : -1;
    }
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = 8 * j + 2 * (lane & 3);
      const float s0 = sb[c], s1 = sb[c + 1], b0 = sb[MAX_BN + c], b1 = sb[MAX_BN + c + 1];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = 16 * warp + (lane >> 2) + 8 * hh;
        float y0 = acc[4 * j + 2 * hh], y1 = acc[4 * j + 2 * hh + 1];
        if (g.mode == 0) {
          y0 = fmaxf(fmaf(y0, s0, b0), 0.f);
          y1 = fmaxf(fmaf(y1, s1, b1), 0.f);
        } else {
          const float2 xv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(xbuf + (64 * wg + r) * BN + c));
          const float2 res = __bfloat1622float2(
              __floats2bfloat162_rn(g.res_scale * (y0 + b0), g.res_scale * (y1 + b1)));
          y0 = xv.x + res.x;
          y1 = xv.y + res.y;
          if (g.relu) {
            y0 = fmaxf(y0, 0.f);
            y1 = fmaxf(y1, 0.f);
          }
        }
        *reinterpret_cast<uint32_t*>(st_wg + r * sp + c) = pack_bf16(y0, y1);
      }
    }
    const int n0 = nt * BN;
    if (g.mode == 1) {
      fence_async_smem();  // the staging rows are read by the bulk-copy engine next
      named_sync(2 + wg, 128);
      if (t128 == 0) {
        mbar_arrive(xempty);  // the warpgroup is done with the residual tile
        tma_store_2d(&tm_o, st_wg, n0, (rt % p.tw) * p.bw + 64 * wg);
        bulk_commit();
      }
      continue;
    }
    named_sync(2 + wg, 128);
    for (int idx = t128; idx < 64 * (BN / 8); idx += 128) {
      const int r = idx / (BN / 8), cc = idx - r * (BN / 8), n = n0 + 8 * cc;
      const int row = rows_wg[r];
      if (row < 0 || n >= g.n) continue;
      const uint4 v = *reinterpret_cast<const uint4*>(st_wg + r * SP + 8 * cc);
      bf16* dst = n < g.nsplit ? static_cast<bf16*>(g.out0) + (int64_t)row * g.ld0 + n
                               : static_cast<bf16*>(g.out1) + (int64_t)row * g.ld1 + (n - g.nsplit);
      *reinterpret_cast<uint4*>(dst) = v;
    }
  }
  if (g.mode == 1 && t128 == 0) bulk_wait();  // the tile stores are complete
}

}  // namespace hop

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// lets hop::conv_bf16<BN> take SMEM_MAX bytes of dynamic shared memory and
// reads how many of its blocks an SM's registers hold, once per device;
// then sizes the ring so that that many blocks fit an SM's shared memory too
// (a small-k conv's chain of waits is hidden by its neighbours on the SM, a
// large one's by a deep ring) and launches as many as the `sms` SMs hold,
// persistent, a multiple of the column tiles
template <int BN>
cudaError_t launch_bn(const CUtensorMap& ta, const CUtensorMap& tw, const CUtensorMap& tx,
                      const CUtensorMap& to, const Args& g, hop::Plan p, int sms,
                      cudaStream_t s) {
  static std::atomic<int> per_sm[hopper::MAX_DEVICES];
  const int slot = hopper::device_slot();
  int ctas = slot >= 0 ? per_sm[slot].load(std::memory_order_acquire) : 0;
  if (ctas <= 0) {
    cudaError_t e = cudaFuncSetAttribute(hop::conv_bf16<BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         hop::SMEM_MAX);
    if (e != cudaSuccess) return e;
    cudaFuncAttributes fa;
    e = cudaFuncGetAttributes(&fa, hop::conv_bf16<BN>);
    if (e != cudaSuccess) return e;
    const int regs = (fa.numRegs + 7) & ~7;  // allocated in units of 8 a thread
    ctas = 65536 / (regs * hop::THREADS);
    if (ctas < 1) ctas = 1;
    if (ctas > 3) ctas = 3;
    if (slot >= 0) per_sm[slot].store(ctas, std::memory_order_release);
  }
  // an SM's 233472 bytes of shared memory, 1 KB of them reserved a block:
  // the most blocks an SM's registers hold whose ring still has 2 stages
  p.x_bytes = g.mode == 1 ? hop::BM * BN * 2 : 0;
  const int fixed = hop::fixed_smem(BN) + p.x_bytes;
  p.stage_bytes = hop::A_BYTES + BN * 128;
  for (; ctas > 1; --ctas)
    if ((233472 / ctas - 1024 - fixed) / p.stage_bytes >= 2) break;
  p.stages = ((ctas > 1 ? 233472 / ctas - 1024 : hop::SMEM_MAX) - fixed) / p.stage_bytes;
  if (p.stages > hop::MAX_STAGES) p.stages = hop::MAX_STAGES;
  if (p.stages < 2) return cudaErrorInvalidValue;
  const int smem = fixed + p.stages * p.stage_bytes;
  int grid = sms * ctas;
  if (grid < p.n_tiles) return cudaErrorInvalidValue;
  grid -= grid % p.n_tiles;  // a block keeps one column tile
  if (grid > p.units) grid = p.units;
  hop::conv_bf16<BN><<<grid, hop::THREADS, smem, s>>>(ta, tw, tx, to, g, p);
  return cudaGetLastError();
}

}  // namespace

// dtype 0 (float32, SIMT): one shifted-GEMM launch as described at the top;
// the bf16 route is k1_conv_bf16. Launches on `stream`; returns
// cudaGetLastError(), or cudaErrorInvalidValue for another dtype.
extern "C" int k1_shifted_gemm(
    int dtype, const void* a, int64_t lda, int k, const void* w, int kh, int kw,
    int rows, int h, int wd, int n, int mode, const float* scale, const float* bias,
    const void* x, int64_t ldx, float res_scale, int relu,
    void* out0, int64_t ld0, int nsplit, void* out1, int64_t ld1, void* stream) {
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  Args g{a, lda, k, w, kh, kw, rows, h, wd, n, mode, scale, bias,
         x, ldx, res_scale, relu, out0, ld0, nsplit, out1, ld1};
  dim3 grid((n + simt::BN - 1) / simt::BN, (rows + simt::BM - 1) / simt::BM);
  simt::shifted_gemm_f32<<<grid, simt::THREADS, 0, static_cast<cudaStream_t>(stream)>>>(g);
  return static_cast<int>(cudaGetLastError());
}

// One bf16 conv on Hopper. wt: the taps' weights K-major, [kh kw n, k]; the
// rows are read as `frames` frames of h x wd pixels (a 1 x 1 conv may pass
// 1, 1, R) in row tiles of [bf, bh, bw] pixels and column tiles of bn, by
// persistent blocks on `sms` SMs. Needs k, n, lda, ldx, ld0, ld1 and nsplit
// (where nsplit < n) multiples of 8 and every pointer 16-byte aligned, and
// mode 1 flat and unsplit; returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int k1_conv_bf16(
    const void* a, int64_t lda, int k, const void* wt, int kh, int kw,
    int frames, int h, int wd, int bf, int bh, int bw, int n, int bn, int sms,
    int mode, const float* scale, const float* bias, const void* x, int64_t ldx,
    float res_scale, int relu, void* out0, int64_t ld0, int nsplit, void* out1, int64_t ld1,
    void* stream) {
  const int64_t rows = (int64_t)frames * h * wd;
  if (k < 8 || k % 8 || n < 8 || n % 8 || lda % 8 || ld0 % 8 || rows < 1 || rows > 0x7fffffff ||
      kh < 1 || kw < 1 || bf < 1 || bh < 1 || bw < 1 || bf * bh * bw > hop::BM || bw > 256 ||
      sms < 1 || !aligned16(a) || !aligned16(wt) || !aligned16(out0) ||
      (mode == 0 && !scale) || !bias || (mode == 1 && (!x || ldx % 8 || !aligned16(x))) ||
      (nsplit < n && (nsplit % 8 || !out1 || ld1 % 8 || !aligned16(out1))) ||
      (mode == 1 && (frames != 1 || h != 1 || bf != 1 || bh != 1 || nsplit < n)))
    return static_cast<int>(cudaErrorInvalidValue);
  Args g{a, lda, k, wt, kh, kw, (int)rows, h, wd, n, mode, scale, bias,
         x, ldx, res_scale, relu, out0, ld0, nsplit, out1, ld1};
  hop::Plan p{};
  p.fr = frames;
  p.hh = h;
  p.ww = wd;
  p.bf = bf;
  p.bh = bh;
  p.bw = bw;
  p.th = (h + bh - 1) / bh;
  p.tw = (wd + bw - 1) / bw;
  p.n_tiles = (n + bn - 1) / bn;
  const int64_t units = (int64_t)((frames + bf - 1) / bf) * p.th * p.tw * p.n_tiles;
  if (units > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  p.units = (int)units;
  p.kchunks = (k + hop::KC - 1) / hop::KC;
  p.chunks = kh * kw * p.kchunks;

  // A: (channels, columns, rows, frames), the channel extent k so that a
  // column slice of a wider buffer is read in place and channels past k are
  // zeros; pixels outside the frame are zeros. W: (k, taps x n).
  CUtensorMap ta, tw, tx{}, to{};
  const cuuint64_t adim[4] = {(cuuint64_t)k, (cuuint64_t)wd, (cuuint64_t)h, (cuuint64_t)frames};
  const cuuint64_t astride[3] = {(cuuint64_t)lda * 2, (cuuint64_t)lda * wd * 2,
                                 (cuuint64_t)lda * wd * h * 2};
  const cuuint32_t abox[4] = {hop::KC, (cuuint32_t)bw, (cuuint32_t)bh, (cuuint32_t)bf};
  const cuuint64_t wdim[2] = {(cuuint64_t)k, (cuuint64_t)kh * kw * n};
  const cuuint64_t wstride[1] = {(cuuint64_t)k * 2};
  const cuuint32_t wbox[2] = {hop::KC, (cuuint32_t)bn};
  if (!hopper::encode_bf16(&ta, a, 4, adim, astride, abox, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !hopper::encode_bf16(&tw, wt, 2, wdim, wstride, wbox, CU_TENSOR_MAP_SWIZZLE_128B))
    return static_cast<int>(cudaErrorInvalidValue);
  if (mode == 1) {  // the residual x [R, n] in [128 rows, bn] tiles; out in [64 rows, bn]
    const cuuint64_t xdim[2] = {(cuuint64_t)n, (cuuint64_t)rows};
    const cuuint64_t xstride[1] = {(cuuint64_t)ldx * 2}, ostride[1] = {(cuuint64_t)ld0 * 2};
    const cuuint32_t xbox[2] = {(cuuint32_t)bn, hop::BM}, obox[2] = {(cuuint32_t)bn, 64};
    if (!hopper::encode_bf16(&tx, x, 2, xdim, xstride, xbox, CU_TENSOR_MAP_SWIZZLE_NONE) ||
        !hopper::encode_bf16(&to, out0, 2, xdim, ostride, obox, CU_TENSOR_MAP_SWIZZLE_NONE))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (bn) {
    case 16: e = launch_bn<16>(ta, tw, tx, to, g, p, sms, s); break;
    case 32: e = launch_bn<32>(ta, tw, tx, to, g, p, sms, s); break;
    case 48: e = launch_bn<48>(ta, tw, tx, to, g, p, sms, s); break;
    case 64: e = launch_bn<64>(ta, tw, tx, to, g, p, sms, s); break;
    case 96: e = launch_bn<96>(ta, tw, tx, to, g, p, sms, s); break;
    case 128: e = launch_bn<128>(ta, tw, tx, to, g, p, sms, s); break;
    case 136: e = launch_bn<136>(ta, tw, tx, to, g, p, sms, s); break;
    case 160: e = launch_bn<160>(ta, tw, tx, to, g, p, sms, s); break;
    case 192: e = launch_bn<192>(ta, tw, tx, to, g, p, sms, s); break;
    case 208: e = launch_bn<208>(ta, tw, tx, to, g, p, sms, s); break;
    case 224: e = launch_bn<224>(ta, tw, tx, to, g, p, sms, s); break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

extern "C" const char* k1_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

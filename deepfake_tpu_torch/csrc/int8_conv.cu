// K7 and K8: the int8 convolutions of the Inception-ResNet-v2 trunk at
// serving (model.irv2_quant = int8 / int8_static).
//
// Replaces no Pallas kernel: the JAX package runs these as XLA ops,
//   deepfake_tpu/models/layers.py:256 quant_conv  (int8 x int8 -> int32
//     conv_general_dilated, then the dequantising epilogue)
//   deepfake_tpu/models/layers.py:224 act_scale_for / :249 quantize_to
//     (the per-tensor max-abs and the quantisation of an activation)
// and PyTorch has no int8 convolution on CUDA (on the CPU an int8
// F.conv2d returns int8 and wraps), so the port needs its own.
//
// K7, k7_int8_conv: an implicit GEMM over NHWC int8 activations,
//   acc[m, n] = sum_k A[m, k] * Wt[n, k],  m = (frame, oy, ox), n = Cout,
//   k = (ky, kx, ci) row-major, A[m, k] = x[frame, oy*s - pt + ky,
//   ox*s - pl + kx, ci] or 0 outside the frame (no im2col buffer), then
//     out[m, n] = T(relu?(__fadd_rn(__fmul_rn(float(acc), __fmul_rn(xs, ws[n])),
//                                   shift[n])))
//   with xs = __fdiv_rn(fmaxf(amax, 1e-12), 127) read from the device scalar
//   `amax` (never from the host). Each rounding is explicit (no FMA
//   contraction), in the JAX order (layers.py:267-270, :322-330), and s32
//   sums of s8 products are exact in any order, so K7 equals its plain
//   version in ops/int8_conv.py to the bit.
//
// What bounds it on the H100: at a fused b8 request (256 frames of 224) the
// stem's convs move the most bytes (f1 and f2 read 100-300 MB of int8 and
// write 200-400 MB of bf16); the 3x3s of 256 to 320 channels in the
// reductions are bound by their products (1,979 TOP/s of dense s8). On the
// card a unit's operands come through TMA at ~8 cycles a 128-byte row and
// ~4 a 32-byte one (PERF.md, K7's redesign), so the design loads few, wide
// rows.
//
// Route 1, Hopper (every conv whose Cin is a multiple of 16): the skeleton
// of K1's bf16 kernel (inception_block.cu) on s8. Persistent blocks of two
// consumer warpgroups and a producer warp; a unit of work is a row tile of
// at most 128 output pixels and a column tile of BN output channels, both
// planned on the host (ops/int8_conv.py::plan: BN = Cout up to 224, wider
// Cout in equal tiles that are multiples of 16, as s8 wgmma takes them; a
// row tile is a [bf, bh, bw] box of output pixels). A block keeps one column
// tile, its xs * ws and shift in shared memory. K runs in ring stages of
// four k32 steps (128 bytes of K): a stage holds 128 / kc chunks of kc
// bytes (32, 64 or 128, the plan's choice by a cost of TMA rows), each an A
// box [rows][kc] and a W box [BN][kc], both swizzled at kc bytes. The
// producer warp's lane 0 issues every load by TMA:
//   - A of a 1x1 stride-1 conv through a 2D map [M, Cin]: the rows flat,
//     128 a tile;
//   - A a box a tap through a 4D map (Cin, W, H, F): tap (ky, kx) of the
//     tile at output (f0, oy0, ox0) is the box at (c0, ox0 s - pl + kx,
//     oy0 s - pt + ky, f0). TMA writes zeros for every pixel outside the
//     frame (negative coordinates included) and every channel past Cin, so
//     the halo and the padding cost no instruction. Stride 2 is the map's
//     traversal stride in W and H (elementStrides 2: a box of 2 bw columns
//     loads every second one, bw of them), not a gather;
//   - A through the wide-row map, where the plan finds it cheaper (kc 128):
//     an output pixel's KW taps of one kernel row are KW Cin contiguous
//     bytes of an input row, so a 4D map (KW Cin, (W - KW) / s + 1, H, F)
//     whose W step is s Cin bytes (its rows overlap) gives them as one box
//     row, and a unit's K is KH rows of KW Cin (f1's 96 bytes of a kernel
//     row in one 128-byte row instead of three 32-byte ones). Its columns
//     are those whose receptive field lies inside the frame; a stride-1
//     conv padded along W reads its pl + pr border columns as a second part
//     of the units, a box a tap. At stride 1 the plan may take the halo:
//     one box of bh + KH - 1 rows of bw (a multiple of 8) columns of one
//     frame, whose tap ky is its rows from ky bw on (whole 128-byte rows, a
//     multiple of the swizzle atom), so the KH taps along H share one load;
//   - W through a 2D map [Cout, K] over the weights as they are stored
//     ([Cout, KH, KW, Cin] is K-major): the chunk's box at its K offset.
//     Where a box runs past its tap's channels it meets the next tap's
//     weights against A's zeros past Cin (or KW Cin). A stage's slots past
//     the last chunk load boxes wholly outside both tensors: zeros.
// Each consumer warpgroup runs wgmma m64nBNk32 s8 on its 64 rows, A and B
// from shared memory, the s32 sums in registers. The epilogue makes the
// roundings above per element from the registers; bf16 out is staged in
// shared memory as the warpgroup's [64, BN] tile and written in 16-byte
// runs (8 channels) while the producer already loads the next unit; f32 out
// (the parity route) is stored from the registers.
//
// Route 2, RGB (at most 4 input channels and KH KW Cin <= 32: the stem's
// f0, 3x3 stride 2 over RGB, K = 27): a TMA box would be one 3-byte pixel,
// and a row of f0's wide map steps 6 bytes, which TMA does not take. A unit
// is a segment of up to 128 output pixels of one output row: its KH input
// row segments come in by byte loads, the block expands them into the
// [128][32] A tile (K zero-filled from 27 to 32) and runs one wgmma
// m64nBNk32 a warpgroup against the weights it keeps; the same epilogue.
//
// Route 3, bytes (any other conv of Cin not a multiple of 16, or an operand
// that is not 16-byte aligned): the first design, kept as it was: blocks of
// 128 output pixels x 64 channels, 8 warps of mma.sync.m16n8k32 s8 tiles,
// the operands gathered a byte at a time into a 3-stage ring, K zero-filled
// to the step.
//
// With `out_amax`, every route's epilogue also takes max |out| over the
// values it stores (after the ReLU and the cast): a thread's running max
// over its units, then per warp by shuffles and one atomicMax on the bits
// into the scalar the entry point zeroed in the stream first. An int8
// consumer of the output then needs no max pass of its own.
//
// K8, two streams bound by HBM, each on a persistent grid sized to the SMs,
// a thread keeping four independent 16-byte loads in flight (evict-first:
// each word is read once): k8_amax takes max |x| over the tensor (block
// maxima into a device array; the last block to finish reduces them and
// writes the scalar, so no memset precedes it; max is order-free, so the
// result repeats to the bit); k8_quantize writes q = clamp(rintf(
// __fdiv_rn(x, scale)), -127, 127) as int8, 16 bytes a store, with scale =
// __fdiv_rn(fmaxf(amax, 1e-12), 127) read from the device scalar, dividing
// as layers.py:251-253 does (the quotient by the reciprocal, the division
// itself only near a half-integer, with the same bits: quotient, near_half),
// half to even as jnp.round.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <atomic>

#include "hopper.cuh"
#include "wgmma_ss.cuh"

namespace i8 {

struct ConvArgs {
  const int8_t* x;     // [F, H, W, C]
  const int8_t* w;     // [N, K], K = KH * KW * C in (ky, kx, ci) order
  const float* amax;   // the activation's max-abs, one f32 on the device
  const float* ws;     // [N] weight scales
  const float* shift;  // [N] folded BatchNorm shift, or the conv bias
  void* out;           // [M, N], M = F * Ho * Wo
  float* out_amax;     // max |out| (as stored) into it, zeroed first; or null
  int F, H, W, C, N, KH, KW, stride, pt, pl, Ho, Wo, K, M, relu, out_bf16;
};

// one output element's epilogue, in the JAX order of roundings
__device__ __forceinline__ float dequant(int acc, float os, float sh, int relu) {
  const float v = __fadd_rn(__fmul_rn(__int2float_rn(acc), os), sh);
  return relu ? (v > 0.f ? v : 0.f) : v;
}

// |v| of the two bf16 in a 32-bit word, as floats (a bf16 is the top half of
// its f32), the larger of them
__device__ __forceinline__ float absmax_bf16x2(uint32_t w) {
  return fmaxf(fabsf(__uint_as_float(w << 16)), fabsf(__uint_as_float(w & 0xffff0000u)));
}

__device__ __forceinline__ float warp_max(float m) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  return m;
}

// the warp's max (every lane present) into *amax: one atomicMax on the bits,
// which order non-negative floats as their values do; max is order-free, so
// the result repeats to the bit
__device__ __forceinline__ void warp_max_to(float m, float* amax) {
  m = warp_max(m);
  if ((threadIdx.x & 31) == 0 && m > 0.f)
    atomicMax(reinterpret_cast<int*>(amax), __float_as_int(m));
}

// ------------------------------------------------------ route 1: Hopper

namespace hop {

using namespace hopper;
typedef __nv_bfloat16 bf16;

constexpr int BM = 128;        // rows of a tile: two wgmma M of 64, one a warpgroup
constexpr int KS = 128;        // bytes of K a ring stage: four k32 steps
constexpr int WARPGROUPS = 2;
constexpr int THREADS = 128 * WARPGROUPS + 32;  // + a producer warp
constexpr int MAX_BN = 224;    // the widest column tile (wgmma_ss.cuh's WgmmaS8)
constexpr int MAX_STAGES = 8;
constexpr int SMEM_MAX = 232448;  // dynamic shared memory a block may use

// one part of a conv's output columns and how its A is read: every column,
// or, on the wide-row map, the columns whose receptive field lies inside
// the frame, and then a second part of the border columns read a box a tap
struct Part {
  int bf, bh, bw;        // a row tile's box of output pixels (flat: 1, 1, 128)
  int tf, th, tw;        // row tiles along frames, output rows, output columns
  int x0, gap_at, gap;   // column tile xt starts at output column x0 + xt bw,
                         // + gap from xt = gap_at on (the right border)
  int x_end;             // the part's columns end before x_end
  int a_rows;            // rows an A box loads: bf bh bw, or (bh + KH - 1) bw
  int ksh;               // taps along H a stage holds: 1, or KH (the halo: one A box of
                         // bh + KH - 1 rows, tap ky its rows from ky bw on, bf = 1)
  int tkw, tc;           // taps along W a row of K holds (KW, or 1 on the wide-row map)
                         // and the bytes of K a tap (Cin, or KW Cin)
  int xs, xo;            // A's W coordinate: ox xs + xo + kx
  int kchunks, chunks;   // ceil(tc / kc); KH / ksh tkw kchunks
  int steps;             // ring stages a unit: ceil(chunks / group)
  int rts;               // row tiles: tf th tw
};

// what the host decides for a launch (ops/int8_conv.py plans it)
struct Plan {
  int flat;              // a 1x1 stride-1 conv: A rows flat through a 2D map
  Part part[2];          // units first of part 0, then of part 1 (none: rts 0)
  int n_tiles, units;    // column tiles of BN; units = row tiles x column tiles
  int kc, group;         // chunk bytes (the swizzle width); chunks a stage, 128 / kc
  int b_at;              // a stage's W boxes start there: after A's rows (128 and
                         // the halo's (KH - 1) bw more), 128 bytes a row
  int stage_bytes;       // b_at + the largest ksh BN 128, in 1024s
  int stages;            // the ring's depth
};

// a unit's part, row tile in it, and first output pixel
struct Unit {
  const Part* q;
  int rt, ox0, oy0, f0;
};
__device__ __forceinline__ Unit unit_of(const Plan& p, int rt) {
  Unit t;
  const bool b = rt >= p.part[0].rts;
  t.q = b ? &p.part[1] : &p.part[0];
  t.rt = b ? rt - p.part[0].rts : rt;
  const Part& q = *t.q;
  const int xt = t.rt % q.tw;
  t.ox0 = q.x0 + xt * q.bw + (xt >= q.gap_at ? q.gap : 0);
  t.oy0 = t.rt / q.tw % q.th * q.bh;
  t.f0 = t.rt / (q.tw * q.th) * q.bf;
  return t;
}

// the epilogue's staging pitch (bf16): a warpgroup's whole [64, BN] tile,
// + 8 so that the rows a warp writes spread over the banks
__host__ __device__ constexpr int staging_pitch(int bn) { return bn + 8; }
// shared memory besides the ring: alignment slack, staging, xs ws and
// shift, the tile's output rows, barriers
__host__ __device__ constexpr int fixed_smem(int bn) {
  return 1024 + WARPGROUPS * 64 * staging_pitch(bn) * 2 + 2 * MAX_BN * 4 + BM * 4 +
         2 * MAX_STAGES * 8;
}

// The epilogue of a warpgroup's [64, BN] tile of s32 sums, once its row
// table (the output row of each tile row, -1 past the conv's edge) is
// written: the roundings per element; f32 out from the registers, bf16 out
// staged in shared memory and written in 16-byte runs (8 threads a row's
// 8-channel runs), the stores not waited for. With g.out_amax, ``omax``
// takes the max |value| of what the thread stores.
template <int BN>
__device__ __forceinline__ void epilogue(const ConvArgs& g, const int (&acc)[BN / 2],
                                         const float* os, const float* sh, bf16* st_wg,
                                         const int* rows_wg, int n0, bool vec_out, float& omax) {
  constexpr int SP = staging_pitch(BN);
  const int t128 = threadIdx.x & 127, warp = t128 >> 5, lane = threadIdx.x & 31;
  const int wg = threadIdx.x >> 7;
  if (!g.out_bf16) {  // f32: from the registers
    named_sync(2 + wg, 128);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = 8 * j + 2 * (lane & 3), n = n0 + c;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = rows_wg[16 * warp + (lane >> 2) + 8 * hh];
        if (row < 0 || n >= g.N) continue;
        const float v0 = dequant(acc[4 * j + 2 * hh], os[c], sh[c], g.relu);
        const float v1 = dequant(acc[4 * j + 2 * hh + 1], os[c + 1], sh[c + 1], g.relu);
        float* out = static_cast<float*>(g.out) + (int64_t)row * g.N + n;
        if (n + 1 < g.N && (g.N & 1) == 0) {
          *reinterpret_cast<float2*>(out) = make_float2(v0, v1);
        } else {
          out[0] = v0;
          if (n + 1 < g.N) out[1] = v1;
        }
        if (g.out_amax) omax = fmaxf(omax, n + 1 < g.N ? fmaxf(fabsf(v0), fabsf(v1)) : fabsf(v0));
      }
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = 8 * j + 2 * (lane & 3);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = 16 * warp + (lane >> 2) + 8 * hh;
      const float v0 = dequant(acc[4 * j + 2 * hh], os[c], sh[c], g.relu);
      const float v1 = dequant(acc[4 * j + 2 * hh + 1], os[c + 1], sh[c + 1], g.relu);
      *reinterpret_cast<__nv_bfloat162*>(st_wg + r * SP + c) =
          __halves2bfloat162(__float2bfloat16_rn(v0), __float2bfloat16_rn(v1));
    }
  }
  named_sync(2 + wg, 128);
  for (int idx = t128; idx < 64 * (BN / 8); idx += 128) {
    const int r = idx / (BN / 8), cc = idx - r * (BN / 8), n = n0 + 8 * cc;
    const int row = rows_wg[r];
    if (row < 0 || n >= g.N) continue;
    const bf16* src = st_wg + r * SP + 8 * cc;
    bf16* dst = static_cast<bf16*>(g.out) + (int64_t)row * g.N + n;
    if (vec_out) {
      const uint4 v = *reinterpret_cast<const uint4*>(src);
      *reinterpret_cast<uint4*>(dst) = v;
      if (g.out_amax)
        omax = fmaxf(omax, fmaxf(fmaxf(absmax_bf16x2(v.x), absmax_bf16x2(v.y)),
                                 fmaxf(absmax_bf16x2(v.z), absmax_bf16x2(v.w))));
    } else {
      for (int e = 0; e < 8 && n + e < g.N; ++e) {
        dst[e] = src[e];
        if (g.out_amax) omax = fmaxf(omax, fabsf(__bfloat162float(src[e])));
      }
    }
  }
}

// One conv, persistent: block b takes units b, b + grid, ...; see the note
// at the top.
template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
    conv_s8(const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_b,
            const __grid_constant__ CUtensorMap tm_w, const ConvArgs g,
            const __grid_constant__ Plan p) {
  constexpr int ACC = BN / 2, SP = staging_pitch(BN);
  const int SB = p.stage_bytes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  bf16* staging = reinterpret_cast<bf16*>(ring + p.stages * SB);   // [wg][64][SP]
  float* os = reinterpret_cast<float*>(staging + WARPGROUPS * 64 * SP);  // xs ws[n]
  float* sh = os + MAX_BN;                                         // shift[n]
  int* rowtab = reinterpret_cast<int*>(sh + MAX_BN);               // [128]
  uint64_t* full = reinterpret_cast<uint64_t*>(rowtab + BM);
  uint64_t* empty = full + MAX_STAGES;

  const int tid = threadIdx.x, wg = tid >> 7, t128 = tid & 127, lane = tid & 31;

  if (tid == 0) {
    for (int i = 0; i < p.stages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, WARPGROUPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // a block keeps one column tile (the grid is a multiple of the column
  // tiles): its xs ws[n] and shift[n], once
  {
    const float xs = __fdiv_rn(fmaxf(*g.amax, 1e-12f), 127.0f);
    const int n0 = (blockIdx.x % p.n_tiles) * BN;
    for (int c = tid; c < BN; c += THREADS) {
      const int n = n0 + c;
      os[c] = n < g.N ? __fmul_rn(xs, g.ws[n]) : 0.f;
      sh[c] = n < g.N ? g.shift[n] : 0.f;
    }
  }
  __syncthreads();

  // the producer warp's lane 0 issues every load, in the order the
  // consumers take them: per unit, each stage of `group` chunks into the
  // next ring slot once both warpgroups released it
  if (tid >= 128 * WARPGROUPS) {
    if (lane == 0) {
      int i = 0;
      for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
        const int nt = u % p.n_tiles;
        const Unit t = unit_of(p, u / p.n_tiles);
        const Part& q = *t.q;
        const CUtensorMap* ma = t.q == &p.part[0] ? &tm_a : &tm_b;
        const int ix0 = t.ox0 * q.xs + q.xo, iy0 = t.oy0 * g.stride - g.pt;
        const uint32_t tx = (uint32_t)(q.a_rows + q.ksh * BN) * KS;
        for (int s = 0; s < q.steps; ++s, ++i) {
          const int sl = i % p.stages;
          if (i >= p.stages) mbar_wait(empty + sl, ((i / p.stages) & 1) ^ 1);
          uint8_t* st = ring + sl * SB;
          mbar_expect_tx(full + sl, tx);
          for (int j = 0; j < p.group; ++j) {
            const int c = s * p.group + j;
            const bool real = c < q.chunks;  // else boxes wholly outside: zeros
            const int tap = real ? c / q.kchunks : 0;  // of KH / ksh tkw
            const int c0 = real ? (c - tap * q.kchunks) * p.kc : q.kchunks * p.kc;
            const int ky = tap / q.tkw * q.ksh, kx = tap - tap / q.tkw * q.tkw;
            uint8_t* a = st + j * BM * p.kc;
            if (p.flat)
              tma_load(a, ma, full + sl, c0, t.rt * BM);
            else
              tma_load_4d(a, ma, full + sl, c0, ix0 + kx, iy0 + ky, t.f0);
            for (int h = 0; h < q.ksh; ++h)  // the stage's taps along H, ky + h
              tma_load(st + p.b_at + (h * p.group + j) * BN * p.kc, &tm_w, full + sl,
                       real ? ((ky + h) * q.tkw + kx) * q.tc + c0 : g.K, nt * BN);
          }
        }
      }
    }
    return;
  }

  // the four k32 steps of a stage: chunk j = 32 kk / kc, 32-byte column
  // (32 kk) % kc of it
  int a_off[KS / 32], b_off[KS / 32];
#pragma unroll
  for (int kk = 0; kk < KS / 32; ++kk) {
    const int j = kk * 32 / p.kc, col = kk * 32 - j * p.kc;
    a_off[kk] = j * BM * p.kc + wg * 64 * p.kc + col;
    b_off[kk] = p.b_at + j * BN * p.kc + col;
  }
  bf16* st_wg = staging + wg * 64 * SP;
  int* rows_wg = rowtab + 64 * wg;
  const bool vec_out = (g.N & 7) == 0 && (reinterpret_cast<uintptr_t>(g.out) & 15) == 0;
  int acc[ACC];
  int pos = 0;
  float omax = 0.f;  // max |out| of this thread's stores (g.out_amax)
  for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
    const int nt = u % p.n_tiles;
    const Unit t = unit_of(p, u / p.n_tiles);
    const Part& q = *t.q;
    int prev = -1;
    for (int s = 0; s < q.steps; ++s, ++pos) {
      const int sl = pos % p.stages;
      mbar_wait(full + sl, (pos / p.stages) & 1);
      const uint8_t* st = ring + sl * SB;
      // the stage's four k32 steps for each tap along H it holds; tap ky + h
      // reads the halo's rows from h bw on (whole rows of 128 bytes: h bw 128
      // is a multiple of the swizzle atom's 1024 where the plan takes the
      // halo), all four steps with no branch between the products
      for (int h = 0; h < q.ksh; ++h) {
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KS / 32; ++kk)
          WgmmaS8<BN>::mma(acc, desc_sw(st + h * q.bw * KS + a_off[kk], p.kc),
                           desc_sw(st + h * BN * KS + b_off[kk], p.kc), s > 0 || h > 0 || kk > 0);
        wgmma_commit();
        wgmma_wait<1>();  // the previous stage's products are done: free its slot
        if (h == 0 && prev >= 0 && t128 == 0) mbar_arrive(empty + prev);
      }
      prev = sl;
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (t128 == 0) mbar_arrive(empty + prev);

    // the epilogue: the output row of each of the warpgroup's 64 tile rows
    // (-1: past the conv's edge), then the roundings per element. The
    // barrier first: the last unit's stores are done with the staging rows.
    named_sync(2 + wg, 128);
    if (t128 < 64) {
      const int tr = 64 * wg + t128;
      int row = -1;
      if (p.flat) {
        row = t.rt * BM + tr < g.M ? t.rt * BM + tr : -1;
      } else if (tr < q.bf * q.bh * q.bw) {
        const int fi = tr / (q.bh * q.bw), rem = tr - fi * q.bh * q.bw;
        const int yi = rem / q.bw, f = t.f0 + fi, y = t.oy0 + yi, x = t.ox0 + rem - yi * q.bw;
        row = f < g.F && y < g.Ho && x < q.x_end ? (f * g.Ho + y) * g.Wo + x : -1;
      }
      rows_wg[t128] = row;
    }
    epilogue<BN>(g, acc, os, sh, st_wg, rows_wg, nt * BN, vec_out, omax);
  }
  if (g.out_amax) warp_max_to(omax, g.out_amax);
}

// ------------------------------------------------------ route 2: RGB

constexpr int RGB_K = 32;            // K of the route: one k32 step (KH KW Cin <= 32)
constexpr int RGB_ROW_BYTES = 1056;  // an input row segment: ((128 - 1) 2 + 7) 4, rounded to 16
constexpr int RGB_THREADS = 128 * WARPGROUPS;

// byte offset of K byte k of row r in a [rows][32] tile swizzled at 32 bytes
__device__ __forceinline__ int sw32_offset(int r, int k) {
  return r * 32 + ((((k >> 4) ^ (r >> 2)) & 1) << 4) + (k & 15);
}

// One conv of at most 4 input channels and K <= 32 (the RGB stem f0: 3x3
// stride 2, K = 27), persistent: block b takes units b, b + grid, ...; a
// unit is a segment of bw <= 128 output pixels of one output row and a
// column tile. Per unit the KH input row segments it reads come in by plain
// byte loads (zeros outside the frame); the block expands them into the A
// tile [128][32], K = (ky, kx, ci) zero-filled past KH KW Cin; each
// warpgroup runs one wgmma m64nBNk32 s8 on its 64 rows against the block's
// weights [BN][32], then the shared epilogue.
template <int BN>
__global__ void __launch_bounds__(RGB_THREADS)
    conv_rgb(const ConvArgs g, int bw, int tw, int n_tiles, int units) {
  constexpr int SP = staging_pitch(BN);
  __shared__ __align__(1024) int8_t A[BM * RGB_K];
  __shared__ __align__(1024) int8_t B[BN * RGB_K];
  __shared__ __align__(16) int8_t rowbuf[7][RGB_ROW_BYTES];
  __shared__ __align__(16) bf16 staging[WARPGROUPS * 64 * SP];
  __shared__ float os[BN], sh[BN];
  __shared__ int rowtab[BM];

  const int tid = threadIdx.x, wg = tid >> 7, t128 = tid & 127;
  const int n0 = (blockIdx.x % n_tiles) * BN;  // a block keeps one column tile
  {
    const float xs = __fdiv_rn(fmaxf(*g.amax, 1e-12f), 127.0f);
    for (int c = tid; c < BN; c += RGB_THREADS) {
      const int n = n0 + c;
      os[c] = n < g.N ? __fmul_rn(xs, g.ws[n]) : 0.f;
      sh[c] = n < g.N ? g.shift[n] : 0.f;
    }
    for (int i = tid; i < BN * RGB_K; i += RGB_THREADS) {
      const int n = i / RGB_K, k = i - n * RGB_K;
      B[sw32_offset(n, k)] = n0 + n < g.N && k < g.K ? g.w[(int64_t)(n0 + n) * g.K + k] : 0;
    }
  }
  bf16* st_wg = staging + wg * 64 * SP;
  int* rows_wg = rowtab + 64 * wg;
  const bool vec_out = (g.N & 7) == 0 && (reinterpret_cast<uintptr_t>(g.out) & 15) == 0;
  const int rb = ((bw - 1) * g.stride + g.KW) * g.C;  // bytes of a row segment
  // each K byte's place in the row segments (ky, kx, ci), -1 past K
  __shared__ int src[RGB_K];
  if (tid < RGB_K) {
    const int ky = tid / (g.KW * g.C), rem = tid - ky * g.KW * g.C;
    src[tid] = tid < g.K ? ky * RGB_ROW_BYTES + rem : -1;
  }
  const int64_t row_bytes = (int64_t)g.W * g.C;
  float omax = 0.f;  // max |out| of this thread's stores (g.out_amax)
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int rt = u / n_tiles, fy = rt / tw;  // fy = frame Ho + output row
    const int f = fy / g.Ho, oy = fy - f * g.Ho, ox0 = (rt - fy * tw) * bw;
    const int ix0 = ox0 * g.stride - g.pl;
    __syncthreads();  // the last unit's products are done with A
    // the row segments: a segment inside its row, from a 4-byte aligned
    // start, in 4-byte words up to the row's last whole word; the rest, and
    // any segment reaching out of the frame, a byte at a time
    for (int ky = 0; ky < g.KH; ++ky) {
      const int iy = oy * g.stride - g.pt + ky;
      int8_t* dst = rowbuf[ky];
      if (iy < 0 || iy >= g.H) {
        for (int b = tid; b < rb; b += RGB_THREADS) dst[b] = 0;
        continue;
      }
      const int8_t* row = g.x + ((int64_t)f * g.H + iy) * row_bytes;
      const int64_t start = (int64_t)ix0 * g.C;
      int words = 0;
      if (start >= 0 && (reinterpret_cast<uintptr_t>(row + start) & 3) == 0) {
        const int64_t in_row = row_bytes - start;  // bytes from start to the row's end
        words = (int)((rb < in_row ? rb : in_row) >> 2);
        for (int i = tid; i < words; i += RGB_THREADS)
          reinterpret_cast<uint32_t*>(dst)[i] = reinterpret_cast<const uint32_t*>(row + start)[i];
      }
      for (int b = 4 * words + tid; b < rb; b += RGB_THREADS) {
        const int64_t at = start + b;
        dst[b] = at >= 0 && at < row_bytes ? row[at] : 0;
      }
    }
    __syncthreads();
    for (int i = tid; i < BM * 2; i += RGB_THREADS) {  // a 16-byte half of a row each
      const int r = i >> 1, h = i & 1;
      uint32_t v[4] = {0u, 0u, 0u, 0u};
      if (r < bw) {
        const int8_t* at = &rowbuf[0][0] + r * g.stride * g.C;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int o = src[16 * h + j];
          if (o >= 0)
            v[j >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(at[o])) << (8 * (j & 3));
        }
      }
      *reinterpret_cast<uint4*>(A + sw32_offset(r, 16 * h)) = make_uint4(v[0], v[1], v[2], v[3]);
    }
    fence_async_smem();  // the tiles' generic writes, seen by wgmma
    __syncthreads();
    int acc[BN / 2];
    wgmma_fence();
    WgmmaS8<BN>::mma(acc, desc_sw(A + wg * 64 * RGB_K, RGB_K), desc_sw(B, RGB_K), 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    named_sync(2 + wg, 128);  // the last unit's stores are done with the staging rows
    if (t128 < 64) {
      const int r = 64 * wg + t128;
      rows_wg[t128] = r < bw && ox0 + r < g.Wo ? fy * g.Wo + ox0 + r : -1;
    }
    epilogue<BN>(g, acc, os, sh, st_wg, rows_wg, n0, vec_out, omax);
  }
  if (g.out_amax) warp_max_to(omax, g.out_amax);
}

}  // namespace hop

// ------------------------------------------------------ route 3: bytes

namespace bytes {

constexpr int BM = 128;       // output pixels a block
constexpr int BN = 64;        // output channels a block
constexpr int BK = 64;        // bytes of K a step (two k32 products)
constexpr int LDS = BK + 16;  // a shared row: 80 bytes, conflict-free fragments
constexpr int STAGES = 3;
constexpr int THREADS = 256;

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One output pixel's place in the input: the frame's first byte and the
// top-left corner of its receptive field (negative inside the padding).
struct Pixel {
  int64_t base;
  int iy0, ix0;
  bool valid;
};

__device__ __forceinline__ Pixel pixel(const ConvArgs& g, int m) {
  Pixel p;
  p.valid = m < g.M;
  const int mm = p.valid ? m : 0;
  const int hw = g.Ho * g.Wo;
  const int f = mm / hw;
  const int r = mm - f * hw;
  const int oy = r / g.Wo;
  const int ox = r - oy * g.Wo;
  p.base = (int64_t)f * g.H * g.W * g.C;
  p.iy0 = oy * g.stride - g.pt;
  p.ix0 = ox * g.stride - g.pl;
  return p;
}

// The address of A[pixel, k] (one tap, channel ci of it), or null outside
// the frame and past K.
__device__ __forceinline__ const int8_t* a_src(const ConvArgs& g, const Pixel& p, int k) {
  if (!p.valid || k >= g.K) return nullptr;
  const int tap = k / g.C;
  const int ci = k - tap * g.C;
  const int ky = tap / g.KW;
  const int kx = tap - ky * g.KW;
  const int iy = p.iy0 + ky, ix = p.ix0 + kx;
  if (iy < 0 || iy >= g.H || ix < 0 || ix >= g.W) return nullptr;
  return g.x + p.base + ((int64_t)iy * g.W + ix) * g.C + ci;
}

// One K step's operands into one slot of the ring, byte by byte through
// registers: 2 A chunks and 1 B chunk of 16 bytes a thread.
__device__ __forceinline__ void load_step(const ConvArgs& g, int8_t* As, int8_t* Bs,
                                          const Pixel (&px)[2], int n_row, int kc, int k0) {
  const int k = k0 + kc * 16;
  const int a_row = threadIdx.x >> 2;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    uint32_t v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int8_t* src = a_src(g, px[i], k + j);
      const uint32_t b = src ? static_cast<uint8_t>(*src) : 0u;
      v[j >> 2] |= b << (8 * (j & 3));
    }
    *reinterpret_cast<uint4*>(As + (a_row + i * 64) * LDS + kc * 16) =
        make_uint4(v[0], v[1], v[2], v[3]);
  }
  uint32_t v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const bool bv = n_row < g.N && k + j < g.K;
    const uint32_t b = bv ? static_cast<uint8_t>(g.w[(int64_t)n_row * g.K + k + j]) : 0u;
    v[j >> 2] |= b << (8 * (j & 3));
  }
  *reinterpret_cast<uint4*>(Bs + a_row * LDS + kc * 16) = make_uint4(v[0], v[1], v[2], v[3]);
}

__global__ void __launch_bounds__(THREADS) conv_kernel(const ConvArgs g) {
  __shared__ __align__(16) int8_t As[STAGES][BM * LDS];
  __shared__ __align__(16) int8_t Bs[STAGES][BN * LDS];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;  // the warp's 32 x 32 tile
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;

  // this thread's two A rows and one B row, the same at every step
  const int kc = tid & 3;
  Pixel px[2];
  px[0] = pixel(g, m0 + (tid >> 2));
  px[1] = pixel(g, m0 + (tid >> 2) + 64);
  const int n_row = n0 + (tid >> 2);

  int acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

  const int steps = (g.K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s)
    if (s < steps) load_step(g, As[s], Bs[s], px, n_row, kc, s * BK);
  for (int t = 0; t < steps; ++t) {
    __syncthreads();
    const int pre = t + STAGES - 1;
    if (pre < steps) load_step(g, As[pre % STAGES], Bs[pre % STAGES], px, n_row, kc, pre * BK);
    const int8_t* a = As[t % STAGES];
    const int8_t* b = Bs[t % STAGES];
#pragma unroll
    for (int ks = 0; ks < BK; ks += 32) {
      uint32_t af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int8_t* r0 = a + (wm * 32 + mi * 16 + gid) * LDS + ks + tig * 4;
        const int8_t* r8 = r0 + 8 * LDS;
        af[mi][0] = *reinterpret_cast<const uint32_t*>(r0);
        af[mi][1] = *reinterpret_cast<const uint32_t*>(r8);
        af[mi][2] = *reinterpret_cast<const uint32_t*>(r0 + 16);
        af[mi][3] = *reinterpret_cast<const uint32_t*>(r8 + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int8_t* c0 = b + (wn * 32 + ni * 8 + gid) * LDS + ks + tig * 4;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(c0);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(c0 + 16);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) mma_s8(acc[mi][ni], af[mi], b0, b1);
      }
    }
  }

  // epilogue: per output channel, explicit roundings in the JAX order
  const float xs = __fdiv_rn(fmaxf(*g.amax, 1e-12f), 127.0f);
  float omax = 0.f;  // max |out| of this thread's stores (g.out_amax)
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int n = n0 + wn * 32 + ni * 8 + tig * 2;
    float os[2], sh[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const bool in = n + j < g.N;
      os[j] = in ? __fmul_rn(xs, g.ws[n + j]) : 0.f;
      sh[j] = in ? g.shift[n + j] : 0.f;
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm * 32 + mi * 16 + gid + h * 8;
        if (m >= g.M) continue;
        float v[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) v[j] = dequant(acc[mi][ni][h * 2 + j], os[j], sh[j], g.relu);
        const int64_t o = (int64_t)m * g.N + n;
        const bool pair = n + 1 < g.N && (g.N & 1) == 0;
#pragma unroll
        for (int j = 0; j < 2; ++j)  // the value as stored
          if (g.out_amax && n + j < g.N)
            omax = fmaxf(omax, fabsf(g.out_bf16 ? __bfloat162float(__float2bfloat16_rn(v[j]))
                                                : v[j]));
        if (g.out_bf16) {
          __nv_bfloat16* out = static_cast<__nv_bfloat16*>(g.out) + o;
          if (pair) {
            *reinterpret_cast<__nv_bfloat162*>(out) =
                __halves2bfloat162(__float2bfloat16_rn(v[0]), __float2bfloat16_rn(v[1]));
          } else {
            if (n < g.N) out[0] = __float2bfloat16_rn(v[0]);
            if (n + 1 < g.N) out[1] = __float2bfloat16_rn(v[1]);
          }
        } else {
          float* out = static_cast<float*>(g.out) + o;
          if (pair) {
            *reinterpret_cast<float2*>(out) = make_float2(v[0], v[1]);
          } else {
            if (n < g.N) out[0] = v[0];
            if (n + 1 < g.N) out[1] = v[1];
          }
        }
      }
    }
  }
  if (g.out_amax) warp_max_to(omax, g.out_amax);
}

}  // namespace bytes

// ------------------------------------------------------------------- K8

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

constexpr int K8_THREADS = 256;
constexpr int K8_LOADS = 4;           // independent 16-byte loads in flight a thread
constexpr int K8_BLOCKS_PER_SM = 8;   // 2048 threads: an SM's most
constexpr int K8_MAX_GRID = 2048;

// k8_amax's block maxima and its count of blocks done (zero when the module
// loads, and again after every launch: the last block resets it), one set a
// device: two k8_amax launches on one device must not overlap (each path of
// the port launches them in one stream)
__device__ float k8_partial[K8_MAX_GRID];
__device__ unsigned int k8_arrived;

// max |v| over a 16-byte word of f32 or bf16 elements
template <typename T>
__device__ __forceinline__ float absmax16(uint4 v) {
  if (sizeof(T) == 2)
    return fmaxf(fmaxf(absmax_bf16x2(v.x), absmax_bf16x2(v.y)),
                 fmaxf(absmax_bf16x2(v.z), absmax_bf16x2(v.w)));
  return fmaxf(fmaxf(fabsf(__uint_as_float(v.x)), fabsf(__uint_as_float(v.y))),
               fmaxf(fabsf(__uint_as_float(v.z)), fabsf(__uint_as_float(v.w))));
}

// the block's max, in thread 0 (every thread present)
__device__ __forceinline__ float block_max(float m) {
  __shared__ float part[K8_THREADS / 32];
  m = warp_max(m);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = m;
  __syncthreads();
  m = threadIdx.x < K8_THREADS / 32 ? part[threadIdx.x] : 0.f;
  return threadIdx.x < 32 ? warp_max(m) : m;
}

// amax[0] = max |x| over n elements, nvec of them 16-byte words (0 where x is
// not 16-byte aligned). Persistent: block b takes the chunks of K8_THREADS
// K8_LOADS contiguous words b, b + grid, ..., each thread K8_LOADS words of a
// chunk (one coalesced row a load) loaded before any is reduced, evict-first
// (each is read once); the words past the last whole chunk grid-stride. Each
// block writes its max to k8_partial; the last block to finish reduces them
// into amax[0] and resets the count, so no memset is needed before a launch.
template <typename T>
__global__ void __launch_bounds__(K8_THREADS) amax_stream(const T* __restrict__ x, int64_t n,
                                                          int64_t nvec, float* __restrict__ amax) {
  constexpr int CHUNK = K8_THREADS * K8_LOADS;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  const int64_t stride = (int64_t)gridDim.x * K8_THREADS;
  float m = 0.f;
  for (int64_t c = (int64_t)blockIdx.x * CHUNK + threadIdx.x; c - threadIdx.x + CHUNK <= nvec;
       c += (int64_t)gridDim.x * CHUNK) {
    uint4 v[K8_LOADS];
#pragma unroll
    for (int j = 0; j < K8_LOADS; ++j) v[j] = __ldcs(xv + c + j * K8_THREADS);
#pragma unroll
    for (int j = 0; j < K8_LOADS; ++j) m = fmaxf(m, absmax16<T>(v[j]));
  }
  for (int64_t i = nvec / CHUNK * CHUNK + (int64_t)blockIdx.x * K8_THREADS + threadIdx.x;
       i < nvec; i += stride)
    m = fmaxf(m, absmax16<T>(__ldcs(xv + i)));
  for (int64_t e = nvec * (16 / sizeof(T)) + (int64_t)blockIdx.x * K8_THREADS + threadIdx.x;
       e < n; e += stride)
    m = fmaxf(m, fabsf(to_f32(x[e])));
  m = block_max(m);
  __shared__ bool last;
  if (threadIdx.x == 0) {
    k8_partial[blockIdx.x] = m;
    __threadfence();  // the block's max is seen before its arrival is counted
    last = atomicAdd(&k8_arrived, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  float r = 0.f;
  for (int b = threadIdx.x; b < (int)gridDim.x; b += K8_THREADS)
    r = fmaxf(r, __ldcg(k8_partial + b));
  r = block_max(r);
  if (threadIdx.x == 0) {
    *amax = r;
    k8_arrived = 0u;
  }
}

// The int8 quantiser's quotient v / scale, as __fdiv_rn gives it to rint,
// from rcp = RN(1 / scale) (the division's own range check sends every zero,
// half of a ReLU output, to its slow path): q0 = RN(v rcp) lies within 2 ulps
// of v / scale and the correctly rounded quotient within half an ulp, so
// where q0 is more than 2^-13 (at least 4 ulps below 256) from a half-integer
// rint takes both alike and q0 stands (past 256 only its sign matters);
// near_half(q0, rint(q0)) says where it does not, and there the caller
// divides.
__device__ __forceinline__ float quotient(float v, float rcp) {
  const float q0 = __fmul_rn(v, rcp);
  return fabsf(q0) < 256.f ? q0 : copysignf(256.f, v);
}
__device__ __forceinline__ bool near_half(float q, float r) {
  return fabsf(q - r) >= 0.5f - 0x1p-13f;
}
// an integral r clamped to [-127, 127], as an int8's bits
__device__ __forceinline__ uint32_t to_q8(float r) {
  return static_cast<uint8_t>(static_cast<int8_t>(__float2int_rn(fminf(fmaxf(r, -127.f), 127.f))));
}
__device__ __forceinline__ uint32_t quantize1(float v, float scale, float rcp) {
  const float q = quotient(v, rcp), r = rintf(q);
  return to_q8(near_half(q, r) ? rintf(__fdiv_rn(v, scale)) : r);
}

// element e of a unit's words (f32: one a word; bf16: two, the low half first)
template <typename T>
__device__ __forceinline__ float element(const uint32_t* w, int e) {
  if (sizeof(T) == 4) return __uint_as_float(w[e]);
  return __uint_as_float(e & 1 ? w[e >> 1] & 0xffff0000u : w[e >> 1] << 16);
}

// q = clamp(rint(x / scale), -127, 127) as int8, scale = max(amax, 1e-12) /
// 127 from the device scalar; nunit units of 16 elements (0 where x or q is
// not 16-byte aligned), then the rest one at a time. A unit is 16 / (16 /
// sizeof(T)) 16-byte loads (bf16 2, f32 4) and one 16-byte store; block b
// takes the chunks of K8_THREADS UPI contiguous units b, b + grid, ..., a
// thread UPI units of a chunk, K8_LOADS words loaded before it quantises
// any; the units past the last whole chunk grid-stride.
template <typename T>
__global__ void __launch_bounds__(K8_THREADS) quantize_stream(const T* __restrict__ x, int64_t n,
                                                              int64_t nunit,
                                                              const float* __restrict__ amax,
                                                              int8_t* __restrict__ q) {
  constexpr int VPU = sizeof(T);         // 16-byte loads a unit
  constexpr int UPI = K8_LOADS / VPU;    // units a step
  const float scale = __fdiv_rn(fmaxf(*amax, 1e-12f), 127.0f);
  const float rcp = __frcp_rn(scale);
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  uint4* qv = reinterpret_cast<uint4*>(q);
  const int64_t stride = (int64_t)gridDim.x * K8_THREADS;
  int64_t u = (int64_t)blockIdx.x * K8_THREADS + threadIdx.x;
  auto store = [&](int64_t unit, const uint4 (&v)[VPU]) {
    uint32_t w[4 * VPU], out[4] = {0u, 0u, 0u, 0u}, exact = 0u;
#pragma unroll
    for (int j = 0; j < VPU; ++j) {
      w[4 * j] = v[j].x;
      w[4 * j + 1] = v[j].y;
      w[4 * j + 2] = v[j].z;
      w[4 * j + 3] = v[j].w;
    }
    // the quotients by the reciprocal, straight-line; then, rarely, the
    // division for those near a half-integer
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const float q = quotient(element<T>(w, e), rcp), r = rintf(q);
      exact |= static_cast<uint32_t>(near_half(q, r)) << e;
      out[e >> 2] |= to_q8(r) << (8 * (e & 3));
    }
    if (exact) {
#pragma unroll
      for (int e = 0; e < 16; ++e)
        if (exact >> e & 1u)
          out[e >> 2] = (out[e >> 2] & ~(0xffu << (8 * (e & 3)))) |
                        to_q8(rintf(__fdiv_rn(element<T>(w, e), scale))) << (8 * (e & 3));
    }
    qv[unit] = make_uint4(out[0], out[1], out[2], out[3]);
  };
  constexpr int CHUNK = K8_THREADS * UPI;
  for (int64_t c = (int64_t)blockIdx.x * CHUNK + threadIdx.x; c - threadIdx.x + CHUNK <= nunit;
       c += (int64_t)gridDim.x * CHUNK) {
    uint4 v[UPI][VPU];
#pragma unroll
    for (int k = 0; k < UPI; ++k)
#pragma unroll
      for (int j = 0; j < VPU; ++j) v[k][j] = __ldcs(xv + (c + k * K8_THREADS) * VPU + j);
#pragma unroll
    for (int k = 0; k < UPI; ++k) store(c + k * K8_THREADS, v[k]);
  }
  for (u = nunit / CHUNK * CHUNK + u; u < nunit; u += stride) {
    uint4 v[VPU];
#pragma unroll
    for (int j = 0; j < VPU; ++j) v[j] = __ldcs(xv + u * VPU + j);
    store(u, v);
  }
  for (int64_t e = nunit * 16 + (int64_t)blockIdx.x * K8_THREADS + threadIdx.x; e < n;
       e += stride)
    q[e] = static_cast<int8_t>(quantize1(to_f32(x[e]), scale, rcp));
}

// the persistent grid of a K8 stream: as many blocks as `sms` SMs hold, no
// more than the work's steps of K8_THREADS threads
inline int k8_grid(int64_t steps, int sms) {
  const int64_t most = (int64_t)sms * K8_BLOCKS_PER_SM < K8_MAX_GRID
                           ? (int64_t)sms * K8_BLOCKS_PER_SM : K8_MAX_GRID;
  const int64_t b = (steps + K8_THREADS - 1) / K8_THREADS;
  return static_cast<int>(b < 1 ? 1 : (b > most ? most : b));
}

inline bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// lets hop::conv_s8<BN> take SMEM_MAX bytes of dynamic shared memory and
// reads how many of its blocks an SM's registers hold, once per device;
// then sizes the ring so that that many blocks fit an SM's shared memory too
// and launches as many as the `sms` SMs hold, persistent, a multiple of the
// column tiles (K1's rule, inception_block.cu::launch_bn)
template <int BN>
cudaError_t launch_bn(const CUtensorMap& ta, const CUtensorMap& tb, const CUtensorMap& tw,
                      const ConvArgs& g,
                      hop::Plan p, int sms, cudaStream_t s) {
  static std::atomic<int> per_sm[hopper::MAX_DEVICES];
  const int slot = hopper::device_slot();
  int ctas = slot >= 0 ? per_sm[slot].load(std::memory_order_acquire) : 0;
  if (ctas <= 0) {
    cudaError_t e = cudaFuncSetAttribute(hop::conv_s8<BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         hop::SMEM_MAX);
    if (e != cudaSuccess) return e;
    cudaFuncAttributes fa;
    e = cudaFuncGetAttributes(&fa, hop::conv_s8<BN>);
    if (e != cudaSuccess) return e;
    const int regs = (fa.numRegs + 7) & ~7;  // allocated in units of 8 a thread
    ctas = 65536 / (regs * hop::THREADS);
    if (ctas < 1) ctas = 1;
    if (ctas > 3) ctas = 3;
    if (slot >= 0) per_sm[slot].store(ctas, std::memory_order_release);
  }
  // an SM's 233472 bytes of shared memory, 1 KB of them reserved a block:
  // the most blocks an SM's registers hold whose ring still has 2 stages
  const int ksh = p.part[0].ksh > p.part[1].ksh ? p.part[0].ksh : p.part[1].ksh;
  p.stage_bytes = (p.b_at + ksh * BN * hop::KS + 1023) & ~1023;
  const int fixed = hop::fixed_smem(BN), sb = p.stage_bytes;
  for (; ctas > 1; --ctas)
    if ((233472 / ctas - 1024 - fixed) / sb >= 2) break;
  p.stages = ((ctas > 1 ? 233472 / ctas - 1024 : hop::SMEM_MAX) - fixed) / sb;
  if (p.stages > hop::MAX_STAGES) p.stages = hop::MAX_STAGES;
  if (p.stages < 2) return cudaErrorInvalidValue;
  const int smem = fixed + p.stages * sb;
  int grid = sms * ctas;
  if (grid < p.n_tiles) return cudaErrorInvalidValue;
  grid -= grid % p.n_tiles;  // a block keeps one column tile
  if (grid > p.units) grid = p.units;
  hop::conv_s8<BN><<<grid, hop::THREADS, smem, s>>>(ta, tb, tw, g, p);
  return cudaGetLastError();
}

inline CUtensorMapSwizzle swizzle_of(int kc) {
  return kc == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                   : kc == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;
}

}  // namespace i8

// K7: one int8 conv, NHWC x [F, H, W, C] int8, weights [N, KH, KW, C] int8,
// out [F, Ho, Wo, N] f32 (out_dtype 0) or bf16 (1). pt / pl: the padding
// above and to the left (the bottom and right follow from Ho and Wo). The
// plan (ops/int8_conv.py::plan): kc 32, 64 or 128 takes route 1 (Hopper),
// in column tiles of bn and, unless the conv is 1x1 at stride 1 (rows flat,
// 128 a tile), row tiles of [bf, bh, bw] output pixels, A by the wide-row
// map where `mode` is 1, or 2 with the halo (see below); kc 0 route 2 (RGB,
// segments of bw output pixels, bf = bh = 1, bn 32, 48 or 64) where the conv
// fits it, else route 3 (bytes); on `sms` SMs. `out_amax` (or null): one f32
// on the device, zeroed in the stream, then max |out| over the values as
// stored, reduced in the epilogue. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int k7_int8_conv(const void* x, const void* w, const float* amax, const float* ws,
                            const float* shift, void* out, int out_dtype, int F, int H, int W,
                            int C, int N, int KH, int KW, int stride, int pt, int pl, int Ho,
                            int Wo, int relu, int kc, int mode, int bn, int bf, int bh, int bw,
                            int bfb, int bhb, int sms, float* out_amax, void* stream) {
  const int64_t M = (int64_t)F * Ho * Wo;
  const int64_t K = (int64_t)KH * KW * C;
  if (!x || !w || !amax || !ws || !shift || !out || (out_dtype != 0 && out_dtype != 1) ||
      F < 1 || H < 1 || W < 1 || C < 1 || N < 1 || KH < 1 || KW < 1 || stride < 1 || pt < 0 ||
      pl < 0 || Ho < 1 || Wo < 1 || M > 0x7fffffff || K > (1 << 20) ||
      (int64_t)F * H * W * C > ((int64_t)1 << 40) ||
      (M + i8::bytes::BM - 1) / i8::bytes::BM > 0x7fffffff ||
      (N + i8::bytes::BN - 1) / i8::bytes::BN > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  i8::ConvArgs g{static_cast<const int8_t*>(x), static_cast<const int8_t*>(w), amax, ws, shift,
                 out, out_amax, F, H, W, C, N, KH, KW, stride, pt, pl, Ho, Wo, (int)K, (int)M,
                 relu, out_dtype};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_amax) {
    const cudaError_t e = cudaMemsetAsync(out_amax, 0, sizeof(float), s);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (kc == 0 && K <= i8::hop::RGB_K && C <= 4 && KH <= 7 && bf == 1 && bh == 1 && bw >= 1 &&
      bw <= i8::hop::BM && ((bw - 1) * stride + KW) * C <= i8::hop::RGB_ROW_BYTES && sms >= 1 &&
      (bn == 32 || bn == 48 || bn == 64)) {
    const int tw = (Wo + bw - 1) / bw, n_tiles = (N + bn - 1) / bn;
    const int64_t units = (int64_t)F * Ho * tw * n_tiles;
    if (units > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
    int grid = sms * 8;  // as many as an SM holds (~33 KB of shared memory a block)
    grid -= grid % n_tiles;
    if (grid < n_tiles) grid = n_tiles;
    if (grid > units) grid = (int)units;
    const int threads = i8::hop::RGB_THREADS;
    if (bn == 32)
      i8::hop::conv_rgb<32><<<grid, threads, 0, s>>>(g, bw, tw, n_tiles, (int)units);
    else if (bn == 48)
      i8::hop::conv_rgb<48><<<grid, threads, 0, s>>>(g, bw, tw, n_tiles, (int)units);
    else
      i8::hop::conv_rgb<64><<<grid, threads, 0, s>>>(g, bw, tw, n_tiles, (int)units);
    return static_cast<int>(cudaGetLastError());
  }
  if (kc == 0) {
    dim3 grid((unsigned)((M + i8::bytes::BM - 1) / i8::bytes::BM),
              (unsigned)((N + i8::bytes::BN - 1) / i8::bytes::BN));
    i8::bytes::conv_kernel<<<grid, i8::bytes::THREADS, 0, s>>>(g);
    return static_cast<int>(cudaGetLastError());
  }
  // the parts of the output columns: all of them; or, with mode 1 (2: and
  // the halo), on the wide-row map (a tap conv at stride 1, or unpadded
  // along W: an output pixel's KW taps of one kernel row are KW Cin
  // contiguous bytes of an input row, one box row of a map whose W step,
  // stride Cin bytes, makes the rows overlap), the columns whose receptive
  // field lies inside the frame, and the pl + pr border columns of a
  // stride-1 conv a box a tap (their boxes: [bfb, bhb] frames and rows of
  // one column). The halo: a unit's A is one box of bh + KH - 1 rows of bw
  // (a multiple of 8) output columns, bf = 1, and tap ky its rows from ky bw
  // on, so the KH taps along H share one load.
  const bool flat = KH == 1 && KW == 1 && stride == 1 && pt == 0 && pl == 0 && Ho == H && Wo == W;
  const int pr = stride == 1 ? Wo - 1 + KW - W - pl : 0;  // stride 1: the right padding read
  const bool valid_w = pl == 0 && (int64_t)(Wo - 1) * stride + KW <= W;
  const int inner = Wo - pl - (pr > 0 ? pr : 0);
  const bool wide = mode >= 1, halo = mode == 2;
  if (mode < 0 || mode > 2 ||
      (wide && (flat || KW == 1 || !(valid_w || (stride == 1 && inner >= 1)))) ||
      (halo && (stride != 1 || KH < 2 || bf != 1 || bw % 8 || bh + KH - 1 > 256)))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool border = wide && !valid_w;
  if (flat) {
    bf = bh = 1;
    bw = i8::hop::BM;
  }
  if ((kc != 32 && kc != 64 && kc != 128) || (wide && kc != 128) || C % 16 ||
      !i8::aligned(x, 16) || !i8::aligned(w, 16) || sms < 1 || bf < 1 || bh < 1 || bw < 1 ||
      bf * bh * bw > i8::hop::BM || bf > 256 || bh * stride > 256 || bw * stride > 256 ||
      (border && (bfb < 1 || bhb < 1 || bfb * bhb > i8::hop::BM || bfb > 256 || bhb > 256)))
    return static_cast<int>(cudaErrorInvalidValue);
  i8::hop::Plan p{};
  p.flat = flat;
  p.kc = kc;
  p.group = i8::hop::KS / kc;
  for (int k = 0; k < (border ? 2 : 1); ++k) {
    i8::hop::Part& q = p.part[k];
    const bool wide_k = wide && k == 0;  // the part on the wide-row map
    const int cols = wide_k ? (border ? inner : Wo) : border ? pl + pr : Wo;
    q.bf = k ? bfb : bf;
    q.bh = k ? bhb : bh;
    q.bw = k ? 1 : bw;
    q.tf = flat ? 1 : (F + q.bf - 1) / q.bf;
    q.th = flat ? 1 : (Ho + q.bh - 1) / q.bh;
    q.tw = flat ? (int)((M + i8::hop::BM - 1) / i8::hop::BM) : (cols + q.bw - 1) / q.bw;
    q.x0 = border && k == 0 ? pl : 0;
    q.gap_at = k ? pl : 0x7fffffff;
    q.gap = k ? Wo - pl - pr : 0;
    q.x_end = border && k == 0 ? pl + inner : Wo;
    q.ksh = halo && k == 0 ? KH : 1;
    q.a_rows = q.ksh > 1 ? (bh + KH - 1) * bw : q.bf * q.bh * q.bw;
    q.tkw = wide_k ? 1 : KW;
    q.tc = wide_k ? KW * C : C;
    q.xs = wide_k ? 1 : stride;
    q.xo = -pl;
    q.kchunks = (q.tc + kc - 1) / kc;
    q.chunks = KH / q.ksh * q.tkw * q.kchunks;
    q.steps = (q.chunks + p.group - 1) / p.group;
    const int64_t rts = (int64_t)q.tf * q.th * q.tw;
    if (rts > 0x3fffffff) return static_cast<int>(cudaErrorInvalidValue);
    q.rts = (int)rts;
  }
  p.b_at = (i8::hop::BM + (halo ? (KH - 1) * bw : 0)) * i8::hop::KS;
  p.n_tiles = (N + bn - 1) / bn;
  const int64_t units = ((int64_t)p.part[0].rts + p.part[1].rts) * p.n_tiles;
  if (units > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  p.units = (int)units;

  // A: flat rows [M, C]; or the wide-row map (KW C, W - KW + 1, H, F), the W
  // step stride C bytes, the traversal stride in H; or (C, W, H, F) with the
  // traversal stride in W and H (every column, or the border columns' boxes
  // of one column). W: [N, K]. Past the extents (Cin, KW Cin, K) and outside
  // the frame TMA writes zeros.
  CUtensorMap ta, tb{}, tw;
  const CUtensorMapSwizzle sw = i8::swizzle_of(kc);
  auto map4 = [&](CUtensorMap* m, bool wide_map, int bfx, int bhx, int bwx) {
    const cuuint64_t adim[4] = {(cuuint64_t)(wide_map ? KW * C : C),
                                (cuuint64_t)(wide_map ? (W - KW) / stride + 1 : W),
                                (cuuint64_t)H, (cuuint64_t)F};
    const cuuint64_t astride[3] = {(cuuint64_t)(wide_map ? stride * C : C), (cuuint64_t)C * W,
                                   (cuuint64_t)C * W * H};
    const cuuint32_t abox[4] = {(cuuint32_t)kc, (cuuint32_t)(wide_map ? bwx : bwx * stride),
                                (cuuint32_t)(bhx * stride), (cuuint32_t)bfx};
    const cuuint32_t elem[4] = {1, (cuuint32_t)(wide_map ? 1 : stride), (cuuint32_t)stride, 1};
    return hopper::encode(m, CU_TENSOR_MAP_DATA_TYPE_UINT8, x, 4, adim, astride, abox, sw, elem);
  };
  bool ok;
  if (flat) {
    const cuuint64_t adim[2] = {(cuuint64_t)C, (cuuint64_t)M};
    const cuuint64_t astride[1] = {(cuuint64_t)C};
    const cuuint32_t abox[2] = {(cuuint32_t)kc, (cuuint32_t)i8::hop::BM};
    ok = hopper::encode(&ta, CU_TENSOR_MAP_DATA_TYPE_UINT8, x, 2, adim, astride, abox, sw);
  } else {
    ok = map4(&ta, wide, bf, halo ? bh + KH - 1 : bh, bw) &&
         (!border || map4(&tb, false, bfb, bhb, 1));
  }
  const cuuint64_t wdim[2] = {(cuuint64_t)K, (cuuint64_t)N};
  const cuuint64_t wstride[1] = {(cuuint64_t)K};
  const cuuint32_t wbox[2] = {(cuuint32_t)kc, (cuuint32_t)bn};
  if (!ok || !hopper::encode(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, 2, wdim, wstride, wbox, sw))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
  switch (bn) {
    case 32: e = i8::launch_bn<32>(ta, tb, tw, g, p, sms, s); break;
    case 48: e = i8::launch_bn<48>(ta, tb, tw, g, p, sms, s); break;
    case 64: e = i8::launch_bn<64>(ta, tb, tw, g, p, sms, s); break;
    case 80: e = i8::launch_bn<80>(ta, tb, tw, g, p, sms, s); break;
    case 96: e = i8::launch_bn<96>(ta, tb, tw, g, p, sms, s); break;
    case 128: e = i8::launch_bn<128>(ta, tb, tw, g, p, sms, s); break;
    case 144: e = i8::launch_bn<144>(ta, tb, tw, g, p, sms, s); break;
    case 160: e = i8::launch_bn<160>(ta, tb, tw, g, p, sms, s); break;
    case 192: e = i8::launch_bn<192>(ta, tb, tw, g, p, sms, s); break;
    case 208: e = i8::launch_bn<208>(ta, tb, tw, g, p, sms, s); break;
    case 224: e = i8::launch_bn<224>(ta, tb, tw, g, p, sms, s); break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

// K8, launch 1: amax[0] = max |x| over n elements (dtype 0 f32, 1 bf16) on a
// persistent grid for `sms` SMs, one launch (it needs no zeroed scalar).
extern "C" int k8_amax(int dtype, const void* x, int64_t n, float* amax, int sms, void* stream) {
  if (!x || !amax || n < 1 || (dtype != 0 && dtype != 1) || sms < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int per_word = dtype == 0 ? 4 : 8;
  const int64_t nvec = i8::aligned(x, 16) ? n / per_word : 0;
  const int grid = i8::k8_grid(nvec > 0 ? (nvec + i8::K8_LOADS - 1) / i8::K8_LOADS : n, sms);
  if (dtype == 0)
    i8::amax_stream<float><<<grid, i8::K8_THREADS, 0, s>>>(static_cast<const float*>(x), n, nvec,
                                                           amax);
  else
    i8::amax_stream<__nv_bfloat16><<<grid, i8::K8_THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), n, nvec, amax);
  return static_cast<int>(cudaGetLastError());
}

// K8, launch 2: q = clamp(rintf(x / scale), -127, 127) as int8, scale =
// max(amax, 1e-12) / 127 from the device scalar, on a persistent grid for
// `sms` SMs.
extern "C" int k8_quantize(int dtype, const void* x, int64_t n, const float* amax, void* q,
                           int sms, void* stream) {
  if (!x || !amax || !q || n < 1 || (dtype != 0 && dtype != 1) || sms < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t nunit = i8::aligned(x, 16) && i8::aligned(q, 16) ? n / 16 : 0;
  const int upi = i8::K8_LOADS / (dtype == 0 ? 4 : 2);  // units a step
  const int grid = i8::k8_grid(nunit > 0 ? (nunit + upi - 1) / upi : n, sms);
  if (dtype == 0)
    i8::quantize_stream<float><<<grid, i8::K8_THREADS, 0, s>>>(
        static_cast<const float*>(x), n, nunit, amax, static_cast<int8_t*>(q));
  else
    i8::quantize_stream<__nv_bfloat16><<<grid, i8::K8_THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), n, nunit, amax, static_cast<int8_t*>(q));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* k7_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

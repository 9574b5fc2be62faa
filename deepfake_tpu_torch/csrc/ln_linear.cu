// K4: the linear layers of a Video Swin block with what surrounds them fused
// in. One layer (k4_ln_linear):
//
//   s   = a (+ a2)                                   (rounded to T)
//   s   = LayerNorm(s) over the k columns            (optional; rounded to T)
//   y   = T(s . W^T + bias)                          (f32 accumulation)
//   y   = T(GELU(y))                                 (optional)
//   out = T((r (+ r2)) + y)                          (optional residual)
//
// with W the [n, k] nn.Linear weight; and the MLP half of the block in one
// launch (k4_mlp_tail): out = s + fc2(GELU(fc1(LayerNorm(s)))), s = a + a2,
// at the same cast points. A Swin3D block runs three launches at widths up
// to 384 (LN1 -> qkv, proj, the MLP tail) and four at 768 (the MLP tail as
// fc1 and fc2 launches of k4_ln_linear: see below).
//
// Replaces, with K3 (window_attn3d.cu) for the attention between qkv and
// proj, the Pallas kernels
//   deepfake_tpu/ops/pallas_window_attn.py:548 pallas_window_attention_nhc_qkv
//     (_nhc_qkv_kernel :364: LayerNorm, x @ W_qkv + b, attention, @ W_proj + b)
//   deepfake_tpu/ops/pallas_mlp.py:101 fused_mlp_tail
//     (_kernel :29: a + b, LayerNorm, fc1, GELU, fc2, + residual)
// and keeps their cast points: LayerNorm statistics in f32 with the fast
// variance max(E[x^2] - E[x]^2, 0) and the (x - mu) * (rsqrt(var + eps) *
// scale) + bias order, each dense step's f32 sum plus bias rounded once to T,
// GELU on the rounded value (tanh form in bf16, erf in f32, as the JAX
// package's gelu_exact; the bf16 route takes tanh from the SFU, ~2^-11
// relative, inside the bf16 rounding that follows), the residual s + y in T.
// bias and the LayerNorm weights are read in T and widened to f32.
//
// What bounds it on the H100 (3.35 TB/s, 989 TFLOP/s bf16): memory at stage
// 0, operations from stage 1 on. The layers are thin (k, n = 96 .. 3072
// against 401,408 rows at video_swin b8 stage 0), so every pass over device
// memory that can be fused is: the a + a2 sum and the LayerNorm are formed in
// shared memory, bias, GELU and the residual are applied to the
// accumulators before the one store, and the MLP's [rows, 4C] hidden tensor
// stays in shared memory at C <= 384 (a video_swin b8 request then moves
// ~4.6 GB less). What the bound does not count is W: a 64-row tile reads the
// whole W of its layer, from L2 unless it fits in shared memory. On the card
// neither that traffic nor occupancy set the time; the steps each tile runs
// in turn did (prologue, MMA, epilogue: see PERF.md), so those keep their
// global loads ahead of their stores and their k steps unconditional.
//
// Routes:
//   - bf16 (serving), Hopper: persistent blocks of two consumer warpgroups
//     and one producer warp. The producer's lane 0 streams W (and A, where
//     there is no panel) by TMA (cp.async.bulk.tensor, 128-byte swizzle)
//     through a ring of stages with full/empty mbarriers; its lane 1 loads
//     each 64-row tile's A panel [64, k] by TMA. The consumers run
//     wgmma.mma_async m64nNk16 (bf16 in, f32 accumulate) from shared memory.
//     Where the layer's W fits the ring it is loaded once per block and kept
//     (stage 0: W_qkv, W_proj, and W_fc1 with W_fc2). The prologue (a + a2,
//     LayerNorm) runs once per tile on the panel, in place, in the swizzled
//     layout wgmma reads. The epilogue applies bias, GELU and the residual
//     to the accumulators, stages the tile in shared memory and writes it,
//     and reads the residual, in 16-byte rows.
//       linear_bf16: each 64-row tile's columns in tiles of 2 W (W = 96 where
//       n is a multiple of 192, else 48), each warpgroup W of them; with
//       k > 1024 (fc2 at C = 768; every layer of Video Swin-L's stage 3 at
//       C = 1536) A and W share the ring stages, and a sum or a LayerNorm
//       is applied to each A atom as it lands, in place, with the rows'
//       statistics from a short pre-pass (one warp a row) before the launch.
//       mlp_tail_bf16: fc1 makes the hidden tensor 64 columns at a time (each
//       warpgroup 32), + b1, round, GELU, round, into shared memory; fc2
//       takes each chunk at once into the [64, C] f32 accumulator (each
//       warpgroup C / 2 columns) and runs on while the next chunk's fc1 is
//       issued. At C = 768 that accumulator would need 384 registers a
//       thread (192 with the columns split), more than a thread has beside
//       everything else, so stage 3 keeps two launches, the hidden tensor
//       through device memory.
//   - f32 (parity): SIMT f32 FMA, 8 x 4 outputs a thread; the MLP tail as
//     two launches.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

#include <algorithm>
#include <initializer_list>
#include <type_traits>

namespace {

struct Args {
  const void* a; const void* a2; int64_t lda;  // A [m, k] (row stride lda); a2 alike, or null
  const void* ln_w; const void* ln_b; float eps;  // LayerNorm over k, or ln_w null
  const void* w;                                 // [n, k] row-major
  const void* bias;                              // [n], or null
  int m, k, n;
  int gelu;
  const void* r; const void* r2; int64_t ldr;    // residual [m, n] (row stride ldr), r2 alike; or null
  void* out; int64_t ldo;                        // [m, n] (row stride ldo)
  float2* stats;  // [m] (mean, 1 / sqrt(var + eps)): bf16 LayerNorm above the panel, else null
};

// the value v takes once stored in bf16
__device__ __forceinline__ float rnd_bf16(float v) { return __bfloat162float(__float2bfloat16(v)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// mean and 1 / sqrt(var + eps) from the sums of x and x^2 over k values
__device__ __forceinline__ void ln_stats(const Args& g, float s1, float s2, float* mu,
                                         float* rs) {
  const float m = s1 / g.k;
  *mu = m;
  *rs = 1.f / sqrtf(fmaxf(s2 / g.k - m * m, 0.f) + g.eps);
}

// ------------------------------------------------------------- f32: SIMT

namespace simt {

constexpr int BM = 128, BN = 64, BK = 16, TM = 8, TN = 4;
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256

// LayerNorm statistics of the block's rows of a (+ a2), one warp per row
__device__ void row_stats(const Args& g, int row0, float* mu_s, float* rs_s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = warp; i < BM; i += THREADS / 32) {
    const int r = row0 + i;
    float s1 = 0.f, s2 = 0.f;
    if (r < g.m) {
      const float* a = static_cast<const float*>(g.a) + (int64_t)r * g.lda;
      const float* a2 = g.a2 ? static_cast<const float*>(g.a2) + (int64_t)r * g.lda : nullptr;
      for (int c = lane; c < g.k; c += 32) {
        const float x = a2 ? a[c] + a2[c] : a[c];
        s1 += x;
        s2 += x * x;
      }
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (lane == 0) ln_stats(g, s1, s2, mu_s + i, rs_s + i);
  }
}

// one element of A as the product reads it: x (+ x2), then the LayerNorm
// with the row's statistics and the column's scale lw and shift lb
__device__ __forceinline__ float a_value(const Args& g, float x, float x2, float lw, float lb,
                                         float mu, float rs) {
  if (g.a2) x += x2;
  if (g.ln_w) x = __fadd_rn(__fmul_rn(x - mu, rs * lw), lb);
  return x;
}

// the epilogue of output (rr, nn) from its sum
__device__ __forceinline__ float finish(const Args& g, int rr, int nn, float acc) {
  float y = acc;
  if (g.bias) y += static_cast<const float*>(g.bias)[nn];
  if (g.gelu) y = y * 0.5f * (1.f + erff(y * 0.70710678118654752f));
  if (g.r) {
    const int64_t o = (int64_t)rr * g.ldr + nn;
    const float s = static_cast<const float*>(g.r)[o];
    y = (g.r2 ? s + static_cast<const float*>(g.r2)[o] : s) + y;
  }
  return y;
}

__global__ void __launch_bounds__(THREADS) ln_linear_f32(Args g) {
  __shared__ float As[BK][BM + 4];  // k-major: a thread's TM rows are adjacent
  __shared__ __align__(16) float Bs[BK][BN + 4];
  __shared__ float mu_s[BM], rs_s[BM];

  const float* A = static_cast<const float*>(g.a);
  const float* A2 = static_cast<const float*>(g.a2);
  const float* W = static_cast<const float*>(g.w);
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  if (g.ln_w) row_stats(g, row0, mu_s, rs_s);
  __syncthreads();

  // A loader: one row and 8 consecutive k per thread
  const int lr = tid >> 1, lk = (tid & 1) * 8;
  const int r = row0 + lr;
  const bool row_ok = r < g.m;
  const float mu = g.ln_w ? mu_s[lr] : 0.f, rs = g.ln_w ? rs_s[lr] : 0.f;
  // W loader: one output column and 4 consecutive k per thread
  const int bn = tid >> 2, bk = (tid & 3) * 4;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < g.k; k0 += BK) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int kk = k0 + lk + i;
      float x = 0.f;
      if (row_ok && kk < g.k) {
        const int64_t o = (int64_t)r * g.lda + kk;
        const float* lw = static_cast<const float*>(g.ln_w);
        const float* lb = static_cast<const float*>(g.ln_b);
        x = a_value(g, A[o], A2 ? A2[o] : 0.f, lw ? lw[kk] : 0.f, lb ? lb[kk] : 0.f, mu, rs);
      }
      As[lk + i][lr] = x;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kk = k0 + bk + j, nn = col0 + bn;
      Bs[bk + j][bn] = (kk < g.k && nn < g.n) ? W[(int64_t)nn * g.k + kk] : 0.f;
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

  float* O = static_cast<float*>(g.out);
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int rr = row0 + ty * TM + i, nn = col0 + tx * TN + j;
      if (rr < g.m && nn < g.n) O[(int64_t)rr * g.ldo + nn] = finish(g, rr, nn, acc[i][j]);
    }
}

}  // namespace simt

// ------------------------------------------------------ bf16: Hopper

namespace hop {

typedef __nv_bfloat16 bf16;

// A tile is BM = 64 rows (one wgmma M). Operands sit in shared memory in the
// 128-byte-swizzled K-major layout that TMA writes and wgmma reads: an atom
// is [rows][64 k] of bf16, 128 bytes a row, 1024 bytes per 8 rows.
constexpr int BM = 64, KC = 64, ATOM = BM * KC * 2;  // ATOM: [64 rows][64 k], 8 KB
constexpr int CONSUMERS = 2;                          // consumer warpgroups
constexpr int THREADS = 128 * CONSUMERS + 32;         // + one producer warp
constexpr int PRODUCER_WARP = 4 * CONSUMERS;
constexpr int SMEM_MAX = 232448;  // dynamic shared memory a block may use
constexpr int MAX_PANEL_K = 1024;
constexpr int MAX_STAGES = 8;

// ---- shared memory, barriers, TMA, wgmma, the 128-byte-swizzle descriptor:
// hopper.cuh

using namespace hopper;

// byte offset of the 16-byte chunk (row r, k chunk g of 8) in a swizzled atom
__device__ __forceinline__ int swz(int r, int g) { return r * 128 + ((g ^ (r & 7)) << 4); }

// wgmma.mma_async m64nNk16, bf16 x bf16 -> f32, A and B from shared memory
// (K-major both); acc == 0 overwrites d
template <int N>
struct Wgmma;
template <>
struct Wgmma<32> {
  __device__ static __forceinline__ void mma(float (&d)[16], uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(acc));
  }
};

template <>
struct Wgmma<48> {
  __device__ static __forceinline__ void mma(float (&d)[24], uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23"
        "}, %24, %25, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "l"(da), "l"(db), "r"(acc));
  }
};

template <>
struct Wgmma<96> {
  __device__ static __forceinline__ void mma(float (&d)[48], uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
        "}, %48, %49, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "l"(da), "l"(db), "r"(acc));
  }
};

template <>
struct Wgmma<192> {
  __device__ static __forceinline__ void mma(float (&d)[96], uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
        "}, %96, %97, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
        : "l"(da), "l"(db), "r"(acc));
  }
};


__device__ __forceinline__ void unpack8(const uint4& v, float (&x)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    x[2 * j] = __low2float(h[j]);
    x[2 * j + 1] = __high2float(h[j]);
  }
}
__device__ __forceinline__ uint4 pack8(const float (&x)[8]) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(x[2 * j], x[2 * j + 1]);
  return v;
}
__device__ __forceinline__ uint32_t pack2(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}
// GELU's tanh form, tanh by the SFU (tanh.approx.f32, ~2^-11 relative): the
// result is rounded to bf16 (2^-8) right after
__device__ __forceinline__ float gelu_tanh(float x) {
  const float inner = 0.79788456080286536f * (x + 0.044715f * x * x * x);
  float t;
  asm("tanh.approx.f32 %0, %1;" : "=f"(t) : "f"(inner));
  return 0.5f * x * (1.f + t);
}

// The prologue on a [64, K] panel that TMA has filled (k chunks of ATOM;
// columns past K and rows past m are zero): s = a (+ a2) rounded to bf16,
// then, with ln_w, the LayerNorm with the row statistics of s in f32; the
// result overwrites the panel in the layout wgmma reads. A lane takes 8
// columns at a time, U times (K <= 256 U), and holds their LayerNorm
// weights for all its rows; warp cw of nwarps takes rows cw, cw + nwarps,
// ..., RB at a time with all their loads issued first, so that the rows'
// latencies overlap.
template <int U>
__device__ void prologue(const Args& g, uint8_t* panel, int row0, int cw, int nwarps, int lane) {
  constexpr int RB = U == 1 ? 8 : U == 2 ? 2 : 1;  // rows at once
  const bf16* A2 = static_cast<const bf16*>(g.a2);
  const int units = g.k / 8;
  uint4 lwv[U], lbv[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int unit = lane + 32 * u;
    if (g.ln_w && unit < units) {
      lwv[u] = *reinterpret_cast<const uint4*>(static_cast<const bf16*>(g.ln_w) + unit * 8);
      lbv[u] = *reinterpret_cast<const uint4*>(static_cast<const bf16*>(g.ln_b) + unit * 8);
    }
  }
  for (int i0 = cw; i0 < BM; i0 += RB * nwarps) {
    uint4 v[RB][U], v2[RB][U];
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const int i = i0 + r * nwarps, row = row0 + i;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int unit = lane + 32 * u;
        if (unit < units) {
          v[r][u] = *reinterpret_cast<const uint4*>(panel + (unit >> 3) * ATOM + swz(i, unit & 7));
          if (A2 && row < g.m)
            v2[r][u] = *reinterpret_cast<const uint4*>(A2 + (int64_t)row * g.lda + unit * 8);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const int i = i0 + r * nwarps, row = row0 + i;
      float x[U][8];
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (lane + 32 * u >= units) break;
        unpack8(v[r][u], x[u]);
        if (A2 && row < g.m) {
          float x2[8];
          unpack8(v2[r][u], x2);
#pragma unroll
          for (int e = 0; e < 8; ++e) x[u][e] = rnd_bf16(x[u][e] + x2[e]);
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          s1 += x[u][e];
          s2 += x[u][e] * x[u][e];
        }
      }
      float mu = 0.f, rs = 0.f;
      if (g.ln_w) ln_stats(g, warp_sum(s1), warp_sum(s2), &mu, &rs);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int unit = lane + 32 * u;
        if (unit >= units) break;
        if (g.ln_w) {
          float lw[8], lb[8];
          unpack8(lwv[u], lw);
          unpack8(lbv[u], lb);
#pragma unroll
          for (int e = 0; e < 8; ++e)
            x[u][e] = __fadd_rn(__fmul_rn(x[u][e] - mu, rs * lw[e]), lb[e]);
        }
        *reinterpret_cast<uint4*>(panel + (unit >> 3) * ATOM + swz(i, unit & 7)) = pack8(x[u]);
      }
    }
  }
  fence_async_smem();  // the panel is read by wgmma next
}

// The epilogue of one consumer warpgroup's [64, W] f32 tile (wgmma's
// accumulator layout: element 4 j + 2 h + e is row 16 warp + lane / 4 + 8 h,
// column 8 j + 2 (lane % 4) + e) at (row0, col0): + bias (from its copy in
// shared memory, bias_s), round; GELU, round; staged in shared memory st
// [64][W + 8], then written in 16-byte rows with the residual pair added:
// out = T(T(r + r2) + y).
template <int W>
__device__ void epilogue(const Args& g, float (&acc)[W / 2], const bf16* bias_s, bf16* st,
                         int row0, int col0, int t128, int wg) {
  constexpr int SP = W + 8, CH = W / 8;
  const int lane = t128 & 31, ra = (t128 >> 5) * 16 + (lane >> 2);
  named_sync(2 + wg, 128);  // the previous tile's stores are done with st
#pragma unroll
  for (int j = 0; j < W / 8; ++j) {
    const int c = 8 * j + 2 * (lane & 3), n = col0 + c;
    const float2 b = g.bias && n < g.n
                         ? __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bias_s + n))
                         : make_float2(0.f, 0.f);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float y0 = rnd_bf16(acc[4 * j + 2 * h] + b.x), y1 = rnd_bf16(acc[4 * j + 2 * h + 1] + b.y);
      if (g.gelu) {
        y0 = gelu_tanh(y0);
        y1 = gelu_tanh(y1);
      }
      *reinterpret_cast<uint32_t*>(st + (ra + 8 * h) * SP + c) = pack2(y0, y1);
    }
  }
  named_sync(2 + wg, 128);
  const bf16* R = static_cast<const bf16*>(g.r);
  const bf16* R2 = static_cast<const bf16*>(g.r2);
  bf16* O = static_cast<bf16*>(g.out);
  for (int idx = t128; idx < BM * CH; idx += 128) {
    const int r = idx / CH, cc = idx - r * CH, row = row0 + r, col = col0 + cc * 8;
    if (row >= g.m || col >= g.n) continue;
    uint4 v = *reinterpret_cast<const uint4*>(st + r * SP + cc * 8);
    if (R) {
      float y[8], s[8];
      unpack8(v, y);
      unpack8(*reinterpret_cast<const uint4*>(R + (int64_t)row * g.ldr + col), s);
      if (R2) {
        float s2[8];
        unpack8(*reinterpret_cast<const uint4*>(R2 + (int64_t)row * g.ldr + col), s2);
#pragma unroll
        for (int e = 0; e < 8; ++e) s[e] = rnd_bf16(s[e] + s2[e]);
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) y[e] = s[e] + y[e];
      v = pack8(y);
    }
    *reinterpret_cast<uint4*>(O + (int64_t)row * g.ldo + col) = v;
  }
}

// The LayerNorm statistics of every row of s = a (+ a2) (rounded to bf16),
// one warp a row, for a layer whose rows are too wide for a panel: the
// kernel then normalises each A atom as it lands
__global__ void __launch_bounds__(256) row_stats_bf16(Args g) {
  const int row = (int)((blockIdx.x * 256 + threadIdx.x) >> 5), lane = threadIdx.x & 31;
  if (row >= g.m) return;
  const bf16* A = static_cast<const bf16*>(g.a) + (int64_t)row * g.lda;
  const bf16* A2 = g.a2 ? static_cast<const bf16*>(g.a2) + (int64_t)row * g.lda : nullptr;
  float s1 = 0.f, s2 = 0.f;
  for (int c = 8 * lane; c < g.k; c += 256) {
    float x[8];
    unpack8(*reinterpret_cast<const uint4*>(A + c), x);
    if (A2) {
      float x2[8];
      unpack8(*reinterpret_cast<const uint4*>(A2 + c), x2);
#pragma unroll
      for (int e = 0; e < 8; ++e) x[e] = rnd_bf16(x[e] + x2[e]);
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      s1 += x[e];
      s2 += x[e] * x[e];
    }
  }
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  if (lane == 0) {
    float mu, rs;
    ln_stats(g, s1, s2, &mu, &rs);
    g.stats[row] = make_float2(mu, rs);
  }
}

// The prologue on one landed A atom [64 rows, 64 k] (k chunk c) of a layer
// without a panel: s = a (+ a2) rounded to bf16, then, with ln_w, the
// LayerNorm with the row statistics of the pre-pass, in place; the 256
// consumer threads take a 16-byte chunk each at a time. Columns past k and
// rows past m stay as TMA wrote them (zeros).
__device__ void atom_prologue(const Args& g, uint8_t* atom, int row0, int c) {
  const bf16* A2 = static_cast<const bf16*>(g.a2);
  for (int i = threadIdx.x; i < BM * 8; i += 128 * CONSUMERS) {
    const int r = i >> 3, u = i & 7, row = row0 + r, col = c * KC + 8 * u;
    if (row >= g.m || col >= g.k) continue;
    uint4* cell = reinterpret_cast<uint4*>(atom + swz(r, u));
    float x[8];
    unpack8(*cell, x);
    if (A2) {
      float x2[8];
      unpack8(*reinterpret_cast<const uint4*>(A2 + (int64_t)row * g.lda + col), x2);
#pragma unroll
      for (int e = 0; e < 8; ++e) x[e] = rnd_bf16(x[e] + x2[e]);
    }
    if (g.ln_w) {
      const float2 st = g.stats[row];
      float lw[8], lb[8];
      unpack8(*reinterpret_cast<const uint4*>(static_cast<const bf16*>(g.ln_w) + col), lw);
      unpack8(*reinterpret_cast<const uint4*>(static_cast<const bf16*>(g.ln_b) + col), lb);
#pragma unroll
      for (int e = 0; e < 8; ++e) x[e] = __fadd_rn(__fmul_rn(x[e] - st.x, st.y * lw[e]), lb[e]);
    }
    *cell = pack8(x);
  }
  fence_async_smem();  // the atom is read by wgmma next
}

// ---- one linear layer: ln_linear's bf16 route

// The schedule of a launch, set by the host. A unit of work is a 64-row tile
// and a group of `per` column tiles of BN = 2 W columns, each consumer
// warpgroup W of them; the blocks are persistent and walk the units. With
// panels > 0 the unit's A rows sit in a panel [64, K] for all its column
// tiles (a prologue, if any, runs once on it) and the ring holds W tiles
// [BN, 64 k]; with panels == 0 (K too large for a panel) each ring stage
// holds an A atom [64, 64 k] and a W tile, and a prologue, if any, runs on
// each atom as it lands (atom_prologue, the LayerNorm's statistics from the
// pre-pass row_stats_bf16). resident: W fits the ring whole, so it is
// loaded once per block and kept.
struct Plan {
  int kc;                  // k chunks of 64 (k rounded up, zeros past k)
  int ntiles, groups, per, units;
  int stages, panels, resident;
  int stage_bytes, panel_bytes;
};

template <int W, int U>
__global__ void __launch_bounds__(THREADS, 1)
    linear_bf16(const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_w,
                Args g, Plan p) {
  constexpr int SP = W + 8, BN = CONSUMERS * W;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                             ~uintptr_t(1023));
  uint8_t* panel0 = base;
  uint8_t* ring = panel0 + p.panels * p.panel_bytes;
  bf16* staging = reinterpret_cast<bf16*>(ring + p.stages * p.stage_bytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + CONSUMERS * BM * SP);
  uint64_t* empty = full + p.stages;
  uint64_t* pfull = empty + p.stages;
  uint64_t* pempty = pfull + 2;
  bf16* bias_s = reinterpret_cast<bf16*>(pempty + 2);  // [n], 16-byte aligned

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (g.bias)
    for (int i = threadIdx.x; i < g.n / 8; i += THREADS)
      reinterpret_cast<uint4*>(bias_s)[i] = reinterpret_cast<const uint4*>(g.bias)[i];
  if (threadIdx.x == 0) {
    for (int i = 0; i < p.stages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, CONSUMERS);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(pfull + i, 1);
      mbar_init(pempty + i, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const bool prologue_on = g.a2 || g.ln_w;
  const int w_bytes = BN * KC * 2;  // [BN][64 k] of W

  if (warp == PRODUCER_WARP) {
    // lane 0 streams the W tiles (and, without panels, the A atoms), lane 1
    // the panels, each on its own barriers: the next unit's W tiles stream
    // in while the block finishes a unit, and its panel follows as soon as
    // that unit releases its panel
    if (lane == 0) {
      int pos = 0;
      for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
        const int row0 = (u / p.groups) * BM, t0 = (u % p.groups) * p.per;
        const int t1 = min(t0 + p.per, p.ntiles);
        if (p.resident) {  // once: every unit of this block has the same column tiles
          for (int t = t0; t < t1; ++t)
            for (int c = 0; c < p.kc; ++c) {
              const int sl = (t - t0) * p.kc + c;
              mbar_expect_tx(full + sl, w_bytes);
              tma_load(ring + sl * p.stage_bytes, &tm_w, full + sl, c * KC, t * BN);
            }
          break;
        }
        for (int t = t0; t < t1; ++t)
          for (int c = 0; c < p.kc; ++c, ++pos) {
            const int sl = pos % p.stages;
            mbar_wait(empty + sl, ((pos / p.stages) & 1) ^ 1);
            uint8_t* st = ring + sl * p.stage_bytes;
            mbar_expect_tx(full + sl, w_bytes + (p.panels ? 0 : ATOM));
            if (!p.panels) {
              tma_load(st, &tm_a, full + sl, c * KC, row0);
              st += ATOM;
            }
            tma_load(st, &tm_w, full + sl, c * KC, t * BN);
          }
      }
    } else if (lane == 1 && p.panels) {
      int ppos = 0;
      for (int u = blockIdx.x; u < p.units; u += gridDim.x, ++ppos) {
        const int sl = ppos % p.panels;
        mbar_wait(pempty + sl, ((ppos / p.panels) & 1) ^ 1);
        mbar_expect_tx(pfull + sl, p.kc * ATOM);
        for (int c = 0; c < p.kc; ++c)
          tma_load(panel0 + sl * p.panel_bytes + c * ATOM, &tm_a, pfull + sl, c * KC,
                   (u / p.groups) * BM);
      }
    }
    return;
  }

  // consumers: warpgroup wg computes columns [wg W, wg W + W) of each tile
  const int wg = threadIdx.x >> 7, t128 = threadIdx.x & 127;
  bf16* st = staging + wg * BM * SP;
  int pos = 0, ppos = 0;
  float acc[W / 2];
  for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
    const int row0 = (u / p.groups) * BM, t0 = (u % p.groups) * p.per;
    const int t1 = min(t0 + p.per, p.ntiles);
    uint8_t* panel = nullptr;
    int psl = 0;
    if (p.panels) {
      psl = ppos % p.panels;
      panel = panel0 + psl * p.panel_bytes;
      mbar_wait(pfull + psl, (ppos / p.panels) & 1);
      ++ppos;
      if (prologue_on) {
        prologue<U>(g, panel, row0, warp, 4 * CONSUMERS, lane);
        named_sync(1, 128 * CONSUMERS);
      }
    }
    for (int t = t0; t < t1; ++t) {
#pragma unroll
      for (int i = 0; i < W / 2; ++i) acc[i] = 0.f;
      wgmma_fence();
      int prev = -1;
      for (int c = 0; c < p.kc; ++c) {
        int sl;
        if (p.resident) {
          sl = (t - t0) * p.kc + c;
          mbar_wait(full + sl, 0);
        } else {
          sl = pos % p.stages;
          mbar_wait(full + sl, (pos / p.stages) & 1);
          ++pos;
        }
        if (!p.panels && prologue_on) {
          atom_prologue(g, ring + sl * p.stage_bytes, row0, c);
          named_sync(1, 128 * CONSUMERS);  // both warpgroups' parts of the atom are in place
        }
        const uint8_t* as = p.panels ? panel + c * ATOM : ring + sl * p.stage_bytes;
        const uint8_t* ws = ring + sl * p.stage_bytes + (p.panels ? 0 : ATOM) + wg * (W / 8) * 1024;
        // all four k steps of the chunk: past k, A and W are zeros (TMA)
#pragma unroll
        for (int kk = 0; kk < KC / 16; ++kk)
          Wgmma<W>::mma(acc, desc_sw128(as + kk * 32), desc_sw128(ws + kk * 32), 1);
        wgmma_commit();
        if (!p.resident) {
          wgmma_wait<1>();  // the previous k chunk's products are done: free its stage
          if (prev >= 0 && t128 == 0) mbar_arrive(empty + prev);
          prev = sl;
        }
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (prev >= 0 && t128 == 0) mbar_arrive(empty + prev);
      epilogue<W>(g, acc, bias_s, st, row0, t * BN + wg * W, t128, wg);
    }
    if (p.panels) {
      if (t128 == 0) mbar_arrive(pempty + psl);
    }
  }
}

// ---- the MLP tail in one launch: mlp_tail's bf16 route at C <= 384

// out = s + fc2(GELU(fc1(LayerNorm(s)))), s = a + a2, for 64-row tiles:
//   - the panel [64, C] (TMA) becomes LayerNorm(s) in place (prologue);
//   - the hidden [64, 4C] is made and consumed in chunks of HC = 64 columns:
//     fc1 on chunk j (each warpgroup 32 of its columns, m64n32), + b1, round,
//     GELU, round, into H[j % 2] (bf16, swizzled as wgmma's A); then fc2
//     takes the chunk at once into the [64, C] f32 accumulator (each
//     warpgroup C / 2 of the columns, m64n(C/2)); the hidden tensor never
//     leaves shared memory;
//   - at the end + b2, round, and the residual s, through the staging area
//     (the panel and H, free by then) in 16-byte rows.
// W1 chunk j ([64 hidden rows, C], K-major) and W2 chunk j ([C rows, 64
// hidden], K-major: W2's own layout) alternate in a ring of equal slots;
// when the ring holds all of W1 and W2 (C = 96: 12 slots of 16 KB), they are
// loaded once per block and kept.
constexpr int HC = 64;

struct MlpArgs {
  const void* a; const void* a2; int64_t lda;  // s = a + a2, [m, C]
  const void* ln_w; const void* ln_b; float eps;
  const void* b1; const void* b2;              // [4C], [C]
  void* out; int64_t ldo;                       // [m, C]
  int m;
};

struct MlpPlan {
  int units, stages, resident, slot_bytes;
};

template <int C>
struct MlpShape {
  static constexpr int kc = (C + KC - 1) / KC;                 // panel / W1 chunk atoms
  static constexpr int chunks = 4 * C / HC;
  static constexpr int panel_bytes = kc * ATOM;
  static constexpr int w1_bytes = kc * ATOM;                   // [64, kc * 64]
  static constexpr int w2_bytes = C * KC * 2;                  // [C, 64]
  static constexpr int w2_box = C <= 256 ? C : C / 2;          // TMA box rows
  static constexpr int slot_bytes = w1_bytes > w2_bytes ? w1_bytes : w2_bytes;
  static constexpr int h_bytes = 2 * BM * HC * 2;              // H[2]
  static constexpr int SP = C + 8;                             // staging row stride
  static_assert(BM * SP * 2 <= panel_bytes + h_bytes, "the staging area is the panel and H");
  static_assert(C % 32 == 0 && C / 2 <= 256, "fc2's columns are split in two wgmma widths");
};

template <int C>
__global__ void __launch_bounds__(THREADS, 1)
    mlp_tail_bf16(const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_w1,
                  const __grid_constant__ CUtensorMap tm_w2, MlpArgs q, MlpPlan p) {
  using S = MlpShape<C>;
  constexpr int WO = C / 2;  // fc2 columns of a warpgroup
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                             ~uintptr_t(1023));
  uint8_t* panel = base;
  uint8_t* hbuf = panel + S::panel_bytes;  // H[2]: [64 rows][64 hidden], swizzled
  uint8_t* ring = hbuf + S::h_bytes;
  bf16* staging = reinterpret_cast<bf16*>(panel);  // [64][SP], once the tile's products are done
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + p.stages * p.slot_bytes);
  uint64_t* empty = full + p.stages;
  uint64_t* pfull = empty + p.stages;
  uint64_t* pempty = pfull + 1;
  bf16* bias_s = reinterpret_cast<bf16*>(pempty + 1);  // b1 [4C] | b2 [C] (16-byte aligned)

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int i = 0; i < p.stages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, CONSUMERS);
    }
    mbar_init(pfull, 1);
    mbar_init(pempty, CONSUMERS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int seq = 2 * S::chunks;  // ring entries per tile: W1_0, W2_0, W1_1, ...

  if (warp == PRODUCER_WARP) {
    // lane 0 streams W1 and W2, lane 1 the panels (as linear_bf16)
    if (lane == 0) {
      int pos = 0;
      for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
        for (int e = 0; e < seq; ++e) {
          int sl = e;
          if (!p.resident) {
            sl = pos % p.stages;
            mbar_wait(empty + sl, ((pos / p.stages) & 1) ^ 1);
            ++pos;
          }
          uint8_t* dst = ring + sl * p.slot_bytes;
          const int j = e >> 1;
          if (!(e & 1)) {  // W1 rows [64 j, 64 j + 64), all C columns
            mbar_expect_tx(full + sl, S::w1_bytes);
            for (int c = 0; c < S::kc; ++c)
              tma_load(dst + c * ATOM, &tm_w1, full + sl, c * KC, j * HC);
          } else {         // W2 columns [64 j, 64 j + 64), all C rows
            mbar_expect_tx(full + sl, S::w2_bytes);
            for (int r = 0; r < C; r += S::w2_box)
              tma_load(dst + r * KC * 2, &tm_w2, full + sl, j * HC, r);
          }
        }
        if (p.resident) break;  // loaded once, kept for every tile
      }
    } else if (lane == 1) {
      int ppos = 0;
      for (int u = blockIdx.x; u < p.units; u += gridDim.x, ++ppos) {
        mbar_wait(pempty, (ppos & 1) ^ 1);
        mbar_expect_tx(pfull, S::panel_bytes);
        for (int c = 0; c < S::kc; ++c) tma_load(panel + c * ATOM, &tm_a, pfull, c * KC, u * BM);
      }
    }
    return;
  }

  const int wg = threadIdx.x >> 7, t128 = threadIdx.x & 127;
  const int ra = (t128 >> 5) * 16 + (lane >> 2);  // this thread's accumulator rows ra, ra + 8
  // b1 and b2 in shared memory, once per block
  for (int i = threadIdx.x; i < 5 * C / 8; i += 128 * CONSUMERS)
    reinterpret_cast<uint4*>(bias_s)[i] = i < C / 2
        ? reinterpret_cast<const uint4*>(q.b1)[i]
        : reinterpret_cast<const uint4*>(q.b2)[i - C / 2];
  named_sync(1, 128 * CONSUMERS);
  const bf16* b1s = bias_s;
  const bf16* b2s = bias_s + 4 * C;
  Args g{};  // the prologue's view of the launch
  g.a2 = q.a2; g.lda = q.lda; g.ln_w = q.ln_w; g.ln_b = q.ln_b; g.eps = q.eps;
  g.m = q.m; g.k = C;
  int pos = 0, ppos = 0;  // ring position at the start of the tile; panels taken
  float o[WO / 2];
  float h[16];            // fc1 of a chunk, this warpgroup's 32 columns
  // ring slot and barrier parity of W1_j (w2 = 0) or W2_j (w2 = 1)
  auto slot = [&](int j, int w2) { return p.resident ? 2 * j + w2 : (pos + 2 * j + w2) % p.stages; };
  auto parity = [&](int j, int w2) {
    return p.resident ? 0 : ((pos + 2 * j + w2) / p.stages) & 1;
  };

  for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
    const int row0 = u * BM;
    mbar_wait(pfull, ppos & 1);
    ++ppos;
    prologue<(C + 255) / 256>(g, panel, row0, warp, 4 * CONSUMERS, lane);
    named_sync(1, 128 * CONSUMERS);
#pragma unroll
    for (int i = 0; i < WO / 2; ++i) o[i] = 0.f;
    for (int j = 0; j < S::chunks; ++j) {
      // fc1: hidden columns [64 j + 32 wg, + 32) of the 64 rows; fc2 of
      // chunk j - 1 may still run
      const int s1 = slot(j, 0), s2 = slot(j, 1);
      mbar_wait(full + s1, parity(j, 0));
#pragma unroll
      for (int i = 0; i < 16; ++i) h[i] = 0.f;
      wgmma_fence();
      const uint8_t* w1 = ring + s1 * p.slot_bytes + wg * (32 / 8) * 1024;
#pragma unroll
      for (int kk = 0; kk < C / 16; ++kk)
        Wgmma<32>::mma(h, desc_sw128(panel + (kk >> 2) * ATOM + (kk & 3) * 32),
                       desc_sw128(w1 + (kk >> 2) * ATOM + (kk & 3) * 32), 1);
      wgmma_commit();
      wgmma_wait<0>();  // fc1 of chunk j and fc2 of chunk j - 1 are done
      fence_regs(h);
      fence_regs(o);
      if (t128 == 0 && !p.resident) {
        mbar_arrive(empty + s1);
        if (j > 0) mbar_arrive(empty + slot(j - 1, 1));
      }
      // + b1, round, GELU, round, into H[j % 2]
      uint8_t* hbuf_j = hbuf + (j & 1) * BM * HC * 2;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int c = wg * 32 + 8 * jj + 2 * (lane & 3);
        const float2 b =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b1s + j * HC + c));
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = ra + 8 * hh;
          const float y0 = gelu_tanh(rnd_bf16(h[4 * jj + 2 * hh] + b.x));
          const float y1 = gelu_tanh(rnd_bf16(h[4 * jj + 2 * hh + 1] + b.y));
          *reinterpret_cast<uint32_t*>(hbuf_j + swz(r, c >> 3) + (c & 7) * 2) = pack2(y0, y1);
        }
      }
      fence_async_smem();
      named_sync(1, 128 * CONSUMERS);  // the whole chunk is in H
      // fc2: output columns [wg C / 2, + C / 2) += H_j . W2_j^T, left running
      mbar_wait(full + s2, parity(j, 1));
      wgmma_fence();
      const uint8_t* w2 = ring + s2 * p.slot_bytes + wg * (WO / 8) * 1024;
#pragma unroll
      for (int kk = 0; kk < HC / 16; ++kk)
        Wgmma<WO>::mma(o, desc_sw128(hbuf_j + kk * 32), desc_sw128(w2 + kk * 32), 1);
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_regs(o);
    if (t128 == 0 && !p.resident) mbar_arrive(empty + slot(S::chunks - 1, 1));
    if (!p.resident) pos += seq;
    named_sync(1, 128 * CONSUMERS);  // both warpgroups' products are done: the panel and H are free
    // + b2, round, staged [64][SP]
#pragma unroll
    for (int jj = 0; jj < WO / 8; ++jj) {
      const int c = wg * WO + 8 * jj + 2 * (lane & 3);
      const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b2s + c));
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<uint32_t*>(staging + (ra + 8 * hh) * S::SP + c) =
            pack2(o[4 * jj + 2 * hh] + b.x, o[4 * jj + 2 * hh + 1] + b.y);
    }
    named_sync(1, 128 * CONSUMERS);
    // out = T(T(a + a2) + y), 16-byte rows, NB rows of loads in flight a thread
    const bf16* A = static_cast<const bf16*>(q.a);
    const bf16* A2 = static_cast<const bf16*>(q.a2);
    bf16* O = static_cast<bf16*>(q.out);
    constexpr int CH = C / 8, ITER = BM * CH / (128 * CONSUMERS);
    constexpr int NB = ITER % 3 == 0 ? 3 : ITER % 4 == 0 ? 4 : 1;
    static_assert(ITER % NB == 0, "the store loop runs in batches of NB");
    for (int i0 = 0; i0 < ITER; i0 += NB) {
      uint4 va[NB], vb[NB];
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        const int idx = threadIdx.x + (i0 + i) * 128 * CONSUMERS;
        const int r = idx / CH, cc = idx - r * CH, row = min(row0 + r, q.m - 1);
        va[i] = *reinterpret_cast<const uint4*>(A + (int64_t)row * q.lda + cc * 8);
        vb[i] = *reinterpret_cast<const uint4*>(A2 + (int64_t)row * q.lda + cc * 8);
      }
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        const int idx = threadIdx.x + (i0 + i) * 128 * CONSUMERS;
        const int r = idx / CH, cc = idx - r * CH, row = row0 + r;
        if (row >= q.m) continue;
        float y[8], s[8], s2[8];
        unpack8(*reinterpret_cast<const uint4*>(staging + r * S::SP + cc * 8), y);
        unpack8(va[i], s);
        unpack8(vb[i], s2);
#pragma unroll
        for (int e = 0; e < 8; ++e) y[e] = rnd_bf16(s[e] + s2[e]) + y[e];
        *reinterpret_cast<uint4*>(O + (int64_t)row * q.ldo + cc * 8) = pack8(y);
      }
    }
    fence_async_smem();  // the next tile's TMA writes where these reads were
    named_sync(1, 128 * CONSUMERS);
    if (t128 == 0) mbar_arrive(pempty);
  }
}

}  // namespace hop

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// ---- host: tensor maps and schedules

// the bf16 matrix [rows, cols] (row stride ld elements) in boxes of
// [box_rows, 64], 128-byte swizzled; reads past the edges are zeros
bool tensor_map(CUtensorMap* map, const void* ptr, int64_t rows, int64_t cols, int64_t ld,
                int box_rows) {
  const cuuint64_t dim[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t stride[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box[2] = {(cuuint32_t)hop::KC, (cuuint32_t)box_rows};
  return hopper::encode_bf16(map, ptr, 2, dim, stride, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

using hopper::sm_count;

// persistent blocks: as many as fit on the card at once, no more than units
template <typename Kernel>
cudaError_t persistent_grid(Kernel kernel, int smem, int units, int* grid) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, hop::THREADS, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *grid = std::min(units, per_sm * sm_count());
  return cudaSuccess;
}

// U: 16-byte units of a panel row a lane takes in the prologue (k <= 256 U)
template <int W, int U>
cudaError_t launch_linear(const Args& g, cudaStream_t s) {
  using namespace hop;
  constexpr int BN = CONSUMERS * W;
  Plan p{};
  p.kc = (g.k + KC - 1) / KC;
  p.ntiles = (g.n + BN - 1) / BN;
  const int row_tiles = (g.m + BM - 1) / BM;
  // column groups when the row tiles alone would leave SMs idle
  const int groups = std::min(p.ntiles, std::max(1, (sm_count() + row_tiles - 1) / row_tiles));
  p.per = (p.ntiles + groups - 1) / groups;
  p.groups = (p.ntiles + p.per - 1) / p.per;
  p.units = row_tiles * p.groups;
  const int w_bytes = BN * KC * 2;
  const int staging = CONSUMERS * BM * (W + 8) * 2;
  // less alignment, barriers and the bias
  const int avail = SMEM_MAX - 1024 - staging - 1024 - (g.bias ? g.n * 2 : 0);
  if (g.k <= MAX_PANEL_K) {
    p.panel_bytes = p.kc * ATOM;
    p.stage_bytes = w_bytes;
    const int T = p.per * p.kc;
    if (p.groups == 1 && p.panel_bytes + T * w_bytes <= avail) {
      p.resident = 1;
      p.stages = T;
      p.panels = 2 * p.panel_bytes + T * w_bytes <= avail ? 2 : 1;
    } else {
      p.panels = 2 * p.panel_bytes + 4 * w_bytes <= avail ? 2 : 1;
      p.stages = std::min(MAX_STAGES, (avail - p.panels * p.panel_bytes) / w_bytes);
    }
  } else {  // A atoms in the ring; a sum or a LayerNorm applied to each as it lands
    p.stage_bytes = w_bytes + ATOM;
    p.stages = std::min(MAX_STAGES, avail / p.stage_bytes);
  }
  if (p.stages < 2 && !p.resident) return cudaErrorInvalidValue;
  const int smem = 1024 + p.panels * p.panel_bytes + p.stages * p.stage_bytes + staging +
                   (2 * p.stages + 4) * 8 + (g.bias ? g.n * 2 : 0);
  CUtensorMap tm_a, tm_w;
  if (!tensor_map(&tm_a, g.a, g.m, g.k, g.lda, BM) || !tensor_map(&tm_w, g.w, g.n, g.k, g.k, BN))
    return cudaErrorInvalidValue;
  int grid = 0;
  cudaError_t e = persistent_grid(linear_bf16<W, U>, smem, p.units, &grid);
  if (e != cudaSuccess) return e;
  if (!p.panels && g.ln_w) {
    row_stats_bf16<<<(unsigned)(((int64_t)g.m * 32 + 255) / 256), 256, 0, s>>>(g);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  linear_bf16<W, U><<<grid, THREADS, smem, s>>>(tm_a, tm_w, g, p);
  return cudaGetLastError();
}

template <int C>
cudaError_t launch_mlp(const hop::MlpArgs& q, const void* w1, const void* w2, cudaStream_t s) {
  using namespace hop;
  using S = MlpShape<C>;
  MlpPlan p{};
  p.units = (q.m + BM - 1) / BM;
  p.slot_bytes = S::slot_bytes;
  const int seq = 2 * S::chunks;
  const int avail = SMEM_MAX - 1024 - S::panel_bytes - S::h_bytes - 512 - 5 * C * 2;
  p.stages = avail / S::slot_bytes;
  if (p.stages >= seq) {
    p.stages = seq;
    p.resident = 1;
  }
  if (p.stages < 2) return cudaErrorInvalidValue;
  const int smem = 1024 + S::panel_bytes + S::h_bytes + p.stages * S::slot_bytes +
                   (2 * p.stages + 2) * 8 + 5 * C * 2;
  CUtensorMap tm_a, tm_w1, tm_w2;
  if (!tensor_map(&tm_a, q.a, q.m, C, q.lda, BM) || !tensor_map(&tm_w1, w1, 4 * C, C, C, HC) ||
      !tensor_map(&tm_w2, w2, C, 4 * C, 4 * C, S::w2_box))
    return cudaErrorInvalidValue;
  int grid = 0;
  const cudaError_t e = persistent_grid(mlp_tail_bf16<C>, smem, p.units, &grid);
  if (e != cudaSuccess) return e;
  mlp_tail_bf16<C><<<grid, THREADS, smem, s>>>(tm_a, tm_w1, tm_w2, q, p);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 float32 (SIMT), 1 bfloat16 (Hopper: wgmma and TMA); every
// pointer holds that type. a2, ln_w (with ln_b), bias, r and r2 may be
// null. Launches on `stream`; returns cudaGetLastError(), or
// cudaErrorInvalidValue for shapes, strides or pointers the kernels do not
// take. stats: scratch of m float2, needed by a bf16 LayerNorm over more
// than hop::MAX_PANEL_K columns (ops/ln_linear_kernel.py MAX_PANEL_K), else null.
extern "C" int k4_ln_linear(
    int dtype, const void* a, const void* a2, int64_t lda, const void* ln_w, const void* ln_b,
    float eps, const void* w, const void* bias, int m, int k, int n, int gelu,
    const void* r, const void* r2, int64_t ldr, void* out, int64_t ldo, void* stats,
    void* stream) {
  if (m < 1 || k < 1 || n < 1 || lda < k || ldo < n || (r && ldr < n) || (ln_w && !ln_b) ||
      (r2 && !r))
    return static_cast<int>(cudaErrorInvalidValue);
  Args g{a, a2, lda, ln_w, ln_b, eps, w, bias, m, k, n, gelu, r, r2, ldr, out, ldo,
         static_cast<float2*>(stats)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const int rows = (m + simt::BM - 1) / simt::BM;
    if (rows > 65535) return static_cast<int>(cudaErrorInvalidValue);
    dim3 grid((n + simt::BN - 1) / simt::BN, rows);
    simt::ln_linear_f32<<<grid, simt::THREADS, 0, s>>>(g);
    return static_cast<int>(cudaGetLastError());
  }
  if (dtype != 1 || k % 8 || n % 8 || lda % 8 || ldo % 8 || (r && ldr % 8) || !aligned16(a) ||
      !aligned16(w) || !aligned16(out) || (a2 && !aligned16(a2)) ||
      (ln_w && !(aligned16(ln_w) && aligned16(ln_b))) || (bias && !aligned16(bias)) ||
      (r && !aligned16(r)) || (r2 && !aligned16(r2)) ||
      (ln_w && k > hop::MAX_PANEL_K && (!stats || reinterpret_cast<uintptr_t>(stats) % 8)))
    return static_cast<int>(cudaErrorInvalidValue);
  auto launch = [&](auto w) {
    constexpr int W = decltype(w)::value;
    return k <= 256 ? launch_linear<W, 1>(g, s) : k <= 512 ? launch_linear<W, 2>(g, s)
                                                            : launch_linear<W, 4>(g, s);
  };
  const cudaError_t e = n % 192 == 0 ? launch(std::integral_constant<int, 96>())
                                     : launch(std::integral_constant<int, 48>());
  return static_cast<int>(e);
}

// The MLP tail of a Swin block in one launch (bf16):
//   out = s + fc2(GELU(fc1(LayerNorm(s)))),  s = a + a2,  a, a2, out [m, c]
// with w1 [4c, c], b1 [4c], w2 [c, 4c], b2 [c] (nn.Linear's layouts) and the
// cast points of k4_ln_linear's two launches. c in {96, 192, 384}: Video
// Swin-S's stages 0-2.
extern "C" int k4_mlp_tail(const void* a, const void* a2, int64_t lda, const void* ln_w,
                           const void* ln_b, float eps, const void* w1, const void* b1,
                           const void* w2, const void* b2, int m, int c, void* out, int64_t ldo,
                           void* stream) {
  if (m < 1 || lda < c || ldo < c || lda % 8 || ldo % 8 || !a2 || !ln_w || !ln_b || !b1 ||
      !b2)
    return static_cast<int>(cudaErrorInvalidValue);
  for (const void* p : {a, a2, ln_w, ln_b, w1, b1, w2, b2, static_cast<const void*>(out)})
    if (!aligned16(p)) return static_cast<int>(cudaErrorInvalidValue);
  const hop::MlpArgs q{a, a2, lda, ln_w, ln_b, eps, b1, b2, out, ldo, m};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (c) {
    case 96: e = launch_mlp<96>(q, w1, w2, s); break;
    case 192: e = launch_mlp<192>(q, w1, w2, s); break;
    case 384: e = launch_mlp<384>(q, w1, w2, s); break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

extern "C" const char* k4_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

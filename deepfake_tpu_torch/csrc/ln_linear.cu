// K4: one linear layer of a Video Swin block with what surrounds it fused in:
//
//   s   = a (+ a2)                                   (rounded to T)
//   s   = LayerNorm(s) over the k columns            (optional; rounded to T)
//   y   = T(s . W^T + bias)                          (f32 accumulation)
//   y   = T(GELU(y))                                 (optional)
//   out = T((r (+ r2)) + y)                          (optional residual)
//
// with W the [n, k] nn.Linear weight. A Swin3D block runs it four times:
// LN1 -> qkv, proj, (x + attn) -> LN2 -> fc1 -> GELU, fc2 + (x + attn).
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
// package's gelu_exact), the residual s + y in T. bias and the LayerNorm
// weights are read in T and widened to f32.
//
// What bounds it on the H100: memory at stages 0-1, about even at 2-3. The
// layers are thin (k and n are 96 .. 3072 against 401,408 rows at video_swin
// b8 stage 0): stage 0's fc1 moves ~460 MB for 30 GFLOP. So the design fuses
// everything that would otherwise be a pass of its own over device memory:
// the a + a2 sum and the LayerNorm are formed in shared memory, and bias,
// GELU and the residual are applied to the accumulators before the one
// store. The qkv tensor and the
// MLP's hidden tensor still go through device memory between launches; fusing
// them away (qkv into K3's prologue, fc1 -> fc2 through shared memory) is the
// next step.
//   - bf16: mma.sync m16n8k16 (bf16 in, f32 accumulate) on 32 x 32 warp
//     tiles, k in steps of 64, W tiles through a three-stage cp.async ring.
//     With a LayerNorm or a sum in the prologue (ln_panel_bf16), a block
//     holds its 64 rows of A for the whole of k in shared memory, summed and
//     normalised once, and walks 128-wide column tiles against them: no
//     element of A is read or normalised twice. Without (linear_bf16),
//     128 x 64 output tiles with A in the same ring, as K1.
//   - f32 (parity): the same tiling as SIMT f32 FMA, 8 x 4 outputs a thread.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>

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

// ------------------------------------------------------ bf16: tensor cores

namespace tc {

constexpr int BK = 64, STAGES = 3;
constexpr int LD = BK + 8;  // smem row stride in elements (144 bytes): the 8 row
                            // addresses of an ldmatrix fall on distinct banks
// linear_bf16: 128 x 64 output tiles, 4 x 2 warps of 32 x 32
constexpr int BM = 128, BN = 64, THREADS = 256;
constexpr size_t linear_smem = sizeof(uint16_t) * STAGES * (BM + BN) * LD;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16-byte async copy; with valid == false nothing is read and the 16 bytes
// are zero-filled (src-size 0)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
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

__device__ __forceinline__ void unpack8(const uint4& v, float (&x)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    x[2 * j] = __low2float(h[j]);
    x[2 * j + 1] = __high2float(h[j]);
  }
}

__device__ __forceinline__ float gelu_tanh(float x) {
  const float inner = 0.79788456080286536f * (x + 0.044715f * x * x * x);
  return 0.5f * x * (1.f + tanhf(inner));
}

// the epilogue of outputs (rr, nn) and (rr, nn + 1) from their f32 sums, with
// paired loads: + bias, round; GELU, round; (r + r2 rounded) + y
__device__ __forceinline__ __nv_bfloat162 finish2(const Args& g, int rr, int nn, float a0,
                                                  float a1) {
  using bf16 = __nv_bfloat16;
  float y0 = a0, y1 = a1;
  if (g.bias) {
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
        static_cast<const bf16*>(g.bias) + nn));
    y0 += b.x;
    y1 += b.y;
  }
  y0 = rnd_bf16(y0);
  y1 = rnd_bf16(y1);
  if (g.gelu) {
    y0 = rnd_bf16(gelu_tanh(y0));
    y1 = rnd_bf16(gelu_tanh(y1));
  }
  if (g.r) {
    const int64_t o = (int64_t)rr * g.ldr + nn;
    float2 r = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(static_cast<const bf16*>(g.r) + o));
    if (g.r2) {
      const float2 r2 = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(static_cast<const bf16*>(g.r2) + o));
      r.x = rnd_bf16(r.x + r2.x);
      r.y = rnd_bf16(r.y + r2.y);
    }
    y0 = r.x + y0;
    y1 = r.y + y1;
  }
  return __floats2bfloat162_rn(y0, y1);
}

// ldmatrix fragments of a 32 x 32 warp tile from A [row][k] (row stride
// lda_s) and W [n][k] (row stride LD), k in [kk, kk + 16), into acc
__device__ __forceinline__ void mma_step(float (&acc)[2][4][4], const uint16_t* as, int lda_s,
                                         const uint16_t* bs, int kk, int lane) {
  uint32_t af[2][4], bf[4][2];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
    ldmatrix_x4(af[mi], as + (mi * 16 + (lane & 15)) * lda_s + kk + (lane >> 4) * 8);
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
    ldmatrix_x2(bf[ni], bs + (ni * 8 + (lane & 7)) * LD + kk + ((lane >> 3) & 1) * 8);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], af[mi], bf[ni]);
}

// the epilogue of a warp's 32 x 32 tile at (r0, c0)
__device__ __forceinline__ void store_tile(const Args& g, float (&acc)[2][4][4], int r0, int c0,
                                           int lane) {
  __nv_bfloat16* O = static_cast<__nv_bfloat16*>(g.out);
  // accumulator fragment: rows lane/4 and lane/4 + 8, columns 2 (lane%4) + {0, 1}
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int nn = c0 + ni * 8 + (lane & 3) * 2;
      if (nn >= g.n) continue;  // n % 8 == 0: nn + 1 < n too
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rr = r0 + mi * 16 + (lane >> 2) + 8 * h;
        if (rr >= g.m) continue;
        *reinterpret_cast<__nv_bfloat162*>(O + (int64_t)rr * g.ldo + nn) =
            finish2(g, rr, nn, acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
      }
    }
}

__device__ __forceinline__ void zero(float (&acc)[2][4][4]) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
}

// No prologue (proj, fc2): a 128 x 64 output tile per block, 8 warps of
// 32 x 32, A and W both by cp.async through a ring of STAGES, as K1. Needs
// k, n, lda, ldr and ldo multiples of 8 and a, w, bias 16-byte aligned (the
// host checks): every 16-byte chunk of a tile is then wholly inside or
// wholly outside the matrix.
__global__ void __launch_bounds__(THREADS) linear_bf16(Args g) {
  extern __shared__ __align__(16) uint16_t sml[];
  uint16_t* As = sml;                      // [STAGES][BM][LD], [row][k]
  uint16_t* Bs = As + STAGES * BM * LD;    // [STAGES][BN][LD], [n][k]: W's own layout

  using bf16 = __nv_bfloat16;
  const bf16* A = static_cast<const bf16*>(g.a);
  const bf16* W = static_cast<const bf16*>(g.w);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;  // 4 x 2 warps of 32 x 32
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;

  auto load = [&](int stage, int k0) {
    uint16_t* as = As + stage * BM * LD;
    uint16_t* bs = Bs + stage * BN * LD;
#pragma unroll
    for (int i = 0; i < BM * BK / 8 / THREADS; ++i) {  // A: 16-byte chunks (8 k)
      const int c = tid + i * THREADS, r = row0 + (c >> 3), kk = k0 + (c & 7) * 8;
      const bool ok = r < g.m && kk < g.k;
      cp_async16(as + (c >> 3) * LD + (c & 7) * 8, ok ? A + (int64_t)r * g.lda + kk : A, ok);
    }
#pragma unroll
    for (int i = 0; i < BN * BK / 8 / THREADS; ++i) {  // W
      const int c = tid + i * THREADS, nn = col0 + (c >> 3), kk = k0 + (c & 7) * 8;
      const bool ok = nn < g.n && kk < g.k;
      cp_async16(bs + (c >> 3) * LD + (c & 7) * 8, ok ? W + (int64_t)nn * g.k + kk : W, ok);
    }
  };

  float acc[2][4][4];
  zero(acc);
  const int ktiles = (g.k + BK - 1) / BK;
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < ktiles) load(st, st * BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<STAGES - 2>();  // step kt has landed (this thread's copies)
    __syncthreads();              // ... everyone's, and stage (kt - 1) is free
    const int next = kt + STAGES - 1;
    if (next < ktiles) load(next % STAGES, next * BK);
    cp_async_commit();
    const int st = kt % STAGES;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16)
      mma_step(acc, As + (st * BM + wm * 32) * LD, LD, Bs + (st * BN + wn * 32) * LD, kk, lane);
  }
  cp_async_wait<0>();
  store_tile(g, acc, row0 + wm * 32, col0 + wn * 32, lane);
}

// With a prologue (LayerNorm and/or a + a2): the block's PBM rows of A are
// summed, normalised and held in shared memory for the whole of k, so each
// element of A is read from device memory, summed and normalised once; the
// block then walks its column tiles (128 wide, 2 x 4 warps of 32 x 32), W
// tiles streaming through a cp.async ring over (column tile, k step) without
// a break between tiles. grid = (row blocks, column groups): with few row
// blocks the columns are split between groups, each of which builds the
// panel itself. Needs k a multiple of 32 up to MAX_PANEL_K and 16-byte
// aligned ln_w, ln_b too.
constexpr int PBM = 64, PBN = 128, PTHREADS = 256, MAX_PANEL_K = 1024;

__host__ __device__ constexpr size_t panel_smem(int k) {
  return sizeof(uint16_t) * (PBM * (k + 8) + STAGES * PBN * LD) + sizeof(float) * 2 * PBM;
}

__global__ void __launch_bounds__(PTHREADS) ln_panel_bf16(Args g, int tiles_per_group) {
  extern __shared__ __align__(16) uint16_t smp[];
  using bf16 = __nv_bfloat16;
  const int K = g.k, PLD = K + 8, chunks = K / 8;  // panel row stride: +16 bytes, off bank conflicts
  uint16_t* P = smp;                   // [PBM][PLD]
  uint16_t* Bs = P + PBM * PLD;        // [STAGES][PBN][LD]
  float* mu_s = reinterpret_cast<float*>(Bs + STAGES * PBN * LD);
  float* rs_s = mu_s + PBM;

  const bf16* A = static_cast<const bf16*>(g.a);
  const bf16* A2 = static_cast<const bf16*>(g.a2);
  const bf16* W = static_cast<const bf16*>(g.w);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps of 32 x 32
  const int row0 = blockIdx.x * PBM;
  const int ntiles = (g.n + PBN - 1) / PBN;
  const int t0 = blockIdx.y * tiles_per_group, t1 = min(t0 + tiles_per_group, ntiles);
  const int ktiles = (K + BK - 1) / BK;
  const int steps = (t1 - t0) * ktiles;

  // W of (column tile t0 + s / ktiles, k step s % ktiles), in 16-byte chunks
  auto load_b = [&](int s) {
    uint16_t* bs = Bs + (s % STAGES) * PBN * LD;
    const int col0 = (t0 + s / ktiles) * PBN, k0 = (s % ktiles) * BK;
#pragma unroll
    for (int i = 0; i < PBN * BK / 8 / PTHREADS; ++i) {
      const int c = tid + i * PTHREADS, nn = col0 + (c >> 3), kk = k0 + (c & 7) * 8;
      const bool ok = nn < g.n && kk < K;
      cp_async16(bs + (c >> 3) * LD + (c & 7) * 8, ok ? W + (int64_t)nn * K + kk : W, ok);
    }
  };
  // the first W tiles are in flight while the panel is built
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load_b(s);
    cp_async_commit();
  }

  // the panel: s = a (+ a2) in bf16, rows past m zero
#pragma unroll 4
  for (int c = tid; c < PBM * chunks; c += PTHREADS) {
    const int i = c / chunks, kk = (c - i * chunks) * 8, r = row0 + i;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < g.m) {
      const int64_t o = (int64_t)r * g.lda + kk;
      v = *reinterpret_cast<const uint4*>(A + o);
      if (A2) {
        float x[8], x2[8];
        unpack8(v, x);
        unpack8(*reinterpret_cast<const uint4*>(A2 + o), x2);
        __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
        for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(x[2 * j] + x2[2 * j],
                                                                 x[2 * j + 1] + x2[2 * j + 1]);
      }
    }
    *reinterpret_cast<uint4*>(P + i * PLD + kk) = v;
  }
  if (g.ln_w) {
    __syncthreads();
    // row statistics from the panel, one warp per row
    for (int i = warp; i < PBM; i += PTHREADS / 32) {
      float s1 = 0.f, s2 = 0.f;
      for (int kk = 2 * lane; kk < K; kk += 64) {
        const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(P + i * PLD + kk));
        s1 += x.x + x.y;
        s2 += x.x * x.x + x.y * x.y;
      }
      s1 = warp_sum(s1);
      s2 = warp_sum(s2);
      if (lane == 0) ln_stats(g, s1, s2, mu_s + i, rs_s + i);
    }
    __syncthreads();
    // normalise in place
    for (int c = tid; c < PBM * chunks; c += PTHREADS) {
      const int i = c / chunks, kk = (c - i * chunks) * 8;
      if (row0 + i >= g.m) continue;
      uint4* at = reinterpret_cast<uint4*>(P + i * PLD + kk);
      float x[8], lw[8], lb[8];
      unpack8(*at, x);
      unpack8(*reinterpret_cast<const uint4*>(static_cast<const bf16*>(g.ln_w) + kk), lw);
      unpack8(*reinterpret_cast<const uint4*>(static_cast<const bf16*>(g.ln_b) + kk), lb);
      const float mu = mu_s[i], rs = rs_s[i];
      uint4 v;
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        h[j] = __floats2bfloat162_rn(
            __fadd_rn(__fmul_rn(x[2 * j] - mu, rs * lw[2 * j]), lb[2 * j]),
            __fadd_rn(__fmul_rn(x[2 * j + 1] - mu, rs * lw[2 * j + 1]), lb[2 * j + 1]));
      *at = v;
    }
  }

  float acc[2][4][4];
  zero(acc);
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<STAGES - 2>();  // W of step s has landed (this thread's copies)
    __syncthreads();              // ... everyone's; the panel is built; stage (s - 1) is free
    if (s + STAGES - 1 < steps) load_b(s + STAGES - 1);
    cp_async_commit();
    const int kt = s % ktiles;
    const uint16_t* bs = Bs + ((s % STAGES) * PBN + wn * 32) * LD;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16)  // k is a multiple of 32, not always of BK
      if (kt * BK + kk < K) mma_step(acc, P + wm * 32 * PLD + kt * BK, PLD, bs, kk, lane);
    if (kt == ktiles - 1) {
      store_tile(g, acc, row0 + wm * 32, (t0 + s / ktiles) * PBN + wn * 32, lane);
      zero(acc);
    }
  }
  cp_async_wait<0>();
}

}  // namespace tc

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// dtype: 0 float32 (SIMT), 1 bfloat16 (tensor cores); every pointer holds that
// type. a2, ln_w (with ln_b), bias, r and r2 may be null. Launches on
// `stream`; returns cudaGetLastError(), or cudaErrorInvalidValue for shapes,
// strides or pointers the kernels do not take.
extern "C" int k4_ln_linear(
    int dtype, const void* a, const void* a2, int64_t lda, const void* ln_w, const void* ln_b,
    float eps, const void* w, const void* bias, int m, int k, int n, int gelu,
    const void* r, const void* r2, int64_t ldr, void* out, int64_t ldo, void* stream) {
  if (m < 1 || k < 1 || n < 1 || lda < k || ldo < n || (r && ldr < n) || (ln_w && !ln_b) ||
      (r2 && !r))
    return static_cast<int>(cudaErrorInvalidValue);
  Args g{a, a2, lda, ln_w, ln_b, eps, w, bias, m, k, n, gelu, r, r2, ldr, out, ldo};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const int rows = (m + simt::BM - 1) / simt::BM;
    if (rows > 65535) return static_cast<int>(cudaErrorInvalidValue);
    dim3 grid((n + simt::BN - 1) / simt::BN, rows);
    simt::ln_linear_f32<<<grid, simt::THREADS, 0, s>>>(g);
  } else if (dtype == 1) {
    const int rows = (m + tc::BM - 1) / tc::BM;
    if (rows > 65535 || k % 8 || n % 8 || lda % 8 || ldo % 8 || (r && ldr % 8) ||
        !aligned16(a) || !aligned16(w) || !aligned16(out) || (a2 && !aligned16(a2)) ||
        (ln_w && !(aligned16(ln_w) && aligned16(ln_b))) || (bias && !aligned16(bias)))
      return static_cast<int>(cudaErrorInvalidValue);
    if (a2 || ln_w) {
      if (k > tc::MAX_PANEL_K || k % 32) return static_cast<int>(cudaErrorInvalidValue);
      // enough blocks for two waves over the 132 SMs, splitting the columns
      // when the rows are few
      const int row_blocks = (m + tc::PBM - 1) / tc::PBM, ntiles = (n + tc::PBN - 1) / tc::PBN;
      const int groups = std::min(ntiles, std::max(1, (264 + row_blocks - 1) / row_blocks));
      const int per = (ntiles + groups - 1) / groups;
      const size_t smem = tc::panel_smem(k);
      const cudaError_t e = cudaFuncSetAttribute(
          tc::ln_panel_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return static_cast<int>(e);
      tc::ln_panel_bf16<<<dim3(row_blocks, (ntiles + per - 1) / per), tc::PTHREADS, smem, s>>>(
          g, per);
    } else {
      const cudaError_t e = cudaFuncSetAttribute(
          tc::linear_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)tc::linear_smem);
      if (e != cudaSuccess) return static_cast<int>(e);
      dim3 grid((n + tc::BN - 1) / tc::BN, rows);
      tc::linear_bf16<<<grid, tc::THREADS, tc::linear_smem, s>>>(g);
    }
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* k4_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

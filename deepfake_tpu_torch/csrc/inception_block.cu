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
// (i + oy, j + ox) leaves the frame: the prologue gathers each row's source
// row and zero-fills rows whose source falls outside, so no tap reads across
// a frame edge (the Pallas kernel's roll + boundary mask). Accumulation is in
// f32 registers for both input types (preferred_element_type=f32). The
// epilogue is either
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
// activations in and out). So the bf16 path runs on the tensor cores:
// mma.sync m16n8k16 (bf16 in, f32 accumulate) on 128x64 tiles, 8 warps of
// 32x32, fed by a 3-stage cp.async ring whose 16-byte copies zero-fill the
// rows a tap takes from outside the frame (the gather costs no extra pass).
// The f32 path is the parity reference: a shared-memory-tiled SIMT GEMM
// (128x64 tile, 8x4 outputs per thread, f32 FMA) with no TF32 rounding.
// Each launch still writes its intermediates to device memory and re-reads
// them for the next conv; a later version fuses the whole block into one
// launch, holds the branch intermediates in shared memory and feeds wgmma
// tiles from TMA loads.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

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

// ------------------------------------------------------ bf16: tensor cores

namespace tc {

constexpr int BM = 128, BN = 64, BK = 32, STAGES = 3, THREADS = 256;
constexpr int AS = BK + 8;  // smem row strides in elements: +16 bytes keeps the
constexpr int BS = BN + 8;  // 8 row addresses of an ldmatrix on distinct banks

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

// Needs k, n, lda and the column offsets of A multiples of 8 and A, W
// 16-byte aligned (the host checks): every 16-byte chunk of a tile is then
// wholly inside or wholly outside the matrix.
__global__ void __launch_bounds__(THREADS) shifted_gemm_bf16(Args g) {
  // bf16 bits: the tiles are only written by cp.async and read by ldmatrix
  __shared__ __align__(16) uint16_t As[STAGES][BM * AS];  // [row][k]
  __shared__ __align__(16) uint16_t Bs[STAGES][BK * BS];  // [k][n]

  const __nv_bfloat16* A = static_cast<const __nv_bfloat16*>(g.a);
  const __nv_bfloat16* W = static_cast<const __nv_bfloat16*>(g.w);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;  // 4 x 2 warps of 32 x 32
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int frame_len = g.h * g.wd;

  // A loader: two 16-byte chunks (8 k) of two rows per thread
  int a_r[2], a_c[2], a_i[2], a_j[2];
  bool a_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = tid + i * THREADS;
    a_r[i] = c >> 2;
    a_c[i] = (c & 3) * 8;
    const int r = row0 + a_r[i];
    a_ok[i] = r < g.rows;
    const int p = a_ok[i] ? r % frame_len : 0;
    a_i[i] = p / g.wd;
    a_j[i] = p % g.wd;
  }
  // B loader: one 16-byte chunk (8 n) of one k row per thread
  const int b_k = tid >> 3, b_n = (tid & 7) * 8;

  const int ktiles = (g.k + BK - 1) / BK;
  const int iters = g.kh * g.kw * ktiles;

  auto load_stage = [&](int stage, int it) {
    const int t = it / ktiles, k0 = (it - t * ktiles) * BK;
    const int oy = t / g.kw - g.kh / 2, ox = t % g.kw - g.kw / 2;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int si = a_i[i] + oy, sj = a_j[i] + ox, kk = k0 + a_c[i];
      const bool v = a_ok[i] && si >= 0 && si < g.h && sj >= 0 && sj < g.wd && kk < g.k;
      const __nv_bfloat16* src =
          v ? A + (int64_t)(row0 + a_r[i] + oy * g.wd + ox) * g.lda + kk : A;
      cp_async16(&As[stage][a_r[i] * AS + a_c[i]], src, v);
    }
    const int kk = k0 + b_k, nn = col0 + b_n;
    const bool v = kk < g.k && nn < g.n;
    cp_async16(&Bs[stage][b_k * BS + b_n], v ? W + ((int64_t)t * g.k + kk) * g.n + nn : W, v);
  };

  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < iters) load_stage(s, s);
    cp_async_commit();
  }
  for (int it = 0; it < iters; ++it) {
    cp_async_wait<STAGES - 2>();  // tile `it` has landed (this thread's copies)
    __syncthreads();              // ... everyone's, and stage (it - 1) is free
    const int next = it + STAGES - 1;
    if (next < iters) load_stage(next % STAGES, next);
    cp_async_commit();

    const uint16_t* as = As[it % STAGES];
    const uint16_t* bs = Bs[it % STAGES];
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[2][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4(af[mi], as + (wm * 32 + mi * 16 + (lane & 15)) * AS + kk + (lane >> 4) * 8);
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
        ldmatrix_x2_trans(bf[ni], bs + (kk + (lane & 15)) * BS + wn * 32 + ni * 8);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], af[mi], bf[ni]);
    }
  }
  cp_async_wait<0>();

  // accumulator fragment: rows lane/4 and lane/4 + 8, columns 2 (lane%4) + {0, 1}
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int rr = row0 + wm * 32 + mi * 16 + (lane >> 2);
      const int nn = col0 + wn * 32 + ni * 8 + (lane & 3) * 2;
      emit<__nv_bfloat16>(g, rr, nn, acc[mi][ni][0]);
      emit<__nv_bfloat16>(g, rr, nn + 1, acc[mi][ni][1]);
      emit<__nv_bfloat16>(g, rr + 8, nn, acc[mi][ni][2]);
      emit<__nv_bfloat16>(g, rr + 8, nn + 1, acc[mi][ni][3]);
    }
}

}  // namespace tc

}  // namespace

// dtype: 0 float32 (SIMT), 1 bfloat16 (tensor cores). Launches on `stream`;
// returns cudaGetLastError(), or cudaErrorInvalidValue for a bf16 launch
// whose shapes or pointers break the 16-byte chunking above.
extern "C" int k1_shifted_gemm(
    int dtype, const void* a, int64_t lda, int k, const void* w, int kh, int kw,
    int rows, int h, int wd, int n, int mode, const float* scale, const float* bias,
    const void* x, int64_t ldx, float res_scale, int relu,
    void* out0, int64_t ld0, int nsplit, void* out1, int64_t ld1, void* stream) {
  Args g{a, lda, k, w, kh, kw, rows, h, wd, n, mode, scale, bias,
         x, ldx, res_scale, relu, out0, ld0, nsplit, out1, ld1};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    dim3 grid((n + simt::BN - 1) / simt::BN, (rows + simt::BM - 1) / simt::BM);
    simt::shifted_gemm_f32<<<grid, simt::THREADS, 0, s>>>(g);
  } else if (dtype == 1) {
    if (k % 8 || n % 8 || lda % 8 || reinterpret_cast<uintptr_t>(a) % 16 ||
        reinterpret_cast<uintptr_t>(w) % 16)
      return static_cast<int>(cudaErrorInvalidValue);
    dim3 grid((n + tc::BN - 1) / tc::BN, (rows + tc::BM - 1) / tc::BM);
    tc::shifted_gemm_bf16<<<grid, tc::THREADS, 0, s>>>(g);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* k1_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

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
//   contraction), in the JAX order (layers.py:267-270, :322-330), so K7
//   equals its plain version in ops/int8_conv.py to the bit.
//   Tiles: 128 output pixels x 64 output channels a block of 8 warps (each a
//   32 x 32 tile of mma.sync.m16n8k32 s8 products into s32), K in steps of
//   64 bytes; operands by cp.async (16 bytes, zero-filled outside the frame
//   and past K or Cout) into a 3-stage ring whose rows are padded to 80
//   bytes, so the fragment loads meet no bank conflict. Where Cin is not a
//   multiple of 16 (the stem's RGB f0, K = 27) the operands are gathered a
//   byte at a time instead. K is zero-filled to the step inside the kernel.
// K8: k8_amax zeroes the scalar in the stream and takes max |x| over the
//   tensor (block maxima combined by atomicMax on the bits of a
//   non-negative float: max is order-free, so the result repeats to the
//   bit); k8_quantize writes q = clamp(rintf(__fdiv_rn(x, scale)), -127,
//   127) as int8 with scale = __fdiv_rn(fmaxf(amax, 1e-12), 127), dividing
//   as layers.py:251-253 does, half to even as jnp.round.
//
// What bounds them on the H100: at a fused b8 request (256 frames of 224)
// the stem's convs move the most bytes (f0 reads 38.5 MB of int8 RGB and
// writes 200 MB of bf16), the reductions' and the 1x1s' products are a few
// GOP each against 1,979 TOP/s of int8 tensor cores: most launches are
// bound by their bytes. This first design keeps the products on mma.sync
// and the loads on cp.async; wgmma on s8 with TMA, and K8's amax fused into
// the previous conv's epilogue, are later work (ROADMAP).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace i8 {

constexpr int BM = 128;      // output pixels a block
constexpr int BN = 64;       // output channels a block
constexpr int BK = 64;       // bytes of K a step (two k32 products)
constexpr int LDS = BK + 16;  // a shared row: 80 bytes, conflict-free fragments
constexpr int STAGES = 3;
constexpr int THREADS = 256;

struct ConvArgs {
  const int8_t* x;     // [F, H, W, C]
  const int8_t* w;     // [N, K], K = KH * KW * C in (ky, kx, ci) order
  const float* amax;   // the activation's max-abs, one f32 on the device
  const float* ws;     // [N] weight scales
  const float* shift;  // [N] folded BatchNorm shift, or the conv bias
  void* out;           // [M, N], M = F * Ho * Wo
  int F, H, W, C, N, KH, KW, stride, pt, pl, Ho, Wo, K, M, relu, out_bf16;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  // src-size 0 fills the 16 bytes with zeros and reads nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_pending() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2) : "memory");
}

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

// One K step's operands into one slot of the ring: 2 A chunks and 1 B chunk of
// 16 bytes a thread. VEC (Cin % 16 == 0): a chunk lies in one tap, by
// cp.async; otherwise byte by byte through registers.
template <bool VEC>
__device__ __forceinline__ void load_step(const ConvArgs& g, int8_t* As, int8_t* Bs,
                                          const Pixel (&px)[2], int n_row, int kc, int k0) {
  const int k = k0 + kc * 16;
  const int tid = threadIdx.x;
  const int a_row = tid >> 2;
  if (VEC) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int8_t* src = a_src(g, px[i], k);
      cp_async16(As + (a_row + i * 64) * LDS + kc * 16, src ? src : g.x, src != nullptr);
    }
    const bool bv = n_row < g.N && k < g.K;
    cp_async16(Bs + a_row * LDS + kc * 16, bv ? g.w + (int64_t)n_row * g.K + k : g.w, bv);
  } else {
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
}

template <bool VEC>
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
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load_step<VEC>(g, As[s], Bs[s], px, n_row, kc, s * BK);
    cp_async_commit();
  }
  for (int t = 0; t < steps; ++t) {
    cp_async_wait_pending();
    __syncthreads();
    const int pre = t + STAGES - 1;
    if (pre < steps) load_step<VEC>(g, As[pre % STAGES], Bs[pre % STAGES], px, n_row, kc, pre * BK);
    cp_async_commit();
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
        for (int j = 0; j < 2; ++j) {
          v[j] = __fadd_rn(__fmul_rn(__int2float_rn(acc[mi][ni][h * 2 + j]), os[j]), sh[j]);
          if (g.relu) v[j] = v[j] > 0.f ? v[j] : 0.f;
        }
        const int64_t o = (int64_t)m * g.N + n;
        const bool pair = n + 1 < g.N && (g.N & 1) == 0;
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
}

// ------------------------------------------------------------------- K8

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

constexpr int VEC_ELEMS = 8;  // elements a thread takes at once

// 8 elements at i * 8 from 16-byte-aligned x (one or two 16-byte loads)
template <typename T>
__device__ __forceinline__ void load8(const T* x, int64_t i, float (&v)[8]) {
  if (sizeof(T) == 2) {
    const uint4 u = reinterpret_cast<const uint4*>(x)[i];
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = __bfloat162float(h[j]);
  } else {
    const float4 a = reinterpret_cast<const float4*>(x)[2 * i];
    const float4 b = reinterpret_cast<const float4*>(x)[2 * i + 1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  }
}

template <typename T>
__global__ void __launch_bounds__(256) amax_kernel(const T* x, int64_t n, int64_t nvec,
                                                   float* amax) {
  float m = 0.f;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < nvec; i += stride) {
    float v[8];
    load8(x, i, v);
#pragma unroll
    for (int j = 0; j < 8; ++j) m = fmaxf(m, fabsf(v[j]));
  }
  for (int64_t i = nvec * VEC_ELEMS + (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride)
    m = fmaxf(m, fabsf(to_f32(x[i])));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  __shared__ float part[8];
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x < 32) {
    m = threadIdx.x < (blockDim.x >> 5) ? part[threadIdx.x] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    // non-negative floats order as their bits do
    if (threadIdx.x == 0) atomicMax(reinterpret_cast<int*>(amax), __float_as_int(m));
  }
}

__device__ __forceinline__ int8_t quantize1(float v, float scale) {
  const float q = fminf(fmaxf(rintf(__fdiv_rn(v, scale)), -127.f), 127.f);
  return static_cast<int8_t>(__float2int_rn(q));
}

template <typename T>
__global__ void __launch_bounds__(256) quantize_kernel(const T* x, int64_t n, int64_t nvec,
                                                       const float* amax, int8_t* q) {
  const float scale = __fdiv_rn(fmaxf(*amax, 1e-12f), 127.0f);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < nvec; i += stride) {
    float v[8];
    load8(x, i, v);
    uint32_t lo = 0u, hi = 0u;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      lo |= static_cast<uint32_t>(static_cast<uint8_t>(quantize1(v[j], scale))) << (8 * j);
      hi |= static_cast<uint32_t>(static_cast<uint8_t>(quantize1(v[j + 4], scale))) << (8 * j);
    }
    reinterpret_cast<uint2*>(q)[i] = make_uint2(lo, hi);
  }
  for (int64_t i = nvec * VEC_ELEMS + (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride)
    q[i] = quantize1(to_f32(x[i]), scale);
}

inline int blocks_for(int64_t work) {
  const int64_t b = (work + 255) / 256;
  return static_cast<int>(b < 1 ? 1 : (b > 4096 ? 4096 : b));
}

inline bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace i8

// K7: one int8 conv, NHWC x [F, H, W, C] int8, weights [N, KH, KW, C] int8,
// out [F, Ho, Wo, N] f32 (out_dtype 0) or bf16 (1). pt / pl: the padding
// above and to the left (the bottom and right follow from Ho and Wo).
// Returns cudaGetLastError(), or cudaErrorInvalidValue for arguments the
// kernel does not take.
extern "C" int k7_int8_conv(const void* x, const void* w, const float* amax, const float* ws,
                            const float* shift, void* out, int out_dtype, int F, int H, int W,
                            int C, int N, int KH, int KW, int stride, int pt, int pl, int Ho,
                            int Wo, int relu, void* stream) {
  const int64_t M = (int64_t)F * Ho * Wo;
  const int64_t K = (int64_t)KH * KW * C;
  if (!x || !w || !amax || !ws || !shift || !out || (out_dtype != 0 && out_dtype != 1) ||
      F < 1 || H < 1 || W < 1 || C < 1 || N < 1 || KH < 1 || KW < 1 || stride < 1 || pt < 0 ||
      pl < 0 || Ho < 1 || Wo < 1 || M > 0x7fffffff || K > (1 << 20) ||
      (int64_t)F * H * W * C > ((int64_t)1 << 40) || (M + i8::BM - 1) / i8::BM > 0x7fffffff ||
      (N + i8::BN - 1) / i8::BN > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  i8::ConvArgs g{static_cast<const int8_t*>(x), static_cast<const int8_t*>(w), amax, ws, shift,
                 out, F, H, W, C, N, KH, KW, stride, pt, pl, Ho, Wo, (int)K, (int)M, relu,
                 out_dtype};
  dim3 grid((unsigned)((M + i8::BM - 1) / i8::BM), (unsigned)((N + i8::BN - 1) / i8::BN));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C % 16 == 0 && i8::aligned(x, 16) && i8::aligned(w, 16))
    i8::conv_kernel<true><<<grid, i8::THREADS, 0, s>>>(g);
  else
    i8::conv_kernel<false><<<grid, i8::THREADS, 0, s>>>(g);
  return static_cast<int>(cudaGetLastError());
}

// K8, launch 1: amax[0] = max |x| over n elements (dtype 0 f32, 1 bf16),
// the scalar zeroed in the same stream first.
extern "C" int k8_amax(int dtype, const void* x, int64_t n, float* amax, void* stream) {
  if (!x || !amax || n < 1 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(amax, 0, sizeof(float), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t nvec = i8::aligned(x, 16) ? n / i8::VEC_ELEMS : 0;
  const int blocks = i8::blocks_for(nvec > 0 ? nvec : n);
  if (dtype == 0)
    i8::amax_kernel<float><<<blocks, 256, 0, s>>>(static_cast<const float*>(x), n, nvec, amax);
  else
    i8::amax_kernel<__nv_bfloat16><<<blocks, 256, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), n, nvec, amax);
  return static_cast<int>(cudaGetLastError());
}

// K8, launch 2: q = clamp(rintf(x / scale), -127, 127) as int8, scale =
// max(amax, 1e-12) / 127 from the device scalar.
extern "C" int k8_quantize(int dtype, const void* x, int64_t n, const float* amax, void* q,
                           void* stream) {
  if (!x || !amax || !q || n < 1 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t nvec = i8::aligned(x, 16) && i8::aligned(q, 8) ? n / i8::VEC_ELEMS : 0;
  const int blocks = i8::blocks_for(nvec > 0 ? nvec : n);
  if (dtype == 0)
    i8::quantize_kernel<float><<<blocks, 256, 0, s>>>(static_cast<const float*>(x), n, nvec,
                                                      amax, static_cast<int8_t*>(q));
  else
    i8::quantize_kernel<__nv_bfloat16><<<blocks, 256, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), n, nvec, amax, static_cast<int8_t*>(q));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* k7_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K3: window attention for Video Swin's large 3D windows (N <= 512 tokens,
// 392 for (8,7,7) windows), head dim 32, token-major. For each (window w,
// head h):
//
//   out = softmax_rows(q.s . k^T + bias[h] + mask[w % n_masks]) . v
//
// Replaces the Pallas kernel
//   deepfake_tpu/ops/pallas_window_attn.py:709 pallas_window_attention_nhc,
//     _nhc_kernel :243 (call :349)
// and, with K4 (ln_linear.cu) for the qkv and proj products around it, the
// attention of pallas_window_attention_nhc_qkv (:548, _nhc_qkv_kernel :364).
// q, k and v are [B_, N, C] with heads in channel slices, read straight out of
// one [B_, N, 3C] qkv tensor by strides (window, head, token; the head dim is
// contiguous), so there is no split copy.
//
// The cast points are the Pallas kernel's inference defaults (mxu_bf16 =
// True, no_max = True): q * bf16(scale) rounded to bf16; bf16 x bf16 dots
// with f32 accumulation; + bias (f32) + mask (bf16 {0, -100}); the
// static-shift softmax e = exp(min(x - 24, 60)) with the 1/rowsum deferred to
// the PV output; the weights cast to bf16 for PV. f32 inputs: all f32.
//
// What bounds it on the H100: memory. A launch reads q, k, v and writes out
// once (bf16), and reads the f32 bias [H, N, N] and the mask; it does
// 4 * B_ * H * N^2 * D operations. At video_swin b8 every stage is bound by
// bytes: stage 0 (B_ = 1024, H = 3) moves 308 MB of tokens plus a 39 MB mask,
// ~0.10 ms at 3.35 TB/s against ~0.06 ms of bf16 tensor-core work; the 24
// launches of one b8 request need ~0.79 ms. So the design keeps the [N, N]
// logits out of device memory altogether:
//   - bf16 (the serving path): one block of 8 warps per (window, head), so
//     q, k, v are read once. The head's K and V (N x 32 bf16) sit in shared
//     memory, keys padded with zero rows to a multiple of 16. Each warp takes
//     16 query rows at a time as mma.sync m16n8k16 A fragments and streams
//     over the keys 16 at a time: S = Q K^T on the tensor cores, bias + mask,
//     the static-shift weights, whose accumulator fragments are re-packed in
//     registers as the A fragments of P V. The static shift needs no row
//     max, so there is no rescaling and no logit tile in shared memory. Keys
//     are permuted within a step (key_of) so that a thread's weights of a row
//     are four consecutive keys: their bias is one 16-byte load and their
//     mask one 8-byte load, issued a step ahead.
//   - f32 (the parity route only; a different kernel from the one that
//     serves): one block of 8 warps per (query tile of 32 rows, window,
//     head), SIMT f32 FMA, K, V and the [32, N] logit tile in shared memory.
// The grid puts the head on its slowest axis, so a head's bias block (614 KB
// f32 at N = 392) stays in L2 while every window of that head runs.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int D = 32;       // head dim
constexpr int MAX_N = 512;  // tokens per window

struct Args {
  const void* q; const void* k; const void* v;
  int64_t s_w, s_h, s_n;           // q/k/v element strides (head dim contiguous)
  void* out; int64_t o_w, o_h, o_n;
  const float* bias;               // [heads, n, n]
  const void* mask; int n_masks;   // [n_masks, n, n]: bf16 (tensor cores) or f32 (SIMT); or null
  float scale;
  int n;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ------------------------------------------------------------- f32: SIMT

namespace simt {

constexpr int MQ = 32, THREADS = 256, DP = D + 1;  // +1 pads off bank conflicts

__host__ __device__ constexpr size_t smem_bytes(int n) {
  return sizeof(float) * (2 * n * DP + MQ * DP + MQ * (n + 1) + MQ);
}

__global__ void __launch_bounds__(THREADS) attn_f32(Args g) {
  extern __shared__ float sm[];
  const int N = g.n, NP = N + 1;
  float* ks = sm;              // [N][DP]
  float* vs = ks + N * DP;     // [N][DP]
  float* qs = vs + N * DP;     // [MQ][DP]
  float* ps = qs + MQ * DP;    // [MQ][NP] logits, then weights
  float* rs = ps + MQ * NP;    // [MQ] deferred 1/rowsum

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
  const float* mask =
      g.mask ? static_cast<const float*>(g.mask) + (int64_t)(w % g.n_masks) * N * N : nullptr;
  for (int idx = tid; idx < rows * N; idx += THREADS) {
    const int i = idx / N, j = idx - i * N;
    const float* qi = qs + i * DP;
    const float* kj = ks + j * DP;
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < D; ++c) s = fmaf(qi[c], kj[c], s);
    const int64_t at = (int64_t)(q0 + i) * N + j;
    s += bias[at];
    if (mask) s += mask[at];
    ps[i * NP + j] = s;
  }
  __syncthreads();

  for (int i = warp; i < rows; i += THREADS / 32) {
    float* p = ps + i * NP;
    float sum = 0.f;
    for (int j = lane; j < N; j += 32) {
      const float e = expf(fminf(p[j] - 24.f, 60.f));
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

}  // namespace simt

// ------------------------------------------------------ bf16: tensor cores

namespace tc {

constexpr int WARPS = 8, THREADS = 32 * WARPS;
constexpr int LD = D + 8;  // smem row stride in bf16 (80 bytes): the 8 rows of a
                           // fragment load fall on distinct banks

__host__ __device__ constexpr size_t smem_bytes(int n) {
  return sizeof(uint16_t) * 2 * ((n + 15) & ~15) * LD;
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

// Key offset, within a step of 16 keys, of k-position p of the mma tiles.
// The accumulator gives thread t4 of a quad positions 2 t4 + {0, 1} and
// 8 + 2 t4 + {0, 1} of a row; mapping them to keys 4 t4 + {0, 1, 2, 3} makes
// its four weights of a row four consecutive keys, so their bias is one
// 16-byte load and their mask one 8-byte load. K rows (for S) and V rows
// (for P V) are read in the same order, so the sum is unchanged.
__device__ __forceinline__ int key_of(int p) {
  const int q = p & 7;
  return 4 * (q >> 1) + (q & 1) + ((p >> 3) << 1);
}

// bias and mask of one row at keys k4 .. k4 + 3; a key past n, or a row past
// n, gets bias -inf and so weight 0
__device__ __forceinline__ void load_add(float (&b)[4], float (&m)[4], const float* brow,
                                         const __nv_bfloat16* mrow, bool row_ok, int k4, int n,
                                         bool vec) {
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

// One block per (window, head): K and V (N x 32 bf16, keys padded with zero
// rows to a multiple of 16) sit in shared memory; each warp takes groups of
// 16 query rows in turn. Needs q, k, v, out, bias and mask 16-byte aligned
// and every stride a multiple of 8 elements (the host checks).
__global__ void __launch_bounds__(THREADS, 3) attn_bf16(Args g) {
  extern __shared__ __align__(16) uint16_t smb[];
  const int N = g.n, NK = (N + 15) & ~15;
  uint16_t* ks = smb;           // [NK][LD]
  uint16_t* vs = ks + NK * LD;  // [NK][LD]

  const int w = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t base = (int64_t)w * g.s_w + (int64_t)h * g.s_h;
  const __nv_bfloat16* Q = static_cast<const __nv_bfloat16*>(g.q) + base;
  const __nv_bfloat16* K = static_cast<const __nv_bfloat16*>(g.k) + base;
  const __nv_bfloat16* V = static_cast<const __nv_bfloat16*>(g.v) + base;

  for (int c = tid; c < NK * (D / 8); c += THREADS) {
    const int j = c / (D / 8), part = (c % (D / 8)) * 8;
    uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
    if (j < N) {
      const int64_t off = (int64_t)j * g.s_n + part;
      kv = *reinterpret_cast<const uint4*>(K + off);
      vv = *reinterpret_cast<const uint4*>(V + off);
    }
    *reinterpret_cast<uint4*>(ks + j * LD + part) = kv;
    *reinterpret_cast<uint4*>(vs + j * LD + part) = vv;
  }
  __syncthreads();

  // q * scale in bf16, as the Pallas kernel's `q * scale.astype(bf16)`
  const float sc = __bfloat162float(__float2bfloat16(g.scale));
  const float* bias = g.bias + (int64_t)h * N * N;
  const __nv_bfloat16* mask =
      g.mask ? static_cast<const __nv_bfloat16*>(g.mask) + (int64_t)(w % g.n_masks) * N * N
             : nullptr;
  const bool vec = N % 4 == 0;
  const int g8 = lane >> 2, t4 = lane & 3;  // fragment rows g8, g8 + 8; column pairs 2 t4
  const int kb0 = key_of(g8), kb1 = key_of(8 + g8);  // K rows of this lane's S columns
  const int kv_row = key_of(lane & 15);             // V row this lane addresses for ldmatrix
  __nv_bfloat16* O = static_cast<__nv_bfloat16*>(g.out) + (int64_t)w * g.o_w + (int64_t)h * g.o_h;

  for (int r0 = warp * 16; r0 < N; r0 += WARPS * 16) {
    const int row_a = r0 + g8, row_b = row_a + 8;
    const bool ok_a = row_a < N, ok_b = row_b < N;
    uint32_t qa[D / 16][4];
#pragma unroll
    for (int s = 0; s < D / 16; ++s)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = (e & 1) ? row_b : row_a;
        const int col = s * 16 + (e >> 1) * 8 + 2 * t4;
        uint32_t pr = 0u;
        if ((e & 1) ? ok_b : ok_a) {
          const __nv_bfloat162 x =
              *reinterpret_cast<const __nv_bfloat162*>(Q + (int64_t)row * g.s_n + col);
          pr = pack_bf16(__low2float(x) * sc, __high2float(x) * sc);
        }
        qa[s][e] = pr;
      }
    const float* brow_a = bias + (int64_t)(ok_a ? row_a : 0) * N;
    const float* brow_b = bias + (int64_t)(ok_b ? row_b : 0) * N;
    const __nv_bfloat16* mrow_a = mask ? mask + (int64_t)(ok_a ? row_a : 0) * N : nullptr;
    const __nv_bfloat16* mrow_b = mask ? mask + (int64_t)(ok_b ? row_b : 0) * N : nullptr;

    float o[D / 8][4];
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[dn][e] = 0.f;
    float sum_a = 0.f, sum_b = 0.f;
    float ba[4], ma[4], bb[4], mb[4];  // this step's bias and mask, rows a and b
    load_add(ba, ma, brow_a, mrow_a, ok_a, 4 * t4, N, vec);
    load_add(bb, mb, brow_b, mrow_b, ok_b, 4 * t4, N, vec);

    for (int j0 = 0; j0 < NK; j0 += 16) {
      // the next step's bias and mask are in flight while this step computes
      float nba[4], nma[4], nbb[4], nmb[4];
      const int k4 = j0 + 16 + 4 * t4;
      load_add(nba, nma, brow_a, mrow_a, ok_a, k4, N, vec);
      load_add(nbb, nmb, brow_b, mrow_b, ok_b, k4, N, vec);

      // S = (q s) K^T for this step's 16 keys, as two n8 tiles
      float s[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
        const uint16_t* kr = ks + (j0 + (nt ? kb1 : kb0)) * LD;
#pragma unroll
        for (int st = 0; st < D / 16; ++st) {
          const uint32_t b[2] = {ld32(kr + st * 16 + 2 * t4), ld32(kr + st * 16 + 8 + 2 * t4)};
          mma_bf16(s[nt], qa[st], b);
        }
      }
      // (s + bias) + mask, the static-shift weights exp(min(x - 24, 60)) summed
      // in f32, then packed to bf16 as P's A fragment: tile nt, element i of
      // row a is key 4 t4 + 2 nt + i
      uint32_t pa[4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        float e[4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int c = 2 * nt + i;
          e[i] = expf(fminf((s[nt][i] + ba[c]) + ma[c] - 24.f, 60.f));
          e[2 + i] = expf(fminf((s[nt][2 + i] + bb[c]) + mb[c] - 24.f, 60.f));
        }
        sum_a += e[0] + e[1];
        sum_b += e[2] + e[3];
        pa[nt * 2] = pack_bf16(e[0], e[1]);
        pa[nt * 2 + 1] = pack_bf16(e[2], e[3]);
      }
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        uint32_t vb[2];
        ldmatrix_x2_trans(vb, vs + (j0 + kv_row) * LD + dn * 8);
        mma_bf16(o[dn], pa, vb);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        ba[c] = nba[c]; ma[c] = nma[c]; bb[c] = nbb[c]; mb[c] = nmb[c];
      }
    }

    // a row's sum is spread over the 4 threads of its quad
    sum_a += __shfl_xor_sync(0xffffffffu, sum_a, 1);
    sum_a += __shfl_xor_sync(0xffffffffu, sum_a, 2);
    sum_b += __shfl_xor_sync(0xffffffffu, sum_b, 1);
    sum_b += __shfl_xor_sync(0xffffffffu, sum_b, 2);
    const float ra = 1.f / sum_a, rb = 1.f / sum_b;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
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

// dtype: 0 float32 (SIMT, f32 mask), 1 bfloat16 (tensor cores, bf16 mask).
// grid = (windows, heads) on the tensor cores, (query tiles, windows, heads)
// in SIMT. Returns cudaGetLastError(), or cudaErrorInvalidValue for
// arguments the kernels do not take.
extern "C" int k3_window_attn(
    int dtype, const void* q, const void* k, const void* v,
    int64_t s_w, int64_t s_h, int64_t s_n,
    void* out, int64_t o_w, int64_t o_h, int64_t o_n,
    const float* bias, const void* mask, int n_masks, float scale,
    int windows, int heads, int n, int d, void* stream) {
  if (n < 1 || n > MAX_N || d != D || windows < 1 || windows > 65535 || heads < 1 ||
      heads > 65535 || (mask && (n_masks < 1 || windows % n_masks)))
    return static_cast<int>(cudaErrorInvalidValue);
  Args g{q, k, v, s_w, s_h, s_n, out, o_w, o_h, o_n, bias, mask, mask ? n_masks : 1,
         scale, n};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1) {
    if (!(aligned16(q) && aligned16(k) && aligned16(v) && aligned16(out) && aligned16(bias) &&
          aligned16(mask)) ||
        (s_w | s_h | s_n | o_w | o_h | o_n) % 8)
      return static_cast<int>(cudaErrorInvalidValue);
    dim3 grid(windows, heads);
    err = launch(tc::attn_bf16, grid, tc::THREADS, tc::smem_bytes(n), s, g);
  } else if (dtype == 0) {
    dim3 grid((n + simt::MQ - 1) / simt::MQ, windows, heads);
    err = launch(simt::attn_f32, grid, simt::THREADS, simt::smem_bytes(n), s, g);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

extern "C" const char* k3_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

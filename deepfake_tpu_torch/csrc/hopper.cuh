// Hopper building blocks shared by the kernels that run on TMA and wgmma
// (inception_block.cu: K1, window_attn.cu: K2, window_attn3d.cu: K3,
// ln_linear.cu: K4, window_attn3d_train.cu: K5's backward, int8_conv.cu:
// K7): shared-memory
// addresses, mbarriers, TMA loads and stores and bulk loads, wgmma fences,
// waits, descriptors and the register-A products of the window attention
// kernels, and, on the host, the tensor-map encoding.
// cuTensorMapEncodeTiled is taken from the driver through the runtime
// (cudaGetDriverEntryPoint*), so no library needs -lcuda.
// Each source that includes this header is compiled into a library of its
// own, so the header sits beside them in csrc/.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace hopper {

// ---- device

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
// returns once the phase of parity `parity` has completed; a wait of more
// than 10 s is a fault in the schedule, so it traps (the launch fails)
// instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done, spins = 0;
  uint64_t t0 = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (!done && (++spins & 255) == 0) {
      if (!t0) t0 = global_ns();
      else if (global_ns() - t0 > 10000000000ull) __trap();
    }
  } while (!done);
}
// one 2D box of the tensor map at (x = column, y = row) into dst; completion
// (its bytes) is counted on bar
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int x,
                                         int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(x), "r"(y)
      : "memory");
}
// one 3D box at (x, y, z)
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int x, int y, int z) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(x), "r"(y), "r"(z)
      : "memory");
}
// one 4D box at (x, y, z, t); elements outside the tensor (negative
// coordinates included) are written as zeros
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int x, int y, int z, int t) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(x), "r"(y), "r"(z), "r"(t)
      : "memory");
}
// a 2D box of shared memory src out to the tensor map at (x, y), by the
// bulk-copy engine (elements outside the tensor are not written); the
// stores a thread issued complete as one bulk group at its commit
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int x,
                                             int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(x), "r"(y)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// the thread's committed bulk stores have read their shared memory (it may
// be written again)
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// ... and are complete
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
// generic-proxy writes to shared memory become visible to wgmma and TMA
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global
// memory into dst by the bulk-copy engine; completion is counted on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
// keeps the compiler from moving accumulator reads above a wgmma wait
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// 2^x, the special-function unit's approximation; subnormal results flush to 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
// wgmma descriptor of an operand in the 64-byte-swizzled layout TMA writes
// for rows of 32 bf16 (64 bytes; 8-row groups 512 bytes apart), as K3 and
// K5 keep a head's q, k, v (and dO) rows. Read K-major (the head dim is
// wgmma's K, as K for S = q K^T) it ignores lbo; read MN-major (the head dim
// is wgmma's N, as V for P V), lbo and sbo are both 512 bytes.
__device__ __forceinline__ uint64_t desc_sw64(const void* p, uint32_t lbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(512 >> 4) << 32) | ((uint64_t)2 << 62);
}

// wgmma descriptor of a K-major operand in the 128-byte-swizzled layout
// (rows of 64 bf16, 128 bytes; 8-row groups 1024 bytes apart; p inside a
// 1024-aligned atom): a step of 16 k inside the atom is p + 32 bytes
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}
// wgmma descriptor of a K-major s8 operand in the layout TMA writes for rows
// of `row` bytes (32, 64 or 128) swizzled at that width (8-row groups 8 *
// row bytes apart; p inside an aligned atom of 8 rows): a step of 32 k
// inside a row is p + 32 bytes
__device__ __forceinline__ uint64_t desc_sw(const void* p, int row) {
  const uint64_t layout = row == 128 ? 1 : row == 64 ? 2 : 3;
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)((8 * row) >> 4) << 32) | (layout << 62);
}
// byte offset of element c (< 64) of row r in that layout
__device__ __forceinline__ int sw128_offset(int r, int c) {
  return r * 128 + ((((c >> 3) ^ r) & 7) << 4) + (c & 7) * 2;
}

// wgmma.mma_async m64nNk16, bf16 x bf16 -> f32, A from registers (the
// mma.m16n8k16 A fragment of each warp's 16 rows), B from shared memory;
// TRANS_B 0: B K-major, 1: MN-major; acc == 0 overwrites d
template <int N, int TRANS_B>
struct WgmmaRS;

template <>
struct WgmmaRS<64, 0> {
  __device__ static __forceinline__ void mma(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                             int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
  }
};

template <>
struct WgmmaRS<16, 0> {
  __device__ static __forceinline__ void mma(float (&d)[8], const uint32_t (&a)[4], uint64_t db,
                                             int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
  }
};

template <>
struct WgmmaRS<32, 1> {
  __device__ static __forceinline__ void mma(float (&d)[16], const uint32_t (&a)[4], uint64_t db,
                                             int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
  }
};

// ---- host

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

// a tensor of `type` and `rank` dims (dim[0] innermost, contiguous; stride[i] the
// byte stride of dim i + 1) in boxes of box[]; reads past the edges are
// zeros. `elem`, where given, is each dim's traversal stride: a box then
// loads every elem[i]-th element of box[i], ceil(box[i] / elem[i]) of them
inline bool encode(CUtensorMap* map, CUtensorMapDataType type, const void* ptr, int rank,
                   const cuuint64_t* dim, const cuuint64_t* stride, const cuuint32_t* box,
                   CUtensorMapSwizzle swizzle, const cuuint32_t* elem = nullptr) {
  const EncodeTiled enc = encoder();
  if (!enc) return false;
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  return enc(map, type, rank, const_cast<void*>(ptr), dim, stride, box, elem ? elem : ones,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}
inline bool encode_bf16(CUtensorMap* map, const void* ptr, int rank, const cuuint64_t* dim,
                        const cuuint64_t* stride, const cuuint32_t* box,
                        CUtensorMapSwizzle swizzle) {
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, ptr, rank, dim, stride, box, swizzle);
}

// devices past this many are served but not cached
constexpr int MAX_DEVICES = 64;

// the current device, or -1 where it has no cache slot
inline int device_slot() {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= MAX_DEVICES) return -1;
  return dev;
}

// the current device's SM count, asked of the runtime once per device
inline int sm_count() {
  static std::atomic<int> cached[MAX_DEVICES];
  const int slot = device_slot();
  if (slot >= 0) {
    const int n = cached[slot].load(std::memory_order_relaxed);
    if (n > 0) return n;
  }
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n < 1)
    return 1;
  if (slot >= 0) cached[slot].store(n, std::memory_order_relaxed);
  return n;
}

}  // namespace hopper

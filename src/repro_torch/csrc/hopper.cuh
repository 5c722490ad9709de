// Hopper (sm_90a) building blocks shared by K2's forward
// (flash_attention.cu) and its backward (flash_attention_bwd.cu): mbarriers,
// TMA loads of 4-d (d, s, head, batch) bf16 tiles, wgmma shared-memory
// descriptors and bf16 products into fp32 registers, and the host's tensor
// maps.  Each source that includes it is compiled into its own library.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;

struct Strides {
  long long b, h, s;            // element strides; d is contiguous
};

namespace tc {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kErrTensorMap = -1;

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done;
}

// Wait for the phase of parity ``parity`` to complete.  A wait of more than
// ~2**35 cycles (tens of seconds) can only be a lost transfer or arrival:
// it traps, so the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > (1ll << 35)) __trap();
}

// one box of the 4-d map (d, s, head, batch) into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int d, int s, int h, int b,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(d), "r"(s), "r"(h), "r"(b),
      "r"(bar)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16 B units) and the swizzle layout (1 = 128 B, 3 = 32 B)
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo, uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// keep the compiler from moving accesses of wgmma registers across the
// asynchronous product's issue and wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
// keep A fragments that an issued wgmma reads in their registers until
// its wait
template <int T>
__device__ __forceinline__ void keep_frags(const uint32_t (&a)[T][4]) {
#pragma unroll
  for (int t = 0; t < T; ++t)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" ::"r"(a[t][j]) : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// An fp32 wgmma accumulator (64 x 16T) as 2T k-steps of bf16 A fragments,
// split x = hi + lo with hi = bf16(x) and lo = bf16(x - hi): k-step t
// takes registers 8t .. 8t+7, the pair 2j, 2j+1 into A register j.
template <int T>
__device__ __forceinline__ void split_frags(const float (&x)[8 * T],
                                            uint32_t (&hi)[T][4],
                                            uint32_t (&lo)[T][4]) {
#pragma unroll
  for (int t = 0; t < T; ++t)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float a = x[8 * t + 2 * j], b = x[8 * t + 2 * j + 1];
      const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
      const float2 hf = __bfloat1622float2(h);
      hi[t][j] = bf16x2_bits(h);
      lo[t][j] = bf16x2_bits(__floats2bfloat162_rn(a - hf.x, b - hf.y));
    }
}

// operand lists: c is the constraint, "+f" (accumulate) or "=f" (overwrite)
#define F4(c, d, i) c(d[i]), c(d[i + 1]), c(d[i + 2]), c(d[i + 3])
#define F8(c, d, i) F4(c, d, i), F4(c, d, i + 4)
#define F16(c, d) F8(c, d, 0), F8(c, d, 8)
#define F32(c, d) F8(c, d, 0), F8(c, d, 8), F8(c, d, 16), F8(c, d, 24)
#define F64(c, d) \
  F32(c, d), F8(c, d, 32), F8(c, d, 40), F8(c, d, 48), F8(c, d, 56)
#define F128(c, d)                                                     \
  F64(c, d), F8(c, d, 64), F8(c, d, 72), F8(c, d, 80), F8(c, d, 88),     \
      F8(c, d, 96), F8(c, d, 104), F8(c, d, 112), F8(c, d, 120)
#define R8 "%0, %1, %2, %3, %4, %5, %6, %7"
#define R16 R8 ", %8, %9, %10, %11, %12, %13, %14, %15"
#define R32                                                                  \
  R16 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, " \
      "%29, %30, %31"
#define R64                                                                  \
  R32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, " \
      "%45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "    \
      "%58, %59, %60, %61, %62, %63"
#define R128                                                                 \
  R64 ", "                                                                   \
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, "    \
      "%77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, "    \
      "%90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, "       \
      "%102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, "   \
      "%113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "   \
      "%124, %125, %126, %127"

// d (64 x N, fp32) (+)= A (64 x 16) * B (16 x N), bf16 operands.
//   ss: A and B from shared memory, both K-major; d = A B when first (the
//       old d is not read, so it need not stay live), else d += A B.
//   rs: d += A B, A from registers (4 x bf16x2 a thread), B MN-major
//       (read with the transpose bit).
template <int N>
struct Mma;

template <>
struct Mma<16> {
  static __device__ __forceinline__ void rs(float (&d)[8],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {" R8 "}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : F8("+f", d, 0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Mma<32> {
  template <bool first>
  static __device__ __forceinline__ void ss(float (&d)[16], uint64_t a,
                                            uint64_t b) {
    if (first)
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {" R16 "}, "
          "%16, %17, p, 1, 1, 0, 0;\n}\n"
          : F16("=f", d)
          : "l"(a), "l"(b), "r"(0));
    else
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {" R16 "}, "
          "%16, %17, p, 1, 1, 0, 0;\n}\n"
          : F16("+f", d)
          : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Mma<64> {
  template <bool first>
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a,
                                            uint64_t b) {
    if (first)
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" R32 "}, "
          "%32, %33, p, 1, 1, 0, 0;\n}\n"
          : F32("=f", d)
          : "l"(a), "l"(b), "r"(0));
    else
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" R32 "}, "
          "%32, %33, p, 1, 1, 0, 0;\n}\n"
          : F32("+f", d)
          : "l"(a), "l"(b), "r"(1));
  }
  static __device__ __forceinline__ void rs(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" R32 "}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : F32("+f", d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Mma<128> {
  template <bool first>
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t a,
                                            uint64_t b) {
    if (first)
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" R64 "}, "
          "%64, %65, p, 1, 1, 0, 0;\n}\n"
          : F64("=f", d)
          : "l"(a), "l"(b), "r"(0));
    else
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" R64 "}, "
          "%64, %65, p, 1, 1, 0, 0;\n}\n"
          : F64("+f", d)
          : "l"(a), "l"(b), "r"(1));
  }
  static __device__ __forceinline__ void rs(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" R64 "}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : F64("+f", d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

// the forward's P.V at D = 256 (its O accumulator is 64 x 256)
template <>
struct Mma<256> {
  static __device__ __forceinline__ void rs(float (&d)[128],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {" R128 "}, "
        "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
        : F128("+f", d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

#undef F4
#undef F8
#undef F16
#undef F32
#undef F64
#undef F128
#undef R8
#undef R16
#undef R32
#undef R64
#undef R128

// A tile row of D bf16 is stored as kParts blocks of kCols columns (one
// TMA box each), every block swizzled like the wgmma descriptors say:
// 128 B rows at D = 64, 128 and 256, 32 B rows at D = 16.
template <int D>
struct Rows {
  static constexpr int kCols = D < 64 ? D : 64;
  static constexpr int kParts = D / kCols;
  static constexpr int kRowBytes = kCols * 2;
  static constexpr uint64_t kLayout = D < 64 ? 3 : 1;   // 32 B / 128 B
};

// K-major operand descriptor of k-step kk (16 of the D columns) of a tile
// at ``addr`` whose parts are ``part_bytes`` apart
template <int D>
__device__ __forceinline__ uint64_t kmajor(uint32_t addr, int part_bytes,
                                           int kk) {
  using R = Rows<D>;
  const int part = kk * 16 / R::kCols;
  const int off = (kk * 16 % R::kCols) * 2;
  return desc(addr + part * part_bytes + off, 16, 8 * R::kRowBytes,
              R::kLayout);
}

// MN-major (transposed) B operand descriptor of k-step t (rows 16t ..
// 16t+15, all D columns) of a tile at ``addr`` whose parts are
// ``part_bytes`` apart
template <int D>
__device__ __forceinline__ uint64_t mnmajor(uint32_t addr, int part_bytes,
                                            int t) {
  using R = Rows<D>;
  return desc(addr + t * 16 * R::kRowBytes, part_bytes, 8 * R::kRowBytes,
              R::kLayout);
}

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// needs no -lcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// the 4-d map (d, s, head, batch) of a bf16 tensor, boxes of cols x rows.
// The driver call needs a current context, which a host thread that has
// made no runtime call yet lacks (autograd's device thread, when K2's
// backward is its first CUDA work: CUDA_ERROR_INVALID_CONTEXT), so the
// current device's primary context is made current first (cudaSetDevice).
bool make_map(CUtensorMap* map, const void* ptr, int D, int cols, int S,
              int heads, int B, Strides st, int rows) {
  EncodeTiled encode = encode_tiled();
  int dev;
  if (encode == nullptr || cudaGetDevice(&dev) != cudaSuccess ||
      cudaSetDevice(dev) != cudaSuccess)
    return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)heads,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st.s * 2, (cuuint64_t)st.h * 2,
                                 (cuuint64_t)st.b * 2};
  const cuuint32_t box[4] = {(cuuint32_t)cols, (cuuint32_t)rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                D < 64 ? CU_TENSOR_MAP_SWIZZLE_32B : CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace tc

}  // namespace

// Paged decode attention for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the Pallas TPU kernel
//   repro/kernels/paged_attention/kernel.py::paged_attention  (body _kernel)
// and computes what it computes: for each sequence, one query token's GQA
// attention over the sequence's pages of a shared K/V pool, with an fp32
// online softmax (running max, denominator, accumulator) over the pages in
// order, positions >= length masked with -1e30, the G query heads of a kv
// head together, and output 0 for a sequence of length 0.  int8 pages are
// multiplied by their (page, kv head) fp32 scale before use.
//
// What bounds it on an H100: bytes.  Each K/V element read is used for G
// (= 3 on smollm) multiply-adds per head group, far below the ~20 fp32
// operations per byte at which the card's CUDA cores, not HBM, would be
// the limit.  The least time is the live K/V pages (plus q, out and the
// live block-table entries) over 3.35 TB/s.
//
// What the design does about it:
//  * it reads only live pages: a block loops over ceil(len / page) table
//    entries and never touches dead ones (the Pallas kernel's clamped
//    index map, made explicit);
//  * each K/V element is read from device memory once, by one block: the
//    grid is (sequence, kv head), and the block serves all G query heads
//    of its kv head from one shared-memory copy of the tile;
//  * loads are coalesced along head_dim (a token's D values for one kv
//    head are contiguous in the pool);
//  * several pages are staged per iteration (a tile of ~64 tokens) to cut
//    the number of block-wide barriers per token.
// It stays a simple kernel: no TMA, no wgmma, no split-K across blocks, so
// a short batch leaves most SMs idle.  Those are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kTileTokens = 64;   // tokens staged per iteration (>= 1 page)

enum DType : int { kF32 = 0, kBF16 = 1, kI8 = 2 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(int8_t x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);   // round to nearest even, as torch's cast
}

// Shared memory (floats unless noted), for G heads, head dim D and a tile
// of T tokens:
//   q   G*D        query rows of the group, pre-scaled by 1/sqrt(D)
//   k   T*(D+1)    K tile; rows padded by one so the score loop, whose
//                  threads walk tokens, hits distinct banks
//   v   T*D        V tile
//   p   G*T        scores, then exp(score - m)
//   acc G*D        fp32 accumulators
//   m, l, c  G     running max, denominator, this tile's rescale factor
//   pid (int) T/page + 1   page ids of the tile
__host__ __device__ inline size_t smem_bytes(int G, int D, int T, int page) {
  return sizeof(float) *
             (size_t)(G * D + T * (D + 1) + T * D + G * T + G * D + 3 * G) +
         sizeof(int) * (size_t)(T / page + 1);
}

template <typename QT, typename KVT, bool kQuant>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(
    const QT* __restrict__ q, const KVT* __restrict__ k_pages,
    const KVT* __restrict__ v_pages, const float* __restrict__ k_scales,
    const float* __restrict__ v_scales,
    const int32_t* __restrict__ block_tables,
    const int32_t* __restrict__ lengths, QT* __restrict__ out, int H, int KH,
    int D, int page, int NP, int tile_pages, float scale) {
  const int b = blockIdx.x;
  const int kh = blockIdx.y;
  const int G = H / KH;
  const int T = tile_pages * page;
  const int DP = D + 1;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + G * D;
  float* v_s = k_s + T * DP;
  float* p_s = v_s + T * D;
  float* acc_s = p_s + G * T;
  float* m_s = acc_s + G * D;
  float* l_s = m_s + G;
  float* c_s = l_s + G;
  int* pid_s = reinterpret_cast<int*>(c_s + G);

  const int len = max(0, min(lengths[b], NP * page));
  const int live_pages = (len + page - 1) / page;
  const int32_t* table = block_tables + (size_t)b * NP;

  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D, d = i % D;
    q_s[i] = to_float(q[((size_t)b * H + kh * G + g) * D + d]) * scale;
    acc_s[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }

  for (int p0 = 0; p0 < live_pages; p0 += tile_pages) {
    const int np_tile = min(tile_pages, live_pages - p0);
    const int nt = np_tile * page;
    __syncthreads();  // the previous tile is consumed; init is visible
    for (int i = tid; i < np_tile; i += kThreads) pid_s[i] = table[p0 + i];
    __syncthreads();

    // stage the tile's K and V for this kv head as fp32
    for (int i = tid; i < nt * D; i += kThreads) {
      const int t = i / D, d = i % D;
      const int pid = pid_s[t / page];
      const size_t src =
          (((size_t)pid * page + (t % page)) * KH + kh) * (size_t)D + d;
      float kv = to_float(k_pages[src]);
      float vv = to_float(v_pages[src]);
      if (kQuant) {
        kv *= k_scales[(size_t)pid * KH + kh];
        vv *= v_scales[(size_t)pid * KH + kh];
      }
      k_s[t * DP + d] = kv;
      v_s[t * D + d] = vv;
    }
    __syncthreads();

    // scores of the G heads against the tile's tokens, masked past len
    for (int i = tid; i < G * nt; i += kThreads) {
      const int g = i / nt, t = i % nt;
      const float* qr = q_s + g * D;
      const float* kr = k_s + t * DP;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
      p_s[g * T + t] = (p0 * page + t < len) ? s : kNegInf;
    }
    __syncthreads();

    // online-softmax update: one warp per head
    for (int g = warp; g < G; g += kThreads / 32) {
      float mx = kNegInf;
      for (int t = lane; t < nt; t += 32) mx = fmaxf(mx, p_s[g * T + t]);
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < nt; t += 32) {
        const float e = expf(p_s[g * T + t] - m_new);
        p_s[g * T + t] = e;
        sum += e;
      }
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        l_s[g] = l_s[g] * corr + sum;
        c_s[g] = corr;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + p @ V
    for (int i = tid; i < G * D; i += kThreads) {
      const int g = i / D, d = i % D;
      const float* pr = p_s + g * T;
      float pv = 0.f;
      for (int t = 0; t < nt; ++t) pv = fmaf(pr[t], v_s[t * D + d], pv);
      acc_s[i] = acc_s[i] * c_s[g] + pv;
    }
  }
  __syncthreads();

  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D, d = i % D;
    out[((size_t)b * H + kh * G + g) * D + d] =
        from_float<QT>(acc_s[i] / fmaxf(l_s[g], 1e-30f));
  }
}

template <typename QT, typename KVT, bool kQuant>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const void* k_scales, const void* v_scales,
                   const void* block_tables, const void* lengths, void* out,
                   int B, int H, int KH, int D, int page, int NP, float scale,
                   cudaStream_t stream) {
  const int G = H / KH;
  const int tile_pages = page >= kTileTokens ? 1 : kTileTokens / page;
  const size_t smem = smem_bytes(G, D, tile_pages * page, page);
  auto kernel = paged_attention_kernel<QT, KVT, kQuant>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid(B, KH);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KVT*>(k_pages),
      static_cast<const KVT*>(v_pages), static_cast<const float*>(k_scales),
      static_cast<const float*>(v_scales),
      static_cast<const int32_t*>(block_tables),
      static_cast<const int32_t*>(lengths), static_cast<QT*>(out), H, KH, D,
      page, NP, tile_pages, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on ``stream``; returns cudaGetLastError() after the launch (0 on
// success).  q_dtype: 0 f32, 1 bf16; kv_dtype: the same, or 2 for int8
// pages with (P, KH) fp32 scales.  All pointers are device pointers to
// contiguous tensors.
int paged_attention_launch(int q_dtype, int kv_dtype, const void* q,
                           const void* k_pages, const void* v_pages,
                           const void* k_scales, const void* v_scales,
                           const void* block_tables, const void* lengths,
                           void* out, int B, int H, int KH, int D, int page,
                           int NP, float scale, void* stream) {
  if (B <= 0) return 0;
  if (KH <= 0 || H % KH != 0 || D <= 0 || page <= 0 || NP <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PA_LAUNCH(QT, KVT, QUANT)                                           \
  return (int)launch<QT, KVT, QUANT>(q, k_pages, v_pages, k_scales,       \
                                     v_scales, block_tables, lengths, out, \
                                     B, H, KH, D, page, NP, scale, s)
  if (q_dtype == kF32 && kv_dtype == kF32) PA_LAUNCH(float, float, false);
  if (q_dtype == kBF16 && kv_dtype == kBF16)
    PA_LAUNCH(__nv_bfloat16, __nv_bfloat16, false);
  if (q_dtype == kF32 && kv_dtype == kI8) PA_LAUNCH(float, int8_t, true);
  if (q_dtype == kBF16 && kv_dtype == kI8)
    PA_LAUNCH(__nv_bfloat16, int8_t, true);
#undef PA_LAUNCH
  return (int)cudaErrorInvalidValue;
}

const char* paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

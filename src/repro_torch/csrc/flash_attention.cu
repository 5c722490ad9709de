// Flash prefill attention for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the Pallas TPU kernel
//   repro/kernels/flash_attention/kernel.py::flash_attention  (body _kernel)
// and computes what it computes: blockwise attention of q (B,H,Sq,D) over
// k/v (B,KH,Sk,D), query head h reading kv head h / G, with an fp32 online
// softmax (running max, denominator, accumulator) over the kv tiles in
// order; q is cast to fp32 and scaled by 1/sqrt(D), the probabilities stay
// fp32 for the P.V product, and the denominator is clamped at 1e-30.
// Masks are aligned top-left (query i and key j both count from 0, also
// when Sq != Sk): causal keeps j <= i, a window keeps i - j < window, keys
// at j >= Sk are masked and their V rows read as 0.  A query row that sees
// no key at all (only possible with a window and Sq > Sk + window - 1)
// yields 0; the Pallas kernel's output there depends on its tile size.
//
// What bounds it on an H100: operations.  A 64-row query tile reads each
// K/V element once per tile and uses it for 64 multiply-adds, so at the
// serving shapes (S >= 512) the work is ~4*B*H*D FLOPs per visible
// (query, key) pair against a few bytes per pair; the least time is those
// FLOPs over the tensor cores' 989 TFLOP/s (bf16).  This kernel does them
// in fp32 on the CUDA cores (67 TFLOP/s), so it cannot come near that
// bound; tensor cores (wgmma fed by TMA) are later work.
//
// What the design does about it:
//  * one block per (query tile of 64 rows, query head, batch); a loop in
//    the block walks the 64-row K/V tiles, which replaces the Pallas grid's
//    sequential kv axis, with max, denominator and accumulator of each row
//    held in registers in fp32;
//  * tiles wholly past the causal diagonal or wholly before the window are
//    skipped (half of the causal work), which leaves the result unchanged;
//  * 256 threads as a 16 x 16 grid: thread (ty, tx) owns query rows
//    ty + 16*i (i < 4) and key columns tx + 16*j of the score tile, and the
//    same rows and head-dim columns tx + 16*j of the accumulator, so the
//    row max and sum are reduced with shuffles across the 16 lanes of tx;
//  * K rows in shared memory are padded to D + 1 floats, so the 16 lanes
//    that read 16 different keys at one d hit 16 different banks;
//  * q, k and v are read through element strides (D contiguous), so the
//    model layout (B,S,H,D) is passed without a copy, and the output is
//    written through strides the same way.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kTile = 64;       // query rows per block and keys per kv tile
constexpr int kThreads = 256;   // 16 x 16
constexpr int kRows = kTile / 16;

enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);   // round to nearest even, as torch's cast
}

struct Strides {
  long long b, h, s;            // element strides; d is contiguous
};

// Shared memory (floats) for head dim D:
//   q  kTile*D        query tile, fp32, pre-scaled
//   k  kTile*(D+1)    key tile (padded rows)
//   v  kTile*D        value tile
//   p  kTile*(kTile+1) probabilities of the tile
__host__ __device__ constexpr size_t smem_bytes(int D) {
  return sizeof(float) * (size_t)(kTile * D + kTile * (D + 1) + kTile * D +
                                  kTile * (kTile + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, int H, int KH, int Sq, int Sk, Strides qs,
    Strides ks, Strides vs, Strides os, int causal, int window,
    float scale) {
  constexpr int DP = D + 1;
  constexpr int PP = kTile + 1;
  constexpr int DC = D / 16;    // accumulator columns per thread
  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / KH);
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;

  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + kTile * D;
  float* v_s = k_s + kTile * DP;
  float* p_s = v_s + kTile * D;

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + kh * ks.h;
  const T* vb = v + b * vs.b + kh * vs.h;

  for (int i = tid; i < kTile * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int qpos = q0 + r;
    q_s[i] = qpos < Sq ? to_float(qb[qpos * qs.s + d]) * scale : 0.f;
  }

  // the kv range any row of this tile can see
  const int q_last = min(q0 + kTile, Sq) - 1;
  int k_lo = 0;
  int k_hi = Sk;
  if (causal) k_hi = min(Sk, q_last + 1);
  if (window) k_lo = max(0, q0 - window + 1) / kTile * kTile;

  float m[kRows], l[kRows], acc[kRows][DC];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = k_lo; k0 < k_hi; k0 += kTile) {
    __syncthreads();  // the previous tile is consumed; q is staged
    for (int i = tid; i < kTile * D; i += kThreads) {
      const int r = i / D, d = i % D;
      const int kpos = k0 + r;
      const bool in = kpos < Sk;
      k_s[r * DP + d] = in ? to_float(kb[kpos * ks.s + d]) : 0.f;
      v_s[r * D + d] = in ? to_float(vb[kpos * vs.s + d]) : 0.f;
    }
    __syncthreads();

    float s[kRows][4];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[kRows], kv[4];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = q_s[(ty + 16 * i) * D + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = k_s[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qpos = q0 + ty + 16 * i;
      bool vis[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        bool ok = qpos < Sq && kpos < Sk;
        if (causal) ok = ok && qpos >= kpos;
        if (window) ok = ok && qpos - kpos < window;
        vis[j] = ok;
        if (ok) mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // masked keys give exactly 0 (the Pallas kernel's exp(-1e30 - m));
        // a row with no visible key so far keeps l = 0 and acc = 0
        const float p = vis[j] ? expf(s[i][j] - m_new) : 0.f;
        p_s[(ty + 16 * i) * PP + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int t = 0; t < kTile; ++t) {
      float pv[kRows], vv[DC];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = p_s[(ty + 16 * i) * PP + t];
#pragma unroll
      for (int j = 0; j < DC; ++j) vv[j] = v_s[t * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < DC; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  T* ob = out + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DC; ++j)
      ob[qpos * os.s + tx + 16 * j] = from_float<T>(acc[i][j] * inv);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int H, int KH, int Sq, int Sk, Strides qs,
                   Strides ks, Strides vs, Strides os, int causal, int window,
                   float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes(D);
  auto kernel = flash_attention_kernel<T, D>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((Sq + kTile - 1) / kTile, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), H, KH, Sq, Sk, qs, ks,
      vs, os, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v,
                     void* out, int B, int H, int KH, int Sq, int Sk,
                     Strides qs, Strides ks, Strides vs, Strides os,
                     int causal, int window, float scale,
                     cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, out, B, H, KH, Sq, Sk, qs, ks, vs, os,
                           causal, window, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, out, B, H, KH, Sq, Sk, qs, ks, vs, os,
                           causal, window, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, B, H, KH, Sq, Sk, qs, ks, vs, os,
                            causal, window, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launch on ``stream``; returns cudaGetLastError() after the launch (0 on
// success).  dtype: 0 f32, 1 bf16 (q, k, v and out alike).  D is 16, 64 or
// 128.  Strides are in elements, in the order (b, h, s) for each of q, k,
// v and out; d is contiguous.  All pointers are device pointers.
int flash_attention_launch(int dtype, int D, const void* q, const void* k,
                           const void* v, void* out, int B, int H, int KH,
                           int Sq, int Sk, long long qsb, long long qsh,
                           long long qss, long long ksb, long long ksh,
                           long long kss, long long vsb, long long vsh,
                           long long vss, long long osb, long long osh,
                           long long oss, int causal, int window, float scale,
                           void* stream) {
  if (B <= 0 || Sq <= 0) return 0;
  if (KH <= 0 || H % KH != 0 || Sk <= 0 || window < 0 || H > 65535 ||
      B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss},
      os{osb, osh, oss};
  if (dtype == kF32)
    return (int)launch_d<float>(D, q, k, v, out, B, H, KH, Sq, Sk, qs, ks,
                                vs, os, causal, window, scale, s);
  if (dtype == kBF16)
    return (int)launch_d<__nv_bfloat16>(D, q, k, v, out, B, H, KH, Sq, Sk,
                                        qs, ks, vs, os, causal, window,
                                        scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

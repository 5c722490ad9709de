// Gradient of flash prefill attention (K2) for Hopper (sm_90a), bound to
// Python with ctypes.
//
// Replaces no Pallas kernel: the reference differentiates its jnp
// ``chunked_attention`` (repro/models/attention.py) with JAX's autodiff,
// and the port's counterpart of that function on the card is K2
// (flash_attention.cu).  So K2's gradient is a kernel too.  It computes,
// for q (B,H,Sq,D), k/v (B,KH,Sk,D), the forward's output o and the
// gradient do arriving at it (query head h reads kv head h / G):
//   P  = softmax over the visible keys of q.k^T / sqrt(D)   (recomputed)
//   dV = P^T.dO            dP = dO.V^T
//   dS = P * (dP - delta)  with delta = rowsum(dO * o)
//   dQ = dS.K / sqrt(D)    dK = dS^T.Q / sqrt(D)
// with the forward's masks (aligned top-left, also when Sq != Sk: causal
// keeps j <= i, a window keeps i - j < window), the G query heads of a kv
// head summed into its dK and dV, and 0 for a query row that sees no key
// (the forward defines its output as 0).  Inputs f32 or bf16, read
// through their (b, h, s) element strides with d contiguous; gradients in
// the inputs' dtype; all arithmetic in fp32 (expf, not __expf).
//
// What bounds it on an H100: operations.  Per visible (query, key) pair
// and query head it does five D-long products (S, dP, dV, dK, dQ: 10*D
// FLOPs, 2.5x the forward's 4*D) against a few bytes, and this design
// recomputes S twice more and dP once more (16*D executed).
//
// This first design is simple and deterministic (no atomics), on the
// CUDA cores in fp32, 256 threads a block as a 16 x 16 grid, 64-row
// tiles, rows padded to D + 1 floats in shared memory:
//   1. fa_bwd_prep_kernel, one block per (query tile, head, batch): each
//      row's log-sum-exp of the scaled scores (an online max and sum over
//      the visible key tiles, as the forward) and delta = rowsum(dO * o),
//      into two fp32 (B,H,Sq) scratch arrays;
//   2. fa_bwd_dkdv_kernel, one block per (key tile, kv head, batch): it
//      loops over the kv head's G query heads and over the query tiles
//      that can see its keys, recomputes P^T = exp(K.Q^T * scale - lse)
//      and dP^T = V.dO^T, accumulates dV += P^T.dO and dK += dS^T.Q in
//      registers, and writes each once;
//   3. fa_bwd_dq_kernel, one block per (query tile, head, batch): it loops
//      over the visible key tiles, recomputes P and dP, and accumulates
//      dQ += dS.K in registers.
// Tiles wholly outside the causal diagonal or the window are not visited.
// The tensor cores, and keeping P's recomputation to one pass, are later
// work (ROADMAP queue 2).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kTile = 64;       // query rows and keys of a tile
constexpr int kThreads = 256;   // 16 x 16
constexpr int kRows = kTile / 16;
constexpr int kPP = kTile + 1;  // padded row of a 64 x 64 fp32 tile

struct Strides {
  long long b, h, s;            // element strides; d is contiguous
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  float* lse;                   // (B,H,Sq) fp32 scratch
  float* delta;                 // (B,H,Sq) fp32 scratch
  Strides qs, ks, vs, os, dos, dqs, dks, dvs;
  int H, KH, Sq, Sk, causal, window;
  float scale;
};

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ bool visible(const Args& a, int i, int j) {
  bool ok = i < a.Sq && j < a.Sk;
  if (a.causal) ok = ok && i >= j;
  if (a.window) ok = ok && i - j < a.window;
  return ok;
}

// Stage rows [r0, r0 + kTile) of one head of a (B, heads, S, D) tensor into
// shared memory as fp32 rows of D + 1 floats; rows at or past S read 0.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* base,
                                          long long stride_s, int r0,
                                          int S) {
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int row = r0 + r;
    dst[r * (D + 1) + d] = row < S ? ld(base + row * stride_s + d) : 0.f;
  }
}

// Sum over the 16 lanes of a half warp (the tx of one ty).
__device__ __forceinline__ float sum16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float max16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// The key tiles a query tile [q0, q0 + kTile) can see: [x, y).
__device__ __forceinline__ int2 key_range(const Args& a, int q0) {
  const int q_last = min(q0 + kTile, a.Sq) - 1;
  return make_int2(a.window ? max(0, q0 - a.window + 1) / kTile * kTile : 0,
                   a.causal ? min(a.Sk, q_last + 1) : a.Sk);
}

// The query tiles that can see a key tile [k0, k0 + kTile): [x, y).
__device__ __forceinline__ int2 query_range(const Args& a, int k0) {
  const int k_last = min(k0 + kTile, a.Sk) - 1;
  return make_int2(a.causal ? k0 / kTile * kTile : 0,
                   a.window ? min(a.Sq, k_last + a.window) : a.Sq);
}

// ---------------------------------------------------------------------------
// 1. log-sum-exp and delta of each query row
// ---------------------------------------------------------------------------

__host__ __device__ constexpr int prep_smem(int D) {
  return (int)sizeof(float) * 2 * kTile * (D + 1);
}

template <int BF16, int D>
__global__ void __launch_bounds__(kThreads) fa_bwd_prep_kernel(Args a) {
  using T = typename std::conditional<BF16, __nv_bfloat16, float>::type;
  constexpr int DP = D + 1;
  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (a.H / a.KH);
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;

  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + kTile * DP;

  const T* qb = static_cast<const T*>(a.q) + b * a.qs.b + h * a.qs.h;
  const T* kb = static_cast<const T*>(a.k) + b * a.ks.b + kh * a.ks.h;
  const T* ob = static_cast<const T*>(a.o) + b * a.os.b + h * a.os.h;
  const T* dob = static_cast<const T*>(a.dout) + b * a.dos.b + h * a.dos.h;
  const long long row0 = ((long long)b * a.H + h) * a.Sq;

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty + 16 * i;
    float acc = 0.f;
    if (row < a.Sq) {
#pragma unroll
      for (int c = 0; c < D / 16; ++c) {
        const int d = tx + 16 * c;
        acc = fmaf(ld(dob + row * a.dos.s + d), ld(ob + row * a.os.s + d),
                   acc);
      }
    }
    acc = sum16(acc);
    if (tx == 0 && row < a.Sq) a.delta[row0 + row] = acc;
  }

  load_tile<T, D>(q_s, qb, a.qs.s, q0, a.Sq);
  const int2 kr = key_range(a, q0);
  float m[kRows], l[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }
  for (int k0 = kr.x; k0 < kr.y; k0 += kTile) {
    __syncthreads();  // the previous tile is consumed; q is staged
    load_tile<T, D>(k_s, kb, a.ks.s, k0, a.Sk);
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
      for (int i = 0; i < kRows; ++i) qv[i] = q_s[(ty + 16 * i) * DP + d];
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
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] *= a.scale;
        if (visible(a, qpos, k0 + tx + 16 * j)) mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], max16(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (visible(a, qpos, k0 + tx + 16 * j)) sum += expf(s[i][j] - m_new);
      l[i] = l[i] * expf(m[i] - m_new) + sum16(sum);
      m[i] = m_new;
    }
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty + 16 * i;
    // a row that sees no key keeps l = 0; its lse is never read
    if (tx == 0 && row < a.Sq)
      a.lse[row0 + row] = l[i] > 0.f ? m[i] + logf(l[i]) : 0.f;
  }
}

// ---------------------------------------------------------------------------
// 2. dK and dV of a key tile, 3. dQ of a query tile
// ---------------------------------------------------------------------------

// Shared memory (floats) of both: four tiles of kTile x (D + 1) (K, V and
// Q, dO), one kTile x (kTile + 1) tile of P or dS, and the tile's lse and
// delta.
__host__ __device__ constexpr int grad_smem(int D) {
  return (int)sizeof(float) * (4 * kTile * (D + 1) + kTile * kPP + 2 * kTile);
}

template <int BF16, int D>
__global__ void __launch_bounds__(kThreads) fa_bwd_dkdv_kernel(Args a) {
  using T = typename std::conditional<BF16, __nv_bfloat16, float>::type;
  constexpr int DP = D + 1;
  constexpr int DC = D / 16;    // accumulator columns per thread
  const int k0 = blockIdx.x * kTile;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = a.H / a.KH;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;

  extern __shared__ float smem[];
  float* k_s = smem;
  float* v_s = k_s + kTile * DP;
  float* q_s = v_s + kTile * DP;
  float* do_s = q_s + kTile * DP;
  float* p_s = do_s + kTile * DP;   // P^T, then dS^T: [key][query]
  float* lse_s = p_s + kTile * kPP;
  float* delta_s = lse_s + kTile;

  load_tile<T, D>(k_s, static_cast<const T*>(a.k) + b * a.ks.b + kh * a.ks.h,
                  a.ks.s, k0, a.Sk);
  load_tile<T, D>(v_s, static_cast<const T*>(a.v) + b * a.vs.b + kh * a.vs.h,
                  a.vs.s, k0, a.Sk);

  // this thread's keys ty + 16 i and dims tx + 16 c
  float dk[kRows][DC], dv[kRows][DC];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk[i][c] = dv[i][c] = 0.f;

  const int2 qr_range = query_range(a, k0);
  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    const T* qb = static_cast<const T*>(a.q) + b * a.qs.b + h * a.qs.h;
    const T* dob = static_cast<const T*>(a.dout) + b * a.dos.b + h * a.dos.h;
    const long long row0 = ((long long)b * a.H + h) * a.Sq;
    for (int q0 = qr_range.x; q0 < qr_range.y; q0 += kTile) {
      __syncthreads();  // the previous query tile is consumed
      load_tile<T, D>(q_s, qb, a.qs.s, q0, a.Sq);
      load_tile<T, D>(do_s, dob, a.dos.s, q0, a.Sq);
      for (int r = threadIdx.x; r < kTile; r += kThreads) {
        const bool in = q0 + r < a.Sq;
        lse_s[r] = in ? a.lse[row0 + q0 + r] : 0.f;
        delta_s[r] = in ? a.delta[row0 + q0 + r] : 0.f;
      }
      __syncthreads();

      // S^T and dP^T for keys ty + 16 i, queries tx + 16 j
      float s[kRows][4], dp[kRows][4];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float kv[kRows], vv[kRows], qv[4], dov[4];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          kv[i] = k_s[(ty + 16 * i) * DP + d];
          vv[i] = v_s[(ty + 16 * i) * DP + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qv[j] = q_s[(tx + 16 * j) * DP + d];
          dov[j] = do_s[(tx + 16 * j) * DP + d];
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
            dp[i][j] = fmaf(vv[i], dov[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qr = tx + 16 * j;
          s[i][j] = visible(a, q0 + qr, k0 + ty + 16 * i)
                        ? expf(s[i][j] * a.scale - lse_s[qr])
                        : 0.f;
          p_s[(ty + 16 * i) * kPP + qr] = s[i][j];
        }
      __syncthreads();
#pragma unroll 4
      for (int t = 0; t < kTile; ++t) {
        float pv[kRows], ov[DC];
#pragma unroll
        for (int i = 0; i < kRows; ++i) pv[i] = p_s[(ty + 16 * i) * kPP + t];
#pragma unroll
        for (int c = 0; c < DC; ++c) ov[c] = do_s[t * DP + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int c = 0; c < DC; ++c) dv[i][c] = fmaf(pv[i], ov[c], dv[i][c]);
      }
      __syncthreads();  // P^T is consumed; dS^T takes its place
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qr = tx + 16 * j;
          p_s[(ty + 16 * i) * kPP + qr] = s[i][j] * (dp[i][j] - delta_s[qr]);
        }
      __syncthreads();
#pragma unroll 4
      for (int t = 0; t < kTile; ++t) {
        float sv[kRows], qv[DC];
#pragma unroll
        for (int i = 0; i < kRows; ++i) sv[i] = p_s[(ty + 16 * i) * kPP + t];
#pragma unroll
        for (int c = 0; c < DC; ++c) qv[c] = q_s[t * DP + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int c = 0; c < DC; ++c) dk[i][c] = fmaf(sv[i], qv[c], dk[i][c]);
      }
    }
  }

  T* dkb = static_cast<T*>(a.dk) + b * a.dks.b + kh * a.dks.h;
  T* dvb = static_cast<T*>(a.dv) + b * a.dvs.b + kh * a.dvs.h;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int kpos = k0 + ty + 16 * i;
    if (kpos >= a.Sk) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      st(dkb + kpos * a.dks.s + tx + 16 * c, dk[i][c] * a.scale);
      st(dvb + kpos * a.dvs.s + tx + 16 * c, dv[i][c]);
    }
  }
}

// At most one block an SM asked for: with the bound on threads alone,
// ptxas held the D = 64 instances at 80 registers (three blocks an SM)
// and spilled.
template <int BF16, int D>
__global__ void __launch_bounds__(kThreads, 1) fa_bwd_dq_kernel(Args a) {
  using T = typename std::conditional<BF16, __nv_bfloat16, float>::type;
  constexpr int DP = D + 1;
  constexpr int DC = D / 16;
  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (a.H / a.KH);
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;

  extern __shared__ float smem[];
  float* k_s = smem;
  float* v_s = k_s + kTile * DP;
  float* q_s = v_s + kTile * DP;
  float* do_s = q_s + kTile * DP;
  float* ds_s = do_s + kTile * DP;  // dS: [query][key]
  float* lse_s = ds_s + kTile * kPP;
  float* delta_s = lse_s + kTile;

  const long long row0 = ((long long)b * a.H + h) * a.Sq;
  load_tile<T, D>(q_s, static_cast<const T*>(a.q) + b * a.qs.b + h * a.qs.h,
                  a.qs.s, q0, a.Sq);
  load_tile<T, D>(do_s,
                  static_cast<const T*>(a.dout) + b * a.dos.b + h * a.dos.h,
                  a.dos.s, q0, a.Sq);
  for (int r = threadIdx.x; r < kTile; r += kThreads) {
    const bool in = q0 + r < a.Sq;
    lse_s[r] = in ? a.lse[row0 + q0 + r] : 0.f;
    delta_s[r] = in ? a.delta[row0 + q0 + r] : 0.f;
  }
  const T* kb = static_cast<const T*>(a.k) + b * a.ks.b + kh * a.ks.h;
  const T* vb = static_cast<const T*>(a.v) + b * a.vs.b + kh * a.vs.h;

  // this thread's queries ty + 16 i and dims tx + 16 c
  float acc[kRows][DC];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;

  const int2 kr = key_range(a, q0);
  for (int k0 = kr.x; k0 < kr.y; k0 += kTile) {
    __syncthreads();  // the previous key tile is consumed; q, dO staged
    load_tile<T, D>(k_s, kb, a.ks.s, k0, a.Sk);
    load_tile<T, D>(v_s, vb, a.vs.s, k0, a.Sk);
    __syncthreads();

    // S and dP for queries ty + 16 i, keys tx + 16 j
    float s[kRows][4], dp[kRows][4];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[kRows], ov[kRows], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        qv[i] = q_s[(ty + 16 * i) * DP + d];
        ov[i] = do_s[(ty + 16 * i) * DP + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = k_s[(tx + 16 * j) * DP + d];
        vv[j] = v_s[(tx + 16 * j) * DP + d];
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qr = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kc = tx + 16 * j;
        const float p = visible(a, q0 + qr, k0 + kc)
                            ? expf(s[i][j] * a.scale - lse_s[qr])
                            : 0.f;
        ds_s[qr * kPP + kc] = p * (dp[i][j] - delta_s[qr]);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int t = 0; t < kTile; ++t) {
      float sv[kRows], kv[DC];
#pragma unroll
      for (int i = 0; i < kRows; ++i) sv[i] = ds_s[(ty + 16 * i) * kPP + t];
#pragma unroll
      for (int c = 0; c < DC; ++c) kv[c] = k_s[t * DP + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(sv[i], kv[c], acc[i][c]);
    }
  }

  T* dqb = static_cast<T*>(a.dq) + b * a.dqs.b + h * a.dqs.h;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= a.Sq) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      st(dqb + qpos * a.dqs.s + tx + 16 * c, acc[i][c] * a.scale);
  }
}

template <typename K>
cudaError_t launch_one(K kernel, dim3 grid, int smem, const Args& a,
                       cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int BF16, int D>
int launch(const Args& a, int B, cudaStream_t stream) {
  const int nq = (a.Sq + kTile - 1) / kTile;
  const int nk = (a.Sk + kTile - 1) / kTile;
  cudaError_t e = launch_one(fa_bwd_prep_kernel<BF16, D>, dim3(nq, a.H, B),
                             prep_smem(D), a, stream);
  if (e != cudaSuccess) return (int)e;
  e = launch_one(fa_bwd_dkdv_kernel<BF16, D>, dim3(nk, a.KH, B),
                 grad_smem(D), a, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)launch_one(fa_bwd_dq_kernel<BF16, D>, dim3(nq, a.H, B),
                         grad_smem(D), a, stream);
}

}  // namespace

extern "C" {

// Launches the three kernels on ``stream`` (prep, dK/dV, dQ) and returns 0
// on success, else the CUDA error code of the first launch refused.
// bf16 != 0: q, k, v, o, dout and the gradients are bf16, else f32.  D is
// 16, 64 or 128.  ``strides`` holds 24 element strides, (b, h, s) of q, k,
// v, o, dout, dq, dk and dv in that order (d is contiguous).  lse and
// delta are fp32 (B,H,Sq) scratch, contiguous.  Every pointer but
// ``strides`` is a device pointer.
int flash_attention_bwd_launch(int bf16, int D, const void* q, const void* k,
                               const void* v, const void* o,
                               const void* dout, void* dq, void* dk,
                               void* dv, void* lse, void* delta, int B,
                               int H, int KH, int Sq, int Sk,
                               const long long* strides, int causal,
                               int window, float scale, void* stream) {
  if (B <= 0 || Sq <= 0) return 0;
  if (KH <= 0 || H % KH != 0 || Sk <= 0 || window < 0 || H > 65535 ||
      B > 65535)
    return (int)cudaErrorInvalidValue;
  const long long* x = strides;
  Args a{q, k, v, o, dout, dq, dk, dv,
         static_cast<float*>(lse), static_cast<float*>(delta),
         Strides{x[0], x[1], x[2]}, Strides{x[3], x[4], x[5]},
         Strides{x[6], x[7], x[8]}, Strides{x[9], x[10], x[11]},
         Strides{x[12], x[13], x[14]}, Strides{x[15], x[16], x[17]},
         Strides{x[18], x[19], x[20]}, Strides{x[21], x[22], x[23]},
         H, KH, Sq, Sk, causal, window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D * 2 + (bf16 != 0)) {
    case 32: return launch<0, 16>(a, B, s);
    case 33: return launch<1, 16>(a, B, s);
    case 128: return launch<0, 64>(a, B, s);
    case 129: return launch<1, 64>(a, B, s);
    case 256: return launch<0, 128>(a, B, s);
    case 257: return launch<1, 128>(a, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Dynamic shared memory of one block of kernel 0 (prep), 1 (dK/dV) or 2
// (dQ) at head dim D, in bytes; 0 for a D without an instance.
int flash_attention_bwd_smem(int kernel, int D) {
  if (D != 16 && D != 64 && D != 128) return 0;
  return kernel == 0 ? prep_smem(D) : grad_smem(D);
}

const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

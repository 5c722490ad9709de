// Flash prefill attention for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the Pallas TPU kernel
//   repro/kernels/flash_attention/kernel.py::flash_attention  (body _kernel)
// and computes what it computes: blockwise attention of q (B,H,Sq,D) over
// k (B,KH,Sk,D) and v (B,KH,Sk,DV), query head h reading kv head h / G, with
// an fp32 online
// softmax (running max, denominator, accumulator) over the kv tiles in
// order; the scores are scaled by 1/sqrt(D) in fp32, the probabilities keep
// fp32 precision in the P.V product, and the denominator is clamped at
// 1e-30.  Masks are aligned top-left (query i and key j both count from 0,
// also when Sq != Sk): causal keeps j <= i, a window keeps i - j < window,
// keys at j >= Sk are masked and their V rows read as 0.  A query row that
// sees no key at all (only possible with a window and Sq > Sk + window - 1)
// yields 0; the Pallas kernel's output there depends on its tile size.
//
// Two kernels, chosen by dtype (a dispatch, not a fallback):
//
// bf16: flash_attention_tc_kernel, on the tensor cores.
//   What bounds it on an H100: operations.  Each visible (query, key) pair
//   costs 4*D FLOPs per query head (Q.K^T and P.V) against a few bytes per
//   pair, so at prefill lengths the least time is those FLOPs over the
//   tensor cores' 989 TFLOP/s (bf16).  Design:
//    * one CTA per (query head, batch, 128-row query tile), 384 threads:
//      warpgroup 0 is the producer (one thread issues every TMA load; the
//      group gives its registers away with setmaxnreg), warpgroups 1 and 2
//      are consumers, 64 query rows each, with 232 registers a thread.
//      D = 256 takes 256 threads instead (below);
//    * Q is loaded once by TMA; K and V tiles of 128 keys (64 at D = 128,
//      where 128 spill registers, and at D = 256) come through a 2-stage
//      ring in shared memory, loaded by cp.async.bulk.tensor and guarded
//      by full (TMA bytes arrived) and empty (8 consumer warps done)
//      mbarriers.  A wait that never ends traps instead of hanging.  The
//      tensor maps are built per call on the host from the element
//      strides, dims (D, S, heads, B), so the strided (B,S,H,D) views of
//      ops.flash_attention_bshd and slices of one fused qkv tensor need no
//      copy.  Rows past the end of the tensor arrive as zeros (V rows past
//      Sk read as 0); keys at j >= Sk are still masked, since a zero K row
//      scores 0, not -inf.  The maps' swizzle (128 B for D = 64, 128 and
//      256, 32 B for D = 16) is the one the wgmma descriptors name;
//    * S = Q.K^T is a bf16 wgmma (A and B from shared memory) into fp32
//      registers: bf16 products are exact in fp32.  1/sqrt(D) is applied
//      in fp32 after the product.  Running max, denominator and the O
//      accumulator stay fp32 in registers; exponentials are exp2 of
//      s * (log2(e)/sqrt(D)) - m, one FMA per element;
//    * P.V is TWO bf16 wgmmas into one fp32 accumulator, P_hi.V + P_lo.V
//      with P_hi = bf16(p) and P_lo = bf16(p - P_hi), P from registers (the
//      S accumulator's layout is the A fragment's), V read from shared
//      memory with the transpose bit.  Why the split: the Pallas kernel
//      keeps P in fp32 for P.V, and the port is held to one output ulp per
//      element (2**-7 * |plain| + 1e-5).  A model of this kernel's
//      arithmetic on bf16 randn inputs (B=1, H=KH=3, D=64, causal, 128-key
//      tiles) missed that bound by 47.7x, 65.5x and 98.6x at S = 511, 2048
//      and 4096 with P rounded to bf16 once, and met it (0.972, 0.965,
//      0.972 of the bound) with the split, as fp32 P does (0.776-0.965).
//      p - P_hi is exact in fp32 and P_lo keeps 8 more bits, so P_hi + P_lo
//      is within 2**-17 of p.  The split costs a third product: 6*D FLOPs
//      executed per visible pair instead of 4*D;
//    * tiles wholly past the causal diagonal or wholly before the window
//      are skipped; only tiles that cross a mask edge or Sk pay for the
//      per-element mask.  The query tiles are launched longest first
//      (blockIdx.z reversed, slowest grid axis), so the causal grid's long
//      tiles do not fall into the last wave;
//    * the epilogue divides by max(l, 1e-30), rounds once to bf16 (RNE) and
//      writes bf16 pairs through the output's strides.
//   D = 256 (gemma3) keeps all of that but the thread layout.  A 64-row
//   group's O accumulator alone is 128 fp32 registers a thread, S of a
//   64-key tile 32 more and P's hi and lo fragments 32: more than the 168
//   that a 384-thread launch allows a thread (an SM's registers are four
//   files of 16,384, and a ninth warp puts three warps on one of them).  So
//   the CTA is the two consumer warpgroups alone, 256 threads under a
//   255-register ceiling, as K2's backward is (flash_attention_bwd.cu):
//   thread 0 loads Q and the first two K/V tiles, then refills each stage
//   one step after both groups release it.  Shared memory: Q 64 KiB, the
//   2-stage ring of 64-key K and V tiles 128 KiB, 197,688 B with barriers
//   and alignment (128-key tiles would need ~320 KiB).  P.V is one
//   m64n256k16 wgmma per k-step and part (V read with the transpose bit
//   across its four 128-byte column blocks).
//
// Both kernels write, when given an ``lse`` array (training asks for it),
// each row's log-sum-exp in the log2 domain, ms + log2(l) in the tensor-
// core kernel's terms (+inf for a row that sees no key), for the backward
// (flash_attention_bwd.cu), which then recomputes no row sum; with a null
// pointer nothing else changes.
//
// f32: flash_attention_f32_kernel, on the CUDA cores (the first port's
//   design, kept for f32 inputs, which it matches to 1e-5): one block per
//   (64-row query tile, query head, batch), 256 threads as a 16 x 16 grid,
//   fp32 FMAs; K rows padded to D + 1 floats in shared memory (213,504 B
//   at D = 256, under the 232,448 B a block may opt into).
//
// Value dim.  Each instance pairs the query/key dim D with a value dim DV
// (template <int D, int DV>): (D, D) for D = 16, 64, 128 and 256, and
// (192, 128) for MLA (deepseek-v2: q/k of nope 128 + rope 64, v of 128;
// the scale stays 1/sqrt(D)).  Q.K^T walks D, the V tiles, P.V, the O
// accumulator and the output take DV.  The (192, 128) tensor-core instance
// keeps D = 128's layout (384 threads, a producer warpgroup, 64-key
// tiles): Q and K rows are three 128-byte swizzled parts of 64 columns
// (12 k-steps of 16), V rows two; shared memory Q 48 KiB + K ring 48 KiB
// + V ring 32 KiB; the P.V accumulator is 64 x 128 a consumer group, as
// at D = 128.  Its f32 instance holds 147,968 B of shared memory.
#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kTile = 64;       // query rows per block and keys per kv tile
constexpr int kThreads = 256;   // 16 x 16
constexpr int kRows = kTile / 16;

// Shared memory (floats) for head dims D and DV:
//   q  kTile*D        query tile, fp32, pre-scaled
//   k  kTile*(D+1)    key tile (padded rows)
//   v  kTile*DV       value tile
//   p  kTile*(kTile+1) probabilities of the tile
__host__ __device__ constexpr size_t smem_bytes(int D, int DV) {
  return sizeof(float) * (size_t)(kTile * D + kTile * (D + 1) + kTile * DV +
                                  kTile * (kTile + 1));
}

template <int D, int DV>
__global__ void __launch_bounds__(kThreads) flash_attention_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ out,
    float* __restrict__ lse, int H, int KH, int Sq, int Sk, Strides qs,
    Strides ks, Strides vs, Strides os, int causal, int window,
    float scale) {
  constexpr int DP = D + 1;
  constexpr int PP = kTile + 1;
  constexpr int DC = DV / 16;   // accumulator columns per thread
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
  float* p_s = v_s + kTile * DV;

  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + kh * ks.h;
  const float* vb = v + b * vs.b + kh * vs.h;

  for (int i = tid; i < kTile * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int qpos = q0 + r;
    q_s[i] = qpos < Sq ? qb[qpos * qs.s + d] * scale : 0.f;
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
      k_s[r * DP + d] = kpos < Sk ? kb[kpos * ks.s + d] : 0.f;
    }
    for (int i = tid; i < kTile * DV; i += kThreads) {
      const int r = i / DV, d = i % DV;
      const int kpos = k0 + r;
      v_s[r * DV + d] = kpos < Sk ? vb[kpos * vs.s + d] : 0.f;
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
      for (int j = 0; j < DC; ++j) vv[j] = v_s[t * DV + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < DC; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  float* ob = out + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DC; ++j)
      ob[qpos * os.s + tx + 16 * j] = acc[i][j] * inv;
    // log2 of the row's sum of exp(scaled score); +inf for a row that
    // sees no key (l = 0), so the backward's P = exp2(s - lse) is 0 there
    if (lse != nullptr && tx == 0)
      lse[((long long)b * H + h) * Sq + qpos] =
          l[i] > 0.f ? fmaf(m[i], tc::kLog2e, log2f(l[i])) : tc::inf();
  }
}

template <int D, int DV>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       void* out, float* lse, int B, int H, int KH, int Sq,
                       int Sk,
                       Strides qs, Strides ks, Strides vs, Strides os,
                       int causal, int window, float scale,
                       cudaStream_t stream) {
  constexpr size_t smem = smem_bytes(D, DV);
  auto kernel = flash_attention_f32_kernel<D, DV>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((Sq + kTile - 1) / kTile, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, H, KH, Sq,
      Sk, qs, ks, vs, os, causal, window, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (wgmma), fed by TMA
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kBM = 128;        // query rows per CTA, 64 per consumer group
constexpr int kStages = 2;      // K/V ring depth
constexpr int kConsumerWarps = 8;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;   // 128*40 + 256*232 <= 65536

// Per head dims (Q and K tile rows stored as hopper.cuh's Rows<D> says, V
// tile rows as Rows<DV>):
template <int D, int DV>
struct Cfg : Rows<D> {
  using R = Rows<D>;
  using RV = Rows<DV>;
  // D = 256 has no producer warpgroup: its two consumer groups' thread 0
  // keeps the ring full (kSelfFed), so a thread may hold 255 registers
  static constexpr bool kSelfFed = D == 256;
  static constexpr int kThreads = kSelfFed ? 256 : 384;
  // keys per kv tile; at D = 128, 128-key tiles spill registers (ptxas
  // gives every instance of a 384-thread launch 168), so that instance
  // takes 64, as does D = 256, whose 128-key ring would not fit
  static constexpr int kBN = D >= 128 ? 64 : 128;
  static constexpr int kPartQ = kBM * R::kRowBytes;
  static constexpr int kPartK = kBN * R::kRowBytes;
  static constexpr int kPartV = kBN * RV::kRowBytes;
  static constexpr int kQBytes = kBM * D * 2;
  static constexpr int kKBytes = kBN * D * 2;
  static constexpr int kVBytes = kBN * DV * 2;
  static constexpr int kK = kQBytes;               // offsets from the base
  static constexpr int kV = kK + kStages * kKBytes;
  static constexpr int kBar = kV + kStages * kVBytes;
  // barriers: q_full, full_k[stages], full_v[stages], empty[stages]
  static constexpr int kSmem = kBar + 8 * (1 + 3 * kStages) + 1024;  // + align
};

// Where the K/V ring's tiles come from: the kv head's maps and coordinates.
struct Feed {
  const CUtensorMap* tk;
  const CUtensorMap* tv;
  int kh, b, k_lo;
};

// Ring step i (the K and V tiles from key k_lo + i * BN) into stage
// i % kStages, by one thread once the stage is released.
template <int D, int DV>
__device__ __forceinline__ void fill(const Feed& f, uint32_t sk, uint32_t sv,
                                     uint32_t bar, int i) {
  using C = Cfg<D, DV>;
  const uint32_t full_k = bar + 8, full_v = full_k + 8 * kStages,
                 empty = full_v + 8 * kStages;
  const int st = i % kStages;
  const uint32_t ph = (i / kStages) & 1;
  const int k0 = f.k_lo + i * C::kBN;
  mbar_wait(empty + 8 * st, ph ^ 1);   // the first round passes
  mbar_expect_tx(full_k + 8 * st, C::kKBytes);
  for (int p = 0; p < C::kParts; ++p)
    tma_load(sk + st * C::kKBytes + p * C::kPartK, f.tk, p * C::kCols, k0,
             f.kh, f.b, full_k + 8 * st);
  mbar_expect_tx(full_v + 8 * st, C::kVBytes);
  for (int p = 0; p < C::RV::kParts; ++p)
    tma_load(sv + st * C::kVBytes + p * C::kPartV, f.tv, p * C::RV::kCols,
             k0, f.kh, f.b, full_v + 8 * st);
}

// The CTA's query tile, loaded once.
template <int D, int DV>
__device__ __forceinline__ void load_q(const CUtensorMap* tq, uint32_t sq,
                                       uint32_t q_full, int q0, int h, int b) {
  using C = Cfg<D, DV>;
  mbar_expect_tx(q_full, C::kQBytes);
  for (int p = 0; p < C::kParts; ++p)
    tma_load(sq + p * C::kPartQ, tq, p * C::kCols, q0, h, b, q_full);
}

// One consumer warpgroup: 64 query rows [row0_g, row0_g + 64) of the CTA's
// tile against the n_tiles kv tiles from k_lo.  Thread layout of the wgmma
// accumulators (64 x N): warp w of the group holds rows 16w + lane/4 and
// 16w + lane/4 + 8; register 4j + e holds column 8j + 2*(lane%4) + (e&1) of
// the first row (e < 2) or the second (e >= 2).  Self-fed (D = 256), the
// CTA's thread 0 also refills the ring: each stage one step after its
// release, so the next tile is in flight while this one is computed.
template <int D, int DV>
__device__ __forceinline__ void consume(
    uint32_t sq, uint32_t sk, uint32_t sv, uint32_t bar, int g,
    __nv_bfloat16* __restrict__ ob, long long oss, float* __restrict__ lse,
    int Sq, int Sk, int q0, int k_lo, int n_tiles, int causal, int window,
    float scale, const Feed& feed) {
  using C = Cfg<D, DV>;
  constexpr int BN = C::kBN;
  const uint32_t q_full = bar, full_k = bar + 8, full_v = full_k + 8 * kStages,
                 empty = full_v + 8 * kStages;
  const int lane = threadIdx.x % 32;
  const int w = (threadIdx.x / 32) % 4;
  const int wr_lo = q0 + 64 * g;           // this group's rows
  const int wr_hi = wr_lo + 63;
  const int r0 = wr_lo + 16 * w + lane / 4;  // this thread's rows r0, r0 + 8
  const int c2 = 2 * (lane % 4);
  const float sc = scale * kLog2e;

  float o[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};   // running max of the raw scores
  float ms[2] = {0.f, 0.f};          // m * sc as used in the exponents
  float l[2] = {0.f, 0.f};           // this thread's part of the row sums

  if (n_tiles > 0) mbar_wait(q_full, 0);
  const uint32_t qa = sq + g * 64 * C::kRowBytes;
  for (int i = 0; i < n_tiles; ++i) {
    if constexpr (C::kSelfFed) {
      // refill the stage step i - 1 released (both groups are past it soon)
      if (threadIdx.x == 0 && i >= 1 && i - 1 + kStages < n_tiles)
        fill<D, DV>(feed, sk, sv, bar, i - 1 + kStages);
      __syncwarp();
    }
    const int st = i % kStages;
    const uint32_t ph = (i / kStages) & 1;
    const int k0 = k_lo + i * BN;
    const uint32_t ka = sk + st * C::kKBytes, va = sv + st * C::kVBytes;

    // S = Q K^T (64 x BN), fp32
    float s[BN / 2];
    mbar_wait(full_k + 8 * st, ph);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint64_t qd = kmajor<D>(qa, C::kPartQ, kk);
      const uint64_t kd = kmajor<D>(ka, C::kPartK, kk);
      if (kk == 0)
        Mma<BN>::template ss<true>(s, qd, kd);
      else
        Mma<BN>::template ss<false>(s, qd, kd);
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs(s);

    // masks: only tiles that cross Sk, the diagonal or the window's edge
    const bool whole = k0 + BN <= Sk && (!causal || k0 + BN - 1 <= wr_lo) &&
                       (!window || wr_hi - k0 < window);
    if (!whole) {
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) {
        const int row = r0 + ((e & 2) ? 8 : 0);
        const int col = k0 + 8 * (e / 4) + c2 + (e & 1);
        bool vis = col < Sk;
        if (causal) vis = vis && col <= row;
        if (window) vis = vis && row - col < window;
        if (!vis) s[e] = kNegInf;
      }
    }

    // online softmax, fp32; a quad of lanes shares each row
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int e = 0; e < BN / 2; ++e)
      mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], s[e]);
    float corr[2], mu[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      // a row with no visible key yet keeps m = -1e30: its exponents use
      // 0, so masked keys still give exactly 0
      mu[r] = m_new == kNegInf ? 0.f : m_new * sc;
      corr[r] = m[r] == kNegInf ? 1.f : ex2(ms[r] - mu[r]);
      m[r] = m_new;
      ms[r] = mu[r];
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) {
      const int r = (e >> 1) & 1;
      s[e] = ex2(fmaf(s[e], sc, -mu[r]));
      sum[r] += s[e];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + sum[r];
#pragma unroll
    for (int e = 0; e < DV / 2; ++e) o[e] *= corr[(e >> 1) & 1];

    // P = P_hi + P_lo as bf16 A fragments
    uint32_t phi[BN / 16][4], plo[BN / 16][4];
    split_frags(s, phi, plo);

    // O += P_hi V + P_lo V (64 x DV), fp32
    mbar_wait(full_v + 8 * st, ph);
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < BN / 16; ++t) {
      const uint64_t vd = mnmajor<DV>(va, C::kPartV, t);
      Mma<DV>::rs(o, phi[t], vd);
      Mma<DV>::rs(o, plo[t], vd);
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs(o);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * st);
  }

  // epilogue: full row sums, one division and one bf16 rounding; with
  // ``lse``, each row's log2-domain log-sum-exp ms + log2(l) (+inf for a
  // row that sees no key, l = 0: the backward's P = exp2(s - lse) is 0)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = r0 + 8 * r;
    if (lse != nullptr && c2 == 0 && row < Sq)
      lse[row] = l[r] > 0.f ? ms[r] + log2f(l[r]) : inf();
    l[r] = fmaxf(l[r], 1e-30f);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= Sq) continue;
    __nv_bfloat16* orow = ob + row * oss + c2;
#pragma unroll
    for (int j = 0; j < DV / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          __floats2bfloat162_rn(o[4 * j + 2 * r] / l[r],
                                o[4 * j + 2 * r + 1] / l[r]);
  }
}

template <int D, int DV>
__global__ void __launch_bounds__(Cfg<D, DV>::kThreads, 1)
    flash_attention_tc_kernel(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ out,
    float* __restrict__ lse, Strides os, int H, int KH, int Sq, int Sk,
    int causal, int window, float scale) {
  using C = Cfg<D, DV>;
  constexpr int BN = C::kBN;
  extern __shared__ uint8_t smem_raw[];
  // 1024-byte alignment: the swizzle pattern repeats every 1024 bytes and
  // the wgmma descriptors assume tiles that start on it
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t sq = base, sk = base + C::kK, sv = base + C::kV,
                 bar = base + C::kBar;
  const uint32_t q_full = bar, full_k = bar + 8, full_v = full_k + 8 * kStages,
                 empty = full_v + 8 * kStages;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBM;   // longest tiles first
  const int kh = h / (H / KH);
  // the kv range any row of this tile can see
  const int q_last = min(q0 + kBM, Sq) - 1;
  int k_lo = 0;
  int k_hi = Sk;
  if (causal) k_hi = min(Sk, q_last + 1);
  if (window) k_lo = max(0, q0 - window + 1) / BN * BN;
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + BN - 1) / BN : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full_k + 8 * st, 1);
      mbar_init(full_v + 8 * st, 1);
      mbar_init(empty + 8 * st, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const Feed feed{&tk, &tv, kh, b, k_lo};
  __nv_bfloat16* ob = out + b * os.b + h * os.h;
  float* lrow = lse == nullptr ? nullptr : lse + ((long long)b * H + h) * Sq;
  if constexpr (C::kSelfFed) {
    // two consumer groups; thread 0 loads Q and the ring's first kStages
    // tiles, then refills the ring between its own tiles
    if (threadIdx.x == 0 && n_tiles > 0) {
      load_q<D, DV>(&tq, sq, q_full, q0, h, b);
      for (int i = 0; i < kStages && i < n_tiles; ++i)
        fill<D, DV>(feed, sk, sv, bar, i);
    }
    __syncwarp();
    consume<D, DV>(sq, sk, sv, bar, threadIdx.x / 128, ob, os.s, lrow, Sq,
                   Sk, q0, k_lo, n_tiles, causal, window, scale, feed);
  } else if (threadIdx.x < 128) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (threadIdx.x == 0 && n_tiles > 0) {
      load_q<D, DV>(&tq, sq, q_full, q0, h, b);
      for (int i = 0; i < n_tiles; ++i) fill<D, DV>(feed, sk, sv, bar, i);
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    consume<D, DV>(sq, sk, sv, bar, threadIdx.x / 128 - 1, ob, os.s, lrow,
                   Sq, Sk, q0, k_lo, n_tiles, causal, window, scale, feed);
  }
}

template <int D, int DV>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int B, int H, int KH, int Sq, int Sk, Strides qs,
           Strides ks, Strides vs, Strides os, int causal, int window,
           float scale, cudaStream_t stream) {
  using C = Cfg<D, DV>;
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, q, D, C::kCols, Sq, H, B, qs, kBM) ||
      !make_map(&mk, k, D, C::kCols, Sk, KH, B, ks, C::kBN) ||
      !make_map(&mv, v, DV, C::RV::kCols, Sk, KH, B, vs, C::kBN))
    return kErrTensorMap;
  auto kernel = flash_attention_tc_kernel<D, DV>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(H, B, (Sq + kBM - 1) / kBM);
  kernel<<<grid, C::kThreads, C::kSmem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(out), lse, os, H, KH, Sq, Sk,
      causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace tc

// the (D, DV) instances, as X(D, DV)
#define FA_INSTANCES(X) X(16, 16) X(64, 64) X(128, 128) X(256, 256) X(192, 128)

bool bad_shape(int B, int H, int KH, int Sk, int window) {
  return KH <= 0 || H % KH != 0 || Sk <= 0 || window < 0 || H > 65535 ||
         B > 65535;
}

}  // namespace

extern "C" {

// Both entry points launch on ``stream`` and return 0 on success, else a
// CUDA error code (cudaGetLastError() after the launch) or -1 when the
// tensor maps cannot be built.  (D, DV) is (16, 16), (64, 64), (128, 128),
// (256, 256) or (192, 128) (FA_INSTANCES).  Strides are in
// elements, in the order (b, h, s) for each of q, k, v and out; d is
// contiguous.  ``lse`` is null or a contiguous fp32 (B,H,Sq) array that
// receives each query row's log2(sum_j exp2(q.k_j * scale * log2(e))) over
// its visible keys, +inf for a row that sees none.  All pointers are
// device pointers.

// f32 q, k, v and out: the CUDA-core kernel.
int flash_attention_f32_launch(int D, int DV, const void* q, const void* k,
                               const void* v, void* out, void* lse, int B,
                               int H, int KH, int Sq, int Sk, long long qsb,
                               long long qsh, long long qss, long long ksb,
                               long long ksh, long long kss, long long vsb,
                               long long vsh, long long vss, long long osb,
                               long long osh, long long oss, int causal,
                               int window, float scale, void* stream) {
  if (B <= 0 || Sq <= 0) return 0;
  if (bad_shape(B, H, KH, Sk, window)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss},
      os{osb, osh, oss};
  float* l2 = static_cast<float*>(lse);
#define ARGS q, k, v, out, l2, B, H, KH, Sq, Sk, qs, ks, vs, os, causal, \
             window, scale, s
#define CASE(d, dv) \
  if (D == d && DV == dv) return (int)launch_f32<d, dv>(ARGS);
  FA_INSTANCES(CASE)
#undef CASE
  return (int)cudaErrorInvalidValue;
}

// bf16 q, k, v and out: the tensor-core kernel.  q, k and v are read by
// TMA: 16-byte aligned bases, strides that are multiples of 16 bytes
// (the wrapper checks both); out is written in bf16 pairs.
int flash_attention_tc_launch(int D, int DV, const void* q, const void* k,
                              const void* v, void* out, void* lse, int B,
                              int H, int KH, int Sq, int Sk, long long qsb,
                              long long qsh, long long qss, long long ksb,
                              long long ksh, long long kss, long long vsb,
                              long long vsh, long long vss, long long osb,
                              long long osh, long long oss, int causal,
                              int window, float scale, void* stream) {
  if (B <= 0 || Sq <= 0) return 0;
  if (bad_shape(B, H, KH, Sk, window) || (Sq + tc::kBM - 1) / tc::kBM > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss},
      os{osb, osh, oss};
  float* l2 = static_cast<float*>(lse);
#define CASE(d, dv) \
  if (D == d && DV == dv) return tc::launch<d, dv>(ARGS);
  FA_INSTANCES(CASE)
#undef CASE
  return (int)cudaErrorInvalidValue;
#undef ARGS
}

// Dynamic shared memory of one block, in bytes: the tensor-core kernel
// (tc != 0) or the f32 one, at head dims (D, DV); 0 for a pair without an
// instance.
int flash_attention_smem(int tc, int D, int DV) {
#define CASE(d, dv)                                                  \
  if (D == d && DV == dv)                                            \
    return tc ? tc::Cfg<d, dv>::kSmem : (int)smem_bytes(d, dv);
  FA_INSTANCES(CASE)
#undef CASE
  return 0;
}

const char* flash_attention_error_string(int code) {
  if (code == tc::kErrTensorMap)
    return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

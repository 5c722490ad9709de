// Gradient of flash prefill attention (K2) for Hopper (sm_90a), bound to
// Python with ctypes.
//
// Replaces no Pallas kernel: the reference differentiates its jnp
// ``chunked_attention`` (repro/models/attention.py) with JAX's autodiff,
// and the port's counterpart of that function on the card is K2
// (flash_attention.cu).  So K2's gradient is a kernel too.  It computes,
// for q (B,H,Sq,D), k/v (B,KH,Sk,D), the forward's output o, the gradient
// do arriving at it and the forward's per-row log-sum-exp lse (query head
// h reads kv head h / G; sc = log2(e) / sqrt(D)):
//   P  = exp2(q.k^T * sc - lse)  over the visible keys, else 0
//   dV = P^T.dO            dP = dO.V^T
//   dS = P * (dP - delta)  with delta = rowsum(dO * o)
//   dQ = dS.K / sqrt(D)    dK = dS^T.Q / sqrt(D)
// with the forward's masks (aligned top-left, also when Sq != Sk: causal
// keeps j <= i, a window keeps i - j < window), the G query heads of a kv
// head summed into its dK and dV, and 0 for a query row that sees no key
// (the forward writes lse = +inf there, so its P is 0).  Gradients in the
// inputs' dtype, every sum in fp32.  No atomics: every gradient element is
// owned by one thread and summed in a fixed order, so two calls on the
// same inputs give the same bits (training's remat "none" and "full"
// depend on it).
//
// What bounds it on an H100.  Per visible (query, key) pair and query head
// it needs five D-long products (S, dP, dV, dK, dQ: 10*D FLOPs, 2.5x the
// forward's 4*D) against 4 q-sized and 4 k-sized tensors moved once.  So
// it is bound by operations from S ~ 2048 on (S = 4096, D = 64: 0.0814 ms
// at 989 TFLOP/s in bf16) and by bytes at the training shape (B=8, H=15,
// KH=5, S=512, D=64: 0.0125 ms at 3.35 TB/s).  The first design (fp32 on
// the CUDA cores) reached 0.3-1.2% of that; three limits held it back, and
// this design answers each:
//   * no tensor cores: bf16 inputs now take two kernels whose products are
//     bf16 wgmmas into fp32 registers, fed by TMA (below); f32 inputs keep
//     the CUDA-core kernels (fp32 FMAs, 64-row tiles, rows padded to D + 1
//     floats in shared memory), as the forward keeps its f32 kernel;
//   * P computed three times: a prep pass recomputed every score for each
//     row's log-sum-exp.  The forward now writes it (its ``lse`` output),
//     and the first kernel only sums delta = rowsum(dO * o) in fp32, a
//     bytes-bound pass with 16-byte loads;
//   * too few blocks and no overlap: the CUDA-core kernels stage tiles
//     synchronously.  The tensor-core kernels keep a 3-stage TMA ring in
//     flight while two warpgroups compute, and give dQ its own grid of
//     (query tile, query head, batch) CTAs.
//
// Why P and dS are split.  The backward is held to 2**-7 * |plain| +
// 2**-10 * max|plain| + 1e-5 per element in bf16.  A CPU model of this
// arithmetic (fp32 lse and P, fp32 sums) gave worst err/limit on dq / dk
// / dv, bf16 randn inputs, causal: with P and dS each rounded once to bf16,
// 1.76 / 1.16 / 0.85 (B=1, H=15, KH=5, S=511, D=64), 1.33 / 1.52 / 1.17
// (B=2, H=6, KH=2, S=512, D=64), 0.73 / 1.27 / 1.05 (B=1, H=4, KH=1,
// S=2048, D=128); with both split into bf16 hi + lo (hi = bf16(x), lo =
// bf16(x - hi), within 2**-17 of x) 0.40 / 0.35 / 0.33, 0.44 / 0.39 / 0.50
// and 0.48 / 0.27 / 0.26.  So P in dV, and dS in dK and dQ, are each two
// bf16 products into one fp32 accumulator, as the forward splits P in P.V
// (tests/test_torch_flash_attention_bwd_tc.py holds the model).
//
// bf16 kernels, 256 threads: two warpgroups of 64 rows each; warp 0
// issues every TMA load into mbarrier-guarded stages (full: TMA bytes and
// warp 0's arrivals; empty: the 8 warps), refilling a stage one step after
// it is released, so two stages stay in flight; a wait that never ends
// traps.  The tensor maps and their stride rules are the forward's
// (hopper.cuh; ``tma_strides``).
//   1. fa_bwd_delta_kernel: delta per query row.
//   2. fa_bwd_dkdv_tc_kernel<D>, one CTA per (128-key tile, kv head,
//      batch; 64 keys at D = 256, below), key tiles of the most work
//      first: K and V loaded once; the ring brings the Q and dO tiles
//      (64 queries, 32 at D = 128, where 64
//      leave too few registers for the two D-wide accumulators) of each of
//      the kv head's G query heads that see the keys, with their lse and
//      delta.  Per tile and consumer: S^T = K.Q^T and dP^T = V.dO^T (both
//      operands from shared memory); P^T = exp2(S^T * sc - lse) in fp32
//      registers, masked only on tiles that cross a mask edge, Sq or Sk;
//      dV += P^T_hi.dO + P^T_lo.dO (P^T from registers, dO read with the
//      transpose bit); dS^T = P^T * (dP^T - delta); dK += dS^T_hi.Q +
//      dS^T_lo.Q.  dK and dV stay in fp32 registers over all G heads and
//      are written once; 1/sqrt(D) is applied to dK in fp32 at the end.
//   3. fa_bwd_dq_tc_kernel<D>, one CTA per (128-row query tile, query
//      head, batch), longest causal tiles first: Q and dO loaded once, the
//      ring brings 64-key K and V tiles; S and dP recomputed, dQ += dS_hi.K
//      + dS_lo.K in fp32 registers, scaled and written once.
// Executed work is 20*D FLOPs a visible pair against the 10*D the bound
// counts: S and dP twice (once per kernel) and dV, dK and dQ split in two.
// Consumers skip tiles wholly masked for their 64 rows.  Ordered dQ
// accumulation across key tiles (FA3's) would drop one recomputation; it
// is later work, since unordered atomics would break determinism.
//
// D = 256 (gemma3's training) has its own layouts, since the ones above
// overrun both limits of a block there (232,448 B of shared memory, 255
// registers a thread):
//   * dK/dV: K and V of 128 keys are 128 KiB and a ring stage of 64-row Q
//     and dO tiles 64 KiB (~320 KiB in all), and one group's dK and dV
//     for 64 keys are 2 x 128 fp32 registers a thread before S, P or dP
//     are counted.  Of the candidates (split the work between the groups;
//     split D between two CTAs, each recomputing S^T and dP^T at full D;
//     32-key tiles, which wgmma's 64-row M does not map onto) the first
//     is taken: it computes nothing twice.  A CTA owns one 64-key tile (K
//     and V 64 KiB, a 2-stage ring 130 KiB, P^T 16 KiB: 216,104 B), and
//     both groups walk the same ring: group 0 computes S^T, P^T and dV,
//     group 1 dP^T, dS^T and dK, each with one 128-register accumulator;
//     P^T goes from group 0 to group 1 through shared memory in fp32,
//     guarded by two named barriers (dkdv_split_consume).  The work of a
//     step is balanced: one 64 x 64 x 256 product and two split ones each;
//   * dQ: the layout above with 32-key K and V tiles (three stages of 32
//     KiB beside Q and dO's 128 KiB: 230,456 B).  Its dQ accumulator is
//     the forward's O at D = 256, 128 registers, with S and dP of a 32-key
//     tile 16 each;
//   * f32: the CUDA-core kernels with 32-row tiles (four 64-row tiles of
//     D + 1 floats would take 263,168 B; 32-row ones take 136,064 B), and
//     the delta kernel with two 16-byte loads a thread.
// All three keep the rules above: no atomics, a fixed summation order,
// P and dS split into hi and lo parts.
#include "hopper.cuh"

#include <type_traits>

namespace {

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  const float* lse;             // (B,H,Sq) fp32, from the forward
  float* delta;                 // (B,H,Sq) fp32 scratch
  Strides qs, ks, vs, os, dos, dqs, dks, dvs;
  int H, KH, Sq, Sk, causal, window;
  float scale;
};

__device__ __forceinline__ bool visible(const Args& a, int i, int j) {
  bool ok = i < a.Sq && j < a.Sk;
  if (a.causal) ok = ok && i >= j;
  if (a.window) ok = ok && i - j < a.window;
  return ok;
}

// ---------------------------------------------------------------------------
// 1. delta = rowsum(dO * o), fp32, 16-byte loads
// ---------------------------------------------------------------------------

constexpr int kDeltaThreads = 256;

template <int BF16, int D>
struct DeltaCfg {
  static constexpr int kElems = BF16 ? 8 : 4;       // per 16-byte load
  // threads per row (at most a warp: the sum is a warp shuffle) and the
  // 16-byte loads of each (2 at D = 256 in f32)
  static constexpr int kLanes = D / kElems < 32 ? D / kElems : 32;
  static constexpr int kLoads = D / kElems / kLanes;
};

// the dot product of two 16-byte vectors of f32 (4) or bf16 (8) values
template <int BF16>
__device__ __forceinline__ float dot16(uint4 x, uint4 y) {
  const uint32_t xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (BF16) {
      const float2 a = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&xs[i]));
      const float2 b = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&ys[i]));
      acc = fmaf(a.x, b.x, acc);
      acc = fmaf(a.y, b.y, acc);
    } else {
      acc = fmaf(__uint_as_float(xs[i]), __uint_as_float(ys[i]), acc);
    }
  }
  return acc;
}

template <int BF16, int D>
__global__ void __launch_bounds__(kDeltaThreads) fa_bwd_delta_kernel(
    Args a, long long rows) {
  using T = typename std::conditional<BF16, __nv_bfloat16, float>::type;
  using C = DeltaCfg<BF16, D>;
  const long long row =
      ((long long)blockIdx.x * kDeltaThreads + threadIdx.x) / C::kLanes;
  const int part = threadIdx.x % C::kLanes;
  float acc = 0.f;
  if (row < rows) {
    const int i = (int)(row % a.Sq);
    const long long bh = row / a.Sq;
    const int h = (int)(bh % a.H), b = (int)(bh / a.H);
    const T* o = static_cast<const T*>(a.o) + b * a.os.b + h * a.os.h +
                 i * a.os.s + part * C::kElems;
    const T* d = static_cast<const T*>(a.dout) + b * a.dos.b +
                 h * a.dos.h + i * a.dos.s + part * C::kElems;
    acc = dot16<BF16>(__ldg(reinterpret_cast<const uint4*>(d)),
                      __ldg(reinterpret_cast<const uint4*>(o)));
#pragma unroll
    for (int l = 1; l < C::kLoads; ++l) {
      const int off = l * C::kLanes * C::kElems;
      acc += dot16<BF16>(__ldg(reinterpret_cast<const uint4*>(d + off)),
                         __ldg(reinterpret_cast<const uint4*>(o + off)));
    }
  }
#pragma unroll
  for (int off = C::kLanes / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (part == 0 && row < rows) a.delta[row] = acc;
}

// ---------------------------------------------------------------------------
// 2-3. f32: dK/dV per key tile and dQ per query tile on the CUDA cores
// ---------------------------------------------------------------------------

// Query rows and keys of a tile: 64, and 32 at D = 256, where four 64-row
// tiles of D + 1 floats alone would take 263,168 B of shared memory (the
// 32-row instance takes 136,064 B).  Each thread of the 16 x 16 grid holds
// f32_tile(D) / 16 rows of a tile.
__host__ __device__ constexpr int f32_tile(int D) {
  return D == 256 ? 32 : 64;
}
constexpr int kThreads = 256;   // 16 x 16

// Stage rows [r0, r0 + f32_tile(D)) of one head of a (B, heads, S, D)
// tensor into shared memory as fp32 rows of D + 1 floats; rows at or past
// S read 0.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* base,
                                          long long stride_s, int r0,
                                          int S) {
  for (int i = threadIdx.x; i < f32_tile(D) * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int row = r0 + r;
    dst[r * (D + 1) + d] = row < S ? base[row * stride_s + d] : 0.f;
  }
}

// The key tiles a query tile [q0, q0 + n) can see: [x, y).
__device__ __forceinline__ int2 key_range(const Args& a, int q0, int n,
                                          int align) {
  const int q_last = min(q0 + n, a.Sq) - 1;
  return make_int2(a.window ? max(0, q0 - a.window + 1) / align * align : 0,
                   a.causal ? min(a.Sk, q_last + 1) : a.Sk);
}

// The query tiles that can see a key tile [k0, k0 + n): [x, y).
__device__ __forceinline__ int2 query_range(const Args& a, int k0, int n,
                                            int align) {
  const int k_last = min(k0 + n, a.Sk) - 1;
  return make_int2(a.causal ? k0 / align * align : 0,
                   a.window ? min(a.Sq, k_last + a.window) : a.Sq);
}

// Shared memory (floats) of both: four tiles of T x (D + 1) (K, V and Q,
// dO), one T x (T + 1) tile of P or dS, and the tile's lse and delta, T =
// f32_tile(D).
__host__ __device__ constexpr int f32_smem(int D) {
  return (int)sizeof(float) * (4 * f32_tile(D) * (D + 1) +
                               f32_tile(D) * (f32_tile(D) + 1) +
                               2 * f32_tile(D));
}

template <int D>
__global__ void __launch_bounds__(kThreads) fa_bwd_dkdv_f32_kernel(Args a) {
  constexpr int kTile = f32_tile(D);
  constexpr int kRows = kTile / 16;   // rows (and columns) a thread holds
  constexpr int kPP = kTile + 1;      // padded row of the P / dS tile
  constexpr int DP = D + 1;
  constexpr int DC = D / 16;    // accumulator columns per thread
  const int k0 = blockIdx.x * kTile;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = a.H / a.KH;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const float sl2 = a.scale * tc::kLog2e;

  extern __shared__ float smem[];
  float* k_s = smem;
  float* v_s = k_s + kTile * DP;
  float* q_s = v_s + kTile * DP;
  float* do_s = q_s + kTile * DP;
  float* p_s = do_s + kTile * DP;   // P^T, then dS^T: [key][query]
  float* lse_s = p_s + kTile * kPP;
  float* delta_s = lse_s + kTile;

  load_tile<D>(k_s, static_cast<const float*>(a.k) + b * a.ks.b +
                        kh * a.ks.h, a.ks.s, k0, a.Sk);
  load_tile<D>(v_s, static_cast<const float*>(a.v) + b * a.vs.b +
                        kh * a.vs.h, a.vs.s, k0, a.Sk);

  // this thread's keys ty + 16 i and dims tx + 16 c
  float dk[kRows][DC], dv[kRows][DC];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk[i][c] = dv[i][c] = 0.f;

  const int2 qr_range = query_range(a, k0, kTile, kTile);
  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    const float* qb = static_cast<const float*>(a.q) + b * a.qs.b +
                      h * a.qs.h;
    const float* dob = static_cast<const float*>(a.dout) + b * a.dos.b +
                       h * a.dos.h;
    const long long row0 = ((long long)b * a.H + h) * a.Sq;
    for (int q0 = qr_range.x; q0 < qr_range.y; q0 += kTile) {
      __syncthreads();  // the previous query tile is consumed
      load_tile<D>(q_s, qb, a.qs.s, q0, a.Sq);
      load_tile<D>(do_s, dob, a.dos.s, q0, a.Sq);
      for (int r = threadIdx.x; r < kTile; r += kThreads) {
        const bool in = q0 + r < a.Sq;
        lse_s[r] = in ? a.lse[row0 + q0 + r] : 0.f;
        delta_s[r] = in ? a.delta[row0 + q0 + r] : 0.f;
      }
      __syncthreads();

      // S^T and dP^T for keys ty + 16 i, queries tx + 16 j
      float s[kRows][kRows], dp[kRows][kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kRows; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float kv[kRows], vv[kRows], qv[kRows], dov[kRows];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          kv[i] = k_s[(ty + 16 * i) * DP + d];
          vv[i] = v_s[(ty + 16 * i) * DP + d];
        }
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          qv[j] = q_s[(tx + 16 * j) * DP + d];
          dov[j] = do_s[(tx + 16 * j) * DP + d];
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int j = 0; j < kRows; ++j) {
            s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
            dp[i][j] = fmaf(vv[i], dov[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          const int qr = tx + 16 * j;
          s[i][j] = visible(a, q0 + qr, k0 + ty + 16 * i)
                        ? exp2f(fmaf(s[i][j], sl2, -lse_s[qr]))
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
        for (int j = 0; j < kRows; ++j) {
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

  float* dkb = static_cast<float*>(a.dk) + b * a.dks.b + kh * a.dks.h;
  float* dvb = static_cast<float*>(a.dv) + b * a.dvs.b + kh * a.dvs.h;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int kpos = k0 + ty + 16 * i;
    if (kpos >= a.Sk) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      dkb[kpos * a.dks.s + tx + 16 * c] = dk[i][c] * a.scale;
      dvb[kpos * a.dvs.s + tx + 16 * c] = dv[i][c];
    }
  }
}

// At most one block an SM asked for: with the bound on threads alone,
// ptxas held the D = 64 instance at 80 registers (three blocks an SM) and
// spilled.
template <int D>
__global__ void __launch_bounds__(kThreads, 1) fa_bwd_dq_f32_kernel(Args a) {
  constexpr int kTile = f32_tile(D);
  constexpr int kRows = kTile / 16;
  constexpr int kPP = kTile + 1;
  constexpr int DP = D + 1;
  constexpr int DC = D / 16;
  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (a.H / a.KH);
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const float sl2 = a.scale * tc::kLog2e;

  extern __shared__ float smem[];
  float* k_s = smem;
  float* v_s = k_s + kTile * DP;
  float* q_s = v_s + kTile * DP;
  float* do_s = q_s + kTile * DP;
  float* ds_s = do_s + kTile * DP;  // dS: [query][key]
  float* lse_s = ds_s + kTile * kPP;
  float* delta_s = lse_s + kTile;

  const long long row0 = ((long long)b * a.H + h) * a.Sq;
  load_tile<D>(q_s, static_cast<const float*>(a.q) + b * a.qs.b +
                        h * a.qs.h, a.qs.s, q0, a.Sq);
  load_tile<D>(do_s, static_cast<const float*>(a.dout) + b * a.dos.b +
                         h * a.dos.h, a.dos.s, q0, a.Sq);
  for (int r = threadIdx.x; r < kTile; r += kThreads) {
    const bool in = q0 + r < a.Sq;
    lse_s[r] = in ? a.lse[row0 + q0 + r] : 0.f;
    delta_s[r] = in ? a.delta[row0 + q0 + r] : 0.f;
  }
  const float* kb = static_cast<const float*>(a.k) + b * a.ks.b +
                    kh * a.ks.h;
  const float* vb = static_cast<const float*>(a.v) + b * a.vs.b +
                    kh * a.vs.h;

  // this thread's queries ty + 16 i and dims tx + 16 c
  float acc[kRows][DC];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;

  const int2 kr = key_range(a, q0, kTile, kTile);
  for (int k0 = kr.x; k0 < kr.y; k0 += kTile) {
    __syncthreads();  // the previous key tile is consumed; q, dO staged
    load_tile<D>(k_s, kb, a.ks.s, k0, a.Sk);
    load_tile<D>(v_s, vb, a.vs.s, k0, a.Sk);
    __syncthreads();

    // S and dP for queries ty + 16 i, keys tx + 16 j
    float s[kRows][kRows], dp[kRows][kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kRows; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[kRows], ov[kRows], kv[kRows], vv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        qv[i] = q_s[(ty + 16 * i) * DP + d];
        ov[i] = do_s[(ty + 16 * i) * DP + d];
      }
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        kv[j] = k_s[(tx + 16 * j) * DP + d];
        vv[j] = v_s[(tx + 16 * j) * DP + d];
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qr = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const int kc = tx + 16 * j;
        const float p = visible(a, q0 + qr, k0 + kc)
                            ? exp2f(fmaf(s[i][j], sl2, -lse_s[qr]))
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

  float* dqb = static_cast<float*>(a.dq) + b * a.dqs.b + h * a.dqs.h;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= a.Sq) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      dqb[qpos * a.dqs.s + tx + 16 * c] = acc[i][c] * a.scale;
  }
}

// ---------------------------------------------------------------------------
// 2-3. bf16: dK/dV per key tile and dQ per query tile on the tensor cores
// ---------------------------------------------------------------------------

namespace tc {

// Two consumer warpgroups and no producer warp.  An SM's registers are
// four files of 16,384, one per quarter, and its warps are dealt out over
// the quarters: a ninth warp puts three on one quarter and caps a thread at
// 168 registers, where dK/dV spilled (44 B at D = 64, 212 B at D = 128; a
// producer warpgroup handing its registers over with setmaxnreg spilled
// 132 and 160 B; __maxnreg__(224) built clean and the launch was refused).
// With eight warps the cap is 255, so warp 0 of the first group keeps the
// ring full itself, refilling each stage one step after its release.
constexpr int kConsumers = 2;                  // warpgroups of 64 rows
constexpr int kConsumerWarps = 4 * kConsumers;
constexpr int kThreads = 128 * kConsumers;
// named barriers (0 is __syncthreads) of the split dK/dV kernel: P^T
// written by group 0, and read by group 1
constexpr int kBarPFull = 1, kBarPEmpty = 2;

// dK/dV: kBN keys a CTA (64 a consumer), kBM queries a ring stage.  At
// D = 256 (kSplit) a CTA owns 64 keys, and its groups split the work:
// group 0 holds dV, group 1 dK (see dkdv_split_consume).
template <int D>
struct DkdvCfg {
  using R = Rows<D>;
  static constexpr bool kSplit = D == 256;
  static constexpr int kBN = kSplit ? 64 : 64 * kConsumers;
  static constexpr int kBM = D == 128 ? 32 : 64;
  static constexpr int kStages = kSplit ? 2 : 3;
  static constexpr int kPartKV = kBN * R::kRowBytes;
  static constexpr int kPartQ = kBM * R::kRowBytes;
  static constexpr int kKVBytes = kBN * D * 2;     // K or V
  static constexpr int kTileBytes = kBM * D * 2;   // Q or dO
  static constexpr int kStage = (2 * kTileBytes + 2 * kBM * 4 + 1023) / 1024 *
                                1024;              // Q, dO, lse, delta
  static constexpr int kV = kKVBytes;              // offsets from the base
  static constexpr int kRing = 2 * kKVBytes;
  // kSplit: P^T of a 64-key x kBM tile in fp32, passed from group 0 to 1
  static constexpr int kP = kRing + kStages * kStage;
  static constexpr int kBar = kP + (kSplit ? 64 * kBM * 4 : 0);
  // barriers: kv_full, full[stages], empty[stages]
  static constexpr int kSmem = kBar + 8 * (1 + 2 * kStages) + 1024;  // + align
};

// dQ: kBM query rows a CTA (64 a consumer), kBN keys a ring stage (32 at
// D = 256: three stages of 64-key K and V tiles beside the 128-row Q and
// dO would need 320 KiB)
template <int D>
struct DqCfg {
  using R = Rows<D>;
  static constexpr int kBM = 64 * kConsumers;
  static constexpr int kBN = D == 256 ? 32 : 64;
  static constexpr int kStages = 3;
  static constexpr int kPartQ = kBM * R::kRowBytes;
  static constexpr int kPartKV = kBN * R::kRowBytes;
  static constexpr int kQBytes = kBM * D * 2;      // Q or dO
  static constexpr int kKVBytes = kBN * D * 2;     // K or V tile
  static constexpr int kStage = 2 * kKVBytes;
  static constexpr int kDO = kQBytes;              // offsets from the base
  static constexpr int kRing = 2 * kQBytes;
  static constexpr int kBar = kRing + kStages * kStage;
  // barriers: q_full, full[stages], empty[stages]
  static constexpr int kSmem = kBar + 8 * (1 + 2 * kStages) + 1024;  // + align
};

struct Maps {
  CUtensorMap q, k, v, dout;
};

// 1024-byte aligned base of the dynamic shared memory: the swizzle pattern
// repeats every 1024 bytes and the wgmma descriptors assume tiles that
// start on it
__device__ __forceinline__ uint32_t aligned_base(const void* raw) {
  return (smem_u32(raw) + 1023) & ~1023u;
}

// Thread layout of a 64 x N wgmma accumulator: warp w of the group holds
// rows 16w + lane/4 and 16w + lane/4 + 8; register 4j + e holds column
// 8j + 2*(lane%4) + (e&1) of the first row (e < 2) or the second (e >= 2).

// Ring step j (query head j / n_q of the kv head, query tile j % n_q) of
// the dK/dV CTA into stage j % kStages, by warp 0 of the first group once
// the stage is released: lane 0 issues the Q and dO tiles' TMA loads,
// every lane stages the rows' lse and delta (0 past Sq) and arrives.
template <int D>
__device__ __forceinline__ void dkdv_fill(const Maps& maps, const Args& a,
                                          uint32_t base, int j, int b,
                                          int kh, int q_lo, int n_q) {
  using C = DkdvCfg<D>;
  using R = Rows<D>;
  const uint32_t full = base + C::kBar + 8, empty = full + 8 * C::kStages;
  const int st = j % C::kStages;
  const int lane = threadIdx.x % 32;
  const int h = kh * (a.H / a.KH) + j / n_q;
  const int q0 = q_lo + (j % n_q) * C::kBM;
  const uint32_t qa = base + C::kRing + st * C::kStage;
  mbar_wait(empty + 8 * st, ((j / C::kStages) & 1) ^ 1);  // first round passes
  if (lane == 0) {
    mbar_expect_tx(full + 8 * st, 2 * C::kTileBytes);
    for (int p = 0; p < R::kParts; ++p) {
      tma_load(qa + p * C::kPartQ, &maps.q, p * R::kCols, q0, h, b,
               full + 8 * st);
      tma_load(qa + C::kTileBytes + p * C::kPartQ, &maps.dout, p * R::kCols,
               q0, h, b, full + 8 * st);
    }
  }
  float* lse_s = reinterpret_cast<float*>(
      __cvta_shared_to_generic(qa + 2 * C::kTileBytes));
  const long long row0 = ((long long)b * a.H + h) * a.Sq;
  for (int r = lane; r < C::kBM; r += 32) {
    const bool in = q0 + r < a.Sq;
    lse_s[r] = in ? a.lse[row0 + q0 + r] : 0.f;
    lse_s[C::kBM + r] = in ? a.delta[row0 + q0 + r] : 0.f;
  }
  mbar_arrive(full + 8 * st);
  __syncwarp();
}

// The dK/dV CTA's K and V tiles (keys from k0) and its ring's first
// kStages steps, issued by warp 0 of the first group (``filler``); every
// thread then waits for K and V.
template <int D>
__device__ __forceinline__ void dkdv_start(const Maps& maps, const Args& a,
                                           uint32_t base, bool filler, int b,
                                           int kh, int k0, int q_lo, int n_q,
                                           int steps) {
  using C = DkdvCfg<D>;
  using R = Rows<D>;
  const uint32_t kv_full = base + C::kBar;
  if (steps == 0) return;
  if (filler) {
    if (threadIdx.x % 32 == 0) {
      mbar_expect_tx(kv_full, 2 * C::kKVBytes);
      for (int p = 0; p < R::kParts; ++p) {
        tma_load(base + p * C::kPartKV, &maps.k, p * R::kCols, k0, kh, b,
                 kv_full);
        tma_load(base + C::kV + p * C::kPartKV, &maps.v, p * R::kCols, k0, kh,
                 b, kv_full);
      }
    }
    __syncwarp();
    for (int j = 0; j < C::kStages && j < steps; ++j)
      dkdv_fill<D>(maps, a, base, j, b, kh, q_lo, n_q);
  }
  mbar_wait(kv_full, 0);
}

template <int D>
__device__ __forceinline__ void dkdv_consume(const Maps& maps, const Args& a,
                                             uint32_t base, int g, int b,
                                             int kh, int k0, int q_lo,
                                             int n_q) {
  using C = DkdvCfg<D>;
  using R = Rows<D>;
  constexpr int BM = C::kBM;
  const uint32_t kv_full = base + C::kBar, full = kv_full + 8,
                 empty = full + 8 * C::kStages;
  const int lane = threadIdx.x % 32;
  const int w = (threadIdx.x / 32) % 4;
  const int kg0 = k0 + 64 * g;               // this group's keys
  const int r0 = kg0 + 16 * w + lane / 4;    // this thread's keys r0, r0 + 8
  const int c2 = 2 * (lane % 4);
  const float sc = a.scale * kLog2e;
  const int G = a.H / a.KH;
  const uint32_t ka = base + g * 64 * R::kRowBytes;
  const uint32_t va = base + C::kV + g * 64 * R::kRowBytes;

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

  const int steps = G * n_q;
  const bool filler = threadIdx.x < 32;      // warp 0 of group 0
  dkdv_start<D>(maps, a, base, filler, b, kh, k0, q_lo, n_q, steps);
  for (int i = 0; i < steps; ++i) {
    // refill the stage step i - 1 released (both groups are past it soon)
    if (filler && i >= 1 && i - 1 + C::kStages < steps)
      dkdv_fill<D>(maps, a, base, i - 1 + C::kStages, b, kh, q_lo, n_q);
    const int st = i % C::kStages;
    const uint32_t ph = (i / C::kStages) & 1;
    const int q0 = q_lo + (i % n_q) * BM;
    const uint32_t qa = base + C::kRing + st * C::kStage;
    const uint32_t doa = qa + C::kTileBytes;
    const float* lse_s = reinterpret_cast<const float*>(
        __cvta_shared_to_generic(doa + C::kTileBytes));
    const float* delta_s = lse_s + BM;
    mbar_wait(full + 8 * st, ph);
    // every query of the tile masked for this group's keys: nothing to add
    const bool skip = kg0 >= a.Sk || (a.causal && q0 + BM - 1 < kg0) ||
                      (a.window && q0 - (kg0 + 63) >= a.window);
    if (!skip) {
      // S^T = K Q^T and dP^T = V dO^T (64 x BM), fp32
      float s[BM / 2], dp[BM / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint64_t kd = kmajor<D>(ka, C::kPartKV, kk);
        const uint64_t qd = kmajor<D>(qa, C::kPartQ, kk);
        if (kk == 0)
          Mma<BM>::template ss<true>(s, kd, qd);
        else
          Mma<BM>::template ss<false>(s, kd, qd);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint64_t vd = kmajor<D>(va, C::kPartKV, kk);
        const uint64_t dd = kmajor<D>(doa, C::kPartQ, kk);
        if (kk == 0)
          Mma<BM>::template ss<true>(dp, vd, dd);
        else
          Mma<BM>::template ss<false>(dp, vd, dd);
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs(s);
      fence_regs(dp);

      // P^T = exp2(S^T sc - lse), fp32; masks only on tiles that cross Sq,
      // Sk, the diagonal or the window's edge
      const bool whole = q0 + BM <= a.Sq && kg0 + 64 <= a.Sk &&
                         (!a.causal || kg0 + 63 <= q0) &&
                         (!a.window || q0 + BM - 1 - kg0 < a.window);
#pragma unroll
      for (int e = 0; e < BM / 2; ++e) {
        const int qc = 8 * (e / 4) + c2 + (e & 1);
        float p = ex2(fmaf(s[e], sc, -lse_s[qc]));
        if (!whole) {
          const int key = r0 + ((e & 2) ? 8 : 0);
          if (!visible(a, q0 + qc, key)) p = 0.f;
        }
        s[e] = p;
      }
      uint32_t hi[BM / 16][4], lo[BM / 16][4];
      split_frags(s, hi, lo);

      // dV += P^T_hi dO + P^T_lo dO (64 x D)
      fence_regs(dv);
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < BM / 16; ++t) {
        const uint64_t dd = mnmajor<D>(doa, C::kPartQ, t);
        Mma<D>::rs(dv, hi[t], dd);
        Mma<D>::rs(dv, lo[t], dd);
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs(dv);
      keep_frags(hi);
      keep_frags(lo);

      // dS^T = P^T (dP^T - delta); dK += dS^T_hi Q + dS^T_lo Q (64 x D)
#pragma unroll
      for (int e = 0; e < BM / 2; ++e)
        dp[e] = s[e] * (dp[e] - delta_s[8 * (e / 4) + c2 + (e & 1)]);
      split_frags(dp, hi, lo);
      fence_regs(dk);
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < BM / 16; ++t) {
        const uint64_t qd = mnmajor<D>(qa, C::kPartQ, t);
        Mma<D>::rs(dk, hi[t], qd);
        Mma<D>::rs(dk, lo[t], qd);
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs(dk);
      keep_frags(hi);
      keep_frags(lo);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * st);
  }

  // epilogue: 1/sqrt(D) on dK in fp32, one bf16 rounding each
  __nv_bfloat16* dkb = static_cast<__nv_bfloat16*>(a.dk) + b * a.dks.b +
                       kh * a.dks.h;
  __nv_bfloat16* dvb = static_cast<__nv_bfloat16*>(a.dv) + b * a.dvs.b +
                       kh * a.dvs.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = r0 + 8 * r;
    if (key >= a.Sk) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dkb + key * a.dks.s + 8 * j + c2) =
          __floats2bfloat162_rn(dk[4 * j + 2 * r] * a.scale,
                                dk[4 * j + 2 * r + 1] * a.scale);
      *reinterpret_cast<__nv_bfloat162*>(dvb + key * a.dvs.s + 8 * j + c2) =
          __floats2bfloat162_rn(dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
    }
  }
}

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "n"(kThreads) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "n"(kThreads) : "memory");
}

// D = 256: the CTA's 64 keys [k0, k0 + 64) are both groups' rows, and the
// groups split the work of each ring step: group 0 computes S^T = K Q^T,
// P^T and dV += P^T_hi dO + P^T_lo dO; group 1 dP^T = V dO^T and, from
// group 0's P^T, dS^T = P^T (dP^T - delta) and dK += dS^T_hi Q + dS^T_lo Q.
// Each group's accumulator (dV or dK, 64 x 256) is 128 fp32 registers a
// thread, where one group holding both would need 256.  P^T passes in fp32
// through shared memory (each thread's 32 values at [e][thread]; both
// groups hold a 64 x 64 tile in the same thread layout), guarded by two
// named barriers: group 0 waits on kBarPEmpty before it overwrites the
// tile, group 1 on kBarPFull before it reads it.  The arithmetic of every
// element is the other instances'.
template <int D>
__device__ __forceinline__ void dkdv_split_consume(
    const Maps& maps, const Args& a, uint32_t base, int g, int b, int kh,
    int k0, int q_lo, int n_q) {
  using C = DkdvCfg<D>;
  constexpr int BM = C::kBM;
  const uint32_t kv_full = base + C::kBar, full = kv_full + 8,
                 empty = full + 8 * C::kStages;
  const int lane = threadIdx.x % 32;
  const int w = (threadIdx.x / 32) % 4;
  const int t = threadIdx.x % 128;           // this thread in its group
  const int r0 = k0 + 16 * w + lane / 4;     // this thread's keys r0, r0 + 8
  const int c2 = 2 * (lane % 4);
  const float sc = a.scale * kLog2e;
  const int G = a.H / a.KH;
  // group 0 multiplies K by Q^T, group 1 V by dO^T
  const uint32_t lhs = base + (g == 0 ? 0 : C::kV);
  float* p_s = reinterpret_cast<float*>(__cvta_shared_to_generic(base +
                                                                  C::kP));

  float acc[D / 2];                          // dV (group 0) or dK (group 1)
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  const int steps = G * n_q;
  const bool filler = threadIdx.x < 32;      // warp 0 of group 0
  dkdv_start<D>(maps, a, base, filler, b, kh, k0, q_lo, n_q, steps);
  bool passed = false;                       // a P^T tile went through p_s
  for (int i = 0; i < steps; ++i) {
    // refill the stage step i - 1 released (both groups are past it soon)
    if (filler && i >= 1 && i - 1 + C::kStages < steps)
      dkdv_fill<D>(maps, a, base, i - 1 + C::kStages, b, kh, q_lo, n_q);
    const int st = i % C::kStages;
    const uint32_t ph = (i / C::kStages) & 1;
    const int q0 = q_lo + (i % n_q) * BM;
    const uint32_t qa = base + C::kRing + st * C::kStage;
    const uint32_t doa = qa + C::kTileBytes;
    const float* lse_s = reinterpret_cast<const float*>(
        __cvta_shared_to_generic(doa + C::kTileBytes));
    const float* delta_s = lse_s + BM;
    mbar_wait(full + 8 * st, ph);
    // every query of the tile masked for the CTA's keys: nothing to add
    // (the same decision in both groups, so their barriers pair up)
    const bool skip = (a.causal && q0 + BM - 1 < k0) ||
                      (a.window && q0 - (k0 + 63) >= a.window);
    if (!skip) {
      // S^T = K Q^T (group 0) or dP^T = V dO^T (group 1), 64 x BM, fp32
      const uint32_t rhs = g == 0 ? qa : doa;
      float x[BM / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint64_t ld = kmajor<D>(lhs, C::kPartKV, kk);
        const uint64_t rd = kmajor<D>(rhs, C::kPartQ, kk);
        if (kk == 0)
          Mma<BM>::template ss<true>(x, ld, rd);
        else
          Mma<BM>::template ss<false>(x, ld, rd);
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs(x);
      uint32_t hi[BM / 16][4], lo[BM / 16][4];
      if (g == 0) {
        // P^T = exp2(S^T sc - lse), fp32; masks only on tiles that cross
        // Sq, Sk, the diagonal or the window's edge
        const bool whole = q0 + BM <= a.Sq && k0 + 64 <= a.Sk &&
                           (!a.causal || k0 + 63 <= q0) &&
                           (!a.window || q0 + BM - 1 - k0 < a.window);
#pragma unroll
        for (int e = 0; e < BM / 2; ++e) {
          const int qc = 8 * (e / 4) + c2 + (e & 1);
          float p = ex2(fmaf(x[e], sc, -lse_s[qc]));
          if (!whole) {
            const int key = r0 + ((e & 2) ? 8 : 0);
            if (!visible(a, q0 + qc, key)) p = 0.f;
          }
          x[e] = p;
        }
        if (passed) named_sync(kBarPEmpty);  // group 1 read the last P^T
#pragma unroll
        for (int e = 0; e < BM / 2; ++e) p_s[e * 128 + t] = x[e];
        named_arrive(kBarPFull);
        split_frags(x, hi, lo);
        // dV += P^T_hi dO + P^T_lo dO (64 x D)
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int u = 0; u < BM / 16; ++u) {
          const uint64_t dd = mnmajor<D>(doa, C::kPartQ, u);
          Mma<D>::rs(acc, hi[u], dd);
          Mma<D>::rs(acc, lo[u], dd);
        }
      } else {
        // dS^T = P^T (dP^T - delta); dK += dS^T_hi Q + dS^T_lo Q (64 x D)
        named_sync(kBarPFull);
#pragma unroll
        for (int e = 0; e < BM / 2; ++e)
          x[e] = p_s[e * 128 + t] *
                 (x[e] - delta_s[8 * (e / 4) + c2 + (e & 1)]);
        named_arrive(kBarPEmpty);
        split_frags(x, hi, lo);
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int u = 0; u < BM / 16; ++u) {
          const uint64_t qd = mnmajor<D>(qa, C::kPartQ, u);
          Mma<D>::rs(acc, hi[u], qd);
          Mma<D>::rs(acc, lo[u], qd);
        }
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs(acc);
      keep_frags(hi);
      keep_frags(lo);
      passed = true;
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * st);
  }
  // group 1's last arrival on kBarPEmpty: every arrival is waited for
  if (g == 0 && passed) named_sync(kBarPEmpty);

  // epilogue: dV as summed, dK times 1/sqrt(D) in fp32; one bf16 rounding
  const bool is_dk = g == 1;
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(is_dk ? a.dk : a.dv) +
                       b * (is_dk ? a.dks.b : a.dvs.b) +
                       kh * (is_dk ? a.dks.h : a.dvs.h);
  const long long os = is_dk ? a.dks.s : a.dvs.s;
  const float mul = is_dk ? a.scale : 1.f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = r0 + 8 * r;
    if (key >= a.Sk) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + key * os + 8 * j + c2) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r] * mul,
                                acc[4 * j + 2 * r + 1] * mul);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1) fa_bwd_dkdv_tc_kernel(
    const __grid_constant__ Maps maps, const Args a) {
  using C = DkdvCfg<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = aligned_base(smem_raw);
  const uint32_t kv_full = base + C::kBar, full = kv_full + 8,
                 empty = full + 8 * C::kStages;
  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * C::kBN;     // causal: the most work first
  const int2 qr = query_range(a, k0, C::kBN, C::kBM);
  const int n_q = qr.y > qr.x ? (qr.y - qr.x + C::kBM - 1) / C::kBM : 0;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int st = 0; st < C::kStages; ++st) {
      mbar_init(full + 8 * st, 1 + 32);      // TMA bytes + warp 0's stores
      mbar_init(empty + 8 * st, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if constexpr (C::kSplit)
    dkdv_split_consume<D>(maps, a, base, threadIdx.x / 128, b, kh, k0, qr.x,
                          n_q);
  else
    dkdv_consume<D>(maps, a, base, threadIdx.x / 128, b, kh, k0, qr.x, n_q);
}

// Ring step j (the K and V tiles from key k_lo + j * kBN) of the dQ CTA
// into stage j % kStages, by thread 0 once the stage is released.
template <int D>
__device__ __forceinline__ void dq_fill(const Maps& maps, uint32_t base,
                                        int j, int b, int kh, int k_lo) {
  using C = DqCfg<D>;
  using R = Rows<D>;
  const uint32_t full = base + C::kBar + 8, empty = full + 8 * C::kStages;
  const int st = j % C::kStages;
  const int k0 = k_lo + j * C::kBN;
  const uint32_t ka = base + C::kRing + st * C::kStage;
  mbar_wait(empty + 8 * st, ((j / C::kStages) & 1) ^ 1);  // first round passes
  mbar_expect_tx(full + 8 * st, C::kStage);
  for (int p = 0; p < R::kParts; ++p) {
    tma_load(ka + p * C::kPartKV, &maps.k, p * R::kCols, k0, kh, b,
             full + 8 * st);
    tma_load(ka + C::kKVBytes + p * C::kPartKV, &maps.v, p * R::kCols, k0,
             kh, b, full + 8 * st);
  }
}

template <int D>
__device__ __forceinline__ void dq_consume(const Maps& maps, const Args& a,
                                           uint32_t base, int g, int b,
                                           int h, int q0, int k_lo,
                                           int n_k) {
  using C = DqCfg<D>;
  using R = Rows<D>;
  constexpr int BN = C::kBN;
  const uint32_t q_full = base + C::kBar, full = q_full + 8,
                 empty = full + 8 * C::kStages;
  const int lane = threadIdx.x % 32;
  const int w = (threadIdx.x / 32) % 4;
  const int qg0 = q0 + 64 * g;               // this group's rows
  const int r0 = qg0 + 16 * w + lane / 4;    // this thread's rows r0, r0 + 8
  const int c2 = 2 * (lane % 4);
  const float sc = a.scale * kLog2e;
  const uint32_t qa = base + g * 64 * R::kRowBytes;
  const uint32_t doa = base + C::kDO + g * 64 * R::kRowBytes;

  const long long row0 = ((long long)b * a.H + h) * a.Sq;
  float lse[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    lse[r] = row < a.Sq ? a.lse[row0 + row] : 0.f;
    delta[r] = row < a.Sq ? a.delta[row0 + row] : 0.f;
  }
  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

  const int kh = h / (a.H / a.KH);
  const bool filler = threadIdx.x == 0;
  if (filler && n_k > 0) {
    mbar_expect_tx(q_full, 2 * C::kQBytes);
    for (int p = 0; p < R::kParts; ++p) {
      tma_load(base + p * C::kPartQ, &maps.q, p * R::kCols, q0, h, b, q_full);
      tma_load(base + C::kDO + p * C::kPartQ, &maps.dout, p * R::kCols, q0, h,
               b, q_full);
    }
    for (int j = 0; j < C::kStages && j < n_k; ++j)
      dq_fill<D>(maps, base, j, b, kh, k_lo);
  }
  __syncwarp();
  if (n_k > 0) mbar_wait(q_full, 0);
  for (int i = 0; i < n_k; ++i) {
    // refill the stage step i - 1 released (both groups are past it soon)
    if (filler && i >= 1 && i - 1 + C::kStages < n_k)
      dq_fill<D>(maps, base, i - 1 + C::kStages, b, kh, k_lo);
    __syncwarp();
    const int st = i % C::kStages;
    const uint32_t ph = (i / C::kStages) & 1;
    const int k0 = k_lo + i * BN;
    const uint32_t ka = base + C::kRing + st * C::kStage;
    const uint32_t va = ka + C::kKVBytes;
    mbar_wait(full + 8 * st, ph);
    // every key of the tile masked for this group's rows: nothing to add
    const bool skip = qg0 >= a.Sq || (a.causal && k0 > qg0 + 63) ||
                      (a.window && qg0 - (k0 + BN - 1) >= a.window);
    if (!skip) {
      // S = Q K^T and dP = dO V^T (64 x BN), fp32
      float s[BN / 2], dp[BN / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint64_t qd = kmajor<D>(qa, C::kPartQ, kk);
        const uint64_t kd = kmajor<D>(ka, C::kPartKV, kk);
        if (kk == 0)
          Mma<BN>::template ss<true>(s, qd, kd);
        else
          Mma<BN>::template ss<false>(s, qd, kd);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint64_t dd = kmajor<D>(doa, C::kPartQ, kk);
        const uint64_t vd = kmajor<D>(va, C::kPartKV, kk);
        if (kk == 0)
          Mma<BN>::template ss<true>(dp, dd, vd);
        else
          Mma<BN>::template ss<false>(dp, dd, vd);
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs(s);
      fence_regs(dp);

      // dS = P (dP - delta), P = exp2(S sc - lse); masks only on tiles
      // that cross Sk, the diagonal or the window's edge
      const bool whole = k0 + BN <= a.Sk &&
                         (!a.causal || k0 + BN - 1 <= qg0) &&
                         (!a.window || qg0 + 63 - k0 < a.window);
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) {
        const int r = (e >> 1) & 1;
        float p = ex2(fmaf(s[e], sc, -lse[r]));
        if (!whole) {
          const int key = k0 + 8 * (e / 4) + c2 + (e & 1);
          if (!visible(a, r0 + 8 * r, key)) p = 0.f;
        }
        dp[e] = p * (dp[e] - delta[r]);
      }
      uint32_t hi[BN / 16][4], lo[BN / 16][4];
      split_frags(dp, hi, lo);

      // dQ += dS_hi K + dS_lo K (64 x D)
      fence_regs(dq);
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < BN / 16; ++t) {
        const uint64_t kd = mnmajor<D>(ka, C::kPartKV, t);
        Mma<D>::rs(dq, hi[t], kd);
        Mma<D>::rs(dq, lo[t], kd);
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs(dq);
      keep_frags(hi);
      keep_frags(lo);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * st);
  }

  __nv_bfloat16* dqb = static_cast<__nv_bfloat16*>(a.dq) + b * a.dqs.b +
                       h * a.dqs.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= a.Sq) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dqb + row * a.dqs.s + 8 * j + c2) =
          __floats2bfloat162_rn(dq[4 * j + 2 * r] * a.scale,
                                dq[4 * j + 2 * r + 1] * a.scale);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1) fa_bwd_dq_tc_kernel(
    const __grid_constant__ Maps maps, const Args a) {
  using C = DqCfg<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = aligned_base(smem_raw);
  const uint32_t q_full = base + C::kBar, full = q_full + 8,
                 empty = full + 8 * C::kStages;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * C::kBM;  // longest first
  const int2 kr = key_range(a, q0, C::kBM, C::kBN);
  const int n_k = kr.y > kr.x ? (kr.y - kr.x + C::kBN - 1) / C::kBN : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < C::kStages; ++st) {
      mbar_init(full + 8 * st, 1);
      mbar_init(empty + 8 * st, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  dq_consume<D>(maps, a, base, threadIdx.x / 128, b, h, q0, kr.x, n_k);
}

}  // namespace tc

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <typename K, typename... P>
cudaError_t launch_one(K kernel, dim3 grid, int threads, int smem,
                       cudaStream_t stream, P... args) {
  if (smem > 0) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

template <int BF16, int D>
cudaError_t launch_delta(const Args& a, int B, cudaStream_t stream) {
  const long long rows = (long long)B * a.H * a.Sq;
  const long long threads = rows * DeltaCfg<BF16, D>::kLanes;
  return launch_one(fa_bwd_delta_kernel<BF16, D>,
                    dim3((unsigned)((threads + kDeltaThreads - 1) /
                                    kDeltaThreads)),
                    kDeltaThreads, 0, stream, a, rows);
}

template <int D>
int launch_f32(const Args& a, int B, cudaStream_t stream) {
  constexpr int T = f32_tile(D);
  const int nq = (a.Sq + T - 1) / T;
  const int nk = (a.Sk + T - 1) / T;
  cudaError_t e = launch_delta<0, D>(a, B, stream);
  if (e != cudaSuccess) return (int)e;
  e = launch_one(fa_bwd_dkdv_f32_kernel<D>, dim3(nk, a.KH, B), kThreads,
                 f32_smem(D), stream, a);
  if (e != cudaSuccess) return (int)e;
  return (int)launch_one(fa_bwd_dq_f32_kernel<D>, dim3(nq, a.H, B), kThreads,
                         f32_smem(D), stream, a);
}

template <int D>
int launch_tc(const Args& a, int B, cudaStream_t stream) {
  using KV = tc::DkdvCfg<D>;
  using DQ = tc::DqCfg<D>;
  constexpr int cols = tc::Rows<D>::kCols;
  tc::Maps kv, dq;   // the two kernels' boxes differ
  if (!tc::make_map(&kv.q, a.q, D, cols, a.Sq, a.H, B, a.qs, KV::kBM) ||
      !tc::make_map(&kv.dout, a.dout, D, cols, a.Sq, a.H, B, a.dos,
                    KV::kBM) ||
      !tc::make_map(&kv.k, a.k, D, cols, a.Sk, a.KH, B, a.ks, KV::kBN) ||
      !tc::make_map(&kv.v, a.v, D, cols, a.Sk, a.KH, B, a.vs, KV::kBN) ||
      !tc::make_map(&dq.q, a.q, D, cols, a.Sq, a.H, B, a.qs, DQ::kBM) ||
      !tc::make_map(&dq.dout, a.dout, D, cols, a.Sq, a.H, B, a.dos,
                    DQ::kBM) ||
      !tc::make_map(&dq.k, a.k, D, cols, a.Sk, a.KH, B, a.ks, DQ::kBN) ||
      !tc::make_map(&dq.v, a.v, D, cols, a.Sk, a.KH, B, a.vs, DQ::kBN))
    return tc::kErrTensorMap;
  const int nk = (a.Sk + KV::kBN - 1) / KV::kBN;
  const int nq = (a.Sq + DQ::kBM - 1) / DQ::kBM;
  if (nk > 65535 || nq > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t e = launch_delta<1, D>(a, B, stream);
  if (e != cudaSuccess) return (int)e;
  e = launch_one(tc::fa_bwd_dkdv_tc_kernel<D>, dim3(a.KH, B, nk),
                 tc::kThreads, KV::kSmem, stream, kv, a);
  if (e != cudaSuccess) return (int)e;
  return (int)launch_one(tc::fa_bwd_dq_tc_kernel<D>, dim3(a.H, B, nq),
                         tc::kThreads, DQ::kSmem, stream, dq, a);
}

}  // namespace

extern "C" {

// Launches the three kernels on ``stream`` (delta, dK/dV, dQ) and returns
// 0 on success, else the CUDA error code of the first launch refused, or
// -1 when a tensor map cannot be built.  bf16 != 0: q, k, v, o, dout and
// the gradients are bf16 (the tensor-core kernels: q, k, v and dout are
// read by TMA, o in 16-byte loads, the gradients written in bf16 pairs, so
// every base is 16-byte aligned and every stride a multiple of 16 bytes;
// the wrapper checks), else f32 (the CUDA-core kernels; o and dout
// 16-byte aligned).  D is 16, 64, 128 or 256.  ``strides`` holds 24 element
// strides, (b, h, s) of q, k, v, o, dout, dq, dk and dv in that order (d
// is contiguous).  lse is the forward's fp32 (B,H,Sq) output and delta
// fp32 (B,H,Sq) scratch, both contiguous.  Every pointer but ``strides``
// is a device pointer.
int flash_attention_bwd_launch(int bf16, int D, const void* q, const void* k,
                               const void* v, const void* o,
                               const void* dout, void* dq, void* dk,
                               void* dv, const void* lse, void* delta, int B,
                               int H, int KH, int Sq, int Sk,
                               const long long* strides, int causal,
                               int window, float scale, void* stream) {
  if (B <= 0 || Sq <= 0) return 0;
  if (KH <= 0 || H % KH != 0 || Sk <= 0 || window < 0 || H > 65535 ||
      B > 65535)
    return (int)cudaErrorInvalidValue;
  const long long* x = strides;
  Args a{q, k, v, o, dout, dq, dk, dv,
         static_cast<const float*>(lse), static_cast<float*>(delta),
         Strides{x[0], x[1], x[2]}, Strides{x[3], x[4], x[5]},
         Strides{x[6], x[7], x[8]}, Strides{x[9], x[10], x[11]},
         Strides{x[12], x[13], x[14]}, Strides{x[15], x[16], x[17]},
         Strides{x[18], x[19], x[20]}, Strides{x[21], x[22], x[23]},
         H, KH, Sq, Sk, causal, window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D * 2 + (bf16 != 0)) {
    case 32: return launch_f32<16>(a, B, s);
    case 33: return launch_tc<16>(a, B, s);
    case 128: return launch_f32<64>(a, B, s);
    case 129: return launch_tc<64>(a, B, s);
    case 256: return launch_f32<128>(a, B, s);
    case 257: return launch_tc<128>(a, B, s);
    case 512: return launch_f32<256>(a, B, s);
    case 513: return launch_tc<256>(a, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Dynamic shared memory of one block of kernel 0 (delta), 1 (dK/dV, f32),
// 2 (dQ, f32), 3 (dK/dV, tensor cores) or 4 (dQ, tensor cores) at head dim
// D, in bytes; 0 for a D without an instance.
int flash_attention_bwd_smem(int kernel, int D) {
  if (D != 16 && D != 64 && D != 128 && D != 256) return 0;
  switch (kernel) {
    case 1:
    case 2: return f32_smem(D);
    case 3:
      return D == 16    ? tc::DkdvCfg<16>::kSmem
             : D == 64  ? tc::DkdvCfg<64>::kSmem
             : D == 128 ? tc::DkdvCfg<128>::kSmem
                        : tc::DkdvCfg<256>::kSmem;
    case 4:
      return D == 16    ? tc::DqCfg<16>::kSmem
             : D == 64  ? tc::DqCfg<64>::kSmem
             : D == 128 ? tc::DqCfg<128>::kSmem
                        : tc::DqCfg<256>::kSmem;
    default: return 0;
  }
}

const char* flash_attention_bwd_error_string(int code) {
  if (code == tc::kErrTensorMap)
    return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

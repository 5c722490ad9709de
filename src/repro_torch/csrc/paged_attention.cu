// Paged decode attention for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the Pallas TPU kernel
//   repro/kernels/paged_attention/kernel.py::paged_attention  (body _kernel)
// and computes what it computes: for each sequence, one query token's GQA
// attention over the sequence's pages of a shared K/V pool, with an fp32
// online softmax, positions >= length masked with -1e30 (they contribute
// exactly 0), the G query heads of a kv head together, lengths clamped to
// NP * page, and output 0 for a sequence of length 0.  q is scaled by
// 1/sqrt(D) in fp32, K and V are read in fp32, and int8 pages are
// multiplied by their (page, kv head) fp32 scale before use.  The output is
// rounded once to q's dtype.
//
// What bounds it on an H100: bytes.  One (token, kv head) reads 2*D*elt
// bytes of K and V and does 4*G*D FLOPs on them: 3 FLOP/B at D = 64, G = 3
// in bf16, far below the ~20 FLOP/B at which the CUDA cores (67 TFLOP/s
// fp32) and not HBM (3.35 TB/s) would be the limit.  The least time is the
// live K/V pages over 3.35 TB/s.  Reaching it takes every SM busy and about
// 16 KB of K/V in flight on each (3.35 TB/s x ~1 us of latency / 132 SMs).
//
// What the design does about it (flash-decoding):
//  * Split-K across blocks.  The grid is (sequence x kv head, split).  A
//    split owns a contiguous range of table entries, [s*NP/S, (s+1)*NP/S),
//    and reads only the live ones (tokens < length: a dead table entry is
//    never read, whatever it holds).  The host chooses S from shapes only
//    (kernels/paged_attention/kernel.py::num_splits), so a long context
//    fills the card even at batch 1.  With S = 1 this kernel writes the
//    output; with S > 1 it writes each split's running max m, denominator
//    l and unnormalised fp32 accumulator to a workspace, and
//    paged_attention_combine_kernel merges the splits with the log-sum-exp
//    rescale.  A split with no live token keeps m = -1e30, l = 0, acc = 0
//    and so contributes exactly 0.
//  * 16-byte loads, several stages in flight.  One token's D values for one
//    kv head are contiguous in the (P, page, KH, D) pool; neighbouring
//    threads copy neighbouring 16-byte words of a token with cp.async.cg
//    into a ring of kStages = 4 shared-memory stages of 4 KB of K and 4 KB
//    of V each (3 stages in flight while one is read: 24 KB per block, and
//    several blocks per SM).  Each thread keeps its rows' (table entry,
//    row in page) and advances them by one stage without a division; the
//    page id of its next stage is loaded a stage ahead.  int8 pages bring
//    their per-row scales into the same stage with 4-byte cp.async.
//  * No fp32 staging copy.  K/V stay in the pool's dtype in shared memory.
//    A token is served by D/8 lanes, each holding 8 of its D values: the
//    lane dequantises its slice in registers (bf16 to fp32, or int8 times
//    the page's scale), its G query rows (pre-scaled, fp32) stay in
//    registers, and the partial dot products are summed across the token's
//    lanes with warp shuffles.  Each group of D/8 lanes keeps its own
//    online-softmax state (m, l, acc) over the tokens it serves; the groups
//    and warps are merged once, at the end of the split.  The only
//    block-wide barrier per stage is the ring's.
//  * Head groups.  G query heads are served by up to four head groups of
//    GW = ceil(G / groups) <= 4 heads, so a thread holds at most 4 x 8 query
//    values and 4 x 8 accumulators in registers for any G up to 16; the
//    warps of one head group share the stage's tokens.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 4;
constexpr int kTensorStageBytes = 4096;   // of K (and of V) per stage
constexpr int kEPT = 8;                   // head-dim values per lane
constexpr int kMaxGW = 4;                 // heads per head group
constexpr int kTokens = 2;                // tokens a lane group takes at once

enum DType : int { kF32 = 0, kBF16 = 1, kI8 = 2 };

template <int KV> struct KVType;
template <> struct KVType<kF32> { using T = float; };
template <> struct KVType<kBF16> { using T = __nv_bfloat16; };
template <> struct KVType<kI8> { using T = int8_t; };

struct Params {
  const void* q;
  const void* k_pages;
  const void* v_pages;
  const float* k_scales;
  const float* v_scales;
  const int32_t* block_tables;
  const int32_t* lengths;
  void* out;      // (B, H, D) in q's dtype, written when S == 1
  float* ws;      // S > 1: acc (B*KH, S, G, D), then m and l (B*KH, S, G)
  int q_bf16;
  int B, H, KH, D, page, NP, S, head_groups;
  float scale;
};

// Head-dim index of the lane's i-th value (ig: the lane's index among the
// D/8 lanes of its token).  bf16 and int8: 8 consecutive values.  f32: two
// runs of 4, one in each half of the row, so that 8 lanes read 128
// contiguous bytes per 16-byte load.
template <int KV>
__device__ __forceinline__ int dim_of(int ig, int i, int D) {
  if (KV == kF32) return i < 4 ? ig * 4 + i : D / 2 + ig * 4 + (i - 4);
  return ig * kEPT + i;
}

// The lane's 8 values of one row of a stage, in fp32.
template <int KV>
__device__ __forceinline__ void load_slice(const char* row, int ig, int D,
                                           float f[kEPT]) {
  if (KV == kF32) {
    const float4 a = *reinterpret_cast<const float4*>(
        row + 16 * ig);
    const float4 b = *reinterpret_cast<const float4*>(
        row + 2 * D + 16 * ig);
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
  } else if (KV == kBF16) {
    const uint4 u = *reinterpret_cast<const uint4*>(row + 16 * ig);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      f[2 * j] = __uint_as_float(w[j] << 16);
      f[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
  } else {
    // int8 b -> fp32 exactly without the quarter-rate I2F: the byte
    // b + 128 placed under the exponent of 2^23, minus 2^23 + 128
    const uint2 u = *reinterpret_cast<const uint2*>(row + 8 * ig);
    const uint32_t w[2] = {u.x ^ 0x80808080u, u.y ^ 0x80808080u};
#pragma unroll
    for (int i = 0; i < kEPT; ++i)
      f[i] = __uint_as_float(__byte_perm(w[i / 4], 0x4B000000u,
                                         0x7540u + i % 4)) -
             8388736.f;
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float read_q(const void* q, int bf16, size_t i) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(q)[i])
              : static_cast<const float*>(q)[i];
}

__device__ __forceinline__ void write_out(void* out, int bf16, size_t i,
                                          float x) {
  if (bf16)   // round to nearest even, as torch's cast
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16(x);
  else
    static_cast<float*>(out)[i] = x;
}

__host__ __device__ inline int stage_rows(int D, int elt) {
  return kTensorStageBytes / (D * elt);
}

// One ring stage: K rows, V rows, and for int8 the rows' K and V scales.
__host__ __device__ inline int stage_bytes(int kv, int D) {
  const int elt = kv == kF32 ? 4 : kv == kBF16 ? 2 : 1;
  return 2 * kTensorStageBytes +
         (kv == kI8 ? 2 * stage_rows(D, elt) * (int)sizeof(float) : 0);
}

template <int KV, int GW>
__global__ void __launch_bounds__(kThreads)
    paged_attention_split_kernel(const Params p) {
  static_assert(GW >= 1 && GW <= kMaxGW, "heads per head group");
  using KVT = typename KVType<KV>::T;
  constexpr bool kQuant = KV == kI8;
  constexpr int kElt = sizeof(KVT);
  extern __shared__ __align__(16) char smem[];

  const int bk = blockIdx.x;          // sequence x kv head
  const int b = bk / p.KH, kh = bk % p.KH;
  const int split = blockIdx.y;
  const int G = p.H / p.KH, D = p.D, page = p.page, NP = p.NP;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // warps: head_groups x token warps; lanes: token groups of D/8 lanes
  const int TW = kWarps / p.head_groups;
  const int hg = warp / TW, tw = warp % TW;
  const int g0 = hg * GW;
  const int ng = max(0, min(GW, G - g0));      // heads of this warp
  const int tpt = D / kEPT;                    // lanes per token
  const int tpt_log = __ffs(tpt) - 1;
  const int ig = lane & (tpt - 1);
  const int ngroups = TW * (32 >> tpt_log);    // token groups per head group
  const int grp0 = tw * (32 >> tpt_log);       // this warp's first group

  // the split's live tokens
  const int len = max(0, min(p.lengths[b], NP * page));
  const int p_lo = (int)(((long long)split * NP) / p.S);
  const int p_hi = (int)(((long long)(split + 1) * NP) / p.S);
  const int tok_begin = p_lo * page;
  const int tok_end = min(p_hi * page, len);
  const int ntok = max(0, tok_end - tok_begin);
  const int T = stage_rows(D, kElt);           // rows per stage
  const int nst = (ntok + T - 1) / T;
  const int sbytes = stage_bytes(KV, D);
  const int row_bytes = D * kElt;

  // the query rows of this warp's heads, scaled by 1/sqrt(D), in fp32
  float qf[GW][kEPT], acc[GW][kEPT], m[GW], l[GW];
#pragma unroll
  for (int g = 0; g < GW; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < kEPT; ++i) {
      acc[g][i] = 0.f;
      qf[g][i] = g < ng ? read_q(p.q, p.q_bf16,
                                 ((size_t)b * p.H + kh * G + g0 + g) * D +
                                     dim_of<KV>(ig, i, D)) *
                              p.scale
                        : 0.f;
    }
  }

  // This thread's two 16-byte chunks of each stage (256 chunks of K and
  // 256 of V): rows r and r + 128 / C at word c of the row.  Each row's
  // (table entry, row in page) is set once here and advanced by T rows a
  // stage; the page id is read a stage ahead of its copy.
  const int C = row_bytes / 16;
  const int c = tid & (C - 1);
  int r[2], pi[2], prow[2], pid[2];
  const int32_t* table = p.block_tables + (size_t)b * NP;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    r[k] = (tid + k * kThreads) / C;
    const int t = tok_begin + r[k];
    pi[k] = t / page;
    prow[k] = t - pi[k] * page;
    pid[k] = t < tok_end ? __ldg(table + pi[k]) : 0;
  }
  const int dq = T / page, dr = T - (T / page) * page;
  const char* kbase = static_cast<const char*>(p.k_pages);
  const char* vbase = static_cast<const char*>(p.v_pages);

  auto issue = [&](int n) {
    char* st = smem + (n % kStages) * sbytes;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int t = tok_begin + n * T + r[k];
      if (t < tok_end) {
        const size_t row =
            ((size_t)pid[k] * page + prow[k]) * p.KH + kh;
        cp_async16(st + r[k] * row_bytes + c * 16,
                   kbase + row * row_bytes + c * 16);
        cp_async16(st + kTensorStageBytes + r[k] * row_bytes + c * 16,
                   vbase + row * row_bytes + c * 16);
        if (kQuant && c == 0) {
          float* sc = reinterpret_cast<float*>(st + 2 * kTensorStageBytes);
          const size_t si = (size_t)pid[k] * p.KH + kh;
          cp_async4(sc + r[k], p.k_scales + si);
          cp_async4(sc + T + r[k], p.v_scales + si);
        }
      }
      prow[k] += dr;
      pi[k] += dq;
      if (prow[k] >= page) {
        prow[k] -= page;
        ++pi[k];
      }
      pid[k] = t + T < tok_end ? __ldg(table + pi[k]) : 0;
    }
    cp_async_commit();
  };

#pragma unroll
  for (int n = 0; n < kStages - 1; ++n) issue(n);

  for (int n = 0; n < nst; ++n) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // stage n landed for all; stage n - 1 is consumed
    issue(n + kStages - 1);
    if (ng == 0) continue;
    const char* st = smem + (n % kStages) * sbytes;
    const float* scales =
        reinterpret_cast<const float*>(st + 2 * kTensorStageBytes);
    const int rows = min(T, ntok - n * T);
    // each token group takes kTokens tokens at a time, whose dot products
    // and shuffle reductions are independent (latency overlapped)
    for (int r0 = grp0; r0 < rows; r0 += kTokens * ngroups) {  // warp-uniform
      int ro[kTokens];
      bool valid[kTokens];
      float s[kTokens][GW];
#pragma unroll
      for (int u = 0; u < kTokens; ++u) {
        const int rr = r0 + u * ngroups + (lane >> tpt_log);
        valid[u] = rr < rows;
        ro[u] = valid[u] ? rr : 0;
        float kv[kEPT];
        load_slice<KV>(st + ro[u] * row_bytes, ig, D, kv);
        if (kQuant) {
          const float ks = scales[ro[u]];
#pragma unroll
          for (int i = 0; i < kEPT; ++i) kv[i] *= ks;
        }
#pragma unroll
        for (int g = 0; g < GW; ++g) {
          float x = 0.f;
#pragma unroll
          for (int i = 0; i < kEPT; ++i) x = fmaf(qf[g][i], kv[i], x);
          s[u][g] = x;
        }
      }
      for (int off = tpt >> 1; off > 0; off >>= 1) {
#pragma unroll
        for (int u = 0; u < kTokens; ++u) {
#pragma unroll
          for (int g = 0; g < GW; ++g)
            s[u][g] += __shfl_xor_sync(0xffffffffu, s[u][g], off);
        }
      }
      // online softmax: rescale only when a running max grows somewhere
      // in the warp (rare after the first tokens), then accumulate
      bool grow = false;
#pragma unroll
      for (int u = 0; u < kTokens; ++u) {
#pragma unroll
        for (int g = 0; g < GW; ++g) grow |= valid[u] && s[u][g] > m[g];
      }
      if (__any_sync(0xffffffffu, grow)) {
#pragma unroll
        for (int g = 0; g < GW; ++g) {
          float m_new = m[g];
#pragma unroll
          for (int u = 0; u < kTokens; ++u)
            if (valid[u]) m_new = fmaxf(m_new, s[u][g]);
          const float corr = exp2f((m[g] - m_new) * kLog2e);
          l[g] *= corr;
#pragma unroll
          for (int i = 0; i < kEPT; ++i) acc[g][i] *= corr;
          m[g] = m_new;
        }
      }
#pragma unroll
      for (int u = 0; u < kTokens; ++u) {
        if (!valid[u]) continue;
        float vv[kEPT];
        load_slice<KV>(st + kTensorStageBytes + ro[u] * row_bytes, ig, D, vv);
        if (kQuant) {
          const float vs = scales[T + ro[u]];
#pragma unroll
          for (int i = 0; i < kEPT; ++i) vv[i] *= vs;
        }
#pragma unroll
        for (int g = 0; g < GW; ++g) {
          const float pr = exp2f((s[u][g] - m[g]) * kLog2e);
          l[g] += pr;
#pragma unroll
          for (int i = 0; i < kEPT; ++i) acc[g][i] = fmaf(pr, vv[i], acc[g][i]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();     // the ring is free: reuse it for the merge

  // merge the token groups of each warp (butterfly: every lane ends with
  // the warp's state), then the warps of each head group through smem
  float* red_acc = reinterpret_cast<float*>(smem);        // [warp][GW][D]
  float* red_m = red_acc + kWarps * kMaxGW * D;           // [warp][GW]
  float* red_l = red_m + kWarps * kMaxGW;
  if (ng > 0) {
    for (int off = tpt; off < 32; off <<= 1) {
#pragma unroll
      for (int g = 0; g < GW; ++g) {
        const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
        const float lo = __shfl_xor_sync(0xffffffffu, l[g], off);
        const float mx = fmaxf(m[g], mo);
        const float a = exp2f((m[g] - mx) * kLog2e);
        const float c2 = exp2f((mo - mx) * kLog2e);
        l[g] = l[g] * a + lo * c2;
#pragma unroll
        for (int i = 0; i < kEPT; ++i) {
          const float ao = __shfl_xor_sync(0xffffffffu, acc[g][i], off);
          acc[g][i] = acc[g][i] * a + ao * c2;
        }
        m[g] = mx;
      }
    }
    if (lane < tpt) {
#pragma unroll
      for (int g = 0; g < GW; ++g) {
#pragma unroll
        for (int i = 0; i < kEPT; ++i)
          red_acc[(warp * kMaxGW + g) * D + dim_of<KV>(ig, i, D)] = acc[g][i];
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int g = 0; g < GW; ++g) {
        red_m[warp * kMaxGW + g] = m[g];
        red_l[warp * kMaxGW + g] = l[g];
      }
    }
  }
  __syncthreads();

  const size_t part = (size_t)bk * p.S + split;
  for (int e = tid; e < G * D; e += kThreads) {
    const int g = e / D, d = e - (e / D) * D;
    const int w0 = (g / GW) * TW, gl = g % GW;
    float mx = kNegInf;
    for (int t = 0; t < TW; ++t) mx = fmaxf(mx, red_m[(w0 + t) * kMaxGW + gl]);
    float lsum = 0.f, a = 0.f;
    for (int t = 0; t < TW; ++t) {
      const int w = (w0 + t) * kMaxGW + gl;
      const float f = exp2f((red_m[w] - mx) * kLog2e);
      lsum = fmaf(red_l[w], f, lsum);
      a = fmaf(red_acc[w * D + d], f, a);
    }
    if (p.S == 1) {
      write_out(p.out, p.q_bf16, ((size_t)b * p.H + kh * G + g) * D + d,
                a / fmaxf(lsum, 1e-30f));
    } else {
      const size_t parts = (size_t)p.B * p.KH * p.S;
      p.ws[(part * G + g) * D + d] = a;
      if (d == 0) {
        p.ws[parts * G * D + part * G + g] = mx;
        p.ws[parts * G * (D + 1) + part * G + g] = lsum;
      }
    }
  }
}

// Merge the S splits of one (sequence x kv head, head): weights
// exp(m_s - M) for M = max_s m_s, output sum_s w_s acc_s / sum_s w_s l_s.
// Below D = 128, the kThreads / D threads of a head-dim index share the
// splits among them.
__global__ void __launch_bounds__(kThreads)
    paged_attention_combine_kernel(const Params p) {
  __shared__ float red[kThreads];
  const int bk = blockIdx.x, g = blockIdx.y;
  const int b = bk / p.KH, kh = bk % p.KH;
  const int G = p.H / p.KH, D = p.D, S = p.S;
  const int tid = threadIdx.x, lane = tid & 31;
  const size_t parts = (size_t)p.B * p.KH * S;
  const float* acc = p.ws;
  const float* ms = p.ws + parts * G * D;
  const float* ls = ms + parts * G;
  const size_t base = (size_t)bk * S;

  float mx = kNegInf;
  for (int s = lane; s < S; s += 32) mx = fmaxf(mx, ms[(base + s) * G + g]);
  for (int o = 16; o > 0; o >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  float lsum = 0.f;
  for (int s = lane; s < S; s += 32)
    lsum += expf(ms[(base + s) * G + g] - mx) * ls[(base + s) * G + g];
  for (int o = 16; o > 0; o >>= 1)
    lsum += __shfl_xor_sync(0xffffffffu, lsum, o);
  const float den = fmaxf(lsum, 1e-30f);

  const size_t out0 = ((size_t)b * p.H + kh * G + g) * D;
  const int width = min(D, kThreads), nparts = kThreads / width;
  const int j0 = tid / width;
  for (int d = tid % width; d < D; d += width) {   // uniform trip count
    float a = 0.f;
    for (int s = j0; s < S; s += nparts)
      a = fmaf(expf(ms[(base + s) * G + g] - mx),
               acc[((base + s) * G + g) * D + d], a);
    red[tid] = a;
    __syncthreads();
    if (j0 == 0) {
      for (int j = 1; j < nparts; ++j) a += red[j * width + tid];
      write_out(p.out, p.q_bf16, out0 + d, a / den);
    }
    __syncthreads();
  }
}

template <int KV, int GW>
cudaError_t launch_split(const Params& p, cudaStream_t stream) {
  dim3 grid(p.B * p.KH, p.S);
  paged_attention_split_kernel<KV, GW>
      <<<grid, kThreads, kStages * stage_bytes(KV, p.D), stream>>>(p);
  return cudaGetLastError();
}

template <int KV>
cudaError_t launch_split_gw(const Params& p, int gw, cudaStream_t stream) {
  switch (gw) {
    case 1: return launch_split<KV, 1>(p, stream);
    case 2: return launch_split<KV, 2>(p, stream);
    case 3: return launch_split<KV, 3>(p, stream);
    case 4: return launch_split<KV, 4>(p, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block of the split kernel.
int paged_attention_smem(int kv_dtype, int D) {
  return kStages * stage_bytes(kv_dtype, D);
}

// Launch on ``stream``; returns the first non-zero cudaGetLastError() of
// the split kernel's launch and (splits > 1) the combine kernel's, else 0.
// q_dtype: 0 f32, 1 bf16; kv_dtype: the same, or 2 for int8 pages with
// (P, KH) fp32 scales.  All pointers are device pointers to contiguous
// tensors; the pools' bases are 16-byte aligned.  ws holds
// B*KH*splits*G*(D+2) floats when splits > 1 and is not read otherwise.
// D is 16, 64, 128 or 256; G = H/KH is 1 to 16; 1 <= splits <= NP.
int paged_attention_launch(int q_dtype, int kv_dtype, const void* q,
                           const void* k_pages, const void* v_pages,
                           const void* k_scales, const void* v_scales,
                           const void* block_tables, const void* lengths,
                           void* out, void* ws, int B, int H, int KH, int D,
                           int page, int NP, int splits, float scale,
                           void* stream) {
  if (B <= 0) return 0;
  if (KH <= 0 || H % KH != 0 || H / KH > 16 || page <= 0 || NP <= 0 ||
      splits < 1 || splits > NP || splits > 65535 ||
      (D != 16 && D != 64 && D != 128 && D != 256) ||
      (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  const bool pair_ok = (kv_dtype == kF32 && q_dtype == kF32) ||
                       (kv_dtype == kBF16 && q_dtype == kBF16) ||
                       (kv_dtype == kI8 && (q_dtype == kF32 || q_dtype == kBF16));
  if (!pair_ok) return (int)cudaErrorInvalidValue;
  const int G = H / KH;
  const int groups = G <= 4 ? 1 : G <= 8 ? 2 : 4;
  Params p{q, k_pages, v_pages, static_cast<const float*>(k_scales),
           static_cast<const float*>(v_scales),
           static_cast<const int32_t*>(block_tables),
           static_cast<const int32_t*>(lengths), out,
           static_cast<float*>(ws), q_dtype == kBF16, B, H, KH, D, page, NP,
           splits, groups, scale};
  const int gw = (G + groups - 1) / groups;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = kv_dtype == kF32    ? launch_split_gw<kF32>(p, gw, s)
                  : kv_dtype == kBF16 ? launch_split_gw<kBF16>(p, gw, s)
                                      : launch_split_gw<kI8>(p, gw, s);
  if (e != cudaSuccess || splits == 1) return (int)e;
  paged_attention_combine_kernel<<<dim3(B * KH, G), kThreads, 0, s>>>(p);
  return (int)cudaGetLastError();
}

const char* paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

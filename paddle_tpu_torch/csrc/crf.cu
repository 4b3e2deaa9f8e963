// Linear-chain CRF for Hopper (sm_90a), f32: the partition function's
// forward recursion, its analytic backward, and the Viterbi decode.
//
// Replaces
// - crf_alpha_fwd: the TPU kernel paddle_tpu/ops/crf.py:_crf_kernel (its
//   pallas_call in _crf_alphas_pallas) with the log Z epilogue of _crf_fwd;
// - crf_bwd: the backward paddle_tpu/ops/crf.py:_crf_bwd, a lax.scan over
//   the saved alphas in JAX (beta recursion, unary and pairwise
//   marginals);
// - crf_viterbi: the decode paddle_tpu/layers/chain.py:crf_decode, a
//   lax.scan in JAX, the tagger's serving path.
//
// Shapes: x [B, T, C] emission scores, mask [B, T] (1 = real step), trans
// [C, C] (trans[prev, next]), a, b [C] the start and end potentials. The
// forward computes, per sequence,
//
//   alpha_0 = a + x_0
//   alpha_t = log(max(s, 1e-37)) + m + tm + x_t   where mask_t > 0,
//             alpha_{t-1}                          elsewhere,
//     m = max_i alpha_{t-1}[i],  tm = max(trans),
//     s = exp(alpha_{t-1} - m) @ exp(trans - tm)
//   log Z = logsumexp(alpha_{T-1} + b)
//
// with the additions in crf_log_z_ref's order. The TPU pads C to 128 lanes
// with -inf scores, which are exact zeros of the exp-space product; here
// the class axis is not padded and the numbers are the same.
//
// Design. The CRF is a chain of T dependent steps over a tiny class axis
// (C = 23 for CoNLL-2000 chunking: exp(trans - tm) is 2.1 KB). So each
// kernel runs the whole time loop inside one launch, one warp per
// sequence, kWarps sequences per block; lane j owns classes j + 32 k, k <
// P, with P = ceil(C / 32) rounded up to 1, 2, 3, 4, 6 or 8 (a template
// parameter; a lane skips its classes past C, so P changes no number).
// The block computes tm = max(trans) and exp(trans - tm) into shared
// memory itself (no host read of tm, no extra launch); the per-step
// max and sum over classes are warp shuffles (a xor butterfly, so every
// lane holds the same bits); the [C] x [C, C] product is each lane's loop
// over the previous step's values, which the warp shares through a
// per-warp shared-memory row. Shared matrices use an odd row stride
// (C | 1), so lanes reading a row or a column hit distinct banks. Each
// time loop loads the next step's mask and rows into registers a step
// ahead, so their global-memory latency overlaps the step's arithmetic
// instead of lengthening the chain. expf and logf are the accurate ones
// (no --use_fast_math).
//
// The backward walks t = T-1 .. 1 with the beta recursion (frozen on
// padding), writing dx = g * q * mask per step, and adds the pairwise
// marginals exp(min(alpha_{t-1}[i] + trans[i, j] + x_t[j] + beta_t[j]
// - log Z, 30)) * mask_t * mask_{t-1} * g into a per-warp [C, C]
// accumulator in shared memory. It writes per-sequence partials of dtrans
// [B, C, C], da and db [B, C]; the wrapper sums them over B. No float
// atomics: two runs give the same bits.
//
// The Viterbi forward keeps max-plus scores in registers and writes the
// back-pointers to a global [B, T, C] scratch (identity on padded steps);
// the final argmax is a warp reduction and lane 0 backtracks. Scores add
// in crf_decode's order (alpha_i + trans_ij, max over i, then + x_j) and
// ties take the first index, as jnp.argmax and torch.argmax do, so the
// paths equal the plain version's exactly.
//
// Bound on the H100 (SXM, 700 W), at the tagger's shape B = 64, T = 80,
// C = 23: the forward moves x and the alphas once (2 x 471 KB) and does
// ~2 C^2 + 10 C operations per step and sequence (6.6 MFLOP), so its bound
// is ~0.3 us, by bytes. The kernel cannot come near it: each sequence is
// a chain of 80 dependent steps (shuffles, a 23-term sum, expf and logf),
// so its time is the latency of that chain, and only 64 warps are busy.
//
// Large C. The backward's shared memory holds exp(trans - tm), trans and
// kWarps [C, C] accumulators: 224 KB at C = 97 of the 227 KB a block may
// hold; the forward's and the Viterbi's hold one [C, C] matrix, full at
// C = 239. Where a kernel's matrices do not fit (the template's kSmem is
// false), they stay in global memory, where the two [C, C] matrices (256
// KB each at C = 256) sit in the 50 MB L2: a small prep kernel launched
// just before, on the same stream, writes tm, exp(trans - tm) and its
// transpose (so that a lane owning row i of the beta product reads a
// coalesced column), the kernels read trans itself, and the backward
// accumulates the pairwise marginals straight into its own sequence's
// partial dtrans_part[b] (each (b, i, j) owned by one lane: still no
// float atomics, two runs bit-equal). The products and sums run in the
// same order on both paths, so they give the same bits. The forward and
// the backward take the global path exactly when the caller passes the
// scratch `work` (crf_work_floats: at the C where they must), so the two
// paths can be timed against each other at one C. chip_smoke.py phase 6
// does, at every C where both run: on the H100 the shared-memory path was
// 20-69 % faster (PERF.md), which is why both stay.
//
// Limits: C <= kMaxClasses (256: 8 classes per lane). The wrapper refuses
// larger C.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kWarps = 4;                 // sequences per block
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxPerLane = 8;            // classes per lane
constexpr int kMaxClasses = 32 * kMaxPerLane;
constexpr size_t kMaxSmem = 232448;       // a block's 227 KB
constexpr int kPrepThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Block-wide: tm = max(trans); e_s = exp(trans - tm) and, if tr_s is
// given, tr_s = trans, both [C, ld] in shared memory. Every thread of the
// block must call it (it holds two barriers).
__device__ float load_transitions(const float* __restrict__ trans, int C,
                                  int ld, float* e_s, float* tr_s,
                                  float* red_s) {
  float m = -INFINITY;
  for (int k = threadIdx.x; k < C * C; k += kThreads) m = fmaxf(m, trans[k]);
  m = warp_max(m);
  if ((threadIdx.x & 31) == 0) red_s[threadIdx.x >> 5] = m;
  __syncthreads();
  float tm = red_s[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) tm = fmaxf(tm, red_s[w]);
  for (int k = threadIdx.x; k < C * C; k += kThreads) {
    const int i = k / C, j = k - i * C;
    e_s[i * ld + j] = expf(trans[k] - tm);
    if (tr_s != nullptr) tr_s[i * ld + j] = trans[k];
  }
  __syncthreads();
  return tm;
}

// The global-memory path's matrices, one block: work[0] = tm = max(trans),
// work[1 ..] = exp(trans - tm) [C, C], then its transpose [C, C].
__global__ void __launch_bounds__(kPrepThreads)
crf_prep_kernel(const float* __restrict__ trans, float* __restrict__ work,
                int C) {
  __shared__ float red_s[kPrepThreads / 32];
  float m = -INFINITY;
  for (int k = threadIdx.x; k < C * C; k += kPrepThreads)
    m = fmaxf(m, trans[k]);
  m = warp_max(m);
  if ((threadIdx.x & 31) == 0) red_s[threadIdx.x >> 5] = m;
  __syncthreads();
  float tm = red_s[0];
  for (int w = 1; w < kPrepThreads / 32; ++w) tm = fmaxf(tm, red_s[w]);
  float* e = work + 1;
  float* et = e + static_cast<size_t>(C) * C;
  for (int k = threadIdx.x; k < C * C; k += kPrepThreads) {
    const int i = k / C, j = k - i * C;
    const float v = expf(trans[k] - tm);
    e[k] = v;
    et[j * C + i] = v;
  }
  if (threadIdx.x == 0) work[0] = tm;
}

// v[k] = row[lane + 32 k] for the classes this lane owns (0 past C).
template <int P>
__device__ __forceinline__ void load_row(float (&v)[P],
                                         const float* __restrict__ row,
                                         int lane, int C) {
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int j = lane + 32 * k;
    v[k] = j < C ? row[j] : 0.f;
  }
}

// P classes per lane; kSmem: exp(trans - tm) in shared memory (computed by
// the block), else in global memory (work, from crf_prep_kernel).
template <int P, bool kSmem>
__global__ void __launch_bounds__(kThreads)
crf_alpha_fwd_kernel(const float* __restrict__ x,      // [B, T, C]
                     const float* __restrict__ mask,   // [B, T]
                     const float* __restrict__ trans,  // [C, C]
                     const float* __restrict__ a,      // [C]
                     const float* __restrict__ bend,   // [C]
                     const float* __restrict__ work,   // prep, !kSmem
                     float* __restrict__ alphas,       // [B, T, C]
                     float* __restrict__ log_z,        // [B]
                     int B, int T, int C) {
  extern __shared__ float smem[];
  const int ld = kSmem ? (C | 1) : C;
  float* e_s = smem;                                 // [C, ld] if kSmem
  float* p_s = smem + (kSmem ? C * ld : 0);          // [kWarps, C]
  float* red_s = p_s + kWarps * C;                   // [kWarps]
  float tm;
  const float* e;
  if (kSmem) {
    tm = load_transitions(trans, C, ld, e_s, nullptr, red_s);
    e = e_s;
  } else {
    tm = work[0];
    e = work + 1;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= B) return;  // no barrier follows
  float* p = p_s + warp * C;
  const float* xb = x + static_cast<size_t>(b) * T * C;
  const float* mb = mask + static_cast<size_t>(b) * T;
  float* ab = alphas + static_cast<size_t>(b) * T * C;

  float alpha[P];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int j = lane + 32 * k;
    alpha[k] = j < C ? a[j] + xb[j] : -INFINITY;
    if (j < C) ab[j] = alpha[k];
  }
  // the next step's mask and emissions are loaded a step ahead, so their
  // latency overlaps this step's arithmetic instead of adding to the chain
  float m_next = 0.f, x_next[P] = {};
  if (T > 1) {
    m_next = mb[1];
    load_row(x_next, xb + C, lane, C);
  }
  for (int t = 1; t < T; ++t) {
    const float m_t = m_next;
    float x_t[P];
#pragma unroll
    for (int k = 0; k < P; ++k) x_t[k] = x_next[k];
    if (t + 1 < T) {
      m_next = mb[t + 1];
      load_row(x_next, xb + static_cast<size_t>(t + 1) * C, lane, C);
    }
    if (m_t > 0.f) {  // warp-uniform
      float m = -INFINITY;
#pragma unroll
      for (int k = 0; k < P; ++k) m = fmaxf(m, alpha[k]);
      m = warp_max(m);
#pragma unroll
      for (int k = 0; k < P; ++k) {
        const int j = lane + 32 * k;
        if (j < C) p[j] = expf(alpha[k] - m);
      }
      __syncwarp();
#pragma unroll
      for (int k = 0; k < P; ++k) {
        const int j = lane + 32 * k;
        if (j < C) {
          float s = 0.f;
#pragma unroll 4
          for (int i = 0; i < C; ++i) s += p[i] * e[i * ld + j];
          alpha[k] = logf(fmaxf(s, 1e-37f)) + m + tm + x_t[k];
        }
      }
      __syncwarp();  // p is rewritten next step
    }
    float* at = ab + static_cast<size_t>(t) * C;
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const int j = lane + 32 * k;
      if (j < C) at[j] = alpha[k];
    }
  }
  float v[P];
  float m = -INFINITY;
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int j = lane + 32 * k;
    v[k] = j < C ? alpha[k] + bend[j] : -INFINITY;
    m = fmaxf(m, v[k]);
  }
  m = warp_max(m);
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < P; ++k) {
    if (lane + 32 * k < C) s += expf(v[k] - m);
  }
  s = warp_sum(s);
  if (lane == 0) log_z[b] = m + logf(s);
}

template <int P, bool kSmem>
__global__ void __launch_bounds__(kThreads)
crf_bwd_kernel(const float* __restrict__ x,        // [B, T, C]
               const float* __restrict__ mask,     // [B, T]
               const float* __restrict__ trans,    // [C, C]
               const float* __restrict__ bend,     // [C]
               const float* __restrict__ alphas,   // [B, T, C]
               const float* __restrict__ log_z,    // [B]
               const float* __restrict__ g,        // [B], d loss / d log Z
               const float* __restrict__ work,     // prep, !kSmem
               float* __restrict__ dx,             // [B, T, C]
               float* __restrict__ dtrans_part,    // [B, C, C]
               float* __restrict__ da_part,        // [B, C]
               float* __restrict__ db_part,        // [B, C]
               int B, int T, int C) {
  extern __shared__ float smem[];
  // kSmem: exp(trans - tm), trans and the kWarps dtrans sums [C, ld] in
  // shared memory; else the matrices in global memory (row i of exp(trans
  // - tm) read as a column of its transpose) and each warp's sums in its
  // own sequence's dtrans_part[b]
  const int ld = kSmem ? (C | 1) : C;
  const size_t mat = kSmem ? static_cast<size_t>(C) * ld : 0;
  float* e_s = smem;                      // [C, ld] exp(trans - tm)
  float* tr_s = e_s + mat;                // [C, ld] trans
  float* acc_s = tr_s + mat;              // [kWarps, C, ld] dtrans sums
  float* v_s = acc_s + kWarps * mat;      // [kWarps, C] alpha_{t-1}
  float* p_s = v_s + kWarps * C;          // [kWarps, C] exp(y - m)
  float* red_s = p_s + kWarps * C;        // [kWarps]
  float tm;
  const float* tr;
  if (kSmem) {
    tm = load_transitions(trans, C, ld, e_s, tr_s, red_s);
    tr = tr_s;
  } else {
    tm = work[0];
    tr = trans;
  }
  const float* et = work + 1 + static_cast<size_t>(C) * C;  // !kSmem
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= B) return;  // no barrier follows
  float* acc = kSmem ? acc_s + warp * mat
                     : dtrans_part + static_cast<size_t>(b) * C * C;
  float* v = v_s + warp * C;
  float* p = p_s + warp * C;
  const size_t tc = static_cast<size_t>(T) * C;
  const float* xb = x + b * tc;
  const float* mb = mask + static_cast<size_t>(b) * T;
  const float* ab = alphas + b * tc;
  float* dxb = dx + b * tc;
  const float lz = log_z[b];
  const float gb = g[b];

  float beta[P];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int j = lane + 32 * k;
    beta[k] = j < C ? bend[j] : 0.f;
    if (j < C) {
      for (int i = 0; i < C; ++i) acc[i * ld + j] = 0.f;
    }
  }
  // step t reads alpha_t, x_t, alpha_{t-1}, mask_t and mask_{t-1}; the
  // next step's x_{t-1}, alpha_{t-2} and mask_{t-2} are loaded a step
  // ahead (alpha_{t-1} and mask_{t-1} carry over)
  float a_t[P], x_t[P], a_p[P] = {}, a_last[P];
  load_row(a_t, ab + static_cast<size_t>(T - 1) * C, lane, C);
  load_row(x_t, xb + static_cast<size_t>(T - 1) * C, lane, C);
  float m_t = mb[T - 1], m_p = 0.f;
  if (T > 1) {
    m_p = mb[T - 2];
    load_row(a_p, ab + static_cast<size_t>(T - 2) * C, lane, C);
  }
#pragma unroll
  for (int k = 0; k < P; ++k) a_last[k] = a_t[k];
  for (int t = T - 1; t >= 1; --t) {
    float x_n[P], a_n[P] = {}, m_n = 0.f;
    load_row(x_n, xb + static_cast<size_t>(t - 1) * C, lane, C);
    if (t >= 2) {
      m_n = mb[t - 2];
      load_row(a_n, ab + static_cast<size_t>(t - 2) * C, lane, C);
    }
    const float pair = m_t * m_p;
    float r[P];
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const int j = lane + 32 * k;
      r[k] = -INFINITY;
      if (j < C) {
        const float q = expf(a_t[k] + beta[k] - lz) * m_t;
        dxb[static_cast<size_t>(t) * C + j] = gb * q;
        r[k] = x_t[k] + beta[k];
        v[j] = a_p[k];  // alpha_{t-1}
      }
    }
    __syncwarp();
    if (pair > 0.f) {  // warp-uniform: pairwise marginals of (t-1, t)
      const float w = pair * gb;
#pragma unroll
      for (int k = 0; k < P; ++k) {
        const int j = lane + 32 * k;
        if (j < C) {
#pragma unroll 4
          for (int i = 0; i < C; ++i) {
            const float s = v[i] + tr[i * ld + j] + r[k] - lz;
            acc[i * ld + j] += expf(fminf(s, 30.f)) * w;
          }
        }
      }
    }
    if (m_t > 0.f) {  // warp-uniform: beta_{t-1} from beta_t
      float m = -INFINITY;
#pragma unroll
      for (int k = 0; k < P; ++k) m = fmaxf(m, r[k]);
      m = warp_max(m);
#pragma unroll
      for (int k = 0; k < P; ++k) {
        const int j = lane + 32 * k;
        if (j < C) p[j] = expf(r[k] - m);
      }
      __syncwarp();
#pragma unroll
      for (int k = 0; k < P; ++k) {
        const int i = lane + 32 * k;  // this lane's row of trans
        if (i < C) {
          float s = 0.f;
#pragma unroll 4
          for (int j = 0; j < C; ++j)
            s += p[j] * (kSmem ? e_s[i * ld + j] : et[j * C + i]);
          beta[k] = logf(fmaxf(s, 1e-37f)) + m + tm;
        }
      }
    }
    __syncwarp();  // v and p are rewritten next step
#pragma unroll
    for (int k = 0; k < P; ++k) {
      a_t[k] = a_p[k];
      x_t[k] = x_n[k];
      a_p[k] = a_n[k];
    }
    m_t = m_p;
    m_p = m_n;
  }
  // here a_t is alpha_0 and m_t is mask_0
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int j = lane + 32 * k;
    if (j < C) {
      const float q0 = expf(a_t[k] + beta[k] - lz) * m_t;
      dxb[j] = gb * q0;
      da_part[static_cast<size_t>(b) * C + j] = gb * q0;
      db_part[static_cast<size_t>(b) * C + j] =
          gb * expf(a_last[k] + bend[j] - lz);
      if (kSmem) {
        float* dtb = dtrans_part + static_cast<size_t>(b) * C * C;
        for (int i = 0; i < C; ++i) dtb[i * C + j] = acc[i * ld + j];
      }
    }
  }
}

template <int P, bool kSmem>
__global__ void __launch_bounds__(kThreads)
crf_viterbi_kernel(const float* __restrict__ x,      // [B, T, C]
                   const float* __restrict__ mask,   // [B, T]
                   const float* __restrict__ trans,  // [C, C]
                   const float* __restrict__ a,      // [C]
                   const float* __restrict__ bend,   // [C]
                   int* __restrict__ ptr,            // [B, T, C] scratch
                   int* __restrict__ path,           // [B, T]
                   float* __restrict__ score,        // [B]
                   int B, int T, int C) {
  extern __shared__ float smem[];
  const int ld = kSmem ? (C | 1) : C;
  float* tr_s = smem;                                // [C, ld] if kSmem
  float* v_s = smem + (kSmem ? C * ld : 0);          // [kWarps, C]
  const float* tr = trans;
  if (kSmem) {
    for (int k = threadIdx.x; k < C * C; k += kThreads) {
      const int i = k / C;
      tr_s[i * ld + k - i * C] = trans[k];
    }
    __syncthreads();
    tr = tr_s;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= B) return;  // no barrier follows
  float* v = v_s + warp * C;
  const size_t tc = static_cast<size_t>(T) * C;
  const float* xb = x + b * tc;
  const float* mb = mask + static_cast<size_t>(b) * T;
  int* pb = ptr + b * tc;

  float alpha[P];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int j = lane + 32 * k;
    alpha[k] = j < C ? a[j] + xb[j] : -INFINITY;
  }
  float m_next = 0.f, x_next[P] = {};  // one step ahead
  if (T > 1) {
    m_next = mb[1];
    load_row(x_next, xb + C, lane, C);
  }
  for (int t = 1; t < T; ++t) {
    const float m_t = m_next;
    float x_t[P];
#pragma unroll
    for (int k = 0; k < P; ++k) x_t[k] = x_next[k];
    if (t + 1 < T) {
      m_next = mb[t + 1];
      load_row(x_next, xb + static_cast<size_t>(t + 1) * C, lane, C);
    }
    int* pt = pb + static_cast<size_t>(t) * C;
    if (m_t > 0.f) {  // warp-uniform
#pragma unroll
      for (int k = 0; k < P; ++k) {
        const int j = lane + 32 * k;
        if (j < C) v[j] = alpha[k];
      }
      __syncwarp();
#pragma unroll
      for (int k = 0; k < P; ++k) {
        const int j = lane + 32 * k;
        if (j < C) {
          float best = -INFINITY;
          int arg = 0;
#pragma unroll 4
          for (int i = 0; i < C; ++i) {
            const float s = v[i] + tr[i * ld + j];
            if (s > best) {  // the first index among equal maxima
              best = s;
              arg = i;
            }
          }
          alpha[k] = best + x_t[k];
          pt[j] = arg;
        }
      }
      __syncwarp();  // v is rewritten next step
    } else {
#pragma unroll
      for (int k = 0; k < P; ++k) {
        const int j = lane + 32 * k;
        if (j < C) pt[j] = j;  // padded step: state j came from j
      }
    }
  }
  float best = -INFINITY;
  int arg = 0;
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int j = lane + 32 * k;
    if (j < C) {
      const float f = alpha[k] + bend[j];
      if (f > best) {
        best = f;
        arg = j;
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ob = __shfl_xor_sync(kFull, best, o);
    const int oa = __shfl_xor_sync(kFull, arg, o);
    if (ob > best || (ob == best && oa < arg)) {
      best = ob;
      arg = oa;
    }
  }
  __syncwarp();  // every lane's pointers are visible to lane 0
  if (lane == 0) {
    int* yb = path + static_cast<size_t>(b) * T;
    int state = arg;
    yb[T - 1] = state;
    for (int t = T - 1; t >= 1; --t) {
      state = pb[static_cast<size_t>(t) * C + state];
      yb[t - 1] = state;
    }
    score[b] = best;
  }
}

// Shared memory of each kernel with its matrices in it (kSmem) or not.
size_t fwd_smem(int C, bool in_smem) {
  const size_t mat = in_smem ? static_cast<size_t>(C) * (C | 1) : 0;
  return sizeof(float) * (mat + kWarps * C + kWarps);
}

size_t bwd_smem(int C, bool in_smem) {
  const size_t mat = in_smem ? static_cast<size_t>(C) * (C | 1) : 0;
  return sizeof(float) * ((2 + kWarps) * mat + 2 * kWarps * C + kWarps);
}

size_t viterbi_smem(int C, bool in_smem) {
  const size_t mat = in_smem ? static_cast<size_t>(C) * (C | 1) : 0;
  return sizeof(float) * (mat + kWarps * C);
}

// Raises the kernel's dynamic shared memory limit when it needs more than
// the default 48 KB.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

bool bad_shape(int B, int T, int C) {
  return B < 0 || T < 1 || C < 1 || C > kMaxClasses;
}

// Classes per lane: ceil(C / 32) rounded up to an instantiated count.
int per_lane(int C) {
  const int p = (C + 31) / 32;
  return p <= 4 ? p : (p <= 6 ? 6 : 8);
}

// The Viterbi's global-memory variant exists where C > 96 (P >= 4): below
// that its matrix fits a block's shared memory.
template <int P>
constexpr bool kHasGlobal = P >= 4;

// Launches crf_prep_kernel when a kernel keeps its matrices in global
// memory.
cudaError_t prep(const float* trans, float* work, int C, cudaStream_t s) {
  crf_prep_kernel<<<1, kPrepThreads, 0, s>>>(trans, work, C);
  return cudaGetLastError();
}

template <int P, bool kSmem>
int launch_fwd(const float* x, const float* mask, const float* trans,
               const float* a, const float* b, float* work, float* alphas,
               float* log_z, int B, int T, int C, cudaStream_t s) {
  const size_t smem = fwd_smem(C, kSmem);
  cudaError_t err = allow_smem(crf_alpha_fwd_kernel<P, kSmem>, smem);
  if (err == cudaSuccess && !kSmem) err = prep(trans, work, C, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  crf_alpha_fwd_kernel<P, kSmem><<<(B + kWarps - 1) / kWarps, kThreads, smem,
                                   s>>>(x, mask, trans, a, b, work, alphas,
                                        log_z, B, T, C);
  return static_cast<int>(cudaGetLastError());
}

// The forward and the backward keep their matrices in global memory when
// the caller passes `work` (crf_work_floats says at which C they must; a
// caller may pass it where they would fit, to time the two paths), in
// shared memory when it passes a null pointer.
template <int P>
int fwd_p(const float* x, const float* mask, const float* trans,
          const float* a, const float* b, float* work, float* alphas,
          float* log_z, int B, int T, int C, cudaStream_t s) {
  if (work != nullptr)
    return launch_fwd<P, false>(x, mask, trans, a, b, work, alphas, log_z,
                                B, T, C, s);
  if (fwd_smem(C, true) > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_fwd<P, true>(x, mask, trans, a, b, work, alphas, log_z, B,
                             T, C, s);
}

template <int P, bool kSmem>
int launch_bwd(const float* x, const float* mask, const float* trans,
               const float* bend, const float* alphas, const float* log_z,
               const float* g, float* work, float* dx, float* dtrans_part,
               float* da_part, float* db_part, int B, int T, int C,
               cudaStream_t s) {
  const size_t smem = bwd_smem(C, kSmem);
  cudaError_t err = allow_smem(crf_bwd_kernel<P, kSmem>, smem);
  if (err == cudaSuccess && !kSmem) err = prep(trans, work, C, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  crf_bwd_kernel<P, kSmem><<<(B + kWarps - 1) / kWarps, kThreads, smem, s>>>(
      x, mask, trans, bend, alphas, log_z, g, work, dx, dtrans_part, da_part,
      db_part, B, T, C);
  return static_cast<int>(cudaGetLastError());
}

template <int P>
int bwd_p(const float* x, const float* mask, const float* trans,
          const float* bend, const float* alphas, const float* log_z,
          const float* g, float* work, float* dx, float* dtrans_part,
          float* da_part, float* db_part, int B, int T, int C,
          cudaStream_t s) {
  if (work != nullptr)
    return launch_bwd<P, false>(x, mask, trans, bend, alphas, log_z, g,
                                work, dx, dtrans_part, da_part, db_part, B,
                                T, C, s);
  if (bwd_smem(C, true) > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_bwd<P, true>(x, mask, trans, bend, alphas, log_z, g, work,
                             dx, dtrans_part, da_part, db_part, B, T, C, s);
}

template <int P, bool kSmem>
int launch_viterbi(const float* x, const float* mask, const float* trans,
                   const float* a, const float* b, int* ptr, int* path,
                   float* score, int B, int T, int C, cudaStream_t s) {
  const size_t smem = viterbi_smem(C, kSmem);
  cudaError_t err = allow_smem(crf_viterbi_kernel<P, kSmem>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  crf_viterbi_kernel<P, kSmem><<<(B + kWarps - 1) / kWarps, kThreads, smem,
                                 s>>>(x, mask, trans, a, b, ptr, path, score,
                                      B, T, C);
  return static_cast<int>(cudaGetLastError());
}

template <int P>
int viterbi_p(const float* x, const float* mask, const float* trans,
              const float* a, const float* b, int* ptr, int* path,
              float* score, int B, int T, int C, cudaStream_t s) {
  if constexpr (kHasGlobal<P>) {
    if (viterbi_smem(C, true) > kMaxSmem)
      return launch_viterbi<P, false>(x, mask, trans, a, b, ptr, path, score,
                                      B, T, C, s);
  }
  return launch_viterbi<P, true>(x, mask, trans, a, b, ptr, path, score, B,
                                 T, C, s);
}

}  // namespace

// The entries below launch on `stream` (the kernel, after crf_prep_kernel
// where the matrices stay in global memory), allocate nothing and do not
// synchronise. Each returns the launch error (cudaError_t as int), 0 when
// the launches were accepted; cudaErrorInvalidValue for a shape the
// kernels do not take (T < 1, C < 1 or C > kMaxClasses, or a null `work`
// where the matrices do not fit shared memory). `work` is scratch of
// 2 C^2 + 1 floats, or null (see fwd_p).

#define CRF_DISPATCH(fn, ...)                        \
  switch (per_lane(C)) {                             \
    case 1: return fn<1>(__VA_ARGS__);               \
    case 2: return fn<2>(__VA_ARGS__);               \
    case 3: return fn<3>(__VA_ARGS__);               \
    case 4: return fn<4>(__VA_ARGS__);               \
    case 6: return fn<6>(__VA_ARGS__);               \
    default: return fn<8>(__VA_ARGS__);              \
  }

// Floats of `work` that the forward (kernel 0) or the backward (1) needs
// at C: 2 C^2 + 1 where its matrices outgrow a block's shared memory,
// else 0 (pass a null pointer).
extern "C" int crf_work_floats(int kernel, int C) {
  if (C < 1 || C > kMaxClasses) return 0;
  const size_t need = kernel == 0 ? fwd_smem(C, true) : bwd_smem(C, true);
  return need > kMaxSmem ? 2 * C * C + 1 : 0;
}

// alphas [B, T, C] (alpha_0 at t = 0) and log_z [B].
extern "C" int crf_alpha_fwd(const float* x, const float* mask,
                             const float* trans, const float* a,
                             const float* b, float* work, float* alphas,
                             float* log_z, int B, int T, int C,
                             void* stream) {
  if (bad_shape(B, T, C)) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CRF_DISPATCH(fwd_p, x, mask, trans, a, b, work, alphas, log_z, B, T, C, s)
}

// dx [B, T, C] and the per-sequence partials dtrans_part [B, C, C],
// da_part [B, C], db_part [B, C] of d(sum_b g_b log Z_b).
extern "C" int crf_bwd(const float* x, const float* mask, const float* trans,
                       const float* b, const float* alphas,
                       const float* log_z, const float* g, float* work,
                       float* dx, float* dtrans_part, float* da_part,
                       float* db_part, int B, int T, int C, void* stream) {
  if (bad_shape(B, T, C)) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CRF_DISPATCH(bwd_p, x, mask, trans, b, alphas, log_z, g, work, dx,
               dtrans_part, da_part, db_part, B, T, C, s)
}

// path [B, T] (int32) and score [B]; ptr [B, T, C] is int32 scratch.
extern "C" int crf_viterbi(const float* x, const float* mask,
                           const float* trans, const float* a, const float* b,
                           int* ptr, int* path, float* score, int B, int T,
                           int C, void* stream) {
  if (bad_shape(B, T, C)) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CRF_DISPATCH(viterbi_p, x, mask, trans, a, b, ptr, path, score, B, T, C, s)
}

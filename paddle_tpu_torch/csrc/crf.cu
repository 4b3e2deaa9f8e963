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
// sequence, kWarps sequences per block; lane j owns classes j, j + 32,
// j + 64. The block computes tm = max(trans) and exp(trans - tm) into
// shared memory itself (no host read of tm, no extra launch); the per-step
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
// Limits: C <= kMaxClasses (96), set by the per-lane registers and by the
// backward's shared memory (exp(trans - tm), trans and kWarps [C, C]
// accumulators: 226 KB at C = 96 of the 227 KB a block may hold). The
// wrapper refuses larger C.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kWarps = 4;                 // sequences per block
constexpr int kThreads = 32 * kWarps;
constexpr int kPerLane = 3;               // classes per lane
constexpr int kMaxClasses = 32 * kPerLane;
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

// v[k] = row[lane + 32 k] for the classes this lane owns (0 past C).
__device__ __forceinline__ void load_row(float (&v)[kPerLane],
                                         const float* __restrict__ row,
                                         int lane, int C) {
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    const int j = lane + 32 * k;
    v[k] = j < C ? row[j] : 0.f;
  }
}

__global__ void __launch_bounds__(kThreads)
crf_alpha_fwd_kernel(const float* __restrict__ x,      // [B, T, C]
                     const float* __restrict__ mask,   // [B, T]
                     const float* __restrict__ trans,  // [C, C]
                     const float* __restrict__ a,      // [C]
                     const float* __restrict__ bend,   // [C]
                     float* __restrict__ alphas,       // [B, T, C]
                     float* __restrict__ log_z,        // [B]
                     int B, int T, int C) {
  extern __shared__ float smem[];
  const int ld = C | 1;
  float* e_s = smem;                    // [C, ld]
  float* p_s = e_s + C * ld;            // [kWarps, C]
  float* red_s = p_s + kWarps * C;      // [kWarps]
  const float tm = load_transitions(trans, C, ld, e_s, nullptr, red_s);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= B) return;  // no barrier follows
  float* p = p_s + warp * C;
  const float* xb = x + static_cast<size_t>(b) * T * C;
  const float* mb = mask + static_cast<size_t>(b) * T;
  float* ab = alphas + static_cast<size_t>(b) * T * C;

  float alpha[kPerLane];
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    const int j = lane + 32 * k;
    alpha[k] = j < C ? a[j] + xb[j] : -INFINITY;
    if (j < C) ab[j] = alpha[k];
  }
  // the next step's mask and emissions are loaded a step ahead, so their
  // latency overlaps this step's arithmetic instead of adding to the chain
  float m_next = 0.f, x_next[kPerLane] = {};
  if (T > 1) {
    m_next = mb[1];
    load_row(x_next, xb + C, lane, C);
  }
  for (int t = 1; t < T; ++t) {
    const float m_t = m_next;
    float x_t[kPerLane];
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) x_t[k] = x_next[k];
    if (t + 1 < T) {
      m_next = mb[t + 1];
      load_row(x_next, xb + static_cast<size_t>(t + 1) * C, lane, C);
    }
    if (m_t > 0.f) {  // warp-uniform
      float m = -INFINITY;
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) m = fmaxf(m, alpha[k]);
      m = warp_max(m);
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) {
        const int j = lane + 32 * k;
        if (j < C) p[j] = expf(alpha[k] - m);
      }
      __syncwarp();
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) {
        const int j = lane + 32 * k;
        if (j < C) {
          float s = 0.f;
#pragma unroll 4
          for (int i = 0; i < C; ++i) s += p[i] * e_s[i * ld + j];
          alpha[k] = logf(fmaxf(s, 1e-37f)) + m + tm + x_t[k];
        }
      }
      __syncwarp();  // p is rewritten next step
    }
    float* at = ab + static_cast<size_t>(t) * C;
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const int j = lane + 32 * k;
      if (j < C) at[j] = alpha[k];
    }
  }
  float v[kPerLane];
  float m = -INFINITY;
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    const int j = lane + 32 * k;
    v[k] = j < C ? alpha[k] + bend[j] : -INFINITY;
    m = fmaxf(m, v[k]);
  }
  m = warp_max(m);
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    if (lane + 32 * k < C) s += expf(v[k] - m);
  }
  s = warp_sum(s);
  if (lane == 0) log_z[b] = m + logf(s);
}

__global__ void __launch_bounds__(kThreads)
crf_bwd_kernel(const float* __restrict__ x,        // [B, T, C]
               const float* __restrict__ mask,     // [B, T]
               const float* __restrict__ trans,    // [C, C]
               const float* __restrict__ bend,     // [C]
               const float* __restrict__ alphas,   // [B, T, C]
               const float* __restrict__ log_z,    // [B]
               const float* __restrict__ g,        // [B], d loss / d log Z
               float* __restrict__ dx,             // [B, T, C]
               float* __restrict__ dtrans_part,    // [B, C, C]
               float* __restrict__ da_part,        // [B, C]
               float* __restrict__ db_part,        // [B, C]
               int B, int T, int C) {
  extern __shared__ float smem[];
  const int ld = C | 1;
  float* e_s = smem;                      // [C, ld] exp(trans - tm)
  float* tr_s = e_s + C * ld;             // [C, ld] trans
  float* acc_s = tr_s + C * ld;           // [kWarps, C, ld] dtrans sums
  float* v_s = acc_s + kWarps * C * ld;   // [kWarps, C] alpha_{t-1}
  float* p_s = v_s + kWarps * C;          // [kWarps, C] exp(y - m)
  float* red_s = p_s + kWarps * C;        // [kWarps]
  const float tm = load_transitions(trans, C, ld, e_s, tr_s, red_s);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= B) return;  // no barrier follows
  float* acc = acc_s + warp * C * ld;
  float* v = v_s + warp * C;
  float* p = p_s + warp * C;
  const size_t tc = static_cast<size_t>(T) * C;
  const float* xb = x + b * tc;
  const float* mb = mask + static_cast<size_t>(b) * T;
  const float* ab = alphas + b * tc;
  float* dxb = dx + b * tc;
  const float lz = log_z[b];
  const float gb = g[b];

  float beta[kPerLane];
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    const int j = lane + 32 * k;
    beta[k] = j < C ? bend[j] : 0.f;
    if (j < C) {
      for (int i = 0; i < C; ++i) acc[i * ld + j] = 0.f;
    }
  }
  // step t reads alpha_t, x_t, alpha_{t-1}, mask_t and mask_{t-1}; the
  // next step's x_{t-1}, alpha_{t-2} and mask_{t-2} are loaded a step
  // ahead (alpha_{t-1} and mask_{t-1} carry over)
  float a_t[kPerLane], x_t[kPerLane], a_p[kPerLane] = {}, a_last[kPerLane];
  load_row(a_t, ab + static_cast<size_t>(T - 1) * C, lane, C);
  load_row(x_t, xb + static_cast<size_t>(T - 1) * C, lane, C);
  float m_t = mb[T - 1], m_p = 0.f;
  if (T > 1) {
    m_p = mb[T - 2];
    load_row(a_p, ab + static_cast<size_t>(T - 2) * C, lane, C);
  }
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) a_last[k] = a_t[k];
  for (int t = T - 1; t >= 1; --t) {
    float x_n[kPerLane], a_n[kPerLane] = {}, m_n = 0.f;
    load_row(x_n, xb + static_cast<size_t>(t - 1) * C, lane, C);
    if (t >= 2) {
      m_n = mb[t - 2];
      load_row(a_n, ab + static_cast<size_t>(t - 2) * C, lane, C);
    }
    const float pair = m_t * m_p;
    float r[kPerLane];
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
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
      for (int k = 0; k < kPerLane; ++k) {
        const int j = lane + 32 * k;
        if (j < C) {
#pragma unroll 4
          for (int i = 0; i < C; ++i) {
            const float s = v[i] + tr_s[i * ld + j] + r[k] - lz;
            acc[i * ld + j] += expf(fminf(s, 30.f)) * w;
          }
        }
      }
    }
    if (m_t > 0.f) {  // warp-uniform: beta_{t-1} from beta_t
      float m = -INFINITY;
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) m = fmaxf(m, r[k]);
      m = warp_max(m);
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) {
        const int j = lane + 32 * k;
        if (j < C) p[j] = expf(r[k] - m);
      }
      __syncwarp();
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) {
        const int i = lane + 32 * k;  // this lane's row of trans
        if (i < C) {
          float s = 0.f;
#pragma unroll 4
          for (int j = 0; j < C; ++j) s += p[j] * e_s[i * ld + j];
          beta[k] = logf(fmaxf(s, 1e-37f)) + m + tm;
        }
      }
    }
    __syncwarp();  // v and p are rewritten next step
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      a_t[k] = a_p[k];
      x_t[k] = x_n[k];
      a_p[k] = a_n[k];
    }
    m_t = m_p;
    m_p = m_n;
  }
  // here a_t is alpha_0 and m_t is mask_0
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    const int j = lane + 32 * k;
    if (j < C) {
      const float q0 = expf(a_t[k] + beta[k] - lz) * m_t;
      dxb[j] = gb * q0;
      da_part[static_cast<size_t>(b) * C + j] = gb * q0;
      db_part[static_cast<size_t>(b) * C + j] =
          gb * expf(a_last[k] + bend[j] - lz);
      float* dtb = dtrans_part + static_cast<size_t>(b) * C * C;
      for (int i = 0; i < C; ++i) dtb[i * C + j] = acc[i * ld + j];
    }
  }
}

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
  const int ld = C | 1;
  float* tr_s = smem;                   // [C, ld] trans
  float* v_s = tr_s + C * ld;           // [kWarps, C]
  for (int k = threadIdx.x; k < C * C; k += kThreads) {
    const int i = k / C;
    tr_s[i * ld + k - i * C] = trans[k];
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= B) return;  // no barrier follows
  float* v = v_s + warp * C;
  const size_t tc = static_cast<size_t>(T) * C;
  const float* xb = x + b * tc;
  const float* mb = mask + static_cast<size_t>(b) * T;
  int* pb = ptr + b * tc;

  float alpha[kPerLane];
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    const int j = lane + 32 * k;
    alpha[k] = j < C ? a[j] + xb[j] : -INFINITY;
  }
  float m_next = 0.f, x_next[kPerLane] = {};  // one step ahead
  if (T > 1) {
    m_next = mb[1];
    load_row(x_next, xb + C, lane, C);
  }
  for (int t = 1; t < T; ++t) {
    const float m_t = m_next;
    float x_t[kPerLane];
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) x_t[k] = x_next[k];
    if (t + 1 < T) {
      m_next = mb[t + 1];
      load_row(x_next, xb + static_cast<size_t>(t + 1) * C, lane, C);
    }
    int* pt = pb + static_cast<size_t>(t) * C;
    if (m_t > 0.f) {  // warp-uniform
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) {
        const int j = lane + 32 * k;
        if (j < C) v[j] = alpha[k];
      }
      __syncwarp();
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) {
        const int j = lane + 32 * k;
        if (j < C) {
          float best = -INFINITY;
          int arg = 0;
#pragma unroll 4
          for (int i = 0; i < C; ++i) {
            const float s = v[i] + tr_s[i * ld + j];
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
      for (int k = 0; k < kPerLane; ++k) {
        const int j = lane + 32 * k;
        if (j < C) pt[j] = j;  // padded step: state j came from j
      }
    }
  }
  float best = -INFINITY;
  int arg = 0;
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
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

size_t fwd_smem(int C) {
  return sizeof(float) * (static_cast<size_t>(C) * (C | 1) + kWarps * C
                          + kWarps);
}

size_t bwd_smem(int C) {
  return sizeof(float) * ((2 + kWarps) * static_cast<size_t>(C) * (C | 1)
                          + 2 * kWarps * C + kWarps);
}

size_t viterbi_smem(int C) {
  return sizeof(float) * (static_cast<size_t>(C) * (C | 1) + kWarps * C);
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

}  // namespace

// The entries below launch once on `stream`, allocate nothing and do not
// synchronise. Each returns the launch error (cudaError_t as int), 0 when
// the launch was accepted; cudaErrorInvalidValue for a shape the kernels
// do not take (T < 1, C < 1 or C > kMaxClasses).

// alphas [B, T, C] (alpha_0 at t = 0) and log_z [B].
extern "C" int crf_alpha_fwd(const float* x, const float* mask,
                             const float* trans, const float* a,
                             const float* b, float* alphas, float* log_z,
                             int B, int T, int C, void* stream) {
  if (bad_shape(B, T, C)) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const size_t smem = fwd_smem(C);
  cudaError_t err = allow_smem(crf_alpha_fwd_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  crf_alpha_fwd_kernel<<<(B + kWarps - 1) / kWarps, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      x, mask, trans, a, b, alphas, log_z, B, T, C);
  return static_cast<int>(cudaGetLastError());
}

// dx [B, T, C] and the per-sequence partials dtrans_part [B, C, C],
// da_part [B, C], db_part [B, C] of d(sum_b g_b log Z_b).
extern "C" int crf_bwd(const float* x, const float* mask, const float* trans,
                       const float* b, const float* alphas,
                       const float* log_z, const float* g, float* dx,
                       float* dtrans_part, float* da_part, float* db_part,
                       int B, int T, int C, void* stream) {
  if (bad_shape(B, T, C)) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const size_t smem = bwd_smem(C);
  cudaError_t err = allow_smem(crf_bwd_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  crf_bwd_kernel<<<(B + kWarps - 1) / kWarps, kThreads, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      x, mask, trans, b, alphas, log_z, g, dx, dtrans_part, da_part, db_part,
      B, T, C);
  return static_cast<int>(cudaGetLastError());
}

// path [B, T] (int32) and score [B]; ptr [B, T, C] is int32 scratch.
extern "C" int crf_viterbi(const float* x, const float* mask,
                           const float* trans, const float* a, const float* b,
                           int* ptr, int* path, float* score, int B, int T,
                           int C, void* stream) {
  if (bad_shape(B, T, C)) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const size_t smem = viterbi_smem(C);
  cudaError_t err = allow_smem(crf_viterbi_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  crf_viterbi_kernel<<<(B + kWarps - 1) / kWarps, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      x, mask, trans, a, b, ptr, path, score, B, T, C);
  return static_cast<int>(cudaGetLastError());
}

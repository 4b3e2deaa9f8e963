// Flash attention for Hopper (sm_90a), f32: the forward and the analytic
// backward (two kernels).
//
// Replaces
// - flash_fwd: the TPU kernel paddle_tpu/ops/attention.py:_flash_kernel
//   (its pallas_call in _flash_forward), plus the row statistics the
//   backward needs;
// - flash_bwd: the backward paddle_tpu/ops/attention.py:_flash_bwd, which
//   is jax.vjp of blockwise_attention in JAX (a recompute through a
//   lax.scan); here it is the FA2-style analytic backward.
//
// Shapes: q [B, N, Tq, D], k and v [B, N, Tk, D], all contiguous; mask
// [B, Tk] (> 0 = a real key, indexed by batch, not by head); o [B, N, Tq,
// D]. The forward computes, per row i of q,
//
//   s_ij = (q_i . k_j) * scale, replaced by -1e9 where mask_j <= 0 or,
//          with causal, where j > i + (Tk - Tq)
//   o_i  = sum_j exp(s_ij - m_i) v_j / l_i,  m_i = max_j s_ij,
//          l_i = sum_j exp(s_ij - m_i)
//
// by the online softmax of blockwise_attention (running m and l, the
// accumulator rescaled by exp(m_old - m_new) at each kv block), and writes
// stats [2, B*N, Tq]: stats[0] = m, stats[1] = log l. Together they are
// the row log-sum-exp m + log l; they are kept apart because a row whose
// every key is masked has m = -1e9, where m + log l rounds to -1e9 in f32
// and the backward could not recover P = 1 / l. With both terms, P_ij =
// exp((s_ij - m_i) - log l_i) is exact for such a row too.
//
// The backward takes dO and the saved q, k, v, o and stats:
//
//   delta_i = sum_d dO_id o_id
//   P_ij    = exp((s_ij - m_i) - log l_i)
//   dV_j    = sum_i P_ij dO_i
//   dS_ij   = P_ij (dO_i . v_j - delta_i), 0 where s_ij was replaced
//             (jnp.where gives a replaced score no gradient)
//   dQ_i    = scale sum_j dS_ij k_j,   dK_j = scale sum_i dS_ij q_i
//
// flash_bwd_dq runs first: one block per (b*n, query block) computes
// delta for its rows (and writes it), then loops over the kv blocks and
// accumulates dQ. flash_bwd_dkdv follows: one block per (b*n, kv block)
// loops over the query blocks and accumulates dK and dV. Every output
// element is summed by one thread in a fixed order: no float atomics, so
// two runs give the same bits.
//
// Design. Tiles of 64 query rows by 64 keys, 256 threads as 16 x 16; a
// thread owns the 4 x 4 scores (ty + 16 i, tx + 16 j) and, of a [64, D]
// accumulator, rows ty + 16 i and columns tx + 16 c. The q, k, v, dO tiles
// sit in shared memory with an odd row stride (D + 1), so the 16 threads
// of a row group reading 16 rows at one column hit 16 banks; the P and dS
// tiles likewise ([64, 65]). A score row's max and sum are xor shuffles
// over the 16 lanes of its row group (every lane gets the same bits). The
// products are f32 FMA, not TF32 tensor cores (TF32 keeps 10 mantissa
// bits and would break the 1e-4 parity with the f32 plain version).
// Key positions at or past Tk (a tile's tail) are left out of the softmax
// (never treated as masked). With causal, a query block skips the kv
// blocks that lie wholly above the diagonal of its last row (it always
// visits the block that holds that diagonal, and at least one); the
// backward skips the same pairs.
//
// Rows that see no key (every score masked: an all-padding kv row, or with
// causal and Tq > Tk the first Tq - Tk rows) follow a rule of their own.
// JAX pads Tk to Tk_pad, a multiple of min(256, Tk), with masked zero keys
// and visits every block, so on such a row every score is the -1e9 fill
// and it gets o = sum_{j<Tk} v_j / Tk_pad, m = -1e9, l = Tk_pad. Here a row
// sees no key iff its running max stays -1e9 (a visible score is above
// the fill). Rows that see a key keep the skips above. The forward divides
// such a row's sum by Tk_pad and saves (-1e9, log Tk_pad); a query block
// that holds one adds the kv blocks its causal skip left out, with P = 1
// on those rows and 0 on the others. The backward needs nothing new for
// dq (dS is 0 on every masked score) or dk; dv_j takes P_ij dO_i =
// dO_i / Tk_pad from each such row: flash_bwd_dkdv visits a skipped
// (query block, kv block) pair when the query block holds such a row, and
// there P = exp((-1e9 - m) - log l) is 1 / Tk_pad on those rows and 0 on
// the others.
//
// Shared memory per block at D = 128: forward 3 tiles + P = 116 KB, dq 4
// tiles + dS = 150 KB, dkdv 4 tiles + P + dS = 166 KB, above the default
// 48 KB: each launcher raises cudaFuncAttributeMaxDynamicSharedMemorySize.
//
// Bound on the H100 (SXM, 700 W): the forward does 4 D operations per
// visible (query, key) pair (two products), the backward 10 D (five); at
// the seq2seq path's [50, 4, 50, 128] the forward moves 20.5 MB for at
// most 0.2 GFLOP, so it is bound by bytes (~6 us); at T = 4096 by
// operations (68.7 GFLOP, ~1 ms at the f32 rate). This simple kernel
// makes one shared-memory load per two FMAs in its inner loops (an SM
// serves one warp-wide load per clock against four FMA instructions), and
// its 116-166 KB of shared memory leave one 256-thread block per SM, so it
// stays well short of the operations bound; register tiles fed by vector
// loads, wgmma, TMA and lower precision are later work.
//
// Limits: D in {8, 16, 32, 64, 128} (template instances; the wrapper pads
// any other D <= 128 with zero columns up to the next instance and refuses
// D > 128), B * N <= 65535 (the grid's y).

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kBlock = 64;              // query rows and keys per tile
constexpr int kSub = 16;                // threads per row group
constexpr int kThreads = kSub * kSub;   // 256
constexpr int kPer = kBlock / kSub;     // rows (and keys) per thread: 4
constexpr int kLdP = kBlock + 1;        // row stride of the P and dS tiles
constexpr float kNeg = -1e9f;           // JAX's _NEG
constexpr int kJaxBlockK = 256;         // JAX flash_attention's block_k
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ __forceinline__ int num_blocks(int t) {
  return (t + kBlock - 1) / kBlock;
}

// The kv blocks query block qb visits: all of them, or with causal those
// up to the one holding its last real row's diagonal (at least one).
// Tk rounded up to a multiple of JAX's kv block min(256, Tk): the l of a
// row that sees no key.
__device__ __forceinline__ float padded_keys(int Tk) {
  const int bk = Tk < kJaxBlockK ? Tk : kJaxBlockK;
  return static_cast<float>((Tk + bk - 1) / bk * bk);
}

__device__ __forceinline__ int kv_blocks(int qb, int nk, int Tq, int off,
                                         int causal) {
  if (!causal) return nk;
  const int end = qb * kBlock + kBlock;
  const int diag = (end < Tq ? end : Tq) - 1 + off;
  const int n = diag < 0 ? 1 : diag / kBlock + 1;
  return n < nk ? n : nk;
}

__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = kSub / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = kSub / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// dst[r, c] (row stride D + 1) = src[row0 + r, c] of a [rows, D] matrix, 0
// past its last row. Every thread of the block takes part.
template <int D>
__device__ __forceinline__ void load_tile(float* dst,
                                          const float* __restrict__ src,
                                          int row0, int rows) {
  for (int idx = threadIdx.x; idx < kBlock * D; idx += kThreads) {
    const int r = idx / D, c = idx - r * D;
    const int row = row0 + r;
    dst[r * (D + 1) + c] =
        row < rows ? src[static_cast<size_t>(row) * D + c] : 0.f;
  }
}

// s[i][j] = a[ty + 16 i, :] . b[tx + 16 j, :] over D, in order of d.
template <int D>
__device__ __forceinline__ void tile_dot(float (&s)[kPer][kPer],
                                         const float* a, const float* b,
                                         int ty, int tx) {
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int j = 0; j < kPer; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float av[kPer], bv[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) av[i] = a[(ty + kSub * i) * (D + 1) + d];
#pragma unroll
    for (int j = 0; j < kPer; ++j) bv[j] = b[(tx + kSub * j) * (D + 1) + d];
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < kPer; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
  }
}

// acc[i][c] += sum_r w(i, r) * x[r, tx + 16 c] over the 64 rows r of x
// (row stride D + 1), where w(i, r) is w[ty + 16 i, r] of a [64, 65] tile,
// or w[r, ty + 16 i] with kTransposed.
template <int D, bool kTransposed>
__device__ __forceinline__ void tile_accumulate(
    float (&acc)[kPer][(D + kSub - 1) / kSub], const float* w,
    const float* x, int ty, int tx) {
  constexpr int kCols = (D + kSub - 1) / kSub;
#pragma unroll 4
  for (int r = 0; r < kBlock; ++r) {
    float wv[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i)
      wv[i] = kTransposed ? w[r * kLdP + ty + kSub * i]
                          : w[(ty + kSub * i) * kLdP + r];
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = tx + kSub * c;
      if (col < D) {
        const float xv = x[r * (D + 1) + col];
#pragma unroll
        for (int i = 0; i < kPer; ++i) acc[i][c] = fmaf(wv[i], xv, acc[i][c]);
      }
    }
  }
}

// Writes rows [row0, row0 + 64) of a [rows, D] output from acc * mul.
template <int D>
__device__ __forceinline__ void store_rows(
    float* __restrict__ dst, float (&acc)[kPer][(D + kSub - 1) / kSub],
    float mul, int row0, int rows, int ty, int tx) {
  constexpr int kCols = (D + kSub - 1) / kSub;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int row = row0 + ty + kSub * i;
    if (row >= rows) continue;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = tx + kSub * c;
      if (col < D) dst[static_cast<size_t>(row) * D + col] = acc[i][c] * mul;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ mask,
                 float* __restrict__ o, float* __restrict__ stats, int BN,
                 int N, int Tq, int Tk, int causal, float scale) {
  constexpr int kCols = (D + kSub - 1) / kSub;
  extern __shared__ float smem[];
  float* q_s = smem;                          // [64, D + 1]
  float* k_s = q_s + kBlock * (D + 1);        // [64, D + 1]
  float* v_s = k_s + kBlock * (D + 1);        // [64, D + 1]
  float* p_s = v_s + kBlock * (D + 1);        // [64, 65]
  float* m_s = p_s + kBlock * kLdP;           // [64] this kv block's mask
  const int qb = blockIdx.x, bn = blockIdx.y, b = bn / N;
  const int tx = threadIdx.x % kSub, ty = threadIdx.x / kSub;
  const int q0 = qb * kBlock, off = Tk - Tq;
  const float* kb_base = k + static_cast<size_t>(bn) * Tk * D;
  const float* vb_base = v + static_cast<size_t>(bn) * Tk * D;
  load_tile<D>(q_s, q + static_cast<size_t>(bn) * Tq * D, q0, Tq);
  float m[kPer], l[kPer], acc[kPer][kCols];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }
  const int nkb = kv_blocks(qb, num_blocks(Tk), Tq, off, causal);
  for (int kb = 0; kb < nkb; ++kb) {
    const int k0 = kb * kBlock;
    __syncthreads();  // the previous block's reads of k_s, v_s, p_s are done
    load_tile<D>(k_s, kb_base, k0, Tk);
    load_tile<D>(v_s, vb_base, k0, Tk);
    if (threadIdx.x < kBlock) {
      const int kj = k0 + threadIdx.x;
      m_s[threadIdx.x] = kj < Tk ? mask[static_cast<size_t>(b) * Tk + kj] : 0.f;
    }
    __syncthreads();
    float s[kPer][kPer];
    tile_dot<D>(s, q_s, k_s, ty, tx);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int diag = q0 + ty + kSub * i + off;
      float row_max = kNeg;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int c = tx + kSub * j, kj = k0 + c;
        float x;
        if (kj >= Tk) {
          x = -INFINITY;  // the tile's tail: left out
        } else {
          x = s[i][j] * scale;
          if (!(m_s[c] > 0.f) || (causal && kj > diag)) x = kNeg;
        }
        s[i][j] = x;
        row_max = fmaxf(row_max, x);
      }
      const float m_new = fmaxf(m[i], group_max(row_max));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const float p = expf(s[i][j] - m_new);
        p_s[(ty + kSub * i) * kLdP + tx + kSub * j] = p;
        sum += p;
      }
      l[i] = l[i] * alpha + group_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();
    tile_accumulate<D, false>(acc, p_s, v_s, ty, tx);
  }
  // rows that see no key: acc holds the sum of v over the visited keys
  bool nokey[kPer];
  int any = 0;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    nokey[i] = q0 + ty + kSub * i < Tq && m[i] == kNeg;
    any |= nokey[i];
  }
  if (__syncthreads_or(any)) {
    // the kv blocks the causal skip left out, for those rows alone
    for (int kb = nkb; kb < num_blocks(Tk); ++kb) {
      const int k0 = kb * kBlock;
      __syncthreads();
      load_tile<D>(v_s, vb_base, k0, Tk);
#pragma unroll
      for (int i = 0; i < kPer; ++i)
#pragma unroll
        for (int j = 0; j < kPer; ++j)
          p_s[(ty + kSub * i) * kLdP + tx + kSub * j] =
              nokey[i] && k0 + tx + kSub * j < Tk ? 1.f : 0.f;
      __syncthreads();
      tile_accumulate<D, false>(acc, p_s, v_s, ty, tx);
    }
  }
  const float tk_pad = padded_keys(Tk);
  // o = acc / l, as blockwise_attention divides
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int row = q0 + ty + kSub * i;
    if (row >= Tq) continue;
    const float li = nokey[i] ? tk_pad : l[i];
    float* orow = o + (static_cast<size_t>(bn) * Tq + row) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = tx + kSub * c;
      if (col < D) orow[col] = acc[i][c] / li;
    }
    if (tx == 0) {
      stats[static_cast<size_t>(bn) * Tq + row] = m[i];
      stats[(static_cast<size_t>(BN) + bn) * Tq + row] = logf(li);
    }
  }
}

// P_ij and dS_ij of one tile, from the scores s (unscaled), dp = dO_i . v_j
// and the rows' m, log l, delta; replaced scores get P from -1e9 and dS 0;
// rows at or past Tq and keys at or past Tk get 0.
__device__ __forceinline__ void probs_and_dscores(
    float (&s)[kPer][kPer], float (&dp)[kPer][kPer], const float* m_s,
    const float* ll_s, const float* delta_s, const float* mask_s, int q0,
    int k0, int Tq, int Tk, int off, int causal, float scale, int ty,
    int tx) {
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int r = ty + kSub * i, row = q0 + r;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int c = tx + kSub * j, kj = k0 + c;
      float p = 0.f, ds = 0.f;
      if (row < Tq && kj < Tk) {
        const bool live = mask_s[c] > 0.f && !(causal && kj > row + off);
        p = expf(((live ? s[i][j] * scale : kNeg) - m_s[r]) - ll_s[r]);
        if (live) ds = p * (dp[i][j] - delta_s[r]);
      }
      s[i][j] = p;
      dp[i][j] = ds;
    }
  }
}

// The rows' m, log l and delta of query block q0 into shared memory (0 past
// Tq); threads 0..63.
__device__ __forceinline__ void load_row_stats(
    float* m_s, float* ll_s, float* delta_s, const float* __restrict__ stats,
    const float* __restrict__ delta, int BN, int bn, int q0, int Tq) {
  if (threadIdx.x < kBlock) {
    const int row = q0 + threadIdx.x;
    const bool in = row < Tq;
    const size_t at = static_cast<size_t>(bn) * Tq + row;
    m_s[threadIdx.x] = in ? stats[at] : 0.f;
    ll_s[threadIdx.x] = in ? stats[static_cast<size_t>(BN) * Tq + at] : 0.f;
    if (delta != nullptr) delta_s[threadIdx.x] = in ? delta[at] : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ mask,
                    const float* __restrict__ o,
                    const float* __restrict__ dout,
                    const float* __restrict__ stats,
                    float* __restrict__ delta, float* __restrict__ dq,
                    int BN, int N, int Tq, int Tk, int causal, float scale) {
  constexpr int kCols = (D + kSub - 1) / kSub;
  extern __shared__ float smem[];
  float* q_s = smem;                          // [64, D + 1]
  float* do_s = q_s + kBlock * (D + 1);       // [64, D + 1]
  float* k_s = do_s + kBlock * (D + 1);       // [64, D + 1]
  float* v_s = k_s + kBlock * (D + 1);        // [64, D + 1]
  float* ds_s = v_s + kBlock * (D + 1);       // [64, 65]
  float* mask_s = ds_s + kBlock * kLdP;       // [64]
  float* m_s = mask_s + kBlock;               // [64]
  float* ll_s = m_s + kBlock;                 // [64]
  float* delta_s = ll_s + kBlock;             // [64]
  const int qb = blockIdx.x, bn = blockIdx.y, b = bn / N;
  const int tx = threadIdx.x % kSub, ty = threadIdx.x / kSub;
  const int q0 = qb * kBlock, off = Tk - Tq;
  const size_t q_at = static_cast<size_t>(bn) * Tq * D;
  const float* kb_base = k + static_cast<size_t>(bn) * Tk * D;
  const float* vb_base = v + static_cast<size_t>(bn) * Tk * D;
  load_tile<D>(q_s, q + q_at, q0, Tq);
  load_tile<D>(do_s, dout + q_at, q0, Tq);
  {
    // delta = rowsum(dO o): four threads per row, then two shuffles
    const int r = threadIdx.x / 4, part = threadIdx.x % 4, row = q0 + r;
    float sum = 0.f;
    if (row < Tq) {
      const float* orow = o + q_at + static_cast<size_t>(row) * D;
      const float* drow = dout + q_at + static_cast<size_t>(row) * D;
      for (int d = part; d < D; d += 4) sum = fmaf(drow[d], orow[d], sum);
    }
    sum += __shfl_xor_sync(kFull, sum, 1);
    sum += __shfl_xor_sync(kFull, sum, 2);
    if (part == 0) {
      delta_s[r] = sum;
      if (row < Tq) delta[static_cast<size_t>(bn) * Tq + row] = sum;
    }
  }
  load_row_stats(m_s, ll_s, nullptr, stats, nullptr, BN, bn, q0, Tq);
  float acc[kPer][kCols];
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  const int nkb = kv_blocks(qb, num_blocks(Tk), Tq, off, causal);
  for (int kb = 0; kb < nkb; ++kb) {
    const int k0 = kb * kBlock;
    __syncthreads();
    load_tile<D>(k_s, kb_base, k0, Tk);
    load_tile<D>(v_s, vb_base, k0, Tk);
    if (threadIdx.x < kBlock) {
      const int kj = k0 + threadIdx.x;
      mask_s[threadIdx.x] =
          kj < Tk ? mask[static_cast<size_t>(b) * Tk + kj] : 0.f;
    }
    __syncthreads();
    float s[kPer][kPer], dp[kPer][kPer];
    tile_dot<D>(s, q_s, k_s, ty, tx);
    tile_dot<D>(dp, do_s, v_s, ty, tx);
    probs_and_dscores(s, dp, m_s, ll_s, delta_s, mask_s, q0, k0, Tq, Tk, off,
                      causal, scale, ty, tx);
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < kPer; ++j)
        ds_s[(ty + kSub * i) * kLdP + tx + kSub * j] = dp[i][j];
    __syncthreads();
    tile_accumulate<D, false>(acc, ds_s, k_s, ty, tx);
  }
  store_rows<D>(dq + q_at, acc, scale, q0, Tq, ty, tx);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ mask,
                      const float* __restrict__ dout,
                      const float* __restrict__ stats,
                      const float* __restrict__ delta,
                      float* __restrict__ dk, float* __restrict__ dv, int BN,
                      int N, int Tq, int Tk, int causal, float scale) {
  constexpr int kCols = (D + kSub - 1) / kSub;
  extern __shared__ float smem[];
  float* k_s = smem;                          // [64, D + 1]
  float* v_s = k_s + kBlock * (D + 1);        // [64, D + 1]
  float* q_s = v_s + kBlock * (D + 1);        // [64, D + 1]
  float* do_s = q_s + kBlock * (D + 1);       // [64, D + 1]
  float* p_s = do_s + kBlock * (D + 1);       // [64 query, 65]
  float* ds_s = p_s + kBlock * kLdP;          // [64 query, 65]
  float* mask_s = ds_s + kBlock * kLdP;       // [64]
  float* m_s = mask_s + kBlock;               // [64]
  float* ll_s = m_s + kBlock;                 // [64]
  float* delta_s = ll_s + kBlock;             // [64]
  const int kb = blockIdx.x, bn = blockIdx.y, b = bn / N;
  const int tx = threadIdx.x % kSub, ty = threadIdx.x / kSub;
  const int k0 = kb * kBlock, off = Tk - Tq;
  const size_t k_at = static_cast<size_t>(bn) * Tk * D;
  const size_t q_at = static_cast<size_t>(bn) * Tq * D;
  load_tile<D>(k_s, k + k_at, k0, Tk);
  load_tile<D>(v_s, v + k_at, k0, Tk);
  if (threadIdx.x < kBlock) {
    const int kj = k0 + threadIdx.x;
    mask_s[threadIdx.x] =
        kj < Tk ? mask[static_cast<size_t>(b) * Tk + kj] : 0.f;
  }
  float dk_acc[kPer][kCols], dv_acc[kPer][kCols];
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;
  const int nq = num_blocks(Tq), nk = num_blocks(Tk);
  for (int qb = 0; qb < nq; ++qb) {
    // block-uniform: a pair past the query block's diagonal (causal)
    const bool skipped = kb >= kv_blocks(qb, nk, Tq, off, causal);
    const int q0 = qb * kBlock;
    __syncthreads();  // the previous query block's reads are done
    load_row_stats(m_s, ll_s, delta_s, stats, delta, BN, bn, q0, Tq);
    if (skipped) {
      // only the block's rows that see no key (m = -1e9) add to dv here
      const int nokey = threadIdx.x < kBlock && q0 + threadIdx.x < Tq &&
                        m_s[threadIdx.x] == kNeg;
      if (!__syncthreads_or(nokey)) continue;
      load_tile<D>(do_s, dout + q_at, q0, Tq);
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int r = ty + kSub * i;
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          const int c = tx + kSub * j;
          p_s[r * kLdP + c] = q0 + r < Tq && k0 + c < Tk
                                  ? expf((kNeg - m_s[r]) - ll_s[r])
                                  : 0.f;
        }
      }
      __syncthreads();
      tile_accumulate<D, true>(dv_acc, p_s, do_s, ty, tx);
      continue;
    }
    load_tile<D>(q_s, q + q_at, q0, Tq);
    load_tile<D>(do_s, dout + q_at, q0, Tq);
    __syncthreads();
    float s[kPer][kPer], dp[kPer][kPer];
    tile_dot<D>(s, q_s, k_s, ty, tx);
    tile_dot<D>(dp, do_s, v_s, ty, tx);
    probs_and_dscores(s, dp, m_s, ll_s, delta_s, mask_s, q0, k0, Tq, Tk, off,
                      causal, scale, ty, tx);
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int at = (ty + kSub * i) * kLdP + tx + kSub * j;
        p_s[at] = s[i][j];
        ds_s[at] = dp[i][j];
      }
    __syncthreads();
    // this thread's keys are ty + 16 i: the P and dS tiles read transposed
    tile_accumulate<D, true>(dv_acc, p_s, do_s, ty, tx);
    tile_accumulate<D, true>(dk_acc, ds_s, q_s, ty, tx);
  }
  store_rows<D>(dv + k_at, dv_acc, 1.f, k0, Tk, ty, tx);
  store_rows<D>(dk + k_at, dk_acc, scale, k0, Tk, ty, tx);
}

template <int D>
constexpr size_t fwd_smem() {
  return sizeof(float) * (3 * kBlock * (D + 1) + kBlock * kLdP + kBlock);
}

template <int D>
constexpr size_t dq_smem() {
  return sizeof(float) * (4 * kBlock * (D + 1) + kBlock * kLdP + 4 * kBlock);
}

template <int D>
constexpr size_t dkdv_smem() {
  return sizeof(float) *
         (4 * kBlock * (D + 1) + 2 * kBlock * kLdP + 4 * kBlock);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int D>
int launch_fwd(const float* q, const float* k, const float* v,
               const float* mask, float* o, float* stats, int B, int N,
               int Tq, int Tk, int causal, float scale, cudaStream_t s) {
  cudaError_t err = allow_smem(flash_fwd_kernel<D>, fwd_smem<D>());
  if (err != cudaSuccess) return err;
  const dim3 grid(num_blocks(Tq), B * N);
  flash_fwd_kernel<D><<<grid, kThreads, fwd_smem<D>(), s>>>(
      q, k, v, mask, o, stats, B * N, N, Tq, Tk, causal, scale);
  return cudaGetLastError();
}

template <int D>
int launch_bwd(const float* q, const float* k, const float* v,
               const float* mask, const float* o, const float* dout,
               const float* stats, float* delta, float* dq, float* dk,
               float* dv, int B, int N, int Tq, int Tk, int causal,
               float scale, cudaStream_t s) {
  cudaError_t err = allow_smem(flash_bwd_dq_kernel<D>, dq_smem<D>());
  if (err != cudaSuccess) return err;
  err = allow_smem(flash_bwd_dkdv_kernel<D>, dkdv_smem<D>());
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<D>
      <<<dim3(num_blocks(Tq), B * N), kThreads, dq_smem<D>(), s>>>(
          q, k, v, mask, o, dout, stats, delta, dq, B * N, N, Tq, Tk, causal,
          scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // same stream: delta is written before this kernel starts
  flash_bwd_dkdv_kernel<D>
      <<<dim3(num_blocks(Tk), B * N), kThreads, dkdv_smem<D>(), s>>>(
          q, k, v, mask, dout, stats, delta, dk, dv, B * N, N, Tq, Tk,
          causal, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int flash_fwd(const float* q, const float* k, const float* v,
                         const float* mask, float* o, float* stats, int B,
                         int N, int Tq, int Tk, int D, int causal,
                         float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 8:
      return launch_fwd<8>(q, k, v, mask, o, stats, B, N, Tq, Tk, causal,
                           scale, s);
    case 16:
      return launch_fwd<16>(q, k, v, mask, o, stats, B, N, Tq, Tk, causal,
                            scale, s);
    case 32:
      return launch_fwd<32>(q, k, v, mask, o, stats, B, N, Tq, Tk, causal,
                            scale, s);
    case 64:
      return launch_fwd<64>(q, k, v, mask, o, stats, B, N, Tq, Tk, causal,
                            scale, s);
    case 128:
      return launch_fwd<128>(q, k, v, mask, o, stats, B, N, Tq, Tk, causal,
                             scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" int flash_bwd(const float* q, const float* k, const float* v,
                         const float* mask, const float* o,
                         const float* dout, const float* stats, float* delta,
                         float* dq, float* dk, float* dv, int B, int N,
                         int Tq, int Tk, int D, int causal, float scale,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 8:
      return launch_bwd<8>(q, k, v, mask, o, dout, stats, delta, dq, dk, dv,
                           B, N, Tq, Tk, causal, scale, s);
    case 16:
      return launch_bwd<16>(q, k, v, mask, o, dout, stats, delta, dq, dk, dv,
                            B, N, Tq, Tk, causal, scale, s);
    case 32:
      return launch_bwd<32>(q, k, v, mask, o, dout, stats, delta, dq, dk, dv,
                            B, N, Tq, Tk, causal, scale, s);
    case 64:
      return launch_bwd<64>(q, k, v, mask, o, dout, stats, delta, dq, dk, dv,
                            B, N, Tq, Tk, causal, scale, s);
    case 128:
      return launch_bwd<128>(q, k, v, mask, o, dout, stats, delta, dq, dk,
                             dv, B, N, Tq, Tk, causal, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// Flash attention for Hopper (sm_90a), f32 or (D <= 128) bf16 in and out,
// the products on the tensor cores: the forward and the analytic backward
// (two kernels).
//
// Replaces
// - flash_fwd: the TPU kernel paddle_tpu/ops/attention.py:_flash_kernel
//   (its pallas_call in _flash_forward), plus the row statistics the
//   backward needs;
// - flash_bwd: the backward paddle_tpu/ops/attention.py:_flash_bwd, which
//   is jax.vjp of blockwise_attention in JAX (a recompute through a
//   lax.scan); here it is the FA2-style analytic backward.
//
// Shapes: q [B, N, Tq, D], k and v [B, N, Tk, D], all contiguous and on
// 16 bytes; mask [B, Tk] (> 0 = a real key, indexed by batch, not by
// head), or null for every key real; o [B, N, Tq, D]. The forward
// computes, per row i of q,
//
//   s_ij = (q_i . k_j) * scale, replaced by -1e9 where mask_j <= 0 or,
//          with causal, where j > i + (Tk - Tq)
//   o_i  = sum_j exp(s_ij - m_i) v_j / l_i,  m_i = max_j s_ij,
//          l_i = sum_j exp(s_ij - m_i)
//
// by the online softmax of blockwise_attention (running m and l, the
// accumulator rescaled by exp(m_old - m_new) at each kv tile), and writes
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
// flash_bwd_dq runs first: one block per (b*n, query block) computes delta
// for its rows (and writes it), then sweeps the kv tiles and accumulates
// dQ. flash_bwd_dkdv follows: one block per (b*n, kv block) sweeps the
// query tiles and accumulates dK and dV. Every output element is summed
// by one thread in a fixed order: no float atomics, so two runs give the
// same bits.
//
// What bounds it on the H100 (SXM, 700 W), and the design. The forward
// does 4 D operations per visible (query, key) pair (two products), the
// backward 10 D (five). At the seq2seq path's [50, 4, 50, 50, 128] the
// bytes bound both (the forward moves 20.5 MB); at T = 4096 the products
// do: 68.7 GFLOP forward, 1.03 ms at the f32 rate outside the tensor
// cores. So every product runs on the tensor cores, in split TF32 (the
// arithmetic of SDPA's own f32 kernel, CUTLASS's OpMultiplyAddFastF32):
// each f32 operand x is split into big = TF32(x) and small = TF32(x -
// big), both rounded to nearest with ties away (the bits of
// cvt.rna.tf32.f32, made by an integer add and a mask: with cvt the
// forward took 2.46 ms at T = 4096 on the H100, with the mask 2.17),
// and each mma.sync m16n8k8 tile product sums small.big' + big.small' +
// big.big' (the small.small' term, 2^-22 of the product, is dropped).
// Three passes at 494.7 TFLOP/s dense TF32 bound the forward at T = 4096
// by 0.417 ms.
//
// - The tensor cores round their sums toward zero, so a long sum kept in
//   one accumulator drifts by an ulp of its size at each mma (9e-6 on o at
//   T = 4096 on the H100, near the 1e-5 tolerance) and is one chain of
//   dependent mma. Every 4 k steps of the forward's score product (8 in
//   the backward), and each tile of the products summed across tiles (o,
//   dq, dk, dv), go to a fresh accumulator that is added in f32, as SDPA's
//   tf32x3 kernels stage theirs.
// - A block owns 64 rows (query rows in the forward and dq, keys in dkdv)
//   over 4 warps of 16 (FA2's split). The block's own rows stay in shared
//   memory for the whole sweep: q (forward), q and dO (dq), k and v
//   (dkdv); a warp reads its A fragments from there and splits them at
//   each use.
// - The streamed operand (k, v and the mask by kv tiles; q, dO and the
//   rows' m, log l, delta by query tiles in dkdv) comes by 16-byte
//   cp.async, zero-filled past the end, into a two-stage ring: tile t + 1
//   lands while tile t is computed. Rows have a stride of D + 4 floats:
//   16-byte aligned, and the fragment loads of every product hit 32
//   distinct banks.
// - The score tile's accumulator fragment is not the A fragment of the
//   next product (tf32 m16n8k8 holds columns 2t, 2t + 1 where A wants t,
//   t + 4), so that product takes its k index in the order (0, 2, 4, 6,
//   1, 3, 5, 7): the accumulator then is the A fragment, and the B rows
//   (v, k, dO or q) are read in the same order. No shuffle or staging.
// - A row's max and sum reduce over the 4 lanes that hold it (two xor
//   shuffles; every lane gets the same bits).
// - dkdv computes the transposed tiles S^T = K Q^T and dP^T = V dO^T, so
//   that P^T and dS^T are again A fragments for dV += P^T dO and dK +=
//   dS^T Q.
//
// Tiles and shared memory (one formula, flash_smem below and flash_plan in
// ops/attention.py, held equal by a card test). Stages: the forward's kv
// tiles are 64 keys (32 at D = 128), dq's 64 (16 at D = 128), dkdv's
// query tiles 32 rows (16 at D = 128). At D = 128 the forward takes q
// (64 x 132 floats) and 2 stages of k, v (32 x 132) and the mask, 101,632
// bytes; dq 101,760 (q, dO; stages of 16 keys); dkdv 101,776 (k, v;
// stages of 16 queries and their m, log l, delta): at most 113 KB, so two
// 4-warp blocks fit an SM (8 warps), and with 128-255 registers a thread
// the register file takes no more. What holds them back at T = 4096:
// every warp splits its own copy of each shared tile's fragments (5
// integer or f32 instructions an element, more than the mma that use
// it), and 2 warps a scheduler hide little of the latency of the lds ->
// split -> mma chain; wgmma reading tiles split once into shared memory
// is the next step.
//
// Key positions at or past Tk (a tile's tail) are left out of the softmax
// (-inf, never treated as masked). With causal, a query block sweeps the
// kv tiles up to the one holding its last row's diagonal (at least one),
// heaviest blocks first, and a warp skips the products of a tile wholly
// above its own rows' diagonals; dkdv visits the same pairs from the key
// side.
//
// Rows that see no key (every score masked: an all-padding kv row, or with
// causal and Tq > Tk the first Tq - Tk rows) follow JAX's rule. JAX pads
// Tk to Tk_pad, a multiple of min(256, Tk), with masked zero keys and
// visits every block, so such a row's scores are all the -1e9 fill and it
// gets o = sum_{j<Tk} v_j / Tk_pad, m = -1e9, l = Tk_pad. Here a row sees
// no key iff its running max stays -1e9 (a visible score is above the
// fill): after the sweep, a block that holds such a row sums v over every
// kv tile for those rows alone (P = 1 on them, 0 on the others) and saves
// (-1e9, log Tk_pad). dq needs nothing new (dS is 0 on every masked
// score); dv_j takes P_ij dO_i = dO_i / Tk_pad from each such row, so
// dkdv also visits the query tiles that hold one: with causal those rows
// are a prefix of the head, the first (first real key) - (Tk - Tq) rows
// (the first real key from the mask).
//
// The bf16 form (flash_fwd / flash_bwd with bf16 = 1; D <= 128: the
// _bf16 kernels of the last kernel section). The reference's Pallas
// kernel is dtype-generic, and at bf16 it computes s = q k^T of the bf16
// operands summed in f32, times the scale in f32; m and l in f32, l
// summing the unrounded p; the accumulator adds p rounded to bf16 times v,
// summed in f32; o = acc / l rounded to bf16. Every tile is kept as bf16
// in shared memory (rows of D + 8 bf16: ldmatrix reads 8 rows in 8 bank
// groups), loaded by 16-byte cp.async into the same two-stage rings and
// read into fragments by ldmatrix (.trans for the operand whose rows are
// the product's k: v, and the streamed or resident tile of the backward's
// last products); every product of two bf16 values is one
// mma.sync.m16n8k16 bf16 with f32 sums, exact products. p goes from the
// score accumulator straight into the A fragment of p v (the m16n8
// accumulators of two n8 tiles are the m16k16 A fragment), rounded to
// bf16 after l took it. The backward takes bf16 q, k, v, o and dO and
// writes dq, dk, dv in bf16; P and dS are not bf16 values, so each is
// split into bf16 hi + lo (lo = x - hi, rounded) and its products take
// two mma, lo first (the error of the split, 2^-16 of the value, lies far
// below the bf16 outputs' rounding; the plain version flash_bwd_plain
// computes those products in f32). The mask, the row statistics and
// delta stay f32; the fresh-accumulator steps, the causal skips and the
// rule for rows that see no key are the f32 kernels'. The wide-head and
// split-row paths have no bf16 form. Tiles at D = 128: the forward's kv
// stages 64 keys (q 17,408 bytes, 2 stages of 35,072: 87,552), dq's 32
// keys (q, dO, stages, delta: 70,144), dkdv's 32 queries (k, v, stages
// with m, log l, delta: 70,416; its dk and dv sums take 128 registers,
// and ptxas spills 94 bytes at D = 128); D = 8 is padded to 16 (the k of
// an mma).
//
// Limits: D in {8, 16, 32, 64, 128} on the tensor cores (template
// instances; the wrapper pads any other D <= 128 with zero columns up to
// the next instance); 128 < D <= 1024 on the wide-head path below (split
// TF32 on the tensor cores too, 16 rows a block); any D above on the
// split-row path (a block a row); B * N on the grid's x (up to 2^31 - 1),
// the query (or kv) blocks on its y (up to 65535 x 64 rows; the wide
// path's 65535 x 16); the split-row path's B * N * T rows on x.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;  // 128
constexpr int kRows = 16 * kWarps;     // rows (or keys) a block owns: 64
constexpr float kNeg = -1e9f;          // JAX's _NEG
constexpr int kJaxBlockK = 256;        // JAX flash_attention's block_k
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 64;
// k steps (of 8) a fresh accumulator of the score products sums: longer
// runs fewer adds and chains the mma better but drifts further; the
// forward's o is held to 1e-5, the backward's gradients only to 1e-4 of
// their largest entry
constexpr int kFwdSteps = 4;
constexpr int kBwdSteps = 8;

// keys a kv tile of the forward and of dq, queries a query tile of dkdv
__host__ __device__ constexpr int kv_cols(int D) { return D == 128 ? 32 : 64; }
__host__ __device__ constexpr int dq_cols(int D) { return D == 128 ? 16 : 64; }
__host__ __device__ constexpr int q_cols(int D) { return D == 128 ? 16 : 32; }
// row stride of every tile in shared memory, floats
__host__ __device__ constexpr int row_ld(int D) { return D + 4; }
// floats of one ring stage: k, v, mask of `cols` keys (forward, dq); q,
// dO, m, log l, delta (dkdv)
__host__ __device__ constexpr int kv_stage(int D, int cols) {
  return 2 * cols * row_ld(D) + cols;
}
__host__ __device__ constexpr int q_stage(int D) {
  return 2 * q_cols(D) * row_ld(D) + 3 * q_cols(D);
}
// dynamic shared memory of each kernel, bytes
__host__ __device__ constexpr size_t fwd_smem(int D) {
  return sizeof(float) * (kRows * row_ld(D) + 2 * kv_stage(D, kv_cols(D)));
}
__host__ __device__ constexpr size_t dq_smem(int D) {
  return sizeof(float) *
         (2 * kRows * row_ld(D) + 2 * kv_stage(D, dq_cols(D)) + kRows);
}
__host__ __device__ constexpr size_t dkdv_smem(int D) {
  return sizeof(float) * (2 * kRows * row_ld(D) + 2 * q_stage(D)) +
         sizeof(int) * kWarps;
}

// ------------------------------------------------------------- copies
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from src into shared dst, or 16 zero bytes where !valid
__device__ __forceinline__ void cp16(float* dst, const float* src,
                                     bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp4(float* dst, const float* src,
                                    bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [row0, row0 + R) of a [rows, D] matrix into dst (row stride D + 4),
// zeros past its last row; every thread of the block takes part
template <int D, int R>
__device__ __forceinline__ void copy_tile(float* dst,
                                          const float* __restrict__ src,
                                          int row0, int rows) {
  constexpr int kChunks = D / 4;
  for (int i = threadIdx.x; i < R * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i - r * kChunks) * 4;
    const int row = row0 + r;
    const bool valid = row < rows;
    cp16(dst + r * row_ld(D) + c,
         src + (valid ? static_cast<size_t>(row) * D + c : 0), valid);
  }
}

// src[at + i] for i < n into dst, 0 at and past `end`, by a block of NT
// threads
template <int NT = kThreads>
__device__ __forceinline__ void copy_vec(float* dst,
                                         const float* __restrict__ src,
                                         int at, int n, int end) {
  for (int i = threadIdx.x; i < n; i += NT) {
    const bool valid = at + i < end;
    cp4(dst + i, src + (valid ? at + i : 0), valid);
  }
}

// the mask of keys [k0, k0 + n) into dst: a null mask is every key real
template <int NT = kThreads>
__device__ __forceinline__ void copy_mask(float* dst,
                                          const float* __restrict__ mrow,
                                          int k0, int n, int Tk) {
  if (mrow != nullptr) {
    copy_vec<NT>(dst, mrow, k0, n, Tk);
    return;
  }
  for (int i = threadIdx.x; i < n; i += NT)
    dst[i] = k0 + i < Tk ? 1.f : 0.f;
}

// ------------------------------------------------- split-TF32 products
struct FragA {  // a 16 x 8 A operand, split
  unsigned big[4], small[4];
};
struct FragB {  // an 8 x 8 B operand, split
  unsigned big[2], small[2];
};

// x rounded to TF32, to nearest with ties away from zero: the bits of
// cvt.rna.tf32.f32 for a finite x, by an integer add and a mask (the
// integer pipe takes them at a higher rate than the conversion unit)
__device__ __forceinline__ unsigned to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small, each rounded to TF32
__device__ __forceinline__ void split(float x, unsigned& big,
                                      unsigned& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4],
                                         const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b in split TF32: the small terms first, then big . big
__device__ __forceinline__ void mma3(float (&c)[4], const FragA& a,
                                     const FragB& b) {
  mma_tf32(c, a.small, b.big);
  mma_tf32(c, a.big, b.small);
  mma_tf32(c, a.big, b.big);
}

// Fragments of lane (g = lane / 4, t = lane % 4). An accumulator c of a
// 16 x 8 tile holds (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).

// A = rows [r0, r0 + 16) x columns [k0, k0 + 8) of a tile (row stride ld)
__device__ __forceinline__ void load_a(FragA& f, const float* s, int ld,
                                       int r0, int k0, int g, int t) {
  const float* p = s + (r0 + g) * ld + k0 + t;
  split(p[0], f.big[0], f.small[0]);
  split(p[8 * ld], f.big[1], f.small[1]);
  split(p[4], f.big[2], f.small[2]);
  split(p[8 * ld + 4], f.big[3], f.small[3]);
}

// B[k][n] = s[n0 + n][k0 + k]: rows of a tile as the columns of B (the
// k^T of q k^T)
__device__ __forceinline__ void load_bt(FragB& f, const float* s, int ld,
                                        int n0, int k0, int g, int t) {
  const float* p = s + (n0 + g) * ld + k0 + t;
  split(p[0], f.big[0], f.small[0]);
  split(p[4], f.big[1], f.small[1]);
}

// B[k][n] = s[k0 + perm(k)][n0 + n], perm = (0, 2, 4, 6, 1, 3, 5, 7): the
// rows in the k order of an accumulator taken as A (acc_to_a)
__device__ __forceinline__ void load_b_perm(FragB& f, const float* s,
                                            int ld, int k0, int n0, int g,
                                            int t) {
  const float* p = s + (k0 + 2 * t) * ld + n0 + g;
  split(p[0], f.big[0], f.small[0]);
  split(p[ld], f.big[1], f.small[1]);
}

// The accumulator c of a 16 x 8 tile as the A fragment of a product over
// its 8 columns, taken in the order perm: A[m][k] = C[m][perm(k)]
__device__ __forceinline__ void acc_to_a(FragA& f, const float (&c)[4]) {
  split(c[0], f.big[0], f.small[0]);
  split(c[2], f.big[1], f.small[1]);
  split(c[1], f.big[2], f.small[2]);
  split(c[3], f.big[3], f.small[3]);
}

// c[j] (16 rows x kNt tiles of 8) += A B^T over D, A rows [r0, r0 + 16)
// of tile as, B^T the first kNt * 8 rows of tile bs. The tensor cores
// round their sums toward zero: a long sum kept in one accumulator drifts
// by an ulp of its size at each mma. So every kSteps k steps (at most)
// go to a fresh accumulator, added to c in f32.
template <int D, int kNt, int kSteps>
__device__ __forceinline__ void product_smem(float (&c)[kNt][4],
                                             const float* as, int r0,
                                             const float* bs, int g, int t) {
  constexpr int kStep = D / 8 < kSteps ? D / 8 : kSteps;
#pragma unroll
  for (int kk = 0; kk < D / 8; kk += kStep) {
    FragA fa[kStep];
#pragma unroll
    for (int h = 0; h < kStep; ++h)
      load_a(fa[h], as, row_ld(D), r0, 8 * (kk + h), g, t);
#pragma unroll
    for (int j = 0; j < kNt; ++j) {
      float u[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int h = 0; h < kStep; ++h) {
        FragB fb;
        load_bt(fb, bs, row_ld(D), 8 * j, 8 * (kk + h), g, t);
        mma3(u, fa[h], fb);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) c[j][i] += u[i];
    }
  }
}

// acc (16 rows x D) += p (16 x kNt * 8, accumulators) times the rows of
// tile xs in the same order; the tile's sum in a fresh accumulator for
// each 8 columns of acc
template <int D, int kNt>
__device__ __forceinline__ void accumulate(float (&acc)[D / 8][4],
                                           const float (&p)[kNt][4],
                                           const float* xs, int g, int t) {
  FragA fa[kNt];
#pragma unroll
  for (int j = 0; j < kNt; ++j) acc_to_a(fa[j], p[j]);
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    float u[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kNt; ++j) {
      FragB fb;
      load_b_perm(fb, xs, row_ld(D), 8 * j, 8 * dn, g, t);
      mma3(u, fa[j], fb);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[dn][i] += u[i];
  }
}

template <int N, int M>
__device__ __forceinline__ void zero(float (&x)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) x[i][j] = 0.f;
}

// rows [r0 + g, r0 + g + 8] of a [rows, D] output from acc * mul_a, mul_b
template <int D>
__device__ __forceinline__ void store_rows(float* __restrict__ dst,
                                           const float (&acc)[D / 8][4],
                                           float mul_a, float mul_b, int r0,
                                           int rows, int g, int t) {
  const int ra = r0 + g, rb = ra + 8;
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    const int c = dn * 8 + 2 * t;
    if (ra < rows)
      *reinterpret_cast<float2*>(dst + static_cast<size_t>(ra) * D + c) =
          make_float2(acc[dn][0] * mul_a, acc[dn][1] * mul_a);
    if (rb < rows)
      *reinterpret_cast<float2*>(dst + static_cast<size_t>(rb) * D + c) =
          make_float2(acc[dn][2] * mul_b, acc[dn][3] * mul_b);
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(kFull, v, 1));
  return fmaxf(v, __shfl_xor_sync(kFull, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(kFull, v, 1);
  return v + __shfl_xor_sync(kFull, v, 2);
}

// Tk rounded up to a multiple of JAX's kv block min(256, Tk): the l of a
// row that sees no key
__device__ __forceinline__ float padded_keys(int Tk) {
  const int bk = Tk < kJaxBlockK ? Tk : kJaxBlockK;
  return static_cast<float>((Tk + bk - 1) / bk * bk);
}

// The kv tiles of kC keys query block q0 sweeps: all of them, or with
// causal those up to the one holding its last row's diagonal (at least
// one).
__device__ __forceinline__ int kv_tiles(int q0, int kC, int Tq, int Tk,
                                        int causal) {
  const int nk = (Tk + kC - 1) / kC;
  if (!causal) return nk;
  const int end = q0 + kRows < Tq ? q0 + kRows : Tq;
  const int diag = end - 1 + (Tk - Tq);
  const int n = diag < 0 ? 1 : diag / kC + 1;
  return n < nk ? n : nk;
}

// ------------------------------------------------------------ forward
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ mask,
                 float* __restrict__ o, float* __restrict__ stats, int BN,
                 int N, int Tq, int Tk, int causal, float scale) {
  constexpr int kC = kv_cols(D), kLd = row_ld(D), kNt = kC / 8;
  constexpr int kDt = D / 8;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                  // [64, D + 4] this block's q
  float* ring = q_s + kRows * kLd;    // 2 stages of k, v, mask
  const int bn = blockIdx.x, b = bn / N;
  // with causal the last query blocks sweep the most tiles: first
  const int qb = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = qb * kRows, r0 = q0 + warp * 16, off = Tk - Tq;
  const int ra = r0 + g, rb = ra + 8;
  const float* kbase = k + static_cast<size_t>(bn) * Tk * D;
  const float* vbase = v + static_cast<size_t>(bn) * Tk * D;
  const float* mrow = mask ? mask + static_cast<size_t>(b) * Tk : nullptr;
  const int nk = (Tk + kC - 1) / kC;
  const int nkt = kv_tiles(q0, kC, Tq, Tk, causal);

  auto load_stage = [&](int kt) {
    float* st = ring + (kt & 1) * kv_stage(D, kC);
    copy_tile<D, kC>(st, kbase, kt * kC, Tk);
    copy_tile<D, kC>(st + kC * kLd, vbase, kt * kC, Tk);
    copy_mask(st + 2 * kC * kLd, mrow, kt * kC, kC, Tk);
  };

  copy_tile<D, kRows>(q_s, q + static_cast<size_t>(bn) * Tq * D, q0, Tq);
  load_stage(0);
  cp_commit();
  float acc[kDt][4];
  zero(acc);
  float m_a = kNeg, m_b = kNeg, l_a = 0.f, l_b = 0.f;
  for (int kt = 0; kt < nkt; ++kt) {
    if (kt + 1 < nkt) load_stage(kt + 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const float* ks = ring + (kt & 1) * kv_stage(D, kC);
    const float* vs = ks + kC * kLd;
    const float* ms = vs + kC * kLd;
    const int k0 = kt * kC;
    // warp-uniform: rows past Tq, or every key of the tile above the
    // diagonals of this warp's rows
    if (r0 < Tq && !(causal && k0 > r0 + 15 + off)) {
      float s[kNt][4];
      zero(s);
      product_smem<D, kNt, kFwdSteps>(s, q_s, warp * 16, ks, g, t);
      float mx_a = kNeg, mx_b = kNeg;
#pragma unroll
      for (int j = 0; j < kNt; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * t + (e & 1), kj = k0 + col;
          const int row = e < 2 ? ra : rb;
          float x;
          if (kj >= Tk) {
            x = -INFINITY;  // the tile's tail: left out
          } else {
            x = s[j][e] * scale;
            if (!(ms[col] > 0.f) || (causal && kj > row + off)) x = kNeg;
          }
          s[j][e] = x;
          if (e < 2)
            mx_a = fmaxf(mx_a, x);
          else
            mx_b = fmaxf(mx_b, x);
        }
      const float mn_a = fmaxf(m_a, quad_max(mx_a));
      const float mn_b = fmaxf(m_b, quad_max(mx_b));
      const float al_a = expf(m_a - mn_a), al_b = expf(m_b - mn_b);
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int j = 0; j < kNt; ++j) {
        s[j][0] = expf(s[j][0] - mn_a);
        s[j][1] = expf(s[j][1] - mn_a);
        s[j][2] = expf(s[j][2] - mn_b);
        s[j][3] = expf(s[j][3] - mn_b);
        sum_a += s[j][0] + s[j][1];
        sum_b += s[j][2] + s[j][3];
      }
      l_a = l_a * al_a + sum_a;
      l_b = l_b * al_b + sum_b;
      m_a = mn_a;
      m_b = mn_b;
#pragma unroll
      for (int dn = 0; dn < kDt; ++dn) {
        acc[dn][0] *= al_a;
        acc[dn][1] *= al_a;
        acc[dn][2] *= al_b;
        acc[dn][3] *= al_b;
      }
      accumulate<D, kNt>(acc, s, vs, g, t);
    }
    __syncthreads();  // the tile's reads are done before it is refilled
  }
  l_a = quad_sum(l_a);
  l_b = quad_sum(l_b);
  // rows that see no key: the sum of v over every key, for them alone
  const bool nk_a = ra < Tq && m_a == kNeg, nk_b = rb < Tq && m_b == kNeg;
  if (__syncthreads_or(nk_a || nk_b)) {
#pragma unroll
    for (int dn = 0; dn < kDt; ++dn) {
      if (nk_a) acc[dn][0] = acc[dn][1] = 0.f;
      if (nk_b) acc[dn][2] = acc[dn][3] = 0.f;
    }
    for (int kt = 0; kt < nk; ++kt) {
      const int k0 = kt * kC;
      copy_tile<D, kC>(ring, vbase, k0, Tk);
      cp_commit();
      cp_wait<0>();
      __syncthreads();
      float p[kNt][4];
#pragma unroll
      for (int j = 0; j < kNt; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          p[j][e] = (e < 2 ? nk_a : nk_b) && k0 + 8 * j + 2 * t + (e & 1) < Tk
                        ? 1.f
                        : 0.f;
      accumulate<D, kNt>(acc, p, ring, g, t);
      __syncthreads();
    }
  }
  const float tk_pad = padded_keys(Tk);
  const float li_a = nk_a ? tk_pad : l_a, li_b = nk_b ? tk_pad : l_b;
  // o = acc / l, as blockwise_attention divides
  float* obase = o + static_cast<size_t>(bn) * Tq * D;
#pragma unroll
  for (int dn = 0; dn < kDt; ++dn) {
    const int c = dn * 8 + 2 * t;
    if (ra < Tq)
      *reinterpret_cast<float2*>(obase + static_cast<size_t>(ra) * D + c) =
          make_float2(acc[dn][0] / li_a, acc[dn][1] / li_a);
    if (rb < Tq)
      *reinterpret_cast<float2*>(obase + static_cast<size_t>(rb) * D + c) =
          make_float2(acc[dn][2] / li_b, acc[dn][3] / li_b);
  }
  if (t == 0) {
    const size_t at = static_cast<size_t>(bn) * Tq;
    const size_t at_l = (static_cast<size_t>(BN) + bn) * Tq;
    if (ra < Tq) {
      stats[at + ra] = m_a;
      stats[at_l + ra] = logf(li_a);
    }
    if (rb < Tq) {
      stats[at + rb] = m_b;
      stats[at_l + rb] = logf(li_b);
    }
  }
}

// ------------------------------------------------------------ backward
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
  constexpr int kC = dq_cols(D), kLd = row_ld(D), kNt = kC / 8;
  constexpr int kDt = D / 8;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                        // [64, D + 4] this block's q
  float* do_s = q_s + kRows * kLd;          // [64, D + 4] and its dO
  float* ring = do_s + kRows * kLd;         // 2 stages of k, v, mask
  float* dl_s = ring + 2 * kv_stage(D, kC); // [64] this block's delta
  const int bn = blockIdx.x, b = bn / N;
  const int qb = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = qb * kRows, r0 = q0 + warp * 16, off = Tk - Tq;
  const int ra = r0 + g, rb = ra + 8;
  const size_t q_at = static_cast<size_t>(bn) * Tq * D;
  const float* kbase = k + static_cast<size_t>(bn) * Tk * D;
  const float* vbase = v + static_cast<size_t>(bn) * Tk * D;
  const float* mrow = mask ? mask + static_cast<size_t>(b) * Tk : nullptr;
  const int nkt = kv_tiles(q0, kC, Tq, Tk, causal);

  auto load_stage = [&](int kt) {
    float* st = ring + (kt & 1) * kv_stage(D, kC);
    copy_tile<D, kC>(st, kbase, kt * kC, Tk);
    copy_tile<D, kC>(st + kC * kLd, vbase, kt * kC, Tk);
    copy_mask(st + 2 * kC * kLd, mrow, kt * kC, kC, Tk);
  };

  copy_tile<D, kRows>(q_s, q + q_at, q0, Tq);
  copy_tile<D, kRows>(do_s, dout + q_at, q0, Tq);
  load_stage(0);
  cp_commit();
  {
    // delta = rowsum(dO o) of this warp's 16 rows: 16-byte loads, a row
    // over kLpr lanes, then xor shuffles within them
    constexpr int kLpr = D / 4 < 32 ? D / 4 : 32, kRpp = 32 / kLpr;
#pragma unroll
    for (int pass = 0; pass < 16 / kRpp; ++pass) {
      const int r = pass * kRpp + lane / kLpr, row = r0 + r;
      float sum = 0.f;
      if (row < Tq) {
        const float4* orow = reinterpret_cast<const float4*>(
            o + q_at + static_cast<size_t>(row) * D);
        const float4* drow = reinterpret_cast<const float4*>(
            dout + q_at + static_cast<size_t>(row) * D);
        for (int c = lane % kLpr; c < D / 4; c += kLpr) {
          const float4 x = orow[c], y = drow[c];
          sum = fmaf(y.x, x.x, sum);
          sum = fmaf(y.y, x.y, sum);
          sum = fmaf(y.z, x.z, sum);
          sum = fmaf(y.w, x.w, sum);
        }
      }
#pragma unroll
      for (int s = kLpr / 2; s > 0; s >>= 1)
        sum += __shfl_xor_sync(kFull, sum, s);
      if (lane % kLpr == 0) {
        dl_s[warp * 16 + r] = sum;
        if (row < Tq) delta[static_cast<size_t>(bn) * Tq + row] = sum;
      }
    }
    __syncwarp();
  }
  const float dl_a = dl_s[warp * 16 + g], dl_b = dl_s[warp * 16 + g + 8];
  const size_t at = static_cast<size_t>(bn) * Tq;
  const size_t at_l = (static_cast<size_t>(BN) + bn) * Tq;
  const float m_a = ra < Tq ? stats[at + ra] : 0.f;
  const float m_b = rb < Tq ? stats[at + rb] : 0.f;
  const float ll_a = ra < Tq ? stats[at_l + ra] : 0.f;
  const float ll_b = rb < Tq ? stats[at_l + rb] : 0.f;
  float acc[kDt][4];
  zero(acc);
  for (int kt = 0; kt < nkt; ++kt) {
    if (kt + 1 < nkt) load_stage(kt + 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const float* ks = ring + (kt & 1) * kv_stage(D, kC);
    const float* vs = ks + kC * kLd;
    const float* ms = vs + kC * kLd;
    const int k0 = kt * kC;
    if (r0 < Tq && !(causal && k0 > r0 + 15 + off)) {
      float s[kNt][4], dp[kNt][4];
      zero(s);
      zero(dp);
      product_smem<D, kNt, kBwdSteps>(s, q_s, warp * 16, ks, g, t);
      product_smem<D, kNt, kBwdSteps>(dp, do_s, warp * 16, vs, g, t);
#pragma unroll
      for (int j = 0; j < kNt; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * t + (e & 1), kj = k0 + col;
          const int row = e < 2 ? ra : rb;
          const bool live = kj < Tk && row < Tq && ms[col] > 0.f &&
                            !(causal && kj > row + off);
          s[j][e] = live ? expf((s[j][e] * scale - (e < 2 ? m_a : m_b)) -
                                (e < 2 ? ll_a : ll_b)) *
                               (dp[j][e] - (e < 2 ? dl_a : dl_b))
                         : 0.f;
        }
      accumulate<D, kNt>(acc, s, ks, g, t);
    }
    __syncthreads();
  }
  store_rows<D>(dq + q_at, acc, scale, scale, r0, Tq, g, t);
}

// The first key of a mask row with mask > 0 (Tk if none; 0 for a null
// mask); every thread of a block of NT takes part. red: NT / 32 ints.
template <int NT = kThreads>
__device__ __forceinline__ int first_key(const float* __restrict__ mrow,
                                         int Tk, int* red) {
  if (mrow == nullptr) return 0;
  for (int base = 0; base < Tk; base += NT) {
    const int j = base + threadIdx.x;
    const bool hit = j < Tk && mrow[j] > 0.f;
    if (__syncthreads_or(hit)) {
      const unsigned bal = __ballot_sync(kFull, hit);
      if ((threadIdx.x & 31) == 0)
        red[threadIdx.x >> 5] =
            bal ? base + (threadIdx.x & ~31) + __ffs(bal) - 1 : INT_MAX;
      __syncthreads();
      int fk = red[0];
#pragma unroll
      for (int w = 1; w < NT / 32; ++w) fk = red[w] < fk ? red[w] : fk;
      return fk;
    }
  }
  return Tk;
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
  constexpr int kC = q_cols(D), kLd = row_ld(D), kNt = kC / 8;
  constexpr int kDt = D / 8;
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;                    // [64, D + 4] this block's keys
  float* v_s = k_s + kRows * kLd;       // [64, D + 4]
  float* ring = v_s + kRows * kLd;      // 2 stages of q, dO, m, log l, delta
  int* red = reinterpret_cast<int*>(ring + 2 * q_stage(D));
  const int bn = blockIdx.x, b = bn / N, kb = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = kb * kRows, kw0 = k0 + warp * 16, off = Tk - Tq;
  const int ka = kw0 + g, kbk = ka + 8;
  const size_t k_at = static_cast<size_t>(bn) * Tk * D;
  const size_t q_at = static_cast<size_t>(bn) * Tq * D;
  const float* mrow = mask ? mask + static_cast<size_t>(b) * Tk : nullptr;
  copy_tile<D, kRows>(k_s, k + k_at, k0, Tk);
  copy_tile<D, kRows>(v_s, v + k_at, k0, Tk);
  cp_commit();
  // the query tiles to visit: with causal, those holding a row that sees
  // one of this block's keys, and those holding a row that sees no key
  const int nq = (Tq + kC - 1) / kC;
  int nokey_rows = 0, nokey_qt = 0, first_qt = 0;
  if (causal) {
    const int fk = first_key(mrow, Tk, red);
    nokey_rows = fk - off < 0 ? 0 : (fk - off < Tq ? fk - off : Tq);
    nokey_qt = (nokey_rows + kC - 1) / kC;
    first_qt = (k0 - off > 0 ? k0 - off : 0) / kC;
  }
  const int from = nokey_qt > first_qt ? nokey_qt : first_qt;
  const int nvis = nokey_qt + (nq > from ? nq - from : 0);
  auto tile_of = [&](int i) { return i < nokey_qt ? i : from + i - nokey_qt; };
  auto load_stage = [&](int i) {
    const int qt0 = tile_of(i) * kC;
    float* st = ring + (i & 1) * q_stage(D);
    copy_tile<D, kC>(st, q + q_at, qt0, Tq);
    copy_tile<D, kC>(st + kC * kLd, dout + q_at, qt0, Tq);
    float* vec = st + 2 * kC * kLd;
    copy_vec(vec, stats + static_cast<size_t>(bn) * Tq, qt0, kC, Tq);
    copy_vec(vec + kC, stats + (static_cast<size_t>(BN) + bn) * Tq, qt0, kC,
             Tq);
    copy_vec(vec + 2 * kC, delta + static_cast<size_t>(bn) * Tq, qt0, kC, Tq);
  };
  const bool mk_a = ka < Tk && (mrow == nullptr || mrow[ka] > 0.f);
  const bool mk_b = kbk < Tk && (mrow == nullptr || mrow[kbk] > 0.f);
  float dk_acc[kDt][4], dv_acc[kDt][4];
  zero(dk_acc);
  zero(dv_acc);
  if (nvis > 0) load_stage(0);
  cp_commit();
  for (int i = 0; i < nvis; ++i) {
    if (i + 1 < nvis) load_stage(i + 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const float* qs = ring + (i & 1) * q_stage(D);
    const float* dos = qs + kC * kLd;
    const float* m_s = dos + kC * kLd;
    const float* ll_s = m_s + kC;
    const float* dl_s = ll_s + kC;
    const int qt0 = tile_of(i) * kC;
    // warp-uniform: keys past Tk, or (causal) every pair of the tile
    // hidden and no row of it without a key
    if (kw0 < Tk &&
        !(causal && qt0 + kC - 1 + off < kw0 && qt0 >= nokey_rows)) {
      float s[kNt][4], dp[kNt][4];  // S^T, dP^T: [this warp's keys, queries]
      zero(s);
      zero(dp);
      product_smem<D, kNt, kBwdSteps>(s, k_s, warp * 16, qs, g, t);
      product_smem<D, kNt, kBwdSteps>(dp, v_s, warp * 16, dos, g, t);
#pragma unroll
      for (int j = 0; j < kNt; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * j + 2 * t + (e & 1), qi = qt0 + c;
          const int key = e < 2 ? ka : kbk;
          const bool valid = key < Tk && qi < Tq;
          const bool live =
              valid && (e < 2 ? mk_a : mk_b) && !(causal && key > qi + off);
          const float p =
              valid ? expf(((live ? s[j][e] * scale : kNeg) - m_s[c]) - ll_s[c])
                    : 0.f;
          dp[j][e] = live ? p * (dp[j][e] - dl_s[c]) : 0.f;
          s[j][e] = p;
        }
      accumulate<D, kNt>(dv_acc, s, dos, g, t);
      accumulate<D, kNt>(dk_acc, dp, qs, g, t);
    }
    __syncthreads();
  }
  cp_wait<0>();
  store_rows<D>(dv + k_at, dv_acc, 1.f, 1.f, kw0, Tk, g, t);
  store_rows<D>(dk + k_at, dk_acc, scale, scale, kw0, Tk, g, t);
}

// ------------------------------------------------------- wide heads
// 128 < D <= kWideMaxD: f32 on the tensor cores in split TF32, the
// arithmetic of the kernels above. A warp's 16 x D accumulator does not
// fit in registers above D = 256, so a block of kWideWarps warps owns
// kWideRows rows (query rows in the forward and dq, keys in dkdv) and
// splits the work across its warps. D is padded with zero columns to a
// multiple of kWideChunk; the streamed operand (k and v; or q and dO)
// comes by cp.async in chunks of kWideKeys rows by kWideChunk columns,
// through a ring of chunks (the forward's 4: three in flight while one is
// computed; the backward's 2; one __syncthreads a chunk):
// - a product over D (the scores S = Q K^T and dP = dO V^T; dkdv their
//   transposes K Q^T and V dO^T) splits the tile's kWideKeys rows: warp w
//   sums its 8 (keys; queries in dkdv) over all of D, chunk by chunk, a
//   fresh mma accumulator each half chunk added in f32, so that each score
//   is one warp's sum in a fixed order;
// - a product into D (O += P V, dQ += dS K, dV += P^T dO, dK += dS^T Q)
//   splits D: warp w owns the columns [c kWideChunk + 8 w, c kWideChunk +
//   8 w + 8) of each chunk c, summed in its registers (Dp / 8 columns a
//   warp), a fresh accumulator a tile added in f32; P and dS are split
//   into TF32 big and small once, into shared memory, by the warp that
//   computed them.
// The block's own rows (q; q and dO; k and v), the A operand of the
// products over D, stay in shared memory for the whole sweep, split into
// TF32 big and small once, in the order of the mma's A fragments (each
// warp reads all of them; split at each use they cost the forward a
// quarter of its time on the H100); dq's and dkdv's two at D > 512 do
// not fit so, and are split at each use. The forward's online softmax
// takes each row's max and sum over the 8 warps' keys through shared
// memory (the sums added in warp order); the masks, the causal offset,
// the key tails and the rows that see no key follow the rules of the
// kernels above. A kv tile (a query tile in dkdv) of kWideKeys rows
// streams: forward, its k chunks (S), then its v chunks (O); dq, its k
// (S), v (dP) and k again (dQ); dkdv, its q (S^T), dO (dP^T and dV from
// one staging) and q again (dK). Work whose result is known is skipped: a
// kv row with no real key takes the forward straight to its no-key pass
// and gives dq = 0 without a sweep; a dkdv block none of whose keys is
// real stages only the dO of the rows that see no key (dV), dK = 0. No
// atomics: two runs give the same bits.
// Where a launch of the 16-chunk instance (512 < D <= 1024) has fewer
// blocks than the card has SMs (a short sequence: [2, 2, 64, 64, 1024] is
// 16), the outputs' chunks are split over gridDim.z parts (wide_parts):
// part z's blocks compute the products over D (the scores, dP) whole and
// only the products into D of the chunks [z nc / parts, (z + 1) nc /
// parts) (wide_part), staging just those chunks for them; the
// accumulators stay indexed by the absolute chunk, so each output element
// is the same sum in the same order, the same bits at any number of
// parts. Part 0 writes the stats and delta. The 4- and 8-chunk instances
// do not split: they sit at 128 registers, where the parts' bookkeeping
// spilled and cost their backward 3-7 % at one part (PERF.md, PR 24).
//
// What bounds them on the H100: not the operations (the split-TF32 bound
// of [2, 4, 300, 300, 256] is 0.003 ms forward) but shared memory and the
// mma issue: every warp reads the whole A operand and P of its block,
// 8 x 16 x 64 split words a chunk each (about 80 KB of shared-memory
// reads a chunk and block, against 20 KB of k or v staged); a first
// design that split the scores' sums over D across the warps (partials
// added in shared memory) read less of A but as much of the partials, and
// measured slower (PERF.md, PR 24).
constexpr int kWideWarps = 8;
constexpr int kWideThreads = 32 * kWideWarps;  // 256
constexpr int kWideRows = 16;   // rows a block owns
constexpr int kWideKeys = 64;   // rows of a streamed tile: 8 a warp
constexpr int kWideChunk = 64;  // columns of a staged chunk: 8 a warp
// chunks of the ring: the forward's, the backward's (measured faster
// than 4 there, where the block's rows and the ring share the SM)
constexpr int kWideStagesFwd = 4, kWideStagesBwd = 2;
constexpr int kWideMaxD = 1024;
constexpr int kWideLd = kWideChunk + 4;  // a staged chunk's row stride
constexpr int kWideSld = kWideKeys + 4;  // P's (and dS's) row stride
// floats of the ring, of P (or dS) split in two, and of the rows'
// vectors (the warps' row maxima and sums; dq's delta)
constexpr int kWideStage = kWideKeys * kWideLd;
constexpr int kWideP = 2 * kWideRows * kWideSld;
constexpr int kWideVec = 2 * kWideWarps * kWideRows + kWideRows;

// D padded to whole chunks, and the resident rows' stride
__host__ __device__ constexpr int wide_dp(int D) {
  return (D + kWideChunk - 1) / kWideChunk * kWideChunk;
}
__host__ __device__ constexpr int wide_ld(int D) { return wide_dp(D) + 4; }
// chunks of D, instance of it (4, 8, 16: D <= 256, 512, 1024)
__host__ __device__ constexpr int wide_chunks(int D) {
  return wide_dp(D) / kWideChunk;
}
__host__ __device__ constexpr int wide_instance(int D) {
  return wide_chunks(D) <= 4 ? 4 : (wide_chunks(D) <= 8 ? 8 : 16);
}
// whether instance NC splits its outputs' chunks into parts
__host__ __device__ constexpr bool wide_splits(int NC) { return NC == 16; }
// parts the outputs' chunks split into (gridDim.z) for a launch of
// `blocks` blocks (B N times the row blocks) at nc chunks of instance NC:
// doubled while the blocks stay within the card's SMs and a part keeps a
// chunk
inline int wide_parts(long long blocks, int NC, int nc, int sms) {
  int parts = 1;
  while (wide_splits(NC) && 2 * parts <= nc && blocks * 2 * parts <= sms)
    parts *= 2;
  return parts;
}
// this block's part of the nc output chunks, [lo, hi): all of them where
// instance NC does not split
template <int NC>
__device__ __forceinline__ void wide_part(int nc, int& lo, int& hi) {
  lo = 0;
  hi = nc;
  if constexpr (wide_splits(NC)) {
    lo = static_cast<int>(blockIdx.z) * nc / static_cast<int>(gridDim.z);
    hi = (static_cast<int>(blockIdx.z) + 1) * nc /
         static_cast<int>(gridDim.z);
  }
}
// whether kernel `which` (0 forward, 1 dq, 2 dkdv) of instance NC keeps
// its resident rows pre-split (2 x 16 x Dp words each), else raw (16 x
// ld floats)
__host__ __device__ constexpr bool wide_presplit(int which, int NC) {
  return which == 0 || NC <= 8;
}
// dynamic shared memory of kernel `which`: its resident rows (q; q and
// dO; k and v), the ring, P and the vectors
__host__ __device__ constexpr size_t wide_smem(int which, int D) {
  return sizeof(float) *
         ((which == 0 ? 1 : 2) * kWideRows *
              (wide_presplit(which, wide_instance(D)) ? 2 * wide_dp(D)
                                                      : wide_ld(D)) +
          (which == 0 ? kWideStagesFwd : kWideStagesBwd) * kWideStage +
          kWideP + kWideVec);
}

// rows [r0, r0 + R) x columns [c0, c0 + W) of a [rows, D] matrix into dst
// (row stride ld), zeros past its last row and past D: 16-byte copies
// where D % 4 == 0, else 4-byte; every thread of the block takes part
template <int R, int W>
__device__ __forceinline__ void wide_copy(float* dst,
                                          const float* __restrict__ src,
                                          int r0, int rows, int c0, int D,
                                          int ld) {
  if (D % 4 == 0) {
    for (int i = threadIdx.x; i < R * W / 4; i += kWideThreads) {
      const int r = i / (W / 4), c = 4 * (i % (W / 4));
      const int row = r0 + r, col = c0 + c;
      const bool valid = row < rows && col < D;
      cp16(dst + r * ld + c,
           src + (valid ? static_cast<size_t>(row) * D + col : 0), valid);
    }
  } else {
    for (int i = threadIdx.x; i < R * W; i += kWideThreads) {
      const int r = i / W, c = i % W;
      const int row = r0 + r, col = c0 + c;
      const bool valid = row < rows && col < D;
      cp4(dst + r * ld + c,
          src + (valid ? static_cast<size_t>(row) * D + col : 0), valid);
    }
  }
}

// the block's resident rows [r0, r0 + kWideRows) of a [rows, D] matrix,
// every chunk (zeros past D and past its last row); not committed
__device__ __forceinline__ void wide_resident(float* dst,
                                              const float* __restrict__ src,
                                              int r0, int rows, int nc,
                                              int D, int ld) {
  for (int c = 0; c < nc; ++c)
    wide_copy<kWideRows, kWideChunk>(dst + c * kWideChunk, src, r0, rows,
                                     c * kWideChunk, D, ld);
}

// rows [r0, r0 + 16) of a [rows, D] matrix (zeros past its last row and
// past D), split into TF32 big and small in the order of the mma's A
// fragments: words 8 (32 kk + l) + [0, 4) the big and [4, 8) the small
// halves of lane l's (g, 8 kk + t), (g + 8, ..), (g, 8 kk + t + 4),
// (g + 8, ..) for k step kk < nk; every thread of the block takes part
__device__ __forceinline__ void wide_frag(unsigned* fr,
                                          const float* __restrict__ src,
                                          int r0, int rows, int D, int nk) {
  for (int i = threadIdx.x; i < 32 * nk; i += kWideThreads) {
    const int kk = i / 32, l = i % 32, g = l >> 2, t = l & 3;
    unsigned w[8];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + g + 8 * (e & 1), c = 8 * kk + t + 4 * (e >> 1);
      split(r < rows && c < D ? src[static_cast<size_t>(r) * D + c] : 0.f,
            w[e], w[4 + e]);
    }
    *reinterpret_cast<uint4*>(fr + 8 * i) = make_uint4(w[0], w[1], w[2], w[3]);
    *reinterpret_cast<uint4*>(fr + 8 * i + 4) =
        make_uint4(w[4], w[5], w[6], w[7]);
  }
}

// s (16 rows x the 8 rows [bn, bn + 8) of the staged chunk bs) += A[:,
// ac, ac + kWideChunk) bs[bn .., :]^T over the chunk's columns in split
// TF32: the chunk's two halves of kWideHalf k steps each in a fresh
// accumulator (two independent mma chains, interleaved), added to s in
// order. A: the block's rows, pre-split (kFrag: wide_frag's words at a)
// or raw (row stride lda).
constexpr int kWideHalf = kWideChunk / 16;
template <bool kFrag>
__device__ __forceinline__ void wide_scores(float (&s)[4], const void* a,
                                            int lda, int ac, const float* bs,
                                            int bn, int g, int t) {
  float u[2][4] = {};
#pragma unroll
  for (int h = 0; h < kWideHalf; ++h) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int kk = (ac >> 3) + half * kWideHalf + h;
      FragA fa;
      FragB fb;
      if constexpr (kFrag) {
        const uint4* f = reinterpret_cast<const uint4*>(a) +
                         2 * (32 * kk + 4 * g + t);
        const uint4 big = f[0], small = f[1];
        fa.big[0] = big.x;
        fa.big[1] = big.y;
        fa.big[2] = big.z;
        fa.big[3] = big.w;
        fa.small[0] = small.x;
        fa.small[1] = small.y;
        fa.small[2] = small.z;
        fa.small[3] = small.w;
      } else {
        load_a(fa, static_cast<const float*>(a), lda, 0, 8 * kk, g, t);
      }
      load_bt(fb, bs, kWideLd, bn, 8 * (half * kWideHalf + h), g, t);
      mma3(u[half], fa, fb);
    }
  }
#pragma unroll
  for (int half = 0; half < 2; ++half)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i] += u[half][i];
}

// the block's resident A rows: pre-split (kFrag) or raw, not committed
template <bool kFrag>
__device__ __forceinline__ void wide_a_rows(void* dst,
                                            const float* __restrict__ src,
                                            int r0, int rows, int nc, int D,
                                            int ld) {
  if constexpr (kFrag) {
    wide_frag(static_cast<unsigned*>(dst), src, r0, rows, D,
              nc * kWideChunk / 8);
  } else {
    wide_resident(static_cast<float*>(dst), src, r0, rows, nc, D, ld);
  }
}

// x into P's TF32 big and small halves at (r, c)
__device__ __forceinline__ void wide_put_p(unsigned* pb, float x, int r,
                                           int c) {
  unsigned big, small;
  split(x, big, small);
  pb[r * kWideSld + c] = big;
  pb[(kWideRows + r) * kWideSld + c] = small;
}

// the warp's four scores (rows g, g + 8; its columns 8 w + 2 t, + 1) into
// P's halves
__device__ __forceinline__ void wide_put_p4(unsigned* pb, const float (&x)[4],
                                            int warp, int g, int t) {
#pragma unroll
  for (int e = 0; e < 4; ++e)
    wide_put_p(pb, x[e], g + 8 * (e >> 1), 8 * warp + 2 * t + (e & 1));
}

// acc (16 rows x the 8 columns [xc, xc + 8) of the staged chunk) += P X
// over the chunk's kWideKeys rows, P split in pb (big, then small
// [16][kWideSld] each); the rows' two halves in fresh accumulators (two
// independent mma chains, interleaved), added in f32 in order
__device__ __forceinline__ void wide_accumulate(float (&acc)[4],
                                                const unsigned* pb,
                                                const float* xs, int xc,
                                                int g, int t) {
  float u[2][4] = {};
  const unsigned* ps = pb + kWideRows * kWideSld;
#pragma unroll
  for (int i = 0; i < kWideKeys / 8; ++i) {
    const int half = i & 1, kk = half * (kWideKeys / 16) + (i >> 1);
    // the k order perm (load_b_perm): A[m][k] = P[m][8 kk + perm(k)]
    const int at = g * kWideSld + 8 * kk + 2 * t;
    const uint2 b0 = *reinterpret_cast<const uint2*>(pb + at);
    const uint2 b1 = *reinterpret_cast<const uint2*>(pb + at + 8 * kWideSld);
    const uint2 s0 = *reinterpret_cast<const uint2*>(ps + at);
    const uint2 s1 = *reinterpret_cast<const uint2*>(ps + at + 8 * kWideSld);
    FragA fa;
    fa.big[0] = b0.x;
    fa.big[1] = b1.x;
    fa.big[2] = b0.y;
    fa.big[3] = b1.y;
    fa.small[0] = s0.x;
    fa.small[1] = s1.x;
    fa.small[2] = s0.y;
    fa.small[3] = s1.y;
    FragB fb;
    load_b_perm(fb, xs, kWideLd, 8 * kk, xc, g, t);
    mma3(u[half], fa, fb);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i] += u[half][i];
}

// the kv tiles of kWideKeys keys query block q0 (kWideRows rows) sweeps:
// all of them, or with causal those up to the one holding its last row's
// diagonal (at least one)
__device__ __forceinline__ int wide_kv_tiles(int q0, int Tq, int Tk,
                                             int causal) {
  const int nk = (Tk + kWideKeys - 1) / kWideKeys;
  if (!causal) return nk;
  const int end = q0 + kWideRows < Tq ? q0 + kWideRows : Tq;
  const int diag = end - 1 + (Tk - Tq);
  const int n = diag < 0 ? 1 : diag / kWideKeys + 1;
  return n < nk ? n : nk;
}

// the warp's columns of chunks [lo, hi) of rows r0 + g, r0 + g + 8 (below
// `rows`; columns below D) of a [rows, D] output: acc[c] / a, b (kDivide)
// or * a, b
template <bool kDivide, int NC>
__device__ __forceinline__ void wide_store(float* __restrict__ dst,
                                           const float (&acc)[NC][4],
                                           float a, float b, int r0,
                                           int rows, int lo, int hi, int D,
                                           int warp, int g, int t) {
  const int ra = r0 + g, rb = ra + 8;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    if (c < lo || c >= hi) continue;
    const int d = c * kWideChunk + 8 * warp + 2 * t;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (d + e >= D) continue;
      if (ra < rows)
        dst[static_cast<size_t>(ra) * D + d + e] =
            kDivide ? acc[c][e] / a : acc[c][e] * a;
      if (rb < rows)
        dst[static_cast<size_t>(rb) * D + d + e] =
            kDivide ? acc[c][2 + e] / b : acc[c][2 + e] * b;
    }
  }
}

template <int N, int M>
__device__ __forceinline__ void zero_acc(float (&x)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) x[i][j] = 0.f;
}

// The ring's stages (kS chunks): stage s is a chunk of one pass over a
// tile, in the order the kernel computes them. WIDE_NEXT(s) makes stage s
// the computed one: waits for it, synchronises the block (every warp is past
// stage s - 1, whose slot the refill takes), issues stage s + kS - 1 and
// returns s's slot. issue(s) is the kernel's: it copies stage s (if any)
// and commits.
#define WIDE_NEXT(s)                                   \
  (cp_wait<kS - 2>(), __syncthreads(), issue((s) + kS - 1), \
   ring + ((s) % kS) * kWideStage)

template <int NC>
__global__ void __launch_bounds__(kWideThreads)
flash_wide_fwd_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ mask, float* __restrict__ o,
                      float* __restrict__ stats, int BN, int N, int Tq,
                      int Tk, int D, int causal, float scale) {
  constexpr int kS = kWideStagesFwd;
  extern __shared__ __align__(16) float smem[];
  const int nc = wide_chunks(D);
  unsigned* q_f = reinterpret_cast<unsigned*>(smem);  // this block's q, split
  float* ring = smem + 2 * kWideRows * nc * kWideChunk;  // chunks of k, v
  unsigned* pb = reinterpret_cast<unsigned*>(ring + kS * kWideStage);
  float* mxw = ring + kS * kWideStage + kWideP;    // [8][16] row maxima
  float* smw = mxw + kWideWarps * kWideRows;       // [8][16] row sums
  const int bn = blockIdx.x, b = bn / N;
  // with causal the last query blocks sweep the most tiles: first
  const int qb = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = qb * kWideRows, off = Tk - Tq;
  const int ra = q0 + g, rb = ra + 8;
  const float* kbase = k + static_cast<size_t>(bn) * Tk * D;
  const float* vbase = v + static_cast<size_t>(bn) * Tk * D;
  const float* mrow = mask ? mask + static_cast<size_t>(b) * Tk : nullptr;
  // a kv row with no real key: every row sees none, the sweep is skipped
  const bool keyless =
      first_key<kWideThreads>(mrow, Tk, reinterpret_cast<int*>(mxw)) >= Tk;
  const int nkt = keyless ? 0 : wide_kv_tiles(q0, Tq, Tk, causal);
  int lo, hi;
  wide_part<NC>(nc, lo, hi);
  const int nv = hi - lo;
  // the sweep's stage s: a tile's nc chunks of k (pass 0), then its
  // chunks lo .. hi - 1 of v (pass 1); the no-key pass's: those of tile
  // s / nv's v
  int ns = (nc + nv) * nkt;
  bool nokey_pass = false;
  auto issue = [&](int s) {
    if (s < ns) {
      const int tile = s / (nokey_pass ? nv : nc + nv);
      const int r = nokey_pass ? nc + s % nv : s % (nc + nv);
      wide_copy<kWideKeys, kWideChunk>(
          ring + (s % kS) * kWideStage, r < nc ? kbase : vbase,
          tile * kWideKeys, Tk,
          (!wide_splits(NC) || r < nc ? r % nc : lo + r - nc) * kWideChunk,
          D, kWideLd);
    }
    cp_commit();
  };
  for (int i = 0; i < kS - 1; ++i) issue(i);
  wide_frag(q_f, q + static_cast<size_t>(bn) * Tq * D, q0, Tq, D,
            nc * kWideChunk / 8);
  float acc[NC][4];
  zero_acc(acc);
  float m_a = kNeg, m_b = kNeg, l_a = 0.f, l_b = 0.f;  // rows g, g + 8
  int s = 0;
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * kWideKeys, col = 8 * warp + 2 * t;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if (c < nc) {
        const float* st = WIDE_NEXT(s);
        wide_scores<true>(x, q_f, 0, c * kWideChunk, st,
                                     8 * warp, g, t);
        ++s;
      }
    }
    float mx_a = kNeg, mx_b = kNeg;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kj = k0 + col + (e & 1), row = e < 2 ? ra : rb;
      if (kj >= Tk) {
        x[e] = -INFINITY;  // the tile's tail: left out
      } else {
        x[e] *= scale;
        if (!(mrow == nullptr || mrow[kj] > 0.f) ||
            (causal && kj > row + off))
          x[e] = kNeg;
      }
    }
    mx_a = quad_max(fmaxf(mx_a, fmaxf(x[0], x[1])));
    mx_b = quad_max(fmaxf(mx_b, fmaxf(x[2], x[3])));
    if (t == 0) {
      mxw[warp * kWideRows + g] = mx_a;
      mxw[warp * kWideRows + g + 8] = mx_b;
    }
    __syncthreads();
    float ma = mxw[g], mb = mxw[g + 8];
#pragma unroll
    for (int w = 1; w < kWideWarps; ++w) {
      ma = fmaxf(ma, mxw[w * kWideRows + g]);
      mb = fmaxf(mb, mxw[w * kWideRows + g + 8]);
    }
    const float mn_a = fmaxf(m_a, ma), mn_b = fmaxf(m_b, mb);
    const float al_a = expf(m_a - mn_a), al_b = expf(m_b - mn_b);
    x[0] = expf(x[0] - mn_a);
    x[1] = expf(x[1] - mn_a);
    x[2] = expf(x[2] - mn_b);
    x[3] = expf(x[3] - mn_b);
    const float sa = quad_sum(x[0] + x[1]), sb = quad_sum(x[2] + x[3]);
    if (t == 0) {
      smw[warp * kWideRows + g] = sa;
      smw[warp * kWideRows + g + 8] = sb;
    }
    wide_put_p4(pb, x, warp, g, t);
    m_a = mn_a;
    m_b = mn_b;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      acc[c][0] *= al_a;
      acc[c][1] *= al_a;
      acc[c][2] *= al_b;
      acc[c][3] *= al_b;
    }
    // the next stage's synchronisation publishes P and the row sums
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if (c >= lo && c < hi) {
        const float* st = WIDE_NEXT(s);
        wide_accumulate(acc[c], pb, st, 8 * warp, g, t);
        ++s;
      }
    }
    // l = l alpha + the tile's sum, the warps' sums in warp order (read
    // before the next tile's scores are written: their chunks'
    // synchronisations come first)
    float ta = smw[g], tb = smw[g + 8];
#pragma unroll
    for (int w = 1; w < kWideWarps; ++w) {
      ta += smw[w * kWideRows + g];
      tb += smw[w * kWideRows + g + 8];
    }
    l_a = l_a * al_a + ta;
    l_b = l_b * al_b + tb;
  }
  cp_wait<0>();
  // rows that see no key: the sum of v over every key, for them alone,
  // through the ring (P = 1 on those rows' keys below Tk)
  const bool nk_a = ra < Tq && m_a == kNeg, nk_b = rb < Tq && m_b == kNeg;
  if (__syncthreads_or(nk_a || nk_b)) {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if (nk_a) acc[c][0] = acc[c][1] = 0.f;
      if (nk_b) acc[c][2] = acc[c][3] = 0.f;
    }
    const int nk = (Tk + kWideKeys - 1) / kWideKeys;
    nokey_pass = true;
    ns = nv * nk;
    s = 0;
    for (int i = 0; i < kS - 1; ++i) issue(i);
    for (int kt = 0; kt < nk; ++kt) {
      const int kc = kt * kWideKeys + 8 * warp + 2 * t;
      float one[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        one[e] = (e < 2 ? nk_a : nk_b) && kc + (e & 1) < Tk ? 1.f : 0.f;
      __syncthreads();  // every warp's reads of the last P are done
      wide_put_p4(pb, one, warp, g, t);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        if (c >= lo && c < hi) {
          const float* st = WIDE_NEXT(s);
          wide_accumulate(acc[c], pb, st, 8 * warp, g, t);
          ++s;
        }
      }
    }
    cp_wait<0>();
  }
  const float tk_pad = padded_keys(Tk);
  const float li_a = nk_a ? tk_pad : l_a, li_b = nk_b ? tk_pad : l_b;
  if ((!wide_splits(NC) || blockIdx.z == 0) && warp == 0 && t == 0) {
    const size_t at = static_cast<size_t>(bn) * Tq;
    const size_t at_l = (static_cast<size_t>(BN) + bn) * Tq;
    if (ra < Tq) {
      stats[at + ra] = m_a;
      stats[at_l + ra] = logf(li_a);
    }
    if (rb < Tq) {
      stats[at + rb] = m_b;
      stats[at_l + rb] = logf(li_b);
    }
  }
  // o = acc / l, as blockwise_attention divides
  wide_store<true>(o + static_cast<size_t>(bn) * Tq * D, acc, li_a, li_b,
                   q0, Tq, lo, hi, D, warp, g, t);
}

// dq and delta: a block of query rows, sweeping the kv tiles (as the
// forward) with its rows' m, log l and delta = rowsum(dO o)
template <int NC>
__global__ void __launch_bounds__(kWideThreads)
flash_wide_dq_kernel(const float* __restrict__ q,
                     const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ mask,
                     const float* __restrict__ o,
                     const float* __restrict__ dout,
                     const float* __restrict__ stats,
                     float* __restrict__ delta, float* __restrict__ dq,
                     int BN, int N, int Tq, int Tk, int D, int causal,
                     float scale) {
  constexpr int kS = kWideStagesBwd;
  constexpr bool kFrag = wide_presplit(1, NC);
  extern __shared__ __align__(16) float smem[];
  const int ld = wide_ld(D), nc = wide_chunks(D);
  // this block's q and dO, pre-split (2 x 16 x Dp words) or raw (16 x ld)
  const int rs = kFrag ? 2 * kWideRows * nc * kWideChunk : kWideRows * ld;
  float* q_s = smem;
  float* do_s = q_s + rs;
  float* ring = do_s + rs;                // chunks of k or v
  unsigned* pb = reinterpret_cast<unsigned*>(ring + kS * kWideStage);
  float* dl_s = ring + kS * kWideStage + kWideP;  // [16] delta
  const int bn = blockIdx.x, b = bn / N;
  const int qb = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = qb * kWideRows, off = Tk - Tq;
  const int ra = q0 + g, rb = ra + 8;
  const size_t q_at = static_cast<size_t>(bn) * Tq * D;
  const float* kbase = k + static_cast<size_t>(bn) * Tk * D;
  const float* vbase = v + static_cast<size_t>(bn) * Tk * D;
  const float* mrow = mask ? mask + static_cast<size_t>(b) * Tk : nullptr;
  // a kv row with no real key: every dS is 0, the sweep is skipped
  const int nkt = first_key<kWideThreads>(mrow, Tk,
                                          reinterpret_cast<int*>(dl_s)) >= Tk
                      ? 0
                      : wide_kv_tiles(q0, Tq, Tk, causal);
  int lo, hi;
  wide_part<NC>(nc, lo, hi);
  // stage s: a tile's nc chunks of k (pass 0) and of v (1), then its
  // chunks lo .. hi - 1 of k again (2)
  const int per = 2 * nc + hi - lo, ns = per * nkt;
  auto issue = [&](int s) {
    if (s < ns) {
      const int tile = s / per, r = s % per;
      wide_copy<kWideKeys, kWideChunk>(
          ring + (s % kS) * kWideStage,
          r / nc == 1 ? vbase : kbase, tile * kWideKeys, Tk,
          (!wide_splits(NC) || r < 2 * nc ? r % nc : lo + r - 2 * nc) *
              kWideChunk,
          D, kWideLd);
    }
    cp_commit();
  };
  wide_a_rows<kFrag>(q_s, q + q_at, q0, Tq, nc, D, ld);
  wide_a_rows<kFrag>(do_s, dout + q_at, q0, Tq, nc, D, ld);
  for (int i = 0; i < kS - 1; ++i) issue(i);
  {
    // delta of row sr: its 16 threads' columns sc + 16 i in order, then
    // xor shuffles within them (the same bits on each)
    const int sr = threadIdx.x >> 4, sc = threadIdx.x & 15, row = q0 + sr;
    float dl = 0.f;
    if (row < Tq) {
      const float* orow = o + q_at + static_cast<size_t>(row) * D;
      const float* drow = dout + q_at + static_cast<size_t>(row) * D;
      for (int d = sc; d < D; d += 16) dl = fmaf(drow[d], orow[d], dl);
    }
#pragma unroll
    for (int w = 8; w > 0; w >>= 1) dl += __shfl_xor_sync(kFull, dl, w);
    if (sc == 0) {
      dl_s[sr] = dl;
      if ((!wide_splits(NC) || blockIdx.z == 0) && row < Tq)
        delta[static_cast<size_t>(bn) * Tq + row] = dl;
    }
  }
  __syncthreads();
  const size_t at = static_cast<size_t>(bn) * Tq;
  const size_t at_l = (static_cast<size_t>(BN) + bn) * Tq;
  const float dl_a = dl_s[g], dl_b = dl_s[g + 8];
  const float m_a = ra < Tq ? stats[at + ra] : 0.f;
  const float m_b = rb < Tq ? stats[at + rb] : 0.f;
  const float ll_a = ra < Tq ? stats[at_l + ra] : 0.f;
  const float ll_b = rb < Tq ? stats[at_l + rb] : 0.f;
  float acc[NC][4];
  zero_acc(acc);
  int s = 0;
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * kWideKeys, col = 8 * warp + 2 * t;
    float x[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if (c < nc) {
        const float* st = WIDE_NEXT(s);
        wide_scores<kFrag>(x, q_s, ld, c * kWideChunk, st,
                                      8 * warp, g, t);
        ++s;
      }
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if (c < nc) {
        const float* st = WIDE_NEXT(s);
        wide_scores<kFrag>(dp, do_s, ld, c * kWideChunk, st,
                                      8 * warp, g, t);
        ++s;
      }
    }
    // dS = P (dP - delta), 0 where a score was masked (published to the
    // other warps by the next stage's synchronisation)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kj = k0 + col + (e & 1), row = e < 2 ? ra : rb;
      const bool live = kj < Tk && row < Tq &&
                        (mrow == nullptr || mrow[kj] > 0.f) &&
                        !(causal && kj > row + off);
      x[e] = live ? expf((x[e] * scale - (e < 2 ? m_a : m_b)) -
                         (e < 2 ? ll_a : ll_b)) *
                        (dp[e] - (e < 2 ? dl_a : dl_b))
                  : 0.f;
    }
    wide_put_p4(pb, x, warp, g, t);
    // dQ += dS K
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if (c >= lo && c < hi) {
        const float* st = WIDE_NEXT(s);
        wide_accumulate(acc[c], pb, st, 8 * warp, g, t);
        ++s;
      }
    }
  }
  cp_wait<0>();
  wide_store<false>(dq + q_at, acc, scale, scale, q0, Tq, lo, hi, D, warp, g,
                    t);
}

// dk and dv: a block of keys, sweeping the query tiles that hold a row
// which sees one of its keys or sees no key (as flash_bwd_dkdv_kernel)
template <int NC>
__global__ void __launch_bounds__(kWideThreads)
flash_wide_dkdv_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ mask,
                       const float* __restrict__ dout,
                       const float* __restrict__ stats,
                       const float* __restrict__ delta,
                       float* __restrict__ dk, float* __restrict__ dv,
                       int BN, int N, int Tq, int Tk, int D, int causal,
                       float scale) {
  constexpr int kS = kWideStagesBwd;
  constexpr bool kFrag = wide_presplit(2, NC);
  extern __shared__ __align__(16) float smem[];
  const int ld = wide_ld(D), nc = wide_chunks(D);
  // this block's keys and their v, pre-split or raw (as dq's)
  const int rs = kFrag ? 2 * kWideRows * nc * kWideChunk : kWideRows * ld;
  float* k_s = smem;
  float* v_s = k_s + rs;
  float* ring = v_s + rs;                 // chunks of q or dO
  unsigned* pb = reinterpret_cast<unsigned*>(ring + kS * kWideStage);
  int* ired = reinterpret_cast<int*>(ring + kS * kWideStage + kWideP);
  const int bn = blockIdx.x, b = bn / N;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.y * kWideRows, off = Tk - Tq;
  const int ka = k0 + g, kb = ka + 8;  // this lane's keys (rows of S^T)
  const size_t k_at = static_cast<size_t>(bn) * Tk * D;
  const float* qbase = q + static_cast<size_t>(bn) * Tq * D;
  const float* dobase = dout + static_cast<size_t>(bn) * Tq * D;
  const float* m_s = stats + static_cast<size_t>(bn) * Tq;
  const float* ll_s = stats + (static_cast<size_t>(BN) + bn) * Tq;
  const float* dl_s = delta + static_cast<size_t>(bn) * Tq;
  const float* mrow = mask ? mask + static_cast<size_t>(b) * Tk : nullptr;
  wide_a_rows<kFrag>(k_s, k + k_at, k0, Tk, nc, D, ld);
  wide_a_rows<kFrag>(v_s, v + k_at, k0, Tk, nc, D, ld);
  // the rows that see no key: with causal the first (first real key) -
  // (Tk - Tq); without, every row of a kv row with no real key
  const int fk = first_key<kWideThreads>(mrow, Tk, ired);
  const int nokey_rows =
      causal ? (fk - off < 0 ? 0 : (fk - off < Tq ? fk - off : Tq))
             : (fk >= Tk ? Tq : 0);
  const bool mk_a = ka < Tk && (mrow == nullptr || mrow[ka] > 0.f);
  const bool mk_b = kb < Tk && (mrow == nullptr || mrow[kb] > 0.f);
  // a block with none of its keys real has dK = 0 and dV only from the
  // rows that see no key: it visits their tiles and stages dO alone
  const bool live_keys = __syncthreads_or(mk_a || mk_b);
  // the query tiles to visit: with causal, those holding a row that sees
  // one of this block's keys, and those holding a row that sees no key
  const int nq = (Tq + kWideKeys - 1) / kWideKeys;
  const int nokey_qt = (nokey_rows + kWideKeys - 1) / kWideKeys;
  const int first_qt =
      !live_keys ? nq
                 : (causal ? (k0 - off > 0 ? k0 - off : 0) / kWideKeys : 0);
  const int from = nokey_qt > first_qt ? nokey_qt : first_qt;
  const int nvis = nokey_qt + (nq > from ? nq - from : 0);
  auto tile_of = [&](int i) {
    return i < nokey_qt ? i : from + i - nokey_qt;
  };
  int lo, hi;
  wide_part<NC>(nc, lo, hi);
  // stage s: a tile's nc chunks of q (pass 0) and of dO (1), then its
  // chunks lo .. hi - 1 of q again (2); a block without a live key stages
  // the dO chunks lo .. hi - 1 alone
  const int per = live_keys ? 2 * nc + hi - lo : hi - lo, ns = per * nvis;
  auto issue = [&](int s) {
    if (s < ns) {
      const int tile = s / per, r = s % per;
      const int chunk = !wide_splits(NC) ? r % nc
                        : !live_keys    ? lo + r
                        : r < 2 * nc    ? r % nc
                                        : lo + r - 2 * nc;
      wide_copy<kWideKeys, kWideChunk>(
          ring + (s % kS) * kWideStage,
          !live_keys || r / nc == 1 ? dobase : qbase,
          tile_of(tile) * kWideKeys, Tq, chunk * kWideChunk, D, kWideLd);
    }
    cp_commit();
  };
  for (int i = 0; i < kS - 1; ++i) issue(i);
  float dk_acc[NC][4], dv_acc[NC][4];
  zero_acc(dk_acc);
  zero_acc(dv_acc);
  int s = 0;
  for (int i = 0; i < nvis; ++i) {
    const int qc = tile_of(i) * kWideKeys + 8 * warp + 2 * t;
    float x[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
    // S^T = K Q^T over the tile's q, then P^T
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if (live_keys && c < nc) {
        const float* st = WIDE_NEXT(s);
        wide_scores<kFrag>(x, k_s, ld, c * kWideChunk, st, 8 * warp, g, t);
        ++s;
      }
    }
    bool live[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int qi = qc + (e & 1), key = e < 2 ? ka : kb;
      const bool valid = key < Tk && qi < Tq;
      live[e] = valid && (e < 2 ? mk_a : mk_b) && !(causal && key > qi + off);
      // a masked score's P is 0 but for a row that sees no key
      x[e] = valid ? expf(((live[e] ? x[e] * scale : kNeg) - m_s[qi]) -
                          ll_s[qi])
                   : 0.f;
    }
    // (with live keys the q chunks' synchronisations came first)
    if (!live_keys) __syncthreads();  // every warp's reads of P^T are done
    wide_put_p4(pb, x, warp, g, t);
    // dP^T = V dO^T and dV += P^T dO (the part's chunks), from one
    // staging of dO
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const bool own = c >= lo && c < hi;
      if (c < nc && (live_keys || own)) {
        const float* st = WIDE_NEXT(s);
        if (live_keys)
          wide_scores<kFrag>(dp, v_s, ld, c * kWideChunk, st, 8 * warp, g,
                             t);
        if (own) wide_accumulate(dv_acc[c], pb, st, 8 * warp, g, t);
        ++s;
      }
    }
    if (!live_keys) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int qi = qc + (e & 1);
      x[e] = live[e] ? x[e] * (dp[e] - dl_s[qi]) : 0.f;
    }
    __syncthreads();  // every warp's reads of P^T are done
    wide_put_p4(pb, x, warp, g, t);
    // dK += dS^T Q
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if (c >= lo && c < hi) {
        const float* st = WIDE_NEXT(s);
        wide_accumulate(dk_acc[c], pb, st, 8 * warp, g, t);
        ++s;
      }
    }
  }
  cp_wait<0>();
  wide_store<false>(dv + k_at, dv_acc, 1.f, 1.f, k0, Tk, lo, hi, D, warp, g,
                    t);
  wide_store<false>(dk + k_at, dk_acc, scale, scale, k0, Tk, lo, hi, D, warp,
                    g, t);
}
#undef WIDE_NEXT

// ------------------------------------------------------ split rows
// D > kWideMaxD, any width: a block of kSplitThreads threads owns one row
// (a query row in the forward and dq, a key in dkdv) and splits its D
// across all of its warps: thread t holds the elements d = t +
// kSplitThreads u. The row's accumulator (o, dq, or dk and dv) lives in
// the output row itself, each element read and written only by its
// owner thread; the streamed rows are read from global memory (L2),
// kSplitRows of them a step. A step's dot products are each thread's
// terms in order, each warp's xor butterfly, then the kSplitWarps warps'
// partials added in warp order from shared memory: the same bits on
// every thread and over two runs, no atomics. The online softmax, masks,
// causal offset, key tails and rows that see no key follow the wide
// path's rules. f32 on the CUDA cores; speed recorded, not targeted.
constexpr int kSplitWarps = 8;
constexpr int kSplitThreads = 32 * kSplitWarps;
constexpr int kSplitRows = 8;  // streamed rows a step

// the block's sums of R per-thread partials (R <= 2 kSplitRows), in place;
// red: the block's [2][kSplitWarps][2 kSplitRows] floats, alternate halves
// by `phase` so that one barrier a call suffices
template <int R>
__device__ __forceinline__ void split_sums(float (&v)[R], float* red,
                                           int& phase) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* half = red + phase * kSplitWarps * 2 * kSplitRows;
  phase ^= 1;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float x = v[r];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
    if (lane == 0) half[warp * 2 * kSplitRows + r] = x;
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float x = half[r];
    for (int w = 1; w < kSplitWarps; ++w) x += half[w * 2 * kSplitRows + r];
    v[r] = x;
  }
}

// a key visible from a query row: within Tk, unmasked, not past the
// row's diagonal
__device__ __forceinline__ bool split_visible(const float* mrow, int kj,
                                              int qi, int off, int causal) {
  return (mrow == nullptr || mrow[kj] > 0.f) && !(causal && kj > qi + off);
}

__global__ void __launch_bounds__(kSplitThreads)
flash_split_fwd_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ mask, float* __restrict__ o,
                       float* __restrict__ stats, int BN, int N, int Tq,
                       int Tk, int D, int causal, float scale) {
  __shared__ float red[2 * kSplitWarps * 2 * kSplitRows];
  int phase = 0;
  const int bn = blockIdx.x / Tq, row = blockIdx.x % Tq, b = bn / N;
  const int off = Tk - Tq, tid = threadIdx.x;
  const float* qr = q + (static_cast<size_t>(bn) * Tq + row) * D;
  const float* kb = k + static_cast<size_t>(bn) * Tk * D;
  const float* vb = v + static_cast<size_t>(bn) * Tk * D;
  float* orow = o + (static_cast<size_t>(bn) * Tq + row) * D;
  const float* mrow = mask ? mask + static_cast<size_t>(b) * Tk : nullptr;
  for (int d = tid; d < D; d += kSplitThreads) orow[d] = 0.f;
  float m = kNeg, l = 0.f;
  for (int k0 = 0; k0 < Tk && !(causal && k0 > row + off);
       k0 += kSplitRows) {
    float s[kSplitRows];
#pragma unroll
    for (int r = 0; r < kSplitRows; ++r) {
      const int kj = k0 + r;
      float part = 0.f;
      if (kj < Tk) {
        const float* kr = kb + static_cast<size_t>(kj) * D;
        for (int d = tid; d < D; d += kSplitThreads) part += qr[d] * kr[d];
      }
      s[r] = part;
    }
    split_sums<kSplitRows>(s, red, phase);
    float mx = kNeg;
#pragma unroll
    for (int r = 0; r < kSplitRows; ++r) {
      const int kj = k0 + r;
      // the tile's tail is left out; a masked score takes the fill
      s[r] = kj >= Tk ? -INFINITY
                      : (split_visible(mrow, kj, row, off, causal)
                             ? s[r] * scale
                             : kNeg);
      mx = fmaxf(mx, s[r]);
    }
    const float mn = fmaxf(m, mx);
    const float al = expf(m - mn);
    float sum = 0.f;
#pragma unroll
    for (int r = 0; r < kSplitRows; ++r) {
      s[r] = expf(s[r] - mn);
      sum += s[r];
    }
    l = l * al + sum;
    m = mn;
    for (int d = tid; d < D; d += kSplitThreads) {
      float acc = orow[d] * al;
#pragma unroll
      for (int r = 0; r < kSplitRows; ++r)
        if (k0 + r < Tk) acc += s[r] * vb[static_cast<size_t>(k0 + r) * D + d];
      orow[d] = acc;
    }
  }
  if (m == kNeg) {  // the row sees no key: JAX's padded mean of v
    for (int d = tid; d < D; d += kSplitThreads) {
      float acc = 0.f;
      for (int j = 0; j < Tk; ++j) acc += vb[static_cast<size_t>(j) * D + d];
      orow[d] = acc;
    }
    l = padded_keys(Tk);
  }
  for (int d = tid; d < D; d += kSplitThreads) orow[d] = orow[d] / l;
  if (tid == 0) {
    stats[static_cast<size_t>(bn) * Tq + row] = m;
    stats[(static_cast<size_t>(BN) + bn) * Tq + row] = logf(l);
  }
}

// dq and delta: a block a query row, sweeping the keys as the forward
__global__ void __launch_bounds__(kSplitThreads)
flash_split_dq_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ mask,
                      const float* __restrict__ o,
                      const float* __restrict__ dout,
                      const float* __restrict__ stats,
                      float* __restrict__ delta, float* __restrict__ dq,
                      int BN, int N, int Tq, int Tk, int D, int causal,
                      float scale) {
  __shared__ float red[2 * kSplitWarps * 2 * kSplitRows];
  int phase = 0;
  const int bn = blockIdx.x / Tq, row = blockIdx.x % Tq, b = bn / N;
  const int off = Tk - Tq, tid = threadIdx.x;
  const size_t r_at = static_cast<size_t>(bn) * Tq + row;
  const float* qr = q + r_at * D;
  const float* dor = dout + r_at * D;
  const float* orow = o + r_at * D;
  const float* kb = k + static_cast<size_t>(bn) * Tk * D;
  const float* vb = v + static_cast<size_t>(bn) * Tk * D;
  float* dqrow = dq + r_at * D;
  const float* mrow = mask ? mask + static_cast<size_t>(b) * Tk : nullptr;
  float dl[1] = {0.f};
  for (int d = tid; d < D; d += kSplitThreads) {
    dl[0] += dor[d] * orow[d];
    dqrow[d] = 0.f;
  }
  split_sums<1>(dl, red, phase);
  if (tid == 0) delta[r_at] = dl[0];
  const float m_i = stats[r_at];
  const float ll_i = stats[static_cast<size_t>(BN) * Tq + r_at];
  for (int k0 = 0; k0 < Tk && !(causal && k0 > row + off);
       k0 += kSplitRows) {
    float sd[2 * kSplitRows];  // the scores' dots, then dO . v
#pragma unroll
    for (int r = 0; r < kSplitRows; ++r) {
      const int kj = k0 + r;
      float ps = 0.f, pd = 0.f;
      if (kj < Tk) {
        const float* kr = kb + static_cast<size_t>(kj) * D;
        const float* vr = vb + static_cast<size_t>(kj) * D;
        for (int d = tid; d < D; d += kSplitThreads) {
          ps += qr[d] * kr[d];
          pd += dor[d] * vr[d];
        }
      }
      sd[r] = ps;
      sd[kSplitRows + r] = pd;
    }
    split_sums<2 * kSplitRows>(sd, red, phase);
    float ds[kSplitRows];
#pragma unroll
    for (int r = 0; r < kSplitRows; ++r) {
      const int kj = k0 + r;
      // a masked score takes no gradient
      ds[r] = kj < Tk && split_visible(mrow, kj, row, off, causal)
                  ? expf((sd[r] * scale - m_i) - ll_i) *
                        (sd[kSplitRows + r] - dl[0])
                  : 0.f;
    }
    for (int d = tid; d < D; d += kSplitThreads) {
      float acc = dqrow[d];
#pragma unroll
      for (int r = 0; r < kSplitRows; ++r)
        if (k0 + r < Tk)
          acc += ds[r] * kb[static_cast<size_t>(k0 + r) * D + d];
      dqrow[d] = acc;
    }
  }
  for (int d = tid; d < D; d += kSplitThreads) dqrow[d] = dqrow[d] * scale;
}

// dk and dv: a block a key row, sweeping every query row
__global__ void __launch_bounds__(kSplitThreads)
flash_split_dkdv_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ mask,
                        const float* __restrict__ dout,
                        const float* __restrict__ stats,
                        const float* __restrict__ delta,
                        float* __restrict__ dk, float* __restrict__ dv,
                        int BN, int N, int Tq, int Tk, int D, int causal,
                        float scale) {
  __shared__ float red[2 * kSplitWarps * 2 * kSplitRows];
  int phase = 0;
  const int bn = blockIdx.x / Tk, key = blockIdx.x % Tk, b = bn / N;
  const int off = Tk - Tq, tid = threadIdx.x;
  const size_t k_at = (static_cast<size_t>(bn) * Tk + key) * D;
  const float* kr = k + k_at;
  const float* vr = v + k_at;
  const float* qb = q + static_cast<size_t>(bn) * Tq * D;
  const float* dob = dout + static_cast<size_t>(bn) * Tq * D;
  const float* m_s = stats + static_cast<size_t>(bn) * Tq;
  const float* ll_s = stats + (static_cast<size_t>(BN) + bn) * Tq;
  const float* dl_s = delta + static_cast<size_t>(bn) * Tq;
  const bool mk =
      mask == nullptr || mask[static_cast<size_t>(b) * Tk + key] > 0.f;
  for (int d = tid; d < D; d += kSplitThreads) dk[k_at + d] = dv[k_at + d] = 0.f;
  for (int q0 = 0; q0 < Tq; q0 += kSplitRows) {
    float sd[2 * kSplitRows];
    bool live[kSplitRows];
#pragma unroll
    for (int r = 0; r < kSplitRows; ++r) {
      const int qi = q0 + r;
      live[r] = qi < Tq && mk && !(causal && key > qi + off);
      float ps = 0.f, pd = 0.f;
      if (live[r]) {
        const float* qr = qb + static_cast<size_t>(qi) * D;
        const float* dor = dob + static_cast<size_t>(qi) * D;
        for (int d = tid; d < D; d += kSplitThreads) {
          ps += kr[d] * qr[d];
          pd += vr[d] * dor[d];
        }
      }
      sd[r] = ps;
      sd[kSplitRows + r] = pd;
    }
    split_sums<2 * kSplitRows>(sd, red, phase);
    float p[kSplitRows], w[kSplitRows];
#pragma unroll
    for (int r = 0; r < kSplitRows; ++r) {
      const int qi = q0 + r;
      p[r] = w[r] = 0.f;
      // a masked score's P is 0 but for a row that sees no key
      if (qi < Tq && (live[r] || m_s[qi] == kNeg)) {
        const float s = live[r] ? sd[r] * scale : kNeg;
        p[r] = expf((s - m_s[qi]) - ll_s[qi]);
        if (live[r]) w[r] = p[r] * (sd[kSplitRows + r] - dl_s[qi]);
      }
    }
    for (int d = tid; d < D; d += kSplitThreads) {
      float av = dv[k_at + d], ak = dk[k_at + d];
#pragma unroll
      for (int r = 0; r < kSplitRows; ++r) {
        if (q0 + r >= Tq) continue;
        const size_t at = static_cast<size_t>(q0 + r) * D + d;
        av += p[r] * dob[at];
        ak += w[r] * qb[at];
      }
      dv[k_at + d] = av;
      dk[k_at + d] = ak;
    }
  }
  for (int d = tid; d < D; d += kSplitThreads) dk[k_at + d] *= scale;
}

// ------------------------------------------------------------ bf16 form
using bf16 = __nv_bfloat16;

// keys a kv stage of the forward and of dq, queries a query stage of dkdv
__host__ __device__ constexpr int bf_kv_cols(int) { return 64; }
__host__ __device__ constexpr int bf_dq_cols(int D) { return D == 128 ? 32 : 64; }
__host__ __device__ constexpr int bf_q_cols(int D) { return D == 128 ? 32 : 64; }
// row stride of every bf16 tile, elements: an odd number of 16-byte
// chunks, so that the 8 rows an ldmatrix reads lie in 8 bank groups
__host__ __device__ constexpr int bf_ld(int D) {
  return (D / 8) % 2 ? D : D + 8;
}
// bytes of a tile of `rows` rows, of a ring stage (two tiles and `vecs`
// f32 vectors of its rows), of each kernel's dynamic shared memory
__host__ __device__ constexpr int bf_tile(int D, int rows) {
  return 2 * rows * bf_ld(D);
}
__host__ __device__ constexpr int bf_stage(int D, int rows, int vecs) {
  return 2 * bf_tile(D, rows) + 4 * vecs * rows;
}
__host__ __device__ constexpr size_t bf_fwd_smem(int D) {
  return bf_tile(D, kRows) + 2 * bf_stage(D, bf_kv_cols(D), 1);
}
__host__ __device__ constexpr size_t bf_dq_smem(int D) {
  return 2 * bf_tile(D, kRows) + 2 * bf_stage(D, bf_dq_cols(D), 1) +
         4 * kRows;
}
__host__ __device__ constexpr size_t bf_dkdv_smem(int D) {
  return 2 * bf_tile(D, kRows) + 2 * bf_stage(D, bf_q_cols(D), 3) +
         sizeof(int) * kWarps;
}

// rows [row0, row0 + R) of a [rows, D] bf16 matrix into dst (row stride
// bf_ld(D)) by 16-byte cp.async, zeros past its last row; every thread of
// the block takes part
template <int D, int R>
__device__ __forceinline__ void copy_tile_bf(bf16* dst,
                                             const bf16* __restrict__ src,
                                             int row0, int rows) {
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < R * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i - r * kChunks) * 8;
    const int row = row0 + r;
    const bool valid = row < rows;
    cp16(reinterpret_cast<float*>(dst + r * bf_ld(D) + c),
         reinterpret_cast<const float*>(
             src + (valid ? static_cast<size_t>(row) * D + c : 0)),
         valid);
  }
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two values as a bf16x2 register, rounded to nearest even (lo: the
// lower column, in the low half)
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  unsigned r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// c[j] (16 rows x kNt tiles of 8, kNt even) += A B^T over D: A rows
// [r0, r0 + 16)
// of tile as, B^T the first kNt * 8 rows of tile bs (both [rows][D]). The
// tensor cores round their sums toward zero: every kSteps k16 steps (at
// most) go to a fresh accumulator, added to c in f32.
template <int D, int kNt, int kSteps>
__device__ __forceinline__ void score_bf(float (&c)[kNt][4], const bf16* as,
                                         int r0, const bf16* bs, int lane) {
  constexpr int kLd = bf_ld(D), kK = D / 16;
  constexpr int kStep = kK < kSteps ? kK : kSteps;
#pragma unroll
  for (int kk = 0; kk < kK; kk += kStep) {
    unsigned a[kStep][4];
#pragma unroll
    for (int h = 0; h < kStep; ++h)
      ldsm_x4(a[h], as + (r0 + (lane & 15)) * kLd + 16 * (kk + h) +
                        8 * (lane >> 4));
#pragma unroll
    for (int j = 0; j < kNt; j += 2) {  // two n8 tiles an ldmatrix
      float u0[4] = {0.f, 0.f, 0.f, 0.f}, u1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int h = 0; h < kStep; ++h) {
        unsigned b[4];
        ldsm_x4(b, bs + (8 * j + (lane & 7) + ((lane >> 4) << 3)) * kLd +
                       16 * (kk + h) + 8 * ((lane >> 3) & 1));
        mma_bf16(u0, a[h], b[0], b[1]);
        mma_bf16(u1, a[h], b[2], b[3]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        c[j][i] += u0[i];
        c[j + 1][i] += u1[i];
      }
    }
  }
}

// acc (16 rows x D) += p (16 x kNt * 8, accumulators) times the rows of
// tile xs ([kNt * 8][D], read transposed): the two n8 accumulators of a
// k16 step are its A fragment. kSplit: p is not a bf16 value, so it
// takes two terms, lo = p - hi then hi; else p is rounded to bf16. The
// tile's sum in a fresh accumulator for each 8 columns of acc.
template <int D, int kNt, bool kSplit>
__device__ __forceinline__ void accumulate_bf(float (&acc)[D / 8][4],
                                              const float (&p)[kNt][4],
                                              const bf16* xs, int lane) {
  constexpr int kLd = bf_ld(D), kK = kNt / 2;
  unsigned hi[kK][4], lo[kK][4];
#pragma unroll
  for (int kk = 0; kk < kK; ++kk) {
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const float* c = p[2 * kk + (h >> 1)];
      const float x = c[2 * (h & 1)], y = c[2 * (h & 1) + 1];
      const unsigned v = pack_bf16(x, y);
      hi[kk][h] = v;
      if constexpr (kSplit)
        lo[kk][h] = pack_bf16(x - __uint_as_float(v << 16),
                              y - __uint_as_float(v & 0xffff0000u));
    }
  }
#pragma unroll
  for (int dn = 0; dn < D / 8; dn += 2) {
    float u0[4] = {0.f, 0.f, 0.f, 0.f}, u1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < kK; ++kk) {
      unsigned b[4];
      ldsm_x4_t(b, xs + (16 * kk + (lane & 15)) * kLd + 8 * dn +
                       8 * (lane >> 4));
      if constexpr (kSplit) {
        mma_bf16(u0, lo[kk], b[0], b[1]);
        mma_bf16(u1, lo[kk], b[2], b[3]);
      }
      mma_bf16(u0, hi[kk], b[0], b[1]);
      mma_bf16(u1, hi[kk], b[2], b[3]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc[dn][i] += u0[i];
      acc[dn + 1][i] += u1[i];
    }
  }
}

// rows [r0 + g, r0 + g + 8] of a [rows, D] bf16 output from acc * mul
template <int D>
__device__ __forceinline__ void store_rows_bf(bf16* __restrict__ dst,
                                              const float (&acc)[D / 8][4],
                                              float mul_a, float mul_b,
                                              int r0, int rows, int g,
                                              int t) {
  const int ra = r0 + g, rb = ra + 8;
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    const int c = dn * 8 + 2 * t;
    if (ra < rows)
      *reinterpret_cast<__nv_bfloat162*>(dst + static_cast<size_t>(ra) * D +
                                         c) =
          __floats2bfloat162_rn(acc[dn][0] * mul_a, acc[dn][1] * mul_a);
    if (rb < rows)
      *reinterpret_cast<__nv_bfloat162*>(dst + static_cast<size_t>(rb) * D +
                                         c) =
          __floats2bfloat162_rn(acc[dn][2] * mul_b, acc[dn][3] * mul_b);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const float* __restrict__ mask, bf16* __restrict__ o,
                      float* __restrict__ stats, int BN, int N, int Tq,
                      int Tk, int causal, float scale) {
  constexpr int kC = bf_kv_cols(D), kLd = bf_ld(D), kNt = kC / 8;
  constexpr int kDt = D / 8;
  constexpr int kStage = bf_stage(D, kC, 1) / 2;  // bf16 elements
  extern __shared__ uint4 bf_smem[];
  bf16* q_s = reinterpret_cast<bf16*>(bf_smem);  // [64][kLd] this block's q
  bf16* ring = q_s + kRows * kLd;                // 2 stages of k, v, mask
  const int bn = blockIdx.x, b = bn / N;
  // with causal the last query blocks sweep the most tiles: first
  const int qb = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = qb * kRows, r0 = q0 + warp * 16, off = Tk - Tq;
  const int ra = r0 + g, rb = ra + 8;
  const bf16* kbase = k + static_cast<size_t>(bn) * Tk * D;
  const bf16* vbase = v + static_cast<size_t>(bn) * Tk * D;
  const float* mrow = mask ? mask + static_cast<size_t>(b) * Tk : nullptr;
  const int nk = (Tk + kC - 1) / kC;
  const int nkt = kv_tiles(q0, kC, Tq, Tk, causal);

  auto load_stage = [&](int kt) {
    bf16* st = ring + (kt & 1) * kStage;
    copy_tile_bf<D, kC>(st, kbase, kt * kC, Tk);
    copy_tile_bf<D, kC>(st + kC * kLd, vbase, kt * kC, Tk);
    copy_mask(reinterpret_cast<float*>(st + 2 * kC * kLd), mrow, kt * kC, kC,
              Tk);
  };

  copy_tile_bf<D, kRows>(q_s, q + static_cast<size_t>(bn) * Tq * D, q0, Tq);
  load_stage(0);
  cp_commit();
  float acc[kDt][4];
  zero(acc);
  float m_a = kNeg, m_b = kNeg, l_a = 0.f, l_b = 0.f;
  for (int kt = 0; kt < nkt; ++kt) {
    if (kt + 1 < nkt) load_stage(kt + 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const bf16* ks = ring + (kt & 1) * kStage;
    const bf16* vs = ks + kC * kLd;
    const float* ms = reinterpret_cast<const float*>(vs + kC * kLd);
    const int k0 = kt * kC;
    // warp-uniform: rows past Tq, or every key of the tile above the
    // diagonals of this warp's rows
    if (r0 < Tq && !(causal && k0 > r0 + 15 + off)) {
      float s[kNt][4];
      zero(s);
      score_bf<D, kNt, kFwdSteps / 2>(s, q_s, warp * 16, ks, lane);
      float mx_a = kNeg, mx_b = kNeg;
#pragma unroll
      for (int j = 0; j < kNt; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * t + (e & 1), kj = k0 + col;
          const int row = e < 2 ? ra : rb;
          float x;
          if (kj >= Tk) {
            x = -INFINITY;  // the tile's tail: left out
          } else {
            x = s[j][e] * scale;
            if (!(ms[col] > 0.f) || (causal && kj > row + off)) x = kNeg;
          }
          s[j][e] = x;
          if (e < 2)
            mx_a = fmaxf(mx_a, x);
          else
            mx_b = fmaxf(mx_b, x);
        }
      const float mn_a = fmaxf(m_a, quad_max(mx_a));
      const float mn_b = fmaxf(m_b, quad_max(mx_b));
      const float al_a = expf(m_a - mn_a), al_b = expf(m_b - mn_b);
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int j = 0; j < kNt; ++j) {
        s[j][0] = expf(s[j][0] - mn_a);
        s[j][1] = expf(s[j][1] - mn_a);
        s[j][2] = expf(s[j][2] - mn_b);
        s[j][3] = expf(s[j][3] - mn_b);
        sum_a += s[j][0] + s[j][1];
        sum_b += s[j][2] + s[j][3];
      }
      l_a = l_a * al_a + sum_a;
      l_b = l_b * al_b + sum_b;
      m_a = mn_a;
      m_b = mn_b;
#pragma unroll
      for (int dn = 0; dn < kDt; ++dn) {
        acc[dn][0] *= al_a;
        acc[dn][1] *= al_a;
        acc[dn][2] *= al_b;
        acc[dn][3] *= al_b;
      }
      // p rounded to v's type (after l took it) in the A fragments
      accumulate_bf<D, kNt, false>(acc, s, vs, lane);
    }
    __syncthreads();  // the tile's reads are done before it is refilled
  }
  l_a = quad_sum(l_a);
  l_b = quad_sum(l_b);
  // rows that see no key: the sum of v over every key, for them alone
  const bool nk_a = ra < Tq && m_a == kNeg, nk_b = rb < Tq && m_b == kNeg;
  if (__syncthreads_or(nk_a || nk_b)) {
#pragma unroll
    for (int dn = 0; dn < kDt; ++dn) {
      if (nk_a) acc[dn][0] = acc[dn][1] = 0.f;
      if (nk_b) acc[dn][2] = acc[dn][3] = 0.f;
    }
    for (int kt = 0; kt < nk; ++kt) {
      const int k0 = kt * kC;
      copy_tile_bf<D, kC>(ring, vbase, k0, Tk);
      cp_commit();
      cp_wait<0>();
      __syncthreads();
      float p[kNt][4];
#pragma unroll
      for (int j = 0; j < kNt; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          p[j][e] = (e < 2 ? nk_a : nk_b) && k0 + 8 * j + 2 * t + (e & 1) < Tk
                        ? 1.f
                        : 0.f;
      accumulate_bf<D, kNt, false>(acc, p, ring, lane);
      __syncthreads();
    }
  }
  const float tk_pad = padded_keys(Tk);
  const float li_a = nk_a ? tk_pad : l_a, li_b = nk_b ? tk_pad : l_b;
  // o = acc / l, as blockwise_attention divides
  bf16* obase = o + static_cast<size_t>(bn) * Tq * D;
#pragma unroll
  for (int dn = 0; dn < kDt; ++dn) {
    const int c = dn * 8 + 2 * t;
    if (ra < Tq)
      *reinterpret_cast<__nv_bfloat162*>(obase + static_cast<size_t>(ra) * D +
                                         c) =
          __floats2bfloat162_rn(acc[dn][0] / li_a, acc[dn][1] / li_a);
    if (rb < Tq)
      *reinterpret_cast<__nv_bfloat162*>(obase + static_cast<size_t>(rb) * D +
                                         c) =
          __floats2bfloat162_rn(acc[dn][2] / li_b, acc[dn][3] / li_b);
  }
  if (t == 0) {
    const size_t at = static_cast<size_t>(bn) * Tq;
    const size_t at_l = (static_cast<size_t>(BN) + bn) * Tq;
    if (ra < Tq) {
      stats[at + ra] = m_a;
      stats[at_l + ra] = logf(li_a);
    }
    if (rb < Tq) {
      stats[at + rb] = m_b;
      stats[at_l + rb] = logf(li_b);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_bf16_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const float* __restrict__ mask,
                         const bf16* __restrict__ o,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ stats,
                         float* __restrict__ delta, bf16* __restrict__ dq,
                         int BN, int N, int Tq, int Tk, int causal,
                         float scale) {
  constexpr int kC = bf_dq_cols(D), kLd = bf_ld(D), kNt = kC / 8;
  constexpr int kDt = D / 8;
  constexpr int kStage = bf_stage(D, kC, 1) / 2;  // bf16 elements
  extern __shared__ uint4 bf_smem[];
  bf16* q_s = reinterpret_cast<bf16*>(bf_smem);  // [64][kLd] this block's q
  bf16* do_s = q_s + kRows * kLd;                // [64][kLd] and its dO
  bf16* ring = do_s + kRows * kLd;               // 2 stages of k, v, mask
  float* dl_s = reinterpret_cast<float*>(ring + 2 * kStage);  // [64] delta
  const int bn = blockIdx.x, b = bn / N;
  const int qb = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = qb * kRows, r0 = q0 + warp * 16, off = Tk - Tq;
  const int ra = r0 + g, rb = ra + 8;
  const size_t q_at = static_cast<size_t>(bn) * Tq * D;
  const bf16* kbase = k + static_cast<size_t>(bn) * Tk * D;
  const bf16* vbase = v + static_cast<size_t>(bn) * Tk * D;
  const float* mrow = mask ? mask + static_cast<size_t>(b) * Tk : nullptr;
  const int nkt = kv_tiles(q0, kC, Tq, Tk, causal);

  auto load_stage = [&](int kt) {
    bf16* st = ring + (kt & 1) * kStage;
    copy_tile_bf<D, kC>(st, kbase, kt * kC, Tk);
    copy_tile_bf<D, kC>(st + kC * kLd, vbase, kt * kC, Tk);
    copy_mask(reinterpret_cast<float*>(st + 2 * kC * kLd), mrow, kt * kC, kC,
              Tk);
  };

  copy_tile_bf<D, kRows>(q_s, q + q_at, q0, Tq);
  copy_tile_bf<D, kRows>(do_s, dout + q_at, q0, Tq);
  load_stage(0);
  cp_commit();
  {
    // delta = rowsum(dO o) of this warp's 16 rows: 8-byte loads of 4
    // values, a row over kLpr lanes, then xor shuffles within them
    constexpr int kLpr = D / 4 < 32 ? D / 4 : 32, kRpp = 32 / kLpr;
#pragma unroll
    for (int pass = 0; pass < 16 / kRpp; ++pass) {
      const int r = pass * kRpp + lane / kLpr, row = r0 + r;
      float sum = 0.f;
      if (row < Tq) {
        const bf16* orow = o + q_at + static_cast<size_t>(row) * D;
        const bf16* drow = dout + q_at + static_cast<size_t>(row) * D;
        for (int c = lane % kLpr; c < D / 4; c += kLpr) {
          const uint2 ou = *reinterpret_cast<const uint2*>(orow + 4 * c);
          const uint2 du = *reinterpret_cast<const uint2*>(drow + 4 * c);
          const __nv_bfloat162* oh =
              reinterpret_cast<const __nv_bfloat162*>(&ou);
          const __nv_bfloat162* dh =
              reinterpret_cast<const __nv_bfloat162*>(&du);
          const float2 x0 = __bfloat1622float2(oh[0]);
          const float2 x1 = __bfloat1622float2(oh[1]);
          const float2 y0 = __bfloat1622float2(dh[0]);
          const float2 y1 = __bfloat1622float2(dh[1]);
          sum = fmaf(y0.x, x0.x, sum);
          sum = fmaf(y0.y, x0.y, sum);
          sum = fmaf(y1.x, x1.x, sum);
          sum = fmaf(y1.y, x1.y, sum);
        }
      }
#pragma unroll
      for (int s = kLpr / 2; s > 0; s >>= 1)
        sum += __shfl_xor_sync(kFull, sum, s);
      if (lane % kLpr == 0) {
        dl_s[warp * 16 + r] = sum;
        if (row < Tq) delta[static_cast<size_t>(bn) * Tq + row] = sum;
      }
    }
    __syncwarp();
  }
  const float dl_a = dl_s[warp * 16 + g], dl_b = dl_s[warp * 16 + g + 8];
  const size_t at = static_cast<size_t>(bn) * Tq;
  const size_t at_l = (static_cast<size_t>(BN) + bn) * Tq;
  const float m_a = ra < Tq ? stats[at + ra] : 0.f;
  const float m_b = rb < Tq ? stats[at + rb] : 0.f;
  const float ll_a = ra < Tq ? stats[at_l + ra] : 0.f;
  const float ll_b = rb < Tq ? stats[at_l + rb] : 0.f;
  float acc[kDt][4];
  zero(acc);
  for (int kt = 0; kt < nkt; ++kt) {
    if (kt + 1 < nkt) load_stage(kt + 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const bf16* ks = ring + (kt & 1) * kStage;
    const bf16* vs = ks + kC * kLd;
    const float* ms = reinterpret_cast<const float*>(vs + kC * kLd);
    const int k0 = kt * kC;
    if (r0 < Tq && !(causal && k0 > r0 + 15 + off)) {
      float s[kNt][4], dp[kNt][4];
      zero(s);
      zero(dp);
      score_bf<D, kNt, kBwdSteps / 2>(s, q_s, warp * 16, ks, lane);
      score_bf<D, kNt, kBwdSteps / 2>(dp, do_s, warp * 16, vs, lane);
#pragma unroll
      for (int j = 0; j < kNt; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * t + (e & 1), kj = k0 + col;
          const int row = e < 2 ? ra : rb;
          const bool live = kj < Tk && row < Tq && ms[col] > 0.f &&
                            !(causal && kj > row + off);
          s[j][e] = live ? expf((s[j][e] * scale - (e < 2 ? m_a : m_b)) -
                                (e < 2 ? ll_a : ll_b)) *
                               (dp[j][e] - (e < 2 ? dl_a : dl_b))
                         : 0.f;
        }
      accumulate_bf<D, kNt, true>(acc, s, ks, lane);
    }
    __syncthreads();
  }
  store_rows_bf<D>(dq + q_at, acc, scale, scale, r0, Tq, g, t);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_bf16_kernel(const bf16* __restrict__ q,
                           const bf16* __restrict__ k,
                           const bf16* __restrict__ v,
                           const float* __restrict__ mask,
                           const bf16* __restrict__ dout,
                           const float* __restrict__ stats,
                           const float* __restrict__ delta,
                           bf16* __restrict__ dk, bf16* __restrict__ dv,
                           int BN, int N, int Tq, int Tk, int causal,
                           float scale) {
  constexpr int kC = bf_q_cols(D), kLd = bf_ld(D), kNt = kC / 8;
  constexpr int kDt = D / 8;
  constexpr int kStage = bf_stage(D, kC, 3) / 2;  // bf16 elements
  extern __shared__ uint4 bf_smem[];
  bf16* k_s = reinterpret_cast<bf16*>(bf_smem);  // [64][kLd] this block's keys
  bf16* v_s = k_s + kRows * kLd;                 // [64][kLd]
  bf16* ring = v_s + kRows * kLd;  // 2 stages of q, dO, m, log l, delta
  int* red = reinterpret_cast<int*>(ring + 2 * kStage);
  const int bn = blockIdx.x, b = bn / N, kb = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = kb * kRows, kw0 = k0 + warp * 16, off = Tk - Tq;
  const int ka = kw0 + g, kbk = ka + 8;
  const size_t k_at = static_cast<size_t>(bn) * Tk * D;
  const size_t q_at = static_cast<size_t>(bn) * Tq * D;
  const float* mrow = mask ? mask + static_cast<size_t>(b) * Tk : nullptr;
  copy_tile_bf<D, kRows>(k_s, k + k_at, k0, Tk);
  copy_tile_bf<D, kRows>(v_s, v + k_at, k0, Tk);
  cp_commit();
  // the query tiles to visit: with causal, those holding a row that sees
  // one of this block's keys, and those holding a row that sees no key
  const int nq = (Tq + kC - 1) / kC;
  int nokey_rows = 0, nokey_qt = 0, first_qt = 0;
  if (causal) {
    const int fk = first_key(mrow, Tk, red);
    nokey_rows = fk - off < 0 ? 0 : (fk - off < Tq ? fk - off : Tq);
    nokey_qt = (nokey_rows + kC - 1) / kC;
    first_qt = (k0 - off > 0 ? k0 - off : 0) / kC;
  }
  const int from = nokey_qt > first_qt ? nokey_qt : first_qt;
  const int nvis = nokey_qt + (nq > from ? nq - from : 0);
  auto tile_of = [&](int i) { return i < nokey_qt ? i : from + i - nokey_qt; };
  auto load_stage = [&](int i) {
    const int qt0 = tile_of(i) * kC;
    bf16* st = ring + (i & 1) * kStage;
    copy_tile_bf<D, kC>(st, q + q_at, qt0, Tq);
    copy_tile_bf<D, kC>(st + kC * kLd, dout + q_at, qt0, Tq);
    float* vec = reinterpret_cast<float*>(st + 2 * kC * kLd);
    copy_vec(vec, stats + static_cast<size_t>(bn) * Tq, qt0, kC, Tq);
    copy_vec(vec + kC, stats + (static_cast<size_t>(BN) + bn) * Tq, qt0, kC,
             Tq);
    copy_vec(vec + 2 * kC, delta + static_cast<size_t>(bn) * Tq, qt0, kC, Tq);
  };
  const bool mk_a = ka < Tk && (mrow == nullptr || mrow[ka] > 0.f);
  const bool mk_b = kbk < Tk && (mrow == nullptr || mrow[kbk] > 0.f);
  float dk_acc[kDt][4], dv_acc[kDt][4];
  zero(dk_acc);
  zero(dv_acc);
  if (nvis > 0) load_stage(0);
  cp_commit();
  for (int i = 0; i < nvis; ++i) {
    if (i + 1 < nvis) load_stage(i + 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const bf16* qs = ring + (i & 1) * kStage;
    const bf16* dos = qs + kC * kLd;
    const float* m_s = reinterpret_cast<const float*>(dos + kC * kLd);
    const float* ll_s = m_s + kC;
    const float* dl_s = ll_s + kC;
    const int qt0 = tile_of(i) * kC;
    // warp-uniform: keys past Tk, or (causal) every pair of the tile
    // hidden and no row of it without a key
    if (kw0 < Tk &&
        !(causal && qt0 + kC - 1 + off < kw0 && qt0 >= nokey_rows)) {
      float s[kNt][4], dp[kNt][4];  // S^T, dP^T: [this warp's keys, queries]
      zero(s);
      zero(dp);
      score_bf<D, kNt, kBwdSteps / 2>(s, k_s, warp * 16, qs, lane);
      score_bf<D, kNt, kBwdSteps / 2>(dp, v_s, warp * 16, dos, lane);
#pragma unroll
      for (int j = 0; j < kNt; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * j + 2 * t + (e & 1), qi = qt0 + c;
          const int key = e < 2 ? ka : kbk;
          const bool valid = key < Tk && qi < Tq;
          const bool live =
              valid && (e < 2 ? mk_a : mk_b) && !(causal && key > qi + off);
          const float p =
              valid ? expf(((live ? s[j][e] * scale : kNeg) - m_s[c]) - ll_s[c])
                    : 0.f;
          dp[j][e] = live ? p * (dp[j][e] - dl_s[c]) : 0.f;
          s[j][e] = p;
        }
      accumulate_bf<D, kNt, true>(dv_acc, s, dos, lane);
      accumulate_bf<D, kNt, true>(dk_acc, dp, qs, lane);
    }
    __syncthreads();
  }
  cp_wait<0>();
  store_rows_bf<D>(dv + k_at, dv_acc, 1.f, 1.f, kw0, Tk, g, t);
  store_rows_bf<D>(dk + k_at, dk_acc, scale, scale, kw0, Tk, g, t);
}

// ------------------------------------------------------------- launch
// each (kernel, D, form) instance's shared-memory limit, raised once a
// device
unsigned long long g_ready[kMaxDevices];

template <typename Kernel>
cudaError_t ready(Kernel kernel, size_t bytes, int bit) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && (g_ready[dev] >> bit & 1ull)) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess && dev < kMaxDevices) g_ready[dev] |= 1ull << bit;
  return err;
}

constexpr int instance_bit(int D) {
  return D == 8 ? 0 : D == 16 ? 1 : D == 32 ? 2 : D == 64 ? 3 : 4;
}

__host__ __device__ constexpr int row_blocks(int t) {
  return (t + kRows - 1) / kRows;
}

template <int D>
int launch_fwd(const float* q, const float* k, const float* v,
               const float* mask, float* o, float* stats, int B, int N,
               int Tq, int Tk, int causal, float scale, cudaStream_t s) {
  if (row_blocks(Tq) > 65535) return cudaErrorInvalidValue;
  cudaError_t err =
      ready(flash_fwd_kernel<D>, fwd_smem(D), instance_bit(D));
  if (err != cudaSuccess) return err;
  flash_fwd_kernel<D><<<dim3(B * N, row_blocks(Tq)), kThreads, fwd_smem(D),
                        s>>>(q, k, v, mask, o, stats, B * N, N, Tq, Tk,
                             causal, scale);
  return cudaGetLastError();
}

template <int D>
int launch_bwd(const float* q, const float* k, const float* v,
               const float* mask, const float* o, const float* dout,
               const float* stats, float* delta, float* dq, float* dk,
               float* dv, int B, int N, int Tq, int Tk, int causal,
               float scale, cudaStream_t s) {
  if (row_blocks(Tq) > 65535 || row_blocks(Tk) > 65535)
    return cudaErrorInvalidValue;
  cudaError_t err =
      ready(flash_bwd_dq_kernel<D>, dq_smem(D), 5 + instance_bit(D));
  if (err != cudaSuccess) return err;
  err = ready(flash_bwd_dkdv_kernel<D>, dkdv_smem(D), 10 + instance_bit(D));
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<D>
      <<<dim3(B * N, row_blocks(Tq)), kThreads, dq_smem(D), s>>>(
          q, k, v, mask, o, dout, stats, delta, dq, B * N, N, Tq, Tk, causal,
          scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // same stream: delta is written before this kernel starts
  flash_bwd_dkdv_kernel<D>
      <<<dim3(B * N, row_blocks(Tk)), kThreads, dkdv_smem(D), s>>>(
          q, k, v, mask, dout, stats, delta, dk, dv, B * N, N, Tq, Tk,
          causal, scale);
  return cudaGetLastError();
}

// the bf16 instances (D 16, 32, 64, 128): bits 24 + 4 kernel + index
constexpr int bf_bit(int D, int which) {
  return 24 + 4 * which + (D == 16 ? 0 : D == 32 ? 1 : D == 64 ? 2 : 3);
}

template <int D>
int launch_fwd_bf16(const void* q, const void* k, const void* v,
                    const float* mask, void* o, float* stats, int B, int N,
                    int Tq, int Tk, int causal, float scale, cudaStream_t s) {
  if (row_blocks(Tq) > 65535) return cudaErrorInvalidValue;
  cudaError_t err =
      ready(flash_fwd_bf16_kernel<D>, bf_fwd_smem(D), bf_bit(D, 0));
  if (err != cudaSuccess) return err;
  flash_fwd_bf16_kernel<D><<<dim3(B * N, row_blocks(Tq)), kThreads,
                             bf_fwd_smem(D), s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), mask, static_cast<bf16*>(o), stats, B * N,
      N, Tq, Tk, causal, scale);
  return cudaGetLastError();
}

template <int D>
int launch_bwd_bf16(const void* q, const void* k, const void* v,
                    const float* mask, const void* o, const void* dout,
                    const float* stats, float* delta, void* dq, void* dk,
                    void* dv, int B, int N, int Tq, int Tk, int causal,
                    float scale, cudaStream_t s) {
  if (row_blocks(Tq) > 65535 || row_blocks(Tk) > 65535)
    return cudaErrorInvalidValue;
  cudaError_t err =
      ready(flash_bwd_dq_bf16_kernel<D>, bf_dq_smem(D), bf_bit(D, 1));
  if (err != cudaSuccess) return err;
  err = ready(flash_bwd_dkdv_bf16_kernel<D>, bf_dkdv_smem(D), bf_bit(D, 2));
  if (err != cudaSuccess) return err;
  const bf16* qs = static_cast<const bf16*>(q);
  const bf16* ks = static_cast<const bf16*>(k);
  const bf16* vs = static_cast<const bf16*>(v);
  const bf16* dos = static_cast<const bf16*>(dout);
  flash_bwd_dq_bf16_kernel<D>
      <<<dim3(B * N, row_blocks(Tq)), kThreads, bf_dq_smem(D), s>>>(
          qs, ks, vs, mask, static_cast<const bf16*>(o), dos, stats, delta,
          static_cast<bf16*>(dq), B * N, N, Tq, Tk, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // same stream: delta is written before this kernel starts
  flash_bwd_dkdv_bf16_kernel<D>
      <<<dim3(B * N, row_blocks(Tk)), kThreads, bf_dkdv_smem(D), s>>>(
          qs, ks, vs, mask, dos, stats, delta, static_cast<bf16*>(dk),
          static_cast<bf16*>(dv), B * N, N, Tq, Tk, causal, scale);
  return cudaGetLastError();
}

// one bf16 instance: fn<D> with the arguments; falls through for a D with
// no instance
#define FLASH_BF16(fn, ...)                   \
  switch (D) {                                \
    case 16: return fn<16>(__VA_ARGS__);      \
    case 32: return fn<32>(__VA_ARGS__);      \
    case 64: return fn<64>(__VA_ARGS__);      \
    case 128: return fn<128>(__VA_ARGS__);    \
    default: break;                           \
  }

// the wide path's instances (NC = 4, 8, 16 chunks): bits 15 + 3 (index
// of NC) + kernel; each raises its limit to its widest D's bytes
constexpr int wide_bit(int NC, int which) {
  return 15 + 3 * (NC == 4 ? 0 : NC == 8 ? 1 : 2) + which;
}

// the card's SMs (wide_parts)
inline int card_sms() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 1;
  return sms;
}

template <int NC>
int launch_wide_fwd(const float* q, const float* k, const float* v,
                    const float* mask, float* o, float* stats, int B, int N,
                    int Tq, int Tk, int D, int causal, float scale,
                    cudaStream_t s) {
  const int qblocks = (Tq + kWideRows - 1) / kWideRows;
  if (qblocks > 65535) return cudaErrorInvalidValue;
  cudaError_t err = ready(flash_wide_fwd_kernel<NC>,
                          wide_smem(0, NC * kWideChunk), wide_bit(NC, 0));
  if (err != cudaSuccess) return err;
  const int parts = wide_parts(static_cast<long long>(B) * N * qblocks, NC,
                               wide_chunks(D), card_sms());
  flash_wide_fwd_kernel<NC><<<dim3(B * N, qblocks, parts), kWideThreads,
                              wide_smem(0, D), s>>>(
      q, k, v, mask, o, stats, B * N, N, Tq, Tk, D, causal, scale);
  return cudaGetLastError();
}

template <int NC>
int launch_wide_bwd(const float* q, const float* k, const float* v,
                    const float* mask, const float* o, const float* dout,
                    const float* stats, float* delta, float* dq, float* dk,
                    float* dv, int B, int N, int Tq, int Tk, int D,
                    int causal, float scale, cudaStream_t s) {
  const int qblocks = (Tq + kWideRows - 1) / kWideRows;
  const int kblocks = (Tk + kWideRows - 1) / kWideRows;
  if (qblocks > 65535 || kblocks > 65535) return cudaErrorInvalidValue;
  cudaError_t err = ready(flash_wide_dq_kernel<NC>,
                          wide_smem(1, NC * kWideChunk), wide_bit(NC, 1));
  if (err != cudaSuccess) return err;
  err = ready(flash_wide_dkdv_kernel<NC>, wide_smem(2, NC * kWideChunk),
              wide_bit(NC, 2));
  if (err != cudaSuccess) return err;
  const int sms = card_sms(), nc = wide_chunks(D);
  const long long bn = static_cast<long long>(B) * N;
  flash_wide_dq_kernel<NC><<<dim3(B * N, qblocks,
                                  wide_parts(bn * qblocks, NC, nc, sms)),
                             kWideThreads, wide_smem(1, D), s>>>(
      q, k, v, mask, o, dout, stats, delta, dq, B * N, N, Tq, Tk, D, causal,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // same stream: delta is written before this kernel starts
  flash_wide_dkdv_kernel<NC><<<dim3(B * N, kblocks,
                                    wide_parts(bn * kblocks, NC, nc, sms)),
                               kWideThreads, wide_smem(2, D), s>>>(
      q, k, v, mask, dout, stats, delta, dk, dv, B * N, N, Tq, Tk, D, causal,
      scale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o (and dO, dq, dk, dv) are float, or bf16 where bf16 != 0
// (D in 16, 32, 64, 128: the bf16 instances); the mask, stats and delta
// are float.
extern "C" int flash_fwd(const float* q, const float* k, const float* v,
                         const float* mask, float* o, float* stats, int B,
                         int N, int Tq, int Tk, int D, int causal, int bf16,
                         float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    FLASH_BF16(launch_fwd_bf16, q, k, v, mask, o, stats, B, N, Tq, Tk,
               causal, scale, s)
    return cudaErrorInvalidValue;
  }
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
      break;
  }
  if (D <= 128) return cudaErrorInvalidValue;
  if (D > kWideMaxD) {
    if (static_cast<long long>(B) * N * Tq > INT_MAX)
      return cudaErrorInvalidValue;
    flash_split_fwd_kernel<<<B * N * Tq, kSplitThreads, 0, s>>>(
        q, k, v, mask, o, stats, B * N, N, Tq, Tk, D, causal, scale);
    return cudaGetLastError();
  }
  switch (wide_instance(D)) {
    case 4:
      return launch_wide_fwd<4>(q, k, v, mask, o, stats, B, N, Tq, Tk, D,
                                causal, scale, s);
    case 8:
      return launch_wide_fwd<8>(q, k, v, mask, o, stats, B, N, Tq, Tk, D,
                                causal, scale, s);
    default:
      return launch_wide_fwd<16>(q, k, v, mask, o, stats, B, N, Tq, Tk, D,
                                 causal, scale, s);
  }
}

extern "C" int flash_bwd(const float* q, const float* k, const float* v,
                         const float* mask, const float* o,
                         const float* dout, const float* stats, float* delta,
                         float* dq, float* dk, float* dv, int B, int N,
                         int Tq, int Tk, int D, int causal, int bf16,
                         float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    FLASH_BF16(launch_bwd_bf16, q, k, v, mask, o, dout, stats, delta, dq, dk,
               dv, B, N, Tq, Tk, causal, scale, s)
    return cudaErrorInvalidValue;
  }
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
      break;
  }
  if (D <= 128) return cudaErrorInvalidValue;
  if (D > kWideMaxD) {
    if (static_cast<long long>(B) * N * (Tq > Tk ? Tq : Tk) > INT_MAX)
      return cudaErrorInvalidValue;
    flash_split_dq_kernel<<<B * N * Tq, kSplitThreads, 0, s>>>(
        q, k, v, mask, o, dout, stats, delta, dq, B * N, N, Tq, Tk, D,
        causal, scale);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    // same stream: delta is written before this kernel starts
    flash_split_dkdv_kernel<<<B * N * Tk, kSplitThreads, 0, s>>>(
        q, k, v, mask, dout, stats, delta, dk, dv, B * N, N, Tq, Tk, D,
        causal, scale);
    return cudaGetLastError();
  }
  switch (wide_instance(D)) {
    case 4:
      return launch_wide_bwd<4>(q, k, v, mask, o, dout, stats, delta, dq, dk,
                                dv, B, N, Tq, Tk, D, causal, scale, s);
    case 8:
      return launch_wide_bwd<8>(q, k, v, mask, o, dout, stats, delta, dq, dk,
                                dv, B, N, Tq, Tk, D, causal, scale, s);
    default:
      return launch_wide_bwd<16>(q, k, v, mask, o, dout, stats, delta, dq,
                                 dk, dv, B, N, Tq, Tk, D, causal, scale, s);
  }
}

// The dynamic shared memory, bytes, that kernel `which` (0 forward, 1 dq,
// 2 dkdv) requests at head width D: an instance's, the wide path's
// (128 < D <= kWideMaxD) or the split-row path's (0: its shared memory is
// static); -1 for another D.
extern "C" long long flash_smem(int which, int D) {
  if (D > kWideMaxD && which >= 0 && which <= 2) return 0;
  if (D > 128 && D <= kWideMaxD && which >= 0 && which <= 2)
    return static_cast<long long>(wide_smem(which, D));
  if (D != 8 && D != 16 && D != 32 && D != 64 && D != 128) return -1;
  switch (which) {
    case 0:
      return static_cast<long long>(fwd_smem(D));
    case 1:
      return static_cast<long long>(dq_smem(D));
    case 2:
      return static_cast<long long>(dkdv_smem(D));
    default:
      return -1;
  }
}

// The bf16 form's dynamic shared memory, bytes, that kernel `which` (0
// forward, 1 dq, 2 dkdv) requests at head width D (16, 32, 64, 128); -1
// for another D.
extern "C" long long flash_bf16_smem(int which, int D) {
  if (D != 16 && D != 32 && D != 64 && D != 128) return -1;
  switch (which) {
    case 0:
      return static_cast<long long>(bf_fwd_smem(D));
    case 1:
      return static_cast<long long>(bf_dq_smem(D));
    case 2:
      return static_cast<long long>(bf_dkdv_smem(D));
    default:
      return -1;
  }
}

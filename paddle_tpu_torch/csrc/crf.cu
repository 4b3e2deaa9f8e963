// Linear-chain CRF for Hopper (sm_90a), f32 (and, up to 32 classes,
// bf16): the partition function's forward recursion, its analytic
// backward, and the Viterbi decode.
//
// Replaces
// - crf_alpha_fwd: the TPU kernel paddle_tpu/ops/crf.py:_crf_kernel (its
//   pallas_call in _crf_alphas_pallas) with the log Z epilogue of _crf_fwd,
//   any C (the TPU pads C to 128 lanes and takes any C);
// - crf_bwd: the backward paddle_tpu/ops/crf.py:_crf_bwd, a lax.scan over
//   the saved alphas in JAX (beta recursion, unary and pairwise
//   marginals);
// - crf_viterbi: the decode paddle_tpu/layers/chain.py:crf_decode, a
//   lax.scan in JAX, the tagger's serving path.
//
// Shapes: x [B, T, C] emission scores, mask [B, T] (1 = real step), trans
// [C, C] (trans[prev, next]), a, b [C] the start and end potentials. Per
// sequence, with tm = max(trans) and E = exp(trans - tm):
//
//   alpha_0 = a + x_0
//   alpha_t = log(max(exp(alpha_{t-1} - m) @ E, 1e-37)) + m + tm + x_t
//             where mask_t > 0 (m = max alpha_{t-1}), else alpha_{t-1}
//   log Z   = logsumexp(alpha_{T-1} + b)
//   beta_{T-1} = b
//   beta_{t-1}[i] = log(max(sum_j exp(y_j - m) E[i, j], 1e-37)) + m + tm
//             where mask_t > 0 (y = x_t + beta_t, m = max y), else beta_t
//
// with the additions in crf_log_z_ref's and crf_bwd_plain's order. The TPU
// pads C to 128 lanes with -inf scores, exact zeros of the exp-space
// product; here the class axis is not padded and the numbers are the same.
//
// The backward: two launches either way; the beta recursion, T - 1
// dependent steps, is the only chain, and nothing waits on it but itself.
// - C <= 32 (crf_bwd_fused_kernel, then crf_sum_kernel): a block a
//   sequence. Its warp 0 runs the chain: lane i owns class and row i, the
//   class count a template (kC: C rounded up to 8; the padded terms add
//   +0), the lane's row of E = exp(trans - tm) in registers, exp(y - m)
//   shared through a 16-byte aligned row read as float4, the max one
//   redux.sync on an order-keeping integer key. Each beta_t goes into a
//   ring in shared memory; six worker warps (one a scheduler apart from
//   the chain's) take the pairs (t, t+1) as their betas arrive, each
//   thread summing the pairwise marginals of its dtrans entries in
//   registers, and write dx. Progress counters in shared memory order the
//   two sides; the chain waits only before it overwrites a ring row the
//   workers have not read. crf_sum_kernel adds the sequences' partials
//   and end terms over b in order.
// - C > 32 (crf_beta_block_kernel, then crf_marginal_kernel): a block a
//   sequence runs the chain with K lanes a row (block_parts: 2 up to C =
//   512; 4 where E comes from L2, up to C = 256) summing alternate terms
//   and combining in a fixed butterfly, two barriers a step (the max, then
//   the shared exp(y - m)), the next step's emissions copied ahead with
//   cp.async; E in shared memory at a row stride = K mod 32 (the lanes of
//   a warp hit 32 banks) where it fits, C <= 226, else each block writes
//   its own transposed copy to global memory (through 32 x 33 tiles) and
//   reads it from L2, coalesced, 16 loads in flight. It stores the betas
//   and the end terms. The marginal pass has no chain: blocks over (tile
//   of 32-wide dtrans entries, chunk of the (b, t) pairs) fill the card,
//   list their pairs in shared memory and read alpha, x and beta straight
//   from global memory, eight pairs' loads in flight, into a partial a
//   chunk; the last block of a tile (an integer counter: no float
//   atomics) adds the partials in chunk order.
// Both sum the pairwise marginals exp(min(alpha_t[i] + trans[i, j] +
// x_{t+1}[j] + beta_{t+1}[j] - log Z, 30)) * mask_{t+1} mask_t g
// exponentiated as a sum, never factorised (forbidden transitions at -1e4
// cannot overflow), in a fixed order: two runs give the same bits, and
// nothing is left for a torch reduction. The dots add their terms in
// order (the block variant: each lane's in order, then the butterfly);
// expf and logf are the accurate ones (no --use_fast_math). Masks are read
// as ballot bits a chunk of 32 steps ahead and a warp's emissions kAhead
// steps ahead: a compare right after a global load stalled every step on
// its latency.

// The Viterbi: one launch. Scores add in crf_decode's order (alpha_i +
// trans_ij, max over i, then + x_j). The max over i runs as four
// interleaved partial (value, first index) maxima (and, in the block
// variant, over K = 2 lanes), combined with the lower index winning a tie:
// the serial loop's value and first index exactly (a max does not round),
// so the paths equal crf_viterbi_plain's and jnp.argmax's. C <= 32: a warp
// a sequence, the lane's column of trans in registers; above, a block a
// sequence, trans in shared memory at a stride = 32 / K mod 32 where it
// fits (C <= 237), else read from L2. Back-pointers (identity on padded
// steps) are kept in shared memory, one byte each for C <= 256, two up to
// 65,536, four above, and the backtrack reads them there; where trans, the
// vectors and T x C back-pointers outgrow a block's shared memory they
// spill to a global scratch, trans kept resident first.
//
// One plan (beta_plan, viterbi_plan, marg_plan below; ops/crf.py:crf_plan,
// held equal by a card test) gives each kernel's variant, parts, strides
// and shared memory. Above C ~ 12,400 (the backward) or ~ 14,500 (the
// Viterbi) even the per-class vectors outgrow shared memory and move to
// global scratch too: any C >= 1 runs.
//
// Bound on the H100 (SXM, 700 W). A chain of T - 1 dependent steps cannot
// approach its bytes bound (the tagger's B = 64, T = 80, C = 23 backward
// moves ~1.4 MB, 0.4 us). crf_chain_floor_*_kernel runs the chains' own
// step functions with no global memory (one warp at C <= 32); its time a
// step times the most live steps of any row is the chain bound
// chip_smoke.py ranks the kernels against (PERF.md).
//
// The forward: one launch, any C. Its alpha step is the beta step on the
// transposed matrix (s_j = sum_i p_i E[i, j] with p = exp(alpha - m), and
// x_t added after the log), so both chains run one step function each
// (warp_chain_step, block_chain_step; kAlpha picks the side) and the floor
// times the very code the kernels run. C <= 32 (crf_alpha_warp_kernel): a
// warp a sequence, four a block; the block computes E once into shared
// memory, lane j keeps column j in registers (C rounded up to 8, the
// padded terms +0), exp(alpha - m) is shared through a 16-byte aligned
// row read as float4, the max is one redux.sync, masks are ballot bits 32
// steps ahead, emissions kAhead steps ahead, and the alpha rows are
// stored each step with nothing waiting on them. Above
// (crf_alpha_block_kernel): a block a sequence, K lanes a column summing
// alternate terms in order and combining in a fixed butterfly, two
// barriers a step, an owner's x_t read from global memory under the dot;
// E in shared memory at a column stride = 32 / K mod 32 (the K parts of 32
// / K columns in 32 banks) while it fits beside alpha and p (K = 4 up to
// C = 232, 2 up to 240), else each block writes its own copy of E in its
// natural layout to scratch and reads its columns from L2 (a warp's slots
// read neighbouring columns: coalesced), 4 lanes a column up to C = 256,
// 16 loads in flight. in_global forces that copy at the shared path's K:
// the same partition of every sum, the same bits. Above C ~ 29,000 the
// vectors (alpha, p) move to scratch too.
//
// The bf16 form (the entries' bf16 flag; C <= 32, the warp kernels, the
// storage type S a template: crf_alpha_warp_kernel, crf_bwd_fused_kernel
// with crf_sum_kernel, crf_decode_warp_kernel). The reference's Pallas
// kernel is dtype-generic: at bf16 its alphas live in bf16, exp(alpha -
// m) is computed in bf16, the product with E = exp(trans - tm) (bf16 too)
// is summed in f32 and rounded, and log(max(s, 1e-37)) + m + tm + x_t
// rounds at each operation; its backward and the Viterbi are scans whose
// every operation rounds. Here every operand is read from bf16 and
// widened, each operation computes in f32 and rounds to bf16 where the
// reference rounds (rnd<S>; the identity for float, so the f32 form's
// instructions are unchanged), the products of two bf16 values are exact
// in f32, and the outputs are stored in bf16. Two departures, both sums:
// the dot's order (in class order, where the reference's matmul has its
// own), and the marginal sums (dtrans, da, db) added in f32 and rounded
// once where JAX adds each step's sum into a bf16 accumulator. The block
// variants (C > 32) have no bf16 form.
//
// The earlier forward (crf_alpha_fwd_kernel: a warp a sequence, 8 classes
// a lane at most, so C <= kEarlierClasses (256); its [C, C] matrix in
// shared memory up to C = 239 and from global memory above, written by
// crf_prep_kernel, launched just before), the earlier backward
// (crf_bwd_kernel: the pairwise marginals inside the chain, per-sequence
// partials summed by the caller) and Viterbi (crf_viterbi_kernel:
// back-pointers in a global scratch) stay built under the entries
// crf_alpha_fwd_lanes, crf_bwd_inline and crf_viterbi_scratch, which no
// path calls, so that chip_smoke.py times them beside the new ones in one
// run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

// the storage type S: float, or __nv_bfloat16 (the bf16 form)
template <typename S>
constexpr bool kIsBf16 = std::is_same<S, __nv_bfloat16>::value;

template <typename S>
__device__ __forceinline__ float ld(const S* p) {
  if constexpr (kIsBf16<S>)
    return __bfloat162float(*p);
  else
    return *p;
}

template <typename S>
__device__ __forceinline__ void st(S* p, float v) {
  if constexpr (kIsBf16<S>)
    *p = __float2bfloat16_rn(v);
  else
    *p = v;
}

// x rounded to S and widened back: a bf16 operation's result
template <typename S>
__device__ __forceinline__ float rnd(float x) {
  if constexpr (kIsBf16<S>)
    return __bfloat162float(__float2bfloat16_rn(x));
  else
    return x;
}

// the exp-space sum's floor, 1e-37 in S (jnp.maximum(s, 1e-37))
template <typename S>
__device__ __forceinline__ float tiny() {
  return rnd<S>(1e-37f);
}

constexpr int kWarps = 4;                 // sequences per warp-variant block
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxPerLane = 8;            // the earlier kernels' classes a lane
constexpr int kEarlierClasses = 32 * kMaxPerLane;
constexpr size_t kMaxSmem = 232448;       // a block's 227 KB
constexpr int kPrepThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kBlockThreads = 1024;       // the block variants' most
constexpr int kTileWarps = 8;             // warps transposing exp(trans - tm)
constexpr size_t kTileBytes = sizeof(float) * kTileWarps * 32 * 33;
constexpr int kMargThreads = 256;         // marginal pass: a tile's entries
constexpr int kStagePairs = kMargThreads; // pairs a marginal block lists
constexpr int kTargetBlocks = 264;        // two marginal blocks an SM
constexpr int kMinPairs = 32;             // pairs a chunk at least
constexpr int kAhead = 4;                 // steps a warp loads x ahead
constexpr int kSetupLoads = 16;           // the forward's setup loads a pass
constexpr int kFusedWarps = 8;            // the one-launch backward's block
constexpr int kIdleWarp = 4;              // the chain's scheduler mate
constexpr int kWorkers = 32 * (kFusedWarps - 2);  // its marginal threads
constexpr int kRing = 32;                 // betas in flight to the workers
constexpr unsigned kPollNs = 200;         // a worker's wait between polls

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

// (v, i) becomes (ov, oi) where that is larger, or equal with a lower
// index: combining first-index maxima gives the first index overall.
__device__ __forceinline__ void take_better(float& v, int& i, float ov,
                                            int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(kFull, v, o);
    const int oi = __shfl_xor_sync(kFull, i, o);
    take_better(v, i, ov, oi);
  }
}

// The warp's max of v in one redux.sync: floats map to ints of the same
// order (negative ones with their magnitude bits flipped), so the integer
// max is the float max exactly (no NaN enters).
__device__ __forceinline__ float warp_max_key(float v) {
  int k = __float_as_int(v);
  k = __reduce_max_sync(kFull, k >= 0 ? k : k ^ 0x7fffffff);
  return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff);
}

// The block's max of v (a barrier inside); red: [32] in shared memory.
__device__ __forceinline__ float block_max(float v, float* red) {
  v = warp_max_key(v);
  const int lane = threadIdx.x & 31;
  if (lane == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  return warp_max_key(lane < static_cast<int>(blockDim.x >> 5) ? red[lane]
                                                               : -INFINITY);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// commits this step's copies and waits for every earlier group
__device__ __forceinline__ void cp_async_commit_wait_prev() {
  cp_async_commit();
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// The live bits of 32 steps t0, t0 + dir, ..., t0 + 31 dir: bit k is
// mask[t0 + dir k] > 0 (0 outside [lo, hi]); m is the lane's mask value,
// loaded a chunk ahead by mask_of, so that no step waits on a mask's load
// (a compare right after a global load stalls the chain on its latency).
template <typename S>
__device__ __forceinline__ float mask_of(const S* __restrict__ mb, int t0,
                                         int dir, int lo, int hi) {
  const int t = t0 + dir * static_cast<int>(threadIdx.x & 31);
  return t >= lo && t <= hi ? ld(mb + t) : 0.f;
}

__device__ __forceinline__ unsigned live_bits(float m) {
  return __ballot_sync(kFull, m > 0.f);
}

// ---------------------------------------------------------- step functions
// Shared by the kernels and crf_chain_floor_kernel, so that the floor
// times the kernels' own steps.

// A live chain step in a warp, kC >= C classes (a multiple of 8). The
// beta step (kAlpha false): lane i (own: i < C) returns beta_{t-1}[i] from
// v = beta_t[i] and x_t = x_t[i], mat = E[i, 0 .. kC) its row. The alpha
// step (kAlpha): lane j returns alpha_t[j] from v = alpha_{t-1}[j] and x_t
// = x_t[j], mat = E[0 .. kC), j] its column; x_t is added after the log.
// mat sits in registers (0 past C; the floor gives every lane one row); p
// is the warp's [32] row in shared memory, 16-byte aligned, 0 past C,
// read as float4. The dot adds the terms 0 .. kC-1 in order: the padded
// terms add +0. S: the rounding of each operation (the bf16 form's).
template <int kC, bool kAlpha, typename S = float>
__device__ __forceinline__ float warp_chain_step(float v, float x_t,
                                                 bool own, int lane, float* p,
                                                 const float (&mat)[kC],
                                                 float tm) {
  const float y = own ? (kAlpha ? v : rnd<S>(x_t + v)) : -INFINITY;
  const float m = warp_max_key(y);
  if (own) p[lane] = rnd<S>(expf(rnd<S>(y - m)));
  __syncwarp();
  float s = 0.f;
  const float4* p4 = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int q = 0; q < kC / 4; ++q) {
    const float4 f = p4[q];
    s += f.x * mat[4 * q];
    s += f.y * mat[4 * q + 1];
    s += f.z * mat[4 * q + 2];
    s += f.w * mat[4 * q + 3];
  }
  __syncwarp();  // p is rewritten next step
  if (!own) return v;
  const float r =
      rnd<S>(rnd<S>(rnd<S>(logf(fmaxf(rnd<S>(s), tiny<S>()))) + m) + tm);
  return kAlpha ? rnd<S>(r + x_t) : r;
}

// The block variants split each row's (or column's) sum or max over K
// adjacent lanes (block_parts: K = 2 up to C = 512, else 1): thread tid
// is part tid % K of slot tid / K, which owns rows (or
// columns) slot, slot + slots, ... (slots = blockDim.x / K); part k takes
// the terms j = k, k + K, ... in order, and the K partials combine in a
// fixed butterfly (the same bits in every lane). Owners are part 0.

// A live chain step in a block (two barriers): v [C] the owners' (beta_t
// or alpha_{t-1}, replaced in place), p [C] shared, xt [C] the step's
// emissions (owners read their own; the alpha step's first column is
// loaded before the barriers, so that a global x_t arrives under them);
// owner o sums the terms e[o * so + j * ss], j = 0 .. C-1: the beta step's
// row i of E (so, ss = E's row and column strides), the alpha step's
// column j (the other way round), 16 terms' loads issued before their sums
// (E may come from L2; left to the compiler's unrolling, the schedule of
// these loads moved with unrelated edits and the L2 path ran half again
// slower on the H100); red [32] shared.
template <bool kAlpha>
__device__ __forceinline__ void block_chain_step(float* v, float* p,
                                                 const float* xt,
                                                 const float* e, size_t so,
                                                 size_t ss, int C, float tm,
                                                 float* red, int K) {
  const int slots = blockDim.x / K, slot = threadIdx.x / K;
  const int part = threadIdx.x - slot * K;
  const float x0 = kAlpha && part == 0 && slot < C ? xt[slot] : 0.f;
  float lm = -INFINITY;
  if (part == 0)
    for (int o = slot; o < C; o += slots)
      lm = fmaxf(lm, kAlpha ? v[o] : xt[o] + v[o]);
  const float m = block_max(lm, red);
  if (part == 0)
    for (int o = slot; o < C; o += slots)
      p[o] = expf((kAlpha ? v[o] : xt[o] + v[o]) - m);
  __syncthreads();
  for (int base = 0; base < C; base += slots) {  // block-uniform trips
    const int o = base + slot;
    float s = 0.f;
    if (o < C) {
      const float* eo = e + o * so + part * ss;
      const size_t step = K * ss;
      int j = part;
      for (; j + 15 * K < C; j += 16 * K, eo += 16 * step) {
        float ev[16], pv[16];
#pragma unroll
        for (int u = 0; u < 16; ++u) {
          ev[u] = eo[u * step];
          pv[u] = p[j + u * K];
        }
#pragma unroll
        for (int u = 0; u < 16; ++u) s += pv[u] * ev[u];  // in order
      }
      for (; j < C; j += K, eo += step) s += p[j] * *eo;
    }
    for (int q = 1; q < K; q <<= 1) s += __shfl_xor_sync(kFull, s, q);
    if (o < C && part == 0) {
      const float r = logf(fmaxf(s, 1e-37f)) + m + tm;
      v[o] = kAlpha ? r + (base == 0 ? x0 : xt[o]) : r;
    }
  }
}

// max_i (v[i * sv] + col[i * si]) and its first index (arg): four interleaved
// partial maxima (i = 4 q + k, each in increasing i), combined with the
// lower index winning a tie. All -inf gives index 0. Sixteen terms are
// loaded before they are compared, so that a column read from L2 keeps
// sixteen loads in flight.
__device__ __forceinline__ float max_plus(const float* v, size_t sv,
                                          const float* col, size_t si, int C,
                                          int& arg) {
  float b0 = -INFINITY, b1 = -INFINITY, b2 = -INFINITY, b3 = -INFINITY;
  int i0 = 0, i1 = 1, i2 = 2, i3 = 3;
  int i = 0;
  for (; i + 16 <= C; i += 16) {  // 16 loads in flight, then the compares
    float s[16];
#pragma unroll
    for (int u = 0; u < 16; ++u) s[u] = v[(i + u) * sv] + col[(i + u) * si];
#pragma unroll
    for (int u = 0; u < 16; u += 4) {
      if (s[u] > b0) { b0 = s[u]; i0 = i + u; }
      if (s[u + 1] > b1) { b1 = s[u + 1]; i1 = i + u + 1; }
      if (s[u + 2] > b2) { b2 = s[u + 2]; i2 = i + u + 2; }
      if (s[u + 3] > b3) { b3 = s[u + 3]; i3 = i + u + 3; }
    }
  }
  for (; i + 4 <= C; i += 4) {
    const float s0 = v[i * sv] + col[i * si];
    const float s1 = v[(i + 1) * sv] + col[(i + 1) * si];
    const float s2 = v[(i + 2) * sv] + col[(i + 2) * si];
    const float s3 = v[(i + 3) * sv] + col[(i + 3) * si];
    if (s0 > b0) { b0 = s0; i0 = i; }
    if (s1 > b1) { b1 = s1; i1 = i + 1; }
    if (s2 > b2) { b2 = s2; i2 = i + 2; }
    if (s3 > b3) { b3 = s3; i3 = i + 3; }
  }
  if (i < C) {
    const float s = v[i * sv] + col[i * si];
    if (s > b0) { b0 = s; i0 = i; }
  }
  if (i + 1 < C) {
    const float s = v[(i + 1) * sv] + col[(i + 1) * si];
    if (s > b1) { b1 = s; i1 = i + 1; }
  }
  if (i + 2 < C) {
    const float s = v[(i + 2) * sv] + col[(i + 2) * si];
    if (s > b2) { b2 = s; i2 = i + 2; }
  }
  take_better(b0, i0, b1, i1);
  take_better(b2, i2, b3, i3);
  take_better(b0, i0, b2, i2);
  arg = i0;
  return b0;
}

// A live Viterbi step in a warp, kC >= C classes: lane j (own: j < C)
// returns alpha_t[j] from alpha = alpha_{t-1}[j] and its first index in
// arg; v the warp's [32] row of this step in shared memory (-inf past C,
// 16-byte aligned; two rows alternate, so one __syncwarp a step
// suffices), col = trans[0 ..
// kC), j] in registers (the floor gives every row r_j). Four interleaved
// partial maxima, as max_plus (eight measured slower on the H100). S: the
// rounding of each addition (the bf16 form's).
template <int kC, typename S = float>
__device__ __forceinline__ float warp_viterbi_step(float alpha, float x_t,
                                                   bool own, int lane,
                                                   float* v,
                                                   const float (&col)[kC],
                                                   int& arg) {
  if (own) v[lane] = alpha;
  __syncwarp();
  float vv[kC];  // every term's load issued before the compares
  const float4* v4 = reinterpret_cast<const float4*>(v);
#pragma unroll
  for (int q = 0; q < kC / 4; ++q) {
    const float4 f = v4[q];
    vv[4 * q] = f.x;
    vv[4 * q + 1] = f.y;
    vv[4 * q + 2] = f.z;
    vv[4 * q + 3] = f.w;
  }
  float best[4];
  int idx[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    best[k] = -INFINITY;
    idx[k] = k;
  }
#pragma unroll
  for (int i = 0; i < kC; ++i) {
    const float s = rnd<S>(vv[i] + col[i]);
    if (s > best[i & 3]) {
      best[i & 3] = s;
      idx[i & 3] = i;
    }
  }
  take_better(best[0], idx[0], best[1], idx[1]);
  take_better(best[2], idx[2], best[3], idx[3]);
  take_better(best[0], idx[0], best[2], idx[2]);
  arg = idx[0];
  return own ? rnd<S>(best[0] + x_t) : alpha;
}

// A live Viterbi step in a block (one barrier): column j of vn = the
// max-plus of v and trans (rows si apart) + xt, its first index into
// bpt[j]; part k of the column's slot takes i = k, k + K, ..., and the
// parts' (value, first index) combine with the lower index winning a tie.
template <typename IdxT>
__device__ __forceinline__ void block_viterbi_step(const float* v, float* vn,
                                                   const float* xt,
                                                   const float* tr,
                                                   size_t si, int C,
                                                   IdxT* bpt, int K) {
  const int slots = blockDim.x / K, slot = threadIdx.x / K;
  const int part = threadIdx.x - slot * K;
  for (int base = 0; base < C; base += slots) {  // block-uniform trips
    const int j = base + slot;
    float best = -INFINITY;
    int arg = part;
    if (j < C) {
      int q = 0;
      best = max_plus(v + part, K, tr + part * si + j, K * si,
                      (C - part + K - 1) / K, q);
      arg = part + K * q;
    }
    for (int o = 1; o < K; o <<= 1) {
      const float ob = __shfl_xor_sync(kFull, best, o);
      const int oi = __shfl_xor_sync(kFull, arg, o);
      take_better(best, arg, ob, oi);
    }
    if (j < C && part == 0) {
      vn[j] = best + xt[j];
      bpt[j] = static_cast<IdxT>(arg);
    }
  }
  __syncthreads();
}

// ------------------------------------------------- the earlier kernels
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

// ------------------------------------------------------ the alpha chains
// C <= kC <= 32: a warp a sequence, kWarps a block. The block computes tm
// and E = exp(trans - tm) [C, C] once, into shared memory (or, ework
// given, into its own copy at ework + blockIdx.x C^2: the same bits from
// global memory); lane j keeps column j in registers. Shared memory: the
// warps' [32] rows of exp(alpha - m), red [32], then E.
template <int kC, typename S>
__global__ void __launch_bounds__(kThreads)
crf_alpha_warp_kernel(const S* __restrict__ x,      // [B, T, C]
                      const S* __restrict__ mask,   // [B, T]
                      const S* __restrict__ trans,  // [C, C]
                      const S* __restrict__ a,      // [C]
                      const S* __restrict__ bend,   // [C]
                      float* ework,                 // or null
                      S* __restrict__ alphas,       // [B, T, C]
                      S* __restrict__ log_z,        // [B]
                      int B, int T, int C) {
  extern __shared__ float smem[];
  float* p_s = smem;             // [kWarps][32], 16-byte aligned
  float* red = p_s + kThreads;   // [32]
  float* e = ework != nullptr
                 ? ework + static_cast<size_t>(blockIdx.x) * C * C
                 : red + 32;     // [C, C]
  float mx = -INFINITY;
  for (int k = threadIdx.x; k < C * C; k += kThreads)
    mx = fmaxf(mx, ld(trans + k));
  const float tm = block_max(mx, red);
  for (int k = threadIdx.x; k < C * C; k += kThreads)
    e[k] = rnd<S>(expf(rnd<S>(ld(trans + k) - tm)));
  p_s[threadIdx.x] = 0.f;  // the padded classes' exp(alpha - m) stay 0
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= B) return;  // no barrier follows
  const bool own = lane < C;
  float col[kC];
#pragma unroll
  for (int i = 0; i < kC; ++i) col[i] = own && i < C ? e[i * C + lane] : 0.f;
  float* p = p_s + warp * 32;
  const size_t tc = static_cast<size_t>(T) * C;
  const S* xb = x + b * tc;
  const S* mb = mask + static_cast<size_t>(b) * T;
  S* ab = alphas + b * tc;
  float alpha = own ? rnd<S>(ld(a + lane) + ld(xb + lane)) : 0.f;
  if (own) st(ab + lane, alpha);
  // emissions kAhead steps ahead, masks a chunk of 32 steps ahead
  float xq[kAhead];
#pragma unroll
  for (int d = 0; d < kAhead; ++d)
    xq[d] = own && 1 + d < T ? ld(xb + static_cast<size_t>(1 + d) * C + lane)
                             : 0.f;
  float m_n = mask_of(mb, 1, 1, 1, T - 1);
  unsigned live = 0;
  for (int t = 1; t < T; ++t) {
    const int k = (t - 1) & 31;
    if (k == 0) {
      live = live_bits(m_n);
      m_n = mask_of(mb, t + 32, 1, 1, T - 1);
    }
    const float x_t = xq[0];
#pragma unroll
    for (int d = 0; d + 1 < kAhead; ++d) xq[d] = xq[d + 1];
    const int tn = t + kAhead;
    xq[kAhead - 1] =
        own && tn < T ? ld(xb + static_cast<size_t>(tn) * C + lane) : 0.f;
    if ((live >> k) & 1u)  // warp-uniform
      alpha = warp_chain_step<kC, true, S>(alpha, x_t, own, lane, p, col, tm);
    if (own) st(ab + static_cast<size_t>(t) * C + lane, alpha);  // not waited on
  }
  // log Z = m + log(sum_j exp(alpha_j + b_j - m))
  const float v = own ? rnd<S>(alpha + ld(bend + lane)) : -INFINITY;
  const float m = warp_max_key(v);
  const float s = warp_sum(own ? rnd<S>(expf(rnd<S>(v - m))) : 0.f);
  if (lane == 0) st(log_z + b, rnd<S>(m + rnd<S>(logf(rnd<S>(s)))));
}

// C > 32: a block a sequence (K parts a column, block_threads(C, K)).
// Shared memory: red [32], then (unless the vectors are global: vwork
// non-null) alpha [C] and p [C], then E [C, ld] (ld > 0: ld = t_stride(C,
// K), so that the K parts of 32 / K columns hit 32 banks). With ld = 0,
// the block writes its own copy of E [C, C] at ework + b C^2 and reads its
// columns from L2. An owner reads its x_t straight from global memory,
// issued before the step's barriers and needed only after its dot (a
// cp.async ring for x, as the beta chain keeps, ran slower on the H100 at
// every C, most where E comes from L2).
__global__ void __launch_bounds__(kBlockThreads)
crf_alpha_block_kernel(const float* __restrict__ x,      // [B, T, C]
                       const float* __restrict__ mask,   // [B, T]
                       const float* __restrict__ trans,  // [C, C]
                       const float* __restrict__ a,      // [C]
                       const float* __restrict__ bend,   // [C]
                       float* __restrict__ alphas,       // [B, T, C]
                       float* __restrict__ log_z,        // [B]
                       float* ework,                     // [B, C, C] or null
                       float* vwork,                     // [B, 2, C] or null
                       int T, int C, int K, int ld) {
  extern __shared__ float smem[];
  const bool giant = vwork != nullptr;
  const size_t Cs = static_cast<size_t>(C);
  const int b = blockIdx.x;
  float* red = smem;
  float* vec = giant ? vwork + b * 2 * Cs : smem + 32;
  float* alpha = vec;              // [C]
  float* p = vec + Cs;             // [C]
  const int nt = blockDim.x, tid = threadIdx.x;
  const int slots = nt / K, slot = tid / K;
  const bool owner = tid - slot * K == 0;
  // trans read twice, 16 loads a thread in flight
  const size_t CC = Cs * Cs, stride = static_cast<size_t>(nt);
  float mx = -INFINITY;
  for (size_t k0 = tid; k0 < CC; k0 += kSetupLoads * stride) {
    float tv[kSetupLoads];
#pragma unroll
    for (int r = 0; r < kSetupLoads; ++r) {
      const size_t k = k0 + r * stride;
      tv[r] = k < CC ? trans[k] : -INFINITY;
    }
#pragma unroll
    for (int r = 0; r < kSetupLoads; ++r) mx = fmaxf(mx, tv[r]);
  }
  const float tm = block_max(mx, red);
  // E[i, j] at e[i * ss + j]: shared memory, or this block's copy in L2
  float* e = ld > 0 ? smem + 32 + (giant ? 0 : 2 * Cs) : ework + b * CC;
  const size_t ss = ld > 0 ? static_cast<size_t>(ld) : Cs;
  {  // entry k = i C + j of trans, the thread's (i, j) stepped on: no
     // division in the loop
    int i = tid / C, j = tid - (tid / C) * C;
    const int di = nt / C, dj = nt - di * C;
    for (size_t k0 = tid; k0 < CC; k0 += kSetupLoads * stride) {
      float tv[kSetupLoads];
#pragma unroll
      for (int r = 0; r < kSetupLoads; ++r) {
        const size_t k = k0 + r * stride;
        tv[r] = k < CC ? trans[k] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kSetupLoads; ++r) {
        if (k0 + r * stride < CC) e[i * ss + j] = expf(tv[r] - tm);
        i += di;
        j += dj;
        if (j >= C) {
          j -= C;
          ++i;
        }
      }
    }
  }
  const size_t tc = static_cast<size_t>(T) * C;
  const float* xb = x + b * tc;
  const float* mb = mask + static_cast<size_t>(b) * T;
  float* ab = alphas + b * tc;
  if (owner) {
    for (int j = slot; j < C; j += slots) {
      alpha[j] = a[j] + xb[j];
      ab[j] = alpha[j];
    }
  }
  __syncthreads();  // E (shared or global), and the reads of red for tm
  float m_n = mask_of(mb, 1, 1, 1, T - 1);  // as the warp variant
  unsigned live = 0;
  for (int t = 1; t < T; ++t) {
    const int k = (t - 1) & 31;
    if (k == 0) {
      live = live_bits(m_n);
      m_n = mask_of(mb, t + 32, 1, 1, T - 1);
    }
    if ((live >> k) & 1u)  // block-uniform
      block_chain_step<true>(alpha, p, xb + t * Cs, e, 1, ss, C, tm, red, K);
    if (owner)
      for (int j = slot; j < C; j += slots) ab[t * Cs + j] = alpha[j];
  }
  // log Z: the block's max, then its sum (each owner's terms in order, the
  // warps' butterflies, the warps in order)
  float lm = -INFINITY;
  if (owner)
    for (int j = slot; j < C; j += slots) lm = fmaxf(lm, alpha[j] + bend[j]);
  const float m = block_max(lm, red);
  float s = 0.f;
  if (owner)
    for (int j = slot; j < C; j += slots) s += expf((alpha[j] + bend[j]) - m);
  s = warp_sum(s);
  __syncthreads();  // every warp has read red for m
  if ((tid & 31) == 0) red[tid >> 5] = s;
  __syncthreads();
  if (tid == 0) {
    float z = 0.f;
    for (int w = 0; w < nt / 32; ++w) z += red[w];
    log_z[b] = m + logf(z);
  }
}

// ------------------------------------------------------ the beta chains
// A ring word of the one-launch backward: the beta's bits and its tag.
__device__ __forceinline__ unsigned long long tagged(float v, int tag) {
  return (static_cast<unsigned long long>(static_cast<unsigned>(tag)) << 32) |
         __float_as_uint(v);
}

// Reads the word's value into v when its tag is `tag`; false otherwise.
__device__ __forceinline__ bool untag(unsigned long long w, int tag,
                                     float& v) {
  v = __uint_as_float(static_cast<unsigned>(w));
  return static_cast<int>(w >> 32) == tag;
}

__device__ __forceinline__ void zero_counters(int* counters, int n) {
  if (blockIdx.x == 0)
    for (int k = threadIdx.x; k < n; k += blockDim.x) counters[k] = 0;
}

// The terms of da and db a sequence b owns, for the marginal pass to sum
// over b in order: g (exp(alpha_0 + beta_0 - log Z) mask_0) and g exp(
// alpha_{T-1} + b - log Z) at class j.
template <typename S>
__device__ __forceinline__ void end_terms(const S* __restrict__ alphas,
                                          const S* __restrict__ mask,
                                          const S* __restrict__ bend,
                                          const S* __restrict__ log_z,
                                          const S* __restrict__ g,
                                          float* __restrict__ terms, int b,
                                          int j, float beta0, int T, int C) {
  const size_t tc = static_cast<size_t>(T) * C;
  const S* ab = alphas + b * tc;
  const float lz = ld(log_z + b), gb = ld(g + b);
  float* tb = terms + static_cast<size_t>(b) * 2 * C;
  tb[j] = rnd<S>(gb * rnd<S>(rnd<S>(expf(rnd<S>(rnd<S>(ld(ab + j) + beta0) -
                                                lz))) *
                             ld(mask + static_cast<size_t>(b) * T)));
  tb[C + j] = rnd<S>(
      gb * rnd<S>(expf(rnd<S>(rnd<S>(ld(ab + tc - C + j) + ld(bend + j)) -
                              lz))));
}

// C <= kC <= 32: the whole backward of a sequence in one block, the
// marginals overlapping the chain. Warp 0 runs the beta chain (its lanes'
// rows of E in registers) and publishes each beta_t into a ring of kRing
// rows in shared memory. The worker warps (1
// .. 3 and 5 .. 7, one a scheduler apart from the chain's; warp 4 idles)
// take the pairs (t, t+1) from T - 2 down to 0 as their betas arrive:
// each worker thread sums the pairwise marginals of its dtrans entries
// (e = wt + kWorkers k) in registers, in pair order, and the first C write
// dx's row t + 1 (row 0 at the end). A ring word holds a beta and its tag
// in one 64-bit store, so the chain publishes with no fence and the
// workers wait on the tags of the words they read. Each worker warp
// publishes the pairs it has done (prog), and the chain waits on them only
// before it overwrites a ring row. At the end the workers write the
// sequence's partial dtrans [C, C] and the chain its end terms;
// crf_sum_kernel adds the sequences in order.
template <int kC, typename S>
__global__ void __launch_bounds__(32 * kFusedWarps)
crf_bwd_fused_kernel(const S* __restrict__ x,           // [B, T, C]
                     const S* __restrict__ mask,        // [B, T]
                     const S* __restrict__ trans,       // [C, C]
                     const S* __restrict__ bend,        // [C]
                     const S* __restrict__ alphas,      // [B, T, C]
                     const S* __restrict__ log_z,       // [B]
                     const S* __restrict__ g,           // [B]
                     S* __restrict__ dx,                // [B, T, C]
                     float* __restrict__ partial,       // [B, C, C]
                     float* __restrict__ terms,         // [B, 2, C]
                     int T, int C) {
  extern __shared__ float smem[];
  constexpr int kEnt = (kC * kC + kWorkers - 1) / kWorkers;
  const int ld = C | 1;
  // [kRing, 32] words: a beta's bits, and above them its tag T - t
  volatile unsigned long long* ring =
      reinterpret_cast<volatile unsigned long long*>(smem);
  float* p = smem + 2 * kRing * 32;   // [32] the chain's exp(y - m)
  float* red = p + 32;                // [32]
  volatile int* prog = reinterpret_cast<volatile int*>(red + 32);  // [8]
  float* e_s = red + 32 + kFusedWarps;  // [C, ld]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x;
  float mx = -INFINITY;
  for (int k = threadIdx.x; k < C * C; k += blockDim.x)
    mx = fmaxf(mx, ::ld(trans + k));
  const float tm = block_max(mx, red);
  for (int k = threadIdx.x; k < C * C; k += blockDim.x) {
    const int i = k / C;
    e_s[i * ld + k - i * C] = rnd<S>(expf(rnd<S>(::ld(trans + k) - tm)));
  }
  if (threadIdx.x < kFusedWarps) prog[threadIdx.x] = 0;
  if (warp == 0) p[lane] = 0.f;  // the padded classes' exp(y - m) stay 0
  for (int k = threadIdx.x; k < kRing * 32; k += blockDim.x) ring[k] = 0;
  __syncthreads();
  const size_t tc = static_cast<size_t>(T) * C;
  const S* xb = x + b * tc;
  const S* ab = alphas + b * tc;
  const S* mb = mask + static_cast<size_t>(b) * T;
  const float lz = ::ld(log_z + b), gb = ::ld(g + b);
  if (warp == 0) {  // ------------------------------------- the chain
    const bool own = lane < C;
    float erow[kC];
#pragma unroll
    for (int j = 0; j < kC; ++j)
      erow[j] = own && j < C ? e_s[lane * ld + j] : 0.f;
    float beta = own ? ::ld(bend + lane) : 0.f;
    ring[((T - 1) % kRing) * 32 + lane] = tagged(beta, 1);
    float xq[kAhead];
#pragma unroll
    for (int d = 0; d < kAhead; ++d)
      xq[d] = own && T - 1 - d >= 1
                  ? ::ld(xb + static_cast<size_t>(T - 1 - d) * C + lane)
                  : 0.f;
    float m_n = mask_of(mb, T - 1, -1, 1, T - 1);
    unsigned live = 0;
    int seen = 0;
    for (int t = T - 1; t >= 1; --t) {
      const int k = (T - 1 - t) & 31;
      if (k == 0) {
        live = live_bits(m_n);
        m_n = mask_of(mb, t - 32, -1, 1, T - 1);
      }
      const float x_t = xq[0];
#pragma unroll
      for (int d = 0; d + 1 < kAhead; ++d) xq[d] = xq[d + 1];
      const int tn = t - kAhead;
      xq[kAhead - 1] =
          own && tn >= 1 ? ::ld(xb + static_cast<size_t>(tn) * C + lane) : 0.f;
      if ((live >> k) & 1u)
        beta = warp_chain_step<kC, false, S>(beta, x_t, own, lane, p, erow,
                                             tm);
      // beta_{t-1} goes where beta_{t-1+kRing} was: the workers must have
      // done its last pair, t - 2 + kRing (seen: the least progress read
      // last time, so the counters are read only when that falls short)
      const int need = T + 1 - t - kRing;
      if (need > seen) {
        seen = T;
        for (int w = 1; w < kFusedWarps; ++w) {
          if (w == kIdleWarp) continue;
          int got;
          while ((got = prog[w]) < need) {
          }
          seen = min(seen, got);
        }
      }
      // one 64-bit store carries the value and its tag: no fence, no flag
      ring[((t - 1) % kRing) * 32 + lane] = tagged(beta, T - t + 1);
    }
    if (own)
      end_terms(alphas, mask, bend, log_z, g, terms, b, lane, beta, T, C);
  } else if (warp != kIdleWarp) {  // ------------------------ the workers
    const int wt = (warp < kIdleWarp ? warp - 1 : warp - 2) * 32 + lane;
    const int CC = C * C;
    float tr[kEnt], acc[kEnt];
    int ei[kEnt], ej[kEnt];
#pragma unroll
    for (int q = 0; q < kEnt; ++q) {
      const int e = wt + kWorkers * q;
      const bool ok = e < CC;
      ei[q] = ok ? e / C : 0;
      ej[q] = ok ? e - ei[q] * C : 0;
      tr[q] = ok ? ::ld(trans + e) : 0.f;
      acc[q] = 0.f;
    }
    const bool dxl = wt < C;  // this thread writes dx's column wt
    // what pair t (t = T-2 .. 0, then t = -1: dx's row 0) reads besides
    // the chain's betas, loaded kAhead pairs ahead: alpha_t[i], x_{t+1}[j]
    // of each entry, alpha_{t+1}[wt], mask_{t+1}, mask_t
    float qa[kAhead][kEnt], qx[kAhead][kEnt], qd[kAhead], qm1[kAhead],
        qm0[kAhead];
    auto fetch = [&](int d, int t) {
      if (t < -1) return;
#pragma unroll
      for (int q = 0; q < kEnt; ++q) {
        qa[d][q] = t >= 0 ? ::ld(ab + static_cast<size_t>(t) * C + ei[q]) : 0.f;
        qx[d][q] =
            t >= 0 ? ::ld(xb + static_cast<size_t>(t + 1) * C + ej[q]) : 0.f;
      }
      qd[d] = dxl ? ::ld(ab + static_cast<size_t>(t + 1) * C + wt) : 0.f;
      qm1[d] = ::ld(mb + t + 1);
      qm0[d] = t >= 0 ? ::ld(mb + t) : 0.f;
    };
#pragma unroll
    for (int d = 0; d < kAhead; ++d) fetch(d, T - 2 - d);
    for (int t = T - 2; t >= -1; --t) {  // pair (t, t+1); t = -1: dx row 0
      const float m1 = qm1[0], m0 = qm0[0], ad = qd[0];
      float ca[kEnt], cx[kEnt];
#pragma unroll
      for (int q = 0; q < kEnt; ++q) {
        ca[q] = qa[0][q];
        cx[q] = qx[0][q];
      }
#pragma unroll
      for (int d = 0; d + 1 < kAhead; ++d) {
#pragma unroll
        for (int q = 0; q < kEnt; ++q) {
          qa[d][q] = qa[d + 1][q];
          qx[d][q] = qx[d + 1][q];
        }
        qd[d] = qd[d + 1];
        qm1[d] = qm1[d + 1];
        qm0[d] = qm0[d + 1];
      }
      fetch(kAhead - 1, t - kAhead);
      // beta_{t+1}'s words, tagged T - 1 - t when the chain wrote them
      const int need = T - 1 - t;
      const volatile unsigned long long* bt = ring + ((t + 1) % kRing) * 32;
      float bq[kEnt], bd = 0.f;
      for (;;) {
        bool ready = true;
#pragma unroll
        for (int q = 0; q < kEnt; ++q) ready &= untag(bt[ej[q]], need, bq[q]);
        if (dxl) ready &= untag(bt[wt], need, bd);
        if (ready) break;
        __nanosleep(kPollNs);  // spaced, so that the polls leave the
                               // shared-memory pipe to the chain
      }
      if (dxl)
        st(dx + b * tc + static_cast<size_t>(t + 1) * C + wt,
           rnd<S>(gb *
                  rnd<S>(rnd<S>(expf(rnd<S>(rnd<S>(ad + bd) - lz))) * m1)));
      const float w = m1 * m0 * gb;  // 0 at t = -1 (masks are 0 or 1)
      if (w != 0.f) {
#pragma unroll
        for (int q = 0; q < kEnt; ++q) {
          const float v =
              rnd<S>(rnd<S>(rnd<S>(ca[q] + tr[q]) + rnd<S>(cx[q] + bq[q])) -
                     lz);
          acc[q] += rnd<S>(rnd<S>(expf(fminf(v, 30.f))) * w);
        }
      }
      // the warp's reads of this row are done (their values are used);
      // no fence: it would wait on the loads fetched ahead
      __syncwarp();
      if (lane == 0) prog[warp] = need;  // pairs done: down to t
    }
    float* pb = partial + static_cast<size_t>(b) * CC;
#pragma unroll
    for (int q = 0; q < kEnt; ++q) {
      const int e = wt + kWorkers * q;
      if (e < CC) pb[e] = acc[q];
    }
  }
}

// dtrans [C, C] = the sequences' partials summed over b in order, da and
// db [C] the end terms likewise: one thread an output, stored in S.
template <typename S>
__global__ void __launch_bounds__(kMargThreads)
crf_sum_kernel(const float* __restrict__ partial,  // [B, C, C]
               const float* __restrict__ terms,    // [B, 2, C]
               S* __restrict__ dtrans, S* __restrict__ da,
               S* __restrict__ db, int B, int C) {
  const int CC = C * C;
  const int k = blockIdx.x * kMargThreads + threadIdx.x;
  if (k >= CC + 2 * C) return;
  const float* src = k < CC ? partial + k : terms + (k - CC);
  const size_t stride = k < CC ? static_cast<size_t>(CC) : 2 * C;
  float sum = 0.f;
#pragma unroll 16
  for (int b = 0; b < B; ++b) sum += src[b * stride];
  if (k < CC)
    st(dtrans + k, sum);
  else if (k < CC + C)
    st(da + k - CC, sum);
  else
    st(db + k - CC - C, sum);
}

// et[j * C + i] = exp(trans[i * C + j] - tm), by up to kTileWarps warps
// through their own 32 x 33 tiles of `tile` (reads and writes coalesced).
// Ends with a barrier.
__device__ void transpose_exp(const float* __restrict__ trans, float* et,
                              int C, float tm, float* tile) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  const int users = nw < kTileWarps ? nw : kTileWarps;
  const int tiles = (C + 31) / 32;
  if (warp < users) {
    float* tw = tile + warp * 32 * 33;
    for (int q = warp; q < tiles * tiles; q += users) {
      const int ti = q / tiles, tj = q - ti * tiles;
      const int j = tj * 32 + lane;
      for (int r = 0; r < 32; ++r) {
        const int i = ti * 32 + r;
        if (i < C && j < C)
          tw[r * 33 + lane] = expf(trans[static_cast<size_t>(i) * C + j] - tm);
      }
      __syncwarp();
      const int i = ti * 32 + lane;
      for (int r = 0; r < 32; ++r) {
        const int jr = tj * 32 + r;
        if (i < C && jr < C)
          et[static_cast<size_t>(jr) * C + i] = tw[lane * 33 + r];
      }
      __syncwarp();  // tw is rewritten by the next tile
    }
  }
  __syncthreads();
}

// C > 32: a block a sequence (K parts a row, block_threads(C, K)).
// Shared memory: red [32], then (unless the vectors are global: vwork
// non-null) beta [C], p [C] and x [2][C], then E [C, ld] (mat_smem; ld =
// e_stride(C, K), so that the K parts of 32 / K rows hit 32 banks) or the
// transpose tiles. Without mat_smem, ework holds each sequence's E
// transposed [C, C]. Writes betas and the end terms, as the warp variant.
__global__ void __launch_bounds__(kBlockThreads)
crf_beta_block_kernel(const float* __restrict__ x,       // [B, T, C]
                      const float* __restrict__ mask,    // [B, T]
                      const float* __restrict__ trans,   // [C, C]
                      const float* __restrict__ bend,    // [C]
                      const float* __restrict__ alphas,  // [B, T, C]
                      const float* __restrict__ log_z,   // [B]
                      const float* __restrict__ g,       // [B]
                      float* __restrict__ betas,         // [B, T, C]
                      float* __restrict__ terms,         // [B, 2, C]
                      float* ework,                      // [B, C, C] or null
                      float* vwork,                      // [B, 2, C] or null
                      int* __restrict__ counters, int n_counters, int B,
                      int T, int C, int K, int ld) {
  extern __shared__ float smem[];
  const bool giant = vwork != nullptr;
  const size_t Cs = static_cast<size_t>(C);
  float* red = smem;
  float* vec = giant ? vwork + blockIdx.x * 2 * Cs : smem + 32;
  float* beta = vec;               // [C]
  float* p = vec + Cs;             // [C]
  float* xs = smem + 32 + 2 * Cs;  // [2][C], !giant
  float* mat = smem + 32 + (giant ? 0 : 4 * Cs);
  zero_counters(counters, n_counters);
  const int b = blockIdx.x;
  if (b >= B) return;  // the whole block: no barrier follows
  const int nt = blockDim.x, tid = threadIdx.x;
  const int slots = nt / K, slot = tid / K;
  const bool owner = tid - slot * K == 0;
  float mx = -INFINITY;
  for (size_t k = tid; k < Cs * Cs; k += nt) mx = fmaxf(mx, trans[k]);
  const float tm = block_max(mx, red);
  const float* e;
  size_t si, sj;
  if (ld > 0) {  // E in shared memory
    for (size_t k = tid; k < Cs * Cs; k += nt) {
      const size_t i = k / Cs;
      mat[i * ld + k - i * Cs] = expf(trans[k] - tm);
    }
    e = mat;
    si = ld;
    sj = 1;
  } else {
    float* et = ework + b * Cs * Cs;
    transpose_exp(trans, et, C, tm, mat);
    e = et;
    si = 1;
    sj = Cs;
  }
  const size_t tc = static_cast<size_t>(T) * C;
  const float* xb = x + b * tc;
  const float* mb = mask + static_cast<size_t>(b) * T;
  float* bb = betas + b * tc;
  if (owner) {
    for (int i = slot; i < C; i += slots) {
      beta[i] = bend[i];
      bb[(T - 1) * Cs + i] = bend[i];
      if (!giant)  // x_{T-1} into its slot, ahead of the step that reads it
        cp_async4(xs + ((T - 1) & 1) * Cs + i, xb + (T - 1) * Cs + i);
    }
  }
  cp_async_commit();
  __syncthreads();  // E, and the reads of red for tm
  float m_n = mask_of(mb, T - 1, -1, 1, T - 1);  // as the warp variant
  unsigned live = 0;
  for (int t = T - 1; t >= 1; --t) {
    const int k = (T - 1 - t) & 31;
    if (k == 0) {
      live = live_bits(m_n);
      m_n = mask_of(mb, t - 32, -1, 1, T - 1);
    }
    const float* xt = xb + t * Cs;
    if (!giant) {  // x_{t-1} copied while this step runs
      if (t >= 2 && owner)
        for (int i = slot; i < C; i += slots)
          cp_async4(xs + ((t - 1) & 1) * Cs + i, xb + (t - 1) * Cs + i);
      cp_async_commit_wait_prev();
      xt = xs + (t & 1) * Cs;
    }
    if ((live >> k) & 1u)  // block-uniform
      block_chain_step<false>(beta, p, xt, e, si, sj, C, tm, red, K);
    if (owner)
      for (int i = slot; i < C; i += slots) bb[(t - 1) * Cs + i] = beta[i];
  }
  cp_async_wait_all();
  if (owner)
    for (int i = slot; i < C; i += slots)
      end_terms(alphas, mask, bend, log_z, g, terms, b, i, beta[i], T, C);
}

// ---------------------------------------------------- the marginal pass
// dx = g exp(alpha + beta - log Z) mask over the flat index k, this
// block's share (I: the index type, 32-bit where B T C allows).
template <typename I>
__device__ __forceinline__ void dx_share(const float* __restrict__ alphas,
                                         const float* __restrict__ betas,
                                         const float* __restrict__ mask,
                                         const float* __restrict__ log_z,
                                         const float* __restrict__ g,
                                         float* __restrict__ dx, I total,
                                         I first, I stride, int T, int C) {
  for (I k = first; k < total; k += stride) {
    const I bt = k / static_cast<I>(C);
    const I b = bt / static_cast<I>(T);
    dx[k] = g[b] * (expf(alphas[k] + betas[k] - log_z[b]) * mask[bt]);
  }
}

// Grid (tiles_i * tiles_j, chunks), kMargThreads threads. Tile (ti, tj)
// holds dtrans rows ti * TI .. and columns tj * TJ .. (TJ = min(C, 32), TI =
// 256 / TJ; thread tid: row tid / TJ, column tid % TJ); chunk c the pairs
// (b, t), t < T - 1, of flat index c * chunk_len .. (c + 1) * chunk_len - 1
// in b-major order, up to kStagePairs at a time: one thread a pair puts
// its row offset, weight mask_{t+1} mask_t g and log Z in shared memory,
// then each thread reads its alpha_t[i], x_{t+1}[j] and beta_{t+1}[j]
// straight from global memory (L1 serves the row's and the column's other
// threads), kUnroll pairs' loads in flight. A dead pair (weight 0) adds
// exp(..) 0 = +-0, which leaves the sum as it is, so no pair branches.
// Block (0, 0) first sums da and db from the chain's end terms over b in
// order.
__global__ void __launch_bounds__(kMargThreads)
crf_marginal_kernel(const float* __restrict__ x,       // [B, T, C]
                    const float* __restrict__ mask,    // [B, T]
                    const float* __restrict__ trans,   // [C, C]
                    const float* __restrict__ alphas,  // [B, T, C]
                    const float* __restrict__ betas,   // [B, T, C]
                    const float* __restrict__ terms,   // [B, 2, C]
                    const float* __restrict__ log_z,   // [B]
                    const float* __restrict__ g,       // [B]
                    float* __restrict__ dx,            // [B, T, C]
                    float* __restrict__ dtrans,        // [C, C]
                    float* __restrict__ da,            // [C]
                    float* __restrict__ db,            // [C]
                    float* partial,                    // [chunks, C, C]
                    int* counters,                     // [tiles]
                    int B, int T, int C, int TI, int TJ, int tiles_j,
                    long long chunk_len) {
  __shared__ long long base_s[kStagePairs];
  __shared__ float w_s[kStagePairs], lz_s[kStagePairs];
  __shared__ int last;
  const int tid = threadIdx.x;
  const size_t Cs = static_cast<size_t>(C), CC = Cs * Cs;
  const int tile = blockIdx.x, chunk = blockIdx.y;
  const int ti = tile / tiles_j, tj = tile - ti * tiles_j;
  const int n_chunks = gridDim.y;

  if (tile == 0 && chunk == 0) {  // da, db: over b in order
    for (int j = tid; j < C; j += kMargThreads) {
      float sa = 0.f, sb = 0.f;
#pragma unroll 16
      for (int b = 0; b < B; ++b) {
        sa += terms[static_cast<size_t>(b) * 2 * C + j];
        sb += terms[static_cast<size_t>(b) * 2 * C + C + j];
      }
      da[j] = sa;
      db[j] = sb;
    }
  }
  const size_t total = static_cast<size_t>(B) * T * Cs;
  const size_t first = (static_cast<size_t>(chunk) * gridDim.x + tile) *
                           kMargThreads + tid;
  const size_t stride = static_cast<size_t>(gridDim.x) * gridDim.y *
                        kMargThreads;
  if (total + stride <= 0xffffffffu)
    dx_share<unsigned>(alphas, betas, mask, log_z, g, dx, total, first,
                       stride, T, C);
  else
    dx_share<size_t>(alphas, betas, mask, log_z, g, dx, total, first, stride,
                     T, C);

  // the pairwise marginals of this tile over this chunk's pairs
  const int i0 = ti * TI, j0 = tj * TJ;
  const int ni = min(TI, C - i0), nj = min(TJ, C - j0);
  const int ii = tid / TJ, jj = tid - ii * TJ;
  const bool valid = ii < ni && jj < nj;
  const size_t e = static_cast<size_t>(i0 + (valid ? ii : 0)) * Cs + j0
                   + (valid ? jj : 0);
  const float tr = trans[e];
  const float* ai = alphas + i0 + (valid ? ii : 0);            // + row
  const float* xj = x + Cs + j0 + (valid ? jj : 0);            // + row
  const float* bj = betas + Cs + j0 + (valid ? jj : 0);        // + row
  const long long pairs = static_cast<long long>(B) * (T - 1);
  const long long p0 = chunk * chunk_len;
  const long long p1 = p0 + chunk_len < pairs ? p0 + chunk_len : pairs;
  float acc = 0.f;
  for (long long q0 = p0; q0 < p1; q0 += kStagePairs) {
    const int n = static_cast<int>(p1 - q0 < kStagePairs ? p1 - q0
                                                          : kStagePairs);
    __syncthreads();  // the previous pairs are read
    if (tid < n) {
      const long long q = q0 + tid;
      const long long b = q / (T - 1), t = q - b * (T - 1);
      base_s[tid] = (b * T + t) * C;
      w_s[tid] = mask[b * T + t + 1] * mask[b * T + t] * g[b];
      lz_s[tid] = log_z[b];
    }
    __syncthreads();
#pragma unroll 8
    for (int s = 0; s < n; ++s) {
      const long long at = base_s[s];
      const float v = ai[at] + tr + (xj[at] + bj[at]) - lz_s[s];
      acc += expf(fminf(v, 30.f)) * w_s[s];
    }
  }
  if (valid) partial[chunk * CC + e] = acc;
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(counters + tile, 1) == n_chunks - 1;
  __syncthreads();
  if (!last || !valid) return;
  __threadfence();
  float sum = 0.f;  // the chunks' partials in chunk order
#pragma unroll 16
  for (int c = 0; c < n_chunks; ++c) sum += __ldcg(partial + c * CC + e);
  dtrans[e] = sum;
}

// ------------------------------------------------------------ Viterbi
// C <= kC <= 32: a warp a sequence, kWarps a block, each lane's column of
// trans in registers. Shared memory: the warps' [2][32] rows, then
// (kBpSmem) their back-pointers
// [kWarps][T][C] bytes; else each sequence's back-pointers at spill + b *
// stride (a template, so that the stores to shared memory are STS).
template <int kC, bool kBpSmem, typename S>
__global__ void __launch_bounds__(kThreads)
crf_decode_warp_kernel(const S* __restrict__ x,      // [B, T, C]
                       const S* __restrict__ mask,   // [B, T]
                       const S* __restrict__ trans,  // [C, C]
                       const S* __restrict__ a,      // [C]
                       const S* __restrict__ bend,   // [C]
                       int* __restrict__ path,       // [B, T]
                       S* __restrict__ score,        // [B]
                       unsigned char* spill, size_t stride, int B, int T,
                       int C) {
  extern __shared__ float smem[];
  float* v_s = smem;                  // [kWarps][2][32]
  unsigned char* bp_s = reinterpret_cast<unsigned char*>(v_s + kWarps * 64);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= B) return;  // no barrier follows
  const bool own = lane < C;
  float col[kC];  // the lane's column of trans, all loads in flight at once
#pragma unroll
  for (int i = 0; i < kC; ++i)
    col[i] = own && i < C ? ld(trans + i * C + lane) : 0.f;
  float* v = v_s + warp * 64;
  v[lane] = -INFINITY;  // the padded classes never win
  v[32 + lane] = -INFINITY;
  __syncwarp();
  const size_t tc = static_cast<size_t>(T) * C;
  unsigned char* bp = kBpSmem ? bp_s + warp * tc : spill + b * stride;
  const S* xb = x + b * tc;
  const S* mb = mask + static_cast<size_t>(b) * T;
  float alpha = own ? rnd<S>(ld(a + lane) + ld(xb + lane)) : -INFINITY;
  // emissions kAhead steps ahead, masks a chunk of 32 steps ahead
  float xq[kAhead];
#pragma unroll
  for (int d = 0; d < kAhead; ++d)
    xq[d] = own && 1 + d < T ? ld(xb + static_cast<size_t>(1 + d) * C + lane)
                             : 0.f;
  float m_n = mask_of(mb, 1, 1, 1, T - 1);
  unsigned live = 0;
  int cur = 0;
  for (int t = 1; t < T; ++t) {
    const int k = (t - 1) & 31;
    if (k == 0) {
      live = live_bits(m_n);
      m_n = mask_of(mb, t + 32, 1, 1, T - 1);
    }
    const float x_t = xq[0];
#pragma unroll
    for (int d = 0; d + 1 < kAhead; ++d) xq[d] = xq[d + 1];
    const int tn = t + kAhead;
    xq[kAhead - 1] =
        own && tn < T ? ld(xb + static_cast<size_t>(tn) * C + lane) : 0.f;
    unsigned char* bpt = bp + static_cast<size_t>(t) * C;
    if ((live >> k) & 1u) {  // warp-uniform
      int arg = 0;
      alpha = warp_viterbi_step<kC, S>(alpha, x_t, own, lane, v + cur * 32,
                                       col, arg);
      if (own) bpt[lane] = static_cast<unsigned char>(arg);
      cur ^= 1;
    } else if (own) {
      bpt[lane] = static_cast<unsigned char>(lane);  // j came from j
    }
  }
  float f = own ? rnd<S>(alpha + ld(bend + lane)) : -INFINITY;
  int arg = lane;
  warp_argmax(f, arg);
  __syncwarp();  // every lane's pointers are visible to lane 0
  if (lane == 0) {
    int* yb = path + static_cast<size_t>(b) * T;
    int state = arg;
    yb[T - 1] = state;
    for (int t = T - 1; t >= 1; --t) {
      state = bp[static_cast<size_t>(t) * C + state];
      yb[t - 1] = state;
    }
    st(score + b, f);
  }
}

// C > 32: a block a sequence, K parts a column. Shared memory: (value,
// index) [32] each, then (unless giant) the alphas [2][C] and x [2][C],
// then trans [C, ld] (ld > 0: ld = t_stride(C, K), so that the K parts of
// 32 / K columns hit 32 banks), then the back-pointers [T][C] of IdxT
// (bp_smem). The sequence's scratch (scratch + b * stride) holds the
// alphas [2][C] where giant, then the back-pointers where not bp_smem.
template <typename IdxT>
__global__ void __launch_bounds__(kBlockThreads)
crf_decode_block_kernel(const float* __restrict__ x,      // [B, T, C]
                        const float* __restrict__ mask,   // [B, T]
                        const float* __restrict__ trans,  // [C, C]
                        const float* __restrict__ a,      // [C]
                        const float* __restrict__ bend,   // [C]
                        int* __restrict__ path,           // [B, T]
                        float* __restrict__ score,        // [B]
                        unsigned char* scratch, size_t stride, int T, int C,
                        int K, int ld, int bp_smem, int giant) {
  extern __shared__ float smem[];
  const size_t Cs = static_cast<size_t>(C);
  float* red_v = smem;
  int* red_i = reinterpret_cast<int*>(smem + 32);
  const int b = blockIdx.x;
  unsigned char* mine = scratch == nullptr ? nullptr : scratch + b * stride;
  float* v = giant ? reinterpret_cast<float*>(mine) : smem + 64;  // [2][C]
  float* xs = smem + 64 + 2 * Cs;                                  // [2][C]
  float* after = smem + 64 + (giant ? 0 : 4 * Cs);
  const int nt = blockDim.x, tid = threadIdx.x;
  const int slots = nt / K, slot = tid / K;
  const bool owner = tid - slot * K == 0;
  const float* tr = trans;
  size_t si = Cs;
  if (ld > 0) {  // trans in shared memory
    for (size_t k = tid; k < Cs * Cs; k += nt) {
      const size_t i = k / Cs;
      after[i * ld + k - i * Cs] = trans[k];
    }
    tr = after;
    si = ld;
    after += Cs * ld;
  }
  IdxT* bp = reinterpret_cast<IdxT*>(
      bp_smem ? reinterpret_cast<unsigned char*>(after)
              : mine + (giant ? sizeof(float) * 2 * Cs : 0));
  const size_t tc = static_cast<size_t>(T) * C;
  const float* xb = x + b * tc;
  const float* mb = mask + static_cast<size_t>(b) * T;
  for (int j = tid; j < C; j += nt) v[j] = a[j] + xb[j];
  if (!giant && T > 1 && owner)
    for (int j = slot; j < C; j += slots) cp_async4(xs + Cs + j, xb + Cs + j);
  cp_async_commit();
  __syncthreads();
  float m_n = mask_of(mb, 1, 1, 1, T - 1);  // as the warp variant
  unsigned live = 0;
  int cur = 0;
  for (int t = 1; t < T; ++t) {
    const int k = (t - 1) & 31;
    if (k == 0) {
      live = live_bits(m_n);
      m_n = mask_of(mb, t + 32, 1, 1, T - 1);
    }
    const float* xt = xb + t * Cs;
    if (!giant) {  // x_{t+1} copied while this step runs
      if (t + 1 < T && owner)
        for (int j = slot; j < C; j += slots)
          cp_async4(xs + ((t + 1) & 1) * Cs + j, xb + (t + 1) * Cs + j);
      cp_async_commit_wait_prev();
      xt = xs + (t & 1) * Cs;
    }
    IdxT* bpt = bp + t * Cs;
    if ((live >> k) & 1u) {  // block-uniform
      block_viterbi_step(v + cur * Cs, v + (cur ^ 1) * Cs, xt, tr, si, C,
                         bpt, K);
      cur ^= 1;
    } else {
      for (int j = tid; j < C; j += nt) bpt[j] = static_cast<IdxT>(j);
    }
  }
  cp_async_wait_all();
  float best = -INFINITY;
  int arg = tid;  // a thread's first column
  for (int j = tid; j < C; j += nt) {
    const float f = v[cur * Cs + j] + bend[j];
    if (f > best) {
      best = f;
      arg = j;
    }
  }
  warp_argmax(best, arg);
  if ((tid & 31) == 0) {
    red_v[tid >> 5] = best;
    red_i[tid >> 5] = arg;
  }
  __syncthreads();  // also the back-pointers of every thread
  if (tid == 0) {
    for (int w = 1; w < nt / 32; ++w)
      take_better(best, arg, red_v[w], red_i[w]);
    int* yb = path + static_cast<size_t>(b) * T;
    int state = arg;
    yb[T - 1] = state;
    for (int t = T - 1; t >= 1; --t) {
      state = static_cast<int>(bp[t * Cs + state]);
      yb[t - 1] = state;
    }
    score[b] = best;
  }
}

// -------------------------------------------------------------- the floor
// T dependent steps of a chain's own step function (kVariant: kBeta, the
// beta recursion's; kViterbi, the Viterbi's; kAlpha, the forward's) with
// no global memory but the last write: the chain bound's unit. The matrix
// is one row r that every row (the beta, the Viterbi) or column (the
// alpha) reads: trans[i, j] = r_j for the beta and the Viterbi, r_i for
// the alpha, r_k = -(k mod 7) / 4, and E = exp(trans - max r); x_j = -1/2
// - (j mod 5) / 8, the start -(j mod 3) / 2, mask 1. out [C] the last
// vector; the Viterbi adds [C] the last back-pointers.
// ops/crf.py:chain_floor_plain computes the same. Shared memory: [32],
// the row [C], x [C], the vectors [2][max(C, 32)] (the warp kernel puts
// them first), the back-pointers of the last 16 steps.
constexpr int kBeta = 0, kViterbi = 1, kAlpha = 2;

__device__ __forceinline__ void floor_inputs(float* row, float* xs,
                                             float* v, int C, bool viterbi) {
  for (int j = threadIdx.x; j < C; j += blockDim.x) {
    const float r = -0.25f * (j % 7);
    row[j] = viterbi ? r : expf(r);  // max r = r_0 = 0
    xs[j] = -0.5f - 0.125f * (j % 5);
    v[j] = -0.5f * (j % 3);
  }
}

// C <= kC <= 32: one warp, the warp step.
template <int kVariant, int kC>
__global__ void __launch_bounds__(32)
crf_floor_warp_kernel(float* __restrict__ out, int T, int C) {
  constexpr bool kVit = kVariant == kViterbi;
  extern __shared__ float smem[];
  float* v = smem;  // [2][32], 16-byte aligned as the kernels'
  float* row = v + 64 + 32;
  float* xs = row + C;
  unsigned short* bp = reinterpret_cast<unsigned short*>(xs + C);
  const int lane = threadIdx.x;
  const bool own = lane < C;
  v[lane] = v[32 + lane] = kVit ? -INFINITY : 0.f;
  __syncwarp();
  floor_inputs(row, xs, v, C, kVit);
  __syncwarp();
  float val = own ? v[lane] : 0.f;
  const float x_j = own ? xs[lane] : 0.f;
  // the beta's row E_j and the alpha's column E_i = exp(r_i) are the same
  // registers; the Viterbi's column r_{lane} for every i
  float mat[kC];
#pragma unroll
  for (int j = 0; j < kC; ++j)
    mat[j] = !own || j >= C ? 0.f : (kVit ? row[lane] : row[j]);
  if (!kVit) {
    v[lane] = 0.f;  // p
    __syncwarp();
  }
  for (int t = 0; t < T; ++t) {
    if (kVit) {
      int arg = 0;
      val = warp_viterbi_step<kC>(val, x_j, own, lane, v + (t & 1) * 32, mat,
                                  arg);
      if (own) bp[(t & 15) * C + lane] = static_cast<unsigned short>(arg);
    } else {
      val = warp_chain_step<kC, kVariant == kAlpha>(val, x_j, own, lane, v,
                                                    mat, 0.f);
    }
  }
  __syncwarp();
  if (own) {
    out[lane] = val;
    if (kVit) out[C + lane] = bp[((T - 1) & 15) * C + lane];
  }
}

// C > 32: a block of the chain's own threads and parts, the block step.
template <int kVariant>
__global__ void __launch_bounds__(kBlockThreads)
crf_floor_block_kernel(float* __restrict__ out, int T, int C, int K) {
  constexpr bool kVit = kVariant == kViterbi;
  extern __shared__ float smem[];
  const size_t Cs = static_cast<size_t>(C);
  float* red = smem;
  float* row = smem + 32;
  float* xs = row + C;
  float* v = xs + C;  // [2][C]
  unsigned short* bp = reinterpret_cast<unsigned short*>(v + 2 * Cs);
  floor_inputs(row, xs, v, C, kVit);
  __syncthreads();
  int cur = 0;
  for (int t = 0; t < T; ++t) {
    if (kVit) {
      block_viterbi_step(v + cur * Cs, v + (cur ^ 1) * Cs, xs, row, 0, C,
                         bp + (t & 15) * Cs, K);
      cur ^= 1;
    } else {  // owner o reads row[j], j = 0 .. C-1, either way
      block_chain_step<kVariant == kAlpha>(v, v + Cs, xs, row, 0, 1, C, 0.f,
                                           red, K);
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < C; j += blockDim.x) {
    out[j] = v[(kVit ? cur : 0) * Cs + j];
    if (kVit) out[C + j] = bp[((T - 1) & 15) * Cs + j];
  }
}

// ------------------------------------------------------------------ plans
// One plan for each kernel at (T, C) (and B for the marginal pass);
// ops/crf.py:crf_plan spells the same formulas (a card test holds the two
// equal through crf_plan_query).

// The warp variants' compile-time class count: C rounded up to 8.
int warp_classes(int C) { return 8 * ((C + 7) / 8); }

// The block variants' parts a row (or column): 2 up to C = 512, 1 above
// (measured on the H100 at C = 64 to 256: 2 beat 1, 4 and 8, whose wider
// blocks pay more for their barriers); then 32 ceil(C K / 32) threads,
// at most 1024.
int block_parts(int C) {
  return C <= 512 ? 2 : 1;
}

// The beta chain with E read from L2 takes 4 lanes a row up to C = 256
// (1024 threads): more loads in flight (measured on the H100 at C = 256).
int beta_parts_global(int C) { return C <= 256 ? 4 : block_parts(C); }

int block_threads(int C, int K) {
  const long long want = static_cast<long long>(C) * K;
  const int c = want < kBlockThreads ? static_cast<int>(want) : kBlockThreads;
  return 32 * ((c + 31) / 32);
}

// Row strides in shared memory at which the K parts of 32 / K rows (E,
// read along rows: ld = K mod 32) or of 32 / K columns (trans, read down
// columns: ld = 32 / K mod 32) fall in 32 distinct banks.
int e_stride(int C, int K) { return C + ((K - C) % 32 + 32) % 32; }
int t_stride(int C, int K) { return C + ((32 / K - C) % 32 + 32) % 32; }

struct ChainPlan {
  bool block = false;     // a block a sequence (C > 32), else a warp
  int threads = 0;        // a block's
  int parts = 1;          // a block variant's lanes a row or column
  int ld = 0;             // the matrix's row stride in shared memory, or 0
  bool mat_smem = false;  // the [C, C] matrix in shared memory
  bool bp_smem = false;   // the Viterbi's back-pointers in shared memory
  bool giant = false;     // the per-class vectors in global memory
  int bp_bytes = 0;       // a back-pointer's bytes (the Viterbi)
  size_t smem = 0;        // dynamic shared memory
};

ChainPlan beta_plan(int C) {
  ChainPlan p;
  const size_t Cs = static_cast<size_t>(C);
  if (C <= 32) {  // the one-launch kernel: E, the ring, p, red, progress
    p.threads = 32 * kFusedWarps;
    p.mat_smem = true;
    p.ld = C | 1;
    p.smem = sizeof(float) * (Cs * (C | 1) + 2 * kRing * 32 + 64 + kFusedWarps);
    return p;
  }
  p.block = true;
  p.parts = block_parts(C);
  const size_t red = sizeof(float) * 32;
  const size_t vec = sizeof(float) * 4 * Cs;  // beta, p, x of two steps
  const int ld = e_stride(C, p.parts);
  const size_t mat = sizeof(float) * Cs * ld;
  if (red + vec + mat <= kMaxSmem) {
    p.threads = block_threads(C, p.parts);
    p.mat_smem = true;
    p.ld = ld;
    p.smem = red + vec + mat;
    return p;
  }
  p.parts = beta_parts_global(C);
  p.threads = block_threads(C, p.parts);
  p.giant = red + vec + kTileBytes > kMaxSmem;
  p.smem = red + (p.giant ? 0 : vec) + kTileBytes;
  return p;
}

ChainPlan viterbi_plan(int T, int C) {
  ChainPlan p;
  const size_t Cs = static_cast<size_t>(C);
  p.bp_bytes = C <= 256 ? 1 : (C <= 65536 ? 2 : 4);
  const size_t bp = static_cast<size_t>(T) * Cs * p.bp_bytes;  // a sequence
  if (C <= 32) {  // the columns in registers
    p.threads = kThreads;
    p.mat_smem = true;
    p.ld = C;
    const size_t base = sizeof(float) * kWarps * 64;
    p.bp_smem = base + kWarps * bp <= kMaxSmem;
    p.smem = base + (p.bp_smem ? kWarps * bp : 0);
    return p;
  }
  p.block = true;
  p.parts = block_parts(C);
  p.threads = block_threads(C, p.parts);
  const size_t red = sizeof(float) * 64;      // (value, index) a warp
  const size_t vec = sizeof(float) * 4 * Cs;  // alphas, x of two steps
  p.giant = red + vec > kMaxSmem;
  size_t used = red + (p.giant ? 0 : vec);
  const int ld = t_stride(C, p.parts);
  const size_t mat = sizeof(float) * Cs * ld;
  p.mat_smem = used + mat <= kMaxSmem;
  if (p.mat_smem) {
    used += mat;
    p.ld = ld;
  }
  p.bp_smem = used + bp <= kMaxSmem;
  if (p.bp_smem) used += bp;
  p.smem = used;
  return p;
}

// The forward: C <= 32 a warp a sequence, E in shared memory at row
// stride C (in_global: each block's copy in scratch); above, a block a
// sequence, K parts a column, E in shared memory at t_stride(C, K) where
// it fits with the vectors: K = 4 where that fits (C <= 232), else
// block_parts(C) (C <= 239); else each block's copy in scratch, read from
// L2 with beta_parts_global(C) parts (4 up to C = 256). On the H100 at C
// = 128 and 200 4 parts beat 2 and 8. in_global forces the copy at the
// shared path's K: the same partition, the same bits.
ChainPlan alpha_plan(int C, bool in_global) {
  ChainPlan p;
  const size_t Cs = static_cast<size_t>(C);
  if (C <= 32) {  // the warps' p rows, red, then E
    p.threads = kThreads;
    p.mat_smem = !in_global;
    p.ld = in_global ? 0 : C;
    p.smem = sizeof(float) * (kThreads + 32 + (in_global ? 0 : Cs * Cs));
    return p;
  }
  p.block = true;
  const size_t red = sizeof(float) * 32;
  const size_t vec = sizeof(float) * 2 * Cs;  // alpha, p
  const auto mat = [&](int K) { return sizeof(float) * Cs * t_stride(C, K); };
  p.parts = C <= 256 && red + vec + mat(4) <= kMaxSmem ? 4 : block_parts(C);
  if (red + vec + mat(p.parts) <= kMaxSmem) {  // E fits beside the vectors
    p.threads = block_threads(C, p.parts);
    p.mat_smem = !in_global;
    p.ld = in_global ? 0 : t_stride(C, p.parts);
    p.smem = red + vec + (in_global ? 0 : mat(p.parts));
    return p;
  }
  p.parts = beta_parts_global(C);
  p.threads = block_threads(C, p.parts);
  p.giant = red + vec > kMaxSmem;
  p.smem = red + (p.giant ? 0 : vec);
  return p;
}

// Floats of the forward's scratch at B: each block's copy of E where it is
// not in shared memory (ceil(B / kWarps) blocks at C <= 32, B above), then
// each sequence's alpha and p [2, C] where giant.
size_t fwd_work_floats(int B, int C, bool in_global) {
  const ChainPlan p = alpha_plan(C, in_global);
  const size_t Bs = static_cast<size_t>(B), Cs = static_cast<size_t>(C);
  const size_t blocks = p.block ? Bs : (Bs + kWarps - 1) / kWarps;
  return (p.mat_smem ? 0 : blocks * Cs * Cs) + (p.giant ? Bs * 2 * Cs : 0);
}

// A sequence's Viterbi scratch in bytes (16-byte multiple): its alphas of
// two steps where giant, then its back-pointers where not in shared memory.
size_t viterbi_stride(const ChainPlan& p, int T, int C) {
  const size_t n = (p.giant ? sizeof(float) * 2 * static_cast<size_t>(C) : 0)
                   + (p.bp_smem ? 0 : static_cast<size_t>(T) * C * p.bp_bytes);
  return (n + 15) / 16 * 16;
}

struct MargPlan {
  int ti = 1, tj = 1;           // a tile's rows and columns of dtrans
  int tiles_i = 1, tiles_j = 1;
  int chunks = 1;               // of the (b, t) pairs
  long long chunk_len = 0;      // pairs a chunk
};

MargPlan marg_plan(int B, int T, int C) {
  MargPlan m;
  m.tj = C < 32 ? C : 32;
  m.ti = kMargThreads / m.tj;
  m.tiles_i = (C + m.ti - 1) / m.ti;
  m.tiles_j = (C + m.tj - 1) / m.tj;
  const long long tiles = static_cast<long long>(m.tiles_i) * m.tiles_j;
  const long long pairs = static_cast<long long>(B) * (T - 1);
  const long long by_pairs = (pairs + kMinPairs - 1) / kMinPairs;
  const long long by_blocks = (kTargetBlocks + tiles - 1) / tiles;
  const long long ch = by_pairs < by_blocks ? by_pairs : by_blocks;
  m.chunks = ch < 1 ? 1 : static_cast<int>(ch);
  m.chunk_len = (pairs + m.chunks - 1) / m.chunks;
  return m;
}

// Floats of the backward's scratch. C <= 32: each sequence's partial
// dtrans [B, C, C] and end terms [B, 2, C]. Above: the betas [B, T, C],
// the end terms [B, 2, C] (da's and db's per sequence), each sequence's
// transposed E [C, C] (where E outgrows shared memory), each sequence's
// beta and p [2, C] (giant), the chunks' partial dtrans [chunks, C, C],
// and a counter (int) a tile.
size_t bwd_work_floats(int B, int T, int C) {
  const ChainPlan p = beta_plan(C);
  const size_t Bs0 = static_cast<size_t>(B), Cs0 = static_cast<size_t>(C);
  if (!p.block) return Bs0 * Cs0 * Cs0 + Bs0 * 2 * Cs0;  // partials, terms
  const MargPlan m = marg_plan(B, T, C);
  const size_t Bs = static_cast<size_t>(B), Cs = static_cast<size_t>(C);
  return Bs * T * Cs + Bs * 2 * Cs
         + (p.block && !p.mat_smem ? Bs * Cs * Cs : 0)
         + (p.giant ? Bs * 2 * Cs : 0) + static_cast<size_t>(m.chunks) * Cs * Cs
         + static_cast<size_t>(m.tiles_i) * m.tiles_j;
}

size_t floor_smem(int C) {
  const size_t Cs = static_cast<size_t>(C), Cw = C > 32 ? Cs : 32;
  return sizeof(float) * (32 + 2 * Cs + 2 * Cw) +
         sizeof(unsigned short) * 16 * Cs;
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

template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, size_t smem,
                   cudaStream_t s, Args... args) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, s>>>(args...);
  return cudaGetLastError();
}

template <typename IdxT>
cudaError_t launch_decode_block(const ChainPlan& p, const float* x,
                                const float* mask, const float* trans,
                                const float* a, const float* b,
                                unsigned char* scratch, size_t stride,
                                int* path, float* score, int B, int T, int C,
                                cudaStream_t s) {
  return launch(crf_decode_block_kernel<IdxT>, dim3(B), p.threads, p.smem, s,
                x, mask, trans, a, b, path, score, scratch, stride, T, C,
                p.parts, p.mat_smem ? p.ld : 0, static_cast<int>(p.bp_smem),
                static_cast<int>(p.giant));
}

// ------------------------------- the earlier kernels' launches
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

bool bad_shape(int B, int T, int C) {
  return B < 0 || T < 1 || C < 1 || C > kEarlierClasses;
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

// The entries below launch on `stream`, allocate nothing and do not
// synchronise. Each returns the launch error (cudaError_t as int), 0 when
// the launches were accepted; cudaErrorInvalidValue for a shape the
// kernels do not take.

// ------------------------------------------------------------- the plan
// kernel 0: the beta chain, 1: the Viterbi, 2: the beta floor, 3: the
// Viterbi floor, 4: the marginal pass (at B), 5: the forward, 6: the
// alpha floor. field 0: dynamic shared memory bytes; 1: flags (1 a block a
// sequence, 2 the matrix in shared memory, 4 the back-pointers in shared
// memory, 8 the vectors in global memory); 2: threads a block; 3: the
// backward's scratch floats (kernel 0), the Viterbi's scratch bytes (1)
// or the forward's scratch floats (5), at B; 4: parts a row or column; 5:
// the matrix's row stride in shared memory (0: global); for kernel 4, 1:
// tiles, 2: chunks, 3: a tile's columns. -1 for an unknown query.
extern "C" long long crf_plan_query(int kernel, int B, int T, int C,
                                    int field) {
  if (kernel == 4) {
    const MargPlan m = marg_plan(B, T, C);
    switch (field) {
      case 0:
        return static_cast<long long>(sizeof(long long) + 2 * sizeof(float)) *
               kStagePairs;
      case 1: return static_cast<long long>(m.tiles_i) * m.tiles_j;
      case 2: return m.chunks;
      case 3: return m.tj;
      default: return -1;
    }
  }
  if (kernel == 2 || kernel == 3 || kernel == 6) {
    if (field == 0) return static_cast<long long>(floor_smem(C));
    if (field == 2)
      return C <= 32 ? 32
                     : (kernel == 2   ? beta_plan(C)
                        : kernel == 3 ? viterbi_plan(1, C)
                                      : alpha_plan(C, false))
                           .threads;
    return -1;
  }
  if (kernel != 0 && kernel != 1 && kernel != 5) return -1;
  const ChainPlan p = kernel == 0   ? beta_plan(C)
                      : kernel == 1 ? viterbi_plan(T, C)
                                    : alpha_plan(C, false);
  switch (field) {
    case 0: return static_cast<long long>(p.smem);
    case 1: return (p.block ? 1 : 0) | (p.mat_smem ? 2 : 0)
                   | (p.bp_smem ? 4 : 0) | (p.giant ? 8 : 0);
    case 2: return p.threads;
    case 3: return kernel == 0
        ? static_cast<long long>(bwd_work_floats(B, T, C))
        : kernel == 1 ? static_cast<long long>(B) * viterbi_stride(p, T, C)
                      : static_cast<long long>(fwd_work_floats(B, C, false));
    case 4: return p.parts;
    case 5: return p.ld;
    default: return -1;
  }
}

// The earlier kernels' scratch: floats of `work` that the earlier forward
// (kernel 0) or the inline backward (1) needs at C: 2 C^2 + 1 where its
// matrices outgrow a block's shared memory, else 0 (pass a null pointer).
extern "C" int crf_work_floats(int kernel, int C) {
  if (C < 1 || C > kEarlierClasses) return 0;
  const size_t need = kernel == 0 ? fwd_smem(C, true) : bwd_smem(C, true);
  return need > kMaxSmem ? 2 * C * C + 1 : 0;
}

#define CRF_DISPATCH(fn, ...)                        \
  switch (per_lane(C)) {                             \
    case 1: return fn<1>(__VA_ARGS__);               \
    case 2: return fn<2>(__VA_ARGS__);               \
    case 3: return fn<3>(__VA_ARGS__);               \
    case 4: return fn<4>(__VA_ARGS__);               \
    case 6: return fn<6>(__VA_ARGS__);               \
    default: return fn<8>(__VA_ARGS__);              \
  }

// alphas [B, T, C] (alpha_0 at t = 0) and log_z [B], any C >= 1, one
// launch. `work` is scratch of fwd_work_floats(B, C, in_global) floats
// (crf_plan_query(5, B, T, C, 3) without in_global), or null where that is
// 0 (E in shared memory). in_global: E read from each block's copy in
// scratch even where it fits shared memory (the same bits).
// The bf16 form of the warp kernels (C <= 32) with every tensor operand
// and result of the storage type S.
template <int KC, typename S>
cudaError_t launch_alpha_warp(const ChainPlan& p, const void* x,
                              const void* mask, const void* trans,
                              const void* a, const void* b, float* ework,
                              void* alphas, void* log_z, int B, int T, int C,
                              cudaStream_t s) {
  return launch(crf_alpha_warp_kernel<KC, S>, dim3((B + kWarps - 1) / kWarps),
                kThreads, p.smem, s, static_cast<const S*>(x),
                static_cast<const S*>(mask), static_cast<const S*>(trans),
                static_cast<const S*>(a), static_cast<const S*>(b), ework,
                static_cast<S*>(alphas), static_cast<S*>(log_z), B, T, C);
}

template <int KC, typename S>
cudaError_t launch_bwd_fused(const ChainPlan& p, const void* x,
                             const void* mask, const void* trans,
                             const void* b, const void* alphas,
                             const void* log_z, const void* g, void* dx,
                             float* partial, float* terms, int B, int T,
                             int C, cudaStream_t s) {
  return launch(crf_bwd_fused_kernel<KC, S>, dim3(B), p.threads, p.smem, s,
                static_cast<const S*>(x), static_cast<const S*>(mask),
                static_cast<const S*>(trans), static_cast<const S*>(b),
                static_cast<const S*>(alphas), static_cast<const S*>(log_z),
                static_cast<const S*>(g), static_cast<S*>(dx), partial, terms,
                T, C);
}

template <int KC, typename S>
cudaError_t launch_decode_warp(const ChainPlan& p, const void* x,
                               const void* mask, const void* trans,
                               const void* a, const void* b, int* path,
                               void* score, unsigned char* scratch,
                               size_t stride, int B, int T, int C,
                               cudaStream_t s) {
  const dim3 grid((B + kWarps - 1) / kWarps);
  const S* xs = static_cast<const S*>(x);
  const S* ms = static_cast<const S*>(mask);
  const S* ts = static_cast<const S*>(trans);
  const S* as = static_cast<const S*>(a);
  const S* bs = static_cast<const S*>(b);
  S* sc = static_cast<S*>(score);
  return p.bp_smem ? launch(crf_decode_warp_kernel<KC, true, S>, grid,
                            kThreads, p.smem, s, xs, ms, ts, as, bs, path, sc,
                            scratch, stride, B, T, C)
                   : launch(crf_decode_warp_kernel<KC, false, S>, grid,
                            kThreads, p.smem, s, xs, ms, ts, as, bs, path, sc,
                            scratch, stride, B, T, C);
}

// the warp kernels' class counts: fn<KC, S>(args) for C's
#define CRF_WARP(err, fn, S, ...)                    \
  switch (warp_classes(C)) {                         \
    case 8: err = fn<8, S>(__VA_ARGS__); break;      \
    case 16: err = fn<16, S>(__VA_ARGS__); break;    \
    case 24: err = fn<24, S>(__VA_ARGS__); break;    \
    default: err = fn<32, S>(__VA_ARGS__); break;    \
  }

extern "C" int crf_alpha_fwd(const float* x, const float* mask,
                             const float* trans, const float* a,
                             const float* b, float* work, float* alphas,
                             float* log_z, int B, int T, int C, int in_global,
                             int bf16, void* stream) {
  if (B < 0 || T < 1 || C < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const bool forced = in_global != 0;
  if (work == nullptr && fwd_work_floats(B, C, forced) > 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const ChainPlan p = alpha_plan(C, forced);
  if (bf16 && p.block) return static_cast<int>(cudaErrorInvalidValue);
  float* ework = p.mat_smem ? nullptr : work;
  float* vwork = p.giant ? work + static_cast<size_t>(B) * C * C : nullptr;
  cudaError_t err;
  if (!p.block) {
    if (bf16) {
      CRF_WARP(err, launch_alpha_warp, __nv_bfloat16, p, x, mask, trans, a, b,
               ework, alphas, log_z, B, T, C, s)
    } else {
      CRF_WARP(err, launch_alpha_warp, float, p, x, mask, trans, a, b, ework,
               alphas, log_z, B, T, C, s)
    }
  } else {
    err = launch(crf_alpha_block_kernel, dim3(B), p.threads, p.smem, s, x,
                 mask, trans, a, b, alphas, log_z, ework, vwork, T, C,
                 p.parts, p.mat_smem ? p.ld : 0);
  }
  return static_cast<int>(err);
}

// d(sum_b g_b log Z_b): dx [B, T, C], dtrans [C, C], da [C], db [C], any
// C >= 1, in two launches: C <= 32 the one-launch backward of each
// sequence and the sum over b; above, the beta chain and the marginal
// pass. `work` is scratch of crf_plan_query(0, B, T, C, 3) floats.
extern "C" int crf_bwd(const float* x, const float* mask, const float* trans,
                       const float* b, const float* alphas,
                       const float* log_z, const float* g, float* work,
                       float* dx, float* dtrans, float* da, float* db, int B,
                       int T, int C, int bf16, void* stream) {
  if (B < 0 || T < 1 || C < 1 ||
      (work == nullptr && bwd_work_floats(B, T, C) > 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const ChainPlan p = beta_plan(C);
  if (bf16 && p.block) return static_cast<int>(cudaErrorInvalidValue);
  const size_t Bs = static_cast<size_t>(B), Cs = static_cast<size_t>(C);
  cudaError_t err = cudaSuccess;
  if (!p.block) {  // one launch for the sequences, then their sum over b
    float* partial = work;
    float* terms = partial + Bs * Cs * Cs;
    if (B > 0) {
      if (bf16) {
        CRF_WARP(err, launch_bwd_fused, __nv_bfloat16, p, x, mask, trans, b,
                 alphas, log_z, g, dx, partial, terms, B, T, C, s)
      } else {
        CRF_WARP(err, launch_bwd_fused, float, p, x, mask, trans, b, alphas,
                 log_z, g, dx, partial, terms, B, T, C, s)
      }
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    const int outs = C * C + 2 * C;
    const dim3 grid((outs + kMargThreads - 1) / kMargThreads);
    const float* pc = partial;
    const float* tc = terms;
    if (bf16) {
      using H = __nv_bfloat16;
      err = launch(crf_sum_kernel<H>, grid, kMargThreads, 0, s, pc, tc,
                   reinterpret_cast<H*>(dtrans), reinterpret_cast<H*>(da),
                   reinterpret_cast<H*>(db), B, C);
    } else {
      err = launch(crf_sum_kernel<float>, grid, kMargThreads, 0, s, pc, tc,
                   dtrans, da, db, B, C);
    }
    return static_cast<int>(err);
  }
  const MargPlan m = marg_plan(B, T, C);
  float* betas = work;
  float* terms = betas + Bs * T * Cs;
  float* rest = terms + Bs * 2 * Cs;
  float* ework = nullptr;
  if (!p.mat_smem) {
    ework = rest;
    rest += Bs * Cs * Cs;
  }
  float* vwork = nullptr;
  if (p.giant) {
    vwork = rest;
    rest += Bs * 2 * Cs;
  }
  float* partial = rest;
  int* counters = reinterpret_cast<int*>(partial + m.chunks * Cs * Cs);
  const int tiles = m.tiles_i * m.tiles_j;
  err = launch(crf_beta_block_kernel, dim3(B > 0 ? B : 1), p.threads, p.smem,
               s, x, mask, trans, b, alphas, log_z, g, betas, terms, ework,
               vwork, counters, tiles, B, T, C, p.parts,
               p.mat_smem ? p.ld : 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch(crf_marginal_kernel, dim3(tiles, m.chunks), kMargThreads, 0,
               s, x, mask, trans, alphas, static_cast<const float*>(betas),
               static_cast<const float*>(terms), log_z, g, dx, dtrans, da, db,
               partial, counters, B, T, C, m.ti, m.tj, m.tiles_j,
               m.chunk_len);
  return static_cast<int>(err);
}

// path [B, T] (int32) and score [B], any C >= 1, one launch. `scratch` is
// crf_plan_query(1, B, T, C, 3) bytes (16-byte aligned), or null where
// that is 0 (the back-pointers and vectors in shared memory).
extern "C" int crf_viterbi(const float* x, const float* mask,
                           const float* trans, const float* a, const float* b,
                           unsigned char* scratch, int* path, float* score,
                           int B, int T, int C, int bf16, void* stream) {
  if (B < 0 || T < 1 || C < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const ChainPlan p = viterbi_plan(T, C);
  const size_t stride = viterbi_stride(p, T, C);
  if ((stride != 0 && scratch == nullptr) || (bf16 && p.block))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (!p.block) {
    if (bf16) {
      CRF_WARP(err, launch_decode_warp, __nv_bfloat16, p, x, mask, trans, a,
               b, path, score, scratch, stride, B, T, C, s)
    } else {
      CRF_WARP(err, launch_decode_warp, float, p, x, mask, trans, a, b, path,
               score, scratch, stride, B, T, C, s)
    }
  } else if (p.bp_bytes == 1) {
    err = launch_decode_block<unsigned char>(p, x, mask, trans, a, b, scratch,
                                             stride, path, score, B, T, C, s);
  } else if (p.bp_bytes == 2) {
    err = launch_decode_block<unsigned short>(p, x, mask, trans, a, b,
                                              scratch, stride, path, score, B,
                                              T, C, s);
  } else {
    err = launch_decode_block<int>(p, x, mask, trans, a, b, scratch, stride,
                                   path, score, B, T, C, s);
  }
  return static_cast<int>(err);
}

// The chain floor: one block runs T steps of the beta step (variant 0),
// the Viterbi step (1) or the alpha step (2) at C classes with no global
// memory; out [C] (the Viterbi: [2 C]), what ops/crf.py:chain_floor_plain
// computes.
extern "C" int crf_chain_floor(float* out, int T, int C, int variant,
                               void* stream) {
  const size_t smem = floor_smem(C);
  if (T < 1 || C < 1 || smem > kMaxSmem || variant < 0 || variant > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (C > 32) {
    const ChainPlan p = variant == kViterbi ? viterbi_plan(1, C)
                        : variant == kAlpha ? alpha_plan(C, false)
                                            : beta_plan(C);
    const int nt = p.threads, K = p.parts;
    switch (variant) {
      case kBeta:
        err = launch(crf_floor_block_kernel<kBeta>, dim3(1), nt, smem, s, out,
                     T, C, K);
        break;
      case kViterbi:
        err = launch(crf_floor_block_kernel<kViterbi>, dim3(1), nt, smem, s,
                     out, T, C, K);
        break;
      default:
        err = launch(crf_floor_block_kernel<kAlpha>, dim3(1), nt, smem, s,
                     out, T, C, K);
        break;
    }
  } else {
#define CRF_FLOOR(KC)                                                        \
  (variant == kViterbi                                                       \
       ? launch(crf_floor_warp_kernel<kViterbi, KC>, dim3(1), 32, smem, s,   \
                out, T, C)                                                   \
   : variant == kAlpha                                                       \
       ? launch(crf_floor_warp_kernel<kAlpha, KC>, dim3(1), 32, smem, s,     \
                out, T, C)                                                   \
       : launch(crf_floor_warp_kernel<kBeta, KC>, dim3(1), 32, smem, s, out, \
                T, C))
    switch (warp_classes(C)) {
      case 8: err = CRF_FLOOR(8); break;
      case 16: err = CRF_FLOOR(16); break;
      case 24: err = CRF_FLOOR(24); break;
      default: err = CRF_FLOOR(32); break;
    }
#undef CRF_FLOOR
  }
  return static_cast<int>(err);
}

// ------------------------------------------------- the earlier kernels
// No path calls these; chip_smoke.py times them beside the kernels above.

// The forward a warp a sequence, 8 classes a lane at most: alphas [B, T,
// C] and log_z [B]; C <= 256. `work` is scratch of crf_work_floats(0, C)
// floats, or null (see fwd_p).
extern "C" int crf_alpha_fwd_lanes(const float* x, const float* mask,
                                   const float* trans, const float* a,
                                   const float* b, float* work,
                                   float* alphas, float* log_z, int B, int T,
                                   int C, void* stream) {
  if (bad_shape(B, T, C)) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CRF_DISPATCH(fwd_p, x, mask, trans, a, b, work, alphas, log_z, B, T, C, s)
}

// The backward with the pairwise marginals inside the chain: dx [B, T, C]
// and the per-sequence partials dtrans_part [B, C, C], da_part [B, C],
// db_part [B, C]; C <= 256, `work` as for crf_alpha_fwd_lanes (kernel 1).
extern "C" int crf_bwd_inline(const float* x, const float* mask,
                              const float* trans, const float* b,
                              const float* alphas, const float* log_z,
                              const float* g, float* work, float* dx,
                              float* dtrans_part, float* da_part,
                              float* db_part, int B, int T, int C,
                              void* stream) {
  if (bad_shape(B, T, C)) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CRF_DISPATCH(bwd_p, x, mask, trans, b, alphas, log_z, g, work, dx,
               dtrans_part, da_part, db_part, B, T, C, s)
}

// The Viterbi with its back-pointers in ptr [B, T, C] (int32 scratch);
// C <= 256.
extern "C" int crf_viterbi_scratch(const float* x, const float* mask,
                                   const float* trans, const float* a,
                                   const float* b, int* ptr, int* path,
                                   float* score, int B, int T, int C,
                                   void* stream) {
  if (bad_shape(B, T, C)) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CRF_DISPATCH(viterbi_p, x, mask, trans, a, b, ptr, path, score, B, T, C, s)
}

// Masked peephole-LSTM sequence recurrence, f32, for Hopper (sm_90a):
// the forward in its primal and its residual (training) form, and the
// backward's per-step gate-gradient chain. The persistent route also has
// a bf16 form on the tensor cores (see "bf16" below and the last section).
//
// Forward. Replaces the TPU kernels paddle_tpu/ops/lstm.py:_lstm_kernel
// (the recurrent weight resident in VMEM, h <= 512) and _lstm_kernel_tiled
// (the weight streamed in gate-column blocks, h = 1280), both forms. It
// computes lstm_sequence_ref (ops/lstm.py:45-68) with the gate bias
// already folded into xs:
//
//   gates = xs_t + h_{t-1} @ W            gate order [in, ig, fg, og]
//   i  = tanh(a_in)
//   ig = sigmoid(a_ig + c_{t-1} * pI)     fg = sigmoid(a_fg + c_{t-1} * pF)
//   c  = i * ig + c_{t-1} * fg
//   og = sigmoid(a_og + c * pO)           h  = og * tanh(c)
//   mask == 0: h and c hold, ys = h_new * mask
//
// The primal form writes ys and the final h, c. The residual form also
// writes, per step, the guarded hs[t] and cs[t] and the activated gates[t]
// = [i | ig | fg | og] (gate-major, each block H wide), the residuals of
// _fwd_rule (ops/lstm.py:331-335). hs doubles as the h buffer: h_{t-1} is
// hs[t-1] (h0 at t = 0), and cs likewise for c.
//
// Two routes, chosen by shape (ops/lstm.py:lstm_route mirrors the
// arithmetic of lstm_smem below), never by failure:
//
// 1. Persistent (lstm_seq_forward_persistent, lstm_bwd_chain_launch): one
//    cooperative launch per sequence and one per reverse chain, at most
//    one block per SM, 256 threads. Block p owns the U units [p U, p U +
//    U), U the fewest of 1, 2, 4, 10 (the instantiated kernels) whose
//    chain grid fits the card: at H = 1280, U = 10 and 128 blocks. The
//    cell is local to a unit once its four gate sums are in, so a step
//    needs one exchange: h_t forward, dgates_t backward. Each block holds
//    a slice of W in shared memory for the whole launch (4 U H floats,
//    rows padded to an odd number of float4s: 205,440 bytes at H = 1280).
//    Both products give each lane a tile of rows x U columns, rows rg + 8 i
//    and columns cg + 4 j of its warp's (rg = lane / 4, cg = lane % 4):
//    float4 loads without bank conflicts, f32 FMAs in a fixed order.
//    Forward step (lstm_persistent_kernel): the block's four gate columns
//    of its units; the product h_{t-1} @ W[:, own columns] ([B][4U]), K
//    split over 8 / mw warps, each staging its slice of h through its own
//    ring of 2-float4 slots (cp.async.cg, two slots ahead, no block-wide
//    wait); the slices' tree through shared memory; every thread finishes
//    up to 4 cells (b, u), h and c in registers (the spelling of
//    lstm_step_kernel, the mask guard, ys, h_t into hs or the primal's own
//    [T, B, H] buffer); one grid barrier (persistent.cuh).
//    Reverse step (lstm_bwd_chain_kernel): the G = 16 R blocks form R row
//    groups by 16 column groups; block p = 16 r + c holds W[the 16 U units
//    of row group r, the gate columns of the R U units of column group c].
//    It waits for the R blocks of its column group (a counter each), stages
//    their dgates_{t+1} [B][4U] through L2 and sums its partial [B][16 U];
//    waits for the 16 blocks of its row group; each own pair (b, u) takes
//    dh_in = carry + its 16 partials in c order; the elementwise chain of
//    lstm_bwd_step_kernel; dgates_t into dxs[t] and the blocks' exchange
//    buffer. At (64, 1280) that moves 21 MB a step through L2 (10.5 MB of
//    dgates read, 5.2 MB of partials written and read) where a layout of
//    whole columns (every block a partial of all H units, one barrier)
//    moves 84 MB and one of whole rows (every block all of dgates) 168 MB;
//    both were measured and were slower on the card (PERF.md). No atomics
//    but the counters: two runs give the same bits.
//    The route line: at most 64 rows, H % 4 == 0, U one of 1, 2, 4, 10
//    with the chain's grid on the card, both blocks within 232,448 bytes:
//    on 132 SMs the largest H is 1280 at B = 1, 16 and 64 (at 1284 the
//    chain needs a ninth row group, 144 blocks).
//    Measured and not kept (PERF.md): the forward's product as 3xTF32
//    mma.sync (slower, and over the 1e-5 value tolerance); K split over
//    the lanes of a tile; 16 warps a block; the operands of the next
//    float4 loaded ahead in registers; h staged through L1 or through
//    registers four slots ahead; in the forward, 8-row tiles with every
//    warp on all rows (their staging cost more than their FMAs saved).
//
// 2. Per-step (lstm_seq_forward, lstm_seq_forward_train, lstm_bwd_step):
//    one launch per timestep. A block owns a tile of kRows batch rows by
//    kUnits hidden units, that is the four gate columns of each of its
//    units, so the cell update is local to the block. Each step streams
//    h_{t-1}[rows, :] and the block's W columns through shared memory in
//    chunks of kK and sums the [kRows, 4 * kUnits] gate pre-activations in
//    f32 registers (each thread: kRowsPerThread rows of one unit, all four
//    gates), then applies the cell and writes h_t, c_t and ys[t] (and the
//    residuals). The step boundary is the launch. Its backward is
//    lstm_bwd_step_kernel, the per-step elementwise chain of the JAX
//    backward (_bwd_rule, ops/lstm.py:358-396, a reverse-time lax.scan, not
//    a Pallas kernel), one launch per step; the products dgates_t @ W^T
//    between steps stay torch.matmul in the wrapper, as JAX leaves them to
//    XLA. That step is bound by bytes: per element of [B, H] it reads 10
//    and writes 6 floats, against ~40 operations.
//
// bf16 (--compute_dtype bfloat16). The reference's Pallas kernels cannot
// run in bf16 with an f32 mask (their h_new * m is f32, stored into a
// bf16 ref), so what the JAX package computes is its scan
// lstm_sequence_ref under jax.vjp, every operation rounded to bf16: the
// recurrent product once after its f32 sum; x_t + product, then + bias
// (not folded into xs: the reference adds it third); each gate's and the
// cell's operations (sigmoid as 1 / (1 + exp(-x)), three roundings); ys =
// og * tanh(c) * mask in f32, unrounded as the reference's f32 output is;
// h and c carried as bf16 values. Its backward rounds dy as it meets
// h_new, the product, dh_in = carry + product, dgates and the dc carry.
// Every operand of the recurrent products is then a bf16 value, so the
// bf16 forms (lstm_bf16_kernel, lstm_bf16_chain_kernel, last section)
// keep the same persistent layouts (units, grids, row and column groups,
// barriers and counters) and run the products as mma.sync m16n8k16 with
// bf16 operands and f32 sums: W's slice resident in shared memory as bf16
// (rows padded by 16 bytes: ldmatrix reads 8 rows in 8 bank groups), h_t
// and dgates crossing blocks as bf16, staged by cp.async. dW stays one
// product after the chain (bf16 operands, f32 accumulation, rounded once),
// where the reference accumulates it in bf16 step by step.
//
// Bound on the H100 (SXM, 700 W): the recurrent product is
// 2 * B * H * 4H operations per step, at the f32 rate outside the tensor
// cores (67 TFLOP/s), forward and backward alike; the bytes are xs and ys
// once (and the residuals once), plus W once. At (64, 1280, 100) that is
// 1.25 ms of operations for a sequence or a chain. What the persistent
// kernels pay above it (PERF.md): the FMA loops run below the f32 rate
// (a warp's float4 load takes 4 shared-memory cycles however many lanes
// share its address), every SM pulls all of h_{t-1} from L2 each forward
// step, and the chain's two waits and exchanges a step. dW and the peephole gradients stay one product and three sums
// after the chain, in the wrapper.

#include <cuda_runtime.h>

#include <cstddef>

#include "persistent.cuh"

namespace {

constexpr int kRows = 32;           // batch rows per block
constexpr int kUnits = 32;          // hidden units per block
constexpr int kK = 32;              // depth of one shared-memory chunk
constexpr int kRowsPerThread = 4;
constexpr int kThreads = kUnits * (kRows / kRowsPerThread);  // 256
constexpr int kBwdThreads = 256;

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// c_prev and c_next alias in the primal form (c updated in place, each
// element by the one thread that owns it), so they are not __restrict__.
template <bool kResiduals>
__global__ void __launch_bounds__(kThreads)
lstm_step_kernel(const float* __restrict__ xs_t,    // [B, 4H], bias folded
                 const float* __restrict__ mask_t,  // [B]
                 const float* __restrict__ w,       // [H, 4H]
                 const float* __restrict__ p_i,     // [H]
                 const float* __restrict__ p_f,     // [H]
                 const float* __restrict__ p_o,     // [H]
                 const float* __restrict__ h_prev,  // [B, H]
                 float* __restrict__ h_next,        // [B, H]
                 const float* c_prev,               // [B, H]
                 float* c_next,                     // [B, H]
                 float* __restrict__ ys_t,          // [B, H]
                 float* __restrict__ gates_t,       // [B, 4H] (residuals)
                 int B, int H) {
  __shared__ float hs[kRows][kK + 1];
  __shared__ float ws[kK][4 * kUnits];

  const int tx = threadIdx.x % kUnits;  // unit within the block
  const int ty = threadIdx.x / kUnits;  // row group; one warp per group
  const int j0 = blockIdx.x * kUnits;
  const int b0 = blockIdx.y * kRows;
  const size_t H4 = 4 * static_cast<size_t>(H);

  float acc[kRowsPerThread][4];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
#pragma unroll
    for (int g = 0; g < 4; ++g) acc[r][g] = 0.0f;
  }

  for (int k0 = 0; k0 < H; k0 += kK) {
    for (int i = threadIdx.x; i < kRows * kK; i += kThreads) {
      const int r = i / kK, k = i % kK;
      const int b = b0 + r, kk = k0 + k;
      hs[r][k] = (b < B && kk < H) ? h_prev[static_cast<size_t>(b) * H + kk]
                                   : 0.0f;
    }
    for (int i = threadIdx.x; i < kK * 4 * kUnits; i += kThreads) {
      const int k = i / (4 * kUnits), col = i % (4 * kUnits);
      const int g = col / kUnits, u = col % kUnits;
      const int kk = k0 + k, j = j0 + u;
      ws[k][col] = (kk < H && j < H)
                       ? w[static_cast<size_t>(kk) * H4 +
                           static_cast<size_t>(g) * H + j]
                       : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kK; ++k) {
      float wv[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) wv[g] = ws[k][g * kUnits + tx];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        const float hv = hs[ty * kRowsPerThread + r][k];
#pragma unroll
        for (int g = 0; g < 4; ++g) acc[r][g] = fmaf(hv, wv[g], acc[r][g]);
      }
    }
    __syncthreads();
  }

  const int j = j0 + tx;
  if (j >= H) return;
  const float pi = p_i[j], pf = p_f[j], po = p_o[j];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int b = b0 + ty * kRowsPerThread + r;
    if (b >= B) break;
    const float* x = xs_t + static_cast<size_t>(b) * H4;
    const size_t o = static_cast<size_t>(b) * H + j;
    const float cp = c_prev[o];
    const float in = tanhf(x[j] + acc[r][0]);
    const float ig = sigmoid_f(x[H + j] + acc[r][1] + cp * pi);
    const float fg = sigmoid_f(x[2 * H + j] + acc[r][2] + cp * pf);
    const float c_new = in * ig + cp * fg;
    const float og = sigmoid_f(x[3 * H + j] + acc[r][3] + c_new * po);
    const float h_new = og * tanhf(c_new);
    const float m = mask_t[b];
    const bool live = m > 0.0f;
    h_next[o] = live ? h_new : h_prev[o];
    c_next[o] = live ? c_new : cp;
    ys_t[o] = h_new * m;
    if (kResiduals) {
      float* gr = gates_t + static_cast<size_t>(b) * H4;
      gr[j] = in;
      gr[H + j] = ig;
      gr[2 * H + j] = fg;
      gr[3 * H + j] = og;
    }
  }
}

// One reverse step of _bwd_rule (ops/lstm.py:366-389), elementwise over
// [B, H]. On entry dh holds (1 - m_{t+1}) * dh_{t+1} and dhw holds
// dgates_{t+1} @ W^T (zero at t = T - 1, where dh holds dhT); their sum
// is the carry dh of step t. On return dh holds (1 - m_t) * dh and dc the
// carry dc_prev; dgates_t = [da_i | da_ig | da_fg | da_og]. dh and dc are
// updated in place, each element by the thread that owns it.
__global__ void __launch_bounds__(kBwdThreads)
lstm_bwd_step_kernel(const float* __restrict__ dy_t,     // [B, H]
                     const float* __restrict__ mask_t,   // [B]
                     const float* __restrict__ gates_t,  // [B, 4H] activated
                     const float* __restrict__ c_new_t,  // [B, H] = cs[t]
                     const float* __restrict__ c_prev_t, // [B, H]
                     const float* __restrict__ p_i,      // [H]
                     const float* __restrict__ p_f,      // [H]
                     const float* __restrict__ p_o,      // [H]
                     const float* __restrict__ dhw,      // [B, H]
                     float* dh,                          // [B, H], in/out
                     float* dc,                          // [B, H], in/out
                     float* __restrict__ dgates_t,       // [B, 4H]
                     int B, int H) {
  const size_t n = static_cast<size_t>(B) * H;
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < n; e += stride) {
    const size_t b = e / H;
    const int j = static_cast<int>(e % H);
    const size_t row = b * 4 * static_cast<size_t>(H);
    const float m = mask_t[b];
    const float i = gates_t[row + j];
    const float ig = gates_t[row + H + j];
    const float fg = gates_t[row + 2 * H + j];
    const float og = gates_t[row + 3 * H + j];
    const float c_new = c_new_t[e];
    const float c_pv = c_prev_t[e];
    const float dh_in = dh[e] + dhw[e];
    const float dc_in = dc[e];
    const float dh_new = m * (dh_in + dy_t[e]);
    const float dc_new = m * dc_in;
    const float tc = tanhf(c_new);
    const float da_og = ((dh_new * tc) * og) * (1.0f - og);
    const float dc_tot =
        (dc_new + (dh_new * og) * (1.0f - tc * tc)) + da_og * p_o[j];
    const float da_i = (dc_tot * ig) * (1.0f - i * i);
    const float da_ig = ((dc_tot * i) * ig) * (1.0f - ig);
    const float da_fg = ((dc_tot * c_pv) * fg) * (1.0f - fg);
    dc[e] = (((1.0f - m) * dc_in + dc_tot * fg) + da_ig * p_i[j]) +
            da_fg * p_f[j];
    dh[e] = (1.0f - m) * dh_in;
    dgates_t[row + j] = da_i;
    dgates_t[row + H + j] = da_ig;
    dgates_t[row + 2 * H + j] = da_fg;
    dgates_t[row + 3 * H + j] = da_og;
  }
}

}  // namespace

// Runs T steps. h is [2, B, H] with h[0] = h0 on entry; after the call
// h[T % 2] holds hT. c is [B, H], c0 on entry and cT on return. Returns
// the first launch error (cudaError_t as int), 0 when every launch was
// accepted. Launches on `stream`, allocates nothing, does not synchronise.
extern "C" int lstm_seq_forward(const float* xs, const float* mask,
                                const float* w, const float* p_i,
                                const float* p_f, const float* p_o, float* h,
                                float* c, float* ys, int T, int B, int H,
                                void* stream) {
  const dim3 grid((H + kUnits - 1) / kUnits, (B + kRows - 1) / kRows);
  const size_t bh = static_cast<size_t>(B) * H;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int t = 0; t < T; ++t) {
    lstm_step_kernel<false><<<grid, kThreads, 0, s>>>(
        xs + static_cast<size_t>(t) * 4 * bh,
        mask + static_cast<size_t>(t) * B, w, p_i, p_f, p_o,
        h + (t & 1) * bh, h + ((t + 1) & 1) * bh, c, c,
        ys + static_cast<size_t>(t) * bh, nullptr, B, H);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// The residual form: T steps from h0, c0 ([B, H]), writing ys, hs, cs
// ([T, B, H]) and the activated gates ([T, B, 4H]). hT = hs[T-1] and
// cT = cs[T-1]. Same launch and error contract as lstm_seq_forward.
extern "C" int lstm_seq_forward_train(const float* xs, const float* mask,
                                      const float* w, const float* p_i,
                                      const float* p_f, const float* p_o,
                                      const float* h0, const float* c0,
                                      float* ys, float* hs, float* cs,
                                      float* gates, int T, int B, int H,
                                      void* stream) {
  const dim3 grid((H + kUnits - 1) / kUnits, (B + kRows - 1) / kRows);
  const size_t bh = static_cast<size_t>(B) * H;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int t = 0; t < T; ++t) {
    const size_t o = static_cast<size_t>(t) * bh;
    lstm_step_kernel<true><<<grid, kThreads, 0, s>>>(
        xs + 4 * o, mask + static_cast<size_t>(t) * B, w, p_i, p_f, p_o,
        t ? hs + o - bh : h0, hs + o, t ? cs + o - bh : c0, cs + o, ys + o,
        gates + 4 * o, B, H);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// One backward step over [B, H] (see lstm_bwd_step_kernel). Same launch
// and error contract as lstm_seq_forward.
extern "C" int lstm_bwd_step(const float* dy_t, const float* mask_t,
                             const float* gates_t, const float* c_new_t,
                             const float* c_prev_t, const float* p_i,
                             const float* p_f, const float* p_o,
                             const float* dhw, float* dh, float* dc,
                             float* dgates_t, int B, int H, void* stream) {
  const size_t n = static_cast<size_t>(B) * H;
  size_t blocks = (n + kBwdThreads - 1) / kBwdThreads;
  if (blocks > 65535) blocks = 65535;  // grid-stride covers the rest
  if (blocks == 0) return 0;
  lstm_bwd_step_kernel<<<static_cast<unsigned>(blocks), kBwdThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      dy_t, mask_t, gates_t, c_new_t, c_prev_t, p_i, p_f, p_o, dhw, dh, dc,
      dgates_t, B, H);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------
// The persistent route: one cooperative launch per sequence or chain.

namespace {

constexpr int kFwd = 0, kBwd = 1;  // lstm_smem kinds
constexpr int kPairs = 4;          // (b, u) cells or pairs of a thread
constexpr int kGroupCols = 16;     // C: the blocks of a chain row group
constexpr int kWarps = kPThreads / 32;
constexpr int kSlots = 3;          // a forward warp's staging ring

// Row stride (floats) of a shared-memory matrix over K columns: an odd
// number of float4s, so that neighbouring rows lie in different banks.
__host__ __device__ inline int padded_ld(int K) { return 4 * ((K / 4) | 1); }

// The rows a lane holds in a product: lane l of a warp holds the rows
// rg + 8 i, i < lane_rows(B) (rg = l / 4), so that one warp covers all B
// rows (padded to 8 lane_rows(B)).
__host__ __device__ inline int lane_rows(int B) {
  return B <= 8 ? 1 : B <= 16 ? 2 : B <= 32 ? 4 : 8;
}

// The forward's rows: lane l holds the rpl rows rg + 8 i of its warp's
// 8 rpl, and mw warps of each K slice take successive row blocks; the
// other 8 / mw warps split K.
struct Rows {
  int rpl, mw;
};

__host__ __device__ inline Rows fwd_rows(int B) {
  return B <= 8 ? Rows{1, 1} : B <= 16 ? Rows{2, 1}
                             : B <= 32 ? Rows{4, 1} : Rows{4, 2};
}

// Rows of a lane handed over in one round through shared memory: half of
// them where it has more than one.
__host__ __device__ inline int half_rows(int rpl) {
  return rpl > 1 ? rpl / 2 : 1;
}

// The chain's grid: the ceil(H / U) unit slices rounded up to whole row
// groups of kGroupCols blocks (the last blocks may own no unit).
__host__ __device__ inline int chain_grid(int H, int U) {
  const int g = (H + U - 1) / U;
  return (g + kGroupCols - 1) / kGroupCols * kGroupCols;
}

// The chain's staging buffers: all R column-group chunks at once where
// they fit beside the weights, else two.
__host__ __device__ inline int chain_bufs(int B, int H, int U) {
  const int R = chain_grid(H, U) / kGroupCols;
  const long long w = 1LL * kGroupCols * U * padded_ld(4 * U * R);
  const long long chunk = 8LL * lane_rows(B) * padded_ld(4 * U);
  return 4 * (w + R * chunk) <= kSmemLimit ? R : 2;
}

// Shared-memory bytes of a persistent block. Forward: the 4 U resident
// weight rows (H wide, padded) and the 8 warps' staging rings of h
// (kSlots slots of [rows][8]), which then hold the K slices' sums on
// their way to warp 0 (at most 4 warps x 32 lanes x rpl U a round) and
// the cells' sums [rows][U][4]. Chain: the row group's 16 U weight rows
// over the column group's 4 U R columns and the staging of its dgates
// (chain_bufs chunks of [rows][4 U]), which then hold the K halves' sums
// and pass the partial out half of the rows [8 half][16 U + 4] at a time.
// Carries and own inputs live in registers.
__host__ __device__ inline long long lstm_smem(int B, int H, int U,
                                               int kind) {
  if (kind == kFwd) {
    const Rows rw = fwd_rows(B);
    const long long stage = 1LL * kWarps * kSlots * 8 * rw.rpl * 8;
    const long long sums =
        max(128LL * rw.rpl * U, 32LL * rw.rpl * rw.mw * U);
    return 4 * (4LL * U * padded_ld(H) + max(stage, sums));
  }
  const int rpl = lane_rows(B), rows = 8 * rpl;
  const int R = chain_grid(H, U) / kGroupCols;
  return 4 * (1LL * kGroupCols * U * padded_ld(4 * U * R) +
              max(max(1LL * chain_bufs(B, H, U) * rows * padded_ld(4 * U),
                      4LL * 32 * half_rows(rpl) * U),
                  8LL * half_rows(rpl) * (kGroupCols * U + 4)));
}

// A lane's tile over one float4 of K: rows 8 i of a (row stride lda) and
// rows 4 j of wt (stride ldw); in every lane of a warp the same K, 8 rows
// of a (rg) and 4 rows of wt (cg): conflict-free float4 loads. A warp's
// float4 load takes 4 shared-memory cycles however many lanes share an
// address: 4 RPL CPL FMAs for RPL + CPL loads.
template <int RPL, int CPL>
struct Operands {
  float4 a[RPL], w[CPL];

  __device__ __forceinline__ void load(const float* pa, int lda,
                                       const float* pw, int ldw) {
#pragma unroll
    for (int j = 0; j < CPL; ++j)
      w[j] = *reinterpret_cast<const float4*>(pw + 4 * j * ldw);
#pragma unroll
    for (int i = 0; i < RPL; ++i)
      a[i] = *reinterpret_cast<const float4*>(pa + 8 * i * lda);
  }

  // acc[i][j] += a[i] . w[j], the 4 terms in K order
  __device__ __forceinline__ void fma(float (&acc)[RPL][CPL]) const {
#pragma unroll
    for (int i = 0; i < RPL; ++i) {
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        float v = acc[i][j];
        v = fmaf(a[i].x, w[j].x, v);
        v = fmaf(a[i].y, w[j].y, v);
        v = fmaf(a[i].z, w[j].z, v);
        v = fmaf(a[i].w, w[j].w, v);
        acc[i][j] = v;
      }
    }
  }
};

// Hands the accumulators of the threads with `give` to those with `take`
// (which add them) through buf, G of a lane's rows a round: slot `slot`
// of the giving warp and of the taking one must match. Every thread of
// the block calls it.
template <int RPL, int CPL, int G>
__device__ __forceinline__ void hand_over(float (&acc)[RPL][CPL], bool give,
                                          bool take, int slot, float* buf) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int i0 = 0; i0 < RPL; i0 += G) {
    if (give) {
      float* o = buf + slot * G * CPL * 32 + lane;
#pragma unroll
      for (int i = 0; i < G; ++i) {
#pragma unroll
        for (int j = 0; j < CPL; ++j) o[(i * CPL + j) * 32] = acc[i0 + i][j];
      }
    }
    __syncthreads();
    if (take) {
      const float* s = buf + slot * G * CPL * 32 + lane;
#pragma unroll
      for (int i = 0; i < G; ++i) {
#pragma unroll
        for (int j = 0; j < CPL; ++j) acc[i0 + i][j] += s[(i * CPL + j) * 32];
      }
    }
    __syncthreads();
  }
}

// The forward sequence, one launch. Block p owns the units [u0, u0 + up)
// (up <= U) and holds W[:, g H + u0 + u] as the shared row 4 u + g. The
// product's [rows][4 U] gate sums: warp (mi, kw) of mw x KW (KW = 8 / mw)
// sums its K slice of h, the float4 columns [q0, q1), for the rows of
// row block mi; its lane (rg, cg) holds rows rg + 8 i and columns cg + 4 j,
// that is gate cg of unit j. Each warp stages its slice through its own
// ring of kSlots slots (2 float4 columns of its rows, cp.async through
// L2: h_{t-1} was written by other SMs), two slots ahead, with no
// block-wide wait. The slices meet in a tree through shared memory (kw +
// d into kw, d = KW / 2, ..., 1: a fixed order); warp kw = 0 of each row
// block writes the sums [b][u][4]; then every thread finishes the cells
// (b, u) = c / up, c % up of c = thread, thread + 256, ..., carrying their
// h and c in registers, and writes ys, h_t into hbuf[t] (hs in the
// residual form), and in the residual form cs and gates; in the primal
// form cT goes to c_out.
template <bool kResidual, int RPL, int U>
__global__ void __launch_bounds__(kPThreads, 1) lstm_persistent_kernel(
    const float* __restrict__ xs,    // [T, B, 4H], bias folded
    const float* __restrict__ mask,  // [T, B]
    const float* __restrict__ w,     // [H, 4H], leading dim ldw
    const float* __restrict__ p_i, const float* __restrict__ p_f,
    const float* __restrict__ p_o,   // [H] each
    const float* __restrict__ h0, const float* __restrict__ c0,  // [B, H]
    float* hbuf, float* __restrict__ c_out, float* __restrict__ ys,
    float* __restrict__ cs, float* __restrict__ gates, unsigned* count,
    int ldw, int T, int B, int H) {
  extern __shared__ float4 smem4[];
  const int lw = padded_ld(H);
  float* const ws = reinterpret_cast<float*>(smem4);  // [4U][lw]
  float* const stage = ws + 4 * U * lw;  // the buffers; then sums
  const int u0 = blockIdx.x * U;
  const int up = min(U, H - u0);
  const size_t bh = static_cast<size_t>(B) * H;
  const size_t H4 = 4 * static_cast<size_t>(H);
  for (int i = threadIdx.x; i < 4 * up * H; i += kPThreads) {
    const int k = i / (4 * up), n = i % (4 * up);
    const int g = n / up, u = n % up;
    cp_async4(ws + (4 * u + g) * lw + k,
              w + static_cast<size_t>(k) * ldw + g * H + u0 + u);
  }
  cp_async_commit();
  const int mw = fwd_rows(B).mw, KW = kWarps / mw;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kw = warp % KW, mi = warp / KW;
  const int rg = lane / 4, cg = lane % 4;
  // the warp's K slice of float4s [q0, q1) in slots of 2; its ring
  // [kSlots][rows_w][8] holds float4 hh of row rr at 4 (hh ^ bit 2 of rr),
  // so that the 8 rows a load reads lie in 8 different banks
  const int rows_w = 8 * RPL, nq = H / 4;
  const int qpw = ((nq + KW - 1) / KW + 1) / 2 * 2;
  const int q0 = min(nq, kw * qpw), q1 = min(nq, q0 + qpw);
  const int nsl = (q1 - q0 + 1) / 2;
  const int first = nsl > 0 ? blockIdx.x % nsl : 0;
  const int sw = (rg >> 2) & 1;
  float* const ring = stage + warp * kSlots * rows_w * 8;
  // the thread's cells
  bool mine[kPairs];
  int cb[kPairs], cu[kPairs];
  float hc[kPairs], cc[kPairs], pi[kPairs], pf[kPairs], po[kPairs],
      x[kPairs][4], m[kPairs];
#pragma unroll
  for (int e = 0; e < kPairs; ++e) {
    const int c = threadIdx.x + e * kPThreads;
    cb[e] = c / up;
    cu[e] = c % up;
    mine[e] = cb[e] < B;
    if (mine[e]) {
      const int j = u0 + cu[e];
      hc[e] = h0[cb[e] * H + j];
      cc[e] = c0[cb[e] * H + j];
      pi[e] = p_i[j];
      pf[e] = p_f[j];
      po[e] = p_o[j];
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  unsigned arrivals = 0;
  for (int t = 0; t < T; ++t) {
    // this step's inputs of the thread's cells, loaded into registers
    // ahead of the product (read-only: through L1)
#pragma unroll
    for (int e = 0; e < kPairs; ++e) {
      if (mine[e]) {
        const float* xr = xs + (static_cast<size_t>(t) * B + cb[e]) * H4 +
                          u0 + cu[e];
#pragma unroll
        for (int g = 0; g < 4; ++g) x[e][g] = xr[g * H];
        m[e] = mask[static_cast<size_t>(t) * B + cb[e]];
      }
    }
    const float* h_prev = t ? hbuf + (t - 1) * bh : h0;
    float acc[RPL][U];
#pragma unroll
    for (int i = 0; i < RPL; ++i) {
#pragma unroll
      for (int j = 0; j < U; ++j) acc[i][j] = 0.0f;
    }
    if (nsl > 0) {
      // slot i: float4s q, q + 1 (q = q0 + 2 ((first + i) % nsl)) of the
      // warp's rows; block p starts at slot p % nsl, so that the blocks
      // read different lines of L2 at a time
      auto issue = [&](int i) {
        const int q = q0 + 2 * ((first + i) % nsl);
        float* dst = ring + (i % kSlots) * rows_w * 8;
        for (int c = lane; c < 2 * rows_w; c += 32) {
          const int rr = c / 2, hh = c % 2, b = mi * rows_w + rr;
          if (b < B && q + hh < q1)
            cp_async16(dst + rr * 8 + 4 * (hh ^ ((rr >> 2) & 1)),
                       h_prev + static_cast<size_t>(b) * H + 4 * (q + hh));
        }
      };
      issue(0);
      cp_async_commit();
      if (nsl > 1) issue(1);
      cp_async_commit();
      for (int i = 0; i < nsl; ++i) {
        if (i + 2 < nsl) issue(i + 2);
        cp_async_commit();
        cp_async_wait<kSlots - 1>();
        __syncwarp();
        const int q = q0 + 2 * ((first + i) % nsl);
        const float* a = ring + (i % kSlots) * rows_w * 8 + rg * 8;
        const float* wt = ws + cg * lw + 4 * q;
        Operands<RPL, U> op;
        op.load(a + 4 * sw, 8, wt, lw);
        op.fma(acc);
        if (q + 1 < q1) {
          op.load(a + 4 * (1 - sw), 8, wt + 4, lw);
          op.fma(acc);
        }
        __syncwarp();
      }
    }
    __syncthreads();
    // the slices' tree, in a fixed order: warps kw in [d, 2d) hand their
    // sums to kw - d
    for (int d = KW / 2; d >= 1; d /= 2)
      hand_over<RPL, U, RPL>(acc, kw >= d && kw < 2 * d, kw < d,
                             mi * d + kw % d, stage);
    if (kw == 0) {
#pragma unroll
      for (int i = 0; i < RPL; ++i) {
#pragma unroll
        for (int j = 0; j < U; ++j)
          stage[((mi * 8 * RPL + rg + 8 * i) * U + j) * 4 + cg] = acc[i][j];
      }
    }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < kPairs; ++e) {
      if (!mine[e]) continue;
      const int b = cb[e], j = u0 + cu[e];
      const float4 a =
          *reinterpret_cast<const float4*>(stage + (b * U + cu[e]) * 4);
      const size_t o = static_cast<size_t>(t) * bh +
                       static_cast<size_t>(b) * H + j;
      const float cp = cc[e];
      const float in = tanhf(x[e][0] + a.x);
      const float ig = sigmoid_f(x[e][1] + a.y + cp * pi[e]);
      const float fg = sigmoid_f(x[e][2] + a.z + cp * pf[e]);
      const float c_new = in * ig + cp * fg;
      const float og = sigmoid_f(x[e][3] + a.w + c_new * po[e]);
      const float h_new = og * tanhf(c_new);
      const bool live = m[e] > 0.0f;
      const float hn = live ? h_new : hc[e];
      const float cn = live ? c_new : cp;
      ys[o] = h_new * m[e];
      hbuf[o] = hn;
      if (kResidual) {
        cs[o] = cn;
        float* gr = gates + (static_cast<size_t>(t) * B + b) * H4 + j;
        gr[0] = in;
        gr[H] = ig;
        gr[2 * H] = fg;
        gr[3 * H] = og;
      }
      hc[e] = hn;
      cc[e] = cn;
    }
    if (t + 1 < T) {
      arrivals += gridDim.x;
      grid_barrier(count, arrivals);
    } else {
      __syncthreads();
    }
  }
  if (!kResidual) {
#pragma unroll
    for (int e = 0; e < kPairs; ++e) {
      if (mine[e]) c_out[cb[e] * H + u0 + cu[e]] = cc[e];
    }
  }
}

// The backward's reverse chain, one launch: dxs [T, B, 4H], dh0 and dc0
// from the residuals (gates, cs), c0 and the cotangents dys, dhT, dcT.
// Block p = r C + c (C = kGroupCols, R = G / C row groups) owns the units
// [u0, u0 + up) = [p U, p U + U) (none past H) and carries their dh and
// dc in registers, four (b, u) pairs a thread. It holds the product's
// block of W: the rows of its row group's units [r C U, (r + 1) C U) over
// the gate columns of its column group's units (those of blocks s C + c,
// s < R), shared row n, column s 4U + g U + u = W[r C U + n, g H + (s C +
// c) U + u]. Reverse step t:
//   1. (t < T - 1) wait for the column group's dgates_{t+1} (dgs, [G][B]
//      [4U] per half); stage them through L2 a block's [B][4U] at a time
//      and sum the partial dgates_{t+1}[:, its columns] @ W[its rows, its
//      columns]^T, [B][C U]: warp (kw, nw) of 2 x 4 takes the columns nw
//      4U + cg + 4 j and the float4s of each chunk's first (kw = 0) or
//      second half, for all the rows; the halves meet in shared memory;
//      the partial goes to part (per half [G][B][C U]) in whole float4s;
//      the row group's counter;
//   2. (t < T - 1) dh_in of the own pairs = carry + the C partials of
//      the row group at their units, added in c order;
//   3. the elementwise chain of lstm_bwd_step_kernel for the own pairs:
//      dgates_t into dxs[t] and dgs; the column group's counter.
// After t = 0 steps 1-2 once more give dh0. One counter per row group and
// per column group, each only growing: a block waits only for the blocks
// whose output it reads; halves alternate by the parity of t, so that no
// block overwrites a buffer another may still read.
template <int RPL, int U>
__global__ void __launch_bounds__(kPThreads, 1) lstm_bwd_chain_kernel(
    const float* __restrict__ dys,    // [T, B, H]
    const float* __restrict__ mask,   // [T, B]
    const float* __restrict__ gates,  // [T, B, 4H] activated
    const float* __restrict__ cs,     // [T, B, H]
    const float* __restrict__ c0,     // [B, H]
    const float* __restrict__ w,      // [H, 4H], leading dim ldw
    const float* __restrict__ p_i, const float* __restrict__ p_f,
    const float* __restrict__ p_o,    // [H] each
    const float* __restrict__ dhT, const float* __restrict__ dcT,  // [B, H]
    float* dxs, float* dgs, float* part, float* __restrict__ dh0,
    float* __restrict__ dc0, unsigned* count, int ldw, int T, int B,
    int H) {
  constexpr int C = kGroupCols, N = C * U, G2 = RPL > 1 ? RPL / 2 : 1;
  extern __shared__ float4 smem4[];
  float* const ws = reinterpret_cast<float*>(smem4);  // [N][lk]
  const int G = gridDim.x, R = G / C;
  const int p = blockIdx.x, r = p / C, c = p % C;
  const int u0 = p * U, up = min(U, H - u0);  // up <= 0: no units
  const int K = 4 * U * R, lk = padded_ld(K), la = padded_ld(4 * U);
  const int rows = 8 * RPL;
  const int nbuf = chain_bufs(B, H, U);
  float* const ring = ws + N * lk;  // [nbuf][rows][la]
  const size_t bh = static_cast<size_t>(B) * H;
  const size_t H4 = 4 * static_cast<size_t>(H);
  const size_t dgs_half = static_cast<size_t>(G) * B * 4 * U;
  const size_t part_half = static_cast<size_t>(G) * B * N;
  for (int i = threadIdx.x; i < N * K; i += kPThreads) {
    const int n = i / K, k = i % K;
    const int s = k / (4 * U), g = (k / U) % 4, u = k % U;
    const int j = r * N + n, su = (s * C + c) * U + u;
    float* dst = ws + n * lk + k;
    if (j < H && su < H) {
      cp_async4(dst, w + static_cast<size_t>(j) * ldw + g * H + su);
    } else {
      *dst = 0.0f;
    }
  }
  cp_async_commit();
  // the thread's pairs b U + u, u < up
  bool mine[kPairs];
  int pb[kPairs], pu[kPairs];
  float dhc[kPairs], dcc[kPairs], pi[kPairs], pf[kPairs], po[kPairs];
#pragma unroll
  for (int e = 0; e < kPairs; ++e) {
    const int i = threadIdx.x + e * kPThreads;
    pb[e] = i / U;
    pu[e] = i % U;
    mine[e] = pb[e] < B && pu[e] < up;
    if (mine[e]) {
      const int j = u0 + pu[e];
      dhc[e] = dhT[pb[e] * H + j];
      dcc[e] = dcT[pb[e] * H + j];
      pi[e] = p_i[j];
      pf[e] = p_f[j];
      po[e] = p_o[j];
    }
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kw = warp / 4, nw = warp % 4;
  const int rg = lane / 4;
  const int col0 = nw * 4 * U + lane % 4;
  const int qh = (U + 1) / 2;  // the first half of a chunk's float4s
  const int qa = kw ? qh : 0, qb = kw ? U : qh;
  unsigned* const row_count = count + r;
  unsigned* const col_count = count + R + c;
  cp_async_wait<0>();
  __syncthreads();

  // 1: the partial of dgates_ts (dgs half ts & 1) into part half `half`
  auto product = [&](int ts, int half) {
    const float* src = dgs + static_cast<size_t>(ts & 1) * dgs_half;
    float acc[RPL][U];
#pragma unroll
    for (int i = 0; i < RPL; ++i) {
#pragma unroll
      for (int j = 0; j < U; ++j) acc[i][j] = 0.0f;
    }
    auto stage = [&](int s, float* buf) {
      const float* a = src + static_cast<size_t>(s * C + c) * B * 4 * U;
      for (int i = threadIdx.x; i < B * U; i += kPThreads) {
        const int b = i / U, q = i % U;
        cp_async16(buf + b * la + 4 * q, a + b * 4 * U + 4 * q);
      }
    };
    auto sum = [&](int s, const float* buf) {
      const float* a = buf + rg * la;
      const float* wt = ws + col0 * lk + s * 4 * U;
      Operands<RPL, U> op;
      for (int q = qa; q < qb; ++q) {
        op.load(a + 4 * q, la, wt + 4 * q, lk);
        op.fma(acc);
      }
    };
    if (nbuf == R) {
      for (int s = 0; s < R; ++s) stage(s, ring + s * rows * la);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      for (int s = 0; s < R; ++s) sum(s, ring + s * rows * la);
    } else {
      stage(0, ring);
      cp_async_commit();
      for (int s = 0; s < R; ++s) {
        if (s + 1 < R) {
          stage(s + 1, ring + ((s + 1) & 1) * rows * la);
          cp_async_commit();
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();
        sum(s, ring + (s & 1) * rows * la);
        __syncthreads();
      }
    }
    __syncthreads();
    hand_over<RPL, U, G2>(acc, kw == 1, kw == 0, nw, ring);
    // the partial to part, G2 of a lane's rows (8 G2 rows of the block) at
    // a time through shared memory (rows of N + 4 floats: the lanes'
    // stores hit 32 banks), then in whole float4s
    float* out = part + static_cast<size_t>(half) * part_half +
                 static_cast<size_t>(p) * B * N;
#pragma unroll
    for (int i0 = 0; i0 < RPL; i0 += G2) {
      if (kw == 0) {
#pragma unroll
        for (int i = 0; i < G2; ++i) {
#pragma unroll
          for (int j = 0; j < U; ++j)
            ring[(rg + 8 * i) * (N + 4) + col0 + 4 * j] = acc[i0 + i][j];
        }
      }
      __syncthreads();
      const int r0 = 8 * i0, nr = min(8 * G2, B - r0);
      for (int x = threadIdx.x; x < nr * (N / 4); x += kPThreads) {
        const int rr = x / (N / 4), q = x % (N / 4);
        *reinterpret_cast<float4*>(out + static_cast<size_t>(r0 + rr) * N +
                                   4 * q) =
            *reinterpret_cast<const float4*>(ring + rr * (N + 4) + 4 * q);
      }
      __syncthreads();
    }
  };
  // 2: dh_in of the own pairs from the row group's partials, c order
  auto reduce = [&](int half, float (&dh_in)[kPairs]) {
    const float* base = part + static_cast<size_t>(half) * part_half;
    float got[kPairs][C];
#pragma unroll
    for (int e = 0; e < kPairs; ++e) {
#pragma unroll
      for (int k = 0; k < C; ++k)
        got[e][k] = mine[e] ? __ldcg(base +
                                     (static_cast<size_t>(r * C + k) * B +
                                      pb[e]) * N + c * U + pu[e])
                            : 0.0f;
    }
#pragma unroll
    for (int e = 0; e < kPairs; ++e) {
      float v = got[e][0];
#pragma unroll
      for (int k = 1; k < C; ++k) v += got[e][k];
      dh_in[e] = dhc[e] + v;
    }
  };

  unsigned row_arrivals = 0, col_arrivals = 0;
  for (int t = T - 1; t >= 0; --t) {
    // this step's inputs of the own pairs, into registers (read-only)
    float gt[kPairs][4], c_new[kPairs], c_pv[kPairs], dy[kPairs], m[kPairs];
    const float* c_prev = t ? cs + (t - 1) * bh : c0;
#pragma unroll
    for (int e = 0; e < kPairs; ++e) {
      if (!mine[e]) continue;
      const size_t o = static_cast<size_t>(pb[e]) * H + u0 + pu[e];
      const float* gr = gates + static_cast<size_t>(t) * B * H4 +
                        static_cast<size_t>(pb[e]) * H4 + u0 + pu[e];
#pragma unroll
      for (int g = 0; g < 4; ++g) gt[e][g] = gr[g * H];
      c_new[e] = cs[t * bh + o];
      c_pv[e] = c_prev[o];
      dy[e] = dys[t * bh + o];
      m[e] = mask[static_cast<size_t>(t) * B + pb[e]];
    }
    float dh_in[kPairs];
    if (t == T - 1) {
#pragma unroll
      for (int e = 0; e < kPairs; ++e) dh_in[e] = dhc[e];
    } else {
      col_arrivals += R;
      grid_wait(col_count, col_arrivals);
      product(t + 1, t & 1);
      row_arrivals += C;
      grid_arrive(row_count);
      grid_wait(row_count, row_arrivals);
      reduce(t & 1, dh_in);
    }
    float* dx_t = dxs + static_cast<size_t>(t) * B * H4;
    float* dg_t = dgs + static_cast<size_t>(t & 1) * dgs_half +
                  static_cast<size_t>(p) * B * 4 * U;
#pragma unroll
    for (int e = 0; e < kPairs; ++e) {
      if (!mine[e]) continue;
      const float i = gt[e][0], ig = gt[e][1], fg = gt[e][2], og = gt[e][3];
      const float mm = m[e];
      const float dh_new = mm * (dh_in[e] + dy[e]);
      const float dc_new = mm * dcc[e];
      const float tc = tanhf(c_new[e]);
      const float da_og = ((dh_new * tc) * og) * (1.0f - og);
      const float dc_tot =
          (dc_new + (dh_new * og) * (1.0f - tc * tc)) + da_og * po[e];
      const float da_i = (dc_tot * ig) * (1.0f - i * i);
      const float da_ig = ((dc_tot * i) * ig) * (1.0f - ig);
      const float da_fg = ((dc_tot * c_pv[e]) * fg) * (1.0f - fg);
      dcc[e] = (((1.0f - mm) * dcc[e] + dc_tot * fg) + da_ig * pi[e]) +
               da_fg * pf[e];
      dhc[e] = (1.0f - mm) * dh_in[e];
      float* dr = dx_t + static_cast<size_t>(pb[e]) * H4 + u0 + pu[e];
      dr[0] = da_i;
      dr[H] = da_ig;
      dr[2 * H] = da_fg;
      dr[3 * H] = da_og;
      float* dg = dg_t + pb[e] * 4 * U + pu[e];
      dg[0] = da_i;
      dg[U] = da_ig;
      dg[2 * U] = da_fg;
      dg[3 * U] = da_og;
    }
    grid_arrive(col_count);
  }
  col_arrivals += R;
  grid_wait(col_count, col_arrivals);
  product(0, 1);
  row_arrivals += C;
  grid_arrive(row_count);
  grid_wait(row_count, row_arrivals);
  float dh_in[kPairs];
  reduce(1, dh_in);
#pragma unroll
  for (int e = 0; e < kPairs; ++e) {
    if (!mine[e]) continue;
    const size_t o = static_cast<size_t>(pb[e]) * H + u0 + pu[e];
    dh0[o] = dh_in[e];
    dc0[o] = dcc[e];
  }
}

// The plan checks of a launcher: 16-byte copies of h rows (H % 4 == 0),
// at most 64 rows, U one of the instantiated 1, 2, 4, 10.
bool bad_plan(int B, int H, int U) {
  return B < 1 || B > 64 || H < 4 || H % 4 != 0 ||
         !(U == 1 || U == 2 || U == 4 || U == 10);
}

template <template <int, int> class K, int RPL>
const void* by_units(int U) {
  switch (U) {
    case 1: return K<RPL, 1>::fn();
    case 2: return K<RPL, 2>::fn();
    case 4: return K<RPL, 4>::fn();
    case 10: return K<RPL, 10>::fn();
  }
  return nullptr;
}

// The kernel K<rpl, U>; the forward's rpl is at most 4 (fwd_rows), the
// chain's 8 (lane_rows).
template <template <int, int> class K, int kMaxRows>
const void* by_rows(int rpl, int U) {
  switch (rpl) {
    case 1: return by_units<K, 1>(U);
    case 2: return by_units<K, 2>(U);
    case 4: return by_units<K, 4>(U);
    case 8:
      if constexpr (kMaxRows >= 8) return by_units<K, 8>(U);
  }
  return nullptr;
}

template <int RPL, int U>
struct Primal {
  static const void* fn() {
    return (const void*)lstm_persistent_kernel<false, RPL, U>;
  }
};
template <int RPL, int U>
struct Residual {
  static const void* fn() {
    return (const void*)lstm_persistent_kernel<true, RPL, U>;
  }
};
template <int RPL, int U>
struct Chain {
  static const void* fn() { return (const void*)lstm_bwd_chain_kernel<RPL, U>; }
};

}  // namespace

// Shared-memory bytes of a persistent block (kind 0: the forward; 1: the
// chain), as the launchers compute them; the wrapper's plan mirrors it.
extern "C" long long lstm_persistent_smem(int B, int H, int U, int kind) {
  return lstm_smem(B, H, U, kind);
}

// The forward sequence on the persistent route: one cooperative launch of
// ceil(H / U) blocks, U units each. hbuf ([T, B, H]) receives h_t for
// every step (hs in the residual form). residual != 0: the residual form
// (ys, hs, cs, gates; c_out unused), else the primal form (ys, hbuf, cT
// in c_out; cs, gates unused). count (one unsigned, zeroed here on the
// stream) is scratch. h0 and hbuf must lie on 16 bytes. Returns 0, a CUDA
// error, -1/-2/-3 (see launch_cooperative) or -4 (a plan the kernel does
// not take).
extern "C" int lstm_seq_forward_persistent(
    const float* xs, const float* mask, const float* w, const float* p_i,
    const float* p_f, const float* p_o, const float* h0, const float* c0,
    float* hbuf, float* c_out, float* ys, float* cs, float* gates,
    unsigned* count, int residual, int ldw, int T, int B, int H, int U,
    void* stream) {
  if (T == 0 || B == 0 || H == 0) return 0;
  if (bad_plan(B, H, U)) return -4;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(count, 0, sizeof(unsigned), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&xs,    &mask, &w,  &p_i, &p_f,   &p_o,   &h0,
                  &c0,    &hbuf, &c_out, &ys, &cs,  &gates, &count,
                  &ldw,   &T,    &B,  &H};
  const int rpl = fwd_rows(B).rpl;
  const void* kernel = residual ? by_rows<Residual, 4>(rpl, U)
                                : by_rows<Primal, 4>(rpl, U);
  return launch_cooperative(kernel, (H + U - 1) / U,
                            lstm_smem(B, H, U, kFwd), args, s);
}

// The backward's reverse chain on the persistent route: dxs ([T, B, 4H]),
// dh0 and dc0 ([B, H]) from the residuals of the forward, on chain_grid(H,
// U) blocks. Scratch: dgs ([2, G, B, 4U], zeroed here: the entries of
// units past H stay 0), part ([2, G, B, 16U]) and count (R + 16 unsigned,
// R = G / 16, zeroed here). Same error contract as
// lstm_seq_forward_persistent.
extern "C" int lstm_bwd_chain_launch(
    const float* dys, const float* mask, const float* gates, const float* cs,
    const float* c0, const float* w, const float* p_i, const float* p_f,
    const float* p_o, const float* dhT, const float* dcT, float* dxs,
    float* dgs, float* part, float* dh0, float* dc0, unsigned* count,
    int ldw, int T, int B, int H, int U, void* stream) {
  if (B == 0 || H == 0) return 0;
  if (bad_plan(B, H, U)) return -4;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T == 0) {
    cudaError_t err = cudaMemcpyAsync(dh0, dhT, sizeof(float) * B * H,
                                      cudaMemcpyDeviceToDevice, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaMemcpyAsync(
        dc0, dcT, sizeof(float) * B * H, cudaMemcpyDeviceToDevice, s));
  }
  const int G = chain_grid(H, U);
  cudaError_t err = cudaMemsetAsync(
      count, 0, sizeof(unsigned) * (G / kGroupCols + kGroupCols), s);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(dgs, 0, sizeof(float) * 2 * G * B * 4 * U, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&dys, &mask, &gates, &cs,  &c0,  &w,   &p_i,
                  &p_f, &p_o,  &dhT,   &dcT, &dxs, &dgs, &part,
                  &dh0, &dc0,  &count, &ldw, &T,   &B,   &H};
  return launch_cooperative(by_rows<Chain, 8>(lane_rows(B), U), G,
                            lstm_smem(B, H, U, kBwd), args, s);
}

// ---------------------------------------------------------------------
// The bf16 forms: the persistent kernels' layouts, the recurrent products
// on the tensor cores (mma.sync m16n8k16, bf16 operands, f32 sums).
//
// Forward (lstm_bf16_kernel): block p owns the units [p U, p U + U) and
// holds W[:, g H + p U + u] as the shared bf16 row n = g U + u (4U rows,
// padded to whole n8 tiles with zero rows; K along the row, ld + 8 wide,
// ld = H rounded up to 16 with zero columns). h_t crosses blocks through
// the exchange hx [T + 1][B][ld] (bf16; slot 0 holds h0, the columns past
// H are 0). Each step, warp kw sums the k16 steps [kw nk / 8, (kw + 1) nk
// / 8) of the product h_{t-1} @ W[:, own columns] for all MT m16 tiles of
// the batch and all n8 tiles of the columns: its ring of kBfSlots k16
// chunks of h_{t-1} (cp.async through L2, the two 16-byte halves of a row
// swapped on rows 4-7 of every 8 so that ldmatrix hits 8 bank groups),
// three chunks ahead, summed in the mma's f32 accumulators (the tensor
// cores' sums truncate: over a warp's <= 10 k16 steps that stays near
// 2^-20 of the sum, far below the product's one bf16 rounding, where a
// fresh accumulator a k16 step costs four f32 adds an mma). The eight
// warps' sums meet in shared memory (where the rings
// were) and every thread adds them for its cells in warp order: the
// product's f32 sum, then the cell of the bf16 arithmetic above, h_t into
// hx[t + 1]; one grid barrier, its halves with red.release and
// ld.acquire in place of persistent.cuh's fences (arrive_rel, wait_acq).
//
// Chain (lstm_bf16_chain_kernel): the f32 chain's blocks, counters and
// order of sums. Block p = 16 r + c holds W[the 16 U units of row group r,
// the gate columns of column group c] as bf16 rows n (the unit) over K =
// R chunks of la = 4U rounded up to 8 (column s la + g U + u; the rest 0),
// K rounded up to 16. Its dgates_t go to the exchange dgs [2][G][B][la]
// as the bf16 values they are; a step stages the column group's R chunks
// (cp.async, a [B][K] tile) and warp (mw, nw) of 2 x 4 sums its m16 tiles
// by n8 tiles of the partial [B][16 U] over all of K in the mma's f32
// accumulators, written to part in f32; each own pair then adds its row
// group's 16 partials in c order and rounds once, as in the f32 form.

namespace {

constexpr int kBfSlots = 4;  // a forward warp's ring of k16 chunks
constexpr int kFwdBf16 = 2, kBwdBf16 = 3;  // lstm_smem kinds of the bf16 forms

// The exchange's row stride, bf16 elements: H rounded up to the mma's k.
__host__ __device__ inline int bf16_ld(int H) { return (H + 15) / 16 * 16; }

// m16 tiles of the batch (the instances: 1, 2, 4).
__host__ __device__ inline int bf16_mtiles(int B) {
  return B <= 16 ? 1 : B <= 32 ? 2 : 4;
}

// n8 tiles of the forward's 4U gate columns.
__host__ __device__ constexpr int fwd_ntiles(int U) { return (4 * U + 7) / 8; }

// Row stride (floats) of a warp's forward sums: 8 per n8 tile, plus 8 for
// an even count, so that the float2 stores of a half-warp hit 32 banks.
__host__ __device__ constexpr int sums_ld(int nt) {
  return 8 * nt + (nt % 2 ? 0 : 8);
}

// The chain's chunk of a block's dgates row: 4U rounded up to 8.
__host__ __device__ constexpr int chain_la(int U) { return (4 * U + 7) / 8 * 8; }

// The chain product's depth: R chunks, rounded up to the mma's k.
__host__ __device__ inline int chain_kp(int H, int U) {
  const int R = chain_grid(H, U) / kGroupCols;
  return (R * chain_la(U) + 15) / 16 * 16;
}

// Shared-memory bytes of a bf16 block. Forward: W's 8 NT rows of ld + 8
// bf16, then the warps' rings (kBfSlots chunks of [16 MT][16] bf16 each),
// which then hold the warps' sums [8][16 MT][sums_ld] f32. Chain: W's 16 U
// rows and the staged dgates' 16 MT rows, both kp + 8 bf16 wide.
__host__ __device__ inline long long bf16_smem(int B, int H, int U,
                                               int kind) {
  const int mt = bf16_mtiles(B);
  if (kind == kFwdBf16) {
    const int nt = fwd_ntiles(U);
    const long long w = 2LL * 8 * nt * (bf16_ld(H) + 8);
    const long long ring = 2LL * kWarps * kBfSlots * 16 * mt * 16;
    const long long sums = 4LL * kWarps * 16 * mt * sums_ld(nt);
    return w + (ring > sums ? ring : sums);
  }
  return 2LL * (kGroupCols * U + 16 * mt) * (chain_kp(H, U) + 8);
}

template <bool kResidual, int MT, int U>
__global__ void __launch_bounds__(kPThreads, 1) lstm_bf16_kernel(
    const bf16* __restrict__ xs,     // [T, B, 4H]
    const float* __restrict__ mask,  // [T, B]
    const bf16* __restrict__ w,      // [H, 4H], leading dim ldw
    const bf16* __restrict__ p_i, const bf16* __restrict__ p_f,
    const bf16* __restrict__ p_o,    // [H] each
    const bf16* __restrict__ bias,   // [4H]
    const bf16* __restrict__ c0,     // [B, H]
    bf16* hx,                        // [T + 1, B, ld]: h0, then h_t
    bf16* __restrict__ c_out, float* __restrict__ ys,
    bf16* __restrict__ cs, bf16* __restrict__ gates, unsigned* count,
    int ldw, int T, int B, int H) {
  using St = Store<bf16>;
  constexpr int NT = fwd_ntiles(U), NW = 8 * NT, SL = sums_ld(NT);
  constexpr int ROWS = 16 * MT;
  extern __shared__ float4 smem4[];
  const int ld = bf16_ld(H), lw = ld + 8;
  bf16* const ws = reinterpret_cast<bf16*>(smem4);  // [NW][lw]
  bf16* const rings = ws + NW * lw;  // [8][kBfSlots][ROWS][16]; then sums
  float* const sums = reinterpret_cast<float*>(rings);  // [8][ROWS][SL]
  const int u0 = blockIdx.x * U;
  const int up = min(U, H - u0);
  const size_t bh = static_cast<size_t>(B) * H;
  const size_t H4 = 4 * static_cast<size_t>(H);
  const size_t bl = static_cast<size_t>(B) * ld;
  const bf16 zero = __float2bfloat16(0.f);
  for (int i = threadIdx.x; i < ld * NW; i += kPThreads) {
    const int k = i / NW, n = i % NW;
    const int g = n / U, u = n % U;
    ws[n * lw + k] = n < 4 * U && u < up && k < H
                         ? w[static_cast<size_t>(k) * ldw + g * H + u0 + u]
                         : zero;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g8 = lane / 4, t4 = lane % 4;
  // the warp's k16 steps [q0, q1); block p starts at step p % nq, so that
  // the blocks read different lines of L2 at a time
  const int nk = ld / 16;
  const int q0 = warp * nk / kWarps, q1 = (warp + 1) * nk / kWarps;
  const int nq = q1 - q0;
  const int first = nq > 0 ? blockIdx.x % nq : 0;
  bf16* const ring = rings + warp * kBfSlots * ROWS * 16;
  // the thread's cells
  bool mine[kPairs];
  int cb[kPairs], cu[kPairs];
  float hc[kPairs], cc[kPairs], pi[kPairs], pf[kPairs], po[kPairs],
      x[kPairs][4], m[kPairs], bb[kPairs][4];
#pragma unroll
  for (int e = 0; e < kPairs; ++e) {
    const int c = threadIdx.x + e * kPThreads;
    cb[e] = c / up;
    cu[e] = c % up;
    mine[e] = cb[e] < B;
    if (mine[e]) {
      const int j = u0 + cu[e];
      hc[e] = St::ld(hx + cb[e] * ld + j);
      cc[e] = St::ld(c0 + cb[e] * H + j);
      pi[e] = St::ld(p_i + j);
      pf[e] = St::ld(p_f + j);
      po[e] = St::ld(p_o + j);
#pragma unroll
      for (int g = 0; g < 4; ++g) bb[e][g] = St::ld(bias + g * H + j);
    }
  }
  __syncthreads();

  unsigned arrivals = 0;
  for (int t = 0; t < T; ++t) {
    // this step's inputs of the thread's cells, into registers ahead of
    // the product (read-only: through L1)
#pragma unroll
    for (int e = 0; e < kPairs; ++e) {
      if (mine[e]) {
        const bf16* xr = xs + (static_cast<size_t>(t) * B + cb[e]) * H4 +
                         u0 + cu[e];
#pragma unroll
        for (int g = 0; g < 4; ++g) x[e][g] = St::ld(xr + g * H);
        m[e] = mask[static_cast<size_t>(t) * B + cb[e]];
      }
    }
    const bf16* h_prev = hx + t * bl;
    float acc[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.f;
    if (nq > 0) {
      // chunk i of the ring: k16 step q0 + (first + i) % nq of the rows;
      // a row's 16-byte half hh at 8 (hh ^ bit 2 of the row)
      auto issue = [&](int i) {
        const int q = q0 + (first + i) % nq;
        bf16* dst = ring + (i % kBfSlots) * ROWS * 16;
        for (int c = lane; c < 2 * B; c += 32) {
          const int r = c / 2, hh = c % 2;
          cp_async16(dst + r * 16 + 8 * (hh ^ ((r >> 2) & 1)),
                        h_prev + static_cast<size_t>(r) * ld + 16 * q + 8 * hh);
        }
      };
#pragma unroll
      for (int i = 0; i < kBfSlots - 1; ++i) {
        if (i < nq) issue(i);
        cp_async_commit();
      }
      for (int i = 0; i < nq; ++i) {
        if (i + kBfSlots - 1 < nq) issue(i + kBfSlots - 1);
        cp_async_commit();
        cp_async_wait<kBfSlots - 1>();
        __syncwarp();
        const int q = q0 + (first + i) % nq;
        const bf16* slot = ring + (i % kBfSlots) * ROWS * 16;
        unsigned a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const int r = mt * 16 + (lane & 15), hh = lane >> 4;
          ldsm_x4(a[mt], slot + r * 16 + 8 * (hh ^ ((r >> 2) & 1)));
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          unsigned b[2];
          ldsm_x2(b, ws + (nt * 8 + (lane & 7)) * lw + 16 * q +
                         8 * ((lane >> 3) & 1));
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) mma_add(acc[mt][nt], a[mt], b);
        }
        __syncwarp();
      }
    }
    __syncthreads();  // every ring read: the sums take their place
    float* const own = sums + warp * ROWS * SL;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        float* o = own + (mt * 16 + g8) * SL + nt * 8 + 2 * t4;
        *reinterpret_cast<float2*>(o) =
            make_float2(acc[mt][nt][0], acc[mt][nt][1]);
        *reinterpret_cast<float2*>(o + 8 * SL) =
            make_float2(acc[mt][nt][2], acc[mt][nt][3]);
      }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < kPairs; ++e) {
      if (!mine[e]) continue;
      const int b = cb[e], j = u0 + cu[e];
      // the product's f32 sum over the warps' K slices, in warp order
      float a[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const float* s = sums + b * SL + g * U + cu[e];
        float v = s[0];
#pragma unroll
        for (int kw = 1; kw < kWarps; ++kw) v += s[kw * ROWS * SL];
        a[g] = v;
      }
      const size_t o = static_cast<size_t>(t) * bh +
                       static_cast<size_t>(b) * H + j;
      const float cp = cc[e];
      // gates = x_t + h @ W + bias, each sum rounded
      const float g0 = St::r(St::r(x[e][0] + St::r(a[0])) + bb[e][0]);
      const float g1 = St::r(St::r(x[e][1] + St::r(a[1])) + bb[e][1]);
      const float g2 = St::r(St::r(x[e][2] + St::r(a[2])) + bb[e][2]);
      const float g3 = St::r(St::r(x[e][3] + St::r(a[3])) + bb[e][3]);
      const float in = St::r(tanhf(g0));
      const float ig = sigmoid_bf16(St::r(g1 + St::r(cp * pi[e])));
      const float fg = sigmoid_bf16(St::r(g2 + St::r(cp * pf[e])));
      const float c_new = St::r(St::r(in * ig) + St::r(cp * fg));
      const float og = sigmoid_bf16(St::r(g3 + St::r(c_new * po[e])));
      const float y = og * St::r(tanhf(c_new));  // exact in f32
      const float h_new = St::r(y);
      const bool live = m[e] > 0.0f;
      const float hn = live ? h_new : hc[e];
      const float cn = live ? c_new : cp;
      ys[o] = y * m[e];
      St::st(hx + (t + 1) * bl + static_cast<size_t>(b) * ld + j, hn);
      if (kResidual) {
        St::st(cs + o, cn);
        bf16* gr = gates + (static_cast<size_t>(t) * B + b) * H4 + j;
        St::st(gr, in);
        St::st(gr + H, ig);
        St::st(gr + 2 * H, fg);
        St::st(gr + 3 * H, og);
      }
      hc[e] = hn;
      cc[e] = cn;
    }
    if (t + 1 < T) {
      arrivals += gridDim.x;
      arrive_rel(count);
      wait_acq(count, arrivals);
    }
  }
  if (!kResidual) {
#pragma unroll
    for (int e = 0; e < kPairs; ++e) {
      if (mine[e]) St::st(c_out + cb[e] * H + u0 + cu[e], cc[e]);
    }
  }
}

template <int MT, int U>
__global__ void __launch_bounds__(kPThreads, 1) lstm_bf16_chain_kernel(
    const float* __restrict__ dys,   // [T, B, H]
    const float* __restrict__ mask,  // [T, B]
    const bf16* __restrict__ gates,  // [T, B, 4H] activated
    const bf16* __restrict__ cs,     // [T, B, H]
    const bf16* __restrict__ c0,     // [B, H]
    const bf16* __restrict__ w,      // [H, 4H], leading dim ldw
    const bf16* __restrict__ p_i, const bf16* __restrict__ p_f,
    const bf16* __restrict__ p_o,    // [H] each
    const bf16* __restrict__ dhT, const bf16* __restrict__ dcT,  // [B, H]
    bf16* dxs, bf16* dgs, float* part, bf16* __restrict__ dh0,
    bf16* __restrict__ dc0, unsigned* count, int ldw, int T, int B, int H) {
  using St = Store<bf16>;
  constexpr int C = kGroupCols, N = C * U, LA = chain_la(U);
  constexpr int NTT = N / 8, NTW = (NTT + 3) / 4, MTW = MT > 1 ? MT / 2 : 1;
  extern __shared__ float4 smem4[];
  const int G = gridDim.x, R = G / C;
  const int p = blockIdx.x, r = p / C, c = p % C;
  const int u0 = p * U, up = min(U, H - u0);  // up <= 0: no units
  const int KP = chain_kp(H, U), ldk = KP + 8, KA = R * LA;
  bf16* const ws = reinterpret_cast<bf16*>(smem4);  // [N][ldk]
  bf16* const at = ws + N * ldk;                     // [16 MT][ldk]
  const size_t bh = static_cast<size_t>(B) * H;
  const size_t H4 = 4 * static_cast<size_t>(H);
  const size_t dgs_half = static_cast<size_t>(G) * B * LA;
  const size_t part_half = static_cast<size_t>(G) * B * N;
  const bf16 zero = __float2bfloat16(0.f);
  for (int i = threadIdx.x; i < N * KP; i += kPThreads) {
    const int n = i / KP, k = i % KP;
    const int s = k / LA, jj = k % LA, g = jj / U, u = jj % U;
    const int j = r * N + n, su = (s * C + c) * U + u;
    ws[n * ldk + k] = k < KA && jj < 4 * U && j < H && su < H
                          ? w[static_cast<size_t>(j) * ldw + g * H + su]
                          : zero;
  }
  // the staged tile's columns past the R chunks stay 0
  for (int i = threadIdx.x; i < 16 * MT * (KP - KA); i += kPThreads)
    at[(i / (KP - KA)) * ldk + KA + i % (KP - KA)] = zero;
  // the thread's pairs b U + u, u < up
  bool mine[kPairs];
  int pb[kPairs], pu[kPairs];
  float dhc[kPairs], dcc[kPairs], pi[kPairs], pf[kPairs], po[kPairs];
#pragma unroll
  for (int e = 0; e < kPairs; ++e) {
    const int i = threadIdx.x + e * kPThreads;
    pb[e] = i / U;
    pu[e] = i % U;
    mine[e] = pb[e] < B && pu[e] < up;
    if (mine[e]) {
      const int j = u0 + pu[e];
      dhc[e] = St::ld(dhT + pb[e] * H + j);
      dcc[e] = St::ld(dcT + pb[e] * H + j);
      pi[e] = St::ld(p_i + j);
      pf[e] = St::ld(p_f + j);
      po[e] = St::ld(p_o + j);
    }
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int mw = warp / 4, nw = warp % 4;
  const int g8 = lane / 4, t4 = lane % 4;
  const bool active = mw * MTW < MT && nw * NTW < NTT;
  unsigned* const row_count = count + r;
  unsigned* const col_count = count + R + c;
  __syncthreads();

  // 1: the partial of dgates_ts (dgs half ts & 1) into part half `half`
  auto product = [&](int ts, int half) {
    const bf16* src = dgs + static_cast<size_t>(ts & 1) * dgs_half;
    constexpr int Q = LA / 8;
    for (int i = threadIdx.x; i < R * B * Q; i += kPThreads) {
      const int s = i / (B * Q), b = (i / Q) % B, q = i % Q;
      cp_async16(at + b * ldk + s * LA + 8 * q,
                    src + (static_cast<size_t>(s * C + c) * B + b) * LA +
                        8 * q);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (!active) return;
    float acc[MTW][NTW][4];
#pragma unroll
    for (int i = 0; i < MTW; ++i)
#pragma unroll
      for (int j = 0; j < NTW; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.f;
    for (int kk = 0; kk < KP / 16; ++kk) {
      unsigned a[MTW][4];
#pragma unroll
      for (int i = 0; i < MTW; ++i)
        ldsm_x4(a[i], at + ((mw * MTW + i) * 16 + (lane & 15)) * ldk +
                          16 * kk + 8 * (lane >> 4));
#pragma unroll
      for (int j = 0; j < NTW; ++j) {
        const int nt = nw * NTW + j;
        if (nt >= NTT) break;
        unsigned b[2];
        ldsm_x2(b, ws + (nt * 8 + (lane & 7)) * ldk + 16 * kk +
                       8 * ((lane >> 3) & 1));
#pragma unroll
        for (int i = 0; i < MTW; ++i) mma_add(acc[i][j], a[i], b);
      }
    }
    float* out = part + static_cast<size_t>(half) * part_half +
                 static_cast<size_t>(p) * B * N;
#pragma unroll
    for (int i = 0; i < MTW; ++i)
#pragma unroll
      for (int j = 0; j < NTW; ++j) {
        const int nt = nw * NTW + j;
        const int row = (mw * MTW + i) * 16 + g8, col = nt * 8 + 2 * t4;
        if (nt >= NTT) break;
        if (row < B)
          *reinterpret_cast<float2*>(out + static_cast<size_t>(row) * N +
                                     col) =
              make_float2(acc[i][j][0], acc[i][j][1]);
        if (row + 8 < B)
          *reinterpret_cast<float2*>(out + static_cast<size_t>(row + 8) * N +
                                     col) =
              make_float2(acc[i][j][2], acc[i][j][3]);
      }
  };
  // 2: dh_in of the own pairs from the row group's partials, c order
  auto reduce = [&](int half, float (&dh_in)[kPairs]) {
    const float* base = part + static_cast<size_t>(half) * part_half;
    float got[kPairs][C];
#pragma unroll
    for (int e = 0; e < kPairs; ++e) {
#pragma unroll
      for (int k = 0; k < C; ++k)
        got[e][k] = mine[e] ? __ldcg(base +
                                     (static_cast<size_t>(r * C + k) * B +
                                      pb[e]) * N + c * U + pu[e])
                            : 0.0f;
    }
#pragma unroll
    for (int e = 0; e < kPairs; ++e) {
      float v = got[e][0];
#pragma unroll
      for (int k = 1; k < C; ++k) v += got[e][k];
      dh_in[e] = St::r(dhc[e] + St::r(v));
    }
  };

  unsigned row_arrivals = 0, col_arrivals = 0;
  for (int t = T - 1; t >= 0; --t) {
    // this step's inputs of the own pairs, into registers (read-only)
    float gt[kPairs][4], c_new[kPairs], c_pv[kPairs], dy[kPairs], m[kPairs];
    const bf16* c_prev = t ? cs + (t - 1) * bh : c0;
#pragma unroll
    for (int e = 0; e < kPairs; ++e) {
      if (!mine[e]) continue;
      const size_t o = static_cast<size_t>(pb[e]) * H + u0 + pu[e];
      const bf16* gr = gates + static_cast<size_t>(t) * B * H4 +
                       static_cast<size_t>(pb[e]) * H4 + u0 + pu[e];
#pragma unroll
      for (int g = 0; g < 4; ++g) gt[e][g] = St::ld(gr + g * H);
      c_new[e] = St::ld(cs + t * bh + o);
      c_pv[e] = St::ld(c_prev + o);
      dy[e] = St::r(dys[t * bh + o]);
      m[e] = mask[static_cast<size_t>(t) * B + pb[e]];
    }
    float dh_in[kPairs];
    if (t == T - 1) {
#pragma unroll
      for (int e = 0; e < kPairs; ++e) dh_in[e] = dhc[e];
    } else {
      col_arrivals += R;
      wait_acq(col_count, col_arrivals);
      product(t + 1, t & 1);
      row_arrivals += C;
      arrive_rel(row_count);
      wait_acq(row_count, row_arrivals);
      reduce(t & 1, dh_in);
    }
    bf16* dx_t = dxs + static_cast<size_t>(t) * B * H4;
    bf16* dg_t = dgs + static_cast<size_t>(t & 1) * dgs_half +
                 static_cast<size_t>(p) * B * LA;
#pragma unroll
    for (int e = 0; e < kPairs; ++e) {
      if (!mine[e]) continue;
      const float i = gt[e][0], ig = gt[e][1], fg = gt[e][2], og = gt[e][3];
      const float mm = m[e];
      const float dh_new = mm * (dh_in[e] + dy[e]);
      const float dc_new = mm * dcc[e];
      const float tc = tanhf(c_new[e]);
      const float da_og = ((dh_new * tc) * og) * (1.0f - og);
      const float dc_tot =
          (dc_new + (dh_new * og) * (1.0f - tc * tc)) + da_og * po[e];
      const float da_i = (dc_tot * ig) * (1.0f - i * i);
      const float da_ig = ((dc_tot * i) * ig) * (1.0f - ig);
      const float da_fg = ((dc_tot * c_pv[e]) * fg) * (1.0f - fg);
      dcc[e] = St::r((((1.0f - mm) * dcc[e] + dc_tot * fg) + da_ig * pi[e]) +
                     da_fg * pf[e]);
      dhc[e] = (1.0f - mm) * dh_in[e];
      const float d4[4] = {da_i, da_ig, da_fg, da_og};
      bf16* dr = dx_t + static_cast<size_t>(pb[e]) * H4 + u0 + pu[e];
      bf16* dg = dg_t + pb[e] * LA + pu[e];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        St::st(dr + g * H, d4[g]);
        St::st(dg + g * U, d4[g]);
      }
    }
    arrive_rel(col_count);
  }
  col_arrivals += R;
  wait_acq(col_count, col_arrivals);
  product(0, 1);
  row_arrivals += C;
  arrive_rel(row_count);
  wait_acq(row_count, row_arrivals);
  float dh_in[kPairs];
  reduce(1, dh_in);
#pragma unroll
  for (int e = 0; e < kPairs; ++e) {
    if (!mine[e]) continue;
    const size_t o = static_cast<size_t>(pb[e]) * H + u0 + pu[e];
    St::st(dh0 + o, dh_in[e]);
    St::st(dc0 + o, dcc[e]);
  }
}

template <int MT, int U>
struct BfPrimal {
  static const void* fn() {
    return (const void*)lstm_bf16_kernel<false, MT, U>;
  }
};
template <int MT, int U>
struct BfResidual {
  static const void* fn() {
    return (const void*)lstm_bf16_kernel<true, MT, U>;
  }
};
template <int MT, int U>
struct BfChain {
  static const void* fn() {
    return (const void*)lstm_bf16_chain_kernel<MT, U>;
  }
};

}  // namespace

// Shared-memory bytes of a bf16 block (kind 0: the forward; 1: the
// chain), as the bf16 launchers compute them; the wrapper's plan mirrors
// it.
extern "C" long long lstm_bf16_smem(int B, int H, int U, int kind) {
  return bf16_smem(B, H, U, kind ? kBwdBf16 : kFwdBf16);
}

// The bf16 forward on the persistent route: one cooperative launch of
// ceil(H / U) blocks. xs (the bias not folded), w, the peepholes, bias
// ([4H]), c0, c_out, cs and gates bf16; ys f32. hx ([T + 1, B, ld] bf16,
// ld = H rounded up to 16, 16-byte aligned) holds h0 in slot 0 and the
// columns past H zero on entry, h_t in slot t + 1 on return. residual !=
// 0: ys, hx, cs, gates (c_out unused); else ys, hx and cT in c_out (cs,
// gates unused). count (one unsigned, zeroed here) is scratch. Same error
// contract as lstm_seq_forward_persistent.
extern "C" int lstm_bf16_forward(const void* xs, const float* mask,
                                 const void* w, const void* p_i,
                                 const void* p_f, const void* p_o,
                                 const void* bias, const void* c0, void* hx,
                                 void* c_out, float* ys, void* cs,
                                 void* gates, unsigned* count, int residual,
                                 int ldw, int T, int B, int H, int U,
                                 void* stream) {
  if (T == 0 || B == 0 || H == 0) return 0;
  if (bad_plan(B, H, U)) return -4;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(count, 0, sizeof(unsigned), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&xs, &mask, &w,  &p_i, &p_f,   &p_o,   &bias, &c0,
                  &hx, &c_out, &ys, &cs, &gates, &count, &ldw,  &T,
                  &B,  &H};
  const int mt = bf16_mtiles(B);
  const void* kernel = residual ? by_rows<BfResidual, 4>(mt, U)
                                : by_rows<BfPrimal, 4>(mt, U);
  return launch_cooperative(kernel, (H + U - 1) / U,
                            bf16_smem(B, H, U, kFwdBf16), args, s);
}

// The bf16 reverse chain on chain_grid(H, U) blocks: dxs ([T, B, 4H]),
// dh0 and dc0 ([B, H]) in bf16 from the bf16 residuals, c0, w, the
// peepholes, dhT and dcT; dys (the cotangent of the f32 ys) f32. Scratch:
// dgs ([2, G, B, la] bf16, la = 4U rounded up to 8; zeroed here: the
// entries of units past H and the padding stay 0), part ([2, G, B, 16U]
// f32) and count (R + 16 unsigned, zeroed here). Same error contract as
// lstm_seq_forward_persistent.
extern "C" int lstm_bf16_chain(const float* dys, const float* mask,
                               const void* gates, const void* cs,
                               const void* c0, const void* w,
                               const void* p_i, const void* p_f,
                               const void* p_o, const void* dhT,
                               const void* dcT, void* dxs, void* dgs,
                               float* part, void* dh0, void* dc0,
                               unsigned* count, int ldw, int T, int B, int H,
                               int U, void* stream) {
  if (B == 0 || H == 0) return 0;
  if (bad_plan(B, H, U)) return -4;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T == 0) {
    cudaError_t err = cudaMemcpyAsync(dh0, dhT, sizeof(bf16) * B * H,
                                      cudaMemcpyDeviceToDevice, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaMemcpyAsync(
        dc0, dcT, sizeof(bf16) * B * H, cudaMemcpyDeviceToDevice, s));
  }
  const int G = chain_grid(H, U);
  cudaError_t err = cudaMemsetAsync(
      count, 0, sizeof(unsigned) * (G / kGroupCols + kGroupCols), s);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(dgs, 0, sizeof(bf16) * 2 * G * B * chain_la(U), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&dys, &mask, &gates, &cs,  &c0,  &w,   &p_i,
                  &p_f, &p_o,  &dhT,   &dcT, &dxs, &dgs, &part,
                  &dh0, &dc0,  &count, &ldw, &T,   &B,   &H};
  return launch_cooperative(by_rows<BfChain, 4>(bf16_mtiles(B), U), G,
                            bf16_smem(B, H, U, kBwdBf16), args, s);
}

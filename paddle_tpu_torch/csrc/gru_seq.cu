// Masked GRU sequence recurrence and the single GRU step, f32, for Hopper
// (sm_90a): the sequence forward in its primal and its residual (training)
// form, the one-step cell forward, and the backward's reverse chain.
//
// Replaces the TPU kernels paddle_tpu/ops/gru.py:_gru_kernel (both forms;
// Wg [H, 2H] and Ws [H, H] resident in VMEM across the time grid) and
// paddle_tpu/kernels/rnn_cells.py:_gru_cell_kernel (one step, both
// recurrent products inside the kernel), and gives the JAX backward
// (_bwd_rule, ops/gru.py:135-166, a reverse lax.scan left to XLA) kernels
// of its own. All compute, with the gate bias already folded into x (gate
// order [update z, reset r, candidate c]):
//
//   z = sigmoid(x_z + h_{t-1} @ Wg[:, :H])
//   r = sigmoid(x_r + h_{t-1} @ Wg[:, H:])
//   c = tanh(x_c + (r * h_{t-1}) @ Ws)
//   h_new = h_{t-1} - z * h_{t-1} + z * c   (JAX's spelling, not (1-z)h + zc)
//   sequence only: mask == 0 holds h (h_t = h_{t-1}), ys[t] = h_new * mask
//
// The primal form writes ys and the final h. The residual form also
// writes, per step, the guarded hs[t] and gates[t] = [z | r | c] (each
// block H wide), the residuals of _fwd_rule (ops/gru.py:129-132). The cell
// (gru_cell_forward) is one unmasked step: out = h_new.
//
// Two routes, chosen by shape (ops/gru.py:gru_route mirrors the arithmetic
// of persistent_smem below):
//
// 1. Persistent (gru_seq_forward_persistent, gru_bwd_chain_launch): one
//    cooperative launch per sequence and one per reverse chain. The card
//    has 132 SMs x 227 KB = 30 MB of shared memory; split by hidden units
//    across a grid of at most one block per SM, the weights fit: block p
//    owns the U = ceil(H / SMs) units [p U, p U + U) and holds, for the
//    whole launch, 3 U H floats of them in shared memory (the forward the
//    z, r columns of Wg and the c columns of Ws, transposed; the backward
//    the rows of Wg and Ws, which the transposed products read). H = 1024:
//    U = 8, 96 KB a block; H = 512: U = 4, 24 KB. A forward step is
//      A. stage h_{t-1} [B, H] (cp.async.cg; all of it at once where it
//         fits beside the weights, else in double-buffered chunks), z
//         and r of the block's units on all rows, r * h_{t-1} into a
//         [B, H] scratch (rh); grid barrier;
//      B. stage rh, c and h_new, the mask guard, ys and the state;
//         grid barrier.
//    A reverse step is: 1. elementwise on the block's units (dh_new, dz,
//    da_c, da_z and the first two terms of dh_prev; da_z, da_c into dxs);
//    barrier; 2. stage da_c, drh = da_c @ Ws^T for the block's units, dr,
//    da_r into dxs, + drh * r; arrive at the next barrier; 3a. stage da_z
//    (out since the first barrier), + da_z @ Wg[:, :H]^T while the others
//    arrive; wait; 3b. stage da_r, + da_r @ Wg[:, H:]^T. Step t-1's phase
//    1 reads only the block's own dh carry, so two barriers a step
//    suffice. Every product is over K = H columns. Each thread sums a
//    4-row x 4-column tile over an interleaved slice of K (float4 reads
//    of the staged rows and the resident weights); a tile's slices are
//    neighbouring lanes of a warp, added by a butterfly of shuffles: f32
//    FMAs in a fixed order, no atomics, two runs give the same bits. The
//    grid barrier (persistent.cuh, shared with lstm_seq.cu, as are the
//    cp.async staging and the checked launch) is an arrival counter
//    (zeroed before each launch):
//    __threadfence, atomicAdd, spin on an acquire load until it reaches
//    (barrier number) x (blocks). Each block's own inputs (x and the mask
//    forward; gates, h_prev, dy and the mask backward) are copied into
//    shared memory a step ahead.
//    Cross-block data (h, rh, dxs) is read only through L2 (cp.async.cg),
//    never through the non-coherent L1.
//    The launcher checks cudaOccupancyMaxActiveBlocksPerMultiprocessor x
//    SMs against the grid and returns -2 where the grid would not be
//    co-resident (-1: the shared memory exceeds the opt-in limit; -3: no
//    cooperative launch); the wrapper raises with the reason.
//    The route line: a block's shared memory is 3 U H weights + the
//    staging (B x H, or two buffers of B x kc floats, 32 <= kc < H) + what
//    it keeps of its own units (the carries, and their inputs a step
//    ahead: 8 B U + 2 B floats forward, 11 B U + 2 B backward), within
//    232,448 bytes; H % 4 == 0 (16-byte copies) and ceil(B/4) ceil(2U/4)
//    <= 256 tiles. On 132 SMs the largest H on the route is 1524 at
//    B = 16, 1452 at B = 50, 1396 at B = 64 and 1584 at B = 1; above it
//    the two-launch route runs.
//
// 2. Two launches a step (gru_seq_forward, gru_seq_forward_train; the
//    cell always): the launch is the barrier between the phases.
//   A. gru_gate_kernel: blocks own a tile of kRows batch rows by kUnits
//      units and sum h_{t-1} @ Wg for the z and r columns of their units;
//      they write z and r into gates_t and r * h_{t-1} into rh.
//   B. gru_state_kernel: the same tiling over rh @ Ws; each thread then has
//      everything its unit needs: c, h_new, the mask guard, ys and the
//      residual c.
//   The tile product streams the rows of h (or rh) and the block's weight
//   columns through shared memory in chunks of kK and sums in f32
//   registers, as csrc/lstm_seq.cu does. Its backward is the per-step
//   pair gru_bwd_gate_kernel / gru_bwd_reset_kernel below, with a cuBLAS
//   product after each, issued by the wrapper.
//
// Strided weights. The layers slice one parameter w0 [H, 3H] into
// Wg = w0[:, :2H] and Ws = w0[:, 2H:]: views whose rows lie 3H apart. The
// kernels take each weight's leading dimension (ldg, lds) and never assume
// a row-major [H, 2H] / [H, H] block; the wrapper checks that the columns
// are contiguous (stride 1) and passes the row stride.
//
// bf16 (--compute_dtype bfloat16): kernels of their own, in the last
// section (gru_bf16_kernel, gru_bf16_chain_kernel): the recurrent products
// on the tensor cores, the state and the gradients crossing blocks as the
// bf16 values they are; the f32 kernels above take f32 only.
//
// Bound on the H100 (SXM, 700 W): the two products are 2 * B * H * 3H
// operations per step at the f32 rate outside the tensor cores
// (67 TFLOP/s), the backward chain's three 6 B H^2; the bytes are xs, ys
// (and the residuals) once, plus W once. At B = 16, H = 1024, T = 400 that
// is 0.601 ms of operations for the sequence and for the chain; at
// B = 50, H = 512, T = 50, 0.0587 ms. The persistent route pays per step
// two grid barriers, the L2 reads of h (every block stages all of it) and
// the products at the FMA rate of the tiles; the two-launch route pays two
// launches and 2 x H/32 dependent L2 round trips per step, with W read
// from L2 each time.
//
// Backward step of the two-launch route. Its per-step chain has two
// products in the middle (drh = da_c @ Ws^T, needed by da_r, and
// da_zr @ Wg^T, the last term of dh_prev):
//   gru_bwd_gate_kernel:  da_z, da_c and the first two terms of dh_prev;
//   (drh = da_c @ Ws^T)
//   gru_bwd_reset_kernel: da_r and the third term (drh * r);
//   (dh_prev += da_zr @ Wg^T)
// Each is bound by bytes: per element of [B, H] the first reads 7 and
// writes 3 floats, the second reads 5 and writes 2, against ~15 and ~5
// operations.
#include <cuda_runtime.h>

#include <cstddef>

#include "persistent.cuh"

namespace {

constexpr int kRows = 16;           // batch rows per block
constexpr int kUnits = 32;          // hidden units per block (one warp)
constexpr int kK = 32;              // depth of one shared-memory chunk
constexpr int kRowsPerThread = 2;
constexpr int kThreads = kUnits * (kRows / kRowsPerThread);  // 256

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// acc[r][g] = sum_k a[b, k] * w[k, g * H + j] for the block's rows b and
// this thread's unit j, gate columns g < NG. a is [B, H] row-major; w has
// leading dimension ldw. Ends with the block synchronised.
template <int NG>
__device__ __forceinline__ void tile_product(
    const float* __restrict__ a, const float* __restrict__ w, int ldw, int B,
    int H, int b0, int j0, float (*as)[kK + 1], float (*ws)[NG * kUnits],
    float (&acc)[kRowsPerThread][NG]) {
  const int tx = threadIdx.x % kUnits;
  const int ty = threadIdx.x / kUnits;
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
#pragma unroll
    for (int g = 0; g < NG; ++g) acc[r][g] = 0.0f;
  }
  for (int k0 = 0; k0 < H; k0 += kK) {
    for (int i = threadIdx.x; i < kRows * kK; i += kThreads) {
      const int r = i / kK, k = i % kK;
      const int b = b0 + r, kk = k0 + k;
      as[r][k] = (b < B && kk < H) ? a[static_cast<size_t>(b) * H + kk]
                                   : 0.0f;
    }
    for (int i = threadIdx.x; i < kK * NG * kUnits; i += kThreads) {
      const int k = i / (NG * kUnits), col = i % (NG * kUnits);
      const int g = col / kUnits, u = col % kUnits;
      const int kk = k0 + k, j = j0 + u;
      ws[k][col] = (kk < H && j < H)
                       ? w[static_cast<size_t>(kk) * ldw +
                           static_cast<size_t>(g) * H + j]
                       : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kK; ++k) {
      float wv[NG];
#pragma unroll
      for (int g = 0; g < NG; ++g) wv[g] = ws[k][g * kUnits + tx];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        const float av = as[ty * kRowsPerThread + r][k];
#pragma unroll
        for (int g = 0; g < NG; ++g) acc[r][g] = fmaf(av, wv[g], acc[r][g]);
      }
    }
    __syncthreads();
  }
}

// Phase A of a step: z, r into gates_t and r * h_prev into rh.
__global__ void __launch_bounds__(kThreads)
gru_gate_kernel(const float* __restrict__ x_t,     // [B, 3H], bias folded
                const float* __restrict__ h_prev,  // [B, H]
                const float* __restrict__ wg,      // [H, 2H], leading dim ldg
                float* __restrict__ gates_t,       // [B, 3H]: z, r written
                float* __restrict__ rh,            // [B, H]
                int ldg, int B, int H) {
  __shared__ float as[kRows][kK + 1];
  __shared__ float ws[kK][2 * kUnits];
  const int j0 = blockIdx.x * kUnits;
  const int b0 = blockIdx.y * kRows;
  float acc[kRowsPerThread][2];
  tile_product<2>(h_prev, wg, ldg, B, H, b0, j0, as, ws, acc);

  const int j = j0 + threadIdx.x % kUnits;
  const int ty = threadIdx.x / kUnits;
  if (j >= H) return;
  const size_t H3 = 3 * static_cast<size_t>(H);
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int b = b0 + ty * kRowsPerThread + r;
    if (b >= B) break;
    const float* x = x_t + static_cast<size_t>(b) * H3;
    float* g = gates_t + static_cast<size_t>(b) * H3;
    const size_t o = static_cast<size_t>(b) * H + j;
    const float z = sigmoid_f(x[j] + acc[r][0]);
    const float rr = sigmoid_f(x[H + j] + acc[r][1]);
    g[j] = z;
    g[H + j] = rr;
    rh[o] = rr * h_prev[o];
  }
}

// Phase B of a step: c from rh @ Ws, then the new state. kMasked: the
// sequence's guard (h holds where mask == 0) and ys; otherwise the cell's
// unmasked output (mask_t and ys_t unused).
template <bool kMasked>
__global__ void __launch_bounds__(kThreads)
gru_state_kernel(const float* __restrict__ x_t,     // [B, 3H], bias folded
                 const float* __restrict__ rh,      // [B, H]
                 const float* __restrict__ w_s,     // [H, H], leading dim lds
                 const float* __restrict__ mask_t,  // [B]
                 const float* __restrict__ h_prev,  // [B, H]
                 float* __restrict__ gates_t,       // [B, 3H]: z read, c written
                 float* __restrict__ h_next,        // [B, H]
                 float* __restrict__ ys_t,          // [B, H]
                 int lds, int B, int H) {
  __shared__ float as[kRows][kK + 1];
  __shared__ float ws[kK][kUnits];
  const int j0 = blockIdx.x * kUnits;
  const int b0 = blockIdx.y * kRows;
  float acc[kRowsPerThread][1];
  tile_product<1>(rh, w_s, lds, B, H, b0, j0, as, ws, acc);

  const int j = j0 + threadIdx.x % kUnits;
  const int ty = threadIdx.x / kUnits;
  if (j >= H) return;
  const size_t H3 = 3 * static_cast<size_t>(H);
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int b = b0 + ty * kRowsPerThread + r;
    if (b >= B) break;
    const float* x = x_t + static_cast<size_t>(b) * H3;
    float* g = gates_t + static_cast<size_t>(b) * H3;
    const size_t o = static_cast<size_t>(b) * H + j;
    const float c = tanhf(x[2 * H + j] + acc[r][0]);
    const float hp = h_prev[o];
    const float z = g[j];
    const float h_new = (hp - z * hp) + z * c;
    g[2 * H + j] = c;
    if (kMasked) {
      const float m = mask_t[b];
      h_next[o] = m > 0.0f ? h_new : hp;
      ys_t[o] = h_new * m;
    } else {
      h_next[o] = h_new;
    }
  }
}

constexpr int kBwdThreads = 256;

// First half of one reverse step. On entry dh holds the carry dh of step
// t; on return (1 - m) * dh + dh_new * (1 - z), and dxs_t holds da_z and
// da_c (its da_r block is written by gru_bwd_reset_kernel).
__global__ void __launch_bounds__(kBwdThreads)
gru_bwd_gate_kernel(const float* __restrict__ dy_t,     // [B, H]
                    const float* __restrict__ mask_t,   // [B]
                    const float* __restrict__ gates_t,  // [B, 3H] z, r, c
                    const float* __restrict__ h_pv,     // [B, H]
                    float* __restrict__ dh,             // [B, H], in/out
                    float* __restrict__ dxs_t,          // [B, 3H]
                    int B, int H) {
  const size_t n = static_cast<size_t>(B) * H;
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < n; e += stride) {
    const size_t b = e / H;
    const int j = static_cast<int>(e % H);
    const size_t row = b * 3 * static_cast<size_t>(H);
    const float m = mask_t[b];
    const float z = gates_t[row + j];
    const float c = gates_t[row + 2 * H + j];
    const float hp = h_pv[e];
    const float d = dh[e];
    const float dh_new = m * (d + dy_t[e]);
    const float dz = dh_new * (c - hp);
    dxs_t[row + 2 * H + j] = (dh_new * z) * (1.0f - c * c);
    dxs_t[row + j] = (dz * z) * (1.0f - z);
    dh[e] = (1.0f - m) * d + dh_new * (1.0f - z);
  }
}

// Second half: drh = da_c @ Ws^T is in; writes da_r into dxs_t and adds
// drh * r to dh.
__global__ void __launch_bounds__(kBwdThreads)
gru_bwd_reset_kernel(const float* __restrict__ drh,      // [B, H]
                     const float* __restrict__ gates_t,  // [B, 3H]
                     const float* __restrict__ h_pv,     // [B, H]
                     float* __restrict__ dh,             // [B, H], in/out
                     float* __restrict__ dxs_t,          // [B, 3H]
                     int B, int H) {
  const size_t n = static_cast<size_t>(B) * H;
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < n; e += stride) {
    const size_t b = e / H;
    const int j = static_cast<int>(e % H);
    const size_t row = b * 3 * static_cast<size_t>(H);
    const float r = gates_t[row + H + j];
    const float d = drh[e];
    const float dr = d * h_pv[e];
    dxs_t[row + H + j] = (dr * r) * (1.0f - r);
    dh[e] = dh[e] + d * r;
  }
}

unsigned bwd_blocks(int B, int H) {
  size_t blocks = (static_cast<size_t>(B) * H + kBwdThreads - 1) /
                  kBwdThreads;
  return static_cast<unsigned>(blocks > 65535 ? 65535 : blocks);
}

dim3 grid_of(int B, int H) {
  return dim3((H + kUnits - 1) / kUnits, (B + kRows - 1) / kRows);
}

// One masked step: phase A then phase B, both on `s`. Returns the first
// launch error (0 if both launches were accepted).
int masked_step(const float* x_t, const float* mask_t, const float* wg,
                const float* w_s, const float* h_prev, float* h_next,
                float* gates_t, float* rh, float* ys_t, int ldg, int lds,
                int B, int H, cudaStream_t s) {
  const dim3 grid = grid_of(B, H);
  gru_gate_kernel<<<grid, kThreads, 0, s>>>(x_t, h_prev, wg, gates_t, rh, ldg,
                                            B, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gru_state_kernel<true><<<grid, kThreads, 0, s>>>(
      x_t, rh, w_s, mask_t, h_prev, gates_t, h_next, ys_t, lds, B, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The primal form: T steps, two launches each. h is [2, B, H] with h[0] = h0
// on entry; after the call h[T % 2] holds hT. gates ([B, 3H]) and rh
// ([B, H]) are scratch. Returns the first launch error (cudaError_t as
// int), 0 when every launch was accepted. Launches on `stream`, allocates
// nothing, does not synchronise.
extern "C" int gru_seq_forward(const float* xs, const float* mask,
                               const float* wg, const float* w_s, float* h,
                               float* gates, float* rh, float* ys, int ldg,
                               int lds, int T, int B, int H, void* stream) {
  if (B == 0 || H == 0) return 0;
  const size_t bh = static_cast<size_t>(B) * H;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int t = 0; t < T; ++t) {
    const int err = masked_step(
        xs + static_cast<size_t>(t) * 3 * bh, mask + static_cast<size_t>(t) * B,
        wg, w_s, h + (t & 1) * bh, h + ((t + 1) & 1) * bh, gates, rh,
        ys + static_cast<size_t>(t) * bh, ldg, lds, B, H, s);
    if (err != 0) return err;
  }
  return 0;
}

// The residual form: T steps from h0 ([B, H]), writing ys, hs ([T, B, H])
// and gates = [z | r | c] ([T, B, 3H]); rh ([B, H]) is scratch. hT =
// hs[T-1]. Same launch and error contract as gru_seq_forward.
extern "C" int gru_seq_forward_train(const float* xs, const float* mask,
                                     const float* wg, const float* w_s,
                                     const float* h0, float* ys, float* hs,
                                     float* gates, float* rh, int ldg, int lds,
                                     int T, int B, int H, void* stream) {
  if (B == 0 || H == 0) return 0;
  const size_t bh = static_cast<size_t>(B) * H;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int t = 0; t < T; ++t) {
    const size_t o = static_cast<size_t>(t) * bh;
    const int err = masked_step(xs + 3 * o, mask + static_cast<size_t>(t) * B,
                                wg, w_s, t ? hs + o - bh : h0, hs + o,
                                gates + 3 * o, rh, ys + o, ldg, lds, B, H, s);
    if (err != 0) return err;
  }
  return 0;
}

// One unmasked GRU step (the cell): out = h_new from x ([B, 3H], bias
// folded) and h ([B, H]). gates ([B, 3H]) and rh ([B, H]) are scratch. Two
// launches; same error contract as gru_seq_forward.
extern "C" int gru_cell_forward(const float* x, const float* h,
                                const float* wg, const float* w_s,
                                float* gates, float* rh, float* out, int ldg,
                                int lds, int B, int H, void* stream) {
  if (B == 0 || H == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid = grid_of(B, H);
  gru_gate_kernel<<<grid, kThreads, 0, s>>>(x, h, wg, gates, rh, ldg, B, H);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gru_state_kernel<false><<<grid, kThreads, 0, s>>>(
      x, rh, w_s, nullptr, h, gates, out, nullptr, lds, B, H);
  return static_cast<int>(cudaGetLastError());
}

// The two halves of one backward step (see gru_bwd_gate_kernel and
// gru_bwd_reset_kernel); the wrapper runs the products between and after
// them. Same launch and error contract as gru_seq_forward.
extern "C" int gru_bwd_gate(const float* dy_t, const float* mask_t,
                            const float* gates_t, const float* h_pv,
                            float* dh, float* dxs_t, int B, int H,
                            void* stream) {
  if (B == 0 || H == 0) return 0;
  gru_bwd_gate_kernel<<<bwd_blocks(B, H), kBwdThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      dy_t, mask_t, gates_t, h_pv, dh, dxs_t, B, H);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gru_bwd_reset(const float* drh, const float* gates_t,
                             const float* h_pv, float* dh, float* dxs_t,
                             int B, int H, void* stream) {
  if (B == 0 || H == 0) return 0;
  gru_bwd_reset_kernel<<<bwd_blocks(B, H), kBwdThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      drh, gates_t, h_pv, dh, dxs_t, B, H);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------
// The persistent route: one cooperative launch per sequence or chain.

namespace {

constexpr int kTileRows = 4;      // rows of a thread's product tile
constexpr int kTileCols = 4;      // columns (gate columns of units)
constexpr int kMaxSlices = 32;    // K slices of one tile

// The K slices each product tile is split into: the threads left over by
// the tiles, rounded down to a power of two (a tile's slices are
// neighbouring lanes of one warp), at most kMaxSlices; 0 if the tiles
// outnumber the threads.
__host__ __device__ inline int slices_of(int B, int nc) {
  const int tiles = ((B + kTileRows - 1) / kTileRows) *
                    ((nc + kTileCols - 1) / kTileCols);
  if (tiles > kPThreads) return 0;
  int s = 1;
  while (2 * s <= kMaxSlices && 2 * s * tiles <= kPThreads) s *= 2;
  return s;
}

// Floats of what a block keeps of its own units: the forward's z and h
// carries and, double-buffered a step ahead, its x columns and the mask;
// the backward's dh carry and, likewise, its gate, h_prev and dy columns
// and the mask.
__host__ __device__ inline int own_floats(int B, int U, bool backward) {
  return backward ? B * U + 2 * (5 * B * U + B)
                  : 2 * B * U + 2 * (3 * B * U + B);
}

// Floats of the staging area for products over up to K columns in
// chunks of kc: one buffer of the whole width where kc covers it (every
// copy in flight at once), else two of kc (double-buffered).
__host__ __device__ inline long long stage_floats(int B, int K, int kc) {
  return kc >= K ? 1LL * B * K : 2LL * B * kc;
}

// Shared-memory bytes of a persistent block: resident weights, the
// staging area and what it keeps of its own units.
__host__ __device__ inline long long persistent_smem(int B, int H, int U,
                                                     int kc, bool backward) {
  return 4LL * (3LL * U * H + stage_floats(B, H, kc) +
                own_floats(B, U, backward));
}

// acc(b, c) = sum_{k < K} a[b * lda + k] * w[c * ldw + k] for b < B and
// c < nc, with a in global memory and w resident in shared memory;
// epi(b, c, acc) once for each (b, c), by one thread. Where kc >= K the
// whole width is staged at once (one copy group; splitting it into groups
// summed as they land measured slower on the H100), else in
// double-buffered chunks of equal width <= kc. Each thread sums a
// kTileRows x kTileCols tile over the float4 groups q = s, s + ks, ... of
// its slice s of each chunk; the slices' partials are added by
// a butterfly across the tile's lanes. Every thread of the block calls
// it; it ends with the block synchronised.
template <class Epi>
__device__ __forceinline__ void block_product(
    const float* __restrict__ a, size_t lda, int K,
    const float* __restrict__ w, int ldw, int nc, int B, int kc,
    float* stage, Epi epi) {
  const int nrt = (B + kTileRows - 1) / kTileRows;
  const int ks = slices_of(B, nc);
  const int items = nrt * ((nc + kTileCols - 1) / kTileCols) * ks;
  const int s = threadIdx.x % ks;
  const int tile = threadIdx.x / ks;
  const int rt = tile % nrt, ct = tile / nrt;
  const bool active = static_cast<int>(threadIdx.x) < items;
  int rows[kTileRows], cols[kTileCols];
#pragma unroll
  for (int r = 0; r < kTileRows; ++r) rows[r] = min(rt * kTileRows + r, B - 1);
#pragma unroll
  for (int c = 0; c < kTileCols; ++c)
    cols[c] = min(ct * kTileCols + c, nc - 1);
  float acc[kTileRows][kTileCols];
#pragma unroll
  for (int r = 0; r < kTileRows; ++r) {
#pragma unroll
    for (int c = 0; c < kTileCols; ++c) acc[r][c] = 0.0f;
  }
  // columns [k0, k0 + wk) of a, staged at buf[b * ld + k - k0]
  auto sum_tile = [&](const float* buf, int ld, int k0, int wk) {
    for (int q = s; q < wk / 4; q += ks) {
      float4 hv[kTileRows], wv[kTileCols];
#pragma unroll
      for (int r = 0; r < kTileRows; ++r)
        hv[r] = *reinterpret_cast<const float4*>(buf + rows[r] * ld + 4 * q);
#pragma unroll
      for (int c = 0; c < kTileCols; ++c)
        wv[c] = *reinterpret_cast<const float4*>(
            w + static_cast<size_t>(cols[c]) * ldw + k0 + 4 * q);
#pragma unroll
      for (int r = 0; r < kTileRows; ++r) {
#pragma unroll
        for (int c = 0; c < kTileCols; ++c) {
          float v = acc[r][c];
          v = fmaf(hv[r].x, wv[c].x, v);
          v = fmaf(hv[r].y, wv[c].y, v);
          v = fmaf(hv[r].z, wv[c].z, v);
          v = fmaf(hv[r].w, wv[c].w, v);
          acc[r][c] = v;
        }
      }
    }
  };
  if (K <= kc) {
    stage_chunk(a, lda, 0, K, B, K, stage);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (active) sum_tile(stage, K, 0, K);
  } else {
    // nch chunks of (nearly) equal width cw <= kc
    const int nch = (K + kc - 1) / kc;
    const int cw = 4 * ((K / 4 + nch - 1) / nch);
    stage_chunk(a, lda, 0, cw, B, cw, stage);
    cp_async_commit();
    for (int ch = 0; ch < nch; ++ch) {
      const int k0 = ch * cw;
      if (ch + 1 < nch) {
        stage_chunk(a, lda, k0 + cw, min(cw, K - k0 - cw), B, cw,
                    stage + ((ch + 1) & 1) * B * cw);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      if (active) sum_tile(stage + (ch & 1) * B * cw, cw, k0, min(cw, K - k0));
      __syncthreads();
    }
  }
  // the slices of a tile are ks neighbouring lanes: a butterfly leaves
  // every one of them the same sum (each addition is a + b on both
  // sides), in an order fixed by ks; lane s then finishes the tile's
  // outputs r * kTileCols + c = s (mod ks)
  // (each level's 16 shuffles are independent: they pipeline)
  for (int off = ks / 2; off > 0; off /= 2) {
#pragma unroll
    for (int r = 0; r < kTileRows; ++r) {
#pragma unroll
      for (int c = 0; c < kTileCols; ++c)
        acc[r][c] += __shfl_xor_sync(0xffffffffu, acc[r][c], off);
    }
  }
  // one call site of epi (inlined once, not per tile entry)
#pragma unroll 1
  for (int idx = s; idx < kTileRows * kTileCols; idx += ks) {
    float v = 0.0f;
#pragma unroll
    for (int r = 0; r < kTileRows; ++r) {
#pragma unroll
      for (int c = 0; c < kTileCols; ++c) {
        if (r * kTileCols + c == idx) v = acc[r][c];
      }
    }
    const int b = rt * kTileRows + idx / kTileCols;
    const int cc = ct * kTileCols + idx % kTileCols;
    if (active && b < B && cc < nc) epi(b, cc, v);
  }
  __syncthreads();
}

// The forward sequence, one launch. kResidual: writes hs and gates (h
// unused); otherwise the state ping-pongs in h [2, B, H] (h[0] = h0 on
// entry, h[T % 2] = hT on return; hs, gates unused).
template <bool kResidual>
__global__ void __launch_bounds__(kPThreads, 1) gru_persistent_kernel(
    const float* __restrict__ xs,    // [T, B, 3H], bias folded
    const float* __restrict__ mask,  // [T, B]
    const float* __restrict__ wg,    // [H, 2H], leading dim ldg
    const float* __restrict__ w_s,   // [H, H], leading dim lds
    const float* __restrict__ h0,    // [B, H]
    float* h, float* __restrict__ ys, float* hs, float* __restrict__ gates,
    float* rh, unsigned* count, int ldg, int lds, int T, int B, int H, int U,
    int kc) {
  extern __shared__ float4 smem4[];
  float* const sm = reinterpret_cast<float*>(smem4);
  const int u0 = blockIdx.x * U;
  const int up = min(U, H - u0);
  float* const wa = sm;                      // [2 up][H]: z, r columns
  float* const wb = wa + 2 * U * H;          // [up][H]: c columns
  float* const stage = wb + U * H;           // [B][H] or [2][B][kc]
  float* const z_own = stage + stage_floats(B, H, kc);  // [B][U]
  float* const h_own = z_own + B * U;           // [B][U]
  float* const x_own = h_own + B * U;  // [2][B][3U]: x of the units
  float* const m_own = x_own + 6 * B * U;       // [2][B]
  const size_t bh = static_cast<size_t>(B) * H;
  const size_t H3 = 3 * static_cast<size_t>(H);
  // the x columns of the block's units and the mask of step t, into
  // buffer t & 1 (read-only inputs: a step ahead, through L1)
  auto prefetch = [&](int t) {
    const float* x_t = xs + static_cast<size_t>(t) * B * H3;
    float* xb = x_own + (t & 1) * 3 * B * U;
    for (int i = threadIdx.x; i < 3 * B * up; i += kPThreads) {
      const int b = i / (3 * up), cu = i % (3 * up);
      const int g = cu / up, u = cu % up;
      cp_async4(xb + b * 3 * U + g * U + u, x_t + b * H3 + g * H + u0 + u);
    }
    for (int b = threadIdx.x; b < B; b += kPThreads)
      cp_async4(m_own + (t & 1) * B + b,
                mask + static_cast<size_t>(t) * B + b);
  };

  for (int i = threadIdx.x; i < 2 * up * H; i += kPThreads) {
    const int k = i / (2 * up), cu = i % (2 * up);
    const int g = cu / up, u = cu % up;
    cp_async4(wa + cu * H + k,
              wg + static_cast<size_t>(k) * ldg + g * H + u0 + u);
  }
  for (int i = threadIdx.x; i < up * H; i += kPThreads) {
    const int k = i / up, u = i % up;
    cp_async4(wb + u * H + k, w_s + static_cast<size_t>(k) * lds + u0 + u);
  }
  prefetch(0);
  cp_async_commit();
  for (int i = threadIdx.x; i < B * up; i += kPThreads) {
    const int b = i / up, u = i % up;
    h_own[b * U + u] = h0[b * H + u0 + u];
  }
  cp_async_wait<0>();
  __syncthreads();

  unsigned arrivals = 0;
  for (int t = 0; t < T; ++t) {
    const float* h_prev =
        kResidual ? (t ? hs + (t - 1) * bh : h0) : h + (t & 1) * bh;
    const float* xb = x_own + (t & 1) * 3 * B * U;
    const float* mb = m_own + (t & 1) * B;
    float* g_t = kResidual ? gates + static_cast<size_t>(t) * B * H3
                           : nullptr;
    if (t + 1 < T) {
      prefetch(t + 1);
      cp_async_commit();
    }
    block_product(h_prev, H, H, wa, H, 2 * up, B, kc, stage,
                  [&](int b, int c, float acc) {
                    const int g = c >= up, u = c - g * up, j = u0 + u;
                    const float v =
                        sigmoid_f(xb[b * 3 * U + g * U + u] + acc);
                    if (g == 0) {
                      z_own[b * U + u] = v;
                    } else {
                      rh[b * H + j] = v * h_own[b * U + u];
                    }
                    if (kResidual) g_t[b * H3 + g * H + j] = v;
                  });
    arrivals += gridDim.x;
    grid_barrier(count, arrivals);
    block_product(rh, H, H, wb, H, up, B, kc, stage,
                  [&](int b, int u, float acc) {
                    const int j = u0 + u;
                    const float c = tanhf(xb[b * 3 * U + 2 * U + u] + acc);
                    const float hp = h_own[b * U + u];
                    const float z = z_own[b * U + u];
                    const float h_new = (hp - z * hp) + z * c;
                    const float m = mb[b];
                    const float hn = m > 0.0f ? h_new : hp;
                    h_own[b * U + u] = hn;
                    const size_t o = static_cast<size_t>(t) * bh +
                                     static_cast<size_t>(b) * H + j;
                    ys[o] = h_new * m;
                    if (kResidual) {
                      hs[o] = hn;
                      g_t[b * H3 + 2 * H + j] = c;
                    } else {
                      h[((t + 1) & 1) * bh + b * H + j] = hn;
                    }
                  });
    if (t + 1 < T) {
      arrivals += gridDim.x;
      grid_barrier(count, arrivals);
    }
  }
}

// The backward's reverse chain, one launch: dxs [T, B, 3H] and dh0 from
// the residuals (hs, gates), the cotangents dys and dhT. Block p holds the
// rows of Wg (2H) and Ws (H) of its units and their dh carry.
__global__ void __launch_bounds__(kPThreads, 1) gru_bwd_chain_kernel(
    const float* __restrict__ dys,    // [T, B, H]
    const float* __restrict__ mask,   // [T, B]
    const float* __restrict__ gates,  // [T, B, 3H]: z, r, c
    const float* __restrict__ h0,     // [B, H]
    const float* __restrict__ hs,     // [T, B, H]
    const float* __restrict__ wg,     // [H, 2H], leading dim ldg
    const float* __restrict__ w_s,    // [H, H], leading dim lds
    const float* __restrict__ dhT,    // [B, H]
    float* dxs, float* __restrict__ dh0, unsigned* count, int ldg, int lds,
    int T, int B, int H, int U, int kc) {
  extern __shared__ float4 smem4[];
  float* const sm = reinterpret_cast<float*>(smem4);
  const int u0 = blockIdx.x * U;
  const int up = min(U, H - u0);
  float* const w2 = sm;                    // [up][H]: rows of Ws
  float* const w3 = w2 + U * H;            // [up][2H]: rows of Wg
  float* const stage = w3 + 2 * U * H;     // [B][H] or [2][B][kc]
  float* const dh = stage + stage_floats(B, H, kc);  // [B][U]
  // [2][B][5U]: z, r, c, h_prev and dy of the block's units
  float* const in_own = dh + B * U;
  float* const m_own = in_own + 10 * B * U;  // [2][B]
  const size_t bh = static_cast<size_t>(B) * H;
  const size_t H3 = 3 * static_cast<size_t>(H);
  // the inputs of reverse step t for the block's units, into buffer t & 1
  // (read-only: a step ahead, through L1)
  auto prefetch = [&](int t) {
    const float* g_t = gates + static_cast<size_t>(t) * B * H3;
    const float* h_pv = t ? hs + (t - 1) * bh : h0;
    const float* dy = dys + static_cast<size_t>(t) * bh;
    float* ib = in_own + (t & 1) * 5 * B * U;
    for (int i = threadIdx.x; i < 5 * B * up; i += kPThreads) {
      const int b = i / (5 * up), cu = i % (5 * up);
      const int g = cu / up, u = cu % up, j = u0 + u;
      const float* src = g < 3 ? g_t + b * H3 + g * H + j
                               : (g == 3 ? h_pv : dy) + b * H + j;
      cp_async4(ib + b * 5 * U + g * U + u, src);
    }
    for (int b = threadIdx.x; b < B; b += kPThreads)
      cp_async4(m_own + (t & 1) * B + b,
                mask + static_cast<size_t>(t) * B + b);
  };

  for (int i = threadIdx.x; i < up * H; i += kPThreads) {
    const int u = i / H, k = i % H;
    cp_async4(w2 + i, w_s + static_cast<size_t>(u0 + u) * lds + k);
  }
  for (int i = threadIdx.x; i < up * 2 * H; i += kPThreads) {
    const int u = i / (2 * H), k = i % (2 * H);
    cp_async4(w3 + i, wg + static_cast<size_t>(u0 + u) * ldg + k);
  }
  prefetch(T - 1);
  cp_async_commit();
  for (int i = threadIdx.x; i < B * up; i += kPThreads) {
    const int b = i / up, u = i % up;
    dh[b * U + u] = dhT[b * H + u0 + u];
  }
  cp_async_wait<0>();
  __syncthreads();

  unsigned arrivals = 0;
  for (int t = T - 1; t >= 0; --t) {
    const float* ib = in_own + (t & 1) * 5 * B * U;
    const float* mb = m_own + (t & 1) * B;
    float* dx_t = dxs + static_cast<size_t>(t) * B * H3;
    if (t > 0) {
      prefetch(t - 1);
      cp_async_commit();
    }
    // 1. the block's units, elementwise
    for (int i = threadIdx.x; i < B * up; i += kPThreads) {
      const int b = i / up, u = i % up, j = u0 + u;
      const float* in = ib + b * 5 * U;
      const float m = mb[b];
      const float z = in[u];
      const float c = in[2 * U + u];
      const float hp = in[3 * U + u];
      const float d = dh[b * U + u];
      const float dh_new = m * (d + in[4 * U + u]);
      const float dz = dh_new * (c - hp);
      dx_t[b * H3 + 2 * H + j] = (dh_new * z) * (1.0f - c * c);
      dx_t[b * H3 + j] = (dz * z) * (1.0f - z);
      dh[b * U + u] = (1.0f - m) * d + dh_new * (1.0f - z);
    }
    arrivals += gridDim.x;
    grid_barrier(count, arrivals);
    // 2. drh = da_c @ Ws^T for the block's units; da_r; + drh * r
    block_product(dx_t + 2 * H, H3, H, w2, H, up, B, kc, stage,
                  [&](int b, int u, float drh) {
                    const int j = u0 + u;
                    const float* in = ib + b * 5 * U;
                    const float r = in[U + u];
                    const float dr = drh * in[3 * U + u];
                    dx_t[b * H3 + H + j] = (dr * r) * (1.0f - r);
                    dh[b * U + u] = dh[b * U + u] + drh * r;
                  });
    // 3. + da_z @ Wg[:, :H]^T (every da_z is out since the barrier
    // above), then, once every block has written its da_r,
    // + da_r @ Wg[:, H:]^T
    arrivals += gridDim.x;
    grid_arrive(count);
    block_product(dx_t, H3, H, w3, 2 * H, up, B, kc, stage,
                  [&](int b, int u, float p) {
                    dh[b * U + u] = dh[b * U + u] + p;
                  });
    grid_wait(count, arrivals);
    block_product(dx_t + H, H3, H, w3 + H, 2 * H, up, B, kc, stage,
                  [&](int b, int u, float p) {
                    dh[b * U + u] = dh[b * U + u] + p;
                  });
  }
  for (int i = threadIdx.x; i < B * up; i += kPThreads) {
    const int b = i / up, u = i % up;
    dh0[b * H + u0 + u] = dh[b * U + u];
  }
}

bool bad_plan(int B, int H, int U, int kc) {
  return B < 1 || H < 4 || H % 4 != 0 || U < 1 || kc < 4 || kc % 4 != 0 ||
         slices_of(B, 2 * U) == 0;
}

}  // namespace

// Shared-memory bytes of a persistent block (backward != 0: the chain's),
// as the launchers compute them; the wrapper's route mirrors it.
extern "C" long long gru_persistent_smem(int B, int H, int U, int kc,
                                         int backward) {
  return persistent_smem(B, H, U, kc, backward != 0);
}

// The forward sequence on the persistent route: one cooperative launch of
// ceil(H / U) blocks, U units each, staging chunks of kc floats (a
// multiple of 4; H % 4 == 0). residual != 0: the residual form (ys, hs,
// gates from h0; h unused), else the primal form (h [2, B, H] with
// h[0] = h0; hT in h[T % 2]). rh ([B, H]) and count (one unsigned, zeroed
// here on the stream) are scratch. Returns 0, a CUDA error, -1/-2/-3 (see
// launch_cooperative) or -4 (a plan the kernel does not take).
extern "C" int gru_seq_forward_persistent(
    const float* xs, const float* mask, const float* wg, const float* w_s,
    const float* h0, float* h, float* ys, float* hs, float* gates, float* rh,
    unsigned* count, int residual, int ldg, int lds, int T, int B, int H,
    int U, int kc, void* stream) {
  if (T == 0 || B == 0 || H == 0) return 0;
  if (bad_plan(B, H, U, kc)) return -4;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(count, 0, sizeof(unsigned), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&xs, &mask, &wg, &w_s, &h0, &h, &ys, &hs, &gates, &rh,
                  &count, &ldg, &lds, &T, &B, &H, &U, &kc};
  const int grid = (H + U - 1) / U;
  const long long smem = persistent_smem(B, H, U, kc, false);
  return residual
             ? launch_cooperative(
                   (const void*)gru_persistent_kernel<true>,
                   grid, smem, args, s)
             : launch_cooperative(
                   (const void*)gru_persistent_kernel<false>,
                   grid, smem, args, s);
}

// The backward's reverse chain on the persistent route: dxs ([T, B, 3H])
// and dh0 ([B, H]) from the residuals of the forward. Same plan, scratch
// and error contract as gru_seq_forward_persistent.
extern "C" int gru_bwd_chain_launch(const float* dys, const float* mask,
                                    const float* gates, const float* h0,
                                    const float* hs, const float* wg,
                                    const float* w_s, const float* dhT,
                                    float* dxs, float* dh0, unsigned* count,
                                    int ldg, int lds, int T, int B, int H,
                                    int U, int kc, void* stream) {
  if (B == 0 || H == 0) return 0;
  if (bad_plan(B, H, U, kc)) return -4;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T == 0) {
    return static_cast<int>(cudaMemcpyAsync(
        dh0, dhT, sizeof(float) * B * H, cudaMemcpyDeviceToDevice, s));
  }
  cudaError_t err = cudaMemsetAsync(count, 0, sizeof(unsigned), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&dys, &mask, &gates, &h0,  &hs,  &wg, &w_s, &dhT, &dxs,
                  &dh0, &count, &ldg, &lds, &T, &B, &H, &U, &kc};
  return launch_cooperative(
      (const void*)gru_bwd_chain_kernel,
      (H + U - 1) / U, persistent_smem(B, H, U, kc, true), args, s);
}

// ---------------------------------------------------------------------
// The bf16 forms: the persistent route's phases, the recurrent products
// on the tensor cores (mma.sync m16n8k16, bf16 operands, f32 sums), as
// csrc/lstm_seq.cu's bf16 forms. They replace, at bf16, the same TPU
// kernel (its bf16 semantics: the reference's scan gru_sequence_ref,
// paddle_tpu/ops/gru.py:33, and its jax.vjp).
//
// Forward (gru_bf16_kernel): block p owns the units [p U, p U + U) (U
// even) and holds, for the whole launch, bf16 rows of ld + 8 elements
// (ld = H rounded up to 16, zero columns past H; the 16-byte pad puts the
// 8 rows an ldmatrix reads in 8 bank groups): the z and r columns of Wg
// of its units (rows g U8 + u, U8 = U rounded up to whole n8 tiles, zero
// rows past the block's units) and the c columns of Ws (rows 2 U8 + u).
// The state crosses blocks as the bf16 values it is: h_t through the
// exchange hx (slot t holds h_t, h0 in slot 0; [T + 1][B][ld] in the
// residual form, whose slots 1 .. T are hs, [2][B][ld] in the primal
// form) and r * h_{t-1} through rhx [B][ld]. A step is
//   A. h_{t-1} @ Wg[:, own z, r columns]; z, r = sigmoid(x + product),
//      r * h_{t-1} into rhx; grid barrier;
//   B. rhx @ Ws[:, own c columns]; c = tanh(x + product), h_t = h - z h +
//      z c, the mask guard, h_t into hx, ys; grid barrier.
// The barrier's halves are persistent.cuh's arrive_rel / wait_acq (one
// red.release, an ld.acquire spin). Per-block flags polled by each warp
// for the blocks owning its K slice, in place of the barrier, measured
// slower on the H100 (PERF.md, PR 24), as did a ring holding a warp's
// whole K slice.
// A product (bf16_partials): warp kw sums the k16 steps [kw nk / 8, (kw +
// 1) nk / 8) (nk = ld / 16) for the m16 tiles of a group of up to 64 rows
// (MT tiles; a larger batch loops over groups) in the mma's f32
// accumulators, from a ring of kBfSlots k16 chunks of the rows (cp.async
// through L2, the LSTM's swizzle), three chunks ahead; the 8 warps' sums
// meet in shared memory (where the rings were) and each cell adds them in
// warp order, then rounds once. Every rounding point of the reference's
// scan is kept: each product once after that sum, x + the product,
// sigmoid_bf16, r * h, and h - z h + z c term by term; ys takes that last
// sum unrounded. The block's own x columns and the mask come a step ahead
// by 4-byte cp.async (two bf16 units a copy: U and H even), issued before
// the step's last barrier.
//
// Chain (gru_bf16_chain_kernel): the f32 chain's phases, roundings and
// order of sums (1. elementwise, da_z and da_c out; 2. drh = da_c @ Ws^T,
// da_r out; 3a. + da_z @ Wg[:, :H]^T; 3b. + da_r @ Wg[:, H:]^T), the
// three products on the mma as above from the rows of Ws and Wg of the
// block's units (rows u, U8 + u, 2 U8 + u: Ws[j, :], Wg[j, :H], Wg[j, H:]),
// two grid barriers a step as the f32 chain's (after 1; arrive after 2,
// wait before 3b).
// da_z, da_r and da_c cross blocks as the bf16 values they are through
// the exchange dax [2][3][B][ld] (by the step's parity: a block writing
// step t's has read every block's da_r of step t + 1, so every block is
// past step t + 2's reads), beside the dxs it returns; the own inputs (z,
// r, c, h_{t-1} bf16, dy f32, the mask) come a step ahead as in the
// forward. No atomics: two runs give the same bits.
//
// What bounds them: the products are 2 B H 3H operations a step (the
// chain's 6 B H^2), 0.0407 ms at B = 16, H = 1024, T = 400 at 989.4
// TFLOP/s; a step's two grid barriers and its two exchanges through L2
// are its latency, and a block's share of the products (its units) runs
// serially on its SM's tensor cores. bf16 halves the resident weights,
// so a block could own twice the f32 forms' units (fewer blocks at each
// barrier, twice the products a block): at (16, 1024) 8 units a block
// measured faster than 16 (PERF.md, PR 24), so gru_plan(..., bf16=True)
// keeps 8 where they fit and never fewer than the f32 plan's units
// (ceil(H / 132), at most 12 on the f32 route): U <= kBfMaxUnits = 16.

namespace {

constexpr int kBfSlots = 4;  // a warp's ring of k16 chunks
constexpr int kBfWarps = kPThreads / 32;
constexpr int kBfMaxUnits = 16;

// The exchanges' row stride, bf16 elements: H rounded up to the mma's k.
__host__ __device__ inline int bf16_ld(int H) { return (H + 15) / 16 * 16; }

// m16 tiles of a product's row group as the batch asks (1, 2, 4: up to
// 64 rows a group).
__host__ __device__ inline int batch_mtiles(int B) {
  return B <= 16 ? 1 : B <= 32 ? 2 : 4;
}

// n8 tiles of a block's U units (1, 2).
__host__ __device__ inline int bf16_ntiles(int U) {
  return U <= 8 ? 1 : 2;
}

// Row stride (floats) of a warp's sums: 8 per n8 tile, plus 8 for an even
// count, so that the float2 stores of a half-warp hit 32 banks.
__host__ __device__ constexpr int sums_ld(int nt) {
  return 8 * nt + (nt % 2 ? 0 : 8);
}

// Shared-memory bytes of a bf16 block at mt m16 tiles a row group: the
// 3 U8 resident weight rows of ld + 8 bf16, the warps' rings ([8]
// [kBfSlots][16 mt][16] bf16), which then hold their sums ([8][16 mt]
// [sums_ld(2 NT)] f32), and what it keeps of its own units: forward, the
// h and z carries (f32), the mask and the x columns (bf16), both
// double-buffered; backward, the dh carry (f32) and, double-buffered, dy
// and the mask (f32) and z, r, c, h_{t-1} (bf16).
__host__ __device__ inline long long tiles_smem(int B, int H, int U, int mt,
                                                bool backward) {
  const int nt = bf16_ntiles(U);
  const long long w = 2LL * 3 * 8 * nt * (bf16_ld(H) + 8);
  const long long ring = 2LL * kBfWarps * kBfSlots * 16 * mt * 16;
  const long long sums = 4LL * kBfWarps * 16 * mt * sums_ld(2 * nt);
  const long long bu = 1LL * B * U;
  const long long own = backward ? 4 * bu + 2 * (4 * bu + 4LL * B + 8 * bu)
                                 : 8 * bu + 2 * (4LL * B + 6 * bu);
  return w + (ring > sums ? ring : sums) + own;
}

// m16 tiles of a product's row group: the batch's, fewer where both
// blocks would not fit the card's limit at it.
__host__ __device__ inline int bf16_mtiles(int B, int H, int U) {
  int mt = batch_mtiles(B);
  while (mt > 1 && tiles_smem(B, H, U, mt, true) > kSmemLimit) mt /= 2;
  return mt;
}

__host__ __device__ inline long long bf16_smem(int B, int H, int U,
                                               bool backward) {
  return tiles_smem(B, H, U, bf16_mtiles(B, H, U), backward);
}

// v = s[0] + s[stride] + ... over the 8 warps, in warp order
__device__ __forceinline__ float warp_order_sum(const float* s, int stride) {
  float v = s[0];
#pragma unroll
  for (int kw = 1; kw < kBfWarps; ++kw) v += s[kw * stride];
  return v;
}

// The 8 warps' partial sums of rows [r0, r0 + rows) of a (bf16, row
// stride lda, ld columns, zero past H) times the block's NTP n8 tiles of
// resident rows w (stride lw) over each warp's k16 steps, into sums[kw]
// [r - r0][c] (row stride SL). Every thread calls it; it ends with the
// block synchronised, the sums in place of the rings (every cp.async of
// the thread done).
template <int MT, int NTP>
__device__ __forceinline__ void bf16_partials(const bf16* a, size_t lda,
                                              int r0, int rows,
                                              const bf16* w, int lw, int ld,
                                              bf16* rings, float* sums,
                                              int SL) {
  constexpr int ROWS = 16 * MT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g8 = lane / 4, t4 = lane % 4;
  // the warp's k16 steps [q0, q1); block p starts at step p % nq, so that
  // the blocks read different lines of L2 at a time
  const int nk = ld / 16;
  const int q0 = warp * nk / kBfWarps, q1 = (warp + 1) * nk / kBfWarps;
  const int nq = q1 - q0;
  const int first = nq > 0 ? blockIdx.x % nq : 0;
  bf16* const ring = rings + warp * kBfSlots * ROWS * 16;
  float acc[MT][NTP][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NTP; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.f;
  if (nq > 0) {
    // chunk i of the ring: k16 step q0 + (first + i) % nq of the rows; a
    // row's 16-byte half hh at 8 (hh ^ bit 2 of the row)
    auto issue = [&](int i) {
      const int q = q0 + (first + i) % nq;
      bf16* dst = ring + (i % kBfSlots) * ROWS * 16;
      for (int c = lane; c < 2 * rows; c += 32) {
        const int r = c / 2, hh = c % 2;
        cp_async16(dst + r * 16 + 8 * (hh ^ ((r >> 2) & 1)),
                   a + static_cast<size_t>(r0 + r) * lda + 16 * q + 8 * hh);
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
      unsigned af[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int r = mt * 16 + (lane & 15), hh = lane >> 4;
        ldsm_x4(af[mt], slot + r * 16 + 8 * (hh ^ ((r >> 2) & 1)));
      }
#pragma unroll
      for (int nt = 0; nt < NTP; ++nt) {
        unsigned bf[2];
        ldsm_x2(bf, w + (nt * 8 + (lane & 7)) * lw + 16 * q +
                        8 * ((lane >> 3) & 1));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_add(acc[mt][nt], af[mt], bf);
      }
      __syncwarp();
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every ring read: the sums take their place
  float* const own = sums + warp * ROWS * SL;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NTP; ++nt) {
      float* o = own + (mt * 16 + g8) * SL + nt * 8 + 2 * t4;
      *reinterpret_cast<float2*>(o) =
          make_float2(acc[mt][nt][0], acc[mt][nt][1]);
      *reinterpret_cast<float2*>(o + 8 * SL) =
          make_float2(acc[mt][nt][2], acc[mt][nt][3]);
    }
  __syncthreads();
}

template <bool kResidual, int MT, int NT>
__global__ void __launch_bounds__(kPThreads, 1) gru_bf16_kernel(
    const bf16* __restrict__ xs,     // [T, B, 3H], bias folded
    const float* __restrict__ mask,  // [T, B]
    const bf16* __restrict__ wg,     // [H, 2H], leading dim ldg
    const bf16* __restrict__ w_s,    // [H, H], leading dim lds
    bf16* hx,                        // [T + 1 or 2, B, ld]: h0 in slot 0
    bf16* rhx,                       // [B, ld]
    float* __restrict__ ys,          // [T, B, H]
    bf16* __restrict__ gates,        // [T, B, 3H] (residual form)
    unsigned* count, int ldg, int lds, int T, int B, int H, int U) {
  using St = Store<bf16>;
  constexpr int U8 = 8 * NT, ROWS = 16 * MT, SL = sums_ld(2 * NT);
  extern __shared__ float4 smem4[];
  const int ld = bf16_ld(H), lw = ld + 8;
  bf16* const wa = reinterpret_cast<bf16*>(smem4);  // [2 U8][lw]: z, r
  bf16* const wb = wa + 2 * U8 * lw;                // [U8][lw]: c
  bf16* const rings = wb + U8 * lw;
  float* const sums = reinterpret_cast<float*>(rings);
  constexpr int kRing = 2 * kBfWarps * kBfSlots * ROWS * 16;
  constexpr int kSums = 4 * kBfWarps * ROWS * SL;
  float* const h_own = reinterpret_cast<float*>(
      reinterpret_cast<char*>(rings) + (kRing > kSums ? kRing : kSums));
  float* const z_own = h_own + B * U;           // [B][U]
  float* const m_own = z_own + B * U;           // [2][B]
  bf16* const x_own = reinterpret_cast<bf16*>(m_own + 2 * B);  // [2][B][3U]
  const int u0 = blockIdx.x * U;
  const int up = min(U, H - u0);
  const size_t H3 = 3 * static_cast<size_t>(H);
  const size_t bl = static_cast<size_t>(B) * ld;
  const bf16 zero = __float2bfloat16(0.f);
  for (int i = threadIdx.x; i < ld * 3 * U8; i += kPThreads) {
    const int k = i / (3 * U8), n = i % (3 * U8);
    const int g = n / U8, u = n % U8;
    bf16 v = zero;
    if (u < up && k < H)
      v = g < 2 ? wg[static_cast<size_t>(k) * ldg + g * H + u0 + u]
                : w_s[static_cast<size_t>(k) * lds + u0 + u];
    wa[n * lw + k] = v;
  }
  // the x columns of the block's units and the mask of step t, into
  // buffer t & 1 (two units a 4-byte copy)
  auto prefetch = [&](int t) {
    const bf16* x_t = xs + static_cast<size_t>(t) * B * H3;
    bf16* xb = x_own + (t & 1) * 3 * B * U;
    const int hp = up / 2;
    for (int i = threadIdx.x; i < 3 * B * hp; i += kPThreads) {
      const int b = i / (3 * hp), cu = i % (3 * hp);
      const int g = cu / hp, u = 2 * (cu % hp);
      cp_async4(xb + b * 3 * U + g * U + u, x_t + b * H3 + g * H + u0 + u);
    }
    for (int b = threadIdx.x; b < B; b += kPThreads)
      cp_async4(m_own + (t & 1) * B + b,
                mask + static_cast<size_t>(t) * B + b);
  };
  prefetch(0);
  cp_async_commit();
  for (int i = threadIdx.x; i < B * up; i += kPThreads) {
    const int b = i / up, u = i % up;
    h_own[b * U + u] = St::ld(hx + b * ld + u0 + u);
  }
  cp_async_wait<0>();
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const bf16* h_prev = hx + (kResidual ? t : (t & 1)) * bl;
    bf16* h_next = hx + (kResidual ? t + 1 : ((t + 1) & 1)) * bl;
    const bf16* xb = x_own + (t & 1) * 3 * B * U;
    const float* mb = m_own + (t & 1) * B;
    bf16* g_t = kResidual ? gates + static_cast<size_t>(t) * B * H3 : nullptr;
    // A. z, r and r * h_{t-1}
    for (int r0 = 0; r0 < B; r0 += ROWS) {
      const int rows = min(ROWS, B - r0);
      bf16_partials<MT, 2 * NT>(h_prev, ld, r0, rows, wa, lw, ld, rings,
                                sums, SL);
      for (int i = threadIdx.x; i < rows * 2 * up; i += kPThreads) {
        const int b = r0 + i / (2 * up), c = i % (2 * up);
        const int g = c / up, u = c % up, j = u0 + u;
        const float p = warp_order_sum(sums + (b - r0) * SL + g * U8 + u,
                                       ROWS * SL);
        const float v = sigmoid_bf16(
            St::r(St::ld(xb + b * 3 * U + g * U + u) + St::r(p)));
        if (g == 0) {
          z_own[b * U + u] = v;
        } else {
          St::st(rhx + b * ld + j, v * h_own[b * U + u]);
        }
        if (kResidual) St::st(g_t + b * H3 + g * H + j, v);
      }
      __syncthreads();  // the sums read before the rings refill
    }
    arrive_rel(count);
    wait_acq(count, (2 * t + 1) * gridDim.x);
    // B. c and the new state
    for (int r0 = 0; r0 < B; r0 += ROWS) {
      const int rows = min(ROWS, B - r0);
      bf16_partials<MT, NT>(rhx, ld, r0, rows, wb, lw, ld, rings, sums, SL);
      for (int i = threadIdx.x; i < rows * up; i += kPThreads) {
        const int b = r0 + i / up, u = i % up, j = u0 + u;
        const float p = warp_order_sum(sums + (b - r0) * SL + u, ROWS * SL);
        const float xc = St::ld(xb + b * 3 * U + 2 * U + u);
        const float hp = h_own[b * U + u];
        const float z = z_own[b * U + u];
        const float c = St::r(tanhf(St::r(xc + St::r(p))));
        const float y = St::r(hp - St::r(z * hp)) + St::r(z * c);
        const float h_new = St::r(y);
        const float m = mb[b];
        const float hn = m > 0.0f ? h_new : hp;
        h_own[b * U + u] = hn;
        ys[static_cast<size_t>(t) * B * H + static_cast<size_t>(b) * H + j] =
            y * m;
        St::st(h_next + b * ld + j, hn);
        if (kResidual) St::st(g_t + b * H3 + 2 * H + j, c);
      }
      __syncthreads();
    }
    if (t + 1 < T) {
      prefetch(t + 1);
      cp_async_commit();
      arrive_rel(count);
      wait_acq(count, (2 * t + 2) * gridDim.x);
    }
  }
}

template <int MT, int NT>
__global__ void __launch_bounds__(kPThreads, 1) gru_bf16_chain_kernel(
    const float* __restrict__ dys,   // [T, B, H]
    const float* __restrict__ mask,  // [T, B]
    const bf16* __restrict__ gates,  // [T, B, 3H]: z, r, c
    const bf16* __restrict__ h0,     // [B, H]
    const bf16* __restrict__ hs,     // [T, B, H]
    const bf16* __restrict__ wg,     // [H, 2H], leading dim ldg
    const bf16* __restrict__ w_s,    // [H, H], leading dim lds
    const bf16* __restrict__ dhT,    // [B, H]
    bf16* __restrict__ dxs,          // [T, B, 3H]
    bf16* dax,                       // [2][3][B, ld]: da_z, da_r, da_c
    bf16* __restrict__ dh0, unsigned* count, int ldg, int lds, int T, int B,
    int H, int U) {
  using St = Store<bf16>;
  constexpr int U8 = 8 * NT, ROWS = 16 * MT, SL = sums_ld(2 * NT);
  extern __shared__ float4 smem4[];
  const int ld = bf16_ld(H), lw = ld + 8;
  // [3 U8][lw]: Ws[j, :], Wg[j, :H], Wg[j, H:] of the units j
  bf16* const ws = reinterpret_cast<bf16*>(smem4);
  bf16* const rings = ws + 3 * U8 * lw;
  float* const sums = reinterpret_cast<float*>(rings);
  constexpr int kRing = 2 * kBfWarps * kBfSlots * ROWS * 16;
  constexpr int kSums = 4 * kBfWarps * ROWS * SL;
  float* const dh = reinterpret_cast<float*>(
      reinterpret_cast<char*>(rings) + (kRing > kSums ? kRing : kSums));
  float* const dy_own = dh + B * U;                    // [2][B][U]
  float* const m_own = dy_own + 2 * B * U;             // [2][B]
  bf16* const in_own = reinterpret_cast<bf16*>(m_own + 2 * B);  // [2][B][4U]
  const int u0 = blockIdx.x * U;
  const int up = min(U, H - u0);
  const size_t bh = static_cast<size_t>(B) * H;
  const size_t H3 = 3 * static_cast<size_t>(H);
  const size_t bl = static_cast<size_t>(B) * ld;
  const bf16 zero = __float2bfloat16(0.f);
  for (int i = threadIdx.x; i < 3 * U8 * ld; i += kPThreads) {
    const int n = i / ld, k = i % ld;
    const int g = n / U8, u = n % U8, j = u0 + u;
    bf16 v = zero;
    if (u < up && k < H)
      v = g == 0 ? w_s[static_cast<size_t>(j) * lds + k]
                 : wg[static_cast<size_t>(j) * ldg + (g - 1) * H + k];
    ws[n * lw + k] = v;
  }
  // the inputs of reverse step t for the block's units, into buffer t & 1
  // (two bf16 units a 4-byte copy)
  auto prefetch = [&](int t) {
    const bf16* g_t = gates + static_cast<size_t>(t) * B * H3;
    const bf16* h_pv = t ? hs + (t - 1) * bh : h0;
    const float* dy = dys + static_cast<size_t>(t) * bh;
    bf16* ib = in_own + (t & 1) * 4 * B * U;
    float* db = dy_own + (t & 1) * B * U;
    const int hp = up / 2;
    for (int i = threadIdx.x; i < 4 * B * hp; i += kPThreads) {
      const int b = i / (4 * hp), cu = i % (4 * hp);
      const int g = cu / hp, u = 2 * (cu % hp), j = u0 + u;
      cp_async4(ib + b * 4 * U + g * U + u,
                g < 3 ? g_t + b * H3 + g * H + j : h_pv + b * H + j);
    }
    for (int i = threadIdx.x; i < B * up; i += kPThreads) {
      const int b = i / up, u = i % up;
      cp_async4(db + b * U + u, dy + b * H + u0 + u);
    }
    for (int b = threadIdx.x; b < B; b += kPThreads)
      cp_async4(m_own + (t & 1) * B + b,
                mask + static_cast<size_t>(t) * B + b);
  };
  prefetch(T - 1);
  cp_async_commit();
  for (int i = threadIdx.x; i < B * up; i += kPThreads) {
    const int b = i / up, u = i % up;
    dh[b * U + u] = St::ld(dhT + b * H + u0 + u);
  }
  cp_async_wait<0>();
  __syncthreads();

  for (int t = T - 1; t >= 0; --t) {
    const unsigned k = T - 1 - t;  // the steps done before this one
    const bf16* ib = in_own + (t & 1) * 4 * B * U;
    const float* db = dy_own + (t & 1) * B * U;
    const float* mb = m_own + (t & 1) * B;
    bf16* const da = dax + (t & 1) * 3 * bl;  // da_z, da_r, da_c
    bf16* const dx_t = dxs + static_cast<size_t>(t) * B * H3;
    // 1. the block's units, elementwise
    for (int i = threadIdx.x; i < B * up; i += kPThreads) {
      const int b = i / up, u = i % up, j = u0 + u;
      const bf16* in = ib + b * 4 * U;
      const float m = mb[b];
      const float z = St::ld(in + u);
      const float c = St::ld(in + 2 * U + u);
      const float hp = St::ld(in + 3 * U + u);
      const float d = dh[b * U + u];
      const float dh_new = m * (d + St::r(db[b * U + u]));
      const float dz = dh_new * (c - hp);
      const float da_c = St::r((dh_new * z) * (1.0f - c * c));
      const float da_z = St::r((dz * z) * (1.0f - z));
      St::st(da + 2 * bl + b * ld + j, da_c);
      St::st(da + b * ld + j, da_z);
      St::st(dx_t + b * H3 + 2 * H + j, da_c);
      St::st(dx_t + b * H3 + j, da_z);
      dh[b * U + u] = (1.0f - m) * d + dh_new * (1.0f - z);
    }
    if (t > 0) {
      prefetch(t - 1);
      cp_async_commit();
    }
    arrive_rel(count);
    wait_acq(count, (2 * k + 1) * gridDim.x);
    // 2. drh = da_c @ Ws^T for the block's units; da_r; + drh * r
    for (int r0 = 0; r0 < B; r0 += ROWS) {
      const int rows = min(ROWS, B - r0);
      bf16_partials<MT, NT>(da + 2 * bl, ld, r0, rows, ws, lw, ld, rings,
                            sums, SL);
      for (int i = threadIdx.x; i < rows * up; i += kPThreads) {
        const int b = r0 + i / up, u = i % up, j = u0 + u;
        const bf16* in = ib + b * 4 * U;
        const float r = St::ld(in + U + u);
        const float drh =
            St::r(warp_order_sum(sums + (b - r0) * SL + u, ROWS * SL));
        const float dr = drh * St::ld(in + 3 * U + u);
        const float da_r = St::r((dr * r) * (1.0f - r));
        St::st(da + bl + b * ld + j, da_r);
        St::st(dx_t + b * H3 + H + j, da_r);
        dh[b * U + u] = dh[b * U + u] + drh * r;
      }
      __syncthreads();
    }
    // 3. + da_z @ Wg[:, :H]^T (every da_z is out since the barrier
    // above), then, once every block has written its da_r,
    // + da_r @ Wg[:, H:]^T
    arrive_rel(count);
    for (int r0 = 0; r0 < B; r0 += ROWS) {
      const int rows = min(ROWS, B - r0);
      bf16_partials<MT, NT>(da, ld, r0, rows, ws + U8 * lw, lw, ld, rings,
                            sums, SL);
      for (int i = threadIdx.x; i < rows * up; i += kPThreads) {
        const int b = r0 + i / up, u = i % up;
        dh[b * U + u] = dh[b * U + u] +
            St::r(warp_order_sum(sums + (b - r0) * SL + u, ROWS * SL));
      }
      __syncthreads();
    }
    wait_acq(count, (2 * k + 2) * gridDim.x);
    for (int r0 = 0; r0 < B; r0 += ROWS) {
      const int rows = min(ROWS, B - r0);
      bf16_partials<MT, NT>(da + bl, ld, r0, rows, ws + 2 * U8 * lw, lw, ld,
                            rings, sums, SL);
      for (int i = threadIdx.x; i < rows * up; i += kPThreads) {
        const int b = r0 + i / up, u = i % up;
        dh[b * U + u] = St::r(dh[b * U + u] + St::r(warp_order_sum(
            sums + (b - r0) * SL + u, ROWS * SL)));
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < B * up; i += kPThreads) {
    const int b = i / up, u = i % up;
    St::st(dh0 + b * H + u0 + u, dh[b * U + u]);
  }
}

bool bad_bf16_plan(int B, int H, int U) {
  return B < 1 || H < 4 || H % 4 != 0 || U < 2 || U % 2 != 0 ||
         U > kBfMaxUnits;
}

// the instance for (m16 tiles, n8 tiles): Fn<MT, NT>::fn()
template <template <int, int> class Fn>
const void* by_tiles(int mt, int nt) {
  switch (4 * mt + nt) {
    case 5: return Fn<1, 1>::fn();
    case 6: return Fn<1, 2>::fn();
    case 9: return Fn<2, 1>::fn();
    case 10: return Fn<2, 2>::fn();
    case 17: return Fn<4, 1>::fn();
    default: return Fn<4, 2>::fn();
  }
}

template <int MT, int NT>
struct BfPrimal {
  static const void* fn() {
    return (const void*)gru_bf16_kernel<false, MT, NT>;
  }
};
template <int MT, int NT>
struct BfResidual {
  static const void* fn() {
    return (const void*)gru_bf16_kernel<true, MT, NT>;
  }
};
template <int MT, int NT>
struct BfChain {
  static const void* fn() {
    return (const void*)gru_bf16_chain_kernel<MT, NT>;
  }
};

}  // namespace

// Shared-memory bytes of a bf16 block (backward != 0: the chain's), as
// the bf16 launchers compute them; the wrapper's plan mirrors it.
extern "C" long long gru_bf16_smem(int B, int H, int U, int backward) {
  return bf16_smem(B, H, U, backward != 0);
}

// The bf16 forward on the persistent route: one cooperative launch of
// ceil(H / U) blocks (U even, at most 16; H % 4 == 0). xs (bias folded),
// the weights (any row strides ldg, lds, columns contiguous) and gates
// bf16; ys f32. hx (bf16, 16-byte aligned) holds h0 in slot 0 and zero
// columns past H (its rows ld = H rounded up to 16 wide): [T + 1, B, ld]
// in the residual form (residual != 0: ys, hx, gates), h_t in slot t on
// return; [2, B, ld] in the primal form (ys, hT in slot T % 2; gates
// unused). rhx ([B, ld] bf16) and count (one unsigned) are scratch,
// zeroed here. Returns 0, a CUDA error, -1/-2/-3 (see launch_cooperative)
// or -4 (a plan the kernel does not take).
extern "C" int gru_bf16_forward(const void* xs, const float* mask,
                                const void* wg, const void* w_s, void* hx,
                                void* rhx, float* ys, void* gates,
                                unsigned* count, int residual, int ldg,
                                int lds, int T, int B, int H, int U,
                                void* stream) {
  if (T == 0 || B == 0 || H == 0) return 0;
  if (bad_bf16_plan(B, H, U)) return -4;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(count, 0, sizeof(unsigned), s);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(rhx, 0, sizeof(bf16) * B * bf16_ld(H), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&xs, &mask, &wg, &w_s, &hx, &rhx, &ys, &gates, &count,
                  &ldg, &lds, &T, &B, &H, &U};
  const int mt = bf16_mtiles(B, H, U), nt = bf16_ntiles(U);
  const void* kernel = residual ? by_tiles<BfResidual>(mt, nt)
                                : by_tiles<BfPrimal>(mt, nt);
  return launch_cooperative(kernel, (H + U - 1) / U,
                            bf16_smem(B, H, U, false), args, s);
}

// The bf16 reverse chain on the persistent route: dxs ([T, B, 3H]) and dh0
// ([B, H]) in bf16 from the bf16 residuals (gates, hs), h0, the weights
// and dhT; dys (the cotangent of the f32 ys) f32. The own inputs are read
// two units a 4-byte copy (h0, hs and gates 4-byte aligned). Scratch: dax
// ([2, 3, B, ld] bf16) and count (one unsigned), both zeroed here.
// Same plan and error contract as gru_bf16_forward.
extern "C" int gru_bf16_chain(const float* dys, const float* mask,
                              const void* gates, const void* h0,
                              const void* hs, const void* wg,
                              const void* w_s, const void* dhT, void* dxs,
                              void* dax, void* dh0, unsigned* count, int ldg,
                              int lds, int T, int B, int H, int U,
                              void* stream) {
  if (B == 0 || H == 0) return 0;
  if (bad_bf16_plan(B, H, U)) return -4;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T == 0) {
    return static_cast<int>(cudaMemcpyAsync(
        dh0, dhT, sizeof(bf16) * B * H, cudaMemcpyDeviceToDevice, s));
  }
  cudaError_t err = cudaMemsetAsync(count, 0, sizeof(unsigned), s);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(dax, 0, sizeof(bf16) * 6 * B * bf16_ld(H), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&dys, &mask, &gates, &h0, &hs, &wg, &w_s, &dhT, &dxs,
                  &dax, &dh0, &count, &ldg, &lds, &T, &B, &H, &U};
  return launch_cooperative(
      by_tiles<BfChain>(bf16_mtiles(B, H, U), bf16_ntiles(U)),
      (H + U - 1) / U,
      bf16_smem(B, H, U, true), args, s);
}

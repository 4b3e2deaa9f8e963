// Masked GRU sequence recurrence and the single GRU step, f32, for Hopper
// (sm_90a): the sequence forward in its primal and its residual (training)
// form, the one-step cell forward, and the backward's per-step chain.
//
// Replaces the TPU kernels paddle_tpu/ops/gru.py:_gru_kernel (both forms;
// Wg [H, 2H] and Ws [H, H] resident in VMEM across the time grid) and
// paddle_tpu/kernels/rnn_cells.py:_gru_cell_kernel (one step, both
// recurrent products inside the kernel). Both compute, with the gate bias
// already folded into x (gate order [update z, reset r, candidate c]):
//
//   z = sigmoid(x_z + h_{t-1} @ Wg[:, :H])
//   r = sigmoid(x_r + h_{t-1} @ Wg[:, H:])
//   c = tanh(x_c + (r * h_{t-1}) @ Ws)
//   h_new = h_{t-1} - z * h_{t-1} + z * c   (JAX's spelling, not (1-z)h + zc)
//   sequence only: mask == 0 holds h (h_t = h_{t-1}), ys[t] = h_new * mask
//
// The primal form (gru_seq_forward) writes ys and the final h. The residual
// form (gru_seq_forward_train) also writes, per step, the guarded hs[t] and
// gates[t] = [z | r | c] (each block H wide), the residuals of _fwd_rule
// (ops/gru.py:129-132); hs doubles as the h buffer (h_{t-1} is hs[t-1], h0
// at t = 0). The cell (gru_cell_forward) is one unmasked step: out = h_new.
//
// Design. The candidate product (r * h) @ Ws needs the reset gate of EVERY
// unit, and r comes from h @ Wg: a step is two dependent products. At
// H = 512, Wg and Ws together are 3 MB, far beyond one SM's 228 KB, so no
// block can hold the weights and run a step alone. Each step is therefore
// two launches on the caller's stream, the launch being the barrier
// between them (no cooperative grid sync):
//   A. gru_gate_kernel: blocks own a tile of kRows batch rows by kUnits
//      units and sum h_{t-1} @ Wg for the z and r columns of their units;
//      they write z and r into gates_t and r * h_{t-1} into a [B, H]
//      scratch (rh).
//   B. gru_state_kernel: the same tiling over rh @ Ws; each thread then has
//      everything its unit needs: c, h_new, the mask guard, ys and the
//      residual c.
// The tile product streams the rows of h (or rh) and the block's weight
// columns through shared memory in chunks of kK and sums in f32
// registers (each thread: kRowsPerThread rows of one unit, every gate
// column the phase needs), as csrc/lstm_seq.cu does.
//
// Strided weights. The layers slice one parameter w0 [H, 3H] into
// Wg = w0[:, :2H] and Ws = w0[:, 2H:]: views whose rows lie 3H apart. The
// kernels take each weight's leading dimension (ldg, lds) and never assume
// a row-major [H, 2H] / [H, H] block; the wrapper checks that the columns
// are contiguous (stride 1) and passes the row stride.
//
// Bound on the H100 (SXM, 700 W): the two products are 2 * B * H * 3H
// operations per step at the f32 rate outside the tensor cores
// (67 TFLOP/s); the bytes are xs, ys (and the residuals) once, plus W once
// per step, which stays in the 50 MB L2 between steps. At B = 50,
// H = 512 a step is 79 MFLOP, about 1.2 us at that rate, against the two
// launches' own latency of a few microseconds: this shape is bound by the
// launches and by how few blocks one tile grid makes (16 x 4 = 64 of 132
// SMs), not by the operations. Not yet done: one persistent cooperative
// kernel per sequence holding W slices in shared memory across steps,
// wgmma on TF32/bf16 tiles, TMA loads.

// Backward step. The JAX backward (_bwd_rule, ops/gru.py:135-166) is a
// reverse-time lax.scan, not a Pallas kernel. Its per-step chain has two
// products in the middle (drh = da_c @ Ws^T, needed by da_r, and
// da_zr @ Wg^T, the last term of dh_prev), so it is two elementwise
// kernels with a cuBLAS product after each, issued by the wrapper:
//   gru_bwd_gate_kernel:  da_z, da_c and the first two terms of dh_prev;
//   (drh = da_c @ Ws^T)
//   gru_bwd_reset_kernel: da_r and the third term (drh * r);
//   (dh_prev += da_zr @ Wg^T)
// Each is bound by bytes: per element of [B, H] the first reads 7 and
// writes 3 floats, the second reads 5 and writes 2, against ~15 and ~5
// operations.
#include <cuda_runtime.h>

#include <cstddef>

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

// Masked peephole-LSTM sequence recurrence, f32, for Hopper (sm_90a):
// the forward in its primal and its residual (training) form, and the
// backward's per-step gate-gradient chain.
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
// The primal form (lstm_seq_forward) writes ys and the final h, c. The
// residual form (lstm_seq_forward_train) also writes, per step, the
// guarded hs[t] and cs[t] and the activated gates[t] = [i | ig | fg | og]
// (gate-major, each block H wide), the residuals of _fwd_rule
// (ops/lstm.py:331-335). hs doubles as the h buffer: h_{t-1} is hs[t-1]
// (h0 at t = 0), and cs likewise for c.
//
// Design. A block owns a tile of kRows batch rows by kUnits hidden units,
// that is the four gate columns of each of its units, so the cell update
// is local to the block. Each step streams h_{t-1}[rows, :] and the
// block's W columns through shared memory in chunks of kK and sums the
// [kRows, 4 * kUnits] gate pre-activations in f32 registers (each thread:
// kRowsPerThread rows of one unit, all four gates), then applies the cell
// and writes h_t, c_t and ys[t] (and the residuals). Blocks of one step
// have no order among them, so the step boundary is the launch: the C
// entries below issue one launch per timestep on the caller's stream (not
// a cooperative grid sync).
//
// Bound on the H100 (SXM, 700 W): the recurrent product is
// 2 * B * H * 4H operations per step, at the f32 rate outside the tensor
// cores (67 TFLOP/s); the bytes are xs and ys once (and the residuals
// once), plus W once per step. For every batch of 40 rows or more the
// operations bound it. At h = 1280 W is 26 MB, so it stays in the 50 MB
// L2 from one step to the next and the per-step re-read comes from L2,
// not HBM. Not yet done: wgmma on TF32/bf16 tiles, TMA loads, a
// persistent kernel holding W slices in shared memory across steps.
//
// Backward step. The JAX backward (_bwd_rule, ops/lstm.py:358-396) is a
// reverse-time lax.scan, not a Pallas kernel. lstm_bwd_step_kernel is its
// per-step elementwise chain, one launch per step (every block of step t
// needs the whole dh of step t + 1, so the launch is again the step
// boundary). The products dgates_t @ W^T (between two steps), dW and the
// peephole reductions (after the last step) stay torch.matmul / sums in
// the wrapper, as JAX leaves them to XLA. It is bound by bytes: per
// element of [B, H] it reads 10 and writes 6 floats, against ~40
// operations.

#include <cuda_runtime.h>

#include <cstddef>

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

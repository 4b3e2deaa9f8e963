// Masked peephole-LSTM sequence recurrence, f32, for Hopper (sm_90a).
//
// Replaces the TPU kernels paddle_tpu/ops/lstm.py:_lstm_kernel (the
// recurrent weight resident in VMEM, h <= 512) and _lstm_kernel_tiled (the
// weight streamed in gate-column blocks, h = 1280) in their primal form:
// ys, hT, cT, no training residuals. It computes lstm_sequence_ref
// (ops/lstm.py:45-68) with the gate bias already folded into xs:
//
//   gates = xs_t + h_{t-1} @ W            gate order [in, ig, fg, og]
//   i  = tanh(a_in)
//   ig = sigmoid(a_ig + c_{t-1} * pI)     fg = sigmoid(a_fg + c_{t-1} * pF)
//   c  = i * ig + c_{t-1} * fg
//   og = sigmoid(a_og + c * pO)           h  = og * tanh(c)
//   mask == 0: h and c hold, ys = h_new * mask
//
// Design. A block owns a tile of kRows batch rows by kUnits hidden units,
// that is the four gate columns of each of its units, so the cell update
// is local to the block. Each step streams h_{t-1}[rows, :] and the
// block's W columns through shared memory in chunks of kK and sums the
// [kRows, 4 * kUnits] gate pre-activations in f32 registers (each thread:
// kRowsPerThread rows of one unit, all four gates), then applies the cell
// and writes h_t into the other half of a double-buffered h, c in place
// and ys[t]. Blocks of one step have no order among them, so the step
// boundary is the launch: the C entry below issues one launch per
// timestep on the caller's stream (not a cooperative grid sync).
//
// Bound on the H100 (SXM, 700 W): the recurrent product is
// 2 * B * H * 4H operations per step, at the f32 rate outside the tensor
// cores (67 TFLOP/s); the bytes are xs and ys once, plus W once per step.
// For every batch of 40 rows or more the operations bound it. At h = 1280
// W is 26 MB, so it stays in the 50 MB L2 from one step to the next and
// the per-step re-read comes from L2, not HBM. Not yet done: wgmma on
// TF32/bf16 tiles, TMA loads, a persistent kernel holding W slices in
// shared memory across steps.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kRows = 32;           // batch rows per block
constexpr int kUnits = 32;          // hidden units per block
constexpr int kK = 32;              // depth of one shared-memory chunk
constexpr int kRowsPerThread = 4;
constexpr int kThreads = kUnits * (kRows / kRowsPerThread);  // 256

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__global__ void __launch_bounds__(kThreads)
lstm_step_kernel(const float* __restrict__ xs_t,    // [B, 4H], bias folded
                 const float* __restrict__ mask_t,  // [B]
                 const float* __restrict__ w,       // [H, 4H]
                 const float* __restrict__ p_i,     // [H]
                 const float* __restrict__ p_f,     // [H]
                 const float* __restrict__ p_o,     // [H]
                 const float* __restrict__ h_prev,  // [B, H]
                 float* __restrict__ h_next,        // [B, H]
                 float* __restrict__ c,             // [B, H], in place
                 float* __restrict__ ys_t,          // [B, H]
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
    const float c_prev = c[o];
    const float in = tanhf(x[j] + acc[r][0]);
    const float ig = sigmoid_f(x[H + j] + acc[r][1] + c_prev * pi);
    const float fg = sigmoid_f(x[2 * H + j] + acc[r][2] + c_prev * pf);
    const float c_new = in * ig + c_prev * fg;
    const float og = sigmoid_f(x[3 * H + j] + acc[r][3] + c_new * po);
    const float h_new = og * tanhf(c_new);
    const float m = mask_t[b];
    if (m > 0.0f) {
      h_next[o] = h_new;
      c[o] = c_new;
    } else {
      h_next[o] = h_prev[o];
    }
    ys_t[o] = h_new * m;
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
    lstm_step_kernel<<<grid, kThreads, 0, s>>>(
        xs + static_cast<size_t>(t) * 4 * bh,
        mask + static_cast<size_t>(t) * B, w, p_i, p_f, p_o,
        h + (t & 1) * bh, h + ((t + 1) & 1) * bh, c,
        ys + static_cast<size_t>(t) * bh, B, H);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

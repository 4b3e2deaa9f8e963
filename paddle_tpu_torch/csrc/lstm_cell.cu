// One LSTM step on pre-projected gates for Hopper (sm_90a), f32.
//
// Replaces the TPU kernel paddle_tpu/kernels/rnn_cells.py:_lstm_cell_kernel
// (its pallas_call in _lstm_pallas), which the lstm_step layer reaches
// through lstm_cell (training; its backward is the vjp of the plain math,
// a recompute, so there is no backward kernel) and lstm_cell_infer (the
// no-grad decode step of a beam search).
//
// Shapes: gates [B, 4H] (x_t + h @ w + gate bias, blocks in the order
// [in, ig, fg, og]), c_prev [B, H], the peepholes check_i, check_f,
// check_o [H], all contiguous; out h and c [B, H]. Per (row, unit), in the
// order of _lstm_math:
//
//   ig = sigmoid(g_ig + c_prev * check_i)
//   fg = sigmoid(g_fg + c_prev * check_f)
//   c  = tanh(g_in) * ig + c_prev * fg
//   og = sigmoid(g_og + c * check_o)
//   h  = og * tanh(c)
//
// Every product and sum is spelled with a round-to-nearest intrinsic, so
// nvcc contracts none into an FMA and each rounds as the plain PyTorch
// version's separate operations do; expf and tanhf, not the fast
// intrinsics.
//
// Design: one thread per (row, unit), a grid-stride loop; neighbouring
// threads read neighbouring units of one gate block, so each of the five
// reads and two writes is coalesced. Bound on the H100 (SXM, 700 W): bytes,
// 4 (4BH + BH + 3H + 2BH); at the decode's B*K = 32 rows of H = 512 that
// is 0.47 MB, 0.14 us at 3.35 TB/s, so a launch's own latency (a few us)
// sets its time.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // 16 blocks for each of the 132 SMs

__device__ __forceinline__ float sigmoid(float x) {
  return __frcp_rn(__fadd_rn(1.f, expf(-x)));
}

__global__ void __launch_bounds__(kThreads)
lstm_cell_kernel(const float* __restrict__ gates,
                 const float* __restrict__ c_prev,
                 const float* __restrict__ check_i,
                 const float* __restrict__ check_f,
                 const float* __restrict__ check_o, float* __restrict__ h,
                 float* __restrict__ c, int B, int H) {
  const size_t n = static_cast<size_t>(B) * H;
  for (size_t idx = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
       idx < n; idx += static_cast<size_t>(gridDim.x) * kThreads) {
    const size_t b = idx / H;
    const int u = static_cast<int>(idx - b * H);
    const float* g = gates + b * 4 * H;
    const float cp = c_prev[idx];
    const float g_in = tanhf(g[u]);
    const float ig = sigmoid(__fadd_rn(g[H + u], __fmul_rn(cp, check_i[u])));
    const float fg =
        sigmoid(__fadd_rn(g[2 * H + u], __fmul_rn(cp, check_f[u])));
    const float state = __fadd_rn(__fmul_rn(g_in, ig), __fmul_rn(cp, fg));
    const float og =
        sigmoid(__fadd_rn(g[3 * H + u], __fmul_rn(state, check_o[u])));
    c[idx] = state;
    h[idx] = __fmul_rn(og, tanhf(state));
  }
}

}  // namespace

extern "C" int lstm_cell_forward(const float* gates, const float* c_prev,
                                 const float* check_i, const float* check_f,
                                 const float* check_o, float* h, float* c,
                                 int B, int H, void* stream) {
  const size_t n = static_cast<size_t>(B) * H;
  if (n == 0) return cudaSuccess;
  size_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  lstm_cell_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      gates, c_prev, check_i, check_f, check_o, h, c, B, H);
  return cudaGetLastError();
}

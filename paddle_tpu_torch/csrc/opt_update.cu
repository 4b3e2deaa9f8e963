// Fused dense optimizer updates, f32, for Hopper (sm_90a).
//
// Replace the TPU kernels paddle_tpu/kernels/opt_update.py:_momentum_kernel
// and _adam_kernel: one elementwise pass over a parameter tensor that reads
// p, g and the slots once and writes the new p and slots once.
//
//   Momentum:  mom = mu * m - lr * (g + decay * p);  p' = p + mom
//   Adam:      g' = g + decay * p
//              m' = b1 * m + (1 - b1) * g'
//              v' = b2 * v + (1 - b2) * g'^2
//              p' = p - alpha * m' / (sqrt(v') + eps)
//
// alpha = lr * sqrt(1 - b2^t) / (1 - b1^t) is computed by the caller, in
// float32, as opt_update.py:126 does. Every operation is spelled with a
// round-to-nearest intrinsic (__fmul_rn, __fadd_rn, ...), which the
// compiler does not contract into fused multiply-adds: the kernel takes
// the same roundings, in the same order, as the plain chain of separate
// PyTorch operations (Optimizer._apply_one).
//
// No TPU layout: no padding to [rows x 128] tiles. A grid-stride loop
// moves float4 where all pointers are 16-byte aligned, then a scalar
// tail; any size, 1 included. The outputs may alias the inputs (each
// element is read and written by one thread), so the pointers are not
// __restrict__.
//
// Bound on the H100 (SXM, 700 W): bytes. Momentum moves 5 floats per
// element (3 read, 2 written), Adam 7 (4 read, 3 written), at 3.35 TB/s,
// against 5 and 11 operations per element.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 16;

__device__ __forceinline__ float momentum_one(float p, float g, float m,
                                              float lr, float decay, float mu,
                                              float* m_out) {
  const float step = __fmul_rn(lr, __fadd_rn(g, __fmul_rn(decay, p)));
  const float mom = __fsub_rn(__fmul_rn(mu, m), step);
  *m_out = mom;
  return __fadd_rn(p, mom);
}

__device__ __forceinline__ float adam_one(float p, float g, float m, float v,
                                          float alpha, float decay, float b1,
                                          float one_minus_b1, float b2,
                                          float one_minus_b2, float eps,
                                          float* m_out, float* v_out) {
  const float gd = __fadd_rn(g, __fmul_rn(decay, p));
  const float mom = __fadd_rn(__fmul_rn(b1, m), __fmul_rn(one_minus_b1, gd));
  const float vv =
      __fadd_rn(__fmul_rn(b2, v), __fmul_rn(one_minus_b2, __fmul_rn(gd, gd)));
  *m_out = mom;
  *v_out = vv;
  return __fsub_rn(
      p, __fdiv_rn(__fmul_rn(alpha, mom), __fadd_rn(__fsqrt_rn(vv), eps)));
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
momentum_kernel(const float* p, const float* g, const float* m, float* p_out,
                float* m_out, float lr, float decay, float mu, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x +
                          threadIdx.x;
  const long long n_vec = kVec ? n / 4 : 0;
  for (long long k = first; k < n_vec; k += stride) {
    const float4 pv = reinterpret_cast<const float4*>(p)[k];
    const float4 gv = reinterpret_cast<const float4*>(g)[k];
    const float4 mv = reinterpret_cast<const float4*>(m)[k];
    float4 po, mo;
    po.x = momentum_one(pv.x, gv.x, mv.x, lr, decay, mu, &mo.x);
    po.y = momentum_one(pv.y, gv.y, mv.y, lr, decay, mu, &mo.y);
    po.z = momentum_one(pv.z, gv.z, mv.z, lr, decay, mu, &mo.z);
    po.w = momentum_one(pv.w, gv.w, mv.w, lr, decay, mu, &mo.w);
    reinterpret_cast<float4*>(p_out)[k] = po;
    reinterpret_cast<float4*>(m_out)[k] = mo;
  }
  for (long long k = 4 * n_vec + first; k < n; k += stride) {
    p_out[k] = momentum_one(p[k], g[k], m[k], lr, decay, mu, &m_out[k]);
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
adam_kernel(const float* p, const float* g, const float* m, const float* v,
            float* p_out, float* m_out, float* v_out, float alpha,
            float decay, float b1, float one_minus_b1, float b2,
            float one_minus_b2, float eps, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x +
                          threadIdx.x;
  const long long n_vec = kVec ? n / 4 : 0;
  for (long long k = first; k < n_vec; k += stride) {
    const float4 pv = reinterpret_cast<const float4*>(p)[k];
    const float4 gv = reinterpret_cast<const float4*>(g)[k];
    const float4 mv = reinterpret_cast<const float4*>(m)[k];
    const float4 vv = reinterpret_cast<const float4*>(v)[k];
    float4 po, mo, vo;
    po.x = adam_one(pv.x, gv.x, mv.x, vv.x, alpha, decay, b1, one_minus_b1,
                    b2, one_minus_b2, eps, &mo.x, &vo.x);
    po.y = adam_one(pv.y, gv.y, mv.y, vv.y, alpha, decay, b1, one_minus_b1,
                    b2, one_minus_b2, eps, &mo.y, &vo.y);
    po.z = adam_one(pv.z, gv.z, mv.z, vv.z, alpha, decay, b1, one_minus_b1,
                    b2, one_minus_b2, eps, &mo.z, &vo.z);
    po.w = adam_one(pv.w, gv.w, mv.w, vv.w, alpha, decay, b1, one_minus_b1,
                    b2, one_minus_b2, eps, &mo.w, &vo.w);
    reinterpret_cast<float4*>(p_out)[k] = po;
    reinterpret_cast<float4*>(m_out)[k] = mo;
    reinterpret_cast<float4*>(v_out)[k] = vo;
  }
  for (long long k = 4 * n_vec + first; k < n; k += stride) {
    p_out[k] = adam_one(p[k], g[k], m[k], v[k], alpha, decay, b1,
                        one_minus_b1, b2, one_minus_b2, eps, &m_out[k],
                        &v_out[k]);
  }
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<std::uintptr_t>(ptr) & 15u) == 0;
}

unsigned blocks_for(long long n) {
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;  // grid-stride covers more
  return static_cast<unsigned>(blocks < 1 ? 1 : blocks);
}

}  // namespace

// One Momentum update of n elements on `stream`. Returns the launch error
// (cudaError_t as int), 0 when the launch was accepted; allocates nothing,
// does not synchronise.
extern "C" int momentum_update(const float* p, const float* g, const float* m,
                               float* p_out, float* m_out, float lr,
                               float decay, float mu, long long n,
                               void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = aligned16(p) && aligned16(g) && aligned16(m) &&
                   aligned16(p_out) && aligned16(m_out);
  const unsigned blocks = blocks_for(vec ? (n + 3) / 4 : n);
  if (vec) {
    momentum_kernel<true><<<blocks, kThreads, 0, s>>>(p, g, m, p_out, m_out,
                                                      lr, decay, mu, n);
  } else {
    momentum_kernel<false><<<blocks, kThreads, 0, s>>>(p, g, m, p_out, m_out,
                                                       lr, decay, mu, n);
  }
  return static_cast<int>(cudaGetLastError());
}

// One Adam update of n elements; alpha is the bias-corrected rate. Same
// launch and error contract as momentum_update.
extern "C" int adam_update(const float* p, const float* g, const float* m,
                           const float* v, float* p_out, float* m_out,
                           float* v_out, float alpha, float decay, float b1,
                           float one_minus_b1, float b2, float one_minus_b2,
                           float eps, long long n, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = aligned16(p) && aligned16(g) && aligned16(m) &&
                   aligned16(v) && aligned16(p_out) && aligned16(m_out) &&
                   aligned16(v_out);
  const unsigned blocks = blocks_for(vec ? (n + 3) / 4 : n);
  if (vec) {
    adam_kernel<true><<<blocks, kThreads, 0, s>>>(
        p, g, m, v, p_out, m_out, v_out, alpha, decay, b1, one_minus_b1, b2,
        one_minus_b2, eps, n);
  } else {
    adam_kernel<false><<<blocks, kThreads, 0, s>>>(
        p, g, m, v, p_out, m_out, v_out, alpha, decay, b1, one_minus_b1, b2,
        one_minus_b2, eps, n);
  }
  return static_cast<int>(cudaGetLastError());
}

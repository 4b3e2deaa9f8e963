// Fused dense optimizer updates, f32, for Hopper (sm_90a).
//
// Replace the TPU kernels paddle_tpu/kernels/opt_update.py:_momentum_kernel
// and _adam_kernel: one elementwise pass that reads p, g and the slots once
// and writes the new p and slots once.
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
// compiler does not contract into fused multiply-adds: the kernels take
// the same roundings, in the same order, as the plain chain of separate
// PyTorch operations (Optimizer._apply_one).
//
// The path's kernels, adam_multi_kernel and momentum_multi_kernel, update
// a step's whole list of parameters in one launch. On the TPU XLA compiled
// a step's updates into one program; on the card a launch per tensor paid
// the host's launch path once per parameter (11 to 26 a step on the
// paths), far more than the bytes of the small ones take. The list travels
// as a table in the kernel's parameter space (__grid_constant__, up to
// kParamBytes on Hopper with CUDA 12.1+): per tensor its pointers, n, its
// own rate and decay (per-parameter learning rates and l2 overrides hold)
// and its first chunk. No host-to-device copy, no scratch. A persistent
// grid walks chunks of kChunk elements, b, b + grid, ...; a block finds its
// chunk's tensor by binary search over the first chunks (uniform across
// the block: constant-cache broadcasts). A tensor whose pointers are all
// 16-byte aligned moves as float4, kUnroll loads of each stream in flight
// a thread; other tensors, and the n % 4 tail, as scalars. Loads and
// stores are streaming (ld/st .cs): each byte is touched once. The caller
// passes plain arrays (pointers, sizes, rates, decays); the table's layout,
// the chunk prefix, the float4 rule and the split of a list longer than
// the table's capacity (opt_table_capacity()) into one launch a table are
// this file's alone.
//
// The per-tensor kernels momentum_kernel and adam_kernel (one launch per
// parameter) stay built as the yardstick of the multi-tensor ones; no path
// runs them. No TPU layout (no padding to [rows x 128] tiles). The outputs
// may alias the inputs (each element is read and written by one thread),
// so no pointer is __restrict__.
//
// Bound on the H100 (SXM, 700 W): bytes. Momentum moves 5 floats per
// element (3 read, 2 written), Adam 7 (4 read, 3 written), at 3.35 TB/s,
// against 5 and 11 operations per element.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <cstring>

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

// ------------------------------------------------- multi-tensor (a step)

// kernel parameter space on Hopper with CUDA 12.1+ (cudaLaunchKernel's
// limit for __grid_constant__ / by-value parameters since 12.1)
constexpr int kParamBytes = 32764;
constexpr long long kChunk = 4096;  // elements a block takes at once
constexpr int kUnroll = 2;          // float4 loads of each stream in flight

// One tensor of the table.
struct OptEntry {
  const float* in[4];  // p, g, mom, v (Momentum: v unused)
  float* out[3];       // p', mom', v' (Momentum: v' unused)
  long long n;
  long long chunk0;  // the table's chunks before this tensor
  float rate;        // Adam: alpha; Momentum: lr
  float decay;
  int vec;  // every pointer 16-byte aligned: float4
};

constexpr int kHeaderBytes = 32;  // hyper[5], count, chunks
constexpr int kCapacity =
    (kParamBytes - kHeaderBytes) / static_cast<int>(sizeof(OptEntry));

struct OptTable {
  float hyper[5];  // Adam: b1, 1-b1, b2, 1-b2, eps; Momentum: mu
  int count;
  long long chunks;
  OptEntry e[kCapacity];
};

static_assert(offsetof(OptTable, e) == kHeaderBytes, "header bytes");
static_assert(sizeof(OptTable) <= kParamBytes, "table exceeds the space");

struct AdamOp {
  static constexpr int kIn = 4;
  __device__ __forceinline__ static void apply(const float* h, float rate,
                                               float decay, const float* in,
                                               float* out) {
    out[0] = adam_one(in[0], in[1], in[2], in[3], rate, decay, h[0], h[1],
                      h[2], h[3], h[4], &out[1], &out[2]);
  }
};

struct MomentumOp {
  static constexpr int kIn = 3;
  __device__ __forceinline__ static void apply(const float* h, float rate,
                                               float decay, const float* in,
                                               float* out) {
    out[0] = momentum_one(in[0], in[1], in[2], rate, decay, h[0], &out[1]);
  }
};

__device__ __forceinline__ float4 ld4(const float* base, long long k) {
  return __ldcs(reinterpret_cast<const float4*>(base) + k);
}

__device__ __forceinline__ void st4(float* base, long long k, float4 v) {
  __stcs(reinterpret_cast<float4*>(base) + k, v);
}

template <class Op>
__device__ __forceinline__ void multi_body(const OptTable& tab) {
  constexpr int kIn = Op::kIn;
  constexpr int kOut = kIn - 1;
  float h[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) h[i] = tab.hyper[i];
  for (long long c = blockIdx.x; c < tab.chunks; c += gridDim.x) {
    // the last tensor whose first chunk is <= c (a tensor of n = 0 has no
    // chunk and shares its first chunk with the next one)
    int lo = 0, hi = tab.count - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (tab.e[mid].chunk0 <= c) {
        lo = mid;
      } else {
        hi = mid - 1;
      }
    }
    const OptEntry& e = tab.e[lo];
    const float rate = e.rate, decay = e.decay;
    const long long begin = (c - e.chunk0) * kChunk;
    const long long end = min(begin + kChunk, e.n);
    long long scalar_from = begin;
    if (e.vec) {
      const long long k_end = begin / 4 + (end - begin) / 4;
      for (long long k0 = begin / 4 + threadIdx.x; k0 < k_end;
           k0 += kUnroll * kThreads) {
        float4 in[kUnroll][kIn];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const long long k = k0 + u * kThreads;
          if (k < k_end) {
#pragma unroll
            for (int s = 0; s < kIn; ++s) in[u][s] = ld4(e.in[s], k);
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const long long k = k0 + u * kThreads;
          if (k < k_end) {
            float4 out[kOut];
#pragma unroll
            for (int l = 0; l < 4; ++l) {  // the float4's lanes x, y, z, w
              float a[kIn], r[kOut];
#pragma unroll
              for (int s = 0; s < kIn; ++s)
                a[s] = reinterpret_cast<const float*>(&in[u][s])[l];
              Op::apply(h, rate, decay, a, r);
#pragma unroll
              for (int s = 0; s < kOut; ++s)
                reinterpret_cast<float*>(&out[s])[l] = r[s];
            }
#pragma unroll
            for (int s = 0; s < kOut; ++s) st4(e.out[s], k, out[s]);
          }
        }
      }
      scalar_from = 4 * k_end;
    }
    for (long long i = scalar_from + threadIdx.x; i < end; i += kThreads) {
      float a[kIn], r[kOut];
#pragma unroll
      for (int s = 0; s < kIn; ++s) a[s] = __ldcs(e.in[s] + i);
      Op::apply(h, rate, decay, a, r);
#pragma unroll
      for (int s = 0; s < kOut; ++s) __stcs(e.out[s] + i, r[s]);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
adam_multi_kernel(const __grid_constant__ OptTable tab) {
  multi_body<AdamOp>(tab);
}

__global__ void __launch_bounds__(kThreads)
momentum_multi_kernel(const __grid_constant__ OptTable tab) {
  multi_body<MomentumOp>(tab);
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<std::uintptr_t>(ptr) & 15u) == 0;
}

// Packs a list of `count` tensors into tables of at most kCapacity records
// and launches one persistent grid a table (at most the blocks the card
// keeps resident at once, and no more than the table's chunks; a table
// without elements launches nothing). in_ptrs [count, Op::kIn] and
// out_ptrs [count, Op::kIn - 1] are the tensors' addresses. Returns the
// launches made, or minus the first launch error (cudaError_t).
template <class Op, class Kernel>
int launch_multi(Kernel kernel, const long long* in_ptrs,
                 const long long* out_ptrs, const long long* sizes,
                 const float* rates, const float* decays, int count,
                 const float* hyper, int n_hyper, int sms, void* stream,
                 int* resident) {
  constexpr int kIn = Op::kIn;
  constexpr int kOut = kIn - 1;
  if (count <= 0) return 0;
  if (*resident == 0) {
    int per_sm = 0;
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, kThreads, 0);
    if (err != cudaSuccess) return -static_cast<int>(err);
    *resident = per_sm < 1 ? 1 : per_sm;
  }
  OptTable tab;  // 32 KB on the host stack; the launch copies it
  for (int i = 0; i < 5; ++i) tab.hyper[i] = i < n_hyper ? hyper[i] : 0.f;
  int launches = 0;
  for (int lo = 0; lo < count; lo += kCapacity) {
    const int hi = count - lo < kCapacity ? count : lo + kCapacity;
    long long chunks = 0;
    for (int i = lo; i < hi; ++i) {
      OptEntry& e = tab.e[i - lo];
      bool vec = true;
      for (int s = 0; s < 4; ++s) {
        e.in[s] = s < kIn ? reinterpret_cast<const float*>(
                                in_ptrs[static_cast<long long>(i) * kIn + s])
                          : nullptr;
        vec = vec && aligned16(e.in[s]);
      }
      for (int s = 0; s < 3; ++s) {
        e.out[s] = s < kOut ? reinterpret_cast<float*>(
                                  out_ptrs[static_cast<long long>(i) * kOut +
                                           s])
                            : nullptr;
        vec = vec && aligned16(e.out[s]);
      }
      e.n = sizes[i];
      e.chunk0 = chunks;
      e.rate = rates[i];
      e.decay = decays[i];
      e.vec = vec ? 1 : 0;
      chunks += (sizes[i] + kChunk - 1) / kChunk;
    }
    if (chunks == 0) continue;
    tab.count = hi - lo;
    tab.chunks = chunks;
    long long blocks = static_cast<long long>(*resident) * sms;
    if (blocks > chunks) blocks = chunks;
    kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
             static_cast<cudaStream_t>(stream)>>>(tab);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return -static_cast<int>(err);
    ++launches;
  }
  return launches;
}

int g_adam_resident = 0;
int g_momentum_resident = 0;

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


// The most tensors one multi-tensor launch takes: the table's records
// that fit in the kernel parameter space beside its header.
extern "C" int opt_table_capacity() { return kCapacity; }

// One Adam update of a list of `count` tensors on `stream`, one launch a
// table of opt_table_capacity() tensors: per tensor i its addresses
// in_ptrs[i] = (p, g, mom, v) and out_ptrs[i] = (p', mom', v'), its size,
// its bias-corrected rate alpha and its decay. Returns the launches made
// (>= 0), or minus the launch error (cudaError_t); allocates nothing, does
// not synchronise.
extern "C" int adam_multi_update(const long long* in_ptrs,
                                 const long long* out_ptrs,
                                 const long long* sizes, const float* rates,
                                 const float* decays, int count, float b1,
                                 float one_minus_b1, float b2,
                                 float one_minus_b2, float eps, int sms,
                                 void* stream) {
  const float hyper[5] = {b1, one_minus_b1, b2, one_minus_b2, eps};
  return launch_multi<AdamOp>(adam_multi_kernel, in_ptrs, out_ptrs, sizes,
                              rates, decays, count, hyper, 5, sms, stream,
                              &g_adam_resident);
}

// The same for Momentum: in_ptrs[i] = (p, g, mom), out_ptrs[i] = (p',
// mom'), each rate an lr, mu the momentum.
extern "C" int momentum_multi_update(const long long* in_ptrs,
                                     const long long* out_ptrs,
                                     const long long* sizes,
                                     const float* rates, const float* decays,
                                     int count, float mu, int sms,
                                     void* stream) {
  const float hyper[1] = {mu};
  return launch_multi<MomentumOp>(momentum_multi_kernel, in_ptrs, out_ptrs,
                                  sizes, rates, decays, count, hyper, 1, sms,
                                  stream, &g_momentum_resident);
}

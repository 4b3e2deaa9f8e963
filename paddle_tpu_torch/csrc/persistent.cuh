// What the persistent (one cooperative launch per sequence) kernels of
// gru_seq.cu and lstm_seq.cu share: the copies into shared memory
// (cp.async), the grid barrier, the staging of a row block through L2 and
// the checked cooperative launch.
//
// Cross-block data (a state another block wrote during the launch) is
// read only through L2 (cp.async.cg, ld.global.cg), never through the
// non-coherent L1.
//
// The bf16 forms' pieces: Store<bf16> (the storage type of values the
// kernels compute on in f32 registers; Store<S>::r rounds an f32 result
// to S and back, round to nearest even as the CPU's bf16 operations
// round, the identity for float), the mma.sync m16n8k16 bf16 product
// with its ldmatrix loads, and the grid barrier's halves with release and
// acquire in place of the fences.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kPThreads = 256;    // threads of a persistent block
constexpr int kSmemLimit = 232448;

using bf16 = __nv_bfloat16;

template <class S>
struct Store;

template <>
struct Store<float> {
  static constexpr bool kF32 = true;
  static __device__ __forceinline__ float ld(const float* p) { return *p; }
  static __device__ __forceinline__ void st(float* p, float v) { *p = v; }
  static __device__ __forceinline__ float r(float v) { return v; }
};

template <>
struct Store<bf16> {
  static constexpr bool kF32 = false;
  static __device__ __forceinline__ float ld(const bf16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ void st(bf16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
  static __device__ __forceinline__ float r(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};

// The reference's bf16 sigmoid (jax.nn.sigmoid: 1 / (1 + exp(-x)), each
// operation rounded to bf16).
__device__ __forceinline__ float sigmoid_bf16(float x) {
  using R = Store<bf16>;
  return R::r(1.0f / R::r(1.0f + R::r(expf(-x))));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// The grid barrier, in two halves so that a block may work between them
// on what needs nobody else's output. grid_arrive counts the block in:
// the fence publishes its writes (ordered before thread 0 by the
// __syncthreads). grid_wait returns once `target` arrivals (this
// barrier's number times the grid) have been counted: the acquire load,
// the fence and the __syncthreads order the block's later reads after the
// others' writes. The counter only grows, so a block that is a barrier
// ahead cannot release one that is behind.
__device__ __forceinline__ void grid_arrive(unsigned* count) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(count, 1u);
  }
}

__device__ __forceinline__ void grid_wait(const unsigned* count,
                                          unsigned target) {
  if (threadIdx.x == 0) {
    while (load_acquire(count) < target) {
    }
    __threadfence();
  }
  __syncthreads();
}

__device__ __forceinline__ void grid_barrier(unsigned* count,
                                             unsigned target) {
  grid_arrive(count);
  grid_wait(count, target);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// the four 8 x 8 matrices whose rows lanes 0-7, 8-15, 16-23, 24-31 point
// at, as an mma A fragment
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// two 8 x 8 matrices (rows from lanes 0-7, 8-15), as a B fragment
__device__ __forceinline__ void ldsm_x2(unsigned (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

// c += a b over k = 16 (f32 sums)
__device__ __forceinline__ void mma_add(float (&c)[4], const unsigned (&a)[4],
                                        const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The grid barrier's halves with release and acquire in place of the
// fences: thread 0 counts the block in with one red.release (its
// block's writes are ordered before it by the __syncthreads); after its
// acquire spin, the __syncthreads orders the block's reads after the
// others' writes.
__device__ __forceinline__ void arrive_rel(unsigned* count) {
  __syncthreads();
  if (threadIdx.x == 0)
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(count)
                 : "memory");
}

__device__ __forceinline__ void wait_acq(const unsigned* count,
                                         unsigned target) {
  if (threadIdx.x == 0) {
    while (load_acquire(count) < target) {
    }
  }
  __syncthreads();
}

// Columns [k0, k0 + w) of rows b < B of a (row stride lda) into
// buf[b * ld + k - k0], 16 bytes a copy through L2.
__device__ __forceinline__ void stage_chunk(const float* __restrict__ a,
                                            size_t lda, int k0, int w,
                                            int B, int ld, float* buf) {
  // thread i copies float4 i, i + kPThreads, ... of the B x w/4 grid; its
  // (row, column) advances by (step_b, step_q) with one carry, so the
  // loop divides only once
  const int q4 = w / 4;
  const int step_b = kPThreads / q4, step_q = kPThreads % q4;
  int b = threadIdx.x / q4, q = threadIdx.x % q4;
  while (b < B) {
    cp_async16(buf + b * ld + 4 * q,
               a + static_cast<size_t>(b) * lda + k0 + 4 * q);
    b += step_b;
    q += step_q;
    if (q >= q4) {
      q -= q4;
      ++b;
    }
  }
}

// Checks that `kernel` with `smem` bytes fits the card as a cooperative
// grid of `grid` blocks, then launches it. Returns 0, a CUDA error, or
// -1 (shared memory above the card's opt-in limit), -2 (the grid does not
// fit on the card at once), -3 (no cooperative launch on this device).
int launch_cooperative(const void* kernel, int grid, long long smem,
                       void** args, cudaStream_t s) {
  int dev = 0, sms = 0, coop = 0, optin = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  if (!coop) return -3;
  if (smem > optin || smem > kSmemLimit) return -1;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, kPThreads, static_cast<size_t>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm * sms < grid) return -2;
  err = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(kPThreads),
                                    args, static_cast<size_t>(smem), s);
  return static_cast<int>(err);
}

}  // namespace

// One GRU step (the cell) for Hopper (sm_90a), f32: one launch on thread
// block clusters.
//
// Replaces the TPU kernel paddle_tpu/kernels/rnn_cells.py:_gru_cell_kernel
// (its pallas_call in _gru_pallas: both recurrent products inside the
// kernel), which the gru_step layer of a recurrent group reaches through
// gru_cell (training; its backward is the vjp of the plain math, a
// recompute, so there is no backward kernel) and gru_cell_infer (the
// no-grad step of --job test and of a beam search). With the gate bias
// folded into x [B, 3H] (gate order [update z, reset r, candidate c]):
//
//   z = sigmoid(x_z + h @ Wg[:, :H])
//   r = sigmoid(x_r + h @ Wg[:, H:])
//   c = tanh(x_c + (r * h) @ Ws)
//   out = h - z * h + z * c           (JAX's spelling, not (1-z)h + zc)
//
// The one dependency inside the step is that c of a row needs r * h over
// all H units of that row. The two-launch cell (gru_seq.cu:
// gru_cell_forward) pays a launch for it; here a cluster of C blocks
// exchanges it through distributed shared memory, with a cluster barrier
// in place of the launch.
//
// Layout. The grid is C x ceil(B / R) blocks, a cluster (C, 1, 1) per
// tile of R batch rows. Block k of a cluster owns the U = 4 ceil(H / 4C)
// units [k U, k U + U) (the last slice may be shorter) and copies into
// its shared memory, 16 bytes a cp.async, the cluster's rows of h and its
// three weight slices, k-major: the z and r columns of Wg with h in four
// groups of K rows, then the c columns of Ws (landing while phase A
// computes), 3 U H floats (192 KB at H = 512, C = 16). Then:
//   A. z and r of its units on the R rows (the product over K = H from
//      shared memory, each K group as it lands); z, h and r * h of its
//      units into shared memory;
//   cluster barrier (arrive.release / wait.acquire);
//   gather the cluster's r * h [R, H] from the C blocks' shared memory
//      (map_shared_rank) over its own copy of h; arrive at the exit
//      barrier (nobody reads a peer's shared memory after this);
//   B. c from the gathered r * h and the Ws slice, then out;
//   wait at the exit barrier, so that no block leaves while a peer may
//      still read its shared memory.
// A product gives each thread 4 neighbouring columns of the slice (one
// float4 of a weight row) and a K slice (in each K group, the float4
// groups q0 + s, q0 + s + ks, ...), for all R rows (R <= RT, a template
// of 1, 2, 4, 8 or 16): lanes of a warp read neighbouring weight columns
// and one float4 of h that they share, 4 + RT float4 loads per 16 RT
// FMAs. The K slices' partials go to shared memory (over the dead Wg
// slice) and one thread an output adds them in slice order: f32 FMAs in a
// fixed order and no atomics, so two runs give the same bits; the order
// over K differs from cuBLAS's, so the kernel holds the plain version
// within rounding, not bit for bit. The copy loops divide once, not per
// copy (an integer division is some 20 instructions, and a block makes
// 12,288 copies at H = 512).
//
// Strided weights: the layers pass Wg = w0[:, :2H] and Ws = w0[:, 2H:] of
// one w0 [H, 3H]; the kernel takes their row strides (ldg, lds). The
// route (kernels/rnn_cells.py:gru_cell_plan) needs H, ldg and lds % 4 ==
// 0, the weights and h on 16 bytes and the block within 232,448 bytes of
// shared memory (cell_smem_floats below, which the plan mirrors).
//
// Bound on the H100 (SXM, 700 W): the two products, 2 B H 3H operations
// at the f32 rate outside the tensor cores (67 TFLOP/s): 1.17 us at
// B = 50, H = 512; the bytes (x, h, W once, out) 3.1 MB, 0.94 us. What the
// design pays: a launch; each block's 192 KB of weights from L2 (every
// cluster reads all of W: the H100 places 7 clusters of 16 at once, so
// B = 50 runs 7 tiles of 8 rows and reads 21 MB), which overlaps little
// with the products; one product of R x 3U x H FMAs a block; the cluster
// barriers and the exchange of r * h.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <mutex>

#include "persistent.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRows = 16;    // rows of a cluster's tile
constexpr int kMaxCluster = 16;  // blocks of a cluster (16: non-portable)
constexpr int kChunks = 4;       // copy groups of h and Wg, computed as
                                 // they land

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__host__ __device__ inline int cell_units(int H, int C) {
  return 4 * ((H + 4 * C - 1) / (4 * C));
}

// K slices of a product over nc columns (nc % 4 == 0) at depth K: the
// threads left by its nc / 4 column groups, at most one float4 group each
__host__ __device__ inline int cell_slices(int nc, int K) {
  const int ks = kThreads / (nc / 4);
  return ks < K / 4 ? ks : K / 4;
}

// Floats of the first region of a block's shared memory: the Wg slice,
// whose space the products' partials reuse.
__host__ __device__ inline int cell_region_floats(int H, int U, int R) {
  const int wa = 2 * U * H;
  const int pa = cell_slices(2 * U, H) * R * 2 * U;
  const int pb = cell_slices(U, H) * R * U;
  return wa > pa ? (wa > pb ? wa : pb) : (pa > pb ? pa : pb);
}

// Floats of a block's shared memory: that region, the Ws slice, the tile
// of h (then of r * h) and z, h, r * h of its own units.
__host__ __device__ inline long long cell_smem_floats(int H, int U, int R) {
  return 1LL * cell_region_floats(H, U, R) + 1LL * U * H + 1LL * R * H +
         3LL * R * U;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// cp.async.wait_group n for a count known once the caller's loop is
// unrolled (the instruction takes an immediate)
__device__ __forceinline__ void cp_async_wait_n(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    default: cp_async_wait<4>(); break;
  }
}

// Rows [k0, k1) of a matrix, per float4s of each from src + k * ld, into
// dst + k * dld, 16 bytes a cp.async: thread t copies float4 t % per of
// rows t / per, t / per + 256 / per, ... (no division in the loop).
__device__ __forceinline__ void copy_rows(float* dst, int dld,
                                          const float* src, size_t ld,
                                          int k0, int k1, int per) {
  if (per <= 0) return;
  const int step = kThreads / per;
  const int t_row = threadIdx.x / per, q = threadIdx.x - t_row * per;
  if (t_row >= step) return;
  for (int k = k0 + t_row; k < k1; k += step)
    cp_async16(dst + k * dld + 4 * q, src + k * ld + 4 * q);
}

// acc[r][c] += tile[r][4 q .. 4 q + 3] . w[4 q .. 4 q + 3][4 cgi + c] for
// the float4 groups q = q0 + s, q0 + s + ks, ... < q1 of this thread's
// slice s, rows r < R (rows past R repeat row R - 1; their sums are never
// stored): the tile row-major (row length K), w k-major (row length nc).
template <int RT>
__device__ __forceinline__ void accumulate(float (&acc)[RT][4],
                                           const float* tile, int R, int K,
                                           const float* w, int nc, int cgi,
                                           int s, int ks, int q0, int q1) {
  for (int q = q0 + s; q < q1; q += ks) {
    float4 wv[4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wv[kk] = *reinterpret_cast<const float4*>(w + (4 * q + kk) * nc +
                                                4 * cgi);
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      const float4 a = *reinterpret_cast<const float4*>(
          tile + min(r, R - 1) * K + 4 * q);
      float v0 = acc[r][0], v1 = acc[r][1], v2 = acc[r][2], v3 = acc[r][3];
      v0 = fmaf(a.x, wv[0].x, v0);
      v1 = fmaf(a.x, wv[0].y, v1);
      v2 = fmaf(a.x, wv[0].z, v2);
      v3 = fmaf(a.x, wv[0].w, v3);
      v0 = fmaf(a.y, wv[1].x, v0);
      v1 = fmaf(a.y, wv[1].y, v1);
      v2 = fmaf(a.y, wv[1].z, v2);
      v3 = fmaf(a.y, wv[1].w, v3);
      v0 = fmaf(a.z, wv[2].x, v0);
      v1 = fmaf(a.z, wv[2].y, v1);
      v2 = fmaf(a.z, wv[2].z, v2);
      v3 = fmaf(a.z, wv[2].w, v3);
      v0 = fmaf(a.w, wv[3].x, v0);
      v1 = fmaf(a.w, wv[3].y, v1);
      v2 = fmaf(a.w, wv[3].z, v2);
      v3 = fmaf(a.w, wv[3].w, v3);
      acc[r][0] = v0;
      acc[r][1] = v1;
      acc[r][2] = v2;
      acc[r][3] = v3;
    }
  }
}

// The slices' sums acc into part[(s R + r) nc + c], over w once every
// thread is done reading it; ends with the block synchronised.
template <int RT>
__device__ __forceinline__ void store_partials(const float (&acc)[RT][4],
                                               int R, int nc, int cgi, int s,
                                               int ks, float* part) {
  __syncthreads();
  if (s < ks) {
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      if (r < R)
        *reinterpret_cast<float4*>(part + (s * R + r) * nc + 4 * cgi) =
            make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    }
  }
  __syncthreads();
}

// The sum of output (r, c)'s partials, in slice order.
__device__ __forceinline__ float slice_sum(const float* part, int ks, int R,
                                           int nc, int r, int c) {
  float v = 0.0f;
  for (int s = 0; s < ks; ++s) v += part[(s * R + r) * nc + c];
  return v;
}

template <int RT>
__global__ void __launch_bounds__(kThreads, 1) gru_cell_cluster_kernel(
    const float* __restrict__ x,   // [B, 3H], bias folded
    const float* __restrict__ h,   // [B, H]
    const float* __restrict__ wg,  // [H, 2H], leading dim ldg
    const float* __restrict__ ws,  // [H, H], leading dim lds
    float* __restrict__ out,       // [B, H]
    int ldg, int lds, int B, int H, int R) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = gridDim.x;  // the cluster spans the grid's x
  const int k = blockIdx.x;
  const int U = cell_units(H, C);
  const int u0 = k * U;
  const int up = max(0, min(U, H - u0));
  const int uq = up / 4;
  const int b0 = blockIdx.y * R;
  const int rows = min(R, B - b0);  // the last tile may be ragged
  const int Q = H / 4;  // float4 groups of a row of h
  const size_t H3 = 3 * static_cast<size_t>(H);
  extern __shared__ float4 smem4[];
  float* const wa = reinterpret_cast<float*>(smem4);  // [H][2U]; partials
  float* const wb = wa + cell_region_floats(H, U, rows);  // [H][U]
  float* const tile = wb + U * H;                     // [rows][H]
  float* const z_own = tile + rows * H;               // [rows][U]
  float* const h_own = z_own + rows * U;              // [rows][U]
  float* const rh_own = h_own + rows * U;             // [rows][U]

  // copy group c < kChunks: the float4 groups [Q c / kChunks,
  // Q (c + 1) / kChunks) of the tile's rows of h and the same rows of the
  // Wg slice; group kChunks: the Ws slice
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int q0 = Q * c / kChunks, q1 = Q * (c + 1) / kChunks;
    copy_rows(tile + 4 * q0, H, h + static_cast<size_t>(b0) * H + 4 * q0,
              H, 0, rows, q1 - q0);
    for (int g = 0; g < 2; ++g)
      copy_rows(wa + g * U, 2 * U, wg + g * H + u0, ldg, 4 * q0, 4 * q1, uq);
    cp_async_commit();
  }
  copy_rows(wb, U, ws + u0, lds, 0, H, uq);
  cp_async_commit();

  // A. z and r of the block's units, each chunk as it lands
  float acc[RT][4];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;
  }
  const int cg_a = threadIdx.x % (U / 2), s_a = threadIdx.x / (U / 2);
  const int ks_a = cell_slices(2 * U, H);
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    cp_async_wait_n(kChunks - c);
    __syncthreads();
    if (s_a < ks_a)
      accumulate<RT>(acc, tile, rows, H, wa, 2 * U, cg_a, s_a, ks_a,
                     Q * c / kChunks, Q * (c + 1) / kChunks);
  }
  store_partials<RT>(acc, rows, 2 * U, cg_a, s_a, ks_a, wa);
  for (int i = threadIdx.x; i < rows * 2 * U; i += kThreads) {
    const int r = i / (2 * U), c = i - r * 2 * U;
    const int g = c >= U, u = c - g * U;
    if (u >= up) continue;
    const int j = u0 + u;
    const float* xr = x + static_cast<size_t>(b0 + r) * H3;
    const float v =
        sigmoid_f(xr[g * H + j] + slice_sum(wa, ks_a, rows, 2 * U, r, c));
    const float hp = tile[r * H + j];
    if (g == 0) {
      z_own[r * U + u] = v;
      h_own[r * U + u] = hp;
    } else {
      rh_own[r * U + u] = v * hp;
    }
  }
  cluster_arrive();
  cluster_wait();

  // the cluster's r * h, over this block's copy of h
  for (int i = threadIdx.x; i < rows * Q; i += kThreads) {
    const int r = i / Q, col = 4 * (i - r * Q);
    const int owner = col / U;
    const float* src = cluster.map_shared_rank(rh_own, owner);
    *reinterpret_cast<float4*>(tile + r * H + col) =
        *reinterpret_cast<const float4*>(src + r * U + col - owner * U);
  }
  cluster_arrive();  // no read of a peer's shared memory follows
  cp_async_wait<0>();
  __syncthreads();

  // B. c and the new state of the block's units
  const int cg_b = threadIdx.x % (U / 4), s_b = threadIdx.x / (U / 4);
  const int ks_b = cell_slices(U, H);
#pragma unroll
  for (int r = 0; r < RT; ++r) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;
  }
  if (s_b < ks_b)
    accumulate<RT>(acc, tile, rows, H, wb, U, cg_b, s_b, ks_b, 0, Q);
  store_partials<RT>(acc, rows, U, cg_b, s_b, ks_b, wa);
  for (int i = threadIdx.x; i < rows * U; i += kThreads) {
    const int r = i / U, u = i - r * U;
    if (u >= up) continue;
    const int j = u0 + u;
    const float c = tanhf(x[static_cast<size_t>(b0 + r) * H3 + 2 * H + j] +
                          slice_sum(wa, ks_b, rows, U, r, u));
    const float hp = h_own[r * U + u];
    const float z = z_own[r * U + u];
    out[static_cast<size_t>(b0 + r) * H + j] = (hp - z * hp) + z * c;
  }
  cluster_wait();
}

using CellKernel = void (*)(const float*, const float*, const float*,
                            const float*, float*, int, int, int, int, int);

CellKernel kernel_of(int R) {
  return R <= 1   ? gru_cell_cluster_kernel<1>
         : R <= 2 ? gru_cell_cluster_kernel<2>
         : R <= 4 ? gru_cell_cluster_kernel<4>
         : R <= 8 ? gru_cell_cluster_kernel<8>
                  : gru_cell_cluster_kernel<16>;
}

cudaLaunchConfig_t launch_config(int C, int R, int B, long long smem,
                                 cudaStream_t s, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, (B + R - 1) / R, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Clusters of this kernel and shared memory that the card can hold at
// once (cudaOccupancyMaxActiveClusters), after opting the kernel into the
// card's shared memory and the non-portable cluster size; a negative CUDA
// error.
int max_clusters(CellKernel kernel, int C, int R, long long smem) {
  // the opt-in limit, not smem: one kernel serves several R, and a later
  // smaller setting would refuse an earlier plan's launch
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err == cudaSuccess && C > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(C, R, R, smem, 0, &attr);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// The placement check of each (device, C, R, shared memory) launched so
// far, made once: the launch path is per step, the check is not cheap.
struct Placed {
  int dev, C, R;
  long long smem;
  int clusters;
};
std::mutex placed_mu;
Placed placed[64];
int n_placed = 0;

int clusters_placed(int dev, CellKernel kernel, int C, int R,
                    long long smem) {
  std::lock_guard<std::mutex> lock(placed_mu);
  for (int i = 0; i < n_placed; ++i) {
    const Placed& p = placed[i];
    if (p.dev == dev && p.C == C && p.R == R && p.smem == smem)
      return p.clusters;
  }
  const int n = max_clusters(kernel, C, R, smem);
  if (n >= 0 && n_placed < 64) placed[n_placed++] = {dev, C, R, smem, n};
  return n;
}

bool bad_plan(int H, int ldg, int lds, int C, int R) {
  return H < 4 || H % 4 != 0 || ldg % 4 != 0 || lds % 4 != 0 || C < 1 ||
         C > kMaxCluster || R < 1 || R > kMaxRows ||
         cell_units(H, C) * (C - 1) >= H ||
         cell_units(H, C) / 2 > kThreads;
}

}  // namespace

// Shared-memory bytes of a cluster block of the cell at H units, cluster
// size C and R rows a tile, as the launcher computes them; the wrapper's
// plan mirrors it.
extern "C" long long gru_cell_smem(int H, int C, int R) {
  return 4 * cell_smem_floats(H, cell_units(H, C), R);
}

// cudaOccupancyMaxActiveClusters of the cell kernel for rows R, cluster
// size C and its shared memory at H units on the current device; a
// negative CUDA error, or -4 for a plan the kernel does not take.
extern "C" int gru_cell_max_clusters(int H, int C, int R) {
  if (bad_plan(H, H, H, C, R)) return -4;
  return max_clusters(kernel_of(R), C, R, gru_cell_smem(H, C, R));
}

// One GRU step on the cluster route: out ([B, H]) from x ([B, 3H], bias
// folded) and h ([B, H], 16-byte aligned), the weights on 16 bytes with
// row strides ldg and lds; clusters of C blocks, R rows a tile. Returns 0,
// a CUDA error, -1 (the block's shared memory above the card's opt-in
// limit), -2 (the card cannot place one cluster of it) or -4 (a plan the
// kernel does not take). Launches on `stream`, allocates nothing, does
// not synchronise.
extern "C" int gru_cell_cluster_forward(const float* x, const float* h,
                                        const float* wg, const float* ws,
                                        float* out, int ldg, int lds, int B,
                                        int H, int C, int R, void* stream) {
  if (B == 0) return 0;
  if (bad_plan(H, ldg, lds, C, R)) return -4;
  const long long smem = gru_cell_smem(H, C, R);
  if (smem > kSmemLimit) return -1;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const CellKernel kernel = kernel_of(R);
  const int n = clusters_placed(dev, kernel, C, R, smem);
  if (n < 0) return -n;
  if (n == 0) return -2;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(
      C, R, B, smem, static_cast<cudaStream_t>(stream), &attr);
  err = cudaLaunchKernelEx(&cfg, kernel, x, h, wg, ws, out, ldg, lds, B, H,
                           R);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

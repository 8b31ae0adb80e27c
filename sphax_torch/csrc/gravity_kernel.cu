// Kernel G: open-boundary direct-sum gravity, for Hopper (sm_90a).
//
// Replaces (TPU Pallas kernel):
//   kernel G  sphax/physics/pallas_kernels.py:808  gravity
//
// acc_i = -G sum_j m_j (r_ij^2 + eps^2)^-3/2 dx_ij over all N columns, with
// no periodic min-image. The self-pair gives exactly zero because dx = 0,
// which needs eps > 0 (the wrapper in sphax_torch/physics/direct_gravity.py
// raises otherwise).
//
// What bounds it: N^2 pairs of 19 flops and one reciprocal square root each,
// all from shared memory, so the fp32 version is bound by the SM's
// arithmetic and issue rate, not by memory. The design spends as few issue
// slots a pair as it can and keeps every SM busy at any N:
//
// - Rows tiled in registers: a thread owns ROWS rows (t, t + THREADS, ... of
//   its block, so that the loads of the rows and the stores stay coalesced),
//   and one shared-memory read of a column record serves ROWS pairs. A pair
//   is then 3 FADD (dx), 3 FFMA (r^2, started from eps^2), one MUFU.RSQ,
//   3 FMUL (m r^-3) and 3 FFMA (the sums).
// - Columns split across blocks: the grid is (row blocks x S column
//   slices). The plan (rows a thread, slices, columns a slice) is made on the
//   host from N and the SM count (direct_gravity.gravity_plan) so that the
//   grid holds several waves of resident blocks. With S > 1 each slice writes
//   its partial sums to a workspace [S, 3, N] and a second kernel adds them
//   in slice order and applies -G; with S = 1 the slice writes acc itself.
//   No atomics: one input gives a bitwise-equal output in every launch.
// - Columns staged double-buffered: the wrapper packs one record (x, y, z, m)
//   a particle, [N, 4], and each tile of TILE records is copied to shared
//   memory with cp.async while the previous tile is summed; one barrier a
//   tile. Columns past the slice's end are zero-filled (m = 0) and add 0.
//
// Each tile's sum is taken apart and then added to the row's total, so an
// fp32 row of N terms rounds in N/TILE + S additions at the total's
// magnitude instead of N. fp64 keeps ::rsqrt (a software sequence).
//
// The launcher returns cudaGetLastError() right after each launch.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;  // threads a block
constexpr int TILE = 256;     // columns a staged tile; a slice is whole tiles
// blocks a SM that __launch_bounds__ keeps room for (16 warps, up to 128
// registers a thread; direct_gravity.BLOCKS_PER_SM). With that room the fp32
// kernel of 4 rows a thread ran faster than held to 64 registers for 32
// warps (PERF.md).
constexpr int MIN_BLOCKS = 4;
// rows a thread (direct_gravity.ROWS). 4 ran fastest of 1, 2 and 4 from
// N = 12,288 up; below, with one-tile slices, within 4 % of 1 row, where the
// host's launches take longer than the kernels (PERF.md)
constexpr int ROWS = 4;

template <typename T> struct GNum;
template <> struct GNum<float> {
  // r^2 >= eps^2 > 0 and far from the denormals: the bare MUFU.RSQ
  static __device__ __forceinline__ float rsqrt(float x) {
    float y;
    asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
  }
  static __device__ __forceinline__ float fma(float a, float b, float c) {
    return fmaf(a, b, c);
  }
};
template <> struct GNum<double> {
  static __device__ __forceinline__ double rsqrt(double x) {
    return ::rsqrt(x);
  }
  static __device__ __forceinline__ double fma(double a, double b, double c) {
    return ::fma(a, b, c);
  }
};

// One column record, aligned for 16-byte vector loads.
template <typename T>
struct alignas(4 * sizeof(T)) Body {
  T x, y, z, m;
};

// Copies records [c0, c0 + TILE) of src to buf with cp.async, 16 bytes a
// copy; records at or past c_end are zero-filled (nothing is read).
template <typename T>
__device__ __forceinline__ void stage(Body<T>* buf, const Body<T>* src,
                                      int c0, int c_end) {
  constexpr int PIECES = int(sizeof(Body<T>)) / 16;  // 16-byte pieces a record
#pragma unroll
  for (int k = 0; k < TILE * PIECES / THREADS; ++k) {
    const int q = threadIdx.x + k * THREADS;
    const int j = c0 + q / PIECES;
    const bool in = j < c_end;
    const char* from =
        reinterpret_cast<const char*>(src + (in ? j : 0)) + (q % PIECES) * 16;
    const unsigned to = static_cast<unsigned>(
        __cvta_generic_to_shared(reinterpret_cast<char*>(buf) + q * 16));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(to),
                 "l"(from), "r"(in ? 16 : 0)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Block (x, y) sums the columns of slice y for THREADS * R rows. With
// `direct` (one slice) it writes acc [n, 3] scaled by `scale` (-G); else the
// unscaled partial sums to out[y] of a workspace [S, 3, n].
template <typename T, int R>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    gravity_kernel(const Body<T>* __restrict__ src, int n, int cols_per_slice,
                   T eps2, T scale, bool direct, T* __restrict__ out) {
  using N = GNum<T>;
  __shared__ Body<T> tile[2][TILE];
  const int row0 = blockIdx.x * (THREADS * R) + threadIdx.x;
  const int c_begin = blockIdx.y * cols_per_slice;
  const int c_end = min(c_begin + cols_per_slice, n);
  const int ntiles = (c_end - c_begin + TILE - 1) / TILE;
  stage(tile[0], src, c_begin, c_end);

  T xi[R], yi[R], zi[R], ax[R], ay[R], az[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int i = row0 + k * THREADS;
    const Body<T> b = i < n ? src[i] : Body<T>{T(0), T(0), T(0), T(0)};
    xi[k] = b.x;
    yi[k] = b.y;
    zi[k] = b.z;
    ax[k] = ay[k] = az[k] = T(0);
  }
  for (int t = 0; t < ntiles; ++t) {
    // tile t is in; every thread is done with tile t - 1, whose buffer the
    // copy of tile t + 1 reuses
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    if (t + 1 < ntiles)
      stage(tile[(t + 1) & 1], src, c_begin + (t + 1) * TILE, c_end);
    const Body<T>* cols = tile[t & 1];
    T px[R], py[R], pz[R];
#pragma unroll
    for (int k = 0; k < R; ++k) px[k] = py[k] = pz[k] = T(0);
#pragma unroll 8
    for (int j = 0; j < TILE; ++j) {
      const Body<T> c = cols[j];
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const T dx = xi[k] - c.x, dy = yi[k] - c.y, dz = zi[k] - c.z;
        const T r2 = N::fma(dz, dz, N::fma(dy, dy, N::fma(dx, dx, eps2)));
        const T inv = N::rsqrt(r2);
        const T f = (c.m * inv) * (inv * inv);
        px[k] = N::fma(f, dx, px[k]);
        py[k] = N::fma(f, dy, py[k]);
        pz[k] = N::fma(f, dz, pz[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < R; ++k) {
      ax[k] += px[k];
      ay[k] += py[k];
      az[k] += pz[k];
    }
  }
  T* part = out + size_t(blockIdx.y) * 3 * n;
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int i = row0 + k * THREADS;
    if (i >= n) continue;
    if (direct) {
      out[3 * size_t(i) + 0] = scale * ax[k];
      out[3 * size_t(i) + 1] = scale * ay[k];
      out[3 * size_t(i) + 2] = scale * az[k];
    } else {
      part[i] = ax[k];
      part[n + size_t(i)] = ay[k];
      part[2 * size_t(n) + i] = az[k];
    }
  }
}

// acc[e] = scale * (sum of the S partials of element e, in slice order), for
// e = 3 i + axis of acc [n, 3].
template <typename T>
__global__ void reduce_slices(const T* __restrict__ work, int n, int slices,
                              T scale, T* __restrict__ acc) {
  const size_t e = size_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= 3 * size_t(n)) return;
  const size_t i = e / 3, axis = e - 3 * i;
  const T* w = work + axis * n + i;
  T s = T(0);
  for (int k = 0; k < slices; ++k) s += w[size_t(k) * 3 * n];
  acc[e] = scale * s;
}

// The main kernel of the newest launch, for sphax_gravity_last_launch.
const void* last_kernel = nullptr;

template <typename T, int R>
cudaError_t launch_rows(const void* src, int n, double eps2, double G,
                        int slices, int cols_per_slice, void* work, void* acc,
                        cudaStream_t stream) {
  const auto kernel = gravity_kernel<T, R>;
  last_kernel = reinterpret_cast<const void*>(kernel);
  const dim3 grid((n + THREADS * R - 1) / (THREADS * R), slices);
  kernel<<<grid, THREADS, 0, stream>>>(
      static_cast<const Body<T>*>(src), n, cols_per_slice, T(eps2), T(-G),
      slices == 1, static_cast<T*>(slices == 1 ? acc : work));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || slices == 1) return err;
  constexpr int RT = 256;
  reduce_slices<T><<<int((3 * size_t(n) + RT - 1) / RT), RT, 0, stream>>>(
      static_cast<const T*>(work), n, slices, T(-G), static_cast<T*>(acc));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_gravity(const void* src, int n, double eps2, double G,
                           int rows_per_thread, int slices,
                           int cols_per_slice, void* work, void* acc,
                           void* stream) {
  // the plan must cut [0, n) into `slices` non-empty runs of whole tiles
  if (n <= 0 || slices < 1 || slices > 65535 || cols_per_slice <= 0 ||
      cols_per_slice % TILE != 0 ||
      (long long)(slices - 1) * cols_per_slice >= n ||
      (long long)slices * cols_per_slice < n ||
      (slices > 1 && work == nullptr))
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  if (rows_per_thread != ROWS) return cudaErrorInvalidValue;
  return launch_rows<T, ROWS>(src, n, eps2, G, slices, cols_per_slice, work,
                              acc, s);
}

}  // namespace

extern "C" {

// src: [n, 4] records (x, y, z, m); work: [slices, 3, n] (unused, may be
// null, when slices == 1); acc: [n, 3].
cudaError_t sphax_gravity_f32(const void* src, int n, double eps2, double G,
                              int rows_per_thread, int slices,
                              int cols_per_slice, void* work, void* acc,
                              void* stream) {
  return launch_gravity<float>(src, n, eps2, G, rows_per_thread, slices,
                               cols_per_slice, work, acc, stream);
}

cudaError_t sphax_gravity_f64(const void* src, int n, double eps2, double G,
                              int rows_per_thread, int slices,
                              int cols_per_slice, void* work, void* acc,
                              void* stream) {
  return launch_gravity<double>(src, n, eps2, G, rows_per_thread, slices,
                                cols_per_slice, work, acc, stream);
}

// What the runtime reports of the kernel G launched last, in the layout of
// sphax_last_launch: out[0] registers a thread, out[1] static and out[2]
// dynamic shared memory in bytes a block, out[3] local memory in bytes a
// thread, out[4] threads a block, out[5] the blocks a SM can hold at once.
cudaError_t sphax_gravity_last_launch(int* out) {
  if (last_kernel == nullptr) return cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, last_kernel);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, last_kernel,
                                                      THREADS, 0);
  if (err != cudaSuccess) return err;
  out[0] = attr.numRegs;
  out[1] = int(attr.sharedSizeBytes);
  out[2] = 0;
  out[3] = int(attr.localSizeBytes);
  out[4] = THREADS;
  out[5] = blocks;
  return cudaSuccess;
}

}  // extern "C"

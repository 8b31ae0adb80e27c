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
// The classic tiled N-body kernel: one thread owns one row; the block
// stages a tile of TILE columns (x, y, z, m) in shared memory, one 16-byte
// (fp32) record per column so that a pair costs one shared-memory broadcast,
// every thread runs an unrolled loop over it with one rsqrt per pair, and G
// is applied once at the end. Columns past N are staged with m = 0 and contribute 0.
// Each tile's sum is taken apart and then added to the row's total, so an
// fp32 row of N terms rounds in N/TILE additions at the total's magnitude
// instead of N.
//
// What bounds it: N^2 pair interactions of ~20 flops and one reciprocal
// square root each, all from shared memory (each staged column is reused by
// TILE rows), so the fp32 version is bound by the SM's arithmetic and
// special-function throughput, not by memory. Nothing more is done about it
// yet (no column splitting across blocks, no register tiling of rows).
//
// The launcher returns cudaGetLastError() right after its launch.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 256;  // threads per block = columns per staged tile

template <typename T> struct GNum;
template <> struct GNum<float> {
  static __device__ __forceinline__ float rsqrt(float x) { return rsqrtf(x); }
};
template <> struct GNum<double> {
  static __device__ __forceinline__ double rsqrt(double x) {
    return ::rsqrt(x);
  }
};

// One staged column, aligned for a single vector load.
template <typename T>
struct alignas(4 * sizeof(T)) Body {
  T x, y, z, m;
};

template <typename T>
__global__ void __launch_bounds__(TILE)
    gravity_kernel(const T* __restrict__ src, int n, T eps2, T G,
                   T* __restrict__ acc) {
  __shared__ Body<T> tile[TILE];
  const int i = blockIdx.x * TILE + threadIdx.x;
  const T* X = src;
  const T* Y = src + n;
  const T* Z = src + 2 * (size_t)n;
  const T* M = src + 3 * (size_t)n;
  const bool row = i < n;
  const T xi = row ? X[i] : T(0), yi = row ? Y[i] : T(0),
          zi = row ? Z[i] : T(0);
  T ax = T(0), ay = T(0), az = T(0);
  for (int t0 = 0; t0 < n; t0 += TILE) {
    const int j = t0 + threadIdx.x;
    const bool col = j < n;
    tile[threadIdx.x] = col ? Body<T>{X[j], Y[j], Z[j], M[j]}
                            : Body<T>{T(0), T(0), T(0), T(0)};
    __syncthreads();
    T px = T(0), py = T(0), pz = T(0);
#pragma unroll 16
    for (int k = 0; k < TILE; ++k) {
      const Body<T> b = tile[k];
      const T dx = xi - b.x, dy = yi - b.y, dz = zi - b.z;
      const T r2 = dx * dx + dy * dy + dz * dz + eps2;
      const T inv = GNum<T>::rsqrt(r2);
      const T f = b.m * (inv * inv * inv);
      px += f * dx;
      py += f * dy;
      pz += f * dz;
    }
    ax += px;
    ay += py;
    az += pz;
    __syncthreads();
  }
  if (row) {
    acc[3 * (size_t)i + 0] = -G * ax;
    acc[3 * (size_t)i + 1] = -G * ay;
    acc[3 * (size_t)i + 2] = -G * az;
  }
}

template <typename T>
cudaError_t launch_gravity(const void* src, int n, double eps2, double G,
                           void* acc, void* stream) {
  const dim3 grid((n + TILE - 1) / TILE), block(TILE);
  gravity_kernel<T><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(src), n, T(eps2), T(G), static_cast<T*>(acc));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// src: SoA [4, n] (x, y, z, m); acc: [n, 3].
cudaError_t sphax_gravity_f32(const void* src, int n, double eps2, double G,
                              void* acc, void* stream) {
  return launch_gravity<float>(src, n, eps2, G, acc, stream);
}

cudaError_t sphax_gravity_f64(const void* src, int n, double eps2, double G,
                              void* acc, void* stream) {
  return launch_gravity<double>(src, n, eps2, G, acc, stream);
}

}  // extern "C"

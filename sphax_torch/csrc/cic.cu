// The P3M mesh's cloud-in-cell deposit and interpolation, for Hopper
// (sm_90a).
//
// Replaces no TPU kernel: the JAX package's CIC (sphax/physics/pm.py) is
// jnp that XLA fuses. On the card the same composition in torch
// (sphax_torch/physics/pm.py keeps it as _deposit_plain and _interp_plain)
// made the eight corners one at a time, twice a solve, each from about 15
// elementwise launches over N with int64 indices, and the interpolation
// held all eight (index, weight) pairs at once: about 30 ms a step at 256^3
// on a 384^3 mesh, against well under 1 ms of bytes. Two kernels take its
// place in pm._deposit and pm._interp:
//
//   cic_deposit_kernel  one thread a particle: its node i0 and fraction f,
//                       then the 8 corner weights times its mass added to
//                       the flat [M^3] grid with atomic adds.
//   cic_interp_kernel   one thread a particle: i0 and f again, then each of
//                       the G (1 to 3) grids of a stacked [G, M^3] read at
//                       the 8 corners and summed in corner order; out [N, G].
//
// What bounds them: bytes. A particle's position (and mass) is read once,
// coalesced; the corners' grid cells are read, or added to, at the
// particles' own locality (the state's order follows the lattice, so a
// warp's corners share lines). One pass each, no int64 temporaries, 8
// atomics a particle in the deposit, 8 G gathers in the interpolation.
//
// Bits: i0 and f come from the operations of the torch expressions in
// pm._cic_weights, in their order: (pos - lo) / cell as an IEEE subtract
// and divide; the periodic box's torch.remainder as c10::div_mod computes
// it (fmod, +0 for a zero remainder, then + M below zero); floor, the cast
// to int32, f = u - i0, then i0's int32 remainder by M; the open box's
// clamps. The corner weights are pm._corners' products, ((wx wy) wz) with
// 1 - f for a lower corner. The interpolation sums as pm._interp does,
// 0 + w g first, each product and sum rounded on its own (no FMA), so its
// output is the plain version's bit for bit. The deposit's sums are taken
// in the order the atomics land, as index_add_'s are on the card. No
// approximate intrinsics. No kernel allocates, synchronises or keeps
// state; every launcher returns cudaGetLastError() right after its launch.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int THREADS = 256;

inline unsigned blocks_for(int rows) {
  return unsigned((rows + THREADS - 1) / THREADS);
}

// IEEE round-to-nearest operations that the compiler may not contract
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float div_rn(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ double div_rn(double a, double b) {
  return __ddiv_rn(a, b);
}

// torch.remainder(a, b) of a floating tensor and b > 0 (c10::div_mod)
template <typename T>
__device__ __forceinline__ T remainder(T a, T b) {
  T mod;
  if constexpr (std::is_same_v<T, float>)
    mod = fmodf(a, b);
  else
    mod = fmod(a, b);
  if (mod == T(0))
    mod = T(0);
  else if (mod < T(0))
    mod = add_rn(mod, b);
  return mod;
}

// torch.remainder(i, m) of an int32 tensor and m > 0
__device__ __forceinline__ int remainder(int i, int m) {
  const int r = i % m;
  return r < 0 ? r + m : r;
}

// pm._cic_weights of one particle: node i0 and fraction f on each axis
template <typename T, bool PERIODIC>
__device__ __forceinline__ void cic_node(const T* __restrict__ p,
                                         const T* __restrict__ lo,
                                         const T* __restrict__ cell, int M,
                                         int (&i0)[3], T (&f)[3]) {
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    T u = div_rn(sub_rn(p[d], lo[d]), cell[d]);
    if constexpr (PERIODIC) {
      u = remainder(u, T(M));
      const int i = static_cast<int>(floor(u));
      f[d] = sub_rn(u, T(i));
      i0[d] = remainder(i, M);
    } else {
      // clip first, then the fraction from the clipped node
      const int i = min(max(static_cast<int>(floor(u)), 0), M - 2);
      f[d] = fmin(fmax(sub_rn(u, T(i)), T(0)), T(1));
      i0[d] = i;
    }
  }
}

// pm._corners: corner c = 4 dx + 2 dy + dz's flat node index and weight
template <typename T, bool PERIODIC>
__device__ __forceinline__ void corner(const int (&i0)[3], const T (&f)[3],
                                       const T (&g)[3], int M, int c,
                                       int64_t& flat, T& w) {
  const int dx = (c >> 2) & 1, dy = (c >> 1) & 1, dz = c & 1;
  w = mul_rn(mul_rn(dx ? f[0] : g[0], dy ? f[1] : g[1]), dz ? f[2] : g[2]);
  int ix = i0[0] + dx, iy = i0[1] + dy, iz = i0[2] + dz;
  if constexpr (PERIODIC) {
    ix = remainder(ix, M);
    iy = remainder(iy, M);
    iz = remainder(iz, M);
  }
  flat = (int64_t(ix) * M + iy) * M + iz;
}

template <typename T, bool PERIODIC>
__global__ void __launch_bounds__(THREADS)
    cic_deposit_kernel(const T* __restrict__ pos, const T* __restrict__ mass,
                       const T* __restrict__ lo, const T* __restrict__ cell,
                       int n, int M, T* __restrict__ grid) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int i0[3];
  T f[3], g[3];
  cic_node<T, PERIODIC>(pos + size_t(i) * 3, lo, cell, M, i0, f);
#pragma unroll
  for (int d = 0; d < 3; ++d) g[d] = sub_rn(T(1), f[d]);
  const T m = mass[i];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    int64_t flat;
    T w;
    corner<T, PERIODIC>(i0, f, g, M, c, flat, w);
    atomicAdd(grid + flat, mul_rn(m, w));
  }
}

template <typename T, bool PERIODIC, int G>
__global__ void __launch_bounds__(THREADS)
    cic_interp_kernel(const T* __restrict__ pos, const T* __restrict__ lo,
                      const T* __restrict__ cell,
                      const T* __restrict__ grids, int n, int M,
                      T* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int i0[3];
  T f[3], g[3];
  cic_node<T, PERIODIC>(pos + size_t(i) * 3, lo, cell, M, i0, f);
#pragma unroll
  for (int d = 0; d < 3; ++d) g[d] = sub_rn(T(1), f[d]);
  int64_t flat[8];
  T w[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) corner<T, PERIODIC>(i0, f, g, M, c, flat[c], w[c]);
  const int64_t cells = int64_t(M) * M * M;
#pragma unroll
  for (int k = 0; k < G; ++k) {
    const T* grid = grids + k * cells;
    T acc = T(0);
#pragma unroll
    for (int c = 0; c < 8; ++c)
      acc = add_rn(acc, mul_rn(w[c], __ldg(grid + flat[c])));
    out[size_t(i) * G + k] = acc;
  }
}

template <typename T>
cudaError_t launch_deposit(const void* pos, const void* mass, const void* lo,
                           const void* cell, int n, int M, int periodic,
                           void* grid, void* stream) {
  if (n <= 0) return cudaSuccess;
  auto run = [&](auto kernel) {
    kernel<<<blocks_for(n), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(pos), static_cast<const T*>(mass),
        static_cast<const T*>(lo), static_cast<const T*>(cell), n, M,
        static_cast<T*>(grid));
    return cudaGetLastError();
  };
  return periodic ? run(cic_deposit_kernel<T, true>)
                  : run(cic_deposit_kernel<T, false>);
}

template <typename T>
cudaError_t launch_interp(const void* pos, const void* lo, const void* cell,
                          const void* grids, int n, int M, int ngrids,
                          int periodic, void* out, void* stream) {
  if (n <= 0) return cudaSuccess;
  auto run = [&](auto kernel) {
    kernel<<<blocks_for(n), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(pos), static_cast<const T*>(lo),
        static_cast<const T*>(cell), static_cast<const T*>(grids), n, M,
        static_cast<T*>(out));
    return cudaGetLastError();
  };
  auto by_box = [&](auto per, auto nk) {
    constexpr bool P = decltype(per)::value;
    constexpr int K = decltype(nk)::value;
    return run(cic_interp_kernel<T, P, K>);
  };
  auto by_grids = [&](auto per) {
    switch (ngrids) {
      case 1: return by_box(per, std::integral_constant<int, 1>{});
      case 2: return by_box(per, std::integral_constant<int, 2>{});
      case 3: return by_box(per, std::integral_constant<int, 3>{});
      default: return cudaErrorInvalidValue;
    }
  };
  return periodic ? by_grids(std::true_type{}) : by_grids(std::false_type{});
}

}  // namespace

extern "C" {

// pos [n, 3] (wrapped into the box); mass [n]; lo, cell [3] on the device;
// grid [M^3], zeroed by the caller; periodic 1 or 0 (open box).
#define SPHAX_CIC_DEPOSIT_ENTRY(NAME, T)                                    \
  cudaError_t NAME(const void* pos, const void* mass, const void* lo,       \
                   const void* cell, int n, int M, int periodic, void* grid, \
                   void* stream) {                                          \
    return launch_deposit<T>(pos, mass, lo, cell, n, M, periodic, grid,     \
                             stream);                                       \
  }
SPHAX_CIC_DEPOSIT_ENTRY(sphax_cic_deposit_f32, float)
SPHAX_CIC_DEPOSIT_ENTRY(sphax_cic_deposit_f64, double)
#undef SPHAX_CIC_DEPOSIT_ENTRY

// pos [n, 3]; lo, cell [3]; grids [ngrids, M^3] (1 <= ngrids <= 3);
// out [n, ngrids].
#define SPHAX_CIC_INTERP_ENTRY(NAME, T)                                     \
  cudaError_t NAME(const void* pos, const void* lo, const void* cell,       \
                   const void* grids, int n, int M, int ngrids,             \
                   int periodic, void* out, void* stream) {                 \
    return launch_interp<T>(pos, lo, cell, grids, n, M, ngrids, periodic,   \
                            out, stream);                                   \
  }
SPHAX_CIC_INTERP_ENTRY(sphax_cic_interp_f32, float)
SPHAX_CIC_INTERP_ENTRY(sphax_cic_interp_f64, double)
#undef SPHAX_CIC_INTERP_ENTRY

}  // extern "C"

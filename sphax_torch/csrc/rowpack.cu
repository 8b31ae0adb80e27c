// The derived pass's row gathers and packing, for Hopper (sm_90a).
//
// Replaces no TPU kernel. The Pallas engine leaves these layout changes to
// XLA, which fuses them; on the card they were a chain of torch gathers,
// concatenations and transposes (sphax_torch/physics/rowpack.py keeps it as
// the plain versions), 23 ms a step at 256^3 against about 2 ms of bytes.
// Three kernels take its place in wengine.derived_with:
//
//   rowpack_gather_a     sorted row r <- original row o = g[r]: kernel A's
//                        SoA window [pos + shift_s, m, vel] (2 DIM + 1
//                        rows; A reads the first DIM + 1 without Balsara),
//                        and the sorted h0, u (and alpha). Pad rows
//                        (o == n) take the plain version's fills: 0, with
//                        1 for h and alpha.
//   rowpack_gather_c     sorted row r: kernel C's SoA window [pos, vel, m,
//                        h, 1/h, rho, cs, ci, gc1, gc2 (, bf)] (2 DIM + 8
//                        (+ 1) rows), positions, velocities and mass from
//                        A's window at r, every other field from the owner
//                        row s = src[r] (the owner mirror), with the
//                        hoists computed by the operations of the torch
//                        expressions they replace, in their order.
//   rowpack_scatter_out  original row i <- owner row inv[i]: h, rho, P,
//                        cs, omega, du/dt, div v and acc as separate
//                        original-order arrays.
//
// What bounds them: bytes. One thread a row; the SoA rows are written
// (and read) coalesced, the state's fields are read through g (and the
// sorted fields through inv) at the sort's locality. About 88, 120 and 84
// bytes a row move, 5.5 GB a step at 256^3 in fp32: 1.7 ms at 3.35 TB/s.
//
// Bits: every output is a copy of an input, except pos + shift_s and the
// four hoists, which are single IEEE operations: the divides and the
// multiplies round as torch's do, and x^k takes ATen's pow_tensor_scalar
// path (x * x for k = 2, x * x * x for k = 3, pow otherwise). No kernel
// allocates, synchronises or keeps state; every launcher returns
// cudaGetLastError() right after its launch.

#include <cuda_runtime.h>

#include <cmath>
#include <type_traits>

namespace {

constexpr int THREADS = 256;

inline unsigned blocks_for(int rows) {
  return unsigned((rows + THREADS - 1) / THREADS);
}

// x^K as ATen's pow_tensor_scalar computes it for a floating tensor and an
// integral exponent K >= 2.
template <int K, typename T>
__device__ __forceinline__ T pow_k(T x) {
  if constexpr (K == 2)
    return x * x;
  else if constexpr (K == 3)
    return x * x * x;
  else if constexpr (std::is_same_v<T, float>)
    return powf(x, float(K));
  else
    return pow(x, double(K));
}

template <typename T, int DIM, bool ALPHA>
__global__ void __launch_bounds__(THREADS)
    rowpack_gather_a(const T* __restrict__ pos, const T* __restrict__ vel,
                     const T* __restrict__ mass, const T* __restrict__ u,
                     const T* __restrict__ h, const T* __restrict__ alpha,
                     const int* __restrict__ g, const T* __restrict__ shift,
                     int n, int Ns, T* __restrict__ win,
                     T* __restrict__ h_s, T* __restrict__ u_s,
                     T* __restrict__ alpha_s) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= Ns) return;
  const size_t ns = size_t(Ns);
  const int o = min(g[r], n);
  const bool real = o < n;
  const size_t od = size_t(o) * DIM, rd = size_t(r) * DIM;
#pragma unroll
  for (int d = 0; d < DIM; ++d)
    win[d * ns + r] = (real ? pos[od + d] : T(0)) + shift[rd + d];
  win[DIM * ns + r] = real ? mass[o] : T(0);
#pragma unroll
  for (int d = 0; d < DIM; ++d)
    win[(DIM + 1 + d) * ns + r] = real ? vel[od + d] : T(0);
  h_s[r] = real ? h[o] : T(1);
  u_s[r] = real ? u[o] : T(0);
  if constexpr (ALPHA) alpha_s[r] = real ? alpha[o] : T(1);
}

template <typename T, int DIM, bool BF>
__global__ void __launch_bounds__(THREADS)
    rowpack_gather_c(const T* __restrict__ win_a, const int* __restrict__ src,
                     const T* __restrict__ h, const T* __restrict__ rho,
                     const T* __restrict__ om, const T* __restrict__ bf,
                     const T* __restrict__ P, const T* __restrict__ cs,
                     int Ns, T sig, T* __restrict__ win) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= Ns) return;
  const size_t ns = size_t(Ns);
  // pos, then vel (A's rows DIM + 1 ...), then m (A's row DIM)
#pragma unroll
  for (int d = 0; d < DIM; ++d) {
    win[d * ns + r] = win_a[d * ns + r];
    win[(DIM + d) * ns + r] = win_a[(DIM + 1 + d) * ns + r];
  }
  win[2 * DIM * ns + r] = win_a[DIM * ns + r];
  const int s = src[r];
  const T hs = h[s], rs = rho[s];
  // invh = 1.0 / h_s (a reciprocal), ci = P_s / (om_s * rho_s * rho_s),
  // gc1 = sigma * invh ** (DIM + 1), gc2 = gc1 * invh
  const T invh = T(1) / hs;
  const T ci = P[s] / (om[s] * rs * rs);
  const T gc1 = sig * pow_k<DIM + 1>(invh);
  T* w = win + (2 * DIM + 1) * ns + r;
  w[0] = hs;
  w[ns] = invh;
  w[2 * ns] = rs;
  w[3 * ns] = cs[s];
  w[4 * ns] = ci;
  w[5 * ns] = gc1;
  w[6 * ns] = gc1 * invh;
  if constexpr (BF) w[7 * ns] = bf[s];
}

template <typename T, int DIM>
__global__ void __launch_bounds__(THREADS)
    rowpack_scatter_out(const int* __restrict__ inv,
                        const T* __restrict__ h_s, const T* __restrict__ rho_s,
                        const T* __restrict__ P_s, const T* __restrict__ cs_s,
                        const T* __restrict__ om_s, const T* __restrict__ du_s,
                        const T* __restrict__ divv_s,
                        const T* __restrict__ acc_s, int n,
                        T* __restrict__ h, T* __restrict__ rho,
                        T* __restrict__ P, T* __restrict__ cs,
                        T* __restrict__ om, T* __restrict__ du,
                        T* __restrict__ divv, T* __restrict__ acc) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int r = inv[i];
  h[i] = h_s[r];
  rho[i] = rho_s[r];
  P[i] = P_s[r];
  cs[i] = cs_s[r];
  om[i] = om_s[r];
  du[i] = du_s[r];
  divv[i] = divv_s[r];
  const size_t rd = size_t(r) * DIM, id = size_t(i) * DIM;
#pragma unroll
  for (int d = 0; d < DIM; ++d) acc[id + d] = acc_s[rd + d];
}

// Calls run(std::integral_constant<int, DIM>) for dim 1, 2 or 3.
template <typename Run>
cudaError_t by_dim(int dim, Run run) {
  switch (dim) {
    case 1: return run(std::integral_constant<int, 1>{});
    case 2: return run(std::integral_constant<int, 2>{});
    case 3: return run(std::integral_constant<int, 3>{});
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_gather_a(const void* pos, const void* vel,
                            const void* mass, const void* u, const void* h,
                            const void* alpha, const void* g,
                            const void* shift, int n, int Ns, int dim,
                            int use_alpha, void* win, void* h_s, void* u_s,
                            void* alpha_s, void* stream) {
  if (Ns <= 0) return cudaSuccess;
  return by_dim(dim, [&](auto dim_c) {
    constexpr int D = decltype(dim_c)::value;
    auto run = [&](auto kernel) {
      kernel<<<blocks_for(Ns), THREADS, 0,
               static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(pos), static_cast<const T*>(vel),
          static_cast<const T*>(mass), static_cast<const T*>(u),
          static_cast<const T*>(h), static_cast<const T*>(alpha),
          static_cast<const int*>(g), static_cast<const T*>(shift), n, Ns,
          static_cast<T*>(win), static_cast<T*>(h_s), static_cast<T*>(u_s),
          static_cast<T*>(alpha_s));
      return cudaGetLastError();
    };
    return use_alpha ? run(rowpack_gather_a<T, D, true>)
                     : run(rowpack_gather_a<T, D, false>);
  });
}

template <typename T>
cudaError_t launch_gather_c(const void* win_a, const void* src,
                            const void* h, const void* rho, const void* om,
                            const void* bf, const void* P, const void* cs,
                            int Ns, int dim, int use_bf, double sig,
                            void* win, void* stream) {
  if (Ns <= 0) return cudaSuccess;
  return by_dim(dim, [&](auto dim_c) {
    constexpr int D = decltype(dim_c)::value;
    auto run = [&](auto kernel) {
      kernel<<<blocks_for(Ns), THREADS, 0,
               static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(win_a), static_cast<const int*>(src),
          static_cast<const T*>(h), static_cast<const T*>(rho),
          static_cast<const T*>(om), static_cast<const T*>(bf),
          static_cast<const T*>(P), static_cast<const T*>(cs), Ns, T(sig),
          static_cast<T*>(win));
      return cudaGetLastError();
    };
    return use_bf ? run(rowpack_gather_c<T, D, true>)
                  : run(rowpack_gather_c<T, D, false>);
  });
}

template <typename T>
cudaError_t launch_scatter_out(const void* inv, const void* h_s,
                               const void* rho_s, const void* P_s,
                               const void* cs_s, const void* om_s,
                               const void* du_s, const void* divv_s,
                               const void* acc_s, int n, int dim, void* h,
                               void* rho, void* P, void* cs, void* om,
                               void* du, void* divv, void* acc,
                               void* stream) {
  if (n <= 0) return cudaSuccess;
  return by_dim(dim, [&](auto dim_c) {
    constexpr int D = decltype(dim_c)::value;
    rowpack_scatter_out<T, D><<<blocks_for(n), THREADS, 0,
                                static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(inv), static_cast<const T*>(h_s),
        static_cast<const T*>(rho_s), static_cast<const T*>(P_s),
        static_cast<const T*>(cs_s), static_cast<const T*>(om_s),
        static_cast<const T*>(du_s), static_cast<const T*>(divv_s),
        static_cast<const T*>(acc_s), n, static_cast<T*>(h),
        static_cast<T*>(rho), static_cast<T*>(P), static_cast<T*>(cs),
        static_cast<T*>(om), static_cast<T*>(du), static_cast<T*>(divv),
        static_cast<T*>(acc));
    return cudaGetLastError();
  });
}

}  // namespace

extern "C" {

// pos, vel [n, dim]; mass, u, h, alpha [n] (alpha read only with
// use_alpha); g [Ns] int32; shift [Ns, dim]; win [2 dim + 1, Ns]; h_s,
// u_s, alpha_s [Ns].
#define SPHAX_GATHER_A_ENTRY(NAME, T)                                       \
  cudaError_t NAME(const void* pos, const void* vel, const void* mass,      \
                   const void* u, const void* h, const void* alpha,         \
                   const void* g, const void* shift, int n, int Ns,         \
                   int dim, int use_alpha, void* win, void* h_s, void* u_s, \
                   void* alpha_s, void* stream) {                           \
    return launch_gather_a<T>(pos, vel, mass, u, h, alpha, g, shift, n, Ns, \
                              dim, use_alpha, win, h_s, u_s, alpha_s,       \
                              stream);                                      \
  }
SPHAX_GATHER_A_ENTRY(sphax_rowpack_gather_a_f32, float)
SPHAX_GATHER_A_ENTRY(sphax_rowpack_gather_a_f64, double)
#undef SPHAX_GATHER_A_ENTRY

// win_a [2 dim + 1, Ns] (rowpack_gather_a's); src [Ns] int32; h, rho, om,
// bf, P, cs [Ns] sorted, unmirrored (bf read only with use_bf); sig the
// kernel's normalisation; win [2 dim + 8 + use_bf, Ns].
#define SPHAX_GATHER_C_ENTRY(NAME, T)                                       \
  cudaError_t NAME(const void* win_a, const void* src, const void* h,       \
                   const void* rho, const void* om, const void* bf,         \
                   const void* P, const void* cs, int Ns, int dim,          \
                   int use_bf, double sig, void* win, void* stream) {       \
    return launch_gather_c<T>(win_a, src, h, rho, om, bf, P, cs, Ns, dim,   \
                              use_bf, sig, win, stream);                    \
  }
SPHAX_GATHER_C_ENTRY(sphax_rowpack_gather_c_f32, float)
SPHAX_GATHER_C_ENTRY(sphax_rowpack_gather_c_f64, double)
#undef SPHAX_GATHER_C_ENTRY

// inv [n] int32; h_s ... divv_s [Ns], acc_s [Ns, dim]; h ... divv [n],
// acc [n, dim].
#define SPHAX_SCATTER_OUT_ENTRY(NAME, T)                                    \
  cudaError_t NAME(const void* inv, const void* h_s, const void* rho_s,     \
                   const void* P_s, const void* cs_s, const void* om_s,     \
                   const void* du_s, const void* divv_s, const void* acc_s, \
                   int n, int dim, void* h, void* rho, void* P, void* cs,   \
                   void* om, void* du, void* divv, void* acc,               \
                   void* stream) {                                          \
    return launch_scatter_out<T>(inv, h_s, rho_s, P_s, cs_s, om_s, du_s,    \
                                 divv_s, acc_s, n, dim, h, rho, P, cs, om,  \
                                 du, divv, acc, stream);                    \
  }
SPHAX_SCATTER_OUT_ENTRY(sphax_rowpack_scatter_out_f32, float)
SPHAX_SCATTER_OUT_ENTRY(sphax_rowpack_scatter_out_f64, double)
#undef SPHAX_SCATTER_OUT_ENTRY

}  // extern "C"

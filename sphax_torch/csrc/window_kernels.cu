// Kernels A and C of the sorted pencil-window engine, for Hopper (sm_90a).
//
// Replaces (TPU Pallas kernels):
//   kernel A  sphax/physics/pallas_kernels.py:315  solve_h_density
//   kernel C  sphax/physics/pallas_kernels.py:563  forces (without the fused
//             P3M `grav` branch, which comes with the gravity slice)
//
// Contract (sphax_torch/physics/window_kernels.py): one thread owns one
// sorted row i; a block covers one tile of `tile` rows, i.e. tile/group
// row-groups of `group` >= 32 rows, so a warp never straddles two groups and
// every lane of a warp walks the same candidate rows: the candidate loads
// are warp-uniform and served as L1 broadcasts, with no shared-memory
// staging. Group g's candidates are, per segment s < NSEG, the rows
// k in [w_lo[g,s], w_lo[g,s] + 128 w_nact[g,s]); a row already inside an
// earlier segment's range is skipped (first-occurrence dedup). Candidate
// fields are SoA [F, Ns]. A group whose w_nact row is all zero writes
// h = h0 and zeros for every other output.
//
// What bounds it: pair arithmetic. The kernels visit every candidate row
// of a group's windows: 2,224 candidate rows per real row, read off the
// built structure (w_nact) at N = 1e6 in the bench configuration
// (fast_sub=3, rgroups=2), against ~74 neighbours inside 2h (eta = 1.3).
// The per-candidate distance test and the per-pair math dominate; the
// operands arrive as warp-uniform broadcasts that hit L1/L2. What the
// design does about it: nothing yet.
// This is the correctness-first version; trimming the candidate set (finer
// groups, compaction) and staging windows in shared memory are later work.
//
// Every launcher returns cudaGetLastError() right after its launch.

#include <cuda_runtime.h>

namespace {

constexpr int DIM = 3;
constexpr int NSEG = 9;  // 3^(DIM-1) pencil segments
constexpr int BLK = 128; // rows per w_nact block

template <typename T> struct Num;

template <> struct Num<float> {
  static constexpr float tiny = 1e-30f;
  static __device__ __forceinline__ float rsqrt(float x) { return rsqrtf(x); }
  static __device__ __forceinline__ float sqrt(float x) { return sqrtf(x); }
  template <bool FAST>
  static __device__ __forceinline__ float div(float a, float b) {
    return FAST ? __fdividef(a, b) : a / b;
  }
};

template <> struct Num<double> {
  static constexpr double tiny = 1e-300;
  static __device__ __forceinline__ double rsqrt(double x) { return ::rsqrt(x); }
  static __device__ __forceinline__ double sqrt(double x) { return ::sqrt(x); }
  template <bool FAST>
  static __device__ __forceinline__ double div(double a, double b) {
    return a / b;
  }
};

// The group's candidate ranges; returns the total active block count.
__device__ __forceinline__ int load_windows(const int* __restrict__ w_lo,
                                            const int* __restrict__ w_nact,
                                            int g, int (&lo)[NSEG],
                                            int (&hi)[NSEG]) {
  int total = 0;
#pragma unroll
  for (int s = 0; s < NSEG; ++s) {
    const int na = w_nact[g * NSEG + s];
    lo[s] = w_lo[g * NSEG + s];
    hi[s] = lo[s] + BLK * na;
    total += na;
  }
  return total;
}

// True when row k lies in a segment before s (already counted).
template <int S>
__device__ __forceinline__ bool seen_before(int k, const int (&lo)[NSEG],
                                            const int (&hi)[NSEG]) {
  bool dup = false;
#pragma unroll
  for (int sp = 0; sp < S; ++sp) dup |= (k >= lo[sp]) & (k < hi[sp]);
  return dup;
}

// ---------------------------------------------------------------------------
// kernel A: Newton-h + density + d rho/d h (+ Balsara div/curl sums)
// ---------------------------------------------------------------------------

template <typename T>
struct DensSums {
  T rho, drdh, div, c0, c1, c2;
};

template <typename T, bool BALS, int S>
__device__ __forceinline__ void density_segment(
    const T* __restrict__ win, int Ns, const int (&lo)[NSEG],
    const int (&hi)[NSEG], T xi, T yi, T zi, T vxi, T vyi, T vzi, T invh,
    T sigd, DensSums<T>& acc) {
  const T* X = win;
  const T* Y = win + Ns;
  const T* Z = win + 2 * (size_t)Ns;
  const T* M = win + 3 * (size_t)Ns;
  for (int k = lo[S]; k < hi[S]; ++k) {
    if (seen_before<S>(k, lo, hi)) continue;
    const T dx = xi - X[k], dy = yi - Y[k], dz = zi - Z[k];
    const T r2 = dx * dx + dy * dy + dz * dz;
    const T invr = Num<T>::rsqrt(r2 + Num<T>::tiny);
    const T q = r2 * invr * invh;
    if (q >= T(2)) continue;  // outside the support: every term is 0
    const T m = M[k];
    const T t = T(2) - q;
    T f, df;
    if (q < T(1)) {
      f = T(1) + q * q * (T(0.75) * q - T(1.5));
      df = q * (T(2.25) * q - T(3));
    } else {
      f = T(0.25) * t * t * t;
      df = T(-0.75) * t * t;
    }
    const T w = sigd * f;
    const T dwdq = sigd * df;
    acc.rho += m * w;
    acc.drdh += m * (-(T(DIM) * w + q * dwdq) * invh);
    if (BALS) {
      const T* VX = win + 4 * (size_t)Ns;
      const T* VY = win + 5 * (size_t)Ns;
      const T* VZ = win + 6 * (size_t)Ns;
      const T mw = m * (dwdq * invh * invr);
      const T dvx = vxi - VX[k], dvy = vyi - VY[k], dvz = vzi - VZ[k];
      acc.div += mw * (dvx * dx + dvy * dy + dvz * dz);
      acc.c0 += mw * (dvy * dz - dvz * dy);
      acc.c1 += mw * (dvz * dx - dvx * dz);
      acc.c2 += mw * (dvx * dy - dvy * dx);
    }
  }
}

template <typename T, bool BALS>
__device__ __forceinline__ DensSums<T> density_walk(
    const T* __restrict__ win, int Ns, const int (&lo)[NSEG],
    const int (&hi)[NSEG], T xi, T yi, T zi, T vxi, T vyi, T vzi, T h,
    T sig) {
  const T invh = T(1) / h;
  const T sigd = sig * invh * invh * invh;
  DensSums<T> a{T(0), T(0), T(0), T(0), T(0), T(0)};
#define SPHAX_SEG(S)                                                       \
  density_segment<T, BALS, S>(win, Ns, lo, hi, xi, yi, zi, vxi, vyi, vzi, \
                              invh, sigd, a)
  SPHAX_SEG(0); SPHAX_SEG(1); SPHAX_SEG(2); SPHAX_SEG(3); SPHAX_SEG(4);
  SPHAX_SEG(5); SPHAX_SEG(6); SPHAX_SEG(7); SPHAX_SEG(8);
#undef SPHAX_SEG
  return a;
}

// pallas_kernels.py newton_update: same clamps and thresholds.
template <typename T>
__device__ __forceinline__ T newton_update(T h, T rho, T drdh, T m_safe,
                                           T eta_d, T hcap) {
  rho = rho > T(1e-30) ? rho : T(1e-30);
  const T rho_h = m_safe * eta_d / (h * h * h);
  const T phi = rho - rho_h;
  T dphi = drdh + T(DIM) * rho_h / h;
  if (fabs(dphi) < T(1e-30)) dphi = T(-1e-30);
  T dh = -phi / dphi;
  dh = dh < T(-0.5) * h ? T(-0.5) * h : dh;
  dh = dh > T(0.5) * h ? T(0.5) * h : dh;
  const T hn = h + dh;
  return hn < hcap ? hn : hcap;
}

template <typename T, bool BALS>
__global__ void solve_h_density_kernel(
    const T* __restrict__ win, const T* __restrict__ h0,
    const int* __restrict__ w_lo, const int* __restrict__ w_nact, int Ns,
    int group, T sig, T eta_d, T hcap, int iters, T* __restrict__ h_out,
    T* __restrict__ rho_out, T* __restrict__ drdh_out,
    T* __restrict__ div_out, T* __restrict__ curl_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= Ns) return;
  int lo[NSEG], hi[NSEG];
  const int active = load_windows(w_lo, w_nact, i / group, lo, hi);
  T h = h0[i];
  if (active == 0) {
    h_out[i] = h;
    rho_out[i] = T(0);
    drdh_out[i] = T(0);
    if (BALS) {
      div_out[i] = T(0);
      curl_out[i] = T(0);
    }
    return;
  }
  const T xi = win[i], yi = win[Ns + i], zi = win[2 * (size_t)Ns + i];
  const T mi = win[3 * (size_t)Ns + i];
  const T m_safe = mi > T(1e-30) ? mi : T(1e-30);
  T vxi = T(0), vyi = T(0), vzi = T(0);
  if (BALS) {
    vxi = win[4 * (size_t)Ns + i];
    vyi = win[5 * (size_t)Ns + i];
    vzi = win[6 * (size_t)Ns + i];
  }
  for (int it = 0; it < iters; ++it) {
    const DensSums<T> a = density_walk<T, false>(win, Ns, lo, hi, xi, yi, zi,
                                                 vxi, vyi, vzi, h, sig);
    h = newton_update(h, a.rho, a.drdh, m_safe, eta_d, hcap);
  }
  const DensSums<T> a = density_walk<T, BALS>(win, Ns, lo, hi, xi, yi, zi,
                                              vxi, vyi, vzi, h, sig);
  h_out[i] = h;
  rho_out[i] = a.rho;
  drdh_out[i] = a.drdh;
  if (BALS) {
    div_out[i] = a.div;
    curl_out[i] = Num<T>::sqrt(a.c0 * a.c0 + a.c1 * a.c1 + a.c2 * a.c2);
  }
}

// ---------------------------------------------------------------------------
// kernel C: symmetrized pressure force + Monaghan viscosity + du/dt
// ---------------------------------------------------------------------------

// SoA field rows of the forces window
enum { FX, FY, FZ, FVX, FVY, FVZ, FM, FH, FINVH, FRHO, FCS, FCI, FGC1, FGC2,
       FBF };

template <typename T>
struct ForceSums {
  T ax, ay, az, du;
};

template <typename T>
struct Own {
  T x, y, z, vx, vy, vz, h, invh, rho, cs, ci, gc1, gc2, bf;
};

template <typename T, bool BF, bool FAST, int S>
__device__ __forceinline__ void force_segment(
    const T* __restrict__ win, int Ns, const int (&lo)[NSEG],
    const int (&hi)[NSEG], const Own<T>& o, T alpha, T beta, T epsv,
    ForceSums<T>& acc) {
  auto F = [&](int f, int k) { return win[(size_t)f * Ns + k]; };
  for (int k = lo[S]; k < hi[S]; ++k) {
    if (seen_before<S>(k, lo, hi)) continue;
    const T dx = o.x - F(FX, k), dy = o.y - F(FY, k), dz = o.z - F(FZ, k);
    const T r2 = dx * dx + dy * dy + dz * dz;
    const T invr = Num<T>::rsqrt(r2 + Num<T>::tiny);
    const T r = r2 * invr;
    const T qi = r * o.invh;
    const T qj = r * F(FINVH, k);
    if (qi >= T(2) && qj >= T(2)) continue;  // both gradients vanish
    const T ti = T(2) - qi, tj = T(2) - qj;
    T gi = qi < T(1) ? o.gc2 * (T(2.25) * qi - T(3))
                     : T(-0.75) * o.gc1 * (ti * ti) * invr;
    gi = qi < T(2) ? gi : T(0);
    T gj = qj < T(1) ? F(FGC2, k) * (T(2.25) * qj - T(3))
                     : T(-0.75) * F(FGC1, k) * (tj * tj) * invr;
    gj = qj < T(2) ? gj : T(0);
    const T gbar = T(0.5) * (gi + gj);

    const T dvx = o.vx - F(FVX, k), dvy = o.vy - F(FVY, k),
            dvz = o.vz - F(FVZ, k);
    const T vdotr = dvx * dx + dvy * dy + dvz * dz;
    const T hbar = T(0.5) * (o.h + F(FH, k));
    const T mu_den = r2 + epsv * hbar * hbar;
    T mu = Num<T>::template div<FAST>(hbar * vdotr, mu_den);
    mu = vdotr < T(0) ? mu : T(0);
    const T cbar = T(0.5) * (o.cs + F(FCS, k));
    const T rhobar = T(0.5) * (o.rho + F(FRHO, k));
    T Pi = Num<T>::template div<FAST>((beta * mu - alpha * cbar) * mu,
                                      rhobar);
    if (BF) Pi = Pi * (T(0.5) * (o.bf + F(FBF, k)));

    const T m = F(FM, k);
    const T cigi = o.ci * gi;
    const T pigb = Pi * gbar;
    const T fcoef = m * (cigi + F(FCI, k) * gj + pigb);
    acc.ax -= fcoef * dx;
    acc.ay -= fcoef * dy;
    acc.az -= fcoef * dz;
    acc.du += m * (cigi + T(0.5) * pigb) * vdotr;
  }
}

template <typename T, bool BF, bool FAST>
__global__ void forces_kernel(const T* __restrict__ win,
                              const int* __restrict__ w_lo,
                              const int* __restrict__ w_nact, int Ns,
                              int group, T alpha, T beta, T epsv,
                              T* __restrict__ acc_out,
                              T* __restrict__ du_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= Ns) return;
  int lo[NSEG], hi[NSEG];
  const int active = load_windows(w_lo, w_nact, i / group, lo, hi);
  ForceSums<T> a{T(0), T(0), T(0), T(0)};
  if (active > 0) {
    auto F = [&](int f) { return win[(size_t)f * Ns + i]; };
    const Own<T> o{F(FX),   F(FY),   F(FZ),  F(FVX), F(FVY),
                   F(FVZ),  F(FH),   F(FINVH), F(FRHO), F(FCS),
                   F(FCI),  F(FGC1), F(FGC2), BF ? F(FBF) : T(0)};
#define SPHAX_SEG(S) \
  force_segment<T, BF, FAST, S>(win, Ns, lo, hi, o, alpha, beta, epsv, a)
    SPHAX_SEG(0); SPHAX_SEG(1); SPHAX_SEG(2); SPHAX_SEG(3); SPHAX_SEG(4);
    SPHAX_SEG(5); SPHAX_SEG(6); SPHAX_SEG(7); SPHAX_SEG(8);
#undef SPHAX_SEG
  }
  acc_out[3 * (size_t)i + 0] = a.ax;
  acc_out[3 * (size_t)i + 1] = a.ay;
  acc_out[3 * (size_t)i + 2] = a.az;
  du_out[i] = a.du;
}

template <typename T>
cudaError_t launch_solve_h_density(const void* win, const void* h0,
                                   const void* w_lo, const void* w_nact,
                                   int Ns, int tile, int group, double sig,
                                   double eta_d, double hcap, int iters,
                                   int bals, void* h, void* rho, void* drdh,
                                   void* div, void* curl, void* stream) {
  const dim3 grid(Ns / tile), block(tile);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto args = [&](auto kernel) {
    kernel<<<grid, block, 0, st>>>(
        static_cast<const T*>(win), static_cast<const T*>(h0),
        static_cast<const int*>(w_lo), static_cast<const int*>(w_nact), Ns,
        group, T(sig), T(eta_d), T(hcap), iters, static_cast<T*>(h),
        static_cast<T*>(rho), static_cast<T*>(drdh), static_cast<T*>(div),
        static_cast<T*>(curl));
  };
  if (bals)
    args(solve_h_density_kernel<T, true>);
  else
    args(solve_h_density_kernel<T, false>);
  return cudaGetLastError();
}

template <typename T, bool FAST>
cudaError_t launch_forces(const void* win, const void* w_lo,
                          const void* w_nact, int Ns, int tile, int group,
                          double alpha, double beta, double epsv, int use_bf,
                          void* acc, void* du, void* stream) {
  const dim3 grid(Ns / tile), block(tile);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto args = [&](auto kernel) {
    kernel<<<grid, block, 0, st>>>(
        static_cast<const T*>(win), static_cast<const int*>(w_lo),
        static_cast<const int*>(w_nact), Ns, group, T(alpha), T(beta),
        T(epsv), static_cast<T*>(acc), static_cast<T*>(du));
  };
  if (use_bf)
    args(forces_kernel<T, true, FAST>);
  else
    args(forces_kernel<T, false, FAST>);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

cudaError_t sphax_solve_h_density_f32(const void* win, const void* h0,
                                      const void* w_lo, const void* w_nact,
                                      int Ns, int tile, int group, double sig,
                                      double eta_d, double hcap, int iters,
                                      int bals, void* h, void* rho,
                                      void* drdh, void* div, void* curl,
                                      void* stream) {
  return launch_solve_h_density<float>(win, h0, w_lo, w_nact, Ns, tile,
                                       group, sig, eta_d, hcap, iters, bals,
                                       h, rho, drdh, div, curl, stream);
}

cudaError_t sphax_solve_h_density_f64(const void* win, const void* h0,
                                      const void* w_lo, const void* w_nact,
                                      int Ns, int tile, int group, double sig,
                                      double eta_d, double hcap, int iters,
                                      int bals, void* h, void* rho,
                                      void* drdh, void* div, void* curl,
                                      void* stream) {
  return launch_solve_h_density<double>(win, h0, w_lo, w_nact, Ns, tile,
                                        group, sig, eta_d, hcap, iters, bals,
                                        h, rho, drdh, div, curl, stream);
}

// fast_math (approximate divides) applies to fp32 only.
cudaError_t sphax_forces_f32(const void* win, const void* w_lo,
                             const void* w_nact, int Ns, int tile, int group,
                             double alpha, double beta, double epsv,
                             int use_bf, int fast, void* acc, void* du,
                             void* stream) {
  if (fast)
    return launch_forces<float, true>(win, w_lo, w_nact, Ns, tile, group,
                                      alpha, beta, epsv, use_bf, acc, du,
                                      stream);
  return launch_forces<float, false>(win, w_lo, w_nact, Ns, tile, group,
                                     alpha, beta, epsv, use_bf, acc, du,
                                     stream);
}

cudaError_t sphax_forces_f64(const void* win, const void* w_lo,
                             const void* w_nact, int Ns, int tile, int group,
                             double alpha, double beta, double epsv,
                             int use_bf, int fast, void* acc, void* du,
                             void* stream) {
  (void)fast;
  return launch_forces<double, false>(win, w_lo, w_nact, Ns, tile, group,
                                      alpha, beta, epsv, use_bf, acc, du,
                                      stream);
}

const char* sphax_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

// Kernels A and C of the sorted pencil-window engine, for Hopper (sm_90a).
//
// Replaces (TPU Pallas kernels):
//   kernel A  sphax/physics/pallas_kernels.py:315  solve_h_density
//   kernel C  sphax/physics/pallas_kernels.py:563  forces, with its fused P3M
//             `grav=(rs, eps)` branch (:592-599, :747-769) as the GRAV mode
// Both are templates on the dimension DIM, instantiated for DIM = 3, 2 and
// 1 (the Pallas kernels' dim-generic code, :337-362, :480-489, :523-531,
// :583-618). A row-group has NSEG = 3^(DIM-1) pencil segments: one in 1D,
// where the dedup has nothing to compare and the curl is zero (:529-530).
// The GRAV mode is 3D only, as the P3M mesh is. Each kernel also has a
// compact walk (`*_compact_kernel`, the Pallas kernels' spec.cwidth > 0
// mode, :195-236), described below.
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
// design does about it: the compact mode below walks about half the rows.
// Finer groups and staging the candidates in shared memory are later work.
//
// In 2D (the Kelvin-Helmholtz problem) a row has about 21 neighbours inside
// 2h (pi (2 eta)^2 with eta = 1.3), and its group walks 3 segments, each
// about a group's rows plus the fast axis's reach of 2 fast_sub + 1 fine
// cells plus up to 128 rows of alignment: 753 candidate rows per real row
// at N = 1,572,864 (kh n=1024, read off w_nact by chip_smoke.py), so the
// walk is bound, as in 3D, by the distance test of candidates that lie
// outside the support.
//
// In 1D a row has about 5 neighbours inside 2h (4 eta with eta = 1.3) and
// its group walks one segment of about a group's rows plus the reach on
// either side plus the alignment, so nearly every candidate fails the
// support test and the walk is bound by that test, as above.
//
// The compact mode (spec.cwidth > 0; the Pallas kernels' `_compact_view`,
// pallas_kernels.py:195-236, entered at :346-351 and :619-626, dedup
// skipped at :446 and :691) walks each group's compacted candidate list
// instead: the disjoint runs [c_lo[g,s], c_lo[g,s] + c_len[g,s]) in
// segment order, cut at cwidth rows in all, as window.compact_index cuts
// its table. The runs are walked in place in the same SoA [F, Ns] arrays,
// unaligned, with no dedup compares and no gathered buffer (the Pallas
// path gathers a [F, n_groups * cwidth] copy, 1.9 GB a call at N = 1e6).
// Same pairs as the in-place walk, so the same bound; at the bench
// configuration a group walks about 1,064 rows per row instead of 2,217.
// The in-place and compact kernels are separate __global__ templates over
// one __forceinline__ row body, so the in-place kernels keep their names
// and their code.
//
// Kernel C's GRAV mode adds the screened P3M short range
// G m_j S(r) (r^2 + eps^2)^-3/2 dx for every candidate with 0 < r^2 <=
// cutoff^2, ahead of the SPH support exit: the screened force reaches to
// 4.5 r_s <= cutoff, well past 2h, so most of its pairs lie outside both
// supports. It uses the native erfc (the TPU needed a polynomial) and one
// exp shared with the derivative term, and it always divides exactly. The
// three split scalars (0.5/rs, 1/(rs sqrt(pi)), eps^2) come from a device
// pointer, because rs is a device tensor; G and cutoff^2 are static. The
// mode adds an erfc, an exp and an rsqrt to every candidate within the
// cutoff, not only to those within the support.
//
// Every launcher returns cudaGetLastError() right after its launch.

#include <cuda_runtime.h>

#include <type_traits>
#include <utility>

namespace {

constexpr int BLK = 128;  // rows per w_nact block

// 3^(dim-1) pencil segments per row-group
__host__ __device__ constexpr int nseg(int dim) {
  return dim <= 1 ? 1 : 3 * nseg(dim - 1);
}

template <typename T> struct Num;

template <> struct Num<float> {
  static constexpr float tiny = 1e-30f;
  static __device__ __forceinline__ float rsqrt(float x) { return rsqrtf(x); }
  static __device__ __forceinline__ float sqrt(float x) { return sqrtf(x); }
  static __device__ __forceinline__ float exp(float x) { return expf(x); }
  static __device__ __forceinline__ float erfc(float x) { return erfcf(x); }
  template <bool FAST>
  static __device__ __forceinline__ float div(float a, float b) {
    return FAST ? __fdividef(a, b) : a / b;
  }
};

template <> struct Num<double> {
  static constexpr double tiny = 1e-300;
  static __device__ __forceinline__ double rsqrt(double x) { return ::rsqrt(x); }
  static __device__ __forceinline__ double sqrt(double x) { return ::sqrt(x); }
  static __device__ __forceinline__ double exp(double x) { return ::exp(x); }
  static __device__ __forceinline__ double erfc(double x) { return ::erfc(x); }
  template <bool FAST>
  static __device__ __forceinline__ double div(double a, double b) {
    return a / b;
  }
};

// The group's candidate ranges; returns the total active block count.
template <int NSEG>
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

// The group's compacted runs, cut at cwidth rows in all; returns the
// total row count.
template <int NSEG>
__device__ __forceinline__ int load_runs(const int* __restrict__ c_lo,
                                         const int* __restrict__ c_len,
                                         int g, int cwidth, int (&lo)[NSEG],
                                         int (&hi)[NSEG]) {
  int total = 0;
#pragma unroll
  for (int s = 0; s < NSEG; ++s) {
    const int len = min(c_len[g * NSEG + s], cwidth - total);
    lo[s] = c_lo[g * NSEG + s];
    hi[s] = lo[s] + len;
    total += len;
  }
  return total;
}

// The group's candidate ranges of either walk; returns the count that
// says whether the group has any candidate.
template <bool COMPACT, int NSEG>
__device__ __forceinline__ int load_ranges(const int* __restrict__ tab_lo,
                                           const int* __restrict__ tab_n,
                                           int g, int cwidth,
                                           int (&lo)[NSEG],
                                           int (&hi)[NSEG]) {
  if constexpr (COMPACT)
    return load_runs(tab_lo, tab_n, g, cwidth, lo, hi);
  else
    return load_windows(tab_lo, tab_n, g, lo, hi);
}

// True when row k lies in a segment before s (already counted).
template <int S, int NSEG>
__device__ __forceinline__ bool seen_before(int k, const int (&lo)[NSEG],
                                            const int (&hi)[NSEG]) {
  bool dup = false;
#pragma unroll
  for (int sp = 0; sp < S; ++sp) dup |= (k >= lo[sp]) & (k < hi[sp]);
  return dup;
}

// The per-axis work is straight-line code, never a loop: a loop in a
// walk's body, even one of constant trip count, changes how nvcc unrolls
// the walk around it, and the 3D kernels would no longer compile to the
// code they had before the template.
template <int N> using Axes = std::make_integer_sequence<int, N>;

// f(0), f(1), ..., f(N - 1)
template <typename F, int... D>
__device__ __forceinline__ void each_axis(std::integer_sequence<int, D...>,
                                          F&& f) {
  (f(D), ...);
}

// a . b summed in axis order: (a0 b0 + a1 b1) + a2 b2
template <typename T, int DIM, int... D>
__device__ __forceinline__ T dot_(const T (&a)[DIM], const T (&b)[DIM],
                                  std::integer_sequence<int, D...>) {
  return (... + (a[D] * b[D]));
}

template <typename T, int DIM>
__device__ __forceinline__ T dot(const T (&a)[DIM], const T (&b)[DIM]) {
  return dot_(a, b, Axes<DIM>{});
}

// ---------------------------------------------------------------------------
// kernel A: Newton-h + density + d rho/d h (+ Balsara div/curl sums)
// ---------------------------------------------------------------------------

template <typename T, int DIM>
struct DensSums {
  T rho, drdh, div;
  // 3D: the curl vector; 2D: its one component; 1D: stays zero
  T curl[DIM == 3 ? 3 : 1];
};

// SoA rows of the density window: DIM positions, m (, DIM velocities).
// DEDUP skips rows of earlier segments (the in-place windows overlap; the
// compact runs do not).
template <typename T, int DIM, bool BALS, bool DEDUP, int S>
__device__ __forceinline__ void density_segment(
    const T* __restrict__ win, int Ns, const int (&lo)[nseg(DIM)],
    const int (&hi)[nseg(DIM)], const T (&xi)[DIM], const T (&vi)[DIM],
    T invh, T sigd, DensSums<T, DIM>& acc) {
  const T* X[DIM];
  each_axis(Axes<DIM>{}, [&](int d) { X[d] = win + d * (size_t)Ns; });
  const T* M = win + DIM * (size_t)Ns;
  for (int k = lo[S]; k < hi[S]; ++k) {
    if constexpr (DEDUP) {
      if (seen_before<S>(k, lo, hi)) continue;
    }
    T dx[DIM];
    each_axis(Axes<DIM>{}, [&](int d) { dx[d] = xi[d] - X[d][k]; });
    const T r2 = dot(dx, dx);
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
      const T* V[DIM];
      each_axis(Axes<DIM>{},
                [&](int d) { V[d] = win + (DIM + 1 + d) * (size_t)Ns; });
      const T mw = m * (dwdq * invh * invr);
      T dv[DIM];
      each_axis(Axes<DIM>{}, [&](int d) { dv[d] = vi[d] - V[d][k]; });
      acc.div += mw * dot(dv, dx);
      if constexpr (DIM == 3) {
        acc.curl[0] += mw * (dv[1] * dx[2] - dv[2] * dx[1]);
        acc.curl[1] += mw * (dv[2] * dx[0] - dv[0] * dx[2]);
        acc.curl[2] += mw * (dv[0] * dx[1] - dv[1] * dx[0]);
      } else if constexpr (DIM == 2) {
        acc.curl[0] += mw * (dv[0] * dx[1] - dv[1] * dx[0]);
      }
    }
  }
}

// every segment in order, unrolled at compile time
template <typename T, int DIM, bool BALS, bool DEDUP, int... S>
__device__ __forceinline__ void density_segments(
    std::integer_sequence<int, S...>, const T* __restrict__ win, int Ns,
    const int (&lo)[nseg(DIM)], const int (&hi)[nseg(DIM)],
    const T (&xi)[DIM], const T (&vi)[DIM], T invh, T sigd,
    DensSums<T, DIM>& acc) {
  (density_segment<T, DIM, BALS, DEDUP, S>(win, Ns, lo, hi, xi, vi, invh,
                                           sigd, acc), ...);
}

template <typename T, int DIM, bool BALS, bool DEDUP>
__device__ __forceinline__ DensSums<T, DIM> density_walk(
    const T* __restrict__ win, int Ns, const int (&lo)[nseg(DIM)],
    const int (&hi)[nseg(DIM)], const T (&xi)[DIM], const T (&vi)[DIM], T h,
    T sig) {
  const T invh = T(1) / h;
  T sigd = sig;  // sig / h^DIM
  each_axis(Axes<DIM>{}, [&](int) { sigd *= invh; });
  DensSums<T, DIM> a{};
  density_segments<T, DIM, BALS, DEDUP>(Axes<nseg(DIM)>{}, win, Ns, lo, hi,
                                        xi, vi, invh, sigd, a);
  return a;
}

// pallas_kernels.py newton_update: same clamps and thresholds.
template <typename T, int DIM>
__device__ __forceinline__ T newton_update(T h, T rho, T drdh, T m_safe,
                                           T eta_d, T hcap) {
  rho = rho > T(1e-30) ? rho : T(1e-30);
  T hd = h;  // h^DIM
  each_axis(Axes<DIM - 1>{}, [&](int) { hd *= h; });
  const T rho_h = m_safe * eta_d / hd;
  const T phi = rho - rho_h;
  T dphi = drdh + T(DIM) * rho_h / h;
  if (fabs(dphi) < T(1e-30)) dphi = T(-1e-30);
  T dh = -phi / dphi;
  dh = dh < T(-0.5) * h ? T(-0.5) * h : dh;
  dh = dh > T(0.5) * h ? T(0.5) * h : dh;
  const T hn = h + dh;
  return hn < hcap ? hn : hcap;
}

// One sorted row of kernel A. The tables are (w_lo, w_nact) in the
// in-place walk and (c_lo, c_len) in the compact one; cwidth is read only
// by the compact walk.
template <typename T, int DIM, bool BALS, bool COMPACT>
__device__ __forceinline__ void solve_h_density_row(
    const T* __restrict__ win, const T* __restrict__ h0,
    const int* __restrict__ tab_lo, const int* __restrict__ tab_n, int Ns,
    int group, int cwidth, T sig, T eta_d, T hcap, int iters,
    T* __restrict__ h_out, T* __restrict__ rho_out,
    T* __restrict__ drdh_out, T* __restrict__ div_out,
    T* __restrict__ curl_out) {
  constexpr int NSEG = nseg(DIM);
  constexpr bool DEDUP = !COMPACT;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= Ns) return;
  int lo[NSEG], hi[NSEG];
  const int active =
      load_ranges<COMPACT>(tab_lo, tab_n, i / group, cwidth, lo, hi);
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
  T xi[DIM], vi[DIM];
  each_axis(Axes<DIM>{}, [&](int d) { xi[d] = win[(size_t)d * Ns + i]; });
  const T mi = win[DIM * (size_t)Ns + i];
  const T m_safe = mi > T(1e-30) ? mi : T(1e-30);
  each_axis(Axes<DIM>{}, [&](int d) {
    vi[d] = BALS ? win[(DIM + 1 + d) * (size_t)Ns + i] : T(0);
  });
  for (int it = 0; it < iters; ++it) {
    const DensSums<T, DIM> a =
        density_walk<T, DIM, false, DEDUP>(win, Ns, lo, hi, xi, vi, h, sig);
    h = newton_update<T, DIM>(h, a.rho, a.drdh, m_safe, eta_d, hcap);
  }
  const DensSums<T, DIM> a =
      density_walk<T, DIM, BALS, DEDUP>(win, Ns, lo, hi, xi, vi, h, sig);
  h_out[i] = h;
  rho_out[i] = a.rho;
  drdh_out[i] = a.drdh;
  if (BALS) {
    div_out[i] = a.div;
    if constexpr (DIM == 3)
      curl_out[i] = Num<T>::sqrt(a.curl[0] * a.curl[0] +
                                 a.curl[1] * a.curl[1] +
                                 a.curl[2] * a.curl[2]);
    else
      curl_out[i] = fabs(a.curl[0]);
  }
}

template <typename T, int DIM, bool BALS>
__global__ void solve_h_density_kernel(
    const T* __restrict__ win, const T* __restrict__ h0,
    const int* __restrict__ w_lo, const int* __restrict__ w_nact, int Ns,
    int group, T sig, T eta_d, T hcap, int iters, T* __restrict__ h_out,
    T* __restrict__ rho_out, T* __restrict__ drdh_out,
    T* __restrict__ div_out, T* __restrict__ curl_out) {
  solve_h_density_row<T, DIM, BALS, false>(win, h0, w_lo, w_nact, Ns, group,
                                           0, sig, eta_d, hcap, iters, h_out,
                                           rho_out, drdh_out, div_out,
                                           curl_out);
}

template <typename T, int DIM, bool BALS>
__global__ void solve_h_density_compact_kernel(
    const T* __restrict__ win, const T* __restrict__ h0,
    const int* __restrict__ c_lo, const int* __restrict__ c_len, int Ns,
    int group, int cwidth, T sig, T eta_d, T hcap, int iters,
    T* __restrict__ h_out, T* __restrict__ rho_out,
    T* __restrict__ drdh_out, T* __restrict__ div_out,
    T* __restrict__ curl_out) {
  solve_h_density_row<T, DIM, BALS, true>(win, h0, c_lo, c_len, Ns, group,
                                          cwidth, sig, eta_d, hcap, iters,
                                          h_out, rho_out, drdh_out, div_out,
                                          curl_out);
}

// ---------------------------------------------------------------------------
// kernel C: symmetrized pressure force + Monaghan viscosity + du/dt
// ---------------------------------------------------------------------------

// SoA field rows of the forces window: DIM positions, DIM velocities, then
// m h invh rho cs ci gc1 gc2 (bf)
template <int DIM>
struct FRow {
  static constexpr int X = 0, V = DIM, M = 2 * DIM, H = M + 1, INVH = M + 2,
                       RHO = M + 3, CS = M + 4, CI = M + 5, GC1 = M + 6,
                       GC2 = M + 7, BF = M + 8;
};

template <typename T, int DIM>
struct ForceSums {
  T a[DIM];
  T du;
};

template <typename T, int DIM>
struct Own {
  T x[DIM], v[DIM];
  T h, invh, rho, cs, ci, gc1, gc2, bf;
};

// The P3M split scalars and constants of the GRAV mode.
template <typename T>
struct Grav {
  T x_scale, sp, eps2, G, rcut2;  // 0.5/rs, 1/(rs sqrt(pi)), eps^2
};

// G S(r) (r^2 + eps^2)^-3/2 inside the hard cut 0 < r^2 <= cutoff^2, else 0.
template <typename T>
__device__ __forceinline__ T grav_coef(T r2, T r, const Grav<T>& g) {
  if (!(r2 > T(0) && r2 <= g.rcut2)) return T(0);
  const T x = r * g.x_scale;
  const T e = Num<T>::exp(-x * x);
  const T screen = Num<T>::erfc(x) + r * g.sp * e;
  const T tg = Num<T>::rsqrt(r2 + g.eps2);
  return g.G * screen * (tg * tg * tg);
}

template <typename T, int DIM, bool BF, bool FAST, bool GRAV, bool DEDUP,
          int S>
__device__ __forceinline__ void force_segment(
    const T* __restrict__ win, int Ns, const int (&lo)[nseg(DIM)],
    const int (&hi)[nseg(DIM)], const Own<T, DIM>& o, T alpha, T beta,
    T epsv, const Grav<T>& g, ForceSums<T, DIM>& acc) {
  using R = FRow<DIM>;
  auto F = [&](int f, int k) { return win[(size_t)f * Ns + k]; };
  for (int k = lo[S]; k < hi[S]; ++k) {
    if constexpr (DEDUP) {
      if (seen_before<S>(k, lo, hi)) continue;
    }
    T dx[DIM];
    each_axis(Axes<DIM>{}, [&](int d) { dx[d] = o.x[d] - F(R::X + d, k); });
    const T r2 = dot(dx, dx);
    const T invr = Num<T>::rsqrt(r2 + Num<T>::tiny);
    const T r = r2 * invr;
    const T gco = GRAV ? grav_coef(r2, r, g) : T(0);
    const T qi = r * o.invh;
    const T qj = r * F(R::INVH, k);
    if (qi >= T(2) && qj >= T(2)) {  // both gradients vanish
      if (GRAV) {
        const T fcoef = F(R::M, k) * gco;
        each_axis(Axes<DIM>{}, [&](int d) { acc.a[d] -= fcoef * dx[d]; });
      }
      continue;
    }
    const T ti = T(2) - qi, tj = T(2) - qj;
    T gi = qi < T(1) ? o.gc2 * (T(2.25) * qi - T(3))
                     : T(-0.75) * o.gc1 * (ti * ti) * invr;
    gi = qi < T(2) ? gi : T(0);
    T gj = qj < T(1) ? F(R::GC2, k) * (T(2.25) * qj - T(3))
                     : T(-0.75) * F(R::GC1, k) * (tj * tj) * invr;
    gj = qj < T(2) ? gj : T(0);
    const T gbar = T(0.5) * (gi + gj);

    T dv[DIM];
    each_axis(Axes<DIM>{}, [&](int d) { dv[d] = o.v[d] - F(R::V + d, k); });
    const T vdotr = dot(dv, dx);
    const T hbar = T(0.5) * (o.h + F(R::H, k));
    const T mu_den = r2 + epsv * hbar * hbar;
    T mu = Num<T>::template div<FAST>(hbar * vdotr, mu_den);
    mu = vdotr < T(0) ? mu : T(0);
    const T cbar = T(0.5) * (o.cs + F(R::CS, k));
    const T rhobar = T(0.5) * (o.rho + F(R::RHO, k));
    T Pi = Num<T>::template div<FAST>((beta * mu - alpha * cbar) * mu,
                                      rhobar);
    if (BF) Pi = Pi * (T(0.5) * (o.bf + F(R::BF, k)));

    const T m = F(R::M, k);
    const T cigi = o.ci * gi;
    const T pigb = Pi * gbar;
    T fsum = cigi + F(R::CI, k) * gj + pigb;
    if (GRAV) fsum += gco;
    const T fcoef = m * fsum;
    each_axis(Axes<DIM>{}, [&](int d) { acc.a[d] -= fcoef * dx[d]; });
    acc.du += m * (cigi + T(0.5) * pigb) * vdotr;
  }
}

template <typename T, int DIM, bool BF, bool FAST, bool GRAV, bool DEDUP,
          int... S>
__device__ __forceinline__ void force_segments(
    std::integer_sequence<int, S...>, const T* __restrict__ win, int Ns,
    const int (&lo)[nseg(DIM)], const int (&hi)[nseg(DIM)],
    const Own<T, DIM>& o, T alpha, T beta, T epsv, const Grav<T>& g,
    ForceSums<T, DIM>& acc) {
  (force_segment<T, DIM, BF, FAST, GRAV, DEDUP, S>(win, Ns, lo, hi, o, alpha,
                                                   beta, epsv, g, acc),
   ...);
}

// One sorted row of kernel C; the tables as in solve_h_density_row.
template <typename T, int DIM, bool BF, bool FAST, bool GRAV, bool COMPACT>
__device__ __forceinline__ void forces_row(
    const T* __restrict__ win, const int* __restrict__ tab_lo,
    const int* __restrict__ tab_n, int Ns, int group, int cwidth, T alpha,
    T beta, T epsv, const T* __restrict__ gsc, T G, T rcut2,
    T* __restrict__ acc_out, T* __restrict__ du_out) {
  static_assert(DIM == 3 || !GRAV, "the GRAV mode is 3D only");
  using R = FRow<DIM>;
  constexpr int NSEG = nseg(DIM);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= Ns) return;
  int lo[NSEG], hi[NSEG];
  const int active =
      load_ranges<COMPACT>(tab_lo, tab_n, i / group, cwidth, lo, hi);
  ForceSums<T, DIM> a{};
  if (active > 0) {
    auto F = [&](int f) { return win[(size_t)f * Ns + i]; };
    Own<T, DIM> o;
    each_axis(Axes<DIM>{}, [&](int d) { o.x[d] = F(R::X + d); });
    each_axis(Axes<DIM>{}, [&](int d) { o.v[d] = F(R::V + d); });
    o.h = F(R::H);
    o.invh = F(R::INVH);
    o.rho = F(R::RHO);
    o.cs = F(R::CS);
    o.ci = F(R::CI);
    o.gc1 = F(R::GC1);
    o.gc2 = F(R::GC2);
    o.bf = BF ? F(R::BF) : T(0);
    Grav<T> g{T(0), T(0), T(0), G, rcut2};
    if (GRAV) {
      g.x_scale = gsc[0];
      g.sp = gsc[1];
      g.eps2 = gsc[2];
    }
    force_segments<T, DIM, BF, FAST, GRAV, !COMPACT>(
        Axes<NSEG>{}, win, Ns, lo, hi, o, alpha, beta, epsv, g, a);
  }
  each_axis(Axes<DIM>{},
            [&](int d) { acc_out[DIM * (size_t)i + d] = a.a[d]; });
  du_out[i] = a.du;
}

template <typename T, int DIM, bool BF, bool FAST, bool GRAV>
__global__ void forces_kernel(const T* __restrict__ win,
                              const int* __restrict__ w_lo,
                              const int* __restrict__ w_nact, int Ns,
                              int group, T alpha, T beta, T epsv,
                              const T* __restrict__ gsc, T G, T rcut2,
                              T* __restrict__ acc_out,
                              T* __restrict__ du_out) {
  forces_row<T, DIM, BF, FAST, GRAV, false>(win, w_lo, w_nact, Ns, group, 0,
                                            alpha, beta, epsv, gsc, G, rcut2,
                                            acc_out, du_out);
}

template <typename T, int DIM, bool BF, bool FAST, bool GRAV>
__global__ void forces_compact_kernel(
    const T* __restrict__ win, const int* __restrict__ c_lo,
    const int* __restrict__ c_len, int Ns, int group, int cwidth, T alpha,
    T beta, T epsv, const T* __restrict__ gsc, T G, T rcut2,
    T* __restrict__ acc_out, T* __restrict__ du_out) {
  forces_row<T, DIM, BF, FAST, GRAV, true>(win, c_lo, c_len, Ns, group,
                                           cwidth, alpha, beta, epsv, gsc, G,
                                           rcut2, acc_out, du_out);
}

// The compact kernels take cwidth after group; `cw` is empty for the
// in-place ones.
template <typename T, int DIM, bool COMPACT>
cudaError_t launch_solve_h_density(const void* win, const void* h0,
                                   const void* tab_lo, const void* tab_n,
                                   int Ns, int tile, int group, int cwidth,
                                   double sig, double eta_d, double hcap,
                                   int iters, int bals, void* h, void* rho,
                                   void* drdh, void* div, void* curl,
                                   void* stream) {
  const dim3 grid(Ns / tile), block(tile);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto run = [&](auto kernel, auto... cw) {
    kernel<<<grid, block, 0, st>>>(
        static_cast<const T*>(win), static_cast<const T*>(h0),
        static_cast<const int*>(tab_lo), static_cast<const int*>(tab_n), Ns,
        group, cw..., T(sig), T(eta_d), T(hcap), iters, static_cast<T*>(h),
        static_cast<T*>(rho), static_cast<T*>(drdh), static_cast<T*>(div),
        static_cast<T*>(curl));
  };
  auto args = [&](auto bals_c) {
    constexpr bool B = decltype(bals_c)::value;
    if constexpr (COMPACT)
      run(solve_h_density_compact_kernel<T, DIM, B>, cwidth);
    else
      run(solve_h_density_kernel<T, DIM, B>);
  };
  if (bals)
    args(std::true_type{});
  else
    args(std::false_type{});
  return cudaGetLastError();
}

// fast_math (approximate divides) applies to fp32 only.
template <typename T, int DIM, bool GRAV, bool COMPACT>
cudaError_t launch_forces(const void* win, const void* tab_lo,
                          const void* tab_n, int Ns, int tile, int group,
                          int cwidth, double alpha, double beta, double epsv,
                          int use_bf, int fast, const void* gsc, double G,
                          double rcut2, void* acc, void* du, void* stream) {
  const dim3 grid(Ns / tile), block(tile);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto run = [&](auto kernel, auto... cw) {
    kernel<<<grid, block, 0, st>>>(
        static_cast<const T*>(win), static_cast<const int*>(tab_lo),
        static_cast<const int*>(tab_n), Ns, group, cw..., T(alpha), T(beta),
        T(epsv), static_cast<const T*>(gsc), T(G), T(rcut2),
        static_cast<T*>(acc), static_cast<T*>(du));
  };
  auto args = [&](auto bf_c, auto fast_c) {
    constexpr bool B = decltype(bf_c)::value, F = decltype(fast_c)::value;
    if constexpr (COMPACT)
      run(forces_compact_kernel<T, DIM, B, F, GRAV>, cwidth);
    else
      run(forces_kernel<T, DIM, B, F, GRAV>);
  };
  constexpr bool F32 = sizeof(T) == 4;
  using Yes = std::true_type;
  using No = std::false_type;
  using Fast = std::bool_constant<F32>;
  if (use_bf && fast && F32)
    args(Yes{}, Fast{});
  else if (use_bf)
    args(Yes{}, No{});
  else if (fast && F32)
    args(No{}, Fast{});
  else
    args(No{}, No{});
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Kernel A: sphax_solve_h_density_{f32,f64} (3D), ..._2d_{f32,f64} (2D),
// ..._1d_{f32,f64} (1D).
#define SPHAX_A_ENTRY(NAME, T, DIM)                                         \
  cudaError_t NAME(const void* win, const void* h0, const void* w_lo,       \
                   const void* w_nact, int Ns, int tile, int group,         \
                   double sig, double eta_d, double hcap, int iters,        \
                   int bals, void* h, void* rho, void* drdh, void* div,     \
                   void* curl, void* stream) {                              \
    return launch_solve_h_density<T, DIM, false>(                         \
        win, h0, w_lo, w_nact, Ns, tile, group, 0, sig, eta_d, hcap, iters, \
        bals, h, rho, drdh, div, curl, stream);                             \
  }
SPHAX_A_ENTRY(sphax_solve_h_density_f32, float, 3)
SPHAX_A_ENTRY(sphax_solve_h_density_f64, double, 3)
SPHAX_A_ENTRY(sphax_solve_h_density_2d_f32, float, 2)
SPHAX_A_ENTRY(sphax_solve_h_density_2d_f64, double, 2)
SPHAX_A_ENTRY(sphax_solve_h_density_1d_f32, float, 1)
SPHAX_A_ENTRY(sphax_solve_h_density_1d_f64, double, 1)
#undef SPHAX_A_ENTRY

// Kernel A's compact walk: sphax_solve_h_density_compact_{f32,f64} (3D),
// ..._compact_2d_{f32,f64} (2D), ..._compact_1d_{f32,f64} (1D); the runs
// c_lo, c_len and cwidth in place of w_lo, w_nact.
#define SPHAX_AC_ENTRY(NAME, T, DIM)                                        \
  cudaError_t NAME(const void* win, const void* h0, const void* c_lo,       \
                   const void* c_len, int Ns, int tile, int group,          \
                   int cwidth, double sig, double eta_d, double hcap,       \
                   int iters, int bals, void* h, void* rho, void* drdh,     \
                   void* div, void* curl, void* stream) {                   \
    return launch_solve_h_density<T, DIM, true>(                          \
        win, h0, c_lo, c_len, Ns, tile, group, cwidth, sig, eta_d, hcap,    \
        iters, bals, h, rho, drdh, div, curl, stream);                      \
  }
SPHAX_AC_ENTRY(sphax_solve_h_density_compact_f32, float, 3)
SPHAX_AC_ENTRY(sphax_solve_h_density_compact_f64, double, 3)
SPHAX_AC_ENTRY(sphax_solve_h_density_compact_2d_f32, float, 2)
SPHAX_AC_ENTRY(sphax_solve_h_density_compact_2d_f64, double, 2)
SPHAX_AC_ENTRY(sphax_solve_h_density_compact_1d_f32, float, 1)
SPHAX_AC_ENTRY(sphax_solve_h_density_compact_1d_f64, double, 1)
#undef SPHAX_AC_ENTRY

// Kernel C without gravity: sphax_forces_{f32,f64} (3D), ..._2d_* (2D),
// ..._1d_* (1D).
#define SPHAX_C_ENTRY(NAME, T, DIM)                                         \
  cudaError_t NAME(const void* win, const void* w_lo, const void* w_nact,   \
                   int Ns, int tile, int group, double alpha, double beta,  \
                   double epsv, int use_bf, int fast, void* acc, void* du,  \
                   void* stream) {                                          \
    return launch_forces<T, DIM, false, false>(                           \
        win, w_lo, w_nact, Ns, tile, group, 0, alpha, beta, epsv, use_bf,   \
        fast, nullptr, 0.0, 0.0, acc, du, stream);                          \
  }
SPHAX_C_ENTRY(sphax_forces_f32, float, 3)
SPHAX_C_ENTRY(sphax_forces_f64, double, 3)
SPHAX_C_ENTRY(sphax_forces_2d_f32, float, 2)
SPHAX_C_ENTRY(sphax_forces_2d_f64, double, 2)
SPHAX_C_ENTRY(sphax_forces_1d_f32, float, 1)
SPHAX_C_ENTRY(sphax_forces_1d_f64, double, 1)
#undef SPHAX_C_ENTRY

// Kernel C's compact walk without gravity: sphax_forces_compact_* (3D),
// ..._compact_2d_* (2D), ..._compact_1d_* (1D).
#define SPHAX_CC_ENTRY(NAME, T, DIM)                                        \
  cudaError_t NAME(const void* win, const void* c_lo, const void* c_len,    \
                   int Ns, int tile, int group, int cwidth, double alpha,   \
                   double beta, double epsv, int use_bf, int fast,          \
                   void* acc, void* du, void* stream) {                     \
    return launch_forces<T, DIM, false, true>(                            \
        win, c_lo, c_len, Ns, tile, group, cwidth, alpha, beta, epsv,       \
        use_bf, fast, nullptr, 0.0, 0.0, acc, du, stream);                  \
  }
SPHAX_CC_ENTRY(sphax_forces_compact_f32, float, 3)
SPHAX_CC_ENTRY(sphax_forces_compact_f64, double, 3)
SPHAX_CC_ENTRY(sphax_forces_compact_2d_f32, float, 2)
SPHAX_CC_ENTRY(sphax_forces_compact_2d_f64, double, 2)
SPHAX_CC_ENTRY(sphax_forces_compact_1d_f32, float, 1)
SPHAX_CC_ENTRY(sphax_forces_compact_1d_f64, double, 1)
#undef SPHAX_CC_ENTRY

// Kernel C with the fused P3M short range (3D): gsc -> the three split
// scalars on the device.
#define SPHAX_CG_ENTRY(NAME, T)                                             \
  cudaError_t NAME(const void* win, const void* w_lo, const void* w_nact,   \
                   int Ns, int tile, int group, double alpha, double beta,  \
                   double epsv, int use_bf, int fast, const void* gsc,      \
                   double G, double rcut2, void* acc, void* du,             \
                   void* stream) {                                          \
    return launch_forces<T, 3, true, false>(                              \
        win, w_lo, w_nact, Ns, tile, group, 0, alpha, beta, epsv, use_bf,   \
        fast, gsc, G, rcut2, acc, du, stream);                              \
  }
SPHAX_CG_ENTRY(sphax_forces_grav_f32, float)
SPHAX_CG_ENTRY(sphax_forces_grav_f64, double)
#undef SPHAX_CG_ENTRY

// Kernel C's compact walk with the fused P3M short range (3D).
#define SPHAX_CGC_ENTRY(NAME, T)                                            \
  cudaError_t NAME(const void* win, const void* c_lo, const void* c_len,    \
                   int Ns, int tile, int group, int cwidth, double alpha,   \
                   double beta, double epsv, int use_bf, int fast,          \
                   const void* gsc, double G, double rcut2, void* acc,      \
                   void* du, void* stream) {                                \
    return launch_forces<T, 3, true, true>(                               \
        win, c_lo, c_len, Ns, tile, group, cwidth, alpha, beta, epsv,       \
        use_bf, fast, gsc, G, rcut2, acc, du, stream);                      \
  }
SPHAX_CGC_ENTRY(sphax_forces_grav_compact_f32, float)
SPHAX_CGC_ENTRY(sphax_forces_grav_compact_f64, double)
#undef SPHAX_CGC_ENTRY

const char* sphax_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

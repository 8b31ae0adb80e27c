// Saitoh & Makino's timestep limiter on the rung path, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's rung integrator
// (sphax/integrate/rungs.py) has no limiter. sphax_torch/integrate/rungs.py
// runs one of these kernels a tick when a problem sets `limiter=A`
// (sphax_torch/physics/rung_limit.py wraps them and keeps their plain
// versions):
//
//   rung_limit_tick_kernel  over the row-groups that hold a closing row:
//                           each closer i takes the lowest current rung
//                           m_i of its neighbours, its new rung from its
//                           wanted rung r_des capped at m_i + a (A = 2^a)
//                           and the Hernquist-Katz alignment, then pushes
//                           r_i' + a to each neighbour j that does not
//                           close and sleeps on a rung above it: the wake
//                           target max(r_i' + a, the least rung whose step
//                           from j's opening ends after this tick) lands
//                           in target[j] by atomicMin. It writes m_i, and
//                           counts the closers whose rung the cap lowered.
//   rung_limit_sync_kernel  every real row, at a span's sync point: rung_out
//                           = min(rung, m + a) over the same neighbours; the
//                           wrapper runs the passes that reach the fixed
//                           point.
//
// Neighbours are the pairs kernel C walks: j a particle other than i with
// mass and |x_i - x_j| < 2 max(h_i, h_j), x_j through the window's image
// shift. Rows of the sorted window structure (sphax_torch/neighbors/
// window.py) give the candidates, as for kernels A and C: group g's rows
// [w_lo[g,s], w_lo[g,s] + 128 w_nact[g,s]) for each of the 9 segments
// (3D), each start clipped at the earlier segments' largest end. The
// kernels read the state in original order through the sorted row's
// original index g, so they need no sorted copy of anything.
//
// What bounds them: latency. A tick's closers are a few percent of the rows
// or less, but the kernel must find them: every warp reads its 32 rows'
// g and rung to see whether one closes (two 4-byte loads a row over all
// sorted rows), and most warps then leave. A warp with a closer culls its
// group's candidates against the box of its closers and their largest h,
// as kernels A and C do (the reach 2 max(h_max, h_j), 1e-3 wider), stages
// the survivors in shared memory, and every lane tests each survivor: a
// compare and a min a pair, no reciprocal. The pull and the push are two
// walks of the same candidates, the push only where some closer's r_i' + a
// lies below the top rung; atomics only where a wake-up results.
//
// Bits: the pair test rounds each operation on its own, in the order of
// the plain version (x_i - x_j per axis, (dx^2 + dy^2) + dz^2 against
// (2 max(h_i, h_j))^2, no fused multiply-add), so both give the same
// neighbours, and integer mins give the same rungs. The sorted position is
// pos[g] + shift, rounded as the plain version adds them. No kernel
// allocates, synchronises or keeps state; every launcher returns
// cudaGetLastError() right after its launch.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int BLK = 128;   // rows per w_nact block
constexpr int NSEG = 9;    // pencil segments of a 3D row-group
constexpr int CAP = 256;   // survivors a warp stages before it walks them
constexpr unsigned FULL = 0xffffffffu;

template <typename T>
struct alignas(16) Vec4 {
  T a, b, c, d;
};

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

template <typename T>
__device__ __forceinline__ T big() {
  return sizeof(T) == 4 ? T(3.0e38) : T(1.0e300);
}

template <typename T>
__device__ __forceinline__ T warp_min(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const T u = __shfl_xor_sync(FULL, v, o);
    v = u < v ? u : v;
  }
  return v;
}

template <typename T>
__device__ __forceinline__ T warp_max(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const T u = __shfl_xor_sync(FULL, v, o);
    v = u > v ? u : v;
  }
  return v;
}

// Lane s < NSEG holds segment s's rows [lo, hi), its start clipped at the
// earlier segments' largest end (the ranges rise with the segment, as the
// window build makes them); the other lanes hold an empty range.
struct Ranges {
  int lo, hi;
};

__device__ __forceinline__ Ranges load_ranges(const int* __restrict__ w_lo,
                                              const int* __restrict__ w_nact,
                                              int g, int lane) {
  Ranges r{0, 0};
  int clip = 0, max_hi = 0;
#pragma unroll
  for (int s = 0; s < NSEG; ++s) {
    const int lo = w_lo[g * NSEG + s];
    const int len = BLK * w_nact[g * NSEG + s];
    if (lane == s) {
      r.lo = lo;
      r.hi = lo + len;
      clip = max_hi;
    }
    if (len > 0) max_hi = max(max_hi, lo + len);
  }
  r.lo = max(r.lo, clip);
  return r;
}

// The walking rows of one warp: their positions, h, the box of their
// positions and their largest h.
template <typename T>
struct Rows {
  T x[3];
  T h;
  T lo[3], hi[3];
  T hmax;

  __device__ __forceinline__ T gap2(const T (&p)[3]) const {
    T g2 = T(0);
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const T below = lo[d] - p[d], above = p[d] - hi[d];
      T g = below > above ? below : above;
      g = g > T(0) ? g : T(0);
      g2 += g * g;
    }
    return g2;
  }
};

// |x_i - x_j| < 2 max(h_i, h_j), each operation rounded on its own in the
// plain version's order
template <typename T>
__device__ __forceinline__ bool neighbours(const Rows<T>& r,
                                           const Vec4<T>& e) {
  const T d0 = sub_rn(r.x[0], e.a), d1 = sub_rn(r.x[1], e.b),
          d2 = sub_rn(r.x[2], e.c);
  const T r2 = add_rn(add_rn(mul_rn(d0, d0), mul_rn(d1, d1)), mul_rn(d2, d2));
  const T hm = r.h > e.d ? r.h : e.d;
  const T s = add_rn(hm, hm);
  return r2 < mul_rn(s, s);
}

// One walk of a warp over its group's candidates: the lanes read 32
// candidates a step (g, mass, position through the shift, h and rung), keep
// those with mass within the reach of the box, stage them in candidate
// order, and whenever another step might not fit, call visit(n) on the n
// staged survivors. Warp-uniform control flow.
template <typename T, typename Visit>
__device__ __forceinline__ void cull_and_visit(
    const Ranges& rg, int lane, const Rows<T>& rows, Vec4<T>* ent,
    int2* idx, const int* __restrict__ g, const T* __restrict__ shift,
    const T* __restrict__ pos, const T* __restrict__ h,
    const T* __restrict__ mass, const int* __restrict__ rung, int n,
    Visit&& visit) {
  int s = 0;
  int k0 = __shfl_sync(FULL, rg.lo, 0);
  int kend = __shfl_sync(FULL, rg.hi, 0);
  const T reach = T(2.002);
  for (;;) {
    int nst = 0;
    while (s < NSEG && nst <= CAP - 32) {
      if (k0 >= kend) {
        ++s;
        k0 = __shfl_sync(FULL, rg.lo, s);  // lane NSEG's range is empty
        kend = __shfl_sync(FULL, rg.hi, s);
        continue;
      }
      const int k = k0 + lane;
      bool keep = false;
      Vec4<T> e{};
      int gj = 0;
      if (k < kend) {
        gj = g[k];
        if (gj < n && mass[gj] > T(0)) {
          T p[3];
#pragma unroll
          for (int d = 0; d < 3; ++d)
            p[d] = add_rn(pos[size_t(gj) * 3 + d], shift[size_t(k) * 3 + d]);
          const T hj = h[gj];
          const T rr = reach * (rows.hmax > hj ? rows.hmax : hj);
          keep = rows.gap2(p) < rr * rr;
          e = Vec4<T>{p[0], p[1], p[2], hj};
        }
      }
      const unsigned kept = __ballot_sync(FULL, keep);
      if (keep) {
        const int slot = nst + __popc(kept & ((1u << lane) - 1u));
        ent[slot] = e;
        idx[slot] = make_int2(gj, rung[gj]);
      }
      nst += __popc(kept);
      k0 += 32;
    }
    if (nst == 0) break;
    __syncwarp();
    visit(nst);
    __syncwarp();
  }
}

template <typename T>
__device__ __forceinline__ Rows<T> warp_rows(bool walks, int gi, int i,
                                             const T* __restrict__ pos,
                                             const T* __restrict__ shift,
                                             const T* __restrict__ h) {
  Rows<T> r;
#pragma unroll
  for (int d = 0; d < 3; ++d)
    r.x[d] = walks ? add_rn(pos[size_t(gi) * 3 + d], shift[size_t(i) * 3 + d])
                   : T(0);
  r.h = walks ? h[gi] : T(0);
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    r.lo[d] = warp_min(walks ? r.x[d] : big<T>());
    r.hi[d] = warp_max(walks ? r.x[d] : -big<T>());
  }
  r.hmax = warp_max(r.h);
  return r;
}

__device__ __forceinline__ Vec4<float> load_ent(const Vec4<float>* p) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  return {v.x, v.y, v.z, v.w};
}
__device__ __forceinline__ Vec4<double> load_ent(const Vec4<double>* p) {
  return *p;
}

template <typename T>
__device__ __forceinline__ Vec4<T>* warp_stage() {
  extern __shared__ __align__(16) unsigned char stage_raw[];
  constexpr size_t bytes = CAP * (sizeof(Vec4<T>) + sizeof(int2));
  return reinterpret_cast<Vec4<T>*>(stage_raw + (threadIdx.x >> 5) * bytes);
}

// The lowest rung among a walking row's neighbours (n_rungs - 1 where it
// has none).
template <typename T>
__device__ __forceinline__ int neighbour_min(
    const Ranges& rg, int lane, bool walks, int gi, const Rows<T>& rows,
    Vec4<T>* ent, int2* idx, const int* g, const T* shift, const T* pos,
    const T* h, const T* mass, const int* rung, int n, int n_rungs) {
  int m = n_rungs - 1;
  cull_and_visit<T>(rg, lane, rows, ent, idx, g, shift, pos, h, mass, rung,
                    n, [&](int nst) {
                      for (int slot = 0; slot < nst; ++slot) {
                        const Vec4<T> e = load_ent(ent + slot);
                        const int2 jr = idx[slot];
                        if (walks && jr.x != gi && jr.y < m &&
                            neighbours(rows, e))
                          m = jr.y;
                      }
                    });
  return m;
}

template <typename T>
__global__ void __launch_bounds__(THREADS) rung_limit_tick_kernel(
    const int* __restrict__ g, const unsigned char* __restrict__ is_real,
    const T* __restrict__ shift, const int* __restrict__ w_lo,
    const int* __restrict__ w_nact, int Ns, int group, int n,
    const T* __restrict__ pos, const T* __restrict__ h,
    const T* __restrict__ mass, const int* __restrict__ rung,
    const int* __restrict__ r_des, int k, int a, int align, int n_rungs,
    int* __restrict__ m_out, int* __restrict__ target,
    int* __restrict__ limited) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= Ns) return;  // Ns is a multiple of THREADS: whole warps only
  const int lane = threadIdx.x & 31;
  const int gi = g[i];
  const bool real = is_real[i] && gi < n;
  const int ri = real ? rung[gi] : 0;
  const bool walks = real && (((k + 1) & ((1 << ri) - 1)) == 0);
  if (!__any_sync(FULL, walks)) return;
  const Rows<T> rows = warp_rows<T>(walks, gi, i, pos, shift, h);
  const Ranges rg = load_ranges(w_lo, w_nact, i / group, lane);
  Vec4<T>* const ent = warp_stage<T>();
  int2* const idx = reinterpret_cast<int2*>(ent + CAP);
  const int m = neighbour_min<T>(rg, lane, walks, gi, rows, ent, idx, g,
                                 shift, pos, h, mass, rung, n, n_rungs);
  // the closer's new rung, capped and aligned as close_rungs makes it
  const int rd = walks ? r_des[gi] : 0;
  const int rl = min(rd, m + a);
  const int rn = rl < ri ? rl : min(rl, align);
  const int ru = rd < ri ? rd : min(rd, align);
  const unsigned low = __ballot_sync(FULL, walks && rn < ru);
  if (lane == 0 && low) atomicAdd(limited, __popc(low));
  if (walks) m_out[gi] = m;
  // the wake-up: only a neighbour sleeping above rn + a can be shortened
  const int pv = rn + a;
  if (!__any_sync(FULL, walks && pv < n_rungs - 1)) return;
  cull_and_visit<T>(
      rg, lane, rows, ent, idx, g, shift, pos, h, mass, rung, n,
      [&](int nst) {
        for (int slot = 0; slot < nst; ++slot) {
          const int2 jr = idx[slot];
          const int rj = jr.y;
          if (!walks || jr.x == gi || rj <= pv) continue;
          const int mask = (1 << rj) - 1;
          if (((k + 1) & mask) == 0) continue;  // j closes this tick
          const Vec4<T> e = load_ent(ent + slot);
          if (!neighbours(rows, e)) continue;
          // the least rung whose step from j's opening ends after tick k
          const int need = 32 - __clz((k & mask) + 1);
          const int v = pv > need ? pv : need;
          if (v < rj) atomicMin(target + jr.x, v);
        }
      });
}

template <typename T>
__global__ void __launch_bounds__(THREADS) rung_limit_sync_kernel(
    const int* __restrict__ g, const unsigned char* __restrict__ is_real,
    const T* __restrict__ shift, const int* __restrict__ w_lo,
    const int* __restrict__ w_nact, int Ns, int group, int n,
    const T* __restrict__ pos, const T* __restrict__ h,
    const T* __restrict__ mass, const int* __restrict__ rung, int a,
    int n_rungs, int* __restrict__ rung_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= Ns) return;
  const int lane = threadIdx.x & 31;
  const int gi = g[i];
  const bool walks = is_real[i] && gi < n;
  if (!__any_sync(FULL, walks)) return;
  const Rows<T> rows = warp_rows<T>(walks, gi, i, pos, shift, h);
  const Ranges rg = load_ranges(w_lo, w_nact, i / group, lane);
  Vec4<T>* const ent = warp_stage<T>();
  int2* const idx = reinterpret_cast<int2*>(ent + CAP);
  const int m = neighbour_min<T>(rg, lane, walks, gi, rows, ent, idx, g,
                                 shift, pos, h, mass, rung, n, n_rungs);
  if (walks) rung_out[gi] = min(rung[gi], m + a);
}

inline size_t stage_bytes(size_t item) {
  return size_t(THREADS / 32) * CAP * (item + sizeof(int2));
}

template <typename T>
cudaError_t launch_tick(const void* g, const void* is_real, const void* shift,
                        const void* w_lo, const void* w_nact, int Ns,
                        int group, int n, const void* pos, const void* h,
                        const void* mass, const void* rung, const void* r_des,
                        int k, int a, int align, int n_rungs, void* m_out,
                        void* target, void* limited, void* stream) {
  if (Ns <= 0) return cudaSuccess;
  if (Ns % THREADS || group % 32) return cudaErrorInvalidValue;
  rung_limit_tick_kernel<T>
      <<<Ns / THREADS, THREADS, stage_bytes(sizeof(Vec4<T>)),
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const int*>(g),
          static_cast<const unsigned char*>(is_real),
          static_cast<const T*>(shift), static_cast<const int*>(w_lo),
          static_cast<const int*>(w_nact), Ns, group, n,
          static_cast<const T*>(pos), static_cast<const T*>(h),
          static_cast<const T*>(mass), static_cast<const int*>(rung),
          static_cast<const int*>(r_des), k, a, align, n_rungs,
          static_cast<int*>(m_out), static_cast<int*>(target),
          static_cast<int*>(limited));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_sync(const void* g, const void* is_real, const void* shift,
                        const void* w_lo, const void* w_nact, int Ns,
                        int group, int n, const void* pos, const void* h,
                        const void* mass, const void* rung, int a,
                        int n_rungs, void* rung_out, void* stream) {
  if (Ns <= 0) return cudaSuccess;
  if (Ns % THREADS || group % 32) return cudaErrorInvalidValue;
  rung_limit_sync_kernel<T>
      <<<Ns / THREADS, THREADS, stage_bytes(sizeof(Vec4<T>)),
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const int*>(g),
          static_cast<const unsigned char*>(is_real),
          static_cast<const T*>(shift), static_cast<const int*>(w_lo),
          static_cast<const int*>(w_nact), Ns, group, n,
          static_cast<const T*>(pos), static_cast<const T*>(h),
          static_cast<const T*>(mass), static_cast<const int*>(rung), a,
          n_rungs, static_cast<int*>(rung_out));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// g [Ns] int32, is_real [Ns] bool, shift [Ns, 3], w_lo and w_nact
// [Ns / group, 9] int32 (the window build's, unmasked); pos [n, 3], h and
// mass [n], rung and r_des [n] int32; m_out [n] int32 (written on closers),
// target [n] int32 (the rungs; lowered in place where a wake-up lands),
// limited [1] int32 (added to).
#define SPHAX_RUNG_TICK_ENTRY(NAME, T)                                       \
  cudaError_t NAME(const void* g, const void* is_real, const void* shift,   \
                   const void* w_lo, const void* w_nact, int Ns, int group,  \
                   int n, const void* pos, const void* h, const void* mass,  \
                   const void* rung, const void* r_des, int k, int a,        \
                   int align, int n_rungs, void* m_out, void* target,        \
                   void* limited, void* stream) {                            \
    return launch_tick<T>(g, is_real, shift, w_lo, w_nact, Ns, group, n,     \
                          pos, h, mass, rung, r_des, k, a, align, n_rungs,   \
                          m_out, target, limited, stream);                   \
  }
SPHAX_RUNG_TICK_ENTRY(sphax_rung_limit_tick_f32, float)
SPHAX_RUNG_TICK_ENTRY(sphax_rung_limit_tick_f64, double)
#undef SPHAX_RUNG_TICK_ENTRY

// the same inputs; rung_out [n] int32, every real row written
#define SPHAX_RUNG_SYNC_ENTRY(NAME, T)                                       \
  cudaError_t NAME(const void* g, const void* is_real, const void* shift,   \
                   const void* w_lo, const void* w_nact, int Ns, int group,  \
                   int n, const void* pos, const void* h, const void* mass,  \
                   const void* rung, int a, int n_rungs, void* rung_out,     \
                   void* stream) {                                           \
    return launch_sync<T>(g, is_real, shift, w_lo, w_nact, Ns, group, n,     \
                          pos, h, mass, rung, a, n_rungs, rung_out, stream); \
  }
SPHAX_RUNG_SYNC_ENTRY(sphax_rung_limit_sync_f32, float)
SPHAX_RUNG_SYNC_ENTRY(sphax_rung_limit_sync_f64, double)
#undef SPHAX_RUNG_SYNC_ENTRY

}  // extern "C"

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
// mode, :195-236): the same body over another candidate table.
//
// Contract (sphax_torch/physics/window_kernels.py): one thread owns one
// sorted row i; a block covers one tile of `tile` rows, i.e. tile/group
// row-groups of `group` >= 32 rows, so a warp never straddles two groups
// and its 32 rows share one candidate set. Group g's candidates are, per
// segment s < NSEG, the rows k in [w_lo[g,s], w_lo[g,s] + 128 w_nact[g,s]);
// a row already inside an earlier segment's range is skipped
// (first-occurrence dedup). The non-empty ranges of a group start in rising
// order, w_lo[g,s] >= w_lo[g,s'] for s' < s, as the window build makes them
// (its cell table is monotone and its pencil offsets rise) and masking
// keeps them (it only empties ranges). In the compact walk they are the
// disjoint runs
// [c_lo[g,s], c_lo[g,s] + c_len[g,s]) in segment order, cut at cwidth rows
// in all, unaligned, with no dedup. Candidate fields are SoA [F, Ns]. A
// group whose table row is all zero writes h = h0 and zeros for every
// other output.
//
// What bounds it: instruction throughput (the warp schedulers' slots), not
// bytes or arithmetic (each input read once over 3.35 TB/s, or the
// operations of the pairs inside the support over 67 TFLOP/s, come to a
// fifteenth to a twenty-fifth of the kernels' times). A group's windows
// hold 2,224 candidate rows per row at N = 1e6 in the bench configuration
// (1,075 compact, 4,299 on the Sedov path, 753 in 2D, 256 in 1D) against
// 74 (3D), 21 (2D) and 5 (1D) inside the support 2h. A walk in which every
// thread visits every candidate spends its time on rejections: four
// warp-uniform loads, up to eight dedup compares, r^2 and a reciprocal
// square root, 32 lanes wide, for a row that 97 % of the time then fails
// the support test. The cull below keeps 437 rows per row at the
// turb256 shapes (102 in 2D at kh1024, 37 in 1D). A walk in which every
// lane then visits every survivor runs the pair arithmetic for the whole
// warp whenever one of its 32 rows takes the survivor: 356 times a warp a
// walk at turb256 for 81 pairs a row, 0.23 of the lanes busy
// (`window_kernels.walk_stats`). Both kernels walk pairs instead (step 3):
// kernel A runs the arithmetic 124 times in a Newton walk and 158 in the
// final one (fill 0.65 and 0.51), kernel C 157 times (fill 0.51, at C's
// rule r < 2 max(h_i, h_j)). What binds A now is the test of every (row,
// survivor) pair and the cull, whose global loads wait unless 32 warps a
// SM hide them (kernel A 51.0 -> 43.0 ms at turb256, 16.4 -> 13.5 at
// sedov128, 2.49 -> 1.67 at kh1024, 0.253 -> 0.180 on the 1D line of 2^20,
// in turns on one H100 at 700 W; culled alone, without a walk, A took
// 15.6 ms at turb256). What binds C now is the same test and cull, and its
// pairs' reads of j's further fields, which go through L1: a batch that
// leaves a SM less L1 is slower (below). Kernel C 48.0 -> 35.8 ms at
// turb256, 6.84 -> 5.06 at sedov128, 1.11 -> 0.62 at kh1024, 0.35 -> 0.28
// on the 1D line, the GRAV mode unchanged (6.79 at the P3M shapes; all in
// turns on one H100 at 700 W, `ab_kernels`).
//
// What the design does about it: each warp culls its candidates
// cooperatively, then walks only the survivors.
//   1. Cull. The warp takes the axis-aligned box of its 32 rows' positions
//      and the largest of their h, over the lanes that carry mass (pad rows
//      sit at 0 with h = 1 and unused ghost slots anywhere; they must not
//      widen the box). The lanes then read 32 different candidates a step,
//      one coalesced load a field, and each tests its candidate's distance
//      to the box against the reach: 2 h_max in kernel A, 2 max(h_max, h_j)
//      in kernel C, at least the cutoff in C's GRAV mode; 1e-3 wider, so
//      that rounding never drops a live pair. A candidate without mass
//      adds exact zeros and is dropped too. The first-occurrence dedup
//      happens here, once a candidate: the ranges rise with the segment
//      (the contract above), so it is a clip of each segment's start at
//      the earlier segments' largest end.
//   2. Stage. Survivors go to the warp's own buffer in shared memory, in
//      candidate order (__ballot_sync and a prefix __popc): one 16-byte
//      entry (32 in fp64) with what the exact test needs, (x, y, z, m) for
//      A and (x, y, z, 1/h_j) for C, and beside it what else the walk
//      reads of it: the velocity for A's Balsara sums (staged for the last
//      walk only) as a further 16-byte vector; the row index for C's pair
//      walk; velocity, m, h, rho, cs, ci, gc1, gc2 and bf for C's GRAV
//      walk (three vectors). A lane stages its own kept candidate, so
//      these loads are coalesced too. The buffers hold A's PairCap (320
//      in fp32, 192 in the final walk), C's ForceCap (192: 4.5 KB a warp)
//      and GravCap (96: 6 KB a warp) survivors; when another step might
//      not fit, the warp walks what it has and goes on culling, so no
//      input can overflow it and nothing is dropped.
//   3. Walk (the pair walk, `test_and_walk`: kernel A, and kernel C
//      outside GRAV). Each lane first tests its own row against every
//      staged survivor, one broadcast load each, and keeps a bit a
//      survivor (C's test: r^2 / h_i^2 or r^2 / h_j^2 against the margin);
//      then each lane walks only the survivors its row took, PAIR_STEP
//      (A) or FORCE_STEP (C) a step, so the pair arithmetic runs where a
//      row has a pair and not where any of 32 has one. Its pair is
//      straight-line code: a pair outside the support adds exact zeros.
//      No sum crosses lanes, and the candidate order is kept, so each
//      row's sums are taken in the order they were, bit for bit the walk
//      of every lane over every survivor (drdh's 3 w + q dw/dq is the
//      fused multiply-add that walk compiled to). C's pair reads j's
//      further fields from the window by row index: staged beside the
//      entry, a lane's own slot costs four 16-byte shared loads a pair
//      that conflict in their banks. In turns at turb256, against the
//      walk of every lane over every survivor (48.0 ms): three vectors
//      staged, 96 survivors at 32 warps a SM 37.4 ms, 128 at 24 warps
//      38.0, 192 at 16 warps 44.5; row index staged, 160 survivors 36.6,
//      192 35.6, 224 34.4, 256 37.3 (and at the bench shapes with
//      fast_math 1.65 at 192, 1.92 at 224, 2.28 at 256 against 1.69:
//      each step of batch leaves less of the SM's memory to L1); two
//      pairs a step spill at 64 registers (42.1 ms); without the cap of
//      64 registers C takes 65 and 28 warps a SM fit (37.6 ms at 192).
//   3. Walk, kernel C's GRAV mode (`every_lane_walk`). Every lane reads
//      each entry as one broadcast 16-byte shared load and tests r^2
//      against its support and the cutoff before any reciprocal square
//      root; a passing pair reads its further vectors the same way. There
//      nearly every survivor lies within the cutoff of every row, so the
//      pair walk's test and its lanes' own loads buy nothing: with it C
//      took 10.0 ms at the P3M shapes (9.5 with the vectors staged)
//      against 6.77, and the GRAV instantiations keep this walk.
//   4. Kernel A culls afresh before each of its Newton walks with the
//      warp's current h_max: h moves by up to half an update, and a list
//      made for one h is no superset for the next.
// Only warp-level synchronisation is used (two row-groups of a tile have
// different candidates, and either may be masked). Of Hopper this uses
// shared memory as the staging buffer, ballots and shuffles, and 16-byte
// shared loads. It does not use wgmma: r^2 as |x_i|^2 + |x_j|^2 - 2 x_i.x_j
// cancels catastrophically in fp32 at neighbour distances of 1e-2 of the
// box, and what follows the cull is not a matrix product. It does not use
// TMA: the cull's loads are 32-row strips, coalesced already.
//
// Kernel C's GRAV mode adds the screened P3M short range
// G m_j S(r) (r^2 + eps^2)^-3/2 dx for every candidate with 0 < r^2 <=
// cutoff^2, ahead of the SPH support exit: the screened force reaches to
// 4.5 r_s <= cutoff, well past 2h, so its cull keeps every candidate within
// the cutoff of the box. It uses the native erfc (the TPU needed a
// polynomial) and one exp shared with the derivative term, and it always
// divides exactly. The three split scalars (0.5/rs, 1/(rs sqrt(pi)),
// eps^2) come from a device pointer, because rs is a device tensor; G and
// cutoff^2 are static.
//
// Every launcher returns the first CUDA error of its launch.

#include <cuda_runtime.h>

#include <type_traits>
#include <utility>

namespace {

constexpr int BLK = 128;  // rows per w_nact block
constexpr unsigned FULL = 0xffffffffu;

// 3^(dim-1) pencil segments per row-group
__host__ __device__ constexpr int nseg(int dim) {
  return dim <= 1 ? 1 : 3 * nseg(dim - 1);
}

template <typename T> struct Num;

template <> struct Num<float> {
  static constexpr float tiny = 1e-30f;
  static constexpr float big = 1e18f;  // big^2 * 3 is finite
  static __device__ __forceinline__ float rsqrt(float x) { return rsqrtf(x); }
  static __device__ __forceinline__ float sqrt(float x) { return sqrtf(x); }
  static __device__ __forceinline__ float exp(float x) { return expf(x); }
  static __device__ __forceinline__ float erfc(float x) { return erfcf(x); }
  static __device__ __forceinline__ float fma(float a, float b, float c) {
    return fmaf(a, b, c);
  }
  template <bool FAST>
  static __device__ __forceinline__ float div(float a, float b) {
    return FAST ? __fdividef(a, b) : a / b;
  }
};

template <> struct Num<double> {
  static constexpr double tiny = 1e-300;
  static constexpr double big = 1e150;
  static __device__ __forceinline__ double rsqrt(double x) { return ::rsqrt(x); }
  static __device__ __forceinline__ double sqrt(double x) { return ::sqrt(x); }
  static __device__ __forceinline__ double exp(double x) { return ::exp(x); }
  static __device__ __forceinline__ double erfc(double x) { return ::erfc(x); }
  static __device__ __forceinline__ double fma(double a, double b, double c) {
    return ::fma(a, b, c);
  }
  template <bool FAST>
  static __device__ __forceinline__ double div(double a, double b) {
    return a / b;
  }
};

// The relative margins of the cull and of the walk's first test. A pair is
// live when r < 2 h; the cull keeps a candidate within 2.002 h_max of the
// warp's box, and the walk leaves a pair before its rsqrt only when
// r^2 / h^2 >= 4.0001, so the exact test q < 2 that follows decides every
// pair it decided before.
template <typename T>
struct Margin {
  static constexpr T reach = T(2.002);        // 2 * 1.001
  static constexpr T reach2 = T(4.008004);    // (2 * 1.001)^2
  static constexpr T rcut2 = T(1.002001);     // 1.001^2
  static constexpr T support2 = T(4.0001);
};

// The per-axis work is straight-line code, never a loop: a loop in a
// walk's body, even one of constant trip count, changes how nvcc unrolls
// the walk around it.
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

// ---------------------------------------------------------------------------
// the warp's candidate ranges, its box, and the cull into shared memory
// ---------------------------------------------------------------------------

// Lane s < NSEG holds segment s's rows [lo, hi); the other lanes hold an
// empty range. `count` says whether the group has any candidate.
struct Ranges {
  int lo, hi, count;
};

// Reads the group's table row (every lane reads all of it: warp-uniform
// loads). In place the ranges are [w_lo, w_lo + 128 w_nact) and overlap;
// each non-empty range starts at or after the ones before it (the
// contract), so a row of segment s was seen before exactly when it lies
// below the largest end of the earlier segments, and the dedup is a clip of
// the start. Compact, they are the runs [c_lo, c_lo + c_len) cut at cwidth
// rows in all, disjoint already.
template <bool COMPACT, int NSEG>
__device__ __forceinline__ Ranges load_ranges(const int* __restrict__ tab_lo,
                                              const int* __restrict__ tab_n,
                                              int g, int cwidth, int lane) {
  Ranges r{0, 0, 0};
  int clip = 0, max_hi = 0;
#pragma unroll
  for (int s = 0; s < NSEG; ++s) {
    const int lo = tab_lo[g * NSEG + s];
    const int n = tab_n[g * NSEG + s];
    const int len = COMPACT ? min(n, cwidth - r.count) : BLK * n;
    r.count += len;
    if (lane == s) {
      r.lo = lo;
      r.hi = lo + len;
      clip = max_hi;
    }
    if (!COMPACT && len > 0) max_hi = max(max_hi, lo + len);
  }
  if (!COMPACT) r.lo = max(r.lo, clip);
  return r;
}

// The axis-aligned box of the warp's rows that carry mass (empty, and then
// far from everything, when none does).
template <typename T, int DIM>
struct Box {
  T lo[DIM], hi[DIM];

  static __device__ __forceinline__ Box of(const T (&x)[DIM], bool has_mass) {
    Box b;
    each_axis(Axes<DIM>{}, [&](int d) {
      b.lo[d] = warp_min(has_mass ? x[d] : Num<T>::big);
      b.hi[d] = warp_max(has_mass ? x[d] : -Num<T>::big);
    });
    return b;
  }

  // squared distance from p to the box, 0 inside; never more than the
  // squared distance from p to a row of the warp, in floating point too
  // (rounding is monotone)
  __device__ __forceinline__ T gap2(const T (&p)[3]) const {
    T g2 = T(0);
    each_axis(Axes<DIM>{}, [&](int d) {
      const T below = lo[d] - p[d], above = p[d] - hi[d];
      T g = below > above ? below : above;
      g = g > T(0) ? g : T(0);
      g2 += g * g;
    });
    return g2;
  }
};

// Four values moved as 16-byte accesses (two in fp64).
template <typename T>
struct alignas(16) Vec4 {
  T a, b, c, d;
};

__device__ __forceinline__ Vec4<float> load_vec(const Vec4<float>* p) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  return {v.x, v.y, v.z, v.w};
}

__device__ __forceinline__ Vec4<double> load_vec(const Vec4<double>* p) {
  const double2 lo = reinterpret_cast<const double2*>(p)[0];
  const double2 hi = reinterpret_cast<const double2*>(p)[1];
  return {lo.x, lo.y, hi.x, hi.y};
}

__device__ __forceinline__ void store_vec(Vec4<float>* p,
                                          const Vec4<float>& v) {
  *reinterpret_cast<float4*>(p) = make_float4(v.a, v.b, v.c, v.d);
}

__device__ __forceinline__ void store_vec(Vec4<double>* p,
                                          const Vec4<double>& v) {
  reinterpret_cast<double2*>(p)[0] = make_double2(v.a, v.b);
  reinterpret_cast<double2*>(p)[1] = make_double2(v.c, v.d);
}

// What the walk's first test needs of a candidate: its position (DIM of
// the three axes) and one more field.
template <typename T>
struct Entry {
  T p[3];
  T w;
};

// The warp's slice of the block's dynamic shared memory, `bytes` a warp:
// its staged entries, then their further vectors, then the mask words of
// its pair walk.
template <typename T>
__device__ __forceinline__ Vec4<T>* warp_stage(size_t bytes) {
  extern __shared__ __align__(16) unsigned char stage_raw[];
  return reinterpret_cast<Vec4<T>*>(stage_raw + (threadIdx.x >> 5) * bytes);
}

inline size_t stage_bytes(int tile, size_t bytes) {
  return size_t(tile / 32) * bytes;
}

// Survivors a warp of kernel A's pair walk stages before a walk. A lane
// walks only its own row's pairs and a batch takes as many steps as the
// most pairs any of its 32 rows takes, so the larger the batch, the closer
// each row comes to that most (`window_kernels.walk_stats`: at the
// turb256 shapes, 437 survivors a row, batches of 320 fill 0.65 of the
// lanes and 192 0.51; on a 24^3 lattice at the same knobs 128 fill 0.43
// and 512 0.96). A survivor takes its entry and one bit a
// row (4 bytes a slot of `mask`), in the final walk with the Balsara sums
// its velocity too: 320 in fp32, 192 with the velocities (6,912 bytes a
// warp), 160 and 96 in fp64. That leaves a SM room for 32 warps, as do the
// 64 registers a thread that A's fp32 kernels are held to (`__maxnreg__`
// on them; 128 in fp64, which no bench path runs): the cull before each
// walk waits on global loads, and at 20 warps a SM, with 512 and 256,
// kernel A took 49.5 ms at turb256 against 43.4 at 32.
template <typename T>
struct PairCap {
  static constexpr int plain = 1280 / int(sizeof(T));
  static constexpr int with_rest = 768 / int(sizeof(T));
  static constexpr size_t bytes = (plain * (sizeof(Vec4<T>) + 4) >
                                   with_rest * (2 * sizeof(Vec4<T>) + 4))
                                      ? plain * (sizeof(Vec4<T>) + 4)
                                      : with_rest * (2 * sizeof(Vec4<T>) + 4);
};

// Survivors a warp of kernel C's pair walk stages before a walk, and the
// pairs a lane walks a step. A survivor takes its entry, its row index and
// one bit a row (4 bytes a slot of `mask`): 24 bytes in fp32, 192
// survivors (4,608 bytes a warp); 128 in fp64, which no bench path runs.
// At 32 warps a SM (C's pair-walk kernels are held to 64 registers, as
// A's) that leaves the SM's unified memory about 92 KB of L1 for the
// pairs' reads of j's fields by row index, against about 28 KB at 256
// survivors; the head note gives the batches measured.
template <typename T>
struct ForceCap {
  static constexpr int n = sizeof(T) == 4 ? 192 : 128;
  static constexpr size_t bytes = n * (sizeof(Vec4<T>) + 8);
};
constexpr int FORCE_STEP = 1;

// Survivors a warp of kernel C's GRAV mode stages before its walk, in which
// every lane visits every survivor: the entry and the three vectors of its
// further fields, 96 in fp32 and 48 in fp64 (6 KB a warp).
template <typename T>
struct GravCap {
  static constexpr int n = 384 / int(sizeof(T));
  static constexpr size_t bytes = n * 4 * sizeof(Vec4<T>);
};

// Kernel C's staging: its GRAV walk's or its pair walk's.
template <typename T, bool GRAV>
using ForceStage = std::conditional_t<GRAV, GravCap<T>, ForceCap<T>>;

// One walk of a warp over its candidates. `entry(k, e)` reads candidate
// row k's entry, `near(e, k)` says whether the warp keeps it, `stage(k,
// slot)` stages what else the walk reads of a kept candidate, and
// `walk(n)` walks the n entries staged at `ent`. The lanes cull 32
// candidates a step and append the survivors in candidate order; whenever
// another step might not fit in `cap` entries, the warp walks what it
// staged and goes on. All control flow here is warp-uniform; `walk` may
// diverge inside.
template <typename T, int NSEG, typename Read, typename Near, typename Stage,
          typename Walk>
__device__ __forceinline__ void cull_and_stage(const Ranges& rg, int lane,
                                               Vec4<T>* ent, int cap,
                                               Read&& entry, Near&& near,
                                               Stage&& stage, Walk&& walk) {
  int s = 0;
  int k0 = __shfl_sync(FULL, rg.lo, 0);
  int kend = __shfl_sync(FULL, rg.hi, 0);
  for (;;) {
    int n = 0;
    while (s < NSEG && n <= cap - 32) {
      if (k0 >= kend) {  // next segment (lane NSEG's range is empty)
        ++s;
        k0 = __shfl_sync(FULL, rg.lo, s);
        kend = __shfl_sync(FULL, rg.hi, s);
        continue;
      }
      const int k = k0 + lane;
      bool keep = k < kend;
      Entry<T> e{};
      if (keep) {
        entry(k, e);
        keep = near(e, k);
      }
      const unsigned kept = __ballot_sync(FULL, keep);
      if (keep) {
        const int slot = n + __popc(kept & ((1u << lane) - 1u));
        store_vec(ent + slot, Vec4<T>{e.p[0], e.p[1], e.p[2], e.w});
        stage(k, slot);
      }
      n += __popc(kept);
      k0 += 32;
    }
    if (n == 0) break;
    __syncwarp();
    walk(n);
    __syncwarp();
  }
}

// The pairs a lane of kernel A's pair walk takes a step.
constexpr int PAIR_STEP = 2;

// The pair walk of kernels A and C over a staged batch of n survivors at
// `ent`.
// 1. Test: each lane applies its own row's first test, `takes(c)`, to
//    every staged survivor, one broadcast 16-byte load each, and keeps one
//    bit a survivor in its own words of `mask` (mask[32 w + lane], bit b
//    for slot 32 w + b). Sentinel entries, far from every row and with
//    the largest 1/h_j, pad the last word, so the test runs 32 slots at a
//    time with no bounds and no row takes them. A lane whose row carries
//    no mass takes nothing.
// 2. Walk: each lane walks the set bits of its own words in slot order,
//    STEP a step, so every step gives every lane that still has pairs
//    that many that passed the test: `pair(e, slot, live)` on each, with
//    `live` false (and slot 0's entry) where the lane has no pair left.
//    The steps of a batch are the most pairs any of its rows takes, over
//    STEP, rounded up.
// A lane sums its own row's pairs in candidate order, as the walk in which
// every lane visits every survivor does: no reduction across lanes.
template <int STEP, typename T, typename Takes, typename Pair>
__device__ __forceinline__ void test_and_walk(int n, int lane, Vec4<T>* ent,
                                              unsigned* mask, bool mine,
                                              Takes&& takes, Pair&& pair) {
  const int words = (n + 31) >> 5;
  if (n + lane < 32 * words)
    store_vec(ent + n + lane, Vec4<T>{Num<T>::big, Num<T>::big,
                                      Num<T>::big, Num<T>::big});
  __syncwarp();
  for (int w = 0; w < words; ++w) {
    unsigned bits = 0;
#pragma unroll
    for (int b = 0; b < 32; ++b) {
      const Vec4<T> v = load_vec(ent + 32 * w + b);
      if (takes(Entry<T>{{v.a, v.b, v.c}, v.d})) bits |= 1u << b;
    }
    mask[32 * w + lane] = mine ? bits : 0u;
  }
  int w = 0;
  unsigned bits = mask[lane];
  // the lane's next slot, -1 past its last
  auto next = [&]() {
    while (bits == 0 && ++w < words) bits = mask[32 * w + lane];
    int slot = -1;
    if (bits != 0) {
      slot = 32 * w + __ffs(bits) - 1;
      bits &= bits - 1;
    }
    return slot;
  };
  for (;;) {
    int slot[STEP];
    slot[0] = next();
    if (!__any_sync(FULL, slot[0] >= 0)) break;
    each_axis(Axes<STEP - 1>{}, [&](int j) { slot[j + 1] = next(); });
    Vec4<T> v[STEP];
    each_axis(Axes<STEP>{}, [&](int j) {
      v[j] = load_vec(ent + (slot[j] < 0 ? 0 : slot[j]));
    });
    each_axis(Axes<STEP>{}, [&](int j) {
      pair(Entry<T>{{v[j].a, v[j].b, v[j].c}, v[j].d},
           slot[j] < 0 ? 0 : slot[j], slot[j] >= 0);
    });
  }
}

// The walk in which every lane visits every staged survivor, in slot
// order: `pair(e, slot)` is one lane's work on one survivor.
template <typename T, typename Pair>
__device__ __forceinline__ void every_lane_walk(int n, const Vec4<T>* ent,
                                                Pair&& pair) {
  for (int slot = 0; slot < n; ++slot) {
    const Vec4<T> v = load_vec(ent + slot);
    pair(Entry<T>{{v.a, v.b, v.c}, v.d}, slot);
  }
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

// One sorted row of kernel A. SoA rows of the density window: DIM
// positions, m (, DIM velocities). The tables are (w_lo, w_nact) in the
// in-place walk and (c_lo, c_len) in the compact one; cwidth is read only
// by the compact walk. `iters` Newton walks, then the walk that writes the
// sums, with the Balsara sums when BALS; each culls at the warp's current
// h_max.
template <typename T, int DIM, bool BALS, bool COMPACT>
__device__ __forceinline__ void solve_h_density_row(
    const T* __restrict__ win, const T* __restrict__ h0,
    const int* __restrict__ tab_lo, const int* __restrict__ tab_n, int Ns,
    int group, int cwidth, T sig, T eta_d, T hcap, int iters,
    T* __restrict__ h_out, T* __restrict__ rho_out,
    T* __restrict__ drdh_out, T* __restrict__ div_out,
    T* __restrict__ curl_out) {
  constexpr int NSEG = nseg(DIM);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= Ns) return;  // Ns is a multiple of the tile: whole warps only
  const int lane = threadIdx.x & 31;
  const Ranges rg =
      load_ranges<COMPACT, NSEG>(tab_lo, tab_n, i / group, cwidth, lane);
  T h = h0[i];
  if (rg.count == 0) {
    h_out[i] = h;
    rho_out[i] = T(0);
    drdh_out[i] = T(0);
    if (BALS) {
      div_out[i] = T(0);
      curl_out[i] = T(0);
    }
    return;
  }
  const T* X[DIM];
  const T* V[DIM];  // read only when BALS
  each_axis(Axes<DIM>{}, [&](int d) {
    X[d] = win + d * (size_t)Ns;
    V[d] = BALS ? win + (DIM + 1 + d) * (size_t)Ns : win;
  });
  const T* M = win + DIM * (size_t)Ns;
  T xi[DIM], vi[DIM];
  each_axis(Axes<DIM>{}, [&](int d) {
    xi[d] = X[d][i];
    vi[d] = BALS ? V[d][i] : T(0);
  });
  const T mi = M[i];
  const T m_safe = mi > T(1e-30) ? mi : T(1e-30);
  const bool has_mass = mi > T(0);
  const Box<T, DIM> box = Box<T, DIM>::of(xi, has_mass);
  Vec4<T>* const ent = warp_stage<T>(PairCap<T>::bytes);
  auto velocity = [&](int k) {
    T v[3] = {T(0), T(0), T(0)};
    each_axis(Axes<DIM>{}, [&](int d) { v[d] = V[d][k]; });
    return Vec4<T>{v[0], v[1], v[2], T(0)};
  };
  for (int it = 0; it <= iters; ++it) {
    // the final walk stages the velocities beside the entries, so its
    // batches hold fewer survivors
    const bool with_rest = BALS && it == iters;
    const int cap = with_rest ? PairCap<T>::with_rest : PairCap<T>::plain;
    Vec4<T>* const rest = ent + cap;
    unsigned* const mask =
        reinterpret_cast<unsigned*>(rest + (with_rest ? cap : 0));
    const T invh = T(1) / h;
    const T invh2 = invh * invh;
    T sigd = sig;  // sig / h^DIM
    each_axis(Axes<DIM>{}, [&](int) { sigd *= invh; });
    DensSums<T, DIM> acc{};
    auto entry = [&](int k, Entry<T>& e) {
      each_axis(Axes<DIM>{}, [&](int d) { e.p[d] = X[d][k]; });
      e.w = M[k];
    };
    const T reach = Margin<T>::reach * warp_max(has_mass ? h : T(0));
    const T reach2 = reach * reach;
    auto near = [&](const Entry<T>& e, int) {
      return e.w > T(0) && box.gap2(e.p) < reach2;
    };
    // the walk's first test: r^2 / h^2 against the support's margin
    auto takes = [&](const Entry<T>& c) {
      T dx[DIM];
      each_axis(Axes<DIM>{}, [&](int d) { dx[d] = xi[d] - c.p[d]; });
      return dot(dx, dx) * invh2 < Margin<T>::support2;
    };
    // One pair, in straight-line code, so that a lane's pairs of a step
    // interleave. A pair that is not live (the lane has none left, or
    // q >= 2: outside the support) takes m = 0 and adds exact zeros, which
    // leaves the sums as they were. `rest_c`: the final walk's Balsara
    // sums.
    auto pair = [&](const Entry<T>& c, int slot, bool live, auto rest_c) {
      T dx[DIM];
      each_axis(Axes<DIM>{}, [&](int d) { dx[d] = xi[d] - c.p[d]; });
      const T r2 = dot(dx, dx);
      const T invr = Num<T>::rsqrt(r2 + Num<T>::tiny);
      const T q = r2 * invr * invh;
      const T m = live && q < T(2) ? c.w : T(0);
      const T t = T(2) - q;
      const bool inner = q < T(1);
      const T f = inner ? T(1) + q * q * (T(0.75) * q - T(1.5))
                        : T(0.25) * t * t * t;
      const T df = inner ? q * (T(2.25) * q - T(3)) : T(-0.75) * t * t;
      const T w = sigd * f;
      const T dwdq = sigd * df;
      acc.rho += m * w;
      acc.drdh += m * (-Num<T>::fma(T(DIM), w, q * dwdq) * invh);
      if constexpr (decltype(rest_c)::value) {
        const Vec4<T> vj = load_vec(rest + slot);
        const T vjd[3] = {vj.a, vj.b, vj.c};
        const T mw = m * (dwdq * invh * invr);
        T dv[DIM];
        each_axis(Axes<DIM>{}, [&](int d) { dv[d] = vi[d] - vjd[d]; });
        acc.div += mw * dot(dv, dx);
        if constexpr (DIM == 3) {
          acc.curl[0] += mw * (dv[1] * dx[2] - dv[2] * dx[1]);
          acc.curl[1] += mw * (dv[2] * dx[0] - dv[0] * dx[2]);
          acc.curl[2] += mw * (dv[0] * dx[1] - dv[1] * dx[0]);
        } else if constexpr (DIM == 2) {
          acc.curl[0] += mw * (dv[0] * dx[1] - dv[1] * dx[0]);
        }
      }
    };
    auto walk = [&](auto rest_c) {
      cull_and_stage<T, NSEG>(
          rg, lane, ent, cap, entry, near,
          [&](int k, int slot) {
            if constexpr (decltype(rest_c)::value)
              store_vec(rest + slot, velocity(k));
          },
          [&](int n) {
            test_and_walk<PAIR_STEP, T>(
                n, lane, ent, mask, has_mass, takes,
                [&](const Entry<T>& c, int slot, bool live) {
                  pair(c, slot, live, rest_c);
                });
          });
    };
    if (with_rest)
      walk(std::bool_constant<BALS>{});
    else
      walk(std::false_type{});
    if (it < iters) {
      h = newton_update<T, DIM>(h, acc.rho, acc.drdh, m_safe, eta_d, hcap);
      continue;
    }
    h_out[i] = h;
    rho_out[i] = acc.rho;
    drdh_out[i] = acc.drdh;
    if (BALS) {
      div_out[i] = acc.div;
      if constexpr (DIM == 3)
        curl_out[i] = Num<T>::sqrt(acc.curl[0] * acc.curl[0] +
                                   acc.curl[1] * acc.curl[1] +
                                   acc.curl[2] * acc.curl[2]);
      else
        curl_out[i] = fabs(acc.curl[0]);
    }
  }
}

// Kernel A's kernels, named for the pair walk so that a trace tells it
// from the walk in which every lane visits every survivor.
template <typename T, int DIM, bool BALS>
__global__ void __maxnreg__(sizeof(T) == 4 ? 64 : 128)
solve_h_density_pairs_kernel(
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
__global__ void __maxnreg__(sizeof(T) == 4 ? 64 : 128)
solve_h_density_pairs_compact_kernel(
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

// The FRow row behind value i of a candidate's staged further fields: DIM
// velocities, then m h rho cs ci gc1 gc2 bf (1/h is in its entry); -1 past
// them.
template <int DIM>
__host__ __device__ constexpr int rest_field(int i) {
  using R = FRow<DIM>;
  if (i < DIM) return R::V + i;
  const int j = i - DIM;
  return j == 0 ? R::M : j == 1 ? R::H : j < 8 ? R::RHO + (j - 2) : -1;
}

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

// One sorted row of kernel C; the tables as in solve_h_density_row. A pair
// counts when r < 2 h_i or r < 2 h_j (or, GRAV, 0 < r <= cutoff), so the
// cull keeps candidate j within 2 max(h_max, h_j) of the warp's box (at
// least the cutoff, GRAV), and stages 1/h_j for the pair walk's first test.
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
  if (i >= Ns) return;  // Ns is a multiple of the tile: whole warps only
  const int lane = threadIdx.x & 31;
  const Ranges rg =
      load_ranges<COMPACT, NSEG>(tab_lo, tab_n, i / group, cwidth, lane);
  ForceSums<T, DIM> acc{};
  if (rg.count > 0) {
    auto F = [&](int f, int k) { return win[(size_t)f * Ns + k]; };
    Own<T, DIM> o;
    each_axis(Axes<DIM>{}, [&](int d) { o.x[d] = F(R::X + d, i); });
    each_axis(Axes<DIM>{}, [&](int d) { o.v[d] = F(R::V + d, i); });
    o.h = F(R::H, i);
    o.invh = F(R::INVH, i);
    o.rho = F(R::RHO, i);
    o.cs = F(R::CS, i);
    o.ci = F(R::CI, i);
    o.gc1 = F(R::GC1, i);
    o.gc2 = F(R::GC2, i);
    o.bf = BF ? F(R::BF, i) : T(0);
    Grav<T> g{T(0), T(0), T(0), G, rcut2};
    if (GRAV) {
      g.x_scale = gsc[0];
      g.sp = gsc[1];
      g.eps2 = gsc[2];
    }
    const T invh2 = o.invh * o.invh;
    constexpr int NV = 3;  // DIM + 8 <= 12 further fields of a candidate
    constexpr int cap = ForceStage<T, GRAV>::n;
    Vec4<T>* const ent = warp_stage<T>(ForceStage<T, GRAV>::bytes);
    // the pair walk stages each survivor's row index, and its lanes' mask
    // words; the GRAV walk its further fields
    int* const row = reinterpret_cast<int*>(ent + cap);
    unsigned* const mask = reinterpret_cast<unsigned*>(row + cap);
    Vec4<T>* const rest = ent + cap;
    // vector v of candidate row k's further fields, from the SoA rows
    auto gather = [&](int k, int v) {
      T t[4];
      each_axis(Axes<4>{}, [&](int c) {
        const int f = rest_field<DIM>(4 * v + c);
        t[c] = f >= 0 && (BF || f != R::BF) ? F(f, k) : T(0);
      });
      return Vec4<T>{t[0], t[1], t[2], t[3]};
    };
    auto entry = [&](int k, Entry<T>& e) {
      each_axis(Axes<DIM>{}, [&](int d) { e.p[d] = F(R::X + d, k); });
      e.w = F(R::INVH, k);
    };
    // the walk's first test: r^2 / h_i^2 or r^2 / h_j^2 against the
    // support's margin, or (GRAV) r^2 inside the cutoff
    auto takes = [&](const Entry<T>& c) {
      T dx[DIM];
      each_axis(Axes<DIM>{}, [&](int d) { dx[d] = o.x[d] - c.p[d]; });
      const T r2 = dot(dx, dx);
      bool in = r2 * invh2 < Margin<T>::support2 ||
                r2 * c.w * c.w < Margin<T>::support2;
      if (GRAV) in = in || r2 <= g.rcut2;
      return in;
    };
    // The SPH terms of one pair (with GRAV, plus its gravity gco), j's
    // further fields in `jv`; `on` false takes m_j = 0 and adds exact
    // zeros, which leaves the sums as they were.
    auto terms = [&](const T (&dx)[DIM], T r2, T invr, T qi, T qj, T gco,
                     const Vec4<T> (&jv)[NV], bool on) {
      const T j[12] = {jv[0].a, jv[0].b, jv[0].c, jv[0].d, jv[1].a, jv[1].b,
                       jv[1].c, jv[1].d, jv[2].a, jv[2].b, jv[2].c, jv[2].d};
      const T mj = on ? j[DIM] : T(0), hj = j[DIM + 1], rhoj = j[DIM + 2],
              csj = j[DIM + 3], cij = j[DIM + 4], gc1j = j[DIM + 5],
              gc2j = j[DIM + 6], bfj = j[DIM + 7];
      const T ti = T(2) - qi, tj = T(2) - qj;
      T gi = qi < T(1) ? o.gc2 * (T(2.25) * qi - T(3))
                       : T(-0.75) * o.gc1 * (ti * ti) * invr;
      gi = qi < T(2) ? gi : T(0);
      T gj = qj < T(1) ? gc2j * (T(2.25) * qj - T(3))
                       : T(-0.75) * gc1j * (tj * tj) * invr;
      gj = qj < T(2) ? gj : T(0);
      const T gbar = T(0.5) * (gi + gj);

      T dv[DIM];
      each_axis(Axes<DIM>{}, [&](int d) { dv[d] = o.v[d] - j[d]; });
      const T vdotr = dot(dv, dx);
      const T hbar = T(0.5) * (o.h + hj);
      const T mu_den = r2 + epsv * hbar * hbar;
      T mu = Num<T>::template div<FAST>(hbar * vdotr, mu_den);
      mu = vdotr < T(0) ? mu : T(0);
      const T cbar = T(0.5) * (o.cs + csj);
      const T rhobar = T(0.5) * (o.rho + rhoj);
      T Pi = Num<T>::template div<FAST>((beta * mu - alpha * cbar) * mu,
                                        rhobar);
      if (BF) Pi = Pi * (T(0.5) * (o.bf + bfj));

      const T cigi = o.ci * gi;
      const T pigb = Pi * gbar;
      T fsum = cigi + cij * gj + pigb;
      if (GRAV) fsum += gco;
      const T fcoef = mj * fsum;
      each_axis(Axes<DIM>{}, [&](int d) { acc.a[d] -= fcoef * dx[d]; });
      acc.du += mj * (cigi + T(0.5) * pigb) * vdotr;
    };
    // One pair of the pair walk, in straight-line code: j's further fields
    // from the window by row index, and m_j = 0 where the pair is not live
    // (the lane has none left) or lies outside both supports (q_i >= 2 and
    // q_j >= 2).
    auto pair = [&](const Entry<T>& c, int slot, bool live) {
      T dx[DIM];
      each_axis(Axes<DIM>{}, [&](int d) { dx[d] = o.x[d] - c.p[d]; });
      const T r2 = dot(dx, dx);
      const T invr = Num<T>::rsqrt(r2 + Num<T>::tiny);
      const T r = r2 * invr;
      const T qi = r * o.invh;
      const T qj = r * c.w;
      Vec4<T> jv[NV];
      each_axis(Axes<NV>{}, [&](int v) { jv[v] = gather(row[slot], v); });
      terms(dx, r2, invr, qi, qj, T(0), jv, live && (qi < T(2) || qj < T(2)));
    };
    // One pair of the GRAV walk, in which every lane visits every survivor:
    // a lane whose row does not take it leaves at once, a pair outside both
    // supports adds its gravity alone, and j's further fields come from
    // their staged vectors.
    auto grav_pair = [&](const Entry<T>& c, int slot) {
      T dx[DIM];
      each_axis(Axes<DIM>{}, [&](int d) { dx[d] = o.x[d] - c.p[d]; });
      const T r2 = dot(dx, dx);
      if (!takes(c)) return;
      const T invr = Num<T>::rsqrt(r2 + Num<T>::tiny);
      const T r = r2 * invr;
      const T gco = grav_coef(r2, r, g);
      const T qi = r * o.invh;
      const T qj = r * c.w;
      if (qi >= T(2) && qj >= T(2)) {  // both gradients vanish
        // m_j: further field DIM of j, and GRAV is 3D
        const T fcoef = load_vec(rest + slot * NV).d * gco;
        each_axis(Axes<DIM>{}, [&](int d) { acc.a[d] -= fcoef * dx[d]; });
        return;
      }
      Vec4<T> jv[NV];
      each_axis(Axes<NV>{},
                [&](int v) { jv[v] = load_vec(rest + slot * NV + v); });
      terms(dx, r2, invr, qi, qj, gco, jv, true);
    };
    const bool has_mass = F(R::M, i) > T(0);
    const Box<T, DIM> box = Box<T, DIM>::of(o.x, has_mass);
    const T reach = Margin<T>::reach * warp_max(has_mass ? o.h : T(0));
    const T reach2 = reach * reach;
    const T gcut2 = rcut2 * Margin<T>::rcut2;
    cull_and_stage<T, NSEG>(
        rg, lane, ent, cap, entry,
        [&](const Entry<T>& e, int k) {
          if (!(F(R::M, k) > T(0))) return false;
          const T g2 = box.gap2(e.p);
          bool in = g2 < reach2 || g2 * e.w * e.w < Margin<T>::reach2;
          if (GRAV) in = in || g2 <= gcut2;
          return in;
        },
        [&](int k, int slot) {
          if constexpr (GRAV)
            each_axis(Axes<NV>{}, [&](int v) {
              store_vec(rest + slot * NV + v, gather(k, v));
            });
          else
            row[slot] = k;
        },
        [&](int n) {
          if constexpr (GRAV)
            every_lane_walk<T>(n, ent, grav_pair);
          else
            test_and_walk<FORCE_STEP, T>(n, lane, ent, mask, has_mass, takes,
                                         pair);
        });
  }
  each_axis(Axes<DIM>{},
            [&](int d) { acc_out[DIM * (size_t)i + d] = acc.a[d]; });
  du_out[i] = acc.du;
}

// Kernel C's kernels: the pair walk's, named for it, so that a trace tells
// it from the GRAV mode's walk in which every lane visits every survivor
// (`forces_kernel`, below).
template <typename T, int DIM, bool BF, bool FAST, bool GRAV>
__global__ void __maxnreg__(sizeof(T) == 4 ? 64 : 128)
forces_pairs_kernel(const T* __restrict__ win, const int* __restrict__ w_lo,
                    const int* __restrict__ w_nact, int Ns, int group,
                    T alpha, T beta, T epsv, const T* __restrict__ gsc, T G,
                    T rcut2, T* __restrict__ acc_out,
                    T* __restrict__ du_out) {
  forces_row<T, DIM, BF, FAST, GRAV, false>(win, w_lo, w_nact, Ns, group, 0,
                                            alpha, beta, epsv, gsc, G, rcut2,
                                            acc_out, du_out);
}

template <typename T, int DIM, bool BF, bool FAST, bool GRAV>
__global__ void __maxnreg__(sizeof(T) == 4 ? 64 : 128)
forces_pairs_compact_kernel(
    const T* __restrict__ win, const int* __restrict__ c_lo,
    const int* __restrict__ c_len, int Ns, int group, int cwidth, T alpha,
    T beta, T epsv, const T* __restrict__ gsc, T G, T rcut2,
    T* __restrict__ acc_out, T* __restrict__ du_out) {
  forces_row<T, DIM, BF, FAST, GRAV, true>(win, c_lo, c_len, Ns, group,
                                           cwidth, alpha, beta, epsv, gsc, G,
                                           rcut2, acc_out, du_out);
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

// The kernel, block size and dynamic shared memory of the newest launch,
// for sphax_last_launch.
struct LastLaunch {
  const void* kernel = nullptr;
  int threads = 0;
  size_t smem = 0;
};
LastLaunch last_launch;

// Launches `kernel` on one block a tile with `smem` bytes of the warps'
// staging buffers as dynamic shared memory (above 48 KB a block only after
// the attribute is raised).
template <typename K, typename... Args>
cudaError_t launch_tiles(K kernel, int Ns, int tile, size_t smem,
                         void* stream, Args... args) {
  last_launch = {reinterpret_cast<const void*>(kernel), tile, smem};
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(Ns / tile), dim3(tile), smem,
           static_cast<cudaStream_t>(stream)>>>(args...);
  return cudaGetLastError();
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
  cudaError_t err = cudaSuccess;
  auto run = [&](auto kernel, auto... cw) {
    err = launch_tiles(
        kernel, Ns, tile, stage_bytes(tile, PairCap<T>::bytes), stream,
        static_cast<const T*>(win), static_cast<const T*>(h0),
        static_cast<const int*>(tab_lo), static_cast<const int*>(tab_n), Ns,
        group, cw..., T(sig), T(eta_d), T(hcap), iters, static_cast<T*>(h),
        static_cast<T*>(rho), static_cast<T*>(drdh), static_cast<T*>(div),
        static_cast<T*>(curl));
  };
  auto args = [&](auto bals_c) {
    constexpr bool B = decltype(bals_c)::value;
    if constexpr (COMPACT)
      run(solve_h_density_pairs_compact_kernel<T, DIM, B>, cwidth);
    else
      run(solve_h_density_pairs_kernel<T, DIM, B>);
  };
  if (bals)
    args(std::true_type{});
  else
    args(std::false_type{});
  return err;
}

// fast_math (approximate divides) applies to fp32 only.
template <typename T, int DIM, bool GRAV, bool COMPACT>
cudaError_t launch_forces(const void* win, const void* tab_lo,
                          const void* tab_n, int Ns, int tile, int group,
                          int cwidth, double alpha, double beta, double epsv,
                          int use_bf, int fast, const void* gsc, double G,
                          double rcut2, void* acc, void* du, void* stream) {
  cudaError_t err = cudaSuccess;
  auto run = [&](auto kernel, auto... cw) {
    err = launch_tiles(
        kernel, Ns, tile, stage_bytes(tile, ForceStage<T, GRAV>::bytes),
        stream,
        static_cast<const T*>(win),
        static_cast<const int*>(tab_lo), static_cast<const int*>(tab_n), Ns,
        group, cw..., T(alpha), T(beta), T(epsv),
        static_cast<const T*>(gsc), T(G), T(rcut2), static_cast<T*>(acc),
        static_cast<T*>(du));
  };
  auto args = [&](auto bf_c, auto fast_c) {
    constexpr bool B = decltype(bf_c)::value, F = decltype(fast_c)::value;
    if constexpr (COMPACT && GRAV)
      run(forces_compact_kernel<T, DIM, B, F, GRAV>, cwidth);
    else if constexpr (COMPACT)
      run(forces_pairs_compact_kernel<T, DIM, B, F, GRAV>, cwidth);
    else if constexpr (GRAV)
      run(forces_kernel<T, DIM, B, F, GRAV>);
    else
      run(forces_pairs_kernel<T, DIM, B, F, GRAV>);
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
  return err;
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

// What the runtime reports of the kernel A or C launched last: out[0]
// registers a thread, out[1] static and out[2] dynamic shared memory in
// bytes a block, out[3] local memory in bytes a thread, out[4] threads a
// block, out[5] the blocks of that launch a SM can hold at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
cudaError_t sphax_last_launch(int* out) {
  if (last_launch.kernel == nullptr) return cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, last_launch.kernel);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, last_launch.kernel, last_launch.threads, last_launch.smem);
  if (err != cudaSuccess) return err;
  out[0] = attr.numRegs;
  out[1] = int(attr.sharedSizeBytes);
  out[2] = int(last_launch.smem);
  out[3] = int(attr.localSizeBytes);
  out[4] = last_launch.threads;
  out[5] = blocks;
  return cudaSuccess;
}

const char* sphax_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

// Per-window min and max for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/interval_stats.py:
//   interval_stats  <- interval_stats_kernel / interval_stats_pallas
// For x[T, S] (time-major: S series side by side, row-major) and a window
// W with T % W == 0:
//   mins[w, s] = min of x[w*W .. (w+1)*W - 1, s];  maxs[w, s] likewise
// in x's dtype (float32, float64, or bfloat16 passed as its 16-bit words).
//
// Semantics are the reference's (XLA's min and max, pinned by the CPU
// tests against the JAX function):
// * NaN propagates: a window that holds a NaN gives a NaN, the first one
//   in time order.  fminf/fmaxf would drop it, so the selection is made of
//   explicit comparisons.  A float32 or float64 NaN keeps its own bits; a
//   bfloat16 NaN comes out as the quiet NaN 0x7fc0 with its sign, as the
//   reference's float32 round trip gives it;
// * -0.0 < +0.0: the min of a window that holds both zeros is -0.0 and its
//   max +0.0, in either order;
// * the output is the selected input element itself, never a value
//   rebuilt from a float.
//
// Bound on the card: one read of x and one write of two [T/W, S] outputs,
// so memory bytes bound it; the design keeps the loads wide and the
// instructions an element few enough to stay under the bytes' time.
// * Wide loads.  A thread owns VEC adjacent series, VEC = 16 bytes /
//   sizeof(x) (8 in bfloat16, 4 in float32, 2 in float64), and loads them
//   with one 16-byte load a row, so a warp reads 512 contiguous bytes of
//   each row whatever the dtype: the time follows the number of loads as
//   much as their bytes.  Eight rows' loads are issued before their
//   comparisons.  Vector loads
//   need every row start 16-byte aligned: the launch takes VEC = 1 (one
//   element a thread, 8 stretches) when S % VEC != 0 or a pointer is off
//   16 bytes.
// * Few instructions an element.  Within a stretch the min and max are
//   taken on order keys: a number's bits as an unsigned integer whose
//   order is the numbers' with -0 < +0, so one integer min and one max an
//   element, plus an add that flags a NaN.  Over a stretch without a NaN
//   the keys select exactly the elements take_min and take_max would
//   (equal numbers other than the zeros have equal bits); a stretch that
//   holds a NaN is walked again with take_min and take_max in time order.
//   Those two are written as selects, not branches.
// * Enough warps.  A block owns 32 x VEC series of one window: its 32 x
//   PARTS threads split the window's W rows into PARTS contiguous
//   stretches (with VEC > 1, doubled up to 32 until the grid holds 2^17
//   threads and a stretch is at most 64 rows); the stretches' results are
//   then folded in time order through shared memory, one series a thread,
//   which keeps "the first NaN" and the zero rule exact.
// The TPU kernel reduced a (W, 128) VMEM tile per grid step.
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int SERIES = 32;  // threads of a block across the series (threadIdx.x)

// stretches of a window (threadIdx.y), at most: up to 32 when a thread
// holds 16 bytes of series, so a small grid still keeps enough loads in
// flight
template <int VEC>
struct Parts {
  static constexpr int MAX = VEC == 1 ? 8 : 32;
};

// VEC elements of one row, loaded and stored as one 16-byte access
template <typename S, int VEC>
struct alignas(sizeof(S) * VEC) Pack {
  S e[VEC];
};

template <typename S>
struct Elem;

// storage type S, compared as C; its bits as the unsigned U (TOP the
// sign bit, INF the bits of +infinity)
template <>
struct Elem<float> {
  using C = float;
  using U = uint32_t;
  static constexpr U TOP = 0x80000000u, INF = 0x7f800000u;
  static __device__ __forceinline__ C value(float v) { return v; }
  static __device__ __forceinline__ float out(float v) { return v; }
  static __device__ __forceinline__ U bits(float v) { return __float_as_uint(v); }
  static __device__ __forceinline__ float from(U u) { return __uint_as_float(u); }
};

template <>
struct Elem<double> {
  using C = double;
  using U = unsigned long long;
  static constexpr U TOP = 0x8000000000000000ull, INF = 0x7ff0000000000000ull;
  static __device__ __forceinline__ C value(double v) { return v; }
  static __device__ __forceinline__ double out(double v) { return v; }
  static __device__ __forceinline__ U bits(double v) { return (U)__double_as_longlong(v); }
  static __device__ __forceinline__ double from(U u) { return __longlong_as_double((long long)u); }
};

template <>
struct Elem<uint16_t> {  // bfloat16
  using C = float;
  using U = uint32_t;  // the 16 bits in the low half
  static constexpr U TOP = 0x8000u, INF = 0x7f80u;
  static __device__ __forceinline__ U bits(uint16_t v) { return v; }
  static __device__ __forceinline__ uint16_t from(U u) { return (uint16_t)u; }
  static __device__ __forceinline__ C value(uint16_t v) {
    return __uint_as_float((uint32_t)v << 16);
  }
  static __device__ __forceinline__ uint16_t out(uint16_t v) {
    return (v & 0x7fff) > 0x7f80 ? (uint16_t)((v & 0x8000) | 0x7fc0) : v;
  }
};

// fold a candidate element e (compared as f) into a running min (lo, flo)
// or max (hi, fhi): a NaN, once held, stays; a NaN candidate replaces a
// number; -0 beats +0 for the min and +0 beats -0 for the max.  Written as
// selects, not branches, which diverge from lane to lane.
template <typename S, typename C>
__device__ __forceinline__ void take_min(S e, C f, S& lo, C& flo) {
  const bool take = !isnan(flo) & (isnan(f) | (f < flo) |
                                   ((f == flo) & (signbit(f) != 0) & (signbit(flo) == 0)));
  lo = take ? e : lo;
  flo = take ? f : flo;
}

template <typename S, typename C>
__device__ __forceinline__ void take_max(S e, C f, S& hi, C& fhi) {
  const bool take = !isnan(fhi) & (isnan(f) | (f > fhi) |
                                   ((f == fhi) & (signbit(f) == 0) & (signbit(fhi) != 0)));
  hi = take ? e : hi;
  fhi = take ? f : fhi;
}

// The order key of a number's bits: an unsigned integer whose order is the
// numbers' order with -0 < +0 (a negative number's bits all flipped, a
// positive one's sign bit set).  Over a stretch with no NaN, the min and
// max keys give exactly the elements take_min and take_max select: equal
// numbers other than the two zeros have equal bits.
template <typename S>
__device__ __forceinline__ typename Elem<S>::U key(typename Elem<S>::U u) {
  using E = Elem<S>;
  return u ^ ((u & E::TOP) ? (E::TOP | (E::TOP - 1)) : E::TOP);
}

template <typename S>
__device__ __forceinline__ typename Elem<S>::U unkey(typename Elem<S>::U k) {
  using E = Elem<S>;
  return k ^ ((k & E::TOP) ? E::TOP : (E::TOP | (E::TOP - 1)));
}

// TOP is set in the result when u is a NaN's bits: |u| > INF
template <typename S>
__device__ __forceinline__ typename Elem<S>::U nan_probe(typename Elem<S>::U u) {
  using E = Elem<S>;
  return (u & (E::TOP - 1)) + (E::TOP - 1 - E::INF);
}

template <typename S, int VEC>
__device__ __forceinline__ Pack<S, VEC> load(const S* p) {
  return *reinterpret_cast<const Pack<S, VEC>*>(p);
}

template <typename S, int VEC>
__global__ void __launch_bounds__(SERIES * Parts<VEC>::MAX)
    interval_stats_kernel(const S* __restrict__ x, int64_t nw, int64_t s, int w,
                                      S* __restrict__ mins, S* __restrict__ maxs) {
  using E = Elem<S>;
  using C = typename E::C;
  using U = typename E::U;
  using P = Pack<S, VEC>;
  constexpr int BATCH = 8;  // rows whose loads are in flight before their comparisons
  __shared__ P part_lo[Parts<VEC>::MAX][SERIES];
  __shared__ P part_hi[Parts<VEC>::MAX][SERIES];
  const int parts = blockDim.y;
  // the thread's first series; with VEC > 1, S % VEC == 0, so its VEC
  // series are all in or all out
  const int64_t col = ((int64_t)blockIdx.x * SERIES + threadIdx.x) * VEC;
  const bool active = col < s;
  // stretch p covers rows [p*w/parts, (p+1)*w/parts): never empty, as parts <= w
  const int r0 = (int)((int64_t)threadIdx.y * w / parts);
  const int r1 = (int)((int64_t)(threadIdx.y + 1) * w / parts);
  for (int64_t win = blockIdx.y; win < nw; win += gridDim.y) {
    if (active) {
      const S* p = x + (size_t)win * w * s + col;
      // min and max keys over the stretch, and whether it holds a NaN
      U kmin[VEC], kmax[VEC], probe = 0;
      {
        const P e = load<S, VEC>(p + (size_t)r0 * s);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const U u = E::bits(e.e[j]);
          kmin[j] = kmax[j] = key<S>(u);
          probe |= nan_probe<S>(u);
        }
      }
      int r = r0 + 1;
      for (; r + BATCH <= r1; r += BATCH) {
        P e[BATCH];
#pragma unroll
        for (int b = 0; b < BATCH; ++b) e[b] = load<S, VEC>(p + (size_t)(r + b) * s);
#pragma unroll
        for (int b = 0; b < BATCH; ++b)
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            const U u = E::bits(e[b].e[j]);
            const U k = key<S>(u);
            kmin[j] = min(kmin[j], k);
            kmax[j] = max(kmax[j], k);
            probe |= nan_probe<S>(u);
          }
      }
      for (; r < r1; ++r) {
        const P e = load<S, VEC>(p + (size_t)r * s);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const U u = E::bits(e.e[j]);
          const U k = key<S>(u);
          kmin[j] = min(kmin[j], k);
          kmax[j] = max(kmax[j], k);
          probe |= nan_probe<S>(u);
        }
      }
      P lo, hi;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        lo.e[j] = E::from(unkey<S>(kmin[j]));
        hi.e[j] = E::from(unkey<S>(kmax[j]));
      }
      if (probe & E::TOP) {  // a NaN: the stretch again, in time order
        lo = hi = load<S, VEC>(p + (size_t)r0 * s);
        C flo[VEC], fhi[VEC];
#pragma unroll
        for (int j = 0; j < VEC; ++j) flo[j] = fhi[j] = E::value(lo.e[j]);
        for (int q = r0 + 1; q < r1; ++q) {
          const P e = load<S, VEC>(p + (size_t)q * s);
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            const C f = E::value(e.e[j]);
            take_min(e.e[j], f, lo.e[j], flo[j]);
            take_max(e.e[j], f, hi.e[j], fhi[j]);
          }
        }
      }
      part_lo[threadIdx.y][threadIdx.x] = lo;
      part_hi[threadIdx.y][threadIdx.x] = hi;
    }
    __syncthreads();
    // fold the stretches in time order, one series a thread (a stretch's
    // min and max are its first NaN if it has one)
    for (int t = threadIdx.y * SERIES + threadIdx.x; t < SERIES * VEC; t += SERIES * parts) {
      const int tx = t / VEC, j = t % VEC;
      const int64_t c = col - (int64_t)threadIdx.x * VEC + t;
      if (c < s) {
        S lo = part_lo[0][tx].e[j];
        S hi = part_hi[0][tx].e[j];
        C flo = E::value(lo);
        C fhi = E::value(hi);
        for (int q = 1; q < parts; ++q) {
          const S a = part_lo[q][tx].e[j];
          const S b = part_hi[q][tx].e[j];
          take_min(a, E::value(a), lo, flo);
          take_max(b, E::value(b), hi, fhi);
        }
        mins[(size_t)win * s + c] = E::out(lo);
        maxs[(size_t)win * s + c] = E::out(hi);
      }
    }
    __syncthreads();
  }
}

template <typename S, int VEC>
static int run(const S* x, int64_t nw, int64_t s, int w, S* mins, S* maxs, cudaStream_t stream) {
  const int64_t gy = nw < 65535 ? nw : 65535;
  const int64_t per_block = (int64_t)SERIES * VEC;
  const dim3 grid((unsigned)((s + per_block - 1) / per_block), (unsigned)gy);
  int parts;
  if (VEC == 1) {  // 8 stretches
    parts = Parts<VEC>::MAX;
    while (parts > w) parts /= 2;
  } else {  // more stretches while the grid holds under 2^17 threads or they are long
    parts = 1;
    const int64_t blocks = (int64_t)grid.x * grid.y;
    while (parts * 2 <= Parts<VEC>::MAX && parts * 2 <= w &&
           (blocks * parts * SERIES < (1 << 17) || w / parts > 64))
      parts *= 2;
  }
  const dim3 block(SERIES, parts);
  interval_stats_kernel<S, VEC><<<grid, block, 0, stream>>>(x, nw, s, w, mins, maxs);
  return (int)cudaGetLastError();
}

// VEC = 16 bytes of series a thread where every row start is 16-byte
// aligned, else one series a thread
template <typename S>
static int launch(const S* x, int64_t nw, int64_t s, int w, S* mins, S* maxs,
                  cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(S);
  const bool aligned = (((uintptr_t)x | (uintptr_t)mins | (uintptr_t)maxs) & 15) == 0;
  if (s % VEC == 0 && aligned) return run<S, VEC>(x, nw, s, w, mins, maxs, stream);
  return run<S, 1>(x, nw, s, w, mins, maxs, stream);
}

extern "C" {
int interval_stats_f32(const float* x, int64_t nw, int64_t s, int w, float* mins, float* maxs,
                       cudaStream_t stream) {
  return launch<float>(x, nw, s, w, mins, maxs, stream);
}
int interval_stats_f64(const double* x, int64_t nw, int64_t s, int w, double* mins,
                       double* maxs, cudaStream_t stream) {
  return launch<double>(x, nw, s, w, mins, maxs, stream);
}
int interval_stats_bf16(const uint16_t* x, int64_t nw, int64_t s, int w, uint16_t* mins,
                        uint16_t* maxs, cudaStream_t stream) {
  return launch<uint16_t>(x, nw, s, w, mins, maxs, stream);
}
}

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
// * the output is the selected input element itself (compared in float
//   for bfloat16), never a value rebuilt from a float.
//
// Bound on the card: one read of x and one write of two [T/W, S] outputs
// against ~2 comparisons an element, so memory bytes bound it.  The TPU
// kernel reduced a (W, 128) VMEM tile per grid step.  Here a block owns 32
// series of one window: its 32 x PARTS threads split the window's W rows
// into PARTS contiguous stretches, so a warp reads 32 adjacent series of
// one row (coalesced) and enough warps are in flight even when T/W x S is
// small; the stretches' results are then folded in time order through
// shared memory, which keeps "the first NaN" and the zero rule exact.
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int SERIES = 32;  // series of a block (threadIdx.x)
constexpr int PARTS = 8;    // stretches of a window (threadIdx.y), at most

// storage type S, compared as C
template <typename S>
struct Elem;

template <>
struct Elem<float> {
  using C = float;
  static __device__ __forceinline__ C value(float v) { return v; }
  static __device__ __forceinline__ float out(float v) { return v; }
};

template <>
struct Elem<double> {
  using C = double;
  static __device__ __forceinline__ C value(double v) { return v; }
  static __device__ __forceinline__ double out(double v) { return v; }
};

template <>
struct Elem<uint16_t> {  // bfloat16
  using C = float;
  static __device__ __forceinline__ C value(uint16_t v) {
    return __uint_as_float((uint32_t)v << 16);
  }
  static __device__ __forceinline__ uint16_t out(uint16_t v) {
    return (v & 0x7fff) > 0x7f80 ? (uint16_t)((v & 0x8000) | 0x7fc0) : v;
  }
};

// fold a candidate element e (compared as f) into a running min (lo, flo)
// or max (hi, fhi): a NaN, once held, stays; a NaN candidate replaces a
// number; -0 beats +0 for the min and +0 beats -0 for the max
template <typename S, typename C>
__device__ __forceinline__ void take_min(S e, C f, S& lo, C& flo) {
  if (!isnan(flo) && (isnan(f) || f < flo || (f == flo && signbit(f) && !signbit(flo)))) {
    lo = e;
    flo = f;
  }
}

template <typename S, typename C>
__device__ __forceinline__ void take_max(S e, C f, S& hi, C& fhi) {
  if (!isnan(fhi) && (isnan(f) || f > fhi || (f == fhi && !signbit(f) && signbit(fhi)))) {
    hi = e;
    fhi = f;
  }
}

template <typename S>
__global__ void interval_stats_kernel(const S* __restrict__ x, int64_t nw, int64_t s, int w,
                                      S* __restrict__ mins, S* __restrict__ maxs) {
  using E = Elem<S>;
  using C = typename E::C;
  __shared__ S part_lo[PARTS][SERIES];
  __shared__ S part_hi[PARTS][SERIES];
  const int parts = blockDim.y;
  const int64_t col = (int64_t)blockIdx.x * SERIES + threadIdx.x;
  const bool active = col < s;
  // stretch p covers rows [p*w/parts, (p+1)*w/parts): never empty, as parts <= w
  const int r0 = (int)((int64_t)threadIdx.y * w / parts);
  const int r1 = (int)((int64_t)(threadIdx.y + 1) * w / parts);
  for (int64_t win = blockIdx.y; win < nw; win += gridDim.y) {
    if (active) {
      const S* p = x + (size_t)win * w * s + col;
      S lo = p[(size_t)r0 * s];
      S hi = lo;
      C flo = E::value(lo);
      C fhi = flo;
#pragma unroll 8
      for (int r = r0 + 1; r < r1; ++r) {
        const S e = p[(size_t)r * s];
        const C f = E::value(e);
        take_min(e, f, lo, flo);
        take_max(e, f, hi, fhi);
      }
      part_lo[threadIdx.y][threadIdx.x] = lo;
      part_hi[threadIdx.y][threadIdx.x] = hi;
    }
    __syncthreads();
    if (active && threadIdx.y == 0) {
      S lo = part_lo[0][threadIdx.x];
      S hi = part_hi[0][threadIdx.x];
      C flo = E::value(lo);
      C fhi = E::value(hi);
      // in time order: a stretch's min and max are its first NaN if it has one
      for (int q = 1; q < parts; ++q) {
        const S a = part_lo[q][threadIdx.x];
        const S b = part_hi[q][threadIdx.x];
        take_min(a, E::value(a), lo, flo);
        take_max(b, E::value(b), hi, fhi);
      }
      mins[(size_t)win * s + col] = E::out(lo);
      maxs[(size_t)win * s + col] = E::out(hi);
    }
    __syncthreads();
  }
}

template <typename S>
static int launch(const S* x, int64_t nw, int64_t s, int w, S* mins, S* maxs,
                  cudaStream_t stream) {
  int parts = PARTS;
  while (parts > w) parts /= 2;
  const dim3 block(SERIES, parts);
  const int64_t gy = nw < 65535 ? nw : 65535;
  const dim3 grid((unsigned)((s + SERIES - 1) / SERIES), (unsigned)gy);
  interval_stats_kernel<S><<<grid, block, 0, stream>>>(x, nw, s, w, mins, maxs);
  return (int)cudaGetLastError();
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

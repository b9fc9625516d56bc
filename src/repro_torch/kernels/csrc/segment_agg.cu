// Closed-form per-segment aggregates of the analytics path for Hopper,
// sm_90a: the row kernel and a whole query step in one launch.
//
// Replaces the Pallas TPU kernel repro/kernels/segment_agg.py:
//   segment_agg    <- segment_agg_kernel / segment_agg_pallas
//   segment_query  <- the same rows, plus the overlap search, the central
//                     second moment and the threshold counts that
//                     repro/core/segment_algebra.py runs around the kernel
//
// segment_agg: for M segment rows, each a line theta + slope * i over the
// local window i in [a, b), emit the window's sum, sum of squares, min and
// max; rows with b <= a emit the identity (0, 0, +3.4e38, -3.4e38).  Input
// is the wrapper's packed rows[M, 4] = (theta, slope, a, b); output is
// out[4, M] = (sum, sumsq, min, max), one contiguous column each.
//
// Two routes, each with its own expressions:
// * float64 (the analytics path): the per-row terms of
//   repro/core/segment_algebra.py base_aggregate, bit for bit:
//     S1(x) = x (x - 1) / 2,  S2(x) = x (x - 1) (2x - 1) / 6
//     d1 = S1(b) - S1(a),  d2 = S2(b) - S2(a),  m = b - a
//     sum = m theta + slope d1
//     sumsq = m theta theta + 2 theta slope d1 + slope slope d2
//     va = theta + slope a,  vb = theta + slope (b - 1)
//   The differences of S1 and S2 (not of the cubes) keep the terms exact
//   for windows far past 2^17 samples.  row_f64 computes them for both
//   entry points.
// * float32: the Pallas body (d1 and d2 from the differences of the
//   products), held to repro/kernels/ref.py segment_agg_ref.
// Every operation is an explicit round-to-nearest intrinsic, left to right
// as numpy evaluates it, never fused into an FMA; the divisions are IEEE
// divisions. min and max are (va < vb ? va : vb) and (va > vb ? va : vb):
// on a tie (-0.0 against 0.0) that is the second operand, as numpy's
// minimum and maximum give it.
//
// segment_query: one step of a query over P parts (a part is one frame's
// segment table and the frame-local sample range [t0, t1)), one block a
// part.  A table is one int64 buffer [4, k] = (t0s, lens, theta bits,
// slope bits) resident on the card; a part's descriptor is 8 int64 words:
//   (table address, k, t0, t1, row offset, f1 bits, f2 bits, unused)
// Each thread finds i0 = the first segment whose end t0s + lens is past t0
// and i1 = the first segment whose start is at or after t1 (binary
// searches over the table, as torch.searchsorted does them), then walks
// rows i0 + tid, i0 + tid + blockDim.x, ... below i1 with
// a = max(t0 - start, 0) and b = min(t1 - start, len) (b > a on every such
// row).  The mode picks the work:
//   0: (sum, sumsq, min, max) a row through row_f64;
//   1: the central terms about mu = f1, in the port's expression order:
//        m = b - a,  ibar = (a + b - 1) / 2,  mean = theta + slope ibar
//        s slope m (m m - 1) / 12 + m ((mean - mu) (mean - mu))
//   2: the counts of i in [a, b) with theta + slope i <op> c for c = f1
//      and c = f2.  The prediction is monotone in i under rounding, so the
//      satisfied set is a half-line: a lower-bound bisection of a fixed
//      ceil(log2(b - a + 1)) steps finds its end in registers, and equals
//      the reference's loop (its answer is unique).  A row's counts are
//      reduced over the block by warp shuffles and shared memory: integer
//      sums are exact in any order.
// The output is one int64 buffer: a header [P, 4] = (i0, i1, count f1,
// count f2), then float64 columns [C, R] (C = 4 in mode 0, 1 in mode 1,
// 0 in mode 2; R rows, part p's rows from its row offset), so the host
// reads a whole step back in one copy.
//
// Bound on the card: memory bytes (the rows touched, 32 bytes each, the
// descriptors and the outputs); at the sizes of a query (a few parts of a
// few rows) a launch takes the card's launch latency, which no design of
// the body moves: the step's one launch and one read-back are the point.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr double kBig = 3.4e38;
constexpr int kThreads = 256;
constexpr int kQueryThreads = 128;

__device__ __forceinline__ double s1_f64(double x) {
  return __ddiv_rn(__dmul_rn(x, __dadd_rn(x, -1.0)), 2.0);
}

__device__ __forceinline__ double s2_f64(double x) {
  const double t = __dmul_rn(__dmul_rn(x, __dadd_rn(x, -1.0)), __dadd_rn(__dmul_rn(2.0, x), -1.0));
  return __ddiv_rn(t, 6.0);
}

// the float64 row terms of both entry points
__device__ __forceinline__ void row_f64(double theta, double slope, double a, double b,
                                        double& sum, double& sumsq, double& mn, double& mx) {
  const double w = __dadd_rn(b, -a);
  sum = 0.0, sumsq = 0.0, mn = kBig, mx = -kBig;
  if (w > 0.0) {
    const double d1 = __dadd_rn(s1_f64(b), -s1_f64(a));
    const double d2 = __dadd_rn(s2_f64(b), -s2_f64(a));
    sum = __dadd_rn(__dmul_rn(w, theta), __dmul_rn(slope, d1));
    const double t1 = __dmul_rn(__dmul_rn(w, theta), theta);
    const double t2 = __dmul_rn(__dmul_rn(__dmul_rn(2.0, theta), slope), d1);
    const double t3 = __dmul_rn(__dmul_rn(slope, slope), d2);
    sumsq = __dadd_rn(__dadd_rn(t1, t2), t3);
    const double va = __dadd_rn(theta, __dmul_rn(slope, a));
    const double vb = __dadd_rn(theta, __dmul_rn(slope, __dadd_rn(b, -1.0)));
    mn = va < vb ? va : vb;
    mx = va > vb ? va : vb;
  }
}

__global__ void segment_agg_f64_kernel(const double* __restrict__ rows, int64_t m,
                                       double* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const double2* r = reinterpret_cast<const double2*>(rows) + 2 * i;
  const double2 p = r[0];
  const double2 q = r[1];
  double sum, sumsq, mn, mx;
  row_f64(p.x, p.y, q.x, q.y, sum, sumsq, mn, mx);
  out[i] = sum;
  out[m + i] = sumsq;
  out[2 * m + i] = mn;
  out[3 * m + i] = mx;
}

__global__ void segment_agg_f32_kernel(const float* __restrict__ rows, int64_t m,
                                       float* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const float4 p = reinterpret_cast<const float4*>(rows)[i];
  const float theta = p.x, slope = p.y, a = p.z, b = p.w;
  const float w = fmaxf(__fadd_rn(b, -a), 0.0f);
  float sum = 0.0f, sumsq = 0.0f, mn = (float)kBig, mx = -(float)kBig;
  if (w > 0.0f) {
    const float bb = __fmul_rn(b, __fadd_rn(b, -1.0f));
    const float aa = __fmul_rn(a, __fadd_rn(a, -1.0f));
    const float d1 = __fmul_rn(__fadd_rn(bb, -aa), 0.5f);
    const float b3 = __fmul_rn(bb, __fadd_rn(__fmul_rn(2.0f, b), -1.0f));
    const float a3 = __fmul_rn(aa, __fadd_rn(__fmul_rn(2.0f, a), -1.0f));
    const float d2 = __fdiv_rn(__fadd_rn(b3, -a3), 6.0f);
    sum = __fadd_rn(__fmul_rn(w, theta), __fmul_rn(slope, d1));
    const float t1 = __fmul_rn(__fmul_rn(w, theta), theta);
    const float t2 = __fmul_rn(__fmul_rn(__fmul_rn(2.0f, theta), slope), d1);
    const float t3 = __fmul_rn(__fmul_rn(slope, slope), d2);
    sumsq = __fadd_rn(__fadd_rn(t1, t2), t3);
    const float va = __fadd_rn(theta, __fmul_rn(slope, a));
    const float vb = __fadd_rn(theta, __fmul_rn(slope, __fadd_rn(b, -1.0f)));
    mn = va < vb ? va : vb;
    mx = va > vb ? va : vb;
  }
  out[i] = sum;
  out[m + i] = sumsq;
  out[2 * m + i] = mn;
  out[3 * m + i] = mx;
}

// theta + slope * i <cmp> c, with cmp '>' (strict) or '>='
__device__ __forceinline__ bool sat(double theta, double slope, int64_t i, double c, bool strict) {
  const double v = __dadd_rn(theta, __dmul_rn(slope, (double)i));
  return strict ? v > c : v >= c;
}

// the count of i in [a, b) with theta + slope * i > c (>= c when not
// strict): repro/core/segment_algebra.py _count_upset for one row
__device__ int64_t count_upset(double theta, double slope, int64_t a, int64_t b, double c,
                               bool strict) {
  if (slope == 0.0) return (strict ? theta > c : theta >= c) ? b - a : 0;
  if (!(slope > 0.0) && !(slope < 0.0)) return 0;  // a NaN slope counts nothing
  const bool up = slope > 0.0;  // up: the satisfied set is {i >= first}
  int64_t lo = a, hi = b;
  const int steps = 64 - __clzll((unsigned long long)(b - a));
  for (int s = 0; s < steps; ++s) {
    if (lo < hi) {
      const int64_t mid = (lo + hi) >> 1;
      if (sat(theta, slope, mid, c, strict) == up) hi = mid;
      else lo = mid + 1;
    }
  }
  return up ? b - lo : lo - a;
}

// op: 0 gt, 1 ge, 2 lt, 3 le
__device__ __forceinline__ int64_t count_op(double theta, double slope, int64_t a, int64_t b,
                                            double c, int op) {
  const bool strict = op == 0 || op == 3;
  const int64_t up = count_upset(theta, slope, a, b, c, strict);
  return op < 2 ? up : (b - a) - up;
}

__device__ __forceinline__ int64_t block_sum(int64_t v, int64_t* shared) {
  for (int d = 16; d > 0; d >>= 1) v += __shfl_down_sync(0xffffffffu, v, d);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) shared[warp] = v;
  __syncthreads();
  int64_t total = 0;
  if (threadIdx.x == 0)
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) total += shared[w];
  __syncthreads();
  return total;
}

__global__ void __launch_bounds__(kQueryThreads)
segment_query_kernel(const int64_t* __restrict__ desc, int nparts, int mode, int op,
                     int64_t nrows_out, int64_t* __restrict__ out) {
  __shared__ int64_t shared[2][kQueryThreads / 32];
  double* cols = reinterpret_cast<double*>(out + 4 * (int64_t)nparts);
  for (int p = blockIdx.x; p < nparts; p += gridDim.x) {
    const int64_t* d = desc + 8 * (int64_t)p;
    const int64_t* t0s = reinterpret_cast<const int64_t*>(d[0]);
    const int64_t k = d[1], t0 = d[2], t1 = d[3], off = d[4];
    const double f1 = __longlong_as_double(d[5]), f2 = __longlong_as_double(d[6]);
    const int64_t* lens = t0s + k;
    const double* thetas = reinterpret_cast<const double*>(t0s + 2 * k);
    const double* slopes = reinterpret_cast<const double*>(t0s + 3 * k);
    int64_t lo = 0, hi = k;  // i0: first end past t0
    while (lo < hi) {
      const int64_t mid = (lo + hi) >> 1;
      if (t0s[mid] + lens[mid] > t0) hi = mid;
      else lo = mid + 1;
    }
    const int64_t i0 = lo;
    lo = 0, hi = k;  // i1: first start at or after t1
    while (lo < hi) {
      const int64_t mid = (lo + hi) >> 1;
      if (t0s[mid] >= t1) hi = mid;
      else lo = mid + 1;
    }
    const int64_t nrows = (t1 > t0 && lo > i0) ? lo - i0 : 0;
    int64_t c1 = 0, c2 = 0;
    for (int64_t r = threadIdx.x; r < nrows; r += blockDim.x) {
      const int64_t j = i0 + r, start = t0s[j];
      const int64_t a = t0 > start ? t0 - start : 0;
      const int64_t b = t1 - start < lens[j] ? t1 - start : lens[j];
      const double theta = thetas[j], slope = slopes[j];
      if (mode == 0) {
        double sum, sumsq, mn, mx;
        row_f64(theta, slope, (double)a, (double)b, sum, sumsq, mn, mx);
        cols[off + r] = sum;
        cols[nrows_out + off + r] = sumsq;
        cols[2 * nrows_out + off + r] = mn;
        cols[3 * nrows_out + off + r] = mx;
      } else if (mode == 1) {
        const double m = (double)(b - a);
        const double ibar = __ddiv_rn((double)(a + b - 1), 2.0);
        const double mean = __dadd_rn(theta, __dmul_rn(slope, ibar));
        const double within = __ddiv_rn(
            __dmul_rn(__dmul_rn(__dmul_rn(slope, slope), m), __dadd_rn(__dmul_rn(m, m), -1.0)),
            12.0);
        const double dev = __dadd_rn(mean, -f1);
        cols[off + r] = __dadd_rn(within, __dmul_rn(m, __dmul_rn(dev, dev)));
      } else {
        c1 += count_op(theta, slope, a, b, f1, op);
        c2 += count_op(theta, slope, a, b, f2, op);
      }
    }
    if (mode == 2) {
      c1 = block_sum(c1, shared[0]);
      c2 = block_sum(c2, shared[1]);
    }
    if (threadIdx.x == 0) {
      int64_t* h = out + 4 * (int64_t)p;
      h[0] = i0;
      h[1] = i0 + nrows;
      h[2] = c1;
      h[3] = c2;
    }
  }
}

unsigned blocks_for(int64_t m) { return (unsigned)((m + kThreads - 1) / kThreads); }

}  // namespace

extern "C" {
int segment_agg_f64(const double* rows, int64_t m, double* out, cudaStream_t stream) {
  segment_agg_f64_kernel<<<blocks_for(m), kThreads, 0, stream>>>(rows, m, out);
  return (int)cudaGetLastError();
}
int segment_agg_f32(const float* rows, int64_t m, float* out, cudaStream_t stream) {
  segment_agg_f32_kernel<<<blocks_for(m), kThreads, 0, stream>>>(rows, m, out);
  return (int)cudaGetLastError();
}
int segment_query(const int64_t* desc, int nparts, int mode, int op, int64_t nrows_out,
                  int64_t* out, cudaStream_t stream) {
  const int grid = nparts < 65535 ? nparts : 65535;
  segment_query_kernel<<<grid, kQueryThreads, 0, stream>>>(desc, nparts, mode, op, nrows_out,
                                                           out);
  return (int)cudaGetLastError();
}
}

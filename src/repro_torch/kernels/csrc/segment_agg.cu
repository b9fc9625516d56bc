// Closed-form per-segment aggregates of the analytics path for Hopper,
// sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/segment_agg.py:
//   segment_agg  <- segment_agg_kernel / segment_agg_pallas
// For M segment rows, each a line theta + slope * i over the local window
// i in [a, b), emit the window's sum, sum of squares, min and max; rows
// with b <= a emit the identity (0, 0, +3.4e38, -3.4e38).
//
// Input is the wrapper's packed rows[M, 4] = (theta, slope, a, b); output
// is out[4, M] = (sum, sumsq, min, max), one contiguous column each.
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
//   for windows far past 2^17 samples.
// * float32: the Pallas body (d1 and d2 from the differences of the
//   products), held to repro/kernels/ref.py segment_agg_ref.
// Every operation is an explicit round-to-nearest intrinsic, left to right
// as numpy evaluates it, never fused into an FMA; the divisions are IEEE
// divisions. min and max are (va < vb ? va : vb) and (va > vb ? va : vb):
// on a tie (-0.0 against 0.0) that is the second operand, as numpy's
// minimum and maximum give it.
//
// Bound on the card: 16 (float32) or 32 (float64) bytes read and as many
// written a row against about 30 operations, so memory bytes bound it.
// One thread a row: one 16-byte load (float32) or two (float64) of its
// packed scalars, neighbouring threads on neighbouring rows, and four
// coalesced column stores.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr double kBig = 3.4e38;

__device__ __forceinline__ double s1_f64(double x) {
  return __ddiv_rn(__dmul_rn(x, __dadd_rn(x, -1.0)), 2.0);
}

__device__ __forceinline__ double s2_f64(double x) {
  const double t = __dmul_rn(__dmul_rn(x, __dadd_rn(x, -1.0)), __dadd_rn(__dmul_rn(2.0, x), -1.0));
  return __ddiv_rn(t, 6.0);
}

__global__ void segment_agg_f64_kernel(const double* __restrict__ rows, int64_t m,
                                       double* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const double2* r = reinterpret_cast<const double2*>(rows) + 2 * i;
  const double2 p = r[0];
  const double2 q = r[1];
  const double theta = p.x, slope = p.y, a = q.x, b = q.y;
  const double w = __dadd_rn(b, -a);
  double sum = 0.0, sumsq = 0.0, mn = kBig, mx = -kBig;
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

constexpr int kThreads = 256;

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
}

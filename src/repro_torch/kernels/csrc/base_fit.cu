// Per-block least-squares line of the tensor codec for Hopper, sm_90a.
//
// Replaces linear_base_fit of repro/core/jaxshrink.py, which XLA compiles
// from a float32 matrix-vector product and a mean (no Pallas kernel).  For
// xb[M, K] (float32, row-major), tc[j] = j - (K - 1) / 2 and denom = sum
// tc^2 (given by the caller):
//   slope = dot(xb[m], tc) / denom
//   theta = sum(xb[m]) * (1 / K) - slope * (K - 1) / 2
// summed in the order of the plain version (kernels/base_fit.py), which is
// XLA's CPU order, so the two agree bit for bit:
// * the dot: 8 accumulators, accumulator j taking columns j, j + 8, ...
//   below K - K % 8 by fused multiply-add (fmaf: one rounding); then
//   ((a0 + a1) + (a2 + a3)) + ((a4 + a5) + (a6 + a7)) for rows in whole
//   tiles of 8 (m < M - M % 8) and ((a0 + a4) + (a2 + a6)) + ((a1 + a5) +
//   (a3 + a7)) for the last M % 8 rows; the K % 8 tail columns take their
//   own fmaf chain, added last;
// * the sum: K <= 32 is one chain from 0.0; otherwise the row, zero-padded
//   evenly at both ends to a multiple of 32, is cut into windows of 32,
//   each summed in a chain from 0.0, and the window sums are summed in a
//   chain from 0.0 (K <= 1024, so at most 32 windows).  The padding zeros
//   are added too: 0.0 turns a -0.0 sum into +0.0.
// Every other multiply, add and the division are explicit round-to-nearest
// intrinsics, which nvcc never contracts (and the build passes
// --fmad=false); the only FMAs are the dot's, written as fmaf.
//
// Bound on the card: 4 bytes read per element and 8 written per row
// against ~3 float operations per element: memory bytes bound it.  One
// thread owns a row and reads it once, 8 columns at a time (two 16-byte
// loads when K % 8 == 0 and the base is aligned); the 8 dot accumulators,
// the window sum and the running total sit in registers.
#include <cuda_runtime.h>
#include <stdint.h>

struct SumState {
  float win;  // the open window's chain
  float tot;  // the chain of closed windows
};

// add x at padded position p (position in the row + the left padding)
__device__ __forceinline__ void add_sum(SumState& s, float x, int p) {
  if (p != 0 && (p & 31) == 0) {
    s.tot = __fadd_rn(s.tot, s.win);
    s.win = 0.0f;
  }
  s.win = __fadd_rn(s.win, x);
}

template <bool VEC>
__global__ void base_fit_kernel(const float* __restrict__ xb, int64_t m, int k, float denom,
                                float inv_k, float t_mean, float* __restrict__ theta,
                                float* __restrict__ slope) {
  const int k8 = k - k % 8;
  const int padding = k > 32 ? ((k + 31) / 32) * 32 - k : 0;
  const int left = padding / 2;
  const int64_t full = m - m % 8;
  for (int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; row < m;
       row += (int64_t)gridDim.x * blockDim.x) {
    const float* x = xb + (size_t)row * k;
    float acc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = 0.0f;
    SumState s{0.0f, 0.0f};
    for (int c = 0; c < k8; c += 8) {
      float v[8];
      if (VEC) {
        const float4 lo = __ldg(reinterpret_cast<const float4*>(x + c));
        const float4 hi = __ldg(reinterpret_cast<const float4*>(x + c + 4));
        v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
        v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = __ldg(x + c + j);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float tc = __fsub_rn((float)(c + j), t_mean);  // exact half-integer
        acc[j] = fmaf(v[j], tc, acc[j]);
        add_sum(s, v[j], c + j + left);
      }
    }
    float tail = 0.0f;
    for (int c = k8; c < k; ++c) {
      const float v = __ldg(x + c);
      tail = fmaf(v, __fsub_rn((float)c, t_mean), tail);
      add_sum(s, v, c + left);
    }
    float dot;
    if (row < full)
      dot = __fadd_rn(__fadd_rn(__fadd_rn(acc[0], acc[1]), __fadd_rn(acc[2], acc[3])),
                      __fadd_rn(__fadd_rn(acc[4], acc[5]), __fadd_rn(acc[6], acc[7])));
    else
      dot = __fadd_rn(__fadd_rn(__fadd_rn(acc[0], acc[4]), __fadd_rn(acc[2], acc[6])),
                      __fadd_rn(__fadd_rn(acc[1], acc[5]), __fadd_rn(acc[3], acc[7])));
    if (k8 < k) dot = __fadd_rn(dot, tail);
    float sum = s.win;
    if (k > 32) {
      if (padding - left > 0) s.win = __fadd_rn(s.win, 0.0f);  // the right padding
      sum = __fadd_rn(s.tot, s.win);
    }
    const float sl = __fdiv_rn(dot, denom);
    slope[row] = sl;
    theta[row] = __fsub_rn(__fmul_rn(sum, inv_k), __fmul_rn(sl, t_mean));
  }
}

extern "C" {
int base_fit(const float* xb, int64_t m, int k, float denom, float inv_k, float t_mean,
             float* theta, float* slope, cudaStream_t stream) {
  if (k < 1 || k > 1024) return (int)cudaErrorInvalidValue;
  const bool vec = k % 8 == 0 && (uintptr_t)xb % 16 == 0;
  const int threads = 128;
  int64_t blocks = (m + threads - 1) / threads;
  if (blocks > 132 * 64) blocks = 132 * 64;
  if (blocks < 1) blocks = 1;
  if (vec)
    base_fit_kernel<true><<<(unsigned)blocks, threads, 0, stream>>>(xb, m, k, denom, inv_k,
                                                                    t_mean, theta, slope);
  else
    base_fit_kernel<false><<<(unsigned)blocks, threads, 0, stream>>>(xb, m, k, denom, inv_k,
                                                                     t_mean, theta, slope);
  return (int)cudaGetLastError();
}
}

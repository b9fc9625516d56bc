// Fused multi-layer refinement quantization (the residual ladder) for
// Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/residual_quant.py:
//   pyramid_quant  <- pyramid_quant_kernel / pyramid_quant_pallas
// For x[M, N] (float32 or float64, row-major), per-row theta, slope [M] of
// x's type and steps[L] (coarse to fine, x's type):
//   pred = theta + slope * t            (t = the float of the in-row index)
//   e    = x - pred
//   for l in 0..L-1:
//     q_l = clip(round_half_even(e / steps[l]), -qmax, qmax);  e = e - q_l * steps[l]
//   qs[l, m, n] = q_l (int32);  err[m, n] = e
// with ragged rows masked: positions t >= lengths[m] give q = 0 on every
// layer and err = +0.0.  Inputs are finite (the clip of a NaN is not the
// reference's).
//
// Exactness rules (the plain torch version computes the same floats):
// * the Pallas kernel's order, not its oracle's;
// * e / steps[l] is an IEEE division (__fdiv_rn / __ddiv_rn), as in the
//   Pallas kernel and its oracle; no reciprocal;
// * round half to even: rintf / rint, as jnp.round and torch.round;
// * no FMA: every multiply and add is an explicit round-to-nearest
//   intrinsic, on top of --fmad=false in the build.
//
// Bound on the card: per element sizeof(T) bytes read and L int32 + one T
// written (the L int32 stores are most of the bytes) against ~6 operations
// a layer, so memory bytes bound it.  The TPU kernel kept the running
// error in VMEM across a static layer loop; here it stays in registers:
// L comes at run time (steps in a small device array, read through the
// cache), a warp owns a row stretch, each thread moves 16 bytes of x (4
// float32 or 2 float64) with one vector load and writes each layer's
// int32s with one vector store, and blocks walk the rows grid-stride.
#include <cuda_runtime.h>
#include <stdint.h>

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float round_even(float a) { return rintf(a); }
__device__ __forceinline__ double round_even(double a) { return rint(a); }
__device__ __forceinline__ float clip(float a, float c) { return fminf(fmaxf(a, -c), c); }
__device__ __forceinline__ double clip(double a, double c) { return fmin(fmax(a, -c), c); }

template <typename T, int V>
__global__ void pyramid_quant_kernel(const T* __restrict__ x, const T* __restrict__ theta,
                                     const T* __restrict__ slope, const T* __restrict__ steps,
                                     int layers, const int32_t* __restrict__ lengths, int64_t m,
                                     int n, int qmax, int32_t* __restrict__ qs,
                                     T* __restrict__ err) {
  const int nv = n / V;
  const T fq = (T)qmax;
  const size_t plane = (size_t)m * n;
  for (int64_t row = (int64_t)blockIdx.x * blockDim.y + threadIdx.y; row < m;
       row += (int64_t)gridDim.x * blockDim.y) {
    const T th = theta[row];
    const T sl = slope[row];
    const int len = lengths ? lengths[row] : n;
    const size_t base = (size_t)row * n;
    for (int c = threadIdx.x; c < nv; c += blockDim.x) {
      const Vec<T, V> xv = reinterpret_cast<const Vec<T, V>*>(x + base)[c];
      T e[V];
      bool ok[V];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int t = c * V + j;
        e[j] = sub_rn(xv.v[j], add_rn(th, mul_rn(sl, (T)t)));
        ok[j] = t < len;
      }
      for (int l = 0; l < layers; ++l) {
        const T st = steps[l];
        Vec<int32_t, V> qv;
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const T qf = clip(round_even(div_rn(e[j], st)), fq);
          e[j] = sub_rn(e[j], mul_rn(qf, st));
          qv.v[j] = ok[j] ? (int32_t)qf : 0;
        }
        reinterpret_cast<Vec<int32_t, V>*>(qs + l * plane + base)[c] = qv;
      }
      Vec<T, V> ev;
#pragma unroll
      for (int j = 0; j < V; ++j) ev.v[j] = ok[j] ? e[j] : (T)0;
      reinterpret_cast<Vec<T, V>*>(err + base)[c] = ev;
    }
  }
}

template <typename T>
static int launch(const T* x, const T* theta, const T* slope, const T* steps, int layers,
                  const int32_t* lengths, int64_t m, int n, int qmax, int32_t* qs, T* err,
                  cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  // vectors need every row start aligned: n % V == 0 and aligned bases
  const bool vec = n % V == 0 && (uintptr_t)x % 16 == 0 && (uintptr_t)err % 16 == 0 &&
                   (uintptr_t)qs % (4 * V) == 0;
  const int nv = vec ? n / V : n;
  int tx = 32;
  while (tx < nv && tx < 256) tx *= 2;
  const dim3 block(tx, 256 / tx);
  int64_t blocks = (m + block.y - 1) / block.y;
  if (blocks > 132 * 32) blocks = 132 * 32;
  if (blocks < 1) blocks = 1;
  if (vec)
    pyramid_quant_kernel<T, V><<<(unsigned)blocks, block, 0, stream>>>(
        x, theta, slope, steps, layers, lengths, m, n, qmax, qs, err);
  else
    pyramid_quant_kernel<T, 1><<<(unsigned)blocks, block, 0, stream>>>(
        x, theta, slope, steps, layers, lengths, m, n, qmax, qs, err);
  return (int)cudaGetLastError();
}

extern "C" {
int pyramid_quant_f32(const float* x, const float* theta, const float* slope, const float* steps,
                      int layers, const int32_t* lengths, int64_t m, int n, int qmax, int32_t* qs,
                      float* err, cudaStream_t stream) {
  return launch<float>(x, theta, slope, steps, layers, lengths, m, n, qmax, qs, err, stream);
}
int pyramid_quant_f64(const double* x, const double* theta, const double* slope,
                      const double* steps, int layers, const int32_t* lengths, int64_t m, int n,
                      int qmax, int32_t* qs, double* err, cudaStream_t stream) {
  return launch<double>(x, theta, slope, steps, layers, lengths, m, n, qmax, qs, err, stream);
}
}

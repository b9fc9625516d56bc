// Fused reconstruction from a layer prefix of the residual ladder for
// Hopper, sm_90a: the inverse of pyramid_quant.cu.
//
// Replaces the Pallas TPU kernel repro/kernels/dequant.py:
//   pyramid_reconstruct  <- pyramid_reconstruct_kernel / pyramid_reconstruct_pallas
// For qs[L, M, N] (int32, contiguous: a prefix qs[:k+1] of a contiguous
// stack is one too), per-row theta, slope [M] (float32 or float64) and
// steps[L] of theta's type:
//   acc = theta + slope * t             (t = the float of the in-row index)
//   for l in 0..L-1:  acc = acc + float(qs[l]) * steps[l]
//   out = acc                           (theta's type, [M, N])
//
// Exactness: the Pallas kernel's order (its oracle sums the layers first
// and adds pred last, which rounds differently); every product and sum is
// an explicit round-to-nearest intrinsic, never fused into an FMA, as in
// the plain torch version.
//
// Bound on the card: L int32 bytes read and sizeof(T) written per element
// against 2 + 2L operations, so memory bytes bound it.  Same layout as
// pyramid_quant.cu: a warp over a row stretch, each thread 16 bytes of
// output (4 float32 or 2 float64) and one vector load of each layer's
// int32s, the row's scalars in registers, blocks grid-stride over the rows.
#include <cuda_runtime.h>
#include <stdint.h>

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

template <typename T, int V>
__global__ void pyramid_reconstruct_kernel(const int32_t* __restrict__ qs,
                                           const T* __restrict__ theta,
                                           const T* __restrict__ slope,
                                           const T* __restrict__ steps, int layers, int64_t m,
                                           int n, T* __restrict__ out) {
  const int nv = n / V;
  const size_t plane = (size_t)m * n;
  for (int64_t row = (int64_t)blockIdx.x * blockDim.y + threadIdx.y; row < m;
       row += (int64_t)gridDim.x * blockDim.y) {
    const T th = theta[row];
    const T sl = slope[row];
    const size_t base = (size_t)row * n;
    for (int c = threadIdx.x; c < nv; c += blockDim.x) {
      T acc[V];
#pragma unroll
      for (int j = 0; j < V; ++j) acc[j] = add_rn(th, mul_rn(sl, (T)(c * V + j)));
      for (int l = 0; l < layers; ++l) {
        const T st = steps[l];
        const Vec<int32_t, V> qv =
            reinterpret_cast<const Vec<int32_t, V>*>(qs + l * plane + base)[c];
#pragma unroll
        for (int j = 0; j < V; ++j) acc[j] = add_rn(acc[j], mul_rn((T)qv.v[j], st));
      }
      Vec<T, V> ov;
#pragma unroll
      for (int j = 0; j < V; ++j) ov.v[j] = acc[j];
      reinterpret_cast<Vec<T, V>*>(out + base)[c] = ov;
    }
  }
}

template <typename T>
static int launch(const int32_t* qs, const T* theta, const T* slope, const T* steps, int layers,
                  int64_t m, int n, T* out, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  // vectors need every row start aligned: n % V == 0 and aligned bases
  const bool vec = n % V == 0 && (uintptr_t)out % 16 == 0 && (uintptr_t)qs % (4 * V) == 0;
  const int nv = vec ? n / V : n;
  int tx = 32;
  while (tx < nv && tx < 256) tx *= 2;
  const dim3 block(tx, 256 / tx);
  int64_t blocks = (m + block.y - 1) / block.y;
  if (blocks > 132 * 32) blocks = 132 * 32;
  if (blocks < 1) blocks = 1;
  if (vec)
    pyramid_reconstruct_kernel<T, V><<<(unsigned)blocks, block, 0, stream>>>(
        qs, theta, slope, steps, layers, m, n, out);
  else
    pyramid_reconstruct_kernel<T, 1><<<(unsigned)blocks, block, 0, stream>>>(
        qs, theta, slope, steps, layers, m, n, out);
  return (int)cudaGetLastError();
}

extern "C" {
int pyramid_reconstruct_f32(const int32_t* qs, const float* theta, const float* slope,
                            const float* steps, int layers, int64_t m, int n, float* out,
                            cudaStream_t stream) {
  return launch<float>(qs, theta, slope, steps, layers, m, n, out, stream);
}
int pyramid_reconstruct_f64(const int32_t* qs, const double* theta, const double* slope,
                            const double* steps, int layers, int64_t m, int n, double* out,
                            cudaStream_t stream) {
  return launch<double>(qs, theta, slope, steps, layers, m, n, out, stream);
}
}

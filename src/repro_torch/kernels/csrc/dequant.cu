// Fused dequantize + reconstruct of the tensor codec for Hopper, sm_90a:
// the inverse of residual_quant.cu.
//
// Replaces the Pallas TPU kernel repro/kernels/dequant.py:
//   dequant  <- dequant_kernel / dequant_reconstruct_pallas
// For q[M, N] (int8, int16 or int32: the wire type, read as is) and
// per-row float32 theta, slope, step [M]:
//   x_hat = (theta + slope * t) + q * step      (t = the float of the index)
//
// Exactness: the two products and two sums are explicit round-to-nearest
// intrinsics (__fmul_rn, __fadd_rn), never fused into an FMA, in the order
// of the Pallas kernel and of the plain torch version.
//
// Bound on the card: sizeof(q) bytes read and 4 written per element
// against 4 float operations, so memory bytes bound it.  Same layout as
// residual_quant.cu: a warp over a row stretch, 4 consecutive elements a
// thread (one vector load of q, one 16-byte store), the row's scalars in
// registers, blocks grid-stride over the rows.
#include <cuda_runtime.h>
#include <stdint.h>

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

template <typename QT, int V>
__global__ void dequant_kernel(const QT* __restrict__ q, const float* __restrict__ theta,
                               const float* __restrict__ slope,
                               const float* __restrict__ step, int64_t m, int n,
                               float* __restrict__ out) {
  const int nv = n / V;
  for (int64_t row = (int64_t)blockIdx.x * blockDim.y + threadIdx.y; row < m;
       row += (int64_t)gridDim.x * blockDim.y) {
    const float th = theta[row];
    const float sl = slope[row];
    const float st = step[row];
    const size_t base = (size_t)row * n;
    for (int c = threadIdx.x; c < nv; c += blockDim.x) {
      const Vec<QT, V> qv = reinterpret_cast<const Vec<QT, V>*>(q + base)[c];
      Vec<float, V> ov;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float pred = __fadd_rn(th, __fmul_rn(sl, (float)(c * V + j)));
        ov.v[j] = __fadd_rn(pred, __fmul_rn((float)qv.v[j], st));
      }
      reinterpret_cast<Vec<float, V>*>(out + base)[c] = ov;
    }
  }
}

template <typename QT>
static int launch(const QT* q, const float* theta, const float* slope, const float* step,
                  int64_t m, int n, float* out, cudaStream_t stream) {
  // 4-wide vectors need every row start aligned: n % 4 == 0 and aligned bases
  const bool vec = n % 4 == 0 && (uintptr_t)out % 16 == 0 &&
                   (uintptr_t)q % (4 * sizeof(QT)) == 0;
  const int nv = vec ? n / 4 : n;
  int tx = 32;
  while (tx < nv && tx < 256) tx *= 2;
  const dim3 block(tx, 256 / tx);
  int64_t blocks = (m + block.y - 1) / block.y;
  if (blocks > 132 * 32) blocks = 132 * 32;
  if (blocks < 1) blocks = 1;
  if (vec)
    dequant_kernel<QT, 4><<<(unsigned)blocks, block, 0, stream>>>(q, theta, slope, step, m, n,
                                                                  out);
  else
    dequant_kernel<QT, 1><<<(unsigned)blocks, block, 0, stream>>>(q, theta, slope, step, m, n,
                                                                  out);
  return (int)cudaGetLastError();
}

extern "C" {
int dequant_i8(const int8_t* q, const float* theta, const float* slope, const float* step,
               int64_t m, int n, float* out, cudaStream_t stream) {
  return launch<int8_t>(q, theta, slope, step, m, n, out, stream);
}
int dequant_i16(const int16_t* q, const float* theta, const float* slope, const float* step,
                int64_t m, int n, float* out, cudaStream_t stream) {
  return launch<int16_t>(q, theta, slope, step, m, n, out, stream);
}
int dequant_i32(const int32_t* q, const float* theta, const float* slope, const float* step,
                int64_t m, int n, float* out, cudaStream_t stream) {
  return launch<int32_t>(q, theta, slope, step, m, n, out, stream);
}
}

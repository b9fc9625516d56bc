// Fused residual quantization of the tensor codec for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/residual_quant.py:
//   residual_quant  <- residual_quant_kernel / residual_quant_pallas
// For x[M, N] (float32, row-major) and per-row theta, slope, step [M]:
//   pred = theta + slope * t          (t = the float of the in-row index)
//   r    = x - pred
//   q    = clip(round_half_even(r * (1 / step)), -qmax, qmax)
//   err  = r - q * step
// with ragged rows masked: positions t >= lengths[m] give q = 0, err = 0.
// q is written in the wire type (int8, int16 or int32), which folds the
// codec's cast into the kernel.
//
// Exactness rules (the plain torch version computes the same floats):
// * round half to even: rintf, as jnp.round and torch.round; roundf would
//   round halves away from zero;
// * the reciprocal is formed first and multiplied, r * (1 / step), as the
//   Pallas kernel does (its jnp oracle divides, r / step); 1 / step is an
//   IEEE division (__fdiv_rn), never __fdividef or fast math;
// * no FMA: every multiply and add is an explicit round-to-nearest
//   intrinsic (__fmul_rn, __fadd_rn, __fsub_rn), which nvcc never
//   contracts, on top of --fmad=false in the build.
//
// Bound on the card: per element 4 bytes read and 4 + sizeof(q) written
// against ~10 float operations, so memory bytes bound it by far.  The TPU
// kernel tiled (8, N) row blocks through VMEM; here a warp owns a row
// stretch and each thread moves 4 consecutive elements with one 16-byte
// load and vector stores (when N % 4 == 0 and the bases are aligned;
// otherwise 1 element), the row's four scalars sit in registers, and
// blocks walk the rows grid-stride so the column index needs no integer
// division.
#include <cuda_runtime.h>
#include <stdint.h>

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

template <typename QT, int V>
__global__ void residual_quant_kernel(const float* __restrict__ x,
                                      const float* __restrict__ theta,
                                      const float* __restrict__ slope,
                                      const float* __restrict__ step,
                                      const int32_t* __restrict__ lengths, int64_t m, int n,
                                      int qmax, QT* __restrict__ q, float* __restrict__ err) {
  const int nv = n / V;
  const float fq = (float)qmax;
  for (int64_t row = (int64_t)blockIdx.x * blockDim.y + threadIdx.y; row < m;
       row += (int64_t)gridDim.x * blockDim.y) {
    const float th = theta[row];
    const float sl = slope[row];
    const float st = step[row];
    const float inv = __fdiv_rn(1.0f, st);
    const int len = lengths ? lengths[row] : n;
    const size_t base = (size_t)row * n;
    for (int c = threadIdx.x; c < nv; c += blockDim.x) {
      const Vec<float, V> xv = reinterpret_cast<const Vec<float, V>*>(x + base)[c];
      Vec<QT, V> qv;
      Vec<float, V> ev;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int t = c * V + j;
        const float pred = __fadd_rn(th, __fmul_rn(sl, (float)t));
        const float r = __fsub_rn(xv.v[j], pred);
        const float qf = fminf(fmaxf(rintf(__fmul_rn(r, inv)), -fq), fq);
        const bool ok = t < len;
        qv.v[j] = ok ? (QT)qf : (QT)0;
        ev.v[j] = ok ? __fsub_rn(r, __fmul_rn(qf, st)) : 0.0f;
      }
      reinterpret_cast<Vec<QT, V>*>(q + base)[c] = qv;
      reinterpret_cast<Vec<float, V>*>(err + base)[c] = ev;
    }
  }
}

template <typename QT>
static int launch(const float* x, const float* theta, const float* slope, const float* step,
                  const int32_t* lengths, int64_t m, int n, int qmax, QT* q, float* err,
                  cudaStream_t stream) {
  // 4-wide vectors need every row start aligned: n % 4 == 0 and aligned bases
  const bool vec = n % 4 == 0 && (uintptr_t)x % 16 == 0 && (uintptr_t)err % 16 == 0 &&
                   (uintptr_t)q % (4 * sizeof(QT)) == 0;
  const int nv = vec ? n / 4 : n;
  int tx = 32;
  while (tx < nv && tx < 256) tx *= 2;
  const dim3 block(tx, 256 / tx);
  int64_t blocks = (m + block.y - 1) / block.y;
  if (blocks > 132 * 32) blocks = 132 * 32;
  if (blocks < 1) blocks = 1;
  if (vec)
    residual_quant_kernel<QT, 4><<<(unsigned)blocks, block, 0, stream>>>(
        x, theta, slope, step, lengths, m, n, qmax, q, err);
  else
    residual_quant_kernel<QT, 1><<<(unsigned)blocks, block, 0, stream>>>(
        x, theta, slope, step, lengths, m, n, qmax, q, err);
  return (int)cudaGetLastError();
}

extern "C" {
int residual_quant_i8(const float* x, const float* theta, const float* slope, const float* step,
                      const int32_t* lengths, int64_t m, int n, int qmax, int8_t* q, float* err,
                      cudaStream_t stream) {
  return launch<int8_t>(x, theta, slope, step, lengths, m, n, qmax, q, err, stream);
}
int residual_quant_i16(const float* x, const float* theta, const float* slope,
                       const float* step, const int32_t* lengths, int64_t m, int n, int qmax,
                       int16_t* q, float* err, cudaStream_t stream) {
  return launch<int16_t>(x, theta, slope, step, lengths, m, n, qmax, q, err, stream);
}
int residual_quant_i32(const float* x, const float* theta, const float* slope,
                       const float* step, const int32_t* lengths, int64_t m, int n, int qmax,
                       int32_t* q, float* err, cudaStream_t stream) {
  return launch<int32_t>(x, theta, slope, step, lengths, m, n, qmax, q, err, stream);
}
}

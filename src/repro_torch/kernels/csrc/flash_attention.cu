// Causal (or full) softmax attention with an online softmax, for Hopper,
// sm_90a: the prefill and forward attention of the dense models.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py:
//   flash_attention  <- _flash_kernel / flash_attention_pallas
// For q [B, Sq, H, D] and k, v [B, Sk, KV, D] (float32 or bf16, the
// models' own layout; query head h reads KV head h / (H / KV), so grouped
// queries need no repeat of K and V in memory):
//   out = softmax(q k^T * scale, causal: kpos <= qpos) v      (in q's type)
// with the semantics of the Pallas kernel: the running max m, the running
// sum l and the accumulator in float32; masked scores are -1e30; KV tiles
// wholly past the diagonal are skipped; the output is acc / max(l, 1e-30).
// Sq and Sk need not be multiples of a tile: the kernel masks the tails.
//
// Design (simple and right first): one block of 256 threads per
// (q tile of 64 rows, head, batch).  The Q tile and each K and V tile of 64
// keys sit in shared memory as float32 (Q and K rows padded to an odd
// stride, so the column walks hit distinct banks); each thread owns a 4 x 4
// block of the score tile (rows ty + 16i, keys tx + 16j) and the matching
// 4 rows x NJ columns (tx + 16j) of the accumulator in registers.  Row
// maxima and sums reduce over the 16 lanes of a row with shuffles.  Scalar
// float32 arithmetic on the CUDA cores, products and sums kept apart
// (--fmad=false): the bound is the tensor cores' bf16 rate on the
// causal FLOPs, which this kernel does not approach; wgmma and TMA are
// later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;  // q rows a block (must equal BK: see the mask note)
constexpr int BK = 64;  // keys a tile
constexpr int THREADS = 256;
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Every row of a processed tile has at least one unmasked key: tile 0 holds
// key 0, and with BQ == BK the last tile a block reads starts at its first
// row.  So m is a real score after the first tile and no row ends with l = 0.
template <typename T, int NJ>
__global__ void __launch_bounds__(THREADS)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, int sq, int sk, int h, int kvh, int d, float scale,
                 int causal) {
  extern __shared__ float smem[];
  const int ld = d + 1;  // d is even, so the stride is odd
  float* qs = smem;             // [BQ][ld]
  float* ks = qs + BQ * ld;     // [BK][ld]
  float* vs = ks + BK * ld;     // [BK][d]
  float* ps = vs + BK * d;      // [BQ][BK + 1]
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * BQ;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const size_t qrow = (size_t)h * d;    // elements between positions of q and o
  const size_t krow = (size_t)kvh * d;  // ... of k and v
  const T* qb = q + (size_t)b * sq * qrow + (size_t)head * d;
  const T* kb = k + (size_t)b * sk * krow + (size_t)(head / (h / kvh)) * d;
  const T* vb = v + (size_t)b * sk * krow + (size_t)(head / (h / kvh)) * d;
  T* ob = o + (size_t)b * sq * qrow + (size_t)head * d;

  for (int idx = threadIdx.x; idx < BQ * d; idx += THREADS) {
    const int r = idx / d, c = idx - r * d;
    qs[r * ld + c] = q0 + r < sq ? to_f(qb[(size_t)(q0 + r) * qrow + c]) : 0.f;
  }
  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }
  const int kv_end = causal ? min(sk, q0 + BQ) : sk;  // skip tiles past the diagonal
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();  // the last tile's K, V and P reads are done
    for (int idx = threadIdx.x; idx < BK * d; idx += THREADS) {
      const int r = idx / d, c = idx - r * d;
      const bool in = k0 + r < sk;
      ks[r * ld + c] = in ? to_f(kb[(size_t)(k0 + r) * krow + c]) : 0.f;
      vs[r * d + c] = in ? to_f(vb[(size_t)(k0 + r) * krow + c]) : 0.f;
    }
    __syncthreads();
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int c = 0; c < d; ++c) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * ld + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = ks[(tx + 16 * j) * ld + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = s[i][j] + a[i] * bk[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float rmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (causal && kpos > qpos) x = NEG;
        if (kpos >= sk) x = -INFINITY;  // past the keys: no weight at all
        s[i][j] = x;
        rmax = fmaxf(rmax, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_new = fmaxf(m[i], rmax);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        rsum = rsum + p;
        ps[(ty + 16 * i) * (BK + 1) + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rsum = rsum + __shfl_xor_sync(0xffffffffu, rsum, off);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + rsum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = acc[i][j] * alpha;
    }
    __syncthreads();
    const int kn = min(BK, sk - k0);
    for (int c = 0; c < kn; ++c) {
      float pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = ps[(ty + 16 * i) * (BK + 1) + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = tx + 16 * j;
        if (col < d) {
          const float vv = vs[c * d + col];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = acc[i][j] + pr[i] * vv;
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = tx + 16 * j;
      if (col < d) ob[(size_t)qpos * qrow + col] = from_f<T>(acc[i][j] / den);
    }
  }
}

template <typename T, int NJ>
int run(const T* q, const T* k, const T* v, T* o, int b, int sq, int sk, int h, int kvh, int d,
        float scale, int causal, cudaStream_t stream) {
  const size_t smem = ((size_t)(BQ + BK) * (d + 1) + (size_t)BK * d + (size_t)BQ * (BK + 1)) *
                      sizeof(float);
  // above 48 KB a block's dynamic shared memory must be asked for
  cudaError_t e = cudaFuncSetAttribute(flash_kernel<T, NJ>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((sq + BQ - 1) / BQ, h, b);
  flash_kernel<T, NJ><<<grid, THREADS, smem, stream>>>(q, k, v, o, sq, sk, h, kvh, d, scale,
                                                       causal);
  return (int)cudaGetLastError();
}

// NJ = accumulator columns a thread: the head dim over 16, rounded up to
// an instantiated width (16, 32, 64, 128, 160 and 256 are exact).
template <typename T>
int launch(const T* q, const T* k, const T* v, T* o, int b, int sq, int sk, int h, int kvh,
           int d, float scale, int causal, cudaStream_t stream) {
  if (d <= 0 || d > 256 || d % 2 || kvh <= 0 || h % kvh) return (int)cudaErrorInvalidValue;
  const int nj = (d + 15) / 16;
  if (nj <= 1) return run<T, 1>(q, k, v, o, b, sq, sk, h, kvh, d, scale, causal, stream);
  if (nj <= 2) return run<T, 2>(q, k, v, o, b, sq, sk, h, kvh, d, scale, causal, stream);
  if (nj <= 4) return run<T, 4>(q, k, v, o, b, sq, sk, h, kvh, d, scale, causal, stream);
  if (nj <= 8) return run<T, 8>(q, k, v, o, b, sq, sk, h, kvh, d, scale, causal, stream);
  if (nj <= 10) return run<T, 10>(q, k, v, o, b, sq, sk, h, kvh, d, scale, causal, stream);
  return run<T, 16>(q, k, v, o, b, sq, sk, h, kvh, d, scale, causal, stream);
}

}  // namespace

extern "C" {
int flash_attention_f32(const float* q, const float* k, const float* v, float* o, int b, int sq,
                        int sk, int h, int kvh, int d, float scale, int causal,
                        cudaStream_t stream) {
  return launch<float>(q, k, v, o, b, sq, sk, h, kvh, d, scale, causal, stream);
}
int flash_attention_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                         __nv_bfloat16* o, int b, int sq, int sk, int h, int kvh, int d,
                         float scale, int causal, cudaStream_t stream) {
  return launch<__nv_bfloat16>(q, k, v, o, b, sq, sk, h, kvh, d, scale, causal, stream);
}
}

// The backward pass of csrc/flash_attention.cu, for Hopper, sm_90a: the
// gradients dq, dk and dv of
//   out = softmax(q k^T * scale, causal: kpos <= qpos) v
// for q [B, Sq, H, D] and k, v [B, Sk, KV, D] (bf16 or float32; query head
// h reads KV head h / (H / KV)), given out and its gradient dout.
//
// Not a TPU kernel: the reference differentiates XLA's attention ops (its
// models never train through the Pallas kernel repro/kernels/
// flash_attention.py, which has no backward).  The port's training route
// runs the forward kernel, so its gradient needs this one.  Its oracle is
// torch.autograd.grad through flash_attention_plain.
//
// What bounds it: five products over the causal pairs (q k^T again, dout
// v^T, p^T dout, ds^T q, ds k), 10 x B x H x D x pairs operations against
// q, k, v, out, dout read once and dq, dk, dv written once: the tensor
// cores' bf16 rate.  This first kernel stays on the CUDA cores in float32
// (explicit fmaf; the build's --fmad=false only stops contraction), so it
// runs far from that bound: a tensor-core (wgmma, TMA) version is a later
// redesign.
//
// Two launches, each output written by one block in one order, with no
// atomics, so a gradient has one summation order and is the same bits on
// every run:
// * dq_kernel, one block per (q tile, head, batch), the longest causal
//   rows first.  Its first pass over the key tiles recomputes each row's
//   max m and sum l (the forward's online softmax) and lse = m + log l; it
//   also forms delta = sum_c dout * out over the row.  Its second pass
//   recomputes p = exp(s - lse), dp = dout v^T, ds = p (dp - delta), and
//   accumulates dq += ds k.  It writes dq, and lse and delta [B, H, Sq]
//   for the second launch.
// * dkdv_kernel, one block per (key tile, KV head, batch).  It loops over
//   the query heads of its group and, for each, the query tiles that see
//   its keys, in order: dv += p^T dout, dk += ds^T q.
// Tiles of TILE rows sit in shared memory as float32 rows of stride d + 1
// (odd, so a column walk hits 32 banks); 256 threads, each owning a
// (TILE / 16) x (TILE / 16) block of the score tile and TILE / 16 rows x
// NJ columns of the accumulators.  TILE = 64 for D <= 128, 32 above (the
// shared memory of D = 256).  Masked scores are -1e30 as in the forward,
// keys past Sk have no weight, query rows past Sq none either.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

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

// rows [r0, r0 + TILE) of one head of x [.., S, heads, D] into s [TILE][ld]
template <typename T, int TILE>
__device__ __forceinline__ void load_tile(float* s, const T* x, int r0, int n, size_t row, int d,
                                          int ld) {
  for (int idx = threadIdx.x; idx < TILE * d; idx += THREADS) {
    const int r = idx / d, c = idx - r * d;
    s[r * ld + c] = r0 + r < n ? to_f(x[(size_t)(r0 + r) * row + c]) : 0.f;
  }
}

template <typename T, int TILE, int NJ>
__global__ void __launch_bounds__(THREADS)
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const T* __restrict__ o, const T* __restrict__ dout, T* __restrict__ dq,
              float* __restrict__ lse_out, float* __restrict__ delta_out, int sq, int sk, int h,
              int kvh, int d, float scale, int causal) {
  constexpr int R = TILE / 16;
  extern __shared__ float smem[];
  const int ld = d + 1;
  float* qs = smem;               // [TILE][ld]
  float* dos = qs + TILE * ld;    // [TILE][ld]
  float* ks = dos + TILE * ld;    // [TILE][ld]
  float* vs = ks + TILE * ld;     // [TILE][ld]
  float* ds = vs + TILE * ld;     // [TILE][TILE + 1]
  float* lse = ds + TILE * (TILE + 1);  // [TILE]
  float* delta = lse + TILE;            // [TILE]
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * TILE;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const size_t qrow = (size_t)h * d;
  const size_t krow = (size_t)kvh * d;
  const size_t qoff = (size_t)b * sq * qrow + (size_t)head * d;
  const size_t koff = (size_t)b * sk * krow + (size_t)(head / (h / kvh)) * d;

  load_tile<T, TILE>(qs, q + qoff, q0, sq, qrow, d, ld);
  load_tile<T, TILE>(dos, dout + qoff, q0, sq, qrow, d, ld);
  __syncthreads();
  // delta: one warp a row, lanes over the columns, then a shuffle sum
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < TILE; r += THREADS / 32) {
    float acc = 0.f;
    if (q0 + r < sq) {
      const T* orow = o + qoff + (size_t)(q0 + r) * qrow;
      for (int c = lane; c < d; c += 32) acc = fmaf(dos[r * ld + c], to_f(orow[c]), acc);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) delta[r] = acc;
  }

  const int kv_end = causal ? min(sk, q0 + TILE) : sk;  // tiles past the diagonal hold no weight
  // pass 1: each row's max and sum, as the forward's online softmax
  float m[R], l[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
  }
  for (int k0 = 0; k0 < kv_end; k0 += TILE) {
    __syncthreads();
    load_tile<T, TILE>(ks, k + koff, k0, sk, krow, d, ld);
    __syncthreads();
    float s[R][R];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) s[i][j] = 0.f;
    for (int c = 0; c < d; ++c) {
      float a[R], bk[R];
#pragma unroll
      for (int i = 0; i < R; ++i) a[i] = qs[(ty + 16 * i) * ld + c];
#pragma unroll
      for (int j = 0; j < R; ++j) bk[j] = ks[(tx + 16 * j) * ld + c];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float rmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (causal && kpos > qpos) x = NEG;
        if (kpos >= sk) x = -INFINITY;
        s[i][j] = x;
        rmax = fmaxf(rmax, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_new = fmaxf(m[i], rmax);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < R; ++j) rsum += expf(s[i][j] - m_new);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      l[i] = l[i] * expf(m[i] - m_new) + rsum;
      m[i] = m_new;
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < R; ++i) lse[ty + 16 * i] = m[i] + logf(fmaxf(l[i], 1e-30f));
  }

  // pass 2: p, dp, ds and dq += ds k
  float acc[R][NJ];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < kv_end; k0 += TILE) {
    __syncthreads();  // the last tile's ds and k reads are done (and lse is written)
    load_tile<T, TILE>(ks, k + koff, k0, sk, krow, d, ld);
    load_tile<T, TILE>(vs, v + koff, k0, sk, krow, d, ld);
    __syncthreads();
    float s[R][R], dp[R][R];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int c = 0; c < d; ++c) {
      float a[R], g[R], bk[R], bv[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        a[i] = qs[(ty + 16 * i) * ld + c];
        g[i] = dos[(ty + 16 * i) * ld + c];
      }
#pragma unroll
      for (int j = 0; j < R; ++j) {
        bk[j] = ks[(tx + 16 * j) * ld + c];
        bv[j] = vs[(tx + 16 * j) * ld + c];
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) {
          s[i][j] = fmaf(a[i], bk[j], s[i][j]);
          dp[i][j] = fmaf(g[i], bv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = ty + 16 * i;
      const int qpos = q0 + r;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float p = 0.f;
        if (kpos < sk && !(causal && kpos > qpos)) p = expf(s[i][j] * scale - lse[r]);
        ds[r * (TILE + 1) + tx + 16 * j] = p * (dp[i][j] - delta[r]);
      }
    }
    __syncthreads();
    const int kn = min(TILE, sk - k0);
    for (int c = 0; c < kn; ++c) {
      float w[R];
#pragma unroll
      for (int i = 0; i < R; ++i) w[i] = ds[(ty + 16 * i) * (TILE + 1) + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = tx + 16 * j;
        if (col < d) {
          const float kk = ks[c * ld + col];
#pragma unroll
          for (int i = 0; i < R; ++i) acc[i][j] = fmaf(w[i], kk, acc[i][j]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = ty + 16 * i;
    if (q0 + r >= sq) continue;
    T* row = dq + qoff + (size_t)(q0 + r) * qrow;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = tx + 16 * j;
      if (col < d) row[col] = from_f<T>(acc[i][j] * scale);
    }
  }
  __syncthreads();  // lse and delta are written (also when no key tile ran)
  const size_t soff = ((size_t)b * h + head) * sq + q0;
  for (int r = threadIdx.x; r < TILE; r += THREADS)
    if (q0 + r < sq) {
      lse_out[soff + r] = lse[r];
      delta_out[soff + r] = delta[r];
    }
}

template <typename T, int TILE, int NJ>
__global__ void __launch_bounds__(THREADS)
    dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ dout, const float* __restrict__ lse_in,
                const float* __restrict__ delta_in, T* __restrict__ dk, T* __restrict__ dv,
                int sq, int sk, int h, int kvh, int d, float scale, int causal) {
  constexpr int R = TILE / 16;
  extern __shared__ float smem[];
  const int ld = d + 1;
  float* ks = smem;               // [TILE][ld]
  float* vs = ks + TILE * ld;     // [TILE][ld]
  float* qs = vs + TILE * ld;     // [TILE][ld]
  float* dos = qs + TILE * ld;    // [TILE][ld]
  float* pt = dos + TILE * ld;    // [TILE keys][TILE + 1]
  float* dst = pt + TILE * (TILE + 1);  // [TILE keys][TILE + 1]
  float* lse = dst + TILE * (TILE + 1);  // [TILE]
  float* delta = lse + TILE;             // [TILE]
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int k0 = blockIdx.x * TILE;
  const int kvhead = blockIdx.y;
  const int b = blockIdx.z;
  const int rep = h / kvh;
  const size_t qrow = (size_t)h * d;
  const size_t krow = (size_t)kvh * d;
  const size_t koff = (size_t)b * sk * krow + (size_t)kvhead * d;

  load_tile<T, TILE>(ks, k + koff, k0, sk, krow, d, ld);
  load_tile<T, TILE>(vs, v + koff, k0, sk, krow, d, ld);
  float adk[R][NJ], adv[R][NJ];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) adk[i][j] = adv[i][j] = 0.f;
  const int q_start = causal ? k0 : 0;  // earlier query rows see none of these keys
  for (int rr = 0; rr < rep; ++rr) {
    const int head = kvhead * rep + rr;
    const size_t qoff = (size_t)b * sq * qrow + (size_t)head * d;
    const size_t soff = ((size_t)b * h + head) * sq;
    for (int q0 = q_start; q0 < sq; q0 += TILE) {
      __syncthreads();  // the last tile's reads are done
      load_tile<T, TILE>(qs, q + qoff, q0, sq, qrow, d, ld);
      load_tile<T, TILE>(dos, dout + qoff, q0, sq, qrow, d, ld);
      for (int r = threadIdx.x; r < TILE; r += THREADS) {
        const bool in = q0 + r < sq;
        lse[r] = in ? lse_in[soff + q0 + r] : INFINITY;  // rows past Sq: no weight
        delta[r] = in ? delta_in[soff + q0 + r] : 0.f;
      }
      __syncthreads();
      float s[R][R], dp[R][R];  // [key row i][query column j]
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) s[i][j] = dp[i][j] = 0.f;
      for (int c = 0; c < d; ++c) {
        float a[R], bv[R], bq[R], g[R];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          a[i] = ks[(ty + 16 * i) * ld + c];
          bv[i] = vs[(ty + 16 * i) * ld + c];
        }
#pragma unroll
        for (int j = 0; j < R; ++j) {
          bq[j] = qs[(tx + 16 * j) * ld + c];
          g[j] = dos[(tx + 16 * j) * ld + c];
        }
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int j = 0; j < R; ++j) {
            s[i][j] = fmaf(a[i], bq[j], s[i][j]);
            dp[i][j] = fmaf(bv[i], g[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int kr = ty + 16 * i;
        const int kpos = k0 + kr;
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const int qc = tx + 16 * j;
          const int qpos = q0 + qc;
          float p = 0.f;
          if (kpos < sk && !(causal && kpos > qpos)) p = expf(s[i][j] * scale - lse[qc]);
          pt[kr * (TILE + 1) + qc] = p;
          dst[kr * (TILE + 1) + qc] = p * (dp[i][j] - delta[qc]);
        }
      }
      __syncthreads();
      const int qn = min(TILE, sq - q0);
      for (int c = 0; c < qn; ++c) {
        float wp[R], wd[R];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          wp[i] = pt[(ty + 16 * i) * (TILE + 1) + c];
          wd[i] = dst[(ty + 16 * i) * (TILE + 1) + c];
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int col = tx + 16 * j;
          if (col < d) {
            const float go = dos[c * ld + col];
            const float qq = qs[c * ld + col];
#pragma unroll
            for (int i = 0; i < R; ++i) {
              adv[i][j] = fmaf(wp[i], go, adv[i][j]);
              adk[i][j] = fmaf(wd[i], qq, adk[i][j]);
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int kr = ty + 16 * i;
    if (k0 + kr >= sk) continue;
    T* rk = dk + koff + (size_t)(k0 + kr) * krow;
    T* rv = dv + koff + (size_t)(k0 + kr) * krow;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = tx + 16 * j;
      if (col < d) {
        rk[col] = from_f<T>(adk[i][j] * scale);
        rv[col] = from_f<T>(adv[i][j]);
      }
    }
  }
}

template <typename T, int TILE, int NJ>
int run(const T* q, const T* k, const T* v, const T* o, const T* dout, T* dq, T* dk, T* dv,
        float* lse, float* delta, int b, int sq, int sk, int h, int kvh, int d, float scale,
        int causal, cudaStream_t stream) {
  const size_t tiles = (size_t)4 * TILE * (d + 1);
  const size_t smem_q = (tiles + (size_t)TILE * (TILE + 1) + 2 * TILE) * sizeof(float);
  const size_t smem_k = (tiles + (size_t)2 * TILE * (TILE + 1) + 2 * TILE) * sizeof(float);
  // above 48 KB a block's dynamic shared memory must be asked for
  cudaError_t e = cudaFuncSetAttribute(dq_kernel<T, TILE, NJ>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_q);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(dkdv_kernel<T, TILE, NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem_k);
  if (e != cudaSuccess) return (int)e;
  if (sq > 0) {
    dq_kernel<T, TILE, NJ><<<dim3((sq + TILE - 1) / TILE, h, b), THREADS, smem_q, stream>>>(
        q, k, v, o, dout, dq, lse, delta, sq, sk, h, kvh, d, scale, causal);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (sk > 0)
    dkdv_kernel<T, TILE, NJ><<<dim3((sk + TILE - 1) / TILE, kvh, b), THREADS, smem_k, stream>>>(
        q, k, v, dout, lse, delta, dk, dv, sq, sk, h, kvh, d, scale, causal);
  return (int)cudaGetLastError();
}

// NJ = accumulator columns a thread: the head dim over 16, rounded up to
// an instantiated width.
template <typename T>
int launch(const T* q, const T* k, const T* v, const T* o, const T* dout, T* dq, T* dk, T* dv,
           float* lse, float* delta, int b, int sq, int sk, int h, int kvh, int d, float scale,
           int causal, cudaStream_t stream) {
  if (d <= 0 || d > 256 || d % 2 || kvh <= 0 || h % kvh || b <= 0)
    return (int)cudaErrorInvalidValue;
  const int nj = (d + 15) / 16;
#define RUN(TILE, NJ) \
  run<T, TILE, NJ>(q, k, v, o, dout, dq, dk, dv, lse, delta, b, sq, sk, h, kvh, d, scale, causal, \
                   stream)
  if (nj <= 2) return RUN(64, 2);
  if (nj <= 4) return RUN(64, 4);
  if (nj <= 8) return RUN(64, 8);
  if (nj <= 12) return RUN(32, 12);
  return RUN(32, 16);
#undef RUN
}

}  // namespace

extern "C" {
int flash_attention_bwd_f32(const float* q, const float* k, const float* v, const float* o,
                            const float* dout, float* dq, float* dk, float* dv, float* lse,
                            float* delta, int b, int sq, int sk, int h, int kvh, int d,
                            float scale, int causal, cudaStream_t stream) {
  return launch<float>(q, k, v, o, dout, dq, dk, dv, lse, delta, b, sq, sk, h, kvh, d, scale,
                       causal, stream);
}
int flash_attention_bwd_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                             const __nv_bfloat16* v, const __nv_bfloat16* o,
                             const __nv_bfloat16* dout, __nv_bfloat16* dq, __nv_bfloat16* dk,
                             __nv_bfloat16* dv, float* lse, float* delta, int b, int sq, int sk,
                             int h, int kvh, int d, float scale, int causal,
                             cudaStream_t stream) {
  return launch<__nv_bfloat16>(q, k, v, o, dout, dq, dk, dv, lse, delta, b, sq, sk, h, kvh, d,
                               scale, causal, stream);
}
}

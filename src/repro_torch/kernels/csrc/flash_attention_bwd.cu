// The backward pass of csrc/flash_attention.cu, for Hopper, sm_90a: the
// gradients dq, dk and dv of
//   out = softmax(q k^T * scale, causal: kpos <= qpos) v
// for q [B, Sq, H, D] and k, v [B, Sk, KV, D] (bf16 or float32; query head
// h reads KV head h / (H / KV)), given out, its gradient dout and the
// forward's lse [B, H, Sq] (float32, natural log: p = exp(s * scale - lse)).
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
// cores' bf16 rate.  This pair does seven products (q k^T and dout v^T
// twice, once a launch), so its floor is 7/5 of that bound.
//
// Two launches, each output written by one block in one order, with no
// atomics, so a gradient has one summation order and is the same bits on
// every run:
// * dq, one block per (q tile, head, batch), the longest causal rows
//   first.  It forms delta = sum_c dout * out over each row (written for
//   the second launch), then over the key tiles p = exp(s - lse) from the
//   saved lse, dp = dout v^T, ds = p (dp - delta), and dq += ds k.
// * dkdv, one block per (key tile, KV head, batch), the first key tiles
//   (the longest causal columns) first.  It loops over the query heads of
//   its group and, for each, the query tiles that see its keys, in order:
//   dv += p^T dout, dk += ds^T q.
// Masked scores are -1e30 as in the forward, so p = 0 there; keys past Sk
// and query rows past Sq have no weight.
//
// Routes, chosen in the C entry point from the dtype, shapes and pointers
// alone (nothing falls back after a failed build or launch):
// * bf16 with D % 8 == 0, D <= 192, Sk > 0 and 16-byte-aligned q, k, v,
//   out, dout, dq, dk, dv: the tensor-core pair (namespace tc).  D is
//   padded to DP = 64, 128 or 192 (MLA's 192, V padded) with zeros that
//   TMA fills past D.
// * everything else (float32; bf16 with D % 8 != 0, an unaligned base or
//   Sk = 0, which a tensor map cannot describe; bf16 D of 200..256, which
//   the tensor-core pair does not instantiate: its K, V and streamed
//   tiles would not fit shared memory): the scalar pair (namespace scalar).
//
// The tensor-core pair (the form of the forward, building blocks in
// csrc/hopper.cuh): three warpgroups a block, two consumers of 64 rows
// each and a producer warp (setmaxnreg 40/232).  Tiles sit in shared
// memory as 64-column boxes with the 128-byte swizzle, loaded by
// cp.async.bulk.tensor through 4-D tensor maps over [B, S, heads, D], a
// full and an empty mbarrier a stage.
// * dq_tc_kernel: Q and dout [128 x DP] of the block once; K and V [64 x
//   DP] tiles through a ring of 2 stages.  S = Q K^T and dP = dout V^T are
//   wgmma m64n64k16 with both operands K-major from shared memory; P and
//   dS in registers on the accumulator fragment; dQ += dS K is wgmma with
//   dS from registers and K MN-major (as the forward's P V).  delta comes
//   from 16-byte loads of out and dout, a quad of lanes a row pair.
// * dkdv_tc_kernel: K and V [128 x DP] of the block once; Q and dout
//   [64 x DP] tiles, with the tile's lse and delta (written into shared
//   memory by the producer warp's lanes, which arrive on the full barrier
//   beside the TMA bytes), through a ring of 2 stages.  S^T = K Q^T and
//   dP^T = V dout^T are ss wgmma (K-major); P^T = exp(S^T scale - lse)
//   in registers, packed to bf16; dV += P^T dout (rs wgmma, B MN-major)
//   in one wgmma group with dP^T; dS^T = P^T (dP^T - delta) from the
//   packed P^T (so a thread never holds P^T and dP^T in float32 together
//   beside dK and dV: 128 registers at DP 128); dK += dS^T Q (rs).  dK
//   and dV stay in float32 registers until the one store.  At DP 192 the
//   tiles are streamed twice, dV in the first pass and dK in the second
//   (eight products instead of seven, one accumulator of 96 registers at
//   a time).
// * P and dS enter the rs products as one bf16 term each, as SDPA's
//   backward does (the forward carries P as hi + lo bf16 terms because the
//   reference multiplies by float32 probabilities; the gradients' checks,
//   3e-2 of each gradient's largest |value|, hold with one term, so no
//   term is split here; dkdv also forms dS^T from the bf16 P^T, one more
//   rounding of 2^-9 of the size of dS's own).  Each output goes through
//   the block's own rows of a tile in shared memory to 16-byte stores,
//   but DP 192's dV (4-byte stores from the fragment).
//
// The scalar pair: tiles of TILE rows in shared memory as float32 rows of
// stride d + 1 (odd, so a column walk hits 32 banks); 256 threads, each
// owning a (TILE / 16) x (TILE / 16) block of the score tile and TILE / 16
// rows x NJ columns of the accumulators; explicit fmaf on the CUDA cores
// (the build's --fmad=false only stops contraction).  TILE = 64 for D <=
// 128, 32 above (the shared memory of D = 256).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace scalar {

constexpr int THREADS = 256;

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
              const T* __restrict__ o, const T* __restrict__ dout,
              const float* __restrict__ lse_in, T* __restrict__ dq, float* __restrict__ delta_out,
              int sq, int sk, int h, int kvh, int d, float scale, int causal) {
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
  const size_t soff = ((size_t)b * h + head) * sq + q0;

  load_tile<T, TILE>(qs, q + qoff, q0, sq, qrow, d, ld);
  load_tile<T, TILE>(dos, dout + qoff, q0, sq, qrow, d, ld);
  for (int r = threadIdx.x; r < TILE; r += THREADS) lse[r] = q0 + r < sq ? lse_in[soff + r] : 0.f;
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
  // p from the forward's lse, dp, ds and dq += ds k
  float acc[R][NJ];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < kv_end; k0 += TILE) {
    __syncthreads();  // the last tile's ds and k reads are done (and delta is written)
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
  __syncthreads();  // delta is written (also when no key tile ran)
  for (int r = threadIdx.x; r < TILE; r += THREADS)
    if (q0 + r < sq) delta_out[soff + r] = delta[r];
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
int run(const T* q, const T* k, const T* v, const T* o, const T* dout, const float* lse, T* dq,
        T* dk, T* dv, float* delta, int b, int sq, int sk, int h, int kvh, int d, float scale,
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
        q, k, v, o, dout, lse, dq, delta, sq, sk, h, kvh, d, scale, causal);
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
int launch(const T* q, const T* k, const T* v, const T* o, const T* dout, const float* lse, T* dq,
           T* dk, T* dv, float* delta, int b, int sq, int sk, int h, int kvh, int d, float scale,
           int causal, cudaStream_t stream) {
  const int nj = (d + 15) / 16;
#define RUN(TILE, NJ) \
  run<T, TILE, NJ>(q, k, v, o, dout, lse, dq, dk, dv, delta, b, sq, sk, h, kvh, d, scale, causal, \
                   stream)
  if (nj <= 2) return RUN(64, 2);
  if (nj <= 4) return RUN(64, 4);
  if (nj <= 8) return RUN(64, 8);
  if (nj <= 12) return RUN(32, 12);
  return RUN(32, 16);
#undef RUN
}

}  // namespace scalar

namespace tc {

using namespace hopper;

constexpr int ROWS = 128;  // a block's own rows: two consumer warpgroups of 64
constexpr int TILE = 64;   // rows of a streamed tile
constexpr int STAGES = 2;  // streamed tiles in flight
constexpr int CONSUMER_WARPS = 8;
constexpr int THREADS = 32 * CONSUMER_WARPS + 128;  // and the producer's warpgroup
constexpr float LOG2E = 1.4426950408889634f;

template <int DP>
struct Tiles {
  static constexpr int BOXES = DP / 64;             // 64-column boxes of a row
  static constexpr uint32_t OWN = ROWS * DP * 2;    // a block's [128 x DP] tile
  static constexpr uint32_t STREAM = TILE * DP * 2; // a streamed [64 x DP] tile
  // dkdv's passes over the streamed tiles: both accumulators in one up to
  // DP 128; at 192, dV in a first pass and dK in a second (the two would
  // need 192 float32 registers a thread)
  static constexpr int PASSES = DP <= 128 ? 1 : 2;
  // two own tiles, two rings of streamed tiles, (dkdv) lse and delta of
  // each stage, 1 + 4 STAGES mbarriers; 1 KB to align to 1024
  static constexpr int SMEM = 2 * OWN + 2 * STAGES * STREAM + 2 * STAGES * TILE * 4 +
                              8 * (1 + 4 * STAGES) + 1024;
};

// P (or dS) of a [64 x 64] accumulator fragment as A fragments of the next
// product: for K-dim 16 kk.., register r holds the pair at row half (r & 1)
// of 8-column chunk 2 kk + r / 2, accumulator entries 8 kk + 2 r, + 1.
// A thread's entry e is row r_lo + 8 ((e >> 1) & 1), column 8 (e / 4) + cq
// + (e & 1) of the fragment.

template <int DP>
__global__ void __launch_bounds__(THREADS, 1)
    dq_tc_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                 const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                 const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
                 const float* __restrict__ lse, __nv_bfloat16* __restrict__ dq,
                 float* __restrict__ delta_out, int sq, int sk, int h, int kvh, int d, float scale,
                 float scale_log2, int causal) {
  using T = Tiles<DP>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t qs = (raw + 1023) & ~1023u;  // the swizzle repeats every 1024 bytes
  const uint32_t dos = qs + T::OWN;
  const uint32_t ks = dos + T::OWN;           // K stage s at ks + s * STREAM
  const uint32_t vs = ks + STAGES * T::STREAM;
  const uint32_t bars = vs + STAGES * T::STREAM;
  const uint32_t full_q = bars;               // then full_k[s], full_v[s], empty_k[s], empty_v[s]
#define FULL_K(s) (bars + 8 * (1 + (s)))
#define FULL_V(s) (bars + 8 * (1 + STAGES + (s)))
#define EMPTY_K(s) (bars + 8 * (1 + 2 * STAGES + (s)))
#define EMPTY_V(s) (bars + 8 * (1 + 3 * STAGES + (s)))

  // the last q tiles first: blockIdx.x walks (head, batch) fastest
  const int ntq = (sq + ROWS - 1) / ROWS;
  const int hb = gridDim.x / ntq;
  const int q0 = (ntq - 1 - (int)(blockIdx.x / hb)) * ROWS;
  const int head = (int)(blockIdx.x % hb) % h;
  const int b = (int)(blockIdx.x % hb) / h;
  const int kv_end = causal ? min(sk, q0 + ROWS) : sk;  // skip tiles past the diagonal
  const int ntiles = (kv_end + TILE - 1) / TILE;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(FULL_K(s), 1);
      mbar_init(FULL_V(s), 1);
      mbar_init(EMPTY_K(s), CONSUMER_WARPS);
      mbar_init(EMPTY_V(s), CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp >= CONSUMER_WARPS) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == CONSUMER_WARPS && lane == 0) {
      const int kvhead = head / (h / kvh);
      mbar_expect_tx(full_q, 2 * T::OWN);
#pragma unroll
      for (int x = 0; x < T::BOXES; ++x) {
        tma_load(qs + x * ROWS * 128, &tq, full_q, 64 * x, head, q0, b);
        tma_load(dos + x * ROWS * 128, &tdo, full_q, 64 * x, head, q0, b);
      }
      for (int i = 0; i < ntiles; ++i) {
        const int s = i % STAGES;
        const uint32_t parity = ((i / STAGES) & 1) ^ 1;  // the first round finds the stage empty
        mbar_wait(EMPTY_K(s), parity);
        mbar_expect_tx(FULL_K(s), T::STREAM);
#pragma unroll
        for (int x = 0; x < T::BOXES; ++x)
          tma_load(ks + s * T::STREAM + x * TILE * 128, &tk, FULL_K(s), 64 * x, kvhead, i * TILE, b);
        mbar_wait(EMPTY_V(s), parity);
        mbar_expect_tx(FULL_V(s), T::STREAM);
#pragma unroll
        for (int x = 0; x < T::BOXES; ++x)
          tma_load(vs + s * T::STREAM + x * TILE * 128, &tv, FULL_V(s), 64 * x, kvhead, i * TILE, b);
      }
    }
  } else {
    // consumers: warpgroup w owns rows q0 + 64 w .. + 63
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int w = warp / 4;
    const int qb = q0 + 64 * w;
    const int r_lo = 16 * (warp % 4) + lane / 4;  // a thread's rows: r_lo and r_lo + 8
    const int cq = 2 * (lane % 4);                // its columns in each 8-column chunk
    const size_t qrow = (size_t)h * d;            // elements between positions of q
    const size_t srow = ((size_t)b * h + head) * sq;

    // delta = sum dout * out over the thread's two rows (a quad of lanes
    // shares them: lane % 4 takes every 4th 8-column chunk), and lse in base 2
    float delta[2], lse2[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = qb + r_lo + 8 * hh;
      float acc = 0.f;
      if (row < sq) {
        const size_t base = ((size_t)b * sq + row) * qrow + (size_t)head * d;
        for (int c8 = lane % 4; c8 < d / 8; c8 += 4) {
          const uint4 a = *reinterpret_cast<const uint4*>(o + base + c8 * 8);
          const uint4 g = *reinterpret_cast<const uint4*>(dout + base + c8 * 8);
          const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
          const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&g);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float2 fa = __bfloat1622float2(a2[j]), fg = __bfloat1622float2(g2[j]);
            acc = acc + fg.x * fa.x;
            acc = acc + fg.y * fa.y;
          }
        }
      }
      acc = acc + __shfl_xor_sync(0xffffffffu, acc, 1);
      acc = acc + __shfl_xor_sync(0xffffffffu, acc, 2);
      delta[hh] = acc;
      lse2[hh] = row < sq ? lse[srow + row] * LOG2E : 0.f;
      if (cq == 0 && row < sq) delta_out[srow + row] = acc;
    }

    float dqa[T::BOXES][32];
#pragma unroll
    for (int p = 0; p < T::BOXES; ++p)
#pragma unroll
      for (int e = 0; e < 32; ++e) dqa[p][e] = 0.f;
    mbar_wait(full_q, 0);
    for (int i = 0; i < ntiles; ++i) {
      const int s = i % STAGES;
      const uint32_t parity = (i / STAGES) & 1;
      const int k0 = i * TILE;
      mbar_wait(FULL_K(s), parity);
      if (causal && k0 > qb + 63) {  // wholly past this warpgroup's last row
        if (lane == 0) mbar_arrive(EMPTY_K(s));
        mbar_wait(FULL_V(s), parity);
        if (lane == 0) mbar_arrive(EMPTY_V(s));
        continue;
      }
      // both tiles first: a wait between two wgmma batches serializes them
      mbar_wait(FULL_V(s), parity);
      float sacc[32], dpacc[32];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;  // 16 columns = 32 bytes into box kk / 4
        const uint64_t da = desc(qs + (kk / 4) * ROWS * 128 + w * 64 * 128 + off, 16, 1024);
        const uint64_t db = desc(ks + s * T::STREAM + (kk / 4) * TILE * 128 + off, 16, 1024);
        wgmma_ss_n64(sacc, da, db, kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        const uint64_t da = desc(dos + (kk / 4) * ROWS * 128 + w * 64 * 128 + off, 16, 1024);
        const uint64_t db = desc(vs + s * T::STREAM + (kk / 4) * TILE * 128 + off, 16, 1024);
        wgmma_ss_n64(dpacc, da, db, kk > 0);
      }
      wg_commit();
      wg_wait0();
      pin(sacc);
      pin(dpacc);
      if (lane == 0) mbar_arrive(EMPTY_V(s));

      // p = exp(s scale - lse), masked where the tile needs it; ds = p (dp - delta)
      const bool edge = (causal && k0 + TILE - 1 > qb) || k0 + TILE > sk;
      uint32_t dsf[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int e = 8 * kk + 2 * r;
          const int hh = r & 1;
          float ds2[2];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            float p = ex2(sacc[e + u] * scale_log2 - lse2[hh]);
            if (edge) {
              const int key = k0 + 8 * (e / 4) + cq + u;
              const int row = qb + r_lo + 8 * hh;
              if ((causal && key > row) || key >= sk) p = 0.f;
            }
            ds2[u] = p * (dpacc[e + u] - delta[hh]);
          }
          dsf[kk][r] = bits(__floats2bfloat162_rn(ds2[0], ds2[1]));
        }

      // dQ += dS K: K MN-major, 16 keys = 2048 bytes down a box
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int p = 0; p < T::BOXES; ++p) {
          const uint64_t db = desc(ks + s * T::STREAM + p * TILE * 128 + kk * 2048, TILE * 128, 1024);
          wgmma_rs_n64(dqa[p], dsf[kk], db);
        }
      wg_commit();
      wg_wait0();
#pragma unroll
      for (int p = 0; p < T::BOXES; ++p) pin(dqa[p]);
      if (lane == 0) mbar_arrive(EMPTY_K(s));
    }

    // epilogue: dQ * scale in bf16 through this warpgroup's rows of the Q
    // tile (its last reader was this warpgroup's last Q K^T)
    bar_sync(1 + w, 128);
    uint8_t* qgen = smem_raw + (qs - raw);
#pragma unroll
    for (int p = 0; p < T::BOXES; ++p)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = r_lo + 8 * hh;
          const __nv_bfloat162 y = __floats2bfloat162_rn(dqa[p][4 * j + 2 * hh] * scale,
                                                         dqa[p][4 * j + 2 * hh + 1] * scale);
          *reinterpret_cast<uint32_t*>(qgen + p * ROWS * 128 + (64 * w + r) * 128 +
                                       ((j ^ (r & 7)) * 16) + cq * 2) = bits(y);
        }
    bar_sync(1 + w, 128);
    for (int idx = threadIdx.x % 128; idx < 64 * (DP / 8); idx += 128) {
      const int r = idx / (DP / 8), c8 = idx % (DP / 8);
      const int qpos = qb + r;
      if (qpos < sq && c8 * 8 < d) {
        const uint4 y = *reinterpret_cast<const uint4*>(
            qgen + (c8 / 8) * ROWS * 128 + (64 * w + r) * 128 + (((c8 % 8) ^ (r & 7)) * 16));
        *reinterpret_cast<uint4*>(dq + ((size_t)b * sq + qpos) * qrow + (size_t)head * d + c8 * 8) = y;
      }
    }
  }
#undef FULL_K
#undef FULL_V
#undef EMPTY_K
#undef EMPTY_V
}

// What a consumer warpgroup of dkdv_tc_kernel needs in its loop over the
// streamed tiles (addresses in shared memory, the block's place).
struct DkdvCtx {
  uint32_t ks, vs, qs, dos, bars;
  const float* lse_s;    // the stages' lse (base 2) [STAGES][64]
  const float* delta_s;  // the stages' delta [STAGES][64]
  int w, kw, r_lo, cq, lane, qt0, per_head, ntiles, sk, causal;
  float scale_log2;
};

// One pass of a consumer warpgroup over the streamed tiles (tile t of the
// pass is the ring's tile t0 + t): S^T = K Q^T, P^T = exp(S^T scale - lse)
// (0 above the diagonal) packed to bf16; with DV, dV += P^T dout; with DK,
// dP^T = V dout^T, dS^T = P^T (dP^T - delta) from the packed P^T and dK +=
// dS^T Q.  dP^T and the dV product go in one wgmma group.
template <int DP, bool DV, bool DK>
__device__ __forceinline__ void dkdv_pass(const DkdvCtx& c, int t0, float (&dva)[DP / 64][32],
                                          float (&dka)[DP / 64][32]) {
  using T = Tiles<DP>;
  for (int t = 0; t < c.ntiles; ++t) {
    const int s = (t0 + t) % STAGES;
    const uint32_t parity = ((t0 + t) / STAGES) & 1;
    const uint32_t full = c.bars + 8 * (1 + s), empty = c.bars + 8 * (1 + STAGES + s);
    const int q0 = (c.qt0 + t % c.per_head) * TILE;
    mbar_wait(full, parity);
    // every query of the tile before every key of the warpgroup, or no key in Sk
    if ((c.causal && q0 + TILE - 1 < c.kw) || c.kw >= c.sk) {
      if (c.lane == 0) mbar_arrive(empty);
      continue;
    }
    const uint32_t qt = c.qs + s * T::STREAM, dot = c.dos + s * T::STREAM;
    float sacc[32];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;  // 16 columns = 32 bytes into box kk / 4
      wgmma_ss_n64(sacc, desc(c.ks + (kk / 4) * ROWS * 128 + c.w * 64 * 128 + off, 16, 1024),
                   desc(qt + (kk / 4) * TILE * 128 + off, 16, 1024), kk > 0);
    }
    wg_commit();
    wg_wait0();
    pin(sacc);

    const float* ls = c.lse_s + s * TILE;
    const bool edge = c.causal && c.kw + 63 > q0;
    uint32_t pf[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int e = 8 * kk + 2 * r;
        const int col = 8 * (2 * kk + r / 2) + c.cq;  // the query column of entry e
        const float2 l2 = *reinterpret_cast<const float2*>(ls + col);
        float p0 = ex2(sacc[e] * c.scale_log2 - l2.x);
        float p1 = ex2(sacc[e + 1] * c.scale_log2 - l2.y);
        if (edge) {
          const int key = c.kw + c.r_lo + 8 * (r & 1);
          if (key > q0 + col) p0 = 0.f;
          if (key > q0 + col + 1) p1 = 0.f;
        }
        pf[kk][r] = bits(__floats2bfloat162_rn(p0, p1));
      }

    float dpacc[32];
    wg_fence();
    if constexpr (DK) {
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        wgmma_ss_n64(dpacc, desc(c.vs + (kk / 4) * ROWS * 128 + c.w * 64 * 128 + off, 16, 1024),
                     desc(dot + (kk / 4) * TILE * 128 + off, 16, 1024), kk > 0);
      }
    }
    if constexpr (DV) {
      // dV += P^T dout: dout MN-major, 16 queries = 2048 bytes down a box
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int p = 0; p < T::BOXES; ++p)
          wgmma_rs_n64(dva[p], pf[kk], desc(dot + p * TILE * 128 + kk * 2048, TILE * 128, 1024));
    }
    wg_commit();
    wg_wait0();
    if constexpr (DV) {
#pragma unroll
      for (int p = 0; p < T::BOXES; ++p) pin(dva[p]);
    }
    if constexpr (DK) {
      pin(dpacc);
      const float* dl = c.delta_s + s * TILE;
      uint32_t dsf[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int e = 8 * kk + 2 * r;
          const float2 d2 = *reinterpret_cast<const float2*>(dl + 8 * (2 * kk + r / 2) + c.cq);
          __nv_bfloat162 pb;
          *reinterpret_cast<uint32_t*>(&pb) = pf[kk][r];
          const float2 pp = __bfloat1622float2(pb);
          dsf[kk][r] = bits(__floats2bfloat162_rn(pp.x * (dpacc[e] - d2.x),
                                                  pp.y * (dpacc[e + 1] - d2.y)));
        }
      // dK += dS^T Q: Q MN-major
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int p = 0; p < T::BOXES; ++p)
          wgmma_rs_n64(dka[p], dsf[kk], desc(qt + p * TILE * 128 + kk * 2048, TILE * 128, 1024));
      wg_commit();
      wg_wait0();
#pragma unroll
      for (int p = 0; p < T::BOXES; ++p) pin(dka[p]);
    }
    if (c.lane == 0) mbar_arrive(empty);
  }
}

// dK (times scale) or dV of a warpgroup's 64 keys, bf16, through its own
// rows of a [128 x DP] tile in shared memory (swizzled) to 16-byte stores
// of the keys in Sk.
template <int DP>
__device__ __forceinline__ void dkdv_store(const float (&acc)[DP / 64][32], float mul,
                                           uint8_t* tile, __nv_bfloat16* out, int w, int kw,
                                           int r_lo, int cq, int b, int sk, int kvh, int kvhead,
                                           int d) {
  bar_sync(1 + w, 128);
#pragma unroll
  for (int p = 0; p < DP / 64; ++p)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = r_lo + 8 * hh;
        *reinterpret_cast<uint32_t*>(tile + p * ROWS * 128 + (64 * w + r) * 128 +
                                     ((j ^ (r & 7)) * 16) + cq * 2) =
            bits(__floats2bfloat162_rn(acc[p][4 * j + 2 * hh] * mul,
                                       acc[p][4 * j + 2 * hh + 1] * mul));
      }
  bar_sync(1 + w, 128);
  const size_t krow = (size_t)kvh * d;  // elements between positions of k
  for (int idx = threadIdx.x % 128; idx < 64 * (DP / 8); idx += 128) {
    const int r = idx / (DP / 8), c8 = idx % (DP / 8);
    const int kpos = kw + r;
    if (kpos < sk && c8 * 8 < d)
      *reinterpret_cast<uint4*>(out + ((size_t)b * sk + kpos) * krow + (size_t)kvhead * d + c8 * 8) =
          *reinterpret_cast<const uint4*>(tile + (c8 / 8) * ROWS * 128 + (64 * w + r) * 128 +
                                          (((c8 % 8) ^ (r & 7)) * 16));
  }
}

template <int DP>
__global__ void __launch_bounds__(THREADS, 1)
    dkdv_tc_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                   const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int sq, int sk,
                   int h, int kvh, int d, float scale, float scale_log2, int causal) {
  using T = Tiles<DP>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t ks = (raw + 1023) & ~1023u;  // the swizzle repeats every 1024 bytes
  const uint32_t vs = ks + T::OWN;
  const uint32_t qs = vs + T::OWN;            // Q stage s at qs + s * STREAM
  const uint32_t dos = qs + STAGES * T::STREAM;
  const uint32_t stats = dos + STAGES * T::STREAM;  // lse (base 2) [STAGES][64], delta [STAGES][64]
  const uint32_t bars = stats + 2 * STAGES * TILE * 4;
  const uint32_t full_kv = bars;              // then full[s], empty[s]
#define FULL(s) (bars + 8 * (1 + (s)))
#define EMPTY(s) (bars + 8 * (1 + STAGES + (s)))
  float* lse_s = reinterpret_cast<float*>(smem_raw + (stats - raw));
  float* delta_s = lse_s + STAGES * TILE;

  // the first key tiles (the longest causal columns) first: blockIdx.x
  // walks (KV head, batch) fastest
  const int nkt = (sk + ROWS - 1) / ROWS;
  const int hb = gridDim.x / nkt;
  const int k0 = (int)(blockIdx.x / hb) * ROWS;
  const int kvhead = (int)(blockIdx.x % hb) % kvh;
  const int b = (int)(blockIdx.x % hb) / kvh;
  const int rep = h / kvh;
  // query tiles of 64 from the diagonal on (k0 is a multiple of 128), for
  // each query head of the group in turn; streamed once a pass
  const int qt0 = causal ? k0 / TILE : 0;
  const int per_head = max((sq + TILE - 1) / TILE - qt0, 0);
  const int ntiles = rep * per_head;

  if (threadIdx.x == 0) {
    mbar_init(full_kv, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(FULL(s), 32);  // the producer warp's lanes (lane 0 with the TMA bytes)
      mbar_init(EMPTY(s), CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp >= CONSUMER_WARPS) {
    // producer: lane 0 issues the TMA loads, every lane writes lse and delta
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == CONSUMER_WARPS) {
      if (lane == 0) {
        mbar_expect_tx(full_kv, 2 * T::OWN);
#pragma unroll
        for (int x = 0; x < T::BOXES; ++x) {
          tma_load(ks + x * ROWS * 128, &tk, full_kv, 64 * x, kvhead, k0, b);
          tma_load(vs + x * ROWS * 128, &tv, full_kv, 64 * x, kvhead, k0, b);
        }
      }
      for (int t = 0; t < T::PASSES * ntiles; ++t) {
        const int s = t % STAGES;
        const uint32_t parity = ((t / STAGES) & 1) ^ 1;  // the first round finds the stage empty
        const int head = kvhead * rep + (t % ntiles) / per_head;
        const int q0 = (qt0 + t % per_head) * TILE;
        const size_t srow = ((size_t)b * h + head) * sq;
        mbar_wait(EMPTY(s), parity);
        for (int r = lane; r < TILE; r += 32) {
          const bool in = q0 + r < sq;  // rows past Sq: no weight
          lse_s[s * TILE + r] = in ? lse[srow + q0 + r] * LOG2E : INFINITY;
          delta_s[s * TILE + r] = in ? delta[srow + q0 + r] : 0.f;
        }
        if (lane == 0) {
          mbar_expect_tx(FULL(s), 2 * T::STREAM);
#pragma unroll
          for (int x = 0; x < T::BOXES; ++x) {
            tma_load(qs + s * T::STREAM + x * TILE * 128, &tq, FULL(s), 64 * x, head, q0, b);
            tma_load(dos + s * T::STREAM + x * TILE * 128, &tdo, FULL(s), 64 * x, head, q0, b);
          }
        } else {
          mbar_arrive(FULL(s));
        }
      }
    }
  } else {
    // consumers: warpgroup w owns keys k0 + 64 w .. + 63
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    DkdvCtx c;
    c.ks = ks;
    c.vs = vs;
    c.qs = qs;
    c.dos = dos;
    c.bars = bars;
    c.lse_s = lse_s;
    c.delta_s = delta_s;
    c.w = warp / 4;
    c.kw = k0 + 64 * c.w;
    c.r_lo = 16 * (warp % 4) + lane / 4;  // a thread's keys: r_lo and r_lo + 8
    c.cq = 2 * (lane % 4);                // its query columns in each 8-column chunk
    c.lane = lane;
    c.qt0 = qt0;
    c.per_head = per_head;
    c.ntiles = ntiles;
    c.sk = sk;
    c.causal = causal;
    c.scale_log2 = scale_log2;
    uint8_t* kgen = smem_raw + (ks - raw);
    uint8_t* vgen = smem_raw + (vs - raw);
    mbar_wait(full_kv, 0);  // also before an epilogue reuses the K or V tile
    if constexpr (T::PASSES == 1) {
      float dka[T::BOXES][32], dva[T::BOXES][32];
#pragma unroll
      for (int p = 0; p < T::BOXES; ++p)
#pragma unroll
        for (int e = 0; e < 32; ++e) dka[p][e] = dva[p][e] = 0.f;
      dkdv_pass<DP, true, true>(c, 0, dva, dka);
      dkdv_store<DP>(dka, scale, kgen, dk, c.w, c.kw, c.r_lo, c.cq, b, sk, kvh, kvhead, d);
      dkdv_store<DP>(dva, 1.f, vgen, dv, c.w, c.kw, c.r_lo, c.cq, b, sk, kvh, kvhead, d);
    } else {
      // dV, then dK: one accumulator of 64 x DP floats at a time.  dV goes
      // from its fragment straight to device memory (bf16 pairs): dK's
      // pass still reads the V tile.
      {
        float dva[T::BOXES][32];
#pragma unroll
        for (int p = 0; p < T::BOXES; ++p)
#pragma unroll
          for (int e = 0; e < 32; ++e) dva[p][e] = 0.f;
        dkdv_pass<DP, true, false>(c, 0, dva, dva);
        const size_t krow = (size_t)kvh * d;
#pragma unroll
        for (int p = 0; p < T::BOXES; ++p)
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int kpos = c.kw + c.r_lo + 8 * hh;
              const int col = 64 * p + 8 * j + c.cq;
              if (kpos < sk && col < d)
                *reinterpret_cast<__nv_bfloat162*>(dv + ((size_t)b * sk + kpos) * krow +
                                                   (size_t)kvhead * d + col) =
                    __floats2bfloat162_rn(dva[p][4 * j + 2 * hh], dva[p][4 * j + 2 * hh + 1]);
            }
      }
      float dka[T::BOXES][32];
#pragma unroll
      for (int p = 0; p < T::BOXES; ++p)
#pragma unroll
        for (int e = 0; e < 32; ++e) dka[p][e] = 0.f;
      dkdv_pass<DP, false, true>(c, ntiles, dka, dka);
      dkdv_store<DP>(dka, scale, kgen, dk, c.w, c.kw, c.r_lo, c.cq, b, sk, kvh, kvhead, d);
    }
  }
#undef FULL
#undef EMPTY
}

template <int DP>
int run(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
        const __nv_bfloat16* o, const __nv_bfloat16* dout, const float* lse, __nv_bfloat16* dq,
        __nv_bfloat16* dk, __nv_bfloat16* dv, float* delta, int b, int sq, int sk, int h, int kvh,
        int d, float scale, int causal, cudaStream_t stream) {
  using T = Tiles<DP>;
  if (encoder() == nullptr) return (int)cudaErrorNotSupported;
  cudaError_t e = current_context();
  if (e != cudaSuccess) return (int)e;
  // the dq launch's own tiles are its 128 query rows, the dkdv launch's its 128 keys
  CUtensorMap q_own, do_own, k_tile, v_tile, q_tile, do_tile, k_own, v_own;
  if (!tensor_map(&q_own, q, b, sq, h, d, ROWS) || !tensor_map(&do_own, dout, b, sq, h, d, ROWS) ||
      !tensor_map(&k_tile, k, b, sk, kvh, d, TILE) || !tensor_map(&v_tile, v, b, sk, kvh, d, TILE) ||
      !tensor_map(&q_tile, q, b, sq, h, d, TILE) || !tensor_map(&do_tile, dout, b, sq, h, d, TILE) ||
      !tensor_map(&k_own, k, b, sk, kvh, d, ROWS) || !tensor_map(&v_own, v, b, sk, kvh, d, ROWS))
    return (int)cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(dq_tc_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           T::SMEM);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(dkdv_tc_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           T::SMEM);
  if (e != cudaSuccess) return (int)e;
  const float scale_log2 = (float)((double)scale * 1.4426950408889634);
  if (sq > 0) {
    const unsigned blocks = (unsigned)((sq + ROWS - 1) / ROWS) * (unsigned)h * (unsigned)b;
    dq_tc_kernel<DP><<<blocks, THREADS, T::SMEM, stream>>>(
        q_own, do_own, k_tile, v_tile, o, dout, lse, dq, delta, sq, sk, h, kvh, d, scale,
        scale_log2, causal);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const unsigned blocks = (unsigned)((sk + ROWS - 1) / ROWS) * (unsigned)kvh * (unsigned)b;
  dkdv_tc_kernel<DP><<<blocks, THREADS, T::SMEM, stream>>>(
      q_tile, do_tile, k_own, v_own, lse, delta, dk, dv, sq, sk, h, kvh, d, scale, scale_log2,
      causal);
  return (int)cudaGetLastError();
}

}  // namespace tc

// The route of a bf16 call: 1 for the tensor-core pair, 0 for the scalar one.
static bool tensor_cores(const void* q, const void* k, const void* v, const void* o,
                         const void* dout, const void* dq, const void* dk, const void* dv, int d,
                         int sk) {
  using hopper::aligned16;
  return d % 8 == 0 && d <= 192 && sk > 0 && aligned16(q) && aligned16(k) && aligned16(v) &&
         aligned16(o) && aligned16(dout) && aligned16(dq) && aligned16(dk) && aligned16(dv);
}

// lse [B, H, Sq] is the forward's (natural log); delta [B, H, Sq] is
// scratch the dq launch writes for the dkdv launch.  *route (when not
// null) is set to 1 for the tensor-core pair, 0 for the scalar one.
extern "C" {
int flash_attention_bwd_f32(const float* q, const float* k, const float* v, const float* o,
                            const float* dout, const float* lse, float* dq, float* dk, float* dv,
                            float* delta, int b, int sq, int sk, int h, int kvh, int d,
                            float scale, int causal, cudaStream_t stream, int* route) {
  if (d <= 0 || d > 256 || d % 2 || kvh <= 0 || h % kvh || b <= 0)
    return (int)cudaErrorInvalidValue;
  if (route != nullptr) *route = 0;
  return scalar::launch<float>(q, k, v, o, dout, lse, dq, dk, dv, delta, b, sq, sk, h, kvh, d,
                               scale, causal, stream);
}
int flash_attention_bwd_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                             const __nv_bfloat16* v, const __nv_bfloat16* o,
                             const __nv_bfloat16* dout, const float* lse, __nv_bfloat16* dq,
                             __nv_bfloat16* dk, __nv_bfloat16* dv, float* delta, int b, int sq,
                             int sk, int h, int kvh, int d, float scale, int causal,
                             cudaStream_t stream, int* route) {
  if (d <= 0 || d > 256 || d % 2 || kvh <= 0 || h % kvh || b <= 0)
    return (int)cudaErrorInvalidValue;
  const bool tc_route = tensor_cores(q, k, v, o, dout, dq, dk, dv, d, sk);
  if (route != nullptr) *route = tc_route;
  if (!tc_route)
    return scalar::launch<__nv_bfloat16>(q, k, v, o, dout, lse, dq, dk, dv, delta, b, sq, sk, h,
                                         kvh, d, scale, causal, stream);
  if (d <= 64)
    return tc::run<64>(q, k, v, o, dout, lse, dq, dk, dv, delta, b, sq, sk, h, kvh, d, scale,
                       causal, stream);
  if (d <= 128)
    return tc::run<128>(q, k, v, o, dout, lse, dq, dk, dv, delta, b, sq, sk, h, kvh, d, scale,
                        causal, stream);
  return tc::run<192>(q, k, v, o, dout, lse, dq, dk, dv, delta, b, sq, sk, h, kvh, d, scale,
                      causal, stream);
}
}

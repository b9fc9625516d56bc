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
//   chain from 0.0 (K <= 1024, so at most 32 windows).  A chain from +0.0
//   never holds -0.0 (x + y is -0.0 only for two -0.0), so adding a padding
//   zero anywhere in it changes no bit: every window is summed over all its
//   32 positions, zeros included, and a row of K <= 32 as one window.
// Every other multiply, add and the division are explicit round-to-nearest
// intrinsics, which nvcc never contracts (and the build passes
// --fmad=false); the only FMAs are the dot's, written as fmaf.
//
// Bound on the card: 4 bytes read per element and 8 written per row
// against ~3 float operations per element: memory bytes bound it.  A block
// walks tiles of RT contiguous rows (RT * K * 4 bytes, one contiguous chunk
// of device memory): the whole block copies a tile into shared memory with
// cp.async, 16 bytes a thread where the rows allow it (K % 4 == 0, a left
// padding % 4 == 0 and a 16-byte-aligned base; else 4 bytes a thread),
// while it computes on the tile before it (NBUF buffers).  Eight threads
// own a row: thread j runs dot accumulator j and windows j, j + 8, ...; the
// accumulators and window sums then reach the group's first thread by
// shuffles, which combines them in the order above.  The shared row holds
// the padded row (zeros at both ends) with 4 words of padding after every
// 32 positions and a row stride of 8 (mod 32) words: a warp's four rows
// read their 8 dot columns from distinct banks, and a row's windows, read
// 16 bytes at a time, start in distinct bank quads.  One kernel takes every
// K in 1..1024, every M and any base address.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int G = 8;                 // threads a row (one a dot accumulator)
constexpr int TILE_BYTES = 40960;    // a tile's shared bytes at most (rows a multiple of 4)
constexpr int NBUF = 2;              // tiles in shared memory: one copied while one is read
constexpr unsigned FULL = 0xffffffffu;

struct Shape {
  int k, k8, nwin, left, rs, rt;  // rs: a row's shared stride in words; rt: rows a tile
  __host__ __device__ Shape(int k_) : k(k_), k8(k_ - k_ % 8) {
    nwin = (k + 31) / 32;
    left = k > 32 ? (nwin * 32 - k) / 2 : 0;
    rs = 36 * nwin + 8;
    rt = TILE_BYTES / (rs * 4) & ~3;
    if (rt > 32) rt = 32;
    if (rt < 4) rt = 4;
  }
  // shared word of padded position p (0..32 * nwin - 1) of row slot r
  __device__ __forceinline__ int at(int r, int p) const { return r * rs + p + 4 * (p >> 5); }
};

// start the copy of tile `tile` (rows tile * rt .. , at most m) into buf
__device__ __forceinline__ void stage(const float* __restrict__ xb, int64_t m, const Shape& sh,
                                      bool vec, int64_t tile, float* buf) {
  const int64_t row0 = tile * sh.rt;
  const int nr = m - row0 < sh.rt ? (int)(m - row0) : sh.rt;
  const float* src = xb + row0 * sh.k;
  if (vec) {
    const int per_row = sh.k / 4;
    for (int c = threadIdx.x; c < nr * per_row; c += blockDim.x) {
      const int r = c / per_row, col = (c - r * per_row) * 4;
      __pipeline_memcpy_async(buf + sh.at(r, col + sh.left), src + 4 * (int64_t)c, 16);
    }
  } else {
    for (int e = threadIdx.x; e < nr * sh.k; e += blockDim.x) {
      const int r = e / sh.k, col = e - r * sh.k;
      __pipeline_memcpy_async(buf + sh.at(r, col + sh.left), src + e, 4);
    }
  }
}

__global__ void __launch_bounds__(256)
base_fit_kernel(const float* __restrict__ xb, int64_t m, int k, bool vec, float denom,
                float inv_k, float t_mean, float* __restrict__ theta,
                float* __restrict__ slope) {
  extern __shared__ __align__(16) float smem[];
  const Shape sh(k);
  const int tile_words = sh.rt * sh.rs;
  const int64_t ntiles = (m + sh.rt - 1) / sh.rt;
  const int64_t full = m - m % 8;
  const int lane = threadIdx.x & 31, r = threadIdx.x / G, j = threadIdx.x % G;
  const int leader = lane & ~(G - 1);
  // the padding positions stay zero: the copies write only a row's columns
  for (int i = threadIdx.x; i < NBUF * tile_words; i += blockDim.x) smem[i] = 0.0f;
  __syncthreads();
  // the block's tiles are blockIdx.x + i * gridDim.x, i = 0, 1, ...
  for (int i = 0; i < NBUF - 1; ++i) {
    const int64_t t = blockIdx.x + (int64_t)i * gridDim.x;
    if (t < ntiles) stage(xb, m, sh, vec, t, smem + i * tile_words);
    __pipeline_commit();
  }
  int64_t tile = blockIdx.x;
  for (int it = 0; tile < ntiles; tile += gridDim.x, ++it) {
    const int64_t next = tile + (int64_t)(NBUF - 1) * gridDim.x;
    if (next < ntiles)  // into the buffer the previous tile used
      stage(xb, m, sh, vec, next, smem + ((it + NBUF - 1) % NBUF) * tile_words);
    __pipeline_commit();
    __pipeline_wait_prior(NBUF - 1);  // this tile has landed
    __syncthreads();
    const float* buf = smem + (it % NBUF) * tile_words;
    // accumulator j over columns j, j + 8, ... below k8
    float acc = 0.0f;
    for (int c = j; c < sh.k8; c += G) {
      acc = fmaf(buf[sh.at(r, c + sh.left)], __fsub_rn((float)c, t_mean), acc);
    }
    // windows j, j + 8, j + 16, j + 24: 32 positions each, from 0.0
    float wsum[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float s = 0.0f;
      const int w = j + G * q;
      if (w < sh.nwin) {
        const float4* p = reinterpret_cast<const float4*>(buf + sh.at(r, 32 * w));
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float4 v = p[i];
          s = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(s, v.x), v.y), v.z), v.w);
        }
      }
      wsum[q] = s;
    }
    float tail = 0.0f;
    if (j == 0) {
      for (int c = sh.k8; c < sh.k; ++c)
        tail = fmaf(buf[sh.at(r, c + sh.left)], __fsub_rn((float)c, t_mean), tail);
    }
    float a[G];
#pragma unroll
    for (int i = 0; i < G; ++i) a[i] = __shfl_sync(FULL, acc, leader + i);
    float sum = 0.0f;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int i = 0; i < G; ++i) {
        if (G * q + i < sh.nwin) sum = __fadd_rn(sum, __shfl_sync(FULL, wsum[q], leader + i));
      }
    }
    const int64_t row = tile * sh.rt + r;
    if (j == 0 && row < m) {
      float dot;
      if (row < full)
        dot = __fadd_rn(__fadd_rn(__fadd_rn(a[0], a[1]), __fadd_rn(a[2], a[3])),
                        __fadd_rn(__fadd_rn(a[4], a[5]), __fadd_rn(a[6], a[7])));
      else
        dot = __fadd_rn(__fadd_rn(__fadd_rn(a[0], a[4]), __fadd_rn(a[2], a[6])),
                        __fadd_rn(__fadd_rn(a[1], a[5]), __fadd_rn(a[3], a[7])));
      if (sh.k8 < sh.k) dot = __fadd_rn(dot, tail);
      const float sl = __fdiv_rn(dot, denom);
      slope[row] = sl;
      theta[row] = __fsub_rn(__fmul_rn(sum, inv_k), __fmul_rn(sl, t_mean));
    }
    __syncthreads();  // the next iteration copies into this buffer
  }
}

// One row (M == 1): XLA's CPU code makes the product a vector dot, which
// LLVM vectorizes with 8 lanes; the order, read off the reference on the
// CPU (kernels/base_fit.py _dot_single), is:
// * K < 60: one chain of fmaf from 0.0 in column order;
// * else W = 8 * U columns a step (U = 4 accumulators, 2 below K = 64) over
//   the first N = K / W steps.  Lane l of accumulator u takes column
//   i * W + 8u + l at step i.  Up to 17 steps the code is unrolled and the
//   accumulators are folded into one chain a lane: accumulator 0's columns
//   in step order, then each next accumulator's in the order 1, 0, 2, 3, ...
//   From 18 steps it is a loop: four chains a lane, each from its own zero,
//   added as (((a0 + a1) + a2) + a3).  Lane 0 of accumulator 0 starts at
//   +0.0, every other lane at -0.0.  The 8 lanes then sum by halves:
//   ((l0 + l4) + (l2 + l6)) + ((l1 + l5) + (l3 + l7));
// * the R = K - N * W columns left: an epilogue of E lanes (E in 8, 4, 2,
//   or none; the least R / E + R % E steps, the smaller E on a tie) whose
//   lane 0 starts at the sum so far, chains of fmaf over floor(R / E)
//   chunks, summed by halves; then the last columns by fmaf, one by one.
// One thread computes it (a single row is a few microseconds of chains);
// the mean is the multi-row kernel's windowed sum.
__device__ __forceinline__ float tc_at(int c, float t_mean) { return __fsub_rn((float)c, t_mean); }

__device__ float halves(float* v, int n) {
  for (int h = n / 2; h >= 1; h /= 2)
    for (int i = 0; i < h; ++i) v[i] = __fadd_rn(v[i], v[i + h]);
  return v[0];
}

__global__ void base_fit_row_kernel(const float* __restrict__ x, int k, float denom,
                                    float inv_k, float t_mean, float* __restrict__ theta,
                                    float* __restrict__ slope) {
  if (threadIdx.x != 0) return;
  float dot = 0.0f;
  int pos = 0;
  if (k >= 60) {
    const int u_n = k >= 64 ? 4 : 2, w = 8 * u_n, steps = k / w;
    float s[8];
    if (steps <= 17) {
      for (int l = 0; l < 8; ++l) s[l] = l ? -0.0f : 0.0f;
      for (int i = 0; i < steps; ++i)
        for (int l = 0; l < 8; ++l) s[l] = fmaf(x[i * w + l], tc_at(i * w + l, t_mean), s[l]);
      for (int u = 1; u < u_n; ++u)
        for (int o = 0; o < steps; ++o) {
          const int i = o < 2 ? 1 - o : o;
          for (int l = 0; l < 8; ++l) {
            const int c = i * w + 8 * u + l;
            s[l] = fmaf(x[c], tc_at(c, t_mean), s[l]);
          }
        }
    } else {
      for (int l = 0; l < 8; ++l) {
        float acc[4];
        for (int u = 0; u < u_n; ++u) {
          acc[u] = (u || l) ? -0.0f : 0.0f;
          for (int i = 0; i < steps; ++i) {
            const int c = i * w + 8 * u + l;
            acc[u] = fmaf(x[c], tc_at(c, t_mean), acc[u]);
          }
        }
        s[l] = acc[0];
        for (int u = 1; u < u_n; ++u) s[l] = __fadd_rn(acc[u], s[l]);
      }
    }
    dot = halves(s, 8);
    pos = steps * w;
    const int rem = k - pos;
    int e = 1, cost = rem;
    for (int v = 2; v <= 8; v *= 2)
      if (rem / v + rem % v < cost) e = v, cost = rem / v + rem % v;
    if (e > 1) {
      float ev[8];
      for (int l = 0; l < e; ++l) ev[l] = l ? -0.0f : dot;
      for (int c = 0; c < rem / e; ++c)
        for (int l = 0; l < e; ++l) {
          const int col = pos + c * e + l;
          ev[l] = fmaf(x[col], tc_at(col, t_mean), ev[l]);
        }
      dot = halves(ev, e);
      pos += rem / e * e;
    }
  }
  for (int c = pos; c < k; ++c) dot = fmaf(x[c], tc_at(c, t_mean), dot);
  // the mean: the multi-row kernel's windows of 32, zero-padded evenly
  float sum = 0.0f;
  if (k <= 32) {
    for (int c = 0; c < k; ++c) sum = __fadd_rn(sum, x[c]);
  } else {
    const int nwin = (k + 31) / 32, left = (nwin * 32 - k) / 2;
    for (int wi = 0; wi < nwin; ++wi) {
      float ws = 0.0f;
      for (int p = 32 * wi; p < 32 * wi + 32; ++p) {
        const int c = p - left;
        ws = __fadd_rn(ws, c >= 0 && c < k ? x[c] : 0.0f);
      }
      sum = __fadd_rn(sum, ws);
    }
  }
  const float sl = __fdiv_rn(dot, denom);
  slope[0] = sl;
  theta[0] = __fsub_rn(__fmul_rn(sum, inv_k), __fmul_rn(sl, t_mean));
}

}  // namespace

extern "C" {
int base_fit(const float* xb, int64_t m, int k, float denom, float inv_k, float t_mean,
             float* theta, float* slope, cudaStream_t stream) {
  if (k < 1 || k > 1024) return (int)cudaErrorInvalidValue;
  if (m <= 0) return (int)cudaGetLastError();
  if (m == 1) {
    base_fit_row_kernel<<<1, 32, 0, stream>>>(xb, k, denom, inv_k, t_mean, theta, slope);
    return (int)cudaGetLastError();
  }
  const Shape sh(k);
  const int threads = G * sh.rt;
  const size_t smem = NBUF * (size_t)sh.rt * sh.rs * sizeof(float);
  // above 48 KB a block's dynamic shared memory must be asked for
  cudaError_t e = cudaFuncSetAttribute(base_fit_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  // one wave of resident blocks, each walking every gridDim-th tile
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, base_fit_kernel, threads, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) per_sm = 1;
  const int64_t ntiles = (m + sh.rt - 1) / sh.rt;
  const int64_t blocks = ntiles < (int64_t)sms * per_sm ? ntiles : (int64_t)sms * per_sm;
  const bool vec = k % 4 == 0 && sh.left % 4 == 0 && (uintptr_t)xb % 16 == 0;
  base_fit_kernel<<<(unsigned)blocks, threads, smem, stream>>>(xb, m, k, vec, denom, inv_k,
                                                               t_mean, theta, slope);
  return (int)cudaGetLastError();
}
}

// Causal (or full) softmax attention with an online softmax, for Hopper,
// sm_90a: the prefill and forward attention of the dense models.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py:
//   flash_attention  <- _flash_kernel / flash_attention_pallas
// For q [B, Sq, H, D] and k, v [B, Sk, KV, D] (bf16 or float32, the
// models' own layout; query head h reads KV head h / (H / KV), so grouped
// queries need no repeat of K and V in memory):
//   out = softmax(q k^T * scale, causal: kpos <= qpos) v      (in q's type)
// with the semantics of the Pallas kernel: the running max m, the running
// sum l and the accumulator in float32; masked scores are -1e30, keys past
// Sk -inf; KV tiles wholly past the diagonal are skipped; the output is
// acc / max(l, 1e-30).  Sq and Sk need not be multiples of a tile: the
// kernel masks the tails and the host pads nothing.
// Given an lse pointer, both kernels also write each row's log-sum-exp,
// lse = m + log(max(l, 1e-30)) in natural log, float32 [B, H, Sq]: the
// backward (csrc/flash_attention_bwd.cu) rebuilds p = exp(s - lse) from it.
// A null pointer writes nothing (prefill and decode); the output's bits
// are the same either way.
//
// What bounds it: 4 x B x H x D x (causal pairs) operations against
// Q + K + V + O bytes once, some 800 operations a byte at the models'
// shapes, so the tensor cores' bf16 rate bounds it.
//
// bf16 (the models' route): tensor cores, fed by the Tensor Memory
// Accelerator (the mbarrier, TMA and wgmma blocks are in csrc/hopper.cuh,
// shared with the backward).  A block owns 128 query rows of one (batch, head): two
// consumer warpgroups of 64 rows each and one producer warp (a third
// warpgroup, whose other warps leave at once; setmaxnreg moves registers
// from it to the consumers).  The head dim is padded to DP, a multiple of
// 64 (64, 128, 192 or 256), with zeros that TMA fills past D.
// * Shared memory: Q [128 x DP] once, and a ring of 2 stages of K and of V
//   [BK x DP] (BK = 128 keys for DP <= 128, 64 above), each tile as DP / 64
//   boxes of 64 columns (128 bytes a row, the 128-byte swizzle).  The
//   producer loads them with cp.async.bulk.tensor through 4-D tensor maps
//   over [B, S, heads, D]; each stage has a "full" mbarrier (TMA bytes
//   arrive) and an "empty" one (every consumer warp has read it), K and V
//   apart so that Q k^T starts before V lands.
// * S = Q K^T: wgmma m64nBKk16, Q and K both from shared memory (K-major),
//   float32 accumulators in registers; the bf16 products are exact in
//   float32.
// * The online softmax in registers on the accumulator fragment (a thread
//   holds two rows; a row's max and sum reduce over its quad of lanes), in
//   the base-2 domain (scores times scale x log2 e, ex2).  Only the tiles
//   that cross the diagonal or the end of the keys are masked.
// * O += P V: wgmma m64n64k16 with P from registers (the accumulator
//   fragment is the A fragment's layout) and V from shared memory
//   (MN-major: the descriptor transposes it), one per 64 columns of DP.
//   P's precision: the reference multiplies V by float32 probabilities.  P
//   goes in as two bf16 terms, hi = bf16(p) and lo = bf16(p - hi), in two
//   wgmmas into the same float32 accumulator: about 16 bits of p, at 1.5x
//   the tensor work of one bf16 P (a TF32 P V would need V transposed in
//   shared memory and runs at half the bf16 rate).
// * The epilogue divides by max(l, 1e-30), converts the base-2 max to
//   lse once (m ln 2 + log l), writes bf16 into the
//   warpgroup's own rows of the Q tile (swizzled, no bank conflicts), and
//   stores 16-byte chunks.
// * Grid: one block per (q tile, head, batch), the last q tiles first, so
//   that the longest causal rows start first and the short ones fill the
//   tail.
// A tensor map needs 16-byte-aligned bases and strides, so bf16 with D %
// 8 != 0, a base pointer off 16 bytes, or Sk = 0 takes the scalar kernel
// below (decided here from the shapes and pointers; nothing falls back
// after a failure).
//
// float32 (no model path; held to 2e-5, finer than bf16 tensor cores
// give): the scalar kernel.  One block of 256 threads per (q tile of 64
// rows, head, batch); Q and each K and V tile of 64 keys sit in shared
// memory as float32 (Q and K rows padded to an odd stride); each thread
// owns a 4 x 4 block of the score tile and 4 rows x NJ columns of the
// accumulator; row maxima and sums reduce over 16 lanes with shuffles;
// scalar float32 arithmetic on the CUDA cores, products and sums kept apart
// (--fmad=false).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace scalar {


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
                 T* __restrict__ o, float* __restrict__ lse, int sq, int sk, int h, int kvh,
                 int d, float scale, int causal) {
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
    if (lse != nullptr && tx == 0) lse[((size_t)b * h + head) * sq + qpos] = m[i] + logf(den);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = tx + 16 * j;
      if (col < d) ob[(size_t)qpos * qrow + col] = from_f<T>(acc[i][j] / den);
    }
  }
}

template <typename T, int NJ>
int run(const T* q, const T* k, const T* v, T* o, float* lse, int b, int sq, int sk, int h,
        int kvh, int d, float scale, int causal, cudaStream_t stream) {
  const size_t smem = ((size_t)(BQ + BK) * (d + 1) + (size_t)BK * d + (size_t)BQ * (BK + 1)) *
                      sizeof(float);
  // above 48 KB a block's dynamic shared memory must be asked for
  cudaError_t e = cudaFuncSetAttribute(flash_kernel<T, NJ>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((sq + BQ - 1) / BQ, h, b);
  flash_kernel<T, NJ><<<grid, THREADS, smem, stream>>>(q, k, v, o, lse, sq, sk, h, kvh, d,
                                                       scale, causal);
  return (int)cudaGetLastError();
}

// NJ = accumulator columns a thread: the head dim over 16, rounded up to
// an instantiated width (16, 32, 64, 128, 160 and 256 are exact).
template <typename T>
int launch(const T* q, const T* k, const T* v, T* o, float* lse, int b, int sq, int sk, int h,
           int kvh, int d, float scale, int causal, cudaStream_t stream) {
  if (d <= 0 || d > 256 || d % 2 || kvh <= 0 || h % kvh) return (int)cudaErrorInvalidValue;
  const int nj = (d + 15) / 16;
  if (nj <= 1) return run<T, 1>(q, k, v, o, lse, b, sq, sk, h, kvh, d, scale, causal, stream);
  if (nj <= 2) return run<T, 2>(q, k, v, o, lse, b, sq, sk, h, kvh, d, scale, causal, stream);
  if (nj <= 4) return run<T, 4>(q, k, v, o, lse, b, sq, sk, h, kvh, d, scale, causal, stream);
  if (nj <= 8) return run<T, 8>(q, k, v, o, lse, b, sq, sk, h, kvh, d, scale, causal, stream);
  if (nj <= 10) return run<T, 10>(q, k, v, o, lse, b, sq, sk, h, kvh, d, scale, causal, stream);
  return run<T, 16>(q, k, v, o, lse, b, sq, sk, h, kvh, d, scale, causal, stream);
}

}  // namespace scalar

namespace tc {

using namespace hopper;

constexpr int BQ = 128;             // q rows a block: two consumer warpgroups of 64
constexpr int STAGES = 2;           // K and V tiles in flight
constexpr int CONSUMER_WARPS = 8;
constexpr int THREADS = 32 * CONSUMER_WARPS + 128;  // and the producer's warpgroup
constexpr float NEG = -1e30f;

template <int DP>
struct Tile {
  static constexpr int BK = DP <= 128 ? 128 : 64;  // keys a tile
  static constexpr int BOXES = DP / 64;            // 64-column boxes of a row
  static constexpr uint32_t Q_BYTES = BQ * DP * 2;
  static constexpr uint32_t KV_BYTES = BK * DP * 2;
  // Q, the K stages, the V stages, then 9 mbarriers; 1 KB to align to 1024
  static constexpr int SMEM = Q_BYTES + 2 * STAGES * KV_BYTES + 128 + 1024;
};

template <int DP>
__global__ void __launch_bounds__(THREADS, 1)
    flash_tc_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                    float* __restrict__ lse, int sq, int sk, int h, int kvh, int d,
                    float scale_log2, int causal) {
  using T = Tile<DP>;
  constexpr int BK = T::BK;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t qs = (raw + 1023) & ~1023u;  // the swizzle repeats every 1024 bytes
  const uint32_t ks = qs + T::Q_BYTES;        // K stage s at ks + s * KV_BYTES
  const uint32_t vs = ks + STAGES * T::KV_BYTES;
  const uint32_t bars = vs + STAGES * T::KV_BYTES;
  const uint32_t full_q = bars;               // then full_k[s], full_v[s], empty_k[s], empty_v[s]
#define FULL_K(s) (bars + 8 * (1 + (s)))
#define FULL_V(s) (bars + 8 * (1 + STAGES + (s)))
#define EMPTY_K(s) (bars + 8 * (1 + 2 * STAGES + (s)))
#define EMPTY_V(s) (bars + 8 * (1 + 3 * STAGES + (s)))

  // the last q tiles first: blockIdx.x walks (head, batch) fastest
  const int ntq = (sq + BQ - 1) / BQ;
  const int hb = gridDim.x / ntq;
  const int q0 = (ntq - 1 - (int)(blockIdx.x / hb)) * BQ;
  const int head = (int)(blockIdx.x % hb) % h;
  const int b = (int)(blockIdx.x % hb) / h;
  const int kv_end = causal ? min(sk, q0 + BQ) : sk;  // skip tiles past the diagonal
  const int ntiles = (kv_end + BK - 1) / BK;

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
      mbar_expect_tx(full_q, T::Q_BYTES);
#pragma unroll
      for (int x = 0; x < T::BOXES; ++x)
        tma_load(qs + x * BQ * 128, &tq, full_q, 64 * x, head, q0, b);
      for (int i = 0; i < ntiles; ++i) {
        const int s = i % STAGES;
        const uint32_t parity = ((i / STAGES) & 1) ^ 1;  // the first round finds the stage empty
        mbar_wait(EMPTY_K(s), parity);
        mbar_expect_tx(FULL_K(s), T::KV_BYTES);
#pragma unroll
        for (int x = 0; x < T::BOXES; ++x)
          tma_load(ks + s * T::KV_BYTES + x * BK * 128, &tk, FULL_K(s), 64 * x, kvhead, i * BK, b);
        mbar_wait(EMPTY_V(s), parity);
        mbar_expect_tx(FULL_V(s), T::KV_BYTES);
#pragma unroll
        for (int x = 0; x < T::BOXES; ++x)
          tma_load(vs + s * T::KV_BYTES + x * BK * 128, &tv, FULL_V(s), 64 * x, kvhead, i * BK, b);
      }
    }
  } else {
    // consumers: warpgroup w owns rows q0 + 64 w .. + 63
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int w = warp / 4;
    const int qb = q0 + 64 * w;
    const int r_lo = 16 * (warp % 4) + lane / 4;  // a thread's rows: r_lo and r_lo + 8
    const int cq = 2 * (lane % 4);                // its columns in each 8-column chunk
    float oacc[DP / 64][32];
#pragma unroll
    for (int p = 0; p < DP / 64; ++p)
#pragma unroll
      for (int e = 0; e < 32; ++e) oacc[p][e] = 0.f;
    float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
    mbar_wait(full_q, 0);
    // Every row a warpgroup computes has an unmasked key in tile 0, which
    // holds key 0 (kpos 0 <= any qpos, and 0 < Sk): so m is a real score
    // after the first tile, and no row ends with l = 0.  A tile wholly past
    // the warpgroup's last row (BK < BQ) is consumed without computing.
    for (int i = 0; i < ntiles; ++i) {
      const int s = i % STAGES;
      const uint32_t parity = (i / STAGES) & 1;
      const int k0 = i * BK;
      mbar_wait(FULL_K(s), parity);
      if (causal && k0 > qb + 63) {
        if (lane == 0) mbar_arrive(EMPTY_K(s));
        mbar_wait(FULL_V(s), parity);
        if (lane == 0) mbar_arrive(EMPTY_V(s));
        continue;
      }
      float sacc[BK / 2];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;  // 16 columns = 32 bytes into box kk / 4
        const uint64_t da = desc(qs + (kk / 4) * BQ * 128 + w * 64 * 128 + off, 16, 1024);
        const uint64_t db = desc(ks + s * T::KV_BYTES + (kk / 4) * BK * 128 + off, 16, 1024);
        if constexpr (BK == 128)
          wgmma_ss_n128(sacc, da, db, kk > 0);
        else
          wgmma_ss_n64(sacc, da, db, kk > 0);
      }
      wg_commit();
      wg_wait0();
      pin(sacc);
      if (lane == 0) mbar_arrive(EMPTY_K(s));

      // scores in the base-2 domain, masked where the tile needs it
      const bool edge = (causal && k0 + BK - 1 > qb) || k0 + BK > sk;
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int e = 0; e < BK / 2; ++e) {
        float t = sacc[e] * scale_log2;
        if (edge) {
          const int key = k0 + 8 * (e / 4) + cq + (e & 1);
          const int row = qb + r_lo + 8 * ((e >> 1) & 1);
          if (causal && key > row) t = NEG;
          if (key >= sk) t = -INFINITY;  // past the keys: no weight at all
        }
        sacc[e] = t;
        mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], t);
      }
      float alpha[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
        const float m_new = fmaxf(m[hh], mx[hh]);
        alpha[hh] = ex2(m[hh] - m_new);
        m[hh] = m_new;
        l[hh] = l[hh] * alpha[hh];
      }
#pragma unroll
      for (int p = 0; p < DP / 64; ++p)
#pragma unroll
        for (int e = 0; e < 32; ++e) oacc[p][e] = oacc[p][e] * alpha[(e >> 1) & 1];
      // P as A fragments: for keys 16 kk.., register r holds the pair at
      // row half (r & 1) of 8-column chunk 2 kk + r / 2: accumulator
      // entries 8 kk + 2 r and 8 kk + 2 r + 1
      uint32_t phi[BK / 16][4], plo[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int e = 8 * kk + 2 * r;
          const float p0 = ex2(sacc[e] - m[r & 1]);
          const float p1 = ex2(sacc[e + 1] - m[r & 1]);
          l[r & 1] = l[r & 1] + p0 + p1;
          const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
          const float2 hf = __bfloat1622float2(hi);
          phi[kk][r] = bits(hi);
          plo[kk][r] = bits(__floats2bfloat162_rn(p0 - hf.x, p1 - hf.y));
        }

      mbar_wait(FULL_V(s), parity);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int p = 0; p < DP / 64; ++p) {
          // 16 keys = 2048 bytes down a box; box p holds columns 64 p..
          const uint64_t db = desc(vs + s * T::KV_BYTES + p * BK * 128 + kk * 2048, BK * 128, 1024);
          wgmma_rs_n64(oacc[p], phi[kk], db);
          wgmma_rs_n64(oacc[p], plo[kk], db);
        }
      wg_commit();
      wg_wait0();
#pragma unroll
      for (int p = 0; p < DP / 64; ++p) pin(oacc[p]);
      if (lane == 0) mbar_arrive(EMPTY_V(s));
    }

    // epilogue: O / max(l, 1e-30) in bf16 through this warpgroup's rows of
    // the Q tile (its last reader was this warpgroup's last Q K^T)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      l[hh] = l[hh] + __shfl_xor_sync(0xffffffffu, l[hh], 1);
      l[hh] = l[hh] + __shfl_xor_sync(0xffffffffu, l[hh], 2);
      l[hh] = fmaxf(l[hh], 1e-30f);
      // lse in natural log: m is the row's largest score in base 2
      const int row = qb + r_lo + 8 * hh;
      if (lse != nullptr && cq == 0 && row < sq)
        lse[((size_t)b * h + head) * sq + row] = m[hh] * 0.6931471805599453f + logf(l[hh]);
    }
    bar_sync(1 + w, 128);
    uint8_t* qgen = smem_raw + (qs - raw);
#pragma unroll
    for (int p = 0; p < DP / 64; ++p)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = r_lo + 8 * hh;
          const __nv_bfloat162 y = __floats2bfloat162_rn(oacc[p][4 * j + 2 * hh] / l[hh],
                                                         oacc[p][4 * j + 2 * hh + 1] / l[hh]);
          *reinterpret_cast<uint32_t*>(qgen + p * BQ * 128 + (64 * w + r) * 128 +
                                       ((j ^ (r & 7)) * 16) + cq * 2) = bits(y);
        }
    bar_sync(1 + w, 128);
    const size_t orow = (size_t)h * d;  // elements between positions of o
    for (int idx = threadIdx.x % 128; idx < 64 * (DP / 8); idx += 128) {
      const int r = idx / (DP / 8), c8 = idx % (DP / 8);
      const int qpos = qb + r;
      if (qpos < sq && c8 * 8 < d) {
        const uint4 y = *reinterpret_cast<const uint4*>(
            qgen + (c8 / 8) * BQ * 128 + (64 * w + r) * 128 + (((c8 % 8) ^ (r & 7)) * 16));
        *reinterpret_cast<uint4*>(o + ((size_t)b * sq + qpos) * orow + (size_t)head * d + c8 * 8) = y;
      }
    }
  }
#undef FULL_K
#undef FULL_V
#undef EMPTY_K
#undef EMPTY_V
}

template <int DP>
int run(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v, __nv_bfloat16* o,
        float* lse, int b, int sq, int sk, int h, int kvh, int d, float scale, int causal,
        cudaStream_t stream) {
  using T = Tile<DP>;
  if (encoder() == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap mq, mk, mv;
  if (!tensor_map(&mq, q, b, sq, h, d, BQ) || !tensor_map(&mk, k, b, sk, kvh, d, T::BK) ||
      !tensor_map(&mv, v, b, sk, kvh, d, T::BK))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(flash_tc_kernel<DP>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (e != cudaSuccess) return (int)e;
  const unsigned blocks = (unsigned)((sq + BQ - 1) / BQ) * (unsigned)h * (unsigned)b;
  const float scale_log2 = (float)((double)scale * 1.4426950408889634);
  flash_tc_kernel<DP><<<blocks, THREADS, T::SMEM, stream>>>(mq, mk, mv, o, lse, sq, sk, h, kvh,
                                                             d, scale_log2, causal);
  return (int)cudaGetLastError();
}

}  // namespace tc

// lse [B, H, Sq] float32 (natural log) is written when not null; *route
// (when not null) is set to 1 for the tensor-core kernel, 0 for the scalar one.
extern "C" {
int flash_attention_f32(const float* q, const float* k, const float* v, float* o, float* lse,
                        int b, int sq, int sk, int h, int kvh, int d, float scale, int causal,
                        cudaStream_t stream, int* route) {
  if (route != nullptr) *route = 0;
  return scalar::launch<float>(q, k, v, o, lse, b, sq, sk, h, kvh, d, scale, causal, stream);
}
int flash_attention_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                         __nv_bfloat16* o, float* lse, int b, int sq, int sk, int h, int kvh, int d,
                         float scale, int causal, cudaStream_t stream, int* route) {
  if (d <= 0 || d > 256 || d % 2 || kvh <= 0 || h % kvh) return (int)cudaErrorInvalidValue;
  const bool tensor_cores = d % 8 == 0 && sk > 0 && hopper::aligned16(q) &&
                            hopper::aligned16(k) && hopper::aligned16(v) && hopper::aligned16(o);
  if (route != nullptr) *route = tensor_cores;
  if (!tensor_cores)
    return scalar::launch<__nv_bfloat16>(q, k, v, o, lse, b, sq, sk, h, kvh, d, scale, causal,
                                         stream);
  if (d <= 64) return tc::run<64>(q, k, v, o, lse, b, sq, sk, h, kvh, d, scale, causal, stream);
  if (d <= 128) return tc::run<128>(q, k, v, o, lse, b, sq, sk, h, kvh, d, scale, causal, stream);
  if (d <= 192) return tc::run<192>(q, k, v, o, lse, b, sq, sk, h, kvh, d, scale, causal, stream);
  return tc::run<256>(q, k, v, o, lse, b, sq, sk, h, kvh, d, scale, causal, stream);
}
}

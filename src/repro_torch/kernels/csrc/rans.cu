// Interleaved 32-bit rANS coder (K <= 64 lanes, 12-bit probabilities,
// 16-bit renormalisation) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernels repro/kernels/rans.py:
//   rans_encode  <- _rans_encode_kernel / rans_encode_pallas
//   rans_decode  <- _rans_decode_kernel / rans_decode_pallas
// The TPU ran the step axis as its sequential grid with the [R, K] states in
// VMEM scratch.  Here each interleaved state lives in a register of the
// thread that walks its steps, and a row's tables live in shared memory.
// The encoder gives one block to a (stream, plane) row, thread `lane` owning
// state `lane`; the decoder gives one warp to a row (see below).  Rows are
// independent, so blocks and warps need nothing from each other.
//
// Layout: a row's cells are [steps, K] row-major (cell t * K + lane), which
// is decoder order; symbol 256 is the identity pad (freq = M, cum = 0: the
// transform is x -> x and the renorm threshold wraps to "never").
//
// Bound on the card: per cell a few integer operations (one 32-bit division)
// against 5 bytes moved (2 read, 3 written) when encoding and about 3 when
// decoding, so by the roofline both are bound by memory bytes.  In practice
// each lane is a serial chain of `steps` dependent updates and a row has at
// most 64 lanes, so a launch of a few rows takes the time of one chain: the
// designs keep that chain in registers and shared memory, with no
// device-memory round trip on it.
#include <cuda_runtime.h>
#include <stdint.h>

#define PROB_BITS 12
#define RANS_M (1u << PROB_BITS)
#define RANS_L (1u << 16)
#define ID_SYM 256
#define THREADS 64

__global__ void rans_encode_kernel(const int16_t* __restrict__ sym, int cols, int K,
                                   const int64_t* __restrict__ freqs,
                                   int64_t* __restrict__ states, bool* __restrict__ need,
                                   int16_t* __restrict__ vals) {
  __shared__ uint32_t f[ID_SYM + 1];
  __shared__ uint32_t c[ID_SYM + 1];
  const int row = blockIdx.x;
  const int lane = threadIdx.x;
  for (int j = lane; j < ID_SYM; j += blockDim.x) f[j] = (uint32_t)freqs[(size_t)row * 256 + j];
  __syncthreads();
  if (lane == 0) {
    uint32_t acc = 0;
    for (int j = 0; j < ID_SYM; ++j) {
      c[j] = acc;
      acc += f[j];
    }
    f[ID_SYM] = RANS_M;
    c[ID_SYM] = 0;
  }
  __syncthreads();
  if (lane >= K) return;
  const int steps = cols / K;
  const size_t base = (size_t)row * cols;
  uint32_t x = RANS_L;
  for (int t = steps - 1; t >= 0; --t) {
    const size_t i = base + (size_t)t * K + lane;
    const int s = sym[i];
    const uint32_t fs = f[s];
    // x >= f << 20, written as x > (f << 20) - 1 in uint32: for f == M the
    // shift wraps to 0 and the threshold to the uint32 max
    const bool nd = x > ((fs << (32 - PROB_BITS)) - 1u);
    need[i] = nd;
    vals[i] = (int16_t)(uint16_t)(x & 0xFFFFu);
    if (nd) x >>= 16;
    x = ((x / fs) << PROB_BITS) + (x % fs) + c[s];
  }
  states[(size_t)row * K + lane] = (int64_t)x;
}

// ---- decode: one warp a row ------------------------------------------------
//
// A row's 64 lanes live in one warp: thread wl owns lanes wl and wl + 32, so
// the ranks of the renormalising lanes come from two ballots of the same warp
// (lower half popc(b_lo & lt), upper half popc(b_lo) + popc(b_hi & lt)) and
// the step loop needs no block barrier.  What bounds a launch of a few rows
// is one lane's chain of steps, each: one shared load of the packed slot
// entry (symbol | (f - 1) << 8 | (slot - c) << 20), a multiply-add, the
// ballot and a popcount for the rank, and, if the lane renormalises, one
// shared load of its word.  The words reach shared memory through a ring of
// two 256-word chunks; the chunk after them waits in registers, loaded when
// pos entered the current chunk, so device memory stays off the chain.  A
// step reads at most 64 words, so the ring covers four steps from any pos
// and the refill is checked once every four steps.
#define DEC_WARPS 4
#define CHUNK 256
#define RING (2 * CHUNK)
#define CHUNK_REGS (CHUNK / 32)
#define UNROLL 4

struct RowSmem {
  uint32_t tab[RANS_M];          // packed slot entries
  uint32_t nz[256 + 4];          // symbols that own slots, in order: sym | (f - 1) << 8 | c << 20
  uint32_t starts[RANS_M / 32];  // bit i: slot i starts a symbol's range
  uint32_t before[RANS_M / 32];  // set bits of starts[] before each word
  uint16_t ring[RING];           // words [256 c, 256 c + 512) of the row, c = pos / 256
};
#define DEC_SMEM (DEC_WARPS * sizeof(RowSmem))

// words [256 c, 256 c + 256) of the row, lane wl's eight (0 past the row's words)
__device__ __forceinline__ void load_chunk(uint16_t (&r)[CHUNK_REGS], const int16_t* w,
                                           int64_t wcnt, int64_t c, int wl) {
#pragma unroll
  for (int j = 0; j < CHUNK_REGS; ++j) {
    const int64_t g = c * CHUNK + wl + 32 * j;
    r[j] = g < wcnt ? (uint16_t)w[g] : (uint16_t)0;
  }
}

__device__ __forceinline__ void store_chunk(uint16_t* ring, const uint16_t (&r)[CHUNK_REGS],
                                            int64_t c, int wl) {
  const int at = (int)(c & 1) * CHUNK;
#pragma unroll
  for (int j = 0; j < CHUNK_REGS; ++j) ring[at + wl + 32 * j] = r[j];
}

// Exclusive prefix sum over the warp.
__device__ __forceinline__ uint32_t warp_excl(uint32_t v, int wl) {
  uint32_t incl = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t u = __shfl_up_sync(0xffffffffu, incl, d);
    if (wl >= d) incl += u;
  }
  return incl - v;
}

// The slot table, built by the warp with no serial walk, so no thread's
// work depends on the table's skew: the cumulative frequencies by a warp
// scan (a thread sums eight symbols); the symbols that own slots compacted
// in order and their first slots marked in a 4096-bit map; then slot s
// belongs to the r-th of them, r = the marks at or before s (a popcount).
// Thread wl fills slots 128 i + 4 wl .. + 3 for i < 32, so a warp's 16-byte
// stores cover 512 consecutive bytes.
__device__ __forceinline__ void build_tables(RowSmem& sm, const uint32_t (&f)[8], int wl) {
  uint32_t c[8], acc = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    c[j] = acc;
    acc += f[j];
  }
  const uint32_t base = warp_excl(acc, wl);
  uint32_t own = 0;  // this thread's symbols that own slots
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    c[j] += base;
    if (f[j] != 0u && c[j] < RANS_M) own |= 1u << j;
  }
  uint32_t k = warp_excl(__popc(own), wl);
#pragma unroll
  for (int j = 0; j < 4; ++j) sm.starts[4 * wl + j] = 0u;
  if (wl == 0) sm.nz[0] = 0u;  // a table that owns no slot still reads entry 0
  __syncwarp();
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (own >> j & 1u) {
      sm.nz[k++] = (uint32_t)(8 * wl + j) | ((f[j] - 1u) & 0xFFFu) << 8 | c[j] << 20;
      atomicOr(&sm.starts[c[j] >> 5], 1u << (c[j] & 31));
    }
  }
  __syncwarp();
  uint32_t word[4], loc[4], cnt = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    word[j] = sm.starts[4 * wl + j];
    loc[j] = cnt;
    cnt += __popc(word[j]);
  }
  const uint32_t pre = warp_excl(cnt, wl);
#pragma unroll
  for (int j = 0; j < 4; ++j) sm.before[4 * wl + j] = pre + loc[j];
  __syncwarp();
  const uint32_t bit = (4u * wl) & 31u;  // the first slot's bit in its word, the same for every i
#pragma unroll 4
  for (int i = 0; i < 32; ++i) {
    const uint32_t slot0 = 128u * i + 4u * wl;
    const uint32_t m = sm.starts[slot0 >> 5], b = sm.before[slot0 >> 5];
    uint32_t e[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint32_t r = b + __popc(m & (0xFFFFFFFFu >> (31u - bit - q)));
      const uint32_t ent = sm.nz[r > 0u ? r - 1u : 0u];
      // a table that sums below M leaves its last slots to its last symbol
      // with fields cut to 12 bits: wrong symbols, never an access out of range
      e[q] = (ent & 0xFFFFFu) | ((slot0 + q - (ent >> 20)) & 0xFFFu) << 20;
    }
    *reinterpret_cast<uint4*>(&sm.tab[slot0]) = make_uint4(e[0], e[1], e[2], e[3]);
  }
  __syncwarp();
}

// One step of a lane: x -> f (x >> 12) + slot - c, written as
// (f - 1) xs + (xs + slot - c) so the multiply waits on one field only.
__device__ __forceinline__ uint32_t advance(uint32_t x, uint32_t e) {
  const uint32_t xs = x >> PROB_BITS;
  return ((e >> 8) & 0xFFFu) * xs + (xs + (e >> 20));
}

__global__ void __launch_bounds__(32 * DEC_WARPS)
rans_decode_kernel(const int64_t* __restrict__ states, int rows, int K,
                   const int64_t* __restrict__ freqs, const int16_t* __restrict__ words,
                   const int64_t* __restrict__ word_off, const int64_t* __restrict__ word_cnt,
                   const int64_t* __restrict__ ns, int64_t cols, uint8_t* __restrict__ syms,
                   int64_t* __restrict__ used) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5;
  const int wl = threadIdx.x & 31;
  const int row = blockIdx.x * DEC_WARPS + warp;
  if (row >= rows) return;  // the whole warp: no block barrier below
  RowSmem& sm = reinterpret_cast<RowSmem*>(smem_raw)[warp];
  uint8_t* out = syms + (int64_t)row * cols;
  // the caller passes cols >= ceil(ns / K) * K; a shorter one never writes past the row
  const int64_t n = min(ns[row], cols);
  int64_t pos = 0;
  if (n > 0) {
    uint32_t f[8];  // the row's frequencies, asked for first: the tables wait on them
#pragma unroll
    for (int j = 0; j < 8; ++j) f[j] = (uint32_t)freqs[(int64_t)row * 256 + 8 * wl + j];
    const int16_t* w = words + word_off[row];
    const int64_t wcnt = word_cnt[row];
    // the first three chunks are asked for before the tables are built
    uint16_t r0[CHUNK_REGS], r1[CHUNK_REGS], pre[CHUNK_REGS];
    load_chunk(r0, w, wcnt, 0, wl);
    load_chunk(r1, w, wcnt, 1, wl);
    load_chunk(pre, w, wcnt, 2, wl);
    const bool has0 = wl < K, has1 = wl + 32 < K;
    // lanes past K carry junk states that never renormalise or store
    uint32_t x0 = has0 ? (uint32_t)states[(int64_t)row * K + wl] : 0u;
    uint32_t x1 = has1 ? (uint32_t)states[(int64_t)row * K + wl + 32] : 0u;
    build_tables(sm, f, wl);
    store_chunk(sm.ring, r0, 0, wl);
    store_chunk(sm.ring, r1, 1, wl);
    __syncwarp();
    const uint32_t lt = (1u << wl) - 1u;
    const int64_t groups = ((n + K - 1) / K + UNROLL - 1) / UNROLL;
    int64_t chunk = 0;  // pos / CHUNK at the last refill check
    uint8_t* o = out;   // the step's first cell
    int64_t left = n;   // cells from o to the row's end
    for (int64_t g = 0; g < groups; ++g) {
#pragma unroll
      for (int u = 0; u < UNROLL; ++u, o += K, left -= K) {
        // steps past the row's last are all inactive: their ballots are 0
        const bool a0 = has0 && wl < left;
        const bool a1 = has1 && wl + 32 < left;
        const uint32_t e0 = sm.tab[x0 & (RANS_M - 1)];
        const uint32_t e1 = sm.tab[x1 & (RANS_M - 1)];
        x0 = advance(x0, e0);
        x1 = advance(x1, e1);
        const bool n0 = a0 && x0 < RANS_L;
        const bool n1 = a1 && x1 < RANS_L;
        const uint32_t b0 = __ballot_sync(0xffffffffu, n0);
        const uint32_t b1 = __ballot_sync(0xffffffffu, n1);
        const uint32_t lo_cnt = __popc(b0);
        const uint32_t p = (uint32_t)pos;
        if (n0) x0 = (x0 << 16) | sm.ring[(p + __popc(b0 & lt)) & (RING - 1)];
        if (n1) x1 = (x1 << 16) | sm.ring[(p + lo_cnt + __popc(b1 & lt)) & (RING - 1)];
        if (a0) o[wl] = (uint8_t)(e0 & 0xFFu);
        if (a1) o[wl + 32] = (uint8_t)(e1 & 0xFFu);
        pos += lo_cnt + __popc(b1);
      }
      if ((pos >> 8) != chunk) {  // warp-uniform: pos entered the next chunk
        ++chunk;
        __syncwarp();  // every lane's reads of the chunk before are done
        store_chunk(sm.ring, pre, chunk + 1, wl);
        __syncwarp();
        load_chunk(pre, w, wcnt, chunk + 2, wl);
      }
    }
  }
  // every cell past the row's symbols is 0, so the output needs no memset
  for (int64_t i = (n > 0 ? n : 0) + wl; i < cols; i += 32) out[i] = 0;
  if (wl == 0) used[row] = pos;
}

extern "C" int rans_encode(const int16_t* sym, int rows, int cols, int K,
                           const int64_t* freqs, int64_t* states, bool* need,
                           int16_t* vals, void* stream) {
  if (rows > 0 && cols > 0) {
    rans_encode_kernel<<<rows, THREADS, 0, (cudaStream_t)stream>>>(sym, cols, K, freqs,
                                                                   states, need, vals);
  }
  return (int)cudaGetLastError();
}

extern "C" int rans_decode(const int64_t* states, int rows, int K, const int64_t* freqs,
                           const int16_t* words, const int64_t* word_off,
                           const int64_t* word_cnt, const int64_t* ns, int64_t cols,
                           uint8_t* syms, int64_t* used, void* stream) {
  if (rows > 0) {
    // above 48 KB a block's dynamic shared memory must be asked for
    cudaError_t e = cudaFuncSetAttribute(rans_decode_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)DEC_SMEM);
    if (e != cudaSuccess) return (int)e;
    const unsigned blocks = (unsigned)((rows + DEC_WARPS - 1) / DEC_WARPS);
    rans_decode_kernel<<<blocks, 32 * DEC_WARPS, DEC_SMEM, (cudaStream_t)stream>>>(
        states, rows, K, freqs, words, word_off, word_cnt, ns, cols, syms, used);
  }
  return (int)cudaGetLastError();
}

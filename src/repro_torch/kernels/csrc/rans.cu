// Interleaved 32-bit rANS coder (K <= 64 lanes, 12-bit probabilities,
// 16-bit renormalisation) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernels repro/kernels/rans.py:
//   rans_encode  <- _rans_encode_kernel / rans_encode_pallas
//   rans_decode  <- _rans_decode_kernel / rans_decode_pallas
// The TPU ran the step axis as its sequential grid with the [R, K] states in
// VMEM scratch.  Here one block owns one (stream, plane) row: thread `lane`
// owns interleaved state `lane` in a register and walks the steps itself,
// and the row's tables live in shared memory.  Rows are independent, so the
// blocks need nothing from each other.
//
// Layout: a row's cells are [steps, K] row-major (cell t * K + lane), which
// is decoder order; symbol 256 is the identity pad (freq = M, cum = 0: the
// transform is x -> x and the renorm threshold wraps to "never").
//
// Bound on the card: per cell a few integer operations (one 32-bit division)
// against 5 bytes moved (2 read, 3 written) when encoding and about 3 when
// decoding, so by the roofline both are bound by memory bytes.  In practice
// each thread is a serial chain of `steps` dependent updates, and there are
// only R * K threads; the design keeps every table lookup in shared memory
// and the state in a register so the chain has no device-memory round trip
// except the cell's own load and store.
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

__global__ void rans_decode_kernel(const int64_t* __restrict__ states, int K,
                                   const int64_t* __restrict__ freqs,
                                   const int16_t* __restrict__ words,
                                   const int64_t* __restrict__ word_off,
                                   const int64_t* __restrict__ word_cnt,
                                   const int64_t* __restrict__ ns, int cols,
                                   uint8_t* __restrict__ syms, int64_t* __restrict__ used) {
  __shared__ uint8_t s2s[RANS_M];
  __shared__ uint32_t f[256];
  __shared__ uint32_t c[256];
  __shared__ int wcount[2][2];
  const int row = blockIdx.x;
  const int lane = threadIdx.x;
  const int warp = lane >> 5;
  const int wl = lane & 31;
  for (int j = lane; j < 256; j += THREADS) f[j] = (uint32_t)freqs[(size_t)row * 256 + j];
  __syncthreads();
  if (lane == 0) {
    uint32_t acc = 0;
    for (int j = 0; j < 256; ++j) {
      c[j] = acc;
      acc += f[j];
    }
  }
  __syncthreads();
  for (int j = lane; j < 256; j += THREADS) {
    const uint32_t end = min(c[j] + f[j], RANS_M);
    for (uint32_t slot = c[j]; slot < end; ++slot) s2s[slot] = (uint8_t)j;
  }
  __syncthreads();
  const int64_t n = ns[row];
  const int steps = (int)((n + K - 1) / K);
  const int64_t woff = word_off[row];
  const int64_t wcnt = word_cnt[row];
  uint32_t x = lane < K ? (uint32_t)states[(size_t)row * K + lane] : 0u;
  int64_t pos = 0;
  for (int t = 0; t < steps; ++t) {
    const int64_t cell = (int64_t)t * K + lane;
    const bool act = lane < K && cell < n;
    uint32_t x2 = x;
    uint32_t s = 0;
    bool nd = false;
    if (act) {
      const uint32_t slot = x & (RANS_M - 1);
      s = s2s[slot];
      x2 = f[s] * (x >> PROB_BITS) + slot - c[s];
      nd = x2 < RANS_L;
    }
    // renormalising lanes read the row's words in ascending lane order:
    // rank = exclusive prefix of `nd` over the lanes, from a warp ballot and
    // the first warp's count
    const uint32_t ballot = __ballot_sync(0xffffffffu, nd);
    if (wl == 0) wcount[t & 1][warp] = __popc(ballot);
    __syncthreads();
    const int first = wcount[t & 1][0];
    const int total = first + wcount[t & 1][1];
    if (nd) {
      const int64_t k = pos + (warp ? first : 0) + __popc(ballot & ((1u << wl) - 1u));
      const uint32_t w = k < wcnt ? (uint32_t)(uint16_t)words[woff + k] : 0u;
      x2 = (x2 << 16) | w;
    }
    if (act) {
      x = x2;
      syms[(size_t)row * cols + cell] = (uint8_t)s;
    }
    pos += total;
  }
  if (lane == 0) used[row] = pos;
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
                           const int64_t* word_cnt, const int64_t* ns, int cols,
                           uint8_t* syms, int64_t* used, void* stream) {
  if (rows > 0) {
    rans_decode_kernel<<<rows, THREADS, 0, (cudaStream_t)stream>>>(
        states, K, freqs, words, word_off, word_cnt, ns, cols, syms, used);
  }
  return (int)cudaGetLastError();
}

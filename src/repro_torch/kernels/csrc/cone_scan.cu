// Shrinking-cone scan (Alg. 3 of SHRINK) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/cone_scan.py
// (_cone_scan_kernel / cone_scan_pallas).  The TPU ran the recurrence on its
// sequential grid with the cone state in VMEM scratch, one series per lane.
//
// The chain, and how it is cut.  The cone state (theta, eps_seg, t0) changes
// only at a break.  Between breaks each step's candidate slopes
//   cand_hi(t) = (v_t + (eps_seg - theta)) / (t - t0)
//   cand_lo(t) = (v_t - (eps_seg + theta)) / (t - t0)
// depend on that state alone, so they are independent of each other; hi and
// lo are a running min of cand_hi and a running max of cand_lo; and the
// break test new_lo > new_hi is monotone (hi only falls and lo only rises
// until a break), so once it holds it holds for every later step.  A run of
// steps (a pass) is therefore scanned in parallel: every candidate, the inclusive
// and exclusive prefix min and max seeded with the state at the pass's
// start, and the first step whose inclusive lo > hi (ballot and
// find-first).  Steps before it keep theta, get brk = 0 and the exclusive
// prefix as their span; the break step gets the exclusive prefix as the
// closing span, brk = 1 and the new origin floor(v / e_t) * e_t, and the
// next pass starts from the new state.  Steps at or past lengths[s] are
// the identity: they never constrain or break a cone.  Step 0 opens the
// first segment whatever the length, as in the plain version.
//
// Exactness (why the scan may reorder the loop's chain).  Each candidate is
// the plain version's IEEE expression: the same grouping, a correctly
// rounded division, no contraction (--fmad=false) and no fast math.  Prefix
// values combine by the loop's own rule, later < earlier ? later : earlier
// (and > for lo).  On non-NaN values that rule is associative: it gives the
// earliest of the minimal values (-0.0 == +0.0 compare equal, so the earlier
// zero is kept, as the loop keeps it).  A NaN candidate compares false and
// so is a right identity; every prefix here starts from a non-NaN seed
// (+-inf or the state, which never holds a NaN), so a NaN is never a left
// operand.  A masked step is given the identity (+inf for hi, -inf for lo).
// The scan therefore returns the loop's bits, signed zeros included.
//
// Layout and bound.  A block owns W adjacent series, one warp a series, and
// walks the time axis in windows of C = 256 steps.  A pass gives lane j the
// rp steps a + j * rp, ..., so it covers 32 * rp steps from the first step
// a not yet written: rp = R = 8 (the rest of the window) unless the last
// pass broke, then rp = 1 (32 steps), since short segments come in runs.
// A window without a break is one pass; data that breaks at every step
// costs a pass of 32 steps a step.  W = 8 while that leaves at most half
// the SMs without a block: one time step of the block's series is then 32
// bytes or more in every output, brk's int32 too, so every store fills
// whole sectors (with W = 4, brk's rows are 16 bytes: half sectors, which
// the card then merges).  At the gateway's S = 1024 that is 128 blocks of 8
// warps, one an SM.  The ragged path's buckets of 64 series take W = 4:
// 16 blocks, each a chain of windows, on twice the SMs.  The windows of x
// and eps reach shared memory by cp.async, NSTAGE = 3 deep, so two
// windows' bytes are in flight while one is scanned; the outputs are
// staged in shared memory and stored row by row.  The tiles are
// time-major with one padding element after each run of R rows, so a
// warp's lanes, reading the same step of their runs, hit distinct banks.
// Per point the kernel reads 16 bytes and writes 28 (float64) against two
// divisions: memory bytes bound it.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int C = 256;         // steps a window
constexpr int R = C / 32;      // steps a lane in a full pass
constexpr int NSTAGE = 3;      // windows of x and eps in shared memory
constexpr unsigned FULL = 0xffffffffu;

template <typename F, int W>
struct Tile {
  static constexpr int ELEMS = C * W + 32;  // C x W and one pad after each run of R rows
  static constexpr size_t SMEM = (size_t)ELEMS * (2 * NSTAGE * sizeof(F) + 3 * sizeof(F) +
                                                 sizeof(int));
  // shared index of window row r (0..C-1), series w of the block
  static __device__ __forceinline__ int at(int r, int w) { return r * W + w + r / R; }
};

template <typename F>
__device__ __forceinline__ F min_rule(F earlier, F later) {
  return later < earlier ? later : earlier;
}

template <typename F>
__device__ __forceinline__ F max_rule(F earlier, F later) {
  return later > earlier ? later : earlier;
}

// start the copy of window k's rows of x and eps into stage buffers xs, es
template <typename F, int W>
__device__ __forceinline__ void stage(const F* __restrict__ x, const F* __restrict__ eps, F* xs,
                                      F* es, int k, int T, int S, int s0, int nw) {
  const int n = min(C, T - k * C);
  for (int e = threadIdx.x; e < n * W; e += blockDim.x) {
    const int r = e / W, w = e % W;
    if (w < nw) {
      const size_t g = (size_t)(k * C + r) * S + s0 + w;
      __pipeline_memcpy_async(xs + Tile<F, W>::at(r, w), x + g, sizeof(F));
      __pipeline_memcpy_async(es + Tile<F, W>::at(r, w), eps + g, sizeof(F));
    }
  }
}

template <typename F, int W>
__global__ void __launch_bounds__(32 * W)
cone_scan_kernel(const F* __restrict__ x, const F* __restrict__ eps,
                 const int* __restrict__ lengths, int T, int S, int* __restrict__ brk,
                 F* __restrict__ theta_out, F* __restrict__ lo_out, F* __restrict__ hi_out,
                 F* __restrict__ fin_lo, F* __restrict__ fin_hi) {
  using Tl = Tile<F, W>;
  extern __shared__ __align__(16) unsigned char smem[];
  F* xs = reinterpret_cast<F*>(smem);  // [NSTAGE][ELEMS]
  F* es = xs + NSTAGE * Tl::ELEMS;     // [NSTAGE][ELEMS]
  F* ths = es + NSTAGE * Tl::ELEMS;    // outputs of one window: theta, psi_lo, psi_hi, brk
  F* los = ths + Tl::ELEMS;
  F* his = los + Tl::ELEMS;
  int* bks = reinterpret_cast<int*>(his + Tl::ELEMS);

  const int lane = threadIdx.x & 31, wp = threadIdx.x >> 5;
  const int s0 = blockIdx.x * W;
  const int nw = min(W, S - s0);
  const bool active = wp < nw;
  const int s = s0 + wp;
  const int len = !active ? 0 : lengths == nullptr ? T : lengths[s];
  const int nwin = (T + C - 1) / C;
  const F inf = (F)INFINITY;

  for (int k = 0; k < NSTAGE - 1; ++k) {
    if (k < nwin) stage<F, W>(x, eps, xs + k * Tl::ELEMS, es + k * Tl::ELEMS, k, T, S, s0, nw);
    __pipeline_commit();
  }
  F theta = 0, eps_seg = 0, lo = -inf, hi = inf;
  int t0 = 0;
  int rp = R;  // steps a lane in the next pass: 1 right after a break, else R
  for (int k = 0; k < nwin; ++k) {
    const int kn = k + NSTAGE - 1;  // its buffer was scanned in window k - 1
    if (kn < nwin) {
      const int b = kn % NSTAGE;
      stage<F, W>(x, eps, xs + b * Tl::ELEMS, es + b * Tl::ELEMS, kn, T, S, s0, nw);
    }
    __pipeline_commit();
    __pipeline_wait_prior(NSTAGE - 1);  // window k has landed
    __syncthreads();
    const F* X = xs + (k % NSTAGE) * Tl::ELEMS;
    const F* E = es + (k % NSTAGE) * Tl::ELEMS;
    const int n = min(C, T - k * C);
    const int tb = k * C;
    if (active) {
      int a = 0;  // the first row not yet written
      if (k == 0) {  // step 0 opens the first segment
        eps_seg = E[Tl::at(0, wp)];
        theta = floor(X[Tl::at(0, wp)] / eps_seg) * eps_seg;
        if (lane == 0) {
          bks[Tl::at(0, wp)] = 1;
          ths[Tl::at(0, wp)] = theta;
          los[Tl::at(0, wp)] = -inf;
          his[Tl::at(0, wp)] = inf;
        }
        a = 1;
      }
      while (a < n) {
        // one pass over rows [a, end): lane j takes rows a + j * rp + i,
        // i < rp; their candidates and inclusive prefix from the identity
        const int end = min(n, a + 32 * rp);
        const int r0 = a + lane * rp;
        F ph[R], pl[R];
        F h = inf, l = -inf;
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const int r = r0 + i;
          if (i < rp && r < end && tb + r < len) {
            const F v = X[Tl::at(r, wp)];
            const F dt = (F)(tb + r - t0);
            h = min_rule(h, (v + (eps_seg - theta)) / dt);
            l = max_rule(l, (v - (eps_seg + theta)) / dt);
          }
          ph[i] = h;
          pl[i] = l;
        }
        // inclusive scan of the lanes' totals, then each lane's exclusive
        // prefix seeded with the state
        F sh = h, sl = l;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const F oh = __shfl_up_sync(FULL, sh, d), ol = __shfl_up_sync(FULL, sl, d);
          if (lane >= d) {
            sh = min_rule(oh, sh);
            sl = max_rule(ol, sl);
          }
        }
        F eh = __shfl_up_sync(FULL, sh, 1), el = __shfl_up_sync(FULL, sl, 1);
        eh = lane == 0 ? hi : min_rule(hi, eh);
        el = lane == 0 ? lo : max_rule(lo, el);
        // the first of the lane's rows whose inclusive lo > hi
        int first = R;
#pragma unroll
        for (int i = R - 1; i >= 0; --i) {
          if (max_rule(el, pl[i]) > min_rule(eh, ph[i])) first = i;
        }
        const unsigned found = __ballot_sync(FULL, first < R);
        int b = end;  // the break row, end if the pass has none
        F nt = theta, ne = eps_seg;
        if (found) {
          b = __shfl_sync(FULL, r0 + first, __ffs(found) - 1);
          ne = E[Tl::at(b, wp)];
          nt = floor(X[Tl::at(b, wp)] / ne) * ne;
        }
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const int r = r0 + i;
          if (i < rp && r <= b && r < end) {
            const int o = Tl::at(r, wp);
            his[o] = i == 0 ? eh : min_rule(eh, ph[i - 1]);
            los[o] = i == 0 ? el : max_rule(el, pl[i - 1]);
            bks[o] = r == b;
            ths[o] = r == b ? nt : theta;
          }
        }
        if (found) {
          theta = nt;
          eps_seg = ne;
          t0 = tb + b;
          lo = -inf;
          hi = inf;
          a = b + 1;
          rp = 1;  // short segments come in runs: the next pass covers 32 rows
        } else {
          hi = min_rule(hi, __shfl_sync(FULL, sh, 31));
          lo = max_rule(lo, __shfl_sync(FULL, sl, 31));
          a = end;
          rp = R;
        }
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < n * W; e += blockDim.x) {
      const int r = e / W, w = e % W;
      if (w < nw) {
        const int o = Tl::at(r, w);
        const size_t g = (size_t)(tb + r) * S + s0 + w;
        brk[g] = bks[o];
        theta_out[g] = ths[o];
        lo_out[g] = los[o];
        hi_out[g] = his[o];
      }
    }
  }
  if (active && lane == 0) {
    fin_lo[s] = lo;
    fin_hi[s] = hi;
  }
}

template <typename F, int W>
int run(const F* x, const F* eps, const int* lengths, int T, int S, int* brk, F* theta, F* lo,
        F* hi, F* fin_lo, F* fin_hi, cudaStream_t stream) {
  // above 48 KB a block's dynamic shared memory must be asked for
  cudaError_t e = cudaFuncSetAttribute(cone_scan_kernel<F, W>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)Tile<F, W>::SMEM);
  if (e != cudaSuccess) return (int)e;
  cone_scan_kernel<F, W><<<(S + W - 1) / W, 32 * W, Tile<F, W>::SMEM, stream>>>(
      x, eps, lengths, T, S, brk, theta, lo, hi, fin_lo, fin_hi);
  return (int)cudaGetLastError();
}

template <typename F>
int launch(const F* x, const F* eps, const int* lengths, int T, int S, int* brk, F* theta,
           F* lo, F* hi, F* fin_lo, F* fin_hi, void* stream) {
  if (T <= 0 || S <= 0) return (int)cudaGetLastError();
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  // 8 series a block while that leaves at most half the SMs without a block
  // (rows of 32 bytes or more: whole sectors for every output, brk too);
  // fewer series, 4 a block: twice the SMs for the chains of windows
  if (2 * ((S + 7) / 8) >= sms)
    return run<F, 8>(x, eps, lengths, T, S, brk, theta, lo, hi, fin_lo, fin_hi,
                     (cudaStream_t)stream);
  return run<F, 4>(x, eps, lengths, T, S, brk, theta, lo, hi, fin_lo, fin_hi,
                   (cudaStream_t)stream);
}

}  // namespace

extern "C" int cone_scan_f64(const double* x, const double* eps, const int* lengths,
                             int T, int S, int* brk, double* theta,
                             double* lo, double* hi, double* fin_lo, double* fin_hi,
                             void* stream) {
  return launch<double>(x, eps, lengths, T, S, brk, theta, lo, hi, fin_lo, fin_hi, stream);
}

extern "C" int cone_scan_f32(const float* x, const float* eps, const int* lengths,
                             int T, int S, int* brk, float* theta,
                             float* lo, float* hi, float* fin_lo, float* fin_hi,
                             void* stream) {
  return launch<float>(x, eps, lengths, T, S, brk, theta, lo, hi, fin_lo, fin_hi, stream);
}

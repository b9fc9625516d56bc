// Shrinking-cone scan (Alg. 3 of SHRINK) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/cone_scan.py
// (_cone_scan_kernel / cone_scan_pallas).  The TPU ran the recurrence on its
// sequential grid with the cone state in VMEM scratch, one series per lane.
// Here one thread owns one series: its state (theta, psi_lo, psi_hi,
// eps_seg, t0) lives in registers and the thread loops over all T time
// steps itself, so nothing is carried between blocks.  Neighbouring threads
// own neighbouring series, so every load of the time-major [T, S] inputs
// and every store of the [T, S] outputs is coalesced across the warp.
//
// Bound on the card: the work per point is a handful of adds, two
// divisions and compares, and the bytes per point are 16 read and 28
// written (float64), so by the roofline the kernel is bound by memory
// bytes.  In practice it is bound by the T-step dependent chain of each
// thread (each step's comparison needs the previous step's span), with
// only S threads in flight.  The design keeps the chain in registers and
// lets the loads of later steps issue ahead of the chain (__restrict__,
// unrolled loop); it does not shorten the chain.
//
// Exactness: in double precision the kernel reproduces the host scan
// bit for bit.  Build with --fmad=false and without fast math, and keep the
// host's grouping of the candidate slopes: (v + (eps - theta)) / dt and
// (v - (eps + theta)) / dt.  The TPU kernel grouped them ((v + eps) - theta)
// / dt, which can differ in the last bit of a span.
#include <cuda_runtime.h>
#include <math.h>

template <typename F>
__global__ void cone_scan_kernel(const F* __restrict__ x, const F* __restrict__ eps,
                                 const int* __restrict__ lengths, int T, int S,
                                 int* __restrict__ brk,
                                 F* __restrict__ theta_out, F* __restrict__ lo_out,
                                 F* __restrict__ hi_out, F* __restrict__ fin_lo,
                                 F* __restrict__ fin_hi) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  const F inf = (F)INFINITY;
  const int len = lengths == nullptr ? T : lengths[s];
  F eps_seg = eps[s];
  F theta = floor(x[s] / eps_seg) * eps_seg;
  F lo = -inf, hi = inf;
  int t0 = 0;
  brk[s] = 1;
  theta_out[s] = theta;
  lo_out[s] = lo;
  hi_out[s] = hi;
#pragma unroll 4
  for (int t = 1; t < T; ++t) {
    const size_t i = (size_t)t * S + s;
    const F v = x[i];
    const F e_t = eps[i];
    const F dt = (F)(t - t0);
    const F cand_hi = (v + (eps_seg - theta)) / dt;
    const F cand_lo = (v - (eps_seg + theta)) / dt;
    const bool grow = t < len;
    const F new_hi = grow && cand_hi < hi ? cand_hi : hi;
    const F new_lo = grow && cand_lo > lo ? cand_lo : lo;
    const bool b = grow && new_lo > new_hi;
    // the span of the segment that closes here is the pre-update one
    lo_out[i] = lo;
    hi_out[i] = hi;
    if (b) {
      theta = floor(v / e_t) * e_t;
      eps_seg = e_t;
      lo = -inf;
      hi = inf;
      t0 = t;
    } else {
      lo = new_lo;
      hi = new_hi;
    }
    brk[i] = b ? 1 : 0;
    theta_out[i] = theta;
  }
  fin_lo[s] = lo;
  fin_hi[s] = hi;
}

template <typename F>
static int launch(const F* x, const F* eps, const int* lengths, int T, int S,
                  int* brk, F* theta, F* lo, F* hi, F* fin_lo,
                  F* fin_hi, void* stream) {
  // 32 threads a block spreads S series over S / 32 SMs: each thread is a
  // serial chain, so more SMs in use means more issue slots for the chains.
  const int threads = 32;
  const int blocks = (S + threads - 1) / threads;
  if (T > 0 && S > 0) {
    cone_scan_kernel<F><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        x, eps, lengths, T, S, brk, theta, lo, hi, fin_lo, fin_hi);
  }
  return (int)cudaGetLastError();
}

extern "C" int cone_scan_f64(const double* x, const double* eps, const int* lengths,
                             int T, int S, int* brk, double* theta,
                             double* lo, double* hi, double* fin_lo, double* fin_hi,
                             void* stream) {
  return launch<double>(x, eps, lengths, T, S, brk, theta, lo, hi,
                        fin_lo, fin_hi, stream);
}

extern "C" int cone_scan_f32(const float* x, const float* eps, const int* lengths,
                             int T, int S, int* brk, float* theta,
                             float* lo, float* hi, float* fin_lo, float* fin_hi,
                             void* stream) {
  return launch<float>(x, eps, lengths, T, S, brk, theta, lo, hi,
                       fin_lo, fin_hi, stream);
}

// Kernels K6 and K7: one utterance through the Kalman (K6) or NLMS (K7)
// stage 1.
//
// Replaces aec_tpu/kernels/pallas_kalman.py:150 kalman_filter_fused
// (pallas_call at :178) and aec_tpu/kernels/pallas_nlms.py:94
// nlms_filter_fused (pallas_call at :121), the single-stream TPU kernels that
// JAX routes every 1-D call to. One template over the filter, two C entry
// points per route. JAX computes the far spectra outside its kernel; here
// the far-frame analysis is fused as in K1, so the function is waveform in,
// waveform out.
//
// The FFT route: one utterance on one CTA. The recursion is serial in time
// and a step's work is small (~0.35 M flops at the default geometry, ~1 us
// of one SM's FMA rate), so what sets the time is the chain of dependent
// phases, not the flops. Each step is the algebra of bl_common.cuh's
// kalman_block_step / nlms_block_step line for line, on real FFTs of length
// 2B (fft.cuh's schedule and edge rules, K1's plan and twiddles), but every
// transform is run by ONE warp (fft.cuh warp_fft: the passes separated by
// __syncwarp, no CTA barrier inside a transform) in a pair of work buffers
// private to that warp. A step is four phases and four CTA barriers, each
// at a true dependency across bins or partitions:
//   1. all threads, per bin: the staged far spectrum X_t into its ring slot;
//      the echo estimate y = sum_l W[l] X[l], and the part of the gain's
//      denominator that does not wait for the residual (Kalman: sum_l
//      |X[l]|^2 P-[l]; NLMS: the smoothed far power and its per-warp sums
//      for the mean over bins). Barrier: y is whole.
//   2. warp 0: echo synthesis irfft(y), e = d - irfft(y)[B:] (written out)
//      and the residual's transform. Barrier.
//   3. all threads, per bin: psi, the denominator, E / den. Barrier.
//   4. jobs, one per warp in turn: partition l's gradient (pre-split for the
//      inverse as it is formed, bins k and M - k in one lane), its
//      constraint (the irfft head, the rfft of [head || 0]) and its update
//      of W[l] (Kalman: P[l], and block t + 1's prediction), all in one
//      warp; and one more job, the far-frame analysis of block t + 1 into a
//      staging spectrum. Each thread also stores the next blocks' far and
//      mic samples it loaded into registers a step earlier. Barrier: the
//      next step's echo estimate reads every partition.
// K1 as a batch of one runs the same step with ~21 CTA barriers (one per
// radix pass). The L constraint pairs need no (L, 2B) work buffers: a warp
// holds one partition at a time. The far blocks sit in a ring of three (the
// analysis of block t + 1 reads blocks t and t + 1 while block t + 2 is
// stored), the mic blocks in a ring of two. On the default geometry each
// lane holds its butterflies' twiddles in registers (fft.cuh WarpTw).
//
// What bounds it. One warp issues every instruction of its transform, so a
// 256-point transform is bound by one warp's instruction latency (~1,000
// cycles at the default geometry), and phase 4 by the SM's four schedulers'
// issue: at L = 10 it is 11 jobs of ~1,600 instructions a lane (two
// transforms, the gradient and pre-split, the split and update), three of
// them on one scheduler. Read on the card, a step of K6 is ~5.5 us: phase 4
// ~3.6, phase 2 ~1.1, phase 1 ~0.6, phase 3 ~0.25, the stores ~0.1, the
// four barriers themselves ~0.05 (kernels/single_costs.py: the transforms
// cut out, and cycles by phase; PERF.md has the split).
// Kalman's covariance update multiplies by 1 / den, a reciprocal a bin, where
// kalman_block_step divides by den.
//
// Largest L. Per partition the state alone: W re/im, the ring re/im (and
// Kalman's P): 5K floats for Kalman, 4K for NLMS; beside it min(17, L + 1)
// warps' work buffers of 2 x 2B floats and ~9 B fixed. In 227 KB a CTA: K6
// 29 at block 256 and 56 at 160, K7 36 and 69 (the dense route's cluster
// held 18 and 46, 18 and 47).
//
// The dense route, a block with a prime factor other than 2, 3 and 5 (e.g.
// 224 = 2^5 7), which has no radix plan: one utterance on one thread-block
// cluster of C = 16 CTAs (the non-portable maximum, one CTA per SM) that
// split the K = B + 1 bins, CTA r owning [r K / C, (r + 1) K / C), on dense
// transforms over the slices of the DFT bases each CTA holds in shared
// memory. The launch asks cudaOccupancyMaxActiveClusters first, and a card
// that cannot place the cluster refuses the call.
// Per step everything per bin (predict / far power, gain, psi, the update)
// is CTA-local, and so are the own columns of the far-frame and residual
// analyses (each CTA holds the whole frame and block). The only cross-bin
// work is the echo synthesis, the constraint head (partial sums over each
// CTA's bins) and NLMS's mean of the far power, reduced across the cluster
// through distributed shared memory:
//   X1 after each CTA has its share of irfft(y)[B:] (and of sum_k power):
//      every CTA sums the C shares in rank order, so all hold the same e;
//   X2 after each CTA has its share of the L x B constraint head: CTA r
//      sums the C shares of its span [r B / C, (r + 1) B / C) of samples
//      (reduce-scatter);
//   X3 after the spans are reduced: every CTA gathers the other spans.
// Each exchange is a cluster.sync() between the writes and the remote
// reads; every buffer read remotely at one exchange is written again only
// after a later one, so three syncs per step order all of it. Its step is
// latency-bound too: 14 CTA barriers and 3 cluster syncs.
//
// The wrappers (kernels/kalman.py, kernels/nlms.py) pick the route from the
// geometry and count which one ran.

#include <cooperative_groups.h>

#include "stage1_fft.cuh"

namespace cg = cooperative_groups;
using namespace aec;

namespace {

constexpr int kC = 16;  // CTAs per cluster

// The cluster's split of the geometry: every CTA computes the same one, so
// their layouts agree for the remote reads.
struct Split {
  int kb;    // the longest bin slice: ceil(K / C)
  int cols;  // own ri columns [re || im]: 2 kb
  int nsl;   // n-slices of a column product: kThreads / cols
  template <class G>
  __host__ __device__ explicit Split(const G& q)
      : kb((q.bins + kC - 1) / kC), cols(2 * kb), nsl(kThreads / cols) {}
};

template <bool kNlms>
struct SingleSmem {
  SArr fwd;        // (2B, cols) own columns of fwd
  SArr inv_tail;   // (cols, B) own rows of inv_tail
  SArr inv_head;   // (cols, B) own rows of inv_head
  SArr wr, wi;    // (L, kb) filter, own bins
  SArr xr, xi;    // (L, kb) far-spectrum ring, own bins
  SArr p;          // (L, kb) Kalman covariance
  SArr power;      // (kb) NLMS smoothed far power
  SArr psi, den;  // (kb) residual psd; den (Kalman) or 1/den (NLMS)
  SArr frame;      // (2B) [previous far block || current]
  SArr d, e;      // (B) mic block; residual block
  SArr y, er;     // (cols) own bins' echo estimate, residual spectrum
  SArr g;          // (L, cols) own bins' update per partition
  SArr part;       // (nsl, max(L, 1), cols) n-slice partials of the column products
  SArr ehalf;      // (B) imaginary half of this CTA's share
  SArr epart;      // (B + 1) this CTA's share of irfft(y)[B:], then of sum_k power (remote)
  SArr tpart;      // (L, B) this CTA's share of the constraint head (remote)
  SArr t;          // (L, B) the whole head; the own span reduced here (remote)
  SArr mean;       // (1) NLMS: mean_k(power)
  template <class G>
  __host__ __device__ SingleSmem(Carve& c, const G& q) {
    const Split sp(q);
    const size_t lb = size_t(q.L) * q.block, lkb = size_t(q.L) * sp.kb;
    fwd = c.take(size_t(q.frame) * sp.cols);
    inv_tail = c.take(size_t(sp.cols) * q.block);
    inv_head = c.take(size_t(sp.cols) * q.block);
    wr = c.take(lkb); wi = c.take(lkb); xr = c.take(lkb); xi = c.take(lkb);
    p = c.take(kNlms ? 1 : lkb);
    power = c.take(kNlms ? sp.kb : 1);
    psi = c.take(sp.kb); den = c.take(sp.kb);
    frame = c.take(q.frame); d = c.take(q.block); e = c.take(q.block);
    y = c.take(sp.cols); er = c.take(sp.cols);
    g = c.take(size_t(q.L) * sp.cols);
    part = c.take(size_t(sp.nsl) * (q.L > 1 ? q.L : 1) * sp.cols);
    ehalf = c.take(q.block); epart = c.take(q.block + 1);
    tpart = c.take(lb); t = c.take(lb);
    mean = c.take(1);
  }
};

// the CTA owning sample j of a block: the largest q with q B / C <= j
__device__ __forceinline__ int span_owner(int j, int B) { return ((j + 1) * kC - 1) / B; }

// this CTA's share of the constraint head irfft(G[l])[:B] for l in
// [l0, l0 + NL): the real half into t (free until X3), the imaginary into tpart
template <int NL, bool kNlms, class G>
__device__ __forceinline__ void head_share(const SingleSmem<kNlms>& s, const G& q,
                                           const Split& sp, int nb, int l0) {
  const int B = q.block;
  for (int idx = threadIdx.x; idx < 2 * B; idx += kThreads) {
    const int half = idx >= B, j = idx - half * B;
    float acc[NL];
#pragma unroll
    for (int l = 0; l < NL; ++l) acc[l] = 0.f;
    for (int b = 0; b < nb; ++b) {
      const int c = half * sp.kb + b;
      const float ih = s.inv_head[c * B + j];
#pragma unroll
      for (int l = 0; l < NL; ++l) acc[l] = fmaf(s.g[(l0 + l) * sp.cols + c], ih, acc[l]);
    }
    const SArr dst = (half ? s.tpart : s.t) + (l0 * B + j);
#pragma unroll
    for (int l = 0; l < NL; ++l) dst[l * B] = acc[l];
  }
}

// constraint tail rfft([t[l] || 0]) on the own columns for l in
// [l0, l0 + NL): n-slice partials into part
template <int NL, bool kNlms, class G>
__device__ __forceinline__ void tail_share(const SingleSmem<kNlms>& s, const G& q,
                                           const Split& sp, int l0) {
  const int tid = threadIdx.x, B = q.block;
  const int c_of = tid % sp.cols, sl = tid / sp.cols;
  if (sl >= sp.nsl) return;
  float acc[NL];
#pragma unroll
  for (int l = 0; l < NL; ++l) acc[l] = 0.f;
  for (int n = sl * B / sp.nsl; n < (sl + 1) * B / sp.nsl; ++n) {
    const float fb = s.fwd[n * sp.cols + c_of];
#pragma unroll
    for (int l = 0; l < NL; ++l) acc[l] = fmaf(s.t[(l0 + l) * B + n], fb, acc[l]);
  }
#pragma unroll
  for (int l = 0; l < NL; ++l) s.part[(sl * q.L + l0 + l) * sp.cols + c_of] = acc[l];
}

template <bool kNlms, class G>
__global__ void __launch_bounds__(kThreads, 1)
single_stream_kernel(const float* __restrict__ far, const float* __restrict__ mic,
                     float* __restrict__ out, int t_blocks, G q, Stage1Bases bs,
                     KalmanParams kp, NlmsParams np) {
  Carve carve;
  const SingleSmem<kNlms> s(carve, q);
  const Split sp(q);
  cg::cluster_group cluster = cg::this_cluster();
  const int r = static_cast<int>(cluster.block_rank());
  const int B = q.block, K = q.bins, L = q.L, ri = q.ri, kb = sp.kb, cols = sp.cols;
  const int lo = r * K / kC, nb = (r + 1) * K / kC - lo;
  const int s_lo = r * B / kC, span = (r + 1) * B / kC - s_lo;  // own span of samples
  const int tid = threadIdx.x;

  // the own slices of the bases (own column c: bin lo + c % kb, the real
  // half for c < kb; the columns past nb stay 0), then the initial state
  auto gcol = [&](int c) { return (c / kb) * K + lo + c % kb; };
  for (int i = tid; i < q.frame * cols; i += kThreads) {
    const int n = i / cols, c = i % cols;
    s.fwd[i] = c % kb < nb ? bs.fwd[n * ri + gcol(c)] : 0.f;
  }
  for (int i = tid; i < cols * B; i += kThreads) {
    const int c = i / B, j = i % B;
    const bool own = c % kb < nb;
    s.inv_tail[i] = own ? bs.inv_tail[gcol(c) * B + j] : 0.f;
    s.inv_head[i] = own ? bs.inv_head[gcol(c) * B + j] : 0.f;
  }
  for (int i = tid; i < L * kb; i += kThreads) {
    s.wr[i] = 0.f; s.wi[i] = 0.f; s.xr[i] = 0.f; s.xi[i] = 0.f;
    if constexpr (!kNlms) s.p[i] = kp.init_p;
  }
  for (int i = tid; i < kb; i += kThreads) {
    s.psi[i] = kNlms ? 0.f : kp.p_floor;
    if constexpr (kNlms) s.power[i] = 0.f;
  }
  for (int i = tid; i < q.frame; i += kThreads) s.frame[i] = 0.f;
  cluster.sync();  // every CTA of the cluster runs before any remote read

  const int c_of = tid % cols, sl = tid / cols;  // (column, n-slice) of the column products

  for (int t = 0; t < t_blocks; ++t) {
    const size_t off = static_cast<size_t>(t) * B;
    const int head = t % L;
    for (int j = tid; j < B; j += kThreads) {
      s.frame[B + j] = far[off + j];
      s.d[j] = mic[off + j];
    }
    __syncthreads();

    // 1. far-frame analysis, own columns: n-slice partials, then their sum
    if (sl < sp.nsl) {
      float acc = 0.f;
#pragma unroll 8
      for (int n = sl * q.frame / sp.nsl; n < (sl + 1) * q.frame / sp.nsl; ++n)
        acc = fmaf(s.frame[n], s.fwd[n * cols + c_of], acc);
      s.part[sl * cols + c_of] = acc;
    }
    __syncthreads();
    if (tid < cols && tid % kb < nb) {
      float acc = 0.f;
      for (int m = 0; m < sp.nsl; ++m) acc += s.part[m * cols + tid];
      (tid < kb ? s.xr : s.xi)[head * kb + tid % kb] = acc;
    }
    __syncthreads();

    // 2. far ring shift; per own bin: predict (Kalman) or the smoothed far
    //    power (NLMS); echo-estimate spectrum y = sum_l W[l] X[l]
    for (int j = tid; j < B; j += kThreads) s.frame[j] = s.frame[B + j];
    for (int b = tid; b < nb; b += kThreads) {
      float yr = 0.f, yi = 0.f, inst = 0.f;
      for (int l = 0; l < L; ++l) {
        const int xs = ring_slot(head, l, L) * kb + b, ws = l * kb + b;
        const float xr = s.xr[xs], xi = s.xi[xs];
        float wr = s.wr[ws], wi = s.wi[ws];
        if constexpr (!kNlms) {
          s.p[ws] = kp.a2 * s.p[ws] + kp.one_minus_a2 * (wr * wr + wi * wi) + kp.q_min;
          wr *= kp.a;
          wi *= kp.a;
          s.wr[ws] = wr;
          s.wi[ws] = wi;
        } else {
          inst += xr * xr + xi * xi;
        }
        yr += wr * xr - wi * xi;
        yi += wr * xi + wi * xr;
      }
      if constexpr (kNlms) s.power[b] = np.ps * s.power[b] + np.one_minus_ps * inst;
      s.y[b] = yr;
      s.y[kb + b] = yi;
    }
    __syncthreads();

    // 3. this CTA's share of irfft(y)[B:] (halves summed apart); the last
    //    warp adds up this CTA's far power for the mean
    for (int idx = tid; idx < 2 * B; idx += kThreads) {
      const int half = idx >= B, j = idx - half * B;
      float acc = 0.f;
      for (int b = 0; b < nb; ++b)
        acc = fmaf(s.y[half * kb + b], s.inv_tail[(half * kb + b) * B + j], acc);
      (half ? s.ehalf : s.epart)[j] = acc;
    }
    if constexpr (kNlms) {
      if (tid >= kThreads - 32) {  // one whole warp
        const int lane = tid - (kThreads - 32);
        float v = 0.f;
        for (int b = lane; b < nb; b += 32) v += s.power[b];
        v = warp_sum(v);
        if (lane == 0) s.epart[B] = v;
      }
    }
    __syncthreads();
    for (int j = tid; j < B; j += kThreads) s.epart[j] += s.ehalf[j];
    cluster.sync();  // X1

    // 4. e = d - irfft(y)[B:], the shares summed in rank order; the mean power
    for (int j = tid; j <= B; j += kThreads) {
      float acc = 0.f;
      for (int m = 0; m < kC; ++m) acc += *cluster.map_shared_rank(&s.epart[j], m);
      if (j < B) s.e[j] = s.d[j] - acc;
      else if (kNlms) s.mean[0] = acc / K;
    }
    __syncthreads();

    // 5. residual spectrum E = rfft([0 || e]), own columns
    if (sl < sp.nsl) {
      float acc = 0.f;
#pragma unroll 8
      for (int n = sl * B / sp.nsl; n < (sl + 1) * B / sp.nsl; ++n)
        acc = fmaf(s.e[n], s.fwd[(B + n) * cols + c_of], acc);
      s.part[sl * cols + c_of] = acc;
    }
    __syncthreads();
    if (tid < cols) {
      float acc = 0.f;
      for (int m = 0; m < sp.nsl; ++m) acc += s.part[m * cols + tid];
      s.er[tid] = acc;
    }
    __syncthreads();

    // 6. per own bin: psi and the gain's denominator
    for (int b = tid; b < nb; b += kThreads) {
      const float er = s.er[b], ei = s.er[kb + b];
      if constexpr (kNlms) {
        const float psi = np.es * s.psi[b] + np.one_minus_es * (er * er + ei * ei);
        s.psi[b] = psi;
        s.den[b] = 1.f / (s.power[b] + np.eps + np.eps_rel * s.mean[0] + np.beta * psi);
      } else {
        const float psi =
            fmaxf(kp.obs * s.psi[b] + kp.one_minus_obs * (er * er + ei * ei), kp.p_floor);
        s.psi[b] = psi;
        float den = 0.f;
        for (int l = 0; l < L; ++l) {
          const int xs = ring_slot(head, l, L) * kb + b;
          den += (s.xr[xs] * s.xr[xs] + s.xi[xs] * s.xi[xs]) * s.p[l * kb + b];
        }
        den += 2.f * psi;
        s.den[b] = den;
        s.er[b] = er / den;
        s.er[kb + b] = ei / den;
      }
    }
    __syncthreads();

    // 7. update per partition and own bin (and the covariance, Kalman)
    for (int i = tid; i < L * kb; i += kThreads) {
      const int l = i / kb, b = i % kb;
      float gr = 0.f, gi = 0.f;
      if (b < nb) {
        const int xs = ring_slot(head, l, L) * kb + b;
        const float xr = s.xr[xs], xi = s.xi[xs], er = s.er[b], ei = s.er[kb + b];
        if constexpr (kNlms) {
          gr = (xr * er + xi * ei) * s.den[b];
          gi = (xr * ei - xi * er) * s.den[b];
        } else {
          const float pp = s.p[i];
          gr = pp * (xr * er + xi * ei);
          gi = pp * (xr * ei - xi * er);
          s.p[i] = fmaxf(pp * (1.f - pp * (xr * xr + xi * xi) / s.den[b]), kp.p_floor);
        }
      }
      s.g[l * cols + b] = gr;
      s.g[l * cols + kb + b] = gi;
    }
    __syncthreads();

    // 8. this CTA's share of the constraint head irfft(G[l])[:B]
    for_chunks(L, [&](auto nl, int l0) { head_share<decltype(nl)::value>(s, q, sp, nb, l0); });
    __syncthreads();
    for (int i = tid; i < L * B; i += kThreads) s.tpart[i] += s.t[i];
    cluster.sync();  // X2

    // 9. reduce-scatter: the C shares of this CTA's span, in rank order
    for (int idx = tid; idx < L * span; idx += kThreads) {
      const int i = (idx / span) * B + s_lo + idx % span;
      float acc = 0.f;
      for (int m = 0; m < kC; ++m) acc += *cluster.map_shared_rank(&s.tpart[i], m);
      s.t[i] = acc;
    }
    cluster.sync();  // X3

    // 10. all-gather the other spans
    for (int i = tid; i < L * B; i += kThreads) {
      const int m = span_owner(i % B, B);
      if (m != r) s.t[i] = *cluster.map_shared_rank(&s.t[i], m);
    }
    __syncthreads();

    // 11. constraint tail rfft([t[l] || 0]) on the own columns, partitions
    //     in registers; W[l] += it (Kalman) or mu times it (NLMS)
    for_chunks(L, [&](auto nl, int l0) { tail_share<decltype(nl)::value>(s, q, sp, l0); });
    __syncthreads();
    for (int i = tid; i < L * cols; i += kThreads) {
      const int l = i / cols, c = i % cols, b = c % kb;
      if (b < nb) {
        float acc = 0.f;
        for (int m = 0; m < sp.nsl; ++m) acc += s.part[(m * L + l) * cols + c];
        const SArr w = c < kb ? s.wr : s.wi;
        if constexpr (kNlms) w[l * kb + b] += np.mu * acc;
        else w[l * kb + b] += acc;
      }
    }
    // 12. every CTA holds the whole residual block: each writes its span
    for (int j = tid; j < span; j += kThreads) out[off + s_lo + j] = s.e[s_lo + j];
    __syncthreads();
  }
  cluster.sync();  // no CTA leaves while another may still read its memory
}

// Launches one cluster, after asking whether the card can place it.
template <bool kNlms, class G>
cudaError_t launch_geom(const float* far, const float* mic, float* out, int t_blocks, const G& q,
                        const Stage1Bases& bs, const KalmanParams& kp, const NlmsParams& np,
                        int device, void* stream) {
  auto kernel = single_stream_kernel<kNlms, G>;
  cudaError_t err;
  const size_t smem = smem_bytes<SingleSmem<kNlms>>(q);
  err = set_smem(reinterpret_cast<const void*>(kernel), smem, device);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kC;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cfg.gridDim = dim3(kC);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, reinterpret_cast<const void*>(kernel), &cfg);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorLaunchOutOfResources;  // the card cannot place it
  if (t_blocks == 0) return cudaSuccess;
  err = cudaLaunchKernelEx(&cfg, kernel, far, mic, out, t_blocks, q, bs, kp, np);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <bool kNlms>
int launch(const float* far, const float* mic, float* out, int t_blocks, int block, int n_blocks,
           const Stage1Bases& bs, const KalmanParams& kp, const NlmsParams& np, int device,
           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  // a block without a radix plan is never the default geometry's
  return launch_geom<kNlms>(far, mic, out, t_blocks, make_geom(block, n_blocks, 0), bs, kp, np,
                            device, stream);
}

// ---------------------------------------------------------------- the FFT route: one CTA

// Per-utterance state and work buffers of the one-CTA FFT step.
template <bool kNlms>
struct SingleFftSmem {
  SArr w;         // (L, K) complex filter
  SArr p;         // (L, K) Kalman covariance
  SArr x;         // (L, K) complex far-spectrum ring (slot t % L holds block t)
  SArr power;     // (K) NLMS smoothed far power
  SArr psi, den;  // (K) residual psd; Kalman: sum_l |X|^2 P-, then 1 / den; NLMS: 1 / den
  SArr ye;        // (K) complex echo estimate y, then E / den (Kalman) or E (NLMS)
  SArr xn;        // (K) complex: the next block's far-frame spectrum
  SArr far3;      // (3, B) far blocks: block t in slot t % 3
  SArr mic2;      // (2, B) mic blocks: block t in slot t % 2
  SArr tw;        // (B) complex: W_2B^m, m in [0, B)
  SArr red;       // (kWarps) NLMS: per-warp sums of the far power
  SArr work;      // (jobs, 2, B) complex: each job warp's two FFT work buffers
  int jobs;       // warps that take jobs: min(kWarps, L + 1)
  template <class G>
  __host__ __device__ SingleFftSmem(Carve& c, const G& q) {
    const size_t lk = size_t(q.L) * q.bins;
    w = c.take(2 * lk); p = c.take(kNlms ? 0 : lk); x = c.take(2 * lk);
    power = c.take(kNlms ? q.bins : 0); psi = c.take(q.bins); den = c.take(q.bins);
    ye = c.take(q.ri); xn = c.take(q.ri);
    far3 = c.take(3 * size_t(q.block)); mic2 = c.take(2 * size_t(q.block));
    tw = c.take(q.frame);
    red = c.take(kWarps);
    jobs = q.L + 1 < kWarps ? q.L + 1 : kWarps;
    work = c.take(size_t(jobs) * 2 * q.frame);
  }
};

// the inverse's pre-split of y, K complex bins (EchoInvSrc's algebra)
struct EchoInvSrcC {
  SArr y, tw;
  int M;
  float inv_n;
  __device__ __forceinline__ float2 operator()(int, int k) const {
    float2 xk = c2(y, k), xm = c2(y, M - k);  // bin K - 1 when k == 0
    if (k == 0) {
      xk.y = 0.f;
      xm.y = 0.f;
    }
    return inv_split(xk, xm, c2(tw, k), inv_n);
  }
};

// z[n] = (x[2n], x[2n+1]) of the frame [prev || cur], two far blocks
struct FarFrameSrc {
  SArr prev, cur;
  int B;
  __device__ __forceinline__ float sample(int m) const { return m < B ? prev[m] : cur[m - B]; }
  __device__ __forceinline__ float2 operator()(int, int n) const {
    return make_float2(sample(2 * n), sample(2 * n + 1));
  }
};

// z[n] of [0_B || e] with e = d - irfft(y)[B:] formed on the way (the echo
// synthesis's tail from its inverse zy) and written out: every sample of e
// is read by one work item of the first pass
struct ResidualOutSrc {
  SArr d, zy;
  float* out;
  int B;
  __device__ __forceinline__ float sample(int m) const {
    if (m < B) return 0.f;
    const float v = d[m - B] - real_sample(zy, 0, m, B);
    out[m - B] = v;
    return v;
  }
  __device__ __forceinline__ float2 operator()(int, int n) const {
    return make_float2(sample(2 * n), sample(2 * n + 1));
  }
};

template <bool kNlms, class G, class Plan>
__global__ void __launch_bounds__(kThreads, 1)
single_fft_kernel(const float* __restrict__ far, const float* __restrict__ mic,
                  float* __restrict__ out, int t_blocks, G q, Plan plan,
                  const float* __restrict__ twd, KalmanParams kp, NlmsParams np) {
  Carve carve;
  const SingleFftSmem<kNlms> s(carve, q);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int B = q.block, K = q.bins, L = q.L, M = q.block, F = q.frame;
  const float inv_n = 1.f / F;
  const auto work = [&](int w, int i) { return s.work + (2 * w + i) * F; };
  // the slot of far block t, for t >= -1 (block -1 shares block 2's)
  const auto far_of = [&](int t) { return s.far3 + ((t + 3) % 3) * B; };
  const auto mic_of = [&](int t) { return s.mic2 + (t & 1) * B; };
  const auto sample = [&](const float* x, int t, int j) {
    return t < t_blocks ? x[static_cast<size_t>(t) * B + j] : 0.f;
  };

  // the initial state (Kalman: W, P as block 0's prediction), the twiddles,
  // far blocks -1 (zero), 0 and 1, mic block 0; then X_0 by warp 0
  for (int i = tid; i < L * K; i += kThreads) {
    c2(s.w, i) = make_float2(0.f, 0.f);
    c2(s.x, i) = make_float2(0.f, 0.f);
    if constexpr (!kNlms) {  // kalman_fft_init's predict from W = 0, P = init_p
      const float w0 = 0.f;
      s.p[i] = kp.a2 * kp.init_p + kp.one_minus_a2 * (w0 * w0 + w0 * w0) + kp.q_min;
    }
  }
  for (int k = tid; k < K; k += kThreads) {
    s.psi[k] = kNlms ? 0.f : kp.p_floor;
    if constexpr (kNlms) s.power[k] = 0.f;
  }
  for (int i = tid; i < F; i += kThreads) s.tw[i] = twd[i];
  for (int j = tid; j < B; j += kThreads) {
    far_of(-1)[j] = 0.f;
    far_of(0)[j] = sample(far, 0, j);
    far_of(1)[j] = sample(far, 1, j);
    mic_of(0)[j] = sample(mic, 0, j);
  }
  __syncthreads();
  const auto wtw = warp_twiddles(plan, q, s.tw, lane);  // this lane's, or the table

  // the far-frame analysis of block t, rfft([t - 1 || t]), by warp w into xn
  const auto analysis = [&](int t, int w) {
    const SArr z = warp_fft<false>(plan, q, lane, FarFrameSrc{far_of(t - 1), far_of(t), B},
                                   work(w, 0), work(w, 1), wtw);
    for (int k = lane; 2 * k <= M; k += 32) {  // bins k and M - k
      float2 xk, xm;
      fwd_split_pair(z, k, M, s.tw, xk, xm);
      c2(s.xn, k) = xk;
      c2(s.xn, M - k) = xm;
    }
  };

  // partition l's gradient, constraint and update by warp w (step t's ring
  // head); Kalman also block t + 1's prediction of W[l], P[l]. Each lane
  // takes bins k and M - k together: the inverse's pre-split (PackedInvSrc's
  // algebra) and the forward's split (fwd_split's) each read both.
  const auto constrain = [&](int l, int head, int w) {
    const SArr a = work(w, 0), b = work(w, 1);
    const int xs = ring_slot(head, l, L) * K, ws = l * K;
    // gradient P- conj(X) E / den (Kalman; and the posterior P) or
    // conj(X) E / den (NLMS) of bin k
    const auto grad = [&](int k) {
      const float2 xv = c2(s.x, xs + k), ev = c2(s.ye, k);
      const float xr = xv.x, xi = xv.y, er = ev.x, ei = ev.y, inv = s.den[k];
      if constexpr (kNlms) {
        return make_float2((xr * er + xi * ei) * inv, (xr * ei - xi * er) * inv);
      } else {
        const float pp = s.p[ws + k];
        s.p[ws + k] = fmaxf(pp * (1.f - pp * (xr * xr + xi * xi) * inv), kp.p_floor);
        return make_float2(pp * (xr * er + xi * ei), pp * (xr * ei - xi * er));
      }
    };
    // W[l] += its constrained update x (Kalman: then block t + 1's prediction)
    const auto update = [&](int k, float2 x) {
      const int i = ws + k;
      const float2 wv = c2(s.w, i);
      if constexpr (kNlms) {
        c2(s.w, i) = make_float2(wv.x + np.mu * x.x, wv.y + np.mu * x.y);
      } else {
        const float wr = wv.x + x.x, wi = wv.y + x.y;
        s.p[i] = kp.a2 * s.p[i] + kp.one_minus_a2 * (wr * wr + wi * wi) + kp.q_min;
        c2(s.w, i) = make_float2(kp.a * wr, kp.a * wi);
      }
    };
    for (int k = lane; 2 * k <= M; k += 32) {
      const int m = M - k;
      const float2 gk = grad(k), gm = m == k ? gk : grad(m);
      if (k == 0) {  // the inverse drops the imaginary parts of bins 0 and M
        c2(a, 0) = inv_split(make_float2(gk.x, 0.f), make_float2(gm.x, 0.f), c2(s.tw, 0), inv_n);
      } else {
        c2(a, k) = inv_split(gk, gm, c2(s.tw, k), inv_n);
        if (m != k) c2(a, m) = inv_split(gm, gk, c2(s.tw, m), inv_n);
      }
    }
    __syncwarp();
#ifdef AEC_NO_CONSTRAINT_FFT  // kernels/single_costs.py: the constraint without its transforms
    const SArr zw = a;
    (void)b;
#else
    const SArr zh = warp_fft<true>(plan, q, lane, BufSrc{a, M}, b, a, wtw);
    const SArr zo = zh.off == a.off ? b : a;
    const SArr zw = warp_fft<false>(plan, q, lane, ConstraintTailSrc{zh, M, B}, zo, zh, wtw);
#endif
    for (int k = lane; 2 * k <= M; k += 32) {
      float2 xk, xm;
      fwd_split_pair(zw, k, M, s.tw, xk, xm);
      update(k, xk);
      if (M - k != k) update(M - k, xm);
    }
  };

  if (warp == 0) analysis(0, 0);
  // thread tid's sample of far block t + 2 and mic block t + 1, loaded
  // during step t - 1 and stored during step t (the rest of a block wider
  // than the CTA is loaded where it is stored)
  float fx = 0.f, fm = 0.f;
  const auto fetch = [&](int t) {
    if (tid < B) {
      fx = sample(far, t + 2, tid);
      fm = sample(mic, t + 1, tid);
    }
  };
  fetch(0);
  __syncthreads();

  for (int t = 0; t < t_blocks; ++t) {
    const int head = t % L;

    // 1. X_t into its ring slot; per bin the echo estimate y = sum_l W[l] X[l]
    //    and Kalman's sum_l |X[l]|^2 P-[l] or NLMS's smoothed far power (and
    //    its per-warp sums)
    float pw = 0.f;
    for (int k = tid; k < K; k += kThreads) {
      c2(s.x, head * K + k) = c2(s.xn, k);
      float yr = 0.f, yi = 0.f, acc = 0.f;
      for (int l = 0; l < L; ++l) {
        const int ws = l * K + k;
        const float2 xv = c2(s.x, ring_slot(head, l, L) * K + k), wv = c2(s.w, ws);
        const float xr = xv.x, xi = xv.y;
        if constexpr (kNlms) acc += xr * xr + xi * xi;
        else acc += (xr * xr + xi * xi) * s.p[ws];
        yr += wv.x * xr - wv.y * xi;
        yi += wv.x * xi + wv.y * xr;
      }
      if constexpr (kNlms) {
        const float pk = np.ps * s.power[k] + np.one_minus_ps * acc;
        s.power[k] = pk;
        pw += pk;
      } else {
        s.den[k] = acc;
      }
      c2(s.ye, k) = make_float2(yr, yi);
    }
    if constexpr (kNlms) {  // every warp whole: lanes past the last bin add 0
      const float sum = warp_sum(pw);
      if (lane == 0) s.red[warp] = sum;
    }
    __syncthreads();

    // 2. warp 0: echo synthesis irfft(y); e = d - irfft(y)[B:] (out) and the
    //    residual spectrum E = rfft([0 || e])
    const SArr zy = fft_result(plan, work(0, 0), work(0, 1));
    const SArr zo = zy.off == work(0, 0).off ? work(0, 1) : work(0, 0);
    const SArr zr = fft_result(plan, zo, zy);
    if (warp == 0) {
#ifndef AEC_NO_ECHO_FFT  // kernels/single_costs.py: the echo and residual without transforms
      warp_fft<true>(plan, q, lane, EchoInvSrcC{s.ye, s.tw, M, inv_n}, work(0, 0), work(0, 1),
                     wtw);
      warp_fft<false>(plan, q, lane,
                      ResidualOutSrc{mic_of(t), zy, out + static_cast<size_t>(t) * B, B}, zo, zy,
                      wtw);
#endif
    }
    __syncthreads();

    // 3. all threads, per bin: psi, den, E / den (Kalman) or 1 / den (NLMS)
    {
      float total = 0.f;
      if constexpr (kNlms) {
#pragma unroll
        for (int w = 0; w < kWarps; ++w) total += s.red[w];
      }
      for (int k = tid; k < K; k += kThreads) {
        const float2 res = fwd_split(zr, 0, k, M, s.tw);
        const float er = res.x, ei = res.y;
        if constexpr (kNlms) {
          const float psi = np.es * s.psi[k] + np.one_minus_es * (er * er + ei * ei);
          s.psi[k] = psi;
          s.den[k] = 1.f / (s.power[k] + np.eps + np.eps_rel * (total / K) + np.beta * psi);
          c2(s.ye, k) = res;
        } else {
          const float psi =
              fmaxf(kp.obs * s.psi[k] + kp.one_minus_obs * (er * er + ei * ei), kp.p_floor);
          s.psi[k] = psi;
          const float inv = 1.f / (s.den[k] + 2.f * psi);
          s.den[k] = inv;
          c2(s.ye, k) = make_float2(er * inv, ei * inv);
        }
      }
    }
    __syncthreads();

    // 4. jobs 0..L-1 the partitions, job L the analysis of block t + 1, one
    //    warp each in turn; every thread stores its prefetched samples
    if (warp < s.jobs) {
      for (int j = warp; j <= L; j += s.jobs) {
        __syncwarp();  // the warp's buffers are free
        if (j < L) constrain(j, head, warp);
        else if (t + 1 < t_blocks) analysis(t + 1, warp);
      }
    }
    if (tid < B) {
      far_of(t + 2)[tid] = fx;
      mic_of(t + 1)[tid] = fm;
    }
    for (int j = tid + kThreads; j < B; j += kThreads) {
      far_of(t + 2)[j] = sample(far, t + 2, j);
      mic_of(t + 1)[j] = sample(mic, t + 1, j);
    }
    if (t + 1 < t_blocks) fetch(t + 1);
    __syncthreads();
  }
}

template <bool kNlms, class G, class Plan>
cudaError_t launch_fft_geom(const float* far, const float* mic, float* out, int t_blocks,
                            const G& q, const Plan& plan, const float* tw, const KalmanParams& kp,
                            const NlmsParams& np, int device, void* stream) {
  auto kernel = single_fft_kernel<kNlms, G, Plan>;
  const size_t smem = smem_bytes<SingleFftSmem<kNlms>>(q);
  cudaError_t err = set_smem(reinterpret_cast<const void*>(kernel), smem, device);
  if (err != cudaSuccess || t_blocks == 0) return err;
  kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(far, mic, out, t_blocks, q,
                                                                   plan, tw, kp, np);
  return cudaGetLastError();
}

template <bool kNlms>
int launch_fft(const float* far, const float* mic, float* out, int t_blocks, int block,
               int n_blocks, const float* tw, const int* radix, int n_pass,
               const KalmanParams& kp, const NlmsParams& np, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  RunPlan plan{};
  err = read_plan(radix, n_pass, block, plan);
  if (err != cudaSuccess) return err;
  return with_geom(block, n_blocks, -1, [&](auto q) -> cudaError_t {
    if constexpr (std::is_same_v<decltype(q), DefaultGeom>) {
      if (!is_default_plan(plan)) return cudaErrorInvalidValue;
      return launch_fft_geom<kNlms>(far, mic, out, t_blocks, q, DefaultPlan{}, tw, kp, np, device,
                                    stream);
    } else {
      return launch_fft_geom<kNlms>(far, mic, out, t_blocks, q, plan, tw, kp, np, device, stream);
    }
  });
}

}  // namespace

extern "C" int aec_single_cluster() { return kC; }

// shared memory of one CTA of the cluster at this geometry, bytes
extern "C" long long aec_single_smem(int block, int n_blocks, int nlms) {
  const Geom q = make_geom(block, n_blocks, 0);
  return static_cast<long long>(nlms ? smem_bytes<SingleSmem<true>>(q)
                                     : smem_bytes<SingleSmem<false>>(q));
}

extern "C" int aec_kalman_single(const float* far, const float* mic, float* out, int t_blocks,
                                 int block, int n_blocks, const float* fwd, const float* inv_tail,
                                 const float* inv_head, float a, float a2, float one_minus_a2,
                                 float q_min, float obs, float one_minus_obs, float floor_,
                                 float init_p, int device, void* stream) {
  const KalmanParams kp{a, a2, one_minus_a2, q_min, obs, one_minus_obs, floor_, init_p};
  return launch<false>(far, mic, out, t_blocks, block, n_blocks,
                       Stage1Bases{fwd, inv_tail, inv_head}, kp, NlmsParams{}, device, stream);
}

extern "C" int aec_nlms_single(const float* far, const float* mic, float* out, int t_blocks,
                               int block, int n_blocks, const float* fwd, const float* inv_tail,
                               const float* inv_head, float mu, float eps, float ps,
                               float one_minus_ps, float eps_rel, float beta, float es,
                               float one_minus_es, int device, void* stream) {
  const NlmsParams np{mu, eps, ps, one_minus_ps, eps_rel, beta, es, one_minus_es};
  return launch<true>(far, mic, out, t_blocks, block, n_blocks,
                      Stage1Bases{fwd, inv_tail, inv_head}, KalmanParams{}, np, device, stream);
}

// The FFT route's shared memory of its one CTA at this geometry, bytes.
extern "C" long long aec_single_fft_smem(int block, int n_blocks, int nlms) {
  const Geom q = make_geom(block, n_blocks, 0);
  return static_cast<long long>(nlms ? smem_bytes<SingleFftSmem<true>>(q)
                                     : smem_bytes<SingleFftSmem<false>>(q));
}

// The FFT route: tw (B, 2) the twiddle table, radix[n_pass] the plan of
// kernels/fft_plan.py.
extern "C" int aec_kalman_single_fft(const float* far, const float* mic, float* out, int t_blocks,
                                     int block, int n_blocks, const float* tw, const int* radix,
                                     int n_pass, float a, float a2, float one_minus_a2,
                                     float q_min, float obs, float one_minus_obs, float floor_,
                                     float init_p, int device, void* stream) {
  const KalmanParams kp{a, a2, one_minus_a2, q_min, obs, one_minus_obs, floor_, init_p};
  return launch_fft<false>(far, mic, out, t_blocks, block, n_blocks, tw, radix, n_pass, kp,
                           NlmsParams{}, device, stream);
}

extern "C" int aec_nlms_single_fft(const float* far, const float* mic, float* out, int t_blocks,
                                   int block, int n_blocks, const float* tw, const int* radix,
                                   int n_pass, float mu, float eps, float ps, float one_minus_ps,
                                   float eps_rel, float beta, float es, float one_minus_es,
                                   int device, void* stream) {
  const NlmsParams np{mu, eps, ps, one_minus_ps, eps_rel, beta, es, one_minus_es};
  return launch_fft<true>(far, mic, out, t_blocks, block, n_blocks, tw, radix, n_pass,
                          KalmanParams{}, np, device, stream);
}

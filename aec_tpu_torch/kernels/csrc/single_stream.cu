// Kernels K6 and K7: one utterance through the Kalman (K6) or NLMS (K7)
// stage 1 on one thread-block cluster.
//
// Replaces aec_tpu/kernels/pallas_kalman.py:150 kalman_filter_fused
// (pallas_call at :178) and aec_tpu/kernels/pallas_nlms.py:94
// nlms_filter_fused (pallas_call at :121), the single-stream TPU kernels that
// JAX routes every 1-D call to. One template over the filter, two C entry
// points. JAX computes the far spectra outside its kernel; here the far-frame
// analysis is fused as in K1, so the function is waveform in, waveform out.
//
// Design: latency of one stream, not throughput. The recursion is serial in
// time, so one utterance can only be spread over bins: a cluster of C = 16
// CTAs (the non-portable maximum, one CTA per SM) splits the K = B + 1 bins,
// CTA r owning [r K / C, (r + 1) K / C): 16 or 17 bins at B = 256 (257 is
// prime, so the last slice is longer). The geometry (block, L) is the
// caller's and the layout is carved at run time; the launch asks
// cudaOccupancyMaxActiveClusters first, and a card that cannot place the
// cluster (shared memory per CTA, cluster size) refuses the call.
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
// after a later one, so three syncs per step order all of it.
//
// What bounds it. Per step ~3.16 M FMA (K1's transforms) over 16 SMs, about
// 200 K per CTA, plus three cluster barriers and ~9 K remote reads per CTA;
// each CTA's slices of the three bases (at B = 256: fwd 512 x 34 columns,
// inv_tail / inv_head 34 x 256 rows: 139 KB of its ~192 KB) stay in shared
// memory for
// the whole launch, so nothing streams from L2 (the roof of K1-K5, PERF.md
// section 5). The card's own bound for the work (the FMAs over all 132 SMs)
// is far below what one cluster can reach: the step's latency - the serial
// chain of products, block barriers and cluster exchanges - sets the time.

#include <cooperative_groups.h>

#include "bl_common.cuh"

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
  return with_geom(block, n_blocks, -1, [&](auto q) {
    return launch_geom<kNlms>(far, mic, out, t_blocks, q, bs, kp, np, device, stream);
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

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
// CTAs (the non-portable maximum, one CTA per SM) splits the K = 257 bins,
// CTA r owning [r K / C, (r + 1) K / C): 16 or 17 bins (257 is prime, so the
// last slice is longer). The launch asks cudaOccupancyMaxActiveClusters
// first; a card that cannot place the cluster refuses the call.
// Per step everything per bin (predict / far power, gain, psi, the update)
// is CTA-local, and so are the own columns of the far-frame and residual
// analyses (each CTA holds the whole frame and block). The only cross-bin
// work is the echo synthesis, the constraint head (partial sums over each
// CTA's bins) and NLMS's mean of the far power, reduced across the cluster
// through distributed shared memory:
//   X1 after each CTA has its share of irfft(y)[B:] (and of sum_k power):
//      every CTA sums the C shares in rank order, so all hold the same e;
//   X2 after each CTA has its share of the L x B constraint head: CTA r
//      sums the C shares of its span of B / C samples (reduce-scatter);
//   X3 after the spans are reduced: every CTA gathers the other spans.
// Each exchange is a cluster.sync() between the writes and the remote
// reads; every buffer read remotely at one exchange is written again only
// after a later one, so three syncs per step order all of it.
//
// What bounds it. Per step ~3.16 M FMA (K1's transforms) over 16 SMs, about
// 200 K per CTA, plus three cluster barriers and ~9 K remote reads per CTA;
// each CTA's slices of the three bases (fwd 512 x 34 columns, inv_tail /
// inv_head 34 x 256 rows: 139 KB of its ~192 KB) stay in shared memory for
// the whole launch, so nothing streams from L2 (the roof of K1-K5, PERF.md
// section 5). The card's own bound for the work (the FMAs over all 132 SMs)
// is far below what one cluster can reach: the step's latency - the serial
// chain of products, block barriers and cluster exchanges - sets the time.

#include <cooperative_groups.h>

#include "bl_common.cuh"

namespace cg = cooperative_groups;
using namespace aec;

namespace {

constexpr int kL = 10;  // KalmanConfig.n_blocks == NlmsConfig.n_blocks
constexpr int kC = 16;  // CTAs per cluster
constexpr int kB = (kBins + kC - 1) / kC;  // the longest bin slice: 17
constexpr int kCols = 2 * kB;              // own ri columns [re || im]: 34
constexpr int kSl = kThreads / kCols;      // n-slices of a column product: 16
constexpr int kSpan = kBlock / kC;         // head samples reduced per CTA: 16
static_assert(kBlock % kC == 0 && kL * kSpan <= kThreads, "");
static_assert(kFrame % kSl == 0 && kBlock % kSl == 0, "");

template <bool kNlms>
struct SingleSmem {
  float fwd[kFrame * kCols];       // own columns of fwd, (n, c)
  float inv_tail[kCols * kBlock];  // own rows of inv_tail, (c, j)
  float inv_head[kCols * kBlock];  // own rows of inv_head, (c, j)
  float wr[kL * kB], wi[kL * kB];  // filter, own bins
  float xr[kL * kB], xi[kL * kB];  // far-spectrum ring, own bins
  float p[kNlms ? 1 : kL * kB];    // Kalman covariance
  float power[kNlms ? kB : 1];     // NLMS smoothed far power
  float psi[kB], den[kB];          // residual psd; den (Kalman) or 1/den (NLMS)
  float frame[kFrame];             // [previous far block || current]
  float d[kBlock], e[kBlock];      // mic block; residual block
  float y[kCols], er[kCols];       // own bins' echo estimate, residual spectrum
  float g[kL * kCols];             // own bins' update per partition
  float part[kSl * kL * kCols];    // n-slice partials of the column products
  float ehalf[kBlock];             // imaginary half of this CTA's share
  float epart[kBlock + 1];  // this CTA's share of irfft(y)[B:], then of sum_k power (remote)
  float tpart[kL * kBlock];  // this CTA's share of the constraint head (remote)
  float t[kL * kBlock];      // the whole head; the own span reduced here (remote)
  float mean;                // NLMS: mean_k(power)
};

template <bool kNlms>
__global__ void __launch_bounds__(kThreads, 1)
single_stream_kernel(const float* __restrict__ far, const float* __restrict__ mic,
                     float* __restrict__ out, int t_blocks, Stage1Bases bs, KalmanParams kp,
                     NlmsParams np) {
  extern __shared__ float4 smem_raw[];
  SingleSmem<kNlms>& s = *reinterpret_cast<SingleSmem<kNlms>*>(smem_raw);
  cg::cluster_group cluster = cg::this_cluster();
  const int r = static_cast<int>(cluster.block_rank());
  const int lo = r * kBins / kC, nb = (r + 1) * kBins / kC - lo;
  const int tid = threadIdx.x;

  // the own slices of the bases (own column c: bin lo + c % kB, the real
  // half for c < kB; the columns past nb stay 0), then the initial state
  auto gcol = [&](int c) { return (c / kB) * kBins + lo + c % kB; };
  for (int i = tid; i < kFrame * kCols; i += kThreads) {
    const int n = i / kCols, c = i % kCols;
    s.fwd[i] = c % kB < nb ? bs.fwd[n * kRi + gcol(c)] : 0.f;
  }
  for (int i = tid; i < kCols * kBlock; i += kThreads) {
    const int c = i / kBlock, j = i % kBlock;
    const bool own = c % kB < nb;
    s.inv_tail[i] = own ? bs.inv_tail[gcol(c) * kBlock + j] : 0.f;
    s.inv_head[i] = own ? bs.inv_head[gcol(c) * kBlock + j] : 0.f;
  }
  for (int i = tid; i < kL * kB; i += kThreads) {
    s.wr[i] = 0.f; s.wi[i] = 0.f; s.xr[i] = 0.f; s.xi[i] = 0.f;
    if constexpr (!kNlms) s.p[i] = kp.init_p;
  }
  for (int i = tid; i < kB; i += kThreads) {
    s.psi[i] = kNlms ? 0.f : kp.p_floor;
    if constexpr (kNlms) s.power[i] = 0.f;
  }
  for (int i = tid; i < kFrame; i += kThreads) s.frame[i] = 0.f;
  cluster.sync();  // every CTA of the cluster runs before any remote read

  const int c_of = tid % kCols, sl = tid / kCols;  // (column, n-slice) of the column products
  const int j = tid % kBlock, half = tid / kBlock;  // (sample, re/im half) of the row products

  for (int t = 0; t < t_blocks; ++t) {
    const size_t off = static_cast<size_t>(t) * kBlock;
    const int head = t % kL;
    if (tid < kBlock) {
      s.frame[kBlock + tid] = far[off + tid];
      s.d[tid] = mic[off + tid];
    }
    __syncthreads();

    // 1. far-frame analysis, own columns: n-slice partials, then their sum
    if (sl < kSl) {
      constexpr int kN = kFrame / kSl;
      float acc = 0.f;
#pragma unroll 8
      for (int n = sl * kN; n < (sl + 1) * kN; ++n)
        acc = fmaf(s.frame[n], s.fwd[n * kCols + c_of], acc);
      s.part[sl * kCols + c_of] = acc;
    }
    __syncthreads();
    if (tid < kCols && tid % kB < nb) {
      float acc = 0.f;
      for (int q = 0; q < kSl; ++q) acc += s.part[q * kCols + tid];
      (tid < kB ? s.xr : s.xi)[head * kB + tid % kB] = acc;
    }
    __syncthreads();

    // 2. far ring shift; per own bin: predict (Kalman) or the smoothed far
    //    power (NLMS); echo-estimate spectrum y = sum_l W[l] X[l]
    if (tid < kBlock) s.frame[tid] = s.frame[kBlock + tid];
    if (tid < nb) {
      const int b = tid;
      float yr = 0.f, yi = 0.f, inst = 0.f;
#pragma unroll
      for (int l = 0; l < kL; ++l) {
        const int xs = ((head - l + kL) % kL) * kB + b, ws = l * kB + b;
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
      s.y[kB + b] = yi;
    }
    __syncthreads();

    // 3. this CTA's share of irfft(y)[B:] (halves summed apart); the last
    //    warp adds up this CTA's far power for the mean
    float acc_y = 0.f;
    if (half < 2) {
      for (int b = 0; b < nb; ++b)
        acc_y = fmaf(s.y[half * kB + b], s.inv_tail[(half * kB + b) * kBlock + j], acc_y);
      if (half == 1) s.ehalf[j] = acc_y;
    } else if constexpr (kNlms) {  // tid >= 2 kBlock: one whole warp
      const int lane = tid - 2 * kBlock;
      const float v = warp_sum(lane < nb ? s.power[lane] : 0.f);  // nb <= kB < 32
      if (lane == 0) s.epart[kBlock] = v;
    }
    __syncthreads();
    if (half == 0) s.epart[j] = acc_y + s.ehalf[j];
    cluster.sync();  // X1

    // 4. e = d - irfft(y)[B:], the shares summed in rank order; the mean power
    if (tid <= kBlock) {
      float acc = 0.f;
      for (int q = 0; q < kC; ++q) acc += *cluster.map_shared_rank(&s.epart[tid], q);
      if (tid < kBlock) s.e[tid] = s.d[tid] - acc;
      else if (kNlms) s.mean = acc / kBins;
    }
    __syncthreads();

    // 5. residual spectrum E = rfft([0 || e]), own columns
    if (sl < kSl) {
      constexpr int kN = kBlock / kSl;
      float acc = 0.f;
#pragma unroll 8
      for (int n = sl * kN; n < (sl + 1) * kN; ++n)
        acc = fmaf(s.e[n], s.fwd[(kBlock + n) * kCols + c_of], acc);
      s.part[sl * kCols + c_of] = acc;
    }
    __syncthreads();
    if (tid < kCols) {
      float acc = 0.f;
      for (int q = 0; q < kSl; ++q) acc += s.part[q * kCols + tid];
      s.er[tid] = acc;
    }
    __syncthreads();

    // 6. per own bin: psi and the gain's denominator
    if (tid < nb) {
      const int b = tid;
      const float er = s.er[b], ei = s.er[kB + b];
      if constexpr (kNlms) {
        const float psi = np.es * s.psi[b] + np.one_minus_es * (er * er + ei * ei);
        s.psi[b] = psi;
        s.den[b] = 1.f / (s.power[b] + np.eps + np.eps_rel * s.mean + np.beta * psi);
      } else {
        const float psi =
            fmaxf(kp.obs * s.psi[b] + kp.one_minus_obs * (er * er + ei * ei), kp.p_floor);
        s.psi[b] = psi;
        float den = 0.f;
#pragma unroll
        for (int l = 0; l < kL; ++l) {
          const int xs = ((head - l + kL) % kL) * kB + b;
          den += (s.xr[xs] * s.xr[xs] + s.xi[xs] * s.xi[xs]) * s.p[l * kB + b];
        }
        den += 2.f * psi;
        s.den[b] = den;
        s.er[b] = er / den;
        s.er[kB + b] = ei / den;
      }
    }
    __syncthreads();

    // 7. update per partition and own bin (and the covariance, Kalman)
    for (int i = tid; i < kL * kB; i += kThreads) {
      const int l = i / kB, b = i % kB;
      float gr = 0.f, gi = 0.f;
      if (b < nb) {
        const int xs = ((head - l + kL) % kL) * kB + b;
        const float xr = s.xr[xs], xi = s.xi[xs], er = s.er[b], ei = s.er[kB + b];
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
      s.g[l * kCols + b] = gr;
      s.g[l * kCols + kB + b] = gi;
    }
    __syncthreads();

    // 8. this CTA's share of the constraint head irfft(G[l])[:B]
    float acc_t[kL];
#pragma unroll
    for (int l = 0; l < kL; ++l) acc_t[l] = 0.f;
    if (half < 2) {
      for (int b = 0; b < nb; ++b) {
        const int c = half * kB + b;
        const float ih = s.inv_head[c * kBlock + j];
#pragma unroll
        for (int l = 0; l < kL; ++l) acc_t[l] = fmaf(s.g[l * kCols + c], ih, acc_t[l]);
      }
      if (half == 1) {
#pragma unroll
        for (int l = 0; l < kL; ++l) s.tpart[l * kBlock + j] = acc_t[l];
      }
    }
    __syncthreads();
    if (half == 0) {
#pragma unroll
      for (int l = 0; l < kL; ++l) s.tpart[l * kBlock + j] += acc_t[l];
    }
    cluster.sync();  // X2

    // 9. reduce-scatter: the C shares of this CTA's span, in rank order
    if (tid < kL * kSpan) {
      const int i = (tid / kSpan) * kBlock + r * kSpan + tid % kSpan;
      float acc = 0.f;
      for (int q = 0; q < kC; ++q) acc += *cluster.map_shared_rank(&s.tpart[i], q);
      s.t[i] = acc;
    }
    cluster.sync();  // X3

    // 10. all-gather the other spans
    for (int i = tid; i < kL * kBlock; i += kThreads) {
      const int q = (i % kBlock) / kSpan;
      if (q != r) s.t[i] = *cluster.map_shared_rank(&s.t[i], q);
    }
    __syncthreads();

    // 11. constraint tail rfft([t[l] || 0]) on the own columns, partitions
    //     in registers; W[l] += it (Kalman) or mu times it (NLMS)
    if (sl < kSl) {
      constexpr int kN = kBlock / kSl;
      float acc[kL];
#pragma unroll
      for (int l = 0; l < kL; ++l) acc[l] = 0.f;
      for (int n = sl * kN; n < (sl + 1) * kN; ++n) {
        const float fb = s.fwd[n * kCols + c_of];
#pragma unroll
        for (int l = 0; l < kL; ++l) acc[l] = fmaf(s.t[l * kBlock + n], fb, acc[l]);
      }
#pragma unroll
      for (int l = 0; l < kL; ++l) s.part[(sl * kL + l) * kCols + c_of] = acc[l];
    }
    __syncthreads();
    for (int i = tid; i < kL * kCols; i += kThreads) {
      const int l = i / kCols, c = i % kCols, b = c % kB;
      if (b < nb) {
        float acc = 0.f;
        for (int q = 0; q < kSl; ++q) acc += s.part[(q * kL + l) * kCols + c];
        float* w = c < kB ? s.wr : s.wi;
        if constexpr (kNlms) w[l * kB + b] += np.mu * acc;
        else w[l * kB + b] += acc;
      }
    }
    // 12. every CTA holds the whole residual block: each writes its span
    if (tid < kSpan) out[off + r * kSpan + tid] = s.e[r * kSpan + tid];
    __syncthreads();
  }
  cluster.sync();  // no CTA leaves while another may still read its memory
}

// Launches one cluster, after asking whether the card can place it.
template <bool kNlms>
int launch(const float* far, const float* mic, float* out, int t_blocks, const Stage1Bases& bs,
           const KalmanParams& kp, const NlmsParams& np, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  auto kernel = single_stream_kernel<kNlms>;
  const size_t smem = sizeof(SingleSmem<kNlms>);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
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
  err = cudaLaunchKernelEx(&cfg, kernel, far, mic, out, t_blocks, bs, kp, np);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" int aec_single_n_blocks() { return kL; }

extern "C" int aec_single_cluster() { return kC; }

extern "C" int aec_kalman_single(const float* far, const float* mic, float* out, int t_blocks,
                                 const float* fwd, const float* inv_tail, const float* inv_head,
                                 float a, float a2, float one_minus_a2, float q_min, float obs,
                                 float one_minus_obs, float floor_, float init_p, int device,
                                 void* stream) {
  const KalmanParams kp{a, a2, one_minus_a2, q_min, obs, one_minus_obs, floor_, init_p};
  return launch<false>(far, mic, out, t_blocks, Stage1Bases{fwd, inv_tail, inv_head}, kp,
                       NlmsParams{}, device, stream);
}

extern "C" int aec_nlms_single(const float* far, const float* mic, float* out, int t_blocks,
                               const float* fwd, const float* inv_tail, const float* inv_head,
                               float mu, float eps, float ps, float one_minus_ps, float eps_rel,
                               float beta, float es, float one_minus_es, int device,
                               void* stream) {
  const NlmsParams np{mu, eps, ps, one_minus_ps, eps_rel, beta, es, one_minus_es};
  return launch<true>(far, mic, out, t_blocks, Stage1Bases{fwd, inv_tail, inv_head},
                      KalmanParams{}, np, device, stream);
}

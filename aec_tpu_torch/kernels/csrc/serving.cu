// Kernel K3: k two-stage serving hops for S live streams, state in place.
//
// Replaces aec_tpu/kernels/pallas_serving.py:239 serving_step_fused
// (pallas_call at :320), the TPU kernel of the streaming serving runtime,
// for both of its stage-1 filters: one template over the filter, with one C
// entry point for Kalman (aec_serving) and one for NLMS (aec_serving_nlms).
//
// Design. On the TPU the grid walked tiles of 128 streams held in lanes, and
// Pallas double-buffered each tile's state through VMEM. Here one CTA owns
// one stream: it loads the stream's state (~56 KB with Kalman: filter,
// covariance, far-spectrum ring, psi, previous blocks, GRU h, OLA tail, the
// 8-row `nm` vector; ~47 KB with NLMS, whose `p` leaf is the (S, K) smoothed
// far power in place of the (S, L, K) covariance) from device memory into
// shared memory with coalesced loads, runs bl_common.cuh's
// two_stage_block_step once per queued block (stage-1 block update, the
// cancelled block handed to stage 2 in shared memory, LittleNet frame,
// monitor EMAs and, with `normalize`, the causal pseudo-norm), and writes the
// state back in place. A call with k blocks pays the state round trip once
// (the chunked dispatch of pallas_serving.py:255-262).
//
// The far-spectrum ring is stored in age order ([l] is l blocks old, as
// StreamState's x_buf), so the host-side migrations are pure reshapes. In
// shared memory the stage-1 steps keep it in slots: at step t partition l
// is slot (t - l) mod L. A launch counts t from 0, so the load puts age a in
// slot L - 1 - a (step 0 pushes into slot 0 and reads age a as partition
// a + 1), and after the last step t = k - 1 age l is read from slot
// (k - 1 - l) mod L.
//
// What bounds it. Per stream and hop, the ~4 M FMA of one stage-1 step and
// one K2 frame re-read ~5.3 MB of fp32 DFT bases from L2; the state round
// trip is 2 x ~56 KB from device memory. At S = 1024 that is 116 MB of state
// (~35 us at the HBM rate) against 5.5 GB of basis reads from L2, so the
// kernel is bound by each SM's L2 read rate, as K1 and K2 are. Stage 2's
// scratch lies over stage 1's (TwoStageSmem), so a CTA takes 107,120 B
// (Kalman) or 97,904 B (NLMS) of shared memory and two fit on an SM.
// Several streams per CTA sharing each basis read, FFT-based transforms and
// tensor cores are the levers left (ROADMAP queue D).

#include <type_traits>

#include "bl_common.cuh"

using namespace aec;

namespace {

constexpr int kL = 10;  // KalmanConfig.n_blocks == NlmsConfig.n_blocks

struct ServingPtrs {  // the ServingState leaves, per-stream contiguous
  float *wr, *wi;     // (S, L, K)
  float* p;           // Kalman covariance (S, L, K) | NLMS far power (S, K)
  float *xbr, *xbi;   // (S, L, K)
  float* psi;         // (S, K)
  float* fprev;       // (S, kBlock) stage-1 previous far block
  float* h;           // (S, kBands)
  float *tail, *prev_lin, *prev_far;  // (S, kBlock)
  float* nm;          // (S, kNmRows)
};

// Moves one stream's state between device memory and shared memory.
template <bool kStore, class S1>
__device__ void move_state(TwoStageSmem<S1>& s, const ServingPtrs& g, size_t stream,
                           int k_blocks) {
  constexpr bool kKalman = std::is_same<S1, KalmanSmem<kL>>::value;
  const int tid = threadIdx.x;
  const size_t lk = stream * kL * kBins, sk = stream * kBins;
  for (int i = tid; i < kL * kBins; i += kThreads) {
    const int l = i / kBins, k = i - l * kBins;
    const int slot = kStore ? ((k_blocks - 1 - l) % kL + kL) % kL : kL - 1 - l;
    const int r = slot * kBins + k;
    if (kStore) {
      g.wr[lk + i] = s.s1.wr[i]; g.wi[lk + i] = s.s1.wi[i];
      g.xbr[lk + i] = s.s1.xr[r]; g.xbi[lk + i] = s.s1.xi[r];
    } else {
      s.s1.wr[i] = g.wr[lk + i]; s.s1.wi[i] = g.wi[lk + i];
      s.s1.xr[r] = g.xbr[lk + i]; s.s1.xi[r] = g.xbi[lk + i];
    }
    if constexpr (kKalman) {
      if (kStore) g.p[lk + i] = s.s1.p[i];
      else s.s1.p[i] = g.p[lk + i];
    }
  }
  for (int i = tid; i < kBins; i += kThreads) {
    if (kStore) g.psi[sk + i] = s.s1.psi[i];
    else s.s1.psi[i] = g.psi[sk + i];
    if constexpr (!kKalman) {
      if (kStore) g.p[sk + i] = s.s1.power[i];
      else s.s1.power[i] = g.p[sk + i];
    }
  }
  if (tid < kBlock) {
    const size_t o = stream * kBlock + tid;
    if (kStore) {
      g.fprev[o] = s.s1.frame[tid]; g.tail[o] = s.s2.tail[tid];
      g.prev_lin[o] = s.s2.lin[tid]; g.prev_far[o] = s.s2.far[tid];
    } else {
      s.s1.frame[tid] = g.fprev[o]; s.s2.tail[tid] = g.tail[o];
      s.s2.lin[tid] = g.prev_lin[o]; s.s2.far[tid] = g.prev_far[o];
    }
  }
  if (tid < kBands) {
    if (kStore) g.h[stream * kBands + tid] = s.s2.h[tid];
    else s.s2.h[tid] = g.h[stream * kBands + tid];
  }
  if (tid < kNmRows) {
    if (kStore) g.nm[stream * kNmRows + tid] = s.nm[tid];
    else s.nm[tid] = g.nm[stream * kNmRows + tid];
  }
}

template <class S1, class P>
__global__ void __launch_bounds__(kThreads, 2)
serving_kernel(const float* __restrict__ far, const float* __restrict__ mic,
               float* __restrict__ out, ServingPtrs g, int k_blocks, Stage1Bases bs, P kp,
               Stage2Weights w, int gain_norm, int normalize) {
  extern __shared__ float4 smem_raw[];
  TwoStageSmem<S1>& s = *reinterpret_cast<TwoStageSmem<S1>*>(smem_raw);
  const size_t stream = blockIdx.x;
  const size_t io = stream * k_blocks * kBlock;
  const int tid = threadIdx.x;

  move_state<false>(s, g, stream, k_blocks);
  for (int u = 0; u < k_blocks; ++u) {
    if (tid < kBlock) {
      s.s1.frame[kBlock + tid] = far[io + u * kBlock + tid];
      s.s1.e[tid] = mic[io + u * kBlock + tid];
    }
    __syncthreads();
    two_stage_block_step(s, u, kp, bs, w, gain_norm != 0, true, normalize != 0);
    if (tid < kBlock) out[io + u * kBlock + tid] = s.x().out[tid];
  }
  move_state<true>(s, g, stream, k_blocks);
}

template <class S1, class P>
int launch(const float* far, const float* mic, float* out, const ServingPtrs& g, int streams,
           int k_blocks, const Stage1Bases& bs, const P& kp, const Stage2Weights& w,
           int gain_norm, int normalize, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int smem = static_cast<int>(sizeof(TwoStageSmem<S1>));
  err = cudaFuncSetAttribute(serving_kernel<S1, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  if (streams == 0 || k_blocks == 0) return cudaSuccess;
  serving_kernel<S1, P><<<streams, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      far, mic, out, g, k_blocks, bs, kp, w, gain_norm, normalize);
  return cudaGetLastError();
}

}  // namespace

extern "C" int aec_serving_n_blocks() { return kL; }

// Kalman stage 1: c0..c7 are the KalmanParams (a, a2, 1 - a2, q_min, obs,
// 1 - obs, floor, init_p); NLMS stage 1: the NlmsParams (mu, eps, ps,
// 1 - ps, eps_rel, beta, es, 1 - es). The argument lists are otherwise equal.
#define AEC_SERVING_ARGS                                                                     \
  const float *far, const float *mic, float *out, float *wr, float *wi, float *p, float *xbr, \
      float *xbi, float *psi, float *fprev, float *h, float *tail, float *prev_lin,           \
      float *prev_far, float *nm, int streams, int k_blocks, const float *fwd,                \
      const float *inv_tail, const float *inv_head, float c0, float c1, float c2, float c3,   \
      float c4, float c5, float c6, float c7, const float *analysis, const float *synthesis, \
      const float *erb, const float *erb_t, const float *w_ih_t, const float *w_hh_t,        \
      const float *b_ih, const float *b_hh, const float *w1_t, const float *b1,              \
      const float *w2_t, const float *b2, const float *inv_env, int gain_norm, int normalize, \
      int device, void *stream

#define AEC_SERVING_LAUNCH(S1, PARAMS)                                                        \
  const ServingPtrs g{wr, wi, p, xbr, xbi, psi, fprev, h, tail, prev_lin, prev_far, nm};      \
  const Stage2Weights w{analysis, synthesis, erb, erb_t, w_ih_t, w_hh_t, b_ih,               \
                        b_hh,     w1_t,      b1,  w2_t,  b2,     inv_env};                    \
  return launch<S1>(far, mic, out, g, streams, k_blocks, Stage1Bases{fwd, inv_tail, inv_head}, \
                    PARAMS{c0, c1, c2, c3, c4, c5, c6, c7}, w, gain_norm, normalize, device,  \
                    stream)

extern "C" int aec_serving(AEC_SERVING_ARGS) { AEC_SERVING_LAUNCH(KalmanSmem<kL>, KalmanParams); }

extern "C" int aec_serving_nlms(AEC_SERVING_ARGS) { AEC_SERVING_LAUNCH(NlmsSmem<kL>, NlmsParams); }

// Kernel K3: k two-stage serving hops for S live streams, state in place.
//
// Replaces aec_tpu/kernels/pallas_serving.py:239 serving_step_fused
// (pallas_call at :320), the TPU kernel of the streaming serving runtime,
// for both of its stage-1 filters: one template over the filter, with one C
// entry point for Kalman (aec_serving) and one for NLMS (aec_serving_nlms).
//
// Design. On the TPU the grid walked tiles of 128 streams held in lanes, and
// Pallas double-buffered each tile's state through VMEM. Here one CTA owns
// one stream: it loads the stream's state (~56 KB with Kalman at the default
// geometry, carved at run time for the caller's hop, L and bands: filter,
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
// kernel is bound by each SM's L2 read rate, as K4 and K5 are. Stage 2's
// scratch lies over stage 1's (TwoStageSmem), so at the default geometry a
// CTA takes ~107 KB (Kalman) or ~98 KB (NLMS) of shared memory and two fit on
// an SM.
// Several streams per CTA sharing each basis read, FFT-based transforms and
// tensor cores are the levers left (ROADMAP queue D).

#include <type_traits>

#include "bl_common.cuh"

using namespace aec;

namespace {

struct ServingPtrs {  // the ServingState leaves, per-stream contiguous
  float *wr, *wi;     // (S, L, K)
  float* p;           // Kalman covariance (S, L, K) | NLMS far power (S, K)
  float *xbr, *xbi;   // (S, L, K)
  float* psi;         // (S, K)
  float* fprev;       // (S, B) stage-1 previous far block
  float* h;           // (S, E)
  float *tail, *prev_lin, *prev_far;  // (S, B)
  float* nm;          // (S, kNmRows)
};

// Moves one stream's state between device memory and shared memory.
template <bool kStore, class S1, class G>
__device__ void move_state(const TwoStageSmem<S1>& s, const G& q, const ServingPtrs& g,
                           size_t stream, int k_blocks) {
  constexpr bool kKalman = std::is_same<S1, KalmanSmem>::value;
  const int tid = threadIdx.x, L = q.L, K = q.bins, B = q.block, E = q.bands;
  const size_t lk = stream * L * K, sk = stream * K;
  for (int i = tid; i < L * K; i += kThreads) {
    const int l = i / K, k = i - l * K;
    const int slot = kStore ? ((k_blocks - 1 - l) % L + L) % L : L - 1 - l;
    const int r = slot * K + k;
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
  for (int i = tid; i < K; i += kThreads) {
    if (kStore) g.psi[sk + i] = s.s1.psi[i];
    else s.s1.psi[i] = g.psi[sk + i];
    if constexpr (!kKalman) {
      if (kStore) g.p[sk + i] = s.s1.power[i];
      else s.s1.power[i] = g.p[sk + i];
    }
  }
  for (int j = tid; j < B; j += kThreads) {
    const size_t o = stream * B + j;
    if (kStore) {
      g.fprev[o] = s.s1.frame[j]; g.tail[o] = s.s2.tail[j];
      g.prev_lin[o] = s.s2.lin[j]; g.prev_far[o] = s.s2.far[j];
    } else {
      s.s1.frame[j] = g.fprev[o]; s.s2.tail[j] = g.tail[o];
      s.s2.lin[j] = g.prev_lin[o]; s.s2.far[j] = g.prev_far[o];
    }
  }
  for (int e = tid; e < E; e += kThreads) {
    if (kStore) g.h[stream * E + e] = s.s2.h[e];
    else s.s2.h[e] = g.h[stream * E + e];
  }
  if (tid < kNmRows) {
    if (kStore) g.nm[stream * kNmRows + tid] = s.nm[tid];
    else s.nm[tid] = g.nm[stream * kNmRows + tid];
  }
}

template <class S1, class P, class G>
__global__ void __launch_bounds__(kThreads, 2)
serving_kernel(const float* __restrict__ far, const float* __restrict__ mic,
               float* __restrict__ out, ServingPtrs g, int k_blocks, G q, Stage1Bases bs, P kp,
               Stage2Weights w, int gain_norm, int normalize) {
  Carve c;
  const TwoStageSmem<S1> s(c, q);
  const int B = q.block;
  const size_t stream = blockIdx.x;
  const size_t io = stream * k_blocks * B;
  const int tid = threadIdx.x;

  move_state<false>(s, q, g, stream, k_blocks);
  for (int u = 0; u < k_blocks; ++u) {
    for (int j = tid; j < B; j += kThreads) {
      s.s1.frame[B + j] = far[io + u * B + j];
      s.s1.e[j] = mic[io + u * B + j];
    }
    __syncthreads();
    two_stage_block_step(s, q, u, kp, bs, w, gain_norm != 0, true, normalize != 0);
    for (int j = tid; j < B; j += kThreads) out[io + u * B + j] = s.x.out[j];
  }
  move_state<true>(s, q, g, stream, k_blocks);
}

template <class S1, class P>
int launch(const float* far, const float* mic, float* out, const ServingPtrs& g, int streams,
           int k_blocks, int block, int n_blocks, int bands, const Stage1Bases& bs, const P& kp,
           const Stage2Weights& w, int gain_norm, int normalize, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return with_geom(block, n_blocks, bands, [&](auto q) {
    auto kernel = serving_kernel<S1, P, decltype(q)>;
    const size_t smem = smem_bytes<TwoStageSmem<S1>>(q);
    cudaError_t e2 = set_smem(reinterpret_cast<const void*>(kernel), smem, device);
    if (e2 != cudaSuccess || streams == 0 || k_blocks == 0) return e2;
    kernel<<<streams, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        far, mic, out, g, k_blocks, q, bs, kp, w, gain_norm, normalize);
    return cudaGetLastError();
  });
}

}  // namespace

// shared memory of one CTA at this geometry, bytes (nlms: the NLMS state)
extern "C" long long aec_serving_smem(int block, int n_blocks, int bands, int nlms) {
  const Geom q = make_geom(block, n_blocks, bands);
  return static_cast<long long>(nlms ? smem_bytes<TwoStageSmem<NlmsSmem>>(q)
                                     : smem_bytes<TwoStageSmem<KalmanSmem>>(q));
}

// Kalman stage 1: c0..c7 are the KalmanParams (a, a2, 1 - a2, q_min, obs,
// 1 - obs, floor, init_p); NLMS stage 1: the NlmsParams (mu, eps, ps,
// 1 - ps, eps_rel, beta, es, 1 - es). The argument lists are otherwise equal.
#define AEC_SERVING_ARGS                                                                     \
  const float *far, const float *mic, float *out, float *wr, float *wi, float *p, float *xbr, \
      float *xbi, float *psi, float *fprev, float *h, float *tail, float *prev_lin,           \
      float *prev_far, float *nm, int streams, int k_blocks, int block, int n_blocks,         \
      int bands, const float *fwd, const float *inv_tail, const float *inv_head, float c0,    \
      float c1, float c2, float c3, float c4, float c5, float c6, float c7,                   \
      const float *analysis, const float *synthesis, const float *erb, const float *erb_t,   \
      const float *w_ih_t, const float *w_hh_t, const float *b_ih, const float *b_hh,        \
      const float *w1_t, const float *b1, const float *w2_t, const float *b2,                \
      const float *inv_env, int gain_norm, int normalize, int device, void *stream

#define AEC_SERVING_LAUNCH(S1, PARAMS)                                                        \
  const ServingPtrs g{wr, wi, p, xbr, xbi, psi, fprev, h, tail, prev_lin, prev_far, nm};      \
  const Stage2Weights w{analysis, synthesis, erb, erb_t, w_ih_t, w_hh_t, b_ih,               \
                        b_hh,     w1_t,      b1,  w2_t,  b2,     inv_env};                    \
  return launch<S1>(far, mic, out, g, streams, k_blocks, block, n_blocks, bands,              \
                    Stage1Bases{fwd, inv_tail, inv_head}, PARAMS{c0, c1, c2, c3, c4, c5, c6, c7}, \
                    w, gain_norm, normalize, device, stream)

extern "C" int aec_serving(AEC_SERVING_ARGS) { AEC_SERVING_LAUNCH(KalmanSmem, KalmanParams); }

extern "C" int aec_serving_nlms(AEC_SERVING_ARGS) { AEC_SERVING_LAUNCH(NlmsSmem, NlmsParams); }

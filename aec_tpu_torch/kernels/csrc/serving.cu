// Kernel K3: k two-stage serving hops for S live streams, state in place.
//
// Replaces aec_tpu/kernels/pallas_serving.py:239 serving_step_fused
// (pallas_call at :320), the TPU kernel of the streaming serving runtime,
// for both of its stage-1 filters: one template over the filter and the hop
// (hop.cuh), one C entry point.
//
// Design. On the TPU the grid walked tiles of 128 streams held in lanes, and
// Pallas double-buffered each tile's state through VMEM. Here one CTA owns
// one stream: it loads the stream's state (~56 KB with Kalman at the default
// geometry, carved at run time for the caller's hop, L and bands: filter,
// covariance, far-spectrum ring, psi, previous blocks, GRU h, OLA tail, the
// 8-row `nm` vector; ~47 KB with NLMS, whose `p` leaf is the (S, K) smoothed
// far power in place of the (S, L, K) covariance) from device memory into
// shared memory with coalesced loads, runs hop.cuh's two-stage hop once per
// queued block (stage-1 block update on FFTs, the cancelled block handed to
// stage 2 in shared memory, the LittleNet frame on FFTs, monitor EMAs and,
// with `normalize`, the causal pseudo-norm), and writes the state back in
// place. A call with k blocks pays the state round trip once (the chunked
// dispatch of pallas_serving.py:255-262). A hop without a radix plan runs
// the dense hop of bl_common.cuh on the same state.
//
// The state in device memory is the JAX layout's: W and P the posterior of
// the last block, the far-spectrum ring in age order ([l] is l blocks old,
// as StreamState's x_buf), so the host-side migrations are pure reshapes.
// In shared memory the Kalman FFT step holds W and P as the next block's
// prediction, so the load predicts once and the call's last step leaves
// the posterior. The stage-1 steps keep the ring in slots: at step t
// partition l is slot (t - l) mod L. A launch counts t from 0, so the load
// puts age a in slot L - 1 - a (step 0 pushes into slot 0 and reads age a as
// partition a + 1), and after the last step t = k - 1 age l is read from
// slot (k - 1 - l) mod L.
//
// What bounds it. Per stream and hop the FFT formulation does ~0.35 M flops
// of stage 1 and ~0.07 M of stage 2 (2 + 1 real FFTs of 512 points and the
// small products), against ~4 M FMA and ~5.3 MB of basis reads from L2 for
// the dense one. The state round trip is 2 x ~56 KB from device memory: at
// S = 1024 that is ~116 MB (~35 us at the HBM rate) against ~0.4 G flops
// (~6 us at the FP32 peak), so the round trip bounds it; in practice each
// CTA's ~35 barrier-separated phases a hop (its latency) and the waves of 2
// CTAs an SM do. At small S the card is mostly idle and the call is the
// host's: the wrapper prepares the constants once (kernels/hop.py).

#include "hop.cuh"

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

// Moves one stream's state between device memory and shared memory; a
// Kalman FFT hop predicts W, P once on the load (it holds the prediction).
template <bool kStore, class Hop, class P, class G>
__device__ void move_state(const typename Hop::Smem& s, const G& q, const ServingPtrs& g,
                           size_t stream, int k_blocks, const P& kp) {
  constexpr bool kKalman = std::is_same<P, KalmanParams>::value;
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
      if (kStore) {
        g.p[lk + i] = s.s1.p[i];
      } else {
        s.s1.p[i] = g.p[lk + i];
        if constexpr (Hop::kPredicted) predict(s.s1, i, s.s1.wr[i], s.s1.wi[i], kp);
      }
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
  for (int i = tid; i < kNmRows; i += kThreads) {
    if (kStore) g.nm[stream * kNmRows + i] = s.nm[i];
    else s.nm[i] = g.nm[stream * kNmRows + i];
  }
}

template <class Hop, class P, class G>
__global__ void __launch_bounds__(kThreads, 2)
serving_kernel(const float* __restrict__ far, const float* __restrict__ mic,
               float* __restrict__ out, ServingPtrs g, int k_blocks, G q, Hop hop, P kp,
               Stage2Weights w, int gain_norm, int normalize) {
  Carve c;
  const typename Hop::Smem s(c, q);
  const int B = q.block;
  const size_t stream = blockIdx.x;
  const size_t io = stream * k_blocks * B;
  const int tid = threadIdx.x;

  hop.init(s, q);
  move_state<false, Hop>(s, q, g, stream, k_blocks, kp);
  for (int u = 0; u < k_blocks; ++u) {
    for (int j = tid; j < B; j += kThreads) {
      s.s1.frame[B + j] = far[io + u * B + j];
      s.s1.e[j] = mic[io + u * B + j];
    }
    __syncthreads();
    hop.step(s, q, u, kp, w, gain_norm != 0, true, normalize != 0, u == k_blocks - 1);
    for (int j = tid; j < B; j += kThreads) out[io + u * B + j] = s.x.out[j];
  }
  move_state<true, Hop>(s, q, g, stream, k_blocks, kp);
}

template <class P>
int launch(const HopConsts& c, const float* far, const float* mic, float* out,
           const ServingPtrs& g, int streams, int k_blocks, int gain_norm, int normalize,
           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const P kp = filter_params<P>(c);
  return with_hop<P>(c, [&](auto q, auto hop) {
    using Hop = decltype(hop);
    auto kernel = serving_kernel<Hop, P, decltype(q)>;
    const size_t smem = smem_bytes<typename Hop::Smem>(q);
    const cudaError_t e2 = set_smem(reinterpret_cast<const void*>(kernel), smem, device);
    if (e2 != cudaSuccess || streams == 0 || k_blocks == 0) return e2;
    kernel<<<streams, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        far, mic, out, g, k_blocks, q, hop, kp, c.w, gain_norm, normalize);
    return cudaGetLastError();
  });
}

}  // namespace

// shared memory of one CTA at this geometry, bytes (nlms: the NLMS state;
// fft: the FFT hop, else the dense one)
extern "C" long long aec_serving_smem(int block, int n_blocks, int bands, int nlms, int fft) {
  return static_cast<long long>(nlms ? hop_smem<NlmsParams>(block, n_blocks, bands, fft != 0)
                                     : hop_smem<KalmanParams>(block, n_blocks, bands, fft != 0));
}

// c: the prepared constants (c->c the KalmanParams, or with nlms the
// NlmsParams); state[12]: the ServingState leaves in ServingPtrs' order;
// far, mic, out (streams, k_blocks * block).
extern "C" int aec_serving(const HopConsts* c, int nlms, const float* far, const float* mic,
                           float* out, float* const* state, int streams, int k_blocks,
                           int gain_norm, int normalize, int device, void* stream) {
  const ServingPtrs g{state[0], state[1], state[2], state[3], state[4],  state[5],
                      state[6], state[7], state[8], state[9], state[10], state[11]};
  if (nlms)
    return launch<NlmsParams>(*c, far, mic, out, g, streams, k_blocks, gain_norm, normalize,
                              device, stream);
  return launch<KalmanParams>(*c, far, mic, out, g, streams, k_blocks, gain_norm, normalize,
                              device, stream);
}

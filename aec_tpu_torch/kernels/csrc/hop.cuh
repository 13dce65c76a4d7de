// The two-stage hop that K3 (serving.cu) and K4 (two_stage.cu) share: one
// stage-1 block update, its cancelled block handed to stage 2 in shared
// memory with the far block, then one LittleNet frame, all on one CTA's
// state.
//
// On FFTs (two_stage_block_step_fft): stage1_fft.cuh's Kalman or NLMS step,
// bl_common.cuh's hand-off (monitor EMAs, the causal pseudo-norm's moments
// and scalars), then stage2_fft.cuh's frame. Stage 2's frame scratch lies
// over the stage-1 FFT work buffers a, b, which are dead between steps
// (TwoStageFftSmem), so a CTA takes ~107 KB (Kalman) or ~98 KB (NLMS) at the
// default geometry and two fit an SM, and the largest partition count is the
// dense layout's (23 / 26 at block 256, 38 / 43 at 160). A hop without a
// radix plan (a prime factor other than 2, 3, 5) keeps the dense hop of
// bl_common.cuh (two_stage_block_step, bases read from L2). The kernels take
// either through a policy (FftHop, DenseHop) and with_hop picks it from the
// host's constants.
//
// HopConsts is everything a launch takes that does not change from call to
// call: the geometry and the plan, the filter constants, the twiddles, the
// dense bases and the stage-2 weights. The host fills it once per net,
// geometry and filter (kernels/hop.py) and passes its address, so a launch
// passes a few pointers.
#pragma once

#include <type_traits>

#include "stage1_fft.cuh"
#include "stage2_fft.cuh"

namespace aec {

// Both stages' state on one CTA on FFTs; S1 is the stage-1 filter's state
// (KalmanFftSmem or NlmsFftSmem). Stage 2's frame scratch lies over the
// stage-1 work buffers a, b where it fits (2 L x 2B floats; it needs 4 x 2B
// and ~10E + B): they are dead once a stage-1 step has returned, and the
// next step writes them before it reads them.
template <class S1>
struct TwoStageFftSmem {
  S1 s1;
  Stage2State s2;
  SArr nm;   // (kNmRows)
  SArr red;  // (kWarps, kMoments) per-warp partial block sums
  Stage2FftScratch x;
  template <class G>
  __host__ __device__ TwoStageFftSmem(Carve& c, const G& q)
      : s1(c, q), s2(c, q), nm(c.take(kNmRows)), red(c.take(kWarps * kMoments)),
        x(scratch(c, q, s1.a)) {}

  template <class G>
  __host__ __device__ static Stage2FftScratch scratch(Carve& c, const G& q, SArr a) {
    Carve over(a.off);
    const Stage2FftScratch x(over, q);
    if (over.n - a.off <= 2 * size_t(q.L) * q.frame) return x;
    return Stage2FftScratch(c, q);
  }
};

// the FFT stage-1 step, by the state's type; `last`: the call's last step
// (the Kalman step then leaves W, P as the posterior)
template <class G, class Plan>
__device__ __forceinline__ void stage1_block_step_fft(const KalmanFftSmem& s, const G& q, int t,
                                                      const KalmanParams& kp, const Plan& plan,
                                                      bool last) {
  kalman_block_step_fft<true>(s, q, t, kp, plan, !last);
}

template <class G, class Plan>
__device__ __forceinline__ void stage1_block_step_fft(const NlmsFftSmem& s, const G& q, int t,
                                                      const NlmsParams& np, const Plan& plan,
                                                      bool) {
  nlms_block_step_fft(s, q, t, np, plan);
}

// One two-stage hop on FFTs: two_stage_block_step's contract (bl_common.cuh)
// on TwoStageFftSmem. W, P of a Kalman state hold the hop's prediction
// before the call and the next one's after it (the posterior if `last`).
template <class S1, class P, class G, class Plan>
__device__ __forceinline__ void two_stage_block_step_fft(const TwoStageFftSmem<S1>& s, const G& q,
                                                         int t, const P& kp,
                                                         const Stage2Weights& w, const Plan& plan,
                                                         bool gain_norm, bool moments,
                                                         bool normalize, bool last) {
  const float mic2 = block_power(s.s1.e, q);  // s1.e becomes the residual
  stage1_block_step_fft(s.s1, q, t, kp, plan, last);
  const float2 off = hand_off(s.s1.e, s.s1.frame, s.s2, s.nm, s.red, q, mic2, moments, normalize);
  stage2_frame_step_fft(s.s2, s.x, q, w, plan, s.s1.tw, gain_norm, off.x, off.y);
}

// ---------------------------------------------------------------- policies

// the stage-1 state layouts of a filter, by its parameters' type
template <class P>
struct Filter;
template <>
struct Filter<KalmanParams> {
  using Dense = KalmanSmem;
  using Fft = KalmanFftSmem;
};
template <>
struct Filter<NlmsParams> {
  using Dense = NlmsSmem;
  using Fft = NlmsFftSmem;
};

// the hop on FFTs: the radix plan and the twiddle table. A Kalman state's W,
// P are held as the prediction between hops (kPredicted).
template <class S1, class Plan>
struct FftHop {
  using Smem = TwoStageFftSmem<S1>;
  static constexpr bool kPredicted = true;
  Plan plan;
  const float* __restrict__ tw;  // (B, 2) fp32
  // the twiddles into shared memory (no barrier)
  template <class G>
  __device__ __forceinline__ void init(const Smem& s, const G& q) const {
    for (int i = threadIdx.x; i < q.frame; i += kThreads) s.s1.tw[i] = tw[i];
  }
  template <class P, class G>
  __device__ __forceinline__ void step(const Smem& s, const G& q, int t, const P& kp,
                                       const Stage2Weights& w, bool gain_norm, bool moments,
                                       bool normalize, bool last) const {
    two_stage_block_step_fft(s, q, t, kp, w, plan, gain_norm, moments, normalize, last);
  }
  // stage 2 alone (K4's zero flush frame)
  template <class G>
  __device__ __forceinline__ void frame(const Smem& s, const G& q, const Stage2Weights& w,
                                        bool gain_norm) const {
    stage2_frame_step_fft(s.s2, s.x, q, w, plan, s.s1.tw, gain_norm);
  }
};

// the dense hop of bl_common.cuh, on the DFT bases
template <class S1>
struct DenseHop {
  using Smem = TwoStageSmem<S1>;
  static constexpr bool kPredicted = false;
  Stage1Bases bs;
  template <class G>
  __device__ __forceinline__ void init(const Smem&, const G&) const {}
  template <class P, class G>
  __device__ __forceinline__ void step(const Smem& s, const G& q, int t, const P& kp,
                                       const Stage2Weights& w, bool gain_norm, bool moments,
                                       bool normalize, bool) const {
    two_stage_block_step(s, q, t, kp, bs, w, gain_norm, moments, normalize);
  }
  template <class G>
  __device__ __forceinline__ void frame(const Smem& s, const G& q, const Stage2Weights& w,
                                        bool gain_norm) const {
    stage2_frame_step(s.s2, s.x, q, w, gain_norm);
  }
};

// ---------------------------------------------------------------- launches

// What a K3 or K4 launch takes that does not change from call to call
// (kernels/hop.py HopConsts mirrors it; aec_hop_consts_bytes checks the two
// agree). n_pass == 0 selects the dense hop.
struct HopConsts {
  int block, n_blocks, bands, n_pass;  // B == hop, L, E; radix passes
  int radix[kMaxPasses];               // kernels/fft_plan.py radix_plan
  float c[8];                          // KalmanParams or NlmsParams, in order
  const float* tw;                     // (B, 2) twiddles W_2B^m
  const float* fwd;                    // dense stage-1 bases (stage1_consts)
  const float* inv_tail;
  const float* inv_head;
  Stage2Weights w;
};

template <class P>
P filter_params(const HopConsts& c) {
  return P{c.c[0], c.c[1], c.c[2], c.c[3], c.c[4], c.c[5], c.c[6], c.c[7]};
}

// f(q, hop): the hop of `c` for filter P (FftHop on the host's plan, the
// default geometry on the compiled plan; DenseHop when n_pass == 0)
template <class P, class F>
cudaError_t with_hop(const HopConsts& c, F&& f) {
  if (c.n_pass == 0)
    return with_geom(c.block, c.n_blocks, c.bands, [&](auto q) {
      return f(q, DenseHop<typename Filter<P>::Dense>{Stage1Bases{c.fwd, c.inv_tail, c.inv_head}});
    });
  RunPlan plan{};
  const cudaError_t err = read_plan(c.radix, c.n_pass, c.block, plan);
  if (err != cudaSuccess) return err;
  using S1 = typename Filter<P>::Fft;
  return with_geom(c.block, c.n_blocks, c.bands, [&](auto q) -> cudaError_t {
    if constexpr (std::is_same_v<decltype(q), DefaultGeom>) {
      if (!is_default_plan(plan)) return cudaErrorInvalidValue;
      return f(q, FftHop<S1, DefaultPlan>{{}, c.tw});
    } else {
      return f(q, FftHop<S1, RunPlan>{plan, c.tw});
    }
  });
}

// bytes of one CTA's layout for filter P at this geometry, on FFTs or dense
template <class P>
size_t hop_smem(int block, int n_blocks, int bands, bool fft) {
  const Geom q = make_geom(block, n_blocks, bands);
  return fft ? smem_bytes<TwoStageFftSmem<typename Filter<P>::Fft>>(q)
             : smem_bytes<TwoStageSmem<typename Filter<P>::Dense>>(q);
}

}  // namespace aec

// sizeof(HopConsts), for the host's mirror of it (each library that
// includes this header is one translation unit, and exports it once)
extern "C" long long aec_hop_consts_bytes() {
  return static_cast<long long>(sizeof(aec::HopConsts));
}

// Kernel K4: the whole two-stage pipeline (Kalman + LittleNet) in one launch.
//
// Replaces aec_tpu/kernels/pallas_two_stage.py:134 two_stage_fused
// (pallas_call at :209), the TPU kernel of two_stage_cancel's batched
// quality="fast" route.
//
// Design. One CTA per utterance walks T + 1 steps with both stages' state in
// shared memory. Steps 0..T-1 are hop.cuh's two-stage hop on FFTs: K1's
// Kalman step, then the LittleNet frame on the cancelled block, handed over
// in shared memory, so the linear waveform reaches device memory only as
// the `lin` output and is never read back. Step T is the zero flush frame:
// stage 1 is skipped and stage 2 sees zero blocks (pallas_two_stage.py:
// 101-113). Outputs are slot-aligned as the TPU kernel's (:252-261): lin
// slot t is block t, the enhanced block of step t is block t - 1 (step 0
// completes nothing), and the mask has T + 1 frames, which is K2's frame /
// OLA schedule (stage2.cu). normalize=False only, as in JAX: the offline
// pseudo-norm needs the whole stage-1 output before stage 2 starts. A hop
// without a radix plan runs the dense hop of bl_common.cuh. Each block's
// inputs are loaded into registers during the step before, as K1's are.
//
// What bounds it. Each step is K1's FFT step (~0.35 M flops) plus one frame
// on FFTs (~0.07 M flops) in sequence, ~35 barrier-separated phases on one
// CTA, two CTAs an SM (~107 KB each at the default geometry): it is bound
// by the CTA's step latency, as K1 is, and runs K2's frames in sequence
// where K2 runs them in parallel. The dense hop reads ~5.3 MB of bases from
// L2 per step.

#include "hop.cuh"

using namespace aec;

namespace {

template <class Hop, class G>
__global__ void __launch_bounds__(kThreads, 2)
two_stage_kernel(const float* __restrict__ far, const float* __restrict__ mic,
                 float* __restrict__ out, float* __restrict__ lin, float* __restrict__ mask,
                 int t_blocks, G q, Hop hop, KalmanParams kp, Stage2Weights w, int gain_norm) {
  Carve c;
  const typename Hop::Smem s(c, q);
  const int B = q.block, E = q.bands;
  const size_t base = static_cast<size_t>(blockIdx.x) * t_blocks * B;
  const size_t mask_base = static_cast<size_t>(blockIdx.x) * (t_blocks + 1) * E;
  const int tid = threadIdx.x;

  if constexpr (Hop::kPredicted) kalman_fft_init(s.s1, q, kp);
  else kalman_init(s.s1, q, kp);
  hop.init(s, q);
  stage2_init(s.s2, q);

  float fx = 0.f, fm = 0.f;  // thread tid's sample of the next far and mic block
  const auto fetch = [&](int t) {
    if (tid < B) {
      fx = far[base + static_cast<size_t>(t) * B + tid];
      fm = mic[base + static_cast<size_t>(t) * B + tid];
    }
  };
  if (t_blocks > 0) fetch(0);
  for (int t = 0; t <= t_blocks; ++t) {
    const size_t off = base + static_cast<size_t>(t) * B;
    if (t < t_blocks) {
      if (tid < B) {
        s.s1.frame[B + tid] = fx;
        s.s1.e[tid] = fm;
      }
      for (int j = tid + kThreads; j < B; j += kThreads) {
        s.s1.frame[B + j] = far[off + j];
        s.s1.e[j] = mic[off + j];
      }
      if (t + 1 < t_blocks) fetch(t + 1);
      __syncthreads();
      hop.step(s, q, t, kp, w, gain_norm != 0, false, false, false);
      for (int j = tid; j < B; j += kThreads) lin[off + j] = s.s1.e[j];
    } else {  // the zero flush frame
      for (int j = tid; j < B; j += kThreads) {
        s.s2.lin[B + j] = 0.f;
        s.s2.far[B + j] = 0.f;
      }
      __syncthreads();
      hop.frame(s, q, w, gain_norm != 0);
    }
    for (int e = tid; e < E; e += kThreads)
      mask[mask_base + static_cast<size_t>(t) * E + e] = s.x.mask[e];
    if (t > 0)
      for (int j = tid; j < B; j += kThreads) out[off - B + j] = s.x.out[j];
  }
}

}  // namespace

// shared memory of one CTA at this geometry, bytes (fft: the FFT hop, else
// the dense one)
extern "C" long long aec_two_stage_smem(int block, int n_blocks, int bands, int fft) {
  return static_cast<long long>(hop_smem<KalmanParams>(block, n_blocks, bands, fft != 0));
}

// c: the prepared constants (c->c the KalmanParams); far, mic, out, lin
// (batch, t_blocks * block); mask (batch, t_blocks + 1, bands).
extern "C" int aec_two_stage(const HopConsts* c, const float* far, const float* mic, float* out,
                             float* lin, float* mask, int batch, int t_blocks, int gain_norm,
                             int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const KalmanParams kp = filter_params<KalmanParams>(*c);
  return with_hop<KalmanParams>(*c, [&](auto q, auto hop) {
    using Hop = decltype(hop);
    auto kernel = two_stage_kernel<Hop, decltype(q)>;
    const size_t smem = smem_bytes<typename Hop::Smem>(q);
    const cudaError_t e2 = set_smem(reinterpret_cast<const void*>(kernel), smem, device);
    if (e2 != cudaSuccess || batch == 0) return e2;
    kernel<<<batch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        far, mic, out, lin, mask, t_blocks, q, hop, kp, c->w, gain_norm);
    return cudaGetLastError();
  });
}

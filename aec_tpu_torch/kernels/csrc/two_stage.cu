// Kernel K4: the whole two-stage pipeline (Kalman + LittleNet) in one launch.
//
// Replaces aec_tpu/kernels/pallas_two_stage.py:134 two_stage_fused
// (pallas_call at :209), the TPU kernel of two_stage_cancel's batched
// quality="fast" route.
//
// Design. One CTA per utterance walks T + 1 steps with both stages' state in
// shared memory. Steps 0..T-1 are bl_common.cuh's two_stage_block_step: the
// Kalman block update, then the LittleNet frame on the cancelled block,
// handed over in shared memory, so the linear waveform reaches device memory
// only as the `lin` output and is never read back. Step T is the zero flush
// frame: stage 1 is skipped and stage 2 sees zero blocks
// (pallas_two_stage.py:101-113). Outputs are slot-aligned as the TPU kernel's
// (:252-261): lin slot t is block t, the enhanced block of step t is block
// t - 1 (step 0 completes nothing), and the mask has T + 1 frames, which is
// K2's frame/OLA schedule (stage2.cu). normalize=False only, as in JAX: the
// offline pseudo-norm needs the whole stage-1 output before stage 2 starts.
//
// What bounds it. The same per-step work as K1 plus K2 (~4 M FMA and ~5.3 MB
// of fp32 DFT bases read from L2 per utterance and step), so it is bound by
// each SM's L2 read rate as they are. Stage 2's scratch lies over stage 1's
// (TwoStageSmem): 107,120 B per CTA, so two CTAs share an SM as K1's do, and
// K2's frames ride in the same waves as K1's steps instead of a second pass.

#include "bl_common.cuh"

using namespace aec;

namespace {

constexpr int kL = 10;  // KalmanConfig.n_blocks

__global__ void __launch_bounds__(kThreads, 2)
two_stage_kernel(const float* __restrict__ far, const float* __restrict__ mic,
                 float* __restrict__ out, float* __restrict__ lin, float* __restrict__ mask,
                 int t_blocks, Stage1Bases bs, KalmanParams kp, Stage2Weights w, int gain_norm) {
  extern __shared__ float4 smem_raw[];
  TwoStageSmem<KalmanSmem<kL>>& s = *reinterpret_cast<TwoStageSmem<KalmanSmem<kL>>*>(smem_raw);
  const size_t base = static_cast<size_t>(blockIdx.x) * t_blocks * kBlock;
  const size_t mask_base = static_cast<size_t>(blockIdx.x) * (t_blocks + 1) * kBands;
  const int tid = threadIdx.x;

  kalman_init<kL>(s.s1, kp);
  stage2_init(s.s2);
  for (int t = 0; t <= t_blocks; ++t) {
    const size_t off = base + static_cast<size_t>(t) * kBlock;
    if (t < t_blocks) {
      if (tid < kBlock) {
        s.s1.frame[kBlock + tid] = far[off + tid];
        s.s1.e[tid] = mic[off + tid];
      }
      __syncthreads();
      two_stage_block_step(s, t, kp, bs, w, gain_norm != 0, false, false);
      if (tid < kBlock) lin[off + tid] = s.s1.e[tid];
    } else {  // the zero flush frame
      if (tid < kBlock) {
        s.s2.lin[kBlock + tid] = 0.f;
        s.s2.far[kBlock + tid] = 0.f;
      }
      __syncthreads();
      stage2_frame_step(s.s2, s.x(), w, gain_norm != 0);
    }
    if (tid < kBands) mask[mask_base + static_cast<size_t>(t) * kBands + tid] = s.x().mask[tid];
    if (t > 0 && tid < kBlock) out[off - kBlock + tid] = s.x().out[tid];
  }
}

}  // namespace

extern "C" int aec_two_stage_n_blocks() { return kL; }

extern "C" int aec_two_stage(const float* far, const float* mic, float* out, float* lin,
                             float* mask, int batch, int t_blocks, const float* fwd,
                             const float* inv_tail, const float* inv_head, float a, float a2,
                             float one_minus_a2, float q_min, float obs, float one_minus_obs,
                             float floor_, float init_p, const float* analysis,
                             const float* synthesis, const float* erb, const float* erb_t,
                             const float* w_ih_t, const float* w_hh_t, const float* b_ih,
                             const float* b_hh, const float* w1_t, const float* b1,
                             const float* w2_t, const float* b2, const float* inv_env,
                             int gain_norm, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int smem = static_cast<int>(sizeof(TwoStageSmem<KalmanSmem<kL>>));
  err = cudaFuncSetAttribute(two_stage_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  if (batch == 0) return cudaSuccess;
  const Stage1Bases bs{fwd, inv_tail, inv_head};
  const KalmanParams kp{a, a2, one_minus_a2, q_min, obs, one_minus_obs, floor_, init_p};
  const Stage2Weights w{analysis, synthesis, erb, erb_t, w_ih_t, w_hh_t, b_ih,
                        b_hh,     w1_t,      b1,  w2_t,  b2,     inv_env};
  two_stage_kernel<<<batch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      far, mic, out, lin, mask, t_blocks, bs, kp, w, gain_norm);
  return cudaGetLastError();
}

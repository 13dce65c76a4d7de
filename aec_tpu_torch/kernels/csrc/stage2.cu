// Kernel K2: batched LittleNet stage-2 inference, one frame per step.
//
// Replaces aec_tpu/kernels/pallas_stage2.py:100 little_net_apply_fused
// (pallas_call at :164), the batch-in-lanes TPU kernel of the stage-2 route.
//
// Design. One CTA per utterance walks the Tb + 1 frames in order (the time
// loop is inside the CTA; CTAs run in parallel over utterances). Per frame,
// bl_common.cuh's stage2_frame_step: windowed analysis DFT of the lin and far
// frames, magnitudes, ERB features, GRU cell, lin1/relu, lin2/sigmoid, ERB
// back-projection (optionally over the unmasked one: gain_norm), pinv
// synthesis and overlap-add with the interior envelope. Only the GRU state
// (32), the OLA tail (256) and the two previous input blocks recur; they stay
// in shared memory, so no frame, spectrum or synthesis frame ever reaches
// device memory. Bookkeeping as the TPU kernel: one trailing zero flush
// block, frame f's output completes block f - 1 (frame 0 writes nothing), the
// mask has Tb + 1 frames.
//
// What bounds it. ~0.8 M FMA per frame and utterance, almost all in the
// analysis and synthesis transforms, whose fp32 bases (~1 MB each) are
// re-read from L2 every frame of every CTA: L2-bandwidth bound. The analysis
// reads each basis element once for both frames. The DFTs do not recur (only
// h and the OLA tail do), so running them as batched passes over all frames
// on tensor cores is the lever left for later.

#include "bl_common.cuh"

using namespace aec;

namespace {

__global__ void __launch_bounds__(kThreads)
stage2_kernel(const float* __restrict__ lin, const float* __restrict__ far,
              float* __restrict__ out, float* __restrict__ mask, int t_blocks,
              Stage2Weights w, int gain_norm) {
  __shared__ Stage2Smem s;
  const size_t base = static_cast<size_t>(blockIdx.x) * t_blocks * kBlock;
  const size_t mask_base = static_cast<size_t>(blockIdx.x) * (t_blocks + 1) * kBands;
  const int tid = threadIdx.x;

  stage2_init(s);
  for (int f = 0; f <= t_blocks; ++f) {  // frame t_blocks is the zero flush block
    if (tid < kBlock) {
      const size_t off = base + static_cast<size_t>(f) * kBlock + tid;
      s.lin[kBlock + tid] = f < t_blocks ? lin[off] : 0.f;
      s.far[kBlock + tid] = f < t_blocks ? far[off] : 0.f;
    }
    __syncthreads();
    stage2_frame_step(s, w, gain_norm != 0);
    if (tid < kBands) mask[mask_base + static_cast<size_t>(f) * kBands + tid] = s.mask[tid];
    if (f > 0 && tid < kBlock) out[base + static_cast<size_t>(f - 1) * kBlock + tid] = s.out[tid];
  }
}

}  // namespace

extern "C" int aec_stage2(const float* lin, const float* far, float* out, float* mask, int batch,
                          int t_blocks, const float* analysis, const float* synthesis,
                          const float* erb, const float* erb_t, const float* w_ih_t,
                          const float* w_hh_t, const float* b_ih, const float* b_hh,
                          const float* w1_t, const float* b1, const float* w2_t, const float* b2,
                          const float* inv_env, int gain_norm, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (batch == 0) return cudaSuccess;
  const Stage2Weights w{analysis, synthesis, erb, erb_t, w_ih_t, w_hh_t, b_ih,
                        b_hh,     w1_t,      b1,  w2_t,  b2,     inv_env};
  stage2_kernel<<<batch, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      lin, far, out, mask, t_blocks, w, gain_norm);
  return cudaGetLastError();
}

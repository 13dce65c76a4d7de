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
// (E), the OLA tail (hop) and the two previous input blocks recur; they stay
// in shared memory, so no frame, spectrum or synthesis frame ever reaches
// device memory. Bookkeeping as the TPU kernel: one trailing zero flush
// block, frame f's output completes block f - 1 (frame 0 writes nothing), the
// mask has Tb + 1 frames. The hop (window = FFT = 2 hop) and the band count
// are the caller's; the layout is carved at run time (bl_common.cuh).
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

struct Stage2Smem {
  Stage2State st;
  Stage2Scratch sc;
  template <class G>
  __host__ __device__ Stage2Smem(Carve& c, const G& q) : st(c, q), sc(c, q) {}
};

template <class G>
__global__ void __launch_bounds__(kThreads)
stage2_kernel(const float* __restrict__ lin, const float* __restrict__ far,
              float* __restrict__ out, float* __restrict__ mask, int t_blocks, G q,
              Stage2Weights w, int gain_norm) {
  Carve c;
  const Stage2Smem s(c, q);
  const int B = q.block, E = q.bands;
  const size_t base = static_cast<size_t>(blockIdx.x) * t_blocks * B;
  const size_t mask_base = static_cast<size_t>(blockIdx.x) * (t_blocks + 1) * E;
  const int tid = threadIdx.x;

  stage2_init(s.st, q);
  for (int f = 0; f <= t_blocks; ++f) {  // frame t_blocks is the zero flush block
    for (int j = tid; j < B; j += kThreads) {
      const size_t off = base + static_cast<size_t>(f) * B + j;
      s.st.lin[B + j] = f < t_blocks ? lin[off] : 0.f;
      s.st.far[B + j] = f < t_blocks ? far[off] : 0.f;
    }
    __syncthreads();
    stage2_frame_step(s.st, s.sc, q, w, gain_norm != 0);
    for (int e = tid; e < E; e += kThreads)
      mask[mask_base + static_cast<size_t>(f) * E + e] = s.sc.mask[e];
    if (f > 0)
      for (int j = tid; j < B; j += kThreads)
        out[base + static_cast<size_t>(f - 1) * B + j] = s.sc.out[j];
  }
}

}  // namespace

// shared memory of one CTA at this geometry, bytes
extern "C" long long aec_stage2_smem(int hop, int bands) {
  return static_cast<long long>(smem_bytes<Stage2Smem>(make_geom(hop, 1, bands)));
}

extern "C" int aec_stage2(const float* lin, const float* far, float* out, float* mask, int batch,
                          int t_blocks, int hop, int bands, const float* analysis,
                          const float* synthesis, const float* erb, const float* erb_t,
                          const float* w_ih_t, const float* w_hh_t, const float* b_ih,
                          const float* b_hh, const float* w1_t, const float* b1, const float* w2_t,
                          const float* b2, const float* inv_env, int gain_norm, int device,
                          void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Stage2Weights w{analysis, synthesis, erb, erb_t, w_ih_t, w_hh_t, b_ih,
                        b_hh,     w1_t,      b1,  w2_t,  b2,     inv_env};
  return with_geom(hop, -1, bands, [&](auto q) {
    auto kernel = stage2_kernel<decltype(q)>;
    const size_t smem = smem_bytes<Stage2Smem>(q);
    cudaError_t e2 = set_smem(reinterpret_cast<const void*>(kernel), smem, device);
    if (e2 != cudaSuccess || batch == 0) return e2;
    kernel<<<batch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(lin, far, out, mask,
                                                                         t_blocks, q, w, gain_norm);
    return cudaGetLastError();
  });
}

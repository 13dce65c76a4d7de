// Kernels K1 and K12: batched partitioned-block frequency-domain Kalman canceller.
//
// K1 replaces aec_tpu/kernels/pallas_kalman.py:492 kalman_filter_fused_batched_bl
// (pallas_call at :573), the batch-in-lanes TPU kernel of the stage-1 route:
// time-domain far blocks in, the far-frame analysis done in the kernel.
// K12 replaces aec_tpu/kernels/pallas_kalman.py:303 kalman_filter_fused_batched
// (pallas_call at :349), its batch-in-sublanes predecessor, which takes the
// far-frame spectra x_ri (B, T, 2K) computed outside: the same kernel with
// kSpectraIn, which loads each step's spectrum into the ring slot in place of
// the analysis and then runs the same step.
//
// Design. On the TPU the grid ran in order and the batch tile rode the 128
// lanes. Here CTAs run in parallel and in no order, so the time loop moves
// INSIDE the CTA and the parallel axis is the utterance: one CTA per
// utterance walks all T blocks with its whole filter state (W re/im, P, the
// far-spectrum ring: 5 x L x 257 fp32) resident in shared memory, so the only
// device-memory traffic is the far blocks (or spectra) and mic blocks in and
// the cancelled blocks out. Each step is bl_common.cuh's kalman_block_step:
// far-frame analysis DFT (K1 only), predict, echo estimate, residual DFT,
// gain, factored constraint (irfft head, then rfft tail), covariance update.
//
// What bounds it. Per step and utterance ~3.2 M FMA (K12: ~2.9 M, no
// analysis), ~2.6 M of them in the constraint pair. The transforms re-read
// their fp32 bases (fwd, inv_tail, inv_head: ~2.1 MB) from L2 at every step
// of every CTA, about one load per two FMAs, so the kernel is L2-bandwidth
// bound before it is FFMA bound. The design reads each basis element once
// per step for all L partitions (the partitions are the product's N
// dimension, held in registers) and fits two CTAs per SM (~100 KB of shared
// memory each). Sharing one basis read among several utterances per CTA,
// FFT-based transforms and tensor cores are the levers left for later.

#include "bl_common.cuh"

using namespace aec;

namespace {

constexpr int kL = 10;  // KalmanConfig.n_blocks

// far: (batch, t_blocks, kBlock) far blocks, or with kSpectraIn
// (batch, t_blocks, kRi) far-frame spectra [re || im]
template <bool kSpectraIn>
__global__ void __launch_bounds__(kThreads, 2)
kalman_batched_kernel(const float* __restrict__ far, const float* __restrict__ mic,
                      float* __restrict__ e, int t_blocks, Stage1Bases bs, KalmanParams kp) {
  extern __shared__ float4 smem_raw[];
  KalmanSmem<kL>& s = *reinterpret_cast<KalmanSmem<kL>*>(smem_raw);
  const size_t base = static_cast<size_t>(blockIdx.x) * t_blocks * kBlock;
  const int tid = threadIdx.x;

  kalman_init<kL>(s, kp);
  for (int t = 0; t < t_blocks; ++t) {
    const size_t off = base + static_cast<size_t>(t) * kBlock;
    if constexpr (kSpectraIn) {
      const float* x = far + (static_cast<size_t>(blockIdx.x) * t_blocks + t) * kRi;
      const int head = t % kL;
      if (tid < kBins) s.xr[head * kBins + tid] = x[tid];
      else if (tid < kRi) s.xi[head * kBins + tid - kBins] = x[tid];
    } else if (tid < kBlock) {
      s.frame[kBlock + tid] = far[off + tid];
    }
    if (tid < kBlock) s.e[tid] = mic[off + tid];
    __syncthreads();
    kalman_block_step<kL, !kSpectraIn>(s, t, kp, bs);
    if (tid < kBlock) e[off + tid] = s.e[tid];
  }
}

template <bool kSpectraIn>
int launch(const float* far, const float* mic, float* e, int batch, int t_blocks,
           const float* fwd, const float* inv_tail, const float* inv_head, float a, float a2,
           float one_minus_a2, float q_min, float obs, float one_minus_obs, float floor_,
           float init_p, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int smem = static_cast<int>(sizeof(KalmanSmem<kL>));
  err = cudaFuncSetAttribute(kalman_batched_kernel<kSpectraIn>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  if (batch == 0 || t_blocks == 0) return cudaSuccess;
  const Stage1Bases bs{fwd, inv_tail, inv_head};
  const KalmanParams kp{a, a2, one_minus_a2, q_min, obs, one_minus_obs, floor_, init_p};
  kalman_batched_kernel<kSpectraIn><<<batch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      far, mic, e, t_blocks, bs, kp);
  return cudaGetLastError();
}

}  // namespace

extern "C" int aec_kalman_n_blocks() { return kL; }

extern "C" int aec_kalman_batched(const float* far, const float* mic, float* e, int batch,
                                  int t_blocks, const float* fwd, const float* inv_tail,
                                  const float* inv_head, float a, float a2, float one_minus_a2,
                                  float q_min, float obs, float one_minus_obs, float floor_,
                                  float init_p, int device, void* stream) {
  return launch<false>(far, mic, e, batch, t_blocks, fwd, inv_tail, inv_head, a, a2,
                       one_minus_a2, q_min, obs, one_minus_obs, floor_, init_p, device, stream);
}

extern "C" int aec_kalman_batched_spectra(const float* x_ri, const float* mic, float* e,
                                          int batch, int t_blocks, const float* fwd,
                                          const float* inv_tail, const float* inv_head, float a,
                                          float a2, float one_minus_a2, float q_min, float obs,
                                          float one_minus_obs, float floor_, float init_p,
                                          int device, void* stream) {
  return launch<true>(x_ri, mic, e, batch, t_blocks, fwd, inv_tail, inv_head, a, a2,
                      one_minus_a2, q_min, obs, one_minus_obs, floor_, init_p, device, stream);
}

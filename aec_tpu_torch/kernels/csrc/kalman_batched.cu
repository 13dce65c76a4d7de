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
// the cancelled blocks out. The geometry (block, L) is the caller's; the
// layout is carved at run time (bl_common.cuh). Each step is bl_common.cuh's kalman_block_step:
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

// far: (batch, t_blocks, B) far blocks, or with kSpectraIn
// (batch, t_blocks, 2K) far-frame spectra [re || im]
template <bool kSpectraIn, class G>
__global__ void __launch_bounds__(kThreads, 2)
kalman_batched_kernel(const float* __restrict__ far, const float* __restrict__ mic,
                      float* __restrict__ e, int t_blocks, G q, Stage1Bases bs, KalmanParams kp) {
  Carve c;
  const KalmanSmem s(c, q);
  const int B = q.block, K = q.bins;
  const size_t base = static_cast<size_t>(blockIdx.x) * t_blocks * B;
  const int tid = threadIdx.x;

  kalman_init(s, q, kp);
  for (int t = 0; t < t_blocks; ++t) {
    const size_t off = base + static_cast<size_t>(t) * B;
    if constexpr (kSpectraIn) {
      const float* x = far + (static_cast<size_t>(blockIdx.x) * t_blocks + t) * q.ri;
      const int head = t % q.L;
      for (int i = tid; i < q.ri; i += kThreads) {
        if (i < K) s.xr[head * K + i] = x[i];
        else s.xi[head * K + i - K] = x[i];
      }
    } else {
      for (int j = tid; j < B; j += kThreads) s.frame[B + j] = far[off + j];
    }
    for (int j = tid; j < B; j += kThreads) s.e[j] = mic[off + j];
    __syncthreads();
    kalman_block_step<!kSpectraIn>(s, q, t, kp, bs);
    for (int j = tid; j < B; j += kThreads) e[off + j] = s.e[j];
  }
}

template <bool kSpectraIn>
int launch(const float* far, const float* mic, float* e, int batch, int t_blocks, int block,
           int n_blocks, const float* fwd, const float* inv_tail, const float* inv_head, float a,
           float a2, float one_minus_a2, float q_min, float obs, float one_minus_obs,
           float floor_, float init_p, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Stage1Bases bs{fwd, inv_tail, inv_head};
  const KalmanParams kp{a, a2, one_minus_a2, q_min, obs, one_minus_obs, floor_, init_p};
  return with_geom(block, n_blocks, -1, [&](auto q) {
    auto kernel = kalman_batched_kernel<kSpectraIn, decltype(q)>;
    const size_t smem = smem_bytes<KalmanSmem>(q);
    cudaError_t e2 = set_smem(reinterpret_cast<const void*>(kernel), smem, device);
    if (e2 != cudaSuccess || batch == 0 || t_blocks == 0) return e2;
    kernel<<<batch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(far, mic, e, t_blocks, q,
                                                                         bs, kp);
    return cudaGetLastError();
  });
}

}  // namespace

// shared memory of one CTA at this geometry, bytes
extern "C" long long aec_kalman_smem(int block, int n_blocks) {
  return static_cast<long long>(smem_bytes<KalmanSmem>(make_geom(block, n_blocks, 0)));
}

extern "C" int aec_kalman_batched(const float* far, const float* mic, float* e, int batch,
                                  int t_blocks, int block, int n_blocks, const float* fwd,
                                  const float* inv_tail, const float* inv_head, float a, float a2,
                                  float one_minus_a2, float q_min, float obs, float one_minus_obs,
                                  float floor_, float init_p, int device, void* stream) {
  return launch<false>(far, mic, e, batch, t_blocks, block, n_blocks, fwd, inv_tail, inv_head, a,
                       a2, one_minus_a2, q_min, obs, one_minus_obs, floor_, init_p, device,
                       stream);
}

extern "C" int aec_kalman_batched_spectra(const float* x_ri, const float* mic, float* e,
                                          int batch, int t_blocks, int block, int n_blocks,
                                          const float* fwd, const float* inv_tail,
                                          const float* inv_head, float a, float a2,
                                          float one_minus_a2, float q_min, float obs,
                                          float one_minus_obs, float floor_, float init_p,
                                          int device, void* stream) {
  return launch<true>(x_ri, mic, e, batch, t_blocks, block, n_blocks, fwd, inv_tail, inv_head, a,
                      a2, one_minus_a2, q_min, obs, one_minus_obs, floor_, init_p, device,
                      stream);
}

// Kernel K5: batched partitioned-block frequency-domain NLMS (MDF) canceller.
//
// Replaces aec_tpu/kernels/pallas_nlms.py:242 nlms_filter_fused_batched_bl
// (pallas_call at :305), the batch-in-lanes TPU kernel of the NLMS stage-1
// route.
//
// Design. As K1 (kalman_batched.cu): the TPU grid's sequential time axis
// becomes a loop inside the CTA and the utterance is the parallel axis. One
// CTA per utterance walks all T blocks with its filter state (W re/im, the
// far-spectrum ring, the smoothed far power and residual psd) in shared
// memory, ~92 KB at the default geometry (carved at run time for the
// caller's block and L, bl_common.cuh), so two CTAs share an SM. Each step is bl_common.cuh's
// nlms_block_step: far-frame analysis DFT, echo estimate, residual DFT, the
// normalized gradient, factored constraint (irfft head, then rfft tail). The
// one reduction across bins, the mean of the far power in the denominator,
// is a CTA reduction: warp shuffles, then one shared slot per warp.
//
// What bounds it. The same ~3.16 M FMA per step and utterance as K1 (the
// transforms; NLMS has less elementwise work), reading the ~2.1 MB of fp32
// bases from L2 at every step of every CTA: on this card each SM's L2 read
// rate is the roof, as for K1 (PERF.md section 5), well above the 12.4 ms
// FMA bound at 256 x 512 blocks. The levers are K1's: several utterances per
// CTA sharing one basis read, FFT-based transforms.

#include "bl_common.cuh"

using namespace aec;

namespace {

template <class G>
__global__ void __launch_bounds__(kThreads, 2)
nlms_batched_kernel(const float* __restrict__ far, const float* __restrict__ mic,
                    float* __restrict__ e, int t_blocks, G q, Stage1Bases bs, NlmsParams np) {
  Carve c;
  const NlmsSmem s(c, q);
  const int B = q.block;
  const size_t base = static_cast<size_t>(blockIdx.x) * t_blocks * B;
  const int tid = threadIdx.x;

  nlms_init(s, q);
  for (int t = 0; t < t_blocks; ++t) {
    const size_t off = base + static_cast<size_t>(t) * B;
    for (int j = tid; j < B; j += kThreads) {
      s.frame[B + j] = far[off + j];
      s.e[j] = mic[off + j];
    }
    __syncthreads();
    nlms_block_step(s, q, t, np, bs);
    for (int j = tid; j < B; j += kThreads) e[off + j] = s.e[j];
  }
}

}  // namespace

// shared memory of one CTA at this geometry, bytes
extern "C" long long aec_nlms_smem(int block, int n_blocks) {
  return static_cast<long long>(smem_bytes<NlmsSmem>(make_geom(block, n_blocks, 0)));
}

extern "C" int aec_nlms_batched(const float* far, const float* mic, float* e, int batch,
                                int t_blocks, int block, int n_blocks, const float* fwd,
                                const float* inv_tail, const float* inv_head, float mu, float eps,
                                float ps, float one_minus_ps, float eps_rel, float beta, float es,
                                float one_minus_es, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Stage1Bases bs{fwd, inv_tail, inv_head};
  const NlmsParams np{mu, eps, ps, one_minus_ps, eps_rel, beta, es, one_minus_es};
  return with_geom(block, n_blocks, -1, [&](auto q) {
    auto kernel = nlms_batched_kernel<decltype(q)>;
    const size_t smem = smem_bytes<NlmsSmem>(q);
    cudaError_t e2 = set_smem(reinterpret_cast<const void*>(kernel), smem, device);
    if (e2 != cudaSuccess || batch == 0 || t_blocks == 0) return e2;
    kernel<<<batch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(far, mic, e, t_blocks, q,
                                                                         bs, np);
    return cudaGetLastError();
  });
}

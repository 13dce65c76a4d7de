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
// memory, so the only device-memory traffic is the far and mic blocks in and
// the cancelled blocks out; each block's inputs are loaded into registers
// during the step before. The step is stage1_fft.cuh's nlms_block_step_fft
// (K3-NLMS runs it too): far-frame analysis, echo synthesis, residual
// analysis and the factored constraint (irfft head of each partition's
// gradient, then the rfft of [head || 0]) as real FFTs of length 2B in
// shared memory (fft.cuh), 3 + 2L transforms a step, L of them side by side
// in each pass, ~0.35 M flops a step at the default geometry against 6.3 M
// for the dense products, and no basis stream. The algebra is
// bl_common.cuh's nlms_block_step line for line; its one reduction across
// bins, the mean of the far power, is a CTA reduction (warp shuffles, one
// shared slot per warp). A block with a prime factor other than 2, 3 and 5
// (e.g. 224 = 2^5 7) keeps the dense step (nlms_block_step, DFT bases read
// from L2); the wrapper picks the step from the geometry (kernels/nlms.py)
// and counts which one ran. The default geometry is compiled with constant
// sizes and the constant radix plan 8, 8, 4; any other at run time.
//
// Largest L. NlmsFftSmem holds per partition W re/im and the ring re/im (4K
// floats) and two FFT work buffers (2 x 2B floats): 2,052 floats at B = 256,
// 1,284 at 160, beside ~2.6 K / ~1.6 K fixed (power, psd, 1/den, frame,
// block, spectrum, twiddles). In 227 KB a CTA that is L = 27 at block 256 and
// 43 at 160, as the dense layout held.
//
// What bounds it. As K1's FFT step: at batch 256 two CTAs share each SM and
// each step is a chain of ~21 barrier-separated passes of a few
// shared-memory loads and stores per thread (latency, not flops: the bound
// on the FFT formulation's flops is ~0.68 ms at 256 x 8.2 s). The dense step
// is bound by each SM's L2 read of its ~2.1 MB of bases at every step.

#include "stage1_fft.cuh"

using namespace aec;

namespace {

// the dense step of bl_common.cuh, on the DFT bases
struct DenseStep {
  using Smem = NlmsSmem;
  Stage1Bases bs;
  template <class G>
  __device__ __forceinline__ void init(const Smem& s, const G& q) const {
    nlms_init(s, q);
  }
  template <class G>
  __device__ __forceinline__ void step(const Smem& s, const G& q, int t,
                                       const NlmsParams& np) const {
    nlms_block_step(s, q, t, np, bs);
  }
};

// the FFT step, on the radix plan and the twiddle table
template <class Plan>
struct FftStep {
  using Smem = NlmsFftSmem;
  Plan plan;
  const float* __restrict__ tw;  // (B, 2) fp32
  template <class G>
  __device__ __forceinline__ void init(const Smem& s, const G& q) const {
    nlms_fft_init(s, q);
    for (int i = threadIdx.x; i < q.frame; i += kThreads) s.tw[i] = tw[i];
    __syncthreads();
  }
  template <class G>
  __device__ __forceinline__ void step(const Smem& s, const G& q, int t,
                                       const NlmsParams& np) const {
    nlms_block_step_fft(s, q, t, np, plan);
  }
};

// far, mic, e: (batch, t_blocks, B)
template <class Step, class G>
__global__ void __launch_bounds__(kThreads, 2)
nlms_batched_kernel(const float* __restrict__ far, const float* __restrict__ mic,
                    float* __restrict__ e, int t_blocks, G q, Step op, NlmsParams np) {
  Carve c;
  const typename Step::Smem s(c, q);
  const int B = q.block;
  const size_t base = static_cast<size_t>(blockIdx.x) * t_blocks * B;
  const int tid = threadIdx.x;

  // Block t's inputs: thread tid's element of its far and mic blocks is
  // loaded into registers during step t - 1; the rest (a block wider than
  // the CTA) at the top of step t.
  float fx = 0.f, fm = 0.f;
  const auto fetch = [&](int t) {
    if (tid < B) {
      const size_t o = base + static_cast<size_t>(t) * B + tid;
      fx = far[o];
      fm = mic[o];
    }
  };

  op.init(s, q);
  fetch(0);
  for (int t = 0; t < t_blocks; ++t) {
    const size_t off = base + static_cast<size_t>(t) * B;
    if (tid < B) {
      s.frame[B + tid] = fx;
      s.e[tid] = fm;
    }
    for (int j = tid + kThreads; j < B; j += kThreads) {
      s.frame[B + j] = far[off + j];
      s.e[j] = mic[off + j];
    }
    if (t + 1 < t_blocks) fetch(t + 1);
    __syncthreads();
    op.step(s, q, t, np);
    for (int j = tid; j < B; j += kThreads) e[off + j] = s.e[j];
  }
}

template <class Step, class G>
cudaError_t launch(const float* far, const float* mic, float* e, int batch, int t_blocks,
                   const G& q, const Step& op, const NlmsParams& np, int device, void* stream) {
  auto kernel = nlms_batched_kernel<Step, G>;
  const size_t smem = smem_bytes<typename Step::Smem>(q);
  cudaError_t err = set_smem(reinterpret_cast<const void*>(kernel), smem, device);
  if (err != cudaSuccess || batch == 0 || t_blocks == 0) return err;
  kernel<<<batch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(far, mic, e, t_blocks, q,
                                                                       op, np);
  return cudaGetLastError();
}

}  // namespace

// shared memory of one CTA at this geometry, bytes: the dense step's
extern "C" long long aec_nlms_smem(int block, int n_blocks) {
  return static_cast<long long>(smem_bytes<NlmsSmem>(make_geom(block, n_blocks, 0)));
}

// ... and the FFT step's
extern "C" long long aec_nlms_fft_smem(int block, int n_blocks) {
  return static_cast<long long>(smem_bytes<NlmsFftSmem>(make_geom(block, n_blocks, 0)));
}

// The dense step (a block without a radix plan).
extern "C" int aec_nlms_batched(const float* far, const float* mic, float* e, int batch,
                                int t_blocks, int block, int n_blocks, const float* fwd,
                                const float* inv_tail, const float* inv_head, float mu, float eps,
                                float ps, float one_minus_ps, float eps_rel, float beta, float es,
                                float one_minus_es, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const DenseStep op{Stage1Bases{fwd, inv_tail, inv_head}};
  const NlmsParams np{mu, eps, ps, one_minus_ps, eps_rel, beta, es, one_minus_es};
  // a block without a radix plan is never the default geometry's
  return launch(far, mic, e, batch, t_blocks, make_geom(block, n_blocks, 0), op, np, device,
                stream);
}

// The FFT step: tw (B, 2) the twiddle table, radix[n_pass] the plan of
// kernels/fft_plan.py.
extern "C" int aec_nlms_batched_fft(const float* far, const float* mic, float* e, int batch,
                                    int t_blocks, int block, int n_blocks, const float* tw,
                                    const int* radix, int n_pass, float mu, float eps, float ps,
                                    float one_minus_ps, float eps_rel, float beta, float es,
                                    float one_minus_es, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  RunPlan plan{};
  err = read_plan(radix, n_pass, block, plan);
  if (err != cudaSuccess) return err;
  const NlmsParams np{mu, eps, ps, one_minus_ps, eps_rel, beta, es, one_minus_es};
  return with_geom(block, n_blocks, -1, [&](auto q) -> cudaError_t {
    if constexpr (std::is_same_v<decltype(q), DefaultGeom>) {
      if (!is_default_plan(plan)) return cudaErrorInvalidValue;
      return launch(far, mic, e, batch, t_blocks, q, FftStep<DefaultPlan>{{}, tw}, np, device,
                    stream);
    } else {
      return launch(far, mic, e, batch, t_blocks, q, FftStep<RunPlan>{plan, tw}, np, device,
                    stream);
    }
  });
}

// Kernels K1 and K12: batched partitioned-block frequency-domain Kalman canceller.
//
// K1 replaces aec_tpu/kernels/pallas_kalman.py:492 kalman_filter_fused_batched_bl
// (pallas_call at :573), the batch-in-lanes TPU kernel of the stage-1 route:
// time-domain far blocks in, the far-frame analysis done in the kernel.
// K12 replaces aec_tpu/kernels/pallas_kalman.py:303 kalman_filter_fused_batched
// (pallas_call at :349), its batch-in-sublanes predecessor, which takes the
// far-frame spectra x_ri (B, T, 2K) computed outside: the CTA-wide kernel
// with kSpectraIn, which loads each step's spectrum into the ring slot in
// place of the analysis and then runs its step.
//
// Design. On the TPU the grid ran in order and the batch tile rode the 128
// lanes. Here CTAs run in parallel and in no order, so the time loop moves
// INSIDE the CTA and the parallel axis is the utterance: one CTA per
// utterance (blockIdx.x) walks all T blocks with its whole filter state (W,
// P, the far-spectrum ring: 5 x L x K fp32) resident in shared memory, so
// the only device-memory traffic is the far blocks (or spectra) and mic
// blocks in and the cancelled blocks out.
//
// K1's step. Each block update is the far-frame analysis, predict, echo
// estimate, echo synthesis, residual analysis, gain, the factored
// constraint (irfft head of each partition's gradient, then the rfft of
// [head || 0]) and the covariance update. On the TPU the transforms were
// dense products with DFT bases, natural for its matrix unit; on this card
// they are real FFTs of length 2B in shared memory (fft.cuh): 3 + 2L
// transforms a step, ~0.35 M flops at the default geometry against 6.3 M
// for the dense products, and no basis stream. K1 runs stage1_warp.cuh's
// step, the one K6 / K7 run (single_stream.cu): every transform belongs to
// one warp, each of the L constraint pairs is one job a warp, the next
// block's analysis runs beside the echo synthesis, and a step has four CTA
// barriers. Its CTA is 10 warps, so at the default geometry two CTAs share
// an SM (~103 KB of shared memory and at most 96 registers a thread each);
// the largest L is 34 at B = 256 and 61 at B = 160. A block with a prime
// factor other than 2, 3 and 5 (e.g. 224 = 2^5 7) keeps the dense step of
// bl_common.cuh (kalman_block_step, bases read from L2); the wrapper picks
// the step from the geometry (kernels/kalman.py) and counts which one ran.
//
// K12's step. Its spectra in, K12 runs stage1_fft.cuh's CTA-wide
// kalman_block_step_fft (shared with K3 and K4): the transforms of a step
// side by side in CTA-wide passes, ~21 barriers a step, each after a pass
// of a few shared-memory loads and stores per thread with 32-320 of the
// 544 threads busy; its layout holds L 24 at B = 256 and 39 at B = 160.
//
// What bounds it. K1's step is bound by its SM's issue in phase 4 (the
// constraint jobs, ~1,600 instructions a lane each; stage1_warp.cuh): ~5.5
// us a step to a batch of 132, one utterance an SM, and ~8 us for a pair
// above it, two utterances sharing the SM's four schedulers. Each
// block's inputs are loaded into registers during the step before. The
// dense step is L2-bandwidth bound (its bases, ~2.1 MB, re-read every step
// of every CTA). The default geometry is compiled with constant sizes and
// the constant radix plan 8, 8, 4; any other at run time.

#include "stage1_warp.cuh"

using namespace aec;

namespace {

// the dense step of bl_common.cuh, on the DFT bases
struct DenseStep {
  using Smem = KalmanSmem;
  Stage1Bases bs;
  template <class G>
  __device__ __forceinline__ void init(const Smem& s, const G& q, const KalmanParams& kp) const {
    kalman_init(s, q, kp);
  }
  template <bool kAnalysis, class G>
  __device__ __forceinline__ void step(const Smem& s, const G& q, int t,
                                       const KalmanParams& kp) const {
    kalman_block_step<kAnalysis>(s, q, t, kp, bs);
  }
};

// K12's FFT step, stage1_fft.cuh's CTA-wide one, on the radix plan and the
// twiddle table
template <class Plan>
struct FftStep {
  using Smem = KalmanFftSmem;
  Plan plan;
  const float* __restrict__ tw;  // (B, 2) fp32
  template <class G>
  __device__ __forceinline__ void init(const Smem& s, const G& q, const KalmanParams& kp) const {
    kalman_fft_init(s, q, kp);
    for (int i = threadIdx.x; i < q.frame; i += kThreads) s.tw[i] = tw[i];
    __syncthreads();
  }
  template <bool kAnalysis, class G>
  __device__ __forceinline__ void step(const Smem& s, const G& q, int t,
                                       const KalmanParams& kp) const {
    kalman_block_step_fft<kAnalysis>(s, q, t, kp, plan);
  }
};

// far: (batch, t_blocks, B) far blocks, or with kSpectraIn
// (batch, t_blocks, 2K) far-frame spectra [re || im]
template <bool kSpectraIn, class Step, class G>
__global__ void __launch_bounds__(kThreads, 2)
kalman_batched_kernel(const float* __restrict__ far, const float* __restrict__ mic,
                      float* __restrict__ e, int t_blocks, G q, Step op, KalmanParams kp) {
  Carve c;
  const typename Step::Smem s(c, q);
  const int B = q.block, K = q.bins;
  const size_t base = static_cast<size_t>(blockIdx.x) * t_blocks * B;
  const int tid = threadIdx.x;

  // Block t's inputs: thread tid's element of its far block (or spectrum)
  // and mic block is loaded into registers during step t - 1; the rest (a
  // block wider than the CTA) at the top of step t.
  const int nx = kSpectraIn ? q.ri : B;
  const size_t blk0 = static_cast<size_t>(blockIdx.x) * t_blocks;
  const auto far_at = [&](int t, int i) { return far[(blk0 + t) * nx + i]; };
  float fx = 0.f, fm = 0.f;
  const auto fetch = [&](int t) {
    if (tid < nx) fx = far_at(t, tid);
    if (tid < B) fm = mic[base + static_cast<size_t>(t) * B + tid];
  };
  const auto place = [&](int i, float v, int t) {
    if constexpr (kSpectraIn) {
      const int head = t % q.L;
      if (i < K) s.xr[head * K + i] = v;
      else s.xi[head * K + i - K] = v;
    } else {
      s.frame[B + i] = v;
    }
  };

  op.init(s, q, kp);
  fetch(0);
  for (int t = 0; t < t_blocks; ++t) {
    const size_t off = base + static_cast<size_t>(t) * B;
    if (tid < nx) place(tid, fx, t);
    if (tid < B) s.e[tid] = fm;
    for (int i = tid + kThreads; i < nx; i += kThreads) place(i, far_at(t, i), t);
    for (int j = tid + kThreads; j < B; j += kThreads) s.e[j] = mic[off + j];
    if (t + 1 < t_blocks) fetch(t + 1);
    __syncthreads();
    op.template step<!kSpectraIn>(s, q, t, kp);
    for (int j = tid; j < B; j += kThreads) e[off + j] = s.e[j];
  }
}

template <bool kSpectraIn, class Step, class G>
cudaError_t launch(const float* far, const float* mic, float* e, int batch, int t_blocks,
                   const G& q, const Step& op, const KalmanParams& kp, int device, void* stream) {
  auto kernel = kalman_batched_kernel<kSpectraIn, Step, G>;
  const size_t smem = smem_bytes<typename Step::Smem>(q);
  cudaError_t err = set_smem(reinterpret_cast<const void*>(kernel), smem, device);
  if (err != cudaSuccess || batch == 0 || t_blocks == 0) return err;
  kernel<<<batch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(far, mic, e, t_blocks, q,
                                                                       op, kp);
  return cudaGetLastError();
}

template <bool kSpectraIn>
int launch_dense(const float* far, const float* mic, float* e, int batch, int t_blocks,
                 int block, int n_blocks, const float* fwd, const float* inv_tail,
                 const float* inv_head, const KalmanParams& kp, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const DenseStep op{Stage1Bases{fwd, inv_tail, inv_head}};
  return with_geom(block, n_blocks, -1, [&](auto q) {
    return launch<kSpectraIn>(far, mic, e, batch, t_blocks, q, op, kp, device, stream);
  });
}

// f(geometry, plan): the default geometry with its compiled plan, or the
// run-time geometry with the host's plan radix[n_pass]
template <class F>
cudaError_t with_plan(int block, int n_blocks, const int* radix, int n_pass, int device, F&& f) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  RunPlan plan{};
  err = read_plan(radix, n_pass, block, plan);
  if (err != cudaSuccess) return err;
  return with_geom(block, n_blocks, -1, [&](auto q) -> cudaError_t {
    if constexpr (std::is_same_v<decltype(q), DefaultGeom>) {
      if (!is_default_plan(plan)) return cudaErrorInvalidValue;
      return f(q, DefaultPlan{});
    } else {
      return f(q, plan);
    }
  });
}

// K1's step: stage1_warp.cuh's, one CTA per utterance, the batch on blockIdx.x
template <class G, class Plan>
__global__ void __launch_bounds__(kStepThreads, 2)
kalman_batched_kernel_warp(const float* __restrict__ far, const float* __restrict__ mic,
                           float* __restrict__ e, int t_blocks, G q, Plan plan,
                           const float* __restrict__ tw, KalmanParams kp) {
  const size_t off = static_cast<size_t>(blockIdx.x) * t_blocks * q.block;
  warp_stage1<false>(far + off, mic + off, e + off, t_blocks, q, plan, tw, kp, NlmsParams{});
}

// f(kernel, geometry, plan, shared memory) on the instantiation of
// kalman_batched_kernel_warp for this geometry and the host's plan, after
// raising its shared memory
template <class F>
cudaError_t with_warp_kernel(int block, int n_blocks, const int* radix, int n_pass, int device,
                             F&& f) {
  return with_plan(block, n_blocks, radix, n_pass, device, [&](auto q, auto plan) -> cudaError_t {
    auto kernel = kalman_batched_kernel_warp<decltype(q), decltype(plan)>;
    const size_t smem = smem_bytes<WarpStepSmem<false>>(q);
    const cudaError_t err = set_smem(reinterpret_cast<const void*>(kernel), smem, device);
    if (err != cudaSuccess) return err;
    return f(kernel, q, plan, smem);
  });
}

}  // namespace

// shared memory of one CTA at this geometry, bytes: the dense step's
extern "C" long long aec_kalman_smem(int block, int n_blocks) {
  return static_cast<long long>(smem_bytes<KalmanSmem>(make_geom(block, n_blocks, 0)));
}

// ... and K12's FFT step's
extern "C" long long aec_kalman_fft_smem(int block, int n_blocks) {
  return static_cast<long long>(smem_bytes<KalmanFftSmem>(make_geom(block, n_blocks, 0)));
}

extern "C" int aec_kalman_batched(const float* far, const float* mic, float* e, int batch,
                                  int t_blocks, int block, int n_blocks, const float* fwd,
                                  const float* inv_tail, const float* inv_head, float a, float a2,
                                  float one_minus_a2, float q_min, float obs, float one_minus_obs,
                                  float floor_, float init_p, int device, void* stream) {
  const KalmanParams kp{a, a2, one_minus_a2, q_min, obs, one_minus_obs, floor_, init_p};
  return launch_dense<false>(far, mic, e, batch, t_blocks, block, n_blocks, fwd, inv_tail,
                             inv_head, kp, device, stream);
}

extern "C" int aec_kalman_batched_spectra(const float* x_ri, const float* mic, float* e,
                                          int batch, int t_blocks, int block, int n_blocks,
                                          const float* fwd, const float* inv_tail,
                                          const float* inv_head, float a, float a2,
                                          float one_minus_a2, float q_min, float obs,
                                          float one_minus_obs, float floor_, float init_p,
                                          int device, void* stream) {
  const KalmanParams kp{a, a2, one_minus_a2, q_min, obs, one_minus_obs, floor_, init_p};
  return launch_dense<true>(x_ri, mic, e, batch, t_blocks, block, n_blocks, fwd, inv_tail,
                            inv_head, kp, device, stream);
}

// K12's FFT step: x_ri the far-frame spectra, tw (B, 2) the twiddle table,
// radix[n_pass] the plan of kernels/fft_plan.py.
extern "C" int aec_kalman_batched_spectra_fft(const float* x_ri, const float* mic, float* e,
                                              int batch, int t_blocks, int block, int n_blocks,
                                              const float* tw, const int* radix, int n_pass,
                                              float a, float a2, float one_minus_a2, float q_min,
                                              float obs, float one_minus_obs, float floor_,
                                              float init_p, int device, void* stream) {
  const KalmanParams kp{a, a2, one_minus_a2, q_min, obs, one_minus_obs, floor_, init_p};
  return with_plan(block, n_blocks, radix, n_pass, device, [&](auto q, auto plan) {
    return launch<true>(x_ri, mic, e, batch, t_blocks, q, FftStep<decltype(plan)>{plan, tw}, kp,
                        device, stream);
  });
}

// K1's warp-owned step (stage1_warp.cuh): far blocks x, tw (B, 2) the
// twiddle table, radix[n_pass] the plan of kernels/fft_plan.py.
extern "C" int aec_kalman_batched_warp(const float* x, const float* mic, float* e, int batch,
                                       int t_blocks, int block, int n_blocks, const float* tw,
                                       const int* radix, int n_pass, float a, float a2,
                                       float one_minus_a2, float q_min, float obs,
                                       float one_minus_obs, float floor_, float init_p,
                                       int device, void* stream) {
  const KalmanParams kp{a, a2, one_minus_a2, q_min, obs, one_minus_obs, floor_, init_p};
  return with_warp_kernel(block, n_blocks, radix, n_pass, device,
                          [&](auto kernel, auto q, auto plan, size_t smem) -> cudaError_t {
    if (batch == 0 || t_blocks == 0) return cudaSuccess;
    kernel<<<batch, kStepThreads, smem, static_cast<cudaStream_t>(stream)>>>(x, mic, e, t_blocks,
                                                                             q, plan, tw, kp);
    return cudaGetLastError();
  });
}

// ... its shared memory of one CTA at this geometry, bytes (K6's layout)
extern "C" long long aec_kalman_warp_smem(int block, int n_blocks) {
  return static_cast<long long>(smem_bytes<WarpStepSmem<false>>(make_geom(block, n_blocks, 0)));
}

// ... and how many of its CTAs one SM holds at this geometry (radix[n_pass]
// as above), or minus a cudaError_t
extern "C" int aec_kalman_warp_ctas(int block, int n_blocks, const int* radix, int n_pass,
                                    int device) {
  int ctas = 0;
  const cudaError_t err = with_warp_kernel(block, n_blocks, radix, n_pass, device,
                                           [&](auto kernel, auto, auto, size_t smem) {
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &ctas, reinterpret_cast<const void*>(kernel), kStepThreads, smem);
  });
  return err == cudaSuccess ? ctas : -static_cast<int>(err);
}

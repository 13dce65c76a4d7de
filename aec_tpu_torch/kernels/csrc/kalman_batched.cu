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
// far-spectrum ring: 5 x L x K fp32) resident in shared memory, so the only
// device-memory traffic is the far blocks (or spectra) and mic blocks in and
// the cancelled blocks out. Two CTAs fit an SM (~101 KB each at the default
// geometry).
//
// The step. Each block update is the far-frame analysis (K1 only), predict,
// echo estimate, echo synthesis, residual analysis, gain, the factored
// constraint (irfft head of each partition's gradient, then the rfft of
// [head || 0]) and the covariance update. On the TPU the transforms were
// dense products with DFT bases, natural for its matrix unit; on this card
// they are real FFTs of length 2B in shared memory (fft.cuh): 3 + 2L
// transforms a step, L of them side by side in each pass, ~0.35 M flops a
// step at the default geometry against 6.3 M for the dense products, and no
// basis stream. The FFT step (kalman_block_step_fft below) keeps the filter
// algebra of bl_common.cuh's kalman_block_step line for line; the gradient
// G goes into an FFT work buffer packed as M complex values (bin 0's real
// part beside bin K-1's in slot 0: the inverse drops their imaginary parts),
// and the head's inverse output is the tail's input with its upper half
// read as zero, so no transform needs a packing pass. The residual e is
// formed in the residual transform's loads, and the next block's predict
// runs in the constraint's last phase. The work buffers take the place of
// the dense step's g, t and tpart and y doubles as the residual's buffer,
// so shared memory does not grow and the largest L stays 24 at B = 256 and
// 39 at B = 160. A block with a prime factor other than 2, 3 and 5 (e.g.
// 224 = 2^5 7) keeps the dense step of bl_common.cuh (kalman_block_step,
// bases read from L2); the wrapper picks the step from the geometry
// (kernels/kalman.py) and counts which one ran.
//
// What bounds it. The FFT step is latency-bound as a batch of one: 21
// barriers a step, each after a pass of a few shared-memory loads and
// stores per thread, with 32-320 of the 544 threads busy in a transform's
// passes. At batch 256 two CTAs share each SM. Each block's inputs are
// loaded into registers during the step before. The dense step is
// L2-bandwidth bound (its bases, ~2.1 MB, re-read every step of every CTA).
// The default geometry is compiled with constant sizes and the constant
// radix plan 8, 8, 4; any other at run time.

#include "fft.cuh"

using namespace aec;

namespace {

// Per-utterance state and work buffers of the FFT step.
struct KalmanFftSmem {
  SArr wr, wi, p;  // (L, K) filter, covariance
  SArr xr, xi;     // (L, K) far-spectrum ring (slot t % L holds block t)
  SArr psi, den;   // (K)
  SArr frame;      // (2B) [previous far block || current far block]
  SArr e;          // (B) mic block in, echo-cancelled block out
  SArr ye;         // (2K) echo-estimate spectrum y, then residual / den
  SArr a, b;       // (L, B) complex: FFT work buffers
  SArr tw;         // (B) complex: W_2B^m, m in [0, B)
  template <class G>
  __host__ __device__ KalmanFftSmem(Carve& c, const G& q) {
    const size_t lk = size_t(q.L) * q.bins;
    wr = c.take(lk); wi = c.take(lk); p = c.take(lk); xr = c.take(lk); xi = c.take(lk);
    psi = c.take(q.bins); den = c.take(q.bins);
    frame = c.take(q.frame); e = c.take(q.block);
    ye = c.take(q.ri);
    a = c.take(size_t(q.L) * q.frame); b = c.take(size_t(q.L) * q.frame);
    tw = c.take(q.frame);
  }
};

// z[n] = (x[2n], x[2n+1]) of the frame [prev || cur]
struct FrameSrc {
  SArr x;
  __device__ __forceinline__ float2 operator()(int, int n) const { return c2(x, n); }
};

// z[n] of [0_B || e] with e = d - irfft(y)[B:] formed on the way (the echo
// synthesis's tail from its inverse zy) and written back: every sample of
// e is read by one work item of the first pass
struct ResidualSrc {
  SArr e, zy;
  int B;
  __device__ __forceinline__ float sample(int m) const {
    if (m < B) return 0.f;
    const float v = e[m - B] - real_sample(zy, 0, m, B);
    e[m - B] = v;
    return v;
  }
  __device__ __forceinline__ float2 operator()(int, int n) const {
    return make_float2(sample(2 * n), sample(2 * n + 1));
  }
};

// z[n] of [t || 0_B], t the first B samples of the head's inverse zh
struct ConstraintTailSrc {
  SArr zh;
  int M, B;
  __device__ __forceinline__ float2 operator()(int l, int n) const {
    const float2 v = elem(zh, l, n, M);
    const int m = 2 * n;
    return make_float2(m < B ? v.x : 0.f, m + 1 < B ? v.y : 0.f);
  }
};

// the inverse's pre-split of y ([re || im], K bins)
struct EchoInvSrc {
  SArr y, tw;
  int M, K;
  float inv_n;
  __device__ __forceinline__ float2 operator()(int, int k) const {
    const int km = M - k;  // in (0, M]: bin K - 1 when k == 0
    const float2 xk = make_float2(y[k], k == 0 ? 0.f : y[K + k]);
    const float2 xm = make_float2(y[km], k == 0 ? 0.f : y[K + km]);
    return inv_split(xk, xm, c2(tw, k), inv_n);
  }
};

// predict W- = aW, P- = a²P + (1-a²)|W|² + q_min of partition bin i, W
// given (the FFT step predicts at the end of the previous step)
__device__ __forceinline__ void predict(const KalmanFftSmem& s, int i, float wr, float wi,
                                        const KalmanParams& kp) {
  s.p[i] = kp.a2 * s.p[i] + kp.one_minus_a2 * (wr * wr + wi * wi) + kp.q_min;
  s.wr[i] = kp.a * wr;
  s.wi[i] = kp.a * wi;
}

// One PBFD-Kalman block update on FFTs (the algebra of bl_common.cuh's
// kalman_block_step; equations: aec_tpu/linear/kalman.py:15-21). Before the
// call s.frame[B:] holds far block t and s.e mic block t (with kAnalysis
// false: ring slot t % L holds block t's far-frame spectrum instead), and
// W, P hold block t's prediction; after it s.e holds the echo-cancelled
// block t and W, P block t + 1's prediction.
template <bool kAnalysis, class G, class Plan>
__device__ __forceinline__ void kalman_block_step_fft(const KalmanFftSmem& s, const G& q, int t,
                                                      const KalmanParams& kp, const Plan& plan) {
  const int tid = threadIdx.x;
  const int B = q.block, K = q.bins, L = q.L, M = q.block;
  const int head = t % L;
  const float inv_n = 1.f / q.frame;

  // 1. far-frame analysis: rfft of [prev || cur] into ring slot `head`;
  //    far ring shift (2., the predict, ran at the end of the step before;
  //    the numbers are kalman_block_step's)
  if constexpr (kAnalysis) {
    const SArr z = fft<false>(plan, q, 1, FrameSrc{s.frame}, s.a, s.b, s.tw);
    for (int k = tid; k < K; k += kThreads) {
      const float2 x = fwd_split(z, 0, k, M, s.tw);
      s.xr[head * K + k] = x.x;
      s.xi[head * K + k] = x.y;
    }
    for (int j = tid; j < B; j += kThreads) s.frame[j] = s.frame[B + j];
    __syncthreads();
  }

  // 3. echo-estimate spectrum y = sum_l W-[l] X[l]
  for (int k = tid; k < K; k += kThreads) {
    float yr = 0.f, yi = 0.f;
    for (int l = 0; l < L; ++l) {
      const int xs = ring_slot(head, l, L) * K + k, ws = l * K + k;
      yr += s.wr[ws] * s.xr[xs] - s.wi[ws] * s.xi[xs];
      yi += s.wr[ws] * s.xi[xs] + s.wi[ws] * s.xr[xs];
    }
    s.ye[k] = yr;
    s.ye[K + k] = yi;
  }
  __syncthreads();

  // 4. echo synthesis irfft(y); 5. e = d - irfft(y)[B:] and the residual
  //    spectrum E = rfft([0 || e]), e formed in the first pass's loads
  const SArr zy = fft<true>(plan, q, 1, EchoInvSrc{s.ye, s.tw, M, K, inv_n}, s.a, s.b, s.tw);
  const SArr zo = zy.off == s.a.off ? s.b : s.a;
  const SArr zr = fft<false>(plan, q, 1, ResidualSrc{s.e, zy, B}, zo, zy, s.tw);

  // 6. observation-noise psd, gain denominator, E / den (into ye: y is spent)
  for (int k = tid; k < K; k += kThreads) {
    const float2 res = fwd_split(zr, 0, k, M, s.tw);
    const float er = res.x, ei = res.y;
    const float psi =
        fmaxf(kp.obs * s.psi[k] + kp.one_minus_obs * (er * er + ei * ei), kp.p_floor);
    s.psi[k] = psi;
    float den = 0.f;
    for (int l = 0; l < L; ++l) {
      const int xs = ring_slot(head, l, L) * K + k;
      den += (s.xr[xs] * s.xr[xs] + s.xi[xs] * s.xi[xs]) * s.p[l * K + k];
    }
    den += 2.f * psi;
    s.den[k] = den;
    s.ye[k] = er / den;
    s.ye[K + k] = ei / den;
  }
  __syncthreads();

  // 7. update G = P- conj(X) E / den, packed into work buffer gb;
  //    covariance P = max(P-(1 - P-|X|²/den), floor)
  const SArr gb = zr.off == s.a.off ? s.b : s.a;
  for (int i = tid; i < L * K; i += kThreads) {
    const int l = i / K, k = i - l * K;
    const int xs = ring_slot(head, l, L) * K + k;
    const float xr = s.xr[xs], xi = s.xi[xs], pp = s.p[i];
    const float erd = s.ye[k], eid = s.ye[K + k];
    pack_bin(gb, l, k, M, make_float2(pp * (xr * erd + xi * eid), pp * (xr * eid - xi * erd)));
    s.p[i] = fmaxf(pp * (1.f - pp * (xr * xr + xi * xi) / s.den[k]), kp.p_floor);
  }
  __syncthreads();

  // 8-9. constraint, all partitions at once: t[l] = irfft(G[l])[:B];
  //      W[l] = W-[l] + rfft([t[l] || 0]); then block t + 1's prediction
  const SArr go = gb.off == s.a.off ? s.b : s.a;
  const SArr zh = fft<true>(plan, q, L, PackedInvSrc{gb, s.tw, M, inv_n}, go, gb, s.tw);
  const SArr other = zh.off == s.a.off ? s.b : s.a;
  const SArr zw = fft<false>(plan, q, L, ConstraintTailSrc{zh, M, B}, other, zh, s.tw);
  for (int i = tid; i < L * K; i += kThreads) {
    const int l = i / K, k = i - l * K;
    const float2 x = fwd_split(zw, l, k, M, s.tw);
    predict(s, i, s.wr[i] + x.x, s.wi[i] + x.y, kp);
  }
  __syncthreads();
}

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

// the FFT step, on the radix plan and the twiddle table
template <class Plan>
struct FftStep {
  using Smem = KalmanFftSmem;
  Plan plan;
  const float* __restrict__ tw;  // (B, 2) fp32
  template <class G>
  __device__ __forceinline__ void init(const Smem& s, const G& q, const KalmanParams& kp) const {
    zero_filter(s, q);
    for (int i = threadIdx.x; i < q.L * q.bins; i += kThreads) {
      s.p[i] = kp.init_p;
      predict(s, i, 0.f, 0.f, kp);  // block 0's
    }
    for (int i = threadIdx.x; i < q.bins; i += kThreads) s.psi[i] = kp.p_floor;
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

template <bool kSpectraIn>
int launch_fft(const float* far, const float* mic, float* e, int batch, int t_blocks, int block,
               int n_blocks, const float* tw, const int* radix, int n_pass,
               const KalmanParams& kp, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  RunPlan plan{};
  err = read_plan(radix, n_pass, block, plan);
  if (err != cudaSuccess) return err;
  return with_geom(block, n_blocks, -1, [&](auto q) -> cudaError_t {
    if constexpr (std::is_same_v<decltype(q), DefaultGeom>) {
      if (!is_default_plan(plan)) return cudaErrorInvalidValue;
      return launch<kSpectraIn>(far, mic, e, batch, t_blocks, q, FftStep<DefaultPlan>{{}, tw},
                                kp, device, stream);
    } else {
      return launch<kSpectraIn>(far, mic, e, batch, t_blocks, q, FftStep<RunPlan>{plan, tw}, kp,
                                device, stream);
    }
  });
}

}  // namespace

// shared memory of one CTA at this geometry, bytes: the dense step's
extern "C" long long aec_kalman_smem(int block, int n_blocks) {
  return static_cast<long long>(smem_bytes<KalmanSmem>(make_geom(block, n_blocks, 0)));
}

// ... and the FFT step's
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

// The FFT step: tw (B, 2) the twiddle table, radix[n_pass] the plan of
// kernels/fft_plan.py; spectra_in selects K12's input (x = x_ri).
extern "C" int aec_kalman_batched_fft(const float* x, const float* mic, float* e, int batch,
                                      int t_blocks, int block, int n_blocks, const float* tw,
                                      const int* radix, int n_pass, int spectra_in, float a,
                                      float a2, float one_minus_a2, float q_min, float obs,
                                      float one_minus_obs, float floor_, float init_p,
                                      int device, void* stream) {
  const KalmanParams kp{a, a2, one_minus_a2, q_min, obs, one_minus_obs, floor_, init_p};
  if (spectra_in)
    return launch_fft<true>(x, mic, e, batch, t_blocks, block, n_blocks, tw, radix, n_pass, kp,
                            device, stream);
  return launch_fft<false>(x, mic, e, batch, t_blocks, block, n_blocks, tw, radix, n_pass, kp,
                           device, stream);
}

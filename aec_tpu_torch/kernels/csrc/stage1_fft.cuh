// The stage-1 block updates on real FFTs in shared memory, for both filters.
//
// kalman_block_step_fft is K1 / K12's step (kalman_batched.cu) and the
// Kalman stage 1 of K3 and K4 (hop.cuh); nlms_block_step_fft is K5's
// (nlms_batched.cu) and K3-NLMS's.
// Each keeps the filter algebra of its dense counterpart in bl_common.cuh
// (kalman_block_step, nlms_block_step) line for line and replaces the dense
// DFT products by real FFTs of length 2B (fft.cuh): the far-frame analysis,
// the echo synthesis, the residual analysis, then the constraint's head (L
// inverse transforms side by side) and tail (L forward ones), ~0.35 M flops
// a step at the default geometry against 6.3 M for the dense products, and
// no basis stream.
//
// The gradient goes into an FFT work buffer packed as M complex values (bin
// 0's real part beside bin K-1's in slot 0: the inverse drops their
// imaginary parts), and the head's inverse output is the tail's input with
// its upper half read as zero, so no transform needs a packing pass. The
// residual e is formed in the residual transform's loads. The Kalman step
// runs the next block's predict in the constraint's last phase, so between
// steps W and P hold the prediction (a caller that keeps the posterior, as
// K3's state does, predicts once after loading and asks the last step not
// to). The work buffers a, b take the place of the dense step's g, t and
// tpart, and ye doubles as the residual's buffer, so shared memory does not
// grow over the dense layouts.
#pragma once

#include "fft.cuh"

namespace aec {

// ---------------------------------------------------------------- Kalman

// Per-utterance state and work buffers of the Kalman FFT step.
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

// the filter's initial state, W and P as block 0's prediction (no barrier)
template <class G>
__device__ __forceinline__ void kalman_fft_init(const KalmanFftSmem& s, const G& q,
                                                const KalmanParams& kp) {
  zero_filter(s, q);
  for (int i = threadIdx.x; i < q.L * q.bins; i += kThreads) {
    s.p[i] = kp.init_p;
    predict(s, i, 0.f, 0.f, kp);
  }
  for (int i = threadIdx.x; i < q.bins; i += kThreads) s.psi[i] = kp.p_floor;
}

// One PBFD-Kalman block update on FFTs (the algebra of bl_common.cuh's
// kalman_block_step; equations: aec_tpu/linear/kalman.py:15-21). Before the
// call s.frame[B:] holds far block t and s.e mic block t (with kAnalysis
// false: ring slot t % L holds block t's far-frame spectrum instead), and
// W, P hold block t's prediction; after it s.e holds the echo-cancelled
// block t and W, P block t + 1's prediction (with predict_next false: block
// t's posterior).
template <bool kAnalysis, class G, class Plan>
__device__ __forceinline__ void kalman_block_step_fft(const KalmanFftSmem& s, const G& q, int t,
                                                      const KalmanParams& kp, const Plan& plan,
                                                      bool predict_next = true) {
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
    if (predict_next) {
      predict(s, i, s.wr[i] + x.x, s.wi[i] + x.y, kp);
    } else {
      s.wr[i] += x.x;
      s.wi[i] += x.y;
    }
  }
  __syncthreads();
}

// ---------------------------------------------------------------- NLMS

// Per-utterance state and work buffers of the NLMS FFT step: KalmanFftSmem
// without the covariance, with NlmsSmem's smoothed far power, 1 / den and
// per-warp partial sums of the power's mean over the bins.
struct NlmsFftSmem {
  SArr wr, wi;            // (L, K) filter
  SArr xr, xi;            // (L, K) far-spectrum ring, as KalmanFftSmem's
  SArr power, psi, inv;   // (K) far power, residual psd, 1 / den
  SArr frame;             // (2B)
  SArr e;                 // (B)
  SArr ye;                // (2K) echo-estimate spectrum y, then the residual spectrum E
  SArr a, b;              // (L, B) complex: FFT work buffers
  SArr tw;                // (B) complex
  SArr red;               // (kWarps) per-warp partial sums of the new power
  template <class G>
  __host__ __device__ NlmsFftSmem(Carve& c, const G& q) {
    const size_t lk = size_t(q.L) * q.bins;
    wr = c.take(lk); wi = c.take(lk); xr = c.take(lk); xi = c.take(lk);
    power = c.take(q.bins); psi = c.take(q.bins); inv = c.take(q.bins);
    frame = c.take(q.frame); e = c.take(q.block);
    ye = c.take(q.ri);
    a = c.take(size_t(q.L) * q.frame); b = c.take(size_t(q.L) * q.frame);
    tw = c.take(q.frame);
    red = c.take(kWarps);
  }
};

// the NLMS filter's initial state (no barrier)
template <class G>
__device__ __forceinline__ void nlms_fft_init(const NlmsFftSmem& s, const G& q) {
  zero_filter(s, q);
  for (int i = threadIdx.x; i < q.bins; i += kThreads) {
    s.power[i] = 0.f;
    s.psi[i] = 0.f;
  }
}

// One MDF block update on FFTs (the algebra of bl_common.cuh's
// nlms_block_step; equations: aec_tpu/linear/nlms.py:20-22, 59-102): the
// Kalman FFT step's five transforms, no predict. Before the call s.frame[B:]
// holds far block t and s.e mic block t; after it s.e holds the
// echo-cancelled block t.
template <class G, class Plan>
__device__ __forceinline__ void nlms_block_step_fft(const NlmsFftSmem& s, const G& q, int t,
                                                    const NlmsParams& np, const Plan& plan) {
  const int tid = threadIdx.x;
  const int B = q.block, K = q.bins, L = q.L, M = q.block;
  const int head = t % L;
  const float inv_n = 1.f / q.frame;

  // 1. far-frame analysis: rfft of [prev || cur] into ring slot `head`;
  //    far ring shift
  {
    const SArr z = fft<false>(plan, q, 1, FrameSrc{s.frame}, s.a, s.b, s.tw);
    for (int k = tid; k < K; k += kThreads) {
      const float2 x = fwd_split(z, 0, k, M, s.tw);
      s.xr[head * K + k] = x.x;
      s.xi[head * K + k] = x.y;
    }
    for (int j = tid; j < B; j += kThreads) s.frame[j] = s.frame[B + j];
    __syncthreads();
  }

  // 2. smoothed far power; echo-estimate spectrum y = sum_l W[l] X[l]; the
  //    power's partial sums per warp for its mean (as nlms_block_step)
  float pw = 0.f;
  for (int k = tid; k < K; k += kThreads) {
    float inst = 0.f, yr = 0.f, yi = 0.f;
    for (int l = 0; l < L; ++l) {
      const int xs = ring_slot(head, l, L) * K + k, ws = l * K + k;
      const float xr = s.xr[xs], xi = s.xi[xs];
      inst += xr * xr + xi * xi;
      yr += s.wr[ws] * xr - s.wi[ws] * xi;
      yi += s.wr[ws] * xi + s.wi[ws] * xr;
    }
    const float p = np.ps * s.power[k] + np.one_minus_ps * inst;
    s.power[k] = p;
    pw += p;
    s.ye[k] = yr;
    s.ye[K + k] = yi;
  }
  {  // every warp whole: lanes past the last bin add 0
    const float sum = warp_sum(pw);
    if (tid % 32 == 0) s.red[tid / 32] = sum;
  }
  __syncthreads();

  // 3. echo synthesis irfft(y); 4. e = d - irfft(y)[B:] and the residual
  //    spectrum E = rfft([0 || e]), e formed in the first pass's loads
  const SArr zy = fft<true>(plan, q, 1, EchoInvSrc{s.ye, s.tw, M, K, inv_n}, s.a, s.b, s.tw);
  const SArr zo = zy.off == s.a.off ? s.b : s.a;
  const SArr zr = fft<false>(plan, q, 1, ResidualSrc{s.e, zy, B}, zo, zy, s.tw);

  // 5. residual psd; den = power + eps + eps_rel mean_k(power) + beta psi;
  //    E into ye (y is spent)
  for (int k = tid; k < K; k += kThreads) {
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += s.red[w];
    const float2 res = fwd_split(zr, 0, k, M, s.tw);
    const float er = res.x, ei = res.y;
    const float psi = np.es * s.psi[k] + np.one_minus_es * (er * er + ei * ei);
    s.psi[k] = psi;
    s.inv[k] = 1.f / (s.power[k] + np.eps + np.eps_rel * (total / K) + np.beta * psi);
    s.ye[k] = er;
    s.ye[K + k] = ei;
  }
  __syncthreads();

  // 6. gradient conj(X[l]) E / den per partition, packed into work buffer gb
  const SArr gb = zr.off == s.a.off ? s.b : s.a;
  for (int i = tid; i < L * K; i += kThreads) {
    const int l = i / K, k = i - l * K;
    const int xs = ring_slot(head, l, L) * K + k;
    const float xr = s.xr[xs], xi = s.xi[xs], er = s.ye[k], ei = s.ye[K + k];
    const float inv = s.inv[k];
    pack_bin(gb, l, k, M, make_float2((xr * er + xi * ei) * inv, (xr * ei - xi * er) * inv));
  }
  __syncthreads();

  // 7-8. constraint, all partitions at once: t[l] = irfft(G[l])[:B];
  //      W[l] += mu rfft([t[l] || 0])
  const SArr go = gb.off == s.a.off ? s.b : s.a;
  const SArr zh = fft<true>(plan, q, L, PackedInvSrc{gb, s.tw, M, inv_n}, go, gb, s.tw);
  const SArr other = zh.off == s.a.off ? s.b : s.a;
  const SArr zw = fft<false>(plan, q, L, ConstraintTailSrc{zh, M, B}, other, zh, s.tw);
  for (int i = tid; i < L * K; i += kThreads) {
    const int l = i / K, k = i - l * K;
    const float2 x = fwd_split(zw, l, k, M, s.tw);
    s.wr[i] += np.mu * x.x;
    s.wi[i] += np.mu * x.y;
  }
  __syncthreads();
}

}  // namespace aec

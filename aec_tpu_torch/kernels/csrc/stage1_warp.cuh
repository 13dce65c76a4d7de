// The stage-1 block updates with every transform in one warp: the step of
// K1 (kalman_batched.cu, one CTA per utterance of a batch) and of K6 / K7
// (single_stream.cu, one utterance on one CTA).
//
// The recursion is serial in time and a step's work is small (~0.35 M flops
// at the default geometry, ~1 us of one SM's FMA rate), so what sets the
// time is the chain of dependent phases, not the flops. Each step is the
// algebra of bl_common.cuh's kalman_block_step / nlms_block_step line for
// line, on real FFTs of length 2B (fft.cuh's schedule and edge rules, the
// plan and twiddles of kernels/fft_plan.py), but every transform is run by
// ONE warp (fft.cuh warp_fft: the passes separated by __syncwarp, no CTA
// barrier inside a transform) in a pair of work buffers private to that
// warp. A step is four phases and four CTA barriers, each at a true
// dependency across bins or partitions:
//   1. all threads, per bin: the staged far spectrum X_t into its ring slot;
//      the echo estimate y = sum_l W[l] X[l], and the part of the gain's
//      denominator that does not wait for the residual (Kalman: sum_l
//      |X[l]|^2 P-[l]; NLMS: the smoothed far power and its per-warp sums
//      for the mean over bins). Barrier: y is whole.
//   2. warp 0: echo synthesis irfft(y), e = d - irfft(y)[B:] (written out)
//      and the residual's transform; beside it warp 1: the far-frame
//      analysis of block t + 1 into a staging spectrum. Barrier.
//   3. all threads, per bin: psi, the denominator, E / den. Barrier.
//   4. jobs, one per warp in turn: partition l's gradient (pre-split for the
//      inverse as it is formed, bins k and M - k in one lane), its
//      constraint (the irfft head, the rfft of [head || 0]) and its update
//      of W[l] (Kalman: P[l], and block t + 1's prediction), all in one
//      warp. Each thread also stores the next blocks' far and mic samples
//      it loaded into registers a step earlier. Barrier: the next step's
//      echo estimate reads every partition.
// stage1_fft.cuh's CTA-wide step runs the same algebra with ~21 CTA
// barriers (one per radix pass). The L constraint pairs need no (L, 2B)
// work buffers: a warp holds one partition at a time. The far blocks sit in
// a ring of three (the analysis of block t + 1 reads blocks t and t + 1
// while block t + 2 is stored), the mic blocks in a ring of two. On the
// default geometry each lane holds its butterflies' twiddles in registers
// (fft.cuh WarpTw).
//
// The CTA is shaped to the jobs: kStepThreads = 10 warps, one for each of
// the L = 10 constraint jobs of the default geometry, and up to 96
// registers a thread with two CTAs an SM (a batch above its SMs' count).
// If the SM numbers the pair's warps in a row, the second CTA's warps fall
// on its four schedulers two places round from the first's and the pair's
// 20 jobs spread 5, 5, 5, 5 (with 12 warps 6, 6, 4, 4). On the card a
// batch of 256 ran ~5 % faster on 10 warps than on 12, ~3 % on 14, and
// ~1 % slower on 11 (PERF.md).
//
// What bounds it. One warp issues every instruction of its transform, so a
// 256-point transform is bound by one warp's instruction latency (~1,000
// cycles at the default geometry), and phase 4 by the SM's four schedulers'
// issue: at L = 10 it is 10 jobs of ~1,600 instructions a lane (two
// transforms, the gradient and pre-split, the split and update), three of
// them on one scheduler. Read on the card, a step of one CTA is ~5.5 us,
// phase 4 ~3.6 of it, phase 2 ~1.1-1.3, phase 1 ~0.6-0.75, phase 3 ~0.25,
// the stores ~0.1, the four barriers themselves ~0.05; two CTAs an SM
// take ~8 us a step for the pair (kernels/single_costs.py: the transforms
// cut out, and cycles by phase; PERF.md has the split).
// Kalman's covariance update multiplies by 1 / den, a reciprocal a bin, where
// kalman_block_step divides by den.
//
// Largest L. Per partition the state alone: W re/im, the ring re/im (and
// Kalman's P): 5K floats for Kalman, 4K for NLMS; beside it min(10, L)
// warps' work buffers (at least 2) of 2 x 2B floats and ~9 B fixed. In 227
// KB a CTA: Kalman (K1, K6) 34 at block 256 and 61 at 160, NLMS (K7) 43
// and 76.
#pragma once

#include "stage1_fft.cuh"

namespace aec {

constexpr int kStepThreads = 320;  // 10 warps: the L = 10 jobs of the default geometry
constexpr int kStepWarps = kStepThreads / 32;

// Per-utterance state and work buffers of the warp-owned step.
template <bool kNlms>
struct WarpStepSmem {
  SArr w;         // (L, K) complex filter
  SArr p;         // (L, K) Kalman covariance
  SArr x;         // (L, K) complex far-spectrum ring (slot t % L holds block t)
  SArr power;     // (K) NLMS smoothed far power
  SArr psi, den;  // (K) residual psd; Kalman: sum_l |X|^2 P-, then 1 / den; NLMS: 1 / den
  SArr ye;        // (K) complex echo estimate y, then E / den (Kalman) or E (NLMS)
  SArr xn;        // (K) complex: the next block's far-frame spectrum
  SArr far3;      // (3, B) far blocks: block t in slot t % 3
  SArr mic2;      // (2, B) mic blocks: block t in slot t % 2
  SArr tw;        // (B) complex: W_2B^m, m in [0, B)
  SArr red;       // (kStepWarps) NLMS: per-warp sums of the far power
  SArr work;      // (max(jobs, 2), 2, B) complex: each warp's two FFT work buffers
  int jobs;       // warps that take jobs: min(kStepWarps, L)
  template <class G>
  __host__ __device__ WarpStepSmem(Carve& c, const G& q) {
    const size_t lk = size_t(q.L) * q.bins;
    w = c.take(2 * lk); p = c.take(kNlms ? 0 : lk); x = c.take(2 * lk);
    power = c.take(kNlms ? q.bins : 0); psi = c.take(q.bins); den = c.take(q.bins);
    ye = c.take(q.ri); xn = c.take(q.ri);
    far3 = c.take(3 * size_t(q.block)); mic2 = c.take(2 * size_t(q.block));
    tw = c.take(q.frame);
    red = c.take(kStepWarps);
    jobs = q.L < kStepWarps ? q.L : kStepWarps;
    work = c.take(size_t(jobs < 2 ? 2 : jobs) * 2 * q.frame);
  }
};

// the inverse's pre-split of y, K complex bins (EchoInvSrc's algebra)
struct EchoInvSrcC {
  SArr y, tw;
  int M;
  float inv_n;
  __device__ __forceinline__ float2 operator()(int, int k) const {
    float2 xk = c2(y, k), xm = c2(y, M - k);  // bin K - 1 when k == 0
    if (k == 0) {
      xk.y = 0.f;
      xm.y = 0.f;
    }
    return inv_split(xk, xm, c2(tw, k), inv_n);
  }
};

// z[n] = (x[2n], x[2n+1]) of the frame [prev || cur], two far blocks
struct FarFrameSrc {
  SArr prev, cur;
  int B;
  __device__ __forceinline__ float sample(int m) const { return m < B ? prev[m] : cur[m - B]; }
  __device__ __forceinline__ float2 operator()(int, int n) const {
    return make_float2(sample(2 * n), sample(2 * n + 1));
  }
};

// z[n] of [0_B || e] with e = d - irfft(y)[B:] formed on the way (the echo
// synthesis's tail from its inverse zy) and written out: every sample of e
// is read by one work item of the first pass
struct ResidualOutSrc {
  SArr d, zy;
  float* out;
  int B;
  __device__ __forceinline__ float sample(int m) const {
    if (m < B) return 0.f;
    const float v = d[m - B] - real_sample(zy, 0, m, B);
    out[m - B] = v;
    return v;
  }
  __device__ __forceinline__ float2 operator()(int, int n) const {
    return make_float2(sample(2 * n), sample(2 * n + 1));
  }
};

// One utterance's stage 1, far / mic (t_blocks, B) in, out (t_blocks, B)
// out, by the calling CTA of kStepThreads threads with WarpStepSmem<kNlms>
// in its dynamic shared memory: the Kalman filter (kp) or NLMS (np).
template <bool kNlms, class G, class Plan>
__device__ __forceinline__ void warp_stage1(const float* __restrict__ far,
                                            const float* __restrict__ mic,
                                            float* __restrict__ out, int t_blocks, const G& q,
                                            const Plan& plan, const float* __restrict__ twd,
                                            const KalmanParams& kp, const NlmsParams& np) {
  Carve carve;
  const WarpStepSmem<kNlms> s(carve, q);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int B = q.block, K = q.bins, L = q.L, M = q.block, F = q.frame;
  const float inv_n = 1.f / F;
  const auto work = [&](int w, int i) { return s.work + (2 * w + i) * F; };
  // the slot of far block t, for t >= -1 (block -1 shares block 2's)
  const auto far_of = [&](int t) { return s.far3 + ((t + 3) % 3) * B; };
  const auto mic_of = [&](int t) { return s.mic2 + (t & 1) * B; };
  const auto sample = [&](const float* x, int t, int j) {
    return t < t_blocks ? x[static_cast<size_t>(t) * B + j] : 0.f;
  };

  // the initial state (Kalman: W, P as block 0's prediction), the twiddles,
  // far blocks -1 (zero), 0 and 1, mic block 0; then X_0 by warp 0
  for (int i = tid; i < L * K; i += kStepThreads) {
    c2(s.w, i) = make_float2(0.f, 0.f);
    c2(s.x, i) = make_float2(0.f, 0.f);
    if constexpr (!kNlms) {  // kalman_fft_init's predict from W = 0, P = init_p
      const float w0 = 0.f;
      s.p[i] = kp.a2 * kp.init_p + kp.one_minus_a2 * (w0 * w0 + w0 * w0) + kp.q_min;
    }
  }
  for (int k = tid; k < K; k += kStepThreads) {
    s.psi[k] = kNlms ? 0.f : kp.p_floor;
    if constexpr (kNlms) s.power[k] = 0.f;
  }
  for (int i = tid; i < F; i += kStepThreads) s.tw[i] = twd[i];
  for (int j = tid; j < B; j += kStepThreads) {
    far_of(-1)[j] = 0.f;
    far_of(0)[j] = sample(far, 0, j);
    far_of(1)[j] = sample(far, 1, j);
    mic_of(0)[j] = sample(mic, 0, j);
  }
  __syncthreads();
  const auto wtw = warp_twiddles(plan, q, s.tw, lane);  // this lane's, or the table

  // the far-frame analysis of block t, rfft([t - 1 || t]), by warp w into xn
  const auto analysis = [&](int t, int w) {
    const SArr z = warp_fft<false>(plan, q, lane, FarFrameSrc{far_of(t - 1), far_of(t), B},
                                   work(w, 0), work(w, 1), wtw);
    for (int k = lane; 2 * k <= M; k += 32) {  // bins k and M - k
      float2 xk, xm;
      fwd_split_pair(z, k, M, s.tw, xk, xm);
      c2(s.xn, k) = xk;
      c2(s.xn, M - k) = xm;
    }
  };

  // partition l's gradient, constraint and update by warp w (step t's ring
  // head); Kalman also block t + 1's prediction of W[l], P[l]. Each lane
  // takes bins k and M - k together: the inverse's pre-split (PackedInvSrc's
  // algebra) and the forward's split (fwd_split's) each read both.
  const auto constrain = [&](int l, int head, int w) {
    const SArr a = work(w, 0), b = work(w, 1);
    const int xs = ring_slot(head, l, L) * K, ws = l * K;
    // gradient P- conj(X) E / den (Kalman; and the posterior P) or
    // conj(X) E / den (NLMS) of bin k
    const auto grad = [&](int k) {
      const float2 xv = c2(s.x, xs + k), ev = c2(s.ye, k);
      const float xr = xv.x, xi = xv.y, er = ev.x, ei = ev.y, inv = s.den[k];
      if constexpr (kNlms) {
        return make_float2((xr * er + xi * ei) * inv, (xr * ei - xi * er) * inv);
      } else {
        const float pp = s.p[ws + k];
        s.p[ws + k] = fmaxf(pp * (1.f - pp * (xr * xr + xi * xi) * inv), kp.p_floor);
        return make_float2(pp * (xr * er + xi * ei), pp * (xr * ei - xi * er));
      }
    };
    // W[l] += its constrained update x (Kalman: then block t + 1's prediction)
    const auto update = [&](int k, float2 x) {
      const int i = ws + k;
      const float2 wv = c2(s.w, i);
      if constexpr (kNlms) {
        c2(s.w, i) = make_float2(wv.x + np.mu * x.x, wv.y + np.mu * x.y);
      } else {
        const float wr = wv.x + x.x, wi = wv.y + x.y;
        s.p[i] = kp.a2 * s.p[i] + kp.one_minus_a2 * (wr * wr + wi * wi) + kp.q_min;
        c2(s.w, i) = make_float2(kp.a * wr, kp.a * wi);
      }
    };
    for (int k = lane; 2 * k <= M; k += 32) {
      const int m = M - k;
      const float2 gk = grad(k), gm = m == k ? gk : grad(m);
      if (k == 0) {  // the inverse drops the imaginary parts of bins 0 and M
        c2(a, 0) = inv_split(make_float2(gk.x, 0.f), make_float2(gm.x, 0.f), c2(s.tw, 0), inv_n);
      } else {
        c2(a, k) = inv_split(gk, gm, c2(s.tw, k), inv_n);
        if (m != k) c2(a, m) = inv_split(gm, gk, c2(s.tw, m), inv_n);
      }
    }
    __syncwarp();
#ifdef AEC_NO_CONSTRAINT_FFT  // kernels/single_costs.py: the constraint without its transforms
    const SArr zw = a;
    (void)b;
#else
    const SArr zh = warp_fft<true>(plan, q, lane, BufSrc{a, M}, b, a, wtw);
    const SArr zo = zh.off == a.off ? b : a;
    const SArr zw = warp_fft<false>(plan, q, lane, ConstraintTailSrc{zh, M, B}, zo, zh, wtw);
#endif
    for (int k = lane; 2 * k <= M; k += 32) {
      float2 xk, xm;
      fwd_split_pair(zw, k, M, s.tw, xk, xm);
      update(k, xk);
      if (M - k != k) update(M - k, xm);
    }
  };

  if (warp == 0) analysis(0, 0);
  // thread tid's sample of far block t + 2 and mic block t + 1, loaded
  // during step t - 1 and stored during step t (the rest of a block wider
  // than the CTA is loaded where it is stored)
  float fx = 0.f, fm = 0.f;
  const auto fetch = [&](int t) {
    if (tid < B) {
      fx = sample(far, t + 2, tid);
      fm = sample(mic, t + 1, tid);
    }
  };
  fetch(0);
  __syncthreads();

  for (int t = 0; t < t_blocks; ++t) {
    const int head = t % L;

    // 1. X_t into its ring slot; per bin the echo estimate y = sum_l W[l] X[l]
    //    and Kalman's sum_l |X[l]|^2 P-[l] or NLMS's smoothed far power (and
    //    its per-warp sums)
    float pw = 0.f;
    for (int k = tid; k < K; k += kStepThreads) {
      c2(s.x, head * K + k) = c2(s.xn, k);
      float yr = 0.f, yi = 0.f, acc = 0.f;
      for (int l = 0; l < L; ++l) {
        const int ws = l * K + k;
        const float2 xv = c2(s.x, ring_slot(head, l, L) * K + k), wv = c2(s.w, ws);
        const float xr = xv.x, xi = xv.y;
        if constexpr (kNlms) acc += xr * xr + xi * xi;
        else acc += (xr * xr + xi * xi) * s.p[ws];
        yr += wv.x * xr - wv.y * xi;
        yi += wv.x * xi + wv.y * xr;
      }
      if constexpr (kNlms) {
        const float pk = np.ps * s.power[k] + np.one_minus_ps * acc;
        s.power[k] = pk;
        pw += pk;
      } else {
        s.den[k] = acc;
      }
      c2(s.ye, k) = make_float2(yr, yi);
    }
    if constexpr (kNlms) {  // every warp whole: lanes past the last bin add 0
      const float sum = warp_sum(pw);
      if (lane == 0) s.red[warp] = sum;
    }
    __syncthreads();

    // 2. warp 0: echo synthesis irfft(y); e = d - irfft(y)[B:] (out) and the
    //    residual spectrum E = rfft([0 || e]); warp 1: the analysis of block
    //    t + 1
    const SArr zy = fft_result(plan, work(0, 0), work(0, 1));
    const SArr zo = zy.off == work(0, 0).off ? work(0, 1) : work(0, 0);
    const SArr zr = fft_result(plan, zo, zy);
    if (warp == 0) {
#ifndef AEC_NO_ECHO_FFT  // kernels/single_costs.py: the echo and residual without transforms
      warp_fft<true>(plan, q, lane, EchoInvSrcC{s.ye, s.tw, M, inv_n}, work(0, 0), work(0, 1),
                     wtw);
      warp_fft<false>(plan, q, lane,
                      ResidualOutSrc{mic_of(t), zy, out + static_cast<size_t>(t) * B, B}, zo, zy,
                      wtw);
#endif
    } else if (warp == 1 && t + 1 < t_blocks) {
      analysis(t + 1, 1);
    }
    __syncthreads();

    // 3. all threads, per bin: psi, den, E / den (Kalman) or 1 / den (NLMS)
    {
      float total = 0.f;
      if constexpr (kNlms) {
#pragma unroll
        for (int w = 0; w < kStepWarps; ++w) total += s.red[w];
      }
      for (int k = tid; k < K; k += kStepThreads) {
        const float2 res = fwd_split(zr, 0, k, M, s.tw);
        const float er = res.x, ei = res.y;
        if constexpr (kNlms) {
          const float psi = np.es * s.psi[k] + np.one_minus_es * (er * er + ei * ei);
          s.psi[k] = psi;
          s.den[k] = 1.f / (s.power[k] + np.eps + np.eps_rel * (total / K) + np.beta * psi);
          c2(s.ye, k) = res;
        } else {
          const float psi =
              fmaxf(kp.obs * s.psi[k] + kp.one_minus_obs * (er * er + ei * ei), kp.p_floor);
          s.psi[k] = psi;
          const float inv = 1.f / (s.den[k] + 2.f * psi);
          s.den[k] = inv;
          c2(s.ye, k) = make_float2(er * inv, ei * inv);
        }
      }
    }
    __syncthreads();

    // 4. jobs 0..L-1 the partitions, one warp each in turn; every thread
    //    stores its prefetched samples
    if (warp < s.jobs) {
      for (int j = warp; j < L; j += s.jobs) {
        __syncwarp();  // the warp's buffers are free
        constrain(j, head, warp);
      }
    }
    if (tid < B) {
      far_of(t + 2)[tid] = fx;
      mic_of(t + 1)[tid] = fm;
    }
    for (int j = tid + kStepThreads; j < B; j += kStepThreads) {
      far_of(t + 2)[j] = sample(far, t + 2, j);
      mic_of(t + 1)[j] = sample(mic, t + 1, j);
    }
    if (t + 1 < t_blocks) fetch(t + 1);
    __syncthreads();
  }
}

}  // namespace aec

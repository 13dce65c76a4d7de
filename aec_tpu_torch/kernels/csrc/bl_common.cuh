// Shared per-step device code of the stage-1 and stage-2 CUDA kernels.
//
// Counterpart of aec_tpu/kernels/bl_common.py: kalman_block_step
// (bl_common.py:248-365), nlms_block_step (bl_common.py:368-449) and
// stage2_frame_step (bl_common.py:452-525). All are CTA-wide functions:
// every thread of a kThreads-thread block calls them, the state lives in the
// block's shared memory, and they end with __syncthreads(). The batched
// kernels (kalman_batched.cu, nlms_batched.cu, stage2.cu) call them once per
// block / frame; two_stage_block_step calls a stage-1 step and the stage-2
// step back to back on one CTA's shared state for the kernels that run both
// stages in one launch (two_stage.cu, serving.cu).
//
// Every product is plain fp32 (FFMA): the TPU kernels' bf16 hi/lo splits and
// separate Nyquist column existed for the bf16 matrix unit and are not needed
// here. Transforms are dense products with constant DFT bases read from
// global memory (L2-resident); the sums over the L filter partitions ride in
// registers, so each basis element is read once per step for all partitions.
#pragma once

#include <cuda_runtime.h>

namespace aec {

constexpr int kBlock = 256;         // stage-1 block == stage-2 hop
constexpr int kFrame = 2 * kBlock;  // analysis frame: N = win = fft = 512
constexpr int kBins = kBlock + 1;   // K = 257
constexpr int kRi = 2 * kBins;      // [re || im] spectrum: 514
constexpr int kThreads = 544;       // 17 warps: one pass over the 514 ri columns
constexpr int kBands = 32;          // ERB bands == GRU hidden (width-1 LittleNet)
constexpr int kSlices = 8;          // bin slices of the ERB projection

static_assert(kThreads >= kRi && kThreads >= 2 * kBlock, "one pass per phase");
static_assert(kSlices * 2 * kBands <= kThreads && 6 * kBands <= kThreads, "");

// ---------------------------------------------------------------- stage 1

struct KalmanParams {
  float a, a2, one_minus_a2, q_min, obs, one_minus_obs, p_floor, init_p;
};

struct Stage1Bases {
  const float* __restrict__ fwd;       // (kFrame, kRi) frame -> ri spectrum
  const float* __restrict__ inv_tail;  // (kRi, kBlock) spectrum -> irfft[B:]
  const float* __restrict__ inv_head;  // (kRi, kBlock) spectrum -> irfft[:B]
};

// Per-utterance state and work vectors (L partitions). The far spectra form
// a ring: block t's spectrum sits in slot t % L, so partition l (l blocks
// old) is slot (t - l) mod L and nothing is shifted per step.
template <int L>
struct KalmanSmem {
  float wr[L * kBins], wi[L * kBins], p[L * kBins];  // filter, covariance
  float xr[L * kBins], xi[L * kBins];                // far-spectrum ring
  float psi[kBins], den[kBins];
  float frame[kFrame];  // [previous far block || current far block]
  float e[kBlock];      // mic block in, echo-cancelled block out
  float y[kRi];         // echo-estimate spectrum
  float er[kRi];        // residual spectrum, then residual / den
  float g[L * kRi];     // gain-weighted update per partition
  float t[L * kBlock], tpart[L * kBlock];  // constraint head (two halves)
};

template <int L>
__device__ void kalman_init(KalmanSmem<L>& s, const KalmanParams& kp) {
  for (int i = threadIdx.x; i < L * kBins; i += kThreads) {
    s.wr[i] = 0.f; s.wi[i] = 0.f; s.xr[i] = 0.f; s.xi[i] = 0.f;
    s.p[i] = kp.init_p;
  }
  for (int i = threadIdx.x; i < kBins; i += kThreads) s.psi[i] = kp.p_floor;
  for (int i = threadIdx.x; i < kFrame; i += kThreads) s.frame[i] = 0.f;
  __syncthreads();
}

// One PBFD-Kalman block update (equations: aec_tpu/linear/kalman.py:15-21).
// Before the call s.frame[kBlock:] holds far block t and s.e mic block t;
// after it s.e holds the echo-cancelled block t. With kAnalysis false the
// caller has already written block t's far-frame spectrum into ring slot
// t % L (and synchronized) in place of step 1, and s.frame is unused.
template <int L, bool kAnalysis = true>
__device__ void kalman_block_step(KalmanSmem<L>& s, int t, const KalmanParams& kp,
                                  const Stage1Bases& bs) {
  const int tid = threadIdx.x;
  const int head = t % L;
  const int j = tid % kBlock, half = tid / kBlock;  // (column, re/im half) split

  // 1. far-frame analysis of [prev || cur] into ring slot `head`
  if constexpr (kAnalysis) {
    if (tid < kRi) {
      float acc = 0.f;
#pragma unroll 8
      for (int n = 0; n < kFrame; ++n) acc = fmaf(s.frame[n], bs.fwd[n * kRi + tid], acc);
      if (tid < kBins) s.xr[head * kBins + tid] = acc;
      else s.xi[head * kBins + tid - kBins] = acc;
    }
    __syncthreads();
  }

  // 2. far ring shift; predict W- = aW, P- = a²P + (1-a²)|W|² + q_min
  if (kAnalysis && tid < kBlock) s.frame[tid] = s.frame[kBlock + tid];
  for (int i = tid; i < L * kBins; i += kThreads) {
    const float wr = s.wr[i], wi = s.wi[i];
    s.p[i] = kp.a2 * s.p[i] + kp.one_minus_a2 * (wr * wr + wi * wi) + kp.q_min;
    s.wr[i] = kp.a * wr;
    s.wi[i] = kp.a * wi;
  }
  __syncthreads();

  // 3. echo-estimate spectrum y = sum_l W-[l] X[l]
  if (tid < kBins) {
    float yr = 0.f, yi = 0.f;
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const int xs = ((head - l + L) % L) * kBins + tid, ws = l * kBins + tid;
      yr += s.wr[ws] * s.xr[xs] - s.wi[ws] * s.xi[xs];
      yi += s.wr[ws] * s.xi[xs] + s.wi[ws] * s.xr[xs];
    }
    s.y[tid] = yr;
    s.y[kBins + tid] = yi;
  }
  __syncthreads();

  // 4. e = d - irfft(y)[B:], the real and imaginary halves summed apart
  float acc_y = 0.f;
  if (half < 2) {
#pragma unroll 8
    for (int c = half * kBins; c < (half + 1) * kBins; ++c)
      acc_y = fmaf(s.y[c], bs.inv_tail[c * kBlock + j], acc_y);
    if (half == 1) s.tpart[j] = acc_y;
  }
  __syncthreads();
  if (half == 0) s.e[j] -= acc_y + s.tpart[j];
  __syncthreads();

  // 5. residual spectrum E = rfft([0 || e])
  if (tid < kRi) {
    float acc = 0.f;
#pragma unroll 8
    for (int n = 0; n < kBlock; ++n) acc = fmaf(s.e[n], bs.fwd[(kBlock + n) * kRi + tid], acc);
    s.er[tid] = acc;
  }
  __syncthreads();

  // 6. observation-noise psd, gain denominator, E / den
  if (tid < kBins) {
    const float er = s.er[tid], ei = s.er[kBins + tid];
    const float psi = fmaxf(kp.obs * s.psi[tid] + kp.one_minus_obs * (er * er + ei * ei), kp.p_floor);
    s.psi[tid] = psi;
    float den = 0.f;
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const int xs = ((head - l + L) % L) * kBins + tid;
      den += (s.xr[xs] * s.xr[xs] + s.xi[xs] * s.xi[xs]) * s.p[l * kBins + tid];
    }
    den += 2.f * psi;
    s.den[tid] = den;
    s.er[tid] = er / den;
    s.er[kBins + tid] = ei / den;
  }
  __syncthreads();

  // 7. update G = P- conj(X) E / den; covariance P = max(P-(1 - P-|X|²/den), floor)
  for (int i = tid; i < L * kBins; i += kThreads) {
    const int l = i / kBins, k = i - l * kBins;
    const int xs = ((head - l + L) % L) * kBins + k;
    const float xr = s.xr[xs], xi = s.xi[xs], pp = s.p[i];
    const float erd = s.er[k], eid = s.er[kBins + k];
    s.g[l * kRi + k] = pp * (xr * erd + xi * eid);
    s.g[l * kRi + kBins + k] = pp * (xr * eid - xi * erd);
    s.p[i] = fmaxf(pp * (1.f - pp * (xr * xr + xi * xi) / s.den[k]), kp.p_floor);
  }
  __syncthreads();

  // 8. constraint head t[l] = irfft(G[l])[:B]; partitions in registers
  float acc_t[L];
#pragma unroll
  for (int l = 0; l < L; ++l) acc_t[l] = 0.f;
  if (half < 2) {
#pragma unroll 2
    for (int c = half * kBins; c < (half + 1) * kBins; ++c) {
      const float ih = bs.inv_head[c * kBlock + j];
#pragma unroll
      for (int l = 0; l < L; ++l) acc_t[l] = fmaf(s.g[l * kRi + c], ih, acc_t[l]);
    }
    if (half == 1) {
#pragma unroll
      for (int l = 0; l < L; ++l) s.tpart[l * kBlock + j] = acc_t[l];
    }
  }
  __syncthreads();
  if (half == 0) {
#pragma unroll
    for (int l = 0; l < L; ++l) s.t[l * kBlock + j] = acc_t[l] + s.tpart[l * kBlock + j];
  }
  __syncthreads();

  // 9. constraint tail W[l] = W-[l] + rfft([t[l] || 0])
  if (tid < kRi) {
    float acc[L];
#pragma unroll
    for (int l = 0; l < L; ++l) acc[l] = 0.f;
#pragma unroll 2
    for (int n = 0; n < kBlock; ++n) {
      const float fb = bs.fwd[n * kRi + tid];
#pragma unroll
      for (int l = 0; l < L; ++l) acc[l] = fmaf(s.t[l * kBlock + n], fb, acc[l]);
    }
    float* w = tid < kBins ? s.wr : s.wi;
    const int k = tid < kBins ? tid : tid - kBins;
#pragma unroll
    for (int l = 0; l < L; ++l) w[l * kBins + k] += acc[l];
  }
  __syncthreads();
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// NlmsConfig's constants, with the two complements as the JAX package
// rounds them to fp32
struct NlmsParams {
  float mu, eps, ps, one_minus_ps, eps_rel, beta, es, one_minus_es;
};

constexpr int kBinWarps = (kBins + 31) / 32;  // warps that hold one bin per thread

// Per-utterance NLMS state and work vectors: KalmanSmem without the
// covariance, with the smoothed far power and the per-warp partial sums of
// its mean over the bins.
template <int L>
struct NlmsSmem {
  float wr[L * kBins], wi[L * kBins];  // filter
  float xr[L * kBins], xi[L * kBins];  // far-spectrum ring, as KalmanSmem's
  float power[kBins], psi[kBins], inv[kBins];  // far power, residual psd, 1/den
  float frame[kFrame];
  float e[kBlock];
  float y[kRi];
  float er[kRi];
  float g[L * kRi];
  float t[L * kBlock], tpart[L * kBlock];
  float red[kBinWarps];  // per-warp partial sums of the new power
};

template <int L>
__device__ void nlms_init(NlmsSmem<L>& s) {
  for (int i = threadIdx.x; i < L * kBins; i += kThreads) {
    s.wr[i] = 0.f; s.wi[i] = 0.f; s.xr[i] = 0.f; s.xi[i] = 0.f;
  }
  for (int i = threadIdx.x; i < kBins; i += kThreads) { s.power[i] = 0.f; s.psi[i] = 0.f; }
  for (int i = threadIdx.x; i < kFrame; i += kThreads) s.frame[i] = 0.f;
  __syncthreads();
}

// One MDF block update (equations: aec_tpu/linear/nlms.py:20-22, 59-102).
// The same transforms as kalman_block_step; no predict step. Before the call
// s.frame[kBlock:] holds far block t and s.e mic block t; after it s.e holds
// the echo-cancelled block t.
template <int L>
__device__ void nlms_block_step(NlmsSmem<L>& s, int t, const NlmsParams& np,
                                const Stage1Bases& bs) {
  const int tid = threadIdx.x;
  const int head = t % L;
  const int j = tid % kBlock, half = tid / kBlock;

  // 1. far-frame analysis of [prev || cur] into ring slot `head`
  if (tid < kRi) {
    float acc = 0.f;
#pragma unroll 8
    for (int n = 0; n < kFrame; ++n) acc = fmaf(s.frame[n], bs.fwd[n * kRi + tid], acc);
    if (tid < kBins) s.xr[head * kBins + tid] = acc;
    else s.xi[head * kBins + tid - kBins] = acc;
  }
  __syncthreads();

  // 2. far ring shift; smoothed far power; echo-estimate spectrum
  //    y = sum_l W[l] X[l]; the power's partial sums per warp for its mean
  if (tid < kBlock) s.frame[tid] = s.frame[kBlock + tid];
  float pw = 0.f;
  if (tid < kBins) {
    float inst = 0.f, yr = 0.f, yi = 0.f;
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const int xs = ((head - l + L) % L) * kBins + tid, ws = l * kBins + tid;
      const float xr = s.xr[xs], xi = s.xi[xs];
      inst += xr * xr + xi * xi;
      yr += s.wr[ws] * xr - s.wi[ws] * xi;
      yi += s.wr[ws] * xi + s.wi[ws] * xr;
    }
    pw = np.ps * s.power[tid] + np.one_minus_ps * inst;
    s.power[tid] = pw;
    s.y[tid] = yr;
    s.y[kBins + tid] = yi;
  }
  if (tid < kBinWarps * 32) {  // whole warps: lanes past the last bin add 0
    const float sum = warp_sum(pw);
    if (tid % 32 == 0) s.red[tid / 32] = sum;
  }
  __syncthreads();

  // 3. e = d - irfft(y)[B:], the real and imaginary halves summed apart
  float acc_y = 0.f;
  if (half < 2) {
#pragma unroll 8
    for (int c = half * kBins; c < (half + 1) * kBins; ++c)
      acc_y = fmaf(s.y[c], bs.inv_tail[c * kBlock + j], acc_y);
    if (half == 1) s.tpart[j] = acc_y;
  }
  __syncthreads();
  if (half == 0) s.e[j] -= acc_y + s.tpart[j];
  __syncthreads();

  // 4. residual spectrum E = rfft([0 || e])
  if (tid < kRi) {
    float acc = 0.f;
#pragma unroll 8
    for (int n = 0; n < kBlock; ++n) acc = fmaf(s.e[n], bs.fwd[(kBlock + n) * kRi + tid], acc);
    s.er[tid] = acc;
  }
  __syncthreads();

  // 5. residual psd; den = power + eps + eps_rel mean_k(power) + beta psi
  if (tid < kBins) {
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < kBinWarps; ++w) total += s.red[w];
    const float er = s.er[tid], ei = s.er[kBins + tid];
    const float psi = np.es * s.psi[tid] + np.one_minus_es * (er * er + ei * ei);
    s.psi[tid] = psi;
    s.inv[tid] = 1.f / (s.power[tid] + np.eps + np.eps_rel * (total / kBins) + np.beta * psi);
  }
  __syncthreads();

  // 6. gradient conj(X[l]) E / den per partition
  for (int i = tid; i < L * kBins; i += kThreads) {
    const int l = i / kBins, k = i - l * kBins;
    const int xs = ((head - l + L) % L) * kBins + k;
    const float xr = s.xr[xs], xi = s.xi[xs], er = s.er[k], ei = s.er[kBins + k];
    s.g[l * kRi + k] = (xr * er + xi * ei) * s.inv[k];
    s.g[l * kRi + kBins + k] = (xr * ei - xi * er) * s.inv[k];
  }
  __syncthreads();

  // 7. constraint head t[l] = irfft(G[l])[:B]; partitions in registers
  float acc_t[L];
#pragma unroll
  for (int l = 0; l < L; ++l) acc_t[l] = 0.f;
  if (half < 2) {
#pragma unroll 2
    for (int c = half * kBins; c < (half + 1) * kBins; ++c) {
      const float ih = bs.inv_head[c * kBlock + j];
#pragma unroll
      for (int l = 0; l < L; ++l) acc_t[l] = fmaf(s.g[l * kRi + c], ih, acc_t[l]);
    }
    if (half == 1) {
#pragma unroll
      for (int l = 0; l < L; ++l) s.tpart[l * kBlock + j] = acc_t[l];
    }
  }
  __syncthreads();
  if (half == 0) {
#pragma unroll
    for (int l = 0; l < L; ++l) s.t[l * kBlock + j] = acc_t[l] + s.tpart[l * kBlock + j];
  }
  __syncthreads();

  // 8. constraint tail W[l] += mu rfft([t[l] || 0])
  if (tid < kRi) {
    float acc[L];
#pragma unroll
    for (int l = 0; l < L; ++l) acc[l] = 0.f;
#pragma unroll 2
    for (int n = 0; n < kBlock; ++n) {
      const float fb = bs.fwd[n * kRi + tid];
#pragma unroll
      for (int l = 0; l < L; ++l) acc[l] = fmaf(s.t[l * kBlock + n], fb, acc[l]);
    }
    float* w = tid < kBins ? s.wr : s.wi;
    const int k = tid < kBins ? tid : tid - kBins;
#pragma unroll
    for (int l = 0; l < L; ++l) w[l * kBins + k] += np.mu * acc[l];
  }
  __syncthreads();
}

// The stage-1 step of a two-stage kernel, by the type of its state.
template <int L>
__device__ void stage1_block_step(KalmanSmem<L>& s, int t, const KalmanParams& kp,
                                  const Stage1Bases& bs) {
  kalman_block_step<L>(s, t, kp, bs);
}

template <int L>
__device__ void stage1_block_step(NlmsSmem<L>& s, int t, const NlmsParams& np,
                                  const Stage1Bases& bs) {
  nlms_block_step<L>(s, t, np, bs);
}

// ---------------------------------------------------------------- stage 2

struct Stage2Weights {
  const float* __restrict__ analysis;   // (kFrame, kRi) windowed analysis DFT
  const float* __restrict__ synthesis;  // (kRi, kFrame) windowed pinv synthesis
  const float* __restrict__ erb;        // (kBins, kBands)
  const float* __restrict__ erb_t;      // (kBands, kBins)
  // weights TRANSPOSED (in, out) so neighbouring threads (outputs) read
  // neighbouring addresses; GRU gates [r; z; n] along the out axis
  const float* __restrict__ w_ih_t;     // (2 kBands, 3 kBands)
  const float* __restrict__ w_hh_t;     // (kBands, 3 kBands)
  const float* __restrict__ b_ih;       // (3 kBands)
  const float* __restrict__ b_hh;       // (3 kBands)
  const float* __restrict__ w1_t;       // (2 kBands, kBands) on [h || mic_erb]
  const float* __restrict__ b1;         // (kBands)
  const float* __restrict__ w2_t;       // (kBands, kBands)
  const float* __restrict__ b2;         // (kBands)
  const float* __restrict__ inv_env;    // (kBlock) inverse interior OLA envelope
};

// What recurs from frame to frame.
struct Stage2State {
  float lin[kFrame], far[kFrame];  // [previous block || current block]
  float h[kBands];                 // GRU state
  float tail[kBlock];              // OLA tail
};

// Work vectors of one frame. Dead between frames, except that the caller
// reads `mask` and `out` right after the step; so a kernel that also runs
// stage 1 may lay them over stage 1's per-step scratch (TwoStageSmem).
struct Stage2Scratch {
  float spec[2 * kRi];  // lin spectrum, far spectrum
  float mag[2 * kBins];  // |lin|, |far|
  float part[kSlices * 2 * kBands];
  float me[kBands], fe[kBands];
  float xp[3 * kBands], hp[3 * kBands];
  float l1[kBands], mask[kBands];
  float y[kRi];  // gain-weighted lin spectrum
  float out[kBlock];
};

struct Stage2Smem {
  Stage2State st;
  Stage2Scratch sc;
};

__device__ __forceinline__ float sigmoid_f(float x) { return 1.f / (1.f + expf(-x)); }

__device__ inline void stage2_init(Stage2State& s) {
  for (int i = threadIdx.x; i < kFrame; i += kThreads) { s.lin[i] = 0.f; s.far[i] = 0.f; }
  for (int i = threadIdx.x; i < kBlock; i += kThreads) s.tail[i] = 0.f;
  for (int i = threadIdx.x; i < kBands; i += kThreads) s.h[i] = 0.f;
  __syncthreads();
}

// One LittleNet frame (equations: aec_tpu/models/little_net.py and
// pipeline/streaming.py). Before the call s.lin[kBlock:] / s.far[kBlock:]
// hold the current blocks; after it x.mask holds this frame's mask and x.out
// the output block this frame completes (the previous one, by OLA).
// off_lin / off_far are subtracted from the whole analysis frames (the
// causal pseudo-norm scalars, bl_common.py:484-490); s.lin / s.far keep the
// raw blocks, so the next frame subtracts its own, newer scalars.
__device__ inline void stage2_frame_step(Stage2State& s, Stage2Scratch& x,
                                         const Stage2Weights& w, bool gain_norm,
                                         float off_lin = 0.f, float off_far = 0.f) {
  const int tid = threadIdx.x;

  // 1. windowed analysis DFT of both frames (one basis read for the two)
  if (tid < kRi) {
    float al = 0.f, af = 0.f;
#pragma unroll 8
    for (int n = 0; n < kFrame; ++n) {
      const float b = w.analysis[n * kRi + tid];
      al = fmaf(s.lin[n] - off_lin, b, al);
      af = fmaf(s.far[n] - off_far, b, af);
    }
    x.spec[tid] = al;
    x.spec[kRi + tid] = af;
  }
  __syncthreads();

  // 2. frame shift; magnitudes with the in-sqrt 1e-9
  if (tid < kBlock) {
    s.lin[tid] = s.lin[kBlock + tid];
    s.far[tid] = s.far[kBlock + tid];
  }
  for (int i = tid; i < 2 * kBins; i += kThreads) {
    const int which = i / kBins, k = i - which * kBins;
    const float re = x.spec[which * kRi + k], im = x.spec[which * kRi + kBins + k];
    x.mag[i] = sqrtf(re * re + im * im + 1e-9f);
  }
  __syncthreads();

  // 3. ERB projection of both magnitudes, in kSlices bin slices
  if (tid < kSlices * 2 * kBands) {
    const int o = tid % (2 * kBands), g = tid / (2 * kBands);
    const int which = o / kBands, e = o - which * kBands;
    float acc = 0.f;
    for (int k = g; k < kBins; k += kSlices)
      acc = fmaf(x.mag[which * kBins + k], w.erb[k * kBands + e], acc);
    x.part[g * 2 * kBands + o] = acc;
  }
  __syncthreads();
  if (tid < 2 * kBands) {
    float acc = 0.f;
#pragma unroll
    for (int g = 0; g < kSlices; ++g) acc += x.part[g * 2 * kBands + tid];
    if (tid < kBands) x.me[tid] = acc;
    else x.fe[tid - kBands] = acc;
  }
  __syncthreads();

  // 4. GRU input projection of [me || |me - fe|] and hidden projection
  if (tid < 3 * kBands) {
    float acc = 0.f;
    for (int i = 0; i < kBands; ++i) acc = fmaf(w.w_ih_t[i * 3 * kBands + tid], x.me[i], acc);
    for (int i = 0; i < kBands; ++i)
      acc = fmaf(w.w_ih_t[(kBands + i) * 3 * kBands + tid], fabsf(x.me[i] - x.fe[i]), acc);
    x.xp[tid] = acc + w.b_ih[tid];
  } else if (tid < 6 * kBands) {
    const int r = tid - 3 * kBands;
    float acc = 0.f;
    for (int i = 0; i < kBands; ++i) acc = fmaf(w.w_hh_t[i * 3 * kBands + r], s.h[i], acc);
    x.hp[r] = acc + w.b_hh[r];
  }
  __syncthreads();

  // 5. GRU cell, torch gate order (b_hn inside the reset product)
  if (tid < kBands) {
    const float r = sigmoid_f(x.xp[tid] + x.hp[tid]);
    const float z = sigmoid_f(x.xp[kBands + tid] + x.hp[kBands + tid]);
    const float n = tanhf(x.xp[2 * kBands + tid] + r * x.hp[2 * kBands + tid]);
    s.h[tid] = (1.f - z) * n + z * s.h[tid];
  }
  __syncthreads();

  // 6. lin1 + relu on [h || me]
  if (tid < kBands) {
    float acc = 0.f;
    for (int i = 0; i < kBands; ++i) acc = fmaf(w.w1_t[i * kBands + tid], s.h[i], acc);
    for (int i = 0; i < kBands; ++i) acc = fmaf(w.w1_t[(kBands + i) * kBands + tid], x.me[i], acc);
    x.l1[tid] = fmaxf(acc + w.b1[tid], 0.f);
  }
  __syncthreads();

  // 7. lin2 + sigmoid: the ERB mask
  if (tid < kBands) {
    float acc = 0.f;
    for (int i = 0; i < kBands; ++i) acc = fmaf(w.w2_t[i * kBands + tid], x.l1[i], acc);
    x.mask[tid] = sigmoid_f(acc + w.b2[tid]);
  }
  __syncthreads();

  // 8. back-projection gain (optionally over the unmasked one) on re and im
  if (tid < kBins) {
    float gsum = 0.f, norm = 0.f;
#pragma unroll 8
    for (int e = 0; e < kBands; ++e) {
      const float b = w.erb_t[e * kBins + tid];
      gsum = fmaf(b, x.mask[e] * x.me[e], gsum);
      norm = fmaf(b, x.me[e], norm);
    }
    const float gain = gain_norm ? gsum / (norm + 1e-9f) : gsum;
    x.y[tid] = gain * x.spec[tid];
    x.y[kBins + tid] = gain * x.spec[kBins + tid];
  }
  __syncthreads();

  // 9. pinv synthesis (real and imaginary halves summed apart) + OLA
  float acc_r = 0.f, acc_i = 0.f;
  if (tid < kFrame) {
#pragma unroll 8
    for (int c = 0; c < kBins; ++c) {
      acc_r = fmaf(x.y[c], w.synthesis[c * kFrame + tid], acc_r);
      acc_i = fmaf(x.y[kBins + c], w.synthesis[(kBins + c) * kFrame + tid], acc_i);
    }
  }
  const float syn = acc_r + acc_i;
  if (tid < kBlock) x.out[tid] = (s.tail[tid] + syn) * w.inv_env[tid] + 1e-9f;
  __syncthreads();
  if (tid >= kBlock && tid < kFrame) s.tail[tid - kBlock] = syn;
  __syncthreads();
}

// ---------------------------------------------------------------- both stages

// Rows of the serving state's per-stream `nm` vector: the causal
// pseudo-norm's running moments (count, sum and sum of squares of the
// stage-1 output, then of the far end), the health monitor's EMAs of mic and
// stage-1-residual block power, one pad row (pallas_serving.py:67-71).
constexpr int kNmRows = 8;
constexpr int kMoments = 5;  // mic², e, e², far, far² summed over a block
// MONITOR_SMOOTH and 1 - MONITOR_SMOOTH, each rounded to fp32 as JAX does
constexpr float kMonitorKeep = 0.99f, kMonitorRate = 0.01f;

// Both stages' state on one CTA; S1 is the stage-1 filter's state
// (KalmanSmem<L> or NlmsSmem<L>). Stage 2's per-frame scratch lies over
// stage 1's update buffer `g`, which is dead once a stage-1 step has
// returned and is fully rewritten by the next one before it is read; that
// keeps the block at 107,120 B with Kalman (97,904 B with NLMS), so two CTAs
// fit on an SM.
template <class S1>
struct TwoStageSmem {
  S1 s1;
  Stage2State s2;
  float nm[kNmRows];
  float red[(kBlock / 32) * kMoments];  // per-warp partial block sums

  __device__ Stage2Scratch& x() { return *reinterpret_cast<Stage2Scratch*>(s1.g); }
  static_assert(sizeof(Stage2Scratch) <= sizeof(S1::g), "scratch must fit in g");
};

// streaming._norm_scalar, rounded step by step as torch rounds it
__device__ __forceinline__ float norm_scalar(float total, float sumsq, float count) {
  const float mean = __fdiv_rn(total, count);
  const float var = __fdiv_rn(__fsub_rn(sumsq, __fmul_rn(__fmul_rn(count, mean), mean)),
                              fmaxf(count - 1.f, 1.f));
  return __fdiv_rn(mean, __fsqrt_rn(fmaxf(var, 1e-12f)));
}

// One two-stage hop on one CTA's state (pallas_serving.py:173-222,
// pallas_two_stage.py:97-122): the stage-1 block update (Kalman or NLMS, by
// the state's type; P its parameters), its cancelled block handed to stage 2
// in shared memory with the far block, then the LittleNet frame. Before the
// call s1.frame[kBlock:] holds far block t and s1.e mic block t; after it
// s1.e holds the stage-1 block, x().out the enhanced block t - 1 and
// x().mask this frame's mask. With `moments` the block's sums fold into
// s.nm: the monitor rows always, the running moments only when `normalize`,
// whose current scalars then offset stage 2's analysis frames.
template <class S1, class P>
__device__ void two_stage_block_step(TwoStageSmem<S1>& s, int t, const P& kp,
                                     const Stage1Bases& bs, const Stage2Weights& w,
                                     bool gain_norm, bool moments, bool normalize) {
  const int tid = threadIdx.x;
  const float mic = tid < kBlock ? s.s1.e[tid] : 0.f;  // s1.e becomes the residual
  stage1_block_step(s.s1, t, kp, bs);
  if (tid < kBlock) {
    s.s2.lin[kBlock + tid] = s.s1.e[tid];
    s.s2.far[kBlock + tid] = s.s1.frame[kBlock + tid];
  }
  float off_lin = 0.f, off_far = 0.f;
  if (moments) {
    if (tid < kBlock) {  // warps 0-7, all lanes active
      const float e = s.s1.e[tid], f = s.s1.frame[kBlock + tid];
      const float v[kMoments] = {mic * mic, e, e * e, f, f * f};
#pragma unroll
      for (int q = 0; q < kMoments; ++q) {
        const float sum = warp_sum(v[q]);
        if (tid % 32 == 0) s.red[(tid / 32) * kMoments + q] = sum;
      }
    }
    __syncthreads();
    if (tid == 0) {
      float sum[kMoments] = {};
      for (int g = 0; g < kBlock / 32; ++g)
#pragma unroll
        for (int q = 0; q < kMoments; ++q) sum[q] += s.red[g * kMoments + q];
      s.nm[5] = kMonitorKeep * s.nm[5] + kMonitorRate * (sum[0] / kBlock);
      s.nm[6] = kMonitorKeep * s.nm[6] + kMonitorRate * (sum[2] / kBlock);
      if (normalize) {
        s.nm[0] += static_cast<float>(kBlock);
#pragma unroll
        for (int q = 1; q < kMoments; ++q) s.nm[q] += sum[q];
      }
    }
    __syncthreads();
    if (normalize) {
      off_lin = norm_scalar(s.nm[1], s.nm[2], s.nm[0]);
      off_far = norm_scalar(s.nm[3], s.nm[4], s.nm[0]);
    }
  } else {
    __syncthreads();
  }
  stage2_frame_step(s.s2, s.x(), w, gain_norm, off_lin, off_far);
}

}  // namespace aec

// Stage-2 (LittleNet) device code on real FFTs: the pieces K2's phases
// (stage2.cu) share with the one-frame step of the per-hop kernels K3 and K4
// (hop.cuh), and that step itself.
//
// Shared with K2: the frame loaders (FrameAt, WindowedSrc), the transform
// policies of K2's phases (FftTr on fft.cuh; DenseTr over the stage-2 bases
// for a hop without a radix plan). The ERB projections and the
// back-projection gain sum over the ERB matrix's support ranges, which the
// host finds once per matrix (kernels/stage2.py erb_support): for each band
// e the first and one past the last bin k with erb[k][e] != 0 (sup[e],
// sup[E + e]; K and 0 for an empty band), then the same for each bin k over
// the bands (sup[2E + k], sup[2E + K + k]). Skipping only exact zeros, the
// sums equal the dense ones in the same order, at ~1/16 of the work (each
// bin lies in at most two ERB bands).
//
// stage2_frame_step_fft is one LittleNet frame with the algebra and rounding
// contract of bl_common.cuh's dense stage2_frame_step: the windowed real
// FFTs of the lin and far frames (the causal pseudo-norm offsets subtracted
// in the loads), magnitudes, ERB sums over the support (exact zeros skipped
// only, so they equal the dense sums taken in bin order), the GRU step in
// the dense step's gate algebra, lin1 and lin2, the back-projection gain,
// then the inverse FFT times the window as the pinv synthesis (window = FFT
// = 2 hop, as K2's phase C) and the OLA with inv_env. Per frame that is 2
// forward and 1 inverse real FFT of 2 hop points and ~30 k flops of small
// products at the default geometry, against 826 k FMA dense.
#pragma once

#include "fft.cuh"

namespace aec {

constexpr int kMaxRun = 8;  // frames per CTA of K2's phases, at most (kernels/stage2.py MAX_RUN)

// raw sample m of the frame [block f-1 || block f] of transform l: lin
// frames f0 .. f0 + n - 1 for l < n, far frames for l >= n (x1), zero past
// the signal's `len` samples and before its start
struct FrameAt {
  const float* __restrict__ x0;
  const float* __restrict__ x1;
  int f0, n, hop, len;
  __device__ __forceinline__ float operator()(int l, int m) const {
    const bool second = l >= n;
    const int s = (f0 + (second ? l - n : l) - 1) * hop + m;
    return s >= 0 && s < len ? (second ? x1 : x0)[s] : 0.f;
  }
};

// z[i] = (w[2i] x[2i], w[2i+1] x[2i+1]) of the windowed frame of transform l
// (the window w in shared or in device memory)
template <class Frame, class Win = SArr>
struct WindowedSrc {
  Frame fr;
  Win win;
  __device__ __forceinline__ float2 operator()(int l, int i) const {
    return make_float2(win[2 * i] * fr(l, 2 * i), win[2 * i + 1] * fr(l, 2 * i + 1));
  }
};

// Real FFTs of 2 hop points on fft.cuh. Work buffers hold transform l at
// complex offset l M (M = hop).
template <class Plan>
struct FftTr {
  Plan plan;
  const float* __restrict__ tw;      // (B, 2) W_2B^m, m < B
  const float* __restrict__ window;  // (2B) analysis / synthesis window

  // the twiddles and the window into shared memory (no barrier)
  template <class G>
  __device__ __forceinline__ void init(const G& q, SArr s_tw, SArr s_win) const {
    for (int i = threadIdx.x; i < q.frame; i += kThreads) {
      s_tw[i] = tw[i];
      s_win[i] = window[i];
    }
  }
  // L forward transforms of the windowed frames; returns the result buffer
  template <class G, class Frame>
  __device__ __forceinline__ SArr forward(const G& q, int L, const Frame& fr, SArr a, SArr b,
                                          SArr s_tw, SArr s_win) const {
    return fft<false>(plan, q, L, WindowedSrc<Frame>{fr, s_win}, a, b, s_tw);
  }
  template <class G>
  __device__ __forceinline__ float2 bin(const G& q, SArr z, int l, int k, SArr s_tw) const {
    return fwd_split(z, l, k, q.block, s_tw);
  }
  template <class G>
  __device__ __forceinline__ void put(const G& q, SArr y, int l, int k, float2 v) const {
    pack_bin(y, l, k, q.block, v);
  }
  // L inverse transforms of the spectra put in y, into dst (y is overwritten)
  template <class G>
  __device__ __forceinline__ SArr inverse(const G& q, int L, SArr y, SArr dst, SArr s_tw) const {
    return fft<true>(plan, q, L, PackedInvSrc{y, s_tw, q.block, 1.f / q.frame}, dst, y, s_tw);
  }
  // sample m of transform l's synthesis frame, windowed
  template <class G>
  __device__ __forceinline__ float syn(const G& q, SArr z, int l, int m, SArr s_win) const {
    return s_win[m] * real_sample(z, l, m, q.block);
  }
};

// Dense transforms over the stage-2 bases, for a hop without an FFT plan:
// frames and syntheses at stride 2B, spectra [re || im] at stride 2K.
struct DenseTr {
  const float* __restrict__ analysis;   // (2B, 2K) windowed analysis DFT
  const float* __restrict__ synthesis;  // (2K, 2B) windowed pinv synthesis

  template <class G>
  __device__ __forceinline__ void init(const G&, SArr, SArr) const {}
  // the raw frames into a, then their spectra into b (each basis element
  // read once for the run's L transforms)
  template <class G, class Frame>
  __device__ __forceinline__ SArr forward(const G& q, int L, const Frame& fr, SArr a, SArr b,
                                          SArr, SArr) const {
    const int N = q.frame, ri = q.ri;
    for (int i = threadIdx.x; i < L * N; i += kThreads) a[i] = fr(i / N, i % N);
    __syncthreads();
    for (int c = threadIdx.x; c < ri; c += kThreads) {
      float acc[2 * kMaxRun] = {};
      for (int m = 0; m < N; ++m) {
        const float v = analysis[m * ri + c];
#pragma unroll
        for (int l = 0; l < 2 * kMaxRun; ++l)
          if (l < L) acc[l] = fmaf(a[l * N + m], v, acc[l]);
      }
#pragma unroll
      for (int l = 0; l < 2 * kMaxRun; ++l)
        if (l < L) b[l * ri + c] = acc[l];
    }
    __syncthreads();
    return b;
  }
  template <class G>
  __device__ __forceinline__ float2 bin(const G& q, SArr z, int l, int k, SArr) const {
    return make_float2(z[l * q.ri + k], z[l * q.ri + q.bins + k]);
  }
  template <class G>
  __device__ __forceinline__ void put(const G& q, SArr y, int l, int k, float2 v) const {
    y[l * q.ri + k] = v.x;
    y[l * q.ri + q.bins + k] = v.y;
  }
  // the real and imaginary halves summed apart, as bl_common.cuh's step 9
  template <class G>
  __device__ __forceinline__ SArr inverse(const G& q, int L, SArr y, SArr dst, SArr) const {
    const int N = q.frame, K = q.bins, ri = q.ri;
    for (int m = threadIdx.x; m < N; m += kThreads) {
      float re[kMaxRun + 1] = {}, im[kMaxRun + 1] = {};
      for (int c = 0; c < K; ++c) {
        const float br = synthesis[c * N + m], bi = synthesis[(K + c) * N + m];
#pragma unroll
        for (int l = 0; l < kMaxRun + 1; ++l)
          if (l < L) {
            re[l] = fmaf(y[l * ri + c], br, re[l]);
            im[l] = fmaf(y[l * ri + K + c], bi, im[l]);
          }
      }
#pragma unroll
      for (int l = 0; l < kMaxRun + 1; ++l)
        if (l < L) dst[l * N + m] = re[l] + im[l];
    }
    __syncthreads();
    return dst;
  }
  template <class G>
  __device__ __forceinline__ float syn(const G& q, SArr z, int l, int m, SArr) const {
    return z[l * q.frame + m];
  }
};


// ---------------------------------------------------------------- one frame on FFTs

// Work vectors of one frame on FFTs. Dead between frames, except that the
// caller reads `mask` and `out` right after the step, so a kernel that also
// runs stage 1 lays them over stage 1's FFT work buffers (hop.cuh).
struct Stage2FftScratch {
  SArr za, zb;    // (2, 2B) each: FFT work buffers of the lin and far frames
  SArr me, fe;    // (E)
  SArr xp, hp;    // (3E)
  SArr l1, mask;  // (E)
  SArr out;       // (B)
  template <class G>
  __host__ __device__ Stage2FftScratch(Carve& c, const G& q) {
    const int e = q.bands;
    za = c.take(2 * size_t(q.frame)); zb = c.take(2 * size_t(q.frame));
    me = c.take(e); fe = c.take(e); xp = c.take(3 * e); hp = c.take(3 * e);
    l1 = c.take(e); mask = c.take(e); out = c.take(q.block);
  }
};

// sample m of the lin (transform 0) or far (1) frame of a Stage2State with
// the causal pseudo-norm offset subtracted
struct HopFrame {
  SArr lin, far;
  float off_lin, off_far;
  __device__ __forceinline__ float operator()(int l, int m) const {
    return l ? far[m] - off_far : lin[m] - off_lin;
  }
};

// One LittleNet frame on FFTs (equations: aec_tpu/models/little_net.py and
// pipeline/streaming.py), stage2_frame_step's contract: before the call
// s.lin[B:] / s.far[B:] hold the current blocks; after it x.mask holds this
// frame's mask and x.out the output block this frame completes. tw is the
// twiddle table W_2B^m (the stage-1 step's: stage-1 block == hop), w.window
// the analysis / synthesis window and w.sup erb's support.
template <class G, class Plan>
__device__ __forceinline__ void stage2_frame_step_fft(const Stage2State& s,
                                                      const Stage2FftScratch& x, const G& q,
                                                      const Stage2Weights& w, const Plan& plan,
                                                      SArr tw, bool gain_norm, float off_lin = 0.f,
                                                      float off_far = 0.f) {
  const int tid = threadIdx.x;
  const int B = q.block, K = q.bins, E = q.bands, M = q.block;

  // 1. windowed real FFTs of both frames, the offsets subtracted in the loads
  const SArr z = fft<false>(plan, q, 2,
                            WindowedSrc<HopFrame, const float*>{
                                HopFrame{s.lin, s.far, off_lin, off_far}, w.window},
                            x.za, x.zb, tw);
  const SArr fr = z.off == x.za.off ? x.zb : x.za;  // the free buffer

  // 2. frame shift; magnitudes with the in-sqrt 1e-9 (|lin| || |far|, into fr)
  for (int j = tid; j < B; j += kThreads) {
    s.lin[j] = s.lin[B + j];
    s.far[j] = s.far[B + j];
  }
  for (int i = tid; i < 2 * K; i += kThreads) {
    const int l = i >= K, k = i - l * K;
    const float2 v = fwd_split(z, l, k, M, tw);
    fr[i] = sqrtf(v.x * v.x + v.y * v.y + 1e-9f);
  }
  __syncthreads();

  // 3. ERB projections of both magnitudes over each band's support
  for (int o = tid; o < 2 * E; o += kThreads) {
    const int l = o >= E, e = o - l * E, hi = w.sup[E + e];
    float acc = 0.f;
    for (int k = w.sup[e]; k < hi; ++k) acc = fmaf(fr[l * K + k], w.erb[k * E + e], acc);
    (l ? x.fe : x.me)[e] = acc;
  }
  __syncthreads();

  // 4. GRU input projection of [me || |me - fe|] and hidden projection
  for (int idx = tid; idx < 6 * E; idx += kThreads) {
    if (idx < 3 * E) {
      float acc = 0.f;
      for (int i = 0; i < E; ++i) acc = fmaf(w.w_ih_t[i * 3 * E + idx], x.me[i], acc);
      for (int i = 0; i < E; ++i)
        acc = fmaf(w.w_ih_t[(E + i) * 3 * E + idx], fabsf(x.me[i] - x.fe[i]), acc);
      x.xp[idx] = acc + w.b_ih[idx];
    } else {
      const int r = idx - 3 * E;
      float acc = 0.f;
      for (int i = 0; i < E; ++i) acc = fmaf(w.w_hh_t[i * 3 * E + r], s.h[i], acc);
      x.hp[r] = acc + w.b_hh[r];
    }
  }
  __syncthreads();

  // 5. GRU cell, torch gate order (b_hn inside the reset product)
  for (int e = tid; e < E; e += kThreads) {
    const float r = sigmoid_f(x.xp[e] + x.hp[e]);
    const float z_ = sigmoid_f(x.xp[E + e] + x.hp[E + e]);
    const float n = tanhf(x.xp[2 * E + e] + r * x.hp[2 * E + e]);
    s.h[e] = (1.f - z_) * n + z_ * s.h[e];
  }
  __syncthreads();

  // 6. lin1 + relu on [h || me]
  for (int e = tid; e < E; e += kThreads) {
    float acc = 0.f;
    for (int i = 0; i < E; ++i) acc = fmaf(w.w1_t[i * E + e], s.h[i], acc);
    for (int i = 0; i < E; ++i) acc = fmaf(w.w1_t[(E + i) * E + e], x.me[i], acc);
    x.l1[e] = fmaxf(acc + w.b1[e], 0.f);
  }
  __syncthreads();

  // 7. lin2 + sigmoid: the ERB mask
  for (int e = tid; e < E; e += kThreads) {
    float acc = 0.f;
    for (int i = 0; i < E; ++i) acc = fmaf(w.w2_t[i * E + e], x.l1[i], acc);
    x.mask[e] = sigmoid_f(acc + w.b2[e]);
  }
  __syncthreads();

  // 8. back-projection gain (optionally over the unmasked one) over each
  //    bin's support; y = gain * spec_lin, packed for the inverse into fr
  //    (the magnitudes are spent)
  for (int k = tid; k < K; k += kThreads) {
    float gsum = 0.f, norm = 0.f;
    const int hi = w.sup[2 * E + K + k];
    for (int e = w.sup[2 * E + k]; e < hi; ++e) {
      const float b = w.erb_t[e * K + k], me = x.me[e];
      gsum = fmaf(b, x.mask[e] * me, gsum);
      norm = fmaf(b, me, norm);
    }
    const float gain = gain_norm ? gsum / (norm + 1e-9f) : gsum;
    const float2 v = fwd_split(z, 0, k, M, tw);
    pack_bin(fr, 0, k, M, make_float2(gain * v.x, gain * v.y));
  }
  __syncthreads();

  // 9. synthesis: window x irfft(y) (the pinv synthesis); OLA with the old
  //    tail, each sample's new tail written by the thread that read its old
  const SArr zs = fft<true>(plan, q, 1, PackedInvSrc{fr, tw, M, 1.f / q.frame}, z, fr, tw);
  for (int j = tid; j < B; j += kThreads) {
    const float head = w.window[j] * real_sample(zs, 0, j, M);
    const float tail = w.window[B + j] * real_sample(zs, 0, B + j, M);
    x.out[j] = (s.tail[j] + head) * w.inv_env[j] + 1e-9f;
    s.tail[j] = tail;
  }
  __syncthreads();
}

}  // namespace aec

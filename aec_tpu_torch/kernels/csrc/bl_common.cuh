// Shared per-step device code of the stage-1 and stage-2 CUDA kernels: the
// geometry, the shared-memory carving, and the dense formulation of the
// per-step functions.
//
// Counterpart of aec_tpu/kernels/bl_common.py: kalman_block_step
// (bl_common.py:248-365), nlms_block_step (bl_common.py:368-449) and
// stage2_frame_step (bl_common.py:452-525), with their transforms as dense
// products over DFT bases. All are CTA-wide functions: every thread of a
// kThreads-thread block calls them, the state lives in the block's shared
// memory, and they end with __syncthreads(). K1 / K12, K5, K3 and K4 run
// them, and two_stage_block_step (the dense two-stage hop), only for a block
// with a prime factor other than 2, 3 and 5, which has no FFT plan (K6 / K7
// then run their dense transforms on a cluster, single_stream.cu). Every
// other geometry of those kernels runs the same algebra on real FFTs:
// stage1_fft.cuh (the stage-1 steps), stage2_fft.cuh (one LittleNet frame,
// and the pieces K2's phases share), hop.cuh (the two-stage hop of K3 and
// K4) and single_stream.cu (one utterance on one CTA), which reuse this
// header's geometry, carving, filter parameters, stage-2 state and the
// hop's hand-off.
//
// Geometry. As the JAX kernels read it from the config and the shapes, so
// these take it at run time (Geom): the stage-1 block B (== the stage-2 hop;
// frame 2B, K = B + 1 bins, [re || im] spectra of 2K), the partition count L
// and the number of ERB bands E (== LittleNet's GRU width). The shared-memory
// layouts are carved at run time from one dynamic allocation by the same
// __host__ __device__ code the host sizes the launch with, and every phase is
// a loop strided by the block over its axis, so any geometry runs; a launch
// is refused only when its layout exceeds the CTA's shared memory. Every
// function is a template over the geometry type: the launchers instantiate
// each kernel twice, for FixedGeom<256, 10, 32> (the default geometry, with
// every size a compile-time constant, so the loops unroll over constant
// strides and the layout offsets fold to immediates, as the fixed-size
// kernels did) and for the run-time Geom (every other geometry). At the
// default geometry every loop makes one pass with the thread mapping and
// summation order the fixed-size kernels had.
//
// The layouts hold offsets into the kernel's dynamic shared memory (SArr),
// not generic pointers, so every access compiles to a shared-memory
// instruction.
//
// Every product is plain fp32 (FFMA): the TPU kernels' bf16 hi/lo splits and
// separate Nyquist column existed for the bf16 matrix unit and are not needed
// here. The dense transforms are products with constant DFT bases read from
// global memory (L2-resident); the sums over the L filter partitions ride in
// registers, kLC partitions per pass over a basis (the last pass of a larger
// L in chunks of 4, 2, 1), so at L <= kLC each basis element is read once per
// step for all partitions.
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

namespace aec {

constexpr int kThreads = 544;  // 17 warps: one pass over the 514 ri columns at B = 256
constexpr int kWarps = kThreads / 32;
constexpr int kSlices = 8;  // bin slices of the ERB projection
constexpr int kLC = 10;     // partitions per register pass of the constraint products

struct Geom {
  int block;  // B: stage-1 block == stage-2 hop
  int bins;   // K = B + 1
  int ri;     // 2K: a spectrum [re || im]
  int frame;  // 2B: analysis frame
  int L;      // stage-1 partitions
  int bands;  // E: ERB bands == stage-2 GRU width
};

__host__ __device__ inline Geom make_geom(int block, int L, int bands) {
  return Geom{block, block + 1, 2 * (block + 1), 2 * block, L, bands};
}

// A geometry whose sizes are compile-time constants, read through the same
// member names as Geom's.
template <int kB, int kL, int kE>
struct FixedGeom {
  static constexpr int block = kB, bins = kB + 1, ri = 2 * (kB + 1), frame = 2 * kB, L = kL,
                       bands = kE;
};
using DefaultGeom = FixedGeom<256, 10, 32>;

// f(geometry): DefaultGeom when (block, L, bands) is the default (a negative
// L or bands matches any, for kernels without partitions or bands), else the
// run-time Geom.
template <class F>
cudaError_t with_geom(int block, int L, int bands, F&& f) {
  if (block == DefaultGeom::block && (L < 0 || L == DefaultGeom::L) &&
      (bands < 0 || bands == DefaultGeom::bands))
    return f(DefaultGeom{});
  return f(make_geom(block, L, bands));
}

// every kernel's dynamic shared memory
extern __shared__ float4 aec_smem4[];

// A float array in the kernel's dynamic shared memory, by its offset.
struct SArr {
  unsigned off;  // floats from the start of dynamic shared memory
  __device__ __forceinline__ float& operator[](int i) const {
    return reinterpret_cast<float*>(aec_smem4)[off + i];
  }
  __host__ __device__ SArr operator+(int k) const { return SArr{off + static_cast<unsigned>(k)}; }
};

// Hands out 16-byte-aligned float arrays of dynamic shared memory, from
// offset `n` on; on the host it sizes a launch.
struct Carve {
  size_t n;  // floats handed out so far
  __host__ __device__ explicit Carve(size_t start = 0) : n(start) {}
  __host__ __device__ SArr take(size_t k) {
    const SArr r{static_cast<unsigned>(n)};
    n += (k + 3) / 4 * 4;
    return r;
  }
  __host__ __device__ size_t bytes() const { return n * sizeof(float); }
};

// ring slot of partition l (l blocks old) at step head = t % L
__device__ __forceinline__ int ring_slot(int head, int l, int L) {
  const int s = head - l;
  return s < 0 ? s + L : s;
}

template <int N>
using Int = std::integral_constant<int, N>;

// f(Int<NL>{}, l0) for partition chunks [l0, l0 + NL) covering [0, L)
template <class F>
__device__ __forceinline__ void for_chunks(int L, F&& f) {
  int l0 = 0;
  for (; l0 + kLC <= L; l0 += kLC) f(Int<kLC>{}, l0);
  for (; l0 + 4 <= L; l0 += 4) f(Int<4>{}, l0);
  for (; l0 + 2 <= L; l0 += 2) f(Int<2>{}, l0);
  for (; l0 < L; ++l0) f(Int<1>{}, l0);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------- stage 1

struct KalmanParams {
  float a, a2, one_minus_a2, q_min, obs, one_minus_obs, p_floor, init_p;
};

// NlmsConfig's constants, with the two complements as the JAX package
// rounds them to fp32
struct NlmsParams {
  float mu, eps, ps, one_minus_ps, eps_rel, beta, es, one_minus_es;
};

struct Stage1Bases {
  const float* __restrict__ fwd;       // (2B, 2K) frame -> ri spectrum
  const float* __restrict__ inv_tail;  // (2K, B) spectrum -> irfft[B:]
  const float* __restrict__ inv_head;  // (2K, B) spectrum -> irfft[:B]
};

// Per-utterance Kalman state and work vectors. The far spectra form a ring:
// block t's spectrum sits in slot t % L, so partition l (l blocks old) is
// slot (t - l) mod L and nothing is shifted per step.
struct KalmanSmem {
  SArr wr, wi, p;  // (L, K) filter, covariance
  SArr xr, xi;      // (L, K) far-spectrum ring
  SArr psi, den;    // (K)
  SArr frame;        // (2B) [previous far block || current far block]
  SArr e;            // (B) mic block in, echo-cancelled block out
  SArr y, er;       // (2K) echo-estimate spectrum; residual, then residual / den
  SArr g;            // (L, 2K) gain-weighted update per partition
  SArr t, tpart;    // (L, B) constraint head (two halves)
  template <class G>
  __host__ __device__ KalmanSmem(Carve& c, const G& q) {
    const size_t lk = size_t(q.L) * q.bins;
    wr = c.take(lk); wi = c.take(lk); p = c.take(lk); xr = c.take(lk); xi = c.take(lk);
    psi = c.take(q.bins); den = c.take(q.bins);
    frame = c.take(q.frame); e = c.take(q.block);
    y = c.take(q.ri); er = c.take(q.ri);
    g = c.take(size_t(q.L) * q.ri);
    t = c.take(size_t(q.L) * q.block); tpart = c.take(size_t(q.L) * q.block);
  }
};

// Per-utterance NLMS state and work vectors: KalmanSmem without the
// covariance, with the smoothed far power and the per-warp partial sums of
// its mean over the bins.
struct NlmsSmem {
  SArr wr, wi;               // (L, K) filter
  SArr xr, xi;               // (L, K) far-spectrum ring, as KalmanSmem's
  SArr power, psi, inv;     // (K) far power, residual psd, 1/den
  SArr frame;                 // (2B)
  SArr e;                     // (B)
  SArr y, er;                // (2K)
  SArr g;                     // (L, 2K)
  SArr t, tpart;             // (L, B)
  SArr red;                   // (kWarps) per-warp partial sums of the new power
  template <class G>
  __host__ __device__ NlmsSmem(Carve& c, const G& q) {
    const size_t lk = size_t(q.L) * q.bins;
    wr = c.take(lk); wi = c.take(lk); xr = c.take(lk); xi = c.take(lk);
    power = c.take(q.bins); psi = c.take(q.bins); inv = c.take(q.bins);
    frame = c.take(q.frame); e = c.take(q.block);
    y = c.take(q.ri); er = c.take(q.ri);
    g = c.take(size_t(q.L) * q.ri);
    t = c.take(size_t(q.L) * q.block); tpart = c.take(size_t(q.L) * q.block);
    red = c.take(kWarps);
  }
};

template <class S, class G>
__device__ __forceinline__ void zero_filter(const S& s, const G& q) {
  for (int i = threadIdx.x; i < q.L * q.bins; i += kThreads) {
    s.wr[i] = 0.f; s.wi[i] = 0.f; s.xr[i] = 0.f; s.xi[i] = 0.f;
  }
  for (int i = threadIdx.x; i < q.frame; i += kThreads) s.frame[i] = 0.f;
}

template <class G>
__device__ __forceinline__ void kalman_init(const KalmanSmem& s, const G& q,
                                            const KalmanParams& kp) {
  zero_filter(s, q);
  for (int i = threadIdx.x; i < q.L * q.bins; i += kThreads) s.p[i] = kp.init_p;
  for (int i = threadIdx.x; i < q.bins; i += kThreads) s.psi[i] = kp.p_floor;
  __syncthreads();
}

template <class G>
__device__ __forceinline__ void nlms_init(const NlmsSmem& s, const G& q) {
  zero_filter(s, q);
  for (int i = threadIdx.x; i < q.bins; i += kThreads) { s.power[i] = 0.f; s.psi[i] = 0.f; }
  __syncthreads();
}

// far-frame analysis of s.frame into ring slot `head`
template <class S, class G>
__device__ __forceinline__ void far_analysis(const S& s, const G& q, int head,
                                             const Stage1Bases& bs) {
  const int K = q.bins, ri = q.ri;
  for (int c = threadIdx.x; c < ri; c += kThreads) {
    const float* b = bs.fwd + c;
    float acc = 0.f;
#pragma unroll 8
    for (int n = 0; n < q.frame; ++n) acc = fmaf(s.frame[n], b[n * ri], acc);
    if (c < K) s.xr[head * K + c] = acc;
    else s.xi[head * K + c - K] = acc;
  }
}

// e = d - irfft(y)[B:], the real and imaginary halves summed apart (the
// real half parked in t, the imaginary half in tpart)
template <class S, class G>
__device__ __forceinline__ void echo_subtract(const S& s, const G& q, const Stage1Bases& bs) {
  const int B = q.block, K = q.bins;
  for (int idx = threadIdx.x; idx < 2 * B; idx += kThreads) {
    const int half = idx >= B, j = idx - half * B;
    const float* b = bs.inv_tail + j;
    float acc = 0.f;
#pragma unroll 8
    for (int c = half * K; c < (half + 1) * K; ++c) acc = fmaf(s.y[c], b[c * B], acc);
    (half ? s.tpart : s.t)[j] = acc;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < B; j += kThreads) s.e[j] -= s.t[j] + s.tpart[j];
  __syncthreads();
}

// residual spectrum E = rfft([0 || e])
template <class S, class G>
__device__ __forceinline__ void residual_analysis(const S& s, const G& q,
                                                  const Stage1Bases& bs) {
  const int B = q.block, ri = q.ri;
  for (int c = threadIdx.x; c < ri; c += kThreads) {
    const float* b = bs.fwd + size_t(B) * ri + c;
    float acc = 0.f;
#pragma unroll 8
    for (int n = 0; n < B; ++n) acc = fmaf(s.e[n], b[n * ri], acc);
    s.er[c] = acc;
  }
  __syncthreads();
}

// constraint head t[l] = irfft(G[l])[:B] for l in [l0, l0 + NL): the real
// half into t, the imaginary half into tpart
template <int NL, class S, class G>
__device__ __forceinline__ void head_chunk(const S& s, const G& q, int l0,
                                           const float* __restrict__ inv_head) {
  const int B = q.block, K = q.bins, ri = q.ri;
  const SArr g = s.g + l0 * ri;
  for (int idx = threadIdx.x; idx < 2 * B; idx += kThreads) {
    const int half = idx >= B, j = idx - half * B;
    const float* ih = inv_head + j;
    float acc[NL];
#pragma unroll
    for (int l = 0; l < NL; ++l) acc[l] = 0.f;
#pragma unroll 2
    for (int c = half * K; c < (half + 1) * K; ++c) {
      const float h = ih[c * B];
#pragma unroll
      for (int l = 0; l < NL; ++l) acc[l] = fmaf(g[l * ri + c], h, acc[l]);
    }
    const SArr dst = (half ? s.tpart : s.t) + (l0 * B + j);
#pragma unroll
    for (int l = 0; l < NL; ++l) dst[l * B] = acc[l];
  }
}

// constraint tail W[l] += scale * rfft([t[l] || 0]) for l in [l0, l0 + NL)
template <int NL, bool kScaled, class S, class G>
__device__ __forceinline__ void tail_chunk(const S& s, const G& q, int l0,
                                           const float* __restrict__ fwd, float mu) {
  const int B = q.block, K = q.bins, ri = q.ri;
  const SArr tt = s.t + l0 * B;
  for (int c = threadIdx.x; c < ri; c += kThreads) {
    const float* fb = fwd + c;
    float acc[NL];
#pragma unroll
    for (int l = 0; l < NL; ++l) acc[l] = 0.f;
#pragma unroll 2
    for (int n = 0; n < B; ++n) {
      const float f = fb[n * ri];
#pragma unroll
      for (int l = 0; l < NL; ++l) acc[l] = fmaf(tt[l * B + n], f, acc[l]);
    }
    const SArr w = (c < K ? s.wr : s.wi) + (l0 * K + (c < K ? c : c - K));
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      if constexpr (kScaled) w[l * K] += mu * acc[l];
      else w[l * K] += acc[l];
    }
  }
}

// the factored gradient constraint of both filters: head, then tail
template <bool kScaled, class S, class G>
__device__ __forceinline__ void constrain(const S& s, const G& q, const Stage1Bases& bs,
                                          float mu) {
  for_chunks(q.L, [&](auto nl, int l0) { head_chunk<decltype(nl)::value>(s, q, l0, bs.inv_head); });
  __syncthreads();
  for (int i = threadIdx.x; i < q.L * q.block; i += kThreads) s.t[i] += s.tpart[i];
  __syncthreads();
  for_chunks(q.L, [&](auto nl, int l0) {
    tail_chunk<decltype(nl)::value, kScaled>(s, q, l0, bs.fwd, mu);
  });
  __syncthreads();
}

// One PBFD-Kalman block update (equations: aec_tpu/linear/kalman.py:15-21).
// Before the call s.frame[B:] holds far block t and s.e mic block t; after it
// s.e holds the echo-cancelled block t. With kAnalysis false the caller has
// already written block t's far-frame spectrum into ring slot t % L (and
// synchronized) in place of step 1, and s.frame is unused.
template <bool kAnalysis = true, class G>
__device__ __forceinline__ void kalman_block_step(const KalmanSmem& s, const G& q, int t,
                                  const KalmanParams& kp, const Stage1Bases& bs) {
  const int tid = threadIdx.x;
  const int B = q.block, K = q.bins, L = q.L;
  const int head = t % L;

  // 1. far-frame analysis of [prev || cur] into ring slot `head`
  if constexpr (kAnalysis) {
    far_analysis(s, q, head, bs);
    __syncthreads();
  }

  // 2. far ring shift; predict W- = aW, P- = a²P + (1-a²)|W|² + q_min
  if (kAnalysis)
    for (int j = tid; j < B; j += kThreads) s.frame[j] = s.frame[B + j];
  for (int i = tid; i < L * K; i += kThreads) {
    const float wr = s.wr[i], wi = s.wi[i];
    s.p[i] = kp.a2 * s.p[i] + kp.one_minus_a2 * (wr * wr + wi * wi) + kp.q_min;
    s.wr[i] = kp.a * wr;
    s.wi[i] = kp.a * wi;
  }
  __syncthreads();

  // 3. echo-estimate spectrum y = sum_l W-[l] X[l]
  for (int k = tid; k < K; k += kThreads) {
    float yr = 0.f, yi = 0.f;
    for (int l = 0; l < L; ++l) {
      const int xs = ring_slot(head, l, L) * K + k, ws = l * K + k;
      yr += s.wr[ws] * s.xr[xs] - s.wi[ws] * s.xi[xs];
      yi += s.wr[ws] * s.xi[xs] + s.wi[ws] * s.xr[xs];
    }
    s.y[k] = yr;
    s.y[K + k] = yi;
  }
  __syncthreads();

  // 4. e = d - irfft(y)[B:]; 5. residual spectrum E = rfft([0 || e])
  echo_subtract(s, q, bs);
  residual_analysis(s, q, bs);

  // 6. observation-noise psd, gain denominator, E / den
  for (int k = tid; k < K; k += kThreads) {
    const float er = s.er[k], ei = s.er[K + k];
    const float psi = fmaxf(kp.obs * s.psi[k] + kp.one_minus_obs * (er * er + ei * ei), kp.p_floor);
    s.psi[k] = psi;
    float den = 0.f;
    for (int l = 0; l < L; ++l) {
      const int xs = ring_slot(head, l, L) * K + k;
      den += (s.xr[xs] * s.xr[xs] + s.xi[xs] * s.xi[xs]) * s.p[l * K + k];
    }
    den += 2.f * psi;
    s.den[k] = den;
    s.er[k] = er / den;
    s.er[K + k] = ei / den;
  }
  __syncthreads();

  // 7. update G = P- conj(X) E / den; covariance P = max(P-(1 - P-|X|²/den), floor)
  for (int i = tid; i < L * K; i += kThreads) {
    const int l = i / K, k = i - l * K;
    const int xs = ring_slot(head, l, L) * K + k;
    const float xr = s.xr[xs], xi = s.xi[xs], pp = s.p[i];
    const float erd = s.er[k], eid = s.er[K + k];
    s.g[l * q.ri + k] = pp * (xr * erd + xi * eid);
    s.g[l * q.ri + K + k] = pp * (xr * eid - xi * erd);
    s.p[i] = fmaxf(pp * (1.f - pp * (xr * xr + xi * xi) / s.den[k]), kp.p_floor);
  }
  __syncthreads();

  // 8-9. constraint: t[l] = irfft(G[l])[:B]; W[l] = W-[l] + rfft([t[l] || 0])
  constrain<false>(s, q, bs, 1.f);
}

// One MDF block update (equations: aec_tpu/linear/nlms.py:20-22, 59-102).
// The same transforms as kalman_block_step; no predict step. Before the call
// s.frame[B:] holds far block t and s.e mic block t; after it s.e holds the
// echo-cancelled block t.
template <class G>
__device__ __forceinline__ void nlms_block_step(const NlmsSmem& s, const G& q, int t,
                                       const NlmsParams& np, const Stage1Bases& bs) {
  const int tid = threadIdx.x;
  const int B = q.block, K = q.bins, L = q.L;
  const int head = t % L;

  // 1. far-frame analysis of [prev || cur] into ring slot `head`
  far_analysis(s, q, head, bs);
  __syncthreads();

  // 2. far ring shift; smoothed far power; echo-estimate spectrum
  //    y = sum_l W[l] X[l]; the power's partial sums per warp for its mean
  for (int j = tid; j < B; j += kThreads) s.frame[j] = s.frame[B + j];
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
    s.y[k] = yr;
    s.y[K + k] = yi;
  }
  {  // every warp whole: lanes past the last bin add 0
    const float sum = warp_sum(pw);
    if (tid % 32 == 0) s.red[tid / 32] = sum;
  }
  __syncthreads();

  // 3. e = d - irfft(y)[B:]; 4. residual spectrum E = rfft([0 || e])
  echo_subtract(s, q, bs);
  residual_analysis(s, q, bs);

  // 5. residual psd; den = power + eps + eps_rel mean_k(power) + beta psi
  for (int k = tid; k < K; k += kThreads) {
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += s.red[w];
    const float er = s.er[k], ei = s.er[K + k];
    const float psi = np.es * s.psi[k] + np.one_minus_es * (er * er + ei * ei);
    s.psi[k] = psi;
    s.inv[k] = 1.f / (s.power[k] + np.eps + np.eps_rel * (total / K) + np.beta * psi);
  }
  __syncthreads();

  // 6. gradient conj(X[l]) E / den per partition
  for (int i = tid; i < L * K; i += kThreads) {
    const int l = i / K, k = i - l * K;
    const int xs = ring_slot(head, l, L) * K + k;
    const float xr = s.xr[xs], xi = s.xi[xs], er = s.er[k], ei = s.er[K + k];
    s.g[l * q.ri + k] = (xr * er + xi * ei) * s.inv[k];
    s.g[l * q.ri + K + k] = (xr * ei - xi * er) * s.inv[k];
  }
  __syncthreads();

  // 7-8. constraint: t[l] = irfft(G[l])[:B]; W[l] += mu rfft([t[l] || 0])
  constrain<true>(s, q, bs, np.mu);
}

// The stage-1 step of a two-stage kernel, by the type of its state.
template <class G>
__device__ __forceinline__ void stage1_block_step(const KalmanSmem& s, const G& q, int t,
                                                  const KalmanParams& kp, const Stage1Bases& bs) {
  kalman_block_step<true>(s, q, t, kp, bs);
}

template <class G>
__device__ __forceinline__ void stage1_block_step(const NlmsSmem& s, const G& q, int t,
                                                  const NlmsParams& np, const Stage1Bases& bs) {
  nlms_block_step(s, q, t, np, bs);
}

// ---------------------------------------------------------------- stage 2

struct Stage2Weights {
  const float* __restrict__ analysis;   // (2B, 2K) windowed analysis DFT
  const float* __restrict__ synthesis;  // (2K, 2B) windowed pinv synthesis
  const float* __restrict__ erb;        // (K, E)
  const float* __restrict__ erb_t;      // (E, K)
  // weights TRANSPOSED (in, out) so neighbouring threads (outputs) read
  // neighbouring addresses; GRU gates [r; z; n] along the out axis
  const float* __restrict__ w_ih_t;     // (2E, 3E)
  const float* __restrict__ w_hh_t;     // (E, 3E)
  const float* __restrict__ b_ih;       // (3E)
  const float* __restrict__ b_hh;       // (3E)
  const float* __restrict__ w1_t;       // (2E, E) on [h || mic_erb]
  const float* __restrict__ b1;         // (E)
  const float* __restrict__ w2_t;       // (E, E)
  const float* __restrict__ b2;         // (E)
  const float* __restrict__ inv_env;    // (B) inverse interior OLA envelope
  // the FFT frame's (stage2_fft.cuh): the window, erb's support
  const float* __restrict__ window;     // (2B)
  const int* __restrict__ sup;          // (2E + 2K), kernels/stage2.py erb_support
};

// What recurs from frame to frame.
struct Stage2State {
  SArr lin, far;  // (2B) [previous block || current block]
  SArr h;          // (E) GRU state
  SArr tail;       // (B) OLA tail
  template <class G>
  __host__ __device__ Stage2State(Carve& c, const G& q) {
    lin = c.take(q.frame); far = c.take(q.frame); h = c.take(q.bands); tail = c.take(q.block);
  }
};

// Work vectors of one frame. Dead between frames, except that the caller
// reads `mask` and `out` right after the step; so a kernel that also runs
// stage 1 may lay them over stage 1's per-step scratch (TwoStageSmem).
struct Stage2Scratch {
  SArr spec;       // (2 * 2K) lin spectrum, far spectrum; then the new OLA tail
  SArr mag;        // (2K) |lin|, |far|
  SArr part;       // (kSlices, 2E)
  SArr me, fe;    // (E)
  SArr xp, hp;    // (3E)
  SArr l1, mask;  // (E)
  SArr y;          // (2K) gain-weighted lin spectrum
  SArr out;        // (B)
  template <class G>
  __host__ __device__ Stage2Scratch(Carve& c, const G& q) {
    const int e = q.bands;
    spec = c.take(2 * q.ri); mag = c.take(2 * q.bins); part = c.take(kSlices * 2 * e);
    me = c.take(e); fe = c.take(e); xp = c.take(3 * e); hp = c.take(3 * e);
    l1 = c.take(e); mask = c.take(e); y = c.take(q.ri); out = c.take(q.block);
  }
};

__device__ __forceinline__ float sigmoid_f(float x) { return 1.f / (1.f + expf(-x)); }

template <class G>
__device__ __forceinline__ void stage2_init(const Stage2State& s, const G& q) {
  for (int i = threadIdx.x; i < q.frame; i += kThreads) { s.lin[i] = 0.f; s.far[i] = 0.f; }
  for (int i = threadIdx.x; i < q.block; i += kThreads) s.tail[i] = 0.f;
  for (int i = threadIdx.x; i < q.bands; i += kThreads) s.h[i] = 0.f;
  __syncthreads();
}

// One LittleNet frame (equations: aec_tpu/models/little_net.py and
// pipeline/streaming.py). Before the call s.lin[B:] / s.far[B:] hold the
// current blocks; after it x.mask holds this frame's mask and x.out the
// output block this frame completes (the previous one, by OLA).
// off_lin / off_far are subtracted from the whole analysis frames (the
// causal pseudo-norm scalars, bl_common.py:484-490); s.lin / s.far keep the
// raw blocks, so the next frame subtracts its own, newer scalars.
template <class G>
__device__ __forceinline__ void stage2_frame_step(const Stage2State& s, const Stage2Scratch& x,
                                                  const G& q, const Stage2Weights& w,
                                                  bool gain_norm,
                                         float off_lin = 0.f, float off_far = 0.f) {
  const int tid = threadIdx.x;
  const int B = q.block, K = q.bins, ri = q.ri, E = q.bands;

  // 1. windowed analysis DFT of both frames (one basis read for the two)
  for (int c = tid; c < ri; c += kThreads) {
    const float* b = w.analysis + c;
    float al = 0.f, af = 0.f;
#pragma unroll 8
    for (int n = 0; n < q.frame; ++n) {
      const float v = b[n * ri];
      al = fmaf(s.lin[n] - off_lin, v, al);
      af = fmaf(s.far[n] - off_far, v, af);
    }
    x.spec[c] = al;
    x.spec[ri + c] = af;
  }
  __syncthreads();

  // 2. frame shift; magnitudes with the in-sqrt 1e-9
  for (int j = tid; j < B; j += kThreads) {
    s.lin[j] = s.lin[B + j];
    s.far[j] = s.far[B + j];
  }
  for (int i = tid; i < 2 * K; i += kThreads) {
    const int which = i >= K, k = i - which * K;
    const float re = x.spec[which * ri + k], im = x.spec[which * ri + K + k];
    x.mag[i] = sqrtf(re * re + im * im + 1e-9f);
  }
  __syncthreads();

  // 3. ERB projection of both magnitudes, in kSlices bin slices
  for (int idx = tid; idx < kSlices * 2 * E; idx += kThreads) {
    const int o = idx % (2 * E), g = idx / (2 * E);
    const int which = o >= E, e = o - which * E;
    float acc = 0.f;
    for (int k = g; k < K; k += kSlices) acc = fmaf(x.mag[which * K + k], w.erb[k * E + e], acc);
    x.part[g * 2 * E + o] = acc;
  }
  __syncthreads();
  for (int o = tid; o < 2 * E; o += kThreads) {
    float acc = 0.f;
#pragma unroll
    for (int g = 0; g < kSlices; ++g) acc += x.part[g * 2 * E + o];
    if (o < E) x.me[o] = acc;
    else x.fe[o - E] = acc;
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
    const float z = sigmoid_f(x.xp[E + e] + x.hp[E + e]);
    const float n = tanhf(x.xp[2 * E + e] + r * x.hp[2 * E + e]);
    s.h[e] = (1.f - z) * n + z * s.h[e];
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

  // 8. back-projection gain (optionally over the unmasked one) on re and im
  for (int k = tid; k < K; k += kThreads) {
    float gsum = 0.f, norm = 0.f;
#pragma unroll 8
    for (int e = 0; e < E; ++e) {
      const float b = w.erb_t[e * K + k];
      gsum = fmaf(b, x.mask[e] * x.me[e], gsum);
      norm = fmaf(b, x.me[e], norm);
    }
    const float gain = gain_norm ? gsum / (norm + 1e-9f) : gsum;
    x.y[k] = gain * x.spec[k];
    x.y[K + k] = gain * x.spec[K + k];
  }
  __syncthreads();

  // 9. pinv synthesis (real and imaginary halves summed apart) + OLA; the
  //    new tail is parked in x.spec (dead after step 8) until every output
  //    sample has read the old one
  for (int m = tid; m < q.frame; m += kThreads) {
    const float* b = w.synthesis + m;
    float acc_r = 0.f, acc_i = 0.f;
#pragma unroll 8
    for (int c = 0; c < K; ++c) {
      acc_r = fmaf(x.y[c], b[c * q.frame], acc_r);
      acc_i = fmaf(x.y[K + c], b[(K + c) * q.frame], acc_i);
    }
    const float syn = acc_r + acc_i;
    if (m < B) x.out[m] = (s.tail[m] + syn) * w.inv_env[m] + 1e-9f;
    else x.spec[m - B] = syn;
  }
  __syncthreads();
  for (int j = tid; j < B; j += kThreads) s.tail[j] = x.spec[j];
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

// Both stages' state on one CTA for the dense hop (hop.cuh's TwoStageFftSmem
// is the FFT hop's); S1 is the stage-1 filter's state (KalmanSmem or
// NlmsSmem). Stage 2's per-frame scratch lies over stage 1's
// update buffer `g` where it fits (L * 2K floats; at the default geometry
// 5,140 against 3,148): g is dead once a stage-1 step has returned and is
// fully rewritten by the next one before it is read. That keeps the block at
// 107,392 B with Kalman (98,224 B with NLMS) at the default geometry, so two
// CTAs fit on an SM.
template <class S1>
struct TwoStageSmem {
  S1 s1;
  Stage2State s2;
  SArr nm;   // (kNmRows)
  SArr red;  // (kWarps, kMoments) per-warp partial block sums
  Stage2Scratch x;
  template <class G>
  __host__ __device__ TwoStageSmem(Carve& c, const G& q)
      : s1(c, q), s2(c, q), nm(c.take(kNmRows)), red(c.take(kWarps * kMoments)),
        x(scratch(c, q, s1.g)) {}

  template <class G>
  __host__ __device__ static Stage2Scratch scratch(Carve& c, const G& q, SArr g) {
    Carve over(g.off);
    const Stage2Scratch x(over, q);
    if (over.n - g.off <= size_t(q.L) * q.ri) return x;
    return Stage2Scratch(c, q);
  }
};

// streaming._norm_scalar, rounded step by step as torch rounds it
__device__ __forceinline__ float norm_scalar(float total, float sumsq, float count) {
  const float mean = __fdiv_rn(total, count);
  const float var = __fdiv_rn(__fsub_rn(sumsq, __fmul_rn(__fmul_rn(count, mean), mean)),
                              fmaxf(count - 1.f, 1.f));
  return __fdiv_rn(mean, __fsqrt_rn(fmaxf(var, 1e-12f)));
}

// The hand-off of a two-stage hop (pallas_serving.py:173-222,
// pallas_two_stage.py:97-122) after its stage-1 step: the stage-1 block e
// and the far block (the stage-1 frame's upper half) become stage 2's
// current blocks. With `moments` the block's sums fold into nm: the monitor
// rows always (mic2 the mic block's power, summed by each thread before the
// stage-1 step), the running moments only when `normalize`, whose current
// scalars are returned (off_lin, off_far) to offset stage 2's analysis
// frames; (0, 0) otherwise. Ends with a barrier.
template <class G>
__device__ __forceinline__ float2 hand_off(SArr e, SArr frame, const Stage2State& s2, SArr nm,
                                           SArr red, const G& q, float mic2, bool moments,
                                           bool normalize) {
  const int tid = threadIdx.x, B = q.block;
  for (int j = tid; j < B; j += kThreads) {
    s2.lin[B + j] = e[j];
    s2.far[B + j] = frame[B + j];
  }
  if (!moments) {
    __syncthreads();
    return make_float2(0.f, 0.f);
  }
  float v[kMoments] = {mic2, 0.f, 0.f, 0.f, 0.f};
  for (int j = tid; j < B; j += kThreads) {
    const float ej = e[j], f = frame[B + j];
    v[1] += ej; v[2] += ej * ej; v[3] += f; v[4] += f * f;
  }
#pragma unroll
  for (int m = 0; m < kMoments; ++m) {  // every warp whole: idle lanes add 0
    const float sum = warp_sum(v[m]);
    if (tid % 32 == 0) red[(tid / 32) * kMoments + m] = sum;
  }
  __syncthreads();
  if (tid == 0) {
    float sum[kMoments] = {};
    for (int g = 0; g < kWarps; ++g)
#pragma unroll
      for (int m = 0; m < kMoments; ++m) sum[m] += red[g * kMoments + m];
    nm[5] = kMonitorKeep * nm[5] + kMonitorRate * (sum[0] / B);
    nm[6] = kMonitorKeep * nm[6] + kMonitorRate * (sum[2] / B);
    if (normalize) {
      nm[0] += static_cast<float>(B);
#pragma unroll
      for (int m = 1; m < kMoments; ++m) nm[m] += sum[m];
    }
  }
  __syncthreads();
  if (!normalize) return make_float2(0.f, 0.f);
  return make_float2(norm_scalar(nm[1], nm[2], nm[0]), norm_scalar(nm[3], nm[4], nm[0]));
}

// the power of mic block e summed over this thread's samples
template <class G>
__device__ __forceinline__ float block_power(SArr e, const G& q) {
  float mic2 = 0.f;
  for (int j = threadIdx.x; j < q.block; j += kThreads) mic2 += e[j] * e[j];
  return mic2;
}

// One two-stage hop on one CTA's state with the dense steps: the stage-1
// block update (Kalman or NLMS, by the state's type; P its parameters), the
// hand-off, then the LittleNet frame. Before the call s1.frame[B:] holds far
// block t and s1.e mic block t; after it s1.e holds the stage-1 block, x.out
// the enhanced block t - 1 and x.mask this frame's mask. `moments`,
// `normalize` as hand_off's. hop.cuh's two_stage_block_step_fft is the same
// hop on FFTs.
template <class S1, class P, class G>
__device__ __forceinline__ void two_stage_block_step(const TwoStageSmem<S1>& s, const G& q, int t,
                                     const P& kp, const Stage1Bases& bs, const Stage2Weights& w,
                                     bool gain_norm, bool moments, bool normalize) {
  const float mic2 = block_power(s.s1.e, q);  // s1.e becomes the residual
  stage1_block_step(s.s1, q, t, kp, bs);
  const float2 off = hand_off(s.s1.e, s.s1.frame, s.s2, s.nm, s.red, q, mic2, moments, normalize);
  stage2_frame_step(s.s2, s.x, q, w, gain_norm, off.x, off.y);
}

// ---------------------------------------------------------------- launches

// bytes of the shared-memory layout S at geometry q
template <class S, class G>
size_t smem_bytes(const G& q) {
  Carve c;
  const S s(c, q);
  (void)s;
  return c.bytes();
}

// Raises the kernel's dynamic shared memory to `bytes`, or returns
// cudaErrorInvalidConfiguration when one CTA of the card cannot hold it.
inline cudaError_t set_smem(const void* kernel, size_t bytes, int device) {
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  if (bytes > static_cast<size_t>(optin)) return cudaErrorInvalidConfiguration;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace aec

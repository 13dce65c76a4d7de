// Kernel K2: batched LittleNet stage-2 inference, as passes over all frames.
//
// Replaces aec_tpu/kernels/pallas_stage2.py:100 little_net_apply_fused
// (pallas_call at :164), the batch-in-lanes TPU kernel of the stage-2 route
// (per-frame math: aec_tpu/kernels/bl_common.py:452 stage2_frame_step).
//
// Design. Of a LittleNet frame only the GRU state h recurs; the OLA tail is
// the previous frame's synthesis. So the frames run in three phases, and
// only the middle one is serial in time (A and C sum over the ERB matrix's
// nonzero ranges, which the host finds once per matrix):
//   A. "analyse" (this file): CTAs parallel over (utterance, run of frames).
//      For each frame f in [0, Tb] of its run a CTA windows the frames
//      [block f-1 || block f] of lin and far (zero blocks past both edges),
//      takes their real FFTs, the magnitudes (in-sqrt 1e-9), the ERB
//      projections me, fe, and the GRU input projection
//      xp = [me || |me - fe|] W_ih^T + b_ih + [b_hr; b_hz; 0]. Out: me and xp.
//   B. "recur": the GRU over the Tb + 1 frames from h = 0 on K8 (gru.cu,
//      launched by the wrapper, kernels/stage2.py). Out: h of every frame.
//   C. "synthesise" (this file): CTAs parallel over (utterance, run). Per
//      frame lin1 + relu on [h || me], lin2 + sigmoid (the mask, written
//      out), the ERB back-projection gain (over the unmasked one with
//      gain_norm), y = gain * spec_lin (the lin spectrum recomputed by the
//      same forward FFT as in A), the inverse real FFT times the synthesis
//      window, and the OLA: out block f-1 = (tail of syn_{f-1} + head of
//      syn_f) * inv_env + 1e-9. A run that starts at frame f0 > 0 also
//      synthesises frame f0 - 1 for its tail (the seam), so no CTA waits on
//      another.
// Bookkeeping as the TPU kernel: one trailing zero flush block, frame f's
// output completes block f - 1 (frame 0 writes nothing), the mask has Tb + 1
// frames. The window-synthesis pair is window = FFT = 2 hop, so the pinv
// synthesis basis is exactly window * irfft (the inverse drops the imaginary
// parts of bins 0 and K - 1, as the basis does).
//
// Transforms. Real FFTs of length 2 hop on fft.cuh (hop = 2^a 3^b 5^c; the
// plan and twiddles of kernels/fft_plan.py, 8, 8, 4 compiled in at the
// default geometry): the run's frames are the side-by-side transforms of one
// set of passes, read from device memory and windowed by the first pass's
// loader. Any other hop (e.g. 224 = 2^5 7) runs the same phases with dense
// transforms over the windowed analysis and pinv synthesis bases
// (kernels/consts.py stage2_consts), each basis element read once per run.
//
// What bounds it. Per frame ~2 forward and 1 inverse FFTs of 2 hop points
// (~34 k flops at hop 256) and ~28 k flops of small products (ERB and gain
// over the filterbank's support, xp 6E^2, GRU 3E^2, lin1/lin2 3E^2): ~65 k
// flops, against 1.65 M for the dense transforms. Phases A and C are bound by
// their CTAs' latency: each runs a few global loads, 3 FFT passes and a
// handful of barrier-separated loops. On an H100 at batch 256 x 8.2 s
// (kernels/phase_costs.py) A takes ~0.73 ms (FFTs ~0.31, projections
// ~0.26), K8 ~0.39, C ~0.69 (FFTs ~0.27, of which the recomputed forward
// ~0.06: storing the spectra in A instead would move >= 540 MB, >= 0.16 ms
// at the HBM rate), against a bound of ~0.13 ms. As a batch of one K8's 513
// serial steps are ~90 % of the device time.

#include "stage2_fft.cuh"

using namespace aec;

namespace {

// ---------------------------------------------------------------- A. analyse

struct AnalyseWeights {
  const float* __restrict__ erb;     // (K, E)
  const int* __restrict__ sup;       // erb's support (kernels/stage2.py)
  const float* __restrict__ w_ih_t;  // (2E, 3E)
  const float* __restrict__ b_ih;    // (3E)
  const float* __restrict__ b_hh;    // (3E): b_hr, b_hz folded into xp
};

// A run of `run` frames: 2 run transforms (lin, then far)
struct AnalyseSmem {
  SArr a, b;     // (2 run, 2K) work buffers
  SArr tw, win;  // (2B) each
  SArr feat;     // (2 run, E) me, then fe
  template <class G>
  __host__ __device__ AnalyseSmem(Carve& c, const G& q, int run) {
    const size_t L = 2 * size_t(run);
    a = c.take(L * q.ri); b = c.take(L * q.ri);
    tw = c.take(q.frame); win = c.take(q.frame);
    feat = c.take(L * q.bands);
  }
};

template <class G, class Tr>
__global__ void __launch_bounds__(kThreads, 3)
analyse_kernel(const float* __restrict__ lin, const float* __restrict__ far,
               float* __restrict__ me_out, float* __restrict__ xp_out, int t_blocks, int run,
               G q, Tr tr, AnalyseWeights w) {
  Carve c;
  const AnalyseSmem s(c, q, run);
  const int tid = threadIdx.x, B = q.block, K = q.bins, E = q.bands;
  const int frames = t_blocks + 1, runs = (frames + run - 1) / run;
  const int u = blockIdx.x / runs, f0 = (blockIdx.x - u * runs) * run;
  const int n = min(run, frames - f0), L = 2 * n;
  const size_t sig = static_cast<size_t>(u) * t_blocks * B;

  tr.init(q, s.tw, s.win);
  __syncthreads();
  const SArr z = tr.forward(q, L, FrameAt{lin + sig, far + sig, f0, n, B, t_blocks * B}, s.a, s.b,
                            s.tw, s.win);

  // magnitudes with the in-sqrt 1e-9, into the free buffer
  const SArr mag = z.off == s.a.off ? s.b : s.a;
  for (int i = tid; i < L * K; i += kThreads) {
    const int l = i / K, k = i - l * K;
    const float2 x = tr.bin(q, z, l, k, s.tw);
    mag[i] = sqrtf(x.x * x.x + x.y * x.y + 1e-9f);
  }
  __syncthreads();

  // ERB projections me (l < n) and fe (l >= n) over each band's support;
  // the transforms run fastest along a warp, so its lanes share a band's
  // loop length
  for (int o = tid; o < L * E; o += kThreads) {
    const int e = o / L, l = o - e * L, hi = w.sup[E + e];
    float acc = 0.f;
    for (int k = w.sup[e]; k < hi; ++k) acc = fmaf(mag[l * K + k], w.erb[k * E + e], acc);
    s.feat[l * E + e] = acc;
  }
  __syncthreads();

  // me out; the GRU input [me || |me - fe|] in place of fe
  const size_t row0 = static_cast<size_t>(u) * frames + f0;
  for (int o = tid; o < n * E; o += kThreads) {
    const float me = s.feat[o];
    me_out[row0 * E + o] = me;
    s.feat[n * E + o] = fabsf(me - s.feat[n * E + o]);
  }
  __syncthreads();

  // its projection, kFrames frames a thread so each weight is read once for them
  constexpr int kFrames = 2;
  const int G3 = 3 * E;
  for (int o = tid; o < (n + kFrames - 1) / kFrames * G3; o += kThreads) {
    const int fb = o / G3 * kFrames, j = o - fb / kFrames * G3;
    float acc[kFrames] = {};
    for (int half = 0; half < 2; ++half) {
      const SArr x = s.feat + half * n * E;
      for (int i = 0; i < E; ++i) {
        const float wv = w.w_ih_t[(half * E + i) * G3 + j];
#pragma unroll
        for (int v = 0; v < kFrames; ++v) acc[v] = fmaf(wv, x[min(fb + v, n - 1) * E + i], acc[v]);
      }
    }
    const float bias = w.b_ih[j] + (j < 2 * E ? w.b_hh[j] : 0.f);
#pragma unroll
    for (int v = 0; v < kFrames; ++v)
      if (fb + v < n) xp_out[(row0 + fb + v) * G3 + j] = acc[v] + bias;
  }
}

// ---------------------------------------------------------------- C. synthesise

struct SynthWeights {
  const int* __restrict__ sup;        // erb's support (kernels/stage2.py)
  const float* __restrict__ erb_t;    // (E, K)
  const float* __restrict__ w1_t;     // (2E, E) on [h || me]
  const float* __restrict__ b1;       // (E)
  const float* __restrict__ w2_t;     // (E, E)
  const float* __restrict__ b2;       // (E)
  const float* __restrict__ inv_env;  // (B) inverse interior OLA envelope
};

// A run of `run` frames and the frame before it: run + 1 transforms
struct SynthSmem {
  SArr a, b;               // (run + 1, 2K) work buffers
  SArr tw, win;            // (2B) each
  SArr h, me, l1, mask;  // (run + 1, E) each
  template <class G>
  __host__ __device__ SynthSmem(Carve& c, const G& q, int run) {
    const size_t L = size_t(run) + 1, le = L * q.bands;
    a = c.take(L * q.ri); b = c.take(L * q.ri);
    tw = c.take(q.frame); win = c.take(q.frame);
    h = c.take(le); me = c.take(le); l1 = c.take(le); mask = c.take(le);
  }
};

template <class G, class Tr>
__global__ void __launch_bounds__(kThreads)
synthesise_kernel(const float* __restrict__ lin, const float* __restrict__ hs,
                  const float* __restrict__ me_in, float* __restrict__ out,
                  float* __restrict__ mask_out, int t_blocks, int run, G q, Tr tr,
                  SynthWeights w, int gain_norm) {
  Carve c;
  const SynthSmem s(c, q, run);
  const int tid = threadIdx.x, B = q.block, K = q.bins, E = q.bands;
  const int frames = t_blocks + 1, runs = (frames + run - 1) / run;
  const int u = blockIdx.x / runs, f0 = (blockIdx.x - u * runs) * run;
  const int f1 = min(f0 + run, frames), g0 = max(f0 - 1, 0), n = f1 - g0;  // frames g0 .. f1 - 1
  const size_t sig = static_cast<size_t>(u) * t_blocks * B;
  const size_t row0 = static_cast<size_t>(u) * frames + g0;

  tr.init(q, s.tw, s.win);
  for (int o = tid; o < n * E; o += kThreads) {
    s.h[o] = hs[row0 * E + o];
    s.me[o] = me_in[row0 * E + o];
  }
  __syncthreads();
  const SArr z = tr.forward(q, n, FrameAt{lin + sig, lin + sig, g0, n, B, t_blocks * B}, s.a, s.b,
                            s.tw, s.win);

  // lin1 + relu on [h || me]; lin2 + sigmoid: the mask
  for (int o = tid; o < n * E; o += kThreads) {
    const int f = o / E, e = o - f * E;
    float acc = 0.f;
    for (int i = 0; i < E; ++i) acc = fmaf(w.w1_t[i * E + e], s.h[f * E + i], acc);
    for (int i = 0; i < E; ++i) acc = fmaf(w.w1_t[(E + i) * E + e], s.me[f * E + i], acc);
    s.l1[o] = fmaxf(acc + w.b1[e], 0.f);
  }
  __syncthreads();
  for (int o = tid; o < n * E; o += kThreads) {
    const int f = o / E, e = o - f * E;
    float acc = 0.f;
    for (int i = 0; i < E; ++i) acc = fmaf(w.w2_t[i * E + e], s.l1[f * E + i], acc);
    const float m = sigmoid_f(acc + w.b2[e]);
    s.mask[o] = m;
    if (g0 + f >= f0) mask_out[row0 * E + o] = m;  // the seam frame is its own run's
  }
  __syncthreads();

  // back-projection gain (optionally over the unmasked one); y = gain * spec_lin
  const SArr y = z.off == s.a.off ? s.b : s.a;
  for (int i = tid; i < n * K; i += kThreads) {
    const int l = i / K, k = i - l * K;
    float gsum = 0.f, norm = 0.f;
    const int hi = w.sup[2 * E + K + k];
    for (int e = w.sup[2 * E + k]; e < hi; ++e) {
      const float bk = w.erb_t[e * K + k], me = s.me[l * E + e];
      gsum = fmaf(bk, s.mask[l * E + e] * me, gsum);
      norm = fmaf(bk, me, norm);
    }
    const float gain = gain_norm ? gsum / (norm + 1e-9f) : gsum;
    const float2 x = tr.bin(q, z, l, k, s.tw);
    tr.put(q, y, l, k, make_float2(gain * x.x, gain * x.y));
  }
  __syncthreads();

  // synthesis; OLA of frames f - 1 and f into output block f - 1, f >= 1
  const SArr zs = tr.inverse(q, n, y, z, s.tw);
  const int first = max(f0, 1);
  for (int i = tid; i < (f1 - first) * B; i += kThreads) {
    const int f = first + i / B, j = i % B, l = f - g0;
    const float v = (tr.syn(q, zs, l - 1, B + j, s.win) + tr.syn(q, zs, l, j, s.win)) * w.inv_env[j];
    out[sig + static_cast<size_t>(f - 1) * B + j] = v + 1e-9f;
  }
}

// ---------------------------------------------------------------- launches

template <class S, class G>
size_t run_smem(const G& q, int run) {
  Carve c;
  const S s(c, q, run);
  (void)s;
  return c.bytes();
}

// Sizes a run's shared memory for `kernel`, then go(ctas, smem) launches it:
// one CTA per (utterance, run of `run` frames).
template <class S, class G, class Go>
cudaError_t launch(const void* kernel, const G& q, int batch, int t_blocks, int run, int device,
                   Go&& go) {
  const size_t smem = run_smem<S>(q, run);
  cudaError_t err = set_smem(kernel, smem, device);
  if (err != cudaSuccess || batch == 0) return err;
  const long long ctas = static_cast<long long>(batch) * ((t_blocks + run) / run);
  if (ctas > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  go(static_cast<unsigned>(ctas), smem);
  return cudaGetLastError();
}

// f(q, transforms): the FFT transforms on the host's plan (n_pass > 0; the
// default geometry on the compiled plan) or the dense ones (n_pass == 0)
template <class F>
cudaError_t with_transforms(int hop, int bands, int run, const float* tw, const float* window,
                            const int* radix, int n_pass, const float* analysis,
                            const float* synthesis, int device, F&& f) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (run < 1 || run > kMaxRun) return cudaErrorInvalidValue;
  if (n_pass == 0) return f(make_geom(hop, 1, bands), DenseTr{analysis, synthesis});
  RunPlan plan{};
  err = read_plan(radix, n_pass, hop, plan);
  if (err != cudaSuccess) return err;
  return with_geom(hop, -1, bands, [&](auto q) -> cudaError_t {
    if constexpr (std::is_same_v<decltype(q), DefaultGeom>) {
      if (!is_default_plan(plan)) return cudaErrorInvalidValue;
      return f(q, FftTr<DefaultPlan>{{}, tw, window});
    } else {
      return f(q, FftTr<RunPlan>{plan, tw, window});
    }
  });
}

}  // namespace

// shared memory of one CTA of phase A (synthesise 0) or C (1) at this
// geometry and run of frames, bytes
extern "C" long long aec_stage2_smem(int hop, int bands, int run, int synthesise) {
  const Geom q = make_geom(hop, 1, bands);
  return static_cast<long long>(synthesise ? run_smem<SynthSmem>(q, run)
                                           : run_smem<AnalyseSmem>(q, run));
}

// Phase A. lin, far (batch, t_blocks, hop); me (batch, t_blocks + 1, E), xp
// (batch, t_blocks + 1, 3E) out. tw (hop, 2) and radix[n_pass] from
// kernels/fft_plan.py, or n_pass = 0 for the dense transforms on `analysis`.
extern "C" int aec_stage2_analyse(const float* lin, const float* far, float* me, float* xp,
                                  int batch, int t_blocks, int hop, int bands, int run,
                                  const float* tw, const float* window, const int* radix,
                                  int n_pass, const float* analysis, const float* erb, const int* sup,
                                  const float* w_ih_t, const float* b_ih, const float* b_hh,
                                  int device, void* stream) {
  const AnalyseWeights w{erb, sup, w_ih_t, b_ih, b_hh};
  const auto st = static_cast<cudaStream_t>(stream);
  return with_transforms(hop, bands, run, tw, window, radix, n_pass, analysis, nullptr, device,
                         [&](auto q, auto tr) {
    const auto kernel = analyse_kernel<decltype(q), decltype(tr)>;
    return launch<AnalyseSmem>(reinterpret_cast<const void*>(kernel), q, batch, t_blocks, run,
                               device, [&](unsigned ctas, size_t smem) {
      kernel<<<ctas, kThreads, smem, st>>>(lin, far, me, xp, t_blocks, run, q, tr, w);
    });
  });
}

// Phase C. lin (batch, t_blocks, hop) as phase A's; hs (batch, t_blocks + 1,
// E) the GRU states of phase B; me phase A's; out (batch, t_blocks, hop) and
// mask (batch, t_blocks + 1, E) out. Transforms as phase A's (the dense ones
// on `analysis` and `synthesis`).
extern "C" int aec_stage2_synthesise(const float* lin, const float* hs, const float* me,
                                     float* out, float* mask, int batch, int t_blocks, int hop,
                                     int bands, int run, const float* tw, const float* window,
                                     const int* radix, int n_pass, const float* analysis,
                                     const float* synthesis, const int* sup, const float* erb_t,
                                     const float* w1_t, const float* b1, const float* w2_t,
                                     const float* b2, const float* inv_env, int gain_norm,
                                     int device, void* stream) {
  const SynthWeights w{sup, erb_t, w1_t, b1, w2_t, b2, inv_env};
  const auto st = static_cast<cudaStream_t>(stream);
  return with_transforms(hop, bands, run, tw, window, radix, n_pass, analysis, synthesis, device,
                         [&](auto q, auto tr) {
    const auto kernel = synthesise_kernel<decltype(q), decltype(tr)>;
    return launch<SynthSmem>(reinterpret_cast<const void*>(kernel), q, batch, t_blocks, run,
                             device, [&](unsigned ctas, size_t smem) {
      kernel<<<ctas, kThreads, smem, st>>>(lin, hs, me, out, mask, t_blocks, run, q, tr, w,
                                           gain_norm);
    });
  });
}

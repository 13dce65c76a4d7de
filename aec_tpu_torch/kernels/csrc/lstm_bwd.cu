// Kernel K9b: the LSTM recurrence's backward on the gates its forward
// saved, one persistent grid, W_hh held on chip across the reverse loop.
//
// Replaces the backwards of aec_tpu/kernels/pallas_lstm.py's custom VJP
// complex_lstm_scan_fused (_bwd at :341-350) and of
// aec_tpu/kernels/pallas_fullsubnet.py's fsn_joint_fused (_bwd at
// :199-217): both recompute through the scan and take jax.vjp of it, which
// XLA compiles into one loop on the device. Here that loop is this kernel,
// fed by the gates K9 (lstm.cu) and K11 (fullsubnet.cu) save with SAVE.
// Per reverse step t = T - 1, ..., 0 of each row, from zero carries:
//   dh = carry_h + g_ys(t);  dc = carry_c + dh o (1 - tanh^2 c)
//   do^ = dh tanh(c) o (1 - o);  di^ = dc g i (1 - i);  dg^ = dc i (1 - g^2);
//   df^ = dc c(t - 1) f (1 - f);  carry_c = dc f;
//   carry_h = W_hh^T [di^, df^, dg^, do^],
// and dxp(t) = [di^, df^, dg^, do^], the gradient of the step's
// pre-activations. The weight gradients are products over all rows and steps
// outside (kernels/lstm.py, kernels/fullsubnet.py), as K8b's are.
//
// Layout. G groups, each with its W_hh (4H, H), each over B x F rows: B
// sequences of T steps, F rows a step (DCCRN: G = 2 parameter groups, B = 2
// x batch, F = 1; FullSubNet's sub band: G = 1, B = batch, F = 161 bins; its
// full band F = 1). Row r = b F + f of group g at step t is row vector
// ((g B + b) T + t) F + f of g_ys (H floats), saved (5H: i, f, g, o, c) and
// dxp (4H), so the sub band's (B, T, F) tensors go in without a transpose.
//
// Design. The product of a step is K9's transposed: each unit k's carry_h
// is a dot of length 4H, the row's dxp(t + 1) against column k of W_hh. A
// CTA owns a run of a group's rows and a chunk of U units, and holds those
// units' columns of W_hh (4H x U) on chip for the whole loop: each warp sums
// CW columns (a power of two) over one of KS k-slices of the 4H (warps w and
// w + 16 / KS share columns), lane l holding quads l, l + 32, ... (npos
// positions) of its slice; the first kRegQuads in registers, then shared
// memory, the rest read from L2 each pass. A step stages `stage` rows of
// dxp(t + 1) at a time in shared memory (past L1: other CTAs wrote them),
// RT of them a sweep; each lane sums in k order with FMAs, the warp's lanes
// reduce by shuffles as in K9 (lstm_common.cuh), and the KS slices' sums
// meet in shared memory, added in slice order by the thread that steps the
// cell. Two plans (kernels/lstm_bwd.py backward_plan):
//   (a) every unit in one CTA (nchunk = 1) and the rows split into runs,
//       where all of W_hh^T fits on chip (FullSubNet's sub band, H = 96:
//       4 x 96 x 96 floats, 147 KB): the CTAs never wait on each other;
//   (b) the units split over a group's CTAs (runs = 1), as K9 splits them
//       (DCCRN's H = 1024, FullSubNet's full band at H = 256): dxp(t) is the
//       exchange, and one counter a group orders it: each CTA adds one
//       after its step's dxp (fence, then atomic add), and the group's CTAs
//       read dxp(t) once the counter says all have. The grid is launched
//       cooperatively, so all of a group's CTAs are resident.
//
// What bounds it. 4H H FMAs a row-step and ~11 H floats a row-step through
// device memory (g_ys, saved, c(t - 1) in; dxp out and read back). At
// DCCRN's training shape (G = 2, R = 32, T = 501, H = 1024) that is 134.5 G
// FMA, 4.0 ms a layer at the fp32 peak; a step of plan (b) is bound by the
// FMAs of the 2 x 64 CTAs (2.1 M each, ~10 us) and the shared memory's
// bandwidth (W's shared half read once a sweep). FullSubNet's sub band (R
// = 16 x 161, H = 96, T = 801) is bound by its bytes: 8.7 GB of saved gates,
// g_ys and dxp, ~2.6 ms. PERF.md has the measured times.

#include <cuda_runtime.h>

#include "lstm_common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRegQuads = 16;  // float4 quads of W a thread holds in registers
constexpr long long kSpinLimit = 1ll << 24;  // ~10 s of polls of a counter: a lost CTA traps

struct BwdArgs {
  const float* __restrict__ g_ys;   // (G, B, T, F, H)
  const float* __restrict__ saved;  // (G, B, T, F, 5H): i, f, g, o, c of each step
  const float4* __restrict__ wp;    // (G nchunk, npos CW, kThreads): the quads of each thread
  unsigned* counters;               // (G runs), zero: a group's CTAs' steps done
  float* dxp;                       // (G, B, T, F, 4H)
  int b, t_steps, f, hidden, runs, run_rows, units, nchunk, ks, npos, jreg, jsm, stage;
};

// shared memory of one CTA (floats): W's shared quads, the staged rows of
// dxp(t + 1), the k-slices' sums (KS, run_rows, columns), carry_c (run_rows, U)
struct BwdSmem {
  size_t ws, dg, pre, cs, total;
};

__host__ __device__ inline BwdSmem bwd_smem(int hidden, int run_rows, int units, int cw, int ks,
                                            int jsm, int stage) {
  BwdSmem s;
  s.ws = 0;
  s.dg = s.ws + size_t(jsm) * cw * kThreads * 4;
  s.pre = s.dg + size_t(stage) * 4 * hidden;
  s.cs = s.pre + size_t(ks) * run_rows * (kWarps / ks) * cw;
  s.total = s.cs + size_t(run_rows) * units;
  return s;
}

// CW columns a warp (a power of two), RT rows a sweep (CW RT <= 32)
template <int CW, int RT>
__global__ void __launch_bounds__(kThreads, 1) lstm_bwd_kernel(BwdArgs a) {
  extern __shared__ float4 smem_raw[];
  constexpr int JR = kRegQuads / CW;  // positions a lane can hold in registers
  constexpr int V = CW * RT;
  constexpr int M = V >= 32 ? 5 : V >= 16 ? 4 : V >= 8 ? 3 : V >= 4 ? 2 : V >= 2 ? 1 : 0;
  const int H = a.hidden, U = a.units, T = a.t_steps, B = a.b, F = a.f, R = B * F;
  const int ks = a.ks, wc = kWarps / ks, cols = wc * CW, rr = a.run_rows;
  const int npos = a.npos, jreg = a.jreg, jsm = a.jsm;
  const int chunk = blockIdx.x % a.nchunk, grp = blockIdx.x / a.nchunk;
  const int g = grp / a.runs, r_lo = (grp % a.runs) * rr, nr = min(rr, R - r_lo);
  const int u0 = chunk * U, nu = min(U, H - u0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int slice = warp / wc, cg = warp % wc, kb = slice * 32 * npos;  // the slice's first quad
  const BwdSmem lay = bwd_smem(H, rr, U, CW, ks, jsm, a.stage);
  float* base = reinterpret_cast<float*>(smem_raw);
  float4* ws = reinterpret_cast<float4*>(base + lay.ws);
  float4* dg4 = reinterpret_cast<float4*>(base + lay.dg);
  float* pre = base + lay.pre;
  float* cs = base + lay.cs;
  const float4* w = a.wp + (size_t(g) * a.nchunk + chunk) * npos * CW * kThreads + tid;
  unsigned* counter = a.counters + grp;
  const bool counted = a.nchunk > 1;
  // row vector of (row r of the group, step t)
  auto vec = [&](int r, int t) {
    const int bb = r / F;
    return ((size_t(g) * B + bb) * T + t) * F + (r - bb * F);
  };

  // once: W's quads on chip, carry_c zero
  float4 wr[JR > 0 ? JR : 1][CW];
#pragma unroll
  for (int j = 0; j < JR; ++j)
#pragma unroll
    for (int i = 0; i < CW; ++i)
      wr[j][i] = j < jreg ? w[size_t(j * CW + i) * kThreads] : float4{};
  for (int q = 0; q < jsm * CW; ++q) ws[q * kThreads + tid] = w[size_t(jreg * CW + q) * kThreads];
  for (int i = tid; i < rr * U; i += kThreads) cs[i] = 0.f;
  __syncthreads();

  for (int s = 0; s < T; ++s) {
    const int t = T - 1 - s;
    // this thread's first cell's inputs, which do not wait for dxp(t + 1):
    // g_ys, i, f, g, o, c of step t and c of step t - 1
    float x0[7] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (tid < nr * nu) {
      const int r = tid / nu, j = tid - r * nu;
      const size_t v = vec(r_lo + r, t);
      x0[0] = a.g_ys[v * H + u0 + j];
#pragma unroll
      for (int k = 0; k < 5; ++k) x0[1 + k] = a.saved[v * 5 * H + k * H + u0 + j];
      x0[6] = t > 0 ? a.saved[(v - F) * 5 * H + 4 * H + u0 + j] : 0.f;
    }
    if (s > 0) {
      if (counted) {
        if (tid == 0) {
          for (long long spins = 0; load_acquire(counter) < unsigned(a.nchunk) * s;)
            if (++spins > kSpinLimit) __trap();
        }
        __syncthreads();
      }
      for (int s0 = 0; s0 < nr; s0 += a.stage) {
        const int ns = min(a.stage, nr - s0);
        for (int i = tid; i < ns * H; i += kThreads) {
          const int r = i / H, k4 = i - r * H;
          const float* row = a.dxp + vec(r_lo + s0 + r, t + 1) * 4 * H;
          dg4[i] = __ldcg(reinterpret_cast<const float4*>(row) + k4);
        }
        __syncthreads();
        // lane l sums its columns over quads kb + l, kb + l + 32, ... of the
        // rows (registers, shared memory, L2), RT rows a sweep; the warp sums
        // over its lanes
        for (int r0 = 0; r0 < ns; r0 += RT) {
          float acc[V];
#pragma unroll
          for (int i = 0; i < V; ++i) acc[i] = 0.f;
#pragma unroll
          for (int j = 0; j < JR; ++j)
            if (j < jreg && kb + lane + 32 * j < H)
              fma_pos<CW, RT>(wr[j], dg4, H, r0, ns, kb + lane + 32 * j, acc);
          for (int j = jreg; j < jreg + jsm && kb + lane + 32 * j < H; ++j) {
            float4 wv[CW];
#pragma unroll
            for (int i = 0; i < CW; ++i) wv[i] = ws[((j - jreg) * CW + i) * kThreads + tid];
            fma_pos<CW, RT>(wv, dg4, H, r0, ns, kb + lane + 32 * j, acc);
          }
          for (int j = jreg + jsm; j < npos && kb + lane + 32 * j < H; ++j) {
            float4 wv[CW];
#pragma unroll
            for (int i = 0; i < CW; ++i) wv[i] = __ldg(w + size_t(j * CW + i) * kThreads);
            fma_pos<CW, RT>(wv, dg4, H, r0, ns, kb + lane + 32 * j, acc);
          }
          Scatter<V, 16>::run(acc, lane);
          const int idx = lane >> (5 - M), i = idx / RT, r = idx - i * RT;
          if ((lane & ((1 << (5 - M)) - 1)) == 0 && r0 + r < ns)
            pre[(size_t(slice) * rr + s0 + r0 + r) * cols + cg * CW + i] = acc[0];
        }
        __syncthreads();
      }
    }

    // the cells of the own (row, unit) pairs, backwards: dxp(t) out
    for (int i = tid; i < nr * nu; i += kThreads) {
      const int r = i / nu, j = i - r * nu;
      const size_t v = vec(r_lo + r, t);
      float x[7];
      if (i == tid) {
#pragma unroll
        for (int k = 0; k < 7; ++k) x[k] = x0[k];
      } else {
        x[0] = a.g_ys[v * H + u0 + j];
#pragma unroll
        for (int k = 0; k < 5; ++k) x[1 + k] = a.saved[v * 5 * H + k * H + u0 + j];
        x[6] = t > 0 ? a.saved[(v - F) * 5 * H + 4 * H + u0 + j] : 0.f;
      }
      float ch = 0.f;
      if (s > 0) {
        ch = pre[size_t(r) * cols + j];
        for (int q = 1; q < ks; ++q) ch += pre[(size_t(q) * rr + r) * cols + j];
      }
      const float ig = x[1], fg = x[2], gg = x[3], og = x[4], tc = tanhf(x[5]);
      const float dh = ch + x[0];
      const float dc = cs[r * U + j] + dh * og * (1.f - tc * tc);
      float* out = a.dxp + v * 4 * H + u0 + j;
      out[0] = dc * gg * ig * (1.f - ig);
      out[H] = dc * x[6] * fg * (1.f - fg);
      out[2 * H] = dc * ig * (1.f - gg * gg);
      out[3 * H] = dh * tc * og * (1.f - og);
      cs[r * U + j] = dc * fg;
    }
    __syncthreads();  // dxp(t) written before this CTA (or, counted, the group) reads it
    if (counted && tid == 0) {
      __threadfence();  // the CTA's dxp(t) before its count
      atomicAdd(counter, 1u);
    }
  }
}

template <int CW, int RT>
cudaError_t bwd_launch(const BwdArgs& a, int ctas, size_t smem, int device, cudaStream_t stream) {
  auto kernel = lstm_bwd_kernel<CW, RT>;
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  if (smem > static_cast<size_t>(optin)) return cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if (ctas > per_sm * sms) return cudaErrorCooperativeLaunchTooLarge;
  BwdArgs args = a;
  void* params[] = {&args};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(ctas),
                                    dim3(kThreads), params, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// rows a sweep: the smallest power of two >= the staged rows, at most 8 and 32 / CW
template <int CW>
cudaError_t bwd_launch_cw(const BwdArgs& a, int ctas, size_t smem, int device,
                          cudaStream_t stream) {
  constexpr int cap = 32 / CW < 8 ? 32 / CW : 8;
  const int r = a.stage;
  if (r <= 1) return bwd_launch<CW, 1>(a, ctas, smem, device, stream);
  if (r <= 2 || cap < 4) return bwd_launch<CW, (cap < 2 ? cap : 2)>(a, ctas, smem, device, stream);
  if (r <= 4 || cap < 8) return bwd_launch<CW, (cap < 4 ? cap : 4)>(a, ctas, smem, device, stream);
  return bwd_launch<CW, cap>(a, ctas, smem, device, stream);
}

}  // namespace

// the float4 quads a thread holds in registers (the wrapper packs for it)
extern "C" int aec_lstm_bwd_reg_quads() { return kRegQuads; }

// g_ys (G, B, T, F, H), saved (G, B, T, F, 5H) fp32; wp (G nchunk, npos CW,
// 512) float4, W_hh's columns packed by kernels/lstm_bwd.py pack_backward;
// counters (G runs) zeroed; dxp (G, B, T, F, 4H). All contiguous; the plan
// (runs, run_rows, units, nchunk, cw, ks, npos, jreg, jsm, stage) from
// backward_plan.
extern "C" int aec_lstm_bwd(const float* g_ys, const float* saved, const void* wp,
                            void* counters, float* dxp, int groups, int b, int t_steps, int f,
                            int hidden, int runs, int run_rows, int units, int nchunk, int cw,
                            int ks, int npos, int jreg, int jsm, int stage, int device,
                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int rows = b * f;
  if (ks < 1 || kWarps % ks != 0 || (kWarps / ks) * cw < units || nchunk * units < hidden ||
      32 * ks * npos < hidden || runs * run_rows < rows || stage < 1 || stage > run_rows ||
      jreg > kRegQuads / cw || jreg + jsm > npos || (jreg < kRegQuads / cw && jreg < npos) ||
      (runs > 1 && nchunk > 1))
    return cudaErrorInvalidValue;
  if (t_steps == 0 || rows == 0) return cudaSuccess;
  const int ctas = groups * runs * nchunk;
  const size_t smem = bwd_smem(hidden, run_rows, units, cw, ks, jsm, stage).total * sizeof(float);
  const BwdArgs a{g_ys, saved, static_cast<const float4*>(wp), static_cast<unsigned*>(counters),
                  dxp, b, t_steps, f, hidden, runs, run_rows, units, nchunk, ks, npos, jreg,
                  jsm, stage};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cw) {
    case 1: return bwd_launch_cw<1>(a, ctas, smem, device, s);
    case 2: return bwd_launch_cw<2>(a, ctas, smem, device, s);
    case 4: return bwd_launch_cw<4>(a, ctas, smem, device, s);
    case 8: return bwd_launch_cw<8>(a, ctas, smem, device, s);
    case 16: return bwd_launch_cw<16>(a, ctas, smem, device, s);
    default: return cudaErrorInvalidValue;
  }
}

// Kernel K11: FullSubNet's joint full-band -> embedding -> sub-band LSTM
// recurrence on one persistent grid.
//
// Replaces aec_tpu/kernels/pallas_fullsubnet.py:106 _fsn_joint_fused_fwd
// (pallas_call at :154, body _kernel at :48-100). Per frame t, from zero
// state, for B utterances:
//   1. the full-band LSTM step (H_fb units; gates = xp_fb[t] + W_hh_fb h_fb);
//   2. the embedding relu(W_out h_fb(t) + b_out) over the F bins;
//   3. the sub-band LSTM step over the B F (utterance, bin) rows (H_sb units;
//      gates = xp_sb[t] + emb * w_col + W_hh_sb h_sb), h_sb(t) out.
// The hoisted input projections with both biases (xp_fb, xp_sb) and the mask
// head stay outside (kernels/fullsubnet.py), as in JAX.
//
// Design. The sub-band rows are independent of each other given the
// embedding, so they are split over one persistent cooperative grid (about
// one CTA per SM, each holding a few rows' h and c and the whole sub-band
// W_hh^T, 147 KB fp32 at H_sb = 96, in shared memory); the full-band units
// are split over the same CTAs (their 4 gate rows of W_hh_fb in shared
// memory). One grid barrier per frame: every CTA steps its full-band units
// from h_fb(t-1) in its shared memory and publishes h_fb(t) to a ping-pong
// buffer; after the barrier it reads the whole h_fb(t) (which is also the
// next frame's h_fb(t-1)), forms its rows' embedding and steps their
// sub-band LSTM. A CTA publishes h_fb(t+1) into the other buffer, and reuses
// this one only at frame t+2, after every CTA has passed the barrier of
// frame t+1 and so finished reading it. Everything is fp32 (JAX's TPU kernel
// rounds the dots' operands to bf16).
//
// What bounds it. Per frame at FullSubNetConfig() and B = 1: 0.26 M FMA
// full-band, 0.04 M embedding, 5.9 M sub-band, and 247 KB of xp_sb; over an
// 8.2 s utterance (820 frames) 5.1 G FMA and 203 MB, so the card's bound is
// the FMAs, ~0.15 ms at the fp32 peak. This design instead pays one grid
// barrier plus one frame's dependent chain (the full-band dot, a read of
// h_fb from L2, the embedding dot, a 96-long sub-band dot per thread, the
// cell) per frame, serial in time: a few microseconds a frame, a few ms per
// utterance.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 384;

struct FsnArgs {
  const float* __restrict__ xp_fb;  // (B, T, 4 Hf)
  const float* __restrict__ xp_sb;  // (B, T, F, 4 Hs)
  const float* __restrict__ w_fb;   // (4 Hf, Hf): W_hh of the full-band LSTM
  const float* __restrict__ w_out;  // (F, Hf)
  const float* __restrict__ b_out;  // (F)
  const float* __restrict__ w_col;  // (4 Hs): the embedding column of sub-band W_ih
  const float* __restrict__ w_sb_t; // (Hs, 4 Hs): W_hh^T of the sub-band LSTM
  float* hbuf;                      // (2, B, Hf) ping-pong of h_fb
  float* ys;                        // (B, T, F, Hs)
  int b, t_steps, f, hf, hs, rmax, umax;
};

struct FsnPlan {
  int ctas, rmax, umax;
  size_t smem;
};

__device__ __forceinline__ float sigmoid_f(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// shared floats of one CTA: W_hh_sb^T, its full-band gate rows, its rows of
// W_out, h_fb of every utterance, its units' c_fb, its rows' h_sb, c_sb and
// pre-activations, w_col, the embedding and b_out of its rows
__host__ __device__ inline size_t fsn_smem_floats(int b, int hf, int hs, int rmax, int umax) {
  return size_t(hs) * 4 * hs + size_t(4) * umax * hf + size_t(rmax) * hf + size_t(b) * hf +
         size_t(b) * umax + size_t(2) * rmax * hs + size_t(rmax) * 4 * hs + 4 * hs + 2 * rmax;
}

inline cudaError_t fsn_plan(int b, int f, int hf, int hs, int device, FsnPlan* p) {
  int sms = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int rows = b * f;
  p->ctas = rows < sms ? rows : sms;
  p->rmax = (rows + p->ctas - 1) / p->ctas;
  p->umax = (hf + p->ctas - 1) / p->ctas;
  p->smem = fsn_smem_floats(b, hf, hs, p->rmax, p->umax) * sizeof(float);
  return cudaSuccess;
}

template <int RT>
__global__ void __launch_bounds__(kThreads) fsn_kernel(FsnArgs a) {
  extern __shared__ float smem[];
  const int B = a.b, T = a.t_steps, F = a.f, Hf = a.hf, Hs = a.hs, G4 = 4 * Hs;
  const int nct = gridDim.x, cta = blockIdx.x, rows = B * F;
  const int r0 = int((long long)cta * rows / nct);
  const int nr = int((long long)(cta + 1) * rows / nct) - r0;
  const int u0 = cta * Hf / nct, nu = (cta + 1) * Hf / nct - u0;
  const int umax = a.umax, rmax = a.rmax;
  float* wsb = smem;                    // (Hs, 4 Hs)
  float* wfb = wsb + size_t(Hs) * G4;   // (4, umax, Hf)
  float* wout = wfb + size_t(4) * umax * Hf;  // (rmax, Hf)
  float* hfs = wout + size_t(rmax) * Hf;      // (B, Hf)
  float* cf = hfs + size_t(B) * Hf;           // (B, umax)
  float* hsb = cf + size_t(B) * umax;         // (rmax, Hs)
  float* csb = hsb + size_t(rmax) * Hs;       // (rmax, Hs)
  float* pre = csb + size_t(rmax) * Hs;       // (rmax, 4 Hs)
  float* wcol = pre + size_t(rmax) * G4;      // (4 Hs)
  float* emb = wcol + G4;                     // (rmax)
  float* bout = emb + rmax;                   // (rmax)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  cg::grid_group grid = cg::this_grid();

  // the CTA's weights, once; zero state
  for (int i = tid; i < Hs * G4; i += blockDim.x) wsb[i] = a.w_sb_t[i];
  for (int i = tid; i < 4 * nu * Hf; i += blockDim.x) {
    const int g = i / (nu * Hf), rem = i - g * nu * Hf, j = rem / Hf, k = rem - j * Hf;
    wfb[(g * umax + j) * Hf + k] = a.w_fb[size_t(g * Hf + u0 + j) * Hf + k];
  }
  for (int i = tid; i < nr * Hf; i += blockDim.x) {
    const int r = i / Hf, k = i - r * Hf;
    wout[i] = a.w_out[size_t((r0 + r) % F) * Hf + k];
  }
  for (int i = tid; i < nr; i += blockDim.x) bout[i] = a.b_out[(r0 + i) % F];
  for (int i = tid; i < G4; i += blockDim.x) wcol[i] = a.w_col[i];
  for (int i = tid; i < B * Hf; i += blockDim.x) hfs[i] = 0.f;
  for (int i = tid; i < B * umax; i += blockDim.x) cf[i] = 0.f;
  for (int i = tid; i < nr * Hs; i += blockDim.x) hsb[i] = csb[i] = 0.f;
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    float* hpub = a.hbuf + size_t(t & 1) * B * Hf;

    // 1. the full-band step of the own units: one warp per (utterance, unit)
    for (int p = warp; p < B * nu; p += nwarps) {
      const int b = p / nu, j = p - b * nu;
      const float* h = hfs + size_t(b) * Hf;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int k = lane; k < Hf; k += 32) {
        const float hk = h[k];
#pragma unroll
        for (int g = 0; g < 4; ++g) acc[g] = fmaf(wfb[(g * umax + j) * Hf + k], hk, acc[g]);
      }
#pragma unroll
      for (int g = 0; g < 4; ++g) acc[g] = warp_sum(acc[g]);
      if (lane == 0) {
        const int u = u0 + j;
        const float* x = a.xp_fb + (size_t(b) * T + t) * 4 * Hf + u;
        const float ig = sigmoid_f(x[0] + acc[0]);
        const float fg = sigmoid_f(x[Hf] + acc[1]);
        const float gg = tanhf(x[2 * Hf] + acc[2]);
        const float og = sigmoid_f(x[3 * Hf] + acc[3]);
        const float c = fg * cf[b * umax + j] + ig * gg;
        cf[b * umax + j] = c;
        hpub[size_t(b) * Hf + u] = og * tanhf(c);
      }
    }
    grid.sync();  // h_fb(t) complete

    // 2. the whole h_fb(t), past L1 (other CTAs wrote it)
    for (int i = tid; i < B * Hf; i += blockDim.x) hfs[i] = __ldcg(hpub + i);
    __syncthreads();

    // 3. the embedding of the own rows: one warp per row
    for (int r = warp; r < nr; r += nwarps) {
      const float* h = hfs + size_t((r0 + r) / F) * Hf;
      float acc = 0.f;
      for (int k = lane; k < Hf; k += 32) acc = fmaf(wout[r * Hf + k], h[k], acc);
      acc = warp_sum(acc);
      if (lane == 0) emb[r] = fmaxf(acc + bout[r], 0.f);
    }
    __syncthreads();

    // 4. the sub-band pre-activations: one gate column per thread, RT rows
    //    at a time in registers
    for (int col = tid; col < G4; col += blockDim.x) {
      const float wc = wcol[col];
      for (int q0 = 0; q0 < nr; q0 += RT) {
        float acc[RT];
#pragma unroll
        for (int r = 0; r < RT; ++r) acc[r] = 0.f;
#pragma unroll 4
        for (int k = 0; k < Hs; ++k) {
          const float w = wsb[k * G4 + col];
#pragma unroll
          for (int r = 0; r < RT; ++r)
            if (q0 + r < nr) acc[r] = fmaf(hsb[(q0 + r) * Hs + k], w, acc[r]);
        }
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          if (q0 + r < nr) {
            const int row = r0 + q0 + r, b = row / F, f = row - b * F;
            const float x = a.xp_sb[((size_t(b) * T + t) * F + f) * G4 + col];
            pre[(q0 + r) * G4 + col] = (x + emb[q0 + r] * wc) + acc[r];
          }
        }
      }
    }
    __syncthreads();

    // 5. the sub-band cell of the own rows, h_sb(t) out
    for (int i = tid; i < nr * Hs; i += blockDim.x) {
      const int r = i / Hs, u = i - r * Hs;
      const float* p = pre + r * G4;
      const float ig = sigmoid_f(p[u]);
      const float fg = sigmoid_f(p[Hs + u]);
      const float gg = tanhf(p[2 * Hs + u]);
      const float og = sigmoid_f(p[3 * Hs + u]);
      const float c = fg * csb[i] + ig * gg;
      const float h = og * tanhf(c);
      csb[i] = c;
      hsb[i] = h;
      const int row = r0 + r, b = row / F, f = row - b * F;
      a.ys[((size_t(b) * T + t) * F + f) * Hs + u] = h;
    }
    __syncthreads();
  }
}

template <int RT>
cudaError_t fsn_launch_rt(const FsnArgs& a, const FsnPlan& p, int device, cudaStream_t stream) {
  auto kernel = fsn_kernel<RT>;
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  if (p.smem > static_cast<size_t>(optin)) return cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(p.smem));
  if (err != cudaSuccess) return err;
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, p.smem);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if (p.ctas > per_sm * sms) return cudaErrorCooperativeLaunchTooLarge;
  FsnArgs args = a;
  void* params[] = {&args};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(p.ctas),
                                    dim3(kThreads), params, p.smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// shared memory of one CTA of the launch plan at this shape, bytes (-1 if
// the device cannot be queried)
extern "C" long long aec_fsn_smem(int b, int f, int hf, int hs, int device) {
  FsnPlan p{};
  if (fsn_plan(b, f, hf, hs, device, &p) != cudaSuccess) return -1;
  return static_cast<long long>(p.smem);
}

// xp_fb (B, T, 4 Hf), xp_sb (B, T, F, 4 Hs), w_fb (4 Hf, Hf), w_out (F, Hf),
// b_out (F), w_col (4 Hs), w_sb_t (Hs, 4 Hs), hbuf (2, B, Hf) scratch, ys
// (B, T, F, Hs). All fp32, contiguous; B, T, F, Hf, Hs >= 1.
extern "C" int aec_fsn(const float* xp_fb, const float* xp_sb, const float* w_fb,
                       const float* w_out, const float* b_out, const float* w_col,
                       const float* w_sb_t, float* hbuf, float* ys, int b, int t_steps, int f,
                       int hf, int hs, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  FsnPlan p{};
  err = fsn_plan(b, f, hf, hs, device, &p);
  if (err != cudaSuccess) return err;
  const FsnArgs a{xp_fb, xp_sb, w_fb, w_out, b_out, w_col, w_sb_t, hbuf, ys,
                  b, t_steps, f, hf, hs, p.rmax, p.umax};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.rmax <= 1) return fsn_launch_rt<1>(a, p, device, s);
  if (p.rmax <= 2) return fsn_launch_rt<2>(a, p, device, s);
  if (p.rmax <= 4) return fsn_launch_rt<4>(a, p, device, s);
  return fsn_launch_rt<8>(a, p, device, s);
}

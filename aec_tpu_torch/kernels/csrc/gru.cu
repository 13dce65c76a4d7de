// Kernel K8: the GRU recurrence with the hidden state resident in shared memory.
//
// Replaces aec_tpu/kernels/pallas_gru.py:65 _gru_scan_fused_fwd (pallas_call
// at :107), the forward of gru_scan_fused. As there, the input projection of
// every frame is hoisted out of the recurrence (one torch.matmul in the
// wrapper, kernels/gru.py, with b_hr and b_hz folded into its bias), so the
// kernel carries only the hidden-state work, in nn.GRU's gate order:
//
//   r  = sigmoid(xr + h W_hr^T)
//   z  = sigmoid(xz + h W_hz^T)
//   n  = tanh(xn + r * (h W_hn^T + b_hn))   (b_hn stays inside the reset product)
//   h' = (1 - z) * n + z * h
//
// Design. On the TPU the grid walked the time axis in order with h in VMEM
// scratch. Here the time loop is inside the CTA and the batch row is the
// parallel axis: one CTA per row, 3H threads, W_hh^T (H x 3H) and h in
// shared memory (W_hh^T is 12 KB at H = 32, 192 KB at H = 128). Per step each
// thread forms one of the 3H gate pre-activations, an H-long dot over h in
// four partial sums, with the next step's input projection already loading
// from device memory; a barrier; H threads combine the gates and write h and
// the output; a barrier.
//
// Wider nets (H > 128, whose W_hh^T no longer fits one SM: 3 MB at H = 512)
// take the wide path, the same recurrence on one persistent grid of
// co-resident CTAs (grid_scan.cuh, shared with K9): each CTA owns U hidden
// units and their 3 gate columns of W_hh^T, read from L2 every step, and one
// grid barrier ends each step.
//
// What bounds it. Neither bytes nor FMAs: one step is 3H^2 FMA on one SM
// (3 K at H = 32) and the steps are serial, so the time is T times one step's
// latency (two barriers, a dependent chain of H/4 FMAs, expf and tanhf); a
// batch of B rows runs on B SMs in the same time. Levers left for later:
// several rows per CTA (one weight read for all), weight columns held in
// registers, and fewer barriers per step.

#include <cuda_runtime.h>

#include "grid_scan.cuh"

namespace {

constexpr int kMaxHidden = 128;

__device__ __forceinline__ float sigmoid_f(float x) { return 1.f / (1.f + expf(-x)); }

__global__ void __launch_bounds__(3 * kMaxHidden)
gru_kernel(const float* __restrict__ xp, const float* __restrict__ whh_t,
           const float* __restrict__ b_hn, const float* __restrict__ h0,
           float* __restrict__ ys, int t_steps, int hidden) {
  extern __shared__ float smem[];
  const int g3 = 3 * hidden;
  float* w = smem;             // (H, 3H) W_hh^T
  float* h = w + hidden * g3;  // (H) hidden state
  float* pre = h + hidden;     // (3H) sigmoid(r), sigmoid(z), h W_hn^T + b_hn
  float* xn = pre + g3;        // (H) the n gate's input projection
  const int j = threadIdx.x;
  const float* x = xp + static_cast<size_t>(blockIdx.x) * t_steps * g3;
  float* y = ys + static_cast<size_t>(blockIdx.x) * t_steps * hidden;

  for (int i = j; i < hidden * g3; i += blockDim.x) w[i] = whh_t[i];
  if (j < hidden) h[j] = h0[static_cast<size_t>(blockIdx.x) * hidden + j];
  const bool n_gate = j >= 2 * hidden;
  const float bias = n_gate ? b_hn[j - 2 * hidden] : 0.f;
  float x_cur = x[j];
  __syncthreads();

  for (int t = 0; t < t_steps; ++t) {
    const float x_next = t + 1 < t_steps ? x[static_cast<size_t>(t + 1) * g3 + j] : 0.f;
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
    int i = 0;
#pragma unroll 4
    for (; i + 4 <= hidden; i += 4) {
      a0 = fmaf(h[i], w[i * g3 + j], a0);
      a1 = fmaf(h[i + 1], w[(i + 1) * g3 + j], a1);
      a2 = fmaf(h[i + 2], w[(i + 2) * g3 + j], a2);
      a3 = fmaf(h[i + 3], w[(i + 3) * g3 + j], a3);
    }
    for (; i < hidden; ++i) a0 = fmaf(h[i], w[i * g3 + j], a0);
    const float acc = (a0 + a1) + (a2 + a3);
    if (n_gate) {
      pre[j] = acc + bias;
      xn[j - 2 * hidden] = x_cur;
    } else {
      pre[j] = sigmoid_f(x_cur + acc);
    }
    __syncthreads();
    if (j < hidden) {
      const float r = pre[j], z = pre[hidden + j];
      const float n = tanhf(xn[j] + r * pre[2 * hidden + j]);
      const float h_new = (1.f - z) * n + z * h[j];
      h[j] = h_new;
      y[static_cast<size_t>(t) * hidden + j] = h_new;
    }
    __syncthreads();
    x_cur = x_next;
  }
}

}  // namespace

extern "C" int aec_gru_max_hidden() { return kMaxHidden; }

// xp (batch, t_steps, 3H): x W_ih^T + b_ih + [b_hr; b_hz; 0]; whh_t (H, 3H);
// b_hn (H); h0 (batch, H); ys (batch, t_steps, H). All fp32, contiguous.
extern "C" int aec_gru(const float* xp, const float* whh_t, const float* b_hn, const float* h0,
                       float* ys, int batch, int t_steps, int hidden, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (hidden < 1 || hidden > kMaxHidden) return cudaErrorInvalidValue;
  const int smem = static_cast<int>(sizeof(float)) * (3 * hidden * hidden + 5 * hidden);
  err = cudaFuncSetAttribute(gru_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  if (batch == 0 || t_steps == 0) return cudaSuccess;
  gru_kernel<<<batch, 3 * hidden, smem, static_cast<cudaStream_t>(stream)>>>(
      xp, whh_t, b_hn, h0, ys, t_steps, hidden);
  return cudaGetLastError();
}

// units per CTA of the wide path's launch plan at this shape
extern "C" int aec_gru_units(int rows, int hidden, int device) {
  aec_grid::GridPlan<aec_grid::GruCell> p{};
  if (aec_grid::grid_plan(1, rows, hidden, device, &p) != cudaSuccess) return -1;
  return p.units;
}

// The wide path (H > kMaxHidden): xp (batch, t_steps, 3H) as aec_gru's; wp
// (nchunk, H, 3U) packed W_hh^T; b_hn (H); hbuf (2, batch, H) with h0 in [0];
// ys (batch, t_steps, H).
extern "C" int aec_gru_grid(const float* xp, const float* wp, const float* b_hn, float* hbuf,
                            float* ys, int batch, int t_steps, int hidden, int units, int device,
                            void* stream) {
  using namespace aec_grid;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  GridPlan<GruCell> p{};
  err = grid_plan(1, batch, hidden, device, &p);
  if (err != cudaSuccess) return err;
  if (p.units != units) return cudaErrorInvalidValue;  // W_hh^T packed for another plan
  const GridArgs a{xp, wp, b_hn, ys, hbuf, batch, t_steps, hidden, p.units, p.nchunk};
  return grid_launch(a, p, device, static_cast<cudaStream_t>(stream));
}

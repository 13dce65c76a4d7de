// A gated recurrence on one persistent grid of co-resident CTAs.
//
// The device code of K8's wide path (gru.cu, H > 128), whose W_hh^T (3 MB
// at H = 512) is too wide for one SM's registers. So the hidden units are
// split over the grid, and each step is
//
//   1. every CTA loads its group's h_{t-1} (R rows x H) from a ping-pong
//      buffer in device memory into shared memory;
//   2. it forms the gate pre-activations of its U hidden units for all R
//      rows: the NG gate columns of W_hh^T of each unit, H x (NG U) floats
//      packed contiguous per CTA by the wrapper, read from L2, the H-long
//      dots split over k-slices of threads, rows in registers;
//   3. it combines the gates (Cell) and writes h_t to the other buffer and
//      to the output;
//   4. one grid-wide barrier (cooperative launch, so the grid is co-resident
//      or the launch is refused).
//
// Inputs: xp (G, R, T, NG H), the input projection with the biases that add
// to it (the wrapper's one matmul); wp (G, nchunk, H, NG U) with wp[g, c, k,
// gate U + j] = W_hh[g][gate H + c U + j, k] (0 past H); hbuf (2, G, R, H)
// with h_0 in [0]. Output ys (G, R, T, H). All fp32: the dots are FFMA chains
// in another summation order than a matmul, so a kernel agrees with its plain
// version to fp32 round-off carried through the recursion.
//
// What bounds it. The work per step is G R NG H^2 FMA over the whole card;
// the bytes per step are W_hh^T from L2. One step costs the slowest SM's
// read of its W slice from L2 plus one grid barrier, serial in time. K9
// (lstm.cu), which began on this code, now holds its W_hh on chip across the
// time loop and waits at a barrier per group; the same moves are the levers
// left for this path.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace aec_grid {

namespace cg = cooperative_groups;

constexpr int kGridThreads = 256;

struct GridArgs {
  const float* __restrict__ xp;  // (G, R, T, NG H)
  const float* __restrict__ wp;  // (G, nchunk, H, NG U)
  const float* __restrict__ bias;  // b_hn (H)
  float* ys;                     // (G, R, T, H)
  float* hbuf;                   // (2, G, R, H)
  int rows, t_steps, hidden, units, nchunk;
};

__device__ __forceinline__ float sigmoid_f(float x) { return 1.f / (1.f + expf(-x)); }

// nn.GRU's cell, gates [r; z; n], b_hn inside the reset product (the other
// hidden biases are folded into xp)
struct GruCell {
  static constexpr int kGates = 3;
  __device__ static float step(const float* x, const float* pre, int U, int H, float h_prev,
                               float b_hn) {
    const float r = sigmoid_f(x[0] + pre[0]);
    const float z = sigmoid_f(x[H] + pre[U]);
    const float n = tanhf(x[2 * H] + r * (pre[2 * U] + b_hn));
    return (1.f - z) * n + z * h_prev;
  }
};

// shared floats of one CTA: h (R, H), k-slice partials, pre-activations
template <class Cell>
__host__ __device__ inline size_t grid_smem_floats(int rows, int hidden, int units) {
  const int cols = Cell::kGates * units, nks = kGridThreads / cols;
  return size_t(rows) * hidden + size_t(nks) * rows * cols + size_t(rows) * cols;
}

template <class Cell, int RT>
__global__ void __launch_bounds__(kGridThreads)
grid_scan_kernel(GridArgs a) {
  extern __shared__ float4 smem_raw[];
  constexpr int NG = Cell::kGates;
  const int R = a.rows, H = a.hidden, U = a.units, T = a.t_steps;
  const int cols = NG * U, nks = kGridThreads / cols;
  const int g = blockIdx.x / a.nchunk, chunk = blockIdx.x % a.nchunk;
  float* hs = reinterpret_cast<float*>(smem_raw);  // (R, H)
  float* part = hs + size_t(R) * H;                // (nks, R, cols)
  float* pre = part + size_t(nks) * R * cols;      // (R, cols)
  const int G = gridDim.x / a.nchunk;
  const float* w = a.wp + (size_t(g) * a.nchunk + chunk) * H * cols;
  const int tid = threadIdx.x, col = tid % cols, ks = tid / cols;
  const int k0 = ks * H / nks, k1 = (ks + 1) * H / nks;
  cg::grid_group grid = cg::this_grid();

  for (int t = 0; t < T; ++t) {
    const float* h_prev = a.hbuf + (size_t(t & 1) * G + g) * R * H;
    float* h_next = a.hbuf + (size_t((t + 1) & 1) * G + g) * R * H;
    for (int i = tid; i < R * H; i += kGridThreads) hs[i] = h_prev[i];
    __syncthreads();

    // 2. the k-slice partial dots of column `col`, RT rows at a time
    if (ks < nks) {
      for (int r0 = 0; r0 < R; r0 += RT) {
        float acc[RT];
#pragma unroll
        for (int r = 0; r < RT; ++r) acc[r] = 0.f;
#pragma unroll 8
        for (int k = k0; k < k1; ++k) {
          const float wv = __ldg(w + size_t(k) * cols + col);
#pragma unroll
          for (int r = 0; r < RT; ++r)
            if (r0 + r < R) acc[r] = fmaf(hs[(r0 + r) * H + k], wv, acc[r]);
        }
#pragma unroll
        for (int r = 0; r < RT; ++r)
          if (r0 + r < R) part[(ks * R + r0 + r) * cols + col] = acc[r];
      }
    }
    __syncthreads();
    for (int i = tid; i < R * cols; i += kGridThreads) {
      float acc = 0.f;
      for (int m = 0; m < nks; ++m) acc += part[m * R * cols + i];
      pre[i] = acc;
    }
    __syncthreads();

    // 3. the gates of the own units, h_t out
    for (int i = tid; i < R * U; i += kGridThreads) {
      const int r = i / U, j = i - r * U, unit = chunk * U + j;
      if (unit < H) {
        const float* x = a.xp + ((size_t(g) * R + r) * T + t) * NG * H + unit;
        const float h = Cell::step(x, pre + r * cols + j, U, H, hs[r * H + unit],
                                   a.bias ? a.bias[unit] : 0.f);
        h_next[r * H + unit] = h;
        a.ys[((size_t(g) * R + r) * T + t) * H + unit] = h;
      }
    }
    grid.sync();  // 4. every h_t written before any CTA loads it
  }
}

// The launch: U units per CTA so that the grid (G nchunk CTAs) is about one
// CTA per SM, co-resident, or the call is refused with
// cudaErrorCooperativeLaunchTooLarge.
template <class Cell>
struct GridPlan {
  int units, nchunk, ctas;
  size_t smem;
};

template <class Cell>
inline cudaError_t grid_plan(int groups, int rows, int hidden, int device, GridPlan<Cell>* p) {
  int sms = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  int units = (groups * hidden + sms - 1) / sms;
  if (Cell::kGates * units > kGridThreads) units = kGridThreads / Cell::kGates;
  p->units = units;
  p->nchunk = (hidden + units - 1) / units;
  p->ctas = groups * p->nchunk;
  p->smem = grid_smem_floats<Cell>(rows, hidden, units) * sizeof(float);
  return cudaSuccess;
}

template <class Cell, int RT>
inline cudaError_t grid_launch_rt(const GridArgs& a, int ctas, size_t smem, int device,
                                  cudaStream_t stream) {
  auto kernel = grid_scan_kernel<Cell, RT>;
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  if (smem > static_cast<size_t>(optin)) return cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kGridThreads, smem);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if (ctas > per_sm * sms) return cudaErrorCooperativeLaunchTooLarge;
  if (a.t_steps == 0 || a.rows == 0) return cudaSuccess;
  GridArgs args = a;
  void* params[] = {&args};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(ctas),
                                    dim3(kGridThreads), params, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// rows in register tiles of RT = the smallest power of two >= R, at most 32
template <class Cell>
inline cudaError_t grid_launch(const GridArgs& a, const GridPlan<Cell>& p, int device,
                               cudaStream_t stream) {
  const int r = a.rows;
  if (r <= 1) return grid_launch_rt<Cell, 1>(a, p.ctas, p.smem, device, stream);
  if (r <= 2) return grid_launch_rt<Cell, 2>(a, p.ctas, p.smem, device, stream);
  if (r <= 4) return grid_launch_rt<Cell, 4>(a, p.ctas, p.smem, device, stream);
  if (r <= 8) return grid_launch_rt<Cell, 8>(a, p.ctas, p.smem, device, stream);
  if (r <= 16) return grid_launch_rt<Cell, 16>(a, p.ctas, p.smem, device, stream);
  return grid_launch_rt<Cell, 32>(a, p.ctas, p.smem, device, stream);
}

}  // namespace aec_grid

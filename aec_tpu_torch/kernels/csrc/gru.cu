// Kernel K8: the GRU recurrence with W_hh held in registers.
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
// parallel axis: one CTA per row. Each hidden unit j has a team of P lanes
// of one warp; lane l of the team owns, for each of the three gates, the
// float4 chunks l, l + P, l + 2P, ... of W_hh's row (C weights a gate, 3C
// in all), loaded into registers once before the time loop from a packing
// the wrapper makes per call (kernels/gru.py pack_gru_lanes). A step reads
// h from shared memory as C/4 float4 broadcasts and runs the 3C FMAs into
// two accumulators per gate; the lanes that finish unit j's gate sums also
// combine them into h_j, written into the other half of a double-buffered
// h and into ys. One synchronisation per step:
//   - H <= 32: one warp, P = 1, every lane a whole unit (96 weight
//     registers at H = 32) and its own r, z, n; __syncwarp. The input
//     projections are loaded two steps ahead into registers.
//   - 32 < H <= 128: P = 4, 4H threads (512 at H = 128, 96 weight registers
//     each); the team's partials are reduce-scattered with three xor
//     shuffles so lanes 0, 1, 2 hold the r, z, n sums, one sigmoid stream
//     serves r and z, and lane 2 combines; __syncthreads. The input
//     projections are staged in shared memory by cp.async, eight steps a
//     chunk, one chunk ahead.
// expf and tanhf stay the precise forms.
//
// What bounds it. Neither bytes nor FMAs of the whole card: a step is 3H^2
// FMA on one SM and the steps are serial, so one step's latency sets the
// pace. At H = 128 the SM must dispatch 1536 warp FMAs a step (384 cycles on
// its four schedulers) besides the activations of 16 warps; at H = 32 one
// warp runs ~100 FMA instructions and the chain of three precise activations.
// A batch of B rows runs on B SMs in the same time.
//
// Wider nets (H > 128, whose W_hh no longer fits one SM's registers: 3 MB at
// H = 512) take the wide path, the same recurrence on one persistent grid of
// co-resident CTAs (grid_scan.cuh): each CTA owns U hidden
// units and their 3 gate columns of W_hh^T, read from L2 every step, and one
// grid barrier ends each step.

#include <cuda_runtime.h>

#include "grid_scan.cuh"

namespace {

constexpr int kMaxHidden = 128;

__device__ __forceinline__ float sigmoid_f(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ float dot4(float4 w, float4 v, float a) {
  a = fmaf(w.x, v.x, a);
  a = fmaf(w.y, v.y, a);
  a = fmaf(w.z, v.z, a);
  return fmaf(w.w, v.w, a);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// P lanes per unit, C weights per lane and gate (a multiple of 4, P C >= H).
// wpk (3 C/4, threads, 4): chunk i of gate g of thread (j P + l) is W_hh[g H
// + j, 4 (l + P i) + e], zero past H; kernels/gru.py pack_gru_lanes.
template <int P, int C>
__global__ void __launch_bounds__(P == 1 ? 32 : 4 * kMaxHidden)
gru_kernel(const float* __restrict__ xp, const float4* __restrict__ wpk,
           const float* __restrict__ b_hn, const float* __restrict__ h0,
           float* __restrict__ ys, int t_steps, int hidden) {
  static_assert(P == 1 || P == 4, "one lane or a team of four per unit");
  constexpr int C4 = C / 4;
  constexpr int kS = 8;  // P = 4: steps of input projection per staged chunk
  __shared__ __align__(16) float hbuf[2][P * C];
  __shared__ float xs[P == 1 ? 1 : 2][P == 1 ? 1 : kS * 3 * kMaxHidden];
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int j = tid / P, l = tid % P;
  const bool live = j < hidden;
  const int u = live ? j : 0;  // a padding team reads unit 0's inputs and writes nothing
  const int g3 = 3 * hidden;
  const size_t row = blockIdx.x;
  const float* xrow = xp + row * t_steps * g3;
  float* y = ys + row * t_steps * hidden + j;

  float4 w[3][C4];
#pragma unroll
  for (int g = 0; g < 3; ++g)
#pragma unroll
    for (int i = 0; i < C4; ++i) w[g][i] = wpk[(g * C4 + i) * nthr + tid];
  for (int i = tid; i < P * C; i += nthr) {
    hbuf[0][i] = i < hidden ? h0[row * hidden + i] : 0.f;
    hbuf[1][i] = 0.f;
  }
  const float bias = b_hn[u];
  float h = h0[row * hidden + u];

  // The input projections. One warp (P = 1): each lane loads its unit's
  // two steps ahead into registers. P = 4: the CTA stages chunks of kS
  // steps in shared memory with cp.async, one chunk ahead.
  float xq[2][3];
  const auto stage = [&](int c) {
    const int t0 = c * kS, n = min(kS, t_steps - t0) * g3;
    float* dst = xs[c & 1];
    const float* src = xrow + static_cast<size_t>(t0) * g3;
    for (int i = tid; i < n; i += nthr) cp_async4(dst + i, src + i);
    cp_async_commit();
  };
  if constexpr (P == 1) {
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int g = 0; g < 3; ++g)
        xq[a][g] = a < t_steps ? xrow[static_cast<size_t>(a) * g3 + g * hidden + u] : 0.f;
    __syncwarp();
  } else {
    stage(0);
    cp_async_wait_all();
    __syncthreads();
  }

  // two steps per loop pass, which ran faster on the H100 than one at every
  // lane plan: across the pair the compiler can keep the input ring and h
  // in place instead of copying them, a copy that waits for its load
#pragma unroll 2
  for (int t = 0; t < t_steps; ++t) {
    float xr, xz, xn;
    if constexpr (P == 1) {
      xr = xq[0][0]; xz = xq[0][1]; xn = xq[0][2];
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        xq[0][g] = xq[1][g];
        xq[1][g] = t + 2 < t_steps ? xrow[static_cast<size_t>(t + 2) * g3 + g * hidden + u] : 0.f;
      }
    } else {
      const int c = t / kS;
      if (t == c * kS && (c + 1) * kS < t_steps) stage(c + 1);
      const float* xc = xs[c & 1] + (t - c * kS) * g3 + u;
      xr = xc[0]; xz = xc[hidden]; xn = xc[2 * hidden];
    }

    // this lane's partial dots over its float4 chunks of h
    const float4* hv = reinterpret_cast<const float4*>(hbuf[t & 1]);
    float acc[3][2] = {{0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
    for (int i = 0; i < C4; ++i) {
      const float4 v = hv[l + P * i];
#pragma unroll
      for (int g = 0; g < 3; ++g) acc[g][i & 1] = dot4(w[g][i], v, acc[g][i & 1]);
    }
    const float sr = acc[0][0] + acc[0][1], sz = acc[1][0] + acc[1][1];
    const float sn = acc[2][0] + acc[2][1];

    bool writer;
    if constexpr (P == 1) {
      const float r = sigmoid_f(xr + sr), z = sigmoid_f(xz + sz);
      const float n = tanhf(xn + r * (sn + bias));
      h = (1.f - z) * n + z * h;
      writer = live;
    } else {
      // reduce-scatter over the team: lane 0 ends with the r sum, lane 1
      // with z's, lane 2 with n's, each (s0 + s2) + (s1 + s3); one sigmoid
      // stream serves r and z, lane 2 combines
      float a0 = l < 2 ? sr : sn, a1 = l < 2 ? sz : 0.f;
      a0 += __shfl_xor_sync(0xffffffffu, l < 2 ? sn : sr, 2);
      a1 += __shfl_xor_sync(0xffffffffu, l < 2 ? 0.f : sz, 2);
      float k = (l & 1) ? a1 : a0;
      k += __shfl_xor_sync(0xffffffffu, (l & 1) ? a0 : a1, 1);
      const float sig = sigmoid_f(k + (l == 0 ? xr : xz));
      const int base = (tid & 31) & ~3;
      const float r = __shfl_sync(0xffffffffu, sig, base);
      const float z = __shfl_sync(0xffffffffu, sig, base + 1);
      const float n = tanhf(xn + r * (k + bias));
      h = (1.f - z) * n + z * h;
      writer = live && l == 2;
    }
    if (writer) {
      hbuf[(t + 1) & 1][j] = h;
      y[static_cast<size_t>(t) * hidden] = h;
    }
    if constexpr (P == 1) {
      __syncwarp();
    } else {
      if (t % kS == kS - 1) cp_async_wait_all();  // the next chunk has landed
      __syncthreads();
    }
  }
}

template <int P, int C>
cudaError_t launch_lanes(const float* xp, const float* wpk, const float* b_hn, const float* h0,
                         float* ys, int batch, int t_steps, int hidden, cudaStream_t stream) {
  const int units = P == 1 ? 32 : (hidden + 7) / 8 * 8;
  gru_kernel<P, C><<<batch, units * P, 0, stream>>>(
      xp, reinterpret_cast<const float4*>(wpk), b_hn, h0, ys, t_steps, hidden);
  return cudaGetLastError();
}

}  // namespace

extern "C" int aec_gru_max_hidden() { return kMaxHidden; }

// xp (batch, t_steps, 3H): x W_ih^T + b_ih + [b_hr; b_hz; 0]; wpk W_hh packed
// for the lanes (kernels/gru.py pack_gru_lanes, whose lane plan this
// dispatch repeats); b_hn (H); h0 (batch, H); ys (batch, t_steps, H). All
// fp32, contiguous.
extern "C" int aec_gru(const float* xp, const float* wpk, const float* b_hn, const float* h0,
                       float* ys, int batch, int t_steps, int hidden, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (hidden < 1 || hidden > kMaxHidden) return cudaErrorInvalidValue;
  if (batch == 0 || t_steps == 0) return cudaSuccess;
  const auto s = static_cast<cudaStream_t>(stream);
  if (hidden <= 4) return launch_lanes<1, 4>(xp, wpk, b_hn, h0, ys, batch, t_steps, hidden, s);
  if (hidden <= 8) return launch_lanes<1, 8>(xp, wpk, b_hn, h0, ys, batch, t_steps, hidden, s);
  if (hidden <= 16) return launch_lanes<1, 16>(xp, wpk, b_hn, h0, ys, batch, t_steps, hidden, s);
  if (hidden <= 32) return launch_lanes<1, 32>(xp, wpk, b_hn, h0, ys, batch, t_steps, hidden, s);
  if (hidden <= 64) return launch_lanes<4, 16>(xp, wpk, b_hn, h0, ys, batch, t_steps, hidden, s);
  return launch_lanes<4, 32>(xp, wpk, b_hn, h0, ys, batch, t_steps, hidden, s);
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

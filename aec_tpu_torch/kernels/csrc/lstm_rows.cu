// Kernel K13: an LSTM layer over many independent rows (FullSubNet's sub
// band: one LSTM shared by every (sample, bin) row), forward and backward.
//
// Shapes. R rows of T steps at width H: the hoisted projection xp (R, T, 4H)
// (x W_ih^T and both biases, one product outside), W_hh (4H, H); each step
// is the product (R, H) x (H, 4H) and the cells. FullSubNet's published
// sub band trains on R = 2,048 rows (drop band: 16 samples x 128 bins) at H
// = 384, T = 503, two layers: a step is 2.4 GFLOP, W_hh 2.36 MB. K9 and
// K9b (lstm.cu, lstm_bwd.cu) keep W_hh on chip in a grid of CTAs that each
// own a few units of every row and exchange h a step: built for a few rows,
// waiting on their own chain. Here the rows never meet, so the work splits
// the other way.
//
// Design. A CTA owns 16 rows and every unit, and marches them through time
// alone: no exchange, no grid barrier. Its 256 threads are 2 row groups x
// 128 unit lanes; thread (g, l) holds the 8 rows of group g for units l +
// 128 j (j < UPT = ceil(H / 128)), all four gates, in registers: 96 sums at
// H = 384, and c. h(t - 1) lies in shared memory, row-major. W_hh streams
// from L2 each step through shared memory in tiles (8 k-values of every
// unit's four gates, 48 KB at H = 384), two buffers, one tile ahead by
// cp.async, so every CTA reads W once a step and each of its values serves
// 16 rows. The backward is the same machine on the transposed product:
// each step's cells turn the carried dh, dc and the saved gates into dxp(t)
// (out, and into shared memory), then dxp(t) (16, 4H) x W_hh (4H, H) gives
// the next step's carried dh, W_hh streamed in tiles of 32 rows.
//
// What bounds it (H = 384, 16 rows a CTA, 128 CTAs): a step's FMAs are
// 9.4 M a CTA, ~37 us at the SM's 128 FMA a clock (1.98 GHz); its reads of
// W are 2.36 MB a CTA from L2, 302 MB a step over the card. So a step sits
// between the FMA bound and the L2 read; lstm_rows_costs.py in
// kernels/ has the reckoning and the measured split.
//
// Numerics: fp32 FMAs, expf and tanhf in the cells; each sum in k order
// (the backward's in the order of the 4H gate-major rows).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 16;        // rows a CTA
constexpr int kRowsThread = 8;   // rows a thread: two row groups of the CTA's 16
constexpr int kLanes = 128;      // unit lanes: thread (g, l) owns units l + 128 j
constexpr int kKt = 8;           // forward: k-values a tile of W

// backward: quads of W_hh's rows a tile (two buffers and dxp's rows must fit)
template <int UPT>
constexpr int kBwdQuads = UPT <= 3 ? 8 : 4;

__device__ __forceinline__ float sigmoid_r(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// n float4 from src into dst by all threads, one commit group
__device__ __forceinline__ void stage(float4* dst, const float4* src, int n) {
  for (int i = threadIdx.x; i < n; i += kThreads) cp_async16(dst + i, src + i);
  cp_async_commit();
}

__device__ __forceinline__ float dot4(const float4 a, const float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// Forward. wt (kp, 128 UPT) float4: wt[k][u] = W_hh[g H + u][k] for g = 0..3
// (x, y, z, w), zero for u >= H or k >= H; kp = H rounded up to kKt.
// Shared memory: two tiles of W (kKt x 128 UPT float4), h (16 x kp).
template <int UPT, bool SAVE>
__global__ void __launch_bounds__(kThreads, 1)
    lstm_rows_kernel(const float* __restrict__ xp, const float4* __restrict__ wt,
                     float* __restrict__ ys, float* __restrict__ saved, int rows, int t_steps,
                     int hidden, int kp) {
  extern __shared__ float4 smem4[];
  constexpr int nu = kLanes * UPT;
  constexpr int tile = kKt * nu;  // float4 a tile
  float4* wbuf = smem4;
  float* hs = reinterpret_cast<float*>(smem4 + 2 * tile);
  const int lane = threadIdx.x % kLanes;
  const int r0 = (threadIdx.x / kLanes) * kRowsThread;
  const int row0 = blockIdx.x * kRows + r0;
  const int h4 = 4 * hidden;
  const int nt = kp / kKt;
  const long total = static_cast<long>(t_steps) * nt;

  stage(wbuf, wt, tile);
  for (int i = threadIdx.x; i < kRows * kp; i += kThreads) hs[i] = 0.f;

  float c[UPT][kRowsThread];
#pragma unroll
  for (int j = 0; j < UPT; ++j)
#pragma unroll
    for (int r = 0; r < kRowsThread; ++r) c[j][r] = 0.f;

  long gt = 0;
  for (int t = 0; t < t_steps; ++t) {
    float acc[UPT][4][kRowsThread];
#pragma unroll
    for (int r = 0; r < kRowsThread; ++r) {
      const int row = row0 + r;
      const float* x = xp + (static_cast<size_t>(row) * t_steps + t) * h4;
#pragma unroll
      for (int j = 0; j < UPT; ++j) {
        const int u = lane + kLanes * j;
        const bool ok = row < rows && u < hidden;
#pragma unroll
        for (int g = 0; g < 4; ++g) acc[j][g][r] = ok ? x[g * hidden + u] : 0.f;
      }
    }
    for (int k0 = 0; k0 < kp; k0 += kKt, ++gt) {
      cp_async_wait_all();
      __syncthreads();
      if (gt + 1 < total) {
        const long nx = (gt + 1) % nt;
        stage(wbuf + ((gt + 1) & 1) * tile, wt + nx * tile, tile);
      }
      const float4* w = wbuf + (gt & 1) * tile;
#pragma unroll
      for (int kq = 0; kq < kKt; kq += 4) {
        float4 hv[kRowsThread];
#pragma unroll
        for (int r = 0; r < kRowsThread; ++r)
          hv[r] = *reinterpret_cast<const float4*>(hs + (r0 + r) * kp + k0 + kq);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
#pragma unroll
          for (int j = 0; j < UPT; ++j) {
            const float4 wv = w[(kq + e) * nu + lane + kLanes * j];
#pragma unroll
            for (int r = 0; r < kRowsThread; ++r) {
              const float h = e == 0 ? hv[r].x : e == 1 ? hv[r].y : e == 2 ? hv[r].z : hv[r].w;
              acc[j][0][r] = fmaf(h, wv.x, acc[j][0][r]);
              acc[j][1][r] = fmaf(h, wv.y, acc[j][1][r]);
              acc[j][2][r] = fmaf(h, wv.z, acc[j][2][r]);
              acc[j][3][r] = fmaf(h, wv.w, acc[j][3][r]);
            }
          }
        }
      }
    }
    __syncthreads();  // every read of h(t - 1) is done before h(t) is written
#pragma unroll
    for (int r = 0; r < kRowsThread; ++r) {
      const int row = row0 + r;
      const size_t at = static_cast<size_t>(row) * t_steps + t;
#pragma unroll
      for (int j = 0; j < UPT; ++j) {
        const int u = lane + kLanes * j;
        const float ig = sigmoid_r(acc[j][0][r]), fg = sigmoid_r(acc[j][1][r]);
        const float gg = tanhf(acc[j][2][r]), og = sigmoid_r(acc[j][3][r]);
        c[j][r] = fg * c[j][r] + ig * gg;
        const float h = og * tanhf(c[j][r]);
        if (u < hidden) {
          hs[(r0 + r) * kp + u] = h;
          if (row < rows) {
            ys[at * hidden + u] = h;
            if constexpr (SAVE) {
              float* s = saved + at * 5 * hidden + u;
              s[0] = ig;
              s[hidden] = fg;
              s[2 * hidden] = gg;
              s[3 * hidden] = og;
              s[4 * hidden] = c[j][r];
            }
          }
        }
      }
    }
  }
}

// Backward. wb (kq, 128 UPT) float4: wb[q][u] = W_hh[4 q + e][u] (x, y, z,
// w for e = 0..3), zero for u >= H or 4 q + e >= 4H; kq = H rounded up to
// the tile's quads. Shared memory: two tiles of W, dxp's 16 rows (4 kq each).
template <int UPT>
__global__ void __launch_bounds__(kThreads, 1)
    lstm_rows_bwd_kernel(const float* __restrict__ g_ys, const float* __restrict__ saved,
                         const float4* __restrict__ wb, float* __restrict__ dxp, int rows,
                         int t_steps, int hidden, int kq) {
  extern __shared__ float4 smem4[];
  constexpr int nu = kLanes * UPT;
  constexpr int qt = kBwdQuads<UPT>;
  constexpr int tile = qt * nu;
  float4* wbuf = smem4;
  float* ds = reinterpret_cast<float*>(smem4 + 2 * tile);
  const int lane = threadIdx.x % kLanes;
  const int r0 = (threadIdx.x / kLanes) * kRowsThread;
  const int row0 = blockIdx.x * kRows + r0;
  const int stride = 4 * kq;  // floats a row of dxp in shared memory
  const int nt = kq / qt;
  const long total = static_cast<long>(t_steps - 1) * nt;

  if (total > 0) stage(wbuf, wb, tile);
  for (int i = threadIdx.x; i < kRows * stride; i += kThreads) ds[i] = 0.f;
  __syncthreads();

  float carry_h[UPT][kRowsThread], carry_c[UPT][kRowsThread];
#pragma unroll
  for (int j = 0; j < UPT; ++j)
#pragma unroll
    for (int r = 0; r < kRowsThread; ++r) carry_h[j][r] = carry_c[j][r] = 0.f;

  long gt = 0;
  for (int t = t_steps - 1; t >= 0; --t) {
#pragma unroll
    for (int r = 0; r < kRowsThread; ++r) {
      const int row = row0 + r;
      if (row >= rows) continue;
      const size_t at = static_cast<size_t>(row) * t_steps + t;
#pragma unroll
      for (int j = 0; j < UPT; ++j) {
        const int u = lane + kLanes * j;
        if (u >= hidden) continue;
        const float* s = saved + at * 5 * hidden + u;
        const float ig = s[0], fg = s[hidden], gg = s[2 * hidden], og = s[3 * hidden];
        const float cc = s[4 * hidden];
        const float cp = t > 0 ? s[-hidden] : 0.f;  // c(t - 1), the row's last step
        const float dh = carry_h[j][r] + g_ys[at * hidden + u];
        const float tc = tanhf(cc);
        const float dc = carry_c[j][r] + dh * og * (1.f - tc * tc);
        const float di = dc * gg * ig * (1.f - ig);
        const float df = dc * cp * fg * (1.f - fg);
        const float dg = dc * ig * (1.f - gg * gg);
        const float dout = dh * tc * og * (1.f - og);
        carry_c[j][r] = dc * fg;
        float* d = dxp + at * 4 * hidden + u;
        d[0] = di;
        d[hidden] = df;
        d[2 * hidden] = dg;
        d[3 * hidden] = dout;
        float* e = ds + (r0 + r) * stride + u;
        e[0] = di;
        e[hidden] = df;
        e[2 * hidden] = dg;
        e[3 * hidden] = dout;
      }
    }
    if (t == 0) break;
#pragma unroll
    for (int j = 0; j < UPT; ++j)
#pragma unroll
      for (int r = 0; r < kRowsThread; ++r) carry_h[j][r] = 0.f;
    for (int q0 = 0; q0 < kq; q0 += qt, ++gt) {
      cp_async_wait_all();
      __syncthreads();  // (the first also puts dxp(t) in every thread's sight)
      if (gt + 1 < total) {
        const long nx = (gt + 1) % nt;
        stage(wbuf + ((gt + 1) & 1) * tile, wb + nx * tile, tile);
      }
      const float4* w = wbuf + (gt & 1) * tile;
#pragma unroll
      for (int q = 0; q < qt; ++q) {
        float4 wv[UPT];
#pragma unroll
        for (int j = 0; j < UPT; ++j) wv[j] = w[q * nu + lane + kLanes * j];
#pragma unroll
        for (int r = 0; r < kRowsThread; ++r) {
          const float4 dv = *reinterpret_cast<const float4*>(ds + (r0 + r) * stride + 4 * (q0 + q));
#pragma unroll
          for (int j = 0; j < UPT; ++j) carry_h[j][r] = dot4(dv, wv[j], carry_h[j][r]);
        }
      }
    }
    __syncthreads();  // every read of dxp(t) is done before dxp(t - 1) is written
  }
}

size_t fwd_smem(int upt, int kp) {
  return sizeof(float4) * 2 * kKt * kLanes * upt + sizeof(float) * kRows * kp;
}

size_t bwd_smem(int upt, int kq) {
  const int qt = upt <= 3 ? kBwdQuads<3> : kBwdQuads<4>;
  return sizeof(float4) * 2 * qt * kLanes * upt + sizeof(float) * kRows * 4 * kq;
}

template <typename K, typename... A>
cudaError_t launch(K kernel, int rows, size_t smem, cudaStream_t s, A... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const int ctas = (rows + kRows - 1) / kRows;
  kernel<<<ctas, kThreads, smem, s>>>(args...);
  return cudaGetLastError();
}

template <int UPT>
cudaError_t fwd_upt(const float* xp, const float4* wt, float* ys, float* saved, int rows,
                    int t_steps, int hidden, int kp, cudaStream_t s) {
  const size_t smem = fwd_smem(UPT, kp);
  if (saved)
    return launch(lstm_rows_kernel<UPT, true>, rows, smem, s, xp, wt, ys, saved, rows, t_steps,
                  hidden, kp);
  return launch(lstm_rows_kernel<UPT, false>, rows, smem, s, xp, wt, ys, saved, rows, t_steps,
                hidden, kp);
}

template <int UPT>
cudaError_t bwd_upt(const float* g_ys, const float* saved, const float4* wb, float* dxp, int rows,
                    int t_steps, int hidden, int kq, cudaStream_t s) {
  return launch(lstm_rows_bwd_kernel<UPT>, rows, bwd_smem(UPT, kq), s, g_ys, saved, wb, dxp,
                rows, t_steps, hidden, kq);
}

}  // namespace

// The constants kernels/lstm_rows.py packs and plans by.
extern "C" int aec_lstm_rows_consts(int which) {
  switch (which) {
    case 0: return kRows;
    case 1: return kLanes;
    case 2: return kKt;
    case 3: return kBwdQuads<3>;
    case 4: return kBwdQuads<4>;
    default: return -1;
  }
}

// xp (R, T, 4H), wt packed by kernels/lstm_rows.py pack_forward (kp rows),
// ys (R, T, H), saved (R, T, 5H) or null. All fp32, contiguous.
extern "C" int aec_lstm_rows(const float* xp, const void* wt, float* ys, float* saved, int rows,
                             int t_steps, int hidden, int kp, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (hidden < 1 || hidden > 4 * kLanes || kp < hidden || kp % kKt) return cudaErrorInvalidValue;
  if (rows == 0 || t_steps == 0) return cudaSuccess;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto w = static_cast<const float4*>(wt);
  switch ((hidden + kLanes - 1) / kLanes) {
    case 1: return fwd_upt<1>(xp, w, ys, saved, rows, t_steps, hidden, kp, s);
    case 2: return fwd_upt<2>(xp, w, ys, saved, rows, t_steps, hidden, kp, s);
    case 3: return fwd_upt<3>(xp, w, ys, saved, rows, t_steps, hidden, kp, s);
    default: return fwd_upt<4>(xp, w, ys, saved, rows, t_steps, hidden, kp, s);
  }
}

// g_ys (R, T, H), saved (R, T, 5H) from aec_lstm_rows, wb packed by
// kernels/lstm_rows.py pack_backward (kq quads), dxp (R, T, 4H).
extern "C" int aec_lstm_rows_bwd(const float* g_ys, const float* saved, const void* wb, float* dxp,
                                 int rows, int t_steps, int hidden, int kq, int device,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int upt = (hidden + kLanes - 1) / kLanes;
  const int qt = upt <= 3 ? kBwdQuads<3> : kBwdQuads<4>;
  if (hidden < 1 || upt > 4 || kq < hidden || kq % qt) return cudaErrorInvalidValue;
  if (rows == 0 || t_steps == 0) return cudaSuccess;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto w = static_cast<const float4*>(wb);
  switch (upt) {
    case 1: return bwd_upt<1>(g_ys, saved, w, dxp, rows, t_steps, hidden, kq, s);
    case 2: return bwd_upt<2>(g_ys, saved, w, dxp, rows, t_steps, hidden, kq, s);
    case 3: return bwd_upt<3>(g_ys, saved, w, dxp, rows, t_steps, hidden, kq, s);
    default: return bwd_upt<4>(g_ys, saved, w, dxp, rows, t_steps, hidden, kq, s);
  }
}

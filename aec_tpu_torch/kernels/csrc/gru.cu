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
// the wrapper caches per weight tensor (kernels/gru.py pack_gru_lanes; a
// gather from W_hh's row-major layout in the kernel itself cost 25 % a
// step at H = 32 on the H100, ptxas giving the loop 128 registers instead
// of 160). A step reads
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
// expf and tanhf stay the precise forms. With SAVE (a training forward)
// the lane that combines unit j also writes r, z, n and hn = h W_hn^T + b_hn
// of each step, (B, T, 4H), for the backward; the arithmetic is the same.
//
// What bounds it. Neither bytes nor FMAs of the whole card: a step is 3H^2
// FMA on one SM and the steps are serial, so one step's latency sets the
// pace. At H = 128 the SM must dispatch 1536 warp FMAs a step (384 cycles on
// its four schedulers) besides the activations of 16 warps; at H = 32 one
// warp runs ~100 FMA instructions and the chain of three precise activations.
// A batch of B rows runs on B SMs in the same time.
//
// Wider nets (H > 128, whose W_hh no longer fits one SM's registers: 3 MB at
// H = 512) take the wide path, gru_wide.cu: both kernels on one persistent
// grid of co-resident CTAs, W_hh on chip across the time loop.
//
// Kernel K8b, the backward of the recurrence (gru_bwd_kernel), the
// counterpart of the custom VJP's _bwd (aec_tpu/kernels/pallas_gru.py:159),
// which XLA compiles from the scan's VJP into one loop on the device. One
// CTA per row walks t = T-1 ... 0 on K8's lane plan, lane l of unit j's
// team holding the chunks l, l + P, ... of column j of each gate's W_hh
// (a row of W_g^T) in registers, packed as K8's (pack_gru_lanes of the
// per-gate transpose). Per step, with dh = the carried gradient
// + g_ys[t] and the saved gates:
//   dn^ = dh (1 - z)(1 - n^2),  dz^ = dh (h_{t-1} - n) z (1 - z),
//   dr^ = dn^ hn r (1 - r),     d_hn = dn^ r
// written to dxp[t] = [dr^, dz^, dn^] and d_hn[t]; [dr^, dz^, d_hn] goes
// into a double-buffered vector in shared memory, one barrier, and each
// team forms dh_{t-1}[j] = sum_g sum_k W_g[k, j] d_g[k] + z dh: the
// forward's 3H^2 FMAs in the transposed layout, the three gates' partials
// summed per lane and then over the team. No transcendental on the chain,
// so a step is shorter than K8's. The weight gradients are plain products
// over the B T rows, left to the wrapper (as XLA leaves them outside the
// loop).
//
// K8b at H = 128 (P = 4, C = 32: 512 threads under __launch_bounds__(512),
// so at most 128 registers a lane) cannot hold all 96 registers of W beside
// a step's state: ptxas spilled that instantiation (PERF.md §6). There
// the last kBwdSmemChunks float4 chunks of a lane's W (of gate n's column:
// the packing's tail) live in shared memory, laid out as the packing is
// (chunk-major, then thread: conflict-free), and are read each step; the
// summation order is unchanged, so the result is bit-equal to the all-
// register plan. H <= 64 keeps every chunk in registers.

#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kMaxHidden = 128;
// K8b at C = 32: float4 chunks of a lane's W in shared memory, the rest in
// registers (PERF.md §6 has its time beside the all-register plan's)
constexpr int kBwdSmemChunks = 4;

__device__ __forceinline__ float sigmoid_f(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ float dot4(float4 w, float4 v, float a) {
  a = fmaf(w.x, v.x, a);
  a = fmaf(w.y, v.y, a);
  a = fmaf(w.z, v.z, a);
  return fmaf(w.w, v.w, a);
}

// a float4 of shared memory, read where it stands in the code: the compiler
// may not hoist it out of the step loop into registers (which a plain load
// of a loop-invariant value invites, undoing a share of W kept in shared memory)
__device__ __forceinline__ float4 ld_shared4(const float4* p) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p)))
               : "memory");
  return v;
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
template <int P, int C, bool SAVE>
__global__ void __launch_bounds__(P == 1 ? 32 : 4 * kMaxHidden)
gru_kernel(const float* __restrict__ xp, const float4* __restrict__ wpk,
           const float* __restrict__ b_hn, const float* __restrict__ h0,
           float* __restrict__ ys, float* __restrict__ gates, int t_steps, int hidden) {
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
  float* gsave = SAVE ? gates + row * t_steps * 4 * hidden + j : nullptr;

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
    float r, z, n, hn;
    if constexpr (P == 1) {
      r = sigmoid_f(xr + sr);
      z = sigmoid_f(xz + sz);
      hn = sn + bias;
      n = tanhf(xn + r * hn);
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
      r = __shfl_sync(0xffffffffu, sig, base);
      z = __shfl_sync(0xffffffffu, sig, base + 1);
      hn = k + bias;
      n = tanhf(xn + r * hn);
      h = (1.f - z) * n + z * h;
      writer = live && l == 2;
    }
    if (writer) {
      hbuf[(t + 1) & 1][j] = h;
      y[static_cast<size_t>(t) * hidden] = h;
      if constexpr (SAVE) {
        float* gs = gsave + static_cast<size_t>(t) * 4 * hidden;
        gs[0] = r;
        gs[hidden] = z;
        gs[2 * hidden] = n;
        gs[3 * hidden] = hn;
      }
    }
    if constexpr (P == 1) {
      __syncwarp();
    } else {
      if (t % kS == kS - 1) cp_async_wait_all();  // the next chunk has landed
      __syncthreads();
    }
  }
}

// K8b. wpk_t: lane l of unit j's team holds, for gate g, chunk i of column
// j of W_g, W_hh[g H + 4 (l + P i) + e, j], zero past H (pack_gru_lanes of
// the per-gate transpose). gys, ys (B, T, H); gates (B, T, 4H) from K8's
// SAVE launch; h0 (B, H); out: dxp (B, T, 3H), dhn (B, T, H), dh0 (B, H).
// SM: the packing's last SM chunks (gate n's) in dynamic shared memory.
template <int P, int C, int SM>
__global__ void __launch_bounds__(P == 1 ? 32 : 4 * kMaxHidden)
gru_bwd_kernel(const float* __restrict__ gys, const float* __restrict__ gates,
               const float* __restrict__ ys, const float* __restrict__ h0,
               const float4* __restrict__ wpk_t, float* __restrict__ dxp,
               float* __restrict__ dhn, float* __restrict__ dh0, int t_steps, int hidden) {
  static_assert(P == 1 || P == 4, "one lane or a team of four per unit");
  constexpr int C4 = C / 4;
  constexpr int NR = 3 * C4 - SM;  // chunks in registers
  static_assert(SM >= 0 && SM <= C4, "shared chunks come from gate n's column");
  // steps of inputs loaded ahead into registers (P = 4: 16 warps, 128 registers a lane)
  constexpr int kAhead = P == 1 ? 2 : 1;
  // [dr^, dz^, d_hn] of a step by unit, double-buffered, zero past H
  __shared__ __align__(16) float dbuf[2][3][P * C];
  extern __shared__ float4 wsm[];  // (SM, threads)
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int j = tid / P, l = tid % P;
  const bool live = j < hidden;
  const int u = live ? j : 0;  // a padding team reads unit 0's inputs and writes nothing
  const size_t row = blockIdx.x;
  const float* gy = gys + row * t_steps * hidden + u;
  const float* yrow = ys + row * t_steps * hidden + u;
  const float* gt = gates + row * t_steps * 4 * hidden + u;

  float4 w[NR > 0 ? NR : 1];
#pragma unroll
  for (int k = 0; k < NR; ++k) w[k] = wpk_t[k * nthr + tid];
#pragma unroll
  for (int k = 0; k < SM; ++k) wsm[k * nthr + tid] = wpk_t[(NR + k) * nthr + tid];
  for (int i = tid; i < 2 * 3 * P * C; i += nthr) (&dbuf[0][0][0])[i] = 0.f;
  // the inputs of step t: g_ys, r, z, n, hn, h_{t-1} (h0 at t = 0)
  const auto load = [&](int t, float* q) {
    if (t < 0) return;
    const size_t o = static_cast<size_t>(t) * hidden, o4 = 4 * o;
    q[0] = gy[o];
    q[1] = gt[o4];
    q[2] = gt[o4 + hidden];
    q[3] = gt[o4 + 2 * hidden];
    q[4] = gt[o4 + 3 * hidden];
    q[5] = t > 0 ? yrow[o - hidden] : h0[row * hidden + u];
  };
  float q[kAhead][6];
#pragma unroll
  for (int a = 0; a < kAhead; ++a) load(t_steps - 1 - a, q[a]);
  if constexpr (P == 1) {
    __syncwarp();
  } else {
    __syncthreads();
  }

  float carry = 0.f;
  for (int t = t_steps - 1; t >= 0; --t) {
    float c[6];
#pragma unroll
    for (int m = 0; m < 6; ++m) c[m] = q[0][m];
#pragma unroll
    for (int a = 0; a + 1 < kAhead; ++a)
#pragma unroll
      for (int m = 0; m < 6; ++m) q[a][m] = q[a + 1][m];
    load(t - kAhead, q[kAhead - 1]);

    const float dh = carry + c[0];
    const float r = c[1], z = c[2], n = c[3], hn = c[4], hp = c[5];
    const float dn = dh * (1.f - z) * (1.f - n * n);
    const float dz = dh * (hp - n) * z * (1.f - z);
    const float dr = dn * hn * r * (1.f - r);
    const float dhn_t = dn * r;
    if (live) {
      const size_t o = (row * t_steps + t) * hidden + j;
      float* dst = dxp + 3 * (row * t_steps + t) * hidden + j;
      float* d = dbuf[t & 1][0];
      if (P == 1 || l == 0) {
        dst[0] = dr;
        d[j] = dr;
      }
      if (P == 1 || l == 1) {
        dst[hidden] = dz;
        d[P * C + j] = dz;
      }
      if (P == 1 || l == 2) dst[2 * hidden] = dn;
      if (P == 1 || l == 3) {
        dhn[o] = dhn_t;
        d[2 * P * C + j] = dhn_t;
      }
    }
    if constexpr (P == 1) {
      __syncwarp();
    } else {
      __syncthreads();
    }

    // this lane's partial of sum_g W_g^T d_g over its float4 chunks
    float acc[3][2] = {{0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
    for (int i = 0; i < C4; ++i)
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        const int k = g * C4 + i;  // the chunk's place in the packing
        const float4 v = reinterpret_cast<const float4*>(dbuf[t & 1][g])[l + P * i];
        const float4 wk = k < NR ? w[k < NR ? k : 0] : ld_shared4(wsm + (k - NR) * nthr + tid);
        acc[g][i & 1] = dot4(wk, v, acc[g][i & 1]);
      }
    float s = ((acc[0][0] + acc[0][1]) + (acc[1][0] + acc[1][1])) + (acc[2][0] + acc[2][1]);
    if constexpr (P == 4) {  // the team's sum, the same bits in every lane
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
    }
    carry = s + z * dh;
  }
  if (live && l == 0) dh0[row * hidden + j] = carry;
}

template <int P>
int units_of(int hidden) {
  return P == 1 ? 32 : (hidden + 7) / 8 * 8;
}

template <int P, int C>
cudaError_t launch_lanes(const float* xp, const float* wpk, const float* b_hn, const float* h0,
                         float* ys, float* gates, int batch, int t_steps, int hidden,
                         cudaStream_t stream) {
  const int threads = units_of<P>(hidden) * P;
  const auto w = reinterpret_cast<const float4*>(wpk);
  if (gates)
    gru_kernel<P, C, true><<<batch, threads, 0, stream>>>(xp, w, b_hn, h0, ys, gates, t_steps,
                                                          hidden);
  else
    gru_kernel<P, C, false><<<batch, threads, 0, stream>>>(xp, w, b_hn, h0, ys, nullptr, t_steps,
                                                           hidden);
  return cudaGetLastError();
}

template <int P, int C>
cudaError_t launch_bwd(const float* gys, const float* gates, const float* ys, const float* h0,
                       const float* wpk_t, float* dxp, float* dhn, float* dh0, int batch,
                       int t_steps, int hidden, cudaStream_t stream) {
  constexpr int SM = P == 4 && C == 32 ? kBwdSmemChunks : 0;
  const int threads = units_of<P>(hidden) * P;
  const size_t smem = size_t(SM) * threads * sizeof(float4);
  auto kernel = gru_bwd_kernel<P, C, SM>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<batch, threads, smem, stream>>>(gys, gates, ys, h0,
                                           reinterpret_cast<const float4*>(wpk_t), dxp, dhn, dh0,
                                           t_steps, hidden);
  return cudaGetLastError();
}

// K8's lane plan (kernels/gru.py lane_plan): the one dispatch both kernels use
template <typename F>
cudaError_t by_lane_plan(int hidden, F&& f) {
  if (hidden <= 4) return f(std::integral_constant<int, 1>{}, std::integral_constant<int, 4>{});
  if (hidden <= 8) return f(std::integral_constant<int, 1>{}, std::integral_constant<int, 8>{});
  if (hidden <= 16) return f(std::integral_constant<int, 1>{}, std::integral_constant<int, 16>{});
  if (hidden <= 32) return f(std::integral_constant<int, 1>{}, std::integral_constant<int, 32>{});
  if (hidden <= 64) return f(std::integral_constant<int, 4>{}, std::integral_constant<int, 16>{});
  return f(std::integral_constant<int, 4>{}, std::integral_constant<int, 32>{});
}

}  // namespace

// xp (batch, t_steps, 3H): x W_ih^T + b_ih + [b_hr; b_hz; 0]; wpk W_hh packed
// for the lanes (kernels/gru.py pack_gru_lanes, whose lane plan this
// dispatch repeats); b_hn (H); h0 (batch, H); ys (batch, t_steps, H); gates
// (batch, t_steps, 4H) written where not null (r, z, n, hn a step). All
// fp32, contiguous.
extern "C" int aec_gru(const float* xp, const float* wpk, const float* b_hn, const float* h0,
                       float* ys, float* gates, int batch, int t_steps, int hidden, int device,
                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (hidden < 1 || hidden > kMaxHidden) return cudaErrorInvalidValue;
  if (batch == 0 || t_steps == 0) return cudaSuccess;
  const auto s = static_cast<cudaStream_t>(stream);
  return by_lane_plan(hidden, [&](auto p, auto c) {
    return launch_lanes<decltype(p)::value, decltype(c)::value>(xp, wpk, b_hn, h0, ys, gates,
                                                                batch, t_steps, hidden, s);
  });
}

// K8b: gys, ys (batch, t_steps, H); gates (batch, t_steps, 4H) from aec_gru;
// h0 (batch, H); wpk_t W_hh's per-gate transpose packed as aec_gru's wpk;
// out dxp (batch, t_steps, 3H), dhn (batch, t_steps, H), dh0 (batch, H).
// All fp32, contiguous.
extern "C" int aec_gru_backward(const float* gys, const float* gates, const float* ys,
                                const float* h0, const float* wpk_t, float* dxp, float* dhn,
                                float* dh0, int batch, int t_steps, int hidden, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (hidden < 1 || hidden > kMaxHidden) return cudaErrorInvalidValue;
  if (batch == 0 || t_steps == 0) return cudaSuccess;
  const auto s = static_cast<cudaStream_t>(stream);
  return by_lane_plan(hidden, [&](auto p, auto c) {
    return launch_bwd<decltype(p)::value, decltype(c)::value>(gys, gates, ys, h0, wpk_t, dxp, dhn,
                                                              dh0, batch, t_steps, hidden, s);
  });
}

// Kernels K8 and K8b on the wide path (H > 128): the GRU recurrence and its
// backward for a net whose W_hh no longer fits one SM's registers (3 MB at
// H = 512), on one persistent grid of co-resident CTAs with W_hh held on
// chip across the time loop.
//
// Replaces, above H = 128, aec_tpu/kernels/pallas_gru.py:65
// _gru_scan_fused_fwd (pallas_call at :107), and the backward of its custom
// VJP gru_scan_fused (_bwd, :159-166: jax.vjp of the scan, which XLA compiles
// into one loop on the device). gru.cu has both at H <= 128 (one CTA per
// row); the contracts are the same:
//
//   forward:  r = sigmoid(xr + h W_hr^T), z = sigmoid(xz + h W_hz^T),
//             hn = h W_hn^T + b_hn, n = tanh(xn + r hn), h' = (1 - z) n + z h,
//             with SAVE also r, z, n, hn of each step, (B, T, 4H), as gru.cu;
//   backward: dh = carry + g_ys(t); dn^ = dh (1 - z)(1 - n^2);
//             dz^ = dh (h(t - 1) - n) z (1 - z); dr^ = dn^ hn r (1 - r);
//             d_hn = dn^ r; carry = W_hh^T [dr^, dz^, d_hn] + z dh,
//             out dxp(t) = [dr^, dz^, dn^], d_hn(t), and dh0 = the last carry.
//
// Design. Both directions are one engine: a CTA owns U hidden units, holds
// the "columns" that produce its outputs, and each step needs one vector per
// row from every CTA:
//   forward:  3U columns of length H (rows g H + u of W_hh, gate g of its
//             unit u), against h(t - 1);
//   backward: U columns of length 3H (column u of W_hh, all three gates),
//             against d(t + 1) = [dr^, dz^, d_hn] of every unit.
// So a step is: wait for the vector's words, stage them in shared memory,
// the dots, the cells of the own units, publish the own units' part of the
// next vector. The columns go to the 16 warps: NCG groups of CW columns (a
// power of two) times KS slices of the vector (KS divides its npos
// positions of 128 floats); lane l of a warp holds quads l + 32 (ks pps + j),
// j < pps, of its CW columns, the first kRegQuads / CW positions in
// registers, the rest in shared memory, packed once per weight tensor by the
// wrapper (kernels/gru.py wide_plan, pack_wide). Each lane sums in k order
// with FMAs, RT rows a pass; the warp's lanes reduce by shuffles (the
// reduce-scatter of lstm_common.cuh) and the KS slices' sums meet in shared
// memory, added in slice order by the thread that steps the cell. The
// summation order is the same in both directions, so kernels/gru.py models
// both in one function (wide_dots).
//
// The exchange replaces the per-step grid barrier of the earlier wide path: the
// vector lies in ping-pong buffers in device memory. Up to kTagRows rows,
// each value travels in a 64-bit word with the step it is for, stored and
// loaded whole (relaxed, gpu scope): a CTA reads each word as soon as it says
// so, with no fence and no counter, as K9 (lstm.cu) exchanges h. Past
// kTagRows rows, where the words' doubled bytes outweigh the wait, plain
// floats and one counter: each CTA adds one after its part (fence, then
// atomic add) and the CTAs read the floats once the counter says all have.
// The launch is cooperative (the grid co-resident or refused) and a wait
// traps after kSpinLimit polls rather than hang.
//
// What bounds it. The card's bound is the FMAs, B T 3H^2 each way (6.3 G at
// the DCT-CNN's training shape, B = 16, T = 501, H = 512: 0.19 ms at the
// fp32 peak), but the steps are serial: one step is the exchange's latency
// (a store's way to L2 and a poll's back), the vector's bytes from L2 into
// every CTA (16 rows: 32 KB of h forward, 96 KB of d backward, a CTA a
// step), and the dots of the CTA (16 x 12 x 512 FMA at H = 512, U = 4). PERF.md
// has the reckoning and the measured times (kernels/gru_wide_costs.py cuts
// the dots out with -DAEC_NO_DOTS; no route defines it).

#include <cuda_runtime.h>

#include "lstm_common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRegQuads = 8;  // float4 quads of W a thread holds in registers
constexpr int kTagRows = 8;  // up to this many rows, the vector travels in tagged words
constexpr int kPairs = 4;  // pairs of words (or quads of floats) a thread loads at once
constexpr int kBackoffNs = 64;  // between two reads of a word not yet written
constexpr long long kSpinLimit = 1ll << 24;  // ~10 s of polls: a lost CTA traps, never hangs

enum Mode { kForward = 0, kForwardSave = 1, kBackward = 2 };

struct WideArgs {
  const float4* __restrict__ wp;  // (nchunk, pps CW, kThreads) quads of the columns
  const float* __restrict__ xp;   // forward: (R, T, 3H), the folded projection
  const float* __restrict__ b_hn;  // forward: (H)
  const float* __restrict__ h0;   // (R, H)
  float* ys;                      // forward: (R, T, H)
  float* gates;                   // forward with SAVE: (R, T, 4H) r, z, n, hn; backward: in
  const float* __restrict__ gys;  // backward: (R, T, H)
  const float* __restrict__ yin;  // backward: (R, T, H), the forward's ys
  float* dxp;                     // backward: (R, T, 3H)
  float* dhn;                     // backward: (R, T, H)
  float* dh0;                     // backward: (R, H)
  void* xbuf;       // (2, R, KP): 64-bit words (tagged) or floats; forward: h0 in slot 0
  unsigned* counter;  // zero at the launch (untagged)
  int rows, t_steps, hidden, units, kdim, kp, ncg, ks, pps, jreg, tagged;
};

// shared memory of one CTA (floats): W's shared quads, the vector, the
// slices' sums, two floats a cell (forward: h; backward: z and dh)
struct WideSmem {
  size_t ws, vs, part, st, total;
};

__host__ __device__ inline WideSmem wide_smem(int rows, int units, int kp, int cw, int ncg,
                                              int ks, int pps, int jreg) {
  WideSmem s;
  s.ws = 0;
  s.vs = s.ws + size_t(pps - jreg) * cw * kThreads * 4;
  s.part = s.vs + size_t(rows) * kp;
  s.st = s.part + size_t(ks) * rows * ncg * cw;
  s.total = s.st + size_t(2) * rows * units;
  return s;
}

__device__ __forceinline__ ulonglong2 load_words(const unsigned long long* p) {
  ulonglong2 v;
  asm volatile("ld.relaxed.gpu.global.v2.b64 {%0, %1}, [%2];" : "=l"(v.x), "=l"(v.y) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ float4 load_floats(const float* p) {
  float4 v;
  asm volatile("ld.relaxed.gpu.global.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_word(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// one value of the next vector: a word with its step, or a float
__device__ __forceinline__ void publish(const WideArgs& a, int slot, int row, int k, float v,
                                        unsigned tag) {
  const size_t o = (size_t(slot) * a.rows + row) * a.kp + k;
  if (a.tagged)
    store_word(static_cast<unsigned long long*>(a.xbuf) + o,
               (static_cast<unsigned long long>(tag) << 32) | __float_as_uint(v));
  else
    static_cast<float*>(a.xbuf)[o] = v;
}

// publication n of the vector (its slot n & 1) into vs (R, KP): each word
// once it carries n, or the floats once the counter says every CTA's part is
// out (n nchunk additions); vs past K stays zero
__device__ __forceinline__ void stage_vector(const WideArgs& a, int n, float* vs) {
  const int R = a.rows, K = a.kdim, KP = a.kp, tid = threadIdx.x;
  if (a.tagged) {
    const unsigned long long* src =
        static_cast<const unsigned long long*>(a.xbuf) + size_t(n & 1) * R * KP;
    const int kh = (K + 1) / 2, total = R * kh;
    for (int p0 = tid; p0 < total; p0 += kThreads * kPairs) {
      ulonglong2 v[kPairs];
#pragma unroll
      for (int q = 0; q < kPairs; ++q) {
        const int idx = p0 + q * kThreads;
        if (idx < total) v[q] = load_words(src + size_t(idx / kh) * KP + 2 * (idx % kh));
      }
#pragma unroll
      for (int q = 0; q < kPairs; ++q) {
        const int idx = p0 + q * kThreads;
        if (idx >= total) break;
        const int r = idx / kh, k = 2 * (idx - r * kh);
        long long spins = 0;
        while (unsigned(v[q].x >> 32) != unsigned(n) ||
               (k + 1 < K && unsigned(v[q].y >> 32) != unsigned(n))) {
          if (++spins > kSpinLimit) __trap();
          __nanosleep(kBackoffNs);
          v[q] = load_words(src + size_t(r) * KP + k);
        }
        vs[r * KP + k] = __uint_as_float(unsigned(v[q].x));
        if (k + 1 < K) vs[r * KP + k + 1] = __uint_as_float(unsigned(v[q].y));
      }
    }
  } else {
    if (tid == 0) {
      const unsigned want = unsigned(gridDim.x) * unsigned(n);
      long long spins = 0;
      while (load_acquire(a.counter) < want) {
        if (++spins > kSpinLimit) __trap();
        __nanosleep(kBackoffNs);
      }
    }
    __syncthreads();
    const float* src = static_cast<const float*>(a.xbuf) + size_t(n & 1) * R * KP;
    const int kq = (K + 3) / 4, total = R * kq;
    float4* vs4 = reinterpret_cast<float4*>(vs);
    for (int p0 = tid; p0 < total; p0 += kThreads * kPairs) {
      float4 v[kPairs];
#pragma unroll
      for (int q = 0; q < kPairs; ++q) {
        const int idx = p0 + q * kThreads;
        if (idx < total) v[q] = load_floats(src + size_t(idx / kq) * KP + 4 * (idx % kq));
      }
#pragma unroll
      for (int q = 0; q < kPairs; ++q) {
        const int idx = p0 + q * kThreads;
        if (idx < total) vs4[(idx / kq) * (KP / 4) + idx % kq] = v[q];
      }
    }
  }
}

template <int V>
struct Log2 {
  static constexpr int value = V >= 32 ? 5 : V >= 16 ? 4 : V >= 8 ? 3 : V >= 4 ? 2 : V >= 2 ? 1 : 0;
};

// CW columns a warp, RT rows a pass (CW RT <= 32)
template <int CW, int RT, int MODE>
__global__ void __launch_bounds__(kThreads, 1) gru_wide_kernel(WideArgs a) {
  extern __shared__ float4 smem_raw[];
  constexpr bool BWD = MODE == kBackward;
  constexpr int JR = kRegQuads / CW;  // positions a lane can hold in registers
  constexpr int V = CW * RT, M = Log2<V>::value;
  static_assert(V <= 32, "a warp reduces at most 32 sums at once");
  const int R = a.rows, H = a.hidden, U = a.units, T = a.t_steps, KP = a.kp;
  const int kp4 = KP / 4, ncolp = a.ncg * CW, pps = a.pps, jreg = a.jreg, nks = a.ks;
  const int u0 = blockIdx.x * U, nu = min(U, H - u0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool dotter = warp < a.ncg * nks;
  const int cg = warp % a.ncg, ks = warp / a.ncg;
  const WideSmem lay = wide_smem(R, U, KP, CW, a.ncg, nks, pps, jreg);
  float* base = reinterpret_cast<float*>(smem_raw);
  const float4* ws = reinterpret_cast<const float4*>(base + lay.ws);
  float* vs = base + lay.vs;
  const float4* vs4 = reinterpret_cast<const float4*>(vs);
  float* part = base + lay.part;
  float* st0 = base + lay.st;  // forward: h of the own units; backward: z
  float* st1 = st0 + R * U;    // backward: dh
  const float4* w = a.wp + size_t(blockIdx.x) * pps * CW * kThreads + tid;

  // once: the columns' quads on chip, the vector's padding zero, the cells' state
  float4 wr[JR > 0 ? JR : 1][CW];
#pragma unroll
  for (int j = 0; j < JR; ++j)
#pragma unroll
    for (int i = 0; i < CW; ++i) wr[j][i] = j < jreg ? w[size_t(j * CW + i) * kThreads] : float4{};
  for (int q = 0; q < (pps - jreg) * CW; ++q)
    reinterpret_cast<float4*>(base + lay.ws)[q * kThreads + tid] =
        w[size_t(jreg * CW + q) * kThreads];
  for (int i = tid; i < R * KP; i += kThreads) vs[i] = 0.f;
  for (int i = tid; i < R * U; i += kThreads) {
    const int r = i / U, j = i - r * U;
    st0[i] = !BWD && j < nu ? a.h0[size_t(r) * H + u0 + j] : 0.f;
    st1[i] = 0.f;
  }
  __syncthreads();

  // iteration n reads publication n of the vector (forward: h(n - 1), h0 at
  // n = 0; backward: d(T - n), none at n = 0), runs the cells of step t and
  // publishes n + 1; the backward's iteration T only forms dh0
  const int steps = BWD ? T + 1 : T;
  for (int n = 0; n < steps; ++n) {
    const int t = BWD ? T - 1 - n : n;
    // this thread's first cell's inputs, which do not wait for the vector
    float in[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    const auto load_in = [&](int i, float* q) {
      const int r = i / nu, u = u0 + (i - r * nu);
      const size_t rt = size_t(r) * T + t;
      if constexpr (BWD) {
        q[0] = a.gys[rt * H + u];
        const float* gs = a.gates + rt * 4 * H + u;
        q[1] = gs[0];
        q[2] = gs[H];
        q[3] = gs[2 * H];
        q[4] = gs[3 * H];
        q[5] = t > 0 ? a.yin[(rt - 1) * H + u] : a.h0[size_t(r) * H + u];
      } else {
        const float* x = a.xp + rt * 3 * H + u;
        q[0] = x[0];
        q[1] = x[H];
        q[2] = x[2 * H];
      }
    };
    if (t >= 0 && tid < R * nu) load_in(tid, in);

    if (!BWD || n > 0) {
      stage_vector(a, n, vs);
      __syncthreads();
#ifndef AEC_NO_DOTS
      // lane l sums its columns over quads l + 32 (ks pps + j) of the rows'
      // vectors (registers, then shared memory), RT rows a pass; the warp
      // sums over its lanes; the slices' sums go to part (KS, R, NCG CW)
      if (dotter) {
        for (int r0 = 0; r0 < R; r0 += RT) {
          float acc[V];
#pragma unroll
          for (int i = 0; i < V; ++i) acc[i] = 0.f;
#pragma unroll
          for (int j = 0; j < JR; ++j)
            if (j < jreg) fma_pos<CW, RT>(wr[j], vs4, kp4, r0, R, lane + 32 * (ks * pps + j), acc);
          for (int j = jreg; j < pps; ++j) {
            float4 wv[CW];
#pragma unroll
            for (int i = 0; i < CW; ++i) wv[i] = ws[((j - jreg) * CW + i) * kThreads + tid];
            fma_pos<CW, RT>(wv, vs4, kp4, r0, R, lane + 32 * (ks * pps + j), acc);
          }
          Scatter<V, 16>::run(acc, lane);
          const int idx = lane >> (5 - M), i = idx / RT, r = idx - i * RT;
          if ((lane & ((1 << (5 - M)) - 1)) == 0 && r0 + r < R)
            part[(ks * R + r0 + r) * ncolp + cg * CW + i] = acc[0];
        }
      }
#else
      for (int i = tid; i < nks * R * ncolp; i += kThreads) part[i] = 0.f;
#endif
      __syncthreads();
    }

    // the cells of the own units; publication n + 1 where someone reads it
    const bool publish_next = n + 1 < steps;
    const int slot = (n + 1) & 1;
    for (int i = tid; i < R * nu; i += kThreads) {
      const int r = i / nu, j = i - r * nu, u = u0 + j, c = r * U + j;
      float q[6];
      if (i == tid) {
#pragma unroll
        for (int m = 0; m < 6; ++m) q[m] = in[m];
      } else if (t >= 0) {
        load_in(i, q);
      }
      if constexpr (BWD) {
        float carry = 0.f;
        if (n > 0) {
          float s = part[r * ncolp + j];
          for (int m = 1; m < nks; ++m) s += part[(m * R + r) * ncolp + j];
          carry = s + st0[c] * st1[c];
        }
        if (n == T) {
          a.dh0[size_t(r) * H + u] = carry;
          continue;
        }
        const float dh = carry + q[0];
        const float rg = q[1], zg = q[2], ng = q[3], hn = q[4], hp = q[5];
        const float dn = dh * (1.f - zg) * (1.f - ng * ng);
        const float dz = dh * (hp - ng) * zg * (1.f - zg);
        const float dr = dn * hn * rg * (1.f - rg);
        const float dhn_t = dn * rg;
        const size_t rt = size_t(r) * T + t;
        float* dx = a.dxp + rt * 3 * H + u;
        dx[0] = dr;
        dx[H] = dz;
        dx[2 * H] = dn;
        a.dhn[rt * H + u] = dhn_t;
        if (publish_next) {
          publish(a, slot, r, u, dr, unsigned(n + 1));
          publish(a, slot, r, H + u, dz, unsigned(n + 1));
          publish(a, slot, r, 2 * H + u, dhn_t, unsigned(n + 1));
        }
        st0[c] = zg;
        st1[c] = dh;
      } else {
        float p[3];
#pragma unroll
        for (int g = 0; g < 3; ++g) {
          const int col = g * U + j;
          p[g] = part[r * ncolp + col];
          for (int m = 1; m < nks; ++m) p[g] += part[(m * R + r) * ncolp + col];
        }
        const float rg = sigmoid_f(q[0] + p[0]);
        const float zg = sigmoid_f(q[1] + p[1]);
        const float hn = p[2] + a.b_hn[u];
        const float ng = tanhf(q[2] + rg * hn);
        const float h = (1.f - zg) * ng + zg * st0[c];
        st0[c] = h;
        const size_t rt = size_t(r) * T + t;
        a.ys[rt * H + u] = h;
        if constexpr (MODE == kForwardSave) {
          float* gs = a.gates + rt * 4 * H + u;
          gs[0] = rg;
          gs[H] = zg;
          gs[2 * H] = ng;
          gs[3 * H] = hn;
        }
        if (publish_next) publish(a, slot, r, u, h, unsigned(n + 1));
      }
    }
    if (publish_next && !a.tagged) {
      __syncthreads();
      if (tid == 0) {
        __threadfence();  // the CTA's part of publication n + 1 before its count
        atomicAdd(a.counter, 1u);
      }
    }
  }
}

template <int CW, int RT, int MODE>
cudaError_t wide_launch(const WideArgs& a, int ctas, size_t smem, int device,
                        cudaStream_t stream) {
  auto kernel = gru_wide_kernel<CW, RT, MODE>;
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
  WideArgs args = a;
  void* params[] = {&args};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(ctas),
                                    dim3(kThreads), params, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// rows a pass: 1 for a single row, else 8 (CW RT <= 32 at CW <= 4)
template <int MODE>
cudaError_t wide_dispatch(const WideArgs& a, int cw, int ctas, size_t smem, int device,
                          cudaStream_t stream) {
  const bool one = a.rows == 1;
  if (cw == 2)
    return one ? wide_launch<2, 1, MODE>(a, ctas, smem, device, stream)
               : wide_launch<2, 8, MODE>(a, ctas, smem, device, stream);
  if (cw == 4)
    return one ? wide_launch<4, 1, MODE>(a, ctas, smem, device, stream)
               : wide_launch<4, 8, MODE>(a, ctas, smem, device, stream);
  return cudaErrorInvalidValue;
}

// the plan (kernels/gru.py wide_plan) as the kernel needs it, or an error
cudaError_t wide_check(const WideArgs& a, int nchunk, int cw, int columns) {
  const int npos = a.kp / 128;
  if (a.kp % 128 != 0 || a.kp < a.kdim || nchunk * a.units < a.hidden ||
      (nchunk - 1) * a.units >= a.hidden || a.ncg * cw < columns || a.ncg * a.ks > kWarps ||
      a.ks * a.pps != npos || a.jreg != (a.pps < kRegQuads / cw ? a.pps : kRegQuads / cw) ||
      a.tagged != (a.rows <= kTagRows ? 1 : 0) || (cw != 2 && cw != 4))
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

}  // namespace

// the plan's constants, which kernels/gru.py repeats (it checks them at load)
extern "C" int aec_gru_wide_reg_quads() { return kRegQuads; }
extern "C" int aec_gru_wide_tag_rows() { return kTagRows; }

// K8 on the wide path: wp the columns' quads (kernels/gru.py pack_wide of the
// forward plan); xp (R, T, 3H); b_hn (H); h0 (R, H); xbuf the zeroed
// exchange with h0 in slot 0 (words with step 0, or floats); counter zero;
// ys (R, T, H); gates (R, T, 4H) written where not null. All fp32, contiguous.
extern "C" int aec_gru_wide_forward(const void* wp, const float* xp, const float* b_hn,
                                    const float* h0, float* ys, float* gates, void* xbuf,
                                    unsigned* counter, int rows, int t_steps, int hidden,
                                    int units, int nchunk, int kp, int cw, int ncg, int ks,
                                    int pps, int jreg, int tagged, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  WideArgs a{static_cast<const float4*>(wp), xp, b_hn, h0, ys, gates, nullptr, nullptr, nullptr,
             nullptr, nullptr, xbuf, counter, rows, t_steps, hidden, units, hidden, kp, ncg, ks,
             pps, jreg, tagged};
  err = wide_check(a, nchunk, cw, 3 * units);
  if (err != cudaSuccess) return err;
  if (rows == 0 || t_steps == 0) return cudaSuccess;
  const size_t smem = wide_smem(rows, units, kp, cw, ncg, ks, pps, jreg).total * sizeof(float);
  const auto s = static_cast<cudaStream_t>(stream);
  return gates ? wide_dispatch<kForwardSave>(a, cw, nchunk, smem, device, s)
               : wide_dispatch<kForward>(a, cw, nchunk, smem, device, s);
}

// K8b on the wide path: wp pack_wide of the backward plan; gys, ys (R, T,
// H); gates (R, T, 4H) from aec_gru_wide_forward's SAVE launch (or aec_gru's:
// one layout); h0 (R, H); xbuf the zeroed exchange; counter zero; out dxp
// (R, T, 3H), dhn (R, T, H), dh0 (R, H). All fp32, contiguous.
extern "C" int aec_gru_wide_backward(const void* wp, const float* gys, const float* gates,
                                     const float* ys, const float* h0, float* dxp, float* dhn,
                                     float* dh0, void* xbuf, unsigned* counter, int rows,
                                     int t_steps, int hidden, int units, int nchunk, int kp,
                                     int cw, int ncg, int ks, int pps, int jreg, int tagged,
                                     int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  WideArgs a{static_cast<const float4*>(wp), nullptr, nullptr, h0, nullptr,
             const_cast<float*>(gates), gys, ys, dxp, dhn, dh0, xbuf, counter, rows, t_steps,
             hidden, units, 3 * hidden, kp, ncg, ks, pps, jreg, tagged};
  err = wide_check(a, nchunk, cw, units);
  if (err != cudaSuccess) return err;
  if (rows == 0 || t_steps == 0) return cudaSuccess;
  const size_t smem = wide_smem(rows, units, kp, cw, ncg, ks, pps, jreg).total * sizeof(float);
  return wide_dispatch<kBackward>(a, cw, nchunk, smem, device, static_cast<cudaStream_t>(stream));
}

// Kernel K9: DCCRN's grouped complex-LSTM recurrence on one persistent grid,
// W_hh held on chip across the time loop.
//
// Replaces aec_tpu/kernels/pallas_lstm.py:88 _grouped_lstm_fused_fwd
// (pallas_call at :123), the forward of complex_lstm_scan_fused. As there,
// the input projections of all four naive-complex paths and both biases are
// hoisted into one matmul outside (kernels/lstm.py), so the kernel carries
// only the recurrence: two parameter groups (real, imag), each over R = 2B
// rows (the real and the imaginary inputs), per step one (R, H) x (H, 4H)
// product per group, then nn.LSTM's i/f/g/o gates carrying c and h from
// zero. Everything is fp32, so K9 agrees with the plain scan to fp32
// round-off (the TPU kernel rounds h and W to bf16, pallas_lstm.py:61-67).
//
// Design. The G x H (group, unit) pairs are split over one persistent grid
// of co-resident CTAs, U units of one group per CTA (about one CTA per SM).
// A CTA's 4U gate columns of W_hh^T (column gate U + j: that gate of unit j)
// go to its 16 warps, CW each (a power of two); lane l of a warp holds the
// quads l, l + 32, ... (npos positions) of its CW columns, and sums them in
// k order with FMAs, RT rows a pass; the warp's 32 partial sums reduce with
// shuffles (a reduce-scatter: each round halves the values a lane keeps). So
// each quad of h read from shared memory serves CW columns, and no partial
// sums cross warps. The wrapper packs the lanes' quads once per weight tensor
// (kernels/lstm.py grouped_plan / pack_grouped, which also model the layout
// and this summation order for the CPU tests) and the kernel keeps them on
// chip for the whole time loop:
//   - the first kRegQuads (16: 64 floats) in registers, in a fully unrolled
//     loop over a fixed per-thread array;
//   - the next positions in shared memory, as many as fit beside the group's
//     h (R x Hp floats), the gates' sums and c;
//   - the rest, where the shared memory runs out (at B = 16, R = 32: h alone
//     takes 128 KB), read from L2 every step.
// The two groups are independent recurrences, so a CTA waits only for its
// own group's h. h travels in 64-bit words, its bits and the step it is for,
// each stored and loaded whole (relaxed, at gpu scope): a CTA reads each word
// of h(t) as soon as the word says t + 1, backing off 64 ns between reads,
// with no fence and no counter (ping-pong buffers make it safe, as in
// lstm_int8.cu). Past 8 rows a group, where a CTA's 8 R H bytes of words a
// step outweigh the wait, one counter a group does instead: each CTA adds
// one after its words (fence, then atomic add) and the group's CTAs read the
// words once the counter says all have. (Both measured on the card against
// cooperative groups' grid barrier, kernels/lstm_costs.py.)
//
// What bounds it. The card's bound for the work is the FMAs (8.6 G per
// layer at B = 1, T = 513: 0.26 ms at the fp32 peak). A step is serial: the
// group's h (16 KB of words at B = 1) from L2 into every CTA, the dots, the
// cells, h(t)'s words out. At DCCRN's H = 1024 and B = 1 a CTA owns 16
// units, 64 columns x 1024 floats = 256 KB: 128 KB in registers, 128 KB in
// shared memory (of 227 KB, beside 9 KB of h, the gates' sums and c),
// nothing from L2; the dots are then bound by the shared memory's 128 B a
// clock (the 128 KB of W and 16 warps x 8 KB of h), ~1.2 us a step, against
// 33.6 MB from L2 a step before. At B = 16 the FMAs bound a step (268 M a
// step, ~8 us at the fp32 peak), beside 64 KB a CTA still read from L2 each
// pass of 8 rows. PERF.md has the measured split of a step
// (kernels/lstm_costs.py).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "lstm_common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRegQuads = 16;  // float4 quads of W a thread holds in registers
constexpr int kPairs = 4;  // pairs of h's words a thread loads at once
constexpr int kBackoffNs = 64;  // between two reads of a word not yet written
#ifdef AEC_COUNTER
constexpr int kTagRows = 0;
#else
constexpr int kTagRows = 8;  // up to this many rows a group, h's words are waited on one by one
#endif

struct LstmArgs {
  const float* __restrict__ xp;   // (G, R, T, 4H): the projection with both biases
  const float4* __restrict__ wp;  // (ctas, npos CW, kThreads): the quads of each thread
  float* ys;                      // (G, R, T, H)
  float* saved;                   // (G, R, T, 5H): each step's i, f, g, o and c, where SAVE
  unsigned long long* hbuf;       // (2, G, R, Hp) words: h's bits, the step it is for; zero
  int rows, t_steps, hidden, hp, units, nchunk, npos, jreg, jsm;
};

// shared memory of one CTA (floats): W's shared quads, h, the gates' sums, c
struct LstmSmem {
  size_t ws, hs, pre, cs, total;
};

__host__ __device__ inline LstmSmem lstm_smem(int rows, int hp, int units, int cw, int jsm) {
  LstmSmem s;
  s.ws = 0;                                             // (jsm CW, kThreads) quads
  s.hs = s.ws + size_t(jsm) * cw * kThreads * 4;        // (R, Hp)
  s.pre = s.hs + size_t(rows) * hp;                     // (R, 16 CW)
  s.cs = s.pre + size_t(rows) * kWarps * cw;            // (R, U)
  s.total = s.cs + size_t(rows) * units;
  return s;
}

// h's words: the low half h's bits, the high half the step it is for,
// written and read whole, so a word that carries step t carries its h
__device__ __forceinline__ ulonglong2 load_words(const unsigned long long* p) {
  ulonglong2 v;
  asm volatile("ld.relaxed.gpu.global.v2.b64 {%0, %1}, [%2];" : "=l"(v.x), "=l"(v.y) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_word(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// CW columns a warp (a power of two), RT rows a pass (CW RT <= 32); SAVE:
// each cell's thread also writes its step's activated gates and c for the
// backward (K9b, lstm_bwd.cu), the arithmetic unchanged
template <int CW, int RT, bool SAVE>
__global__ void __launch_bounds__(kThreads, 1) lstm_kernel(LstmArgs a) {
  extern __shared__ float4 smem_raw[];
  constexpr int JR = kRegQuads / CW;  // positions a lane can hold in registers
  constexpr int V = CW * RT, M = V >= 32 ? 5 : V >= 16 ? 4 : V >= 8 ? 3 : V >= 4 ? 2 : V >= 2 ? 1 : 0;
  const int R = a.rows, H = a.hidden, Hp = a.hp, U = a.units, T = a.t_steps;
  const int npos = a.npos, jreg = a.jreg, jsm = a.jsm, hp4 = Hp / 4, cols = kWarps * CW;
  const int G = gridDim.x / a.nchunk, g = blockIdx.x / a.nchunk, chunk = blockIdx.x % a.nchunk;
  const int u0 = chunk * U, nu = min(U, H - u0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const LstmSmem lay = lstm_smem(R, Hp, U, CW, jsm);
  float* base = reinterpret_cast<float*>(smem_raw);
  float4* ws = reinterpret_cast<float4*>(base + lay.ws);
  float* hs = base + lay.hs;
  const float4* hs4 = reinterpret_cast<const float4*>(hs);
  float* pre = base + lay.pre;
  float* cs = base + lay.cs;
  const float4* w = a.wp + size_t(blockIdx.x) * npos * CW * kThreads + tid;
  // past kTagRows rows (each CTA then reads 8 R H bytes of words a step),
  // one counter a group: the CTAs wait until all of the group's have added
  // one for the step, then read the words once
  const bool counted = R > kTagRows;
  unsigned* counter = reinterpret_cast<unsigned*>(a.hbuf + size_t(2) * G * R * Hp) + g;

  // once: W's quads on chip, c zero
  float4 wr[JR > 0 ? JR : 1][CW];
#pragma unroll
  for (int j = 0; j < JR; ++j)
#pragma unroll
    for (int i = 0; i < CW; ++i)
      wr[j][i] = j < jreg ? w[size_t(j * CW + i) * kThreads] : float4{};
  for (int q = 0; q < jsm * CW; ++q) ws[q * kThreads + tid] = w[size_t(jreg * CW + q) * kThreads];
  for (int i = tid; i < R * U; i += kThreads) cs[i] = 0.f;

  for (int t = 0; t < T; ++t) {
    // this thread's first cell's inputs, which do not wait for h
    float xg[4] = {0.f, 0.f, 0.f, 0.f};
    if (tid < R * nu) {
      const int r = tid / nu, j = tid - r * nu;
      const float* x = a.xp + ((size_t(g) * R + r) * T + t) * 4 * H + u0 + j;
#pragma unroll
      for (int gt = 0; gt < 4; ++gt) xg[gt] = x[gt * H];
    }
    if (counted) {
      if (t > 0 && tid == 0) {
        while (load_acquire(counter) < unsigned(a.nchunk) * t) {
        }
      }
      __syncthreads();
    }
    // the group's h(t-1), each word once it carries step t (past L1: other
    // CTAs wrote them), kPairs pairs of words in flight a thread; the padding
    // past H has no writer and reads as zero
    const unsigned long long* h_prev = a.hbuf + (size_t(t & 1) * G + g) * R * Hp;
    for (int p0 = tid; p0 < R * Hp / 2; p0 += kThreads * kPairs) {
      ulonglong2 v[kPairs];
#pragma unroll
      for (int q = 0; q < kPairs; ++q)
        if (p0 + q * kThreads < R * Hp / 2) v[q] = load_words(h_prev + 2 * (p0 + q * kThreads));
#pragma unroll
      for (int q = 0; q < kPairs; ++q) {
        const int i = 2 * (p0 + q * kThreads), k = i % Hp;
        if (i >= R * Hp) break;
        while ((k < H && unsigned(v[q].x >> 32) != unsigned(t)) ||
               (k + 1 < H && unsigned(v[q].y >> 32) != unsigned(t))) {
          __nanosleep(kBackoffNs);
          v[q] = load_words(h_prev + i);
        }
        hs[i] = k < H ? __uint_as_float(unsigned(v[q].x)) : 0.f;
        hs[i + 1] = k + 1 < H ? __uint_as_float(unsigned(v[q].y)) : 0.f;
      }
    }
    __syncthreads();

    // lane l sums its columns over quads l, l + 32, ... of h (registers,
    // shared memory, L2), RT rows a pass; the warp sums over its lanes
    for (int r0 = 0; r0 < R; r0 += RT) {
      float acc[V];
#pragma unroll
      for (int i = 0; i < V; ++i) acc[i] = 0.f;
#ifndef AEC_NO_DOTS
#pragma unroll
      for (int j = 0; j < JR; ++j)
        if (j < jreg && lane + 32 * j < hp4) fma_pos<CW, RT>(wr[j], hs4, hp4, r0, R, lane + 32 * j, acc);
      for (int j = jreg; j < jreg + jsm && lane + 32 * j < hp4; ++j) {
        float4 wv[CW];
#pragma unroll
        for (int i = 0; i < CW; ++i) wv[i] = ws[((j - jreg) * CW + i) * kThreads + tid];
        fma_pos<CW, RT>(wv, hs4, hp4, r0, R, lane + 32 * j, acc);
      }
#ifndef AEC_NO_L2
      for (int j = jreg + jsm; j < npos && lane + 32 * j < hp4; ++j) {
        float4 wv[CW];
#pragma unroll
        for (int i = 0; i < CW; ++i) wv[i] = __ldg(w + size_t(j * CW + i) * kThreads);
        fma_pos<CW, RT>(wv, hs4, hp4, r0, R, lane + 32 * j, acc);
      }
#endif
#endif
      Scatter<V, 16>::run(acc, lane);
      const int idx = lane >> (5 - M), i = idx / RT, r = idx - i * RT;
      if ((lane & ((1 << (5 - M)) - 1)) == 0 && r0 + r < R)
        pre[(r0 + r) * cols + warp * CW + i] = acc[0];
    }
    __syncthreads();

    // the gates of the own units, h_t out
    unsigned long long* h_next = a.hbuf + (size_t((t + 1) & 1) * G + g) * R * Hp;
    for (int i = tid; i < R * nu; i += kThreads) {
      const int r = i / nu, j = i - r * nu;
      float x[4], p[4];
#pragma unroll
      for (int gt = 0; gt < 4; ++gt) {
        x[gt] = i == tid ? xg[gt] : a.xp[((size_t(g) * R + r) * T + t) * 4 * H + gt * H + u0 + j];
        p[gt] = pre[r * cols + gt * U + j];
      }
      const float ig = sigmoid_f(x[0] + p[0]);
      const float fg = sigmoid_f(x[1] + p[1]);
      const float gg = tanhf(x[2] + p[2]);
      const float og = sigmoid_f(x[3] + p[3]);
      const float c = fg * cs[r * U + j] + ig * gg;
      cs[r * U + j] = c;
      const float h = og * tanhf(c);
      store_word(h_next + r * Hp + u0 + j,
                 (static_cast<unsigned long long>(t + 1) << 32) | __float_as_uint(h));
      a.ys[((size_t(g) * R + r) * T + t) * H + u0 + j] = h;
      if constexpr (SAVE) {
        float* sv = a.saved + ((size_t(g) * R + r) * T + t) * 5 * H + u0 + j;
        sv[0] = ig;
        sv[H] = fg;
        sv[2 * H] = gg;
        sv[3 * H] = og;
        sv[4 * H] = c;
      }
    }
#ifdef AEC_GRID_SYNC
    cooperative_groups::this_grid().sync();
#endif
    if (counted) {
      __syncthreads();
      if (tid == 0) {
        __threadfence();  // the CTA's words of h(t) before its count
        atomicAdd(counter, 1u);
      }
    }
  }
}

template <int CW, int RT>
cudaError_t lstm_launch(const LstmArgs& a, int ctas, size_t smem, int device,
                        cudaStream_t stream) {
  auto kernel = a.saved ? lstm_kernel<CW, RT, true> : lstm_kernel<CW, RT, false>;
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
  LstmArgs args = a;
  void* params[] = {&args};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(ctas),
                                    dim3(kThreads), params, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// rows a pass: the smallest power of two >= R, at most 8 and 32 / CW
template <int CW>
cudaError_t lstm_launch_cw(const LstmArgs& a, int ctas, size_t smem, int device,
                           cudaStream_t stream) {
  constexpr int cap = 32 / CW < 8 ? 32 / CW : 8;
  const int r = a.rows;
  if (r <= 1) return lstm_launch<CW, 1>(a, ctas, smem, device, stream);
  if (r <= 2 || cap < 4) return lstm_launch<CW, (cap < 2 ? cap : 2)>(a, ctas, smem, device, stream);
  if (r <= 4 || cap < 8) return lstm_launch<CW, (cap < 4 ? cap : 4)>(a, ctas, smem, device, stream);
  return lstm_launch<CW, cap>(a, ctas, smem, device, stream);
}

}  // namespace

// the float4 quads a thread holds in registers (the wrapper packs for it)
extern "C" int aec_lstm_reg_quads() { return kRegQuads; }

// xp (G, R, T, 4H) fp32; wp (ctas, npos CW, 512) float4, W_hh^T packed by
// kernels/lstm.py pack_grouped; hbuf (2, G, R, hp) zeroed words; ys (G, R,
// T, H); saved (G, R, T, 5H) or null (no saving). All contiguous; the plan
// (units, nchunk, cw, npos, jreg, jsm) from grouped_plan.
extern "C" int aec_lstm(const float* xp, const void* wp, void* hbuf, float* ys, float* saved,
                        int groups, int rows, int t_steps, int hidden, int hp, int units,
                        int nchunk, int cw, int npos, int jreg, int jsm, int device,
                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (hp % 4 != 0 || hp < hidden || nchunk * units < hidden || 4 * units > kWarps * cw ||
      32 * npos * 4 < hp || jreg > kRegQuads / cw || jreg + jsm > npos ||
      (jreg < kRegQuads / cw && jreg < npos))
    return cudaErrorInvalidValue;
  if (t_steps == 0 || rows == 0) return cudaSuccess;
  const int ctas = groups * nchunk;
  const size_t smem = lstm_smem(rows, hp, units, cw, jsm).total * sizeof(float);
  const LstmArgs a{xp, static_cast<const float4*>(wp), ys, saved,
                   static_cast<unsigned long long*>(hbuf), rows, t_steps, hidden, hp, units,
                   nchunk, npos, jreg, jsm};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cw) {
    case 1: return lstm_launch_cw<1>(a, ctas, smem, device, s);
    case 2: return lstm_launch_cw<2>(a, ctas, smem, device, s);
    case 4: return lstm_launch_cw<4>(a, ctas, smem, device, s);
    case 8: return lstm_launch_cw<8>(a, ctas, smem, device, s);
    case 16: return lstm_launch_cw<16>(a, ctas, smem, device, s);
    default: return cudaErrorInvalidValue;
  }
}

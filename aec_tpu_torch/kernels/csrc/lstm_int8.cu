// Kernel K10: the int8 LSTM recurrence on one persistent grid, W_hh's codes
// held on chip across the time loop.
//
// Replaces aec_tpu/kernels/pallas_lstm.py:237 lstm_int8_fused (pallas_call
// at :299, body _int8_kernel at :187-231): W_hh quantized per row to int8,
// h carried as int8 at the fixed scale 127, an s8 x s8 -> s32 dot per step,
// dequantized by one multiply per gate row, c in fp32. The input projection
// (x W_ih^T + b_ih) stays one matmul outside (ops/lstm.py).
//
// Numerics: the same operations as the plain loop (ops/lstm.py, K10's plain
// version), in its order and with its roundings: the int32 sum is exact (as
// the plain loop's float64 one is, whatever the order of its terms) and
// converts to fp32 once (__int2float_rn); gates = (xp + acc * out_scale) +
// b_hh; c' = sigmoid(f) c + sigmoid(i) tanh(g); h = sigmoid(o) tanh(c'); the
// code of h is rint(clip(h * 127, -127, 127)), rint rounding half to even as
// torch.round does. Every product and sum is written with __fmul_rn /
// __fadd_rn, so nvcc cannot contract one into an FMA (which rounds once
// where the plain loop rounds twice). The grid walks exactly T steps over
// exactly B rows.
//
// Design. The hidden units are split over one persistent grid, U units per
// CTA (about one CTA per SM; U a multiple of 4), each CTA owning its units'
// 4 gate rows so that the cell update stays local. A row's 16-code chunks lie
// in three places, chosen once per codes tensor by the wrapper
// (kernels/lstm_int8.py int8_plan / pack_int8, which also model it for the
// CPU tests):
//   - registers: warp w owns row slots w, w + 16, ... (RPW slots, RPW a power
//     of two), lane l holds chunks l, l + 32, ..., CR = kRegQuads / RPW of
//     them per slot, loaded before the time loop (a fully unrolled dot over
//     a fixed per-thread array, so the indices are compile-time);
//   - shared memory: the next ksm chunks of every row, loaded before the time
//     loop, as many as fit beside h's codes and the small per-unit buffers;
//   - L2: the rest, read every step, two rows' loads in flight a lane (more
//     spill registers and run slower); nothing else large passes through L2
//     in a step (xp 64 KB, ys 16 KB at B = 1).
// Per step a lane walks its chunk positions and, for each, loads h's chunk
// from shared memory once and dots it against the RPW rows of its warp, so
// h is read once per warp and position, not once per row. The int32 sums
// reduce over the warp with shuffles, the cells update in shared memory.
//
// h's exchange is its own barrier: h's codes travel in 64-bit words, 4 codes
// and the step they are for, each stored and loaded whole (relaxed, at gpu
// scope), so a CTA needs no fence and no counter: it reads each word of h(t)
// as soon as the word says t + 1, backing off 64 ns between reads. Ping-pong
// buffers make this safe: a CTA overwrites a word of step t only after it
// has read every word of step t + 1, which its writer stored after reading
// step t's. The cooperative launch keeps the grid co-resident. (Measured on
// the card against cooperative groups' grid barrier and against a counter
// in device memory, kernels/lstm_costs.py: both slower.)
//
// What bounds it. The function's own work is small: each input read once
// (the codes 67 MB, xp 34 MB at T = 513, B = 1, H = 4096) and 34 G int8
// MACs, ~0.035 ms on the card. A step is serial: h's 4 KB of codes from L2
// into every CTA, the dots, the cells, the words of h(t) out. At H = 4096 a
// CTA owns U = 32 units, 128 rows x 4096 codes = 512 KB, more than an SM
// holds: 512 threads x 16 int4 of codes in registers (128 KB: row slots 8, 2
// chunks a slot, the first 1024 codes of each row) and 110 chunks a row in
// shared memory (220 KB of the 227 KB, beside 6.6 KB of h's codes and
// buffers) leave 82 chunks a row (1312 codes, 164 KB a CTA, 21 MB over the
// grid) to read from L2 every step, ~3-4 us at the L2's ~5-7 TB/s: the
// bound of this design, against ~20 us for the whole 67 MB from HBM.
// PERF.md has the measured split of a step (kernels/lstm_costs.py).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRegQuads = 16;  // 16-code chunks a thread holds in registers
constexpr int kPairs = 2;       // pairs of h's words a thread loads at once
constexpr int kBackoffNs = 64;  // between two reads of a word not yet written

struct Int8Args {
  const float* __restrict__ xp;     // (B, T, 4H): x W_ih^T + b_ih
  const int4* __restrict__ wreg;    // (ctas, kRegQuads, kThreads): the register chunks
  const int4* __restrict__ wrest;   // (ctas, RS, nrest): shared-memory chunks, then L2 chunks
  const float* __restrict__ scale;  // (4H): row scale / 127
  const float* __restrict__ b_hh;   // (4H)
  const float* __restrict__ c0;     // (B, H)
  unsigned long long* hq;           // (2, B, Hp / 4) words: 4 codes of h, the step they are for
  float* ys;                        // (B, T, H)
  float* c_out;                     // (B, H)
  int b, t_steps, h, hp, units, rs, kreg, nrest, ksm;
};

// shared memory of one CTA, each part 16-byte aligned
struct Int8Smem {
  size_t ws, hq, dots, xs, cs, sc, bh, total;
};

__host__ __device__ inline size_t round16(size_t n) { return (n + 15) / 16 * 16; }

__host__ __device__ inline Int8Smem int8_smem(int b, int hp, int units, int rs, int ksm) {
  Int8Smem s;
  s.ws = 0;                                               // (RS, ksm) chunks
  s.hq = s.ws + size_t(rs) * ksm * 16;                    // (B, Hp) codes of h
  s.dots = s.hq + size_t(b) * hp;                         // (B, 4U) int32 sums
  s.xs = s.dots + round16(size_t(b) * 4 * units * 4);     // (B, 4U) the cells' xp
  s.cs = s.xs + round16(size_t(b) * 4 * units * 4);       // (B, U) c
  s.sc = s.cs + round16(size_t(b) * units * 4);           // (4U) row scales
  s.bh = s.sc + round16(size_t(4) * units * 4);           // (4U) b_hh
  s.total = s.bh + round16(size_t(4) * units * 4);
  return s;
}

__device__ __forceinline__ float sigmoid_rn(float x) {
  return __fdiv_rn(1.f, __fadd_rn(1.f, expf(-x)));
}

__device__ __forceinline__ int dot16(const int4 w, const int4 h, int acc) {
  acc = __dp4a(w.x, h.x, acc);
  acc = __dp4a(w.y, h.y, acc);
  acc = __dp4a(w.z, h.z, acc);
  return __dp4a(w.w, h.w, acc);
}

// h's words: the low half 4 codes, the high half the step they are for,
// written and read whole, so a word that carries step t carries its codes
__device__ __forceinline__ ulonglong2 load_words(const unsigned long long* p) {
  ulonglong2 v;
  asm volatile("ld.relaxed.gpu.global.v2.b64 {%0, %1}, [%2];" : "=l"(v.x), "=l"(v.y) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_word(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// h's chunk j of rows b0 .. b0 + BT - 1 (zero past B)
template <int BT>
__device__ __forceinline__ void load_h(const int4* hq4, int nk16, int B, int b0, int j,
                                       int4 (&hv)[BT]) {
#pragma unroll
  for (int q = 0; q < BT; ++q)
    hv[q] = b0 + q < B ? hq4[(b0 + q) * nk16 + j] : make_int4(0, 0, 0, 0);
}

// RPW row slots a warp (a power of two, the codes of the register part held
// in registers), or RPW = 0: any number of slots, no codes in registers;
// BT rows of h at a time
template <int RPW, int BT>
__global__ void __launch_bounds__(kThreads, 1) lstm_int8_kernel(Int8Args a) {
  extern __shared__ int4 smem_raw[];
  const int B = a.b, T = a.t_steps, H = a.h, Hp = a.hp, U = a.units, RS = a.rs;
  const int nk16 = Hp / 16, nw = Hp / 4, kreg = a.kreg, nrest = a.nrest, ksm = a.ksm;
  const int u0 = blockIdx.x * U, nu = min(U, H - u0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Int8Smem lay = int8_smem(B, Hp, U, RS, ksm);
  char* base = reinterpret_cast<char*>(smem_raw);
  int4* ws = reinterpret_cast<int4*>(base + lay.ws);
  int8_t* hq_s = reinterpret_cast<int8_t*>(base + lay.hq);
  const int4* hq4 = reinterpret_cast<const int4*>(hq_s);
  int* dots = reinterpret_cast<int*>(base + lay.dots);
  float* xs = reinterpret_cast<float*>(base + lay.xs);
  float* cs = reinterpret_cast<float*>(base + lay.cs);
  float* sc_s = reinterpret_cast<float*>(base + lay.sc);
  float* bh_s = reinterpret_cast<float*>(base + lay.bh);
  const int4* rest = a.wrest + size_t(blockIdx.x) * RS * nrest;
#ifdef AEC_L2_HOT
  const int4* l2 = a.wrest;  // every CTA streams CTA 0's chunks: L2-resident for certain
#else
  const int4* l2 = rest;
#endif

  // once: the codes on chip, the rows' scales and biases, c0
  constexpr int CR = RPW > 0 ? kRegQuads / RPW : 0;
  constexpr int LG = RPW < 2 ? 1 : 2;  // rows whose L2 chunks load together
  int4 wr[RPW > 0 ? kRegQuads : 1];
  if constexpr (RPW > 0) {
#pragma unroll
    for (int i = 0; i < kRegQuads; ++i)
      wr[i] = a.wreg[(size_t(blockIdx.x) * kRegQuads + i) * kThreads + tid];
  }
  for (int i = tid; i < RS * ksm; i += kThreads) {
    const int r = i / ksm, j = i - r * ksm;
    ws[i] = rest[size_t(r) * nrest + j];
  }
  for (int i = tid; i < 4 * U; i += kThreads) {
    const int g = i / U, j = i - g * U;
    sc_s[i] = j < nu ? a.scale[g * H + u0 + j] : 0.f;
    bh_s[i] = j < nu ? a.b_hh[g * H + u0 + j] : 0.f;
  }
  for (int i = tid; i < B * nu; i += kThreads) {
    const int b = i / nu, j = i - b * nu;
    cs[b * U + j] = a.c0[size_t(b) * H + u0 + j];
  }

  for (int t = 0; t < T; ++t) {
    // this thread's first cell's inputs, which do not wait for h
    if (tid < B * nu) {
      const int b = tid / nu, j = tid - b * nu;
      const float* x = a.xp + (size_t(b) * T + t) * 4 * H + u0 + j;
#pragma unroll
      for (int g = 0; g < 4; ++g) xs[b * 4 * U + g * U + j] = x[g * H];
    }
    // h(t-1)'s codes, each word once it carries step t (past L1: other CTAs
    // wrote them), kPairs pairs of words in flight a thread; the padding past
    // H has no writer and reads as zero
    const unsigned long long* src = a.hq + size_t(t & 1) * B * nw;
    for (int p0 = tid; p0 < B * nw / 2; p0 += kThreads * kPairs) {
      ulonglong2 v[kPairs];
#pragma unroll
      for (int q = 0; q < kPairs; ++q)
        if (p0 + q * kThreads < B * nw / 2) v[q] = load_words(src + 2 * (p0 + q * kThreads));
#pragma unroll
      for (int q = 0; q < kPairs; ++q) {
        const int i = 2 * (p0 + q * kThreads), b = i / nw, w = i - b * nw;
        if (i >= B * nw) break;
        while ((4 * w < H && unsigned(v[q].x >> 32) != unsigned(t)) ||
               (4 * w + 4 < H && unsigned(v[q].y >> 32) != unsigned(t))) {
          __nanosleep(kBackoffNs);
          v[q] = load_words(src + i);
        }
        int* dst = reinterpret_cast<int*>(hq_s + size_t(b) * Hp) + w;
        dst[0] = 4 * w < H ? int(unsigned(v[q].x)) : 0;
        dst[1] = 4 * w + 4 < H ? int(unsigned(v[q].y)) : 0;
      }
    }
    __syncthreads();

    // the exact int32 dots of the CTA's rows
    if constexpr (RPW > 0) {
      for (int b0 = 0; b0 < B; b0 += BT) {
        int acc[RPW][BT];
#pragma unroll
        for (int rr = 0; rr < RPW; ++rr)
#pragma unroll
          for (int q = 0; q < BT; ++q) acc[rr][q] = 0;
#ifndef AEC_NO_DOTS
#pragma unroll
        for (int c = 0; c < CR; ++c) {  // the register part
          const int j = c * 32 + lane;
          if (j < kreg) {
            int4 hv[BT];
            load_h<BT>(hq4, nk16, B, b0, j, hv);
#pragma unroll
            for (int rr = 0; rr < RPW; ++rr)
#pragma unroll
              for (int q = 0; q < BT; ++q) acc[rr][q] = dot16(wr[rr * CR + c], hv[q], acc[rr][q]);
          }
        }
        for (int j = kreg + lane; j < kreg + ksm; j += 32) {  // shared memory
          int4 hv[BT];
          load_h<BT>(hq4, nk16, B, b0, j, hv);
#pragma unroll
          for (int rr = 0; rr < RPW; ++rr) {
            const int4 w = ws[(rr * kWarps + warp) * ksm + j - kreg];
#pragma unroll
            for (int q = 0; q < BT; ++q) acc[rr][q] = dot16(w, hv[q], acc[rr][q]);
          }
        }
#ifndef AEC_NO_L2
        for (int j = kreg + ksm + lane; j < nk16; j += 32) {  // L2, LG rows' loads in flight
#pragma unroll
          for (int r0 = 0; r0 < RPW; r0 += LG) {
            int4 w[LG];
#pragma unroll
            for (int r = 0; r < LG; ++r)
              w[r] = __ldg(l2 + size_t((r0 + r) * kWarps + warp) * nrest + j - kreg);
            int4 hv[BT];
            load_h<BT>(hq4, nk16, B, b0, j, hv);
#pragma unroll
            for (int r = 0; r < LG; ++r)
#pragma unroll
              for (int q = 0; q < BT; ++q) acc[r0 + r][q] = dot16(w[r], hv[q], acc[r0 + r][q]);
          }
        }
#endif
#endif
#pragma unroll
        for (int rr = 0; rr < RPW; ++rr) {
          const int rl = rr * kWarps + warp;
#pragma unroll
          for (int q = 0; q < BT; ++q) {
            int v = acc[rr][q];
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
            if (lane == 0 && rl < 4 * U && b0 + q < B) dots[(b0 + q) * 4 * U + rl] = v;
          }
        }
      }
    } else {
      for (int rl = warp; rl < RS; rl += kWarps) {
        for (int b0 = 0; b0 < B; b0 += BT) {
          int acc[BT];
#pragma unroll
          for (int q = 0; q < BT; ++q) acc[q] = 0;
#ifndef AEC_NO_DOTS
          for (int j = lane; j < nk16; j += 32) {
            int4 hv[BT];
            load_h<BT>(hq4, nk16, B, b0, j, hv);
            const int4 w = j < ksm ? ws[rl * ksm + j] : __ldg(l2 + size_t(rl) * nrest + j);
#pragma unroll
            for (int q = 0; q < BT; ++q) acc[q] = dot16(w, hv[q], acc[q]);
          }
#endif
#pragma unroll
          for (int q = 0; q < BT; ++q) {
            int v = acc[q];
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
            if (lane == 0 && rl < 4 * U && b0 + q < B) dots[(b0 + q) * 4 * U + rl] = v;
          }
        }
      }
    }
    __syncthreads();

    // the cells of the own units: h(t) out, its codes over h(t-1)'s, now
    // read, in shared memory
    for (int i = tid; i < B * nu; i += kThreads) {
      const int b = i / nu, j = i - b * nu;
      float x[4];
#pragma unroll
      for (int g = 0; g < 4; ++g)
        x[g] = i == tid ? xs[b * 4 * U + g * U + j] : a.xp[(size_t(b) * T + t) * 4 * H + g * H + u0 + j];
      const int* d = dots + b * 4 * U;
      float p[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const int r = g * U + j;
        p[g] = __fadd_rn(__fadd_rn(x[g], __fmul_rn(__int2float_rn(d[r]), sc_s[r])), bh_s[r]);
      }
      const float ig = sigmoid_rn(p[0]), fg = sigmoid_rn(p[1]);
      const float gg = tanhf(p[2]), og = sigmoid_rn(p[3]);
      const float c = __fadd_rn(__fmul_rn(fg, cs[b * U + j]), __fmul_rn(ig, gg));
      const float h = __fmul_rn(og, tanhf(c));
      cs[b * U + j] = c;
      a.ys[(size_t(b) * T + t) * H + u0 + j] = h;
      hq_s[size_t(b) * Hp + u0 + j] =
          static_cast<int8_t>(__float2int_rn(fminf(fmaxf(__fmul_rn(h, 127.f), -127.f), 127.f)));
      if (t == T - 1) a.c_out[size_t(b) * H + u0 + j] = c;
    }
    __syncthreads();
    // the own words of h(t), for step t + 1 (U is a multiple of 4)
    unsigned long long* dst = a.hq + size_t((t + 1) & 1) * B * nw;
    for (int i = tid; i < B * (U / 4); i += kThreads) {
      const int b = i / (U / 4), w = u0 / 4 + i - b * (U / 4);
      if (4 * w < H) {
        const unsigned codes = reinterpret_cast<const unsigned*>(hq_s + size_t(b) * Hp)[w];
        store_word(dst + size_t(b) * nw + w,
                   (static_cast<unsigned long long>(t + 1) << 32) | codes);
      }
    }
    __syncthreads();  // the words read from shared memory before the next step's overwrite them
#ifdef AEC_GRID_SYNC
    cooperative_groups::this_grid().sync();
#endif
  }
}

template <int RPW, int BT>
cudaError_t int8_launch(const Int8Args& a, int ctas, size_t smem, int device,
                        cudaStream_t stream) {
  auto kernel = lstm_int8_kernel<RPW, BT>;
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
  Int8Args args = a;
  void* params[] = {&args};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(ctas),
                                    dim3(kThreads), params, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// rows of h a pass: the smallest power of two >= B, at most 4; one at RPW >=
// 8, whose accumulators and codes fill the registers
template <int RPW>
cudaError_t int8_launch_rpw(const Int8Args& a, int ctas, size_t smem, int device,
                            cudaStream_t stream) {
  if constexpr (RPW >= 8) {
    return int8_launch<RPW, 1>(a, ctas, smem, device, stream);
  } else {
    if (a.b >= 3) return int8_launch<RPW, 4>(a, ctas, smem, device, stream);
    if (a.b == 2) return int8_launch<RPW, 2>(a, ctas, smem, device, stream);
    return int8_launch<RPW, 1>(a, ctas, smem, device, stream);
  }
}

}  // namespace

// the 16-code chunks a thread holds in registers (the wrapper packs for it)
extern "C" int aec_lstm_int8_reg_quads() { return kRegQuads; }

// xp (B, T, 4H) fp32; wreg (ctas, kRegQuads, kThreads) and wrest (ctas, rs,
// nrest) int4 chunks of W_hh's codes (kernels/lstm_int8.py pack_int8);
// scale, b_hh (4H) fp32; c0 (B, H) fp32; hq (2, B, hp / 4) words, zero but
// for h0's codes in [0]'s low halves; ys (B, T, H), c_out (B, H) fp32. All
// contiguous; B, T, H >= 1; the plan (units, a multiple of 4, rpw, rs,
// kreg, nrest, ksm) from int8_plan.
extern "C" int aec_lstm_int8(const float* xp, const void* wreg, const void* wrest,
                             const float* scale, const float* b_hh, const float* c0, void* hq,
                             float* ys, float* c_out, int b, int t_steps, int hidden, int hp,
                             int units, int rpw, int rs, int kreg, int nrest, int ksm, int device,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int ctas = (hidden + units - 1) / units;
  if (hp % 16 != 0 || hp < hidden || units % 4 != 0 || rs < 4 * units || rs % kWarps != 0 ||
      kreg + nrest != hp / 16 || ksm > nrest || (rpw > 0 && rs != rpw * kWarps) ||
      (rpw == 0 && kreg != 0))
    return cudaErrorInvalidValue;
  const size_t smem = int8_smem(b, hp, units, rs, ksm).total;
  const Int8Args a{xp, static_cast<const int4*>(wreg), static_cast<const int4*>(wrest), scale,
                   b_hh, c0, static_cast<unsigned long long*>(hq), ys, c_out, b, t_steps,
                   hidden, hp, units, rs, kreg, nrest, ksm};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (rpw) {
    case 0: return int8_launch_rpw<0>(a, ctas, smem, device, s);
    case 1: return int8_launch_rpw<1>(a, ctas, smem, device, s);
    case 2: return int8_launch_rpw<2>(a, ctas, smem, device, s);
    case 4: return int8_launch_rpw<4>(a, ctas, smem, device, s);
    case 8: return int8_launch_rpw<8>(a, ctas, smem, device, s);
    case 16: return int8_launch_rpw<16>(a, ctas, smem, device, s);
    default: return cudaErrorInvalidValue;
  }
}

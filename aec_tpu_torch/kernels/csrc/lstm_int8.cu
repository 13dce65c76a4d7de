// Kernel K10: the int8 LSTM recurrence on one persistent grid.
//
// Replaces aec_tpu/kernels/pallas_lstm.py:237 lstm_int8_fused (pallas_call
// at :299, body _int8_kernel at :187-231): W_hh quantized per row to int8,
// h carried as int8 at the fixed scale 127, an s8 x s8 -> s32 dot per step,
// dequantized by one multiply per gate row, c in fp32. The input projection
// (x W_ih^T + b_ih) stays one matmul outside (kernels/lstm_int8.py).
//
// Numerics: the same operations as the plain loop (ops/lstm.py, K10's plain
// version), in its order and with its roundings: the int32 sum is exact (as
// the plain loop's float64 one is) and converts to fp32 once
// (__int2float_rn); gates = (xp + acc * out_scale) + b_hh; c' = sigmoid(f) c
// + sigmoid(i) tanh(g); h = sigmoid(o) tanh(c'); the code of h is
// rint(clip(h * 127, -127, 127)), rint rounding half to even as torch.round
// does. Every product and sum is written with __fmul_rn / __fadd_rn, so nvcc
// cannot contract one into an FMA (which rounds once where the plain loop
// rounds twice). The TPU kernel's padded steps and rows do not exist here:
// the grid walks exactly T steps over exactly B rows.
//
// Design. W_hh's codes (4H x H int8, 67 MB at ATT-CCRN's H = 4096) fit
// neither a CTA's shared memory nor the 50 MB L2, so the hidden units are
// split over one persistent cooperative grid (about one CTA per SM); each
// CTA reads its units' 4 gate rows (the wrapper pads each row to a multiple
// of 16 codes) straight from device memory every step, 16 codes per lane
// per load, 8 loads in flight per lane, and dots them against h's codes in
// shared memory with __dp4a. h's codes go through a ping-pong buffer in
// device memory; one grid barrier per step.
//
// What bounds it. The function's own work is small: each input read once
// (the codes 67 MB, xp 34 MB at T = 513) and 34 G int8 MACs, ~0.035 ms on
// the card. This design re-reads all of W_hh's codes every step, mostly from
// HBM since they exceed the L2: at 3.35 TB/s that is ~20 us per step,
// ~10.3 ms per 513-frame utterance at B = 1, plus one grid barrier per step.
// Keeping the codes on chip across steps (shared memory and registers of
// 132 SMs hold ~64 MB) is the lever left for later.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kLoads = 8;  // 16-code loads in flight per lane

struct Int8Args {
  const float* __restrict__ xp;     // (B, T, 4H): x W_ih^T + b_ih
  const int8_t* __restrict__ wq;    // (4H, Hp): W_hh's codes, each row zero-padded to Hp
  const float* __restrict__ scale;  // (4H): row scale / 127
  const float* __restrict__ b_hh;   // (4H)
  const float* __restrict__ c0;     // (B, H)
  int8_t* hq;                       // (2, B, Hp): h's codes, [0] from h0, padding zero
  float* ys;                        // (B, T, H)
  float* c_out;                     // (B, H)
  int b, t_steps, h, hp, units;
};

__device__ __forceinline__ float sigmoid_rn(float x) {
  return __fdiv_rn(1.f, __fadd_rn(1.f, expf(-x)));
}

__host__ __device__ inline size_t int8_smem_bytes(int b, int hp, int units) {
  return size_t(b) * hp + size_t(b) * 4 * units * sizeof(float) + size_t(b) * units * sizeof(float);
}

inline cudaError_t int8_units(int hidden, int device, int* units) {
  int sms = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  *units = (hidden + sms - 1) / sms;
  return cudaSuccess;
}

template <int BT>
__global__ void __launch_bounds__(kThreads) lstm_int8_kernel(Int8Args a) {
  extern __shared__ int4 smem_raw[];
  const int B = a.b, T = a.t_steps, H = a.h, Hp = a.hp, U = a.units;
  const int u0 = blockIdx.x * U, nu = min(U, H - u0), nk16 = Hp / 16;
  int8_t* hq_s = reinterpret_cast<int8_t*>(smem_raw);           // (B, Hp)
  float* pre = reinterpret_cast<float*>(hq_s + size_t(B) * Hp);  // (B, 4U)
  float* cs = pre + size_t(B) * 4 * U;                           // (B, U)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  cg::grid_group grid = cg::this_grid();

  for (int i = tid; i < B * nu; i += blockDim.x) {
    const int b = i / nu, j = i - b * nu;
    cs[b * U + j] = a.c0[size_t(b) * H + u0 + j];
  }
  for (int t = 0; t < T; ++t) {
    // h(t-1)'s codes, past L1 (other CTAs wrote them)
    const int4* src = reinterpret_cast<const int4*>(a.hq + size_t(t & 1) * B * Hp);
    for (int i = tid; i < B * nk16; i += blockDim.x)
      reinterpret_cast<int4*>(hq_s)[i] = __ldcg(src + i);
    __syncthreads();

    // the own gate rows' exact int32 dots: one warp per row
    for (int rl = warp; rl < 4 * nu; rl += nwarps) {
      const int g = rl / nu, j = rl - g * nu, row = g * H + u0 + j;
      const int4* w = reinterpret_cast<const int4*>(a.wq + size_t(row) * Hp);
      for (int b0 = 0; b0 < B; b0 += BT) {
        int acc[BT];
#pragma unroll
        for (int q = 0; q < BT; ++q) acc[q] = 0;
        for (int k0 = 0; k0 < nk16; k0 += 32 * kLoads) {
          int4 wv[kLoads];
#pragma unroll
          for (int l = 0; l < kLoads; ++l) {
            const int idx = k0 + l * 32 + lane;
            wv[l] = idx < nk16 ? __ldg(w + idx) : make_int4(0, 0, 0, 0);
          }
#pragma unroll
          for (int q = 0; q < BT; ++q) {
            if (b0 + q < B) {
              const int4* hv = reinterpret_cast<const int4*>(hq_s + size_t(b0 + q) * Hp);
#pragma unroll
              for (int l = 0; l < kLoads; ++l) {
                const int idx = k0 + l * 32 + lane;
                if (idx < nk16) {
                  const int4 h4 = hv[idx];
                  acc[q] = __dp4a(wv[l].x, h4.x, acc[q]);
                  acc[q] = __dp4a(wv[l].y, h4.y, acc[q]);
                  acc[q] = __dp4a(wv[l].z, h4.z, acc[q]);
                  acc[q] = __dp4a(wv[l].w, h4.w, acc[q]);
                }
              }
            }
          }
        }
#pragma unroll
        for (int q = 0; q < BT; ++q)
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) acc[q] += __shfl_xor_sync(0xffffffffu, acc[q], o);
        if (lane == 0) {
          const float sc = a.scale[row], bh = a.b_hh[row];
#pragma unroll
          for (int q = 0; q < BT; ++q) {
            const int b = b0 + q;
            if (b < B) {
              const float x = a.xp[(size_t(b) * T + t) * 4 * H + row];
              pre[b * 4 * U + g * U + j] =
                  __fadd_rn(__fadd_rn(x, __fmul_rn(__int2float_rn(acc[q]), sc)), bh);
            }
          }
        }
      }
    }
    __syncthreads();

    // the cells of the own units: h(t) out, its code to the other buffer
    int8_t* next = a.hq + size_t((t + 1) & 1) * B * Hp;
    for (int i = tid; i < B * nu; i += blockDim.x) {
      const int b = i / nu, j = i - b * nu;
      const float* p = pre + b * 4 * U;
      const float ig = sigmoid_rn(p[j]), fg = sigmoid_rn(p[U + j]);
      const float gg = tanhf(p[2 * U + j]), og = sigmoid_rn(p[3 * U + j]);
      const float c = __fadd_rn(__fmul_rn(fg, cs[b * U + j]), __fmul_rn(ig, gg));
      const float h = __fmul_rn(og, tanhf(c));
      cs[b * U + j] = c;
      a.ys[(size_t(b) * T + t) * H + u0 + j] = h;
      next[size_t(b) * Hp + u0 + j] =
          static_cast<int8_t>(__float2int_rn(fminf(fmaxf(__fmul_rn(h, 127.f), -127.f), 127.f)));
      if (t == T - 1) a.c_out[size_t(b) * H + u0 + j] = c;
    }
    grid.sync();  // every code of h(t) written before any CTA loads them
  }
}

template <int BT>
cudaError_t int8_launch_bt(const Int8Args& a, int ctas, size_t smem, int device,
                           cudaStream_t stream) {
  auto kernel = lstm_int8_kernel<BT>;
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

}  // namespace

// shared memory of one CTA of the launch plan at this shape, bytes (-1 if
// the device cannot be queried)
extern "C" long long aec_lstm_int8_smem(int b, int hidden, int hp, int device) {
  int units = 0;
  if (int8_units(hidden, device, &units) != cudaSuccess) return -1;
  return static_cast<long long>(int8_smem_bytes(b, hp, units));
}

// xp (B, T, 4H) fp32; wq (4H, Hp) int8 with Hp a multiple of 16; scale,
// b_hh (4H) fp32; c0 (B, H) fp32; hq (2, B, Hp) int8 with h0's codes in [0]
// and zero padding; ys (B, T, H), c_out (B, H) fp32. All contiguous; B, T,
// H >= 1.
extern "C" int aec_lstm_int8(const float* xp, const int8_t* wq, const float* scale,
                             const float* b_hh, const float* c0, int8_t* hq, float* ys,
                             float* c_out, int b, int t_steps, int hidden, int hp, int device,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (hp % 16 != 0 || hp < hidden) return cudaErrorInvalidValue;
  int units = 0;
  err = int8_units(hidden, device, &units);
  if (err != cudaSuccess) return err;
  const int ctas = (hidden + units - 1) / units;
  const size_t smem = int8_smem_bytes(b, hp, units);
  const Int8Args a{xp, wq, scale, b_hh, c0, hq, ys, c_out, b, t_steps, hidden, hp, units};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b <= 1) return int8_launch_bt<1>(a, ctas, smem, device, s);
  if (b <= 2) return int8_launch_bt<2>(a, ctas, smem, device, s);
  if (b <= 4) return int8_launch_bt<4>(a, ctas, smem, device, s);
  return int8_launch_bt<8>(a, ctas, smem, device, s);
}

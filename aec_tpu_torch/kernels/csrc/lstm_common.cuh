// The dots and the warp reduction that K9 (lstm.cu) and K9b (lstm_bwd.cu)
// share: a lane's sums over its float4 quads of a staged vector against its
// columns' quads of W, then the warp's reduce-scatter.
#pragma once

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float sigmoid_f(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ float dot4(const float4 h, const float4 w, float acc) {
  acc = fmaf(h.x, w.x, acc);
  acc = fmaf(h.y, w.y, acc);
  acc = fmaf(h.z, w.z, acc);
  return fmaf(h.w, w.w, acc);
}

// the warp's sums of V = 2^m <= 32 values: rounds over lane bits 16, 8, ...,
// 1; while a lane holds n > 1 values it keeps the half its lane bit picks
// and adds the partner's copy of it, then it adds the partner's value. Lane
// l ends with value l >> (5 - m) summed over the 32 lanes, in the order of a
// tree whose first level pairs lanes l and l ^ 16.
template <int N, int O>
struct Scatter {
  template <int V>
  __device__ static __forceinline__ void run(float (&v)[V], int lane) {
    if constexpr (O > 0) {
      if constexpr (N > 1) {
        constexpr int h = N / 2;
        const bool up = lane & O;
#pragma unroll
        for (int i = 0; i < h; ++i) {
          const float send = up ? v[i] : v[i + h];
          const float keep = up ? v[i + h] : v[i];
          v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
        }
        Scatter<h, O / 2>::run(v, lane);
      } else {
        v[0] += __shfl_xor_sync(0xffffffffu, v[0], O);
        Scatter<1, O / 2>::run(v, lane);
      }
    }
  }
};

// RT rows' sums of CW columns against quad k4 of the staged rows (row r at
// hs4 + r hp4: h in K9, the gates' gradients in K9b), one quad of W a column
template <int CW, int RT>
__device__ __forceinline__ void fma_pos(const float4 (&w)[CW], const float4* hs4, int hp4, int r0,
                                        int R, int k4, float (&acc)[CW * RT]) {
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    if (r0 + r < R) {
      const float4 h = hs4[(r0 + r) * hp4 + k4];
#pragma unroll
      for (int i = 0; i < CW; ++i) acc[i * RT + r] = dot4(h, w[i], acc[i * RT + r]);
    }
  }
}

}  // namespace

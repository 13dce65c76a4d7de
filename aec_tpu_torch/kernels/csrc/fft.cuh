// CTA-wide real FFTs over shared memory, for the stage-1 FFT steps of K1,
// K12, K5 and K3 (stage1_fft.cuh), the analysis and synthesis phases of K2
// and the one-frame stage 2 of K3 and K4 (stage2_fft.cuh); and the same
// schedule run by one warp on one transform, for K6 / K7 (single_stream.cu).
//
// A real transform of length N = 2B is a complex FFT of length M = B over
// the even / odd samples packed as (re, im), and a split of its M outputs
// into the K = B + 1 bins of the real spectrum (and back for the inverse).
// The complex FFT is a Stockham auto-sort schedule: pass p of radix R reads
// element j + r M/R (j < M/R, r < R), multiplies it by the twiddle
// W_M^(r k M/(Ns R)) with k = j mod Ns, takes the R-point DFT in registers
// and writes element (j div Ns) Ns R + k + r Ns, where Ns is the product of
// the earlier radices; results come out in natural order. Each pass is one
// strided loop over (transform, butterfly) pairs of the CTA and one barrier,
// so a transform costs one barrier per radix (3 at B = 256: radices 8, 8, 4;
// 3 at B = 160: 8, 4, 5), and L transforms run side by side in the same
// passes. Radices 2, 3, 4, 5 and 8 are written out, so every B = 2^a 3^b 5^c
// runs; kernels/fft_plan.py builds the plan and the twiddle table (W_N^m for
// m in [0, M), float64 rounded to fp32) and holds a plain-torch model of
// this schedule that the CPU tests check.
//
// The first pass of a transform reads its input through a loader (a
// functor (transform, index) -> complex), so packing real input, zero
// halves and the inverse's pre-split cost no pass of their own; the forward
// split is done by whoever consumes the spectrum (fwd_split). The inverse
// drops the imaginary parts of bins 0 and K - 1, as np.fft.irfft and the
// dense inverse bases do.
#pragma once

#include "bl_common.cuh"

namespace aec {

constexpr int kMaxPasses = 12;  // kernels/fft_plan.py MAX_PASSES

// a radix plan read at run time (the host's)
struct RunPlan {
  int passes;
  int radix[kMaxPasses];
};

// a radix plan fixed at compile time
template <int... Rs>
struct FixedPlan {};

// complex element i of an array of interleaved (re, im) pairs
__device__ __forceinline__ float2& c2(SArr a, int i) {
  return reinterpret_cast<float2*>(aec_smem4)[a.off / 2 + i];
}

// complex element e of transform l in a work buffer of L transforms of M
// complex values each
__device__ __forceinline__ float2& elem(SArr buf, int l, int e, int M) {
  return c2(buf, l * M + e);
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }
__device__ __forceinline__ float2 csub(float2 a, float2 b) { return make_float2(a.x - b.x, a.y - b.y); }
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 cscale(float2 a, float s) { return make_float2(a.x * s, a.y * s); }

// a times -i (forward) or +i (inverse): the quarter turn of the transform's sign
template <bool kInv>
__device__ __forceinline__ float2 rot(float2 a) {
  return kInv ? make_float2(-a.y, a.x) : make_float2(a.y, -a.x);
}

// W_N^m for m in [0, N) from the table of W_N^m, m in [0, M)
// (W_N^(m + M) = -W_N^m); conjugated for the inverse
template <bool kInv>
__device__ __forceinline__ float2 twiddle(SArr tw, int m, int M) {
  float2 w = c2(tw, m < M ? m : m - M);
  if (m >= M) w = make_float2(-w.x, -w.y);
  if (kInv) w.y = -w.y;
  return w;
}

// ---------------------------------------------------------------- butterflies

template <int R, bool kInv>
struct Dft;

template <bool kInv>
struct Dft<2, kInv> {
  __device__ __forceinline__ static void run(float2* v) {
    const float2 a = v[0];
    v[0] = cadd(a, v[1]);
    v[1] = csub(a, v[1]);
  }
};

template <bool kInv>
struct Dft<4, kInv> {
  __device__ __forceinline__ static void run(float2* v) {
    const float2 t0 = cadd(v[0], v[2]), t1 = csub(v[0], v[2]);
    const float2 t2 = cadd(v[1], v[3]), t3 = rot<kInv>(csub(v[1], v[3]));
    v[0] = cadd(t0, t2);
    v[2] = csub(t0, t2);
    v[1] = cadd(t1, t3);
    v[3] = csub(t1, t3);
  }
};

template <bool kInv>
struct Dft<8, kInv> {
  __device__ __forceinline__ static void run(float2* v) {
    constexpr float h = 0.70710678118654752f;  // sqrt(1/2)
    float2 e[4] = {v[0], v[2], v[4], v[6]}, o[4] = {v[1], v[3], v[5], v[7]};
    Dft<4, kInv>::run(e);
    Dft<4, kInv>::run(o);
    // o[k] *= W_8^k
    o[1] = cscale(cadd(o[1], rot<kInv>(o[1])), h);
    o[2] = rot<kInv>(o[2]);
    o[3] = cscale(csub(rot<kInv>(o[3]), o[3]), h);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[k] = cadd(e[k], o[k]);
      v[k + 4] = csub(e[k], o[k]);
    }
  }
};

template <bool kInv>
struct Dft<3, kInv> {
  __device__ __forceinline__ static void run(float2* v) {
    constexpr float s = 0.86602540378443865f;  // sin(2 pi / 3)
    const float2 a = cadd(v[1], v[2]), b = cscale(rot<kInv>(csub(v[1], v[2])), s);
    const float2 m = csub(v[0], cscale(a, 0.5f));
    v[0] = cadd(v[0], a);
    v[1] = cadd(m, b);
    v[2] = csub(m, b);
  }
};

template <bool kInv>
struct Dft<5, kInv> {
  __device__ __forceinline__ static void run(float2* v) {
    constexpr float c1 = 0.30901699437494742f, c2_ = -0.80901699437494742f;  // cos(2 pi / 5), cos(4 pi / 5)
    constexpr float s1 = 0.95105651629515357f, s2 = 0.58778525229247313f;    // sin(2 pi / 5), sin(4 pi / 5)
    const float2 a1 = cadd(v[1], v[4]), b1 = csub(v[1], v[4]);
    const float2 a2 = cadd(v[2], v[3]), b2 = csub(v[2], v[3]);
    const float2 m1 = cadd(v[0], cadd(cscale(a1, c1), cscale(a2, c2_)));
    const float2 m2 = cadd(v[0], cadd(cscale(a1, c2_), cscale(a2, c1)));
    const float2 n1 = rot<kInv>(cadd(cscale(b1, s1), cscale(b2, s2)));
    const float2 n2 = rot<kInv>(csub(cscale(b1, s2), cscale(b2, s1)));
    v[0] = cadd(v[0], cadd(a1, a2));
    v[1] = cadd(m1, n1);
    v[4] = csub(m1, n1);
    v[2] = cadd(m2, n2);
    v[3] = csub(m2, n2);
  }
};

// ---------------------------------------------------------------- passes

// a work buffer of L transforms of M points each
struct BufSrc {
  SArr a;
  int m;
  __device__ __forceinline__ float2 operator()(int l, int i) const { return elem(a, l, i, m); }
};

// element i of transform l of a work buffer of M-point transforms, in
// natural order
struct NatDst {
  SArr a;
  int m;
  __device__ __forceinline__ float2& operator()(int l, int i) const { return elem(a, l, i, m); }
};

// Butterfly j of a Stockham pass of radix R over transform l of M points:
// src(l, i) -> dst(l, i), the twiddle of input r from tw(r, m) with
// m = 2 r k M / (Ns R) (W_2M^m).
template <int R, bool kInv, class Src, class Dst, class Tw>
__device__ __forceinline__ void butterfly(int M, int l, int j, int ns, const Src& src,
                                          const Dst& dst, const Tw& tw) {
  const int mr = M / R, span = ns * R, step = M / span, k = j % ns;
  float2 v[R];
#pragma unroll
  for (int r = 0; r < R; ++r) v[r] = src(l, j + r * mr);
  if (ns > 1) {
#pragma unroll
    for (int r = 1; r < R; ++r) v[r] = cmul(v[r], tw(r, 2 * r * k * step));
  }
  Dft<R, kInv>::run(v);
  const int d = (j / ns) * span + k;
#pragma unroll
  for (int r = 0; r < R; ++r) dst(l, d + r * ns) = v[r];
}

// One Stockham pass of radix R over L transforms of M = q.block points:
// src(l, i) -> work buffer dst. No barrier.
template <int R, bool kInv, class G, class Src>
__device__ __forceinline__ void fft_pass(const G& q, int L, int ns, const Src& src, SArr dst,
                                         SArr tw) {
  const int M = q.block, mr = M / R;
  for (int w = threadIdx.x; w < L * mr; w += kThreads) {
    const int l = w / mr;
    butterfly<R, kInv>(M, l, w - l * mr, ns, src, NatDst{dst, M},
                       [&](int, int m) { return twiddle<kInv>(tw, m, M); });
  }
}

template <bool kInv, class G, class Src>
__device__ __forceinline__ void fft_pass_any(int radix, const G& q, int L, int ns, const Src& src,
                                             SArr dst, SArr tw) {
  switch (radix) {
    case 8: fft_pass<8, kInv>(q, L, ns, src, dst, tw); break;
    case 4: fft_pass<4, kInv>(q, L, ns, src, dst, tw); break;
    case 2: fft_pass<2, kInv>(q, L, ns, src, dst, tw); break;
    case 5: fft_pass<5, kInv>(q, L, ns, src, dst, tw); break;
    default: fft_pass<3, kInv>(q, L, ns, src, dst, tw); break;
  }
}

template <bool kInv, class G, class Src, int R, int... Rs>
__device__ __forceinline__ SArr fft_fixed(const G& q, int L, int ns, const Src& src, SArr dst,
                                          SArr other, SArr tw) {
  fft_pass<R, kInv>(q, L, ns, src, dst, tw);
  __syncthreads();
  if constexpr (sizeof...(Rs) == 0) {
    return dst;
  } else {
    return fft_fixed<kInv, G, BufSrc, Rs...>(q, L, ns * R, BufSrc{dst, q.block}, other, dst, tw);
  }
}

// L complex FFTs of M = q.block points (unscaled; the inverse conjugates
// the twiddles): the first pass reads src and writes dst, later passes
// alternate between `other` and dst. Ends with a barrier; returns the
// buffer that holds the result. `src` may read `other`, never dst.
template <bool kInv, class G, class Src, int... Rs>
__device__ __forceinline__ SArr fft(const FixedPlan<Rs...>&, const G& q, int L, const Src& src,
                                    SArr dst, SArr other, SArr tw) {
  return fft_fixed<kInv, G, Src, Rs...>(q, L, 1, src, dst, other, tw);
}

template <bool kInv, class G, class Src>
__device__ __forceinline__ SArr fft(const RunPlan& p, const G& q, int L, const Src& src, SArr dst,
                                    SArr other, SArr tw) {
  fft_pass_any<kInv>(p.radix[0], q, L, 1, src, dst, tw);
  __syncthreads();
  int ns = p.radix[0];
  for (int i = 1; i < p.passes; ++i) {
    const SArr from = dst;
    dst = other;
    other = from;
    fft_pass_any<kInv>(p.radix[i], q, L, ns, BufSrc{from, q.block}, dst, tw);
    __syncthreads();
    ns *= p.radix[i];
  }
  return dst;
}

// ---------------------------------------------------------------- one warp's transforms

// The same schedule run by the 32 lanes of one warp on one transform (the
// single-stream kernels, single_stream.cu): a pass is a loop strided by the
// warp over its butterflies, and a __syncwarp takes the place of the CTA
// barrier, so a transform costs no __syncthreads. src(0, i) is read by the
// first pass; the buffers alternate as fft's do. One warp issues every
// instruction of its transform, so the transform is bound by its
// instruction count: on a fixed plan (the default geometry) each lane holds
// the twiddles of its butterflies in registers (WarpTw, loaded once), and
// the index arithmetic folds to constants; on a run-time plan they come
// from the table.

// the twiddles of one lane's butterflies on a fixed plan of M points, for the
// passes from the one after Ns points on (the first pass takes none)
template <int M, int Ns, int... Rs>
struct WarpTw {
  __device__ __forceinline__ void load(SArr, int) {}
};

template <int M, int Ns, int R, int... Rs>
struct WarpTw<M, Ns, R, Rs...> {
  static constexpr int kB = (M / R + 31) / 32;  // butterflies a lane
  float2 w[kB][R - 1];                         // forward: W_2M^(2 r k M / (Ns R))
  WarpTw<M, Ns * R, Rs...> next;
  __device__ __forceinline__ void load(SArr tw, int lane) {
#pragma unroll
    for (int b = 0; b < kB; ++b) {
      const int k = (lane + 32 * b) % Ns;
#pragma unroll
      for (int r = 1; r < R; ++r) w[b][r - 1] = twiddle<false>(tw, 2 * r * k * (M / (Ns * R)), M);
    }
    next.load(tw, lane);
  }
};

// a fixed plan's lane twiddles, loaded from the table (every lane calls it)
template <class G, int R0, int... Rs>
__device__ __forceinline__ WarpTw<G::block, R0, Rs...> warp_twiddles(const FixedPlan<R0, Rs...>&,
                                                                     const G&, SArr tw, int lane) {
  WarpTw<G::block, R0, Rs...> w;
  w.load(tw, lane);
  return w;
}

// ... a run-time plan's are the table
template <class G>
__device__ __forceinline__ SArr warp_twiddles(const RunPlan&, const G&, SArr tw, int) {
  return tw;
}

template <bool kInv, class G, class Src, int Ns, int R, int... Rs>
__device__ __forceinline__ SArr warp_fft_fixed(const G& q, int lane, const Src& src, SArr dst,
                                               SArr other,
                                               const WarpTw<G::block, Ns, R, Rs...>& w) {
  constexpr int M = G::block;
#pragma unroll
  for (int b = 0; b < WarpTw<M, Ns, R, Rs...>::kB; ++b) {
    const int j = lane + 32 * b;
    if (j < M / R)
      butterfly<R, kInv>(M, 0, j, Ns, src, NatDst{dst, M}, [&](int r, int) {
        const float2 t = w.w[b][r - 1];
        return kInv ? make_float2(t.x, -t.y) : t;
      });
  }
  __syncwarp();
  if constexpr (sizeof...(Rs) == 0) {
    return dst;
  } else {
    return warp_fft_fixed<kInv>(q, lane, BufSrc{dst, M}, other, dst, w.next);
  }
}

// One complex FFT of M = q.block points by the calling warp (every lane
// calls it; `lane` is its lane) on a fixed plan, with the lane's twiddles:
// as fft with L = 1, ends with __syncwarp.
template <bool kInv, class G, class Src, int R0, int... Rs>
__device__ __forceinline__ SArr warp_fft(const FixedPlan<R0, Rs...>&, const G& q, int lane,
                                         const Src& src, SArr dst, SArr other,
                                         const WarpTw<G::block, R0, Rs...>& w) {
  constexpr int M = G::block;
  for (int j = lane; j < M / R0; j += 32)  // the first pass: no twiddles
    butterfly<R0, kInv>(M, 0, j, 1, src, NatDst{dst, M}, [](int, int) { return float2{}; });
  __syncwarp();
  if constexpr (sizeof...(Rs) == 0) {
    return dst;
  } else {
    return warp_fft_fixed<kInv>(q, lane, BufSrc{dst, M}, other, dst, w);
  }
}

template <int R, bool kInv, class G, class Src>
__device__ __forceinline__ void warp_pass(const G& q, int lane, int ns, const Src& src, SArr dst,
                                          SArr tw) {
  const int M = q.block;
  for (int j = lane; j < M / R; j += 32)
    butterfly<R, kInv>(M, 0, j, ns, src, NatDst{dst, M},
                       [&](int, int m) { return twiddle<kInv>(tw, m, M); });
  __syncwarp();
}

template <bool kInv, class G, class Src>
__device__ __forceinline__ void warp_pass_any(int radix, const G& q, int lane, int ns,
                                              const Src& src, SArr dst, SArr tw) {
  switch (radix) {
    case 8: warp_pass<8, kInv>(q, lane, ns, src, dst, tw); break;
    case 4: warp_pass<4, kInv>(q, lane, ns, src, dst, tw); break;
    case 2: warp_pass<2, kInv>(q, lane, ns, src, dst, tw); break;
    case 5: warp_pass<5, kInv>(q, lane, ns, src, dst, tw); break;
    default: warp_pass<3, kInv>(q, lane, ns, src, dst, tw); break;
  }
}

// ... on a run-time plan, with the twiddle table
template <bool kInv, class G, class Src>
__device__ __forceinline__ SArr warp_fft(const RunPlan& p, const G& q, int lane, const Src& src,
                                         SArr dst, SArr other, SArr tw) {
  warp_pass_any<kInv>(p.radix[0], q, lane, 1, src, dst, tw);
  int ns = p.radix[0];
  for (int i = 1; i < p.passes; ++i) {
    const SArr from = dst;
    dst = other;
    other = from;
    warp_pass_any<kInv>(p.radix[i], q, lane, ns, BufSrc{from, q.block}, dst, tw);
    ns *= p.radix[i];
  }
  return dst;
}

// ---------------------------------------------------------------- real-FFT splits

// Bin k in [0, M] of the real FFT whose half-length complex FFT is
// transform l of work buffer z: X[k] = (Z[k] + Z*[M-k]) / 2 - i W_N^k (Z[k]
// - Z*[M-k]) / 2, indices mod M.
__device__ __forceinline__ float2 split_bin(float2 a, float2 b, float2 w) {
  const float sr = a.x + b.x, si = a.y - b.y;             // Z[k] + Z*[M-k]
  const float fr = 0.5f * (a.y + b.y), fi = -0.5f * (a.x - b.x);  // -i (Z[k] - Z*[M-k]) / 2
  return make_float2(0.5f * sr + (w.x * fr - w.y * fi), 0.5f * si + (w.x * fi + w.y * fr));
}

__device__ __forceinline__ float2 fwd_split(SArr z, int l, int k, int M, SArr tw) {
  const float2 a = elem(z, l, k == M ? 0 : k, M);
  const float2 b = elem(z, l, k == 0 ? 0 : M - k, M);  // Z[M-k], conjugated in split_bin
  return split_bin(a, b, k < M ? c2(tw, k) : make_float2(-1.f, 0.f));
}

// Bins k and M - k of the same (k in [0, M/2]; k = 0 gives bins 0 and M),
// from one read of Z[k] and Z[M-k]: xm is bin M - k (when M - k == k, bin
// k again).
__device__ __forceinline__ void fwd_split_pair(SArr z, int k, int M, SArr tw, float2& xk,
                                               float2& xm) {
  const float2 a = c2(z, k), b = c2(z, k == 0 ? 0 : M - k);
  xk = split_bin(a, b, c2(tw, k));
  xm = split_bin(b, a, k == 0 ? make_float2(-1.f, 0.f) : c2(tw, M - k));
}

// The inverse's pre-split for k in [0, M): Z'[k] = ((X[k] + X*[M-k]) + i
// conj(W_N^k) (X[k] - X*[M-k])) * inv_n, from xk = X[k] and xm = X[M-k]
// (bins 0 and M with their imaginary parts already dropped); the inverse
// passes then give x[2n] = Re z[n], x[2n+1] = Im z[n].
__device__ __forceinline__ float2 inv_split(float2 xk, float2 xm, float2 w, float inv_n) {
  const float er = xk.x + xm.x, ei = xk.y - xm.y;  // X[k] + X*[M-k]
  const float dr = xk.x - xm.x, di = xk.y + xm.y;  // X[k] - X*[M-k]
  const float orr = w.x * dr + w.y * di, oi = w.x * di - w.y * dr;  // conj(W) (X - X*)
  return make_float2((er - oi) * inv_n, (ei + orr) * inv_n);
}

// sample m of the real signal whose packed complex form is transform l of
// work buffer z
__device__ __forceinline__ float real_sample(SArr z, int l, int m, int M) {
  const float2 v = elem(z, l, m >> 1, M);
  return (m & 1) ? v.y : v.x;
}

// Bin k in [0, M] of a real spectrum into transform l of work buffer g,
// packed as M complex values for PackedInvSrc: slot 0 holds (Re X[0],
// Re X[M]) (the inverse drops both imaginary parts), slot k in (0, M) X[k].
__device__ __forceinline__ void pack_bin(SArr g, int l, int k, int M, float2 x) {
  if (k == 0) {
    elem(g, l, 0, M).x = x.x;
  } else if (k == M) {
    elem(g, l, 0, M).y = x.x;
  } else {
    elem(g, l, k, M) = x;
  }
}

// the inverse's pre-split of each transform's spectrum packed by pack_bin
struct PackedInvSrc {
  SArr g, tw;
  int M;
  float inv_n;
  __device__ __forceinline__ float2 operator()(int l, int k) const {
    const float2 v = elem(g, l, k, M);
    const float2 xk = k == 0 ? make_float2(v.x, 0.f) : v;
    const float2 xm = k == 0 ? make_float2(v.y, 0.f) : elem(g, l, M - k, M);
    return inv_split(xk, xm, c2(tw, k), inv_n);
  }
};

// the buffer that holds a transform's result: dst after an odd number of
// passes, else other (fft and warp_fft alternate between the two)
template <int... Rs>
__device__ __forceinline__ SArr fft_result(const FixedPlan<Rs...>&, SArr dst, SArr other) {
  return sizeof...(Rs) % 2 ? dst : other;
}

__device__ __forceinline__ SArr fft_result(const RunPlan& p, SArr dst, SArr other) {
  return p.passes % 2 ? dst : other;
}

// ---------------------------------------------------------------- plans on the host

// the default geometry's plan, compiled in; kernels/fft_plan.py radix_plan(256)
using DefaultPlan = FixedPlan<8, 8, 4>;

// The host's plan radix[n_pass] (kernels/fft_plan.py radix_plan) into `plan`:
// cudaErrorInvalidValue unless every radix is written out and they multiply
// to `block`.
inline cudaError_t read_plan(const int* radix, int n_pass, int block, RunPlan& plan) {
  if (n_pass < 1 || n_pass > kMaxPasses) return cudaErrorInvalidValue;
  plan.passes = n_pass;
  int m = 1;
  for (int i = 0; i < n_pass; ++i) {
    const int r = radix[i];
    if (r != 2 && r != 3 && r != 4 && r != 5 && r != 8) return cudaErrorInvalidValue;
    plan.radix[i] = r;
    m *= r;
  }
  return m == block ? cudaSuccess : cudaErrorInvalidValue;
}

// whether a plan read by read_plan is DefaultPlan's
inline bool is_default_plan(const RunPlan& plan) {
  return plan.passes == 3 && plan.radix[0] == 8 && plan.radix[1] == 8 && plan.radix[2] == 4;
}

}  // namespace aec

// Kernel K9b: the LSTM recurrence's backward on the gates its forward
// saved, one launch, W_hh held on chip across the reverse loop.
//
// Replaces the backwards of aec_tpu/kernels/pallas_lstm.py's custom VJP
// complex_lstm_scan_fused (_bwd at :341-350) and of
// aec_tpu/kernels/pallas_fullsubnet.py's fsn_joint_fused (_bwd at
// :199-217): both recompute through the scan and take jax.vjp of it, which
// XLA compiles into one loop on the device. Here that loop is this kernel,
// fed by the gates K9 (lstm.cu) and K11 (fullsubnet.cu) save with SAVE.
// Per reverse step t = T - 1, ..., 0 of each row, from zero carries:
//   dh = carry_h + g_ys(t);  dc = carry_c + dh o (1 - tanh^2 c)
//   do^ = dh tanh(c) o (1 - o);  di^ = dc g i (1 - i);  dg^ = dc i (1 - g^2);
//   df^ = dc c(t - 1) f (1 - f);  carry_c = dc f;
//   carry_h = W_hh^T [di^, df^, dg^, do^],
// and dxp(t) = [di^, df^, dg^, do^], the gradient of the step's
// pre-activations. The weight gradients are products over all rows and steps
// outside (kernels/lstm.py, kernels/fullsubnet.py), as K8b's are.
//
// Layout. G groups, each with its W_hh (4H, H), each over B x F rows: B
// sequences of T steps, F rows a step (DCCRN: G = 2 parameter groups, B = 2
// x batch, F = 1; FullSubNet's sub band: G = 1, B = batch, F = 161 bins; its
// full band F = 1). Row r = b F + f of group g at step t is row vector
// ((g B + b) T + t) F + f of g_ys (H floats), saved (5H: i, f, g, o, c) and
// dxp (4H), so the sub band's (B, T, F) tensors go in without a transpose.
// H is a multiple of 4 (the wrapper pads it), so every row is 16-byte aligned.
//
// The dots. The product of a step is K9's transposed: each unit k's carry_h
// is a dot of length 4H, the row's dxp(t + 1) against column k of W_hh. A
// CTA owns a run of a group's rows and a chunk of U units, and holds those
// units' columns of W_hh (4H x U) on chip for the whole loop: each warp sums
// CW columns (a power of two) over one of KS k-slices of the 4H (warps w and
// w + 16 / KS share columns), lane l holding quads l, l + 32, ... (npos
// positions) of its slice; the first kRegQuads in registers, then shared
// memory, the rest read from L2 each pass. RT rows go a sweep; each lane sums
// in k order with FMAs (a shared or L2 position streamed one column's quad at
// a time, which keeps the lane under 128 registers: the first design held a
// position's CW quads at once and spilled, PERF.md §6), the warp's lanes
// reduce by shuffles as in K9 (lstm_common.cuh), and the KS slices' sums
// meet in shared memory, added in slice order by the thread that steps the
// cell. A CTA takes its rows in blocks of block_rows (the slices' sums of
// one block in shared memory at a time).
//
// Inputs. A block's g_ys(t), i, f, g, o(t) and c(t - 1) for the CTA's rows
// and units stream into a two-slot ring in shared memory by TMA bulk copies
// (cp.async.bulk on an mbarrier a slot), a block ahead of the cells, issued
// by six warps, one field each (one warp issuing them all held every plan's
// step 1.8-6.4 us longer, PERF.md §6); c(t) is the c(t - 1) operand the
// cells kept from the step before.
//
// The exchange of dxp(t), by plan (kernels/lstm_bwd.py backward_plan):
//   local (plan a): every unit in one CTA (nchunk = 1), the rows split into
//     runs, where all of W_hh^T fits one CTA (FullSubNet's sub band, H = 96):
//     the cells write dxp(t) into the CTA's own buffer in shared memory for
//     the next step's dots (and to device memory for the weight gradients,
//     never read back here); the CTAs never wait on each other.
//   cluster: a group's units over one thread-block cluster of nchunk <= 16
//     CTAs (FullSubNet's full band: 16 CTAs of 16 units at H = 256, a
//     non-portable size, narrower where the card places no cluster of 16).
//     A slot of dxp lies chunk-major, (chunk, row, gate, unit), so a CTA's
//     slice of every row is one block and the dots take k in that order (W
//     packed to match). Each CTA stores its slice of dxp(t) into its own slot
//     t & 1 and pushes the block into every other CTA's by one bulk copy
//     (cp.async.bulk shared::cta -> shared::cluster) a CTA, counted on that
//     slot's mbarrier there, and waits on its own before the dots: no
//     device-memory read-back, no counter and no cluster barrier on the step
//     (barrier.cluster's release compiles to a GPU-scope fence: K11's
//     finding, csrc/fullsubnet.cu). Two slots suffice: a CTA pushes dxp(t - 1) only after every CTA's
//     dxp(t), which each sends after its dots have read dxp(t + 1).
//   split: a group's units over co-resident CTAs, each holding the rows of
//     W_hh of its own units' gates (DCCRN's H = 1024: 64 CTAs of 16 units a
//     group): the product is split over k, and what crosses CTAs is each
//     unit's partial carry_h, not dxp (lstm_bwd_split_kernel below).
//   grid: a group's units over co-resident CTAs where the split plan does
//     not fit (H > 1024), launched cooperatively (the waits trap after
//     kSpinLimit polls). Each CTA writes its slice of dxp(t) to device memory
//     and publishes it with a release store of its own flag (the blocks of
//     rows it has finished). Rounds of round_rows rows of dxp(t + 1) land by
//     TMA in a ring of nbuf buffers once the producers' flags say the rows'
//     block is published; full and empty mbarriers order the ring (each warp
//     releases a buffer when its dots are done), so the next round lands
//     while this one's dots run and no CTA-wide barrier falls between rounds.
//     (Clusters of 2 taking each round by TMA multicast ran 6-12 % slower at
//     every plan tried, PERF.md §6.)
//
// What bounds it. 4H H FMAs a row-step and ~11 H floats a row-step through
// device memory (g_ys, saved, c(t - 1) in; dxp out). At DCCRN's training
// shape (G = 2, R = 32, T = 501, H = 1024) that is 134.5 G FMA, 4.0 ms a
// layer at the fp32 peak; a step of the split plan is bound by the FMAs of
// the 2 x 64 CTAs (2.1 M each) and the group's exchange of partials.
// FullSubNet's sub band (R = 16 x 161, H = 96, T = 801) is bound by its
// bytes: 8.7 GB of saved gates, g_ys and dxp, ~2.6 ms. PERF.md has
// the measured times and their split (kernels/lstm_bwd_costs.py, which
// builds this source with parts of the step cut out: -DAEC_NO_DOTS,
// -DAEC_NO_STAGE, -DAEC_NO_WAIT, -DAEC_NO_CELLS; no route defines them).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "lstm_common.cuh"

namespace cgr = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRegQuads = 16;  // float4 quads of W a thread holds in registers
constexpr int kInWarp = kWarps - 1;  // the first of the warps that issue the inputs' copies
constexpr int kMaxCluster = 16;  // 16 past the portable 8, where the card places it
constexpr int kMaxBuf = 2;
constexpr long long kSpinLimit = 1ll << 24;  // ~10 s of polls of a flag: a lost CTA traps
// cluster: the pushes of dxp and the waits for them; a cost variant that cuts
// the waits, the staging or the cells runs without them (the cells, if kept,
// store into the own slot)
#if defined(AEC_NO_WAIT) || defined(AEC_NO_STAGE) || defined(AEC_NO_CELLS)
constexpr bool kPush = false;
#else
constexpr bool kPush = true;
#endif

enum Mode { kLocal = 0, kCluster = 1, kGrid = 2, kSplit = 3 };
constexpr int kSplitRows = 16;  // split: rows a pass of the dots (sums a column)
// split: registers of W a thread (48 ran 6 % faster than 64 at DCCRN's shape
// on the H100: fewer spills beside the 32 sums of a pass; PERF.md §6)
constexpr int kSplitRegs = 48;

struct BwdArgs {
  const float* __restrict__ g_ys;   // (G, B, T, F, H)
  const float* __restrict__ saved;  // (G, B, T, F, 5H): i, f, g, o, c of each step
  const float4* __restrict__ wp;    // (G nchunk, npos CW, kThreads): the quads of each thread
  unsigned* flags;                  // (G nchunk), zero: grid, the blocks each CTA has published
  float* dxp;                       // (G, B, T, F, 4H)
  int b, t_steps, f, hidden, runs, run_rows, block_rows, units, nchunk, ks, npos, jreg, jsm,
      round_rows, nbuf;
};

// shared memory of one CTA (floats): W's shared quads; dxp(t + 1)'s rows
// (local: the run's own rows; cluster: two slots of every row, chunk-major,
// nchunk 4U floats a row; grid: nbuf buffers of round_rows rows); the
// k-slices' sums of a block (KS, block_rows, columns); carry_c and the
// carried c (run_rows, U) each; the inputs' two slots (block_rows, 6, U);
// the mbarriers (inputs 2, the exchange's full 2, its empty 2)
struct BwdSmem {
  size_t ws, dg, pre, cs, cb, inp, bar, total;
};

__host__ __device__ inline BwdSmem bwd_smem(int mode, int hidden, int run_rows, int block_rows,
                                            int units, int nchunk, int cw, int ks, int jsm,
                                            int round_rows, int nbuf) {
  BwdSmem s;
  if (mode == kSplit) {  // W's shared k-values (jsm, cw columns, threads); dxp(t + 1)'s own
    // k-range (4U, rows padded to a pass); carry_c, c; the inputs' two slots; mbarriers
    s.ws = 0;
    s.dg = s.ws + size_t(jsm) * cw * kThreads;
    s.pre = s.dg + size_t(4) * units * ((run_rows + kSplitRows - 1) / kSplitRows * kSplitRows);
    s.cs = s.pre;
    s.cb = s.cs + size_t(run_rows) * units;
    s.inp = s.cb + size_t(run_rows) * units;
    s.bar = s.inp + size_t(2) * block_rows * 6 * units;
    s.total = s.bar + 2 * 6;
    return s;
  }
  s.ws = 0;
  s.dg = s.ws + size_t(jsm) * cw * kThreads * 4;
  s.pre = s.dg + (mode == kLocal     ? size_t(run_rows) * 4 * hidden
                   : mode == kCluster ? size_t(2) * run_rows * 4 * nchunk * units
                                      : size_t(nbuf) * round_rows * 4 * hidden);
  s.cs = s.pre + size_t(ks) * block_rows * (kWarps / ks) * cw;
  s.cb = s.cs + size_t(run_rows) * units;
  s.inp = s.cb + size_t(run_rows) * units;
  s.bar = s.inp + size_t(2) * block_rows * 6 * units;
  s.total = s.bar + 2 * 6;  // six 8-byte mbarriers
  return s;
}

// ---------------------------------------------------------------- PTX

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// one arrival that also expects `bytes` of asynchronous copies this phase
__device__ __forceinline__ void mbar_expect(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// until the phase of this parity has completed
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  asm volatile(
      "{\n .reg .pred done;\n WAIT_%=:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      " @!done bra WAIT_%=;\n}" ::"r"(smem_u32(bar)), "r"(parity) : "memory");
}

__device__ __forceinline__ unsigned map_rank(const void* p, unsigned rank) {
  unsigned d;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(d) : "r"(smem_u32(p)), "r"(rank));
  return d;
}

// TMA: `bytes` (a multiple of 16) of this CTA's shared `src` into CTA `rank`'s
// copy of it, counted on that CTA's copy of `bar`
__device__ __forceinline__ void bulk_push(const float* src, unsigned bytes,
                                          unsigned long long* bar, unsigned rank) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];" ::"r"(map_rank(src, rank)), "r"(smem_u32(src)), "r"(bytes), "r"(map_rank(bar, rank))
      : "memory");
}

// this thread's shared-memory stores before the async proxy's (TMA) reads of them
__device__ __forceinline__ void fence_proxy_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// TMA: `bytes` (a multiple of 16) from global to this CTA's shared memory, counted on `bar`
__device__ __forceinline__ void bulk_copy(float* dst, const float* src, unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}

// this thread's global writes before the async proxy's (TMA) reads of them
__device__ __forceinline__ void fence_proxy_global() {
  asm volatile("fence.proxy.async.global;" ::: "memory");
}

__device__ __forceinline__ void store_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// ---------------------------------------------------------------- the inputs

// g_ys(t), the four gates of step t and c(t - 1) of `rows` rows of the group
// (from row r0, row vectors by `vec`) and units [u0, u0 + nu) into `slot`
// (rows, 6, U), counted on `bar`. The fields go over the warps kInWarp,
// kInWarp - 1, ... (one a warp: g_ys, the gates one by one, c(t - 1); the
// four gates one block where the CTA holds every unit), the rows over a
// warp's lanes, so no warp issues more than a copy a row; lane 0 of warp
// kInWarp expects the bytes (a copy may land first: the phase waits on
// that arrival)
template <typename Vec>
__device__ __forceinline__ void stream_inputs(const BwdArgs& a, Vec vec, int r0, int rows, int t,
                                              int u0, int nu, float* slot,
                                              unsigned long long* bar, int warp, int lane) {
  const int H = a.hidden, U = a.units, F = a.f;
  const bool whole = nu == H;  // one chunk: the four gates of a row are contiguous
  const int k = kInWarp - warp, fields = whole ? 3 : 6;
  if (k < 0 || k >= fields) return;
  if (k == 0 && lane == 0)
    mbar_expect(bar, unsigned(rows) * nu * (t > 0 ? 6 : 5) * sizeof(float));
  const bool cprev = k == fields - 1;
  if (cprev && t == 0) return;
  const unsigned field = unsigned(nu) * sizeof(float);
  for (int r = lane; r < rows; r += 32) {
    const size_t v = vec(r0 + r, t);
    float* d = slot + size_t(r) * 6 * U;
    if (k == 0) {
      bulk_copy(d, a.g_ys + v * H + u0, field, bar);
    } else if (cprev) {
      bulk_copy(d + 5 * U, a.saved + (v - F) * 5 * H + 4 * H + u0, field, bar);
    } else if (whole) {
      bulk_copy(d + U, a.saved + v * 5 * H, 4 * field, bar);
    } else {
      bulk_copy(d + k * U, a.saved + v * 5 * H + (k - 1) * H + u0, field, bar);
    }
  }
}

// one backward LSTM cell: the carried gradient ch of h(t), g_ys(t), the
// gates and c(t), c(t - 1) and carry_c in; dxp(t)'s four gates and the
// next carry_c out
__device__ __forceinline__ void bwd_cell(float ch, float gy, float ig, float fg, float gg,
                                         float og, float c, float cprev, float carry,
                                         float (&d)[4], float& carry_out) {
  const float tc = tanhf(c);
  const float dh = ch + gy;
  const float dc = carry + dh * og * (1.f - tc * tc);
  d[0] = dc * gg * ig * (1.f - ig);
  d[1] = dc * cprev * fg * (1.f - fg);
  d[2] = dc * ig * (1.f - gg * gg);
  d[3] = dh * tc * og * (1.f - og);
  carry_out = dc * fg;
}

// ---------------------------------------------------------------- the dots

// RT rows' sums of CW columns against quad k4 of the staged rows (row r at
// hs4 + r hp4), the CW quads of W one at a time from w, w + stride, ... (shared
// memory, or L2 where `l2`): fma_pos's order, a quad of W live at a time
template <int CW, int RT>
__device__ __forceinline__ void fma_stream(const float4* w, int stride, bool l2, const float4* hs4,
                                           int hp4, int r0, int R, int k4, float (&acc)[CW * RT]) {
  float4 h[RT];
#pragma unroll
  for (int r = 0; r < RT; ++r) h[r] = r0 + r < R ? hs4[(r0 + r) * hp4 + k4] : float4{};
#pragma unroll
  for (int i = 0; i < CW; ++i) {
    const float4 wv = l2 ? __ldg(w + size_t(i) * stride) : w[size_t(i) * stride];
#pragma unroll
    for (int r = 0; r < RT; ++r)
      if (r0 + r < R) acc[i * RT + r] = dot4(h[r], wv, acc[i * RT + r]);
  }
}

// ---------------------------------------------------------------- the kernel

// MODE the exchange (a template parameter, so an instantiation holds only
// its own plan's code: the lanes are capped at 128 registers), CW columns a
// warp (a power of two), RT rows a sweep (CW RT <= 32)
template <int MODE, int CW, int RT>
__global__ void __launch_bounds__(kThreads, 1) lstm_bwd_kernel(BwdArgs a) {
  extern __shared__ float4 smem_raw[];
  constexpr int JR = kRegQuads / CW;  // positions a lane can hold in registers
  constexpr int V = CW * RT;
  constexpr int M = V >= 32 ? 5 : V >= 16 ? 4 : V >= 8 ? 3 : V >= 4 ? 2 : V >= 2 ? 1 : 0;
  const int H = a.hidden, U = a.units, T = a.t_steps, B = a.b, F = a.f, R = B * F;
  const int ks = a.ks, wc = kWarps / ks, cols = wc * CW, rr = a.run_rows, rb = a.block_rows;
  constexpr int mode = MODE;
  const int npos = a.npos, jreg = a.jreg, jsm = a.jsm, nch = a.nchunk;
  const int chunk = blockIdx.x % nch, grp = blockIdx.x / nch;
  const int g = grp / a.runs, r_lo = (grp % a.runs) * rr, nr = min(rr, R - r_lo);
  const int u0 = chunk * U, nu = min(U, H - u0);
  const int nblocks = (nr + rb - 1) / rb;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int slice = warp / wc, cg = warp % wc, kb = slice * 32 * npos;  // the slice's first quad
  // quads of k a row of staged dxp holds (cluster: nchunk chunks of 4U floats)
  const int kq = mode == kCluster ? nch * U : H;
  const BwdSmem lay = bwd_smem(mode, H, rr, rb, U, nch, CW, ks, jsm, a.round_rows, a.nbuf);
  float* base = reinterpret_cast<float*>(smem_raw);
  float4* ws = reinterpret_cast<float4*>(base + lay.ws);
  float* dg = base + lay.dg;
  float* pre = base + lay.pre;
  float* cs = base + lay.cs;
  float* cb = base + lay.cb;
  float* inp = base + lay.inp;
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(base + lay.bar);
  unsigned long long* in_full = bars;   // the inputs' two slots
  unsigned long long* x_full = bars + 2;  // cluster: dxp's two slots; grid: the ring's buffers
  unsigned long long* x_empty = bars + 4;  // grid: the ring's buffers released by every warp
  const float4* w = a.wp + (size_t(g) * nch + chunk) * npos * CW * kThreads + tid;
  const unsigned rank = mode == kCluster ? cgr::this_cluster().block_rank() : 0;
  // row vector of (row r of the group, step t)
  auto vec = [&](int r, int t) {
    const int bb = r / F;
    return ((size_t(g) * B + bb) * T + t) * F + (r - bb * F);
  };

  // once: W's quads on chip, carry_c zero, c(T - 1) of the own rows; the
  // cluster's slots zero (a last chunk's padding is never written)
  float4 wr[JR > 0 ? JR : 1][CW];
#pragma unroll
  for (int j = 0; j < JR; ++j)
#pragma unroll
    for (int i = 0; i < CW; ++i)
      wr[j][i] = j < jreg ? w[size_t(j * CW + i) * kThreads] : float4{};
  for (int q = 0; q < jsm * CW; ++q) ws[q * kThreads + tid] = w[size_t(jreg * CW + q) * kThreads];
  for (int i = tid; i < nr * nu; i += kThreads) {
    const int r = i / nu, j = i - r * nu;
    cs[r * U + j] = 0.f;
    cb[r * U + j] = a.saved[vec(r_lo + r, T - 1) * 5 * H + 4 * H + u0 + j];
  }
  if (mode == kCluster)
    for (size_t i = tid; i < size_t(2) * rr * 4 * kq; i += kThreads) dg[i] = 0.f;
  // cluster: the bytes of the others' slices a slot takes a step
  const unsigned pushed = unsigned(nch - 1) * nr * 4 * U * sizeof(float);
  if (tid == 0) {
    mbar_init(in_full, 1);
    mbar_init(in_full + 1, 1);
    mbar_init(x_full, 1);
    mbar_init(x_full + 1, 1);
    mbar_init(x_empty, kWarps);
    mbar_init(x_empty + 1, kWarps);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    if (mode == kCluster && kPush)  // dxp(T - 1) and dxp(T - 2) expected in their slots
      for (int k = 0; k < 2 && T - 1 - k >= 1; ++k) mbar_expect(x_full + ((T - 1 - k) & 1), pushed);
  }
  if (mode == kCluster) {
    cgr::this_cluster().sync();  // every CTA's mbarriers set before another's copies land
  } else {
    __syncthreads();
  }

  // the inputs of unit n (step n / nblocks, block n % nblocks) into slot n & 1:
  // per row g_ys, the four gates and c(t - 1) of the CTA's units
  auto issue_inputs = [&](int n) {
    const int s = n / nblocks, hb = n - s * nblocks, t = T - 1 - s;
    if (s >= T) return;
    const int row0 = hb * rb;
    stream_inputs(a, vec, r_lo + row0, min(rb, nr - row0), t, u0, nu,
                  inp + size_t(n & 1) * rb * 6 * U, in_full + (n & 1), warp, lane);
  };

  // RT rows a sweep of nrows rows of dxp(t + 1) at dg4 (kq quads a row;
  // cluster: chunk c's U quads of every row at dg4 + c rr U): each lane's
  // dots over its quads (registers, shared memory, L2), the warp's sum over
  // its lanes, into the slice's sums of block rows prow0, ...
  auto dots = [&](const float4* dg4, int nrows, int prow0) {
#ifndef AEC_NO_DOTS
    // quad p of a row: its rows' first quad and their stride
    auto at = [&](int p, const float4*& hs, int& k4, int& stride) {
      if (mode == kCluster) {
        const int c = p / U;
        hs = dg4 + size_t(c) * rr * U;
        k4 = p - c * U;
        stride = U;
      } else {
        hs = dg4;
        k4 = p;
        stride = H;
      }
    };
    for (int r0 = 0; r0 < nrows; r0 += RT) {
      float acc[V];
#pragma unroll
      for (int i = 0; i < V; ++i) acc[i] = 0.f;
      const float4* hs;
      int k4, stride;
#pragma unroll
      for (int j = 0; j < JR; ++j)
        if (j < jreg && kb + lane + 32 * j < kq) {
          at(kb + lane + 32 * j, hs, k4, stride);
          fma_pos<CW, RT>(wr[j], hs, stride, r0, nrows, k4, acc);
        }
      for (int j = jreg; j < jreg + jsm && kb + lane + 32 * j < kq; ++j) {
        at(kb + lane + 32 * j, hs, k4, stride);
        fma_stream<CW, RT>(ws + (j - jreg) * CW * kThreads + tid, kThreads, false, hs, stride,
                           r0, nrows, k4, acc);
      }
      for (int j = jreg + jsm; j < npos && kb + lane + 32 * j < kq; ++j) {
        at(kb + lane + 32 * j, hs, k4, stride);
        fma_stream<CW, RT>(w + size_t(j * CW) * kThreads, kThreads, true, hs, stride, r0, nrows,
                           k4, acc);
      }
      Scatter<V, 16>::run(acc, lane);
      const int idx = lane >> (5 - M), i = idx / RT, r = idx - i * RT;
      if ((lane & ((1 << (5 - M)) - 1)) == 0 && r0 + r < nrows)
        pre[(size_t(slice) * rb + prow0 + r0 + r) * cols + cg * CW + i] = acc[0];
    }
#endif
  };

  issue_inputs(0);
  int m = 0;  // grid: rounds taken so far
  for (int n = 0; n < T * nblocks; ++n) {
    const int s = n / nblocks, hb = n - s * nblocks, t = T - 1 - s;
    const int row0 = hb * rb, rows = min(rb, nr - row0);
    issue_inputs(n + 1);  // into the slot unit n - 1 left (its cells ended in a barrier)

    // carry_h: dxp(t + 1) of the block's rows against the own columns
    if (s > 0) {
      if (mode == kLocal) {
        dots(reinterpret_cast<const float4*>(dg + size_t(row0) * 4 * H), rows, 0);
      } else if (mode == kCluster) {
        const int slot = (t + 1) & 1;
        if (kPush) {
          mbar_wait(x_full + slot, unsigned((T - 2 - t) >> 1) & 1u);
          // expect dxp(t - 1) in this slot (dxp(0) is never sent): it
          // lands only after this CTA has sent dxp(t), after these dots
          if (tid == 0 && t >= 2) mbar_expect(x_full + slot, pushed);
        }
        dots(reinterpret_cast<const float4*>(dg + size_t(slot) * rr * 4 * kq), rows, 0);
      } else {
        // rounds of round_rows rows through the ring: lane 0 of warp 0
        // copies a round once the producers have published the block (flags
        // >= n - nblocks + 1) and every warp has released its buffer
        const int RRo = a.round_rows, NB = a.nbuf, nround = (rows + RRo - 1) / RRo;
        auto issue_round = [&](int mm, int k) {  // lane 0 of warp 0
          const int bf = mm % NB, q0 = row0 + k * RRo, nrr = min(RRo, row0 + rows - q0);
          if (mm >= NB) mbar_wait(x_empty + bf, unsigned(mm / NB - 1) & 1u);
#ifndef AEC_NO_STAGE
          mbar_expect(x_full + bf, unsigned(nrr) * 4 * H * sizeof(float));
          for (int r = 0; r < nrr; ++r)
            bulk_copy(dg + (size_t(bf) * RRo + r) * 4 * H, a.dxp + vec(q0 + r, t + 1) * 4 * H,
                      unsigned(4 * H) * sizeof(float), x_full + bf);
#else
          mbar_arrive(x_full + bf);  // no copy: the ring keeps what it held
#endif
        };
        if (warp == 0) {
#ifndef AEC_NO_WAIT
          const unsigned want = unsigned(n - nblocks + 1);
          for (int p = lane; p < nch; p += 32) {
            const unsigned* fl = a.flags + size_t(g) * nch + p;
            for (long long spins = 0; load_acquire(fl) < want;)
              if (++spins > kSpinLimit) __trap();
          }
#endif
          __syncwarp();
          if (lane == 0) {
            fence_proxy_global();  // the producers' dxp, acquired above, before the copies read it
            for (int k = 0; k < NB && k < nround; ++k) issue_round(m + k, k);
          }
          __syncwarp();
        }
        for (int k = 0; k < nround; ++k, ++m) {
          const int bf = m % NB, q0 = k * RRo, nrr = min(RRo, rows - q0);
          mbar_wait(x_full + bf, unsigned(m / NB) & 1u);
          dots(reinterpret_cast<const float4*>(dg + size_t(bf) * RRo * 4 * H), nrr, q0);
          __syncwarp();
          if (lane == 0) mbar_arrive(x_empty + bf);
          if (warp == 0) {
            if (lane == 0 && k + NB < nround) issue_round(m + NB, k + NB);
            __syncwarp();
          }
        }
      }
    }
    mbar_wait(in_full + (n & 1), unsigned(n >> 1) & 1u);  // the block's inputs landed
    __syncthreads();  // the slices' sums complete

    // the cells of the block's (row, unit) pairs, backwards: dxp(t) out
#ifndef AEC_NO_CELLS
    const float* slot = inp + size_t(n & 1) * rb * 6 * U;
    // cluster: the own slice of slot t & 1, (row, gate, unit) from own
    float* own = dg + (size_t(t & 1) * nch + chunk) * rr * 4 * U;
    for (int i = tid; i < rows * nu; i += kThreads) {
      const int rl = i / nu, j = i - rl * nu, r = row0 + rl;
      const float* x = slot + size_t(rl) * 6 * U + j;
      const float ig = x[U], fg = x[2 * U], gg = x[3 * U], og = x[4 * U];
      const float cprev = t > 0 ? x[5 * U] : 0.f;
      float ch = 0.f;
      if (s > 0) {
        ch = pre[size_t(rl) * cols + j];
        for (int q = 1; q < ks; ++q) ch += pre[(size_t(q) * rb + rl) * cols + j];
      }
      float d[4];
      bwd_cell(ch, x[0], ig, fg, gg, og, cb[r * U + j], cprev, cs[r * U + j], d, cs[r * U + j]);
      cb[r * U + j] = cprev;  // c(t - 1): the next reverse step's c
      float* out = a.dxp + vec(r_lo + r, t) * 4 * H + u0 + j;
#pragma unroll
      for (int k = 0; k < 4; ++k) out[k * H] = d[k];
      if (mode == kLocal) {  // the run's buffer
#pragma unroll
        for (int k = 0; k < 4; ++k) dg[size_t(r) * 4 * H + k * H + j] = d[k];
      } else if (mode == kCluster) {
#pragma unroll
        for (int k = 0; k < 4; ++k) own[(size_t(r) * 4 + k) * U + j] = d[k];
      } else {
        fence_proxy_global();
      }
    }
    if (mode == kCluster && kPush && t > 0) {
      // the own slice of slot t & 1 into every other CTA's, one bulk copy a
      // CTA, counted on that CTA's mbarrier of the slot
      fence_proxy_shared();
      __syncthreads();
      if (tid < nch && tid != int(rank))
        bulk_push(own, unsigned(nr) * 4 * U * sizeof(float), x_full + (t & 1), unsigned(tid));
    }
#endif
    __syncthreads();  // the block's cells done before the next block's sums and inputs
    if (mode == kGrid && tid == 0) {
      fence_proxy_global();
      store_release(a.flags + size_t(g) * nch + chunk, unsigned(n + 1));
    }
  }
  // no CTA leaves while another of its cluster may still copy into or out of it
  if (mode == kCluster) cgr::this_cluster().sync();
}

// The split plan (mode kSplit). CTA (g, q) steps the cells of units [q U, q U
// + U) and holds the rows of W_hh of the same units' four gates (4U rows, H
// long): the k-range its own cells produce of dxp. A step's product is then
// split over k, not over units: the CTA forms the partial carry_h of every
// unit from its own dxp(t + 1) alone, dxp(t + 1)'s own k-range (4U, rows)
// never leaving its shared memory, and the group sums the partials through
// device memory, (dst, src, rows, U) a slot, each unit's nchunk partials
// added in source order by the thread that steps its cell. Per step a CTA
// writes and reads R H floats of partials (128 KB at DCCRN's shape) where
// the grid plan reads R 4H of dxp (512 KB). Thread tid owns columns tid +
// 512 ci (ci < CPT) of its 4U rows: k < jreg in registers, the rest in
// shared memory; a pass of kSplitRows rows keeps CPT kSplitRows sums a thread,
// each in k order with FMAs, its dxp operands broadcast from shared memory,
// so no shuffle reduces them. Readiness: a flag a CTA (the steps whose
// partials it has published, a release store); the CTA reads the group's
// partials once its warp 0 has seen every flag, which orders the steps, so
// two slots suffice. The grid is launched cooperatively (every CTA
// co-resident: the waits trap after kSpinLimit polls).
template <int CPT>
__global__ void __launch_bounds__(kThreads, 1) lstm_bwd_split_kernel(BwdArgs a, float* part) {
  extern __shared__ float4 smem_raw[];
  constexpr int KR = kSplitRegs / CPT;  // k-values of W a thread can hold in registers
  const int H = a.hidden, U = a.units, T = a.t_steps, B = a.b, F = a.f, R = B * F;
  const int K = 4 * U, kr = a.jreg, nch = a.nchunk;
  const int q = blockIdx.x % nch, g = blockIdx.x / nch;
  const int u0 = q * U, nu = min(U, H - u0);
  const int Rp = (R + kSplitRows - 1) / kSplitRows * kSplitRows;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const BwdSmem lay = bwd_smem(kSplit, H, R, R, U, nch, CPT, 1, a.jsm, 0, 0);
  float* base = reinterpret_cast<float*>(smem_raw);
  float* ws = base + lay.ws;  // (K - kr, CPT, threads)
  float* dsm = base + lay.dg;  // (4U, Rp): dxp(t + 1)'s own k-range, k = gate U + j
  float* cs = base + lay.cs;
  float* cb = base + lay.cb;
  float* inp = base + lay.inp;
  unsigned long long* in_full = reinterpret_cast<unsigned long long*>(base + lay.bar);
  const float* w = reinterpret_cast<const float*>(a.wp) + size_t(g * nch + q) * K * CPT * kThreads;
  unsigned* flags = a.flags + size_t(g) * nch;
  auto vec = [&](int r, int t) {
    const int bb = r / F;
    return ((size_t(g) * B + bb) * T + t) * F + (r - bb * F);
  };
  // (dst chunk, src chunk, row, unit) partials of slot t & 1
  auto slot_of = [&](int t) { return part + (size_t(g) * 2 + (t & 1)) * nch * nch * R * U; };

  // once: W's k-values on chip, dxp's own k-range and carry_c zero, c(T - 1)
  float wr[KR][CPT];
#pragma unroll
  for (int k = 0; k < KR; ++k)
#pragma unroll
    for (int ci = 0; ci < CPT; ++ci)
      wr[k][ci] = k < kr ? w[size_t(k * CPT + ci) * kThreads + tid] : 0.f;
  for (int k = kr; k < K; ++k)
    for (int ci = 0; ci < CPT; ++ci)
      ws[((k - kr) * CPT + ci) * kThreads + tid] = w[size_t(k * CPT + ci) * kThreads + tid];
  for (int i = tid; i < K * Rp; i += kThreads) dsm[i] = 0.f;
  for (int i = tid; i < R * nu; i += kThreads) {
    const int r = i / nu, j = i - r * nu;
    cs[r * U + j] = 0.f;
    cb[r * U + j] = a.saved[vec(r, T - 1) * 5 * H + 4 * H + u0 + j];
  }
  if (tid == 0) {
    mbar_init(in_full, 1);
    mbar_init(in_full + 1, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  stream_inputs(a, vec, 0, R, T - 1, u0, nu, inp, in_full, warp, lane);

  for (int s = 0; s < T; ++s) {
    const int t = T - 1 - s;
    if (s + 1 < T)  // into the slot step s - 1 left
      stream_inputs(a, vec, 0, R, t - 1, u0, nu, inp + size_t((s + 1) & 1) * R * 6 * U,
                    in_full + ((s + 1) & 1), warp, lane);
    float* slot = slot_of(t);
    if (s > 0) {
#ifndef AEC_NO_DOTS
      // the partial carry_h of every unit from the own k-range of dxp(t + 1)
      for (int r0 = 0; r0 < R; r0 += kSplitRows) {
        float acc[CPT][kSplitRows];
#pragma unroll
        for (int ci = 0; ci < CPT; ++ci)
#pragma unroll
          for (int r = 0; r < kSplitRows; ++r) acc[ci][r] = 0.f;
        auto fma_k = [&](const float (&wv)[CPT], int k) {
          const float4* d4 = reinterpret_cast<const float4*>(dsm + size_t(k) * Rp + r0);
#pragma unroll
          for (int r4 = 0; r4 < kSplitRows / 4; ++r4) {
            const float4 d = d4[r4];
#pragma unroll
            for (int ci = 0; ci < CPT; ++ci) {
              acc[ci][4 * r4] = fmaf(d.x, wv[ci], acc[ci][4 * r4]);
              acc[ci][4 * r4 + 1] = fmaf(d.y, wv[ci], acc[ci][4 * r4 + 1]);
              acc[ci][4 * r4 + 2] = fmaf(d.z, wv[ci], acc[ci][4 * r4 + 2]);
              acc[ci][4 * r4 + 3] = fmaf(d.w, wv[ci], acc[ci][4 * r4 + 3]);
            }
          }
        };
#pragma unroll
        for (int k = 0; k < KR; ++k)
          if (k < kr) fma_k(wr[k], k);
#pragma unroll 4
        for (int k = kr; k < K; ++k) {
          float wv[CPT];
#pragma unroll
          for (int ci = 0; ci < CPT; ++ci) wv[ci] = ws[((k - kr) * CPT + ci) * kThreads + tid];
          fma_k(wv, k);
        }
#pragma unroll
        for (int ci = 0; ci < CPT; ++ci) {
          const int col = tid + ci * kThreads, p = col / U;
          if (col < H)
#pragma unroll
            for (int r = 0; r < kSplitRows; ++r)
              if (r0 + r < R) slot[((size_t(p) * nch + q) * R + r0 + r) * U + (col - p * U)] =
                  acc[ci][r];
        }
      }
#endif
      __syncthreads();  // the CTA's partials written
      if (tid == 0) {
        __threadfence();
        store_release(flags + q, unsigned(s));
      }
#ifndef AEC_NO_WAIT
      if (warp == 0) {  // every CTA of the group has published step s's partials
        for (int p = lane; p < nch; p += 32)
          for (long long spins = 0; load_acquire(flags + p) < unsigned(s);)
            if (++spins > kSpinLimit) __trap();
      }
#endif
      __syncthreads();
    }
    mbar_wait(in_full + (s & 1), unsigned(s >> 1) & 1u);  // step s's inputs landed

    // the cells of the own (row, unit) pairs: carry_h as the group's partials
    // summed in source order, dxp(t) out and into the own k-range
#ifndef AEC_NO_CELLS
    const float* x0 = inp + size_t(s & 1) * R * 6 * U;
    for (int i = tid; i < R * nu; i += kThreads) {
      const int r = i / nu, j = i - r * nu;
      const float* x = x0 + size_t(r) * 6 * U + j;
      float ch = 0.f;
      if (s > 0) {  // 16 loads in flight, added in source order
        const float* src = slot + (size_t(q) * nch * R + r) * U + j;
        int p = 0;
        for (; p + 16 <= nch; p += 16) {
          float v[16];
#pragma unroll
          for (int e = 0; e < 16; ++e) v[e] = __ldcg(src + size_t(p + e) * R * U);
#pragma unroll
          for (int e = 0; e < 16; ++e) ch += v[e];
        }
        for (; p < nch; ++p) ch += __ldcg(src + size_t(p) * R * U);
      }
      const float cprev = t > 0 ? x[5 * U] : 0.f;
      float d[4];
      bwd_cell(ch, x[0], x[U], x[2 * U], x[3 * U], x[4 * U], cb[r * U + j], cprev, cs[r * U + j],
               d, cs[r * U + j]);
      cb[r * U + j] = cprev;
      float* out = a.dxp + vec(r, t) * 4 * H + u0 + j;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        out[k * H] = d[k];
        dsm[size_t(k * U + j) * Rp + r] = d[k];
      }
    }
#endif
    __syncthreads();  // the cells done before the next step's dots and inputs
  }
}

// a cooperative launch of `ctas` CTAs of `kernel` (every CTA co-resident:
// the waits trap after kSpinLimit polls), or cudaErrorCooperativeLaunchTooLarge
template <typename Kernel>
cudaError_t coop_launch(Kernel kernel, void** params, int ctas, size_t smem, int device,
                        cudaStream_t stream) {
  int per_sm = 0, sms = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if (ctas > per_sm * sms) return cudaErrorCooperativeLaunchTooLarge;
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(ctas),
                                    dim3(kThreads), params, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// `kernel` allowed `smem` bytes of dynamic shared memory (and clusters past 8)
template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem, int cluster, int device) {
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  if (smem > static_cast<size_t>(optin)) return cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess || cluster <= 8) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

// a launch config of `ctas` CTAs in clusters of `cluster` (attr: its storage)
inline cudaLaunchConfig_t cluster_config(cudaLaunchAttribute* attr, int ctas, int cluster,
                                         size_t smem, cudaStream_t stream) {
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  return cfg;
}

template <int CPT>
cudaError_t split_launch(const BwdArgs& a, float* part, int ctas, size_t smem, int device,
                         cudaStream_t stream) {
  auto kernel = lstm_bwd_split_kernel<CPT>;
  cudaError_t err = set_smem(kernel, smem, 1, device);
  if (err != cudaSuccess) return err;
  BwdArgs args = a;
  void* params[] = {&args, &part};
  return coop_launch(kernel, params, ctas, smem, device, stream);
}

template <int MODE, int CW, int RT>
cudaError_t bwd_launch(const BwdArgs& a, int ctas, size_t smem, int device, cudaStream_t stream) {
  auto kernel = lstm_bwd_kernel<MODE, CW, RT>;
  cudaError_t err = set_smem(kernel, smem, MODE == kCluster ? a.nchunk : 1, device);
  if (err != cudaSuccess) return err;
  BwdArgs args = a;
  void* params[] = {&args};
  if (MODE == kGrid) return coop_launch(kernel, params, ctas, smem, device, stream);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      cluster_config(attr, ctas, MODE == kCluster ? a.nchunk : 1, smem, stream);
  err = cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(kernel), params);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// rows a sweep: one where a call of the dots takes one row, two where the
// grid plan's rounds take two, else as many as 32 / CW, at most 8 (fewer
// rows than that leave sums idle: only small shapes take them, and each
// rows-a-sweep is another instantiation a mode)
template <int MODE, int CW>
cudaError_t bwd_launch_cw(const BwdArgs& a, int sweep, int ctas, size_t smem, int device,
                          cudaStream_t stream) {
  constexpr int cap = 32 / CW < 8 ? 32 / CW : 8;
  if (sweep <= 1) return bwd_launch<MODE, CW, 1>(a, ctas, smem, device, stream);
  if constexpr (MODE == kGrid && cap > 2) {
    if (sweep <= 2) return bwd_launch<MODE, CW, 2>(a, ctas, smem, device, stream);
  }
  return bwd_launch<MODE, CW, cap>(a, ctas, smem, device, stream);
}

template <int MODE>
cudaError_t bwd_launch_mode(const BwdArgs& a, int cw, int sweep, int ctas, size_t smem,
                            int device, cudaStream_t stream) {
  switch (cw) {
    case 1: return bwd_launch_cw<MODE, 1>(a, sweep, ctas, smem, device, stream);
    case 2: return bwd_launch_cw<MODE, 2>(a, sweep, ctas, smem, device, stream);
    case 4: return bwd_launch_cw<MODE, 4>(a, sweep, ctas, smem, device, stream);
    case 8: return bwd_launch_cw<MODE, 8>(a, sweep, ctas, smem, device, stream);
    case 16: return bwd_launch_cw<MODE, 16>(a, sweep, ctas, smem, device, stream);
    default: return cudaErrorInvalidValue;
  }
}

// the clusters of `cluster` CTAs of `smem` bytes the card places at once
template <int CW>
int clusters_of(int cluster, size_t smem, int device) {
  auto kernel = lstm_bwd_kernel<kCluster, CW, 1>;
  if (set_smem(kernel, smem, cluster, device) != cudaSuccess) return 0;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(attr, cluster, cluster, smem, nullptr);
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess) {
    cudaGetLastError();  // clear the refusal: the answer is none
    return 0;
  }
  return n;
}

}  // namespace

// the float4 quads a thread holds in registers (the wrapper packs for it)
extern "C" int aec_lstm_bwd_reg_quads() { return kRegQuads; }

// how many clusters of `cluster` CTAs (cw columns a warp, `smem` bytes of
// shared memory a CTA) the card places at once: 0 where it places none
extern "C" int aec_lstm_bwd_clusters(int cluster, int smem, int cw, int device) {
  if (cudaSetDevice(device) != cudaSuccess || cluster < 1 || cluster > kMaxCluster) return 0;
  switch (cw) {
    case 1: return clusters_of<1>(cluster, smem, device);
    case 2: return clusters_of<2>(cluster, smem, device);
    case 4: return clusters_of<4>(cluster, smem, device);
    case 8: return clusters_of<8>(cluster, smem, device);
    case 16: return clusters_of<16>(cluster, smem, device);
    default: return 0;
  }
}

// g_ys (G, B, T, F, H), saved (G, B, T, F, 5H) fp32, H a multiple of 4; wp
// W_hh packed by kernels/lstm_bwd.py pack_backward for the plan: (G nchunk,
// npos CW, 512) float4 of columns, the split plan's (G nchunk, 4U, CW, 512)
// floats of rows; flags (G nchunk) zeroed; dxp (G, B, T, F, 4H); part the
// split plan's (G, 2, nchunk, nchunk, rows, U) partials (else null). All
// contiguous; the plan (mode, runs, run_rows, block_rows, units, nchunk, cw,
// ks, npos, jreg, jsm, round_rows, nbuf) from backward_plan. Returns a
// cudaError_t: a plan this source cannot run is cudaErrorInvalidValue, a grid
// the card cannot hold co-resident cudaErrorCooperativeLaunchTooLarge.
extern "C" int aec_lstm_bwd(const float* g_ys, const float* saved, const void* wp, void* flags,
                            float* dxp, float* part, int groups, int b, int t_steps, int f,
                            int hidden, int mode, int runs, int run_rows, int block_rows,
                            int units, int nchunk, int cw, int ks, int npos, int jreg, int jsm,
                            int round_rows, int nbuf, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int rows = b * f;
  if (mode == kSplit) {
    // cw: columns a thread (1 or 2), npos: the 4U k-values, jreg of them in registers
    if (hidden % 4 != 0 || units % 4 != 0 || (cw != 1 && cw != 2) || hidden > cw * kThreads ||
        npos != 4 * units || jreg > kSplitRegs / cw || jreg + jsm != npos ||
        nchunk * units < hidden || runs != 1 || run_rows != rows || block_rows != rows ||
        part == nullptr)
      return cudaErrorInvalidValue;
    if (t_steps == 0 || rows == 0) return cudaSuccess;
    const size_t smem =
        bwd_smem(kSplit, hidden, rows, rows, units, nchunk, cw, 1, jsm, 0, 0).total * sizeof(float);
    const BwdArgs a{g_ys, saved, static_cast<const float4*>(wp), static_cast<unsigned*>(flags),
                    dxp, b, t_steps, f, hidden, 1, rows, rows, units, nchunk, 1, npos, jreg, jsm,
                    0, 0};
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    return cw == 1 ? split_launch<1>(a, part, groups * nchunk, smem, device, s)
                   : split_launch<2>(a, part, groups * nchunk, smem, device, s);
  }
  const int kq = mode == kCluster ? nchunk * units : hidden;  // quads of k a staged row holds
  const bool shape_ok =
      hidden % 4 == 0 && units % 4 == 0 && ks >= 1 && kWarps % ks == 0 &&
      (kWarps / ks) * cw >= units && nchunk * units >= hidden && 32 * ks * npos >= kq &&
      runs * run_rows >= rows && block_rows >= 1 && block_rows <= run_rows &&
      jreg <= kRegQuads / cw && jreg + jsm <= npos && (jreg >= kRegQuads / cw || jreg >= npos);
  const bool mode_ok =
      (mode == kLocal && nchunk == 1) ||
      (mode == kCluster && runs == 1 && nchunk >= 2 && nchunk <= kMaxCluster &&
       block_rows == run_rows && size_t(run_rows) * 4 * hidden * sizeof(float) < (1u << 20)) ||
      (mode == kGrid && runs == 1 && round_rows >= 1 && round_rows <= block_rows && nbuf >= 1 &&
       nbuf <= kMaxBuf);
  if (!shape_ok || !mode_ok) return cudaErrorInvalidValue;
  if (t_steps == 0 || rows == 0) return cudaSuccess;
  const int ctas = groups * runs * nchunk;
  const size_t smem = bwd_smem(mode, hidden, run_rows, block_rows, units, nchunk, cw, ks, jsm,
                               round_rows, nbuf).total * sizeof(float);
  const BwdArgs a{g_ys, saved, static_cast<const float4*>(wp), static_cast<unsigned*>(flags),
                  dxp, b, t_steps, f, hidden, runs, run_rows, block_rows, units, nchunk, ks,
                  npos, jreg, jsm, round_rows, nbuf};
  const int sweep = mode == kGrid ? round_rows : block_rows;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == kLocal) return bwd_launch_mode<kLocal>(a, cw, sweep, ctas, smem, device, s);
  if (mode == kCluster) return bwd_launch_mode<kCluster>(a, cw, sweep, ctas, smem, device, s);
  return bwd_launch_mode<kGrid>(a, cw, sweep, ctas, smem, device, s);
}

// Kernel K11: FullSubNet's joint full-band -> embedding -> sub-band LSTM
// recurrence, the full band as a producer running ahead of the sub-band rows.
//
// Replaces aec_tpu/kernels/pallas_fullsubnet.py:106 _fsn_joint_fused_fwd
// (pallas_call at :154, body _kernel at :48-100). Per frame t, from zero
// state, for B utterances:
//   1. the full-band LSTM step (H_fb units; gates = xp_fb[t] + W_hh_fb h_fb);
//   2. the embedding emb(t) = relu(W_out h_fb(t) + b_out) over the F bins;
//   3. the sub-band LSTM step over the B F (utterance, bin) rows (H_sb units;
//      gates = xp_sb[t] + emb * w_col + W_hh_sb h_sb), h_sb(t) out.
// The hoisted input projections with both biases (xp_fb, xp_sb) and the mask
// head stay outside (kernels/fullsubnet.py), as in JAX. Everything is fp32
// (JAX's TPU kernel rounds the dots' operands to bf16).
//
// Design. The full band never reads the sub band, so the two recurrences are
// decoupled in time: one launch of thread-block clusters of kC CTAs, all
// co-resident (the grid is the number of clusters the card places at once,
// one CTA an SM), and no grid barrier.
//   - Cluster 0 is the producer. It steps the full-band LSTM of every
//     utterance over all T frames: CTA q owns units [q U, q U + U) and holds
//     their four gate rows of W_hh_fb (the first kRegPos positions a thread
//     in registers, the next in shared memory, the rest read from L2 each
//     step). Each step it sends its h slice into every CTA of the cluster by
//     st.async, counted on an mbarrier there, and waits on its own mbarrier
//     for the whole h (h_fb sits in three slots, one mbarrier each; one CTA
//     barrier a step keeps a slot from being overwritten while a warp still
//     reads it). A cluster barrier would cost a GPU-scope fence a step
//     (barrier.cluster.arrive's release compiles to MEMBAR.ALL.GPU). Then it
//     forms its bins' rows of the previous frame's emb and publishes them to
//     global memory as words that carry their step (the value's bits low,
//     t + 1 high).
//   - The other clusters are consumers. Each CTA owns a fixed run of
//     (utterance, bin) rows and steps their sub-band LSTM over all T frames on
//     its own, with W_hh_sb on chip (registers, then shared memory). It waits
//     only on its rows' emb(t) words (relaxed loads, issued a frame ahead,
//     with a back-off), keeps its rows' xp_sb up to 8 frames ahead in a
//     shared-memory ring filled by TMA bulk copies (an mbarrier a slot), and
//     takes one CTA barrier a frame.
// In both roles a thread owns one unit's four gates over a slice of k (slices
// of S lanes side by side in a warp, k quads s, s + S, ...; rows of W and h
// zero-padded to S np quads); the slices' sums meet by shuffles and one lane
// of the slice group steps the cell, so a step's gates never pass through
// shared memory. Rows of h go RT at a time, a template parameter of each
// role (pass_rows).
//
// What bounds it. Per frame at FullSubNetConfig() and B = 1: 0.26 M FMA
// full-band, 0.04 M embedding, 5.9 M sub-band, and 247 KB of xp_sb; over an
// 8.2 s utterance (820 frames) 5.1 G FMA and 203 MB, so the card's bound is
// the FMAs, ~0.15 ms at the fp32 peak. This design is bound by the longer of
// two serial chains a frame, each issue-bound on its SM: the producer's step
// (32 K FMA a CTA from registers, the reduction, the cells and their
// st.async, the embedding rows) and a consumer's step (36,864 FMA a row, two
// of six weight positions from shared memory, the reduction and the cells).
// At B = 1 the two are about even (a consumer CTA holds 1 or 2 of the 161
// rows); from B = 4 on the consumers set the pace. PERF.md has the measured
// split (kernels/fsn_costs.py).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kC = 8;           // CTAs a cluster (the portable size); cluster 0 produces
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRegPos = 4;      // weight positions (a float4 of each of 4 gates) in registers
constexpr int kDp = 3;          // the producer's ring of xp_fb frames
constexpr int kMaxDepth = 8;    // the consumers' ring of xp_sb frames, at most
constexpr int kBackoffNs = 64;  // between two reads of an emb word not yet written
constexpr long long kSpinLimit = 1ll << 24;  // ~10 s of polls: a lost producer traps, never hangs
constexpr size_t kPosFloats = size_t(4) * 4 * kThreads;  // one shared-memory position

struct FsnArgs {
  const float* __restrict__ xp_fb;  // (B, T, 4 Hf)
  const float* __restrict__ xp_sb;  // (B, T, F, 4 Hs)
  const float* __restrict__ w_fb;   // (4 Hf, hpp): W_hh of the full band, rows zero-padded
  const float* __restrict__ w_out;  // (F, Hf)
  const float* __restrict__ b_out;  // (F)
  const float* __restrict__ w_col;  // (4 Hs): the embedding column of the sub-band W_ih
  const float* __restrict__ w_sb;   // (4 Hs, hsq): W_hh of the sub band, rows zero-padded
  unsigned long long* emb;          // (T, B F) words: emb's bits, the step it is for; zeroed
  float* ys;                        // (B, T, F, Hs)
  // SAVE: what the backward (K9b, lstm_bwd.cu, over each band) reads: the
  // full band's activated gates and c (B, T, 5 Hf), the embedding before its
  // ReLU (B, T, F), the sub band's gates and c (B, T, F, 5 Hs)
  float* save_fb;
  float* save_emb;
  float* save_sb;
  int b, t_steps, f, hf, hs, up;
  int sp, np, jrp, jsp;             // producer slices, positions, in registers, in shared memory
  int sc, nc, jrc, jsc;             // the same for the consumers (none from L2)
  int rows, depth;                  // rows a consumer CTA, its ring of frames
};

// The launch plan: the fields of FsnArgs it sets, the grid and the bytes of
// shared memory the larger role needs (kernels/fullsubnet.py fsn_plan repeats it).
struct FsnPlan {
  int clusters, consumers, rows, depth, up;
  int sp, np, jrp, jsp, sc, nc, jrc, jsc;
  long long smem;
};

__host__ __device__ inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// rows of a pass over n rows (the producer's utterances, a consumer's
// rows): the smallest power of two >= n, at most 4
__host__ __device__ inline int pass_rows(int n) { return n <= 1 ? 1 : n <= 2 ? 2 : 4; }

// lanes a unit's k is split over: a power of two <= 32, no more than the
// quads of k, and a unit for every group of lanes
inline int slices(int units, int quads) {
  int s = 32;
  while (s > 1 && (s > quads || s * units > kThreads)) s >>= 1;
  return s;
}

// float offsets of the producer's shared memory: W_hh_fb's shared positions,
// h_fb's three slots (B rounded up to whole passes, S np quads a row), the
// mbarriers of those slots and of the xp_fb ring's, its bins' rows of W_out
// (Hf), the xp_fb ring (kDp, B, 4, U), c (B, U), its bins' b_out
struct ProdSmem {
  size_t ws, h, bar, wout, ring, c, bout, total;
};

__host__ __device__ inline ProdSmem prod_smem(int b, int hf, int up, int sp, int np, int nf,
                                              int jsp) {
  ProdSmem l;
  const int bp = ceil_div(b, pass_rows(b)) * pass_rows(b);
  l.ws = 0;
  l.h = l.ws + size_t(jsp) * kPosFloats;
  l.bar = l.h + size_t(3) * bp * 4 * sp * np;
  l.wout = l.bar + 4 * ceil_div(3 + kDp, 2);  // 3 + kDp mbarriers, 16-byte aligned
  l.ring = l.wout + size_t(nf) * hf;
  l.c = l.ring + size_t(kDp) * b * 4 * up;
  l.bout = l.c + size_t(b) * up;
  l.total = l.bout + nf;
  return l;
}

// float offsets of a consumer's: W_hh_sb's shared positions, the xp_sb ring
// (depth, R, 4 Hs) and its mbarriers, h's two slots (R rounded up to whole
// passes, S np quads a row), c (R, Hs), emb's two slots (R)
struct ConsSmem {
  size_t ws, ring, bar, h, c, emb, total;
};

__host__ __device__ inline ConsSmem cons_smem(int rows, int hs, int sc, int nc, int jsc,
                                              int depth) {
  ConsSmem l;
  l.ws = 0;
  l.ring = l.ws + size_t(jsc) * kPosFloats;
  l.bar = l.ring + size_t(depth) * rows * 4 * hs;
  l.h = l.bar + 4 * ceil_div(depth, 2);  // depth mbarriers, 16-byte aligned
  l.c = l.h + size_t(2) * ceil_div(rows, pass_rows(rows)) * pass_rows(rows) * 4 * sc * nc;
  l.emb = l.c + size_t(rows) * hs;
  l.total = l.emb + size_t(2) * rows;
  return l;
}

// `clusters`: how many clusters of kC CTAs (one an SM) the card places at
// once; `cap`: the bytes of shared memory a CTA may have
// (Hf a multiple of 4: the wrapper pads it)
inline cudaError_t make_plan(int b, int f, int hf, int hs, int clusters, size_t cap, FsnPlan* p) {
  const int nf = ceil_div(f, kC);
  p->up = 4 * ceil_div(hf, 4 * kC);
  if (hf % 4 != 0 || p->up > kThreads || hs > kThreads) return cudaErrorInvalidValue;
  p->sp = slices(p->up, hf / 4);
  p->np = ceil_div(hf / 4, p->sp);
  p->jrp = p->np < kRegPos ? p->np : kRegPos;
  const size_t other = prod_smem(b, hf, p->up, p->sp, p->np, nf, 0).total * sizeof(float);
  const size_t room = other < cap ? (cap - other) / (kPosFloats * sizeof(float)) : 0;
  p->jsp = int(room < size_t(p->np - p->jrp) ? room : size_t(p->np - p->jrp));
  p->sc = slices(hs, ceil_div(hs, 4));
  p->nc = ceil_div(ceil_div(hs, 4), p->sc);
  p->jrc = p->nc < kRegPos ? p->nc : kRegPos;
  p->jsc = p->nc - p->jrc;
  const int cc = clusters - 1 < ceil_div(b * f, kC) ? clusters - 1 : ceil_div(b * f, kC);
  if (cc < 1) return cudaErrorLaunchOutOfResources;
  p->clusters = cc + 1;
  p->consumers = cc * kC;
  p->rows = ceil_div(b * f, p->consumers);
  p->depth = kMaxDepth;
  while (p->depth > 2 && cons_smem(p->rows, hs, p->sc, p->nc, p->jsc, p->depth).total *
                                 sizeof(float) > cap)
    --p->depth;
  const long long smem_p =
      prod_smem(b, hf, p->up, p->sp, p->np, nf, p->jsp).total * sizeof(float);
  const long long smem_c =
      cons_smem(p->rows, hs, p->sc, p->nc, p->jsc, p->depth).total * sizeof(float);
  p->smem = smem_p > smem_c ? smem_p : smem_c;
  return cudaSuccess;
}

// ---------------------------------------------------------------- PTX

// emb's words: written and read whole, so a word that carries step t + 1
// carries emb(t)
__device__ __forceinline__ unsigned long long load_word(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_word(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// mbarriers: a phase completes when its one arrival (with the bytes it
// expects) has come and that many bytes of st.async have landed
__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_expect(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes) : "memory");
}

// until the phase of this parity has completed
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  asm volatile(
      "{\n .reg .pred done;\n WAIT_%=:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      " @!done bra WAIT_%=;\n}" ::"r"(smem_u32(bar)), "r"(parity) : "memory");
}

// v into CTA `rank`'s copy of the shared word `dst`, counted on its copy of `bar`
__device__ __forceinline__ void st_async(float* dst, float v, unsigned long long* bar,
                                         unsigned rank) {
  unsigned d, b;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(d) : "r"(smem_u32(dst)), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(b) : "r"(smem_u32(bar)), "r"(rank));
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];" ::"r"(d),
               "r"(__float_as_uint(v)), "r"(b) : "memory");
}

// TMA: `bytes` (a multiple of 16) from global to this CTA's shared memory,
// counted on `bar`
__device__ __forceinline__ void bulk_copy(float* dst, const float* src, unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}

// ---------------------------------------------------------------- the shared step

__device__ __forceinline__ float sigmoid_f(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ float dot4(const float4 h, const float4 w, float acc) {
  acc = fmaf(h.x, w.x, acc);
  acc = fmaf(h.y, w.y, acc);
  acc = fmaf(h.z, w.z, acc);
  return fmaf(h.w, w.w, acc);
}

// nn.LSTM's cell on the pre-activations [i, f, g, o]; c in place, h out;
// SAVE: the activated gates and c also to sv[0], sv[w], ..., sv[4 w]
template <bool SAVE>
__device__ __forceinline__ float lstm_cell(const float (&p)[4], float* c, float* sv, int w) {
  const float ig = sigmoid_f(p[0]);
  const float fg = sigmoid_f(p[1]);
  const float gg = tanhf(p[2]);
  const float og = sigmoid_f(p[3]);
  const float cn = fg * *c + ig * gg;
  *c = cn;
  if constexpr (SAVE) {
    sv[0] = ig;
    sv[w] = fg;
    sv[2 * w] = gg;
    sv[3 * w] = og;
    sv[4 * w] = cn;
  }
  return og * tanhf(cn);
}

// A thread's weights: unit u's four gate rows (row g at w + g gstride, S np
// quads each, zero past the width) at the quads k4 = s + S j of position j;
// the first jr positions in registers, the next js in shared memory
// (position-major, then gate, then thread), the rest stay in global memory
// and are read from L2 each step.
struct UnitW {
  float4 r[kRegPos][4];
  const float4* sm;  // this thread's first shared position
  const float* w;    // gate 0's row
  size_t gstride;    // floats from a gate's row to the next
  int s, S, np, jr, js;
};

__device__ __forceinline__ float4 row_quad(const UnitW& w, int g, int j) {
  return __ldg(reinterpret_cast<const float4*>(w.w + g * w.gstride) + w.s + w.S * j);
}

__device__ __forceinline__ void load_unit_w(UnitW& w, float4* ws) {
#pragma unroll
  for (int j = 0; j < kRegPos; ++j)
#pragma unroll
    for (int g = 0; g < 4; ++g) w.r[j][g] = j < w.jr ? row_quad(w, g, j) : float4{};
  w.sm = ws + threadIdx.x;
  for (int j = 0; j < w.js; ++j)
    for (int g = 0; g < 4; ++g) ws[(j * 4 + g) * kThreads + threadIdx.x] = row_quad(w, g, w.jr + j);
}

// RT rows of h (row r at h4 + r hq) at quad k4 against one position's four gates
template <int RT>
__device__ __forceinline__ void rows_fma(const float4 (&w)[4], const float4* h4, int hq, int k4,
                                         float (&acc)[RT][4]) {
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    const float4 h = h4[r * hq + k4];
#pragma unroll
    for (int g = 0; g < 4; ++g) acc[r][g] = dot4(h, w[g], acc[r][g]);
  }
}

// RT rows of h (S np quads a row, zero past the width) against the thread's
// slice of its unit's four gate rows, then summed over the slice group's S
// lanes: every lane of the group ends with the four sums of every row
template <int RT>
__device__ __forceinline__ void unit_gates(const UnitW& w, const float4* h4, float (&acc)[RT][4]) {
  const int hq = w.S * w.np;
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int g = 0; g < 4; ++g) acc[r][g] = 0.f;
#pragma unroll
  for (int j = 0; j < kRegPos; ++j)
    if (j < w.jr) rows_fma<RT>(w.r[j], h4, hq, w.s + w.S * j, acc);
#pragma unroll 1
  for (int j = 0; j < w.js; ++j) {
    float4 q[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) q[g] = w.sm[(j * 4 + g) * kThreads];
    rows_fma<RT>(q, h4, hq, w.s + w.S * (w.jr + j), acc);
  }
#pragma unroll 1
  for (int j = w.jr + w.js; j < w.np; ++j) {
    float4 q[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) q[g] = row_quad(w, g, j);
    rows_fma<RT>(q, h4, hq, w.s + w.S * j, acc);
  }
#pragma unroll 1
  for (int o = w.S >> 1; o > 0; o >>= 1)
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int g = 0; g < 4; ++g) acc[r][g] += __shfl_xor_sync(0xffffffffu, acc[r][g], o);
}

// row r's four sums, by selects (no local memory)
template <int RT>
__device__ __forceinline__ void pick(const float (&acc)[RT][4], int r, float (&p)[4]) {
#pragma unroll
  for (int g = 0; g < 4; ++g) p[g] = acc[0][g];
#pragma unroll
  for (int i = 1; i < RT; ++i)
#pragma unroll
    for (int g = 0; g < 4; ++g) p[g] = r == i ? acc[i][g] : p[g];
}

// ---------------------------------------------------------------- the producer

template <int RT, bool SAVE>
__device__ void producer(const FsnArgs& a, float* smem) {
  cg::cluster_group cluster = cg::this_cluster();
  const int q = static_cast<int>(cluster.block_rank());
  const int B = a.b, T = a.t_steps, F = a.f, H = a.hf, U = a.up, S = a.sp;
  const int hq = H / 4, hpp = 4 * S * a.np, bp = ceil_div(B, RT) * RT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int s = tid % S, u = tid / S, u0 = q * U, nu = min(U, H - u0);
  const bool live = u < nu;
  const int f0 = q * F / kC, nf = (q + 1) * F / kC - f0;
  const ProdSmem lay = prod_smem(B, H, U, S, a.np, ceil_div(F, kC), a.jsp);
  float* hsl = smem + lay.h;  // (3, bp, hpp): h_fb(t) in slot (t + 1) % 3
  float* wout = smem + lay.wout;
  float* ring = smem + lay.ring;
  float* cs = smem + lay.c;
  float* bout = smem + lay.bout;
  // the h slots' mbarriers, then the ring's
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(smem + lay.bar);
  unsigned long long* rbars = bars + 3;

  UnitW w;
  w.w = a.w_fb + size_t(live ? u0 + u : 0) * hpp;  // a dead unit reads unit 0's rows
  w.gstride = size_t(H) * hpp;
  w.s = s, w.S = S, w.np = a.np, w.jr = a.jrp, w.js = a.jsp;
  load_unit_w(w, reinterpret_cast<float4*>(smem + lay.ws));
  for (int i = tid; i < nf * H; i += kThreads) wout[i] = a.w_out[size_t(f0) * H + i];
  for (int i = tid; i < nf; i += kThreads) bout[i] = a.b_out[f0 + i];
  for (int i = tid; i < 3 * bp * hpp; i += kThreads) hsl[i] = 0.f;
  for (int i = tid; i < B * U; i += kThreads) cs[i] = 0.f;

  // the own units' xp_fb of frame tf into ring slot tf % kDp by TMA: a copy
  // of nu floats for each (utterance, gate), issued by warp 0's lanes
  auto stage = [&](int tf) {
    if (warp != 0 || nu <= 0 || tf >= T) return;
    unsigned long long* bar = rbars + tf % kDp;
    if (lane == 0) mbar_expect(bar, unsigned(B) * 4 * nu * sizeof(float));
    for (int i = lane; i < 4 * B; i += 32)
      bulk_copy(ring + ((tf % kDp) * B + i / 4) * 4 * U + (i % 4) * U,
                a.xp_fb + (size_t(i / 4) * T + tf) * 4 * H + (i % 4) * H + u0,
                unsigned(nu) * sizeof(float), bar);
  };
  // the own bins' rows of emb(te) from h_fb(te), out as words: an item
  // (utterance, bin) a group of se lanes, k split over them
  int se = 16;
  while (se > hq) se >>= 1;
  auto embed = [&](int te) {
    const float4* h4 = reinterpret_cast<const float4*>(hsl + ((te + 1) % 3) * bp * hpp);
    const float4* w4 = reinterpret_cast<const float4*>(wout);
    for (int i0 = (tid & ~31) / se; i0 < nf * B; i0 += kThreads / se) {
      const int i = i0 + lane / se, b = i / max(nf, 1), r = i - b * nf, k0 = lane % se;
      float acc = 0.f;
      if (i < nf * B)
        for (int k4 = k0; k4 < hq; k4 += se)
          acc = dot4(h4[b * (hpp / 4) + k4], w4[r * hq + k4], acc);
      for (int o = se >> 1; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (i < nf * B && k0 == 0) {
        store_word(a.emb + (size_t(te) * B + b) * F + f0 + r,
                   (static_cast<unsigned long long>(te + 1) << 32) |
                       __float_as_uint(fmaxf(acc + bout[r], 0.f)));
        if constexpr (SAVE) a.save_emb[(size_t(b) * T + te) * F + f0 + r] = acc + bout[r];
      }
    }
  };

  // h_fb(t) lands in slot (t + 1) % 3 of every CTA by st.async, counted
  // on the slot's mbarrier there: the bytes of every unit of every utterance
  const unsigned slot_bytes = unsigned(B) * H * sizeof(float);
  if (tid == 0) {
    for (int k = 0; k < 3 + kDp; ++k) mbar_init(bars + k);
    mbar_init_fence();
  }
  cluster.sync();  // every CTA's slots zeroed and mbarriers set before any st.async
  for (int tf = 0; tf < kDp - 1; ++tf) stage(tf);

  const bool warp_live = (tid & ~31) / S < nu;  // some unit of this warp is the CTA's
  for (int t = 0; t < T; ++t) {
    // h_fb(t - 1), the (t - 1) / 3-th use of slot t % 3, and xp_fb(t) landed
    if (t > 0) mbar_wait(bars + t % 3, unsigned((t - 1) / 3) & 1u);
    if (nu > 0) mbar_wait(rbars + t % kDp, unsigned(t / kDp) & 1u);
    // every warp past frame t - 1 (its embedding rows read slot (t + 1) % 3's
    // last h, its cells ring slot (t - 1) % kDp) before any CTA's h(t) can
    // land there and frame t + kDp - 1 is staged there: the CTAs that write
    // h(t) first wait for this CTA's h(t - 1), stored after this barrier
    __syncthreads();
    if (tid == 0) mbar_expect(bars + (t + 1) % 3, slot_bytes);
    stage(t + kDp - 1);
    const float4* hprev = reinterpret_cast<const float4*>(hsl + (t % 3) * bp * hpp);
    float* hnext = hsl + ((t + 1) % 3) * bp * hpp;
    for (int r0 = 0; warp_live && r0 < B; r0 += RT) {
      float acc[RT][4];
      unit_gates<RT>(w, hprev + r0 * (hpp / 4), acc);
      // lane s steps rows s, s + S, ... of the pass and sends h to every CTA
      for (int r = s; live && r < RT && r0 + r < B; r += S) {
        const int b = r0 + r;
        const float* x = ring + ((t % kDp) * B + b) * 4 * U + u;
        float p[4];
        pick<RT>(acc, r, p);
#pragma unroll
        for (int g = 0; g < 4; ++g) p[g] += x[g * U];
        float* sv = SAVE ? a.save_fb + (size_t(b) * T + t) * 5 * H + u0 + u : nullptr;
        const float h = lstm_cell<SAVE>(p, cs + b * U + u, sv, H);
        for (int m = 0; m < kC; ++m) st_async(hnext + b * hpp + u0 + u, h, bars + (t + 1) % 3, m);
      }
    }
    if (t > 0) embed(t - 1);
  }
  mbar_wait(bars + T % 3, unsigned((T - 1) / 3) & 1u);
  embed(T - 1);
  cluster.sync();  // no CTA leaves while another may still write into it
}

// ---------------------------------------------------------------- the consumers

template <int RT, bool SAVE>
__device__ void consumer(const FsnArgs& a, float* smem) {
  const int cta = blockIdx.x - kC, ncons = gridDim.x - kC, rows = a.b * a.f;
  const int r0 = int((long long)cta * rows / ncons);
  const int nr = int((long long)(cta + 1) * rows / ncons) - r0;
  if (nr <= 0) return;
  const int T = a.t_steps, F = a.f, Hs = a.hs, S = a.sc, R = a.rows, D = a.depth;
  const int hsq = 4 * S * a.nc;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, s = tid % S, u = tid / S;
  const bool live = u < Hs;
  const ConsSmem lay = cons_smem(R, Hs, S, a.nc, a.jsc, D);
  float* ring = smem + lay.ring;  // (D, R, 4 Hs)
  float* hsl = smem + lay.h;      // (2, R rounded up, hsq): h_sb(t) in slot (t + 1) & 1
  float* cs = smem + lay.c;
  float* embv = smem + lay.emb;   // (2, R): emb(t) in slot t & 1
  const int hslot = ceil_div(R, RT) * RT * hsq;

  UnitW w;
  w.w = a.w_sb + size_t(live ? u : 0) * hsq;  // a dead unit reads unit 0's rows
  w.gstride = size_t(Hs) * hsq;
  w.s = s, w.S = S, w.np = a.nc, w.jr = a.jrc, w.js = a.jsc;
  load_unit_w(w, reinterpret_cast<float4*>(smem + lay.ws));
  float wc[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) wc[g] = live ? a.w_col[g * Hs + u] : 0.f;
  for (int i = tid; i < 2 * hslot; i += kThreads) hsl[i] = 0.f;
  for (int i = tid; i < R * Hs; i += kThreads) cs[i] = 0.f;

  // the own rows' xp_sb of frame tf into ring slot tf % D by TMA, counted on
  // the slot's mbarrier: the rows are consecutive, one copy for each
  // utterance they span
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(smem + lay.bar);
  auto stage = [&](int tf) {
    if (tid != 0 || tf >= T) return;
    mbar_expect(bars + tf % D, unsigned(nr) * 4 * Hs * sizeof(float));
    for (int r = 0; r < nr;) {
      const int row = r0 + r, b = row / F, f = row - b * F, n = min(nr - r, F - f);
      bulk_copy(ring + ((tf % D) * R + r) * 4 * Hs,
                a.xp_sb + ((size_t(b) * T + tf) * F + f) * 4 * Hs,
                unsigned(n) * 4 * Hs * sizeof(float), bars + tf % D);
      r += n;
    }
  };
  // the own rows' emb words of frame te (loaded a frame ahead of their use)
  auto emb_word = [&](int te) {
    return te < T ? load_word(a.emb + size_t(te) * rows + r0 + tid) : 0ull;
  };

  if (tid == 0) {
    for (int k = 0; k < D; ++k) mbar_init(bars + k);
    mbar_init_fence();
  }
  __syncthreads();
  for (int tf = 0; tf < D - 1; ++tf) stage(tf);
  const bool warp_live = (tid & ~31) / S < Hs;  // some unit of this warp is live
  unsigned long long word = tid < nr ? emb_word(0) : 0ull;
  for (int t = 0; t < T; ++t) {
    if (tid < nr) {  // the own rows' emb(t), once the producer has published it
#ifndef AEC_CONSUMERS_ONLY
      for (long long spins = 0; unsigned(word >> 32) != unsigned(t + 1); word = emb_word(t)) {
        if (++spins > kSpinLimit) __trap();
        __nanosleep(kBackoffNs);
      }
#endif
      embv[(t & 1) * R + tid] = __uint_as_float(unsigned(word));
      word = emb_word(t + 1);
    }
    mbar_wait(bars + t % D, unsigned(t / D) & 1u);  // frame t landed
    __syncthreads();
    stage(t + D - 1);  // into the slot frame t - 1 left
    const float4* hprev = reinterpret_cast<const float4*>(hsl + (t & 1) * hslot);
    float* hnext = hsl + ((t + 1) & 1) * hslot;
    for (int q0 = 0; warp_live && q0 < nr; q0 += RT) {
      float acc[RT][4];
      unit_gates<RT>(w, hprev + q0 * (hsq / 4), acc);
      // lane s steps rows s, s + S, ... of the pass
      for (int r = s; live && r < RT && q0 + r < nr; r += S) {
        const int row = q0 + r;
        const float* x = ring + ((t % D) * R + row) * 4 * Hs + u;
        const float e = embv[(t & 1) * R + row];
        float p[4];
        pick<RT>(acc, r, p);
#pragma unroll
        for (int g = 0; g < 4; ++g) p[g] = (x[g * Hs] + e * wc[g]) + p[g];
        const int gr = r0 + row, b = gr / F, f = gr - b * F;
        float* sv = SAVE ? a.save_sb + ((size_t(b) * T + t) * F + f) * 5 * Hs + u : nullptr;
        const float h = lstm_cell<SAVE>(p, cs + row * Hs + u, sv, Hs);
        hnext[row * hsq + u] = h;
        a.ys[((size_t(b) * T + t) * F + f) * Hs + u] = h;
      }
    }
  }
}

// PR and CR: the producer's and the consumers' rows a pass; SAVE: both
// roles also write what the backward reads, the arithmetic unchanged
template <int PR, int CR, bool SAVE>
__global__ void __launch_bounds__(kThreads, 1) fsn_kernel(FsnArgs a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  if (blockIdx.x < kC) {
#ifndef AEC_CONSUMERS_ONLY
    producer<PR, SAVE>(a, smem);
#endif
  } else {
#ifndef AEC_PRODUCER_ONLY
    consumer<CR, SAVE>(a, smem);
#endif
  }
}

template <int PR, bool SAVE>
const void* kernel_cr(int rows) {
  switch (pass_rows(rows)) {
    case 1: return reinterpret_cast<const void*>(fsn_kernel<PR, 1, SAVE>);
    case 2: return reinterpret_cast<const void*>(fsn_kernel<PR, 2, SAVE>);
    default: return reinterpret_cast<const void*>(fsn_kernel<PR, 4, SAVE>);
  }
}

template <bool SAVE>
const void* kernel_pr(int b, int rows) {
  switch (pass_rows(b)) {
    case 1: return kernel_cr<1, SAVE>(rows);
    case 2: return kernel_cr<2, SAVE>(rows);
    default: return kernel_cr<4, SAVE>(rows);
  }
}

// the instantiation for B utterances, a consumer's rows and saving or not
const void* kernel_for(int b, int rows, bool save = false) {
  return save ? kernel_pr<true>(b, rows) : kernel_pr<false>(b, rows);
}

cudaLaunchConfig_t launch_config(int clusters, size_t smem, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kC;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cfg.gridDim = dim3(clusters * kC);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  return cfg;
}

// The plan at this shape on this device: every CTA takes all the shared
// memory a CTA may have (so one CTA an SM, whatever the instantiation), and
// the clusters are as many as the card places at once, so that every CTA is
// resident while consumers wait on the producer.
cudaError_t query(int b, int f, int hf, int hs, int device, FsnPlan* p, size_t* optin) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  int cap = 0;
  err = cudaDeviceGetAttribute(&cap, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  *optin = static_cast<size_t>(cap);
  const void* kernel = kernel_for(1, 1);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, cap);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = launch_config(1, *optin, nullptr, attr);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return err;
  return make_plan(b, f, hf, hs, clusters, *optin, p);
}

}  // namespace

// the plan at this shape on this device, as 14 ints: clusters, consumers,
// rows, depth, up, sp, np, jrp, jsp, sc, nc, jrc, jsc, shared-memory bytes
extern "C" int aec_fsn_plan(int b, int f, int hf, int hs, int device, long long* out) {
  FsnPlan p{};
  size_t optin = 0;
  const cudaError_t err = query(b, f, hf, hs, device, &p, &optin);
  if (err != cudaSuccess) return err;
  const long long v[] = {p.clusters, p.consumers, p.rows, p.depth, p.up, p.sp, p.np,
                         p.jrp, p.jsp, p.sc, p.nc, p.jrc, p.jsc, p.smem};
  for (int i = 0; i < 14; ++i) out[i] = v[i];
  return cudaSuccess;
}

// xp_fb (B, T, 4 Hf), xp_sb (B, T, F, 4 Hs), w_fb (4 Hf, 4 sp np), w_out
// (F, Hf), b_out (F), w_col (4 Hs), w_sb (4 Hs, 4 sc nc), emb (T, B F)
// zeroed words, ys (B, T, F, Hs); save_fb (B, T, 5 Hf), save_emb (B, T, F),
// save_sb (B, T, F, 5 Hs), all three or none null (no saving); sp np and sc
// nc the plan's (aec_fsn_plan), the rows' padding zero. All fp32 but emb,
// contiguous; B, T, F, Hs >= 1, Hf a positive multiple of 4.
extern "C" int aec_fsn(const float* xp_fb, const float* xp_sb, const float* w_fb,
                       const float* w_out, const float* b_out, const float* w_col,
                       const float* w_sb, void* emb, float* ys, float* save_fb, float* save_emb,
                       float* save_sb, int b, int t_steps, int f, int hf, int hs, int device,
                       void* stream) {
  FsnPlan p{};
  size_t optin = 0;
  cudaError_t err = query(b, f, hf, hs, device, &p, &optin);
  if (err != cudaSuccess) return err;
  if (p.smem > static_cast<long long>(optin)) return cudaErrorInvalidConfiguration;
  const bool save = save_fb != nullptr;
  if (save != (save_emb != nullptr) || save != (save_sb != nullptr)) return cudaErrorInvalidValue;
  const FsnArgs a{xp_fb, xp_sb, w_fb, w_out, b_out, w_col, w_sb,
                  static_cast<unsigned long long*>(emb), ys, save_fb, save_emb, save_sb,
                  b, t_steps, f, hf, hs,
                  p.up, p.sp, p.np, p.jrp, p.jsp, p.sc, p.nc, p.jrc, p.jsc, p.rows, p.depth};
  const void* kernel = kernel_for(b, p.rows, save);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(optin));
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      launch_config(p.clusters, optin, static_cast<cudaStream_t>(stream), attr);
  void* args[] = {const_cast<FsnArgs*>(&a)};
  err = cudaLaunchKernelExC(&cfg, kernel, args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Kernel K9: DCCRN's grouped complex-LSTM recurrence on one persistent grid.
//
// Replaces aec_tpu/kernels/pallas_lstm.py:88 _grouped_lstm_fused_fwd
// (pallas_call at :123), the forward of complex_lstm_scan_fused. As there,
// the input projections of all four naive-complex paths and both biases are
// hoisted into one matmul outside (kernels/lstm.py), so the kernel carries
// only the recurrence: two parameter groups (real, imag), each over 2B rows
// (the real and the imaginary inputs), per step one (2B, H) x (H, 4H) product
// per group, then nn.LSTM's i/f/g/o gates carrying c and h from zero.
//
// Design. On the TPU h, c and both groups' W_hh sat in VMEM for the whole
// time grid. Here W_hh (33.6 MB in fp32 at DCCRN's H = 1024) fits no CTA's
// or cluster's shared memory (254 KB per SM over 132 SMs) but does fit the
// 50 MB L2, so grid_scan.cuh splits the 2 x H (group, unit) pairs over one
// persistent grid of co-resident CTAs, about one per SM: each owns U units
// of one group and their 4 gate columns of W_hh^T (read from L2 every step),
// loads its group's h (2B x H) into shared memory, computes its units' gates
// for all 2B rows, writes h to a ping-pong buffer, and one grid barrier ends
// the step. Everything is fp32, so K9 agrees with the plain scan to fp32
// round-off (the TPU kernel rounds h and W to bf16, pallas_lstm.py:61-67).
//
// What bounds it. The card's bound for the work is the FMAs (8.6 G per
// layer at B = 1, T = 513: 0.26 ms at the fp32 peak); the design instead
// streams all of W_hh from L2 once per step and pays one grid barrier, both
// serial in time. A bf16 W resident in shared memory (127 KB per SM) or in
// registers is the lever left for later.

#include "grid_scan.cuh"

using namespace aec_grid;

// (units per CTA) of the launch plan at this shape: the wrapper packs W_hh^T
// with it
extern "C" int aec_lstm_units(int groups, int rows, int hidden, int device) {
  GridPlan<LstmCell> p{};
  if (grid_plan(groups, rows, hidden, device, &p) != cudaSuccess) return -1;
  return p.units;
}

// shared memory of one CTA of the plan, bytes
extern "C" long long aec_lstm_smem(int rows, int hidden, int units) {
  return static_cast<long long>(grid_smem_floats<LstmCell>(rows, hidden, units) * sizeof(float));
}

// xp (G, R, T, 4H); wp (G, nchunk, H, 4U) packed W_hh^T; hbuf (2, G, R, H)
// zeroed; ys (G, R, T, H). All fp32, contiguous.
extern "C" int aec_lstm(const float* xp, const float* wp, float* hbuf, float* ys, int groups,
                        int rows, int t_steps, int hidden, int units, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  GridPlan<LstmCell> p{};
  err = grid_plan(groups, rows, hidden, device, &p);
  if (err != cudaSuccess) return err;
  if (p.units != units) return cudaErrorInvalidValue;  // W_hh^T packed for another plan
  const GridArgs a{xp, wp, nullptr, ys, hbuf, rows, t_steps, hidden, p.units, p.nchunk};
  return grid_launch(a, p, device, static_cast<cudaStream_t>(stream));
}

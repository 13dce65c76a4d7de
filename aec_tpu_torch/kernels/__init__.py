"""Hand-written CUDA C++ kernels for Hopper (sm_90a), each beside its plain
PyTorch version (counterpart of ``aec_tpu/kernels``).

- ``kalman``  — K1, batched Kalman stage 1 (``csrc/kalman_batched.cu``), its
  spectra-in instantiation K12, and K6, single-stream Kalman stage 1 on one
  thread-block cluster (``csrc/single_stream.cu``);
- ``nlms``    — K5, batched NLMS stage 1 (``csrc/nlms_batched.cu``), and K7,
  single-stream NLMS stage 1 (``csrc/single_stream.cu``);
- ``stage2``  — K2, batched LittleNet stage 2 as passes over all frames
  (``csrc/stage2.cu`` on ``csrc/fft.cuh``, its GRU recurrence on K8);
- ``fft_plan`` — the radix plans and twiddles of the FFTs of K1, K12, K2, K3
  and K4, and a plain-torch model of their schedule;
- ``phase_costs`` — a card tool that times K2's phases with parts cut out;
- ``serving`` — K3, the streaming serving step for S live streams with a
  Kalman or NLMS stage 1, state in place (``csrc/serving.cu``), with the
  serving state and its migrations;
- ``two_stage`` — K4, both stages in one launch (``csrc/two_stage.cu``);
- ``hop`` — the two-stage hop K3 and K4 share (``csrc/hop.cuh``): the
  launch constants prepared once per net and geometry, and a plain-torch
  model of the hop on FFTs;
- ``serving_costs`` — a card tool that splits a K3 call's time between the
  host and the kernel;
- ``gru``     — K8, the GRU recurrence, and K8b, its backward
  (``csrc/gru.cu``), and the autograd Function of the fused GRU scan;
- ``lstm``    — K9, DCCRN's grouped complex-LSTM recurrence (``csrc/lstm.cu``,
  W_hh held on chip, packed once per weight tensor, the gates saved for the
  backward), and its autograd Function;
- ``lstm_bwd`` — K9b, the LSTM recurrence's backward on the gates K9 and
  K11 save (``csrc/lstm_bwd.cu``, W_hh on chip, the inputs streamed by
  TMA; by plan dxp kept in the CTA, pushed through a cluster or taken
  from device memory, or the product split over k);
- ``lstm_bwd_costs`` — a card tool that times K9b's step whole and with
  each part cut out;
- ``lstm_int8`` — K10, the int8 LSTM recurrence of ATT-CCRN's bottleneck
  (``csrc/lstm_int8.cu``, the codes held on chip, quantized and laid out
  once per weight tensor);
- ``lstm_costs`` — a card tool that times K9's and K10's steps with their
  dots cut out;
- ``fullsubnet`` — K11, FullSubNet's joint full-band / sub-band LSTM
  recurrence (``csrc/fullsubnet.cu``), and its autograd Function (its
  backward K9b over each band);
- ``consts``  — their constant DFT bases, fp32, cached per device;
- ``_build``  — ``nvcc`` at first use, ctypes binding, error checks.

``csrc/bl_common.cuh`` holds the geometry, the shared-memory carving and
the dense per-step device code, ``csrc/fft.cuh`` the CTA-wide real FFTs,
``csrc/stage1_fft.cuh`` the stage-1 steps on them, ``csrc/stage2_fft.cuh``
the stage-2 pieces on them, ``csrc/lstm_common.cuh`` the dots and warp
reduction K9 and K9b share.
A wrapper launches its kernel for a CUDA tensor (or raises) and takes the
plain version for a CPU tensor; each counts its launches in ``.launches``.
"""

"""Hand-written CUDA C++ kernels for Hopper (sm_90a), each beside its plain
PyTorch version (counterpart of ``aec_tpu/kernels``).

- ``kalman``  — K1, batched Kalman stage 1 (``csrc/kalman_batched.cu``), its
  spectra-in instantiation K12, and K6, single-stream Kalman stage 1 on one
  thread-block cluster (``csrc/single_stream.cu``);
- ``nlms``    — K5, batched NLMS stage 1 (``csrc/nlms_batched.cu``), and K7,
  single-stream NLMS stage 1 (``csrc/single_stream.cu``);
- ``stage2``  — K2, batched LittleNet stage 2 (``csrc/stage2.cu``);
- ``serving`` — K3, the streaming serving step for S live streams with a
  Kalman or NLMS stage 1, state in place (``csrc/serving.cu``), with the
  serving state and its migrations;
- ``two_stage`` — K4, both stages in one launch (``csrc/two_stage.cu``);
- ``gru``     — K8, the GRU recurrence (``csrc/gru.cu``), and the autograd
  Function of the fused GRU scan;
- ``lstm``    — K9, DCCRN's grouped complex-LSTM recurrence (``csrc/lstm.cu``
  on ``csrc/grid_scan.cuh``), and its autograd Function;
- ``lstm_int8`` — K10, the int8 LSTM recurrence of ATT-CCRN's bottleneck
  (``csrc/lstm_int8.cu``);
- ``fullsubnet`` — K11, FullSubNet's joint full-band / sub-band LSTM
  recurrence (``csrc/fullsubnet.cu``), and its autograd Function;
- ``consts``  — their constant DFT bases, fp32, cached per device;
- ``_build``  — ``nvcc`` at first use, ctypes binding, error checks.

``csrc/bl_common.cuh`` holds the per-step device code the kernels share.
A wrapper launches its kernel for a CUDA tensor (or raises) and takes the
plain version for a CPU tensor; each counts its launches in ``.launches``.
"""

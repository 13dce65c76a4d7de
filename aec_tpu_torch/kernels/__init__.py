"""Hand-written CUDA C++ kernels for Hopper (sm_90a), each beside its plain
PyTorch version (counterpart of ``aec_tpu/kernels``).

- ``kalman``  — K1, batched Kalman stage 1 (``csrc/kalman_batched.cu``);
- ``stage2``  — K2, batched LittleNet stage 2 (``csrc/stage2.cu``);
- ``consts``  — their constant DFT bases, fp32, cached per device;
- ``_build``  — ``nvcc`` at first use, ctypes binding, error checks.

``csrc/bl_common.cuh`` holds the per-step device code both kernels share.
A wrapper launches its kernel for a CUDA tensor (or raises) and takes the
plain version for a CPU tensor; each counts its launches in ``.launches``.
"""

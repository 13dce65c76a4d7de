"""aec_tpu_torch — the PyTorch/CUDA port of ``aec_tpu`` for NVIDIA Hopper.

A second package beside ``aec_tpu`` (the JAX reference, which stays as it
is). The layout mirrors ``aec_tpu`` so every module has a named counterpart:

- ``aec_tpu_torch.dsp``      — windows, ERB filterbank, STFT/iSTFT as
  DFT-basis matmuls, GCC-PHAT bulk-delay alignment (``aec_tpu/dsp``);
- ``aec_tpu_torch.linear``   — overlap-save machinery and the partitioned-
  block frequency-domain Kalman and NLMS cancellers (``aec_tpu/linear``);
- ``aec_tpu_torch.ops``      — the GRU and LSTM recurrences, DCCRN's complex
  conv/norm layers (``aec_tpu/ops``);
- ``aec_tpu_torch.models``   — LittleNet, TwoLayerGRU and DCCRN as
  ``nn.Module`` s, and the registry of the ported families;
- ``aec_tpu_torch.pipeline`` — the two-stage composition, the streaming
  (frame-in / frame-out) runtime, the ``.ex`` files, wav I/O;
- ``aec_tpu_torch.kernels``  — hand-written CUDA C++ kernels for sm_90a, each
  beside its plain PyTorch version. A CUDA tensor goes through the kernel
  (or the call raises); a CPU tensor takes the plain version.
- ``aec_tpu_torch.train``    — LittleNet's trainer, the model adapters, loss
  metrics and checkpoints in the JAX package's format;
- ``aec_tpu_torch.cli``      — ``python -m aec_tpu_torch.cli.train`` and
  ``python -m aec_tpu_torch.cli.infer``;
- ``aec_tpu_torch.utils``    — weights carried over from and back to the JAX
  checkpoints, logging helpers.

The package imports ``torch`` and never ``jax``. The device of every
computation is the device of its input tensors; the entry points that
create nets or state put them on the card unless asked for ``device="cpu"``.
"""

__version__ = "0.1.0"


def __getattr__(name):
    """Lazy top-level conveniences (keep package import cheap)."""
    lazy = {
        "two_stage_cancel": ("aec_tpu_torch.pipeline.two_stage", "two_stage_cancel"),
        "kalman_cancel": ("aec_tpu_torch.linear.kalman", "kalman_cancel"),
        "nlms_cancel": ("aec_tpu_torch.linear.nlms", "nlms_cancel"),
        "KalmanConfig": ("aec_tpu_torch.configs", "KalmanConfig"),
        "NlmsConfig": ("aec_tpu_torch.configs", "NlmsConfig"),
        "little_net_apply": ("aec_tpu_torch.models.little_net", "little_net_apply"),
        "erb_filterbank": ("aec_tpu_torch.dsp.erb", "erb_filterbank"),
        "load_npz": ("aec_tpu_torch.utils.weights", "load_npz"),
        "little_net_init": ("aec_tpu_torch.models.little_net", "little_net_init"),
        "TrainConfig": ("aec_tpu_torch.configs", "TrainConfig"),
        **{n: ("aec_tpu_torch.pipeline.streaming", n) for n in (
            "stream_init", "stream_step", "stream_flush", "stream_init_batched",
            "stream_step_batched", "stream_run")},
        **{n: ("aec_tpu_torch.kernels.serving", n) for n in (
            "serving_init", "serving_step_fused", "serving_step_plain",
            "serving_state_from_stream", "serving_state_to_stream",
            "serving_reset_streams", "serving_erle")},
    }
    if name in lazy:
        import importlib

        mod, attr = lazy[name]
        return getattr(importlib.import_module(mod), attr)
    raise AttributeError(f"module 'aec_tpu_torch' has no attribute {name!r}")

"""aec_tpu_torch — the PyTorch/CUDA port of ``aec_tpu`` for NVIDIA Hopper.

A second package beside ``aec_tpu`` (the JAX reference, which stays as it
is). The layout mirrors ``aec_tpu`` so every module has a named counterpart:

- ``aec_tpu_torch.dsp``      — windows, ERB and mel filterbanks, STFT/iSTFT
  as DFT-basis matmuls, GCC-PHAT bulk-delay alignment (``aec_tpu/dsp``);
- ``aec_tpu_torch.linear``   — overlap-save machinery and the partitioned-
  block frequency-domain Kalman and NLMS cancellers (``aec_tpu/linear``);
- ``aec_tpu_torch.ops``      — the GRU and LSTM recurrences, DCCRN's complex
  conv/norm layers (``aec_tpu/ops``);
- ``aec_tpu_torch.models``   — LittleNet, TwoLayerGRU, DCCRN, FullSubNet and
  ATT-CCRN as ``nn.Module`` s, and the registry of the ported families;
- ``aec_tpu_torch.pipeline`` — the two-stage composition, the streaming
  (frame-in / frame-out) runtime, the ``.ex`` files, wav I/O;
- ``aec_tpu_torch.kernels``  — hand-written CUDA C++ kernels for sm_90a, each
  beside its plain PyTorch version. A CUDA tensor goes through the kernel
  (or the call raises); a CPU tensor takes the plain version.
- ``aec_tpu_torch.train``    — the reference-cadence ``Trainer`` (LittleNet,
  TwoLayerGRU) and the ``GenericTrainer`` for every family, with the model
  adapters, the optimizer with optax's numbers, loss metrics (SI-SNR,
  STOI, PESQ) and checkpoints in the JAX package's format;
- ``aec_tpu_torch.parallel`` — the (data, model) mesh of ranks on
  ``torch.distributed`` (NCCL on cards, gloo on the CPU), data-parallel
  steps with JAX's global-batch numbers, the pipelined sequence scan, the
  tensor-parallel LSTM and a multi-rank dry run;
- ``aec_tpu_torch.cli``      — every CLI of the JAX package:
  ``python -m aec_tpu_torch.cli.{prepare_data,train,infer,batch_enhance,
  stream,measure,export_pt,profile}``;
- ``aec_tpu_torch.utils``    — weights carried over from and back to the JAX
  checkpoints and ``.pt`` files, logging and profiling helpers.

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
        "get_model": ("aec_tpu_torch.models.registry", "get_model"),
        "list_models": ("aec_tpu_torch.models.registry", "list_models"),
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

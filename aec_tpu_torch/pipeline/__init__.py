"""Pipelines: the two-stage composition, the streaming runtime, data I/O
and loading (``aec_tpu/pipeline``)."""

from aec_tpu_torch.pipeline import (  # h5io imports h5py only inside its functions
    audio_io,
    datasets,
    features,
    h5io,
    streaming,
    two_stage,
)

__all__ = ["audio_io", "h5io", "features", "datasets", "two_stage", "streaming"]

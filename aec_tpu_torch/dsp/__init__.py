"""DSP front end: windows, ERB filterbank, STFT/iSTFT (``aec_tpu/dsp``)."""

from aec_tpu_torch.dsp import erb, stft, windows  # submodules
from aec_tpu_torch.dsp.erb import erb_filterbank, erb_to_freq, freq_to_erb
from aec_tpu_torch.dsp.stft import (
    StftConfig,
    analysis_matrix,
    frame_signal,
    magnitude,
    num_frames,
    ola_envelope,
    overlap_add,
    split_complex,
    synthesis_matrix,
)
from aec_tpu_torch.dsp.windows import periodic_window

__all__ = [
    "stft",
    "erb",
    "windows",
    "StftConfig",
    "analysis_matrix",
    "synthesis_matrix",
    "frame_signal",
    "overlap_add",
    "ola_envelope",
    "split_complex",
    "magnitude",
    "num_frames",
    "erb_filterbank",
    "freq_to_erb",
    "erb_to_freq",
    "periodic_window",
]

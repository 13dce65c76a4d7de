"""DSP front end: windows, ERB filterbank, STFT/iSTFT (``aec_tpu/dsp``)."""

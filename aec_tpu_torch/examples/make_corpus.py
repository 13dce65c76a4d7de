"""Synthesize an AEC-Challenge-style wav corpus (recorded-speech stand-in),
the port's ``examples/make_corpus.py``: the same flags, files and prints.

Quadruples named ``{nearend_speech,nearend_mic,farend_speech,echo}_fileid_N.wav``
(the reference's ``generate_h5files/train_wav2h5.py:10-52`` contract) with
the scene statistics of the quality battery: speech-like far ends, random
decaying RIRs with up to 40 ms of bulk delay, loudspeaker saturation on a
fraction of scenes, and intermittent speech-like or speech-shaped-noise near
ends at random SNR. numpy only (no device, hence no ``--device``): one seed
gives the JAX script's files byte for byte.

  python -m aec_tpu_torch.examples.make_corpus --out corpus --count 512 --val 32

Then pack, train and enhance with the port's CLIs:

  python -m aec_tpu_torch.cli.prepare_data train --wav_path corpus/train \
      --h5_path corpus/h5tr --list_path corpus/lists
  python -m aec_tpu_torch.cli.prepare_data test --wav_path corpus/val \
      --h5_path corpus/h5cv --list_path corpus/lists
  python -m aec_tpu_torch.cli.train --tr_list corpus/lists/tr_list.txt \
      --cv_file corpus/h5cv/test.ex --ckpt_dir corpus/exp
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from aec_tpu_torch.examples.scenes import loudspeaker, speech_like
from aec_tpu_torch.pipeline.audio_io import write_wav

SR = 16000


def synth_quadruple(rng: np.random.Generator, n: int):
    """One (near, mic, far, echo) scene with the battery's statistics."""
    far = speech_like(rng, n, f0=rng.uniform(90.0, 230.0))
    # random decaying RIR with up to 40 ms bulk delay
    delay = rng.integers(0, int(0.040 * SR))
    length = int(rng.uniform(400, 1600))
    h = np.exp(-np.arange(length) / rng.uniform(100.0, 500.0))
    h = h * rng.standard_normal(length)
    h = rng.uniform(0.3, 1.0) * h / (np.abs(h).max() + 1e-9)
    src = loudspeaker(far) if rng.uniform() < 0.3 else far
    echo = np.convolve(src, h.astype(np.float32))[: n - delay]
    echo = np.concatenate([np.zeros(delay, np.float32), echo.astype(np.float32)])

    if rng.uniform() < 0.7:  # active near end
        if rng.uniform() < 0.5:
            near = speech_like(rng, n, f0=rng.uniform(140.0, 260.0))
        else:  # speech-shaped noise with random spectral emphasis
            white = rng.standard_normal(n)
            spec = np.fft.rfft(white)
            f = np.fft.rfftfreq(n, 1.0 / SR)
            center = rng.uniform(300.0, 3000.0)
            emph = np.exp(-((np.log(f + 30.0) - np.log(center)) ** 2))
            near = np.fft.irfft(spec * emph / np.maximum(f / 500.0, 1.0), n=n)
            near = (near / (np.abs(near).max() + 1e-9)).astype(np.float32)
        near = (rng.uniform(0.2, 0.8) * near).astype(np.float32)
    else:
        near = np.zeros(n, np.float32)
    # a sensor / room noise floor (~-60 dBFS): an all-zero near end NaNs the
    # reference loss's pseudo-norm (it divides by the near end's std)
    near = (near + 1e-3 * rng.standard_normal(n)).astype(np.float32)

    mic = echo + near
    scale = np.float32(1.0 / (np.abs(mic).max() + 1e-9))
    return near * scale, mic * scale, far, echo * scale


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True)
    p.add_argument("--count", type=int, default=512)
    p.add_argument("--val", type=int, default=32)
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    n = int(args.seconds * SR) // 256 * 256
    rng = np.random.default_rng(args.seed)
    for split, count in (("train", args.count), ("val", args.val)):
        d = os.path.join(args.out, split)
        os.makedirs(d, exist_ok=True)
        for i in range(count):
            near, mic, far, echo = synth_quadruple(rng, n)
            fid = f"{i:05d}"
            write_wav(os.path.join(d, f"nearend_speech_fileid_{fid}.wav"), near, SR)
            write_wav(os.path.join(d, f"nearend_mic_fileid_{fid}.wav"), mic, SR)
            write_wav(os.path.join(d, f"farend_speech_fileid_{fid}.wav"), far, SR)
            write_wav(os.path.join(d, f"echo_fileid_{fid}.wav"), echo, SR)
        print(f"{split}: {count} quadruples ({4 * count} wavs) in {d}")


if __name__ == "__main__":
    main()

"""Host and transfers: the median host ms of one call into the program, read
from the root span the program records around it
(``aec_tpu_torch.utils.profiling``): ``two_stage`` a batch (bulk),
``train.step`` a step (train), ``serving.step`` a tick (serve), ``enhance``
an utterance (infer). The spans are on while the window is traced and are
stamped by the host clock, so this is the host's time in the call, the card's
work left out where the call does not wait for it. None where the program
records no such span (a program without spans)."""

ROOT = {"bulk": "two_stage", "train": "train.step", "serve": "serving.step", "infer": "enhance"}


def collected():
    """The program's ``profiling.collected()``, or None where it has none."""
    try:
        from aec_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "collected", None)
    return read() if callable(read) else None


def median_ms(name: str):
    """The median ms of the program's spans named ``name``, or None."""
    c = collected()
    s = c["summary"].get(name) if c else None
    return s["median_ms"] if s else None


def read(r):
    name = ROOT.get(r["mix"]["driver"])
    return median_ms(name) if name else None

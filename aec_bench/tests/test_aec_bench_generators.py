"""The scene generator is deterministic by seed, for seeds beyond 32 bits."""

from __future__ import annotations

import json

import pytest
import torch

from aec_bench import scenes
from aec_bench.tests.helpers import REPO

MIX = json.loads((REPO / "aec_bench" / "traffic" / "bulk.json").read_text())["scene"]


def batch(seed, circular=False):
    return scenes.make(scenes.generator(seed, "cpu"), 5, 4096, MIX, "cpu", circular=circular)


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5, 2**40 + 3])
def test_same_seed_same_scenes(seed):
    a, b = batch(seed), batch(seed)
    for k in ("far", "mic", "near", "echo"):
        assert torch.equal(a[k], b[k]) and torch.isfinite(a[k]).all()


def test_other_seed_other_scenes():
    a, b = batch(11), batch(12)
    assert not torch.equal(a["mic"], b["mic"])


def test_scene_parts():
    s = batch(3)
    assert torch.allclose(s["mic"], s["echo"] + s["near"], atol=0.01)
    assert s["far"].abs().amax(-1).sub(1).abs().max() < 1e-5  # peak-normalised
    talk = s["near"].abs().amax(-1) > 0
    assert 0 < int(talk.sum()) < 5 or MIX["doubletalk"] in (0, 1)


def test_circular_echo_has_no_seam():
    """A wrapped echo is the far end's circular convolution: a loop of the
    ring equals the linear convolution of the looped far end."""
    g = scenes.generator(4, "cpu")
    far = torch.randn(2, 1024, generator=g)
    h = torch.randn(2, 300, generator=g)
    circ = scenes.convolve(far, h, circular=True)
    lin = scenes.convolve(torch.cat([far, far], -1), h, circular=False)[:, 1024:]
    assert torch.allclose(circ, lin, atol=1e-4)

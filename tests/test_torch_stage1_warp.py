"""K1 and K6 share ``csrc/stage1_warp.cuh``'s step: K1's wrapper counts it
as ``"warp"``, the profiler's counters export that key, and both sources
size the one layout alike (where ``nvcc`` can build them; the libraries'
layout queries need no card).

The file imports neither JAX nor the JAX package, so on a machine with the
card and without JAX it runs as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_stage1_warp.py
"""

import pytest

from aec_tpu_torch.kernels import _build
from aec_tpu_torch.kernels.kalman import (
    bind_batched,
    bind_single,
    kalman_cancel_fused_batched,
    kalman_filter_fused_batched,
)
from aec_tpu_torch.utils import profiling


def test_k1_steps_count_the_warp_step():
    """K1 counts its warp-owned step apart from the CTA-wide FFT step and
    the dense one; K12 keeps the CTA-wide step and has no such key."""
    assert set(kalman_cancel_fused_batched.steps) == {"warp", "fft", "dense"}
    assert set(kalman_filter_fused_batched.steps) == {"fft", "dense"}


def test_counters_export_the_warp_step():
    flat = profiling.counters()
    key = "kalman.kalman_cancel_fused_batched.steps.warp"
    assert flat[key] == kalman_cancel_fused_batched.steps["warp"]
    assert "kalman.kalman_cancel_fused_batched.steps.fft" in flat


@pytest.fixture(scope="module")
def libs():
    try:
        _build._nvcc()
    except RuntimeError:
        pytest.skip("needs nvcc to build the CUDA sources")
    return bind_batched(_build.load("kalman_batched")), bind_single(_build.load("single_stream"))


@pytest.mark.parametrize("n_blocks", [10, 24])
@pytest.mark.parametrize("block", [256, 160])
def test_k1_and_k6_size_one_layout(libs, block, n_blocks):
    """K1's shared memory is K6's Kalman layout, and it holds two CTAs of
    an SM's 228 KB at the default geometry."""
    k1, k6 = libs
    got = k1.aec_kalman_warp_smem(block, n_blocks)
    assert got == k6.aec_single_fft_smem(block, n_blocks, 0)
    assert got <= 227 * 1024
    if (block, n_blocks) == (256, 10):
        assert 2 * (got + 1024) <= 228 * 1024

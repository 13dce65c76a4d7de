"""The FFT plan of K1 / K12's step (aec_tpu_torch.kernels.fft_plan): its
plain-torch model of the kernel's radix schedule against the dense DFT bases
the dense step reads (kernels.consts.stage1_consts) and against torch.fft,
at 2B = 512 (the default hop) and 320 (the 320 / 160 / 320 STFT)."""

import numpy as np
import pytest
import torch

from aec_tpu_torch.kernels import fft_plan
from aec_tpu_torch.kernels.consts import stage1_consts

CPU = torch.device("cpu")
TOL = 1e-5  # of each output's scale: fp32 round-off of a few hundred terms


def _close(got, want):
    scale = float(want.abs().max())
    err = float((got.double() - want.double()).abs().max())
    assert err <= TOL * scale, f"max|d| {err:.3e} > {TOL:g} x {scale:.3e}"


def _ri(z: torch.Tensor) -> torch.Tensor:
    return torch.cat([z.real, z.imag], dim=-1)


@pytest.mark.parametrize("block,plan", [(256, (8, 8, 4)), (160, (8, 4, 5)), (12, (4, 3)),
                                        (45, (5, 3, 3)), (2, (2,)), (224, None), (7, None),
                                        (1, None)])
def test_radix_plan(block, plan):
    """Radices 8 first, then 4, 2, 5, 3, multiplying to the block; None
    (the dense step) for a block with another prime factor, or below 2."""
    assert fft_plan.radix_plan(block) == plan


@pytest.mark.parametrize("block,step", [(256, "fft"), (160, "fft"), (96, "fft"), (45, "fft"),
                                        (224, "dense"), (112, "dense"), (1, "dense")])
def test_stage1_step_by_geometry(block, step):
    """The step every stage-1 kernel (K1 / K12, K5, K6 / K7) takes at a
    block: the FFT step where the block has a radix plan, else the dense one
    (K6 / K7: the one-CTA route and the cluster route)."""
    from aec_tpu_torch.kernels.kalman import step_for

    assert step_for(block) == step


def test_twiddle_table_is_rounded_float64():
    t = fft_plan.twiddles(256, CPU)
    m = np.arange(256)
    want = np.exp(-2j * np.pi * m / 512)
    assert t.dtype == torch.float32 and tuple(t.shape) == (256, 2)
    assert np.array_equal(t[:, 0].numpy(), want.real.astype(np.float32))
    assert np.array_equal(t[:, 1].numpy(), want.imag.astype(np.float32))


@pytest.mark.parametrize("block", [256, 160])
@pytest.mark.parametrize("frame", ["full", "zero_head", "zero_tail"])
def test_forward_matches_dense_basis_and_torch(rng, block, frame):
    """rfft of L = 3 batched frames of each kind the step transforms: the
    far frame [prev || cur], the residual [0 || e], the constraint tail
    [t || 0]."""
    x = rng.standard_normal((2, 3, 2 * block)).astype(np.float32)
    if frame == "zero_head":
        x[..., :block] = 0.0
    elif frame == "zero_tail":
        x[..., block:] = 0.0
    xt = torch.from_numpy(x)
    got = fft_plan.rfft(xt, block)
    assert tuple(got.shape) == (2, 3, 2 * (block + 1))
    _close(got, xt @ stage1_consts(block, CPU)["fwd"])
    _close(got, _ri(torch.fft.rfft(xt.double())))


@pytest.mark.parametrize("block", [256, 160])
@pytest.mark.parametrize("half", ["head", "tail"])
def test_inverse_halves_match_dense_bases_and_torch(rng, block, half):
    """The inverse's head (the constraint) and tail (the echo synthesis) of
    L = 4 batched spectra whose bins 0 and K - 1 carry imaginary parts: the
    model drops them, as the dense inverse bases (irfft of unit vectors) and
    torch.fft.irfft do."""
    k = block + 1
    spec = rng.standard_normal((4, 2 * k)).astype(np.float32)
    assert (spec[:, k] != 0).all() and (spec[:, 2 * k - 1] != 0).all()
    st = torch.from_numpy(spec)
    got = fft_plan.irfft(st, block, half)
    c = stage1_consts(block, CPU)
    if half == "tail":
        dense = st @ c["inv_tail"]
    else:
        dense = st @ c["inv_head"]
    _close(got, dense)
    full = torch.fft.irfft(torch.complex(st[:, :k].double(), st[:, k:].double()), n=2 * block)
    _close(got, full[:, block:] if half == "tail" else full[:, :block])
    # the imaginary parts of bins 0 and K - 1 change nothing
    dropped = st.clone()
    dropped[:, k] = 0.0
    dropped[:, 2 * k - 1] = 0.0
    assert torch.equal(fft_plan.irfft(dropped, block, half), got)


@pytest.mark.parametrize("block", [256, 160])
def test_constraint_round_trip_matches_dense_constraint(rng, block):
    """The step's constraint on L = 5 partitions, rfft([irfft(G)[:B] || 0]),
    through the model against the dense constraint matrix of
    linear/overlap_save (inv_head @ fwd[:B])."""
    from aec_tpu_torch.linear.overlap_save import _dft_mats

    g = torch.from_numpy(rng.standard_normal((5, 2 * (block + 1))).astype(np.float32))
    head = fft_plan.irfft(g, block, "head")
    got = fft_plan.rfft(torch.cat([head, torch.zeros_like(head)], dim=-1), block)
    _close(got, g @ torch.from_numpy(_dft_mats(block)[2]))


@pytest.mark.parametrize("block", [12, 45, 96, 2])
def test_other_radices(rng, block):
    """Radix-3, -5 and -2 passes (blocks 12, 45, 96, 2) forward and back."""
    x = torch.from_numpy(rng.standard_normal((3, 2 * block)).astype(np.float32))
    _close(fft_plan.rfft(x, block), _ri(torch.fft.rfft(x.double())))
    spec = _ri(torch.fft.rfft(x.double())).float()
    _close(fft_plan.irfft(spec, block, "head"), x[:, :block])
    _close(fft_plan.irfft(spec, block, "tail"), x[:, block:])


# ---------------------------------------------------------------- K2's transforms


@pytest.mark.parametrize("block,plan", [(256, (8, 8, 4)), (160, (8, 4, 5))])
def test_stage2_analysis_matches_windowed_basis(rng, block, plan):
    """K2's analysis: the model's rfft of the window times a frame equals
    stage2_consts' windowed analysis basis, for 2 x 3 frames."""
    from aec_tpu_torch.dsp.stft import StftConfig
    from aec_tpu_torch.kernels.consts import stage2_consts

    assert fft_plan.radix_plan(block) == plan
    c = stage2_consts(StftConfig(2 * block, block, 2 * block), CPU)
    x = torch.from_numpy(rng.standard_normal((2, 3, 2 * block)).astype(np.float32))
    _close(fft_plan.rfft(x * c["window"], block), x @ c["analysis"])


@pytest.mark.parametrize("block,plan", [(256, (8, 8, 4)), (160, (8, 4, 5))])
def test_stage2_synthesis_matches_pinv_basis(rng, block, plan):
    """K2's synthesis: the window times the model's inverse (head and tail)
    equals stage2_consts' pinv synthesis basis on 4 spectra whose bins 0
    and K - 1 carry imaginary parts, which both ignore."""
    from aec_tpu_torch.dsp.stft import StftConfig
    from aec_tpu_torch.kernels.consts import stage2_consts

    assert fft_plan.radix_plan(block) == plan
    c = stage2_consts(StftConfig(2 * block, block, 2 * block), CPU)
    k = block + 1
    spec = rng.standard_normal((4, 2 * k)).astype(np.float32)
    assert (spec[:, k] != 0).all() and (spec[:, 2 * k - 1] != 0).all()
    st = torch.from_numpy(spec)
    got = c["window"] * torch.cat([fft_plan.irfft(st, block, "head"),
                                   fft_plan.irfft(st, block, "tail")], dim=-1)
    _close(got, st @ c["synthesis"])

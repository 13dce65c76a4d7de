"""The JAX package's public names in the port, each with JAX's value or
behaviour: the configs and their defaults, ``dsp.stft.num_frames``,
``models.little_net.little_net_width``, ``linear.overlap_save``'s
``ri_from_complex`` and ``block_count``, the subpackages' re-exports and
the top-level ``get_model`` / ``list_models``."""

import dataclasses
import importlib

import jax
import numpy as np
import pytest
import torch

import aec_tpu
import aec_tpu_torch
from aec_tpu import configs as jconfigs
from aec_tpu.dsp import stft as jstft
from aec_tpu.linear import overlap_save as jols
from aec_tpu.models.little_net import little_net_init as jax_init
from aec_tpu.models.little_net import little_net_width as jax_width
from aec_tpu_torch import configs
from aec_tpu_torch.dsp import stft
from aec_tpu_torch.linear import overlap_save as ols
from aec_tpu_torch.models.little_net import little_net_width
from aec_tpu_torch.utils.weights import params_from_jax

CONFIGS = ("SpeechConfig", "ErbConfig", "LittleNetConfig", "PipelineConfig", "TrainConfig",
           "NlmsConfig", "KalmanConfig")


@pytest.mark.parametrize("name", CONFIGS)
def test_configs_have_jax_fields_and_defaults(name):
    mine, theirs = getattr(configs, name), getattr(jconfigs, name)
    assert [f.name for f in dataclasses.fields(mine)] == [f.name for f in dataclasses.fields(theirs)]
    assert dataclasses.asdict(mine()) == dataclasses.asdict(theirs())
    assert mine.__dataclass_params__.frozen


def test_default_configs_and_derived_values():
    for name in ("SPEECH", "ERB", "TRAIN", "NLMS", "KALMAN"):
        mine, theirs = getattr(configs, f"DEFAULT_{name}"), getattr(jconfigs, f"DEFAULT_{name}")
        assert type(mine).__name__ == type(theirs).__name__
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    assert configs.SpeechConfig(win_size=320).n_freqs == jconfigs.SpeechConfig(win_size=320).n_freqs


def test_num_frames_is_jax_and_the_stft_count():
    for cfg in (stft.StftConfig(), stft.StftConfig(win_len=320, hop=160)):
        jcfg = jstft.StftConfig(win_len=cfg.win_len, hop=cfg.hop)
        for n in (4096, 4100, 16000, 12345):
            assert stft.num_frames(n, cfg) == jstft.num_frames(n, jcfg)
            assert stft.stft(torch.zeros(1, n), cfg).shape[1] == stft.num_frames(n, cfg)


@pytest.mark.parametrize("width", [1, 2])
def test_little_net_width_is_jax(width):
    params = jax_init(jax.random.PRNGKey(0), width=width)
    net = params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    assert little_net_width(net) == jax_width(params) == width


def test_overlap_save_names_are_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5)) + 1j * rng.standard_normal((3, 5))
    got, want = ols.ri_from_complex(x), np.asarray(jols.ri_from_complex(x))
    assert got.dtype == torch.float32 and str(want.dtype) == "float32"
    np.testing.assert_array_equal(got.numpy(), want)
    for n, block in ((4096, 256), (4097, 256), (1, 160), (0, 256), (320, 160)):
        assert ols.block_count(n, block) == jols.block_count(n, block)


@pytest.mark.parametrize("sub", ["dsp", "linear", "models", "ops", "pipeline", "train", "utils",
                                 "parallel"])
def test_subpackages_export_what_jax_exports(sub):
    """Each subpackage's __all__ is JAX's, and every name resolves: a module
    to the port's module of that name, anything else to an object."""
    mine = importlib.import_module(f"aec_tpu_torch.{sub}")
    theirs = importlib.import_module(f"aec_tpu.{sub}")
    assert sorted(mine.__all__) == sorted(theirs.__all__)
    for name in mine.__all__:
        obj = getattr(mine, name)
        if type(getattr(theirs, name)).__name__ == "module":
            assert obj.__name__ == f"aec_tpu_torch.{sub}.{name}"


def test_top_level_registry():
    assert aec_tpu_torch.list_models() == aec_tpu.list_models()
    spec = aec_tpu_torch.get_model("little_net")
    assert spec.name == aec_tpu.get_model("little_net").name and not spec.stateful
    with pytest.raises(KeyError):
        aec_tpu_torch.get_model("no_such_model")

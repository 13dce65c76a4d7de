"""Zoo training's trainers: Trainer with TwoLayerGRU, GenericTrainer one
epoch per family restoring in JAX, a JAX GenericTrainer checkpoint resumed
in the port (split out of tests/test_torch_zoo_train.py; the helpers are
tests/torch_zoo_common.py)."""

import functools
import importlib
import json

import jax
import numpy as np
import pytest

from aec_tpu.configs import TrainConfig as JaxTrainConfig
from aec_tpu.models import two_layer_gru as jtlg
from aec_tpu.train import checkpoints as jck
from aec_tpu.train import loop as jloop
from aec_tpu.train.generic import GenericTrainer as JaxGenericTrainer
from aec_tpu.train.generic import make_adapter as jax_make_adapter
from aec_tpu_torch.configs import TrainConfig
from aec_tpu_torch.models import two_layer_gru as ttlg
from aec_tpu_torch.train import loop as tloop
from aec_tpu_torch.train.generic import GenericTrainer
from aec_tpu_torch.utils import weights
from torch_zoo_common import (
    LOSS_RTOL,
    NARROW,
    _assert_params_close,
    _assert_tree_close,
    _make_dataset,
)


def test_trainer_takes_two_layer_gru(tmp_path, rng):
    """Trainer with the registry's two_layer_gru loss and init, as JAX's CLI
    builds it; its checkpoint restores under JAX's template."""
    from aec_tpu_torch.models.registry import get_model

    paths, cv = _make_dataset(tmp_path, rng)
    spec = get_model("two_layer_gru")
    out = tloop.Trainer(paths, cv, str(tmp_path / "exp"), cfg=TrainConfig(max_n_epochs=1,
                        batch_size=2, lr=1e-4), loss_fn=spec.loss, init_fn=spec.init,
                        device="cpu").train()
    assert isinstance(out["net"], ttlg.TwoLayerGru) and out["optimizer"].count == 1
    jparams = jtlg.two_layer_gru_init(jax.random.PRNGKey(0))
    jopt = jloop.make_optimizer(JaxTrainConfig(), 1)
    got = jck.restore(str(tmp_path / "exp/models/latest.npz"),
                      {"params": jparams, "opt_state": jopt.init(jparams)})
    _assert_tree_close(got["params"], weights.two_layer_gru_to_jax(out["net"]), 0.0, "params")


@pytest.mark.parametrize("model", ["fullsubnet", "att_ccrn", "little_net", "dccrn"])
def test_generic_trainer_one_epoch_restores_in_jax(tmp_path, rng, monkeypatch, model):
    """GenericTrainer for one epoch per family (as tests/test_generic_trainer.py
    runs JAX's; DCCRN and ATT-CCRN narrowed, NARROW); its latest.npz
    restores under JAX's {"params", "opt_state", "model_state"} template of
    the same config in JAX's checkpoints.restore, leaf for leaf."""
    if model in NARROW:
        module, name, kw, _ = NARROW[model]
        mod = importlib.import_module(module)
        monkeypatch.setattr(mod, name, functools.partial(getattr(mod, name), **kw))
    paths, cv = _make_dataset(tmp_path, rng)
    metrics = ("sisdr",) if model == "dccrn" else ()
    exp = tmp_path / f"exp_{model}"
    out = GenericTrainer(model=model, tr_list=paths, cv_file=cv, ckpt_dir=str(exp),
                         cfg=TrainConfig(max_n_epochs=1, batch_size=2, lr=1e-4),
                         validate_metrics=metrics, device="cpu").train()
    info = out["ckpt_info"]
    assert info["cur_epoch"] == 1 and info["model"] == model and np.isfinite(info["cv_loss"])
    row = json.loads((exp / "metrics.jsonl").read_text().splitlines()[-1])
    assert row["model"] == model and set(row) == {"epoch", "iter", "model", "tr_loss",
                                                  "cv_loss", "batch_time_s", "train_xrt"}
    if metrics:
        assert np.isfinite(info["cv_sisdr"]) and (exp / "models/best_sisdr.npz").is_file()
    if model in NARROW:
        params, state = NARROW[model][3](NARROW[model][2])
    else:
        params, state = jax_make_adapter(model).init(jax.random.PRNGKey(0))
    jopt = jloop.make_optimizer(JaxTrainConfig(), 1)
    got = jck.restore(str(exp / "models/latest.npz"),
                      {"params": params, "opt_state": jopt.init(params), "model_state": state})
    want_p, want_s = weights.to_jax(out["net"])
    _assert_tree_close(got["params"], want_p, 0.0, "params")
    _assert_tree_close(got["model_state"], want_s, 0.0, "model_state")
    assert int(got["opt_state"][-1][0].count) == 1


def test_jax_generic_checkpoint_resumes_in_port(tmp_path, rng):
    """JAX's GenericTrainer trains FullSubNet one epoch (one step) and
    writes latest.npz; JAX and the port each resume from it for one more
    step: the same tr_loss (LOSS_RTOL) and cv loss, the parameters as
    _assert_params_close says."""
    paths, cv = _make_dataset(tmp_path, rng)
    cfg = dict(max_n_epochs=1, batch_size=2, lr=1e-3)
    JaxGenericTrainer(model="fullsubnet", tr_list=paths, cv_file=cv,
                      ckpt_dir=str(tmp_path / "j0"), cfg=JaxTrainConfig(**cfg)).train()
    latest = str(tmp_path / "j0/models/latest.npz")
    want = JaxGenericTrainer(model="fullsubnet", tr_list=paths, cv_file=cv,
                             ckpt_dir=str(tmp_path / "j1"), cfg=JaxTrainConfig(**cfg),
                             resume_model=latest).train()
    got = GenericTrainer(model="fullsubnet", tr_list=paths, cv_file=cv,
                         ckpt_dir=str(tmp_path / "t1"), cfg=TrainConfig(**cfg),
                         resume_model=latest, device="cpu").train()
    assert got["optimizer"].count == 2
    for k in ("tr_loss", "cv_loss"):
        np.testing.assert_allclose(got["ckpt_info"][k], want["ckpt_info"][k], rtol=LOSS_RTOL,
                                   err_msg=k)
    _assert_params_close(weights.to_jax(got["net"])[0], want["params"], cfg["lr"])


def test_generic_trainer_refuses_what_the_port_leaves_out(tmp_path):
    """Unknown validate_metrics are refused; a mesh is taken (several
    ranks: tests/test_torch_parallel_cli.py)."""
    assert GenericTrainer("dccrn", [], "", str(tmp_path), use_mesh=True, device="cpu").use_mesh
    with pytest.raises(ValueError, match="unknown validate_metrics"):
        GenericTrainer("dccrn", [], "", str(tmp_path), validate_metrics=("pesq",), device="cpu")

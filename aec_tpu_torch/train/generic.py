"""Generic trainer (``aec_tpu/train/generic.py``): one epoch loop for every
model family, and the adapters it and ``cli/infer`` use.

Stateless families take ``{}`` as state: LittleNet and TwoLayerGRU an
``nn.Module`` as their params, FullSubNet its param tree of tensors. DCCRN
and ATT-CCRN take their (params, state) trees, BatchNorm running statistics
in the state. :class:`GenericTrainer` holds each family as a module
(``ModelAdapter.module``) and trains it through
``train.loop.make_stateful_train_step``, the statistics in the module's
buffers; ``use_mesh`` shards the batch over the ranks as ``Trainer`` does.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Callable

import torch
from torch import nn

from aec_tpu_torch.configs import TrainConfig
from aec_tpu_torch.dsp.erb import erb_filterbank
from aec_tpu_torch.dsp.stft import StftConfig
from aec_tpu_torch.models.tree_net import copy_into, functional_params, model_state
from aec_tpu_torch.parallel.mesh import globalize_batch, is_primary, make_mesh
from aec_tpu_torch.pipeline.datasets import EvalLoader, TrainLoader
from aec_tpu_torch.train import checkpoints
from aec_tpu_torch.train.loop import (
    add_wave_metrics,
    make_optimizer,
    make_stateful_train_step,
    restore_train_tree,
    shard_corpus,
    train_tree,
)
from aec_tpu_torch.utils.tools import count_frames, get_logger, num_params


@dataclasses.dataclass
class ModelAdapter:
    """Normalizes a model family to: ``init(generator, device) -> (params,
    state | {})``, ``loss(params, state, mic, far, near, echo, train) ->
    (loss, new_state)``, ``enhance(params, state, mic, far) -> wav`` (eval
    mode) and ``module(params, state) -> nn.Module`` holding them. DCCRN's
    loss also takes ``lstm_fused`` and FullSubNet's ``joint_kernel``
    (keyword-only, default None: the ops' routing)."""

    init: Callable[..., tuple[Any, Any]]
    loss: Callable[..., tuple[torch.Tensor, Any]]
    stateful: bool
    enhance: Callable[..., torch.Tensor] | None = None
    module: Callable[[Any, Any], nn.Module] | None = None


def make_adapter(name: str, scfg: StftConfig = StftConfig()) -> ModelAdapter:
    if name in ("little_net", "two_layer_gru"):
        from aec_tpu_torch.models.registry import get_model

        spec = get_model(name)
        erb_np = erb_filterbank(scfg.n_freqs, 16000, 32)

        def erb_on(x: torch.Tensor) -> torch.Tensor:
            return torch.as_tensor(erb_np, dtype=torch.float32, device=x.device)

        def init(generator=None, device="cuda"):
            return spec.init(generator=generator, device=device), {}

        def loss(params, state, mic, far, near, echo, train):
            value, _ = spec.loss(params, mic, far, near, erb_on(mic), scfg, sqrt_eps=1e-12)
            return value, state

        def enhance(params, state, mic, far):
            return spec.apply(params, mic, far, erb_on(mic), scfg)["wav"]

        return ModelAdapter(init, loss, stateful=False, enhance=enhance,
                            module=lambda params, state: params)

    if name == "dccrn":
        from aec_tpu_torch.models.dccrn import (
            Dccrn,
            DccrnConfig,
            dccrn_apply,
            dccrn_init,
            dccrn_loss_v1,
        )

        cfg = DccrnConfig()

        def init(generator=None, device="cuda"):
            return dccrn_init(cfg, generator=generator, device=device)

        def loss(params, state, mic, far, near, echo, train, *, lstm_fused=None):
            value, aux = dccrn_loss_v1(params, state, mic, far, near, echo, cfg, train=train,
                                       lstm_fused=lstm_fused)
            return value, aux["state"]

        def enhance(params, state, mic, far):
            return dccrn_apply(params, state, mic, far, cfg, train=False)[0]["wav"]

        return ModelAdapter(init, loss, stateful=True, enhance=enhance,
                            module=lambda params, state: Dccrn(params, state, cfg))

    if name == "fullsubnet":
        from aec_tpu_torch.models.fullsubnet import (
            FullSubNet,
            FullSubNetConfig,
            fullsubnet_apply,
            fullsubnet_init,
            fullsubnet_loss,
        )

        cfg = FullSubNetConfig()

        def init(generator=None, device="cuda"):
            return fullsubnet_init(cfg, generator=generator, device=device), {}

        def loss(params, state, mic, far, near, echo, train, *, joint_kernel=None):
            value, _ = fullsubnet_loss(params, mic, far, near, echo, cfg,
                                       joint_kernel=joint_kernel)
            return value, state

        def enhance(params, state, mic, far):
            return fullsubnet_apply(params, mic, far, cfg)["wav"]

        return ModelAdapter(init, loss, stateful=False, enhance=enhance,
                            module=lambda params, state: FullSubNet(params, cfg))

    if name == "att_ccrn":
        from aec_tpu_torch.models.att_ccrn import (
            AttCcrn,
            AttCcrnConfig,
            att_ccrn_apply,
            att_ccrn_init,
            att_ccrn_loss,
        )

        cfg = AttCcrnConfig()

        def init(generator=None, device="cuda"):
            return att_ccrn_init(cfg, generator=generator, device=device)

        def loss(params, state, mic, far, near, echo, train):
            value, aux = att_ccrn_loss(params, state, mic, far, near, cfg, train=train)
            return value, aux["state"]

        def enhance(params, state, mic, far):
            return att_ccrn_apply(params, state, mic, far, cfg, train=False)[0]["wav"]

        return ModelAdapter(init, loss, stateful=True, enhance=enhance,
                            module=lambda params, state: AttCcrn(params, state, cfg))

    raise KeyError(f"no training adapter for model {name!r}")


@dataclasses.dataclass
class GenericTrainer:
    """Model-agnostic epoch loop with the reference's cadence, on ``device``
    (the card unless asked for ``"cpu"``): the JAX package's logs,
    ``metrics.jsonl`` schema and checkpoint tree ``{"params", "opt_state",
    "model_state"}``; validation at batch 1."""

    model: str
    tr_list: list[str]
    cv_file: str
    ckpt_dir: str
    cfg: TrainConfig = TrainConfig()
    scfg: StftConfig = StftConfig()
    use_mesh: bool = False
    bucket_quantum: int = 4096
    resume_model: str = ""
    time_log: str = ""  # per-batch timing lines, like Trainer
    # optional cv metrics ("stoi", "sisdr") with best_<metric>.npz slots
    validate_metrics: tuple[str, ...] = ()
    device: str = "cuda"

    def __post_init__(self):
        unknown = set(self.validate_metrics) - {"stoi", "sisdr"}
        if unknown:
            raise ValueError(
                f"unknown validate_metrics {sorted(unknown)}; supported: stoi, sisdr"
            )

    def train(self) -> dict:
        os.makedirs(self.ckpt_dir, exist_ok=True)
        logger = get_logger(os.path.join(self.ckpt_dir, "train.log"), log_file=True)
        adapter = make_adapter(self.model, self.scfg)
        dev = torch.device(self.device)
        mesh = make_mesh() if self.use_mesh else None
        tr_files, local_bs, pad_to, steps_cap = shard_corpus(
            self.tr_list, self.cfg.batch_size, self.bucket_quantum, mesh)
        loader = TrainLoader(tr_files, local_bs, bucket_quantum=self.bucket_quantum,
                             pad_to=pad_to, seed=self.cfg.seed)
        cv_loader = EvalLoader(self.cv_file, batch_size=1)

        net = adapter.module(*adapter.init(
            generator=torch.Generator().manual_seed(self.cfg.seed), device=dev))
        state = model_state(net)  # the net's buffers: each step's statistics go there
        steps_per_epoch = max(len(self.tr_list) // self.cfg.batch_size, 1)
        optimizer = make_optimizer(self.cfg, steps_per_epoch, net)
        logger.info("model %s: %s params", self.model, f"{num_params(net):,d}")

        def step_loss(p, s, mic, far, near, echo):
            loss, new_state = adapter.loss(p, s, mic, far, near, echo, True)
            return loss, {"state": new_state}

        train_step = make_stateful_train_step(step_loss, optimizer, mesh)

        ckpt_info = {"cur_epoch": 0, "cur_iter": 0, "best_loss": float("inf"),
                     "model": self.model}
        for m in self.validate_metrics:
            ckpt_info[f"cv_{m}"] = None
            ckpt_info[f"best_{m}"] = float("-inf")  # higher is better
        if self.resume_model:
            restore_train_tree(self.resume_model, optimizer)
            ckpt_info.update(checkpoints.load_info(self.resume_model))

        logging_period = self.cfg.logging_period or max(
            len(self.tr_list) // self.cfg.batch_size, 1
        )
        keys = ("nearend_mic", "farend_speech", "nearend_speech", "echo")
        while ckpt_info["cur_epoch"] < self.cfg.max_n_epochs:
            accu_loss, accu_frames = 0.0, 0
            for n_iter, batch in enumerate(loader):
                if steps_cap is not None and n_iter >= steps_cap:
                    break
                t0 = time.perf_counter()
                if mesh is not None:
                    arrays = globalize_batch(mesh, [batch[k] for k in keys], dev)
                else:
                    arrays = [torch.from_numpy(batch[k]).to(dev) for k in keys]
                new_state, loss = train_step(state, *arrays)
                copy_into(state, new_state)
                loss_val = float(loss)  # waits for the device
                batch_time = time.perf_counter() - t0
                n_frames = count_frames(batch["n_samples"], self.scfg.win_len, self.scfg.hop)
                accu_loss += loss_val * n_frames
                accu_frames += n_frames
                if self.time_log and is_primary():
                    with open(self.time_log, "a") as f:
                        print(
                            f"Epoch [{ckpt_info['cur_epoch'] + 1}/"
                            f"{self.cfg.max_n_epochs}], Iter [{n_iter}], "
                            f"tr_loss = {loss_val:.4f} / "
                            f"{accu_loss / accu_frames:.4f}, "
                            f"batch_time (s) = {batch_time:.4f}",
                            file=f,
                        )
                if (n_iter + 1) % logging_period == 0:
                    metrics = self.validate(adapter, net, state, cv_loader)
                    cv_loss = metrics["loss"]
                    ckpt_info.update(
                        cur_iter=n_iter, tr_loss=accu_loss / accu_frames, cv_loss=cv_loss
                    )
                    is_best = cv_loss < ckpt_info["best_loss"]
                    if is_best:
                        ckpt_info["best_loss"] = cv_loss
                    extra_best = {}
                    for m in self.validate_metrics:
                        ckpt_info[f"cv_{m}"] = metrics[m]
                        improved = metrics[m] > ckpt_info[f"best_{m}"]
                        if improved:
                            ckpt_info[f"best_{m}"] = metrics[m]
                        extra_best[f"best_{m}"] = improved
                    if is_primary():
                        checkpoints.save_latest_best(
                            os.path.join(self.ckpt_dir, "models"), train_tree(optimizer),
                            ckpt_info, is_best, extra_best=extra_best,
                        )
                        # per-period metrics, Trainer's schema plus the family
                        audio_s = batch["nearend_mic"].size / 16000.0
                        with open(os.path.join(self.ckpt_dir, "metrics.jsonl"), "a") as f:
                            f.write(json.dumps({
                                "epoch": ckpt_info["cur_epoch"] + 1, "iter": n_iter,
                                "model": self.model, "tr_loss": ckpt_info["tr_loss"],
                                "cv_loss": cv_loss, "batch_time_s": round(batch_time, 5),
                                "train_xrt": round(audio_s / batch_time, 1),
                            }) + "\n")
                    logger.info("epoch %d iter %d tr_loss %.4f cv_loss %.4f",
                                ckpt_info["cur_epoch"] + 1, n_iter, ckpt_info["tr_loss"], cv_loss)
                    accu_loss, accu_frames = 0.0, 0
            ckpt_info["cur_epoch"] += 1
        return {"net": net, "optimizer": optimizer, "model_state": state,
                "ckpt_info": ckpt_info}

    @torch.no_grad()
    def validate(self, adapter: ModelAdapter, net: nn.Module, state, cv_loader) -> dict:
        """Frame-weighted mean cv loss at batch 1 (``adapter.loss`` with
        ``train=False``: the statistics stay as they are) plus the optional
        waveform metrics of ``adapter.enhance``."""
        params = functional_params(net)
        dev = next(net.parameters()).device
        cv_loss, cv_frames = 0.0, 0
        sums = {m: 0.0 for m in self.validate_metrics}
        counts = {m: 0 for m in self.validate_metrics}
        for egs in cv_loader:
            mic, far, near, echo = (torch.from_numpy(egs[k]).to(dev) for k in (
                "nearend_mic", "farend_speech", "nearend_speech", "echo"))
            loss, _ = adapter.loss(params, state, mic, far, near, echo, False)
            f = count_frames(egs["n_samples"], self.scfg.win_len, self.scfg.hop)
            cv_loss += float(loss) * f
            cv_frames += f
            if self.validate_metrics:
                est = adapter.enhance(params, state, mic, far).cpu().numpy()
                add_wave_metrics(sums, counts, est, egs["nearend_speech"],
                                 min(egs["n_samples"], est.shape[-1]))
        out = {"loss": cv_loss / max(cv_frames, 1)}
        for m in self.validate_metrics:
            out[m] = sums[m] / max(counts[m], 1)
        return out

"""Training loop: Adam + stepped decay, the reference's cadence
(``aec_tpu/train/loop.py``).

- one train step: the loss's backward, optional global-norm clipping and an
  Adam update whose numbers are optax's (:class:`Optimizer`), over any
  ported family's net: :func:`make_train_step` for the reference-cadence
  families (LittleNet, TwoLayerGRU), :func:`make_stateful_train_step` for
  every family through one signature, BatchNorm statistics carried beside
  the parameters (``train/generic.GenericTrainer``);
- Adam(lr=1e-5) + StepLR(period 5 epochs, gamma 0.5) as the reference's
  train_conf, through a step-count schedule evaluated before each update as
  optax evaluates it;
- frame-weighted loss accounting with the reference's ``countFrames``,
  validation once per logging period (once per epoch), checkpoints
  latest/best-on-cv-loss in the JAX package's format, the optimizer's
  moments keyed like the family's JAX param tree;
- deliberate divergence from the reference, as in the JAX package:
  gradients are reset every step (the reference never calls
  ``optimizer.zero_grad()``);
- ``Trainer(device_cache=...)`` trains from a corpus held in device memory
  (``pipeline/device_cache.py``) on an epoch loop that never waits on the
  device: the float32 cache reproduces the host loader's run;
- with a mesh (``parallel/mesh.py``; ``Trainer(use_mesh=True)``) each rank
  steps on its rows of the global batch and the step is JAX's on the whole
  batch: global batch statistics and loss shares
  (``parallel/global_batch.py``), the gradients summed over the ranks.

On a CUDA device the recurrences route as their ops do: LittleNet's and
TwoLayerGRU's GRU runs on kernel K8 at any batch (every train step and
validation utterance) and its backward on K8b; DCCRN's complex LSTMs run on
K9 at B <= 16 and FullSubNet's joint recurrence on K11, so a DCCRN or
FullSubNet train step at the default batch of 16 runs its kernel forward,
saving the gates, and its backward on K9b (the counterpart of the loop XLA
compiles from the JAX custom VJPs' recompute).

Spans (``utils/profiling``): ``train.step`` around a step, and inside it
``train.forward``, ``train.backward`` (``loss.backward()`` on the calling
thread) and ``train.update`` (Adam's).
"""

from __future__ import annotations

import collections
import dataclasses
import json
import math
import os
import time
from typing import Callable

import numpy as np
import torch
from torch import nn

from aec_tpu_torch.configs import TrainConfig
from aec_tpu_torch.dsp.erb import erb_filterbank
from aec_tpu_torch.dsp.stft import StftConfig
from aec_tpu_torch.models.little_net import little_net_init, little_net_loss
from aec_tpu_torch.models.tree_net import functional_params, map_tree
from aec_tpu_torch.parallel.global_batch import global_batch, sum_gradients
from aec_tpu_torch.parallel.mesh import (
    globalize_batch,
    is_primary,
    make_mesh,
    process_count,
    process_local_files,
)
from aec_tpu_torch.pipeline.datasets import EvalLoader, TrainLoader
from aec_tpu_torch.train import checkpoints
from aec_tpu_torch.utils import profiling
from aec_tpu_torch.utils.tools import count_frames, get_logger, loss_log, num_params
from aec_tpu_torch.utils.weights import leaf_pairs, load_jax, param_tree, to_jax

LossFn = Callable[..., tuple[torch.Tensor, dict]]

# optax's state types, for the checkpoint key paths (``.count``, ``.mu``, ...)
ScaleByAdamState = collections.namedtuple("ScaleByAdamState", "count mu nu")
ScaleByScheduleState = collections.namedtuple("ScaleByScheduleState", "count")


def make_lr_schedule(cfg: TrainConfig, steps_per_epoch: int) -> Callable[[int], float]:
    """torch StepLR semantics over update counts: lr0 * gamma^(epoch // period)."""

    def schedule(step: int) -> float:
        epoch = step // max(steps_per_epoch, 1)
        return cfg.lr * (cfg.lr_decay_factor ** (epoch // cfg.lr_decay_period))

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0) -> Callable[[int], float]:
    """``optax.cosine_decay_schedule``: ``init_value * ((1 - alpha) * 0.5 *
    (1 + cos(pi * min(count, decay_steps) / decay_steps)) + alpha)``."""
    if decay_steps <= 0:
        raise ValueError(f"decay_steps must be positive, got {decay_steps}")

    def schedule(count: int) -> float:
        frac = min(count, decay_steps) / decay_steps
        return init_value * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * frac)) + alpha)

    return schedule


class Optimizer:
    """``optax.chain([clip_by_global_norm(clip_norm)], adam(schedule))`` of
    the JAX loop on ``torch.optim.Adam``, whose update equals optax's
    (m_hat / (sqrt(v_hat) + 1e-8), no eps inside the root). The group's
    ``lr`` is set to ``schedule(count)`` before each step, ``count`` being
    the updates done so far, as optax evaluates the schedule before counting.
    Clipping is optax's: ``g / norm * clip_norm`` unless ``norm < clip_norm``
    (not ``clip_grad_norm_``, which adds 1e-6 to the norm). ``schedule``, a
    callable of the update count, replaces the config's stepped decay (e.g.
    :func:`cosine_decay_schedule`)."""

    def __init__(self, cfg: TrainConfig, steps_per_epoch: int, net: nn.Module,
                 schedule: Callable[[int], float] | None = None):
        self.net = net
        self.schedule = schedule or make_lr_schedule(cfg, steps_per_epoch)
        self.clip_norm = cfg.clip_norm
        self.adam = torch.optim.Adam(net.parameters(), lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8)
        self.count = 0

    def update(self) -> None:
        """One update from the gradients in the net's ``.grad``; a
        parameter the loss does not reach (``.grad`` None) takes a zero
        gradient, as optax's update does."""
        for p in self.net.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.clip_norm >= 0:
            grads = [p.grad for p in self.net.parameters()]
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            keep = norm < self.clip_norm  # no host sync: select on the device
            for g in grads:
                g.copy_(torch.where(keep, g, g / norm * self.clip_norm))
        for group in self.adam.param_groups:
            group["lr"] = self.schedule(self.count)
        self.adam.step()
        self.count += 1

    def state_tree(self) -> tuple:
        """The state in optax's layout: ``[i][0]`` Adam's count, mu and nu
        (trees keyed like the family's JAX param tree), ``[i][1]`` the
        schedule's count, with ``i = 1`` behind clipping's empty state, else 0."""
        def moment(key):
            return param_tree(self.net, lambda p: self.adam.state.get(p, {}).get(
                key, torch.zeros_like(p)))

        count = np.int32(self.count)
        adam = (ScaleByAdamState(count, moment("exp_avg"), moment("exp_avg_sq")),
                ScaleByScheduleState(count))
        return ((), adam) if self.clip_norm >= 0 else (adam,)

    def load_state_tree(self, tree) -> None:
        """Resume from :meth:`state_tree`'s layout (numpy leaves, e.g. read by
        ``checkpoints.restore`` from a JAX or a port checkpoint)."""
        adam, sched = tree[-1]
        params = param_tree(self.net)
        for (p, mu), (_, nu) in zip(leaf_pairs(params, adam.mu), leaf_pairs(params, adam.nu)):
            self.adam.state[p] = {
                "step": torch.tensor(float(adam.count), dtype=torch.float32),
                "exp_avg": torch.as_tensor(np.array(mu), device=p.device),
                "exp_avg_sq": torch.as_tensor(np.array(nu), device=p.device),
            }
        self.count = int(sched.count)


def make_optimizer(cfg: TrainConfig, steps_per_epoch: int, net: nn.Module) -> Optimizer:
    """The JAX loop's name for :class:`Optimizer` over ``net``'s parameters."""
    return Optimizer(cfg, steps_per_epoch, net)


def train_tree(optimizer: Optimizer) -> dict:
    """``{"params", "opt_state", "model_state"}`` as the JAX trainers
    checkpoint them (the JAX ``Trainer`` writes no ``model_state``; a
    stateless net's is ``{}``, which adds no entry)."""
    params, state = to_jax(optimizer.net)
    return {"params": params, "opt_state": optimizer.state_tree(), "model_state": state}


def restore_train_tree(path: str, optimizer: Optimizer) -> None:
    """Load params, optimizer state and BatchNorm statistics from a JAX or
    port checkpoint."""
    restored = checkpoints.restore(path, train_tree(optimizer))
    load_jax(optimizer.net, restored["params"], restored["model_state"])
    optimizer.load_state_tree(restored["opt_state"])


def _global_update(optimizer: Optimizer, mesh, forward_backward) -> tuple:
    """``forward_backward()`` -> (loss, aux) run with the loss's backward,
    then the update. With a mesh that has a data group the forward's batch
    reductions are the global batch's (``parallel/global_batch.py``) and the
    gradients and the loss are summed over the data axis before the update
    (each rank's loss being its share of the global one), so every rank
    applies the global step and reports the global loss."""
    optimizer.adam.zero_grad(set_to_none=True)
    with global_batch(mesh) as group:
        loss, aux = forward_backward()
        if group is not None:
            with profiling.span("train.allreduce"):
                loss = sum_gradients(list(optimizer.net.parameters()), loss, group)
    with profiling.span("train.update"):
        optimizer.update()
    return loss.detach(), aux


def make_train_step(
    loss_fn: LossFn, optimizer: Optimizer, mesh=None, *, scfg: StftConfig = StftConfig(),
    sqrt_eps: float = 1e-12,
):
    """One update of ``optimizer.net``: ``step(mic, ref, near, erb) -> loss``
    (a 0-d tensor on the batch's device, not synchronized). ``loss_fn(net,
    mic, ref, near, erb, cfg, sqrt_eps=...)`` returns (scalar loss, aux).

    With ``mesh`` (``parallel.mesh.make_mesh``) each rank passes its rows
    of the global batch (data-sharded; the net is replicated) and the step
    is JAX's step on the whole batch (``_global_update``)."""
    net = optimizer.net

    def step(mic, ref, near, erb):
        def forward_backward():
            with profiling.span("train.forward"):
                loss, aux = loss_fn(net, mic, ref, near, erb, scfg, sqrt_eps=sqrt_eps)
            with profiling.span("train.backward", lend=True):
                loss.backward()
            return loss, aux

        with profiling.span("train.step"):
            return _global_update(optimizer, mesh, forward_backward)[0]

    return step


def make_stateful_train_step(loss_fn: Callable, optimizer: Optimizer, mesh=None):
    """One update of ``optimizer.net`` for any family:
    ``step(model_state, *batch) -> (new_state, loss)``. ``loss_fn(params,
    model_state, *batch)`` returns (scalar loss, ``{"state": new_state}``),
    ``params`` being the net's parameters as its family's functional loss
    takes them (:func:`functional_params`). The new BatchNorm statistics
    come out of the loss's aux detached, once per step; they never enter
    autograd. The parameters are updated in place.

    With ``mesh`` the batch arrays are each rank's rows and the step is
    JAX's on the global batch (``_global_update``): the BatchNorm
    statistics too are the global batch's, the same on every rank."""
    net = optimizer.net

    def step(model_state, *batch):
        def forward_backward():
            with profiling.span("train.forward"):
                loss, aux = loss_fn(functional_params(net), model_state, *batch)
            with profiling.span("train.backward", lend=True):
                loss.backward()
            return loss, aux

        with profiling.span("train.step"):
            loss, aux = _global_update(optimizer, mesh, forward_backward)
            return map_tree(aux["state"], torch.Tensor.detach), loss

    return step


def make_eval_step(loss_fn: LossFn, *, scfg: StftConfig = StftConfig()):
    """``step(net, mic, ref, near, erb) -> (loss, enhanced wav)`` without
    gradients; the loss's default ``sqrt_eps`` (0); the wav feeds the
    optional stoi/sisdr validation metrics."""

    @torch.no_grad()
    def step(net, mic, ref, near, erb):
        loss, aux = loss_fn(net, mic, ref, near, erb, scfg)
        return loss, aux["wav"]

    return step


def add_wave_metrics(sums: dict, counts: dict, est: np.ndarray, clean: np.ndarray,
                     n: int) -> None:
    """Add each utterance's metrics named by ``sums`` ("sisdr", "stoi") of
    ``est`` against ``clean``, over their first ``n`` samples, to ``sums``
    and ``counts``. stoi may be nan on clips too short for a 384 ms segment,
    which are skipped."""
    from aec_tpu_torch.train.metrics import si_snr
    from aec_tpu_torch.train.stoi import stoi

    for e, c in zip(est[:, :n], clean[:, :n]):
        if "sisdr" in sums:
            sums["sisdr"] += float(si_snr(torch.from_numpy(e), torch.from_numpy(c)))
            counts["sisdr"] += 1
        if "stoi" in sums:
            s = stoi(c, e)
            if np.isfinite(s):
                sums["stoi"] += s
                counts["stoi"] += 1


def shard_corpus(tr_list: list[str], batch_size: int, bucket_quantum: int, mesh):
    """(files, local batch, pad_to, steps_cap) of this rank's loader, as
    JAX's trainers take them: without a mesh or with one process, the whole
    list at the global batch; with several, ``process_local_files`` at the
    global batch over the process count, every utterance padded to the
    longest rounded up to ``bucket_quantum`` (so the ranks' batches have one
    shape) and the epoch capped at the smallest shard's batch count (so
    every rank enters the same number of collective steps)."""
    pc = process_count()
    if mesh is None or pc == 1:
        return tr_list, batch_size, 0, None
    if batch_size % pc:
        raise ValueError(f"global batch_size {batch_size} must divide evenly over {pc} processes")
    from aec_tpu_torch.pipeline.h5io import utterance_length

    local_bs = batch_size // pc
    longest = max(utterance_length(p) for p in tr_list)
    pad_to = -(-longest // bucket_quantum) * bucket_quantum
    return process_local_files(tr_list), local_bs, pad_to, (len(tr_list) // pc) // max(local_bs, 1)


@dataclasses.dataclass
class Trainer:
    """Epoch-loop orchestrator with the reference's cadence and logging, on
    ``device`` (the card unless asked for ``"cpu"``)."""

    tr_list: list[str]
    cv_file: str
    ckpt_dir: str
    cfg: TrainConfig = TrainConfig()
    scfg: StftConfig = StftConfig()
    erb_bands: int = 32
    resume_model: str = ""
    time_log: str = ""
    loss_log_name: str = "loss.txt"
    use_mesh: bool = False
    bucket_quantum: int = 4096
    # the family's loss and init (the registry's, as JAX's CLI passes them)
    loss_fn: LossFn = little_net_loss
    init_fn: Callable[..., nn.Module] = little_net_init
    # optional cv metrics ("stoi", "sisdr"); each gets a best_<metric>.npz
    # slot; higher is better
    validate_metrics: tuple[str, ...] = ()
    # "" (the host loader) or "int16" / "bfloat16" / "float32": hold the
    # whole corpus and the cv set in device memory (pipeline/device_cache.py)
    # and run each epoch's steps without waiting on the device; the same
    # update math, cadence and shuffle stream; validate_metrics unsupported
    device_cache: str = ""
    device: str = "cuda"

    def __post_init__(self):
        # once-per-epoch validation/checkpoint cadence
        self.logging_period = self.cfg.logging_period or max(
            len(self.tr_list) // self.cfg.batch_size, 1
        )
        unknown = set(self.validate_metrics) - {"stoi", "sisdr"}
        if unknown:
            raise ValueError(
                f"unknown validate_metrics {sorted(unknown)}; supported: stoi, sisdr"
            )

    def train(self) -> dict:
        os.makedirs(self.ckpt_dir, exist_ok=True)
        logger = get_logger(os.path.join(self.ckpt_dir, "train.log"), log_file=True)
        if self.device_cache:
            if self.use_mesh:
                raise ValueError("device_cache is single-host/single-chip")
            if self.validate_metrics:
                raise ValueError(
                    "validate_metrics need per-utterance wav readback — "
                    "use the host loader (device_cache='')"
                )
            return self._train_cached(logger)
        dev = torch.device(self.device)
        mesh = make_mesh() if self.use_mesh else None
        tr_files, local_bs, pad_to, steps_cap = shard_corpus(
            self.tr_list, self.cfg.batch_size, self.bucket_quantum, mesh)
        loader = TrainLoader(tr_files, local_bs, bucket_quantum=self.bucket_quantum,
                             pad_to=pad_to, seed=self.cfg.seed)
        cv_loader = EvalLoader(self.cv_file, batch_size=1)

        net = self.init_fn(generator=torch.Generator().manual_seed(self.cfg.seed), device=dev)
        erb = torch.as_tensor(erb_filterbank(self.scfg.n_freqs, 16000, self.erb_bands),
                              dtype=torch.float32, device=dev)
        steps_per_epoch = max(len(self.tr_list) // self.cfg.batch_size, 1)
        optimizer = make_optimizer(self.cfg, steps_per_epoch, net)
        train_step = make_train_step(self.loss_fn, optimizer, mesh, scfg=self.scfg)
        eval_step = make_eval_step(self.loss_fn, scfg=self.scfg)
        logger.info("Trainable parameter count: {:,d} -> {:.2f} MB".format(
            num_params(net), num_params(net) * 4 / 2**20))

        ckpt_info = {"cur_epoch": 0, "cur_iter": 0, "tr_loss": None, "cv_loss": None,
                     "best_loss": float("inf")}
        for m in self.validate_metrics:
            ckpt_info[f"cv_{m}"] = None
            ckpt_info[f"best_{m}"] = float("-inf")
        if self.resume_model:
            restore_train_tree(self.resume_model, optimizer)
            ckpt_info.update(checkpoints.load_info(self.resume_model))
            logger.info(f"Resumed from {self.resume_model}: {ckpt_info}")

        keys = ("nearend_mic", "farend_speech", "nearend_speech")
        while ckpt_info["cur_epoch"] < self.cfg.max_n_epochs:
            accu_loss, accu_frames = 0.0, 0
            for n_iter, batch in enumerate(loader):
                if steps_cap is not None and n_iter >= steps_cap:
                    break
                t0 = time.perf_counter()
                if mesh is not None:
                    mic, ref, near = globalize_batch(mesh, [batch[k] for k in keys], dev)
                else:
                    mic, ref, near = (torch.from_numpy(batch[k]).to(dev) for k in keys)
                loss_val = float(train_step(mic, ref, near, erb))  # waits for the device
                batch_time = time.perf_counter() - t0
                n_frames = count_frames(batch["n_samples"], self.scfg.win_len, self.scfg.hop)
                accu_loss += loss_val * n_frames
                accu_frames += n_frames

                msg = (
                    f"Epoch [{ckpt_info['cur_epoch'] + 1}/{self.cfg.max_n_epochs}], "
                    f"Iter [{n_iter}], tr_loss = {loss_val:.4f} / "
                    f"{accu_loss / accu_frames:.4f}, batch_time (s) = {batch_time:.4f}"
                )
                if self.time_log and is_primary():
                    with open(self.time_log, "a") as f:
                        print(msg, file=f)

                if (n_iter + 1) % self.logging_period == 0:
                    metrics = self.validate(eval_step, net, erb, cv_loader)
                    ckpt_info["cur_iter"] = n_iter
                    ckpt_info["tr_loss"] = accu_loss / accu_frames
                    ckpt_info["cv_loss"] = metrics["loss"]
                    is_best = metrics["loss"] < ckpt_info["best_loss"]
                    if is_best:
                        ckpt_info["best_loss"] = metrics["loss"]
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
                        loss_log(os.path.join(self.ckpt_dir, self.loss_log_name), ckpt_info,
                                 metrics)
                        # per-period metrics: loss and throughput (xRT = audio s / wall s)
                        audio_s = (batch["nearend_mic"].shape[0] * batch["nearend_mic"].shape[1]
                                   / 16000.0)
                        with open(os.path.join(self.ckpt_dir, "metrics.jsonl"), "a") as f:
                            f.write(json.dumps({
                                "epoch": ckpt_info["cur_epoch"] + 1, "iter": n_iter,
                                "tr_loss": ckpt_info["tr_loss"], "cv_loss": metrics["loss"],
                                "batch_time_s": round(batch_time, 5),
                                "train_xrt": round(audio_s / batch_time, 1),
                            }) + "\n")
                    logger.info("Epoch [{:d}/{:d}], ( tr_loss: {:.4f} | best_loss: {:.4f} )".format(
                        ckpt_info["cur_epoch"] + 1, self.cfg.max_n_epochs, ckpt_info["tr_loss"],
                        ckpt_info["best_loss"]))
                    accu_loss, accu_frames = 0.0, 0
            ckpt_info["cur_epoch"] += 1
        return {"net": net, "optimizer": optimizer, "ckpt_info": ckpt_info}

    def _train_cached(self, logger) -> dict:
        """Training on a device-resident corpus (JAX's ``_train_cached``).

        The same update math, optimizer schedule, shuffle stream
        (``np.random.default_rng(seed)``, one shuffle an epoch, the first
        ``steps_per_epoch * batch_size`` of it), per-epoch validation and
        latest / best checkpoints as the host loader's loop. Each step
        gathers its batch from the cache on the device and keeps its loss
        there; the epoch's indices go up once and its losses come back
        once, so the host never waits on the device inside an epoch (JAX
        scans the epoch in one dispatch). cv runs at batch 1 over the cached
        cv set, which equals the host ``validate`` on a uniform-length
        corpus (on the card a batch-1 GRU is kernel K8)."""
        from aec_tpu_torch.pipeline import device_cache as dc

        cfg, dev = self.cfg, torch.device(self.device)
        t_load0 = time.perf_counter()
        logger.info("device_cache=%s: caching %d train files + cv on device",
                    self.device_cache, len(self.tr_list))
        corpus = dc.from_files(self.tr_list, dtype=self.device_cache,
                               bucket_quantum=self.bucket_quantum, device=dev,
                               progress=lambda i, n: logger.info("  cached %d/%d", i, n))
        cv = dc.from_grouped(self.cv_file, dtype=self.device_cache,
                             bucket_quantum=self.bucket_quantum, device=dev)
        logger.info("corpus resident: %d x %d (%s) in %.1f s", corpus.n_utts,
                    corpus.arrays[dc.CACHE_KEYS[0]].shape[1], self.device_cache,
                    time.perf_counter() - t_load0)

        net = self.init_fn(generator=torch.Generator().manual_seed(cfg.seed), device=dev)
        erb = torch.as_tensor(erb_filterbank(self.scfg.n_freqs, 16000, self.erb_bands),
                              dtype=torch.float32, device=dev)
        steps_per_epoch = max(corpus.n_utts // cfg.batch_size, 1)
        optimizer = make_optimizer(cfg, steps_per_epoch, net)
        train_step = make_train_step(self.loss_fn, optimizer, scfg=self.scfg)
        eval_step = make_eval_step(self.loss_fn, scfg=self.scfg)
        logger.info("Trainable parameter count: {:,d} -> {:.2f} MB".format(
            num_params(net), num_params(net) * 4 / 2**20))

        ckpt_info = {"cur_epoch": 0, "cur_iter": 0, "tr_loss": None, "cv_loss": None,
                     "best_loss": float("inf")}
        if self.resume_model:
            restore_train_tree(self.resume_model, optimizer)
            ckpt_info.update(checkpoints.load_info(self.resume_model))
            logger.info(f"Resumed from {self.resume_model}: {ckpt_info}")

        rng = np.random.default_rng(cfg.seed)
        cv_idx = torch.arange(cv.n_utts, device=dev)[:, None]  # batch 1
        n_frames = count_frames(corpus.n_samples, self.scfg.win_len, self.scfg.hop)
        audio_s = cfg.batch_size * corpus.n_samples / 16000.0
        sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

        while ckpt_info["cur_epoch"] < cfg.max_n_epochs:
            order = np.arange(corpus.n_utts)
            rng.shuffle(order)
            idx = torch.as_tensor(order[: steps_per_epoch * cfg.batch_size]
                                  .reshape(steps_per_epoch, cfg.batch_size), device=dev)
            sync()
            t0 = time.perf_counter()
            losses = torch.stack([train_step(*corpus.batch(ib), erb) for ib in idx])
            losses = losses.cpu().numpy()  # one readback per epoch
            epoch_time = time.perf_counter() - t0
            batch_time = epoch_time / steps_per_epoch

            if self.time_log:
                with open(self.time_log, "a") as f:
                    for n_iter, loss_val in enumerate(losses):
                        print(f"Epoch [{ckpt_info['cur_epoch'] + 1}/{cfg.max_n_epochs}], "
                              f"Iter [{n_iter}], tr_loss = {loss_val:.4f} / "
                              f"{losses[: n_iter + 1].mean():.4f}, "
                              f"batch_time (s) = {batch_time:.4f}", file=f)

            cv_losses = torch.stack([eval_step(net, *cv.batch(ib), erb)[0] for ib in cv_idx])
            metrics = {"loss": float(cv_losses.cpu().numpy().mean())}
            ckpt_info["cur_iter"] = steps_per_epoch - 1
            # uniform-length corpus: the frame weights are equal, so the
            # frame-weighted mean is the plain mean
            ckpt_info["tr_loss"] = float(losses.mean())
            ckpt_info["cv_loss"] = metrics["loss"]
            is_best = metrics["loss"] < ckpt_info["best_loss"]
            if is_best:
                ckpt_info["best_loss"] = metrics["loss"]
            checkpoints.save_latest_best(os.path.join(self.ckpt_dir, "models"),
                                         train_tree(optimizer), ckpt_info, is_best)
            loss_log(os.path.join(self.ckpt_dir, self.loss_log_name), ckpt_info, metrics)
            with open(os.path.join(self.ckpt_dir, "metrics.jsonl"), "a") as f:
                f.write(json.dumps({
                    "epoch": ckpt_info["cur_epoch"] + 1, "iter": ckpt_info["cur_iter"],
                    "tr_loss": ckpt_info["tr_loss"], "cv_loss": metrics["loss"],
                    "batch_time_s": round(batch_time, 5), "epoch_time_s": round(epoch_time, 3),
                    "train_xrt": round(audio_s / batch_time, 1), "n_frames_per_batch": n_frames,
                }) + "\n")
            logger.info("Epoch [{:d}/{:d}] {:.2f}s, ( tr_loss: {:.4f} | cv_loss: {:.4f} | "
                        "best_loss: {:.4f} )".format(
                            ckpt_info["cur_epoch"] + 1, cfg.max_n_epochs, epoch_time,
                            ckpt_info["tr_loss"], metrics["loss"], ckpt_info["best_loss"]))
            ckpt_info["cur_epoch"] += 1
        return {"net": net, "optimizer": optimizer, "ckpt_info": ckpt_info}

    def validate(self, eval_step, net, erb, cv_loader) -> dict:
        """Frame-weighted mean cv loss plus the optional waveform metrics
        (mean over utterances, :func:`add_wave_metrics`)."""
        accu_loss, accu_frames = 0.0, 0
        metric_sums = {m: 0.0 for m in self.validate_metrics}
        metric_counts = {m: 0 for m in self.validate_metrics}
        for batch in cv_loader:
            loss, wav = eval_step(net, *(torch.from_numpy(batch[k]).to(erb.device) for k in (
                "nearend_mic", "farend_speech", "nearend_speech")), erb)
            n_frames = count_frames(batch["n_samples"], self.scfg.win_len, self.scfg.hop)
            accu_loss += float(loss) * n_frames
            accu_frames += n_frames
            if self.validate_metrics:
                add_wave_metrics(metric_sums, metric_counts, wav.cpu().numpy(),
                                 batch["nearend_speech"], batch["n_samples"])
        out = {"loss": accu_loss / max(accu_frames, 1)}
        for m in self.validate_metrics:
            out[m] = metric_sums[m] / max(metric_counts[m], 1)
        return out

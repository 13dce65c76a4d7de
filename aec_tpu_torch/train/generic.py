"""Model adapters (``aec_tpu/train/generic.py``): one interface for every
ported family, used by ``cli/infer`` (and by the generic trainer, ROADMAP
A1, which comes with the training slice).

Stateless families (LittleNet, TwoLayerGRU) take an ``nn.Module`` as their
params and ``{}`` as state; DCCRN takes its (params, state) trees of tensors,
BatchNorm running statistics in the state.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from aec_tpu_torch.dsp.erb import erb_filterbank
from aec_tpu_torch.dsp.stft import StftConfig


@dataclasses.dataclass
class ModelAdapter:
    """Normalizes a model family to: ``init(generator, device) -> (params,
    state | {})``, ``loss(params, state, mic, far, near, echo, train) ->
    (loss, new_state)`` and ``enhance(params, state, mic, far) -> wav`` (eval
    mode)."""

    init: Callable[..., tuple[Any, Any]]
    loss: Callable[..., tuple[torch.Tensor, Any]]
    stateful: bool
    enhance: Callable[..., torch.Tensor] | None = None


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

        return ModelAdapter(init, loss, stateful=False, enhance=enhance)

    if name == "dccrn":
        from aec_tpu_torch.models.dccrn import DccrnConfig, dccrn_apply, dccrn_init, dccrn_loss_v1

        cfg = DccrnConfig()

        def init(generator=None, device="cuda"):
            return dccrn_init(cfg, generator=generator, device=device)

        def loss(params, state, mic, far, near, echo, train):
            value, aux = dccrn_loss_v1(params, state, mic, far, near, echo, cfg, train=train)
            return value, aux["state"]

        def enhance(params, state, mic, far):
            return dccrn_apply(params, state, mic, far, cfg, train=False)[0]["wav"]

        return ModelAdapter(init, loss, stateful=True, enhance=enhance)

    from aec_tpu_torch.models.registry import NOT_PORTED

    if name in NOT_PORTED:
        raise KeyError(f"model {name!r} is not ported yet (ROADMAP {NOT_PORTED[name]})")
    raise KeyError(f"no training adapter for model {name!r}")

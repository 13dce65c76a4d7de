"""Interop with the reference's pickled ``.pt`` checkpoints
(``aec_tpu/utils/torch_compat.py``).

The reference pickles its whole ``CheckPoint`` object with ``torch.save``
(tools.py:71-74), so unpickling needs the class importable under the module
names the pickle recorded (``utils.tools`` / ``tools`` / ``utils``):
:func:`_register_stubs` registers stub modules holding this module's stand-in
class. The state-dict maps carry LittleNet's and TwoLayerGRU's weights onto
the port's ``LittleNet`` and from either net (the reference names their
modules gru1 / linear1 / linear2 alike), and DCCRN's (params, state) trees to
the reference's module layout. Unpickle only files this program, the JAX
package or the reference wrote: unpickling can run code.
"""

from __future__ import annotations

import sys
import types

import numpy as np
import torch
from torch import nn


class _CheckPointStub:
    """Shape-compatible stand-in for the reference CheckPoint class."""

    def __init__(self, ckpt_info=None, net_state_dict=None, optim_state_dict=None):
        self.ckpt_info = ckpt_info
        self.net_state_dict = net_state_dict
        self.optim_state_dict = optim_state_dict


def _register_stubs() -> None:
    """Make ``CheckPoint`` importable from ``utils.tools``, ``tools`` and
    ``utils``. Sets this module's class each call, so whichever package
    registered last, the port's loader finds a class it can fill."""
    for mod_name in ("utils.tools", "tools", "utils"):
        if mod_name not in sys.modules:
            sys.modules[mod_name] = types.ModuleType(mod_name)
        setattr(sys.modules[mod_name], "CheckPoint", _CheckPointStub)


def save_reference_checkpoint(path: str, ckpt_info: dict, net_state_dict) -> None:
    """Write a ``.pt`` the reference loads without this package installed:
    the pickle records the class as ``utils.tools.CheckPoint``, as the
    reference's own ``torch.save(self, filename)`` does, so its unpickler
    resolves to its class. ``net_state_dict`` values must be torch tensors."""
    cls = type("CheckPoint", (), {"__init__": _CheckPointStub.__init__})
    cls.__module__ = "utils.tools"
    cls.__qualname__ = "CheckPoint"
    _register_stubs()
    sys.modules["utils.tools"].CheckPoint = cls  # pickle's lookup target
    torch.save(cls(dict(ckpt_info), net_state_dict, None), path)


def load_reference_checkpoint(path: str) -> tuple[dict, dict[str, np.ndarray]]:
    """A reference ``.pt`` checkpoint -> (ckpt_info, numpy state dict)."""
    _register_stubs()
    obj = torch.load(path, map_location="cpu", weights_only=False)
    state = {k: v.detach().cpu().numpy() for k, v in obj.net_state_dict.items()}
    return dict(obj.ckpt_info or {}), state


def little_net_params_from_state_dict(state: dict[str, np.ndarray], *, device="cuda"):
    """The reference ``Little_net`` state dict (gru1 / linear1 / linear2;
    the ConvSTFT buffers are ignored, the port's DSP is analytic) ->
    ``LittleNet`` on ``device``, eval mode."""
    from aec_tpu_torch.utils.weights import params_from_jax, tree_from_named

    return params_from_jax(tree_from_named(state), device=device)


def _np(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def state_dict_from_little_net_params(params, include_dsp_buffers: bool = True
                                      ) -> dict[str, np.ndarray]:
    """A ``LittleNet`` or ``TwoLayerGru`` (or their JAX param tree) -> the
    reference's state dict, for exporting to its tooling.

    ``include_dsp_buffers`` also emits the fixed ConvSTFT / ConviSTFT
    buffers (cpx_stft.weight, istft.weight / window / enframe) that the
    reference registers, built from the same DFT / pinv equations: its
    Tester loads state dicts strictly, so full interop needs them."""
    if isinstance(params, nn.Module):
        from aec_tpu_torch.utils.weights import param_tree

        params = param_tree(params, _np)
    sd = {
        "gru1.weight_ih_l0": _np(params["gru"]["w_ih"]),
        "gru1.weight_hh_l0": _np(params["gru"]["w_hh"]),
        "gru1.bias_ih_l0": _np(params["gru"]["b_ih"]),
        "gru1.bias_hh_l0": _np(params["gru"]["b_hh"]),
        "linear1.weight": _np(params["lin1"]["w"]),
        "linear1.bias": _np(params["lin1"]["b"]),
        "linear2.weight": _np(params["lin2"]["w"]),
        "linear2.bias": _np(params["lin2"]["b"]),
    }
    if include_dsp_buffers:
        from aec_tpu_torch.dsp.stft import StftConfig, _bases
        from aec_tpu_torch.dsp.windows import periodic_window

        cfg = StftConfig()
        analysis, synthesis = _bases(cfg)  # (win, 2K), (2K, win) float64
        window = periodic_window(cfg.win_type, cfg.win_len)
        sd["cpx_stft.weight"] = analysis.T.astype(np.float32)[:, None, :]
        sd["istft.weight"] = synthesis.astype(np.float32)[:, None, :]
        sd["istft.window"] = window.astype(np.float32)[None, :, None]
        sd["istft.enframe"] = np.eye(cfg.win_len, dtype=np.float32)[:, None, :]
    return sd


def state_dict_from_dccrn_params(params, state) -> dict[str, np.ndarray]:
    """DCCRN's (params, state) trees (the port's ``Dccrn.params()`` /
    ``.state()`` or ``weights.dccrn_to_jax``'s numpy trees) -> the reference
    module layout. Two targets, detected from the tree:

    - v1 (dccrn.py:453-521): ``encoder.{i}.0`` ComplexConv2d / ``.1``
      BatchNorm2d / ``.2`` PReLU, mirrored ``decoder.{i}`` (Tanh head),
      plain ``lstm`` (DccrnConfig(use_clstm=False, use_cbn=False,
      rnn_layers=1));
    - v2 (dccrn2.py): ComplexBatchNorm (Wrr/Wri/Wii/Br/Bi + RM*/RV*
      buffers) when use_cbn, ``enhance.{i}.{real,imag}_lstm`` complex-LSTM
      stack when use_clstm, and a bare-conv final decoder stage (v2_head).
    """
    rnn = params.get("rnn")
    is_clstm = isinstance(rnn, (list, tuple))
    if not is_clstm and ("w_ih" not in rnn):
        raise ValueError(
            "state_dict_from_dccrn_params: unrecognized rnn tree (expected a plain-LSTM "
            "dict for v1 or a complex-LSTM list for v2)"
        )

    def bn_entries(prefix, layer, lstate):
        if "bn" not in layer:  # v2 bare-conv head
            return {}
        bn = layer["bn"]
        if "scale" in bn:  # real nn.BatchNorm2d
            return {
                f"{prefix}.weight": _np(bn["scale"]),
                f"{prefix}.bias": _np(bn["bias"]),
                f"{prefix}.running_mean": _np(lstate["bn"]["mean"]),
                f"{prefix}.running_var": _np(lstate["bn"]["var"]),
            }
        s = lstate["bn"]  # ComplexBatchNorm (dccrn.py:222-248 names)
        return {
            f"{prefix}.Wrr": _np(bn["w_rr"]),
            f"{prefix}.Wri": _np(bn["w_ri"]),
            f"{prefix}.Wii": _np(bn["w_ii"]),
            f"{prefix}.Br": _np(bn["b_r"]),
            f"{prefix}.Bi": _np(bn["b_i"]),
            f"{prefix}.RMr": _np(s["m_r"]),
            f"{prefix}.RMi": _np(s["m_i"]),
            f"{prefix}.RVrr": _np(s["v_rr"]),
            f"{prefix}.RVri": _np(s["v_ri"]),
            f"{prefix}.RVii": _np(s["v_ii"]),
        }

    def conv_block(prefix, layer, lstate, *, transpose: bool):
        # the trees' kernels are HWIO (kh, kw, Cin/2, Cout/2); torch's Conv2d
        # wants OIHW, its ConvTranspose2d IOHW
        perm = (2, 3, 0, 1) if transpose else (3, 2, 0, 1)
        out = {
            f"{prefix}.0.real_conv.weight": np.transpose(_np(layer["conv"]["w_r"]), perm),
            f"{prefix}.0.real_conv.bias": _np(layer["conv"]["b_r"]),
            f"{prefix}.0.imag_conv.weight": np.transpose(_np(layer["conv"]["w_i"]), perm),
            f"{prefix}.0.imag_conv.bias": _np(layer["conv"]["b_i"]),
        }
        out.update(bn_entries(f"{prefix}.1", layer, lstate))
        if "prelu" in layer and "bn" in layer:
            out[f"{prefix}.2.weight"] = _np(layer["prelu"]).reshape(1)
        return out

    sd: dict[str, np.ndarray] = {}
    n_dec = len(params["decoder"])
    for i, (layer, lstate) in enumerate(zip(params["encoder"], state["encoder"])):
        sd.update(conv_block(f"encoder.{i}", layer, lstate, transpose=False))
    for i, (layer, lstate) in enumerate(zip(params["decoder"], state["decoder"])):
        block = conv_block(f"decoder.{i}", layer, lstate, transpose=True)
        if i == n_dec - 1:  # the v1 head ends in Tanh: no PReLU entry
            block.pop(f"decoder.{i}.2.weight", None)
        sd.update(block)
    if is_clstm:
        for i, lp in enumerate(rnn):
            for part in ("real", "imag"):
                p = lp[part]
                sd.update({
                    f"enhance.{i}.{part}_lstm.weight_ih_l0": _np(p["w_ih"]),
                    f"enhance.{i}.{part}_lstm.weight_hh_l0": _np(p["w_hh"]),
                    f"enhance.{i}.{part}_lstm.bias_ih_l0": _np(p["b_ih"]),
                    f"enhance.{i}.{part}_lstm.bias_hh_l0": _np(p["b_hh"]),
                })
    else:
        sd.update({
            "lstm.weight_ih_l0": _np(rnn["w_ih"]),
            "lstm.weight_hh_l0": _np(rnn["w_hh"]),
            "lstm.bias_ih_l0": _np(rnn["b_ih"]),
            "lstm.bias_hh_l0": _np(rnn["b_hh"]),
        })
    return sd

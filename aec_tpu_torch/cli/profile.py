"""Model profiling CLI: parameters and operations of every registered family
(``aec_tpu/cli/profile.py``), the JSON rows of the JAX CLI.

  python -m aec_tpu_torch.cli.profile [--models little_net,dccrn] [--n 16384]

Counts on the CPU: ``params`` / ``param_mb`` are the family's (JAX's counts
exactly), ``flops_per_call`` is ``torch.utils.flop_counter``'s count of one
forward on the plain route (``utils/profiling.flops``: the port's CUDA
kernels launch through ctypes, where the counter cannot see them), not held
to XLA's cost analysis.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from aec_tpu_torch.dsp.erb import erb_filterbank
from aec_tpu_torch.models.registry import get_model, list_models
from aec_tpu_torch.utils.profiling import flops
from aec_tpu_torch.utils.tools import num_params


def profile_model(name: str, n: int = 16384, batch: int = 1) -> dict:
    spec = get_model(name)
    gen = torch.Generator().manual_seed(0)
    rng = np.random.default_rng(0)
    mic = torch.from_numpy(rng.standard_normal((batch, n)).astype(np.float32))
    far = torch.from_numpy(rng.standard_normal((batch, n)).astype(np.float32))

    if spec.stateful:
        params, state = spec.init(generator=gen, device="cpu")
        call = lambda: spec.apply(params, state, mic, far)[0]  # noqa: E731
    else:
        params = spec.init(generator=gen, device="cpu")
        if name in ("dct_dnn", "dct_cnn"):
            call = lambda: spec.apply(params, mic)  # noqa: E731
        elif name == "fullsubnet":
            call = lambda: spec.apply(params, mic, far)  # noqa: E731
        else:
            erb = torch.from_numpy(erb_filterbank())
            call = lambda: spec.apply(params, mic, far, erb)  # noqa: E731
    cost = flops(lambda: call()["wav"])
    count = num_params(params)
    return {
        "model": name,
        "params": count,
        "param_mb": round(count * 4 / 2**20, 3),
        "flops_per_call": cost["flops"],
        "flops_per_sample": cost["flops"] / (batch * n),
        "reference": spec.reference,
    }


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="Profile model families")
    p.add_argument("--models", type=str, default=",".join(list_models()))
    p.add_argument("--n", type=int, default=16384)
    p.add_argument("--batch", type=int, default=1)
    args = p.parse_args(argv)
    rows = [profile_model(name.strip(), args.n, args.batch) for name in args.models.split(",")]
    print(json.dumps(rows, indent=2))


if __name__ == "__main__":
    main()

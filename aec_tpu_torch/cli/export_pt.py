"""Export a framework ``.npz`` checkpoint to the reference's ``.pt`` format
(``aec_tpu/cli/export_pt.py``), so the reference's own tooling (its Tester,
``CheckPoint.load``'s strict state-dict load) runs a LittleNet or TwoLayerGRU
trained here. The pickle is the reference's (the whole CheckPoint object,
tools.py:65-82), with the fixed ConvSTFT / ConviSTFT buffers it registers.
Host work only: no device is touched.

  python -m aec_tpu_torch.cli.export_pt --model_file exp/models/best_loss.npz \\
      --out best_loss.pt [--model little_net]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from aec_tpu_torch.models.registry import get_model
from aec_tpu_torch.train import checkpoints
from aec_tpu_torch.utils.tools import get_logger
from aec_tpu_torch.utils.torch_compat import (
    save_reference_checkpoint,
    state_dict_from_little_net_params,
)
from aec_tpu_torch.utils.weights import param_tree

logger = get_logger(__name__)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="Export .npz checkpoint to reference .pt")
    p.add_argument("--model_file", required=True, help="framework .npz checkpoint")
    p.add_argument("--out", required=True, help="output .pt path")
    p.add_argument("--model", default="little_net", choices=("little_net", "two_layer_gru"),
                   help="family (both use the reference gru1/linear1/linear2 module names, "
                        "ERB.py:84-88/213-217)")
    args = p.parse_args(argv)

    template = {"params": param_tree(get_model(args.model).init(device="cpu"),
                                     lambda t: t.detach().numpy())}
    params = checkpoints.restore(args.model_file, template)["params"]
    info = checkpoints.load_info(args.model_file)
    sd = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in state_dict_from_little_net_params(params).items()}
    save_reference_checkpoint(args.out, info or {"cur_epoch": 0, "cur_iter": 0}, sd)
    logger.info("wrote %s (%d tensors)", args.out, len(sd))
    print(args.out)


if __name__ == "__main__":
    main()

"""The parallel layer on ``torch.distributed`` (``aec_tpu/parallel``): the
(data, model) mesh of ranks, the global-batch reductions of a
data-parallel step, the pipelined sequence scan, the tensor-parallel LSTM
and a multi-rank dry run."""

from aec_tpu_torch.parallel import mesh
from aec_tpu_torch.parallel.mesh import data_sharding, make_mesh, replicated

__all__ = ["mesh", "make_mesh", "data_sharding", "replicated"]

"""Process groups laid out as a (data, model) mesh (``aec_tpu/parallel/mesh.py``).

JAX runs one SPMD program over a ``jax.sharding.Mesh`` of devices; the port
runs one process (a rank of ``torch.distributed``) per device instead: NCCL
between cards, gloo between CPU processes. A :class:`Mesh` is the rank grid
``(n_data, n_model)`` in row-major order, rank ``r = d * n_model + m``, with
one process group per row and per column, so a collective over the
``"data"`` axis reaches the ranks that hold the other rows of the batch and
one over ``"model"`` those that hold the other shards of a weight.

A batch sharded over ``"data"`` (JAX's ``P("data")``) is split into
contiguous blocks: the rank at data index ``d`` of ``D`` owns rows
``[d * B / D, (d + 1) * B / D)``. Parameters are replicated: every rank
holds them whole, and the step builders of ``train/loop.py`` keep them equal
by summing the gradients over the data axis before each update
(``parallel/global_batch.py`` says why a sum).

Without a process group, :func:`make_mesh` gives a 1 x 1 mesh that runs no
collective, as JAX's mesh does on one device.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist


def distributed_init_if_needed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    device: str = "cuda",
) -> bool:
    """Start ``torch.distributed`` when a coordinator is configured; True
    iff the group was brought up here.

    Resolution order per field, as JAX's: the argument, then the
    environment (``AEC_COORDINATOR`` / ``JAX_COORDINATOR_ADDRESS``,
    ``AEC_NUM_PROCESSES`` / ``JAX_NUM_PROCESSES``, ``AEC_PROCESS_ID`` /
    ``JAX_PROCESS_ID``). With no coordinator anywhere this is a no-op that
    returns False, and so is a call when a group is already up (a launcher
    brought it up, or an earlier call did).

    The group is ``init_process_group(init_method=f"tcp://{address}")``
    with NCCL when ``device`` is a CUDA device and gloo otherwise. On CUDA
    the rank takes its card before the group starts: ``LOCAL_RANK`` where
    a launcher set it, else ``process_id`` modulo the visible cards, so
    ranks numbered host by host land one per card.
    """
    coordinator_address = (
        coordinator_address
        or os.environ.get("AEC_COORDINATOR")
        or os.environ.get("JAX_COORDINATOR_ADDRESS")
    )
    if not coordinator_address:
        return False
    if dist.is_initialized():
        return False

    def env_int(*names):
        return next((int(os.environ[n]) for n in names if n in os.environ), None)

    if num_processes is None:
        num_processes = env_int("AEC_NUM_PROCESSES", "JAX_NUM_PROCESSES")
    if process_id is None:
        process_id = env_int("AEC_PROCESS_ID", "JAX_PROCESS_ID")
    if num_processes is None or process_id is None:
        raise ValueError(
            "a coordinator is set but not the process count and id: set AEC_NUM_PROCESSES "
            "and AEC_PROCESS_ID (or pass num_processes / process_id)")
    cuda = torch.device(device).type == "cuda"
    if cuda:
        local = env_int("LOCAL_RANK")
        torch.cuda.set_device(local if local is not None
                              else process_id % torch.cuda.device_count())
    dist.init_process_group(
        backend="nccl" if cuda else "gloo",
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes,
        rank=process_id,
    )
    return True


def process_count() -> int:
    """Ranks in the default group (1 without one): JAX's ``process_count``."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This rank (0 without a group): JAX's ``process_index``."""
    return dist.get_rank() if dist.is_initialized() else 0


def backend_device() -> torch.device:
    """The device the default group's collectives take tensors on: this
    rank's card under NCCL, the CPU under gloo or without a group."""
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


@dataclasses.dataclass
class Mesh:
    """This rank's view of a ``(n_data, n_model)`` grid of ranks.

    ``shape`` maps each axis name to its size, ``ranks`` is the grid of
    global ranks, ``groups`` maps each axis to the process group of this
    rank's row or column (None on a mesh without a process group), and
    ``coords`` to this rank's index along it."""

    shape: dict[str, int]
    ranks: np.ndarray
    groups: dict[str, object]
    coords: dict[str, int]

    def group(self, axis: str):
        return self.groups[axis]

    def index(self, axis: str) -> int:
        return self.coords[axis]

    def axis_ranks(self, axis: str) -> list[int]:
        """The global ranks along ``axis`` through this rank, in axis order."""
        d, m = self.coords["data"], self.coords["model"]
        line = self.ranks[:, m] if axis == "data" else self.ranks[d, :]
        return [int(r) for r in line]

    @property
    def device(self) -> torch.device:
        return backend_device()


def make_mesh(
    n_data: int | None = None,
    n_model: int = 1,
    *,
    devices: list | None = None,
) -> Mesh:
    """Mesh with axes ("data", "model"); by default every rank of the
    default group on the data axis. ``devices`` are the global ranks to lay
    out (the first ``n_data * n_model`` of them, as JAX takes devices);
    every rank of the default group must call this alike, since each
    process group is created by all of them. Without a process group the
    mesh is 1 x 1 and has no groups."""
    if not dist.is_initialized():
        if (n_data or 1) * n_model != 1:
            raise ValueError(f"a {n_data} x {n_model} mesh needs a process group")
        return Mesh({"data": 1, "model": 1}, np.zeros((1, 1), np.int64),
                    {"data": None, "model": None}, {"data": 0, "model": 0})
    ranks = list(devices) if devices is not None else list(range(dist.get_world_size()))
    if n_data is None:
        n_data = len(ranks) // n_model
    if n_data * n_model > len(ranks) or n_data < 1:
        raise ValueError(f"a {n_data} x {n_model} mesh needs more than {len(ranks)} ranks")
    grid = np.asarray(ranks[: n_data * n_model], np.int64).reshape(n_data, n_model)
    me = dist.get_rank()
    groups: dict[str, object] = {"data": None, "model": None}
    # every rank creates every group, in one order
    for m in range(n_model):
        g = dist.new_group([int(r) for r in grid[:, m]])
        if me in grid[:, m]:
            groups["data"] = g
    for d in range(n_data):
        g = dist.new_group([int(r) for r in grid[d, :]])
        if me in grid[d, :]:
            groups["model"] = g
    where = np.argwhere(grid == me)
    if not len(where):
        raise ValueError(f"rank {me} is not in the mesh's ranks {grid.ravel().tolist()}")
    d, m = (int(v) for v in where[0])
    return Mesh({"data": n_data, "model": n_model}, grid, groups, {"data": d, "model": m})


def data_sharding(mesh: Mesh) -> tuple[int, int]:
    """The batch axis split over "data" (JAX's ``P("data")``): this rank's
    block as (index, count) along the data axis; rows
    ``[index * B / count, (index + 1) * B / count)`` of a global batch B."""
    return mesh.index("data"), mesh.shape["data"]


def replicated(mesh: Mesh) -> tuple[int, int]:
    """No axis split (JAX's ``P()``): every rank holds the whole array, the
    one block of one."""
    del mesh
    return 0, 1


def local_rows(mesh: Mesh, n_rows: int) -> slice:
    """This rank's contiguous rows of a global batch of ``n_rows``, which
    must divide by the data axis."""
    i, n = data_sharding(mesh)
    if n_rows % n:
        raise ValueError(f"batch {n_rows} does not divide over the data axis of {n}")
    per = n_rows // n
    return slice(i * per, (i + 1) * per)


def shard_batch(mesh: Mesh, batch: dict, device=None) -> dict:
    """A global host batch dict -> this rank's rows of each array (ndim >= 1)
    as tensors on ``device`` (the mesh's device by default); scalars pass
    through."""
    dev = mesh.device if device is None else device
    return {k: (torch.as_tensor(np.asarray(v)[local_rows(mesh, len(v))]).to(dev)
                if getattr(v, "ndim", 0) >= 1 else v)
            for k, v in batch.items()}


def is_primary() -> bool:
    """True on the rank that owns checkpoint and log writes (rank 0)."""
    return process_index() == 0


def process_local_files(items: list) -> list:
    """This rank's disjoint slice of a global file list,
    ``items[rank::world]`` (each process reads only its shard)."""
    return list(items[process_index():: process_count()])


def globalize_batch(mesh: Mesh, arrays: list, device=None) -> list:
    """Per-rank host arrays -> tensors on this rank's device.

    Each rank passes only its local rows; the global batch is implicit: the
    ranks' rows stacked in data-axis order, ``local_batch x data-axis size``
    rows, which the step builders' collectives treat as one batch. Every
    rank must pass arrays of one shape (fixed-length padding: TrainLoader's
    ``pad_to``)."""
    dev = mesh.device if device is None else device
    return [torch.as_tensor(np.asarray(a)).to(dev) for a in arrays]

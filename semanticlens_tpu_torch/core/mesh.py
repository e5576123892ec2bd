"""Process groups, device meshes and the collectives the port's multi-GPU paths share.

Counterpart of ``semanticlens_tpu.core.mesh`` on ``torch.distributed``. The
JAX package runs one process over many devices and places arrays on a
``jax.sharding.Mesh``; the port runs one process per card (``torchrun``, or
:func:`semanticlens_tpu_torch.parallel.launch.spawn`) and each process
holds its own rows. A :class:`~torch.distributed.device_mesh.DeviceMesh`
stands where the JAX package takes a ``Mesh``, with the same axis names:
``"data"`` (data parallelism: every rank its own rows, one merge at the
end) and ``"model"`` (tensor parallelism: parameters as DTensors, see
:mod:`semanticlens_tpu_torch.parallel.tensor_parallel`).

Collectives run on the backend's device: the card for NCCL, the CPU for
gloo (:func:`comm_device`, decided from ``dist.get_backend``). The CPU tests
run gloo ranks; on the card the port runs NCCL.
"""

from __future__ import annotations

import contextlib
import datetime
import logging
import os
import subprocess
import sys
from dataclasses import dataclass

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

logger = logging.getLogger(__name__)

__all__ = ["backend_reachable", "data_mesh", "data_model_mesh", "enable_compilation_cache", "init_distributed",
           "replicate", "shard_batch", "shard_concept_db", "ShardedRows"]


def init_distributed(backend: str | None = None, *, store_path=None, device=None, timeout_s: float = 600.0
                     ) -> torch.device:
    """Join the process group of this run and return this rank's device.

    ``RANK`` and ``WORLD_SIZE`` come from the environment (``torchrun`` sets
    them, with ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``). With
    ``store_path`` the ranks meet through a ``FileStore`` at that path
    instead of a TCP port. ``backend`` is ``"nccl"`` (the default: one card
    per rank, ``cuda:LOCAL_RANK``) or ``"gloo"`` (the CPU, or ``device`` if
    given: two gloo ranks may share one card). A failed NCCL start raises;
    there is no fallback to gloo. Every collective of the group times out
    after ``timeout_s``, so a lost rank fails the run instead of hanging it.
    Idempotent once the group exists.
    """
    backend = backend or "nccl"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    local_rank = int(os.environ.get("LOCAL_RANK", 0))
    if device is None:
        device = torch.device("cuda", local_rank) if backend == "nccl" else torch.device("cpu")
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if dist.is_initialized():
        return device
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    kwargs = {"backend": backend, "rank": rank, "world_size": world,
              "timeout": datetime.timedelta(seconds=timeout_s)}
    if store_path is not None:
        kwargs["store"] = dist.FileStore(str(store_path), world)
    else:
        kwargs["init_method"] = "env://"
    if backend == "nccl":
        kwargs["device_id"] = device  # starts NCCL now, so a failure raises here
    dist.init_process_group(**kwargs)
    return device


def comm_device(group=None) -> torch.device:
    """Where this group's collectives take their tensors: the card for NCCL, the CPU for gloo."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def check_mesh(mesh) -> DeviceMesh | None:
    """``mesh`` itself; a ``mesh=`` that is neither None nor a ``DeviceMesh`` raises ``TypeError``."""
    if mesh is not None and not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch.distributed DeviceMesh (core.data_mesh), got {type(mesh).__name__}")
    return mesh


def mesh_axis(mesh, axis_name: str = "data"):
    """``(size, rank, group)`` of one mesh axis; ``(1, 0, None)`` without a mesh or that axis."""
    mesh = check_mesh(mesh)
    if mesh is None or axis_name not in (mesh.mesh_dim_names or ()):
        return 1, 0, None
    return mesh.size(mesh.mesh_dim_names.index(axis_name)), mesh.get_local_rank(axis_name), mesh.get_group(axis_name)


def is_tensor_parallel(mesh) -> bool:
    """A mesh with a ``"model"`` axis selects the tensor-parallel mode (DTensor parameters); at width 1
    it is the same code on one rank."""
    mesh = check_mesh(mesh)
    return mesh is not None and "model" in (mesh.mesh_dim_names or ())


@contextlib.contextmanager
def tensor_parallel_region():
    """Where DTensor parameters meet plain tensors: ``implicit_replication``, no autograd, and
    outside inference mode (a view of a DTensor refuses inference tensors)."""
    from torch.distributed.tensor.experimental import implicit_replication

    with torch.inference_mode(False), torch.no_grad(), implicit_replication():
        yield


def full_tensor(x):
    """A DTensor gathered whole; anything else as it is."""
    from torch.distributed.tensor import DTensor

    return x.full_tensor() if isinstance(x, DTensor) else x


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """(W, *x.shape) stack of every rank's ``x``, on ``x``'s device."""
    via = comm_device(group)
    local = x.detach().to(via).contiguous()
    parts = [torch.empty_like(local) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, local, group=group)
    return torch.stack(parts).to(x.device)


def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``op`` over every rank's ``x``, returned on ``x``'s device (``x`` itself is left alone)."""
    via = comm_device(group)
    out = x.detach().to(via, copy=True).contiguous()
    dist.all_reduce(out, op=op, group=group)
    return out.to(x.device)


def barrier(group=None) -> None:
    """Wait for every rank of ``group``; on NCCL the barrier names this rank's card."""
    if dist.get_backend(group) == "nccl":
        dist.barrier(group=group, device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier(group=group)


def is_writer(mesh) -> bool:
    """True on the one rank that writes shared files: global rank 0, or every process without a mesh."""
    return check_mesh(mesh) is None or dist.get_rank() == 0


def _mesh_device_type() -> str:
    """The backend's device: ``"cuda"`` under NCCL, ``"cpu"`` under gloo (see :func:`comm_device`)."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def data_mesh(n_devices: int | None = None, *, axis_name: str = "data") -> DeviceMesh:
    """1-D mesh over every rank of the process group (one card each).

    ``n_devices`` must be the world size when given: a rank outside the
    mesh would have nothing to do.
    """
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"data_mesh({n_devices}): the process group has {world} ranks; start {n_devices}")
    return DeviceMesh(_mesh_device_type(), torch.arange(world), mesh_dim_names=(axis_name,))


def data_model_mesh(model: int) -> DeviceMesh:
    """2-D ``("data", "model")`` mesh: ``model`` consecutive ranks share each tensor-parallel group."""
    world = dist.get_world_size()
    if world % model:
        raise ValueError(f"model axis {model} does not divide the world size {world}")
    return DeviceMesh(_mesh_device_type(), torch.arange(world).reshape(world // model, model),
                      mesh_dim_names=("data", "model"))


def shard_batch(array, mesh: DeviceMesh, *, axis_name: str = "data"):
    """This rank's rows of a global batch: rows ``[r·B/W, (r+1)·B/W)`` of ``W`` ranks on the axis."""
    size, rank, _ = mesh_axis(mesh, axis_name)
    b = array.shape[0]
    if b % size:
        raise ValueError(f"batch of {b} rows does not divide the {size}-way '{axis_name}' axis")
    per = b // size
    return array[rank * per : (rank + 1) * per]


def replicate(tree: dict, mesh: DeviceMesh) -> dict:
    """Broadcast every tensor of a flat dict from global rank 0, so every rank holds identical params."""
    check_mesh(mesh)
    out = {}
    for name, value in tree.items():
        if not isinstance(value, torch.Tensor):
            out[name] = value
            continue
        buf = value.detach().to(comm_device(), copy=True).contiguous()
        dist.broadcast(buf, src=0)
        out[name] = buf.to(value.device)
    return out


@dataclass
class ShardedRows:
    """This rank's rows ``[start, start + len(local))`` of a ``total``-row tensor split over one mesh axis."""

    local: torch.Tensor
    start: int
    total: int
    group: object

    def full(self) -> torch.Tensor:
        """The whole tensor on every rank, rows in order."""
        return all_gather(self.local, self.group).flatten(0, 1)


def shard_concept_db(concept_db: dict, mesh: DeviceMesh, *, axis_name: str = "data") -> dict:
    """Split a concept DB over the component axis for data-parallel Analyze.

    Clarity and polysemanticity are independent per component: each rank
    scores its :class:`ShardedRows` and the scores are all-gathered in
    component order (``scores.clarity_score`` / ``polysemanticity_score``
    take a ``ShardedRows``). Layers whose component count does not divide
    the axis stay whole on every rank (logged), as in the JAX package.
    """
    size, rank, group = mesh_axis(mesh, axis_name)
    out = {}
    for name, value in concept_db.items():
        arr = torch.as_tensor(value)
        c = arr.shape[0]
        if c % size:
            logger.info("layer %s: %d components not divisible by %d-way mesh; kept whole", name, c, size)
            out[name] = arr
            continue
        per = c // size
        out[name] = ShardedRows(arr[rank * per : (rank + 1) * per], rank * per, c, group)
    return out


def backend_reachable(n_devices: int = 1, *, timeout_s: int = 120) -> bool:
    """True when ≥ ``n_devices`` CUDA devices answer, counted in a subprocess with a timeout.

    A wedged card can hang the first CUDA call; the probe in its own
    process turns that into False instead of a hang.
    """
    try:
        proc = subprocess.run([sys.executable, "-c", "import torch; print(torch.cuda.device_count())"],
                              capture_output=True, text=True, timeout=timeout_s)
    except subprocess.TimeoutExpired:
        return False
    try:
        return proc.returncode == 0 and int(proc.stdout.strip() or 0) >= n_devices
    except ValueError:
        return False


def enable_compilation_cache() -> str:
    """The directory where the port's kernels are built and kept between runs.

    The JAX package turns on XLA's persistent compilation cache here. The
    port compiles nothing at run time but its hand-written kernels, which
    ``utils/cuda_build.py`` builds once per source and flags into
    ``semanticlens_tpu_torch/csrc/build/`` and reuses while the source is
    unchanged; there is no other cache to turn on. Returns that directory.
    """
    from semanticlens_tpu_torch.utils.cuda_build import BUILD_DIR

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    return str(BUILD_DIR)

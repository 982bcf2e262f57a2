"""Data parallelism over torch.distributed, one process a GPU, and the
word table row-sharded over a model axis.

Counterpart of `digat_tpu.parallel.mesh`. Where the JAX package shards a
batch along the `data` axis of a device mesh and lets `shard_map` psum the
gradients, the port runs one process a GPU, each with the whole model,
and sums the gradients with one explicit `all_reduce` a step
(`train.train_step.train_step`). Launch with torchrun:

    python -m torch.distributed.run --nproc_per_node N -m digat_tpu_torch.cli ...

`init_distributed` reads torchrun's environment (RANK, WORLD_SIZE,
LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT) and the JAX
package's flags. A JAX process is one host and a port process one GPU, so
`num_processes` is the node count (WORLD_SIZE / LOCAL_WORLD_SIZE),
`process_id` the node rank and `coordinator_address` (host:port) the
rendezvous; a flag that contradicts the environment raises. Without a
launcher, `coordinator_address` with `num_processes` and `process_id`
starts one process a node, one GPU each; with neither, the run is the
single-device one and no process group exists.

`--mesh_model M` > 1 lays the ranks out as JAX's `make_mesh` lays out
devices: a `mesh_data x mesh_model` grid, the model index fastest (rank r
has model index r % M and data index r // M). M divides each node's
ranks, so a model group lies inside one node. The ranks of a model group
see the same batch rows and each holds 1/M of the word table's rows
(`parallel.sharded_table`); a data group holds the same rows of the table
on every rank and splits the batch. Every rank makes every sub-group, in
one order. At M 1 the data group is the whole world and no model group
exists: the data-parallel run is as it was.

Each rank computes on `cuda:LOCAL_RANK` over NCCL, or on the CPU over
gloo; a caller may name the device and the backend. A backend that fails
to start raises: there is no second backend and no move to the CPU. A
rank that raises ends the run: the others' collectives time out after
TIMEOUT_S, and only the waits for rank 0's set-up
(`DistContext.wait_for_main`) are allowed SETUP_TIMEOUT_S."""

from __future__ import annotations

import dataclasses
import os
from datetime import timedelta
from typing import Optional, Sequence

import torch
import torch.distributed as tdist

from digat_tpu_torch.runtime import resolve_device

LAUNCHER_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE")
# A rank that raises leaves the others in a collective of the training or
# scoring loop; they give up after this long, and the run ends.
TIMEOUT_S = 300
# The waits for rank 0's set-up (preparing a dataset, building the kernels)
# may take longer: they run on a gloo group of their own with this timeout.
SETUP_TIMEOUT_S = 4 * 3600


@dataclasses.dataclass(frozen=True)
class DistContext:
    """Where this process stands among the ranks. `backend` None: a single
    process with no process group, where every collective is the identity.
    `model_world` M > 1: the ranks form a (world / M) x M grid, with
    `data_group` the ranks of this rank's model index and `model_group`
    those of its data index (`make_grid`)."""

    rank: int = 0
    world: int = 1
    local_rank: int = 0
    local_world: int = 1
    device: torch.device = torch.device("cpu")
    backend: Optional[str] = None
    setup_group: Optional[object] = dataclasses.field(default=None, compare=False, repr=False)
    model_world: int = 1
    data_group: Optional[object] = dataclasses.field(default=None, compare=False, repr=False)
    model_group: Optional[object] = dataclasses.field(default=None, compare=False, repr=False)

    @property
    def active(self) -> bool:
        """Whether a process group exists (a launched run, even of one rank)."""
        return self.backend is not None

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    @property
    def node(self) -> int:
        """The node rank: the JAX package's process index."""
        return self.rank // self.local_world

    @property
    def nodes(self) -> int:
        """The node count: the JAX package's process count."""
        return self.world // self.local_world

    @property
    def model_rank(self) -> int:
        """This rank's index on the model axis: which rows of the word table
        it holds."""
        return self.local_rank % self.model_world

    @property
    def data_rank(self) -> int:
        """This rank's index on the data axis (the rank itself at M 1)."""
        return self.rank // self.model_world

    @property
    def data_world(self) -> int:
        return self.world // self.model_world

    @property
    def local_data_rank(self) -> int:
        """The data index among this node's ranks: which row group of the
        node's batch this rank takes."""
        return self.local_rank // self.model_world

    @property
    def local_data_world(self) -> int:
        return self.local_world // self.model_world

    def _skips(self, group) -> bool:
        """Whether a collective over `group` is the identity: no process
        group, or a sub-group of one rank (the world itself, even of one
        rank, always takes the call)."""
        return not self.active or (group is not None and tdist.get_world_size(group) == 1)

    def all_reduce_sum_(self, tensors: Sequence[torch.Tensor], group=None) -> None:
        """Sum each tensor over the ranks of `group` (None: the world) in
        place, through one flat buffer and one `all_reduce` (the tensors
        share one dtype and device)."""
        if not tensors or self._skips(group):
            return
        if len({(t.dtype, t.device) for t in tensors}) != 1:
            raise ValueError("all_reduce_sum_ takes tensors of one dtype on one device")
        flat = torch.cat([t.reshape(-1) for t in tensors])
        tdist.all_reduce(flat, group=group)
        _unflatten_into(flat, tensors)

    def broadcast_(self, tensors: Sequence[torch.Tensor], src: int = 0, group=None) -> None:
        """Overwrite each tensor with that of rank `src` (a rank of the
        world, in `group`; None: the world), through one flat buffer a
        dtype."""
        if not tensors or self._skips(group):
            return
        for dtype in dict.fromkeys(t.dtype for t in tensors):
            part = [t for t in tensors if t.dtype == dtype]
            flat = torch.cat([t.reshape(-1) for t in part])
            tdist.broadcast(flat, src, group=group)
            _unflatten_into(flat, part)

    def broadcast_flag(self, flag: bool, src: int = 0) -> bool:
        """Rank `src`'s value of `flag` on every rank."""
        if not self.active:
            return bool(flag)
        t = torch.tensor([int(flag)], device=self.device)
        tdist.broadcast(t, src)
        return bool(t.item())

    def all_gather_rows(self, x: torch.Tensor, group=None) -> torch.Tensor:
        """[rows, ...] of every rank of `group` (None: the world) -> [size *
        rows, ...] in the group's rank order."""
        if self._skips(group):
            return x
        size = self.world if group is None else tdist.get_world_size(group)
        out = x.new_empty((size * x.shape[0],) + tuple(x.shape[1:]))
        tdist.all_gather_into_tensor(out, x.contiguous(), group=group)
        return out

    def wait_for_main(self) -> None:
        """A barrier with SETUP_TIMEOUT_S: the other ranks wait here while
        rank 0 does the run's set-up."""
        if self.active:
            tdist.barrier(group=self.setup_group)


def _unflatten_into(flat: torch.Tensor, tensors: Sequence[torch.Tensor]) -> None:
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view_as(t))
        offset += n


def _tcp_url(address: str) -> str:
    host, _, port = address.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"coordinator_address must be host:port, got {address!r}")
    return f"tcp://{host}:{port}"


def init_distributed(cfg, device=None, backend: Optional[str] = None,
                     timeout_s: float = TIMEOUT_S) -> DistContext:
    """Join the ranks this process was launched among -> its `DistContext`.
    `cfg` is a `config.Config` (`device`, `mesh_data`, `coordinator_address`,
    `num_processes`, `process_id`); `device` and `backend` override the
    defaults (`cuda:LOCAL_RANK` and NCCL, or the CPU and gloo)."""
    env = os.environ
    model_world = max(cfg.mesh_model, 1)
    present = [k for k in LAUNCHER_VARS if k in env]
    if present:
        if len(present) != len(LAUNCHER_VARS):
            raise RuntimeError(f"launcher environment incomplete: {present} set, "
                               f"{sorted(set(LAUNCHER_VARS) - set(present))} missing")
        rank, world, local_rank, local_world = (int(env[k]) for k in LAUNCHER_VARS)
        if world % local_world or rank % local_world != local_rank or not 0 <= rank < world:
            raise RuntimeError(f"RANK {rank}, WORLD_SIZE {world}, LOCAL_RANK {local_rank} and "
                               f"LOCAL_WORLD_SIZE {local_world} do not describe whole nodes")
        nodes, node = world // local_world, rank // local_world
        if cfg.num_processes > 0 and cfg.num_processes != nodes:
            raise ValueError(f"--num_processes {cfg.num_processes} contradicts the launcher's "
                             f"{nodes} nodes (WORLD_SIZE {world} / LOCAL_WORLD_SIZE "
                             f"{local_world})")
        if cfg.process_id >= 0 and cfg.process_id != node:
            raise ValueError(f"--process_id {cfg.process_id} contradicts the launcher's node "
                             f"rank {node}")
        master = (env.get("MASTER_ADDR"), env.get("MASTER_PORT"))
        if cfg.coordinator_address:
            if all(master) and cfg.coordinator_address != f"{master[0]}:{master[1]}":
                raise ValueError(f"--coordinator_address {cfg.coordinator_address} contradicts "
                                 f"MASTER_ADDR:MASTER_PORT {master[0]}:{master[1]}")
            init_method = _tcp_url(cfg.coordinator_address)
        elif all(master):
            init_method = "env://"
        else:
            raise RuntimeError("launched without MASTER_ADDR and MASTER_PORT, and no "
                               "--coordinator_address")
    elif cfg.coordinator_address or cfg.num_processes > 1:
        if not cfg.coordinator_address or cfg.num_processes < 1:
            raise ValueError("without a launcher, --num_processes and --coordinator_address "
                             "go together")
        world, local_rank, local_world = cfg.num_processes, 0, 1
        rank = max(cfg.process_id, 0) if world == 1 else cfg.process_id
        if not 0 <= rank < world:
            raise ValueError(f"--process_id {cfg.process_id} is not a rank of "
                             f"--num_processes {world}")
        init_method = _tcp_url(cfg.coordinator_address)
    else:
        if cfg.mesh_data not in (0, 1):
            raise ValueError(f"--mesh_data {cfg.mesh_data} needs as many ranks; this is one "
                             "process (launch with torch.distributed.run)")
        if model_world > 1:
            raise ValueError(f"--mesh_model {model_world} needs as many ranks on a node; this "
                             "is one process (launch with torch.distributed.run)")
        return DistContext(device=resolve_device(device if device is not None else cfg.device))
    if local_world % model_world:
        raise ValueError(f"--mesh_model {model_world} does not divide the {local_world} ranks "
                         "of a node (a model group lies inside one node)")
    if cfg.mesh_data not in (0, world // model_world):
        raise ValueError(f"--mesh_data {cfg.mesh_data} x --mesh_model {model_world} is not the "
                         f"world size {world} (one rank a GPU; --mesh_data 0 takes world / "
                         "mesh_model)")
    if device is None:
        device = f"cuda:{local_rank}" if cfg.device == "cuda" else cfg.device
    device = resolve_device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", local_rank)
        if not torch.cuda.is_available() or device.index >= torch.cuda.device_count():
            raise RuntimeError(f"rank {rank} wants {device}; this node has "
                               f"{torch.cuda.device_count()} CUDA devices")
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    tdist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world,
                             timeout=timedelta(seconds=timeout_s),
                             device_id=device if backend == "nccl" else None)
    setup = tdist.new_group(backend="gloo", timeout=timedelta(seconds=SETUP_TIMEOUT_S))
    ctx = DistContext(rank, world, local_rank, local_world, device, backend, setup)
    return make_grid(ctx, model_world, timeout_s)


def make_grid(ctx: DistContext, model_world: int, timeout_s: float = TIMEOUT_S) -> DistContext:
    """`ctx` laid out as a (world / M) x M grid over its process group, M =
    `model_world`, the model index fastest: every rank makes the model
    groups (ranks d M .. d M + M - 1 for each data index d), then the data
    groups (ranks m, m + M, ... for each model index m), all in that order,
    and keeps its own two. At M 1, `ctx` itself."""
    if model_world == 1:
        return ctx
    if not ctx.active or ctx.local_world % model_world:
        raise ValueError(f"--mesh_model {model_world} does not divide the {ctx.local_world} "
                         "ranks of a node")
    data_world = ctx.world // model_world
    timeout = timedelta(seconds=timeout_s)
    model_groups = [tdist.new_group([d * model_world + m for m in range(model_world)],
                                    timeout=timeout) for d in range(data_world)]
    data_groups = [tdist.new_group([d * model_world + m for d in range(data_world)],
                                   timeout=timeout) for m in range(model_world)]
    grid = dataclasses.replace(ctx, model_world=model_world)
    return dataclasses.replace(grid, model_group=model_groups[grid.data_rank],
                               data_group=data_groups[grid.model_rank])


def destroy(ctx: DistContext) -> None:
    """Leave the process group that `ctx` joined, if any."""
    if ctx.active and tdist.is_initialized():
        tdist.destroy_process_group()


def build_kernels(ctx: DistContext) -> None:
    """Compile the CUDA kernels once a node: local rank 0 builds, every rank
    waits for it, so that no two ranks run nvcc side by side."""
    if ctx.device.type != "cuda":
        return
    if ctx.local_rank == 0:
        from digat_tpu_torch.ops import build

        build.build_library()
    ctx.wait_for_main()

"""Meshes (the port of ``repro.launch.mesh``): the scan engine's
("cells", "silo") grid on ``torch.distributed``, and the host's own data
mesh.

``make_engine_mesh(shape)`` is the reference's ``jax.make_mesh(shape,
("cells", "silo"))`` over an already initialized ``torch.distributed``
world of cells·silo ranks: rank r = c·silo + s (row-major, as
``jax.make_mesh`` lays out its devices), one process group per cells-row
(the silo ranks that train one block of cells together) and the world
group for the final gathers.  Every rank calls it, in the same order (it
creates process groups).  The caller starts the world itself
(``torchrun``, or ``torch.distributed.init_process_group`` with an
address, the world size and the rank); nothing here reads a cluster's
environment.

Collectives run in place on CUDA tensors under NCCL.  Under gloo a CUDA
tensor is staged through the host (gloo's CUDA collectives do not cover
all-gather), and a CPU tensor goes as it is.  Every collective is
order-preserving and exact: an all-gather concatenates the ranks' pieces in
rank order, and a sum is the one reduction (``silo_reduce="psum"``).

The production mesh of the LM stack (``make_production_mesh``) is the
reference's (16, 16) ("data", "model") pod, or (2, 16, 16) ("pod", "data",
"model") for two pods, held as an abstract mesh: its axis names and shape,
no devices (one card cannot hold 256 or 512 of them).  ``axis_map_for``
and ``make_shard_ctx`` map the logical axes onto it (or onto any mesh with
``axis_names`` and a ``shape`` or ``devices.shape``); the dry-run
(``launch/dryrun.py``) derives each device's shard from them.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch



def engine_mesh_shape(shape) -> tuple[int, int]:
    """``shape`` as (cells, silo): (cells,) gets silo 1.  Raises unless
    both sizes are positive."""
    shape = tuple(int(s) for s in shape)
    if len(shape) == 1:
        shape = shape + (1,)
    if len(shape) != 2 or any(s < 1 for s in shape):
        raise ValueError(f"engine mesh shape must be (cells,) or "
                         f"(cells, silo) with positive sizes, got {shape!r}")
    return shape


@dataclass
class EngineMesh:
    """This rank's place on the (cells, silo) grid and its groups."""
    shape: tuple[int, int]
    rank: int                 # c·silo + s
    cell_rank: int            # c: which block of cells this rank runs
    silo_rank: int            # s: which chunk of clients / panel rows
    silo_group: Any           # the ranks of this cells-row
    world_group: Any
    backend: str

    @property
    def cells(self) -> int:
        return self.shape[0]

    @property
    def silo(self) -> int:
        return self.shape[1]

    @property
    def size(self) -> int:
        return self.shape[0] * self.shape[1]

    def _staged(self, t: torch.Tensor) -> bool:
        return self.backend != "nccl" and t.is_cuda

    def all_gather_silo(self, t: torch.Tensor) -> torch.Tensor:
        """The silo ranks' equal-shaped ``t`` concatenated along dim 0 in
        silo order (the reference's ``all_gather(..., tiled=True)``)."""
        if self.silo == 1:
            return t
        import torch.distributed as dist
        src = t.cpu() if self._staged(t) else t.contiguous()
        out = src.new_empty((self.silo * src.shape[0],) + tuple(src.shape[1:]))
        if self.backend == "nccl":
            dist.all_gather_into_tensor(out, src, group=self.silo_group)
        else:
            dist.all_gather(list(out.chunk(self.silo)), src,
                            group=self.silo_group)
        return out.to(t.device) if self._staged(t) else out

    def all_reduce_silo(self, t: torch.Tensor) -> torch.Tensor:
        """The silo ranks' ``t`` summed (a new tensor; ``t`` is kept)."""
        if self.silo == 1:
            return t
        import torch.distributed as dist
        out = t.cpu() if self._staged(t) else t.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=self.silo_group)
        return out.to(t.device) if self._staged(t) else out

    def gather_objects(self, obj) -> list:
        """Every rank's picklable ``obj`` (host arrays), in rank order."""
        if self.size == 1:
            return [obj]
        import torch.distributed as dist
        out = [None] * self.size
        dist.all_gather_object(out, obj, group=self.world_group)
        return out

    def barrier(self) -> None:
        if self.size > 1:
            import torch.distributed as dist
            dist.barrier(group=self.world_group)


def make_engine_mesh(shape=(8, 1)) -> EngineMesh:
    """The scan engine's ("cells", "silo") grid over the initialized
    ``torch.distributed`` world (DESIGN.md §13): sweep cells split over the
    first axis; local training's client axis and, with ``psum``, the
    memory panel's rows over the second.  The world must hold exactly
    cells·silo ranks."""
    import torch.distributed as dist
    cells, silo = engine_mesh_shape(shape)
    n = cells * silo
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"the ({cells}x{silo}) engine mesh needs an initialized "
            f"torch.distributed world of {n} ranks: start the ranks with "
            "torchrun, or call torch.distributed.init_process_group("
            "backend, init_method=..., world_size=..., rank=...) first")
    world = dist.get_world_size()
    if world != n:
        raise RuntimeError(f"the ({cells}x{silo}) engine mesh needs "
                           f"{n} ranks, the world has {world}")
    rank = dist.get_rank()
    groups = [dist.new_group([c * silo + s for s in range(silo)])
              for c in range(cells)]
    return EngineMesh(shape=(cells, silo), rank=rank,
                      cell_rank=rank // silo, silo_rank=rank % silo,
                      silo_group=groups[rank // silo],
                      world_group=dist.group.WORLD,
                      backend=dist.get_backend())


@dataclass(frozen=True)
class HostMesh:
    """What this host has: a (n_dev,) pure data-parallel mesh."""
    shape: tuple[int]
    axis_names: tuple[str]
    devices: tuple


def make_host_mesh(device_type: str = "cuda") -> HostMesh:
    """Every device of ``device_type`` on this host as a ("data",) mesh
    (the CPU counts as one device)."""
    if device_type == "cuda":
        devices = tuple(torch.device("cuda", i)
                        for i in range(torch.cuda.device_count()))
    else:
        devices = (torch.device(device_type),)
    if not devices:
        raise RuntimeError("make_host_mesh: this host has no CUDA device")
    return HostMesh(shape=(len(devices),), axis_names=("data",),
                    devices=devices)


@dataclass(frozen=True)
class ProductionMesh:
    """The LM stack's target mesh, abstract: axis names and shape."""
    shape: tuple[int, ...]
    axis_names: tuple[str, ...]

    @property
    def size(self) -> int:
        return math.prod(self.shape)


def make_production_mesh(*, multi_pod: bool = False) -> ProductionMesh:
    """The reference's target: 256 chips a pod.

    single pod : (16, 16)    axes ("data", "model")
    two pods   : (2, 16, 16) axes ("pod", "data", "model")
    """
    if multi_pod:
        return ProductionMesh((2, 16, 16), ("pod", "data", "model"))
    return ProductionMesh((16, 16), ("data", "model"))


# When True (variant `fsdp_over_pod`), weights and optimizer state shard over
# BOTH the pod and data axes (32-way) instead of data only: half the
# per-chip weight + optimizer memory, at the price of cross-pod weight
# gathers.
FSDP_OVER_POD = False


def axis_map_for(mesh) -> dict[str, tuple[str, ...]]:
    """Logical -> physical axis map (DESIGN.md §3).

    dp    batch axis: ("pod","data") multi-pod, ("data",) single-pod
    fsdp  weight-sharding axis: ("data",) (("pod","data") under FSDP_OVER_POD)
    tp    tensor-parallel axis: ("model",)
    sp    sequence axis (long-context, batch=1): ("data",)
    """
    names = set(mesh.axis_names)
    amap: dict[str, tuple[str, ...]] = {}
    if "pod" in names and "data" in names:
        amap["dp"] = ("pod", "data")
    elif "data" in names:
        amap["dp"] = ("data",)
    if "data" in names:
        if FSDP_OVER_POD and "pod" in names:
            amap["fsdp"] = ("pod", "data")
        else:
            amap["fsdp"] = ("data",)
        amap["sp"] = ("data",)
    if "model" in names:
        amap["tp"] = ("model",)
    return amap


def make_shard_ctx(mesh):
    """The ``ShardCtx`` of ``mesh``: its axis map and the tp and dp sizes."""
    from repro_torch.sharding.ctx import ShardCtx, axes_total, mesh_sizes
    amap = axis_map_for(mesh)
    sizes = mesh_sizes(mesh)
    return ShardCtx(axis_map=amap, mesh=mesh,
                    tp_size=axes_total(sizes, amap.get("tp")),
                    dp_size=axes_total(sizes, amap.get("dp")))


# ------------------------------------------------------------- spawn helper
def _rank_entry(rank, fn, world, args, init_file, backend, conn):
    import traceback

    import torch.distributed as dist
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    try:
        conn.send((fn(rank, world, *args), None))
    except Exception:                  # reported to the parent, which raises
        conn.send((None, traceback.format_exc()))
    finally:
        conn.close()
        dist.destroy_process_group()


def _stop_resource_tracker() -> None:
    """Stop the resource tracker process that starting a spawned process
    starts in its parent, and wait for it, so that no process of
    ``run_ranks`` outlives it.  The ranks talk over pipes, which register
    nothing with the tracker; a later spawn starts it anew."""
    import os
    from multiprocessing import resource_tracker

    rt = resource_tracker._resource_tracker
    with rt._lock:
        if rt._fd is not None:
            os.close(rt._fd)           # end of file: the tracker exits
            rt._fd = None
        if rt._pid is not None:
            os.waitpid(rt._pid, 0)
            rt._pid = None


def run_ranks(fn, world: int, args=(), *, init_file: str,
              backend: str = "gloo", timeout: float = 300.0) -> list:
    """``fn(rank, world, *args)`` on ``world`` spawned processes, each a rank
    of one ``torch.distributed`` world (a file store at ``init_file``, a
    path that must not exist yet; no port is opened), and their return
    values in rank order.  ``fn`` and ``args`` must pickle, and what ``fn``
    returns too (host arrays, not CUDA tensors).  A rank that raises, or
    a world that has not finished within ``timeout`` seconds, raises here
    after every rank is stopped — so a collective that hangs fails instead
    of blocking its caller.  Every process it starts has ended when it
    returns or raises."""
    import multiprocessing as mp
    import time
    from multiprocessing.connection import wait

    ctx = mp.get_context("spawn")
    pipes = [ctx.Pipe(duplex=False) for _ in range(world)]
    procs = [ctx.Process(target=_rank_entry, daemon=True,
                         args=(r, fn, world, args, init_file, backend,
                               pipes[r][1]))
             for r in range(world)]
    out: dict = {}
    try:
        for p in procs:
            p.start()
        for _, send in pipes:          # the ranks hold the sending ends
            send.close()
        waiting = {recv: r for r, (recv, _) in enumerate(pipes)}
        deadline = time.monotonic() + timeout
        while waiting:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"run_ranks: {len(waiting)} of "
                                   f"{world} ranks unfinished after "
                                   f"{timeout} s")
            for recv in wait(list(waiting), timeout=min(left, 5.0)):
                rank = waiting.pop(recv)
                try:
                    value, err = recv.recv()
                except EOFError:       # the rank died before it sent
                    procs[rank].join(timeout=10)
                    raise RuntimeError(
                        f"run_ranks: rank {rank} exited with "
                        f"{procs[rank].exitcode} before reporting") from None
                if err is not None:
                    raise RuntimeError(
                        f"run_ranks: rank {rank} raised:\n{err}")
                out[rank] = value
    finally:
        for p in procs:
            if p.pid is None:          # never started
                continue
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
        for recv, _ in pipes:
            recv.close()
        _stop_resource_tracker()
    return [out[r] for r in range(world)]

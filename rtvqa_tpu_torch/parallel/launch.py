"""Process groups for the port's multi-device paths: one process per card
(the counterpart of ``jax.devices()`` and of the JAX package's single
controller).

The JAX package runs one program over every device of its mesh. The port
runs one process per card, every process running the same code on its own
shard (SPMD), joined by a ``torch.distributed`` process group:

* ``init_from_env`` joins torchrun's world (``RANK``, ``WORLD_SIZE``,
  ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``) or, outside torchrun,
  makes a world of one; ``world`` does so for a ``with`` block and destroys
  a group it made;
* ``spawn`` starts ``world_size`` processes with the ``spawn`` start method
  (never ``fork``: a parent that has started threads, as JAX and the
  decoder's prefetch do, can deadlock a forked child), joins them in one
  group and returns each rank's result, or raises when one fails or the
  world outlives its timeout.

On the card each rank binds ``cuda:{LOCAL_RANK}`` and NCCL. Gloo runs only
when the caller asks for the CPU or names gloo (two ranks on one card, for
instance, which NCCL refuses). Nothing falls back: NCCL that fails to
initialise raises, and a card that was asked for and is missing raises, as
``device.get_device`` does.

The collective helpers keep tensors on the card under NCCL and move them
through host memory under gloo (gloo's collectives take CPU tensors); they
return tensors on the device they were given. ``agree`` is the failure
protocol of the sharded paths: each step ends its local work with one small
all-reduce of "did I fail", so a failure on one rank raises on every rank
before the next collective instead of leaving the others waiting in it.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import tempfile
import time
from typing import Any, Callable, Iterator, Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from rtvqa_tpu_torch.device import get_device

BACKENDS = ("nccl", "gloo")


class ShardFailure(RuntimeError):
    """A sharded step failed on some rank; raised on every rank of its group."""


def _backend_for(dev: torch.device, backend: Optional[str]) -> str:
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"NCCL needs CUDA devices, got {dev}; gloo runs on the CPU")
    return backend


def _bind(dev: torch.device, backend: str) -> torch.device:
    """This rank's device: ``cuda:{LOCAL_RANK}`` on the card (modulo the
    card count under gloo, which lets ranks share one card), made current."""
    if dev.type != "cuda":
        return dev
    if dev.index is None:
        local_rank = int(os.environ.get("LOCAL_RANK", "0"))
        count = torch.cuda.device_count()
        if backend == "nccl" and local_rank >= count:
            raise RuntimeError(
                f"NCCL needs one card per rank: local rank {local_rank}, {count} card(s); "
                "name gloo to share a card between ranks"
            )
        dev = torch.device("cuda", local_rank % count)
    torch.cuda.set_device(dev)
    return dev


def init_from_env(
    device: str | torch.device | None = None, backend: Optional[str] = None
) -> torch.device:
    """Join this process's world and return its device (default: the card).

    Under torchrun (``RANK`` and ``WORLD_SIZE`` set) the group is torchrun's
    (``env://``); otherwise it is a world of one (rank 0, an in-memory
    store). The backend is NCCL on the card and gloo on the CPU unless
    ``backend`` names one. If a group exists already, only the device is
    bound, under that group's backend."""
    dev = get_device(device)
    if dist.is_initialized():
        return _bind(dev, _backend_for(dev, backend or dist.get_backend()))
    backend = _backend_for(dev, backend)
    dev = _bind(dev, backend)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    return dev


@contextlib.contextmanager
def world(
    device: str | torch.device | None = None, backend: Optional[str] = None
) -> Iterator[torch.device]:
    """``init_from_env`` for a ``with`` block: yields the device, and
    destroys the group on exit if this block made it."""
    made = not dist.is_initialized()
    dev = init_from_env(device, backend)
    try:
        yield dev
    finally:
        if made and dist.is_initialized():
            dist.destroy_process_group()


def _child(rank, fn, world_size, backend, device, store_path, timeout, args, results):
    os.environ["LOCAL_RANK"] = str(rank)
    _bind(get_device(device), backend)
    dist.init_process_group(
        backend, store=dist.FileStore(store_path, world_size), rank=rank,
        world_size=world_size, timeout=datetime.timedelta(seconds=timeout),
    )
    try:
        results.put((rank, fn(*args)))
    finally:
        dist.destroy_process_group()


def spawn(
    fn: Callable[..., Any],
    world_size: int,
    backend: str,
    device: str | torch.device,
    *args,
    timeout: float = 300.0,
) -> list:
    """Run ``fn(*args)`` on ``world_size`` new processes joined in one group
    (``backend`` on ``device``; on the card, rank r binds card r, modulo the
    card count under gloo); returns their results in rank order.

    ``fn`` must be importable by name (a module-level function) and return
    a picklable value; return numpy arrays rather than tensors, which the
    queue would pass through shared memory that an exited child no longer
    holds. Inside ``fn``, ``init_from_env(device)`` returns the rank's
    device. A child that raises or dies fails the call (with its traceback)
    and ends the others; a world that outlives ``timeout`` (also each
    collective's timeout) is killed and raises ``TimeoutError``."""
    _backend_for(torch.device(device), backend)
    ctx = mp.get_context("spawn")
    results = ctx.SimpleQueue()
    got: dict[int, Any] = {}

    def drain():
        while not results.empty():
            rank, out = results.get()
            got[rank] = out

    with tempfile.TemporaryDirectory(prefix="rtvqa_spawn_") as tmp:
        procs = mp.start_processes(
            _child,
            args=(fn, world_size, backend, str(device), os.path.join(tmp, "store"),
                  timeout, args, results),
            nprocs=world_size, join=False, start_method="spawn",
        )
        deadline = time.monotonic() + timeout
        try:
            while not procs.join(timeout=0.1):
                drain()
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"a spawned world of {world_size} did not finish within {timeout} s"
                    )
            drain()
        finally:
            for p in procs.processes:
                if p.is_alive():
                    p.kill()
                p.join(timeout=30)
    missing = sorted(set(range(world_size)) - set(got))
    if missing:
        raise RuntimeError(f"ranks {missing} of a spawned world returned no result")
    return [got[r] for r in range(world_size)]


# --- collectives ------------------------------------------------------------


def comm_device(group) -> torch.device:
    """Where ``group``'s collectives take their tensors: this rank's card
    under NCCL, the CPU under gloo."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _global(group, group_rank: int) -> int:
    return group_rank if group is None else dist.get_global_rank(group, group_rank)


def all_gather(t: torch.Tensor, group) -> list[torch.Tensor]:
    """Every rank's ``t`` (one shape and type across ``group``) in group
    rank order, on ``t``'s device."""
    src = t.to(comm_device(group)).contiguous()
    out = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, src, group=group)
    return [o.to(t.device) for o in out]


def broadcast(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """Group rank ``src``'s ``t`` on every rank of ``group`` (each rank
    passes a tensor of the same shape and type), as a new tensor on ``t``'s
    device."""
    buf = t.to(comm_device(group), copy=True).contiguous()
    dist.broadcast(buf, src=_global(group, src), group=group)
    return buf.to(t.device)


def broadcast_object(obj: Any, src: int = 0, group=None) -> Any:
    """Group rank ``src``'s picklable ``obj`` on every rank of ``group``
    (None: the whole world)."""
    box = [obj]
    dist.broadcast_object_list(box, src=_global(group, src), group=group)
    return box[0]


def share(fn: Callable[[], Any], run: bool = True) -> Any:
    """Run ``fn()`` on the ranks where ``run`` is true (rank 0 among them)
    and return rank 0's result on every rank of the world. If rank 0 fails,
    every rank raises: rank 0 its own error, the others ``ShardFailure``; a
    rank whose own ``fn`` failed raises its error."""
    out, err = None, None
    if run:
        try:
            out = fn()
        except Exception as e:
            err = e
    status = broadcast_object(("ok", out) if err is None else ("error", f"{type(err).__name__}: {err}"))
    if err is not None:
        raise err
    if status[0] == "error":
        raise ShardFailure(f"rank 0 failed: {status[1]}")
    return status[1]


def scatter(parts: Optional[list[torch.Tensor]], numel: int, src: int, group,
            device: torch.device) -> torch.Tensor:
    """Group rank ``src`` sends ``parts[i]`` (flat uint8, ``numel`` bytes
    each, on the communication device: the card under NCCL, the CPU under
    gloo) to group rank i; every rank returns its part on ``device``."""
    comm = comm_device(group)
    buf = torch.empty(numel, dtype=torch.uint8, device=comm)
    dist.scatter(buf, scatter_list=parts, src=_global(group, src), group=group)
    return buf.to(device)


def agree(error: Optional[BaseException], group) -> None:
    """One all-reduce of "did this rank fail": raises ``ShardFailure`` on
    every rank of ``group`` if any rank passed an error (chained to it on
    the rank that failed); returns on every rank otherwise."""
    flag = torch.tensor([0 if error is None else 1], dtype=torch.int32, device=comm_device(group))
    dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=group)
    if int(flag.item()):
        if error is not None:
            raise ShardFailure(f"rank {dist.get_rank()} failed: {error!r}") from error
        raise ShardFailure("a step failed on another rank of the mesh")

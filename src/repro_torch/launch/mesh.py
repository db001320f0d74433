"""Process meshes of the port: the ranks of distributed FETI and the LM
meshes (counterpart of ``repro.launch.mesh``).

The reference shards the subdomain axis over a ``("data",)`` device mesh
inside one program. Here every device is one process (rank) of a
``torch.distributed`` group: :class:`FetiMesh` is one rank's view of that
group (its rank, the world size, the group, its ``torch.device``) and is
what :class:`repro_torch.feti.FetiConfig` carries as ``mesh``.

Backends: ``nccl`` when every rank has a card of its own (``cuda:rank``);
with fewer cards than ranks that is an error unless the caller asks for
``gloo``, which then lets the ranks share the cards round-robin, or run on
the CPU (``device="cpu"``; gloo is then the only backend). Nothing falls
back on its own: :func:`rank_devices` raises with the reason, and
:func:`describe` says what was chosen.

:func:`spawn_ranks` starts the ranks on this host with
``torch.multiprocessing`` (start method ``spawn``) and a ``file://``
rendezvous in a fresh temporary directory, so concurrent callers never
compete for a TCP port. Every collective has a timeout
(:data:`DEFAULT_TIMEOUT_S`): a rank that dies ends the run at once (the
others are terminated), and a rank that hangs or falls out of step in its
collectives fails it within the timeout. The function a rank runs must be
importable from ``repro_torch`` (it is pickled by name), and its return
value comes back to the caller, one per rank.

The reference's ``force_host_device_count`` has no counterpart: gloo
ranks on the CPU play its part.

The LM meshes: :func:`make_production_mesh` describes the reference's
(data=16, model=16) and (pod=2, data=16, model=16) meshes by their shape
alone (:class:`MeshShape`; no 256- or 512-rank group exists), which is
all the dry-run's arithmetic and the sharding rules
(:mod:`repro_torch.distributed.sharding`) read. :func:`make_local_mesh`
is a real ``DeviceMesh`` of (world, 1) over ``("data", "model")`` on the
launched ranks; the sharding rules accept either.
"""
from __future__ import annotations

import datetime
import os
import pickle
import tempfile
import time
from typing import Any, Callable, List, Optional, Sequence, Union

import torch

from repro_torch.device import resolve_device

__all__ = ["DEFAULT_TIMEOUT_S", "FetiMesh", "MeshShape", "RankFailure",
           "describe", "make_feti_mesh", "make_local_mesh",
           "make_production_mesh", "rank_devices", "run_each",
           "spawn_ranks", "split_sizes"]

DEFAULT_TIMEOUT_S = 120.0
BACKENDS = ("nccl", "gloo")


def split_sizes(S: int, world_size: int) -> List[int]:
    """Subdomains per rank: contiguous slices whose sizes differ by at most
    one, the larger first (``torch.tensor_split``'s sizes)."""
    if world_size < 1:
        raise ValueError(f"world size must be at least 1, got {world_size}")
    if world_size > S:
        raise ValueError(f"{world_size} ranks for {S} subdomains: every rank "
                         "needs at least one")
    q, r = divmod(S, world_size)
    return [q + 1 if i < r else q for i in range(world_size)]


class FetiMesh:
    """One rank's view of the FETI process group.

    ``group`` is the ``torch.distributed`` process group (``None``: the
    default group). A mesh whose ranks run no collective (each rank's
    preprocessing, outside ``schur="auto"``) may be built without an
    initialized group, as the tests do to preprocess every slice in one
    process. ``all_reduces`` counts the all-reduces this rank has made and
    ``all_reduce_s`` sums their host seconds: each call returns once its
    sum is in, so they hold the wait for this rank's device work before
    it, for the other ranks and for the exchange.
    """

    def __init__(self, rank: int, world_size: int,
                 device: Union[str, torch.device, None] = None,
                 group=None, backend: Optional[str] = None):
        if not 0 <= rank < world_size:
            raise ValueError(f"rank {rank} outside a world of {world_size}")
        self.rank = int(rank)
        self.world_size = int(world_size)
        self.device = resolve_device(device)
        self.group = group
        self.backend = backend
        self.all_reduces = 0
        self.all_reduce_s = 0.0

    def __repr__(self) -> str:
        return (f"FetiMesh(rank={self.rank}, world_size={self.world_size}, "
                f"device={self.device}, backend={self.backend})")

    def owned(self, S: int) -> range:
        """The global indices of this rank's subdomains out of ``S``."""
        sizes = split_sizes(S, self.world_size)
        lo = sum(sizes[: self.rank])
        return range(lo, lo + sizes[self.rank])

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the ranks: a new contiguous tensor, the
        same bits on every rank (``x`` itself is left as it was)."""
        import torch.distributed as dist

        out = x.clone(memory_format=torch.contiguous_format)
        t0 = time.perf_counter()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=self.group)
        self.all_reduce_s += time.perf_counter() - t0
        self.all_reduces += 1
        return out

    def broadcast_object(self, obj: Any, src: int = 0) -> Any:
        """``obj`` of rank ``src`` on every rank (pickled through the host
        for gloo, through this rank's card for nccl)."""
        import torch.distributed as dist

        box = [obj if self.rank == src else None]
        dist.broadcast_object_list(box, src=src, group=self.group)
        return box[0]


def rank_devices(n: int, backend: Optional[str] = None,
                 device: Union[str, torch.device, None] = None):
    """``(backend, [device of each rank])`` for ``n`` local ranks.

    ``device`` is where the ranks run (``None``: ``cuda``). On CUDA the
    default backend is ``nccl``, which needs a card a rank; with fewer cards
    this raises unless ``backend="gloo"``, which shares the cards
    round-robin. On the CPU the backend must be ``gloo``.
    """
    import torch.distributed as dist

    if n < 1:
        raise ValueError(f"need at least one rank, got {n}")
    if backend not in (None,) + BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    dev = resolve_device(device)
    if dev.type == "cpu":
        if backend != "gloo":
            raise ValueError("ranks on the CPU need backend='gloo' "
                             "(--backend gloo): nccl runs on cards only")
        return "gloo", [torch.device("cpu")] * n
    cards = torch.cuda.device_count()
    if backend == "gloo":
        if not dist.is_gloo_available():
            raise RuntimeError("this torch build has no gloo backend")
        return "gloo", [torch.device("cuda", r % cards) for r in range(n)]
    if cards < n:
        raise ValueError(
            f"{n} ranks need {n} cards for nccl (a card a rank), this machine "
            f"has {cards}; pass backend='gloo' (--backend gloo) to let the "
            "ranks share the cards")
    if not dist.is_nccl_available():
        raise RuntimeError("this torch build has no nccl backend; pass "
                           "backend='gloo' (--backend gloo)")
    return "nccl", [torch.device("cuda", r) for r in range(n)]


def describe(backend: str, devices: Sequence[torch.device]) -> str:
    """One line naming the backend, each rank's device and whether ranks
    share a card."""
    names = [str(d) for d in devices]
    cards = sorted({d for d in names if d.startswith("cuda")})
    shared = (f"; {len(names)} ranks share {len(cards)} card(s)"
              if cards and len(cards) < len(names) else "")
    return (f"{len(names)} rank(s), backend {backend}, devices "
            f"[{', '.join(names)}]{shared}")


def make_feti_mesh(device: Union[str, torch.device, None] = None,
                   group=None) -> FetiMesh:
    """This rank's :class:`FetiMesh` in an initialized process group (the
    default one unless ``group`` is given). ``device`` defaults to
    ``cuda:<rank>`` under nccl and must be given under gloo."""
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("make_feti_mesh needs an initialized process "
                           "group (torch.distributed.init_process_group)")
    rank = dist.get_rank(group)
    world = dist.get_world_size(group)
    backend = str(dist.get_backend(group))
    if device is None:
        if backend != "nccl":
            raise ValueError(f"pass the rank's device under {backend}")
        device = torch.device("cuda", rank)
    return FetiMesh(rank, world, device, group=group, backend=backend)


class MeshShape:
    """A mesh described by its axes alone: ``shape`` maps each axis name to
    its size, in order, as a ``jax.sharding.Mesh``'s does."""

    def __init__(self, shape: dict):
        self.shape = dict(shape)

    @property
    def size(self) -> int:
        n = 1
        for v in self.shape.values():
            n *= v
        return n

    def __repr__(self) -> str:
        return f"MeshShape({self.shape})"


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """The reference's production meshes by shape: one pod (data=16,
    model=16) = 256 devices, two pods (pod=2, data=16, model=16) = 512;
    the "pod" axis carries pure data parallelism."""
    if multi_pod:
        return MeshShape({"pod": 2, "data": 16, "model": 16})
    return MeshShape({"data": 16, "model": 16})


def make_local_mesh(device_type: str = "cuda"):
    """The launched ranks as a ``DeviceMesh`` of (world, 1) over ("data",
    "model") on ``device_type`` (``"cpu"`` for gloo ranks on the CPU).
    Needs an initialized process group."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_local_mesh needs an initialized process "
                           "group (torch.distributed.init_process_group)")
    if device_type == "cuda":
        resolve_device("cuda")
    return init_device_mesh(device_type, (dist.get_world_size(), 1),
                            mesh_dim_names=("data", "model"))


def run_each(rank: FetiMesh, calls: Sequence) -> list:
    """``[fn(rank, *args) for fn, args in calls]``: several functions of a
    rank in one :func:`spawn_ranks` group, in the same order on every
    rank (each function module-level, as ``spawn_ranks`` needs)."""
    return [fn(rank, *args) for fn, args in calls]


class RankFailure(RuntimeError):
    """A spawned rank failed; the message holds its error."""


def _rank_main(rank: int, fn: Callable, n: int, backend: str,
               devices: Sequence[str], init: str, timeout_s: float,
               out_dir: str, args: tuple) -> None:
    """The entry point of one spawned rank: join the group, run ``fn(mesh,
    *args)``, leave its return value in ``out_dir``."""
    import torch.distributed as dist

    dev = torch.device(devices[rank])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=init, rank=rank, world_size=n,
        timeout=datetime.timedelta(seconds=timeout_s))
    try:
        out = fn(make_feti_mesh(dev), *args)
        path = os.path.join(out_dir, f"rank{rank}.pkl")
        with open(path + ".tmp", "wb") as f:
            pickle.dump(out, f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(path + ".tmp", path)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn: Callable, n: int, *, backend: Optional[str] = None,
                device: Union[str, torch.device, None] = None,
                args: tuple = (), timeout: float = DEFAULT_TIMEOUT_S,
                devices: Optional[Sequence] = None) -> list:
    """Run ``fn(mesh, *args)`` on ``n`` local ranks; returns the ranks'
    return values, rank 0 first.

    ``backend`` and ``device`` choose as :func:`rank_devices` does;
    ``devices`` (one per rank) overrides its choice of devices.
    ``timeout`` is every collective's, in seconds. ``fn`` must be a
    module-level function of ``repro_torch`` (it is pickled by name).
    Raises :class:`RankFailure` when a rank fails: the others are then
    terminated.
    """
    import torch.multiprocessing as mp

    chosen, devs = rank_devices(n, backend, device)
    if devices is not None:
        if len(devices) != n:
            raise ValueError(f"{len(devices)} devices for {n} ranks")
        devs = [torch.device(d) for d in devices]
    with tempfile.TemporaryDirectory(prefix="repro_torch_ranks-") as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        try:
            mp.start_processes(
                _rank_main,
                args=(fn, n, chosen, [str(d) for d in devs], init,
                      float(timeout), tmp, tuple(args)),
                nprocs=n, join=True, start_method="spawn")
        except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
            raise RankFailure(f"rank {e.error_index} of {n} failed:\n"
                              f"{e}") from None
        out = []
        for rank in range(n):
            with open(os.path.join(tmp, f"rank{rank}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out

"""Roofline terms of the dry-run's cells and per-device constants for
ranking assembly plans (counterpart of ``repro.launch.roofline``).

:data:`HW` holds the card's data-sheet figures; :func:`roofline_terms`
turns a cell's analytic FLOP and byte counts
(:mod:`repro_torch.launch.analytic`) into its compute, memory and
collective seconds. The reference reads its collective bytes from XLA's
compiled HLO (``parse_collective_bytes``, ``collective_stats_trip_corrected``);
those parsers read XLA text and have no counterpart here. The port counts
what it sends itself: :func:`record_collectives` records every c10d
collective a block issues on this rank, by the reference's operation
names and byte convention (the result tensor's bytes of every call), and
:func:`repro_torch.launch.analytic.lm_collectives` /
``feti_collectives`` give the same schedule for a cell on a mesh of
shapes. A row without one (one card sends nothing) carries
:func:`no_collectives`: zero bytes, which :mod:`repro_torch.launch.report`
prints as "—".

The autotuner (:mod:`repro_torch.core.autotune`) feeds its FLOP and byte
models through :meth:`DeviceModel.time_s` to order candidate plans;
absolute accuracy matters only as far as the ranking does, and the
measured refinement handles the rest.

``"tpu"``, ``"gpu"`` (an A100-class card) and ``"cpu"`` are the
reference's models unchanged. ``"h100"`` is the card the port runs on:
NVIDIA H100 80GB HBM3 at its 700 W power limit, data-sheet rates. One
figure prices every dtype there. f64 runs on the FP64 tensor cores
(DMMA, 67 TFLOP/s). The f32 candidates outside the kernels (the plain
variants, cuBLAS SGEMM with TF32 off) run on FFMA, also 67 TFLOP/s; the f32
kernels' 3xTF32 products take three TF32 products each, 3 x FLOPs /
494.7 TFLOP/s, i.e. 165 TFLOP/s of f32 work, but a kernel's time is set by
its traffic and occupancy well below either peak (PERF.md §6), so the
ranking gains nothing from a second figure. bf16 stages compute at f32
(:mod:`repro_torch.core.precision`).
"""
from __future__ import annotations

import contextlib
import dataclasses
import inspect
import types
from typing import Mapping, Optional, Union

import torch

__all__ = ["HW", "CollectiveStats", "Roofline", "roofline_terms",
           "no_collectives", "record_collectives", "DeviceModel",
           "DEVICE_MODELS", "CUDA_KINDS", "detect_device"]

# One NVIDIA H100 80GB HBM3 (SXM) at its 700 W power limit, NVIDIA's data
# sheet, dense rates without sparsity. ``link_bw``: NVLink 4, 18 links of
# 25 GB/s each way (900 GB/s both ways together), one direction's sum.
# ``net_bw``: one 400 Gb/s NDR InfiniBand port a GPU (NVIDIA DGX H100 data
# sheet), the rate of a group that spans more than one 8-GPU NVLink
# domain, as every group of the production meshes does.
HW = {
    "name": "NVIDIA H100 80GB HBM3, 700 W",
    "peak_flops": 989e12,  # bf16 / fp16 tensor cores
    "peak_flops_tf32": 494.7e12,  # TF32 tensor cores
    "peak_flops_f32": 67e12,  # FFMA, outside the tensor cores
    "peak_flops_f64": 67e12,  # FP64 tensor cores (DMMA)
    "hbm_bw": 3.35e12,  # B/s
    "link_bw": 450e9,  # B/s
    "net_bw": 50e9,  # B/s
    "hbm_bytes": 80 * 2**30,  # capacity, for fit checks
}


@dataclasses.dataclass
class CollectiveStats:
    """Collective payload bytes and counts by operation name."""

    bytes_by_op: dict
    count_by_op: dict

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_op.values())

    @property
    def total_count(self) -> int:
        return sum(self.count_by_op.values())


def no_collectives() -> CollectiveStats:
    """The record of a cell that sends nothing: no bytes."""
    return CollectiveStats(bytes_by_op={}, count_by_op={})


# c10d function -> (the reference's operation name, the argument holding
# the call's result)
_C10D_OPS = {
    "all_gather": ("all-gather", "tensor_list"),
    "all_gather_into_tensor": ("all-gather", "output_tensor"),
    "all_reduce": ("all-reduce", "tensor"),
    "reduce_scatter": ("reduce-scatter", "output"),
    "reduce_scatter_tensor": ("reduce-scatter", "output"),
    "all_to_all": ("all-to-all", "output_tensor_list"),
    "all_to_all_single": ("all-to-all", "output"),
    "send": ("collective-permute", "tensor"),
    "recv": ("collective-permute", "tensor"),
    "isend": ("collective-permute", "tensor"),
    "irecv": ("collective-permute", "tensor"),
}
_RECORDERS: list = []  # the active recorders' stats, innermost last
_ORIGINALS: dict = {}  # c10d function name -> the unwrapped function


def _nbytes(x) -> int:
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(t) for t in x)
    return x.numel() * x.element_size()


def _counting(name: str, fn):
    op, result = _C10D_OPS[name]
    sig = inspect.signature(fn)

    def call(*args, **kwargs):
        nbytes = _nbytes(sig.bind(*args, **kwargs).arguments[result])
        for stats in _RECORDERS:
            stats.bytes_by_op[op] = stats.bytes_by_op.get(op, 0) + nbytes
            stats.count_by_op[op] = stats.count_by_op.get(op, 0) + 1
        return fn(*args, **kwargs)

    return call


@contextlib.contextmanager
def record_collectives():
    """Count every c10d collective the block issues on this rank: yields a
    :class:`CollectiveStats` that fills in as the calls are made, keyed by
    the reference's operation names (``all-gather``, ``all-reduce``,
    ``reduce-scatter``, ``all-to-all``, ``collective-permute`` for
    point-to-point sends and receives), each call's bytes those of its
    result tensor(s), every call counted (the reference's trip-corrected
    convention). The ``torch.distributed`` functions are wrapped while any
    recorder is open; blocks nest, each outer one counting the inner
    block's calls too. Calls made below c10d's Python functions (DTensor's
    functional collectives) are not seen: the port issues none."""
    import torch.distributed as dist

    stats = CollectiveStats(bytes_by_op={}, count_by_op={})
    if not _RECORDERS:
        for name in _C10D_OPS:
            _ORIGINALS[name] = getattr(dist, name)
            setattr(dist, name, _counting(name, _ORIGINALS[name]))
    _RECORDERS.append(stats)
    try:
        yield stats
    finally:
        _RECORDERS[:] = [r for r in _RECORDERS if r is not stats]
        if not _RECORDERS:
            for name, fn in _ORIGINALS.items():
                setattr(dist, name, fn)
            _ORIGINALS.clear()


@dataclasses.dataclass
class Roofline:
    flops_per_dev: float
    bytes_per_dev: float
    coll_bytes_per_dev: float
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: Optional[float] = None
    useful_ratio: Optional[float] = None  # MODEL_FLOPS / (FLOPs * chips)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def roofline_terms(cost: dict, coll: CollectiveStats, chips: int,
                   model_flops: Optional[float] = None,
                   link_bw: float = HW["link_bw"]) -> Roofline:
    """The three terms of one cell: ``cost["flops"]`` / peak,
    ``cost["bytes accessed"]`` / HBM rate (both per device, from the
    analytic counts) and the collective bytes / ``link_bw``; the largest
    is the dominant one."""
    flops = float(cost.get("flops", 0.0))
    bytes_ = float(cost.get("bytes accessed", 0.0))
    cb = float(coll.total_bytes)
    compute_s = flops / HW["peak_flops"]
    memory_s = bytes_ / HW["hbm_bw"]
    collective_s = cb / link_bw
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    useful = None
    if model_flops:
        useful = model_flops / max(flops * chips, 1.0)
    return Roofline(
        flops_per_dev=flops,
        bytes_per_dev=bytes_,
        coll_bytes_per_dev=cb,
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        dominant=dominant,
        model_flops=model_flops,
        useful_ratio=useful,
    )


@dataclasses.dataclass(frozen=True)
class DeviceModel:
    """Per-device roofline constants for *ranking* kernel schedules.

    Attributes:
      kind: "tpu" | "gpu" | "h100" | "cpu".
      peak_flops: sustained f64 FLOP/s (the default dtype's regime).
      mem_bw: main-memory bandwidth, B/s.
      overhead_s: per-dispatched-op launch/dispatch overhead. This is the
        term that penalizes tiny block sizes (many small ops) and rewards
        fused single-launch schedules.
      peak_flops_by_dtype: sustained FLOP/s per stage dtype name ("f64" |
        "f32" | "bf16"); missing entries fall back to ``peak_flops``.
    """

    kind: str
    name: str
    peak_flops: float
    mem_bw: float
    overhead_s: float = 5e-6
    peak_flops_by_dtype: Optional[Mapping[str, float]] = None

    def peak(self, dtype: str = "f64") -> float:
        """Sustained FLOP/s for a stage dtype name; unknown names fall
        back to the f64 figure."""
        if self.peak_flops_by_dtype is None:
            return self.peak_flops
        return self.peak_flops_by_dtype.get(dtype, self.peak_flops)

    def time_s(self, flops: float, bytes_: float, n_ops: int = 1,
               dtype: str = "f64") -> float:
        """Roofline execution-time estimate: max(compute, memory) + launches."""
        return max(flops / self.peak(dtype), bytes_ / self.mem_bw) \
            + n_ops * self.overhead_s


def _freeze(d: dict) -> Mapping[str, float]:
    return types.MappingProxyType(dict(d))


# the reference's TPU v5e HBM bandwidth (its roofline.HW["hbm_bw"])
_TPU_HBM_BW = 819e9
_TPU_BF16_PEAK = 197e12

DEVICE_MODELS = {
    # the reference's models, unchanged (the tests compare scores)
    "tpu": DeviceModel("tpu", "tpu-v5e-f64", peak_flops=1.0e12,
                       mem_bw=_TPU_HBM_BW, overhead_s=2e-6,
                       peak_flops_by_dtype=_freeze(
                           {"f64": 1.0e12, "f32": 98.5e12,
                            "bf16": _TPU_BF16_PEAK})),
    "gpu": DeviceModel("gpu", "a100-f64", peak_flops=9.7e12,
                       mem_bw=1.55e12, overhead_s=5e-6,
                       peak_flops_by_dtype=_freeze(
                           {"f64": 9.7e12, "f32": 19.5e12,
                            "bf16": 156e12})),
    "cpu": DeviceModel("cpu", "host-f64", peak_flops=5.0e10,
                       mem_bw=2.0e10, overhead_s=10e-6,
                       peak_flops_by_dtype=_freeze(
                           {"f64": 5.0e10, "f32": 1.0e11,
                            "bf16": 1.0e11})),
    # NVIDIA H100 80GB HBM3, 700 W (see the module note). overhead_s: the
    # median host-to-completion time of one small launch through a kernel
    # wrapper (the stepped SYRK on one 8 x 8 tile, then a synchronize),
    # 31.11 us over 200 launches, measured by chip_smoke.py's autotune
    # phase on that card at 700 W
    "h100": DeviceModel("h100", "h100-f64", peak_flops=67e12,
                        mem_bw=3.35e12, overhead_s=31.11e-6,
                        peak_flops_by_dtype=_freeze(
                            {"f64": 67e12, "f32": 67e12, "bf16": 67e12})),
}

# the kinds whose kernel candidates are the port's CUDA kernels
CUDA_KINDS = ("gpu", "h100")


def detect_device(device: Union[str, torch.device]) -> DeviceModel:
    """The :class:`DeviceModel` of a torch device (the one the config
    resolved): a CUDA card whose name holds "H100" is ``"h100"``, another
    CUDA card ``"gpu"``, anything else the CPU model. Availability is the
    caller's to check (:func:`repro_torch.device.resolve_device`)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        name = torch.cuda.get_device_name(dev)
        return DEVICE_MODELS["h100" if "H100" in name else "gpu"]
    return DEVICE_MODELS["cpu"]

"""Device mesh and its sum over shards, multi-process start-up, `auto_solver`.

Counterpart of `linearsfm_tpu/parallel/mesh.py`. The reference mesh is
single-controller: one process, a `jax.sharding.Mesh` of devices, and
`shard_map` inside one jitted program. The port keeps that shape:

* a `Mesh` is a tuple of torch devices along one named axis, driven from
  one process; shard d's tensors live on ``devices[d]`` and its kernels
  launch there;
* `Mesh.psum` is an explicit sum of the shards' partials, taken in shard
  order on ``devices[0]``, so every run adds them in the same order;
* a device may repeat: ``Mesh(("cuda:0",) * 4)`` runs the real four-way
  sharded arithmetic on one card, and ``Mesh(("cpu",) * k)`` on the CPU.

Topology policy (the reference's): tree levels with many pairs run
map-parallel over a ``pairs`` axis; the root-style joins shard the feature
axis (``fs``) and sum the partial reduced camera systems; across
processes, each owns a contiguous span of maps and only the block roots
move (`parallel/multihost.py`, over `torch.distributed` with gloo).
"""

from __future__ import annotations

import contextlib

import torch


class Mesh:
    """Devices along one named axis (``pairs`` or ``fs``); ``size`` shards.

    devices: anything `torch.device` accepts; a CUDA device without an
    index is the current one."""

    def __init__(self, devices, axis: str = "pairs"):
        self.devices = tuple(canonical(d) for d in devices)
        if not self.devices:
            raise ValueError("Mesh: no devices")
        self.axis = axis

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self):
        return f"Mesh({[str(d) for d in self.devices]}, {self.axis!r})"

    def on(self, d: int):
        """Context for shard d's work: its CUDA device is current (the
        kernels launch on the current device), a no-op on the CPU."""
        dev = self.devices[d]
        return (torch.cuda.device(dev) if dev.type == "cuda"
                else contextlib.nullcontext())

    def psum(self, parts) -> torch.Tensor:
        """Sum of the shards' partials (an iterable, shard order) on
        ``devices[0]``: ((p0 + p1) + p2) + ... . Each part may be freed as
        soon as it is added."""
        total = None
        for p in parts:
            p = p.to(self.devices[0])
            total = p if total is None else total + p
        return total


def canonical(dev) -> torch.device:
    """torch.device with an explicit index for CUDA."""
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def solver_device(device, who: str) -> torch.device:
    """`device` of an entry point, `canonical`; a CUDA device with no CUDA
    raises (nothing falls back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who}: no CUDA device; pass device=\"cpu\" to "
                           f"solve on the CPU")
    return canonical(device)


def feature_window(N: int, nd: int) -> int:
    """Features per shard, Nl = ceil(N / nd): shard d owns [d Nl, d Nl + Nl)."""
    return (N + nd - 1) // nd


def _cuda_devices(n: int | None, who: str) -> list[torch.device]:
    if not torch.cuda.is_available():
        raise RuntimeError(f"{who}: no CUDA device; build an explicit "
                           f"Mesh(devices, axis) for another device")
    count = torch.cuda.device_count()
    n = count if n is None else min(n, count)
    return [torch.device("cuda", i) for i in range(n)]


def pairs_mesh(n: int | None = None) -> Mesh:
    """The first n CUDA cards (all by default) along the ``pairs`` axis."""
    return Mesh(_cuda_devices(n, "pairs_mesh"), "pairs")


def fs_mesh(n: int | None = None) -> Mesh:
    """The first n CUDA cards (all by default) along the ``fs`` axis."""
    return Mesh(_cuda_devices(n, "fs_mesh"), "fs")


def init_multihost(coordinator_address: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None) -> None:
    """Join the process group (gloo, over TCP at coordinator_address,
    "host:port"); nothing to do for a single process."""
    if num_processes is None or num_processes <= 1:
        return
    import torch.distributed as dist
    addr = coordinator_address
    if not addr.startswith("tcp://"):
        addr = "tcp://" + addr
    dist.init_process_group("gloo", init_method=addr,
                            world_size=num_processes, rank=process_id)


def auto_solver(datatype: str, use_mesh: bool = True,
                executor: str = "device", *, device="cuda", **kw):
    """The production solver on `device`, with a mesh over every CUDA card
    when there is more than one.

    executor "device" (default): `DeviceTreeSolver`, one mesh for its
    per-level modes (dp levels over the pairs, the tp root over the
    features). executor "host": `TreeSolver` with a pairs mesh and an fs
    root mesh. A CUDA device without CUDA raises.
    """
    device = torch.device(device)
    ndev = 1
    if device.type == "cuda":
        ndev = len(_cuda_devices(None, "auto_solver"))
    device = canonical(device)
    multi = use_mesh and ndev > 1
    if executor == "host":
        from ..core.tree import TreeSolver
        if multi:
            kw.setdefault("mesh", pairs_mesh())
            kw.setdefault("root_mesh", fs_mesh())
        return TreeSolver(datatype, device=device, **kw)
    from ..core.device_tree import DeviceTreeSolver
    if multi:
        kw.setdefault("mesh", pairs_mesh())
    return DeviceTreeSolver(datatype, device=device, **kw)

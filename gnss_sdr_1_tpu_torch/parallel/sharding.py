"""Meshes of torch devices and the trees sharded over them.

The JAX package shards arrays over a `jax.sharding.Mesh` and lets XLA place
the collectives (`gnss_sdr_1_tpu/parallel/sharding.py`).  Here, as there,
one process drives its local devices and a process group joins hosts; the
data layout is explicit instead:

* a mesh is an array of torch devices with axis names (`Mesh`);
* a channel-sharded tree is one tree per mesh entry (`ChannelShards`), each
  holding a contiguous block of channels on its entry's device; leaves
  whose leading axis does not divide by the mesh size are replicated;
* a replicated tensor is one tensor per mesh entry, copied once to each
  distinct device;
* time blocks are one tensor per mesh entry, joined by
  `halo_exchange_blocks`.

Channels are independent until observables fan in on the host, so the
channel-sharded engine (`parallel.sharded`) runs each shard on its own
device with no copy between devices and no collective in its hot loop.
A mesh may name the CPU, or one device several times (logical shards).
"""

from __future__ import annotations

import os

import numpy as np
import torch


class Mesh:
    """An array of torch devices with one name per axis (the JAX `Mesh`).

    `process_index` is the row of the 'host' axis this process drives (0
    on a single host); only that row's devices are addressable here."""

    def __init__(self, devices, axis_names: tuple[str, ...],
                 process_index: int = 0):
        arr = np.asarray(devices, dtype=object)
        if arr.ndim != len(axis_names):
            raise ValueError(f"{arr.ndim}-D device array for axes "
                             f"{axis_names}")
        self.devices = arr
        self.axis_names = tuple(axis_names)
        self.process_index = int(process_index)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def local_devices(self) -> list[torch.device]:
        """This process's devices, in mesh order."""
        if self.axis_names[0] == "host":
            return list(self.devices[self.process_index].ravel())
        return list(self.devices.ravel())


def _explicit(device) -> torch.device:
    """`device` as an explicit torch device: a bare 'cuda' becomes the
    current CUDA device's index, and a CUDA device without a GPU raises."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(f"mesh names {dev} but no CUDA device is "
                           f"available; name 'cpu' to build a mesh on the "
                           f"CPU explicitly")
    index = torch.cuda.current_device() if dev.index is None else dev.index
    if not 0 <= index < torch.cuda.device_count():
        raise ValueError(f"cuda:{index} does not exist "
                         f"({torch.cuda.device_count()} visible)")
    return torch.device("cuda", index)


def _mesh_devices(n_devices: int | None, devices) -> list[torch.device]:
    if devices is not None:
        devs = [_explicit(d) for d in devices]
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass devices="
                               "['cpu', ...] to build a mesh on the CPU "
                               "explicitly")
        count = torch.cuda.device_count()
        n = n_devices or count
        if n > count:
            raise ValueError(f"{n} devices asked for, {count} visible")
        devs = [torch.device("cuda", i) for i in range(n)]
    if not devs:
        raise ValueError("a mesh needs at least one device")
    return devs


def channel_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D mesh over the 'channel' axis: the first `n_devices` visible CUDA
    devices (all of them by default; raises without a GPU), or `devices`
    as given (the CPU, or one device named several times, included)."""
    return Mesh(_mesh_devices(n_devices, devices), ("channel",))


def time_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D mesh over the 'time' axis (sequence-parallel sample blocks)."""
    return Mesh(_mesh_devices(n_devices, devices), ("time",))


# ---------------------------------------------------------------- trees --


def _tree_map(fn, tree, *rest):
    """fn over the leaves of `tree` (and the matching leaves of `rest`),
    through NamedTuples, tuples, lists and dicts."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, *kids)
                            for kids in zip(tree, *rest)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, *kids) for kids in zip(tree, *rest))
    if isinstance(tree, dict):
        return {k: _tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


def _is_array(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray))


def _put(x, device: torch.device):
    """An array leaf as a tensor on `device`; other leaves unchanged."""
    if isinstance(x, np.ndarray):
        x = torch.as_tensor(np.ascontiguousarray(x))
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return x


class ChannelShards:
    """A tree sharded over the channel axes of a mesh: `shards[j]` is the
    tree of this process's j-th mesh device, `split` the tree of flags of
    the leaves cut into channel blocks (the others are replicated)."""

    def __init__(self, shards: list, mesh: Mesh, split):
        self.shards = list(shards)
        self.mesh = mesh
        self.split = split

    def __len__(self) -> int:
        return len(self.shards)

    def __getitem__(self, j):
        return self.shards[j]

    def __iter__(self):
        return iter(self.shards)

    def replace(self, shards: list) -> "ChannelShards":
        """The same layout holding other per-device trees."""
        return ChannelShards(shards, self.mesh, self.split)


def _shard(tree, mesh: Mesh, n_blocks: int, first_block: int):
    devs = mesh.local_devices()

    def is_split(x):
        return _is_array(x) and x.ndim >= 1 and x.shape[0] % n_blocks == 0

    def block(x, j):
        if not is_split(x):
            return _put(x, devs[j])
        n = x.shape[0] // n_blocks
        b = first_block + j
        return _put(x[b * n:(b + 1) * n], devs[j])

    shards = [_tree_map(lambda x, j=j: block(x, j), tree)
              for j in range(len(devs))]
    return ChannelShards(shards, mesh, _tree_map(is_split, tree))


def shard_channel_tree(tree, mesh: Mesh) -> ChannelShards:
    """Shard every array leaf along its leading (channel) axis into
    contiguous blocks, one per mesh entry, each on its entry's device;
    leaves not divisible by the mesh size (and non-array leaves) are
    replicated."""
    return _shard(tree, mesh, mesh.shape["channel"], 0)


def gather_channel_tree(sharded: ChannelShards, device="cpu"):
    """The inverse of shard_channel_tree (of this process's shards): the
    channel blocks concatenated in mesh order on `device`, a replicated
    leaf taken from the first shard."""
    dev = torch.device(device)

    def join(flag, *leaves):
        if flag:
            return torch.cat([leaf.to(dev) for leaf in leaves])
        return _put(leaves[0], dev)

    return _tree_map(join, sharded.split, *sharded.shards)


def replicate(x, mesh: Mesh) -> list[torch.Tensor]:
    """`x` on every mesh entry of this process: one pinned host copy, then
    a non_blocking copy to each distinct device (entries naming the same
    device share its copy)."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(
        np.ascontiguousarray(x))
    devs = mesh.local_devices()
    if t.device.type == "cpu" and any(d.type == "cuda" for d in devs):
        t = t.pin_memory()
    copies: dict[torch.device, torch.Tensor] = {}
    for d in devs:
        if d not in copies:
            copies[d] = t.to(d, non_blocking=True)
    return [copies[d] for d in devs]


def halo_exchange_blocks(blocks, halo: int) -> list[torch.Tensor]:
    """Append the first `halo` samples of the NEXT block to each block
    (the overlap-save tail), so per-device convolution windows are exact
    at the seams: block j [L_j] becomes [L_j + halo] on its own device.
    The last block wraps to the first's head, as in the JAX package
    (callers zero it or ignore the final tail)."""
    blocks = [b if isinstance(b, torch.Tensor) else torch.as_tensor(b)
              for b in blocks]
    if any(b.shape[0] < halo for b in blocks):
        raise ValueError(f"every block must hold >= {halo} samples")
    n = len(blocks)
    return [torch.cat([b, blocks[(j + 1) % n][:halo].to(
        b.device, non_blocking=True)]) for j, b in enumerate(blocks)]


# ------------------------------------------ multi-host (torch.distributed) --


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> bool:
    """Join this process to a multi-host run (torch.distributed).

    Called once per host before any device use.  Arguments default from
    the standard environment: `coordinator` 'host:port' from MASTER_ADDR
    and MASTER_PORT, `num_processes` from WORLD_SIZE, `process_id` from
    RANK.  Returns False when neither a coordinator nor a world size is
    configured (the single-host case: callers go on with the local
    devices), True once the process group is up.  A world size without a
    coordinator, or without this process's rank, raises: a run asked for
    on several processes never goes on as one.  The backend is NCCL where
    a GPU is visible, gloo on the CPU."""
    import datetime

    import torch.distributed as dist

    env = os.environ
    if coordinator is None and env.get("MASTER_ADDR") and \
            env.get("MASTER_PORT"):
        coordinator = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None and env.get("WORLD_SIZE"):
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and env.get("RANK"):
        process_id = int(env["RANK"])
    if coordinator is None and num_processes is None:
        return False
    if coordinator is None:
        raise ValueError(f"a run of {num_processes} processes needs a "
                         f"coordinator: MASTER_ADDR and MASTER_PORT, or "
                         f"coordinator='host:port'")
    if num_processes is None or process_id is None:
        raise ValueError(f"a run coordinated at {coordinator} needs its "
                         f"world size and this process's rank (WORLD_SIZE "
                         f"and RANK, or num_processes and process_id)")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"rank {process_id} outside a world of "
                         f"{num_processes}")
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(minutes=5))
    return True


def host_channel_mesh(local_devices=None) -> Mesh:
    """('host', 'channel') mesh over every process's devices: one row per
    rank of the process group (one row without one), each row the local
    devices, which every host is taken to have alike: every visible CUDA
    device by default (raises without a GPU), or `local_devices` as given.
    Channels shard across hosts first, then across each host's devices."""
    import torch.distributed as dist

    local = _mesh_devices(None, local_devices)
    n_proc, rank = 1, 0
    if dist.is_available() and dist.is_initialized():
        n_proc, rank = dist.get_world_size(), dist.get_rank()
    rows = np.empty((n_proc, len(local)), dtype=object)
    for r in range(n_proc):
        for j, d in enumerate(local):
            rows[r, j] = d
    return Mesh(rows, ("host", "channel"), process_index=rank)


def shard_host_channel_tree(tree, mesh: Mesh) -> ChannelShards:
    """Shard leading (channel) axes over both mesh axes flattened: rank r
    holds blocks r * L .. r * L + L - 1 of host x L local devices, one on
    each of its devices, so the channels split over ranks first.  Each
    process holds only its own shards (the JAX `addressable_shards`);
    leaves not divisible by the mesh size are replicated."""
    hosts, local = mesh.shape["host"], mesh.shape["channel"]
    return _shard(tree, mesh, hosts * local, mesh.process_index * local)


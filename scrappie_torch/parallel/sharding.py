"""Device mesh and sharding helpers.

Counterpart of scrappie_tpu/parallel/sharding.py. The models are small
(about 1 MB), so their weights are replicated; chunk batches are
data-parallel over the mesh's 'data' axis; the widest product (hidden ->
1025-state output) can also be split over 'state' along its contraction
axis, each state device computing a partial product that is summed onto
its data device (what XLA's psum does for the JAX package).

A `Mesh` is a grid of torch.devices, [n_data, n_state]. A device may
appear more than once (["cpu"] * 8, ["cuda:0"] * 2): each position still
gets its own replica and its own slice of every batch, so a mesh can be
checked on one card or on the CPU. There are no implicit collectives:
`split_rows` / `gather_rows` move batch slices, and `shard_params` places
the split weight as nn/layers.StateShards, whose product
(nn/layers.state_matmul) sums the partials in a fixed order and hands the
layer below the full gradient.
"""

from __future__ import annotations

import numpy as np
import torch

from scrappie_torch.device import as_device
from scrappie_torch.models import registry
from scrappie_torch.models.forward import Network, load_model, network_of
from scrappie_torch.nn.layers import StateShards

#: The parameters split over 'state' where the engine and the trainer ask
#: for it (the output layer of every basecaller), as in the JAX package.
STATE_SHARD_KEYS = ("FF_W", "FF3_W")


def _normalised(device) -> torch.device:
    """A device with its index: a bare "cuda" means the current card."""
    dev = as_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """Devices in a [data, state] grid (JAX's Mesh(devices, ("data",
    "state")))."""

    axis_names = ("data", "state")

    def __init__(self, devices):
        grid = np.empty((len(devices), len(devices[0])), dtype=object)
        for d, row in enumerate(devices):
            if len(row) != grid.shape[1]:
                raise ValueError("mesh rows differ in length")
            for s, dev in enumerate(row):
                grid[d, s] = _normalised(dev)
        self.devices = grid

    @property
    def shape(self) -> dict[str, int]:
        return {"data": self.devices.shape[0], "state": self.devices.shape[1]}

    @property
    def size(self) -> int:
        return self.devices.size

    @property
    def data_devices(self) -> list[torch.device]:
        """The device of each data row (its state position 0): where its
        replica's activations live."""
        return list(self.devices[:, 0])

    @property
    def device_type(self) -> str:
        types = {d.type for d in self.devices.flat}
        if len(types) != 1:
            raise ValueError(f"a mesh mixes device types {sorted(types)}")
        return types.pop()

    def __repr__(self) -> str:
        rows = [[str(d) for d in row] for row in self.devices]
        return f"Mesh({self.shape}, {rows})"


def make_mesh(n_data: int | None = None, n_state: int = 1, devices=None) -> Mesh:
    """A [n_data, n_state] mesh over `devices` (default: every visible
    CUDA device; without CUDA this raises, as device.as_device does). The
    first n_data * n_state devices are used, row by row; n_data defaults to
    all of them. Asking for more devices than there are raises, and so does
    a device count that n_state does not divide: the mesh never shrinks
    quietly."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh() spans the visible CUDA devices, but "
                "torch.cuda.is_available() is False; pass devices=['cpu', "
                "...] for a mesh of plain PyTorch twins")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [_normalised(d) for d in devices]
    if n_state < 1:
        raise ValueError(f"n_state must be at least 1, not {n_state}")
    if n_data is None:
        if len(devices) % n_state:
            raise ValueError(f"{len(devices)} devices do not divide into "
                             f"rows of n_state={n_state}")
        n_data = len(devices) // n_state
    if n_data < 1:
        raise ValueError(f"n_data must be at least 1, not {n_data}")
    if n_data * n_state > len(devices):
        raise ValueError(f"a {n_data} x {n_state} mesh needs "
                         f"{n_data * n_state} devices; {len(devices)} given")
    flat = devices[: n_data * n_state]
    return Mesh([flat[d * n_state:(d + 1) * n_state] for d in range(n_data)])


def resolve_mesh(device=None, mesh: Mesh | None = None) -> Mesh:
    """The mesh of an entry point: `mesh` as given, a one-device mesh of
    `device`, or, with neither, every visible card (make_mesh())."""
    if mesh is not None and device is not None:
        raise ValueError("pass device= or mesh=, not both")
    if mesh is not None:
        if not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a sharding.Mesh, not "
                            f"{type(mesh).__name__}")
        return mesh
    if device is not None:
        return make_mesh(devices=[device])
    return make_mesh()


def round_batch(batch_size: int, mesh: Mesh) -> int:
    """batch_size rounded up to a multiple of the data axis."""
    n = mesh.shape["data"]
    return -(-int(batch_size) // n) * n


# ----------------------------------------------------------------- weights


def _place(v, device: torch.device) -> torch.Tensor:
    """A float32 copy of an array or tensor on `device`, contiguous; a
    normal tensor also under torch.inference_mode (as
    models/convert.params_from_numpy)."""
    with torch.inference_mode(False):
        if isinstance(v, torch.Tensor):
            return v.detach().to(device=device, dtype=torch.float32, copy=True,
                                 memory_format=torch.contiguous_format)
        return torch.tensor(np.ascontiguousarray(v, dtype=np.float32),
                            device=device)


def state_split(v, mesh: Mesh) -> bool:
    """JAX's condition for splitting a listed parameter over 'state':
    2-D, state > 1, and its first axis divisible by state."""
    S = mesh.shape["state"]
    return np.ndim(v) == 2 and S > 1 and np.shape(v)[0] % S == 0


def shard_params(params: dict, mesh: Mesh, state_shard_keys=(),
                 full: bool = True) -> list[dict]:
    """Place parameters (a dict of numpy arrays, the registry's, or of
    tensors): one replica for each data row, on its data device; a listed
    2-D key whose first (contraction) axis `state` divides becomes
    StateShards over the row's state devices (with the whole weight on the
    data device too, unless full=False). Returns the rows' dicts."""
    S = mesh.shape["state"]
    out = []
    for row in mesh.devices:
        placed = {}
        for k, v in params.items():
            if k in state_shard_keys and state_split(v, mesh):
                n = np.shape(v)[0] // S
                placed[k] = StateShards(
                    [_place(v[s * n:(s + 1) * n], row[s]) for s in range(S)],
                    _place(v, row[0]) if full else None)
            else:
                placed[k] = _place(v, row[0])
        out.append(placed)
    return out


def load_replicas(model: str, mesh: Mesh, state_shard_keys=STATE_SHARD_KEYS
                  ) -> list[Network]:
    """The named basecaller placed on a mesh: one replica on each data
    device, its output layer's weight also split over the row's state
    devices where shard_params splits it (Network.state_shards). A
    one-device mesh gives load_model's network."""
    if mesh.size == 1:
        return [load_model(model, mesh.devices[0, 0])]
    nets = []
    for placed in shard_params(registry.load_params(model), mesh,
                               state_shard_keys):
        net = network_of(model, {k: v.full if isinstance(v, StateShards)
                                 else v for k, v in placed.items()})
        net.state_shards = {k: v for k, v in placed.items()
                            if isinstance(v, StateShards)}
        nets.append(net)
    return nets


# ----------------------------------------------------------------- batches


def batch_slices(n: int, n_data: int) -> list[tuple[int, int]]:
    """Contiguous row ranges of a batch of n rows over n_data devices (the
    counterpart of batch_sharding): equal slices of ceil(n / n_data) rows,
    the last ones shorter; empty ranges are left out, so a short batch
    uses fewer devices."""
    per = -(-n // n_data) if n else 0
    return [(lo, min(lo + per, n)) for lo in range(0, n, per)] if per else []


def split_rows(x, devices) -> list[tuple[int, torch.Tensor]]:
    """Rows of x (numpy or a tensor) in contiguous slices, one on each
    device that gets rows: [(data index, slice on its device)]."""
    out = []
    for d, (lo, hi) in enumerate(batch_slices(len(x), len(devices))):
        part = x[lo:hi]
        if isinstance(part, torch.Tensor):
            part = part.to(devices[d])
        else:
            part = torch.as_tensor(np.ascontiguousarray(part),
                                   device=devices[d])
        out.append((d, part))
    return out


def gather_rows(parts, device) -> torch.Tensor:
    """Tensors of row slices -> one tensor on `device`, in order: each
    part is copied once."""
    parts = [p.to(device) for p in parts]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)

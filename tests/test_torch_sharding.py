"""scrappie_torch/parallel/sharding.py on the CPU: the mesh, the placement
of parameters against scrappie_tpu's shard_params on its 8-device virtual
mesh (tests/conftest.py), batch slices, and the row-parallel product
over 'state' (forward and backward) against the plain product.

A mesh of the port may repeat a device (["cpu"] * 8), as the JAX
package's virtual mesh repeats the host; each position keeps its own
replica and batch slice. Placement is exact (the same numbers, copied);
the row-parallel product sums two partial products, so it is held to
the whole product within 1e-6 relative to its largest entry (float32
sums in another order)."""

import numpy as np
import pytest
import torch

from scrappie_torch.nn import layers as tl
from scrappie_torch.parallel import sharding as ts
from scrappie_tpu.models import registry
from scrappie_tpu.parallel import sharding as js

torch.set_num_threads(1)
SPLIT_RTOL = 1e-6


def test_mesh_shape_and_placement():
    mesh = ts.make_mesh(2, 2, devices=["cpu"] * 4)
    assert mesh.shape == {"data": 2, "state": 2}
    assert mesh.axis_names == ("data", "state")
    assert mesh.size == 4 and mesh.device_type == "cpu"
    assert mesh.devices.shape == (2, 2)
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)
    assert ts.make_mesh(devices=["cpu"] * 3).shape == {"data": 3, "state": 1}
    # the first n_data * n_state devices, row by row, as JAX takes them
    assert ts.make_mesh(1, 2, devices=["cpu"] * 8).shape == {"data": 1,
                                                             "state": 2}
    assert ts.round_batch(5, mesh) == 6 and ts.round_batch(4, mesh) == 4


@pytest.mark.parametrize("args,kw", [
    ((3, 2), dict(devices=["cpu"] * 4)),      # more devices than there are
    ((None, 3), dict(devices=["cpu"] * 4)),   # 3 does not divide 4
    ((0, 1), dict(devices=["cpu"])),
])
def test_make_mesh_never_shrinks_quietly(args, kw):
    with pytest.raises(ValueError):
        ts.make_mesh(*args, **kw)


def test_default_mesh_spans_the_cards_or_raises():
    if torch.cuda.is_available():
        mesh = ts.make_mesh()
        assert mesh.size == torch.cuda.device_count()
        return
    with pytest.raises(RuntimeError, match="cuda"):
        ts.make_mesh()
    with pytest.raises(RuntimeError, match="cuda"):
        ts.resolve_mesh()


def test_resolve_mesh():
    mesh = ts.make_mesh(devices=["cpu"] * 2)
    assert ts.resolve_mesh(mesh=mesh) is mesh
    one = ts.resolve_mesh("cpu")
    assert one.shape == {"data": 1, "state": 1}
    with pytest.raises(ValueError, match="not both"):
        ts.resolve_mesh("cpu", mesh)
    with pytest.raises(TypeError):
        ts.resolve_mesh(mesh=object())


@pytest.mark.parametrize("model", ["rgrgr_r94", "raw_r94", "rnnrf_r94",
                                   "nanonet_events"])
def test_shard_params_equal_jax_addressable_shards(model):
    """On a 4 x 2 mesh, each data row's replica and state slices equal the
    addressable shards of JAX's shard_params on the virtual mesh's
    devices at the same positions."""
    params = registry.load_params(model)
    keys = ("FF_W", "FF3_W")
    jmesh = js.make_mesh(n_state=2)
    assert jmesh.devices.shape == (4, 2)
    jplaced = js.shard_params(params, jmesh, state_shard_keys=keys)
    mesh = ts.make_mesh(4, 2, devices=["cpu"] * 8)
    rows = ts.shard_params(params, mesh, state_shard_keys=keys)
    assert len(rows) == 4
    split = 0
    for k, v in params.items():
        shards = {s.device: np.asarray(s.data)
                  for s in jplaced[k].addressable_shards}
        for d in range(4):
            got = rows[d][k]
            if isinstance(got, ts.StateShards):
                split += 1
                assert got.bounds == ((0, 48), (48, 96))
                np.testing.assert_array_equal(got.full.numpy(), v)
                for s in range(2):
                    np.testing.assert_array_equal(
                        got.shards[s].numpy(), shards[jmesh.devices[d, s]])
            else:
                for s in range(2):
                    np.testing.assert_array_equal(
                        got.numpy(), shards[jmesh.devices[d, s]])
    assert split == 4  # the output layer's weight, on every row


def test_shard_params_replicates_without_a_state_axis():
    params = registry.load_params("rgrgr_r94")
    rows = ts.shard_params(params, ts.make_mesh(devices=["cpu"] * 2),
                           state_shard_keys=ts.STATE_SHARD_KEYS)
    for row in rows:
        assert not any(isinstance(v, ts.StateShards) for v in row.values())
    # two replicas, not one tensor twice
    assert rows[0]["FF_W"].data_ptr() != rows[1]["FF_W"].data_ptr()
    # JAX's condition: 2-D and divisible by 'state'
    odd = {"FF_W": np.ones((5, 3), np.float32), "FF_b": np.ones(3, np.float32)}
    rows = ts.shard_params(odd, ts.make_mesh(1, 2, devices=["cpu"] * 2),
                           state_shard_keys=("FF_W", "FF_b"))
    assert not any(isinstance(v, ts.StateShards) for v in rows[0].values())


@pytest.mark.parametrize("n,n_data,want", [
    (8, 2, [(0, 4), (4, 8)]), (5, 2, [(0, 3), (3, 5)]), (1, 4, [(0, 1)]),
    (7, 4, [(0, 2), (2, 4), (4, 6), (6, 7)]), (0, 2, []),
])
def test_batch_slices(n, n_data, want):
    assert ts.batch_slices(n, n_data) == want


def test_split_and_gather_rows():
    x = np.arange(30, dtype=np.float32).reshape(10, 3)
    parts = ts.split_rows(x, [torch.device("cpu")] * 3)
    assert [d for d, _ in parts] == [0, 1, 2]
    assert [len(p) for _, p in parts] == [4, 4, 2]
    np.testing.assert_array_equal(
        ts.gather_rows([p for _, p in parts], "cpu").numpy(), x)
    t = torch.from_numpy(x)
    assert torch.equal(ts.gather_rows([p for _, p in ts.split_rows(
        t, [torch.device("cpu")] * 2)], "cpu"), t)


@pytest.mark.parametrize("n_state", [2, 3])
def test_row_parallel_product_and_its_gradient(n_state):
    """feedforward with StateShards equals x @ W + b, and its backward
    gives x the full gradient and each shard its rows of W's."""
    rng = np.random.default_rng(n_state)
    x = rng.standard_normal((7, 3, 96)).astype(np.float32)
    W = rng.standard_normal((96, 41)).astype(np.float32)
    b = rng.standard_normal(41).astype(np.float32)
    g = rng.standard_normal((7, 3, 41)).astype(np.float32)
    mesh = ts.make_mesh(1, n_state, devices=["cpu"] * n_state)
    placed = ts.shard_params({"FF_W": W}, mesh, ("FF_W",), full=False)[0]
    w = placed["FF_W"]
    assert w.full is None and len(w.shards) == n_state
    for t in w.shards:
        t.requires_grad_(True)
    xs = torch.tensor(x, requires_grad=True)
    y = tl.feedforward(xs, w, torch.tensor(b))
    (y * torch.tensor(g)).sum().backward()

    xw = torch.tensor(x, requires_grad=True)
    Ww = torch.tensor(W, requires_grad=True)
    want = tl.feedforward(xw, Ww, torch.tensor(b))
    (want * torch.tensor(g)).sum().backward()

    def close(a, c):
        np.testing.assert_allclose(a, c, rtol=0,
                                   atol=SPLIT_RTOL * np.abs(c).max())

    close(y.detach().numpy(), want.detach().numpy())
    close(xs.grad.numpy(), xw.grad.numpy())
    close(torch.cat([t.grad for t in w.shards]).numpy(), Ww.grad.numpy())
    with torch.inference_mode():
        close(tl.feedforward(torch.tensor(x), w, torch.tensor(b)).numpy(),
              want.detach().numpy())

"""train(mesh=) on the CPU: data-parallel training over a (2, 1) mesh
(["cpu"] * 2) and a (2, 2) mesh (["cpu"] * 4, the output layer split over
'state'), for all four models, against mesh=None on the same batches; and
rgrgr_r94's first step against scrappie_tpu's train(mesh=) on a (2, 2)
virtual mesh.

The gradient is compared, not weights after many steps: Adam's first
update moves a weight by about lr whatever its gradient's size, so a
near-zero gradient's sign decides the weight's direction. Tolerances:
  * the first step's loss and the global norm of its gradient: 1e-5
    relative (each replica's masked sum over the global count, added in
    row order; the split product sums two partials);
  * every gradient leaf: 1e-4 relative to its largest entry
    (tests/test_torch_train.py's GRAD_RTOL against jax.grad);
  * three steps' losses: 1e-4 relative;
  * against scrappie_tpu's sharded step: the loss within 1e-5 relative
    (tests/test_torch_train.py's LOSS_RTOL).
"""

import jax
import numpy as np
import pytest
import torch

from scrappie_torch.parallel.sharding import make_mesh
from scrappie_torch.train import trainer as tt
from scrappie_torch.train.simulate import SquiggleSimulator
from scrappie_tpu import ops as jops
from scrappie_tpu.models import registry
from scrappie_tpu.parallel import sharding as js
from scrappie_tpu.train import trainer as jt

torch.set_num_threads(1)
MODELS = ("rgrgr_r94", "raw_r94", "rnnrf_r94", "nanonet_events")
LOSS_RTOL = 1e-5
NORM_RTOL = 1e-5
GRAD_RTOL = 1e-4
STEPS_RTOL = 1e-4
BATCH, NSAMPLE, LR = 4, 600, 1e-3


def meshes():
    return {"2x1": make_mesh(devices=["cpu"] * 2),
            "2x2": make_mesh(2, 2, devices=["cpu"] * 4)}


def perturbed(model: str, seed: int) -> dict:
    """The in-repo weights plus 0.05 seeded standard-normal noise."""
    rng = np.random.default_rng(seed)
    return {k: (v + 0.05 * rng.standard_normal(v.shape)).astype(np.float32)
            for k, v in registry.load_params(model).items()}


def batches(model: str, seed: int, n: int) -> list:
    sim = SquiggleSimulator(seed=seed, device="cpu")
    if model == "nanonet_events":
        return [sim.detected_events_batch(BATCH, NSAMPLE // 10)
                for _ in range(n)]
    stride = {"rgrgr_r94": 5, "raw_r94": 4, "rnnrf_r94": 2}[model]
    make = (sim.crf_labelled_batch if model == "rnnrf_r94"
            else sim.labelled_batch)
    return [make(BATCH, NSAMPLE, stride) for _ in range(n)]


class Replay:
    """A simulator that hands out given batches in order."""

    def __init__(self, batches):
        self.batches = list(batches)

    def labelled_batch(self, *_):
        return self.batches.pop(0)

    crf_labelled_batch = detected_events_batch = labelled_batch


def global_norm(grads) -> float:
    return float(torch.sqrt(sum((g.double() ** 2).sum()
                                for g in grads.values())))


@pytest.mark.parametrize("model", MODELS)
def test_train_on_a_mesh_matches_one_device(model):
    params = perturbed(model, seed=3)
    data = batches(model, seed=4, n=3)
    tensors = {k: torch.tensor(v) for k, v in params.items()}
    loss, grads = tt.value_and_grad(model, tensors, *data[0])
    kw = dict(steps=3, batch=BATCH, nsample=NSAMPLE, lr=LR, params=params,
              log_every=0)
    _, losses = tt.train(model, simulator=Replay(data), device="cpu", **kw)
    assert losses[0] == pytest.approx(float(loss), rel=LOSS_RTOL)
    for name, mesh in meshes().items():
        mloss, mgrads = tt.value_and_grad_on_mesh(model, tensors, mesh,
                                                  *data[0])
        assert float(mloss) == pytest.approx(float(loss), rel=LOSS_RTOL), name
        assert global_norm(mgrads) == pytest.approx(global_norm(grads),
                                                    rel=NORM_RTOL), name
        assert set(mgrads) == set(grads)
        for k, g in grads.items():
            assert mgrads[k].shape == g.shape
            err = float((mgrads[k] - g).abs().max())
            assert err <= GRAD_RTOL * max(float(g.abs().max()), 1e-30), (name, k)
        got_params, got = tt.train(model, simulator=Replay(data), mesh=mesh,
                                   **kw)
        np.testing.assert_allclose(got, losses, rtol=STEPS_RTOL, err_msg=name)
        assert set(got_params) == set(params)
        assert all(got_params[k].shape == v.shape and
                   got_params[k].dtype == np.float32
                   for k, v in params.items())


def test_train_on_a_mesh_matches_jax_sharded_step():
    """rgrgr_r94's first step: the port on a (2, 2) mesh against
    scrappie_tpu's train on a (2, 2) virtual mesh (batch sharded over
    'data', FF_W over 'state'), the same weights and batch."""
    model = "rgrgr_r94"
    params = perturbed(model, seed=7)
    data = batches(model, seed=8, n=1)
    jmesh = js.make_mesh(n_data=2, n_state=2, devices=jax.devices()[:4])
    kw = dict(steps=1, batch=BATCH, nsample=NSAMPLE, lr=LR, params=params,
              log_every=0)
    with jops.pallas(False):
        _, want = jt.train(model, simulator=Replay(data), mesh=jmesh, **kw)
    _, got = tt.train(model, simulator=Replay(data),
                      mesh=meshes()["2x2"], **kw)
    assert got[0] == pytest.approx(want[0], rel=LOSS_RTOL)


def test_train_needs_rows_for_every_data_device():
    """A batch the data axis does not divide is refused, not padded."""
    sig, labels = batches("rgrgr_r94", seed=1, n=1)[0]
    tensors = {k: torch.tensor(v)
               for k, v in registry.load_params("rgrgr_r94").items()}
    with pytest.raises(ValueError, match="data devices"):
        tt.value_and_grad_on_mesh("rgrgr_r94", tensors, meshes()["2x1"],
                                  sig[:3], labels[:3])

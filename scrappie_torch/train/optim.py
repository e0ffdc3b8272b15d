"""The JAX trainer's optimiser, written out in PyTorch.

scrappie_tpu/train/trainer.py builds it with optax:

    apply_if_finite(chain(clip_by_global_norm(1.0), adam(lr)),
                    max_consecutive_errors=25)

There is no optax beside the port, so `FiniteClippedAdam` repeats optax's
formulas (optax 0.2: transforms/_conditionality.py, _clipping.py,
_src/transform.py:scale_by_adam) on a dict of tensors, in the order of
operations optax takes:

  * apply_if_finite: if every gradient is finite, or the count of
    consecutive non-finite gradients (this one included) exceeds
    MAX_CONSECUTIVE_ERRORS, the inner update runs; otherwise the
    parameters and the inner state stay as they are. The count returns
    to 0 on a finite gradient.
  * clip_by_global_norm(MAX_NORM): norm = sqrt(sum over the leaves, in
    sorted key order as jax.tree.leaves takes a dict, of sum(g * g)); the
    gradients pass unchanged where norm < MAX_NORM, else each becomes
    (g / norm) * MAX_NORM. (torch.nn.utils.clip_grad_norm_ divides by
    norm + 1e-6 and so is not this function.)
  * adam(lr, B1, B2, EPS), optax's defaults: mu = (1 - B1) g + B1 mu,
    nu = (1 - B2) g^2 + B2 nu, count += 1, update = -lr * (mu / (1 -
    B1^count)) / (sqrt(nu / (1 - B2^count)) + EPS), params += update, the
    bias corrections 1 - b^count in float32 as optax takes them.

It keeps its own update rather than torch.optim.Adam: Adam's formula is
the same in exact arithmetic, but it folds the bias corrections into the
step size (lr / (1 - b1^t) and sqrt(1 - b2^t)), so its float32 rounding
differs from optax's, and it has no way to keep its state on a rejected
step. The state is float32 like the parameters, count an integer.
"""

from __future__ import annotations

import torch

#: The constants of the JAX trainer's optax call (and optax's adam defaults).
MAX_NORM = 1.0
MAX_CONSECUTIVE_ERRORS = 25
B1, B2, EPS = 0.9, 0.999, 1e-8


class FiniteClippedAdam:
    """apply_if_finite(chain(clip_by_global_norm(MAX_NORM), adam(lr)),
    MAX_CONSECUTIVE_ERRORS) over a dict of float32 parameter tensors,
    updated in place by `step(grads)`."""

    def __init__(self, params: dict[str, torch.Tensor], lr: float):
        self.params = params
        self.lr = lr
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.count = 0
        self.notfinite_count = 0

    @torch.no_grad()
    def step(self, grads: dict[str, torch.Tensor]) -> bool:
        """Apply one update from grads (a tensor for every parameter);
        return whether it was applied."""
        keys = sorted(self.params)
        finite = bool(torch.stack([torch.isfinite(grads[k]).all()
                                   for k in keys]).all())
        self.notfinite_count = 0 if finite else self.notfinite_count + 1
        if not (finite or self.notfinite_count > MAX_CONSECUTIVE_ERRORS):
            return False
        norm = torch.sqrt(sum(torch.sum(grads[k] * grads[k]) for k in keys))
        clip = not bool(norm < MAX_NORM)
        self.count += 1
        bc1, bc2 = (float(1 - torch.tensor(b, dtype=torch.float32) ** self.count)
                    for b in (B1, B2))
        for k in keys:
            g = grads[k]
            if clip:
                g = (g / norm) * MAX_NORM
            self.mu[k] = (1 - B1) * g + B1 * self.mu[k]
            self.nu[k] = (1 - B2) * (g * g) + B2 * self.nu[k]
            mu_hat = self.mu[k] / bc1
            nu_hat = self.nu[k] / bc2
            update = -self.lr * (mu_hat / (torch.sqrt(nu_hat) + EPS))
            self.params[k].add_(update)
        return True

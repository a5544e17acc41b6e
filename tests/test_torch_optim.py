"""The port's optimizers and schedulers against the JAX package's (optax).

Five steps of each optimizer from the same parameters with the same numpy
gradients: parameters agree to 1e-6 absolute (the same update, written as
torch and optax write it, in f32). The schedulers are copies of the JAX
package's and must give the same learning-rate sequence exactly.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from multi_task_breast_cancer_tpu_torch.train import optim as O

TOL = 1e-6


@pytest.mark.parametrize("name,lr", [("Adam", 1e-3), ("SGD", 1e-2), ("AdamW", 1e-3),
                                     ("Unknown", 0.5)])
def test_optimizer_matches_optax_over_five_steps(name, lr):
    import jax.numpy as jnp
    import optax

    from multi_task_breast_cancer_tpu.train import optim as JO

    rng = np.random.default_rng(0)
    p0 = {"w": rng.standard_normal((4, 5)).astype(np.float32),
          "b": rng.standard_normal(5).astype(np.float32)}
    # gradients of varied scale, some at the Adam eps (1e-4)
    grads = [{k: (rng.standard_normal(v.shape) * 10.0 ** rng.integers(-5, 1)).astype(np.float32)
              for k, v in p0.items()} for _ in range(5)]

    tx = JO.init_optimizer(name, lr)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(jp)
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)

    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    opt = O.init_optimizer(name, lr, list(tp.values()))
    for g in grads:
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
    for k in p0:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=0, atol=TOL)


def test_set_and_get_learning_rate():
    p = torch.nn.Parameter(torch.zeros(3))
    opt = O.init_optimizer("Adam", 1e-4, [p])
    assert opt.defaults["eps"] == 1e-4
    O.set_learning_rate(opt, 5e-5)
    assert O.get_learning_rate(opt) == 5e-5
    p.grad = torch.ones(3)
    opt.step()
    # the first Adam step of a unit gradient moves by lr / (1 + eps)
    torch.testing.assert_close(p.detach(), torch.full((3,), -5e-5 / (1 + 1e-4)),
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("kind", ["plateau", "cosine"])
def test_schedulers_match_jax(kind):
    from multi_task_breast_cancer_tpu.train import optim as JO

    kw = {"t_max": 7, "factor": 0.5, "min_lr": 1e-6, "patience": 2}
    ours, theirs = O.init_lr_scheduler(kind, 1e-3, **kw), JO.init_lr_scheduler(kind, 1e-3, **kw)
    metrics = [1.0, 0.9, 0.95, 0.95, 0.96, 0.97, 0.5, 0.6, 0.6, 0.6, 0.7, 0.8, 0.9, 1.0]
    for m in metrics:
        assert ours.step(m) == theirs.step(m)
    assert ours.state_dict() == theirs.state_dict()
    fresh = O.init_lr_scheduler(kind, 1e-3, **kw)
    fresh.load_state_dict(ours.state_dict())
    assert fresh.lr == ours.lr
    with pytest.raises(ValueError, match="scheduler"):
        O.init_lr_scheduler("step", 1e-3)

"""The port's fused clip + AdamW (mmtrl_tpu_torch/ops/fused_optim.py) against
the JAX package's, step for step on the same numpy-seeded trees, in both
clip regimes, on the CPU."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mmtrl_tpu.ops.fused_optim import fused_clip_adamw as jax_fused_clip_adamw
from mmtrl_tpu_torch.algos.dt.train import warmup_cosine_decay_schedule
from mmtrl_tpu_torch.ops.fused_optim import fused_clip_adamw, global_norm, init_adam_state

SHAPES = {"w": (17, 23), "b": (23,), "table": (11, 7)}
# float32 on both sides with the same operations; XLA and PyTorch may sum the
# global norm in another order and fuse differently, as in
# tests/test_fused_optim.py's own comparison with optax.
RTOL, ATOL = 2e-6, 2e-7


def _tree(seed, scale):
    rng = np.random.RandomState(seed)
    return {k: (rng.randn(*s) * scale).astype(np.float32) for k, s in SHAPES.items()}


def _run_both(jax_lr, torch_lr, grad_scales, max_grad_norm, **kw):
    params = _tree(0, 0.5)
    grads_seq = [_tree(i + 1, s) for i, s in enumerate(grad_scales)]
    tx = jax_fused_clip_adamw(jax_lr, max_grad_norm=max_grad_norm, **kw)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = tx.init(jp)
    tp = [torch.from_numpy(params[k].copy()) for k in SHAPES]
    tstate = init_adam_state(tp)
    out = []
    for g in grads_seq:
        upd, jstate = tx.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        tstate = fused_clip_adamw(tp, [torch.from_numpy(g[k]) for k in SHAPES], tstate,
                                  torch_lr, max_grad_norm=max_grad_norm, **kw)
        out.append((jp, jstate, [t.clone() for t in tp], tstate, g))
    return out


@pytest.mark.parametrize("regime", ["clip_fires", "clip_idle"])
def test_matches_jax_with_warmup_cosine(regime):
    # as tests/test_fused_optim.py:31, three steps in one clip regime each
    kw = dict(b1=0.9, b2=0.95, weight_decay=0.1, eps=1e-8)
    jax_lr = optax.warmup_cosine_decay_schedule(0.0, 3e-4, warmup_steps=2, decay_steps=20,
                                                end_value=3e-5)
    torch_lr = warmup_cosine_decay_schedule(0.0, 3e-4, 2, 20, 3e-5)
    scale = 10.0 if regime == "clip_fires" else 1e-3
    steps = _run_both(jax_lr, torch_lr, [scale] * 3, 0.25, **kw)
    for jp, jstate, tp, tstate, g in steps:
        norm = float(global_norm([torch.from_numpy(x) for x in g.values()]))
        assert (norm > 0.25) == (regime == "clip_fires")
        assert int(tstate.count) == int(jstate.count) and tstate.count.dtype == torch.int32
        for i, k in enumerate(SHAPES):
            np.testing.assert_allclose(tp[i].numpy(), np.asarray(jp[k]), rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(tstate.mu[i].numpy(), np.asarray(jstate.mu[k]),
                                       rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(tstate.nu[i].numpy(), np.asarray(jstate.nu[k]),
                                       rtol=RTOL, atol=ATOL)
    # the schedule is read at the count before the increment: 0 at step 1
    first_params = steps[0][2]
    np.testing.assert_array_equal(first_params[0].numpy(), _tree(0, 0.5)["w"])


def test_matches_jax_constant_lr():
    # as tests/test_fused_optim.py:60
    kw = dict(b1=0.9, b2=0.999, weight_decay=0.01)
    for jp, _, tp, _, _ in _run_both(1e-3, 1e-3, [1.0, 1.0, 1.0], 0.5, **kw):
        for i, k in enumerate(SHAPES):
            np.testing.assert_allclose(tp[i].numpy(), np.asarray(jp[k]), rtol=RTOL, atol=ATOL)


def test_weight_decay_reaches_every_parameter_and_updates_in_place():
    params = [torch.ones(3), torch.ones(2, 2)]
    ids = [id(p) for p in params]
    state = fused_clip_adamw(params, [torch.zeros(3), torch.zeros(2, 2)],
                             init_adam_state(params), 0.5, weight_decay=0.1)
    # zero gradients: the update is the decay alone, -lr * wd * p
    for p in params:
        torch.testing.assert_close(p, torch.full_like(p, 1 - 0.5 * 0.1), rtol=0, atol=1e-7)
    assert [id(p) for p in params] == ids and int(state.count) == 1

"""The port's DT training step (mmtrl_tpu_torch/algos/dt/train.py) against the
JAX package's on the CPU: the schedule, the loss and accuracy, three train
steps at TINY from the same converted parameters and zero moments on the
same batches, the optimizer state carried across whole, and an overfit
run."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mmtrl_tpu.algos.dt import DTTrainConfig as JaxDTTrainConfig
from mmtrl_tpu.algos.dt import create_dt_state as jax_create_dt_state
from mmtrl_tpu.algos.dt import make_dt_train_step as jax_make_dt_train_step
from mmtrl_tpu.models.decision_transformer import DTConfig as JaxDTConfig
from mmtrl_tpu_torch.algos.dt import (
    DTTrainConfig,
    TrajectoryBuffer,
    create_dt_state,
    make_dt_train_step,
    make_dt_train_steps,
)
from mmtrl_tpu_torch.algos.dt.train import dt_loss, warmup_cosine_decay_schedule
from mmtrl_tpu_torch.convert import adam_state_from_flax, dt_params_from_flax
from mmtrl_tpu_torch.models.decision_transformer import DTConfig

TINY = JaxDTConfig(
    num_actions=4, context_len=6, d_model=32, n_layers=2, n_heads=2,
    dropout=0.0, max_timestep=64, compute_dtype="float32",
)
TRAIN = dict(learning_rate=1e-3, warmup_steps=2, total_steps=20)
N_STEPS = 3
# Loss and accuracy: float32 forward on both sides, summation order only.
LOSS_RTOL = 1e-6
# Parameters after three AdamW steps: Adam divides each gradient by its own
# running RMS, so a gradient entry near zero, where float32 summation order
# changes its relative value most, moves its parameter by up to the learning
# rate either way.  Held to 1e-6 relative plus 5e-6 (half a percent of the
# learning rate 1e-3), and to 1e-8 in the mean over all parameters.
PARAM_ATOL = 5e-6


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several worker processes at once; torch's own
    intra-op thread pool on top of that oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(seed, B=4, K=6, masked=True):
    rng = np.random.RandomState(seed)
    mask = np.ones((B, K), bool)
    if masked:
        mask[0, :2] = False  # a left-padded window
    return (
        rng.uniform(-5, 10, (B, K)).astype(np.float32),
        rng.uniform(-1, 1, (B, K, 2, 84, 84)).astype(np.float32),
        rng.randint(0, 4, (B, K)).astype(np.int32),
        np.tile(np.arange(K, dtype=np.int32), (B, 1)),
        mask,
    )


def _torch_batch(b):
    rtg, states, actions, ts, mask = (torch.from_numpy(x) for x in b)
    return rtg, states, actions.long(), ts.long(), mask


@pytest.fixture(scope="module")
def three_steps():
    """Three JAX steps and three port steps from the same start."""
    batches = [_batch(10 + i) for i in range(N_STEPS)]
    jstate = jax_create_dt_state(
        jax.random.PRNGKey(0), TINY, JaxDTTrainConfig(**TRAIN), tuple(map(jnp.asarray, batches[0]))
    )
    state = create_dt_state(DTConfig(**dataclasses.asdict(TINY)), DTTrainConfig(**TRAIN),
                            device="cpu")
    state.model.load_state_dict(dt_params_from_flax(jax.tree_util.tree_map(np.asarray, jstate.params)),
                                strict=True)
    jstep = jax.jit(jax_make_dt_train_step(TINY))
    step = make_dt_train_step(DTConfig(**dataclasses.asdict(TINY)))
    metrics = []
    for i, b in enumerate(batches):
        jstate, jm = jstep(jstate, tuple(map(jnp.asarray, b)), jax.random.PRNGKey(i))
        state, m = step(state, _torch_batch(b))
        metrics.append(({k: float(v) for k, v in jm.items()}, {k: float(v) for k, v in m.items()}))
    return jstate, state, metrics


@pytest.mark.parametrize("i", range(N_STEPS))
def test_train_step_loss_and_accuracy_match_jax(three_steps, i):
    _, _, metrics = three_steps
    ref, out = metrics[i]
    assert set(out) == set(ref) == {"dt/loss", "dt/action_accuracy"}
    np.testing.assert_allclose(out["dt/loss"], ref["dt/loss"], rtol=LOSS_RTOL)
    assert out["dt/action_accuracy"] == ref["dt/action_accuracy"]


def test_params_after_three_steps_match_jax(three_steps):
    jstate, state, _ = three_steps
    ref = dt_params_from_flax(jax.tree_util.tree_map(np.asarray, jstate.params))
    out = dict(state.model.named_parameters())
    assert set(out) == set(ref)
    diffs = []
    for name, r in ref.items():
        o = out[name].detach()
        np.testing.assert_allclose(o.numpy(), r.numpy(), rtol=1e-6, atol=PARAM_ATOL, err_msg=name)
        diffs.append((o - r).abs().flatten())
    assert float(torch.cat(diffs).mean()) <= 1e-8
    assert int(state.step) == int(jstate.step) == N_STEPS


def test_adam_state_carries_over_from_jax(three_steps):
    jstate, state, _ = three_steps
    names = [n for n, _ in state.model.named_parameters()]
    opt = jstate.opt_state
    carried = adam_state_from_flax(opt.count, jax.tree_util.tree_map(np.asarray, opt.mu),
                                   jax.tree_util.tree_map(np.asarray, opt.nu), names)
    assert int(carried.count) == int(state.opt_state.count) == N_STEPS
    assert carried.count.dtype == torch.int32
    for a, b, p in zip(carried.mu, state.opt_state.mu, state.model.parameters()):
        assert a.shape == p.shape
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-7)
    for a, b in zip(carried.nu, state.opt_state.nu):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-10)
    with pytest.raises(ValueError, match="missing"):
        adam_state_from_flax(opt.count, jax.tree_util.tree_map(np.asarray, opt.mu),
                             jax.tree_util.tree_map(np.asarray, opt.nu), names + ["extra.weight"])


@pytest.mark.parametrize("warmup,total", [(5, 40), (512, 20_000)])
def test_schedule_matches_optax(warmup, total):
    peak = 6e-4
    ref = optax.warmup_cosine_decay_schedule(0.0, peak, warmup_steps=warmup, decay_steps=total,
                                             end_value=0.1 * peak)
    schedule = warmup_cosine_decay_schedule(0.0, peak, warmup, total, 0.1 * peak)
    for count in (0, warmup - 1, warmup, (warmup + total) // 2, total, total + 7):
        out = schedule(torch.tensor(count, dtype=torch.int32))
        assert out.dtype == torch.float32
        # float32 on both sides; cos may differ in its last place
        np.testing.assert_allclose(float(out), float(ref(jnp.int32(count))), rtol=1e-6, atol=0)


def test_loss_and_accuracy_golden():
    logits = torch.tensor([[[2.0, 2.0, 0.0], [0.0, 1.0, 3.0], [1.0, 0.0, 0.0]]])
    actions = torch.tensor([[0, 1, 0]])
    mask = torch.tensor([[True, True, False]])
    loss, acc = dt_loss(logits, actions, mask)
    logp = torch.log_softmax(logits, -1)[0]
    torch.testing.assert_close(loss, -(logp[0, 0] + logp[1, 1]) / 2)
    assert float(acc) == 0.5  # the tie [2, 2, 0] picks index 0, as jnp.argmax
    loss0, acc0 = dt_loss(logits, actions, torch.zeros_like(mask))
    assert float(loss0) == float(acc0) == 0.0  # over max(mask.sum(), 1)


def test_create_dt_state_from_a_generator_keeps_the_global_rng():
    cfg, tcfg = DTConfig(**dataclasses.asdict(TINY)), DTTrainConfig(**TRAIN)
    torch.manual_seed(123)
    expected = torch.rand(3)
    torch.manual_seed(123)
    states = [create_dt_state(cfg, tcfg, generator=torch.Generator().manual_seed(4), device="cpu")
              for _ in range(2)]
    assert torch.equal(torch.rand(3), expected)
    for a, b in zip(states[0].model.parameters(), states[1].model.parameters()):
        assert torch.equal(a, b)
    assert int(states[0].step) == 0 and all(float(m.abs().sum()) == 0 for m in states[0].opt_state.mu)
    # MoE FFNs: the experts' moments start at zero too
    moe_state = create_dt_state(dataclasses.replace(cfg, moe_experts=4), tcfg, device="cpu")
    names = [n for n, _ in moe_state.model.named_parameters()]
    assert "block_0.moe.experts_w1" in names and "block_0.moe.gate.weight" in names
    assert all(float(m.abs().sum()) == 0 for m in moe_state.opt_state.mu)


def test_dt_overfits_tiny_batch():
    # tests/test_dt.py's overfit run, on the port from its own init.  That
    # test stops after 40 of the schedule's 60 steps, where the JAX run is at
    # 0.497 of its first loss (and the port, from the same converted init, at
    # the same loss to 1e-6); from the port's init it runs the whole schedule.
    cfg = DTConfig(**dataclasses.asdict(TINY))
    state = create_dt_state(cfg, DTTrainConfig(total_steps=60, warmup_steps=5, learning_rate=1e-3),
                            seed=0, device="cpu")
    step = make_dt_train_step(cfg)
    batch = _torch_batch(_batch(0, masked=False))
    losses = []
    for _ in range(60):
        state, m = step(state, batch)
        losses.append(float(m["dt/loss"]))
    assert losses[-1] < losses[0] * 0.5, (losses[0], losses[-1])


def test_train_steps_sample_and_train():
    cfg = DTConfig(**dict(dataclasses.asdict(TINY), dropout=0.1))
    rng = np.random.RandomState(0)
    N, T = 2, 20
    buf = TrajectoryBuffer(
        states=torch.from_numpy(rng.uniform(-1, 1, (N, T, 2 * 84 * 84)).astype(np.float32)),
        actions=torch.from_numpy(rng.randint(0, 4, (N, T))).long(),
        rtg=torch.from_numpy(rng.uniform(-5, 10, (N, T)).astype(np.float32)),
        timesteps=torch.arange(T).repeat(N, 1), episode_starts=torch.zeros((N, T), dtype=torch.bool),
        state_shape=(2, 84, 84),
    )
    state = create_dt_state(cfg, DTTrainConfig(**TRAIN), seed=1, device="cpu")
    before = [p.detach().clone() for p in state.model.parameters()]
    state, m = make_dt_train_steps(cfg, 3, 6, 2)(state, buf, torch.Generator().manual_seed(0))
    assert int(state.step) == 2 and np.isfinite(float(m["dt/loss"]))
    assert all(not torch.equal(a, b) for a, b in zip(before, state.model.parameters()))

"""The whole serving slice on the CPU: the port's evaluate_dt against the JAX
evaluate_dt at TINY, from converted weights and the same env reset draws."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmtrl_tpu.algos.dt import evaluate_dt as jax_evaluate_dt
from mmtrl_tpu.envs.minecraft2d import Minecraft2d as JaxMinecraft2d
from mmtrl_tpu.models.decision_transformer import DecisionTransformer as JaxDT
from mmtrl_tpu.models.decision_transformer import DTConfig as JaxDTConfig
from mmtrl_tpu_torch.algos.dt import evaluate_dt
from mmtrl_tpu_torch.convert import dt_params_from_flax
from mmtrl_tpu_torch.envs.minecraft2d import Minecraft2d
from mmtrl_tpu_torch.models.decision_transformer import DecisionTransformer, DTConfig

TINY = JaxDTConfig(
    num_actions=4, context_len=6, d_model=32, n_layers=2, n_heads=2,
    dropout=0.0, max_timestep=64, compute_dtype="float32",
)
NUM_ENVS, NUM_STEPS = 4, 40  # > MAX_ITER = 30: every env ends an episode and resets


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several worker processes at once; torch's own
    intra-op thread pool on top of that oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reset_draws(env, keys):
    s = jax.vmap(env._reset)(keys)[1]
    cells = np.stack(
        [np.asarray(loc[:, 0] * 5 + loc[:, 1]) for loc in (s.agent, s.good, s.bad, s.gem)],
        axis=1,
    )
    return torch.tensor(cells).long(), torch.tensor(np.asarray(s.gem_type)).long()


def _jax_schedule(env, key, num_envs, num_steps):
    """The reset draws JAX evaluate_dt makes, in order: its initial v_reset
    (evaluate.py:40-41), then one auto-reset draw per env per step from the
    step keys (evaluate.py:72,76-78; base.py:96-98)."""
    key, k_reset = jax.random.split(key)
    draws = [_reset_draws(env, jax.random.split(k_reset, num_envs))]
    for _ in range(num_steps):
        key, _, k_step = jax.random.split(key, 3)
        step_keys = jax.random.split(k_step, num_envs)
        draws.append(_reset_draws(env, jax.vmap(lambda k: jax.random.split(k)[1])(step_keys)))
    return draws


@pytest.mark.parametrize("seed,rtg_clip", [(0, None), (1, 10.0)])
def test_evaluate_dt_matches_jax(seed, rtg_clip):
    jenv = JaxMinecraft2d()
    rng = np.random.RandomState(seed)
    example = (
        jnp.asarray(rng.uniform(0, 10, (1, 6)), jnp.float32),
        jnp.asarray(rng.uniform(-1, 1, (1, 6, 2, 84, 84)), jnp.float32),
        jnp.zeros((1, 6), jnp.int32),
        jnp.zeros((1, 6), jnp.int32),
    )
    params = JaxDT(TINY).init(jax.random.PRNGKey(seed), *example)
    key = jax.random.PRNGKey(100 + seed)
    ref = jax.jit(
        lambda p, k: jax_evaluate_dt(
            jenv, TINY, p, k, 10.0, num_envs=NUM_ENVS, num_steps=NUM_STEPS,
            rtg_clip=rtg_clip,
        )
    )(params, key)

    draws = _jax_schedule(jenv, key, NUM_ENVS, NUM_STEPS)

    def replay(n, generator=None):
        assert n == NUM_ENVS
        return draws.pop(0)

    cfg = DTConfig(**dataclasses.asdict(TINY))
    model = DecisionTransformer(cfg, device="cpu")
    model.load_state_dict(
        dt_params_from_flax(jax.tree_util.tree_map(np.asarray, params)), strict=True
    )
    env = Minecraft2d(device="cpu", sampler=replay)
    out = evaluate_dt(
        env, cfg, model, 10.0, num_envs=NUM_ENVS, num_steps=NUM_STEPS,
        rtg_clip=rtg_clip, device="cpu",
    )
    assert not draws  # every JAX draw was consumed, in step
    assert set(out) == set(ref)
    assert int(out["eval/episodes"]) == int(ref["eval/episodes"]) >= NUM_ENVS
    for name in ("eval/episodic_return", "eval/episodic_length"):
        assert float(out[name]) == float(ref[name]), name


def test_evaluate_dt_sampling_and_device_checks():
    cfg = DTConfig(**dataclasses.asdict(TINY))
    torch.manual_seed(0)
    model = DecisionTransformer(cfg, device="cpu")
    env = Minecraft2d(device="cpu")
    runs = [
        evaluate_dt(env, cfg, model, 10.0, num_envs=3, num_steps=35, greedy=False,
                    generator=torch.Generator().manual_seed(7), device="cpu")
        for _ in range(2)
    ]
    assert all(torch.equal(runs[0][k], runs[1][k]) for k in runs[0])  # seeded
    assert int(runs[0]["eval/episodes"]) >= 3
    assert torch.isfinite(runs[0]["eval/episodic_return"])
    with pytest.raises(ValueError, match="env is on"):
        evaluate_dt(env, cfg, model, 10.0, device="meta")


def test_evaluate_dt_restores_the_callers_mode():
    cfg = DTConfig(**dataclasses.asdict(TINY))
    torch.manual_seed(0)
    model = DecisionTransformer(cfg, device="cpu")
    env = Minecraft2d(device="cpu")
    modes = []
    model.register_forward_pre_hook(lambda m, args: modes.append(m.training))
    assert model.training
    evaluate_dt(env, cfg, model, 10.0, num_envs=2, num_steps=3, device="cpu")
    assert model.training and modes == [False] * 3  # eval inside, train after
    model.eval()
    evaluate_dt(env, cfg, model, 10.0, num_envs=2, num_steps=1, device="cpu")
    assert not model.training

    def fail(state, action):
        raise RuntimeError("env step failed")

    model.train()
    env._step_env = fail
    with pytest.raises(RuntimeError, match="env step failed"):
        evaluate_dt(env, cfg, model, 10.0, num_envs=2, num_steps=2, device="cpu")
    assert model.training

"""The port's online PPO path against the JAX package's on the CPU, on the
same seeded numpy inputs and converted weights: GAE, the categorical
helpers, the LSTM cell, the attention modules, the recurrent agents, the
PPO loss, the optax state's conversion and whole ``update_from_rollout``
calls (the JAX permutations replayed into the port), with and without the
target-KL stop."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmtrl_tpu.algos.ppo import PPOConfig as JaxPPOConfig
from mmtrl_tpu.algos.ppo import make_recurrent_ppo as jax_make_recurrent_ppo
from mmtrl_tpu.algos.ppo.core import _explained_variance as jax_explained_variance
from mmtrl_tpu.algos.ppo.core import _ppo_loss as jax_ppo_loss
from mmtrl_tpu.envs.minecraft2d import Minecraft2d as JaxMinecraft2d
from mmtrl_tpu.models import attention as jax_attention
from mmtrl_tpu.models import distributions as jax_dist
from mmtrl_tpu.models.agents import MultimodalRecurrentAgent as JaxMultimodalAgent
from mmtrl_tpu.models.agents import RecurrentAgent as JaxRecurrentAgent
from mmtrl_tpu.models.lstm import LSTMCell as JaxLSTMCell
from mmtrl_tpu.ops.gae import compute_gae as jax_compute_gae
from mmtrl_tpu_torch.algos.ppo import PPOConfig, RunnerState, make_recurrent_ppo
from mmtrl_tpu_torch.algos.ppo.core import _explained_variance, _ppo_loss
from mmtrl_tpu_torch.convert import agent_params_from_flax, ppo_opt_state_from_flax
from mmtrl_tpu_torch.envs.minecraft2d import Minecraft2d
from mmtrl_tpu_torch.models import attention
from mmtrl_tpu_torch.models.agents import MultimodalRecurrentAgent, RecurrentAgent
from mmtrl_tpu_torch.models.distributions import (
    categorical_entropy,
    categorical_log_prob,
    categorical_sample,
    gumbel_argmax,
)
from mmtrl_tpu_torch.models.lstm import LSTMCell
from mmtrl_tpu_torch.ops.gae import compute_gae

# float32 on both sides, the same operations in the same order where the
# module is a few elementwise ops and small products: summation order only.
F32_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several worker processes at once; torch's own
    intra-op thread pool on top of that oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(out, ref, rtol, atol_of_max=0.0, what="", atol=0.0):
    """|out - ref| <= rtol * |ref| + atol_of_max * max|ref| + atol, elementwise."""
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    ref = np.asarray(ref)
    atol += atol_of_max * float(np.abs(ref).max()) if ref.size else 0.0
    np.testing.assert_allclose(out, ref, rtol=rtol, atol=atol, err_msg=what)


# ---- GAE --------------------------------------------------------------------
def test_gae_matches_jax():
    rng = np.random.RandomState(0)
    T, N = 9, 3
    rewards, values = rng.randn(T, N).astype(np.float32), rng.randn(T, N).astype(np.float32)
    dones = rng.rand(T, N) < 0.3
    next_value, next_done = rng.randn(N).astype(np.float32), rng.rand(N) < 0.5
    ref = jax_compute_gae(*map(jnp.asarray, (rewards, values, dones, next_value, next_done)),
                          0.99, 0.95)
    out = compute_gae(*map(_t, (rewards, values, dones, next_value, next_done)), 0.99, 0.95)
    for o, r in zip(out, ref):
        _close(o, r, F32_RTOL, 1e-6)


def test_gae_golden_case_with_a_done_in_the_middle():
    """gamma = lambda = 0.5; the episode ends after step 0 (dones[1] is the
    flag that preceded obs 1), so step 0 bootstraps nothing:
    t=2: delta = 3 + 0.5*2 - 1.5 = 2.5, adv 2.5;
    t=1: delta = 2 + 0.5*1.5 - 1 = 1.75, adv 1.75 + 0.25*2.5 = 2.375;
    t=0: delta = 1 - 0.5 = 0.5, adv 0.5."""
    adv, ret = compute_gae(
        torch.tensor([[1.0], [2.0], [3.0]]), torch.tensor([[0.5], [1.0], [1.5]]),
        torch.tensor([[False], [True], [False]]), torch.tensor([2.0]), torch.tensor([False]),
        0.5, 0.5,
    )
    assert adv[:, 0].tolist() == [0.5, 2.375, 2.5]
    assert ret[:, 0].tolist() == [1.0, 3.375, 4.0]


# ---- categorical ------------------------------------------------------------
def test_categorical_helpers_match_jax():
    rng = np.random.RandomState(1)
    logits = (rng.randn(64, 4) * 3).astype(np.float32)
    actions = rng.randint(0, 4, 64)
    key = jax.random.PRNGKey(5)
    # the uniforms jax draws, injected into the port's Gumbel argmax
    u = np.asarray(jax.random.uniform(key, logits.shape))
    ref = np.asarray(jax_dist.categorical_sample(key, jnp.asarray(logits)))
    assert gumbel_argmax(_t(logits), _t(u)).tolist() == ref.tolist()
    _close(categorical_log_prob(_t(logits), _t(actions)),
           jax_dist.categorical_log_prob(jnp.asarray(logits), jnp.asarray(actions)), F32_RTOL, 1e-7)
    _close(categorical_entropy(_t(logits)), jax_dist.categorical_entropy(jnp.asarray(logits)),
           F32_RTOL, 1e-7)
    # the port's sampler is the same argmax over the generator's uniforms in [0, 1)
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    assert torch.equal(categorical_sample(g1, _t(logits)),
                       gumbel_argmax(_t(logits), torch.rand(64, 4, generator=g2)))


# ---- LSTM and attention -----------------------------------------------------
def _load(module, params):
    module.load_state_dict(agent_params_from_flax(jax.device_get(params)), strict=True)
    return module


def test_lstm_cell_matches_jax_and_resets_on_done():
    rng = np.random.RandomState(2)
    B, I, H = 3, 5, 8
    x = rng.randn(B, I).astype(np.float32)
    h, c = (rng.randn(B, H).astype(np.float32) for _ in range(2))
    done = np.array([False, True, False])
    jcell = JaxLSTMCell(H)
    params = jcell.init(jax.random.PRNGKey(0), (jnp.asarray(h), jnp.asarray(c)),
                        jnp.asarray(x), jnp.asarray(done))
    (rh, rc), _ = jcell.apply(params, (jnp.asarray(h), jnp.asarray(c)), jnp.asarray(x),
                              jnp.asarray(done))
    cell = _load(LSTMCell(I, H, device="cpu"), params)
    (oh, oc), out = cell((_t(h), _t(c)), _t(x), _t(done))
    _close(oh, rh, F32_RTOL, 1e-6)
    _close(oc, rc, F32_RTOL, 1e-6)
    assert torch.equal(out, oh)
    # the done row is the step from a zero carry
    zh, zc = _t(h), _t(c)
    zh[1], zc[1] = 0.0, 0.0
    (zh, zc), _ = cell((zh, zc), _t(x), torch.zeros(B, dtype=torch.bool))
    assert torch.equal(zh[1], oh[1]) and torch.equal(zc[1], oc[1])


@pytest.mark.parametrize("name", ["CaslAttention", "NewAttention", "SigmoidGate"])
def test_attention_matches_jax(name):
    rng = np.random.RandomState(3)
    B, F, H = 4, 16, 8
    v, a = (rng.randn(B, F).astype(np.float32) for _ in range(2))
    h = rng.randn(B, H).astype(np.float32)
    jmod = getattr(jax_attention, name)()
    params = jmod.init(jax.random.PRNGKey(1), jnp.asarray(v), jnp.asarray(a), jnp.asarray(h))
    ref = jmod.apply(params, jnp.asarray(v), jnp.asarray(a), jnp.asarray(h))
    cls = getattr(attention, name)
    mod = cls(F, F, device="cpu") if name == "SigmoidGate" else cls(F, F, H, device="cpu")
    out = _load(mod, params)(_t(v), _t(a), _t(h))
    for o, r, what in zip(out, ref, ("video", "audio", "weights")):
        _close(o, r, 1e-5, 1e-6, what)


# ---- agents -----------------------------------------------------------------
T_AGENT, B_AGENT = 3, 2
# The towers' convs and Dense layers sum thousands of float32 terms in
# another order than XLA (and the 255 input scale leaves the features small);
# the recurrence then carries those differences through T steps.
AGENT_RTOL, AGENT_ATOL_OF_MAX = 1e-4, 1e-5


def _agent_inputs(channels, seed=4):
    rng = np.random.RandomState(seed)
    obs = rng.uniform(-1, 1, (T_AGENT, B_AGENT, channels, 84, 84)).astype(np.float32)
    done = np.zeros((T_AGENT, B_AGENT), bool)
    done[1, 0] = True  # a reset inside the window
    carry = tuple((rng.randn(B_AGENT, 128) * 0.5).astype(np.float32) for _ in range(2))
    return obs, done, carry


def _agent_parity(jmodel, model, channels):
    obs, done, carry = _agent_inputs(channels)
    jcarry = tuple(map(jnp.asarray, carry))
    params = jmodel.init(jax.random.PRNGKey(2), jnp.asarray(obs), jnp.asarray(done), jcarry)
    ref = jax.jit(jmodel.apply)(params, jnp.asarray(obs), jnp.asarray(done), jcarry)
    _load(model, params)
    logits, value, (h, c) = model(_t(obs), _t(done), tuple(map(_t, carry)))
    assert logits.shape == (T_AGENT, B_AGENT, 4) and value.shape == (T_AGENT, B_AGENT)
    for o, r, what in zip((logits, value, h, c), (ref[0], ref[1], *ref[2]),
                          ("logits", "value", "h", "c")):
        _close(o, r, AGENT_RTOL, AGENT_ATOL_OF_MAX, what)


@pytest.mark.parametrize("attn,fusion,scale", [
    (None, "sum", 255.0), (None, "concat", 1.0), ("casl", "sum", 255.0),
    ("casl", "sum", 1.0), ("new", "sum", 1.0), ("gate", "sum", 1.0),
])
def test_multimodal_agent_matches_jax(attn, fusion, scale):
    kw = dict(num_actions=4, conv_type="small", attn_type=attn, fusion_type=fusion,
              input_scale=scale)
    _agent_parity(JaxMultimodalAgent(**kw), MultimodalRecurrentAgent(**kw, device="cpu"), 2)


def test_recurrent_agent_matches_jax():
    kw = dict(num_actions=4, conv_type="small", input_scale=1.0)
    _agent_parity(JaxRecurrentAgent(**kw), RecurrentAgent(**kw, device="cpu"), 1)


def test_agent_keeps_the_jax_details():
    with pytest.raises(ValueError, match="concat"):
        MultimodalRecurrentAgent(4, "small", "casl", "concat", device="cpu")
    gate = MultimodalRecurrentAgent(4, "small", "gate", device="cpu")
    assert gate.actor.weight.shape == (4, 129) and gate.critic.weight.shape == (1, 129)
    big = MultimodalRecurrentAgent(4, "big", "casl", device="cpu")
    # the flagship online agent: two big towers, casl 32, LSTM 128, 4 actions
    assert sum(p.numel() for p in big.parameters()) == 3_722_343
    assert big.input_scale == 255.0


# ---- loss -------------------------------------------------------------------
def test_ppo_loss_and_explained_variance_match_jax_population_statistics():
    """Five samples, so the population and the sample standard deviation of
    the advantages differ by sqrt(5/4); the JAX loss uses the former."""
    rng = np.random.RandomState(6)
    n = 5
    arrays = [rng.randn(n).astype(np.float32) * s for s in (0.3, 1.0, 1.0, 0.3, 2.0, 1.0, 1.0)]
    newlogprob, entropy, newvalue, logprob_old, adv, ret, val = arrays
    entropy = np.abs(entropy)
    inputs = (newlogprob, entropy, newvalue, logprob_old, adv, ret, val)
    jcfg, cfg = JaxPPOConfig(), PPOConfig()
    jloss, jmetrics = jax_ppo_loss(jcfg, *map(jnp.asarray, inputs))
    loss, metrics = _ppo_loss(cfg, *map(_t, inputs))
    _close(loss, jloss, F32_RTOL, 1e-7)
    for k, v in jmetrics.items():
        _close(metrics[k], v, F32_RTOL, 1e-7, k)
    # the sample standard deviation would give another loss
    biased = dataclasses.replace(cfg, norm_adv=False)
    adv_ddof1 = (_t(adv) - _t(adv).mean()) / (_t(adv).std(correction=1) + 1e-8)
    ddof1_loss, _ = _ppo_loss(biased, *map(_t, inputs[:4]), adv_ddof1, *map(_t, inputs[5:]))
    assert abs(float(ddof1_loss) - float(jloss)) > 1e-3
    _close(_explained_variance(_t(val), _t(ret)),
           jax_explained_variance(jnp.asarray(val), jnp.asarray(ret)), F32_RTOL, 1e-7)
    flat = np.full(n, 2.0, np.float32)
    assert torch.isnan(_explained_variance(_t(val), _t(flat)))
    assert np.isnan(jax_explained_variance(jnp.asarray(val), jnp.asarray(flat)))


# ---- update_from_rollout ----------------------------------------------------
N_ENVS, N_STEPS = 4, 4
UPDATE = dict(num_envs=N_ENVS, num_steps=N_STEPS, num_minibatches=2, update_epochs=2,
              total_timesteps=3 * N_ENVS * N_STEPS, clip_rewards=True)
AGENT = dict(num_actions=4, conv_type="small", attn_type="casl", input_scale=1.0)
# Parameters after the update's Adam steps (lr 2.5e-4): float32 gradients
# summed in other orders; with eps 1e-5 an update's sensitivity to its
# gradient is bounded, so the parameters agree far inside the learning rate.
PARAM_RTOL, PARAM_ATOL = 1e-5, 1e-7
# Moments: mu and nu are the gradients' running averages, so they carry the
# gradients' own float32 differences, relative to each tensor's largest.
MOMENT_RTOL, MOMENT_ATOL_OF_MAX = 1e-4, 1e-4
METRIC_RTOL = 1e-4


def _rollout(jmodel, params, seed):
    """A rollout of seeded observations, random actions under the policy's
    own log-probs and values, random rewards and dones, and the post-rollout
    observation, done and carry."""
    rng = np.random.RandomState(seed)
    T, N = N_STEPS, N_ENVS
    obs = rng.uniform(-1, 1, (T + 1, N, 2, 84, 84)).astype(np.float32)
    dones = rng.rand(T + 1, N) < 0.25
    carry0 = tuple((rng.randn(N, 128) * 0.3).astype(np.float32) for _ in range(2))
    logits, values, carry = jmodel.apply(params, jnp.asarray(obs[:T]), jnp.asarray(dones[:T]),
                                         tuple(map(jnp.asarray, carry0)))
    actions = rng.randint(0, 4, (T, N))
    logprobs = jax_dist.categorical_log_prob(logits, jnp.asarray(actions))
    rewards = rng.choice([-10.0, -1.0, 10.0], (T, N)).astype(np.float32)
    rollout = (obs[:T], actions.astype(np.int32), np.asarray(logprobs), np.sign(rewards),
               dones[:T], np.asarray(values))
    after = (obs[T], dones[T], tuple(np.asarray(c) for c in carry))
    return carry0, rollout, after


def _jax_perms(key, epochs):
    perms = []
    for _ in range(epochs):
        key, k_perm = jax.random.split(key)
        perms.append(_t(jax.random.permutation(k_perm, N_ENVS)))
    return perms


class _JaxUpdate:
    """The jitted JAX ``update_from_rollout`` of one config and its agent."""

    def __init__(self, **changes):
        self.cfg = JaxPPOConfig(**{**UPDATE, **changes})
        self.model = JaxMultimodalAgent(**AGENT)
        parts = jax_make_recurrent_ppo(JaxMinecraft2d(), self.model, self.cfg)
        self.runner = parts[0](jax.random.PRNGKey(0))
        self.update = jax.jit(parts.update_from_rollout)

    def run(self, rs, seed):
        carry0, rollout, (obs, done, carry) = _rollout(self.model, rs.train_state.params, seed)
        rs = rs.replace(obs=jnp.asarray(obs), done=jnp.asarray(done),
                        carry=tuple(map(jnp.asarray, carry)))
        out = self.update(rs, tuple(map(jnp.asarray, carry0)), tuple(map(jnp.asarray, rollout)))
        return (carry0, rollout, (obs, done, carry)), rs, out


def _port_update(jupdate, jrs, data):
    """The port's update from the JAX runner's state, converted."""
    carry0, rollout, (obs, done, carry) = data
    # rpo_alpha is read only by the continuous variant
    jfields = dataclasses.asdict(jupdate.cfg)
    assert jfields.pop("rpo_alpha") == 0.0
    cfg = PPOConfig(**jfields)
    model = MultimodalRecurrentAgent(**AGENT, device="cpu")
    _load(model, jrs.train_state.params)
    names = [n for n, _ in model.named_parameters()]
    opt_state = ppo_opt_state_from_flax(jax.device_get(jrs.train_state.opt_state), names)
    ppo = make_recurrent_ppo(Minecraft2d(device="cpu"), model, cfg)
    rs = RunnerState(model=model, opt_state=opt_state, env_state=None, obs=_t(obs),
                     done=_t(done), carry=tuple(map(_t, carry)), stats=None, generator=None)
    rollout = tuple(_t(x) for x in rollout)
    rollout = rollout[:1] + (rollout[1].long(),) + rollout[2:]
    rs, metrics = ppo.update_from_rollout(rs, tuple(map(_t, carry0)), rollout,
                                          perms=_jax_perms(jrs.key, cfg.update_epochs))
    return rs, metrics


def _compare(rs, metrics, jrs, jmetrics):
    ts = jax.device_get(jrs.train_state)
    names = [n for n, _ in rs.model.named_parameters()]
    ref_params = agent_params_from_flax(ts.params)
    for name, p in rs.model.named_parameters():
        _close(p, ref_params[name], PARAM_RTOL, what=name, atol=PARAM_ATOL)
    ref_opt = ppo_opt_state_from_flax(ts.opt_state, names)
    assert int(rs.opt_state.count) == int(ref_opt.count)
    for moments, refs in ((rs.opt_state.mu, ref_opt.mu), (rs.opt_state.nu, ref_opt.nu)):
        for name, m, r in zip(names, moments, refs):
            _close(m, r, MOMENT_RTOL, MOMENT_ATOL_OF_MAX, name)
    jmetrics = jax.device_get(jmetrics)
    assert set(metrics) == set(jmetrics)
    for k, v in jmetrics.items():
        _close(metrics[k], v, METRIC_RTOL, what=k, atol=1e-7)


@pytest.fixture(scope="module")
def plain_update():
    return _JaxUpdate()


def test_update_from_rollout_matches_jax(plain_update):
    data, jrs_in, (jrs, jmetrics) = plain_update.run(plain_update.runner, seed=7)
    rs, metrics = _port_update(plain_update, jrs_in, data)
    assert int(jrs.train_state.step) == 4
    _compare(rs, metrics, jrs, jmetrics)
    for _, p in rs.model.named_parameters():
        assert p.requires_grad


def test_update_continues_from_a_converted_optax_state(plain_update):
    """A second JAX update (count 4, so the annealed rate is 2/3 of the
    peak) continued in the port from the JAX optimizer state converted."""
    _, _, (jrs1, _) = plain_update.run(plain_update.runner, seed=7)
    names = [n for n, _ in MultimodalRecurrentAgent(**AGENT, device="cpu").named_parameters()]
    opt = ppo_opt_state_from_flax(jax.device_get(jrs1.train_state.opt_state), names)
    adam = jax.device_get(jrs1.train_state.opt_state)[1][0]
    mu = agent_params_from_flax(adam.mu)
    assert int(opt.count) == 4 and all(torch.equal(m, mu[n]) for n, m in zip(names, opt.mu))
    data, jrs_in, (jrs2, jmetrics) = plain_update.run(jrs1, seed=8)
    rs, metrics = _port_update(plain_update, jrs_in, data)
    assert int(jrs2.train_state.step) == 8
    _compare(rs, metrics, jrs2, jmetrics)


def test_minibatches_must_divide_the_envs():
    model = MultimodalRecurrentAgent(**AGENT, device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        make_recurrent_ppo(Minecraft2d(device="cpu"), model, PPOConfig(num_envs=6, num_minibatches=4))


def test_update_stops_at_the_target_kl_as_jax_does():
    """target_kl crossed in epoch 1: epoch 1's update stands, epochs 2 and 3
    run on the frozen state with fresh permutations and are discarded, and
    the metrics are epoch 3's."""
    jupdate = _JaxUpdate(target_kl=1e-9, update_epochs=3)
    data, jrs_in, (jrs, jmetrics) = jupdate.run(jupdate.runner, seed=9)
    assert int(jrs.train_state.step) == 2  # only epoch 1's two minibatches
    rs, metrics = _port_update(jupdate, jrs_in, data)
    _compare(rs, metrics, jrs, jmetrics)

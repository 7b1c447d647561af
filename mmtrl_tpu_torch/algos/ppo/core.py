"""PPO on tensors; port of ``PPOConfig``, ``RunnerState``, ``make_ppo``
and ``make_recurrent_ppo`` of ``mmtrl_tpu/algos/ppo/core.py``.

One training iteration is the JAX program's three stages as Python loops
over tensors on the run's device:

  rollout -- ``num_steps`` agent steps, categorical samples, env steps and
             episode statistics;
  gae     -- the reverse loop of ``ops/gae.py``;
  update  -- ``update_epochs`` epochs of ``num_minibatches`` minibatches
             with a fresh permutation per epoch.  The feedforward variant
             (``make_ppo``) permutes all ``num_envs * num_steps`` rows of
             the flattened batch; the recurrent one permutes the env
             indices, and each minibatch replays its envs' whole sequences
             from the rollout's initial carry (the reference's
             sequence-preserving scheme, src/train.py:200-218), so the
             agent's LSTM runs ``num_steps`` steps forward and back per
             minibatch.

One ``torch.Generator`` on the run's device drives the env's reset draws,
the action samples and the permutations, in that order within an
iteration.  The optimizer is ``ops/fused_optim.py::fused_clip_adamw`` with
``weight_decay=0`` and ``eps=1e-5``: term for term JAX's
``optax.chain(clip_by_global_norm, adam(eps=1e-5))``, under the linear
anneal ``lr * (1 - (count // opt_steps_per_update) / num_updates)`` read at
the count before the increment.

``make_continuous_ppo`` is the feedforward loop with a diagonal-Gaussian
policy (``PolicyHead`` ``gaussian_head``): the rollout stores the
unclipped sample (``ClipAction`` clips only what the env sees), and with
``rpo_alpha`` each minibatch perturbs the mean by a fresh uniform draw
(RPO, cleanrl/rpo_continuous_action.py:130-136).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn

from mmtrl_tpu_torch.core.metrics import EpisodeStatistics
from mmtrl_tpu_torch.envs.base import Environment
from mmtrl_tpu_torch.models.distributions import (
    categorical_entropy,
    categorical_log_prob,
    categorical_sample,
    normal_entropy,
    normal_log_prob,
    normal_sample,
)
from mmtrl_tpu_torch.models.lstm import Carry
from mmtrl_tpu_torch.ops.fused_optim import (
    ScaleByAdamState,
    fused_clip_adamw,
    init_adam_state,
)
from mmtrl_tpu_torch.ops.gae import compute_gae

# (obs, actions, logprobs, rewards, dones, values), each (T, N, ...)
Rollout = Tuple[torch.Tensor, ...]


@dataclasses.dataclass
class PPOConfig:
    """Field for field the JAX ``PPOConfig``."""

    total_timesteps: int = 500_000
    learning_rate: float = 2.5e-4
    num_envs: int = 4
    num_steps: int = 128
    anneal_lr: bool = True
    gamma: float = 0.99
    gae_lambda: float = 0.95
    num_minibatches: int = 4
    update_epochs: int = 4
    norm_adv: bool = True
    clip_coef: float = 0.2
    clip_vloss: bool = True
    ent_coef: float = 0.01
    vf_coef: float = 0.5
    max_grad_norm: float = 0.5
    clip_rewards: bool = False  # sign-clip like SB3 ClipRewardEnv
    rpo_alpha: float = 0.0  # >0 enables RPO mean perturbation (continuous PPO)
    target_kl: Optional[float] = None  # early-stop epochs past this KL

    @property
    def batch_size(self) -> int:
        return self.num_envs * self.num_steps

    @property
    def minibatch_size(self) -> int:
        return self.batch_size // self.num_minibatches

    @property
    def num_updates(self) -> int:
        return self.total_timesteps // self.batch_size

    @property
    def opt_steps_per_update(self) -> int:
        """Optimizer steps per ``train_iteration``: the LR anneal quantum and
        the resume-time update-counter divisor."""
        return self.num_minibatches * self.update_epochs


def _cpu(x: torch.Tensor) -> torch.Tensor:
    return x.detach().cpu()


def runner_payload(x: Any) -> Any:
    """A runner (or one of its fields) as a checkpoint payload of plain
    tensors, lists and dicts on the CPU, loadable with
    ``torch.load(weights_only=True)``: a module as its state dict, a
    generator as its state, an Adam state as ``{count, mu, nu}``, a
    dataclass as a dict of its fields, a tuple as a list; numbers and
    dicts (of any of these) as they are."""
    if x is None or isinstance(x, (int, float)):
        return x
    if isinstance(x, dict):
        return {k: runner_payload(v) for k, v in x.items()}
    if isinstance(x, torch.Tensor):
        return _cpu(x)
    if isinstance(x, nn.Module):
        return {k: _cpu(v) for k, v in x.state_dict().items()}
    if isinstance(x, torch.Generator):
        return x.get_state()
    if isinstance(x, ScaleByAdamState):
        return {"count": _cpu(x.count), "mu": [_cpu(m) for m in x.mu],
                "nu": [_cpu(v) for v in x.nu]}
    if dataclasses.is_dataclass(x):
        return {f.name: runner_payload(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, tuple):
        return [runner_payload(v) for v in x]
    raise TypeError(f"no payload for {type(x).__name__}")


def load_runner_payload(template: Any, payload: Any) -> Any:
    """``template`` with every field taken from ``payload``, each tensor on
    its template's device; modules and generators are loaded in place."""
    if template is None:
        return None
    if isinstance(template, (int, float)):
        return type(template)(payload)
    if isinstance(template, dict):
        return {k: load_runner_payload(v, payload[k]) for k, v in template.items()}
    if isinstance(template, torch.Tensor):
        return payload.to(template.device)
    if isinstance(template, nn.Module):
        template.load_state_dict(payload)
        return template
    if isinstance(template, torch.Generator):
        template.set_state(payload.cpu())  # a CPU ByteTensor, any device
        return template
    if isinstance(template, ScaleByAdamState):
        device = template.count.device
        return ScaleByAdamState(payload["count"].to(device), [m.to(device) for m in payload["mu"]],
                                [v.to(device) for v in payload["nu"]])
    if dataclasses.is_dataclass(template):
        return type(template)(**{f.name: load_runner_payload(getattr(template, f.name),
                                                             payload[f.name])
                                 for f in dataclasses.fields(template)})
    if isinstance(template, tuple):
        return tuple(load_runner_payload(t, v) for t, v in zip(template, payload, strict=True))
    raise TypeError(f"no payload for {type(template).__name__}")


@dataclasses.dataclass
class RunnerState:
    """Everything an iteration carries: the agent (its parameters are the
    trained weights) and the optimizer state over ``model.parameters()`` in
    order, the env state, the current observation, the done flag that
    preceded it, the LSTM carry (``()`` for a feedforward agent), the episode
    statistics and the generator."""

    model: nn.Module
    opt_state: ScaleByAdamState
    env_state: Any
    obs: torch.Tensor  # (N, ...) current observation
    done: torch.Tensor  # (N,) done preceding the current obs
    carry: Carry
    stats: EpisodeStatistics
    generator: torch.Generator

    @property
    def step(self) -> torch.Tensor:
        return self.opt_state.count

    def payload(self) -> Dict[str, Any]:
        return runner_payload(self)

    def load_payload(self, payload: Dict[str, Any]) -> "RunnerState":
        return load_runner_payload(self, payload)


def lr_schedule(cfg: PPOConfig) -> Callable[[torch.Tensor], torch.Tensor] | float:
    """The reference's per-update linear decay, read from the count."""
    if not cfg.anneal_lr:
        return cfg.learning_rate
    steps_per_update = cfg.opt_steps_per_update

    def schedule(count: torch.Tensor) -> torch.Tensor:
        frac = 1.0 - (count // steps_per_update).float() / cfg.num_updates
        return cfg.learning_rate * frac

    return schedule


def _maybe_clip(cfg: PPOConfig, reward: torch.Tensor) -> torch.Tensor:
    return torch.sign(reward) if cfg.clip_rewards else reward


def _ppo_loss(
    cfg: PPOConfig,
    newlogprob: torch.Tensor,
    entropy: torch.Tensor,
    newvalue: torch.Tensor,
    logprob_old: torch.Tensor,
    advantages: torch.Tensor,
    returns: torch.Tensor,
    values_old: torch.Tensor,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Clip objective + clipped value loss + entropy bonus (reference:
    src/train.py:232-253).  Advantages are normalized by their population
    standard deviation, as ``jnp.std`` computes it."""
    logratio = newlogprob - logprob_old
    ratio = torch.exp(logratio)
    approx_kl = ((ratio - 1.0) - logratio).mean()

    if cfg.norm_adv:
        advantages = (advantages - advantages.mean()) / (advantages.std(correction=0) + 1e-8)

    pg_loss1 = -advantages * ratio
    pg_loss2 = -advantages * torch.clamp(ratio, 1 - cfg.clip_coef, 1 + cfg.clip_coef)
    pg_loss = torch.maximum(pg_loss1, pg_loss2).mean()

    if cfg.clip_vloss:
        v_clipped = values_old + torch.clamp(newvalue - values_old, -cfg.clip_coef, cfg.clip_coef)
        v_loss = 0.5 * torch.maximum((newvalue - returns) ** 2, (v_clipped - returns) ** 2).mean()
    else:
        v_loss = 0.5 * ((newvalue - returns) ** 2).mean()

    entropy_loss = entropy.mean()
    loss = pg_loss - cfg.ent_coef * entropy_loss + v_loss * cfg.vf_coef
    clipfrac = ((ratio - 1.0).abs() > cfg.clip_coef).float().mean()
    metrics = {
        "losses/policy_loss": pg_loss,
        "losses/value_loss": v_loss,
        "losses/entropy": entropy_loss,
        "losses/approx_kl": approx_kl,
        "losses/clipfrac": clipfrac,
    }
    return loss, metrics


def _explained_variance(values: torch.Tensor, returns: torch.Tensor) -> torch.Tensor:
    """Population variances, as ``jnp.var``; NaN when the returns are flat."""
    var_y = returns.var(correction=0)
    return torch.where(var_y == 0, torch.nan, 1 - (returns - values).var(correction=0) / var_y)


Metrics = Dict[str, torch.Tensor]


def draw_perm(generator: torch.Generator, n: int, perms: Optional[Sequence[torch.Tensor]],
              epoch: int, shape: Tuple[int, int], device: torch.device) -> torch.Tensor:
    """The epoch's permutation of ``range(n)`` as ``shape`` (minibatches x
    rows): from the generator, or ``perms[epoch]`` when a test replays
    another implementation's draws."""
    if perms is None:
        perm = torch.randperm(n, generator=generator, device=generator.device)
    else:
        perm = perms[epoch]
    return perm.to(device).reshape(shape)


def grads_of(loss: torch.Tensor, params: Sequence[torch.Tensor],
             allow_unused: bool = False) -> List[torch.Tensor]:
    """d loss / d params.  A parameter the loss does not reach raises,
    unless ``allow_unused``: then its gradient is zeros, as ``jax.grad``
    gives it (PPG's aux head in the policy phase)."""
    grads = torch.autograd.grad(loss, params, allow_unused=allow_unused)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]


def run_epochs(
    epochs: int,
    target_kl: Optional[float],
    params: Sequence[torch.Tensor],
    opt_state: Any,
    perm_of: Callable[[int], torch.Tensor],
    minibatch_step: Callable[[Any, torch.Tensor], Tuple[Any, Metrics]],
) -> Tuple[Any, Metrics]:
    """``epochs`` epochs of ``minibatch_step(opt_state, idx)`` over the rows
    of ``perm_of(epoch)``; returns the optimizer state and the last
    minibatch's metrics.  With ``target_kl``: after an epoch's last
    minibatch crossed it, each later epoch still runs, from the frozen
    state, and its update is discarded (its metrics stay), as JAX's
    ``_kl_epoch_scan`` does."""
    stop, metrics = False, {}
    for epoch in range(epochs):
        perm = perm_of(epoch)
        frozen = ([p.detach().clone() for p in params], opt_state) if stop else None
        for idx in perm:
            opt_state, metrics = minibatch_step(opt_state, idx)
        if frozen is not None:
            with torch.no_grad():
                for p, saved in zip(params, frozen[0]):
                    p.copy_(saved)
            opt_state = frozen[1]
        elif target_kl is not None:
            stop = bool(metrics["losses/approx_kl"] > target_kl)
    return opt_state, {k: v.detach() for k, v in metrics.items()}


def ppo_step(cfg: PPOConfig, schedule, params: Sequence[torch.Tensor], opt_state: ScaleByAdamState,
             loss: torch.Tensor, allow_unused: bool = False) -> ScaleByAdamState:
    """One clipped, annealed Adam step of the PPO optimizer on ``loss``
    (``allow_unused`` as in ``grads_of``)."""
    return fused_clip_adamw(params, grads_of(loss, params, allow_unused), opt_state, schedule,
                            eps=1e-5, weight_decay=0.0, max_grad_norm=cfg.max_grad_norm)


# =============================================================================
# Feedforward PPO: discrete (categorical) and continuous (diagonal Gaussian)
# =============================================================================
class PolicyHead(NamedTuple):
    """How the feedforward loop reads its agent: ``act(model, obs,
    generator) -> (action, logprob, value)`` in the rollout, ``terms(model,
    obs, action, generator) -> (logprob, entropy, value)`` on a minibatch,
    ``value(model, obs)`` for the bootstrap."""

    act: Callable[..., Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]
    terms: Callable[..., Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]
    value: Callable[[nn.Module, torch.Tensor], torch.Tensor]


def _categorical_act(model, obs, generator):
    logits, value = model(obs)[:2]
    action = categorical_sample(generator, logits)
    return action, categorical_log_prob(logits, action), value


def _categorical_terms(model, obs, action, generator):
    logits, value = model(obs)[:2]
    return categorical_log_prob(logits, action), categorical_entropy(logits), value


# ``model(obs) -> (logits, value, ...)``
CATEGORICAL = PolicyHead(_categorical_act, _categorical_terms, lambda model, obs: model(obs)[1])


def gaussian_head(rpo_alpha: float = 0.0,
                  rpo_noise: Optional[Sequence[torch.Tensor]] = None) -> PolicyHead:
    """``model(obs) -> (mean, log_std, value)``.  With ``rpo_alpha`` each
    minibatch adds ``U(-rpo_alpha, rpo_alpha)`` noise of the mean's shape
    to the mean before the stored actions' log-probabilities: drawn from
    the generator as ``jax.random.uniform`` with ``minval`` and ``maxval``
    draws it, or taken in turn from ``rpo_noise`` (one tensor per
    minibatch, in order) when a test replays another implementation's."""
    replay = None if rpo_noise is None else list(rpo_noise)

    def act(model, obs, generator):
        mean, log_std, value = model(obs)
        action = normal_sample(generator, mean, log_std)
        return action, normal_log_prob(mean, log_std, action), value

    def terms(model, obs, action, generator):
        mean, log_std, value = model(obs)
        if rpo_alpha > 0:
            if replay is None:
                u = torch.rand(mean.shape, generator=generator, device=mean.device,
                               dtype=mean.dtype)
                noise = torch.clamp(u * (2 * rpo_alpha) - rpo_alpha, min=-rpo_alpha)
            else:
                noise = replay.pop(0).to(mean.device, mean.dtype)
            mean = mean + noise
        return normal_log_prob(mean, log_std, action), normal_entropy(log_std), value

    return PolicyHead(act, terms, lambda model, obs: model(obs)[2])


@dataclasses.dataclass
class FeedforwardPPO:
    """The functions of ``make_ppo`` and ``make_continuous_ppo``, by name;
    ``rollout`` is the first half of ``train_iteration``,
    ``update_from_rollout`` the second; ``env`` the env they step."""

    init_runner: Callable[[torch.Generator], RunnerState]
    rollout: Callable[[RunnerState], Tuple[RunnerState, Rollout]]
    train_iteration: Callable[[RunnerState], Tuple[RunnerState, Metrics]]
    update_from_rollout: Callable[..., Tuple[RunnerState, Metrics]]
    env: Environment


def init_feedforward_runner(env: Environment, model: nn.Module, num_envs: int,
                            generator: torch.Generator) -> RunnerState:
    obs, env_state = env.reset(num_envs, generator)
    return RunnerState(
        model=model,
        opt_state=init_adam_state(list(model.parameters())),
        env_state=env_state,
        obs=obs,
        done=torch.zeros(num_envs, dtype=torch.bool, device=obs.device),
        carry=(),
        stats=EpisodeStatistics.create(num_envs, obs.device),
        generator=generator,
    )


def feedforward_rollout(env: Environment, cfg: PPOConfig, rs: RunnerState,
                        head: PolicyHead = CATEGORICAL) -> Tuple[RunnerState, Rollout]:
    """``num_steps`` steps of ``head.act``; the actions are stored as the
    policy drew them."""
    T, N = cfg.num_steps, cfg.num_envs
    device = rs.obs.device
    obs = torch.empty((T,) + tuple(rs.obs.shape), dtype=rs.obs.dtype, device=device)
    logprobs, rewards, values = (torch.empty((T, N), device=device) for _ in range(3))
    dones = torch.empty((T, N), dtype=torch.bool, device=device)
    actions = None
    env_state, o, done, stats = rs.env_state, rs.obs, rs.done, rs.stats
    for t in range(T):
        with torch.no_grad():
            action, logprob, value = head.act(rs.model, o, rs.generator)
        if actions is None:
            actions = torch.empty((T,) + tuple(action.shape), dtype=action.dtype, device=device)
        obs[t], actions[t], dones[t], values[t], logprobs[t] = o, action, done, value, logprob
        o, env_state, reward, done, info = env.step(env_state, action, rs.generator)
        # Episode statistics take the RAW reward when a reward-transforming
        # wrapper reports one (src/train.py:52-57); the loss the clipped one.
        stats = stats.update(info.get("raw_reward", reward), done)
        rewards[t] = _maybe_clip(cfg, reward)
    rs = dataclasses.replace(rs, env_state=env_state, obs=o, done=done, stats=stats)
    return rs, (obs, actions, logprobs, rewards, dones, values)


def feedforward_update(cfg: PPOConfig, rs: RunnerState, rollout: Rollout,
                       perms: Optional[Sequence[torch.Tensor]] = None,
                       allow_unused: bool = False, head: PolicyHead = CATEGORICAL
                       ) -> Tuple[RunnerState, Metrics, torch.Tensor]:
    """GAE and ``cfg.update_epochs`` epochs over permutations of all
    ``batch_size`` rows; returns the runner, the last minibatch's metrics
    and the (T, N) returns.  ``allow_unused`` gives a parameter that the
    loss does not reach a zero gradient (PPG's aux head)."""
    obs, actions, logprobs, rewards, dones, values = rollout
    model = rs.model
    with torch.no_grad():
        next_value = head.value(model, rs.obs)
    advantages, returns = compute_gae(rewards, values, dones, next_value, rs.done,
                                      cfg.gamma, cfg.gae_lambda)
    batch = tuple(x.reshape((cfg.batch_size,) + x.shape[2:])
                  for x in (obs, actions, logprobs, advantages, returns, values))
    params = list(model.parameters())
    schedule = lr_schedule(cfg)

    def minibatch_step(opt_state, idx):
        b_obs, b_act, b_logp, b_adv, b_ret, b_val = (x[idx] for x in batch)
        newlogprob, entropy, newvalue = head.terms(model, b_obs, b_act, rs.generator)
        loss, metrics = _ppo_loss(cfg, newlogprob, entropy, newvalue, b_logp, b_adv, b_ret,
                                  b_val)
        return ppo_step(cfg, schedule, params, opt_state, loss, allow_unused), metrics

    shape = (cfg.num_minibatches, cfg.minibatch_size)
    opt_state, metrics = run_epochs(
        cfg.update_epochs, cfg.target_kl, params, rs.opt_state,
        lambda e: draw_perm(rs.generator, cfg.batch_size, perms, e, shape, obs.device),
        minibatch_step)
    return dataclasses.replace(rs, opt_state=opt_state), metrics, returns


def _feedforward_ppo(env: Environment, model: nn.Module, cfg: PPOConfig,
                     head_of: Callable[..., PolicyHead]) -> FeedforwardPPO:
    def update_from_rollout(rs: RunnerState, rollout: Rollout,
                            perms: Optional[Sequence[torch.Tensor]] = None, **draws):
        """PPO update from a completed rollout; ``rs`` carries the
        post-rollout obs and done for the value bootstrap.  ``perms`` (one
        permutation of ``range(batch_size)`` per epoch) replaces the
        generator's draws, so a test can replay another implementation's."""
        rs, metrics, returns = feedforward_update(cfg, rs, rollout, perms, head=head_of(**draws))
        metrics["losses/explained_variance"] = _explained_variance(rollout[5].reshape(-1),
                                                                   returns.reshape(-1))
        return rs, metrics

    def train_iteration(rs: RunnerState):
        rs, data = feedforward_rollout(env, cfg, rs, head_of())
        return update_from_rollout(rs, data)

    return FeedforwardPPO(
        init_runner=lambda generator: init_feedforward_runner(env, model, cfg.num_envs, generator),
        rollout=lambda rs: feedforward_rollout(env, cfg, rs, head_of()),
        train_iteration=train_iteration,
        update_from_rollout=update_from_rollout,
        env=env,
    )


def make_ppo(env: Environment, model: nn.Module, cfg: PPOConfig) -> FeedforwardPPO:
    """``model(obs (N, ...)) -> (logits, value)``; minibatches are
    permutations of the flattened (T * N) batch.  ``init_runner`` takes
    ``model``; the other functions use the runner's own model."""
    return _feedforward_ppo(env, model, cfg, lambda: CATEGORICAL)


def make_continuous_ppo(env: Environment, model: nn.Module, cfg: PPOConfig) -> FeedforwardPPO:
    """``model(obs) -> (mean, log_std, value)``: ``make_ppo``'s loop with a
    diagonal-Gaussian policy, RPO's mean noise with ``cfg.rpo_alpha``.
    ``update_from_rollout(rs, rollout, perms, rpo_noise=...)`` takes the
    minibatches' RPO draws in order (epoch by epoch) in place of the
    generator's."""
    return _feedforward_ppo(env, model, cfg,
                            lambda rpo_noise=None: gaussian_head(cfg.rpo_alpha, rpo_noise))


# =============================================================================
# Recurrent (LSTM) PPO
# =============================================================================
@dataclasses.dataclass
class RecurrentPPO:
    """The functions of ``make_recurrent_ppo``, by name (JAX returns them in
    an ``AlgoParts`` tuple); ``rollout`` is the first half of
    ``train_iteration``, ``update_from_rollout`` the second."""

    init_runner: Callable[..., RunnerState]
    rollout: Callable[[RunnerState], Tuple[RunnerState, Rollout]]
    train_iteration: Callable[[RunnerState], Tuple[RunnerState, Metrics]]
    update_from_rollout: Callable[..., Tuple[RunnerState, Metrics]]
    policy_step: Callable[..., Tuple[torch.Tensor, ...]]


def make_recurrent_ppo(env: Environment, model: nn.Module, cfg: PPOConfig) -> RecurrentPPO:
    """``model(obs (T, B, ...), done (T, B), carry) -> (logits, value,
    carry)``; minibatching is over env indices so each minibatch replays
    full sequences from the rollout's initial carry (reference:
    src/train.py:200-218).  ``init_runner`` takes ``model``; the other
    functions use the runner's own model.  ``env`` may be a native pool
    (``envs/skeleton_native.py``): its ``step`` copies each action to the
    host, one sync a rollout step, as JAX's ordered ``io_callback`` does."""
    if cfg.num_envs % cfg.num_minibatches:
        raise ValueError("recurrent PPO needs num_envs divisible by num_minibatches "
                         "(sequence-preserving minibatches)")
    envs_per_batch = cfg.num_envs // cfg.num_minibatches
    schedule = lr_schedule(cfg)

    def init_runner(generator: torch.Generator) -> RunnerState:
        obs, env_state = env.reset(cfg.num_envs, generator)
        return RunnerState(
            model=model,
            opt_state=init_adam_state(list(model.parameters())),
            env_state=env_state,
            obs=obs,
            done=torch.zeros(cfg.num_envs, dtype=torch.bool, device=obs.device),
            carry=model.initial_carry(cfg.num_envs, obs.device),
            stats=EpisodeStatistics.create(cfg.num_envs, obs.device),
            generator=generator,
        )

    @torch.no_grad()
    def policy_step(agent: nn.Module, obs: torch.Tensor, done: torch.Tensor, carry: Carry,
                    generator: Optional[torch.Generator]):
        """One behaviour-policy step: (action, logprob, value, carry)."""
        logits, value, new_carry = agent(obs[None], done[None], carry)
        action = categorical_sample(generator, logits[0])
        return action, categorical_log_prob(logits[0], action), value[0], new_carry

    def rollout(rs: RunnerState) -> Tuple[RunnerState, Rollout]:
        T, N = cfg.num_steps, cfg.num_envs
        device = rs.obs.device
        obs = torch.empty((T,) + tuple(rs.obs.shape), dtype=rs.obs.dtype, device=device)
        actions = torch.empty((T, N), dtype=torch.long, device=device)
        logprobs, rewards, values = (torch.empty((T, N), device=device) for _ in range(3))
        dones = torch.empty((T, N), dtype=torch.bool, device=device)
        env_state, o, done, carry, stats = rs.env_state, rs.obs, rs.done, rs.carry, rs.stats
        for t in range(T):
            action, logprob, value, carry = policy_step(rs.model, o, done, carry, rs.generator)
            obs[t], actions[t], logprobs[t], dones[t], values[t] = o, action, logprob, done, value
            o, env_state, reward, done, info = env.step(env_state, action, rs.generator)
            stats = stats.update(info.get("raw_reward", reward), done)
            rewards[t] = _maybe_clip(cfg, reward)
        rs = dataclasses.replace(rs, env_state=env_state, obs=o, done=done, carry=carry,
                                 stats=stats)
        return rs, (obs, actions, logprobs, rewards, dones, values)

    def update_from_rollout(
        rs: RunnerState, initial_carry: Carry, rollout: Rollout,
        perms: Optional[Sequence[torch.Tensor]] = None,
    ) -> Tuple[RunnerState, Metrics]:
        """PPO update from a completed rollout.  ``rs`` carries the
        post-rollout (obs, done, carry) for the value bootstrap; ``rollout``
        is time-major (T, N, ...).  ``perms`` (one permutation of the env
        indices per epoch) replaces the generator's draws, so a test can
        replay another implementation's."""
        obs, actions, logprobs, rewards, dones, values = rollout
        model = rs.model
        with torch.no_grad():
            _, next_value, _ = model(rs.obs[None], rs.done[None], rs.carry)
        advantages, returns = compute_gae(rewards, values, dones, next_value[0], rs.done,
                                          cfg.gamma, cfg.gae_lambda)
        params = list(model.parameters())

        def minibatch_step(opt_state, idx):
            logits, newvalue, _ = model(obs[:, idx], dones[:, idx],
                                        tuple(c[idx] for c in initial_carry))
            loss, metrics = _ppo_loss(
                cfg,
                categorical_log_prob(logits, actions[:, idx]).reshape(-1),
                categorical_entropy(logits).reshape(-1),
                newvalue.reshape(-1),
                logprobs[:, idx].reshape(-1),
                advantages[:, idx].reshape(-1),
                returns[:, idx].reshape(-1),
                values[:, idx].reshape(-1),
            )
            return ppo_step(cfg, schedule, params, opt_state, loss), metrics

        shape = (cfg.num_minibatches, envs_per_batch)
        opt_state, metrics = run_epochs(
            cfg.update_epochs, cfg.target_kl, params, rs.opt_state,
            lambda e: draw_perm(rs.generator, cfg.num_envs, perms, e, shape, obs.device),
            minibatch_step)
        metrics["losses/explained_variance"] = _explained_variance(values.reshape(-1),
                                                                   returns.reshape(-1))
        return dataclasses.replace(rs, opt_state=opt_state), metrics

    def train_iteration(rs: RunnerState) -> Tuple[RunnerState, Metrics]:
        initial_carry = rs.carry
        rs, data = rollout(rs)
        return update_from_rollout(rs, initial_carry, data)

    return RecurrentPPO(init_runner, rollout, train_iteration, update_from_rollout, policy_step)

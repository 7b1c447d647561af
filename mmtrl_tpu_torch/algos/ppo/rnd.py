"""PPO + Random Network Distillation on tensors; port of
``mmtrl_tpu/algos/ppo/rnd.py`` (the reference's cleanrl/ppo_rnd_envpool.py).

Curiosity: a fixed random target network and a trained predictor network;
the intrinsic reward is their prediction error on running-normalized
observations (reference :361-369).  Dual value heads with separate gammas;
the intrinsic returns are non-episodic.  Kept from the JAX module, each the
reference's own behaviour:

- the rollout's intrinsic rewards use the observation statistics from
  BEFORE the rollout; the statistics are then updated from all T x N
  observations, and the predictor's inputs are normalized with the
  updated ones;
- intrinsic rewards are divided by the standard deviation of the
  discounted forward filter (RewardForwardFilter + RunningMeanStd,
  :231-236);
- the predictor's optimizer is plain Adam (lr, eps 1e-5): no gradient
  clipping and no learning-rate anneal; the policy's is the clipped,
  annealed PPO optimizer;
- the predictor loss takes a random ``update_proportion`` of each
  minibatch (:374-380).

One ``torch.Generator`` drives, in order, the rollout's draws, then per
epoch the permutation and per minibatch the predictor mask's uniforms.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mmtrl_tpu_torch import DeviceLike, resolve_device
from mmtrl_tpu_torch.algos.ppo.core import (
    PPOConfig,
    draw_perm,
    grads_of,
    load_runner_payload,
    lr_schedule,
    run_epochs,
    runner_payload,
)
from mmtrl_tpu_torch.core.metrics import EpisodeStatistics
from mmtrl_tpu_torch.envs.base import Environment
from mmtrl_tpu_torch.envs.wrappers import RunningStat
from mmtrl_tpu_torch.models.common import AtariTower, Dense, MLPTower
from mmtrl_tpu_torch.models.distributions import (
    categorical_entropy,
    categorical_log_prob,
    categorical_sample,
)
from mmtrl_tpu_torch.ops.fused_optim import ScaleByAdamState, fused_clip_adamw, init_adam_state
from mmtrl_tpu_torch.ops.gae import compute_gae

# (obs, actions, logprobs, rewards, int_rewards, dones, v_ext, v_int,
#  next_obs), each (T, N, ...)
RNDRollout = Tuple[torch.Tensor, ...]
# (obs_stat, reward_stat, forward_filter) after a rollout
RNDStatistics = Tuple[RunningStat, RunningStat, torch.Tensor]


@dataclasses.dataclass
class RNDConfig(PPOConfig):
    int_coef: float = 1.0
    ext_coef: float = 2.0
    int_gamma: float = 0.99
    update_proportion: float = 0.25  # fraction of batch used for predictor loss


def _is_image(obs_shape: Sequence[int]) -> bool:
    """The JAX modules branch on ``obs.ndim >= 4`` of a batch."""
    return len(obs_shape) >= 3


class RNDAgent(nn.Module):
    """Policy with dual value heads (ext + int), image or vector obs:
    obs (N, ...) -> logits (N, A), v_ext (N,), v_int (N,)."""

    def __init__(self, num_actions: int, obs_shape: Sequence[int], input_scale: float = 1.0,
                 device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        self.input_scale = input_scale
        if _is_image(obs_shape):
            self.network = AtariTower("big", obs_shape[0], device=device)
        else:
            self.network = MLPTower(obs_shape[0], (64, 64), device=device)
        f = self.network.feature_size
        self.actor = Dense(f, num_actions, scale=0.01, device=device)
        self.critic_ext = Dense(f, 1, scale=0.01, device=device)
        self.critic_int = Dense(f, 1, scale=0.01, device=device)

    def forward(self, obs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        if isinstance(self.network, AtariTower):
            feat = self.network(obs / self.input_scale)
        else:
            feat = self.network(obs)
        return self.actor(feat), self.critic_ext(feat)[..., 0], self.critic_int(feat)[..., 0]


class RNDNetwork(nn.Module):
    """Target/predictor embedding network (reference RNDModel:183-226):
    the small tower (or a relu MLP), then for the predictor an extra
    ``Dense(256)`` + relu, then ``Dense(out_dim)``; flax numbers the Dense
    layers it creates, so the last is ``Dense_1`` in the predictor and
    ``Dense_0`` in the target."""

    def __init__(self, obs_shape: Sequence[int], out_dim: int = 256, predictor: bool = False,
                 device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        if _is_image(obs_shape):
            self.trunk = AtariTower("small", obs_shape[0], device=device)
        else:
            self.trunk = MLPTower(obs_shape[0], (64, 64), activation="relu", device=device)
        f = self.trunk.feature_size
        self.predictor = predictor
        if predictor:
            self.Dense_0 = Dense(f, 256, device=device)
            self.Dense_1 = Dense(256, out_dim, device=device)
        else:
            self.Dense_0 = Dense(f, out_dim, device=device)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        x = self.trunk(obs)
        if self.predictor:
            return self.Dense_1(F.relu(self.Dense_0(x)))
        return self.Dense_0(x)


@dataclasses.dataclass
class RNDRunner:
    """Everything an RND iteration carries (JAX ``RNDRunner``): the agent
    and its optimizer state, the predictor and its own Adam state, the
    fixed target, the env state, the current obs and the done before it,
    the observation and intrinsic-reward statistics, the (N,) forward
    filter, the episode statistics and the generator."""

    model: nn.Module
    opt_state: ScaleByAdamState
    predictor: nn.Module
    predictor_opt_state: ScaleByAdamState
    target: nn.Module
    env_state: Any
    obs: torch.Tensor
    done: torch.Tensor
    obs_stat: RunningStat
    reward_stat: RunningStat
    forward_filter: torch.Tensor
    stats: EpisodeStatistics
    generator: torch.Generator

    @property
    def step(self) -> torch.Tensor:
        return self.opt_state.count

    def payload(self) -> Dict[str, Any]:
        return runner_payload(self)

    def load_payload(self, payload: Dict[str, Any]) -> "RNDRunner":
        return load_runner_payload(self, payload)


@dataclasses.dataclass
class RNDPPO:
    """The functions of ``make_rnd_ppo``, by name; ``rollout`` is the first
    half of ``train_iteration``, ``update_from_rollout`` the second."""

    init_runner: Callable[[torch.Generator], "RNDRunner"]
    rollout: Callable[["RNDRunner"], Tuple["RNDRunner", RNDRollout]]
    train_iteration: Callable[["RNDRunner"], Tuple["RNDRunner", Dict[str, torch.Tensor]]]
    update_from_rollout: Callable[..., Tuple["RNDRunner", Dict[str, torch.Tensor]]]
    statistics: Callable[["RNDRunner", RNDRollout], RNDStatistics]


def make_rnd_ppo(env: Environment, model: RNDAgent, cfg: RNDConfig,
                 target: Optional[RNDNetwork] = None,
                 predictor: Optional[RNDNetwork] = None) -> RNDPPO:
    """``target`` and ``predictor`` default to fresh networks on the
    model's device (from the global RNG); the target is never trained."""
    obs_shape = tuple(env.observation_space.shape)
    device = next(model.parameters()).device
    target = target or RNDNetwork(obs_shape, device=device)
    predictor = predictor or RNDNetwork(obs_shape, predictor=True, device=device)
    target.requires_grad_(False)
    schedule = lr_schedule(cfg)

    def init_runner(generator: torch.Generator) -> RNDRunner:
        obs, env_state = env.reset(cfg.num_envs, generator)
        return RNDRunner(
            model=model,
            opt_state=init_adam_state(list(model.parameters())),
            predictor=predictor,
            predictor_opt_state=init_adam_state(list(predictor.parameters())),
            target=target,
            env_state=env_state,
            obs=obs,
            done=torch.zeros(cfg.num_envs, dtype=torch.bool, device=obs.device),
            obs_stat=RunningStat.create(obs_shape, obs.device),
            reward_stat=RunningStat.create((), obs.device),
            forward_filter=torch.zeros(cfg.num_envs, device=obs.device),
            stats=EpisodeStatistics.create(cfg.num_envs, obs.device),
            generator=generator,
        )

    @torch.no_grad()
    def intrinsic_reward(rs: RNDRunner, obs: torch.Tensor) -> torch.Tensor:
        norm_obs = rs.obs_stat.normalize(obs).clamp(-5.0, 5.0)
        return ((rs.target(norm_obs) - rs.predictor(norm_obs)) ** 2).sum(-1) / 2.0

    def rollout(rs: RNDRunner) -> Tuple[RNDRunner, RNDRollout]:
        T, N = cfg.num_steps, cfg.num_envs
        device = rs.obs.device
        obs, next_obs = (torch.empty((T,) + tuple(rs.obs.shape), dtype=rs.obs.dtype,
                                     device=device) for _ in range(2))
        actions = torch.empty((T, N), dtype=torch.long, device=device)
        logprobs, rewards, int_rewards, v_ext, v_int = (
            torch.empty((T, N), device=device) for _ in range(5))
        dones = torch.empty((T, N), dtype=torch.bool, device=device)
        env_state, o, done, stats = rs.env_state, rs.obs, rs.done, rs.stats
        for t in range(T):
            with torch.no_grad():
                logits, v_ext[t], v_int[t] = rs.model(o)
            action = categorical_sample(rs.generator, logits)
            obs[t], actions[t], dones[t] = o, action, done
            logprobs[t] = categorical_log_prob(logits, action)
            o, env_state, rewards[t], done, _ = env.step(env_state, action, rs.generator)
            int_rewards[t] = intrinsic_reward(rs, o)  # the pre-rollout obs_stat
            next_obs[t] = o
            stats = stats.update(rewards[t], done)
        rs = dataclasses.replace(rs, env_state=env_state, obs=o, done=done, stats=stats)
        return rs, (obs, actions, logprobs, rewards, int_rewards, dones, v_ext, v_int, next_obs)

    def statistics(rs: RNDRunner, data: RNDRollout) -> RNDStatistics:
        """The runner's observation statistics, intrinsic-reward statistics
        and forward filter, updated from a rollout (reference
        RewardForwardFilter + RunningMeanStd, :231-236,361-369)."""
        obs, int_rewards = data[0], data[4]
        obs_stat = rs.obs_stat.update(obs.reshape((-1,) + obs.shape[2:]))
        filt, series = rs.forward_filter, []
        for r in int_rewards:
            filt = filt * cfg.int_gamma + r
            series.append(filt)
        return obs_stat, rs.reward_stat.update(torch.stack(series).reshape(-1)), filt

    def update_from_rollout(
        rs: RNDRunner, data: RNDRollout,
        perms: Optional[Sequence[torch.Tensor]] = None,
        mask_uniforms: Optional[Sequence[Sequence[torch.Tensor]]] = None,
        stats: Optional[RNDStatistics] = None,
    ) -> Tuple[RNDRunner, Dict[str, torch.Tensor]]:
        """The statistics, both GAEs and ``update_epochs`` epochs of
        minibatch steps of both optimizers.  ``perms`` (one permutation of
        ``range(batch_size)`` per epoch) and ``mask_uniforms`` (per epoch,
        per minibatch, ``minibatch_size`` uniforms in [0, 1)) replace the
        generator's draws, and ``stats`` (``statistics(rs, data)``) their
        computation, so a test can replay another implementation's.  (An
        observation element constant over the batch has a variance of a few
        float32 roundings, and the normalization divides by sqrt(var +
        1e-8): two summation orders give predictor inputs 1e4 roundings
        apart there.)"""
        obs, actions, logprobs, rewards, int_rewards, dones, v_ext, v_int, next_obs = data
        obs_stat, reward_stat, filt = stats or statistics(rs, data)
        int_rewards = int_rewards / torch.sqrt(reward_stat.var + 1e-8)

        model, pred_net, target_net = rs.model, rs.predictor, rs.target
        with torch.no_grad():
            _, next_v_ext, next_v_int = model(rs.obs)
        ext_adv, ext_ret = compute_gae(torch.sign(rewards) if cfg.clip_rewards else rewards,
                                       v_ext, dones, next_v_ext, rs.done, cfg.gamma,
                                       cfg.gae_lambda)
        # the intrinsic stream is non-episodic: its dones are zeros
        int_adv, int_ret = compute_gae(int_rewards, v_int, torch.zeros_like(dones), next_v_int,
                                       torch.zeros_like(rs.done), cfg.int_gamma, cfg.gae_lambda)
        advantages = ext_adv * cfg.ext_coef + int_adv * cfg.int_coef

        def flat(x):
            return x.reshape((cfg.batch_size,) + x.shape[2:])

        norm_next = obs_stat.normalize(flat(next_obs)).clamp(-5.0, 5.0)
        batch = tuple(map(flat, (obs, actions, logprobs, advantages, ext_ret, int_ret)))
        batch += (norm_next,)
        params, pred_params = list(model.parameters()), list(pred_net.parameters())
        n_params = len(params)
        replayed = None if mask_uniforms is None else iter(
            [u for epoch in mask_uniforms for u in epoch])

        def minibatch_step(opt_states, idx):
            b_obs, b_act, b_logp, b_adv, b_eret, b_iret, b_norm_next = (x[idx] for x in batch)
            logits, newv_ext, newv_int = model(b_obs)
            newlogprob = categorical_log_prob(logits, b_act)
            entropy = categorical_entropy(logits)
            adv = ((b_adv - b_adv.mean()) / (b_adv.std(correction=0) + 1e-8)
                   if cfg.norm_adv else b_adv)
            ratio = torch.exp(newlogprob - b_logp)
            pg = torch.maximum(-adv * ratio,
                               -adv * ratio.clamp(1 - cfg.clip_coef, 1 + cfg.clip_coef)).mean()
            v_loss = 0.5 * (((newv_ext - b_eret) ** 2).mean() + ((newv_int - b_iret) ** 2).mean())
            # predictor distillation on a random subset (reference :374-380)
            with torch.no_grad():
                target_out = target_net(b_norm_next)
            fwd_err = ((pred_net(b_norm_next) - target_out) ** 2).mean(-1)
            if replayed is None:
                u = torch.rand(fwd_err.shape, generator=rs.generator, device=rs.generator.device)
            else:
                u = next(replayed)
            mask = (u.to(fwd_err.device) < cfg.update_proportion).float()
            fwd_loss = (fwd_err * mask).sum() / mask.sum().clamp(min=1.0)
            loss = pg - cfg.ent_coef * entropy.mean() + v_loss * cfg.vf_coef + fwd_loss
            grads = grads_of(loss, params + pred_params)
            opt_state = fused_clip_adamw(params, grads[:n_params], opt_states[0], schedule,
                                         eps=1e-5, weight_decay=0.0,
                                         max_grad_norm=cfg.max_grad_norm)
            pred_state = fused_clip_adamw(pred_params, grads[n_params:], opt_states[1],
                                          cfg.learning_rate, eps=1e-5, weight_decay=0.0,
                                          max_grad_norm=None)
            return (opt_state, pred_state), {
                "losses/policy_loss": pg, "losses/value_loss": v_loss,
                "losses/fwd_loss": fwd_loss, "losses/entropy": entropy.mean()}

        shape = (cfg.num_minibatches, cfg.minibatch_size)
        (opt_state, pred_state), metrics = run_epochs(
            cfg.update_epochs, None, params, (rs.opt_state, rs.predictor_opt_state),
            lambda e: draw_perm(rs.generator, cfg.batch_size, perms, e, shape, obs.device),
            minibatch_step)
        metrics["charts/mean_int_reward"] = int_rewards.mean()
        rs = dataclasses.replace(rs, opt_state=opt_state, predictor_opt_state=pred_state,
                                 obs_stat=obs_stat, reward_stat=reward_stat,
                                 forward_filter=filt)
        return rs, metrics

    def train_iteration(rs: RNDRunner):
        rs, data = rollout(rs)
        return update_from_rollout(rs, data)

    return RNDPPO(init_runner, rollout, train_iteration, update_from_rollout, statistics)

"""DDPG, and the fused loop that DDPG, TD3 and SAC share; port of
``mmtrl_tpu/algos/offpolicy/ddpg.py`` (the reference's
cleanrl/ddpg_continuous_action(_jax).py).

Each network is a ``dqn.DQNTrainState``: the module (its parameters are the
trained weights), its target copy and its ``optax.adam`` state, stepped by
``dqn.adam_step`` and synced by ``dqn.sync_target`` (``tau * params +
(1 - tau) * target``, ``optax.incremental_update``).

``make_actor_critic_loop`` is JAX's scanned ``train_iteration`` as a
Python loop over ``steps_per_iteration`` env steps.  A step draws the
exploring action's normals and a uniform action, both every step as JAX
does; acts uniformly while the step count before the step is below
``learning_starts``; steps the env; and ``insert_update``s: stores the
transitions and, once the count after the step is past
``learning_starts``, samples a batch and runs the algorithm's update,
whose cadences read ``global_step // num_envs``.  The global step is a
host integer, so the cadences cost no copy from the device.  As in JAX,
an iteration reports the LAST step's losses, 0 when that step did not
train.  The host loop (``hostloop.py``) steps its envs on the host and
hands a chunk of transitions to ``chunk_fn``, which runs the same
``insert_update`` step by step, so the two paths share their update code
and cadence.

DDPG's update: the critic's TD step against the targets, then, every
``policy_frequency`` steps, the actor's step on the critic after this
step's update, and the Polyak sync of both targets.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn

from mmtrl_tpu_torch.algos.offpolicy.common import Metrics, OffPolicyRunner, step_env
from mmtrl_tpu_torch.algos.offpolicy.dqn import (
    Batch,
    DQNTrainState,
    adam_step,
    create_dqn_state,
    sync_target,
)
from mmtrl_tpu_torch.core.metrics import EpisodeStatistics
from mmtrl_tpu_torch.data.buffers import ReplayBuffer
from mmtrl_tpu_torch.envs.base import Environment
from mmtrl_tpu_torch.ops.fused_optim import ScaleByAdamState


@dataclasses.dataclass
class DDPGConfig:
    """Field for field the JAX ``DDPGConfig`` and its defaults."""

    total_timesteps: int = 1_000_000
    learning_rate: float = 3e-4
    num_envs: int = 1
    buffer_size: int = 131_072
    gamma: float = 0.99
    tau: float = 0.005
    batch_size: int = 256
    exploration_noise: float = 0.1
    learning_starts: int = 25_000
    policy_frequency: int = 2
    steps_per_iteration: int = 512

    @property
    def num_iterations(self) -> int:
        return self.total_timesteps // (self.steps_per_iteration * self.num_envs)


class ContinuousDraws(NamedTuple):
    """One step's draws, for a test to replay another implementation's.
    ``explore_noise`` (n, A) standard normals: DDPG's and TD3's exploration
    noise, SAC's policy sample; ``random_action`` (n, A) the warmup's
    uniform action.  For the update (None when the step does not train, or
    to draw from the generator): ``sample_idx`` (B,) the replay indices,
    ``target_noise`` (B, A) TD3's smoothing normals or SAC's next-action
    normals, ``actor_noise`` SAC's (B, A) normals of each actor pass."""

    explore_noise: torch.Tensor
    random_action: torch.Tensor
    sample_idx: Optional[torch.Tensor] = None
    target_noise: Optional[torch.Tensor] = None
    actor_noise: Optional[Sequence[torch.Tensor]] = None


@dataclasses.dataclass
class ActorCriticState:
    """The actor, its critics (DDPG's one, TD3's and SAC's two) and SAC's
    temperature ``log_alpha`` with its own Adam state."""

    actor: DQNTrainState
    critics: Tuple[DQNTrainState, ...]
    log_alpha: Optional[torch.Tensor] = None
    alpha_opt_state: Optional[ScaleByAdamState] = None

    def load_payload(self, payload: Dict[str, Any]) -> "ActorCriticState":
        """Load the networks' ``DQNTrainState`` payloads and the temperature
        (``convert.actor_critic_payload_from_flax``'s layout), in place."""
        self.actor.load_payload(payload["actor"])
        for ts, p in zip(self.critics, payload["critics"], strict=True):
            ts.load_payload(p)
        if self.log_alpha is not None:
            device = self.log_alpha.device
            self.log_alpha = payload["log_alpha"].to(device, self.log_alpha.dtype)
            opt = payload["alpha_opt_state"]
            self.alpha_opt_state = ScaleByAdamState(opt["count"].to(device),
                                                    [m.to(device) for m in opt["mu"]],
                                                    [v.to(device) for v in opt["nu"]])
        return self


class ActorCriticAlgo(NamedTuple):
    """``init_runner(generator)``; ``train_iteration(runner, draws=None) ->
    (runner, metrics)``, ``draws`` one ``ContinuousDraws`` a step replacing
    the generator's; ``update(state, batch, step_idx, draws=None,
    generator=None) -> (state, metrics)``, one training step's update on a
    batch (the states' tensors may be float64).  The host loop's parts
    (JAX's ``AlgoParts`` extras): ``chunk_fn(runner, transitions,
    draws=None) -> (runner, metrics)``, the transitions' tensors shaped
    ``(chunk, num_envs, ...)`` on the runner's device and ``draws`` one
    ``ContinuousDraws`` a step (its update fields); ``act_explore(actor,
    obs, noise, space)`` and ``act_greedy(actor, obs, space)``, the
    behaviour and evaluation actions of an actor module on ``space`` (an
    ``ActionSpace`` on the module's device); ``actor_module(state)``, the
    trained actor; ``space``, the env's action space."""

    init_runner: Callable[[torch.Generator], OffPolicyRunner]
    train_iteration: Callable[..., Tuple[OffPolicyRunner, Metrics]]
    update: Callable[..., Tuple[ActorCriticState, Metrics]]
    chunk_fn: Callable[..., Tuple[OffPolicyRunner, Metrics]]
    act_explore: Callable[..., torch.Tensor]
    act_greedy: Callable[..., torch.Tensor]
    actor_module: Callable[[ActorCriticState], nn.Module]
    space: "ActionSpace"


class ActionSpace(NamedTuple):
    """The Box action space as float32 tensors on the env's device."""

    low: torch.Tensor
    high: torch.Tensor
    scale: torch.Tensor  # (high - low) / 2
    bias: torch.Tensor  # (high + low) / 2
    shape: Tuple[int, ...]

    @classmethod
    def of(cls, env: Environment) -> "ActionSpace":
        sp = env.action_space
        low, high = (torch.as_tensor(b, dtype=torch.float32, device=env.device)
                     for b in (sp.low, sp.high))
        return cls(low, high, (high - low) / 2.0, (high + low) / 2.0, tuple(sp.shape))

    def to(self, device) -> "ActionSpace":
        return ActionSpace(*(t.to(device) for t in self[:4]), self.shape)

    def uniform(self, n: int, generator: torch.Generator) -> torch.Tensor:
        """(n, *shape) uniform in [low, high), as ``jax.random.uniform``
        with ``minval`` and ``maxval`` draws it."""
        u = torch.rand((n,) + self.shape, generator=generator, device=self.low.device)
        return torch.maximum(u * (self.high - self.low) + self.low, self.low)


def critic_step(ts: DQNTrainState, batch: Batch, target: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One Adam step of the critic on the MSE of Q(s, a) against
    ``target``: (loss, mean Q)."""
    q = ts.model(batch["obs"], batch["action"])
    loss = ((q - target) ** 2).mean()
    adam_step(ts, loss)
    return loss.detach(), q.mean().detach()


def bootstrap(gamma: float, batch: Batch, q_next: torch.Tensor) -> torch.Tensor:
    return batch["reward"] + gamma * (1.0 - batch["done"]) * q_next


def make_actor_critic_loop(env: Environment, cfg, space: ActionSpace,
                           make_state: Callable[[], ActorCriticState], explore: Callable,
                           greedy: Callable, update: Callable,
                           zero_metrics: Callable[[ActorCriticState], Metrics]
                           ) -> ActorCriticAlgo:
    """The fused loop of DDPG, TD3 and SAC, and the host loop's chunk path.
    ``make_state()`` is the initial train state; ``explore(actor, obs,
    noise, space)`` the exploring action and ``greedy(actor, obs, space)``
    the evaluation's; ``update(state, batch, step_idx, draws, generator) ->
    (state, metrics)`` a training step's update; ``zero_metrics(state)``
    the metrics of a step that does not train."""
    n = cfg.num_envs

    def init_runner(generator: torch.Generator) -> OffPolicyRunner:
        obs, env_state = env.reset(n, generator)
        device = obs.device
        example = dict(obs=obs[0], action=torch.zeros(space.shape, device=device),
                       reward=torch.zeros((), device=device), next_obs=obs[0],
                       done=torch.zeros((), device=device))
        return OffPolicyRunner(
            train_state=make_state(), buffer=ReplayBuffer.create(example, cfg.buffer_size),
            env_state=env_state, obs=obs, global_step=0,
            stats=EpisodeStatistics.create(n, device), generator=generator)

    def insert_update(runner: OffPolicyRunner, transition: Dict[str, torch.Tensor],
                      draws: Optional[ContinuousDraws] = None):
        """Store one env step's ``num_envs`` transitions and, once more
        than ``learning_starts`` are stored, sample a batch and run the
        update: the half of a step that the fused loop and the chunk path
        share (JAX's ``insert_update``)."""
        runner.buffer.add_batch(transition, n)
        gs = runner.global_step + n
        ts = runner.train_state
        if gs > cfg.learning_starts:
            batch = runner.buffer.sample(runner.generator, cfg.batch_size,
                                         None if draws is None else draws.sample_idx)
            ts, metrics = update(ts, batch, gs // n, draws, runner.generator)
        else:
            metrics = zero_metrics(ts)
        return dataclasses.replace(runner, train_state=ts, global_step=gs), metrics

    def step_fn(runner: OffPolicyRunner, draws: Optional[ContinuousDraws] = None):
        gen = runner.generator
        if draws is None:
            noise = torch.randn((n,) + space.shape, generator=gen, device=runner.obs.device)
            draws = ContinuousDraws(noise, space.uniform(n, gen))
        if runner.global_step < cfg.learning_starts:
            action = draws.random_action.to(runner.obs.device)
        else:
            with torch.no_grad():
                action = explore(runner.train_state.actor.model, runner.obs,
                                 draws.explore_noise.to(runner.obs.device), space)
        runner, transition = step_env(env, runner, action)
        return insert_update(runner, transition, draws)

    def train_iteration(runner: OffPolicyRunner,
                        draws: Optional[Sequence[ContinuousDraws]] = None):
        for k in range(cfg.steps_per_iteration):
            runner, metrics = step_fn(runner, None if draws is None else draws[k])
        return runner, metrics

    def chunk_fn(runner: OffPolicyRunner, transitions: Dict[str, torch.Tensor],
                 draws: Optional[Sequence[ContinuousDraws]] = None):
        """``insert_update`` of each step of a chunk of host transitions
        (leaves ``(chunk, num_envs, ...)``), in order: JAX's scanned
        ``chunk_fn``.  Returns the runner and the last step's metrics."""
        steps = next(iter(transitions.values())).shape[0]
        for t in range(steps):
            runner, metrics = insert_update(runner, {k: v[t] for k, v in transitions.items()},
                                            None if draws is None else draws[t])
        return runner, metrics

    return ActorCriticAlgo(init_runner, train_iteration, update, chunk_fn, explore, greedy,
                           lambda ts: ts.actor.model, space)


def noisy_explore(exploration_noise: float) -> Callable:
    """DDPG's and TD3's exploring action: the actor's, plus normals times
    ``exploration_noise`` times the action space's half-width, clipped."""

    def explore(actor: nn.Module, obs: torch.Tensor, noise: torch.Tensor, space: ActionSpace):
        a_det = actor(obs)
        return torch.clamp(a_det + noise * exploration_noise * space.scale, space.low, space.high)

    return explore


def deterministic_greedy(actor: nn.Module, obs: torch.Tensor, space: ActionSpace) -> torch.Tensor:
    """DDPG's and TD3's evaluation action: the actor's own."""
    return actor(obs)


def zeros_of(ts: ActorCriticState, *names: str) -> Metrics:
    zero = torch.zeros((), device=ts.actor.opt_state.count.device)
    return {name: zero for name in names}


def make_ddpg(env: Environment, actor: nn.Module, critic: nn.Module,
              cfg: DDPGConfig) -> ActorCriticAlgo:
    """DDPG's fused loop; ``actor(obs) -> action`` (``DeterministicActor``),
    ``critic(obs, action) -> Q`` (``QFunction``), on the env's device.
    Both targets start as copies of their networks."""
    space = ActionSpace.of(env)
    names = ("losses/qf1_loss", "losses/actor_loss", "losses/qf1_values")

    def make_state():
        return ActorCriticState(actor=create_dqn_state(actor, cfg.learning_rate),
                                critics=(create_dqn_state(critic, cfg.learning_rate),))

    def update(ts: ActorCriticState, batch: Batch, step_idx: int, draws=None, generator=None):
        (qf,) = ts.critics
        with torch.no_grad():
            next_a = ts.actor.target(batch["next_obs"])
            target = bootstrap(cfg.gamma, batch, qf.target(batch["next_obs"], next_a))
        c_loss, q_mean = critic_step(qf, batch, target)
        a_loss = torch.zeros_like(c_loss)
        if step_idx % cfg.policy_frequency == 0:
            loss = -qf.model(batch["obs"], ts.actor.model(batch["obs"])).mean()
            adam_step(ts.actor, loss)
            sync_target(ts.actor, cfg.tau)
            sync_target(qf, cfg.tau)
            a_loss = loss.detach()
        return ts, dict(zip(names, (c_loss, a_loss, q_mean)))

    return make_actor_critic_loop(env, cfg, space, make_state,
                                  noisy_explore(cfg.exploration_noise), deterministic_greedy,
                                  update, lambda ts: zeros_of(ts, *names))

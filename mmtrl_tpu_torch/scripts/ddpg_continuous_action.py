"""DDPG, the reference's cleanrl/ddpg_continuous_action(_jax).py; twin of
``scripts/ddpg_continuous_action.py``.  The fused loop
(``algos/offpolicy/ddpg.py::make_ddpg``) acts, steps a registry env,
stores and updates on the card, with the 256-256 ReLU ``DeterministicActor``
and ``QFunction``, and ends with a greedy evaluation of the actor.  Same
CLI and defaults as the JAX script, whose ``--platform`` has no
counterpart (``--cuda`` picks the device).  An id outside the registry
(MuJoCo's HalfCheetah-v4, ...) runs the fused loop on a ``GymPool`` of host
gymnasium envs, a copy to the host and back each step; ``--host-loop``
steps a ``GymPool`` even for a registry id and trains through
``algos/offpolicy/hostloop.py`` (behaviour actions on the host, a chunk of
``--chunk-size`` steps of transitions to the card at a time).  Both need
the gymnasium package.  ``--track`` journals the metrics to
``wandb_local/``; ``--capture-video`` is accepted and ignored, as in JAX.

    python -m mmtrl_tpu_torch.scripts.ddpg_continuous_action --env-id Pendulum-v1
    python -m mmtrl_tpu_torch.scripts.ddpg_continuous_action --cuda False \\
        --total-timesteps 2048 --learning-starts 512 --batch-size 64
    python -m mmtrl_tpu_torch.scripts.ddpg_continuous_action --cuda False --host-loop \\
        --env-id HalfCheetah-v4 --total-timesteps 2048 --learning-starts 512 --batch-size 64
"""

import dataclasses
from typing import Optional

import numpy as np

from mmtrl_tpu_torch.algos.offpolicy.ddpg import DDPGConfig, make_ddpg
from mmtrl_tpu_torch.algos.offpolicy.hostloop import run_offpolicy_hostloop
from mmtrl_tpu_torch.algos.offpolicy.runner import run_offpolicy
from mmtrl_tpu_torch.core.config import cli
from mmtrl_tpu_torch.envs.gym_bridge import GymPool, make_any
from mmtrl_tpu_torch.models.agents import DeterministicActor, QFunction
from mmtrl_tpu_torch.scripts._common import config_of, device_from, field, seeded


@dataclasses.dataclass
class Args:
    exp_name: str = field("ddpg_continuous_action", "the name of this experiment")
    seed: int = field(1, "seed of the experiment")
    torch_deterministic: bool = field(
        True, "set torch.backends.cudnn.deterministic (deterministic cuDNN algorithms)")
    cuda: bool = field(True, "run on the CUDA card (raises without one); False: on the CPU")
    track: bool = field(False, "mirror metrics to the local wandb journal (wandb_local/)")
    wandb_project_name: str = field("cleanRL", "the wandb's project name")
    wandb_entity: Optional[str] = field(None, "the entity (team) of wandb's project")
    capture_video: bool = field(False, "CLI compat (accepted and ignored, as in JAX)")
    env_id: str = field("Pendulum-v1", "the id of the environment")
    total_timesteps: int = field(1000000, "total timesteps of the experiments")
    learning_rate: float = field(3e-4, "the learning rate of the optimizer")
    num_envs: int = field(1, "the number of parallel game environments")
    buffer_size: int = field(131072, "the replay memory buffer size")
    gamma: float = field(0.99, "the discount factor gamma")
    tau: float = field(0.005, "target smoothing coefficient")
    batch_size: int = field(256, "batch size from the replay memory")
    exploration_noise: float = field(0.1, "the scale of exploration noise")
    learning_starts: int = field(25000, "timestep to start learning")
    policy_frequency: int = field(2, "delayed policy update frequency")
    steps_per_iteration: int = field(512, "env steps fused per train_iteration call")
    print_interval: int = field(1, "print stats every so iterations")
    save_interval: int = field(0, "save every n iterations (0: never)")
    save_dir: str = field("saved_agents", "checkpoint folder")
    load_from: str = field("", "checkpoint path from which to resume the run")
    host_loop: bool = field(False, "step gymnasium envs on the host, updates on the card")
    chunk_size: int = field(64, "host-loop transitions per device dispatch")


def env_and_device(args):
    """(env, device) of a run, the networks on the card (``--cuda``):
    with ``--host-loop`` a ``GymPool`` of ``--num-envs`` host envs whatever
    the id (JAX's ``scripts/td3_continuous_action.py:29-32``); else the
    registry's env, or a ``GymPool`` for any other id."""
    device = device_from(args)
    if args.host_loop:
        return GymPool(args.env_id, args.num_envs, seed=args.seed, device=device), device
    return make_any(args.env_id, num_envs=args.num_envs, seed=args.seed, device=device)[0], device


def deterministic_actor(args, env, device) -> DeterministicActor:
    """DDPG's and TD3's actor on the env's action space, its parameters
    initialised from ``--seed``."""
    sp = env.action_space
    obs_dim, action_dim = env.observation_space.shape[0], sp.shape[0]
    scale, bias = (tuple(np.broadcast_to(np.ravel(x), (action_dim,)))
                   for x in ((np.asarray(sp.high) - np.asarray(sp.low)) / 2.0,
                             (np.asarray(sp.high) + np.asarray(sp.low)) / 2.0))
    return seeded(args.seed, device, lambda: DeterministicActor(obs_dim, action_dim, scale, bias,
                                                                 device=device))


def q_function(seed: int, env, device) -> QFunction:
    return seeded(seed, device, lambda: QFunction(env.observation_space.shape[0],
                                                  env.action_space.shape[0], device=device))


def networks(args, env, device):
    """(actor, critics) of a run."""
    return deterministic_actor(args, env, device), [q_function(args.seed + 1, env, device)]


def parts(args, cfg_cls=DDPGConfig, networks_of=networks):
    """(env, device, actor, critics, run config) of a run: the one place
    where a run's env, networks and config are made."""
    env, device = env_and_device(args)
    return (env, device, *networks_of(args, env, device), config_of(cfg_cls, args))


def build(args, factory=make_ddpg, cfg_cls=DDPGConfig, networks_of=networks):
    """(algorithm, run config, device, env) of a fused run of ``factory``
    (``make_ddpg``, ``make_td3``, ``make_sac``)."""
    env, device, actor, critics, cfg = parts(args, cfg_cls, networks_of)
    return factory(env, actor, *critics, cfg), cfg, device, env


def run(args, factory=make_ddpg, cfg_cls=DDPGConfig, networks_of=networks):
    """A run of ``factory``: with ``--host-loop`` through
    ``run_offpolicy_hostloop`` on the host pool, else the algorithm of
    ``build`` through the fused loop and its greedy evaluation."""
    if args.host_loop:
        env, device, actor, critics, cfg = parts(args, cfg_cls, networks_of)
        return run_offpolicy_hostloop(factory, env, actor, critics, cfg, args, device)
    algo, cfg, device, env = build(args, factory, cfg_cls, networks_of)
    return run_offpolicy(algo, cfg, args, device, eval_setup=(
        env, lambda module, obs: algo.act_greedy(module, obs, algo.space), algo.actor_module))


def main(args=None):
    return run(args or cli(Args))


if __name__ == "__main__":
    main()

"""DDPG, the reference's cleanrl/ddpg_continuous_action(_jax).py; twin of
``scripts/ddpg_continuous_action.py``.  The fused loop
(``algos/offpolicy/ddpg.py::make_ddpg``) acts, steps a registry env,
stores and updates on the card, with the 256-256 ReLU ``DeterministicActor``
and ``QFunction``, and ends with a greedy evaluation of the actor.  Same
CLI and defaults as the JAX script, whose ``--platform`` has no
counterpart (``--cuda`` picks the device).  ``--host-loop`` (gymnasium
envs on the host) and ids outside the registry raise naming ROADMAP A.7;
``--track`` and ``--capture-video`` raise naming A.9.

    python -m mmtrl_tpu_torch.scripts.ddpg_continuous_action --env-id Pendulum-v1
    python -m mmtrl_tpu_torch.scripts.ddpg_continuous_action --cuda False \\
        --total-timesteps 2048 --learning-starts 512 --batch-size 64
"""

import dataclasses
from typing import Optional

from mmtrl_tpu_torch.algos.offpolicy.ddpg import DDPGConfig, make_ddpg
from mmtrl_tpu_torch.algos.offpolicy.runner import run_offpolicy
from mmtrl_tpu_torch.core.config import cli
from mmtrl_tpu_torch.models.agents import DeterministicActor, QFunction
from mmtrl_tpu_torch.scripts._common import (
    config_of,
    device_from,
    field,
    make_registry_env,
    seeded,
)


@dataclasses.dataclass
class Args:
    exp_name: str = field("ddpg_continuous_action", "the name of this experiment")
    seed: int = field(1, "seed of the experiment")
    torch_deterministic: bool = field(
        True, "set torch.backends.cudnn.deterministic (deterministic cuDNN algorithms)")
    cuda: bool = field(True, "run on the CUDA card (raises without one); False: on the CPU")
    track: bool = field(False, "mirror metrics to wandb (not ported yet: raises)")
    wandb_project_name: str = field("cleanRL", "the wandb's project name")
    wandb_entity: Optional[str] = field(None, "the entity (team) of wandb's project")
    capture_video: bool = field(False, "capture videos of the agent (not ported yet: raises)")
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
    host_loop: bool = field(False, "step gymnasium envs on the host (not ported yet: raises)")
    chunk_size: int = field(64, "host-loop transitions per device dispatch")


def env_and_device(args):
    """(env, device) of a run: a registry env on the card (``--cuda``)."""
    if args.host_loop:
        raise NotImplementedError("--host-loop: gymnasium envs on the host with updates on the "
                                  "card are not ported yet (ROADMAP A.7)")
    device = device_from(args)
    return make_registry_env(args.env_id, device), device


def deterministic_actor(args, env, device) -> DeterministicActor:
    """DDPG's and TD3's actor on the env's action space, its parameters
    initialised from ``--seed``."""
    sp = env.action_space
    obs_dim, action_dim = env.observation_space.shape[0], sp.shape[0]
    scale = [(sp.high - sp.low) / 2.0] * action_dim
    bias = [(sp.high + sp.low) / 2.0] * action_dim
    return seeded(args.seed, device, lambda: DeterministicActor(obs_dim, action_dim, scale, bias,
                                                                 device=device))


def q_function(seed: int, env, device) -> QFunction:
    return seeded(seed, device, lambda: QFunction(env.observation_space.shape[0],
                                                  env.action_space.shape[0], device=device))


def build(args):
    """(algorithm, run config, device, env) of a run."""
    env, device = env_and_device(args)
    cfg = config_of(DDPGConfig, args)
    actor = deterministic_actor(args, env, device)
    return make_ddpg(env, actor, q_function(args.seed + 1, env, device), cfg), cfg, device, env


def main(args=None):
    args = args or cli(Args)
    algo, cfg, device, env = build(args)
    return run_offpolicy(algo, cfg, args, device,
                         eval_setup=(env, lambda actor, obs: actor(obs), lambda ts: ts.actor.model))


if __name__ == "__main__":
    main()

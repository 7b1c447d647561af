"""DQN on classic control, the reference's cleanrl/dqn.py; twin of
``scripts/dqn.py``.  The fused loop (``algos/offpolicy/dqn.py::make_dqn``)
acts, steps the env, stores and updates on the card; a 120-84 ReLU Q
network; ``--prioritized-replay`` samples by PER.  Same CLI and defaults as
the JAX script, whose ``--platform`` has no counterpart (``--cuda`` picks
the device).

    python -m mmtrl_tpu_torch.scripts.dqn --env-id CartPole-v1 --total-timesteps 500000
    python -m mmtrl_tpu_torch.scripts.dqn --cuda False --total-timesteps 1024 \\
        --learning-starts 256 --prioritized-replay
"""

import dataclasses
from typing import Optional

from mmtrl_tpu_torch.algos.offpolicy.dqn import DQNConfig, argmax_q, make_dqn
from mmtrl_tpu_torch.algos.offpolicy.runner import run_offpolicy
from mmtrl_tpu_torch.core.config import cli
from mmtrl_tpu_torch.envs import make
from mmtrl_tpu_torch.models.agents import QNetwork
from mmtrl_tpu_torch.scripts._common import config_of, device_from, field, seeded


@dataclasses.dataclass
class Args:
    exp_name: str = field("dqn", "the name of this experiment")
    seed: int = field(1, "seed of the experiment")
    torch_deterministic: bool = field(
        True, "set torch.backends.cudnn.deterministic (deterministic cuDNN algorithms)")
    cuda: bool = field(True, "run on the CUDA card (raises without one); False: on the CPU")
    track: bool = field(False, "mirror metrics to the local wandb journal (wandb_local/)")
    wandb_project_name: str = field("cleanRL", "the wandb's project name")
    wandb_entity: Optional[str] = field(None, "the entity (team) of wandb's project")
    capture_video: bool = field(False, "CLI compat (accepted and ignored, as in JAX)")
    env_id: str = field("CartPole-v1", "the id of the environment")
    total_timesteps: int = field(500000, "total timesteps of the experiments")
    learning_rate: float = field(2.5e-4, "the learning rate of the optimizer")
    num_envs: int = field(1, "the number of parallel game environments")
    buffer_size: int = field(10000, "the replay memory buffer size")
    gamma: float = field(0.99, "the discount factor gamma")
    tau: float = field(1.0, "the target network update rate")
    target_network_frequency: int = field(500, "target update interval (steps)")
    batch_size: int = field(128, "batch size from the replay memory")
    start_e: float = field(1.0, "the starting epsilon for exploration")
    end_e: float = field(0.05, "the ending epsilon for exploration")
    exploration_fraction: float = field(0.5, "fraction of timesteps for eps decay")
    learning_starts: int = field(10000, "timestep to start learning")
    train_frequency: int = field(10, "the frequency of training")
    steps_per_iteration: int = field(512, "env steps fused per train_iteration call")
    prioritized_replay: bool = field(False, "use prioritized experience replay")
    per_alpha: float = field(0.6, "PER priority exponent")
    per_beta_start: float = field(0.4, "PER IS-weight exponent (annealed to 1)")
    print_interval: int = field(1, "print stats every so iterations")
    save_interval: int = field(0, "save every n iterations (0: never)")
    save_dir: str = field("saved_agents", "checkpoint folder")
    load_from: str = field("", "checkpoint path from which to resume the run")


def build(args):
    """(algorithm, run config, device, env) of a run; the Q network's
    parameters are initialised from ``--seed``."""
    device = device_from(args)
    env = make(args.env_id, device=device)
    cfg = config_of(DQNConfig, args)
    model = seeded(args.seed, device, lambda: QNetwork(
        env.num_actions, obs_shape=env.observation_space.shape, device=device))
    return make_dqn(env, model, cfg), cfg, device, env


def main(args=None):
    args = args or cli(Args)
    algo, cfg, device, env = build(args)
    return run_offpolicy(algo, cfg, args, device,
                         eval_setup=(env, argmax_q, lambda ts: ts.model))


if __name__ == "__main__":
    main()

"""SAC, the reference's cleanrl/sac_continuous_action.py; twin of
``scripts/sac_continuous_action.py``.  The fused loop
(``algos/offpolicy/sac.py::make_sac``) with the 256-256 ReLU
``SquashedGaussianActor`` and two ``QFunction``s on the card, alpha
autotuned, and a greedy evaluation (``tanh(mean)`` scaled to the action
space).  Same CLI and defaults as the JAX script; ``--host-loop`` and the
gymnasium ids as in ``ddpg_continuous_action``; ``--track`` journals the
metrics to ``wandb_local/`` and ``--capture-video`` is ignored, as in JAX.

    python -m mmtrl_tpu_torch.scripts.sac_continuous_action --env-id Pendulum-v1
    python -m mmtrl_tpu_torch.scripts.sac_continuous_action --cuda False \\
        --total-timesteps 2048 --learning-starts 512 --batch-size 64
    python -m mmtrl_tpu_torch.scripts.sac_continuous_action --cuda False --host-loop \\
        --env-id HalfCheetah-v4 --total-timesteps 2048 --learning-starts 512 --batch-size 64
"""

import dataclasses
from typing import Optional

from mmtrl_tpu_torch.algos.offpolicy.sac import SACConfig, make_sac
from mmtrl_tpu_torch.core.config import cli
from mmtrl_tpu_torch.models.agents import SquashedGaussianActor
from mmtrl_tpu_torch.scripts import ddpg_continuous_action as ddpg
from mmtrl_tpu_torch.scripts._common import field, seeded


@dataclasses.dataclass
class Args:
    exp_name: str = field("sac_continuous_action", "the name of this experiment")
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
    q_lr: float = field(1e-3, "critic learning rate")
    policy_lr: float = field(3e-4, "actor learning rate")
    num_envs: int = field(1, "the number of parallel game environments")
    buffer_size: int = field(131072, "the replay memory buffer size")
    gamma: float = field(0.99, "the discount factor gamma")
    tau: float = field(0.005, "target smoothing coefficient")
    batch_size: int = field(256, "batch size from the replay memory")
    learning_starts: int = field(5000, "timestep to start learning")
    policy_frequency: int = field(2, "actor update frequency")
    target_network_frequency: int = field(1, "target sync frequency")
    alpha: float = field(0.2, "entropy regularization coefficient")
    autotune: bool = field(True, "automatic alpha tuning")
    steps_per_iteration: int = field(512, "env steps fused per train_iteration call")
    print_interval: int = field(1, "print stats every so iterations")
    save_interval: int = field(0, "save every n iterations (0: never)")
    save_dir: str = field("saved_agents", "checkpoint folder")
    load_from: str = field("", "checkpoint path from which to resume the run")
    host_loop: bool = field(False, "step gymnasium envs on the host, updates on the card")
    chunk_size: int = field(64, "host-loop transitions per device dispatch")


def networks(args, env, device):
    """(actor, critics) of a run, initialised from ``--seed``."""
    actor = seeded(args.seed, device, lambda: SquashedGaussianActor(
        env.observation_space.shape[0], env.action_space.shape[0], device=device))
    return actor, [ddpg.q_function(args.seed + k, env, device) for k in (1, 2)]


def build(args):
    """(algorithm, run config, device, env) of a fused run."""
    return ddpg.build(args, make_sac, SACConfig, networks)


def main(args=None):
    return ddpg.run(args or cli(Args), make_sac, SACConfig, networks)


if __name__ == "__main__":
    main()

"""DQN on a real 2600 cartridge, the reference's dqn_atari leg; twin of
``scripts/dqn_rom.py``.

The Q network (``AtariTower('big')`` on the (3, 84, 84) observation) trains
with epsilon-greedy acting, an int8 replay ring and a target network
through the host loop (``algos/offpolicy/hostloop_dqn.py``): the C++ core
emulates the cartridge on the host, the observation, acting, replay and
TD updates run on the card.  Same CLI and defaults as the JAX script; the
default cartridge is RALLY.

Cadence against the reference's dqn_atari defaults (train_frequency 4,
batch 32: 8 replayed samples an env step; a target sync every 1000 env
steps): 8 pool envs, ``--train-frequency 2`` pool steps at batch 128 and
``--target-network-frequency 125`` pool steps keep both ratios.  The ring
holds 100k int8 transitions (4.2 GB on the card).

    python -m mmtrl_tpu_torch.scripts.dqn_rom
    python -m mmtrl_tpu_torch.scripts.dqn_rom --cuda False --num-envs 2 --buffer-size 64 \\
        --learning-starts 16 --batch-size 8 --total-timesteps 64 --eval-steps 0
"""

import dataclasses
from typing import Optional

from mmtrl_tpu_torch.algos.offpolicy import DQNConfig
from mmtrl_tpu_torch.algos.offpolicy.hostloop_dqn import run_dqn_hostloop
from mmtrl_tpu_torch.core.config import cli
from mmtrl_tpu_torch.envs.homebrew_native import make_native_env
from mmtrl_tpu_torch.models.agents import QNetwork
from mmtrl_tpu_torch.scripts._common import config_of, device_from, field, seeded


@dataclasses.dataclass
class Args:
    exp_name: str = field("dqn_rom", "the name of this experiment")
    seed: int = field(1, "seed of the experiment")
    torch_deterministic: bool = field(
        True, "set torch.backends.cudnn.deterministic (deterministic cuDNN algorithms)")
    cuda: bool = field(True, "run on the CUDA card (raises without one); False: on the CPU")
    track: bool = field(False, "CLI compat")
    wandb_project_name: str = field("cleanRL", "CLI compat")
    wandb_entity: Optional[str] = field(None, "CLI compat")
    capture_video: bool = field(False, "CLI compat")
    env_id: str = field("rally_native", "rally_native | brick_native | skeleton_plus_native")
    rom_path: str = field("", "cartridge path (default: per env-id)")
    frameskip: int = field(8, "emulator frames per env step")
    episode_steps: int = field(1500, "env-step cap per episode")
    reward_mode: str = field("score", "'score'/'win' (rally), 'shaped'/'kills' (skeleton)")
    repeat_action_probability: float = field(
        0.0, "ALE-v5 sticky actions (reference envpool setting: 0.25)")
    total_timesteps: int = field(1000000, "total env transitions")
    learning_rate: float = field(1e-4, "Adam lr (dqn_atari default)")
    num_envs: int = field(8, "parallel emulated cartridges")
    buffer_size: int = field(100000, "replay capacity (int8-quantized obs)")
    gamma: float = field(0.99, "discount")
    tau: float = field(1.0, "target update rate (1 = hard sync)")
    target_network_frequency: int = field(125, "target sync every n POOL steps")
    batch_size: int = field(128, "TD batch size")
    start_e: float = field(1.0, "starting epsilon")
    end_e: float = field(0.01, "final epsilon (dqn_atari default)")
    exploration_fraction: float = field(0.10, "fraction of steps for eps decay")
    learning_starts: int = field(20000, "env transitions before updates")
    train_frequency: int = field(2, "TD update every n POOL steps")
    eval_steps: int = field(
        4000, "greedy eval POOL steps after training, floored at the episode cap (0: skip)")
    print_interval: int = field(1, "print every n*50 pool steps")
    save_interval: int = field(0, "save train state every n*50 pool steps (0: never)")
    save_dir: str = field("saved_agents", "checkpoint folder")
    load_from: str = field(
        "", "resume: restore the train state (params+target+opt) from a saved run; the replay "
        "ring restarts cold and refills at epsilon=end_e before updates resume")


def config_from(args) -> DQNConfig:
    return config_of(DQNConfig, args)


def setup(args):
    """(device, pool env, the host loop's config) of a Q run; a resumed run
    acts at the final epsilon while its cold ring refills."""
    if args.load_from:
        args.start_e = args.end_e
    device = device_from(args)
    env = make_native_env(args.env_id, num_envs=args.num_envs, rom_path=args.rom_path,
                          seed=args.seed, frameskip=args.frameskip,
                          episode_steps=args.episode_steps, reward_mode=args.reward_mode,
                          repeat_action_probability=args.repeat_action_probability,
                          device=device)
    return device, env, config_from(args)


def main(args=None):
    args = args or cli(Args)
    device, env, cfg = setup(args)
    try:
        # native observations lie in [-1, 1]: no /255
        model = seeded(args.seed, device, lambda: QNetwork(
            num_actions=env.num_actions, input_scale=1.0,
            obs_shape=env.observation_space.shape, device=device))
        return run_dqn_hostloop(env, model, cfg, args, device, eval_steps=args.eval_steps)
    finally:
        env.close()


if __name__ == "__main__":
    main()

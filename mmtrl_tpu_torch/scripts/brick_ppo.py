"""PPO on BRICK, the repo's Breakout-class homebrew cartridge (a 4 x 16
brick wall, row-scored +2/+1, a double-speed second wall, 3 lives); twin of
``scripts/brick_ppo.py``.

    python -m mmtrl_tpu_torch.scripts.brick_ppo --num-envs 32 --total-timesteps 1000000

Reward is the ALE-style score delta; clearing both walls (score 192) wins.
"""

import dataclasses

from mmtrl_tpu_torch.core.config import cli
from mmtrl_tpu_torch.envs.homebrew_native import BRICK_ROM
from mmtrl_tpu_torch.scripts import rally_ppo
from mmtrl_tpu_torch.scripts._common import field


@dataclasses.dataclass
class Args(rally_ppo.Args):
    exp_name: str = field("brick_ppo", "the name of this experiment")
    env_id: str = field("brick_native", "the id of the environment")
    clip_rewards: bool = field(False, "score deltas are already small ints")
    backend: str = field("native", "brick exists only as a real cartridge")
    rom_path: str = field("", "cartridge path (default: native/homebrew/brick.bin)")


def main(args=None):
    return rally_ppo.main(args or cli(Args), default_rom=BRICK_ROM)


if __name__ == "__main__":
    main()

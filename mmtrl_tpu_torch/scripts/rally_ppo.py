"""PPO on RALLY, the repo's homebrew wall-ball cartridge whose audio
channel encodes the ball's height as pitch; twin of ``scripts/rally_ppo.py``.

The native 2600 core, the two-tower multimodal agent and recurrent PPO
through the host loop (``skeleton_plus_ppo.main``), on the card.

    python -m mmtrl_tpu_torch.scripts.rally_ppo --num-envs 32 --total-timesteps 1000000
    python -m mmtrl_tpu_torch.scripts.rally_ppo --cuda False --conv-size small \\
        --num-envs 2 --num-steps 8 --num-minibatches 1 --update-epochs 1 --total-timesteps 32

Reward is the ALE-style score delta (+1 per paddle return; 21 wins).
"""

import dataclasses

from mmtrl_tpu_torch.core.config import cli
from mmtrl_tpu_torch.envs.homebrew_native import RALLY_ROM
from mmtrl_tpu_torch.scripts._common import BasePPOArgs, field
from mmtrl_tpu_torch.scripts.skeleton_plus_ppo import main as skeleton_main


@dataclasses.dataclass
class Args(BasePPOArgs):
    exp_name: str = field("rally_ppo", "the name of this experiment")
    env_id: str = field("rally_native", "the id of the environment")
    num_envs: int = field(32, "parallel emulated cartridges")
    clip_rewards: bool = field(False, "score deltas are already unit-scale")
    attn_type: str = field("casl", "crossmodal attention type")
    backend: str = field("native", "rally exists only as a real cartridge")
    rom_path: str = field("", "cartridge path (default: native/homebrew/rally.bin)")
    frameskip: int = field(8, "emulator frames per env step")
    reward_mode: str = field("score", "'score' (ALE delta) or 'win' (+5 bonus)")
    host_loop: bool = field(
        True, "host rollout loop (policy and update on the card, emulation on the host)")
    eval_steps: int = field(4000, "greedy eval env-steps after host-loop training (0: skip)")
    repeat_action_probability: float = field(
        0.0, "ALE-v5 sticky actions (reference envpool setting: 0.25)")


def main(args=None, default_rom: str = RALLY_ROM):
    args = args or cli(Args)
    if not args.rom_path:
        args.rom_path = default_rom
    return skeleton_main(args)


if __name__ == "__main__":
    main()

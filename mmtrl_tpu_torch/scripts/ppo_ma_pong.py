"""Parameter-sharing multi-agent PPO on the two-player PONG cartridge; twin
of ``scripts/ppo_ma_pong.py``.

The reference's ppo_pettingzoo_ma_atari.py trains one shared policy over
both players of 2-player Atari Pong (reference :150-159).  Here the
in-repo ``pong.bin`` runs on the native 2600 core with both joysticks
driven by the shared recurrent multimodal agent (video + stereo MFCC),
through the host loop (``algos/ppo/hostloop.py``): emulation on the host,
the policy and the update on the card.  The PPO batch is 2 x
``--num-envs`` agent slots, so ``global_step`` counts slot-steps.

The rewards are zero-sum (own minus opponent score delta), so the mean
return over slots is about 0 by construction; ``charts/episodic_kills``
(points scored a slot an episode) is the curve to watch.

    python -m mmtrl_tpu_torch.scripts.ppo_ma_pong --num-envs 16 --total-timesteps 1000000
    python -m mmtrl_tpu_torch.scripts.ppo_ma_pong --cuda False --num-envs 2 --num-steps 8 \\
        --num-minibatches 1 --update-epochs 1 --total-timesteps 64
"""

import dataclasses

from mmtrl_tpu_torch.algos.ppo.hostloop import run_recurrent_ppo_hostloop
from mmtrl_tpu_torch.core.config import cli
from mmtrl_tpu_torch.envs.pong_ma import NUM_AGENTS, PONG_ROM, NativePong2P
from mmtrl_tpu_torch.models.agents import MultimodalRecurrentAgent
from mmtrl_tpu_torch.scripts._common import (
    BasePPOArgs,
    device_from,
    field,
    ppo_config_from,
    seeded,
)


@dataclasses.dataclass
class Args(BasePPOArgs):
    exp_name: str = field("ppo_ma_pong", "the name of this experiment")
    env_id: str = field("pong_ma_native", "the id of the environment")
    num_envs: int = field(16, "parallel JOINT cartridges (2 agent slots each)")
    clip_rewards: bool = field(False, "score deltas are already ±1")
    attn_type: str = field("casl", "crossmodal attention type")
    conv_size: str = field("small", "conv trunk size (host-loop recipe)")
    rom_path: str = field("", "cartridge path (default: native/homebrew/pong.bin)")
    frameskip: int = field(8, "emulator frames per env step")
    episode_steps: int = field(1500, "env-step episode cap per cartridge")
    repeat_action_probability: float = field(
        0.0, "ALE-v5 sticky actions per slot (reference envpool setting: 0.25)")
    eval_steps: int = field(
        0, "greedy self-play eval env-steps after training (0: skip; match evals against "
        "fixed opponents: python -m mmtrl_tpu_torch.tools.eval_pong)")


def main(args=None):
    args = args or cli(Args)
    device = device_from(args)
    env = NativePong2P(
        num_envs=args.num_envs,
        rom_path=args.rom_path or PONG_ROM,
        seed=args.seed,
        frameskip=args.frameskip,
        episode_steps=args.episode_steps,
        repeat_action_probability=args.repeat_action_probability,
        device=device,
    )
    try:
        # Parameter sharing: the PPO batch dim is num_envs * 2 agent slots.
        cfg = ppo_config_from(args, num_envs=args.num_envs * NUM_AGENTS)
        model = seeded(args.seed, device, lambda: MultimodalRecurrentAgent(
            num_actions=env.num_actions,
            conv_type=args.conv_size,
            attn_type=args.attn_type,
            fusion_type=args.fusion_type,
            input_scale=1.0,  # the observations lie in [-1, 1]: no legacy /255
            audio_channels=env.observation_space.shape[0] - 1,
            device=device,
        ))
        return run_recurrent_ppo_hostloop(env, model, cfg, args, device,
                                          eval_steps=args.eval_steps)
    finally:
        env.close()


if __name__ == "__main__":
    main()

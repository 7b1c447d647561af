"""Multimodal or single-tower PPO-LSTM on Minecraft2d, the reference's
src/minecraft_lstm.py (MinecraftAgent or the single-tower OldAgent,
reference :82-91); twin of ``scripts/minecraft_lstm.py``.

    python -m mmtrl_tpu_torch.scripts.minecraft_lstm --num-envs 8 --agent minecraft
"""

import dataclasses

from mmtrl_tpu_torch.algos.ppo import make_recurrent_ppo
from mmtrl_tpu_torch.algos.ppo.runner import run_training
from mmtrl_tpu_torch.core.config import cli
from mmtrl_tpu_torch.envs import make
from mmtrl_tpu_torch.models.agents import MultimodalRecurrentAgent, RecurrentAgent
from mmtrl_tpu_torch.scripts._common import (
    BasePPOArgs,
    device_from,
    field,
    ppo_config_from,
    seeded,
)


@dataclasses.dataclass
class Args(BasePPOArgs):
    exp_name: str = field("minecraft_lstm", "the name of this experiment")
    env_id: str = field("minecraft", "the id of the environment")
    agent: str = field("minecraft", "'minecraft' (two-tower) or 'old' (single-tower)")
    num_envs: int = field(4, "parallel envs")
    num_minibatches: int = field(1, "mini-batches")
    update_epochs: int = field(1, "update epochs")


def main(args=None):
    args = args or cli(Args)
    device = device_from(args)
    if args.agent == "old":
        env = make(args.env_id, use_audio=False, device=device)
        build = lambda: RecurrentAgent(  # noqa: E731
            num_actions=env.num_actions, conv_type=args.conv_size,
            input_scale=args.input_scale, device=device)
    else:
        env = make(args.env_id, device=device)
        build = lambda: MultimodalRecurrentAgent(  # noqa: E731
            num_actions=env.num_actions,
            conv_type=args.conv_size,
            attn_type=args.attn_type,
            fusion_type=args.fusion_type,
            input_scale=args.input_scale,
            device=device,
        )
    cfg = ppo_config_from(args)
    model = seeded(args.seed, device, build)
    return run_training(make_recurrent_ppo(env, model, cfg), cfg, args, device)


if __name__ == "__main__":
    main()

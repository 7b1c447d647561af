"""Multimodal PPO-LSTM on Minecraft2d, the reference's src/train.py; twin of
``scripts/train.py``.

Same CLI (--attn-type casl|new, --fusion-type sum|concat, --conv-size
big|small, checkpoint flags).  The agent is the two-tower crossmodal
MinecraftAgent.  ``--capture-video`` records a greedy episode (the argmax
of the agent's logits, its LSTM carry from one env's zeros) as a GIF under
``videos/<run_name>/`` at each checkpoint and at the end.

    python -m mmtrl_tpu_torch.scripts.train --env-id minecraft --attn-type casl --fusion-type sum
    python -m mmtrl_tpu_torch.scripts.train --cuda False --conv-size small --total-timesteps 64
"""

import dataclasses

from mmtrl_tpu_torch.algos.ppo import make_recurrent_ppo
from mmtrl_tpu_torch.algos.ppo.runner import run_training
from mmtrl_tpu_torch.core.config import cli
from mmtrl_tpu_torch.envs import make
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
    exp_name: str = field("train", "the name of this experiment")
    env_id: str = field("minecraft", "the id of the environment")
    num_envs: int = field(1, "parallel envs (reference default, src/utils.py:74)")
    num_minibatches: int = field(1, "mini-batches (reference default)")
    update_epochs: int = field(1, "update epochs (reference default)")


def make_agent(args, num_actions: int, device) -> MultimodalRecurrentAgent:
    """The run's agent, its parameters initialised from ``--seed``."""
    return seeded(args.seed, device, lambda: MultimodalRecurrentAgent(
        num_actions=num_actions,
        conv_type=args.conv_size,
        attn_type=args.attn_type,
        fusion_type=args.fusion_type,
        input_scale=args.input_scale,
        device=device,
    ))


def recurrent_video_policy(model, obs, done, carry, generator):
    """The greedy step of a recurrent agent: the argmax of its logits."""
    logits, _, carry = model(obs[None], done[None], carry)
    return logits[0].argmax(-1), carry


def main(args=None):
    args = args or cli(Args)
    device = device_from(args)
    env = make(args.env_id, device=device)
    cfg = ppo_config_from(args)
    model = make_agent(args, env.num_actions, device)
    ppo = make_recurrent_ppo(env, model, cfg)
    video_setup = (env, recurrent_video_policy, lambda rs: rs.model,
                   model.initial_carry(1)) if args.capture_video else None
    return run_training(ppo, cfg, args, device, video_setup=video_setup)


if __name__ == "__main__":
    main()

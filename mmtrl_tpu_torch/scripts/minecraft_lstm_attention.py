"""Sigmoid-gated multimodal PPO-LSTM, the reference's
src/minecraft_lstm_attention.py; twin of ``scripts/minecraft_lstm_attention.py``:
gate = sigmoid(MLP([v; a])), convex fusion v*w + a*(1-w), and the scalar
gate concatenated onto the LSTM output so the actor/critic heads are 129-d
(reference :59-104).

    python -m mmtrl_tpu_torch.scripts.minecraft_lstm_attention --total-timesteps 100000
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
    exp_name: str = field("minecraft_lstm_attention", "the name of this experiment")
    env_id: str = field("minecraft", "the id of the environment")
    num_envs: int = field(1, "parallel envs (reference runs a single env)")
    num_minibatches: int = field(1, "mini-batches")
    update_epochs: int = field(1, "update epochs")


def main(args=None):
    args = args or cli(Args)
    device = device_from(args)
    env = make(args.env_id, device=device)
    cfg = ppo_config_from(args)
    model = seeded(args.seed, device, lambda: MultimodalRecurrentAgent(
        num_actions=env.num_actions,
        conv_type=args.conv_size,
        attn_type="gate",
        fusion_type="sum",
        input_scale=args.input_scale,
        device=device,
    ))
    return run_training(make_recurrent_ppo(env, model, cfg), cfg, args, device)


if __name__ == "__main__":
    main()

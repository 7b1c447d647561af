"""Evaluate a saved run: greedy episodes from a port checkpoint; twin of
``scripts/evaluate.py``.

    python -m mmtrl_tpu_torch.scripts.evaluate --load-from saved_agents/<run_name> \\
        --script train --env-id minecraft --attn-type casl

--script names the entry script whose model and architecture flags apply;
the checkpoint's model (``RunnerState.payload()["model"]``) is loaded into
a freshly built agent.  ``--script skeleton_plus_ppo`` rebuilds the
two-tower agent on the env's audio channels (two on ``skeleton_plus``,
the device simulator); give its ``--attn-type`` and ``--input-scale 1``,
as for the JAX script.  ``--script ppo`` rebuilds the classic-control MLP
agent on the env's observation width.  ``--env-id skeleton_plus_native``
evaluates on the Skeleton+ ROM's pool of ``--num-envs`` cartridges (the
sim -> ROM transfer check), stepped through its ``reset``/``step``; it
needs ``SkelPlus.bin`` (``$MMTRL_SKELETON_ROM`` or ``roms/``) and raises
``FileNotFoundError`` without it.  The host loops' own greedy evaluation
is their ``--eval-steps``; DQN's and C51's is their runner's.

    python -m mmtrl_tpu_torch.scripts.evaluate --load-from saved_agents/<run_name> \\
        --script skeleton_plus_ppo --env-id skeleton_plus --attn-type casl --input-scale 1
    python -m mmtrl_tpu_torch.scripts.evaluate --load-from saved_agents/<run_name> \\
        --script ppo --env-id CartPole-v1
"""

import dataclasses
from typing import Optional

import torch

from mmtrl_tpu_torch.core.checkpoint import load_run
from mmtrl_tpu_torch.core.config import cli
from mmtrl_tpu_torch.envs import make
from mmtrl_tpu_torch.models.agents import CNNAgent, MLPActorCritic, MultimodalRecurrentAgent
from mmtrl_tpu_torch.scripts._common import device_from, field
from mmtrl_tpu_torch.utils.evaluate import evaluate_policy


@dataclasses.dataclass
class Args:
    load_from: str = field("", "checkpoint path (saved_agents/<run_name>)")
    cuda: bool = field(True, "run on the CUDA card (raises without one); False: on the CPU")
    script: str = field("train", "entry script whose architecture to rebuild")
    env_id: str = field("minecraft", "environment id")
    seed: int = field(1, "evaluation seed")
    num_envs: int = field(16, "evaluation envs")
    num_steps: int = field(512, "evaluation env steps")
    greedy: bool = field(True, "argmax actions (False: sample)")
    attn_type: Optional[str] = field(None, "attention type (recurrent agents)")
    fusion_type: str = field("sum", "fusion type")
    conv_size: str = field("big", "conv tower size")
    input_scale: float = field(255.0, "observation divisor")


def build_model(args, env, device):
    """(agent, recurrent) for ``--script``."""
    if args.script in ("train", "minecraft_lstm", "skeleton_plus_ppo"):
        return MultimodalRecurrentAgent(
            num_actions=env.num_actions, conv_type=args.conv_size, attn_type=args.attn_type,
            fusion_type=args.fusion_type, input_scale=args.input_scale,
            audio_channels=env.observation_space.shape[0] - 1, device=device), True
    if args.script == "minecraft_lstm_attention":
        return MultimodalRecurrentAgent(
            num_actions=env.num_actions, conv_type=args.conv_size, attn_type="gate",
            fusion_type="sum", input_scale=args.input_scale, device=device), True
    if args.script == "minecraft_cnn":
        return CNNAgent(num_actions=env.num_actions, conv_type=args.conv_size,
                        input_scale=args.input_scale,
                        in_channels=env.observation_space.shape[0], device=device), False
    if args.script == "ppo":
        return MLPActorCritic(env.num_actions, env.observation_space.shape[0],
                              device=device), False
    raise SystemExit(f"unknown --script {args.script!r}")


def main(args=None):
    args = args or cli(Args)
    device = device_from(args)
    native = args.env_id.lower() == "skeleton_plus_native"
    # the ROM's pool has a fixed size, which must be the evaluation's
    env = (make(args.env_id, num_envs=args.num_envs, device=device) if native
           else make(args.env_id, device=device))
    try:
        model, recurrent = build_model(args, env, device)
        model.load_state_dict(load_run(args.load_from, map_location=device)["model"])
        carry = model.initial_carry(args.num_envs, device) if recurrent else None
        results = evaluate_policy(
            env, model, torch.Generator(device=device).manual_seed(args.seed),
            num_envs=args.num_envs, num_steps=args.num_steps, greedy=args.greedy,
            recurrent=recurrent, initial_carry=carry)
    finally:
        if native:
            env.close()
    results = {k: float(v) for k, v in results.items()}
    print(results)
    return results


if __name__ == "__main__":
    main()

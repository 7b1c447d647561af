"""Greedy AND sampled evaluations of a saved recurrent policy on a native
cartridge env; twin of ``tools/eval_rom_policy.py``.

Deterministic (argmax) policies can collapse on Breakout-class dynamics:
the ball and paddle phase-lock into a loop the argmax policy never breaks
(the classic ALE determinism pathology; the reference's Atari scripts
report stochastic training returns for the same reason).  The tool
reports both action rules from one checkpoint, so the gap itself is a
measurement.  The checkpoint is a run of the port's recurrent PPO entry
points (``rally_ppo``, ``brick_ppo``, ``skeleton_plus_ppo --backend
native``: the multimodal recurrent agent at input scale 1), evaluated by
``utils/evaluate.py::evaluate_policy`` on the card (``--cuda False``: on
the CPU).

    python -m mmtrl_tpu_torch.tools.eval_rom_policy \\
        --load-from saved_agents/brick_native__brick_ppo__1__<ts> \\
        --env-id brick_native --num-envs 8 --num-steps 4000
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

import torch

from mmtrl_tpu_torch import resolve_device
from mmtrl_tpu_torch.core.checkpoint import load_run
from mmtrl_tpu_torch.core.config import strtobool
from mmtrl_tpu_torch.envs.registry import make
from mmtrl_tpu_torch.models.agents import MultimodalRecurrentAgent
from mmtrl_tpu_torch.utils.evaluate import evaluate_policy


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--load-from", required=True)
    p.add_argument("--env-id", default="brick_native")
    p.add_argument("--num-envs", type=int, default=8)
    p.add_argument("--num-steps", type=int, default=4000)
    p.add_argument("--seed", type=int, default=11)
    p.add_argument("--conv-size", default="small")
    p.add_argument("--attn-type", default="casl")
    p.add_argument(
        "--repeat-action-probability", type=float, default=0.0,
        help="ALE-v5 sticky actions (the reference's envpool RND-Atari setting is 0.25, "
        "ppo_rnd_envpool.py:281); breaks the argmax phase-lock so a greedy eval measures "
        "policy quality, not emulator determinism")
    p.add_argument("--cuda", type=strtobool, default=True, nargs="?", const=True,
                   help="run on the CUDA card (raises without one); False: on the CPU")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Dict[str, float]]:
    """Prints and returns each action rule's mean return, mean length and
    episode count."""
    args = parse_args(argv)
    device = resolve_device(None if args.cuda else "cpu")
    env = make(args.env_id, num_envs=args.num_envs,
               repeat_action_probability=args.repeat_action_probability, device=device)
    try:
        model = MultimodalRecurrentAgent(
            num_actions=env.num_actions, conv_type=args.conv_size, attn_type=args.attn_type,
            fusion_type="sum", input_scale=1.0,
            audio_channels=env.observation_space.shape[0] - 1, device=device)
        model.load_state_dict(load_run(args.load_from, map_location=device)["model"])
        out = {}
        for greedy in (True, False):
            res = evaluate_policy(
                env, model, torch.Generator(device=device).manual_seed(args.seed),
                num_envs=args.num_envs, num_steps=args.num_steps, greedy=greedy,
                recurrent=True, initial_carry=model.initial_carry(args.num_envs, device))
            res = {k: float(v) for k, v in res.items()}
            tag = "greedy" if greedy else "sampled"
            print(f"{tag}: return={res['eval/episodic_return']:.2f} "
                  f"length={res['eval/episodic_length']:.1f} "
                  f"episodes={int(res['eval/episodes'])}")
            out[tag] = res
    finally:
        env.close()
    return out


if __name__ == "__main__":
    main()

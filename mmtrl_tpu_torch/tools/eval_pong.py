"""Match play of a self-play-trained PONG policy against fixed opponents;
twin of ``tools/eval_pong.py``.

Self-play training (``scripts/ppo_ma_pong.py``) has zero-sum rewards, so its
training curve cannot show absolute strength.  This tool plays the saved
shared policy as PLAYER 0 against a fixed PLAYER 1 on the cartridge and
reports per-episode points for and against, the score differential and
the episode win rate: the evidence that the multi-agent run learned
(reference contract: cleanrl/ppo_pettingzoo_ma_atari.py evaluates the
shared policy the same way, by match outcomes).

Opponents:
  noop     the right paddle never moves (measures serving and aim)
  random   uniform random actions
  tracker  a scripted ball-follower reading cartridge RAM ($84 BALLY, $88
           PAD1Y), the heuristic that beats an idle paddle 21-0
  self     a mirror match (the policy plays both sides; diff about 0)

Both action rules (greedy argmax and sampled) are reported, as in
``eval_rom_policy``.  The checkpoint is a ``ppo_ma_pong`` run of the port
(the multimodal recurrent agent, sum fusion, input scale 1); the policy
runs on the card (``--cuda False``: on the CPU), the cartridges on the
host.

    python -m mmtrl_tpu_torch.tools.eval_pong \\
        --load-from saved_agents/pong_ma_native__ppo_ma_pong__1__<ts> \\
        --opponent tracker --num-envs 8 --num-steps 3000
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from mmtrl_tpu_torch import resolve_device
from mmtrl_tpu_torch.core.checkpoint import load_run
from mmtrl_tpu_torch.core.config import strtobool
from mmtrl_tpu_torch.envs.pong_ma import NativePong2P
from mmtrl_tpu_torch.models.agents import MultimodalRecurrentAgent
from mmtrl_tpu_torch.models.distributions import categorical_sample

UP, DOWN = 3, 4  # the tracker's joystick actions


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--load-from", required=True)
    p.add_argument("--opponent", default="tracker", choices=["noop", "random", "tracker", "self"])
    p.add_argument("--num-envs", type=int, default=8)
    p.add_argument("--num-steps", type=int, default=3000)
    p.add_argument("--seed", type=int, default=11)
    p.add_argument("--conv-size", default="small")
    p.add_argument("--attn-type", default="casl")
    p.add_argument("--episode-steps", type=int, default=1500)
    p.add_argument("--repeat-action-probability", type=float, default=0.0)
    p.add_argument("--cuda", type=strtobool, default=True, nargs="?", const=True,
                   help="run on the CUDA card (raises without one); False: on the CPU")
    return p.parse_args(argv)


def tracker_actions(ram: np.ndarray) -> np.ndarray:
    """Player 1's ball-follower: up while the ball (RAM byte 4) lies above
    the paddle's middle (byte 8, plus 8), else down."""
    bally, p1y = ram[:, 4].astype(np.int32), ram[:, 8].astype(np.int32)
    return np.where(bally + 2 < p1y + 8, UP, DOWN)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Dict[str, float]]:
    """Prints each action rule's line and returns its mean differential,
    points for and against, win rate and episode count (an empty dict when
    no episode ended)."""
    args = parse_args(argv)
    device = resolve_device(None if args.cuda else "cpu")
    n = args.num_envs
    env = NativePong2P(num_envs=n, seed=args.seed, episode_steps=args.episode_steps,
                       repeat_action_probability=args.repeat_action_probability, device=device)
    try:
        model = MultimodalRecurrentAgent(
            num_actions=env.num_actions, conv_type=args.conv_size, attn_type=args.attn_type,
            fusion_type="sum", input_scale=1.0,
            audio_channels=env.observation_space.shape[0] - 1, device=device)
        model.load_state_dict(load_run(args.load_from, map_location=device)["model"])
        rng = np.random.default_rng(args.seed)
        out = {}
        for greedy in (True, False):
            generator = torch.Generator(device=device).manual_seed(args.seed)
            frames, audio = env._host_reset()
            carry = model.initial_carry(env.num_slots, device)
            done_slots = np.zeros(env.num_slots, np.uint8)
            pts_for, pts_against = np.zeros(n, np.int64), np.zeros(n, np.int64)
            ep_diff, ep_for, ep_against, wins = [], [], [], 0
            for _ in range(args.num_steps):
                obs = env._obs(frames, audio)  # (2n, 3, 84, 84)
                done = torch.as_tensor(done_slots.astype(bool), device=device)
                with torch.no_grad():
                    logits, _, carry = model(obs[None], done[None], carry)
                acts = (logits[0].argmax(-1) if greedy
                        else categorical_sample(generator, logits[0])).cpu().numpy()
                actions = np.zeros((n, 2), np.int32)
                actions[:, 0] = acts[0::2]  # the policy drives player 0
                if args.opponent == "self":
                    actions[:, 1] = acts[1::2]
                elif args.opponent == "random":
                    actions[:, 1] = rng.integers(0, env.num_actions, n)
                elif args.opponent == "tracker":
                    actions[:, 1] = tracker_actions(env.ram())
                # noop: player 1 stays at 0
                frames, audio, kd, _, done_slots, _, _, _ = env._host_step(actions.reshape(-1))
                sd0 = kd[0::2]  # slot 0's own minus the opponent's points
                pts_for += np.maximum(sd0, 0)
                pts_against += np.maximum(-sd0, 0)
                for i in np.nonzero(done_slots[0::2].astype(bool))[0]:
                    ep_for.append(int(pts_for[i]))
                    ep_against.append(int(pts_against[i]))
                    ep_diff.append(int(pts_for[i] - pts_against[i]))
                    wins += int(pts_for[i] > pts_against[i])
                    pts_for[i] = pts_against[i] = 0
            tag = "greedy" if greedy else "sampled"
            if ep_diff:
                res = dict(diff=float(np.mean(ep_diff)), points_for=float(np.mean(ep_for)),
                           points_against=float(np.mean(ep_against)),
                           winrate=wins / len(ep_diff), episodes=len(ep_diff))
                print(f"{tag} vs {args.opponent}: diff={res['diff']:+.2f} "
                      f"for={res['points_for']:.2f} against={res['points_against']:.2f} "
                      f"winrate={res['winrate']:.2f} episodes={res['episodes']}")
            else:
                res = {}
                print(f"{tag} vs {args.opponent}: no completed episodes")
            out[tag] = res
    finally:
        env.close()
    return out


if __name__ == "__main__":
    main()

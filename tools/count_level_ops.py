#!/usr/bin/env python3
"""Count the operations the procmaze and two-agent Minecraft2d paths
dispatch, on the CPU.

    python3 tools/count_level_ops.py

Counts (``TorchDispatchMode``, as ``tools/count_classic_ops.py`` does) the
non-view operations of: one ProcMaze step and one two-agent Minecraft2d
step (their counts do not depend on the batch); one PPG policy iteration
of ``scripts.ppg --env-id procmaze`` (8 envs; the rollout counted a step,
the update of 4 minibatches apart) and its aux phase (6 epochs x 4
minibatches and the 4 chunks of old logits; counted over a small store,
the count does not depend on its rows), and the agent's FLOPs a row and
a cycle's (counted on meta tensors); one step of the greedy evaluation;
and one ``ppo_ma_minecraft`` update at its defaults (8 slots x 128 steps,
4 x 4 minibatches), its rollout and update apart.  On the card nearly
every such operation is a kernel launch, so the count, multiplied by the
host's time an operation, predicts a wall.  Counts only; it times
nothing.
"""

import dataclasses
import os
import sys

import torch
from torch.utils.flop_counter import FlopCounterMode

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from count_classic_ops import Count  # noqa: E402

from mmtrl_tpu_torch.algos.ppo.core import feedforward_update  # noqa: E402
from mmtrl_tpu_torch.core.config import cli  # noqa: E402
from mmtrl_tpu_torch.envs.minecraft2d_ma import MultiAgentMinecraft2d  # noqa: E402
from mmtrl_tpu_torch.envs.procmaze import ProcMaze  # noqa: E402
from mmtrl_tpu_torch.scripts import ppg, ppo_ma_minecraft  # noqa: E402


def counted(fn):
    with Count() as c:
        out = fn()
    return out, c.ops, c.by_name


def top(by_name, k=6):
    return sorted(by_name.items(), key=lambda kv: -kv[1])[:k]


def main():
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    g = torch.Generator().manual_seed(0)
    for label, env, n in (("procmaze step", ProcMaze(device="cpu"), 8),
                          ("minecraft_ma step", MultiAgentMinecraft2d(device="cpu"), 8)):
        _, state = env.reset(n, g)
        env.step(state, torch.zeros(n, dtype=torch.long), g)
        _, ops, by_name = counted(lambda: env.step(state, torch.zeros(n, dtype=torch.long), g))
        print(f"{label}: {ops} operations; top {top(by_name)}")

    # PPG on procmaze: 8 envs, the rollout a step (16 steps counted), one
    # policy update of 4 minibatches; the aux phase of a 1-iteration cycle
    argv = ["--cuda", "False", "--env-id", "procmaze", "--num-steps", "16", "--n-iteration", "1"]
    args = cli(ppg.Args, argv)
    algo, _, _ = ppg.build(args)
    cfg = ppg.ppg_config_from(args)
    rs = algo.init_runner(torch.Generator().manual_seed(args.seed))
    (rs, data), roll_ops, _ = counted(lambda: algo.rollout(rs))
    policy_cfg = dataclasses.replace(cfg, update_epochs=cfg.e_policy, target_kl=None,
                                     clip_rewards=False)
    _, upd_ops, upd_names = counted(lambda: feedforward_update(policy_cfg, rs, data, None,
                                                               allow_unused=True))
    _, cycle_ops, _ = counted(lambda: algo.train_iteration(rs))
    aux_ops = cycle_ops - roll_ops - upd_ops
    steps = ppg.Args.num_steps
    per_iter = roll_ops / args.num_steps * steps + upd_ops
    print(f"ppg procmaze: rollout {roll_ops / args.num_steps:.1f} operations a step of "
          f"{args.num_envs} envs; policy update {upd_ops} ({cfg.num_minibatches} minibatches); "
          f"aux phase about {aux_ops} ({cfg.e_auxiliary} x {cfg.num_aux_minibatches}); "
          f"a policy iteration of {steps} steps {per_iter:.0f}; a cycle of "
          f"{ppg.Args.n_iteration} about {ppg.Args.n_iteration * per_iter + aux_ops:.0f}; "
          f"update top {top(upd_names)}")
    # the IMPALA agent's convolution and matmul FLOPs a row (meta tensors:
    # shapes only), forward and forward + backward, and so a cycle's
    meta = ppg.PPGAgent(4, (3, 84, 84), device="meta")
    x = torch.zeros(1, 3, 84, 84, device="meta")
    with FlopCounterMode(display=False) as fc:
        meta(x)
    fwd = fc.get_total_flops()
    with FlopCounterMode(display=False) as fc:
        logits, value, aux = meta(x)
        (logits.sum() + value.sum() + aux.sum()).backward()
    fwd_bwd = fc.get_total_flops()
    rows = ppg.Args.num_envs * steps * ppg.Args.n_iteration
    aux_flops = rows * fwd + ppg.Args.e_auxiliary * rows * fwd_bwd
    print(f"PPGAgent on (3, 84, 84): {fwd / 1e6:.1f} MFLOP a row forward, "
          f"{fwd_bwd / 1e6:.1f} forward + backward; a default cycle ({rows} rows): "
          f"aux phase {aux_flops / 1e12:.1f} TFLOP, policy phase "
          f"{rows * (fwd + fwd_bwd) / 1e12:.1f} (rollout forward, one epoch)")

    env = ProcMaze(device="cpu")
    obs, state = env.reset(ppg.EVAL_ENVS, g)
    model = rs.model

    def eval_step():
        with torch.no_grad():
            action = model(obs)[0].argmax(dim=-1)
        return env.step(state, action, g)

    _, ops, _ = counted(eval_step)
    print(f"greedy evaluation: {ops} operations a step; 2 x {ppg.Args.eval_rollout_steps} "
          f"steps {2 * ppg.Args.eval_rollout_steps * ops}")

    # ppo_ma_minecraft at its defaults
    args = cli(ppo_ma_minecraft.Args, ["--cuda", "False"])
    algo, cfg, _ = ppo_ma_minecraft.build(args)
    rs = algo.init_runner(torch.Generator().manual_seed(args.seed))
    (rs, data), roll_ops, _ = counted(lambda: algo.rollout(rs))
    _, upd_ops, upd_names = counted(lambda: algo.update_from_rollout(rs, data))
    print(f"ppo_ma_minecraft update ({cfg.num_envs} slots x {cfg.num_steps}, "
          f"{cfg.update_epochs} x {cfg.num_minibatches}): rollout {roll_ops} "
          f"({roll_ops / cfg.num_steps:.1f} a step), update {upd_ops}; "
          f"update top {top(upd_names)}")


if __name__ == "__main__":
    main()

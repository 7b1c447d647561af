#!/usr/bin/env python3
"""Count the operations the classic-control loops dispatch, on the CPU.

    python3 tools/count_classic_ops.py

Builds ``dqn --prioritized-replay``, ``dqn`` and ``c51`` at their defaults
with ``--total-timesteps 5120 --learning-starts 1024`` on the CPU, runs
three iterations, then counts (``TorchDispatchMode``) the non-view
operations of the fourth (512 env steps of 1 env, past ``learning_starts``)
and of one PPO update on CartPole at ``scripts.ppo``'s defaults; then the
same for ``ddpg``, ``td3`` and ``sac_continuous_action`` on Pendulum-v1
(an iteration past ``learning_starts``: every step trains) and for one
``ppo_continuous_action`` update at its defaults (4 x 2,048 steps, 32 x 10
minibatches), its rollout and update counted apart.  On the
card nearly every such operation is a kernel launch, so the count,
multiplied by the host's time an operation, predicts an iteration's wall.
Counts only; it times nothing.
"""

import os
import sys

import torch
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mmtrl_tpu_torch.core.config import cli  # noqa: E402
from mmtrl_tpu_torch.scripts import (  # noqa: E402
    c51,
    ddpg_continuous_action,
    dqn,
    ppo,
    ppo_continuous_action,
    sac_continuous_action,
    td3_continuous_action,
)

VIEWS = {"view", "_unsafe_view", "slice", "select", "expand", "t", "transpose", "unsqueeze",
         "squeeze", "as_strided", "alias", "detach", "reshape", "permute", "lift_fresh",
         "_to_copy"}


class Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops, self.by_name = 0, {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.__name__.split(".")[0]
        if name not in VIEWS:
            self.ops += 1
            self.by_name[name] = self.by_name.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


def main():
    torch.set_num_threads(1)
    for label, module, extra in (("dqn --prioritized-replay", dqn, ["--prioritized-replay"]),
                                 ("dqn", dqn, []), ("c51", c51, []),
                                 ("ddpg", ddpg_continuous_action, []),
                                 ("td3", td3_continuous_action, []),
                                 ("sac", sac_continuous_action, [])):
        args = cli(module.Args, ["--cuda", "False", "--total-timesteps", "5120",
                                 "--learning-starts", "1024"] + extra)
        algo, cfg, _, _ = module.build(args)
        runner = algo.init_runner(torch.Generator().manual_seed(args.seed))
        for _ in range(3):
            runner, _ = algo.train_iteration(runner)
        count = Count()
        with count:
            algo.train_iteration(runner)
        top = sorted(count.by_name.items(), key=lambda kv: -kv[1])[:8]
        print(f"{label}: {count.ops} operations an iteration, "
              f"{count.ops / cfg.steps_per_iteration:.1f} an env step; top {top}")
    args = cli(ppo.Args, ["--cuda", "False"])
    algo, _, _ = ppo.build(args)
    runner = algo.init_runner(torch.Generator().manual_seed(args.seed))
    count = Count()
    with count:
        algo.train_iteration(runner)
    print(f"ppo CartPole-v1 update (4 x 128): {count.ops} operations")
    args = cli(ppo_continuous_action.Args, ["--cuda", "False"])
    algo, cfg, _ = ppo_continuous_action.build(args)
    runner = algo.init_runner(torch.Generator().manual_seed(args.seed))
    rollout, update = Count(), Count()
    with rollout:
        runner, data = algo.rollout(runner)
    with update:
        algo.update_from_rollout(runner, data)
    print(f"ppo_continuous_action Pendulum-v1 update (4 x 2048, 32 x 10): rollout "
          f"{rollout.ops} operations ({rollout.ops / cfg.num_steps:.1f} a step of 4 envs), "
          f"update {update.ops} ({update.ops / cfg.opt_steps_per_update:.1f} a minibatch)")


if __name__ == "__main__":
    main()

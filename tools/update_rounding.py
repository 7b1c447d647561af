#!/usr/bin/env python3
"""Which ReLUs the float32 RND update of chip_smoke.py's ppo_family phase
switches, on the card and on the CPU, against the same update in float64.

    python3 tools/update_rounding.py

Replays that phase's RND update check (the same weights, rollout,
permutations, mask uniforms and CPU statistics, built by chip_smoke.py's
``ppo_update_case`` and ``rnd_update_case``) in float32 on the card and on
the CPU, and in float64 on the CPU, with TF32 off and cuDNN's deterministic
algorithms as the phase takes them.  At each of the update's 16 minibatch
steps it records the output of every layer that feeds a ReLU: the conv and
Dense layers of the agent's tower and of the predictor's trunk, and the
predictor's hidden Dense.  Prints one JSON line for each float32 side: per
step, the activations whose sign differs from float64's, layer by layer;
the steps with any; and the largest parameter difference from float64
after the update, for the agent and for the predictor, with the card's
name and power limit.  Exits 1 without CUDA.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402


def replay(case, stats, device: str, dtype: torch.dtype):
    """The case's update of copies of its CPU modules on ``device`` in
    ``dtype``: (the agent and the predictor after it, the ReLU-feeding
    layers' names, per step their outputs in float64 on the CPU)."""
    from mmtrl_tpu_torch.algos.ppo.rnd import make_rnd_ppo
    from mmtrl_tpu_torch.envs.minecraft2d import Minecraft2d

    def convert(x):
        return (x.to(dtype) if x.is_floating_point() else x).to(device)

    agent, target, predictor = (copy.deepcopy(m).to(device=device, dtype=dtype)
                                for m in case.cpu)
    layers = {**{f"agent.{k}": m for k, m in agent.network.named_children()},
              **{f"predictor.trunk.{k}": m for k, m in predictor.trunk.named_children()},
              "predictor.Dense_0": predictor.Dense_0}
    outputs = []

    def record(module, inputs, output):
        if torch.is_grad_enabled():  # the minibatch steps, not the bootstrap value
            outputs.append(output.detach().cpu().double())

    hooks = [m.register_forward_hook(record) for m in layers.values()]
    try:
        algo = make_rnd_ppo(Minecraft2d(device=device), agent, case.cfg, target, predictor)
        rs = algo.init_runner(torch.Generator(device=device).manual_seed(chip_smoke.SEED))
        rs = dataclasses.replace(rs, obs=convert(case.runner.obs),
                                 done=convert(case.runner.done))
        on_side = (*(type(x)(convert(x.mean), convert(x.var), convert(x.count))
                     for x in stats[:2]), convert(stats[2]))
        algo.update_from_rollout(rs, tuple(map(convert, case.data)), case.perms, case.masks,
                                 on_side)
    finally:
        for h in hooks:
            h.remove()
    n = len(layers)
    steps = [outputs[i:i + n] for i in range(0, len(outputs), n)]
    return (agent, predictor), list(layers), steps


def main() -> int:
    if not torch.cuda.is_available():
        print("update_rounding: CUDA is not available; nothing was run", file=sys.stderr)
        return 1
    from mmtrl_tpu_torch.algos.ppo.rnd import make_rnd_ppo
    from mmtrl_tpu_torch.envs.minecraft2d import Minecraft2d

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    smi = chip_smoke.card()
    _, g = chip_smoke.ppo_update_case()
    case = chip_smoke.rnd_update_case(g)
    stats = make_rnd_ppo(Minecraft2d(device="cpu"), case.cpu[0], case.cfg,
                         *case.cpu[1:]).statistics(case.runner, case.data)
    exact, names, exact_steps = replay(case, stats, "cpu", torch.float64)
    for side, device in (("card float32", "cuda"), ("cpu float32", "cpu")):
        nets, _, steps = replay(case, stats, device, torch.float32)
        flips = [[int(((a > 0) != (b > 0)).sum()) for a, b in zip(step, ref, strict=True)]
                 for step, ref in zip(steps, exact_steps, strict=True)]
        print(json.dumps({
            "side": side, "layers": names, "relu_sign_flips_by_step": flips,
            "steps_with_flips": [i + 1 for i, f in enumerate(flips) if any(f)],
            "agent_param_err_vs_float64": chip_smoke.param_err(nets[:1], exact[:1])[0],
            "predictor_param_err_vs_float64": chip_smoke.param_err(nets[1:], exact[1:])[0],
            "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Experiment submission — the reference's cleanrl_utils/submit_exp.py;
port of ``mmtrl_tpu/utils/submit_exp.py``.

The reference submits to AWS Batch or prints docker commands (reference
:103-142).  Without network access, submission targets are the
local queue runner or a user-provided remote hook; this tool renders the
commands (docker or bare) and either writes an exp script for
queue_runner or prints them.

    python -m mmtrl_tpu_torch.utils.submit_exp \
        --command "python -m mmtrl_tpu_torch.scripts.ppo --total-timesteps 100000" \
        --env-ids CartPole-v1 --num-seeds 2 --docker-tag mmtrl-tpu:latest
"""

from __future__ import annotations

import argparse


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--command", required=True)
    parser.add_argument("--env-ids", nargs="+", required=True)
    parser.add_argument("--num-seeds", type=int, default=1)
    parser.add_argument("--docker-tag", default="")
    parser.add_argument("--exp-script", default="", help="write commands here")
    args = parser.parse_args(argv)

    commands = []
    for seed in range(1, args.num_seeds + 1):
        for env_id in args.env_ids:
            cmd = f"{args.command} --env-id {env_id} --seed {seed}"
            if args.docker_tag:
                cmd = (
                    f"docker run --rm --privileged -v $(pwd):/workspace/mmtrl-tpu "
                    f"{args.docker_tag} {cmd.split(' ', 1)[1]}"
                )
            commands.append(cmd)
    if args.exp_script:
        with open(args.exp_script, "w") as f:
            f.write("\n".join(commands) + "\n")
        print(f"wrote {len(commands)} commands to {args.exp_script}; run with "
              f"python -m mmtrl_tpu_torch.utils.queue_runner --exp-script {args.exp_script}")
    else:
        print("\n".join(commands))


if __name__ == "__main__":
    main()

"""TD3, the reference's cleanrl/td3_continuous_action(_jax).py; twin of
``scripts/td3_continuous_action.py``: ``ddpg_continuous_action``'s CLI
with target-policy smoothing, on ``algos/offpolicy/td3.py::make_td3``
(twin ``QFunction``s initialised apart).

    python -m mmtrl_tpu_torch.scripts.td3_continuous_action --env-id Pendulum-v1
"""

import dataclasses

from mmtrl_tpu_torch.algos.offpolicy.runner import run_offpolicy
from mmtrl_tpu_torch.algos.offpolicy.td3 import TD3Config, make_td3
from mmtrl_tpu_torch.core.config import cli
from mmtrl_tpu_torch.scripts import ddpg_continuous_action as ddpg
from mmtrl_tpu_torch.scripts._common import config_of, field


@dataclasses.dataclass
class Args(ddpg.Args):
    exp_name: str = field("td3_continuous_action", "the name of this experiment")
    policy_noise: float = field(0.2, "target policy smoothing noise scale")
    noise_clip: float = field(0.5, "smoothing noise clip")


def build(args):
    """(algorithm, run config, device, env) of a run."""
    env, device = ddpg.env_and_device(args)
    cfg = config_of(TD3Config, args)
    actor = ddpg.deterministic_actor(args, env, device)
    qf1, qf2 = (ddpg.q_function(args.seed + k, env, device) for k in (1, 2))
    return make_td3(env, actor, qf1, qf2, cfg), cfg, device, env


def main(args=None):
    args = args or cli(Args)
    algo, cfg, device, env = build(args)
    return run_offpolicy(algo, cfg, args, device,
                         eval_setup=(env, lambda actor, obs: actor(obs), lambda ts: ts.actor.model))


if __name__ == "__main__":
    main()

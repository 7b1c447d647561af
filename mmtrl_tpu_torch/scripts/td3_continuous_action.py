"""TD3, the reference's cleanrl/td3_continuous_action(_jax).py; twin of
``scripts/td3_continuous_action.py``: ``ddpg_continuous_action``'s CLI
with target-policy smoothing, on ``algos/offpolicy/td3.py::make_td3``
(twin ``QFunction``s initialised apart); ``--host-loop`` and the gymnasium
ids as there.

    python -m mmtrl_tpu_torch.scripts.td3_continuous_action --env-id Pendulum-v1
    python -m mmtrl_tpu_torch.scripts.td3_continuous_action --cuda False --host-loop \\
        --env-id Hopper-v4 --total-timesteps 2048 --learning-starts 512 --batch-size 64
"""

import dataclasses

from mmtrl_tpu_torch.algos.offpolicy.td3 import TD3Config, make_td3
from mmtrl_tpu_torch.core.config import cli
from mmtrl_tpu_torch.scripts import ddpg_continuous_action as ddpg
from mmtrl_tpu_torch.scripts._common import field


@dataclasses.dataclass
class Args(ddpg.Args):
    exp_name: str = field("td3_continuous_action", "the name of this experiment")
    policy_noise: float = field(0.2, "target policy smoothing noise scale")
    noise_clip: float = field(0.5, "smoothing noise clip")


def networks(args, env, device):
    """(actor, critics) of a run."""
    return (ddpg.deterministic_actor(args, env, device),
            [ddpg.q_function(args.seed + k, env, device) for k in (1, 2)])


def build(args):
    """(algorithm, run config, device, env) of a fused run."""
    return ddpg.build(args, make_td3, TD3Config, networks)


def main(args=None):
    return ddpg.run(args or cli(Args), make_td3, TD3Config, networks)


if __name__ == "__main__":
    main()

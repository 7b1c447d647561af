"""Robust Policy Optimization, the reference's cleanrl/rpo_continuous_action.py;
twin of ``scripts/rpo_continuous_action.py``: ``ppo_continuous_action``
with a uniform perturbation of the Gaussian mean when the update evaluates
stored actions (``--rpo-alpha``, 0.5 by default).

    python -m mmtrl_tpu_torch.scripts.rpo_continuous_action --rpo-alpha 0.5
"""

import dataclasses

from mmtrl_tpu_torch.core.config import cli
from mmtrl_tpu_torch.scripts import ppo_continuous_action
from mmtrl_tpu_torch.scripts._common import field


@dataclasses.dataclass
class Args(ppo_continuous_action.Args):
    exp_name: str = field("rpo_continuous_action", "the name of this experiment")
    rpo_alpha: float = field(0.5, "RPO mean-perturbation radius")


def main(args=None):
    return ppo_continuous_action.main(args or cli(Args))


if __name__ == "__main__":
    main()

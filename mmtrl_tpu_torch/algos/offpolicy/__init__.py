"""Value learning on the native cartridges: DQN and C51 through the host
loop (``hostloop_dqn``).  The fused device paths of the JAX package
(``make_dqn``, ``make_c51``), PER, DDPG, TD3 and SAC are not ported yet
(ROADMAP A.6)."""

from mmtrl_tpu_torch.algos.offpolicy.c51 import (
    C51Config,
    c51_td_update,
    categorical_projection,
    expected_q_greedy,
)
from mmtrl_tpu_torch.algos.offpolicy.common import linear_epsilon
from mmtrl_tpu_torch.algos.offpolicy.dqn import (
    DQNConfig,
    DQNTrainState,
    create_dqn_state,
    dqn_td_update,
)

__all__ = ["C51Config", "DQNConfig", "DQNTrainState", "c51_td_update", "categorical_projection",
           "create_dqn_state", "dqn_td_update", "expected_q_greedy", "linear_epsilon"]

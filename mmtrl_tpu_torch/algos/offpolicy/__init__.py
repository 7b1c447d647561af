"""Value learning: DQN and C51 through the fused device loops
(``make_dqn`` with uniform or prioritized replay, ``make_c51``; the
classic-control twins) and through the host loop on the native cartridges
(``hostloop_dqn``).  DDPG, TD3 and SAC and the gymnasium host loop are not
ported yet (ROADMAP A.6, A.7)."""

from mmtrl_tpu_torch.algos.offpolicy.c51 import (
    C51Config,
    c51_td_update,
    categorical_projection,
    expected_q_greedy,
    make_c51,
)
from mmtrl_tpu_torch.algos.offpolicy.common import OffPolicyRunner, StepDraws, linear_epsilon
from mmtrl_tpu_torch.algos.offpolicy.dqn import (
    DQNConfig,
    DQNTrainState,
    create_dqn_state,
    dqn_td_update,
    make_dqn,
)

__all__ = ["C51Config", "DQNConfig", "DQNTrainState", "OffPolicyRunner", "StepDraws",
           "c51_td_update", "categorical_projection", "create_dqn_state", "dqn_td_update",
           "expected_q_greedy", "linear_epsilon", "make_c51", "make_dqn"]

"""Off-policy learning through the fused device loops: DQN and C51
(``make_dqn`` with uniform or prioritized replay, ``make_c51``) and the
continuous-control DDPG, TD3 and SAC (``make_ddpg``, ``make_td3``,
``make_sac``); DQN and C51 also through the host loop on the native
cartridges (``hostloop_dqn``), DDPG, TD3 and SAC through the host loop on
gymnasium envs (``hostloop``, their ``chunk_fn``)."""

from mmtrl_tpu_torch.algos.offpolicy.c51 import (
    C51Config,
    c51_td_update,
    categorical_projection,
    expected_q_greedy,
    make_c51,
)
from mmtrl_tpu_torch.algos.offpolicy.common import OffPolicyRunner, StepDraws, linear_epsilon
from mmtrl_tpu_torch.algos.offpolicy.ddpg import (
    ActorCriticState,
    ContinuousDraws,
    DDPGConfig,
    make_ddpg,
)
from mmtrl_tpu_torch.algos.offpolicy.dqn import (
    DQNConfig,
    DQNTrainState,
    create_dqn_state,
    dqn_td_update,
    make_dqn,
)
from mmtrl_tpu_torch.algos.offpolicy.sac import SACConfig, make_sac
from mmtrl_tpu_torch.algos.offpolicy.td3 import TD3Config, make_td3

__all__ = ["ActorCriticState", "C51Config", "ContinuousDraws", "DDPGConfig", "DQNConfig",
           "DQNTrainState", "OffPolicyRunner", "SACConfig", "StepDraws", "TD3Config",
           "c51_td_update", "categorical_projection", "create_dqn_state", "dqn_td_update",
           "expected_q_greedy", "linear_epsilon", "make_c51", "make_ddpg", "make_dqn",
           "make_sac", "make_td3"]

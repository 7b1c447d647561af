"""Proximal policy optimization: the feedforward (discrete and
continuous, with RPO) and recurrent (LSTM) variants; PPO + RND in ``rnd``,
PPG in ``ppg``."""

from mmtrl_tpu_torch.algos.ppo.core import (
    PPOConfig,
    RunnerState,
    make_continuous_ppo,
    make_ppo,
    make_recurrent_ppo,
)

__all__ = ["PPOConfig", "RunnerState", "make_continuous_ppo", "make_ppo", "make_recurrent_ppo"]

"""Proximal policy optimization: the recurrent (LSTM) variant."""

from mmtrl_tpu_torch.algos.ppo.core import PPOConfig, RunnerState, make_recurrent_ppo

__all__ = ["PPOConfig", "RunnerState", "make_recurrent_ppo"]

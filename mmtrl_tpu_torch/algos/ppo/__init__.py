"""Proximal policy optimization: the feedforward and recurrent (LSTM)
variants; PPO + RND in ``rnd``, PPG in ``ppg``."""

from mmtrl_tpu_torch.algos.ppo.core import PPOConfig, RunnerState, make_ppo, make_recurrent_ppo

__all__ = ["PPOConfig", "RunnerState", "make_ppo", "make_recurrent_ppo"]

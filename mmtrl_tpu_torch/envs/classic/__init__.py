"""The discrete classic-control envs, batched on the device; port of
``mmtrl_tpu/envs/classic`` (Pendulum is not ported yet, ROADMAP A.6)."""

from mmtrl_tpu_torch.envs.classic.acrobot import Acrobot
from mmtrl_tpu_torch.envs.classic.cartpole import CartPole
from mmtrl_tpu_torch.envs.classic.mountain_car import MountainCar

__all__ = ["Acrobot", "CartPole", "MountainCar"]

"""The classic-control envs, batched on the device; port of
``mmtrl_tpu/envs/classic``: CartPole, Acrobot and MountainCar (discrete
actions) and Pendulum (a continuous torque)."""

from mmtrl_tpu_torch.envs.classic.acrobot import Acrobot
from mmtrl_tpu_torch.envs.classic.cartpole import CartPole
from mmtrl_tpu_torch.envs.classic.mountain_car import MountainCar
from mmtrl_tpu_torch.envs.classic.pendulum import Pendulum

__all__ = ["Acrobot", "CartPole", "MountainCar", "Pendulum"]

"""Environment registry: ``make(env_id)`` like the reference's make_env
thunks; port of ``mmtrl_tpu/envs/registry.py``, every id of which it has:
Minecraft2d, its two-agent variant (``minecraft_ma``), Doorpuzzle
(``doorpuzzle``), ProcMaze (``procmaze``), the classic-control envs
(``CartPole-v1``, ``Acrobot-v1``, ``MountainCar-v0``, ``Pendulum-v1``),
the Skeleton+ device simulator (``skeleton_plus``) and the native 2600
cartridges (``rally_native``, ``brick_native``, the two-player
``pong_ma_native`` and ``skeleton_plus_native``, the last needing
SkelPlus.bin, which is not in the repository).  ``make`` passes its
keyword arguments to the env (``device``, ``use_audio``, Doorpuzzle's
``hard_mode``, ProcMaze's ``num_levels`` and ``start_level``, the samplers;
the native envs' ``num_envs``, ``rom_path``, ``seed``, ...)."""

from __future__ import annotations

from typing import Callable, Dict

from mmtrl_tpu_torch.envs.base import Environment
from mmtrl_tpu_torch.envs.classic import Acrobot, CartPole, MountainCar, Pendulum
from mmtrl_tpu_torch.envs.doorpuzzle import Doorpuzzle
from mmtrl_tpu_torch.envs.homebrew_native import NativeBrick, NativeHomebrew
from mmtrl_tpu_torch.envs.minecraft2d import Minecraft2d
from mmtrl_tpu_torch.envs.minecraft2d_ma import MultiAgentMinecraft2d
from mmtrl_tpu_torch.envs.pong_ma import NativePong2P
from mmtrl_tpu_torch.envs.procmaze import ProcMaze
from mmtrl_tpu_torch.envs.skeleton_native import NativeSkeletonPlus
from mmtrl_tpu_torch.envs.skeleton_plus import SkeletonPlusSim

registry: Dict[str, Callable[..., Environment]] = {}


def register(*names: str):
    def deco(factory):
        for n in names:
            registry[n.lower()] = factory
        return factory

    return deco


register("CartPole-v1", "CartPole")(CartPole)
register("Acrobot-v1", "Acrobot")(Acrobot)
register("MountainCar-v0", "MountainCar")(MountainCar)
register("Pendulum-v1", "Pendulum")(Pendulum)
register("minecraft", "Minecraft2d")(Minecraft2d)
register("doorpuzzle", "Doorpuzzle")(Doorpuzzle)
register("skeleton_plus", "SkeletonPlus")(SkeletonPlusSim)
register("skeleton_plus_native")(NativeSkeletonPlus)
register("rally_native")(NativeHomebrew)
register("brick_native")(NativeBrick)
register("pong_ma_native")(NativePong2P)
register("minecraft_ma", "MultiAgentMinecraft2d")(MultiAgentMinecraft2d)
register("procmaze", "ProcMaze")(ProcMaze)


def make(env_id: str, **kwargs) -> Environment:
    key = env_id.lower()
    if key not in registry:
        raise KeyError(f"unknown env {env_id!r}; available: {sorted(registry)}")
    return registry[key](**kwargs)

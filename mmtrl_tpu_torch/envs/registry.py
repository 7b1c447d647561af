"""Environment registry: ``make(env_id)`` like the reference's make_env
thunks; port of ``mmtrl_tpu/envs/registry.py``.  Only Minecraft2d is
ported so far; ``make`` passes its keyword arguments (``device``,
``use_audio``) to the env."""

from __future__ import annotations

from typing import Callable, Dict

from mmtrl_tpu_torch.envs.base import Environment
from mmtrl_tpu_torch.envs.minecraft2d import Minecraft2d

registry: Dict[str, Callable[..., Environment]] = {}


def register(*names: str):
    def deco(factory):
        for n in names:
            registry[n.lower()] = factory
        return factory

    return deco


register("minecraft", "Minecraft2d")(Minecraft2d)


def make(env_id: str, **kwargs) -> Environment:
    key = env_id.lower()
    if key not in registry:
        raise KeyError(f"unknown env {env_id!r}; available: {sorted(registry)}")
    return registry[key](**kwargs)

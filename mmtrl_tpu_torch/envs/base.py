"""Batched environment API on tensors; port of ``mmtrl_tpu/envs/base.py``.

An environment steps a whole batch of envs at once: its state is a
dataclass of tensors with the batch on dim 0, and ``step`` auto-resets the
envs that are done, as the JAX env does (on done, obs and state come from a
fresh reset, reward and done from the terminal transition).  Reset draws
come from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from mmtrl_tpu_torch.envs import spaces

EnvState = Any
StepResult = Tuple[torch.Tensor, EnvState, torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]


def _expand(pred: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return pred.reshape(pred.shape + (1,) * (like.dim() - pred.dim()))


def tree_select(pred: torch.Tensor, on_true, on_false):
    """Fieldwise ``where`` between two states of one dataclass type."""
    return type(on_true)(**{
        f.name: torch.where(
            _expand(pred, getattr(on_true, f.name)),
            getattr(on_true, f.name),
            getattr(on_false, f.name),
        )
        for f in dataclasses.fields(on_true)
    })


class Environment(abc.ABC):
    """Subclasses implement ``reset`` and ``_step_env``; ``step`` adds the
    auto-reset, drawing a reset for every env each step as the JAX env does."""

    device: torch.device

    @abc.abstractmethod
    def reset(
        self, num_envs: int, generator: Optional[torch.Generator] = None
    ) -> Tuple[torch.Tensor, EnvState]:
        ...

    @abc.abstractmethod
    def _step_env(self, state: EnvState, action: torch.Tensor) -> StepResult:
        ...

    @property
    @abc.abstractmethod
    def observation_space(self) -> spaces.Box:
        ...

    @property
    @abc.abstractmethod
    def action_space(self) -> spaces.Discrete:
        ...

    @property
    def name(self) -> str:
        return type(self).__name__

    @property
    def num_actions(self) -> int:
        return self.action_space.n

    def step(
        self,
        state: EnvState,
        action: torch.Tensor,
        generator: Optional[torch.Generator] = None,
    ) -> StepResult:
        obs_st, state_st, reward, done, info = self._step_env(state, action)
        obs_rs, state_rs = self.reset(action.shape[0], generator)
        state = tree_select(done, state_rs, state_st)
        obs = torch.where(_expand(done, obs_st), obs_rs, obs_st)
        info = dict(info)
        info["final_obs"] = obs_st  # the true post-transition observation
        return obs, state, reward, done, info

"""Decision-transformer algorithms: data, training and evaluation."""

from mmtrl_tpu_torch.algos.dt.data import (
    TrajectoryBuffer,
    collect_trajectories,
    returns_to_go,
)
from mmtrl_tpu_torch.algos.dt.evaluate import evaluate_dt
from mmtrl_tpu_torch.algos.dt.train import (
    DTTrainConfig,
    create_dt_state,
    make_dt_train_step,
    make_dt_train_steps,
)

__all__ = [
    "collect_trajectories",
    "returns_to_go",
    "TrajectoryBuffer",
    "DTTrainConfig",
    "make_dt_train_step",
    "make_dt_train_steps",
    "create_dt_state",
    "evaluate_dt",
]

"""Decision-transformer algorithms (evaluation so far)."""

from mmtrl_tpu_torch.algos.dt.evaluate import evaluate_dt

__all__ = ["evaluate_dt"]

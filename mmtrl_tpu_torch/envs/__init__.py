from mmtrl_tpu_torch.envs.registry import make, register

__all__ = ["make", "register"]

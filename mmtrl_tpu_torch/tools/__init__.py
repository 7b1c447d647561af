"""Evaluation tools of saved policies; twins of the JAX repo's ``tools/``
evaluation scripts, each run as ``python -m mmtrl_tpu_torch.tools.<name>``."""

"""Entry scripts of the port, twins of the JAX package's ``scripts/``:

    python -m mmtrl_tpu_torch.scripts.train --env-id minecraft --attn-type casl
    python -m mmtrl_tpu_torch.scripts.dt_minecraft --policy-from <checkpoint>

They run on the card; ``--cuda False`` runs them on the CPU."""

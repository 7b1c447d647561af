"""flax parameter trees -> PyTorch state dicts for the ported modules.

The ported modules keep flax's module names, so a path in the flax tree is
the ``state_dict`` key with its leaf renamed and, for kernels, transposed:

- Dense ``kernel`` (in, out) -> Linear ``weight`` (out, in);
- Conv ``kernel`` HWIO -> ``weight`` OIHW;
- Embed ``embedding`` -> ``weight``; LayerNorm ``scale`` -> ``weight``;
- ``bias`` copies over.

Load the result with ``model.load_state_dict(sd, strict=True)``, which
checks that every name and shape lines up.  ``adam_state_from_flax`` maps an
optax ``ScaleByAdamState`` the same way, so a JAX train state carries over
whole.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Sequence

import numpy as np
import torch

from mmtrl_tpu_torch.ops.fused_optim import ScaleByAdamState


def _leaf(name: str, value: np.ndarray):
    if name == "kernel":
        if value.ndim == 2:
            return "weight", value.T
        if value.ndim == 4:
            return "weight", value.transpose(3, 2, 0, 1)
        raise ValueError(f"kernel of rank {value.ndim}")
    if name in ("embedding", "scale"):
        return "weight", value
    if name == "bias":
        return "bias", value
    raise ValueError(f"unknown flax leaf {name!r}")


def dt_params_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """State dict of a flax tree of numpy arrays (``{'params': ...}`` or the
    inner tree), for the DT or any of its submodules."""
    if set(params) == {"params"}:
        params = params["params"]
    out: Dict[str, torch.Tensor] = {}

    def walk(tree: Mapping[str, Any], prefix: str):
        for key, value in tree.items():
            if isinstance(value, Mapping):
                walk(value, f"{prefix}{key}.")
            else:
                name, array = _leaf(key, np.asarray(value, dtype=np.float32))
                out[prefix + name] = torch.tensor(array)

    walk(params, "")
    return out


def adam_state_from_flax(count: Any, mu: Mapping[str, Any], nu: Mapping[str, Any],
                         names: Sequence[str]):
    """``ops.fused_optim.ScaleByAdamState`` of an optax ``ScaleByAdamState``
    (``count``, and ``mu`` and ``nu`` trees shaped like the params), its
    moments in the order of ``names``, the model's ``named_parameters()``."""
    moments = [dt_params_from_flax(tree) for tree in (mu, nu)]
    for sd in moments:
        if set(sd) != set(names):
            raise ValueError(
                f"moments do not match the parameters: missing "
                f"{sorted(set(names) - set(sd))}, unexpected {sorted(set(sd) - set(names))}"
            )
    return ScaleByAdamState(
        count=torch.tensor(int(np.asarray(count)), dtype=torch.int32),
        mu=[moments[0][n] for n in names],
        nu=[moments[1][n] for n in names],
    )

"""flax parameter trees -> PyTorch state dicts for the ported modules.

The ported modules keep flax's module names, so a path in the flax tree is
the ``state_dict`` key with its leaf renamed and, for kernels, transposed:

- Dense ``kernel`` (in, out) -> Linear ``weight`` (out, in);
- Conv ``kernel`` HWIO -> ``weight`` OIHW;
- Embed ``embedding`` -> ``weight``; LayerNorm ``scale`` -> ``weight``;
- ``bias`` copies over;
- the MoE experts' stacked ``experts_w1/b1/w2/b2`` copy over unchanged:
  the port stores the (E, D, F) and (E, F, D) layouts as flax does.

Load the result with ``model.load_state_dict(sd, strict=True)``, which
checks that every name and shape lines up.  The same walk serves every
ported model (``agent_params_from_flax``): the recurrent agents,
``CNNAgent``, the google variant's ``GoogleAgent`` (its hidden heads
``Dense_0`` and ``Dense_1``), ``RNDAgent``, the RND target and predictor
(``trunk``, ``Dense_0``, and the predictor's ``Dense_1``) and ``PPGAgent``,
whose IMPALA trunk keeps flax's auto-numbered names
(``network.ConvSequence_0.Conv_0``,
``network.ConvSequence_0.ResidualBlock_1.Conv_1``, ...).
``adam_state_from_flax`` maps an optax ``ScaleByAdamState`` the same way,
and ``ppo_opt_state_from_flax`` finds that state inside an optimizer's
chain (the PPO optimizer's, or the RND predictor's plain ``optax.adam``),
so a JAX train state carries over whole.  The Q networks (``QNetwork``,
``DistributionalQNetwork``: ``network`` and ``q``) take the same walk, and
``dqn_payload_from_flax`` maps a whole ``DQNTrainState`` (params, target
params, Adam state) onto the payload ``DQNTrainState.load_payload`` reads.
``ContinuousActorCritic``'s state-independent ``log_std`` copies over as a
leaf; ``actor_critic_payload_from_flax`` maps DDPG's, TD3's and SAC's
whole train states (actor, critics, targets, each Adam state, and SAC's
``log_alpha`` with its Adam state) onto ``ActorCriticState``'s payload.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch

from mmtrl_tpu_torch.ops.fused_optim import ScaleByAdamState


# The port's weight of a flax kernel of each rank: its dimension i is the
# kernel's dimension _KERNEL_TO_PORT[rank][i] (Dense (in, out) -> (out, in),
# Conv HWIO -> OIHW).
_KERNEL_TO_PORT = {2: (1, 0), 4: (3, 2, 0, 1)}


def kernel_port_dims(ndim: int) -> Tuple[int, ...]:
    """For each dimension of a flax kernel of rank ``ndim``, the port
    weight's dimension that holds it."""
    if ndim not in _KERNEL_TO_PORT:
        raise ValueError(f"kernel of rank {ndim}")
    return tuple(_KERNEL_TO_PORT[ndim].index(d) for d in range(ndim))


def _leaf(name: str, value: np.ndarray):
    if name == "kernel":
        if value.ndim not in _KERNEL_TO_PORT:
            raise ValueError(f"kernel of rank {value.ndim}")
        return "weight", value.transpose(_KERNEL_TO_PORT[value.ndim])
    if name in ("embedding", "scale"):
        return "weight", value
    if name in ("bias", "log_std") or name.startswith("experts_"):
        return name, value
    raise ValueError(f"unknown flax leaf {name!r}")


def _flax_leaves(params: Mapping[str, Any]):
    """(state-dict name, flax leaf name, float32 array in flax's layout) of
    every leaf of a flax tree (``{'params': ...}`` or the inner tree)."""
    if set(params) == {"params"}:
        params = params["params"]

    def walk(tree: Mapping[str, Any], prefix: str):
        for key, value in tree.items():
            if isinstance(value, Mapping):
                yield from walk(value, f"{prefix}{key}.")
            else:
                array = np.asarray(value, dtype=np.float32)
                yield prefix + _leaf(key, array)[0], key, array

    yield from walk(params, "")


def dt_params_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """State dict of a flax tree of numpy arrays (``{'params': ...}`` or the
    inner tree), for the DT or any of its submodules."""
    return {name: torch.tensor(_leaf(key, array)[1])
            for name, key, array in _flax_leaves(params)}


def dt_tp_params_from_flax(params: Mapping[str, Any], tp: int,
                           index: int) -> Dict[str, torch.Tensor]:
    """Rank ``index``'s state dict of a DT under ``tp``-way tensor
    parallelism (``parallel/sharding.py::shard_dt_params``)."""
    from mmtrl_tpu_torch.parallel.sharding import tp_slice

    return {name: tp_slice(name, t, tp, index)
            for name, t in dt_params_from_flax(params).items()}


def dt_fsdp_params_from_flax(params: Mapping[str, Any], axis_size: int, index: int,
                             min_size: int = 2**14) -> Dict[str, torch.Tensor]:
    """Rank ``index``'s state dict of a DT under FSDP over ``axis_size``
    ranks (``parallel/sharding.py::shard_fsdp_params``): JAX's rule picks
    the dimension on flax's layout, which the leaf's transpose maps to the
    port's."""
    from mmtrl_tpu_torch.parallel.sharding import fsdp_dim

    out = {}
    for name, key, array in _flax_leaves(params):
        tensor = torch.tensor(_leaf(key, array)[1])
        d = fsdp_dim(array.shape, axis_size, min_size)
        if d is not None:
            dim = kernel_port_dims(array.ndim)[d] if key == "kernel" else d
            tensor = tensor.chunk(axis_size, dim)[index].contiguous()
        out[name] = tensor
    return out


def stage_params_from_flax(stacked: Mapping[str, Any], stage: int) -> List[Dict[str, torch.Tensor]]:
    """The state dicts of stage ``stage``'s layers, from a flax tree whose
    leaves stack (stage, layer, ...) as JAX's ``stack_stage_params`` twice
    over builds them: each pipeline rank's part."""
    shapes = []
    tree = _map_arrays(lambda a: shapes.append(np.shape(a)) or np.asarray(a)[stage], stacked)
    return [dt_params_from_flax(_map_arrays(lambda a: a[i], tree))
            for i in range(shapes[0][1])]


def _map_arrays(fn, tree: Mapping[str, Any]) -> Dict[str, Any]:
    return {k: _map_arrays(fn, v) if isinstance(v, Mapping) else fn(v) for k, v in tree.items()}


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


# The recurrent agents keep flax's nesting (``core.attn``, ``core.lstm``),
# so the generic walk maps them, every attention variant included.
agent_params_from_flax = dt_params_from_flax


def _adam_of(opt_state: Any):
    """The one optax ``ScaleByAdamState`` inside an optimizer's state."""
    found = []

    def walk(node):
        if hasattr(node, "mu") and hasattr(node, "nu") and hasattr(node, "count"):
            found.append(node)
        elif isinstance(node, (tuple, list)):
            for child in node:
                walk(child)

    walk(opt_state)
    if len(found) != 1:
        raise ValueError(f"expected one ScaleByAdamState in the optax state, found {len(found)}")
    return found[0]


def ppo_opt_state_from_flax(opt_state: Any, names: Sequence[str]) -> ScaleByAdamState:
    """``ScaleByAdamState`` of the PPO optimizer's optax state,
    ``chain(clip_by_global_norm, adam)``: ``(EmptyState, (ScaleByAdamState,
    ScaleByScheduleState or EmptyState))``, or of a plain ``adam``'s
    ``(ScaleByAdamState, EmptyState)``.  The schedule's count equals the
    Adam count, which the port's schedule reads."""
    adam = _adam_of(opt_state)
    return adam_state_from_flax(adam.count, adam.mu, adam.nu, names)


def dqn_payload_from_flax(ts: Any, names: Sequence[str]) -> Dict[str, Any]:
    """The port's ``DQNTrainState`` payload of a JAX train state of numpy
    arrays (``jax.device_get``): ``DQNTrainState``, DDPG's ``ACTrainState``
    or a plain flax ``TrainState`` (no target: SAC's actor), the Adam
    moments in the order of ``names``, the network's
    ``named_parameters()``."""
    opt = ppo_opt_state_from_flax(ts.opt_state, names)
    target = getattr(ts, "target_params", None)
    return {"model": dt_params_from_flax(ts.params),
            "target": None if target is None else dt_params_from_flax(target),
            "opt_state": {"count": opt.count, "mu": opt.mu, "nu": opt.nu}}


def actor_critic_payload_from_flax(state: Any, actor_names: Sequence[str],
                                   critic_names: Sequence[str]) -> Dict[str, Any]:
    """The payload ``ActorCriticState.load_payload`` reads of a JAX
    ``DDPGState`` (``actor``, ``critic``), ``TD3State`` (``actor``, ``qf1``,
    ``qf2``) or ``SACState`` (those and ``log_alpha`` with its Adam state),
    of numpy arrays: each network's params, target and Adam state."""
    critics = [state.critic] if hasattr(state, "critic") else [state.qf1, state.qf2]
    payload = {"actor": dqn_payload_from_flax(state.actor, actor_names),
               "critics": [dqn_payload_from_flax(c, critic_names) for c in critics],
               "log_alpha": None, "alpha_opt_state": None}
    if hasattr(state, "log_alpha"):
        adam = _adam_of(state.alpha_opt_state)
        payload["log_alpha"] = torch.tensor(np.asarray(state.log_alpha, np.float32))
        payload["alpha_opt_state"] = {
            "count": torch.tensor(int(np.asarray(adam.count)), dtype=torch.int32),
            "mu": [torch.tensor(np.asarray(adam.mu, np.float32))],
            "nu": [torch.tensor(np.asarray(adam.nu, np.float32))]}
    return payload

"""One rank of the port's side of ``tests/test_torch_parallel.py`` (not a
test module).

``run`` joins a gloo world of ``WORLD`` ranks through a ``file://`` store,
runs every case of the port on the CPU in one fixed order (every rank
joins every group and every collective in the same order), and writes its
results, numpy arrays and plain values, to ``rank<r>.pkl``.  It imports
neither JAX nor ``mmtrl_tpu``: the inputs arrive as numpy arrays (the flax
parameters as nested dicts of them), made by the test process.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import sys
import traceback

import torch
import torch.distributed as dist

from mmtrl_tpu_torch.algos.dt import DTTrainConfig, create_dt_state, make_dt_train_step
from mmtrl_tpu_torch.algos.dt.train import dt_gradients
from mmtrl_tpu_torch.convert import (
    dt_fsdp_params_from_flax,
    dt_params_from_flax,
    dt_tp_params_from_flax,
    stage_params_from_flax,
)
from mmtrl_tpu_torch.core.distributed import maybe_initialize_distributed
from mmtrl_tpu_torch.models.decision_transformer import Block, DecisionTransformer, DTConfig
from mmtrl_tpu_torch.models.moe import moe_combine_weights
from mmtrl_tpu_torch.ops.fused_optim import init_adam_state
from mmtrl_tpu_torch.parallel import (
    make_mesh,
    pipeline_apply,
    ring_attention,
    shard_batch,
    stack_stage_params,
)
from mmtrl_tpu_torch.parallel.collectives import all_gather, enter, ppermute, psum, reduce_scatter
from mmtrl_tpu_torch.parallel.expert import expert_parallel_moe
from mmtrl_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, replicate, shard_along
from mmtrl_tpu_torch.parallel.seq_composed import make_dt_seq_train_step, seq_cfg, shard_dt_batch
from mmtrl_tpu_torch.parallel.sharding import shard_dt_params, shard_fsdp_params

WORLD = 4
TIMEOUT_S = 60
SEQ_MESHES = ((2, 2), (1, 4), (4, 1))  # (data, seq)
N_STEPS = 2  # the first step's learning rate is 0 (warmup from 0)


def _np(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().numpy().copy()
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np(v) for v in tree]
    return tree


def _batch(inp):
    rtg, states, actions, ts, mask = (torch.from_numpy(x) for x in inp["batch"])
    return rtg, states, actions.long(), ts.long(), mask


def _state(inp, cfg, prepare=None):
    """A train state on the CPU with the JAX parameters loaded;
    ``prepare(model)`` shards it before the moments are made."""
    state = create_dt_state(cfg, DTTrainConfig(**inp["train"]), device="cpu")
    state.model.load_state_dict(dt_params_from_flax(inp["params"]), strict=True)
    if prepare is not None:
        prepare(state.model)
        state.opt_state = init_adam_state(list(state.model.parameters()))
    return state


def _grads(state, batch, mesh, axes=DATA_AXIS):
    """The gradients of the initial parameters on this rank, by name."""
    grads = dt_gradients(state.model, batch, mesh, axes)[3]
    return _np(dict(zip((n for n, _ in state.model.named_parameters()), grads)))


def _steps(step, state, batch):
    metrics = []
    for _ in range(N_STEPS):
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    params = {n: p for n, p in state.model.named_parameters()}
    return {"metrics": metrics, "params": _np(params)}


def case_mesh(inp):
    mesh = make_mesh()
    mesh2 = make_mesh((2, 2), (DATA_AXIS, MODEL_AXIS))
    try:
        make_mesh((3, 2), (DATA_AXIS, MODEL_AXIS))
        raised = None
    except ValueError as exc:
        raised = str(exc)
    x = torch.full((3,), float(dist.get_rank()))
    replicate(mesh2, [x], MODEL_AXIS)
    return {"shape": mesh.shape, "shape2": mesh2.shape, "coords2": mesh2.coords,
            "raised": raised, "replicated": x.numpy(),
            "init_again": maybe_initialize_distributed("cpu")}


def case_collectives(inp):
    """Each collective and its backward on rank-dependent values: rank r
    holds r + 1 and weighs its output by r + 1."""
    mesh = make_mesh((WORLD,), (DATA_AXIS,))
    w = float(mesh.index(DATA_AXIS) + 1)
    out = {}
    for name, fn in (("psum", lambda x: psum(x, mesh, DATA_AXIS)),
                     ("enter", lambda x: enter(x, mesh, DATA_AXIS)),
                     ("ppermute", lambda x: ppermute(x, mesh, DATA_AXIS)),
                     ("all_gather", lambda x: all_gather(x, mesh, DATA_AXIS)),
                     ("reduce_scatter", lambda x: reduce_scatter(
                         x * torch.arange(1.0, 9.0), mesh, DATA_AXIS))):
        x = torch.full((8,) if name == "reduce_scatter" else (2,), w, requires_grad=True)
        y = fn(x)
        (g,) = torch.autograd.grad((y * w).sum(), x)
        out[name] = (_np(y), _np(g))
    return out


def case_dp_step(inp):
    cfg = DTConfig(**inp["cfg"])
    mesh = make_mesh((WORLD,), (DATA_AXIS,))
    state, batch = _state(inp, cfg), shard_batch(mesh, _batch(inp))
    grads = _grads(state, batch, mesh)
    return dict(_steps(make_dt_train_step(cfg, mesh), state, batch), grads=grads)


def case_tp_forward(inp):
    cfg = DTConfig(**inp["cfg"])
    mesh = make_mesh((2, 2), (DATA_AXIS, MODEL_AXIS))
    model = DecisionTransformer(cfg, device="cpu")
    model.load_state_dict(dt_params_from_flax(inp["params"]), strict=True)
    shard_dt_params(mesh, model)
    converted = dt_tp_params_from_flax(inp["params"], 2, mesh.index(MODEL_AXIS))
    same = all(torch.equal(p, converted[n]) for n, p in model.named_parameters())
    model.eval()
    with torch.no_grad():
        logits = model(*_batch(inp)[:4])
    return {"logits": logits.numpy(), "converted_equal": same,
            "shapes": {n: tuple(p.shape) for n, p in model.named_parameters()}}


def case_tp_step(inp):
    cfg = DTConfig(**inp["cfg"])
    mesh = make_mesh((2, 2), (DATA_AXIS, MODEL_AXIS))
    state = _state(inp, cfg, lambda m: shard_dt_params(mesh, m))
    batch = shard_batch(mesh, _batch(inp))
    grads = _grads(state, batch, mesh)
    return dict(_steps(make_dt_train_step(cfg, mesh), state, batch), grads=grads,
                model_index=mesh.index(MODEL_AXIS))


def case_fsdp_step(inp):
    cfg = DTConfig(**inp["cfg"])
    mesh = make_mesh((WORLD,), (DATA_AXIS,))
    # min_size=1: at test sizes every shardable tensor shards, as in JAX's test.
    state = _state(inp, cfg, lambda m: shard_fsdp_params(mesh, m, min_size=1))
    converted = dt_fsdp_params_from_flax(inp["params"], WORLD, mesh.index(DATA_AXIS), min_size=1)
    same = all(torch.equal(p, converted[n]) for n, p in state.model.named_parameters())
    specs = dict(state.model.shard_plan.specs)
    batch = shard_batch(mesh, _batch(inp))
    grads = _grads(state, batch, mesh)
    return dict(_steps(make_dt_train_step(cfg, mesh), state, batch), grads=grads,
                converted_equal=same, specs=specs)


def case_seq_steps(inp):
    cfg = DTConfig(**inp["cfg"])
    out = {}
    for dp, sp in SEQ_MESHES:
        mesh = make_mesh((dp, sp), (DATA_AXIS, "seq"))
        scfg = seq_cfg(cfg, sp)
        state, batch = _state(inp, scfg), shard_dt_batch(_batch(inp), mesh)
        state.model.use_mesh(mesh)  # the step does so too
        grads = _grads(state, batch, mesh, (DATA_AXIS, "seq"))
        res = dict(_steps(make_dt_seq_train_step(scfg, mesh), state, batch), grads=grads)
        # the trained sequence-parallel parameters load into the dense model
        dense = DecisionTransformer(cfg, device="cpu")
        dense.load_state_dict(state.model.state_dict(), strict=True)
        res["dense_roundtrip"] = all(torch.equal(a, b) for a, b in zip(
            dense.parameters(), state.model.parameters()))
        out[f"{dp}x{sp}"] = res
    mesh = make_mesh((1, WORLD), (DATA_AXIS, "seq"))
    try:
        make_dt_seq_train_step(dataclasses.replace(cfg, seq_axis="seq", seq_axis_size=2), mesh)
        out["mismatch"] = None
    except ValueError as exc:
        out["mismatch"] = str(exc)
    return out


def case_ring(inp):
    mesh = make_mesh((WORLD,), ("seq",))
    q, k, v = (shard_along(torch.from_numpy(x), mesh, "seq", 2) for x in inp["qkv"])
    out = {}
    for causal in (False, True):
        with torch.no_grad():
            out[f"causal={causal}"] = ring_attention(q, k, v, mesh, causal=causal).numpy()
    qg, kg, vg = (shard_along(torch.from_numpy(x), mesh, "seq", 2).requires_grad_()
                  for x in inp["qkv_grad"])
    w = torch.from_numpy(inp["w"])
    loss = (ring_attention(qg, kg, vg, mesh, causal=True) * w).sum()
    out["grads"] = _np(list(torch.autograd.grad(loss, (qg, kg, vg))))
    return out


def case_expert(inp):
    mesh = make_mesh((WORLD,), ("expert",))
    x, logits, w1, b1, w2, b2 = (torch.from_numpy(a) for a in inp["moe"])
    combine = moe_combine_weights(logits, 2)
    ws = [shard_along(w, mesh, "expert", 0).requires_grad_() for w in (w1, b1, w2, b2)]
    x = x.requires_grad_()
    loss = (expert_parallel_moe(x, combine, *ws, mesh) ** 2).mean()
    grads = torch.autograd.grad(loss, ws + [x])
    return {"value": float(loss.detach()), "grads": _np(list(grads[:4])), "x_grad": _np(grads[4])}


def _mlp_stage(params, x):
    h = torch.tanh(x @ params["w1"] + params["b1"])
    return h @ params["w2"] + params["b2"]


def case_pipeline(inp):
    mesh = make_mesh((WORLD,), ("pipe",))
    me = mesh.index("pipe")
    out = {}
    mine = {k: torch.from_numpy(v[me]) for k, v in inp["pipe_stages"].items()}
    with torch.no_grad():
        out["forward"] = pipeline_apply(_mlp_stage, mine, torch.from_numpy(inp["pipe_x"]),
                                        mesh).numpy()
    mine = {k: torch.from_numpy(v[me]).requires_grad_() for k, v in inp["pipe_grad_stages"].items()}
    y = pipeline_apply(_mlp_stage, mine, torch.from_numpy(inp["pipe_grad_x"]), mesh)
    grads = torch.autograd.grad((y ** 2).sum(), list(mine.values()))
    out["grads"] = dict(zip(mine, _np(list(grads))))

    blk = Block(DTConfig(**inp["block_cfg"]), device="cpu")
    layers = stack_stage_params(stage_params_from_flax(inp["block_stages"], me))
    n_layers = next(iter(layers.values())).shape[0]

    def stage_fn(params, x):
        for i in range(n_layers):
            layer = {k: v[i] for k, v in params.items()}
            x, _ = torch.func.functional_call(blk, layer, (x,))
        return x

    with torch.no_grad():
        out["dt_blocks"] = pipeline_apply(stage_fn, layers, torch.from_numpy(inp["block_x"]),
                                          mesh).numpy()
    return out


CASES = {
    "mesh": case_mesh,
    "collectives": case_collectives,
    "dp_step": case_dp_step,
    "tp_forward": case_tp_forward,
    "tp_step": case_tp_step,
    "fsdp_step": case_fsdp_step,
    "seq": case_seq_steps,
    "ring": case_ring,
    "expert": case_expert,
    "pipeline": case_pipeline,
}


def run(rank: int, store: str, inputs: dict, out_dir: str) -> None:
    """Spawn target: one rank of the world; writes ``rank<r>.pkl``."""
    torch.set_num_threads(1)
    results = {"rank": rank}
    try:
        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                                world_size=WORLD,
                                timeout=datetime.timedelta(seconds=TIMEOUT_S))
        for name, case in CASES.items():
            results[name] = case(inputs)
        dist.destroy_process_group()
    except Exception:
        results["error"] = traceback.format_exc()
    results["forbidden_modules"] = sorted(
        m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "optax", "mmtrl_tpu"))
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)
    if "error" in results:
        os._exit(1)  # the other ranks' collectives time out

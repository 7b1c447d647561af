"""The port's multi-device axes (``mmtrl_tpu_torch/parallel``,
``core/distributed.py``) against the JAX package's on the CPU.

The module fixture makes every input from a numpy seed and JAX's DT
parameters, starts ONE 4-rank gloo world of spawned processes that runs
every case of the port (``tests/torch_parallel_worker.py``, which imports
neither JAX nor ``mmtrl_tpu``), and meanwhile computes JAX's results here,
on the virtual CPU devices of ``tests/conftest.py``.  Each test then holds
one case to the tolerance of JAX's own test of it:
``tests/test_parallel.py`` (TP forward, FSDP step), ``test_seq_composed.py``
(the data x seq step, which also sets the DP and TP steps' tolerances),
``test_pipeline_ring.py`` (ring, pipeline) and ``test_moe.py`` (experts).

The train steps run two steps: the warmup schedule's first learning rate
is 0, so only the second moves the parameters.
"""

import contextlib
import io
import multiprocessing
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

import torch_parallel_worker as worker
from mmtrl_tpu.algos.dt import DTTrainConfig as JaxDTTrainConfig
from mmtrl_tpu.algos.dt import create_dt_state as jax_create_dt_state
from mmtrl_tpu.algos.dt import make_dt_train_step as jax_make_dt_train_step
from mmtrl_tpu.core.distributed import maybe_initialize_distributed as jax_init
from mmtrl_tpu.models.decision_transformer import Block as JaxBlock
from mmtrl_tpu.models.decision_transformer import DecisionTransformer as JaxDT
from mmtrl_tpu.models.decision_transformer import DTConfig as JaxDTConfig
from mmtrl_tpu.models.moe import MoEFFN as JaxMoEFFN
from mmtrl_tpu.models.moe import moe_combine_weights as jax_combine
from mmtrl_tpu.parallel.expert import expert_parallel_moe as jax_expert_moe
from mmtrl_tpu.parallel.expert import moe_param_specs as jax_moe_specs
from mmtrl_tpu.parallel.mesh import make_mesh as jax_make_mesh
from mmtrl_tpu.parallel.pipeline import pipeline_apply as jax_pipeline
from mmtrl_tpu.parallel.pipeline import stack_stage_params as jax_stack
from mmtrl_tpu.parallel.ring_attention import ring_attention as jax_ring
from mmtrl_tpu.parallel.sharding import dt_param_sharding as jax_dt_sharding
from mmtrl_tpu.parallel.sharding import fsdp_param_sharding as jax_fsdp_sharding
from mmtrl_tpu_torch.convert import (
    dt_fsdp_params_from_flax,
    dt_params_from_flax,
    dt_tp_params_from_flax,
)
from mmtrl_tpu_torch.core.distributed import maybe_initialize_distributed
from mmtrl_tpu_torch.models.decision_transformer import DecisionTransformer, DTConfig
from mmtrl_tpu_torch.models.moe import MoEFFN
from mmtrl_tpu_torch.parallel.expert import moe_param_specs
from mmtrl_tpu_torch.parallel.mesh import Mesh
from mmtrl_tpu_torch.parallel.sharding import dt_param_sharding, fsdp_param_sharding

REPO = Path(__file__).resolve().parent.parent
WORLD = worker.WORLD
B, K = 8, 8
CFG = dict(num_actions=4, context_len=K, d_model=32, n_layers=2, n_heads=2, dropout=0.0,
           max_timestep=64, state_kind="vector", state_dim=8, compute_dtype="float32")
TRAIN = dict(batch_size=B, total_steps=10, warmup_steps=2)
BLOCK_CFG = dict(num_actions=4, context_len=8, d_model=16, n_layers=8, n_heads=2, dropout=0.0,
                 max_timestep=16, compute_dtype="float32")
PP, LAYERS_PER_STAGE = 4, 2
JOIN_S = 150


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs():
    rng = np.random.RandomState(0)
    mask = np.ones((B, K), bool)
    mask[0, -2:] = False  # a ragged tail: the masked mean's denominator is not B K
    batch = (rng.uniform(-5, 5, (B, K)).astype(np.float32),
             rng.normal(size=(B, K, 8)).astype(np.float32),
             rng.randint(0, 4, (B, K)).astype(np.int32),
             np.tile(np.arange(K, dtype=np.int32), (B, 1)), mask)
    cfg, tcfg = JaxDTConfig(**CFG), JaxDTTrainConfig(**TRAIN)
    # jitted: the eager flax init takes seconds
    state = jax.jit(lambda key, b: jax_create_dt_state(key, cfg, tcfg, b))(
        jax.random.PRNGKey(0), tuple(map(jnp.asarray, batch)))
    blk = JaxBlock(JaxDTConfig(**BLOCK_CFG))
    block_x = rng.normal(size=(4, 2, 24, 16)).astype(np.float32)
    init = jax.jit(lambda k: blk.init(k, jnp.asarray(block_x[0]), True)["params"])
    layers = [init(k) for k in jax.random.split(jax.random.PRNGKey(8), BLOCK_CFG["n_layers"])]
    stages = [jax_stack(layers[i * LAYERS_PER_STAGE:(i + 1) * LAYERS_PER_STAGE]) for i in range(PP)]

    def mlp_stages(d, hidden, seed):
        r = np.random.RandomState(seed)
        return {"w1": (r.normal(size=(PP, d, hidden)) * 0.3).astype(np.float32),
                "b1": (r.normal(size=(PP, hidden)) * 0.1).astype(np.float32),
                "w2": (r.normal(size=(PP, hidden, d)) * 0.3).astype(np.float32),
                "b2": (r.normal(size=(PP, d)) * 0.1).astype(np.float32)}

    E, D, F = 4, 8, 16
    return {
        "cfg": CFG, "train": TRAIN, "batch": batch,
        "params": jax.tree_util.tree_map(np.asarray, state.params),
        "qkv": [rng.normal(size=(2, 2, 32, 8)).astype(np.float32) for _ in range(3)],
        "qkv_grad": [rng.normal(size=(1, 2, 16, 8)).astype(np.float32) for _ in range(3)],
        "w": rng.normal(size=(8,)).astype(np.float32),
        "moe": [rng.normal(size=(2, 6, D)).astype(np.float32),
                rng.normal(size=(2, 6, E)).astype(np.float32),
                (rng.normal(size=(E, D, F)) * 0.3).astype(np.float32),
                (rng.normal(size=(E, F)) * 0.1).astype(np.float32),
                (rng.normal(size=(E, F, D)) * 0.3).astype(np.float32),
                (rng.normal(size=(E, D)) * 0.1).astype(np.float32)],
        "pipe_stages": mlp_stages(6, 12, 3),
        "pipe_x": rng.normal(size=(6, 3, 6)).astype(np.float32),
        "pipe_grad_stages": mlp_stages(4, 8, 5),
        "pipe_grad_x": rng.normal(size=(4, 2, 4)).astype(np.float32),
        "block_cfg": BLOCK_CFG, "block_x": block_x,
        "block_stages": jax.tree_util.tree_map(np.asarray, jax_stack(stages)),
    }, state


def _mlp_stage(params, x):
    h = jnp.tanh(x @ params["w1"] + params["b1"])
    return h @ params["w2"] + params["b2"]


def _jax_results(inp, state):
    """JAX's side of every case."""
    out = {}
    cfg = JaxDTConfig(**CFG)
    batch = tuple(map(jnp.asarray, inp["batch"]))
    out["logits"] = np.asarray(JaxDT(cfg).apply(state.params, *batch[:4]))
    step = jax.jit(jax_make_dt_train_step(cfg))
    metrics = []
    for i in range(worker.N_STEPS):
        state, m = step(state, batch, jax.random.PRNGKey(1 + i))
        metrics.append({k: float(v) for k, v in m.items()})
    out["metrics"] = metrics
    out["params"] = jax.tree_util.tree_map(np.asarray, state.params)

    def loss_fn(params):
        logits = JaxDT(cfg).apply(params, *batch[:4])
        nll = -jnp.take_along_axis(jax.nn.log_softmax(logits), batch[2][..., None], -1)[..., 0]
        m = batch[4].astype(jnp.float32)
        return (nll * m).sum() / jnp.maximum(m.sum(), 1.0)

    out["grads"] = jax.tree_util.tree_map(np.asarray, jax.jit(jax.grad(loss_fn))(
        jax.tree_util.tree_map(jnp.asarray, inp["params"])))

    def mesh_of(name):
        return jax_make_mesh((WORLD,), (name,), devices=jax.devices()[:WORLD])

    q, k, v = map(jnp.asarray, inp["qkv"])
    ring = jax.jit(lambda q, k, v, c: jax_ring(q, k, v, mesh_of("seq"), causal=c),
                   static_argnums=3)
    for causal in (False, True):
        out[f"ring causal={causal}"] = np.asarray(ring(q, k, v, causal))
    w = jnp.asarray(inp["w"])
    grads = jax.jit(jax.grad(lambda q, k, v: (jax_ring(q, k, v, mesh_of("seq"), causal=True)
                                              * w).sum(), argnums=(0, 1, 2)))
    out["ring grads"] = [np.asarray(g) for g in grads(*map(jnp.asarray, inp["qkv_grad"]))]

    x, logits, *ws = map(jnp.asarray, inp["moe"])
    combine = jax_combine(logits, 2)

    def ep_loss(ws, x):
        return (jax_expert_moe(x, combine, *ws, mesh_of("expert")) ** 2).mean()

    value, (g_w, g_x) = jax.jit(jax.value_and_grad(ep_loss, argnums=(0, 1)))(tuple(ws), x)
    out["expert"] = (float(value), [np.asarray(g) for g in g_w], np.asarray(g_x))

    stacked = jax.tree_util.tree_map(jnp.asarray, inp["pipe_stages"])
    out["pipe forward"] = np.asarray(jax.jit(
        lambda p, x: jax_pipeline(_mlp_stage, p, x, mesh_of("pipe")))(stacked, inp["pipe_x"]))
    stacked = jax.tree_util.tree_map(jnp.asarray, inp["pipe_grad_stages"])
    px = jnp.asarray(inp["pipe_grad_x"])
    out["pipe grads"] = jax.tree_util.tree_map(np.asarray, jax.jit(jax.grad(
        lambda p: (jax_pipeline(_mlp_stage, p, px, mesh_of("pipe")) ** 2).sum()))(stacked))
    blk = JaxBlock(JaxDTConfig(**BLOCK_CFG))

    def stage_fn(params, x):
        x, _ = jax.lax.scan(lambda x, p: (blk.apply({"params": p}, x, True), None), x, params)
        return x

    out["pipe dt"] = np.asarray(jax.jit(lambda p, x: jax_pipeline(stage_fn, p, x, mesh_of("pipe")))(
        inp["block_stages"], inp["block_x"]))
    return out


def _init_subprocess():
    """The coordinator path of ``maybe_initialize_distributed`` in a fresh
    one-rank process (a TCP store on a port the OS picks)."""
    code = (
        "import socket, torch.distributed as dist\n"
        "s = socket.socket(); s.bind(('localhost', 0)); port = s.getsockname()[1]; s.close()\n"
        "import os; os.environ['MMTRL_COORDINATOR'] = f'localhost:{port}'\n"
        "from mmtrl_tpu_torch.core.distributed import maybe_initialize_distributed as init\n"
        "ok = init('cpu')\n"
        "print(ok, dist.get_backend(), dist.get_world_size())\n"
        "dist.destroy_process_group()\n"
    )
    env = dict(os.environ, MMTRL_NUM_PROCESSES="1", MMTRL_PROCESS_ID="0")
    return subprocess.Popen([sys.executable, "-c", code], env=env, cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel")
    inp, state = _inputs()
    init_proc = _init_subprocess()
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=worker.run, args=(r, str(tmp / "store"), inp, str(tmp)))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        ref = _jax_results(inp, state)
    finally:
        for p in procs:
            p.join(JOIN_S)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    init_out, init_err = init_proc.communicate(timeout=JOIN_S)
    results = []
    for r in range(WORLD):
        path = tmp / f"rank{r}.pkl"
        assert path.exists(), f"rank {r} wrote nothing (exit code {procs[r].exitcode})"
        with open(path, "rb") as f:
            results.append(pickle.load(f))
    errors = [res["error"] for res in results if "error" in res]
    assert not errors, errors[0]
    return {"ranks": results, "ref": ref, "inputs": inp, "init": (init_out, init_err)}


def _ref_state_dict(world):
    return dt_params_from_flax(world["ref"]["params"])


def _assert_metrics(out, ref, loss_tol, acc_tol=1e-6):
    for m, r in zip(out, ref):
        assert abs(m["dt/loss"] - r["dt/loss"]) < loss_tol
        assert abs(m["dt/action_accuracy"] - r["dt/action_accuracy"]) < acc_tol


# The gradients of the whole batch's loss at the initial parameters, summed
# over the ranks' blocks, against jax.grad's: test_moe.py's tolerances for
# gradients.  (Adam and the clip hide a gradient scaled uniformly, as by a
# psum whose backward sums, so the steps' parameters alone would not.)
GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-6


def _assert_grads(grads, ref):
    assert set(grads) == set(ref)
    for name, r in ref.items():
        np.testing.assert_allclose(grads[name], r.numpy(), rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)


def _max_err(params, ref):
    assert set(params) == set(ref)
    return max(float(np.abs(params[n] - ref[n].numpy()).max()) for n in ref)


# ---- the world -------------------------------------------------------------


def test_the_world_imports_neither_jax_nor_the_jax_package(world):
    assert [res["forbidden_modules"] for res in world["ranks"]] == [[]] * WORLD


def test_make_mesh_sizes_and_its_error(world):
    for rank, res in enumerate(world["ranks"]):
        mesh = res["mesh"]
        assert mesh["shape"] == {"data": WORLD}
        assert mesh["shape2"] == {"data": 2, "model": 2}
        assert mesh["coords2"] == (rank // 2, rank % 2)  # row-major, as JAX reshapes devices
        assert "does not cover 4 devices" in mesh["raised"]
        assert mesh["init_again"] is True
        # broadcast over the model axis from its first rank
        np.testing.assert_array_equal(mesh["replicated"], np.full(3, float(rank - rank % 2)))


def test_collectives_and_their_backward(world):
    """Rank r holds r + 1 and weighs its output by r + 1 (ranks 0-3)."""
    w = np.arange(1.0, WORLD + 1)
    for r, res in enumerate(world["ranks"]):
        out = res["collectives"]
        # psum: the sum forward, the rank's own weight back
        np.testing.assert_array_equal(out["psum"][0], [w.sum()] * 2)
        np.testing.assert_array_equal(out["psum"][1], [w[r]] * 2)
        # enter: identity forward, the weights summed back
        np.testing.assert_array_equal(out["enter"][0], [w[r]] * 2)
        np.testing.assert_array_equal(out["enter"][1], [w.sum()] * 2)
        # ppermute: from rank r - 1; the gradient from rank r + 1's weight
        np.testing.assert_array_equal(out["ppermute"][0], [w[r - 1]] * 2)
        np.testing.assert_array_equal(out["ppermute"][1], [w[(r + 1) % WORLD]] * 2)
        # all_gather: every rank's pair; back, the weights summed
        np.testing.assert_array_equal(out["all_gather"][0], np.repeat(w, 2))
        np.testing.assert_array_equal(out["all_gather"][1], [w.sum()] * 2)
        # reduce_scatter of (r + 1) * [1..8]: rank r keeps its pair of the
        # sum; back, every rank's weight on its pair, times [1..8]
        np.testing.assert_array_equal(out["reduce_scatter"][0],
                                      w.sum() * np.arange(1.0, 9.0)[2 * r:2 * r + 2])
        np.testing.assert_array_equal(out["reduce_scatter"][1],
                                      np.repeat(w, 2) * np.arange(1.0, 9.0))


def test_make_mesh_without_a_process_group_is_one_rank():
    assert jax_make_mesh((1,), ("data",), devices=jax.devices()[:1]).devices.size == 1
    from mmtrl_tpu_torch.parallel import make_mesh

    assert make_mesh().shape == {"data": 1}
    assert make_mesh(axis_names=("data", "model")).shape == {"data": 1, "model": 1}
    with pytest.raises(ValueError, match="does not cover 1 devices"):
        make_mesh((2,))


def test_data_parallel_step_matches_the_one_device_step(world):
    ref = _ref_state_dict(world)
    moved = dt_params_from_flax(world["inputs"]["params"])
    assert max(float((ref[n] - moved[n]).abs().max()) for n in ref) > 1e-4  # the second step
    for res in world["ranks"]:
        out = res["dp_step"]
        _assert_grads(out["grads"], dt_params_from_flax(world["ref"]["grads"]))
        _assert_metrics(out["metrics"], world["ref"]["metrics"], 1e-5)
        assert _max_err(out["params"], ref) < 2e-5
    # the replicas stay equal
    first = world["ranks"][0]["dp_step"]["params"]
    for res in world["ranks"][1:]:
        assert all(np.array_equal(first[n], res["dp_step"]["params"][n]) for n in first)


def test_tensor_parallel_forward_matches_replicated(world):
    for res in world["ranks"]:
        out = res["tp_forward"]
        assert out["converted_equal"]
        assert out["shapes"]["block_0.attn.qkv.weight"] == (3 * 16, 32)
        assert out["shapes"]["block_1.proj.weight"] == (32, 64)
        np.testing.assert_allclose(out["logits"], world["ref"]["logits"], atol=2e-5, rtol=2e-5)


def test_tensor_parallel_step_matches_the_one_device_step(world):
    ref = dt_params_from_flax(world["ref"]["params"])
    for res in world["ranks"]:
        out = res["tp_step"]
        _assert_grads(out["grads"], dt_tp_params_from_flax(world["ref"]["grads"], 2,
                                                          out["model_index"]))
        _assert_metrics(out["metrics"], world["ref"]["metrics"], 1e-5)
        mine = dt_tp_params_from_flax(world["ref"]["params"], 2, out["model_index"])
        assert _max_err(out["params"], mine) < 2e-5
        assert set(mine) == set(ref)


def test_fsdp_step_matches_the_one_device_step(world):
    for rank, res in enumerate(world["ranks"]):
        out = res["fsdp_step"]
        assert out["converted_equal"]
        assert any("data" in spec for spec in out["specs"].values())
        _assert_grads(out["grads"], dt_fsdp_params_from_flax(world["ref"]["grads"], WORLD, rank,
                                                            min_size=1))
        _assert_metrics(out["metrics"], world["ref"]["metrics"], 2e-5)
        mine = dt_fsdp_params_from_flax(world["ref"]["params"], WORLD, rank, min_size=1)
        assert _max_err(out["params"], mine) < 5e-5


@pytest.mark.parametrize("mesh", [f"{dp}x{sp}" for dp, sp in worker.SEQ_MESHES])
def test_seq_step_matches_the_one_device_step(world, mesh):
    ref = _ref_state_dict(world)
    for res in world["ranks"]:
        out = res["seq"][mesh]
        _assert_grads(out["grads"], dt_params_from_flax(world["ref"]["grads"]))
        _assert_metrics(out["metrics"], world["ref"]["metrics"], 1e-5)
        assert _max_err(out["params"], ref) < 2e-5
        assert out["dense_roundtrip"]


def test_seq_step_rejects_a_mismatched_axis_size(world):
    for res in world["ranks"]:
        assert "seq_axis_size=2 != mesh seq=4" in res["seq"]["mismatch"]


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_matches_jax(world, causal):
    chunks = [res["ring"][f"causal={causal}"] for res in world["ranks"]]
    np.testing.assert_allclose(np.concatenate(chunks, axis=2),
                               world["ref"][f"ring causal={causal}"], atol=2e-5)


def test_ring_attention_grads_match_jax(world):
    for i, ref in enumerate(world["ref"]["ring grads"]):
        got = np.concatenate([res["ring"]["grads"][i] for res in world["ranks"]], axis=2)
        np.testing.assert_allclose(got, ref, atol=3e-5)


def test_expert_parallel_matches_jax_values_and_grads(world):
    value, g_w, g_x = world["ref"]["expert"]
    for rank, res in enumerate(world["ranks"]):
        out = res["expert"]
        np.testing.assert_allclose(out["value"], value, rtol=1e-6)
        for got, ref in zip(out["grads"], g_w):
            np.testing.assert_allclose(got, np.split(ref, WORLD)[rank], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(out["x_grad"], g_x, rtol=1e-5, atol=1e-6)


def test_pipeline_matches_jax(world):
    for res in world["ranks"]:
        np.testing.assert_allclose(res["pipeline"]["forward"], world["ref"]["pipe forward"],
                                   atol=1e-5)


def test_pipeline_grads_match_jax(world):
    for rank, res in enumerate(world["ranks"]):
        for name, got in res["pipeline"]["grads"].items():
            np.testing.assert_allclose(got, world["ref"]["pipe grads"][name][rank],
                                       atol=2e-4, rtol=2e-5)


def test_pipeline_over_dt_blocks_matches_jax(world):
    for res in world["ranks"]:
        np.testing.assert_allclose(res["pipeline"]["dt_blocks"], world["ref"]["pipe dt"],
                                   atol=2e-4, rtol=2e-5)


# ---- the sharding rules, rank by rank ----------------------------------------


def _torch_name(path):
    keys = [p.key for p in path]
    leaf = {"kernel": "weight", "embedding": "weight", "scale": "weight"}.get(keys[-1], keys[-1])
    return ".".join([k for k in keys[:-1] if k != "params"] + [leaf])


def _to_port_layout(leaf_name, spec, ndim):
    spec = tuple(spec) + (None,) * (ndim - len(spec))
    if leaf_name == "kernel":
        perm = {2: (1, 0), 4: (3, 2, 0, 1)}[ndim]
        spec = tuple(spec[d] for d in perm)
    return spec


def _full(spec, ndim):
    return tuple(spec) + (None,) * (ndim - len(spec))


def _specs_against_jax(jax_specs, params, port_specs):
    """Each leaf's JAX specification (``NamedSharding`` or
    ``PartitionSpec``), moved to the port's layout, is the port's."""
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    specs = jax.tree_util.tree_leaves(
        jax_specs, is_leaf=lambda s: isinstance(s, (NamedSharding, PartitionSpec)))
    assert len(flat) == len(specs) == len(port_specs)
    for (path, leaf), spec in zip(flat, specs):
        name = _torch_name(path)
        want = _to_port_layout(path[-1].key, getattr(spec, "spec", spec), leaf.ndim)
        assert _full(port_specs[name], leaf.ndim) == want, name


MULTIMODAL = dict(num_actions=4, context_len=4, d_model=64, n_layers=2, n_heads=2, dropout=0.0,
                  max_timestep=16, compute_dtype="float32")


def _multimodal_params():
    model = JaxDT(JaxDTConfig(**MULTIMODAL))
    z = jnp.zeros((1, 4), jnp.int32)
    return jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, 4)),
                          jnp.zeros((1, 4, 2, 84, 84)), z, z)


@pytest.mark.parametrize("min_size", [1, 2**14])
def test_fsdp_rule_picks_jax_leaves_and_dimensions(min_size):
    """On the multimodal DT (conv, dense, embedding and LayerNorm leaves):
    the same leaves shard, along the same logical dimension."""
    params = _multimodal_params()
    jmesh = jax_make_mesh((WORLD,), ("data",), devices=jax.devices()[:WORLD])
    mesh = Mesh(("data",), (WORLD,), (0,), {("data",): None})
    model = DecisionTransformer(DTConfig(**MULTIMODAL), device="cpu")
    _specs_against_jax(jax_fsdp_sharding(jmesh, params, min_size=min_size), params,
                       fsdp_param_sharding(mesh, model, min_size=min_size))


def test_tensor_parallel_rule_matches_jax():
    params = _multimodal_params()
    jmesh = jax_make_mesh((2, 2), ("data", "model"), devices=jax.devices()[:4])
    mesh = Mesh(("data", "model"), (2, 2), (0, 0),
                {("data",): None, ("model",): None, ("data", "model"): None})
    model = DecisionTransformer(DTConfig(**MULTIMODAL), device="cpu")
    _specs_against_jax(jax_dt_sharding(jmesh, params), params, dt_param_sharding(mesh, model))


def test_moe_param_specs_shard_the_expert_axis():
    jparams = jax.eval_shape(JaxMoEFFN(d_model=8, d_ff=16, num_experts=4, top_k=2).init,
                             jax.random.PRNGKey(0), jnp.zeros((1, 2, 8)))["params"]
    got = moe_param_specs(MoEFFN(8, 16, 4, 2, torch.float32, "dense", device="cpu"))
    _specs_against_jax(jax_moe_specs(jparams), jparams, got)
    assert got["experts_w1"][0] == got["experts_b2"][0] == "expert"


# ---- maybe_initialize_distributed ------------------------------------------


def test_initialize_is_a_no_op_without_a_coordinator(monkeypatch):
    for var in ("MMTRL_COORDINATOR", "WORLD_SIZE", "TPU_WORKER_HOSTNAMES"):
        monkeypatch.delenv(var, raising=False)
    assert maybe_initialize_distributed("cpu") is False
    assert jax_init() is False
    assert not torch.distributed.is_initialized()


def test_initialize_prints_a_failed_start_as_jax_does(monkeypatch):
    """ROADMAP C.25: a start that fails is printed and skipped."""
    monkeypatch.setenv("MMTRL_COORDINATOR", "localhost:1")
    monkeypatch.setenv("MMTRL_NUM_PROCESSES", "two")
    monkeypatch.setenv("MMTRL_PROCESS_ID", "0")
    printed = []
    for init in (lambda: maybe_initialize_distributed("cpu"), jax_init):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert init() is False
        printed.append(buf.getvalue())
    assert printed[0] == printed[1] == \
        "multi-host init skipped: invalid literal for int() with base 10: 'two'\n"
    assert not torch.distributed.is_initialized()


def test_initialize_starts_a_gloo_group_from_the_coordinator(world):
    out, err = world["init"]
    assert out.split() == ["True", "gloo", "1"], err

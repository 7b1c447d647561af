"""Parity of the port's models (mmtrl_tpu_torch/models) with the JAX models on
converted weights, on the CPU, with dropout 0."""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmtrl_tpu.models.common import AtariTower as JaxAtariTower
from mmtrl_tpu.models.decision_transformer import DecisionTransformer as JaxDT
from mmtrl_tpu.models.decision_transformer import DTConfig as JaxDTConfig
from mmtrl_tpu_torch.convert import dt_params_from_flax
from mmtrl_tpu_torch.models.common import AtariTower, Dense
from mmtrl_tpu_torch.models.decision_transformer import (
    DecisionTransformer,
    DTConfig,
    LayerNorm,
)

TINY = JaxDTConfig(
    num_actions=4, context_len=6, d_model=32, n_layers=2, n_heads=2,
    dropout=0.0, max_timestep=64, compute_dtype="float32",
)
FLAGSHIP_F32 = JaxDTConfig(dropout=0.0, max_timestep=64, compute_dtype="float32")
# The action head's 0.01-scaled init keeps logits near 1e-2, so float32
# logits are held to 1e-6 (summation order only).
LOGIT_ATOL_F32 = 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several worker processes at once; torch's own
    intra-op thread pool on top of that oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(seed, cfg, B, channels=2):
    rng = np.random.RandomState(seed)
    K = cfg.context_len
    if cfg.state_kind == "multimodal":
        states = rng.uniform(-1, 1, (B, K, channels, 84, 84))
    else:
        states = rng.randn(B, K, cfg.state_dim)
    return (
        rng.uniform(-5, 10, (B, K)).astype(np.float32),
        states.astype(np.float32),
        rng.randint(0, cfg.num_actions, (B, K)).astype(np.int32),
        rng.randint(0, cfg.max_timestep, (B, K)).astype(np.int32),
    )


def _numpy_params(jmodel, batch, seed):
    """A flax param tree of the model's shapes filled from a numpy seed:
    kernels ~ N(0, 1/fan_in), biases and LayerNorm scales perturbed from
    0 and 1, embeddings ~ N(0, 0.02)."""
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), *map(jnp.asarray, batch))

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            x = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        elif name == "embedding":
            x = rng.randn(*shape) * 0.02
        else:
            x = (name == "scale") + rng.randn(*shape) * 0.1
        return jnp.asarray(x, jnp.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _both(cfg, seed, B, numpy_params=False, channels=2):
    batch = _batch(seed, cfg, B, channels)
    jmodel = JaxDT(cfg)
    if numpy_params:
        params = _numpy_params(jmodel, batch, seed)
    else:
        params = jmodel.init(jax.random.PRNGKey(seed), *map(jnp.asarray, batch))
    model = DecisionTransformer(
        DTConfig(**dataclasses.asdict(cfg)), device="cpu", state_channels=channels
    )
    model.load_state_dict(dt_params_from_flax(_numpy(params)), strict=True)
    model.eval()
    logits_jax = np.asarray(jmodel.apply(params, *map(jnp.asarray, batch)))
    tb = [torch.from_numpy(x) for x in batch]
    tb[2], tb[3] = tb[2].long(), tb[3].long()
    return model, tb, logits_jax


@pytest.mark.parametrize(
    "size,channels", [("big", 1), ("small", 1), ("big", 2), ("small", 2)]
)
def test_atari_tower_matches_jax(size, channels):
    # channels == 1 reaches the JAX space-to-depth Conv_0, channels == 2 nn.Conv.
    x = np.random.RandomState(7).uniform(-1, 1, (3, 84, 84, channels)).astype(np.float32)
    jt = JaxAtariTower(size)
    params = jt.init(jax.random.PRNGKey(1), jnp.asarray(x))
    ref = np.asarray(jt.apply(params, jnp.asarray(x)))
    tower = AtariTower(size, channels, device="cpu")
    tower.load_state_dict(dt_params_from_flax(_numpy(params)), strict=True)
    out = tower(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert out.shape == ref.shape == (3, 512 if size == "big" else 256)
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize(
    "cfg",
    [
        TINY,
        dataclasses.replace(TINY, fusion_type="concat"),
        dataclasses.replace(TINY, conv_type="small"),
        dataclasses.replace(TINY, state_kind="vector", state_dim=8),
    ],
    ids=["tiny", "concat", "small_conv", "vector"],
)
def test_dt_logits_match_jax_f32(cfg):
    model, batch, ref = _both(cfg, 0, 4)
    with torch.no_grad():
        out = model(*batch)
    assert out.dtype == torch.float32 and out.shape == ref.shape == (4, 6, 4)
    np.testing.assert_allclose(out.numpy(), ref, atol=LOGIT_ATOL_F32, rtol=0)


def test_dt_flagship_width_forward_matches_jax_f32():
    # numpy-seeded weights (logits of order 1) spare the CPU flax's
    # orthogonal init of ~20M parameters
    model, batch, ref = _both(FLAGSHIP_F32, 1, 1, numpy_params=True)
    with torch.no_grad():
        out = model(*batch)
    assert out.shape == ref.shape == (1, 30, 4)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("ln_dtype", ["float32", "bfloat16"])
def test_dt_logits_match_jax_bf16(ln_dtype):
    cfg = dataclasses.replace(TINY, compute_dtype="bfloat16", ln_dtype=ln_dtype)
    model, batch, ref = _both(cfg, 2, 4)
    with torch.no_grad():
        out = model(*batch)
    # Both sides round every product and bias add to bf16 (8 significant
    # bits) at the same places, but sum in other orders, and below S = 1024
    # the JAX attention rounds the normalised probabilities where the port's
    # kernel rounds the unnormalised ones; the logits themselves are bf16, one
    # rounding being 2^-8 of the largest.  Held to 2% of the largest logit.
    assert np.abs(out.numpy() - ref).max() <= 0.02 * np.abs(ref).max()


def test_dense_rounds_product_and_bias_add_as_flax_bf16():
    # flax rounds the product to bf16 and then the bias add; a fused addmm
    # would round once.  Same float32 products, so bit for bit.
    rng = np.random.RandomState(0)
    w, b = rng.randn(48, 40).astype(np.float32) / 7, rng.randn(40).astype(np.float32)
    x = rng.randn(64, 48).astype(np.float32)
    ref = fnn.Dense(40, dtype=jnp.bfloat16).apply(
        {"params": {"kernel": jnp.asarray(w), "bias": jnp.asarray(b)}},
        jnp.asarray(x, jnp.bfloat16),
    )
    dense = Dense(48, 40, device="cpu")
    dense.load_state_dict(dt_params_from_flax({"kernel": w, "bias": b}), strict=True)
    out = dense(torch.from_numpy(x).bfloat16())
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(out.detach().float().numpy(), np.asarray(ref, np.float32))


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_layernorm_matches_flax(out_dtype):
    # flax: float32 statistics, variance max(0, E[x^2] - E[x]^2), eps 1e-6.
    # float32: summation order only (1e-6 on outputs of order 1); bf16 output:
    # that plus one rounding, 2^-7 relative.
    rng = np.random.RandomState(1)
    x = rng.randn(64, 48).astype(np.float32) * 2 + 0.5
    scale, bias = 1 + rng.randn(48) * 0.1, rng.randn(48) * 0.1
    params = {"scale": jnp.asarray(scale, jnp.float32), "bias": jnp.asarray(bias, jnp.float32)}
    ref = fnn.LayerNorm(dtype=jnp.dtype(out_dtype)).apply(
        {"params": params}, jnp.asarray(x, out_dtype)
    )
    ln = LayerNorm(48, getattr(torch, out_dtype), torch.device("cpu"))
    ln.load_state_dict(dt_params_from_flax(_numpy(params)), strict=True)
    out = ln(torch.from_numpy(x).to(getattr(torch, out_dtype)))
    assert out.dtype == getattr(torch, out_dtype)
    rtol = 1e-6 if out_dtype == "float32" else 2**-7
    np.testing.assert_allclose(
        out.detach().float().numpy(), np.asarray(ref, np.float32), atol=1e-6, rtol=rtol
    )


def test_dt_with_two_audio_planes_loads_and_matches_jax_f32():
    # Skeleton+'s states: video plus a stereo pair of audio planes.  The JAX
    # tower reads the channel count off the example batch at init.
    model, batch, ref = _both(TINY, 5, 2, channels=3)
    assert model.state_encoder.audio_net.Conv_0.in_channels == 2
    with torch.no_grad():
        out = model(*batch)
    np.testing.assert_allclose(out.numpy(), ref, atol=LOGIT_ATOL_F32, rtol=0)


def _loss_and_grads(model, batch):
    logits = model(*batch)
    loss = -(torch.log_softmax(logits, -1)
             * torch.nn.functional.one_hot(batch[2], TINY.num_actions)).sum()
    return loss, torch.autograd.grad(loss, list(model.parameters()))


def test_dt_remat_matches_no_remat_with_dropout():
    # torch.utils.checkpoint restores the global RNG before it recomputes a
    # block, so the recomputed dropout masks are the ones of the first pass:
    # loss and gradients are the same program's, to float32 summation order.
    cfg = DTConfig(**dict(dataclasses.asdict(TINY), dropout=0.1))
    batch = [torch.from_numpy(x) for x in _batch(6, TINY, 2)]
    batch[2], batch[3] = batch[2].long(), batch[3].long()
    torch.manual_seed(0)
    model = DecisionTransformer(cfg, device="cpu")
    model_r = DecisionTransformer(dataclasses.replace(cfg, remat=True), device="cpu")
    model_r.load_state_dict(model.state_dict())
    assert model.training and model_r.training
    calls = []
    for m in (model, model_r):
        m.block_0.register_forward_pre_hook(lambda mod, args: calls.append(mod))
    results = []
    for m in (model, model_r, model):
        torch.manual_seed(7)
        results.append(_loss_and_grads(m, batch))
    # remat runs block_0 again in the backward; without it, once a pass
    assert [c is model_r.block_0 for c in calls] == [False, True, True, False]
    (l0, g0), (l1, g1), (l2, _) = results
    torch.manual_seed(8)
    l3, _ = _loss_and_grads(model, batch)
    assert l0.item() == l2.item() != l3.item()  # dropout is on and seeded
    torch.testing.assert_close(l1, l0, rtol=1e-6, atol=0)
    for a, b in zip(g1, g0):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_dt_is_causal():
    cfg = DTConfig(**dataclasses.asdict(TINY))
    torch.manual_seed(0)
    model = DecisionTransformer(cfg, device="cpu").eval()
    rtg, states, actions, ts = (torch.from_numpy(x) for x in _batch(3, TINY, 2))
    actions, ts = actions.long(), ts.long()
    with torch.no_grad():
        logits = model(rtg, states, actions, ts)
        states2 = states.clone()
        states2[:, 4] += 0.5
        logits2 = model(rtg, states2, actions, ts)
        actions2 = actions.clone()
        actions2[:, 3] = (actions2[:, 3] + 1) % 4
        logits3 = model(rtg, states, actions2, ts)
    torch.testing.assert_close(logits[:, :4], logits2[:, :4], atol=1e-5, rtol=0)
    assert not torch.allclose(logits[:, 4:], logits2[:, 4:])
    # action_t is predicted from state_t, which precedes it causally
    torch.testing.assert_close(logits[:, 3], logits3[:, 3], atol=1e-5, rtol=0)


@pytest.mark.parametrize(
    "change", [dict(moe_experts=4), dict(seq_axis="seq", seq_axis_size=2)]
)
def test_unported_options_raise(change):
    """What is still unported of each option raises, naming ROADMAP A.8:
    the MoE aux loss over a sharded batch, in the data-parallel step and
    in the sequence-parallel step."""
    from mmtrl_tpu_torch.algos.dt.train import DTTrainConfig, create_dt_state, make_dt_train_step
    from mmtrl_tpu_torch.parallel import make_mesh
    from mmtrl_tpu_torch.parallel.seq_composed import make_dt_seq_train_step

    cfg = DTConfig(**dict(dataclasses.asdict(TINY), **dict(change, moe_experts=4)))
    if cfg.seq_axis:
        cfg = dataclasses.replace(cfg, seq_axis_size=1)
        step = make_dt_seq_train_step(cfg, make_mesh((1, 1), ("data", "seq")))
    else:
        step = make_dt_train_step(cfg, make_mesh())
    state = create_dt_state(cfg, DTTrainConfig(batch_size=2), device="cpu")
    batch = [torch.from_numpy(x) for x in _batch(0, TINY, 2)]
    batch[2], batch[3] = batch[2].long(), batch[3].long()
    batch.append(torch.ones(batch[0].shape))  # mask
    with pytest.raises(NotImplementedError, match="ROADMAP A.8"):
        step(state, batch)


@pytest.mark.parametrize(
    "change", [dict(moe_experts=4), dict(seq_axis="seq", seq_axis_size=2)]
)
def test_moe_and_seq_axis_options_build(change):
    """Both options are ported: MoE FFNs (since the cartridge slice) build
    a ``moe`` in every block; sequence-parallel attention (since the
    multi-device slice) builds the dense model's parameter tree, raises
    without a mesh, and on a one-rank ``seq`` mesh (a ring of one chunk)
    gives the dense model's logits.  The many-rank ring is held against
    JAX's in ``tests/test_torch_parallel.py``."""
    from mmtrl_tpu_torch.parallel import make_mesh

    cfg = DTConfig(**dict(dataclasses.asdict(TINY), **change))
    model = DecisionTransformer(cfg, device="cpu")
    if cfg.moe_experts:
        assert all(hasattr(getattr(model, f"block_{i}"), "moe") for i in range(cfg.n_layers))
        return
    dense = DecisionTransformer(DTConfig(**dataclasses.asdict(TINY)), device="cpu")
    model.load_state_dict(dense.state_dict(), strict=True)
    batch = [torch.from_numpy(x) for x in _batch(0, TINY, 2)]
    batch[2], batch[3] = batch[2].long(), batch[3].long()
    with torch.no_grad():
        with pytest.raises(ValueError, match="use_mesh"):
            model(*batch)
        model.use_mesh(make_mesh(axis_names=("seq",)))
        torch.testing.assert_close(model(*batch), dense(*batch), atol=LOGIT_ATOL_F32, rtol=0)


def test_converter_layouts():
    rng = np.random.RandomState(0)
    tree = {"params": {
        "Dense_0": {"kernel": rng.randn(3, 5), "bias": rng.randn(5)},
        "Conv_0": {"kernel": rng.randn(8, 8, 2, 4), "bias": rng.randn(4)},
        "ln": {"scale": rng.randn(5), "bias": rng.randn(5)},
        "emb": {"embedding": rng.randn(7, 5)},
    }}
    sd = dt_params_from_flax(tree)
    p = tree["params"]
    np.testing.assert_array_equal(sd["Dense_0.weight"], p["Dense_0"]["kernel"].T.astype(np.float32))
    np.testing.assert_array_equal(
        sd["Conv_0.weight"], p["Conv_0"]["kernel"].transpose(3, 2, 0, 1).astype(np.float32)
    )
    np.testing.assert_array_equal(sd["ln.weight"], p["ln"]["scale"].astype(np.float32))
    np.testing.assert_array_equal(sd["emb.weight"], p["emb"]["embedding"].astype(np.float32))
    assert set(sd) == {
        "Dense_0.weight", "Dense_0.bias", "Conv_0.weight", "Conv_0.bias",
        "ln.weight", "ln.bias", "emb.weight",
    }
    assert all(t.dtype == torch.float32 for t in sd.values())

"""Parity of the port's models (mmtrl_tpu_torch/models) with the JAX models on
converted weights, on the CPU, with dropout 0."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmtrl_tpu.models.common import AtariTower as JaxAtariTower
from mmtrl_tpu.models.decision_transformer import DecisionTransformer as JaxDT
from mmtrl_tpu.models.decision_transformer import DTConfig as JaxDTConfig
from mmtrl_tpu_torch.convert import dt_params_from_flax
from mmtrl_tpu_torch.models.common import AtariTower
from mmtrl_tpu_torch.models.decision_transformer import DecisionTransformer, DTConfig

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


def _batch(seed, cfg, B):
    rng = np.random.RandomState(seed)
    K = cfg.context_len
    if cfg.state_kind == "multimodal":
        states = rng.uniform(-1, 1, (B, K, 2, 84, 84))
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


def _both(cfg, seed, B, numpy_params=False):
    batch = _batch(seed, cfg, B)
    jmodel = JaxDT(cfg)
    if numpy_params:
        params = _numpy_params(jmodel, batch, seed)
    else:
        params = jmodel.init(jax.random.PRNGKey(seed), *map(jnp.asarray, batch))
    model = DecisionTransformer(DTConfig(**dataclasses.asdict(cfg)), device="cpu")
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
    # Both sides round every product to bf16 (8 significant bits), in other
    # places and orders; the difference is held to 5% of the largest logit.
    assert np.abs(out.numpy() - ref).max() <= 0.05 * np.abs(ref).max()


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
    cfg = DTConfig(**dict(dataclasses.asdict(TINY), **change))
    with pytest.raises(NotImplementedError):
        DecisionTransformer(cfg, device="cpu")


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

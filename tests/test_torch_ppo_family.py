"""The port's feedforward, google, RND and PPG modules against the JAX
package's on the CPU, on the same seeded numpy inputs and converted weights:
``RunningStat``, the spaces' samplers, the IMPALA, Atari and MLP towers,
``CNNAgent``, the google variant's ``GoogleAgent``, ``RNDAgent`` and both
``RNDNetwork``s on their image and vector branches, and ``PPGAgent`` with
the gradients of its detached aux head.  The updates are in
``test_torch_ppo_family_updates.py``."""

import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmtrl_tpu.algos.ppo.ppg import PPGAgent as JaxPPGAgent
from mmtrl_tpu.algos.ppo.rnd import RNDAgent as JaxRNDAgent
from mmtrl_tpu.algos.ppo.rnd import RNDNetwork as JaxRNDNetwork
from mmtrl_tpu.envs.wrappers import RunningStat as JaxRunningStat
from mmtrl_tpu.models import CNNAgent as JaxCNNAgent
from mmtrl_tpu.models.common import AtariTower as JaxAtariTower
from mmtrl_tpu.models.common import ImpalaTower as JaxImpalaTower
from mmtrl_tpu.models.common import MLPTower as JaxMLPTower
from mmtrl_tpu_torch.algos.ppo.ppg import PPGAgent
from mmtrl_tpu_torch.algos.ppo.rnd import RNDAgent, RNDNetwork
from mmtrl_tpu_torch.convert import agent_params_from_flax
from mmtrl_tpu_torch.envs.spaces import Box, Discrete
from mmtrl_tpu_torch.envs.wrappers import RunningStat
from mmtrl_tpu_torch.models import common
from mmtrl_tpu_torch.models.agents import CNNAgent
from mmtrl_tpu_torch.models.common import AtariTower, ImpalaTower, MLPTower
from mmtrl_tpu_torch.scripts.minecraft_lstm_google import GoogleAgent

REPO = Path(__file__).resolve().parent.parent
# Every output within this share of its own largest magnitude: float32 on
# both sides, convs and products summed in other orders (oneDNN against
# XLA), a few roundings of the largest term.
OUT_TOL_OF_MAX = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several worker processes at once; torch's own
    intra-op thread pool on top of that oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close_of_max(out, ref, what="", tol=OUT_TOL_OF_MAX):
    """|out - ref| <= tol * max|ref|, elementwise."""
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    ref = np.asarray(ref)
    assert out.shape == ref.shape, what
    np.testing.assert_allclose(out, ref, rtol=0, atol=tol * float(np.abs(ref).max()),
                               err_msg=what)


def _load(module, params):
    module.load_state_dict(agent_params_from_flax(jax.device_get(params)), strict=True)
    return module


def _obs(shape, seed):
    return np.random.RandomState(seed).uniform(-1, 1, shape).astype(np.float32)


def _nhwc(x):
    return jnp.asarray(np.moveaxis(x, -3, -1))


# ---- RunningStat and the spaces ---------------------------------------------
@pytest.mark.parametrize("shape", [(), (2, 3)])
def test_running_stat_matches_jax_over_three_batches(shape):
    """Three batches of different sizes and offsets merged in turn; the
    batch variances are population variances (ddof 0), as ``jnp.var``."""
    rng = np.random.RandomState(0)
    ref, out = JaxRunningStat.create(shape), RunningStat.create(shape, "cpu")
    assert float(out.count) == pytest.approx(1e-4) and out.count.dtype == torch.float32
    for n, loc in ((5, 1.0), (2, -3.0), (7, 0.5)):
        batch = (rng.randn(n, *shape) * 2 + loc).astype(np.float32)
        ref, out = ref.update(jnp.asarray(batch)), out.update(_t(batch))
        for name in ("mean", "var", "count"):
            np.testing.assert_allclose(getattr(out, name).numpy(), getattr(ref, name),
                                       rtol=1e-6, atol=1e-7, err_msg=name)
    x = rng.randn(4, *shape).astype(np.float32)
    np.testing.assert_allclose(out.normalize(_t(x)).numpy(), ref.normalize(jnp.asarray(x)),
                               rtol=1e-6, atol=1e-6)
    # two rows, 0 and 2: batch variance 1 (the sample variance would be 2)
    two = RunningStat.create((), "cpu").update(torch.tensor([0.0, 2.0]))
    assert float(two.var) == pytest.approx((1e-4 + 2 * 1.0 + 1e-4 * 2 / 2.0001) / 2.0001, rel=1e-6)


def test_spaces_sample_from_the_generator():
    g1, g2 = torch.Generator().manual_seed(4), torch.Generator().manual_seed(4)
    d = Discrete(5)
    draws = torch.stack([d.sample(g1) for _ in range(200)])
    assert draws.dtype == torch.int32 and draws.shape == (200,)
    assert set(draws.tolist()) == set(range(5))
    assert torch.equal(draws, torch.stack([d.sample(g2) for _ in range(200)]))
    box = Box(np.array([0.0, -1.0], np.float32), np.array([4.0, 1.0], np.float32), (2,))
    x = torch.stack([box.sample(g1) for _ in range(500)])
    assert x.dtype == torch.float32 and x.shape == (500, 2)
    assert all(box.contains(row.numpy()) for row in x)
    assert x[:, 0].max() > 3.5 and x[:, 1].min() < -0.9
    assert Box(0.0, 4.0, (2, 84, 84)).sample(g1).shape == (2, 84, 84)


# ---- towers -----------------------------------------------------------------
def _pool_symmetric(x):
    return torch.nn.functional.max_pool2d(x, 3, 2, padding=1)


def test_impala_tower_matches_jax_and_its_pool_pads_as_xla(monkeypatch):
    """84 -> 42 -> 21 -> 11: the SAME max pool pads (0, 1) at 84 and 42 and
    (1, 1) at 21.  The same tower with a symmetric (1, 1) pool everywhere
    is far outside the tolerance, so this test fails against one."""
    x = _obs((3, 2, 84, 84), 1)
    jmod = JaxImpalaTower()
    params = jmod.init(jax.random.PRNGKey(0), _nhwc(x))
    ref = jmod.apply(params, _nhwc(x))
    tower = _load(ImpalaTower(2, device="cpu"), params)
    assert [n for n, _ in tower.named_parameters()][:6] == [
        "ConvSequence_0.Conv_0.weight", "ConvSequence_0.Conv_0.bias",
        "ConvSequence_0.ResidualBlock_0.Conv_0.weight", "ConvSequence_0.ResidualBlock_0.Conv_0.bias",
        "ConvSequence_0.ResidualBlock_0.Conv_1.weight", "ConvSequence_0.ResidualBlock_0.Conv_1.bias"]
    with torch.no_grad():
        _close_of_max(tower(_t(x)), ref, "impala")
        monkeypatch.setattr(common, "max_pool_same", _pool_symmetric)
        shifted = tower(_t(x)).numpy()
    assert np.abs(shifted - np.asarray(ref)).max() > 100 * OUT_TOL_OF_MAX * np.abs(ref).max()


def test_impala_convs_take_flax_default_init():
    """lecun normal: variance 1 / fan_in, truncated at two deviations, and
    zero biases; the Dense keeps the orthogonal init."""
    torch.manual_seed(0)
    tower = ImpalaTower(2, device="cpu")
    w = tower.ConvSequence_1.ResidualBlock_0.Conv_1.weight  # 32 x 32 x 3 x 3
    std = (1.0 / (32 * 9)) ** 0.5
    assert abs(w.std().item() - std) < 0.05 * std
    assert w.abs().max().item() <= 2 * std / 0.87962566103423978 + 1e-6
    assert all(not b.detach().any() for n, b in tower.named_parameters() if n.endswith("bias"))
    assert tower.Dense_0.weight.shape == (256, 32 * 11 * 11)


def test_atari_tower_features_override_matches_jax():
    """The big trunk projected to 256 (the google variant's towers), on one
    channel: JAX takes its space-to-depth ``Conv_0`` there."""
    x = _obs((3, 1, 84, 84), 2)
    jmod = JaxAtariTower("big", features=256)
    params = jmod.init(jax.random.PRNGKey(1), _nhwc(x))
    tower = _load(AtariTower("big", 1, "cpu", features=256), params)
    assert tower.feature_size == 256 and tower.Dense_0.weight.shape == (256, 3136)
    with torch.no_grad():
        _close_of_max(tower(_t(x)), jmod.apply(params, _nhwc(x)), "tower")


@pytest.mark.parametrize("activation", ["tanh", "relu"])
def test_mlp_tower_matches_jax(activation):
    x = np.random.RandomState(3).randn(5, 7).astype(np.float32)
    jmod = JaxMLPTower((64, 32), activation)
    params = jmod.init(jax.random.PRNGKey(2), jnp.asarray(x))
    tower = _load(MLPTower(7, (64, 32), activation, "cpu"), params)
    with torch.no_grad():
        _close_of_max(tower(_t(x)), jmod.apply(params, jnp.asarray(x)), activation)


# ---- agents -----------------------------------------------------------------
def _feedforward_parity(jmodel, model, x, names):
    params = jmodel.init(jax.random.PRNGKey(3), jnp.asarray(x))
    ref = jax.jit(jmodel.apply)(params, jnp.asarray(x))
    _load(model, params)
    with torch.no_grad():
        out = model(_t(x))
    assert len(out) == len(ref) == len(names)
    for o, r, what in zip(out, ref, names):
        _close_of_max(o, r, what)
    return params


@pytest.mark.parametrize("conv,scale", [("small", 255.0), ("small", 1.0), ("big", 1.0)])
def test_cnn_agent_matches_jax(conv, scale):
    kw = dict(num_actions=4, conv_type=conv, input_scale=scale)
    _feedforward_parity(JaxCNNAgent(**kw), CNNAgent(**kw, device="cpu"), _obs((5, 2, 84, 84), 4),
                        ("logits", "value"))


def _jax_google_agent():
    """JAX's GoogleAgent, from its script (imported as the scripts import
    their siblings)."""
    sys.path.insert(0, str(REPO / "scripts"))
    try:
        spec = importlib.util.spec_from_file_location(
            "_jax_minecraft_lstm_google", REPO / "scripts" / "minecraft_lstm_google.py")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.GoogleAgent
    finally:
        sys.path.remove(str(REPO / "scripts"))


@pytest.mark.parametrize("offset", [0.0, 0.5])
def test_google_agent_matches_jax(offset):
    """T = 3, B = 2 with a reset inside the window, at the reference's input
    scale 255 and at 1 (where the towers decide more of the outputs)."""
    rng = np.random.RandomState(5)
    T, B = 3, 2
    obs = rng.uniform(-1, 1, (T, B, 2, 84, 84)).astype(np.float32)
    done = np.zeros((T, B), bool)
    done[1, 0] = True
    carry = tuple((rng.randn(B, 128) * 0.5).astype(np.float32) for _ in range(2))
    jcarry = tuple(map(jnp.asarray, carry))
    jagent_cls = _jax_google_agent()
    params = None
    for scale in (255.0, 1.0):
        jmodel = jagent_cls(num_actions=4, policy_offset=offset, input_scale=scale)
        if params is None:
            params = jmodel.init(jax.random.PRNGKey(4), jnp.asarray(obs), jnp.asarray(done), jcarry)
        ref = jax.jit(jmodel.apply)(params, jnp.asarray(obs), jnp.asarray(done), jcarry)
        model = _load(GoogleAgent(4, offset, input_scale=scale, device="cpu"), params)
        with torch.no_grad():
            logits, value, (h, c) = model(_t(obs), _t(done), tuple(map(_t, carry)))
        for o, r, what in zip((logits, value, h, c), (ref[0], ref[1], *ref[2]),
                              ("logits", "value", "h", "c")):
            _close_of_max(o, r, f"{what} at scale {scale}")
    if offset > 0:  # every action keeps at least offset / A of the mass
        assert float(torch.softmax(logits, -1).min()) >= offset / 4 - 1e-6
    assert [tuple(model.Dense_0.weight.shape), tuple(model.Dense_1.weight.shape)] == [
        (32, 128), (128, 128)]
    assert model.core.lstm.ih.weight.shape == (512, 512)


@pytest.mark.parametrize("image", [True, False])
def test_rnd_agent_and_networks_match_jax(image):
    shape = (2, 84, 84) if image else (6,)
    x = _obs((4,) + shape, 6)
    _feedforward_parity(JaxRNDAgent(num_actions=4), RNDAgent(4, shape, device="cpu"), x,
                        ("logits", "v_ext", "v_int"))
    for predictor in (False, True):
        jnet = JaxRNDNetwork(predictor=predictor)
        params = jnet.init(jax.random.PRNGKey(5), jnp.asarray(x))
        net = _load(RNDNetwork(shape, predictor=predictor, device="cpu"), params)
        assert ("Dense_1.weight" in net.state_dict()) == predictor
        with torch.no_grad():
            _close_of_max(net(_t(x)), jnet.apply(params, jnp.asarray(x)),
                          f"{'predictor' if predictor else 'target'}")


@pytest.mark.parametrize("image", [True, False])
def test_ppg_agent_matches_jax_and_its_aux_head_is_detached(image):
    """Outputs, and the gradients of a loss on the aux value alone: they
    reach the aux head and nothing else, in JAX and in the port."""
    shape = (2, 84, 84) if image else (6,)
    x = _obs((3,) + shape, 7)
    jmodel = JaxPPGAgent(num_actions=4)
    model = PPGAgent(4, shape, device="cpu")
    params = _feedforward_parity(jmodel, model, x, ("logits", "value", "aux_value"))
    target = np.array([0.5, -1.0, 2.0], np.float32)

    def jloss(p):
        return ((jmodel.apply(p, jnp.asarray(x))[2] - target) ** 2).sum()

    ref_grads = agent_params_from_flax(jax.device_get(jax.grad(jloss)(params)))
    loss = ((model(_t(x))[2] - _t(target)) ** 2).sum()
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()), allow_unused=True)
    for name, g in zip(names, grads):
        if name.startswith("aux_critic"):
            _close_of_max(g, ref_grads[name], name)
        else:
            assert g is None and not ref_grads[name].any(), name

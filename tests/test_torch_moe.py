"""The port's MoE FFN (mmtrl_tpu_torch/models/moe.py) and the MoE decision
transformer against the JAX package on the CPU: the combine weights, the
dense and gather dispatches and their gradients, drops past capacity with
first choices keeping their slots, tied router logits, the load-balance
aux loss, and a TINY MoE DT's forward and one train step under both
dispatches from the same converted weights."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmtrl_tpu.algos.dt import DTTrainConfig as JaxDTTrainConfig
from mmtrl_tpu.algos.dt import create_dt_state as jax_create_dt_state
from mmtrl_tpu.algos.dt import make_dt_train_step as jax_make_dt_train_step
from mmtrl_tpu.models import moe as jmoe
from mmtrl_tpu.models.decision_transformer import DecisionTransformer as JaxDT
from mmtrl_tpu.models.decision_transformer import DTConfig as JaxDTConfig
from mmtrl_tpu_torch.algos.dt import DTTrainConfig, create_dt_state, make_dt_train_step
from mmtrl_tpu_torch.convert import adam_state_from_flax, dt_params_from_flax
from mmtrl_tpu_torch.models import moe
from mmtrl_tpu_torch.models.decision_transformer import DTConfig

# float32 on both sides; the products sum in other orders (oneDNN against
# XLA's CPU dot), a few float32 roundings of values of order 1.
ATOL = 2e-5
TINY = JaxDTConfig(num_actions=4, context_len=6, d_model=32, n_layers=2, n_heads=2,
                   dropout=0.0, max_timestep=64, compute_dtype="float32", conv_type="small",
                   moe_experts=4, moe_top_k=2)
TRAIN = dict(learning_rate=1e-3, warmup_steps=2, total_steps=20)
# Parameters after one AdamW step from the same weights and zero moments:
# Adam's first step moves each parameter by about the learning rate times
# sign(gradient), so a gradient entry near zero, whose sign float32
# summation order decides, may differ by up to 2e-3; held to 1e-6 relative
# plus 5e-6 (as tests/test_torch_train.py), and to 1e-8 in the mean.
PARAM_ATOL = 5e-6


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _experts(rng, E, D, F):
    return [rng.normal(0, 0.3, s).astype(np.float32) for s in ((E, D, F), (E, F), (E, F, D), (E, D))]


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("k", [1, 2, 4])
def test_combine_weights_match_jax(k):
    logits = np.random.RandomState(k).normal(size=(3, 5, 4)).astype(np.float32)
    ref = np.asarray(jmoe.moe_combine_weights(jnp.asarray(logits), k))
    out = moe.moe_combine_weights(torch.from_numpy(logits), k).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-7)
    assert ((out > 0).sum(-1) == k).all()


def test_dense_dispatch_matches_jax():
    rng = np.random.RandomState(0)
    x = rng.normal(size=(2, 5, 8)).astype(np.float32)
    combine = np.asarray(jmoe.moe_combine_weights(jnp.asarray(rng.normal(size=(2, 5, 4)),
                                                              jnp.float32), 2))
    ws = _experts(rng, 4, 8, 16)
    ref = np.asarray(jmoe.moe_ffn_dense(*map(jnp.asarray, [x, combine] + ws)))
    out = moe.moe_ffn_dense(*_t(x, combine, *ws)).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


def test_gather_dispatch_and_its_gradients_match_jax():
    """Output and the gradients of a weighted sum of it with respect to the
    input and the four expert tensors; 2 x 80 tokens at cf 1.25 give C =
    128 of 160 rows, so some second choices drop."""
    rng = np.random.RandomState(1)
    x = rng.normal(size=(2, 80, 8)).astype(np.float32)
    logits = rng.normal(size=(2, 80, 4)).astype(np.float32)
    logits[..., 0] += 1.5  # expert 0 overflows
    w = rng.normal(size=x.shape).astype(np.float32)
    ws = _experts(rng, 4, 8, 16)
    assert moe.capacity(160, 2, 4, 1.25) == 128

    def jloss(x, *ws):
        return (jmoe.moe_ffn_gather(x, jnp.asarray(logits), *ws, top_k=2) * w).sum()

    ref_out = np.asarray(jmoe.moe_ffn_gather(*map(jnp.asarray, [x, logits] + ws), top_k=2))
    ref_grads = jax.grad(jloss, argnums=tuple(range(5)))(*map(jnp.asarray, [x] + ws))
    xt, *wt = (t.requires_grad_() for t in _t(x, *ws))
    out = moe.moe_ffn_gather(xt, torch.from_numpy(logits), *wt, top_k=2)
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(), [xt] + wt)
    np.testing.assert_allclose(out.detach().numpy(), ref_out, atol=ATOL, rtol=0)
    for name, g, r in zip(["x", "w1", "b1", "w2", "b2"], grads, ref_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-4, rtol=1e-5, err_msg=name)


def test_gather_drops_keep_first_choices():
    """256 tokens, E = 2, top-2, cf 0.25: C = 128.  Tokens 0-199 choose
    expert 0 first, tokens 200-255 second; expert 0's 128 slots go to the
    first choices of tokens 0-127 (choice-major), so tokens 128-199 lose
    their first choice and tokens 200-255 their second."""
    T, E, D, F = 256, 2, 4, 8
    rng = np.random.RandomState(2)
    x = rng.normal(size=(1, T, D)).astype(np.float32)
    logits = np.zeros((1, T, E), np.float32)
    logits[0, :200] = [2.0, 1.0]
    logits[0, 200:] = [1.0, 2.0]
    ws = _experts(rng, E, D, F)
    assert moe.capacity(T, 2, E, 0.25) == 128
    out = moe.moe_ffn_gather(*_t(x, logits, *ws), top_k=2, capacity_factor=0.25).numpy()
    ref = np.asarray(jmoe.moe_ffn_gather(*map(jnp.asarray, [x, logits] + ws), top_k=2,
                                         capacity_factor=0.25))
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)

    w1, b1, w2, b2 = ws

    def expert(e, xs):
        h = np.asarray(jax.nn.gelu(jnp.asarray(xs @ w1[e] + b1[e])))
        return h @ w2[e] + b2[e]

    hi, lo = np.exp(1.0) / (np.exp(1.0) + 1.0), 1.0 / (np.exp(1.0) + 1.0)  # softmax([2, 1])
    xs = x[0]
    expected = np.zeros_like(xs)
    # expert 1's slots: the first choices of 200-255 come before the
    # second choices of 0-199, which fill the remaining 72 slots (0-71)
    expected[:128] += hi * expert(0, xs[:128])
    expected[:72] += lo * expert(1, xs[:72])
    expected[200:] += hi * expert(1, xs[200:])
    np.testing.assert_allclose(out[0], expected, atol=1e-5, rtol=0)


def test_tied_router_logits_pick_the_lower_expert_as_jax():
    logits = np.array([[[1.0, 1.0, 1.0, 1.0], [0.0, 2.0, 2.0, 2.0], [3.0, 0.0, 3.0, 0.0]]],
                      np.float32)
    vals, idx = moe.stable_top_k(torch.from_numpy(logits), 2)
    jvals, jidx = jax.lax.top_k(jnp.asarray(logits), 2)
    assert idx.tolist() == np.asarray(jidx).tolist() == [[[0, 1], [1, 2], [0, 2]]]
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))
    combine = moe.moe_combine_weights(torch.from_numpy(logits), 2).numpy()
    np.testing.assert_array_equal(combine, np.asarray(jmoe.moe_combine_weights(
        jnp.asarray(logits), 2)))
    rng = np.random.RandomState(3)
    x = rng.normal(size=(1, 3, 4)).astype(np.float32)
    ws = _experts(rng, 4, 4, 8)
    out = moe.moe_ffn_gather(*_t(x, logits, *ws), top_k=2).numpy()
    ref = np.asarray(jmoe.moe_ffn_gather(*map(jnp.asarray, [x, logits] + ws), top_k=2))
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("k", [1, 2])
def test_load_balance_aux_matches_jax(k):
    logits = np.random.RandomState(4).normal(size=(2, 7, 4)).astype(np.float32)
    lj = jnp.asarray(logits)
    ref = float(jmoe.load_balance_aux(jax.nn.softmax(lj, -1), jmoe.moe_combine_weights(lj, k)))
    lt = torch.from_numpy(logits)
    out = float(moe.load_balance_aux(torch.softmax(lt, -1), moe.moe_combine_weights(lt, k)))
    np.testing.assert_allclose(out, ref, rtol=1e-6)
    uniform = torch.zeros(8, 4)  # every expert equally likely: aux is 1
    assert float(moe.load_balance_aux(torch.softmax(uniform, -1),
                                      moe.moe_combine_weights(uniform, 4))) == pytest.approx(1.0)


def _batch(seed, B=4, K=6):
    rng = np.random.RandomState(seed)
    mask = np.ones((B, K), bool)
    mask[0, :2] = False
    return (rng.uniform(-5, 10, (B, K)).astype(np.float32),
            rng.uniform(-1, 1, (B, K, 3, 84, 84)).astype(np.float32),
            rng.randint(0, 4, (B, K)).astype(np.int32),
            np.tile(np.arange(K, dtype=np.int32), (B, 1)), mask)


def _torch_batch(b):
    rtg, states, actions, ts, mask = (torch.from_numpy(x) for x in b)
    return rtg, states, actions.long(), ts.long(), mask


@pytest.fixture(scope="module")
def jax_step():
    """The JAX MoE DT (dense dispatch): logits and the blocks' mean sown aux
    of one forward, then one train step.  At TINY a batch is 72 tokens, the
    capacity C = 72, so nothing drops and JAX's gather dispatch computes the
    same (tests/test_moe.py); both of the port's dispatches are held to it."""
    cfg = TINY
    b = _batch(0)
    jb = tuple(map(jnp.asarray, b))
    # jitted: an eager flax init of the towers takes some 15 s
    jstate = jax.jit(lambda k, jb: jax_create_dt_state(k, cfg, JaxDTTrainConfig(**TRAIN), jb))(
        jax.random.PRNGKey(0), jb)
    params = jax.tree_util.tree_map(np.asarray, jstate.params)
    jlogits, muts = JaxDT(cfg).apply(jstate.params, *jb[:4], mutable=["intermediates"])
    auxes = jax.tree_util.tree_leaves(muts["intermediates"])
    forward = (np.asarray(jlogits), float(sum(auxes) / len(auxes)))
    jstate, jm = jax.jit(jax_make_dt_train_step(cfg))(jstate, jb, jax.random.PRNGKey(1))
    return b, params, forward, jstate, {k: float(v) for k, v in jm.items()}


@pytest.fixture(scope="module", params=["dense", "gather"])
def one_step(request, jax_step):
    """The port's MoE DT from the JAX weights: one forward, one train step."""
    b, params, forward, jstate, jm = jax_step
    pcfg = DTConfig(**dataclasses.asdict(dataclasses.replace(TINY, moe_dispatch=request.param)))
    state = create_dt_state(pcfg, DTTrainConfig(**TRAIN), device="cpu", state_channels=3)
    state.model.load_state_dict(dt_params_from_flax(params), strict=True)
    state.model.eval()
    with torch.no_grad():
        logits, aux = state.model(*_torch_batch(b)[:4], return_aux=True)
    ported = (logits.numpy(), float(aux))
    state, m = make_dt_train_step(pcfg)(state, _torch_batch(b))
    return forward, ported, (jstate, jm), (state, {k: float(v) for k, v in m.items()})


def test_moe_dt_forward_matches_jax(one_step):
    (ref_logits, ref_aux), (logits, aux), _, _ = one_step
    np.testing.assert_allclose(logits, ref_logits, atol=ATOL, rtol=0)
    np.testing.assert_allclose(aux, ref_aux, rtol=1e-6)


def test_moe_dt_train_step_matches_jax(one_step):
    _, _, (jstate, jm), (state, m) = one_step
    assert set(m) == set(jm) == {"dt/loss", "dt/action_accuracy", "dt/moe_aux"}
    np.testing.assert_allclose(m["dt/loss"], jm["dt/loss"], rtol=1e-6)
    np.testing.assert_allclose(m["dt/moe_aux"], jm["dt/moe_aux"], rtol=1e-6)
    ref = dt_params_from_flax(jax.tree_util.tree_map(np.asarray, jstate.params))
    out = dict(state.model.named_parameters())
    assert set(out) == set(ref) and any(".moe.experts_w1" in n for n in out)
    diffs = []
    for name, r in ref.items():
        o = out[name].detach()
        np.testing.assert_allclose(o.numpy(), r.numpy(), rtol=1e-6, atol=PARAM_ATOL, err_msg=name)
        diffs.append((o - r).abs().flatten())
    assert float(torch.cat(diffs).mean()) <= 1e-8
    # the optimizer state carries over, the experts' moments included
    names = [n for n, _ in state.model.named_parameters()]
    opt = jstate.opt_state
    carried = adam_state_from_flax(opt.count, jax.tree_util.tree_map(np.asarray, opt.mu),
                                   jax.tree_util.tree_map(np.asarray, opt.nu), names)
    for name, a, b in zip(names, carried.mu, state.opt_state.mu):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-7, msg=name)
    for name, a, b in zip(names, carried.nu, state.opt_state.nu):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-10, msg=name)


def test_moe_aux_survives_remat():
    """With remat each block's forward runs again in the backward; the aux
    comes back as each block's output, so it is counted once: loss, aux and
    every gradient equal the run without remat."""
    cfg = DTConfig(**dataclasses.asdict(dataclasses.replace(TINY, moe_dispatch="gather")))
    b = _torch_batch(_batch(5))
    runs = []
    for remat in (False, True):
        state = create_dt_state(dataclasses.replace(cfg, remat=remat, dropout=0.1),
                                DTTrainConfig(**TRAIN), seed=3, device="cpu", state_channels=3)
        state.model.train()
        torch.manual_seed(0)
        logits, aux = state.model(*b[:4], return_aux=True)
        loss = logits.square().mean() + cfg.moe_aux_coef * aux
        grads = torch.autograd.grad(loss, list(state.model.parameters()))
        runs.append((loss.item(), aux.item(), grads))
    (loss0, aux0, g0), (loss1, aux1, g1) = runs
    assert loss0 == loss1 and aux0 == aux1
    for a, c in zip(g0, g1):
        torch.testing.assert_close(a, c, rtol=0, atol=0)

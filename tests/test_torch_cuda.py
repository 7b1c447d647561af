"""Card-only tests of the port's CUDA kernels against their plain versions.

They import no JAX, so they also run where only PyTorch is installed:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Without a GPU each test skips: a CUDA kernel has no CPU mode.
"""

import pytest
import torch

from mmtrl_tpu_torch.ops import flash_attention as fa


def _qkv(shape, dtype, seed, n=3):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(shape, generator=g, device="cuda").to(dtype) for _ in range(n)]


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")


def _check_fwd(q, k, v, blocks, heads=None):
    """One launch of the forward against its plain version, over the (B, H)
    heads selected by the boolean mask ``heads`` (all by default)."""
    before = fa.launches
    o, lse = fa.flash_attention_fwd(q, k, v, *blocks)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    o_ref, lse_ref = fa.flash_attention_fwd_plain(q, k, v)
    if heads is not None:
        o, lse, o_ref, lse_ref = o[heads], lse[heads], o_ref[heads], lse_ref[heads]
    # one rounding of the same float32 result to the output dtype, plus
    # float32 summation order
    tol = 1e-5 if q.dtype == torch.float32 else 1e-2
    assert ((o.float() - o_ref.float()).abs() <= tol * (1 + o_ref.float().abs())).all()
    assert (lse - lse_ref).abs().max().item() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize(
    "dtype,shape,blocks",
    [(torch.float32, (16, 4, 90, 128), (0, 0)), (torch.float32, (2, 4, 37, 64), (4, 64)),
     (torch.float32, (1, 2, 300, 128), (16, 64)), (torch.bfloat16, (16, 4, 90, 128), (0, 0)),
     (torch.bfloat16, (2, 4, 37, 64), fa.BF16_BLOCKS), (torch.bfloat16, (1, 2, 300, 128), (0, 0))]
    + [(torch.bfloat16, (2, 3, S, D), (0, 0)) for D in (16, 32, 64, 128) for S in (1, 63, 64, 65, 90)],
)
def test_flash_fwd_matches_plain_version(dtype, shape, blocks):
    _need_gpu()
    _check_fwd(*_qkv(shape, dtype, 1), blocks)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [37, 90])
def test_flash_fwd_nan_head_stays_in_its_head(S):
    """One head's K and V all NaN: the other heads still equal the plain
    version, so no tile reads past a head's last row (S = 37 and 90 leave a
    ragged last tile)."""
    _need_gpu()
    q, k, v = _qkv((2, 4, S, 128), torch.bfloat16, 3)
    k[0, 1], v[0, 1] = float("nan"), float("nan")
    others = torch.ones(2, 4, dtype=torch.bool, device="cuda")
    others[0, 1] = False
    _check_fwd(q, k, v, (0, 0), others)


@pytest.mark.cuda
def test_flash_fwd_rejects_what_the_kernel_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    q, k, v = _qkv((1, 2, 16, 96), torch.bfloat16, 0)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_fwd(q, k, v)
    q, k, v = _qkv((1, 2, 16, 64), torch.float16, 0)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa.flash_attention_fwd(q, k, v)
    q, k, v = _qkv((1, 16, 2, 64), torch.bfloat16, 0)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_fwd(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))


@pytest.mark.cuda
def test_flash_fwd_heads_past_grid_y():
    """B * H > 65535: the bf16 forward's 1-D persistent grid takes it; the
    float32 kernel, with B * H on grid.y, refuses it."""
    _need_gpu()
    q, k, v = _qkv((2, 35000, 1, 16), torch.bfloat16, 4)
    _check_fwd(q, k, v, (0, 0))
    with pytest.raises(ValueError, match="B \\* H <= 65535"):
        fa.flash_attention_fwd(q.float(), k.float(), v.float())


def _check_bwd(q, k, v, do, blocks, heads=None):
    """One launch of each backward kernel against the plain backward on the
    same lse and delta, over the (B, H) heads selected by the boolean mask
    ``heads`` (all by default)."""
    o, lse = fa.flash_attention_fwd(q, k, v)  # its own default blocks
    delta = (do.float() * o.float()).sum(-1)
    before = (fa.dq_launches, fa.dkv_launches)
    grads = fa.flash_attention_bwd(q, k, v, do, lse, delta, *blocks)
    torch.cuda.synchronize()
    assert (fa.dq_launches, fa.dkv_launches) == (before[0] + 1, before[1] + 1)
    # the same float32 sums in another order; in bf16 a rounding of P or dS
    # to bf16 may flip, so 2^-6 of the tensor's largest magnitude
    tol = 1e-5 if q.dtype == torch.float32 else 2**-6
    for g, ref in zip(grads, fa.flash_attention_bwd_plain(q, k, v, do, lse, delta)):
        assert g.dtype == q.dtype
        if heads is not None:
            g, ref = g[heads], ref[heads]
        scale = max(1.0, ref.float().abs().max().item())
        assert (g.float() - ref.float()).abs().max().item() <= tol * scale


# float32 takes the CUDA-core kernels at their block choices, bfloat16 the
# tensor-core kernels at their one tile: the model's lengths, a ragged tile,
# one row and a tile and one row, at the smallest and largest head dims.
@pytest.mark.cuda
@pytest.mark.parametrize(
    "dtype,shape,blocks",
    [(torch.float32, (2, 4, 90, 128), (0, 0)), (torch.float32, (2, 4, 37, 64), (4, 64)),
     (torch.float32, (2, 4, 37, 64), (16, 32)), (torch.float32, (1, 2, 37, 16), (0, 0)),
     (torch.float32, (1, 3, 70, 32), (8, 64)), (torch.bfloat16, (2, 4, 90, 128), (0, 0)),
     (torch.bfloat16, (2, 4, 37, 64), fa.BF16_BLOCKS), (torch.bfloat16, (1, 2, 37, 16), (0, 0)),
     (torch.bfloat16, (1, 3, 70, 32), fa.BF16_BLOCKS), (torch.bfloat16, (1, 2, 300, 128), (0, 0))]
    + [(torch.bfloat16, (2, 3, S, D), (0, 0)) for D in (16, 128) for S in (1, 65, 90)],
)
def test_flash_bwd_matches_plain_version(dtype, shape, blocks):
    _need_gpu()
    _check_bwd(*_qkv(shape, dtype, 2, 4), blocks)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [37, 90])
def test_flash_bwd_nan_head_stays_in_its_head(S):
    """One head's q, k, v and dO all NaN, and so its lse and delta: the
    other heads still equal the plain backward, so no tile or lse/delta load
    reads past a head's last row."""
    _need_gpu()
    q, k, v, do = _qkv((2, 4, S, 128), torch.bfloat16, 3, 4)
    for t in (q, k, v, do):
        t[0, 1] = float("nan")
    others = torch.ones(2, 4, dtype=torch.bool, device="cuda")
    others[0, 1] = False
    _check_bwd(q, k, v, do, (0, 0), others)


@pytest.mark.cuda
def test_flash_bwd_heads_past_grid_y():
    """B * H > 65535: the bf16 backward kernels' 1-D persistent grids take
    it; the float32 kernels, with B * H on grid.y, refuse it."""
    _need_gpu()
    q, k, v, do = _qkv((2, 35000, 1, 16), torch.bfloat16, 4, 4)
    _check_bwd(q, k, v, do, (0, 0))
    q, k, v, do = (t.float() for t in (q, k, v, do))
    lse = torch.zeros(q.shape[:3], device="cuda")
    with pytest.raises(ValueError, match="B \\* H <= 65535"):
        fa.flash_attention_dkv(q, k, v, do, lse, lse)


@pytest.mark.cuda
def test_tiny_train_step_on_the_card_matches_the_cpu():
    _need_gpu()
    from mmtrl_tpu_torch.algos.dt import DTTrainConfig, create_dt_state, make_dt_train_step
    from mmtrl_tpu_torch.models.decision_transformer import DTConfig

    # TINY: head dim 16, float32, dropout 0
    cfg = DTConfig(num_actions=4, context_len=6, d_model=32, n_layers=2, n_heads=2,
                   dropout=0.0, max_timestep=64, compute_dtype="float32")
    tcfg = DTTrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10)
    g = torch.Generator().manual_seed(0)
    batch = (torch.rand(4, 6, generator=g) * 10, torch.rand(4, 6, 2, 84, 84, generator=g) * 2 - 1,
             torch.randint(0, 4, (4, 6), generator=g), torch.arange(6).repeat(4, 1),
             torch.ones(4, 6, dtype=torch.bool))
    states = {dev: create_dt_state(cfg, tcfg, seed=3, device=dev) for dev in ("cuda", "cpu")}
    states["cpu"].model.load_state_dict(states["cuda"].model.state_dict())
    step = make_dt_train_step(cfg)
    fa.launches = fa.dq_launches = fa.dkv_launches = 0
    metrics = {}
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # full float32 on both sides
    try:
        for dev, state in states.items():
            for _ in range(2):
                state, m = step(state, [t.to(dev) for t in batch])
            metrics[dev] = float(m["dt/loss"])
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    assert (fa.launches, fa.dq_launches, fa.dkv_launches) == (4, 4, 4)  # 2 layers x 2 steps
    assert abs(metrics["cuda"] - metrics["cpu"]) <= 1e-5 * abs(metrics["cpu"])
    for a, b in zip(states["cuda"].model.parameters(), states["cpu"].model.parameters()):
        # float32, sums in other orders; Adam can move a parameter whose
        # gradient is near zero by up to the learning rate (1e-3)
        torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_online_agent_on_the_card_matches_the_cpu():
    _need_gpu()
    from mmtrl_tpu_torch.models.agents import MultimodalRecurrentAgent

    torch.manual_seed(0)
    kw = dict(num_actions=4, conv_type="small", attn_type="casl", input_scale=1.0)
    card = MultimodalRecurrentAgent(**kw, device="cuda")
    cpu = MultimodalRecurrentAgent(**kw, device="cpu")
    cpu.load_state_dict(card.state_dict())
    g = torch.Generator().manual_seed(1)
    obs = torch.rand(5, 3, 2, 84, 84, generator=g) * 2 - 1
    done = torch.zeros(5, 3, dtype=torch.bool)
    done[2, 1] = True
    carry = tuple(torch.randn(3, 128, generator=g) * 0.5 for _ in range(2))
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            out = card(obs.cuda(), done.cuda(), tuple(c.cuda() for c in carry))
            ref = cpu(obs, done, carry)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    # float32 on both sides: convs and products summed in other orders,
    # carried through 5 LSTM steps
    for o, r in zip((out[0], out[1], *out[2]), (ref[0], ref[1], *ref[2])):
        assert (o.cpu() - r).abs().max().item() <= 1e-4 * max(r.abs().max().item(), 1e-6)


@pytest.mark.cuda
def test_tiny_ppo_run_on_the_card(tmp_path, monkeypatch):
    _need_gpu()
    import math

    from mmtrl_tpu_torch.core.checkpoint import load_run
    from mmtrl_tpu_torch.core.config import cli
    from mmtrl_tpu_torch.scripts import train

    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("MMTRL_RUN_ROOT", str(tmp_path / "runs"))
    out = train.main(cli(train.Args, [
        "--conv-size", "small", "--attn-type", "casl", "--num-envs", "4", "--num-steps", "8",
        "--num-minibatches", "2", "--update-epochs", "2", "--total-timesteps", "64",
        "--save-interval", "2"]))
    assert out["runner"].obs.device.type == "cuda" and len(out["history"]) == 2
    assert all(math.isfinite(v) for row in out["history"] for k, v in row.items()
               if k.startswith("losses/") and k != "losses/explained_variance")
    ckpt = str(tmp_path / "saved_agents" / out["run_name"])
    assert int(load_run(ckpt)["opt_state"]["count"]) == 8
    # the payload loads onto the card, the generator state included
    resumed = train.main(cli(train.Args, [
        "--conv-size", "small", "--attn-type", "casl", "--num-envs", "4", "--num-steps", "8",
        "--num-minibatches", "2", "--update-epochs", "2", "--total-timesteps", "96",
        "--load-from", ckpt]))
    assert resumed["initial_update"] == 3 and len(resumed["history"]) == 1


def _ppo_family_agent(name, device):
    from mmtrl_tpu_torch.algos.ppo.ppg import PPGAgent
    from mmtrl_tpu_torch.algos.ppo.rnd import RNDAgent, RNDNetwork
    from mmtrl_tpu_torch.models.agents import CNNAgent
    from mmtrl_tpu_torch.scripts.minecraft_lstm_google import GoogleAgent

    shape = (2, 84, 84)
    return {
        "cnn": lambda: CNNAgent(4, "small", input_scale=1.0, device=device),
        "google": lambda: GoogleAgent(4, 0.5, input_scale=1.0, device=device),
        "rnd": lambda: RNDAgent(4, shape, device=device),
        "rnd_target": lambda: RNDNetwork(shape, device=device),
        "rnd_predictor": lambda: RNDNetwork(shape, predictor=True, device=device),
        "ppg": lambda: PPGAgent(4, shape, device=device),
    }[name]()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cnn", "google", "rnd", "rnd_target", "rnd_predictor", "ppg"])
def test_ppo_family_agent_on_the_card_matches_the_cpu(name):
    """The feedforward, google, RND and PPG agents in float32 (no TF32) on
    the card against the same weights on the CPU: every output within 1e-5
    of its largest magnitude (convs summed in other orders; the google
    agent's LSTM carries them through 4 steps)."""
    _need_gpu()
    torch.manual_seed(0)
    card = _ppo_family_agent(name, "cuda")
    cpu = _ppo_family_agent(name, "cpu")
    cpu.load_state_dict(card.state_dict())
    g = torch.Generator().manual_seed(1)
    obs = torch.rand(4, 3, 2, 84, 84, generator=g) * 2 - 1
    if name == "google":
        done = torch.zeros(4, 3, dtype=torch.bool)
        done[2, 1] = True
        carry = tuple(torch.randn(3, 128, generator=g) * 0.5 for _ in range(2))
        args = (obs, done, carry)
    else:
        args = (obs.reshape(12, 2, 84, 84),)
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            out = card(*[a.cuda() if torch.is_tensor(a) else tuple(c.cuda() for c in a)
                         for a in args])
            ref = cpu(*args)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    flat = lambda t: [x for o in (t if isinstance(t, tuple) else (t,))  # noqa: E731
                      for x in (o if isinstance(o, tuple) else (o,))]
    for o, r in zip(flat(out), flat(ref), strict=True):
        assert (o.cpu() - r).abs().max().item() <= 1e-5 * max(r.abs().max().item(), 1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("dispatch", ["dense", "gather"])
def test_moe_block_on_the_card_matches_the_cpu(dispatch):
    """One MoE Block (the flash kernel, then the top-2 of 4 experts)
    forward and backward, float32 with TF32 off: 8 x 90 tokens, so the
    gather dispatch's capacity (512 of 720 rows) drops assignments."""
    _need_gpu()
    from mmtrl_tpu_torch.models.decision_transformer import Block, DTConfig

    cfg = DTConfig(num_actions=6, context_len=30, d_model=64, n_layers=1, n_heads=2,
                   dropout=0.0, compute_dtype="float32", moe_experts=4, moe_top_k=2,
                   moe_dispatch=dispatch)
    torch.manual_seed(0)
    card = Block(cfg, torch.device("cuda"))
    cpu = Block(cfg, torch.device("cpu"))
    cpu.load_state_dict(card.state_dict())
    g = torch.Generator().manual_seed(1)
    x = torch.randn(8, 90, 64, generator=g)
    w = torch.randn(x.shape, generator=g)
    sides = []
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        for m, dev in ((card, "cuda"), (cpu, "cpu")):
            xi = x.to(dev).requires_grad_()
            y, aux = m(xi)
            grads = torch.autograd.grad((y * w.to(dev)).sum() + aux, [xi] + list(m.parameters()))
            sides.append([y.detach().cpu(), aux.detach().cpu()] + [t.cpu() for t in grads])
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    # float32 sums in other orders; the routing (a logit gap near 1e-6
    # would flip a choice) is the same on both sides
    for a, b in zip(*sides):
        assert (a - b).abs().max().item() <= 1e-4 * max(b.abs().max().item(), 1e-6)


@pytest.mark.cuda
def test_native_observation_on_the_card_matches_the_cpu():
    """RALLY at 4 envs for 30 pool steps: ``_obs`` on the card (cuFFT) and
    on the CPU (pocketfft) from the same frames and u8 audio code."""
    _need_gpu()
    import numpy as np

    from mmtrl_tpu_torch.data.quant import dequant_audio_u8, quant_audio_u8
    from mmtrl_tpu_torch.envs.homebrew_native import NativeHomebrew

    card, cpu = NativeHomebrew(4, seed=2), NativeHomebrew(4, seed=2, device="cpu")
    rng = np.random.default_rng(0)
    try:
        frames, audio = card._host_reset()
        for _ in range(30):
            code = torch.from_numpy(quant_audio_u8(audio))
            obs = card._obs(frames, dequant_audio_u8(code.cuda()))
            ref = cpu._obs(frames, dequant_audio_u8(code))
            assert obs.device.type == "cuda" and obs.shape == (4, 3, 84, 84)
            # values in [-1, 1]; float32 cepstra up to 40 summed in other
            # orders, divided by each plane's range
            assert (obs.cpu() - ref).abs().max().item() <= 1e-4
            frames, audio = card._host_step(rng.integers(0, 6, 4).astype(np.int32))[:2]
    finally:
        card.close()
        cpu.close()


@pytest.mark.cuda
def test_skeleton_sim_on_the_card_matches_the_cpu():
    """The Skeleton+ simulator at 8 envs for 40 steps of random actions, the
    draws made on the CPU and replayed into the card env: state, reward and
    done equal, the frame equal, the MFCC planes (cuFFT against pocketfft)
    within 1e-4."""
    _need_gpu()
    from mmtrl_tpu_torch.envs.skeleton_plus import SkeletonPlusSim

    cpu, card = SkeletonPlusSim(device="cpu"), SkeletonPlusSim()
    tape = []

    def record(draw):
        def sampler(n, generator):
            tape.append(draw(n, generator))
            return tape[-1]

        return sampler

    cpu.reset_sampler, cpu.step_sampler, cpu.noise_sampler = (
        record(cpu.draw_reset), record(cpu.draw_step), record(cpu.draw_noise))
    card.reset_sampler = card.step_sampler = card.noise_sampler = lambda n, g: tape.pop(0)
    g = torch.Generator().manual_seed(0)
    obs_cpu, s_cpu = cpu.reset(8, g)
    obs, s = card.reset(8)
    for _ in range(40):
        assert obs.device.type == "cuda" and torch.equal(obs[:, 0].cpu(), obs_cpu[:, 0])
        assert (obs.cpu() - obs_cpu).abs().max().item() <= 1e-4
        action = torch.randint(0, 5, (8,), generator=g)
        obs_cpu, s_cpu, r_cpu, d_cpu, _ = cpu.step(s_cpu, action, g)
        obs, s, r, d, _ = card.step(s, action.cuda())
        for name in ("agent", "facing", "skeleton", "skel_hits", "kills", "life", "t", "phase"):
            assert torch.equal(getattr(s, name).cpu(), getattr(s_cpu, name)), name
        assert torch.equal(r.cpu(), r_cpu) and torch.equal(d.cpu(), d_cpu)
    assert not tape


@pytest.mark.cuda
@pytest.mark.parametrize("algo", ["dqn", "c51"])
def test_td_update_on_the_card_matches_the_cpu(algo):
    """One TD update of the full-width Q network at batch 32, in float64 on
    the card and on the CPU from the same weights and batch: parameters
    within 1e-9 (float32 would let a ReLU switch and Adam turn it into a
    step of the learning rate)."""
    _need_gpu()
    from mmtrl_tpu_torch.algos.offpolicy import c51_td_update, create_dqn_state, dqn_td_update
    from mmtrl_tpu_torch.models.agents import DistributionalQNetwork, QNetwork

    g = torch.Generator().manual_seed(0)
    batch = dict(obs=torch.rand(32, 3, 84, 84, generator=g) * 2 - 1,
                 next_obs=torch.rand(32, 3, 84, 84, generator=g) * 2 - 1,
                 action=torch.randint(0, 6, (32,), generator=g),
                 reward=torch.randint(-1, 2, (32,), generator=g).float(),
                 done=(torch.rand(32, generator=g) < 0.2).float())
    torch.manual_seed(0)
    net = (QNetwork(6, 1.0, device="cpu") if algo == "dqn"
           else DistributionalQNetwork(6, 51, 1.0, device="cpu"))
    sides = []
    for device in ("cuda", "cpu"):
        ts = create_dqn_state(type(net)(6, *(() if algo == "dqn" else (51,)), 1.0,
                                        device=device).double(), 1e-4, 1e-8)
        ts.model.load_state_dict(net.state_dict())
        ts.target.load_state_dict({k: v * 0.9 for k, v in net.state_dict().items()})
        b = {k: (v.double() if v.is_floating_point() else v).to(device) for k, v in batch.items()}
        if algo == "dqn":
            ts, loss, _, _ = dqn_td_update(0.99, ts, b)
        else:
            atoms = torch.linspace(-10.0, 10.0, 51, dtype=torch.float64, device=device)
            ts, loss, _ = c51_td_update(atoms, 0.99, ts, b)
        sides.append((loss.item(), [p.detach().cpu() for p in ts.model.parameters()]))
    (loss_card, card), (loss_cpu, cpu) = sides
    assert abs(loss_card - loss_cpu) <= 1e-9 * abs(loss_cpu)
    assert max((a - b).abs().max().item() for a, b in zip(card, cpu)) <= 1e-9
    assert any(not torch.equal(a, b.double()) for a, b in zip(cpu, net.parameters()))

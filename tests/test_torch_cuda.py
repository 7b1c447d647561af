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

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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "shape,blocks",
    [((16, 4, 90, 128), (0, 0)), ((2, 4, 37, 64), (4, 64)), ((1, 2, 300, 128), (16, 64))],
)
def test_flash_fwd_matches_plain_version(shape, blocks, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    q, k, v = _qkv(shape, dtype, 1)
    before = fa.launches
    o, lse = fa.flash_attention_fwd(q, k, v, *blocks)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    o_ref, lse_ref = fa.flash_attention_fwd_plain(q, k, v)
    # one rounding of the same float32 result to the output dtype, plus
    # float32 summation order
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    assert ((o.float() - o_ref.float()).abs() <= tol * (1 + o_ref.float().abs())).all()
    assert (lse - lse_ref).abs().max().item() <= 1e-4


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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "shape,blocks",
    [((2, 4, 90, 128), (0, 0)), ((2, 4, 37, 64), (4, 64)), ((2, 4, 37, 64), (16, 32)),
     ((1, 2, 37, 16), (0, 0)), ((1, 3, 70, 32), (8, 64))],
)
def test_flash_bwd_matches_plain_version(shape, blocks, dtype):
    _need_gpu()
    q, k, v, do = _qkv(shape, dtype, 2, 4)
    o, lse = fa.flash_attention_fwd(q, k, v, *blocks)
    delta = (do.float() * o.float()).sum(-1)
    before = (fa.dq_launches, fa.dkv_launches)
    grads = fa.flash_attention_bwd(q, k, v, do, lse, delta, *blocks)
    torch.cuda.synchronize()
    assert (fa.dq_launches, fa.dkv_launches) == (before[0] + 1, before[1] + 1)
    # the same float32 sums in another order; in bf16 a rounding of P or dS
    # to bf16 may flip, so 2^-6 of the tensor's largest magnitude
    tol = 1e-5 if dtype == torch.float32 else 2**-6
    for g, ref in zip(grads, fa.flash_attention_bwd_plain(q, k, v, do, lse, delta)):
        assert g.dtype == dtype
        scale = max(1.0, ref.float().abs().max().item())
        assert (g.float() - ref.float()).abs().max().item() <= tol * scale


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

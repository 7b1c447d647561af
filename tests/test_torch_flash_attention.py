"""Parity of the port's causal attention (mmtrl_tpu_torch/ops/flash_attention.py)
with the JAX package on the CPU: the plain forward and backward against the
Pallas kernels run in interpret mode and against the jnp reference; the
kernels themselves are compared on the card (tests/test_torch_cuda.py and
chip_smoke.py)."""

import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmtrl_tpu.ops import flash_attention as jfa
from mmtrl_tpu_torch.ops import _build
from mmtrl_tpu_torch.ops import flash_attention as tfa

REPO = Path(__file__).resolve().parent.parent
# (atol, rtol).  The plain forward does the Pallas kernel's arithmetic (P
# rounded to v's dtype for PV, l summed in float32), so in bf16 the two
# agree but for a rare flip of the final rounding by float32 summation
# order: one bf16 ulp, at most 2^-7 relative.  The port's mha_reference does
# the jnp reference's arithmetic and agrees with it as closely.  The jnp
# reference rounds the normalised P, the kernel the unnormalised one, so in
# bf16 the plain forward and the jnp reference differ by up to one rounding
# of the output, 2^-8 of |o| <= 4.  float32: summation order only.
TOL_PALLAS = {"float32": (1e-6, 1e-6), "bfloat16": (1e-7, 2**-7)}
TOL_REFERENCE = {"float32": (1e-6, 1e-6), "bfloat16": (1e-3, 2**-7)}
TOL_PLAIN_REFERENCE = {"float32": (1e-6, 1e-6), "bfloat16": (2e-2, 0.0)}
# dQ, dK, dV in bf16 against the Pallas backward: both round P and dS to bf16
# before the products, so a float32 difference in the last place can flip
# one such rounding; held to 2^-8 of the tensor's largest magnitude.  Against
# autograd of the plain forward, whose backward keeps dS in float32 and
# rounds at other places, 2^-6.  float32: summation order only, of terms up
# to ~10 (dP and delta, which cancel exactly when S = 1).
BWD_TOL_OF_MAX_PALLAS = {"float32": 1e-5, "bfloat16": 2**-8}
BWD_TOL_OF_MAX_AUTOGRAD = {"float32": 1e-5, "bfloat16": 2**-6}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several worker processes at once; torch's own
    intra-op thread pool on top of that oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qkv(seed, B, H, S, D, dtype):
    rng = np.random.RandomState(seed)
    x = rng.randn(3, B, H, S, D).astype(np.float32)
    t = torch.from_numpy(x).to(getattr(torch, dtype))
    return t[0], t[1], t[2]


def _lse64(q, k):
    """Float64 causal logsumexp of the (already rounded) inputs."""
    q64, k64 = q.double().numpy(), k.double().numpy()
    s = np.einsum("bhqd,bhkd->bhqk", q64, k64) * q.shape[-1] ** -0.5
    S = q.shape[-2]
    s = np.where(np.tril(np.ones((S, S), bool)), s, -np.inf)
    m = s.max(-1, keepdims=True)
    return (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]


def _qkvdo(S, D, dtype):
    rng = np.random.RandomState(S * 100 + D)
    x = rng.randn(4, 2, 2, S, D).astype(np.float32)
    return list(torch.from_numpy(x).to(getattr(torch, dtype)))


@functools.cache
def _jax_pallas(S, D, dtype):
    """(o, dq, dk, dv) of the JAX package's Pallas kernels, run in interpret
    mode on the CPU with one 128-row block, on ``_qkvdo``'s inputs."""
    q, k, v, do = (jnp.asarray(t.float().numpy(), dtype=dtype) for t in _qkvdo(S, D, dtype))
    interpret = functools.partial(jfa.pl.pallas_call, interpret=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jfa.pl, "pallas_call", interpret)
        f = functools.partial(jfa.causal_flash_attention, block_q=128, block_k=128,
                              force_pallas=True)
        o, vjp = jax.vjp(f, q, k, v)
        grads = vjp(do)
    return tuple(np.asarray(x).astype(np.float32) for x in (o, *grads))


def _close(out, ref, tol):
    atol, rtol = tol
    np.testing.assert_allclose(out.float().numpy(), ref, atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [16, 64])
@pytest.mark.parametrize("S", [1, 37, 90])
def test_port_matches_jax_reference(S, D, dtype):
    q, k, v, _ = _qkvdo(S, D, dtype)
    to_jax = lambda t: jnp.asarray(t.float().numpy(), dtype=dtype)  # noqa: E731
    o_jax = np.asarray(jfa.mha_reference(to_jax(q), to_jax(k), to_jax(v))).astype(np.float32)

    o_ref = tfa.mha_reference(q, k, v)
    o_plain, lse = tfa.flash_attention_fwd_plain(q, k, v)
    assert o_ref.dtype == o_plain.dtype == q.dtype and lse.dtype == torch.float32
    assert lse.shape == (2, 2, S)
    _close(o_ref, o_jax, TOL_REFERENCE[dtype])
    _close(o_plain, o_jax, TOL_PLAIN_REFERENCE[dtype])
    _close(o_plain, _jax_pallas(S, D, dtype)[0], TOL_PALLAS[dtype])
    np.testing.assert_allclose(lse.numpy(), _lse64(q, k), atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [16, 64])
@pytest.mark.parametrize("S", [1, 37, 90])
def test_bwd_plain_matches_jax_pallas_and_autograd(S, D, dtype):
    q, k, v, do = _qkvdo(S, D, dtype)
    o, lse = tfa.flash_attention_fwd_plain(q, k, v)
    delta = (do.float() * o.float()).sum(-1)
    grads = tfa.flash_attention_bwd_plain(q, k, v, do, lse, delta)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    autograd = torch.autograd.grad(tfa.flash_attention_fwd_plain(*leaves)[0], leaves, do)
    for g, ref_jax, ref_torch in zip(grads, _jax_pallas(S, D, dtype)[1:], autograd):
        assert g.dtype == q.dtype and g.shape == q.shape
        scale = max(1.0, np.abs(ref_jax).max())
        assert np.abs(g.float().numpy() - ref_jax).max() <= BWD_TOL_OF_MAX_PALLAS[dtype] * scale
        err = (g.float() - ref_torch.float()).abs().max().item()
        assert err <= BWD_TOL_OF_MAX_AUTOGRAD[dtype] * scale


def test_cpu_backward_goes_through_the_function():
    q, k, v, do = (t.requires_grad_() for t in _qkvdo(37, 16, "float32"))
    before = (tfa.launches, tfa.dq_launches, tfa.dkv_launches)
    o = tfa.causal_flash_attention(q, k, v)
    assert type(o.grad_fn).__name__ == "FlashAttentionBackward"
    (o * do).sum().backward()
    _, lse = tfa.flash_attention_fwd_plain(q, k, v)
    delta = (do.float() * o.float()).sum(-1)
    expected = tfa.flash_attention_bwd_plain(q, k, v, do, lse.detach(), delta.detach())
    for t, e in zip((q, k, v), expected):
        assert torch.equal(t.grad, e)
    assert (tfa.launches, tfa.dq_launches, tfa.dkv_launches) == before


def test_bwd_wrappers_take_the_plain_version_on_cpu():
    q, k, v, do = _qkvdo(37, 64, "bfloat16")
    o, lse = tfa.flash_attention_fwd_plain(q, k, v)
    delta = (do.float() * o.float()).sum(-1)
    args = (q, k, v, do, lse, delta)
    dq, dk, dv = tfa.flash_attention_bwd_plain(*args)
    bwd = tfa.flash_attention_bwd(*args, *tfa.BF16_BLOCKS)
    assert all(torch.equal(a, b) for a, b in zip(bwd, (dq, dk, dv)))
    assert torch.equal(tfa.flash_attention_dq(*args), dq)
    assert all(torch.equal(a, b) for a, b in zip(tfa.flash_attention_dkv(*args), (dk, dv)))
    with pytest.raises(ValueError, match="do must match"):
        tfa.flash_attention_bwd(q, k, v, do.float(), lse, delta)
    with pytest.raises(ValueError, match="lse must be float32"):
        tfa.flash_attention_bwd(q, k, v, do, lse.bfloat16(), delta)
    with pytest.raises(ValueError, match="delta must be float32"):
        tfa.flash_attention_dq(q, k, v, do, lse, delta[:, :, 1:])
    meta = [t.to("meta") for t in args]
    with pytest.raises(ValueError, match="no kernel"):
        tfa.flash_attention_dkv(*meta)


# (dtype, blocks) pairs the forward takes: the bf16 forward's one tile
# (query rows per block, keys per TMA tile) and the float32 CUDA-core
# kernel's (rows per block, keys per shared-memory tile); (0, 0) is each
# one's default.
@pytest.mark.parametrize(
    "dtype,blocks",
    [("bfloat16", (0, 0)), ("bfloat16", (64, 64)), ("float32", (0, 0)),
     ("float32", (4, 64)), ("float32", (16, 32)), ("float32", (8, 64))],
)
def test_cpu_tensor_takes_plain_version(dtype, blocks):
    q, k, v = _qkv(0, 2, 3, 37, 64, dtype)
    before = tfa.launches
    o = tfa.causal_flash_attention(q, k, v)
    o2, lse2 = tfa.flash_attention_fwd(q, k, v, *blocks)
    o_plain, lse = tfa.flash_attention_fwd_plain(q, k, v)
    assert torch.equal(o, o_plain) and torch.equal(o2, o_plain) and torch.equal(lse2, lse)
    assert tfa.launches == before  # the plain version is no launch


# Pairs the forward of that dtype does not take, CPU tensors as on the card;
# the bf16 forward has the one tile (64, 64).
@pytest.mark.parametrize(
    "dtype,blocks",
    [("float32", (2, 32)), ("float32", (8, 16)), ("float32", (32, 64)), ("float32", (8, 128)),
     ("float32", (64, 64)), ("bfloat16", (32, 64)), ("bfloat16", (64, 32)),
     ("bfloat16", (256, 128)), ("bfloat16", (64, 128)), ("bfloat16", (128, 64)),
     ("bfloat16", (128, 128))],
)
def test_unsupported_blocks_raise(dtype, blocks):
    q, k, v = _qkv(0, 1, 1, 8, 64, dtype)
    with pytest.raises(ValueError, match="block_q"):
        tfa.flash_attention_fwd(q, k, v, *blocks)


def test_backward_blocks_raise_with_the_forward_kernels_name():
    """The float32 CUDA-core pair (8, 32) is no pair for any bf16 kernel,
    and the bf16 kernels' one tile (64, 64) none for the float32 backward:
    each raises naming the kernel that refuses it, before anything runs;
    (64, 64) runs every bf16 kernel."""
    q, k, v = _qkv(0, 1, 2, 8, 64, "bfloat16")
    with pytest.raises(ValueError, match="flash_fwd in torch.bfloat16"):
        tfa.flash_attention_fwd(q, k, v, 8, 32)
    with pytest.raises(ValueError, match="flash_fwd in torch.bfloat16"):
        tfa.flash_attention_fwd(q, k, v, 8, 0)
    o, lse = tfa.flash_attention_fwd(q, k, v, 64, 64)
    do = torch.ones_like(o)
    delta = (do.float() * o.float()).sum(-1)
    args = (q, k, v, do, lse, delta)
    for a, b in zip(tfa.flash_attention_bwd(*args, 64, 64), tfa.flash_attention_bwd_plain(*args)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="flash_dq in torch.bfloat16"):
        tfa.flash_attention_bwd(*args, 8, 32)
    with pytest.raises(ValueError, match="flash_dkv in torch.bfloat16"):
        tfa.flash_attention_dkv(*args, 8, 32)
    f32 = [t.float() for t in (q, k, v, do)] + [lse, delta]
    with pytest.raises(ValueError, match="flash_dq in torch.float32"):
        tfa.flash_attention_bwd(*f32, 64, 64)


# Every float32 CUDA-core pair and the bf16 tile's neighbours: none is the
# bf16 backward kernels' one tile, so each raises naming the kernel, before
# anything runs.
@pytest.mark.parametrize("kernel", ["flash_dq", "flash_dkv"])
@pytest.mark.parametrize(
    "blocks",
    [(4, 32), (4, 64), (8, 32), (8, 64), (16, 32), (16, 64), (64, 32), (32, 64), (128, 64),
     (64, 128), (128, 128)],
)
def test_bf16_backward_takes_only_its_tile(kernel, blocks):
    q, k, v, do = _qkvdo(37, 64, "bfloat16")
    o, lse = tfa.flash_attention_fwd_plain(q, k, v)
    delta = (do.float() * o.float()).sum(-1)
    wrapper = getattr(tfa, kernel.replace("flash_", "flash_attention_"))
    with pytest.raises(ValueError, match=f"{kernel} in torch.bfloat16 takes block_q in \\(64,\\)"):
        wrapper(q, k, v, do, lse, delta, *blocks)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_default_blocks_run_forward_and_backward(dtype):
    """The model's call runs each kernel at its own default, for both
    dtypes; (0, 0) asks a wrapper for the same."""
    q, k, v, do = _qkvdo(37, 64, dtype)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o = tfa.causal_flash_attention(*leaves)
    assert torch.equal(tfa.flash_attention_fwd(q, k, v, 0, 0)[0], o.detach())
    grads = torch.autograd.grad(o, leaves, do)
    o_plain, lse = tfa.flash_attention_fwd_plain(q, k, v)
    delta = (do.float() * o_plain.float()).sum(-1)
    assert torch.equal(o.detach(), o_plain)
    for g, ref in zip(grads, tfa.flash_attention_bwd_plain(q, k, v, do, lse, delta)):
        assert torch.equal(g, ref)


def test_mismatched_inputs_raise():
    q, k, v = _qkv(0, 1, 2, 8, 64, "float32")
    with pytest.raises(ValueError, match="shape"):
        tfa.causal_flash_attention(q, k[:, :, :4], v)
    with pytest.raises(ValueError, match="dtypes"):
        tfa.causal_flash_attention(q, k.bfloat16(), v)


def test_other_device_raises_without_fallback():
    q = torch.empty(1, 1, 8, 64, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tfa.causal_flash_attention(q, q, q)


def test_causality_of_plain_version():
    q, k, v = _qkv(3, 1, 2, 20, 16, "float32")
    o = tfa.causal_flash_attention(q, k, v)
    k2, v2 = k.clone(), v.clone()
    k2[:, :, 12:] += 1.0
    v2[:, :, 12:] -= 1.0
    o2 = tfa.causal_flash_attention(q, k2, v2)
    assert torch.equal(o[:, :, :12], o2[:, :, :12])
    assert not torch.allclose(o[:, :, 12:], o2[:, :, 12:])


def test_module_imports_and_runs_without_nvcc(tmp_path):
    env = dict(os.environ, PATH=str(tmp_path), CUDA_HOME=str(tmp_path / "none"))
    code = (
        "import torch\n"
        "from mmtrl_tpu_torch.ops import _build, flash_attention as f\n"
        "q = torch.randn(1, 2, 5, 64)\n"
        "assert f.causal_flash_attention(q, q, q).shape == q.shape\n"
        "try:\n"
        "    _build.nvcc_path()\n"
        "except RuntimeError as e:\n"
        "    assert 'nvcc not found' in str(e)\n"
        "else:\n"
        "    raise SystemExit('found an nvcc')\n"
        "print('ok')\n"
    )
    r = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=120,
    )
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def test_library_path_is_keyed_on_sources_and_ignored_by_git():
    p = _build.library_path("flash_fwd")
    assert p.parent == _build.BUILD_DIR and p.name.startswith("flash_fwd-")
    assert p == _build.library_path("flash_fwd")
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    ignored = (REPO / ".gitignore").read_text().splitlines()
    assert str(_build.BUILD_DIR.relative_to(REPO)) + "/" in ignored

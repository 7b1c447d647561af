"""Parity of the port's causal attention (mmtrl_tpu_torch/ops/flash_attention.py)
with the JAX reference, on the CPU; the kernel itself is compared on the
card (tests/test_torch_cuda.py and chip_smoke.py)."""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmtrl_tpu.ops import flash_attention as jfa
from mmtrl_tpu_torch.ops import _build
from mmtrl_tpu_torch.ops import flash_attention as tfa

REPO = Path(__file__).resolve().parent.parent
# bf16 inputs: a bf16 output is within one rounding (2^-8 relative) of the
# float32 result, and the JAX reference also rounds its probabilities to
# bf16 before the PV product; f32: summation order only.
ATOL = {"float32": 1e-5, "bfloat16": 2e-2}


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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [16, 64])
@pytest.mark.parametrize("S", [1, 37, 90])
def test_port_matches_jax_reference(S, D, dtype):
    q, k, v = _qkv(S * 100 + D, 2, 2, S, D, dtype)
    to_jax = lambda t: jnp.asarray(t.float().numpy(), dtype=dtype)  # noqa: E731
    o_jax = np.asarray(jfa.mha_reference(to_jax(q), to_jax(k), to_jax(v))).astype(np.float32)

    o_ref = tfa.mha_reference(q, k, v)
    o_plain, lse = tfa.flash_attention_fwd_plain(q, k, v)
    assert o_ref.dtype == o_plain.dtype == q.dtype and lse.dtype == torch.float32
    assert lse.shape == (2, 2, S)
    np.testing.assert_allclose(o_ref.float().numpy(), o_jax, atol=ATOL[dtype], rtol=0)
    np.testing.assert_allclose(o_plain.float().numpy(), o_jax, atol=ATOL[dtype], rtol=0)
    np.testing.assert_allclose(lse.numpy(), _lse64(q, k), atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("blocks", [(0, 0), (4, 64), (16, 32)])
def test_cpu_tensor_takes_plain_version(blocks):
    q, k, v = _qkv(0, 2, 3, 37, 64, "bfloat16")
    before = tfa.launches
    o = tfa.causal_flash_attention(q, k, v, *blocks)
    o2, lse2 = tfa.flash_attention_fwd(q, k, v, *blocks)
    o_plain, lse = tfa.flash_attention_fwd_plain(q, k, v)
    assert torch.equal(o, o_plain) and torch.equal(o2, o_plain) and torch.equal(lse2, lse)
    assert tfa.launches == before  # the plain version is no launch


@pytest.mark.parametrize("blocks", [(2, 32), (8, 16), (32, 64), (8, 128)])
def test_unsupported_blocks_raise(blocks):
    q, k, v = _qkv(0, 1, 1, 8, 64, "float32")
    with pytest.raises(ValueError, match="block_q"):
        tfa.causal_flash_attention(q, k, v, *blocks)


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

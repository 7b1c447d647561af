"""Card-only tests of the port's CUDA kernels against their plain versions.

They import no JAX, so they also run where only PyTorch is installed:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Without a GPU each test skips: a CUDA kernel has no CPU mode.
"""

import pytest
import torch

from mmtrl_tpu_torch.ops import flash_attention as fa


def _qkv(shape, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(shape, generator=g, device="cuda").to(dtype) for _ in range(3)]


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

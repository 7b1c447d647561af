"""Sequence-parallel ring attention (the ``seq`` axis); port of
``mmtrl_tpu/parallel/ring_attention.py``.

For contexts too long for one card, the sequence shards over a mesh axis:
each rank holds a (B, H, S/n, D) chunk of Q, K and V.  The K/V chunks
rotate around the ring with ``ppermute`` (``parallel/collectives.py``), and
each rank accumulates its queries' attention over every chunk with the
streaming-softmax statistics (running max ``m``, normalizer ``l``, weighted
sum ``o``), so no rank forms the (S, S) score matrix: O(S/n * S) time and
O(S/n) memory a rank.

Plain tensor code, as JAX's is (its ring runs no Pallas kernel), in
float32 with JAX's finite -1e30 mask, its global positions
``my * C + arange(C)`` and its final ``o / max(l, 1e-30)``.  The backward
is autograd's: the ``ppermute`` of each rotation sends its gradient back
one rank, the reverse rotation that ``jax.grad`` derives through JAX's
scan.  JAX rotates once more after the last chunk and drops the result;
the port skips that rotation.
"""

from __future__ import annotations

from typing import Optional

import torch

from mmtrl_tpu_torch.parallel.collectives import ppermute
from mmtrl_tpu_torch.parallel.mesh import Mesh

NEG_BIG = -1e30  # finite "-inf": keeps fully-masked rows NaN-free


def ring_attention(
    q: torch.Tensor,  # (B, H, C, D): this rank's query chunk
    k: torch.Tensor,  # (B, H, C, D)
    v: torch.Tensor,  # (B, H, C, D)
    mesh: Mesh,
    axis_name: str = "seq",
    causal: bool = False,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Attention of this rank's chunk of a sequence sharded contiguously
    over ``axis_name``: rank i holds positions [i C, (i + 1) C).  Returns the
    (B, H, C, D) output chunk in ``q``'s dtype.  JAX's ``ring_attention``
    takes the global arrays and shards them itself; here each rank passes
    its own chunk."""
    B, H, C, D = q.shape
    n, my = mesh.size(axis_name), mesh.index(axis_name)
    s = scale if scale is not None else 1.0 / (D ** 0.5)
    qf = (q * s).float()
    q_pos = my * C + torch.arange(C, device=q.device)  # global positions of my queries
    m = torch.full((B, H, C), NEG_BIG, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, C), dtype=torch.float32, device=q.device)
    o = torch.zeros((B, H, C, D), dtype=torch.float32, device=q.device)
    kv = torch.stack([k, v])
    for j in range(n):
        k_c, v_c = kv[0].float(), kv[1].float()
        scores = torch.einsum("bhqd,bhkd->bhqk", qf, k_c)
        if causal:
            src = (my - j) % n  # whose chunk I hold at step j
            k_pos = src * C + torch.arange(C, device=q.device)
            mask = q_pos[:, None] >= k_pos[None, :]
            scores = torch.where(mask, scores, NEG_BIG)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(scores - m_new[..., None])
        l = l * corr + p.sum(dim=-1)
        o = o * corr[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, v_c)
        m = m_new
        if j + 1 < n:  # rotate K/V to the next rank
            kv = ppermute(kv, mesh, axis_name)
    return (o / l.clamp(min=1e-30)[..., None]).to(q.dtype)

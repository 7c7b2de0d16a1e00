"""Sequence (context) parallelism — the port of
``paddlebox_tpu/parallel/sequence.py`` (``attention_reference`` :31,
``ring_attention`` :45, ``ulysses_attention`` :116,
``make_sequence_parallel_attention`` :144).

The sequence dimension is sharded over a mesh axis; each rank holds its
contiguous shard ``(B, S_local, H, D)`` of q, k and v:

- ``ring_attention`` — the K/V blocks travel around the ring (one
  differentiable ``ppermute`` of the stacked pair a hop, n - 1 hops)
  while each rank keeps its Q shard; the softmax accumulates online (a
  running max and denominator), so a rank holds (S_local, S_local)
  scores at a time. The causal mask uses global positions. The scores
  and the (o, m, l) state accumulate in f32 or wider (bf16 inputs are
  upcast before the products; f64 stays f64), and the result is cast
  back to the input dtype.
- ``ulysses_attention`` — two all-to-alls re-shard from sequence- to
  head-parallel (``(B, S, H / n, D)``), full attention runs per head
  group, and the result shards back. It raises when the heads do not
  divide by the axis size.

Both equal ``attention_reference`` over the global sequence, causal
masking and gradients included. The products are plain
``torch.einsum`` (the reference computes them outside any Pallas
kernel).
"""

from __future__ import annotations

import math

import torch

from paddlebox_tpu_torch.parallel import collective_ops as cops
from paddlebox_tpu_torch.parallel.mesh import Mesh


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False) -> torch.Tensor:
    """Plain full attention. Shapes: (B, S, H, D) -> (B, S, H, D)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        S_q, S_k = s.shape[-2], s.shape[-1]
        mask = (torch.arange(S_k, device=s.device)[None, :]
                > torch.arange(S_q, device=s.device)[:, None])
        s = s.masked_fill(mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh: Mesh, axis: str,
                   causal: bool = False) -> torch.Tensor:
    """This rank's (B, S_local, H, D) shard of full attention over the
    global sequence, sharded over ``axis`` in rank order."""
    n = mesh.axis_size(axis)
    my = mesh.axis_index(axis)
    B, S_l, H, Dh = q.shape
    scale = 1.0 / math.sqrt(Dh)
    in_dtype = q.dtype
    acc = torch.promote_types(in_dtype, torch.float32)
    dev = q.device
    qf = q.to(acc)
    q_pos = my * S_l + torch.arange(S_l, device=dev)  # global positions
    neg = float("-inf")

    def accumulate(o, m, l, kb, vb, i):
        # kb came from rank (my - i) mod n
        src = (my - i) % n
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kb.to(acc)) * scale
        mask = None
        if causal:
            k_pos = src * S_l + torch.arange(S_l, device=dev)
            mask = k_pos[None, :] > q_pos[:, None]          # (S_l, S_l)
            s = s.masked_fill(mask, neg)
        m_new = torch.maximum(m, s.amax(dim=-1))
        # fully masked rows keep m = -inf; guard the exp shift
        shift = torch.where(torch.isneginf(m_new),
                            torch.zeros_like(m_new), m_new)
        p = torch.exp(s - shift[..., None])
        if causal:
            p = p.masked_fill(mask, 0.0)
        m_old = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
        corr = torch.where(torch.isneginf(m), torch.zeros_like(m),
                           torch.exp(m_old - shift))
        l_new = l * corr + p.sum(dim=-1)
        o_new = (o * corr[..., None]
                 + torch.einsum("bhqk,bkhd->bhqd", p, vb.to(acc)))
        return o_new, m_new, l_new

    o = torch.zeros((B, H, S_l, Dh), dtype=acc, device=dev)
    m = torch.full((B, H, S_l), neg, dtype=acc, device=dev)
    l = torch.zeros((B, H, S_l), dtype=acc, device=dev)
    kv = torch.stack([k, v])
    # n - 1 hops; the block held last is consumed without another hop
    for i in range(n - 1):
        o, m, l = accumulate(o, m, l, kv[0], kv[1], i)
        kv = cops.ppermute(kv, mesh, axis, 1)
    o, m, l = accumulate(o, m, l, kv[0], kv[1], n - 1)
    denom = torch.where(l == 0.0, torch.ones_like(l), l)
    out = (o / denom[..., None]).to(in_dtype)
    return out.transpose(1, 2)  # (B, H, S_l, D) -> (B, S_l, H, D)


def _to_heads(x, mesh, axis, n):
    """(B, S_l, H, D) sequence shards → (B, S, H / n, D) head groups."""
    B, S_l, H, D = x.shape
    x = x.reshape(B, S_l, n, H // n, D).permute(2, 0, 1, 3, 4)
    x = cops.all_to_all(x.contiguous(), mesh, axis)   # dim 0: source rank
    return x.permute(1, 0, 2, 3, 4).reshape(B, n * S_l, H // n, D)


def _to_seq(x, mesh, axis, n):
    """(B, S, H / n, D) head groups → (B, S_l, H, D) sequence shards."""
    B, S, Hl, D = x.shape
    x = x.reshape(B, n, S // n, Hl, D).permute(1, 0, 2, 3, 4)
    x = cops.all_to_all(x.contiguous(), mesh, axis)   # dim 0: head group
    return x.permute(1, 2, 0, 3, 4).reshape(B, S // n, n * Hl, D)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mesh: Mesh, axis: str,
                      causal: bool = False) -> torch.Tensor:
    """Ulysses (all-to-all) attention: this rank's (B, S_local, H, D)
    shard of full attention. Requires H % axis size == 0."""
    n = mesh.axis_size(axis)
    H = q.shape[2]
    if H % n:
        raise ValueError(f"heads {H} not divisible by axis size {n}")
    qh, kh, vh = (_to_heads(t, mesh, axis, n) for t in (q, k, v))
    out = attention_reference(qh, kh, vh, causal=causal)
    return _to_seq(out, mesh, axis, n)


def make_sequence_parallel_attention(mesh: Mesh, axis_name: str,
                                     mode: str = "ring",
                                     causal: bool = False):
    """→ ``fn(q, k, v)`` over this rank's sequence shards (B, S_local,
    H, D) of the global (B, S, H, D) arrays, the shards in rank order
    along ``axis_name``; returns this rank's shard of the output — a
    drop-in for full attention whose sequence stopped fitting one card."""
    inner = {"ring": ring_attention, "ulysses": ulysses_attention}[mode]
    mesh.axis_size(axis_name)                # a named axis of this mesh

    def fn(q, k, v):
        return inner(q, k, v, mesh, axis_name, causal=causal)

    return fn


def seq_shard(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """This rank's contiguous shard of a global (B, S, ...) array along
    the sequence dim."""
    n = mesh.axis_size(axis)
    if x.shape[1] % n:
        raise ValueError(f"sequence {x.shape[1]} does not divide by the "
                         f"axis size {n}")
    s = x.shape[1] // n
    i = mesh.axis_index(axis)
    return x[:, i * s:(i + 1) * s]

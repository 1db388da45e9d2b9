"""Ring attention: context-parallel attention over the mesh's `context`
axis, counterpart of `polyaxon_tpu/parallel/ring.py`.

Each rank holds one sequence chunk of Q/K/V. n - 1 `ppermute` hops rotate
the K/V chunks around the ring, and each hop's attention is merged into
the running result, so the [S, S] score matrix never exists anywhere:

- `_ring_body_flash`: each hop is `flash_hop`, the flash kernel's
  `flash_attention_lse` (causal on the rank's own chunk, non-causal on the
  others) merged by logsumexp. Under causality a chunk from a later rank
  contributes nothing: its lse is masked to -inf, zeroing its merge
  weight, and the kernel runs on it all the same, as in the reference;
- `_ring_body`: the einsum body (`_chunk_attention` plus the online-softmax
  merge), for chunks the kernel's blocks do not fit.

The backward is the reverse ring: autograd runs each hop's backward
kernels, and `collectives.ppermute`'s backward sends the K/V cotangents
back the way the chunks came.

`ring_attention` takes either this rank's local chunks (plain tensors, as
the model's forward holds them: batch over the batch axes, sequence over
`context`, heads over `model` when the mesh has one) or DTensors on the
mesh, whose placements say the same thing; the output matches its input.
With DTensors, k/v replicated over `model` while q's heads are split over
it is the reference's GQA expansion under head TP (KV not dividing the
model axis): the kv heads are expanded to the query heads and each rank
keeps its own.
"""

from __future__ import annotations

import threading
from typing import Optional

import torch

from .collectives import axis_group, axis_index, ppermute

NEG_INF = -1e30

# the mesh model-internal collectives read (ring attention, the tensor
# parallel blocks, constrain); the trainer binds it. Thread-local, as in
# the reference
_MESH_STATE = threading.local()


def set_current_mesh(mesh) -> None:
    _MESH_STATE.mesh = mesh


def current_mesh():
    return getattr(_MESH_STATE, "mesh", None)


def model_group(local: int, full: int):
    """The bound mesh's `model` group when this rank holds `local` of a
    `full`-wide projection (a tensor-parallel slice), else None."""
    if local == full:
        return None
    group = axis_group(current_mesh(), "model")
    if group is None:
        raise ValueError(
            f"a {local}-wide slice of a {full}-wide projection needs a bound "
            "mesh with a model axis (parallel.ring.set_current_mesh)"
        )
    return group


def _chunk_attention(q, k, v, scale: float, full: bool, same: bool):
    """One KV chunk's contribution: (o unnormalized [B,S,H,D] f32, m, l
    [B,H,S,1]). `full`: every key is visible; `same`: the rank's own chunk
    (lower-triangular). Masked entries get probability 0 through the
    `allowed` mask, never a -inf softmax. GQA scores against the true kv
    heads, head h = kv * G + g."""
    B, S_q, H, D = q.shape
    S_k, KV = k.shape[1], k.shape[2]
    G = H // KV
    s = torch.einsum(
        "bqkgd,bskd->bkgqs", q.reshape(B, S_q, KV, G, D).float(), k.float()
    ).reshape(B, H, S_q, S_k) * scale
    tril = torch.ones(S_q, S_k, dtype=torch.bool, device=q.device).tril()
    allowed = tril if (same and not full) else torch.full_like(tril, full)
    s = s.masked_fill(~allowed, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(allowed, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum(
        "bkgqs,bskd->bqkgd",
        p.reshape(B, KV, G, S_q, S_k).to(v.dtype).float(),
        v.float(),
    ).reshape(B, S_q, H, D).to(v.dtype)  # P.V in v's dtype, as the reference's einsum
    return o, m, l


def _ring_body(q, k, v, *, group, n: int, idx: int, scale: float, causal: bool):
    B, S, H, D = q.shape
    o = torch.zeros((B, S, H, D), dtype=torch.float32, device=q.device)
    m = torch.full((B, H, S, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, S, 1), dtype=torch.float32, device=q.device)
    for t in range(n):
        src = (idx - t) % n
        full, same = (src < idx, src == idx) if causal else (True, False)
        o_i, m_i, l_i = _chunk_attention(q, k, v, scale, full=full, same=same)
        m_new = torch.maximum(m, m_i)
        alpha = torch.exp(m - m_new)  # rescale of the running accumulator
        beta = torch.exp(m_i - m_new)  # rescale of this chunk
        l = alpha * l + beta * l_i
        o = o * alpha.transpose(1, 2) + o_i * beta.transpose(1, 2)
        m = m_new
        if t != n - 1:  # rotate KV to the next rank; the last hop sends nothing
            k, v = ppermute((k, v), group)
    return (o / l.transpose(1, 2).clamp_min(1e-30)).to(q.dtype)


def flash_hop(q, k, v, o=None, lse=None, *, scale: float, causal: bool, keep: bool = True):
    """One ring hop: `flash_attention_lse` of q against the chunk (k, v),
    merged into the running (o [B,S,H,D] f32, lse [B,H,S,1]) by logaddexp:
    lse' = logaddexp(lse, lse_i), o' = o exp(lse - lse') + o_i exp(lse_i -
    lse'). `keep=False` (a chunk from a later rank under causality) masks
    the hop's lse to -inf: its merge weight is 0 and its kernels still run.
    With o=None it starts the merge. Returns (o, lse)."""
    from ..ops.flash_attention import flash_attention_lse

    o_i, lse_i = flash_attention_lse(q, k, v, causal=causal, sm_scale=scale)
    lse_i = lse_i[..., None]
    if not keep:
        lse_i = torch.full_like(lse_i, NEG_INF)
    if o is None:
        return o_i.float(), lse_i
    lse_new = torch.logaddexp(lse, lse_i)
    w = torch.exp(lse - lse_new).transpose(1, 2)  # [B,S,H,1]
    w_i = torch.exp(lse_i - lse_new).transpose(1, 2)
    return o * w + o_i.float() * w_i, lse_new


def _ring_body_flash(q, k, v, *, group, n: int, idx: int, scale: float, causal: bool):
    """The flash kernel inside each hop: O(S_local) memory per hop where
    the einsum body holds a [B,H,S_local,S_local] f32 score matrix."""
    o, lse = flash_hop(q, k, v, scale=scale, causal=causal)
    for t in range(1, n):
        k, v = ppermute((k, v), group)
        src = (idx - t) % n
        o, lse = flash_hop(q, k, v, o, lse, scale=scale, causal=False,
                           keep=not causal or src < idx)
    return o.to(q.dtype)


def use_flash_body(s_local: int, head_dim: int) -> bool:
    """The reference's gate (the chunk fits the kernel's blocks, head_dim a
    multiple of 64 up to 256) and the Hopper kernel's head dims."""
    from ..ops.flash_attention import SUPPORTED_HEAD_DIMS, flash_shapes_ok

    return (flash_shapes_ok(s_local) and head_dim % 64 == 0 and head_dim <= 256
            and head_dim in SUPPORTED_HEAD_DIMS)


def _ring_local(q, k, v, *, mesh, axis_name: str, block_kv: int, causal: bool):
    """ring_attention on this rank's local chunks."""
    group = axis_group(mesh, axis_name)
    if group is None:
        # no context axis: the flash dispatch on the rank's batch and heads
        from ..ops.attention import local_attention

        return local_attention(q, k, v, causal=causal, backend="flash",
                                     block_kv=block_kv)
    n = mesh.size(mesh.mesh_dim_names.index(axis_name))
    body = _ring_body_flash if use_flash_body(q.shape[1], q.shape[-1]) else _ring_body
    return body(q, k, v, group=group, n=n, idx=axis_index(mesh, axis_name),
                scale=q.shape[-1] ** -0.5, causal=causal)


def dtensor_local_views(q, k, v, axis_name: str):
    """DTensor q/k/v → (mesh, q, k, v local, q's placements, whether the
    sequence divides the `axis_name` axis). k/v replicated over `model`
    while q's heads are split over it are expanded to the query heads,
    each rank keeping its own; their cotangents are then partial sums over
    `model`."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = q.device_mesh
    names = list(mesh.mesh_dim_names)
    if tuple(k.placements) != tuple(v.placements):
        raise ValueError("k and v must have the same placements")
    m = names.index("model") if "model" in names else None
    for d, (pq, pk) in enumerate(zip(q.placements, k.placements)):
        if d != m and pq != pk:
            raise ValueError(
                f"k/v placements {tuple(k.placements)} differ from q's "
                f"{tuple(q.placements)} outside the model axis"
            )
    expand = (m is not None and q.placements[m] == Shard(2)
              and k.placements[m] == Replicate() and k.shape[2] != q.shape[2])
    kv_grad = list(k.placements)
    if expand:
        kv_grad[m] = Partial()
    ql = q.to_local()
    kl, vl = (t.to_local(grad_placements=kv_grad) for t in (k, v))
    if expand:
        H, KV = q.shape[2], k.shape[2]
        lo = mesh.get_local_rank("model") * ql.shape[2]
        kl, vl = (t.repeat_interleave(H // KV, dim=2)[:, :, lo:lo + ql.shape[2]]
                  for t in (kl, vl))
    n = mesh.size(names.index(axis_name)) if axis_name in names else 1
    return mesh, ql, kl, vl, tuple(q.placements), q.shape[1] % n == 0


def _seq_gathered(q, axis_name):
    """q's placements with the sequence no longer split over `axis_name`."""
    from torch.distributed.tensor import Replicate

    names = list(q.device_mesh.mesh_dim_names)
    pl = list(q.placements)
    if axis_name in names:
        pl[names.index(axis_name)] = Replicate()
    return pl


def with_dtensors(local_fn, q, k, v, *, axis_name: str, causal: bool):
    """Run `local_fn(mesh, q, k, v)` on DTensors' local views and wrap the
    result with q's placements. A sequence that does not divide the axis
    runs the einsum attention on the sequence gathered over it (the
    reference's fallback), then is split again."""
    from torch.distributed.tensor import DTensor

    if not q.shape[1] % max(1, _axis_size(q.device_mesh, axis_name)) == 0:
        from ..ops.attention import local_attention

        gathered = [t.redistribute(q.device_mesh, _seq_gathered(t, axis_name))
                    for t in (q, k, v)]
        mesh, ql, kl, vl, pl, _ = dtensor_local_views(*gathered, axis_name)
        o = local_attention(ql, kl, vl, causal=causal, backend="xla")
        out = DTensor.from_local(o, mesh, list(pl), run_check=False)
        return out.redistribute(mesh, list(q.placements))
    mesh, ql, kl, vl, pl, _ = dtensor_local_views(q, k, v, axis_name)
    o = local_fn(mesh, ql, kl, vl)
    return DTensor.from_local(o, mesh, list(pl), run_check=False)


def _axis_size(mesh, axis: str) -> int:
    names = list(mesh.mesh_dim_names)
    return mesh.size(names.index(axis)) if axis in names else 1


def ring_attention(q, k, v, *, axis_name: str = "context", block_kv: int = 512,
                   causal: bool = True, mesh=None):
    """Attention with Q/K/V sequence-sharded over `axis_name`.

    q [B, S, H, D], k/v [B, S, KV, D] with KV dividing H: pass GQA kv
    unexpanded, so the rotating chunks travel at kv-head width. Local
    chunks (plain tensors) use `mesh` or the bound mesh; DTensors carry
    their own. Without a (non-trivial) context axis this is the flash
    dispatch on the rank's batch and heads, so models can use `attention:
    ring` unconditionally."""
    from torch.distributed.tensor import DTensor

    def local(mesh_, ql, kl, vl):
        return _ring_local(ql, kl, vl, mesh=mesh_, axis_name=axis_name,
                           block_kv=block_kv, causal=causal)

    if isinstance(q, DTensor):
        return with_dtensors(local, q, k, v, axis_name=axis_name, causal=causal)
    return local(mesh if mesh is not None else current_mesh(), q, k, v)

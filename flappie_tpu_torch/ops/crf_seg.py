"""Segmented (two-level) CRF scans (counterpart of
flappie_tpu/ops/crf_seg.py, ``FLAPPIE_TPU_CRF_IMPL=seg``).

Both semirings of the decode are associative -- (+, logsumexp) for the
forward and backward passes, (+, max) for Viterbi -- and so is the
composition of the traceback's maps [S] -> [S], so every prefix state
vector comes from a two-level scan: split time into G groups of L steps,
(A) scan the group-local prefix *matrix* products over all groups at
once (L serial steps on [B, S, S, G] operands), (B) combine the G
group-final matrices serially (G steps on [B, S]), and (C) recover every
step's state with one parallel vector x prefix-matrix product.  Serial
depth drops from T to L + T/L.

Plain torch on any device, as the JAX module is plain ``lax.scan`` and
``jnp`` (it holds no Pallas kernel).  The grouping (``SEG_L``), the
group axis kept minor, the association order and the tie rule are the
JAX module's, so this lands on JAX's ``seg``, not only near the
sequential scans.  Sums are in index order (a cumulative sum's last
entry) with the maximum replaced by 0 where it is not finite, as
``jax.scipy.special.logsumexp`` does.

Invalid steps get the semiring identity (0 diagonal, NEG_BIG elsewhere),
which freezes the running state as the sequential masks do.  The matrix
prefix products reassociate the f32 sums, so the sum semiring is not
bit-equal to the sequential scans (about 1e-6 relative a level); max-plus
values are exact on dyadic inputs, and backpointers come from the alpha
vectors by the sequential step's tie_rank argmin, so tie order is the
same.

Reference semantics: src/decode.c:119-204 (Viterbi), :377-498
(forward/backward transition posterior), src/layers.c:1035 (partition).
"""

from __future__ import annotations

import torch

NEG_BIG = -3.0e38

# Group length: serial depth of phase A.  T=2560 blocks -> G=20 groups.
SEG_L = 128


def _lse(x, dim: int):
    """logsumexp along ``dim``: the maximum (0 where it is not finite) plus
    the log of the exponentials' sum in index order."""
    mx = x.amax(dim=dim, keepdim=True)
    mx = torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx))
    s = torch.cumsum(torch.exp(x - mx), dim=dim).narrow(dim, -1, 1)
    return (torch.log(s) + mx).squeeze(dim)


def _identity_mat(S: int, like):
    eye = torch.eye(S, dtype=torch.bool, device=like.device)
    return torch.where(eye, torch.zeros((), dtype=like.dtype, device=like.device),
                       torch.full((), NEG_BIG, dtype=like.dtype, device=like.device))


def _masked_dense(dense, nblocks):
    """dense [B, T, S, S] with each read's steps past ``nblocks`` [B]
    replaced by the semiring identity (the same for both semirings)."""
    B, T, S, _ = dense.shape
    valid = torch.arange(T, device=dense.device)[None, :] < nblocks.to(dense.device)[:, None]
    return torch.where(valid[..., None, None], dense, _identity_mat(S, dense))


# -- semiring ops in the group-minor layout [..., S, S, G] / [..., S, G] -------


def _mm_lse(a, b):
    # out[..., i, j, g] = lse_k a[..., i, k, g] + b[..., k, j, g]
    return _lse(a[..., :, :, None, :] + b[..., None, :, :, :], -3)


def _vm_lse(v, m):
    # out[..., j, g] = lse_k v[..., k, g] + m[..., k, j, g]
    return _lse(v[..., :, None, :] + m, -3)


def _mm_max(a, b):
    return (a[..., :, :, None, :] + b[..., None, :, :, :]).amax(dim=-3)


def _vm_max(v, m):
    return (v[..., :, None, :] + m).amax(dim=-3)


def _vv_lse(v, m):
    # v: [B, S], m: [B, S, S] -> [B, S]
    return _lse(v[:, :, None] + m, 1)


def _vv_max(v, m):
    return (v[:, :, None] + m).amax(dim=1)


def _prefix_vectors(dense_masked, v0, mm, vm, vv, L: int = SEG_L):
    """Every prefix state vector of an associative semiring scan:
    dense_masked [B, T, S, S] (identity at invalid steps), v0 [B, S] ->
    states [B, T, S], states[:, t] the vector after steps 0..t.  ``mm`` /
    ``vm`` are the semiring's matrix and vector products in the
    group-minor layout, ``vv`` its vector product on [B, S] x [B, S, S]."""
    B, T, S, _ = dense_masked.shape
    G = -(-T // L)
    Tp = G * L
    if Tp != T:
        pad = _identity_mat(S, dense_masked).expand(B, Tp - T, S, S)
        dense_masked = torch.cat([dense_masked, pad], dim=1)

    # [L, B, S, S, G]: the scan runs over the step within a group
    m = dense_masked.reshape(B, G, L, S, S).permute(2, 0, 3, 4, 1)

    # Phase A: group-local prefix matrices, L serial steps over [B, G]
    carry = _identity_mat(S, m)[None, :, :, None].expand(B, S, S, G)
    prefixes = torch.empty_like(m)
    for k in range(L):
        carry = mm(carry, m[k])
        prefixes[k] = carry

    # Phase B: start vector of each group, G serial steps on [B, S]
    finals = carry.permute(3, 0, 1, 2)  # [G, B, S, S]
    starts = torch.empty(G, B, S, dtype=v0.dtype, device=v0.device)
    v = v0
    for g in range(G):
        starts[g] = v  # the vector *before* group g
        v = vv(v, finals[g])

    # Phase C: parallel vector x prefix-matrix products
    sv = starts.permute(1, 2, 0)[None]  # [1, B, S, G]
    states = vm(sv, prefixes)  # [L, B, S, G]
    return states.permute(1, 3, 0, 2).reshape(B, Tp, S)[:, :T]


def seg_forward_states(dense, nblocks):
    """alphas [B, T+1, S] of the sum-semiring forward scan (alpha[0] = 0)."""
    B, T, S, _ = dense.shape
    md = _masked_dense(dense, nblocks)
    v0 = dense.new_zeros(B, S)
    states = _prefix_vectors(md, v0, _mm_lse, _vm_lse, _vv_lse)
    return torch.cat([v0[:, None], states], dim=1)


def seg_backward_states(dense, nblocks):
    """betas [B, T+1, S]: beta[T] = 0, beta[t] = lse_j m[t][i, j] +
    beta[t+1][j], as a forward scan over reversed time on the transposed
    matrices."""
    B, T, S, _ = dense.shape
    md = _masked_dense(dense, nblocks)
    md_rev = md.flip(1).transpose(-1, -2)
    v0 = dense.new_zeros(B, S)
    states = _prefix_vectors(md_rev, v0, _mm_lse, _vm_lse, _vv_lse)
    return torch.cat([v0[:, None], states], dim=1).flip(1)


def seg_viterbi_states(dense, nblocks):
    """Max-plus alphas [B, T+1, S] (alpha[0] = 0)."""
    B, T, S, _ = dense.shape
    md = _masked_dense(dense, nblocks)
    v0 = dense.new_zeros(B, S)
    states = _prefix_vectors(md, v0, _mm_max, _vm_max, _vv_max)
    return torch.cat([v0[:, None], states], dim=1)


def seg_backptr(alphas, dense, nblocks, tie_rank, RANK_BIG=10**6):
    """Backpointers [B, T, S] int8 recovered elementwise from the max-plus
    prefix vectors: bp[b, t, to] is the from-state of lowest tie_rank among
    those where alpha[t][from] + m[t][from, to] is the maximum, the
    sequential step's formula (so tie order is the same; only value ulps
    can differ).  Invalid steps hold the identity."""
    B, T, S, _ = dense.shape
    dev = dense.device
    md = _masked_dense(dense, nblocks)
    md_t = md.permute(0, 2, 3, 1)  # [B, from, to, T]
    a_t = alphas[:, :-1].permute(0, 2, 1)  # [B, from, T]
    scores = a_t[:, :, None, :] + md_t  # [B, from, to, T]
    best = scores.amax(dim=1)  # [B, to, T]
    rank = torch.as_tensor(tie_rank, dtype=torch.int64, device=dev)[None, :, :, None]
    big = torch.full((), RANK_BIG, dtype=torch.int64, device=dev)
    bp = torch.where(scores == best[:, None], rank, big).argmin(dim=1)  # [B, to, T]
    bp = bp.permute(0, 2, 1)  # [B, T, to]
    valid = torch.arange(T, device=dev)[None, :] < nblocks.to(dev)[:, None]
    ident = torch.arange(S, device=dev)[None, None, :]
    return torch.where(valid[..., None], bp, ident).to(torch.int8)


def seg_traceback(backptr, last_state, nblocks, L: int = SEG_L):
    """Path [B, T+1] int32 by segmented composition of the backpointer
    maps: path[T] = last_state, path[t] = backptr[t][path[t+1]].  The maps
    at invalid steps must be the identity (seg_backptr and the sequential
    Viterbi steps guarantee it)."""
    B, T, S = backptr.shape
    dev = backptr.device
    g = backptr.flip(1).to(torch.int64)  # g[i] = backptr[T-1-i]: s_i -> s_{i+1}
    G = -(-T // L)
    Tp = G * L
    ident = torch.arange(S, device=dev)
    if Tp != T:
        g = torch.cat([g, ident[None, None].expand(B, Tp - T, S)], dim=1)
    m = g.reshape(B, G, L, S).permute(2, 0, 1, 3)  # [L, B, G, S]

    # Phase A: within-group prefix maps P[l] = g_l o ... o g_0
    carry = ident[None, None].expand(B, G, S)
    prefixes = torch.empty_like(m)
    for k in range(L):
        carry = torch.gather(m[k], -1, carry)  # s -> g_k[carry[s]]
        prefixes[k] = carry

    # Phase B: the state entering each group, G serial steps on [B]
    state = last_state.to(device=dev, dtype=torch.int64)
    starts = torch.empty(G, B, dtype=torch.int64, device=dev)
    for j in range(G):
        starts[j] = state  # the state *before* group j
        state = torch.gather(carry[:, j], 1, state[:, None])[:, 0]

    # Phase C: states[l, b, g] = P[l, b, g][starts[g, b]]
    idx = starts.T[None, :, :, None].expand(L, B, G, 1)
    states = torch.gather(prefixes, -1, idx)[..., 0]  # [L, B, G]
    states = states.permute(1, 2, 0).reshape(B, Tp)[:, :T]
    # states[:, i] is path[T-1-i]; put last_state at the end and flip
    path = torch.cat([last_state.to(device=dev, dtype=torch.int64)[:, None], states], dim=1)
    return path.flip(1).to(torch.int32)

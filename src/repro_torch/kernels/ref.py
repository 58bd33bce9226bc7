"""Plain PyTorch versions of the kernels.

These are the semantics contract of the port, as ``kernels/ref.py`` is
the reference's: each function repeats the reference oracle's
arithmetic in its order (unit rows built before the dot product), and
runs on any device.  The kernel wrappers take them for a tensor that
lies on the CPU, and ``chip_smoke.py`` holds each CUDA kernel against
them on the card.  The kernels divide after the dot product instead,
so a kernel and its plain version agree to f32 tolerance, not bit for
bit.

``gram_in_bf16`` (the Gram functions) rounds the two operands of the
dot products to bf16, round to nearest even as the reference's
``astype(jnp.bfloat16)``, and sums in f32; norms and Ĥ stay those of
the f32 rows.  A product of two bf16 values is exact in f32, so the
kernels and these versions differ only in the order of the sums.  The
kernel wrappers' CPU dispatch never sets it: there the option is
ignored, as the reference's CPU oracle ignores it.
"""
from __future__ import annotations

import torch

#: cosine clip bounds of Eq. 9, as f32 (the reference's weak-typed
#: python floats become the same f32 constants)
COS_LO = -1.0 + 1e-7
COS_HI = 1.0 - 1e-7


def entropy_ref(updates: torch.Tensor, temperature: float) -> torch.Tensor:
    """H(softmax(v / T)) row-wise.  updates: (N, C) -> (N,) f32."""
    u = updates.float() / temperature
    u = u - u.max(dim=-1, keepdim=True).values
    e = torch.exp(u)
    z = e.sum(dim=-1)
    s = (e * u).sum(dim=-1)
    return torch.log(z) - s / z


def fused_stats_ref(updates: torch.Tensor, temperature: float,
                    row_scale: torch.Tensor | None = None):
    """(N, C) -> (entropy, l2 norm, rms), each (N,) f32.  ``row_scale``
    (N,) multiplies each row before the tempered softmax; norm and RMS
    are always of the raw rows."""
    x = updates.float()
    scaled = x if row_scale is None else x * row_scale.float()[:, None]
    ent = entropy_ref(scaled, temperature)
    sumsq = (x * x).sum(dim=-1)
    return ent, torch.sqrt(sumsq), torch.sqrt(sumsq / x.shape[-1])


#: the stats kernels' slices (csrc/entropy_carry.cuh): boundaries on
#: whole STATS_UNIT-column units, at most MAX_STATS_SPLITS (the portable
#: cluster size); an empty slice's carry is (STATS_NEG, 0, 0)
STATS_UNIT = 32
MAX_STATS_SPLITS = 8
STATS_NEG = -1e30


def stats_slice_ranges(c: int, splits: int) -> list:
    """The stats kernels' slices of [0, c): [(begin, end)] per slice,
    slice p the units [U·p/P, U·(p+1)/P) of U = ceil(c / 32), the last
    cut at c; a slice may be empty (U < P)."""
    if not 1 <= splits <= MAX_STATS_SPLITS:
        raise ValueError(f"splits must be in [1, {MAX_STATS_SPLITS}], got "
                         f"{splits}")
    units = -(-c // STATS_UNIT)
    return [(units * p // splits * STATS_UNIT,
             min(units * (p + 1) // splits * STATS_UNIT, c))
            for p in range(splits)]


def _slice_carry(u: torch.Tensor):
    """(m, Z, S) of each row of u (N, w): m the max, Z = Σ e^{u−m},
    S = Σ e^{u−m}(u − m); (-1e30, 0, 0) where w = 0."""
    n = u.shape[0]
    if u.shape[1] == 0:
        return (torch.full((n,), STATS_NEG, dtype=torch.float32,
                           device=u.device),
                torch.zeros(n, device=u.device),
                torch.zeros(n, device=u.device))
    m = u.amax(dim=-1)
    d = u - m[:, None]
    e = torch.exp(d)
    return m, e.sum(dim=-1), (e * d).sum(dim=-1)


def merge_carries(carries) -> torch.Tensor:
    """Ĥ = ln Z − S / Z of the carries merged in their order, as the
    kernels' rank 0 merges its cluster's (``carry::merge``)."""
    m, z, s = carries[0]
    for mo, zo, so in carries[1:]:
        mn = torch.maximum(m, mo)
        a, b = torch.exp(m - mn), torch.exp(mo - mn)
        s = (s + (m - mn) * z) * a + (so + (mo - mn) * zo) * b
        z = z * a + zo * b
        m = mn
    return torch.log(z) - s / z


def entropy_split_ref(updates: torch.Tensor, temperature: float,
                      splits: int) -> torch.Tensor:
    """H(softmax(x / T)) row-wise as ``hetero_entropy.cu`` splits it:
    one carry per slice of :func:`stats_slice_ranges`, merged in slice
    order.  Same result as :func:`entropy_ref`, to f32 rounding."""
    u = updates.float() / temperature
    return merge_carries([_slice_carry(u[:, lo:hi]) for lo, hi in
                          stats_slice_ranges(u.shape[1], splits)])


def fused_stats_split_ref(updates: torch.Tensor, temperature: float,
                          splits: int, row_scale: torch.Tensor | None = None,
                          normalize: bool = False):
    """(entropy, l2 norm, rms) as ``fused_stats.cu`` splits each row:
    per slice a carry and a sum of squares, added and merged in slice
    order.  The softmax reads x·s: s = row_scale / T, or under
    ``normalize`` 1 / (max(RMS, 1e-12)·T) from the merged sum of
    squares, else 1/T."""
    x = updates.float()
    c = x.shape[1]
    ranges = stats_slice_ranges(c, splits)
    sumsq = torch.zeros(x.shape[0], device=x.device)
    for lo, hi in ranges:
        sumsq = sumsq + (x[:, lo:hi] * x[:, lo:hi]).sum(dim=-1)
    rms = torch.sqrt(sumsq / c)
    if normalize:
        if row_scale is not None:
            raise ValueError("normalize takes no row_scale")
        scale = 1.0 / (torch.clamp(rms, min=1e-12) * temperature)
        u = x * scale[:, None]
    elif row_scale is not None:
        u = x * (row_scale.float() / temperature)[:, None]
    else:
        u = x * (1.0 / temperature)
    ent = merge_carries([_slice_carry(u[:, lo:hi]) for lo, hi in ranges])
    return ent, torch.sqrt(sumsq), rms


def row_entropy(rows: torch.Tensor, temperature: float,
                normalize: bool) -> torch.Tensor:
    """Ĥ of each row; ``normalize`` RMS-normalizes the rows first."""
    if normalize:
        rms = torch.sqrt((rows * rows).mean(dim=-1, keepdim=True))
        return entropy_ref(rows / torch.clamp(rms, min=1e-12), temperature)
    return entropy_ref(rows, temperature)


def gram_operand(x: torch.Tensor, gram_in_bf16: bool) -> torch.Tensor:
    """The f32 values a Gram product reads: ``x`` itself, or rounded to
    bf16 and widened back."""
    return x.to(torch.bfloat16).float() if gram_in_bf16 else x


def pairwise_distance_ref(updates: torch.Tensor, entropies: torch.Tensor,
                          lam: float, eps: float = 1e-8,
                          gram_in_bf16: bool = False) -> torch.Tensor:
    """Eq. 9 distance matrix.  updates (N, C), entropies (N,) -> (N, N)."""
    x = updates.float()
    norms = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    unit = gram_operand(x, gram_in_bf16) / torch.clamp(norms, min=eps)
    cos = torch.clamp(unit @ unit.T, COS_LO, COS_HI)
    eye = torch.eye(x.shape[0], dtype=x.dtype, device=x.device)
    ang = torch.arccos(cos) * (1.0 - eye)
    h = entropies.float()
    return ang + lam * torch.abs(h[:, None] - h[None, :])


#: the Gram kernels' slices of C are whole GRAM_CHUNK-column chunks
#: (csrc/gram_tile.cuh: TC, slice_range)
GRAM_CHUNK = 32


def gram_slice_ranges(c: int, splits: int) -> list:
    """The Gram kernels' slices of [0, c): [(begin, end)] per slice,
    slice s the chunks [nch·s/S, nch·(s+1)/S) of nch = ceil(c / 32),
    the last cut at c; a slice is empty where S > nch."""
    nch = -(-c // GRAM_CHUNK)
    return [(nch * s // splits * GRAM_CHUNK,
             min(nch * (s + 1) // splits * GRAM_CHUNK, c))
            for s in range(splits)]


def kahan_add(acc: torch.Tensor, comp: torch.Tensor, v: torch.Tensor):
    """One Kahan step, (acc, comp) += v elementwise, each operation
    rounded on its own as ``gram_tile.cuh: kahan_add``."""
    y = v - comp
    t = acc + y
    return t, (t - acc) - y


def pairwise_split_ref(x: torch.Tensor, stats: torch.Tensor, lam: float,
                       splits: int, gram_in_bf16: bool = False,
                       eps: float = 1e-8) -> torch.Tensor:
    """Eq. 9 matrix in the pairwise kernel's sum structure: one Gram
    product per slice of :func:`gram_slice_ranges`, the slices added
    in slice order with Kahan compensation, divided by the norms after
    the dot product, each unordered pair computed once (the upper
    triangle mirrored) and the diagonal 0.  x (N, C), stats (N, 2) =
    [norm, Ĥ] -> (N, N) f32; the same result as
    :func:`pairwise_distance_ref` to f32 rounding."""
    xo = gram_operand(x.float(), gram_in_bf16)
    n = xo.shape[0]
    acc = torch.zeros((n, n), dtype=torch.float32, device=xo.device)
    comp = torch.zeros_like(acc)
    for lo, hi in gram_slice_ranges(xo.shape[1], splits):
        part = xo[:, lo:hi] @ xo[:, lo:hi].T
        acc, comp = kahan_add(acc, comp, part)
    nrm = torch.clamp(stats[:, 0].float(), min=eps)
    cos = torch.clamp(acc / (nrm[:, None] * nrm[None, :]), COS_LO, COS_HI)
    h = stats[:, 1].float()
    d = torch.triu(torch.arccos(cos) + lam * torch.abs(h[:, None] -
                                                       h[None, :]), 1)
    return d + d.T


def selection_step_ref(updates: torch.Tensor, temperature: float,
                       lam: float, normalize: bool = False,
                       gram_in_bf16: bool = False):
    """(N, C) -> (Ĥ (N,), Eq. 9 D (N, N)), from scratch."""
    x = updates.float()
    h = row_entropy(x, temperature, normalize)
    return h, pairwise_distance_ref(x, h, lam, gram_in_bf16=gram_in_bf16)


def distance_strip_ref(updates: torch.Tensor, stats: torch.Tensor,
                       ids: torch.Tensor, lam: float, eps: float = 1e-8,
                       epilogue: str = "arccos",
                       gram_in_bf16: bool = False) -> torch.Tensor:
    """(N, C), (N, 2) current [norm, Ĥ], (K,) ids -> (K, N) distance
    strip; the true diagonal is zeroed.  ``epilogue``:

      arccos — Eq. 9: arccos of the cosine + λ|ΔĤ| (HiCS)
      cosine — the angle alone, stats[:, 1] unread (Clustered Sampling)
      l2     — √(|a|² + |b|² − 2⟨a, b⟩) from the cached norms (DivFL)

    Unit rows use the cached norms."""
    x = gram_operand(updates.float(), gram_in_bf16)
    if epilogue == "l2":
        nr, nc = stats[ids, 0], stats[:, 0]
        dot = x[ids] @ x.T
        d = torch.sqrt(torch.clamp(
            nr[:, None] ** 2 + nc[None, :] ** 2 - 2.0 * dot, min=0.0))
    elif epilogue in ("arccos", "cosine"):
        unit = x / torch.clamp(stats[:, 0:1], min=eps)
        d = torch.arccos(torch.clamp(unit[ids] @ unit.T, COS_LO, COS_HI))
    else:
        raise ValueError(f"unknown epilogue {epilogue!r}; expected "
                         "'arccos', 'cosine' or 'l2'")
    cols = torch.arange(x.shape[0], device=x.device)
    d = torch.where(ids[:, None] == cols[None, :], 0.0, d)
    if epilogue == "arccos":
        d = d + lam * torch.abs(stats[ids, 1][:, None] - stats[None, :, 1])
    return d


def scatter_strip(dist: torch.Tensor, strip: torch.Tensor,
                  ids: torch.Tensor) -> torch.Tensor:
    """Write a (K, N) strip into rows AND columns ``ids`` of a copy of
    ``dist``.  The K×K block ends up holding the column write, so the
    result is exactly symmetric whenever the strip's K×K block is."""
    out = dist.clone()
    out[ids] = strip
    out[:, ids] = strip.T
    return out


def cached_selection_step_ref(updates: torch.Tensor, dist: torch.Tensor,
                              stats: torch.Tensor, ids: torch.Tensor,
                              temperature: float, lam: float,
                              normalize: bool = False, eps: float = 1e-8,
                              gram_in_bf16: bool = False):
    """Incremental step: refresh the rows/cols of ``ids`` in the cached
    ``dist`` (N, N) and ``stats`` (N, 2) = [norm, Ĥ].  Returns
    (Ĥ (N,), dist, stats).  K = 0 returns the cache unchanged."""
    if ids.numel() == 0:
        return stats[:, 1], dist, stats
    x = updates.float()
    rows = x[ids]
    h_rows = row_entropy(rows, temperature, normalize)
    n_rows = torch.linalg.vector_norm(rows, dim=-1)
    stats = stats.clone()
    stats[ids] = torch.stack([n_rows, h_rows], dim=-1)
    strip = distance_strip_ref(x, stats, ids, lam, eps=eps,
                               gram_in_bf16=gram_in_bf16)
    return stats[:, 1], scatter_strip(dist, strip, ids), stats


def scatter_strip_symmetric(dist: torch.Tensor, strip: torch.Tensor,
                            ids: torch.Tensor) -> torch.Tensor:
    """Write a (K, N) strip into rows AND columns ``ids`` of a copy of
    ``dist``, the K×K block averaged with its transpose, so the result
    is exactly symmetric whatever the strip's K×K block is (the
    reference's ``_scatter_strip_symmetric``; a bit-symmetric block
    comes through unchanged).  Duplicate ids write equal values."""
    kk = strip[:, ids]
    out = dist.clone()
    out[ids] = strip
    out[:, ids] = strip.T
    out[ids[:, None], ids[None, :]] = 0.5 * (kk + kk.T)
    return out


def cached_feature_step_ref(feats: torch.Tensor, dist: torch.Tensor,
                            stats: torch.Tensor, ids: torch.Tensor,
                            metric: str = "cosine", eps: float = 1e-8,
                            gram_in_bf16: bool = False):
    """Incremental full-update distance step (CS, DivFL): refresh the
    rows and columns of ``ids`` in the cached ``dist`` (N, N) and
    ``stats`` (N, 2) = [L2 norm, 0] from the features (N, F) with the
    selector's ``metric`` ("cosine" or "l2").  Returns (dist, stats);
    K = 0 returns the cache unchanged."""
    if ids.numel() == 0:
        return dist, stats
    x = feats.float()
    n_rows = torch.linalg.vector_norm(x[ids], dim=-1)
    stats = stats.clone()
    stats[ids] = torch.stack([n_rows, torch.zeros_like(n_rows)], dim=-1)
    strip = distance_strip_ref(x, stats, ids, 0.0, eps=eps, epilogue=metric,
                               gram_in_bf16=gram_in_bf16)
    return scatter_strip_symmetric(dist, strip, ids), stats


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         length, scale: float | None = None) -> torch.Tensor:
    """GQA one-token decode attention.

    q: (B, H, dh); k/v: (B, S, KV, dh); length: valid cache length, ()
    or (B,) (positions >= length are masked).  H must be a multiple of
    KV.  Returns (B, H, dh) float32.  A row of length 0 is NaN (softmax
    over all -inf); the kernel returns 0 there.
    """
    b, h, dh = q.shape
    s, kv = k.shape[1], k.shape[2]
    g = h // kv
    scale = (dh ** -0.5) if scale is None else scale
    qf = q.float().reshape(b, kv, g, dh)
    logits = torch.einsum("bngd,bsnd->bngs", qf, k.float()) * scale
    pos = torch.arange(s, device=q.device)
    lens = torch.as_tensor(length, device=q.device).reshape(-1, 1)
    mask = pos[None, :] < lens
    logits = torch.where(mask[:, None, None, :], logits, -torch.inf)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bngs,bsnd->bngd", p, v.float())
    return out.reshape(b, h, dh)


#: cache positions per tile of the decode kernel
#: (csrc/decode_attention.cu: BS); splits are runs of whole tiles
DECODE_TILE = 32
#: the decode kernel's masked logit and empty-split max
NEG_INF = -1e30


def decode_split_ranges(s: int, splits: int) -> list:
    """The decode kernel's splits of [0, s): [(begin, end)] per split,
    split p the tiles [T·p/P, T·(p+1)/P) of T = ceil(s / 32), the last
    cut at s; 1 <= P <= T, as the kernel takes."""
    tiles = -(-s // DECODE_TILE)
    if not 1 <= splits <= tiles:
        raise ValueError(f"splits must be in [1, {tiles}], got {splits}")
    return [(tiles * p // splits * DECODE_TILE,
             min(tiles * (p + 1) // splits * DECODE_TILE, s))
            for p in range(splits)]


def decode_split_partials(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, lengths, splits: int,
                          scale: float | None = None):
    """Each split's partial of :func:`decode_attention_split_ref`:
    (m, l, acc), shapes (P, B, KV, G) twice and (P, B, KV, G, dh).  A
    split's m is the max of its valid logits, -1e30 where it has none
    (then l = 0 and acc = 0); l = Σ p and acc = Σ p·V over its valid
    positions, p = e^{logit − m}."""
    b, h, dh = q.shape
    s, kv = k.shape[1], k.shape[2]
    scale = (dh ** -0.5) if scale is None else scale
    qf = q.float().reshape(b, kv, h // kv, dh)
    lens = torch.as_tensor(lengths, device=q.device).reshape(-1)
    lens = lens.expand(b).clamp(0, s)
    pos = torch.arange(s, device=q.device)
    parts = []
    for lo, hi in decode_split_ranges(s, splits):
        logits = torch.einsum("bngd,bsnd->bngs", qf,
                              k[:, lo:hi].float()) * scale
        valid = (pos[lo:hi][None, :] < lens[:, None])[:, None, None, :]
        logits = torch.where(valid, logits, NEG_INF)
        m = logits.amax(dim=-1)
        p = torch.where(valid, torch.exp(logits - m[..., None]), 0.0)
        parts.append((m, p.sum(dim=-1),
                      torch.einsum("bngs,bsnd->bngd", p,
                                   v[:, lo:hi].float())))
    return tuple(torch.stack(x) for x in zip(*parts))


def merge_decode_partials(m: torch.Tensor, l: torch.Tensor,
                          acc: torch.Tensor) -> torch.Tensor:
    """The decode kernel's merge: splits in increasing order,
    M = max m_p, l = Σ l_p·e^{m_p−M}, acc = Σ acc_p·e^{m_p−M}, then
    acc / max(l, 1e-30) as (B, H, dh).  An empty split weighs
    e^{−1e30−M} = 0; a row with no valid position gives 0."""
    mx = m.amax(dim=0)
    ls = torch.zeros_like(mx)
    out = torch.zeros_like(acc[0])
    for mp, lp, ap in zip(m, l, acc):
        wt = torch.exp(mp - mx)
        ls = ls + lp * wt
        out = out + ap * wt[..., None]
    out = out / torch.clamp(ls, min=1e-30)[..., None]
    b, kv, g, dh = out.shape
    return out.reshape(b, kv * g, dh)


def decode_attention_split_ref(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, lengths, splits: int,
                               scale: float | None = None,
                               gc: int | None = None) -> torch.Tensor:
    """GQA one-token decode attention as the kernel splits it: the
    partial (m, l, acc) of each of ``splits`` runs of 32-position tiles
    (:func:`decode_split_ranges`), merged in increasing split order,
    for each chunk of ``gc`` query heads of a KV head (the kernel's
    chunk plan, ``kernels.decode_attention.decode_plan``; all G heads
    in one chunk by default).  Same arguments and result as
    :func:`decode_attention_ref`, except that a row of length 0 is 0,
    as the kernel's."""
    b, h, dh = q.shape
    kv = k.shape[2]
    g = h // kv
    gc = g if gc is None else gc
    qg = q.reshape(b, kv, g, dh)
    outs = []
    for c0 in range(0, g, gc):
        qc = qg[:, :, c0:c0 + gc]
        out = merge_decode_partials(*decode_split_partials(
            qc.reshape(b, -1, dh), k, v, lengths, splits, scale))
        outs.append(out.reshape(b, kv, -1, dh))
    return torch.cat(outs, dim=2).reshape(b, h, dh)

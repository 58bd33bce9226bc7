"""Device-resident metric groups: the round step's telemetry dict.

The port of the reference's ``telemetry/metrics.py``.  A
:class:`MetricsSpec` names which metric *groups* a run records;
:func:`make_metrics` compiles that choice into a pure ``(init, step)``
pair the drivers thread through their round steps:

    telc            = metrics.init()                # carry dict
    telc, telemetry = metrics.step(telc, ctx)       # inside the round

``telemetry`` is a flat ``{"group/field": tensor}`` dict, an ordinary
output of the round step: the drivers stack it to ``(T, ...)`` per
field (``(S, T, ...)`` in the sweep).  The carry holds the one metric
that accumulates across rounds (the fairness times-selected histogram).
The step is tensor code that reads nothing on the host, so it runs
inside the scanned driver's captured CUDA graph.

Schema contract: the field SET is identical for every group
combination.  Disabled groups, and fields whose inputs a driver cannot
supply (``async/*`` on the sync loop), are zero-width ``(0,)`` tensors,
made once on the device.  Enabling a group never changes the dict's
structure, only widths, and the training computation is untouched:
every metric is derived from values the round already produced, so
telemetry-on and telemetry-off runs take bit-identical trajectories.

Groups:

  selection — Ĥ-estimate health: mean/std spread, cohort mean,
              Ĥ-vs-true-partition-entropy MAE and Spearman rank
              correlation (needs ``ctx.true_entropy``), the staleness
              ring's fill, and, when the selector has ``diagnostics``,
              cluster sizes and the within-cluster Ĥ spread.
  training  — the round's train loss, mean ‖Δb‖ row norm, the global
              update norm ‖θ^{t+1} − θ^t‖, the lr scale.
  fairness  — cumulative times-selected histogram, participation rate
              (fraction ever selected), effective participation
              exp(H(counts))/N.
  async     — buffer fill, accepted/overflow-dropped counts, the
              aggregation trigger, server version, version lag of the
              oldest buffered entry, staleness ages of the aggregated
              cohort (−1 when the tick did not fire).

Imports from ``repro_torch.core`` stay inside functions:
``repro_torch.kernels`` imports :mod:`repro_torch.telemetry.trace`
when it is imported, so a module-level ``repro_torch.core`` import here
would close an import cycle.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch

from repro_torch.backend import resolve_device

#: every registered metric group, in schema order.
GROUPS: Tuple[str, ...] = ("selection", "training", "fairness", "async")

#: the async group's scalar fields, in schema order
_ASYNC_SCALARS = ("fired", "fill", "accepted", "dropped", "version",
                  "version_lag")


@dataclasses.dataclass(frozen=True)
class MetricsSpec:
    """Which metric groups a run records.  ``groups=()`` is telemetry
    off: every field in the schema is emitted zero-width."""
    groups: Tuple[str, ...] = ()

    def __post_init__(self):
        unknown = set(self.groups) - set(GROUPS)
        if unknown:
            raise ValueError(f"unknown metric groups {sorted(unknown)}; "
                             f"known: {list(GROUPS)}")
        object.__setattr__(self, "groups", tuple(self.groups))

    def enabled(self, group: str) -> bool:
        return group in self.groups

    @classmethod
    def all(cls) -> "MetricsSpec":
        return cls(groups=GROUPS)


class TelemetryCtx(NamedTuple):
    """What the round or tick hands the metrics step.  A field a driver
    cannot supply stays ``None``; its metrics come out zero-width."""
    t: Any = None                    # round / tick index
    ids: Any = None                  # (K,) dispatched cohort
    state: Any = None                # post-update SelectorState
    train_loss: Any = None           # () cohort mean train loss
    true_entropy: Any = None         # (N,) H(D_k) of the true partition
    params_before: Any = None        # θ^t   (pre-aggregation)
    params_after: Any = None         # θ^{t+1}
    bias_updates: Any = None         # (K, C) cohort Δb
    lr_scale: Any = None             # () decay factor
    # -- async tick extras ------------------------------------------------
    fired: Any = None                # () bool — aggregation triggered
    fill: Any = None                 # () buffer fill after the tick
    accepted: Any = None             # () arrivals buffered this tick
    dropped: Any = None              # () arrivals overflow-dropped
    version: Any = None              # () server version after the tick
    version_lag: Any = None          # () version − oldest buffered
    agg_ages: Any = None             # (M,) popped ages, −1 when idle


class Metrics(NamedTuple):
    """The compiled ``(init, step)`` pair plus its spec."""
    spec: MetricsSpec
    init: Callable[[], Dict[str, torch.Tensor]]
    step: Callable[..., tuple]   # (carry, ctx) -> (carry, telemetry)


def _f32(v) -> torch.Tensor:
    return torch.as_tensor(v).to(torch.float32)


def _flat_norm_sq(a: dict, b: dict) -> torch.Tensor:
    """Σ over the leaves (``jax.tree_util.tree_leaves`` order) of
    Σ (a − b)²."""
    from repro_torch.optim import tree_leaves
    return sum(((_f32(x) - _f32(y)) ** 2).sum()
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def _ranks(v: torch.Tensor) -> torch.Tensor:
    """Each entry's rank in a stable ascending sort (ties to the lower
    index, as ``jnp.argsort``), f32."""
    order = torch.argsort(v, stable=True)
    return torch.zeros(v.shape, device=v.device).index_copy(
        0, order, torch.arange(v.shape[0], dtype=torch.float32,
                               device=v.device))


def spearman(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Spearman rank correlation of two (N,) vectors (ties broken by a
    stable sort's order): the ordering consistency Thm 3.3 promises,
    unlike a raw value comparison.  0 when a vector is constant."""
    ra, rb = _ranks(a), _ranks(b)
    ra = ra - ra.mean()
    rb = rb - rb.mean()
    denom = torch.sqrt((ra * ra).sum() * (rb * rb).sum())
    return torch.where(denom > 0, (ra * rb).sum() / denom,
                       torch.zeros_like(denom))


def client_true_entropy(y: torch.Tensor, mask: torch.Tensor,
                        num_classes: int) -> torch.Tensor:
    """(N,) true label entropy H(D_k) from padded labels (N, S) and
    their sample mask: the ground truth the ``selection`` group scores
    Ĥ against.  The class counts are summed by a scatter over the
    labels, so nothing is read on the host."""
    from repro_torch.core.hetero import label_entropy
    y = torch.as_tensor(y).long()
    mask = _f32(mask).to(y.device)
    counts = torch.zeros(y.shape[:-1] + (int(num_classes),),
                         device=y.device).scatter_add_(-1, y, mask)
    return label_entropy(counts)


def make_metrics(spec: MetricsSpec, fn=None, num_clients: int = 0,
                 num_select: int = 0, device="cuda") -> Metrics:
    """Compile a :class:`MetricsSpec` for one experiment shape on
    ``device``.

    ``fn`` is the :class:`~repro_torch.core.selectors.functional.
    FunctionalSelector` whose ``entropies`` / ``diagnostics`` the
    ``selection`` group reads (without it the selection fields are
    zero-width).  ``num_clients`` sizes the fairness histogram.
    """
    del num_select
    dev = resolve_device(device)
    n = int(num_clients)
    want_sel = spec.enabled("selection")
    want_train = spec.enabled("training")
    want_fair = spec.enabled("fairness")
    want_async = spec.enabled("async")
    zf = torch.zeros(0, device=dev)
    zi = torch.zeros(0, dtype=torch.int32, device=dev)

    def init() -> Dict[str, torch.Tensor]:
        return {"fairness/counts":
                torch.zeros(n, dtype=torch.int32, device=dev)
                if want_fair else zi}

    def step(carry: Dict[str, torch.Tensor], ctx: TelemetryCtx):
        from repro_torch.core.selectors.functional import state_entropies
        out: Dict[str, torch.Tensor] = {}
        ids = None if ctx.ids is None else torch.as_tensor(ctx.ids).long()

        # -- selection ----------------------------------------------------
        ent = (state_entropies(fn, ctx.state)
               if want_sel and fn is not None and ctx.state is not None
               else zf)
        have_ent = ent.shape[0] > 0
        if have_ent:
            out["selection/ent_mean"] = ent.mean()
            out["selection/ent_std"] = ent.std(correction=0)
            out["selection/ent_selected_mean"] = (
                ent.index_select(0, ids).mean() if ids is not None
                else ent.mean())
        else:
            out["selection/ent_mean"] = zf
            out["selection/ent_std"] = zf
            out["selection/ent_selected_mean"] = zf
        if have_ent and ctx.true_entropy is not None:
            te = _f32(ctx.true_entropy)
            out["selection/ent_mae"] = (ent - te).abs().mean()
            out["selection/ent_rank_corr"] = spearman(ent, te)
        else:
            out["selection/ent_mae"] = zf
            out["selection/ent_rank_corr"] = zf
        ring = (int(ctx.state.stale_ids.shape[0])
                if want_sel and ctx.state is not None else 0)
        out["selection/stale_frac"] = (
            _f32(ctx.state.stale_fill) / ring if ring else zf)
        if want_sel and fn is not None and fn.diagnostics is not None \
                and ctx.state is not None:
            diag = fn.diagnostics(ctx.state)
            out["selection/cluster_sizes"] = diag["cluster_sizes"].to(
                torch.int32)
            out["selection/cluster_ent_spread"] = _f32(
                diag["cluster_ent_spread"])
        else:
            out["selection/cluster_sizes"] = zi
            out["selection/cluster_ent_spread"] = zf

        # -- training -----------------------------------------------------
        out["training/loss"] = (
            _f32(ctx.train_loss)
            if want_train and ctx.train_loss is not None else zf)
        if want_train and ctx.bias_updates is not None:
            db = _f32(ctx.bias_updates)
            out["training/delta_b_norm"] = torch.sqrt(
                (db * db).sum(dim=-1)).mean()
        else:
            out["training/delta_b_norm"] = zf
        out["training/update_norm"] = (
            torch.sqrt(_flat_norm_sq(ctx.params_after, ctx.params_before))
            if want_train and ctx.params_before is not None
            and ctx.params_after is not None else zf)
        out["training/lr_scale"] = (
            _f32(ctx.lr_scale)
            if want_train and ctx.lr_scale is not None else zf)

        # -- fairness -----------------------------------------------------
        counts = carry["fairness/counts"]
        if want_fair and ids is not None:
            counts = counts.index_add(
                0, ids, torch.ones(ids.shape, dtype=torch.int32,
                                   device=counts.device))
            total = counts.sum()
            p = counts.float() / torch.clamp(total, min=1).float()
            hp = -torch.where(counts > 0, p * torch.log(
                torch.clamp(p, min=1e-12)), torch.zeros_like(p)).sum()
            out["fairness/sel_counts"] = counts
            out["fairness/participation"] = (counts > 0).float().mean()
            out["fairness/eff_participation"] = torch.where(
                total > 0, torch.exp(hp) / max(1, n), torch.zeros_like(hp))
        else:
            out["fairness/sel_counts"] = zi
            out["fairness/participation"] = zf
            out["fairness/eff_participation"] = zf

        # -- async --------------------------------------------------------
        for field in _ASYNC_SCALARS:
            val = getattr(ctx, field)
            out[f"async/{field}"] = (
                _f32(val) if want_async and val is not None else zf)
        out["async/agg_ages"] = (
            _f32(ctx.agg_ages)
            if want_async and ctx.agg_ages is not None else zf)

        return {"fairness/counts": counts}, out

    return Metrics(spec, init, step)

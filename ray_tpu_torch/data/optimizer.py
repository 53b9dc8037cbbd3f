"""Logical-plan optimizer for Data pipelines.

Parity: ``python/ray/data/_internal/logical/optimizers.py`` and the rule set
under ``_internal/logical/rules/`` — the reference rewrites its logical
operator DAG (projection pushdown, operator fusion, zero-copy conversions)
before planning physical execution. Here the plan is already fused eagerly
(a chain of per-block ops inside one ``TaskMapStage``); this pass works on
that op chain:

* **projection algebra** — adjacent declarative column ops (``select`` /
  ``drop`` / ``rename``, plain-data payloads) coalesce, and projections
  commute LEFT past renames, so a chain like ``rename → select`` becomes
  ``select' → rename'`` with the select adjacent to the source;
* **projection pushdown** — a leading ``select`` over column-pruning
  sources (parquet ReadTasks) moves into the read itself: the pruned
  columns never leave the file (``pq.read_table(columns=...)``).

Opaque ops (map/filter/flat_map/map_batches closures) are barriers — the
optimizer never reorders across them, because a closure may read or create
any column.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

_PROJECTIONS = ("select", "drop", "rename")


def _merge_pair(a: Tuple, b: Tuple) -> Optional[List[Tuple]]:
    """Rewrite [a, b] (both projection ops) to an equivalent, smaller or
    more-pushdown-friendly list, or None when no rule applies. Rules only
    fire when they cannot change error behavior (e.g. a select of a column
    the earlier op removed must still raise at execution)."""
    ka, pa = a
    kb, pb = b
    if ka == "select" and kb == "select":
        # merge only when both name the same column set: select(pa)
        # validates EVERY pa column against the block, so collapsing a
        # pb ⊂ pa pair to select(pb) would swallow the KeyError a missing
        # pa-only column must raise at execution
        if set(pb) == set(pa):
            return [("select", list(pb))]
        return None  # differing sets: keep the chain (and its errors)
    if ka == "drop" and kb == "drop":
        return [("drop", list(pa) + [c for c in pb if c not in pa])]
    if ka == "select" and kb == "drop":
        # drop ignores missing columns, so the pair's error behavior is
        # exactly select(pa)'s; merging to select(pa − pb) would skip the
        # missing-column check for a dropped pa column. Only a no-op drop
        # (disjoint from the selection) is eliminable.
        if not (set(pa) & set(pb)):
            return [("select", list(pa))]
        return None
    if ka == "drop" and kb == "select":
        if not (set(pb) & set(pa)):
            return [("select", list(pb))]
        return None  # selecting a dropped column must still raise
    if ka == "rename" and kb == "rename":
        comp = {k: pb.get(v, v) for k, v in pa.items()}
        for k, v in pb.items():
            if k not in pa.values() and k not in comp:
                comp[k] = v
        return [("rename", comp)]
    if ka == "rename" and kb == "select":
        # commute the select left through the rename (pushdown direction):
        # select post-rename names == select their pre-images, then rename
        # only what survives
        inv = {}
        for k, v in pa.items():
            if v in inv:
                return None  # ambiguous rename target; leave untouched
            inv[v] = k
        pre = []
        for c in pb:
            if c in inv:
                pre.append(inv[c])
            elif c in pa:
                # c was renamed AWAY (source, not target): post-rename it
                # does not exist — the select must raise at runtime, so
                # this pair cannot merge
                return None
            else:
                pre.append(c)
        if len(set(pre)) != len(pre):
            return None
        kept = {k: v for k, v in pa.items() if k in pre}
        out: List[Tuple] = [("select", pre)]
        if kept:
            out.append(("rename", kept))
        return out
    if ka == "rename" and kb == "drop":
        inv = {}
        for k, v in pa.items():
            if v in inv:
                return None
            inv[v] = k
        # a dropped name that was renamed AWAY (source-only) matches no
        # post-rename column: dropping it is a no-op — exclude it rather
        # than wrongly dropping the rename's source
        pre = [
            inv.get(c, c)
            for c in pb
            if not (c in pa and c not in inv)
        ]
        kept = {k: v for k, v in pa.items() if k not in pre}
        out = [("drop", pre)]
        if kept:
            out.append(("rename", kept))
        return out
    return None


def optimize_ops(ops: List[Tuple]) -> List[Tuple]:
    """Canonicalize a fused op chain. Terminates: every applied rule either
    shrinks the chain or moves a select/drop strictly left past a rename,
    and opaque ops partition the chain into independently-optimized runs."""
    ops = list(ops)
    for _ in range(len(ops) * len(ops) + 8):  # safety bound, never hit
        for i in range(len(ops) - 1):
            a, b = ops[i], ops[i + 1]
            if a[0] in _PROJECTIONS and b[0] in _PROJECTIONS:
                merged = _merge_pair(a, b)
                if merged is not None and merged != [a, b]:
                    ops[i : i + 2] = merged
                    break
        else:
            return ops
    return ops


def optimize_plan(sources: List, stages: List):
    """Rewrite (sources, stages) before execution: canonicalize every
    task-map op chain, then push a leading select into column-pruning
    ReadTask sources."""
    from ray_tpu_torch.data.streaming_executor import ReadTask, TaskMapStage

    stages = [
        TaskMapStage(optimize_ops(s.ops)) if isinstance(s, TaskMapStage) else s
        for s in stages
    ]
    if (
        stages
        and isinstance(stages[0], TaskMapStage)
        and stages[0].ops
        and stages[0].ops[0][0] == "select"
        and sources
        and all(
            isinstance(r, ReadTask) and r.supports_columns for r in sources
        )
    ):
        cols = list(stages[0].ops[0][1])
        # an existing per-read restriction (read_parquet(columns=...)) must
        # stay authoritative: push only a NARROWING select; a select of a
        # column the read excludes must keep its runtime KeyError
        if all(
            r.columns is None or set(cols) <= set(r.columns) for r in sources
        ):
            sources = [
                ReadTask(r.fn, r.args, columns=cols, supports_columns=True)
                for r in sources
            ]
            rest = stages[0].ops[1:]
            stages = ([TaskMapStage(rest)] if rest else []) + stages[1:]
    return sources, stages

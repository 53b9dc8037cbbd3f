"""Elastic checkpoint format: N→M rank re-sharding over committed shards.

The checkpoint plane (``checkpointing``) commits per-rank shard directories
(``shard-{rank:05d}-of-{world:05d}``) under one step prefix with a manifest
+ atomic COMMIT marker. That made restores *trusted*; this module makes
them *elastic*: a checkpoint committed by N ranks can be restored into M
ranks, for any N and M, without staging the whole checkpoint anywhere.

The format is deliberately simple — the reference's train library has no
equivalent (its restore path assumes the same world size; a resized run
falls back to rank-0 gather), and process-sharded formats assume a
live global mesh. Here a shard is raw row-partitioned arrays plus a tiny
index:

* each array is partitioned along axis 0 into contiguous, balanced row
  ranges (:func:`partition_rows`) — the ZeRO/optimizer-state layout;
* a shard directory holds one ``<name>.bin`` per array (C-order bytes of
  this rank's rows) and an ``ELASTIC.json`` index: per-array dtype, global
  shape, row offset/count, and per-chunk sha256 digests of the bin file;
* on restore, each *new* rank computes the row range it owns under the new
  world size, consults every old shard's index, and reads only the byte
  ranges that overlap its rows through the storage layer's ranged-read
  path (``external_storage.read_range``) — chunk digests verify exactly
  the chunks it touched, so a corrupted shard is refused without hashing
  whole files.

Covered layouts: N→M for any N, M (including N→1 and 1→M); M>N (new ranks
whose balanced partition is empty get zero-row slices); rank-0-only
checkpoints (one shard carrying full rows 0..R) restored into any world.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ray_tpu_torch._private import external_storage as _storage

ELASTIC_INDEX = "ELASTIC.json"
ELASTIC_VERSION = 1
# digest granularity of shard bin files: a ranged read rounds out to this
# grid, so it bounds both over-read and the verification unit
_CHUNK = 4 * 1024 * 1024


def partition_rows(total_rows: int, world_size: int) -> List[Tuple[int, int]]:
    """Balanced contiguous row partition: rank r owns ``[lo, hi)``. The
    first ``total_rows % world_size`` ranks get one extra row. With more
    ranks than rows, trailing ranks own empty ranges — legal (M>N growth
    past the row count) and round-trips through save/restore."""
    if world_size < 1:
        raise ValueError(f"world_size must be >= 1, got {world_size}")
    if total_rows < 0:
        raise ValueError(f"total_rows must be >= 0, got {total_rows}")
    q, rem = divmod(total_rows, world_size)
    out = []
    lo = 0
    for r in range(world_size):
        hi = lo + q + (1 if r < rem else 0)
        out.append((lo, hi))
        lo = hi
    return out


def _chunk_digests(data: memoryview) -> List[str]:
    return [
        hashlib.sha256(data[off : off + _CHUNK]).hexdigest()
        for off in range(0, len(data), _CHUNK)
    ] or []


def save_elastic_shard(
    dest_dir: str,
    arrays: Dict[str, Any],
    *,
    rank: int = 0,
    world_size: int = 1,
    extra: Optional[dict] = None,
) -> dict:
    """Write one rank's elastic shard into ``dest_dir``.

    ``arrays`` values are either a *global* array (every rank holds the
    full replica — the common data-parallel case; this rank's balanced row
    partition is sliced out and saved) or a ``(local_slice, row_offset,
    global_rows)`` tuple for callers that already hold only their slice
    (ZeRO-style sharded optimizer state). ``extra`` is a small JSON
    metadata dict (step, hyperparameters, ...) returned verbatim on
    restore. Returns the written index."""
    os.makedirs(dest_dir, exist_ok=True)
    index: Dict[str, Any] = {
        "version": ELASTIC_VERSION,
        "rank": int(rank),
        "world_size": int(world_size),
        "arrays": {},
        "extra": extra or {},
    }
    for name, value in arrays.items():
        if "/" in name or os.sep in name or name in (ELASTIC_INDEX,):
            raise ValueError(f"illegal elastic array name {name!r}")
        if isinstance(value, tuple):
            local, row_offset, global_rows = value
            local = np.ascontiguousarray(local)
            if local.ndim < 1:
                raise ValueError(f"array {name!r} must have ndim >= 1")
            if row_offset < 0 or row_offset + local.shape[0] > global_rows:
                raise ValueError(
                    f"array {name!r}: slice [{row_offset}, "
                    f"{row_offset + local.shape[0]}) outside 0..{global_rows}"
                )
            global_shape = (int(global_rows),) + tuple(local.shape[1:])
        else:
            full = np.ascontiguousarray(value)
            if full.ndim < 1:
                raise ValueError(f"array {name!r} must have ndim >= 1")
            lo, hi = partition_rows(full.shape[0], world_size)[rank]
            local, row_offset = full[lo:hi], lo
            global_shape = tuple(full.shape)
        data = memoryview(np.ascontiguousarray(local)).cast("B")
        fname = f"{name}.bin"
        with open(os.path.join(dest_dir, fname), "wb") as fh:
            fh.write(data)
        index["arrays"][name] = {
            "file": fname,
            "dtype": np.dtype(local.dtype).str,
            "global_shape": [int(s) for s in global_shape],
            "row_offset": int(row_offset),
            "rows": int(local.shape[0]),
            "chunk": _CHUNK,
            "chunk_digests": _chunk_digests(data),
        }
    with open(os.path.join(dest_dir, ELASTIC_INDEX), "w") as fh:
        json.dump(index, fh, sort_keys=True, indent=1)
    return index


def _join(prefix: str, name: str) -> str:
    if _storage.has_scheme(prefix):
        return _storage.join(prefix, name)
    return os.path.join(prefix, name)


def _read_index(shard_prefix: str) -> Optional[dict]:
    blob = _storage.read_bytes(_join(shard_prefix, ELASTIC_INDEX))
    if blob is None:
        return None
    try:
        index = json.loads(blob)
    except ValueError as e:
        raise _storage.IntegrityError(
            f"corrupt elastic index under {shard_prefix}: {e}"
        ) from e
    if index.get("version") != ELASTIC_VERSION:
        raise _storage.IntegrityError(
            f"unsupported elastic index version {index.get('version')!r} "
            f"under {shard_prefix}"
        )
    return index


def discover_shards(source: str) -> List[str]:
    """Shard prefixes (each holding an ``ELASTIC.json``) under one step
    prefix. A world-of-one checkpoint collapses the shard into the step
    dir itself; a committed prefix is discovered through its manifest so
    the index files we are about to trust are exactly the committed
    ones."""
    return _discover(source.rstrip("/"))[1]


def _discover(source: str, manifest: Optional[dict] = None):
    """(committed manifest or None, sorted shard prefixes) — one manifest
    read serves discovery AND per-shard index verification."""
    if manifest is None:
        manifest = _storage.read_committed_manifest(source)
    names: set = set()
    if manifest is not None:
        for rel in manifest.get("files", {}):
            rel = rel.replace(os.sep, "/")
            if rel == ELASTIC_INDEX:
                names.add("")
            elif rel.endswith("/" + ELASTIC_INDEX):
                names.add(rel[: -len("/" + ELASTIC_INDEX)])
    elif _storage.has_scheme(source) and not source.startswith("file://"):
        for key in _storage.list_uri(source + "/"):
            if key.endswith("/" + ELASTIC_INDEX):
                rest = key[len(source) + 1 :]
                shard = rest[: -len("/" + ELASTIC_INDEX)]
                names.add("" if shard == "" else shard)
            elif key == _join(source, ELASTIC_INDEX):
                names.add("")
    else:
        root = source[len("file://") :] if source.startswith("file://") else source
        if os.path.isfile(os.path.join(root, ELASTIC_INDEX)):
            names.add("")
        if os.path.isdir(root):
            for name in os.listdir(root):
                if os.path.isfile(os.path.join(root, name, ELASTIC_INDEX)):
                    names.add(name)
    return manifest, sorted(_join(source, n) if n else source for n in names)


def is_elastic(source: str) -> bool:
    """Whether a step prefix (or single shard dir) carries elastic
    indexes — i.e. :func:`load_elastic_state` can re-shard it."""
    return bool(discover_shards(source))


def _verify_index_against_manifest(
    source: str, shard_prefix: str, manifest: Optional[dict]
) -> None:
    """When the step prefix is committed, the index file itself must match
    its manifest entry — the chunk digests we are about to trust inherit
    the manifest's integrity."""
    if manifest is None:
        return
    rel = ELASTIC_INDEX
    if shard_prefix != source:
        shard_name = shard_prefix[len(source) + 1 :]
        rel = f"{shard_name}/{ELASTIC_INDEX}"
    entry = manifest.get("files", {}).get(rel) or manifest.get("files", {}).get(
        rel.replace("/", os.sep)
    )
    if entry is None:
        raise _storage.IntegrityError(
            f"{source}: elastic index {rel!r} not in the committed manifest"
        )
    _storage.verify_file(source, rel, entry)


def load_elastic_state(
    source: str,
    *,
    rank: int = 0,
    world_size: int = 1,
    arrays: Optional[List[str]] = None,
) -> Tuple[Dict[str, np.ndarray], dict]:
    """Restore this rank's row partition of every array from an elastic
    checkpoint committed at ANY world size.

    ``source`` is a step prefix (local path or URI) — or a single shard
    dir for world-of-one layouts. Each requested array is materialized as
    this rank's balanced partition under ``world_size``
    (:func:`partition_rows` of its global rows); the bytes are assembled
    from whichever old shards overlap, via ranged reads rounded out to
    the digest-chunk grid, and every chunk read is verified against the
    shard index's sha256 before a byte of it lands in the result. Raises
    :class:`~ray_tpu_torch._private.external_storage.IntegrityError` on any
    digest mismatch, truncated shard, or uncovered row range.

    Returns ``(arrays, extra)``: name → this rank's slice (C-contiguous
    ndarray; zero-row slices when the partition is empty), and the saver's
    ``extra`` metadata (rank 0's copy when ranks disagree).
    """
    if not 0 <= rank < world_size:
        raise ValueError(
            f"rank must be in [0, world_size): got rank={rank}, "
            f"world_size={world_size}"
        )
    source = source.rstrip("/")
    manifest, shard_prefixes = _discover(source)
    if not shard_prefixes:
        raise _storage.IntegrityError(
            f"no elastic shard indexes under {source} — not an elastic "
            f"checkpoint (save with save_elastic_shard / train.report_elastic)"
        )
    indexes: List[Tuple[str, dict]] = []
    for sp in shard_prefixes:
        _verify_index_against_manifest(source, sp, manifest)
        idx = _read_index(sp)
        if idx is not None:
            indexes.append((sp, idx))
    if not indexes:
        raise _storage.IntegrityError(f"no readable elastic index under {source}")
    # one step = one save generation: shards from two world sizes in one
    # prefix are a torn mix of attempts (the writer clears stale layouts,
    # so this only trips on externally corrupted/hand-merged dirs) — the
    # overlap would silently interleave generations' rows
    worlds = {idx.get("world_size") for _sp, idx in indexes}
    if len(worlds) > 1:
        raise _storage.IntegrityError(
            f"{source}: shards from multiple world sizes {sorted(worlds)} "
            f"under one step — refusing a mixed-generation restore"
        )
    indexes.sort(key=lambda pair: pair[1].get("rank", 0))
    extra = dict(indexes[0][1].get("extra") or {})

    # union of array specs across shards, consistency-checked
    specs: Dict[str, dict] = {}
    for sp, idx in indexes:
        for name, meta in idx.get("arrays", {}).items():
            prev = specs.get(name)
            if prev is not None and (
                prev["dtype"] != meta["dtype"]
                or prev["global_shape"] != meta["global_shape"]
            ):
                raise _storage.IntegrityError(
                    f"{source}: shards disagree on array {name!r}: "
                    f"{prev['dtype']}{prev['global_shape']} vs "
                    f"{meta['dtype']}{meta['global_shape']}"
                )
            if prev is None:
                specs[name] = {
                    "dtype": meta["dtype"],
                    "global_shape": meta["global_shape"],
                }

    wanted = list(specs) if arrays is None else list(arrays)
    missing = [n for n in wanted if n not in specs]
    if missing:
        raise KeyError(f"{source}: arrays not in elastic checkpoint: {missing}")

    out: Dict[str, np.ndarray] = {}
    for name in wanted:
        spec = specs[name]
        dtype = np.dtype(spec["dtype"])
        gshape = tuple(int(s) for s in spec["global_shape"])
        rowbytes = int(np.prod(gshape[1:], dtype=np.int64)) * dtype.itemsize
        lo, hi = partition_rows(gshape[0], world_size)[rank]
        dest = np.empty((hi - lo,) + gshape[1:], dtype=dtype)
        if hi > lo:
            if rowbytes == 0:
                pass  # zero-width rows: nothing to read, shape is enough
            else:
                covered = _fill_from_shards(
                    source, indexes, name, dest, lo, hi, rowbytes
                )
                _check_coverage(source, name, lo, hi, covered)
        out[name] = dest
    return out, extra


def _fill_from_shards(
    source: str,
    indexes: List[Tuple[str, dict]],
    name: str,
    dest: np.ndarray,
    lo: int,
    hi: int,
    rowbytes: int,
) -> List[Tuple[int, int]]:
    """Assemble dest rows [lo, hi) of one array from every old shard that
    overlaps, with chunk-verified ranged reads. Returns the covered row
    intervals."""
    dest_bytes = memoryview(dest).cast("B")
    covered: List[Tuple[int, int]] = []
    for sp, idx in indexes:
        meta = idx.get("arrays", {}).get(name)
        if meta is None:
            continue
        olo = int(meta["row_offset"])
        ohi = olo + int(meta["rows"])
        ilo, ihi = max(lo, olo), min(hi, ohi)
        if ihi <= ilo:
            continue
        chunk = int(meta.get("chunk") or _CHUNK)
        digests = meta.get("chunk_digests") or []
        file_size = int(meta["rows"]) * rowbytes
        # byte range inside the old shard's bin file, rounded out to the
        # digest-chunk grid so every chunk we read verifies
        b0 = (ilo - olo) * rowbytes
        b1 = (ihi - olo) * rowbytes
        c0 = (b0 // chunk) * chunk
        c1 = min(file_size, ((b1 + chunk - 1) // chunk) * chunk)
        buf = bytearray(c1 - c0)

        def make_dest(n, _want=c1 - c0, _buf=buf):
            return memoryview(_buf) if n == _want else None

        key = _join(sp, meta["file"])
        n = _storage.read_range(key, c0, c1 - c0, make_dest)
        if n != c1 - c0:
            raise _storage.IntegrityError(
                f"{source}: shard file {key} truncated or missing "
                f"(wanted bytes [{c0}, {c1}), got {n})"
            )
        view = memoryview(buf)
        for ci in range(c0 // chunk, (c1 + chunk - 1) // chunk):
            off = ci * chunk - c0
            piece = view[off : off + min(chunk, c1 - c0 - off)]
            if ci >= len(digests) or hashlib.sha256(piece).hexdigest() != digests[ci]:
                raise _storage.IntegrityError(
                    f"{source}: digest mismatch in shard file {key} "
                    f"chunk {ci} — refusing to re-shard from a corrupt shard"
                )
        span = memoryview(buf)[b0 - c0 : b1 - c0]
        dest_bytes[(ilo - lo) * rowbytes : (ihi - lo) * rowbytes] = span
        covered.append((ilo, ihi))
    return covered


def _check_coverage(
    source: str, name: str, lo: int, hi: int, covered: List[Tuple[int, int]]
) -> None:
    covered.sort()
    cursor = lo
    for a, b in covered:
        if a > cursor:
            break
        cursor = max(cursor, b)
    if cursor < hi:
        raise _storage.IntegrityError(
            f"{source}: array {name!r} rows [{cursor}, {hi}) not covered by "
            f"any shard — incomplete elastic checkpoint"
        )


def load_elastic_full(
    source: str, *, arrays: Optional[List[str]] = None
) -> Tuple[Dict[str, np.ndarray], dict]:
    """The whole-array view (world of one): every array fully assembled.
    What a replicated data-parallel loop restores regardless of how many
    ranks saved — or will run."""
    return load_elastic_state(source, rank=0, world_size=1, arrays=arrays)

"""The port's data library (``ray_tpu_torch.data``) against the JAX
package's (``ray_tpu.data``), on the CPU: each runtime started once for the
module (two CPUs, no pre-started workers).

- ``tests/test_data.py``'s programs, each run through both packages on the
  same seeded numpy inputs: the rows, batch sizes, aggregates and plans
  they give must be equal (exactly: both sides run the same numpy code on
  the same blocks). The parquet cases skip where ``pyarrow`` is absent.
- ``iter_torch_batches(device="cpu")`` against ``iter_jax_batches`` on the
  same dataset and ``dtypes``: equal arrays, exactly; with ``sharding=``,
  rank 1 of a two-rank data mesh keeps the rows of the reference's shard on
  its second device. Without a card the default device (``"cuda"``)
  raises.
- ``DataParallelTrainer(datasets=...)`` (and ``TorchTrainer``'s) and
  ``train.get_dataset_shard`` against ``JaxTrainer``: the same totals at one
  worker, the same disjoint
  per-rank shards at two; a throttled dataset's waits land in the step
  plane's ``data_wait``, attributed to its operator, and the transfer in
  ``host_to_device``.
- BC fed by ``ray_tpu_torch.data.from_items`` against the reference fed by
  ``ray_tpu.data.from_items``: metrics and parameters after three training
  steps within ``tests/test_torch_rl_algos.py``'s offline tolerances.
- ``ray_tpu_torch.data`` has every public name of ``ray_tpu.data`` and
  imports neither ``jax`` nor ``ray_tpu``.
"""

import csv
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

import ray_tpu  # noqa: E402
import ray_tpu.data as RD  # noqa: E402
import ray_tpu_torch  # noqa: E402
import ray_tpu_torch.data as PD  # noqa: E402

# BC after three training steps: tests/test_torch_rl_algos.py's offline rule
BC_ATOL, BC_RTOL = 1e-5, 1e-4


@pytest.fixture(scope="module")
def runtimes():
    for R in (ray_tpu, ray_tpu_torch):
        if R.is_initialized():
            R.shutdown()
    try:
        ray_tpu.init(num_cpus=2, _system_config={"prestart_workers": False})
        ray_tpu_torch.init(num_cpus=2, _system_config={"prestart_workers": False})
        yield
    finally:
        ray_tpu_torch.shutdown()
        ray_tpu.shutdown()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A csv, a jsonl, two text files and (with pyarrow) a parquet file."""
    d = tmp_path_factory.mktemp("files")
    with open(d / "t.csv", "w", newline="") as fh:
        w = csv.DictWriter(fh, fieldnames=["a", "b"])
        w.writeheader()
        for i in range(5):
            w.writerow({"a": i, "b": i * 2.5})
    with open(d / "t.json", "w") as fh:
        for i in range(3):
            fh.write(json.dumps({"v": i, "w": [i, i + 1]}) + "\n")
    os.makedirs(d / "text")
    for i in range(2):
        with open(d / "text" / f"p{i}.txt", "w") as fh:
            fh.write(f"line {i}a\nline {i}b\n")
    return d


def _plain(x):
    """Rows, blocks and aggregates as plain Python values, for equality."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return [_plain(v) for v in x.tolist()] if x.dtype == object else x.tolist()
    if isinstance(x, np.generic):
        return x.item()
    return x


# Each program takes (runtime module, data module, files dir) and returns
# what tests/test_data.py's case checks. The functions it hands to the
# library are lambdas or nested functions, pickled by value: a worker of
# the port never imports this module (and with it jax).


def _range_count_take(R, D, d):
    ds = D.range(100)
    return ds.count(), ds.take(5), ds.num_blocks()


def _map_batches(R, D, d):
    return D.range(100).map_batches(lambda b: {"id": b["id"] * 2}).take(3)


def _map_and_filter(R, D, d):
    ds = D.range(20).map(lambda r: {"id": r["id"] + 1}).filter(lambda r: r["id"] % 2 == 0)
    return ds.count(), ds.take_all()


def _flat_map(R, D, d):
    ds = D.from_items([1, 2]).flat_map(lambda r: [{"v": r["item"]}, {"v": r["item"] * 10}])
    return ds.take_all()


def _iter_batches_sizes(R, D, d):
    ds = D.range(100, num_blocks=7)
    return ([len(b["id"]) for b in ds.iter_batches(batch_size=32)],
            [len(b["id"]) for b in ds.iter_batches(batch_size=32, drop_last=True)],
            [b["id"] for b in ds.iter_batches(batch_size=30)])


def _map_batches_rebatched(R, D, d):
    ds = D.range(50, num_blocks=3).map_batches(lambda b: {"n": np.array([len(b["id"])])},
                                               batch_size=16)
    return ds.take_all(), ds.num_blocks()


def _repartition(R, D, d):
    ds = D.range(100).repartition(5)
    return ds.num_blocks(), ds.count(), ds.take_all()


def _split(R, D, d):
    return ([s.take_all() for s in D.range(100).split(4, equal=True)],
            [s.take_all() for s in D.range(10, num_blocks=5).split(2)])


def _streaming_split(R, D, d):
    its = D.range(64).streaming_split(2, equal=True)

    def consume(it):
        return sum(int(b["id"].sum()) for b in it.iter_batches(batch_size=8))

    return R.get([R.remote(consume).remote(it) for it in its], timeout=120)


def _union_zip_limit(R, D, d):
    u = D.range(10).union(D.range(10).map(lambda r: {"id": r["id"] + 100}))
    z = D.range(5).zip(D.range(5).map(lambda r: {"other": r["id"] * 2}))
    a = D.from_items([{"a": i} for i in range(6)], num_blocks=2)
    b = D.from_items([{"b": i} for i in range(6)], num_blocks=3)
    return u.take_all(), z.take_all(), D.range(100).limit(7).take_all(), a.zip(b).take_all()


def _random_shuffle(R, D, d):
    return (D.range(50).random_shuffle(seed=0).take_all(),
            D.range(200, num_blocks=4).random_shuffle(seed=3).take_all())


def _random_sample_take_batch(R, D, d):
    ds = D.range(100, num_blocks=4)
    return ds.random_sample(0.3, seed=5).take_all(), ds.take_batch(7)


def _from_numpy_schema(R, D, d):
    ds = D.from_numpy(np.arange(30, dtype=np.float32).reshape(10, 3), column="x")
    dd = D.from_numpy({"a": np.arange(6), "b": np.ones((6, 2), np.int32)}, num_blocks=2)
    return ds.schema(), ds.count(), ds.take(2), dd.schema(), dd.take_all()


def _sort(R, D, d):
    vals = np.random.default_rng(0).permutation(500).astype(np.int64)
    ds = D.from_numpy({"x": vals}).repartition(5)
    return ds.sort("x").to_block(), ds.sort("x", descending=True).to_block()


def _groupby_aggregate(R, D, d):
    n = 300
    ds = D.from_numpy({"k": np.arange(n) % 3, "v": np.arange(n, dtype=np.float64)}).repartition(4)
    g = ds.groupby("k")
    return [g.sum("v").to_block(), g.count().to_block(), g.mean("v").to_block(),
            g.std("v").to_block(), g.min("v").to_block(), g.max("v").to_block(),
            g.aggregate(D.Count(), D.Sum("v")).to_block()]


def _global_aggregates(R, D, d):
    ds = D.from_numpy({"v": np.arange(100, dtype=np.float64)}).repartition(3)
    return (ds.sum("v"), ds.min("v"), ds.max("v"), ds.mean("v"), ds.std("v"),
            ds.aggregate(D.Count(), D.Mean("v"), D.Std("v", ddof=0)))


def _map_groups(R, D, d):
    ds = D.from_numpy({"k": np.arange(60) % 2, "v": np.ones(60)})
    return ds.groupby("k").map_groups(
        lambda g: {"k": g["k"][:1], "total": np.array([g["v"].sum()])}).to_block()


def _actor_pool(R, D, d):
    class AddBias:
        def __init__(self):
            self.bias = 5.0  # expensive set-up, once per pool actor

        def __call__(self, block):
            return {"x": block["x"] + self.bias}

    ds = D.from_numpy({"x": np.arange(40, dtype=np.float64)}).repartition(4)
    out = ds.map_batches(AddBias, compute=D.ActorPoolStrategy(size=2))
    return np.sort(out.to_block()["x"])


def _column_ops(R, D, d):
    ds = D.from_items([{"a": i, "b": i * 2, "c": i * 3} for i in range(6)])
    out = ds.drop_columns(["c"]).rename_columns({"b": "bb"}).select_columns(["bb"]).take_all()
    added = ds.add_column("d", lambda b: b["a"] + b["c"]).take_all()
    return out, added, ds.unique("b")


def _optimizer_pushdown(R, D, d):
    from importlib import import_module

    opt = import_module(f"{D.__name__}.optimizer")
    chains = [
        [("select", ["a", "b"]), ("select", ["b", "a"])],
        [("drop", ["a"]), ("drop", ["b"])],
        [("select", ["a", "b"]), ("drop", ["c"])],
        [("select", ["a"]), ("select", ["b"])],
        [("select", ["a", "b"]), ("drop", ["b"])],
        [("rename", {"a": "b"}), ("rename", {"b": "c", "x": "y"})],
        [("rename", {"a": "b"}), ("select", ["b", "c"])],
        [("rename", {"a": "b"}), ("drop", ["b", "a"])],
    ]
    return [opt.optimize_ops(c) for c in chains]


def _read_csv_json(R, D, d):
    return (D.read_csv(str(d / "t.csv")).take_all(),
            D.read_json(str(d / "t.json")).take_all(),
            D.read_text(str(d / "text")).take_all())


def _write_read_roundtrip(R, D, d):
    ds = D.from_items([{"a": i, "b": float(i) / 4} for i in range(9)], num_blocks=3)
    out = str(d / f"out_{D.__name__}")
    files = ds.write_csv(out)
    ds.write_json(out + "_json")
    return ([os.path.basename(f) for f in files], D.read_csv(out).take_all(),
            D.read_json(out + "_json").take_all())


def _parquet(R, D, d):
    pa = pytest.importorskip("pyarrow")
    import pyarrow.parquet as pq

    p = d / "t.parquet"
    if not p.exists():
        pq.write_table(pa.table({"a": [1, 2, 3], "b": [4.0, 5.0, 6.0], "c": ["x", "y", "z"]}), p)
    from importlib import import_module

    opt = import_module(f"{D.__name__}.optimizer")
    ds = D.read_parquet(str(p)).select_columns(["a", "b"])
    src, stages = opt.optimize_plan(ds._block_refs, ds._stages)
    ds2 = D.read_parquet(str(p)).rename_columns({"a": "id"}).select_columns(["id"])
    src2, _ = opt.optimize_plan(ds2._block_refs, ds2._stages)
    return (src[0].columns, [len(s.ops) for s in stages], ds.take_all(), src2[0].columns,
            ds2.take_all(), D.read_parquet(str(p), columns=["b"]).take_all(),
            D.read_parquet(str(p)).map_batches(lambda b: {"x2": b["a"] * 2}).take_all())


PROGRAMS = {f.__name__.lstrip("_"): f for f in (
    _range_count_take, _map_batches, _map_and_filter, _flat_map, _iter_batches_sizes,
    _map_batches_rebatched, _repartition, _split, _streaming_split, _union_zip_limit,
    _random_shuffle, _random_sample_take_batch, _from_numpy_schema, _sort,
    _groupby_aggregate, _global_aggregates, _map_groups, _actor_pool, _column_ops,
    _optimizer_pushdown, _read_csv_json, _write_read_roundtrip, _parquet,
)}


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_program_gives_the_reference_result(runtimes, files, name):
    program = PROGRAMS[name]
    want = _plain(program(ray_tpu, RD, files))
    got = _plain(program(ray_tpu_torch, PD, files))
    assert got == want


def test_missing_columns_raise_as_in_the_reference(runtimes):
    for D in (RD, PD):
        ds = D.from_items([{"a": i} for i in range(3)])
        with pytest.raises(Exception, match="select_columns: missing"):
            ds.select_columns(["nope"]).take_all()
        with pytest.raises(ValueError, match="different row counts"):
            D.range(5).zip(D.range(6)).take_all()


# -- the device feed -------------------------------------------------------


def _feed_dataset(D):
    rng = np.random.default_rng(7)
    return D.from_numpy({"x": rng.normal(size=(50, 3)), "y": rng.integers(0, 9, (50,)),
                         "z": rng.integers(0, 255, (50, 2, 2), dtype=np.uint8)}, num_blocks=3)


@pytest.mark.parametrize("drop_last", [False, True])
def test_iter_torch_batches_equal_iter_jax_batches(runtimes, drop_last):
    """The same dataset and dtypes through both feeds (exact: both cast
    the same numpy values)."""
    jb = list(_feed_dataset(RD).iter_jax_batches(
        batch_size=16, drop_last=drop_last, dtypes={"x": np.float32, "y": np.int32}))
    pb = list(_feed_dataset(PD).iter_torch_batches(
        batch_size=16, drop_last=drop_last, dtypes={"x": torch.float32, "y": torch.int32},
        device="cpu"))
    assert len(pb) == len(jb) == (3 if drop_last else 4)
    for p, j in zip(pb, jb):
        assert sorted(p) == sorted(j)
        for k in j:
            assert p[k].device.type == "cpu"
            assert str(p[k].dtype).split(".")[1] == str(j[k].dtype)
            np.testing.assert_array_equal(p[k].numpy(), np.asarray(j[k]))


class _RankOfTwo:
    """Rank ``index`` of a two-rank data mesh, as ``shard_tensor`` reads
    one, on the CPU."""

    device = torch.device("cpu")

    def __init__(self, index):
        self.index = index

    def axis_size(self, axes):
        return 2

    def axis_index(self, axes):
        return self.index


def test_iter_torch_batches_keep_the_ranks_shard(runtimes, cpu_mesh_devices):
    """``sharding=`` with a mesh: each rank keeps the rows that the
    reference's sharded ``device_put`` puts on its device."""
    from jax.sharding import Mesh, NamedSharding
    from jax.sharding import PartitionSpec as JP

    from ray_tpu_torch.parallel.sharding import PartitionSpec

    sharding = NamedSharding(Mesh(np.array(cpu_mesh_devices[:2]), ("data",)), JP("data"))
    jb = list(_feed_dataset(RD).iter_jax_batches(batch_size=16, sharding=sharding,
                                                 dtypes={"x": np.float32, "y": np.int32}))
    for rank in (0, 1):
        pb = list(_feed_dataset(PD).iter_torch_batches(
            batch_size=16, drop_last=True, sharding=PartitionSpec("data"),
            mesh=_RankOfTwo(rank), dtypes={"x": torch.float32, "y": torch.int32}))
        assert len(pb) == len(jb) == 3
        for p, j in zip(pb, jb):
            for k in j:
                shard = next(s for s in j[k].addressable_shards
                             if s.device == cpu_mesh_devices[rank])
                np.testing.assert_array_equal(p[k].numpy(), np.asarray(shard.data))
    with pytest.raises(ValueError, match="needs mesh"):
        next(iter(PD.range(4).iter_torch_batches(sharding=PartitionSpec("data"))))


def test_iter_torch_batches_default_device_needs_a_card(runtimes):
    it = PD.range(8).iter_torch_batches(batch_size=4)
    if torch.cuda.is_available():
        assert next(it)["id"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            next(it)
    assert PD.DataIterator(PD.range(4)).copy_stats() == {"batches": 0, "bytes": 0,
                                                         "copy_ms": 0.0}


# -- the Train library's dataset seams --------------------------------------


def _sum_loop_fn(train_module):
    def loop(config):
        train = __import__(train_module, fromlist=["x"])
        it = train.get_dataset_shard("train")
        total = sum(int(b["id"].sum()) for b in it.iter_batches(batch_size=16))
        train.report({"total": total, "config_keys": sorted(config),
                      "none": train.get_dataset_shard("missing") is None})

    return loop


def test_trainer_datasets_feed_get_dataset_shard(runtimes, tmp_path):
    """After tests/test_data.py's test_dataset_feeds_jax_trainer: the loop
    reads its shard through the instrumented API and gets a config without
    the internal ``__datasets__`` key."""
    from ray_tpu.train import JaxTrainer
    from ray_tpu.train import RunConfig as JRunConfig
    from ray_tpu.train import ScalingConfig as JScalingConfig
    from ray_tpu_torch.train import DataParallelTrainer, RunConfig, ScalingConfig, TorchTrainer

    ref = JaxTrainer(
        _sum_loop_fn("ray_tpu.train"), train_loop_config={"lr": 1},
        scaling_config=JScalingConfig(num_workers=1),
        run_config=JRunConfig(storage_path=str(tmp_path), name="ref"),
        datasets={"train": RD.DataIterator(RD.range(64))},
    ).fit()
    port = DataParallelTrainer(
        _sum_loop_fn("ray_tpu_torch.train"), train_loop_config={"lr": 1},
        scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(storage_path=str(tmp_path), name="port"),
        datasets={"train": PD.DataIterator(PD.range(64))},
    ).fit()
    # TorchTrainer passes datasets= on (its one worker joins a gloo group)
    torch_port = TorchTrainer(
        _sum_loop_fn("ray_tpu_torch.train"), train_loop_config={"lr": 1},
        scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(storage_path=str(tmp_path), name="torch_port"),
        datasets={"train": PD.range(64)},
    ).fit()
    for res in (ref, port, torch_port):
        assert res.error is None, res.error
        assert res.metrics["total"] == sum(range(64))
        assert res.metrics["config_keys"] == ["lr"] and res.metrics["none"]


def _rank_rows_fn(train_module, out_dir):
    def loop(config):
        train = __import__(train_module, fromlist=["x"])
        ctx = train.get_context()
        seen = []
        for batch in train.get_dataset_shard("train").iter_batches(batch_size=64):
            seen.extend(int(v) for v in batch["id"])
        with open(os.path.join(out_dir, f"rank{ctx.get_world_rank()}.txt"), "w") as fh:
            fh.write(",".join(map(str, sorted(seen))))
        train.report({"n": len(seen)})

    return loop


def _rank_rows(out_dir):
    out = {}
    for r in (0, 1):
        with open(os.path.join(out_dir, f"rank{r}.txt")) as fh:
            out[r] = {int(x) for x in fh.read().split(",") if x}
    return out


def test_two_ranks_get_the_reference_disjoint_shards(runtimes, tmp_path):
    """After tests/test_train_obs.py's test_dataset_shard_is_per_rank_disjoint:
    each rank a disjoint, lazy, round-robin shard with the stages applied."""
    from ray_tpu.train import JaxTrainer
    from ray_tpu.train import RunConfig as JRunConfig
    from ray_tpu.train import ScalingConfig as JScalingConfig
    from ray_tpu_torch.train import DataParallelTrainer, RunConfig, ScalingConfig

    seen = {}
    for name, Trainer, Run, Scaling, D, mod in (
        ("ref", JaxTrainer, JRunConfig, JScalingConfig, RD, "ray_tpu.train"),
        ("port", DataParallelTrainer, RunConfig, ScalingConfig, PD, "ray_tpu_torch.train"),
    ):
        out = tmp_path / name
        out.mkdir()
        res = Trainer(
            # half a CPU each: the map tasks get the module's other CPU
            _rank_rows_fn(mod, str(out)),
            scaling_config=Scaling(num_workers=2, resources_per_worker={"CPU": 0.5}),
            run_config=Run(storage_path=str(tmp_path), name=f"shard_{name}"),
            datasets={"train": D.range(64, num_blocks=8).map_batches(
                lambda b: {"id": b["id"] + 1000})},
        ).fit()
        assert res.error is None, res.error
        seen[name] = _rank_rows(str(out))
    assert seen["port"] == seen["ref"]
    assert seen["port"][0] and seen["port"][1] and not seen["port"][0] & seen["port"][1]
    assert seen["port"][0] | seen["port"][1] == set(range(1000, 1064))


def test_throttled_dataset_waits_land_in_data_wait(runtimes, tmp_path):
    """After tests/test_train_obs.py's test_ingest_stall_attribution_throttled_dataset:
    a slow map stage's waits land in ``data_wait`` attributed to it (or its
    source feed), and ``iter_torch_batches``' transfer in ``host_to_device``."""
    from ray_tpu_torch.train import DataParallelTrainer, RunConfig, ScalingConfig

    def loop(config):
        from ray_tpu_torch import train

        n = 0
        for batch in train.get_dataset_shard("train").iter_torch_batches(batch_size=8,
                                                                          device="cpu"):
            train.report({"rows": int(next(iter(batch.values())).shape[0])})
            n += 1
        assert n > 0

    def slow(block):
        time.sleep(0.04)
        return block

    res = DataParallelTrainer(
        loop, scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(storage_path=str(tmp_path), name="port_ingest"),
        datasets={"train": PD.range(32).map_batches(slow)},
    ).fit()
    assert res.error is None, res.error
    deadline = time.monotonic() + 20
    while True:
        d = ray_tpu_torch.train_timeline("port_ingest").to_dict()
        if d.get("steps_seen", 0) >= 4 or time.monotonic() > deadline:
            break
        time.sleep(0.2)
    assert d["steps_seen"] >= 3
    assert d["totals"]["data_wait_ms"] > 30.0, d["totals"]
    assert d["ops"] and sum(d["ops"].values()) > 10.0
    assert any("map" in op or op == "source" for op in d["ops"])
    h2d = [rec["stages"]["host_to_device_ms"] for s in d["steps"] for rec in s["ranks"].values()]
    assert any(v > 0 for v in h2d)
    from ray_tpu_torch.util.metrics import prometheus_text

    text = prometheus_text()
    assert "ray_tpu_torch_train_data_wait_ratio" in text


# -- offline RL fed by a dataset ---------------------------------------------


def _bc_rows(n=700, seed=0):
    rng = np.random.default_rng(seed)
    obs = rng.normal(scale=0.5, size=(n, 4)).astype(np.float32)
    actions = (obs[:, 2] + 0.25 * obs[:, 3] > 0).astype(np.int64)
    return [{"obs": o, "actions": a} for o, a in zip(obs, actions)]


def test_bc_fed_by_from_items_matches_the_reference(runtimes):
    import ray_tpu.rl as JR
    import ray_tpu_torch.rl as PR

    rows = _bc_rows()
    ja = JR.BCConfig().offline_data(RD.from_items(rows)).debugging(seed=0).build()
    pa = PR.BCConfig().offline_data(PD.from_items(rows)).debugging(seed=0).build(device="cpu")
    pa.set_state(ja.get_state())
    for _ in range(3):
        jm, pm = ja.train(), pa.train()
        assert sorted(pm) == sorted(jm)
        for k in jm:
            np.testing.assert_allclose(float(pm[k]), float(jm[k]), atol=BC_ATOL, rtol=BC_RTOL,
                                       err_msg=k)
    for a, b in zip(jax.tree.leaves(pa.get_state()["params"]),
                    jax.tree.leaves(ja.get_state()["params"])):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=BC_ATOL, rtol=0)


# -- the package ------------------------------------------------------------


def test_public_names_and_no_jax():
    assert set(RD.__all__) <= set(PD.__all__)
    for name in RD.__all__:
        assert hasattr(PD, name), name
    assert ray_tpu_torch.data is PD
    code = ("import sys, ray_tpu_torch, ray_tpu_torch.data, ray_tpu_torch.dag, "
            "ray_tpu_torch.train; ray_tpu_torch.data.range; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'ray_tpu')); "
            "print(bad); sys.exit(1 if bad else 0)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr

"""The port's mesh configuration and sharding rules against the JAX
package's, without processes: ``MeshConfig.resolve`` (its wildcard and its
errors), and ``logical_to_mesh_spec`` equal, entry for entry, to JAX's
``PartitionSpec`` for every TINY parameter and for the batch, on meshes of
the same shapes (the JAX side on the virtual CPU devices)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from ray_tpu.models import transformer as JT  # noqa: E402
from ray_tpu.parallel import mesh as jmesh  # noqa: E402
from ray_tpu.parallel import sharding as jsharding  # noqa: E402
from ray_tpu_torch.models import transformer as PT  # noqa: E402
from ray_tpu_torch.models.moe import moe_param_logical_axes  # noqa: E402
from ray_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from ray_tpu_torch.parallel import sharding as psharding  # noqa: E402

MESHES = [
    dict(data=2, fsdp=2),
    dict(fsdp=2, tensor=2),
    dict(context=2, tensor=2),
    dict(data=2, fsdp=2, tensor=2),
    dict(pipeline=2, tensor=2),
    dict(context=4),
    dict(expert=4),
    dict(data=8),
]


@pytest.mark.parametrize("sizes", [dict(data=-1, tensor=2), dict(fsdp=2, tensor=-1), dict(context=8)])
def test_resolve_matches_jax(sizes):
    assert pmesh.MeshConfig(**sizes).resolve(8) == jmesh.MeshConfig(**sizes).resolve(8)


@pytest.mark.parametrize("sizes", [dict(data=3, tensor=2), dict(data=-1, tensor=-1), dict(data=-1, tensor=3)])
def test_resolve_errors_match_jax(sizes):
    with pytest.raises(ValueError) as port_err:
        pmesh.MeshConfig(**sizes).resolve(8)
    with pytest.raises(ValueError) as jax_err:
        jmesh.MeshConfig(**sizes).resolve(8)
    assert str(port_err.value) == str(jax_err.value)


def test_constants_match_jax():
    assert pmesh.CANONICAL_ORDER == jmesh.CANONICAL_ORDER
    assert psharding.DEFAULT_LM_RULES == jsharding.DEFAULT_LM_RULES


def _meshes(sizes):
    n = int(np.prod(list(sizes.values())))
    jm = jmesh.create_mesh(jmesh.MeshConfig(**sizes), devices=jax.devices()[:n])
    pm = pmesh.AbstractMesh(pmesh.MeshConfig(**sizes).resolve(n))
    return jm, pm


@pytest.mark.parametrize("sizes", MESHES, ids=lambda s: ",".join(f"{k}={v}" for k, v in s.items()))
def test_param_specs_match_jax(sizes):
    jm, pm = _meshes(sizes)
    logical = PT.param_logical_axes(PT.TINY)
    assert logical == JT.param_logical_axes(JT.TINY)
    trees = [(logical, jsharding.DEFAULT_LM_RULES), (moe_param_logical_axes(), jsharding.DEFAULT_LM_RULES)]
    for tree, rules in trees:
        for name, axes in tree.items():
            want = jsharding.logical_to_mesh_spec(axes, rules, jm)
            got = psharding.logical_to_mesh_spec(axes, psharding.DEFAULT_LM_RULES, pm)
            assert tuple(got) == tuple(want), (name, got, want)
    assert tuple(psharding.batch_sharding(pm)) == tuple(jsharding.batch_sharding(jm).spec)


def test_spec_never_reuses_an_axis():
    pm = pmesh.AbstractMesh(dict(data=2, fsdp=2, tensor=2))
    spec = psharding.logical_to_mesh_spec(("embed", "embed", "mlp"), psharding.DEFAULT_LM_RULES, pm)
    assert tuple(spec) == ("fsdp", None, "tensor")


def test_parallel_modules_and_rank_jobs_leave_jax_out():
    """The rank processes import the port's parallel modules and the jobs
    module by name: none of them may bring in jax or ``ray_tpu``."""
    import pathlib
    import subprocess
    import sys

    root = pathlib.Path(__file__).resolve().parent.parent
    code = (
        "import sys; sys.path.insert(0, 'tests');"
        "import ray_tpu_torch.parallel.launch, ray_tpu_torch.parallel.pipeline,"
        " ray_tpu_torch.parallel.distributed, ray_tpu_torch.entry, test_torch_rank_jobs;"
        "bad=[m for m in sys.modules if m.split('.')[0] in ('jax','ray_tpu')];"
        "print(bad); sys.exit(1 if bad else 0)"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr

"""The port's mesh and sharding rules against the JAX package's
(`core/mesh.py`, `parallel/sharding.py`): the axes, every leaf's
PartitionSpec for the gar_tiny, gar_1b and gar_8b trees (JAX's built with
`jax.eval_shape`, the port's on the meta device, so no weights are made),
the replication of dimensions an odd mesh does not divide, and the dp
subgroup a batch shards over. No process group is needed here; the
multi-rank paths are held in tests/test_torch_parallel_train.py,
test_torch_tp_inference.py and test_torch_ulysses_ring.py."""

import jax
import pytest

from grasp_any_region_tpu.core import config as jcfg
from grasp_any_region_tpu.core import mesh as jmesh
from grasp_any_region_tpu_torch.core import config as tcfg
from grasp_any_region_tpu_torch.core import mesh as tmesh


def test_axes_and_mesh_spec_match_jax():
    assert tmesh.AXES == jmesh.AXES
    spec = tmesh.MeshSpec(data=2, fsdp=3, tensor=2, seq=1, pipe=1)
    jspec = jmesh.MeshSpec(data=2, fsdp=3, tensor=2, seq=1, pipe=1)
    assert spec.size == jspec.size == 12
    assert spec.axis_sizes() == jspec.axis_sizes()
    assert spec.shape == dict(zip(jmesh.AXES, jspec.axis_sizes()))


@pytest.mark.parametrize("preset", ["gar_tiny", "gar_1b", "gar_8b"])
def test_param_pspecs_equal_jax_for_every_leaf(preset):
    from jax.sharding import PartitionSpec as P

    from grasp_any_region_tpu.models import init_gar_params
    from grasp_any_region_tpu.parallel.sharding import param_pspecs as jax_pspecs
    from grasp_any_region_tpu_torch.models.gar import GARParams
    from grasp_any_region_tpu_torch.parallel.sharding import param_pspecs

    cfg_j = getattr(jcfg, preset)()
    shapes = jax.eval_shape(lambda: init_gar_params(jax.random.PRNGKey(0), cfg_j))
    want = {"/".join(str(k.key) for k in path): tuple(spec) for path, spec in
            jax.tree_util.tree_flatten_with_path(
                jax_pspecs(shapes), is_leaf=lambda x: isinstance(x, P))[0]}
    got = param_pspecs(GARParams(getattr(tcfg, preset)(), device="meta"))
    assert set(got) == set(want)
    assert got == want
    assert got["llm/blocks/wq"] == (None, "fsdp", "tensor")


def test_param_pspecs_pipe_puts_decoder_layers_on_pipe():
    from grasp_any_region_tpu_torch.models.gar import GARParams
    from grasp_any_region_tpu_torch.parallel.sharding import param_pspecs

    specs = param_pspecs(GARParams(tcfg.gar_tiny(), device="meta"), pipe=True)
    assert specs["llm/blocks/wo"] == ("pipe",)
    assert specs["llm/embed"] == ("tensor", "fsdp")


@pytest.mark.parametrize("spec,shape", [
    ((None, "fsdp", "tensor"), (2, 64, 64)),  # 64 % 3: fsdp dropped, tensor kept
    ((("data", "fsdp"), None), (64, 8)),      # data * fsdp = 3 does not divide 64
    (("tensor", None), (64, 8)),              # divides: unchanged
    (("fsdp",), (64,)),                       # dropped
    (("fsdp",), (96, 4)),                     # a short spec stays short
    (None, (4,)),
])
def test_sanitize_spec_matches_jax_on_odd_factorizations(spec, shape):
    from jax.sharding import PartitionSpec as P

    from grasp_any_region_tpu.parallel.sharding import sanitize_spec as jax_sanitize
    from grasp_any_region_tpu_torch.parallel.sharding import sanitize_spec

    mesh = jmesh.make_mesh(jmesh.MeshSpec(data=1, fsdp=3, tensor=2, seq=1),
                           devices=jax.devices()[:6])
    want = jax_sanitize(None if spec is None else P(*spec), shape, mesh)
    got = sanitize_spec(spec, shape, tmesh.MeshSpec(fsdp=3, tensor=2))
    assert got == tuple(want)


@pytest.mark.parametrize("b,spec,want", [
    (4, tmesh.MeshSpec(data=2, fsdp=2), ("data", "fsdp")),
    (4, tmesh.MeshSpec(data=2, fsdp=4), ("fsdp",)),   # the larger axis that divides
    (2, tmesh.MeshSpec(data=2, fsdp=3), ("data",)),
    (17, tmesh.MeshSpec(data=2, fsdp=2), ()),         # 17 tiles: repeated
    (3, tmesh.MeshSpec(tensor=2), ()),
])
def test_dp_axes_take_the_largest_dividing_subgroup(b, spec, want):
    """`_flash_sharded`'s choice (JAX `ops/attention.py:116-150`)."""
    from grasp_any_region_tpu_torch.parallel.sharding import dp_axes

    assert dp_axes(b, spec) == want


def test_make_mesh_of_one_rank_needs_no_process_group():
    mesh = tmesh.make_mesh(tmesh.MeshSpec(), device="cpu")
    assert mesh.size == 1 and mesh.group("fsdp") is None and mesh.index("data") == 0
    assert tmesh.single_device_mesh(device="cpu").coords == dict.fromkeys(tmesh.AXES, 0)
    with pytest.raises(ValueError, match="needs 2 ranks"):
        tmesh.make_mesh(tmesh.MeshSpec(fsdp=2), device="cpu")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        tmesh.make_mesh(tmesh.MeshSpec())  # the card unless asked for the CPU


def test_batch_pspecs_match_jax():
    """Every batch field shards its leading axis over (data, fsdp)."""
    from grasp_any_region_tpu.data.synthetic import synthetic_batch
    from grasp_any_region_tpu.parallel.sharding import batch_pspecs as jax_batch_pspecs
    from grasp_any_region_tpu_torch.data.synthetic import synthetic_batch as port_batch
    from grasp_any_region_tpu_torch.parallel.sharding import batch_pspecs

    jb, _, _ = synthetic_batch(jcfg.gar_tiny(), batch=2, grid=(1, 1), seed=0)
    tb, _, _ = port_batch(tcfg.gar_tiny(), batch=2, grid=(1, 1), seed=0, device="cpu")
    want = jax_batch_pspecs(jb)
    got = batch_pspecs(tb)
    for name in type(tb)._fields:
        w, g = getattr(want, name), getattr(got, name)
        assert (g is None) if w is None else g == tuple(w), name

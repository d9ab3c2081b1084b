"""The port's sharding rules and placements against the reference.

* For every parameter and cache leaf of the ten assigned archs' reduced
  configs, on a 16×16 ``("data", "model")`` and a 2×16×16
  ``("pod", "data", "model")`` mesh, the port's ``resolve_spec`` equals
  the reference's (``PARAM_RULES`` for parameters, ``RULES`` for caches,
  as ``tree_shardings`` applies them). The reference's ``resolve_spec``
  reads only the mesh's axis names and sizes, so a duck-typed mesh
  stands in for 256 devices on both sides; the cache shapes are the
  reference's ``init_cache`` shapes (``jax.eval_shape``), equal to the
  port's on ``meta``.
* On the production mesh over a fake process group of 256 ranks (rank 0,
  ``meta`` shards, nothing allocated), ``placements`` turns resolved
  specs into DTensor placements with the local shapes they promise,
  ``distribute_tree`` places a tree by them, and an indivisible dim is
  replicated, never split unevenly.
* ``CollectiveMeter`` names each redistribution's collective as NCCL
  issues it: ``Shard(0)`` -> ``Shard(1)`` is an all-to-all (DTensor
  issues an all-gather and a chunk on a CPU mesh, which has none), and
  ``torch.distributed.all_reduce`` over one mesh axis an all-reduce of
  that axis's size.
"""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # leave the other test workers their cores

from _config_parity import config_parity  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.distributed import sharding as ref_sharding  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro_torch.configs import ASSIGNED, get_config  # noqa: E402
from repro_torch.distributed import sharding as S  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch.hlo_analysis import CollectiveMeter  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.spec import (abstract_params, axes_tree,  # noqa
                                     is_spec, tree_leaves)
from torch.distributed.tensor import (DTensor, Replicate,  # noqa: E402
                                      Shard, distribute_tensor)


class FakeMesh:
    """Duck-typed mesh: axis names and a shape mapping, no devices."""

    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


MESHES = {"16x16": FakeMesh({"data": 16, "model": 16}),
          "2x16x16": FakeMesh({"pod": 2, "data": 16, "model": 16})}


def _leaves(specs_tree, axes):
    """(shape, logical axes) of every leaf of a spec tree."""
    return [(s.shape, a) for s, a in zip(
        tree_leaves(specs_tree, is_spec),
        tree_leaves(axes, S._is_axes))]


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ASSIGNED)
def test_resolve_spec_equals_reference_on_every_leaf(arch, mesh):
    m = MESHES[mesh]
    cfg = get_config(arch).reduced()
    ref_cfg = ref_get_config(arch).reduced()
    mine, must = config_parity(cfg, ref_cfg)
    assert mine == must
    model, ref_model = build_model(cfg), ref_build_model(ref_cfg)
    specs = model.specs()
    params = _leaves(specs, axes_tree(specs))
    ref_specs = ref_model.specs()
    ref_params = [(s.shape, s.axes) for s in jax.tree.leaves(
        ref_specs, is_leaf=lambda x: hasattr(x, "axes"))]
    assert [tuple(s) for s, _ in params] == [tuple(s) for s, _ in ref_params]
    for (shape, axes), (_, ref_axes) in zip(params, ref_params):
        assert tuple(axes) == tuple(ref_axes)
        got = S.resolve_spec(axes, shape, m, S.PARAM_RULES)
        want = ref_sharding.resolve_spec(axes, shape, m,
                                         ref_sharding.PARAM_RULES)
        assert P(*got) == want, (arch, shape, axes)
    B, T = 4, 64
    cache = model.init_cache(B, T, cfg.dtype, device="meta")
    ref_cache = jax.eval_shape(lambda: ref_model.init_cache(
        B, T, jnp.dtype(ref_cfg.dtype)))
    shapes = [tuple(t.shape) for t in tree_leaves(cache)]
    assert shapes == [tuple(t.shape) for t in jax.tree.leaves(ref_cache)]
    axes = tree_leaves(model.cache_axes(), S._is_axes)
    ref_axes = jax.tree.leaves(ref_model.cache_axes(), is_leaf=S._is_axes)
    assert [tuple(a) for a in axes] == [tuple(a) for a in ref_axes]
    for shape, ax in zip(shapes, axes):
        got = S.resolve_spec(ax, shape, m, S.RULES)
        want = ref_sharding.resolve_spec(ax, shape, m, ref_sharding.RULES)
        assert P(*got) == want, (arch, shape, ax)


@pytest.fixture
def production_mesh():
    """Rank 0 of the 16×16 production mesh over a fake group of 256."""
    with D.fake_group(256):
        yield make_production_mesh(device_type="cpu")


def test_placements_and_local_shapes(production_mesh):
    mesh = production_mesh
    assert mesh.device_mesh is not None and mesh.size == 256
    assert mesh.shape == {"data": 16, "model": 16}
    # olmo-1b's stacked query weight: FSDP over data, heads over model
    spec = S.resolve_spec(("layers", "embed", "heads", "head_dim"),
                          (16, 2048, 16, 128), mesh, S.PARAM_RULES)
    assert spec == (None, "data", "model", None)
    assert S.placements(spec, mesh) == (Shard(1), Shard(2))
    assert S.named_sharding(("batch", None), (32, 7),
                            mesh).placements == (Shard(0), Replicate())
    w = S.distribute(torch.empty(16, 2048, 16, 128, device="meta"),
                     S.placements(spec, mesh), mesh)
    assert isinstance(w, DTensor) and tuple(w.shape) == (16, 2048, 16, 128)
    assert tuple(w.to_local().shape) == (16, 128, 1, 128)
    assert w.to_local().device.type == "meta"
    # whisper's 6 heads do not divide 16: replicated, never uneven
    spec = S.resolve_spec(("embed", "heads", "head_dim"), (384, 6, 64),
                          mesh, S.PARAM_RULES)
    assert S.placements(spec, mesh) == (Shard(0), Replicate())
    # a tree: parameters by PARAM_RULES, a cache by the active rules
    cfg = get_config("olmo-1b")
    model = build_model(cfg)
    specs = model.specs()
    with S.use_mesh(mesh):
        placed = S.distribute_tree(abstract_params(specs, cfg.dtype),
                                   axes_tree(specs), mesh, params=True)
        cache = S.distribute_tree(model.init_cache(32, 1024, cfg.dtype,
                                                   device="meta"),
                                  model.cache_axes(), mesh)
    tok = placed["embed"]["tok"]            # (vocab, embed)
    assert tok.placements == (Shard(1), Shard(0))
    assert tuple(tok.to_local().shape) == (cfg.vocab_padded // 16, 2048 // 16)
    k = cache["layers"]["sub0"]["k"]        # (layers, batch, seq, kv, hd)
    assert k.placements == (Shard(1), Shard(2))
    assert tuple(k.to_local().shape) == (16, 2, 64, 16, 128)
    sh = S.tree_shardings(axes_tree(specs), abstract_params(specs), mesh,
                          params=True)
    assert sh["embed"]["tok"].placements == tok.placements


def test_meter_names_the_collectives_nccl_issues(production_mesh):
    dm = production_mesh.device_mesh
    x = distribute_tensor(torch.empty(64, 64, device="meta"), dm,
                          [Shard(0), Replicate()], src_data_rank=None)
    meter = CollectiveMeter()
    with meter:
        y = x.redistribute(dm, [Shard(1), Replicate()])
        z = x.redistribute(dm, [Replicate(), Replicate()])
        t = torch.empty(8, device="meta")
        torch.distributed.all_reduce(t, group=dm.get_group("model"))
    assert y.placements == (Shard(1), Replicate())
    assert tuple(y.to_local().shape) == (64, 4)
    assert tuple(z.to_local().shape) == (64, 64)
    assert meter.records == [("all-to-all", 64 * 4 * 4, 16),
                             ("all-gather", 64 * 64 * 4, 16),
                             ("all-reduce", 8 * 4, 16)]


def test_fake_group_refuses_a_second_group(production_mesh):
    with pytest.raises(RuntimeError, match="already up"):
        with D.fake_group(256):
            pass

"""The port's logical-axis sharding (``repro_torch/sharding``) against the
JAX package's (``repro/sharding``), compared exactly.

* Every case of tests/test_sharding.py, on the port's ``spec_for_shape``
  and ``AxisRules.spec``, and a hypothesis sweep holding both packages'
  specs equal over shapes, logical axes, the four rule tables and both
  production meshes.
* For all ten architectures, under the four rule tables, on (16, 16)
  and (2, 16, 16): every param, decode-cache and optimizer-state leaf's
  spec equals the JAX one.  No device is needed on either side: the JAX
  trees are ``jax.eval_shape``'d and their specs computed with
  ``spec_for_shape`` over the JAX axes trees (``api.param_axes()``,
  ``api.cache_axes()``, ``optimizer_state_axes``) and the meshes' sizes;
  the port's trees are built under ``FakeTensorMode``.  A port leaf of a
  layer list is one layer of a stacked JAX leaf, whose spec is the
  port's with the (never sharded) ``layers`` axis in front.
* ``placements_for_spec`` gives the DTensor placements of those specs
  on a fake (2, 16, 16) process group.
* ``input_specs`` gives fake tensors of the JAX ``ShapeDtypeStruct``s'
  shapes and dtypes for every arch x shape.
"""
import functools

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from jax.tree_util import keystr, tree_flatten_with_path
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import INPUT_SHAPES as JAX_INPUT_SHAPES
from repro.configs import get_config as jax_get_config
from repro.configs import input_specs as jax_input_specs
from repro.configs import shapes_for_arch as jax_shapes_for_arch
from repro.models.registry import build_model as jax_build_model
from repro.models.registry import rules_for_mode as jax_rules_for_mode
from repro.optim.optimizers import make_optimizer as jax_make_optimizer
from repro.optim.optimizers import optimizer_state_axes as jax_opt_axes
from repro.sharding.partitioning import spec_for_shape as jax_spec_for_shape
from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config, input_specs, shapes_for_arch
from repro_torch.models.registry import TP_MODES, build_model, rules_for_mode
from repro_torch.optim.optimizers import make_optimizer, optimizer_state_axes
from repro_torch.sharding.axes import (
    LOGICAL_RULES_FSDP,
    LOGICAL_RULES_GATHER,
    LOGICAL_RULES_MEGATRON,
    LOGICAL_RULES_ZERO1,
    PartitionSpec as P,
    placements_for_spec,
)
from repro_torch.sharding.partitioning import spec_for_shape, spec_tree
from repro_torch.tree import is_layered, jax_path, tree_paths

SIZES = {"pod": 2, "data": 16, "model": 16}
MESHES = {"16x16": {"data": 16, "model": 16}, "2x16x16": SIZES}
DECODE = "decode_32k"


# --- tests/test_sharding.py's cases, on the port --------------------------


def test_megatron_basic_specs():
    spec = spec_for_shape(LOGICAL_RULES_MEGATRON, (4096, 14336), ("fsdp_embed", "mlp"), SIZES)
    assert spec == P(("pod", "data"), "model")


def test_gather_mode_keeps_weights_sharded_but_acts_replicated():
    w = spec_for_shape(LOGICAL_RULES_GATHER, (4096, 14336), ("embed", "mlp"), SIZES)
    assert w == P(None, "model")
    act = spec_for_shape(LOGICAL_RULES_GATHER, (256, 4096, 14336),
                         ("batch", None, "act_mlp"), SIZES)
    assert act == P(("pod", "data"))
    act_col = spec_for_shape(LOGICAL_RULES_GATHER, (256, 4096, 14336),
                             ("batch", None, "act_mlp_col"), SIZES)
    assert act_col == P(("pod", "data"), None, "model")


def test_non_divisible_axis_dropped():
    spec = spec_for_shape(LOGICAL_RULES_MEGATRON, (4096, 25, 64),
                          ("fsdp_embed", "heads", "head_dim"), SIZES)
    assert spec == P(("pod", "data"))
    spec = spec_for_shape(LOGICAL_RULES_MEGATRON, (8, 6144, 16384),
                          ("experts", "fsdp_embed", "expert_mlp"), SIZES)
    assert spec[0] is None


def test_mesh_axis_used_once():
    assert spec_for_shape(LOGICAL_RULES_MEGATRON, (64, 128), ("heads", "mlp"), SIZES) == P("model")


def test_partial_divisibility_of_compound_axis():
    assert spec_for_shape(LOGICAL_RULES_MEGATRON, (2, 128), ("batch", None), SIZES) == P("pod")
    assert spec_for_shape(LOGICAL_RULES_MEGATRON, (1, 128), ("batch", None), SIZES) == P()


@given(st.integers(min_value=1, max_value=4096),
       st.sampled_from(["batch", "mlp", "heads", "embed", "vocab", "experts"]))
@settings(max_examples=100, deadline=None)
def test_spec_always_divides(dim, axis):
    spec = spec_for_shape(LOGICAL_RULES_MEGATRON, (dim,), (axis,), SIZES)
    entry = spec[0] if len(spec) else None
    if entry is None:
        return
    axes = entry if isinstance(entry, tuple) else (entry,)
    assert dim % int(np.prod([SIZES[a] for a in axes])) == 0


def test_rules_spec_trailing_nones_trimmed():
    assert LOGICAL_RULES_MEGATRON.spec("batch", None, None) == P(("pod", "data"))


def test_fsdp_mode_folds_model_into_batch():
    act = spec_for_shape(LOGICAL_RULES_FSDP, (512, 4096, 4096),
                         ("batch", None, "act_embed"), SIZES)
    assert act == P(("pod", "data", "model"))
    act256 = spec_for_shape(LOGICAL_RULES_FSDP, (256, 4096, 4096),
                            ("batch", None, "act_embed"), SIZES)
    assert act256 == P(("pod", "data"))
    w = spec_for_shape(LOGICAL_RULES_FSDP, (4096, 11008), ("fsdp_embed", "mlp"), SIZES)
    assert w == P(("pod", "data", "model"))
    e = spec_for_shape(LOGICAL_RULES_FSDP, (128, 4096, 1536),
                       ("experts", "fsdp_embed", "expert_mlp"), SIZES)
    assert e[0] == "model"


def test_zero1_params_replicated_opt_sharded():
    assert spec_for_shape(LOGICAL_RULES_ZERO1, (4096, 11008), ("fsdp_embed", "mlp"), SIZES) == P()
    m = spec_for_shape(LOGICAL_RULES_ZERO1, (4096, 11008), ("opt_embed", "mlp"), SIZES)
    assert m == P(("pod", "data", "model"))


# --- both packages, compared exactly -------------------------------------


@pytest.mark.parametrize("mode", TP_MODES)
def test_rule_tables_equal_jax(mode):
    ours, theirs = rules_for_mode(mode), jax_rules_for_mode(mode)
    assert dict(ours.rules) == dict(theirs.rules) and ours.name == theirs.name


LOGICAL = sorted(LOGICAL_RULES_MEGATRON.rules) + [None, "unknown"]


@given(st.lists(st.tuples(st.integers(1, 1024), st.sampled_from(LOGICAL)), min_size=1,
                max_size=5),
       st.sampled_from(TP_MODES), st.sampled_from(sorted(MESHES)))
@settings(max_examples=300, deadline=None)
def test_spec_for_shape_equals_jax(dims, mode, mesh):
    shape = tuple(d for d, _ in dims)
    axes = tuple(a for _, a in dims)
    got = spec_for_shape(rules_for_mode(mode), shape, axes, MESHES[mesh])
    want = jax_spec_for_shape(jax_rules_for_mode(mode), shape, axes, MESHES[mesh])
    assert tuple(got) == tuple(want)
    assert tuple(rules_for_mode(mode).spec(*axes)) == tuple(jax_rules_for_mode(mode).spec(*axes))


# --- every leaf of every arch ---------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_trees(arch):
    api = jax_build_model(jax_get_config(arch))
    params = jax.eval_shape(lambda: api.init(jax.random.key(0)))
    b, s = JAX_INPUT_SHAPES[DECODE].global_batch, JAX_INPUT_SHAPES[DECODE].seq_len
    cache = jax.eval_shape(lambda: api.init_cache(b, s))
    opt = {name: jax.eval_shape(jax_make_optimizer(name).init, params)
           for name in ("sgd", "adam", "adafactor")}
    return api, params, cache, opt


@functools.lru_cache(maxsize=None)
def _port_trees(arch):
    api = build_model(get_config(arch))
    shape = INPUT_SHAPES[DECODE]
    with FakeTensorMode():
        params = api.init(torch.Generator().manual_seed(0), torch.device("cpu"))
        cache = api.init_cache(shape.global_batch, shape.seq_len)
        opt = {name: make_optimizer(name).init(params) for name in ("sgd", "adam", "adafactor")}
    return api, params, cache, opt


def _jax_specs(rules, axes, shapes, sizes):
    """{path: spec tuple} of a JAX tree, from its axes tree."""
    out = {}
    is_leaf = lambda x: isinstance(x, tuple) or x is None  # noqa: E731
    specs = jax.tree.map(
        lambda ax, s: tuple(jax_spec_for_shape(rules, s.shape, ax or (None,) * len(s.shape),
                                               sizes)),
        axes, shapes, is_leaf=is_leaf)
    for path, spec in tree_flatten_with_path(specs, is_leaf=lambda x: isinstance(x, tuple))[0]:
        out[tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)] = spec
    return out


def _compare(port_specs, jax_specs, what):
    """Each port leaf's spec against its JAX leaf's; every JAX leaf met."""
    seen = set()
    n = 0
    for path, spec in tree_paths(port_specs):
        if spec is None:  # a Python int ("t", "count")
            continue
        jp = jax_path(path)
        assert jp in jax_specs, f"{what}: {path} has no JAX leaf"
        want = jax_specs[jp]
        if is_layered(path):
            assert not want or want[0] is None, (what, path, want)
            want = want[1:]
        assert tuple(spec) == tuple(want), f"{what} {path}: {tuple(spec)} != {want}"
        seen.add(jp)
        n += 1
    missing = set(jax_specs) - seen - {("t",), ("count",)}
    assert not missing, f"{what}: JAX leaves without a port leaf: {sorted(missing)[:5]}"
    return n


@pytest.mark.parametrize("mode", TP_MODES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_leaf_spec_equals_jax(arch, mode):
    japi, jparams, jcache, jopt = _jax_trees(arch)
    tapi, tparams, tcache, topt = _port_trees(arch)
    jrules, trules = jax_rules_for_mode(mode), rules_for_mode(mode)
    jp_axes, tp_axes = japi.param_axes(), tapi.param_axes()
    for mesh, sizes in MESHES.items():
        tag = f"{arch} {mode} {mesh}"
        n = _compare(spec_tree(trules, tp_axes, tparams, sizes),
                     _jax_specs(jrules, jp_axes, jparams, sizes), f"{tag} params")
        assert n >= get_config(arch).num_layers
        _compare(spec_tree(trules, tapi.cache_axes(), tcache, sizes),
                 _jax_specs(jrules, japi.cache_axes(), jcache, sizes), f"{tag} cache")
        for name in ("sgd", "adam", "adafactor"):
            t_axes = optimizer_state_axes(name, tp_axes, tparams)
            j_axes = jax_opt_axes(name, jp_axes, jparams)
            got = spec_tree(trules, t_axes, topt[name], sizes)
            want = _jax_specs(jrules, j_axes, jopt[name], sizes)
            if name == "adafactor":  # the port's state is in the JAX layout already
                for path, spec in tree_paths(got):
                    if spec is not None:
                        assert tuple(spec) == want[path], (tag, name, path)
                assert {p for p, s in tree_paths(got) if s is not None} == set(want) - {
                    ("count",)}
            else:
                _compare(got, want, f"{tag} {name}")


def test_a_sharded_leaf_of_every_kind_is_met():
    """The comparison above is not vacuous: under megatron on (16, 16)
    yi-6b's embedding is vocab x fsdp sharded, hymba's 32001-row one only
    on fsdp and its heads replicated (25 heads), moonshot's experts
    sharded on model and mixtral's not."""
    sizes = MESHES["16x16"]
    rules = rules_for_mode("megatron")
    for arch, path, want in (
        ("yi-6b", ("embed", "table"), ("model", "data")),
        ("hymba-1.5b", ("embed", "table"), (None, "data")),
        ("hymba-1.5b", ("blocks", 0, "attn", "wq", "kernel"), ("data",)),
        ("moonshot-v1-16b-a3b", ("blocks", 0, "moe", "w_in"), ("model", "data")),
        ("mixtral-8x22b", ("blocks", 0, "moe", "w_in"), (None, "data")),
    ):
        api, params, _, _ = _port_trees(arch)
        specs = dict(tree_paths(spec_tree(rules, api.param_axes(), params, sizes)))
        assert tuple(specs[path]) == want, (arch, path, specs[path])


# --- placements on a fake production group ---------------------------------


@pytest.fixture
def fake_group():
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=512)
    yield
    dist.destroy_process_group()


def test_placements_on_the_production_mesh(fake_group):
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.launch.mesh import make_production_mesh, mesh_name
    from repro_torch.sharding.partitioning import param_sharding_for_tree

    mesh = make_production_mesh(multi_pod=True, device_type="cpu")
    assert mesh_name(mesh) == "2x16x16" and mesh.mesh_dim_names == ("pod", "data", "model")
    names = mesh.mesh_dim_names
    assert placements_for_spec(names, P(("pod", "data"), "model")) == (Shard(0), Shard(0),
                                                                      Shard(1))
    assert placements_for_spec(names, P(None, ("pod", "data", "model"))) == (Shard(1),) * 3
    assert placements_for_spec(names, P()) == (Replicate(),) * 3
    api, params, _, _ = _port_trees("yi-6b")
    rules = rules_for_mode("megatron")
    pl = dict(tree_paths(param_sharding_for_tree(mesh, api.param_axes(), rules, params)))
    specs = dict(tree_paths(spec_tree(rules, api.param_axes(), params, SIZES)))
    assert set(pl) == set(specs)
    for path, spec in specs.items():
        assert pl[path] == placements_for_spec(names, spec), path


def test_production_mesh_needs_its_world_size():
    from repro_torch.launch.mesh import make_production_mesh

    with pytest.raises(RuntimeError, match="256 ranks"):
        make_production_mesh(device_type="cpu")


# --- input stand-ins ---------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_equal_jax(arch):
    jcfg, tcfg = jax_get_config(arch), get_config(arch)
    assert shapes_for_arch(tcfg) == jax_shapes_for_arch(jcfg)
    for name in shapes_for_arch(tcfg):
        want = jax_input_specs(jcfg, JAX_INPUT_SHAPES[name])
        got = input_specs(tcfg, INPUT_SHAPES[name])
        assert sorted(got) == sorted(want), (arch, name)
        flat_want = {keystr(p): x for p, x in tree_flatten_with_path(want)[0]}
        flat_got = {}
        for path, x in tree_paths(got):
            flat_got[keystr(tuple(jax.tree_util.DictKey(k) for k in path))] = x
        for key, w in flat_want.items():
            g = flat_got[key]
            if key == "['cache']['t']":  # the port's position is a Python int
                assert g == 0 and w.shape == ()
                continue
            assert tuple(g.shape) == w.shape, (arch, name, key)
            assert str(g.dtype).replace("torch.", "") == str(w.dtype), (arch, name, key)


def test_restore_checkpoint_onto_a_mesh(tmp_path):
    """``checkpoint/io.py::restore_checkpoint(shardings=, mesh=)`` lays the
    restored leaves out on a mesh (the JAX package's ``shardings``): on
    the CPU's (1, 1) host mesh, DTensors with the given placements and
    the saved values."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.checkpoint.io import restore_checkpoint, save_checkpoint
    from repro_torch.launch.mesh import host_mesh

    tree = {"w": np.arange(12, dtype=np.float32).reshape(3, 4),
            "b": {"x": np.ones((5,), np.float32)}}
    save_checkpoint(str(tmp_path), 3, tree)
    with host_mesh("cpu") as mesh:
        pl = {"w": (Shard(0), Replicate()), "b": {"x": (Replicate(), Replicate())}}
        got = restore_checkpoint(str(tmp_path), shardings=pl, mesh=mesh)
        assert tuple(got["w"].placements) == pl["w"]
        np.testing.assert_array_equal(got["w"].full_tensor().numpy(), tree["w"])
        np.testing.assert_array_equal(got["b"]["x"].full_tensor().numpy(), tree["b"]["x"])

"""The port's training substrate against the JAX package: the token
stream (``data/pipeline.py``), the loss (``train/loss.py``), the
schedules and optimizers (``optim/``), the param and optimizer-state
converters (``convert.py``) and checkpoints (``checkpoint/io.py``).

The same numpy inputs, made from a seed, go through both packages.
Tolerances (fp32; the packages sum in different orders): the token
stream bit for bit; the loss rtol 1e-6 and its logits gradient atol
1e-7; the schedules rtol 1e-6 (one float32 ulp of the cosine); one and
three optimizer updates atol 1e-6 on params of O(1) and rtol 1e-5 on
the moments (a bf16 leaf within one bf16 step, rtol 2^-7).
tests/test_checkpoint.py's cases are mirrored on the port, and
checkpoints are read across in both directions, bf16 leaves included.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.tree_util import keystr, tree_flatten_with_path

from repro.checkpoint import io as jax_io
from repro.data.pipeline import synthetic_token_batches as jax_token_batches
from repro.optim import optimizers as jax_optim
from repro.optim.schedule import make_schedule as jax_make_schedule
from repro.train.loss import softmax_cross_entropy as jax_cross_entropy
from repro_torch import convert
from repro_torch.checkpoint import io
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.data.pipeline import synthetic_token_batches
from repro_torch.models.registry import build_model
from repro_torch.optim import optimizers
from repro_torch.optim.schedule import make_schedule
from repro_torch.train.loss import softmax_cross_entropy
from repro_torch.train.step import TrainState, init_train_state, make_train_step
from repro_torch.tree import tree_paths


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run torch on one intra-op thread: these tests share the host with
    the suite's timing-sensitive cluster tests, and need no more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _get(tree, path):
    for k in path:
        tree = tree[k.key]
    return tree


# ---------------------------------------------------------------------------
# data


@pytest.mark.parametrize("seed,stream_seed", [(0, None), (3, None), (3, 11)])
def test_token_stream_equals_jax(seed, stream_seed):
    ours = synthetic_token_batches(4, 12, 97, seed=seed, stream_seed=stream_seed)
    theirs = jax_token_batches(4, 12, 97, seed=seed, stream_seed=stream_seed)
    for _ in range(3):
        a, b = next(ours), next(theirs)
        assert sorted(a) == sorted(b) == ["labels", "tokens"]
        for k in a:
            assert a[k].dtype == b[k].dtype == np.int32
            np.testing.assert_array_equal(a[k], b[k])


# ---------------------------------------------------------------------------
# loss


@pytest.mark.parametrize("mask", [None, "bool", "float"])
@pytest.mark.parametrize("z_loss", [0.0, 1e-4])
def test_cross_entropy_matches_jax(mask, z_loss):
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((2, 5, 11)) * 3).astype(np.float32)
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
    m = None if mask is None else rng.random((2, 5)) < 0.6
    if mask == "float":
        m = m.astype(np.float32) * 0.5
    jm = None if m is None else jnp.asarray(m)
    want, want_g = jax.value_and_grad(
        lambda x: jax_cross_entropy(x, jnp.asarray(labels), mask=jm, z_loss=z_loss))(
        jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_(True)
    got = softmax_cross_entropy(x, torch.from_numpy(labels),
                                mask=None if m is None else torch.from_numpy(m),
                                z_loss=z_loss)
    got.backward()
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g), atol=1e-7, rtol=0)


def test_cross_entropy_of_bf16_logits_is_fp32():
    logits = torch.randn(2, 3, 7, generator=torch.Generator().manual_seed(0))
    labels = torch.tensor([[0, 1, 2], [3, 4, 5]])
    got = softmax_cross_entropy(logits.bfloat16(), labels)
    want = softmax_cross_entropy(logits.bfloat16().float(), labels)
    assert got.dtype == torch.float32 and torch.equal(got, want)


def test_cross_entropy_gather_equals_one_hot():
    gen = torch.Generator().manual_seed(0)
    logits = torch.randn(2, 5, 11, generator=gen)
    labels = torch.randint(0, 11, (2, 5), generator=gen)
    got = softmax_cross_entropy(logits, labels)
    one_hot = torch.nn.functional.one_hot(labels, 11)
    want = -torch.mean(torch.sum(torch.log_softmax(logits, -1) * one_hot, -1))
    assert np.isclose(float(got), float(want), rtol=1e-6)


# ---------------------------------------------------------------------------
# schedules


@pytest.mark.parametrize("lr,warmup,total", [(1.0, 10, 100), (3e-4, 7, 53), (1e-3, 0, 10)])
@pytest.mark.parametrize("kind", ["constant", "cosine", "wsd"])
def test_schedule_matches_jax_at_every_step(kind, lr, warmup, total):
    ours = make_schedule(kind, learning_rate=lr, warmup_steps=warmup, total_steps=total)
    theirs = jax_make_schedule(kind, learning_rate=lr, warmup_steps=warmup,
                               total_steps=total)
    got = np.array([ours(s) for s in range(total + 5)])
    want = np.array([float(theirs(jnp.array(s, jnp.int32))) for s in range(total + 5)])
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_schedules():
    """tests/test_train.py::test_schedules on the port."""
    for kind in ("constant", "cosine", "wsd"):
        f = make_schedule(kind, learning_rate=1.0, warmup_steps=10, total_steps=100)
        lrs = np.array([f(s) for s in range(100)])
        assert lrs[0] < lrs[9] <= 1.0
        assert lrs.max() <= 1.0 + 1e-6
        if kind == "cosine":
            assert lrs[-1] < 0.2
        if kind == "wsd":
            assert np.allclose(lrs[15:85], lrs[20], rtol=1e-6)
            assert lrs[-1] < 0.15


# ---------------------------------------------------------------------------
# optimizers


N_LAYERS = 3


def _tree(seed, *, bf16=False):
    """A JAX-layout tree with a ``blocks`` leaf stacked over 3 layers that
    is large enough to factor (128 x 160 a layer), small stacked leaves
    (a 1-d and a 2-d one), and unstacked leaves, one of them factored,
    one (optionally) bf16; numpy leaves."""
    rng = np.random.default_rng(seed)

    def n(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    tree = {
        "blocks": {"w": n(N_LAYERS, 128, 160, scale=0.1), "b": n(N_LAYERS, 16),
                   "s": n(N_LAYERS, 4, 8)},
        "embed": {"table": n(200, 8)},
        "head": n(130, 129, scale=0.05),
    }
    if bf16:
        tree["embed"]["table"] = tree["embed"]["table"].astype(jnp.bfloat16)
    return tree


def _grads(seed, tree):
    """Gradients like the tree, one leaf (``s``) far larger than the rest
    so that Adafactor's update clip binds there."""
    rng = np.random.default_rng(seed)
    g = jax.tree.map(lambda p: (rng.standard_normal(p.shape) * 0.01).astype(np.float32), tree)
    g["blocks"]["s"] = g["blocks"]["s"] * 1e3
    return g


def _port(tree):
    """The JAX-layout tree in the port's layout: ``blocks`` a list."""
    cfg = ModelConfig(arch_id="t", family="dense", num_layers=N_LAYERS, d_model=8,
                      num_heads=1, num_kv_heads=1, d_ff=8, vocab_size=200)
    return convert.lm_params_from_numpy(tree, cfg, "cpu"), cfg


@pytest.mark.parametrize("updates", [1, 3])
@pytest.mark.parametrize("name", ["sgd", "adam", "adafactor"])
def test_optimizer_updates_match_jax(name, updates):
    """Params and the whole state after 1 and 3 updates, on a tree with a
    bf16 leaf and stacked ``blocks`` leaves (Adafactor factors the 128 x
    160 layers of ``w`` on the stacked shape, and clips by RMS over all 3
    layers at once)."""
    tree = _tree(0, bf16=True)
    jopt = jax_optim.make_optimizer(name)
    topt = optimizers.make_optimizer(name)
    jp = jax.tree.map(jnp.asarray, tree)
    js = jopt.init(jp)
    tp, cfg = _port(tree)
    ts = topt.init(tp)
    lr = {"sgd": 0.1, "adam": 1e-2, "adafactor": 1e-2}[name]
    for i in range(updates):
        g = _grads(10 + i, tree)
        jp, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp, jnp.float32(lr))
        tg, _ = _port(g)
        tp, ts = topt.update(tg, ts, tp, np.float32(lr))
    got = convert.lm_params_to_numpy(tp, cfg)
    for path, want in tree_flatten_with_path(jax.tree.map(np.asarray, jp))[0]:
        leaf = _get(got, path)
        if isinstance(leaf, convert.BitView):
            assert str(want.dtype) == leaf.dtype == "bfloat16"
            leaf = convert.leaf_from_numpy(leaf, "cpu").float().numpy()
            np.testing.assert_allclose(leaf, want.astype(np.float32), rtol=2 ** -7,
                                       atol=1e-6, err_msg=keystr(path))
        else:
            assert leaf.dtype == want.dtype and leaf.shape == want.shape
            np.testing.assert_allclose(leaf, want, atol=1e-6, rtol=0, err_msg=keystr(path))
    gs = convert.opt_state_to_numpy(name, ts, cfg)
    jstate = jax.tree.map(np.asarray, js)
    assert jax.tree.structure(jstate) == jax.tree.structure(
        jax.tree.map(lambda x: x, gs))
    for path, want in tree_flatten_with_path(jstate)[0]:
        leaf = _get(gs, path)
        assert leaf.shape == want.shape and leaf.dtype == want.dtype, keystr(path)
        np.testing.assert_allclose(leaf, want, rtol=1e-5, atol=1e-12, err_msg=keystr(path))
    if name == "adafactor":
        assert sorted(js["v"]["blocks"]["w"]) == ["vc", "vr"]
        assert js["v"]["blocks"]["w"]["vr"].shape == (N_LAYERS, 128)


def test_adafactor_clip_binds_over_the_stacked_leaf():
    """Adafactor clips its update by its RMS over the whole JAX leaf: on
    the stacked ``s`` leaf, one RMS over all 3 layers.  A second update
    whose layer-0 gradients grew 100x against the first gives layer 0 a
    larger update than the others: the clip binds (stacked RMS 1), and
    no layer is clipped on its own (a per-layer clip would give each an
    RMS of 1)."""
    tree = _tree(1)
    tp, cfg = _port(tree)
    opt = optimizers.adafactor()
    jp = jax.tree.map(jnp.asarray, tree)
    jopt = jax_optim.adafactor()
    state, jstate = opt.init(tp), jopt.init(jp)
    for i, boost in enumerate((1.0, 100.0)):
        g = _grads(2 + i, tree)
        g["blocks"]["s"][0] *= boost
        prev = tp
        tp, state = opt.update(_port(g)[0], state, tp, 1.0)
        jp, jstate = jopt.update(jax.tree.map(jnp.asarray, g), jstate, jp, jnp.float32(1.0))
    steps = torch.stack([prev["blocks"][i]["s"] - tp["blocks"][i]["s"]
                         for i in range(N_LAYERS)])
    assert abs(float(torch.sqrt(torch.mean(steps ** 2))) - 1.0) < 1e-5
    per_layer = [float(torch.sqrt(torch.mean(s ** 2))) for s in steps]
    assert per_layer[0] > 1.1 and max(per_layer[1:]) < 0.95, per_layer
    for i in range(N_LAYERS):
        np.testing.assert_allclose(tp["blocks"][i]["s"].numpy(),
                                   np.asarray(jp["blocks"]["s"][i]), atol=1e-6)


# ---------------------------------------------------------------------------
# convert


def test_bf16_params_leave_as_bit_views_and_come_back():
    t = torch.randn(3, 5, generator=torch.Generator().manual_seed(0)).bfloat16()
    out = convert.params_to_numpy({"a": {"w": t}, "b": torch.ones(2)})
    assert isinstance(out["a"]["w"], convert.BitView)
    assert out["a"]["w"].dtype == "bfloat16" and out["a"]["w"].bits.dtype == np.uint16
    assert out["b"].dtype == np.float32
    back = convert.params_from_numpy(out, "cpu")
    assert back["a"]["w"].dtype == torch.bfloat16 and torch.equal(back["a"]["w"], t)
    # a JAX bf16 array through numpy (ml_dtypes) reads back to the same bits
    j = np.asarray(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16))
    assert torch.equal(convert.leaf_from_numpy(j, "cpu"), t)


def test_lm_params_restack_onto_the_layer_axis():
    tree = _tree(3, bf16=True)
    tp, cfg = _port(tree)
    assert isinstance(tp["blocks"], list) and len(tp["blocks"]) == N_LAYERS
    back = convert.lm_params_to_numpy(tp, cfg)
    for path, want in tree_flatten_with_path(tree)[0]:
        got = _get(back, path)
        if isinstance(got, convert.BitView):
            np.testing.assert_array_equal(got.bits, want.view(np.uint16))
        else:
            np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="blocks"):
        convert.lm_params_to_numpy(dict(tp, blocks=tp["blocks"][:2]), cfg)


# ---------------------------------------------------------------------------
# checkpoints


def test_roundtrip(tmp_path):
    """tests/test_checkpoint.py::test_roundtrip on the port."""
    tree = {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "b": {"c": torch.ones((2,), dtype=torch.int32),
                  "d": torch.tensor(3.5, dtype=torch.bfloat16)}}
    io.save_checkpoint(str(tmp_path), 7, tree)
    got = io.restore_checkpoint(str(tmp_path))
    assert torch.equal(got["a"], tree["a"]) and torch.equal(got["b"]["c"], tree["b"]["c"])
    assert got["b"]["d"].dtype == torch.bfloat16 and torch.equal(got["b"]["d"], tree["b"]["d"])


def test_latest_step_selection(tmp_path):
    for s in (3, 11, 5):
        io.save_checkpoint(str(tmp_path), s, {"x": torch.zeros(1)})
    assert io.latest_step(str(tmp_path)) == 11
    assert io.restore_checkpoint(str(tmp_path), step=5)["x"].shape == (1,)
    assert io.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        io.restore_checkpoint(str(tmp_path / "none"))


def test_training_resume_equivalence(tmp_path):
    """Save at step 2, restore, continue: the same params as 4 steps
    uninterrupted (tests/test_checkpoint.py's case, with the state saved
    in the JAX package's layout and read back through the converters)."""
    cfg = ModelConfig(arch_id="t", family="dense", num_layers=1, d_model=32, num_heads=2,
                      num_kv_heads=2, d_ff=64, vocab_size=32, dtype="float32",
                      param_dtype="float32")
    api = build_model(cfg)
    run = RunConfig(optimizer="sgd", learning_rate=0.1, max_grad_norm=None,
                    schedule="constant", warmup_steps=0)
    step = make_train_step(api, run)

    def batches():
        it = synthetic_token_batches(4, 8, cfg.vocab_size, seed=0)
        return ({k: torch.from_numpy(v) for k, v in next(it).items()} for _ in iter(int, 1))

    s = init_train_state(torch.Generator().manual_seed(0), api, run, "cpu")
    it = batches()
    for _ in range(4):
        s, _ = step(s, next(it))

    s2 = init_train_state(torch.Generator().manual_seed(0), api, run, "cpu")
    it = batches()
    for _ in range(2):
        s2, _ = step(s2, next(it))
    io.save_checkpoint(str(tmp_path), 2, {
        "params": convert.lm_params_to_numpy(s2.params, cfg),
        "opt": convert.opt_state_to_numpy("sgd", s2.opt_state, cfg)})
    restored = io.restore_checkpoint(str(tmp_path))
    s3 = TrainState(step=2, params=convert.lm_params_from_numpy(restored["params"], cfg, "cpu"),
                    opt_state=convert.opt_state_from_numpy("sgd", restored["opt"], cfg, "cpu"))
    for _ in range(2):
        s3, _ = step(s3, next(it))
    want, got = dict(tree_paths(s.params)), dict(tree_paths(s3.params))
    assert sorted(want, key=str) == sorted(got, key=str)
    for path, a in want.items():
        torch.testing.assert_close(got[path], a, atol=1e-6, rtol=0)


@pytest.mark.parametrize("name", ["sgd", "adam", "adafactor"])
def test_checkpoint_the_port_writes_restores_under_jax(tmp_path, name):
    """Params (one leaf bf16) and an optimizer state the port wrote, in
    the JAX layout, read back by ``repro.checkpoint.io`` to the same
    arrays and dtypes."""
    tree = _tree(4, bf16=True)
    tp, cfg = _port(tree)
    opt = optimizers.make_optimizer(name)
    tp, ts = opt.update(_port(_grads(5, tree))[0], opt.init(tp), tp, 1e-2)
    io.save_checkpoint(str(tmp_path), 3, {"params": convert.lm_params_to_numpy(tp, cfg),
                                          "opt": convert.opt_state_to_numpy(name, ts, cfg)})
    got = jax_io.restore_checkpoint(str(tmp_path))
    want = {"params": convert.lm_params_to_numpy(tp, cfg),
            "opt": convert.opt_state_to_numpy(name, ts, cfg)}
    for path, leaf in tree_flatten_with_path(got)[0]:
        w = _get(want, path)
        if isinstance(w, convert.BitView):
            assert str(leaf.dtype) == "bfloat16"
            np.testing.assert_array_equal(leaf.view(np.uint16), w.bits)
        else:
            assert leaf.dtype == w.dtype
            np.testing.assert_array_equal(leaf, w)


def test_checkpoint_jax_writes_restores_in_the_port(tmp_path):
    """A JAX-written tree (bf16, fp32 and int leaves; a stacked
    ``blocks``) restores into torch tensors of the same values and
    dtypes, and the params into the port's layout."""
    tree = jax.tree.map(jnp.asarray, _tree(6, bf16=True))
    tree["step"] = jnp.array(4, jnp.int32)
    jax_io.save_checkpoint(str(tmp_path), 4, tree)
    got = io.restore_checkpoint(str(tmp_path))
    assert got["embed"]["table"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["embed"]["table"].view(torch.int16).numpy(),
                                  np.asarray(tree["embed"]["table"]).view(np.int16))
    assert got["step"].dtype == torch.int32 and int(got["step"]) == 4
    np.testing.assert_array_equal(got["blocks"]["w"].numpy(), np.asarray(tree["blocks"]["w"]))
    _, cfg = _port(_tree(6))
    port = convert.lm_params_from_numpy({k: v for k, v in got.items() if k != "step"}, cfg,
                                        "cpu")
    assert len(port["blocks"]) == N_LAYERS
    assert torch.equal(port["blocks"][1]["w"], got["blocks"]["w"][1])

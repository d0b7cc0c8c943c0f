"""The port's train step against the JAX package's ``make_train_step``,
one step at a time: both packages start each step from the JAX state
(carried across with ``repro_torch.convert``), take the same numpy
batch, and their losses, metrics, params and optimizer states are
compared.  Shared by tests/test_torch_lm_train.py and
tests/test_torch_lm_train_zoo.py (each file runs in its own worker).

Tolerances (fp32 on the CPU; the packages sum in different orders):
loss and aux rtol 1e-5, grad_norm rtol 1e-4; every moment leaf max |Δ|
<= 1e-4 * max |want|; params atol 1e-5.  Adam's first step is about
lr * sign(g), and Adafactor's unfactored update is g / |g| scaled the
same way: where the JAX gradient of an element lies below 1e-5 of the
largest gradient in the tree, the two packages' float32 noise may take
opposite signs, so there the params are held only to twice the largest
step the JAX package took in that leaf.  The element's gradient comes
from the JAX second moment before and after the step: g^2 = (nu' -
b * nu) / (1 - b).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.tree_util import keystr, tree_flatten_with_path

from repro.configs import RunConfig as JaxRunConfig
from repro.configs import get_config as jax_get_config
from repro.configs import reduced_for_smoke as jax_reduced
from repro.data.pipeline import synthetic_token_batches
from repro.launch.train import add_modalities
from repro.models.registry import build_model as jax_build_model
from repro.train.step import init_train_state as jax_init_train_state
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch import convert
from repro_torch.configs import RunConfig, get_config, reduced_for_smoke
from repro_torch.models.registry import build_model
from repro_torch.train.step import TrainState, make_train_step

LR = {"sgd": 0.1, "adam": 1e-3, "adafactor": 1e-2}
LOSS_RTOL, GNORM_RTOL, STATE_RTOL, PARAM_ATOL, TINY_GRAD = 1e-5, 1e-4, 1e-4, 1e-5, 1e-5


def _get(tree, path):
    for k in path:
        tree = tree[k.key]
    return tree


def _params_to_port(tree, cfg):
    fn = (convert.encdec_params_from_numpy if cfg.num_encoder_layers
          else convert.lm_params_from_numpy)
    return fn(tree, cfg, "cpu")


def _params_to_numpy(params, cfg):
    fn = convert.encdec_params_to_numpy if cfg.num_encoder_layers else convert.lm_params_to_numpy
    return fn(params, cfg)


def _grad_sq(opt, before, after, count):
    """Each element's squared JAX gradient of the step, from the second
    moment (None where the state holds none per element)."""
    if opt == "adam":
        return jax.tree.map(lambda a, b: (b - 0.95 * a) / 0.05, before["nu"], after["nu"])
    if opt == "adafactor":
        beta = 1.0 - (count + 1.0) ** -0.8
        return jax.tree.map(
            lambda a, b: (b["v"] - beta * a["v"]) / (1 - beta) if "v" in a else None,
            before["v"], after["v"], is_leaf=lambda x: isinstance(x, dict) and (
                "v" in x or "vr" in x))
    return None


def check_step_parity(arch, opt, *, steps=2, batch=2, seq=8, **run_kw):
    """``steps`` steps of reduced ``arch`` with ``opt``, compared step by
    step (see the module docstring).  Returns the per-step records."""
    jcfg, tcfg = jax_reduced(jax_get_config(arch)), reduced_for_smoke(get_config(arch))
    kw = dict(optimizer=opt, learning_rate=LR[opt], warmup_steps=1, total_steps=10,
              remat="none", **run_kw)
    japi, tapi = jax_build_model(jcfg), build_model(tcfg)
    jstate = jax_init_train_state(jax.random.key(0), japi, JaxRunConfig(**kw))
    jstep = jax.jit(jax_make_train_step(japi, JaxRunConfig(**kw)))
    tstep = make_train_step(tapi, RunConfig(**kw))
    it = synthetic_token_batches(batch, seq, jcfg.vocab_size, seed=0)
    rng = np.random.default_rng(0)
    records = []
    for i in range(steps):
        host = add_modalities(next(it), jcfg, rng)
        jp = jax.tree.map(np.asarray, jstate.params)
        jo = jax.tree.map(np.asarray, jstate.opt_state)
        tstate = TrainState(int(jstate.step), _params_to_port(jp, tcfg),
                            convert.opt_state_from_numpy(opt, jo, tcfg, "cpu"))
        tstate, tm = tstep(tstate, {k: torch.from_numpy(v) for k, v in host.items()})
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in host.items()})
        rec = {k: (float(jm[k]), float(tm[k])) for k in jm}
        for k, rtol in (("loss", LOSS_RTOL), ("aux_loss", LOSS_RTOL),
                        ("grad_norm", GNORM_RTOL), ("lr", 1e-6)):
            if k in jm:
                np.testing.assert_allclose(rec[k][1], rec[k][0], rtol=rtol, atol=1e-7,
                                           err_msg=f"{arch} {opt} step {i} {k}")
        assert tstate.step == int(jstate.step)

        jo_new = jax.tree.map(np.asarray, jstate.opt_state)
        to_new = convert.opt_state_to_numpy(opt, tstate.opt_state, tcfg)
        for path, want in tree_flatten_with_path(jo_new)[0]:
            got = _get(to_new, path)
            assert got.shape == want.shape, (keystr(path), got.shape, want.shape)
            err = np.abs(got.astype(np.float64) - want).max(initial=0.0)
            assert err <= STATE_RTOL * max(np.abs(want).max(initial=0.0), 1e-30), (
                f"{arch} {opt} step {i} state {keystr(path)}: {err}")

        jp_new = jax.tree.map(np.asarray, jstate.params)
        tp_new = _params_to_numpy(tstate.params, tcfg)
        g2 = _grad_sq(opt, jo, jo_new, i + 1)
        gmax = 0.0 if g2 is None else max(
            np.sqrt(np.abs(x)).max() for x in jax.tree.leaves(g2))
        flagged = 0
        for path, want in tree_flatten_with_path(jp_new)[0]:
            got = _get(tp_new, path)
            assert got.dtype == want.dtype and got.shape == want.shape, keystr(path)
            diff = np.abs(got.astype(np.float64) - want)
            tol = np.full(diff.shape, PARAM_ATOL)
            sq = None if g2 is None else _get(g2, path)
            if sq is not None:
                tiny = np.sqrt(np.abs(sq)) < TINY_GRAD * gmax
                step_max = np.abs(want - _get(jp, path)).max(initial=0.0)
                tol = np.where(tiny, 2 * step_max + PARAM_ATOL, tol)
                flagged += int(tiny.sum())
            bad = diff > tol
            assert not bad.any(), (
                f"{arch} {opt} step {i} param {keystr(path)}: max |diff| {diff.max()} "
                f"at {np.argwhere(bad)[:3].tolist()}")
        rec["flagged_elements"] = flagged
        records.append(rec)
    return records

"""The port's LM paths sharded over a (2, 4) ("data", "model") mesh of 8
gloo ranks on the CPU, against the port unsharded and the JAX package.

One subprocess (tests/_torch_mesh_worker.py, at a free port, with a
timeout) runs every case on 8 ranks: reduced dense (yi-6b), hybrid
(hymba-1.5b, its sliding window's ring wrapping during decode) and
encoder-decoder (whisper-medium) configs in float32, under the megatron
and gather rule tables: the forward's logits, the prefill's logits and
cache, 3 teacher-forced decode steps, and one SGD train step, from the
JAX package's ``init`` params carried across with ``convert``; and one
SGD step of the paper's CNN (C1 8, C2 16 kernels, both split over
``model``) through ``core/conv_shard.py``'s kernel-sharded conv, against
the port's one-device step (``cnn_loss`` with the plain conv).

Tolerances: sharded against the port unsharded atol = rtol = 1e-4 (the
ranks sum in another order); against the JAX package, those of the
files that hold the unsharded port to it: tests/test_torch_lm_serve.py's
atol = rtol = 2e-3 for forward, prefill and decode, and
tests/_torch_train_parity.py's for the train step (loss rtol 1e-5,
grad_norm rtol 1e-4, params atol 1e-5 for SGD).

Under megatron the decode cache is sharded on its slot axis
(``cache_seq`` on ``model``): the test holds that decode writes it in
place (every rank's shard keeps its storage), keeps that layout, and
that a decode step's collective bytes (counted by
``roofline/op_count.py``) are the same against a cache of twice the
slots: no collective moves the cache.
"""
import os
import pickle
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import RunConfig as JaxRunConfig
from repro.configs import get_config as jax_get_config
from repro.configs import reduced_for_smoke as jax_reduced
from repro.models.registry import build_model as jax_build_model
from repro.models.registry import rules_for_mode as jax_rules_for_mode
from repro.train.step import init_train_state as jax_init_train_state
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch import convert
from repro_torch.configs import RunConfig, get_config, reduced_for_smoke
from repro_torch.models.registry import build_model
from repro_torch.optim.optimizers import make_optimizer
from repro_torch.train.step import TrainState, make_train_step

ROOT = os.path.join(os.path.dirname(__file__), "..")
WORKER = os.path.join(os.path.dirname(__file__), "_torch_mesh_worker.py")
ARCHS = {"dense": "yi-6b", "hybrid": "hymba-1.5b", "encdec": "whisper-medium"}
MODES = ("megatron", "gather")
B, S, PROMPT, CACHE, STEPS, LR = 4, 19, 16, 20, 3, 0.1
MESH_TOL, JAX_TOL = 1e-4, 2e-3
LOSS_RTOL, GNORM_RTOL, PARAM_ATOL = 1e-5, 1e-4, 1e-5


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_worker(kind, cases, tmp_path, timeout=600):
    """The 8-rank worker on ``cases``; its results."""
    inp, outp = tmp_path / f"{kind}_in.pkl", tmp_path / f"{kind}_out.pkl"
    with open(inp, "wb") as f:
        pickle.dump(cases, f)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, WORKER, kind, str(inp), str(outp), str(free_port())],
                       env=env, cwd=ROOT, capture_output=True, text=True, timeout=timeout)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-8000:]
    with open(outp, "rb") as f:
        return pickle.load(f)


def _inputs(cfg, seed):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, size=(B, S))}
    train = {"tokens": rng.integers(0, cfg.vocab_size, size=(B, PROMPT)),
             "labels": rng.integers(0, cfg.vocab_size, size=(B, PROMPT)).astype(np.int32)}
    if cfg.audio is not None:
        frames = rng.normal(size=(B, cfg.audio.num_frames, cfg.audio.frame_dim))
        batch["frames"] = train["frames"] = frames.astype(np.float32)
    return batch, train


def _jax_results(jcfg, jparams, batch, train):
    japi = jax_build_model(jcfg)
    rules = jax_rules_for_mode("megatron")
    out = {"forward": np.asarray(japi.forward(jparams, batch, rules=rules)[0])}
    prompt = {k: (v[:, :PROMPT] if k == "tokens" else v) for k, v in batch.items()}
    logits, cache = japi.prefill(jparams, prompt, rules=rules, cache_len=CACHE)
    out["prefill"] = np.asarray(logits)
    out["decode"] = []
    for t in range(PROMPT, PROMPT + STEPS):
        logits, cache = japi.decode_step(jparams, cache, batch["tokens"][:, t:t + 1],
                                         rules=rules)
        out["decode"].append(np.asarray(logits))
    run = JaxRunConfig(optimizer="sgd", learning_rate=LR, warmup_steps=1, total_steps=10,
                       remat="none")
    state = jax_init_train_state(jax.random.key(0), japi, run)
    state, metrics = jax.jit(jax_make_train_step(japi, run))(state, train)
    out["train"] = {k: float(v) for k, v in metrics.items()}
    out["train_params"] = jax.tree.map(np.asarray, state.params)
    return out


def _port_results(tcfg, jparams, batch, train):
    tapi = build_model(tcfg)
    from_np = (convert.encdec_params_from_numpy if tcfg.num_encoder_layers
               else convert.lm_params_from_numpy)
    to_np = (convert.encdec_params_to_numpy if tcfg.num_encoder_layers
             else convert.lm_params_to_numpy)
    params = from_np(jparams, tcfg, "cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = {"forward": tapi.forward(params, tb)[0].numpy()}
    prompt = {k: (v[:, :PROMPT] if k == "tokens" else v) for k, v in tb.items()}
    with torch.inference_mode():
        logits, cache = tapi.prefill(params, prompt, cache_len=CACHE)
        out["prefill"] = logits.numpy()
        out["decode"] = []
        for t in range(PROMPT, PROMPT + STEPS):
            logits, cache = tapi.decode_step(params, cache, tb["tokens"][:, t:t + 1])
            out["decode"].append(logits.numpy())
    out["cache_after"] = {k: v.float().numpy() for k, v in cache.items()
                          if isinstance(v, torch.Tensor)}
    run = RunConfig(optimizer="sgd", learning_rate=LR, warmup_steps=1, total_steps=10,
                    remat="none")
    state = TrainState(0, params, make_optimizer("sgd").init(params))
    state, metrics = make_train_step(tapi, run)(
        state, {k: torch.from_numpy(v) for k, v in train.items()})
    out["train"] = {k: float(v) for k, v in metrics.items()}
    out["train_params"] = to_np(state.params, tcfg)
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """{(case, mode): (sharded, unsharded port, JAX)}."""
    torch.set_num_threads(1)
    cases, refs = {}, {}
    for i, (name, arch) in enumerate(ARCHS.items()):
        jcfg, tcfg = jax_reduced(jax_get_config(arch)), reduced_for_smoke(get_config(arch))
        jparams = jax.tree.map(np.asarray, jax_build_model(jcfg).init(jax.random.key(0)))
        batch, train = _inputs(jcfg, seed=i + 1)
        cases[name] = dict(arch=arch, params=jparams, batch=batch, train_batch=train,
                           prompt_len=PROMPT, cache_len=CACHE, decode_steps=STEPS, lr=LR,
                           modes=MODES)
        refs[name] = (_port_results(tcfg, jparams, batch, train),
                      _jax_results(jcfg, jparams, batch, train))
    cases["cnn"] = _cnn_inputs()
    sharded = run_worker("lm", cases, tmp_path_factory.mktemp("mesh"))
    out = {(name, mode): (sharded[(name, mode)],) + refs[name]
           for name in ARCHS for mode in MODES}
    out.update({("cnn", mode): (sharded[("cnn", mode)], _cnn_reference(cases["cnn"]))
                for mode in MODES})
    return out


def _cnn_inputs():
    from repro_torch.models.cnn import init_cnn, make_cnn_config

    cfg = make_cnn_config(8, 16)
    params = init_cnn(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(7)
    return dict(kind="cnn", sizes=(8, 16), lr=0.05, modes=MODES,
                params={l: {n: t.numpy() for n, t in d.items()} for l, d in params.items()},
                images=rng.standard_normal((4, 32, 32, 3)).astype(np.float32),
                labels=np.arange(4) % 10)


def _cnn_reference(case):
    from repro_torch.launch.hetero import sgd_step
    from repro_torch.models.cnn import cnn_loss, make_cnn_config

    cfg = make_cnn_config(*case["sizes"])
    params = {l: {n: torch.from_numpy(a) for n, a in d.items()}
              for l, d in case["params"].items()}
    images, labels = torch.from_numpy(case["images"]), torch.from_numpy(case["labels"])
    new, loss, _ = sgd_step(params, lambda q: cnn_loss(q, images, labels, cfg=cfg),
                            case["lr"])
    return {"loss": loss, "params": {l: {n: t.numpy() for n, t in d.items()}
                                     for l, d in new.items()}}


def _close(got, want, tol, msg):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=tol, rtol=tol, err_msg=msg)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, prefix + (k,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", list(ARCHS))
def test_sharded_serving_equals_unsharded_and_jax(results, case, mode):
    got, port, want = results[(case, mode)]
    for key in ("forward", "prefill"):
        _close(got[key], port[key], MESH_TOL, f"{case} {mode} {key} vs unsharded")
        _close(got[key], want[key], JAX_TOL, f"{case} {mode} {key} vs jax")
    for i in range(STEPS):
        _close(got["decode"][i], port["decode"][i], MESH_TOL, f"{case} {mode} decode {i}")
        _close(got["decode"][i], want["decode"][i], JAX_TOL, f"{case} {mode} decode {i} jax")
    assert sorted(got["cache_after"]) == sorted(port["cache_after"])
    for key, val in got["cache_after"].items():
        _close(val, port["cache_after"][key], MESH_TOL, f"{case} {mode} cache[{key!r}]")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", list(ARCHS))
def test_sharded_train_step_equals_unsharded_and_jax(results, case, mode):
    got, port, want = results[(case, mode)]
    for k in ("loss", "grad_norm", "lr"):
        _close(got["train"][k], port["train"][k], MESH_TOL, f"{case} {mode} {k}")
    np.testing.assert_allclose(got["train"]["loss"], want["train"]["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["train"]["grad_norm"], want["train"]["grad_norm"],
                               rtol=GNORM_RTOL)
    want_params = dict(_flat(want["train_params"]))
    port_params = dict(_flat(port["train_params"]))
    for path, val in _flat(got["train_params"]):
        _close(val, port_params[path], MESH_TOL, f"{case} {mode} param {path} vs unsharded")
        np.testing.assert_allclose(np.asarray(val, np.float64), want_params[path],
                                   atol=PARAM_ATOL, rtol=0, err_msg=f"{case} {mode} {path}")


@pytest.mark.parametrize("case", list(ARCHS))
def test_megatron_decode_cache_stays_sharded_on_its_slots(results, case):
    got = results[(case, "megatron")][0]
    assert got["cache_in_place"]
    assert got["decode_collective_bytes"] > 0
    assert got["decode_collective_bytes_2x_cache"] == got["decode_collective_bytes"]
    if "k" in got["cache_placements"]:
        # (data, model): batch on data, the slot axis (2 of layers, B, C, KV, hd) on model
        assert got["cache_placements"]["k"] == ["Shard(1)", "Shard(2)"]
        assert got["cache_placements"]["pos"] == ["Shard(0)", "Shard(1)"]
    gather = results[(case, "gather")][0]
    assert gather["cache_in_place"]
    if "k" in gather["cache_placements"]:  # gather mode holds every slot on every model rank
        assert gather["cache_placements"]["k"][1] != "Shard(2)"


@pytest.mark.parametrize("mode", MODES)
def test_kernel_sharded_cnn_step_equals_one_device(results, mode):
    got, want = results[("cnn", mode)]
    assert got["conv2_placements"] == ["Replicate", "Shard"]  # C2's kernels on model
    _close(got["loss"], want["loss"], MESH_TOL, f"cnn {mode} loss")
    for layer, leaves in want["params"].items():
        for name, val in leaves.items():
            _close(got["params"][layer][name], val, MESH_TOL, f"cnn {mode} {layer}/{name}")

"""The port's decoder-only serving path, end to end, against the JAX
package.

One ``init_lm`` parameter tree (JAX package) is carried across with
``repro_torch.convert.lm_params_from_numpy``; the same numpy tokens go
through both packages' ``forward``, ``prefill`` (logits and every cache
entry) and ``decode_step`` (past the sliding window's ring wrap), for
tests/test_serve.py's four families (dense GQA, SWA, SSM, hybrid) and
``reduced_for_smoke(hymba-1.5b)``.  The port runs the kernels' plain
versions here (CPU tensors); the card runs K4 and K5 in chip_smoke.py.
Tolerance: tests/test_serve.py's atol = rtol = 2e-3 (fp32; the two
packages sum in different orders and the port's attention and SSD run
the kernels' contract, the JAX model its jnp forms).

Also: ``ServeEngine.generate``'s greedy tokens equal the JAX engine's;
the port's serve CLI runs reduced on the CPU when asked and refuses
without a card otherwise.  The MoE, VLM and encoder-decoder families,
and caller-supplied positions, are tests/test_torch_lm_zoo.py's.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import RunConfig as JaxRunConfig
from repro.configs import get_config as jax_get_config
from repro.configs import reduced_for_smoke as jax_reduced
from repro.configs.base import ModelConfig as JaxModelConfig
from repro.configs.base import SSMConfig as JaxSSMConfig
from repro.models.registry import build_model as jax_build_model
from repro.models.registry import rules_for_mode
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro_torch import convert
from repro_torch.configs import get_config, reduced_for_smoke
from repro_torch.configs.base import ModelConfig, SSMConfig
from repro_torch.models.registry import build_model
from repro_torch.serve.engine import ServeEngine

ROOT = os.path.join(os.path.dirname(__file__), "..")
RULES = rules_for_mode("megatron")
ATOL = RTOL = 2e-3
N_PROMPT, N_TOTAL = 10, 24


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run torch on one intra-op thread: these tests share the host with
    the suite's timing-sensitive cluster tests, and need no more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(**kw):
    """tests/test_serve.py's config, in both packages."""
    base = dict(arch_id="t", family="dense", num_layers=2, d_model=64, num_heads=4,
                num_kv_heads=2, d_ff=128, vocab_size=97, dtype="float32",
                param_dtype="float32")
    ssm = kw.pop("ssm", None)
    base.update(kw)
    jcfg = JaxModelConfig(**base, ssm=None if ssm is None else JaxSSMConfig(**ssm))
    tcfg = ModelConfig(**base, ssm=None if ssm is None else SSMConfig(**ssm))
    return jcfg, tcfg


CASES = {
    "dense-gqa": _pair(),
    "swa": _pair(sliding_window=8),
    "ssm": _pair(family="ssm", num_heads=0, num_kv_heads=0, d_ff=0, head_dim=8,
                 ssm=dict(d_state=4, d_conv=3, expand=2, head_dim=8, chunk_size=4)),
    "hybrid": _pair(family="hybrid", head_dim=16,
                    ssm=dict(d_state=4, d_conv=3, expand=2, head_dim=16, chunk_size=4)),
    "hymba-1.5b reduced": (jax_reduced(jax_get_config("hymba-1.5b")),
                           reduced_for_smoke(get_config("hymba-1.5b"))),
    # the config knobs the families above leave at their defaults
    "gelu": _pair(activation="gelu"),
    "squared-relu non-gated": _pair(activation="squared_relu", gated_mlp=False),
    "layernorm": _pair(norm="layernorm"),
    "logit softcap": _pair(logit_softcap=30.0),
    "rope theta 5e6": _pair(rope_theta=5e6),
    "head_dim 24": _pair(head_dim=24),
    "tied embeddings": _pair(tie_embeddings=True),
}
CASES.update({f"{arch} reduced": (jax_reduced(jax_get_config(arch)),
                                  reduced_for_smoke(get_config(arch)))
              for arch in ("yi-6b", "mamba2-370m", "minicpm-2b")})


def _models(name):
    jcfg, tcfg = CASES[name]
    japi, tapi = jax_build_model(jcfg), build_model(tcfg)
    jparams = jax.tree.map(np.asarray, japi.init(jax.random.key(0)))
    return jcfg, japi, jparams, tapi, convert.lm_params_from_numpy(jparams, tcfg, "cpu")


def _tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, size=shape)


def _close(got, want, msg):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=ATOL, rtol=RTOL,
                               err_msg=msg)


@pytest.mark.parametrize("name", list(CASES))
def test_forward_prefill_and_decode_match_jax(name):
    jcfg, japi, jparams, tapi, tparams = _models(name)
    toks = _tokens(jcfg, (2, N_TOTAL))
    ttoks = torch.from_numpy(toks)

    jfull, _ = jax.jit(lambda p, t: japi.forward(p, {"tokens": t}, rules=RULES))(
        jparams, toks)
    tfull, aux = tapi.forward(tparams, {"tokens": ttoks})
    assert float(aux) == 0.0
    _close(tfull, jfull, f"{name} forward")

    jlog, jcache = jax.jit(lambda p, t: japi.prefill(
        p, {"tokens": t}, rules=RULES, cache_len=N_TOTAL))(jparams, toks[:, :N_PROMPT])
    tlog, tcache = tapi.prefill(tparams, {"tokens": ttoks[:, :N_PROMPT]},
                                cache_len=N_TOTAL)
    _close(tlog, jlog, f"{name} prefill logits")
    assert sorted(tcache) == sorted(jcache)
    assert tcache["t"] == int(jcache["t"]) == N_PROMPT
    for key in sorted(set(jcache) - {"t"}):
        assert tuple(tcache[key].shape) == jcache[key].shape, key
        _close(tcache[key], jcache[key], f"{name} prefill cache[{key!r}]")

    jstep = jax.jit(lambda p, c, t: japi.decode_step(p, c, t, rules=RULES))
    for t in range(N_PROMPT, N_TOTAL):  # past the ring's wrap of an 8- or 16-slot window
        jlog, jcache = jstep(jparams, jcache, toks[:, t : t + 1])
        tlog, tcache = tapi.decode_step(tparams, tcache, ttoks[:, t : t + 1])
        _close(tlog, jlog, f"{name} decode step {t}")
        _close(tlog, jfull[:, t], f"{name} decode step {t} vs the forward")
    for key in sorted(set(jcache) - {"t"}):
        _close(tcache[key], jcache[key], f"{name} cache[{key!r}] after decode")


@pytest.mark.parametrize("name", ["dense-gqa", "hybrid"])
def test_engine_greedy_tokens_equal_jax(name):
    jcfg, japi, jparams, tapi, tparams = _models(name)
    toks = _tokens(jcfg, (2, 8), seed=2)
    want = JaxServeEngine(api=japi, run=JaxRunConfig(), params=jparams).generate(
        {"tokens": toks}, max_new_tokens=6)
    timings = {}
    got = ServeEngine(api=tapi, params=tparams).generate(
        {"tokens": torch.from_numpy(toks)}, max_new_tokens=6, timings=timings)
    assert got.dtype == torch.int32 and tuple(got.shape) == (2, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert timings["decode_steps"] == 5 and timings["prefill_s"] > 0


@pytest.mark.parametrize("name", ["dense-gqa", "hybrid"])
def test_engine_eos_and_cache_len_equal_jax(name):
    """``eos_id`` pins a row to it once the row has emitted it, and
    ``cache_len`` sizes the cache past prompt plus new tokens, as in the
    JAX engine.  The eos is row 0's greedy token at the first step whose
    next token differs, so it fires mid-sequence and changes what follows."""
    jcfg, japi, jparams, tapi, tparams = _models(name)
    toks = _tokens(jcfg, (2, 8), seed=2)
    n_new, cache_len = 8, 8 + 8 + 5
    jeng = JaxServeEngine(api=japi, run=JaxRunConfig(), params=jparams)
    free = np.asarray(jeng.generate({"tokens": toks}, max_new_tokens=n_new))
    at = next(i for i in range(1, n_new - 1) if free[0, i + 1] != free[0, i])
    eos = int(free[0, at])
    want = np.asarray(jeng.generate({"tokens": toks}, max_new_tokens=n_new,
                                    cache_len=cache_len, eos_id=eos))
    assert (want[0, at:] == eos).all() and want[0, at + 1] != free[0, at + 1]
    got = ServeEngine(api=tapi, params=tparams).generate(
        {"tokens": torch.from_numpy(toks)}, max_new_tokens=n_new, cache_len=cache_len,
        eos_id=eos)
    np.testing.assert_array_equal(got.numpy(), want)


def test_engine_sampling_is_seeded():
    jcfg, japi, jparams, tapi, tparams = _models("hybrid")
    eng = ServeEngine(api=tapi, params=tparams)
    batch = {"tokens": torch.from_numpy(_tokens(jcfg, (2, 8)))}
    a = eng.generate(batch, max_new_tokens=5, sample=True, temperature=0.7, seed=3)
    b = eng.generate(batch, max_new_tokens=5, sample=True, temperature=0.7, seed=3)
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert int(a.min()) >= 0 and int(a.max()) < jcfg.vocab_size


def _serve_cli(*args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "hymba-1.5b", *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)


def test_serve_cli_runs_reduced_on_the_cpu():
    r = _serve_cli("--device", "cpu", "--batch", "2", "--prompt-len", "20", "--max-new", "4")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "generated (2, 4)" in r.stdout and "on cpu" in r.stdout


def test_serve_cli_refuses_without_a_card():
    r = _serve_cli("--batch", "2", "--prompt-len", "8", "--max-new", "2")
    assert r.returncode != 0
    assert "needs a CUDA card" in r.stderr

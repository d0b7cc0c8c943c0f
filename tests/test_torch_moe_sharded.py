"""The port's expert-parallel MoE on 8 gloo ranks of a (2, 4) ("data",
"model") mesh must equal the port's single-shard path and the JAX
package's: tests/test_moe_sharded.py's three cases — experts dividing
the model axis (expert-parallel, the all-reduce over ``model``), experts
that do not (per-expert d_ff sharded, the mixtral case), and the
all-to-all dispatch (tokens sharded over ``model`` too) — at its
tolerances: outputs atol = rtol = 1e-4, and the sharded load-balance
aux (a mean of per-token-shard statistics) within 0.5x-2x of the
unsharded one.  The params and tokens are the JAX package's
``init_moe`` and ``jax.random.normal`` draws, carried across as numpy;
the sharded run is one subprocess (tests/_torch_mesh_worker.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JaxModelConfig
from repro.configs.base import MoEConfig as JaxMoEConfig
from repro.layers.moe import apply_moe as jax_apply_moe
from repro.layers.moe import init_moe as jax_init_moe
from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.layers.moe import apply_moe
from test_torch_mesh import run_worker

CASES = {
    "expert-parallel": dict(num_experts=8, d_ff=8, dispatch="psum"),
    "dff-parallel": dict(num_experts=3, d_ff=8, dispatch="psum"),
    "alltoall": dict(num_experts=8, d_ff=8, dispatch="alltoall"),
}
TOL = 1e-4


def _moe_kw(c):
    return dict(num_experts=c["num_experts"], experts_per_token=2, expert_d_ff=c["d_ff"],
                capacity_factor=100.0, dispatch=c["dispatch"])


def _cfgs(c):
    base = dict(arch_id="t", family="moe", num_layers=1, d_model=16, num_heads=2,
                num_kv_heads=2, d_ff=c["d_ff"], vocab_size=16, dtype="float32",
                param_dtype="float32")
    return (JaxModelConfig(**base, moe=JaxMoEConfig(**_moe_kw(c))),
            ModelConfig(**base, moe=MoEConfig(**_moe_kw(c))))


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    cases, refs = {}, {}
    for name, c in CASES.items():
        jcfg, tcfg = _cfgs(c)
        params = jax.tree.map(np.array, jax_init_moe(jax.random.key(0), 16, jcfg.moe,
                                                       jnp.float32))
        x = np.array(jax.random.normal(jax.random.key(1), (8, 6, 16), jnp.float32))
        want, want_aux = jax_apply_moe(params, jnp.asarray(x), cfg=jcfg, mesh=None)
        tparams = {"router": {"kernel": torch.from_numpy(params["router"]["kernel"])},
                   **{k: torch.from_numpy(params[k]) for k in ("w_in", "w_gate", "w_out")}}
        port, port_aux = apply_moe(tparams, torch.from_numpy(x), cfg=tcfg)
        refs[name] = (np.asarray(want), float(want_aux), port.numpy(), float(port_aux))
        cases[name] = dict(params=params, x=x, d_ff=c["d_ff"], moe=_moe_kw(c))
    sharded = run_worker("moe", cases, tmp_path_factory.mktemp("moe"), timeout=300)
    return {name: (sharded[name],) + refs[name] for name in CASES}


@pytest.mark.parametrize("name", list(CASES))
def test_moe_sharded_equals_local(results, name):
    got, want, want_aux, port, port_aux = results[name]
    np.testing.assert_allclose(got["out"], port, atol=TOL, rtol=TOL, err_msg=f"{name} port")
    np.testing.assert_allclose(got["out"], want, atol=TOL, rtol=TOL, err_msg=f"{name} jax")
    # sharded paths compute the load-balance stats per token shard
    assert 0.5 * port_aux < got["aux"] < 2.0 * port_aux, (name, got["aux"], port_aux)
    assert 0.5 * want_aux < got["aux"] < 2.0 * want_aux, (name, got["aux"], want_aux)

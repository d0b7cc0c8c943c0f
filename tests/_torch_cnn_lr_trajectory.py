"""The paper's CNN at full width (cifar_cnn_500_1500) trained 4 plain SGD
steps at lr 0.05 on the CPU by both packages from the same start: the
JAX package's ``init_cnn(key(0))`` carried into the port with
``convert.params_from_numpy``, one ``synthetic_cifar_batches(32,
seed=0)`` batch a step.  Prints each package's losses, their largest
relative difference and the peak resident memory (about 2.5 GiB).

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/_torch_cnn_lr_trajectory.py

A divergence that only the port shows would be a port fault; both
packages spiking at step 2 is the learning rate at this width.
"""
import resource

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.data.pipeline import synthetic_cifar_batches
from repro.models.cnn import cnn_loss, init_cnn, make_cnn_config
from repro_torch.convert import params_from_numpy
from repro_torch.launch.hetero import sgd_step
from repro_torch.models.cnn import cnn_loss as port_cnn_loss
from repro_torch.models.cnn import make_cnn_config as port_make_cnn_config

C1, C2, BATCH, LR, STEPS = 500, 1500, 32, 0.05, 4


def main():
    cfg, port_cfg = make_cnn_config(C1, C2), port_make_cnn_config(C1, C2)
    params = init_cnn(jax.random.key(0), cfg)
    port_params = params_from_numpy(jax.tree.map(np.array, params), "cpu")
    grad = jax.jit(jax.value_and_grad(lambda p, x, y: cnn_loss(p, x, y, cfg=cfg)[0]))
    stream = synthetic_cifar_batches(BATCH, seed=0)
    jax_losses, port_losses = [], []
    for _ in range(STEPS):
        b = next(stream)
        loss, g = grad(params, jnp.asarray(b["images"]), jnp.asarray(b["labels"]))
        params = jax.tree.map(lambda p, gp: p - LR * gp, params, g)
        jax_losses.append(float(loss))
        x, y = torch.from_numpy(b["images"]), torch.from_numpy(b["labels"]).long()
        port_params, loss, _ = sgd_step(
            port_params, lambda q: port_cnn_loss(q, x, y, cfg=port_cfg), LR)
        port_losses.append(loss)
    print("jax ", jax_losses)
    print("port", port_losses)
    print("max rel diff", max(abs(a - b) / abs(a) for a, b in zip(jax_losses, port_losses)))
    print("peak rss GiB", resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20)


if __name__ == "__main__":
    main()

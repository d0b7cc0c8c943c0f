"""The plain reference against the program's numpy and torch:cpu
devices at a tiny width: the same training steps and served outputs."""
import numpy as np
import pytest
import torch

from portbench.drivers import serve as serve_driver, train as train_driver
from portbench.reference import cifar_cnn as ref
from conftest import tiny_spec

SEED = 2 ** 31 + 17


@pytest.mark.parametrize("backends", [["numpy"], ["torch:cpu", "numpy"],
                                      ["numpy", "torch:cpu", "numpy"]])
def test_sgd_steps_match_the_cluster_step(backends):
    from repro_torch.core.cluster.cluster import HeteroCluster
    from repro_torch.models.cnn import make_cluster_train_step
    from portbench import traffic
    from portbench.drivers import _common

    s = tiny_spec("cnn500_train_hetero")
    cfg = s.cfg
    params = train_driver.init_params(cfg, SEED, "cpu")
    p0 = train_driver.host(params)
    batches = [b for _, b in zip(range(3), traffic.synthetic_cifar_batches(4, seed=SEED))]
    cluster = HeteroCluster([1.0] * len(backends), backends, pipeline=True, microbatches=2)
    try:
        cluster.probe(image_size=32, in_channels=3, kernel_size=5, num_kernels=8, batch=4)
        step = make_cluster_train_step(cluster, _common.cnn_config(cfg), lr=0.01, device="cpu")
        losses = []
        for b in batches:
            params, loss, _ = step(params, b["images"], b["labels"])
            losses.append(loss)
    finally:
        cluster.shutdown()
    want_losses, _, want = ref.sgd_steps(p0, batches, 0.01, cfg, "cpu")
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    got = train_driver.host(params)
    for layer in want:
        for name in want[layer]:
            np.testing.assert_allclose(got[layer][name], want[layer][name],
                                       rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("backends", [["numpy"], ["torch:cpu", "numpy"]])
def test_serve_outputs_match_the_cluster_server(backends):
    from repro_torch.core.cluster.cluster import HeteroCluster
    from repro_torch.launch.hetero import relu_pool
    from repro_torch.serve.server import ClusterServer
    from portbench import traffic

    cfg = tiny_spec("cnn150_serve_hetero").cfg
    weights, fc = serve_driver.init_weights(cfg, SEED, "cpu")
    images = traffic.serve_images(9, 32, 3, SEED)
    cluster = HeteroCluster([1.0] * len(backends), backends, pipeline=True)
    try:
        cluster.probe(image_size=32, in_channels=3, kernel_size=5, num_kernels=8, batch=4)
        server = ClusterServer(cluster, weights, between=[relu_pool, relu_pool],
                               head=lambda z: z.reshape(z.shape[0], -1) @ fc, max_batch=4)
        with server:
            resps = [f.result(timeout=60) for f in [server.submit(x) for x in images]]
    finally:
        cluster.shutdown()
    got = np.stack([r.output for r in resps])
    np.testing.assert_allclose(got, ref.serve_outputs(weights, fc, images, "cpu", rows=4),
                               rtol=1e-4, atol=1e-5 * np.abs(got).max())


def test_round_tf32_keeps_ten_mantissa_bits_to_nearest_even():
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      -(1.0 + 3 * 2 ** -11), 1.0 + 2 ** -11 + 2 ** -20, 3.0e38, 0.0])
    want = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0, 1.0 + 2 ** -9, -(1.0 + 2 ** -9),
                         1.0 + 2 ** -10, ref.round_tf32(torch.tensor([3.0e38]))[0], 0.0])
    got = ref.round_tf32(x)
    assert torch.equal(got, want)
    assert torch.equal(ref.round_tf32(got), got)
    r = torch.randn(10000)
    assert ((ref.round_tf32(r) - r).abs() <= r.abs() * 2 ** -11).all()

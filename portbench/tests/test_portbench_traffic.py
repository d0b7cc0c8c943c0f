"""The traffic: the same seed gives the same inputs; every seed gives
the same amount of work."""
import numpy as np
import pytest

from portbench import traffic

SEED = 2 ** 31 + 977


def test_schedule_repeats_for_a_seed():
    a = traffic.open_loop_schedule(123.0, 7.0, SEED)
    b = traffic.open_loop_schedule(123.0, 7.0, SEED)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("rate,seconds", [(123.0, 7.0), (40.0, 1.0), (350.0, 20.0)])
def test_schedule_sends_the_same_work_for_every_seed(rate, seconds):
    a = traffic.open_loop_schedule(rate, seconds, SEED)
    b = traffic.open_loop_schedule(rate, seconds, SEED + 1)
    assert len(a) == len(b) == round(rate * seconds)
    assert not np.array_equal(a, b)
    np.testing.assert_allclose(np.sort(np.diff(a, prepend=0)), np.sort(np.diff(b, prepend=0)))
    assert np.all(np.diff(a) > 0) and a[-1] == pytest.approx(seconds)


def test_schedule_gaps_are_exponential_quantiles():
    due = traffic.open_loop_schedule(200.0, 50.0, SEED)
    gaps = np.diff(due, prepend=0)
    # mean 1/rate; an exponential's median is ln 2 of its mean
    assert gaps.mean() == pytest.approx(1 / 200.0)
    assert np.median(gaps) == pytest.approx(np.log(2) / 200.0, rel=0.02)


def test_cifar_batches_are_the_programs():
    from repro_torch.data.pipeline import synthetic_cifar_batches

    ours = traffic.synthetic_cifar_batches(8, seed=SEED)
    theirs = synthetic_cifar_batches(8, seed=SEED)
    for _ in range(3):
        a, b = next(ours), next(theirs)
        np.testing.assert_array_equal(a["images"], b["images"])
        np.testing.assert_array_equal(a["labels"], b["labels"])


def test_serve_images_repeat_for_a_seed():
    a = traffic.serve_images(5, 8, 3, SEED)
    np.testing.assert_array_equal(a, traffic.serve_images(5, 8, 3, SEED))
    assert a.shape == (5, 8, 8, 3) and a.dtype == np.float32
    assert not np.array_equal(a, traffic.serve_images(5, 8, 3, SEED + 1))

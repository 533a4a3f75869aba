"""The port's timing helpers (mxq_tpu_torch/utils/benchlib.py) against
mxq_tpu's: fold_to_input bit for bit, and time_op's contract on the CPU
(a positive median, ``const`` passed through as the step's argument)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxq_tpu.utils import benchlib as jbench
from mxq_tpu_torch.utils import benchlib
import torch_port_helpers  # noqa: F401  (one torch thread per process)


@pytest.mark.parametrize("shape,k", [((4, 96), 32), ((2, 100), 32),
                                     ((3, 16), 64)])
def test_fold_to_input_equals_reference(shape, k):
    y = np.random.RandomState(0).randn(*shape).astype(np.float32)
    want = np.asarray(jbench.fold_to_input(jnp.asarray(y), k))
    got = benchlib.fold_to_input(torch.from_numpy(y), k)
    assert got.shape == want.shape == (shape[0], k)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


def test_fold_to_input_dtype():
    y = torch.ones((2, 8))
    assert benchlib.fold_to_input(y, 4, torch.bfloat16).dtype \
        == torch.bfloat16


def test_time_op_positive_median_with_const():
    w = torch.randn(64, 64)
    seen = []

    def step(c, x):
        seen.append(c is w)
        return benchlib.fold_to_input(x @ c, 64)

    t = benchlib.time_op(step, torch.randn(8, 64), iters_hi=4, reps=3,
                         const=w)
    assert 0 < t < 1.0
    assert seen and all(seen)
    # warm-up, then three repetitions of four executions each
    assert len(seen) == 1 + 3 * 4


def test_time_op_calibrates_without_trip_counts():
    calls = []

    def step(x):
        calls.append(1)
        return x * 0.5

    t = benchlib.time_op(step, torch.ones(16), target_s=0.001)
    assert 0 < t < 0.01
    assert len(calls) > 4

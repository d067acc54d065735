"""The softmax's class sum on the CPU (ROADMAP C.1's residual).

XLA's CPU reduction adds the classes of a row left to right in f32 for up
to 32 classes; ``torch.sum`` adds them in its vectorised order, which
differs on most rows from 7 classes up.  ``multiclass.class_sum`` repeats
XLA's order on CPU tensors, so the port's ``_softmax``, the one-vs-all
transform and the multiclass gradients equal the reference's jitted
functions bit for bit.  Past 32 classes XLA's order is another one, not
repeated (ROADMAP C.1 records the share of rows that differ).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.config import parse_params as r_params
from lightgbm_tpu.multiclass import _softmax as r_softmax
from lightgbm_tpu.objectives import create_objective as r_objective
from lightgbm_tpu_torch.config import parse_params as p_params
from lightgbm_tpu_torch.multiclass import (XLA_SEQUENTIAL_CLASSES, _softmax,
                                           class_sum)
from lightgbm_tpu_torch.objectives import create_objective as p_objective

ROWS = 20_000


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def _raw(k, seed):
    return np.random.default_rng(seed).normal(0, 4, (ROWS, k)).astype(
        np.float32)


@pytest.mark.parametrize("k", [3, 7, 32])
def test_softmax_bit_equal_to_the_reference(k):
    x = _raw(k, k)
    want = np.asarray(jax.jit(r_softmax)(jnp.asarray(x)))
    got = _softmax(torch.from_numpy(x)).numpy()
    assert np.array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("k", [7, 16, 32])
def test_class_sum_is_sequential_and_torch_sum_is_not(k):
    e = np.exp(_raw(k, 100 + k) / 4).astype(np.float32)
    seq = np.zeros(ROWS, np.float32)
    for c in range(k):
        seq = (seq + e[:, c]).astype(np.float32)
    got = class_sum(torch.from_numpy(e))[:, 0].numpy()
    assert np.array_equal(_bits(got), _bits(seq))
    # the fault it repairs: torch's order differs on many rows
    plain = torch.from_numpy(e).sum(dim=-1).numpy()
    assert np.mean(_bits(plain) != _bits(seq)) > 0.1
    assert k <= XLA_SEQUENTIAL_CLASSES


def _objectives(name, k):
    params = dict(objective=name, num_class=k, verbose=-1)
    return (r_objective(r_params(params)), p_objective(p_params(params)))


def test_ova_transform_bit_equal_to_the_reference():
    """Against the transform as the reference's ``predict`` runs it, op by
    op.  Jitted, XLA rewrites ``(1 / (1 + e)) / s`` into ``1 / ((1 + e) *
    s)``, which the port does not copy."""
    x = _raw(7, 71)
    ref, port = _objectives("multiclassova", 7)
    want = np.asarray(ref.transform(jnp.asarray(x)))
    got = port.transform(torch.from_numpy(x)).numpy()
    assert np.array_equal(_bits(got), _bits(want))


def test_multiclass_gradients_bit_equal_to_the_reference():
    rng = np.random.default_rng(72)
    x = _raw(7, 73)
    y = rng.integers(0, 7, ROWS).astype(np.int32)
    w = rng.uniform(0.5, 2.0, ROWS).astype(np.float32)
    ref, port = _objectives("multiclass", 7)
    g_r, h_r = jax.jit(ref.grad_hess)(jnp.asarray(x), jnp.asarray(y),
                                      jnp.asarray(w))
    g_p, h_p = port.grad_hess(torch.from_numpy(x), torch.from_numpy(y),
                              torch.from_numpy(w))
    assert np.array_equal(_bits(g_p.numpy()), _bits(g_r))
    assert np.array_equal(_bits(h_p.numpy()), _bits(h_r))


def test_card_tensors_keep_torch_sum():
    """On a CUDA tensor the class sum is ``torch.sum`` (as ``link_exp``
    keeps ``torch.exp`` there); checked on the CPU through the dispatch."""
    e = torch.from_numpy(np.exp(_raw(40, 5) / 4).astype(np.float32))
    # past 32 classes the CPU takes torch's order too
    assert torch.equal(class_sum(e), e.sum(dim=-1, keepdim=True))

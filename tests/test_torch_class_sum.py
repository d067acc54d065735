"""The softmax's class sum on the CPU (ROADMAP C.1's residual).

XLA's CPU reduction adds the classes of a row left to right in f32 for up
to 32 classes; ``torch.sum`` adds them in its vectorised order, which
differs on most rows from 7 classes up.  ``multiclass.class_sum`` repeats
XLA's order on CPU tensors, so the port's ``_softmax``, the one-vs-all
transform and the multiclass gradients equal the reference's jitted
functions bit for bit.  Past 32 classes XLA's CPU reduction adds windows
of 32 classes (the row padded with zeros, half before and half after),
each left to right from 0, then the window sums by the same rule;
``class_sum`` repeats that too.
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


@pytest.mark.parametrize("k", [3, 7, 32, 33, 40, 64, 65, 100, 257])
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


def _windowed(e):
    """XLA's CPU order past 32 classes, in numpy: zero-padded windows of 32
    classes (half the padding before), each summed left to right from 0,
    then the window sums by the same rule."""
    k, w = e.shape[1], XLA_SEQUENTIAL_CLASSES
    if k <= w:
        acc = np.zeros(len(e), np.float32)
        for c in range(k):
            acc = (acc + e[:, c]).astype(np.float32)
        return acc
    pad = w * -(-k // w) - k
    ep = np.pad(e, ((0, 0), (pad // 2, pad - pad // 2)))
    sums = np.stack([_windowed(ep[:, i:i + w])
                     for i in range(0, ep.shape[1], w)], axis=1)
    return _windowed(sums)


@pytest.mark.parametrize("k", [33, 64, 100, 1100])
def test_class_sum_takes_windows_past_32_classes(k):
    """Past 32 classes the sum is XLA's windowed tree, equal to the
    reference's jitted ``jnp.sum``, and not the left-to-right order."""
    e = np.exp(_raw(k, 200 + k) / 4).astype(np.float32)
    got = class_sum(torch.from_numpy(e))[:, 0].numpy()
    assert np.array_equal(_bits(got), _bits(_windowed(e)))
    want = np.asarray(jax.jit(lambda a: jnp.sum(a, axis=-1))(
        jnp.asarray(e)))
    assert np.array_equal(_bits(got), _bits(want))
    seq = np.zeros(ROWS, np.float32)
    for c in range(k):
        seq = (seq + e[:, c]).astype(np.float32)
    assert np.mean(_bits(got) != _bits(seq)) > 0.1


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


@pytest.mark.parametrize("k", [7, 33])
def test_multiclass_gradients_bit_equal_to_the_reference(k):
    rng = np.random.default_rng(72)
    x = _raw(k, 73)
    y = rng.integers(0, k, ROWS).astype(np.int32)
    w = rng.uniform(0.5, 2.0, ROWS).astype(np.float32)
    ref, port = _objectives("multiclass", k)
    g_r, h_r = jax.jit(ref.grad_hess)(jnp.asarray(x), jnp.asarray(y),
                                      jnp.asarray(w))
    g_p, h_p = port.grad_hess(torch.from_numpy(x), torch.from_numpy(y),
                              torch.from_numpy(w))
    assert np.array_equal(_bits(g_p.numpy()), _bits(g_r))
    assert np.array_equal(_bits(h_p.numpy()), _bits(h_r))


def test_card_tensors_keep_torch_sum():
    """On a tensor off the CPU the class sum is one ``torch.sum`` (as
    ``link_exp`` keeps ``torch.exp`` on the card); checked here on tensors
    of the ``meta`` device, with every torch function the sum calls
    recorded."""
    from torch.overrides import TorchFunctionMode

    class Calls(TorchFunctionMode):
        def __init__(self):
            super().__init__()
            self.names = []

        def __torch_function__(self, func, types, args=(), kwargs=None):
            self.names.append(getattr(func, "__name__", str(func)))
            return func(*args, **(kwargs or {}))

    for k in (7, 40):
        e = torch.empty((ROWS, k), device="meta")
        with Calls() as calls:
            out = class_sum(e)
        assert out.shape == (ROWS, 1) and out.device.type == "meta"
        # attribute reads (``shape``, ``device``) aside, one sum
        assert [n for n in calls.names if n != "__get__"] == ["sum"]

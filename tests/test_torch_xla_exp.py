"""The links' ``exp`` on the CPU (ROADMAP C.1's second cause).

XLA's CPU backend computes f32 ``exp`` with Cephes' single-precision
polynomial, every multiply-add fused; ``torch.exp`` differs from it on
about 9.6 % of f32 inputs by an ulp, which moved binary and multiclass
gradients.  ``objectives.xla_exp_f32`` repeats XLA's arithmetic and is the
binary and multiclass link's ``exp`` on CPU tensors (``link_exp``).  It
must equal ``jnp.exp`` bit for bit on 2,000,001 evenly spaced points of
[-20, 20] and at the edges (clamps, overflow, infinities, NaN).
"""

import jax.numpy as jnp
import numpy as np
import torch

from lightgbm_tpu.multiclass import _softmax as r_softmax
from lightgbm_tpu_torch.multiclass import _softmax
from lightgbm_tpu_torch.objectives import link_exp, sigmoid, xla_exp_f32

EDGES = [0.0, -0.0, 1e-30, -1e-30, 88.7, 88.72, 88.8, 88.9, 100.0, -87.3,
         -87.8, -87.9, -100.0, -103.9, np.inf, -np.inf, np.nan]


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def test_xla_exp_bit_equal_to_jnp_exp_on_the_grid():
    x = np.linspace(-20, 20, 2_000_001).astype(np.float32)
    x = np.concatenate([x, np.float32(EDGES)])
    want = np.asarray(jnp.exp(jnp.asarray(x)))
    got = xla_exp_f32(torch.from_numpy(x)).numpy()
    assert np.array_equal(_bits(got), _bits(want))
    # the fault it repairs: torch's exp differs on ~10 % of the grid
    plain = torch.exp(torch.from_numpy(x)).numpy()
    assert np.mean(_bits(plain) != _bits(want)) > 0.05


def test_links_use_it_on_cpu_tensors():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 4, (1000, 7)).astype(np.float32)
    t = torch.from_numpy(x)
    assert torch.equal(link_exp(t), xla_exp_f32(t))
    want = 1.0 / (1.0 + np.asarray(jnp.exp(-jnp.asarray(x))))
    assert np.array_equal(_bits(sigmoid(t).numpy()), _bits(want))
    # the softmax's numerators and its class sum are XLA's: the port's
    # softmax is the reference's bit for bit
    assert np.array_equal(_bits(_softmax(t).numpy()),
                          _bits(r_softmax(jnp.asarray(x))))

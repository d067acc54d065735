"""Counter-based random numbers, bit-exact with the reference's ``jax.random``.

The reference draws its bagging and ``feature_fraction`` masks with
``jax.random`` under the default ``threefry2x32`` implementation with
``jax_threefry_partitionable=True``.  The same params and seed give the same
trees in both packages only if the masks are bit-identical, so this module
re-implements the three calls the training path makes:

* :func:`prng_key` — ``PRNGKey(seed)``: the key ``(seed >> 32, seed &
  0xFFFFFFFF)``;
* :func:`fold_in` — ``fold_in(key, i)``: the key hashed with the counter
  pair ``(0, i)``;
* :func:`uniform` — ``uniform(key, shape)`` in f32: the row-major flat index
  of each element split into a (hi, lo) 32-bit counter pair, hashed, the two
  output words XORed, the top 23 bits placed in the mantissa of a float in
  ``[1, 2)`` and 1 subtracted;
* :func:`split` — ``split(key, num)``: key ``i`` is the key hashed with the
  counter pair ``(0, i)`` (the partitionable scheme's ``iota_2x32_shape``
  counters), which is also what ``fold_in(key, i)`` hashes.

:func:`split_keys` and :func:`uniform_rows` are the batched forms the fused
cross-validation program uses: one key per batch element as an int64
``[E, 2]`` tensor, hashed in one pass on the caller's device;
:func:`fold_in_tensor` folds a tensor of counters (the node ids of a
per-node feature-mask table) into such keys on the device, and
:func:`key_tensor` / :func:`split_on` put keys there without a
host-to-device copy.

The hash is Threefry-2x32 with 20 rounds (Salmon et al., "Parallel random
numbers: as easy as 1, 2, 3", SC'11).  Words are uint32 values held in int64
tensors and masked with ``0xFFFFFFFF`` after every add and shift; the work is
a few dozen elementwise operations per call, on the caller's device.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple, Union

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

Key = Tuple[int, int]


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & _MASK


def threefry2x32(key, x0: torch.Tensor, x1: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 (20 rounds) of the counter pairs ``(x0, x1)`` under
    ``key``; the counters are int64 tensors holding uint32 values.  The key
    is a pair of ints, or a pair of int64 tensors that broadcast against the
    counters (one key per batch element)."""
    k0, k1 = key
    if isinstance(k0, torch.Tensor):
        k0, k1 = k0 & _MASK, k1 & _MASK
    else:
        k0, k1 = int(k0) & _MASK, int(k1) & _MASK
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def prng_key(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)`` for a seed in ``[0, 2**32)``."""
    seed = int(seed)
    if not 0 <= seed < (1 << 32):
        raise ValueError(f"seed must lie in [0, 2**32), got {seed}")
    return (seed >> 32) & _MASK, seed & _MASK


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in(key, data)``: the key hashed with the counter
    pair ``(0, data)``."""
    x0 = torch.zeros(1, dtype=torch.int64)
    x1 = torch.tensor([int(data) & _MASK], dtype=torch.int64)
    y0, y1 = threefry2x32(key, x0, x1)
    return int(y0[0]), int(y1[0])


def random_bits(key: Key, shape: Union[int, Sequence[int]],
                device: Union[str, torch.device] = "cpu") -> torch.Tensor:
    """32 random bits per element (int64 ``shape``): the partitionable
    scheme, one hash per element of its row-major flat index."""
    shape = (int(shape),) if isinstance(shape, int) else tuple(shape)
    numel = 1
    for d in shape:
        numel *= int(d)
    idx = torch.arange(numel, dtype=torch.int64, device=device)
    y0, y1 = threefry2x32(key, idx >> 32, idx & _MASK)
    return (y0 ^ y1).reshape(shape)


def _bits_to_unit(bits: torch.Tensor) -> torch.Tensor:
    one = 0x3F800000
    f = ((bits >> 9) | one).to(torch.int32).view(torch.float32)
    return f - 1.0


def uniform(key: Key, shape: Union[int, Sequence[int]],
            device: Union[str, torch.device] = "cpu") -> torch.Tensor:
    """``jax.random.uniform(key, shape)``: f32 in ``[0, 1)``."""
    return _bits_to_unit(random_bits(key, shape, device))


def split_keys(key: Key, num: int) -> torch.Tensor:
    """``jax.random.split(key, num)`` as an int64 ``[num, 2]`` CPU tensor."""
    idx = torch.arange(int(num), dtype=torch.int64)
    y0, y1 = threefry2x32(key, torch.zeros_like(idx), idx)
    return torch.stack([y0, y1], dim=1)


def split(key: Key, num: int) -> List[Key]:
    """``jax.random.split(key, num)``: ``num`` keys."""
    return [(int(a), int(b)) for a, b in split_keys(key, num).tolist()]


def fold_in_keys(keys: torch.Tensor, data: int) -> torch.Tensor:
    """``vmap(fold_in)(keys, data)`` over an int64 ``[E, 2]`` key tensor."""
    x1 = torch.full((keys.shape[0],), int(data) & _MASK, dtype=torch.int64,
                    device=keys.device)
    y0, y1 = threefry2x32((keys[:, 0], keys[:, 1]), torch.zeros_like(x1), x1)
    return torch.stack([y0, y1], dim=1)


def key_tensor(keys: Sequence[Key], device) -> torch.Tensor:
    """Host key pairs as an int64 ``[E, 2]`` tensor on ``device``, made by
    elementwise ops that take the words as scalars: a blocking
    host-to-device copy (or an item write) would wait for the work queued
    on the card, a host sync inside a tree."""
    col = torch.arange(2, device=device)
    return torch.stack([torch.where(col == 0, int(k0) & _MASK,
                                    int(k1) & _MASK) for k0, k1 in keys])


def split_on(key: Key, num: int, device) -> torch.Tensor:
    """``jax.random.split(key, num)`` as an int64 ``[num, 2]`` tensor
    hashed on ``device`` (the key's words enter as scalars: no
    host-to-device copy)."""
    idx = torch.arange(int(num), dtype=torch.int64, device=device)
    y0, y1 = threefry2x32(key, torch.zeros_like(idx), idx)
    return torch.stack([y0, y1], dim=1)


def fold_in_tensor(keys: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """``vmap(vmap(fold_in, (None, 0)))(keys, data)``: every counter of
    ``data`` (int64 ``[...]``, on the keys' device) folded into every key
    of ``keys`` (int64 ``[E, 2]``) -> int64 ``[E, *data.shape, 2]``, in one
    pass on the device (no host read)."""
    lead = (keys.shape[0],) + (1,) * data.dim()
    x1 = (data & _MASK)[None].expand(lead[:1] + tuple(data.shape))
    y0, y1 = threefry2x32((keys[:, 0].reshape(lead), keys[:, 1].reshape(lead)),
                          torch.zeros_like(x1), x1)
    return torch.stack([y0, y1], dim=-1)


def uniform_rows(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``vmap(lambda k: uniform(k, (n,)))(keys)``: f32 ``[E, n]`` on the
    keys' device, one hash per element."""
    idx = torch.arange(int(n), dtype=torch.int64, device=keys.device)
    y0, y1 = threefry2x32((keys[:, :1], keys[:, 1:]), (idx >> 32)[None, :],
                          (idx & _MASK)[None, :])
    return _bits_to_unit(y0 ^ y1)

"""Port parity: the out-of-core block store (``data/block_store.py``) on the
CPU, against the reference's ``lightgbm_tpu/data/block_store.py``.

* the layout rules: blocks a multiple of 256 rows, a single-block store at
  ceil256(n), a multi-block tail padded to ``block_rows`` — ``padded_rows``
  and the checksums equal the reference's store for the same codes, so
  every O(n) vector sized by it matches and streamed checkpoints
  interchange;
* the integrity screen: a mutated block fails its crc32
  (``OOCBlockError.kind == "corrupt"``), a reshaped one its shape
  (``"short"``), both quarantined at once with no retry;
* the bounded retry: armed ``block_read`` / ``device_put`` faults within
  ``max_read_retries`` are absorbed (``read_retries`` counts them), one that
  persists surfaces as ``kind="read"`` with the ``FaultError`` chained;
* the odometers: ``bytes_streamed`` per pass, ``passes``, ``verify_ms``;
  a ``ColumnViewStore`` moves only its columns and writes through to the
  parent; ``gather_rows`` equals the codes;
* ``Dataset.from_blocks`` refuses a one-shot generator.

Exact equality throughout (integer codes and byte counts).
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu.data.block_store as RB
import lightgbm_tpu_torch as P
from lightgbm_tpu_torch.data import BlockStore, ColumnViewStore, OOCBlockError
from lightgbm_tpu_torch.faults import FaultError, FaultInjector, FaultSpec


def _codes(n, f=5, seed=0):
    return np.random.default_rng(seed).integers(
        0, 64, (n, f)).astype(np.uint8)


@pytest.mark.parametrize("n,block_rows", [(300, 512), (512, 512),
                                          (1800, 512), (2048, 512),
                                          (5000, 1024)])
def test_layout_equals_reference(n, block_rows):
    codes = _codes(n)
    ours = BlockStore.from_binned(codes, block_rows)
    ref = RB.BlockStore.from_binned(codes, block_rows)
    assert ours.num_blocks == ref.num_blocks
    assert ours.padded_rows == ref.padded_rows
    assert ours.checksums == ref.checksums
    for a, b in zip(ours.blocks, ref.blocks):
        assert np.array_equal(a, b)
    if n <= block_rows:
        assert ours.padded_rows == -(-n // 256) * 256
    else:
        assert all(b.shape[0] == block_rows for b in ours.blocks)
    stacked = np.concatenate(ours.blocks)
    assert np.array_equal(stacked[:n], codes)
    assert not stacked[n:].any()


def test_layout_validation():
    with pytest.raises(ValueError, match="multiple of 256"):
        BlockStore.from_binned(_codes(100), 300)
    with pytest.raises(ValueError, match="multi-block"):
        BlockStore([_codes(512), _codes(256)], 768, 512)
    w = BlockStore.writer(256)
    w.append(_codes(10))
    with pytest.raises(ValueError, match="dtype"):
        w.append(_codes(10).astype(np.uint16))
    with pytest.raises(ValueError, match="ragged"):
        w.append(_codes(10, f=6))
    with pytest.raises(ValueError, match="no rows"):
        BlockStore.writer(256).finish()
    with pytest.raises(ValueError, match="prefetch"):
        list(BlockStore.from_binned(_codes(300), 256).device_blocks(0))


def test_cpu_blocks_and_odometers():
    codes = _codes(1800)
    store = BlockStore.from_binned(codes, 512)
    assert store.device.type == "cpu"
    got = []
    for off, b in store.device_blocks():
        assert isinstance(b, torch.Tensor) and b.device.type == "cpu"
        assert b.dtype == torch.uint8 and b.is_contiguous()
        got.append((off, b.numpy().copy()))
    assert [o for o, _ in got] == [0, 512, 1024, 1536]
    assert np.array_equal(np.concatenate([b for _, b in got])[:1800], codes)
    assert store.passes == 1 and store.verify_ms > 0.0
    assert store.bytes_streamed == store.padded_rows * 5
    list(store.device_blocks(prefetch_blocks=3))
    assert store.passes == 2
    assert store.bytes_streamed == 2 * store.padded_rows * 5
    assert store.device_buffers == 0 and store.peak_device_buffers == 0


@pytest.mark.parametrize("how,kind", [("flip", "corrupt"),
                                      ("reshape", "short")])
def test_integrity_screen_quarantines(how, kind):
    store = BlockStore.from_binned(_codes(1800), 512)
    store._sleep = lambda s: None
    if how == "flip":
        store.blocks[2][7, 3] ^= 0xFF
    else:
        store.blocks[2] = store.blocks[2][:256]
    with pytest.raises(OOCBlockError) as ei:
        list(store.device_blocks())
    assert ei.value.block == 2 and ei.value.kind == kind
    assert store.quarantined == {2} and store.read_retries == 0
    store.verify_checksums = False
    if how == "flip":
        assert len(list(store.device_blocks())) == 4


@pytest.mark.parametrize("site", ["block_read", "device_put"])
def test_transient_faults_retried(site):
    codes = _codes(1800)
    store = BlockStore.from_binned(codes, 512)
    slept = []
    store._sleep = slept.append
    store.fault_injector = FaultInjector([FaultSpec(site, after=1,
                                                    times=2)])
    out = np.concatenate([b.numpy() for _, b in store.device_blocks()])
    assert np.array_equal(out[:1800], codes)
    assert store.read_retries == 2
    assert slept == [store.retry_backoff_s, 2 * store.retry_backoff_s]
    # a fault that outlasts the retries names its block
    store.fault_injector = FaultInjector([FaultSpec(site, after=0,
                                                    times=-1)])
    with pytest.raises(OOCBlockError) as ei:
        list(store.device_blocks())
    assert ei.value.kind == "read" and ei.value.block == 0
    assert ei.value.attempts == store.max_read_retries + 1
    assert isinstance(ei.value.__cause__, FaultError)
    assert not store.quarantined


def test_column_view_store_bytes_and_write_through():
    codes = _codes(1800, f=8)
    store = BlockStore.from_binned(codes, 512)
    cols = np.array([1, 4, 6])
    view = ColumnViewStore(store, cols)
    assert view.num_features == 3 and view.padded_rows == store.padded_rows
    out = np.concatenate([b.numpy() for _, b in view.device_blocks()])
    assert np.array_equal(out[:1800], codes[:, cols])
    assert store.bytes_streamed == store.padded_rows * 3
    view.bytes_streamed += 10           # writes reach the parent
    assert store.bytes_streamed == store.padded_rows * 3 + 10
    idx = np.array([5, 900, 1799, 0, 513])
    assert np.array_equal(view.gather_rows(idx), codes[idx][:, cols])
    assert np.array_equal(store.gather_rows(idx), codes[idx])
    ref = RB.BlockStore.from_binned(codes, 512)
    assert np.array_equal(store.gather_rows(idx, col_ids=cols),
                          ref.gather_rows(idx, col_ids=cols))
    with pytest.raises(ValueError, match="out of range"):
        ColumnViewStore(store, [0, 8])
    with pytest.raises(ValueError, match="non-empty"):
        ColumnViewStore(store, [])


def test_from_blocks_refuses_one_shot_generator():
    X = np.random.default_rng(1).normal(size=(600, 3))
    gen = (X[i:i + 200] for i in range(0, 600, 200))
    with pytest.raises(ValueError, match="two passes"):
        P.Dataset.from_blocks(gen, device="cpu")
    ds = P.Dataset.from_blocks(lambda: (X[i:i + 200]
                                        for i in range(0, 600, 200)),
                               params={"stream_block_rows": 256},
                               device="cpu")
    assert ds.num_data() == 600 and ds.block_store.num_blocks == 3
    assert ds.row_mask.shape[0] == ds.block_store.padded_rows == 768

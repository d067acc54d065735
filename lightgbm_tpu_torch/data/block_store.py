"""Host-resident binned row blocks and their prefetch to the card — the port
of ``lightgbm_tpu/data/block_store.py``.

The out-of-core regime: the ``[n, F]`` binned code matrix does not live on
the device.  It lives here, as packed uint8 host blocks, and every
histogram pass of a streamed tree walks them through
:meth:`BlockStore.device_blocks`.  On a CUDA device the host blocks sit in
pinned memory and each block's copy runs ``non_blocking`` on a side
``torch.cuda.Stream`` into a ring of ``prefetch_blocks + 1`` device
buffers, ``prefetch_blocks`` blocks ahead of the consumer, so the PCIe copy
of block ``k+1`` overlaps the kernels of block ``k``.  Two events order
each buffer: the compute stream waits on the copy's event before it reads
the buffer, and the copy stream waits on an event recorded behind the last
kernel that read the buffer before it overwrites it (without the second
one, block ``k + depth + 1``'s copy would overwrite memory a histogram
kernel of block ``k`` is still reading).  A column view's active columns
are gathered into a pinned staging buffer per slot first, so its copies
are asynchronous too.  On a CPU device the store yields plain CPU
tensors, with no stream.

Block layout rules, kept verbatim from the reference so that
``padded_rows``, and every O(n) vector sized by it (scores, bag, labels),
match the reference's and streamed checkpoints interchange:

* ``block_rows`` must be a multiple of ``ROW_PAD_MULTIPLE`` (256);
* single-block stores (``ceil256(n) <= block_rows``) keep the block at
  ``ceil256(n)`` rows;
* multi-block stores pad the tail block to EXACTLY ``block_rows``.

The consumer sums the per-block histogram partials in float64 and rounds
once after the last block (``data/stream_grow.py``).

Every read is screened: the block's shape and crc32 against the ones
recorded at construction (a failure quarantines the block and raises
:class:`OOCBlockError` at once), and transient errors (the ``block_read``
and ``device_put`` fault sites, runtime transfer errors) are retried with
an exponential backoff up to ``max_read_retries`` times.  The odometers
``bytes_streamed`` (bytes sent to the device), ``read_retries``,
``verify_ms`` (host ms of the integrity screen) and, when ``time_waits``
is set, ``copy_wait_ms()`` (device ms the compute stream stalled on a
copy, by CUDA events) are what the round-time breakdown reads.
"""

from __future__ import annotations

import time
import zlib
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..dataset import ROW_PAD_MULTIPLE


class OOCBlockError(RuntimeError):
    """A block-store read failed — always carries WHICH block.

    ``kind`` classifies the quarantine reason:

    * ``"corrupt"`` — the block's bytes no longer match the checksum
      recorded at construction (host memory / file corruption);
    * ``"short"`` — the block's shape mutated away from the layout rules;
    * ``"read"`` — a transient read or transfer error persisted past the
      bounded retry.

    Upstream exceptions (an injected ``FaultError``, a CUDA transfer error)
    are chained as ``__cause__`` so the block index is never lost.
    """

    def __init__(self, message: str, block: int, kind: str = "read",
                 attempts: int = 1):
        super().__init__(message)
        self.block = int(block)
        self.kind = kind
        self.attempts = int(attempts)


def _check_block_rows(block_rows: int) -> int:
    block_rows = int(block_rows)
    if block_rows <= 0 or block_rows % ROW_PAD_MULTIPLE:
        raise ValueError(
            f"block_rows={block_rows} must be a positive multiple of "
            f"{ROW_PAD_MULTIPLE}")
    return block_rows


class BlockStore:
    """Immutable host store of binned row blocks (see module docstring).

    ``device`` (a ``torch.device``; CPU until the Dataset sets it) is where
    :meth:`device_blocks` puts the blocks."""

    def __init__(self, blocks: List[np.ndarray], num_rows: int,
                 block_rows: int):
        if not blocks:
            raise ValueError("BlockStore needs at least one block")
        self.blocks = blocks
        self.num_rows = int(num_rows)
        self.block_rows = _check_block_rows(block_rows)
        self.bytes_streamed = 0    # bytes sent to the device
        self.prefetch_blocks = 1   # lookahead depth (stream_prefetch_blocks)
        if len(blocks) > 1:
            for k, b in enumerate(blocks):
                if b.shape[0] != self.block_rows:
                    raise ValueError(
                        f"multi-block store: block {k} has {b.shape[0]} "
                        f"rows, expected exactly block_rows="
                        f"{self.block_rows}")
        # blocks are trusted at construction (the writer just built them);
        # the per-read verify catches anything that mutates them afterwards
        self.checksums = [zlib.crc32(np.ascontiguousarray(b).data)
                          for b in blocks]
        self._shapes = [b.shape for b in blocks]
        self.verify_checksums = True
        self.fault_injector = None     # faults.FaultInjector
        self.max_read_retries = 3      # transient-read attempts per block
        self.retry_backoff_s = 0.05    # base of the exponential backoff
        self._sleep = time.sleep       # injectable (tests pin to no-op)
        self.read_retries = 0          # absorbed-transient odometer
        self.quarantined: set = set()  # block indices that failed verify
        self.device = torch.device("cpu")
        self.passes = 0                # completed device_blocks() walks
        self.verify_ms = 0.0           # host ms of the integrity screen
        self.time_waits = False        # time the compute stream's waits
        self._wait_events: list = []
        self._pinned: Optional[List[torch.Tensor]] = None
        self._ring: Optional[List[torch.Tensor]] = None
        self._ring_key = None
        self._ring_free: list = []
        self._staging: Optional[List[torch.Tensor]] = None
        self._staged: list = []
        self._copy_stream = None
        self.device_buffers = 0        # ring buffers alive on the device
        self.peak_device_buffers = 0

    @property
    def num_blocks(self) -> int:
        return len(self.blocks)

    @property
    def num_features(self) -> int:
        return int(self.blocks[0].shape[1])

    @property
    def padded_rows(self) -> int:
        """Total padded row extent (the streamed analogue of n_pad)."""
        return int(sum(b.shape[0] for b in self.blocks))

    @property
    def nbytes(self) -> int:
        return int(sum(b.nbytes for b in self.blocks))

    @property
    def dtype(self):
        return self.blocks[0].dtype

    def _verify_block(self, k: int) -> np.ndarray:
        """Integrity screen for block ``k`` (shape then checksum); a failure
        quarantines the block — no retry can help — and raises at once."""
        t0 = time.perf_counter()
        b = self.blocks[k]
        try:
            if b.shape != self._shapes[k]:
                self.quarantined.add(k)
                raise OOCBlockError(
                    f"block {k} is short/misshapen: {b.shape} vs the "
                    f"{self._shapes[k]} it was built with", block=k,
                    kind="short")
            if self.verify_checksums and \
                    zlib.crc32(np.ascontiguousarray(b).data) \
                    != self.checksums[k]:
                self.quarantined.add(k)
                raise OOCBlockError(
                    f"block {k} failed its checksum (host-side corruption "
                    "after construction)", block=k, kind="corrupt")
        finally:
            self.verify_ms += 1e3 * (time.perf_counter() - t0)
        return b

    # -- the card: pinned host blocks, a copy stream, a ring of buffers ----
    def _pin(self) -> None:
        """Move the host blocks into pinned memory once (the numpy blocks
        become views of the pinned tensors: same bytes, same checksums)."""
        if self._pinned is not None:
            return
        pinned = []
        for k, b in enumerate(self.blocks):
            t = torch.empty(b.shape, dtype=torch.uint8, pin_memory=True)
            t.numpy()[...] = b
            pinned.append(t)
            self.blocks[k] = t.numpy()
        self._pinned = pinned

    def _ring_buffers(self, n_cols: int, depth: int,
                      sliced: bool) -> List[torch.Tensor]:
        """The ring of ``depth + 1`` device buffers for blocks of ``n_cols``
        columns, allocated once per shape (a new shape drops the old ring
        first, so at most one ring is alive); ``sliced`` (a column view)
        adds a pinned host staging buffer per slot, which the active
        columns are gathered into before their copy."""
        key = (n_cols, depth, sliced)
        if self._ring_key != key:
            if self._ring is not None and self._copy_stream is not None:
                # no copy may still be writing into a buffer we drop
                self._copy_stream.synchronize()
            self._ring = None
            self.device_buffers = 0
            shape = (self.blocks[0].shape[0], n_cols)
            self._ring = [torch.empty(shape, dtype=torch.uint8,
                                      device=self.device)
                          for _ in range(depth + 1)]
            self._ring_free = [None] * (depth + 1)
            self._staging = ([torch.empty(shape, dtype=torch.uint8,
                                          pin_memory=True)
                              for _ in range(depth + 1)] if sliced else None)
            self._staged = [None] * (depth + 1)
            self._ring_key = key
            self.device_buffers = depth + 1
            self.peak_device_buffers = max(self.peak_device_buffers,
                                           self.device_buffers)
        return self._ring

    def copy_wait_ms(self) -> float:
        """Device ms the compute stream stalled on block copies since the
        last call (needs ``time_waits``; synchronizes on the events)."""
        total = 0.0
        for a, b in self._wait_events:
            b.synchronize()
            total += a.elapsed_time(b)
        self._wait_events = []
        return total

    def _host_block(self, k: int, col_ids, out=None) -> np.ndarray:
        """Block ``k`` read and screened, with the bounded retry: transient
        errors back off exponentially and retry up to ``max_read_retries``
        times; integrity failures never retry.  ``col_ids`` (feature
        screening) slices the block to the active columns on the host,
        after the verify (the checksum covers the full block), into
        ``out`` when given."""
        from ..faults import FaultError

        last = None
        for attempt in range(self.max_read_retries + 1):
            if attempt:
                self.read_retries += 1
                self._sleep(self.retry_backoff_s * (2 ** (attempt - 1)))
            try:
                if self.fault_injector is not None:
                    self.fault_injector.check("block_read")
                b = self._verify_block(k)
                if col_ids is not None:
                    b = (np.ascontiguousarray(b[:, col_ids]) if out is None
                         else np.take(b, col_ids, axis=1, out=out))
                if self.fault_injector is not None:
                    self.fault_injector.check("device_put")
                return b
            except OOCBlockError:
                raise                      # quarantined: not transient
            except (FaultError, RuntimeError, OSError) as e:
                last = e
        raise OOCBlockError(
            f"block {k} read failed after "
            f"{self.max_read_retries + 1} attempts: {last}", block=k,
            kind="read",
            attempts=self.max_read_retries + 1) from last

    def device_blocks(self, prefetch_blocks: int = None, col_ids=None
                      ) -> Iterator[Tuple[int, torch.Tensor]]:
        """Yield ``(row_offset, block)`` u8 ``[rows, F]`` (``F`` the
        ``col_ids`` count when given) on the store's device, with blocks
        ``k+1 .. k+depth`` already on their way while the consumer works on
        block ``k``.  A yielded block is valid until the consumer resumes
        the iteration.  Depth defaults to ``prefetch_blocks``; 1 is the
        double buffer.  ``bytes_streamed`` counts what crossed to the
        device (the sliced bytes under ``col_ids``)."""
        depth = self.prefetch_blocks if prefetch_blocks is None \
            else int(prefetch_blocks)
        if depth < 1:
            raise ValueError(
                f"prefetch_blocks={depth} must be >= 1 (1 = double "
                "buffer)")
        if self.device.type == "cpu":
            yield from self._cpu_blocks(col_ids)
        else:
            yield from self._cuda_blocks(depth, col_ids)
        self.passes += 1

    def _cpu_blocks(self, col_ids):
        for k in range(len(self.blocks)):
            b = self._host_block(k, col_ids)
            self.bytes_streamed += b.nbytes
            yield k * self.block_rows, torch.from_numpy(b)

    def _cuda_blocks(self, depth: int, col_ids):
        self._pin()
        n = len(self.blocks)
        n_cols = self.num_features if col_ids is None else len(col_ids)
        ring = self._ring_buffers(n_cols, depth, col_ids is not None)
        compute = torch.cuda.current_stream(self.device)
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        copy = self._copy_stream
        slots = len(ring)
        ready = [None] * slots

        def issue(k: int) -> None:
            j = k % slots
            if col_ids is None:
                self._host_block(k, None)
                src_t = self._pinned[k]
            else:
                # the slot's last copy out of its staging buffer is done
                if self._staged[j] is not None:
                    self._staged[j].synchronize()
                src_t = self._staging[j]
                self._host_block(k, col_ids, out=src_t.numpy())
            with torch.cuda.stream(copy):
                if self._ring_free[j] is not None:
                    # the last kernel that read this buffer is done
                    copy.wait_event(self._ring_free[j])
                ring[j].copy_(src_t, non_blocking=True)
                ev = torch.cuda.Event()
                ev.record(copy)
            ready[j] = self._staged[j] = ev

        for k in range(min(depth, n)):
            issue(k)
        for k in range(n):
            j = k % slots
            if k + depth < n:
                issue(k + depth)
            if self.time_waits:
                before = torch.cuda.Event(enable_timing=True)
                before.record(compute)
            compute.wait_event(ready[j])
            if self.time_waits:
                after = torch.cuda.Event(enable_timing=True)
                after.record(compute)
                self._wait_events.append((before, after))
            self.bytes_streamed += int(ring[j].numel())
            try:
                yield k * self.block_rows, ring[j]
            finally:
                # the consumer has queued every kernel that reads block k
                free = torch.cuda.Event()
                free.record(compute)
                self._ring_free[j] = free

    def gather_rows(self, idx: np.ndarray, col_ids=None) -> np.ndarray:
        """Host-side row gather (GOSS at the source: only the sampled rows
        cross PCIe; ``col_ids`` restricts the gather to the active
        columns)."""
        idx = np.asarray(idx, np.int64)
        n_cols = self.num_features if col_ids is None else len(col_ids)
        out = np.empty((len(idx), n_cols), self.dtype)
        b = idx // self.block_rows
        r = idx - b * self.block_rows
        for k in range(len(self.blocks)):
            m = b == k
            if m.any():
                rows = self.blocks[k][r[m]]
                out[m] = rows if col_ids is None else rows[:, col_ids]
        return out

    @staticmethod
    def from_binned(codes: np.ndarray, block_rows: int) -> "BlockStore":
        """Chunk an already-binned [n, F] code matrix per the layout rules
        (tests and the GOSS full-matrix fallback)."""
        w = BlockStore.writer(block_rows)
        w.append(np.asarray(codes))
        return w.finish()

    @staticmethod
    def writer(block_rows: int) -> "_BlockWriter":
        return _BlockWriter(block_rows)


def shard_block_store(store: BlockStore, n_shards: int) -> List[BlockStore]:
    """Split a multi-block store into ``n_shards`` per-shard stores over
    CONTIGUOUS block ranges (streamed data parallelism).

    Each shard is a real :class:`BlockStore` over the same host blocks by
    reference (no copy; on a CUDA store the parent is pinned first and the
    shards share its pinned tensors), with its own ``bytes_streamed``
    odometer, ring of device buffers and copy stream, and the parent's
    verify, fault and retry settings.  Contiguity keeps the global row order
    shard-major: row ``i`` of shard ``s`` is global row ``s *
    rows_per_shard + i``, which is :func:`~..parallel.mesh.row_bounds`'s
    split of the resident vectors.  Requires ``num_blocks % n_shards ==
    0``, so the per-shard block walks stay in lockstep.
    """
    n_shards = int(n_shards)
    if n_shards < 1:
        raise ValueError(f"n_shards={n_shards} must be >= 1")
    if store.num_blocks % n_shards:
        raise ValueError(
            f"cannot shard {store.num_blocks} blocks across "
            f"{n_shards} devices: block count must be divisible so "
            "per-shard block walks stay in lockstep")
    if store.device.type == "cuda":
        store._pin()
    per = store.num_blocks // n_shards
    rows_per_shard = per * store.block_rows
    shards: List[BlockStore] = []
    for s in range(n_shards):
        lo = s * rows_per_shard
        real = max(0, min(store.num_rows - lo, rows_per_shard))
        ks = slice(s * per, (s + 1) * per)
        sh = BlockStore(store.blocks[ks], max(real, 1), store.block_rows)
        sh.num_rows = real          # may be 0 for all-padding tail shards
        if store._pinned is not None:
            sh._pinned = store._pinned[ks]
        sh.device = store.device
        for name in ("verify_checksums", "fault_injector",
                     "max_read_retries", "retry_backoff_s", "_sleep",
                     "prefetch_blocks"):
            setattr(sh, name, getattr(store, name))
        shards.append(sh)
    return shards


class ColumnViewStore:
    """A column-restricted VIEW of a BlockStore (feature screening).

    Wraps a store and a sorted global column-id vector; ``device_blocks``
    and ``gather_rows`` yield ``[rows, F_active]`` slices (sliced on the
    host, before the copy — the PCIe saving is real), while every other
    attribute — retry config, fault injector, device, quarantine set, the
    odometers — reads and writes through to the parent, so a view of a
    :func:`shard_block_store` shard counts its bytes on the real shard.
    Trees grown against a view live in compacted feature space; the caller
    remaps winners to global ids
    (``models.feature_mask.remap_split_features``).
    """

    def __init__(self, store, col_ids):
        object.__setattr__(self, "_store", store)
        object.__setattr__(
            self, "col_ids", np.asarray(col_ids, np.int64))
        if self.col_ids.ndim != 1 or len(self.col_ids) == 0:
            raise ValueError("col_ids must be a non-empty 1-D id vector")
        if self.col_ids.min() < 0 or \
                self.col_ids.max() >= store.num_features:
            raise ValueError(
                f"col_ids out of range for a {store.num_features}-feature "
                "store")

    def __getattr__(self, name):
        return getattr(self._store, name)

    def __setattr__(self, name, value):
        # writes (the GOSS round's ``bytes_streamed +=``, test knobs) go to
        # the parent: the view carries no state of its own
        setattr(self._store, name, value)

    @property
    def num_features(self) -> int:
        return int(len(self.col_ids))

    def device_blocks(self, prefetch_blocks: int = None):
        return self._store.device_blocks(prefetch_blocks,
                                         col_ids=self.col_ids)

    def gather_rows(self, idx: np.ndarray) -> np.ndarray:
        return self._store.gather_rows(idx, col_ids=self.col_ids)


class _BlockWriter:
    """Incremental BlockStore builder: appends arbitrary-length code
    chunks, emits fixed ``block_rows`` blocks, applies the single-block /
    padded-tail finalize rules."""

    def __init__(self, block_rows: int):
        self.block_rows = _check_block_rows(block_rows)
        self._blocks: List[np.ndarray] = []
        self._carry: List[np.ndarray] = []
        self._carry_rows = 0
        self._num_rows = 0
        self._dtype = None
        self._num_features = None

    def append(self, codes: np.ndarray) -> "_BlockWriter":
        codes = np.asarray(codes)
        if codes.ndim != 2:
            raise ValueError(f"code chunks must be 2-D, got {codes.shape}")
        if self._dtype is None:
            self._dtype = codes.dtype
            self._num_features = int(codes.shape[1])
        elif codes.dtype != self._dtype:
            raise ValueError(
                f"code dtype {codes.dtype} != first chunk's {self._dtype}")
        elif int(codes.shape[1]) != self._num_features:
            raise ValueError(
                f"ragged feature counts: {codes.shape[1]} vs "
                f"{self._num_features}")
        self._num_rows += int(codes.shape[0])
        self._carry.append(codes)
        self._carry_rows += int(codes.shape[0])
        while self._carry_rows >= self.block_rows:
            buf = np.concatenate(self._carry, axis=0)
            self._blocks.append(np.ascontiguousarray(buf[:self.block_rows]))
            rest = buf[self.block_rows:]
            self._carry = [rest] if rest.shape[0] else []
            self._carry_rows = int(rest.shape[0])
        return self

    def finish(self) -> BlockStore:
        if self._num_rows == 0:
            raise ValueError("no rows appended")
        n = self._num_rows
        n_pad = -(-n // ROW_PAD_MULTIPLE) * ROW_PAD_MULTIPLE
        carry = (np.concatenate(self._carry, axis=0) if self._carry
                 else np.zeros((0, self._num_features), self._dtype))
        if not self._blocks:
            # single block: pad to ceil256(n) only
            blk = np.zeros((n_pad, self._num_features), self._dtype)
            blk[:carry.shape[0]] = carry
            blocks = [np.ascontiguousarray(blk)]
        else:
            blocks = self._blocks
            if carry.shape[0]:
                tail = np.zeros((self.block_rows, self._num_features),
                                self._dtype)
                tail[:carry.shape[0]] = carry
                blocks = blocks + [np.ascontiguousarray(tail)]
        return BlockStore(blocks, n, self.block_rows)

"""Streamed x data-parallel training: per-shard block stores on a row mesh,
with one histogram merge per block-round — the port of
``lightgbm_tpu/data/stream_dp.py``.

The two scale axes compose: the ``[n, F]`` code matrix lives in host
blocks (:mod:`.block_store`) and the rows shard over a 1-D mesh
(``parallel.mesh``).  The parent store splits into D per-shard stores over
contiguous block ranges (:func:`~.block_store.shard_block_store`); shard
``s`` streams only its own blocks through its own ring of device buffers
and copy stream onto its own device, so each device's ingest bytes drop by
D.  :class:`StreamMesh` is a row source of the one streamed grower
(``data.stream_grow.stream_grow_tree``; serial streaming is its one-shard
case).  Each **block-round** (:func:`dp_block_rounds`) hands every shard
its local block ``j``; every shard runs the grower's per-block step of
``models/tree.py`` (``_stream_root_block`` / ``_stream_strict_block`` /
``_stream_wave_block``: kernel B1 at f32, bf16 or int8) on it, and the
shards' partials merge through ``ops.histogram.histogram_merge`` in the
configured mode and wire — once per block-round.  The table work after a
pass (kernel B3 for a strict split iteration, the wave body's steps for a
wave) runs once, on shard 0's device: the merged decision is replicated.

Summation order (fixed, free of atomics): a block-round's partials merge
in shard order, shard 0 first (the ring modes in the ring's rotation, as
the in-memory mesh merges); the merged block-round results accumulate in
float64 in block order and round to f32 once after the last block-round,
as the serial streamed grower sums its block partials (a pass of one
block-round takes its merge as it is).  Under the reduce-scatter modes
the accumulator stays feature-sharded — each shard adds only its slice of
F — and the slices gather once per split iteration (or wave), when the
table step consumes the histogram.  So on exact (dyadic) sums a streamed
dp tree is bit-identical to the serial streamed tree, to the in-memory
mesh's and to the reference's streamed dp tree (which accumulates in f32);
on general data it holds the parity regime (split structure equal, leaves
within rtol 1e-5 / atol 1e-6).  A non-f32 wire is tolerance-gated, never
bit-claimed.

What lives where: as on the in-memory mesh, the statistics, train scores,
labels, weights and bag stay whole on the Booster's device in global row
order (shard-major, so shard ``s``'s rows are one contiguous range); each
shard receives its slice of the round's statistics and keeps its own
``row_leaf``.  GOSS at the source samples each shard's rows on the host
(``default_rng((seed, shard))``), sends each shard's sampled codes to that
shard's device only, and grows the tree on the compacted shards through
the in-memory mesh step (``parallel.data_parallel``: B1 per shard per
root, B2 per shard per wave), whose ring merges carry the configured
wire.  With virtual shards (``parallel.set_virtual_devices``) every
shard's ring sits on the one card.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ..models.tree import grow_tree
from ..ops.histogram import histogram_merge
from ..ops.predict import forest_depth_cap
from ..ops.split import fma
from ..parallel.mesh import (Mesh, _put, gather_rows, place_tables,
                             shard_rows)
from .stream_grow import goss_host_select, stream_tree_values

_F32 = torch.float32


def choose_stream_dp_devices(num_blocks: int, n_devices: int) -> int:
    """Largest device count <= ``n_devices`` dividing ``num_blocks``, so the
    per-shard block walks stay in lockstep (every block of a multi-block
    store is ``block_rows`` long, so the padded rows divide too)."""
    d = max(int(n_devices), 1)
    while d > 1 and num_blocks % d:
        d -= 1
    return d


def setup_stream_shards(store, mesh: Mesh):
    """Shard ``store`` over ``mesh`` and pin each shard's transfers to its
    own device -> the per-shard :class:`~.block_store.BlockStore` list
    (independent ``bytes_streamed`` odometers)."""
    from .block_store import shard_block_store

    shards = shard_block_store(store, mesh.size)
    for sh, dev in zip(shards, mesh.devices):
        sh.device = torch.device(dev)
    return shards


def drain_shard_odometers(store, shards) -> None:
    """Fold the per-shard odometers into the parent store's global
    ``bytes_streamed``, leaving the per-shard counters as they are."""
    store.bytes_streamed = sum(sh.bytes_streamed for sh in shards)


def dp_block_rounds(shards):
    """Yield, per block-round ``j``, the list of every shard's ``(local
    row offset, block)`` — shard ``s``'s local block ``j``, already on its
    device through its own prefetch ring.  The shards' walks advance in
    lockstep; a yielded block is valid until the next round."""
    gens = [sh.device_blocks() for sh in shards]
    for _ in range(shards[0].num_blocks):
        yield [next(g) for g in gens]
    for g in gens:
        next(g, None)        # each walk's end: the last slot freed, a pass


class StreamMesh:
    """The Booster's streamed data-parallel topology: the row ``mesh``, the
    per-shard stores and the merge (``mode`` one of the non-voting
    ``ops.histogram.MERGE_MODES``, ``wire`` and ``chunks`` for the ring
    modes).  It answers what the in-memory ``MeshLayout`` answers for the
    checkpoint and the row limits (``n_devices``, ``dr``, ``dc``,
    ``voting_k``), and is the streamed grower's row source over the mesh
    (``split``, ``hist``, ``gather``: ``data.stream_grow.SerialSource``
    states the protocol)."""

    def __init__(self, mesh: Mesh, shards, mode: str = "psum",
                 wire: str = "f32", chunks: int = 1):
        self.mesh = mesh
        self.shards = list(shards)
        self.mode, self.wire, self.chunks = mode, wire, int(chunks)
        self.voting_k = 0
        self.dr, self.dc = mesh.size, 1

    @property
    def n_devices(self) -> int:
        return self.mesh.size

    @property
    def lead(self) -> torch.device:
        return self.mesh.lead

    def with_shards(self, shards) -> "StreamMesh":
        """This topology over other per-shard stores (a screened round's
        column views of them)."""
        view = StreamMesh.__new__(StreamMesh)
        view.__dict__.update(self.__dict__)
        view.shards = list(shards)
        return view

    # -- the streamed grower's row source --------------------------------
    def split(self, stats: torch.Tensor) -> List[torch.Tensor]:
        return shard_rows(self.mesh.devices, stats)

    def hist(self, parts, block_fn) -> torch.Tensor:
        return stream_dp_pass(self, parts, block_fn)

    def gather(self, row_leaf) -> torch.Tensor:
        return gather_rows(row_leaf, self.lead)

    def merge(self, parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """One block-round's merge of the shards' partials ``[K, F, B, 3]``:
        ``[full histogram]`` on shard 0's device (psum), or each shard's
        padded feature slice on its device (reduce-scatter modes)."""
        from ..parallel.data_parallel import MERGE_TIMER

        timed = MERGE_TIMER["on"] and self.lead.type == "cuda"
        if timed:
            e0 = torch.cuda.Event(enable_timing=True)
            e0.record()
        if self.mode == "psum":
            out = [histogram_merge(parts, "psum")[0]]
        else:
            out = histogram_merge(parts, self.mode, self.n_devices,
                                  self.wire, self.chunks)
        if timed:
            e1 = torch.cuda.Event(enable_timing=True)
            e1.record()
            MERGE_TIMER["pairs"].append((e0, e1))
        return out


def stream_dp_pass(smesh: StreamMesh, stats_parts, block_fn) -> torch.Tensor:
    """One histogram pass over every shard's blocks: per block-round,
    ``block_fn(s, off, bins_b, stats_b)`` gives shard ``s``'s partial of its
    local block and the partials merge; the merged block-rounds accumulate
    in float64 in block order (per shard under the reduce-scatter modes)
    and round once.  Returns the full histogram ``[K, F, B, 3]`` f32 on
    shard 0's device: the reduce-scatter slices gather here, once."""
    shards = smesh.shards
    accs = None
    single = shards[0].num_blocks == 1
    for blocks in dp_block_rounds(shards):
        parts = []
        for s, (off, bins_b) in enumerate(blocks):
            nb = bins_b.shape[0]
            parts.append(block_fn(s, off, bins_b,
                                  stats_parts[s][off:off + nb]))
        merged = smesh.merge(parts)
        if single:
            accs = merged
        elif accs is None:
            accs = [m.to(torch.float64) for m in merged]
        else:
            for a, m in zip(accs, merged):
                a.add_(m)
    if not single:
        accs = [a.to(_F32) for a in accs]
    lead = smesh.lead
    if len(accs) == 1:
        return _put(accs[0], lead)
    full = torch.cat([_put(a, lead) for a in accs], dim=-3)
    return full[..., :shards[0].num_features, :, :]


def stream_dp_goss_round(smesh: StreamMesh, obj, y, w, bag, pred, fmask,
                         hyper, goss_k_shard, top_rate: float,
                         other_rate: float, seed: int, num_leaves: int,
                         num_bins: int, hist_impl: str, hist_dtype: str,
                         wave_width: int):
    """One GOSS round sampled per shard at the source.

    Each shard samples its own row range on the host
    (:func:`~.stream_grow.goss_host_select` under ``default_rng((seed,
    shard))``, ``goss_k_shard`` rows), gathers only those rows' codes,
    counted on its own odometer, and sends them to its own device.  The
    compacted shards then grow one tree through the in-memory mesh step
    (``parallel.data_parallel.MeshTreeRows`` with the mesh's merge and
    wire; the compacted statistics, ``k`` rows of three floats a shard,
    split from the Booster's device), and one streamed traversal pass per
    shard gives every row's value for ``fma(lr, value, pred)``."""
    from ..parallel.data_parallel import MeshLayout, mesh_rows

    shards = smesh.shards
    g, h = obj.grad_hess(pred, y, w)
    g_abs = g.abs().cpu().numpy()               # host reads: the sampling
    bag_h = bag.cpu().numpy()
    rows_ps = g_abs.shape[0] // len(shards)
    idx_parts, wt_parts, bins_parts = [], [], []
    for s, sh in enumerate(shards):
        lo = s * rows_ps
        idx_l, wt_l = goss_host_select(g_abs[lo:lo + rows_ps],
                                       bag_h[lo:lo + rows_ps], goss_k_shard,
                                       top_rate, other_rate, (int(seed), s))
        # GOSS at the source, per shard: only its sampled rows cross, to
        # its own device
        bins_s = sh.gather_rows(idx_l)
        sh.bytes_streamed += bins_s.nbytes
        bins_parts.append(torch.from_numpy(bins_s).to(sh.device))
        idx_parts.append(lo + idx_l)
        wt_parts.append(wt_l)
    dev = pred.device
    idx = torch.from_numpy(np.concatenate(idx_parts)).to(dev)
    wt = torch.from_numpy(np.concatenate(wt_parts)).to(dev)
    live = (bag[idx] > 0).to(_F32) * (wt > 0).to(_F32)
    wt = wt * live
    stats = torch.stack([g[idx] * wt, h[idx] * wt, live], dim=-1)
    layout = MeshLayout.of_row_blocks(smesh.mesh, bins_parts, num_bins,
                                      smesh.mode, smesh.wire, smesh.chunks)
    # the rows carry every shard's codes; the grower reads no global matrix
    tree, _ = grow_tree(None, stats, fmask, hyper.ctx(), num_leaves,
                        num_bins, hyper.max_depth, hist_impl=hist_impl,
                        hist_dtype=hist_dtype, wave_width=wave_width,
                        rows=mesh_rows(layout, stats, wave_width, hist_impl,
                                       hist_dtype),
                        scorer=layout.scorer())
    depth = forest_depth_cap(tree)
    values = torch.cat([_put(stream_tree_values(
        sh, place_tables(tree, sh.device), depth), dev) for sh in shards])
    lr = torch.tensor(hyper.learning_rate, dtype=_F32, device=dev)
    return tree, fma(lr, values, pred)

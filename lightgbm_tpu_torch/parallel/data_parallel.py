"""Data-parallel (and feature-parallel) tree growth over a device mesh — the
port of ``lightgbm_tpu/parallel/data_parallel.py`` and the growth half of
``feature_parallel.py``.

Upstream's ``tree_learner="data"`` shards the rows: each shard builds
histograms of its own rows, the partials merge
(``ops.histogram.histogram_merge``) and every shard takes the same split
from the merged result, so the grown tree is replicated by construction.
``"voting"`` merges only the columns the shards vote for (PV-Tree), and
``"feature"`` shards the columns instead (``feature_parallel``); a 2-D
``(data, feature)`` mesh composes the two.

The reference runs one program per shard under ``shard_map``.  Here one
process drives the shards in turn through the growers of ``models/tree.py``
(the same growers serial training runs), which take their row work from a
*rows* object: :class:`MeshTreeRows` / :class:`MeshBatchRows` hold each
shard's binned block, statistics and ``row_leaf`` on the shard's device
and, per histogram pass, partition each shard's rows and build its partial
(kernel B1, B2 per wave, B5/B6 for a batch of trees), then merge.  The
table work after a merge (the split scan, the node table, the wave plan)
runs once, on shard 0's device: the merged decision is replicated, so one
host read a wave serves every shard.  A merge that leaves slices (the
reduce-scatter modes, feature shards) or local partials (voting) hands them
side by side to the mesh's split scorer
(:func:`~..models.tree.make_dist_scorer`).

What lives where: the Dataset, the train scores and the bag stay whole on
its device (``mesh.lead``) in global row order, as the Booster keeps them;
each shard holds its row block of the binned matrix (a view for a virtual
shard on that device) and receives its slice of the round's statistics.
With virtual shards (:func:`~.mesh.set_virtual_devices`) every hop is a
no-op; between distinct cards it is a peer copy.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ..models.tree import _PK, _strict_partition, batched_wave_route
from ..ops.histogram import (compute_histograms, compute_histograms_batched,
                             hist_partition_fused, hist_partition_plain,
                             histogram_merge, histograms_rows, resolve_mode,
                             route_wave, sr_round_bf16)
from .feature_parallel import broadcast_feature_column, shard_features
from .mesh import (DATA_AXIS, FEATURE_AXIS, Mesh, gather_rows, psum,
                   row_bounds, shard_rows)

# CUDA-event timing of every merge (chip_smoke.py reads it): while "on",
# each merge records a (start, end) event pair
MERGE_TIMER = {"on": False, "pairs": []}


def merge_ms() -> float:
    """The summed CUDA-event milliseconds of the merges recorded since the
    last call (synchronizes; 0.0 when none ran on a card)."""
    pairs = MERGE_TIMER["pairs"]
    MERGE_TIMER["pairs"] = []
    if not pairs:
        return 0.0
    torch.cuda.synchronize()
    return float(sum(a.elapsed_time(b) for a, b in pairs))


def _put(x, dev):
    return x if x is None or x.device == dev else x.to(dev, non_blocking=True)


class MeshLayout:
    """The Booster's sharded training matrix: ``mesh`` (rows x columns),
    the row ranges of the ``dr`` row blocks over the padded rows, the
    binned blocks ``blocks[i][j]`` and the merge topology (``mode`` one of
    ``ops.histogram.MERGE_MODES``, ``wire`` and ``chunks`` for the ring
    modes, ``voting_k``).  Feature-sharded meshes merge by ``psum`` over
    their data axis."""

    def __init__(self, mesh: Mesh, bins: torch.Tensor, num_bins: int,
                 mode: str = "psum", wire: str = "f32", chunks: int = 1,
                 voting_k: int = 0):
        self.mesh = mesh
        self.dr = mesh.axis_size(DATA_AXIS)
        self.dc = mesh.axis_size(FEATURE_AXIS)
        self.num_features = int(bins.shape[1])
        self.num_bins = int(num_bins)
        self.bounds = row_bounds(int(bins.shape[0]), self.dr)
        self.blocks = shard_features(mesh, bins)
        self.f_loc = int(self.blocks[0][0].shape[1])
        if self.dc > 1 and mode != "psum":
            raise ValueError(
                f"hist_merge={mode!r} is a data-parallel merge topology and "
                "cannot compose with feature sharding — the 2-D mesh keeps "
                "the psum merge")
        self.mode, self.wire = mode, wire
        self.chunks, self.voting_k = int(chunks), int(voting_k)
        self._view = None

    @classmethod
    def of_row_blocks(cls, mesh: Mesh, blocks: Sequence[torch.Tensor],
                      num_bins: int, mode: str = "psum", wire: str = "f32",
                      chunks: int = 1) -> "MeshLayout":
        """The layout of a 1-D row mesh over row blocks already on their
        shards' devices (``blocks[i]`` ``[k, F]`` on ``mesh.devices[i]``,
        one ``k`` for all): streamed GOSS's per-shard samples, which never
        meet on one device."""
        view = cls.__new__(cls)
        k = int(blocks[0].shape[0])
        view.mesh, view.dr, view.dc = mesh, mesh.size, 1
        view.num_features = view.f_loc = int(blocks[0].shape[1])
        view.num_bins = int(num_bins)
        view.bounds = [(i * k, (i + 1) * k) for i in range(mesh.size)]
        view.blocks = [[b.contiguous()] for b in blocks]
        view.mode, view.wire = mode, wire
        view.chunks, view.voting_k = int(chunks), 0
        view._view = None
        return view

    @property
    def n_devices(self) -> int:
        return self.mesh.size

    def device(self, i: int, j: int = 0) -> torch.device:
        return self.mesh.devices[i * self.dc + j]

    def scorer(self, num_features: Optional[int] = None):
        """The split scorer the merged histograms need (None: the plain
        scan of a full psum)."""
        from ..models.tree import make_dist_scorer

        f = self.num_features if num_features is None else num_features
        if self.dc > 1:
            return make_dist_scorer("reduce_scatter", self.dc, f)
        if self.mode == "psum":
            return None
        return make_dist_scorer(self.mode, self.dr, f, self.voting_k,
                                self.chunks)

    def screened(self, active_ids) -> "MeshLayout":
        """A layout whose blocks are the active columns (a screened round;
        1-D row meshes only), cached on the id set."""
        key = active_ids.tobytes()
        if self._view is not None and self._view[0] == key:
            return self._view[1]
        view = MeshLayout.__new__(MeshLayout)
        view.__dict__.update(self.__dict__)
        view.blocks = []
        for i, row in enumerate(self.blocks):
            ids = torch.from_numpy(active_ids.astype("int64")).to(
                row[0].device)
            view.blocks.append([row[0].index_select(1, ids).contiguous()])
        view.num_features = view.f_loc = int(len(active_ids))
        view._view = None
        self._view = (key, view)
        return view

    def compacted(self, idx: Sequence[torch.Tensor]) -> "MeshLayout":
        """A layout of each row block's rows ``idx[i]`` (local ids): a GOSS
        round's per-shard compaction.  1-D row meshes only."""
        view = MeshLayout.__new__(MeshLayout)
        view.__dict__.update(self.__dict__)
        view.blocks = [[row[0][ix.to(row[0].device)]]
                       for row, ix in zip(self.blocks, idx)]
        k = int(idx[0].shape[0])
        view.bounds = [(i * k, (i + 1) * k) for i in range(self.dr)]
        view._view = None
        return view

    def split_rows(self, x: torch.Tensor) -> List[torch.Tensor]:
        """``x``'s rows (global order) as the row blocks' slices, each on
        its block's device."""
        return shard_rows([self.device(i) for i in range(self.dr)], x)

    # -- the merge -------------------------------------------------------
    def merge(self, parts) -> torch.Tensor:
        """``parts[i][j]``: row block ``i``'s partial for column block
        ``j``, ``[..., f, B, 3]``.  Returns the merged representation on
        shard 0's device: the full histogram (psum), the slices side by
        side (reduce-scatter modes, column blocks) or the local partials
        stacked on axis ``-4`` (voting)."""
        timed = MERGE_TIMER["on"] and self.mesh.lead.type == "cuda"
        if timed:
            e0 = torch.cuda.Event(enable_timing=True)
            e0.record()
        lead = self.mesh.lead
        if self.dc > 1:
            cols = [psum([parts[i][j] for i in range(self.dr)])[0]
                    for j in range(self.dc)]
            out = torch.cat([_put(c, lead) for c in cols], dim=-3)
        else:
            hs = [p[0] for p in parts]
            if self.mode == "voting":
                out = torch.stack([_put(h, lead) for h in hs], dim=-4)
            elif self.mode == "psum":
                out = histogram_merge(hs, "psum")[0]
            else:
                slices = histogram_merge(hs, self.mode, self.dr, self.wire,
                                         self.chunks)
                out = torch.cat([_put(h, lead) for h in slices], dim=-3)
        if timed:
            e1 = torch.cuda.Event(enable_timing=True)
            e1.record()
            MERGE_TIMER["pairs"].append((e0, e1))
        return out

    def total(self, stats: Sequence[torch.Tensor]) -> torch.Tensor:
        """The roots' (g, h, count) totals: each row block's sum over its
        rows, ``psum``-ed (the reference's root totals under a slicing
        merge)."""
        return psum([s.sum(dim=0) for s in stats])[0].to(self.mesh.lead)

    def columns(self, i: int, feat: torch.Tensor) -> torch.Tensor:
        """Row block ``i``'s codes of the GLOBAL columns ``feat`` ``[k]``
        (``[n_i, k]``, by the owners' broadcast when the columns are
        sharded)."""
        return broadcast_feature_column(self.blocks[i], feat, self.f_loc)


class _RowsBase:
    def __init__(self, layout: MeshLayout, stats, hist_impl: str,
                 hist_dtype: str):
        self.layout = layout
        self.stats = layout.split_rows(stats)
        if hist_dtype == "bf16sr":
            # each shard rounds its own rows, hashed by their local index,
            # as the reference's grower does inside shard_map
            self.stats = [sr_round_bf16(s) if s.dim() == 2 else
                          sr_round_bf16(s.transpose(0, 1)).transpose(0, 1)
                          for s in self.stats]
            hist_dtype = "bf16"
        self.num_features = layout.num_features
        self.device = layout.mesh.lead
        self.num_bins = layout.num_bins
        self.hist_impl, self.hist_dtype = hist_impl, hist_dtype

    def total(self) -> Optional[torch.Tensor]:
        """The roots' totals from the rows under a slicing merge; None on a
        feature-sharded mesh, whose merged histogram holds every column (the
        grower then sums feature 0's bins, as the reference's psum path
        does)."""
        if self.layout.dc > 1:
            return None
        return self.layout.total(self.stats)

    @property
    def row_leaf(self) -> torch.Tensor:
        """The shards' ``row_leaf`` in global row order on shard 0's
        device."""
        if self._row_axis == 0:
            return gather_rows(self._row_leaf, self.device)
        return gather_rows([r.t() for r in self._row_leaf], self.device).t()


class MeshTreeRows(_RowsBase):
    """One tree's row work over a mesh, for the strict grower
    (``strict=True``: :class:`~..models.tree.StrictRows`' methods) or the
    wave grower (:class:`~..models.tree.WaveRows`' methods).  ``stats`` f32
    ``[n, 3]`` in global row order."""

    def __init__(self, layout: MeshLayout, stats: torch.Tensor,
                 hist_impl: str, hist_dtype: str, strict: bool):
        super().__init__(layout, stats, hist_impl, hist_dtype)
        self.strict_mode = strict
        self.e = 1
        self.fuse_split = layout.dc == 1
        self._row_axis = 0
        self._row_leaf = [torch.zeros((s.shape[0], 1) if strict else
                                      (s.shape[0],), dtype=torch.int32,
                                      device=s.device) for s in self.stats]

    def _hist(self, i: int, j: int, seg, k: int) -> torch.Tensor:
        dev = self.layout.device(i, j)
        return compute_histograms(
            self.layout.blocks[i][j], _put(self.stats[i], dev),
            _put(seg, dev), k, self.num_bins, impl=self.hist_impl,
            hist_dtype=self.hist_dtype)

    def _all(self, segs, k: int):
        lay = self.layout
        return lay.merge([[self._hist(i, j, segs[i], k)
                           for j in range(lay.dc)] for i in range(lay.dr)])

    def root(self) -> torch.Tensor:
        segs = [torch.zeros(s.shape[0], dtype=torch.int32, device=s.device)
                for s in self.stats]
        h = self._all(segs, 1)
        return h if self.strict_mode else h[0]      # [1, F, B, 3] / [F, B, 3]

    def total(self) -> Optional[torch.Tensor]:
        t = super().total()
        return t[None] if self.strict_mode and t is not None else t

    def strict(self, aux, scal, catmask, P) -> torch.Tensor:
        lay = self.layout
        segs = []
        for i in range(lay.dr):
            dev = lay.device(i)
            a, sc = _put(aux, dev), _put(scal, dev)
            cm, pp = _put(catmask, dev), _put(P, dev)
            bins = lay.blocks[i][0]
            if lay.dc > 1:
                bins = lay.columns(i, a[:, 1].to(torch.int64))   # [n_i, 1]
                a = a.clone()
                a[:, 1] = 0.0
            self._row_leaf[i], seg = _strict_partition(
                bins, self._row_leaf[i], a, sc, cm, pp)
            segs.append(seg[:, 0])
        return self._all(segs, 2).unsqueeze(0)              # [1, 2, F, B, 3]

    def wave(self, plan, fuse_part: bool, cat=None, catmask=None):
        lay = self.layout
        slot_of_node, feat, thr, dl, n_nodes = plan.route_args
        if fuse_part and lay.dc == 1:
            mode = resolve_mode(self.hist_dtype)
            parts = []
            for i in range(lay.dr):
                dev = lay.device(i)
                args = (lay.blocks[i][0], self.stats[i], self._row_leaf[i],
                        _put(slot_of_node, dev), _put(feat, dev),
                        _put(thr, dev), _put(dl, dev), n_nodes,
                        self.num_bins, mode)
                h, self._row_leaf[i] = (
                    hist_partition_plain(*args)
                    if self.hist_impl in ("plain", "jnp")
                    else hist_partition_fused(*args))
                parts.append([h])
            return lay.merge(parts)
        segs = []
        for i in range(lay.dr):
            dev = lay.device(i)
            f_i = _put(feat, dev)
            bins = lay.blocks[i][0]
            if lay.dc > 1:
                bins = lay.columns(i, f_i.to(torch.int64))      # [n_i, s]
                f_i = torch.arange(plan.s, dtype=torch.int32, device=dev)
            ckw = {} if cat is None else dict(cat=_put(cat, dev),
                                              catmask=_put(catmask, dev))
            seg, self._row_leaf[i] = route_wave(
                bins, self._row_leaf[i], _put(slot_of_node, dev), f_i,
                _put(thr, dev), _put(dl, dev), n_nodes, **ckw)
            segs.append(seg)
        return self._all(segs, plan.s)


class MeshBatchRows(_RowsBase):
    """``E`` trees' row work over a mesh (multiclass): the strict grower's
    (``strict=True``) or the batched wave grower's methods.  ``stats_t``
    f32 ``[n, E, 3]`` in global row order."""

    def __init__(self, layout: MeshLayout, stats_t: torch.Tensor,
                 hist_impl: str, hist_dtype: str, strict: bool):
        super().__init__(layout, stats_t, hist_impl, hist_dtype)
        self.strict_mode = strict
        self.e = int(stats_t.shape[1])
        self.fuse_split = layout.dc == 1
        if strict:
            self._row_axis = 0
            self._row_leaf = [torch.zeros((s.shape[0], self.e),
                                          dtype=torch.int32, device=s.device)
                              for s in self.stats]
        else:
            self._row_axis = 1
            self._row_leaf = [torch.zeros((self.e, s.shape[0]),
                                          dtype=torch.int64, device=s.device)
                              for s in self.stats]
            self._stats_b = [s.transpose(0, 1).contiguous()
                             for s in self.stats]      # [E, n_i, 3]

    def _rows_hist(self, i: int, j: int, seg_t, k: int) -> torch.Tensor:
        dev = self.layout.device(i, j)
        return histograms_rows(self.layout.blocks[i][j],
                               _put(self.stats[i], dev), _put(seg_t, dev),
                               k, self.num_bins, impl=self.hist_impl,
                               hist_dtype=self.hist_dtype)

    def root(self) -> torch.Tensor:
        lay = self.layout
        return lay.merge([[self._rows_hist(i, j, None, 1)[:, 0]
                           for j in range(lay.dc)] for i in range(lay.dr)])

    def strict(self, aux, scal, catmask, P) -> torch.Tensor:
        lay = self.layout
        segs = []
        for i in range(lay.dr):
            dev = lay.device(i)
            a, sc = _put(aux, dev), _put(scal, dev)
            cm, pp = _put(catmask, dev), _put(P, dev)
            bins = lay.blocks[i][0]
            if lay.dc > 1:
                bins = lay.columns(i, a[:, 1].to(torch.int64))   # [n_i, E]
                a = a.clone()
                a[:, 1] = torch.arange(self.e, dtype=a.dtype, device=dev)
            self._row_leaf[i], seg = _strict_partition(
                bins, self._row_leaf[i], a, sc, cm, pp)
            segs.append(seg)
        return lay.merge([[self._rows_hist(i, j, segs[i], 2)
                           for j in range(lay.dc)] for i in range(lay.dr)])

    def wave(self, route, w_width: int) -> torch.Tensor:
        lay = self.layout
        slot_of_node, prow, direct_left, n_nodes, wmask = route
        parts = []
        for i in range(lay.dr):
            dev = lay.device(i)
            r = (_put(slot_of_node, dev), _put(prow, dev),
                 _put(direct_left, dev), _put(n_nodes, dev),
                 _put(wmask, dev))
            bins = lay.blocks[i][0]
            if lay.dc > 1:
                # every split's GLOBAL column, fetched from its owner
                ew = self.e * w_width
                bins = lay.columns(i, r[1][..., _PK.CAND_FEAT].reshape(-1)
                                   .to(torch.int64))            # [n_i, E*W]
                pr = r[1].clone()
                pr[..., _PK.CAND_FEAT] = torch.arange(
                    ew, dtype=pr.dtype, device=dev).view(self.e, w_width)
                r = (r[0], pr) + r[2:]
            row_base = (torch.arange(bins.shape[0], device=dev)
                        * bins.shape[1])
            self._row_leaf[i], seg = batched_wave_route(
                bins, self._row_leaf[i], r, row_base, self.num_bins)
            parts.append([compute_histograms_batched(
                lay.blocks[i][j], _put(self._stats_b[i], lay.device(i, j)),
                _put(seg, lay.device(i, j)), w_width, self.num_bins,
                impl=self.hist_impl, hist_dtype=self.hist_dtype)
                for j in range(lay.dc)])
        return lay.merge(parts)


def mesh_rows(layout: MeshLayout, stats: torch.Tensor, wave_width: int,
              hist_impl: str, hist_dtype: str):
    """The rows object a grower needs at this (encoded) wave width: for one
    tree (``stats [n, 3]``) :class:`MeshTreeRows`, for a batch (``stats
    [n, E, 3]``) :class:`MeshBatchRows`, the strict grower's methods at
    width 1 and the wave growers' above."""
    from ..models.tree import decode_wave_width

    strict = decode_wave_width(int(wave_width))[0] <= 1
    cls = MeshTreeRows if stats.dim() == 2 else MeshBatchRows
    return cls(layout, stats, hist_impl, hist_dtype, strict=strict)

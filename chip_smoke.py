"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card and nvcc; exits non-zero (and prints no result line)
without them, or when any check fails.  It drives the port only
(``lightgbm_tpu_torch``) and imports nothing of JAX or ``lightgbm_tpu``.

Phases:

1. the card's name and power limit, torch/CUDA versions, and the build of
   every kernel from ``lightgbm_tpu_torch/csrc`` (nvcc's ptxas report);
2. the forest-predict kernel against its plain PyTorch version on the
   card, on the same inputs, bit for bit (``torch.equal``), at f32, bf16
   and int8 over a full-width forest (100 trees x 127 leaves, 28 columns,
   255 bins, ragged leaf-wise trees with dead-slot garbage and a
   single-leaf tree), three trees of 8,191 leaves (16,384 node slots, more
   than a block's shared memory holds), 1,000 trees and awkward shapes,
   among them rows of 256, 257 and 2,000 columns (codes staged in shared
   memory while a tile's fit 32 KB, read from global memory past that);
   then the 8,191-leaf trees deployed in a ``PredictorRuntime`` on the
   card and served, raw scores equal to the runtime's on the CPU;
3. the main path, once per forest precision, with every launch counter set
   to 0 just before and read just after: bin ``make_higgs_like`` rows with
   ``BinMapper.fit``, save a seed-made full-width forest to ``.npz``,
   ``ModelBank.deploy`` it by path with warm and canary, serve 4,096
   single-row requests through ``MicroBatcher`` and one 1,000,000-row
   ``PredictorRuntime.predict`` (16,384-row chunks), check answers against
   ``PackedForest.predict_numpy`` on a sample, assert that no dispatch fell
   back or took the legacy path, and ``!swap``/``!rollback`` through the
   CLI's ``_serve`` on in-memory streams;
4. each kernel against its plain version once more, bit for bit, on the
   main path's own tables and binned ``make_higgs_like`` rows at every
   bucket of the ladder; then times on the card (CUDA events, median of 5
   runs of 10 back-to-back launches queued behind a spin kernel) of each
   kernel and its plain version at every bucket, with the kernel's bound
   (bytes or operations) and its walk bound (the node visits' two
   dependent loads, one warp-wide load per clock on each SM at
   ``clocks.max.sm``); the whole table goes to
   ``build/chip_smoke/chip_smoke_report.json``;
5. the histogram kernels (``hist_fused``, B1; ``hist_partition``, B2) at f32
   and bf16 against a float64 sum on the card (``|kernel - f64| <= 1e-6 *
   sum |x|`` per cell, counts and row routing exact) and against their plain
   versions: the north-star root (1,000,000 rows x 28 features x 256 bins,
   one segment), a north-star wave (42 splits) and first wave (one split),
   both recorded from a real tree grown by the plain grower, three
   two-segment calls recorded from a strict tree (the root's split, a call
   of about the mean rows, one of at most 5,000 rows), 95 % of the rows
   and all but 300 outside both segments, one slot of a wave holding 90 %
   of its direct rows, and awkward shapes (ragged row counts, 1 and 300
   features, up to 64 segments with out-of-range ids, every row in one
   bin, empty segments); on dyadic statistics kernel == plain == f64
   exactly; two launches bit-equal;
6. the training main path at full width: ``Dataset(make_higgs_like(
   1,000,000))`` -> ``train`` of the north-star model (binary, 127 leaves,
   255 bins) for 10 rounds at the default histogram precision (bf16) and
   again at f32, counters at 0 just before each and read just after (every
   histogram on the path through the kernels, no plain-version call); AUC
   on ``make_higgs_like(200,000, seed=9)`` within 1e-4 of the same rounds
   through the plain versions; on dyadic labels the round-1 tree of the
   kernel path equals the plain path's; then ``pack_booster`` -> ``.npz`` ->
   ``ModelBank.deploy`` -> a 1,000,000-row ``PredictorRuntime.predict``
   within 1e-5 of ``Booster.predict``; a ``torch.profiler`` breakdown of
   three rounds (device time by kernel family: B1's passes, B2's, the
   rest; the device's busy share, host syncs); section 2's limit on the
   medians of three kernel/plain pairs of 10-round runs in turns (the
   kernel path no slower); then each histogram kernel's time, its plain
   version's, its bound (the bytes this data needs) and (B1) one
   ``index_add_`` call's, B1 at the root and the three recorded strict
   calls, B2 at the recorded wave and first wave;
7. the split-iteration kernel (B3, ``split_iter``) against its plain version
   bit for bit (table and pick) at E in {1, 5, 40} elements, F in {6, 28},
   B in {16, 63, 256}, capacity 253, on random, dyadic and tied histograms
   with per-element regularizers, inactive elements and depth caps, chained
   over iterations, the kernel on a clone of the table (it updates its
   table in place); chains with the table updated in place at E = 1,
   F = 28 (the strict Booster) and E = 5, F = 6 (``cv()``); the segstats
   histogram (B6, ``hist_segstats``) at Kc in {15, 30, 120, 240, 1080}
   channels on the diamonds split (about 45,800 x 6) and on 1,000,000 x 28,
   at f32 and bf16, against float64 and its plain version (``1e-6 *
   sum|x|`` per cell, exact on dyadic channels), two launches bit-equal;
8. this slice's path at full width, counters at 0 just before each run and
   read just after (no plain-version call on the kernel path): (a) the
   strict grower in a Booster at the north star (``grow_policy=
   "leafwise"``, 3 rounds) through the kernels and the plain versions, AUC
   apart by at most 1e-4, the dyadic round-1 trees equal, and a profiled
   strict round (device ms per round, B1's share); (b) ``cv()`` as
   examples/gridsearch_cv.py calls it (diamonds, 1,000 rounds, 5 folds,
   rmse, early stopping 5) through the kernels, and through the plain
   versions for its first 40 rounds: every fold-mean RMSE within 1e-5
   relative of the kernel run's, the best of those rounds equal; (c)
   ``run_grid_search`` over the 36 learning_rate=0.1 rows of the 108-config
   grid (six buckets), with per-bucket seconds and rounds, configs per hour
   and the top 3; a profiled fused round at num_leaves 127, E = 40; B6's
   time, plain time, bound and one ``index_add_`` call's; B3's at E = 40,
   20 and 5 (F = 6) and E = 1 (F = 28), beside an empty kernel's;
9. the batched fused histogram (B5, ``hist_fused_batched``) at f32 and bf16
   against float64 (``1e-6 * sum|x|`` per cell) and its plain version: a
   north-star wave (1,000,000 x 28, E = 5, K = 42), a Covertype-shaped wave
   (581,012 x 54, E = 7, K = 42), K = 22 (the route's edge), out-of-range
   segment ids on ragged rows; exact on dyadic statistics; two launches
   bit-equal;
10. ``cv()`` at the north star in the wave regime (``make_higgs_like(
   1,000,000)``, binary, 127 leaves, bf16, exact tail, 5 folds, early
   stopping 5; 20 rounds, cut from the reference bench's 100 so that both
   runs fit) through the kernels and the plain versions: B5 launched, no
   plain-version call on the kernel path, ``best_iter`` equal, per-round
   fold-mean ``binary_logloss`` within 1e-4; on dyadic labels the five
   folds' round-1 predictions (every row) the same bits; seconds per round,
   a profiled round's device breakdown, and B5's time, plain time, bound and
   one ``index_add_`` call's at the round's widest wave;
11. multiclass at Covertype's shape (581,012 x 54 seed-made rows, 7 classes,
   127 leaves, 10 rounds: the class batch of the wave grower, B6 roots and
   B5 waves) through the kernels and the plain versions: held-out
   ``multi_logloss`` within 1e-4; on a dyadic tier (8 classes at a zero
   init score) the round-1 trees equal at bf16 and f32; the model saved as
   text and as ``.npz``, reloaded, and served through ``ModelBank`` (B4,
   ``[n, 7]``) within 1e-5 of ``Booster.predict``;
12. quantized-histogram training (``hist_dtype="int8"``, B1's int8 mode,
   ``hist_fused_int8``): (a) the kernel bit for bit against its plain
   version (the sums are exact integers), two launches bit-equal, and
   within the reference's bound ``scale * 4 * sqrt(rows in the cell + 9)``
   of the float64 sums of the unquantized statistics, at the north-star
   root, at the recorded 42-split wave (its direct children as segments)
   and at awkward shapes (a feature whose rows sit in one bin, empty
   segments, a segment holding every row, 42 segments with 70 % of the rows
   outside, a prime row count); 16,909,321 rows refused before any launch;
   (b)
   north-star training at int8 (10 rounds on the wave grower's unfused
   route: B1 int8 for every root and wave, B2 never) through the kernels
   and the plain versions, trees and predictions identical, held-out AUC
   no more than 0.01 below phase 6's bf16, int8 and bf16 rounds timed in
   turns; (c) the strict Booster at int8 (3 rounds: B1 int8 with two
   segments, B3), kernel and plain trees identical; (d) ``cv()`` at int8 on
   the diamonds split (B6 at f32, B3): ``best_iter`` and ``best_score``
   equal to phase 8b's f32 ``cv()``; (e) ``python -m lightgbm_tpu_torch
   task=train`` at int8 on a 200,000-row CSV written here, ``task=predict``
   equal to ``Booster(model_file=...).predict`` (to the file's 10
   significant digits), and the model through ``pack_booster`` and
   ``task=serve`` within 1e-5; then B1 int8's time, plain time, bound and
   one ``index_add_`` call's at the root, the wave and a two-segment call;
13. recovery on the card, every launch counter at 0 just before each run
   and read just after: (a) ``train_resumable`` at the north star with
   ``bagging_fraction=0.8``, ``bagging_freq=1``, ``feature_fraction=0.8``
   (12 rounds, a checkpoint every 4, the generation-4, -8 and -12 files
   kept; B1, B2), the same run sent SIGTERM by its own round hook after
   round index 6 (it returns preempted at 7 rounds with a checkpoint) and
   resumed to 12, and ``resume_booster`` from the generation-4 and -8
   files continued to 12: every tree field, ``_pred_train`` and ``_bag``
   equal to the uninterrupted run's bit for bit, and each model served
   through ``PredictorRuntime`` (B4) on 16,384 rows equal bit for bit;
   the checkpoint's bytes, ``save_checkpoint`` ms and ``resume_booster``
   ms; (b) ``python -m lightgbm_tpu_torch task=train checkpoint_dir=...
   checkpoint_rounds=5 num_trees=30`` on phase 12e's 200,000-row CSV in a
   subprocess, sent SIGTERM once its first checkpoint file appears (it must
   exit 0 and print "preempted"), rerun to its end: the model file equal,
   byte for byte, to an uninterrupted run's; (c) a 12-config sweep (the
   num_leaves 31, learning_rate 0.1 bucket of ``paramGrid.json``'s axes)
   on phase 8's diamonds split with an ``.RData`` ledger and carry
   checkpoints (100 rounds, 5 folds, early stopping 5, a segment every 25
   rounds), stopped by a ``FaultInjector`` at ``sweep_segment`` hit 3
   and rerun: ``resumed_units >= 1`` and the ledger file equal, byte for
   byte, to an uninterrupted run's, with and without carry checkpoints
   (B6, B3); the uninterrupted run's seconds with and without them;
14. examples/bagging_boosting.py's calls and rf with per-node sampling
   (``boosting="rf"``, ``feature_fraction_bynode``), every launch counter
   at 0 just before each run and read just after: (a) the script's calls at
   its own sizes (``make_boosting_curve(1000, 8657)``, one column, its
   params): ``cv`` (5 folds, early stopping 50, the script's 1,000 rounds
   cut to 40 on both paths; fused strict, B6 + B3) through the kernels
   and the plain versions (fold-mean RMSE per round within 1e-5 relative,
   ``best_iter`` equal, ``best_score`` within 1e-5), ``train`` of 300 rounds
   (B1 + B3; the plain run the first 20 rounds, the plain versions being
   launch-bound at 1,000 rows) and ``predict(grid, ntree_limit=k)`` for k
   in {1, 20, 50, 100, 300} (kernel vs plain within 1e-5 up to 20 trees;
   the RMSE against the true curve falls
   with k and differs across k), the staged fits served through
   ``PredictorRuntime`` (B4) within 1e-5, ``LGBMRandomForestRegressor``
   forests of 1, 3 and 100 trees fitted and served (RMSE falling from 1 to
   100); B1, B6, B3 and B4 at F = 1 against their plain versions once; (b)
   an rf forest at the north star (``make_higgs_like(1,000,000)``, binary,
   127 leaves, 255 bins, ``bagging_fraction=0.632``, ``bagging_freq=1``,
   ``feature_fraction_bynode=5/28``; 6 trees on the wave grower, B1 roots
   and B2 waves at bf16) through the kernels and the plain versions in
   turns: held-out AUC within 1e-4, the dyadic first tree equal, no host
   sync from drawing the mask tables (PyTorch's sync debug mode), a round's
   syncs with bynode on and off beside its waves, the forest served
   through ``PredictorRuntime`` on 16,384 rows within 1e-5 of
   ``Booster.predict``; (c) ``cv()`` on the diamonds split with
   ``feature_fraction_bynode=0.5`` (the batched unfused strict body: B6, no
   B3 launch; 15 rounds, cut from phase 8b's 1,000) through the kernels
   and the plain versions, ``best_iter`` equal, ``best_score`` within 1e-5
   relative; (d) fused ``cv()`` at 2^19
   rows x 28, 5 folds, 63 leaves, 3 rounds, ``feature_fraction_bynode=
   0.5`` (B6 roots, B5 waves): per-round fold-mean logloss within 1e-4 of
   the plain versions';
15. the remaining objectives, every launch counter at 0 just before each
   run and read just after: (a) ``regression_l1`` and ``quantile``
   (alpha 0.9) at the north star's width (``make_higgs_like(1,000,000)``'s
   rows, a continuous label: its logit plus N(0, 1) noise; 127 leaves, 255
   bins, bf16, 10 rounds on the wave grower: B1 roots, B2 waves, the leaf
   renewal after each tree) through the kernels and the plain versions in
   turns, beside l2 on the same data: trees structure-equal, leaf values
   and the held-out metric within 1e-5 relative; a profiled round's
   renewal device ms, the renewal run under
   ``torch.cuda.set_sync_debug_mode("error")`` (no host read); (b) the
   regression family on examples/gridsearch_cv.py's diamonds split with
   the price in dollars and the example's untuned call (learning rate
   0.1, cut to 8 rounds): huber, fair, poisson, gamma, tweedie, mape,
   cross_entropy (price over the largest price) and a custom ``fobj``
   (l2 in arithmetic operators) through the kernels and the plain
   versions, the held-out metric within 1e-5 relative; each model packed
   and 16,384 rows served through ``PredictorRuntime`` (B4, then the exp
   or sigmoid link) within 1e-5 (relative past 1) of ``Booster.predict``,
   the custom model refused as the reference refuses it; (c) fused
   ``cv()`` with ``regression_l1`` on phase 8's diamonds Dataset (5 folds,
   l1, early stopping 5, at most 8 rounds: B6, B3; no renewal, as the
   reference's fused program): ``best_iter`` equal, ``best_score`` within
   1e-5 relative; (d) ``hist_dtype="bf16sr"`` at the north star, 10 rounds:
   ``sr_round_bf16`` on the card bit-equal to the CPU's on the root
   statistics, kernel and plain trees equal, the AUC beside phase 6's bf16
   AUC and the s per round against bf16 in turns;
16. GOSS and DART at LightGBM's defaults, every launch counter at 0 just
   before each run and read just after: (a) GOSS at the north star
   (``top_rate`` 0.2, ``other_rate`` 0.1: 300,000 compacted rows, f32
   under "auto", B1 roots and B2 waves), 4 rounds through the kernels and
   the plain versions in turns beside the gbdt round: the selected rows
   and weights of every round equal on both paths, the card's selection
   equal to the CPU's on the same gradients and run under
   ``torch.cuda.set_sync_debug_mode("error")``, trees equal, AUC within
   1e-4; host syncs per round, the selection's and the full-row
   traversal's device ms from the profiler; 16,384 rows served by B4
   within 1e-5 of ``Booster.predict``; (b) multiclass GOSS at Covertype's
   shape, 3 rounds (B5 and B6 by the route rule): trees equal,
   ``multi_logloss`` within 1e-4; (c) DART at the north star (``drop_rate``
   0.1, ``max_drop`` 50, ``skip_drop`` 0.5), 20 rounds with the valid set
   attached: the same drops, stored leaves after rescaling equal within
   1e-5, valid AUC within 1e-4, the dropped-tree replay's CUDA-event ms
   per drop round, the final model served by B4 within 1e-5; (d)
   examples/gridsearch_cv.py's ``cv()`` arguments with ``boosting="goss"``
   and ``"dart"`` (the per-fold route, B1 and B2): GOSS's runs cut at 15
   rounds, DART's both at 20, fold-mean RMSE per round
   within 1e-5 and the best round equal; (e)
   DART on examples/bagging_boosting.py's curve (the strict grower: B1
   and B3), ``train_resumable`` killed by SIGTERM after round index 6 and
   resumed: every tree field, ``_pred_train`` and the served scores bit
   for bit as the uninterrupted run, its trees equal to the plain path's;
17. categorical features, every launch counter at 0 just before each run
   and read just after: (a) the north star's model on a seed-made table at
   the shape of szilard/GBM-perf's airline-delay data (1,000,000 x 8:
   Month, DayofMonth, DayOfWeek, UniqueCarrier, Origin and Dest as
   categories, Origin and Dest past the 254 a column keeps; DepTime,
   Distance), 6 rounds through the kernels and the plain versions in
   turns (waves on the unfused route: B1 bf16, no B2): AUC on 200,000
   held-out rows within 1e-4, the round-1 trees on a dyadic label equal
   (subset masks included), host syncs of a categorical and a numeric
   round with their sites (none of its own, no more beyond the one per
   wave), one round whose every split scan runs under
   ``torch.cuda.set_sync_debug_mode("error")``, a profiled round, the
   text model reloaded with predictions bit-equal, the forest served by
   the legacy traversal within 1e-5 with no B4 launch; (b) the strict
   grower, 3 rounds (B1 pairs, no B3), AUC within 1e-4; (c)
   examples/gridsearch_cv.py's ``cv()`` with cut, color and clarity as
   factors (fused strict, E = 5: B6, no B3; both runs cut at 15 rounds,
   ``best_iter`` compared); (d) multiclass at
   Covertype's shape with Wilderness_Area and Soil_Type as categorical
   columns, 3 rounds (B5, B6), ``multi_logloss`` within 1e-4; (e) int8
   (B1 int8) and GOSS (f32 B1) at (a)'s shape, 3 rounds each, trees and
   masks equal.  B2, B3 and B4 never launch on categorical data, as the
   reference routes it;
18. ranking, every launch counter at 0 just before each run and read just
   after: (a) the reference bench's MSLR configuration uncut (bench.py
   ``bench_mslr``: 1,000 queries x 100 documents x 136 features and 200
   held-out queries from ``default_rng(5)``, per-query feature offsets,
   top-heavy labels 0-4; ``lambdarank``, 63 leaves, learning rate 0.1,
   ``min_data_in_leaf`` 20, 255 bins, bf16, truncation at the query depth;
   the wave grower with the exact tail: B1 roots, B2 waves), 6 rounds
   through the kernels and the plain versions in turns: held-out NDCG@10
   within 1e-4, the round-1 trees equal (a near tie is recorded), host
   syncs per round, the lambda pass's device ms and launches, a profiled
   round, 20,000 held-out rows served by B4 within 1e-5 of
   ``Booster.predict``; (b) 1,500 ragged queries of 20-220 documents
   (about 180,000 rows x 136, MSLR-WEB30K's mean depth) with (a)'s recipe,
   6 rounds each path: the lambda pass's gather/scatter route over
   several query chunks with no host read (sync debug mode "error"),
   training NDCG@10 within 1e-4; (c) group-aware ``cv()`` at the reference
   test's ``make_ranked`` shape (40 queries of 8-24 documents, 6 features,
   3 folds, early stopping 5, 30 rounds; the strict grower: B1, B3): the
   whole-query folds equal to the reference's rule, per-round means
   within 1e-5, ``best_iter`` equal; (d) ``LGBMRanker.fit(group=,
   eval_set=, eval_group=, eval_at=[10])`` on (a)'s data, 20 rounds, its
   text model reloaded and served by B4 within 1e-5; a 12-round
   ``train_resumable`` killed by SIGTERM after round index 6 and resumed,
   bit for bit as the uninterrupted run;
19. constraints and randomized splits, every launch counter at 0 just
   before each run and read just after: (a) the north star with
   ``monotone_constraints`` +1 on columns 6 and 14 and -1 on column 17, 6
   rounds through the kernels and the plain versions (B1 roots, B2 waves,
   no plain-version call on the kernel path): AUC on
   ``make_higgs_like(200,000, seed=9)`` within 1e-4, the round-1 trees on a
   dyadic label equal and their overgrown node tables equal too (the bounds
   included), 1,000 held-out rows swept over every bin of each constrained
   column with the raw score never moving against the sign, exactly, on
   both paths; seconds a round beside phase 6's unconstrained round and
   against unconstrained rounds in turns, a profiled round; (b)
   ``extra_trees`` at the north star, 6 rounds: the rand-bin table of
   every round drawn on the card equal to the CPU's bit for bit, the dyadic
   round-1 trees equal, AUC within 1e-4, no host-sync site and no more
   syncs beyond the one per wave than an unconstrained round; (c)
   ``interaction_constraints`` of four groups of seven columns, 6 rounds:
   no root-to-leaf path across groups, the dyadic round-1 trees equal, AUC
   within 1e-4; (d) examples/advanced_features.py's monotone call (seed 7,
   4,000 training rows, ``[1, -1, 0, 0, 0]``, 60 rounds) as called (its
   rows pad to 4,096: the wave grower, B2) and on the strict grower (B1
   pairs, B3 never; 10 rounds): held-out RMSE within 1e-5 of the plain
   path, the raw score monotone over the held-out rows' sweeps, CUDA-event
   ms a split iteration and of the unfused body's scan; (e) multiclass at
   Covertype's shape with its first column constrained, 3 rounds (B6 roots,
   B5 waves): ``multi_logloss`` within 1e-4; (f) (a)'s model served by B4
   within 1e-5 of ``Booster.predict``.
20. linear leaves and introspection, every launch counter at 0 just
   before each run and read just after: (a) ``linear_tree=True`` at the
   north star (``enable_bundle=False``), 6 rounds through the kernels and
   the plain versions in turns (B1 roots, B2 waves, then the ridge fit in
   plain PyTorch; no plain-version call on the kernel path): AUC on
   ``make_higgs_like(200,000, seed=9)`` within 1e-4, the dyadic round-1
   trees equal in every field (``linear_feat``, ``linear_coef``), the
   fit's CUDA-event ms a round, seconds a round beside a constant-leaf
   round and phase 6's, host syncs of a linear and a constant round (the
   fit adds none), one round's fit under ``torch.cuda.set_sync_debug_mode(
   "error")``; (b) examples/advanced_features.py's linear call (seed 7,
   4,000 rows, 8 leaves, 25 rounds: the strict grower, B1 pairs and B3)
   beside its constant-leaf twin: held-out RMSE within 1e-5 of the plain
   path and below the constant one, CUDA-event ms a split iteration and a
   fit; (c) TreeSHAP on the card: the example's monotone model (60 rounds),
   500 held-out rows, additive within 1e-4 and within 1e-5 of the same
   model's contributions on CPU tensors; 4,096 rows of (a)'s constant-leaf
   counterpart (10 trees of 127 leaves): seconds, additivity, peak memory;
   (d) ``pred_leaf`` of 16,384 rows of that model, ``dump_model`` and
   ``create_tree_digraph``'s text equal to the CPU's; (e) (b)'s model
   through the text model reloaded with predictions bit-equal on the card,
   and ``pack_booster`` (and ``save_model`` to ``.npz``) refusing it by
   name.
21. continuation, every launch counter at 0 just before each run and read
   just after, on the Datasets phases 6, 8 and 11 built: (a) the north
   star with phase 13's bagging and feature fraction, 5 rounds continued
   5 more through ``train(init_model=<Booster>)``, ``train(init_model=
   <JSON model file>)``, ``Booster(model_file).update(ds)`` and
   ``train_resumable(init_model=)``: every tree field, ``_pred_train`` and
   the bag equal to 10 uninterrupted rounds bit for bit (B1 roots, B2
   waves); the replay's CUDA-event ms at 5 and at 10 trees, the 10-tree
   replay equal to the live scores; (b) that 127-leaf model continued 3
   rounds at 31 leaves and learning rate 0.05 (a forest of two node
   capacities): ``predict(num_iteration=10)`` within rtol 1e-6 of the first
   model's (bit-equality recorded), 16,384 rows served through B4 within
   1e-5 of ``Booster.predict``, a DART continuation of 3 rounds whose drops
   span both capacities, and ``train_resumable`` of the mixed forest killed
   by SIGTERM and resumed bit for bit; (c) ``rollback_one_iter`` twice
   with a valid set: valid scores within 1e-6 of the 8-round run's, then 2
   more rounds; (d) ``refit`` of the 10-round model on ``make_higgs_like(
   200,000, seed=9)``: two refits on the card bit-identical, the card's
   refit on 4,096 of those rows within the parity regime of the CPU's
   (leaves rtol 1e-5 / atol 1e-6, predictions rtol 1e-5), the refit model
   served through B4, its seconds; (e) multiclass at Covertype's shape, 3 +
   3 rounds equal to 6 bit for bit (B6 roots, B5 waves); (f) diamonds'
   Dataset through ``save_binary`` and ``Dataset(path)``: the fused strict
   ``cv()`` (B6, B3) and a strict ``train`` (B1 pairs, B3) equal to the
   original's, examples/advanced_features.py's linear call continued 10 +
   10 equal to 20 (strict, B3), and the north star's file bytes and its
   write and read seconds.
22. out-of-core training, every launch counter at 0 just before each run
   and read just after: (a) the north star streamed (``Dataset.from_blocks``
   over phase 6's rows in 131,072-row blocks with ``reference=`` phase 6's
   Dataset: 8 blocks, the tail padded), 6 bf16 rounds on the wave grower
   through the kernels, through the plain versions and in memory, in
   turns: AUC within 1e-4 of in memory and of plain, B1 launched once per
   block of every pass (the root and each wave, after the plain routing;
   no B2, no plain-version call), ``X_binned`` None and at most
   ``prefetch_blocks + 1`` block buffers on the device, the dyadic round-1
   tree equal to the in-memory one, the model served through
   ``PredictorRuntime`` (B4) within 1e-5 of ``Booster.predict``; bytes
   streamed, verify ms (crc32) and copy-wait ms (CUDA events) per round,
   a round's peak device bytes streamed and in memory, and a fresh sketch
   fit's host seconds at 10^6 rows; (b) the strict grower streamed (200,000
   rows in 65,536-row blocks, 31 leaves, ``grow_policy="leafwise"``, 3
   rounds): B3 90 times, B1 two-segment per block of every split iteration,
   the trees within the parity regime of the in-memory strict grower's (a
   near tie recorded), ms a split iteration; (c) GOSS at the source on (a)'s
   store (``top_rate`` 0.2, ``other_rate`` 0.1, 5 rounds: the in-memory
   grower on the gathered rows, B1 and B2 at f32): each round's host
   selection equal to a recomputation from the same gradients, gathered
   bytes over a full pass, AUC beside in-memory GOSS's; (d) on (b)'s
   streamed Dataset with bagging and feature fraction: ``train_resumable``
   killed by SIGTERM after round index 2 of 6 and resumed, bit for bit as
   the uninterrupted run (trees, train scores, bag), the same with
   ``feature_screen="ema"`` (the screener's state carried), ``init_model=``
   5 + 5 rounds (a Booster and a model file) equal to 10, and a Dataset
   binned by another sketch refused by ``resume_booster`` (its schema
   digest) and by ``Booster(model_file).update``; (e) EMA screening at the
   reference bench's width (136 columns, 16 informative, keep 0.25,
   refresh 10; 100,000 rows, 12 rounds) in memory and streamed: AUC drift
   against screen-off within 1e-4, ``screen_refresh_rounds=1`` bit for bit
   as screen-off, every screened pass moving ``F_active`` columns and every
   refresh pass ``F``;
23. multi-device training over ``parallel.set_virtual_devices(4)`` shards
   of the one card (virtual shards measure the code path, not several
   cards), every launch counter at 0 just before each run and read just
   after: (a) ``tree_learner="data"`` at the north star (the default
   ``reduce_scatter_pipelined`` merge, 4 chunks, f32 wire, bf16
   histograms, 6 rounds) in turns with serial and with the plain
   versions: B1 4 times a root and B2 4 times a wave, AUC within 1e-4 of
   both, split structure equal to serial's (a near tie allowed) and the
   leaves within rtol 1e-5 / atol 1e-6, the dyadic round-1 tree equal to
   serial's, host syncs a round no more than serial's, the merges, scans
   and the pieces' exchanges under sync debug mode "error", the merge's
   CUDA-event ms a round, a round's peak bytes, the model served by B4
   within 1e-5; (b) every merge at f32 wire grows serial's dyadic round-1
   tree bit for bit at D = 4 and D = 8; bf16 and int8 wire within AUC 1e-4
   of f32 wire on the reference's gate task (tools/bench_multichip.py's
   "margin" data), their drift at the north star recorded (ungated in the
   reference too); voting at ``top_k`` 20 (the exact union at F = 28)
   and 5 trains a valid tree, its AUC beside serial's; (c)
   ``tree_learner="feature"`` (7 columns a shard) and ``mesh_shape="2x2"``:
   B1 without B2 or B3, the dyadic round-1 tree equal to serial's; (d) on
   200,000 north-star rows or their own shape, 3 rounds each against
   serial: the strict grower under ``histogram_merge="psum"`` (B1 pairs
   per shard, B3), multiclass at Covertype's shape (B5/B6 per shard),
   GOSS sampled per shard (AUC within 5e-3 of serial GOSS), lambdarank at
   18a's shape, the airline table's categorical columns (voting warns and
   takes ``reduce_scatter``), linear leaves and int8 histograms; (e) a
   D = 4 ``train_resumable`` killed by SIGTERM after round index 6 and
   resumed bit for bit, resumed at D = 2 and D = 8 with the checkpoint's
   trees kept, and a checkpoint naming D = 3 or another merge mode refused
   with ``IncompatibleCheckpointError`` naming the field.
24. the rest of multi-device over ``set_virtual_devices(4)`` shards of the
   card (the code path, not several cards), every launch counter at 0
   just before each run and read just after: (a) the serving mesh — phase
   3's north-star forest at f32, bf16 and int8 and phase 11's 7-class
   Covertype forest, every bucket of the ladder through ``dp``, ``tp``
   and ``auto``: dp equal to the single route bit for bit, tp within the
   a-priori f32 bound of regrouping the tree sum into 4 shard sums plus 2
   ulp of the largest served output (the reference's 2-ulp bound, which
   its 12-tree tests meet, is recorded: 100 trees can regroup past it),
   at ``num_iteration`` 1, 5 and all too, and within 1e-5 of ``Booster.predict`` (f32) or the dequantized
   oracle; B4 4 times a dp dispatch and 4·K times a tp dispatch; no
   ``build_node_tables`` after ``warm()``; every shard's tree slice
   through B4 bit for bit its plain version; rows/s of a 1,000,000-row
   dp ``predict_binned`` against single in turns; the MicroBatcher's
   p50/p99 over 4,096 requests on the tp route against single; ``task=
   serve mesh_devices=4`` in a subprocess under
   ``LIGHTGBM_TPU_TORCH_VIRTUAL_DEVICES=4``; (b) streamed data
   parallelism — phase 22a's store (8 blocks, 2 a shard) with
   ``tree_learner="data"``, 4 rounds in turns with serial streaming and
   the in-memory mesh: AUC within 1e-4 of both, B1 once per block of
   every pass (no B2), each shard streaming a quarter of serial's bytes,
   at most 4 · (``prefetch_blocks`` + 1) block buffers, the dyadic
   round-1 tree equal to serial streaming's, the merge's CUDA-event ms
   and a round's peak bytes; the strict grower streamed under ``psum``
   (B3, ms a split iteration); GOSS at the source with the int8 wire
   (gathered bytes a shard, B1/B2 per shard); ``train_resumable`` killed
   after round index 6 and resumed at D = 4 bit for bit, then at D = 2;
   (c) the multi-device sweep — phase 13c's 12-config ``.RData`` grid with
   4 devices in groups of 2 through ``SweepService`` and through ``task=
   sweep sweep_devices=4 sweep_group_size=2`` in a subprocess: both
   ledger files byte-equal to 13c's single-device ledger, the plan's two
   groups recorded per bucket.
25. the production loop, every launch counter at 0 just before each run
   and read just after: (a) the refresh daemon (``pipeline.RefreshDaemon``
   on the wall clock) over phase 6's rows arriving as 131,072-row blocks:
   generation 1 the first 5 blocks and 10 rounds, generations 2-4 a block
   each (the last the padded tail) and 5 rounds, phase 6's params, a
   checkpoint every 2 rounds; once with a fault at ``continue_train``
   (generation 2, preempted after its round-14 checkpoint and retried from
   it), ``artifact_push`` (generation 3, poisoned NaN leaves rejected at
   ingest while generation 2 serves) and ``flip`` (generation 4, rolled
   back, generation 3 serving and anchoring), once without: every
   artifact of the faulted run equal to the control run's bit for bit,
   generation 2 equal to ``train_resumable(init_model=<generation 1>)``
   by hand, every flip's served scores on 16,384 held-out rows within
   1e-5 of ``Booster(model_file=...).predict`` (B4), generation 1
   through the plain versions within AUC 1e-4; per generation the
   staleness, its legs (wait, train, publish, deploy, flip) and the
   train leg's CUDA-event ms; (b) a retune on the diamonds split
   (16,384-row blocks): 4 configs of ``paramGrid.json``'s learning_rate
   0.1 rows at the workflow's ``cv()`` arguments (5 folds, 1,000 rounds,
   early stopping 5; B6, B3), a ``sweep_promote`` fault, the retry
   launching no sweep kernel and promoting the ledger's best, the ledger
   equal to a ``SweepService`` run by hand, the winner served within 1e-5,
   B6 + B3 equal to their plain versions on exact sums; (c) ``python -m
   lightgbm_tpu_torch task=refresh`` in a subprocess over 2 north-star
   blocks (``g0001``), then again with a third (re-anchored, ``g0002``),
   the summaries and the served scores checked; (d) ``profile_training``
   at the north star (10 rounds, CUDA events, a trace under ``build/``):
   every key, the timed rounds equal to ``lgb.train``'s bit for bit, a
   histogram pass one B1 launch, a tree one B1 and one B2 a wave, both
   equal to their plain versions on the profile's exact statistics; (e)
   the ``*_card`` launch budgets in a fresh process, each between its
   floor and its ceiling.

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import collections
import io
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

SEED = 20261016
PRECISIONS = ("f32", "bf16", "int8")
NUM_TREES, NUM_LEAVES, NUM_FEATURES, MAX_BIN = 100, 127, 28, 255
LEARNING_RATE = 0.1
CAPACITY = 2 * NUM_LEAVES - 1
BIG_ROWS, SINGLE_REQUESTS, MAX_BUCKET = 1_000_000, 4096, 1 << 14
LARGE_LEAVES = 8191        # trees of 16,384 node slots (phase 2)
# H100 SXM published peaks (NVIDIA data sheet, dense): HBM bytes/s and
# the f32 rate outside the tensor cores, the closest listed rate for the
# kernel's integer compares and f32 multiply-adds
PEAK_BYTES_S, PEAK_OPS_S = 3.35e12, 67e12
# spin cycles that keep the card busy while the host enqueues timed calls
SPIN_CYCLES = 20_000_000
KERNEL_SOURCE = "lightgbm_tpu_torch/csrc/predict_forest.cu"
REPLACES = "lightgbm_tpu/ops/predict.py:257"
KERNELS = ("predict_forest", "hist_fused", "hist_partition", "split_iter",
           "hist_segstats", "hist_fused_batched", "hist_fused_int8")
HIST_SOURCES = {
    "hist_fused": ("lightgbm_tpu_torch/csrc/hist_fused.cu",
                   "lightgbm_tpu/ops/histogram_pallas.py:304"),
    "hist_partition": ("lightgbm_tpu_torch/csrc/hist_partition.cu",
                       "lightgbm_tpu/ops/histogram_pallas.py:830"),
}
SPLIT_ITER_SOURCE = ("lightgbm_tpu_torch/csrc/split_iter.cu",
                     "lightgbm_tpu/ops/histogram_pallas.py:605")
SEGSTATS_SOURCE = ("lightgbm_tpu_torch/csrc/hist_segstats.cu",
                   "lightgbm_tpu/ops/histogram_pallas.py:76")
BATCHED_SOURCE = ("lightgbm_tpu_torch/csrc/hist_fused_batched.cu",
                  "lightgbm_tpu/ops/histogram_pallas.py:955")
INT8_SOURCE = ("lightgbm_tpu_torch/csrc/hist_fused_int8.cu",
               "lightgbm_tpu/ops/histogram_pallas.py:304")
# phase 12e: the CLI's int8 training file, its test file, requests served
CLI_ROWS, CLI_TEST_ROWS, CLI_SERVE_ROWS = 200_000, 20_000, 256
# the grid-search workflow (examples/gridsearch_cv.py, r/gridsearchCV.R)
SWEEP_SEED = 3928272
CV_PARAMS = {"learning_rate": 0.1, "objective": "regression"}
CV_ROUNDS, CV_FOLDS, CV_ES = 1000, 5, 5
# 8b's plain cv() runs this many rounds (the kernel run's early stopping
# ends near 139) and is held to the kernel run's first rounds
CV_PLAIN_ROUNDS = 40
SEGSTATS_KC = (15, 30, 120, 240, 1080)
STRICT_ROUNDS = 3
STRICT_LATE_ROWS = 5_000      # phase 5/6: a late strict call's rows at most
HIST_MODES = ("f32", "bf16")
HIST_REL_TOL = 1e-6           # |kernel - f64| <= HIST_REL_TOL * sum |x|
TRAIN_PARAMS = {"objective": "binary", "num_leaves": NUM_LEAVES,
                "learning_rate": LEARNING_RATE, "min_data_in_leaf": 20,
                "max_bin": MAX_BIN, "verbosity": -1}
TRAIN_ROUNDS, VALID_ROWS, AUC_TOL = 10, 200_000, 1e-4
# phases 19a-c, 20a, 22a and 23a train the north star for this many rounds
# a run (10 until phase 25 needed the time; every check is relative)
LATE_ROUNDS = 6
# phase 6's limit: medians of this many kernel/plain run pairs, in turns
TIMING_PAIRS = 3
# phase 10: cv() at the north star in the wave regime (rounds cut from the
# reference bench's 100 so that the kernel and plain runs both fit)
NS_CV_ROUNDS, NS_CV_FOLDS, NS_CV_ES, NS_CV_TOL = 20, 5, 5, 1e-4
# phase 11: multiclass at the shape of UCI Covertype (581,012 x 54, 7
# classes: 10 quantitative columns, 4 wilderness and 40 soil indicators)
COV_ROWS, COV_NUMERIC, COV_WILD, COV_SOIL, COV_CLASSES = (581_012, 10, 4,
                                                          40, 7)
COV_VALID_ROWS, COV_ROUNDS, COV_TOL = 100_000, 10, 1e-4
COV_PARAMS = {"objective": "multiclass", "num_class": COV_CLASSES,
              "num_leaves": NUM_LEAVES, "learning_rate": LEARNING_RATE,
              "min_data_in_leaf": 20, "max_bin": MAX_BIN, "verbosity": -1}
# phase 13: recovery (the bag and both masks are part of the resumed state)
RECOVERY_PARAMS = dict(TRAIN_PARAMS, bagging_fraction=0.8, bagging_freq=1,
                       feature_fraction=0.8)
RECOVERY_ROUNDS, RECOVERY_EVERY, RECOVERY_KILL_AFTER = 12, 4, 6
RECOVERY_SERVE_ROWS = 16_384
# 13b's CLI runs 15 rounds (60 until phase 24 needed the time, 30 until
# 13c's and 24c's sweeps took back their early-stopped rounds; the kill lands after the first checkpoint, at round 5)
RECOVERY_CLI_ROUNDS, RECOVERY_CLI_EVERY = 15, 5
RECOVERY_SEGMENT_ROUNDS = 25     # the sweep's carry checkpoint cadence
# 13c's and 24c's sweeps run up to 1,000 rounds: early stopping ends every
# bucket (at 167-191 rounds on the card) after the fault at segment hit 3
# (round 75 at the latest), so the resumed run's stopping point depends on
# the restored early-stopping state (best score, patience count)
RECOVERY_SWEEP_ROUNDS = 1000
# phase 14: examples/bagging_boosting.py at its own sizes (the script's
# params; cv 5 folds, early stopping 50; train 500, cut to 300 when phase
# 24 needed the time and to a largest stage of 100 when 13c's and 24c's
# sweeps took back their early-stopped rounds; the staged fits and
# forest sizes it prints).  Its cv's 1,000 rounds are cut to 60 on both
# paths (early stopping ends them at 323; 100 until phase 22 needed the
# time): the plain versions are launch-bound at 1,000 rows and the script
# must fit its time limit on a slow host
BB_ROWS, BB_SEED = 1000, 8657
BB_PARAMS = {"objective": "reg:linear", "eval_metric": "rmse", "eta": 0.02,
             "max_depth": 6, "max_leaf_nodes": 31, "verbosity": 0,
             "min_data_in_leaf": 1}
# (60 until phase 23 needed the time)
BB_CV_ROUNDS, BB_CV_ES, BB_FOLDS, BB_TRAIN_ROUNDS = 40, 50, 5, 100
BB_STAGES, BB_FORESTS = (1, 20, 50, 100), (1, 3, 100)
# the plain versions run ~5 ms a call at 1,000 rows (launch-bound): the
# plain train covers the stages up to 20 trees (100 until phase 22, 50
# until phase 23)
BB_PLAIN_ROUNDS = 20
# EXAMPLES_r05.json (the JAX package on a TPU): staged RMSEs, printed as a
# quality reference beside the port's, never as a time
BB_TPU_STAGED_RMSE = {1: 0.5196, 20: 0.3567, 50: 0.1977, 100: 0.075,
                      300: 0.0166}
# the rf north star: sklearn's "sqrt" of 28 columns per split
RF_PARAMS = dict(TRAIN_PARAMS, boosting="rf", bagging_fraction=0.632,
                 bagging_freq=1, feature_fraction_bynode=5 / 28)
RF_TREES, RF_SERVE_ROWS, SYNC_ROUNDS = 6, 16_384, 3   # 14b: 10 until phase 25
BYNODE_CV_PARAMS = dict(CV_PARAMS, feature_fraction_bynode=0.5)
# 14c's rounds, cut from phase 8b's 1,000 (early stopping found 301): the
# unfused body's split scan runs in plain ops, 5-9 ms a split iteration
# (50 until phase 20 needed the time, 30 until phase 23 did)
BYNODE_CV_ROUNDS = 15
BATCH_CV_ROWS, BATCH_CV_LEAVES, BATCH_CV_ROUNDS = 1 << 19, 63, 3
# phase 15: the remaining objectives; 15a's renewal at the north star, 6
# rounds on each path in turns (10 until 13c's and 24c's sweeps took back their early-stopped rounds)
RENEW_ROUNDS, RENEW_ALPHA = 6, 0.9
# 15b: examples/gridsearch_cv.py's untuned call on diamonds prices; each
# objective's default metric ("fair" names one neither package has: l1)
FAMILY_OBJECTIVES = ("huber", "fair", "poisson", "gamma", "tweedie", "mape",
                     "cross_entropy", "custom")
FAMILY_METRIC = {"fair": "l1", "custom": "l2"}
# the example's rounds cut to 12 on both paths (the plain versions are
# launch-bound at 45,957 rows; 100 until phase 20 needed the time, 60
# until phase 23 did, 30 until phase 24 did, 20 until 13c's and 24c's sweeps took back their early-stopped rounds)
FAMILY_ROUNDS, FAMILY_SERVE_ROWS = 8, 16_384   # 15b/c: 12 until phase 25
# phase 16: GOSS and DART at LightGBM's defaults (top_rate 0.2, other_rate
# 0.1; drop_rate 0.1, max_drop 50, skip_drop 0.5)
GOSS_PARAMS = dict(TRAIN_PARAMS, boosting="goss", top_rate=0.2,
                   other_rate=0.1)
# 16a's rounds on each path in turns: 6 (10 until phase 24 needed the time)
GOSS_ROUNDS, GOSS_SERVE_ROWS, MC_GOSS_ROUNDS = 4, 16_384, 3   # 16a: 6 until phase 25
DART_PARAMS = dict(TRAIN_PARAMS, boosting="dart", drop_rate=0.1,
                   max_drop=50, skip_drop=0.5)
# 12 rounds (30 until phase 24 needed the time, 20 until 13c's and 24c's sweeps took back their early-stopped rounds)
DART_ROUNDS = 12
# 16d: the example's cv() rounds (kernels, plain), cut so the script fits
# its time limit on a slow host: GOSS's both at 6 (early stopping ends
# them at 177); DART's early stopping rarely ends it (each drop round
# moves the ensemble), so both of its runs stop at 8 (10 and 12 until
# phase 24 needed the time, 15 and 20 until phase 23, 25 and 30 until
# phase 22, 40 and 50 before phase 20)
GD_CV_ROUNDS = {"goss": 6, "dart": 8}
# 16e: the curve's params with DART dropping half the trees every round
DART_CURVE_PARAMS = dict(BB_PARAMS, boosting="dart", drop_rate=0.5,
                         skip_drop=0.0)
# phase 17: categorical features.  17a at the shape of szilard/GBM-perf's
# airline-delay table (8 columns; Origin and Dest past the 254 categories a
# column keeps at 255 bins, so their rarest share the overflow bin)
AIR_COLUMNS = ("Month", "DayofMonth", "DayOfWeek", "DepTime",
               "UniqueCarrier", "Origin", "Dest", "Distance")
AIR_CATS = {"Month": 12, "DayofMonth": 31, "DayOfWeek": 7,
            "UniqueCarrier": 22, "Origin": 300, "Dest": 300}
# 17a's rounds on each path in turns: 4 (10 until phase 24 needed the time,
# 6 until 13c's and 24c's sweeps took back their early-stopped rounds);
# 17b, 17d and 17e: 2 (3 until 13c's and 24c's sweeps took back their
# early-stopped rounds)
AIR_ROWS, CAT_ROUNDS, CAT_SHORT_ROUNDS, CAT_SERVE_ROWS = (1_000_000, 4, 2,
                                                          16_384)
# 17c: examples/gridsearch_cv.py's cv() with the diamonds factors; both
# runs are cut at the same round (early stopping ends the kernel run at
# 139), so the script fits its time limit on a slow host (as 16d; 30
# until phase 23 and 15 until 13c's and 24c's sweeps took back their
# early-stopped 1,000 rounds needed the time)
DIAMOND_CATS = ["cut", "color", "clarity"]
CAT_CV_ROUNDS = 8
# phase 18: ranking; 18a is the reference bench's MSLR configuration
# (bench.py bench_mslr): 1,000 training and 200 held-out queries of 100
# documents, 136 features, truncation at the query depth
MSLR_QUERIES, MSLR_VALID_QUERIES, MSLR_DOCS, MSLR_FEATURES = 1000, 200, 100, \
    136
# 18a's rounds on both paths in turns: 10 (50 until phase 23 needed the
# time, 25 until phase 24 did, 15 until 13c's and 24c's sweeps took back
# their early-stopped rounds)
MSLR_ROUNDS, MSLR_SEED, NDCG_K, RANK_TOL = 6, 5, 10, 1e-4   # 18a: 10 until phase 25
MSLR_PARAMS = {"objective": "lambdarank", "num_leaves": 63,
               "learning_rate": 0.1, "min_data_in_leaf": 20,
               "hist_dtype": "bf16", "lambdarank_truncation_level": MSLR_DOCS,
               "max_bin": MAX_BIN, "eval_at": [NDCG_K], "verbosity": -1}
# 18b: ragged queries at MSLR-WEB30K's mean depth (3,771,125 documents over
# 31,531 queries: about 120 a query); 1,500 of them, about 180,000 rows
# (10,000 until phase 23 needed the time, 5,000 until phase 24 did, 2,500
# and 10 rounds until phase 25 did: host binning is most of 18b)
RAGGED_QUERIES, RAGGED_DOCS, RAGGED_ROUNDS, RAGGED_DEPTH = 1_500, (20, 221), \
    6, 120
# 18c: the reference test's make_ranked shape in a group-aware cv()
RANK_CV_QUERIES, RANK_CV_FOLDS, RANK_CV_ES, RANK_CV_ROUNDS, RANK_CV_SEED = \
    40, 3, 5, 30, 7
RANK_CV_PARAMS = {"objective": "lambdarank", "num_leaves": 7,
                  "min_data_in_leaf": 5, "learning_rate": 0.3,
                  "eval_at": [5], "verbosity": -1}
RANKER_ROUNDS = 20
# phase 19: constraints at the north star; the monotone columns are three of
# make_higgs_like's purely linear ones (its weights 2.41, 1.43 and -1.42)
MONO_NS = [0] * NUM_FEATURES
MONO_NS[6], MONO_NS[14], MONO_NS[17] = 1, 1, -1
IC_GROUPS = [list(range(g, g + 7)) for g in range(0, NUM_FEATURES, 7)]
MONO_SWEEP_ROWS, MONO_SERVE_ROWS, MONO_MC_ROUNDS = 1000, 16_384, 3
ADV_ROUNDS = 60            # examples/advanced_features.py's num_boost_round
# 19d's strict-grower runs are cut to 6 rounds on both paths (the unfused
# body takes ~8 ms a split iteration on the card; 20 until phase 23
# needed the time, 10 until phase 24 did)
ADV_STRICT_ROUNDS = 6
# phase 20: examples/advanced_features.py's linear call and TreeSHAP rows,
# and the north star's TreeSHAP and pred_leaf rows
LINEAR_EXAMPLE_ROUNDS, SHAP_EXAMPLE_ROWS = 25, 500
SHAP_NORTH_STAR_ROWS, LEAF_ROWS = 4096, 16_384
# phase 21: continuation.  21a: phase 13's config, 5 + 5 rounds against 10;
# 21b: the 127-leaf model continued at 31 leaves and half the rate (the
# ratio 2 is exact in f32), DART dropping half the trees of every round
CONT_ROUNDS, MIXED_ROUNDS = 5, 3
MIXED_PARAMS = dict(RECOVERY_PARAMS, num_leaves=31, learning_rate=0.05)
MIXED_DART_PARAMS = dict(MIXED_PARAMS, boosting="dart", drop_rate=0.5,
                         skip_drop=0.0, max_drop=50)
ROLLBACK_STEPS, REFIT_CPU_ROWS, COV_CONT_ROUNDS = 2, 4096, 3
LINEAR_CONT_ROUNDS, STRICT_BINARY_ROUNDS, CV_BINARY_ROUNDS = 10, 10, 10


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------
def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60)
    check(clock.returncode == 0, f"nvidia-smi failed: {clock.stderr}")
    clock_mhz = float(clock.stdout.strip().splitlines()[0])
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}, device {torch.cuda.get_device_name(0)}")
    from lightgbm_tpu_torch.kernels import build

    t0 = time.perf_counter()
    secs = build.build(KERNELS)
    log(f"kernel build: {json.dumps(secs)} "
        f"(wall {time.perf_counter() - t0:.2f} s)")
    for name, text in build.BUILD_LOG.items():
        log(f"--- nvcc {name} ---\n{text.strip()}")
    return card, secs, clock_mhz


# ---------------------------------------------------------------------------
# phase 2: kernel vs plain version on the card
# ---------------------------------------------------------------------------
def compare(soa, bins, lr, init, num_it, depth, start, what):
    """The kernel against its plain version, bit for bit."""
    from lightgbm_tpu_torch.ops.predict import (predict_forest,
                                                predict_forest_plain)

    got = predict_forest(soa, bins, lr, init, num_it, depth, start)
    want = predict_forest_plain(soa, bins, lr, init, num_it, depth, start)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
    err = float((got - want).abs().max()) if got.numel() else 0.0
    check(torch.equal(got, want), f"{what}: not bit-equal (max err {err})")
    return err


def serve_large_trees(dev):
    """Three 8,191-leaf f32 trees deployed in a ``PredictorRuntime`` on the
    card and served, raw scores bit for bit equal to the same runtime on
    the CPU (the plain version).  Returns the node slots of a tree."""
    from lightgbm_tpu_torch.dataset import BinMapper
    from lightgbm_tpu_torch.kernels._timing import make_forest
    from lightgbm_tpu_torch.serving import (PredictorRuntime,
                                            packed_from_arrays)
    from lightgbm_tpu_torch.utils.datasets import make_higgs_like

    X, _ = make_higgs_like(20_000, NUM_FEATURES, seed=5)
    mapper = BinMapper.fit(X, max_bin=MAX_BIN)
    arrays = make_forest(SEED + 30, 3, LARGE_LEAVES, mapper.n_bins)
    meta = {"shrink": LEARNING_RATE, "init_score": [0.25], "num_class": 1,
            "best_iteration": -1,
            "params": {"objective": "binary", "num_leaves": LARGE_LEAVES},
            "bin_mapper": mapper.to_dict()}
    packed = packed_from_arrays(arrays, meta)
    card = PredictorRuntime(packed, max_bucket=MAX_BUCKET, device=dev)
    card.warm()
    host = PredictorRuntime(packed, max_bucket=MAX_BUCKET, device="cpu")
    codes = mapper.transform(X)
    got = card.predict_binned(codes, raw_score=True)
    want = host.predict_binned(codes, raw_score=True)
    check(np.array_equal(got, want), "the 8,191-leaf forest served on the "
          "card differs from the plain version")
    check(card.stats.snapshot()["fallbacks"] == 0, "8,191-leaf fallbacks")
    return int(card._soa[0].split_feature.shape[1])


def phase_kernel_vs_plain(dev):
    from lightgbm_tpu_torch.kernels._timing import (depth_cap_of,
                                                    make_forest, soa_for)

    rng = np.random.default_rng(SEED)
    col_bins = np.full(NUM_FEATURES, MAX_BIN)
    errs = {p: 0.0 for p in PRECISIONS}
    full = make_forest(SEED + 1, NUM_TREES, NUM_LEAVES, col_bins)
    odd = make_forest(SEED + 2, 37, 31, col_bins)          # T % chunk != 0
    k = np.random.default_rng(SEED + 3)
    # dyadic leaves k/128 with |k| <= 127, one |k| = 127 leaf per tree, so
    # the int8 scale is exactly 1/128: every sum is exact in f32
    dyadic = make_forest(SEED + 3, 64, NUM_LEAVES, col_bins,
                         leaf_fn=lambda: np.float32(
                             k.integers(-127, 128) / 128.0))
    isl = dyadic["is_leaf"]
    first = np.argmax(isl, axis=1)
    dyadic["leaf_value"][np.arange(isl.shape[0]), first] = 127.0 / 128.0
    # rows wider than the kernel stages in shared memory (256 columns at
    # the largest tile)
    wide = {f: make_forest(SEED + f, 24, 31, np.full(f, MAX_BIN))
            for f in (256, 257, 2000)}
    # trees past one block's shared memory, and a forest of many rounds
    large = make_forest(SEED + 4, 3, LARGE_LEAVES, col_bins)
    many = make_forest(SEED + 5, 1000, NUM_LEAVES, col_bins)
    cases = [("full", full, NUM_FEATURES, [2048, 3001, 127, 1]),
             ("odd-trees", odd, NUM_FEATURES, [3001, 129]),
             ("dyadic", dyadic, NUM_FEATURES, [4096, 3001]),
             (f"leaves-{LARGE_LEAVES}", large, NUM_FEATURES, [2048, 1]),
             ("trees-1000", many, NUM_FEATURES, [2048, 1])] + [
                 (f"wide-{f}", arrays, f, [300])
                 for f, arrays in wide.items()]
    for prec in PRECISIONS:
        for name, arrays, f, ns in cases:
            soa = soa_for(arrays, prec, dev)
            depth = depth_cap_of(arrays)
            t = arrays["leaf_value"].shape[0]
            for n in ns:
                bins = torch.from_numpy(rng.integers(
                    0, MAX_BIN, (n, f)).astype(np.uint8)).to(dev)
                windows = [(t, 0), (t // 3, 0), (t // 2, t // 4), (1, t - 1),
                           (t + 50, 0), (5, t + 3)]
                for num_it, start in windows:
                    what = f"{prec} {name} n={n} window=({num_it},{start})"
                    e = compare(soa, bins, LEARNING_RATE, 0.25, num_it, depth,
                                start, what)
                    errs[prec] = max(errs[prec], e)
            # a depth cap below the forest's depth cuts every walk alike
            bins = torch.from_numpy(rng.integers(
                0, MAX_BIN, (513, f)).astype(np.uint8)).to(dev)
            errs[prec] = max(errs[prec], compare(
                soa, bins, LEARNING_RATE, 0.0, t, max(depth // 2, 1), 0,
                f"{prec} {name} short depth cap"))
        log(f"phase 2 {prec}: kernel == plain version bit for bit over "
            f"{len(cases)} forests")
    slots = serve_large_trees(dev)
    log(f"phase 2 serve: three {LARGE_LEAVES}-leaf trees ({slots} node "
        f"slots each) served by PredictorRuntime on the card, raw scores "
        f"== the plain version's")
    return errs


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------
def build_model(workdir):
    from lightgbm_tpu_torch.dataset import BinMapper
    from lightgbm_tpu_torch.kernels._timing import make_forest
    from lightgbm_tpu_torch.serving import packed_from_arrays
    from lightgbm_tpu_torch.utils.datasets import make_higgs_like

    t0 = time.perf_counter()
    X, y = make_higgs_like(BIG_ROWS, NUM_FEATURES, seed=0)
    mapper = BinMapper.fit(X, max_bin=MAX_BIN)
    arrays = make_forest(SEED + 10, NUM_TREES, NUM_LEAVES, mapper.n_bins)
    pbar = float(np.mean(y))
    meta = {"shrink": LEARNING_RATE,
            "init_score": [float(np.log(pbar / (1.0 - pbar)))],
            "num_class": 1, "best_iteration": -1,
            "params": {"objective": "binary", "num_leaves": NUM_LEAVES,
                       "learning_rate": LEARNING_RATE, "max_bin": MAX_BIN,
                       "num_iterations": NUM_TREES},
            "bin_mapper": mapper.to_dict()}
    packed = packed_from_arrays(arrays, meta)
    path = os.path.join(workdir, "higgs_forest.npz")
    packed.save(path)
    # a second artifact for !swap: same shape, other leaf values
    arrays2 = dict(arrays, leaf_value=arrays["leaf_value"] * 0.5)
    path2 = os.path.join(workdir, "higgs_forest_v2.npz")
    packed_from_arrays(arrays2, meta).save(path2)
    log(f"model: {NUM_TREES} trees x {NUM_LEAVES} leaves (capacity "
        f"{CAPACITY}), {NUM_FEATURES} features, {MAX_BIN} bins, depth cap "
        f"{packed.depth_cap}; data {BIG_ROWS} rows "
        f"({time.perf_counter() - t0:.1f} s to make and bin)")
    return X, y, mapper, path, path2


def serve_cli(path, path2, precision, rows):
    from lightgbm_tpu_torch.__main__ import _serve

    lines = [",".join(f"{v:.6f}" for v in r) for r in rows[:3]]
    text = "\n".join(lines + [f"!swap {path2}"] + lines + ["!rollback"]
                     + lines + ["!stats"]) + "\n"
    out, err = io.StringIO(), io.StringIO()
    rc = _serve(path, {"forest_precision": precision, "max_batch": "1",
                       "canary_rows": "8"},
                stdin=io.StringIO(text), stdout=out, stderr=err)
    check(rc == 0, f"_serve exit {rc}")
    preds = [float(v) for v in out.getvalue().split()]
    log_text = err.getvalue()
    check(len(preds) == 9 and all(np.isfinite(preds)),
          f"_serve answered {out.getvalue()!r}")
    check("swapped default -> v2" in log_text, f"no swap ack: {log_text!r}")
    check("rolled back default -> v1" in log_text,
          f"no rollback ack: {log_text!r}")
    check(np.allclose(preds[:3], preds[6:], rtol=0, atol=0),
          "rollback did not restore the first version's answers")
    check(not np.allclose(preds[:3], preds[3:6]),
          "swap did not change the answers")


def phase_main_path(precision, X, path, path2):
    from lightgbm_tpu_torch.kernels.predict import PREDICT_FOREST_LAUNCHES
    from lightgbm_tpu_torch.serving import ModelBank

    PREDICT_FOREST_LAUNCHES.reset()
    t0 = time.perf_counter()
    bank = ModelBank(max_bucket=MAX_BUCKET, warm_on_deploy=True,
                     canary_rows=64, forest_precision=precision)
    rep = bank.deploy("higgs", path)
    check(rep["ok"], f"deploy failed: {rep}")
    t_deploy = time.perf_counter() - t0
    rt = bank.runtime("higgs")
    check(str(rt.device).startswith("cuda"), f"runtime on {rt.device}")

    batcher = bank.batcher("higgs", max_batch=128, max_delay_ms=2.0)
    single = X[:SINGLE_REQUESTS]
    t0 = time.perf_counter()
    pend = []
    for row in single:
        pend.append(batcher.submit(row))
        batcher.pump()
    batcher.flush()
    t_single = time.perf_counter() - t0
    single_out = np.array([p.result() for p in pend], np.float32)

    t0 = time.perf_counter()
    rt.packed.bin_mapper.transform(X)
    t_bin = time.perf_counter() - t0
    t0 = time.perf_counter()
    big_out = rt.predict(X)
    t_big = time.perf_counter() - t0
    launches = PREDICT_FOREST_LAUNCHES.count

    stats = rt.stats.snapshot()
    check(stats["fallbacks"] == 0, f"fallbacks {stats['fallbacks']}")
    check(stats["fused_path"]["legacy_dispatches"] == 0,
          f"legacy dispatches {stats['fused_path']['legacy_dispatches']}")
    want_launches = (stats["predict_kernel_launches"]
                     + rt.warmed_buckets * rt.kernel_launches_per_dispatch)
    check(launches == want_launches and launches > 0,
          f"kernel launches {launches}, expected {want_launches}")
    check(big_out.shape == (BIG_ROWS,) and np.isfinite(big_out).all(),
          "1M-row predict: wrong shape or non-finite")
    check(bool(((big_out > 0) & (big_out < 1)).all()),
          "binary predictions outside (0, 1)")

    rng = np.random.default_rng(SEED + 20)
    sample = rng.choice(BIG_ROWS, 2000, replace=False)
    codes = rt.packed.bin_mapper.transform(X[sample])
    want = rt.oracle.predict_numpy(codes, raw_score=False)
    err_big = float(np.abs(big_out[sample] - want).max())
    want_single = rt.oracle.predict_numpy(
        rt.packed.bin_mapper.transform(single), raw_score=False)
    err_single = float(np.abs(single_out - want_single).max())
    exact = rt.packed.predict_numpy(codes, raw_score=False)
    err_exact = float(np.abs(big_out[sample] - exact).max())
    check(err_big <= 1e-5 and err_single <= 1e-5,
          f"device vs numpy oracle: {err_big:.3e} / {err_single:.3e}")
    check(err_exact <= 1e-5 + rt.quant_error_bound,
          f"device vs exact f32 forest {err_exact:.3e} beyond the "
          f"quantization bound {rt.quant_error_bound:.3e}")

    PREDICT_FOREST_LAUNCHES.reset()
    serve_cli(path, path2, precision, X[SINGLE_REQUESTS:])
    cli_launches = PREDICT_FOREST_LAUNCHES.count
    check(cli_launches > 0, "the CLI phase launched no kernel")
    result = {
        "precision": precision, "launches": launches + cli_launches,
        "deploy_s": t_deploy, "warmed_programs": rep["warmed"],
        "single_requests": SINGLE_REQUESTS, "single_s": t_single,
        "batched_dispatches": stats["batched_dispatches"],
        "queue_latency_p50_ms": stats["queue_latency_p50_ms"],
        "queue_latency_p99_ms": stats["queue_latency_p99_ms"],
        "big_rows": BIG_ROWS, "big_s": t_big, "big_binning_s": t_bin,
        "big_rows_per_s": BIG_ROWS / t_big,
        "max_abs_err_vs_oracle": max(err_big, err_single),
        "max_abs_err_vs_exact": err_exact,
        "quant_error_bound": rt.quant_error_bound,
        "fallbacks": stats["fallbacks"],
        "legacy_dispatches": stats["fused_path"]["legacy_dispatches"],
        "cli_launches": cli_launches,
    }
    log(f"phase 3 {precision}: {json.dumps(result)}")
    return result, rt


# ---------------------------------------------------------------------------
# phase 4: times
# ---------------------------------------------------------------------------
def time_ms(fn, runs=5, inner=10):
    """Device ms per call: median over ``runs`` of CUDA events around
    ``inner`` back-to-back calls.  A spin kernel enqueued first keeps the
    card busy while the host enqueues the calls, so the events time the
    calls' device work and not the host's launch overhead."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(runs):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        s.record()
        for _ in range(inner):
            fn()
        e.record()
        e.synchronize()
        per.append(s.elapsed_time(e) / inner)
    return float(np.median(per))


def host_ms(fn, runs=200):
    """Host wall ms per call, synchronised once at the end (the rate the
    host can issue calls, device work overlapped)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(runs):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / runs * 1e3


def bound_ms(soa, bins, depth_cap, t, clock_mhz):
    """Least time for the work: bytes (the bins once, the output once, and
    each node record the rows' paths read (8 bytes) and each cut walk's
    leaf value (4) once) over HBM peak, and operations (per internal node
    on a row's path: one compare and one select; per row and tree: one
    multiply and one add) over the f32 non-tensor peak.  Also the walk
    bound: the node visits' dependent loads (a record and a code each),
    one warp-wide load per clock on each SM at the card's
    ``clocks.max.sm``.  Returns (ms, bound_by, node_visits, walk_ms)."""
    from lightgbm_tpu_torch.kernels._timing import (byte_bound_ms,
                                                    walk_bound_ms,
                                                    walk_counts)

    n, f = bins.shape
    visits, records, cut = walk_counts(soa, bins, depth_cap, t)
    ops = 2 * visits + 2 * n * t
    b_ms = byte_bound_ms(n, f, records, cut)
    o_ms = ops / PEAK_OPS_S * 1e3
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return (max(b_ms, o_ms), "bytes" if b_ms >= o_ms else "operations",
            visits, walk_bound_ms(visits, sms, clock_mhz))


def phase_times(runtimes, X, clock_mhz):
    from lightgbm_tpu_torch.kernels.predict import forest_sums
    from lightgbm_tpu_torch.ops.predict import forest_sums_plain

    table, breakdown = [], []
    head, path_errs = {}, {}
    for prec, rt in runtimes.items():
        soa = rt._soa[0]
        depth = rt.packed.depth_cap
        t = rt.packed.num_trees
        codes = rt.packed.bin_mapper.transform(X[:MAX_BUCKET])
        all_bins = torch.from_numpy(codes).to(rt.device)
        # the kernel against its plain version on the main path's own
        # tables and rows, at every bucket of the ladder
        path_errs[prec] = 0.0
        for b in rt.buckets:
            for num_it in (t, t // 2):
                path_errs[prec] = max(path_errs[prec], compare(
                    soa, all_bins[:b].contiguous(), float(rt.packed.shrink),
                    float(rt.packed.init_score[0]), num_it, depth, 0,
                    f"{prec} main-path tables, bucket {b}, {num_it} trees"))
        log(f"phase 4 {prec}: kernel == plain version bit for bit on the "
            f"main path's tables at every bucket 1 .. {MAX_BUCKET}")
        for b in rt.buckets:
            bins = all_bins[:b].contiguous()
            k_ms = time_ms(lambda: forest_sums(soa, bins, 0, t, depth))
            k_host = host_ms(lambda: forest_sums(soa, bins, 0, t, depth))
            p_ms = time_ms(lambda: forest_sums_plain(soa, bins, t, depth),
                           runs=11, inner=1)
            b_ms, by, visits, w_ms = bound_ms(soa, bins, depth, t,
                                              clock_mhz)
            row = {"precision": prec, "bucket": b, "kernel_ms": k_ms,
                   "kernel_host_ms": k_host, "plain_ms": p_ms,
                   "bound_ms": b_ms, "bound_by": by, "walk_bound_ms": w_ms,
                   "node_visits": visits, "rows_per_s": b / k_ms * 1e3}
            table.append(row)
            if b == MAX_BUCKET:
                head[prec] = row
        # where a launch's time goes: no trees (launch and bin staging),
        # every tree with one step (table staging), every tree in full
        for b in (1, MAX_BUCKET):
            bins = all_bins[:b].contiguous()
            parts = {"bucket": b, "precision": prec,
                     "no_trees_ms": time_ms(
                         lambda: forest_sums(soa, bins, 0, 0, depth)),
                     "one_step_ms": time_ms(
                         lambda: forest_sums(soa, bins, 0, t, 1)),
                     "full_ms": time_ms(
                         lambda: forest_sums(soa, bins, 0, t, depth))}
            breakdown.append(parts)
            log(f"phase 4 {prec} breakdown: {json.dumps(parts)}")
        log(f"phase 4 {prec}: " + ", ".join(
            f"{r['bucket']}:{r['kernel_ms']:.4f}/{r['kernel_host_ms']:.4f}/"
            f"{r['plain_ms']:.3f}ms"
            for r in table if r["precision"] == prec))
    return table, breakdown, head, path_errs


# ---------------------------------------------------------------------------
# phase 5: the histogram kernels against float64 and their plain versions
# ---------------------------------------------------------------------------
def hist_counters():
    from lightgbm_tpu_torch.kernels.histogram import (HIST_FUSED_LAUNCHES,
                                                      HIST_PARTITION_LAUNCHES)

    return {"hist_fused": HIST_FUSED_LAUNCHES,
            "hist_partition": HIST_PARTITION_LAUNCHES}


def reset_counters():
    from lightgbm_tpu_torch.kernels.predict import PREDICT_FOREST_LAUNCHES

    PREDICT_FOREST_LAUNCHES.reset()
    for per_mode in hist_counters().values():
        for c in per_mode.values():
            c.reset()


def read_counters():
    from lightgbm_tpu_torch.kernels.predict import PREDICT_FOREST_LAUNCHES

    out = {"predict_forest": PREDICT_FOREST_LAUNCHES.count}
    for name, per_mode in hist_counters().items():
        for mode, c in per_mode.items():
            out[f"{name}_{mode}"] = c.count
    return out


def f64_hists(bins, stats, seg, k, num_bins, mode):
    """Float64 sums on the card of the mode-rounded stats and of their
    absolute values: ``[K, F, B, S]`` each."""
    st = stats.to(torch.bfloat16).to(torch.float32) if mode == "bf16" \
        else stats
    st = st.to(torch.float64)
    n, f = bins.shape
    s = st.shape[1]
    seg = seg.to(torch.int64)
    rows = torch.nonzero((seg >= 0) & (seg < k)).squeeze(1)
    ref = torch.zeros((k * f * num_bins, s), dtype=torch.float64,
                      device=bins.device)
    mag = torch.zeros_like(ref)
    base = seg[rows] * (f * num_bins)
    codes = bins[rows].to(torch.int64)
    for j in range(f):
        idx = base + j * num_bins + codes[:, j]
        ref.index_add_(0, idx, st[rows])
        mag.index_add_(0, idx, st[rows].abs())
    shape = (k, f, num_bins, s)
    return ref.view(shape), mag.view(shape)


def check_cells(out, ref, mag, what, exact=False):
    """Per-cell bound ``|out - ref| <= HIST_REL_TOL * sum |x|``; the count
    channel (the third statistic) exact; everything exact when asked."""
    check(bool(torch.isfinite(out).all()), f"{what}: non-finite cells")
    err = (out.to(torch.float64) - ref).abs()
    if exact:
        check(bool((err == 0).all()), f"{what}: not exact (max err "
              f"{float(err.max()):.3e})")
    else:
        check(bool((err <= HIST_REL_TOL * mag).all()),
              f"{what}: a cell is off by more than {HIST_REL_TOL} x sum|x| "
              f"(max ratio {float((err / mag.clamp(min=1e-300)).max()):.3e})")
    if out.shape[-1] == 3:
        check(torch.equal(out[..., 2].to(torch.float64), ref[..., 2]),
              f"{what}: counts not exact")
    return float(err.max()) if err.numel() else 0.0


def stats_for(rng, n, dev, dyadic=False, s=3):
    """(grad, hess, in-bag count) rows: N(0,1), U(0, 0.25), {0, 1}; or the
    dyadic tier's +-0.5, 0.25, 1, whose every partial sum is exact."""
    if dyadic:
        g = np.where(rng.random(n) < 0.5, -0.5, 0.5)
        cols = [g, np.full(n, 0.25), np.ones(n)]
    else:
        cols = [rng.normal(size=n), rng.uniform(0, 0.25, n),
                (rng.random(n) < 0.8).astype(np.float64)]
    st = np.stack(cols[:s], axis=1).astype(np.float32)
    return torch.from_numpy(st).to(dev)


def fused_case(name, bins, stats, seg, k, num_bins, exact=False):
    from lightgbm_tpu_torch.ops import histogram as H

    errs = {}
    for mode in HIST_MODES:
        what = f"hist_fused {mode} {name}"
        got = H.hist_fused(bins, stats, seg, k, num_bins, mode)
        again = H.hist_fused(bins, stats, seg, k, num_bins, mode)
        plain = H.hist_fused_plain(bins, stats, seg, k, num_bins, mode)
        torch.cuda.synchronize()
        check(torch.equal(got, again), f"{what}: two launches differ")
        ref, mag = f64_hists(bins, stats, seg, k, num_bins, mode)
        check_cells(got, ref, mag, what, exact)
        check_cells(plain, ref, mag, f"{what} (plain version)", exact)
        errs[mode] = check_cells(got, plain.to(torch.float64), mag,
                                 f"{what} vs plain", exact)
    return errs


def partition_case(name, args, exact=False):
    """``args`` = (bins, stats, row_leaf, slot_of_node, feat, thr,
    direct_left, n_nodes, num_bins) of one wave."""
    from lightgbm_tpu_torch.ops import histogram as H

    bins, stats, row_leaf, slot, feat, thr, dl, n_nodes, num_bins = args
    seg, want_leaf = H.route_wave(bins, row_leaf, slot, feat, thr, dl,
                                  n_nodes)
    errs = {}
    for mode in HIST_MODES:
        what = f"hist_partition {mode} {name}"
        got, leaf = H.hist_partition_fused(*args, mode)
        again, leaf2 = H.hist_partition_fused(*args, mode)
        plain, plain_leaf = H.hist_partition_plain(*args, mode)
        torch.cuda.synchronize()
        check(torch.equal(got, again) and torch.equal(leaf, leaf2),
              f"{what}: two launches differ")
        check(torch.equal(leaf, want_leaf) and torch.equal(leaf, plain_leaf),
              f"{what}: row routing differs from the plain version")
        ref, mag = f64_hists(bins, stats, seg, feat.shape[0], num_bins, mode)
        check_cells(got, ref, mag, what, exact)
        check_cells(plain, ref, mag, f"{what} (plain version)", exact)
        errs[mode] = check_cells(got, plain.to(torch.float64), mag,
                                 f"{what} vs plain", exact)
    return errs


def random_wave(rng, dev, n, f, num_bins, w, capacity):
    """A synthetic wave: rows spread over ``capacity`` nodes, ``w`` of them
    splitting on random features and thresholds."""
    bins = torch.from_numpy(rng.integers(0, num_bins, (n, f)).astype(
        np.uint8)).to(dev)
    row_leaf = torch.from_numpy(rng.integers(-1, capacity + 1, n).astype(
        np.int32)).to(dev)
    slot = np.full(capacity, -1, np.int32)
    slot[rng.permutation(capacity)[:w]] = np.arange(w)
    return (bins, stats_for(rng, n, dev), row_leaf,
            torch.from_numpy(slot).to(dev),
            torch.from_numpy(rng.integers(0, f, w).astype(np.int32)).to(dev),
            torch.from_numpy(rng.integers(0, num_bins, w).astype(
                np.int32)).to(dev),
            torch.from_numpy(rng.integers(0, 2, w).astype(np.uint8)).to(dev),
            2 * capacity, num_bins)


def heavy_wave(rng, dev, n, f, num_bins, w, capacity, share):
    """A synthetic wave whose first slot holds ``share`` of the rows and
    sends them all to its direct (left) child."""
    args = list(random_wave(rng, dev, n, f, num_bins, w, capacity))
    slot = args[3].cpu().numpy()
    node0 = int(np.nonzero(slot == 0)[0][0])
    heavy = torch.from_numpy(rng.random(n) < share).to(dev)
    args[2] = torch.where(heavy, node0, args[2]).to(torch.int32)
    args[5] = args[5].clone()
    args[5][0] = num_bins - 1
    args[6] = args[6].clone()
    args[6][0] = 1
    return tuple(args)


def binary_root_stats(y, dev):
    """The north-star round-1 statistics: binary logloss gradients at the
    boost-from-average score, hessians, all rows in the bag."""
    pbar = float(np.mean(y))
    p = np.full(len(y), pbar)
    st = np.stack([p - y, p * (1 - p), np.ones(len(y))], axis=1)
    return torch.from_numpy(st.astype(np.float32)).to(dev)


def record_wave(bins, stats):
    """Grow one north-star tree with the plain grower and keep the inputs of
    its first widest wave and of its first wave (the root's split): real B2
    calls."""
    import lightgbm_tpu_torch.models.tree as T
    from lightgbm_tpu_torch.config import parse_params
    from lightgbm_tpu_torch.models.gbdt import (HyperScalars,
                                                resolve_wave_width)

    p = parse_params(TRAIN_PARAMS)
    orig = T.hist_partition_plain
    rec = {}

    def spy(*args):
        rec.setdefault("first", args[:9])
        if args[4].shape[0] > rec.get("w", 0):
            rec["w"] = int(args[4].shape[0])
            rec["args"] = args[:9]
        return orig(*args)

    T.hist_partition_plain = spy
    try:
        T.grow_tree(bins, stats, torch.ones(bins.shape[1],
                                            device=bins.device),
                    HyperScalars.from_params(p).ctx(), p.num_leaves, 256,
                    -1, hist_impl="plain", hist_dtype="f32",
                    wave_width=resolve_wave_width(p, bins.shape[0]))
    finally:
        T.hist_partition_plain = orig
    return rec["args"], rec["first"]


def record_strict(bins, stats):
    """Grow one north-star tree with the plain strict grower and keep the
    segments of three of its two-segment B1 calls: the root's split (its
    children hold every row), the call whose children hold the number of
    rows nearest the tree's mean, and the last whose children hold at most
    5,000 rows."""
    import lightgbm_tpu_torch.models.tree as T
    from lightgbm_tpu_torch.config import parse_params
    from lightgbm_tpu_torch.models.gbdt import HyperScalars

    p = parse_params(TRAIN_PARAMS)
    segs = []
    orig = T.compute_histograms

    def spy(b, st, seg, k, *a, **kw):
        if k == 2:
            segs.append(seg.to(torch.int8).clone())
        return orig(b, st, seg, k, *a, **kw)

    T.compute_histograms = spy
    try:
        T.grow_tree(bins, stats, torch.ones(bins.shape[1],
                                            device=bins.device),
                    HyperScalars.from_params(p).ctx(), p.num_leaves, 256,
                    -1, hist_impl="plain", hist_dtype="f32", wave_width=1)
    finally:
        T.compute_histograms = orig
    m = np.array([int((s < 2).sum()) for s in segs])
    mid = int(np.argmin(np.abs(m - m.mean())))
    late = max(i for i in range(len(m)) if m[i] <= STRICT_LATE_ROWS)
    return {name: segs[i].to(torch.int32) for name, i in
            (("strict_early", 0), ("strict_mid", mid),
             ("strict_late", late))}


def phase_hist_kernels(dev, X, y, mapper):
    rng = np.random.default_rng(SEED + 50)
    t0 = time.perf_counter()
    bins = torch.from_numpy(mapper.transform(X)).to(dev)
    root_stats = binary_root_stats(y, dev)
    n = bins.shape[0]
    zeros = torch.zeros(n, dtype=torch.int32, device=dev)
    errs = {"hist_fused": {m: 0.0 for m in HIST_MODES},
            "hist_partition": {m: 0.0 for m in HIST_MODES}}

    def keep(name, e):
        for m, v in e.items():
            errs[name][m] = max(errs[name][m], v)

    keep("hist_fused", fused_case("north-star root", bins, root_stats,
                                  zeros, 1, 256))
    fused_case("north-star root, dyadic", bins,
               stats_for(rng, n, dev, dyadic=True), zeros, 1, 256,
               exact=True)

    def rb(rows, f, b):
        return torch.from_numpy(rng.integers(0, b, (rows, f)).astype(
            np.uint8)).to(dev)

    def rseg(rows, lo, hi):
        return torch.from_numpy(rng.integers(lo, hi, rows).astype(
            np.int32)).to(dev)

    awkward = [
        ("ragged 300,001 rows, 3 segments + out of range", rb(300_001, 28,
         256), stats_for(rng, 300_001, dev), rseg(300_001, -1, 4), 3, 256),
        ("1 feature", rb(200_003, 1, 256), stats_for(rng, 200_003, dev),
         rseg(200_003, 0, 2), 2, 256),
        ("300 features", rb(20_011, 300, 256), stats_for(rng, 20_011, dev),
         rseg(20_011, 0, 2), 2, 256),
        ("64 segments, ids in [-3, 70)", rb(100_003, 5, 64),
         stats_for(rng, 100_003, dev), rseg(100_003, -3, 70), 64, 64),
        ("every row in one bin, empty segments",
         torch.full((50_000, 4), 7, dtype=torch.uint8, device=dev),
         stats_for(rng, 50_000, dev), rseg(50_000, 0, 2) * 3, 8, 256),
        ("2 statistics, 2 bins", rb(4_099, 3, 2),
         stats_for(rng, 4_099, dev, s=2), rseg(4_099, 0, 5), 5, 2),
    ]
    for name, b, st, sg, k, nb in awkward:
        keep("hist_fused", fused_case(name, b, st, sg, k, nb))
    fused_case("64 segments, dyadic", awkward[3][1],
               stats_for(rng, 100_003, dev, dyadic=True), awkward[3][3], 64,
               64, exact=True)
    # the partitioned design's edges: most rows outside both segments (the
    # strict grower's late calls), segments of the recorded strict tree
    outside = torch.where(torch.from_numpy(rng.random(n) < 0.95).to(dev),
                          2, rseg(n, 0, 2))
    keep("hist_fused", fused_case("north star, 95 % of rows outside both "
                                  "segments", bins, root_stats, outside, 2,
                                  256))
    few = torch.full((n,), 2, dtype=torch.int32, device=dev)
    few[torch.from_numpy(rng.choice(n, 300, replace=False)).to(dev)] = \
        rseg(300, 0, 2)
    keep("hist_fused", fused_case("north star, 300 rows in two segments",
                                  bins, root_stats, few, 2, 256))
    strict = record_strict(bins, root_stats)
    for name, seg in strict.items():
        keep("hist_fused", fused_case(f"north star, recorded {name} call "
                                      f"({int((seg < 2).sum())} rows)", bins,
                                      root_stats, seg, 2, 256))
    fused_case("north star, 95 % outside, dyadic", bins,
               stats_for(rng, n, dev, dyadic=True), outside, 2, 256,
               exact=True)

    wave, first_wave = record_wave(bins, root_stats)
    keep("hist_partition", partition_case(
        f"north-star wave (W={wave[4].shape[0]})", wave))
    keep("hist_partition", partition_case("north-star first wave (W=1)",
                                          first_wave))
    for share in (0.9,):
        keep("hist_partition", partition_case(
            f"one slot holding {share:.0%} of the direct rows",
            heavy_wave(rng, dev, 300_001, 28, 256, 42, 120, share)))
    dy = list(wave)
    dy[1] = stats_for(rng, n, dev, dyadic=True)
    partition_case("north-star wave, dyadic", tuple(dy), exact=True)
    for name, shape in [("ragged, 7 splits", (300_001, 28, 256, 7, 40)),
                        ("1 feature, 1 split", (100_003, 1, 256, 1, 3)),
                        ("300 features", (20_011, 300, 256, 5, 21)),
                        ("64 splits", (100_003, 6, 64, 64, 200))]:
        keep("hist_partition", partition_case(
            name, random_wave(rng, dev, *shape)))
    log(f"phase 5: B1 and B2 within {HIST_REL_TOL} x sum|x| of float64 and "
        f"of their plain versions at f32 and bf16, exact on dyadic stats, "
        f"bit-equal across launches (max abs err vs plain {json.dumps(errs)};"
        f" {time.perf_counter() - t0:.1f} s)")
    return errs, bins, root_stats, wave, first_wave, strict


# ---------------------------------------------------------------------------
# phase 6: training at full width
# ---------------------------------------------------------------------------
def train_run(lgb, ds, params, rounds):
    """Train with every counter at 0 before and read after; the plain
    versions counted too (they must not run on the kernel path)."""
    import lightgbm_tpu_torch.models.tree as T
    import lightgbm_tpu_torch.ops.histogram as H

    calls = {"plain": 0}
    origs = (H.hist_fused_plain, T.hist_partition_plain)

    def counted(fn):
        def wrapper(*a, **k):
            calls["plain"] += 1
            return fn(*a, **k)
        return wrapper

    H.hist_fused_plain = counted(origs[0])
    T.hist_partition_plain = counted(origs[1])
    try:
        torch.cuda.synchronize()
        reset_counters()
        t0 = time.perf_counter()
        booster = lgb.train(params, ds, rounds)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = read_counters()
    finally:
        H.hist_fused_plain, T.hist_partition_plain = origs
    return booster, secs, counts, calls["plain"]


def auc(booster, Xv, yv, dev):
    from lightgbm_tpu_torch.metrics import get_metric

    p = torch.from_numpy(booster.predict(Xv)).to(dev)
    y = torch.from_numpy(yv).to(dev)
    return float(get_metric("auc").fn(p, y, torch.ones_like(y)))


def tree_arrays(booster, i):
    from lightgbm_tpu_torch.models.tree import tree_to_arrays

    return tree_to_arrays(booster.trees[i])


def phase_train(dev, X, y, workdir):
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.serving import ModelBank, pack_booster
    from lightgbm_tpu_torch.utils.datasets import make_higgs_like

    Xv, yv = make_higgs_like(VALID_ROWS, NUM_FEATURES, seed=9)
    t0 = time.perf_counter()
    ds = lgb.Dataset(X, label=y, params={"max_bin": MAX_BIN})
    ds.construct()
    t_bin = time.perf_counter() - t0
    check(ds.device.type == "cuda", f"Dataset on {ds.device}")
    runs = {}
    for tag, extra in (("bf16", {}), ("f32", {"hist_dtype": "f32"}),
                       ("plain", {"hist_impl": "plain"})):
        b, secs, counts, plain_calls = train_run(
            lgb, ds, dict(TRAIN_PARAMS, **extra), TRAIN_ROUNDS)
        check(b.num_trees() == TRAIN_ROUNDS, f"{tag}: {b.num_trees()} trees")
        runs[tag] = {"booster": b, "s": secs, "counts": counts,
                     "plain_calls": plain_calls, "auc": auc(b, Xv, yv, dev)}
        log(f"phase 6 {tag}: {TRAIN_ROUNDS} rounds in {secs:.2f} s "
            f"({secs / TRAIN_ROUNDS:.3f} s/round), AUC "
            f"{runs[tag]['auc']:.6f}, launches {json.dumps(counts)}, plain "
            f"calls {plain_calls}")
    for mode in HIST_MODES:
        c, r = runs[mode]["counts"], runs[mode]
        check(c[f"hist_fused_{mode}"] >= TRAIN_ROUNDS,
              f"{mode}: B1 launched {c[f'hist_fused_{mode}']} times")
        check(c[f"hist_partition_{mode}"] > TRAIN_ROUNDS,
              f"{mode}: B2 launched {c[f'hist_partition_{mode}']} times")
        # B1 only at the roots: every wave took B2, never the unfused route
        check(c[f"hist_fused_{mode}"] == TRAIN_ROUNDS
              and c["hist_fused_int8"] == 0,
              f"{mode}: B1 launched {c[f'hist_fused_{mode}']} times (int8 "
              f"{c['hist_fused_int8']}): a wave took the unfused route")
        check(r["plain_calls"] == 0,
              f"{mode}: {r['plain_calls']} plain-version calls on the kernel "
              "path")
        check(0.5 < r["auc"] < 1.0, f"{mode}: AUC {r['auc']}")
    plain = runs["plain"]
    check(sum(v for k, v in plain["counts"].items()
              if k.startswith("hist_")) == 0,
          "hist_impl='plain' launched a histogram kernel")
    # section 2's limit (the kernel path no slower than the plain path) on
    # medians of kernel and plain runs in turns (K P, P K, K P)
    timed = {"bf16": [], "plain": []}
    for i in range(TIMING_PAIRS):
        pair = (("bf16", {}), ("plain", {"hist_impl": "plain"}))
        for tag, extra in (pair if i % 2 == 0 else pair[::-1]):
            secs = train_run(lgb, ds, dict(TRAIN_PARAMS, **extra),
                             TRAIN_ROUNDS)[1]
            timed[tag].append(secs / TRAIN_ROUNDS)
    median_s = {k: float(np.median(v)) for k, v in timed.items()}
    log(f"phase 6 timing: s/round in turns {json.dumps(timed)}, medians "
        f"{json.dumps(median_s)}")
    check(median_s["bf16"] <= median_s["plain"],
          f"the kernel path's median {median_s['bf16']:.4f} s/round is "
          f"slower than the plain path's {median_s['plain']:.4f}")
    d_auc = abs(runs["bf16"]["auc"] - plain["auc"])
    check(d_auc <= AUC_TOL, f"AUC kernel {runs['bf16']['auc']} vs plain "
          f"{plain['auc']}: {d_auc:.2e} > {AUC_TOL}")

    # dyadic labels: the round-1 trees of both paths are the same arrays
    w = np.random.default_rng(SEED + 60).normal(0, 1, NUM_FEATURES)
    order = np.argsort(X @ w + 0.6 * np.sin(X[:, 0] * 2))
    yd = np.zeros(len(X), np.float32)
    yd[order[len(X) // 2:]] = 1.0
    dsd = lgb.Dataset(X, label=yd, params={"max_bin": MAX_BIN})
    dyadic = {}
    for mode in HIST_MODES:
        p = dict(TRAIN_PARAMS, objective="regression", hist_dtype=mode)
        bk = train_run(lgb, dsd, p, 1)[0]
        bp = train_run(lgb, dsd, dict(p, hist_impl="plain"), 1)[0]
        a, b = tree_arrays(bk, 0), tree_arrays(bp, 0)
        same = all(np.array_equal(a[k], b[k]) for k in a)
        check(same, f"dyadic {mode}: the kernel path's round-1 tree differs "
              "from the plain path's")
        dyadic[mode] = int(a["num_leaves"])
    log(f"phase 6 dyadic: round-1 trees of kernel and plain paths equal "
        f"(leaves {json.dumps(dyadic)})")

    # the trained model through slice 1's serving path
    booster = runs["bf16"]["booster"]
    path = os.path.join(workdir, "trained_higgs.npz")
    pack_booster(booster).save(path)
    reset_counters()
    bank = ModelBank(max_bucket=MAX_BUCKET, warm_on_deploy=True,
                     canary_rows=64, forest_precision="f32")
    rep = bank.deploy("trained", path)
    check(rep["ok"], f"deploy of the trained model failed: {rep}")
    served = bank.runtime("trained").predict(X)
    launches = read_counters()["predict_forest"]
    direct = booster.predict(X)
    err_serve = float(np.abs(served - direct).max())
    check(launches > 0, "serving the trained model launched no kernel")
    check(err_serve <= 1e-5, f"served vs Booster.predict: {err_serve:.3e}")
    log(f"phase 6 serve: {BIG_ROWS} rows through ModelBank, max abs diff "
        f"{err_serve:.3e} vs Booster.predict, {launches} predict launches")

    breakdown = profile_rounds(lgb, ds, TRAIN_PARAMS)
    bf = runs["bf16"]
    result = {
        "rows": len(X), "features": NUM_FEATURES, "rounds": TRAIN_ROUNDS,
        "params": TRAIN_PARAMS, "binning_s": t_bin,
        "s_per_round": {k: r["s"] / TRAIN_ROUNDS for k, r in runs.items()},
        "s_per_round_runs_in_turns": timed,
        "s_per_round_median": median_s,
        "rows_rounds_per_s": {k: len(X) * TRAIN_ROUNDS / r["s"]
                              for k, r in runs.items()},
        "waves_per_tree": {m: runs[m]["counts"][f"hist_partition_{m}"]
                           / TRAIN_ROUNDS for m in HIST_MODES},
        "auc": {k: r["auc"] for k, r in runs.items()},
        "auc_kernel_minus_plain": bf["auc"] - plain["auc"],
        "launches": {m: runs[m]["counts"] for m in HIST_MODES},
        "serve_max_abs_diff": err_serve, "serve_predict_launches": launches,
        "dyadic_round1_leaves": dyadic,
        "round_breakdown": breakdown,
    }
    log(f"phase 6: {json.dumps(result)}")
    return result, ds


# the profiled rounds' device-time families: B1's passes (its histogram and
# finish instances, and the partition over segment ids, which no other
# kernel of a single booster's round runs), B2's (its own instances and the
# routing count), B1 int8's histogram pass; everything else is "other"
PROFILE_FAMILIES = {
    "B1 f32/bf16 (hist_fused)": ("hr::b1", "rowpart::SegArray"),
    "B2 (hist_partition)": ("hr::b2", "b2::Route"),
    "B1 int8 (int8_hist_kernel)": ("int8_hist_kernel",),
}


def profile_rounds(lgb, ds, params, rounds=3, tag="phase 6",
                   unfused=False):
    """Where a north-star round's time goes: ``torch.profiler`` over
    ``rounds`` rounds after one warm round; device time by kernel family,
    the device's busy share of the wall time, and the host syncs (one per
    wave, one per exact-tail prune).  ``unfused``: the waves take the
    unfused route (B1 beyond each root, no B2), as categorical ones do."""
    from torch.profiler import ProfilerActivity, profile

    booster = lgb.Booster(params, ds)
    booster.update()
    torch.cuda.synchronize()
    reset_counters()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(rounds):
            booster.update()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    counts = read_counters()
    families = {f: 0.0 for f in PROFILE_FAMILIES}
    families["other"] = 0.0
    top = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
        if dev_us <= 0:
            continue
        top.append((dev_us, e.key, e.count))
        fam = next((f for f, keys in PROFILE_FAMILIES.items()
                    if any(k in e.key for k in keys)), "other")
        families[fam] += dev_us / 1e3
    device_ms = sum(families.values())
    top.sort(reverse=True)
    # a wave is one B2 launch, or on the unfused route one B1 int8 launch
    # beyond the tree's root
    fused = counts["hist_fused_int8"] + (
        counts["hist_fused_bf16"] + counts["hist_fused_f32"] if unfused
        else 0)
    waves = (counts["hist_partition_bf16"] + counts["hist_partition_f32"]
             + max(fused - rounds, 0)) / rounds
    out = {"rounds": rounds, "wall_ms_per_round": wall_ms / rounds,
           "device_ms_per_round": device_ms / rounds,
           "device_busy_share": device_ms / wall_ms if wall_ms else None,
           "device_ms_per_round_by_family": {
               k: v / rounds for k, v in families.items()},
           "b1_share": families["B1 f32/bf16 (hist_fused)"] / device_ms
           if device_ms else None,
           "waves_per_tree": waves,
           "host_syncs_per_round": waves + 1,
           "top_device_ops": [
               {"name": k[:80], "ms_per_round": us / 1e3 / rounds,
                "calls_per_round": c / rounds} for us, k, c in top[:10]]}
    if device_ms == 0:
        out["device_busy_share"] = "not measured (no device time traced)"
    log(f"{tag} breakdown (profiled): {json.dumps(out)}")
    return out


def hist_bound_ms(nbytes, ops):
    b_ms, o_ms = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_OPS_S * 1e3
    return max(b_ms, o_ms), ("bytes" if b_ms >= o_ms else "operations")


def phase_hist_times(bins, root_stats, wave, first_wave, strict):
    """Device ms per launch of each histogram kernel at the main paths'
    shapes (B1: the north-star root and the recorded strict calls; B2: the
    recorded 42-split wave and first wave), its plain version's, its bound
    and for B1 one ``index_add_`` call over precomputed cell indices.  The
    bounds count the bytes this data needs: B1 reads each row's segment id
    and the codes and statistics of the rows in its segments once and
    writes ``[K, F, B, 3]`` (``4n + m (F + 12) + K F B 12``); B2 reads each
    row's leaf, the split code of the rows of splitting leaves, the direct
    rows' codes and statistics, and writes ``new_row_leaf`` and ``[W, F,
    B, 3]``.  The operations (one add per row in a segment, feature and
    statistic) bound none of them."""
    from lightgbm_tpu_torch.ops import histogram as H

    n, f = bins.shape
    dev = bins.device
    rows = {}
    b1_shapes = {"root": (torch.zeros(n, dtype=torch.int32, device=dev), 1)}
    b1_shapes.update({name: (seg, 2) for name, seg in strict.items()})
    for shape, (seg, k) in b1_shapes.items():
        sel = torch.nonzero((seg >= 0) & (seg < k)).squeeze(1)
        m = int(sel.numel())
        bound = hist_bound_ms(4 * n + m * (f + 12) + k * f * 256 * 12,
                              m * f * 3)
        flat = (((seg[sel].to(torch.int64) * f)[:, None]
                 + torch.arange(f, device=dev)) * 256
                + bins[sel].to(torch.int64)).reshape(-1)
        vals = root_stats[sel].repeat_interleave(f, dim=0)
        out = torch.zeros(k * f * 256, 3, dtype=torch.float32, device=dev)
        lib_ms = time_ms(lambda: out.index_add_(0, flat, vals), runs=11,
                         inner=3)
        del flat, vals, out
        for mode in HIST_MODES:
            name = f"hist_fused_{mode}" + ("" if shape == "root"
                                           else f"_{shape}")
            rows[name] = {
                "shape": f"n={n} F={f} B=256 K={k} S=3 rows in a segment "
                         f"{m} ({shape})",
                "ms": time_ms(lambda: H.hist_fused(bins, root_stats, seg, k,
                                                   256, mode),
                              runs=11, inner=5),
                "plain_ms": time_ms(lambda: H.hist_fused_plain(
                    bins, root_stats, seg, k, 256, mode), runs=5, inner=1),
                "bound_ms": bound[0], "bound_by": bound[1],
                "library_ms": lib_ms}
    for shape, args in (("wave", wave), ("first_wave", first_wave)):
        w = int(args[4].shape[0])
        seg, _ = H.route_wave(args[0], *args[2:8])
        direct = int((seg >= 0).sum())
        leaf = args[2].to(torch.int64)
        cap = args[3].shape[0]
        slot = args[3].to(torch.int64)[leaf.clamp(0, cap - 1)]
        routed = int(((leaf >= 0) & (leaf < cap) & (slot >= 0)).sum())
        bound = hist_bound_ms(8 * n + routed + direct * (f + 12)
                              + w * f * 256 * 12, direct * f * 3)
        for mode in HIST_MODES:
            name = f"hist_partition_{mode}" + ("" if shape == "wave"
                                               else f"_{shape}")
            rows[name] = {
                "shape": f"n={n} F={f} B=256 W={w} direct rows {direct} "
                         f"({shape})",
                "ms": time_ms(lambda: H.hist_partition_fused(*args, mode),
                              runs=11, inner=5),
                "plain_ms": time_ms(lambda: H.hist_partition_plain(*args,
                                                                   mode),
                                    runs=5, inner=1),
                "bound_ms": bound[0], "bound_by": bound[1],
                "library_ms": None}
    for name, r in rows.items():
        log(f"phase 6 times {name}: {json.dumps(r)}")
    return rows


# ---------------------------------------------------------------------------
# phase 7: the split-iteration kernel (B3) and the segstats histogram (B6)
# against their plain versions on the card
# ---------------------------------------------------------------------------
def bits_equal(a, b) -> bool:
    """Bit for bit: signed zeros and NaN payloads count."""
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def rand_child_hists(rng, dev, lead, f, b, kind):
    """Children's (grad, hess, count) histograms ``lead + [F, B, 3]``:
    random, dyadic (every partial sum exact) or tied (every feature a copy
    of feature 0, so equal gains tie across features)."""
    shape = tuple(lead) + (f, b)
    if kind == "dyadic":
        g = rng.integers(-8, 9, shape) * 0.5
        h = rng.integers(0, 9, shape) * 0.25
    else:
        g = rng.normal(size=shape)
        h = rng.uniform(0, 0.25, shape)
    c = rng.integers(0, 6, shape).astype(np.float64)
    hist = np.stack([g, h * (c > 0), c], axis=-1).astype(np.float32)
    if kind == "ties":
        hist[..., :, :, :] = hist[..., :1, :, :]
    return torch.from_numpy(hist).to(dev)


def b3_case(rng, dev, e, f, b, cap, kind, iters, in_place=False):
    """Chain ``iters`` strict split iterations of ``e`` elements with
    per-element regularizers, some elements inactive from the start and
    some with a depth cap; at every iteration the kernel's table and aux
    must equal the plain version's bit for bit.  The kernel updates its
    table in place: it runs on a clone of the plain version's table, or
    with ``in_place`` on its own running table and aux, as the strict
    grower calls it.  Returns the launches."""
    from lightgbm_tpu_torch.kernels.split_iter import split_iter
    from lightgbm_tpu_torch.models.tree import (_packed_root_table,
                                                split_iter_plain)
    from lightgbm_tpu_torch.ops.split import (SplitContext,
                                              constrained_leaf_output,
                                              find_best_split)

    def pick(vals):
        return torch.tensor(np.asarray(vals, np.float32)[
            rng.integers(0, len(vals), e)], device=dev)

    ctx = SplitContext(pick([0.0, 0.5]), pick([0.0, 1.0]),
                       pick([1.0, 3.0, 20.0]), pick([1e-3, 0.5]),
                       pick([0.0, 0.1]), pick([0.0, 0.3]), pick([0.0, 2.0]))
    max_depth = pick([-1.0, 3.0, 5.0])
    fmask = torch.from_numpy((rng.random((e, f)) < 0.8).astype(
        np.float32)).to(dev)
    fmask[:, 0] = 1.0
    root = rand_child_hists(rng, dev, (e,), f, b, kind) * 4.0
    tot = root[:, 0].sum(dim=1)
    zero = torch.zeros(e, dtype=torch.float32, device=dev)
    root_out = constrained_leaf_output(tot[:, 0], tot[:, 1], tot[:, 2],
                                       ctx._replace(path_smooth=zero),
                                       float("-inf"), float("inf"), zero)
    best = find_best_split(root, ctx, fmask, None, root_out, arith="scan")
    table = _packed_root_table(cap, root_out, tot, best)
    active = torch.isfinite(best.gain) & torch.from_numpy(
        rng.random(e) < 0.85).to(dev)
    aux = torch.stack([zero, best.feature.float(), best.bin.float(),
                       active.float(), zero, zero, zero, zero], dim=1)
    scal = torch.zeros((e, 16), dtype=torch.float32, device=dev)
    for i, v in enumerate(ctx):
        scal[:, i] = v
    scal[:, 7] = max_depth
    scal[:, 8] = 1.0
    tk, ak = table.clone(), aux
    for it in range(iters):
        hist = rand_child_hists(rng, dev, (e, 2), f, b, kind)
        src = tk if in_place else table.clone()
        tk, ak = split_iter(hist, src, fmask, ak if in_place else aux, scal)
        tp, ap = split_iter_plain(hist, table, fmask, aux, scal)
        torch.cuda.synchronize()
        check(tk.data_ptr() == src.data_ptr(),
              "B3 did not update its table in place")
        if not (bits_equal(tk, tp) and bits_equal(ak, ap)):
            diff = torch.nonzero(tk.view(torch.int32)
                                 != tp.view(torch.int32))[:5].tolist()
            fail(f"B3 E={e} F={f} B={b} {kind} iteration {it}: kernel != "
                 f"plain at [e, node, col] {diff}; aux kernel "
                 f"{ak[:3].tolist()} plain {ap[:3].tolist()}")
        scal[:, 8] += 2.0 * (aux[:, 3] > 0).float()
        table, aux = tp, ap
    return iters


def segstats_f64(bins, segstats, num_bins, mode):
    """Float64 sums on the card of the mode-rounded channels and of their
    absolute values: ``[F, B, Kc]`` each."""
    st = segstats.to(torch.bfloat16).to(torch.float32) if mode == "bf16" \
        else segstats
    st = st.to(torch.float64)
    n, f = bins.shape
    ref = torch.zeros((f * num_bins, st.shape[1]), dtype=torch.float64,
                      device=bins.device)
    mag = torch.zeros_like(ref)
    codes = bins.to(torch.int64)
    for j in range(f):
        idx = j * num_bins + codes[:, j]
        ref.index_add_(0, idx, st)
        mag.index_add_(0, idx, st.abs())
    shape = (f, num_bins, st.shape[1])
    return ref.view(shape), mag.view(shape)


def b6_case(name, bins, segstats, num_bins, exact=False):
    from lightgbm_tpu_torch.ops import histogram as H

    errs = {}
    for mode in HIST_MODES:
        what = f"hist_segstats {mode} {name}"
        got = H.hist_segstats(bins, segstats, num_bins, mode)
        again = H.hist_segstats(bins, segstats, num_bins, mode)
        plain = H.hist_segstats_plain(bins, segstats, num_bins, mode)
        torch.cuda.synchronize()
        check(bits_equal(got, again), f"{what}: two launches differ")
        ref, mag = segstats_f64(bins, segstats, num_bins, mode)
        check_cells(got, ref, mag, what, exact)
        check_cells(plain, ref, mag, f"{what} (plain version)", exact)
        errs[mode] = check_cells(got, plain.to(torch.float64), mag,
                                 f"{what} vs plain", exact)
        del ref, mag
    return errs


def diamonds_split():
    """The grid-search workflow's training split: ``make_synthetic_diamonds``
    cut by ``train_test_split_bernoulli`` (about 45,800 x 6)."""
    from lightgbm_tpu_torch.utils.datasets import (
        make_synthetic_diamonds, train_test_split_bernoulli)

    X, y, _ = make_synthetic_diamonds()
    tr, _ = train_test_split_bernoulli(len(y), p_train=0.85, seed=SWEEP_SEED)
    return X[tr], y[tr]


def phase_b3_b6(dev, higgs_bins):
    from lightgbm_tpu_torch.dataset import BinMapper

    rng = np.random.default_rng(SEED + 70)
    t0 = time.perf_counter()
    cases = 0
    for e in (1, 5, 40):
        for f in (6, 28):
            for b in (16, 63, 256):
                for kind in ("random", "dyadic", "ties"):
                    iters = 12 if (b == 256 and kind == "random") else 4
                    b3_case(rng, dev, e, f, b, CAPACITY, kind, iters)
                    cases += 1
    # five elements grown through a whole 127-leaf tree
    b3_case(rng, dev, 5, 6, 256, CAPACITY, "random", NUM_LEAVES - 1)
    # in place, as the strict grower calls it: the strict Booster's shape
    # (E = 1, F = 28: a cluster of eight blocks) and cv()'s (E = 5, F = 6)
    for e, f in ((1, 28), (5, 6)):
        for b in (16, 63, 256):
            b3_case(rng, dev, e, f, b, CAPACITY, "random", 12, in_place=True)
            cases += 1
    b3_case(rng, dev, 1, 28, 256, CAPACITY, "random", NUM_LEAVES - 1,
            in_place=True)
    log(f"phase 7: B3 == plain version bit for bit in {cases + 2} cases "
        f"(E in 1/5/40, F in 6/28, B in 16/63/256, capacity {CAPACITY}; "
        f"random, dyadic and tied histograms, per-element regularizers, "
        f"inactive elements, depth caps; six chains and a whole 127-leaf "
        f"tree with the table updated in place at E = 1/F = 28 and E = 5/"
        f"F = 6; {time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    Xd, _ = diamonds_split()
    dbins = torch.from_numpy(BinMapper.fit(Xd, max_bin=MAX_BIN).transform(
        Xd)).to(dev)
    errs = {m: 0.0 for m in HIST_MODES}

    def keep(e):
        for m, v in e.items():
            errs[m] = max(errs[m], v)

    shapes = [("diamonds", dbins, 256), ("north-star rows", higgs_bins, 256)]
    for name, bins, nb in shapes:
        n = bins.shape[0]
        for kc in SEGSTATS_KC:
            st = torch.from_numpy(rng.normal(size=(n, kc)).astype(
                np.float32)).to(dev)
            keep(b6_case(f"{name} {n}x{bins.shape[1]} Kc={kc}", bins, st,
                         nb))
            del st
        dy = torch.from_numpy((rng.integers(-4, 5, (n, 240)) * 0.25).astype(
            np.float32)).to(dev)
        b6_case(f"{name} Kc=240 dyadic", bins, dy, nb, exact=True)
        del dy
    log(f"phase 7: B6 within {HIST_REL_TOL} x sum|x| of float64 and of its "
        f"plain version at f32 and bf16 for Kc in {list(SEGSTATS_KC)} on "
        f"the diamonds split ({dbins.shape[0]} x {dbins.shape[1]}) and "
        f"{higgs_bins.shape[0]} x {higgs_bins.shape[1]}, exact on dyadic "
        f"channels, bit-equal across launches (max abs err vs plain "
        f"{json.dumps(errs)}; {time.perf_counter() - t0:.1f} s)")
    return errs, dbins


# ---------------------------------------------------------------------------
# phase 8: the strict grower, cv() and the sweep at full width
# ---------------------------------------------------------------------------
def b3_b6_counters():
    from lightgbm_tpu_torch.kernels.histogram import (
        HIST_FUSED_BATCHED_LAUNCHES, HIST_SEGSTATS_LAUNCHES)
    from lightgbm_tpu_torch.kernels.split_iter import SPLIT_ITER_LAUNCHES

    return (SPLIT_ITER_LAUNCHES, HIST_SEGSTATS_LAUNCHES,
            HIST_FUSED_BATCHED_LAUNCHES)


def plain_spies(skip=()):
    """Wrap every plain version the training paths can reach so a run can
    count the calls (they must not run on the kernel path); ``skip`` names
    the ones a path runs as its own body (the unfused strict body's split
    scan, ``split_iter_plain``, under per-node sampling)."""
    import lightgbm_tpu_torch.models.tree as T
    import lightgbm_tpu_torch.ops.histogram as H

    calls = {"plain": 0}
    targets = [(m, name) for m, name in (
        (H, "hist_fused_plain"), (H, "hist_segstats_plain"),
        (H, "hist_fused_batched_plain"), (T, "hist_partition_plain"),
        (T, "split_iter_plain")) if name not in skip]
    origs = [(m, name, getattr(m, name)) for m, name in targets]

    def counted(fn):
        def wrapper(*a, **k):
            calls["plain"] += 1
            return fn(*a, **k)
        return wrapper

    for m, name, fn in origs:
        setattr(m, name, counted(fn))

    def restore():
        for m, name, fn in origs:
            setattr(m, name, fn)
    return calls, restore


def counted_run(fn, skip=()):
    """``fn()`` with every counter at 0 just before and read just after;
    returns (result, seconds, counts, plain-version calls) (``skip``: see
    :func:`plain_spies`)."""
    si, ss, sb = b3_b6_counters()
    calls, restore = plain_spies(skip)
    try:
        torch.cuda.synchronize()
        reset_counters()
        si.reset()
        for c in (*ss.values(), *sb.values()):
            c.reset()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = read_counters()
        counts["split_iter"] = si.count
        for m, c in ss.items():
            counts[f"hist_segstats_{m}"] = c.count
        for m, c in sb.items():
            counts[f"hist_fused_batched_{m}"] = c.count
    finally:
        restore()
    return out, secs, counts, calls["plain"]


def phase_strict(dev, X, y):
    """(a) The single-booster strict grower at the north star."""
    import lightgbm_tpu_torch as lgb

    from lightgbm_tpu_torch.utils.datasets import make_higgs_like

    Xv, yv = make_higgs_like(VALID_ROWS, NUM_FEATURES, seed=9)
    ds = lgb.Dataset(X, label=y, params={"max_bin": MAX_BIN})
    ds.construct()
    params = dict(TRAIN_PARAMS, grow_policy="leafwise")
    runs = {}
    for tag, extra in (("kernels", {}), ("plain", {"hist_impl": "plain"})):
        b, secs, counts, plain_calls = counted_run(
            lambda: lgb.train(dict(params, **extra), ds, STRICT_ROUNDS))
        runs[tag] = {"s": secs, "counts": counts, "plain_calls": plain_calls,
                     "auc": auc(b, Xv, yv, dev), "booster": b}
        log(f"phase 8a {tag}: {STRICT_ROUNDS} strict rounds in {secs:.2f} s, "
            f"AUC {runs[tag]['auc']:.6f}, launches {json.dumps(counts)}, "
            f"plain calls {plain_calls}")
    k = runs["kernels"]
    check(k["counts"]["hist_fused_bf16"] + k["counts"]["hist_fused_f32"] > 0
          and k["counts"]["split_iter"] > 0,
          f"strict kernel path launches {k['counts']}")
    check(k["plain_calls"] == 0, f"{k['plain_calls']} plain-version calls on "
          "the strict kernel path")
    check(runs["plain"]["counts"]["split_iter"] == 0,
          "the plain strict path launched B3")
    d_auc = k["auc"] - runs["plain"]["auc"]
    check(abs(d_auc) <= AUC_TOL, f"strict AUC kernel - plain {d_auc:.2e}")
    w = np.random.default_rng(SEED + 80).normal(0, 1, NUM_FEATURES)
    order = np.argsort(X @ w + 0.6 * np.sin(X[:, 0] * 2))
    yd = np.zeros(len(X), np.float32)
    yd[order[len(X) // 2:]] = 1.0
    dsd = lgb.Dataset(X, label=yd, params={"max_bin": MAX_BIN})
    p = dict(params, objective="regression", hist_dtype="f32")
    bk = lgb.train(p, dsd, 1)
    bp = lgb.train(dict(p, hist_impl="plain"), dsd, 1)
    a, b = tree_arrays(bk, 0), tree_arrays(bp, 0)
    check(all(np.array_equal(a[key], b[key]) for key in a),
          "dyadic strict round-1 trees of kernel and plain paths differ")
    breakdown = profile_rounds(lgb, ds, params, tag="phase 8a strict")
    out = {"rounds": STRICT_ROUNDS,
           "s_per_round": {t: r["s"] / STRICT_ROUNDS for t, r in runs.items()},
           "auc": {t: r["auc"] for t, r in runs.items()},
           "auc_kernel_minus_plain": d_auc,
           "launches": k["counts"], "dyadic_round1_leaves":
           int(a["num_leaves"]),
           "profiled_device_ms_per_round": breakdown["device_ms_per_round"],
           "profiled_b1_share": breakdown["b1_share"],
           "round_breakdown": breakdown}
    log(f"phase 8a: {json.dumps(out)}")
    return out


def phase_cv(dev):
    """(b) ``cv()`` exactly as examples/gridsearch_cv.py calls it, through the
    kernels and through the plain versions."""
    import lightgbm_tpu_torch as lgb

    Xd, yd = diamonds_split()
    ds = lgb.Dataset(Xd, label=yd)
    ds.construct()
    res, hist = {}, {}
    for tag, extra, cap in (("kernels", {}, CV_ROUNDS),
                            ("plain", {"hist_impl": "plain"},
                             CV_PLAIN_ROUNDS)):
        fit, secs, counts, plain_calls = counted_run(
            lambda: lgb.cv(dict(CV_PARAMS, **extra), ds,
                           num_boost_round=cap, nfold=CV_FOLDS,
                           metrics="rmse", early_stopping_rounds=CV_ES,
                           stratified=False, seed=SWEEP_SEED))
        hist[tag] = np.asarray(fit["valid rmse-mean"], np.float64)
        rounds = len(hist[tag])
        res[tag] = {"best_iter": fit.best_iter, "best_score": fit.best_score,
                    "s": secs, "counts": counts, "plain_calls": plain_calls,
                    "history_len": rounds}
        log(f"phase 8b cv {tag}: best_iter {fit.best_iter}, best_score "
            f"{fit.best_score!r}, {secs:.2f} s, launches {json.dumps(counts)},"
            f" plain calls {plain_calls}")
    k, p = res["kernels"], res["plain"]
    check(k["counts"]["split_iter"] > 0
          and k["counts"]["hist_segstats_f32"] > 0,
          f"cv kernel path launches {k['counts']}")
    check(k["plain_calls"] == 0, f"{k['plain_calls']} plain-version calls on "
          "the cv kernel path")
    check(np.isfinite(k["best_score"]) and k["best_score"] < 0,
          f"cv best_score {k['best_score']}")
    # the plain run against the kernel run's first CV_PLAIN_ROUNDS rounds:
    # every fold-mean RMSE within 1e-5 relative, the best round equal
    n = p["history_len"]
    head = hist["kernels"][:n]
    check(k["history_len"] > n == CV_PLAIN_ROUNDS,
          f"cv rounds kernel {k['history_len']} plain {n}")
    rel = float(np.max(np.abs(head - hist["plain"]) / hist["plain"]))
    check(rel <= 1e-5, f"cv fold-mean RMSE kernel vs plain: rel {rel:.2e}")
    check(int(np.argmin(head)) + 1 == p["best_iter"],
          f"cv best round of the first {n}: kernel "
          f"{int(np.argmin(head)) + 1} vs plain {p['best_iter']}")
    res["best_score_rel_diff"] = rel
    res["rounds_run"] = min(k["best_iter"] + CV_ES, CV_ROUNDS)
    return res, ds


def sweep_grid():
    """The 36 learning_rate=0.1 rows of examples/gridsearch_cv.py's 108."""
    from lightgbm_tpu_torch.utils.sweep import expand_grid

    grid = expand_grid(learning_rate=[0.1, 0.05, 0.01],
                       num_leaves=[31, 63, 127], min_data_in_leaf=[20, 40],
                       feature_fraction=[0.8, 1.0],
                       bagging_fraction=[0.6, 0.8, 1.0], bagging_freq=[4],
                       nthread=[4])
    return [g for g in grid if g["learning_rate"] == 0.1]


def phase_sweep(ds, workdir):
    """(c) ``run_grid_search`` over the 36 learning_rate=0.1 rows."""
    from lightgbm_tpu_torch.utils.sweep import run_grid_search

    grid = sweep_grid()
    path = os.path.join(workdir, "paramGrid_lr0.1.json")
    if os.path.exists(path):
        os.unlink(path)
    ledger, secs, counts, plain_calls = counted_run(
        lambda: run_grid_search(
            grid, ds, base_params={"objective": "regression",
                                   "verbosity": -1, "hist_dtype": "bf16"},
            num_boost_round=CV_ROUNDS, nfold=CV_FOLDS,
            early_stopping_rounds=CV_ES, ledger_path=path, seed=SWEEP_SEED,
            verbose=False))
    check(not ledger.pending(), f"sweep left rows {ledger.pending()}")
    check(counts["split_iter"] > 0 and counts["hist_segstats_bf16"] > 0,
          f"sweep launches {counts}")
    check(plain_calls == 0, f"{plain_calls} plain-version calls in the sweep")
    stats = ledger.sweep_stats
    buckets = [{k: b[k] for k in ("num_leaves", "configs", "rounds", "s")}
               for b in stats["buckets"]]
    check(len(buckets) == 6, f"{len(buckets)} buckets, expected 6")
    board = ledger.leaderboard()
    for r in ledger.rows:
        check(r["iteration"] >= 1 and np.isfinite(r["score"])
              and r["score"] < 0, f"sweep row {r}")
    out = {"configs": len(grid), "s": secs,
           "configs_per_hour": len(grid) / secs * 3600.0,
           "buckets": buckets, "launches": counts,
           "top3": [{k: r[k] for k in ("num_leaves", "min_data_in_leaf",
                                       "feature_fraction",
                                       "bagging_fraction", "iteration",
                                       "score")} for r in board[:3]]}
    log(f"phase 8c sweep: {json.dumps(out)}")
    return out


def profile_fused_round(ds):
    """Where one fused round's time goes at num_leaves 127, E = 40 (8
    configs x 5 folds of the sweep's bagged bucket): ``torch.profiler``
    over one round after a warm one; device time of B6, B3 and the plain
    ops, and the host's share of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    from lightgbm_tpu_torch.config import parse_params
    from lightgbm_tpu_torch.kernels import histogram as kh
    from lightgbm_tpu_torch.models.fused import FusedCVProgram

    grid = [g for g in sweep_grid() if g["num_leaves"] == 127
            and g["bagging_fraction"] < 1.0]
    params = [parse_params(dict(g, objective="regression", verbosity=-1,
                                hist_dtype="bf16"), warn_unknown=False)
              for g in grid]
    n = ds.num_data()
    assign = np.random.default_rng(SWEEP_SEED).permutation(n) % CV_FOLDS
    masks = np.stack([assign != k for k in range(CV_FOLDS)])
    prog = FusedCVProgram(ds, params, masks, CV_ROUNDS, CV_ES, SWEEP_SEED)
    carry = prog.step(prog.init(), 1)
    torch.cuda.synchronize()
    # the (rows, channels) of the round's B6 calls
    b6_shapes = collections.Counter()
    orig = kh.hist_segstats

    def spy(bins, segstats, *a):
        b6_shapes[f"n={segstats.shape[0]} Kc={segstats.shape[1]}"] += 1
        return orig(bins, segstats, *a)

    kh.hist_segstats = spy
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            carry = prog.step(carry, 2)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        kh.hist_segstats = orig
    fam = {"b6:: kernels (B6)": 0.0, "split_iter_kernel (B3)": 0.0,
           "plain PyTorch ops": 0.0}
    top = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        if us <= 0:
            continue
        top.append((us, e.key, e.count))
        key = next((k for k in fam if k.split()[0] in e.key),
                   "plain PyTorch ops")
        fam[key] += us / 1e3
    dev_ms = sum(fam.values())
    top.sort(reverse=True)
    out = {"elements": prog.batch, "num_leaves": 127,
           "b6_calls_by_shape": dict(b6_shapes),
           "wall_ms": wall_ms, "device_ms": dev_ms,
           "device_busy_share": dev_ms / wall_ms if dev_ms else
           "not measured (no device time traced)",
           "host_share": 1.0 - dev_ms / wall_ms if dev_ms else
           "not measured",
           "device_ms_by_family": fam,
           "top_device_ops": [{"name": k[:80], "ms": us / 1e3, "calls": c}
                              for us, k, c in top[:10]]}
    log(f"phase 8 breakdown (profiled fused round): {json.dumps(out)}")
    return out


def phase_b3_b6_times(dbins):
    """Device ms per launch of B6 at the sweep's shape (the num_leaves 127,
    E = 40 bucket on the diamonds split) and of B3 at every main path's
    (E = 40, 20 and 5 at F = 6; E = 1 at F = 28), the plain versions', the
    bounds, B6's ``index_add_`` call's and an empty kernel's (the launch
    floor B3 sits on)."""
    from lightgbm_tpu_torch.kernels.split_iter import split_iter
    from lightgbm_tpu_torch.models.tree import split_iter_plain
    from lightgbm_tpu_torch.ops import histogram as H

    rng = np.random.default_rng(SEED + 90)
    dev = dbins.device
    n, f = dbins.shape
    rows = {}
    e, kc = 40, 240
    st = torch.from_numpy(rng.normal(size=(n, kc)).astype(np.float32)).to(
        dev)
    # B6: bins and the n x Kc statistics read once, [F, B, Kc] written;
    # n * F * Kc adds
    b6_bound = hist_bound_ms(n * f + 4 * n * kc + 4 * f * 256 * kc,
                             n * f * kc)
    flat = (torch.arange(f, device=dev) * 256
            + dbins.to(torch.int64)).reshape(-1)
    vals = st.repeat_interleave(f, dim=0)
    out = torch.zeros(f * 256, kc, dtype=torch.float32, device=dev)
    lib_ms = time_ms(lambda: out.index_add_(0, flat, vals), runs=11, inner=3)
    del flat, vals
    for mode in HIST_MODES:
        rows[f"hist_segstats_{mode}"] = {
            "shape": f"n={n} F={f} B=256 Kc={kc}",
            "ms": time_ms(lambda: H.hist_segstats(dbins, st, 256, mode),
                          runs=11, inner=5),
            "plain_ms": time_ms(lambda: H.hist_segstats_plain(
                dbins, st, 256, mode), runs=5, inner=1),
            "bound_ms": b6_bound[0], "bound_by": b6_bound[1],
            "library_ms": lib_ms}
    # B3 at the main paths' shapes, B = 256, capacity 253: the strict
    # Booster (E = 1, F = 28), the example's cv() (E = 5, F = 6) and the
    # sweep's buckets (E = 20 and 40, F = 6); bytes: the histograms, the
    # leaf's row, the pick's two columns, masks and scalars read, three rows
    # and aux written (the table is updated in place); operations: about 40
    # f32 ops per (child, feature, bin)
    from lightgbm_tpu_torch.kernels.split_iter_timing import inputs
    empty_ms = time_ms(lambda: torch.cuda._sleep(0), runs=11, inner=5)
    for e, f in ((40, 6), (1, 28), (5, 6), (20, 6)):
        hist, table, fmask, aux, scal = inputs(rng, dev, e, f)
        b3_bytes = 4 * (hist.numel() + e * (2 * CAPACITY + 24 + 3 * 24)
                        + fmask.numel() + 2 * aux.numel() + scal.numel())
        b3_bound = hist_bound_ms(b3_bytes, 40 * e * 2 * f * 256)
        name = "split_iter" if e == 40 else f"split_iter_E{e}_F{f}"
        rows[name] = {
            "shape": f"E={e} F={f} B=256 capacity={CAPACITY}",
            "ms": time_ms(lambda: split_iter(hist, table, fmask, aux, scal),
                          runs=11, inner=5),
            "plain_ms": time_ms(lambda: split_iter_plain(
                hist, table, fmask, aux, scal), runs=5, inner=1),
            "bound_ms": b3_bound[0], "bound_by": b3_bound[1],
            "library_ms": None, "empty_kernel_ms": empty_ms}
    for name, r in rows.items():
        log(f"phase 8 times {name}: {json.dumps(r)}")
    return rows


# ---------------------------------------------------------------------------
# phase 9: the batched fused histogram (B5) against float64 and its plain
# version on the card
# ---------------------------------------------------------------------------
def covertype_like(n, seed):
    """Rows with the shape of UCI Covertype: 10 quantitative columns, a
    one-hot wilderness area (4) and soil type (40); the class is the argmax
    of a fixed linear score plus Gumbel noise (the weights come from their
    own stream, so every seed shares the labelling function)."""
    rng = np.random.default_rng(seed)
    num = rng.normal(0, 1, (n, COV_NUMERIC))
    wild = np.eye(COV_WILD)[rng.integers(0, COV_WILD, n)]
    soil = np.eye(COV_SOIL)[rng.integers(0, COV_SOIL, n)]
    X = np.hstack([num, wild, soil]).astype(np.float32)
    W = np.random.default_rng(20261017).normal(0, 1, (X.shape[1],
                                                      COV_CLASSES))
    y = np.argmax(X @ W + rng.gumbel(size=(n, COV_CLASSES)), axis=1)
    return X, y.astype(np.float32)


def wave_segments(rng, e, n, k, dev, lo=0, hi=None):
    """Segments ``[E, n]`` of a wave: about 45 % of the rows in a direct
    child (ids in ``[lo, hi)``, ``hi`` = K by default), the rest -1."""
    hi = k if hi is None else hi
    ids = rng.integers(lo, hi, (e, n))
    seg = np.where(rng.random((e, n)) < 0.45, ids, -1).astype(np.int32)
    return torch.from_numpy(seg).to(dev)


def b5_case(name, bins, stats, seg, k, num_bins, exact=False):
    """B5 at both modes: two launches bit-equal, every element's cells
    within HIST_REL_TOL x sum|x| of float64 (exact when asked), and against
    the plain version."""
    from lightgbm_tpu_torch.ops import histogram as H

    errs = {}
    for mode in HIST_MODES:
        what = f"hist_fused_batched {mode} {name}"
        got = H.hist_fused_batched(bins, stats, seg, k, num_bins, mode)
        again = H.hist_fused_batched(bins, stats, seg, k, num_bins, mode)
        plain = H.hist_fused_batched_plain(bins, stats, seg, k, num_bins,
                                           mode)
        torch.cuda.synchronize()
        check(bits_equal(got, again), f"{what}: two launches differ")
        errs[mode] = 0.0
        for e in range(stats.shape[0]):
            ref, mag = f64_hists(bins, stats[e], seg[e], k, num_bins, mode)
            check_cells(got[e], ref, mag, f"{what} element {e}", exact)
            check_cells(plain[e], ref, mag,
                        f"{what} element {e} (plain version)", exact)
            errs[mode] = max(errs[mode], check_cells(
                got[e], plain[e].to(torch.float64), mag,
                f"{what} element {e} vs plain", exact))
            del ref, mag
        del got, again, plain
    return errs


def phase_b5(dev, higgs_bins, cov_bins):
    rng = np.random.default_rng(SEED + 100)
    t0 = time.perf_counter()
    n, _ = higgs_bins.shape
    nc = cov_bins.shape[0]

    def stats(e, rows, dyadic=False):
        return torch.stack([stats_for(rng, rows, dev, dyadic)
                            for _ in range(e)])

    errs = {m: 0.0 for m in HIST_MODES}

    def keep(e):
        for m, v in e.items():
            errs[m] = max(errs[m], v)

    keep(b5_case(f"north-star wave {n} x {higgs_bins.shape[1]}, E=5, K=42",
                 higgs_bins, stats(5, n), wave_segments(rng, 5, n, 42, dev),
                 42, 256))
    keep(b5_case(f"Covertype-shaped wave {nc} x {cov_bins.shape[1]}, E=7, "
                 "K=42", cov_bins, stats(7, nc),
                 wave_segments(rng, 7, nc, 42, dev), 42, 256))
    keep(b5_case("K=22 (the route's edge), E=5", higgs_bins, stats(5, n),
                 wave_segments(rng, 5, n, 22, dev), 22, 256))
    rows = min(300_001, n)
    keep(b5_case(f"ragged {rows} rows, ids in [-3, 45), K=42, E=2",
                 higgs_bins[:rows], stats(2, rows),
                 wave_segments(rng, 2, rows, 42, dev, -3, 45), 42, 256))
    b5_case("north-star wave, dyadic, E=5, K=42", higgs_bins,
            stats(5, n, dyadic=True), wave_segments(rng, 5, n, 42, dev), 42,
            256, exact=True)
    log(f"phase 9: B5 within {HIST_REL_TOL} x sum|x| of float64 and of its "
        f"plain version at f32 and bf16 (north-star and Covertype-shaped "
        f"waves, K=22, out-of-range ids, ragged rows), exact on dyadic "
        f"stats, bit-equal across launches (max abs err vs plain "
        f"{json.dumps(errs)}; {time.perf_counter() - t0:.1f} s)")
    return errs


# ---------------------------------------------------------------------------
# phase 10: cv() at the north star through the wave regime
# ---------------------------------------------------------------------------
def north_star_cv(lgb, ds, extra):
    return lgb.cv(dict(TRAIN_PARAMS, **extra), ds,
                  num_boost_round=NS_CV_ROUNDS, nfold=NS_CV_FOLDS,
                  early_stopping_rounds=NS_CV_ES, seed=SEED)


def phase_cv_north_star(dev, X, y):
    import lightgbm_tpu_torch as lgb

    ds = lgb.Dataset(X, label=y, params={"max_bin": MAX_BIN})
    ds.construct()
    res = {}
    for tag, extra in (("kernels", {}), ("plain", {"hist_impl": "plain"})):
        fit, secs, counts, plain_calls = counted_run(
            lambda: north_star_cv(lgb, ds, extra))
        hist = fit["valid binary_logloss-mean"]
        rounds = min(fit.best_iter + NS_CV_ES, NS_CV_ROUNDS)
        res[tag] = {"best_iter": fit.best_iter, "best_score": fit.best_score,
                    "s": secs, "rounds_run": rounds,
                    "s_per_round": secs / rounds, "counts": counts,
                    "plain_calls": plain_calls, "logloss_mean": hist}
        log(f"phase 10 cv {tag}: best_iter {fit.best_iter}, best_score "
            f"{fit.best_score!r}, {secs:.2f} s for {rounds} rounds "
            f"({secs / rounds:.3f} s/round), launches {json.dumps(counts)},"
            f" plain calls {plain_calls}")
    k, p = res["kernels"], res["plain"]
    check(k["counts"]["hist_fused_batched_bf16"] > 0,
          f"north-star cv launched no B5: {k['counts']}")
    check(k["plain_calls"] == 0, f"{k['plain_calls']} plain-version calls on "
          "the north-star cv kernel path")
    check(sum(v for key, v in p["counts"].items()
              if key.startswith("hist_")) == 0,
          "the plain north-star cv launched a histogram kernel")
    check(k["best_iter"] == p["best_iter"],
          f"north-star cv best_iter kernel {k['best_iter']} vs plain "
          f"{p['best_iter']}")
    d = np.abs(np.asarray(k["logloss_mean"]) - np.asarray(p["logloss_mean"]))
    check(len(k["logloss_mean"]) == len(p["logloss_mean"])
          and bool((d <= NS_CV_TOL).all()),
          f"north-star cv per-round logloss apart by {d.max():.2e}")
    res["max_logloss_diff"] = float(d.max())

    # dyadic labels (exactly half ones: init score 0, gradients +-0.5,
    # hessians 1/4): the five folds' round-1 predictions, held-out rows
    # included, are the same bits on both paths
    order = np.argsort(X @ np.random.default_rng(SEED + 110).normal(
        0, 1, NUM_FEATURES))
    yd = np.zeros(len(X), np.float32)
    yd[order[len(X) // 2:]] = 1.0
    dsd = lgb.Dataset(X, label=yd, params={"max_bin": MAX_BIN})
    preds = {}
    for tag, extra in (("kernels", {}), ("plain", {"hist_impl": "plain"})):
        prog = fused_program(dsd, dict(TRAIN_PARAMS, **extra))
        preds[tag] = prog.step(prog.init(), 1).pred
    check(bits_equal(preds["kernels"], preds["plain"]),
          "dyadic north-star cv: round-1 predictions of kernel and plain "
          "paths differ")
    log("phase 10 dyadic: the five folds' round-1 predictions (every row) "
        "of kernel and plain paths are the same bits")
    res["breakdown"], wave = profile_wave_round(ds)
    out = {t: {f: r[f] for f in ("best_iter", "best_score", "s",
                                 "rounds_run", "s_per_round", "counts")}
           for t, r in res.items() if t in ("kernels", "plain")}
    out["max_logloss_diff"] = res["max_logloss_diff"]
    log(f"phase 10: {json.dumps(out)}")
    return res, wave


def fused_program(ds, params):
    """The fused-CV program ``cv()`` runs for ``params`` on ``ds`` (the
    same folds: stratified, shuffled, seed SEED)."""
    from lightgbm_tpu_torch.config import parse_params
    from lightgbm_tpu_torch.engine import _make_folds
    from lightgbm_tpu_torch.models.fused import FusedCVProgram

    y = ds.get_label()
    masks = np.zeros((NS_CV_FOLDS, len(y)), bool)
    for i, (tr, _) in enumerate(_make_folds(len(y), NS_CV_FOLDS, y, True,
                                            True, SEED)):
        masks[i, tr] = True
    return FusedCVProgram(ds, [parse_params(params)], masks, NS_CV_ROUNDS,
                          NS_CV_ES, SEED)


def profile_wave_round(ds):
    """One profiled round of north-star cv (E = 5 folds, wave regime)
    after a warm one: device time of B5, B6 and the plain ops, the host's
    share; returns it with the inputs of the round's widest B5 call."""
    from torch.profiler import ProfilerActivity, profile

    import lightgbm_tpu_torch.models.tree as T

    prog = fused_program(ds, TRAIN_PARAMS)
    carry = prog.step(prog.init(), 1)
    torch.cuda.synchronize()
    rec = {}
    orig = T.compute_histograms_batched

    def spy(bins, stats, seg, k, *a, **kw):
        if k > rec.get("k", 0):
            rec.update(k=k, args=(bins, stats.clone(), seg.clone(), k))
        return orig(bins, stats, seg, k, *a, **kw)

    T.compute_histograms_batched = spy
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            carry = prog.step(carry, 2)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        T.compute_histograms_batched = orig
    fam = {"b5:: kernels (B5: gather, items, reduce)": 0.0,
           "rowpart:: kernels (B5's partition)": 0.0,
           "b6:: kernels (B6)": 0.0, "plain PyTorch ops": 0.0}
    top = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        if us <= 0:
            continue
        top.append((us, e.key, e.count))
        key = next((k for k in fam if k.split()[0] in e.key),
                   "plain PyTorch ops")
        fam[key] += us / 1e3
    dev_ms = sum(fam.values())
    top.sort(reverse=True)
    out = {"elements": prog.batch, "num_leaves": NUM_LEAVES,
           "wave_width": prog.wave_width, "wall_ms": wall_ms,
           "device_ms": dev_ms,
           "device_busy_share": dev_ms / wall_ms if dev_ms else
           "not measured (no device time traced)",
           "host_share": 1.0 - dev_ms / wall_ms if dev_ms else
           "not measured",
           "device_ms_by_family": fam,
           "top_device_ops": [{"name": k[:80], "ms": us / 1e3, "calls": c}
                              for us, k, c in top[:10]]}
    log(f"phase 10 breakdown (profiled north-star cv round): "
        f"{json.dumps(out)}")
    return out, rec["args"]


def phase_b5_times(wave):
    """Device ms per launch of B5 at the widest wave of a north-star cv
    round (E = 5 folds, K = 42), its plain version's, its bound and one
    ``index_add_`` over the flat (element, segment, feature, bin) cells."""
    from lightgbm_tpu_torch.ops import histogram as H

    bins, stats, seg, k = wave
    n, f = bins.shape
    e, s = stats.shape[0], stats.shape[2]
    dev = bins.device
    valid = (seg >= 0) & (seg < k)
    direct_rows = int(valid.sum())
    # bins read once, each element's stats and segments once, [E, K, F, B,
    # S] written; one add per (direct row, feature, statistic)
    bound = hist_bound_ms(n * f + e * n * (4 * s + 4)
                          + 4 * e * k * f * 256 * s, direct_rows * f * s)
    el, rows = torch.nonzero(valid, as_tuple=True)
    flat = (((el * k + seg[el, rows].to(torch.int64)) * f)[:, None]
            + torch.arange(f, device=dev)) * 256 \
        + bins[rows].to(torch.int64)
    flat = flat.reshape(-1)
    vals = stats[el, rows].repeat_interleave(f, dim=0)
    out = torch.zeros(e * k * f * 256, s, dtype=torch.float32, device=dev)
    lib_ms = time_ms(lambda: out.index_add_(0, flat, vals), runs=11, inner=3)
    del flat, vals, out, el, rows
    res = {}
    for mode in HIST_MODES:
        res[f"hist_fused_batched_{mode}"] = {
            "shape": f"n={n} F={f} B=256 E={e} K={k} S={s} direct rows "
                     f"{direct_rows}",
            "ms": time_ms(lambda: H.hist_fused_batched(bins, stats, seg, k,
                                                       256, mode),
                          runs=11, inner=3),
            "plain_ms": time_ms(lambda: H.hist_fused_batched_plain(
                bins, stats, seg, k, 256, mode), runs=3, inner=1),
            "bound_ms": bound[0], "bound_by": bound[1],
            "library_ms": lib_ms}
    for name, r in res.items():
        log(f"phase 10 times {name}: {json.dumps(r)}")
    return res


# ---------------------------------------------------------------------------
# phase 11: multiclass at Covertype's shape
# ---------------------------------------------------------------------------
def multi_logloss(booster, Xv, yv, dev):
    from lightgbm_tpu_torch.metrics import get_metric

    p = torch.from_numpy(booster.predict(Xv)).to(dev)
    y = torch.from_numpy(yv).to(dev)
    return float(get_metric("multi_logloss").fn(p, y, torch.ones_like(y)))


def phase_multiclass(dev, X, y, workdir):
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.serving import ModelBank

    Xv, yv = covertype_like(COV_VALID_ROWS, SEED + 121)
    t0 = time.perf_counter()
    ds = lgb.Dataset(X, label=y, params={"max_bin": MAX_BIN})
    ds.construct()
    t_bin = time.perf_counter() - t0
    runs = {}
    for tag, extra in (("kernels", {}), ("plain", {"hist_impl": "plain"})):
        b, secs, counts, plain_calls = counted_run(
            lambda: lgb.train(dict(COV_PARAMS, **extra), ds, COV_ROUNDS))
        check(b.num_trees() == COV_ROUNDS
              and b.num_model_per_iteration() == COV_CLASSES,
              f"multiclass {tag}: {b.num_trees()} rounds")
        runs[tag] = {"booster": b, "s": secs, "counts": counts,
                     "plain_calls": plain_calls,
                     "multi_logloss": multi_logloss(b, Xv, yv, dev)}
        log(f"phase 11 {tag}: {COV_ROUNDS} rounds of {COV_CLASSES} trees in "
            f"{secs:.2f} s ({secs / COV_ROUNDS:.3f} s/round), held-out "
            f"multi_logloss {runs[tag]['multi_logloss']:.6f}, launches "
            f"{json.dumps(counts)}, plain calls {plain_calls}")
    k, p = runs["kernels"], runs["plain"]
    check(k["counts"]["hist_fused_batched_bf16"] > 0
          and k["counts"]["hist_segstats_bf16"] > 0,
          f"multiclass kernel path launches {k['counts']}")
    check(k["plain_calls"] == 0, f"{k['plain_calls']} plain-version calls on "
          "the multiclass kernel path")
    d_ll = k["multi_logloss"] - p["multi_logloss"]
    check(np.isfinite(k["multi_logloss"]) and abs(d_ll) <= COV_TOL,
          f"multiclass held-out multi_logloss kernel - plain {d_ll:.2e}")

    # dyadic tier: 8 classes at a zero init score, so every round-1
    # probability is 1/8, every gradient 1/8 or -7/8 and every hessian 7/32;
    # the kernel path's round-1 trees equal the plain path's, at bf16 and f32
    dy = dict(COV_PARAMS, num_class=8, boost_from_average=False)
    dyadic, f32_counts = {}, None
    for mode in HIST_MODES:
        pm = dict(dy, hist_dtype=mode)
        bk, _, counts, _ = counted_run(lambda: lgb.train(pm, ds, 1))
        bp = lgb.train(dict(pm, hist_impl="plain"), ds, 1)
        a, b = tree_arrays(bk, 0), tree_arrays(bp, 0)
        check(all(np.array_equal(a[key], b[key]) for key in a),
              f"dyadic multiclass {mode}: round-1 trees of kernel and plain "
              "paths differ")
        dyadic[mode] = a["num_leaves"].tolist()
        if mode == "f32":
            f32_counts = counts
    log(f"phase 11 dyadic: round-1 trees of kernel and plain paths equal "
        f"(leaves per class {json.dumps(dyadic)})")

    # the model as text and as .npz, reloaded, and served through ModelBank
    booster = k["booster"]
    direct = booster.predict(X)
    check(direct.shape == (len(X), COV_CLASSES), f"predict {direct.shape}")
    errs = {}
    for ext in ("txt", "npz"):
        path = os.path.join(workdir, f"covertype_multiclass.{ext}")
        booster.save_model(path)
        again = lgb.Booster(model_file=path)
        errs[ext] = float(np.abs(again.predict(X) - direct).max())
        check(errs[ext] <= 1e-6, f"reloaded .{ext} model vs Booster.predict: "
              f"{errs[ext]:.3e}")
    reset_counters()
    bank = ModelBank(max_bucket=MAX_BUCKET, warm_on_deploy=True,
                     canary_rows=64, forest_precision="f32")
    rep = bank.deploy("covertype", path)
    check(rep["ok"], f"deploy of the multiclass model failed: {rep}")
    served = bank.runtime("covertype").predict(X)
    launches = read_counters()["predict_forest"]
    err_serve = float(np.abs(served - direct).max())
    check(launches > 0, "serving the multiclass model launched no kernel")
    check(served.shape == direct.shape and err_serve <= 1e-5,
          f"served {served.shape} vs Booster.predict: {err_serve:.3e}")
    log(f"phase 11 serve: {len(X)} rows x {COV_CLASSES} classes through "
        f"ModelBank, max abs diff {err_serve:.3e} vs Booster.predict, "
        f"{launches} predict launches; reloaded models {json.dumps(errs)}")
    out = {"rows": len(X), "features": X.shape[1], "classes": COV_CLASSES,
           "rounds": COV_ROUNDS, "params": COV_PARAMS, "binning_s": t_bin,
           "s_per_round": {t: r["s"] / COV_ROUNDS for t, r in runs.items()},
           "multi_logloss": {t: r["multi_logloss"] for t, r in runs.items()},
           "multi_logloss_kernel_minus_plain": d_ll,
           "launches": k["counts"], "dyadic_f32_launches": f32_counts,
           "dyadic_round1_leaves": dyadic, "reload_max_abs_diff": errs,
           "serve_max_abs_diff": err_serve,
           "serve_predict_launches": launches}
    log(f"phase 11: {json.dumps(out)}")
    return out, ds


# ---------------------------------------------------------------------------
# phase 12: quantized-histogram training (B1's int8 mode)
# ---------------------------------------------------------------------------
def int8_case(name, bins, stats, seg, k, num_bins):
    """B1 int8 against its plain version (bit for bit: the sums are exact
    integers), two launches bit-equal, and within the reference's
    statistical bound of the float64 sums of the unquantized statistics:
    ``scale * 4 * sqrt(rows in the cell + 9)`` per cell."""
    from lightgbm_tpu_torch.ops import histogram as H

    what = f"hist_fused int8 {name}"
    got = H.hist_fused(bins, stats, seg, k, num_bins, "int8")
    again = H.hist_fused(bins, stats, seg, k, num_bins, "int8")
    plain = H.hist_fused_plain(bins, stats, seg, k, num_bins, "int8")
    torch.cuda.synchronize()
    check(torch.equal(got, again), f"{what}: two launches differ")
    check(bits_equal(got, plain), f"{what}: kernel and plain version differ "
          f"(max {float((got - plain).abs().max()):.3e})")
    ref, _ = f64_hists(bins, stats, seg, k, num_bins, "f32")
    ones = torch.ones((bins.shape[0], 1), dtype=torch.float32,
                      device=bins.device)
    rows, _ = f64_hists(bins, ones, seg, k, num_bins, "f32")
    scale = H.quantize_int8(stats)[1].to(torch.float64)
    tol = scale * 4.0 * torch.sqrt(rows + 9.0)
    err = (got.to(torch.float64) - ref).abs()
    check(bool(torch.isfinite(got).all()) and bool((err <= tol).all()),
          f"{what}: a cell is outside the quantization bound (max "
          f"err/bound {float((err / tol).max()):.3f})")
    return float((err / tol).max())


def phase_int8_kernel(dev, bins, root_stats, wave):
    """(a) B1 int8 against its plain version at the north-star root, at a
    recorded real wave and at awkward shapes; the row limit."""
    from lightgbm_tpu_torch.kernels.histogram import HIST_FUSED_LAUNCHES
    from lightgbm_tpu_torch.ops import histogram as H

    rng = np.random.default_rng(SEED + 130)
    n = bins.shape[0]
    seg_w, _ = H.route_wave(wave[0], *wave[2:8])
    w = int(wave[4].shape[0])
    ratios = {
        "north-star root": int8_case(
            "north-star root", bins, root_stats,
            torch.zeros(n, dtype=torch.int32, device=dev), 1, 256),
        f"north-star wave (K={w})": int8_case(
            f"north-star wave (K={w})", bins, root_stats,
            seg_w.to(torch.int32), w, 256)}
    for name, (rows, f, nb, k, lo) in {
            "ragged, ids in [-3, 9)": (300_001, 28, 256, 7, -3),
            "300 features, 2 bins": (20_011, 300, 2, 3, 0)}.items():
        b = torch.from_numpy(rng.integers(0, nb, (rows, f)).astype(
            np.uint8)).to(dev)
        sg = torch.from_numpy(rng.integers(lo, k + 2, rows).astype(
            np.int32)).to(dev)
        ratios[name] = int8_case(name, b, stats_for(rng, rows, dev), sg, k,
                                 nb)
    # the redesign's edges: a feature whose rows all sit in one bin (the
    # warp aggregation's worst case for a plain scatter), empty segments, a
    # segment holding every row, 42 segments with 70 % of the rows outside,
    # a row count that no work item size divides
    one_bin = bins.clone()
    one_bin[:, 0] = 7
    wave_k = torch.where(torch.from_numpy(rng.random(n) < 0.7).to(dev),
                         w + 5, seg_w.to(torch.int32).clamp(min=0) % w)
    sparse = torch.from_numpy(rng.choice(np.array([0, 4, 8, -1, 11],
                                                  np.int32), n)).to(dev)
    for name, (b, sg, k) in {
            "one bin, root": (one_bin, torch.zeros(n, dtype=torch.int32,
                                                   device=dev), 1),
            "one bin, 42 segments": (one_bin, seg_w.to(torch.int32), w),
            "empty segments": (bins, sparse, 9),
            "one segment holds every row": (
                bins, torch.ones(n, dtype=torch.int32, device=dev), 3),
            "K=42, 70 % outside": (bins, wave_k.to(torch.int32), w)}.items():
        ratios[name] = int8_case(name, b, root_stats, sg, k, 256)
    del one_bin
    odd = 999_983                       # prime: no item size divides it
    ratios["n=999,983, root"] = int8_case(
        "n=999,983, root", bins[:odd], root_stats[:odd],
        torch.zeros(odd, dtype=torch.int32, device=dev), 1, 256)
    ratios["n=999,983, 2 segments"] = int8_case(
        "n=999,983, 2 segments", bins[:odd], root_stats[:odd],
        (seg_w[:odd] >= 0).to(torch.int32), 2, 256)
    # the row limit: refused before any launch
    big = H.INT8_ACC_ROW_LIMIT + 1
    before = HIST_FUSED_LAUNCHES["int8"].count
    try:
        H.hist_fused(torch.zeros((big, 1), dtype=torch.uint8, device=dev),
                     torch.zeros((big, 1), device=dev),
                     torch.zeros(big, dtype=torch.int32, device=dev), 1, 2,
                     "int8")
        refused = False
    except ValueError:
        refused = True
    check(refused and HIST_FUSED_LAUNCHES["int8"].count == before,
          f"{big:,} rows in int8 mode were not refused before launch")
    log(f"phase 12a: B1 int8 == plain version bit for bit, two launches "
        f"bit-equal, within the quantization bound in {len(ratios)} cases "
        f"(max err/bound "
        f"{json.dumps(ratios)}); {big:,} rows refused before launch")
    return ratios


def trees_identical(a, b, n_trees):
    return all(all(np.array_equal(x[key], y[key]) for key in x)
               for x, y in ((tree_arrays(a, i), tree_arrays(b, i))
                            for i in range(n_trees)))


def phase_int8_train(dev, X, y, auc_bf16):
    """(b) north-star training at ``hist_dtype="int8"`` through the kernels
    and the plain versions; int8 and bf16 rounds timed in turns; (c) the
    strict Booster at int8."""
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.utils.datasets import make_higgs_like

    Xv, yv = make_higgs_like(VALID_ROWS, NUM_FEATURES, seed=9)
    ds = lgb.Dataset(X, label=y, params={"max_bin": MAX_BIN})
    ds.construct()
    params = dict(TRAIN_PARAMS, hist_dtype="int8")
    runs = {}
    for tag, extra in (("kernels", {}), ("plain", {"hist_impl": "plain"})):
        b, secs, counts, plain_calls = counted_run(
            lambda: lgb.train(dict(params, **extra), ds, TRAIN_ROUNDS))
        runs[tag] = {"booster": b, "s": secs, "counts": counts,
                     "plain_calls": plain_calls, "auc": auc(b, Xv, yv, dev)}
        log(f"phase 12b int8 {tag}: {TRAIN_ROUNDS} rounds in {secs:.2f} s, "
            f"AUC {runs[tag]['auc']:.6f}, launches {json.dumps(counts)}, "
            f"plain calls {plain_calls}")
    k, p = runs["kernels"], runs["plain"]
    c = k["counts"]
    check(c["hist_fused_int8"] > TRAIN_ROUNDS,
          f"int8 training launched B1 int8 {c['hist_fused_int8']} times")
    check(c["hist_partition_f32"] + c["hist_partition_bf16"] == 0
          and c["hist_fused_f32"] + c["hist_fused_bf16"] == 0,
          f"int8 training took another histogram kernel: {c}")
    check(k["plain_calls"] == 0, f"{k['plain_calls']} plain-version calls on "
          "the int8 kernel path")
    check(sum(v for key, v in p["counts"].items()
              if key.startswith("hist_")) == 0,
          "int8 hist_impl='plain' launched a histogram kernel")
    same = trees_identical(k["booster"], p["booster"], TRAIN_ROUNDS)
    pred_k, pred_p = k["booster"].predict(Xv), p["booster"].predict(Xv)
    check(same and np.array_equal(pred_k, pred_p),
          "int8 kernel and plain paths grew other trees or predictions")
    gap = k["auc"] - auc_bf16
    check(0.5 < k["auc"] < 1.0 and gap >= -0.01,
          f"int8 AUC {k['auc']} more than 0.01 below bf16's {auc_bf16}")
    # int8 and bf16 rounds in turns (int8 bf16, bf16 int8)
    timed = {"int8": [], "bf16": []}
    for i in range(2):
        pair = (("int8", params), ("bf16", TRAIN_PARAMS))
        for tag, prm in (pair if i % 2 == 0 else pair[::-1]):
            timed[tag].append(train_run(lgb, ds, prm, TRAIN_ROUNDS)[1]
                              / TRAIN_ROUNDS)
    log(f"phase 12b timing: s/round in turns {json.dumps(timed)}")
    breakdown = profile_rounds(lgb, ds, params, tag="phase 12b int8")

    sp = dict(params, grow_policy="leafwise")
    strict = {}
    for tag, extra in (("kernels", {}), ("plain", {"hist_impl": "plain"})):
        b, secs, counts, plain_calls = counted_run(
            lambda: lgb.train(dict(sp, **extra), ds, STRICT_ROUNDS))
        strict[tag] = {"booster": b, "s": secs, "counts": counts,
                       "plain_calls": plain_calls}
        log(f"phase 12c strict int8 {tag}: {STRICT_ROUNDS} rounds in "
            f"{secs:.2f} s, launches {json.dumps(counts)}, plain calls "
            f"{plain_calls}")
    sc = strict["kernels"]["counts"]
    check(sc["hist_fused_int8"] > 0 and sc["split_iter"] > 0
          and strict["kernels"]["plain_calls"] == 0,
          f"strict int8 kernel path launches {sc}")
    check(trees_identical(strict["kernels"]["booster"],
                          strict["plain"]["booster"], STRICT_ROUNDS),
          "strict int8 kernel and plain trees differ")
    out = {"rounds": TRAIN_ROUNDS,
           "s_per_round": {t: r["s"] / TRAIN_ROUNDS for t, r in runs.items()},
           "s_per_round_in_turns": timed,
           "s_per_round_median": {t: float(np.median(v))
                                  for t, v in timed.items()},
           "auc": {t: r["auc"] for t, r in runs.items()},
           "auc_bf16_phase6": auc_bf16, "auc_int8_minus_bf16": gap,
           "launches": c, "trees_kernel_equal_plain": same,
           "round_breakdown": breakdown,
           "strict": {"rounds": STRICT_ROUNDS, "launches": sc,
                      "s_per_round": {t: r["s"] / STRICT_ROUNDS
                                      for t, r in strict.items()}}}
    log(f"phase 12b/c: {json.dumps(out)}")
    return out


def phase_int8_cv(ds, f32_cv):
    """(d) ``cv()`` at ``hist_dtype="int8"`` on the diamonds split (B6 at
    f32 and B3): the same ``best_iter`` and ``best_score`` as phase 8b's f32
    ``cv()``."""
    import lightgbm_tpu_torch as lgb

    fit, secs, counts, plain_calls = counted_run(
        lambda: lgb.cv(dict(CV_PARAMS, hist_dtype="int8"), ds,
                       num_boost_round=CV_ROUNDS, nfold=CV_FOLDS,
                       metrics="rmse", early_stopping_rounds=CV_ES,
                       stratified=False, seed=SWEEP_SEED))
    check(counts["split_iter"] > 0 and counts["hist_segstats_f32"] > 0
          and counts["hist_fused_int8"] == 0 and plain_calls == 0,
          f"int8 cv launches {counts}, plain calls {plain_calls}")
    check(fit.best_iter == f32_cv["best_iter"]
          and fit.best_score == f32_cv["best_score"],
          f"int8 cv best_iter {fit.best_iter} / best_score "
          f"{fit.best_score!r} vs f32 {f32_cv['best_iter']} / "
          f"{f32_cv['best_score']!r}")
    out = {"best_iter": fit.best_iter, "best_score": fit.best_score,
           "s": secs, "launches": counts}
    log(f"phase 12d cv int8: {json.dumps(out)} (equal to phase 8b's f32)")
    return out


def write_csv(path, X, y):
    with open(path, "w") as f:
        f.write(",".join(["label"] + [f"f{j}" for j in range(X.shape[1])])
                + "\n")
        f.writelines(",".join([f"{yv:.9g}"] + [f"{v:.9g}" for v in row])
                     + "\n" for row, yv in zip(X, y))


def phase_int8_cli(workdir):
    """(e) ``task=train`` (int8) on a 200,000-row CSV, ``task=predict``
    against ``Booster(model_file=...).predict``, and the model through
    ``pack_booster`` and ``task=serve``."""
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.__main__ import _serve, main as cli
    from lightgbm_tpu_torch.serving import pack_booster
    from lightgbm_tpu_torch.utils.datasets import make_higgs_like

    Xc, yc = make_higgs_like(CLI_ROWS, NUM_FEATURES, seed=13)
    Xt, yt = make_higgs_like(CLI_TEST_ROWS, NUM_FEATURES, seed=14)
    train_csv = os.path.join(workdir, "cli_train.csv")
    test_csv = os.path.join(workdir, "cli_test.csv")
    model = os.path.join(workdir, "cli_int8_model.txt")
    preds = os.path.join(workdir, "cli_int8_preds.txt")
    t0 = time.perf_counter()
    write_csv(train_csv, Xc, yc)
    write_csv(test_csv, Xt, yt)
    t_csv = time.perf_counter() - t0
    argv = ["task=train", f"data={train_csv}", "header=true",
            "label_column=name:label", "objective=binary",
            f"num_trees={TRAIN_ROUNDS}", f"num_leaves={NUM_LEAVES}",
            f"max_bin={MAX_BIN}", "hist_dtype=int8", "verbosity=-1",
            f"output_model={model}"]
    rc, secs, counts, plain_calls = counted_run(lambda: cli(argv))
    check(rc == 0 and counts["hist_fused_int8"] > 0 and plain_calls == 0
          and counts["hist_partition_bf16"] + counts["hist_partition_f32"]
          == 0, f"CLI train rc {rc}, launches {counts}, plain calls "
          f"{plain_calls}")
    t1 = time.perf_counter()
    rc = cli(["task=predict", f"data={test_csv}", "header=true",
              "label_column=name:label", f"input_model={model}",
              f"output_result={preds}"])
    t_pred = time.perf_counter() - t1
    check(rc == 0, f"CLI predict rc {rc}")
    booster = lgb.Booster(model_file=model)
    direct = booster.predict(Xt)
    got = np.loadtxt(preds)
    err_pred = float(np.abs(got - direct).max())
    check(got.shape == direct.shape and err_pred <= 1e-9,
          f"task=predict vs Booster.predict: {err_pred:.3e}")
    npz = os.path.join(workdir, "cli_int8_model.npz")
    pack_booster(booster).save(npz)
    lines = "".join(",".join(f"{v:.9g}" for v in row) + "\n"
                    for row in Xt[:CLI_SERVE_ROWS])
    out, err = io.StringIO(), io.StringIO()
    reset_counters()
    rc = _serve(npz, {"max_batch": "64"}, stdin=io.StringIO(lines),
                stdout=out, stderr=err)
    served = np.array([float(v) for v in out.getvalue().split()])
    launches = read_counters()["predict_forest"]
    err_serve = float(np.abs(served - direct[:CLI_SERVE_ROWS]).max()) \
        if served.shape == (CLI_SERVE_ROWS,) else float("inf")
    check(rc == 0 and launches > 0 and err_serve <= 1e-5,
          f"task=serve rc {rc}, {launches} launches, vs Booster.predict "
          f"{err_serve:.3e}")
    res = {"rows": CLI_ROWS, "test_rows": CLI_TEST_ROWS, "csv_s": t_csv,
           "train_s": secs, "predict_s": t_pred, "launches": counts,
           "predict_max_abs_diff": err_pred,
           "serve_rows": CLI_SERVE_ROWS, "serve_max_abs_diff": err_serve,
           "serve_predict_launches": launches}
    log(f"phase 12e CLI: {json.dumps(res)}")
    return res


def phase_int8_times(bins, root_stats, wave):
    """B1 int8's device ms at the north-star root, the recorded wave and a
    two-segment (strict) call, its plain version's, its bound and one
    ``index_add_`` of the quantized values into flat int32 (segment,
    feature, bin) cells."""
    from lightgbm_tpu_torch.ops import histogram as H

    n, f = bins.shape
    dev = bins.device
    seg_w, _ = H.route_wave(wave[0], *wave[2:8])
    q = H.quantize_int8(root_stats)[0].to(torch.int32)
    res = {}
    for name, seg, k in (
            ("root", torch.zeros(n, dtype=torch.int32, device=dev), 1),
            ("wave", seg_w.to(torch.int32), int(wave[4].shape[0])),
            # the strict grower's call: two segments (here the wave's rows
            # and the rest)
            ("strict2", (seg_w < 0).to(torch.int32), 2)):
        rows = torch.nonzero((seg >= 0) & (seg < k)).squeeze(1)
        # stats (every row: the scale is over all n) and seg read once, the
        # codes of the rows in a segment once, [K, F, B, 3] f32 written; one
        # integer add per (row in a segment, feature, statistic)
        bound = hist_bound_ms(16 * n + int(rows.numel()) * f
                              + k * f * 256 * 12, int(rows.numel()) * f * 3)
        flat = (((seg[rows].to(torch.int64) * f)[:, None]
                 + torch.arange(f, device=dev)) * 256
                + bins[rows].to(torch.int64)).reshape(-1)
        vals = q[rows].repeat_interleave(f, dim=0)
        acc = torch.zeros(k * f * 256, 3, dtype=torch.int32, device=dev)
        lib_ms = time_ms(lambda: acc.index_add_(0, flat, vals), runs=11,
                         inner=3)
        del flat, vals, acc
        res[name] = {
            "shape": f"n={n} F={f} B=256 K={k} S=3 rows in a segment "
                     f"{int(rows.numel())}",
            "ms": time_ms(lambda: H.hist_fused(bins, root_stats, seg, k, 256,
                                               "int8"), runs=11, inner=5),
            "plain_ms": time_ms(lambda: H.hist_fused_plain(
                bins, root_stats, seg, k, 256, "int8"), runs=5, inner=1),
            "bound_ms": bound[0], "bound_by": bound[1], "library_ms": lib_ms}
        log(f"phase 12 times hist_fused_int8 {name}: "
            f"{json.dumps(res[name])}")
    return res


# ---------------------------------------------------------------------------
# phase 13: recovery on the card
# ---------------------------------------------------------------------------
def same_run(a, b) -> bool:
    """Every tree field, the train scores and the bag equal bit for bit."""
    return (len(a.trees) == len(b.trees)
            and trees_identical(a, b, len(a.trees))
            and torch.equal(a._pred_train, b._pred_train)
            and torch.equal(a._bag, b._bag))


def phase_recovery_train(dev, X, y, workdir):
    """(a) Kill and resume at the north star in one process."""
    import shutil
    import signal

    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.serving import PredictorRuntime, pack_booster
    from lightgbm_tpu_torch.training import (list_checkpoints,
                                             load_checkpoint, resume_booster,
                                             save_checkpoint, train_resumable)
    from lightgbm_tpu_torch.utils.datasets import make_higgs_like

    root = os.path.join(workdir, "recovery")
    shutil.rmtree(root, ignore_errors=True)
    full_dir, kill_dir, probe_dir = (os.path.join(root, d) for d in
                                     ("full", "killed", "probe"))
    ds = lgb.Dataset(X, label=y, params={"max_bin": MAX_BIN})
    ds.construct()
    kw = dict(checkpoint_rounds=RECOVERY_EVERY, keep_last=3)

    def kill(booster, i):
        if i == RECOVERY_KILL_AFTER:
            os.kill(os.getpid(), signal.SIGTERM)

    def training():
        full = train_resumable(dict(RECOVERY_PARAMS), ds, RECOVERY_ROUNDS,
                               checkpoint_dir=full_dir, resume=False, **kw)
        killed = train_resumable(dict(RECOVERY_PARAMS), ds, RECOVERY_ROUNDS,
                                 checkpoint_dir=kill_dir, resume=False,
                                 round_callbacks=[kill], **kw)
        again = train_resumable(dict(RECOVERY_PARAMS), ds, RECOVERY_ROUNDS,
                                checkpoint_dir=kill_dir, resume=True, **kw)
        gens = {}
        for path in list_checkpoints(full_dir)[:2]:
            b = resume_booster(path, ds)
            gens[f"generation {b._iter}"] = b
            while b._iter < RECOVERY_ROUNDS:
                b.update()
        return full, killed, again, gens

    (full, killed, again, gens), secs, counts, plain_calls = counted_run(
        training)
    check(full.completed and full.checkpoint_failures == 0,
          f"uninterrupted resumable run: {full}")
    files = list_checkpoints(full_dir)
    iters = [load_checkpoint(q)[1]["iter"] for q in files]
    check(iters == [4, 8, 12], f"generations kept {iters}, expected 4, 8, 12")
    check(killed.preempted and killed.rounds_done == RECOVERY_KILL_AFTER + 1
          and killed.last_checkpoint is not None
          and load_checkpoint(killed.last_checkpoint)[1]["iter"]
          == RECOVERY_KILL_AFTER + 1,
          f"SIGTERM after round index {RECOVERY_KILL_AFTER}: preempted "
          f"{killed.preempted} at {killed.rounds_done} rounds, checkpoint "
          f"{killed.last_checkpoint}")
    check(again.completed and again.resumed_from == killed.last_checkpoint,
          f"resume after SIGTERM: {again}")
    check(counts["hist_fused_bf16"] > 0 and counts["hist_partition_bf16"] > 0
          and plain_calls == 0, f"recovery training launches {counts}, "
          f"plain calls {plain_calls}")
    runs = {"SIGTERM then resume": again.booster, **gens}
    for tag, b in runs.items():
        check(same_run(full.booster, b), f"{tag}: trees, _pred_train or _bag "
              "differ from the uninterrupted run")
    # the checkpoint's size and the two calls' times (the card synchronised
    # around each)
    save_ms, resume_ms = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_checkpoint(full.booster, probe_dir, keep_last=1)
        save_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        resume_booster(files[1], ds)
        torch.cuda.synchronize()
        resume_ms.append((time.perf_counter() - t0) * 1e3)
    # the resumed models served through PredictorRuntime (B4)
    Xs, _ = make_higgs_like(RECOVERY_SERVE_ROWS, NUM_FEATURES, seed=21)
    reset_counters()
    served = {}
    for tag, b in (("uninterrupted", full.booster), *runs.items()):
        rt = PredictorRuntime(pack_booster(b), max_bucket=MAX_BUCKET,
                              device=dev)
        served[tag] = rt.predict(Xs, raw_score=True)
    torch.cuda.synchronize()
    serve_launches = read_counters()["predict_forest"]
    want = served["uninterrupted"]
    check(want.shape == (RECOVERY_SERVE_ROWS,)
          and bool(np.isfinite(want).all()), "served scores not finite")
    for tag, got in served.items():
        check(np.array_equal(got, want), f"{tag}: served predictions differ "
              "from the uninterrupted model's")
    check(serve_launches > 0, "serving the resumed models launched no B4")
    counts["predict_forest"] = serve_launches
    out = {"rows": len(X), "rounds": RECOVERY_ROUNDS,
           "params": RECOVERY_PARAMS, "training_s": secs,
           "generations_kept": iters, "preempted_at": killed.rounds_done,
           "bit_identical": sorted(runs), "launches": counts,
           "checkpoint_bytes": os.path.getsize(files[-1]),
           "save_checkpoint_ms": save_ms, "resume_booster_ms": resume_ms,
           "served_rows": RECOVERY_SERVE_ROWS,
           "serve_predict_launches": serve_launches}
    log(f"phase 13a: {json.dumps(out)}")
    return out


def cli_train_argv(csv, ckpt_dir, model):
    return [sys.executable, "-m", "lightgbm_tpu_torch", "task=train",
            f"data={csv}", "header=true", "label_column=name:label",
            "objective=binary", f"num_trees={RECOVERY_CLI_ROUNDS}",
            f"num_leaves={NUM_LEAVES}", f"max_bin={MAX_BIN}",
            "verbosity=-1", f"checkpoint_dir={ckpt_dir}",
            f"checkpoint_rounds={RECOVERY_CLI_EVERY}",
            f"output_model={model}"]


def wait_process(proc, what, timeout=300):
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        fail(f"{what} ran past {timeout} s")
    return out, err


def phase_recovery_cli(workdir):
    """(b) ``task=train checkpoint_dir=`` in a fresh process: SIGTERM after
    its first checkpoint, a rerun to the end, the model file equal to an
    uninterrupted run's."""
    import shutil
    import signal

    csv = os.path.join(workdir, "cli_train.csv")     # phase 12e's file
    check(os.path.exists(csv), f"{csv} (phase 12e's CSV) is missing")
    root = os.path.join(workdir, "recovery_cli")
    shutil.rmtree(root, ignore_errors=True)
    dirs = {t: os.path.join(root, t) for t in ("killed", "clean")}
    models = {t: os.path.join(root, f"{t}.txt") for t in dirs}
    for d in dirs.values():
        os.makedirs(d)
    t0 = time.perf_counter()
    procs = {t: subprocess.Popen(cli_train_argv(csv, dirs[t], models[t]),
                                 cwd=ROOT, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
             for t in ("killed", "clean")}
    killed, first = procs["killed"], None
    try:
        while first is None and killed.poll() is None:
            names = [n for n in os.listdir(dirs["killed"])
                     if n.startswith("ckpt_") and n.endswith(".lgckpt")]
            if names:
                first = min(names)
            else:
                time.sleep(0.005)
        if first is not None:
            killed.send_signal(signal.SIGTERM)
        out_k, err_k = wait_process(killed, "the preempted CLI run")
        t_killed = time.perf_counter() - t0
        check(first is not None, f"the CLI run ended before its first "
              f"checkpoint (rc {killed.returncode}): {err_k[-2000:]}")
        check(killed.returncode == 0 and "preempted" in out_k,
              f"the CLI run sent SIGTERM exited {killed.returncode} without "
              f"\"preempted\": {out_k[-1000:]} {err_k[-2000:]}")
        check(not os.path.exists(models["killed"]),
              "the preempted run wrote a model file")
        t1 = time.perf_counter()
        procs["rerun"] = subprocess.Popen(
            cli_train_argv(csv, dirs["killed"], models["killed"]), cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        out_r, err_r = wait_process(procs["rerun"], "the resumed CLI run")
        t_rerun = time.perf_counter() - t1
        out_c, err_c = wait_process(procs["clean"],
                                    "the uninterrupted CLI run")
    finally:
        for proc in procs.values():          # stop whatever a failure left
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    check(procs["rerun"].returncode == 0 and "resumed from" in out_r,
          f"the rerun exited {procs['rerun'].returncode}: {out_r[-1000:]} "
          f"{err_r[-2000:]}")
    check(procs["clean"].returncode == 0,
          f"the uninterrupted CLI run exited {procs['clean'].returncode}: "
          f"{err_c[-2000:]}")
    with open(models["killed"], "rb") as f, open(models["clean"], "rb") as g:
        a, b = f.read(), g.read()
    check(a == b, "the resumed CLI model file differs from the uninterrupted "
          "run's")
    preempted_line = [ln for ln in out_k.splitlines() if "preempted" in ln]
    out = {"rows": CLI_ROWS, "rounds": RECOVERY_CLI_ROUNDS,
           "checkpoint_rounds": RECOVERY_CLI_EVERY,
           "first_checkpoint": first, "preempted": preempted_line[-1],
           "killed_run_s": t_killed, "rerun_s": t_rerun,
           "model_bytes": len(a), "model_files_equal": True}
    log(f"phase 13b: {json.dumps(out)}")
    return out


def recovery_grid():
    """The num_leaves 31, learning_rate 0.1 bucket of paramGrid.json's axes
    (12 configs)."""
    from lightgbm_tpu_torch.utils.sweep import expand_grid

    with open(os.path.join(ROOT, "paramGrid.json")) as f:
        rows = json.load(f)["rows"]
    axes = {k: sorted({r[k] for r in rows}) for k in rows[0]
            if k not in ("iteration", "score")}
    return [g for g in expand_grid(**axes)
            if g["num_leaves"] == 31 and g["learning_rate"] == 0.1]


def phase_recovery_sweep(ds, workdir):
    """(c) A sweep stopped at a segment boundary and resumed from its carry
    checkpoint: the ``.RData`` ledger equal to an uninterrupted run's."""
    import hashlib
    import shutil

    from lightgbm_tpu_torch.faults import FaultInjector
    from lightgbm_tpu_torch.sweep import SweepService

    root = os.path.join(workdir, "recovery_sweep")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    grid = recovery_grid()
    check(len(grid) == 12, f"{len(grid)} configs, expected 12")
    ckpt = os.path.join(root, "ck")

    def service(ledger, **kw):
        return SweepService(
            grid, ds, base_params={"objective": "regression", "verbosity": -1,
                                   "cv_segment_rounds":
                                   RECOVERY_SEGMENT_ROUNDS},
            num_boost_round=RECOVERY_SWEEP_ROUNDS, nfold=CV_FOLDS,
            early_stopping_rounds=CV_ES, seed=SWEEP_SEED,
            ledger_path=os.path.join(root, ledger),
            clock=lambda: 0.0, **kw).run()

    inj = FaultInjector()
    inj.arm("sweep_segment", after=2)
    runs = {}
    for tag, fn in (
            ("uninterrupted", lambda: service("clean.RData")),
            ("uninterrupted_checkpointed", lambda: service(
                "clean_ck.RData", checkpoint_dir=os.path.join(root, "ck0"))),
            ("interrupted", lambda: service("paramGrid.RData",
                                            checkpoint_dir=ckpt,
                                            injector=inj)),
            ("resumed", lambda: service("paramGrid.RData",
                                        checkpoint_dir=ckpt))):
        res, secs, counts, plain_calls = counted_run(fn)
        runs[tag] = {"result": res, "s": secs, "counts": counts,
                     "plain_calls": plain_calls}
    clean, cut, res = (runs[t]["result"] for t in ("uninterrupted",
                                                    "interrupted", "resumed"))
    check(clean.completed and not clean.preempted,
          f"uninterrupted sweep: {clean.error}")
    clean_ck = runs["uninterrupted_checkpointed"]["result"]
    check(clean_ck.completed and clean_ck.resumed_units == 0
          and clean_ck.checkpoint_failures == 0,
          f"uninterrupted checkpointed sweep: {clean_ck.error}, resumed "
          f"{clean_ck.resumed_units}, lost writes "
          f"{clean_ck.checkpoint_failures}")
    check(cut.preempted and "sweep_segment" in (cut.error or ""),
          f"the fault at sweep_segment hit 3 did not stop the sweep: "
          f"{cut.error}")
    check(res.completed and res.resumed_units >= 1,
          f"the rerun resumed {res.resumed_units} units")
    # early stopping, not the cap, ended every bucket, and after the fault
    rounds = {t: [b["rounds"] for b in r.stats["buckets"]]
              for t, r in (("uninterrupted", clean), ("resumed", res))}
    fault_round = 3 * RECOVERY_SEGMENT_ROUNDS
    check(all(fault_round < r < RECOVERY_SWEEP_ROUNDS
              for r in rounds["uninterrupted"] + rounds["resumed"]),
          f"13c bucket rounds {rounds}: early stopping did not end every "
          f"bucket between the fault (round {fault_round}) and the cap "
          f"{RECOVERY_SWEEP_ROUNDS}")
    check(not os.path.exists(ckpt)
          and not os.path.exists(os.path.join(root, "ck0")),
          "spent carry checkpoints were kept")

    def digest(path):
        with open(path, "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()

    a, b, c = (digest(os.path.join(root, n)) for n in (
        "paramGrid.RData", "clean.RData", "clean_ck.RData"))
    check(a == b, "the resumed .RData ledger differs from the "
          "uninterrupted run's")
    check(c == b, "the checkpointed .RData ledger differs from the "
          "uninterrupted run's")
    total = collections.Counter()
    for r in runs.values():
        total.update(r["counts"])
        check(r["plain_calls"] == 0, f"{r['plain_calls']} plain-version "
              "calls in the recovery sweep")
    seg_key = "hist_segstats_f32"
    check(total["split_iter"] > 0 and total[seg_key] > 0,
          f"recovery sweep launches {dict(total)}")
    for row in res.ledger.rows:
        check(row["iteration"] >= 1 and np.isfinite(row["score"])
              and row["score"] < 0, f"sweep row {row}")
    out = {"configs": len(grid), "resumed_units": res.resumed_units,
           "bucket_rounds": rounds,
           "checkpoint_failures": res.checkpoint_failures,
           "interrupted_error": cut.error, "ledger_sha256": a,
           "s": {t: r["s"] for t, r in runs.items()},
           "checkpoint_overhead_s": runs["uninterrupted_checkpointed"]["s"]
           - runs["uninterrupted"]["s"],
           "launches": {"split_iter": total["split_iter"],
                        seg_key: total[seg_key]},
           "best": {k: res.ledger.leaderboard()[0][k] for k in (
               "min_data_in_leaf", "feature_fraction", "bagging_fraction",
               "iteration", "score")}}
    log(f"phase 13c: {json.dumps(out)}")
    return out


# ---------------------------------------------------------------------------
# phase 14: examples/bagging_boosting.py's calls, and rf with per-node
# sampling at full width
# ---------------------------------------------------------------------------
def host_syncs(fn):
    """``fn()`` and the call sites of the host syncs it made, found by
    PyTorch's sync debug mode (a warning per synchronising call: a
    device-to-host read, a blocking host-to-device copy; a prototype that,
    by its own warning, does not yet detect every such call)."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    sites = [f"{os.path.basename(w.filename)}:{w.lineno}" for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    return out, sites


def mask_table_syncs(dev):
    """Host syncs of drawing the per-node mask tables at the north star's
    shapes: one tree's (the wave grower's overgrow capacity) and a batch's
    (cv()'s five elements)."""
    from lightgbm_tpu_torch.models.feature_mask import (node_mask_fn,
                                                        node_mask_table)
    from lightgbm_tpu_torch.utils.random import key_tensor, split_on

    mask = torch.ones(NUM_FEATURES, device=dev)
    cap = 2 * 2 * NUM_LEAVES

    def draw():
        key_tensor([(0, 7), (3, 5)], dev)      # the strict grower's keys
        one = node_mask_fn((0, 7), 5 / 28, NUM_FEATURES, mask, False, cap)
        batch = node_mask_table(split_on((0, 7), CV_FOLDS, dev),
                                torch.full((CV_FOLDS,), 0.5, device=dev),
                                mask.expand(CV_FOLDS, -1), cap)
        return one(torch.arange(cap, device=dev)), batch
    (one, batch), sites = host_syncs(draw)
    check(one.shape == (cap, NUM_FEATURES) and bool((one.sum(1) == 5).all())
          and batch.shape == (CV_FOLDS, cap, NUM_FEATURES),
          "14b: mask tables of the wrong shape or fraction")
    return sites


def add_launches(total, counts):
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def rmse(pred, truth):
    return float(np.sqrt(np.mean((np.asarray(pred, np.float64) - truth)
                                 ** 2)))


def phase_bagging_boosting(dev, launches):
    """14a: the script's calls at its own sizes, on the card."""
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.serving import PredictorRuntime, pack_booster
    from lightgbm_tpu_torch.sklearn import LGBMRandomForestRegressor
    from lightgbm_tpu_torch.utils.datasets import make_boosting_curve

    X, y = make_boosting_curve(BB_ROWS, BB_SEED)
    grid = np.linspace(-4, 4, 400).reshape(-1, 1)
    truth = np.abs(grid[:, 0]) + np.cos(grid[:, 0])
    ds = lgb.Dataset(X, label=y)
    ds.construct()
    check(ds.device.type == "cuda" and ds.X_binned.shape[1] == 1,
          f"the curve's Dataset: {ds.device}, {tuple(ds.X_binned.shape)}")
    out = {"cv": {}, "train": {}, "forest": {}}
    # boosting side: cv (fused strict, E = 5: B6 + B3), train (B1 + B3)
    hist = {}
    for tag, extra in (("kernels", {}), ("plain", {"hist_impl": "plain"})):
        fit, secs, counts, plain = counted_run(lambda: lgb.cv(
            dict(BB_PARAMS, **extra), ds, num_boost_round=BB_CV_ROUNDS,
            early_stopping_rounds=BB_CV_ES, nfold=BB_FOLDS,
            stratified=False))
        hist[tag] = list(fit["valid rmse-mean"])
        out["cv"][tag] = {"best_iter": fit.best_iter,
                          "best_score": fit.best_score, "s": secs,
                          "counts": counts, "plain_calls": plain}
        log(f"phase 14a cv {tag}: best_iter {fit.best_iter}, best_score "
            f"{fit.best_score!r}, {secs:.2f} s, launches "
            f"{json.dumps(counts)}, plain calls {plain}")
    k, p = out["cv"]["kernels"], out["cv"]["plain"]
    check(k["counts"]["split_iter"] > 0
          and k["counts"]["hist_segstats_f32"] > 0 and k["plain_calls"] == 0,
          f"14a cv kernel path: launches {k['counts']}, plain calls "
          f"{k['plain_calls']}")
    check(len(hist["kernels"]) == len(hist["plain"]) and max(
        rel_diff(a, b) for a, b in zip(hist["kernels"], hist["plain"]))
          <= 1e-5, "14a cv fold-mean RMSE kernel vs plain per round")
    check(k["best_iter"] == p["best_iter"], f"14a cv best_iter kernel "
          f"{k['best_iter']} vs plain {p['best_iter']}")
    rel = abs(k["best_score"] - p["best_score"]) / abs(p["best_score"])
    check(rel <= 1e-5, f"14a cv best_score kernel vs plain: rel {rel:.2e}")
    out["cv"]["best_score_rel_diff"] = rel
    add_launches(launches, k["counts"])
    # the plain run trains the first BB_PLAIN_ROUNDS trees of the staged
    # fits
    staged, boosters = {}, {}
    for tag, extra, rounds in (("kernels", {}, BB_TRAIN_ROUNDS),
                               ("plain", {"hist_impl": "plain"},
                                BB_PLAIN_ROUNDS)):
        b, secs, counts, plain = counted_run(lambda: lgb.train(
            dict(BB_PARAMS, **extra), ds, num_boost_round=rounds))
        staged[tag] = {s: b.predict(grid, ntree_limit=s) for s in BB_STAGES
                       if s <= rounds}
        boosters[tag] = b
        out["train"][tag] = {"rounds": rounds, "s": secs, "counts": counts,
                             "plain_calls": plain}
        log(f"phase 14a train {tag}: {rounds} rounds in {secs:.2f} s, "
            f"launches {json.dumps(counts)}, plain calls {plain}")
    kt = out["train"]["kernels"]
    check(kt["counts"]["hist_fused_f32"] > 0 and kt["counts"]["split_iter"]
          > 0 and kt["plain_calls"] == 0, f"14a train kernel path: launches "
          f"{kt['counts']}, plain calls {kt['plain_calls']}")
    add_launches(launches, kt["counts"])
    staged_diff = max(float(np.abs(staged["kernels"][s]
                                   - staged["plain"][s]).max())
                      for s in staged["plain"])
    check(staged_diff <= 1e-5, f"14a staged predictions kernel vs plain "
          f"{staged_diff:.2e}")
    errs = [rmse(staged["kernels"][s], truth) for s in BB_STAGES]
    check(all(a > b for a, b in zip(errs, errs[1:])),
          f"14a staged RMSEs do not fall with k: {errs}")
    check(len(set(errs)) == len(errs), f"14a staged RMSEs repeat: {errs}")
    out["staged_rmse"] = dict(zip(map(str, BB_STAGES), errs))
    out["staged_kernel_minus_plain"] = staged_diff
    # the staged model served: B4 at F = 1, one window per stage
    rt = PredictorRuntime(pack_booster(boosters["kernels"]), max_bucket=512)
    served, secs, counts, _ = counted_run(lambda: {
        s: rt.predict(grid, num_iteration=s) for s in BB_STAGES})
    check(counts["predict_forest"] >= len(BB_STAGES),
          f"14a staged serving launches {counts}")
    add_launches(launches, counts)
    serve_diff = max(float(np.abs(served[s] - staged["kernels"][s]).max())
                     for s in BB_STAGES)
    check(serve_diff <= 1e-5, f"14a served staged predictions vs "
          f"Booster.predict {serve_diff:.2e}")
    out["served_staged_max_diff"] = serve_diff
    # bagging side: the wrapper's rf (strict at 1,000 rows: B1 + B3; one
    # column, so max_features=1 keeps it), each forest served (B4)
    ferr = {}
    for n_trees in BB_FORESTS:
        def fit_and_serve():
            rf = LGBMRandomForestRegressor(
                n_estimators=n_trees, max_leaf_nodes=20, max_features=1,
                random_state=345, min_samples_leaf=3)
            rf.fit(X, y)
            frt = PredictorRuntime(pack_booster(rf.booster_), max_bucket=512)
            return rf.predict(grid), frt.predict(grid)
        (pred, srv), secs, counts, plain = counted_run(fit_and_serve)
        check(counts["predict_forest"] > 0 and counts["split_iter"] > 0
              and plain == 0, f"14a forest of {n_trees}: launches {counts}, "
              f"plain calls {plain}")
        add_launches(launches, counts)
        d = float(np.abs(pred - srv).max())
        check(d <= 1e-5, f"14a forest of {n_trees}: served vs predict {d}")
        ferr[n_trees] = rmse(pred, truth)
        out["forest"][str(n_trees)] = {"s": secs, "rmse": ferr[n_trees],
                                       "served_max_diff": d}
        log(f"phase 14a forest of {n_trees}: {secs:.2f} s, RMSE vs truth "
            f"{ferr[n_trees]:.4f}, launches {json.dumps(counts)}")
    check(ferr[BB_FORESTS[-1]] < ferr[BB_FORESTS[0]],
          f"14a forest RMSE does not fall from 1 to 100 trees: {ferr}")
    # every kernel of the path at F = 1 against its plain version, once
    rng = np.random.default_rng(SEED + 141)
    bins = ds.X_binned
    n, nb = bins.shape[0], ds.num_bins
    st = stats_for(rng, n, dev)
    seg = torch.from_numpy(rng.integers(0, 3, n).astype(np.int32)).to(dev)
    f1 = {"hist_fused": fused_case("F=1 two segments", bins, st, seg, 2, nb),
          "hist_segstats": b6_case("F=1 cv folds", bins, torch.from_numpy(
              rng.normal(size=(n, 3 * BB_FOLDS)).astype(np.float32)).to(dev),
              nb)}
    for e in (1, BB_FOLDS):
        b3_case(rng, dev, e, 1, nb, 61, "random", 30, in_place=True)
    f1["split_iter"] = 0.0
    gbins = torch.from_numpy(rt.packed.bin_mapper.transform(grid)).to(dev)
    f1["predict_forest"] = max(
        compare(rt._soa[0], gbins, float(rt.packed.shrink),
                float(rt.packed.init_score[0]), s, rt.packed.depth_cap, 0,
                f"14a B4 F=1 first {s} trees") for s in BB_STAGES)
    out["f1_max_abs_err"] = f1
    log(f"phase 14a F=1 kernels vs plain: {json.dumps(f1)}")
    tpu = {str(a): b for a, b in BB_TPU_STAGED_RMSE.items()}
    log(f"phase 14a: best_iter {k['best_iter']}, cv {k['s']:.2f} s (plain "
        f"{p['s']:.2f}), train {kt['s']:.2f} s; staged RMSE "
        f"{json.dumps(out['staged_rmse'])} (EXAMPLES_r05.json, TPU, JAX, a "
        f"quality reference only: {json.dumps(tpu)}); forest RMSE "
        f"{json.dumps({str(a): b for a, b in ferr.items()})}")
    return out


def phase_rf_north_star(dev, X, y, launches):
    """14b: an rf forest with per-node sampling at the north star."""
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.serving import PredictorRuntime, pack_booster
    from lightgbm_tpu_torch.utils.datasets import make_higgs_like

    Xv, yv = make_higgs_like(VALID_ROWS, NUM_FEATURES, seed=9)
    ds = lgb.Dataset(X, label=y, params={"max_bin": MAX_BIN})
    ds.construct()
    runs = {"kernels": [], "plain": []}
    boosters = {}
    for tag in ("kernels", "plain", "plain", "kernels"):       # in turns
        extra = {} if tag == "kernels" else {"hist_impl": "plain"}
        b, secs, counts, plain = counted_run(
            lambda: lgb.train(dict(RF_PARAMS, **extra), ds, RF_TREES))
        runs[tag].append({"s_per_round": secs / RF_TREES, "counts": counts,
                          "plain_calls": plain})
        boosters.setdefault(tag, b)
        log(f"phase 14b rf {tag}: {RF_TREES} trees in {secs:.2f} s, "
            f"launches {json.dumps(counts)}, plain calls {plain}")
    k = runs["kernels"][0]
    check(k["counts"]["hist_fused_bf16"] > 0
          and k["counts"]["hist_partition_bf16"] > 0
          and k["plain_calls"] == 0, f"14b kernel path: launches "
          f"{k['counts']}, plain calls {k['plain_calls']}")
    add_launches(launches, k["counts"])
    aucs = {t: auc(b, Xv, yv, dev) for t, b in boosters.items()}
    d_auc = aucs["kernels"] - aucs["plain"]
    check(abs(d_auc) <= AUC_TOL, f"14b AUC kernel - plain {d_auc:.2e}")
    # the dyadic tier: the first tree of the kernel path equals the plain
    # path's
    w = np.random.default_rng(SEED + 142).normal(0, 1, NUM_FEATURES)
    order = np.argsort(X @ w + 0.6 * np.sin(X[:, 0] * 2))
    yd = np.zeros(len(X), np.float32)
    yd[order[len(X) // 2:]] = 1.0
    dsd = lgb.Dataset(X, label=yd, params={"max_bin": MAX_BIN})
    pd_ = dict(RF_PARAMS, objective="regression", hist_dtype="f32")
    bk = lgb.train(pd_, dsd, 1)
    bp = lgb.train(dict(pd_, hist_impl="plain"), dsd, 1)
    a, b = tree_arrays(bk, 0), tree_arrays(bp, 0)
    check(all(np.array_equal(a[key], b[key]) for key in a),
          "14b dyadic first rf trees of kernel and plain paths differ")
    del dsd
    # the mask table adds no host sync: its draws alone make none; a
    # round's syncs with bynode on and off are reported beside its waves
    # (one B2 launch each, a host read each), which differ with the trees
    sites = mask_table_syncs(dev)
    check(not sites, f"14b: drawing the mask tables made {len(sites)} host "
          f"syncs, at {sites}")
    syncs = {"mask_tables": len(sites)}
    for tag, ff in (("bynode", RF_PARAMS["feature_fraction_bynode"]),
                    ("bynode_off", 1.0)):
        bs = lgb.Booster(dict(RF_PARAMS, feature_fraction_bynode=ff), ds)
        bs.update()
        (_, sites), _, counts, _ = counted_run(lambda: host_syncs(
            lambda: [bs.update() for _ in range(SYNC_ROUNDS)]))
        n, waves = len(sites), counts["hist_partition_bf16"]
        syncs[tag] = {"per_round": n / SYNC_ROUNDS,
                      "waves_per_round": waves / SYNC_ROUNDS,
                      "per_wave": n / waves if waves else None}
    log(f"phase 14b host syncs: {json.dumps(syncs)}")
    # the forest packed and served (B4)
    booster = boosters["kernels"]
    rows = Xv[:RF_SERVE_ROWS]
    rt = PredictorRuntime(pack_booster(booster), max_bucket=MAX_BUCKET)
    served, secs, counts, _ = counted_run(lambda: rt.predict(rows))
    check(counts["predict_forest"] > 0, f"14b serving launches {counts}")
    add_launches(launches, counts)
    sdiff = float(np.abs(served - booster.predict(rows)).max())
    check(sdiff <= 1e-5, f"14b served vs Booster.predict {sdiff:.2e}")
    out = {"trees": RF_TREES, "leaves": RF_PARAMS["num_leaves"],
           "feature_fraction_bynode": RF_PARAMS["feature_fraction_bynode"],
           "s_per_round_in_turns": {t: [r["s_per_round"] for r in v]
                                    for t, v in runs.items()},
           "launches": k["counts"], "auc": aucs,
           "auc_kernel_minus_plain": d_auc,
           "dyadic_first_tree_leaves": int(a["num_leaves"]),
           "host_syncs_per_round": syncs,
           "serve": {"rows": RF_SERVE_ROWS, "s": secs,
                     "rows_per_s": RF_SERVE_ROWS / secs,
                     "max_abs_diff": sdiff, "launches": counts}}
    log(f"phase 14b: {json.dumps(out)}")
    return out


def phase_bynode_cv(dds, launches):
    """14c: the batched unfused strict body (diamonds cv, E = 5, B6, no
    B3)."""
    import lightgbm_tpu_torch as lgb

    res = {}
    for tag, extra in (("kernels", {}), ("plain", {"hist_impl": "plain"})):
        fit, secs, counts, plain = counted_run(
            lambda: lgb.cv(dict(BYNODE_CV_PARAMS, **extra), dds,
                           num_boost_round=BYNODE_CV_ROUNDS, nfold=CV_FOLDS,
                           metrics="rmse", early_stopping_rounds=CV_ES,
                           stratified=False, seed=SWEEP_SEED),
            skip=("split_iter_plain",))
        res[tag] = {"best_iter": fit.best_iter, "best_score": fit.best_score,
                    "s": secs, "counts": counts, "plain_calls": plain}
        log(f"phase 14c cv bynode {tag}: best_iter {fit.best_iter}, "
            f"best_score {fit.best_score!r}, {secs:.2f} s, launches "
            f"{json.dumps(counts)}, plain histogram calls {plain}")
    k, p = res["kernels"], res["plain"]
    check(k["counts"]["split_iter"] == 0, "14c: B3 launched under bynode")
    check(k["counts"]["hist_segstats_f32"] > 0 and k["plain_calls"] == 0,
          f"14c kernel path: launches {k['counts']}, plain calls "
          f"{k['plain_calls']}")
    check(k["best_iter"] == p["best_iter"], f"14c best_iter kernel "
          f"{k['best_iter']} vs plain {p['best_iter']}")
    rel = abs(k["best_score"] - p["best_score"]) / abs(p["best_score"])
    check(rel <= 1e-5, f"14c best_score kernel vs plain: rel {rel:.2e}")
    res["best_score_rel_diff"] = rel
    add_launches(launches, k["counts"])
    return res


def phase_bynode_waves(launches):
    """14d: the batched waves under bynode (fused cv at 2^19 rows: B6
    roots, B5 waves)."""
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.utils.datasets import make_higgs_like

    Xb, yb = make_higgs_like(BATCH_CV_ROWS, NUM_FEATURES, seed=SEED + 143)
    ds = lgb.Dataset(Xb, label=yb, params={"max_bin": MAX_BIN})
    ds.construct()
    params = dict(TRAIN_PARAMS, num_leaves=BATCH_CV_LEAVES,
                  feature_fraction_bynode=0.5)
    res = {}
    for tag, extra in (("kernels", {}), ("plain", {"hist_impl": "plain"})):
        fit, secs, counts, plain = counted_run(
            lambda: lgb.cv(dict(params, **extra), ds,
                           num_boost_round=BATCH_CV_ROUNDS, nfold=CV_FOLDS,
                           stratified=False, seed=SWEEP_SEED))
        res[tag] = {"logloss_mean": fit["valid binary_logloss-mean"],
                    "s_per_round": secs / BATCH_CV_ROUNDS, "counts": counts,
                    "plain_calls": plain}
        log(f"phase 14d cv waves bynode {tag}: {secs:.2f} s, launches "
            f"{json.dumps(counts)}, plain calls {plain}")
    k, p = res["kernels"], res["plain"]
    check(k["counts"]["hist_fused_batched_bf16"] > 0
          and k["counts"]["hist_segstats_bf16"] > 0 and k["plain_calls"] == 0,
          f"14d kernel path: launches {k['counts']}, plain calls "
          f"{k['plain_calls']}")
    gap = float(np.max(np.abs(np.asarray(k["logloss_mean"])
                              - np.asarray(p["logloss_mean"]))))
    check(len(k["logloss_mean"]) == BATCH_CV_ROUNDS and gap <= NS_CV_TOL,
          f"14d per-round fold-mean logloss kernel vs plain {gap:.2e}")
    res["logloss_kernel_minus_plain"] = gap
    add_launches(launches, k["counts"])
    return res


def phase_bagging_rf(dev, X, y, dds):
    """Phase 14, every launch counter at 0 just before each run and read
    just after; fails unless every kernel of the path launched."""
    t0 = time.perf_counter()
    launches = {}
    out = {"bagging_boosting": phase_bagging_boosting(dev, launches),
           "rf_north_star": phase_rf_north_star(dev, X, y, launches),
           "bynode_cv": phase_bynode_cv(dds, launches),
           "bynode_waves": phase_bynode_waves(launches)}
    for name in ("hist_fused_f32", "hist_fused_bf16", "hist_partition_bf16",
                 "split_iter", "predict_forest", "hist_segstats_f32",
                 "hist_segstats_bf16", "hist_fused_batched_bf16"):
        check(launches.get(name, 0) > 0, f"phase 14: {name} never launched")
    out["launches"] = launches
    out["s"] = time.perf_counter() - t0
    log(f"phase 14: {out['s']:.1f} s, launches {json.dumps(launches)}")
    return out


def continuous_label(X, seed):
    """15a's label: the Higgs-like logit of ``make_higgs_like`` plus
    N(0, 1) noise from ``seed``."""
    w = np.random.default_rng(987654321).normal(0, 1, X.shape[1])
    logits = (X @ w) * 0.6 + 0.8 * np.sin(X[:, 0] * 2) * X[:, 1] \
        + 0.5 * (X[:, 2] ** 2 - 1)
    noise = np.random.default_rng(seed).normal(0, 1, len(X))
    return (logits + noise).astype(np.float32)


def held_out_metric(booster, name, Xv, yv, dev):
    """The objective's metric (bound to its params) of the transformed
    predictions on held-out rows, on the card."""
    from lightgbm_tpu_torch.metrics import get_metric

    p = torch.from_numpy(booster.predict(Xv)).to(dev)
    y = torch.from_numpy(np.asarray(yv, np.float32)).to(dev)
    return float(get_metric(name, booster.params).fn(p, y,
                                                     torch.ones_like(y)))


def rel_diff(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


def profile_renewal(lgb, ds, params, rounds=3):
    """15a: the renewal's device ms per round (``torch.profiler``, the
    device time under a range around each call) and its CUDA-event span;
    the renewal runs under ``torch.cuda.set_sync_debug_mode("error")``, so
    a read back to the host fails the phase."""
    from torch.profiler import ProfilerActivity, profile, record_function

    import lightgbm_tpu_torch.models.gbdt as G

    orig = G.renew_leaf_values
    spans = []

    def renew(*a, **k):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        with record_function("renew_leaf_values"):
            start.record()
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = orig(*a, **k)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            end.record()
        spans.append((start, end))
        return out

    G.renew_leaf_values = renew
    try:
        booster = lgb.Booster(params, ds)
        booster.update()
        torch.cuda.synchronize()
        spans.clear()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(rounds):
                booster.update()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        G.renew_leaf_values = orig
    renew_us = device_us = 0.0
    for e in prof.key_averages():
        if e.key == "renew_leaf_values":
            renew_us = getattr(e, "device_time_total",
                               getattr(e, "cuda_time_total", 0.0))
        device_us += getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0.0))
    check(len(spans) == rounds, f"15a: {len(spans)} renewals in {rounds} "
          "rounds")
    out = {"rounds": rounds, "wall_ms_per_round": wall_ms / rounds,
           "device_ms_per_round": device_us / 1e3 / rounds,
           "renewal_device_ms_per_round": (
               renew_us / 1e3 / rounds if renew_us > 0 else
               "not measured (no device time traced under the range)"),
           "renewal_event_ms_per_round": sum(
               s.elapsed_time(e) for s, e in spans) / rounds,
           "renewal_host_syncs": 0}
    return out


def phase_renewal_north_star(dev, X, launches):
    """15a: regression_l1 and quantile (alpha 0.9) at the north star's
    width, kernel and plain paths in turns, beside l2 on the same data."""
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.models.tree import tree_to_arrays
    from lightgbm_tpu_torch.utils.datasets import make_higgs_like

    Xv, _ = make_higgs_like(VALID_ROWS, NUM_FEATURES, seed=9)
    yc, yvc = continuous_label(X, SEED + 150), continuous_label(Xv,
                                                                SEED + 151)
    ds = lgb.Dataset(X, label=yc, params={"max_bin": MAX_BIN})
    ds.construct()
    base = dict(TRAIN_PARAMS, alpha=RENEW_ALPHA)
    out = {"rounds": RENEW_ROUNDS, "alpha": RENEW_ALPHA}
    for obj, metric in (("regression", "l2"), ("regression_l1", "l1"),
                        ("quantile", "quantile")):
        params = dict(base, objective=obj)
        runs = {"kernels": [], "plain": []}
        boosters = {}
        for tag in ("kernels", "plain", "plain", "kernels"):     # in turns
            extra = {} if tag == "kernels" else {"hist_impl": "plain"}
            b, secs, counts, plain = counted_run(lambda: lgb.train(
                dict(params, **extra), ds, RENEW_ROUNDS))
            runs[tag].append({"s_per_round": secs / RENEW_ROUNDS,
                              "counts": counts, "plain_calls": plain})
            boosters.setdefault(tag, b)
        k = runs["kernels"][0]
        check(k["counts"]["hist_fused_bf16"] > 0
              and k["counts"]["hist_partition_bf16"] > 0
              and k["plain_calls"] == 0, f"15a {obj} kernel path: launches "
              f"{k['counts']}, plain calls {k['plain_calls']}")
        add_launches(launches, k["counts"])
        res = {"s_per_round_in_turns": {t: [r["s_per_round"] for r in v]
                                        for t, v in runs.items()},
               "launches": k["counts"]}
        if obj != "regression":
            bk, bp = boosters["kernels"], boosters["plain"]
            lv_rel = 0.0
            for i in range(RENEW_ROUNDS):
                a, b = tree_arrays(bk, i), tree_arrays(bp, i)
                check(all(np.array_equal(a[f], b[f]) for f in (
                    "split_feature", "split_bin", "left", "right",
                    "is_leaf")), f"15a {obj}: tree {i} of the kernel and "
                    "plain paths differ in structure")
                leaves = a["is_leaf"]
                lv_rel = max(lv_rel, float(np.max(
                    np.abs(a["leaf_value"][leaves] - b["leaf_value"][leaves])
                    / np.maximum(np.abs(b["leaf_value"][leaves]), 1e-30))))
            check(lv_rel <= 1e-5, f"15a {obj}: leaf values kernel vs plain "
                  f"rel {lv_rel:.2e}")
            m = {t: held_out_metric(b, metric, Xv, yvc, dev)
                 for t, b in boosters.items()}
            check(rel_diff(m["kernels"], m["plain"]) <= 1e-5,
                  f"15a {obj}: held-out {metric} kernel {m['kernels']!r} vs "
                  f"plain {m['plain']!r}")
            res.update(leaf_value_rel_diff=lv_rel, held_out=m,
                       profile=profile_renewal(lgb, ds, params))
        else:
            res["held_out"] = {"kernels": held_out_metric(
                boosters["kernels"], metric, Xv, yvc, dev)}
        out[obj] = res
        log(f"phase 15a {obj}: {json.dumps(res)}")
    del ds
    return out


def l2_fobj(pred, y):
    """15b's custom objective: l2 written with arithmetic operators only,
    called on the Booster's tensors on the card."""
    return pred - y, pred * 0.0 + 1.0


def diamonds_price():
    """15b: the diamonds split of examples/gridsearch_cv.py with the label
    as a price in dollars (``exp`` of the log-price); train and test."""
    from lightgbm_tpu_torch.utils.datasets import (
        make_synthetic_diamonds, train_test_split_bernoulli)

    X, y, _ = make_synthetic_diamonds()
    tr, te = train_test_split_bernoulli(len(y), p_train=0.85,
                                        seed=SWEEP_SEED)
    price = np.exp(y)
    return X[tr], price[tr], X[te], price[te]


def phase_regression_family(dev, launches):
    """15b: the regression family on diamonds prices, the example's
    untuned call, kernel vs plain, each model packed and served."""
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.serving import PredictorRuntime, pack_booster

    Xt, pt, Xe, pe = diamonds_price()
    out = {}
    serve_rows = np.concatenate([Xe, Xt])[:FAMILY_SERVE_ROWS]
    for obj in FAMILY_OBJECTIVES:
        y, ye, metric = pt, pe, FAMILY_METRIC.get(obj, obj)
        if obj == "cross_entropy":
            y, ye = pt / pt.max(), pe / pt.max()
        params = {"learning_rate": 0.1,
                  "objective": l2_fobj if obj == "custom" else obj}
        ds = lgb.Dataset(Xt, label=y)
        ds.construct()
        res, boosters = {}, {}
        for tag, extra in (("kernels", {}), ("plain", {"hist_impl": "plain"})):
            b, secs, counts, plain = counted_run(lambda: lgb.train(
                dict(params, **extra), ds, FAMILY_ROUNDS))
            boosters[tag] = b
            res[tag] = {"rounds": FAMILY_ROUNDS, "s": secs, "counts": counts,
                        "plain_calls": plain,
                        metric: held_out_metric(b, metric, Xe, ye, dev)}
        k = res["kernels"]
        check(k["counts"]["hist_fused_f32"] > 0
              and k["counts"]["hist_partition_f32"] > 0
              and k["plain_calls"] == 0, f"15b {obj} kernel path: launches "
              f"{k['counts']}, plain calls {k['plain_calls']}")
        add_launches(launches, k["counts"])
        rel = rel_diff(k[metric], res["plain"][metric])
        check(np.isfinite(k[metric]) and rel <= 1e-5, f"15b {obj}: held-out "
              f"{metric} kernel {k[metric]!r} vs plain "
              f"{res['plain'][metric]!r}")
        res["metric_rel_diff"] = rel
        booster = boosters["kernels"]
        packed = pack_booster(booster)
        if obj == "custom":
            # as the reference: no objective to rebuild, no runtime
            try:
                PredictorRuntime(packed)
            except ValueError as e:
                res["serve"] = f"refused as the reference refuses: {e}"
            else:
                fail("15b: a custom-objective model was served")
        else:
            rt = PredictorRuntime(packed, max_bucket=MAX_BUCKET)
            served, secs, counts, _ = counted_run(
                lambda: rt.predict(serve_rows))
            check(counts["predict_forest"] > 0,
                  f"15b {obj} serving launches {counts}")
            add_launches(launches, counts)
            want = booster.predict(serve_rows)
            d = float(np.max(np.abs(served - want)
                             / np.maximum(np.abs(want), 1.0)))
            check(d <= 1e-5, f"15b {obj}: served vs Booster.predict {d:.2e}")
            res["serve"] = {"rows": len(serve_rows), "s": secs,
                            "max_rel_diff": d}
        out[obj] = res
        log(f"phase 15b {obj}: {json.dumps(res)}")
    return out


def phase_l1_cv(dds, launches):
    """15c: fused ``cv()`` with regression_l1 on the diamonds split (B6 and
    B3; no renewal, as the reference's fused program)."""
    import lightgbm_tpu_torch as lgb

    res = {}
    params = {"learning_rate": 0.1, "objective": "regression_l1"}
    for tag, extra in (("kernels", {}), ("plain", {"hist_impl": "plain"})):
        fit, secs, counts, plain = counted_run(lambda: lgb.cv(
            dict(params, **extra), dds, num_boost_round=FAMILY_ROUNDS,
            nfold=CV_FOLDS, metrics="l1", early_stopping_rounds=CV_ES,
            stratified=False, seed=SWEEP_SEED))
        res[tag] = {"best_iter": fit.best_iter, "best_score": fit.best_score,
                    "s": secs, "counts": counts, "plain_calls": plain}
        log(f"phase 15c cv l1 {tag}: best_iter {fit.best_iter}, best_score "
            f"{fit.best_score!r}, {secs:.2f} s, launches {json.dumps(counts)}"
            f", plain calls {plain}")
    k, p = res["kernels"], res["plain"]
    check(k["counts"]["split_iter"] > 0
          and k["counts"]["hist_segstats_f32"] > 0 and k["plain_calls"] == 0,
          f"15c kernel path: launches {k['counts']}, plain calls "
          f"{k['plain_calls']}")
    check(k["best_iter"] == p["best_iter"], f"15c best_iter kernel "
          f"{k['best_iter']} vs plain {p['best_iter']}")
    rel = rel_diff(k["best_score"], p["best_score"])
    check(rel <= 1e-5, f"15c best_score kernel vs plain: rel {rel:.2e}")
    res["best_score_rel_diff"] = rel
    add_launches(launches, k["counts"])
    return res


def phase_bf16sr(dev, X, y, auc_bf16, launches):
    """15d: ``hist_dtype="bf16sr"`` at the north star: the rounding on the
    card bit-equal to the CPU's, kernel and plain trees equal, AUC and s per
    round beside bf16 in turns."""
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.ops.histogram import sr_round_bf16
    from lightgbm_tpu_torch.utils.datasets import make_higgs_like

    st = binary_root_stats(y, dev)
    on_card = sr_round_bf16(st).cpu()
    on_cpu = sr_round_bf16(st.cpu())
    check(torch.equal(on_card.view(torch.int32), on_cpu.view(torch.int32)),
          "15d: sr_round_bf16 on the card differs from the CPU's")
    Xv, yv = make_higgs_like(VALID_ROWS, NUM_FEATURES, seed=9)
    ds = lgb.Dataset(X, label=y, params={"max_bin": MAX_BIN})
    ds.construct()
    runs = {"bf16sr": [], "bf16": [], "bf16sr_plain": []}
    boosters = {}
    for tag in ("bf16sr", "bf16", "bf16", "bf16sr", "bf16sr_plain"):
        extra = {"hist_dtype": "bf16sr" if tag.startswith("bf16sr")
                 else "bf16"}
        if tag.endswith("plain"):
            extra["hist_impl"] = "plain"
        b, secs, counts, plain = counted_run(lambda: lgb.train(
            dict(TRAIN_PARAMS, **extra), ds, TRAIN_ROUNDS))
        runs[tag].append({"s_per_round": secs / TRAIN_ROUNDS,
                          "counts": counts, "plain_calls": plain})
        boosters.setdefault(tag, b)
    k = runs["bf16sr"][0]
    check(k["counts"]["hist_fused_bf16"] > 0
          and k["counts"]["hist_partition_bf16"] > 0
          and k["plain_calls"] == 0, f"15d kernel path: launches "
          f"{k['counts']}, plain calls {k['plain_calls']}")
    add_launches(launches, k["counts"])
    for i in range(TRAIN_ROUNDS):
        a = tree_arrays(boosters["bf16sr"], i)
        b = tree_arrays(boosters["bf16sr_plain"], i)
        check(all(np.array_equal(a[f], b[f]) for f in a),
              f"15d: bf16sr tree {i} of the kernel and plain paths differ")
    aucs = {t: auc(b, Xv, yv, dev) for t, b in boosters.items()}
    out = {"rounds": TRAIN_ROUNDS, "sr_round_card_equals_cpu": True,
           "auc": aucs, "phase6_auc_bf16": auc_bf16,
           "s_per_round_in_turns": {t: [r["s_per_round"] for r in v]
                                    for t, v in runs.items()},
           "launches": k["counts"]}
    log(f"phase 15d: {json.dumps(out)}")
    return out


def phase_objectives(dev, X, y, dds, auc_bf16):
    """Phase 15, every launch counter at 0 just before each run and read
    just after; fails unless B1, B2, B3, B4 and B6 launched."""
    t0 = time.perf_counter()
    launches = {}
    out = {"renewal": phase_renewal_north_star(dev, X, launches),
           "family": phase_regression_family(dev, launches),
           "l1_cv": phase_l1_cv(dds, launches),
           "bf16sr": phase_bf16sr(dev, X, y, auc_bf16, launches)}
    for name in ("hist_fused_f32", "hist_fused_bf16", "hist_partition_f32",
                 "hist_partition_bf16", "split_iter", "predict_forest",
                 "hist_segstats_f32"):
        check(launches.get(name, 0) > 0, f"phase 15: {name} never launched")
    out["launches"] = launches
    out["s"] = time.perf_counter() - t0
    log(f"phase 15: {out['s']:.1f} s, launches {json.dumps(launches)}")
    return out


# ---------------------------------------------------------------------------
# phase 16: GOSS and DART
# ---------------------------------------------------------------------------
def trees_parity(a_booster, b_booster, n_trees, what):
    """Tree structure equal and leaf values within 1e-5 relative (the
    parity regime of kernel and plain sums in other orders)."""
    lv_rel = 0.0
    for i in range(n_trees):
        a, b = tree_arrays(a_booster, i), tree_arrays(b_booster, i)
        check(all(np.array_equal(a[f], b[f]) for f in (
            "split_feature", "split_bin", "left", "right", "is_leaf",
            "num_leaves", "count")),
            f"{what}: tree {i} of the kernel and plain paths differ in "
            "structure")
        leaves = a["is_leaf"]
        lv_rel = max(lv_rel, float(np.max(
            np.abs(a["leaf_value"][leaves] - b["leaf_value"][leaves])
            / np.maximum(np.abs(b["leaf_value"][leaves]), 1e-30))))
    check(lv_rel <= 1e-5, f"{what}: leaf values kernel vs plain rel "
          f"{lv_rel:.2e}")
    return lv_rel


def range_device_ms(prof, key):
    """Device time (ms) traced under the profiler range ``key``."""
    for e in prof.key_averages():
        if e.key == key:
            return getattr(e, "device_time_total",
                           getattr(e, "cuda_time_total", 0.0)) / 1e3
    return 0.0


def profile_goss_round(lgb, ds, rounds=3):
    """16a: a GOSS round's device time by part (``torch.profiler`` ranges
    around the selection and the full-row traversal, the tree's depth read
    included), the device's busy share; the selection runs under
    ``torch.cuda.set_sync_debug_mode("error")``, so a host read fails."""
    from torch.profiler import ProfilerActivity, profile, record_function

    import lightgbm_tpu_torch.models.gbdt as G

    origs = {n: getattr(G, n) for n in ("goss_select", "predict_tree_binned",
                                        "forest_depth_cap")}
    spans = {"goss_select": [], "traversal": []}

    def select(*a, **k):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        with record_function("goss_select"):
            start.record()
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = origs["goss_select"](*a, **k)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            end.record()
        spans["goss_select"].append((start, end))
        return out

    def ranged(name, key):
        def fn(*a, **k):
            with record_function(key):
                return origs[name](*a, **k)
        return fn

    G.goss_select = select
    G.predict_tree_binned = ranged("predict_tree_binned", "goss_traversal")
    G.forest_depth_cap = ranged("forest_depth_cap", "goss_depth_read")
    try:
        booster = lgb.Booster(GOSS_PARAMS, ds)
        booster.update()
        torch.cuda.synchronize()
        spans["goss_select"].clear()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(rounds):
                booster.update()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        for n, fn in origs.items():
            setattr(G, n, fn)
    ranges = ("goss_select", "goss_traversal", "goss_depth_read")
    device_us = sum(getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0.0))
                    for e in prof.key_averages() if e.key not in ranges)
    check(len(spans["goss_select"]) == rounds,
          f"16a: {len(spans['goss_select'])} selections in {rounds} rounds")
    sel = range_device_ms(prof, "goss_select")
    trav = (range_device_ms(prof, "goss_traversal")
            + range_device_ms(prof, "goss_depth_read"))
    nm = "not measured (no device time traced under the range)"
    return {"rounds": rounds, "wall_ms_per_round": wall_ms / rounds,
            "device_ms_per_round": device_us / 1e3 / rounds,
            "device_busy_share": (device_us / 1e3 / wall_ms if device_us
                                  else "not measured"),
            "selection_device_ms_per_round": sel / rounds if sel else nm,
            "selection_event_ms_per_round": sum(
                s.elapsed_time(e) for s, e in spans["goss_select"]) / rounds,
            "traversal_device_ms_per_round": trav / rounds if trav else nm,
            "selection_host_syncs": 0}


def phase_goss_north_star(dev, X, y, launches):
    """16a: GOSS at the north star (LightGBM's defaults a = 0.2, b = 0.1:
    300,000 compacted rows, f32 under "auto", B1 roots and B2 waves),
    kernel and plain paths in turns beside phase 6's gbdt round."""
    import lightgbm_tpu_torch as lgb
    import lightgbm_tpu_torch.models.gbdt as G
    from lightgbm_tpu_torch.ops.sampling import goss_select
    from lightgbm_tpu_torch.serving import PredictorRuntime, pack_booster
    from lightgbm_tpu_torch.utils.datasets import make_higgs_like

    Xv, yv = make_higgs_like(VALID_ROWS, NUM_FEATURES, seed=9)
    ds = lgb.Dataset(X, label=y, params={"max_bin": MAX_BIN})
    ds.construct()
    orig, selections = G.goss_select, {}

    def recording(tag):
        rec = selections.setdefault(tag, [])

        def fn(*a, **k):
            out = orig(*a, **k)
            rec.append((out[0].clone(), out[1].clone()))
            return out
        return fn

    for extra in ({}, {"hist_impl": "plain"}):                # warm
        lgb.train(dict(GOSS_PARAMS, **extra), ds, 1)
    runs = {"kernels": [], "plain": [], "gbdt": []}
    boosters = {}
    for tag in ("kernels", "plain", "gbdt", "gbdt", "plain", "kernels"):
        params = (TRAIN_PARAMS if tag == "gbdt" else dict(
            GOSS_PARAMS, **({"hist_impl": "plain"} if tag == "plain"
                            else {})))
        if tag != "gbdt" and tag not in boosters:
            G.goss_select = recording(tag)
        try:
            b, secs, counts, plain = counted_run(
                lambda: lgb.train(params, ds, GOSS_ROUNDS))
        finally:
            G.goss_select = orig
        runs[tag].append({"s_per_round": secs / GOSS_ROUNDS,
                          "counts": counts, "plain_calls": plain})
        boosters.setdefault(tag, b)
        log(f"phase 16a {tag}: {GOSS_ROUNDS} rounds in {secs:.2f} s, "
            f"launches {json.dumps(counts)}, plain calls {plain}")
    k = runs["kernels"][0]
    check(k["counts"]["hist_fused_f32"] > 0
          and k["counts"]["hist_partition_f32"] > 0
          and k["counts"]["hist_fused_bf16"] == 0
          and k["plain_calls"] == 0, f"16a kernel path (f32 at 300,000 "
          f"compacted rows): launches {k['counts']}, plain calls "
          f"{k['plain_calls']}")
    add_launches(launches, k["counts"])
    bk, bp = boosters["kernels"], boosters["plain"]
    check(bk._goss_k() == (200_000, 100_000) and bk._eff_rows() == 300_000,
          f"16a GOSS counts {bk._goss_k()}")
    sk, sp = selections["kernels"], selections["plain"]
    check(len(sk) == len(sp) == GOSS_ROUNDS, f"16a: {len(sk)}/{len(sp)} "
          "selections recorded")
    for r, ((ik, wk), (ip, wp)) in enumerate(zip(sk, sp)):
        check(torch.equal(ik, ip) and torch.equal(wk, wp),
              f"16a round {r}: the kernel and plain paths selected other "
              "rows or weights")
    del selections, sk, sp
    lv_rel = trees_parity(bk, bp, GOSS_ROUNDS, "16a")
    # the card's selection equals the CPU's on the same gradients, with no
    # host read
    g, _ = bk.obj.grad_hess(bk._pred_train, ds.y, bk._w_eff)
    key = bk._round_key(GOSS_ROUNDS)
    args = (bk._goss_k(), GOSS_PARAMS["top_rate"], GOSS_PARAMS["other_rate"])
    goss_select(key, g, bk._bag, *args)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        card_sel = goss_select(key, g, bk._bag, *args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    cpu_sel = goss_select(key, g.cpu(), bk._bag.cpu(), *args)
    check(all(torch.equal(a.cpu(), b) for a, b in zip(card_sel, cpu_sel)),
          "16a: the card's GOSS selection differs from the CPU's")
    aucs = {t: auc(b, Xv, yv, dev) for t, b in boosters.items()}
    d_auc = aucs["kernels"] - aucs["plain"]
    check(abs(d_auc) <= AUC_TOL, f"16a AUC kernel - plain {d_auc:.2e}")
    syncs = {}
    for tag, params in (("goss", GOSS_PARAMS), ("gbdt", TRAIN_PARAMS)):
        bs = lgb.Booster(params, ds)
        bs.update()
        (_, sites), _, _, _ = counted_run(lambda: host_syncs(
            lambda: [bs.update() for _ in range(SYNC_ROUNDS)]))
        syncs[tag] = len(sites) / SYNC_ROUNDS
    profile = profile_goss_round(lgb, ds)
    rows = Xv[:GOSS_SERVE_ROWS]
    rt = PredictorRuntime(pack_booster(bk), max_bucket=MAX_BUCKET)
    served, secs, counts, _ = counted_run(lambda: rt.predict(rows))
    check(counts["predict_forest"] > 0, f"16a serving launches {counts}")
    add_launches(launches, counts)
    sdiff = float(np.abs(served - bk.predict(rows)).max())
    check(sdiff <= 1e-5, f"16a served vs Booster.predict {sdiff:.2e}")
    out = {"rounds": GOSS_ROUNDS, "goss_k": list(bk._goss_k()),
           "hist_dtype": "f32",
           "s_per_round_in_turns": {t: [r["s_per_round"] for r in v]
                                    for t, v in runs.items()},
           "launches": k["counts"], "auc": aucs,
           "auc_kernel_minus_plain": d_auc, "leaf_value_rel_diff": lv_rel,
           "selection_card_equals_cpu": True,
           "host_syncs_per_round": syncs, "profile": profile,
           "serve": {"rows": GOSS_SERVE_ROWS, "s": secs,
                     "max_abs_diff": sdiff, "launches": counts}}
    log(f"phase 16a: {json.dumps(out)}")
    return out


def phase_goss_multiclass(dev, Xc, yc, launches):
    """16b: multiclass GOSS (rows re-weighted by sum_c |g_c|, not
    compacted) at Covertype's shape: the batched class trees, B5 or B6 by
    the route rule."""
    import lightgbm_tpu_torch as lgb

    Xv, yv = covertype_like(COV_VALID_ROWS, SEED + 121)
    ds = lgb.Dataset(Xc, label=yc, params={"max_bin": MAX_BIN})
    ds.construct()
    params = dict(COV_PARAMS, boosting="goss")
    runs = {}
    for tag, extra in (("kernels", {}), ("plain", {"hist_impl": "plain"})):
        b, secs, counts, plain = counted_run(
            lambda: lgb.train(dict(params, **extra), ds, MC_GOSS_ROUNDS))
        runs[tag] = {"booster": b, "s_per_round": secs / MC_GOSS_ROUNDS,
                     "counts": counts, "plain_calls": plain,
                     "multi_logloss": multi_logloss(b, Xv, yv, dev)}
        log(f"phase 16b {tag}: {MC_GOSS_ROUNDS} rounds in {secs:.2f} s, "
            f"multi_logloss {runs[tag]['multi_logloss']:.6f}, launches "
            f"{json.dumps(counts)}, plain calls {plain}")
    k, p = runs["kernels"], runs["plain"]
    b5, b6 = (k["counts"]["hist_fused_batched_bf16"],
              k["counts"]["hist_segstats_bf16"])
    check(b5 + b6 > 0 and k["plain_calls"] == 0, f"16b kernel path: "
          f"launches {k['counts']}, plain calls {k['plain_calls']}")
    add_launches(launches, k["counts"])
    for i in range(MC_GOSS_ROUNDS):
        a, b = tree_arrays(k["booster"], i), tree_arrays(p["booster"], i)
        check(all(np.array_equal(a[f], b[f]) for f in (
            "split_feature", "split_bin", "left", "right", "is_leaf")),
            f"16b: round {i}'s class trees of the kernel and plain paths "
            "differ in structure")
    d_ll = k["multi_logloss"] - p["multi_logloss"]
    check(np.isfinite(k["multi_logloss"]) and abs(d_ll) <= COV_TOL,
          f"16b multi_logloss kernel - plain {d_ll:.2e}")
    out = {"rounds": MC_GOSS_ROUNDS,
           "s_per_round": {t: r["s_per_round"] for t, r in runs.items()},
           "multi_logloss": {t: r["multi_logloss"] for t, r in runs.items()},
           "launches": k["counts"], "b5_launched": b5 > 0,
           "b6_launched": b6 > 0}
    log(f"phase 16b: {json.dumps(out)}")
    return out


def phase_dart_north_star(dev, X, y, launches):
    """16c: DART at the north star with LightGBM's defaults, the phase-6
    valid set attached, kernel and plain paths: the same drops, stored
    leaves after rescaling and valid AUC; the dropped-tree replay's device
    ms per drop round (CUDA events around its stacked forest passes)."""
    import lightgbm_tpu_torch as lgb
    import lightgbm_tpu_torch.models.gbdt as G
    from lightgbm_tpu_torch.serving import PredictorRuntime, pack_booster
    from lightgbm_tpu_torch.utils.datasets import make_higgs_like

    Xv, yv = make_higgs_like(VALID_ROWS, NUM_FEATURES, seed=9)
    ds = lgb.Dataset(X, label=y, params={"max_bin": MAX_BIN})
    ds.construct()
    dv = lgb.Dataset(Xv, label=yv, reference=ds)
    origs = (G.dart_drops, G.predict_forest_binned)
    runs = {}
    for tag, extra in (("kernels", {}), ("plain", {"hist_impl": "plain"})):
        drops, spans = [], []

        def dart_drops(*a, **k):
            out = origs[0](*a, **k)
            drops.append(out)
            return out

        def replay(*a, **k):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
            start.record()
            out = origs[1](*a, **k)
            end.record()
            spans.append((start, end))
            return out

        G.dart_drops, G.predict_forest_binned = dart_drops, replay
        try:
            b, secs, counts, plain = counted_run(lambda: lgb.train(
                dict(DART_PARAMS, **extra), ds, DART_ROUNDS,
                valid_sets=[dv], valid_names=["valid"]))
        finally:
            G.dart_drops, G.predict_forest_binned = origs
        n_drop = sum(1 for d in drops if d)
        runs[tag] = {"booster": b, "s_per_round": secs / DART_ROUNDS,
                     "counts": counts, "plain_calls": plain, "drops": drops,
                     "drop_rounds": n_drop,
                     "replay_event_ms_per_drop_round": (
                         sum(s.elapsed_time(e) for s, e in spans) / n_drop
                         if n_drop else None),
                     "auc": auc(b, Xv, yv, dev)}
        log(f"phase 16c {tag}: {DART_ROUNDS} rounds in {secs:.2f} s, "
            f"{n_drop} drop rounds, dropped {[len(d) for d in drops]}, "
            f"launches {json.dumps(counts)}, plain calls {plain}")
    k, p = runs["kernels"], runs["plain"]
    check(k["counts"]["hist_fused_bf16"] > 0
          and k["counts"]["hist_partition_bf16"] > 0
          and k["plain_calls"] == 0, f"16c kernel path: launches "
          f"{k['counts']}, plain calls {k['plain_calls']}")
    add_launches(launches, k["counts"])
    check(k["drops"] == p["drops"] and k["drop_rounds"] > 0,
          f"16c: drops kernel {k['drops']} vs plain {p['drops']}")
    lv_rel = trees_parity(k["booster"], p["booster"], DART_ROUNDS, "16c")
    d_auc = k["auc"] - p["auc"]
    check(abs(d_auc) <= AUC_TOL, f"16c valid AUC kernel - plain {d_auc:.2e}")
    bk = k["booster"]
    rows = Xv[:GOSS_SERVE_ROWS]
    rt = PredictorRuntime(pack_booster(bk), max_bucket=MAX_BUCKET)
    served, secs, counts, _ = counted_run(lambda: rt.predict(rows))
    check(counts["predict_forest"] > 0, f"16c serving launches {counts}")
    add_launches(launches, counts)
    sdiff = float(np.abs(served - bk.predict(rows)).max())
    check(sdiff <= 1e-5, f"16c served vs Booster.predict {sdiff:.2e}")
    out = {"rounds": DART_ROUNDS,
           "drops_per_round": [len(d) for d in k["drops"]],
           "s_per_round": {t: r["s_per_round"] for t, r in runs.items()},
           "replay_event_ms_per_drop_round": {
               t: r["replay_event_ms_per_drop_round"]
               for t, r in runs.items()},
           "auc": {t: r["auc"] for t, r in runs.items()},
           "auc_kernel_minus_plain": d_auc, "leaf_value_rel_diff": lv_rel,
           "launches": k["counts"],
           "serve": {"rows": GOSS_SERVE_ROWS, "s": secs,
                     "max_abs_diff": sdiff, "launches": counts}}
    log(f"phase 16c: {json.dumps(out)}")
    return out


def phase_goss_dart_cv(dds, launches):
    """16d: examples/gridsearch_cv.py's cv() arguments with GOSS and then
    DART (the per-fold route; 31 leaves and ~11,000 compacted rows per fold
    put GOSS on the wave grower: B1 and B2), both paths cut at the same
    round: the fold-mean RMSE per round within 1e-5 relative and
    ``best_iter`` equal."""
    import lightgbm_tpu_torch as lgb

    out = {}
    for boosting in ("goss", "dart"):
        res = {}
        rounds = GD_CV_ROUNDS[boosting]
        for tag, extra in (("kernels", {}), ("plain", {"hist_impl": "plain"})):
            fit, secs, counts, plain = counted_run(lambda: lgb.cv(
                dict(CV_PARAMS, boosting=boosting, **extra), dds,
                num_boost_round=rounds, nfold=CV_FOLDS, metrics="rmse",
                early_stopping_rounds=CV_ES, stratified=False,
                seed=SWEEP_SEED))
            res[tag] = {"max_rounds": rounds, "best_iter": fit.best_iter,
                        "best_score": fit.best_score, "s": secs,
                        "rounds_run": len(fit["valid rmse-mean"]),
                        "counts": counts, "plain_calls": plain,
                        "history": list(fit["valid rmse-mean"])}
            log(f"phase 16d {boosting} cv {tag}: best_iter {fit.best_iter},"
                f" best_score {fit.best_score!r}, {secs:.2f} s, launches "
                f"{json.dumps(counts)}, plain calls {plain}")
        kc, pc = res["kernels"], res["plain"]
        check(kc["counts"]["hist_fused_f32"] > 0
              and kc["counts"]["hist_partition_f32"] > 0
              and kc["plain_calls"] == 0, f"16d {boosting} kernel path: "
              f"launches {kc['counts']}, plain calls {kc['plain_calls']}")
        add_launches(launches, kc["counts"])
        hk, hp = kc.pop("history"), pc.pop("history")
        check(len(hk) == len(hp), f"16d {boosting}: rounds run kernel "
              f"{len(hk)} vs plain {len(hp)}")
        rel = max(rel_diff(a, b) for a, b in zip(hk, hp))
        check(rel <= 1e-5, f"16d {boosting} fold-mean RMSE kernel vs plain "
              f"per round: rel {rel:.2e}")
        check(kc["best_iter"] == pc["best_iter"], f"16d {boosting} "
              f"best_iter kernel {kc['best_iter']} vs plain "
              f"{pc['best_iter']}")
        res["rmse_rel_diff"] = rel
        out[boosting] = res
    log(f"phase 16d: {json.dumps(out)}")
    return out


def phase_dart_recovery(dev, workdir, launches):
    """16e: DART on examples/bagging_boosting.py's curve (the strict
    grower: B1's two segments and B3), ``train_resumable`` killed by SIGTERM
    after round index 6 and resumed: every tree field (rescaled leaves
    included), the train scores and the served scores bit-identical to the
    uninterrupted run; its trees equal to the plain path's."""
    import shutil
    import signal

    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.models.gbdt import dart_drops
    from lightgbm_tpu_torch.serving import PredictorRuntime, pack_booster
    from lightgbm_tpu_torch.training import train_resumable
    from lightgbm_tpu_torch.utils.datasets import make_boosting_curve

    X, y = make_boosting_curve(BB_ROWS, BB_SEED)
    ds = lgb.Dataset(X, label=y)
    ds.construct()
    root = os.path.join(workdir, "dart_recovery")
    shutil.rmtree(root, ignore_errors=True)
    full_dir, kill_dir = (os.path.join(root, d) for d in ("full", "killed"))
    kw = dict(checkpoint_rounds=RECOVERY_EVERY, keep_last=3)

    def kill(booster, i):
        if i == RECOVERY_KILL_AFTER:
            os.kill(os.getpid(), signal.SIGTERM)

    def training():
        full = train_resumable(dict(DART_CURVE_PARAMS), ds, RECOVERY_ROUNDS,
                               checkpoint_dir=full_dir, resume=False, **kw)
        killed = train_resumable(dict(DART_CURVE_PARAMS), ds,
                                 RECOVERY_ROUNDS, checkpoint_dir=kill_dir,
                                 resume=False, round_callbacks=[kill], **kw)
        again = train_resumable(dict(DART_CURVE_PARAMS), ds, RECOVERY_ROUNDS,
                                checkpoint_dir=kill_dir, resume=True, **kw)
        return full, killed, again

    (full, killed, again), secs, counts, plain = counted_run(training)
    check(counts["hist_fused_f32"] > 0 and counts["split_iter"] > 0
          and plain == 0, f"16e kernel path: launches {counts}, plain calls "
          f"{plain}")
    add_launches(launches, counts)
    check(killed.preempted and killed.rounds_done == RECOVERY_KILL_AFTER + 1
          and again.completed and again.resumed_from
          == killed.last_checkpoint, f"16e SIGTERM after round index "
          f"{RECOVERY_KILL_AFTER}: {killed}, then {again}")
    fb, ab = full.booster, again.booster
    check(same_run(fb, ab), "16e: the resumed DART run's trees, _pred_train "
          "or _bag differ from the uninterrupted run")
    drops = [dart_drops(fb.params, i, i) for i in range(RECOVERY_ROUNDS)]
    check(sum(map(len, drops)) > 0, f"16e: no round dropped a tree {drops}")
    grid = np.linspace(-4, 4, 400).reshape(-1, 1)
    served = [PredictorRuntime(pack_booster(b), max_bucket=512).predict(
        grid, raw_score=True) for b in (fb, ab)]
    check(np.array_equal(served[0], served[1]), "16e: served scores of the "
          "resumed and uninterrupted runs differ")
    bp = lgb.train(dict(DART_CURVE_PARAMS, hist_impl="plain"), ds,
                   RECOVERY_ROUNDS)
    lv_rel = trees_parity(fb, bp, RECOVERY_ROUNDS, "16e")
    out = {"rows": BB_ROWS, "rounds": RECOVERY_ROUNDS,
           "preempted_at": killed.rounds_done, "s": secs,
           "drops_per_round": [len(d) for d in drops],
           "bit_identical": True, "leaf_value_rel_diff_vs_plain": lv_rel,
           "launches": counts}
    log(f"phase 16e: {json.dumps(out)}")
    return out


def phase_goss_dart(dev, X, y, Xc, yc, dds, workdir, card):
    """Phase 16, every launch counter at 0 just before each run and read
    just after; fails unless B1, B2, B3, B4 and B5 or B6 launched."""
    t0 = time.perf_counter()
    launches, secs = {}, {}
    out = {}
    for name, fn in (("16a", lambda: phase_goss_north_star(dev, X, y,
                                                           launches)),
                     ("16b", lambda: phase_goss_multiclass(dev, Xc, yc,
                                                           launches)),
                     ("16c", lambda: phase_dart_north_star(dev, X, y,
                                                           launches)),
                     ("16d", lambda: phase_goss_dart_cv(dds, launches)),
                     ("16e", lambda: phase_dart_recovery(dev, workdir,
                                                         launches))):
        t1 = time.perf_counter()
        out[name] = fn()
        secs[name] = time.perf_counter() - t1
    for name in ("hist_fused_f32", "hist_partition_f32", "split_iter",
                 "predict_forest"):
        check(launches.get(name, 0) > 0, f"phase 16: {name} never launched")
    check(launches.get("hist_fused_batched_bf16", 0)
          + launches.get("hist_segstats_bf16", 0) > 0,
          "phase 16: neither B5 nor B6 launched")
    out["launches"] = launches
    out["s_by_part"] = secs
    out["s"] = time.perf_counter() - t0
    log(f"phase 16: {out['s']:.1f} s ({json.dumps(secs)}) on {card}, "
        f"launches {json.dumps(launches)}")
    return out


# ---------------------------------------------------------------------------
# phase 17: categorical features
# ---------------------------------------------------------------------------
def airline_like(n, seed):
    """Rows at the shape of the airline-delay table: Month (12), DayofMonth
    (31), DayOfWeek (7), UniqueCarrier (22), Origin and Dest (300 airports
    each, Zipf-like traffic) as category codes, DepTime (hhmm) and Distance
    numeric; the label (about a fifth delayed) from per-category effects
    drawn from their own stream, so every seed shares the labelling."""
    rng = np.random.default_rng(seed)
    fx = np.random.default_rng(20261018)
    traffic = 1.0 / np.arange(1, 301) ** 0.9
    traffic /= traffic.sum()
    cols = {"Month": rng.integers(1, 13, n), "DayofMonth": rng.integers(
        1, 32, n), "DayOfWeek": rng.integers(1, 8, n),
        "DepTime": rng.integers(5, 24, n) * 100 + rng.integers(0, 60, n),
        "UniqueCarrier": rng.integers(0, 22, n),
        "Origin": rng.choice(300, n, p=traffic),
        "Dest": rng.choice(300, n, p=traffic),
        "Distance": np.exp(rng.normal(6.4, 0.6, n)).clip(30, 5000)}
    score = -1.6 + 0.45 * (cols["DepTime"] / 100.0 - 14.0) / 5.0 \
        + 0.1 * np.log(cols["Distance"] / 600.0)
    for name, k in AIR_CATS.items():
        base = 1 if name in ("Month", "DayofMonth", "DayOfWeek") else 0
        scale = 0.2 if name == "DayofMonth" else 0.5
        score = score + fx.normal(0, scale, k)[cols[name] - base]
    y = (rng.random(n) < 1.0 / (1.0 + np.exp(-score))).astype(np.float32)
    X = np.column_stack([cols[c] for c in AIR_COLUMNS]).astype(np.float32)
    return X, y


def cat_dataset(lgb, X, y):
    return lgb.Dataset(X, label=y, feature_name=list(AIR_COLUMNS),
                       categorical_feature=list(AIR_CATS),
                       params={"max_bin": MAX_BIN})


def cat_split_nodes(booster):
    return int(sum(int(t.is_cat_split.sum()) for t in booster.trees))


def syncs_per_round(lgb, params, ds):
    """Host syncs per round (PyTorch's sync debug mode) and waves per round
    (a wave is a B2 launch, or on the unfused route a B1 launch beyond the
    root) over SYNC_ROUNDS rounds after a warm one, and the sync sites."""
    b = lgb.Booster(params, ds)
    b.update()
    (_, sites), _, counts, _ = counted_run(lambda: host_syncs(
        lambda: [b.update() for _ in range(SYNC_ROUNDS)]))
    waves = sum(v for k, v in counts.items()
                if k.startswith(("hist_partition_", "hist_fused_"))
                and not k.startswith("hist_fused_batched")) - SYNC_ROUNDS
    return {"syncs_per_round": len(sites) / SYNC_ROUNDS,
            "waves_per_round": waves / SYNC_ROUNDS,
            "sites": dict(sorted(collections.Counter(sites).items()))}


def round_without_host_reads(booster, module, name):
    """One round whose every call of ``module.name`` runs under
    ``torch.cuda.set_sync_debug_mode("error")``, so a host read there
    fails the round; returns the calls run."""
    orig, calls = getattr(module, name), [0]

    def guarded(*a, **k):
        calls[0] += 1
        torch.cuda.set_sync_debug_mode("error")
        try:
            return orig(*a, **k)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    setattr(module, name, guarded)
    try:
        booster.update()
        torch.cuda.synchronize()
    finally:
        setattr(module, name, orig)
    return calls[0]


def phase_cat_airline(dev, workdir, launches):
    """17a: the north star's model on the airline-shaped table, the wave
    grower through B1 (categorical waves take the unfused route: the plain
    partition, then B1 with a segment per split), kernel and plain paths in
    turns."""
    import lightgbm_tpu_torch as lgb
    import lightgbm_tpu_torch.models.tree as T
    from lightgbm_tpu_torch.serving import PredictorRuntime, pack_booster

    X, y = airline_like(AIR_ROWS, SEED + 170)
    Xv, yv = airline_like(VALID_ROWS, SEED + 171)
    t0 = time.perf_counter()
    ds = cat_dataset(lgb, X, y)
    ds.construct()
    bin_s = time.perf_counter() - t0
    check(ds.col_is_categorical.tolist() == [c in AIR_CATS
                                             for c in AIR_COLUMNS],
          f"17a categorical columns {ds.col_is_categorical}")
    origin = AIR_COLUMNS.index("Origin")
    over = int((ds.X_binned[:, origin] == 254).sum())
    check(ds.feature_num_bin(origin) == 255 and over > 0,
          f"17a Origin: {ds.feature_num_bin(origin)} bins, {over} rows in "
          "the overflow bin")
    for extra in ({}, {"hist_impl": "plain"}):                # warm
        lgb.train(dict(TRAIN_PARAMS, **extra), ds, 1)
    runs, boosters = {"kernels": [], "plain": []}, {}
    for tag in ("kernels", "plain", "plain", "kernels"):
        params = dict(TRAIN_PARAMS, **({"hist_impl": "plain"}
                                       if tag == "plain" else {}))
        b, secs, counts, plain = counted_run(
            lambda: lgb.train(params, ds, CAT_ROUNDS))
        runs[tag].append({"s_per_round": secs / CAT_ROUNDS,
                          "counts": counts, "plain_calls": plain})
        boosters.setdefault(tag, b)
        log(f"phase 17a {tag}: {CAT_ROUNDS} rounds in {secs:.2f} s, "
            f"launches {json.dumps(counts)}, plain calls {plain}")
    k = runs["kernels"][0]
    check(k["counts"]["hist_fused_bf16"] > 0 and k["plain_calls"] == 0
          and k["counts"]["hist_partition_bf16"] == 0
          and k["counts"]["hist_partition_f32"] == 0,
          f"17a kernel path (B1 bf16, no B2): launches {k['counts']}, plain "
          f"calls {k['plain_calls']}")
    add_launches(launches, k["counts"])
    bk, bp = boosters["kernels"], boosters["plain"]
    n_cat = cat_split_nodes(bk)
    check(n_cat > 0, "17a: no categorical split in the kernel path's trees")
    aucs = {t: auc(b, Xv, yv, dev) for t, b in boosters.items()}
    d_auc = aucs["kernels"] - aucs["plain"]
    check(abs(d_auc) <= AUC_TOL, f"17a AUC kernel - plain {d_auc:.2e}")
    same_trees = all(
        all(np.array_equal(tree_arrays(bk, i)[f], tree_arrays(bp, i)[f])
            for f in ("split_feature", "split_bin", "left", "right",
                      "is_leaf", "is_cat_split", "cat_mask"))
        for i in range(CAT_ROUNDS))
    # the round-1 tree on a dyadic label (l2, exactly half ones): exact sums
    score = X[:, AIR_COLUMNS.index("DepTime")] / 2400.0 + np.random.\
        default_rng(SEED + 172).normal(0, 1, 300)[X[:, origin].astype(int)]
    yd = np.zeros(len(y), np.float32)
    yd[np.argsort(score, kind="stable")[len(y) // 2:]] = 1.0
    dsd = cat_dataset(lgb, X, yd)
    pd_ = dict(TRAIN_PARAMS, objective="regression", hist_dtype="f32")
    a, b = (tree_arrays(lgb.train(dict(pd_, **extra), dsd, 1), 0)
            for extra in ({}, {"hist_impl": "plain"}))
    check(a.keys() == b.keys() and all(np.array_equal(a[f], b[f])
                                       for f in a),
          "17a: the dyadic round-1 trees of the kernel and plain paths differ")
    check(bool(a["is_cat_split"].any()), "17a: no subset split in the dyadic "
          "round-1 tree")
    del dsd, yd
    # host syncs: a categorical round against a numeric round of the same
    # tree shape (the same table with no categorical column)
    dsn = lgb.Dataset(X, label=y, params={"max_bin": MAX_BIN})
    syncs = {"categorical": syncs_per_round(lgb, TRAIN_PARAMS, ds),
             "numeric": syncs_per_round(lgb, TRAIN_PARAMS, dsn)}
    del dsn
    sc, sn = syncs["categorical"], syncs["numeric"]
    # no site of its own, and no more syncs beyond the one per wave
    check(set(sc["sites"]) <= set(sn["sites"])
          and sc["syncs_per_round"] - sc["waves_per_round"]
          <= sn["syncs_per_round"] - sn["waves_per_round"],
          f"17a host syncs: categorical {sc}, numeric {sn}")
    scans = round_without_host_reads(lgb.Booster(TRAIN_PARAMS, ds), T,
                                     "find_best_split")
    breakdown = profile_rounds(lgb, ds, TRAIN_PARAMS, tag="phase 17a",
                               unfused=True)
    # the text model reloads with the same predictions, bit for bit
    path = os.path.join(workdir, "cat_airline.txt")
    bk.save_model(path)
    rows = Xv[:CAT_SERVE_ROWS]
    want = bk.predict(rows)
    check(np.array_equal(lgb.Booster(model_file=path).predict(rows), want),
          "17a: the reloaded text model predicts other bits")
    rt = PredictorRuntime(pack_booster(bk), max_bucket=MAX_BUCKET)
    served, serve_s, counts, _ = counted_run(lambda: rt.predict(rows))
    check(counts["predict_forest"] == 0 and not rt.fused_predict,
          f"17a: a categorical forest reached B4 ({counts})")
    sdiff = float(np.abs(served - want).max())
    check(sdiff <= 1e-5, f"17a served vs Booster.predict {sdiff:.2e}")
    out = {"rounds": CAT_ROUNDS, "binning_s": bin_s, "overflow_rows": over,
           "s_per_round_in_turns": {t: [r["s_per_round"] for r in v]
                                    for t, v in runs.items()},
           "launches": k["counts"], "b1_launches": k["counts"][
               "hist_fused_bf16"], "categorical_split_nodes": n_cat,
           "auc": aucs, "auc_kernel_minus_plain": d_auc,
           "all_trees_equal_kernel_vs_plain": same_trees,
           "host_syncs": syncs, "scans_under_sync_error": scans,
           "round_breakdown": breakdown,
           "serve": {"rows": CAT_SERVE_ROWS, "s": serve_s,
                     "max_abs_diff": sdiff, "b4_launches": 0}}
    log(f"phase 17a: {json.dumps(out)}")
    return out, ds, Xv, yv


def phase_cat_strict(dev, ds, Xv, yv, launches):
    """17b: the same table on the strict grower: B1 with two segments per
    split iteration, the reference's unfused body (no B3)."""
    import lightgbm_tpu_torch as lgb

    params = dict(TRAIN_PARAMS, grow_policy="leafwise")
    runs = {}
    for tag, extra in (("kernels", {}), ("plain", {"hist_impl": "plain"})):
        b, secs, counts, plain = counted_run(
            lambda: lgb.train(dict(params, **extra), ds, CAT_SHORT_ROUNDS),
            skip=("split_iter_plain",))
        runs[tag] = {"s_per_round": secs / CAT_SHORT_ROUNDS,
                     "counts": counts, "plain_calls": plain,
                     "auc": auc(b, Xv, yv, dev),
                     "categorical_split_nodes": cat_split_nodes(b)}
        log(f"phase 17b {tag}: {CAT_SHORT_ROUNDS} strict rounds in "
            f"{secs:.2f} s, launches {json.dumps(counts)}, plain calls "
            f"{plain}")
    k = runs["kernels"]
    check(k["counts"]["hist_fused_bf16"] > 0 and k["counts"]["split_iter"]
          == 0 and k["plain_calls"] == 0, f"17b kernel path (B1, no B3): "
          f"launches {k['counts']}, plain calls {k['plain_calls']}")
    add_launches(launches, k["counts"])
    d_auc = k["auc"] - runs["plain"]["auc"]
    check(abs(d_auc) <= AUC_TOL, f"17b AUC kernel - plain {d_auc:.2e}")
    out = {"rounds": CAT_SHORT_ROUNDS, **{t: {f: v for f, v in r.items()
                                             if f != "counts"}
                                         for t, r in runs.items()},
           "launches": k["counts"], "auc_kernel_minus_plain": d_auc}
    log(f"phase 17b: {json.dumps(out)}")
    return out


def phase_cat_cv(launches):
    """17c: examples/gridsearch_cv.py's cv() with cut, color and clarity as
    factors (fused, strict trees, E = 5: B6 and the unfused body)."""
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.utils.datasets import (
        make_synthetic_diamonds, train_test_split_bernoulli)

    X, y, names = make_synthetic_diamonds()
    tr, _ = train_test_split_bernoulli(len(y), p_train=0.85, seed=SWEEP_SEED)
    ds = lgb.Dataset(X[tr], label=y[tr], feature_name=names,
                     categorical_feature=DIAMOND_CATS)
    ds.construct()
    res = {}
    for tag, extra, rounds in (("kernels", {}, CAT_CV_ROUNDS),
                               ("plain", {"hist_impl": "plain"},
                                CAT_CV_ROUNDS)):
        fit, secs, counts, plain = counted_run(lambda: lgb.cv(
            dict(CV_PARAMS, **extra), ds, num_boost_round=rounds,
            nfold=CV_FOLDS, metrics="rmse", early_stopping_rounds=CV_ES,
            stratified=False, seed=SWEEP_SEED), skip=("split_iter_plain",))
        res[tag] = {"max_rounds": rounds, "best_iter": fit.best_iter,
                    "best_score": fit.best_score, "s": secs,
                    "rounds_run": len(fit["valid rmse-mean"]),
                    "counts": counts, "plain_calls": plain,
                    "history": list(fit["valid rmse-mean"])}
        log(f"phase 17c cv {tag}: best_iter {fit.best_iter}, best_score "
            f"{fit.best_score!r}, {secs:.2f} s, launches {json.dumps(counts)}"
            f", plain calls {plain}")
    kc, pc = res["kernels"], res["plain"]
    check(kc["counts"]["hist_segstats_f32"] > 0 and kc["counts"][
        "split_iter"] == 0 and kc["plain_calls"] == 0, f"17c kernel path "
        f"(B6, no B3): launches {kc['counts']}, plain calls "
        f"{kc['plain_calls']}")
    add_launches(launches, kc["counts"])
    hk, hp = kc.pop("history"), pc.pop("history")
    n = min(len(hk), len(hp))
    rel = max(rel_diff(a, b) for a, b in zip(hk[:n], hp[:n]))
    check(rel <= 1e-5, f"17c fold-mean RMSE kernel vs plain over {n} rounds: "
          f"rel {rel:.2e}")
    if pc["rounds_run"] >= kc["rounds_run"]:
        check(kc["best_iter"] == pc["best_iter"], f"17c best_iter kernel "
              f"{kc['best_iter']} vs plain {pc['best_iter']}")
        res["compared"] = "best_iter and best_score"
    else:
        check(int(np.argmin(hk[:n])) == int(np.argmin(hp[:n])),
              f"17c: best round of the first {n}")
        res["compared"] = f"the first {n} rounds (plain run cut)"
    res["rmse_rel_diff"] = rel
    log(f"phase 17c: {json.dumps(res)}")
    return res


def covertype_cat(n, seed):
    """Covertype's shape with its two categorical columns: the ten
    quantitative columns, Wilderness_Area (4 categories) and Soil_Type
    (40) as codes, and the class of :func:`covertype_like`."""
    X, y = covertype_like(n, seed)
    wild = np.argmax(X[:, COV_NUMERIC:COV_NUMERIC + COV_WILD], axis=1)
    soil = np.argmax(X[:, COV_NUMERIC + COV_WILD:], axis=1)
    return np.column_stack([X[:, :COV_NUMERIC], wild, soil]).astype(
        np.float32), y


def phase_cat_multiclass(dev, launches):
    """17d: multiclass at Covertype's shape with its two categorical
    columns, 7 classes, 127 leaves (B6 roots, B5 waves)."""
    import lightgbm_tpu_torch as lgb

    Xc, yc = covertype_cat(COV_ROWS, SEED + 120)
    Xv, yv = covertype_cat(COV_VALID_ROWS, SEED + 121)
    ds = lgb.Dataset(Xc, label=yc, categorical_feature=[COV_NUMERIC,
                                                        COV_NUMERIC + 1],
                     params={"max_bin": MAX_BIN})
    ds.construct()
    runs = {}
    for tag, extra in (("kernels", {}), ("plain", {"hist_impl": "plain"})):
        b, secs, counts, plain = counted_run(lambda: lgb.train(
            dict(COV_PARAMS, **extra), ds, CAT_SHORT_ROUNDS))
        runs[tag] = {"s_per_round": secs / CAT_SHORT_ROUNDS,
                     "counts": counts, "plain_calls": plain,
                     "multi_logloss": multi_logloss(b, Xv, yv, dev),
                     "categorical_split_nodes": cat_split_nodes(b)}
        log(f"phase 17d {tag}: {CAT_SHORT_ROUNDS} rounds in {secs:.2f} s, "
            f"multi_logloss {runs[tag]['multi_logloss']:.6f}, launches "
            f"{json.dumps(counts)}, plain calls {plain}")
    k, p = runs["kernels"], runs["plain"]
    check(k["counts"]["hist_fused_batched_bf16"] > 0
          and k["counts"]["hist_segstats_bf16"] > 0 and k["plain_calls"] == 0
          and k["categorical_split_nodes"] > 0, f"17d kernel path (B5 and "
          f"B6): launches {k['counts']}, plain calls {k['plain_calls']}")
    add_launches(launches, k["counts"])
    d_ll = k["multi_logloss"] - p["multi_logloss"]
    check(np.isfinite(k["multi_logloss"]) and abs(d_ll) <= COV_TOL,
          f"17d multi_logloss kernel - plain {d_ll:.2e}")
    out = {"rounds": CAT_SHORT_ROUNDS, **{t: {f: v for f, v in r.items()
                                             if f != "counts"}
                                         for t, r in runs.items()},
           "launches": k["counts"], "multi_logloss_kernel_minus_plain": d_ll}
    log(f"phase 17d: {json.dumps(out)}")
    return out


def phase_cat_int8_goss(ds, launches):
    """17e: 17a's table at ``hist_dtype="int8"`` (B1's int8 mode) and with
    ``boosting="goss"`` (300,000 compacted rows: f32 B1), kernel and plain
    trees equal."""
    import lightgbm_tpu_torch as lgb

    out = {}
    for name, params, b1 in (
            ("int8", dict(TRAIN_PARAMS, hist_dtype="int8"),
             "hist_fused_int8"),
            ("goss", GOSS_PARAMS, "hist_fused_f32")):
        runs = {}
        for tag, extra in (("kernels", {}),
                           ("plain", {"hist_impl": "plain"})):
            b, secs, counts, plain = counted_run(lambda: lgb.train(
                dict(params, **extra), ds, CAT_SHORT_ROUNDS))
            runs[tag] = {"booster": b, "s_per_round": secs /
                         CAT_SHORT_ROUNDS, "counts": counts,
                         "plain_calls": plain}
            log(f"phase 17e {name} {tag}: {CAT_SHORT_ROUNDS} rounds in "
                f"{secs:.2f} s, launches {json.dumps(counts)}, plain calls "
                f"{plain}")
        k = runs["kernels"]
        check(k["counts"][b1] > 0 and k["plain_calls"] == 0
              and k["counts"]["hist_partition_f32"] == 0
              and k["counts"]["hist_partition_bf16"] == 0,
              f"17e {name} kernel path: launches {k['counts']}, plain calls "
              f"{k['plain_calls']}")
        add_launches(launches, k["counts"])
        bk, bp = k.pop("booster"), runs["plain"].pop("booster")
        lv_rel = trees_parity(bk, bp, CAT_SHORT_ROUNDS, f"17e {name}")
        for i in range(CAT_SHORT_ROUNDS):
            a, b = tree_arrays(bk, i), tree_arrays(bp, i)
            check(all(np.array_equal(a[f], b[f])
                      for f in ("is_cat_split", "cat_mask")),
                  f"17e {name}: tree {i}'s subset masks differ")
        out[name] = {"s_per_round": {t: r["s_per_round"]
                                     for t, r in runs.items()},
                     "launches": k["counts"], "leaf_value_rel_diff": lv_rel,
                     "categorical_split_nodes": cat_split_nodes(bk)}
    log(f"phase 17e: {json.dumps(out)}")
    return out


def phase_categorical(dev, workdir, card):
    """Phase 17, every launch counter at 0 just before each run and read
    just after; fails unless B1, B1 int8, B5 and B6 launched on categorical
    data, and B2, B3 and B4 never did."""
    t0 = time.perf_counter()
    launches, secs, out = {}, {}, {}
    t1 = time.perf_counter()
    out["17a"], ds, Xv, yv = phase_cat_airline(dev, workdir, launches)
    secs["17a"] = time.perf_counter() - t1
    for name, fn in (("17b", lambda: phase_cat_strict(dev, ds, Xv, yv,
                                                      launches)),
                     ("17c", lambda: phase_cat_cv(launches)),
                     ("17d", lambda: phase_cat_multiclass(dev, launches)),
                     ("17e", lambda: phase_cat_int8_goss(ds, launches))):
        t1 = time.perf_counter()
        out[name] = fn()
        secs[name] = time.perf_counter() - t1
    del ds
    for name in ("hist_fused_bf16", "hist_fused_int8",
                 "hist_fused_batched_bf16", "hist_segstats_bf16",
                 "hist_segstats_f32"):
        check(launches.get(name, 0) > 0, f"phase 17: {name} never launched")
    for name in ("hist_partition_f32", "hist_partition_bf16", "split_iter",
                 "predict_forest"):
        check(launches.get(name, 0) == 0, f"phase 17: {name} launched "
              f"{launches.get(name)} times on categorical data")
    out["launches"] = launches
    out["s_by_part"] = secs
    out["s"] = time.perf_counter() - t0
    log(f"phase 17: {out['s']:.1f} s ({json.dumps(secs)}) on {card}, "
        f"launches {json.dumps(launches)}")
    return out


# ---------------------------------------------------------------------------
# phase 18: ranking
# ---------------------------------------------------------------------------
def mslr_like(sizes, rng, n_features=MSLR_FEATURES):
    """The reference bench's MSLR-shaped rows for queries of ``sizes``:
    normal features, per-query offsets on five informative columns, a
    nonlinear utility and top-heavy graded labels 0-4 from each query's
    utility ranks (most documents irrelevant, a few highly relevant)."""
    n = int(sizes.sum())
    X = rng.normal(0, 1, (n, n_features)).astype(np.float32)
    qid = np.repeat(np.arange(len(sizes)), sizes)
    qoff = rng.normal(0, 2.0, (len(sizes), 5)).astype(np.float32)
    X[:, :5] += qoff[qid]
    u = (1.5 * X[:, 0] + np.sin(2 * X[:, 1]) + 0.8 * X[:, 2] * X[:, 3]
         + 0.5 * X[:, 4] ** 2 + 0.6 * rng.normal(0, 1, n))
    y = np.zeros(n)
    start = 0
    for s in sizes:
        q = slice(start, start + s)
        r = u[q].argsort().argsort() / (s - 1)
        y[q] = np.digitize(r, [0.55, 0.8, 0.92, 0.98])
        start += s
    return X, y


def make_ranked(n_queries, docs_lo, docs_hi, f, seed):
    """The reference test's ranked data (tests/test_ranking.py): a hidden
    utility, graded labels 0-4 by within-query quantile."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(docs_lo, docs_hi + 1, n_queries)
    n = int(sizes.sum())
    X = rng.normal(0, 1, (n, f))
    u = (1.2 * X[:, 0] + np.sin(2 * X[:, 1]) + 0.6 * X[:, 2] ** 2
         + 0.3 * rng.normal(0, 1, n))
    y = np.zeros(n)
    start = 0
    for s in sizes:
        ranks = u[start:start + s].argsort().argsort()
        y[start:start + s] = np.minimum(4, (5 * ranks) // s)
        start += s
    return X, y, sizes


def lambda_pass(booster, reps=5):
    """The lambda pass (``LambdaRank.grad_hess``) on the booster's train
    scores: CUDA-event ms (median of ``reps``), the profiler's device ms
    and kernel launches of one call, its query chunks, and one call under
    ``torch.cuda.set_sync_debug_mode("error")``, so a host read fails."""
    from torch.profiler import ProfilerActivity, profile

    obj = booster.obj
    args = (booster._pred_train, booster.train_set.y, booster._w_eff)
    obj.grad_hess(*args)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        obj.grad_hess(*args)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        obj.grad_hess(*args)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if getattr(e, "self_device_time_total",
                          getattr(e, "self_cuda_time_total", 0.0)) > 0]
    device_us = sum(getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0.0))
                    for e in kernels)
    torch.cuda.set_sync_debug_mode("error")
    try:
        obj.grad_hess(*args)
        torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    q, g = obj._packed["valid"].shape
    return {"queries": q, "G": g, "query_chunk": obj.query_chunk,
            "chunks": -(-q // obj.query_chunk),
            "route": "uniform" if obj._packed["uniform"] else "ragged",
            "event_ms": float(np.median(times)),
            "device_ms": (device_us / 1e3 if device_us
                          else "not measured (no device time traced)"),
            "launches": int(sum(e.count for e in kernels)),
            "host_reads": 0}


def first_split_difference(a, b):
    """None when two trees' structure agrees, else the first node whose
    split differs with both trees' gains there (a near tie when they are
    within 1e-4 relative: C.1's treatment)."""
    fields = ("split_feature", "split_bin", "left", "right", "is_leaf",
              "num_leaves")
    if all(np.array_equal(a[f], b[f]) for f in fields):
        return None
    diff = np.flatnonzero((a["split_feature"] != b["split_feature"])
                          | (a["split_bin"] != b["split_bin"])
                          | (a["is_leaf"] != b["is_leaf"]))
    i = int(diff[0]) if len(diff) else 0
    # flat over a multiclass round's [K, M] tables
    ga = float(a["split_gain"].reshape(-1)[i])
    gb = float(b["split_gain"].reshape(-1)[i])
    return {"node": i, "gains": [ga, gb],
            "rel": abs(ga - gb) / max(abs(ga), abs(gb), 1e-30)}


def phase_rank_mslr(dev, workdir, launches):
    """18a: the reference bench's MSLR configuration, uncut, on the wave
    grower (B1 roots, B2 waves), kernel and plain paths in turns."""
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.ranking import RankEvalContext
    from lightgbm_tpu_torch.serving import PredictorRuntime, pack_booster

    rng = np.random.default_rng(MSLR_SEED)
    sizes_all = np.full(MSLR_QUERIES + MSLR_VALID_QUERIES, MSLR_DOCS)
    X_all, y_all = mslr_like(sizes_all, rng)
    n = MSLR_QUERIES * MSLR_DOCS
    X, y, sizes = X_all[:n], y_all[:n], sizes_all[:MSLR_QUERIES]
    Xv, yv, sv = X_all[n:], y_all[n:], sizes_all[MSLR_QUERIES:]
    t0 = time.perf_counter()
    ds = lgb.Dataset(X, label=y, group=sizes, params={"max_bin": MAX_BIN})
    ds.construct()
    bin_s = time.perf_counter() - t0
    ctx = RankEvalContext(sv, yv, None, device=dev)
    for extra in ({}, {"hist_impl": "plain"}):                # warm
        lgb.train(dict(MSLR_PARAMS, **extra), ds, 1)
    runs, boosters = {"kernels": [], "plain": []}, {}
    for tag in ("kernels", "plain", "plain", "kernels"):
        params = dict(MSLR_PARAMS, **({"hist_impl": "plain"}
                                      if tag == "plain" else {}))
        b, secs, counts, plain = counted_run(
            lambda: lgb.train(params, ds, MSLR_ROUNDS))
        runs[tag].append({"s_per_round": secs / MSLR_ROUNDS,
                          "counts": counts, "plain_calls": plain})
        boosters.setdefault(tag, b)
        log(f"phase 18a {tag}: {MSLR_ROUNDS} rounds in {secs:.2f} s, "
            f"launches {json.dumps(counts)}, plain calls {plain}")
    k = runs["kernels"][0]
    check(k["counts"]["hist_fused_bf16"] > 0
          and k["counts"]["hist_partition_bf16"] > 0
          and k["plain_calls"] == 0,
          f"18a kernel path (B1 and B2 at bf16): launches {k['counts']}, "
          f"plain calls {k['plain_calls']}")
    add_launches(launches, k["counts"])
    bk, bp = boosters["kernels"], boosters["plain"]
    ndcg = {t: ctx.ndcg(torch.from_numpy(b.predict(Xv)).to(dev), NDCG_K)
            for t, b in boosters.items()}
    d_ndcg = ndcg["kernels"] - ndcg["plain"]
    check(abs(d_ndcg) <= RANK_TOL and 0.0 < ndcg["kernels"] <= 1.0,
          f"18a held-out NDCG@{NDCG_K} kernel {ndcg['kernels']:.6f}, plain "
          f"{ndcg['plain']:.6f}")
    tie = first_split_difference(tree_arrays(bk, 0), tree_arrays(bp, 0))
    check(tie is None or tie["rel"] <= 1e-4,
          f"18a: the round-1 trees of the kernel and plain paths differ "
          f"beyond a near tie: {tie}")
    if tie is not None:
        log(f"phase 18a: round-1 near tie (C.1) kernel vs plain: {tie}")
    b = lgb.Booster(MSLR_PARAMS, ds)
    b.update()
    (_, sites), _, _, _ = counted_run(lambda: host_syncs(
        lambda: [b.update() for _ in range(SYNC_ROUNDS)]))
    lam = lambda_pass(bk)
    breakdown = profile_rounds(lgb, ds, MSLR_PARAMS, tag="phase 18a")
    rt = PredictorRuntime(pack_booster(bk), max_bucket=MAX_BUCKET)
    want = bk.predict(Xv, raw_score=True)
    served, serve_s, counts, _ = counted_run(
        lambda: rt.predict(Xv, raw_score=True))
    sdiff = float(np.abs(served - want).max())
    check(counts["predict_forest"] > 0 and sdiff <= 1e-5,
          f"18a served vs Booster.predict {sdiff:.2e}, B4 launches "
          f"{counts['predict_forest']}")
    add_launches(launches, {"predict_forest": counts["predict_forest"]})
    out = {"rows": n, "queries": MSLR_QUERIES, "docs": MSLR_DOCS,
           "features": MSLR_FEATURES, "rounds": MSLR_ROUNDS,
           "params": MSLR_PARAMS, "binning_s": bin_s,
           "s_per_round_in_turns": {t: [r["s_per_round"] for r in v]
                                    for t, v in runs.items()},
           "launches": k["counts"], f"ndcg@{NDCG_K}_held_out": ndcg,
           "ndcg_kernel_minus_plain": d_ndcg,
           "round1_structure_equal": tie is None, "round1_near_tie": tie,
           "host_syncs_per_round": len(sites) / SYNC_ROUNDS,
           "host_sync_sites": dict(sorted(collections.Counter(
               sites).items())),
           "lambda_pass": lam, "round_breakdown": breakdown,
           "serve": {"rows": len(Xv), "s": serve_s, "max_abs_diff": sdiff,
                     "b4_launches": counts["predict_forest"]}}
    log(f"phase 18a: {json.dumps(out)}")
    return out, ds, (X, y, sizes), (Xv, yv, sv), ctx


def phase_rank_ragged(dev, launches):
    """18b: 1,500 ragged queries (20-220 documents) with 18a's feature and
    label recipe: the gather/scatter route of the lambda pass over several
    query chunks, kernel and plain paths."""
    import lightgbm_tpu_torch as lgb

    rng = np.random.default_rng(SEED + 180)
    sizes = rng.integers(*RAGGED_DOCS, RAGGED_QUERIES)
    X, y = mslr_like(sizes, rng)
    t0 = time.perf_counter()
    ds = lgb.Dataset(X, label=y, group=sizes, params={"max_bin": MAX_BIN})
    ds.construct()
    bin_s = time.perf_counter() - t0
    del X
    params = dict(MSLR_PARAMS, lambdarank_truncation_level=RAGGED_DEPTH,
                  metric="ndcg")
    runs, ndcg = {}, {}
    for tag in ("kernels", "plain"):
        p = dict(params, **({"hist_impl": "plain"} if tag == "plain"
                            else {}))
        b = lgb.Booster(p, ds)
        b.update()                                            # warm
        _, secs, counts, plain = counted_run(
            lambda: [b.update() for _ in range(RAGGED_ROUNDS - 1)])
        runs[tag] = {"s_per_round": secs / (RAGGED_ROUNDS - 1),
                     "counts": counts, "plain_calls": plain}
        ndcg[tag] = b.eval_train()[0][2]
        if tag == "kernels":
            lam = lambda_pass(b)
        log(f"phase 18b {tag}: {json.dumps(runs[tag])}")
    k = runs["kernels"]
    check(k["counts"]["hist_fused_bf16"] > 0
          and k["counts"]["hist_partition_bf16"] > 0
          and k["plain_calls"] == 0,
          f"18b kernel path: launches {k['counts']}, plain calls "
          f"{k['plain_calls']}")
    add_launches(launches, k["counts"])
    d_ndcg = ndcg["kernels"] - ndcg["plain"]
    check(abs(d_ndcg) <= RANK_TOL,
          f"18b NDCG@{NDCG_K} kernel {ndcg['kernels']:.6f}, plain "
          f"{ndcg['plain']:.6f}")
    check(lam["route"] == "ragged" and lam["chunks"] > 1,
          f"18b lambda pass {lam}")
    out = {"rows": int(sizes.sum()), "queries": RAGGED_QUERIES,
           "docs": list(RAGGED_DOCS), "rounds": RAGGED_ROUNDS,
           "binning_s": bin_s,
           "s_per_round": {t: r["s_per_round"] for t, r in runs.items()},
           "launches": k["counts"], f"ndcg@{NDCG_K}_train": ndcg,
           "ndcg_kernel_minus_plain": d_ndcg, "lambda_pass": lam}
    log(f"phase 18b: {json.dumps(out)}")
    return out


def reference_query_folds(sizes, n, nfold, seed):
    """The reference's whole-query folds (engine._make_folds with groups),
    written out here: a seeded permutation of the queries, every nfold-th
    to one fold."""
    rng = np.random.default_rng(seed)
    gidx = rng.permutation(len(sizes))
    bounds = np.concatenate([[0], np.cumsum(sizes)])
    out = []
    for k in range(nfold):
        test = np.concatenate([np.arange(bounds[g], bounds[g + 1])
                               for g in gidx[k::nfold]])
        mask = np.zeros(n, bool)
        mask[test] = True
        out.append((np.flatnonzero(~mask), np.flatnonzero(mask)))
    return out


def phase_rank_cv(launches):
    """18c: group-aware cv() at the reference test's make_ranked shape on
    the strict grower (B1, B3), kernel and plain paths."""
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.engine import _make_folds

    X, y, sizes = make_ranked(RANK_CV_QUERIES, 8, 24, 6, SEED + 181)
    n = len(y)
    want = reference_query_folds(sizes, n, RANK_CV_FOLDS, RANK_CV_SEED)
    got = _make_folds(n, RANK_CV_FOLDS, y, False, True, RANK_CV_SEED, sizes)
    check(all(np.array_equal(a, c) and np.array_equal(b, d)
              for (a, b), (c, d) in zip(want, got)),
          "18c: the whole-query folds differ from the reference's")
    ds = lgb.Dataset(X, label=y, group=sizes)
    res = {}
    for tag in ("kernels", "plain"):
        p = dict(RANK_CV_PARAMS, **({"hist_impl": "plain"} if tag == "plain"
                                    else {}))
        r, secs, counts, plain = counted_run(lambda: lgb.cv(
            p, ds, RANK_CV_ROUNDS, nfold=RANK_CV_FOLDS,
            early_stopping_rounds=RANK_CV_ES, seed=RANK_CV_SEED,
            return_cvbooster=True))
        res[tag] = {"result": r, "s": secs, "counts": counts,
                    "plain_calls": plain}
        log(f"phase 18c {tag}: {secs:.2f} s, best_iter {r.best_iter}, "
            f"launches {json.dumps(counts)}, plain calls {plain}")
    rk, rp = res["kernels"]["result"], res["plain"]["result"]
    counts = res["kernels"]["counts"]
    check(counts["split_iter"] > 0 and res["kernels"]["plain_calls"] == 0,
          f"18c kernel path: launches {counts}")
    add_launches(launches, counts)
    key = "valid ndcg@5-mean"
    mk, mp = np.asarray(rk[key]), np.asarray(rp[key])
    check(rk.best_iter == rp.best_iter and len(mk) == len(mp)
          and float(np.abs(mk - mp).max()) <= 1e-5,
          f"18c cv kernel vs plain: best_iter {rk.best_iter} / "
          f"{rp.best_iter}, means {mk.tolist()} / {mp.tolist()}")
    for b, (tr, _) in zip(rk.cvbooster.boosters, want):
        check(int(b.train_set.get_group().sum()) == len(tr),
              "18c: a fold's query groups do not cover its rows")
    out = {"rows": n, "queries": RANK_CV_QUERIES, "folds": RANK_CV_FOLDS,
           "best_iter": rk.best_iter, "best_score": rk.best_score,
           "mean_max_abs_diff": float(np.abs(mk - mp).max()),
           "s": {t: r["s"] for t, r in res.items()}, "launches": counts}
    log(f"phase 18c: {json.dumps(out)}")
    return out


def phase_rank_ranker_recovery(dev, workdir, ds, train, valid, ctx,
                               launches):
    """18d: LGBMRanker on 18a's data, its text model reloaded and served
    (B4); then a 12-round lambdarank train_resumable killed by SIGTERM
    after round index 6 and resumed, bit for bit as the uninterrupted
    run."""
    import shutil
    import signal

    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.serving import PredictorRuntime, pack_booster
    from lightgbm_tpu_torch.training import train_resumable

    X, y, sizes = train
    Xv, yv, sv = valid
    kw = {k: v for k, v in MSLR_PARAMS.items()
          if k not in ("objective", "num_leaves", "learning_rate",
                       "min_data_in_leaf", "eval_at")}
    est = lgb.LGBMRanker(n_estimators=RANKER_ROUNDS, num_leaves=63,
                         learning_rate=0.1, min_child_samples=20, **kw)
    (_, fit_s, counts, _) = counted_run(lambda: est.fit(
        X, y, group=sizes, eval_set=[(Xv, yv)], eval_group=[sv],
        eval_at=[NDCG_K]))
    add_launches(launches, counts)
    got = est.best_score_["valid_0"][f"ndcg@{NDCG_K}"]
    direct = ctx.ndcg(torch.from_numpy(est.predict(Xv)).to(dev), NDCG_K)
    check(abs(got - direct) <= RANK_TOL and 0.0 < got <= 1.0,
          f"18d LGBMRanker valid NDCG@{NDCG_K} {got} vs its predictions' "
          f"{direct}")
    path = os.path.join(workdir, "ranker.txt")
    est.booster_.save_model(path)
    back = lgb.Booster(model_file=path)
    want = back.predict(Xv, raw_score=True)
    rdiff = float(np.abs(want - est.predict(Xv, raw_score=True)).max())
    rt = PredictorRuntime(pack_booster(back), max_bucket=MAX_BUCKET)
    served, _, scounts, _ = counted_run(lambda: rt.predict(Xv,
                                                           raw_score=True))
    sdiff = float(np.abs(served - want).max())
    check(rdiff <= 1e-5 and sdiff <= 1e-5 and scounts["predict_forest"] > 0,
          f"18d ranker reloaded {rdiff:.2e}, served {sdiff:.2e}, B4 "
          f"{scounts['predict_forest']}")
    add_launches(launches, {"predict_forest": scounts["predict_forest"]})
    root = os.path.join(workdir, "rank_recovery")
    shutil.rmtree(root, ignore_errors=True)
    full_dir, kill_dir = (os.path.join(root, d) for d in ("full", "killed"))
    rkw = dict(checkpoint_rounds=RECOVERY_EVERY, keep_last=3)
    params = dict(MSLR_PARAMS, bagging_fraction=0.8, bagging_freq=1)

    def kill(booster, i):
        if i == RECOVERY_KILL_AFTER:
            os.kill(os.getpid(), signal.SIGTERM)

    def training():
        full = train_resumable(dict(params), ds, RECOVERY_ROUNDS,
                               checkpoint_dir=full_dir, resume=False, **rkw)
        killed = train_resumable(dict(params), ds, RECOVERY_ROUNDS,
                                 checkpoint_dir=kill_dir, resume=False,
                                 round_callbacks=[kill], **rkw)
        again = train_resumable(dict(params), ds, RECOVERY_ROUNDS,
                                checkpoint_dir=kill_dir, resume=True, **rkw)
        return full, killed, again

    (full, killed, again), rec_s, rcounts, _ = counted_run(training)
    add_launches(launches, rcounts)
    check(killed.preempted and killed.rounds_done == RECOVERY_KILL_AFTER + 1
          and again.completed and again.resumed_from == killed.last_checkpoint,
          f"18d SIGTERM then resume: {killed}, {again}")
    check(same_run(full.booster, again.booster),
          "18d: the resumed lambdarank run differs from the uninterrupted "
          "one")
    s_full, s_again = (PredictorRuntime(pack_booster(b.booster),
                                        max_bucket=MAX_BUCKET).predict(
        Xv, raw_score=True) for b in (full, again))
    check(np.array_equal(s_full, s_again),
          "18d: the resumed model serves other scores")
    out = {"ranker": {"rounds": RANKER_ROUNDS, "fit_s": fit_s,
                      f"valid_ndcg@{NDCG_K}": got,
                      "reloaded_max_abs_diff": rdiff,
                      "served_max_abs_diff": sdiff,
                      "b4_launches": scounts["predict_forest"]},
           "recovery": {"rounds": RECOVERY_ROUNDS,
                        "preempted_at": killed.rounds_done,
                        "bit_identical": True, "s": rec_s,
                        "launches": rcounts}}
    log(f"phase 18d: {json.dumps(out)}")
    return out


def phase_ranking(dev, workdir, card):
    """Phase 18, every launch counter at 0 just before each run and read
    just after; fails unless B1, B2, B3 and B4 launched."""
    t0 = time.perf_counter()
    launches, secs, out = {}, {}, {}
    t1 = time.perf_counter()
    out["18a"], ds, train, valid, ctx = phase_rank_mslr(dev, workdir,
                                                        launches)
    secs["18a"] = time.perf_counter() - t1
    for name, fn in (("18b", lambda: phase_rank_ragged(dev, launches)),
                     ("18c", lambda: phase_rank_cv(launches)),
                     ("18d", lambda: phase_rank_ranker_recovery(
                         dev, workdir, ds, train, valid, ctx, launches))):
        t1 = time.perf_counter()
        out[name] = fn()
        secs[name] = time.perf_counter() - t1
    del ds
    for name in ("hist_fused_bf16", "hist_partition_bf16", "split_iter",
                 "predict_forest"):
        check(launches.get(name, 0) > 0, f"phase 18: {name} never launched")
    out["launches"] = launches
    out["s_by_part"] = secs
    out["s"] = time.perf_counter() - t0
    log(f"phase 18: {out['s']:.1f} s ({json.dumps(secs)}) on {card}, "
        f"launches {json.dumps(launches)}")
    return out


# ---------------------------------------------------------------------------
# phase 19: constraints and randomized splits
# ---------------------------------------------------------------------------
def overgrown_tables(fn):
    """``fn()`` and the packed node tables every exact-tail wave tree held
    before its prune (bounds included), read back to the host."""
    import lightgbm_tpu_torch.models.tree as T

    orig, tables = T._exact_prune, []

    def spy(P, *a, **k):
        tables.append(P.detach().cpu().numpy().copy())
        return orig(P, *a, **k)

    T._exact_prune = spy
    try:
        out = fn()
    finally:
        T._exact_prune = orig
    return out, tables


def monotone_sweep(booster, rows, mono):
    """Each of ``rows`` (binned, on the card) swept over every bin of each
    constrained column: the steps of the raw score against the column's
    sign; the smallest step per column (never below 0 when monotone).  The
    forest is summed in one fixed order for every row, and f32 rounding is
    monotone, so the check is exact."""
    from lightgbm_tpu_torch.ops.predict import predict_forest_binned

    forest = booster._stacked_forest()
    n_bins = booster.train_set.bin_mapper.n_bins
    out = {}
    for f, sign in enumerate(mono):
        if sign == 0:
            continue
        nb = int(n_bins[f])
        grid = rows.repeat_interleave(nb, dim=0)
        grid[:, f] = torch.arange(nb, device=rows.device,
                                  dtype=grid.dtype).repeat(rows.shape[0])
        raw = predict_forest_binned(
            forest, grid, booster._shrink, float(booster.init_score_),
            len(booster.trees), booster._depth_cap).reshape(-1, nb)
        step = torch.diff(raw.double(), dim=1) * sign
        out[f] = float(step.min())
    return out


def paths_outside_groups(booster, groups):
    """The root-to-leaf paths of the forest that split on columns of more
    than one interaction group."""
    from lightgbm_tpu_torch.models.tree import tree_to_arrays

    bad = 0
    for t in booster.trees:
        a = tree_to_arrays(t)
        stack = [(0, frozenset())]
        while stack:
            node, used = stack.pop()
            if a["is_leaf"][node] or a["left"][node] < 0:
                bad += not any(used <= set(g) for g in groups)
                continue
            used = used | {int(a["split_feature"][node])}
            stack += [(int(a["left"][node]), used),
                      (int(a["right"][node]), used)]
    return bad


def dyadic_label(X, seed):
    """y in {0, 1} with exactly half ones: every round-1 l2 statistic is
    +-0.5 or 1, so every histogram sum is exact on both paths."""
    w = np.random.default_rng(seed).normal(0, 1, X.shape[1])
    order = np.argsort(X @ w + 0.6 * np.sin(X[:, 0] * 2), kind="stable")
    yd = np.zeros(len(X), np.float32)
    yd[order[len(X) // 2:]] = 1.0
    return yd


def constrained_runs(lgb, ds, params, dsd, tag, launches, Xv, yv, dev):
    """One option at the north star: kernel and plain paths (6 rounds
    each, the kernel path first), AUC, and the dyadic round-1 trees and
    overgrown tables (bounds included) of both paths."""
    runs, boosters = {}, {}
    for path, extra in (("kernels", {}), ("plain", {"hist_impl": "plain"})):
        b, secs, counts, plain = counted_run(
            lambda: lgb.train(dict(params, **extra), ds, LATE_ROUNDS))
        runs[path] = {"s_per_round": secs / LATE_ROUNDS, "counts": counts,
                      "plain_calls": plain, "auc": auc(b, Xv, yv, dev)}
        boosters[path] = b
        log(f"phase {tag} {path}: {LATE_ROUNDS} rounds in {secs:.2f} s, "
            f"AUC {runs[path]['auc']:.6f}, launches {json.dumps(counts)}, "
            f"plain calls {plain}")
    k = runs["kernels"]
    check(k["counts"]["hist_fused_bf16"] == LATE_ROUNDS
          and k["counts"]["hist_partition_bf16"] > LATE_ROUNDS
          and k["plain_calls"] == 0 and k["counts"]["split_iter"] == 0,
          f"{tag} kernel path (B1 roots, B2 waves): launches {k['counts']},"
          f" plain calls {k['plain_calls']}")
    check(sum(v for n, v in runs["plain"]["counts"].items()
              if n.startswith("hist_")) == 0,
          f"{tag}: hist_impl='plain' launched a histogram kernel")
    add_launches(launches, k["counts"])
    d_auc = k["auc"] - runs["plain"]["auc"]
    check(abs(d_auc) <= AUC_TOL, f"{tag} AUC kernel - plain {d_auc:.2e}")
    pd_ = dict(params, objective="regression", hist_dtype="f32")
    dy = {}
    for path, extra in (("kernels", {}), ("plain", {"hist_impl": "plain"})):
        b, tables = overgrown_tables(
            lambda: lgb.train(dict(pd_, **extra), dsd, 1))
        dy[path] = (tree_arrays(b, 0), tables)
    (a, ta), (b, tb) = dy["kernels"], dy["plain"]
    check(a.keys() == b.keys() and all(np.array_equal(a[f], b[f])
                                       for f in a),
          f"{tag}: the dyadic round-1 trees of the kernel and plain paths "
          "differ")
    check(len(ta) == len(tb) == 1 and np.array_equal(ta[0], tb[0]),
          f"{tag}: the dyadic overgrown tables (bounds included) differ")
    out = {"s_per_round": {p: r["s_per_round"] for p, r in runs.items()},
           "auc": {p: r["auc"] for p, r in runs.items()},
           "auc_kernel_minus_plain": d_auc, "launches": k["counts"],
           "dyadic_round1_equal": True,
           "dyadic_leaves": int(a["num_leaves"])}
    return out, boosters, ta[0]


def phase_mono_north_star(dev, ds, dsd, Xv, yv, workdir, launches,
                          unconstrained):
    """19a and 19f: the north star with monotone constraints, its sweep,
    a profiled round, and the model served by B4."""
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.models.tree import _PK
    from lightgbm_tpu_torch.serving import PredictorRuntime, pack_booster

    params = dict(TRAIN_PARAMS, monotone_constraints=MONO_NS)
    out, boosters, table = constrained_runs(lgb, ds, params, dsd, "19a",
                                            launches, Xv, yv, dev)
    bounded = int(np.isfinite(table[:, _PK.BOUND_LO]).sum()
                  + np.isfinite(table[:, _PK.BOUND_HI]).sum())
    check(bounded > 0, "19a: no bounded node in the dyadic tree")
    rows = ds.bin_mapper.transform(Xv[:MONO_SWEEP_ROWS])
    rows = torch.from_numpy(rows).to(dev)
    sweeps = {p: monotone_sweep(b, rows, MONO_NS)
              for p, b in boosters.items()}
    check(all(v >= 0 for s in sweeps.values() for v in s.values()),
          f"19a: the raw score moves against a constraint: {sweeps}")
    out["sweep_min_step"] = sweeps
    out["bounded_dyadic_nodes"] = bounded
    out["unconstrained_s_per_round"] = unconstrained
    # the monotone round against an unconstrained one on this Dataset, in
    # turns (unconstrained, monotone, monotone, unconstrained)
    turns = {"unconstrained": [], "monotone": []}
    for tag in ("unconstrained", "monotone", "monotone", "unconstrained"):
        p = params if tag == "monotone" else TRAIN_PARAMS
        secs = counted_run(lambda: lgb.train(p, ds, LATE_ROUNDS))[1]
        turns[tag].append(secs / LATE_ROUNDS)
    out["s_per_round_in_turns"] = turns
    out["round_breakdown"] = profile_rounds(lgb, ds, params,
                                            tag="phase 19a")
    # 19f: served by B4
    bk = boosters["kernels"]
    rt = PredictorRuntime(pack_booster(bk), max_bucket=MAX_BUCKET)
    served, serve_s, counts, _ = counted_run(
        lambda: rt.predict(Xv[:MONO_SERVE_ROWS]))
    want = bk.predict(Xv[:MONO_SERVE_ROWS])
    sdiff = float(np.abs(served - want).max())
    check(counts["predict_forest"] > 0, f"19f: B4 never launched ({counts})")
    check(sdiff <= 1e-5, f"19f served vs Booster.predict {sdiff:.2e}")
    add_launches(launches, counts)
    out["serve"] = {"rows": MONO_SERVE_ROWS, "s": serve_s,
                    "max_abs_diff": sdiff,
                    "b4_launches": counts["predict_forest"]}
    log(f"phase 19a/f: {json.dumps(out)}")
    return out


def phase_extra_trees_north_star(dev, ds, dsd, Xv, yv, launches):
    """19b: extra-trees at the north star; its rand-bin table on the card
    against the CPU's, and its host syncs against an unconstrained
    round's."""
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.models.gbdt import (extra_trees_col_bins,
                                                resolve_wave_width)
    from lightgbm_tpu_torch.models.tree import (decode_wave_width,
                                                rand_bin_table)
    from lightgbm_tpu_torch.utils.random import key_tensor

    params = dict(TRAIN_PARAMS, extra_trees=True)
    out, _, _ = constrained_runs(lgb, ds, params, dsd, "19b", launches, Xv,
                                 yv, dev)
    # the table a round draws (the exact tail's overgrown capacity)
    b = lgb.Booster(params, ds)
    _, _, over = decode_wave_width(resolve_wave_width(
        b.params, int(ds.row_mask.shape[0])))
    cap = 2 * max(NUM_LEAVES + 1, int(over or 0)) - 1
    colb = torch.tensor(extra_trees_col_bins(ds.bin_mapper))
    keys = [b._round_key(i) for i in range(LATE_ROUNDS)]
    card = rand_bin_table(key_tensor(keys, dev), NUM_FEATURES, MAX_BIN + 1,
                          colb.to(dev), cap)
    cpu = rand_bin_table(key_tensor(keys, "cpu"), NUM_FEATURES,
                         MAX_BIN + 1, colb, cap)
    check(torch.equal(card.cpu(), cpu),
          "19b: the rand-bin table on the card differs from the CPU's")
    syncs = {"extra_trees": syncs_per_round(lgb, params, ds),
             "unconstrained": syncs_per_round(lgb, TRAIN_PARAMS, ds)}
    se, su = syncs["extra_trees"], syncs["unconstrained"]
    check(set(se["sites"]) <= set(su["sites"])
          and se["syncs_per_round"] - se["waves_per_round"]
          <= su["syncs_per_round"] - su["waves_per_round"],
          f"19b host syncs: extra_trees {se}, unconstrained {su}")
    out["rand_bin_table"] = {"shape": list(cpu.shape), "equal_cpu": True}
    out["host_syncs"] = syncs
    log(f"phase 19b: {json.dumps(out)}")
    return out


def phase_interaction_north_star(dev, ds, dsd, Xv, yv, launches):
    """19c: four interaction groups of seven columns at the north star."""
    import lightgbm_tpu_torch as lgb

    params = dict(TRAIN_PARAMS, interaction_constraints=IC_GROUPS)
    out, boosters, _ = constrained_runs(lgb, ds, params, dsd, "19c",
                                        launches, Xv, yv, dev)
    bad = {p: paths_outside_groups(b, IC_GROUPS)
           for p, b in boosters.items()}
    check(not any(bad.values()), f"19c: paths across groups {bad}")
    out["paths_across_groups"] = bad
    log(f"phase 19c: {json.dumps(out)}")
    return out


def advanced_features_data():
    """examples/advanced_features.py's data: seed 7, 5,000 rows x 5, the
    first 4,000 for training."""
    rng = np.random.default_rng(7)
    n = 5000
    X = rng.normal(size=(n, 5)).astype(np.float32)
    y = (1.2 * X[:, 0] - 0.8 * X[:, 1]
         + np.where(X[:, 2] > 0, 2.0 * X[:, 2], 0.3 * X[:, 2])
         + 0.1 * rng.normal(size=n)).astype(np.float32)
    return X, y


def split_iteration_events(fn):
    """``fn()`` with CUDA events around every call of the unfused strict
    body's split scan (``split_iter_plain``) and around the whole call:
    (result, scan ms per call, calls, total event ms)."""
    import lightgbm_tpu_torch.models.tree as T

    orig, pairs = T.split_iter_plain, []

    def timed(*a, **k):
        s, e = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        s.record()
        out = orig(*a, **k)
        e.record()
        pairs.append((s, e))
        return out

    T.split_iter_plain = timed
    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    try:
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
    finally:
        T.split_iter_plain = orig
    scan = [s.elapsed_time(e) for s, e in pairs]
    return (out, float(np.mean(scan)) if scan else 0.0, len(scan),
            start.elapsed_time(end))


def phase_advanced_features(dev, launches):
    """19d: examples/advanced_features.py's monotone call (its data, its
    params, 60 rounds) as the script calls it, and again on the strict
    grower (``grow_policy="leafwise"``): the example's 4,000 rows pad to
    4,096, which takes the wave grower by the default rule."""
    import lightgbm_tpu_torch as lgb

    X, y = advanced_features_data()
    tr, te = slice(0, 4000), slice(4000, None)
    params = {"objective": "regression", "verbosity": -1,
              "monotone_constraints": [1, -1, 0, 0, 0]}
    out = {}
    for grower, extra, rounds in (
            ("as_called", {}, ADV_ROUNDS),
            ("strict", {"grow_policy": "leafwise"}, ADV_STRICT_ROUNDS)):
        res = {}
        for path, imp in (("kernels", {}), ("plain", {"hist_impl": "plain"})):
            ds = lgb.Dataset(X[tr], label=y[tr])
            skip = ("split_iter_plain",) if grower == "strict" else ()
            (b, scan_ms, scans, ev_ms), secs, counts, plain = counted_run(
                lambda: split_iteration_events(lambda: lgb.train(
                    dict(params, **extra, **imp), ds, rounds)),
                skip=skip)
            pred = b.predict(X[te])
            rmse_ = float(np.sqrt(np.mean((pred.astype(np.float64)
                                           - y[te]) ** 2)))
            splits = sum(int(t.num_leaves) - 1 for t in b.trees)
            res[path] = {"s": secs, "rmse": rmse_, "counts": counts,
                         "plain_calls": plain, "split_iterations": splits,
                         "event_ms": ev_ms,
                         "event_ms_per_split_iteration": ev_ms / splits,
                         "scan_event_ms_per_call": scan_ms,
                         "scan_calls": scans, "booster": b}
            log(f"phase 19d {grower} {path}: {rounds} rounds in "
                f"{secs:.2f} s, RMSE {rmse_:.7f}, launches "
                f"{json.dumps(counts)}, plain calls {plain}, "
                f"{ev_ms / splits:.3f} event ms a split iteration")
        k = res["kernels"]
        check(k["plain_calls"] == 0 and k["counts"]["split_iter"] == 0,
              f"19d {grower}: plain calls {k['plain_calls']}, B3 launched "
              f"{k['counts']['split_iter']} times")
        if grower == "strict":
            check(k["counts"]["hist_fused_f32"] >= rounds
                  and k["scan_calls"] > 0,
                  f"19d strict: B1 pairs {k['counts']}")
        else:
            check(k["counts"]["hist_partition_f32"] > 0,
                  f"19d as called: B2 never launched {k['counts']}")
        add_launches(launches, k["counts"])
        d = k["rmse"] - res["plain"]["rmse"]
        check(abs(d) <= 1e-5, f"19d {grower}: RMSE kernel - plain {d:.2e}")
        sweep = monotone_sweep(k["booster"], torch.from_numpy(
            k["booster"].train_set.bin_mapper.transform(X[te])).to(dev),
            params["monotone_constraints"])
        check(all(v >= 0 for v in sweep.values()),
              f"19d {grower}: the raw score moves against a constraint "
              f"{sweep}")
        out[grower] = {p: {f: v for f, v in r.items() if f != "booster"}
                       for p, r in res.items()}
        out[grower]["rounds"] = rounds
        out[grower]["rmse_kernel_minus_plain"] = d
        out[grower]["sweep_min_step"] = sweep
    log(f"phase 19d: {json.dumps(out)}")
    return out


def phase_mono_multiclass(dev, Xc, yc, launches):
    """19e: multiclass at Covertype's shape with its first column
    constrained, 3 rounds (B6 roots, B5 waves)."""
    import lightgbm_tpu_torch as lgb

    Xv, yv = covertype_like(COV_VALID_ROWS, SEED + 121)
    ds = lgb.Dataset(Xc, label=yc, params={"max_bin": MAX_BIN})
    ds.construct()                  # binned before the timed runs
    mono = [1] + [0] * (Xc.shape[1] - 1)
    params = dict(COV_PARAMS, monotone_constraints=mono)
    runs = {}
    for path, extra in (("kernels", {}), ("plain", {"hist_impl": "plain"})):
        b, secs, counts, plain = counted_run(
            lambda: lgb.train(dict(params, **extra), ds, MONO_MC_ROUNDS))
        runs[path] = {"s_per_round": secs / MONO_MC_ROUNDS,
                      "counts": counts, "plain_calls": plain,
                      "multi_logloss": multi_logloss(b, Xv, yv, dev)}
        log(f"phase 19e {path}: {MONO_MC_ROUNDS} rounds in {secs:.2f} s, "
            f"multi_logloss {runs[path]['multi_logloss']:.6f}, launches "
            f"{json.dumps(counts)}")
    k = runs["kernels"]
    check(k["counts"]["hist_fused_batched_bf16"] > 0
          and k["plain_calls"] == 0,
          f"19e kernel path (B5): launches {k['counts']}, plain calls "
          f"{k['plain_calls']}")
    add_launches(launches, k["counts"])
    d = k["multi_logloss"] - runs["plain"]["multi_logloss"]
    check(abs(d) <= COV_TOL, f"19e multi_logloss kernel - plain {d:.2e}")
    out = {"rounds": MONO_MC_ROUNDS,
           **{p: {f: v for f, v in r.items() if f != "counts"}
              for p, r in runs.items()},
           "launches": k["counts"], "multi_logloss_kernel_minus_plain": d}
    log(f"phase 19e: {json.dumps(out)}")
    return out


def phase_constraints(dev, X, y, Xc, yc, workdir, card, unconstrained):
    """Phase 19, every launch counter at 0 just before each run and read
    just after; fails unless B1, B2, B4 and B5 launched and B3 did not."""
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.utils.datasets import make_higgs_like

    t0 = time.perf_counter()
    launches, secs, out = {}, {}, {}
    Xv, yv = make_higgs_like(VALID_ROWS, NUM_FEATURES, seed=9)
    t1 = time.perf_counter()
    ds = lgb.Dataset(X, label=y, params={"max_bin": MAX_BIN})
    ds.construct()
    dsd = lgb.Dataset(X, label=dyadic_label(X, SEED + 190), reference=ds)
    dsd.construct()
    secs["binning"] = time.perf_counter() - t1
    for name, fn in (
            ("19a", lambda: phase_mono_north_star(
                dev, ds, dsd, Xv, yv, workdir, launches, unconstrained)),
            ("19b", lambda: phase_extra_trees_north_star(
                dev, ds, dsd, Xv, yv, launches)),
            ("19c", lambda: phase_interaction_north_star(
                dev, ds, dsd, Xv, yv, launches)),
            ("19d", lambda: phase_advanced_features(dev, launches)),
            ("19e", lambda: phase_mono_multiclass(dev, Xc, yc, launches))):
        t1 = time.perf_counter()
        out[name] = fn()
        secs[name] = time.perf_counter() - t1
    del ds, dsd
    for name in ("hist_fused_bf16", "hist_partition_bf16", "hist_fused_f32",
                 "hist_fused_batched_bf16", "predict_forest"):
        check(launches.get(name, 0) > 0, f"phase 19: {name} never launched")
    check(launches.get("split_iter", 0) == 0,
          f"phase 19: B3 launched {launches.get('split_iter')} times")
    out["launches"] = launches
    out["s_by_part"] = secs
    out["s"] = time.perf_counter() - t0
    log(f"phase 19: {out['s']:.1f} s ({json.dumps(secs)}) on {card}, "
        f"launches {json.dumps(launches)}")
    return out


def event_timed(module, name, fn):
    """``fn()`` with CUDA events around every call of ``module.name``:
    (result, median event ms per call, calls)."""
    out, ms = calls_event_ms(module, name, fn)
    return out, (float(np.median(ms)) if ms else 0.0), len(ms)


def calls_event_ms(module, name, fn):
    """``fn()`` with CUDA events around every call of ``module.name``:
    (result, the event ms of each call in order)."""
    orig, pairs = getattr(module, name), []

    def timed(*a, **k):
        s, e = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        s.record()
        try:
            return orig(*a, **k)
        finally:
            e.record()
            pairs.append((s, e))

    setattr(module, name, timed)
    try:
        out = fn()
        torch.cuda.synchronize()
    finally:
        setattr(module, name, orig)
    return out, [s.elapsed_time(e) for s, e in pairs]


def phase_linear_north_star(dev, X, y, Xv, yv, launches, constant_s):
    """20a: linear leaves at the north star, 6 rounds through the kernels
    and the plain versions in turns (B1 roots, B2 waves, then the fit)."""
    import lightgbm_tpu_torch as lgb
    import lightgbm_tpu_torch.models.gbdt as G

    ds = lgb.Dataset(X, label=y, params={"max_bin": MAX_BIN,
                                         "enable_bundle": False})
    ds.construct()
    dsd = lgb.Dataset(X, label=dyadic_label(X, SEED + 200), reference=ds)
    dsd.construct()
    params = dict(TRAIN_PARAMS, linear_tree=True)
    runs, boosters = {}, {}
    for path, extra in (("kernels", {}), ("plain", {"hist_impl": "plain"}),
                        ("plain", {"hist_impl": "plain"}), ("kernels", {})):
        if path in runs:
            # the second of each pair is timed only
            secs = counted_run(lambda: lgb.train(
                dict(params, **extra), ds, LATE_ROUNDS))[1]
            runs[path]["s_per_round_turns"].append(secs / LATE_ROUNDS)
            continue
        (b, fit_ms, fits), secs, counts, plain = counted_run(
            lambda: event_timed(G, "fit_linear_leaves", lambda: lgb.train(
                dict(params, **extra), ds, LATE_ROUNDS)))
        runs[path] = {"s_per_round": secs / LATE_ROUNDS,
                      "s_per_round_turns": [secs / LATE_ROUNDS],
                      "counts": counts, "plain_calls": plain,
                      "fit_event_ms_per_round": fit_ms, "fits": fits,
                      "auc": auc(b, Xv, yv, dev)}
        boosters[path] = b
        log(f"phase 20a {path}: {LATE_ROUNDS} rounds in {secs:.2f} s, "
            f"AUC {runs[path]['auc']:.6f}, fit {fit_ms:.3f} event ms a "
            f"round, launches {json.dumps(counts)}, plain calls {plain}")
    k = runs["kernels"]
    check(k["counts"]["hist_fused_bf16"] == LATE_ROUNDS
          and k["counts"]["hist_partition_bf16"] > LATE_ROUNDS
          and k["plain_calls"] == 0 and k["counts"]["split_iter"] == 0
          and k["fits"] == LATE_ROUNDS,
          f"20a kernel path (B1 roots, B2 waves): launches {k['counts']}, "
          f"plain calls {k['plain_calls']}, fits {k['fits']}")
    check(sum(v for n, v in runs["plain"]["counts"].items()
              if n.startswith("hist_")) == 0,
          "20a: hist_impl='plain' launched a histogram kernel")
    check(boosters["kernels"].trees[0].linear_feat is not None,
          "20a: the trees carry no linear leaves")
    add_launches(launches, k["counts"])
    d_auc = k["auc"] - runs["plain"]["auc"]
    check(abs(d_auc) <= AUC_TOL, f"20a AUC kernel - plain {d_auc:.2e}")
    pd_ = dict(params, objective="regression", hist_dtype="f32")
    dy = {}
    for path, extra in (("kernels", {}), ("plain", {"hist_impl": "plain"})):
        dy[path] = tree_arrays(lgb.train(dict(pd_, **extra), dsd, 1), 0)
    a, b = dy["kernels"], dy["plain"]
    check("linear_coef" in a and a.keys() == b.keys()
          and all(np.array_equal(a[f], b[f]) for f in a),
          "20a: the dyadic round-1 linear trees of the kernel and plain "
          "paths differ")
    # host syncs: a linear round beside a constant-leaf round, and one
    # round whose fit runs under the sync debug mode "error"
    syncs = {"linear": syncs_per_round(lgb, params, ds),
             "constant": syncs_per_round(lgb, TRAIN_PARAMS, ds)}
    guarded = lgb.Booster(params, ds)
    guarded.update()
    check(round_without_host_reads(guarded, G, "fit_linear_leaves") == 1,
          "20a: the fit did not run under the sync debug mode")
    check(syncs["linear"]["syncs_per_round"]
          - syncs["linear"]["waves_per_round"]
          <= syncs["constant"]["syncs_per_round"]
          - syncs["constant"]["waves_per_round"],
          f"20a: the linear round adds host syncs {syncs}")
    # the constant-leaf counterpart (TreeSHAP and introspection run on it)
    const, const_s, _, _ = counted_run(
        lambda: lgb.train(TRAIN_PARAMS, ds, LATE_ROUNDS))
    out = {"s_per_round": {p: r["s_per_round"] for p, r in runs.items()},
           "s_per_round_turns": {p: r["s_per_round_turns"]
                                 for p, r in runs.items()},
           "constant_s_per_round": const_s / LATE_ROUNDS,
           "phase6_constant_s_per_round": constant_s,
           "fit_event_ms_per_round": {p: r["fit_event_ms_per_round"]
                                      for p, r in runs.items()},
           "auc": {p: r["auc"] for p, r in runs.items()},
           "auc_kernel_minus_plain": d_auc, "launches": k["counts"],
           "dyadic_round1_equal": True,
           "dyadic_leaves": int(a["num_leaves"]), "host_syncs": syncs,
           "fit_under_sync_error": True}
    log(f"phase 20a: {json.dumps(out)}")
    return out, const, ds


def phase_linear_example(dev, workdir, launches):
    """20b and 20e: examples/advanced_features.py's linear call (seed 7,
    4,000 rows, 8 leaves, 25 rounds: the strict grower, B1 pairs and B3)
    beside its constant-leaf twin, kernel and plain paths; its model
    through the text model, and ``pack_booster``'s refusal."""
    import lightgbm_tpu_torch as lgb
    import lightgbm_tpu_torch.models.gbdt as G
    import lightgbm_tpu_torch.models.tree as T
    from lightgbm_tpu_torch.serving import pack_booster

    X, y = advanced_features_data()
    tr, te = slice(0, 4000), slice(4000, None)
    lin = {"objective": "regression", "verbosity": -1, "num_leaves": 8,
           "linear_tree": True}
    res = {}
    for path, imp in (("kernels", {}), ("plain", {"hist_impl": "plain"})):
        ds = lgb.Dataset(X[tr], label=y[tr])
        ((b, fit_ms, fits), si_ms, si_calls), secs, counts, plain = \
            counted_run(lambda: event_timed(T, "split_iter", lambda:
                        event_timed(G, "fit_linear_leaves", lambda:
                                    lgb.train(dict(lin, **imp), ds,
                                              LINEAR_EXAMPLE_ROUNDS))))
        res[path] = {"s": secs, "rmse": rmse(b.predict(X[te]), y[te]),
                     "counts": counts, "plain_calls": plain,
                     "split_iter_event_ms": si_ms, "split_iterations":
                     si_calls, "fit_event_ms": fit_ms, "fits": fits,
                     "booster": b}
        log(f"phase 20b {path}: {LINEAR_EXAMPLE_ROUNDS} rounds in "
            f"{secs:.2f} s, RMSE {res[path]['rmse']:.7f}, launches "
            f"{json.dumps(counts)}, plain calls {plain}, "
            f"{si_ms:.4f} event ms a split iteration, {fit_ms:.3f} a fit")
    k = res["kernels"]
    check(k["plain_calls"] == 0 and k["counts"]["split_iter"] > 0
          and k["counts"]["hist_fused_f32"] > 0,
          f"20b strict kernel path (B1 pairs, B3): launches {k['counts']}, "
          f"plain calls {k['plain_calls']}")
    add_launches(launches, k["counts"])
    d = k["rmse"] - res["plain"]["rmse"]
    check(abs(d) <= 1e-5, f"20b: RMSE kernel - plain {d:.2e}")
    con = lgb.train({"objective": "regression", "verbosity": -1,
                     "num_leaves": 8}, lgb.Dataset(X[tr], label=y[tr]),
                    LINEAR_EXAMPLE_ROUNDS)
    con_rmse = rmse(con.predict(X[te]), y[te])
    check(k["rmse"] < con_rmse,
          f"20b: linear RMSE {k['rmse']:.5f} not below constant "
          f"{con_rmse:.5f}")
    # 20e: the linear model through the text model; the packed artifact
    # refuses it by name
    bk = k["booster"]
    path = os.path.join(workdir, "linear_model.txt")
    bk.save_model(path)
    back = lgb.Booster(model_file=path)
    same = bool(np.array_equal(back.predict(X[te]), bk.predict(X[te])))
    check(same, "20e: the reloaded text model predicts other bits")
    refused = []
    for fn in (lambda: pack_booster(bk),
               lambda: bk.save_model(os.path.join(workdir, "linear.npz"))):
        try:
            fn()
        except NotImplementedError as e:
            refused.append("linear_tree" in str(e))
    check(refused == [True, True], f"20e: pack_booster refusals {refused}")
    out = {"rounds": LINEAR_EXAMPLE_ROUNDS,
           **{p: {f: v for f, v in r.items() if f != "booster"}
              for p, r in res.items()},
           "rmse_kernel_minus_plain": d, "constant_rmse": con_rmse,
           "text_model_bit_equal": same, "packed_refused": True}
    log(f"phase 20b/e: {json.dumps(out)}")
    return out


def phase_shap_and_introspection(dev, const, Xv, launches):
    """20c and 20d: TreeSHAP on the card (the example's monotone model,
    then 4,096 rows of the north-star constant model), ``pred_leaf``,
    ``dump_model`` and ``create_tree_digraph`` against the CPU's."""
    import lightgbm_tpu_torch as lgb

    X, y = advanced_features_data()
    tr, te = slice(0, 4000), slice(4000, None)
    mono = lgb.train({"objective": "regression", "verbosity": -1,
                      "monotone_constraints": [1, -1, 0, 0, 0]},
                     lgb.Dataset(X[tr], label=y[tr]), ADV_ROUNDS)
    mono_cpu = lgb.Booster(model_str=mono.model_to_string(), device="cpu")
    rows = X[te][:SHAP_EXAMPLE_ROWS]
    t0 = time.perf_counter()
    contrib = mono.predict(rows, pred_contrib=True)
    ex_s = time.perf_counter() - t0
    add = float(np.abs(contrib.sum(1) - mono.predict(rows, raw_score=True))
                .max())
    d_cpu = float(np.abs(contrib - mono_cpu.predict(rows, pred_contrib=True))
                  .max())
    mean_abs = np.abs(contrib[:, :5]).mean(0)
    check(add <= 1e-4, f"20c: additivity {add:.2e}")
    check(d_cpu <= 1e-5, f"20c: card - CPU contributions {d_cpu:.2e}")
    check(mean_abs[3:].max() < 0.05 * mean_abs[:3].min(),
          f"20c: mean |SHAP| {mean_abs}")
    # 4,096 rows of the north-star constant model (10 trees of 127 leaves)
    rows = Xv[:SHAP_NORTH_STAR_ROWS]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    (ns, _, counts, _) = counted_run(lambda: const.predict(
        rows, pred_contrib=True))
    t0 = time.perf_counter()
    ns = const.predict(rows, pred_contrib=True)
    torch.cuda.synchronize()
    ns_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    ns_add = float(np.abs(ns.sum(1) - const.predict(rows, raw_score=True))
                   .max())
    check(ns.shape == (SHAP_NORTH_STAR_ROWS, NUM_FEATURES + 1)
          and np.isfinite(ns).all() and ns_add <= 1e-4,
          f"20c north star: shape {ns.shape}, additivity {ns_add:.2e}")
    # 20d: pred_leaf, dump_model and the DOT text against the CPU's
    const_cpu = lgb.Booster(model_str=const.model_to_string(), device="cpu")
    leaf_rows = Xv[:LEAF_ROWS]
    t0 = time.perf_counter()
    leaves = const.predict(leaf_rows, pred_leaf=True)
    leaf_s = time.perf_counter() - t0
    leaves_equal = bool(np.array_equal(
        leaves, const_cpu.predict(leaf_rows, pred_leaf=True)))
    check(leaves_equal and leaves.shape == (LEAF_ROWS, LATE_ROUNDS)
          and leaves.max() < NUM_LEAVES,
          f"20d: pred_leaf differs from the CPU's ({leaves.shape})")
    dump_equal = const.dump_model() == const_cpu.dump_model()
    dot_equal = all(lgb.create_tree_digraph(const, tree_index=i)
                    == lgb.create_tree_digraph(const_cpu, tree_index=i)
                    for i in (0, LATE_ROUNDS - 1))
    check(dump_equal and dot_equal,
          f"20d: dump_model equal {dump_equal}, DOT text equal {dot_equal}")
    out = {"example": {"rows": SHAP_EXAMPLE_ROWS, "s": ex_s,
                       "additivity": add, "max_abs_card_minus_cpu": d_cpu,
                       "mean_abs_shap": mean_abs.tolist()},
           "north_star": {"rows": SHAP_NORTH_STAR_ROWS, "trees":
                          LATE_ROUNDS, "s": ns_s, "additivity": ns_add,
                          "peak_bytes_above_base": int(peak),
                          "launches": counts},
           "pred_leaf": {"rows": LEAF_ROWS, "s": leaf_s,
                         "equal_to_cpu": leaves_equal},
           "dump_model_equal": dump_equal, "dot_text_equal": dot_equal}
    log(f"phase 20c/d: {json.dumps(out)}")
    return out


def phase_linear_introspection(dev, X, y, card, constant_s):
    """Phase 20, every launch counter at 0 just before each run and read
    just after; fails unless B1 (bf16 and f32), B2 and B3 launched."""
    from lightgbm_tpu_torch.utils.datasets import make_higgs_like

    t0 = time.perf_counter()
    launches, secs, out = {}, {}, {}
    workdir = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(workdir, exist_ok=True)
    Xv, yv = make_higgs_like(VALID_ROWS, NUM_FEATURES, seed=9)
    t1 = time.perf_counter()
    out["20a"], const, ds = phase_linear_north_star(dev, X, y, Xv, yv,
                                                    launches, constant_s)
    secs["20a"] = time.perf_counter() - t1
    for name, fn in (
            ("20b", lambda: phase_linear_example(dev, workdir, launches)),
            ("20c", lambda: phase_shap_and_introspection(dev, const, Xv,
                                                         launches))):
        t1 = time.perf_counter()
        out[name] = fn()
        secs[name] = time.perf_counter() - t1
    del ds, const
    for name in ("hist_fused_bf16", "hist_partition_bf16", "hist_fused_f32",
                 "split_iter"):
        check(launches.get(name, 0) > 0, f"phase 20: {name} never launched")
    out["launches"] = launches
    out["s_by_part"] = secs
    out["s"] = time.perf_counter() - t0
    log(f"phase 20: {out['s']:.1f} s ({json.dumps(secs)}) on {card}, "
        f"launches {json.dumps(launches)}")
    return out


# ---------------------------------------------------------------------------
# phase 21: continuation (init_model, mixed capacities, rollback, refit,
# binary dataset files)
# ---------------------------------------------------------------------------
def leaves_equal(a, b) -> bool:
    """Every tree's leaf values equal bit for bit (the same structures)."""
    return len(a.trees) == len(b.trees) and all(
        torch.equal(ta.leaf_value.cpu(), tb.leaf_value.cpu())
        for ta, tb in zip(a.trees, b.trees))


def phase_continue_north_star(dev, ds, root, launches):
    """21a: 5 + 5 rounds against 10, four ways, and the replay's time."""
    import lightgbm_tpu_torch as lgb
    import lightgbm_tpu_torch.models.gbdt as G
    from lightgbm_tpu_torch.training import train_resumable

    params, n = dict(RECOVERY_PARAMS), 2 * CONT_ROUNDS
    path = os.path.join(root, "first5.txt")

    def runs():
        full = lgb.train(params, ds, n)
        first = lgb.train(params, ds, CONT_ROUNDS)
        first.save_model(path)
        conts = {"init_model=Booster": lgb.train(params, ds, CONT_ROUNDS,
                                                 init_model=first),
                 "init_model=model file": lgb.train(params, ds, CONT_ROUNDS,
                                                    init_model=path)}
        loaded = lgb.Booster(model_file=path)
        for _ in range(CONT_ROUNDS):
            loaded.update(ds)
        conts["Booster(model_file).update(ds)"] = loaded
        res = train_resumable(params, ds, n, resume=False, init_model=path,
                              checkpoint_dir=os.path.join(root, "ck21a"),
                              checkpoint_rounds=CONT_ROUNDS)
        check(res.completed and res.rounds_done == n
              and res.resumed_from == path,
              f"21a train_resumable(init_model=): {res}")
        conts["train_resumable(init_model=)"] = res.booster
        return full, conts

    ((full, conts), replay_ms, replays), secs, counts, plain = counted_run(
        lambda: event_timed(G.Booster, "_rebase_and_replay", runs))
    for how, b in conts.items():
        check(same_run(full, b), f"21a {how}: trees, _pred_train or _bag "
              "differ from 10 uninterrupted rounds")
    check(counts["hist_fused_bf16"] > 0 and counts["hist_partition_bf16"] > 0
          and plain == 0 and replays == len(conts),
          f"21a launches {counts}, plain calls {plain}, replays {replays}")
    add_launches(launches, counts)
    # the replay of all 10 trees, three times: the live scores' bits
    fresh = [lgb.Booster(params, ds) for _ in range(3)]
    _, replay10_ms, _ = event_timed(G.Booster, "_rebase_and_replay", lambda: [
        b.ingest_init_model(full) for b in fresh])
    check(all(torch.equal(b._pred_train, full._pred_train) for b in fresh),
          "21a: the 10-tree replay differs from the live train scores")
    out = {"rounds": [CONT_ROUNDS, CONT_ROUNDS], "params": params,
           "bit_identical": sorted(conts), "s": secs, "launches": counts,
           "replay_event_ms_5_trees": replay_ms,
           "replay_event_ms_10_trees": replay10_ms,
           "replay_rows": int(ds.num_data_)}
    log(f"phase 21a: {json.dumps(out)}")
    return out, full


def phase_mixed_capacity(dev, ds, full, Xv, root, launches):
    """21b: the 127-leaf model continued at 31 leaves: predict, B4, DART,
    and a killed and resumed ``train_resumable`` of the mixed forest."""
    import signal

    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.config import parse_params
    from lightgbm_tpu_torch.models.gbdt import dart_drops
    from lightgbm_tpu_torch.serving import PredictorRuntime, pack_booster
    from lightgbm_tpu_torch.training import train_resumable

    n = full.num_trees()
    mixed, secs, counts, _ = counted_run(lambda: lgb.train(
        MIXED_PARAMS, ds, MIXED_ROUNDS, init_model=full))
    add_launches(launches, counts)
    caps = sorted({t.capacity for t in mixed.trees})
    check(caps == [2 * MIXED_PARAMS["num_leaves"] - 1, CAPACITY],
          f"21b: capacities {caps}")
    p_first, p_full = mixed.predict(Xv, num_iteration=n), full.predict(Xv)
    rel = float(np.max(np.abs(p_first - p_full) / np.abs(p_full)))
    check(rel <= 1e-6, f"21b: predict(num_iteration={n}) rel {rel:.2e}")
    # served through B4 (the padded stack)
    Xs = Xv[:RECOVERY_SERVE_ROWS]
    (served, direct), _, serve_counts, _ = counted_run(lambda: (
        PredictorRuntime(pack_booster(mixed), max_bucket=MAX_BUCKET,
                         device=dev).predict(Xs, raw_score=True),
        mixed.predict(Xs, raw_score=True)))
    err = float(np.abs(served - direct).max())
    check(serve_counts["predict_forest"] > 0 and err <= 1e-5,
          f"21b served: B4 launches {serve_counts['predict_forest']}, "
          f"max abs diff {err:.2e}")
    add_launches(launches, serve_counts)
    # DART on top: its dropped-tree stacks span both capacities
    drops = [dart_drops(parse_params(MIXED_DART_PARAMS), i, i)
             for i in range(n, n + MIXED_ROUNDS)]
    check(any(min(d) < n <= max(d) for d in drops if d),
          f"21b DART drops {drops} never mix the capacities")
    dart, dart_s, dart_counts, _ = counted_run(lambda: lgb.train(
        MIXED_DART_PARAMS, ds, MIXED_ROUNDS, init_model=full))
    check(dart.num_trees() == n + MIXED_ROUNDS
          and bool(np.isfinite(dart.predict(Xs)).all()),
          "21b: the DART continuation")
    add_launches(launches, dart_counts)
    # the mixed forest killed and resumed through its checkpoints
    path = os.path.join(root, "mixed.txt")
    mixed.save_model(path)
    total = n + MIXED_ROUNDS + 3

    def kill(booster, i):
        if i == n + MIXED_ROUNDS:
            os.kill(os.getpid(), signal.SIGTERM)

    kw = dict(checkpoint_rounds=1, init_model=path)

    def resumable():
        whole = train_resumable(MIXED_PARAMS, ds, total, resume=False,
                                checkpoint_dir=os.path.join(root, "m_full"),
                                **kw)
        killed = train_resumable(MIXED_PARAMS, ds, total, resume=False,
                                 checkpoint_dir=os.path.join(root, "m_kill"),
                                 round_callbacks=[kill], **kw)
        again = train_resumable(MIXED_PARAMS, ds, total, resume=True,
                                checkpoint_dir=os.path.join(root, "m_kill"),
                                **kw)
        return whole, killed, again

    (whole, killed, again), res_s, res_counts, _ = counted_run(resumable)
    add_launches(launches, res_counts)
    check(killed.preempted and killed.rounds_done == n + MIXED_ROUNDS + 1
          and again.completed and again.resumed_from == killed.last_checkpoint,
          f"21b kill/resume: killed {killed}, again {again}")
    check(same_run(whole.booster, again.booster)
          and sorted({t.capacity for t in again.booster.trees}) == caps,
          "21b: the resumed mixed forest differs from the uninterrupted one")
    out = {"capacities": caps, "s": secs,
           "predict_first_10_rel_diff": rel,
           "predict_first_10_bit_equal": bool(np.array_equal(p_first,
                                                             p_full)),
           "served_rows": len(Xs), "served_max_abs_diff": err,
           "dart_drops": drops, "dart_s": dart_s,
           "resume_bit_identical": True, "resumable_s": res_s,
           "launches": {"train": counts, "serve": serve_counts,
                        "dart": dart_counts, "resumable": res_counts}}
    log(f"phase 21b: {json.dumps(out)}")
    return out


def phase_rollback(dev, ds, Xv, yv, launches):
    """21c: ``rollback_one_iter`` twice with a valid set, then 2 rounds."""
    import lightgbm_tpu_torch as lgb

    dv = lgb.Dataset(Xv, label=yv, reference=ds)
    dv.construct()

    def with_valid(rounds):
        b = lgb.Booster(RECOVERY_PARAMS, ds)
        b.add_valid(dv, "v")
        for _ in range(rounds):
            b.update()
        return b

    n = 2 * CONT_ROUNDS
    (long, short), secs, counts, _ = counted_run(
        lambda: (with_valid(n), with_valid(n - ROLLBACK_STEPS)))
    add_launches(launches, counts)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ROLLBACK_STEPS):
        long.rollback_one_iter()
    torch.cuda.synchronize()
    rb_s = time.perf_counter() - t0
    d_valid = float((long._valid[0][2] - short._valid[0][2]).abs().max())
    d_train = float((long._pred_train - short._pred_train).abs().max())
    d_metric = abs(long.eval_valid()[0][2] - short.eval_valid()[0][2])
    check(long.num_trees() == n - ROLLBACK_STEPS and d_valid <= 1e-6,
          f"21c: valid scores after rollback {d_valid:.2e} from the "
          f"{n - ROLLBACK_STEPS}-round run's")
    _, more_s, more_counts, _ = counted_run(lambda: [
        long.update() for _ in range(ROLLBACK_STEPS)])
    add_launches(launches, more_counts)
    check(long.num_trees() == n
          and bool(torch.isfinite(long._valid[0][2]).all()),
          "21c: rounds after the rollback")
    out = {"rollback_s": rb_s, "valid_rows": len(Xv),
           "valid_max_abs_diff": d_valid, "train_max_abs_diff": d_train,
           "metric_abs_diff": d_metric, "rounds_after_s": more_s,
           "launches": counts}
    log(f"phase 21c: {json.dumps(out)}")
    return out


def phase_refit(dev, full, Xv, yv, launches):
    """21d: ``refit`` of the 10-round model on 200,000 rows: deterministic
    on the card, near the CPU's, served through B4."""
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.serving import PredictorRuntime, pack_booster

    secs, refits = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        refits.append(full.refit(Xv, yv))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    check(leaves_equal(*refits), "21d: two refits on the card differ")
    check(not leaves_equal(full, refits[0]), "21d: the refit moved no leaf")
    cpu = lgb.Booster(model_str=full.model_to_string(), device="cpu")
    rows = slice(0, REFIT_CPU_ROWS)
    want = cpu.refit(Xv[rows], yv[rows])
    got = full.refit(Xv[rows], yv[rows])
    # the parity regime (rtol 1e-5, atol 1e-6): the card's links round
    # their exp otherwise than the CPU's copy of XLA's, and a leaf near 0
    # keeps only the absolute part of its sums' rounding
    a = torch.stack([t.leaf_value for t in got.trees]).cpu()
    b = torch.stack([t.leaf_value for t in want.trees])
    d_abs = float((a - b).abs().max())
    rel = float(((a - b).abs() / b.abs().clamp(min=1e-30)).max())
    p_got = got.predict(Xv[rows])
    p_rel = float(np.max(np.abs(p_got - want.predict(Xv[rows]))
                         / np.abs(p_got)))
    check(bool(((a - b).abs() <= 1e-5 * b.abs() + 1e-6).all())
          and p_rel <= 1e-5,
          f"21d: card - CPU refit leaves {d_abs:.2e} abs ({rel:.2e} rel), "
          f"predictions {p_rel:.2e} rel")
    Xs = Xv[:RECOVERY_SERVE_ROWS]
    (served, direct), _, counts, _ = counted_run(lambda: (
        PredictorRuntime(pack_booster(refits[0]), max_bucket=MAX_BUCKET,
                         device=dev).predict(Xs, raw_score=True),
        refits[0].predict(Xs, raw_score=True)))
    err = float(np.abs(served - direct).max())
    check(counts["predict_forest"] > 0 and err <= 1e-5,
          f"21d served: B4 launches {counts['predict_forest']}, {err:.2e}")
    add_launches(launches, counts)
    out = {"rows": len(Xv), "trees": full.num_trees(), "refit_s": secs,
           "bit_identical_on_card": True, "cpu_rows": REFIT_CPU_ROWS,
           "card_minus_cpu_leaf_max_abs": d_abs,
           "card_minus_cpu_leaf_max_rel": rel,
           "card_minus_cpu_predict_max_rel": p_rel,
           "served_max_abs_diff": err,
           "launches": counts}
    log(f"phase 21d: {json.dumps(out)}")
    return out


def phase_continue_multiclass(dev, cds, launches):
    """21e: multiclass at Covertype's shape, 3 + 3 rounds against 6."""
    import lightgbm_tpu_torch as lgb

    def runs():
        whole = lgb.train(COV_PARAMS, cds, 2 * COV_CONT_ROUNDS)
        first = lgb.train(COV_PARAMS, cds, COV_CONT_ROUNDS)
        return whole, lgb.train(COV_PARAMS, cds, COV_CONT_ROUNDS,
                                init_model=first)

    (whole, cont), secs, counts, plain = counted_run(runs)
    check(whole.num_trees() == 2 * COV_CONT_ROUNDS
          and trees_identical(whole, cont, whole.num_trees())
          and torch.equal(whole._pred_train, cont._pred_train),
          "21e: the multiclass continuation differs from 6 rounds")
    check(counts["hist_fused_batched_bf16"] > 0
          and counts["hist_segstats_bf16"] > 0 and plain == 0,
          f"21e launches {counts}, plain calls {plain}")
    add_launches(launches, counts)
    out = {"rounds": [COV_CONT_ROUNDS, COV_CONT_ROUNDS], "s": secs,
           "bit_identical": True, "launches": counts}
    log(f"phase 21e: {json.dumps(out)}")
    return out


def phase_binary_dataset(dev, dds, ds, root, launches):
    """21f: diamonds through ``save_binary`` and ``Dataset(path)`` (fused
    strict ``cv()``, strict ``train``), the example's linear call continued
    10 + 10, and the north star's file."""
    import lightgbm_tpu_torch as lgb

    path = os.path.join(root, "diamonds.bin")
    dds.save_binary(path)
    back = lgb.Dataset(path)
    back.construct()
    check(back.device.type == "cuda" and torch.equal(back.X_binned,
                                                     dds.X_binned)
          and np.array_equal(back.get_label(), dds.get_label()),
          "21f: the reloaded diamonds Dataset differs")
    strict = dict(CV_PARAMS, grow_policy="leafwise")

    def both(d):
        return (lgb.cv(CV_PARAMS, d, CV_BINARY_ROUNDS, nfold=CV_FOLDS,
                       metrics="rmse", stratified=False, seed=SWEEP_SEED),
                lgb.train(strict, d, STRICT_BINARY_ROUNDS))

    (cv_a, tr_a), secs, counts, plain = counted_run(lambda: both(dds))
    cv_b, tr_b = both(back)
    check(dict(cv_a) == dict(cv_b)
          and trees_identical(tr_a, tr_b, STRICT_BINARY_ROUNDS),
          "21f: cv() or strict train on the reloaded Dataset differ")
    check(counts["hist_segstats_f32"] > 0 and counts["hist_fused_f32"] > 0
          and counts["split_iter"] > 0 and plain == 0,
          f"21f launches {counts}, plain calls {plain}")
    add_launches(launches, counts)
    # examples/advanced_features.py's linear call, 10 + 10 against 20
    X, y = advanced_features_data()
    lin = {"objective": "regression", "verbosity": -1, "num_leaves": 8,
           "linear_tree": True}
    lds = lgb.Dataset(X[:4000], label=y[:4000])

    def linear():
        whole = lgb.train(lin, lds, 2 * LINEAR_CONT_ROUNDS)
        first = lgb.train(lin, lds, LINEAR_CONT_ROUNDS)
        return whole, lgb.train(lin, lds, LINEAR_CONT_ROUNDS,
                                init_model=first)

    (whole, cont), lin_s, lin_counts, _ = counted_run(linear)
    check(trees_identical(whole, cont, whole.num_trees())
          and torch.equal(whole._pred_train, cont._pred_train)
          and lin_counts["split_iter"] > 0,
          f"21f: the linear continuation (B3 {lin_counts['split_iter']})")
    add_launches(launches, lin_counts)
    # the north star's file: bytes, write and read seconds
    big = os.path.join(root, "higgs.bin")
    t0 = time.perf_counter()
    ds.save_binary(big)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    again = lgb.Dataset(big)
    again.construct()
    torch.cuda.synchronize()
    read_s = time.perf_counter() - t0
    check(torch.equal(again.X_binned, ds.X_binned), "21f: the north star's "
          "reloaded codes differ")
    out = {"diamonds_cv_and_strict_equal": True, "s": secs,
           "launches": counts, "linear_continuation_equal": True,
           "linear_s": lin_s, "linear_launches": lin_counts,
           "north_star_bytes": os.path.getsize(big + ".npz"),
           "north_star_write_s": write_s, "north_star_read_s": read_s}
    del again
    log(f"phase 21f: {json.dumps(out)}")
    return out


def phase_continuation(dev, ds, dds, cds, card):
    """Phase 21, every launch counter at 0 just before each run and read
    just after; fails unless B1 (bf16 and f32), B2, B3, B4, B5 and B6
    launched."""
    import shutil

    from lightgbm_tpu_torch.utils.datasets import make_higgs_like

    t0 = time.perf_counter()
    launches, secs, out = {}, {}, {}
    root = os.path.join(ROOT, "build", "chip_smoke", "continuation")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    Xv, yv = make_higgs_like(VALID_ROWS, NUM_FEATURES, seed=9)
    t1 = time.perf_counter()
    out["21a"], full = phase_continue_north_star(dev, ds, root, launches)
    secs["21a"] = time.perf_counter() - t1
    for name, fn in (
            ("21b", lambda: phase_mixed_capacity(dev, ds, full, Xv, root,
                                                 launches)),
            ("21c", lambda: phase_rollback(dev, ds, Xv, yv, launches)),
            ("21d", lambda: phase_refit(dev, full, Xv, yv, launches)),
            ("21e", lambda: phase_continue_multiclass(dev, cds, launches)),
            ("21f", lambda: phase_binary_dataset(dev, dds, ds, root,
                                                 launches))):
        t1 = time.perf_counter()
        out[name] = fn()
        secs[name] = time.perf_counter() - t1
    for name in ("hist_fused_bf16", "hist_partition_bf16", "hist_fused_f32",
                 "split_iter", "predict_forest", "hist_fused_batched_bf16",
                 "hist_segstats_bf16", "hist_segstats_f32"):
        check(launches.get(name, 0) > 0, f"phase 21: {name} never launched")
    out["launches"] = launches
    out["s_by_part"] = secs
    out["s"] = time.perf_counter() - t0
    log(f"phase 21: {out['s']:.1f} s ({json.dumps(secs)}) on {card}, "
        f"launches {json.dumps(launches)}")
    return out


# ---------------------------------------------------------------------------
# phase 22: out-of-core training (streamed Datasets, EMA feature screening)
# ---------------------------------------------------------------------------
STREAM_BLOCK_ROWS = 131_072          # 1,000,000 rows: 8 blocks, tail padded
STREAM_PARAMS = dict(TRAIN_PARAMS, stream_block_rows=STREAM_BLOCK_ROWS)
STREAM_STRICT_ROWS, STREAM_STRICT_BLOCK = 200_000, 65_536   # 4 blocks
STREAM_STRICT_PARAMS = dict(TRAIN_PARAMS, num_leaves=31,
                            grow_policy="leafwise",
                            stream_block_rows=STREAM_STRICT_BLOCK)
STREAM_STRICT_ROUNDS, STREAM_GOSS_ROUNDS = 3, 5
STREAM_RECOVERY_PARAMS = dict(RECOVERY_PARAMS, num_leaves=63,
                              stream_block_rows=STREAM_STRICT_BLOCK)
STREAM_RECOVERY_ROUNDS, STREAM_KILL_AFTER, STREAM_CONT_ROUNDS = 6, 2, 5
# 22e: the reference's screening bench width (tools/bench_screening.py:
# 136 columns, 16 informative, keep 0.25, refresh every 10)
SCREEN_F, SCREEN_INFORMATIVE, SCREEN_ROWS = 136, 16, 100_000
SCREEN_ROUNDS, SCREEN_BLOCK, SCREEN_DRIFT = 12, 32_768, 1e-4   # 20 until phase 25
SCREEN_BASE = {"objective": "binary", "num_leaves": 31, "learning_rate": 0.2,
               "max_bin": 63, "min_data_in_leaf": 20, "verbosity": -1,
               "seed": 7}
SCREEN = {"feature_screen": "ema", "screen_keep_ratio": 0.25,
          "screen_refresh_rounds": 10}


def row_blocks(X, y, rows):
    """A zero-argument callable yielding ``(X, y)`` row blocks (the two
    passes of ``Dataset.from_blocks``)."""
    return lambda: ((X[lo:lo + rows], y[lo:lo + rows])
                    for lo in range(0, len(X), rows))


def streamed_rounds(booster, store, rounds):
    """``rounds`` updates of a Booster on a streamed Dataset, each timed to
    a synchronize, with the store's odometers per round."""
    per = []
    for _ in range(rounds):
        store.copy_wait_ms()                 # drop earlier waits
        b0, p0, v0 = store.bytes_streamed, store.passes, store.verify_ms
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        booster.update()
        torch.cuda.synchronize()
        per.append({"s": time.perf_counter() - t0,
                    "bytes": store.bytes_streamed - b0,
                    "passes": store.passes - p0,
                    "verify_ms": store.verify_ms - v0,
                    "copy_wait_ms": store.copy_wait_ms()})
    return per


def peak_round_bytes(booster):
    """Device bytes a round allocates above what was live before it
    (``max_memory_allocated`` after ``reset_peak_memory_stats``)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    booster.update()
    torch.cuda.synchronize()
    return {"round_peak_above_live": torch.cuda.max_memory_allocated() - base,
            "live_before": base}


def phase_stream_north_star(dev, X, y, ds, Xv, yv, launches):
    """22a: the north star streamed from 131,072-row blocks with phase 6's
    bins, kernel / plain / in-memory in turns; the dyadic round-1 tree;
    the ring's buffers; B4 serving; peak memory; a fresh sketch fit."""
    import copy

    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.data.sketch import schema_digest
    from lightgbm_tpu_torch.serving import PredictorRuntime, pack_booster

    t0 = time.perf_counter()
    sds = lgb.Dataset.from_blocks(row_blocks(X, y, STREAM_BLOCK_ROWS),
                                  params=STREAM_PARAMS, reference=ds)
    t_blocks = time.perf_counter() - t0
    store = sds.block_store
    check(sds.X_binned is None and sds.is_streamed
          and store.num_blocks == 8
          and store.padded_rows == 8 * STREAM_BLOCK_ROWS
          and schema_digest(sds.bin_mapper) == schema_digest(ds.bin_mapper),
          f"22a streamed Dataset: {store.num_blocks} blocks, "
          f"{store.padded_rows} padded rows")
    store.time_waits = True

    def streamed(extra):
        def go():
            b = lgb.Booster(dict(STREAM_PARAMS, **extra), sds)
            return b, streamed_rounds(b, store, LATE_ROUNDS)
        (b, per), secs, counts, plain = counted_run(go)
        return {"booster": b, "per_round": per, "s": secs, "counts": counts,
                "plain_calls": plain}

    runs, turns = {}, {"streamed": [], "plain": [], "in_memory": []}
    for tag in ("streamed", "plain", "in_memory", "in_memory", "streamed"):
        if tag == "in_memory":
            b, secs, counts, plain = train_run(lgb, ds, TRAIN_PARAMS,
                                               LATE_ROUNDS)
            r = {"booster": b, "s": secs, "counts": counts,
                 "plain_calls": plain}
        else:
            r = streamed({} if tag == "streamed" else {"hist_impl": "plain"})
        turns[tag].append(r["s"] / LATE_ROUNDS)
        runs.setdefault(tag, r)
    k, pl, mem = runs["streamed"], runs["plain"], runs["in_memory"]
    passes = sum(r["passes"] for r in k["per_round"])
    check(k["counts"]["hist_fused_bf16"] == passes * store.num_blocks
          and k["counts"]["hist_partition_bf16"] == 0
          and k["plain_calls"] == 0,
          f"22a streamed launches {k['counts']} over {passes} passes, "
          f"plain calls {k['plain_calls']}")
    check(sum(v for n, v in pl["counts"].items() if n.startswith("hist_"))
          == 0, f"22a hist_impl='plain' launched {pl['counts']}")
    check(store.peak_device_buffers <= store.prefetch_blocks + 1,
          f"22a {store.peak_device_buffers} block buffers on the device, "
          f"prefetch {store.prefetch_blocks}")
    aucs = {t: auc(r["booster"], Xv, yv, dev) for t, r in runs.items()}
    check(abs(aucs["streamed"] - aucs["in_memory"]) <= AUC_TOL
          and abs(aucs["streamed"] - aucs["plain"]) <= AUC_TOL,
          f"22a AUC {json.dumps(aucs)}")
    add_launches(launches, k["counts"])

    # the dyadic round-1 tree: streamed == in memory, every field
    # (phase 6's bins and 22a's blocks relabelled: shallow copies share
    # the codes, ``set_label`` puts the new labels on the card)
    yd = dyadic_label(X, SEED + 220)
    dsd, sdd = copy.copy(ds).set_label(yd), copy.copy(sds).set_label(yd)
    pd = dict(STREAM_PARAMS, objective="regression")
    (bm, bs), _, counts, _ = counted_run(lambda: (lgb.train(pd, dsd, 1),
                                                  lgb.train(pd, sdd, 1)))
    add_launches(launches, counts)
    check(trees_identical(bm, bs, 1), "22a dyadic: the streamed round-1 "
          "tree differs from the in-memory one")
    del dsd, sdd

    # served through PredictorRuntime (B4)
    rows = Xv[:RECOVERY_SERVE_ROWS]
    rt = PredictorRuntime(pack_booster(k["booster"]), max_bucket=MAX_BUCKET,
                          device=dev)
    served, _, counts, _ = counted_run(lambda: rt.predict(rows))
    check(counts["predict_forest"] > 0, f"22a serving launches {counts}")
    add_launches(launches, counts)
    sdiff = float(np.abs(served - k["booster"].predict(rows)).max())
    check(sdiff <= 1e-5, f"22a served vs Booster.predict {sdiff:.2e}")

    # a round's peak device memory, streamed against in memory
    peaks = {}
    for tag, d in (("streamed", sds), ("in_memory", ds)):
        b = lgb.Booster(dict(STREAM_PARAMS), d)
        b.update()
        peaks[tag] = peak_round_bytes(b)
    peaks["in_memory_X_binned_bytes"] = int(ds.X_binned.numel())
    peaks["ring_bytes"] = int(store.device_buffers * STREAM_BLOCK_ROWS
                              * NUM_FEATURES)

    # a fresh sketch fit at 10^6 rows (no reference): host seconds
    t0 = time.perf_counter()
    fresh = lgb.Dataset.from_blocks(row_blocks(X, y, STREAM_BLOCK_ROWS),
                                    params=STREAM_PARAMS)
    t_sketch = time.perf_counter() - t0
    same = schema_digest(fresh.bin_mapper) == schema_digest(ds.bin_mapper)
    del fresh
    per = k["per_round"]
    out = {"rows": len(X), "blocks": store.num_blocks,
           "block_rows": STREAM_BLOCK_ROWS, "padded_rows": store.padded_rows,
           "prefetch_blocks": store.prefetch_blocks,
           "peak_device_buffers": store.peak_device_buffers,
           "from_blocks_reference_s": t_blocks,
           "from_blocks_fresh_sketch_s": t_sketch,
           "fresh_sketch_digest_equals_in_memory_fit": same,
           "s_per_round_in_turns": turns, "auc": aucs,
           "passes_per_round": [r["passes"] for r in per],
           "bytes_streamed_per_round": [r["bytes"] for r in per],
           "verify_ms_per_round": [r["verify_ms"] for r in per],
           "copy_wait_ms_per_round": [r["copy_wait_ms"] for r in per],
           "s_per_round": [r["s"] for r in per],
           "launches": k["counts"], "dyadic_round1_equal": True,
           "serve_max_abs_diff": sdiff, "peak_bytes": peaks}
    log(f"phase 22a: {json.dumps(out)}")
    return out, sds


def trees_regime(a, b, what):
    """Structure equal and leaves within rtol 1e-5 / atol 1e-6, else a near
    tie recorded (the first differing split's gains within 1e-4
    relative, C.1's treatment); returns the near ties."""
    ties = []
    for i in range(min(len(a.trees), len(b.trees))):
        ta, tb = tree_arrays(a, i), tree_arrays(b, i)
        d = first_split_difference(ta, tb)
        if d is not None:
            check(d["rel"] <= 1e-4, f"{what}: tree {i} differs: {d}")
            ties.append({"tree": i, **d})
            break                       # later trees grow on other scores
        check(np.allclose(ta["leaf_value"], tb["leaf_value"], rtol=1e-5,
                          atol=1e-6), f"{what}: tree {i} leaf values")
    check(len(a.trees) == len(b.trees), f"{what}: tree counts")
    return ties


def phase_stream_strict(dev, X, y, ds, launches):
    """22b: the strict grower streamed, 31 leaves on 200,000 rows in
    65,536-row blocks: B1 pairs per block and B3 per split iteration."""
    import lightgbm_tpu_torch as lgb
    import lightgbm_tpu_torch.data.stream_grow as SG

    Xs, ys = X[:STREAM_STRICT_ROWS], y[:STREAM_STRICT_ROWS]
    sds = lgb.Dataset.from_blocks(row_blocks(Xs, ys, STREAM_STRICT_BLOCK),
                                  params=STREAM_STRICT_PARAMS, reference=ds)
    mds = lgb.Dataset(Xs, label=ys, reference=ds)
    p, n = STREAM_STRICT_PARAMS, STREAM_STRICT_ROUNDS
    (bs, tree_ms, trees), secs, counts, plain = counted_run(
        lambda: event_timed(SG, "_grow_strict",
                            lambda: lgb.train(p, sds, n)))
    iters = n * (p["num_leaves"] - 1)
    nb = sds.block_store.num_blocks
    check(counts["split_iter"] == iters
          and counts["hist_fused_f32"] == (n + iters) * nb and plain == 0
          and trees == n, f"22b launches {counts}, plain calls {plain}")
    add_launches(launches, counts)
    bm, msecs, mcounts, _ = train_run(lgb, mds, p, n)
    add_launches(launches, mcounts)
    ties = trees_regime(bs, bm, "22b streamed vs in-memory strict")
    out = {"rows": STREAM_STRICT_ROWS, "blocks": nb, "rounds": n,
           "num_leaves": p["num_leaves"], "launches": counts,
           "s": secs, "in_memory_s": msecs,
           "ms_per_split_iteration": tree_ms / (p["num_leaves"] - 1),
           "near_ties": ties}
    log(f"phase 22b: {json.dumps(out)}")
    return out, sds


def goss_recompute(g_abs, bag, goss_k, top_rate, other_rate, seed):
    """GOSS's host selection recomputed from its inputs: the k_top in-bag
    rows of largest |g| (checked as a multiset of scores, since
    ``argpartition`` breaks ties its own way), then ``default_rng(seed)``'s
    uniform draw from the rest."""
    k_top, k_other = goss_k
    valid = bag > 0
    score = np.where(valid, g_abs, -1.0)
    kt = min(k_top, int(valid.sum()))
    top = np.sort(np.argpartition(-score, kt - 1)[:kt])
    top_scores = np.sort(score[top])
    want_scores = np.sort(score)[::-1][:kt][::-1]
    rest = np.flatnonzero(valid & ~np.isin(np.arange(len(score)), top))
    other = np.sort(np.random.default_rng(seed).choice(
        rest, size=min(k_other, len(rest)), replace=False))
    return top, other, bool(np.array_equal(top_scores, want_scores))


def phase_stream_goss(dev, sds, ds, Xv, yv, launches):
    """22c: GOSS at the source on 22a's store, LightGBM's default rates."""
    import lightgbm_tpu_torch as lgb
    import lightgbm_tpu_torch.data.stream_grow as SG

    store = sds.block_store
    p = dict(STREAM_PARAMS, boosting="goss")
    seen, orig = [], SG.goss_host_select

    def spy(*a):
        out = orig(*a)
        seen.append((a, out))
        return out

    SG.goss_host_select = spy
    try:
        def go():
            b = lgb.Booster(p, sds)
            return b, streamed_rounds(b, store, STREAM_GOSS_ROUNDS)
        (bs, per), secs, counts, plain = counted_run(go)
    finally:
        SG.goss_host_select = orig
    check(counts["hist_partition_f32"] > 0 and counts["hist_fused_f32"] > 0
          and plain == 0 and len(seen) == STREAM_GOSS_ROUNDS,
          f"22c launches {counts}, plain calls {plain}")
    add_launches(launches, counts)
    for (g_abs, bag, goss_k, tr, orr, seed), (idx, wt) in seen:
        top, other, top_ok = goss_recompute(g_abs, bag, goss_k, tr, orr,
                                            seed)
        check(top_ok and np.array_equal(idx[:len(top)], top)
              and np.array_equal(idx[goss_k[0]:goss_k[0] + len(other)],
                                 other),
              "22c: the host selection differs from its recomputation")
    full_pass = store.padded_rows * store.num_features
    gathered = [r["bytes"] - r["passes"] * full_pass for r in per]
    bm, msecs, mcounts, _ = train_run(
        lgb, ds, dict(TRAIN_PARAMS, boosting="goss"), STREAM_GOSS_ROUNDS)
    add_launches(launches, mcounts)
    aucs = {"streamed_goss": auc(bs, Xv, yv, dev),
            "in_memory_goss": auc(bm, Xv, yv, dev)}
    check(abs(aucs["streamed_goss"] - aucs["in_memory_goss"]) <= 0.01,
          f"22c AUC {json.dumps(aucs)}")
    out = {"rounds": STREAM_GOSS_ROUNDS, "goss_k": list(bs._goss_k()),
           "gathered_over_full_pass": [gb / full_pass for gb in gathered],
           "s_per_round": [r["s"] for r in per],
           "in_memory_goss_s_per_round": msecs / STREAM_GOSS_ROUNDS,
           "auc": aucs, "launches": counts,
           "selection_equals_recomputation": True}
    log(f"phase 22c: {json.dumps(out)}")
    return out


def phase_stream_recovery(dev, sds, ds, X, y, launches):
    """22d: kill and resume, a screened resume, init_model continuation,
    and another schema refused, on 22b's streamed Dataset."""
    import shutil
    import signal

    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.training import (IncompatibleCheckpointError,
                                             latest_checkpoint,
                                             resume_booster, train_resumable)

    root = os.path.join(ROOT, "build", "chip_smoke", "stream_recovery")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    n = STREAM_RECOVERY_ROUNDS

    def kill(booster, i):
        if i == STREAM_KILL_AFTER:
            os.kill(os.getpid(), signal.SIGTERM)

    def resumable(params, tag):
        kw = dict(checkpoint_rounds=STREAM_KILL_AFTER + 1, keep_last=2)
        full = train_resumable(params, sds, n, resume=False,
                               checkpoint_dir=os.path.join(root, tag + "f"),
                               **kw)
        d = os.path.join(root, tag + "k")
        killed = train_resumable(params, sds, n, resume=False,
                                 checkpoint_dir=d, round_callbacks=[kill],
                                 **kw)
        again = train_resumable(params, sds, n, resume=True,
                                checkpoint_dir=d, **kw)
        check(killed.preempted and killed.rounds_done == STREAM_KILL_AFTER + 1
              and again.completed and again.resumed_from is not None,
              f"22d {tag}: killed {killed}, resumed {again}")
        check(same_run(full.booster, again.booster), f"22d {tag}: the "
              "resumed run differs from the uninterrupted one")
        return full.booster, again.booster

    p = dict(STREAM_RECOVERY_PARAMS)
    ps = dict(p, feature_screen="ema", screen_keep_ratio=0.25,
              screen_refresh_rounds=2)
    path = os.path.join(root, "first5.txt")

    def runs():
        resumable(p, "plain")
        full_s, again_s = resumable(ps, "screened")
        ema = [b._screener.state() for b in (full_s, again_s)]
        check(np.array_equal(ema[0][0], ema[1][0]) and ema[0][1] == ema[1][1],
              "22d screened: the screener's state differs after the resume")
        full10 = lgb.train(p, sds, 2 * STREAM_CONT_ROUNDS)
        first = lgb.train(p, sds, STREAM_CONT_ROUNDS)
        first.save_model(path)
        conts = [lgb.train(p, sds, STREAM_CONT_ROUNDS, init_model=first),
                 lgb.train(p, sds, STREAM_CONT_ROUNDS, init_model=path)]
        for c in conts:
            check(same_run(full10, c), "22d: init_model 5 + 5 differs from "
                  "10 uninterrupted rounds")
        return first

    first, secs, counts, plain = counted_run(runs)
    check(counts["hist_fused_bf16"] + counts["hist_fused_f32"] > 0
          and plain == 0, f"22d launches {counts}, plain {plain}")
    add_launches(launches, counts)
    # another schema: a fresh sketch over other rows is refused by digest
    other = lgb.Dataset.from_blocks(
        row_blocks(X[-STREAM_STRICT_ROWS:] * 1.5, y[-STREAM_STRICT_ROWS:],
                   STREAM_STRICT_BLOCK), params=STREAM_RECOVERY_PARAMS)
    ckpt = latest_checkpoint(os.path.join(root, "screenedk"))
    refused = []
    try:
        resume_booster(ckpt, other)
    except IncompatibleCheckpointError as e:
        refused.append(e.field)
    try:
        lgb.Booster(model_file=path).update(other)
    except ValueError as e:
        refused.append("binning" if "binning" in str(e) else str(e))
    check(refused == ["schema_digest", "binning"],
          f"22d: another schema was not refused: {refused}")
    out = {"rounds": n, "killed_after_round_index": STREAM_KILL_AFTER,
           "bit_identical": ["kill/resume", "screened kill/resume",
                             "init_model=Booster 5+5", "init_model=file 5+5"],
           "other_schema_refused": refused, "s": secs, "launches": counts}
    log(f"phase 22d: {json.dumps(out)}")
    return out


def wide_problem(n, seed):
    """The reference bench's screening task: 136 columns, 16 informative,
    rows within margin 1 of the boundary dropped."""
    rng = np.random.default_rng(seed)
    Xw = rng.normal(0, 1, (3 * n, SCREEN_F)).astype(np.float32)
    w = rng.normal(0, 1, SCREEN_INFORMATIVE)
    margin = (Xw[:, :SCREEN_INFORMATIVE] @ w) * 1.5
    keep = np.abs(margin) >= 1.0
    Xw, margin = Xw[keep][:n], margin[keep][:n]
    return Xw, (margin > 0).astype(np.float32)


def phase_stream_screening(dev, launches):
    """22e: EMA screening at F = 136, in memory and streamed."""
    import lightgbm_tpu_torch as lgb

    Xw, yw = wide_problem(SCREEN_ROWS + SCREEN_ROWS // 2, SEED + 221)
    Xt, yt = Xw[:SCREEN_ROWS], yw[:SCREEN_ROWS]
    Xv, yv = Xw[SCREEN_ROWS:], yw[SCREEN_ROWS:]
    mds = lgb.Dataset(Xt, label=yt, params=dict(SCREEN_BASE))
    mds.construct()
    sp = dict(SCREEN_BASE, stream_block_rows=SCREEN_BLOCK)
    sds = lgb.Dataset.from_blocks(row_blocks(Xt, yt, SCREEN_BLOCK),
                                  params=sp, reference=mds)
    store = sds.block_store
    configs = {"off": {}, "ema": SCREEN,
               "refresh_1": dict(SCREEN, screen_refresh_rounds=1)}
    res, per_round = {}, {}

    def runs():
        for where, d in (("in_memory", mds), ("streamed", sds)):
            for tag, extra in configs.items():
                b = lgb.Booster(dict(sp, **extra), d)
                if where == "streamed":
                    per_round[tag] = streamed_rounds(b, store, SCREEN_ROUNDS)
                else:
                    for _ in range(SCREEN_ROUNDS):
                        b.update()
                res[where, tag] = b
        return res

    _, secs, counts, plain = counted_run(runs)
    check(counts["hist_fused_f32"] > 0 and plain == 0,
          f"22e launches {counts}, plain {plain}")
    add_launches(launches, counts)
    aucs, f_active = {}, int(np.ceil(0.25 * SCREEN_F))
    for where in ("in_memory", "streamed"):
        a = {t: auc(res[where, t], Xv, yv, dev) for t in configs}
        aucs[where] = a
        check(abs(a["ema"] - a["off"]) <= SCREEN_DRIFT,
              f"22e {where}: AUC drift {a['ema'] - a['off']:.2e}")
        check(same_run(res[where, "off"], res[where, "refresh_1"]),
              f"22e {where}: screen_refresh_rounds=1 differs from off")
    # the bytes: every pass of a refresh round moves F columns, of a
    # screened round F_active
    rows = store.padded_rows
    screened_rounds = 0
    for r in per_round["ema"]:
        width = r["bytes"] // max(r["passes"] * rows, 1)
        check(r["bytes"] == r["passes"] * rows * width
              and width in (SCREEN_F, f_active),
              f"22e: a screened round moved {r['bytes']} bytes in "
              f"{r['passes']} passes")
        screened_rounds += width == f_active
    off_b = sum(r["bytes"] for r in per_round["off"])
    ema_b = sum(r["bytes"] for r in per_round["ema"])
    off_pass = off_b / sum(r["passes"] for r in per_round["off"])
    nominal = ((SCREEN_ROUNDS - screened_rounds) * SCREEN_F
               + screened_rounds * f_active) / (SCREEN_ROUNDS * SCREEN_F)
    check(screened_rounds >= SCREEN_ROUNDS - 3 and ema_b < off_b,
          f"22e: {screened_rounds} screened rounds moved {ema_b} bytes "
          f"against screen-off's {off_b}")
    out = {"rows": SCREEN_ROWS, "features": SCREEN_F, "f_active": f_active,
           "rounds": SCREEN_ROUNDS, "auc": aucs,
           "screened_rounds": screened_rounds,
           "bytes_streamed": {"off": off_b, "ema": ema_b},
           "bytes_ratio": ema_b / off_b, "nominal_ratio": nominal,
           "off_bytes_per_pass": off_pass,
           "s_per_round_streamed": {t: float(np.median([r["s"] for r in v]))
                                    for t, v in per_round.items()},
           "s": secs, "launches": counts}
    log(f"phase 22e: {json.dumps(out)}")
    return out


def phase_streaming(dev, X, y, ds, card):
    """Phase 22, every launch counter at 0 just before each run and read
    just after; fails unless B1 (bf16 and f32), B2, B3 and B4 launched."""
    from lightgbm_tpu_torch.utils.datasets import make_higgs_like

    t0 = time.perf_counter()
    launches, secs, out = {}, {}, {}
    Xv, yv = make_higgs_like(VALID_ROWS, NUM_FEATURES, seed=9)
    t1 = time.perf_counter()
    out["22a"], sds = phase_stream_north_star(dev, X, y, ds, Xv, yv,
                                              launches)
    secs["22a"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    out["22b"], sds_strict = phase_stream_strict(dev, X, y, ds, launches)
    secs["22b"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    out["22c"] = phase_stream_goss(dev, sds, ds, Xv, yv, launches)
    secs["22c"] = time.perf_counter() - t1
    del sds
    t1 = time.perf_counter()
    out["22d"] = phase_stream_recovery(dev, sds_strict, ds, X, y, launches)
    secs["22d"] = time.perf_counter() - t1
    del sds_strict
    t1 = time.perf_counter()
    out["22e"] = phase_stream_screening(dev, launches)
    secs["22e"] = time.perf_counter() - t1
    for name in ("hist_fused_bf16", "hist_fused_f32", "hist_partition_f32",
                 "split_iter", "predict_forest"):
        check(launches.get(name, 0) > 0, f"phase 22: {name} never launched")
    out["launches"] = launches
    out["s_by_part"] = secs
    out["s"] = time.perf_counter() - t0
    log(f"phase 22: {out['s']:.1f} s ({json.dumps(secs)}) on {card}, "
        f"launches {json.dumps(launches)}")
    return out


# phase 23: multi-device training on virtual shards of the one card.  23a:
# the north star at D = 4 (the default reduce_scatter_pipelined merge, 4
# chunks, f32 wire); 23b-e at D = 4 unless named.  23d's options run on the
# first DP_SUB_ROWS north-star rows (or their own shape) for DP_ROUNDS
# rounds; 23e kills after round index DP_KILL_AFTER of DP_RECOVERY_ROUNDS
DP_DEVICES, DP_ROUNDS, DP_SUB_ROWS = 4, 3, 200_000
DP_MERGES = ("psum", "reduce_scatter", "reduce_scatter_ring",
             "reduce_scatter_pipelined")
DP_RECOVERY_ROUNDS, DP_RECOVERY_EVERY, DP_KILL_AFTER = 8, 4, 6
# 23b: the lossy wires are gated where the reference gates them
# (tools/bench_multichip.py: AUC drift <= 1e-4 on its exactly-learnable
# "margin" task, 4,096 x 16, 15 leaves, 10 rounds); on the north star,
# like the reference's ungated noisy "ladder" task, the drift is recorded
# under a sanity bound (on an H100 80GB HBM3 at 700 W: bf16 6.6e-4, int8
# 4.2e-3 below f32 wire; the port's wire is the reference's bit for bit
# on the CPU, tests/test_torch_parallel.py)
WIRE_AUC_LIMIT = 1e-2
MARGIN_ROWS, MARGIN_FEATURES, MARGIN_ROUNDS = 4096, 16, 10
DP_PARAMS = dict(TRAIN_PARAMS, tree_learner="data")


def structure_regime(a, b, what, leaf_tol=False):
    """Split structure equal tree by tree (the first differing split, if
    any, a near tie: gains within 1e-4 relative, after which later trees
    grow on other scores and are not compared); the leaves' largest
    absolute and relative differences recorded over the equal trees, and
    with ``leaf_tol`` held to rtol 1e-5 / atol 1e-6 (the parity regime).
    Only leaf slots count: an internal node keeps the value it had as a
    leaf, and the root's comes from the root totals, which a slicing merge
    takes from the statistics (f32) where serial takes them from the
    (bf16-rounded) histogram, as the reference's do."""
    ties, worst_abs, worst_rel, n = [], 0.0, 0.0, 0
    for i in range(min(len(a.trees), len(b.trees))):
        ta, tb = tree_arrays(a, i), tree_arrays(b, i)
        d = first_split_difference(ta, tb)
        if d is not None:
            check(d["rel"] <= 1e-4, f"{what}: tree {i} differs: {d}")
            ties.append({"tree": i, **d})
            break
        leaf = ta["is_leaf"].astype(bool)
        la = ta["leaf_value"].astype(np.float64)[leaf]
        lb = tb["leaf_value"].astype(np.float64)[leaf]
        if leaf_tol:
            check(np.allclose(la, lb, rtol=1e-5, atol=1e-6),
                  f"{what}: tree {i} leaf values")
        diff = np.abs(la - lb)
        worst_abs = max(worst_abs, float(diff.max()))
        worst_rel = max(worst_rel, float((diff / np.maximum(
            np.abs(la), 1e-30)).max()))
        n += 1
    check(len(a.trees) == len(b.trees), f"{what}: tree counts")
    return ties, {"trees_equal_structure": n, "max_abs": worst_abs,
                  "max_rel": worst_rel}


def dp_counts(counts, d):
    """Whether every histogram kernel's launches on a mesh run are a
    multiple of the shard count (each pass launches once per shard)."""
    return all(v % d == 0 for k, v in counts.items()
               if k.startswith("hist_") and v)


def phase_dp_north_star(dev, X, y, ds, Xv, yv, launches):
    """23a: ``tree_learner="data"`` at the north star over DP_DEVICES
    virtual shards, mesh / serial / mesh-plain in turns (6 rounds each):
    B1 D times a root and B2 D times a wave, AUC within 1e-4 of serial and
    of plain, split structure equal to serial's (a near tie allowed) and
    the leaves within rtol 1e-5 / atol 1e-6, the dyadic round-1
    tree equal to serial's, host syncs a round no more than serial's, the
    merges and exchanges with no host read, the merge's CUDA-event ms, a
    round's peak bytes, the model served (B4)."""
    import copy

    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.parallel import data_parallel as DP
    from lightgbm_tpu_torch.serving import PredictorRuntime, pack_booster

    d = DP_DEVICES
    runs, turns = {}, {"mesh": [], "serial": [], "plain": []}
    for tag in ("mesh", "serial", "plain", "serial", "mesh"):
        extra = {"serial": {"tree_learner": "serial"},
                 "plain": {"hist_impl": "plain"}}.get(tag, {})
        DP.MERGE_TIMER["on"] = tag == "mesh"
        b, secs, counts, plain = train_run(lgb, ds, dict(DP_PARAMS, **extra),
                                           LATE_ROUNDS)
        DP.MERGE_TIMER["on"] = False
        merge = DP.merge_ms()
        turns[tag].append(secs / LATE_ROUNDS)
        if tag not in runs:
            runs[tag] = {"booster": b, "counts": counts, "plain_calls": plain,
                         "merge_ms_per_round": merge / LATE_ROUNDS}
        log(f"phase 23a {tag}: {secs / LATE_ROUNDS:.4f} s/round, launches "
            f"{json.dumps(counts)}, plain calls {plain}, merge "
            f"{merge / LATE_ROUNDS:.3f} ms/round")
    m, ser, pl = runs["mesh"], runs["serial"], runs["plain"]
    mb = m["booster"]
    check(mb._mesh is not None and mb._mesh.n_devices == d
          and mb._mesh.mode == "reduce_scatter_pipelined"
          and mb._mesh.chunks == 4 and mb._mesh.wire == "f32",
          f"23a mesh {getattr(mb, '_mesh', None)}")
    c = m["counts"]
    check(c["hist_fused_bf16"] == d * LATE_ROUNDS
          and c["hist_partition_bf16"] > 0 and dp_counts(c, d)
          and m["plain_calls"] == 0,
          f"23a launches {c} (B1 {d} a root, B2 {d} a wave), plain calls "
          f"{m['plain_calls']}")
    check(sum(v for k, v in pl["counts"].items() if k.startswith("hist_"))
          == 0, f"23a hist_impl='plain' launched {pl['counts']}")
    waves = {"mesh": c["hist_partition_bf16"] / d,
             "serial": ser["counts"]["hist_partition_bf16"]}
    aucs = {t: auc(r["booster"], Xv, yv, dev) for t, r in runs.items()}
    check(abs(aucs["mesh"] - aucs["serial"]) <= AUC_TOL
          and abs(aucs["mesh"] - aucs["plain"]) <= AUC_TOL,
          f"23a AUC {json.dumps(aucs)}")
    ties, leaf_diff = structure_regime(ser["booster"], mb,
                                       "23a mesh vs serial", leaf_tol=True)
    add_launches(launches, c)

    # the dyadic round-1 tree (phase 6's codes relabelled): mesh == serial
    yd = dyadic_label(X, SEED + 230)
    dsd = copy.copy(ds).set_label(yd)
    pd = dict(DP_PARAMS, objective="regression")
    (bm, bs), _, counts, _ = counted_run(lambda: (
        lgb.train(pd, dsd, 1), lgb.train(dict(pd, tree_learner="serial"),
                                          dsd, 1)))
    add_launches(launches, counts)
    check(trees_identical(bm, bs, 1), "23a dyadic: the mesh's round-1 tree "
          "differs from the serial one")

    # host syncs a round (sync debug mode), mesh against serial
    syncs = {"mesh": syncs_per_round(lgb, DP_PARAMS, ds),
             "serial": syncs_per_round(
                 lgb, dict(DP_PARAMS, tree_learner="serial"), ds)}
    check(syncs["mesh"]["syncs_per_round"]
          <= syncs["serial"]["syncs_per_round"],
          f"23a host syncs a round {json.dumps(syncs)}")

    # mesh rounds with every merge, every split scan and every exchange of
    # the pieces' winners under sync debug mode "error": none reads the host
    import lightgbm_tpu_torch.models.tree as T

    probe = lgb.Booster(dict(DP_PARAMS), ds)
    merges = round_without_host_reads(probe, DP.MeshLayout, "merge")
    scans = round_without_host_reads(probe, T, "find_best_split")
    exchanges = round_without_host_reads(probe, T, "_best_of_pieces")
    check(merges > 0 and scans > 0 and exchanges > 0,
          f"23a sync probe: {merges} merges, {scans} scans, {exchanges} "
          "exchanges")
    del probe

    # a round's peak device bytes above live, mesh against serial
    peaks = {}
    for tag, extra in (("mesh", {}), ("serial", {"tree_learner": "serial"})):
        peaks[tag] = peak_round_bytes(lgb.Booster(dict(DP_PARAMS, **extra),
                                                  ds))
    # served through PredictorRuntime (B4)
    rows = Xv[:RECOVERY_SERVE_ROWS]
    rt = PredictorRuntime(pack_booster(mb), max_bucket=MAX_BUCKET,
                          device=dev)
    served, _, counts, _ = counted_run(lambda: rt.predict(rows))
    check(counts["predict_forest"] > 0, f"23a serving launches {counts}")
    add_launches(launches, counts)
    sdiff = float(np.abs(served - mb.predict(rows)).max())
    check(sdiff <= 1e-5, f"23a served vs Booster.predict {sdiff:.2e}")
    pdiff = float(np.abs(mb.predict(Xv) - ser["booster"].predict(Xv)).max())
    out = {"devices": d, "virtual": True, "s_per_round_in_turns": turns,
           "merge_event_ms_per_round": m["merge_ms_per_round"],
           "auc": aucs, "near_ties_vs_serial": ties,
           "leaf_diff_vs_serial": leaf_diff,
           "pred_max_abs_diff_vs_serial": pdiff, "waves": waves,
           "launches": c, "host_syncs": syncs, "peak_bytes": peaks,
           "dyadic_round1_equal": True, "serve_max_abs_diff": sdiff,
           "under_sync_error": {"merges": merges, "scans": scans,
                                "exchanges": exchanges}}
    log(f"phase 23a: {json.dumps(out)}")
    return out, dsd, aucs["mesh"]


def phase_dp_merges(dev, X, ds, dsd, Xv, yv, auc_f32_wire, launches):
    """23b: every merge at f32 wire grows serial's round-1 tree on the
    dyadic tier at D = 4 and D = 8, bit for bit; bf16 and int8 wire within
    AUC 1e-4 of f32 wire on the reference's gate task
    (:func:`wire_margin_gate`), their drift at the north star recorded
    (within WIRE_AUC_LIMIT, a sanity bound); voting (top_k 20, the
    exact union at F = 28, and top_k 5, a real ballot) trains a valid
    tree, its AUC beside serial's."""
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.parallel import set_virtual_devices

    pd = dict(DP_PARAMS, objective="regression", hist_dtype="f32")
    serial = lgb.train(dict(pd, tree_learner="serial"), dsd, 1)
    dyadic = {}
    try:
        for d in (DP_DEVICES, 8):
            set_virtual_devices(d)
            for mode in DP_MERGES:
                b, _, counts, _ = counted_run(lambda: lgb.train(
                    dict(pd, histogram_merge=mode), dsd, 1))
                check(b._mesh.n_devices == d and dp_counts(counts, d),
                      f"23b {mode} D={d}: launches {counts}")
                check(trees_identical(serial, b, 1), f"23b {mode} D={d}: "
                      "the round-1 tree differs from serial's")
                dyadic[f"{mode}@{d}"] = True
                add_launches(launches, counts)
    finally:
        set_virtual_devices(DP_DEVICES)
    aucs = {"f32": auc_f32_wire}
    secs = {}
    for wire in ("bf16", "int8"):
        b, s, counts, _ = counted_run(lambda: lgb.train(
            dict(DP_PARAMS, histogram_wire=wire), ds, LATE_ROUNDS))
        aucs[wire] = auc(b, Xv, yv, dev)
        secs[wire] = s / LATE_ROUNDS
        add_launches(launches, counts)
        # the lossy wires re-round every hop's partial sums (bf16: 8 bits
        # of mantissa; int8: 255 levels a column): recorded, a sanity limit
        check(b._mesh.wire == wire and abs(aucs[wire] - aucs["f32"])
              <= WIRE_AUC_LIMIT, f"23b {wire} wire AUC {aucs[wire]} vs "
              f"f32 {aucs['f32']}")
    margin = wire_margin_gate(lgb, dev, launches)
    voting = {}
    for k in (20, 5):
        b, s, counts, _ = counted_run(lambda: lgb.train(
            dict(DP_PARAMS, tree_learner="voting", top_k=k), ds,
            DP_ROUNDS))
        add_launches(launches, counts)
        t = tree_arrays(b, 0)
        check(b._mesh.mode == "voting" and int(t["num_leaves"]) > 1,
              f"23b voting top_k={k}: {int(t['num_leaves'])} leaves")
        voting[f"top_k={k}"] = {"auc": auc(b, Xv, yv, dev),
                                "s_per_round": s / DP_ROUNDS,
                                "leaves_round1": int(t["num_leaves"])}
    serial3 = lgb.train(dict(DP_PARAMS, tree_learner="serial"), ds,
                        DP_ROUNDS)
    voting["serial_auc"] = auc(serial3, Xv, yv, dev)
    out = {"dyadic_round1_equal": dyadic, "wire_auc": aucs,
           "wire_auc_drift": {w: aucs[w] - aucs["f32"]
                              for w in ("bf16", "int8")},
           "wire_s_per_round": secs, "margin_gate": margin,
           "voting": voting}
    log(f"phase 23b: {json.dumps(out)}")
    return out


def wire_margin_gate(lgb, dev, launches):
    """The reference's wire quality gate (tools/bench_multichip.py's
    "margin" task: labels a deterministic function of three thresholded
    columns, 4,096 x 16, 15 leaves, lr 0.2, 10 rounds, held-out AUC from
    another seed): bf16 and int8 wire within AUC 1e-4 of f32 wire."""
    def make(seed):
        rng = np.random.default_rng(seed)
        X = rng.uniform(-1, 1, size=(MARGIN_ROWS, MARGIN_FEATURES)).astype(
            np.float32)
        logit = (4.0 * (X[:, 0] > 0.3) + 3.0 * (X[:, 1] < 0.1)
                 + 2.0 * (X[:, 2] > 0.6) - 4.5)
        return X, (logit > 0).astype(np.float32)

    X, y = make(1)
    Xv, yv = make(2)
    ds = lgb.Dataset(X, label=y)
    base = {"objective": "binary", "num_leaves": 15, "learning_rate": 0.2,
            "verbosity": -1, "tree_learner": "data", "mesh_shape": "1d"}
    aucs = {}
    for wire in ("f32", "bf16", "int8"):
        b, _, counts, _ = counted_run(lambda: lgb.train(
            dict(base, histogram_wire=wire), ds, MARGIN_ROUNDS))
        add_launches(launches, counts)
        aucs[wire] = auc(b, Xv, yv, dev)
    for wire in ("bf16", "int8"):
        check(abs(aucs[wire] - aucs["f32"]) <= AUC_TOL,
              f"23b margin gate: {wire} wire AUC {aucs[wire]} vs f32 "
              f"{aucs['f32']}")
    return aucs


def phase_dp_features(dev, ds, dsd, Xv, yv, launches):
    """23c: ``tree_learner="feature"`` (28 columns, 7 a shard) and
    ``mesh_shape="2x2"``: B1 without B2 (and no B3), the dyadic round-1
    tree equal to serial's; DP_ROUNDS binary rounds timed, AUC recorded."""
    import lightgbm_tpu_torch as lgb

    pd = dict(DP_PARAMS, objective="regression")
    serial = lgb.train(dict(pd, tree_learner="serial"), dsd, 1)
    out = {}
    for tag, extra in (("feature", {"tree_learner": "feature"}),
                       ("mesh_2x2", {"mesh_shape": "2x2"})):
        b, _, counts, _ = counted_run(lambda: lgb.train(dict(pd, **extra),
                                                        dsd, 1))
        lay = b._mesh
        check(lay is not None and lay.dc == (4 if tag == "feature" else 2)
              and counts["hist_fused_bf16"] > 0
              and counts["hist_partition_bf16"] == 0
              and counts["split_iter"] == 0 and dp_counts(counts, 4),
              f"23c {tag}: mesh {lay and (lay.dr, lay.dc)}, launches "
              f"{counts}")
        check(trees_identical(serial, b, 1), f"23c {tag}: the dyadic "
              "round-1 tree differs from serial's")
        add_launches(launches, counts)
        bb, s, counts, _ = counted_run(lambda: lgb.train(
            dict(DP_PARAMS, **extra), ds, DP_ROUNDS))
        add_launches(launches, counts)
        out[tag] = {"mesh": [lay.dr, lay.dc], "f_local": lay.f_loc,
                    "s_per_round": s / DP_ROUNDS,
                    "auc": auc(bb, Xv, yv, dev), "launches": counts}
    log(f"phase 23c: {json.dumps(out)}")
    return out


def dp_pair(lgb, ds, params, rounds, what, launches, d=DP_DEVICES):
    """Serial, then mesh runs of ``params``; the mesh's split structure
    equal to serial's (a near tie allowed, :func:`structure_regime`), the
    leaves' differences recorded; returns (mesh booster, serial booster,
    the record)."""
    ser, s_ser, _, _ = counted_run(lambda: lgb.train(
        dict(params, tree_learner="serial"), ds, rounds))
    b, s, counts, plain = counted_run(lambda: lgb.train(params, ds, rounds))
    check(b._mesh is not None and b._mesh.n_devices == d
          and dp_counts(counts, d) and plain == 0,
          f"{what}: mesh {b._mesh}, launches {counts}, plain calls {plain}")
    add_launches(launches, counts)
    ties, leaf_diff = structure_regime(ser, b, what)
    return b, ser, {"s_per_round": s / rounds,
                    "serial_s_per_round": s_ser / rounds,
                    "launches": counts, "near_ties": ties,
                    "leaf_diff": leaf_diff}


def phase_dp_options(dev, X, y, ds_cov, Xv, yv, launches):
    """23d: what the mesh composes with, DP_ROUNDS rounds each against
    serial (split structure equal, a near tie allowed, the leaves'
    differences recorded): the strict grower under psum (B1 pairs per
    shard, B3), multiclass at Covertype's shape (B5/B6 per shard), GOSS
    (per-shard samples: AUC within 5e-3 of serial GOSS), lambdarank at
    18a's shape, categorical columns at the airline table's shape (and
    voting's warning and fallback), linear leaves, int8 histograms."""
    import warnings

    import lightgbm_tpu_torch as lgb

    out = {}
    sub = DP_SUB_ROWS
    dsub = lgb.Dataset(X[:sub], label=y[:sub], params={"max_bin": MAX_BIN})
    b, _, r = dp_pair(lgb, dsub, dict(DP_PARAMS, grow_policy="leafwise",
                                      histogram_merge="psum"),
                      DP_ROUNDS, "23d strict psum", launches)
    check(r["launches"]["split_iter"] == DP_ROUNDS * (NUM_LEAVES - 1)
          and r["launches"]["hist_partition_bf16"] == 0,
          f"23d strict: launches {r['launches']}")
    out["strict_psum"] = r
    b, _, r = dp_pair(lgb, ds_cov, dict(COV_PARAMS, tree_learner="data"),
                      DP_ROUNDS, "23d multiclass", launches)
    check(r["launches"]["hist_fused_batched_bf16"]
          + r["launches"]["hist_segstats_bf16"] > 0,
          f"23d multiclass: launches {r['launches']}")
    out["multiclass"] = r
    gp = dict(GOSS_PARAMS, tree_learner="data")
    b, ser, r = dp_pair_goss(lgb, dsub, gp, launches)
    out["goss"] = r

    rng = np.random.default_rng(MSLR_SEED)
    sizes = np.full(MSLR_QUERIES, MSLR_DOCS)
    Xr, yr = mslr_like(sizes, rng)
    dr = lgb.Dataset(Xr, label=yr, group=sizes, params={"max_bin": MAX_BIN})
    b, ser, r = dp_pair(lgb, dr, dict(MSLR_PARAMS, tree_learner="data"),
                        DP_ROUNDS, "23d lambdarank", launches)
    r["ndcg@10"] = {"mesh": b.eval_train()[0][2],
                    "serial": ser.eval_train()[0][2]}
    out["lambdarank"] = r

    Xa, ya = airline_like(sub, SEED + 231)
    da = cat_dataset(lgb, Xa, ya)
    b, ser, r = dp_pair(lgb, da, DP_PARAMS, DP_ROUNDS, "23d categorical",
                        launches)
    check(cat_split_nodes(b) > 0, "23d categorical: no subset split")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        bv = lgb.train(dict(DP_PARAMS, tree_learner="voting"), da,
                       DP_ROUNDS)
    check(bv._mesh.mode == "reduce_scatter" and any(
        "reduce_scatter merge instead" in str(w.message) for w in caught),
        "23d categorical voting: no warning and fallback")
    structure_regime(ser, bv, "23d categorical voting fallback")
    r["voting_fallback"] = "reduce_scatter"
    out["categorical"] = r
    del da, dr

    dl = lgb.Dataset(X[:sub], label=y[:sub], free_raw_data=False,
                     params={"max_bin": MAX_BIN, "enable_bundle": False})
    b, ser, r = dp_pair(lgb, dl, dict(DP_PARAMS, linear_tree=True),
                        DP_ROUNDS, "23d linear", launches)
    check(b.trees[0].linear_coef is not None, "23d linear: no coefficients")
    out["linear"] = r
    b, _, counts, _ = counted_run(lambda: lgb.train(
        dict(DP_PARAMS, hist_dtype="int8"), dsub, DP_ROUNDS))
    ser = lgb.train(dict(DP_PARAMS, hist_dtype="int8",
                         tree_learner="serial"), dsub, DP_ROUNDS)
    check(counts["hist_fused_int8"] > 0 and dp_counts(counts, DP_DEVICES),
          f"23d int8: launches {counts}")
    add_launches(launches, counts)
    out["int8"] = {"launches": counts, "auc": {
        "mesh": auc(b, Xv, yv, dev), "serial": auc(ser, Xv, yv, dev)}}
    check(abs(out["int8"]["auc"]["mesh"] - out["int8"]["auc"]["serial"])
          <= 1e-3, f"23d int8 AUC {out['int8']['auc']}")
    log(f"phase 23d: {json.dumps(out)}")
    return out


def dp_pair_goss(lgb, ds, params, launches):
    """GOSS samples each shard's rows (per-shard keys), so its trees are
    not serial GOSS's: the AUCs within 5e-3 (a sanity limit; the gap is
    recorded), the tree replicated and every row scored."""
    from lightgbm_tpu_torch.utils.datasets import make_higgs_like

    Xv, yv = make_higgs_like(VALID_ROWS // 4, NUM_FEATURES, seed=9)
    dev = ds.device
    ser = lgb.train(dict(params, tree_learner="serial"), ds, DP_ROUNDS)
    b, s, counts, _ = counted_run(lambda: lgb.train(params, ds, DP_ROUNDS))
    add_launches(launches, counts)
    k_shard = b._goss_k_shard()
    check(b._mesh is not None and dp_counts(counts, DP_DEVICES)
          and np.isfinite(b._pred_train.cpu().numpy()).all(),
          f"23d GOSS: launches {counts}")
    aucs = {"mesh": auc(b, Xv, yv, dev), "serial": auc(ser, Xv, yv, dev)}
    check(abs(aucs["mesh"] - aucs["serial"]) <= 5e-3, f"23d GOSS {aucs}")
    return b, ser, {"s_per_round": s / DP_ROUNDS, "auc": aucs,
                    "k_per_shard": list(k_shard), "launches": counts}


def phase_dp_recovery(dev, ds, workdir, launches):
    """23e: a D = 4 ``train_resumable`` killed by SIGTERM after round index
    DP_KILL_AFTER and resumed at D = 4 equals the uninterrupted D = 4 run
    bit for bit; resumed at D = 2 and D = 8 it keeps the forest so far and
    continues with its structure; a checkpoint naming D = 3, or another
    merge mode, raises ``IncompatibleCheckpointError`` naming the field.
    (Another D merges the same partials in another order: structure equal
    to the uninterrupted run, a near tie allowed, the leaves recorded.)"""
    import shutil
    import signal

    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.parallel import set_virtual_devices
    from lightgbm_tpu_torch.training import (IncompatibleCheckpointError,
                                             load_checkpoint, resume_booster,
                                             train_resumable)

    root = os.path.join(workdir, "dp_recovery")
    shutil.rmtree(root, ignore_errors=True)
    params = dict(RECOVERY_PARAMS, tree_learner="data")
    kw = dict(checkpoint_rounds=DP_RECOVERY_EVERY, keep_last=3)

    def kill(booster, i):
        if i == DP_KILL_AFTER:
            os.kill(os.getpid(), signal.SIGTERM)

    def training():
        full = train_resumable(dict(params), ds, DP_RECOVERY_ROUNDS,
                               checkpoint_dir=os.path.join(root, "full"),
                               resume=False, **kw)
        killed = train_resumable(dict(params), ds, DP_RECOVERY_ROUNDS,
                                 checkpoint_dir=os.path.join(root, "kill"),
                                 resume=False, round_callbacks=[kill], **kw)
        again = train_resumable(dict(params), ds, DP_RECOVERY_ROUNDS,
                                checkpoint_dir=os.path.join(root, "kill"),
                                resume=True, **kw)
        return full, killed, again

    (full, killed, again), secs, counts, _ = counted_run(training)
    add_launches(launches, counts)
    check(killed.preempted and killed.rounds_done == DP_KILL_AFTER + 1
          and again.completed and full.booster._mesh.n_devices == DP_DEVICES,
          f"23e runs: {killed}, {again}")
    check(same_run(full.booster, again.booster),
          "23e: the resumed D = 4 run differs from the uninterrupted one")
    path = killed.last_checkpoint
    arrays, meta = load_checkpoint(path)
    check(meta["parallel"]["n_devices"] == DP_DEVICES
          and meta["parallel"]["merge_mode"] == "reduce_scatter_pipelined",
          f"23e checkpoint meta {meta['parallel']}")
    elastic = {}
    try:
        for d in (2, 8):
            set_virtual_devices(d)
            b = resume_booster(path, ds)
            check(b._mesh.n_devices == d and b._iter == DP_KILL_AFTER + 1,
                  f"23e resume at D = {d}: {b._mesh}, iter {b._iter}")
            while b._iter < DP_RECOVERY_ROUNDS:
                b.update()
            check(trees_identical(full.booster, b, DP_KILL_AFTER + 1),
                  f"23e resume at D = {d}: the checkpoint's trees changed")
            elastic[d] = structure_regime(full.booster, b,
                                          f"23e D=4 -> {d}")
    finally:
        set_virtual_devices(DP_DEVICES)
    refusals = {}
    for field, patch in (("n_devices", {"n_devices": 3}),
                         ("merge_mode", {"merge_mode": "psum"})):
        bad = dict(meta, parallel=dict(meta["parallel"], **patch))
        try:
            resume_booster((arrays, bad), ds)
            fail(f"23e: a checkpoint with {patch} resumed")
        except IncompatibleCheckpointError as e:
            check(e.field == field, f"23e refusal names {e.field}")
            refusals[field] = str(e)[:80]
    out = {"s": secs, "bit_identical": True,
           "elastic_vs_uninterrupted": {str(k): v for k, v in
                                        elastic.items()},
           "refusals": refusals}
    log(f"phase 23e: {json.dumps(out)}")
    return out


def phase_multi_device(dev, X, y, ds, ds_cov, workdir, card):
    """Phase 23 over DP_DEVICES virtual shards on the one card, every
    launch counter at 0 just before each run and read just after; fails
    unless B1, B2, B3, B4, B5/B6 and B1 int8 launched."""
    from lightgbm_tpu_torch.parallel import set_virtual_devices
    from lightgbm_tpu_torch.utils.datasets import make_higgs_like

    t0 = time.perf_counter()
    launches, secs, out = {}, {}, {}
    Xv, yv = make_higgs_like(VALID_ROWS, NUM_FEATURES, seed=9)
    set_virtual_devices(DP_DEVICES)
    try:
        t1 = time.perf_counter()
        out["23a"], dsd, auc_mesh = phase_dp_north_star(dev, X, y, ds, Xv,
                                                        yv, launches)
        secs["23a"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        out["23b"] = phase_dp_merges(dev, X, ds, dsd, Xv, yv, auc_mesh,
                                     launches)
        secs["23b"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        out["23c"] = phase_dp_features(dev, ds, dsd, Xv, yv, launches)
        secs["23c"] = time.perf_counter() - t1
        del dsd
        t1 = time.perf_counter()
        out["23d"] = phase_dp_options(dev, X, y, ds_cov, Xv, yv, launches)
        secs["23d"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        out["23e"] = phase_dp_recovery(dev, ds, workdir, launches)
        secs["23e"] = time.perf_counter() - t1
    finally:
        set_virtual_devices(0)
    for name in ("hist_fused_bf16", "hist_fused_f32", "hist_partition_bf16",
                 "split_iter", "predict_forest", "hist_fused_int8"):
        check(launches.get(name, 0) > 0, f"phase 23: {name} never launched")
    check(launches.get("hist_fused_batched_bf16", 0)
          + launches.get("hist_segstats_bf16", 0) > 0,
          "phase 23: neither B5 nor B6 launched")
    out["launches"] = launches
    out["s_by_part"] = secs
    out["s"] = time.perf_counter() - t0
    log(f"phase 23: {out['s']:.1f} s ({json.dumps(secs)}) on {card}, "
        f"launches {json.dumps(launches)}")
    return out


# ---------------------------------------------------------------------------
# phase 24: the serving mesh, streamed data parallelism and the
# multi-device sweep, on MESH_DEVICES virtual shards of the one card
# ---------------------------------------------------------------------------
MESH_DEVICES = 4
MESH_ULPS = 2                      # tp's bound (the reference's _ulp_tol)
MESH_COV_ROWS = 16_384             # Covertype-shaped rows served in 24a
MESH_CLI_ROWS = 8
SDP_PARAMS = dict(STREAM_PARAMS, tree_learner="data")
SDP_ROUNDS, SDP_GOSS_ROUNDS, SDP_STRICT_ROUNDS = 4, 3, 3   # 24b: 10 until phase 25
SDP_RECOVERY_ROUNDS, SDP_KILL_AFTER, SDP_RECOVERY_EVERY = 8, 6, 4


def ulp_ratio(got, want):
    """max |got - want| over MESH_ULPS ulp of the largest |want|."""
    tol = MESH_ULPS * np.spacing(np.float32(np.abs(want).max()))
    return float(np.abs(got.astype(np.float64) - want).max() / tol)


def regroup_bound(rt, codes, num_it=None):
    """Per row, the a-priori f32 bound on two groupings of the tree sum
    ``shrink * sum_t leaf_t`` (``(T + D) * 2^-24 * |shrink| * sum_t
    |leaf_t|``) plus MESH_ULPS ulp of the largest served output (each
    route's own transform rounding): tp regroups the single route's sum
    into D shard sums, which can differ by more than 2 ulp of the output
    once T is large.  ``[n]`` or ``[n, K]``, for served probabilities too
    (the transforms' slopes are at most 1)."""
    from lightgbm_tpu_torch.ops.predict import forest_sums_plain

    pf = rt.packed
    t = pf.num_trees if num_it is None else min(int(num_it), pf.num_trees)
    bins = torch.from_numpy(codes).to(rt.device)
    cols = [forest_sums_plain(s._replace(leaf=s.leaf.abs()), bins, t,
                              pf.depth_cap).double().cpu().numpy()
            for s in rt._soa]
    abs_sum = np.stack(cols, axis=1) if len(cols) > 1 else cols[0]
    return (t + MESH_DEVICES) * 2.0 ** -24 * abs(pf.shrink) * abs_sum


def mesh_forests(X, path, workdir):
    """24a's forests: phase 3's north-star artifact at each precision and
    phase 11's Covertype model, each with rows to serve."""
    from lightgbm_tpu_torch.serving import PackedForest

    ns = PackedForest.load(path)
    cov_path = os.path.join(workdir, "covertype_multiclass.npz")
    Xc, _ = covertype_like(MESH_COV_ROWS, SEED + 240)
    out = {f"north_star_{p}": (ns, path, X, p) for p in PRECISIONS}
    out["covertype_f32"] = (PackedForest.load(cov_path), cov_path, Xc, "f32")
    return out


def phase_serve_mesh(dev, X, path, workdir, launches):
    """24a: the serving mesh at full width (see the module docstring)."""
    import lightgbm_tpu_torch as lgb
    import lightgbm_tpu_torch.kernels.predict as KP
    from lightgbm_tpu_torch.ops import predict as OP
    from lightgbm_tpu_torch.parallel.mesh import row_bounds
    from lightgbm_tpu_torch.serving import ModelBank, PredictorRuntime

    builds, real_build = [], KP.build_node_tables

    def counted_build(soa):
        builds.append(1)
        return real_build(soa)

    out = {}
    for name, (pf, art, Xs, prec) in mesh_forests(X, path, workdir).items():
        nc = pf.num_class
        codes = pf.bin_mapper.transform(Xs[:MAX_BUCKET])
        kw = dict(max_bucket=MAX_BUCKET, forest_precision=prec, device=dev)
        single = PredictorRuntime(pf, **kw)
        rts = {pol: PredictorRuntime(pf, mesh_devices=MESH_DEVICES,
                                     shard_policy=pol, **kw)
               for pol in ("dp", "tp", "auto")}
        KP.build_node_tables = counted_build
        try:
            for rt in (single, *rts.values()):
                rt.warm()
            warm_builds = len(builds)
            bounds = regroup_bound(single, codes)
            routes, worst, served = collections.Counter(), 0.0, 0
            for b in single.buckets:
                want = single.predict_binned(codes[:b], raw_score=False)
                for pol, rt in rts.items():
                    route = rt.route_for(b)
                    got, _, counts, _ = counted_run(
                        lambda: rt.predict_binned(codes[:b], raw_score=False))
                    add_launches(launches, counts)
                    served += 1
                    routes[f"{pol}:{route}"] += 1
                    shards = MESH_DEVICES if route != "single" else 1
                    check(counts["predict_forest"] == shards * nc,
                          f"24a {name} {pol} bucket {b} ({route}): "
                          f"{counts['predict_forest']} B4 launches")
                    if route == "tp":
                        r = ulp_ratio(got, want)
                        worst = max(worst, r)
                        over = float((np.abs(got.astype(np.float64) - want)
                                      - bounds[:b]).max() / (MESH_ULPS *
                                      np.spacing(np.float32(
                                          np.abs(want).max()))))
                        check(over <= 1.0, f"24a {name} tp bucket {b}: "
                              f"{r:.2f} x {MESH_ULPS} ulp, past the "
                              "regrouping bound")
                    else:
                        check(np.array_equal(got, want),
                              f"24a {name} {pol} bucket {b} ({route}) "
                              "differs from the single route")
            trunc = {}
            for k in (1, 5, None):
                want = single.predict_binned(codes[:64], num_iteration=k,
                                             raw_score=False)
                got = rts["tp"].predict_binned(codes[:64], num_iteration=k,
                                               raw_score=False)
                trunc[str(k)] = ulp_ratio(got, want)
                over = float((np.abs(got.astype(np.float64) - want)
                              - regroup_bound(single, codes[:64], k)).max()
                             / (MESH_ULPS * np.spacing(np.float32(
                                 np.abs(want).max()))))
                check(over <= 1.0, f"24a {name} tp num_iteration={k}: "
                      f"{trunc[str(k)]:.2f} x {MESH_ULPS} ulp, past the "
                      "regrouping bound")
            new_builds = len(builds) - warm_builds
            check(new_builds == 0, f"24a {name}: {new_builds} node-table "
                  "builds after warm()")
        finally:
            KP.build_node_tables = real_build
        # the served probabilities against Booster.predict (f32) or the
        # dequantized oracle (bf16, int8)
        rows = Xs[:4096]
        tp_out = rts["tp"].predict(rows)
        if prec == "f32":
            ref_out = lgb.Booster(model_file=art).predict(rows)
        else:
            ref_out = rts["tp"].oracle.predict_numpy(
                pf.bin_mapper.transform(rows), raw_score=False)
        vs_ref = float(np.abs(tp_out - ref_out).max())
        check(vs_ref <= 1e-5, f"24a {name} tp vs reference {vs_ref:.2e}")
        # every shard route's kernel against its plain version, bit for bit
        n_cmp = min(4096, len(codes))
        bins = torch.from_numpy(codes[:n_cmp]).to(dev)
        shards, t_loc = rts["tp"]._tp_soa_parts()
        pairs = []
        for d, soas in enumerate(shards):
            for soa in soas:
                t0, t1 = OP.tree_window(t_loc, pf.num_trees, -d * t_loc)
                pairs.append((f"tp shard {d}",
                              KP.forest_sums(soa, bins, t0, t1,
                                             pf.depth_cap),
                              OP.forest_sums_plain(soa, bins, pf.num_trees,
                                                   pf.depth_cap, -d * t_loc)))
        for (a, e), (soas, _, _) in zip(row_bounds(n_cmp, MESH_DEVICES),
                                        rts["dp"]._dp_parts()):
            for soa in soas:
                pairs.append((f"dp rows [{a}, {e})",
                              KP.forest_sums(soa, bins[a:e], 0, pf.num_trees,
                                             pf.depth_cap),
                              OP.forest_sums_plain(soa, bins[a:e],
                                                   pf.num_trees,
                                                   pf.depth_cap)))
        kerr = max(float((g - w).abs().max()) for _, g, w in pairs)
        for what, g, w in pairs:
            check(torch.equal(g, w), f"24a {name} {what}: kernel != plain")
        out[name] = {"classes": nc, "trees": pf.num_trees,
                     "dispatches": served, "routes": dict(routes),
                     "tp_worst_over_2ulp": worst,
                     "tp_truncated_over_2ulp": trunc,
                     "regroup_bound_max": float(bounds.max()),
                     "tp_vs_reference_max_abs": vs_ref,
                     "trees_per_shard": t_loc,
                     "node_table_builds_after_warm": 0,
                     "kernel_vs_plain_max_abs_err": kerr}
        log(f"phase 24a {name}: {json.dumps(out[name])}")

    # rows/s of a 1,000,000-row predict_binned (codes binned once), dp
    # against single in turns; and the MicroBatcher on tp against single
    ns = mesh_forests(X, path, workdir)["north_star_f32"][0]
    big = ns.bin_mapper.transform(X)
    rt_single = PredictorRuntime(ns, max_bucket=MAX_BUCKET, device=dev)
    rt_dp = PredictorRuntime(ns, max_bucket=MAX_BUCKET, device=dev,
                             mesh_devices=MESH_DEVICES, shard_policy="dp")
    turns = {"single": [], "dp": []}
    outs = {}
    for tag in ("single", "dp", "dp", "single"):
        rt = rt_single if tag == "single" else rt_dp
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs[tag] = rt.predict_binned(big)
        turns[tag].append(len(big) / (time.perf_counter() - t0))
    check(np.array_equal(outs["dp"], outs["single"]),
          "24a 1,000,000-row dp predict differs from single")
    del big
    # the MicroBatcher on the single and tp routes in turns (single, tp,
    # tp, single), each turn's queue latencies read from its own batches
    banks, latency, answers = {}, {"single": [], "tp": []}, {}
    for tag, extra in (("single", {}), ("tp", {
            "mesh_devices": MESH_DEVICES, "shard_policy": "tp"})):
        bank = ModelBank(max_bucket=MAX_BUCKET, warm_on_deploy=True,
                         canary_rows=64, device=dev, **extra)
        check(bank.deploy("higgs", path)["ok"], f"24a {tag} deploy")
        banks[tag] = bank
    for tag in ("single", "tp", "tp", "single"):
        bank = banks[tag]
        mb = bank.batcher("higgs", max_batch=128, max_delay_ms=2.0)
        stats = bank.runtime("higgs").stats

        def serve():
            pend = []
            for row in X[:SINGLE_REQUESTS]:
                pend.append(mb.submit(row))
                mb.pump()
            mb.flush()
            return np.array([p_.result() for p_ in pend], np.float32)

        n0 = len(stats.queue_latencies)
        routes0 = dict(stats.snapshot()["route_dispatches"])
        answers[tag], secs, counts, _ = counted_run(serve)
        add_launches(launches, counts)
        snap = stats.snapshot()
        lat_ms = np.array(list(stats.queue_latencies)[n0:]) * 1e3
        latency[tag].append({
            "p50_ms": float(np.quantile(lat_ms, 0.50)),
            "p99_ms": float(np.quantile(lat_ms, 0.99)), "s": secs,
            "batches": int(lat_ms.size),
            "routes": {r: n - routes0.get(r, 0) for r, n in
                       snap["route_dispatches"].items()}})
        check(snap["fallbacks"] == 0, f"24a {tag} MicroBatcher fallbacks")
    rel = float(np.abs(answers["tp"] - answers["single"]).max())
    check(rel <= 1e-5 and all(t["routes"].get("tp", 0) > 0
                              for t in latency["tp"]),
          f"24a MicroBatcher tp vs single {rel:.2e}, routes "
          f"{[t['routes'] for t in latency['tp']]}")
    # the CLI in a subprocess with the environment variable
    lines = "".join(",".join(f"{v:.9g}" for v in r) + "\n"
                    for r in X[:MESH_CLI_ROWS])
    env = dict(os.environ, LIGHTGBM_TPU_TORCH_VIRTUAL_DEVICES=str(
        MESH_DEVICES))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "lightgbm_tpu_torch", "task=serve",
         f"input_model={path}", f"mesh_devices={MESH_DEVICES}",
         "shard_policy=tp", "max_batch=4", "show_stats=true"],
        input=lines, capture_output=True, text=True, cwd=ROOT, env=env,
        timeout=300)
    cli_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"24a task=serve mesh_devices=4 exit "
          f"{proc.returncode}: {proc.stderr[-2000:]}")
    got = np.array([float(v) for v in proc.stdout.split()], np.float64)
    want = rt_single.predict(X[:MESH_CLI_ROWS])
    check(got.shape == want.shape
          and float(np.abs(got - want).max()) <= 1e-5,
          f"24a CLI answers {proc.stdout[:200]!r}")
    check('"mesh_devices": 4' in proc.stderr, "24a CLI stats name no "
          "4-device mesh")
    out.update(rows_per_s_in_turns=turns, microbatcher=latency,
               microbatcher_tp_vs_single_max_abs=rel,
               cli_serve_s=cli_s, cli_rows=MESH_CLI_ROWS)
    log(f"phase 24a: rows/s {json.dumps(turns)}, MicroBatcher "
        f"{json.dumps(latency)}, CLI {cli_s:.1f} s")
    return out


def sdp_rounds(booster, rounds):
    """``rounds`` timed updates of a streamed dp Booster, each shard's
    odometer and pass count per round."""
    shards = booster._mesh.shards
    per = []
    for _ in range(rounds):
        b0 = [sh.bytes_streamed for sh in shards]
        p0 = shards[0].passes
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        booster.update()
        torch.cuda.synchronize()
        per.append({"s": time.perf_counter() - t0,
                    "shard_bytes": [sh.bytes_streamed - b for sh, b
                                    in zip(shards, b0)],
                    "passes": shards[0].passes - p0})
    return per


def phase_stream_dp(dev, X, y, ds, Xv, yv, workdir, launches):
    """24b: streamed data parallelism (see the module docstring)."""
    import copy
    import shutil
    import signal

    import lightgbm_tpu_torch as lgb
    import lightgbm_tpu_torch.data.stream_dp as SDP
    import lightgbm_tpu_torch.data.stream_grow as SG
    from lightgbm_tpu_torch.parallel import data_parallel as DP
    from lightgbm_tpu_torch.parallel import set_virtual_devices
    from lightgbm_tpu_torch.training import resume_booster, train_resumable

    sds = lgb.Dataset.from_blocks(row_blocks(X, y, STREAM_BLOCK_ROWS),
                                  params=STREAM_PARAMS, reference=ds)
    store = sds.block_store
    d = MESH_DEVICES
    runs, turns = {}, {"stream_dp": [], "serial_streamed": [],
                       "in_memory_mesh": []}
    for tag in ("stream_dp", "serial_streamed", "in_memory_mesh",
                "stream_dp"):
        DP.MERGE_TIMER["on"] = tag != "serial_streamed"
        if tag == "in_memory_mesh":
            b, secs, counts, plain = train_run(lgb, ds, DP_PARAMS, SDP_ROUNDS)
            r = {"booster": b, "counts": counts, "plain_calls": plain}
        else:
            params = SDP_PARAMS if tag == "stream_dp" else STREAM_PARAMS

            def go():
                b = lgb.Booster(dict(params), sds)
                return b, (sdp_rounds(b, SDP_ROUNDS) if tag == "stream_dp"
                           else streamed_rounds(b, store, SDP_ROUNDS))
            (b, per), secs, counts, plain = counted_run(go)
            r = {"booster": b, "per_round": per, "counts": counts,
                 "plain_calls": plain}
        DP.MERGE_TIMER["on"] = False
        r["merge_ms_per_round"] = DP.merge_ms() / SDP_ROUNDS
        turns[tag].append(secs / SDP_ROUNDS)
        runs.setdefault(tag, r)
        log(f"phase 24b {tag}: {secs / SDP_ROUNDS:.4f} s/round, launches "
            f"{json.dumps(r['counts'])}, merge "
            f"{r['merge_ms_per_round']:.2f} ms/round")
    k, ser, mem = (runs[t] for t in ("stream_dp", "serial_streamed",
                                     "in_memory_mesh"))
    kb = k["booster"]
    shards = kb._mesh.shards
    check(isinstance(kb._mesh, SDP.StreamMesh) and kb._mesh.n_devices == d
          and all(sh.num_blocks == store.num_blocks // d for sh in shards),
          f"24b mesh {kb._mesh}")
    passes = sum(r["passes"] for r in k["per_round"])
    check(k["counts"]["hist_fused_bf16"] == passes * store.num_blocks
          and k["counts"]["hist_partition_bf16"] == 0
          and k["plain_calls"] == 0,
          f"24b launches {k['counts']} over {passes} passes, plain calls "
          f"{k['plain_calls']}")
    add_launches(launches, k["counts"])
    add_launches(launches, mem["counts"])
    ser_bytes = [r["bytes"] for r in ser["per_round"]]
    # each shard streams a quarter of what serial streams a pass
    quarter = [[b * d for b in r["shard_bytes"]] for r in k["per_round"]]
    check(all(len(set(q)) == 1 for q in quarter)
          and all(q[0] * ser["per_round"][i]["passes"]
                  == ser_bytes[i] * k["per_round"][i]["passes"]
                  for i, q in enumerate(quarter)),
          f"24b shard bytes a round {[r['shard_bytes'] for r in k['per_round']]}"
          f" against serial's {ser_bytes}")
    buffers = sum(sh.peak_device_buffers for sh in shards)
    check(buffers <= d * (store.prefetch_blocks + 1),
          f"24b {buffers} block buffers on the device")
    aucs = {t: auc(r["booster"], Xv, yv, dev) for t, r in runs.items()}
    check(abs(aucs["stream_dp"] - aucs["serial_streamed"]) <= AUC_TOL
          and abs(aucs["stream_dp"] - aucs["in_memory_mesh"]) <= AUC_TOL,
          f"24b AUC {json.dumps(aucs)}")

    # the dyadic round-1 tree at each histogram precision: the kernels'
    # streamed dp tree == the plain versions' (B1 f32/bf16/int8 held
    # against plain on the main path's blocks), and at f32/bf16 == serial
    # streaming's (int8 quantizes per shard block: recorded)
    yd = dyadic_label(X, SEED + 241)
    sdd = copy.copy(sds).set_label(yd)
    pd = dict(SDP_PARAMS, objective="regression")
    dyadic = {}
    for mode in ("bf16", "f32", "int8"):
        pm = dict(pd, hist_dtype=mode)
        (bk, bp, bs), _, counts, _ = counted_run(lambda: (
            lgb.train(pm, sdd, 1), lgb.train(dict(pm, hist_impl="plain"),
                                             sdd, 1),
            lgb.train(dict(pm, tree_learner="serial"), sdd, 1)))
        add_launches(launches, counts)
        check(bk._mesh is not None and counts[f"hist_fused_{mode}"] > 0
              and trees_identical(bk, bp, 1),
              f"24b dyadic {mode}: the kernels' streamed dp tree differs "
              f"from the plain versions' (launches {counts})")
        dyadic[mode] = {"kernel_equals_plain": True,
                        "equals_serial_streamed": trees_identical(bk, bs, 1)}
        check(mode == "int8" or dyadic[mode]["equals_serial_streamed"],
              f"24b dyadic {mode}: the streamed dp tree differs from "
              "serial streaming's")
    del bk, bp, bs
    peaks = {"stream_dp": peak_round_bytes(lgb.Booster(dict(SDP_PARAMS),
                                                       sds)),
             "serial_streamed": peak_round_bytes(
                 lgb.Booster(dict(STREAM_PARAMS), sds))}

    # the strict grower streamed under psum: 200,000 rows, 4 blocks, one a
    # shard; B3 once a split iteration
    Xs, ys = X[:STREAM_STRICT_ROWS], y[:STREAM_STRICT_ROWS]
    sst = lgb.Dataset.from_blocks(row_blocks(Xs, ys, STREAM_STRICT_BLOCK),
                                  params=STREAM_STRICT_PARAMS, reference=ds)
    ps = dict(STREAM_STRICT_PARAMS, tree_learner="data",
              histogram_merge="psum")
    (bst, tree_ms, trees), secs, counts, plain = counted_run(
        lambda: event_timed(SG, "_grow_strict",
                            lambda: lgb.train(ps, sst, SDP_STRICT_ROUNDS)))
    iters = SDP_STRICT_ROUNDS * (ps["num_leaves"] - 1)
    nb = sst.block_store.num_blocks
    check(bst._mesh.n_devices == d and counts["split_iter"] == iters
          and counts["hist_fused_f32"] == (SDP_STRICT_ROUNDS + iters) * nb
          and plain == 0 and trees == SDP_STRICT_ROUNDS,
          f"24b strict launches {counts}, plain calls {plain}")
    add_launches(launches, counts)
    # B3 (and the pairs' B1) against the plain versions: a dyadic round
    sst_d = copy.copy(sst).set_label(yd[:STREAM_STRICT_ROWS])
    psd = dict(ps, objective="regression")
    (bk, bp), _, counts, _ = counted_run(lambda: (
        lgb.train(psd, sst_d, 1),
        lgb.train(dict(psd, hist_impl="plain"), sst_d, 1)))
    add_launches(launches, counts)
    check(counts["split_iter"] == ps["num_leaves"] - 1
          and trees_identical(bk, bp, 1),
          f"24b strict dyadic: kernel tree != plain tree ({counts})")
    strict = {"rows": STREAM_STRICT_ROWS, "blocks": nb, "launches": counts,
              "s": secs, "ms_per_split_iteration":
              tree_ms / (ps["num_leaves"] - 1),
              "dyadic_kernel_equals_plain": True}
    del sst, sst_d, bst, bk, bp

    # GOSS at the source with the int8 wire over reduce_scatter_ring
    pg = dict(SDP_PARAMS, boosting="goss",
              histogram_merge="reduce_scatter_ring", histogram_wire="int8")

    def goss():
        b = lgb.Booster(dict(pg), sds)
        return b, sdp_rounds(b, SDP_GOSS_ROUNDS)
    (bg, per_g), secs_g, counts_g, plain_g = counted_run(goss)
    check(bg._mesh.wire == "int8" and plain_g == 0
          and counts_g["hist_partition_f32"] > 0
          and counts_g["hist_partition_f32"] % d == 0
          and counts_g["hist_fused_f32"] % d == 0,
          f"24b GOSS launches {counts_g}, plain calls {plain_g}")
    add_launches(launches, counts_g)
    shard_pass = (store.padded_rows // d) * store.num_features
    gathered = [[(sb - r["passes"] * shard_pass) / shard_pass
                 for sb in r["shard_bytes"]] for r in per_g]
    # serial streaming's GOSS at the same rounds: one host sample over all
    # rows where each shard samples its own (statistically equivalent)
    bgs = lgb.train(dict(pg, tree_learner="serial"), sds, SDP_GOSS_ROUNDS)
    auc_g = {"stream_dp_goss_int8_wire": auc(bg, Xv, yv, dev),
             "serial_streamed_goss": auc(bgs, Xv, yv, dev)}
    check(abs(auc_g["stream_dp_goss_int8_wire"]
              - auc_g["serial_streamed_goss"]) <= 0.01,
          f"24b GOSS AUC {json.dumps(auc_g)}")
    del bgs
    # B2 (and B1) of the compacted shards against the plain versions
    (bk, bp), _, counts, _ = counted_run(lambda: (
        lgb.train(dict(pg, objective="regression"), sdd, 1),
        lgb.train(dict(pg, objective="regression", hist_impl="plain"),
                  sdd, 1)))
    add_launches(launches, counts)
    check(counts["hist_partition_f32"] > 0 and trees_identical(bk, bp, 1),
          f"24b GOSS dyadic: kernel tree != plain tree ({counts})")
    del bk, bp, sdd
    goss_out = {"gathered_over_shard_pass": gathered,
                "s_per_round": [r["s"] for r in per_g], "auc": auc_g,
                "launches": counts_g, "goss_k_shard": list(
                    bg._goss_k_shard())}
    del bg

    # kill after round index SDP_KILL_AFTER, resume at D = 4, then D = 2
    root = os.path.join(workdir, "stream_dp_recovery")
    shutil.rmtree(root, ignore_errors=True)
    pr = dict(SDP_PARAMS, bagging_fraction=0.8, bagging_freq=1)
    kw = dict(checkpoint_rounds=SDP_RECOVERY_EVERY, keep_last=3)

    def kill(booster, i):
        if i == SDP_KILL_AFTER:
            os.kill(os.getpid(), signal.SIGTERM)

    def recovery():
        full = train_resumable(dict(pr), sds, SDP_RECOVERY_ROUNDS,
                               checkpoint_dir=os.path.join(root, "full"),
                               resume=False, **kw)
        cut = train_resumable(dict(pr), sds, SDP_RECOVERY_ROUNDS,
                              checkpoint_dir=os.path.join(root, "kill"),
                              resume=False, round_callbacks=[kill], **kw)
        again = train_resumable(dict(pr), sds, SDP_RECOVERY_ROUNDS,
                                checkpoint_dir=os.path.join(root, "kill"),
                                resume=True, **kw)
        return full, cut, again
    (full, cut, again), secs_r, counts_r, _ = counted_run(recovery)
    add_launches(launches, counts_r)
    check(cut.preempted and cut.rounds_done == SDP_KILL_AFTER + 1
          and again.completed and full.booster._mesh.n_devices == d,
          f"24b recovery runs {cut}, {again}")
    check(same_run(full.booster, again.booster),
          "24b: the resumed D = 4 run differs from the uninterrupted one")
    set_virtual_devices(2)
    try:
        b2 = resume_booster(cut.last_checkpoint, sds)
        check(b2._mesh.n_devices == 2, f"24b resume at D = 2: {b2._mesh}")
        while b2._iter < SDP_RECOVERY_ROUNDS:
            b2.update()
    finally:
        set_virtual_devices(d)
    check(trees_identical(full.booster, b2, SDP_KILL_AFTER + 1),
          "24b resume at D = 2: the checkpoint's trees changed")
    elastic = structure_regime(full.booster, b2, "24b D=4 -> 2")
    del b2, full, cut, again
    per = k["per_round"]
    out = {"devices": d, "virtual": True, "blocks": store.num_blocks,
           "blocks_per_shard": store.num_blocks // d,
           "s_per_round_in_turns": turns, "auc": aucs,
           "merge_event_ms_per_round": k["merge_ms_per_round"],
           "in_memory_mesh_merge_event_ms_per_round":
           mem["merge_ms_per_round"],
           "passes_per_round": [r["passes"] for r in per],
           "shard_bytes_per_round": [r["shard_bytes"] for r in per],
           "serial_bytes_per_round": ser_bytes,
           "peak_device_buffers": buffers, "peak_bytes": peaks,
           "launches": k["counts"], "dyadic_round1": dyadic,
           "strict_psum": strict, "goss_int8_wire": goss_out,
           "recovery_s": secs_r, "resume_bit_identical": True,
           "elastic_d2_vs_uninterrupted": elastic}
    log(f"phase 24b: {json.dumps(out)}")
    return out


def phase_sweep_devices(dds, workdir, launches):
    """24c: 13c's 12-config grid over 4 devices in groups of 2, through the
    service and the CLI, both ledgers byte-equal to 13c's single-device
    ledger (the service writing it anew when 13c's file is missing)."""
    import hashlib

    from lightgbm_tpu_torch.sweep import SweepService

    root = os.path.join(workdir, "sweep_devices")
    os.makedirs(root, exist_ok=True)
    grid = recovery_grid()
    base = {"objective": "regression", "verbosity": -1,
            "cv_segment_rounds": RECOVERY_SEGMENT_ROUNDS}

    def service(ledger, **kw):
        path_ = os.path.join(root, ledger)
        if os.path.exists(path_):
            os.unlink(path_)
        return SweepService(
            grid, dds, base_params=base,
            num_boost_round=RECOVERY_SWEEP_ROUNDS,
            nfold=CV_FOLDS, early_stopping_rounds=CV_ES, seed=SWEEP_SEED,
            ledger_path=path_, clock=lambda: 0.0, **kw).run()

    single = os.path.join(workdir, "recovery_sweep", "clean.RData")
    if not os.path.exists(single):
        service("single.RData")
        single = os.path.join(root, "single.RData")
    res, secs, counts, plain = counted_run(lambda: service(
        "mesh.RData", n_devices=MESH_DEVICES, group_size=2))
    add_launches(launches, counts)
    check(res.completed and plain == 0, f"24c sweep: {res.error}")
    plan = res.stats["plan"]
    groups = sorted({b["group"] for b in res.stats["buckets"]})
    check(plan["n_groups"] == 2 and plan["group_size"] == 2
          and groups == list(range(min(2, plan["units"]))),
          f"24c plan {plan}, groups {groups}")
    b_rounds = [b["rounds"] for b in res.stats["buckets"]]
    check(all(r < RECOVERY_SWEEP_ROUNDS for r in b_rounds),
          f"24c bucket rounds {b_rounds}: early stopping did not end every "
          f"bucket before the cap {RECOVERY_SWEEP_ROUNDS}")

    def digest(p_):
        with open(p_, "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()

    want = digest(single)
    check(digest(os.path.join(root, "mesh.RData")) == want,
          "24c: the 4-device ledger differs from the single-device one")
    # the CLI on the same rows, written exactly
    from lightgbm_tpu_torch.utils.rdata import read_rdata

    Xd, yd = diamonds_split()
    csv = os.path.join(root, "diamonds.csv")
    np.savetxt(csv, np.column_stack([yd, Xd]), delimiter=",", fmt="%.17g",
               header=",".join(["label"] + [f"f{j}" for j in
                                            range(Xd.shape[1])]),
               comments="")
    grid_json = os.path.join(root, "grid.json")
    with open(grid_json, "w") as f:
        json.dump({"rows": grid}, f)
    ledger_cli = os.path.join(root, "cli.RData")
    if os.path.exists(ledger_cli):
        os.unlink(ledger_cli)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "lightgbm_tpu_torch", "task=sweep",
         f"data={csv}", "header=true", "label_column=name:label",
         f"sweep_grid={grid_json}", f"ledger={ledger_cli}",
         f"sweep_devices={MESH_DEVICES}", "sweep_group_size=2",
         "objective=regression", "verbosity=-1",
         f"cv_segment_rounds={RECOVERY_SEGMENT_ROUNDS}",
         f"num_iterations={RECOVERY_SWEEP_ROUNDS}", f"nfold={CV_FOLDS}",
         f"early_stopping_rounds={CV_ES}", f"seed={SWEEP_SEED}"],
        capture_output=True, text=True, cwd=ROOT, timeout=600)
    cli_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"24c task=sweep exit {proc.returncode}: "
          f"{proc.stderr[-2000:]}")
    a = read_rdata(ledger_cli)["paramGrid"]
    b = read_rdata(single)["paramGrid"]
    check(a == b, "24c: the CLI's 4-device ledger rows differ from the "
          "single-device ledger's")
    summary = json.loads(proc.stderr.strip().splitlines()[-1])
    out = {"configs": len(grid), "plan": plan, "groups": groups,
           "buckets": [{k_: v for k_, v in b_.items()
                        if k_ in ("group", "configs", "rounds", "s")}
                       for b_ in res.stats["buckets"]],
           "service_s": secs, "cli_s": cli_s, "cli_summary": summary,
           "ledger_sha256": want, "ledgers_equal": True,
           "cli_bytes_equal": digest(ledger_cli) == want}
    log(f"phase 24c: {json.dumps(out)}")
    return out


def phase_multi_device_rest(dev, X, y, ds, dds, path, workdir, card):
    """Phase 24 over MESH_DEVICES virtual shards; fails unless B4 (dp and
    tp), B1 (f32 and bf16), B2 and B3 launched."""
    from lightgbm_tpu_torch.parallel import set_virtual_devices
    from lightgbm_tpu_torch.utils.datasets import make_higgs_like

    t0 = time.perf_counter()
    launches, secs, out = {}, {}, {}
    Xv, yv = make_higgs_like(VALID_ROWS, NUM_FEATURES, seed=9)
    set_virtual_devices(MESH_DEVICES)
    try:
        t1 = time.perf_counter()
        out["24a"] = phase_serve_mesh(dev, X, path, workdir, launches)
        secs["24a"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        out["24b"] = phase_stream_dp(dev, X, y, ds, Xv, yv, workdir,
                                     launches)
        secs["24b"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        out["24c"] = phase_sweep_devices(dds, workdir, launches)
        secs["24c"] = time.perf_counter() - t1
    finally:
        set_virtual_devices(0)
    for name in ("predict_forest", "hist_fused_bf16", "hist_fused_f32",
                 "hist_fused_int8", "hist_partition_f32", "split_iter"):
        check(launches.get(name, 0) > 0, f"phase 24: {name} never launched")
    out["launches"] = launches
    out["s_by_part"] = secs
    out["s"] = time.perf_counter() - t0
    out["virtual_shards"] = MESH_DEVICES
    log(f"phase 24: {out['s']:.1f} s ({json.dumps(secs)}) on {card}, "
        f"launches {json.dumps(launches)}")
    return out


# ---------------------------------------------------------------------------
# phase 25: the production loop — the refresh daemon over the north star's
# blocks with a fault at every pipeline site, a retune on the grid-search
# workflow's data, task=refresh in a subprocess, profile_training at the
# north star, and the launch budgets
# ---------------------------------------------------------------------------
# 25a: phase 6's params on 131,072-row blocks; generation 1 takes the first
# REFRESH_FIRST_BLOCKS blocks and REFRESH_INITIAL rounds, generations 2-4 a
# block each (the last the padded tail) and REFRESH_ROUNDS rounds.  A
# checkpoint every 2 rounds: at 5, a 5-round generation that starts at
# round 10 writes none before its end, so a preempted generation could not
# retry from its own checkpoint
REFRESH_FIRST_BLOCKS, REFRESH_INITIAL, REFRESH_ROUNDS = 5, 10, 5
REFRESH_CKPT_ROUNDS, REFRESH_SLO_MS = 2, 120_000.0
REFRESH_SERVE_ROWS = 16_384
# 25b: the diamonds split in 16,384-row blocks, 4 configs of
# paramGrid.json's learning_rate 0.1 rows, the workflow's cv() arguments
RETUNE_BLOCK, RETUNE_CONFIGS, RETUNE_INITIAL = 16_384, 4, 20
# 25c: two north-star blocks, then a third; 25d: profile_training's rounds
CLI_REFRESH_INITIAL, CLI_REFRESH_ROUNDS, PROFILE_ROUNDS = 3, 2, 10


def daemon_with_feed(root, params, dev, injector=None, **kw):
    """A RefreshDaemon on the wall clock over an in-memory feed."""
    import shutil

    from lightgbm_tpu_torch.pipeline import (ArrivalFeed, RefreshDaemon,
                                             wall_clock)

    shutil.rmtree(root, ignore_errors=True)
    feed = ArrivalFeed(wall_clock)
    return RefreshDaemon(params, root, feed=feed, injector=injector,
                         clock=wall_clock, device=dev, **kw), feed


def packed_equal(a_path, b_path):
    from lightgbm_tpu_torch.serving.packed import PackedForest

    a, b = PackedForest.load(a_path), PackedForest.load(b_path)
    return all(np.array_equal(getattr(a, f), getattr(b, f)) for f in (
        "split_feature", "split_bin", "left", "right", "is_leaf",
        "leaf_value")) and np.array_equal(a.init_score, b.init_score)


def served_vs_model(d, Xs, dev, what):
    """The bank's served scores against ``Booster(model_file=<live
    artifact>).predict`` on the same rows (B4 against the plain replay)."""
    import lightgbm_tpu_torch as lgb

    got = d.bank.predict(d.model_name, Xs)
    want = lgb.Booster(model_file=d._live_path, device=dev).predict(Xs)
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    check(err <= 1e-5, f"{what}: served scores {err:.2e} from "
          f"Booster(model_file={os.path.basename(d._live_path)}).predict")
    return err


def refresh_generations(d, feed, blocks, Xs, dev, inj=None):
    """Drive 25a's four generations; with ``inj`` arm continue_train in
    generation 2, artifact_push in 3 and flip in 4.  Returns the events and
    each flip's served-score error."""
    from lightgbm_tpu_torch.faults import FaultSpec

    k = REFRESH_FIRST_BLOCKS
    events, served = [], {}

    def tick(expect):
        ev = d.tick()
        check(ev is not None and ev["event"] == expect,
              f"25a generation {d._gen + 1}: {expect} expected, got "
              f"{None if ev is None else {x: v for x, v in ev.items() if x != 'report'}}")
        events.append({x: v for x, v in ev.items() if x != "report"})
        if expect == "flipped":
            served[ev["version"]] = served_vs_model(d, Xs, dev,
                                                    f"25a {ev['version']}")
        return ev

    for X_b, y_b in blocks[:k]:
        feed.push(X_b, y_b)
    tick("flipped")
    feed.push(*blocks[k])
    if inj is not None:
        # the 5th round callback of the generation (round 15), after the
        # round-14 checkpoint
        inj.arm(FaultSpec(site="continue_train",
                          after=inj.hits["continue_train"] + 4, times=1))
        tick("preempted")
        ev = tick("flipped")
        check(str(ev["resumed_from"]).endswith(".lgckpt"),
              f"25a the preempted generation resumed from "
              f"{ev['resumed_from']}, not its checkpoint")
    else:
        tick("flipped")
    feed.push(*blocks[k + 1])
    if inj is not None:
        before = d.bank.predict(d.model_name, Xs)
        inj.arm(FaultSpec(site="artifact_push", after=inj.hits[
            "artifact_push"], times=1))
        ev = tick("rejected")
        check(ev["poisoned"] and ev["stage"] == "ingest"
              and d.bank.version(d.model_name) == "g0002"
              and np.array_equal(before, d.bank.predict(d.model_name, Xs)),
              f"25a poisoned artifact: {ev}; version "
              f"{d.bank.version(d.model_name)}")
    tick("flipped")
    feed.push(*blocks[k + 2])
    if inj is not None:
        inj.arm(FaultSpec(site="flip", after=inj.hits["flip"], times=1))
        tick("rolled_back")
        check(d.bank.version(d.model_name) == "g0003"
              and d._live_path.endswith("model_g0003.npz"),
              f"25a rollback: serving {d.bank.version(d.model_name)}, "
              f"anchored on {d._live_path}")
        served["g0003_after_rollback"] = served_vs_model(
            d, Xs, dev, "25a after the rollback")
    else:
        tick("flipped")
    check(d.tick() is None, "25a the daemon is not idle after generation 4")
    return events, served


def phase_refresh_north_star(dev, X, y, Xv, yv, workdir, launches):
    """25a: the refresh loop at the north star, faulted and unfaulted."""
    import shutil

    import lightgbm_tpu_torch as lgb
    import lightgbm_tpu_torch.pipeline.daemon as D
    from lightgbm_tpu_torch.faults import FaultInjector
    from lightgbm_tpu_torch.serving.packed import PackedForest, pack_booster
    from lightgbm_tpu_torch.training import train_resumable

    blocks = list(row_blocks(X, y, STREAM_BLOCK_ROWS)())
    check(len(blocks) == REFRESH_FIRST_BLOCKS + 3,
          f"25a: {len(blocks)} blocks")
    Xs = Xv[:REFRESH_SERVE_ROWS]
    kw = dict(refresh_rounds=REFRESH_ROUNDS, initial_rounds=REFRESH_INITIAL,
              checkpoint_rounds=REFRESH_CKPT_ROUNDS,
              staleness_slo_ms=REFRESH_SLO_MS)
    runs = {}
    for tag in ("faulted", "control"):
        inj = FaultInjector() if tag == "faulted" else None
        d, feed = daemon_with_feed(os.path.join(workdir, f"refresh_{tag}"),
                                   STREAM_PARAMS, dev, injector=inj, **kw)
        ((events, served), train_ms), secs, counts, plain = counted_run(
            lambda: calls_event_ms(D, "train_resumable",
                                   lambda: refresh_generations(
                                       d, feed, blocks, Xs, dev, inj)))
        check(plain == 0, f"25a {tag}: {plain} plain-version calls")
        add_launches(launches, counts)
        runs[tag] = {"daemon": d, "events": events, "served": served,
                     "s": secs, "counts": counts, "train_ms": train_ms}
    f, c = runs["faulted"]["daemon"], runs["control"]["daemon"]
    for g in (2, 3, 4):
        name = f"model_g{g:04d}.npz"
        check(packed_equal(os.path.join(f.models_dir, name),
                           os.path.join(c.models_dir, name)),
              f"25a faulted {name} differs from the control run's")
    check(f._live_path.endswith("model_g0003.npz")
          and c._live_path.endswith("model_g0004.npz"),
          f"25a live artifacts {f._live_path}, {c._live_path}")
    for tag in ("faulted", "control"):
        k = runs[tag]["counts"]
        check(k["hist_fused_bf16"] > 0 and k["predict_forest"] > 0
              and k["hist_partition_bf16"] == 0,
              f"25a {tag} launches {k}")
    # generation 2 by hand: train_resumable(init_model=<generation 1>)
    g1 = os.path.join(c.models_dir, "model_g0001.npz")
    mapper = PackedForest.load(g1).bin_mapper
    ds2 = lgb.Dataset.from_blocks(blocks[:REFRESH_FIRST_BLOCKS + 1],
                                  params=dict(STREAM_PARAMS),
                                  reference=mapper, device=dev)
    hand_dir = os.path.join(workdir, "refresh_hand")
    shutil.rmtree(hand_dir, ignore_errors=True)
    res = train_resumable(dict(STREAM_PARAMS), ds2,
                          REFRESH_INITIAL + REFRESH_ROUNDS,
                          checkpoint_dir=hand_dir,
                          checkpoint_rounds=REFRESH_CKPT_ROUNDS,
                          init_model=g1)
    hand = os.path.join(hand_dir, "g2.npz")
    pack_booster(res.booster).save(hand)
    check(res.completed and packed_equal(hand, os.path.join(
        c.models_dir, "model_g0002.npz")),
        "25a generation 2 differs from train_resumable(init_model="
        "<generation 1>) by hand")
    del ds2
    # generation 1 through the plain versions: AUC within AUC_TOL
    ds1 = lgb.Dataset.from_blocks(blocks[:REFRESH_FIRST_BLOCKS],
                                  params=dict(STREAM_PARAMS),
                                  reference=mapper, device=dev)
    plain = lgb.train(dict(STREAM_PARAMS, hist_impl="plain"), ds1,
                      REFRESH_INITIAL)
    del ds1
    auc_kernel = auc(lgb.Booster(model_file=g1, device=dev), Xv, yv, dev)
    auc_plain = auc(plain, Xv, yv, dev)
    check(abs(auc_kernel - auc_plain) <= AUC_TOL,
          f"25a generation 1 AUC {auc_kernel:.6f} kernel vs "
          f"{auc_plain:.6f} plain")
    gens = {}
    for tag in ("faulted", "control"):
        d = runs[tag]["daemon"]
        recs = d.tracker.snapshot()
        gens[tag] = {"events": runs[tag]["events"],
                     "served_max_abs": runs[tag]["served"],
                     "train_event_ms": runs[tag]["train_ms"],
                     "staleness": recs, "s": runs[tag]["s"],
                     "launches": runs[tag]["counts"]}
    out = {"generations": gens, "auc_kernel": auc_kernel,
           "auc_plain": auc_plain, "blocks": len(blocks),
           "rounds": [e.get("rounds") for e in runs["control"]["events"]]}
    log("phase 25a: " + json.dumps({
        t: {"s": g["s"], "staleness_ms": [
            r["staleness_ms"] for r in g["staleness"]["generations"]],
            "decomposition": [r["decomposition"]
                              for r in g["staleness"]["generations"]],
            "train_event_ms": g["train_event_ms"],
            "events": [e["event"] for e in g["events"]]}
        for t, g in gens.items()}) + f", AUC kernel {auc_kernel:.6f} "
        f"plain {auc_plain:.6f}")
    return out


def batched_kernel_vs_plain(bins, num_bins, e, dev, what):
    """B6 + B3 (the fused strict grower over ``e`` elements) against their
    plain versions on ``bins`` with dyadic statistics: the same tables."""
    from lightgbm_tpu_torch.models.gbdt import HyperScalars, HyperScalarsBatch
    from lightgbm_tpu_torch.models.tree import grow_trees_batched

    gen = torch.Generator(device="cpu").manual_seed(SEED + 25)
    n, nf = bins.shape
    g = (torch.randint(-8, 9, (n, e), generator=gen).float() / 8).to(dev)
    ones = torch.ones((n, e), dtype=torch.float32, device=dev)
    stats = torch.stack([g, ones, ones], -1)
    scal = HyperScalars(learning_rate=0.1, lambda_l1=0.0, lambda_l2=0.0,
                        min_data_in_leaf=20.0, min_sum_hessian=1e-3,
                        min_gain_to_split=0.0, max_depth=0)
    batch = HyperScalarsBatch(*(torch.full((e,), float(v), device=dev)
                                for v in scal))
    fmask = torch.ones((e, nf), dtype=torch.float32, device=dev)
    out = {}
    for impl in ("auto", "plain"):
        out[impl] = grow_trees_batched(bins, stats, fmask, batch.ctx(),
                                       batch.max_depth, 31, num_bins, 1,
                                       hist_impl=impl, hist_dtype="f32")
    check(all(torch.equal(a, b) for a, b in zip(out["auto"][:3],
                                                 out["plain"][:3])),
          f"{what}: B6 + B3 differ from their plain versions on exact sums")


def phase_retune(dev, workdir, launches):
    """25b: a retune on the grid-search workflow's diamonds split with a
    sweep_promote fault; the ledger against a SweepService run by hand."""
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.faults import FaultInjector
    from lightgbm_tpu_torch.sweep import SweepService

    Xd, yd = diamonds_split()
    blocks = [(Xd[lo:lo + RETUNE_BLOCK], yd[lo:lo + RETUNE_BLOCK])
              for lo in range(0, len(yd), RETUNE_BLOCK)]
    grid = recovery_grid()[:RETUNE_CONFIGS]
    params = dict(CV_PARAMS, verbosity=-1, stream_block_rows=RETUNE_BLOCK)
    inj = FaultInjector()
    root = os.path.join(workdir, "retune")
    d, feed = daemon_with_feed(
        root, params, dev, injector=inj, refresh_rounds=REFRESH_ROUNDS,
        initial_rounds=RETUNE_INITIAL, sweep_grid=grid,
        sweep_rounds=CV_ROUNDS, sweep_nfold=CV_FOLDS,
        sweep_early_stopping=CV_ES)
    for b in blocks:
        feed.push(*b)
    steps = {}
    for tag, fn, expect in (("generation_1", d.tick, "flipped"),
                            ("retune", d.retune, "preempted"),
                            ("retry", d.tick, "retuned")):
        if tag == "retune":
            inj.arm("sweep_promote")
        ev, secs, counts, plain = counted_run(fn)
        check(ev is not None and ev["event"] == expect and plain == 0,
              f"25b {tag}: {expect} expected, got {ev}, {plain} plain "
              f"calls")
        add_launches(launches, counts)
        steps[tag] = {"event": {k: v for k, v in ev.items()
                                if k != "report"}, "s": secs,
                      "counts": counts}
    check(steps["retune"]["event"]["phase"] == "sweep_promote",
          f"25b the fault stopped {steps['retune']['event']}")
    sweep_counts, retry_counts = (steps[t]["counts"]
                                  for t in ("retune", "retry"))
    check(sweep_counts["split_iter"] > 0
          and sweep_counts["hist_segstats_f32"] > 0,
          f"25b sweep launches {sweep_counts}")
    check(retry_counts["split_iter"] == 0
          and retry_counts["hist_segstats_f32"] == 0
          and retry_counts["hist_segstats_bf16"] == 0,
          f"25b the retry redid sweep units: {retry_counts}")
    with open(os.path.join(d._sweep_dir(2), "ledger.json")) as f:
        ledger = json.load(f)["rows"]
    top = min(ledger, key=lambda r: -r["score"])
    winner = steps["retry"]["event"]["winner"]
    check(all(winner[k] == top[k] for k in winner)
          and steps["retry"]["event"]["rounds"] == max(
              int(top["iteration"]), 1),
          f"25b winner {winner} is not the ledger's best {top}")
    served = served_vs_model(d, Xd[:4096], dev, "25b the retuned model")
    # the ledger against a SweepService run by hand on the same Dataset
    ds = lgb.Dataset(np.concatenate([b[0] for b in blocks]),
                     label=np.concatenate([b[1] for b in blocks]),
                     params=dict(params), device=dev)
    ds.bin_mapper = d._ref_mapper
    hand = os.path.join(root, "hand")
    res = SweepService(grid, ds, base_params=dict(params),
                       num_boost_round=CV_ROUNDS, nfold=CV_FOLDS,
                       early_stopping_rounds=CV_ES, seed=2,
                       ledger_path=os.path.join(hand, "ledger.json"),
                       checkpoint_dir=os.path.join(hand, "ckpt")).run()
    check(res.completed, f"25b the sweep by hand: {res.error}")
    with open(os.path.join(hand, "ledger.json")) as f:
        hand_rows = json.load(f)["rows"]
    check(hand_rows == ledger, "25b the daemon's ledger differs from the "
          "SweepService run by hand")
    ds.construct()
    batched_kernel_vs_plain(ds.X_binned, ds.num_bins, CV_FOLDS, dev, "25b")
    out = {"configs": len(grid), "ledger": ledger, "winner": winner,
           "served_max_abs": served,
           "steps": {t: {"event": s["event"], "s": s["s"],
                         "launches": s["counts"]} for t, s in steps.items()}}
    log(f"phase 25b: {json.dumps({t: s['s'] for t, s in steps.items()})} s,"
        f" winner {json.dumps(winner)} at {steps['retry']['event']['rounds']}"
        f" rounds, sweep launches {json.dumps(sweep_counts)}")
    return out


def phase_refresh_cli(dev, X, y, workdir):
    """25c: ``task=refresh`` in a subprocess, twice over a growing watch
    directory of north-star blocks."""
    import shutil

    from lightgbm_tpu_torch.serving import ModelBank

    root = os.path.join(workdir, "refresh_cli")
    shutil.rmtree(root, ignore_errors=True)
    watch, state = os.path.join(root, "watch"), os.path.join(root, "state")
    os.makedirs(watch)
    blocks = list(row_blocks(X, y, STREAM_BLOCK_ROWS)())
    argv = [sys.executable, "-m", "lightgbm_tpu_torch", "task=refresh",
            f"watch_dir={watch}", f"state_dir={state}",
            f"initial_rounds={CLI_REFRESH_INITIAL}",
            f"refresh_rounds={CLI_REFRESH_ROUNDS}", f"device={dev.type}",
            f"stream_block_rows={STREAM_BLOCK_ROWS}"] + [
        f"{k}={v}" for k, v in TRAIN_PARAMS.items()]
    runs = []
    for i, n_blocks in enumerate((2, 3)):
        for j in range(n_blocks):
            path = os.path.join(watch, f"block{j}.npz")
            if not os.path.exists(path):
                np.savez(path, X=blocks[j][0], y=blocks[j][1])
        t0 = time.perf_counter()
        proc = subprocess.run(argv, capture_output=True, text=True,
                              cwd=ROOT, timeout=300)
        secs = time.perf_counter() - t0
        check(proc.returncode == 0, f"25c task=refresh run {i + 1} exit "
              f"{proc.returncode}: {proc.stderr[-2000:]}")
        events = [json.loads(ln) for ln in proc.stdout.splitlines()
                  if ln.startswith("{")]
        summary = json.loads(proc.stderr.strip().splitlines()[-1])
        rounds = CLI_REFRESH_INITIAL + i * CLI_REFRESH_ROUNDS
        check([e["event"] for e in events] == ["flipped"]
              and events[0]["version"] == f"g{i + 1:04d}"
              and events[0]["rounds"] == rounds
              and summary["generation"] == i + 1
              and summary["served"] == 1 and summary["breaches"] == [],
              f"25c run {i + 1}: events {events}, summary {summary}")
        runs.append({"s": secs, "events": events, "summary": summary})
    check(str(runs[1]["events"][0]["resumed_from"]).endswith(
        "model_g0001.npz"), f"25c the rerun did not re-anchor: "
        f"{runs[1]['events'][0]}")
    import lightgbm_tpu_torch as lgb

    art = os.path.join(state, "models", "model_g0002.npz")
    bank = ModelBank(device=dev)
    bank.deploy("model", art, version="g0002")
    Xs = X[:4096]
    got = bank.predict("model", Xs)
    want = lgb.Booster(model_file=art, device=dev).predict(Xs)
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    check(err <= 1e-5, f"25c served {err:.2e} from the model file")
    log(f"phase 25c: runs {[r['s'] for r in runs]} s, served {err:.2e}")
    return {"runs": runs, "served_max_abs": err}


def phase_profile_north_star(dev, X, y, ds, workdir, launches):
    """25d: profile_training at the north star (CUDA events), its timed
    rounds against lgb.train, B1/B2 launches and kernel vs plain."""
    import lightgbm_tpu_torch as lgb
    import lightgbm_tpu_torch.models.tree as T
    import lightgbm_tpu_torch.ops.histogram as H
    from lightgbm_tpu_torch.config import parse_params
    from lightgbm_tpu_torch.models.gbdt import (Booster, HyperScalars,
                                                resolve_hist_dtype,
                                                resolve_wave_width)
    from lightgbm_tpu_torch.models.tree import grow_tree, tree_to_arrays
    from lightgbm_tpu_torch.utils.profiling import profile_training

    trace = os.path.join(workdir, "p25_trace")
    boosters, orig = [], Booster.update_many

    def spy(self, k):
        orig(self, k)
        boosters.append(self)

    Booster.update_many = spy
    try:
        report, secs, counts, plain = counted_run(
            lambda: profile_training(dict(TRAIN_PARAMS), X, y,
                                     PROFILE_ROUNDS, trace_dir=trace,
                                     device=dev))
    finally:
        Booster.update_many = orig
    check(plain == 0, f"25d {plain} plain-version calls")
    add_launches(launches, counts)
    keys = {"bin_construct_s", "histogram_pass_s", "split_scan_s",
            "partition_s", "tree_grow_s", "round_s", "train_total_s",
            "num_boost_round", "rows", "rows_per_s", "hist_dtype",
            "wave_width", "wave_tail"}
    check(keys <= set(report) and all(report[k] > 0 for k in keys
                                      if k.endswith("_s"))
          and report["rows"] == len(y) and report["hist_dtype"] == "bf16",
          f"25d report {report}")
    check(os.path.exists(os.path.join(trace, "profile_training.trace.json")),
          "25d no trace written")
    want = lgb.train(dict(TRAIN_PARAMS), ds, PROFILE_ROUNDS)
    got = boosters[-1]
    check(len(got.trees) == len(want.trees) == PROFILE_ROUNDS
          and all(all(np.array_equal(a[k], b[k], equal_nan=True) for k in a)
                  for a, b in ((tree_to_arrays(s), tree_to_arrays(t))
                               for s, t in zip(got.trees, want.trees))),
          "25d the profiled rounds differ from lgb.train's")
    # one histogram pass: B1 once; one tree: B1 once and B2 once a wave;
    # on the profile's exact statistics the kernels equal their plain
    # versions bit for bit
    p = parse_params(dict(TRAIN_PARAMS))
    n_pad = int(ds.row_mask.shape[0])
    hd, ww = resolve_hist_dtype(p, n_pad), resolve_wave_width(p, n_pad)
    stats = torch.stack([ds.y, torch.ones_like(ds.y), ds.row_mask], -1)
    seg = torch.where(ds.row_mask > 0.5, 0, 2).to(torch.int32)
    _, _, c_hist, _ = counted_run(lambda: H.compute_histograms(
        ds.X_binned, stats, seg, 2, ds.num_bins, "auto", hd))
    fmask = torch.ones(ds.num_feature_, dtype=torch.float32, device=dev)
    ctx = HyperScalars.from_params(p).ctx()
    waves = {"n": 0}
    tree_orig = T.hist_partition_fused

    def count_waves(*a, **k):
        waves["n"] += 1
        return tree_orig(*a, **k)

    T.hist_partition_fused = count_waves
    try:
        (tk, rk), _, c_tree, _ = counted_run(lambda: grow_tree(
            ds.X_binned, stats, fmask, ctx, p.num_leaves, ds.num_bins,
            p.max_depth, hist_dtype=hd, wave_width=ww))
    finally:
        T.hist_partition_fused = tree_orig
    mode = "bf16" if hd == "bf16" else "f32"
    check(c_hist[f"hist_fused_{mode}"] == 1
          and c_tree[f"hist_fused_{mode}"] == 1
          and c_tree[f"hist_partition_{mode}"] == waves["n"] > 0,
          f"25d launches: histogram pass {c_hist}, tree {c_tree}, "
          f"{waves['n']} waves")
    tp_, rp = grow_tree(ds.X_binned, stats, fmask, ctx, p.num_leaves,
                        ds.num_bins, p.max_depth, hist_impl="plain",
                        hist_dtype=hd, wave_width=ww)
    a, b = tree_to_arrays(tk), tree_to_arrays(tp_)
    check(all(np.array_equal(a[k], b[k], equal_nan=True) for k in a)
          and torch.equal(rk, rp),
          "25d B1/B2 differ from their plain versions on exact sums")
    ms = {k[:-2] + "_ms": report[k] * 1e3 for k in report
          if k.endswith("_s")}
    out = {"report": report, "event_ms": ms, "s": secs,
           "launches": counts, "waves_per_tree": waves["n"]}
    log(f"phase 25d: {json.dumps(report)}")
    return out


def phase_card_budgets():
    """25e: the ``*_card`` launch budgets, measured in a fresh process
    (late in a long process the profiler can lose records): every one
    between its floor and its ceiling."""
    code = ("import json; from lightgbm_tpu_torch.analysis.budgets import "
            "LAUNCH_BUDGETS, check_launch_budgets; print(json.dumps("
            "check_launch_budgets([b.name for b in LAUNCH_BUDGETS "
            "if b.where == 'card'])))")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=ROOT, timeout=300)
    check(proc.returncode == 0, f"25e launch budgets exit {proc.returncode}:"
          f" {proc.stderr[-2000:]}")
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    check(len(res) == 3 and all(r["ok"] for r in res),
          f"25e launch budgets {res}")
    out = {r["name"]: [r["floor"], r["measured"], r["budget"]] for r in res}
    log("phase 25e: " + json.dumps(out))
    return out


def phase_production_loop(dev, X, y, ds, workdir, card):
    """Phase 25, every launch counter at 0 just before each run and read
    just after; fails unless B1, B2, B3, B4 and B6 launched."""
    from lightgbm_tpu_torch.utils.datasets import make_higgs_like

    t0 = time.perf_counter()
    launches, secs, out = {}, {}, {}
    Xv, yv = make_higgs_like(VALID_ROWS, NUM_FEATURES, seed=9)
    for part, fn in (
            ("25a", lambda: phase_refresh_north_star(dev, X, y, Xv, yv,
                                                     workdir, launches)),
            ("25b", lambda: phase_retune(dev, workdir, launches)),
            ("25c", lambda: phase_refresh_cli(dev, X, y, workdir)),
            ("25d", lambda: phase_profile_north_star(dev, X, y, ds, workdir,
                                                     launches)),
            ("25e", phase_card_budgets)):
        t1 = time.perf_counter()
        out[part] = fn()
        secs[part] = time.perf_counter() - t1
    for name in ("predict_forest", "hist_fused_bf16", "hist_partition_bf16",
                 "split_iter", "hist_segstats_f32"):
        check(launches.get(name, 0) > 0, f"phase 25: {name} never launched")
    out["launches"] = launches
    out["s_by_part"] = secs
    out["s"] = time.perf_counter() - t0
    log(f"phase 25: {out['s']:.1f} s ({json.dumps(secs)}) on {card}, "
        f"launches {json.dumps(launches)}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    try:
        import lightgbm_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the lightgbm_tpu_torch package is missing "
              f"beside this script ({e})", file=sys.stderr)
        return 2
    from lightgbm_tpu_torch.dataset import BinMapper

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card, build_s, clock_mhz = phase_device()
    errs = phase_kernel_vs_plain(dev)
    log(f"elapsed through phase 2: {time.perf_counter() - t_start:.1f} s")

    workdir = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(workdir, exist_ok=True)
    X, y, mapper, path, path2 = build_model(workdir)
    main_path, runtimes = {}, {}
    for prec in PRECISIONS:
        main_path[prec], runtimes[prec] = phase_main_path(prec, X, path,
                                                          path2)
    table, breakdown, head, path_errs = phase_times(runtimes, X, clock_mhz)
    log(f"elapsed through phase 3-4: {time.perf_counter() - t_start:.1f} s")
    runtimes.clear()
    hist_errs, bins, root_stats, wave, first_wave, strict_segs = \
        phase_hist_kernels(dev, X, y, mapper)
    log(f"elapsed through phase 5: {time.perf_counter() - t_start:.1f} s")
    train, ds_north = phase_train(dev, X, y, workdir)
    log(f"elapsed through phase 6: {time.perf_counter() - t_start:.1f} s")
    hist_times = phase_hist_times(bins, root_stats, wave, first_wave,
                                  strict_segs)
    del first_wave, strict_segs
    b6_errs, dbins = phase_b3_b6(dev, bins)
    Xc, yc = covertype_like(COV_ROWS, SEED + 120)
    cov_bins = torch.from_numpy(BinMapper.fit(Xc, max_bin=MAX_BIN).transform(
        Xc)).to(dev)
    b5_errs = phase_b5(dev, bins, cov_bins)
    log(f"elapsed through phase 7, 9: {time.perf_counter() - t_start:.1f} s")
    del cov_bins
    strict = phase_strict(dev, X, y)
    cv_res, dds = phase_cv(dev)
    sweep = phase_sweep(dds, workdir)
    fused_round = profile_fused_round(dds)
    log(f"elapsed through phase 8: {time.perf_counter() - t_start:.1f} s")
    b3_b6_times = phase_b3_b6_times(dbins)
    del dbins
    ns_cv, b5_wave = phase_cv_north_star(dev, X, y)
    b5_times = phase_b5_times(b5_wave)
    log(f"elapsed through phase 10: {time.perf_counter() - t_start:.1f} s")
    del b5_wave
    multiclass, ds_cov = phase_multiclass(dev, Xc, yc, workdir)
    log(f"elapsed through phase 11: {time.perf_counter() - t_start:.1f} s")
    int8_ratios = phase_int8_kernel(dev, bins, root_stats, wave)
    int8 = phase_int8_train(dev, X, y, train["auc"]["bf16"])
    int8["cv"] = phase_int8_cv(dds, cv_res["kernels"])
    int8["cli"] = phase_int8_cli(workdir)
    int8["times"] = phase_int8_times(bins, root_stats, wave)
    int8["err_over_bound"] = int8_ratios
    log(f"elapsed through phase 12: {time.perf_counter() - t_start:.1f} s")
    del bins, root_stats, wave
    t13 = time.perf_counter()
    recovery = {"train": phase_recovery_train(dev, X, y, workdir),
                "cli": phase_recovery_cli(workdir),
                "sweep": phase_recovery_sweep(dds, workdir)}
    recovery["s"] = time.perf_counter() - t13
    log(f"phase 13: {recovery['s']:.1f} s")
    rec_launches = dict(recovery["train"]["launches"])
    for k, v in recovery["sweep"]["launches"].items():
        rec_launches[k] = rec_launches.get(k, 0) + v
    phase14 = phase_bagging_rf(dev, X, y, dds)
    l14 = phase14["launches"]
    phase15 = phase_objectives(dev, X, y, dds, train["auc"]["bf16"])
    l15 = phase15["launches"]
    phase16 = phase_goss_dart(dev, X, y, Xc, yc, dds, workdir, card)
    l16 = phase16["launches"]
    phase17 = phase_categorical(dev, workdir, card)
    l17 = phase17["launches"]
    phase18 = phase_ranking(dev, workdir, card)
    l18 = phase18["launches"]
    phase19 = phase_constraints(
        dev, X, y, Xc, yc, workdir, card,
        {"s_per_round": train["s_per_round"]["bf16"],
         "s_per_round_median": train["s_per_round_median"]["bf16"]})
    l19 = phase19["launches"]
    del Xc, yc
    phase20 = phase_linear_introspection(dev, X, y, card,
                                         train["s_per_round"]["bf16"])
    l20 = phase20["launches"]
    phase21 = phase_continuation(dev, ds_north, dds, ds_cov, card)
    l21 = phase21["launches"]
    phase22 = phase_streaming(dev, X, y, ds_north, card)
    l22 = phase22["launches"]
    phase23 = phase_multi_device(dev, X, y, ds_north, ds_cov, workdir, card)
    l23 = phase23["launches"]
    del ds_cov
    phase24 = phase_multi_device_rest(dev, X, y, ds_north, dds, path,
                                      workdir, card)
    l24 = phase24["launches"]
    phase25 = phase_production_loop(dev, X, y, ds_north, workdir, card)
    l25 = phase25["launches"]
    del ds_north

    kernels = []
    for prec in PRECISIONS:
        h = head[prec]
        # phases 6, 11 and 12e serve their trained models at f32
        by_phase = {"3": main_path[prec]["launches"]}
        if prec == "f32":
            by_phase.update({"6": train["serve_predict_launches"],
                             "11": multiclass["serve_predict_launches"],
                             "12e": int8["cli"]["serve_predict_launches"],
                             "13": rec_launches["predict_forest"],
                             "14": l14["predict_forest"],
                             "15": l15["predict_forest"],
                             "16": l16["predict_forest"],
                             "17": l17.get("predict_forest", 0),
                             "18": l18.get("predict_forest", 0),
                             "19": l19.get("predict_forest", 0),
                             "20": l20.get("predict_forest", 0),
                             "21": l21.get("predict_forest", 0),
                             "22": l22.get("predict_forest", 0),
                             "23": l23.get("predict_forest", 0),
                             "24": l24.get("predict_forest", 0),
                             "25": l25.get("predict_forest", 0)})
        kernels.append({
            "name": f"predict_forest_{prec}", "route": "cuda",
            "source": KERNEL_SOURCE, "replaces": REPLACES,
            "launches": main_path[prec]["launches"],
            "launches_by_phase": by_phase,
            "max_abs_err": path_errs[prec], "max_err": path_errs[prec],
            "phase2_max_abs_err": errs[prec],
            "ms": h["kernel_ms"], "plain_ms": h["plain_ms"],
            "bound_ms": h["bound_ms"], "bound_by": h["bound_by"],
            "walk_bound_ms": h["walk_bound_ms"],
            "library_ms": None, "bucket": MAX_BUCKET,
        })
    for name, (source, replaces) in HIST_SOURCES.items():
        for mode in HIST_MODES:
            t = hist_times[f"{name}_{mode}"]
            kernels.append({
                "name": f"{name}_{mode}", "route": "cuda", "source": source,
                "replaces": replaces,
                "launches": train["launches"][mode][f"{name}_{mode}"],
                "launches_by_phase": {
                    "6": train["launches"][mode][f"{name}_{mode}"],
                    "13": rec_launches.get(f"{name}_{mode}", 0),
                    "14": l14.get(f"{name}_{mode}", 0),
                    "15": l15.get(f"{name}_{mode}", 0),
                    "16": l16.get(f"{name}_{mode}", 0),
                    "17": l17.get(f"{name}_{mode}", 0),
                    "18": l18.get(f"{name}_{mode}", 0),
                    "19": l19.get(f"{name}_{mode}", 0),
                    "20": l20.get(f"{name}_{mode}", 0),
                    "21": l21.get(f"{name}_{mode}", 0),
                    "22": l22.get(f"{name}_{mode}", 0),
                    "23": l23.get(f"{name}_{mode}", 0),
                    "24": l24.get(f"{name}_{mode}", 0),
                    "25": l25.get(f"{name}_{mode}", 0)},
                "max_abs_err": hist_errs[name][mode],
                "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": t["library_ms"], "shape": t["shape"],
                "other_shapes": {r["shape"]: {x: r[x] for x in (
                    "ms", "plain_ms", "bound_ms", "library_ms")}
                    for key, r in hist_times.items()
                    if key.startswith(f"{name}_{mode}_")},
            })
    t = b3_b6_times["split_iter"]
    kernels.append({
        "name": "split_iter", "route": "cuda", "source": SPLIT_ITER_SOURCE[0],
        "replaces": SPLIT_ITER_SOURCE[1],
        "launches": (cv_res["kernels"]["counts"]["split_iter"]
                     + sweep["launches"]["split_iter"]),
        "launches_by_phase": {
            "8b": cv_res["kernels"]["counts"]["split_iter"],
            "8c": sweep["launches"]["split_iter"],
            "13": rec_launches["split_iter"],
            "14": l14["split_iter"], "15": l15["split_iter"],
            "16": l16["split_iter"], "17": l17.get("split_iter", 0),
            "18": l18.get("split_iter", 0), "19": l19.get("split_iter", 0),
            "20": l20.get("split_iter", 0), "21": l21.get("split_iter", 0),
            "22": l22.get("split_iter", 0), "23": l23.get("split_iter", 0),
                    "24": l24.get("split_iter", 0),
            "25": l25.get("split_iter", 0)},
        "max_abs_err": 0.0, "ms": t["ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": None, "shape": t["shape"],
        "empty_kernel_ms": t["empty_kernel_ms"],
        "other_shapes": {r["shape"]: {x: r[x] for x in (
            "ms", "plain_ms", "bound_ms")} for name, r in
            b3_b6_times.items() if name.startswith("split_iter_")}})
    launches_b6 = {"f32": cv_res["kernels"]["counts"]["hist_segstats_f32"],
                   "bf16": sweep["launches"]["hist_segstats_bf16"]}
    for mode in HIST_MODES:
        t = b3_b6_times[f"hist_segstats_{mode}"]
        kernels.append({
            "name": f"hist_segstats_{mode}", "route": "cuda",
            "source": SEGSTATS_SOURCE[0], "replaces": SEGSTATS_SOURCE[1],
            "launches": launches_b6[mode],
            "launches_by_phase": {
                "8b" if mode == "f32" else "8c": launches_b6[mode],
                "13": rec_launches.get(f"hist_segstats_{mode}", 0),
                "14": l14.get(f"hist_segstats_{mode}", 0),
                "15": l15.get(f"hist_segstats_{mode}", 0),
                "16": l16.get(f"hist_segstats_{mode}", 0),
                "17": l17.get(f"hist_segstats_{mode}", 0),
                "18": l18.get(f"hist_segstats_{mode}", 0),
                "19": l19.get(f"hist_segstats_{mode}", 0),
                "20": l20.get(f"hist_segstats_{mode}", 0),
                "21": l21.get(f"hist_segstats_{mode}", 0),
                "22": l22.get(f"hist_segstats_{mode}", 0),
                "23": l23.get(f"hist_segstats_{mode}", 0),
                    "24": l24.get(f"hist_segstats_{mode}", 0),
                "25": l25.get(f"hist_segstats_{mode}", 0)},
            "max_abs_err": b6_errs[mode],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "shape": t["shape"]})
    # B5 on the main path: bf16 in the north-star cv and the multiclass
    # training, f32 in the multiclass dyadic run at f32
    launches_b5 = {
        "bf16": (ns_cv["kernels"]["counts"]["hist_fused_batched_bf16"]
                 + multiclass["launches"]["hist_fused_batched_bf16"]),
        "f32": multiclass["dyadic_f32_launches"]["hist_fused_batched_f32"]}
    for mode in HIST_MODES:
        t = b5_times[f"hist_fused_batched_{mode}"]
        check(launches_b5[mode] > 0, f"B5 {mode} never launched on the main "
              "path")
        kernels.append({
            "name": f"hist_fused_batched_{mode}", "route": "cuda",
            "source": BATCHED_SOURCE[0], "replaces": BATCHED_SOURCE[1],
            "launches": launches_b5[mode], "max_abs_err": b5_errs[mode],
            "launches_by_phase": {
                "14": l14.get(f"hist_fused_batched_{mode}", 0),
                "15": l15.get(f"hist_fused_batched_{mode}", 0),
                "16": l16.get(f"hist_fused_batched_{mode}", 0),
                "17": l17.get(f"hist_fused_batched_{mode}", 0),
                "18": l18.get(f"hist_fused_batched_{mode}", 0),
                "19": l19.get(f"hist_fused_batched_{mode}", 0),
                "20": l20.get(f"hist_fused_batched_{mode}", 0),
                "21": l21.get(f"hist_fused_batched_{mode}", 0),
                "22": l22.get(f"hist_fused_batched_{mode}", 0),
                "23": l23.get(f"hist_fused_batched_{mode}", 0),
                    "24": l24.get(f"hist_fused_batched_{mode}", 0),
                "25": l25.get(f"hist_fused_batched_{mode}", 0)},
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "shape": t["shape"]})
    t = int8["times"]["root"]
    kernels.append({
        "name": "hist_fused_int8", "route": "cuda", "source": INT8_SOURCE[0],
        "replaces": INT8_SOURCE[1], "launches": int8["launches"][
            "hist_fused_int8"], "max_abs_err": 0.0,
        "launches_by_phase": {
            "12": int8["launches"]["hist_fused_int8"],
            "16": l16.get("hist_fused_int8", 0),
            "17": l17.get("hist_fused_int8", 0),
            "18": l18.get("hist_fused_int8", 0),
            "19": l19.get("hist_fused_int8", 0),
            "20": l20.get("hist_fused_int8", 0),
            "21": l21.get("hist_fused_int8", 0),
            "22": l22.get("hist_fused_int8", 0),
            "23": l23.get("hist_fused_int8", 0),
                    "24": l24.get("hist_fused_int8", 0),
            "25": l25.get("hist_fused_int8", 0)},
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        "shape": t["shape"],
        "other_shapes": {r["shape"]: {x: r[x] for x in (
            "ms", "plain_ms", "bound_ms", "library_ms")} for name, r in
            int8["times"].items() if name != "root"}})
    for k_ in kernels:
        # phases 23 and 24 ran on virtual shards of the one card
        k_["virtual_shards"] = {"phases": ["23", "24"],
                                "shards": MESH_DEVICES, "card": card}
    report = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda, "build_s": build_s,
              "kernel_vs_plain_max_abs_err": errs,
              "main_path_tables_max_abs_err": path_errs,
              "main_path": main_path,
              "times": table, "breakdown": breakdown, "kernels": kernels,
              "hist_max_abs_err_vs_plain": hist_errs, "train": train,
              "hist_times": hist_times, "b6_max_abs_err_vs_plain": b6_errs,
              "strict": strict, "cv": cv_res, "sweep": sweep,
              "fused_round_breakdown": fused_round,
              "b3_b6_times": b3_b6_times, "b5_max_abs_err_vs_plain": b5_errs,
              "north_star_cv": {t: {f: v for f, v in r.items()
                                    if f != "logloss_mean"}
                                if isinstance(r, dict) else r
                                for t, r in ns_cv.items()},
              "b5_times": b5_times, "multiclass": multiclass,
              "int8": int8, "recovery": recovery, "phase14": phase14,
              "phase15": phase15, "phase16": phase16, "phase17": phase17,
              "phase18": phase18, "phase19": phase19, "phase20": phase20,
              "phase21": phase21, "phase22": phase22, "phase23": phase23,
              "phase24": phase24, "phase25": phase25,
              "library_call": {
                  "predict_forest": "none: no single PyTorch call computes "
                                    "forest traversal",
                  "hist_fused": "Tensor.index_add_ over precomputed flat "
                                "(feature, bin) cell indices",
                  "hist_fused_int8": "Tensor.index_add_ of the quantized "
                                     "values (int32) over precomputed flat "
                                     "(segment, feature, bin) cells",
                  "hist_partition": "none: no single PyTorch call routes "
                                    "rows and builds their histograms",
                  "split_iter": "none: no single PyTorch call scans gains "
                                "and updates a node table",
                  "hist_segstats": "Tensor.index_add_ over precomputed flat "
                                   "(feature, bin) cell indices",
                  "hist_fused_batched": "Tensor.index_add_ over precomputed "
                                        "flat (element, segment, feature, "
                                        "bin) cell indices"},
              "total_s": time.perf_counter() - t_start}
    with open(os.path.join(workdir, "chip_smoke_report.json"), "w") as f:
        json.dump(report, f, indent=1)
    log(f"total {report['total_s']:.1f} s; card {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

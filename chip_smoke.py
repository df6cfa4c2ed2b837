#!/usr/bin/env python3
# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Smoke run of the PyTorch port (``torchmetrics_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout, on a machine with a card

Phases, each of which raises (and the script exits non-zero, printing no
result) if it fails:

1. device: a CUDA device must exist; prints ``nvidia-smi``'s name and power limit;
2. build: compiles every hand kernel in ``torchmetrics_tpu_torch/csrc`` with
   ``nvcc`` (one process per source, all started together);
3. kernels: each kernel against its plain PyTorch version on the card,
   bitwise, at the main path's shape and on edge batches, then timed beside
   its plain version, its bound, (where one exists) one PyTorch call
   computing the same function, and one ``torch.sum`` reading its main
   input (what a plain read of those bytes takes on the card); K5 is timed
   here on the audio phase's inputs and checked there (phase 22), K7 on the
   image phase's first two batches and checked there (phase 24), K6 on the
   bbox compute's own arguments and checked there (phase 23), K8 on the text
   phase's first batch and checked there (phase 25);
4. entry: the one-batch suite step of ``torchmetrics_tpu_torch._entry.entry``
   (C=8, T=32, N=256) on the card, as a user calls it (``fn(*args)``): each
   kernel must launch once and the values must agree with the same step on
   the CPU;
5. slice: the flagship suite (``MulticlassAccuracy(micro)``,
   ``MulticlassF1Score(macro)``, ``MulticlassAUROC(macro, thresholds=128)``)
   in a ``MetricCollection`` on ``device="cuda"``, fed 8 batches of
   65536 x 64 float32 logits made on the card from a seed; the launch
   counts of the kernels are zeroed just before and read just after, the
   final states must equal bitwise those of the same stream folded through
   the plain versions, and the values must be finite, in [0, 1] and agree
   with a numpy reference for accuracy and F1;
6. exact: ``MulticlassAUROC`` and ``MulticlassAveragePrecision`` at their
   defaults (``thresholds=None``, macro) over the same stream, one compute
   group; per-class values within 1e-6 of the same stream folded on the CPU
   through the port and within 1e-4 of a float64 numpy/scipy reference, one
   class's padded curve bitwise equal on the card and the CPU; compute's
   device time, launches, the sort's share and the peak memory;
7. multilabel: ``MultilabelAccuracy``, ``MultilabelF1Score(macro)`` and
   ``MultilabelAUROC(macro, thresholds=128)`` over 8 batches of 65536 x 64
   logits with {0, 1} targets, about 1% ignored (-1); K1 must launch once per
   batch, in matrix mode; the final int32 states must equal bitwise the
   stream folded with K1's plain version, and the values a numpy reference
   within 1e-6 / 1e-5 / 1e-5.
8. families: the stat-scores families (``MulticlassPrecision``, ``Recall``,
   ``NegativePredictiveValue``, ``Specificity``, ``HammingDistance``, macro;
   one compute group, K2 once per batch) and the confusion-matrix families
   (``MulticlassConfusionMatrix``, ``JaccardIndex``, ``MatthewsCorrCoef``,
   ``CohenKappa``; one compute group, one C x C ``confmat`` counted with
   plain PyTorch ops) in one collection over the slice's stream: ``confmat``
   bitwise equal to a numpy ``np.bincount`` fold brought to the host and
   tp/fp/tn/fn to the counts derived from it; values within FAMILY_ATOL of
   numpy float64; the same collection through ``suite.fused()`` bitwise
   equal, K2 once per replay in the trace; ``torch.argmax`` and the
   confusion matrix on the hard rows equal to the CPU's; the eager and fused
   steady passes profiled; the confusion-matrix update alone timed beside
   its bound and ``torch.bincount`` on the same indices.
9. points: ``MulticlassAUROC(thresholds=128)`` beside the four fixed-point
   classes (``Multiclass{RecallAtFixedPrecision, PrecisionAtFixedRecall,
   SensitivityAtSpecificity, SpecificityAtSensitivity}``, ``min_*=0.5``,
   ``thresholds=128``) over the slice's stream: one compute group, K1 once
   per batch eager and once per replay fused; the state bitwise equal to the
   fold through K1's plain version; every per-class value and threshold
   bitwise equal to the port's CPU compute of the same state and to a numpy
   float64 selection within POINT_ATOL (thresholds equal); the steady eager
   and fused passes profiled; the exact mode of two of the classes within
   POINT_EXACT_ATOL of the CPU.
10. scores: ``MulticlassCalibrationError`` (15 bins, l1 and l2),
   ``MulticlassHingeLoss`` (both modes) and ``Dice(average="macro")`` over the
   slice's stream; the three multilabel ranking metrics over the multilabel
   stream; ``BinaryFairness`` and ``BinaryGroupStatRates`` over 8 binary
   batches with 8 seeded groups; each collection eager and fused (states
   bitwise equal); the count states bitwise equal to numpy folds, values
   within SCORE_ATOL of numpy float64; the calibration and ranking updates
   timed beside their bound.
11. regression: the regression and aggregation slice at full width (8
   batches of 65536 samples made on the card): the single-output family
   (MSE, MAE, MSLE, MAPE, SMAPE, WMAPE, Minkowski, log-cosh, Tweedie, RSE,
   R², explained variance, Pearson, concordance, CSI), Spearman over all
   524,288 rows, the (65536, 8) multi-output MSE, raw R² and Pearson,
   cosine similarity over (65536, 64) rows and KL divergence over their
   softmaxes, the aggregators over the per-sample squared error (NaNs in one
   batch; ``"ignore"`` and float imputations), the weighted means and
   ``RunningMean(window=4)``; Kendall tau-b with its test over the first
   batch (the int32 census) and a float32 census of two batches within 2^-20
   of its int64 recount. Each collection eager and fused (states bitwise
   equal), counts bitwise equal to numpy folds, values within
   REGRESSION_ATOL/RTOL of numpy/scipy float64, the port's CPU compute of
   each card state within REGRESSION_CPU_RTOL of the card's; the steady eager
   and fused passes profiled, each plain update and compute timed beside its
   bound. No hand kernel runs here.
12. wrappers: the wrappers and metric arithmetic over the slice's stream
   (regression wrappers over (65536, 8) batches made on the card):
   ``ClasswiseWrapper(MulticlassF1Score(average=None))`` (K2 8), ``MinMaxMetric
   (MulticlassAUROC(thresholds=128))`` computed after every batch (K1 8),
   ``BootStrapper(MulticlassF1Score, 10 copies)`` poisson and multinomial
   (K2 80 each, also counted from the profiler; each copy's states bitwise
   equal to a bare metric fed the same seeded indices; mean/std/quantiles
   within 1e-6 relative of numpy float64), ``(F1 + accuracy) / 2`` and
   ``1 - AUROC`` bitwise equal to the bare arithmetic, ``MultitaskWrapper`` and
   ``MetricTracker`` over the suite (states bitwise, ``best_metric`` equal to
   numpy's argmax/argmin), ``MultioutputWrapper(R2Score, 8, remove_nans=True)``
   within 1e-6 of a float64 numpy fold, and a collection of two
   ``MinMaxMetric`` over different bases forming no compute group; each
   wrapper's eager pass timed beside its bare metric's, and a bootstrap
   copy's index upload, gather and update.
13. sketch: the sketch plane at full width over NUM_BATCHES batches made on
   the card (``_sketch_streams``): ``Quantile(q=[0.5, 0.99])`` and
   ``Median()`` at the default geometry (2048, 18), ``SpearmanCorrCoef(
   num_bins=64)``, ``DriftScore(bins=64)`` against a pinned 65536-sample
   reference on a stream whose second half is shifted, ``Cardinality()``
   (precision 12) and ``HeavyHitters()`` (4 x 1024, k = 32) over Zipf-like
   int32 tags on 1e6 keys, a ``MomentsSketch`` over (65536, 64) rows and a
   4096-slot reservoir. The eager pass is the main path: K3 (``cm_track``)
   counted from 0, once per batch. Every state equal to the same stream
   through the port on the CPU (integer leaves bitwise, KLL items as floats:
   a radix sort may order -0 and +0 apart; the moments within 1e-5); the
   quantiles inside ``kll_error_bound`` of numpy's order statistics, HLL
   within 3 x 1.04/sqrt(m) of the true distinct count, Count-Min point
   queries at or above the true counts, the drift scores within 1e-5 of
   numpy float64. ``make_jit_update`` over the Quantile stream, captured
   once and replayed, equal to the eager Quantile; the value and tag members
   through ``suite.fused()`` equal to eager, the fused pass's busy share; K3
   bitwise against its plain loop at 65536 tags from an empty and a filled
   table, on a batch whose every tag is admitted, and on tables with a key
   live in two slots and with a negative count (its unfiltered mode), its
   counters (survivors of its filters, steps run) equal to the host's trace
   of the same filters, each case timed; device ms per
   update of the KLL update, the captured step, HLL, the Count-Min grid, the
   Count-Min update with K3 and the drift histogram; ``set_dtype(float64)``
   on a card Quantile.
14. sliced: the sliced and windowed planes at the JAX benchmark's widths,
   each stream made on the card from a seed over NUM_BATCHES batches:
   ``sliced_fanout`` (``MulticlassAccuracy(8)`` over 1024 cells, 8192 rows a
   batch, keys uniform over 1024 cohorts; ``run_scan``, K4 and K2s),
   ``drift_cohorts`` (``DriftScore(bins=32)`` against 65536 reference values,
   1024 cells, 8192 values a batch; ``run_scan``, K4) and ``sliced_suite``
   (the headline suite, 65536 x 64, T = 128, keys over 200 cohorts into 256
   cells; one captured step per batch, K4, K2s and K1s). The three kernels'
   counts from 0 over those runs (the main path); 32 fan-out and drift
   cohorts and 12 suite cohorts bitwise equal to independent metrics fed
   their rows, the fan-out's states over all cells to one metric over every
   row, the drift scores of ``compute_all`` within 1e-6 of each cohort's own;
   K4, K2s and K1s bitwise against their plain versions at the main path's
   shapes and timed, K1s and K2s also at 1 and 256 cells in both target
   (K2s: scores and labels) modes with every row dropped, none, 90% in one
   cell and 131,072 rows in one cell; K4 also timed from an empty table at
   the suite's and the fan-out's first batches and a spill batch (2,048
   cohorts into 1,024 cells), table and cells bitwise, its new keys and
   rounds equal to the host's count of the same route;
   the captured passes timed (samples/s, the naive loop of
   1024 metric instances over one batch beside it, scored windows/s) and the
   suite's pass profiled (busy share, top device ops); JAX's small test suite
   (accuracy, a histogram sketch, exact AUROC with ``cat_capacity``) on the
   card equal to the CPU's bitwise; a ``WindowRing(slots=4, every_n=2)`` over
   the headline suite, ``query(last=k)`` equal to a recompute over those
   windows' batches, and a tumbling ring equal to ``Running(window=4)``.
15. fused: the slice's suite through ``suite.fused()``, one CUDA graph
   replay per batch: final states bitwise equal to the plain fold and values
   to the unfused ``compute()``; the wrappers' counters moved by the
   warm-up's launch and the capture's recorded one alone; K1 and K2 once per
   replayed batch, counted from the profiler trace (a trace without them
   fails); in a steady pass the host launches the graphs and copies the
   inputs, no kernel; the steady pass beside the unfused one, in turns, and
   the states after every timed pass equal to a whole number of plain folds;
   ``run_scan`` of the 8 batches and ``run_stream`` from pinned host numpy
   batches, the states after each timed pass held the same way; a
   ``validate_args=True`` suite captured; the exact group fused with
   CatBuffers of 8 x 65536 rows, its values equal bitwise to phase 6's.
16. durable: the headline suite through ``StreamingEvaluator`` +
   ``CheckpointStore(keep_last=2)`` (``snapshot_every_n=2``,
   ``watchdog_timeout_s=60``: every update on the watchdog's worker thread,
   the fused plan built and captured there), unfused and ``fused=True``:
   uninterrupted, then killed by ``runner.preempt`` after batch 5 and resumed
   in a freshly built suite; final int32 states bitwise equal to the plain
   fold and values to the slice phase's (and numpy's within its budget); K1
   and K2 5 + 4 launches unfused, and fused each plan's warm-up and captured
   launch (2 + 2) beside 2 warm-ups + 9 replays in a profiler trace; a torn
   save (no warning, falls back to step 2) and bitrot (one
   ``CheckpointStoreWarning`` naming step 4), both resumed bitwise equal; the
   card's final snapshot restored into a ``device="cpu"`` suite (states
   bitwise, values within 1e-6); the fused drive's steady pass with
   ``snapshot_every_n`` None, 8 and 1 in turns and the busy share at 1; the
   parts of one snapshot (fold-back, device-to-host copy, pickle, CRC32,
   atomic write with fsync) for the suite and for the exact group over
   524,288 rows (272.6 MB), with ``latest()`` + restore and its peak device
   memory. The sketch regime: a Quantile killed after batch 5 and resumed
   bitwise equal to the uninterrupted run; card checkpoints of a Quantile and
   of a reservoir restored into ``device="cpu"`` metrics (the reservoir's next
   draw equal). The windowed regime (the suite with a ``WindowRing``) and
   the sliced regime (the fan-out ``SlicedPlan`` target) killed after batch
   5 and resumed, bitwise equal to their uninterrupted runs. Works in a
   temporary directory it removes.
17. dist: two ranks spawned with ``torch.multiprocessing`` (``_dist_rank``),
   one gloo group on ``cuda:0``: the collectives the port asks of gloo on
   CUDA tensors; replica sync of the suite (rank 0 folds batches 0-3, rank
   1 batches 4-7; K1 and K2 once per local batch; the synced int32 states
   equal bitwise to the single-process fold and the values to phase 5's);
   the exact group's uneven cat gather (5 batches against 3; the per-class
   values equal bitwise to phase 6's; unsync restores the local rows);
   ``ShardedMetric`` and ``suite.fused(mesh=...)`` with half the rows of
   every batch on each rank (states bitwise equal to the single-process
   fold; K1 and K2 once per batch in a profiler trace of the plan);
   ``sharded_update`` of ``MinMaxMetric(MulticlassAUROC)`` and of
   ``Running(MeanSquaredError(), window=3)`` over 4 events equal to the
   replica regime (int32 bitwise, float within 1e-6), ``BootStrapper``
   refused with the JAX package's reason; a corrupt payload from rank 1
   failing the object gather on both ranks, then healing; the durable
   kill-and-resume of both regimes (replica: a store per rank,
   ``write_rank=None``; sharded fused over the mesh: rank 0 alone writes, no
   second sync), each resume timed; a Quantile, a DriftScore and a
   HeavyHitters merge-synced (each rank folds half of the sketch batches)
   equal to the one-rank merge of both halves; the sliced mesh plan (half of
   every fan-out batch on each rank) bitwise equal to the local plan. A rank that fails or outlives DIST_TIMEOUT_S fails the
   script. The times it prints are gloo's through the host on one card.
18. guard (runs after sliced): the StateGuard over the flagship suite
   (micro accuracy, macro F1, binned macro AUROC guarded with the multiclass
   ``contract=``) on copies of the slice's batches with invalid rows
   injected on the card from a seed (batches 1, 3 and 7: about 1% rows with
   a NaN score, 0.2% with a +Inf, 0.5% labelled 64 or -1; batch 5 wholly
   invalid). The mask policy's eager pass is the main path: K2s and K1s
   counted from 0. Under mask, reject and propagate, through eager,
   ``suite.fused()``, ``make_jit_update`` (a step per member) and the
   suite's ``SlicedPlan`` (200 cohorts into 256 cells): integer states
   bitwise equal to the unguarded suite over the host-filtered rows (mask),
   over the clean batches (reject) and over the raw rows (propagate); the
   counters equal numpy's row counts; the sliced cells sum to the per-row
   fold and its counters. ``MeanSquaredError``'s ``guard_poisoned`` under
   propagate latches at the first NaN batch, not before, and a
   ``StreamingEvaluator`` gated on it writes no cadence snapshot after it.
   K2s and K1s at the guard's one-cell shape bitwise against their plain
   versions and timed; ``DomainContract.row_invalid`` (plain PyTorch) timed
   against its byte bound; each policy's eager and fused pass against the
   unguarded pass, in turns, and the fused passes' device kernels.
19. obs (runs after guard): the eager, fused and sliced passes of the
   headline suite with tracing off and on, in turns (ms, samples/s, spans
   per pass); a JSON-lines trace written and read back with the port's
   ``obs.read_jsonl``/``summarize``; device telemetry on the captured
   ``make_jit_update`` step over the guard's stream, the drained NaN and Inf
   gauges equal to numpy's counts and the step timed with telemetry off and
   on; the capture record (``obs.xla_records``) of a fused plan built under
   tracing; the live publisher (50 Hz status files, ``/metrics`` on
   localhost) over a durable run, its OpenMetrics text parsed and the
   runner's progress and throughput gauges in it.
20. serve (runs after durable): the serve plane (``torchmetrics_tpu_torch.serve``)
   on the card. (1) The flagship suite served by an in-process ``Stream``
   (``fused=True``, ``use_feed=True``, ``snapshot_every_n=4``; its factory
   is this script's ``serve_suite``) and offered the slice's 8 batches as
   numpy arrays: states bitwise equal to the plain fold, values to the slice
   phase's, K1 and K2 at least 8 launches each in a profiler trace (the
   replays) and on the wrappers (warm-up and capture); samples/s of the
   served run beside the fused plan's steady pass. (2) ``python -m
   torchmetrics_tpu_torch.serve serve --device cuda`` in a subprocess: the
   suite created over HTTP, 8 JSON batches of 4,096 x 64 replayed over the
   unix socket, the daemon SIGKILLed after batch 5's ack, restarted over the
   same base directory and replayed from its ``next_seq``; the drained
   states (the ``/v1/state`` export) bitwise equal to an uninterrupted
   in-process stream's, ``/healthz`` 200, SIGTERM drains; JSON decode ms a
   batch, socket-ingest samples/s, restart-to-ready s. (3) Two in-process
   leaf ``ServeDaemon`` instances with 4 of those batches each and a
   ``FleetAggregator`` on the card pulling them over localhost: the fold's
   integer states bitwise equal to one fold of all 8, values within
   SERVE_FLEET_ATOL; the export's ms and bytes, the fold's ms. (4) A
   ``heavy_hitters`` stream over the sketch phase's 8 x 65,536 Zipf-like
   tags (K3 8 launches) and a ``sliced_accuracy(64 classes, 256 cells)``
   stream over the slice's batches keyed over 200 cohorts (K4 and K2s at
   least 8 each in a profiler trace): drained states bitwise equal to the
   same metrics run directly. (5) ``guarded_binary_accuracy(policy="mask")``
   over binary rows made from the guard phase's poisoned batches: the
   counters equal numpy's, the states the unguarded metric's over the valid
   rows. Works in a temporary directory it removes.

21. domains (runs after dist): segmentation, pairwise, nominal and
   retrieval (ROADMAP A14) at full width, inputs made on the card from a
   seed. ``MeanIoU`` and ``GeneralizedDiceScore`` (19 classes, Cityscapes'
   evaluation classes; ``input_format="index"``, ``per_class=True``, with
   and without the background) over 8 batches of 8 x 512 x 1024 label maps:
   values within DOMAIN_SEG_ATOL of float64 numpy from per-sample
   ``np.bincount`` confusion counts, the first batch's per-sample, per-class
   intersection and union bitwise equal to the port's on the CPU, one
   ``mean_iou`` over one-hot inputs (two 319 MB int32 tensors) bitwise equal
   to the index format's. The five pairwise functions at BERT-base width
   (cosine, euclidean, linear over 4,096 x 768; manhattan and minkowski,
   exponent 3, over 1,024 x 768, their broadcast 3.2 GB), with and without
   ``y``, reductions None and ``"mean"``, against float64 numpy within the
   stated budgets (the broadcast ones on their first 256 rows). The four
   contingency metrics (64 classes) over the slice's batches argmaxed,
   ``nan_strategy="replace"``, and over float labels with about 1% NaN rows,
   ``"drop"``: ``confmat`` bitwise equal to a numpy ``np.bincount`` fold and
   values within DOMAIN_NOMINAL_ATOL of float64; ``fleiss_kappa`` over
   65,536 subjects x 5 categories x 10 raters and ``cramers_v_matrix`` over
   a 65,536 x 8 table the same way. The eleven retrieval classes over MS
   MARCO passage dev re-ranking's shape (6,980 queries x 1,000 candidates,
   about one relevant passage a query, scores rounded to 1e-3 with zeros of
   both signs) in 8 batches: each value equal to the same state's compute on
   the CPU within DOMAIN_RETRIEVAL_CPU_ATOL and to a float64 numpy reference
   (a stable argsort per query) within DOMAIN_RETRIEVAL_ATOL;
   ``RetrievalAUROC(max_fpr=0.1)``, whose compute is a host loop over the
   queries, over the first 256 queries. Each family's update and compute
   timed against its bound, ``_pack_queries``' share of a retrieval
   compute, the peak memory.
22. audio (after domains): clustering and audio (ROADMAP A14) at full
   width, inputs made on the card from a seed. Clustering at ImageNet-1k
   validation's size as deep-clustering evaluations report it: the nine
   label-pair classes over 50,000 samples in 1,000 clusters (a clustering
   partly aligned with the classes through a permutation) and the three
   intrinsic classes over 50,000 x 2,048 float32 features (ResNet-50's
   pooled width) with 1,000 labels, each updated in 8 batches and computed;
   the int32 contingency table bitwise equal to numpy's ``np.bincount``,
   the label-pair values within CLUSTER_ATOL and the intrinsic ones within
   CLUSTER_RTOL of float64 numpy/scipy references (the expected MI by
   ``scipy.stats.hypergeom``); each compute's wall time, the AMI's host EMI
   time and the peak memory of the intrinsic computes (Davies-Bouldin's and
   Dunn's (1000, 1000, 2048) centroid difference). Separation at
   WSJ0-2mix's shape as Conv-TasNet evaluates it (8 kHz, 2 speakers, 4 s,
   batch 16, speakers swapped in every other mixture): SNR, SI-SNR, SI-SDR,
   SA-SDR, C-SI-SNR (on a ``torch.stft`` of the same signals), SDR (filter
   length 512) and PIT speaker-wise with SI-SDR and with SDR, functional and
   module, against float64 numpy (SDR by ``scipy.linalg.solve_toeplitz``),
   PIT's permutations equal to numpy's exhaustive search; each call timed
   against its bound. Speech quality on DNS Challenge-shaped clips (10 s at
   16 kHz, batch 8, 23 cochlear filters, made on the card): SRMR with
   ``norm`` False and True is the main path (K5 counted from 0, two
   launches a call), both within SRMR_REF_RTOL of a float64
   ``scipy.signal.lfilter`` pipeline at full length (float32's own error
   there is percent-level) and bitwise equal with cuDNN's TF32 flag on and
   off, and within SRMR_CPU_RTOL of the port on the CPU at T = 16,000
   over SRMR_CPU_SEEDS seeded batches, with its witness (the card on the
   CPU's envelope within SRMR_WITNESS_RTOL); STOI and ESTOI bitwise equal
   to the same numpy run on the host; PESQ and DNSMOS raising their
   ``ModuleNotFoundError``. K5 on the main path's own inputs at T = 160,000
   (the clips into the gammatone cascade, their envelope into the
   modulation bank), timed in phase 3 (device ms, stream ms, byte bound,
   chain floor: T dependent steps of 16 cycles at the card's top SM
   clock), and here held bitwise against its plain loop at that full length, the loop's
   steps replayed from CUDA graphs of 2,000 steps, and over the first
   2,000 samples against the eager loop (the CPU route's launches).
23. detection (after audio): ROADMAP A14's detection at COCO val2017's shape (5,000
   images, 80 classes, 36,781 ground truths, 0-63 an image, about 1%
   crowds, COCO's small/medium/large mix; 100 detections an image, jittered
   from the ground truths and false positives; made on the card from a
   seed). ``MeanAveragePrecision(class_metrics=True, extended_summary=True)``
   fed in batches of 16 images, then ``compute`` is the main path (K6
   counted from 0: one launch); the compute again with its stages timed
   (host packing, IoU, K6, the ignore masks, accumulation, summary), the
   tables equal; K6 on the compute's own inputs bitwise against its plain
   loop, the same inputs as phase 3 timed it on (device ms from the
   profiler, or CUDA events where it sees no device time; stream ms; the
   bound of the walk over candidates, its least bytes and operations,
   beside the dense bound; the chain floor, the longest image's walk at
   the cycles a step of chip_k6_variants.py's register-only chain probe;
   K6 on the densest image alone; registers), and on adversarial batches (ties, NaNs, crowds, all-ignored
   and empty images, D and G not multiples of 32, thresholds 1.0, +-0, -1,
   -2 and NaN, G around a word and the 128 ground truths held in
   registers, a matched set past them, a block's masks past shared memory,
   candidate IoUs of -1, -2 and +-0, rows covered by candidates; each of
   the five instantiations reached); the
   card's result against the port's CPU route on the same inputs, the
   first 1,000 images (tables and classes bitwise, summaries within
   DET_SUMMARY_ATOL; the whole stream's CPU compute took 34 s); the four
   IoU classes over the same 1,000 images, updates timed,
   ``IntersectionOverUnion`` within 1e-5 of a float64 numpy mean. segm, cut to 200 images x 20
   detections of 480 x 640 ellipse masks (the host codec's time): the
   codec's runs bitwise against the numpy plain route on 10 images, the
   card against the CPU on the same RLEs. Panoptic quality, cut to 64 images
   at 480 x 640 with COCO panoptic's 80 thing and 53 stuff categories (host
   numpy's time): the update timed, the states and values of both classes
   on the card bitwise equal to the CPU's over the first 2 images.
24. image (after detection): ROADMAP A14's image domain, made on the card
   from a seed. The main path: the full-reference classes (SSIM with the
   11 x 11 Gaussian and with a 7 x 7 uniform window, MS-SSIM at 5 scales,
   UQI, VIF, SCC, PSNR, PSNRB on the first channel, ERGAS, SAM, RMSE-SW,
   RASE, TV) over 4 batches of 8 x 3 x 1,356 x 2,040 float32 (DIV2K's 2K
   scale, cut from DIV2K validation's 100 images), K7 counted from 0 on each
   path (4, 4, 20, 1, 16 and 4 launches) and nowhere else; each update and
   compute timed; the first 2 images of the first batch held against a
   float64 route of the plain version (float64 convolutions) within
   IMG_F64_ATOL / IMG_F64_RTOL, RMSE-SW and RASE against the CPU on a
   crop, ``image_gradients`` against its differences; SSIM's gradient
   through K7's autograd route against autograd through the plain loop.
   Every distinct K7 launch of the first batch (SSIM's 11 x 11 and 7 x 7,
   MS-SSIM's five scales, UQI's compute over the 32 images, VIF's four
   scales, SCC's 8 x 8 on the zero-padded high pass; 13 at that full shape)
   and of D_lambda and D_s kept as it ran and held bitwise against the plain
   route on its own arguments; K7 also bitwise on edge batches (constant
   images, a window as large as the image, a row pitch of 33 floats). K7
   (its window passed as two factors) timed beside its plain route, cuDNN's
   depthwise conv over the stacked input under the factors' outer product
   (TF32 off; a yardstick the port never calls), the byte bound and the
   separable window's operation bound, the read floor. Pan
   sharpening at WorldView-3's 8 bands, 4:1 (preds and pan 4 x 8 x 1,024 x
   1,024, ms 4 x 8 x 256 x 256): D_lambda, D_s with and without ``pan_lr``,
   QNR (K7 2, 2, 2, 4 launches), the card against the CPU on a crop. FID over
   10,000 real and 10,000 fake uint8 images at 299² in batches of 200 on the
   full Inception-v3 (seeded weights), the tower held against the CPU's on
   the first 8 images within TOWER_RTOL, the host eigvals of FID's compute
   timed apart; KID (100 subsets of 1,000), IS (10 splits) and MiFID each on
   its own tower over 2,000 real and 2,000 fake (a cut). LPIPS with each
   trunk on 1,024 pairs at 256 x 256 in batches of 64, the card against the
   CPU on the first 8 pairs. PPL over 1,000 samples of a small seeded
   generator, LPIPS vgg.
25. text (after image): ROADMAP A14's text domain, inputs made from a
   seed. The main path: ``Perplexity(ignore_index=-100)`` over 8 updates of
   GPT-2-shaped float32 logits (8 x 1,024 x 50,257, made on the card, about
   5% of the targets ignored), K8 (``token_nll``) counted from 0 (one launch
   an update); the first batch's rows held against the plain route within
   K8_F32_BUDGET and its total, a slice of it card against CPU; 2 more
   updates on a bfloat16 stream. K8 against its plain route on edge batches
   (every target ignored, targets -1 and -V, targets >= V and < -V, rows of
   +-inf and NaN logits, V = 1, V = 32,000 in three types, a row pitch of
   1,003), its gradient against autograd through the plain route, its
   capture in a CUDA graph; timed in phase 3 beside its byte bound, the plain
   route, ``F.cross_entropy(reduction="none")`` (a yardstick the port never
   calls) and the read floor, in float32 and bfloat16, with the peak memory
   of an update through each. The error-rate family (WER, CER, MER, WIL,
   WIP, ``EditDistance``) over LibriSpeech test-clean's shape (2,620
   utterances, about 52,600 words from 8,000, 3% substitutions, 1%
   insertions, 1% deletions) in batches of 64, card against the CPU route
   bitwise, the first 200 pairs against a Python DP. BLEU, SacreBLEU (13a,
   intl), chrF++, TER, EED and ROUGE (1, 2, L, Lsum) over WMT14 en-de
   newstest2014's shape (the first 1,024 of its 3,003 segments, one reference each: the
   metrics' host Python is most of the phase) in batches of
   64, each update and compute timed, the CPU route fed the first 8 batches
   and bitwise equal to the card's states there. SQuAD over SQuAD v1.1
   dev's shape (10,570 questions, 1-3 answers), card against CPU bitwise.
   BERTScore at bert-base-uncased's widths (seeded weights, a word-hash
   tokenizer) over the 3,003 MT pairs at ``max_length=128``, idf off and on,
   ``all_layers=True`` on the first 64 pairs, card against CPU on the first
   16 within BERT_CPU_ATOL; InfoLM on the same widths as a masked LM, cut
   to 256 pairs (one forward a token of every sentence) for the KL
   divergence and 64 for the AB divergence, card against CPU on the first
   4; the default-model paths
   raising (nothing is downloaded).
26. chaos (runs last): ``torchmetrics_tpu_torch/serve/chaos.py --mode short``
   and ``--mode poison`` (seed 11) with ``--device cuda``: every daemon the
   harness starts must print a ready line naming the card, and the reports
   must carry the invariants JAX's tests assert (short: legs main and
   circuit, quarantined [6], degraded observed, at least 2 restarts; poison:
   quarantined [2, 4], 2 rollbacks, 4 masked rows, 2 rejected batches, the
   health walk ok, degraded, ok). A failed leg fails the script. Each leg's
   seconds and each daemon's time to its ready line are printed.
27. multimodal (runs after text, before chaos): ROADMAP A14's last domain on seeded towers built from
   the published configurations (transformers' ``CLIPModel``, nothing downloaded), through the harness's
   own processor (``_ClipProcessor``: torch and numpy, CLIP's published preprocessing, a seeded word-hash
   tokenizer with CLIP's ids; no PIL). ``CLIPScore`` at openai/clip-vit-large-patch14's widths (vision 24
   layers, hidden 1,024, 16 heads, MLP 4,096, patch 14 at 224; text 12 layers, hidden 768, 12 heads, MLP
   3,072, vocabulary 49,408, 77 positions; projection 768) over MS-COCO val2017's shape: 3 x 480 x 640
   uint8 images made on the card, one caption of 8-20 words each, cut to 1,024 of the 5,000 images in 16
   updates of 64, three captions of 90 words (the truncation warning fires three times); the value in
   [0, 100], the functional against the module over the first 128 pairs and two half-batches against one
   batch within MM_BATCHING_ATOL, the card against the CPU on the first 4 pairs within
   CLIP_SCORE_CPU_ATOL. ``CLIPImageQualityAssessment`` at openai/clip-vit-base-patch16's widths (vision 12
   layers, hidden 768, 12 heads, MLP 3,072, patch 16; text 12 layers, hidden 512, 8 heads, MLP 2,048;
   projection 512) over KonIQ-10k's shape (3 x 768 x 1,024 in [0, 1], made on the card), cut to 512 images
   in 8 updates of 64, the 16 prompt keywords and one custom pair (34 anchor texts): the dict and
   ``format_as_dict=False`` equal, every probability in [0, 1], the card against the CPU on the first 4
   images within CLIP_IQA_CPU_ATOL. The towers run in float32 (cuDNN's TF32 off, matmuls at
   ``"highest"``) and leave both flags as they were; each tower's features hold ``projection_dim`` in
   the form the card's transformers returns (printed). Printed: each tower's images (captions, prompts)
   per second, an update's host preprocessing against the rest, the peak memory of an update, each
   check's largest error, the phase's seconds; the default-model paths raise (nothing is downloaded).
28. lint (after multimodal, before chaos): the port's static checks (``torchmetrics_tpu_torch/lint``,
   loaded by file path: the standard library alone) lint the port and this script in at most
   LINT_BUDGET_S with no finding above ``lint/baseline.json``, and every rule fires on the fixture
   corpus (``tests/torch_lint_corpus``). Then the static verdicts are held against CUDA-graph capture:
   each capture fixture of the corpus and a list of the port's classes are built with
   ``make_jit_update`` on the card and their step called three times (the first call runs eagerly, the
   second captures, the third replays). A fixture the linter flags (``.item()``, ``bool(t)``,
   boolean-mask indexing, ``torch.bincount``, ``torch.nonzero``, an upload, a host read one call away)
   must fail with the port's capture error; its clean twin (the read under ``_is_concrete``, the port's
   ``_bincount``, ``torch.where``, a Python scalar) must capture, replay and equal its eager fold bit
   for bit. The classes the linter's repairs made capturable (the exact matches, MeanIoU, VIF,
   MS-SSIM, LPIPS) and two clean updates (Dice, Perplexity) must capture and fold bitwise; the
   host paths the port suppresses with a reason (SRMR, PanopticQuality, RetrievalMAP with an
   ``ignore_index``) must fail. Printed: a verdict line per case, the lint run's seconds, the phase's.
29. cache (after fused, before durable): the compiled-step cache. The headline suite through
   ``suite.fused()`` (8 batches, fold back), then the plan rebuilt over the same suite; a
   ``SlicedPlan`` of the suite over 256 cells, rebuilt the same way; two ``StreamingEvaluator``
   drives (``fused=True``) over one suite. Traced: the first update of each first plan makes a
   capture record (``obs/xla.py``) and the rebuilt plan's none (``fused.cache.hit``,
   ``sliced.cache.hit``), and the second drive makes none. Each first update is timed by CUDA
   events and the wall clock; the rebuilt plans' states and the second drive's are held bitwise
   against plans built with the cache cleared. The dist phase prints ``sharded_update``'s cache
   counters on each rank (a miss per member, then hits).

Phase 3 also holds K1's matrix mode (the multilabel path's launch) bitwise
against its plain version at 65536 x 64, T=128, with -1 entries, and times it.

The last lines of standard output are a ``[kernels]`` line per kernel (and
one for K1's matrix mode), a ``[summary]`` line with the slice's throughput,
busy share, device time by kernel and, per pass, the launches of the argmax,
prefix-sum and int32-sum kernels that K1 and K2 took over, the exact and
multilabel phases' device times, the families phase's passes and confusion-matrix update, the points
and scores phases' passes and update times, the regression phase's seconds, passes and update times, the wrappers phase's seconds and launches, the sketch phase's seconds, K3 and busy share, the fused phase's passes, the cache phase's first updates, the durable phase's passes and snapshot sizes, the serve phase's numbers, the dist phase's time and the domains, audio, detection, image, text, multimodal (with its towers' images/s) and chaos phases' seconds, ``nvidia-smi``'s
line, the ``kernels`` JSON object (K1, K1's matrix mode, K2, K3, K1s, K2s, K4, K2s and K1s at the
StateGuard's one-cell shape, K5 on the gammatone and the modulation bank, K6, K7 and K8) and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import cProfile
import gc
import io
import json
import math
import os
import pstats
import statistics
import subprocess
import sys
import time

SEED = 0
NUM_CLASSES = 64  # bench.py NUM_CLASSES
BATCH = 1 << 16  # bench.py BATCH
THRESHOLDS = 128  # bench.py THRESHOLDS
NUM_BATCHES = 8
TIMING_REPS = 200
PROFILE_REPS = 50
PROFILE_TRACES = 6  # profiler traces taken before a measurement that sees no device time fails
STEADY_PASSES = 9

# NVIDIA H100 SXM data sheet: device memory rate, and the float32 rate outside the tensor cores, which the
# kernels' compares and integer adds are counted against
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_OPS_PER_S = 67e12


#: the hand kernels of the classification paths (phases 4-12 and 15-17);
#: the sketch phase's main path runs K3 alone
CLASSIFICATION_KERNELS = ("binned_curve_state", "stat_counts")


def _classification_kernels():
    from torchmetrics_tpu_torch.ops import KERNELS

    return {name: KERNELS[name] for name in CLASSIFICATION_KERNELS}


class SmokeFailure(RuntimeError):
    """A phase of the smoke run found the port wrong."""


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


# --------------------------------------------------------------------- device


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false: this smoke run needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True,
        text=True,
        timeout=60,
        check=True,
    ).stdout.strip()
    name = torch.cuda.get_device_name(0)
    print(f"[device] {name}; torch {torch.__version__}, CUDA {torch.version.cuda}; nvidia-smi: {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda:0"), smi


# ---------------------------------------------------------------------- build


#: nvcc's output for each kernel source, from phase_build (ptxas's registers and spills)
BUILD_LOGS = {}


def phase_build():
    from torchmetrics_tpu_torch.ops import _build

    names = _build.kernel_sources()
    t0 = time.perf_counter()
    logs = _build.build(names)
    BUILD_LOGS.update(logs)
    seconds = time.perf_counter() - t0
    for name in names:
        _build.load(name)
    print(f"[build] {len(names)} kernels {names} built in {seconds:.2f} s")
    for name, log in logs.items():
        regs = [int(w) for line in log.splitlines() if "registers" in line for w in line.split("Used")[1].split()[:1]]
        spills = sum(1 for line in log.splitlines() if "spill" in line and not line.strip().startswith("0 bytes stack frame, 0 bytes spill"))
        print(f"[build] {name}: {len(regs)} instantiations, {min(regs, default=0)}-{max(regs, default=0)} registers, {spills} with spills")
    return seconds


# -------------------------------------------------------------------- kernels


def _stream_ms(fn, arg_sets, reps=TIMING_REPS):
    """Mean time of one ``fn`` call on the stream, by CUDA events around
    ``reps`` calls that cycle through ``arg_sets`` (distinct buffers larger
    together than the 50 MB L2, so each call reads its input from device
    memory). Where the host takes longer to issue a call than the device to
    run it, this is the host's time."""
    import torch

    for args in arg_sets[:3]:
        fn(*args)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _device_time_us(event):
    """A profiler event's device time in microseconds (the attribute's name moved across PyTorch versions)."""
    for attr in ("self_device_time_total", "self_cuda_time_total", "device_time_total", "cuda_time_total"):
        value = getattr(event, attr, None)
        if value:
            return float(value)
    return 0.0


def _profile(fn, reps):
    """``{kernel name: (device us, launches)}`` of what ``reps`` calls of ``fn``
    run on the device, their sum, and the window's wall time, from ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    found = {}
    for evt in prof.key_averages():
        if getattr(evt, "device_type", None) == torch.autograd.DeviceType.CUDA:
            found[evt.key] = (_device_time_us(evt), evt.count)
    return found, sum(t for t, _ in found.values()), wall_us


def _device_ms(fn, arg_sets, reps=PROFILE_REPS):
    """Device time of one ``fn`` call: everything it runs on the device (kernels,
    memsets, copies), summed by the profiler over ``reps`` calls."""
    state = {"i": 0}

    def one_call():
        fn(*arg_sets[state["i"] % len(arg_sets)])
        state["i"] += 1

    for _ in range(PROFILE_TRACES):  # torch.profiler on an H100 was seen to return traces without device events, three in a row
        found, busy_us, _ = _profile(one_call, reps)
        if busy_us > 0:
            break
        time.sleep(0.1)
    else:
        raise SmokeFailure(f"torch.profiler saw no device time for {getattr(fn, '__name__', fn)} in {PROFILE_TRACES} traces: {found}")
    # each kernel's mean time per launch times its launches per call: the same as
    # busy_us / reps for a whole trace, and still right for one that lost events
    # (torch.profiler on an H100 was seen to drop some launches of a kernel from a trace)
    per_call_us = sum(t / n * max(1, round(n / reps)) for t, n in found.values() if n)
    return per_call_us / 1e3, found


def _measure(versions, profile_reps=PROFILE_REPS, timing_reps=TIMING_REPS):
    """``versions``: ``(label, fn, arg_sets)``. Each one's device time (profiler)
    and stream time (events), taken in turns, forward then backward; the
    smaller of each one's two readings."""
    out = {label: {"device_ms": [], "stream_ms": []} for label, _, _ in versions}
    for seq in (versions, versions[::-1]):
        for label, fn, arg_sets in seq:
            device_ms, found = _device_ms(fn, arg_sets, profile_reps)
            out[label]["device_ms"].append(device_ms)
            out[label]["stream_ms"].append(_stream_ms(fn, arg_sets, timing_reps))
            out[label]["found"] = found
    for label, rec in out.items():
        rec["device_ms"], rec["stream_ms"] = min(rec["device_ms"]), min(rec["stream_ms"])
    return out


def _kernel_only_us(found, name):
    """Device time per launch of the hand kernel itself (no memset, no casts)."""
    mine = [(t, n) for key, (t, n) in found.items() if f"{name}_kernel" in key]
    launches = sum(n for _, n in mine)
    return sum(t for t, _ in mine) / launches if launches else None


def _read_floor(x):
    """One PyTorch reduction over the kernel's main input: what a plain read of
    those bytes takes on this card, beside the bound (a yardstick, not the function)."""
    import torch

    return torch.sum(x)


def _bound(n_bytes, n_ops):
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, n_ops / PEAK_FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _main_path_batches(device):
    """The slice's input stream: NUM_BATCHES (logits, labels) pairs made on the card from SEED."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    batches = []
    for _ in range(NUM_BATCHES):
        logits = torch.randn((BATCH, NUM_CLASSES), generator=gen, device=device, dtype=torch.float32)
        labels = torch.randint(0, NUM_CLASSES, (BATCH,), generator=gen, device=device, dtype=torch.int32)
        batches.append((logits, labels))
    return batches


def _assert_bitwise(got, want, what):
    import torch

    _require(got.dtype == want.dtype == torch.int32, f"{what}: dtypes {got.dtype} / {want.dtype}, expected int32")
    _require(got.shape == want.shape, f"{what}: shapes {tuple(got.shape)} / {tuple(want.shape)}")
    diff = (got.to(torch.int64) - want.to(torch.int64)).abs()
    err = int(diff.max()) if diff.numel() else 0
    _require(err == 0, f"{what}: kernel and plain version differ (max abs difference {err})")
    return float(err)


def _assert_state_counts(state, valid, what):
    """At every threshold each valid entry is either below it or at/above it."""
    import torch

    per_threshold = state.to(torch.int64).sum((1, 2, 3))
    _require(bool((per_threshold == valid).all()), f"{what}: a threshold counted {per_threshold.tolist()[:3]}..., not {valid}")


def check_binned_curve_state(device, batches):
    """K1 against ``binned_curve_state_plain``: main-path shape, edge batches, other grids; then timed."""
    import torch

    from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import _uniform_grid
    from torchmetrics_tpu_torch.ops import binned_curve_state, binned_curve_state_plain
    from torchmetrics_tpu_torch.utilities.compute import _linspace_like_jax

    thr = _linspace_like_jax(0.0, 1.0, THRESHOLDS, device=device)
    affine = _uniform_grid(THRESHOLDS)
    _require(affine is not None, "the int grid does not take the affine bin index")
    probs = [torch.softmax(logits, dim=1).contiguous() for logits, _ in batches]
    arg_sets = [(p, thr, labels, True, affine) for p, (_, labels) in zip(probs, batches)]
    plain_sets = [a[:4] for a in arg_sets]

    # the main path's shape: (65536, 64) probabilities, labels mode, T=128, both bin indices
    want = binned_curve_state_plain(*plain_sets[0])
    max_err = _assert_bitwise(binned_curve_state(*arg_sets[0]), want, "binned_curve_state, main-path shape")
    _assert_bitwise(binned_curve_state(*plain_sets[0]), want, "binned_curve_state, main-path shape, binary search")

    # edge batch: every grid point, <0, >1, NaN, +-inf, an all-NaN row, ignored and out-of-range labels
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 1)
    n, k = 4099, NUM_CLASSES
    edge = torch.rand((n, k), generator=gen, device=device)
    flat = edge.view(-1)
    flat[:THRESHOLDS] = thr
    specials = torch.tensor([-0.5, -1e-30, 1.5, 1.0 + 1e-6, float("nan"), float("inf"), float("-inf"), 0.0, -0.0, 1.0], device=device)
    flat[THRESHOLDS : THRESHOLDS + specials.numel()] = specials
    flat[-specials.numel() :] = specials
    edge[7] = float("nan")
    labels = torch.randint(-1, k + 3, (n,), generator=gen, device=device, dtype=torch.int32)
    binary = torch.randint(-1, 3, (n, k), generator=gen, device=device, dtype=torch.int64)
    irregular = torch.sort(torch.rand(97, generator=gen, device=device)).values
    irregular[10:13] = irregular[10]  # repeated thresholds
    grid6000 = _linspace_like_jax(0.0, 1.0, 6000, device=device)
    grid13000 = _linspace_like_jax(0.0, 1.0, 13000, device=device)
    cases = [
        ("edge batch, labels mode, T=128", edge, thr, labels, True, affine),
        ("edge batch, int64 labels, T=128", edge, thr, labels.to(torch.int64), True, affine),
        ("edge batch, binary mode, T=128", edge, thr, binary, False, affine),
        ("edge batch, non-uniform grid T=97 (binary search)", edge, irregular, labels, True, _uniform_grid(irregular)),
        ("edge batch, K=7 (scalar loads)", edge[:, :7].contiguous(), thr, binary[:, :7].contiguous(), False, affine),
        ("edge batch, T=6000 (histogram in global memory)", edge, grid6000, labels, True, _uniform_grid(6000)),
        ("edge batch, K=4, T=13000 (thresholds in global memory)", edge[:, :4].contiguous(), grid13000,
         binary[:, :4].contiguous(), False, _uniform_grid(13000)),
    ]
    for what, p, t_grid, target, mode, aff in cases:
        got = binned_curve_state(p, t_grid, target, mode, aff)
        _assert_bitwise(got, binned_curve_state_plain(p, t_grid, target, mode), f"binned_curve_state, {what}")
        valid = int((target >= 0).sum()) * (p.shape[1] if mode else 1)
        _assert_state_counts(got, valid, f"binned_curve_state, {what}")
    before = binned_curve_state.launches
    empty = binned_curve_state(edge[:0], thr, labels[:0], True, affine)
    _require(binned_curve_state.launches == before, "binned_curve_state: an empty batch counted a launch")
    _require(int(empty.abs().sum()) == 0 and empty.shape == (THRESHOLDS, k, 2, 2), "binned_curve_state: empty batch not zero")
    torch.cuda.synchronize()
    print(
        f"[kernels] binned_curve_state: bitwise equal to its plain version at {BATCH}x{NUM_CLASSES} T={THRESHOLDS}"
        f" (affine and binary-search bin index) and on {len(cases)} edge cases; an empty batch launches nothing"
    )

    times = _measure(
        [
            ("kernel", binned_curve_state, arg_sets),
            ("plain", binned_curve_state_plain, plain_sets),
            ("read_floor", _read_floor, [(p,) for p in probs]),
        ]
    )
    n_elem = BATCH * NUM_CLASSES
    n_bytes = n_elem * 4 + BATCH * 4 + THRESHOLDS * 4 + THRESHOLDS * NUM_CLASSES * 4 * 4
    n_ops = n_elem * 6  # affine bin index: subtract, multiply, three compares, one add
    bound_ms, bound_by = _bound(n_bytes, n_ops)
    return {
        "name": "binned_curve_state",
        "route": "cuda",
        "source": "torchmetrics_tpu_torch/csrc/binned_curve_state.cu",
        "replaces": "torchmetrics_tpu/functional/classification/precision_recall_curve.py:295",
        "max_abs_err": max_err,
        "ms": times["kernel"]["device_ms"],
        "plain_ms": times["plain"]["device_ms"],
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "stream_ms": {k: v["stream_ms"] for k, v in times.items()},
        "kernel_only_us": _kernel_only_us(times["kernel"]["found"], "binned_curve_state"),
        "bytes": n_bytes,
        "read_floor_ms": times["read_floor"]["device_ms"],
    }


def _hard_rows(scores):
    """Rows jnp.argmax rules on, written into the first rows of ``scores``: ties, NaN, -inf, +-0."""
    c = scores.shape[1]
    scores[0] = float("nan")  # all NaN: 0
    scores[1] = float("-inf")  # all -inf: 0
    scores[2] = 0.0
    scores[2, ::2] = -0.0  # -0 and 0 tie: 0
    scores[3] = 0.25  # all tied: 0
    scores[4, c // 2 :] = 1e9  # tied maxima: the first of them
    scores[5, c - 1] = float("nan")  # one NaN beats every number
    scores[6, 1:] = float("inf")
    scores[6, 3] = float("nan")  # NaN beats +inf
    return scores


def check_stat_counts(device, batches):
    """K2 against ``stat_counts_plain``: main-path shape, edge batches; then timed beside ``torch.argmax``."""
    import torch

    from torchmetrics_tpu_torch.ops import stat_counts, stat_counts_plain

    c = NUM_CLASSES
    arg_sets = [(logits, labels, c) for logits, labels in batches]
    max_err = _assert_bitwise(stat_counts(*arg_sets[0]), stat_counts_plain(*arg_sets[0]), "stat_counts, main-path shape")

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 2)
    n = 70001
    s_edge = _hard_rows(torch.randn((n, c), generator=gen, device=device))
    s_odd = _hard_rows(torch.randn((n, 7), generator=gen, device=device))
    s_wide = _hard_rows(torch.randn((3001, 4000), generator=gen, device=device))
    p_edge = torch.randint(-3, c + 3, (n,), generator=gen, device=device, dtype=torch.int32)
    t_edge = torch.randint(-3, c + 3, (n,), generator=gen, device=device, dtype=torch.int64)
    t_ign = t_edge.clone()
    t_ign[::7] = 5
    cases = [
        ("scores, out-of-range targets, no ignore_index", s_edge, t_edge, c, None),
        ("scores, ignore_index=5", s_edge, t_ign, c, 5),
        ("scores, ignore_index=-1 outside the classes", s_edge, t_edge, c, -1),
        ("scores, C=7 (scalar loads)", s_odd, t_edge.remainder(9) - 1, 7, 3),
        ("scores, C=4000 (partials in global memory)", s_wide, t_edge[:3001] * 60, 4000, None),
        ("int32 labels, out of range", p_edge, t_edge, c, None),
        ("int64 labels, ignore_index=5", p_edge.to(torch.int64) + 2**32, t_ign, c, 5),
        ("int32 labels, C=2", p_edge.remainder(2), t_edge.remainder(2), 2, None),
    ]
    for what, p, t, nc, ignore in cases:
        _assert_bitwise(stat_counts(p, t, nc, ignore), stat_counts_plain(p, t, nc, ignore), f"stat_counts, {what}")
    before = stat_counts.launches
    empty = stat_counts(s_edge[:0], t_edge[:0], c, 5)
    _require(stat_counts.launches == before, "stat_counts: an empty batch counted a launch")
    _require(int(empty.abs().sum()) == 0 and empty.shape == (4, c), "stat_counts: empty batch not zero")
    torch.cuda.synchronize()
    print(
        f"[kernels] stat_counts: bitwise equal to its plain version at N={BATCH} C={NUM_CLASSES}"
        f" and on {len(cases)} edge cases; an empty batch launches nothing"
    )

    def library(logits):  # only a part of the function: the argmax that K2 fuses
        return torch.argmax(logits, dim=1)

    times = _measure(
        [
            ("kernel", stat_counts, arg_sets),
            ("plain", stat_counts_plain, arg_sets),
            ("library", library, [(logits,) for logits, _ in batches]),
            ("read_floor", _read_floor, [(logits,) for logits, _ in batches]),
        ]
    )
    n_bytes = BATCH * c * 4 + BATCH * 4 + 4 * c * 4
    bound_ms, bound_by = _bound(n_bytes, BATCH * c)  # one compare per score
    return {
        "name": "stat_counts",
        "route": "cuda",
        "source": "torchmetrics_tpu_torch/csrc/stat_counts.cu",
        "replaces": "torchmetrics_tpu/functional/classification/stat_scores.py:300",
        "max_abs_err": max_err,
        "ms": times["kernel"]["device_ms"],
        "plain_ms": times["plain"]["device_ms"],
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": times["library"]["device_ms"],
        "stream_ms": {k: v["stream_ms"] for k, v in times.items()},
        "kernel_only_us": _kernel_only_us(times["kernel"]["found"], "stat_counts"),
        "bytes": n_bytes,
        "read_floor_ms": times["read_floor"]["device_ms"],
    }


# ---------------------------------------------------------------------- entry

# the entry's values on the card against the same step on the CPU: accuracy
# and F1 come from the same argmax of the same logits (1e-6); the AUROC may
# move where a softmax ulp carries a probability across a threshold, the
# budget tests/test_torch_slice.py holds the port to against the JAX entry
ENTRY_ATOL = {"accuracy": 1e-6, "f1_macro": 1e-6, "auroc_macro": 2e-3}


def phase_entry(kernels):
    import torch

    from torchmetrics_tpu_torch._entry import entry

    fn, args = entry()
    for wrapper in kernels.values():
        wrapper.launches = 0
    out = fn(*args)
    torch.cuda.synchronize()
    launches = {name: wrapper.launches for name, wrapper in kernels.items()}
    _require(all(n == 1 for n in launches.values()), f"entry(): kernel launches {launches}, expected one each")
    _require(all(v.device.type == "cuda" for v in out.values()), "entry(): results not on the card")
    ref_fn, ref_args = entry(device="cpu")
    ref = ref_fn(*ref_args)
    diffs = {k: abs(float(out[k]) - float(ref[k])) for k in ref}
    for k, d in diffs.items():
        _require(math.isfinite(float(out[k])) and d <= ENTRY_ATOL[k], f"entry(): {k} {float(out[k])} vs CPU {float(ref[k])}")
    print(f"[entry] on the card: launches {launches}; |card - CPU| {diffs}")
    return diffs


# ---------------------------------------------------------------------- slice


def _short_kernel_name(key):
    """A profiler kernel name cut to its function and the op it was built for."""
    import re

    key = re.sub(r"^void |\(anonymous namespace\)::", "", key)
    base = key.split("<")[0].split("(")[0].split("::")[-1]
    tag = re.search(r"(\w+Ops|\w+Functor\w*|\w+_functor|\w*[Ss]oftmax\w*)", key)
    return base if not tag or tag.group(1) in base else f"{base}[{tag.group(1)}]"


# device kernels the redesigned K1 and K2 took over, by a pattern of their names
WATCHED_LAUNCHES = {"argmax": r"ArgMax", "cumsum": r"[Ss]can", "int32_sum": r"sum_functor<int\b"}


def _watched_launches(found):
    """Launches, by WATCHED_LAUNCHES pattern, among the profiler's device kernels."""
    import re

    return {what: sum(n for key, (_, n) in found.items() if re.search(pat, key)) for what, pat in WATCHED_LAUNCHES.items()}


def _plain_curve_state(batches, device):
    """The multiclass PR-curve state (T=THRESHOLDS) of the stream, folded through K1's plain version on the card."""
    import torch

    from torchmetrics_tpu_torch.ops import binned_curve_state_plain
    from torchmetrics_tpu_torch.utilities.compute import _linspace_like_jax

    thr = _linspace_like_jax(0.0, 1.0, THRESHOLDS, device=device)
    confmat = torch.zeros((THRESHOLDS, NUM_CLASSES, 2, 2), dtype=torch.int32, device=device)
    for logits, labels in batches:
        confmat += binned_curve_state_plain(torch.softmax(logits, dim=1), thr, labels, True)
    return confmat


def _expected_states_plain(batches, device):
    """The suite's final states from the same stream folded through the plain
    versions of the kernels (and the plain micro path), on the card."""
    import torch

    from torchmetrics_tpu_torch.ops import stat_counts_plain

    c = NUM_CLASSES
    zeros = lambda shape: torch.zeros(shape, dtype=torch.int32, device=device)  # noqa: E731
    acc = {k: zeros(()) for k in ("tp", "fp", "tn", "fn")}
    f1 = {k: zeros((c,)) for k in ("tp", "fp", "tn", "fn")}
    for logits, labels in batches:
        pred = torch.argmax(logits, dim=1)
        hit = (pred == labels).sum(dtype=torch.int32)
        miss = (pred != labels).sum(dtype=torch.int32)
        acc["tp"] += hit
        acc["fp"] += miss
        acc["fn"] += miss
        acc["tn"] += c * BATCH - (hit + 2 * miss)
        for name, counts in zip(("tp", "fp", "tn", "fn"), stat_counts_plain(logits, labels, c)):
            f1[name] += counts
    return {"acc": acc, "f1": f1, "auroc": {"confmat": _plain_curve_state(batches, device)}}


def _numpy_reference_values(batches):
    """Micro accuracy and macro F1 from a numpy confusion matrix of the same stream."""
    import numpy as np

    c = NUM_CLASSES
    cm = np.zeros((c, c), np.int64)
    for logits, labels in batches:
        pred = logits.argmax(1).cpu().numpy()
        np.add.at(cm, (labels.cpu().numpy(), pred), 1)
    tp = np.diag(cm).astype(np.float64)
    fp, fn = cm.sum(0) - tp, cm.sum(1) - tp
    denom = 2 * tp + fp + fn
    f1 = np.where(denom > 0, 2 * tp / np.where(denom > 0, denom, 1), 0.0)
    present = (tp + fp + fn) > 0
    return tp.sum() / cm.sum(), f1[present].mean()


def _headline_suite(tm, validate_args=False, device="cuda"):
    return tm.MetricCollection(
        {
            "acc": tm.MulticlassAccuracy(num_classes=NUM_CLASSES, average="micro", validate_args=validate_args, device=device),
            "f1": tm.MulticlassF1Score(num_classes=NUM_CLASSES, average="macro", validate_args=validate_args, device=device),
            "auroc": tm.MulticlassAUROC(
                num_classes=NUM_CLASSES, average="macro", thresholds=THRESHOLDS, validate_args=validate_args, device=device
            ),
        },
        compute_groups=True,
    )


def _require_states_bitwise(suite, expected, what):
    for key, states in expected.items():
        for name, want in states.items():
            _assert_bitwise(getattr(suite[key], name), want, f"{what}: state {key}.{name}")


def phase_slice(device, batches, kernels):
    import torch

    import torchmetrics_tpu_torch as tm

    suite = _headline_suite(tm)
    for wrapper in kernels.values():
        wrapper.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for logits, labels in batches:
        suite.update(logits, labels)
    values = suite.compute()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {name: wrapper.launches for name, wrapper in kernels.items()}

    print(f"[slice] launches over {NUM_BATCHES} batches: {launches}")
    for name, count in launches.items():
        _require(count == NUM_BATCHES, f"kernel {name} launched {count} times on the main path, expected {NUM_BATCHES}")
    # each metric holds states no other has, so the JAX collection (pinned in
    # tests/test_torch_slice.py) keeps each in a group of its own
    groups = sorted(sorted(g) for g in suite.compute_groups.values())
    _require(groups == [["acc"], ["auroc"], ["f1"]], f"compute groups {groups}, expected each metric on its own")

    _require_states_bitwise(suite, _expected_states_plain(batches, device), "slice")
    print("[slice] final states equal bitwise to the stream folded through the plain versions")

    vals = {k: float(v) for k, v in values.items()}
    print(f"[slice] values: {vals}")
    for k, v in vals.items():
        _require(math.isfinite(v) and 0.0 <= v <= 1.0, f"{k}={v} is not a finite value in [0, 1]")
    want_acc, want_f1 = _numpy_reference_values(batches)
    _require(abs(vals["acc"] - want_acc) <= 1e-6, f"accuracy {vals['acc']} vs numpy {want_acc}")
    _require(abs(vals["f1"] - want_f1) <= 1e-5, f"macro F1 {vals['f1']} vs numpy {want_f1}")

    steady = _steady_and_profile("slice", suite.update, batches, reset=suite.reset)
    samples = NUM_BATCHES * BATCH
    print(
        f"[slice] {samples} samples: first pass (update + group formation + compute) {seconds:.4f} s ="
        f" {samples / seconds:.1f} samples/s; steady updates, median of {STEADY_PASSES} passes {steady['median_s']:.4f} s ="
        f" {samples / steady['median_s']:.1f} samples/s (passes: {', '.join(f'{p:.4f}' for p in steady['passes'])} s)"
    )
    return {"launches": launches, "first_sps": samples / seconds, "steady_sps": samples / steady["median_s"], "values": values, **steady}


def _steady_and_profile(tag, update, batches, reset=None):
    """Steady passes of ``update`` over ``batches`` (a suite's, its compute
    groups settled, or a fused plan's, its graph captured; ``reset`` before
    each pass where given), their median, and where one pass's device time
    goes, by kernel, and the host's; printed under ``[profile]`` and ``[host]``."""
    import torch

    def steady_pass():
        for batch in batches:
            update(*batch)

    passes = []
    for _ in range(STEADY_PASSES):
        if reset is not None:
            reset()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        steady_pass()
        torch.cuda.synchronize()
        passes.append(time.perf_counter() - t1)
    steady = statistics.median(passes)

    found, busy_us, wall_us = _profile(steady_pass, 1)
    print(
        f"[profile] {tag}, steady pass of {len(batches)} updates: device busy {busy_us:.1f} us in kernels; busy share"
        f" {busy_us / (steady * 1e6):.3f} of the unprofiled median window ({steady * 1e6:.1f} us),"
        f" {busy_us / wall_us:.3f} of the profiled one ({wall_us:.1f} us)"
    )
    watched = _watched_launches(found)
    print(
        f"[profile] {tag}, launches per pass of {len(batches)} updates: {sum(n for _, n in found.values())} device kernels;"
        f" {watched}"
    )
    top = sorted(found.items(), key=lambda kv: -kv[1][0])
    for key, (t, n) in top[:12]:
        print(f"[profile]   {t:10.1f} us  {n:4d} launches  {key[:110]}")
    host = cProfile.Profile()
    host.enable()
    steady_pass()
    torch.cuda.synchronize()
    host.disable()
    text = io.StringIO()
    stats = pstats.Stats(host, stream=text)
    stats.sort_stats("tottime").print_stats(12)
    for line in text.getvalue().splitlines():
        if line.strip() and ("function calls" in line or not line.startswith(("   Ordered", "         "))):
            print(f"[host] {tag}: {line[:150]}")
    return {
        "found": found,
        "median_s": steady,
        "passes": passes,
        "steady_range_ms": (min(passes) * 1e3, max(passes) * 1e3),
        "busy_us": busy_us,
        "busy_share": busy_us / (steady * 1e6),
        "top": [(_short_kernel_name(key), t, n) for key, (t, n) in top[:6]],
        "host_calls": stats.total_calls,
        "watched": watched,
        "device_launches": sum(n for _, n in found.values()),
    }


# --------------------------------------------------------------- K1 matrix mode


def _multilabel_batches(device):
    """The multilabel stream: NUM_BATCHES (logits, targets) pairs of BATCH x NUM_CLASSES labels, made on
    the card from SEED + 3; targets in {0, 1}, about 1% of them -1 (``ignore_index=-1``)."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 3)
    batches = []
    for _ in range(NUM_BATCHES):
        logits = torch.randn((BATCH, NUM_CLASSES), generator=gen, device=device, dtype=torch.float32)
        target = torch.randint(0, 2, (BATCH, NUM_CLASSES), generator=gen, device=device, dtype=torch.int32)
        ignored = torch.rand((BATCH, NUM_CLASSES), generator=gen, device=device) < 0.01
        batches.append((logits, torch.where(ignored, -1, target)))
    return batches


def check_binned_curve_matrix_mode(device, ml_batches):
    """K1 in matrix mode (an (N, K) target, -1 masking an entry), the multilabel path's
    launch, against its plain version at the bench's width; then timed."""
    import torch

    from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import _uniform_grid
    from torchmetrics_tpu_torch.ops import binned_curve_state, binned_curve_state_plain
    from torchmetrics_tpu_torch.utilities.compute import _linspace_like_jax

    thr = _linspace_like_jax(0.0, 1.0, THRESHOLDS, device=device)
    affine = _uniform_grid(THRESHOLDS)
    arg_sets = [(torch.sigmoid(logits), thr, target, False, affine) for logits, target in ml_batches]
    plain_sets = [a[:4] for a in arg_sets]
    want = binned_curve_state_plain(*plain_sets[0])
    max_err = _assert_bitwise(binned_curve_state(*arg_sets[0]), want, "binned_curve_state, matrix mode, bench width")
    _assert_bitwise(binned_curve_state(*plain_sets[0]), want, "binned_curve_state, matrix mode, binary search")
    _assert_state_counts(want, int((ml_batches[0][1] >= 0).sum()), "binned_curve_state, matrix mode")
    times = _measure(
        [
            ("kernel", binned_curve_state, arg_sets),
            ("plain", binned_curve_state_plain, plain_sets),
            ("read_floor", _read_floor, [(a[0],) for a in arg_sets]),
        ]
    )
    n_elem = BATCH * NUM_CLASSES
    n_bytes = n_elem * 4 * 2 + THRESHOLDS * 4 + THRESHOLDS * NUM_CLASSES * 4 * 4  # probabilities, int32 targets, grid, state
    bound_ms, bound_by = _bound(n_bytes, n_elem * 6)
    row = {
        "ms": times["kernel"]["device_ms"],
        "kernel_only_us": _kernel_only_us(times["kernel"]["found"], "binned_curve_state"),
        "plain_ms": times["plain"]["device_ms"],
        "read_floor_ms": times["read_floor"]["device_ms"],
        "stream_ms": {k: v["stream_ms"] for k, v in times.items()},
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "bytes": n_bytes,
        "max_abs_err": max_err,
    }
    print(
        f"[kernels] binned_curve_state, matrix mode: bitwise equal to its plain version at {BATCH}x{NUM_CLASSES}"
        f" T={THRESHOLDS} with -1 entries (affine and binary-search bin index)"
    )
    return row


# ---------------------------------------------------------------------- exact

# kernels of the exact path's sort, by a pattern of their device names, and
# the kinds its compute time is split into (the first pattern that matches)
SORT_KERNELS = r"[Ss]ort"
EXACT_KINDS = {"sort": SORT_KERNELS, "scan (cumsum, cummax)": r"scan", "gather": r"gather|index",
               "copy and cast": r"copy|Cat", "reduce": r"reduce"}


def _numpy_exact_reference(preds, target):
    """Per-class AUROC (the Mann-Whitney statistic with midranks) and AP (from a
    stable descending sort, tie groups merged) of the stored probabilities, in
    float64 with numpy and scipy."""
    import numpy as np
    from scipy.stats import rankdata

    p = preds.cpu().numpy().astype(np.float64)
    y = target.cpu().numpy()
    p, y = p[y >= 0], y[y >= 0]
    ranks = rankdata(p, axis=0)
    auroc, ap = np.empty(p.shape[1]), np.empty(p.shape[1])
    for c in range(p.shape[1]):
        pos = y == c
        n_pos, n_neg = pos.sum(), (~pos).sum()
        auroc[c] = (ranks[pos, c].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg)
        order = np.argsort(-p[:, c], kind="stable")
        ps, ys = p[order, c], pos[order]
        tps = np.cumsum(ys)
        ends = np.r_[ps[1:] != ps[:-1], True]
        tp_e, seen = tps[ends], np.arange(1, len(ys) + 1)[ends]
        ap[c] = np.sum(np.diff(np.r_[0, tp_e]) * tp_e / seen) / n_pos
    return auroc, ap


def phase_exact(device, batches, kernels):
    """MulticlassAUROC and MulticlassAveragePrecision at their exact defaults
    (``thresholds=None``, macro) over the slice's stream: one compute group;
    per-class values against the CPU fold and a float64 reference; one class's
    padded curve bitwise against the CPU; compute's device time, launches,
    sort share and peak memory."""
    import torch

    import torchmetrics_tpu_torch as tm
    from torchmetrics_tpu_torch.functional.classification.auroc import _multiclass_auroc_compute
    from torchmetrics_tpu_torch.functional.classification.average_precision import _multiclass_average_precision_compute
    from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import _binary_clf_curve_padded

    c = NUM_CLASSES
    suite = tm.MetricCollection(
        {
            "auroc": tm.MulticlassAUROC(num_classes=c, validate_args=False, device=device),
            "ap": tm.MulticlassAveragePrecision(num_classes=c, validate_args=False, device=device),
        },
        compute_groups=True,
    )
    for wrapper in kernels.values():
        wrapper.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for logits, labels in batches:
        suite.update(logits, labels)
    torch.cuda.synchronize()
    update_s = time.perf_counter() - t0
    groups = sorted(sorted(g) for g in suite.compute_groups.values())
    _require(groups == [["ap", "auroc"]], f"exact: compute groups {groups}, expected AUROC and AP in one")
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t1 = time.perf_counter()
    values = suite.compute()
    torch.cuda.synchronize()
    compute_s = time.perf_counter() - t1
    peak = torch.cuda.max_memory_allocated()
    launches = {name: wrapper.launches for name, wrapper in kernels.items()}
    vals = {k: float(v) for k, v in values.items()}
    for k, v in vals.items():
        _require(math.isfinite(v) and 0.0 <= v <= 1.0, f"exact: {k}={v} is not a finite value in [0, 1]")

    state = suite["auroc"]._curve_state()
    per_class = {
        "auroc": _multiclass_auroc_compute(state, c, None).cpu(),
        "ap": _multiclass_average_precision_compute(state, c, None).cpu(),
    }
    for k in per_class:
        _require(abs(vals[k] - float(per_class[k].mean())) <= 1e-6, f"exact: macro {k} {vals[k]} vs mean of its classes")
    cpu = {
        "auroc": tm.MulticlassAUROC(num_classes=c, average=None, validate_args=False, device="cpu"),
        "ap": tm.MulticlassAveragePrecision(num_classes=c, average=None, validate_args=False, device="cpu"),
    }
    for logits, labels in batches:
        for metric in cpu.values():
            metric.update(logits.cpu(), labels.cpu())
    err_cpu = {k: float((per_class[k] - cpu[k].compute()).abs().max()) for k in cpu}
    ref_auroc, ref_ap = _numpy_exact_reference(*state)
    err_ref = {
        "auroc": float(abs(per_class["auroc"].double().numpy() - ref_auroc).max()),
        "ap": float(abs(per_class["ap"].double().numpy() - ref_ap).max()),
    }
    for k in cpu:
        _require(err_cpu[k] <= 1e-6, f"exact: per-class {k} on the card vs the CPU fold: max |diff| {err_cpu[k]}")
        _require(err_ref[k] <= 1e-4, f"exact: per-class {k} vs the float64 reference: max |diff| {err_ref[k]}")

    preds, target = state
    tgt = torch.where(target >= 0, (target == 0).to(torch.int32), -1)
    card_curve = _binary_clf_curve_padded(preds[:, 0], tgt)
    cpu_curve = _binary_clf_curve_padded(preds[:, 0].cpu(), tgt.cpu())
    for what, g, w in zip(("fps", "tps", "thresholds", "mask"), card_curve, cpu_curve):
        g = g.cpu()
        same = torch.equal(g.view(torch.int32), w.view(torch.int32)) if g.is_floating_point() else torch.equal(g, w)
        _require(same, f"exact: class 0's padded curve, {what}, differs between the card and the CPU")

    def compute_once():
        for metric in suite.values(copy_state=False):
            metric._computed = None
        suite.compute()

    found, busy_us, _ = _profile(compute_once, 3)
    import re

    sort_us = sum(t for key, (t, _) in found.items() if re.search(SORT_KERNELS, key))
    kinds = {}
    for key, (t, n) in found.items():
        kind = next((k for k, pat in EXACT_KINDS.items() if re.search(pat, key)), "other")
        us, count = kinds.get(kind, (0.0, 0))
        kinds[kind] = (us + t / 3, count + n / 3)
    print("[exact] compute device us by kind: " + "; ".join(f"{k} {us:.1f} in {n:.0f}" for k, (us, n) in sorted(kinds.items(), key=lambda kv: -kv[1][0])))
    device_launches = sum(n for _, n in found.values()) / 3
    top = sorted(found.items(), key=lambda kv: -kv[1][0])
    for key, (t, n) in top[:10]:
        print(f"[exact]   {t / 3:10.1f} us  {n / 3:6.1f} launches  {key[:110]}")
    samples = NUM_BATCHES * BATCH
    print(
        f"[exact] MulticlassAUROC + MulticlassAveragePrecision (thresholds=None, macro) over {samples}x{c}:"
        f" values {vals}; hand-kernel launches {launches}; update pass {update_s:.4f} s; first compute {compute_s:.4f} s wall;"
        f" compute device {busy_us / 3 / 1e3:.3f} ms, {device_launches:.0f} device kernels, sort share {sort_us / busy_us:.3f};"
        f" peak memory {peak / 2**20:.1f} MiB ({(peak - held) / 2**20:.1f} MiB above the {held / 2**20:.1f} MiB held before compute);"
        f" per-class max |card - CPU| {err_cpu}, max |card - float64 reference| {err_ref};"
        " class 0's padded curve bitwise equal on the card and the CPU"
    )
    return {"compute_ms": busy_us / 3 / 1e3, "sort_share": sort_us / busy_us, "peak_mib": peak / 2**20, "values": values,
            "per_class": per_class}


# ----------------------------------------------------------------- multilabel


def _numpy_multilabel_reference(ml_batches):
    """Macro accuracy, macro F1 (at 0.5) and macro binned AUROC (T=128) of the
    multilabel stream in float64 with numpy; ignored (-1) entries dropped."""
    import numpy as np

    logits = np.concatenate([logits.cpu().numpy() for logits, _ in ml_batches]).astype(np.float64)
    y = np.concatenate([target.cpu().numpy() for _, target in ml_batches])
    pred = logits > 0  # sigmoid(x) > 0.5; an ignored entry (-1) is neither 0 nor 1
    tp = (pred & (y == 1)).sum(0)
    fp = (pred & (y == 0)).sum(0)
    tn = (~pred & (y == 0)).sum(0)
    fn = (~pred & (y == 1)).sum(0)
    acc = ((tp + tn) / (tp + tn + fp + fn)).mean()
    f1 = (2 * tp / np.maximum(2 * tp + fp + fn, 1)).mean()
    thr = np.linspace(0, 1, THRESHOLDS).astype(np.float32).astype(np.float64)
    bins = np.searchsorted(thr, 1 / (1 + np.exp(-logits)), side="right")  # thresholds <= p
    aucs = []
    for k in range(y.shape[1]):
        ge = []
        for label in (1, 0):
            hist = np.bincount(bins[y[:, k] == label, k], minlength=THRESHOLDS + 1)
            ge.append(np.cumsum(hist[::-1])[::-1][1:] / hist.sum())  # share with p >= thr_t
        tpr, fpr = ge[0][::-1], ge[1][::-1]
        aucs.append(np.sum(np.diff(fpr) * (tpr[1:] + tpr[:-1]) / 2))
    return acc, f1, float(np.mean(aucs))


def phase_multilabel(device, ml_batches, kernels):
    """MultilabelAccuracy, MultilabelF1Score(macro) and MultilabelAUROC(macro,
    thresholds=128) over the multilabel stream: K1 launches once per batch in
    matrix mode; states bitwise against the stream folded with K1's plain
    version; values against a numpy reference; the steady pass profiled."""
    import torch

    import torchmetrics_tpu_torch as tm
    from torchmetrics_tpu_torch.functional.classification.stat_scores import (
        _multilabel_stat_scores_format,
        _multilabel_stat_scores_update,
    )
    from torchmetrics_tpu_torch.ops import binned_curve_state, binned_curve_state_plain
    from torchmetrics_tpu_torch.utilities.compute import _linspace_like_jax, normalize_logits_if_needed

    c = NUM_CLASSES
    common = {"ignore_index": -1, "validate_args": False, "device": device}
    suite = tm.MetricCollection(
        {
            "acc": tm.MultilabelAccuracy(num_labels=c, **common),
            "f1": tm.MultilabelF1Score(num_labels=c, average="macro", **common),
            "auroc": tm.MultilabelAUROC(num_labels=c, average="macro", thresholds=THRESHOLDS, **common),
        },
        compute_groups=True,
    )
    for wrapper in kernels.values():
        wrapper.launches = 0
    binned_curve_state.matrix_launches = 0
    for logits, target in ml_batches:
        suite.update(logits, target)
    values = suite.compute()
    torch.cuda.synchronize()
    launches = {name: wrapper.launches for name, wrapper in kernels.items()}
    matrix = binned_curve_state.matrix_launches
    _require(
        launches["binned_curve_state"] == matrix == NUM_BATCHES,
        f"multilabel: K1 launched {launches['binned_curve_state']} times ({matrix} in matrix mode), expected {NUM_BATCHES}",
    )
    groups = sorted(sorted(g) for g in suite.compute_groups.values())
    _require(groups == [["acc", "f1"], ["auroc"]], f"multilabel: compute groups {groups}, expected accuracy and F1 in one")

    thr = _linspace_like_jax(0.0, 1.0, THRESHOLDS, device=device)
    want = {k: torch.zeros(c, dtype=torch.int32, device=device) for k in ("tp", "fp", "tn", "fn")}
    confmat = torch.zeros((THRESHOLDS, c, 2, 2), dtype=torch.int32, device=device)
    for logits, target in ml_batches:
        preds, tgt = _multilabel_stat_scores_format(logits, target, c, 0.5, -1)
        for name, counts in zip(("tp", "fp", "tn", "fn"), _multilabel_stat_scores_update(preds, tgt)):
            want[name] += counts
        confmat += binned_curve_state_plain(normalize_logits_if_needed(logits, "sigmoid"), thr, target, False)
    for key in ("acc", "f1"):
        for name, counts in want.items():
            _assert_bitwise(getattr(suite[key], name), counts, f"multilabel state {key}.{name}")
    _assert_bitwise(suite["auroc"].confmat, confmat, "multilabel state auroc.confmat")

    vals = {k: float(v) for k, v in values.items()}
    ref = dict(zip(("acc", "f1", "auroc"), _numpy_multilabel_reference(ml_batches)))
    for k, tol in (("acc", 1e-6), ("f1", 1e-5), ("auroc", 1e-5)):
        _require(abs(vals[k] - ref[k]) <= tol, f"multilabel: {k} {vals[k]} vs numpy {ref[k]} (tolerance {tol})")
    steady = _steady_and_profile("multilabel", suite.update, ml_batches, reset=suite.reset)
    print(
        f"[multilabel] {NUM_BATCHES}x{BATCH}x{c} logits, 1% ignored: values {vals} (numpy {ref}); launches {launches},"
        f" K1 in matrix mode {matrix}; states bitwise equal to the fold with K1's plain version; steady pass"
        f" {steady['median_s'] * 1e3:.3f} ms median, device work {steady['busy_us']:.1f} us in"
        f" {steady['device_launches']} device kernels, busy share {steady['busy_share']:.3f}"
    )
    return {"launches": launches, **steady}


# ------------------------------------------------------------------- families

# the stat-scores families (one compute group: tp/fp/tn/fn, K2 once per batch)
# and the confusion-matrix families (one compute group: a C x C int32 confmat)
FAMILY_STAT = {
    "prec": "MulticlassPrecision",
    "rec": "MulticlassRecall",
    "npv": "MulticlassNegativePredictiveValue",
    "spec": "MulticlassSpecificity",
    "ham": "MulticlassHammingDistance",
}
FAMILY_CONFMAT = {
    "cm": "MulticlassConfusionMatrix",
    "jac": "MulticlassJaccardIndex",
    "mcc": "MulticlassMatthewsCorrCoef",
    "kappa": "MulticlassCohenKappa",
}
# values against numpy float64 on the same counts: float32 divisions and
# reductions over 64 classes (and MCC's and kappa's float32 squares of counts
# up to 524288) stay far inside this absolute budget
FAMILY_ATOL = 1e-5


def _family_suite(tm):
    kw = {"num_classes": NUM_CLASSES, "validate_args": False, "device": "cuda"}
    members = {key: getattr(tm, name)(average="macro", **kw) for key, name in FAMILY_STAT.items()}
    members.update({key: getattr(tm, name)(**kw) for key, name in FAMILY_CONFMAT.items()})
    return tm.MetricCollection(members, compute_groups=True)


def _numpy_family_reference(batches):
    """The stream's confusion matrix from a numpy argmax and ``np.bincount`` on
    the host, the int32 tp/fp/tn/fn derived from it, and every family's value
    in float64 (macro over the classes present, as the port averages)."""
    import numpy as np

    c = NUM_CLASSES
    cm = np.zeros(c * c, np.int64)
    for logits, labels in batches:
        pred = logits.cpu().numpy().argmax(1)
        cm += np.bincount(labels.cpu().numpy().astype(np.int64) * c + pred, minlength=c * c)
    cm = cm.reshape(c, c)
    f = cm.astype(np.float64)
    tp = np.diag(f)
    fp, fn = f.sum(0) - tp, f.sum(1) - tp
    tn = f.sum() - tp - fp - fn
    present = (tp + fp + fn) > 0

    def ratio(num, den):
        return np.where(den > 0, num / np.where(den > 0, den, 1), 0.0)

    def macro(score):
        return score[present].mean()

    s, tk, pk = f.sum(), f.sum(1), f.sum(0)
    mcc = (np.trace(f) * s - (tk * pk).sum()) / np.sqrt((s**2 - (pk * pk).sum()) * (s**2 - (tk * tk).sum()))
    expected = np.outer(tk, pk) / s
    off = 1.0 - np.eye(c)
    union = tk + pk - tp
    values = {
        "prec": macro(ratio(tp, tp + fp)),
        "rec": macro(ratio(tp, tp + fn)),
        "npv": macro(ratio(tn, tn + fn)),
        "spec": macro(ratio(tn, tn + fp)),
        "ham": macro(1.0 - ratio(tp, tp + fn)),
        "jac": ratio(tp, union)[union > 0].mean(),
        "mcc": mcc,
        "kappa": 1.0 - (off * f).sum() / (off * expected).sum(),
    }
    counts = {"tp": tp, "fp": fp, "tn": tn, "fn": fn}
    return cm.astype(np.int32), {k: v.astype(np.int32) for k, v in counts.items()}, values


def _confmat_update(logits, labels):
    """The confusion-matrix family's update of one batch, as the module runs it: argmax, indices, count."""
    from torchmetrics_tpu_torch.functional.classification.confusion_matrix import (
        _multiclass_confusion_matrix_format,
        _multiclass_confusion_matrix_update,
    )

    preds, target = _multiclass_confusion_matrix_format(logits, labels)
    return _multiclass_confusion_matrix_update(preds, target, NUM_CLASSES)


def phase_families(device, batches, kernels):
    """The stat-scores families (precision, recall, NPV, specificity, Hamming;
    macro) and the confusion-matrix families (confusion matrix, Jaccard, MCC,
    kappa) in one collection over the slice's stream: two compute groups; K2
    once per batch; ``confmat`` bitwise equal to a numpy ``np.bincount`` fold
    and tp/fp/tn/fn to the counts derived from it; values within FAMILY_ATOL
    of numpy float64; the same collection through ``suite.fused()`` bitwise
    equal, K2 once per replay in the trace; the confusion-matrix update
    alone timed beside its bound and ``torch.bincount`` on the same indices;
    ``torch.argmax`` and the confusion matrix on the hard rows against the CPU's."""
    import torch

    import torchmetrics_tpu_torch as tm
    from torchmetrics_tpu_torch.functional.classification import multiclass_confusion_matrix

    t_phase = time.perf_counter()
    c = NUM_CLASSES
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 4)
    hard = _hard_rows(torch.randn((4096, c), generator=gen, device=device))
    hard_target = torch.randint(0, c, (4096,), generator=gen, device=device, dtype=torch.int32)
    _require(
        torch.equal(torch.argmax(hard, dim=1).cpu(), torch.argmax(hard.cpu(), dim=1)),
        "families: torch.argmax on the card differs from the CPU's on the hard rows (ties, NaN, -inf, +-0)",
    )
    hard_cm = multiclass_confusion_matrix(hard, hard_target, c, validate_args=False)
    _require(
        torch.equal(hard_cm.cpu(), multiclass_confusion_matrix(hard.cpu(), hard_target.cpu(), c, validate_args=False)),
        "families: the confusion matrix of the hard rows differs between the card and the CPU",
    )
    suite = _family_suite(tm)
    suite.update(*batches[0])  # two updates form the compute groups; then one leader per group updates
    suite.update(*batches[1])
    suite.reset()
    for wrapper in kernels.values():
        wrapper.launches = 0
    for logits, labels in batches:
        suite.update(logits, labels)
    values = suite.compute()
    torch.cuda.synchronize()
    launches = {name: wrapper.launches for name, wrapper in kernels.items()}
    _require(launches["stat_counts"] == NUM_BATCHES, f"families: K2 launched {launches['stat_counts']} times, expected {NUM_BATCHES}")
    groups = sorted(sorted(g) for g in suite.compute_groups.values())
    want_groups = sorted([sorted(FAMILY_CONFMAT), sorted(FAMILY_STAT)])
    _require(groups == want_groups, f"families: compute groups {groups}, expected {want_groups}")

    cm, counts, ref = _numpy_family_reference(batches)
    expected = {
        "cm": {"confmat": torch.from_numpy(cm).to(device)},
        "prec": {name: torch.from_numpy(v).to(device) for name, v in counts.items()},
    }
    _require_states_bitwise(suite, expected, "families")
    _require(torch.equal(values["cm"].cpu(), torch.from_numpy(cm)), "families: the confusion matrix's value is not its state")
    vals = {k: float(v) for k, v in values.items() if k != "cm"}
    diffs = {k: abs(vals[k] - ref[k]) for k in vals}
    for k, d in diffs.items():
        _require(math.isfinite(vals[k]) and d <= FAMILY_ATOL, f"families: {k} {vals[k]} vs numpy float64 {ref[k]}")
    print(
        f"[families] launches over {NUM_BATCHES} batches {launches}; compute groups {groups}; confmat bitwise equal to"
        f" the numpy np.bincount fold, tp/fp/tn/fn to the counts derived from it; values {vals}; |card - numpy float64|"
        f" max {max(diffs.values()):.2e} (budget {FAMILY_ATOL})"
    )
    eager = _steady_and_profile("families", suite.update, batches, reset=suite.reset)

    # the same collection fused: one graph replay per batch
    fused_suite = _family_suite(tm)
    plan = _fresh_plan(fused_suite, batches)
    capture_s = _timed(lambda: [plan.update(*b) for b in batches])
    _require(len(plan._captured) == 1, f"families fused: {len(plan._captured)} graphs captured for one batch shape")
    plan.fold_back()
    _require_states_bitwise(fused_suite, expected, "families fused")
    _require_values_bitwise(fused_suite.compute(), values, "families fused")
    fused = _steady_and_profile("families fused", plan.update, batches)
    found, traces = fused["found"], 1
    while True:
        k2 = sum(n for key, (_, n) in found.items() if "stat_counts_kernel" in key)
        if k2 == NUM_BATCHES or traces == 3:  # the trace may drop launches: up to three traced passes
            break
        found, _, _ = _profile(lambda: [plan.update(*b) for b in batches], 1)
        traces += 1
    _require(k2 == NUM_BATCHES, f"families fused: the trace of a steady pass shows K2 {k2} times, expected {NUM_BATCHES}")
    fused_passes = _require_plan_passes(plan, fused_suite, expected, "families fused steady passes")

    # the confusion-matrix update alone, and torch.bincount on the same indices
    arg_sets = list(batches)
    index_sets = [(labels * c + torch.argmax(logits, dim=1).to(torch.int32),) for logits, labels in batches]
    for (logits, labels), (idx,) in zip(batches, index_sets):
        want = torch.bincount(idx, minlength=c * c).reshape(c, c).to(torch.int32)
        _require(torch.equal(_confmat_update(logits, labels), want), "families: the confusion-matrix update differs from torch.bincount")

    def library(idx):  # not capture-safe: it reads the indices' max on the host to size its output
        return torch.bincount(idx, minlength=c * c)

    times = _measure([("update", _confmat_update, arg_sets), ("library", library, index_sets)])
    per_call = sum(n for _, n in times["update"]["found"].values()) / PROFILE_REPS
    n_bytes = BATCH * c * 4 + BATCH * 4 + c * c * 4
    bound_ms, bound_by = _bound(n_bytes, BATCH * c)
    for tag, run in (("eager", eager), ("fused", fused)):
        print(
            f"[families] {tag} steady pass {run['median_s'] * 1e3:.3f} ms median, device {run['busy_us']:.1f} us in"
            f" {run['device_launches']} device kernels, busy share {run['busy_share']:.3f}; device us by kernel:"
            f" {'; '.join(f'{name} {t:.1f}/{n}' for name, t, n in run['top'])}"
        )
    print(
        f"[families] fused: K2 {k2} per pass in the trace; first fused pass (warm-up, capture, {NUM_BATCHES} replays)"
        f" {capture_s:.4f} s; states bitwise after {fused_passes} passes; the card's argmax and confusion matrix equal"
        f" the CPU's on the hard rows"
    )
    print(
        f"[families] confusion-matrix update alone (argmax, indices, capture-safe count), per batch of {BATCH}x{c}: device"
        f" {times['update']['device_ms']:.5f} ms in {per_call:.1f} device kernels ({per_call * NUM_BATCHES:.0f} per pass),"
        f" stream {times['update']['stream_ms']:.5f} ms; bound {bound_ms:.5f} ms ({bound_by}, {n_bytes} B); torch.bincount on"
        f" the same indices {times['library']['device_ms']:.5f} ms device, {times['library']['stream_ms']:.5f} ms stream"
    )
    for key, (t, n) in sorted(times["update"]["found"].items(), key=lambda kv: -kv[1][0])[:6]:
        print(f"[families]   update: {t / PROFILE_REPS:8.2f} us per call  {n / PROFILE_REPS:4.1f} launches per call  {key[:100]}")
    seconds = time.perf_counter() - t_phase
    print(f"[families] phase {seconds:.1f} s")
    return {
        "seconds": seconds,
        "eager": eager,
        "fused": fused,
        "launches": launches,
        "update_ms": times["update"]["device_ms"],
        "update_kernels": per_call,
        "bound_ms": bound_ms,
        "bincount_ms": times["library"]["device_ms"],
    }


# ---------------------------------------------------------------------- points

# the fixed-point curve families, each beside the binned AUROC on one grid:
# one compute group on the PR-curve state, K1 once per batch
POINT_CLASSES = {
    "rfp": ("MulticlassRecallAtFixedPrecision", "min_precision"),
    "pfr": ("MulticlassPrecisionAtFixedRecall", "min_recall"),
    "sas": ("MulticlassSensitivityAtSpecificity", "min_specificity"),
    "spas": ("MulticlassSpecificityAtSensitivity", "min_sensitivity"),
}
POINT_MIN = 0.5
# chosen values against a numpy float64 selection: one float32 division of
# counts (or 1 minus one) per value; the chosen thresholds must be equal
POINT_ATOL = 1e-6
# the exact mode on the card against the same state computed on the CPU, for
# every POINT_EXACT_STRIDE-th class (the CPU's curves of all 64 took most of the phase)
POINT_EXACT_ATOL = 1e-6
POINT_EXACT_STRIDE = 4


def _points_suite(tm, thresholds=THRESHOLDS, keys=tuple(POINT_CLASSES), auroc=True, device="cuda"):
    kw = {"num_classes": NUM_CLASSES, "thresholds": thresholds, "validate_args": False, "device": device}
    members = {"auroc": tm.MulticlassAUROC(average="macro", **kw)} if auroc else {}
    for key in keys:
        name, arg = POINT_CLASSES[key]
        members[key] = getattr(tm.classification, name)(**{arg: POINT_MIN}, **kw)
    return tm.MetricCollection(members, compute_groups=True)


def _numpy_point_reference(confmat, thresholds):
    """Per class ``(value, threshold)`` of each fixed-point family from the int32
    ``(T, C, 2, 2)`` state brought to the host: the rates in float64 and the
    selection rules written anew in numpy (the highest primary value, then the
    highest constraint, then the highest threshold for the PR-curve families;
    the first best in descending-threshold order for the ROC ones)."""
    import numpy as np

    s = confmat.cpu().numpy().astype(np.int64)  # [t, c, target, pred]
    thr = thresholds.cpu().numpy().astype(np.float64)
    tp, fp, fn, tn = s[..., 1, 1], s[..., 0, 1], s[..., 1, 0], s[..., 0, 0]

    def ratio(num, den):
        return np.where(den > 0, num / np.where(den > 0, den, 1), 0.0)

    precision, recall, fpr = ratio(tp, tp + fp), ratio(tp, tp + fn), ratio(fp, fp + tn)
    spec = 1.0 - fpr[::-1]
    cases = {
        "rfp": (recall, precision, thr, True),
        "pfr": (precision, recall, thr, True),
        "sas": (recall[::-1], spec, thr[::-1], False),
        "spas": (spec, recall[::-1], thr[::-1], False),
    }
    out = {}
    for key, (primary, constraint, grid, lex) in cases.items():
        vals, picks = np.zeros(primary.shape[1]), np.zeros(primary.shape[1])
        for c in range(primary.shape[1]):
            p, k = primary[:, c], constraint[:, c]
            ok = np.flatnonzero(k >= POINT_MIN)
            if not len(ok):
                vals[c], picks[c] = 0.0, 1e6
                continue
            if lex:
                best = ok[p[ok] == p[ok].max()]
                best = best[k[best] == k[best].max()]
                i = best[grid[best] == grid[best].max()][0]
                vals[c], picks[c] = p[i], (grid[i] if p[i] != 0 else 1e6)
            else:
                i = ok[np.argmax(p[ok])]
                vals[c], picks[c] = p[i], grid[i]
        out[key] = (vals, picks)
    return out


def _require_pairs_bitwise(got, want, what):
    import torch

    for k in want:
        for part, g, w in zip(("value", "threshold"), got[k], want[k]):
            g, w = g.cpu(), w.cpu()
            _require(g.dtype == w.dtype == torch.float32 and g.shape == w.shape, f"{what}: {k} {part} {g.dtype}{tuple(g.shape)}")
            _require(torch.equal(g.view(torch.int32), w.view(torch.int32)), f"{what}: {k} {part} {g.tolist()} vs {w.tolist()}")


def phase_points(device, batches, kernels, slice_run):
    """``MulticlassAUROC(thresholds=128)`` and the four fixed-point classes
    (``min_*=0.5``) over the slice's stream: one compute group, K1 once per
    batch eager and fused; the final state bitwise equal to the fold through
    K1's plain version; each per-class value and threshold bitwise equal to the
    port's CPU compute of the same state, and to a numpy float64 selection
    within POINT_ATOL (thresholds equal); the steady eager and fused passes
    profiled; the exact mode of two of the classes within POINT_EXACT_ATOL of
    the CPU."""
    import torch

    import torchmetrics_tpu_torch as tm

    t_phase = time.perf_counter()
    keys = sorted(["auroc", *POINT_CLASSES])
    suite = _points_suite(tm)
    suite.update(*batches[0])  # two updates form the compute group; then its leader alone updates
    suite.update(*batches[1])
    suite.reset()
    for wrapper in kernels.values():
        wrapper.launches = 0
    for logits, labels in batches:
        suite.update(logits, labels)
    torch.cuda.synchronize()
    launches = {name: wrapper.launches for name, wrapper in kernels.items()}
    _require(launches["binned_curve_state"] == NUM_BATCHES, f"points: K1 launched {launches['binned_curve_state']} times, expected {NUM_BATCHES}")
    groups = sorted(sorted(g) for g in suite.compute_groups.values())
    _require(groups == [keys], f"points: compute groups {groups}, expected one of {keys}")
    confmat = _plain_curve_state(batches, device)
    expected = {"auroc": {"confmat": confmat}}
    _require_states_bitwise(suite, expected, "points")

    t0 = time.perf_counter()
    values = suite.compute()
    torch.cuda.synchronize()
    compute_s = time.perf_counter() - t0
    _require(torch.equal(values["auroc"], slice_run["values"]["auroc"]), "points: the AUROC differs from the slice phase's on the same state")
    points = {k: values[k] for k in POINT_CLASSES}
    cpu = {}
    for key in POINT_CLASSES:
        name, arg = POINT_CLASSES[key]
        metric = getattr(tm.classification, name)(NUM_CLASSES, **{arg: POINT_MIN}, thresholds=THRESHOLDS, device="cpu")
        metric.load_state_tree({"confmat": suite[key].confmat.cpu(), "_update_count": NUM_BATCHES})
        cpu[key] = metric.compute()
    _require_pairs_bitwise(points, cpu, "points: card vs the CPU compute of the same state")
    ref = _numpy_point_reference(confmat, suite["auroc"].thresholds)
    errs = {}
    for key, (want_vals, want_thr) in ref.items():
        got_vals, got_thr = (x.cpu().double().numpy() for x in points[key])
        errs[key] = float(abs(got_vals - want_vals).max())
        _require(errs[key] <= POINT_ATOL, f"points: {key} values vs numpy float64: max |diff| {errs[key]}")
        _require((got_thr == want_thr).all(), f"points: {key} thresholds differ from numpy's at classes {list((got_thr != want_thr).nonzero()[0])}")

    def compute_once():
        for metric in suite.values(copy_state=False):
            metric._computed = None
        suite.compute()

    found, compute_us, _ = _profile(compute_once, 3)
    compute_kernels = sum(n for _, n in found.values()) / 3
    eager = _steady_and_profile("points", suite.update, batches, reset=suite.reset)

    fused_suite = _points_suite(tm)
    plan = _fresh_plan(fused_suite, batches)
    for wrapper in kernels.values():
        wrapper.launches = 0
    capture_s = _timed(lambda: [plan.update(*b) for b in batches])
    counted = kernels["binned_curve_state"].launches
    _require(counted == 2, f"points fused: K1's wrapper counted {counted} launches, expected 1 warm-up + 1 captured")
    _require(len(plan._captured) == 1, f"points fused: {len(plan._captured)} graphs captured for one batch shape")
    plan.fold_back()
    _require_states_bitwise(fused_suite, expected, "points fused")
    fused_values = fused_suite.compute()
    _require_pairs_bitwise({k: fused_values[k] for k in POINT_CLASSES}, points, "points fused vs eager")
    fused = _steady_and_profile("points fused", plan.update, batches)
    found_f, traces = fused["found"], 1
    while True:
        k1 = sum(n for key, (_, n) in found_f.items() if "binned_curve_state_kernel" in key)
        if k1 == NUM_BATCHES or traces == 3:  # the trace may drop launches: up to three traced passes
            break
        found_f, _, _ = _profile(lambda: [plan.update(*b) for b in batches], 1)
        traces += 1
    _require(k1 == NUM_BATCHES, f"points fused: the trace of a steady pass shows K1 {k1} times, expected {NUM_BATCHES}")
    fused_passes = _require_plan_passes(plan, fused_suite, expected, "points fused steady passes")

    binned_s = time.perf_counter() - t_phase
    # the exact mode (thresholds=None) of two of the classes: one compute group on the cat states
    t_exact = time.perf_counter()
    exact = _points_suite(tm, thresholds=None, keys=("rfp", "spas"), auroc=False)
    for logits, labels in batches:
        exact.update(logits, labels)
    exact_groups = sorted(sorted(g) for g in exact.compute_groups.values())
    _require(exact_groups == [["rfp", "spas"]], f"points exact: compute groups {exact_groups}")
    exact_values = exact.compute()
    torch.cuda.synchronize()
    exact_card_s = time.perf_counter() - t_exact
    # the CPU computes every fourth class: the same one-vs-rest curves, from
    # the same rows (a label outside the kept classes is negative for each)
    leader = exact["rfp"]
    kept = torch.arange(0, NUM_CLASSES, POINT_EXACT_STRIDE)
    labels = torch.cat(leader.target).cpu()
    remap = torch.full((NUM_CLASSES,), len(kept), dtype=labels.dtype)
    remap[kept] = torch.arange(len(kept), dtype=labels.dtype)
    state = {"preds": [torch.cat(leader.preds).cpu()[:, kept]], "target": [remap[labels]], "_update_count": NUM_BATCHES}
    t_cpu = time.perf_counter()
    exact_errs = {}
    for key in ("rfp", "spas"):
        name, arg = POINT_CLASSES[key]
        metric = getattr(tm.classification, name)(len(kept), **{arg: POINT_MIN}, validate_args=False, device="cpu")
        metric.load_state_tree(state)
        want = metric.compute()
        exact_errs[key] = max(float((g.cpu()[kept] - w).abs().max()) for g, w in zip(exact_values[key], want))
        _require(exact_errs[key] <= POINT_EXACT_ATOL, f"points exact: {key} card vs CPU max |diff| {exact_errs[key]}")
    exact_cpu_s = time.perf_counter() - t_cpu
    del exact, leader, state

    seconds = time.perf_counter() - t_phase
    summary = {k: (float(v[0].mean()), int((v[1] == 1e6).sum())) for k, v in points.items()}
    print(
        f"[points] launches over {NUM_BATCHES} batches {launches}; compute group {groups}; confmat bitwise equal to the"
        f" fold through K1's plain version; per-class values and thresholds bitwise equal to the CPU compute of the same"
        f" state; max |card - numpy float64| {errs} (budget {POINT_ATOL}), thresholds equal; mean value and sentinel"
        f" classes per family {summary}; AUROC equal to the slice phase's"
    )
    print(
        f"[points] compute (AUROC + 4 selections over {NUM_CLASSES} classes): first {compute_s * 1e3:.3f} ms wall, device"
        f" {compute_us / 3:.1f} us in {compute_kernels:.0f} device kernels"
    )
    for tag, run in (("eager", eager), ("fused", fused)):
        print(
            f"[points] {tag} steady pass {run['median_s'] * 1e3:.3f} ms median, device {run['busy_us']:.1f} us in"
            f" {run['device_launches']} device kernels, busy share {run['busy_share']:.3f}; device us by kernel:"
            f" {'; '.join(f'{name} {t:.1f}/{n}' for name, t, n in run['top'])}"
        )
    print(
        f"[points] fused: K1 {k1} per pass in the trace; first fused pass (warm-up, capture, {NUM_BATCHES} replays)"
        f" {capture_s:.4f} s; states bitwise after {fused_passes} passes; values bitwise equal to the eager compute"
    )
    print(
        f"[points] exact mode (thresholds=None) of RecallAtFixedPrecision and SpecificityAtSensitivity: one compute group,"
        f" updates and compute on the card {exact_card_s:.3f} s; max |card - CPU| over every {POINT_EXACT_STRIDE}th class"
        f" {exact_errs} (budget {POINT_EXACT_ATOL}; the CPU's compute {exact_cpu_s:.1f} s)"
    )
    print(f"[points] phase {seconds:.1f} s, of it the binned checks, profiles and fused plan {binned_s:.1f} s")
    return {"seconds": seconds, "launches": launches, "eager": eager, "fused": fused, "compute_us": compute_us / 3,
            "compute_kernels": compute_kernels, "k1_fused": k1}


# ---------------------------------------------------------------------- scores

SCORE_BINS = 15
FAIR_GROUPS = 8
# values against numpy float64 on the same probabilities: float32 sums over
# 524,288 rows (ECE divides two of them per bin; hinge, Dice and the ranking
# metrics are means); the fairness values are one division of counts
SCORE_ATOL = {"ece": 1e-4, "hinge": 1e-5, "dice": 1e-5, "ranking": 1e-5, "fair": 1e-6}
# the label-ranking AP update takes milliseconds: fewer calls per reading than the kernels' timing
SCORE_PROFILE_REPS, SCORE_TIMING_REPS = 10, 40


def _scores_suite(tm):
    cls, kw = tm.classification, {"validate_args": False, "device": "cuda"}
    return tm.MetricCollection(
        {
            "ece_l1": cls.MulticlassCalibrationError(NUM_CLASSES, n_bins=SCORE_BINS, norm="l1", **kw),
            "ece_l2": cls.MulticlassCalibrationError(NUM_CLASSES, n_bins=SCORE_BINS, norm="l2", **kw),
            "hinge_cs": cls.MulticlassHingeLoss(NUM_CLASSES, **kw),
            "hinge_ova": cls.MulticlassHingeLoss(NUM_CLASSES, multiclass_mode="one-vs-all", **kw),
            "dice": cls.Dice(num_classes=NUM_CLASSES, average="macro", device="cuda"),
        },
        compute_groups=True,
    )


def _ranking_suite(tm):
    cls, kw = tm.classification, {"ignore_index": -1, "validate_args": False, "device": "cuda"}
    return tm.MetricCollection(
        {
            "coverage": cls.MultilabelCoverageError(NUM_CLASSES, **kw),
            "rank_ap": cls.MultilabelRankingAveragePrecision(NUM_CLASSES, **kw),
            "rank_loss": cls.MultilabelRankingLoss(NUM_CLASSES, **kw),
        },
        compute_groups=True,
    )


def _fairness_suite(tm):
    cls, kw = tm.classification, {"validate_args": False, "device": "cuda"}
    return tm.MetricCollection(
        {"fair": cls.BinaryFairness(FAIR_GROUPS, **kw), "rates": cls.BinaryGroupStatRates(FAIR_GROUPS, **kw)}, compute_groups=True
    )


def _fairness_batches(device):
    """NUM_BATCHES binary (logits, targets, groups) batches of BATCH rows, made on the card from SEED + 5."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 5)
    batches = []
    for _ in range(NUM_BATCHES):
        logits = torch.randn((BATCH,), generator=gen, device=device, dtype=torch.float32)
        target = torch.randint(0, 2, (BATCH,), generator=gen, device=device, dtype=torch.int32)
        groups = torch.randint(0, FAIR_GROUPS, (BATCH,), generator=gen, device=device, dtype=torch.int32)
        batches.append((logits, target, groups))
    return batches


def _numpy_scores_reference(batches):
    """Calibration (15 bins), hinge (both modes) and Dice (macro) of the stream
    in numpy from the card's softmax brought to the host: the counts exactly
    (bins by the JAX grid's float32 edges), the values in float64."""
    import numpy as np
    import torch

    c = NUM_CLASSES
    edges = np.append(np.arange(SCORE_BINS, dtype=np.float32) * (np.float32(1) / np.float32(SCORE_BINS)), np.float32(1))
    count, conf_sum, acc_sum = np.zeros(SCORE_BINS, np.int64), np.zeros(SCORE_BINS), np.zeros(SCORE_BINS)
    hinge_cs, hinge_ova, rows = 0.0, np.zeros(c), 0
    tp, pred_n, label_n = np.zeros(c, np.int64), np.zeros(c, np.int64), np.zeros(c, np.int64)
    for logits, labels in batches:
        p = torch.softmax(logits, dim=1).cpu().numpy()
        y = labels.cpu().numpy().astype(np.int64)
        conf, pred = p.max(1), p.argmax(1)
        idx = np.clip(np.searchsorted(edges, conf, side="right") - 1, 0, SCORE_BINS - 1)
        count += np.bincount(idx, minlength=SCORE_BINS)
        conf_sum += np.bincount(idx, weights=conf.astype(np.float64), minlength=SCORE_BINS)
        acc_sum += np.bincount(idx, weights=(pred == y).astype(np.float64), minlength=SCORE_BINS)
        p64 = p.astype(np.float64)
        true = p64[np.arange(len(y)), y]
        other = np.where(np.eye(c, dtype=bool)[y], -np.inf, p64).max(1)
        hinge_cs += np.clip(1 - (true - other), 0, None).sum()
        hinge_ova += np.clip(1 - np.where(np.eye(c, dtype=bool)[y], p64, -p64), 0, None).sum(0)
        rows += len(y)
        tp += np.bincount(y[pred == y], minlength=c)
        pred_n += np.bincount(pred, minlength=c)
        label_n += np.bincount(y, minlength=c)
    prop = count / count.sum()
    gap = np.where(count > 0, acc_sum / np.maximum(count, 1) - conf_sum / np.maximum(count, 1), 0.0)
    fp, fn = pred_n - tp, label_n - tp
    support = (tp + fp + fn) > 0
    dice = np.where(support, 2 * tp / np.maximum(2 * tp + fp + fn, 1), 0.0)[support].mean()
    values = {
        "ece_l1": float(np.sum(np.abs(gap) * prop)),
        "ece_l2": float(np.sqrt(np.sum(gap**2 * prop))),
        "hinge_cs": hinge_cs / rows,
        "hinge_ova": hinge_ova / rows,
        "dice": float(dice),
    }
    counts = {"bin_count": count, "total": rows, "tp": tp, "fp": fp, "fn": fn}
    return counts, values


def _numpy_ranking_reference(ml_batches):
    """Coverage error, label-ranking AP and ranking loss of the multilabel stream
    (ignored entries irrelevant) in numpy from the card's sigmoid brought to the
    host: coverage's state folded as the port folds it (exact per-batch integer
    sums added in float32), AP and the loss in float64 from ranks by a stable sort."""
    import numpy as np
    import torch

    measure = np.float32(0)
    ap_sum = loss_sum = 0.0
    rows = 0
    for logits, target in ml_batches:
        p = torch.sigmoid(logits).cpu().numpy()
        rel = target.cpu().numpy() == 1
        n, c = p.shape
        offset = np.where(rel, 0.0, abs(float(p.min())) + 10).astype(np.float32)
        cover = (p >= (p + offset).min(1, keepdims=True)).sum(1)
        measure = np.float32(measure + np.float32(cover.sum()))
        # ranks within each row from one stable ascending argsort: a tie group
        # starts where the sorted value changes; the inverse permutation puts
        # each label's rank back in its column
        order = np.argsort(p, axis=1, kind="stable")
        ranked, rel_sorted = np.take_along_axis(p, order, 1), np.take_along_axis(rel, order, 1)
        pos = np.broadcast_to(np.arange(c), (n, c))
        first = np.maximum.accumulate(np.where(np.r_["1", np.ones((n, 1), bool), ranked[:, 1:] != ranked[:, :-1]], pos, 0), axis=1)
        rel_before = np.c_[np.zeros((n, 1), np.int64), np.cumsum(rel_sorted, axis=1)]  # relevant labels before each position
        n_rel = rel.sum(1)
        inverse = np.empty_like(order)
        np.put_along_axis(inverse, order, pos, axis=1)
        rank_all = np.take_along_axis(c - first, inverse, 1)  # #{k: p_k >= p_j}
        rank_rel = np.take_along_axis(n_rel[:, None] - np.take_along_axis(rel_before, first, 1), inverse, 1)
        per_row = np.where(rel, rank_rel / rank_all, 0.0).sum(1) / np.maximum(n_rel, 1)
        scored = (n_rel > 0) & (n_rel < c)
        ap_sum += np.where(scored, per_row, 1.0).sum()
        loss = (((c - inverse) * rel).sum(1) - 0.5 * n_rel * (n_rel + 1)) / np.maximum(n_rel * (c - n_rel), 1)
        loss_sum += np.where(scored, loss, 0.0).sum()
        rows += n
    values = {"coverage": float(measure) / rows, "rank_ap": ap_sum / rows, "rank_loss": loss_sum / rows}
    return {"measure": measure, "total": rows}, values


def _numpy_fairness_reference(fair_batches):
    """Per-group tp/fp/tn/fn of the binary stream (sigmoid > 0.5 from the card's
    sigmoid brought to the host), and the rates and ratios in float64."""
    import numpy as np
    import torch

    g = FAIR_GROUPS
    counts = np.zeros((g, 4), np.int64)  # tp, fp, tn, fn
    for logits, target, groups in fair_batches:
        pred = torch.sigmoid(logits).cpu().numpy() > 0.5
        y = target.cpu().numpy() == 1
        cell = np.where(pred & y, 0, np.where(pred & ~y, 1, np.where(~pred & ~y, 2, 3)))
        counts += np.bincount(groups.cpu().numpy().astype(np.int64) * 4 + cell, minlength=g * 4).reshape(g, 4)
    tp, fp, tn, fn = (counts[:, i].astype(np.float64) for i in range(4))
    pos_rate, tpr = (tp + fp) / (tp + fp + tn + fn), tp / (tp + fn)
    values = {f"group_{i}": counts[i] / max(counts[i].sum(), 1) for i in range(g)}
    for prefix, rates in (("DP", pos_rate), ("EO", tpr)):
        lo, hi = int(np.argmin(rates)), int(np.argmax(rates))
        values[f"{prefix}_{lo}_{hi}"] = rates[lo] / rates[hi]
    return {"tp": tp, "fp": fp, "tn": tn, "fn": fn}, values


def _require_suite_states_bitwise(got, want, what):
    """Every state of every member of ``got`` equal to ``want``'s, bit for bit
    (list states concatenated)."""
    import torch

    for key in want.keys(keep_base=True):
        a, b = got[key].state_tree(), want[key].state_tree()
        for name, w in b.items():
            g = a[name]
            if isinstance(w, list):
                g, w = torch.cat([torch.atleast_1d(v) for v in g]), torch.cat([torch.atleast_1d(v) for v in w])
            same = g.dtype == w.dtype and g.shape == w.shape and torch.equal(g.reshape(-1).view(torch.uint8), w.reshape(-1).view(torch.uint8))
            _require(same, f"{what}: state {key}.{name} differs")


def _require_close(got, want, atol, what):
    import numpy as np

    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = float(np.abs(g - w).max())
    _require(bool(np.isfinite(g).all()) and err <= atol, f"{what}: {g} vs numpy float64 {w} (max |diff| {err}, budget {atol})")
    return err


def _eager_and_fused(make, stream, what, **options):
    """``make()``'s collection over ``stream`` eagerly (after two updates form
    its compute groups) and through ``suite.fused(**options)``: the fused
    states bitwise equal to the eager ones. Returns the eager collection, its
    values and the fused plan's first pass time."""
    import torch

    eager = make()
    eager.update(*stream[0])
    eager.update(*stream[1])
    eager.reset()
    for batch in stream:
        eager.update(*batch)
    values = eager.compute()
    fused_suite = make()
    plan = _fresh_plan(fused_suite, stream, **options)
    first_s = _timed(lambda: [plan.update(*b) for b in stream])
    _require(len(plan._captured) == 1, f"{what} fused: {len(plan._captured)} graphs captured for one batch shape")
    plan.fold_back()
    torch.cuda.synchronize()
    _require_suite_states_bitwise(fused_suite, eager, f"{what}: fused vs eager")
    return eager, values, first_s


def phase_scores(device, batches, ml_batches, kernels):
    """Calibration error (15 bins, l1 and l2), hinge (Crammer-Singer and
    one-vs-all) and Dice (macro) over the slice's stream; the three ranking
    metrics over the multilabel stream; ``BinaryFairness`` and
    ``BinaryGroupStatRates`` over 8 binary batches with 8 seeded groups. Each
    collection eager and through ``suite.fused()`` (states bitwise equal); the
    count states bitwise equal to a numpy fold; values within SCORE_ATOL of
    numpy float64; the calibration and ranking updates timed beside their bound."""
    import numpy as np
    import torch

    import importlib

    import torchmetrics_tpu_torch as tm

    # by module path: the package also exports functions of these names
    ce = importlib.import_module("torchmetrics_tpu_torch.functional.classification.calibration_error")
    ranking = importlib.import_module("torchmetrics_tpu_torch.functional.classification.ranking")

    t_phase = time.perf_counter()
    fair_batches = _fairness_batches(device)
    for wrapper in kernels.values():
        wrapper.launches = 0
    scores, score_vals, scores_fused_s = _eager_and_fused(lambda: _scores_suite(tm), batches, "scores")
    ranks, rank_vals, ranks_fused_s = _eager_and_fused(lambda: _ranking_suite(tm), ml_batches, "ranking")
    fair, fair_vals, fair_fused_s = _eager_and_fused(lambda: _fairness_suite(tm), fair_batches, "fairness")
    card_s = time.perf_counter() - t_phase
    launches = {name: wrapper.launches for name, wrapper in kernels.items()}
    groups = {tag: sorted(sorted(g) for g in col.compute_groups.values()) for tag, col in (("scores", scores), ("ranking", ranks), ("fairness", fair))}
    _require(groups["scores"] == [["dice"], ["ece_l1", "ece_l2"], ["hinge_cs"], ["hinge_ova"]], f"scores: compute groups {groups['scores']}")
    _require(groups["fairness"] == [["fair", "rates"]], f"fairness: compute groups {groups['fairness']}")

    def require_count(col, key, name, want, what):
        """A count state equal to the numpy fold's, dtype included."""
        got, want = getattr(col[key], name).cpu().numpy(), np.asarray(want)
        _require(got.dtype == want.dtype and np.array_equal(got, want), f"{what}: {key}.{name} {got} vs the numpy fold's {want}")

    counts, ref = _numpy_scores_reference(batches)
    require_count(scores, "ece_l1", "bin_count", counts["bin_count"].astype(np.float32), "scores")
    for key in ("hinge_cs", "hinge_ova"):
        require_count(scores, key, "total", np.int32(counts["total"]), "scores")
    for name in ("tp", "fp", "fn"):
        require_count(scores, "dice", name, counts[name].astype(np.float32), "scores")
    errs = {}
    for key, want in ref.items():
        atol = SCORE_ATOL["ece" if key.startswith("ece") else key.split("_")[0]]
        errs[key] = _require_close(score_vals[key].cpu().numpy(), want, atol, f"scores: {key}")

    rank_counts, rank_ref = _numpy_ranking_reference(ml_batches)
    require_count(ranks, "coverage", "measure", rank_counts["measure"], "ranking")
    for key in ("coverage", "rank_ap", "rank_loss"):
        require_count(ranks, key, "total", np.float32(rank_counts["total"]), "ranking")
        errs[key] = _require_close(rank_vals[key].cpu().numpy(), rank_ref[key], SCORE_ATOL["ranking"], f"ranking: {key}")

    fair_counts, fair_ref = _numpy_fairness_reference(fair_batches)
    numpy_s = time.perf_counter() - t_phase - card_s
    for name, want in fair_counts.items():
        require_count(fair, "fair", name, want.astype(np.float32), "fairness")
    _require(sorted(fair_vals) == sorted(fair_ref), f"fairness: keys {sorted(fair_vals)} vs numpy {sorted(fair_ref)}")
    errs["fair"] = max(_require_close(fair_vals[k].cpu().numpy(), fair_ref[k], SCORE_ATOL["fair"], f"fairness: {k}") for k in fair_ref)

    # the calibration and ranking updates alone, as the modules run them, beside their bound
    def calibration_update(logits, labels):
        return ce._binning_update(*ce._multiclass_calibration_error_update(*ce._multiclass_calibration_error_format(logits, labels)), SCORE_BINS)

    def ranking_update(fn):
        return lambda logits, target: fn(*ranking._multilabel_ranking_format(logits, target, -1))

    paths = {
        "calibration": (calibration_update, batches, BATCH * NUM_CLASSES * 4 + BATCH * 4 + 3 * SCORE_BINS * 4, BATCH * NUM_CLASSES * 4),
        "coverage": (ranking_update(ranking._multilabel_coverage_error_update), ml_batches, BATCH * NUM_CLASSES * 8 + 8, BATCH * NUM_CLASSES * 4),
        "ranking_ap": (ranking_update(ranking._multilabel_ranking_average_precision_update), ml_batches, BATCH * NUM_CLASSES * 8 + 8,
                       2 * BATCH * NUM_CLASSES * NUM_CLASSES),
        "ranking_loss": (ranking_update(ranking._multilabel_ranking_loss_update), ml_batches, BATCH * NUM_CLASSES * 8 + 8,
                         BATCH * NUM_CLASSES * 14),
    }
    t_timing = time.perf_counter()
    times = _measure([(name, fn, stream) for name, (fn, stream, _, _) in paths.items()], SCORE_PROFILE_REPS, SCORE_TIMING_REPS)
    timing_s = time.perf_counter() - t_timing
    timed = {}
    for name, (_, _, n_bytes, n_ops) in paths.items():
        bound_ms, bound_by = _bound(n_bytes, n_ops)
        per_call = sum(n for _, n in times[name]["found"].values()) / SCORE_PROFILE_REPS
        timed[name] = {"ms": times[name]["device_ms"], "stream_ms": times[name]["stream_ms"], "bound_ms": bound_ms,
                       "bound_by": bound_by, "bytes": n_bytes, "kernels": per_call}
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t_phase
    print(
        f"[scores] hand-kernel launches {launches} (none of these families runs one); compute groups {groups}; fused"
        f" states bitwise equal to the eager ones for the three collections (first fused pass {scores_fused_s:.4f} /"
        f" {ranks_fused_s:.4f} / {fair_fused_s:.4f} s); bin_count, hinge totals, Dice tp/fp/fn, ranking totals and"
        f" coverage's measure and fairness tp/fp/tn/fn bitwise equal to the numpy folds"
    )
    vals = {k: (float(v) if v.numel() == 1 else f"mean {float(v.mean()):.6f}") for k, v in {**score_vals, **rank_vals}.items()}
    print(f"[scores] values {vals}; fairness {({k: float(v) for k, v in fair_vals.items() if not k.startswith('group_')})}")
    print(f"[scores] max |card - numpy float64| {errs} (budgets {SCORE_ATOL})")
    for name, t in timed.items():
        top = sorted(times[name]["found"].items(), key=lambda kv: -kv[1][0])[:4]
        print(
            f"[scores] {name} update per batch: device {t['ms']:.5f} ms in {t['kernels']:.1f} device kernels, stream"
            f" {t['stream_ms']:.5f} ms; bound {t['bound_ms']:.5f} ms ({t['bound_by']}, {t['bytes']} B); most device time:"
            f" {'; '.join(f'{_short_kernel_name(key)} {us / SCORE_PROFILE_REPS:.1f} us' for key, (us, _) in top)}"
        )
    print(
        f"[scores] phase {seconds:.1f} s: the collections eager and fused {card_s:.1f} s, the numpy references and"
        f" checks {numpy_s:.1f} s, the update timings {timing_s:.1f} s"
    )
    return {"seconds": seconds, "timed": timed, "errs": errs}


# ----------------------------------------------------------------- regression

REG_OUTPUTS = 8
REG_ROWS_WIDTH = NUM_CLASSES
MINKOWSKI_P = 3
TWEEDIE_POWER = 1.5
CSI_THRESHOLD = 0.5
RUNNING_WINDOW = 4
NAN_BATCH, NAN_STRIDE = 3, 997  # the aggregators' batch 3 holds a NaN every 997th sample
MIN_FILL, SUM_FILL, MEAN_FILL = 1e3, 0.5, 0.25  # the float imputations
# values against numpy/scipy float64 on the same host copies: float32 sums
# over 524,288 rows (R², RSE and explained variance subtract the squared
# mean from the mean square); the count states are held bitwise instead
REGRESSION_ATOL, REGRESSION_RTOL = 1e-4, 1e-4
# the port's CPU compute of the card's state against the card's, relative to
# max(|value|, 1): the same ops on the same state, ulps of the final
# sqrt/log/pow apart, and the cat states' sums added in another order
REGRESSION_CPU_RTOL = 1e-5
KENDALL_FLOAT_REL = 2.0**-20
REG_PROFILE_REPS, REG_TIMING_REPS = 10, 40
# the census takes tens of milliseconds per call: few calls per reading
CENSUS_PROFILE_REPS, CENSUS_TIMING_REPS = 2, 3


def _regression_streams(device, batches):
    """The slice's regression streams, made on the card from SEED + 8: the
    single-output (preds, target) in (0.05, 3.05) and its positive multiplicative
    noise, the (65536, 8) multi-output pair, and the rows (the slice's logits
    against a second seeded (65536, 64) tensor); the aggregators' per-sample
    squared error (NaNs in batch NAN_BATCH) and seeded weights in [0, 1)."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 8)
    single, multi, rows, agg, weighted = [], [], [], [], []
    for i in range(NUM_BATCHES):
        preds = torch.rand(BATCH, generator=gen, device=device) * 3 + 0.05
        target = preds * torch.exp(0.25 * torch.randn(BATCH, generator=gen, device=device))
        single.append((preds, target))
        mp = torch.randn((BATCH, REG_OUTPUTS), generator=gen, device=device)
        multi.append((mp, mp * torch.linspace(-1, 1, REG_OUTPUTS, device=device) + torch.randn((BATCH, REG_OUTPUTS), generator=gen, device=device)))
        rows.append((batches[i][0], torch.randn((BATCH, REG_ROWS_WIDTH), generator=gen, device=device)))
        sq = (preds - target) ** 2
        if i == NAN_BATCH:
            sq[::NAN_STRIDE] = float("nan")
        agg.append((sq,))
        weighted.append((sq, torch.rand(BATCH, generator=gen, device=device)))
    return single, multi, rows, agg, weighted


def _regression_single(tm):
    kw = {"device": "cuda"}
    return tm.MetricCollection({
        "mse": tm.MeanSquaredError(**kw), "mae": tm.MeanAbsoluteError(**kw), "msle": tm.MeanSquaredLogError(**kw),
        "mape": tm.MeanAbsolutePercentageError(**kw), "smape": tm.SymmetricMeanAbsolutePercentageError(**kw),
        "wmape": tm.WeightedMeanAbsolutePercentageError(**kw), "minkowski": tm.MinkowskiDistance(p=MINKOWSKI_P, **kw),
        "log_cosh": tm.LogCoshError(**kw), "tweedie": tm.TweedieDevianceScore(power=TWEEDIE_POWER, **kw),
        "rse": tm.RelativeSquaredError(**kw), "r2": tm.R2Score(**kw), "ev": tm.ExplainedVariance(**kw),
        "pearson": tm.PearsonCorrCoef(**kw), "ccc": tm.ConcordanceCorrCoef(**kw),
        "csi": tm.CriticalSuccessIndex(CSI_THRESHOLD, **kw),
    })


def _regression_collections(tm):
    """``(tag, make, stream key, fused options)`` of every collection of the
    phase. The aggregators' collections form no compute groups: two
    aggregators of one class but other NaN strategies hold equal states until
    the first NaN, and a group would fold them as one."""
    cap = NUM_BATCHES * BATCH
    kw = {"device": "cuda"}
    return [
        ("single", lambda: _regression_single(tm), "single", {}),
        ("spearman", lambda: tm.MetricCollection({"spearman": tm.SpearmanCorrCoef(**kw)}), "single", {"cat_capacity": cap}),
        ("multi", lambda: tm.MetricCollection({
            "mse": tm.MeanSquaredError(num_outputs=REG_OUTPUTS, **kw),
            "r2": tm.R2Score(num_outputs=REG_OUTPUTS, multioutput="raw_values", **kw),
            "pearson": tm.PearsonCorrCoef(num_outputs=REG_OUTPUTS, **kw),
        }), "multi", {}),
        ("cosine", lambda: tm.MetricCollection({"cosine": tm.CosineSimilarity(**kw)}), "rows", {"cat_capacity": cap}),
        ("kl", lambda: tm.MetricCollection({"kl": tm.KLDivergence(**kw)}), "softmax", {}),
        ("aggregators", lambda: tm.MetricCollection({
            "sum": tm.SumMetric(nan_strategy="ignore", **kw), "max": tm.MaxMetric(nan_strategy="ignore", **kw),
            "cat": tm.CatMetric(nan_strategy="ignore", **kw), "min_fill": tm.MinMetric(nan_strategy=MIN_FILL, **kw),
            "sum_fill": tm.SumMetric(nan_strategy=SUM_FILL, **kw),
        }, compute_groups=False), "agg", {"cat_capacity": cap}),
        ("weighted", lambda: tm.MetricCollection({
            "mean": tm.MeanMetric(nan_strategy="ignore", **kw), "mean_fill": tm.MeanMetric(nan_strategy=MEAN_FILL, **kw),
        }, compute_groups=False), "weighted", {}),
    ]


def _numpy_regression_reference(single, multi, rows_kl, agg, weighted):
    """Every value of the phase in float64 from host copies of the card's
    inputs, and the count states exactly."""
    import numpy as np
    from scipy.stats import spearmanr

    p = np.concatenate([b[0].cpu().numpy() for b in single]).astype(np.float64)
    t = np.concatenate([b[1].cpu().numpy() for b in single]).astype(np.float64)
    n = p.size
    d = p - t
    tss = ((t - t.mean()) ** 2).sum()
    k = TWEEDIE_POWER
    dev = 2 * (np.maximum(t, 0) ** (2 - k) / ((1 - k) * (2 - k)) - t * p ** (1 - k) / (1 - k) + p ** (2 - k) / (2 - k))
    pb, tb = p >= CSI_THRESHOLD, t >= CSI_THRESHOLD
    hits, misses, alarms = int((pb & tb).sum()), int((~pb & tb).sum()), int((pb & ~tb).sum())
    cov = ((p - p.mean()) * (t - t.mean())).sum() / (n - 1)
    vx, vy = p.var(ddof=1), t.var(ddof=1)
    values = {
        "single": {
            "mse": (d**2).mean(), "mae": np.abs(d).mean(), "msle": ((np.log1p(p) - np.log1p(t)) ** 2).mean(),
            "mape": (np.abs(d) / np.maximum(np.abs(t), 1.17e-6)).mean(),
            "smape": (2 * np.abs(d) / np.maximum(np.abs(t) + np.abs(p), 1.17e-6)).mean(),
            "wmape": np.abs(d).sum() / np.abs(t).sum(), "minkowski": (np.abs(d) ** MINKOWSKI_P).sum() ** (1 / MINKOWSKI_P),
            "log_cosh": np.log(np.cosh(d)).mean(), "tweedie": dev.mean(), "rse": (d**2).sum() / tss,
            "r2": 1 - (d**2).sum() / tss, "ev": 1 - np.var(t - p) / np.var(t), "pearson": cov / np.sqrt(vx * vy),
            "ccc": 2 * cov / (vx + vy + (p.mean() - t.mean()) ** 2), "csi": hits / (hits + misses + alarms),
        },
        "spearman": {"spearman": spearmanr(p, t).statistic},
    }
    mp = np.concatenate([b[0].cpu().numpy() for b in multi]).astype(np.float64)
    mt = np.concatenate([b[1].cpu().numpy() for b in multi]).astype(np.float64)
    mres = ((mt - mp) ** 2).sum(0)
    values["multi"] = {
        "mse": (mres / mp.shape[0]), "r2": 1 - mres / ((mt - mt.mean(0)) ** 2).sum(0),
        "pearson": np.array([np.corrcoef(mp[:, j], mt[:, j])[0, 1] for j in range(REG_OUTPUTS)]),
    }
    cos_sum = kl_sum = 0.0
    for x, y, px, qy in rows_kl:
        x64, y64 = x.cpu().numpy().astype(np.float64), y.cpu().numpy().astype(np.float64)
        cos_sum += ((x64 * y64).sum(1) / (np.linalg.norm(x64, axis=1) * np.linalg.norm(y64, axis=1))).sum()
        p64, q64 = px.cpu().numpy().astype(np.float64), qy.cpu().numpy().astype(np.float64)
        kl_sum += (p64 * np.log(p64 / q64)).sum()
    values["cosine"] = {"cosine": cos_sum}
    values["kl"] = {"kl": kl_sum / n}
    sq = np.concatenate([b[0].cpu().numpy() for b in agg])  # float32, NaNs in batch NAN_BATCH
    w = np.concatenate([b[1].cpu().numpy() for b in weighted]).astype(np.float64)
    nan = np.isnan(sq)
    ignored = np.where(nan, np.float32(0), sq)  # "ignore" zeroes the value (and its weight)
    values["aggregators"] = {
        "sum": ignored.astype(np.float64).sum(), "max": float(ignored.max()), "cat": ignored,
        "min_fill": float(np.where(nan, np.float32(MIN_FILL), sq).min()),
        "sum_fill": np.where(nan, SUM_FILL, sq.astype(np.float64)).sum(),
    }
    wi = np.where(nan, 0.0, w)
    values["weighted"] = {
        "mean": (ignored * wi).sum() / wi.sum(),
        "mean_fill": (np.where(nan, MEAN_FILL, sq.astype(np.float64)) * w).sum() / w.sum(),
    }
    last = slice((NUM_BATCHES - RUNNING_WINDOW) * BATCH, None)
    values["running"] = ignored[last].astype(np.float64).sum() / (~nan[last]).sum()
    counts = {"single.csi": (hits, misses, alarms), "rows": n}
    return values, counts


def _regression_timed_paths(single, rows_kl, cosine_state, spearman_state, kendall_rows):
    """``name -> (fn, arg sets, bytes, operations)`` of each plain update or
    compute timed per call, as the modules run them."""
    import importlib

    import torch

    fr = "torchmetrics_tpu_torch.functional.regression."
    mse = importlib.import_module(fr + "mse")
    pearson = importlib.import_module(fr + "pearson")
    kl = importlib.import_module(fr + "kl_divergence")
    cos = importlib.import_module(fr + "cosine_similarity")
    spear = importlib.import_module(fr + "spearman")
    kendall = importlib.import_module(fr + "kendall")

    zeros = tuple(torch.zeros(1, device=single[0][0].device) for _ in range(6))
    pairs = BATCH * (BATCH - 1) // 2
    n_all = NUM_BATCHES * BATCH
    return {
        "mse_update": (lambda p, t: mse._mean_squared_error_update(p, t, 1), single, 2 * BATCH * 4 + 4, 3 * BATCH),
        "pearson_update": (lambda p, t: pearson._pearson_corrcoef_update(p, t, *zeros, 1), single, 2 * BATCH * 4 + 12 * 4,
                           14 * BATCH),
        "kl_update": (lambda x, y, p, q: kl._kld_update(p, q, False), rows_kl, 2 * BATCH * REG_ROWS_WIDTH * 4 + BATCH * 4,
                      8 * BATCH * REG_ROWS_WIDTH),
        "cosine_compute": (lambda p, t: cos._cosine_similarity_compute(p, t, "sum"), [cosine_state],
                           2 * n_all * REG_ROWS_WIDTH * 4 + 4, 6 * n_all * REG_ROWS_WIDTH),
        "spearman_compute": (spear._spearman_corrcoef_compute, [spearman_state], 2 * n_all * 4 + 4,
                             2 * 2 * n_all * math.ceil(math.log2(n_all))),
        "kendall_census": (kendall._pair_census, [kendall_rows], 2 * BATCH * 4 + 8, 6 * pairs),
    }


def phase_regression(device, batches, kernels):
    """The regression and aggregation slice at full width: 8 batches of 65536
    samples made on the card (``_regression_streams``). Collections: the
    single-output family (MSE, MAE, MSLE, MAPE, SMAPE, WMAPE, Minkowski p=3,
    log-cosh, Tweedie 1.5, RSE, R², explained variance, Pearson, concordance,
    CSI at 0.5), Spearman over all 524,288 rows, the (65536, 8) multi-output
    MSE, raw R² and Pearson, cosine similarity and KL divergence over the
    (65536, 64) rows (the slice's logits against a second seeded tensor; their
    softmaxes for KL), the aggregators over the per-sample squared error
    (sum, max and cat with ``"ignore"``, which zeroes a NaN value as the JAX
    package does; min and sum with a float imputation) and the weighted means;
    ``RunningMean(window=4)`` eagerly; ``KendallRankCorrCoef(variant="b",
    t_test=True)`` over the first batch only (65,536 rows, 2.1e9 pairs, the
    int32 census: a cut, since an eager census over all 524,288 rows would
    write 512 blocks of 2.1 GB each), and one census over two batches (131,072
    rows, the float32 accumulator) within 2^-20 relative of the same blocks
    counted in int64 on the card. Each collection eager and through
    ``suite.fused()``, float states bitwise equal; the count states bitwise
    equal to numpy folds; values within REGRESSION_ATOL/RTOL of numpy float64
    (Spearman against ``scipy.stats.spearmanr``, Kendall against
    ``scipy.stats.kendalltau``); the port's CPU compute of each card state
    within REGRESSION_CPU_RTOL of the card's. The single-output family's
    steady eager and fused passes profiled; each plain update and compute
    timed beside its bound. No hand kernel runs here."""
    import importlib

    import numpy as np
    import torch
    from scipy.stats import kendalltau

    import torchmetrics_tpu_torch as tm

    t_phase = time.perf_counter()
    single, multi, rows, agg, weighted = _regression_streams(device, batches)
    rows_kl = [(x, y, torch.softmax(x, dim=1), torch.softmax(y, dim=1)) for x, y in rows]
    streams = {"single": single, "multi": multi, "rows": rows, "softmax": [(px, qy) for _, _, px, qy in rows_kl], "agg": agg,
               "weighted": weighted}
    for wrapper in kernels.values():
        wrapper.launches = 0
    runs = {}
    for tag, make, key, options in _regression_collections(tm):
        stream = streams[key]
        if options:
            options = dict(options, example_batch=stream[0])
        runs[tag] = _eager_and_fused(make, stream, f"regression {tag}", **options)
    launches = {name: wrapper.launches for name, wrapper in kernels.items()}
    _require(not any(launches.values()), f"regression: a hand kernel launched ({launches}); none is on this path")
    running = tm.RunningMean(window=RUNNING_WINDOW, nan_strategy="ignore", device="cuda")
    for (sq,) in agg:
        running.update(sq)
    running_value = running.compute()
    kendall = tm.KendallRankCorrCoef(variant="b", t_test=True, device="cuda")
    kendall.update(*single[0])
    tau, p_value = kendall.compute()
    census_mod = importlib.import_module("torchmetrics_tpu_torch.functional.regression.kendall")
    x2, y2 = torch.cat([single[0][0], single[1][0]]), torch.cat([single[0][1], single[1][1]])
    con, dis = census_mod._pair_census(x2, y2)
    exact = census_mod._census_counts(x2, y2).sum(0).tolist()
    _require(con.dtype == torch.float32, f"regression: the census of {x2.shape[0]} rows accumulated in {con.dtype}, not float32")
    float_rel = [abs(float(g) - w) / w for g, w in zip((con, dis), exact)]
    _require(max(float_rel) <= KENDALL_FLOAT_REL, f"regression: float32 census {float(con)}/{float(dis)} vs int64 {exact}")
    card_s = time.perf_counter() - t_phase

    values = {tag: runs[tag][1] for tag in runs}
    ref, counts = _numpy_regression_reference(single, multi, rows_kl, agg, weighted)
    errs = {}
    for tag, want_values in ref.items():
        if tag == "running":
            continue
        for key, want in want_values.items():
            got = values[tag][key].cpu().numpy()
            if key == "cat":
                _require(got.dtype == np.float32 and np.array_equal(got.view(np.uint32), want.view(np.uint32)),
                         "regression: CatMetric's rows differ from the host copy")
                continue
            atol = REGRESSION_ATOL + REGRESSION_RTOL * float(np.max(np.abs(want)))
            errs[f"{tag}.{key}"] = _require_close(got, want, atol, f"regression {tag}: {key}")
    errs["running"] = _require_close(running_value.cpu().numpy(), ref["running"], REGRESSION_ATOL, "regression: RunningMean")
    single_col = runs["single"][0]
    hits, misses, alarms = counts["single.csi"]
    for name, want in (("hits", hits), ("misses", misses), ("false_alarms", alarms)):
        got = getattr(single_col["csi"], name).cpu().numpy()
        _require(got.dtype == np.int32 and int(got) == want, f"regression: CSI {name} {got} vs the numpy fold's {want}")
    for key in ("mse", "mae", "msle", "log_cosh", "rse", "r2"):
        got = single_col[key].total.cpu().numpy()
        _require(got.dtype == np.int32 and int(got) == counts["rows"], f"regression: {key}.total {got} vs {counts['rows']}")
    got = single_col["tweedie"].num_observations.cpu().numpy()
    _require(got.dtype == np.int32 and int(got) == counts["rows"], f"regression: tweedie count {got}")
    for key in ("mse", "r2"):
        got = runs["multi"][0][key].total.cpu().numpy()
        _require(got.dtype == np.int32 and int(got) == counts["rows"], f"regression: multi {key}.total {got}")
    got = runs["kl"][0]["kl"].total.cpu().numpy()
    _require(got.dtype == np.int32 and int(got) == counts["rows"], f"regression: kl.total {got}")

    a = np.concatenate([b[0].cpu().numpy() for b in single[:1]]), np.concatenate([b[1].cpu().numpy() for b in single[:1]])
    ref_tau = kendalltau(a[0], a[1], variant="b")
    errs["kendall.tau"] = _require_close(tau.cpu().numpy(), ref_tau.statistic, 1e-5, "regression: Kendall tau-b")
    errs["kendall.p"] = _require_close(p_value.cpu().numpy(), ref_tau.pvalue, 1e-6, "regression: Kendall p-value")
    numpy_s = time.perf_counter() - t_phase - card_s

    # the port's CPU compute of every card state
    cpu_errs = {}
    for tag, make, _, _ in _regression_collections(tm):
        col = runs[tag][0]
        for key in col.keys(keep_base=True):
            card_metric = dict.__getitem__(col, key)
            cpu_metric = card_metric.clone().to("cpu")
            cpu_metric._computed = None
            got, want = cpu_metric.compute(), card_metric.compute()
            g, w = np.asarray(got, np.float64), want.cpu().numpy().astype(np.float64)
            err = float(np.max(np.abs(g - w) / np.maximum(np.abs(w), 1.0))) if w.size else 0.0
            _require(g.shape == w.shape and err <= REGRESSION_CPU_RTOL, f"regression: CPU compute of {tag}.{key} {g} vs the card's {w}")
            cpu_errs[f"{tag}.{key}"] = err
    cpu_kendall = kendall.clone().to("cpu")
    cpu_kendall._computed = None
    ctau, cp = cpu_kendall.compute()
    _require(abs(float(ctau) - float(tau)) <= 1e-6 * abs(float(tau)) and abs(float(cp) - float(p_value)) <= 1e-7,
             f"regression: Kendall on the CPU {float(ctau)}, {float(cp)} vs the card's {float(tau)}, {float(p_value)}")
    cpu_s = time.perf_counter() - t_phase - card_s - numpy_s

    # steady passes of the single-output family, eager and fused
    eager_suite = _regression_single(tm)
    eager_suite.update(*single[0])
    eager_suite.update(*single[1])
    eager = _steady_and_profile("regression eager", eager_suite.update, single, reset=eager_suite.reset)
    fused_suite = _regression_single(tm)
    plan = _fresh_plan(fused_suite, single)
    for b in single:
        plan.update(*b)
    fused = _steady_and_profile("regression fused", plan.update, single)

    spearman_metric = runs["spearman"][0]["spearman"]
    cosine_metric = runs["cosine"][0]["cosine"]
    spearman_state = (torch.cat(spearman_metric.preds), torch.cat(spearman_metric.target))
    cosine_state = (torch.cat(cosine_metric.preds), torch.cat(cosine_metric.target))
    paths = _regression_timed_paths(single, rows_kl, cosine_state, spearman_state, single[0])
    t_timing = time.perf_counter()
    reps = {name: (CENSUS_PROFILE_REPS, CENSUS_TIMING_REPS) if name == "kendall_census" else (REG_PROFILE_REPS, REG_TIMING_REPS)
            for name in paths}
    times = {}
    for profile_reps, timing_reps in sorted(set(reps.values())):
        versions = [(name, fn, stream) for name, (fn, stream, _, _) in paths.items() if reps[name] == (profile_reps, timing_reps)]
        times.update(_measure(versions, profile_reps, timing_reps))
    timing_s = time.perf_counter() - t_timing
    timed = {}
    for name, (_, _, n_bytes, n_ops) in paths.items():
        bound_ms, bound_by = _bound(n_bytes, n_ops)
        per_call = sum(n for _, n in times[name]["found"].values()) / reps[name][0]
        timed[name] = {"ms": times[name]["device_ms"], "stream_ms": times[name]["stream_ms"], "bound_ms": bound_ms,
                       "bound_by": bound_by, "bytes": n_bytes, "kernels": per_call}
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t_phase
    groups = {tag: sorted(sorted(g) for g in runs[tag][0].compute_groups.values()) for tag in runs}
    print(
        f"[regression] hand-kernel launches {launches} (none of these families runs one); compute groups {groups};"
        f" fused states bitwise equal to the eager ones for the {len(runs)} collections (first fused passes"
        f" {', '.join(f'{tag} {r[2]:.4f}' for tag, r in runs.items())} s); totals, CSI hits/misses/false alarms,"
        f" the cat rows bitwise equal to the numpy folds"
    )
    vals = {f"{tag}.{k}": (float(v) if v.numel() == 1 else f"mean {float(v.float().mean()):.6f}") for tag in values for k, v in values[tag].items()}
    print(f"[regression] values {vals}; RunningMean({RUNNING_WINDOW}) {float(running_value):.6f}; Kendall tau-b {float(tau):.6f}, p {float(p_value):.3e}")
    print(f"[regression] max |card - numpy/scipy float64| {errs} (budget {REGRESSION_ATOL} + {REGRESSION_RTOL} x |value|)")
    print(f"[regression] max relative |CPU compute - card compute| {max(cpu_errs.values()):.3e} over {len(cpu_errs)} metrics (budget {REGRESSION_CPU_RTOL})")
    print(
        f"[regression] float32 census of {x2.shape[0]} rows: {float(con):.0f} concordant, {float(dis):.0f} discordant;"
        f" int64 recount {exact}; relative {max(float_rel):.3e} (budget 2^-20)"
    )
    for name, t in timed.items():
        top = sorted(times[name]["found"].items(), key=lambda kv: -kv[1][0])[:4]
        print(
            f"[regression] {name} per call: device {t['ms']:.5f} ms in {t['kernels']:.1f} device kernels, stream"
            f" {t['stream_ms']:.5f} ms; bound {t['bound_ms']:.5f} ms ({t['bound_by']}, {t['bytes']} B); most device time:"
            f" {'; '.join(f'{_short_kernel_name(key)} {us / reps[name][0]:.1f} us' for key, (us, _) in top)}"
        )
    print(
        f"[regression] phase {seconds:.1f} s: the collections eager and fused and the censuses {card_s:.1f} s, the"
        f" numpy/scipy references {numpy_s:.1f} s, the CPU computes {cpu_s:.1f} s, the update timings {timing_s:.1f} s"
    )
    return {"seconds": seconds, "timed": timed, "eager": eager, "fused": fused, "errs": errs}


# ------------------------------------------------------------------- wrappers

WRAPPER_BOOTSTRAPS = 10
WRAPPER_QUANTILES = (0.05, 0.95)
WRAPPER_RTOL = 1e-6  # bootstrap mean/std/quantile against numpy float64 over the copies' values
MULTIOUTPUT_ATOL = 1e-6  # R² per output against a float64 numpy fold
WRAPPER_REPS = 5  # timed passes per wrapper and per bare metric (median)
TRACKER_STEPS = ((0, 3), (3, 5), (5, NUM_BATCHES))  # the batches of each MetricTracker increment
COPY_PROFILE_REPS, COPY_TIMING_REPS = 20, 50


def _draw_indices(rng, size, strategy):
    """A bootstrap copy's row indices, drawn as the JAX package draws them (an independent copy of the rule)."""
    import numpy as np

    if strategy == "poisson":
        return np.repeat(np.arange(size), rng.poisson(1, size=size))
    return rng.integers(0, size, size=size)


def _wrapper_streams(device):
    """The regression stream of the wrappers phase, made on the card from SEED + 9:
    NUM_BATCHES (preds, target) pairs of BATCH x REG_OUTPUTS float32, and one
    such pair with NaNs in some rows of two outputs (``MultioutputWrapper``)."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 9)
    reg = []
    for _ in range(NUM_BATCHES):
        p = torch.randn((BATCH, REG_OUTPUTS), generator=gen, device=device)
        reg.append((p, 0.8 * p + torch.randn((BATCH, REG_OUTPUTS), generator=gen, device=device)))
    p, t = (x.clone() for x in reg[0])
    p[::97, 3] = float("nan")
    t[5::89, 6] = float("nan")
    return reg, (p, t)


def _counts(kernels):
    import torch

    torch.cuda.synchronize()
    return {name: w.launches for name, w in kernels.items()}


def _zero(kernels):
    for w in kernels.values():
        w.launches = 0


def _traced_at_least(fn, kernels, want, tries=3):
    """Each hand kernel's launches in a profiler trace of ``fn()``; fails unless
    they reach ``want``. A trace that lost launches (torch.profiler on an H100
    was seen to drop some events of a long trace) is taken again, up to ``tries``."""
    best = {}
    for _ in range(tries):
        got = _kernel_launches_traced(fn, kernels)
        best = {name: max(best.get(name, 0), n) for name, n in got.items()}
        if all(best[name] >= n for name, n in want.items()):
            return best
    raise SmokeFailure(f"wrappers: hand-kernel launches in {tries} profiler traces {best}, expected at least {want}")


def _wrapper_pass(update, batches, reset):
    """Median wall time of WRAPPER_REPS passes of ``update`` over ``batches``
    (``reset`` before each), and one pass's device time, device kernels and
    hand-kernel launches from the profiler."""
    def one_pass():
        reset()
        for batch in batches:
            update(*batch)

    wall = statistics.median(_timed(one_pass) for _ in range(WRAPPER_REPS))
    found, busy_us, _ = _profile(one_pass, 1)
    hand = {name: sum(n for key, (_, n) in found.items() if f"{name}_kernel" in key) for name in ("binned_curve_state", "stat_counts")}
    return {"wall_ms": wall * 1e3, "device_ms": busy_us / 1e3, "kernels": sum(n for _, n in found.values()),
            "busy_share": busy_us / (wall * 1e6), "hand": hand}


def _require_metric_states_bitwise(got, want, what):
    """Every state of ``got`` bitwise ``want``'s (a sketch state leaf by leaf)."""
    import torch

    for name in want._defaults:
        g, w = getattr(got, name), getattr(want, name)
        for a, b in zip(g, w) if isinstance(w, tuple) else [(g, w)]:
            if b.dtype == torch.int32:
                _assert_bitwise(a, b, f"{what}.{name}")
            else:
                _require(a.dtype == b.dtype and torch.equal(a, b), f"{what}.{name}: {a} vs {b}")


def phase_wrappers(device, batches, kernels, smi):
    """The wrappers, metric arithmetic and compute-group repair at the main
    path's width (the slice's 8 batches of 65536 x 64 logits; regression
    wrappers on (65536, 8) float32 batches made on the card from SEED + 9).
    Each wrapper's launch counts are zeroed just before its stream and read
    just after; each check is exact unless it states a budget:

    - ``ClasswiseWrapper(MulticlassF1Score(64, average=None))``: K2 8 per
      pass; its dict equals the bare metric's vector element for element;
    - ``MinMaxMetric(MulticlassAUROC(64, thresholds=128))`` computed after
      every batch: K1 8; raw/min/max equal the bare metric's per-prefix
      values and their running min and max;
    - ``BootStrapper(MulticlassF1Score(64, "macro"), 10 copies, seed)``,
      poisson and multinomial: K2 80 per pass (also counted from the
      profiler); each copy's int32 states equal a bare metric fed
      ``batch[idx]``, ``idx`` drawn from an identical
      ``np.random.default_rng(SEED)``; mean/std/quantiles within
      WRAPPER_RTOL relative of numpy float64 over the copies' values;
    - ``(MulticlassF1Score + MulticlassAccuracy(macro)) / 2`` and
      ``1 - MulticlassAUROC``: equal the same arithmetic on the bare values;
    - ``MultitaskWrapper({"cls": headline suite, "reg": MeanSquaredError()})``
      and ``MetricTracker(headline suite)`` over 3 increments: states equal
      the bare suite's; ``best_metric`` equals numpy's argmax/argmin over
      ``compute_all()``;
    - ``MultioutputWrapper(R2Score(), 8, remove_nans=True)`` on a batch with
      NaN rows: within MULTIOUTPUT_ATOL of a float64 numpy fold;
    - a collection of ``MinMaxMetric(MulticlassAccuracy)`` and
      ``MinMaxMetric(MulticlassF1Score)``: no compute group forms, and each
      value equals the wrapper's alone.

    Then each wrapper's eager pass beside its bare metric's (device ms, wall
    ms, device kernels, busy share), and a bootstrap copy's cost (index
    upload, gather, update), each beside the card's name and power limit."""
    import numpy as np
    import torch

    import torchmetrics_tpu_torch as tm

    t_phase = time.perf_counter()
    c = NUM_CLASSES
    kw = {"device": "cuda"}
    reg, (nan_p, nan_t) = _wrapper_streams(device)
    launches, traced = {}, {}

    def f1(average="macro"):
        return tm.MulticlassF1Score(num_classes=c, average=average, **kw)

    def auroc():
        return tm.MulticlassAUROC(num_classes=c, thresholds=THRESHOLDS, **kw)

    # ClasswiseWrapper
    classwise = tm.ClasswiseWrapper(f1(None))
    _zero(kernels)
    for b in batches:
        classwise.update(*b)
    launches["classwise"] = _counts(kernels)
    _require(launches["classwise"] == {"binned_curve_state": 0, "stat_counts": NUM_BATCHES}, f"wrappers: classwise launches {launches['classwise']}")
    bare = f1(None)
    for b in batches:
        bare.update(*b)
    vec, labelled = bare.compute(), classwise.compute()
    _require(list(labelled) == [f"multiclassf1score_{i}" for i in range(c)], f"wrappers: classwise keys {list(labelled)[:3]}...")
    _require(all(torch.equal(labelled[f"multiclassf1score_{i}"], vec[i]) for i in range(c)), "wrappers: classwise values differ from the bare vector")

    # MinMaxMetric, computed after every batch
    minmax = tm.MinMaxMetric(auroc())
    _zero(kernels)
    outs = []
    for b in batches:
        minmax.update(*b)
        outs.append(minmax.compute())
    launches["minmax"] = _counts(kernels)
    _require(launches["minmax"] == {"binned_curve_state": NUM_BATCHES, "stat_counts": 0}, f"wrappers: minmax launches {launches['minmax']}")
    traced_minmax = tm.MinMaxMetric(auroc())
    traced["minmax"] = _traced_at_least(lambda: [(traced_minmax.update(*b), traced_minmax.compute()) for b in batches],
                                             kernels, {"binned_curve_state": NUM_BATCHES})
    bare, prefix = auroc(), []
    for b, out in zip(batches, outs):
        bare.update(*b)
        prefix.append(bare.compute())
        seen = torch.stack(prefix)
        _require(torch.equal(out["raw"], prefix[-1]) and torch.equal(out["max"], seen.max()) and torch.equal(out["min"], seen.min()),
                 f"wrappers: minmax after {len(prefix)} batches {out} vs the bare prefix values {seen.tolist()}")

    # BootStrapper, both sampling strategies
    boot_errs = {}
    quantiles = torch.tensor(WRAPPER_QUANTILES, device=device)
    for strategy in ("poisson", "multinomial"):
        boot = tm.BootStrapper(f1(), num_bootstraps=WRAPPER_BOOTSTRAPS, seed=SEED, sampling_strategy=strategy, quantile=quantiles)
        _zero(kernels)
        for b in batches:
            boot.update(*b)
        launches[f"bootstrap_{strategy}"] = got = _counts(kernels)
        _require(got == {"binned_curve_state": 0, "stat_counts": NUM_BATCHES * WRAPPER_BOOTSTRAPS}, f"wrappers: bootstrap {strategy} launches {got}")
        rng = np.random.default_rng(SEED)
        copies = [f1() for _ in range(WRAPPER_BOOTSTRAPS)]
        for logits, labels in batches:
            for copy in copies:
                idx = torch.from_numpy(_draw_indices(rng, BATCH, strategy)).to(device)
                copy.update(logits[idx], labels[idx])
        for i, (mine, ref) in enumerate(zip(boot.metrics, copies)):
            _require_metric_states_bitwise(mine, ref, f"wrappers: bootstrap {strategy} copy {i}")
        out = boot.compute()
        vals = np.array([float(m.compute()) for m in boot.metrics], np.float64)
        want = {"mean": vals.mean(), "std": vals.std(ddof=1), "quantile": np.quantile(vals, WRAPPER_QUANTILES)}
        for key, w in want.items():
            g = out[key].double().cpu().numpy()
            err = float(np.max(np.abs(g - w) / np.abs(w)))
            _require(err <= WRAPPER_RTOL, f"wrappers: bootstrap {strategy} {key} {g} vs numpy float64 {w} (relative {err:.3e})")
            boot_errs[f"{strategy}.{key}"] = err
        traced_boot = tm.BootStrapper(f1(), num_bootstraps=WRAPPER_BOOTSTRAPS, seed=SEED, sampling_strategy=strategy)
        traced[strategy] = _traced_at_least(lambda: [traced_boot.update(*b) for b in batches], kernels,
                                                 {"stat_counts": NUM_BATCHES * WRAPPER_BOOTSTRAPS})

    # metric arithmetic
    fa, aa = f1(), tm.MulticlassAccuracy(num_classes=c, average="macro", **kw)
    composed = (fa + aa) / 2
    complement = 1 - auroc()
    _zero(kernels)
    for b in batches:
        composed.update(*b)
    launches["composed"] = _counts(kernels)
    _zero(kernels)
    for b in batches:
        complement.update(*b)
    launches["complement"] = _counts(kernels)
    _require(launches["composed"]["stat_counts"] == 2 * NUM_BATCHES and launches["complement"]["binned_curve_state"] == NUM_BATCHES,
             f"wrappers: arithmetic launches {launches['composed']} / {launches['complement']}")
    bf, ba, bu = f1(), tm.MulticlassAccuracy(num_classes=c, average="macro", **kw), auroc()
    for b in batches:
        for m in (bf, ba, bu):
            m.update(*b)
    composed_value, complement_value = composed.compute(), complement.compute()
    _require(torch.equal(composed_value, (bf.compute() + ba.compute()) / 2), f"wrappers: (F1 + accuracy) / 2 = {composed_value}")
    _require(torch.equal(complement_value, 1 - bu.compute()), f"wrappers: 1 - AUROC = {complement_value}")

    # MultitaskWrapper and MetricTracker over the headline suite
    multitask = tm.MultitaskWrapper({"cls": _headline_suite(tm), "reg": tm.MeanSquaredError(**kw)})
    _zero(kernels)
    for (logits, labels), (rp, rt) in zip(batches, reg):
        multitask.update({"cls": logits, "reg": rp}, {"cls": labels, "reg": rt})
    launches["multitask"] = _counts(kernels)
    _require(launches["multitask"] == {"binned_curve_state": NUM_BATCHES, "stat_counts": NUM_BATCHES}, f"wrappers: multitask launches {launches['multitask']}")
    bare_suite, bare_mse = _headline_suite(tm), tm.MeanSquaredError(**kw)
    for b, r in zip(batches, reg):
        bare_suite.update(*b)
        bare_mse.update(*r)
    for key in ("acc", "f1", "auroc"):
        _require_metric_states_bitwise(multitask.task_metrics["cls"][key], bare_suite[key], f"wrappers: multitask cls.{key}")
    _require_metric_states_bitwise(multitask.task_metrics["reg"], bare_mse, "wrappers: multitask reg")
    task_values = multitask.compute()
    _require(torch.equal(task_values["reg"], bare_mse.compute()), "wrappers: multitask reg value")

    maximize = [True, False, True]  # acc, auroc, f1 (the collection's sorted keys): argmax, argmin, argmax
    tracker = tm.MetricTracker(_headline_suite(tm), maximize=maximize)
    _zero(kernels)
    for lo, hi in TRACKER_STEPS:
        tracker.increment()
        for b in batches[lo:hi]:
            tracker.update(*b)
    launches["tracker"] = _counts(kernels)
    _require(launches["tracker"] == {"binned_curve_state": NUM_BATCHES, "stat_counts": NUM_BATCHES}, f"wrappers: tracker launches {launches['tracker']}")
    last = _headline_suite(tm)
    for b in batches[TRACKER_STEPS[-1][0]:]:
        last.update(*b)
    for key in ("acc", "f1", "auroc"):
        _require_metric_states_bitwise(tracker._metrics[-1][key], last[key], f"wrappers: tracker last step {key}")
    history = {k: v.cpu().numpy() for k, v in tracker.compute_all().items()}
    best, step = tracker.best_metric(return_step=True)
    for (key, arr), up in zip(history.items(), maximize):
        want_step = int(np.argmax(arr)) if up else int(np.argmin(arr))
        _require(step[key] == want_step and best[key] == float(arr[want_step]), f"wrappers: tracker best {key} {best[key]}@{step[key]} vs numpy {arr}")

    # MultioutputWrapper dropping NaN rows
    multi = tm.MultioutputWrapper(tm.R2Score(**kw), num_outputs=REG_OUTPUTS, remove_nans=True)
    multi.update(nan_p, nan_t)
    r2 = multi.compute().double().cpu().numpy()
    hp, ht = nan_p.double().cpu().numpy(), nan_t.double().cpu().numpy()
    want_r2 = []
    for i in range(REG_OUTPUTS):
        keep = ~(np.isnan(hp[:, i]) | np.isnan(ht[:, i]))
        p_i, t_i = hp[keep, i], ht[keep, i]
        want_r2.append(1 - ((t_i - p_i) ** 2).sum() / ((t_i - t_i.mean()) ** 2).sum())
    multi_err = float(np.max(np.abs(r2 - np.array(want_r2))))
    _require(multi_err <= MULTIOUTPUT_ATOL, f"wrappers: multioutput R² {r2} vs numpy float64 {want_r2} (max {multi_err:.3e})")

    # the compute-group repair: two MinMaxMetric over different bases
    def pair():
        return {"acc": tm.MinMaxMetric(tm.MulticlassAccuracy(num_classes=c, average="micro", **kw)), "f1": tm.MinMaxMetric(f1())}

    col, alone = tm.MetricCollection(pair()), pair()
    for b in batches:
        col.update(*b)
        for m in alone.values():
            m.update(*b)
    groups = col.compute_groups
    _require(groups == {0: ["acc"], 1: ["f1"]}, f"wrappers: the MinMax collection formed compute groups {groups}")
    col_values = col.compute()
    for key, m in alone.items():
        for part, v in m.compute().items():
            _require(torch.equal(col_values[f"{key}_{part}"], v), f"wrappers: collection {key}_{part} differs from the wrapper alone")
    card_s = time.perf_counter() - t_phase

    # eager passes, each wrapper beside its bare metric
    def with_compute(m):
        def update(*b):
            m.update(*b)
            m.compute()
        return update

    timed_pairs = []
    cw, cb = tm.ClasswiseWrapper(f1(None)), f1(None)
    timed_pairs.append(("ClasswiseWrapper(F1 per class)", cw.update, cw.reset, cb.update, cb.reset, batches))
    mm, mb = tm.MinMaxMetric(auroc()), auroc()
    timed_pairs.append(("MinMaxMetric(AUROC), compute per batch", with_compute(mm), mm.reset, with_compute(mb), mb.reset, batches))
    for strategy in ("poisson", "multinomial"):
        bw, bb = tm.BootStrapper(f1(), num_bootstraps=WRAPPER_BOOTSTRAPS, seed=SEED, sampling_strategy=strategy), f1()
        timed_pairs.append((f"BootStrapper({WRAPPER_BOOTSTRAPS}, {strategy})", bw.update, bw.reset, bb.update, bb.reset, batches))
    cf, ca = f1(), tm.MulticlassAccuracy(num_classes=c, average="macro", **kw)
    comp = (cf + ca) / 2
    bf2, ba2 = f1(), tm.MulticlassAccuracy(num_classes=c, average="macro", **kw)

    def bare_two(*b):
        bf2.update(*b)
        ba2.update(*b)

    def reset_two():
        bf2.reset()
        ba2.reset()

    timed_pairs.append(("(F1 + accuracy) / 2", comp.update, comp.reset, bare_two, reset_two, batches))
    comp_auroc, bare_auroc = 1 - auroc(), auroc()
    timed_pairs.append(("1 - AUROC", comp_auroc.update, comp_auroc.reset, bare_auroc.update, bare_auroc.reset, batches))
    tracked, tracked_bare = tm.MetricTracker(_headline_suite(tm)), _headline_suite(tm)
    tracked.increment()
    for _ in range(2):  # let the suites' compute groups settle before timing
        tracked.update(*batches[0])
        tracked_bare.update(*batches[0])
    timed_pairs.append(("MetricTracker(suite), one step", tracked.update, tracked.reset, tracked_bare.update, tracked_bare.reset, batches))
    mtw, mts, mtr = (tm.MultitaskWrapper({"cls": _headline_suite(tm), "reg": tm.MeanSquaredError(**kw)}), _headline_suite(tm),
                     tm.MeanSquaredError(**kw))
    task_stream = [(lg, lb, rp, rt) for (lg, lb), (rp, rt) in zip(batches, reg)]

    def multitask_update(lg, lb, rp, rt):
        mtw.update({"cls": lg, "reg": rp}, {"cls": lb, "reg": rt})

    def bare_task(lg, lb, rp, rt):
        mts.update(lg, lb)
        mtr.update(rp, rt)

    def reset_task():
        mts.reset()
        mtr.reset()

    for _ in range(2):  # let the suites' compute groups settle before timing
        multitask_update(*task_stream[0])
        bare_task(*task_stream[0])
    timed_pairs.append(("MultitaskWrapper(suite, MSE)", multitask_update, mtw.reset, bare_task, reset_task, task_stream))
    mow, mob = tm.MultioutputWrapper(tm.R2Score(**kw), num_outputs=REG_OUTPUTS, remove_nans=True), tm.R2Score(
        num_outputs=REG_OUTPUTS, multioutput="raw_values", **kw)
    timed_pairs.append(("MultioutputWrapper(R², 8, remove_nans)", mow.update, mow.reset, mob.update, mob.reset, reg))
    timings = []
    for tag, w_update, w_reset, b_update, b_reset, stream in timed_pairs:
        timings.append((tag, _wrapper_pass(w_update, stream, w_reset), _wrapper_pass(b_update, stream, b_reset)))

    # a bootstrap copy's cost: index upload, gather, update (one batch of the stream)
    logits, labels = batches[0]
    idx_host = _draw_indices(np.random.default_rng(SEED), BATCH, "poisson")
    idx = torch.from_numpy(idx_host).to(device)
    copy = f1()
    gathered = (logits.index_select(0, idx), labels.index_select(0, idx))
    copy_costs = _measure([
        ("index upload", lambda: torch.from_numpy(idx_host).to(device), [()]),
        ("gather", lambda: (logits.index_select(0, idx), labels.index_select(0, idx)), [()]),
        ("update", lambda: copy.update(*gathered), [()]),
    ], COPY_PROFILE_REPS, COPY_TIMING_REPS)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t_phase

    print(f"[wrappers] hand-kernel launches per wrapper stream (counts zeroed before, read after): {launches}")
    print(
        f"[wrappers] hand-kernel launches in a profiler trace of a pass: MinMax {traced['minmax']} (K1 at least"
        f" {NUM_BATCHES}); BootStrapper poisson {traced['poisson']}, multinomial {traced['multinomial']} (K2 at least"
        f" {NUM_BATCHES * WRAPPER_BOOTSTRAPS})"
    )
    print(
        f"[wrappers] classwise dict == bare vector; minmax raw/min/max == the bare per-prefix values; bootstrap copies'"
        f" int32 states == bare metrics fed batch[idx]; mean/std/quantile relative to numpy float64 {boot_errs} (budget"
        f" {WRAPPER_RTOL}); (F1 + acc) / 2 = {float(composed_value):.6f} and 1 - AUROC = {float(complement_value):.6f} bitwise"
        f" equal to the bare arithmetic; multitask and tracker states == the bare suite's, tracker best {best} at {step};"
        f" multioutput R² max |card - numpy float64| {multi_err:.3e} (budget {MULTIOUTPUT_ATOL}); MinMax collection groups"
        f" {groups}, values == each wrapper alone"
    )
    for tag, w, b in timings:
        print(
            f"[wrappers] {tag}: eager pass of {NUM_BATCHES} batches device {w['device_ms']:.3f} ms, wall {w['wall_ms']:.3f} ms,"
            f" {w['kernels']} device kernels, busy share {w['busy_share']:.3f}, hand kernels {w['hand']}; bare metric device"
            f" {b['device_ms']:.3f} ms, wall {b['wall_ms']:.3f} ms, {b['kernels']} kernels, busy share {b['busy_share']:.3f},"
            f" hand kernels {b['hand']} (median of {WRAPPER_REPS}); {smi}"
        )
    print(
        f"[wrappers] one bootstrap copy per batch of {BATCH} rows ({idx.numel()} drawn): "
        + "; ".join(f"{k} device {v['device_ms']:.5f} ms, stream {v['stream_ms']:.5f} ms" for k, v in copy_costs.items())
        + f"; {smi}"
    )
    print(f"[wrappers] phase {seconds:.1f} s (the checks {card_s:.1f} s)")
    return {"seconds": seconds, "launches": launches, "traced": traced,
            "timings": {tag: (w, b) for tag, w, b in timings}, "copy": copy_costs}


# ---------------------------------------------------------------------- fused


def _fresh_plan(suite, batches, **options):
    """``suite.fused()`` after two eager updates (the compute groups form) and a reset, so the plan starts from zero states."""
    suite.update(*batches[0])
    suite.update(*batches[1])
    suite.reset()
    return suite.fused(**options)


def _require_values_bitwise(got, want, what):
    import torch

    _require(sorted(got) == sorted(want), f"{what}: value keys {sorted(got)} vs {sorted(want)}")
    for k in want:
        _require(torch.equal(got[k], want[k]), f"{what}: {k} {got[k].tolist()!r} vs unfused {want[k].tolist()!r}")


def _require_plan_passes(plan, suite, expected, what):
    """Fold ``plan`` back and hold ``suite``'s states bitwise against the plain
    fold times the number of whole passes the plan has applied (integer counts)."""
    applied = plan.updates_applied
    _require(applied % NUM_BATCHES == 0, f"{what}: {applied} updates applied, not whole passes of {NUM_BATCHES}")
    plan.fold_back()
    passes = applied // NUM_BATCHES
    _require_states_bitwise(suite, {k: {n: passes * v for n, v in st.items()} for k, st in expected.items()}, f"{what}, {passes} passes")
    return passes


def _timed(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def phase_fused(device, batches, kernels, slice_run, exact_run):
    """The headline suite through ``suite.fused()`` (one CUDA graph replay per
    batch): states bitwise equal to the unfused slice's fold and values to its
    ``compute()``; K1 and K2 launched once per batch inside the replays,
    counted from the profiler trace; the steady pass against the unfused one,
    in turns; one ``run_scan`` of the 8 batches, one ``run_stream`` from
    pinned host numpy batches, and the exact group fused with a CatBuffer of
    NUM_BATCHES * BATCH rows, its values equal to the unfused exact phase's."""
    import re

    import torch

    import torchmetrics_tpu_torch as tm

    expected = _expected_states_plain(batches, device)
    suite = _headline_suite(tm)
    plan = _fresh_plan(suite, batches)
    for wrapper in kernels.values():
        wrapper.launches = 0
    capture_s = _timed(lambda: plan.update(*batches[0]))  # warm-up, capture and the first replay
    rest_s = _timed(lambda: [plan.update(*b) for b in batches[1:]])
    launches = {name: wrapper.launches for name, wrapper in kernels.items()}
    print(
        f"[fused] first pass: wrapper counts {launches} (the warm-up step's launch and the capture's recorded one;"
        f" the {NUM_BATCHES} replays run without the wrappers); graphs captured {len(plan._captured)}"
    )
    for name, count in launches.items():
        _require(count == 2, f"fused: kernel {name}'s wrapper counted {count} launches, expected 1 warm-up + 1 captured")
    _require(len(plan._captured) == 1, f"fused: {len(plan._captured)} graphs captured for one batch shape")
    plan.fold_back()
    values = suite.compute()
    _require_states_bitwise(suite, expected, "fused")
    _require_values_bitwise(values, slice_run["values"], "fused")
    print("[fused] final states equal bitwise to the plain fold; values equal bitwise to the unfused compute()")

    # the steady fused pass; K1 and K2 in the replays, counted from the profiler trace
    steady = _steady_and_profile("fused", plan.update, batches)
    found, traces = steady["found"], 1
    while True:
        per_pass = {name: sum(n for key, (_, n) in found.items() if f"{name}_kernel" in key) for name in kernels}
        # torch.profiler on an H100 was seen to drop launches from a trace: up to three traced passes
        if all(n == NUM_BATCHES for n in per_pass.values()) or traces == 3:
            break
        found, _, _ = _profile(lambda: [plan.update(*b) for b in batches], 1)
        traces += 1
    print(f"[fused] hand-kernel launches per steady pass of {NUM_BATCHES} replays, from the profiler trace ({traces} traced): {per_pass}")
    for name, count in per_pass.items():
        _require(count == NUM_BATCHES, f"fused: the trace of a steady pass shows kernel {name} {count} times, expected {NUM_BATCHES}")
    _require(all(w.launches == 2 for w in kernels.values()), f"fused: a replay moved a wrapper's count {launches}")

    # no eager step: the host launched no kernel in a steady pass, only the graphs and the input copies
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for batch in batches:
            plan.update(*batch)
        torch.cuda.synchronize()
    host = {evt.key: evt.count for evt in prof.key_averages() if re.match(r"cu(da)?(GraphLaunch|LaunchKernel|MemcpyAsync)", evt.key)}
    print(f"[fused] host CUDA calls in a steady pass: {host}")
    _require(sum(n for k, n in host.items() if "GraphLaunch" in k) == NUM_BATCHES, f"fused: graph launches {host}")
    _require(not any(n for k, n in host.items() if "LaunchKernel" in k), f"fused: the host launched kernels itself {host}")

    # unfused and fused passes in turns, on the same batches
    unfused = _headline_suite(tm)
    unfused.update(*batches[0])
    unfused.update(*batches[1])
    turns = {"unfused": [], "fused": []}
    for _ in range(STEADY_PASSES):
        unfused.reset()
        turns["unfused"].append(_timed(lambda: [unfused.update(*b) for b in batches]))
        turns["fused"].append(_timed(lambda: [plan.update(*b) for b in batches]))
    medians = {k: statistics.median(v) for k, v in turns.items()}
    fused_passes = _require_plan_passes(plan, suite, expected, "fused steady passes")

    # run_scan: one graph over the stacked 8 batches
    scan_suite = _headline_suite(tm)
    scan_plan = _fresh_plan(scan_suite, batches)
    scan_first_s = _timed(lambda: scan_plan.run_scan(batches))
    scan_plan.fold_back()
    _require_states_bitwise(scan_suite, expected, "fused run_scan")
    _require_values_bitwise(scan_suite.compute(), slice_run["values"], "fused run_scan")
    stacked = scan_plan.stage(batches)
    scan_s = statistics.median(_timed(lambda: scan_plan.run_scan(stacked)) for _ in range(STEADY_PASSES))
    _require_plan_passes(scan_plan, scan_suite, expected, "fused run_scan")

    # run_stream: pinned host numpy batches through the DeviceFeed
    host_batches = []
    for logits, labels in batches:
        pl = torch.empty(logits.shape, dtype=logits.dtype, pin_memory=True)
        pt = torch.empty(labels.shape, dtype=labels.dtype, pin_memory=True)
        pl.copy_(logits)
        pt.copy_(labels)
        host_batches.append((pl.numpy(), pt.numpy()))
    stream_suite = _headline_suite(tm)
    stream_plan = _fresh_plan(stream_suite, batches)
    stream_first_s = _timed(lambda: stream_plan.run_stream(host_batches))
    stream_plan.fold_back()
    _require_states_bitwise(stream_suite, expected, "fused run_stream")
    _require_values_bitwise(stream_suite.compute(), slice_run["values"], "fused run_stream")
    stream_times = []
    for _ in range(3):  # every timed pass held against the plain fold
        stream_times.append(_timed(lambda: stream_plan.run_stream(host_batches)))
        _require_plan_passes(stream_plan, stream_suite, expected, "fused run_stream")
    stream_s = statistics.median(stream_times)

    def copies_alone():  # the same host batches to the card, one after another, with nothing else
        for pl, pt in host_batches:
            torch.from_numpy(pl).to(device, non_blocking=True)
            torch.from_numpy(pt).to(device, non_blocking=True)

    h2d_s = statistics.median(_timed(copies_alone) for _ in range(3))
    h2d_bytes = sum(pl.nbytes + pt.nbytes for pl, pt in host_batches)

    # validate_args=True: the value checks skip themselves under capture
    checked = _headline_suite(tm, validate_args=True)
    checked_plan = _fresh_plan(checked, batches)
    for batch in batches:
        checked_plan.update(*batch)
    checked_plan.fold_back()
    _require_states_bitwise(checked, expected, "fused, validate_args=True")

    # the exact group, its cat states in CatBuffers of NUM_BATCHES * BATCH rows
    exact = tm.MetricCollection(
        {
            "auroc": tm.MulticlassAUROC(num_classes=NUM_CLASSES, validate_args=False, device=device),
            "ap": tm.MulticlassAveragePrecision(num_classes=NUM_CLASSES, validate_args=False, device=device),
        },
        compute_groups=True,
    )
    exact_plan = _fresh_plan(exact, batches, cat_capacity=NUM_BATCHES * BATCH, example_batch=batches[0])
    exact_first_s = _timed(lambda: [exact_plan.update(*b) for b in batches])
    exact_plan.fold_back()
    exact_values = exact.compute()
    _require_values_bitwise(exact_values, exact_run["values"], "fused exact group")
    carry = exact_plan.state["members"][exact_plan._infos[0].key]["preds"]
    print(
        f"[fused] exact group (thresholds=None): CatBuffer {tuple(carry.data.shape)} {carry.data.dtype},"
        f" {carry.data.numel() * carry.data.element_size() / 1e6:.1f} MB; values {({k: float(v) for k, v in exact_values.items()})}"
        f" equal bitwise to the unfused exact phase's; first pass (layout probe, warm-up, capture, 8 replays) {exact_first_s:.4f} s"
    )

    samples = NUM_BATCHES * BATCH
    print(
        f"[fused] headline suite, {NUM_BATCHES}x{BATCH}x{NUM_CLASSES}: first update (warm-up + capture + replay) {capture_s:.4f} s,"
        f" then {NUM_BATCHES - 1} replays {rest_s:.4f} s; steady pass median of {STEADY_PASSES} {steady['median_s'] * 1e3:.3f} ms"
        f" = {samples / steady['median_s']:.1f} samples/s; busy share {steady['busy_share']:.3f}"
        f" ({steady['busy_us']:.1f} us device in {steady['device_launches']} device kernels per pass); host"
        f" {steady['host_calls']} Python calls per pass (unfused slice: {slice_run['host_calls']})"
    )
    print(
        f"[fused] in turns, {STEADY_PASSES} passes each: unfused median {medians['unfused'] * 1e3:.3f} ms"
        f" ({', '.join(f'{t * 1e3:.3f}' for t in turns['unfused'])}), fused median {medians['fused'] * 1e3:.3f} ms"
        f" ({', '.join(f'{t * 1e3:.3f}' for t in turns['fused'])}); ratio {medians['unfused'] / medians['fused']:.2f}"
    )
    print(
        f"[fused] run_scan of {NUM_BATCHES} batches: first {scan_first_s:.4f} s (stack, warm-up, capture, replay),"
        f" then {scan_s * 1e3:.3f} ms per replay (median of {STEADY_PASSES}); run_stream from pinned host numpy:"
        f" first {stream_first_s:.4f} s, then {stream_s * 1e3:.3f} ms per pass (median of 3), against {h2d_s * 1e3:.3f} ms"
        f" for the {h2d_bytes} bytes' host-to-device copies alone ({h2d_bytes / h2d_s / 1e9:.1f} GB/s); both states bitwise"
        f" equal to the plain fold, and after every timed pass to the plain fold times the passes applied"
        f" ({fused_passes} for the update plan); validate_args=True suite captured and equal"
    )
    return {
        **steady,
        "capture_s": capture_s,
        "turns": medians,
        "scan_ms": scan_s * 1e3,
        "stream_ms": stream_s * 1e3,
        "h2d_ms": h2d_s * 1e3,
        "per_pass": per_pass,
    }


# ---------------------------------------------------------------------- cache


def _first_update(drive):
    """``(CUDA-event ms, wall ms, capture records)`` of one call of ``drive``
    under tracing: for a first update, the warm-up, capture and first replay
    of a plan that captures, or one replay of a plan that adopted its entry."""
    import torch

    from torchmetrics_tpu_torch import obs

    before = len(obs.xla_records())
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    drive()
    end.record()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    return start.elapsed_time(end), wall_ms, len(obs.xla_records()) - before


def _cache_counters():
    from torchmetrics_tpu_torch import obs

    return {k: v for k, v in obs.snapshot()["counters"].items() if ".cache." in k}


def phase_cache(device, batches, smi):
    """The compiled-step cache: a fused plan, a sliced plan (256 cells) and a
    StreamingEvaluator drive rebuilt over the same target adopt the cached
    entry, so the rebuilt plan's first update is one replay (no capture
    record); the rebuilt plans' states bitwise equal to plans built with the
    cache cleared. See the module docstring, phase 29."""
    import torch

    import torchmetrics_tpu_torch as tm
    from torchmetrics_tpu_torch import obs
    from torchmetrics_tpu_torch.parallel.sharded import _SHARDED_FN_CACHE
    from torchmetrics_tpu_torch.robustness import StreamingEvaluator

    t_phase = time.perf_counter()
    out = {}
    keys = _suite_keys(device)
    kinds = {
        "fused": (lambda suite: _fresh_plan(suite, batches), lambda plan, i: plan.update(*batches[i])),
        "sliced": (lambda suite: suite.sliced(num_cells=SUITE_CELLS), lambda plan, i: plan.update(keys[i], *batches[i])),
    }

    def states(plan, suite, kind):
        if kind == "sliced":
            return plan.save_checkpoint()
        plan.fold_back()
        return suite

    for kind, (build, drive) in kinds.items():
        _SHARDED_FN_CACHE.clear()
        with obs.tracing():
            suite = _headline_suite(tm)
            plan = build(suite)
            first = _first_update(lambda: drive(plan, 0))
            for i in range(1, NUM_BATCHES):
                drive(plan, i)
            if kind == "fused":
                plan.fold_back()
            entry = plan._entry
            del plan  # dropped, as a runner drops its plan at the end of a drive
            suite.reset()
            plan = suite.sliced(num_cells=SUITE_CELLS) if kind == "sliced" else suite.fused()
            counters = _cache_counters()
            _require(plan._entry is entry and counters == {f"{kind}.cache.miss": 1, f"{kind}.cache.hit": 1},
                     f"cache {kind}: the rebuilt plan did not adopt the entry ({counters})")
            rebuilt = _first_update(lambda: drive(plan, 0))
            for i in range(1, NUM_BATCHES):
                drive(plan, i)
            got = states(plan, suite, kind)
        _require(first[2] == 1 and rebuilt[2] == 0, f"cache {kind}: capture records {first[2]} then {rebuilt[2]}, expected 1 then 0")
        _SHARDED_FN_CACHE.clear()
        ref_suite = _headline_suite(tm)
        ref_plan = build(ref_suite)
        for i in range(NUM_BATCHES):
            drive(ref_plan, i)
        want = states(ref_plan, ref_suite, kind)
        if kind == "sliced":
            _require_payloads_bitwise(got, want, "cache sliced: the rebuilt plan against one built with the cache cleared")
        else:
            _require_suite_states_bitwise(got, want, "cache fused: the rebuilt plan against one built with the cache cleared")
        out[kind] = {"first": first, "rebuilt": rebuilt, "counters": counters}
        print(
            f"[cache] {kind}: first update of the first plan (warm-up, capture, replay) {first[0]:.3f} ms by CUDA events,"
            f" {first[1]:.3f} ms wall, {first[2]} capture record; of the plan rebuilt over the same suite (the cached"
            f" entry adopted: one replay) {rebuilt[0]:.3f} ms / {rebuilt[1]:.3f} ms, {rebuilt[2]} capture records;"
            f" counters {counters}; states after {NUM_BATCHES} batches bitwise equal to a plan built with the cache"
            f" cleared; {smi}"
        )
        del plan, ref_plan, suite, ref_suite, got, want

    # two runner drives over one suite: the second drive's plan is served from the cache
    _SHARDED_FN_CACHE.clear()
    suite = _headline_suite(tm)
    drives = []
    with obs.tracing():
        for _ in range(2):
            ev = StreamingEvaluator(suite, fused=True)
            before = len(obs.xla_records())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            values = ev.run(batches)
            torch.cuda.synchronize()
            drives.append({"ms": (time.perf_counter() - t0) * 1e3, "records": len(obs.xla_records()) - before, "values": values})
        counters = _cache_counters()
    _require([d["records"] for d in drives] == [1, 0] and counters.get("fused.cache.hit") == 1,
             f"cache runner: capture records per drive {[d['records'] for d in drives]}, counters {counters}")
    ref = _headline_suite(tm)
    for _ in range(2):  # the same two drives (each continues the suite's state), the cache cleared before each
        _SHARDED_FN_CACHE.clear()
        ref_values = StreamingEvaluator(ref, fused=True).run(batches)
    _require_values_bitwise(drives[1]["values"], ref_values, "cache runner: the second drive against a cleared cache")
    _require_suite_states_bitwise(suite, ref, "cache runner: the second drive against a cleared cache")
    out["runner_ms"] = [d["ms"] for d in drives]
    print(
        f"[cache] StreamingEvaluator(fused=True): drive 1 {drives[0]['ms']:.3f} ms wall ({drives[0]['records']} capture"
        f" record), drive 2 over the same suite {drives[1]['ms']:.3f} ms ({drives[1]['records']} capture records,"
        f" fused.cache.hit {counters.get('fused.cache.hit')}); values and states bitwise equal to a drive with the"
        f" cache cleared; {smi}"
    )
    _SHARDED_FN_CACHE.clear()
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[cache] phase {out['seconds']:.1f} s")
    return out


# -------------------------------------------------------------------- durable

DURABLE_EVERY_N = 2
DURABLE_KILL_AFTER = 4  # the fault skips four hits: the run dies after batch 5, before any snapshot of it
DURABLE_WATCHDOG_S = 60.0
DURABLE_REPS = 3
DURABLE_CPU_ATOL = 1e-6  # the CPU compute of a card snapshot against the card's compute


def _durable_evaluator(tm, directory, every_n=DURABLE_EVERY_N, watchdog_s=DURABLE_WATCHDOG_S, **kw):
    from torchmetrics_tpu_torch.robustness import CheckpointStore, StreamingEvaluator

    return StreamingEvaluator(
        _headline_suite(tm),
        store=CheckpointStore(directory, keep_last=2),
        snapshot_every_n=every_n,
        watchdog_timeout_s=watchdog_s,
        **kw,
    )


def _kill(ev, batches, *extra):
    """Drive ``ev`` under the preemption after batch DURABLE_KILL_AFTER + 1 (and
    ``extra`` faults); it must die. Returns the exception's class name."""
    from torchmetrics_tpu_torch.robustness import faults

    with faults.inject(faults.Fault("preempt", "runner.preempt", after=DURABLE_KILL_AFTER, count=1), *extra):
        try:
            ev.run(batches)
        except (faults.SimulatedPreemption, faults.FaultInjected) as err:
            return type(err).__name__
    raise SmokeFailure("durable: the run outlived its injected preemption")


def _snapshot_parts(ev, directory, reps=DURABLE_REPS):
    """Median wall ms of each part of one snapshot of ``ev``'s state (fold-back
    where a fused plan is live, device-to-host copy into the checkpoint dict,
    pickle, CRC32, atomic write with fsync), over ``reps``; and the bytes."""
    import pickle

    import torch

    from torchmetrics_tpu_torch.robustness import store_format as fmt

    parts = {"fold_back": [], "d2h": [], "pickle": [], "crc": [], "write": []}
    for i in range(reps):
        t0 = time.perf_counter()
        if ev._fused_plan is not None:
            ev._fused_plan.fold_back()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        payload = {"payload_version": 1, "cursor": ev.cursor, "kind": ev._kind(), "checkpoint": ev._checkpoint()}
        t2 = time.perf_counter()
        data = pickle.dumps(payload, protocol=pickle.HIGHEST_PROTOCOL)
        t3 = time.perf_counter()
        fmt.payload_crc(data)
        t4 = time.perf_counter()
        path = os.path.join(directory, f"parts-{i}.ckpt")
        fmt.atomic_write(path, data)
        t5 = time.perf_counter()
        for key, (a, b) in zip(parts, ((t0, t1), (t1, t2), (t2, t3), (t3, t4), (t4, t5))):
            parts[key].append((b - a) * 1e3)
        n_bytes = len(data)
        os.unlink(path)
        del payload, data
    return {k: statistics.median(v) for k, v in parts.items()}, n_bytes


def phase_durable(device, batches, kernels, slice_run, exact_run, smi):
    """The headline suite through ``StreamingEvaluator`` + ``CheckpointStore``
    at full width: uninterrupted, killed and resumed, unfused and fused (the
    plan built and captured on the watchdog's worker thread); torn-write and
    bitrot drills; a card snapshot restored on the CPU; the fused drive's pass
    against ``snapshot_every_n``; the parts of one snapshot of the suite and of
    the exact group (272.6 MB). Works in a temporary directory it removes."""
    import shutil
    import tempfile
    import warnings

    import numpy as np
    import torch

    import torchmetrics_tpu_torch as tm
    from torchmetrics_tpu_torch.robustness import CheckpointStore, StreamingEvaluator, faults
    from torchmetrics_tpu_torch.robustness import store_format as fmt
    from torchmetrics_tpu_torch.utilities.exceptions import CheckpointStoreWarning

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke_durable_")
    try:
        expected = _expected_states_plain(batches, device)
        want_acc, want_f1 = _numpy_reference_values(batches)
        out = {}

        def check(ev, values, what):
            _require(ev.cursor == NUM_BATCHES, f"durable {what}: cursor {ev.cursor}")
            _require_states_bitwise(ev.metric, expected, f"durable {what}")
            _require_values_bitwise(values, slice_run["values"], f"durable {what}")
            _require(abs(float(values["acc"]) - want_acc) <= 1e-6 and abs(float(values["f1"]) - want_f1) <= 1e-5,
                     f"durable {what}: values {values} vs numpy {want_acc}, {want_f1}")

        # 1) uninterrupted runs, then kill-and-resume in a freshly built suite: unfused and fused
        for fused in (False, True):
            tag = "fused" if fused else "unfused"
            _zero(kernels)
            ev = _durable_evaluator(tm, os.path.join(root, f"{tag}-whole"), fused=fused)
            t0 = time.perf_counter()
            values = ev.run(batches)
            torch.cuda.synchronize()
            whole_s = time.perf_counter() - t0
            check(ev, values, f"{tag} uninterrupted run")
            whole = _counts(kernels)
            want_whole = 2 if fused else NUM_BATCHES  # fused: the warm-up's launch and the capture's recorded one
            _require(all(n == want_whole for n in whole.values()), f"durable {tag} run: wrapper counts {whole}")

            def kill_and_resume(directory):
                _zero(kernels)
                killed = _durable_evaluator(tm, directory, fused=fused)
                _require(_kill(killed, batches) == "SimulatedPreemption", f"durable {tag}: not preempted")
                _require(killed.store.steps() == [2, 4], f"durable {tag}: snapshots {killed.store.steps()} at the kill")
                before = _counts(kernels)
                replays_before = killed._fused_plan.updates_applied if fused else None
                _zero(kernels)
                resumed = _durable_evaluator(tm, directory, fused=fused)
                t0 = time.perf_counter()
                values = resumed.resume(batches)
                torch.cuda.synchronize()
                resume_s = time.perf_counter() - t0
                after = _counts(kernels)
                replays_after = resumed._fused_plan.updates_applied if fused else None
                return resumed, values, before, after, replays_before, replays_after, resume_s

            if not fused:
                resumed, values, before, after, _, _, resume_s = kill_and_resume(os.path.join(root, tag))
                check(resumed, values, f"{tag} kill and resume")
                total = {k: before[k] + after[k] for k in before}
                _require(all(n == NUM_BATCHES + 1 for n in total.values()),
                         f"durable {tag}: K1/K2 {before} before the kill + {after} after the resume, expected 5 + 4 each")
                out[tag] = {"before": before, "after": after, "resume_s": resume_s, "whole_s": whole_s}
                continue
            # fused: replays do not pass the wrappers; the profiler counts every device launch of the kernels
            from torch.profiler import ProfilerActivity, profile

            for attempt in range(3):
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    resumed, values, before, after, rep_b, rep_a, resume_s = kill_and_resume(os.path.join(root, f"{tag}{attempt}"))
                    torch.cuda.synchronize()
                traced = {n: sum(e.count for e in prof.key_averages() if f"{n}_kernel" in e.key) for n in kernels}
                # torch.profiler on an H100 was seen to drop launches from a trace
                if all(n == 2 + NUM_BATCHES + 1 for n in traced.values()):
                    break
            check(resumed, values, f"{tag} kill and resume")
            _require(all(before[k] == after[k] == 2 for k in before), f"durable fused: wrapper counts {before} / {after}")
            _require((rep_b, rep_a) == (DURABLE_KILL_AFTER + 1, NUM_BATCHES - DURABLE_KILL_AFTER),
                     f"durable fused: the plans applied {rep_b} and {rep_a} batches")
            _require(all(n == 2 + NUM_BATCHES + 1 for n in traced.values()),
                     f"durable fused: device launches of the kernels over kill and resume {traced}, expected 2 warm-ups + 9 replays")
            out[tag] = {"before": before, "after": after, "replays": (rep_b, rep_a), "traced": traced,
                        "attempts": attempt + 1, "resume_s": resume_s, "whole_s": whole_s}

        # 2) drills on the card's store: a torn save, then bitrot at rest
        directory = os.path.join(root, "torn")
        died = _kill(_durable_evaluator(tm, directory), batches, faults.Fault("fail", "store.write.torn", after=1, count=1))
        store = CheckpointStore(directory)
        torn = {"died": died, "steps": store.steps(), "debris": fmt.temp_files(directory)}
        _require(died == "FaultInjected" and torn["steps"] == [2] and torn["debris"], f"durable torn drill: {torn}")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            resumed = _durable_evaluator(tm, directory)
            check(resumed, resumed.resume(batches), "torn drill")
        _require(not [w for w in caught if issubclass(w.category, CheckpointStoreWarning)], "durable torn drill: a clean manifest warned")
        directory = os.path.join(root, "bitrot")
        _kill(_durable_evaluator(tm, directory), batches, faults.Fault("corrupt", "store.payload", after=1, arg=64))
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            resumed = _durable_evaluator(tm, directory)
            check(resumed, resumed.resume(batches), "bitrot drill")
        skipped = [str(w.message) for w in caught if issubclass(w.category, CheckpointStoreWarning)]
        _require(len(skipped) == 1 and "step 4" in skipped[0] and "CRC32" in skipped[0], f"durable bitrot drill: warnings {skipped}")
        out["bitrot_warning"] = skipped[0]

        # 3) the card's final snapshot restored into a device="cpu" suite
        cpu_suite = _headline_suite(tm, device="cpu")
        cursor = StreamingEvaluator(cpu_suite, store=CheckpointStore(os.path.join(root, "unfused"))).serve_open()
        _require(cursor == NUM_BATCHES, f"durable cpu restore: cursor {cursor}")
        for key, states in expected.items():
            for name, want in states.items():
                got = getattr(cpu_suite[key], name)
                _require(got.device.type == "cpu", f"durable cpu restore: {key}.{name} on {got.device}")
                _assert_bitwise(got.to(device), want, f"durable cpu restore: {key}.{name}")
        cpu_values = cpu_suite.compute()
        out["cpu_err"] = max(_require_close(cpu_values[k].numpy(), slice_run["values"][k].cpu().numpy(), DURABLE_CPU_ATOL,
                                            f"durable cpu restore: {k}") for k in cpu_values)

        # 4) the fused drive's steady pass against snapshot_every_n, in turns (serve_step: one plan per
        # evaluator), and without the watchdog's thread per batch
        cadences = {"none": (None, DURABLE_WATCHDOG_S), "every_8": (NUM_BATCHES, DURABLE_WATCHDOG_S),
                    "every_1": (1, DURABLE_WATCHDOG_S), "none_no_watchdog": (None, None)}
        evs = {}
        for label, (every_n, watchdog_s) in cadences.items():
            evs[label] = _durable_evaluator(tm, os.path.join(root, f"cadence-{label}"), every_n=every_n, watchdog_s=watchdog_s,
                                            fused=True)
            evs[label].serve_open()
            for batch in batches:  # the first pass builds and captures the plan
                evs[label].serve_step(batch)
        turns = {label: [] for label in cadences}
        for _ in range(DURABLE_REPS):
            for label, ev in evs.items():
                turns[label].append(_timed(lambda: [ev.serve_step(b) for b in batches]) * 1e3)
        found, busy_us, wall_us = _profile(lambda: [evs["every_1"].serve_step(b) for b in batches], 1)
        out["every_1_busy"] = (busy_us, wall_us)
        out["cadence_ms"] = {label: statistics.median(t) for label, t in turns.items()}
        out["cadence_turns"] = turns
        suite_parts, suite_bytes = _snapshot_parts(evs["every_8"], root)
        out["suite_parts"], out["suite_bytes"] = suite_parts, suite_bytes
        for label, ev in evs.items():
            passes = 1 + DURABLE_REPS + (2 if label == "every_1" else 0)  # _profile runs the pass twice
            ev.serve_close()
            _require(ev.cursor == passes * NUM_BATCHES, f"durable cadence {label}: cursor {ev.cursor}")
            _require_states_bitwise(ev.metric, {k: {n: passes * v for n, v in st.items()} for k, st in expected.items()},
                                    f"durable cadence {label}, {passes} passes")

        # 5) the exact group: one snapshot of 2 x 524,288 x 64 float32 preds + int32 targets, latest() and restore
        def exact_group():
            return tm.MetricCollection(
                {
                    "auroc": tm.MulticlassAUROC(num_classes=NUM_CLASSES, validate_args=False, device=device),
                    "ap": tm.MulticlassAveragePrecision(num_classes=NUM_CLASSES, validate_args=False, device=device),
                },
                compute_groups=True,
            )

        directory = os.path.join(root, "exact")
        ev = StreamingEvaluator(exact_group(), store=CheckpointStore(directory, keep_last=1), watchdog_timeout_s=DURABLE_WATCHDOG_S)
        t0 = time.perf_counter()
        exact_values = ev.run(batches)
        torch.cuda.synchronize()
        exact_run_s = time.perf_counter() - t0
        _require_values_bitwise(exact_values, exact_run["values"], "durable exact group")
        exact_parts, exact_bytes = _snapshot_parts(ev, root)
        state_bytes = 2 * NUM_BATCHES * BATCH * (NUM_CLASSES * 4 + 4)
        _require(exact_bytes >= state_bytes, f"durable exact snapshot {exact_bytes} B < its states' {state_bytes} B")
        del ev
        gc.collect()  # a metric's wrapped update refers to the metric: the run's states go with the cycle collector
        fresh = exact_group()
        restorer = StreamingEvaluator(fresh, store=CheckpointStore(directory, keep_last=1))
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        cursor = restorer._restore_latest()
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        peak, held = torch.cuda.max_memory_allocated(), torch.cuda.memory_allocated()
        _require(cursor == NUM_BATCHES, f"durable exact restore: cursor {cursor}")
        _require_values_bitwise(fresh.compute(), exact_run["values"], "durable exact group restored")
        out.update(exact_parts=exact_parts, exact_bytes=exact_bytes, exact_state_bytes=state_bytes, exact_run_s=exact_run_s,
                   exact_restore_s=restore_s, exact_peak_mib=(peak - base) / 2**20, exact_held_mib=(held - base) / 2**20,
                   exact_base_mib=base / 2**20)
        del fresh, restorer
        out["sketch"] = _durable_sketch(device, root)
        out["a10"] = _durable_a10(device, root, batches)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase

    un, fu = out["unfused"], out["fused"]
    print(
        f"[durable] StreamingEvaluator(CheckpointStore(keep_last=2), snapshot_every_n={DURABLE_EVERY_N},"
        f" watchdog_timeout_s={DURABLE_WATCHDOG_S:g}) over the headline suite, {NUM_BATCHES}x{BATCH}x{NUM_CLASSES}:"
        f" uninterrupted unfused {un['whole_s']:.3f} s, fused {fu['whole_s']:.3f} s; final int32 states bitwise equal to the"
        f" plain fold and values to the slice phase's compute()"
    )
    print(
        f"[durable] killed after batch {DURABLE_KILL_AFTER + 1} (snapshots 2 and 4 on disk), resumed in a fresh suite, bitwise equal:"
        f" unfused K1/K2 {un['before']} before the kill + {un['after']} after = {NUM_BATCHES + 1} each (batch 5 replayed),"
        f" resume {un['resume_s']:.3f} s; fused: wrapper counts {fu['before']} before and {fu['after']} after (each plan's"
        f" warm-up launch and captured one), the plans replayed {fu['replays'][0]} + {fu['replays'][1]} batches, device"
        f" launches in the trace {fu['traced']} (2 warm-ups + 9 replays; {fu['attempts']} trace(s)), resume {fu['resume_s']:.3f} s"
    )
    print(
        f"[durable] torn save at step 4: the run died ({torn['died']}), manifest steps {torn['steps']}, debris"
        f" {torn['debris']}, resume from step 2 without a warning, bitwise equal; bitrot at step 4: {out['bitrot_warning']!r},"
        f" resume from step 2, bitwise equal; the card's step-{NUM_BATCHES} snapshot restored into a device='cpu' suite:"
        f" states bitwise equal, compute() within {out['cpu_err']:.2e} of the card's (budget {DURABLE_CPU_ATOL})"
    )
    cad = out["cadence_ms"]
    busy_us, wall_us = out["every_1_busy"]
    print(
        f"[durable] fused drive, a steady pass of {NUM_BATCHES} serve_step() (watchdog thread per batch), median of"
        f" {DURABLE_REPS} in turns: snapshot_every_n=None {cad['none']:.3f} ms, 8 {cad['every_8']:.3f} ms, 1"
        f" {cad['every_1']:.3f} ms, None without the watchdog {cad['none_no_watchdog']:.3f} ms (passes"
        f" {out['cadence_turns']}); every 1: device busy {busy_us:.1f} us of the profiled"
        f" {wall_us:.1f} us = busy share {busy_us / wall_us:.4f}; {smi}"
    )
    sp, ep = out["suite_parts"], out["exact_parts"]
    print(
        f"[durable] one snapshot of the suite, {out['suite_bytes']} B pickled: fold_back {sp['fold_back']:.3f} ms,"
        f" device-to-host copy {sp['d2h']:.3f} ms, pickle {sp['pickle']:.3f} ms, CRC32 {sp['crc']:.3f} ms,"
        f" atomic_write + fsync {sp['write']:.3f} ms (medians of {DURABLE_REPS}); numpy {np.__version__}; {smi}"
    )
    print(
        f"[durable] the exact group (MulticlassAUROC + MulticlassAveragePrecision, {NUM_BATCHES * BATCH} rows, each member"
        f" its own copy): run with its final snapshot {out['exact_run_s']:.3f} s; one snapshot {out['exact_bytes']} B"
        f" ({out['exact_state_bytes']} B of states): device-to-host copy {ep['d2h']:.3f} ms, pickle {ep['pickle']:.3f} ms,"
        f" CRC32 {ep['crc']:.3f} ms, atomic_write + fsync {ep['write']:.3f} ms; latest() + validate + restore on the card"
        f" {out['exact_restore_s'] * 1e3:.3f} ms, peak device memory {out['exact_peak_mib']:.1f} MiB above the"
        f" {out['exact_base_mib']:.1f} MiB held before, {out['exact_held_mib']:.1f} MiB held after; values bitwise equal to the exact phase's; numpy {np.__version__}; {smi}"
    )
    print(
        f"[durable] sketch regime: a Quantile over {NUM_BATCHES} x {BATCH} values killed after batch {DURABLE_KILL_AFTER + 1}"
        f" ({out['sketch']['died']}) and resumed in {out['sketch']['resume_s']:.3f} s, bitwise equal to the uninterrupted run;"
        f" card checkpoints of the Quantile and of a {SKETCH_RESERVOIR}-slot reservoir restored into device='cpu' metrics"
        f" bitwise, the restored reservoir's next draw equal to the card's"
    )
    a10 = out["a10"]
    print(
        f"[durable] windowed regime: the headline suite with WindowRing(slots={WINDOW_SLOTS}, every_n={WINDOW_EVERY_N}) killed after batch"
        f" {DURABLE_KILL_AFTER + 1} ({a10['windowed_died']}) and resumed in {a10['windowed_resume_s']:.3f} s, the ring's payload and"
        f" query(last=1, 2, {WINDOW_SLOTS}) bitwise equal to the uninterrupted run; sliced regime: the fan-out SlicedPlan target"
        f" ({FANOUT_CELLS} cells, kind 'sliced') killed after batch {DURABLE_KILL_AFTER + 1} ({a10['sliced_died']}) and resumed in"
        f" {a10['sliced_resume_s']:.3f} s, its whole carry (table included) and compute_all bitwise equal to the uninterrupted run"
    )
    print(f"[durable] phase {out['seconds']:.1f} s")
    return out


def _durable_a10(device, root, batches):
    """The windowed and sliced regimes through ``StreamingEvaluator``: the
    headline suite with a ``WindowRing`` and the fan-out ``SlicedPlan`` target,
    each killed after batch DURABLE_KILL_AFTER + 1 and resumed in a fresh
    object graph, bitwise equal to the uninterrupted run (the ring's payload
    and queries; the plan's whole carry and ``compute_all``)."""
    import torch

    import torchmetrics_tpu_torch as tm
    from torchmetrics_tpu_torch.parallel import WindowRing
    from torchmetrics_tpu_torch.robustness import CheckpointStore, StreamingEvaluator

    out = {}

    def windowed():
        suite = _headline_suite(tm, device=device)
        return suite, WindowRing(suite, slots=WINDOW_SLOTS, every_n=WINDOW_EVERY_N)

    ref_suite, ref_ring = windowed()
    StreamingEvaluator(ref_suite, window_ring=ref_ring).run(batches)
    directory = os.path.join(root, "windowed")
    suite, ring = windowed()
    out["windowed_died"] = _kill(
        StreamingEvaluator(suite, store=CheckpointStore(directory, keep_last=2), snapshot_every_n=DURABLE_EVERY_N, window_ring=ring), batches
    )
    suite, ring = windowed()
    ev = StreamingEvaluator(suite, store=CheckpointStore(directory, keep_last=2), snapshot_every_n=DURABLE_EVERY_N, window_ring=ring)
    out["windowed_resume_s"] = _timed(lambda: ev.resume(batches))
    _require(ev.cursor == NUM_BATCHES and len(ring) == len(ref_ring) == WINDOW_SLOTS, f"durable windowed: cursor {ev.cursor}, {len(ring)} windows")
    _require_payloads_bitwise(ring.payload(), ref_ring.payload(), "durable windowed: the resumed ring")
    for k in (1, 2, WINDOW_SLOTS):
        _require_values_bitwise(ring.query(last=k), ref_ring.query(last=k), f"durable windowed: query(last={k})")

    keys, preds, target = _fanout_stream(device)
    fan_batches = [(keys[i], preds[i], target[i]) for i in range(NUM_BATCHES)]

    def plan():
        return tm.MulticlassAccuracy(num_classes=FANOUT_CLASSES, validate_args=False, device=device).sliced(num_cells=FANOUT_CELLS)

    ref_plan = plan()
    want = StreamingEvaluator(ref_plan).run(fan_batches)
    directory = os.path.join(root, "sliced")
    out["sliced_died"] = _kill(StreamingEvaluator(plan(), store=CheckpointStore(directory, keep_last=2), snapshot_every_n=DURABLE_EVERY_N), fan_batches)
    resumed = plan()
    ev = StreamingEvaluator(resumed, store=CheckpointStore(directory, keep_last=2), snapshot_every_n=DURABLE_EVERY_N)
    box = {}
    out["sliced_resume_s"] = _timed(lambda: box.update(got=ev.resume(fan_batches)))
    _require(ev.cursor == NUM_BATCHES and ev._kind() == "sliced", f"durable sliced: cursor {ev.cursor}")
    _require_payloads_bitwise(resumed.save_checkpoint(), ref_plan.save_checkpoint(), "durable sliced: the resumed carry")
    _require(torch.equal(box["got"]["MulticlassAccuracy"], want["MulticlassAccuracy"]), "durable sliced: compute_all")
    return out


def _durable_sketch(device, root):
    """The sketch regime through ``StreamingEvaluator``: a ``Quantile`` over the
    sketch phase's values, killed after batch DURABLE_KILL_AFTER + 1 and resumed
    in a fresh metric, bitwise equal to the uninterrupted run; card checkpoints
    of a ``Quantile`` and of a reservoir restored into ``device="cpu"``
    metrics, the reservoir then drawing the card's tags."""
    import torch

    import torchmetrics_tpu_torch as tm
    from torchmetrics_tpu_torch.robustness import CheckpointStore, StreamingEvaluator

    streams, _ = _sketch_streams(device)
    batches = [(v,) for v in streams["values"]]

    def make(dev=device):
        return tm.Quantile(q=list(SKETCH_QS), device=dev)

    whole = make()
    for b in batches:
        whole.update(*b)
    directory = os.path.join(root, "sketch")
    died = _kill(StreamingEvaluator(make(), store=CheckpointStore(directory, keep_last=2), snapshot_every_n=DURABLE_EVERY_N), batches)
    resumed = StreamingEvaluator(make(), store=CheckpointStore(directory, keep_last=2), snapshot_every_n=DURABLE_EVERY_N)
    t0 = time.perf_counter()
    values = resumed.resume(batches)
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t0
    _require(resumed.cursor == NUM_BATCHES, f"durable sketch: cursor {resumed.cursor}")
    _sketch_states_equal(resumed.metric, whole, "durable sketch resumed vs uninterrupted", bitwise=True)
    _require(torch.equal(values, whole.compute()), "durable sketch: the resumed value")
    sample = _sketch_holders()[1]
    res, res_cpu = sample(device=device), sample(device="cpu")
    for v in streams["values"][:4]:
        res.update(v)
    cpu_q = make("cpu")
    for src, dst in ((whole, cpu_q), (res, res_cpu)):
        dst.load_checkpoint(src.save_checkpoint())
        _sketch_states_equal(dst, src, f"durable sketch: {type(src).__name__} from the card on the CPU", bitwise=True)
    _require(torch.equal(cpu_q.compute(), whole.compute().cpu()), "durable sketch: the CPU Quantile's value")
    res.update(streams["values"][4])
    res_cpu.update(streams["values"][4].cpu())
    _sketch_states_equal(res_cpu, res, "durable sketch: the restored reservoir's next draw", bitwise=True)
    return {"died": died, "resume_s": resume_s}


# ----------------------------------------------------------------------- dist

DIST_WORLD = 2
DIST_TIMEOUT_S = 420  # the whole phase: both ranks' start, every check, every timing
DIST_REPS = 5


def _kernel_launches_traced(fn, names):
    """Launches of each hand kernel in a profiler trace of ``fn()``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {name: sum(e.count for e in prof.key_averages() if f"{name}_kernel" in e.key) for name in names}


def _median_timed(fn, reps=DIST_REPS):
    return statistics.median(_timed(fn) for _ in range(reps))


def _dist_rank(rank, world, addr, out_dir):
    """One rank of the dist phase: a gloo group of ``world`` ranks sharing
    ``cuda:0``. Raises on any failed check; the parent then exits non-zero."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=addr, world_size=world, rank=rank)
    try:
        result = _dist_checks(rank, world, out_dir)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(result, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _dist_checks(rank, world, out_dir):
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    import torchmetrics_tpu_torch as tm
    from torchmetrics_tpu_torch import obs
    from torchmetrics_tpu_torch.functional.classification.auroc import _multiclass_auroc_compute
    from torchmetrics_tpu_torch.functional.classification.average_precision import _multiclass_average_precision_compute
    from torchmetrics_tpu_torch.parallel import ShardedMetric
    from torchmetrics_tpu_torch.robustness import faults
    from torchmetrics_tpu_torch.utilities.distributed import _all_gather, all_reduce_, gather_all_objects
    from torchmetrics_tpu_torch.utilities.exceptions import SyncError

    KERNELS = _classification_kernels()

    device = torch.device("cuda", 0)
    want = torch.load(os.path.join(out_dir, "expected.pt"))
    want["slice_values"] = {k: v.to(device) for k, v in want["slice_values"].items()}
    want["exact_values"] = {k: v.to(device) for k, v in want["exact_values"].items()}
    batches = _main_path_batches(device)
    expected = _expected_states_plain(batches, device)
    out = {"rank": rank}

    # the collectives the port asks of gloo, on CUDA tensors (a refusal raises SyncError)
    taken = []
    for dtype in (torch.int32, torch.int64, torch.float32):
        x = torch.arange(4, device=device).to(dtype) + rank
        gathered = _all_gather(x, None)
        _require([int(g[0]) for g in gathered] == list(range(world)), f"all_gather of {dtype} on the card")
        taken.append(f"all_gather {dtype}")
        for op in ("SUM", "MAX", "MIN"):
            all_reduce_(x.clone(), getattr(dist.ReduceOp, op))
            taken.append(f"all_reduce {op} {dtype}")
    out["gloo_cuda_collectives"] = taken

    # 1) replica sync: each rank folds half the stream, compute() syncs
    suite = _headline_suite(tm)
    per_rank = NUM_BATCHES // world
    mine = batches[rank * per_rank : (rank + 1) * per_rank]
    for wrapper in KERNELS.values():
        wrapper.launches = 0
    for batch in mine:
        suite.update(*batch)
    torch.cuda.synchronize()
    launches = {name: w.launches for name, w in KERNELS.items()}
    _require(all(n == per_rank for n in launches.values()), f"rank {rank}: K1/K2 launches {launches}, expected {per_rank} each")
    out["sync_launches"] = launches
    values = suite.compute()
    _require_values_bitwise(values, want["slice_values"], f"rank {rank}: synced suite values")
    members = suite.values(copy_state=False)
    for m in members:
        m.sync()
    _require_states_bitwise(suite, expected, f"rank {rank}: synced suite")
    for m in members:
        m.unsync()
    state_bytes = sum(t.numel() * t.element_size() for m in members for t in m.state_tree().values())

    def compute_again():
        for m in members:
            m._computed = None
        suite.compute()

    def sync_alone():
        for m in members:
            m.sync()
        torch.cuda.synchronize()
        for m in members:
            m.unsync()

    out["suite_compute_ms"] = _median_timed(compute_again) * 1e3
    out["suite_sync_ms"] = _median_timed(sync_alone) * 1e3
    out["suite_state_bytes"] = state_bytes

    # 2) uneven cat gather: the exact group, 5 batches on rank 0 and 3 on rank 1
    c = NUM_CLASSES
    exact = tm.MetricCollection(
        {
            "auroc": tm.MulticlassAUROC(num_classes=c, validate_args=False, device=device),
            "ap": tm.MulticlassAveragePrecision(num_classes=c, validate_args=False, device=device),
        },
        compute_groups=True,
    )
    cut = 5
    for batch in (batches[:cut] if rank == 0 else batches[cut:]):
        exact.update(*batch)
    local_rows = (cut if rank == 0 else NUM_BATCHES - cut) * BATCH
    _require_values_bitwise(exact.compute(), want["exact_values"], f"rank {rank}: synced exact values")
    auroc = exact["auroc"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    auroc.sync()
    torch.cuda.synchronize()
    out["exact_gather_ms"] = (time.perf_counter() - t0) * 1e3
    state = auroc._curve_state()
    _require(state[0].shape == (NUM_BATCHES * BATCH, c), f"rank {rank}: gathered preds {tuple(state[0].shape)}")
    per_class = {"auroc": _multiclass_auroc_compute(state, c, None).cpu(), "ap": _multiclass_average_precision_compute(state, c, None).cpu()}
    for k, v in per_class.items():
        _require(torch.equal(v, want["exact_per_class"][k]), f"rank {rank}: synced per-class {k} differs from the exact phase's")
    auroc.unsync()
    held = sum(x.shape[0] for x in auroc.preds)
    _require(held == local_rows, f"rank {rank}: after unsync the exact state holds {held} rows, not {local_rows}")
    out["exact_rows"] = [local_rows, NUM_BATCHES * BATCH]
    del exact, auroc, state

    # 3) sharded update: every rank gets half the rows of every batch
    mesh = init_device_mesh("cuda", (world,), mesh_dim_names=("data",))
    rows = BATCH // world
    local = [tuple(x[rank * rows : (rank + 1) * rows] for x in batch) for batch in batches]
    sharded = _headline_suite(tm)
    wrapped = {key: ShardedMetric(m, mesh) for key, m in sharded.items(keep_base=True)}
    with obs.tracing():  # sharded_update's cache: one build per member, then hits
        for batch in local:
            for m in wrapped.values():
                m.update(*batch)
        cache_counters = _cache_counters()
        cold = [e["args"]["cold"] for e in obs.get_trace() if e["name"] == "sharded.update_step"]
    want_counters = {"sharded.cache.miss": len(wrapped), "sharded.cache.hit": len(wrapped) * (NUM_BATCHES - 1)}
    _require(cache_counters == want_counters and cold.count(True) == len(wrapped) and len(cold) == len(wrapped) * NUM_BATCHES,
             f"rank {rank}: sharded_update's cache counters {cache_counters}, cold spans {cold.count(True)} of {len(cold)}")
    out["sharded_cache"] = {"counters": cache_counters, "cold": cold.count(True), "steps": len(cold)}
    _require_states_bitwise(sharded, expected, f"rank {rank}: ShardedMetric")
    _require_values_bitwise(sharded.compute(), want["slice_values"], f"rank {rank}: ShardedMetric values")

    fused_suite = _headline_suite(tm)
    plan = _fresh_plan(fused_suite, local, mesh=mesh)
    for wrapper in KERNELS.values():
        wrapper.launches = 0
    first_s = _timed(lambda: [plan.update(*b) for b in local])
    counted = {name: w.launches for name, w in KERNELS.items()}
    _require(all(n == 2 for n in counted.values()), f"rank {rank}: sharded plan wrapper counts {counted}, expected warm-up + capture")
    traced = _kernel_launches_traced(lambda: [plan.update(*b) for b in local], KERNELS)
    _require(all(n == NUM_BATCHES for n in traced.values()), f"rank {rank}: sharded plan K1/K2 per pass in the trace {traced}")
    out["sharded_plan_launches_per_pass"] = traced
    passes = [_timed(lambda: [plan.update(*b) for b in local]) for _ in range(DIST_REPS)]
    out["sharded_pass_ms"] = statistics.median(passes) * 1e3
    out["sharded_first_pass_ms"] = first_s * 1e3
    applied = plan.updates_applied
    _require(applied == NUM_BATCHES * (2 + DIST_REPS), f"rank {rank}: {applied} sharded plan updates applied")
    plan.fold_back()
    n = applied // NUM_BATCHES
    _require_states_bitwise(fused_suite, {k: {s: n * v for s, v in st.items()} for k, st in expected.items()}, f"rank {rank}: sharded plan, {n} passes")

    # 5) wrappers under sharded_update against the replica regime, DIST_WRAPPER_EVENTS events of half batches
    out.update(_dist_wrapper_checks(rank, world, mesh, local, device))

    # 6) durable kill and resume: the replica regime (a store per rank) and the sharded fused one (rank 0 writes)
    out.update(_dist_durable_checks(rank, world, mesh, mine, local, out_dir, want, expected))

    # 8) the sliced mesh plan (two graphs around the collectives) against the local plan
    out.update(_dist_sliced_checks(rank, world, device, mesh))

    # 7) sketch states merge-synced across the ranks
    out.update(_dist_sketch_checks(rank, world, device))

    # 4) fault drill: a corrupt payload from rank 1 fails the object gather on both ranks, then heals
    faults.install_from_env("corrupt:gather_bytes.payload:rank=1:count=1")
    try:
        gather_all_objects(("drill", rank))
        raise SmokeFailure(f"rank {rank}: the corrupt object gather did not raise")
    except SyncError as err:
        _require("rank 1" in str(err) and "corrupt" in str(err), f"rank {rank}: SyncError {err}")
        out["drill_error"] = str(err)
    faults.clear()
    _require(gather_all_objects(("drill", rank)) == [("drill", r) for r in range(world)], f"rank {rank}: the healed gather")
    return out


def _dist_sliced_checks(rank, world, device, mesh):
    """The sliced mesh plan on two ranks: each passes its half of every
    fan-out batch (keys and rows; accuracy through K2s, exact AUROC's cat
    rows gathered), against the local plan over the whole batches, bitwise;
    both plans' passes timed."""
    import torch

    import torchmetrics_tpu_torch as tm
    from torchmetrics_tpu_torch.parallel import SlicedPlan

    keys, logits, target = _fanout_stream(device)
    preds = torch.softmax(logits, -1)  # probabilities: the exact member's rows are the inputs themselves
    half = FANOUT_BATCH // world
    mine = slice(rank * half, (rank + 1) * half)
    cap = 4 * NUM_BATCHES * FANOUT_BATCH // FANOUT_CELLS  # four times a cell's mean rows

    def suite():
        kw = dict(validate_args=False, device=device)
        return tm.MetricCollection(
            {"acc": tm.MulticlassAccuracy(num_classes=FANOUT_CLASSES, **kw),
             "exact": tm.MulticlassAUROC(num_classes=FANOUT_CLASSES, thresholds=None, **kw)},
            compute_groups=False,
        )

    p_mesh = SlicedPlan(suite(), num_cells=FANOUT_CELLS, mesh=mesh, cat_capacity=cap, example_batch=(preds[0, mine], target[0, mine]))
    p_local = SlicedPlan(suite(), num_cells=FANOUT_CELLS, cat_capacity=cap, example_batch=(preds[0], target[0]))
    for i in range(NUM_BATCHES):
        p_mesh.update(keys[i, mine], preds[i, mine], target[i, mine])
        p_local.update(keys[i], preds[i], target[i])
    _require_payloads_bitwise(p_mesh.save_checkpoint(), p_local.save_checkpoint(), f"rank {rank}: the sliced mesh plan vs the local plan")
    _require(len(p_mesh._sharded) == 1 and all(s.fold_graph is not None for s in p_mesh._sharded.values()),
             f"rank {rank}: the sliced mesh plan captured its two graphs")

    def mesh_pass():
        for i in range(NUM_BATCHES):
            p_mesh.update(keys[i, mine], preds[i, mine], target[i, mine])

    def local_pass():
        for i in range(NUM_BATCHES):
            p_local.update(keys[i], preds[i], target[i])

    return {"sliced_mesh_pass_ms": _median_timed(mesh_pass) * 1e3, "sliced_local_pass_ms": _median_timed(local_pass) * 1e3}


def _dist_sketch_checks(rank, world, device):
    """Two ranks merge-sync a ``Quantile``, a ``DriftScore`` and a
    ``HeavyHitters`` (its ``uint32`` keys travel as int32 bits), each rank
    folding its half of the sketch phase's batches: the synced state equals
    the one-rank merge of both halves (the reduction in rank order), and
    unsync restores the local state."""
    import torch

    import torchmetrics_tpu_torch as tm
    from torchmetrics_tpu_torch import drift
    from torchmetrics_tpu_torch import sketch as sk

    streams, reference = _sketch_streams(device)
    half = NUM_BATCHES // world
    makers = {
        "quantile": (lambda **kw: tm.Quantile(q=list(SKETCH_QS), **kw), "values"),
        "drift": (lambda **kw: drift.DriftScore(reference, bins=SKETCH_BINS, **kw), "drift"),
        "heavy": (lambda **kw: drift.HeavyHitters(**kw), "tags"),
    }
    out = {}
    for name, (make, key) in makers.items():
        synced = make(device=device)
        for i in range(rank * half, (rank + 1) * half):
            synced.update(streams[key][i])
        parts = []
        for r in range(world):
            part = make(device=device, distributed_available_fn=lambda: False)
            for i in range(r * half, (r + 1) * half):
                part.update(streams[key][i])
            parts.append(part)
        state = next(iter(synced._defaults))
        local_count = int(getattr(synced, state).count)
        want = sk.reduce_merge_states([getattr(p, state) for p in parts])
        sync_s = _timed(synced.sync)
        got = getattr(synced, state)
        for field, a, b in zip(got._fields, got, want):
            same = torch.equal(a, b) if a.dtype.is_floating_point else torch.equal(a.to(torch.int64), b.to(torch.int64))
            _require(same, f"rank {rank}: synced {name} {field} differs from the one-rank merge")
        synced.unsync()
        _require(int(getattr(synced, state).count) == local_count, f"rank {rank}: unsync of {name}")
        out[f"sketch_{name}_sync_ms"] = sync_s * 1e3
    return out


def _dist_durable_checks(rank, world, mesh, mine, local, out_dir, want, expected):
    """Kill-and-resume of the headline suite through ``StreamingEvaluator`` in
    both regimes: replica (``mine``, each rank's 4 whole batches, plain
    updates, a store directory per rank with ``write_rank=None``; killed after
    batch 3) and sharded fused (``local``, half the rows of all 8 batches,
    ``fused_options={"mesh": mesh}``, one store rank 0 alone writes; killed
    after batch 5). The resumed value must equal the slice phase's bitwise;
    the replica resume syncs at compute() and each rank writes only into its
    own directory; the sharded resume holds the plain fold's states on every
    rank, does not sync again, and rank 1 writes no file."""
    import torch
    import torch.distributed as dist

    import torchmetrics_tpu_torch as tm
    from torchmetrics_tpu_torch.robustness import CheckpointStore, StreamingEvaluator, faults
    from torchmetrics_tpu_torch.robustness import store_format as fmt

    regimes = {
        "replica": (mine, os.path.join(out_dir, f"durable_replica_rank{rank}"), None, {}, len(mine) // 2),
        "sharded": (local, os.path.join(out_dir, "durable_sharded"), 0, {"fused": True, "fused_options": {"mesh": mesh}}, DURABLE_KILL_AFTER),
    }
    out = {}
    written, syncs = [], []
    atomic_write, sync_dist = fmt.atomic_write, tm.Metric._sync_dist

    def recording_write(path, data):
        written.append(path)
        atomic_write(path, data)

    def counting_sync(self, *args, **kwargs):
        syncs.append(type(self).__name__)
        return sync_dist(self, *args, **kwargs)

    fmt.atomic_write, tm.Metric._sync_dist = recording_write, counting_sync
    try:
        for regime, (stream, directory, write_rank, kw, kill_after) in regimes.items():
            def evaluator():
                store = CheckpointStore(directory, keep_last=2, write_rank=write_rank)
                return StreamingEvaluator(_headline_suite(tm), store=store, snapshot_every_n=DURABLE_EVERY_N, **kw)

            written.clear()
            with faults.inject(faults.Fault("preempt", "runner.preempt", after=kill_after, count=1)):
                try:
                    evaluator().run(stream)
                    raise SmokeFailure(f"rank {rank}: the durable {regime} run outlived its preemption")
                except faults.SimulatedPreemption:
                    pass
            dist.barrier()  # rank 0's snapshots are on disk before any rank reads them
            syncs.clear()
            resumed = evaluator()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            values = resumed.resume(stream)
            torch.cuda.synchronize()
            out[f"durable_{regime}_resume_ms"] = (time.perf_counter() - t0) * 1e3
            _require(resumed.cursor == len(stream), f"rank {rank}: durable {regime} cursor {resumed.cursor}")
            _require_values_bitwise(values, want["slice_values"], f"rank {rank}: durable {regime} values")
            if regime == "replica":
                _require(bool(syncs), f"rank {rank}: the durable replica compute() did not sync")
                _require(written and all(os.path.dirname(p) == directory for p in written),
                         f"rank {rank}: durable replica writes {written}")
            else:
                _require(not syncs, f"rank {rank}: the durable sharded resume synced again {syncs}")
                _require_states_bitwise(resumed.metric, expected, f"rank {rank}: durable sharded")
                _require(bool(written) == (rank == 0), f"rank {rank}: durable sharded writes {written}")
            out[f"durable_{regime}_files"] = len(written)
            out[f"durable_{regime}_restored_from"] = (len(stream), kill_after)
    finally:
        fmt.atomic_write, tm.Metric._sync_dist = atomic_write, sync_dist
    return out


DIST_WRAPPER_EVENTS = 4
DIST_WRAPPER_RTOL = 1e-6
# the JAX package's reason (torchmetrics_tpu/wrappers/bootstrapping.py), which the port must give word for word
JAX_BOOTSTRAP_REASON = (
    "BootStrapper resamples with a host RNG per update; a traced sharded step "
    "would freeze the resample indices at trace time. Shard the wrapped metric "
    "instead, or run BootStrapper in the replica regime."
)


def _dist_wrapper_checks(rank, world, mesh, local, device):
    """``sharded_update`` of ``MinMaxMetric(MulticlassAUROC(64, thresholds=128))``
    (computed after every event) and of ``Running(MeanSquaredError(), window=3)``
    over DIST_WRAPPER_EVENTS events, each rank holding half the rows of every
    batch, against the replica regime (plain updates of the same halves, synced
    at compute): int32 states bitwise, float states and values within
    DIST_WRAPPER_RTOL; ``BootStrapper`` refused with the JAX package's reason.
    One sharded event of each wrapper and one replica update are timed."""
    import torch

    import torchmetrics_tpu_torch as tm
    from torchmetrics_tpu_torch.parallel import sharded_update

    KERNELS = _classification_kernels()

    rows = BATCH // world
    events = local[:DIST_WRAPPER_EVENTS]
    reg_events = [tuple(x[rank * rows : (rank + 1) * rows, 0] for x in r) for r in _wrapper_streams(device)[0][:DIST_WRAPPER_EVENTS]]
    out = {}

    def minmax():
        return tm.MinMaxMetric(tm.MulticlassAUROC(num_classes=NUM_CLASSES, thresholds=THRESHOLDS, device=device))

    def running():
        return tm.Running(tm.MeanSquaredError(device=device), window=3)

    def close(got, want, what):
        if want.dtype == torch.int32:
            _assert_bitwise(got, want, what)
            return 0.0
        err = float(((got - want).abs() / want.abs().clamp_min(1e-30)).max()) if want.numel() else 0.0
        _require(got.shape == want.shape and err <= DIST_WRAPPER_RTOL, f"{what}: {got} vs {want} (relative {err:.3e})")
        return err

    errs = {}
    sharded_mm, replica_mm = minmax(), minmax()
    for wrapper in KERNELS.values():
        wrapper.launches = 0
    for i, ev in enumerate(events):
        sharded_update(sharded_mm, mesh, *ev)
        got = sharded_mm.compute()
        replica_mm.update(*ev)
        want = replica_mm.compute()  # the child syncs at its compute()
        for k in want:
            errs[f"minmax.{i}.{k}"] = close(got[k], want[k], f"rank {rank}: sharded MinMax event {i} {k}")
    out["sharded_minmax_launches"] = {name: w.launches for name, w in KERNELS.items()}
    child = replica_mm._base_metric
    child.sync()
    for name in child._defaults:
        close(getattr(sharded_mm._base_metric, name), getattr(child, name), f"rank {rank}: sharded MinMax child {name}")
    child.unsync()
    for name in ("min_val", "max_val"):
        errs[f"minmax.{name}"] = close(getattr(sharded_mm, name), getattr(replica_mm, name), f"rank {rank}: sharded MinMax {name}")

    sharded_run, replica_run = running(), running()
    for ev in reg_events:
        sharded_update(sharded_run, mesh, *ev)
        replica_run.update(*ev)
    errs["running.value"] = close(sharded_run.compute(), replica_run.compute(), f"rank {rank}: sharded Running value")
    replica_run.sync()
    for name in replica_run._defaults:
        errs[f"running.{name}"] = close(getattr(sharded_run, name), getattr(replica_run, name), f"rank {rank}: sharded Running {name}")
    replica_run.unsync()
    _require(sharded_run._num_vals_seen == DIST_WRAPPER_EVENTS, f"rank {rank}: sharded Running saw {sharded_run._num_vals_seen} events")
    out["sharded_wrapper_errs"] = max(errs.values())

    boot = tm.BootStrapper(tm.MulticlassF1Score(num_classes=NUM_CLASSES, device=device), num_bootstraps=2)
    try:
        sharded_update(boot, mesh, *events[0])
        raise SmokeFailure(f"rank {rank}: sharded_update took a BootStrapper")
    except ValueError as err:
        _require(str(err) == f"BootStrapper does not support sharded_update: {JAX_BOOTSTRAP_REASON}", f"rank {rank}: refusal {err}")
        out["bootstrap_refusal"] = str(err)

    timed_mm, timed_run, timed_replica = minmax(), running(), minmax()
    out["sharded_minmax_event_ms"] = _median_timed(lambda: sharded_update(timed_mm, mesh, *events[0])) * 1e3
    out["sharded_running_event_ms"] = _median_timed(lambda: sharded_update(timed_run, mesh, *reg_events[0])) * 1e3
    out["replica_minmax_update_ms"] = _median_timed(lambda: timed_replica.update(*events[0])) * 1e3
    return out


def phase_dist(slice_run, exact_run, fused_run, smi):
    """Two gloo ranks on ``cuda:0`` (spawned, ``_dist_rank``): replica sync of
    the headline suite, the exact group's uneven cat gather, the sharded
    update and sharded fused plan, and a corrupt-payload drill. A rank that
    fails or outlives DIST_TIMEOUT_S fails the phase; its processes are killed."""
    import shutil
    import socket
    import tempfile

    import torch
    import torch.multiprocessing as mp

    out_dir = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    torch.save(
        {
            "slice_values": {k: v.cpu() for k, v in slice_run["values"].items()},
            "exact_values": {k: v.cpu() for k, v in exact_run["values"].items()},
            "exact_per_class": exact_run["per_class"],
        },
        os.path.join(out_dir, "expected.pt"),
    )
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        addr = f"tcp://127.0.0.1:{sock.getsockname()[1]}"
    t0 = time.perf_counter()
    ctx = mp.start_processes(_dist_rank, args=(DIST_WORLD, addr, out_dir), nprocs=DIST_WORLD, join=False, start_method="spawn")
    try:
        while not ctx.join(timeout=5):
            if time.perf_counter() - t0 > DIST_TIMEOUT_S:
                raise SmokeFailure(f"dist: the ranks outlived {DIST_TIMEOUT_S} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
                proc.join()
    seconds = time.perf_counter() - t0
    ranks = []
    for rank in range(DIST_WORLD):
        with open(os.path.join(out_dir, f"rank{rank}.json")) as f:
            ranks.append(json.load(f))
    shutil.rmtree(out_dir, ignore_errors=True)
    r0 = ranks[0]
    note = "gloo stages CUDA tensors through the host: these times describe gloo on one card, not NCCL"
    print(f"[dist] {DIST_WORLD} gloo ranks on cuda:0, all checks passed on both in {seconds:.1f} s (spawn included)")
    print(f"[dist] gloo took on CUDA tensors: {', '.join(r0['gloo_cuda_collectives'])}")
    print(
        f"[dist] replica sync: K1/K2 launches per rank {[r['sync_launches'] for r in ranks]} ({NUM_BATCHES // DIST_WORLD} local batches"
        f" each); synced states bitwise equal to the single-process fold, values to the slice phase's"
    )
    for r in ranks:
        print(
            f"[dist] rank {r['rank']}: suite compute() with its sync {r['suite_compute_ms']:.3f} ms, the sync alone"
            f" {r['suite_sync_ms']:.3f} ms ({r['suite_state_bytes']} B of states; median of {DIST_REPS}); {smi}; {note}"
        )
        print(
            f"[dist] rank {r['rank']}: exact group {r['exact_rows'][0]} local rows, gathered to {r['exact_rows'][1]}:"
            f" MulticlassAUROC's sync {r['exact_gather_ms']:.3f} ms; per-class values bitwise equal to the exact phase's; {smi}; {note}"
        )
        print(
            f"[dist] rank {r['rank']}: sharded fused pass of {NUM_BATCHES} half batches {r['sharded_pass_ms']:.3f} ms"
            f" (median of {DIST_REPS}; first pass with captures {r['sharded_first_pass_ms']:.3f} ms) against the local"
            f" fused pass {fused_run['median_s'] * 1e3:.3f} ms; K1/K2 per pass in the trace {r['sharded_plan_launches_per_pass']};"
            f" {smi}; {note}"
        )
    for r in ranks:
        print(
            f"[dist] rank {r['rank']}: sharded_update's compiled-step cache over {NUM_BATCHES} ShardedMetric events of each"
            f" member: counters {r['sharded_cache']['counters']}, sharded.update_step spans cold {r['sharded_cache']['cold']}"
            f" of {r['sharded_cache']['steps']} (a build per member, then the cached step)"
        )
    for r in ranks:
        print(
            f"[dist] rank {r['rank']}: wrappers under sharded_update, {DIST_WRAPPER_EVENTS} events: MinMaxMetric(AUROC) and"
            f" Running(MSE, 3) equal the replica regime (int32 bitwise, float relative {r['sharded_wrapper_errs']:.3e}, budget"
            f" {DIST_WRAPPER_RTOL}); K1/K2 over the sharded and replica MinMax events {r['sharded_minmax_launches']}; one sharded event"
            f" MinMax {r['sharded_minmax_event_ms']:.3f} ms, Running {r['sharded_running_event_ms']:.3f} ms, a replica MinMax"
            f" update {r['replica_minmax_update_ms']:.3f} ms (median of {DIST_REPS}); {smi}; {note}"
        )
    for r in ranks:
        print(
            f"[dist] rank {r['rank']}: durable kill and resume, values bitwise equal to the slice phase's: replica regime"
            f" (4 local batches, killed after batch 3, a store per rank, {r['durable_replica_files']} files written, compute()"
            f" syncs) resume {r['durable_replica_resume_ms']:.3f} ms; sharded fused regime (8 half batches, killed after"
            f" batch {DURABLE_KILL_AFTER + 1}, rank 0 writes: {r['durable_sharded_files']} files from this rank, no second"
            f" sync, states bitwise equal to the plain fold) resume {r['durable_sharded_resume_ms']:.3f} ms; {smi}; {note}"
        )
    for r in ranks:
        print(
            f"[dist] rank {r['rank']}: sketch merge sync ({NUM_BATCHES // DIST_WORLD} local batches of {BATCH}), equal to the"
            f" one-rank merge of both halves: Quantile {r['sketch_quantile_sync_ms']:.3f} ms, DriftScore"
            f" {r['sketch_drift_sync_ms']:.3f} ms, HeavyHitters (uint32 keys as int32) {r['sketch_heavy_sync_ms']:.3f} ms; {smi}; {note}"
        )
    for r in ranks:
        print(
            f"[dist] rank {r['rank']}: the sliced mesh plan ({FANOUT_CELLS} cells, half of each of {NUM_BATCHES} x {FANOUT_BATCH} rows,"
            f" accuracy and exact AUROC) bitwise equal to the local plan over the whole batches; a pass {r['sliced_mesh_pass_ms']:.3f} ms"
            f" against the local plan's {r['sliced_local_pass_ms']:.3f} ms (medians of {DIST_REPS}); {smi}; {note}"
        )
    print(f"[dist] BootStrapper refused: {r0['bootstrap_refusal']!r}")
    print(f"[dist] fault drill: {r0['drill_error']!r} on both ranks; the next gather healed")
    return {"seconds": seconds, "ranks": ranks}


# --------------------------------------------------------------------- sketch

SKETCH_QS = (0.5, 0.99)
SKETCH_BINS = 64  # DriftScore's and bounded Spearman's bins
SKETCH_KEYS = 10**6  # the Zipf-like tags' key space
SKETCH_RESERVOIR = 4096
SKETCH_DRIFT_ATOL = 1e-5  # the card's drift scores against a float64 numpy reference
SKETCH_MOMENTS_RTOL = 1e-5  # the card's row moments against the CPU's (sums in another order)
SKETCH_REPS = 10  # profiled calls per timed sketch update


def _sketch_streams(device):
    """The sketch phase's stream, made on the card from SEED + 40: NUM_BATCHES
    batches of BATCH float32 values (Quantile, Median, the reservoir), value
    pairs with a correlated second column (bounded Spearman), drift values in
    [0, 1) whose second half is shifted up by 0.2, Zipf-like int32 tags over
    SKETCH_KEYS keys (density 1/k: ``floor(exp(u * ln 1e6)) - 1``), and
    (BATCH, NUM_CLASSES) rows (the moments); and the pinned BATCH-sample drift reference."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 40)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device, dtype=torch.float32)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=device, dtype=torch.float32)

    values = [randn(BATCH) for _ in range(NUM_BATCHES)]
    pairs = [(x, 0.6 * x + 0.8 * randn(BATCH)) for x in values]
    drift = [rand(BATCH) * (0.8 if i >= NUM_BATCHES // 2 else 1.0) + (0.2 if i >= NUM_BATCHES // 2 else 0.0) for i in range(NUM_BATCHES)]
    tags = [(torch.floor(torch.exp(rand(BATCH) * math.log(SKETCH_KEYS))) - 1).clamp(0, SKETCH_KEYS - 1).to(torch.int32)
            for _ in range(NUM_BATCHES)]
    rows = [randn(BATCH, NUM_CLASSES) for _ in range(NUM_BATCHES)]
    reference = rand(BATCH)
    return {"values": values, "pairs": pairs, "drift": drift, "tags": tags, "rows": rows}, reference


def _sketch_holders():
    """Metrics over a bare sketch state: (BATCH, NUM_CLASSES) row moments and a SKETCH_RESERVOIR-slot sample."""
    import torchmetrics_tpu_torch as tm
    from torchmetrics_tpu_torch import sketch as sk

    class RowMoments(tm.Metric):
        full_state_update = False

        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            self.add_state("moments", sk.moments_init((NUM_CLASSES,), device="cpu"), dist_reduce_fx="merge")

        def update(self, rows):
            self.moments = sk.moments_update(self.moments, rows)

        def compute(self):
            return sk.moments_variance(self.moments)

    class Sample(tm.Metric):
        full_state_update = False

        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            self.add_state("res", sk.reservoir_init(SKETCH_RESERVOIR, seed=SEED, device="cpu"), dist_reduce_fx="merge")

        def update(self, x):
            self.res = sk.reservoir_update(self.res, x)

        def compute(self):
            return self.res.values

    return RowMoments, Sample


def _sketch_metrics(device, reference, holders):
    """``{name: (metric, stream key)}``: every sketch metric of the phase, on ``device``."""
    import torchmetrics_tpu_torch as tm
    from torchmetrics_tpu_torch import drift

    row_moments, sample = holders
    return {
        "quantile": (tm.Quantile(q=list(SKETCH_QS), device=device), "values"),
        "median": (tm.Median(device=device), "values"),
        "spearman": (tm.SpearmanCorrCoef(num_bins=SKETCH_BINS, device=device), "pairs"),
        "drift": (drift.DriftScore(reference.to(device), bins=SKETCH_BINS, device=device), "drift"),
        "cardinality": (drift.Cardinality(device=device), "tags"),
        "heavy": (drift.HeavyHitters(device=device), "tags"),
        "moments": (row_moments(device=device), "rows"),
        "reservoir": (sample(device=device), "values"),
    }


def _sketch_update(metric, arg):
    if isinstance(arg, tuple):
        metric.update(*arg)
    else:
        metric.update(arg)


def _sketch_states_equal(got, want, what, moments_rtol=None, bitwise=False):
    """Every state of ``got`` equals ``want``'s: integer leaves bitwise, float
    leaves as floats (a radix sort may order -0 and +0 apart) or, with
    ``bitwise``, bit for bit; the row moments' floats within ``moments_rtol``
    where given."""
    import torch

    for name in want._defaults:
        g, w = getattr(got, name), getattr(want, name)
        pairs = zip(w._fields, g, w) if hasattr(w, "_fields") else [("", g, w)]
        for field, a, b in pairs:
            a, b = a.detach().cpu(), b.detach().cpu()
            _require(a.dtype == b.dtype and a.shape == b.shape, f"{what}: {name}.{field} {a.dtype}{tuple(a.shape)} vs {b.dtype}{tuple(b.shape)}")
            if moments_rtol is not None and a.dtype.is_floating_point:
                _require(torch.allclose(a, b, rtol=moments_rtol, atol=moments_rtol), f"{what}: {name}.{field} beyond rtol {moments_rtol}")
            elif a.dtype.is_floating_point:
                same = a.numpy().tobytes() == b.numpy().tobytes() if bitwise else torch.equal(a, b)
                _require(same, f"{what}: {name}.{field} differs")
            else:
                _require(torch.equal(a.to(torch.int64), b.to(torch.int64)), f"{what}: {name}.{field} differs")


def _numpy_drift_scores(edges, reference, live, eps=1e-6):
    """PSI, KL and KS in float64 of two samples binned on ``edges`` (the low and high tallies as edge cells)."""
    import numpy as np

    def cells(x):
        idx = np.clip(np.searchsorted(edges, x, side="right") - 1, 0, edges.size - 2)
        inside = (x >= edges[0]) & (x <= edges[-1])
        counts = np.bincount(idx[inside], minlength=edges.size - 1)
        return np.concatenate([[np.sum(x < edges[0])], counts, [np.sum(x > edges[-1])]]).astype(np.float64) / x.size

    p, q = cells(live), cells(reference)
    pf, qf = np.maximum(p, eps), np.maximum(q, eps)
    pf, qf = pf / pf.sum(), qf / qf.sum()
    psi = float(np.sum((pf - qf) * np.log(pf / qf)))
    return psi, psi / 2, float(np.max(np.abs(np.cumsum(p) - np.cumsum(q))))


def _events_ms(fn, reps=SKETCH_REPS):
    """Mean stream time of ``fn`` by CUDA events around ``reps`` calls, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_cm_track(device, streams):
    """K3 against ``cm_track_plain`` on the card at the main path's shape: the
    tags of one 65536-tag batch, their estimates against the grid after it,
    the table left by the batch before; bitwise, from an empty and from a
    filled table. Then three cases its filters must not change: every tag
    distinct with estimates rising (every tag admitted, nothing to skip), a
    filled table with a key live in two slots and one with a negative count
    (the unfiltered chain over every tag); bitwise too. Each case's counters
    (the mode, the tile filters' survivors, the steps run) equal the host's
    trace of the same filters, and each is timed by CUDA events; the chain's
    floor is the sketch batches' steps times the adversarial batch's time per
    step. Then timed beside its plain loop (host clock, the loop runs on the
    host) and its bound."""
    import torch

    from torchmetrics_tpu_torch import sketch as sk
    from torchmetrics_tpu_torch.ops import cm_track, cm_track_plain
    from torchmetrics_tpu_torch.ops.cm_track import cm_track_stats
    from torchmetrics_tpu_torch.sketch.countmin import _int32_bits, _point
    from torchmetrics_tpu_torch.sketch.hll import _as_tags

    arg_sets = []
    state = sk.cm_init(device=device)
    for i, batch in enumerate(streams["tags"][:4]):
        tags = _as_tags(batch)
        grid = sk.cm_update(state, batch).counts
        arg_sets.append((_int32_bits(tags), _point(grid, tags), state.hh_keys, state.hh_counts))
        state = sk.cm_update(state, batch)
    k = int(arg_sets[0][2].numel())
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 41)
    adversarial = (torch.randperm(BATCH, generator=gen, device=device).to(torch.int32) * 7919 - 2**30,
                   torch.arange(1, BATCH + 1, dtype=torch.int32, device=device),
                   torch.zeros(k, dtype=torch.int64, device=device).to(torch.uint32), torch.zeros(k, dtype=torch.int32, device=device))
    dup_keys, dup_counts = arg_sets[1][2].clone(), arg_sets[1][3].clone()
    dup_keys[-1], dup_counts[-1] = dup_keys[0], dup_counts[0].clamp(min=1)
    neg_counts = arg_sets[1][3].clone()
    neg_counts[k // 2] = -1
    cases = {
        "sketch batch 0, empty table": arg_sets[0],
        "sketch batch 1, filled table": arg_sets[1],
        "sketch batch 3, filled table": arg_sets[3],
        "adversarial: every tag admitted": adversarial,
        "live duplicate key": (*arg_sets[1][:2], dup_keys, dup_counts),
        "negative count": (*arg_sets[1][:3], neg_counts),
    }
    max_err, stats = 0, {}
    for label, args in cases.items():
        *got, counters = cm_track_stats(*args)
        torch.cuda.synchronize()
        host = tuple(a.cpu() for a in args)
        *want, want_counters = cm_track_stats(*host)  # on the host: cm_track_plain and the filters' trace
        for g, w in zip(got, want):
            _require(g.dtype == w.dtype and torch.equal(g.cpu().to(torch.int64), w.to(torch.int64)), f"cm_track, {label}: the kernel differs from its plain loop")
        _require(counters.cpu().tolist() == want_counters.tolist(),
                 f"cm_track, {label}: the kernel's counters {counters.tolist()} differ from the host's trace {want_counters.tolist()}")
        max_err = max(max_err, int((got[1].cpu().to(torch.int64) - want[1].to(torch.int64)).abs().max()))
        filtered, survivors, steps = want_counters.tolist()
        stats[label] = {"filtered": filtered, "survivors": survivors, "steps": steps}
    for label, args in cases.items():  # timed after every host loop, each case the best of three
        stats[label]["ms"] = min(_events_ms(lambda args=args: cm_track(*args)) for _ in range(3))
    _require(stats["live duplicate key"]["filtered"] == 0 and stats["negative count"]["filtered"] == 0
             and stats["adversarial: every tag admitted"]["steps"] == BATCH, "cm_track: the unfiltered and the adversarial cases")
    ns_per_step = stats["adversarial: every tag admitted"]["ms"] * 1e6 / BATCH
    for rec in stats.values():
        rec["floor_ms"] = rec["steps"] * ns_per_step / 1e6
    print(f"[kernels] cm_track: bitwise equal to its plain loop at n={BATCH} tags, k={k}, on {len(cases)} cases, the counters"
          f" equal to the host's trace; mode (1 filtered), survivors, steps, stream ms, chain floor ms (steps x"
          f" {ns_per_step:.2f} ns a step, the adversarial batch's): "
          + "; ".join(f"{label} {r['filtered']}, {r['survivors']}, {r['steps']}, {r['ms']:.5f}, {r['floor_ms']:.5f}" for label, r in stats.items()))
    times = _measure([("kernel", cm_track, arg_sets), ("read_floor", _read_floor, [(a[0],) for a in arg_sets])],
                     profile_reps=SKETCH_REPS, timing_reps=SKETCH_REPS)
    plain_s = [_timed(lambda args=args: cm_track_plain(*args)) for args in arg_sets[:2]]
    n_bytes = BATCH * 8 + k * 8 * 2  # the tags and estimates read once, the table read and written
    bound_ms, bound_by = _bound(n_bytes, BATCH * k * 3)  # per tag and slot: the key compare, the live test, the minimum
    sketch_steps = [stats[label]["steps"] for label in cases if label.startswith("sketch")]
    return {
        "name": "cm_track",
        "route": "cuda",
        "source": "torchmetrics_tpu_torch/csrc/cm_track.cu",
        "replaces": "torchmetrics_tpu/sketch/countmin.py:118",
        "max_abs_err": max_err,
        "ms": times["kernel"]["device_ms"],
        "plain_ms": min(plain_s) * 1e3,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "stream_ms": {k_: v["stream_ms"] for k_, v in times.items()},
        "kernel_only_us": _kernel_only_us(times["kernel"]["found"], "cm_track"),
        "bytes": n_bytes,
        "read_floor_ms": times["read_floor"]["device_ms"],
        "cases": stats,
        "chain_floor_ms": max(sketch_steps) * ns_per_step / 1e6,
    }


def phase_sketch(device, kernels, smi):
    """The sketch plane at full width (see the module docstring, phase 13):
    eager (the main path: K3 counted), against the CPU and numpy; the captured
    one-metric step; the fused plan; K3 against its plain loop; set_dtype."""
    import numpy as np
    import torch

    import torchmetrics_tpu_torch as tm
    from torchmetrics_tpu_torch import sketch as sk
    from torchmetrics_tpu_torch.parallel import fold_jit_state, make_jit_update
    from torchmetrics_tpu_torch.sketch.countmin import _columns
    from torchmetrics_tpu_torch.sketch.hll import _as_tags

    t_phase = time.perf_counter()
    streams, reference = _sketch_streams(device)
    holders = _sketch_holders()
    out = {}

    # 1) eager, the main path: every metric's update over the 8 batches; K3's count from 0
    card = _sketch_metrics(device, reference, holders)
    for wrapper in kernels.values():
        wrapper.launches = 0
    t0 = time.perf_counter()
    for i in range(NUM_BATCHES):
        for metric, key in card.values():
            _sketch_update(metric, streams[key][i])
    torch.cuda.synchronize()
    out["eager_s"] = time.perf_counter() - t0
    out["launches"] = {name: w.launches for name, w in kernels.items()}
    _require(out["launches"]["cm_track"] == NUM_BATCHES, f"sketch: K3 launched {out['launches']['cm_track']} times on the main path, expected {NUM_BATCHES}")

    # the same stream through the port on the CPU
    host = {key: [tuple(t.cpu() for t in b) if isinstance(b, tuple) else b.cpu() for b in s] for key, s in streams.items()}
    cpu = _sketch_metrics("cpu", reference.cpu(), holders)
    t0 = time.perf_counter()
    for i in range(NUM_BATCHES):
        for metric, key in cpu.values():
            _sketch_update(metric, host[key][i])
    out["cpu_s"] = time.perf_counter() - t0
    for name, (metric, _) in card.items():
        _sketch_states_equal(metric, cpu[name][0], f"sketch {name}, card vs CPU", SKETCH_MOMENTS_RTOL if name == "moments" else None)
    for name in ("quantile", "median"):
        _require(torch.equal(card[name][0].compute().cpu(), cpu[name][0].compute()), f"sketch {name}: quantiles differ from the CPU's")

    # against numpy: the quantiles inside the rank bound, HLL inside 3 sigma, Count-Min above the truth, drift to 1e-5
    values = np.concatenate([v.cpu().numpy() for v in streams["values"]])
    values.sort()
    n = values.size
    q = card["quantile"][0]
    bound = float(q.error_bound())
    est = q.compute().cpu().numpy()
    rank_err = [abs(float(np.searchsorted(values, e, side="right")) - qq * n) for qq, e in zip(SKETCH_QS, est)]
    _require(all(r <= bound + 1 for r in rank_err), f"sketch quantile: rank errors {rank_err} beyond the bound {bound}")
    tags = np.concatenate([t.cpu().numpy() for t in streams["tags"]])
    distinct = int(np.unique(tags).size)
    card_est = float(card["cardinality"][0].compute())
    hll_rel = abs(card_est - distinct) / distinct
    _require(hll_rel <= 3 * 1.04 / math.sqrt(4096), f"sketch cardinality {card_est} vs {distinct} distinct: {hll_rel:.4f}")
    truth = np.bincount(tags, minlength=SKETCH_KEYS)
    probe = np.concatenate([np.argsort(-truth)[:100], np.random.default_rng(SEED).integers(0, SKETCH_KEYS, 100)]).astype(np.int32)
    point = card["heavy"][0].count_of(torch.from_numpy(probe).to(device)).cpu().numpy()
    _require(bool((point >= truth[probe]).all()), "sketch heavy hitters: a point query below the true count")
    keys, counts = card["heavy"][0].compute()
    top_true = set(np.argsort(-truth)[:5].tolist())
    found_top = len(top_true & set(keys.cpu().to(torch.int64).numpy()[:32].tolist()))
    drift_metric = card["drift"][0]
    want = _numpy_drift_scores(drift_metric.reference.edges.cpu().numpy().astype(np.float64),
                               reference.cpu().numpy(), np.concatenate([d.cpu().numpy() for d in streams["drift"]]))
    got = [float(v) for v in drift_metric.compute()]
    drift_err = max(abs(g - w) for g, w in zip(got, want))
    _require(drift_err <= SKETCH_DRIFT_ATOL, f"sketch drift scores {got} vs numpy {want}")
    out.update(rank_err=rank_err, bound=bound, hll_rel=hll_rel, distinct=distinct, found_top=found_top, drift=got, drift_err=drift_err,
               spearman=float(card["spearman"][0].compute()), state_bytes=sk.kll_state_bytes(q.sketch))
    print(
        f"[sketch] eager, {NUM_BATCHES} x {BATCH}: every state equal to the port's on the CPU (integer leaves bitwise, KLL items"
        f" as floats, moments within {SKETCH_MOMENTS_RTOL}); K3 launches on the main path {out['launches']['cm_track']};"
        f" quantiles {est.tolist()} rank errors {rank_err} <= bound {bound:.0f}; HLL {card_est:.1f} vs {distinct} distinct"
        f" (relative {hll_rel:.4f}); Count-Min point queries >= the truth on 200 keys, {found_top} of the 5 hottest keys in"
        f" the table; drift psi/kl/ks {got} within {drift_err:.2e} of numpy float64; bounded Spearman {out['spearman']:.5f};"
        f" eager pass {out['eager_s']:.3f} s on the card, {out['cpu_s']:.3f} s on the CPU; kll_state_bytes {out['state_bytes']}"
    )

    out["k3_row"] = dict(check_cm_track(device, streams), launches=out["launches"]["cm_track"])

    # 2) A5b: the captured one-metric step over the Quantile stream equals the eager Quantile
    step_metric = tm.Quantile(q=list(SKETCH_QS), device=device)
    step, state = make_jit_update(step_metric, donate=True)
    for v in streams["values"]:
        state = step(state, v)
    _require(len(step._captured) == 1, f"sketch: the step captured {len(step._captured)} graphs")
    fold_jit_state(step_metric, state)
    _sketch_states_equal(step_metric, card["quantile"][0], "sketch captured step vs eager")
    _require(step_metric._update_count == NUM_BATCHES, "sketch: the step's update count")

    # 3) the fused plan: the value-stream members and the tag members, one graph replay per batch each
    fused_members = {"values": ("quantile", "median", "reservoir"), "drift": ("drift",), "tags": ("cardinality", "heavy")}
    fused = _sketch_metrics(device, reference, holders)
    plans = {}
    for key, names in fused_members.items():
        col = tm.MetricCollection({name: fused[name][0] for name in names}, compute_groups=False)
        plans[key] = col.fused()
    for i in range(NUM_BATCHES):
        for key, plan in plans.items():
            plan.update(streams[key][i])
    for plan in plans.values():
        plan.fold_back()
    for names in fused_members.values():
        for name in names:
            _sketch_states_equal(fused[name][0], card[name][0], f"sketch fused {name} vs eager")

    def fused_pass():
        for i in range(NUM_BATCHES):
            for key, plan in plans.items():
                plan.update(streams[key][i])

    found, busy_us, wall_us = _profile(fused_pass, 1)
    out.update(fused_busy_share=busy_us / wall_us, fused_busy_us=busy_us, fused_wall_us=wall_us)

    # 4) device ms per update, each on its own state
    hll = sk.hll_init(device=device)
    live = sk.hist_init(SKETCH_BINS, 0.0, 1.0, device=device)
    cm = sk.cm_init(device=device)
    timing_q = tm.Quantile(q=list(SKETCH_QS), device=device)
    step_q = tm.Quantile(q=list(SKETCH_QS), device=device)
    tstep, tstate = make_jit_update(step_q, donate=True)
    for v in streams["values"][:2]:
        tstate = tstep(tstate, v)
    ones = torch.ones((), dtype=torch.int32, device=device)

    def grid(counts, t):
        tags64 = _as_tags(t)
        cols = _columns(tags64, 4, 1024)
        flat = (cols + 1024 * torch.arange(4, device=device)[:, None]).reshape(-1)
        return counts.reshape(-1).index_add(0, flat, ones.expand(flat.numel()))

    def state_bytes(state):
        return sum(leaf.numel() * leaf.element_size() for leaf in state)

    # bytes each update must move: its batch read once, its state read and written once
    batch_bytes = BATCH * 4
    timed = {}
    for label, fn, args, n_bytes in [
        ("KLL update (Quantile.update)", timing_q.update, [(v,) for v in streams["values"]], batch_bytes + 2 * state_bytes(timing_q.sketch)),
        ("captured step (make_jit_update)", lambda v: tstep(tstate, v), [(v,) for v in streams["values"]],
         batch_bytes + 2 * state_bytes(step_q.sketch)),
        ("HLL update", lambda t: sk.hll_update(hll, t), [(t,) for t in streams["tags"]], batch_bytes + 2 * state_bytes(hll)),
        ("Count-Min grid", lambda t: grid(cm.counts, t), [(t,) for t in streams["tags"]], batch_bytes + 2 * cm.counts.numel() * 4),
        ("Count-Min update with K3", lambda t: sk.cm_update(cm, t), [(t,) for t in streams["tags"]], batch_bytes + 2 * state_bytes(cm)),
        ("drift update (histogram)", lambda x: sk.hist_update(live, x), [(x,) for x in streams["drift"]], batch_bytes + 2 * state_bytes(live)),
    ]:
        ms, found = _device_ms(fn, args, SKETCH_REPS)
        bound_ms, bound_by = _bound(n_bytes, 0)
        timed[label] = {"ms": ms, "launches": sum(max(1, round(c / SKETCH_REPS)) for _, c in found.values() if c),
                        "bytes": n_bytes, "bound_ms": bound_ms}
    out["timed"] = timed

    # 5) set_dtype(torch.float64) on a card Quantile
    q64 = tm.Quantile(q=list(SKETCH_QS), device=device)
    q64.update(streams["values"][0])
    q64.set_dtype(torch.float64)
    q64.update(streams["values"][1].double())
    _require(q64.sketch.items.dtype == torch.float64 and q64.sketch.count.dtype == torch.int32 and int(q64.sketch.count) == 2 * BATCH,
             "sketch: set_dtype(float64) on the card")
    _require(bool(torch.isfinite(q64.compute()).all()) and q64.compute().dtype == torch.float64, "sketch: the float64 Quantile's value")

    out["seconds"] = time.perf_counter() - t_phase
    print(
        f"[sketch] captured make_jit_update over the Quantile stream: one graph, states equal to the eager Quantile's;"
        f" fused plans (values: quantile, median, reservoir; drift; tags: cardinality, heavy hitters) equal to eager,"
        f" busy share of a fused pass {out['fused_busy_share']:.4f} ({busy_us:.1f} us of {wall_us:.1f} us);"
        f" set_dtype(float64) on the card updates and computes in float64"
    )
    print(
        "[sketch] device ms per update at 65536 values (kernel launches per call; bytes; byte bound ms): "
        + "; ".join(f"{k} {v['ms']:.5f} ({v['launches']}; {v['bytes']} B; {v['bound_ms']:.5f})" for k, v in timed.items())
        + f"; phase {out['seconds']:.1f} s; {smi}"
    )
    return out


# --------------------------------------------------------------------- sliced

#: the hand kernels of the sliced plane (phase 14); its geometries run them beside no other
SLICED_KERNELS = ("slice_assign", "stat_counts_segmented", "binned_curve_state_segmented")
K2S_KERNEL = "stat_counts_cells"  # K2s's device kernel over more than one cell (at one cell it is K2's, stat_counts_kernel)
FANOUT_CELLS = 1024  # bench_workloads.py SLICED_CELLS
FANOUT_BATCH = 8192  # bench_workloads.py SLICED_BATCH
FANOUT_CLASSES = 8  # bench_workloads.py SLICED_CLASSES
DRIFT_CELLS = 1024  # bench_workloads.py DRIFT_CELLS
DRIFT_BATCH = 8192  # bench_workloads.py DRIFT_BATCH
DRIFT_BINS = 32  # bench_workloads.py DRIFT_BINS
DRIFT_REFERENCE = 65536
SUITE_COHORTS = 200
SUITE_CELLS = 256
SLICED_SAMPLE = 32  # cohorts held against independent metrics (fanout, drift)
SUITE_SAMPLE = 12  # cohorts of the flagship suite held against independent suites
SLICED_REPS = 3
SLICED_DRIFT_ATOL = 1e-6  # compute_all's scores against each cohort's own DriftScore (vmapped sums)
WINDOW_SLOTS, WINDOW_EVERY_N = 4, 2


def _sliced_kernels():
    from torchmetrics_tpu_torch.ops import KERNELS

    return {name: KERNELS[name] for name in SLICED_KERNELS}


def _fanout_stream(device):
    """bench_workloads.py's sliced_fanout stream, made on the card from a seed: NUM_BATCHES
    batches of FANOUT_BATCH rows, keys uniform over FANOUT_CELLS cohorts, 8-class logits."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 20)
    keys = torch.randint(0, FANOUT_CELLS, (NUM_BATCHES, FANOUT_BATCH), generator=gen, device=device, dtype=torch.int32)
    preds = torch.randn((NUM_BATCHES, FANOUT_BATCH, FANOUT_CLASSES), generator=gen, device=device)
    target = torch.randint(0, FANOUT_CLASSES, (NUM_BATCHES, FANOUT_BATCH), generator=gen, device=device, dtype=torch.int32)
    return keys, preds, target


def _drift_stream(device):
    """bench_workloads.py's drift_cohort_windows stream: values N(0.5, 0.1) over DRIFT_CELLS
    cohorts, and a DRIFT_REFERENCE-value reference from numpy's seed 0, as the JAX leg draws it."""
    import numpy as np
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 21)
    keys = torch.randint(0, DRIFT_CELLS, (NUM_BATCHES, DRIFT_BATCH), generator=gen, device=device, dtype=torch.int32)
    vals = 0.5 + 0.1 * torch.randn((NUM_BATCHES, DRIFT_BATCH), generator=gen, device=device)
    reference = torch.from_numpy(np.random.RandomState(0).normal(0.5, 0.1, DRIFT_REFERENCE).astype(np.float32)).to(device)
    return keys, vals, reference


def _suite_keys(device):
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 22)
    return torch.randint(0, SUITE_COHORTS, (NUM_BATCHES, BATCH), generator=gen, device=device, dtype=torch.int32)


def _cohort_refs(cohorts, factory, keys, *streams):
    """One independent metric per cohort, fed that cohort's rows of every batch
    that has any (a cell counts the batches that reach it)."""
    refs = {}
    for k in cohorts:
        metric = factory()
        for i in range(keys.shape[0]):
            sel = keys[i] == k
            if bool(sel.any()):
                metric.update(*(s[i][sel] for s in streams))
        refs[k] = metric
    return refs


def _require_cell_bitwise(got, want, what):
    """An exported cell against an independent metric: the update count (the
    batches that reached the cell) and every state, bitwise."""
    _require(got._update_count == want._update_count, f"{what}: update count {got._update_count} vs {want._update_count}")
    _require_metric_states_bitwise(got, want, what)


def _flat_payload(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_flat_payload(value, f"{prefix}{key}."))
        elif isinstance(value, list):
            for i, v in enumerate(value):
                out.update(_flat_payload(v, f"{prefix}{key}[{i}].") if isinstance(v, dict) else {f"{prefix}{key}[{i}]": v})
        else:
            out[f"{prefix}{key}"] = value
    return out


def _require_payloads_bitwise(got, want, what):
    import numpy as np

    g, w = _flat_payload(got), _flat_payload(want)
    _require(sorted(g) == sorted(w), f"{what}: payload keys differ")
    for key in w:
        a, b = np.asarray(g[key]), np.asarray(w[key])
        _require(a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), f"{what}: {key} differs")


SPILL_COHORTS = 2048  # K4's spill batch: FANOUT_BATCH keys over twice FANOUT_CELLS cohorts
K4_FRESH_TABLES = 6  # empty tables a first-batch shape is timed over, one call each


def _k4_bound(batch, num_cells, new_keys):
    """K4's least time: the keys read and the cells written once, the table read
    once and each new key written once; the hash's few tens of integer operations a key."""
    return _bound(batch * 4 * 2 + num_cells * 5 + new_keys * 5 + 4, batch * 40)


def check_slice_assign(device, suite_keys, fanout_keys):
    """K4 against ``slice_assign_plain`` (JAX's while_loop as a host loop) on
    the card at the main path's shapes: the suite's 65536 keys over 200
    cohorts into 256 cells and the fan-out's 8192 keys into 1024 cells, each
    from an empty table (insertion rounds) and again on the filled one
    (lookups), and a spill batch (8192 keys over 2048 cohorts into 1024
    cells); table and cells bitwise, the kernel's new keys and rounds equal
    to the host's count of its route (``slice_assign_reps_plain``). Each
    first batch timed over fresh tables, and the steady state (every cohort
    resident), beside the plain version and the bound."""
    import torch

    from torchmetrics_tpu_torch.ops import slice_assign, slice_assign_plain
    from torchmetrics_tpu_torch.ops.slice_assign import _kept_buffers, slice_assign_reps_plain, slice_assign_stats

    def table(n):
        return (torch.zeros((n, 1), dtype=torch.int32, device=device), torch.zeros(n, dtype=torch.bool, device=device),
                torch.zeros((), dtype=torch.int32, device=device))

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 23)
    spill_keys = torch.randint(0, SPILL_COHORTS, (2, FANOUT_BATCH), generator=gen, device=device, dtype=torch.int32)
    shapes = {}
    for what, n, kmats in (("suite", SUITE_CELLS, suite_keys[:2]), ("fan-out", FANOUT_CELLS, fanout_keys[:2]),
                           ("spill", FANOUT_CELLS, spill_keys)):
        mine, plain, reps = table(n), table(n), table(n)
        for i, k in enumerate(kmats):
            kmat = k[:, None].contiguous()
            got = slice_assign(*mine, kmat)
            want = slice_assign_plain(*plain, kmat)
            host = {}
            slice_assign_reps_plain(*reps, kmat, stats=host)
            torch.cuda.synchronize()
            _require(torch.equal(got, want), f"slice_assign, {what} batch {i}: cells differ from the plain version")
            for a, b, c in zip(mine, plain, reps):
                _require(torch.equal(a, b) and torch.equal(c, b), f"slice_assign, {what} batch {i}: the table differs from the plain version")
            stats = slice_assign_stats(mine[0])
            _require(stats == host, f"slice_assign, {what} batch {i}: kernel new keys and rounds {stats}, host {host}")
            if i == 0:
                shapes[what] = dict(stats, spilled_rows=int((got < 0).sum()), batch=int(kmat.shape[0]), cells=n)
    for what, kmats in (("suite", suite_keys), ("fan-out", fanout_keys), ("spill", spill_keys)):
        rec = shapes[what]
        kmat = kmats[0][:, None].contiguous()

        def first_call():  # an empty table and the buffers kept with it are made first (their memsets are not K4's)
            fresh = table(rec["cells"])
            _kept_buffers(fresh[0], rec["batch"])
            slice_assign(*fresh, kmat)

        _, found = _device_ms(first_call, [()], reps=K4_FRESH_TABLES)
        ms = _kernel_only_us(found, "slice_assign") / 1e3  # the call's one launch
        fresh = [table(rec["cells"]) for _ in range(K4_FRESH_TABLES)]
        for t in fresh:
            _kept_buffers(t[0], rec["batch"])
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for t in fresh:
            slice_assign(*t, kmat)
        end.record()
        torch.cuda.synchronize()
        plain_wall_ms = _timed(lambda: slice_assign_plain(*table(rec["cells"]), kmat)) * 1e3  # a host loop of rounds
        bound_ms, bound_by = _k4_bound(rec["batch"], rec["cells"], rec["new_keys"])
        rec.update(ms=ms, stream_ms=start.elapsed_time(end) / K4_FRESH_TABLES, plain_wall_ms=plain_wall_ms, bound_ms=bound_ms,
                   bound_by=bound_by)
        print(f"[kernels] slice_assign, {what} first batch ({rec['batch']} keys into {rec['cells']} empty cells): {rec['new_keys']} new"
              f" keys, {rec['rounds']} rounds, {rec['spilled_rows']} rows spilled; device {ms:.5f} ms (stream {rec['stream_ms']:.5f})"
              f" against the plain version's {plain_wall_ms:.3f} ms wall and the bound {bound_ms:.5f} ({bound_by})")
    print(f"[kernels] slice_assign: bitwise equal to its plain version (table and cells) at {BATCH} keys into {SUITE_CELLS}"
          f" cells, {FANOUT_BATCH} into {FANOUT_CELLS} and a spill batch over {SPILL_COHORTS} cohorts, from an empty and from a"
          f" filled table; new keys and rounds equal to the host's count")
    steady = table(SUITE_CELLS)
    slice_assign(*steady, suite_keys[0][:, None].contiguous())
    arg_sets = [(*steady, k[:, None].contiguous()) for k in suite_keys]
    times = _measure([("kernel", slice_assign, arg_sets), ("plain", slice_assign_plain, arg_sets[:2]),
                      ("read_floor", _read_floor, [(k,) for k in suite_keys])], profile_reps=SKETCH_REPS, timing_reps=SKETCH_REPS)
    n_bytes = BATCH * 4 * 2 + SUITE_CELLS * 5 + 4  # keys read, cells written, the table read once
    bound_ms, bound_by = _k4_bound(BATCH, SUITE_CELLS, 0)
    return {
        "name": "slice_assign",
        "route": "cuda",
        "source": "torchmetrics_tpu_torch/csrc/slice_assign.cu",
        "replaces": "torchmetrics_tpu/parallel/sliced.py:210",
        "max_abs_err": 0.0,
        "ms": times["kernel"]["device_ms"],
        "plain_ms": times["plain"]["device_ms"],
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "stream_ms": {k: v["stream_ms"] for k, v in times.items()},
        "kernel_only_us": _kernel_only_us(times["kernel"]["found"], "slice_assign"),
        "bytes": n_bytes,
        "read_floor_ms": times["read_floor"]["device_ms"],
        "first_batches": shapes,
    }


def check_stat_counts_segmented(device, batches, cells_list, fanout):
    """K2s against ``stat_counts_segmented_plain`` on the card: the suite's
    65536 x 64 logits into 256 cells and the fan-out's 8192 x 8 into 1024,
    spilled (-1) rows beside; then at 1 and 256 cells, scores and labels
    mode, every row dropped, none, 90% in one cell, 131,072 rows in one
    cell; bitwise. Timed at the suite's shape, and at the fan-out's."""
    import torch

    from torchmetrics_tpu_torch.ops import stat_counts_segmented, stat_counts_segmented_plain

    arg_sets = [(logits, labels, cells, SUITE_CELLS, NUM_CLASSES) for (logits, labels), cells in zip(batches, cells_list)]
    max_err = _assert_bitwise(stat_counts_segmented(*arg_sets[0]), stat_counts_segmented_plain(*arg_sets[0]), "stat_counts_segmented, suite shape")
    keys, preds, target = fanout
    spilled = torch.where(keys[0] % 97 == 0, -1, keys[0])  # a few rows dropped, as spilled rows are
    for ignore in (None, 3):
        _assert_bitwise(stat_counts_segmented(preds[0], target[0], spilled, FANOUT_CELLS, FANOUT_CLASSES, ignore),
                        stat_counts_segmented_plain(preds[0], target[0], spilled, FANOUT_CELLS, FANOUT_CLASSES, ignore),
                        f"stat_counts_segmented, fan-out shape, ignore_index={ignore}")
    logits2 = torch.cat([batches[0][0], batches[1][0]])
    labels2 = torch.cat([batches[0][1], batches[1][1]])
    preds2 = torch.cat([batches[2][1], batches[3][1]])  # class indices: the labels mode
    layouts = 0
    for num_cells in (1, SUITE_CELLS):
        for layout, (rows, lay_cells) in _segmented_layouts(device, num_cells).items():
            for mode, p in (("scores", logits2[:rows]), ("labels", preds2[:rows])):
                args = (p, labels2[:rows], lay_cells, num_cells, NUM_CLASSES)
                _assert_bitwise(stat_counts_segmented(*args), stat_counts_segmented_plain(*args),
                                f"stat_counts_segmented, {num_cells} cells, {layout}, {mode} mode")
                layouts += 1
    print(f"[kernels] stat_counts_segmented: bitwise equal to its plain version at {BATCH}x{NUM_CLASSES} into {SUITE_CELLS} cells"
          f" and {FANOUT_BATCH}x{FANOUT_CLASSES} into {FANOUT_CELLS} with dropped rows and an ignore_index; and on {layouts} layouts"
          f" (1 and {SUITE_CELLS} cells, scores and labels mode: every row dropped, none, 90% in one cell, 131072 rows in one cell)")
    times = _measure([("kernel", stat_counts_segmented, arg_sets), ("plain", stat_counts_segmented_plain, arg_sets),
                      ("read_floor", _read_floor, [(a[0],) for a in arg_sets])])
    fan_sets = [(preds[i], target[i], keys[i], FANOUT_CELLS, FANOUT_CLASSES) for i in range(NUM_BATCHES)]
    fan_ms, fan_found = _device_ms(stat_counts_segmented, fan_sets)
    n_bytes = BATCH * NUM_CLASSES * 4 + BATCH * 4 * 2 + SUITE_CELLS * 4 * NUM_CLASSES * 4
    bound_ms, bound_by = _bound(n_bytes, BATCH * NUM_CLASSES)  # one compare per score
    fan_bytes = FANOUT_BATCH * FANOUT_CLASSES * 4 + FANOUT_BATCH * 4 * 2 + FANOUT_CELLS * 4 * FANOUT_CLASSES * 4
    print(f"[kernels] stat_counts_segmented at the fan-out's shape ({FANOUT_BATCH}x{FANOUT_CLASSES} into {FANOUT_CELLS} cells):"
          f" device {fan_ms:.5f} ms, bound {_bound(fan_bytes, FANOUT_BATCH * FANOUT_CLASSES)[0]:.5f}; by kernel"
          f" {', '.join(f'{_short_kernel_name(k)} {t / max(1, n):.2f} us' for k, (t, n) in fan_found.items())}")
    return {
        "name": "stat_counts_segmented",
        "route": "cuda",
        "source": "torchmetrics_tpu_torch/csrc/stat_counts.cu",
        "replaces": "torchmetrics_tpu/parallel/sliced.py:280",
        "max_abs_err": max_err,
        "ms": times["kernel"]["device_ms"],
        "plain_ms": times["plain"]["device_ms"],
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "stream_ms": {k: v["stream_ms"] for k, v in times.items()},
        "kernel_only_us": _kernel_only_us(times["kernel"]["found"], K2S_KERNEL),
        "bytes": n_bytes,
        "read_floor_ms": times["read_floor"]["device_ms"],
        "fanout_ms": fan_ms,
        "by_kernel_us": {_short_kernel_name(k): t / max(1, n) for k, (t, n) in times["kernel"]["found"].items()},
    }


def _segmented_layouts(device, num_cells):
    """``{layout: (rows, cells)}`` for K1s's layout checks, made on the card
    from SEED + 42: every row dropped, none dropped, 90% of the rows in one
    cell (the rest spread, some dropped), and 131,072 rows in one cell (more
    than a block's 16-bit count), over 2 x BATCH rows."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 42 + num_cells)

    def spread(n, low):
        return torch.randint(low, num_cells, (n,), generator=gen, device=device, dtype=torch.int32)

    hot = torch.rand(BATCH, generator=gen, device=device) < 0.9
    return {
        "all dropped": (BATCH, torch.full((BATCH,), -1, dtype=torch.int32, device=device)),
        "none dropped": (BATCH, spread(BATCH, 0)),
        "90% in one cell": (BATCH, torch.where(hot, torch.full_like(spread(BATCH, 0), num_cells // 2), spread(BATCH, -1))),
        "131072 rows in one cell": (2 * BATCH, torch.zeros(2 * BATCH, dtype=torch.int32, device=device)),
    }


def check_binned_curve_segmented(device, batches, cells_list):
    """K1s against ``binned_curve_state_segmented_plain`` on the card at the
    suite's shape (65536 x 64 softmax probabilities, T = 128, into 256
    cells), labels mode and matrix mode (one-hot targets, -1 entries);
    bitwise. Then at 1 and 256 cells, both modes, every row dropped, none,
    90% in one cell, 131,072 rows in one cell; bitwise. Timed in labels mode
    with the affine bin index, as the sliced suite calls it."""
    import torch

    from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import _uniform_grid
    from torchmetrics_tpu_torch.ops import binned_curve_state_segmented, binned_curve_state_segmented_plain
    from torchmetrics_tpu_torch.utilities.compute import _linspace_like_jax

    thr = _linspace_like_jax(0.0, 1.0, THRESHOLDS, device=device)
    affine = _uniform_grid(THRESHOLDS)
    plain_sets = [(torch.softmax(logits, 1), thr, labels, True, cells, SUITE_CELLS) for (logits, labels), cells in zip(batches, cells_list)]
    arg_sets = [(*args, affine) for args in plain_sets]
    max_err = _assert_bitwise(binned_curve_state_segmented(*arg_sets[0]), binned_curve_state_segmented_plain(*plain_sets[0]),
                              "binned_curve_state_segmented, labels mode, suite shape")
    p, _, labels, _, cells, _ = plain_sets[1]
    onehot = torch.nn.functional.one_hot(labels.long(), NUM_CLASSES).to(torch.int32)
    onehot[::13] = -1
    _assert_bitwise(binned_curve_state_segmented(p, thr, onehot, False, cells, SUITE_CELLS, affine),
                    binned_curve_state_segmented_plain(p, thr, onehot, False, cells, SUITE_CELLS),
                    "binned_curve_state_segmented, matrix mode, suite shape")
    p2 = torch.cat([plain_sets[0][0], p])
    labels2 = torch.cat([plain_sets[0][2], labels])
    onehot2 = torch.cat([onehot, onehot])
    layouts = 0
    for num_cells in (1, SUITE_CELLS):
        for layout, (rows, lay_cells) in _segmented_layouts(device, num_cells).items():
            for mode, target in (("labels", labels2[:rows]), ("matrix", onehot2[:rows])):
                args = (p2[:rows], thr, target, mode == "labels", lay_cells, num_cells)
                _assert_bitwise(binned_curve_state_segmented(*args, affine), binned_curve_state_segmented_plain(*args),
                                f"binned_curve_state_segmented, {num_cells} cells, {layout}, {mode} mode")
                layouts += 1
    print(f"[kernels] binned_curve_state_segmented: bitwise equal to its plain version at {BATCH}x{NUM_CLASSES} T={THRESHOLDS}"
          f" into {SUITE_CELLS} cells, labels and matrix mode; and on {layouts} layouts (1 and {SUITE_CELLS} cells, both modes:"
          f" every row dropped, none, 90% in one cell, 131072 rows in one cell)")
    times = _measure([("kernel", binned_curve_state_segmented, arg_sets), ("plain", binned_curve_state_segmented_plain, plain_sets[:2]),
                      ("read_floor", _read_floor, [(a[0],) for a in arg_sets])], profile_reps=SKETCH_REPS, timing_reps=SKETCH_REPS * 4)
    n_bytes = BATCH * NUM_CLASSES * 4 + BATCH * 4 * 2 + THRESHOLDS * 4 + SUITE_CELLS * THRESHOLDS * NUM_CLASSES * 4 * 4
    bound_ms, bound_by = _bound(n_bytes, BATCH * NUM_CLASSES * 4)  # the affine bin index and its three compares
    return {
        "name": "binned_curve_state_segmented",
        "route": "cuda",
        "source": "torchmetrics_tpu_torch/csrc/binned_curve_state.cu",
        "replaces": "torchmetrics_tpu/parallel/sliced.py:280",
        "max_abs_err": max_err,
        "ms": times["kernel"]["device_ms"],
        "plain_ms": times["plain"]["device_ms"],
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "stream_ms": {k: v["stream_ms"] for k, v in times.items()},
        "kernel_only_us": _kernel_only_us(times["kernel"]["found"], "binned_curve_cells"),
        "bytes": n_bytes,
        "read_floor_ms": times["read_floor"]["device_ms"],
    }


def _small_sketch_suite(tm, device):
    """JAX's test_sliced.py suite at its size: MulticlassAccuracy, a histogram
    sketch of each row's top probability, exact MulticlassAUROC (cat rows)."""
    import torch

    from torchmetrics_tpu_torch.sketch import hist_init, hist_update

    class _ScoreHistogram(tm.Metric):
        full_state_update = False

        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            self.add_state("hist", hist_init(bins=8, lo=0.0, hi=1.0, device=self.device), dist_reduce_fx="merge")

        def update(self, preds, target):
            self.hist = hist_update(self.hist, preds.max(-1).values)

        def compute(self):
            return self.hist.counts.to(torch.float32) / torch.clamp(self.hist.count, min=1)

    kw = dict(validate_args=False, device=device)
    return tm.MetricCollection(
        {"acc": tm.MulticlassAccuracy(num_classes=5, **kw), "hist": _ScoreHistogram(device=device),
         "auroc_exact": tm.MulticlassAUROC(num_classes=5, thresholds=None, **kw)},
        compute_groups=False,
    )


def phase_sliced(device, batches, smi):
    """The sliced and windowed planes (see the module docstring, phase 14)."""
    import numpy as np
    import torch

    import torchmetrics_tpu_torch as tm
    from torchmetrics_tpu_torch import drift as tdrift
    from torchmetrics_tpu_torch.parallel import SlicedPlan, WindowRing
    from torchmetrics_tpu_torch.wrappers import Running

    t_phase = time.perf_counter()
    kernels = _sliced_kernels()
    out = {}
    fan_keys, fan_preds, fan_target = _fanout_stream(device)
    drift_keys, drift_vals, reference = _drift_stream(device)
    suite_keys = _suite_keys(device)

    # 1) the main path: the three geometries through their plans, the counts from 0
    for wrapper in kernels.values():
        wrapper.launches = 0
    fan_plan = tm.MulticlassAccuracy(num_classes=FANOUT_CLASSES, validate_args=False, device=device).sliced(num_cells=FANOUT_CELLS)
    drift_plan = tdrift.DriftScore(reference=reference, bins=DRIFT_BINS, lo=0.0, hi=1.0, device=device).sliced(num_cells=DRIFT_CELLS)
    suite_plan = _headline_suite(tm, device=device).sliced(num_cells=SUITE_CELLS)
    t0 = time.perf_counter()
    fan_plan.run_scan(fan_keys, (fan_preds, fan_target))
    drift_plan.run_scan(drift_keys, (drift_vals,))
    for i, (logits, labels) in enumerate(batches):
        suite_plan.update(suite_keys[i], logits, labels)
    torch.cuda.synchronize()
    out["first_s"] = time.perf_counter() - t0
    out["launches"] = {name: w.launches for name, w in kernels.items()}
    for name, count in out["launches"].items():
        _require(count > 0, f"sliced: kernel {name} launched {count} times on the main path")
    _require(len(suite_plan._captured) == 1 and len(fan_plan._captured) == 1 and len(drift_plan._captured) == 1,
             "sliced: each plan captures one graph for its one input signature")

    # 2) every checked cell equals an independent metric fed that cohort's rows
    rng = np.random.default_rng(SEED)
    _require(fan_plan.spills == 0 and fan_plan.updates_applied == NUM_BATCHES, "sliced fan-out: spills or update count")
    sample = [int(k) for k in rng.choice(FANOUT_CELLS, SLICED_SAMPLE, replace=False)]
    refs = _cohort_refs(sample, lambda: tm.MulticlassAccuracy(num_classes=FANOUT_CLASSES, validate_args=False, device=device),
                        fan_keys, fan_preds, fan_target)
    for k, ref in refs.items():
        _require_cell_bitwise(fan_plan.export_cell(k), ref, f"sliced fan-out cohort {k}")
    whole = tm.MulticlassAccuracy(num_classes=FANOUT_CLASSES, validate_args=False, device=device)
    for i in range(NUM_BATCHES):
        whole.update(fan_preds[i], fan_target[i])
    carry = fan_plan.state["members"]["MulticlassAccuracy"]
    for name in ("tp", "fp", "tn", "fn"):
        _require(torch.equal(carry[name].sum(0, dtype=torch.int32), getattr(whole, name)), f"sliced fan-out: {name} over all cells")
    out["fanout_occupancy"] = fan_plan.occupancy

    dsample = [int(k) for k in rng.choice(DRIFT_CELLS, SLICED_SAMPLE, replace=False)]
    drefs = _cohort_refs(dsample, lambda: tdrift.DriftScore(reference=reference, bins=DRIFT_BINS, lo=0.0, hi=1.0, device=device),
                         drift_keys, drift_vals)
    scores = drift_plan.compute_all()["DriftScore"]
    drift_err = 0.0
    for k, ref in drefs.items():
        _require_cell_bitwise(drift_plan.export_cell(k), ref, f"sliced drift cohort {k}")
        cell = drift_plan.lookup(k)
        for name, want in zip(scores._fields, ref.compute()):
            drift_err = max(drift_err, abs(float(getattr(scores, name)[cell]) - float(want)))
    _require(drift_err <= SLICED_DRIFT_ATOL, f"sliced drift: compute_all {drift_err:.3e} from per-cohort compute")
    out["drift_err"] = drift_err

    ssample = sorted(int(k) for k in rng.choice(SUITE_COHORTS, SUITE_SAMPLE, replace=False))
    srefs = _cohort_refs(ssample, lambda: _headline_suite(tm, device=device), suite_keys, [b[0] for b in batches], [b[1] for b in batches])
    for k, ref in srefs.items():
        exported = suite_plan.export_cell(k)
        for key in ("acc", "f1", "auroc"):
            _require_cell_bitwise(dict.__getitem__(exported, key), dict.__getitem__(ref, key), f"sliced suite cohort {k} {key}")
    _require(suite_plan.spills == 0 and abs(suite_plan.occupancy - SUITE_COHORTS / SUITE_CELLS) < 1e-9, "sliced suite: table")
    out["suite_carry_bytes"] = sum(suite_plan.state_byte_sizes().values())
    print(
        f"[sliced] main path: sliced_fanout (MulticlassAccuracy({FANOUT_CLASSES}), {FANOUT_CELLS} cells, {NUM_BATCHES} x {FANOUT_BATCH}"
        f" rows, run_scan), drift_cohorts (DriftScore({DRIFT_BINS} bins) vs {DRIFT_REFERENCE} reference values, {DRIFT_CELLS} cells,"
        f" {NUM_BATCHES} x {DRIFT_BATCH}, run_scan) and sliced_suite (the headline suite, {SUITE_COHORTS} cohorts into"
        f" {SUITE_CELLS} cells, {NUM_BATCHES} x {BATCH} x {NUM_CLASSES}, update per batch), first pass with captures"
        f" {out['first_s']:.3f} s; launches {out['launches']} (each plan's warm-up and captured launch); fan-out occupancy"
        f" {out['fanout_occupancy']:.4f}; {SLICED_SAMPLE} fan-out and drift cohorts and {SUITE_SAMPLE} suite cohorts bitwise equal"
        f" to independent metrics, the fan-out's states over all cells to one metric over every row; drift compute_all within"
        f" {drift_err:.2e} of per-cohort compute; the suite's carry {out['suite_carry_bytes']} B"
    )

    # 3) the kernels against their plain versions, and timed
    cells_list = []
    table = (torch.zeros((SUITE_CELLS, 1), dtype=torch.int32, device=device), torch.zeros(SUITE_CELLS, dtype=torch.bool, device=device),
             torch.zeros((), dtype=torch.int32, device=device))
    from torchmetrics_tpu_torch.ops import slice_assign

    for k in suite_keys:
        cells_list.append(slice_assign(*table, k[:, None].contiguous()))
    out["rows"] = [
        dict(check_binned_curve_segmented(device, batches, cells_list), launches=out["launches"]["binned_curve_state_segmented"]),
        dict(check_stat_counts_segmented(device, batches, cells_list, (fan_keys, fan_preds, fan_target)),
             launches=out["launches"]["stat_counts_segmented"]),
        dict(check_slice_assign(device, suite_keys, fan_keys), launches=out["launches"]["slice_assign"]),
    ]

    # 4) timed: the captured passes, the naive fan-out loop, the drift scorer
    fan_runs = [_timed(lambda: fan_plan.run_scan(fan_keys, (fan_preds, fan_target))) for _ in range(SLICED_REPS)]
    out["fanout_sps"] = NUM_BATCHES * FANOUT_BATCH / statistics.median(fan_runs)
    naive = {c: tm.MulticlassAccuracy(num_classes=FANOUT_CLASSES, validate_args=False, device=device) for c in range(FANOUT_CELLS)}
    keys_h = fan_keys[0].cpu().numpy()

    def drive_naive():
        order = np.argsort(keys_h, kind="stable")
        sorted_k = keys_h[order]
        starts = np.flatnonzero(np.r_[True, sorted_k[1:] != sorted_k[:-1]])
        bounds = np.r_[starts, len(sorted_k)]
        index = torch.from_numpy(order).to(device)
        for j, s in enumerate(starts):
            sel = index[s : bounds[j + 1]]
            naive[int(sorted_k[s])].update(fan_preds[0][sel], fan_target[0][sel])

    drive_naive()  # warm: every member at its real sub-batch shape
    for m in naive.values():
        m.reset()
    out["naive_sps"] = FANOUT_BATCH / _timed(drive_naive)
    out["fanout_ratio"] = out["fanout_sps"] / out["naive_sps"]
    drift_runs = [_timed(lambda: drift_plan.run_scan(drift_keys, (drift_vals,))) for _ in range(SLICED_REPS)]
    out["drift_ingest_sps"] = NUM_BATCHES * DRIFT_BATCH / statistics.median(drift_runs)
    drift_plan.compute_all()
    score_runs = [_timed(drift_plan.compute_all) for _ in range(SLICED_REPS)]
    out["drift_windows_per_s"] = DRIFT_CELLS / statistics.median(score_runs)

    def suite_pass():
        for i, (logits, labels) in enumerate(batches):
            suite_plan.update(suite_keys[i], logits, labels)

    suite_runs = [_timed(suite_pass) for _ in range(SLICED_REPS)]
    out["suite_pass_ms"] = statistics.median(suite_runs) * 1e3
    for attempt in range(1, 4):  # torch.profiler on an H100 was seen to drop events of a trace: take it again
        found, busy_us, wall_us = _profile(suite_pass, 1)
        per_pass = {name: sum(n for key, (_, n) in found.items() if f"{kernel}_kernel" in key)
                    for name, kernel in (("slice_assign", "slice_assign"), ("stat_counts_segmented", K2S_KERNEL),
                                         ("binned_curve_state_segmented", "binned_curve_cells"))}
        if all(n == NUM_BATCHES for n in per_pass.values()):
            break
    out.update(suite_busy_us=busy_us, suite_wall_us=wall_us, suite_per_pass=per_pass, suite_traces=attempt)
    top = sorted(found.items(), key=lambda kv: -kv[1][0])[:8]
    out["suite_top"] = [(_short_kernel_name(key), t, n) for key, (t, n) in top]
    print(
        f"[sliced] sliced_fanout: captured run_scan of {NUM_BATCHES} x {FANOUT_BATCH} rows {statistics.median(fan_runs) * 1e3:.3f} ms ="
        f" {out['fanout_sps']:.1f} samples/s (median of {SLICED_REPS}); the naive loop of {FANOUT_CELLS} metric instances over one"
        f" batch (host group-by + one update per cohort) {out['naive_sps']:.1f} samples/s; ratio {out['fanout_ratio']:.1f}; {smi}"
    )
    print(
        f"[sliced] drift_cohorts: ingest (captured run_scan) {out['drift_ingest_sps']:.1f} samples/s, scored windows"
        f" (compute_all over {DRIFT_CELLS} cells) {out['drift_windows_per_s']:.1f} windows/s (medians of {SLICED_REPS}); {smi}"
    )
    print(
        f"[sliced] sliced_suite: a pass of {NUM_BATCHES} replays {out['suite_pass_ms']:.3f} ms ="
        f" {NUM_BATCHES * BATCH / out['suite_pass_ms'] * 1e3:.1f} samples/s (median of {SLICED_REPS}); profiled pass: device busy"
        f" {busy_us:.1f} us of {wall_us:.1f} us = busy share {busy_us / wall_us:.4f} ({attempt} trace(s)); hand-kernel launches"
        f" per pass in the trace {per_pass}; top device ops:"
        f" {'; '.join(f'{name} {t:.1f} us/{n}' for name, t, n in out['suite_top'])}; {smi}"
    )

    # 5) JAX's small suite (accuracy, a histogram sketch, exact AUROC's cat rows) on the card and on the CPU
    srng = np.random.default_rng(SEED + 23)
    small = []
    for _ in range(4):
        x = srng.standard_normal((48, 5))
        e = np.exp(x - x.max(-1, keepdims=True))
        small.append((torch.from_numpy(srng.integers(0, 7, 48).astype(np.int32)), torch.from_numpy((e / e.sum(-1, keepdims=True)).astype(np.float32)),
                      torch.from_numpy(srng.integers(0, 5, 48).astype(np.int32))))
    payloads = []
    for dev in (device, torch.device("cpu")):
        plan = SlicedPlan(_small_sketch_suite(tm, dev), num_cells=32, cat_capacity=4 * 48 + 8, example_batch=tuple(t.to(dev) for t in small[0][1:]))
        for b in small[:2]:
            plan.update(*(t.to(dev) for t in b))
        plan.run_scan([b[0].to(dev) for b in small[2:]], [tuple(t.to(dev) for t in b[1:]) for b in small[2:]])
        payloads.append(plan.save_checkpoint())
    _require_payloads_bitwise(payloads[0], payloads[1], "sliced small sketch suite, card vs CPU")
    print("[sliced] JAX's test suite at its size (48-row batches, 32 cells, 7 cohorts: accuracy, a histogram sketch, exact AUROC"
          " with cat_capacity), update and run_scan: the card's carry bitwise equal to the CPU's")

    # 6) windowed: a ring over the headline suite, and a tumbling ring against Running
    suite = _headline_suite(tm, device=device)
    ring = WindowRing(suite, slots=WINDOW_SLOTS, every_n=WINDOW_EVERY_N)
    for i, batch in enumerate(batches):
        suite.update(*batch)
        ring.observe(i + 1)
    for k in (1, 2, WINDOW_SLOTS):
        ref = _headline_suite(tm, device=device)
        for batch in batches[NUM_BATCHES - WINDOW_EVERY_N * k :]:
            ref.update(*batch)
        _require_values_bitwise(ring.query(last=k), ref.compute(), f"windowed query(last={k})")
    t0 = time.perf_counter()
    ring.query(last=WINDOW_SLOTS)
    torch.cuda.synchronize()
    out["query_ms"] = (time.perf_counter() - t0) * 1e3
    base = tm.SumMetric(device=device)
    tumbling = WindowRing(base, slots=4, every_n=1)
    running = Running(tm.SumMetric(device=device), window=4)
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 24)
    for i in range(9):
        x = torch.randint(-50, 50, (BATCH,), generator=gen, device=device).to(torch.float32)
        base.update(x)
        tumbling.observe(i + 1)
        running.update(x)
        if i + 1 >= 4:
            _require(torch.equal(tumbling.query(last=4), running.compute()), f"windowed: tumbling ring vs Running at {i}")
    print(
        f"[sliced] windowed: WindowRing(slots={WINDOW_SLOTS}, every_n={WINDOW_EVERY_N}) over the headline suite, query(last=1, 2, 4)"
        f" bitwise equal to the suite recomputed over those windows' batches; query(last={WINDOW_SLOTS}) {out['query_ms']:.3f} ms;"
        f" a tumbling ring of 4 equal to Running(SumMetric, window=4) over 9 updates of {BATCH} values"
    )
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[sliced] phase {out['seconds']:.1f} s; {smi}")
    return out


# ----------------------------------------------------------------------- main


# --------------------------------------------------------------- guard (A11)

GUARD_POLICIES = ("mask", "reject", "propagate")
GUARD_DIRTY = (1, 3, 5, 7)  # batches that carry invalid rows; batch 5 is wholly invalid
GUARD_WHOLLY_INVALID = 5
GUARD_NAN_SHARE = 0.01  # rows with one NaN score
GUARD_INF_SHARE = 0.002  # rows with one +Inf score
GUARD_LABEL_SHARE = 0.005  # rows labelled NUM_CLASSES or -1 (half each)
GUARD_REPS = 5


def _guard_batches(device, batches):
    """Copies of the main path's batches with invalid rows injected on the card
    from a seed (see GUARD_*), and numpy's per-batch row masks of them."""
    import numpy as np
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 30)
    out, masks = [], []
    for i, (logits, labels) in enumerate(batches):
        logits, labels = logits.clone(), labels.clone()
        if i in GUARD_DIRTY:
            rows = lambda share: torch.rand(BATCH, generator=gen, device=device) < share  # noqa: E731
            col = torch.randint(0, NUM_CLASSES, (BATCH,), generator=gen, device=device)
            nan_rows, inf_rows, bad = rows(GUARD_NAN_SHARE), rows(GUARD_INF_SHARE), rows(GUARD_LABEL_SHARE)
            idx = torch.arange(BATCH, device=device)
            logits[idx[nan_rows], col[nan_rows]] = float("nan")
            logits[idx[inf_rows], (col[inf_rows] + 1) % NUM_CLASSES] = float("inf")
            high = torch.rand(BATCH, generator=gen, device=device) < 0.5
            labels = torch.where(bad, torch.where(high, NUM_CLASSES, -1), labels).to(labels.dtype)
            if i == GUARD_WHOLLY_INVALID:
                labels = torch.full_like(labels, NUM_CLASSES)
        out.append((logits, labels))
        lg, lb = logits.cpu().numpy(), labels.cpu().numpy()
        nan, inf, dom = np.isnan(lg).any(1), np.isinf(lg).any(1), (lb < 0) | (lb >= NUM_CLASSES)
        masks.append({"nan": nan, "inf": inf, "domain": dom, "invalid": nan | inf | dom})
    return out, masks


def _guarded_suite(tm, policy, device):
    """The flagship suite, each member guarded; the binned AUROC declares no
    contract (as in JAX) and takes the multiclass one with ``contract=``."""
    from torchmetrics_tpu_torch.robustness import enable_guard

    contract = tm.MulticlassStatScores(num_classes=NUM_CLASSES, device=device).domain_contract()
    return tm.MetricCollection(
        {
            "acc": enable_guard(tm.MulticlassAccuracy(num_classes=NUM_CLASSES, average="micro", device=device), policy),
            "f1": enable_guard(tm.MulticlassF1Score(num_classes=NUM_CLASSES, average="macro", device=device), policy),
            "auroc": enable_guard(
                tm.MulticlassAUROC(num_classes=NUM_CLASSES, average="macro", thresholds=THRESHOLDS, device=device),
                policy, contract=contract,
            ),
        },
        compute_groups=False,
    )


def _plain_states_of(suite):
    """Every member's non-guard states (references)."""
    return {key: {n: getattr(m, n) for n in m._defaults if not n.startswith("guard_")} for key, m in suite.items(keep_base=True, copy_state=False)}


def _require_suite_plain_equal(suite, want, what):
    for key, states in want.items():
        for name, value in states.items():
            _assert_bitwise(getattr(suite[key], name), value, f"{what}: {key}.{name}")


def _guard_counters_of(suite):
    from torchmetrics_tpu_torch.robustness import guard_counters

    return {key: guard_counters(m) for key, m in suite.items(keep_base=True, copy_state=False)}


def _numpy_guard_counters(masks, policy, batches_seen=None):
    """What the counters must read after the stream, from numpy's row masks."""
    seen = masks if batches_seen is None else [masks[i] for i in batches_seen]
    total = lambda key: int(sum(int(m[key].sum()) for m in seen))  # noqa: E731
    return {
        "nan_rows": total("nan"),
        "inf_rows": total("inf"),
        "domain_rows": total("domain"),
        "masked_rows": total("invalid") if policy == "mask" else 0,
        "rejected_batches": sum(int(m["invalid"].any()) for m in seen) if policy == "reject" else 0,
        "poisoned": 0,  # integer states only: the probe has no float leaf to trip on
    }


def check_guard_segmented(device, guard_batches, masks):
    """K2s and K1s at the StateGuard's mask shape (``num_cells=1``, invalid
    rows as cell -1) on the card against their plain versions, bitwise, and
    timed beside them (the main path's dirty batches)."""
    import torch

    from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import _uniform_grid
    from torchmetrics_tpu_torch.ops import (
        binned_curve_state_segmented,
        binned_curve_state_segmented_plain,
        stat_counts_segmented,
        stat_counts_segmented_plain,
    )
    from torchmetrics_tpu_torch.utilities.compute import _linspace_like_jax

    cells = [torch.from_numpy(m["invalid"]).to(device).to(torch.int32).neg() for m in masks]  # 0 valid, -1 invalid
    k2 = [(logits, labels, c, 1, NUM_CLASSES) for (logits, labels), c in zip(guard_batches, cells)]
    thr = _linspace_like_jax(0.0, 1.0, THRESHOLDS, device=device)
    k1 = [(torch.softmax(logits, 1), thr, labels, True, c, 1) for (logits, labels), c in zip(guard_batches, cells)]
    affine = _uniform_grid(THRESHOLDS)  # the guard's mask route passes the suite's grid
    rows = []
    for name, kernel, plain, plain_sets, extra, tag, n_bytes, n_ops in (
        # K2 with the row mask at one cell
        ("stat_counts_segmented", stat_counts_segmented, stat_counts_segmented_plain, k2, (), "stat_counts",
         BATCH * NUM_CLASSES * 4 + BATCH * 4 * 2 + 4 * NUM_CLASSES * 4, BATCH * NUM_CLASSES),
        # K1 with the row mask at one cell
        ("binned_curve_state_segmented", binned_curve_state_segmented, binned_curve_state_segmented_plain, k1, (affine,),
         "binned_curve_state", BATCH * NUM_CLASSES * 4 + BATCH * 4 * 2 + THRESHOLDS * 4 + THRESHOLDS * NUM_CLASSES * 4 * 4,
         BATCH * NUM_CLASSES * 4),
    ):
        arg_sets = [(*args, *extra) for args in plain_sets]
        max_err = 0.0
        for i in GUARD_DIRTY:
            max_err = max(max_err, _assert_bitwise(kernel(*arg_sets[i]), plain(*plain_sets[i]), f"{name}, one cell, batch {i}"))
        times = _measure([("kernel", kernel, arg_sets), ("plain", plain, plain_sets[:2]), ("read_floor", _read_floor, [(a[0],) for a in arg_sets])],
                         profile_reps=SKETCH_REPS, timing_reps=SKETCH_REPS * 4)
        bound_ms, bound_by = _bound(n_bytes, n_ops)
        rows.append({
            "name": f"{name}, one cell (StateGuard mask)",
            "route": "cuda",
            "source": "torchmetrics_tpu_torch/csrc/" + ("stat_counts.cu" if name.startswith("stat") else "binned_curve_state.cu"),
            "replaces": "torchmetrics_tpu/robustness/guard.py:310",
            "max_abs_err": max_err,
            "ms": times["kernel"]["device_ms"],
            "plain_ms": times["plain"]["device_ms"],
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": None,
            "stream_ms": {k: v["stream_ms"] for k, v in times.items()},
            "kernel_only_us": _kernel_only_us(times["kernel"]["found"], tag),
            "bytes": n_bytes,
            "read_floor_ms": times["read_floor"]["device_ms"],
        })
    print(f"[kernels] K2s and K1s at the StateGuard's mask shape (num_cells=1, invalid rows as cell -1, {len(GUARD_DIRTY)} dirty"
          f" batches of {BATCH}x{NUM_CLASSES}): bitwise equal to their plain versions")
    return rows


def phase_guard(device, batches, smi):
    """StateGuard (ROADMAP A11) on the card: see the module docstring, phase 18."""
    import tempfile

    import numpy as np
    import torch

    import torchmetrics_tpu_torch as tm
    from torchmetrics_tpu_torch.ops import KERNELS
    from torchmetrics_tpu_torch.parallel import fold_jit_state, make_jit_update
    from torchmetrics_tpu_torch.robustness import CheckpointStore, StreamingEvaluator, enable_guard, guard_counters

    t_phase = time.perf_counter()
    out = {}
    gb, masks = _guard_batches(device, batches)
    invalid_total = int(sum(int(m["invalid"].sum()) for m in masks))
    _require(bool(masks[GUARD_WHOLLY_INVALID]["invalid"].all()) and invalid_total > len(GUARD_DIRTY) * BATCH * 0.01,
             "guard: the injected stream")
    kernels = {name: KERNELS[name] for name in ("stat_counts_segmented", "binned_curve_state_segmented")}

    # 1) the main path: the guarded suite, mask, eager; K2s and K1s counted from 0
    suite = _guarded_suite(tm, "mask", device)
    _zero(kernels)
    for batch in gb:
        suite.update(*batch)
    out["launches"] = _counts(kernels)
    for name, count in out["launches"].items():
        _require(count > 0, f"guard: kernel {name} launched {count} times on the guarded main path")

    # the references: the unguarded suite over the host-filtered rows, over the clean batches, over the raw rows
    def unguarded(select):
        ref = _headline_suite(tm, device=device)
        for i, (logits, labels) in enumerate(gb):
            keep = select(i)
            if keep is None:
                continue
            if keep is True:
                ref.update(logits, labels)
            elif bool(keep.any()):
                ref.update(logits[keep], labels[keep])
        return _plain_states_of(ref)

    valid_t = [torch.from_numpy(~m["invalid"]).to(device) for m in masks]
    want = {
        "mask": unguarded(lambda i: valid_t[i]),
        "reject": unguarded(lambda i: True if not masks[i]["invalid"].any() else None),
        "propagate": unguarded(lambda i: True),
    }
    clean = [i for i, m in enumerate(masks) if not m["invalid"].any()]
    _require_suite_plain_equal(suite, want["mask"], "guard mask eager")
    for key, got in _guard_counters_of(suite).items():
        _require(got == _numpy_guard_counters(masks, "mask"), f"guard mask eager: {key} counters {got}")

    # 2) every policy through eager, suite.fused(), make_jit_update (one step per member) and the sliced plan
    suite_keys = _suite_keys(device)
    paths = {}
    for policy in GUARD_POLICIES:
        counters_want = _numpy_guard_counters(masks, policy)
        eager = suite if policy == "mask" else _guarded_suite(tm, policy, device)
        if policy != "mask":
            for batch in gb:
                eager.update(*batch)
        fused_suite = _guarded_suite(tm, policy, device)
        plan = fused_suite.fused()
        for batch in gb:
            plan.update(*batch)
        plan.fold_back()
        jit_suite = _guarded_suite(tm, policy, device)
        for key, member in jit_suite.items(keep_base=True, copy_state=False):
            step, state = make_jit_update(member)
            for batch in gb:
                state = step(state, *batch)
            fold_jit_state(member, state)
        for tag, s in (("eager", eager), ("fused", fused_suite), ("jit", jit_suite)):
            _require_suite_plain_equal(s, want[policy], f"guard {policy} {tag}")
            for key, got in _guard_counters_of(s).items():
                _require(got == counters_want, f"guard {policy} {tag}: {key} counters {got} vs numpy {counters_want}")
        sliced = _guarded_suite(tm, policy, device).sliced(num_cells=SUITE_CELLS)
        for i, batch in enumerate(gb):
            sliced.update(suite_keys[i], *batch)
        # per row: the invalid rows of a cohort drop out of its cell under mask
        # and reject alike, and each row's verdict is counted in its cell
        row_want = want["propagate" if policy == "propagate" else "mask"]
        for key in ("acc", "f1", "auroc"):
            carry = sliced.state["members"][key]
            for name, value in row_want[key].items():
                _assert_bitwise(carry[name].sum(0, dtype=torch.int32), value, f"guard {policy} sliced: {key}.{name} over all cells")
            per_row = dict(_numpy_guard_counters(masks, "mask"))
            per_row["masked_rows"] = per_row["masked_rows"] if policy == "mask" else 0
            per_row["rejected_batches"] = invalid_total if policy == "reject" else 0
            got = {n[len("guard_"):]: int(carry[n].sum()) for n in carry if n.startswith("guard_") and n != "guard_poisoned"}
            _require(got == {k: v for k, v in per_row.items() if k != "poisoned"}, f"guard {policy} sliced: {key} counters {got}")
        _require(sliced.spills == 0, f"guard {policy} sliced: spills")
        paths[policy] = {"eager": eager, "fused": plan, "sliced": sliced}
    print(
        f"[guard] the flagship suite guarded (acc micro, F1 macro, binned AUROC macro with contract=) over {NUM_BATCHES} x {BATCH} x"
        f" {NUM_CLASSES}, batches {GUARD_DIRTY} dirty ({invalid_total} invalid rows; batch {GUARD_WHOLLY_INVALID} wholly invalid):"
        f" K2s/K1s launches on the mask main path {out['launches']}; mask, reject and propagate through eager, suite.fused(),"
        f" make_jit_update and a SlicedPlan ({SUITE_COHORTS} cohorts into {SUITE_CELLS} cells): integer states bitwise equal to the"
        f" unguarded suite over the host-filtered rows (mask), the clean batches {clean} (reject), the raw rows (propagate);"
        f" counters equal numpy's; the sliced cells sum to the per-row fold"
    )

    # 3) propagate: MeanSquaredError's poison latch trips at the first NaN batch, not before
    first_nan = next(i for i, m in enumerate(masks) if m["nan"].any())
    mse = enable_guard(tm.MeanSquaredError(device=device), "propagate")
    latches = []
    for logits, labels in gb:
        mse.update(logits.max(1).values, labels.to(torch.float32))
        latches.append(guard_counters(mse)["poisoned"])
    _require(latches == [0] * first_nan + [1] * (NUM_BATCHES - first_nan), f"guard propagate: MSE poison latch by batch {latches}")

    # 4) the runner: a snapshot gate on guard_poisoned vetoes every cadence snapshot after the poison
    with tempfile.TemporaryDirectory() as tmp:
        gated = enable_guard(tm.MeanSquaredError(device=device), "propagate")
        store = CheckpointStore(os.path.join(tmp, "store"))
        ev = StreamingEvaluator(gated, store=store, snapshot_every_n=1)
        ev.snapshot_gate = lambda: guard_counters(gated)["poisoned"] == 0
        ev.serve_open()
        for logits, labels in gb:
            ev.serve_step((logits.max(1).values, labels.to(torch.float32)))
        cadence = [int(e["step"]) for e in store._manifest()["snapshots"]]
        ev.serve_close()
        final = [int(e["step"]) for e in store._manifest()["snapshots"]]
    _require(cadence == list(range(1, first_nan + 1)), f"guard runner: cadence snapshots {cadence}, poison at batch {first_nan + 1}")
    _require(final[-1] == NUM_BATCHES, f"guard runner: the explicit final snapshot {final}")
    print(f"[guard] propagate: MSE's guard_poisoned by batch {latches} (first NaN in batch {first_nan}); a StreamingEvaluator"
          f" gated on it wrote cadence snapshots {cadence} only, then the explicit final one at {final[-1]}")

    # 5) kernels at the guard's shape, and the contract's per-row checks against their byte bound
    out["rows"] = check_guard_segmented(device, gb, masks)
    for row in out["rows"]:
        row["launches"] = out["launches"][row["name"].split(",")[0]]
    contract = suite["f1"]._guard_contract
    arg_sets = [(logits, labels.to(torch.int64)) for logits, labels in gb]
    row_ms, found = _device_ms(contract.row_invalid, arg_sets)
    out["row_invalid_ms"] = row_ms
    out["row_invalid_launches"] = sum(n for _, n in found.values()) / PROFILE_REPS
    out["row_invalid_bound_ms"] = _bound(BATCH * NUM_CLASSES * 4 + BATCH * 8, BATCH * NUM_CLASSES * 2)[0]

    # 6) each policy's pass against the unguarded pass, eager and fused, in turns
    plain_suite = _headline_suite(tm, device=device)
    plain_plan = _fresh_plan(plain_suite, gb)
    passes = {"unguarded": (plain_suite, plain_plan)}
    for policy in GUARD_POLICIES:
        passes[policy] = (paths[policy]["eager"], paths[policy]["fused"])

    def one_pass(update):
        return lambda: [update(*b) for b in gb]

    timings = {label: {"eager": [], "fused": []} for label in passes}
    for order in (list(passes), list(passes)[::-1]) * ((GUARD_REPS + 1) // 2):
        for label in order:
            eager, plan = passes[label]
            timings[label]["eager"].append(_timed(one_pass(eager.update)))
            timings[label]["fused"].append(_timed(one_pass(plan.update)))
    out["pass_ms"] = {label: {k: statistics.median(v) * 1e3 for k, v in t.items()} for label, t in timings.items()}
    out["pass_launches"], out["pass_top"] = {}, {}
    for label, (eager, plan) in passes.items():
        found, busy_us, _ = _profile(one_pass(plan.update), 1)
        out["pass_launches"][label] = (sum(n for _, n in found.values()), busy_us)
        top = sorted(found.items(), key=lambda kv: -kv[1][0])[:6]
        out["pass_top"][label] = [(_short_kernel_name(key), t, n) for key, (t, n) in top]
    out["seconds"] = time.perf_counter() - t_phase
    print(
        f"[guard] pass of {NUM_BATCHES} batches, ms (median of {len(timings['mask']['eager'])}, in turns), eager / fused:"
        f" {'; '.join(f'{k} {v['eager']:.3f} / {v['fused']:.3f}' for k, v in out['pass_ms'].items())}; fused pass device kernels"
        f" and busy us: {'; '.join(f'{k} {n} / {b:.1f}' for k, (n, b) in out['pass_launches'].items())};"
        f" DomainContract.row_invalid {row_ms * 1e3:.2f} us device per batch ({out['row_invalid_launches']:.0f} launches,"
        f" plain PyTorch) against its byte bound {out['row_invalid_bound_ms'] * 1e3:.2f} us; phase {out['seconds']:.1f} s; {smi}"
    )
    for label in GUARD_POLICIES:
        print(f"[guard] {label} fused pass, top device ops: {'; '.join(f'{k} {t:.1f} us/{n}' for k, t, n in out['pass_top'][label])}")
    return out


# ----------------------------------------------------------------- obs (A12)

OBS_REPS = 5


def phase_obs(device, batches, smi):
    """The observability plane (ROADMAP A12) on the card: see the module docstring, phase 19."""
    import json as _json
    import re
    import tempfile
    import urllib.request

    import numpy as np
    import torch

    import torchmetrics_tpu_torch as tm
    from torchmetrics_tpu_torch import obs
    from torchmetrics_tpu_torch.obs import device as obs_device
    from torchmetrics_tpu_torch.obs import live
    from torchmetrics_tpu_torch.parallel import fold_jit_state, make_jit_update
    from torchmetrics_tpu_torch.robustness import CheckpointStore, StreamingEvaluator

    t_phase = time.perf_counter()
    out = {}
    obs.clear()

    # 1) the fused pass and the sliced suite's pass, tracing off and on, in turns
    eager_suite = _headline_suite(tm, device=device)
    eager_suite.update(*batches[0])
    eager_suite.update(*batches[1])
    plan = _fresh_plan(_headline_suite(tm, device=device), batches)
    sliced = _headline_suite(tm, device=device).sliced(num_cells=SUITE_CELLS)
    keys = _suite_keys(device)
    drives = {
        "eager": lambda: [eager_suite.update(*b) for b in batches],
        "fused": lambda: [plan.update(*b) for b in batches],
        "sliced": lambda: [sliced.update(keys[i], *b) for i, b in enumerate(batches)],
    }
    for drive in drives.values():
        drive()  # captures and warms every path before any timing
    timings = {(d, t): [] for d in drives for t in ("off", "on")}
    spans = {}
    for order in (("off", "on"), ("on", "off")) * ((OBS_REPS + 1) // 2):
        for traced in order:
            for name, drive in drives.items():
                if traced == "on":
                    with obs.tracing():
                        timings[(name, "on")].append(_timed(drive))
                        spans[name] = len(obs.get_trace())
                else:
                    timings[(name, "off")].append(_timed(drive))
    out["pass_ms"] = {k: statistics.median(v) * 1e3 for k, v in timings.items()}
    out["spans"] = spans
    samples = NUM_BATCHES * BATCH
    print(
        "[obs] passes of the headline suite, tracing off / on (ms, samples/s, spans recorded per pass; medians of"
        f" {len(timings[('fused', 'on')])}, in turns): "
        + "; ".join(
            f"{d} {out['pass_ms'][(d, 'off')]:.3f} / {out['pass_ms'][(d, 'on')]:.3f} ms, {samples / out['pass_ms'][(d, 'off')] * 1e3:.1f} /"
            f" {samples / out['pass_ms'][(d, 'on')] * 1e3:.1f} samples/s, {spans[d]} spans"
            for d in drives
        )
        + f"; {smi}"
    )

    # 2) a trace written as JSON lines and read back with the port's own reader
    with tempfile.TemporaryDirectory() as tmp:
        with obs.tracing():
            eager_suite.update(*batches[0])
            eager_suite.compute()
            recorded = obs.get_trace()
            path = os.path.join(tmp, "smoke.trace.jsonl")
            obs.write_jsonl(path, rank=0)
        events, counters, gauges, meta = obs.read_jsonl(path)
        summary = obs.summarize(events, counters, gauges, dropped=meta.get("dropped", 0))
    _require(events == recorded and meta.get("rank") == 0, "obs: the JSONL trace reads back as recorded")
    _require("MulticlassAccuracy" in summary and "collection.compute" in {e["name"] for e in events}, "obs: the summary")
    print(f"[obs] JSONL trace of one update + compute: {len(events)} events written and read back equal; summary"
          f" {len(summary.splitlines())} lines")

    # 3) device telemetry on the captured make_jit_update step: the drained NaN/Inf gauges equal numpy's counts
    gb, _ = _guard_batches(device, batches)
    n_nan = int(sum(int(torch.isnan(l).sum()) for l, _ in gb))
    n_inf = int(sum(int(torch.isinf(l).sum()) for l, _ in gb))
    step_ms = {}
    metrics = {}
    for tag in ("off", "on"):
        metric = tm.MulticlassF1Score(num_classes=NUM_CLASSES, average="macro", validate_args=False, device=device)
        if tag == "on":
            with obs_device.device_telemetry():
                step, state = make_jit_update(metric, donate=True)
        else:
            step, state = make_jit_update(metric, donate=True)
        for batch in gb:
            state = step(state, *batch)  # the first call runs eagerly, the second captures
        _require(len(step._captured) == 1, f"obs: the jit step ({tag}) captured one graph")
        fold_jit_state(metric, state)
        metrics[tag] = (metric, step, state)
    for tag in ("off", "on", "off", "on"):
        metric, step, state = metrics[tag]
        step_ms.setdefault(tag, []).append(_timed(lambda: [step(state, *b) for b in gb]) / NUM_BATCHES * 1e3)
    out["step_ms"] = {k: min(v) for k, v in step_ms.items()}
    obs.clear()
    metric_on = tm.MulticlassF1Score(num_classes=NUM_CLASSES, average="macro", validate_args=False, device=device)
    with obs_device.device_telemetry():
        step, state = make_jit_update(metric_on)
    for batch in gb:
        state = step(state, *batch)
    fold_jit_state(metric_on, state)
    metric_on.compute()
    g = obs.snapshot()["gauges"]
    _require(g["device.MulticlassF1Score.nan_count"] == n_nan and g["device.MulticlassF1Score.inf_count"] == n_inf
             and g["device.MulticlassF1Score.updates"] == NUM_BATCHES,
             f"obs telemetry: drained NaN {g.get('device.MulticlassF1Score.nan_count')} / Inf"
             f" {g.get('device.MulticlassF1Score.inf_count')} vs numpy {n_nan} / {n_inf}")
    _require(torch.equal(metrics["on"][0].tp, metrics["off"][0].tp), "obs telemetry: states with telemetry on equal off")
    print(f"[obs] device telemetry on the captured make_jit_update step (F1 macro over the guard's stream): drained NaN"
          f" {n_nan} and Inf {n_inf} elements equal numpy's; step {out['step_ms']['off']:.4f} ms off, {out['step_ms']['on']:.4f} ms on"
          f" (per batch, replays); {smi}")

    # 4) the capture records of a fused plan built under tracing
    with obs.tracing():
        traced_plan = _fresh_plan(_headline_suite(tm, device=device), batches)
        traced_plan.update(*batches[0])
        torch.cuda.synchronize()
        records = obs.xla_records()
        rows = obs.compile_rows(obs.get_trace())
    _require(len(records) == 1 and records[0]["kind"] == "fused" and records[0]["flops"] is None, f"obs: capture records {records}")
    _require(rows and rows[0]["first_step_ms"] is not None, "obs: the first_step span joins the record")
    out["capture"] = records[0]
    print(f"[obs] fused plan capture record: warm-up (lower) {records[0]['lower_ms']:.2f} ms, capture (compile)"
          f" {records[0]['compile_ms']:.2f} ms, first replay {rows[0]['first_step_ms']:.3f} ms (host wall clock)")

    # 5) the live publisher sampled at a short interval over a durable run, its OpenMetrics text parsed
    with tempfile.TemporaryDirectory() as tmp:
        with live.publishing(http="127.0.0.1:0", directory=os.path.join(tmp, "status"), cadence_s=0.02, rank=0) as pub:
            host, port = pub.http_address()
            ev = StreamingEvaluator(_headline_suite(tm, device=device), store=CheckpointStore(os.path.join(tmp, "s")), snapshot_every_n=2)
            ev.run(batches)
            body = urllib.request.urlopen(f"http://{host}:{port}/metrics", timeout=10).read().decode()
            ticks = pub.seq
        status = live.read_status_dir(os.path.join(tmp, "status"))
    _require(live.publisher() is None, "obs: the live publisher stopped")
    samples_om = {}
    for line in body.splitlines():
        if line and not line.startswith("#"):
            m = re.match(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})? (\S+)", line)
            _require(m is not None, f"obs: an OpenMetrics line does not parse: {line!r}")
            samples_om[m.group(1)] = float(m.group(3))
    _require(body.endswith("# EOF\n"), "obs: the exposition ends with # EOF")
    _require(samples_om.get("tm_tpu_runner_progress_batches_total") == NUM_BATCHES
             and samples_om.get("tm_tpu_runner_cursor") == NUM_BATCHES
             and samples_om.get("tm_tpu_runner_throughput_samples_per_s", 0) > 0, f"obs live: runner gauges {samples_om}")
    out["live_sps"] = samples_om["tm_tpu_runner_throughput_samples_per_s"]
    out["seconds"] = time.perf_counter() - t_phase
    obs.clear()
    print(f"[obs] live publisher (50 Hz status files, /metrics on localhost) over the durable run: {len(samples_om)} samples,"
          f" runner.progress.batches {samples_om['tm_tpu_runner_progress_batches_total']:.0f}, throughput"
          f" {out['live_sps']:.1f} samples/s (EWMA, host clock), {ticks} status ticks into {len(status)} file(s); phase"
          f" {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------- serve

SERVE_EVERY_N = 4  # the in-process suite stream's snapshot cadence
SERVE_DAEMON_EVERY_N = 2  # the daemon's: a kill after batch 5 resumes from 4 or 6
SERVE_JSON_ROWS = 4096  # rows of a JSON batch (65,536 x 64 floats would be ~80 MB of JSON a batch)
SERVE_KILL_AFTER = 5  # the daemon is SIGKILLed once batch 5 is acked
SERVE_WAIT_S = 120.0  # every wait on a stream, a daemon or a socket
SERVE_CELLS = 256
SERVE_FLEET_ATOL = 1e-6  # the fleet's values against the one-process fold's compute
SERVE_FACTORIES = "torchmetrics_tpu_torch.serve.factories"


def serve_suite(device="cuda"):
    """The flagship suite as a stream target (``chip_smoke:serve_suite``):
    the serve plane's built-in factories have none."""
    import torchmetrics_tpu_torch as tm

    return _headline_suite(tm, device=device)


def _serve_stream(directory, device, **spec):
    from torchmetrics_tpu_torch.serve import Stream, StreamSpec

    stream = Stream(StreamSpec(**spec), directory, device=device)
    stream.start(timeout_s=SERVE_WAIT_S)
    return stream


def _serve_drive(stream, host_batches):
    """Offer every batch (numpy, in process: no JSON) from seq 0, then drain."""
    for seq, batch in enumerate(host_batches):
        reply = stream.offer(seq, batch, block=True, deadline_s=SERVE_WAIT_S)
        _require(bool(reply.get("ok")), f"serve: offer {seq} to {stream.spec.name}: {reply}")
    drained = stream.drain(timeout_s=SERVE_WAIT_S)
    _require(bool(drained.get("ok")) and drained["cursor"] == len(host_batches), f"serve: drain of {stream.spec.name}: {drained}")
    return drained


def _suite_checkpoint(suite):
    return {name: m.save_checkpoint() for name, m in suite.items(keep_base=True, copy_state=True)}


def _json_batches(device):
    """NUM_BATCHES wire batches of SERVE_JSON_ROWS x NUM_CLASSES float32 logits and
    int labels made on the card from SEED + 50, as JSON lists."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 50)
    out = []
    for _ in range(NUM_BATCHES):
        logits = torch.randn((SERVE_JSON_ROWS, NUM_CLASSES), generator=gen, device=device, dtype=torch.float32)
        labels = torch.randint(0, NUM_CLASSES, (SERVE_JSON_ROWS,), generator=gen, device=device, dtype=torch.int32)
        out.append([logits.tolist(), labels.tolist()])
    return out


def _readline_within(stream, seconds, what):
    import select

    ready, _, _ = select.select([stream], [], [], seconds)
    _require(bool(ready), f"serve: no {what} within {seconds:.0f} s")
    return stream.readline()


def _http_json(address, method, path, body=None):
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps({"v": 1, **body}).encode()
    req = urllib.request.Request(f"http://{address[0]}:{address[1]}{path}", data=data, method=method)
    try:
        with urllib.request.urlopen(req, timeout=SERVE_WAIT_S) as resp:
            raw = resp.read()
            return resp.status, json.loads(raw), len(raw)
    except urllib.error.HTTPError as err:
        raw = err.read()
        return err.code, json.loads(raw), len(raw)


class _ServeDaemonProcess:
    """``python -m torchmetrics_tpu_torch.serve serve --device cuda`` over one
    base directory; its ready line parsed; killed on exit whatever happens."""

    def __init__(self, root, base_dir):
        self.root, self.base_dir = root, base_dir
        self.proc = None

    def start(self):
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in (self.root, os.environ.get("PYTHONPATH", "")) if p))
        self.log = open(os.path.join(self.base_dir + ".stderr"), "ab")
        t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "torchmetrics_tpu_torch.serve", "serve", "--base-dir", self.base_dir, "--device", "cuda"],
            stdout=subprocess.PIPE, stderr=self.log, text=True, cwd=self.root, env=env,
        )
        line = _readline_within(self.proc.stdout, SERVE_WAIT_S, "ready line from the daemon")
        if not line:
            self.log.flush()
            with open(self.log.name, "rb") as fh:
                tail = fh.read()[-2000:].decode(errors="replace")
            raise SmokeFailure(f"serve: the daemon exited before its ready line; its stderr ends: {tail}")
        info = json.loads(line)
        _require(info.get("ok") is True and info.get("pid") == self.proc.pid, f"serve: ready line {info}")
        self.ready_s = time.perf_counter() - t0
        self.http, self.socket_path = tuple(info["http"]), info["socket"]
        return self

    def kill(self, sig):
        if self.proc is not None and self.proc.poll() is None:
            self.proc.send_signal(sig)
            try:
                self.proc.wait(timeout=SERVE_WAIT_S)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=SERVE_WAIT_S)
        if self.proc is not None:
            self.proc.stdout.close()
            self.log.close()
        return None if self.proc is None else self.proc.returncode


class _SocketClient:
    """Newline-JSON frames over the daemon's unix-socket ingest plane."""

    def __init__(self, path):
        import socket

        self.sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self.sock.settimeout(SERVE_WAIT_S)
        self.sock.connect(path)
        self.file = self.sock.makefile("rwb")

    def frame(self, obj):
        self.file.write(json.dumps({"v": 1, **obj}, separators=(",", ":")).encode() + b"\n")
        self.file.flush()
        line = self.file.readline()
        _require(bool(line), "serve: the daemon closed the ingest socket")
        return json.loads(line)

    def close(self):
        self.file.close()
        self.sock.close()


def phase_serve(device, batches, kernels, slice_run, smi):
    """The serve plane (ROADMAP A13) on the card: see the module docstring, phase 20."""
    import shutil
    import signal
    import tempfile

    import numpy as np
    import torch

    import torchmetrics_tpu_torch as tm
    from torchmetrics_tpu_torch.drift import HeavyHitters
    from torchmetrics_tpu_torch.ops import KERNELS
    from torchmetrics_tpu_torch.robustness import guard_counters
    from torchmetrics_tpu_torch.serve import FleetAggregator, ServeDaemon, decode_state
    from torchmetrics_tpu_torch.serve.federation import _fold_metric
    from torchmetrics_tpu_torch.serve.stream import decode_batch

    t_phase = time.perf_counter()
    root_dir = os.path.dirname(os.path.abspath(__file__))
    work = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    out = {}
    try:
        # 1) the flagship suite through an in-process Stream at full width:
        # fused, DeviceFeed, snapshot_every_n=4, numpy batches offered (no JSON)
        host = [(logits.cpu().numpy(), labels.cpu().numpy()) for logits, labels in batches]
        expected = _expected_states_plain(batches, device)
        spec = dict(name="suite", target="chip_smoke:serve_suite", fused=True, use_feed=True, snapshot_every_n=SERVE_EVERY_N)
        runs = []

        def served():
            stream = _serve_stream(os.path.join(work, f"suite{len(runs)}", "store"), device, **spec)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            drained = _serve_drive(stream, host)
            torch.cuda.synchronize()
            runs.append((stream, drained, time.perf_counter() - t0))

        _zero(kernels)
        traced = {}
        for _ in range(3):  # a trace that lost launches is taken again
            got = _kernel_launches_traced(served, kernels)
            traced = {k: max(traced.get(k, 0), n) for k, n in got.items()}
            if all(n >= NUM_BATCHES for n in traced.values()):
                break
        wrapped = _counts(kernels)
        _require(all(n >= NUM_BATCHES for n in traced.values()),
                 f"serve stream: K1/K2 launches in the profiler traces {traced}, expected at least {NUM_BATCHES} each")
        _require(all(n > 0 for n in wrapped.values()), f"serve stream: wrapper counts {wrapped}")
        served()  # one more run, untraced, for the time
        stream, drained, served_s = runs[-1]
        for s, d, _ in runs:
            _require_states_bitwise(s.evaluator.metric, expected, "serve stream")
            for key, want in slice_run["values"].items():
                _require(d["results"][key] == float(want), f"serve stream: {key} {d['results'][key]!r} vs the slice's {float(want)!r}")
        _require(stream.status()["restarts"] == 0 and stream.dropped == 0, f"serve stream: {stream.status()}")
        # 1b) a crash loop: the worker dies three times (on batch 5, then twice
        # on its replay of batch 4) and is rebuilt each time; the rebuilt
        # evaluators must free the dead ones' states and graph pools
        from torchmetrics_tpu_torch.robustness import faults

        gc.collect()  # the baseline holds no garbage that the clean stream's capture would collect
        torch.cuda.synchronize()
        base_alloc = torch.cuda.memory_allocated()
        clean = _serve_stream(os.path.join(work, "clean", "store"), device, **spec)
        _serve_drive(clean, host)
        torch.cuda.synchronize()
        clean_alloc = torch.cuda.memory_allocated() - base_alloc
        crashy_spec = dict(spec, name="crashy", max_restarts=5, poison_threshold=5, backoff_base_s=0.01)
        with faults.inject(faults.Fault("fail", "serve.worker.crash", after=5, count=3)):
            crashy = _serve_stream(os.path.join(work, "crashy", "store"), device, **crashy_spec)
            _serve_drive(crashy, host)
        torch.cuda.synchronize()
        crashy_alloc = torch.cuda.memory_allocated() - base_alloc - clean_alloc
        status = crashy.status()
        _require(status["restarts"] == 3 and status["circuit"] == "closed" and crashy.dropped == 0
                 and status["deadletter_depth"] == 0, f"serve crash loop: {status}")
        _require_states_bitwise(crashy.evaluator.metric, expected, "serve crash loop")
        _require(crashy_alloc <= 2 * clean_alloc, f"serve crash loop: {crashy_alloc} B held after 3 rebuilds against"
                                                  f" {clean_alloc} B for a stream that never crashed")
        runs.extend([(clean, None, None), (crashy, None, None)])
        print(f"[serve] crash loop: the suite stream's worker killed 3 times mid-stream and rebuilt (fused plan captured"
              f" anew each time): states bitwise equal to the plain fold, device memory held after the drain"
              f" {crashy_alloc / 2**20:.1f} MiB against {clean_alloc / 2**20:.1f} MiB for a stream that never crashed; {smi}")
        out["crash_loop"] = {"clean_mib": clean_alloc / 2**20, "crashy_mib": crashy_alloc / 2**20}
        suite = serve_suite(device)
        plan = _fresh_plan(suite, batches)
        for batch in batches:
            plan.update(*batch)
        fused_s = statistics.median(_timed(lambda: [plan.update(*b) for b in batches]) for _ in range(5))
        samples = NUM_BATCHES * BATCH
        out["stream"] = {"served_sps": samples / served_s, "served_s": served_s, "fused_sps": samples / fused_s,
                         "traced": traced, "wrapped": wrapped}
        print(f"[serve] stream: the suite served in process (fused, DeviceFeed, snapshot_every_n={SERVE_EVERY_N}, numpy"
              f" offers): {samples / served_s:.1f} samples/s ({served_s * 1e3:.1f} ms from the first offer to the drained"
              f" result, the plan's capture and the final snapshot included) vs the fused plan's steady pass over the same"
              f" batches on the card {samples / fused_s:.1f} samples/s; K1/K2 in the profiler {traced}, wrapper counts"
              f" {wrapped}; states bitwise equal to the plain fold; {smi}")

        # 2) the daemon: a subprocess, the suite created over HTTP, JSON batches
        # through the socket, SIGKILL after batch 5's ack, restart, replay, drain
        wire_batches = _json_batches(device)
        frames = [json.dumps(b) for b in wire_batches]
        decode_ms = statistics.median(_timed(lambda f=f: decode_batch(json.loads(f))) * 1e3 for f in frames)
        dspec = {"name": "suite", "target": "chip_smoke:serve_suite", "fused": True,
                 "snapshot_every_n": SERVE_DAEMON_EVERY_N}
        ref_stream = _serve_stream(os.path.join(work, "ref", "store"), device, **dspec)
        for seq, batch in enumerate(wire_batches):
            _require(bool(ref_stream.offer(seq, batch, block=True, deadline_s=SERVE_WAIT_S).get("ok")), "serve daemon: reference offer")
        ref_drained = ref_stream.drain(timeout_s=SERVE_WAIT_S)
        _require(bool(ref_drained.get("ok")), f"serve daemon: reference drain {ref_drained}")
        ref_state = decode_state(json.loads(json.dumps(ref_stream.export(timeout_s=SERVE_WAIT_S)["state"])))
        base = os.path.join(work, "daemon")
        daemon = _ServeDaemonProcess(root_dir, base).start()
        client = None
        try:
            first_ready_s = daemon.ready_s
            code, reply, _ = _http_json(daemon.http, "POST", "/v1/streams", dspec)
            _require(code == 200 and reply.get("ok") and reply["next_seq"] == 0, f"serve daemon: create {code} {reply}")
            client = _SocketClient(daemon.socket_path)
            t0 = time.perf_counter()
            for seq in range(SERVE_KILL_AFTER + 1):
                ack = client.frame({"op": "ingest", "stream": "suite", "seq": seq, "batch": wire_batches[seq],
                                    "deadline_s": SERVE_WAIT_S})
                _require(bool(ack.get("ok")) and ack["next_seq"] == seq + 1, f"serve daemon: ack of {seq}: {ack}")
            ingest_s = time.perf_counter() - t0
            client.close()
            client = None
            rc = daemon.kill(signal.SIGKILL)
            _require(rc == -signal.SIGKILL, f"serve daemon: SIGKILL left return code {rc}")
            daemon = _ServeDaemonProcess(root_dir, base).start()
            restart_s = daemon.ready_s
            code, status, _ = _http_json(daemon.http, "GET", "/v1/streams/suite")
            _require(code == 200 and status.get("ok"), f"serve daemon: status after the restart {code} {status}")
            resumed_at = int(status["next_seq"])
            _require(0 <= resumed_at <= SERVE_KILL_AFTER + 1 and resumed_at % SERVE_DAEMON_EVERY_N == 0,
                     f"serve daemon: resumed at {resumed_at}")
            client = _SocketClient(daemon.socket_path)
            for seq in range(resumed_at, NUM_BATCHES):
                ack = client.frame({"op": "ingest", "stream": "suite", "seq": seq, "batch": wire_batches[seq],
                                    "deadline_s": SERVE_WAIT_S})
                _require(bool(ack.get("ok")), f"serve daemon: replay ack of {seq}: {ack}")
            code, got, _ = _http_json(daemon.http, "POST", "/v1/streams/suite/drain")
            _require(code == 200 and got.get("ok") and got["cursor"] == NUM_BATCHES, f"serve daemon: drain {code} {got}")
            _require(got["results"] == ref_drained["results"], f"serve daemon: results {got['results']} vs {ref_drained['results']}")
            code, exported, _ = _http_json(daemon.http, "GET", "/v1/streams/suite/state")
            _require(code == 200 and exported.get("ok") and exported["watermark"] == NUM_BATCHES, f"serve daemon: export {code}")
            _require_payloads_bitwise(decode_state(exported["state"])["checkpoint"], ref_state["checkpoint"],
                                      "serve daemon: drained states against the uninterrupted run")
            code, health, _ = _http_json(daemon.http, "GET", "/healthz")
            _require(code == 200, f"serve daemon: /healthz {code} {health}")
            client.close()
            client = None
            rc = daemon.kill(signal.SIGTERM)
            _require(rc == 0, f"serve daemon: the SIGTERM drain exited {rc}")
        finally:
            if client is not None:
                client.close()
            daemon.kill(signal.SIGKILL)
        ingest_sps = (SERVE_KILL_AFTER + 1) * SERVE_JSON_ROWS / ingest_s
        out["daemon"] = {"decode_ms": decode_ms, "ingest_sps": ingest_sps, "restart_s": restart_s,
                         "first_ready_s": first_ready_s, "resumed_at": resumed_at}
        print(f"[serve] daemon: JSON decode {decode_ms:.2f} ms per {SERVE_JSON_ROWS} x {NUM_CLASSES} batch (json.loads +"
              f" decode_batch, host), socket ingest {ingest_sps:.1f} samples/s over {SERVE_KILL_AFTER + 1} acked batches,"
              f" ready in {first_ready_s:.2f} s, restart-to-ready {restart_s:.2f} s after SIGKILL, resumed at seq {resumed_at},"
              f" drained states bitwise equal to the uninterrupted run, /healthz 200; {smi}")

        # 3) the fleet: two port leaf daemons with 4 batches each, one port aggregator
        leaves, agg = {}, None
        try:
            for i in range(2):
                leaf = ServeDaemon(os.path.join(work, f"leaf{i}"), publish=False, device=device).start()
                leaves[f"leaf{i}"] = leaf
                _require(bool(leaf.create_stream(dict(dspec, name="suite", fused=False))["ok"]), "serve fleet: create")
                for seq, batch in enumerate(wire_batches[4 * i: 4 * i + 4]):
                    _require(bool(leaf.ingest("suite", seq, batch, block=True, deadline_s=SERVE_WAIT_S).get("ok")), "serve fleet: ingest")
                _require(bool(leaf.flush("suite").get("ok")), "serve fleet: flush")
            export_ms, export_bytes = [], 0
            for leaf in leaves.values():
                t0 = time.perf_counter()
                code, _, export_bytes = _http_json(leaf.http_address(), "GET", "/v1/state")
                export_ms.append((time.perf_counter() - t0) * 1e3)
                _require(code == 200, f"serve fleet: export {code}")
            agg = FleetAggregator(os.path.join(work, "agg"), pull_interval_s=3600.0, publish=False, device=device).start()
            for name, leaf in sorted(leaves.items()):
                host_, port_ = leaf.http_address()
                _require(bool(agg.add_leaf(name, f"http://{host_}:{port_}").get("ok")), "serve fleet: add_leaf")
            agg.pull_now()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            result = agg.aggregate()
            torch.cuda.synchronize()
            fold_ms = (time.perf_counter() - t0) * 1e3
            _require(not result["errors"] and result["coverage"] == 1.0, f"serve fleet: {result['errors']} {result['coverage']}")
            # the fold's states, through the aggregator's own fold of its slots
            folded = None
            for name in sorted(leaves):
                slot = agg._slots[name]["suite"]
                inst = agg._build_loaded(slot["spec"], slot["kind"], slot["payload"]["checkpoint"])
                if folded is None:
                    folded = inst
                    continue
                members = dict(inst.items(keep_base=True, copy_state=False))
                for mname, member in folded.items(keep_base=True, copy_state=False):
                    _fold_metric(member, members[mname])
            one = serve_suite(device)
            for batch in wire_batches:
                one.update(*decode_batch(batch))
            _require_payloads_bitwise(_suite_checkpoint(folded), _suite_checkpoint(one), "serve fleet: folded states against one fold of all 8")
            want = one.compute()
            for key, value in result["streams"]["suite"]["value"].items():
                _require(abs(value - float(want[key])) <= SERVE_FLEET_ATOL, f"serve fleet: {key} {value} vs {float(want[key])}")
        finally:
            if agg is not None:
                agg.shutdown()
            for leaf in leaves.values():
                leaf.shutdown(drain=False)
        out["fleet"] = {"export_ms": statistics.median(export_ms), "export_bytes": export_bytes, "fold_ms": fold_ms}
        print(f"[serve] fleet: two leaf daemons x 4 JSON batches, a FleetAggregator on the card: /v1/state export"
              f" {statistics.median(export_ms):.2f} ms and {export_bytes} B a leaf (HTTP on localhost), aggregate() fold"
              f" {fold_ms:.2f} ms; integer states bitwise equal to one fold of all 8, values within {SERVE_FLEET_ATOL}; {smi}")

        # 4) the planes: heavy hitters (K3) and per-cohort accuracy (K4, K2s), served and run directly
        sketch_streams, _ = _sketch_streams(device)
        tags = sketch_streams["tags"]
        planes = {}
        k3 = {"cm_track": KERNELS["cm_track"]}
        _zero(k3)
        hh = _serve_stream(os.path.join(work, "hh", "store"), device, name="hh", target=f"{SERVE_FACTORIES}:heavy_hitters")
        t0 = time.perf_counter()
        _serve_drive(hh, [(t.cpu().numpy(),) for t in tags])
        planes["heavy_hitters_s"] = time.perf_counter() - t0
        planes["k3"] = _counts(k3)["cm_track"]
        _require(planes["k3"] >= NUM_BATCHES, f"serve planes: K3 launched {planes['k3']} times under the served stream")
        direct = HeavyHitters(device=device)
        for t in tags:
            direct.update(t)
        _require_payloads_bitwise(hh.evaluator.metric.save_checkpoint(), direct.save_checkpoint(),
                                  "serve planes: heavy hitters against the metric run directly")
        # the plan captures its step: replays pass no wrapper, the profiler counts them
        sliced_k = {name: KERNELS[name] for name in ("slice_assign", "stat_counts_segmented")}
        keys = _suite_keys(device)
        sliced_host = [(keys[i].cpu().numpy(), *host[i]) for i in range(NUM_BATCHES)]
        sliced_runs = []

        def served_sliced():
            stream = _serve_stream(os.path.join(work, f"sliced{len(sliced_runs)}", "store"), device, name="sliced",
                                   target=f"{SERVE_FACTORIES}:sliced_accuracy",
                                   kwargs={"num_classes": NUM_CLASSES, "num_cells": SERVE_CELLS})
            t0 = time.perf_counter()
            _serve_drive(stream, sliced_host)
            torch.cuda.synchronize()
            sliced_runs.append((stream, time.perf_counter() - t0))

        _zero(sliced_k)
        traced_s = {}
        for _ in range(3):  # K2s's device kernel over more than one cell
            got = _kernel_launches_traced(served_sliced, ("slice_assign", K2S_KERNEL))
            got["stat_counts_segmented"] = got.pop(K2S_KERNEL)
            traced_s = {k: max(traced_s.get(k, 0), n) for k, n in got.items()}
            if all(n >= NUM_BATCHES for n in traced_s.values()):
                break
        planes["sliced"], planes["sliced_wrapped"] = traced_s, _counts(sliced_k)
        sl, planes["sliced_s"] = sliced_runs[-1]
        _require(all(n >= NUM_BATCHES for n in traced_s.values()) and all(n > 0 for n in planes["sliced_wrapped"].values()),
                 f"serve planes: K4/K2s under the served stream: profiler {traced_s}, wrappers {planes['sliced_wrapped']}")
        plan = tm.MulticlassAccuracy(num_classes=NUM_CLASSES, validate_args=False, device=device).sliced(num_cells=SERVE_CELLS)
        for i, (logits, labels) in enumerate(batches):
            plan.update(keys[i], logits, labels)
        _require_payloads_bitwise(sl.evaluator.metric.save_checkpoint(), plan.save_checkpoint(),
                                  "serve planes: the sliced stream against the plan run directly")
        out["planes"] = planes
        print(f"[serve] planes: heavy_hitters over {NUM_BATCHES} x {BATCH} Zipf-like tags {planes['heavy_hitters_s'] * 1e3:.1f} ms"
              f" (K3 {planes['k3']} launches), sliced_accuracy({NUM_CLASSES} classes, {SERVE_CELLS} cells) over {NUM_BATCHES} x"
              f" {BATCH} rows {planes['sliced_s'] * 1e3:.1f} ms (K4/K2s in the profiler {planes['sliced']}, wrapper counts"
              f" {planes['sliced_wrapped']}); drained states bitwise equal to the metrics run directly; {smi}")

        # 5) the guard: guarded_binary_accuracy(policy="mask") over the guard phase's poisoned rows
        gb, masks = _guard_batches(device, batches)
        bin_host, filtered = [], tm.BinaryAccuracy(validate_args=False, device=device)
        want_counts = {"nan_rows": 0, "inf_rows": 0, "domain_rows": 0, "masked_rows": 0, "rejected_batches": 0, "poisoned": 0}
        for (logits, labels), m in zip(gb, masks):
            nan_row = torch.from_numpy(m["nan"]).to(device)
            inf_row = torch.from_numpy(m["inf"]).to(device) & ~nan_row
            preds = torch.sigmoid(torch.nan_to_num(logits[:, 0]))
            preds = torch.where(nan_row, float("nan"), torch.where(inf_row, float("inf"), preds))
            target = torch.where(labels >= NUM_CLASSES, 2, torch.where(labels < 0, -1, labels % 2)).to(torch.int32)
            p, t = preds.cpu().numpy(), target.cpu().numpy()
            nan, inf = np.isnan(p), np.isinf(p)
            dom = (np.isfinite(p) & ((p < 0) | (p > 1))) | ~np.isin(t, (0, 1))
            bad = nan | inf | dom
            for key, mask in (("nan_rows", nan), ("inf_rows", inf), ("domain_rows", dom), ("masked_rows", bad)):
                want_counts[key] += int(mask.sum())
            bin_host.append((p, t))
            if not bad.all():
                filtered.update(torch.from_numpy(p[~bad]).to(device), torch.from_numpy(t[~bad]).to(device))
        gs = _serve_stream(os.path.join(work, "guard", "store"), device, name="guarded",
                           target=f"{SERVE_FACTORIES}:guarded_binary_accuracy", kwargs={"policy": "mask"})
        _serve_drive(gs, bin_host)
        got_counts = guard_counters(gs.evaluator.metric)
        _require(got_counts == want_counts, f"serve guard: counters {got_counts} vs numpy {want_counts}")
        _require(gs.status()["guard"]["rollbacks"] == 0, f"serve guard: {gs.status()['guard']}")
        for name in ("tp", "fp", "tn", "fn"):
            _assert_bitwise(getattr(gs.evaluator.metric, name).to(torch.int32), getattr(filtered, name).to(torch.int32),
                            f"serve guard: {name} against the unguarded metric over the valid rows")
        out["guard"] = got_counts
        print(f"[serve] guard: guarded_binary_accuracy(mask) over the poisoned stream: counters {got_counts} equal to"
              f" numpy's; states bitwise equal to the unguarded metric over the valid rows; {smi}")
        for s in [hh, gs, ref_stream] + [r[0] for r in runs] + [r[0] for r in sliced_runs]:
            s.abandon()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[serve] phase {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------- domains

DOMAIN_SEG_CLASSES = 19  # Cityscapes' evaluation classes
DOMAIN_SEG_SHAPE = (8, 512, 1024)  # 8 label maps a batch, Cityscapes at half resolution
DOMAIN_PAIR_ROWS, DOMAIN_PAIR_DIM = 4096, 768  # BERT-base width
DOMAIN_PAIR_BCAST_ROWS = 1024  # manhattan and minkowski: a (1024, 1024, 768) broadcast, 3.2 GB
DOMAIN_PAIR_REF_ROWS = 256  # rows of the broadcast distances held against numpy float64
DOMAIN_NOMINAL_CLASSES = NUM_CLASSES
DOMAIN_FLEISS = (65536, 5, 10)  # subjects, categories, raters
DOMAIN_TABLE = (65536, 8)  # cramers_v_matrix: rows, categorical variables
DOMAIN_QUERIES, DOMAIN_DOCS = 6980, 1000  # MS MARCO passage dev re-ranking: queries x candidates
DOMAIN_MAX_FPR_QUERIES = 256  # RetrievalAUROC(max_fpr=...) runs a host loop over queries: cut to these
DOMAIN_REPS = 10
DOMAIN_SEG_ATOL = 1e-6
DOMAIN_NOMINAL_ATOL = 1e-5
DOMAIN_RETRIEVAL_CPU_ATOL = 1e-6
DOMAIN_RETRIEVAL_ATOL = 1e-5
DOMAIN_PAIR_RTOL = 1e-5  # cosine: of 1; linear: of |x||y|; manhattan, minkowski: of the value
DOMAIN_EUCLID_REL = 1e-6  # euclidean: squared distance within this share of |x|^2 + |y|^2


def _domain_timed(fn, args, n_bytes, n_ops, reps=DOMAIN_REPS):
    """One call's stream ms (CUDA events), its device ms and launches from
    the profiler (None where PROFILE_TRACES traces in a row held no device
    event: torch.profiler on the card was seen to drop a lone cuBLAS
    kernel), and the bound of the same work."""
    stream_ms = _events_ms(lambda: fn(*args), reps)
    try:
        ms, found = _device_ms(fn, [args], reps)
        launches = sum(n for _, n in found.values()) / reps
    except SmokeFailure:
        ms = launches = None
    bound_ms, bound_by = _bound(n_bytes, n_ops)
    return {"ms": ms, "stream_ms": stream_ms, "launches": launches, "bound_ms": bound_ms, "bound_by": bound_by}


def _domain_timed_text(name, t):
    device = "not measured" if t["ms"] is None else f"{t['ms']:.5f}"
    launches = "not counted" if t["launches"] is None else f"{t['launches']:.0f}"
    return f"{name} {device} / {t['stream_ms']:.5f} ({launches}; {t['bound_ms']:.5f}, {t['bound_by']})"


def _segmentation_batches(device):
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 17)
    out = []
    for _ in range(NUM_BATCHES):
        target = torch.randint(0, DOMAIN_SEG_CLASSES, DOMAIN_SEG_SHAPE, generator=gen, device=device, dtype=torch.int32)
        noise = torch.randint(0, DOMAIN_SEG_CLASSES, DOMAIN_SEG_SHAPE, generator=gen, device=device, dtype=torch.int32)
        keep = torch.rand(DOMAIN_SEG_SHAPE, generator=gen, device=device) < 0.7
        out.append((torch.where(keep, target, noise), target))
    return out


def _numpy_segmentation(seg):
    """Per batch, the (N, C, C) float64 confusion counts of each sample
    (rows the target), from ``np.bincount`` on the host."""
    import numpy as np

    c = DOMAIN_SEG_CLASSES
    out = []
    for preds, target in seg:
        p = preds.cpu().numpy().reshape(preds.shape[0], -1).astype(np.int64)
        t = target.cpu().numpy().reshape(target.shape[0], -1).astype(np.int64)
        out.append(np.stack([np.bincount(t[i] * c + p[i], minlength=c * c).reshape(c, c) for i in range(p.shape[0])]).astype(np.float64))
    return out


def _numpy_seg_values(counts, background):
    """MeanIoU and GeneralizedDiceScore (square weights), per class, in float64."""
    import numpy as np

    iou_batches, dice_sum, samples = [], 0.0, 0
    for cm in counts:
        inter = np.diagonal(cm, axis1=1, axis2=2)
        tsum, psum = cm.sum(2), cm.sum(1)
        if not background:
            inter, tsum, psum = inter[:, 1:], tsum[:, 1:], psum[:, 1:]
        union = tsum + psum - inter
        iou_batches.append(np.where(union > 0, inter / np.where(union > 0, union, 1), 0.0).mean(0))
        with np.errstate(divide="ignore"):
            w = 1.0 / tsum**2
        finite_max = np.where(np.isinf(w), 0.0, w).max(1, keepdims=True)
        w = np.where(np.isinf(w), finite_max, w)
        num, den = 2 * inter * w, (tsum + psum) * w
        dice_sum = dice_sum + np.where(den != 0, num / np.where(den != 0, den, 1), 0.0).sum(0)
        samples += cm.shape[0]
    return np.mean(iou_batches, 0), dice_sum / samples


def _domain_segmentation(tm, device, out):
    import importlib

    import numpy as np
    import torch

    from torchmetrics_tpu_torch.utilities.data import to_onehot

    iou = importlib.import_module("torchmetrics_tpu_torch.functional.segmentation.mean_iou")
    gd = importlib.import_module("torchmetrics_tpu_torch.functional.segmentation.generalized_dice")
    c = DOMAIN_SEG_CLASSES
    seg = _segmentation_batches(device)
    counts = _numpy_segmentation(seg)
    errs = {}
    for background in (True, False):
        metrics = {"iou": tm.MeanIoU(c, include_background=background, per_class=True, input_format="index", device=device),
                   "dice": tm.GeneralizedDiceScore(c, include_background=background, per_class=True, input_format="index",
                                                   device=device)}
        for preds, target in seg:
            for m in metrics.values():
                m.update(preds, target)
        want_iou, want_dice = _numpy_seg_values(counts, background)
        errs[f"iou bg={background}"] = _require_close(metrics["iou"].compute().cpu().numpy(), want_iou, DOMAIN_SEG_ATOL,
                                                      f"MeanIoU(include_background={background})")
        errs[f"dice bg={background}"] = _require_close(metrics["dice"].compute().cpu().numpy(), want_dice, DOMAIN_SEG_ATOL,
                                                       f"GeneralizedDiceScore(include_background={background})")
        # the first batch's per-sample, per-class counts on the card equal the port's on the CPU
        p0, t0 = seg[0]
        card = iou._mean_iou_update(p0, t0, c, background, "index")
        host = iou._mean_iou_update(p0.cpu(), t0.cpu(), c, background, "index")
        for g, w, what in zip(card, host, ("intersection", "union")):
            _require(torch.equal(g.cpu().view(torch.int32), w.view(torch.int32)), f"segmentation {what} (bg={background}): card != CPU")
    p0, t0 = seg[0]
    by_index = tm.functional.mean_iou(p0, t0, c, input_format="index")
    by_onehot = tm.functional.mean_iou(to_onehot(p0, c), to_onehot(t0, c), c, input_format="one-hot")
    _require(torch.equal(by_index, by_onehot), "mean_iou: one-hot format != index format")
    pixels = math.prod(DOMAIN_SEG_SHAPE)
    seg_bytes = 2 * pixels * 4 + 2 * DOMAIN_SEG_SHAPE[0] * c * 4
    out["timed"]["iou_update"] = _domain_timed(lambda p, t: iou._mean_iou_update(p, t, c, True, "index"), seg[1], seg_bytes, 5 * pixels * c)
    out["timed"]["dice_update"] = _domain_timed(lambda p, t: gd._generalized_dice_update(p, t, c, True, "square", "index"), seg[1],
                                                seg_bytes, 5 * pixels * c)
    out["errors"]["segmentation"] = max(errs.values())
    del seg


def _pairwise_reference(name, x, y, exponent=3):
    """The float64 numpy distance matrix of ``x``'s rows against ``y``'s."""
    import numpy as np

    x, y = x.astype(np.float64), y.astype(np.float64)
    if name == "cosine":
        return (x / np.linalg.norm(x, axis=1, keepdims=True)) @ (y / np.linalg.norm(y, axis=1, keepdims=True)).T
    if name == "linear":
        return x @ y.T
    if name == "euclidean":
        return np.sqrt(np.maximum((x * x).sum(1)[:, None] + (y * y).sum(1)[None, :] - 2 * x @ y.T, 0))
    rows = []
    for i in range(0, x.shape[0], 32):
        diff = np.abs(x[i:i + 32, None, :] - y[None, :, :])
        rows.append(diff.sum(-1) if name == "manhattan" else ((diff**exponent).sum(-1)) ** (1 / exponent))
    return np.concatenate(rows)


def _domain_pairwise(tm, device, out):
    import numpy as np
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 18)
    x = torch.randn((DOMAIN_PAIR_ROWS, DOMAIN_PAIR_DIM), generator=gen, device=device)
    y = torch.randn((DOMAIN_PAIR_ROWS, DOMAIN_PAIR_DIM), generator=gen, device=device)
    f = tm.functional
    fns = {"cosine": f.pairwise_cosine_similarity, "euclidean": f.pairwise_euclidean_distance,
           "linear": f.pairwise_linear_similarity, "manhattan": f.pairwise_manhattan_distance,
           "minkowski": lambda *a, **k: f.pairwise_minkowski_distance(*a, exponent=3, **k)}
    worst = 0.0
    for name, fn in fns.items():
        broadcast = name in ("manhattan", "minkowski")
        rows = DOMAIN_PAIR_BCAST_ROWS if broadcast else DOMAIN_PAIR_ROWS
        xs, ys = x[:rows], y[:rows]
        checked = DOMAIN_PAIR_REF_ROWS if broadcast else rows
        xn, yn = xs.cpu().numpy(), ys.cpu().numpy()
        for with_y in (True, False):
            other = yn if with_y else xn
            want = _pairwise_reference(name, xn[:checked], other)
            if not with_y:
                np.fill_diagonal(want, 0.0)
            sq_x = (xn[:checked].astype(np.float64) ** 2).sum(1)[:, None]
            sq_y = (other.astype(np.float64) ** 2).sum(1)[None, :]
            if name == "euclidean":
                budget = np.sqrt(DOMAIN_EUCLID_REL * (sq_x + sq_y)) + 1e-6
            elif name == "linear":
                budget = DOMAIN_PAIR_RTOL * np.sqrt(sq_x * sq_y) + 1e-6
            elif name == "cosine":
                budget = np.full(want.shape, DOMAIN_PAIR_RTOL)
            else:
                budget = DOMAIN_PAIR_RTOL * np.abs(want) + 1e-6
            for reduction in (None, "mean"):
                got = fn(xs, ys if with_y else None, reduction=reduction)[:checked].double().cpu().numpy()
                w, b = (want, budget) if reduction is None else (want.mean(-1), budget.mean(-1))
                err = np.abs(got - w)
                _require(bool(np.isfinite(got).all()) and bool((err <= b).all()),
                         f"pairwise {name} (y={'given' if with_y else 'None'}, reduction={reduction}): max |err| {err.max()}"
                         f" over the budget (worst share {(err / b).max():.3f})")
                worst = max(worst, float((err / b).max()))
        n, m, d = rows, rows, DOMAIN_PAIR_DIM
        ops = 2 * n * m * d if not broadcast else (3 if name == "manhattan" else 5) * n * m * d
        out["timed"][f"pairwise_{name}"] = _domain_timed(lambda a, b: fn(a, b), (xs, ys), 2 * n * d * 4 + n * m * 4, ops,
                                                          reps=3 if broadcast else DOMAIN_REPS)
    out["errors"]["pairwise (share of budget)"] = worst
    del x, y


def _numpy_nominal(cm, name, bias=True):
    """Cramér's V, Pearson's C, Theil's U or Tschuprow's T of a contingency
    table (rows the target), in float64, with JAX's bias correction."""
    import numpy as np

    cm = np.asarray(cm, np.float64)
    cm = cm[cm.sum(1) != 0]
    cm = cm[:, cm.sum(0) != 0]
    n = cm.sum()
    r, c = cm.shape
    if name == "theils_u":
        p_xy, p_y = cm / n, cm.sum(1) / n
        with np.errstate(divide="ignore", invalid="ignore"):
            s_xy = np.where(p_xy > 0, p_xy * np.log(p_y[:, None] / np.where(p_xy > 0, p_xy, 1)), 0.0).sum()
        p_x = cm.sum(0) / n
        s_x = -(p_x[p_x > 0] * np.log(p_x[p_x > 0])).sum()
        return 0.0 if s_x == 0 else (s_x - s_xy) / s_x
    expected = np.outer(cm.sum(1), cm.sum(0)) / n
    df = expected.size - r - c + 1
    if df == 0:
        chi2 = 0.0
    else:
        obs = cm
        if df == 1 and bias and name != "pearsons_contingency_coefficient":
            diff = expected - cm
            obs = cm + np.sign(diff) * np.minimum(0.5, np.abs(diff))
        chi2 = ((obs - expected) ** 2 / expected).sum()
    phi2 = chi2 / n
    if name == "pearsons_contingency_coefficient":
        return float(np.clip(np.sqrt(phi2 / (1 + phi2)), 0, 1))
    if bias:
        phi2 = max(0.0, phi2 - (r - 1) * (c - 1) / (n - 1))
        r, c = r - (r - 1) ** 2 / (n - 1), c - (c - 1) ** 2 / (n - 1)
    value = np.sqrt(phi2 / min(r - 1, c - 1)) if name == "cramers_v" else np.sqrt(phi2 / np.sqrt((r - 1) * (c - 1)))
    return float(np.clip(value, 0, 1))


def _numpy_fleiss(counts):
    import numpy as np

    counts = np.asarray(counts, np.float64)
    n_raters = counts.sum(1).max()
    p_i = counts.sum(0) / (counts.shape[0] * n_raters)
    p_j = ((counts**2).sum(1) - n_raters) / (n_raters * (n_raters - 1))
    pe = (p_i**2).sum()
    return (p_j.mean() - pe) / (1 - pe + 1e-5)


def _domain_nominal(tm, device, batches, out):
    import importlib

    import numpy as np
    import torch

    nu = importlib.import_module("torchmetrics_tpu_torch.functional.nominal.utils")
    nm = importlib.import_module("torchmetrics_tpu_torch.functional.nominal.metrics")
    c = DOMAIN_NOMINAL_CLASSES
    classes = {"cramers_v": "CramersV", "pearsons_contingency_coefficient": "PearsonsContingencyCoefficient",
               "theils_u": "TheilsU", "tschuprows_t": "TschuprowsT"}
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 19)
    drop_batches, want = [], {"replace": np.zeros(c * c, np.int64), "drop": np.zeros(c * c, np.int64)}
    for logits, labels in batches:
        pred = torch.argmax(logits, dim=1)
        nan_rows = torch.rand(pred.shape, generator=gen, device=device) < 0.01
        drop_batches.append((torch.where(nan_rows, torch.full(pred.shape, float("nan"), device=device), pred.float()), labels.float()))
        p, t, keep = pred.cpu().numpy().astype(np.int64), labels.cpu().numpy().astype(np.int64), ~nan_rows.cpu().numpy()
        want["replace"] += np.bincount(t * c + p, minlength=c * c)
        want["drop"] += np.bincount(t[keep] * c + p[keep], minlength=c * c)
    errs = []
    for strategy, stream in (("replace", batches), ("drop", drop_batches)):
        metrics = {name: getattr(tm, cls)(num_classes=c, nan_strategy=strategy, device=device) for name, cls in classes.items()}
        for batch in stream:
            for m in metrics.values():
                m.update(*batch)
        cm = want[strategy].reshape(c, c)
        for name, m in metrics.items():
            _require(torch.equal(m.confmat.cpu(), torch.from_numpy(cm.astype(np.float32))),
                     f"{classes[name]}({strategy}): confmat != the numpy np.bincount fold")
            errs.append(_require_close(float(m.compute()), _numpy_nominal(cm, name), DOMAIN_NOMINAL_ATOL, f"{classes[name]}({strategy})"))
    subjects, cats, raters = DOMAIN_FLEISS
    truth = torch.randint(0, cats, (subjects, 1), generator=gen, device=device)
    choice = torch.where(torch.rand((subjects, raters), generator=gen, device=device) < 0.4, truth,
                         torch.randint(0, cats, (subjects, raters), generator=gen, device=device))
    counts = (choice[..., None] == torch.arange(cats, device=device)).sum(1, dtype=torch.int32)
    errs.append(_require_close(float(tm.functional.fleiss_kappa(counts)), _numpy_fleiss(counts.cpu().numpy()), DOMAIN_NOMINAL_ATOL,
                               "fleiss_kappa"))
    rows, variables = DOMAIN_TABLE
    base = torch.randint(0, 6, (rows, 1), generator=gen, device=device)
    noise = torch.randint(0, 9, (rows, variables), generator=gen, device=device)
    table = torch.where(torch.rand((rows, variables), generator=gen, device=device) < 0.3, base, noise)
    got = tm.functional.cramers_v_matrix(table).cpu().numpy()
    tab = table.cpu().numpy()
    want_m = np.ones((variables, variables))
    for i in range(variables):
        for j in range(i + 1, variables):
            vals, inv = np.unique(np.concatenate([tab[:, i], tab[:, j]]), return_inverse=True)
            a, b = inv[:rows], inv[rows:]
            k = len(vals)
            want_m[i, j] = want_m[j, i] = _numpy_nominal(np.bincount(b * k + a, minlength=k * k).reshape(k, k), "cramers_v")
    errs.append(_require_close(got, want_m, DOMAIN_NOMINAL_ATOL, "cramers_v_matrix"))
    logits, labels = batches[1]
    out["timed"]["nominal_update"] = _domain_timed(lambda p, t: nu._nominal_confmat(p, t, c), (logits, labels),
                                                   BATCH * (c + 1) * 4 + c * c * 4, 2 * BATCH * c)
    confmat = torch.from_numpy(want["replace"].reshape(c, c).astype(np.float32)).to(device)
    out["timed"]["cramers_v_compute"] = _domain_timed(lambda m: nm._cramers_v_compute(m, True), (confmat,), c * c * 4 + 4, 10 * c * c)
    out["timed"]["fleiss_kappa"] = _domain_timed(tm.functional.fleiss_kappa, (counts,), subjects * cats * 4 + 4, 4 * subjects * cats)
    out["errors"]["nominal"] = max(errs)


def _retrieval_stream(device):
    """MS MARCO passage dev re-ranking's shape: DOMAIN_QUERIES queries of
    DOMAIN_DOCS candidates, one relevant passage per query and a second for
    about 6% of them; scores rounded to 1e-3 (ties), about 1% of them 0 of
    either sign. Flat (indexes, preds, target) in query order."""
    import torch

    q, d = DOMAIN_QUERIES, DOMAIN_DOCS
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 20)
    scores = torch.rand((q, d), generator=gen, device=device) * 0.6
    hard = torch.rand((q, d), generator=gen, device=device) < 0.003
    scores = torch.where(hard, torch.rand((q, d), generator=gen, device=device), scores)
    target = torch.zeros((q, d), dtype=torch.int32, device=device)
    rows = torch.arange(q, device=device)
    first = torch.randint(0, d, (q,), generator=gen, device=device)
    second = torch.randint(0, d, (q,), generator=gen, device=device)
    target[rows, first] = 1
    extra = torch.rand(q, generator=gen, device=device) < 0.06
    target[rows[extra], second[extra]] = 1
    scores = torch.where(target > 0, 0.6 + 0.4 * torch.rand((q, d), generator=gen, device=device), scores)
    scores = torch.round(scores * 1000) / 1000
    zeros = torch.rand((q, d), generator=gen, device=device)
    scores = torch.where(zeros < 0.005, torch.zeros_like(scores), scores)
    scores = torch.where(zeros > 0.995, -torch.zeros_like(scores), scores)
    indexes = rows[:, None].expand(q, d).to(torch.int32)
    return indexes.reshape(-1), scores.reshape(-1), target.reshape(-1)


def _numpy_retrieval(indexes, preds, target):
    """Every retrieval value of the phase in float64 from a stable argsort of
    each query's negated scores (one row per query: every query has
    DOMAIN_DOCS candidates), and the per-k mean curves."""
    import numpy as np
    from scipy.stats import rankdata

    q, d = DOMAIN_QUERIES, DOMAIN_DOCS
    p = preds.reshape(q, d)
    t = target.reshape(q, d).astype(np.float64)
    order = np.argsort(-p, axis=1, kind="stable")
    s = np.take_along_axis(t, order, 1)
    ps = np.take_along_axis(p, order, 1)
    n_rel = s.sum(1)
    hits = np.cumsum(s, 1)
    k = np.arange(1, d + 1)
    has_pos, n_neg = n_rel > 0, d - n_rel
    first = np.argmax(s > 0, 1)
    r_prec = np.take_along_axis(hits, np.maximum(n_rel.astype(np.int64) - 1, 0)[:, None], 1)[:, 0] / np.maximum(n_rel, 1)
    # tie-averaged DCG@10: each run of equal scores shares its mean gain
    runs = np.cumsum(np.c_[np.zeros((q, 1), np.int64), ps[:, 1:] != ps[:, :-1]], 1) + np.arange(q)[:, None] * d
    mean_gain = (np.bincount(runs.ravel(), weights=s.ravel()) / np.maximum(np.bincount(runs.ravel()), 1))[runs]
    disc = 1 / np.log2(np.arange(10) + 2)
    ideal = (-np.sort(-t, 1))[:, :10] @ disc
    dcg = mean_gain[:, :10] @ disc
    ranks = rankdata(p, axis=1)
    auc = ((ranks * t).sum(1) - n_rel * (n_rel + 1) / 2) / np.maximum(n_rel * n_neg, 1)
    prec_curve = (hits[:, :100] / k[:100]).mean(0)
    rec_curve = (hits[:, :100] / np.maximum(n_rel, 1)[:, None]).mean(0)
    ok = prec_curve >= 0.5
    best = max(zip(rec_curve[ok], k[:100][ok])) if ok.any() else (0.0, 100)
    values = {
        "RetrievalMAP": np.where(has_pos, (hits / k * s).sum(1) / np.maximum(n_rel, 1), 0).mean(),
        "RetrievalMRR": np.where(has_pos, 1 / (first + 1), 0).mean(),
        "RetrievalPrecision": np.where(has_pos, hits[:, 9] / 10, 0).mean(),
        "RetrievalRecall": np.where(has_pos, hits[:, 99] / np.maximum(n_rel, 1), 0).mean(),
        "RetrievalHitRate": (hits[:, 9] > 0).mean(),
        "RetrievalFallOut": np.where(n_neg > 0, (10 - hits[:, 9]) / np.maximum(n_neg, 1), 0).mean(),
        "RetrievalRPrecision": np.where(has_pos, r_prec, 0).mean(),
        "RetrievalNormalizedDCG": np.where(ideal > 0, dcg / np.where(ideal > 0, ideal, 1), 0).mean(),
        "RetrievalAUROC": np.where(has_pos & (n_neg > 0), auc, 0).mean(),
        "RetrievalPrecisionRecallCurve": (prec_curve, rec_curve),
        "RetrievalRecallAtFixedPrecision": best,
    }
    return values


def _numpy_partial_auc(p, t, max_fpr):
    """One query's McClish-standardized partial AUROC up to ``max_fpr``, in float64."""
    import numpy as np

    order = np.argsort(-p, kind="stable")
    p, t = p[order].astype(np.float64), t[order].astype(np.float64)
    last = np.r_[np.flatnonzero(np.diff(p)), p.size - 1]
    tps, fps = np.cumsum(t)[last], np.cumsum(1 - t)[last]
    tpr, fpr = np.r_[0, tps / tps[-1]], np.r_[0, fps / fps[-1]]
    stop = np.searchsorted(fpr, max_fpr, "right")
    x = np.r_[fpr[:stop], max_fpr]
    y = np.r_[tpr[:stop], np.interp(max_fpr, fpr, tpr)]
    area = np.trapezoid(y, x) if hasattr(np, "trapezoid") else np.trapz(y, x)
    lo, hi = 0.5 * max_fpr**2, max_fpr
    return 0.5 * (1 + (area - lo) / (hi - lo))


def _domain_retrieval(tm, device, out):
    import numpy as np
    import torch

    import torchmetrics_tpu_torch.retrieval.base as rbase
    from torchmetrics_tpu_torch.interop import state_from_numpy, state_to_numpy

    indexes, preds, target = _retrieval_stream(device)
    kwargs = {"RetrievalMAP": {}, "RetrievalMRR": {}, "RetrievalPrecision": {"top_k": 10}, "RetrievalRecall": {"top_k": 100},
              "RetrievalHitRate": {"top_k": 10}, "RetrievalFallOut": {"top_k": 10}, "RetrievalRPrecision": {},
              "RetrievalNormalizedDCG": {"top_k": 10}, "RetrievalAUROC": {}, "RetrievalPrecisionRecallCurve": {"max_k": 100},
              "RetrievalRecallAtFixedPrecision": {"min_precision": 0.5, "max_k": 100}}
    metrics = {name: getattr(tm, name)(device=device, **kw) for name, kw in kwargs.items()}
    parts = torch.arange(indexes.numel(), device=device).chunk(NUM_BATCHES)
    update_s = 0.0
    for part in parts:
        for m in metrics.values():
            update_s += _timed(lambda: m.update(preds[part], target[part], indexes=indexes[part]))
    want = _numpy_retrieval(indexes.cpu().numpy(), preds.cpu().numpy(), target.cpu().numpy())
    errs, cpu_errs, compute_s, pack_s = [], [], {}, {}
    pack = rbase._pack_queries

    def timed_pack(*states):  # the host's share of a compute: packing the queries into the grid
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        grid = pack(*states)
        torch.cuda.synchronize()
        pack_s[name] = time.perf_counter() - t0
        return grid

    for name, m in metrics.items():
        got = None

        def run():
            nonlocal got
            got = m.compute()

        rbase._pack_queries = timed_pack
        try:
            compute_s[name] = _timed(run)
        finally:
            rbase._pack_queries = pack
        host = getattr(tm, name)(device="cpu", **kwargs[name])
        state_from_numpy(host, state_to_numpy(m, include_count=True))
        on_cpu = host.compute()
        pairs = list(zip(got, on_cpu)) if isinstance(got, tuple) else [(got, on_cpu)]
        for g, h in pairs:
            _require(g.dtype == h.dtype and g.shape == h.shape, f"{name}: card {g.dtype}{tuple(g.shape)} vs CPU {h.dtype}{tuple(h.shape)}")
            cpu_errs.append(_require_close(g.cpu().double().numpy(), h.double().numpy(), DOMAIN_RETRIEVAL_CPU_ATOL, f"{name}: card vs CPU"))
        w = want[name]
        if name == "RetrievalRecallAtFixedPrecision":
            errs.append(_require_close(float(got[0]), w[0], DOMAIN_RETRIEVAL_ATOL, name))
            _require(int(got[1]) == int(w[1]), f"{name}: k {int(got[1])} vs numpy's {int(w[1])}")
        elif name == "RetrievalPrecisionRecallCurve":
            errs.append(_require_close(got[0].cpu().numpy(), w[0], DOMAIN_RETRIEVAL_ATOL, f"{name} precision"))
            errs.append(_require_close(got[1].cpu().numpy(), w[1], DOMAIN_RETRIEVAL_ATOL, f"{name} recall"))
        else:
            errs.append(_require_close(float(got), w, DOMAIN_RETRIEVAL_ATOL, name))
    grid = pack(*[torch.cat(getattr(metrics["RetrievalMAP"], k)) for k in ("indexes", "preds", "target")])
    from torchmetrics_tpu_torch.functional.retrieval.metrics import _average_precision_kernel

    docs = indexes.numel()
    out["timed"]["retrieval_ap_rows"] = _domain_timed(_average_precision_kernel, grid, docs * 9 + DOMAIN_QUERIES * 4,
                                                      docs * math.ceil(math.log2(DOMAIN_DOCS)), reps=3)
    # RetrievalAUROC(max_fpr): JAX's host loop, one exact binary curve per query, over the first queries
    cut = DOMAIN_MAX_FPR_QUERIES * DOMAIN_DOCS
    partial = tm.RetrievalAUROC(max_fpr=0.1, device=device)
    partial.update(preds[:cut], target[:cut], indexes=indexes[:cut])
    value = None

    def run_partial():
        nonlocal value
        value = partial.compute()

    max_fpr_s = _timed(run_partial)
    p, t = preds[:cut].cpu().numpy().reshape(-1, DOMAIN_DOCS), target[:cut].cpu().numpy().reshape(-1, DOMAIN_DOCS)
    errs.append(_require_close(float(value), np.mean([_numpy_partial_auc(a, b, 0.1) for a, b in zip(p, t)]), DOMAIN_RETRIEVAL_ATOL,
                               "RetrievalAUROC(max_fpr=0.1)"))
    out["errors"]["retrieval"] = max(errs)
    out["errors"]["retrieval card vs CPU"] = max(cpu_errs)
    out["retrieval"] = {"update_ms_per_batch": update_s / NUM_BATCHES / len(metrics) * 1e3, "compute_ms": {k: v * 1e3 for k, v in compute_s.items()},
                        "pack_ms": [min(pack_s.values()) * 1e3, max(pack_s.values()) * 1e3],
                        "pack_share": [min(pack_s[k] / compute_s[k] for k in pack_s), max(pack_s[k] / compute_s[k] for k in pack_s)],
                        "max_fpr_s": max_fpr_s,
                        "max_fpr_ms_per_query": max_fpr_s / DOMAIN_MAX_FPR_QUERIES * 1e3}


def phase_domains(device, batches, smi):
    """Segmentation, pairwise, nominal and retrieval (ROADMAP A14) at full
    width on the card: see the module docstring, phase 21."""
    import torch

    import torchmetrics_tpu_torch as tm

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out = {"timed": {}, "errors": {}}
    _domain_segmentation(tm, device, out)
    _domain_pairwise(tm, device, out)
    _domain_nominal(tm, device, batches, out)
    _domain_retrieval(tm, device, out)
    out["peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
    out["seconds"] = time.perf_counter() - t_phase
    torch.cuda.empty_cache()
    r = out["retrieval"]
    print(
        f"[domains] {smi}; device ms / stream ms per call (launches; bound ms, by):"
        f" {'; '.join(_domain_timed_text(k, v) for k, v in out['timed'].items())};"
        f" retrieval update {r['update_ms_per_batch']:.3f} ms wall a batch a metric, compute ms wall"
        f" {', '.join(f'{k} {v:.1f}' for k, v in r['compute_ms'].items())}, of it _pack_queries"
        f" {r['pack_ms'][0]:.1f}-{r['pack_ms'][1]:.1f} ms ({r['pack_share'][0]:.3f}-{r['pack_share'][1]:.3f} of each compute),"
        f" RetrievalAUROC(max_fpr=0.1) host loop over the first"
        f" {DOMAIN_MAX_FPR_QUERIES} of {DOMAIN_QUERIES} queries {r['max_fpr_s']:.2f} s ({r['max_fpr_ms_per_query']:.2f} ms a query);"
        f" max |err| {', '.join(f'{k} {v:.2e}' for k, v in out['errors'].items())}; peak {out['peak_mib']:.1f} MiB;"
        f" {out['seconds']:.1f} s"
    )
    return out


# ------------------------------------------------------- clustering and audio

CLUSTER_SAMPLES, CLUSTER_K, CLUSTER_DIM = 50000, 1000, 2048  # ImageNet-1k val, 1,000 clusters, ResNet-50's pooled width
CLUSTER_ATOL = 1e-4  # label-pair scores (float32 sums of logs over a 1000 x 1000 table) against numpy float64
CLUSTER_RTOL = 1e-4  # intrinsic scores (float32 sums over 50,000 x 2,048) against numpy float64, relative
SEP_FS, SEP_SPK, SEP_T, SEP_BATCH = 8000, 2, 32000, 16  # WSJ0-2mix as Conv-TasNet evaluates it: 4 s utterances
SEP_ATOL = 1e-3  # SNR, SI-SNR, SI-SDR, SA-SDR, C-SI-SNR in dB against numpy float64
SDR_RTOL, SDR_ATOL = 2e-2, 0.1  # SDR against a float64 scipy.linalg.solve_toeplitz (JAX's own test's budget)
SEP_FILTER = 512
QUALITY_FS, QUALITY_T, QUALITY_BATCH = 16000, 160000, 8  # DNS Challenge test clips: 10 s at 16 kHz
QUALITY_FILTERS = 23
# float32 SRMR against a float64 scipy.signal.lfilter pipeline, relative: at 16 kHz the 4 Hz modulation band's
# poles lie 1.6e-3 from 1, and float32 rounding alone moves SRMR by 0.8-6.6% on speech-shaped clips (scipy's own
# float32 lfilter of the same pipeline does too; 7.3-7.5% on the card's clips)
SRMR_REF_RTOL = 0.1
# the card's SRMR against the CPU's (K5's plain loop, bitwise K5's arithmetic) on SRMR_CPU_SEEDS batches of clips at
# T = SRMR_CPU_T: cuFFT and pocketfft differ in the envelope's last bits, which re-roll the modulation bank's float32
# rounding noise (the same noise that puts float32 SRMR percents from float64). The witness: the card's SRMR on the
# CPU's envelope, which must then agree within SRMR_WITNESS_RTOL (only the windowed energy's sum order differs).
# Read on an H100 80GB HBM3 at 700 W: 2.62e-4, 1.37e-4, 7.57e-5, 1.13e-4 by batch (1.02e-4 on the audio phase's
# own clips), the witness 2.36e-7; each budget is about 4x its largest reading.
SRMR_CPU_RTOL = 1e-3
SRMR_WITNESS_RTOL = 1e-6
SRMR_CPU_T, SRMR_CPU_SEEDS = 16000, 4  # the CPU's plain loop issues ~7 ops a time step: 1 s clips
K5_PLAIN_CHUNK = 2000  # time steps of the plain loop in one CUDA graph; the eager plain loop is timed over as many
K5_STEP_CYCLES = 16  # a stage's recurrence: an add, a multiply, a subtract and an add, 4 cycles each
AUDIO_REPS = 3


def _cluster_streams(device):
    """Two label vectors (a clustering partly aligned with the classes through a
    permutation) and 50,000 x 2,048 features around 1,000 centres, made on the card."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 23)
    n, k, d = CLUSTER_SAMPLES, CLUSTER_K, CLUSTER_DIM
    target = torch.randint(0, k, (n,), generator=gen, device=device, dtype=torch.int32)
    perm = torch.randperm(k, generator=gen, device=device).to(torch.int32)
    preds = torch.where(torch.rand(n, generator=gen, device=device) < 0.6, perm[target.long()],
                        torch.randint(0, k, (n,), generator=gen, device=device, dtype=torch.int32))
    centres = 2.0 * torch.randn((k, d), generator=gen, device=device)
    labels = torch.randint(0, k, (n,), generator=gen, device=device, dtype=torch.int32)
    data = centres[labels.long()] + torch.randn((n, d), generator=gen, device=device)
    return preds, target, data, labels


def _numpy_label_pair_scores(preds, target):
    """The nine label-pair scores in float64 from a numpy contingency table
    (rows: preds' clusters), sklearn's formulas; the expected MI as the sum
    over the distinct marginal pairs of the hypergeometric expectation, its
    pmf from binomial coefficients in log form (``scipy.special.gammaln``)."""
    import numpy as np
    from scipy.special import gammaln

    def log_choose(n, k):
        return gammaln(n + 1) - gammaln(k + 1) - gammaln(n - k + 1)

    pu, pi = np.unique(preds, return_inverse=True)
    tu, ti = np.unique(target, return_inverse=True)
    cont = np.bincount(pi * len(tu) + ti, minlength=len(pu) * len(tu)).reshape(len(pu), len(tu))
    n = float(cont.sum())
    a, b = cont.sum(1).astype(np.float64), cont.sum(0).astype(np.float64)
    nz = cont > 0
    c = cont[nz].astype(np.float64)
    outer = np.outer(a, b)[nz]
    mi = float((c / n * (np.log(c) + np.log(n) - np.log(outer))).sum())

    def entropy(m):
        p = m[m > 0] / n
        return float(-(p * np.log(p)).sum())

    h_p, h_t = entropy(a), entropy(b)
    emi = 0.0
    ua, ca = np.unique(a, return_counts=True)
    ub, cb = np.unique(b, return_counts=True)
    nij = np.arange(1, int(min(a.max(), b.max())) + 1, dtype=np.float64)
    k, bb = nij[None, :], ub[:, None]
    for av, an in zip(ua, ca):
        valid = (k <= av) & (k <= bb) & (bb - k <= n - av)
        kc, rest = np.where(valid, k, 0.0), np.where(valid, bb - k, 0.0)
        pmf = np.where(valid, np.exp(log_choose(av, kc) + log_choose(n - av, rest) - log_choose(n, bb)), 0.0)
        term = k / n * np.log(n * k / (av * bb))
        emi += an * float((cb[:, None] * pmf * term).sum())
    ami = (mi - emi) / (0.5 * (h_p + h_t) - emi)
    nmi = mi / (0.5 * (h_p + h_t))
    hom, com = mi / h_t, mi / h_p
    sum_sq = float((cont.astype(np.float64) ** 2).sum())
    sa, sb = float((a**2).sum()), float((b**2).sum())
    tp, fp, fn = sum_sq - n, sb - sum_sq, sa - sum_sq
    tn = n * n - n - tp - fp - fn
    return cont, emi, {
        "MutualInfoScore": mi, "AdjustedMutualInfoScore": ami, "NormalizedMutualInfoScore": nmi,
        "HomogeneityScore": hom, "CompletenessScore": com, "VMeasureScore": 2 * hom * com / (hom + com),
        "RandScore": (tp + tn) / (n * n - n), "AdjustedRandScore": 2 * (tp * tn - fn * fp) / ((tp + fn) * (fn + tn) + (tp + fp) * (fp + tn)),
        "FowlkesMallowsIndex": tp / np.sqrt((tp + fp) * (tp + fn)),
    }


def _numpy_intrinsic_scores(data, labels):
    """Calinski-Harabasz, Davies-Bouldin and Dunn (p = 2) in float64, the centroids by a sparse one-hot product."""
    import numpy as np
    from scipy.sparse import csr_matrix
    from scipy.spatial.distance import cdist

    data = np.asarray(data, np.float64)
    uniq, inv = np.unique(labels, return_inverse=True)
    k, n = len(uniq), data.shape[0]
    onehot = csr_matrix((np.ones(n), (inv, np.arange(n))), shape=(k, n))
    counts = np.bincount(inv, minlength=k).astype(np.float64)
    cents = (onehot @ data) / counts[:, None]
    dist = np.sqrt(((data - cents[inv]) ** 2).sum(1))
    between = (counts * ((cents - data.mean(0)) ** 2).sum(1)).sum()
    within = (dist**2).sum()
    intra = np.bincount(inv, weights=dist, minlength=k) / counts
    cd = cdist(cents, cents)
    ratio = (intra[:, None] + intra[None, :]) / np.where(cd == 0, np.inf, cd)
    np.fill_diagonal(ratio, -np.inf)
    max_intra = np.full(k, -np.inf)
    np.maximum.at(max_intra, inv, dist)
    return {
        "CalinskiHarabaszScore": between * (n - k) / (within * (k - 1)),
        "DaviesBouldinScore": ratio.max(1).mean(),
        "DunnIndex": cd[np.triu_indices(k, 1)].min() / max_intra.max(),
    }


def _audio_clustering(tm, device, out):
    """The twelve clustering classes at ImageNet-1k validation's size (see the module docstring, phase 22)."""
    import importlib

    import numpy as np
    import torch

    cu = importlib.import_module("torchmetrics_tpu_torch.functional.clustering.utils")
    emi_mod = importlib.import_module("torchmetrics_tpu_torch.functional.clustering.adjusted_mutual_info_score")
    preds, target, data, labels = _cluster_streams(device)
    t0 = time.perf_counter()
    cont, emi_ref, pair_ref = _numpy_label_pair_scores(preds.cpu().numpy(), target.cpu().numpy())
    intr_ref = _numpy_intrinsic_scores(data.cpu().numpy(), labels.cpu().numpy())
    out["cluster_reference_s"] = time.perf_counter() - t0
    got_cont = cu.calculate_contingency_matrix(preds, target)
    _require(got_cont.dtype == torch.int32 and np.array_equal(got_cont.cpu().numpy(), cont),
             "clustering: the contingency table differs from numpy's bincount")
    errs, emi_calls = {}, []
    emi_fn = emi_mod.expected_mutual_info_score

    def timed_emi(contingency, n_samples):  # the AMI compute's host EMI, timed where it runs
        t0 = time.perf_counter()
        value = emi_fn(contingency, n_samples)
        emi_calls.append((time.perf_counter() - t0, float(value)))
        return value
    out["cluster_compute_s"] = {}
    for name in (*pair_ref, *intr_ref):
        intrinsic = name in intr_ref
        metric = getattr(tm, name)(device=device)
        a, b = (data, labels) if intrinsic else (preds, target)
        for part in range(NUM_BATCHES):
            rows = slice(part * CLUSTER_SAMPLES // NUM_BATCHES, (part + 1) * CLUSTER_SAMPLES // NUM_BATCHES)
            metric.update(a[rows], b[rows])
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        emi_mod.expected_mutual_info_score = timed_emi
        try:
            t0 = time.perf_counter()
            value = float(metric.compute())
            torch.cuda.synchronize()
            out["cluster_compute_s"][name] = time.perf_counter() - t0
        finally:
            emi_mod.expected_mutual_info_score = emi_fn
        if intrinsic:
            out.setdefault("cluster_peak_mib", {})[name] = torch.cuda.max_memory_allocated() / 2**20
            want = intr_ref[name]
            err = abs(value - want) / abs(want)
            _require(np.isfinite(value) and err <= CLUSTER_RTOL, f"{name}: {value} vs numpy float64 {want} (relative {err})")
        else:
            err = _require_close(value, pair_ref[name], CLUSTER_ATOL, name)
        errs[name] = err
        del metric
    _require(len(emi_calls) == 1, f"clustering: the EMI ran {len(emi_calls)} times, not once in the AMI compute")
    out["emi_s"] = emi_calls[0][0]
    errs["expected MI"] = _require_close(emi_calls[0][1], emi_ref, CLUSTER_ATOL, "expected mutual information")
    out["errors"].update(errs)
    out["cluster_values"] = {**pair_ref, **intr_ref}
    del preds, target, data, labels


def _sep_streams(device):
    """WSJ0-2mix-shaped separation outputs: 16 mixtures of 2 speakers, 4 s at 8 kHz; each estimate a
    leak of the other speaker plus noise, speaker order swapped in half the mixtures."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 24)
    target = torch.randn((SEP_BATCH, SEP_SPK, SEP_T), generator=gen, device=device)
    est = 0.9 * target + 0.2 * target.flip(1) + 0.1 * torch.randn(target.shape, generator=gen, device=device)
    swap = torch.arange(SEP_BATCH, device=device) % 2 == 1
    preds = torch.where(swap[:, None, None], est.flip(1), est)
    return preds, target


def _numpy_si_sdr(p, t, zero_mean=False, scale_invariant=True, axes=(-1,)):
    import numpy as np

    eps = np.finfo(np.float32).eps
    p, t = np.asarray(p, np.float64), np.asarray(t, np.float64)
    if zero_mean:
        p, t = p - p.mean(-1, keepdims=True), t - t.mean(-1, keepdims=True)
    if scale_invariant:
        t = ((p * t).sum(axes, keepdims=True) + eps) / ((t**2).sum(axes, keepdims=True) + eps) * t
    return 10 * np.log10(((t**2).sum(axes) + eps) / (((t - p) ** 2).sum(axes) + eps))


def _numpy_sdr(p, t, filter_length):
    import numpy as np
    from scipy.linalg import solve_toeplitz

    p, t = np.asarray(p, np.float64).reshape(-1, p.shape[-1]), np.asarray(t, np.float64).reshape(-1, t.shape[-1])
    t = t / np.maximum(np.linalg.norm(t, axis=-1, keepdims=True), 1e-6)
    p = p / np.maximum(np.linalg.norm(p, axis=-1, keepdims=True), 1e-6)
    n_fft = 2 ** int(np.ceil(np.log2(p.shape[-1] + t.shape[-1] - 1)))
    tf = np.fft.rfft(t, n_fft)
    r = np.fft.irfft(np.abs(tf) ** 2, n_fft)[:, :filter_length]
    b = np.fft.irfft(np.conj(tf) * np.fft.rfft(p, n_fft), n_fft)[:, :filter_length]
    coh = np.array([bb @ solve_toeplitz(rr, bb) for rr, bb in zip(r, b)])
    return 10 * np.log10(coh / (1 - coh))


def _audio_separation(tm, device, out):
    """SI-SDR, SA-SDR, SNR, SI-SNR, C-SI-SNR, SDR and PIT at WSJ0-2mix's shape (see the module docstring, phase 22)."""
    import itertools

    import numpy as np
    import torch

    f = tm.functional
    preds, target = _sep_streams(device)
    spec = lambda x: torch.view_as_real(torch.stft(x.reshape(-1, SEP_T), 256, 64, window=torch.hann_window(256, device=device),
                                                   return_complex=True)).reshape(*x.shape[:-1], 129, -1, 2)  # noqa: E731
    sp, st = spec(preds), spec(target)
    pn, tn, spn, stn = (x.cpu().numpy() for x in (preds, target, sp, st))
    refs = {
        "SignalNoiseRatio": (f.signal_noise_ratio, (preds, target), _numpy_si_sdr(pn, tn, scale_invariant=False)),
        "ScaleInvariantSignalDistortionRatio": (f.scale_invariant_signal_distortion_ratio, (preds, target), _numpy_si_sdr(pn, tn)),
        "ScaleInvariantSignalNoiseRatio": (f.scale_invariant_signal_noise_ratio, (preds, target), _numpy_si_sdr(pn, tn, True)),
        "SourceAggregatedSignalDistortionRatio": (f.source_aggregated_signal_distortion_ratio, (preds, target),
                                                  _numpy_si_sdr(pn, tn, axes=(-1, -2))),
        "ComplexScaleInvariantSignalNoiseRatio": (f.complex_scale_invariant_signal_noise_ratio, (sp, st),
                                                  _numpy_si_sdr(spn.reshape(*spn.shape[:-3], -1), stn.reshape(*stn.shape[:-3], -1))),
        "SignalDistortionRatio": (f.signal_distortion_ratio, (preds, target), _numpy_sdr(pn, tn, SEP_FILTER).reshape(SEP_BATCH, SEP_SPK)),
    }
    pair_si = _numpy_si_sdr(pn[:, None, :, :], tn[:, :, None, :])  # (B, target speaker, pred speaker)
    pair_sdr = _numpy_sdr(np.broadcast_to(pn[:, None], (SEP_BATCH, SEP_SPK, SEP_SPK, SEP_T)),
                          np.broadcast_to(tn[:, :, None], (SEP_BATCH, SEP_SPK, SEP_SPK, SEP_T)), SEP_FILTER).reshape(SEP_BATCH, SEP_SPK, SEP_SPK)
    for name, mtx, fn in (("PIT(SI-SDR)", pair_si, f.scale_invariant_signal_distortion_ratio), ("PIT(SDR)", pair_sdr, f.signal_distortion_ratio)):
        perms = list(itertools.permutations(range(SEP_SPK)))
        scores = np.stack([mtx[:, np.arange(SEP_SPK), list(p)].mean(-1) for p in perms], -1)
        refs[name] = (lambda p, t, fn=fn: f.permutation_invariant_training(p, t, fn)[0], (preds, target), scores.max(-1))
        best = np.asarray(perms)[scores.argmax(-1)]
        _require(np.array_equal(f.permutation_invariant_training(preds, target, fn)[1].cpu().numpy(), best),
                 f"{name}: the best permutations differ from numpy's")
        _require(bool((best[1::2] == [1, 0]).all()) and bool((best[::2] == [0, 1]).all()), f"{name}: the swap was not undone")
    errs = {}
    solved = ("SignalDistortionRatio", "PIT(SDR)")  # the distortion filter's float32 Toeplitz solve
    for name, (fn, args, want) in refs.items():
        got = fn(*args).double().cpu().numpy()
        err = np.abs(got - want)
        budget = SDR_ATOL + SDR_RTOL * np.abs(want) if name in solved else SEP_ATOL
        _require(got.shape == want.shape and bool(np.isfinite(got).all()) and bool((err <= budget).all()),
                 f"{name}: max |err| {err.max()} dB against numpy float64 over the budget")
        errs[f"{name}, dB"] = float(err.max())
        cls = name if not name.startswith("PIT") else None
        if cls:  # the module class over the batch in two halves: its mean against numpy's
            metric = getattr(tm, cls)(device=device)
            for half in (slice(0, SEP_BATCH // 2), slice(SEP_BATCH // 2, SEP_BATCH)):
                metric.update(*(a[half] for a in args))
            _require_close(float(metric.compute()), want.mean(), float(np.max(budget)), f"{cls} (module)")
        n_in = sum(a.numel() * a.element_size() for a in args)
        ops = 6 * sum(a.numel() for a in args) if name not in solved else \
            SEP_BATCH * SEP_SPK * (SEP_SPK if name.startswith("PIT") else 1) * (SEP_FILTER**3 // 3 + 30 * SEP_T)
        out["timed"][name] = _domain_timed(fn, args, n_in + got.size * 4, ops, reps=AUDIO_REPS)
    pit = tm.PermutationInvariantTraining(f.scale_invariant_signal_distortion_ratio, device=device)
    for half in (slice(0, SEP_BATCH // 2), slice(SEP_BATCH // 2, SEP_BATCH)):
        pit.update(preds[half], target[half])
    _require_close(float(pit.compute()), refs["PIT(SI-SDR)"][2].mean(), SEP_ATOL, "PermutationInvariantTraining (module)")
    out["errors"].update(errs)


def _speechlike(device, gen, batch, length, fs):
    """Speech-shaped test clips made on the card: pink-ish noise under a
    4 Hz syllable envelope with pauses, a reverberant tail by an exponential
    impulse response (FFT convolution), peak 0.9."""
    import torch

    noise = torch.randn((batch, length), generator=gen, device=device)
    freqs = torch.fft.rfftfreq(length, 1 / fs, device=device)
    pink = torch.fft.irfft(torch.fft.rfft(noise) / freqs.clamp(min=50) ** 0.5, length)
    t = torch.arange(length, device=device) / fs
    rate = 3.0 + 2.0 * torch.rand((batch, 1), generator=gen, device=device)
    envelope = torch.sin(torch.pi * rate * t).abs() ** 2 * (torch.sin(2 * torch.pi * 0.25 * t) > -0.5)
    taps = torch.exp(-torch.arange(fs // 4, device=device) / (0.05 * fs)) * torch.randn(fs // 4, generator=gen, device=device)
    dry = pink * envelope
    wet = torch.fft.irfft(torch.fft.rfft(dry, 2 * length) * torch.fft.rfft(taps, 2 * length), 2 * length)[:, :length]
    clip = dry + 0.3 * wet / wet.abs().amax(-1, keepdim=True) * dry.abs().amax(-1, keepdim=True)
    return 0.9 * clip / clip.abs().amax(-1, keepdim=True)


def _numpy_srmr(x, fs, n_filters=QUALITY_FILTERS, low_freq=125, min_cf=4):
    """SRMR in float64 with ``norm`` False and True, ``{norm: values}``:
    the port's filter designs (the JAX package's, copied), every IIR by
    ``scipy.signal.lfilter``, the Hilbert envelope by numpy's FFT at the same
    padded length (one front end for both), the windowed energies frame by frame."""
    import importlib
    from math import ceil

    import numpy as np
    from scipy.signal import lfilter

    sr = importlib.import_module("torchmetrics_tpu_torch.functional.audio.srmr")
    x = np.asarray(x, np.float64)
    x = x / np.maximum(np.abs(x).max(-1, keepdims=True), 1.0)
    batch, length = x.shape
    co = sr._make_erb_filters(fs, n_filters, low_freq)
    gt = np.empty((batch, n_filters, length))
    for ch in range(n_filters):
        y = x
        for k in (1, 2, 3, 4):
            y = lfilter([co[ch, 0], co[ch, k], co[ch, 5]], co[ch, 6:9], y, axis=-1)
        gt[:, ch] = y / co[ch, 9]
    n = length if length % 16 == 0 else ceil(length / 16) * 16
    h = np.zeros(n)
    h[0] = 1
    if n % 2 == 0:
        h[n // 2] = 1
        h[1 : n // 2] = 2
    else:
        h[1 : (n + 1) // 2] = 2
    env = np.abs(np.fft.ifft(np.fft.fft(gt, n=n, axis=-1) * h, axis=-1)[..., :length])
    del gt
    w_len, w_inc = ceil(0.256 * fs), ceil(0.064 * fs)
    frames = int(1 + (length - w_len) // w_inc) if length >= w_len else 1
    w2 = np.hamming(w_len + 2)[:w_len] ** 2
    erbs = np.flipud(sr._calc_erbs(low_freq, fs, n_filters))
    out = {}
    for norm in (False, True):
        _, mf_b, mf_a, lower, _ = sr._modulation_filterbank_and_cutoffs(min_cf, 30 if norm else 128, 8, float(fs), 2)
        energy = np.empty((batch, n_filters, 8, frames))
        for k in range(8):
            sq = lfilter(mf_b[k], mf_a[k], env, axis=-1) ** 2
            sq = np.pad(sq, ((0, 0), (0, 0), (0, max(0, (frames - 1) * w_inc + w_len - length))))
            for fr in range(frames):
                energy[:, :, k, fr] = sq[..., fr * w_inc : fr * w_inc + w_len] @ w2
        if norm:
            peak = energy.mean(1, keepdims=True).max(2, keepdims=True).max(3, keepdims=True)
            energy = np.clip(energy, peak * 10**-3, peak)
        avg = energy.mean(-1)
        perc = avg.sum(2) * 100 / avg.reshape(batch, -1).sum(-1)[:, None]
        k90 = np.argmax(np.flip(perc, -1).cumsum(-1) > 90, axis=-1)
        kstar = 4 + (lower[4:8][None, :] <= erbs[k90][:, None]).sum(-1)
        out[norm] = avg[:, :, :4].sum((1, 2)) / np.array([avg[i, :, 4 : kstar[i]].sum() for i in range(batch)])
    return out


def _device_ms_or_events(fn, args, stream_ms):
    """``fn(*args)``'s device ms from the profiler, its kernels, and the
    source of the ms; where PROFILE_TRACES traces in a row held no device
    event (torch.profiler on the card was seen to go blind late in a long
    process), the CUDA-event stream ms of the same call, and the source
    says so (it goes into the kernels line)."""
    try:
        ms, found = _device_ms(fn, [args], AUDIO_REPS)
        return ms, found, "profiler"
    except SmokeFailure:
        return stream_ms, {}, "cuda events"


class _GraphedSteps:
    """The plain loop's stage walk (``ops.biquad.stage_steps``) replayed from
    a CUDA graph of K5_PLAIN_CHUNK steps, one per row count: the same ops on
    the same values, one launch each, without the host's cost of launching
    them (the eager loop issues ~7 ops a time step, 4.5 million for the
    gammatone at 10 s). A chunk's inputs and carry go in by copies; the tail
    short of a chunk runs eagerly."""

    def __init__(self):
        self.graphs = {}

    def _capture(self, rows, device):
        import torch

        from torchmetrics_tpu_torch.ops.biquad import stage_steps

        cols = [torch.zeros((rows, K5_PLAIN_CHUNK), device=device) for _ in range(4)]  # bx0, bx1, bx2, out
        vecs = [torch.zeros(rows, device=device) for _ in range(4)]  # a1, a2, z1, z2
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            stage_steps(*cols[:3], *vecs, cols[3])  # warm-up outside the capture
        torch.cuda.current_stream(device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            z1, z2 = stage_steps(*cols[:3], *vecs, cols[3])
            vecs[2].copy_(z1)
            vecs[3].copy_(z2)
        return graph, cols, vecs

    def __call__(self, bx0, bx1, bx2, a1, a2, z1, z2, out):
        from torchmetrics_tpu_torch.ops.biquad import stage_steps

        rows, length = bx0.shape
        if rows not in self.graphs:
            self.graphs[rows] = self._capture(rows, bx0.device)
        graph, (c0, c1, c2, c_out), vecs = self.graphs[rows]
        for dst, src in zip(vecs, (a1, a2, z1, z2)):
            dst.copy_(src)
        whole = length - length % K5_PLAIN_CHUNK
        for t0 in range(0, whole, K5_PLAIN_CHUNK):
            for dst, src in ((c0, bx0), (c1, bx1), (c2, bx2)):
                dst.copy_(src[:, t0 : t0 + K5_PLAIN_CHUNK])
            graph.replay()
            out[:, t0 : t0 + K5_PLAIN_CHUNK].copy_(c_out)
        z1, z2 = vecs[2].clone(), vecs[3].clone()
        if whole < length:
            z1, z2 = stage_steps(bx0[:, whole:], bx1[:, whole:], bx2[:, whole:], a1, a2, z1, z2, out[:, whole:])
        return z1, z2


def _quality_clips(device):
    """The speech-quality clips (QUALITY_BATCH x QUALITY_T, seeded) and the generator after them."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 25)
    return _speechlike(device, gen, QUALITY_BATCH, QUALITY_T, QUALITY_FS), gen


def _k5_banks(clips):
    """K5's two calls in SRMR on ``clips`` (default arguments): ``(bank,
    stages, (x, num, den))`` with SRMR's own inputs, the preconditioned clips
    into the gammatone cascade and their envelope into the modulation bank."""
    import importlib

    import torch

    sr = importlib.import_module("torchmetrics_tpu_torch.functional.audio.srmr")
    peak = clips.abs().amax(-1, keepdim=True)
    wave = clips / torch.where(peak > 1, peak, torch.ones_like(peak))  # SRMR's own precondition
    fcoefs = sr._make_erb_filters(QUALITY_FS, QUALITY_FILTERS, 125)
    num, den, _ = sr._gammatone_banks(fcoefs)
    env = sr._hilbert_envelope(sr._erb_filterbank(wave, fcoefs)).reshape(-1, clips.shape[-1])
    _, mf_b, mf_a, _, _ = sr._modulation_filterbank_and_cutoffs(4, 128, 8, float(QUALITY_FS), 2)
    mb, ma = torch.tensor(mf_b, dtype=torch.float32)[:, None], torch.tensor(mf_a, dtype=torch.float32)[:, None]
    return (("gammatone", 4, (wave, num, den)), ("modulation", 1, (env, mb, ma)))


def time_biquad_cascade(device):
    """K5's rows, timed early in the run (torch.profiler has been seen to go
    blind late in a long process), on the audio phase's inputs at
    T = QUALITY_T: device ms, stream ms, bound, chain floor, read floor. The
    audio phase adds the launches, the check and the plain loop's time."""
    import torch

    from torchmetrics_tpu_torch.ops import biquad_cascade

    clock_hz = _sm_clock_hz()
    regs = [int(w) for line in BUILD_LOGS.get("biquad", "").splitlines() if "registers" in line for w in line.split("Used")[1].split()[:1]]
    spills = sum(1 for line in BUILD_LOGS.get("biquad", "").splitlines()
                 if "spill" in line and not line.strip().startswith("0 bytes stack frame, 0 bytes spill"))
    rows = []
    for bank, stages, args in _k5_banks(_quality_clips(device)[0]):
        out_rows = args[0].shape[0] * args[1].shape[0]
        n_bytes = (args[0].numel() + out_rows * QUALITY_T) * 4
        bound_ms, bound_by = _bound(n_bytes, out_rows * QUALITY_T * stages * 9)
        stream_ms = _events_ms(lambda: biquad_cascade(*args), AUDIO_REPS)
        dev_ms, found, source = _device_ms_or_events(biquad_cascade, args, stream_ms)
        floor_ms, _, floor_source = _device_ms_or_events(_read_floor, (args[0],), _events_ms(lambda: _read_floor(args[0]), AUDIO_REPS))
        rows.append({
            "name": f"biquad_cascade, {bank} ({stages} stage{'s' if stages > 1 else ''}, {out_rows} rows, T={QUALITY_T})",
            "route": "cuda", "source": "torchmetrics_tpu_torch/csrc/biquad.cu",
            "replaces": "torchmetrics_tpu/functional/audio/srmr.py:107", "launches": None, "max_abs_err": None,
            "ms": dev_ms, "ms_source": source, "plain_ms": None, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "stream_ms": {"kernel": stream_ms}, "kernel_only_us": _kernel_only_us(found, "biquad_cascade"), "bytes": n_bytes,
            "read_floor_ms": floor_ms, "read_floor_source": floor_source, "chain_floor_ms": QUALITY_T * K5_STEP_CYCLES / clock_hz * 1e3, "clock_mhz": clock_hz / 1e6,
            "registers": f"{min(regs, default=0)}-{max(regs, default=0)}", "spills": spills,
        })
        del args
    torch.cuda.empty_cache()
    return rows


def _k5_check(rows, clips, main_launches, smi):
    """K5 held bitwise against its plain loop on the main path's own inputs
    at T = QUALITY_T, the loop's steps replayed from CUDA graphs
    (_GraphedSteps) and, over the first K5_PLAIN_CHUNK samples, run eagerly
    as the CPU route runs them: the eager loop, its replay and K5 agree
    there bit for bit. Fills in the rows of :func:`time_biquad_cascade`."""
    import torch

    from torchmetrics_tpu_torch.ops import biquad_cascade, biquad_cascade_plain

    graphed = _GraphedSteps()
    for (bank, stages, args), row in zip(_k5_banks(clips), rows):
        x, b, a = args
        got = biquad_cascade(*args)
        head = x[:, :K5_PLAIN_CHUNK]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eager = biquad_cascade_plain(head, b, a)
        torch.cuda.synchronize()
        eager_s = time.perf_counter() - t0
        _require(torch.equal(biquad_cascade_plain(head, b, a, steps=graphed), eager),
                 f"biquad_cascade ({bank}): the plain loop replayed from a CUDA graph differs from the eager loop")
        _require(torch.equal(got[:, :K5_PLAIN_CHUNK], eager), f"biquad_cascade ({bank}): K5 differs from the eager plain loop")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = biquad_cascade_plain(*args, steps=graphed)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        _require(got.shape == want.shape and torch.equal(got, want), f"biquad_cascade ({bank}): K5 differs from its plain loop at T={QUALITY_T}")
        row.update(launches=main_launches, max_abs_err=float((got - want).abs().max()), plain_ms=plain_s * 1e3,
                   eager_ms_per_step=eager_s * 1e3 / K5_PLAIN_CHUNK)
        print(f"[kernels] biquad_cascade ({bank}): bitwise equal to its plain loop on the main path's inputs at T={QUALITY_T},"
              f" {got.shape[0]} rows, {stages} stage(s); {smi}; device ms {row['ms']:.5f} ({row['ms_source']}, timed"
              f" in phase 3), stream ms {row['stream_ms']['kernel']:.5f}, bound {row['bound_ms']:.5f}"
              f" ({row['bound_by']}, {row['bytes']} B), chain floor {row['chain_floor_ms']:.5f} ({K5_STEP_CYCLES} cycles a"
              f" step at {row['clock_mhz']:.0f} MHz), read floor {row['read_floor_ms']:.5f} ({row['read_floor_source']}); plain loop {plain_s * 1e3:.1f} ms"
              f" wall (steps replayed from CUDA graphs of {K5_PLAIN_CHUNK}), eager {row['eager_ms_per_step']:.4f} ms a"
              f" time step over the first {K5_PLAIN_CHUNK} (equal bits); registers {row['registers']}, {row['spills']} with"
              f" spills; launches per SRMR call 2, on the main path {main_launches}")
        del got, want, eager
    return rows


def _srmr_card_against_cpu(tm, device, out):
    """SRMR on the card against the CPU's on SRMR_CPU_SEEDS batches of clips
    at T = SRMR_CPU_T, per batch; and the witness of the gap's cause: the
    card's SRMR with the CPU's envelope put in place of its own."""
    import importlib

    import numpy as np
    import torch

    sr = importlib.import_module("torchmetrics_tpu_torch.functional.audio.srmr")
    srmr = tm.functional.speech_reverberation_modulation_energy_ratio
    batches = []
    for k in range(SRMR_CPU_SEEDS):
        gen = torch.Generator(device=device)
        gen.manual_seed(SEED + 40 + k)
        batches.append(_speechlike(device, gen, QUALITY_BATCH, SRMR_CPU_T, QUALITY_FS))
    clips = torch.cat(batches)
    own, envelopes = sr._hilbert_envelope, []

    def recorded(x):
        envelopes.append(own(x))
        return envelopes[-1]

    t0 = time.perf_counter()
    sr._hilbert_envelope = recorded
    try:
        cpu = srmr(clips.cpu(), QUALITY_FS).double().numpy()
    finally:
        sr._hilbert_envelope = own
    out["srmr_cpu_s"] = time.perf_counter() - t0
    card = srmr(clips, QUALITY_FS).double().cpu().numpy()
    sr._hilbert_envelope = lambda x: envelopes[0].to(x.device)
    try:
        witness = srmr(clips, QUALITY_FS).double().cpu().numpy()
    finally:
        sr._hilbert_envelope = own
    rel = (np.abs(card - cpu) / np.abs(cpu)).reshape(SRMR_CPU_SEEDS, QUALITY_BATCH).max(-1)
    rel_witness = float((np.abs(witness - cpu) / np.abs(cpu)).max())
    out["srmr_cpu_rel"], out["srmr_witness_rel"] = rel.tolist(), rel_witness
    print(f"[audio] SRMR card vs CPU at T={SRMR_CPU_T}, relative, by seed batch of {QUALITY_BATCH}:"
          f" {', '.join(f'{v:.3e}' for v in rel)} (budget {SRMR_CPU_RTOL:g}); on the CPU's envelope {rel_witness:.3e}"
          f" (budget {SRMR_WITNESS_RTOL:g}); the CPU's SRMR {out['srmr_cpu_s']:.1f} s")
    _require(bool(np.isfinite(card).all()) and float(rel.max()) <= SRMR_CPU_RTOL,
             f"SRMR on the card {card} vs the CPU's {cpu} at T={SRMR_CPU_T} (relative {rel})")
    _require(rel_witness <= SRMR_WITNESS_RTOL, f"SRMR on the card from the CPU's envelope: relative {rel_witness} to the CPU's")
    out["errors"]["SRMR card vs CPU, relative"] = float(rel.max())
    out["errors"]["SRMR card on the CPU's envelope vs CPU, relative"] = rel_witness


def _audio_quality(tm, device, out, smi, k5_rows):
    """SRMR through K5 (the main path: K5's count from 0), K5's rows on the
    main path's inputs, SRMR TF32-invariant, against float64 lfilter and
    against the CPU; STOI and ESTOI against the host's numpy; PESQ and
    DNSMOS refused (see the module docstring, phase 22)."""
    import importlib

    import numpy as np
    import torch

    from torchmetrics_tpu_torch.ops import biquad_cascade

    st = importlib.import_module("torchmetrics_tpu_torch.functional.audio.stoi")
    clips, gen = _quality_clips(device)
    srmr = {norm: tm.SpeechReverberationModulationEnergyRatio(fs=QUALITY_FS, norm=norm, device=device) for norm in (False, True)}
    torch.cuda.synchronize()
    biquad_cascade.launches = 0  # the main path: the SRMR metrics' updates
    t0 = time.perf_counter()
    for norm, metric in srmr.items():
        for half in (slice(0, QUALITY_BATCH // 2), slice(QUALITY_BATCH // 2, QUALITY_BATCH)):
            metric.update(clips[half])
    torch.cuda.synchronize()
    out["srmr_update_s"] = (time.perf_counter() - t0) / 4
    main_launches = biquad_cascade.launches
    _require(main_launches == 8, f"SRMR: K5 launched {main_launches} times over 4 updates, not 2 a call")
    rows = _k5_check(k5_rows, clips, main_launches, smi)
    host = clips.cpu().numpy()
    t0 = time.perf_counter()
    ref = _numpy_srmr(host, QUALITY_FS)
    out["srmr_reference_s"] = time.perf_counter() - t0
    _srmr_card_against_cpu(tm, device, out)
    saved = torch.backends.cudnn.allow_tf32
    try:
        for norm in (False, True):
            values = []
            for flag in (True, False):  # PyTorch's default, then off: SRMR depends on neither
                torch.backends.cudnn.allow_tf32 = flag
                values.append(tm.functional.speech_reverberation_modulation_energy_ratio(clips, QUALITY_FS, norm=norm))
            _require(torch.equal(values[0], values[1]), f"SRMR(norm={norm}): cuDNN's TF32 flag changed the result")
            got = values[1].double().cpu().numpy()
            rel = np.abs(got - ref[norm]) / np.abs(ref[norm])
            _require(bool(np.isfinite(got).all()) and bool((rel <= SRMR_REF_RTOL).all()),
                     f"SRMR(norm={norm}): {got} vs float64 lfilter {ref[norm]} (relative {rel.max()})")
            out["errors"][f"SRMR norm={norm}, relative"] = float(rel.max())
            _require_close(float(srmr[norm].compute()), got.mean(), 1e-5 * abs(got.mean()), f"SpeechReverberationModulationEnergyRatio(norm={norm})")
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    call = lambda x: tm.functional.speech_reverberation_modulation_energy_ratio(x, QUALITY_FS)  # noqa: E731
    out["timed"]["srmr"] = _domain_timed(call, (clips,), clips.numel() * 4 + QUALITY_BATCH * 4,
                                         QUALITY_BATCH * QUALITY_FILTERS * QUALITY_T * (4 * 9 + 8 * 9 + 40), reps=AUDIO_REPS)
    noisy = clips + 0.05 * torch.randn(clips.shape, generator=gen, device=device)
    out["stoi_s"] = {}
    for extended in (False, True):
        t0 = time.perf_counter()
        got = tm.functional.short_time_objective_intelligibility(noisy, clips, QUALITY_FS, extended)
        out["stoi_s"][extended] = time.perf_counter() - t0
        p, c = noisy.cpu().numpy().astype(np.float64), clips.cpu().numpy().astype(np.float64)
        want = np.asarray([st._stoi_single(cc, pp, QUALITY_FS, extended) for pp, cc in zip(p, c)], np.float32)
        _require(got.device == clips.device and np.array_equal(got.cpu().numpy(), want),
                 f"{'E' if extended else ''}STOI on the card's clips differs from the host's numpy")
        out[f"{'e' if extended else ''}stoi"] = want.tolist()
    stoi = tm.ShortTimeObjectiveIntelligibility(fs=QUALITY_FS, device=device)
    stoi.update(noisy, clips)
    _require(abs(float(stoi.compute()) - float(np.mean(out["stoi"], dtype=np.float32))) <= 1e-6, "ShortTimeObjectiveIntelligibility (module)")
    for fn, args in ((tm.functional.perceptual_evaluation_speech_quality, (noisy, clips, QUALITY_FS, "wb")),
                     (tm.functional.deep_noise_suppression_mean_opinion_score, (noisy, QUALITY_FS)),
                     (lambda: tm.PerceptualEvaluationSpeechQuality(QUALITY_FS, "wb", device=device), ()),
                     (lambda: tm.DeepNoiseSuppressionMeanOpinionScore(QUALITY_FS, device=device), ())):
        try:
            fn(*args)
        except ModuleNotFoundError as err:
            _require("pesq" in str(err) or "onnxruntime" in str(err), f"unexpected message: {err}")
        else:
            raise SmokeFailure(f"{getattr(fn, '__name__', fn)} ran without its backend")
    out["srmr_values"] = {norm: ref[norm].tolist() for norm in ref}
    return rows


def phase_audio(device, smi, k5_rows):
    """Clustering (ImageNet-1k val) and audio (WSJ0-2mix separation, DNS
    Challenge clips) at full width, K5 held against its plain loop: see the
    module docstring, phase 22."""
    import torch

    import torchmetrics_tpu_torch as tm

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    out = {"timed": {}, "errors": {}}
    _audio_clustering(tm, device, out)
    torch.cuda.empty_cache()
    _audio_separation(tm, device, out)
    torch.cuda.empty_cache()
    out["rows"] = _audio_quality(tm, device, out, smi, k5_rows)
    out["seconds"] = time.perf_counter() - t_phase
    torch.cuda.empty_cache()
    print(
        f"[audio] {smi}; clustering at {CLUSTER_SAMPLES} x {CLUSTER_DIM}, {CLUSTER_K} clusters, 8 batches: compute s"
        f" {', '.join(f'{k} {v:.3f}' for k, v in out['cluster_compute_s'].items())}; the AMI's host EMI"
        f" {out['emi_s']:.2f} s; peak MiB {', '.join(f'{k} {v:.1f}' for k, v in out['cluster_peak_mib'].items())};"
        f" numpy references {out['cluster_reference_s']:.1f} s; device ms / stream ms per call (launches; bound ms, by):"
        f" {'; '.join(_domain_timed_text(k, v) for k, v in out['timed'].items())}; SRMR update {out['srmr_update_s']:.3f} s a"
        f" call of {QUALITY_BATCH // 2} x {QUALITY_T}, its float64 reference {out['srmr_reference_s']:.1f} s; STOI / ESTOI"
        f" host s {out['stoi_s'][False]:.2f} / {out['stoi_s'][True]:.2f}; max |err| {', '.join(f'{k} {v:.2e}' for k, v in out['errors'].items())};"
        f" {out['seconds']:.1f} s"
    )
    return out


# --------------------------------------------------------------- detection

DET_IMAGES = 5000  # COCO val2017
DET_CLASSES = 80
DET_GTS = 36781  # COCO val2017's instance annotations
DET_MAX_GT = 63  # val2017's most annotations in one image
DET_PER_IMAGE = 100  # the max-detections cap that Faster R-CNN, DETR and YOLO evaluations use
DET_BATCH = 16  # images an update, as a detector's evaluation loop feeds them
DET_H, DET_W = 480, 640  # COCO's usual image size
DET_SIZE_MIX = (0.41, 0.34)  # COCO's small and medium instance shares (large: the rest)
DET_CROWD = 0.01
DET_REPS = 5
DET_SUMMARY_ATOL = 1e-6  # the summary means: float32 sums of up to T x R x K cells in another order
SEGM_IMAGES, SEGM_DETS, SEGM_CODEC_CHECK = 200, 20, 10  # cut: the host codec's time
PQ_IMAGES, PQ_THINGS, PQ_STUFFS, PQ_BATCH, PQ_CPU_IMAGES = 64, 80, 53, 8, 2  # cut: host numpy's time
# the CPU route's compute and the IoU classes' per-image updates over the first 1,000 images: the full
# stream took 34 s and 16.6 s of the phase on the card's host
DET_CPU_IMAGES = DET_IOU_IMAGES = 1000
K6_OPS_PER_CELL = 4  # the dense bound's count a (image, area, threshold, detection, ground truth) cell: two selects, two compares
# the walk's count, for each (image, area range, threshold): a candidate's compare in each of the two stages, and
# each detection's two compares with the bar
K6_OPS_PER_CANDIDATE = K6_OPS_PER_STEP = 2
# one thread's step on registers alone, in cycles, at 0, 1, 2, 3 and 4 candidates a step (chip_k6_variants.py's
# chain probe on an NVIDIA H100 80GB HBM3 at 700 W); past 4 candidates a step, the last difference a candidate
K6_STEP_CYCLES = (63.657, 308.188, 407.657, 505.407, 603.657)


def _require_same_bits(got, want, what):
    """``got`` and ``want`` hold the same bits (floats compared as their integer views)."""
    import torch

    got, want = got.cpu(), want.cpu()
    _require(got.dtype == want.dtype and got.shape == want.shape,
             f"{what}: {got.dtype} {tuple(got.shape)} vs {want.dtype} {tuple(want.shape)}")
    if got.dtype.is_floating_point:
        view = {2: torch.int16, 4: torch.int32, 8: torch.int64}[got.element_size()]
        got, want = got.view(view), want.view(view)
    _require(torch.equal(got, want), f"{what}: the bits differ")


def _det_boxes(gen, n, device):
    """``n`` COCO-like xyxy boxes in a DET_W x DET_H image: COCO's small /
    medium / large mix, log-uniform areas in each range and aspect ratios in [1/2, 2]."""
    import torch

    u = torch.rand(n, generator=gen, device=device)
    small, medium = u < DET_SIZE_MIX[0], u < DET_SIZE_MIX[0] + DET_SIZE_MIX[1]
    lo = torch.where(small, 16.0, torch.where(medium, 32.0**2, 96.0**2))
    hi = torch.where(small, 32.0**2, torch.where(medium, 96.0**2, 0.5 * DET_W * DET_H))
    area = torch.exp(torch.log(lo) + torch.rand(n, generator=gen, device=device) * (torch.log(hi) - torch.log(lo)))
    ratio = torch.exp((torch.rand(n, generator=gen, device=device) * 2 - 1) * math.log(2))
    w = torch.sqrt(area * ratio).clamp(max=DET_W)
    h = (area / w).clamp(max=DET_H)
    x0 = torch.rand(n, generator=gen, device=device) * (DET_W - w)
    y0 = torch.rand(n, generator=gen, device=device) * (DET_H - h)
    return torch.stack([x0, y0, x0 + w, y0 + h], -1)


def _det_stream(device, n_imgs=None, n_gts=None):
    """COCO val2017's shape made from SEED on ``device``: per-image ground
    truths (0 to DET_MAX_GT, DET_GTS in all, about 1% crowds) and
    DET_PER_IMAGE detections (a jittered copy of each ground truth with
    probability 0.85, a duplicate with 0.3, false positives for the rest;
    labels kept with probability 0.9). Returns per-image dicts (views of a
    few large tensors) and the per-image counts."""
    import numpy as np
    import torch

    n_imgs = n_imgs or DET_IMAGES
    n_gts = n_gts or DET_GTS
    rng = np.random.default_rng(SEED + 19)
    counts = np.clip(rng.negative_binomial(1.3, 1.3 / (1.3 + n_gts / n_imgs), n_imgs), 0, DET_MAX_GT)
    counts[0] = DET_MAX_GT
    while counts.sum() != n_gts:
        i = int(rng.integers(1, n_imgs))
        step = 1 if counts.sum() < n_gts else -1
        if 0 <= counts[i] + step <= DET_MAX_GT:
            counts[i] += step
    gen = torch.Generator(device=device).manual_seed(SEED + 19)
    gt_boxes = _det_boxes(gen, n_gts, device)
    gt_labels = torch.randint(0, DET_CLASSES, (n_gts,), generator=gen, device=device)
    gt_crowd = torch.rand(n_gts, generator=gen, device=device) < DET_CROWD
    ng = torch.as_tensor(counts, device=device)[:, None]
    offsets = torch.as_tensor(np.cumsum(counts) - counts, device=device)[:, None]
    slot = torch.arange(DET_PER_IMAGE, device=device)[None, :]
    shape = (n_imgs, DET_PER_IMAGE)
    hit = (slot < ng) & (torch.rand(shape, generator=gen, device=device) < 0.85)
    dup = (slot >= ng) & (slot < 2 * ng) & (torch.rand(shape, generator=gen, device=device) < 0.3)
    src = (offsets + slot % ng.clamp(min=1)).clamp(max=n_gts - 1)
    base = gt_boxes[src]
    wh = base[..., 2:] - base[..., :2]
    sigma = 0.01 + 0.19 * torch.rand(shape + (1,), generator=gen, device=device)
    center = (base[..., :2] + base[..., 2:]) / 2 + wh * sigma * torch.randn(shape + (2,), generator=gen, device=device)
    half = wh * torch.exp(sigma * torch.randn(shape + (2,), generator=gen, device=device)) / 2
    jittered = torch.cat([center - half, center + half], -1)
    from_gt = (hit | dup)[..., None]
    det_boxes = torch.where(from_gt, jittered, _det_boxes(gen, n_imgs * DET_PER_IMAGE, device).reshape(shape + (4,)))
    keep_label = (hit | dup) & (torch.rand(shape, generator=gen, device=device) < 0.9)
    det_labels = torch.where(keep_label, gt_labels[src], torch.randint(0, DET_CLASSES, shape, generator=gen, device=device))
    u = torch.rand(shape, generator=gen, device=device)
    det_scores = torch.where(hit, 0.5 + 0.5 * u, torch.where(dup, 0.3 + 0.5 * u, 0.6 * u))
    split = counts.tolist()
    preds = [{"boxes": b, "scores": s, "labels": lab} for b, s, lab in zip(det_boxes, det_scores, det_labels)]
    target = [{"boxes": b, "labels": lab, "iscrowd": c} for b, lab, c in
              zip(gt_boxes.split(split), gt_labels.split(split), gt_crowd.split(split))]
    return preds, target, counts


def _det_on(items, device):
    """The same per-image dicts on ``device`` (one copy of each large tensor, then views)."""
    import torch

    out = []
    keys = list(items[0]) if items else []
    moved = {}
    for key in keys:
        parts = [it[key] for it in items]
        flat = torch.cat([p.reshape(-1) for p in parts]).to(device)
        moved[key] = [v.reshape(p.shape) for v, p in zip(flat.split([p.numel() for p in parts]), parts)]
    for i in range(len(items)):
        out.append({key: moved[key][i] for key in keys})
    return out


def _map_module():
    import importlib

    return importlib.import_module("torchmetrics_tpu_torch.functional.detection.map")


def _timed_map_compute(metric, keep=None):
    """``metric.compute()`` with each stage timed (a synchronize on both
    sides of each): the host packing, the IoU, K6, the matching around it,
    the accumulation and the summary; with ``keep`` a dict, K6's arguments
    go there."""
    import torch

    tmap = _map_module()
    names = ("_bbox_iou_and_area", "coco_match", "_match", "_accumulate", "_match_and_accumulate")
    originals = {name: getattr(tmap, name) for name in names}
    parts = dict.fromkeys(names, 0.0)

    def timed(name):
        fn = originals[name]

        def wrapper(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            parts[name] += time.perf_counter() - t0
            if name == "coco_match" and keep is not None:
                keep["args"] = args
            return out
        return wrapper

    for name in names:
        setattr(tmap, name, timed(name))
    metric._computed = None  # compute again, not from the cache
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = metric.compute()
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        for name, fn in originals.items():
            setattr(tmap, name, fn)
    split = {
        "host packing": total - parts["_bbox_iou_and_area"] - parts["_match_and_accumulate"],
        "IoU": parts["_bbox_iou_and_area"],
        "K6": parts["coco_match"],
        "ignore masks": parts["_match"] - parts["coco_match"],
        "accumulation": parts["_accumulate"],
        "summary": parts["_match_and_accumulate"] - parts["_match"] - parts["_accumulate"],
    }
    return result, total, split


def _require_map_equal(got, want, what):
    """The card's mAP dict against the CPU route's: the same keys, the tables
    and classes bitwise, the summaries within DET_SUMMARY_ATOL. Returns the
    largest summary difference."""
    import torch

    _require(sorted(got) == sorted(want), f"{what}: keys {sorted(got)} vs {sorted(want)}")
    worst = 0.0
    for key, w in want.items():
        g, w = got[key].cpu(), w.cpu()
        _require(g.dtype == w.dtype and g.shape == w.shape, f"{what} {key}: {g.dtype} {tuple(g.shape)} vs {w.dtype} {tuple(w.shape)}")
        if key in ("precision", "recall", "scores", "classes"):
            _require(torch.equal(g, w), f"{what} {key}: the card's table differs from the CPU's")
        else:
            err = float((g.double() - w.double()).abs().max()) if g.numel() else 0.0
            _require(err <= DET_SUMMARY_ATOL, f"{what} {key}: |card - CPU| {err} > {DET_SUMMARY_ATOL}")
            worst = max(worst, err)
    return worst


K6_EDGE_THRS = (1.0, 0.0, -0.0, -1.0, float("nan"), 0.5, -2.0, -1.5)


def _k6_inputs(gen, device, n, d, g, a, kind):
    """K6's arguments but the thresholds, made on ``device`` from ``gen``: ``grid`` IoUs on a 0.05 grid
    (ties) with 2% NaNs and every 5th detection at 1.0, three classes, 10% invalid, 10% crowds (image 0
    all crowds: all ignored), image 1 without detections, image 2 without ground truths; ``special``
    the same flags, one class, IoUs from -1.0, -2.0, -0.0, +0.0, NaN, 1.0 and 0.5; ``cover`` every ground
    truth valid, of the one class, unignored, IoUs from -1.0, -2.0, -1.5 and -0.0 (stage 1's
    candidates cover the row: no -1.0 column outside them)."""
    import torch

    def draw(values):
        values = torch.tensor(values, device=device)
        return values[torch.randint(0, len(values), (n, d, g), generator=gen, device=device)]

    if kind == "cover":
        return (draw([-1.0, -2.0, -1.5, -0.0]), torch.zeros((n, d), dtype=torch.int32, device=device),
                torch.ones((n, d), dtype=torch.bool, device=device), torch.zeros((n, g), dtype=torch.int32, device=device),
                torch.ones((n, g), dtype=torch.bool, device=device), torch.zeros((n, g), dtype=torch.bool, device=device),
                torch.zeros((n, a, g), dtype=torch.bool, device=device))
    if kind == "special":
        iou = draw([-1.0, -2.0, -0.0, 0.0, float("nan"), 1.0, 0.5])
    else:
        iou = torch.round(torch.rand((n, d, g), generator=gen, device=device) * 20) / 20
        iou[torch.rand((n, d, g), generator=gen, device=device) < 0.02] = float("nan")
        iou[:, ::5] = 1.0
    classes = 1 if kind == "special" else 3
    det_labels = torch.randint(0, classes, (n, d), generator=gen, device=device, dtype=torch.int32)
    gt_labels = torch.randint(0, classes, (n, g), generator=gen, device=device, dtype=torch.int32)
    det_valid = torch.rand((n, d), generator=gen, device=device) < 0.9
    gt_valid = torch.rand((n, g), generator=gen, device=device) < 0.9
    gt_crowd = torch.rand((n, g), generator=gen, device=device) < 0.1
    gt_crowd[0] = True
    gt_ig = (torch.rand((n, a, g), generator=gen, device=device) < 0.2) | gt_crowd[:, None, :]
    det_valid[1] = False
    gt_valid[2] = False
    return iou, det_labels, det_valid, gt_labels, gt_valid, gt_crowd, gt_ig


def _k6_adversarial(device):
    """K6 bitwise against its plain loop on card batches built to break it
    (``_k6_inputs``): ties, NaN IoUs, crowds, all-ignored and empty images,
    D and G not multiples of 32, thresholds at 1.0, +-0, -1, -2, -1.5 and
    NaN; G at 32, 63, 64, 65 and around the 128 ground truths the matched
    set holds in registers; past them (G = 1,100: the scratch
    instantiation); D x G x 4 past 48 KB (the old kernel's stage); a block's
    masks past 48 KB of shared memory (200 detections, one area range: the
    scratch instantiation); candidate IoUs of -1.0, -2.0 and +-0 with
    several NaNs a row; rows whose candidates cover every ground truth (no
    filler). Returns the number of cases and the instantiations reached."""
    import torch

    from torchmetrics_tpu_torch.ops import coco_match, coco_match_plain
    from torchmetrics_tpu_torch.ops.coco_match import coco_match_instantiation

    gen = torch.Generator(device=device).manual_seed(SEED + 61)
    coco, edges = torch.linspace(0.5, 0.95, 10), torch.tensor(K6_EDGE_THRS)
    cases = [(16, 37, 45, 4, coco, "grid"), (16, 37, 45, 4, edges, "grid"), (4, 9, 1100, 2, coco, "grid"),
             (4, 200, 70, 4, torch.linspace(0.3, 0.9, 23), "grid"), (6, 200, 100, 1, edges, "grid"),
             (8, 50, 45, 4, edges, "special"), (4, 30, 129, 2, edges, "special"), (4, 20, 37, 2, edges, "cover"),
             (4, 20, 128, 2, edges, "cover")]
    cases += [(8, 40, g, 4, coco, "grid") for g in (32, 63, 64, 65, 127, 128, 129)]
    reached = set()
    for n, d, g, a, thrs, kind in cases:
        args = (*_k6_inputs(gen, device, n, d, g, a, kind), thrs.to(device))
        got, want = coco_match(*args), coco_match_plain(*args)
        for x, y, name in zip(got, want, ("det_matched", "det_ignored")):
            _require_same_bits(x, y, f"K6 adversarial {kind} ({n}, {d}, {g}, {a}, T={thrs.numel()}) {name}")
        reached.add(coco_match_instantiation(n, d, g, a, thrs.numel()))
    _require(reached == {0, 1, 2, 3, 4}, f"K6 adversarial: instantiations reached {sorted(reached)}, not 0-4")
    return len(cases), sorted(reached)


def _k6_least_bytes(args):
    """The bytes the matcher must move on these inputs: the labels and flags,
    the thresholds, the 32-byte sectors of the IoU that hold a candidate (a
    valid ground truth of the detection's label, on a valid detection), and
    the two outputs."""
    iou, det_labels, det_valid, gt_labels, gt_valid, gt_crowd, gt_ig, thrs = args
    n, d, g = iou.shape
    a, t = gt_ig.shape[1], thrs.numel()
    cand = det_valid[:, :, None] & gt_valid[:, None, :] & (det_labels[:, :, None] == gt_labels[:, None, :])
    sectors = (cand.reshape(-1).nonzero()[:, 0] // 8).unique().numel()
    flags = sum(x.numel() * x.element_size() for x in (det_labels, det_valid, gt_labels, gt_valid, gt_crowd, gt_ig, thrs))
    return flags + sectors * 32 + 2 * n * a * t * d, int(cand.sum()), sectors


def _sm_clock_hz():
    """The card's top SM clock from nvidia-smi, in Hz (1.98 GHz, the H100 SXM's, if it does not answer)."""
    smi_clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits", "-i", "0"],
                               capture_output=True, text=True, timeout=60).stdout.strip()
    return float(smi_clock) * 1e6 if smi_clock.replace(".", "", 1).isdigit() else 1.98e9


def _det_fed(tm, device):
    """``MeanAveragePrecision`` fed the COCO val2017-shaped stream in batches
    of DET_BATCH: the metric, the stream, its counts and the ms an update."""
    import torch

    preds, target, counts = _det_stream(device)
    metric = tm.MeanAveragePrecision(device=device, class_metrics=True, extended_summary=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(0, len(preds), DET_BATCH):
        metric.update(preds[i:i + DET_BATCH], target[i:i + DET_BATCH])
    torch.cuda.synchronize()
    return metric, preds, target, counts, (time.perf_counter() - t0) * 1e3 / math.ceil(len(preds) / DET_BATCH)


def k6_bbox_inputs(device):
    """The bbox compute at COCO val2017's shape and K6's arguments from it:
    the fed metric (computed once) and the (5,000, 104, 64) IoU with its
    labels, flags, ignore masks and thresholds, as the compute passes them."""
    import torchmetrics_tpu_torch as tm

    metric = _det_fed(tm, device)[0]
    keep = {}
    _timed_map_compute(metric, keep)
    return metric, tuple(x.contiguous() for x in keep["args"])


def _k6_walk_cycles(args):
    """The chain floor of K6's launch on these inputs, in cycles: each image's
    walk of D steps, a step's cycles those of the chain probe
    (K6_STEP_CYCLES) at its candidates (valid ground truths of the
    detection's label), the longest image's. Every thread of an image walks
    the same steps; under a bar above -1 (COCO's thresholds) a step without
    candidates is skipped. Returns the cycles, the image and its candidate
    pairs."""
    import torch

    cand = args[2][:, :, None] & args[4][:, None, :] & (args[1][:, :, None] == args[3][:, None, :])
    counts = cand.sum(2)
    top = len(K6_STEP_CYCLES) - 1
    table = torch.tensor(K6_STEP_CYCLES, dtype=torch.float64, device=counts.device)
    slope = K6_STEP_CYCLES[top] - K6_STEP_CYCLES[top - 1]
    walk = (table[counts.clamp(max=top)] + (counts - top).clamp(min=0).double() * slope).sum(1)
    image = int(walk.argmax())
    return float(walk[image]), image, int(counts[image].sum())


def time_coco_match(device):
    """K6's row, timed in phase 3 (torch.profiler was seen to go blind late in
    a long run, and CUDA events around K6's 0.1 ms launch then time the
    host's launch cost) on the bbox compute's own arguments at COCO
    val2017's shape (``k6_bbox_inputs``): device ms (profiler), stream ms;
    the bound of the walk over candidates: the least bytes (labels, flags,
    thresholds, the candidates' IoU sectors, the outputs) and its operations
    (K6_OPS_PER_CANDIDATE, K6_OPS_PER_STEP), beside the dense bound (the
    dense step's K6_OPS_PER_CELL a (detection, ground truth) cell of every
    image, area range and threshold, every input byte); the chain floor
    (``_k6_walk_cycles`` at the card's top clock); K6 on the image with the
    most candidate pairs alone (a launch's time on that image, not a floor);
    the read floor, registers. The detection phase adds the launches, the
    check and the plain loop's time on the same inputs."""
    import torch

    from torchmetrics_tpu_torch.ops import coco_match

    metric, args = k6_bbox_inputs(device)
    del metric
    iou = args[0]
    n, d, g = iou.shape
    a, t = args[6].shape[1], args[7].numel()
    stream_ms = _events_ms(lambda: coco_match(*args), DET_REPS)
    dev_ms, found, source = _device_ms_or_events(coco_match, args, stream_ms)
    floor_ms, _, floor_source = _device_ms_or_events(_read_floor, (iou,), _events_ms(lambda: _read_floor(iou), DET_REPS))
    dense_bytes = sum(x.numel() * x.element_size() for x in args) + 2 * n * a * t * d
    dense_ms, dense_by = _bound(dense_bytes, K6_OPS_PER_CELL * n * a * t * d * g)
    least_bytes, candidates, sectors = _k6_least_bytes(args)
    walk_ops = a * t * (K6_OPS_PER_CANDIDATE * candidates + K6_OPS_PER_STEP * n * d)
    bound_ms, bound_by = _bound(least_bytes, walk_ops)
    clock_hz = _sm_clock_hz()
    chain_cycles, chain_image, chain_pairs = _k6_walk_cycles(args)
    pair_ok = args[2][:, :, None] & args[4][:, None, :] & (args[1][:, :, None] == args[3][:, None, :])
    densest = int(pair_ok.sum((1, 2)).argmax())
    one = tuple(x[densest : densest + 1] for x in args[:7]) + (args[7],)
    # the profiler's device time only: CUDA events around a lone small launch time the host's launch cost
    try:
        densest_ms, _ = _device_ms(coco_match, [one], DET_REPS)
        densest_source = f"profiler, image {densest} alone ({int(pair_ok[densest].sum())} candidate pairs)"
    except SmokeFailure:
        densest_ms, densest_source = None, "not measured: torch.profiler saw no device time"
    log = BUILD_LOGS.get("coco_match", "")
    regs = [int(w) for line in log.splitlines() if "registers" in line for w in line.split("Used")[1].split()[:1]]
    spills = sum(1 for line in log.splitlines() if "spill" in line and not line.strip().startswith("0 bytes stack frame, 0 bytes spill"))
    del args, iou, one, pair_ok
    torch.cuda.empty_cache()
    return {
        "name": f"coco_match ({n} images x {d} detections x {g} ground truths, A={a}, T={t})",
        "route": "cuda", "source": "torchmetrics_tpu_torch/csrc/coco_match.cu",
        "replaces": "torchmetrics_tpu/functional/detection/map.py:92", "launches": None, "max_abs_err": None,
        "ms": dev_ms, "ms_source": source, "plain_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None, "stream_ms": {"kernel": stream_ms},
        "kernel_only_us": _kernel_only_us(found, "coco_match"), "bytes": least_bytes, "walk_ops": walk_ops,
        "candidates": candidates, "candidate_sectors": sectors, "dense_bound_ms": dense_ms, "dense_bound_by": dense_by,
        "dense_bytes": dense_bytes, "read_floor_ms": floor_ms, "read_floor_source": floor_source,
        "chain_floor_ms": chain_cycles / clock_hz * 1e3, "chain_cycles": chain_cycles, "chain_image": chain_image,
        "chain_pairs": chain_pairs, "clock_mhz": clock_hz / 1e6, "densest_image_ms": densest_ms,
        "densest_image_source": densest_source, "registers": f"{min(regs, default=0)}-{max(regs, default=0)}", "spills": spills,
    }


def _k6_row(args, main_launches, row):
    """K6's row from phase 3 (``time_coco_match``) completed on the main
    path's own inputs: the same inputs (their candidates and least bytes
    equal), K6 bitwise against its plain loop, the plain loop's ms, the
    launches."""
    from torchmetrics_tpu_torch.ops import coco_match, coco_match_plain

    _require(_k6_least_bytes(args) == (row["bytes"], row["candidates"], row["candidate_sectors"]),
             "detection: K6's arguments differ from those timed in phase 3")
    got = coco_match(*args)
    plain_stream = _events_ms(lambda: coco_match_plain(*args), 1)
    want = coco_match_plain(*args)
    for x, y, name in zip(got, want, ("det_matched", "det_ignored")):
        _require_same_bits(x, y, f"K6 at the main path's shape {name}")
    row.update(launches=main_launches, max_abs_err=0.0, plain_ms=plain_stream)
    row["stream_ms"]["plain"] = plain_stream
    return row


def _det_bbox(tm, device, out, k6_row):
    """The bbox cell: the COCO val2017-shaped stream through
    ``MeanAveragePrecision.update`` in batches of DET_BATCH, ``compute`` with
    K6 counted from 0 (the main path), its stages timed in a second compute,
    K6 held against its plain loop (``k6_row``, timed in phase 3, completed),
    the card against the CPU route, and the four IoU classes over its first
    images."""
    import torch

    from torchmetrics_tpu_torch.ops import coco_match

    kw = {"class_metrics": True, "extended_summary": True}
    coco_match.launches = 0
    metric, preds, target, counts, update_ms = _det_fed(tm, device)
    out["update_ms"] = {"MeanAveragePrecision": update_ms}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = metric.compute()
    torch.cuda.synchronize()
    out["compute_s"] = time.perf_counter() - t0
    out["peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
    out["main_launches"] = coco_match.launches
    _require(out["main_launches"] == 1, f"detection: K6 launched {out['main_launches']} times in the compute, not once")
    num_k = res["classes"].numel()
    _require(res["precision"].shape == (10, 101, num_k, 4, 3) and num_k == DET_CLASSES, f"detection: tables {tuple(res['precision'].shape)}")
    for key in ("map", "map_50", "map_75", "mar_100", "map_small", "map_large"):
        v = float(res[key])
        _require(math.isfinite(v) and 0.0 < v <= 1.0, f"detection {key} = {v}")
    out["values"] = {key: float(res[key]) for key in ("map", "map_50", "map_75", "map_small", "map_medium", "map_large", "mar_1", "mar_10", "mar_100")}
    keep = {}
    res2, total, split = _timed_map_compute(metric, keep)
    _require_map_equal(res2, res, "detection: a second compute")
    out["timed_compute_s"], out["compute_split_s"] = total, split
    out["k6_row"] = _k6_row(keep["args"], out["main_launches"], k6_row)
    del keep
    torch.cuda.empty_cache()
    # the CPU route on the same inputs: the first DET_CPU_IMAGES images, on the card and on the CPU
    first_p, first_t = preds[:DET_CPU_IMAGES], target[:DET_CPU_IMAGES]
    card_metric, cpu_metric = tm.MeanAveragePrecision(device=device, **kw), tm.MeanAveragePrecision(device="cpu", **kw)
    cpu_preds, cpu_target = _det_on(first_p, "cpu"), _det_on(first_t, "cpu")
    for i in range(0, len(first_p), DET_BATCH):
        card_metric.update(first_p[i:i + DET_BATCH], first_t[i:i + DET_BATCH])
        cpu_metric.update(cpu_preds[i:i + DET_BATCH], cpu_target[i:i + DET_BATCH])
    got = card_metric.compute()
    t0 = time.perf_counter()
    want = cpu_metric.compute()
    out["cpu_compute_s"] = time.perf_counter() - t0
    out["errors"]["mAP card vs CPU"] = _require_map_equal(got, want, "detection: card vs CPU")
    del card_metric, cpu_metric, cpu_preds, cpu_target, got, want, res, res2, metric
    # the four IoU classes over the stream's first DET_IOU_IMAGES images
    first_p, first_t = preds[:DET_IOU_IMAGES], target[:DET_IOU_IMAGES]
    for name in ("IntersectionOverUnion", "GeneralizedIntersectionOverUnion", "DistanceIntersectionOverUnion",
                 "CompleteIntersectionOverUnion"):
        m = getattr(tm, name)(device=device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(0, len(first_p), DET_BATCH):
            m.update(first_p[i:i + DET_BATCH], first_t[i:i + DET_BATCH])
        torch.cuda.synchronize()
        out["update_ms"][name] = (time.perf_counter() - t0) * 1e3 / math.ceil(len(first_p) / DET_BATCH)
        value = float(next(iter(m.compute().values())))
        _require(math.isfinite(value) and -1.0 <= value <= 1.0, f"detection {name} = {value}")
        out["values"][name] = value
        if name == "IntersectionOverUnion":
            out["errors"]["IoU vs numpy"] = _require_close(value, _numpy_mean_iou(first_p, first_t), 1e-5, name)
        del m
    out["images"], out["gts"] = len(preds), int(counts.sum())
    del preds, target


def _numpy_mean_iou(preds, target):
    """The mean IoU over label-equal (detection, ground truth) pairs in float64 numpy."""
    import numpy as np

    total, count = 0.0, 0
    for p, t in zip(preds, target):
        d, g = p["boxes"].double().cpu().numpy(), t["boxes"].double().cpu().numpy()
        if not len(d) or not len(g):
            continue
        lt, rb = np.maximum(d[:, None, :2], g[None, :, :2]), np.minimum(d[:, None, 2:], g[None, :, 2:])
        inter = np.clip(rb - lt, 0, None).prod(-1)
        union = np.prod(d[:, 2:] - d[:, :2], -1)[:, None] + np.prod(g[:, 2:] - g[:, :2], -1)[None, :] - inter
        iou = np.where(union > 0, inter / np.where(union > 0, union, 1), 0.0)
        same = p["labels"].cpu().numpy()[:, None] == t["labels"].cpu().numpy()[None, :]
        total += iou[same].sum()
        count += int(same.sum())
    return total / count if count else 0.0


def _ellipses(boxes, device):
    """``(n, DET_H, DET_W)`` uint8 masks of the ellipses inscribed in ``boxes``."""
    import torch

    ys = torch.arange(DET_H, device=device, dtype=torch.float32)[None, :, None] + 0.5
    xs = torch.arange(DET_W, device=device, dtype=torch.float32)[None, None, :] + 0.5
    c = (boxes[:, :2] + boxes[:, 2:]) / 2
    r = ((boxes[:, 2:] - boxes[:, :2]) / 2).clamp(min=0.5)
    return ((((xs - c[:, None, None, 0]) / r[:, None, None, 0]) ** 2
             + ((ys - c[:, None, None, 1]) / r[:, None, None, 1]) ** 2) <= 1).to(torch.uint8)


def _det_segm(tm, device, out):
    """The segm cell, cut to SEGM_IMAGES images of SEGM_DETS detections: the
    bbox stream's first images as ellipse masks at 480 x 640 on the card,
    RLE-encoded by the port's codec at update; the codec's runs bitwise
    against the numpy plain route on SEGM_CODEC_CHECK images; the card's mAP
    against the CPU route on the same RLEs."""
    import numpy as np
    import torch

    from torchmetrics_tpu_torch.functional.detection import mask_utils
    from torchmetrics_tpu_torch.ops import coco_match

    preds, target, _ = _det_stream(device, n_imgs=SEGM_IMAGES, n_gts=SEGM_IMAGES * DET_GTS // DET_IMAGES)
    metric = tm.MeanAveragePrecision(iou_type="segm", device=device, extended_summary=True)
    t_update, checked = 0.0, 0
    before = coco_match.launches
    for i in range(0, SEGM_IMAGES, DET_BATCH):
        batch_p, batch_t = [], []
        for p, t in zip(preds[i:i + DET_BATCH], target[i:i + DET_BATCH]):
            top = torch.argsort(p["scores"], descending=True)[:SEGM_DETS]
            batch_p.append({"masks": _ellipses(p["boxes"][top], device), "scores": p["scores"][top], "labels": p["labels"][top]})
            batch_t.append({"masks": _ellipses(t["boxes"], device), "labels": t["labels"], "iscrowd": t["iscrowd"]})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metric.update(batch_p, batch_t)
        t_update += time.perf_counter() - t0
        for j, item in enumerate(batch_p):
            if checked < SEGM_CODEC_CHECK:
                host = item["masks"].cpu().numpy()
                for k in range(host.shape[0]):
                    rle = metric.detection_mask[i + j][k]
                    _require(np.array_equal(rle["counts"], mask_utils._encode_numpy(host[k].flatten(order="F"))),
                             f"segm: the codec's runs of image {i + j} mask {k} differ from the numpy route's")
                checked += 1
    out["segm_update_ms"] = t_update * 1e3 / math.ceil(SEGM_IMAGES / DET_BATCH)
    t0 = time.perf_counter()
    res = metric.compute()
    torch.cuda.synchronize()
    out["segm_compute_s"] = time.perf_counter() - t0
    _require(coco_match.launches == before + 1, "segm: K6 did not launch once in the compute")
    cpu_metric = tm.MeanAveragePrecision(iou_type="segm", device="cpu", extended_summary=True)
    cpu_metric.update(
        [{"masks": m, "scores": s.cpu(), "labels": lab.cpu()} for m, s, lab in
         zip(metric.detection_mask, metric.detection_scores, metric.detection_labels)],
        [{"masks": m, "labels": lab.cpu(), "iscrowd": c.cpu()} for m, lab, c in
         zip(metric.groundtruth_mask, metric.groundtruth_labels, metric.groundtruth_crowds)],
    )
    out["errors"]["segm card vs CPU"] = _require_map_equal(res, cpu_metric.compute(), "segm: card vs CPU")
    out["values"]["segm map"] = float(res["map"])
    _require(0.0 < out["values"]["segm map"] <= 1.0, f"segm map = {out['values']['segm map']}")
    out["segm_codec_images"] = checked


def _panoptic_maps(gen, n, device, things, stuffs):
    """``(n, DET_H, DET_W, 2)`` int64 (category, instance) maps: an 8 x 8
    grid of stuff regions under 12-24 thing instances (ellipses); and the
    predictions: instances redrawn from jittered boxes, 10% of instance and
    region categories changed."""
    import torch

    things_t, stuffs_t = torch.tensor(sorted(things), device=device), torch.tensor(sorted(stuffs), device=device)
    target = torch.zeros((n, DET_H, DET_W, 2), dtype=torch.int64, device=device)
    preds = torch.zeros_like(target)
    for i in range(n):
        grid = stuffs_t[torch.randint(0, len(stuffs_t), (8, 8), generator=gen, device=device)]
        cat = grid.repeat_interleave(DET_H // 8, 0).repeat_interleave(DET_W // 8, 1)
        flip = torch.rand((8, 8), generator=gen, device=device) < 0.1
        grid_p = torch.where(flip, stuffs_t[torch.randint(0, len(stuffs_t), (8, 8), generator=gen, device=device)], grid)
        cat_p = grid_p.repeat_interleave(DET_H // 8, 0).repeat_interleave(DET_W // 8, 1)
        inst, inst_p = torch.zeros_like(cat), torch.zeros_like(cat)
        k = int(torch.randint(12, 25, (1,), generator=gen, device=device))
        boxes = _det_boxes(gen, k, device)
        labels = things_t[torch.randint(0, len(things_t), (k,), generator=gen, device=device)]
        wh = boxes[:, 2:] - boxes[:, :2]
        jitter = torch.cat([wh, wh], -1) * 0.05 * torch.randn((k, 4), generator=gen, device=device)
        labels_p = torch.where(torch.rand(k, generator=gen, device=device) < 0.1,
                               things_t[torch.randint(0, len(things_t), (k,), generator=gen, device=device)], labels)
        masks, masks_p = _ellipses(boxes, device).bool(), _ellipses(boxes + jitter, device).bool()
        for j in range(k):
            cat, inst = torch.where(masks[j], labels[j], cat), torch.where(masks[j], j + 1, inst)
            cat_p, inst_p = torch.where(masks_p[j], labels_p[j], cat_p), torch.where(masks_p[j], j + 1, inst_p)
        target[i, ..., 0], target[i, ..., 1], preds[i, ..., 0], preds[i, ..., 1] = cat, inst, cat_p, inst_p
    return preds, target


def _det_panoptic(tm, device, out):
    """The panoptic cell, cut to PQ_IMAGES images at 480 x 640 with COCO
    panoptic's 133 categories (80 things, 53 stuff): PanopticQuality on the
    card in batches of PQ_BATCH (the per-image matching is host numpy); the
    states and values of PanopticQuality and ModifiedPanopticQuality on the
    card equal to the CPU's over the first PQ_CPU_IMAGES images."""
    import torch

    things, stuffs = set(range(1, PQ_THINGS + 1)), set(range(PQ_THINGS + 1, PQ_THINGS + PQ_STUFFS + 1))
    gen = torch.Generator(device=device).manual_seed(SEED + 133)
    preds, target = _panoptic_maps(gen, PQ_IMAGES, device, things, stuffs)
    metric = tm.PanopticQuality(things=things, stuffs=stuffs, return_sq_and_rq=True, device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(0, PQ_IMAGES, PQ_BATCH):
        metric.update(preds[i:i + PQ_BATCH], target[i:i + PQ_BATCH])
    torch.cuda.synchronize()
    out["pq_update_ms"] = (time.perf_counter() - t0) * 1e3 / (PQ_IMAGES // PQ_BATCH)
    pq = metric.compute()
    _require(bool(torch.isfinite(pq).all()) and 0.0 < float(pq[0]) <= 1.0, f"panoptic quality {pq.tolist()}")
    out["values"]["PQ, SQ, RQ"] = [round(float(v), 6) for v in pq]
    cut = slice(0, PQ_CPU_IMAGES)
    for name in ("PanopticQuality", "ModifiedPanopticQuality"):
        card = getattr(tm, name)(things=things, stuffs=stuffs, return_sq_and_rq=True, device=device)
        cpu = getattr(tm, name)(things=things, stuffs=stuffs, return_sq_and_rq=True, device="cpu")
        card.update(preds[cut], target[cut])
        cpu.update(preds[cut].cpu(), target[cut].cpu())
        for key in ("iou_sum", "true_positives", "false_positives", "false_negatives"):
            _require_same_bits(getattr(card, key).cpu(), getattr(cpu, key), f"{name} {key}: card vs CPU")
        _require_same_bits(card.compute().cpu(), cpu.compute(), f"{name}: card vs CPU")
    del preds, target


def phase_detection(device, smi, k6_row):
    """Detection (ROADMAP A14) at COCO val2017's shape, K6 on the main path: see the module docstring, phase 23."""
    import torch

    import torchmetrics_tpu_torch as tm

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    out = {"errors": {}, "values": {}}
    out["adversarial_cases"] = _k6_adversarial(device)
    _det_bbox(tm, device, out, k6_row)
    torch.cuda.empty_cache()
    _det_segm(tm, device, out)
    torch.cuda.empty_cache()
    _det_panoptic(tm, device, out)
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    row = out["k6_row"]
    print(
        f"[detection] {smi}; bbox at COCO val2017's shape ({out['images']} images, {out['gts']} ground truths,"
        f" {DET_PER_IMAGE} detections an image, {DET_CLASSES} classes): K6 device ms {row['ms']:.5f} ({row['ms_source']};"
        f" kernel alone {row['kernel_only_us'] or 0:.2f} us; both in phase 3), stream ms {row['stream_ms']['kernel']:.5f}, launches"
        f" per compute {out['main_launches']}, bound {row['bound_ms']:.5f} ({row['bound_by']}: the walk's {row['bytes']} B, its"
        f" {row['candidates']} candidate pairs in {row['candidate_sectors']} IoU sectors, {row['walk_ops']} operations), dense"
        f" bound {row['dense_bound_ms']:.5f} ({row['dense_bound_by']}, {row['dense_bytes']} B), chain floor"
        f" {row['chain_floor_ms']:.5f} (image {row['chain_image']}'s walk, {row['chain_pairs']} candidate pairs, at the chain"
        f" probe's cycles a step {K6_STEP_CYCLES}, {row['clock_mhz']:.0f} MHz), densest image alone {row['densest_image_ms']}"
        f" ({row['densest_image_source']}),"
        f" registers {row['registers']}, {row['spills']} with spills; plain matcher {row['plain_ms']:.3f} ms; read floor"
        f" {row['read_floor_ms']:.5f}; compute wall {out['compute_s']:.3f} s (timed again {out['timed_compute_s']:.3f}:"
        f" {', '.join(f'{k} {v:.4f}' for k, v in out['compute_split_s'].items())}), the CPU route's {out['cpu_compute_s']:.2f} s"
        f" on the first {DET_CPU_IMAGES} images;"
        f" peak {out['peak_mib']:.1f} MiB; update ms per {DET_BATCH} images (the IoU classes over the first {DET_IOU_IMAGES})"
        f" {', '.join(f'{k} {v:.2f}' for k, v in out['update_ms'].items())}; segm ({SEGM_IMAGES} x {SEGM_DETS}, 480 x 640)"
        f" update {out['segm_update_ms']:.1f} ms, compute {out['segm_compute_s']:.3f} s, codec = numpy on"
        f" {out['segm_codec_images']} images; PQ ({PQ_IMAGES} at 480 x 640, {PQ_THINGS} + {PQ_STUFFS} categories) update"
        f" {out['pq_update_ms']:.1f} ms per {PQ_BATCH}; K6 adversarial cases {out['adversarial_cases'][0]} bitwise"
        f" (instantiations {out['adversarial_cases'][1]}); values"
        f" {', '.join(f'{k} {v if isinstance(v, list) else round(v, 6)}' for k, v in out['values'].items())}; max |err|"
        f" {', '.join(f'{k} {v:.2e}' for k, v in out['errors'].items())}; {out['seconds']:.1f} s"
    )
    return out


# ------------------------------------------------------------------ image

IMG_SHAPE = (8, 3, 1356, 2040)  # DIV2K's 2K scale: 8 images a batch, cut from DIV2K validation's 100
IMG_BATCHES = 4
IMG_F64_IMAGES = 2  # images of the first batch held against the float64 route of the plain version
IMG_F64_ATOL = 1e-5  # SSIM, MS-SSIM, UQI, VIF, SCC per image against float64 (float32's E[x²] - mu² cancellation)
IMG_F64_RTOL = 1e-5  # PSNR, ERGAS, SAM, TV against float64
IMG_CPU_ATOL = 1e-5  # RMSE-SW, RASE, the pan-sharpening indices: the card against the port on the CPU
PAN_SHAPE = (4, 8, 1024, 1024)  # WorldView-3's 8 multispectral bands, pan and fused at 4:1 over ms
PAN_RATIO = 4
PAN_CPU_CROP = 128  # the pan-sharpening indices held card vs CPU on a crop of the first image
GEN_IMAGES = 10_000  # real and fake each, FID
GEN_CUT = 2_000  # KID, IS and MiFID each run their own tower over this many real and fake (a cut)
GEN_BATCH = 200
GEN_CPU_IMAGES = 8  # the tower held card vs CPU
TOWER_RTOL = 1e-4  # of a feature row's largest value: cuDNN's float32 convolutions against oneDNN's
LPIPS_PAIRS = 1024
LPIPS_BATCH = 64
LPIPS_SIZE = 256
LPIPS_CPU_PAIRS = 8
LPIPS_CPU_RTOL = 1e-4
PPL_SAMPLES = 1000
K7_OPS_PER_TAP = 10  # five products by the factor and five sums at each tap of each pass
K7_OPS_PER_INPUT = 3  # x², y², xy once per input pixel: the least work of the function
K7_GRAD_RTOL = 1e-4  # SSIM's gradient through K7's adjoint against autograd through the plain loop
IMG_REPS = 10


def _img_batches(device, count=IMG_BATCHES):
    """IMG_BATCHES (preds, target) pairs made on the card from SEED: ``target`` in [0, 1), ``preds`` a
    noisy copy clamped to [1/255, 1] (an 8-bit image's range: no pixel is black in every band, where
    SAM's angle is 0/0, in JAX as in the port)."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 20)
    out = []
    for _ in range(count):
        target = torch.rand(IMG_SHAPE, generator=gen, device=device)
        preds = torch.clamp(target + 0.05 * torch.randn(IMG_SHAPE, generator=gen, device=device), 1 / 255, 1)
        out.append((preds, target))
    return out


def _k7_cases(p, t, device):
    """K7's three windows on one batch, as the main paths pad and call it: ``(x, y, col, row)``."""
    from torchmetrics_tpu_torch.functional.image.helpers import _gaussian_factors, _uniform_factors, reflect_pad_2d
    from torchmetrics_tpu_torch.functional.image.metrics import _vif_factor

    vif = _vif_factor(17.0, 17 / 5, device)
    return {
        "gaussian 11x11 (SSIM, MS-SSIM, UQI)": (reflect_pad_2d(p, 5, 5), reflect_pad_2d(t, 5, 5),
                                                *_gaussian_factors((11, 11), (1.5, 1.5), device=device)),
        "uniform 7x7 (SSIM)": (reflect_pad_2d(p, 3, 3), reflect_pad_2d(t, 3, 3), *_uniform_factors((7, 7), 49.0, device=device)),
        "VIF 17x17 VALID": (t, p, vif, vif),
    }


def time_window_moments(device):
    """K7 timed in phase 3 (torch.profiler was seen to go blind late in a long
    run) on the image phase's first two batches, the Gaussian 11 x 11 case:
    device ms (profiler), stream ms, the plain loop's and cuDNN's stacked
    depthwise conv's ms (over the factors' outer product), the bounds, the
    read floor, registers. The operation bound is the separable window's: a
    row pass over every input row, then a column pass, two operations a tap a
    moment, and x², y², xy once an input."""
    import torch

    from torchmetrics_tpu_torch.functional.image.helpers import conv2d
    from torchmetrics_tpu_torch.ops import window_moments, window_moments_plain

    key = "gaussian 11x11 (SSIM, MS-SSIM, UQI)"
    arg_sets = [_k7_cases(p, t, device)[key] for p, t in _img_batches(device, 2)]
    x, y, col, row = arg_sets[0]
    b, c, hp, wp = x.shape
    kh, kw = col.numel(), row.numel()
    outputs, inputs = b * c * (hp - kh + 1) * (wp - kw + 1), x.numel()
    stacked = [torch.cat([a, bb, a * a, bb * bb, a * bb]) for a, bb, _, _ in arg_sets]
    w3 = torch.outer(col, row)[None, None].expand(c, 1, kh, kw).contiguous()

    def library(s):
        return conv2d(s, w3, groups=c)

    _require(torch.allclose(library(stacked[0]).reshape(5, b, c, hp - kh + 1, wp - kw + 1), window_moments(x, y, col, row),
                            rtol=1e-5, atol=1e-6), "K7 against cuDNN's stacked depthwise conv")
    before = window_moments.launches
    m = _measure([("kernel", window_moments, arg_sets), ("library", library, [(s,) for s in stacked])],
                 profile_reps=IMG_REPS, timing_reps=IMG_REPS)
    window_moments.launches = before  # timing launches are not the main path's
    del stacked
    torch.cuda.empty_cache()
    plain_ms = _events_ms(lambda: window_moments_plain(x, y, col, row), 1)
    floor_ms, _ = _device_ms(_read_floor, [(x,)], IMG_REPS)
    n_bytes = 2 * inputs * 4 + 5 * outputs * 4
    # a kw-tap pass along rows over all hp rows, then a kh-tap pass along columns
    n_ops = K7_OPS_PER_TAP * b * c * (wp - kw + 1) * (kw * hp + kh * (hp - kh + 1)) + K7_OPS_PER_INPUT * inputs
    bound_ms, bound_by = _bound(n_bytes, n_ops)
    log = BUILD_LOGS.get("window_moments", "")
    regs = [int(v) for line in log.splitlines() if "registers" in line for v in line.split("Used")[1].split()[:1]]
    spills = sum(1 for line in log.splitlines() if "spill" in line and not line.strip().startswith("0 bytes stack frame, 0 bytes spill"))
    del arg_sets, x, y
    torch.cuda.empty_cache()
    return {
        "name": f"window_moments ({b} x {c} x {hp - kh + 1} x {wp - kw + 1}, 11 x 11 Gaussian)",
        "route": "cuda", "source": "torchmetrics_tpu_torch/csrc/window_moments.cu",
        "replaces": "torchmetrics_tpu/functional/image/ssim.py:114", "max_abs_err": 0.0,
        "ms": m["kernel"]["device_ms"], "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": m["library"]["device_ms"],
        "stream_ms": {"kernel": m["kernel"]["stream_ms"], "plain": plain_ms, "library": m["library"]["stream_ms"]},
        "kernel_only_us": _kernel_only_us(m["kernel"]["found"], "window_moments"), "bytes": n_bytes,
        "read_floor_ms": floor_ms,
        "ops_ms": n_ops / PEAK_FP32_OPS_PER_S * 1e3, "bytes_ms": n_bytes / PEAK_BYTES_PER_S * 1e3,
        "registers": f"{min(regs, default=0)}-{max(regs, default=0)}", "spills": spills,
    }


class _K7Recorder:
    """Stands in for K7's wrapper in the image modules (``helpers``: SSIM, MS-SSIM, UQI and the pan-sharpening
    indices; ``metrics``: VIF and SCC). Every call goes to the wrapper, whose count moves as it would; while
    armed, the first launch of each (path, input shape, window shape) keeps its arguments and its result, which
    :meth:`check` then holds bit for bit against the plain loop on the same arguments."""

    def __init__(self):
        self.armed, self.path, self.calls, self.checked = False, None, {}, []

    def __enter__(self):
        from torchmetrics_tpu_torch.functional.image import helpers, metrics

        self.modules = (helpers, metrics)
        for module in self.modules:
            module.window_moments = self
        return self

    def __exit__(self, *exc):
        from torchmetrics_tpu_torch.ops import window_moments

        for module in self.modules:
            module.window_moments = window_moments

    def __call__(self, x, y, col, row):
        from torchmetrics_tpu_torch.ops import window_moments

        out = window_moments(x, y, col, row)
        key = (self.path, tuple(x.shape), (col.numel(), row.numel()))
        if self.armed and key not in self.calls:
            self.calls[key] = (x, y, col, row, out)
        return out

    def check(self):
        """Each kept launch against the plain loop, compared on the card as int32 views, then let go."""
        import torch

        from torchmetrics_tpu_torch.ops import window_moments_plain

        for (path, shape, window), (x, y, col, row, out) in self.calls.items():
            what = f"{path} {'x'.join(map(str, window))} at {'x'.join(map(str, shape))}"
            want = window_moments_plain(x, y, col, row)
            _require(out.dtype == want.dtype == torch.float32 and out.shape == want.shape, f"K7 {what}: {out.shape} vs {want.shape}")
            _require(torch.equal(out.view(torch.int32), want.view(torch.int32)), f"K7 {what}: the bits differ from the plain loop")
            self.checked.append(what)
            del want
        self.calls = {}
        torch.cuda.empty_cache()


def _k7_checks(device, batches):
    """K7 bitwise against its plain route on the edge batches (the main path's launches are held by _K7Recorder)."""
    import torch

    from torchmetrics_tpu_torch.functional.image.helpers import _uniform_factors
    from torchmetrics_tpu_torch.ops import window_moments, window_moments_plain

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 21)
    g11 = _k7_cases(*(v[:1, :1, :16, :16] for v in batches[0]), device)["gaussian 11x11 (SSIM, MS-SSIM, UQI)"][2:]
    box33 = _uniform_factors((33, 33), 1089.0, device=device)
    edges = {
        "constant images": (torch.full((2, 3, 40, 40), 0.3, device=device), torch.full((2, 3, 40, 40), -1.7, device=device), *g11),
        "a window as large as the image": (torch.rand((2, 3, 33, 33), generator=gen, device=device),
                                           torch.rand((2, 3, 33, 33), generator=gen, device=device), *box33),
        "a row pitch of 33 floats": (torch.rand((3, 2, 70, 33), generator=gen, device=device),
                                     torch.rand((3, 2, 70, 33), generator=gen, device=device), *g11),
    }
    for what, args in edges.items():
        _require_same_bits(window_moments(*args), window_moments_plain(*args), f"K7 on {what}")
    return sorted(edges)


def _conv64(x, table):
    """The plain version's filter in float64: a VALID depthwise conv of every channel."""
    import torch.nn.functional as F

    c = x.shape[1]
    return F.conv2d(x, table.to(x.dtype)[None, None].expand(c, 1, *table.shape), groups=c)


def _ssim64(p, t, table, pad, c1, c2):
    """Per-image SSIM and contrast sensitivity in float64 (JAX's formula and crops), reflection padded by ``pad``."""
    import torch

    from torchmetrics_tpu_torch.functional.image.helpers import reflect_pad_2d

    x, y = reflect_pad_2d(p, pad, pad), reflect_pad_2d(t, pad, pad)
    mx, my, exx, eyy, exy = (_conv64(v, table) for v in (x, y, x * x, y * y, x * y))
    vx, vy, cov = torch.clamp(exx - mx**2, min=0), torch.clamp(eyy - my**2, min=0), exy - mx * my
    upper, lower = 2 * cov + c2, vx + vy + c2
    ssim = ((2 * mx * my + c1) * upper) / ((mx**2 + my**2 + c1) * lower)
    cs = (upper / lower)[..., pad:-pad, pad:-pad]
    return ssim.flatten(1).mean(1), cs.flatten(1).mean(1)


def _vif64(p, t, sigma_n_sq=2.0):
    """Pixel-domain VIF in float64, every channel, then the mean (JAX's ``visual_information_fidelity``)."""
    import torch

    from torchmetrics_tpu_torch.functional.image.metrics import _vif_filter

    eps = 1e-10
    num = den = 0.0
    for scale in range(4):
        n = 2.0 ** (4 - scale) + 1
        table = _vif_filter(n, n / 5, p.device).to(torch.float64)
        if scale > 0:
            t, p = _conv64(t, table)[:, :, ::2, ::2], _conv64(p, table)[:, :, ::2, ::2]
        mt, mp, ett, epp, etp = (_conv64(v, table) for v in (t, p, t * t, p * p, t * p))
        st, sp, stp = torch.clamp(ett - mt**2, min=0), torch.clamp(epp - mp**2, min=0), etp - mt * mp
        g = stp / (st + eps)
        sv = sp - g * stp
        low_t, low_p = st < eps, sp < eps
        g, sv, st = torch.where(low_t, 0.0, g), torch.where(low_t, sp, sv), torch.where(low_t, 0.0, st)
        g, sv = torch.where(low_p, 0.0, g), torch.where(low_p, 0.0, sv)
        neg = g < 0
        sv, g = torch.where(neg, sp, sv), torch.where(neg, 0.0, g)
        sv = torch.clamp(sv, min=eps)
        num = num + torch.log10(1.0 + g**2 * st / (sv + sigma_n_sq)).sum((2, 3))
        den = den + torch.log10(1.0 + st / sigma_n_sq).sum((2, 3))
    return (num / den).mean()


def _scc64(p, t, window=8):
    """SCC in float64: the high pass by a symmetric-padded flipped filter, then the uniform window's moments."""
    import torch
    import torch.nn.functional as F

    from torchmetrics_tpu_torch.functional.image.metrics import _symmetric_reflect_pad_2d

    hp = torch.tensor([[-1.0, -1.0, -1.0], [-1.0, 8.0, -1.0], [-1.0, -1.0, -1.0]], dtype=torch.float64, device=p.device)
    p, t = (_conv64(_symmetric_reflect_pad_2d(v, (1, 1, 1, 1)), hp) * 2.0 for v in (p, t))
    left, right = math.ceil((window - 1) / 2), math.floor((window - 1) / 2)
    p, t = (F.pad(v, (left, right, left, right)) for v in (p, t))
    box = torch.ones((window, window), dtype=torch.float64, device=p.device) / window**2
    mp, mt, epp, ett, etp = (_conv64(v, box) for v in (p, t, p * p, t * t, t * p))
    den = torch.sqrt(torch.clamp(ett - mt**2, min=0)) * torch.sqrt(torch.clamp(epp - mp**2, min=0))
    cov = etp - mt * mp
    return torch.where(den == 0, 0.0, cov / torch.where(den == 0, 1.0, den)).mean()


def _img_float64_errors(tm, p32, t32):
    """The first IMG_F64_IMAGES images through the port (float32, K7) against the float64 route of the plain version."""
    import torch

    from torchmetrics_tpu_torch.functional.image.helpers import _gaussian_factors, avg_pool2d, reflect_pad_2d

    F_ = tm.functional
    p, t = p32.to(torch.float64), t32.to(torch.float64)
    g11 = torch.outer(*_gaussian_factors((11, 11), (1.5, 1.5), device=p.device)).to(torch.float64)
    rng = torch.maximum(p.max() - p.min(), t.max() - t.min())
    c1, c2 = (0.01 * rng) ** 2, (0.03 * rng) ** 2
    ref = {"ssim": _ssim64(p, t, g11, 5, c1, c2)[0],
           "ssim_uniform7": _ssim64(p, t, torch.ones((7, 7), dtype=torch.float64, device=p.device) / 49, 3, 1e-4, 9e-4)[0]}
    scales, x, y = [], p, t
    for _ in range(5):
        scales.append(_ssim64(x, y, g11, 5, 1e-4, 9e-4))
        x, y = avg_pool2d(x), avg_pool2d(y)
    mcs = torch.stack([torch.relu(cs) for _, cs in scales[:-1]] + [torch.relu(scales[-1][0])])
    betas = torch.tensor((0.0448, 0.2856, 0.3001, 0.2363, 0.1333), dtype=torch.float64, device=p.device)[:, None]
    weighted = mcs**betas
    ref["ms_ssim"] = weighted[0]
    for row in weighted[1:]:  # row by row: torch.prod on the card compiles its kernel at run time
        ref["ms_ssim"] = ref["ms_ssim"] * row
    got = {
        "ssim": F_.structural_similarity_index_measure(p32, t32, reduction="none"),
        "ssim_uniform7": F_.structural_similarity_index_measure(p32, t32, gaussian_kernel=False, kernel_size=7,
                                                                data_range=1.0, reduction="none"),
        "ms_ssim": F_.multiscale_structural_similarity_index_measure(p32, t32, data_range=1.0, reduction="none"),
        "uqi": F_.universal_image_quality_index(p32, t32),
        "vif": F_.visual_information_fidelity(p32, t32),
        "scc": F_.spatial_correlation_coefficient(p32, t32),
        "psnr": F_.peak_signal_noise_ratio(p32, t32, data_range=1.0),
        "ergas": F_.error_relative_global_dimensionless_synthesis(p32, t32),
        "sam": F_.spectral_angle_mapper(p32, t32),
        "tv": F_.total_variation(p32),
    }
    x, y = (reflect_pad_2d(v, 5, 5) for v in (p, t))
    mx, my, exx, eyy, exy = (_conv64(v, g11) for v in (x, y, x * x, y * y, x * y))
    vx, vy = torch.clamp(exx - mx**2, min=0), torch.clamp(eyy - my**2, min=0)
    uqi = (2 * mx * my * 2 * (exy - mx * my)) / ((mx**2 + my**2) * (vx + vy) + torch.finfo(torch.float32).eps)
    ref["uqi"] = uqi[..., 5:-5, 5:-5].mean()
    ref["vif"] = _vif64(p, t)
    ref["scc"] = _scc64(p, t)
    ref["psnr"] = 10 * torch.log10(1.0 / ((p - t) ** 2).mean())
    b, c = p.shape[:2]
    rmse = torch.sqrt(((p - t) ** 2).reshape(b, c, -1).mean(2))
    ref["ergas"] = (100 / 4 * torch.sqrt(((rmse / t.reshape(b, c, -1).mean(2)) ** 2).sum(1) / c)).mean()
    cos = (p * t).sum(1) / (torch.sqrt((p * p).sum(1)) * torch.sqrt((t * t).sum(1)))
    ref["sam"] = torch.arccos(torch.clamp(cos, -1, 1)).mean()
    ref["tv"] = ((p[..., 1:, :] - p[..., :-1, :]).abs().sum() + (p[..., :, 1:] - p[..., :, :-1]).abs().sum())
    errors = {}
    for key, want in ref.items():
        g = got[key].to(torch.float64)
        err = float((g - want).abs().max())
        budget = IMG_F64_ATOL if key in ("ssim", "ssim_uniform7", "ms_ssim", "uqi", "vif", "scc") else IMG_F64_RTOL * float(want.abs().max())
        _require(err <= budget, f"image {key}: {err:.3e} from float64, budget {budget:.3e}")
        errors[key] = err
    return errors


def _img_gradient_check(tm, device, p, t):
    """SSIM's gradient in ``preds`` through K7's autograd route against autograd through the plain loop, on the card."""
    import torch

    from torchmetrics_tpu_torch.functional.image import helpers
    from torchmetrics_tpu_torch.ops import window_moments, window_moments_plain

    grads = []
    for route in (window_moments, window_moments_plain):
        leaf = p[:2, :, :512, :512].clone().requires_grad_(True)
        helpers.window_moments = route
        try:
            tm.functional.structural_similarity_index_measure(leaf, t[:2, :, :512, :512]).backward()
        finally:
            helpers.window_moments = window_moments
        grads.append(leaf.grad)
    scale = float(grads[1].abs().max())
    err = float((grads[0] - grads[1]).abs().max())
    _require(err <= K7_GRAD_RTOL * scale, f"K7's gradient route: {err:.3e} from plain autograd (largest {scale:.3e})")
    return err / scale


def _img_full_reference(tm, device, batches, out):
    """The main path: the full-reference classes over IMG_BATCHES batches, K7 counted from 0 on each K7 path."""
    import torch

    from torchmetrics_tpu_torch.ops import window_moments

    I_ = tm.image
    metrics = {
        "ssim": I_.StructuralSimilarityIndexMeasure(device=device),
        "ssim_uniform7": I_.StructuralSimilarityIndexMeasure(gaussian_kernel=False, kernel_size=7, data_range=1.0, device=device),
        "ms_ssim": I_.MultiScaleStructuralSimilarityIndexMeasure(data_range=1.0, device=device),
        "uqi": I_.UniversalImageQualityIndex(device=device),
        "vif": I_.VisualInformationFidelity(device=device),
        "scc": I_.SpatialCorrelationCoefficient(device=device),
        "psnr": I_.PeakSignalNoiseRatio(data_range=1.0, device=device),
        "psnrb": I_.PeakSignalNoiseRatioWithBlockedEffect(device=device),
        "ergas": I_.ErrorRelativeGlobalDimensionlessSynthesis(device=device),
        "sam": I_.SpectralAngleMapper(device=device),
        "rmse_sw": I_.RootMeanSquaredErrorUsingSlidingWindow(device=device),
        "rase": I_.RelativeAverageSpectralError(device=device),
        "tv": I_.TotalVariation(device=device),
    }
    window_moments.launches = 0
    launches, update_ms, compute_ms, values = {}, {}, {}, {}
    with _K7Recorder() as k7:
        for name, metric in metrics.items():
            before = window_moments.launches
            walls = []
            k7.path = name
            for i, (p, t) in enumerate(batches):
                k7.armed = i == 0  # every distinct launch of the first batch is held against the plain loop
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if name == "psnrb":
                    metric.update(p[:, :1], t[:, :1])  # grayscale only: the first channel
                elif name == "tv":
                    metric.update(p)
                else:
                    metric.update(p, t)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            k7.armed = True  # UQI's launch is in its compute
            t1 = time.perf_counter()
            value = metric.compute()
            torch.cuda.synchronize()
            update_ms[name] = (walls[0], statistics.median(walls[1:]))  # the first update, the median of the rest
            compute_ms[name] = (time.perf_counter() - t1) * 1e3
            launches[name] = window_moments.launches - before
            values[name] = float(value.mean())
            _require(bool(torch.isfinite(value).all()), f"image {name}: {value}")
            metric.reset()
            k7.armed = False
            k7.check()
    out["k7_bitwise"] = k7.checked
    del metrics
    torch.cuda.empty_cache()
    want = {"ssim": IMG_BATCHES, "ssim_uniform7": IMG_BATCHES, "ms_ssim": 5 * IMG_BATCHES, "uqi": 1, "vif": 4 * IMG_BATCHES,
            "scc": IMG_BATCHES}
    for name, n in want.items():
        _require(launches[name] == n, f"K7 launched {launches[name]} times on the {name} path, expected {n}")
    _require(all(launches[k] == 0 for k in launches if k not in want), f"K7 off its paths: {launches}")
    held = {w.split()[0] for w in k7.checked}
    _require(held == set(want), f"K7's launches held bitwise on {sorted(held)}, expected {sorted(want)}")
    dy, dx = tm.functional.image_gradients(batches[0][0])
    p0 = batches[0][0]
    _require(torch.equal(dy[..., :-1, :], p0[..., 1:, :] - p0[..., :-1, :]) and torch.equal(dx[..., :, :-1], p0[..., :, 1:] - p0[..., :, :-1])
             and bool((dy[..., -1, :] == 0).all()) and bool((dx[..., :, -1] == 0).all()), "image_gradients")
    out.update(launches=launches, update_ms=update_ms, compute_ms=compute_ms, values=values)
    p, t = (v[:IMG_F64_IMAGES] for v in batches[0])
    out["f64_errors"] = _img_float64_errors(tm, p, t)
    cpu_p, cpu_t = p[:1, :, :512, :512].cpu(), t[:1, :, :512, :512].cpu()
    for name in ("root_mean_squared_error_using_sliding_window", "relative_average_spectral_error"):
        card = getattr(tm.functional, name)(p[:1, :, :512, :512], t[:1, :, :512, :512])
        cpu = getattr(tm.functional, name)(cpu_p, cpu_t)
        err = float((card.cpu() - cpu).abs().max())
        _require(err <= IMG_CPU_ATOL * max(1.0, float(cpu.abs().max())), f"image {name}: card vs CPU {err:.3e}")
        out["f64_errors"][f"{name} (card vs CPU)"] = err
    out["grad_rel_err"] = _img_gradient_check(tm, device, *batches[0])


def _img_pansharpening(tm, device, out):
    """D_lambda, D_s (with and without ``pan_lr``) and QNR at WorldView-3's 8 bands, 4:1."""
    import torch
    import torch.nn.functional as F

    from torchmetrics_tpu_torch.ops import window_moments

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 22)
    b, c, h, w = PAN_SHAPE
    ms = torch.rand((b, c, h // PAN_RATIO, w // PAN_RATIO), generator=gen, device=device)
    pan = torch.rand(PAN_SHAPE, generator=gen, device=device)
    preds = torch.clamp(0.6 * pan + 0.4 * F.interpolate(ms, scale_factor=PAN_RATIO, mode="nearest"), 0, 1)
    pan_lr = torch.rand(ms.shape, generator=gen, device=device)
    I_ = tm.image
    cases = {
        "d_lambda": (I_.SpectralDistortionIndex(device=device), (preds, ms)),
        "d_s": (I_.SpatialDistortionIndex(device=device), (preds, {"ms": ms, "pan": pan})),
        "d_s_pan_lr": (I_.SpatialDistortionIndex(device=device), (preds, {"ms": ms, "pan": pan, "pan_lr": pan_lr})),
        "qnr": (I_.QualityWithNoReference(device=device), (preds, {"ms": ms, "pan": pan})),
    }
    values, ms_wall, launches = {}, {}, {}
    with _K7Recorder() as k7:
        for name, (metric, args) in cases.items():
            before = window_moments.launches
            k7.path, k7.armed = name, name in ("d_lambda", "d_s")  # QNR's and pan_lr's launches repeat these shapes
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metric.update(*args)
            value = metric.compute()
            torch.cuda.synchronize()
            ms_wall[name] = (time.perf_counter() - t0) * 1e3
            launches[name] = window_moments.launches - before
            values[name] = float(value)
            _require(math.isfinite(values[name]) and -1e-6 <= values[name] <= 1 + 1e-6, f"pan-sharpening {name}: {values[name]}")
            k7.armed = False
            k7.check()
    _require(launches == {"d_lambda": 2, "d_s": 2, "d_s_pan_lr": 2, "qnr": 4}, f"K7 launches of the pan-sharpening indices {launches}")
    k = PAN_CPU_CROP
    crop = (preds[:1, :, :k, :k], ms[:1, :, : k // PAN_RATIO, : k // PAN_RATIO], pan[:1, :, :k, :k])
    errs = {}
    for name in ("spectral_distortion_index", "spatial_distortion_index", "quality_with_no_reference"):
        args = crop[:2] if name == "spectral_distortion_index" else crop
        card = getattr(tm.functional, name)(*args)
        cpu = getattr(tm.functional, name)(*[a.cpu() for a in args])
        errs[name] = float((card.cpu() - cpu).abs())
        _require(errs[name] <= IMG_CPU_ATOL, f"{name}: card vs CPU {errs[name]:.3e}")
    out["pan"] = {"values": values, "ms": ms_wall, "launches": launches, "cpu_errors": errs, "k7_bitwise": k7.checked}


def _gen_images(gen, device, n, real):
    import torch

    imgs = torch.randint(0, 256, (n, 3, 299, 299), generator=gen, device=device, dtype=torch.uint8)
    return imgs if real else (imgs.to(torch.float32) * 0.6 + 50).to(torch.uint8)


def _img_generative(tm, device, out):
    """FID over GEN_IMAGES real and fake at 299², KID (100 subsets of 1,000), IS (10 splits) and MiFID over GEN_CUT."""
    import numpy as np
    import torch

    from torchmetrics_tpu_torch.image.backbones.inception import InceptionFeatureExtractor

    I_ = tm.image
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 23)
    fid = I_.FrechetInceptionDistance(device=device)
    first = _gen_images(gen, device, GEN_CPU_IMAGES, True)
    cpu_feats = InceptionFeatureExtractor(("2048",), device="cpu")(first.cpu())
    card_feats = fid.inception(first).cpu()
    tower_err = float(((card_feats - cpu_feats).abs() / cpu_feats.abs().amax(1, keepdim=True)).max())
    _require(tower_err <= TOWER_RTOL, f"Inception card vs CPU: {tower_err:.3e} of each row's largest value")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(GEN_IMAGES // GEN_BATCH):
        fid.update(_gen_images(gen, device, GEN_BATCH, True), real=True)
        fid.update(_gen_images(gen, device, GEN_BATCH, False), real=False)
    torch.cuda.synchronize()
    fid_update_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fid_value = float(fid.compute())
    fid_compute_s = time.perf_counter() - t0
    n = np.float64(int(fid.real_features_num_samples))
    mean = fid.real_features_sum.double().cpu().numpy() / n
    sigma = (fid.real_features_cov_sum.double().cpu().numpy() - n * np.outer(mean, mean)) / (n - 1)
    t0 = time.perf_counter()
    np.linalg.eigvals(sigma @ sigma)
    eigvals_s = time.perf_counter() - t0
    _require(math.isfinite(fid_value) and fid_value >= -1e-3, f"FID {fid_value}")
    del fid
    torch.cuda.empty_cache()
    others = {
        "kid": I_.KernelInceptionDistance(subsets=100, subset_size=1000, device=device),
        "is": I_.InceptionScore(splits=10, device=device),
        "mifid": I_.MemorizationInformedFrechetInceptionDistance(device=device),
    }
    update_s, compute_s, values = {}, {}, {"fid": fid_value}
    for name, metric in others.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(GEN_CUT // GEN_BATCH):
            if name == "is":
                metric.update(_gen_images(gen, device, GEN_BATCH, False))
            else:
                metric.update(_gen_images(gen, device, GEN_BATCH, True), real=True)
                metric.update(_gen_images(gen, device, GEN_BATCH, False), real=False)
        torch.cuda.synchronize()
        update_s[name] = time.perf_counter() - t0
        t0 = time.perf_counter()
        value = metric.compute()
        compute_s[name] = time.perf_counter() - t0
        value = value if isinstance(value, tuple) else (value,)
        _require(all(math.isfinite(float(v)) for v in value), f"{name} {value}")
        values[name] = [float(v) for v in value]
    _require(values["is"][0] >= 1.0 - 1e-5, f"IS {values['is']}")
    out["gen"] = {"fid_images_per_s": 2 * GEN_IMAGES / fid_update_s, "fid_update_s": fid_update_s, "fid_compute_s": fid_compute_s,
                  "eigvals_s": eigvals_s, "update_s": update_s, "compute_s": compute_s, "values": values, "tower_err": tower_err}


def _img_lpips(tm, device, out):
    """LPIPS with each trunk on LPIPS_PAIRS pairs at LPIPS_SIZE², the card against the CPU on the first pairs."""
    import torch

    res = {}
    for net_type in ("alex", "vgg", "squeeze"):
        gen = torch.Generator(device=device)
        gen.manual_seed(SEED + 24)
        metric = tm.image.LearnedPerceptualImagePatchSimilarity(net_type=net_type, device=device)
        first = None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(LPIPS_PAIRS // LPIPS_BATCH):
            a = torch.rand((LPIPS_BATCH, 3, LPIPS_SIZE, LPIPS_SIZE), generator=gen, device=device) * 2 - 1
            b = torch.clamp(a + 0.3 * torch.randn(a.shape, generator=gen, device=device), -1, 1)
            first = first if first is not None else (a[:LPIPS_CPU_PAIRS], b[:LPIPS_CPU_PAIRS])
            metric.update(a, b)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        value = float(metric.compute())
        _require(math.isfinite(value) and value >= 0, f"LPIPS {net_type} {value}")
        cpu_net = tm.image.LearnedPerceptualImagePatchSimilarity(net_type=net_type, device="cpu").net
        with torch.no_grad():
            card = metric.net(*first).cpu()
            cpu = cpu_net(*(v.cpu() for v in first))
        err = float((card - cpu).abs().max() / cpu.abs().max())
        _require(err <= LPIPS_CPU_RTOL, f"LPIPS {net_type} card vs CPU {err:.3e}")
        res[net_type] = {"pairs_per_s": LPIPS_PAIRS / wall, "value": value, "cpu_rel_err": err}
    out["lpips"] = res


def _img_ppl(tm, device, out):
    """PPL over PPL_SAMPLES samples of a small seeded generator on the card, LPIPS vgg."""
    import torch

    class SmokeGenerator(torch.nn.Module):
        """128-d latents, a linear map to 3 x 64 x 64 images in [0, 255]."""

        def __init__(self):
            super().__init__()
            self.gen = torch.Generator(device=device)
            self.gen.manual_seed(SEED + 25)
            self.weight = torch.nn.Parameter(torch.randn((128, 3 * 64 * 64), generator=self.gen, device=device) / 128**0.5)

        def sample(self, n):
            return torch.randn((n, 128), generator=self.gen, device=device)

        def forward(self, z):
            return 255 * torch.sigmoid(z @ self.weight).reshape(z.shape[0], 3, 64, 64)

    metric = tm.image.PerceptualPathLength(num_samples=PPL_SAMPLES, sim_net="vgg", device=device)
    metric.update(SmokeGenerator())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mean, std, kept = metric.compute()
    torch.cuda.synchronize()
    _require(math.isfinite(float(mean)) and math.isfinite(float(std)) and 0 < kept.numel() <= PPL_SAMPLES, f"PPL {mean} {std}")
    out["ppl"] = {"s": time.perf_counter() - t0, "mean": float(mean), "kept": int(kept.numel())}


def phase_image(device, smi, k7_row):
    """The image domain (ROADMAP A14) at DIV2K's 2K scale, K7 on the main path: see the module docstring, phase 24."""
    import torch

    import torchmetrics_tpu_torch as tm

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out = {}
    batches = _img_batches(device)
    _img_full_reference(tm, device, batches, out)
    k7_row.update(launches=sum(out["launches"].values()), edge_cases=_k7_checks(device, batches))
    out["k7_row"] = k7_row
    del batches
    torch.cuda.empty_cache()
    _img_pansharpening(tm, device, out)
    torch.cuda.empty_cache()
    _img_generative(tm, device, out)
    torch.cuda.empty_cache()
    _img_lpips(tm, device, out)
    _img_ppl(tm, device, out)
    out["peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
    out["seconds"] = time.perf_counter() - t_phase
    torch.cuda.empty_cache()
    row, g, pan = out["k7_row"], out["gen"], out["pan"]
    print(
        f"[image] {smi}; K7 at {row['name']}: device ms {row['ms']:.5f} (kernel alone {row['kernel_only_us'] or 0:.2f} us),"
        f" stream ms {row['stream_ms']['kernel']:.5f}, plain {row['plain_ms']:.3f}, cuDNN's stacked depthwise conv"
        f" {row['library_ms']:.5f} device / {row['stream_ms']['library']:.5f} stream; bound {row['bound_ms']:.5f}"
        f" ({row['bound_by']}; bytes {row['bytes_ms']:.5f}, operations {row['ops_ms']:.5f}), read floor"
        f" {row['read_floor_ms']:.5f}; registers {row['registers']}, {row['spills']}"
        f" with spills; bitwise on every distinct launch of the main path's first batch ({len(out['k7_bitwise'])}:"
        f" {'; '.join(out['k7_bitwise'])}), of the pan-sharpening indices ({len(pan['k7_bitwise'])}), and on"
        f" {', '.join(row['edge_cases'])}; K7 launches on the main path"
        f" {out['launches']}; update ms a batch, first / the rest's median"
        f" {', '.join(f'{k} {v[0]:.2f} / {v[1]:.2f}' for k, v in out['update_ms'].items())};"
        f" compute ms {', '.join(f'{k} {v:.2f}' for k, v in out['compute_ms'].items())}; values"
        f" {', '.join(f'{k} {v:.6f}' for k, v in out['values'].items())}; max |err| from float64 / the CPU"
        f" {', '.join(f'{k} {v:.2e}' for k, v in out['f64_errors'].items())}; SSIM gradient route {out['grad_rel_err']:.2e} of"
        f" its largest; pan-sharpening ms {', '.join(f'{k} {v:.1f}' for k, v in pan['ms'].items())}, values"
        f" {', '.join(f'{k} {v:.6f}' for k, v in pan['values'].items())}, K7 {pan['launches']}; FID over {GEN_IMAGES} + {GEN_IMAGES}"
        f" at 299²: {g['fid_images_per_s']:.1f} images/s through the tower, compute {g['fid_compute_s']:.2f} s (host eigvals of"
        f" 2048 x 2048 alone {g['eigvals_s']:.2f} s); over {GEN_CUT} (+ {GEN_CUT}): updates s"
        f" {', '.join(f'{k} {v:.2f}' for k, v in g['update_s'].items())}, computes s"
        f" {', '.join(f'{k} {v:.2f}' for k, v in g['compute_s'].items())}; values {g['values']}; tower card vs CPU"
        f" {g['tower_err']:.2e} of a row's largest; LPIPS pairs/s at {LPIPS_SIZE}²"
        f" {', '.join(f'{k} {v['pairs_per_s']:.1f} (card vs CPU {v['cpu_rel_err']:.2e})' for k, v in out['lpips'].items())};"
        f" PPL over {PPL_SAMPLES} samples {out['ppl']['s']:.2f} s, mean {out['ppl']['mean']:.4f}; peak {out['peak_mib']:.1f} MiB;"
        f" {out['seconds']:.1f} s"
    )
    return out


# ------------------------------------------------------------------- text

TEXT_SEED = SEED + 25
PPL_SHAPE = (8, 1024, 50257)  # GPT-2's evaluation shape: batch 8, context 1,024, vocabulary 50,257
PPL_UPDATES = 8
PPL_BF16_UPDATES = 2
PPL_IGNORED = 0.05  # share of the targets set to ignore_index
PPL_IGNORE = -100
PPL_CPU_TOKENS = 128  # the first tokens of each sequence of the first batch, held card against the CPU
PPL_CPU_RTOL = 1e-5
K8_F32_BUDGET = 2e-6  # a float32 row: |K8 - plain| within this share of max(1, |plain|) (another sum order, expf)
K8_16BIT_EPS = 2  # a 16-bit row: within 2 eps of the type times max(1, |plain|) (the plain route rounds 4 times)
K8_GRAD_RTOL = 1e-5  # K8's gradient against autograd through the plain route, of the largest entry
K8_REPS = 10


def _ppl_batch(gen, device, shape=PPL_SHAPE, dtype=None):
    """One batch of GPT-2-shaped logits (float32 normal, times 3) and int64 targets, PPL_IGNORED of them
    PPL_IGNORE, made on the card from ``gen``."""
    import torch

    b, t, v = shape
    logits = torch.randn((b, t, v), generator=gen, device=device, dtype=torch.float32).mul_(3.0)
    target = torch.randint(0, v, (b, t), generator=gen, device=device)
    ignored = torch.rand((b, t), generator=gen, device=device) < PPL_IGNORED
    target = torch.where(ignored, torch.full_like(target, PPL_IGNORE), target)
    return (logits if dtype is None else logits.to(dtype)), target


def _k8_compare(got, want, what):
    """K8's ``(nll, valid)`` against the plain route's: validity equal, NaN and +-inf in the same rows, the
    finite rows within the stated budget; returns the largest error as a share of max(1, |plain|)."""
    import torch

    (nll, valid), (pnll, pvalid) = got, want
    _require(nll.dtype == pnll.dtype and nll.shape == pnll.shape, f"K8 {what}: {nll.dtype} {tuple(nll.shape)} vs {pnll.dtype}")
    _require(torch.equal(valid, pvalid), f"K8 {what}: the valid rows differ")
    a, b = nll.to(torch.float32), pnll.to(torch.float32)
    _require(torch.equal(torch.isnan(a), torch.isnan(b)), f"K8 {what}: NaN in other rows than the plain route")
    _require(torch.equal(torch.isinf(a), torch.isinf(b)) and torch.equal(a[torch.isinf(a)], b[torch.isinf(b)]),
             f"K8 {what}: +-inf in other rows than the plain route")
    fin = torch.isfinite(b)
    if not bool(fin.any()):
        return 0.0
    err = float(((a[fin] - b[fin]).abs() / b[fin].abs().clamp(min=1.0)).max())
    budget = K8_F32_BUDGET if nll.dtype == torch.float32 else K8_16BIT_EPS * torch.finfo(nll.dtype).eps
    _require(err <= budget, f"K8 {what}: error {err:.3e} of max(1, |plain|) over the budget {budget:.3e}")
    return err


def check_token_nll(device):
    """K8 against its plain route on the card on the edge batches, its gradient against autograd through
    the plain route, and its capture in a CUDA graph (a replay bitwise equal to the eager launch)."""
    import torch

    from torchmetrics_tpu_torch.ops import token_nll, token_nll_plain

    before = token_nll.launches
    gen = torch.Generator(device=device)
    gen.manual_seed(TEXT_SEED + 1)

    def rand(n, v, dtype=torch.float32):
        return torch.randn((n, v), generator=gen, device=device).mul_(3.0).to(dtype)

    def targets(n, v):
        return torch.randint(0, v, (n,), generator=gen, device=device)

    v = 1000
    special = rand(8, v)
    special[0, 7] = float("inf")
    special[1] = float("-inf")
    special[2, 3] = float("nan")
    special[3, 5] = float("-inf")
    special[4, :] = float("inf")
    wide = torch.randn((96, 1003), generator=gen, device=device)
    cases = {
        "every target ignored": (rand(64, v), torch.full((64,), PPL_IGNORE, device=device), PPL_IGNORE),
        "targets -1 and -V": (rand(64, v), torch.tensor([-1, -v] * 32, device=device), None),
        "targets >= V and < -V (NaN)": (rand(64, v), torch.tensor([v, v + 7, -v - 1, 3] * 16, device=device), PPL_IGNORE),
        "rows of +-inf and NaN logits": (special, torch.tensor([7, 2, 2, 5, 0, 1, 2, 3], device=device), None),
        "V = 1": (rand(64, 1), torch.zeros(64, dtype=torch.int64, device=device), None),
        "V = 32,000": (rand(256, 32000), targets(256, 32000), 0),
        "V = 32,000 bfloat16": (rand(256, 32000, torch.bfloat16), targets(256, 32000), None),
        "V = 32,000 float16": (rand(256, 32000, torch.float16), targets(256, 32000), None),
        "a row pitch of 1,003 (not a multiple of 4)": (wide[:, :v], targets(96, v), None),
        "a row pitch of 1,003, bfloat16": (wide.to(torch.bfloat16)[:, :v], targets(96, v), None),
        "int32 targets, V = 50,257": (rand(33, 50257), targets(33, 50257).to(torch.int32), None),
    }
    errors = {}
    for what, (x, t, ignore) in cases.items():
        errors[what] = _k8_compare(token_nll(x, t, ignore), token_nll_plain(x, t, ignore), what)
    torch.cuda.synchronize()

    x = rand(256, 32000).requires_grad_(True)
    t = torch.where(targets(256, 32000) % 7 == 0, torch.full((256,), PPL_IGNORE, device=device), targets(256, 32000))
    weights = torch.rand(256, generator=gen, device=device)
    nll, _ = token_nll(x, t, PPL_IGNORE)
    (grad,) = torch.autograd.grad((nll * weights).sum(), x)
    xp = x.detach().clone().requires_grad_(True)
    pnll, _ = token_nll_plain(xp, t, PPL_IGNORE)
    (pgrad,) = torch.autograd.grad((pnll * weights).sum(), xp)
    grad_err = float((grad - pgrad).abs().max() / pgrad.abs().max())
    _require(grad_err <= K8_GRAD_RTOL, f"K8's gradient: {grad_err:.3e} of the largest entry from autograd through the plain route")

    xs, ts = rand(512, 50257), targets(512, 50257)
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        token_nll(xs, ts, PPL_IGNORE)
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = token_nll(xs, ts, PPL_IGNORE)
    xs.copy_(rand(512, 50257))
    graph.replay()
    eager = token_nll(xs, ts, PPL_IGNORE)
    torch.cuda.synchronize()
    _require_same_bits(captured[0], eager[0], "K8 replayed from a CUDA graph against its eager launch")
    _require(torch.equal(captured[1], eager[1]), "K8's valid rows replayed from a CUDA graph")
    token_nll.launches = before  # these launches are not the main path's
    del x, xp, xs, grad, pgrad, graph
    torch.cuda.empty_cache()
    return {"errors": errors, "grad_err": grad_err}


def time_token_nll(device):
    """K8 timed in phase 3 on the main path's first batch (GPT-2's shape, float32, then the same logits in
    bfloat16): device ms (profiler), stream ms, ``F.cross_entropy(reduction="none", ignore_index=-100)``
    (the library's call for the same function; the port never calls it), the plain route, the bounds, the
    read floor, registers, and the peak memory of a Perplexity update through K8 against the plain route's."""
    import torch
    import torch.nn.functional as F

    from torchmetrics_tpu_torch.functional.text.perplexity import _perplexity_update
    from torchmetrics_tpu_torch.ops import token_nll, token_nll_plain
    from torchmetrics_tpu_torch.utilities.compute import _sum_in_xla_order

    gen = torch.Generator(device=device)
    gen.manual_seed(TEXT_SEED)
    logits, target = _ppl_batch(gen, device)
    n, v = logits.shape[0] * logits.shape[1], logits.shape[2]
    x, t = logits.reshape(n, v), target.reshape(n)
    before = token_nll.launches
    out = {}
    for label, xx in (("float32", x), ("bfloat16", x.to(torch.bfloat16))):
        err = _k8_compare(token_nll(xx, t, PPL_IGNORE), token_nll_plain(xx, t, PPL_IGNORE), f"GPT-2's shape, {label}")

        def library(a, b):
            return F.cross_entropy(a, b, reduction="none", ignore_index=PPL_IGNORE)

        m = _measure([("kernel", token_nll, [(xx, t, PPL_IGNORE)]), ("library", library, [(xx, t)])],
                     profile_reps=K8_REPS, timing_reps=K8_REPS)
        plain_ms = _events_ms(lambda: token_nll_plain(xx, t, PPL_IGNORE), 2)
        floor_ms, _ = _device_ms(_read_floor, [(xx,)], K8_REPS)
        n_bytes = xx.numel() * xx.element_size() + t.numel() * t.element_size() + n * (xx.element_size() + 1)
        n_ops = 3 * n * v  # a compare, an exponential and an add a logit
        bound_ms, bound_by = _bound(n_bytes, n_ops)
        out[label] = {
            "max_abs_err": err, "ms": m["kernel"]["device_ms"], "library_ms": m["library"]["device_ms"], "plain_ms": plain_ms,
            "stream_ms": {"kernel": m["kernel"]["stream_ms"], "plain": plain_ms, "library": m["library"]["stream_ms"]},
            "kernel_only_us": _kernel_only_us(m["kernel"]["found"], "token_nll"), "bytes": n_bytes, "bound_ms": bound_ms,
            "bound_by": bound_by, "read_floor_ms": floor_ms, "bytes_ms": n_bytes / PEAK_BYTES_PER_S * 1e3,
            "ops_ms": n_ops / PEAK_FP32_OPS_PER_S * 1e3,
        }
        torch.cuda.empty_cache()
    peak = {}
    for label, fn in (("K8", lambda: _perplexity_update(logits, target, PPL_IGNORE)),
                      ("plain", lambda: _sum_in_xla_order(token_nll_plain(x, t, PPL_IGNORE)[0]))):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        peak[label] = (torch.cuda.max_memory_allocated() - base) / 2**20
        torch.cuda.empty_cache()
    token_nll.launches = before  # timing launches are not the main path's
    log = BUILD_LOGS.get("token_nll", "")
    regs = [int(w) for line in log.splitlines() if "registers" in line for w in line.split("Used")[1].split()[:1]]
    spills = sum(1 for line in log.splitlines() if "spill" in line and not line.strip().startswith("0 bytes stack frame, 0 bytes spill"))
    row = dict(out["float32"])
    row.update(
        name=f"token_nll ({n} x {v}, float32)", route="cuda", source="torchmetrics_tpu_torch/csrc/token_nll.cu",
        replaces="torchmetrics_tpu/functional/text/perplexity.py:44", bf16=out["bfloat16"], peak_mib=peak,
        registers=f"{min(regs, default=0)}-{max(regs, default=0)}", spills=spills,
    )
    del logits, target, x, t
    torch.cuda.empty_cache()
    return row


ASR_UTTERANCES = 2620  # LibriSpeech test-clean: 2,620 utterances, 52,576 words
ASR_MEAN_WORDS = 20.07
ASR_VOCAB = 8000
ASR_EDITS = (0.03, 0.01, 0.01)  # substitutions, insertions, deletions a word
ASR_BATCH = 64
ASR_DP_PAIRS = 200
MT_SEGMENTS = 3003  # WMT14 en-de newstest2014: 3,003 segments, one reference each
MT_HOST_SEGMENTS = 1024  # the MT metrics (host Python on the card's CPU) take the first 1,024 (16 batches) of them
MT_MEAN_WORDS = 20.6
MT_VOCAB = 20000
MT_BATCH = 64
MT_BLEU_RTOL = 1e-6  # BLEU's value card against CPU (states bitwise; the log and exp of each device)
MT_CPU_BATCHES = 8  # the CPU route is fed the first 8 batches (512 segments) and held against the card's states then
SQUAD_QUESTIONS = 10570  # SQuAD v1.1 dev
SQUAD_BATCH = 1024
BERT_VOCAB = 30522  # bert-base-uncased's published widths: 12 layers, hidden 768, 12 heads, FFN 3,072
BERT_MAX_LENGTH = 128
BERT_BATCH = 64
BERT_ALL_LAYERS_PAIRS = 64
BERT_CPU_PAIRS = 16
BERT_CPU_ATOL = 1e-4  # a score card against CPU: 12 float32 layers through cuBLAS and oneDNN in other orders
INFOLM_PAIRS = 256  # cut: InfoLM runs one forward per token of every sentence (KL divergence)
INFOLM_AB_PAIRS = 64  # the AB divergence, cut further: the first 64 of them (about 20 s at 256 on an H100)
INFOLM_CPU_PAIRS = 4
INFOLM_CPU_RTOL = 1e-4  # of max(1, |score|), card against CPU
TEXT_MT_CLASSES = ("BLEUScore", "SacreBLEUScore 13a", "SacreBLEUScore intl", "CHRFScore", "TranslationEditRate",
                   "ExtendedEditDistance", "ROUGEScore")


def _text_words(rng, n, capital_share=0.0):
    """``n`` distinct seeded lowercase words of 2-10 letters (a share capitalized)."""
    import numpy as np

    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    words = set()
    while len(words) < n:
        w = "".join(rng.choice(letters, int(rng.integers(2, 11))))
        words.add(w.capitalize() if rng.random() < capital_share else w)
    return sorted(words)


def _text_edit(rng, words, vocab, sub, ins, dele, swap=0.0):
    """A hypothesis from a reference: each word dropped, replaced, or followed by an inserted word at these
    rates, and with probability ``swap`` one word moved two places on (a reordering for TER's shifts)."""
    out = []
    for w in words:
        r = rng.random()
        if r < dele:
            continue
        out.append(str(vocab[int(rng.integers(len(vocab)))]) if r < dele + sub else w)
        if rng.random() < ins:
            out.append(str(vocab[int(rng.integers(len(vocab)))]))
    if swap and len(out) > 4 and rng.random() < swap:
        k = int(rng.integers(0, len(out) - 3))
        out[k : k + 3] = out[k + 1 : k + 3] + out[k : k + 1]
    return out


def _text_corpus(seed, n, mean_words, n_vocab, edits, capital_share=0.0, punct=False, swap=0.0):
    """Seeded references of Zipf-distributed words, lognormal lengths of mean ``mean_words``, and their
    hypotheses (``_text_edit``)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    vocab = _text_words(rng, n_vocab, capital_share)
    lens = np.clip(np.round(rng.lognormal(np.log(mean_words) - 0.18, 0.6, n)), 1, 100).astype(int)
    p = 1.0 / (np.arange(n_vocab) + 10.0)
    ids = rng.choice(n_vocab, size=int(lens.sum()), p=p / p.sum())
    refs, hyps, k = [], [], 0
    for length in lens:
        words = [vocab[i] for i in ids[k : k + length]]
        k += length
        if punct:
            for j in range(len(words)):
                if rng.random() < 0.08:
                    words[j] += str(rng.choice([",", ";", ":", "!", "?"]))
                elif rng.random() < 0.02:
                    words[j] = str(int(rng.integers(0, 10000)))
            words[-1] += "."
        refs.append(" ".join(words))
        hyps.append(" ".join(_text_edit(rng, words, vocab, *edits, swap=swap)))
    return hyps, refs


def _levenshtein(a, b):
    """The textbook DP, in Python."""
    prev = list(range(len(b) + 1))
    for i, x in enumerate(a, 1):
        cur = [i]
        for j, y in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (x != y)))
        prev = cur
    return prev[-1]


def _states_equal(card, cpu, what):
    """Every state of a card metric bitwise equal to the CPU route's (lists leaf by leaf)."""
    for key, value in card.state_tree().items():
        want = cpu.state_tree()[key]
        for i, (a, b) in enumerate(zip(*[v if isinstance(v, list) else [v] for v in (value, want)])):
            _require_same_bits(a, b, f"{what} state {key}[{i}] card against CPU")
        if isinstance(value, list):
            _require(len(value) == len(want), f"{what} state {key}: {len(value)} leaves against {len(want)}")


def _flat_values(value):
    import torch

    if isinstance(value, dict):
        return {k: v for k, v in value.items() if isinstance(v, torch.Tensor)}
    if isinstance(value, tuple):
        return {str(i): v for i, v in enumerate(value)}
    return {"value": value}


def _text_asr(tm, device, out):
    """The error-rate family over LibriSpeech test-clean's shape, card against the CPU route bitwise, the
    first ASR_DP_PAIRS pairs against a Python DP."""
    hyps, refs = _text_corpus(TEXT_SEED + 2, ASR_UTTERANCES, ASR_MEAN_WORDS, ASR_VOCAB, ASR_EDITS)
    names = ("WordErrorRate", "CharErrorRate", "MatchErrorRate", "WordInfoLost", "WordInfoPreserved", "EditDistance")
    timing, values = {}, {}
    for name in names:
        card, cpu = getattr(tm, name)(), getattr(tm, name)(device="cpu")
        t0 = time.perf_counter()
        for i in range(0, len(hyps), ASR_BATCH):
            card.update(hyps[i : i + ASR_BATCH], refs[i : i + ASR_BATCH])
        t1 = time.perf_counter()
        value = card.compute()
        timing[name] = ((t1 - t0) * 1e3 / -(-len(hyps) // ASR_BATCH), (time.perf_counter() - t1) * 1e3)
        for i in range(0, len(hyps), ASR_BATCH):
            cpu.update(hyps[i : i + ASR_BATCH], refs[i : i + ASR_BATCH])
        _states_equal(card, cpu, name)
        _require_same_bits(value, cpu.compute(), f"{name} value card against CPU")
        values[name] = float(value)
    head = slice(0, ASR_DP_PAIRS)
    word_dp = [_levenshtein(h.split(), r.split()) for h, r in zip(hyps[head], refs[head])]
    char_dp = [_levenshtein(h, r) for h, r in zip(hyps[head], refs[head])]
    wer, cer, ed = tm.WordErrorRate(), tm.CharErrorRate(), tm.EditDistance(reduction="none")
    for m in (wer, cer, ed):
        m.update(hyps[head], refs[head])
    _require(float(wer.errors) == sum(word_dp) and float(wer.total) == sum(len(r.split()) for r in refs[head]),
             f"WER over the first {ASR_DP_PAIRS} pairs: {float(wer.errors)} errors against the Python DP's {sum(word_dp)}")
    _require(float(cer.errors) == sum(char_dp), f"CER: {float(cer.errors)} against the Python DP's {sum(char_dp)}")
    _require(ed.compute().cpu().tolist() == char_dp, "EditDistance per pair against the Python DP")
    out["asr"] = {"words": sum(len(r.split()) for r in refs), "ms": timing, "values": values}


def _text_mt(tm, device, out):
    """BLEU, SacreBLEU (13a, intl), chrF++, TER, EED and ROUGE over WMT14 en-de newstest2014's shape on the
    card, each update and compute timed; the CPU route fed the first MT_CPU_BATCHES batches, its states then
    bitwise equal to the card's at that point, and its value too."""
    hyps, refs = _text_corpus(TEXT_SEED + 3, MT_SEGMENTS, MT_MEAN_WORDS, MT_VOCAB, (0.15, 0.03, 0.05),
                              capital_share=0.3, punct=True, swap=0.3)
    hyps, refs = hyps[:MT_HOST_SEGMENTS], refs[:MT_HOST_SEGMENTS]
    targets = [[r] for r in refs]
    makers = {
        "BLEUScore": lambda **kw: tm.BLEUScore(n_gram=4, **kw),
        "SacreBLEUScore 13a": lambda **kw: tm.SacreBLEUScore(tokenize="13a", **kw),
        "SacreBLEUScore intl": lambda **kw: tm.SacreBLEUScore(tokenize="intl", **kw),
        "CHRFScore": lambda **kw: tm.CHRFScore(n_word_order=2, **kw),
        "TranslationEditRate": lambda **kw: tm.TranslationEditRate(**kw),
        "ExtendedEditDistance": lambda **kw: tm.ExtendedEditDistance(**kw),
        "ROUGEScore": lambda **kw: tm.ROUGEScore(rouge_keys=("rouge1", "rouge2", "rougeL", "rougeLsum"), **kw),
    }
    timing, values = {}, {}
    for name, make in makers.items():
        card, cpu = make(), make(device="cpu")
        t0 = time.perf_counter()
        for b, i in enumerate(range(0, len(hyps), MT_BATCH)):
            if b == MT_CPU_BATCHES:
                head = {k: [x.clone() for x in v] if isinstance(v, list) else v if k == "_update_count" else v.clone()
                        for k, v in card.state_tree(include_count=True).items()}
                t_head = time.perf_counter()
                for j in range(0, i, MT_BATCH):
                    cpu.update(hyps[j : j + MT_BATCH], targets[j : j + MT_BATCH])
                t0 += time.perf_counter() - t_head
            card.update(hyps[i : i + MT_BATCH], targets[i : i + MT_BATCH])
        t1 = time.perf_counter()
        value = card.compute()
        timing[name] = ((t1 - t0) * 1e3 / -(-len(hyps) // MT_BATCH), (time.perf_counter() - t1) * 1e3)
        for key, want in cpu.state_tree(include_count=True).items():
            got = head[key]
            if key == "_update_count":
                _require(got == want, f"{name}: {got} updates against the CPU's {want}")
                continue
            for i, (a, b) in enumerate(zip(*[v if isinstance(v, list) else [v] for v in (got, want)])):
                _require_same_bits(a, b, f"{name} state {key}[{i}] after {MT_CPU_BATCHES} batches, card against CPU")
        card_head = make()
        card_head.load_state_tree({k: v for k, v in head.items()})
        head_values = _flat_values(card_head.compute())
        for key, v in _flat_values(cpu.compute()).items():
            if name.startswith(("BLEU", "SacreBLEU")):  # exp(sum(w * log p)) through each device's float32 log and exp
                got = float(head_values[key])
                _require(abs(got - float(v)) <= MT_BLEU_RTOL * abs(float(v)), f"{name} value card {got} against CPU {float(v)}")
            else:
                _require_same_bits(head_values[key], v, f"{name} value {key} card against CPU")
        values[name] = {k: float(v) for k, v in _flat_values(value).items()}
        for key, v in values[name].items():
            _require(math.isfinite(v) and 0.0 <= v <= (1.0 if name != "TranslationEditRate" else 10.0), f"{name} {key} = {v}")
    out["mt"] = {"words": sum(len(r.split()) for r in refs), "ms": timing, "values": values}


def _text_squad(tm, device, out):
    """SQuAD over SQuAD v1.1 dev's shape (10,570 questions with 1-3 answers), card against CPU bitwise."""
    import numpy as np

    rng = np.random.default_rng(TEXT_SEED + 4)
    vocab = np.array(_text_words(rng, 5000))
    preds, targets = [], []
    for q in range(SQUAD_QUESTIONS):
        answers = [" ".join(rng.choice(vocab, int(rng.integers(1, 6)))) for _ in range(int(rng.integers(1, 4)))]
        r = rng.random()
        first = answers[0].split()
        if r < 0.6:
            pred = ("the " if rng.random() < 0.2 else "") + answers[int(rng.integers(len(answers)))]
        elif r < 0.85:
            pred = " ".join(first[: max(1, len(first) - 1)] + list(rng.choice(vocab, 1)))
        else:
            pred = " ".join(rng.choice(vocab, int(rng.integers(1, 5))))
        preds.append({"prediction_text": pred, "id": f"q{q}"})
        targets.append({"answers": {"answer_start": [0] * len(answers), "text": answers}, "id": f"q{q}"})
    card, cpu = tm.SQuAD(), tm.SQuAD(device="cpu")
    t0 = time.perf_counter()
    for i in range(0, SQUAD_QUESTIONS, SQUAD_BATCH):
        card.update(preds[i : i + SQUAD_BATCH], targets[i : i + SQUAD_BATCH])
        cpu.update(preds[i : i + SQUAD_BATCH], targets[i : i + SQUAD_BATCH])
    value = card.compute()
    seconds = time.perf_counter() - t0
    _states_equal(card, cpu, "SQuAD")
    for key, v in cpu.compute().items():
        _require_same_bits(value[key], v, f"SQuAD {key} card against CPU")
    _require(float(card.total) == SQUAD_QUESTIONS, f"SQuAD counted {float(card.total)} questions")
    out["squad"] = {"s": seconds, "values": {k: float(v) for k, v in value.items()}}


def _text_perplexity(tm, device, out):
    """The main path: Perplexity over PPL_UPDATES batches at GPT-2's shape made on the card, K8 counted from
    0 (one launch an update); the first batch's rows held against the plain route, a slice of it card against
    CPU; then PPL_BF16_UPDATES bfloat16 updates."""
    import torch

    from torchmetrics_tpu_torch.functional.text.perplexity import perplexity
    from torchmetrics_tpu_torch.ops import token_nll, token_nll_plain
    from torchmetrics_tpu_torch.utilities.compute import _sum_in_xla_order

    gen = torch.Generator(device=device)
    gen.manual_seed(TEXT_SEED)
    metric = tm.Perplexity(ignore_index=PPL_IGNORE)
    token_nll.launches = 0
    update_ms, kept, counted = [], 0, 0
    for i in range(PPL_UPDATES):
        logits, target = _ppl_batch(gen, device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metric.update(logits, target)
        torch.cuda.synchronize()
        update_ms.append((time.perf_counter() - t0) * 1e3)
        counted += int((target != PPL_IGNORE).sum())
        if i == 0:
            first = (logits, target, metric.total_log_probs.clone())
    launches = token_nll.launches
    _require(launches == PPL_UPDATES, f"K8 launched {launches} times over {PPL_UPDATES} Perplexity updates")
    value = float(metric.compute())
    _require(math.isfinite(value) and value > 1.0, f"Perplexity {value}")
    _require(float(metric.count) == counted, f"Perplexity counted {float(metric.count)} tokens, the batches hold {counted}")
    logits, target, total0 = first
    x, t = logits.reshape(-1, logits.shape[-1]), target.reshape(-1)
    row_err = _k8_compare(token_nll(x, t, PPL_IGNORE), token_nll_plain(x, t, PPL_IGNORE), "the main path's first batch")
    plain_total = float(_sum_in_xla_order(token_nll_plain(x, t, PPL_IGNORE)[0]))
    total_err = abs(float(total0) - plain_total) / abs(plain_total)
    _require(total_err <= K8_F32_BUDGET, f"the first update's total {float(total0)} against the plain route's {plain_total}")
    head = (logits[:, :PPL_CPU_TOKENS].contiguous(), target[:, :PPL_CPU_TOKENS].contiguous())
    card_ppl = float(perplexity(*head, ignore_index=PPL_IGNORE))
    cpu_ppl = float(perplexity(head[0].cpu(), head[1].cpu(), ignore_index=PPL_IGNORE))
    _require(abs(card_ppl - cpu_ppl) <= PPL_CPU_RTOL * cpu_ppl, f"perplexity card {card_ppl} against CPU {cpu_ppl}")
    del first, logits, target, x, t, head
    torch.cuda.empty_cache()
    half = tm.Perplexity(ignore_index=PPL_IGNORE)
    before = token_nll.launches
    for _ in range(PPL_BF16_UPDATES):
        logits, target = _ppl_batch(gen, device, dtype=torch.bfloat16)
        half.update(logits, target)
    _require(token_nll.launches - before == PPL_BF16_UPDATES, "K8 on the bfloat16 stream: one launch an update")
    half_value = float(half.compute())
    _require(math.isfinite(half_value) and half.total_log_probs.dtype == torch.float32, f"bfloat16 Perplexity {half_value}")
    del logits, target
    torch.cuda.empty_cache()
    out["ppl"] = {"launches": launches, "value": value, "bf16_value": half_value, "update_ms": update_ms,
                  "row_err": row_err, "total_err": total_err, "cpu": (card_ppl, cpu_ppl)}


class _WordHashTokenizer:
    """A seeded offline word tokenizer with bert-base-uncased's special ids: lowercased words split on
    whitespace, each to ``1000 + crc32(word) % (vocab - 1000)``, [CLS] 101 first, [SEP] 102 last, [PAD] 0."""

    cls_token_id, sep_token_id, pad_token_id, mask_token_id = 101, 102, 0, 103

    def __init__(self, vocab_size=BERT_VOCAB):
        self.vocab_size = vocab_size

    def __call__(self, text, padding=True, truncation=True, max_length=None, return_tensors="np", **kw):
        import zlib

        import numpy as np

        max_length = max_length or 512
        rows = []
        for sentence in text:
            ids = [1000 + zlib.crc32(w.encode()) % (self.vocab_size - 1000) for w in sentence.lower().split()]
            rows.append([self.cls_token_id] + ids[: max_length - 2] + [self.sep_token_id])
        width = max_length if padding == "max_length" else max(len(r) for r in rows)
        input_ids = np.zeros((len(rows), width), np.int64)
        attention_mask = np.zeros((len(rows), width), np.int64)
        for i, r in enumerate(rows):
            input_ids[i, : len(r)] = r
            attention_mask[i, : len(r)] = 1
        return {"input_ids": input_ids, "attention_mask": attention_mask}


def _bert_towers(device):
    """bert-base-uncased's architecture with seeded weights: the encoder (BERTScore) and the masked LM
    (InfoLM), on the card."""
    import torch
    from transformers import BertConfig, BertForMaskedLM, BertModel

    config = BertConfig(vocab_size=BERT_VOCAB, hidden_size=768, num_hidden_layers=12, num_attention_heads=12,
                        intermediate_size=3072, max_position_embeddings=512)
    torch.manual_seed(TEXT_SEED)
    encoder = BertModel(config).eval().to(device)
    torch.manual_seed(TEXT_SEED + 1)
    mlm = BertForMaskedLM(config).eval().to(device)
    return encoder, mlm


def _text_towers(tm, device, out):
    """BERTScore and InfoLM at bert-base-uncased's widths with seeded weights and the word-hash tokenizer:
    see the module docstring, phase 25. The default-model paths raise (nothing is downloaded)."""
    import copy

    import torch

    from torchmetrics_tpu_torch.functional.text import bert_score, infolm

    os.environ.setdefault("HF_HUB_OFFLINE", "1")  # the default-model paths read the local cache alone; say so to the hub too
    for make in (lambda: tm.BERTScore(), lambda: tm.InfoLM()):
        try:
            make()
        except (OSError, ModuleNotFoundError) as err:
            out.setdefault("default_raises", []).append(type(err).__name__)
        else:
            raise SmokeFailure("a default-model path loaded a model: nothing should be in the cache")
    hyps, refs = _text_corpus(TEXT_SEED + 3, MT_SEGMENTS, MT_MEAN_WORDS, MT_VOCAB, (0.15, 0.03, 0.05),
                              capital_share=0.3, punct=True, swap=0.3)
    tok = _WordHashTokenizer()
    encoder, mlm = _bert_towers(device)
    res = {}
    for idf in (False, True):
        metric = tm.BERTScore(model=encoder, user_tokenizer=tok, idf=idf, max_length=BERT_MAX_LENGTH, batch_size=BERT_BATCH)
        t0 = time.perf_counter()
        for i in range(0, len(hyps), BERT_BATCH):
            metric.update(hyps[i : i + BERT_BATCH], refs[i : i + BERT_BATCH])
        t1 = time.perf_counter()
        score = metric.compute()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        f1 = score["f1"]
        _require(f1.shape == (len(hyps),) and bool(torch.isfinite(f1).all()), f"BERTScore idf={idf}: {f1.shape}")
        res[f"idf={idf}"] = {"update_s": t1 - t0, "compute_s": t2 - t1, "f1": float(f1.mean()),
                             "pairs_per_s": len(hyps) / (t2 - t1)}
    layers = bert_score(hyps[:BERT_ALL_LAYERS_PAIRS], refs[:BERT_ALL_LAYERS_PAIRS], model=encoder, user_tokenizer=tok,
                        all_layers=True, max_length=BERT_MAX_LENGTH)
    n_states = encoder.config.num_hidden_layers + 1  # the embeddings' output and each layer's
    _require(layers["f1"].shape == (n_states * BERT_ALL_LAYERS_PAIRS,) and bool(torch.isfinite(layers["f1"]).all()),
             f"all_layers: {layers['f1'].shape}")
    cpu_encoder = copy.deepcopy(encoder).cpu()
    head = (hyps[:BERT_CPU_PAIRS], refs[:BERT_CPU_PAIRS])
    bert_err = 0.0
    for idf in (False, True):
        card = bert_score(*head, model=encoder, user_tokenizer=tok, idf=idf, max_length=BERT_MAX_LENGTH)
        cpu = bert_score(*head, model=cpu_encoder, user_tokenizer=tok, idf=idf, max_length=BERT_MAX_LENGTH)
        for key in ("precision", "recall", "f1"):
            bert_err = max(bert_err, float((card[key].cpu() - cpu[key]).abs().max()))
    _require(bert_err <= BERT_CPU_ATOL, f"BERTScore card against CPU on {BERT_CPU_PAIRS} pairs: {bert_err:.2e}")
    del cpu_encoder
    measures = {"kl_divergence": ({}, INFOLM_PAIRS), "ab_divergence": ({"alpha": 0.5, "beta": 0.5}, INFOLM_AB_PAIRS)}
    for measure, (kw, pairs) in measures.items():
        metric = tm.InfoLM(model=mlm, user_tokenizer=tok, information_measure=measure, return_sentence_level_score=True, **kw)
        t0 = time.perf_counter()
        for i in range(0, pairs, BERT_BATCH):
            metric.update(hyps[i : min(i + BERT_BATCH, pairs)], refs[i : min(i + BERT_BATCH, pairs)])
        mean, sentences = metric.compute()
        torch.cuda.synchronize()
        _require(sentences.shape == (pairs,) and bool(torch.isfinite(sentences).all()), f"InfoLM {measure}")
        res[f"infolm {measure} ({pairs} pairs)"] = {"s": time.perf_counter() - t0, "mean": float(mean)}
    cpu_mlm = copy.deepcopy(mlm).cpu()
    head = (hyps[:INFOLM_CPU_PAIRS], refs[:INFOLM_CPU_PAIRS])
    infolm_err = 0.0
    for measure, (kw, _) in measures.items():
        _, card = infolm(*head, model=mlm, user_tokenizer=tok, information_measure=measure, return_sentence_level_score=True, **kw)
        _, cpu = infolm(*head, model=cpu_mlm, user_tokenizer=tok, information_measure=measure, return_sentence_level_score=True, **kw)
        infolm_err = max(infolm_err, float(((card.cpu() - cpu).abs() / cpu.abs().clamp(min=1.0)).max()))
    _require(infolm_err <= INFOLM_CPU_RTOL, f"InfoLM card against CPU on {INFOLM_CPU_PAIRS} pairs: {infolm_err:.2e}")
    del encoder, mlm, cpu_mlm
    torch.cuda.empty_cache()
    out["towers"] = {**res, "bert_cpu_err": bert_err, "infolm_cpu_err": infolm_err}


def phase_text(device, smi, k8_row):
    """The text domain (ROADMAP A14), K8 on Perplexity's main path: see the module docstring, phase 25."""
    import torch

    import torchmetrics_tpu_torch as tm

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out = {}
    _text_perplexity(tm, device, out)
    k8_row.update(launches=out["ppl"]["launches"], checks=check_token_nll(device))
    out["k8_row"] = k8_row
    _text_asr(tm, device, out)
    _text_mt(tm, device, out)
    _text_squad(tm, device, out)
    _text_towers(tm, device, out)
    out["peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
    out["seconds"] = time.perf_counter() - t_phase
    row, ppl, tw = k8_row, out["ppl"], out["towers"]
    print(
        f"[text] {smi}; K8 at {row['name']}: device ms {row['ms']:.5f} (kernel alone {row['kernel_only_us'] or 0:.2f} us),"
        f" stream ms {row['stream_ms']['kernel']:.5f}, plain {row['plain_ms']:.3f}, F.cross_entropy"
        f" {row['library_ms']:.5f} device / {row['stream_ms']['library']:.5f} stream; bound {row['bound_ms']:.5f}"
        f" ({row['bound_by']}; bytes {row['bytes_ms']:.5f}, operations {row['ops_ms']:.5f}), read floor {row['read_floor_ms']:.5f};"
        f" bfloat16: device ms {row['bf16']['ms']:.5f}, F.cross_entropy {row['bf16']['library_ms']:.5f}, plain"
        f" {row['bf16']['plain_ms']:.3f}, bound {row['bf16']['bound_ms']:.5f}, read floor {row['bf16']['read_floor_ms']:.5f};"
        f" registers {row['registers']}, {row['spills']} with spills; peak MiB of an update K8 {row['peak_mib']['K8']:.1f},"
        f" plain {row['peak_mib']['plain']:.1f}; row errors (of max(1, |plain|)) {row['max_abs_err']:.2e} float32,"
        f" {row['bf16']['max_abs_err']:.2e} bfloat16, main path {ppl['row_err']:.2e}, edge batches"
        f" {'; '.join(f'{k} {v:.2e}' for k, v in row['checks']['errors'].items())}; gradient {row['checks']['grad_err']:.2e};"
        f" captured in a CUDA graph; K8 launches on the main path {ppl['launches']}; Perplexity {ppl['value']:.4f}"
        f" (bfloat16 stream {ppl['bf16_value']:.4f}), update ms {', '.join(f'{v:.2f}' for v in ppl['update_ms'])},"
        f" card/CPU {ppl['cpu'][0]:.6f}/{ppl['cpu'][1]:.6f}; ASR ({out['asr']['words']} words) update/compute ms"
        f" {', '.join(f'{k} {a:.2f}/{b:.2f}' for k, (a, b) in out['asr']['ms'].items())}, values"
        f" {', '.join(f'{k} {v:.6f}' for k, v in out['asr']['values'].items())}; MT ({out['mt']['words']} words) update/compute ms"
        f" {', '.join(f'{k} {a:.2f}/{b:.2f}' for k, (a, b) in out['mt']['ms'].items())}, values {out['mt']['values']};"
        f" SQuAD {out['squad']['s']:.2f} s (card and CPU) {out['squad']['values']}; towers {tw}; default models raise"
        f" {out['default_raises']}; peak {out['peak_mib']:.1f} MiB; {out['seconds']:.1f} s"
    )
    return out


# ------------------------------------------------------------- multimodal

MM_SEED = SEED + 27
#: openai/clip-vit-large-patch14's published widths (CLIPScore's default model)
CLIP_L14 = {"vision": dict(num_hidden_layers=24, hidden_size=1024, num_attention_heads=16, intermediate_size=4096,
                           patch_size=14, image_size=224),
            "text": dict(num_hidden_layers=12, hidden_size=768, num_attention_heads=12, intermediate_size=3072,
                         vocab_size=49408, max_position_embeddings=77),
            "projection_dim": 768}
#: openai/clip-vit-base-patch16's published widths (CLIP-IQA's default model)
CLIP_B16 = {"vision": dict(num_hidden_layers=12, hidden_size=768, num_attention_heads=12, intermediate_size=3072,
                           patch_size=16, image_size=224),
            "text": dict(num_hidden_layers=12, hidden_size=512, num_attention_heads=8, intermediate_size=2048,
                         vocab_size=49408, max_position_embeddings=77),
            "projection_dim": 512}
CLIP_BOS, CLIP_EOS = 49406, 49407  # CLIP's tokenizer: <|startoftext|>, <|endoftext|> (also its padding)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)  # CLIP's published image normalisation
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
COCO_IMAGE = (3, 480, 640)  # MS-COCO val2017's common shape (640 x 480), uint8
COCO_IMAGES = 1024  # cut from val2017's 5,000
COCO_BATCH = 64
COCO_WORDS = (8, 20)  # one caption an image, 8-20 words
COCO_LONG = (3, 9, 14)  # the batches holding a caption of 90 words (past CLIP's 77 positions)
KONIQ_IMAGE = (3, 768, 1024)  # KonIQ-10k's 1024 x 768 images, in [0, 1]
KONIQ_IMAGES = 512  # cut from KonIQ-10k's 10,073
KONIQ_BATCH = 64
IQA_CUSTOM = ("Crisp photo.", "Grainy photo.")
MM_CPU_IMAGES = 4
CLIP_SCORE_CPU_ATOL = 1e-3  # 100 * cos, card against CPU: 24 (ViT-L) float32 layers through cuBLAS and oneDNN
CLIP_IQA_CPU_ATOL = 2e-4  # a probability, card against CPU: p(1 - p) * 100 times the cosines' gap at most
MM_BATCHING_ATOL = 1e-3  # 100 * cos on the card, the same pairs in batches of other sizes


class _ClipProcessor:
    """The harness's CLIP processor, written in torch and numpy (no PIL): images (3, H, W) uint8 (scaled by
    1/255) or float in [0, 1], their shortest side resized to 224 (bicubic, antialiased), centre-cropped to
    224 x 224 and normalised by CLIP's mean and std; text lowercased, split on whitespace, each word to
    ``crc32(word, seed) % 49406``, between <|startoftext|> and <|endoftext|>, padded with <|endoftext|> to
    the longest caption and never truncated (the metric truncates at 77 and warns). Times its calls."""

    def __init__(self, seed=MM_SEED, size=224):
        self.seed, self.size, self.seconds = seed, size, []

    def _pixels(self, images):
        import numpy as np
        import torch
        import torch.nn.functional as F

        x = torch.from_numpy(np.stack(images))
        x = x.to(torch.float32) / 255.0 if x.dtype == torch.uint8 else x.to(torch.float32)
        h, w = x.shape[-2:]
        scale = self.size / min(h, w)
        oh, ow = max(self.size, round(h * scale)), max(self.size, round(w * scale))
        x = F.interpolate(x, size=(oh, ow), mode="bicubic", align_corners=False, antialias=True)
        top, left = (oh - self.size) // 2, (ow - self.size) // 2
        x = x[..., top : top + self.size, left : left + self.size]
        mean = torch.tensor(CLIP_MEAN).view(1, 3, 1, 1)
        std = torch.tensor(CLIP_STD).view(1, 3, 1, 1)
        return ((x - mean) / std).numpy()

    def _tokens(self, text):
        import zlib

        import numpy as np

        rows = [[CLIP_BOS] + [zlib.crc32(w.encode(), self.seed) % CLIP_BOS for w in t.lower().split()] + [CLIP_EOS] for t in text]
        width = max(len(r) for r in rows)
        input_ids = np.full((len(rows), width), CLIP_EOS, np.int64)
        attention_mask = np.zeros((len(rows), width), np.int64)
        for i, r in enumerate(rows):
            input_ids[i, : len(r)] = r
            attention_mask[i, : len(r)] = 1
        return input_ids, attention_mask

    def __call__(self, text=None, images=None, return_tensors="np", padding=True, **kw):
        t0 = time.perf_counter()
        out = {}
        if text is not None:
            out["input_ids"], out["attention_mask"] = self._tokens(text)
        if images is not None:
            out["pixel_values"] = self._pixels(images)
        self.seconds.append(time.perf_counter() - t0)
        return out


def _clip_model(widths, device, seed):
    """transformers' ``CLIPModel`` at ``widths`` with seeded weights, built on ``device``."""
    import torch
    from transformers import CLIPConfig, CLIPModel

    config = CLIPConfig(text_config=widths["text"], vision_config=widths["vision"], projection_dim=widths["projection_dim"])
    torch.manual_seed(seed)
    with torch.device(device):
        model = CLIPModel(config)
    return model.eval()


def _coco_captions(rng, n, words):
    """``n`` seeded captions of 8-20 words from ``words``; a caption of 90 words opens each batch of ``COCO_LONG``."""
    lens = rng.integers(COCO_WORDS[0], COCO_WORDS[1] + 1, n)
    caps = [" ".join(rng.choice(words, int(k))) for k in lens]
    for b in COCO_LONG:
        caps[b * COCO_BATCH] = " ".join(rng.choice(words, 90))
    return caps


def _tower_rates(model, proc, device, images, text):
    """Images/s of the vision tower and captions/s of the text tower on one preprocessed batch (CUDA events)."""
    import torch

    from torchmetrics_tpu_torch.functional.multimodal.clip_score import _fp32_towers, _projected

    batch = proc(text=text, images=[i.cpu().numpy() for i in images])
    pixels = torch.from_numpy(batch["pixel_values"]).to(device)
    ids = torch.from_numpy(batch["input_ids"][:, :77]).to(device)
    mask = torch.from_numpy(batch["attention_mask"][:, :77]).to(device)
    rates, forms, proj_err = {}, {}, {}
    # each tower's features, read from what get_*_features returns, against the projection of its pooled output
    explicit = {"vision": lambda: model.visual_projection(model.vision_model(pixel_values=pixels).pooler_output),
                "text": lambda: model.text_projection(model.text_model(input_ids=ids, attention_mask=mask).pooler_output)}
    for name, call, n in (("vision", lambda: model.get_image_features(pixels), len(images)),
                          ("text", lambda: model.get_text_features(input_ids=ids, attention_mask=mask), len(text))):
        with _fp32_towers():
            out = call()
            forms[name] = type(out).__name__
            _require(_projected(out).shape == (n, model.config.projection_dim),
                     f"{name} features {tuple(_projected(out).shape)}, projection_dim {model.config.projection_dim}")
            proj_err[name] = float((_projected(out) - explicit[name]()).abs().max())
            _require(proj_err[name] <= MM_BATCHING_ATOL / 100, f"{name} features against the projected pooled output: {proj_err[name]:.2e}")
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            for _ in range(3):
                call()
            end.record()
            torch.cuda.synchronize()
        rates[name] = 3 * n / (start.elapsed_time(end) / 1e3)
    return rates, {"forms": forms, "projection_err": proj_err}


def _mm_clip_score(tm, device, out):
    """CLIPScore at ViT-L/14's widths over MS-COCO val2017-shaped pairs: see the module docstring, phase 27."""
    import copy
    import warnings

    import numpy as np
    import torch

    from torchmetrics_tpu_torch.functional.multimodal import clip_score
    from torchmetrics_tpu_torch.functional.multimodal.clip_score import _clip_score_update

    model = _clip_model(CLIP_L14, device, MM_SEED)
    proc = _ClipProcessor()
    rng = np.random.default_rng(MM_SEED)
    captions = _coco_captions(rng, COCO_IMAGES, _text_words(rng, 10000))
    gen = torch.Generator(device).manual_seed(MM_SEED)
    batches = [torch.randint(0, 256, (COCO_BATCH, *COCO_IMAGE), generator=gen, device=device, dtype=torch.uint8)
               for _ in range(COCO_IMAGES // COCO_BATCH)]
    rates, forms = _tower_rates(model, proc, device, batches[0], captions[:COCO_BATCH])
    metric = tm.CLIPScore(model=model, processor=proc)
    update_ms, proc_ms, peak_mib = [], [], 0.0
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for b, images in enumerate(batches):
            torch.cuda.reset_peak_memory_stats()
            n_proc = len(proc.seconds)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metric.update(images, captions[b * COCO_BATCH : (b + 1) * COCO_BATCH])
            torch.cuda.synchronize()
            update_ms.append((time.perf_counter() - t0) * 1e3)
            proc_ms.append(sum(proc.seconds[n_proc:]) * 1e3)
            peak_mib = max(peak_mib, torch.cuda.max_memory_allocated() / 2**20)
    truncations = [str(w.message) for w in caught if "max_position_embeddings=77" in str(w.message)]
    _require(len(truncations) == len(COCO_LONG), f"CLIPScore: {len(truncations)} truncation warnings, want {len(COCO_LONG)}")
    value = metric.compute()
    _require(value.shape == () and bool(torch.isfinite(value)) and 0 <= float(value) <= 100, f"CLIPScore {value}")
    _require(int(metric.n_samples) == COCO_IMAGES and metric.score.dtype == torch.float32, "CLIPScore states")
    raw_mean = float(metric.score) / COCO_IMAGES  # before the clamp at 0: seeded towers score near 0 either side
    # the functional over the module's first two batches, and the first batch in two halves; the mean
    # 100 * cos before the clamp, which the values (clamped at 0) would hide
    head, head_caps = torch.cat(batches[:2]), captions[: 2 * COCO_BATCH]
    module = tm.CLIPScore(model=model, processor=proc)
    module.update(batches[0], captions[:COCO_BATCH])
    module.update(batches[1], captions[COCO_BATCH : 2 * COCO_BATCH])
    pairs, n = _clip_score_update(head, head_caps, model, proc)
    functional_err = max(abs(float(pairs.mean()) - float(module.score) / int(module.n_samples)),
                         abs(float(clip_score(head, head_caps, model=model, processor=proc)) - float(module.compute())))
    _require(n == int(module.n_samples) and functional_err <= MM_BATCHING_ATOL, f"CLIPScore functional against the module: {functional_err:.2e}")
    halves = tm.CLIPScore(model=model, processor=proc)
    half = COCO_BATCH // 2
    halves.update(batches[0][:half], captions[:half])
    halves.update(batches[0][half:], captions[half:COCO_BATCH])
    one = tm.CLIPScore(model=model, processor=proc)
    one.update(batches[0], captions[:COCO_BATCH])
    halves_err = max(abs(float(halves.score) - float(one.score)) / COCO_BATCH, abs(float(halves.compute()) - float(one.compute())))
    _require(halves_err <= MM_BATCHING_ATOL, f"CLIPScore two half-batches against one batch: {halves_err:.2e}")
    # card against CPU on the first pairs
    cpu_model = copy.deepcopy(model).cpu()
    card, _ = _clip_score_update(batches[0][:MM_CPU_IMAGES], captions[:MM_CPU_IMAGES], model, proc)
    cpu, _ = _clip_score_update(batches[0][:MM_CPU_IMAGES].cpu(), captions[:MM_CPU_IMAGES], cpu_model, proc, "cpu")
    _require(card.device.type == "cuda" and cpu.device.type == "cpu", "CLIPScore ran where it was asked")
    cpu_err = float((card.cpu() - cpu).abs().max())
    _require(cpu_err <= CLIP_SCORE_CPU_ATOL, f"CLIPScore card against CPU on {MM_CPU_IMAGES} pairs: {cpu_err:.2e}")
    del cpu_model, model
    torch.cuda.empty_cache()
    n = len(update_ms)
    out["clip_score"] = {"value": float(value), "raw_mean": raw_mean, "rates": rates, "forms": forms, "update_ms": statistics.median(update_ms),
                         "proc_ms": statistics.median(proc_ms), "tower_ms": statistics.median(np.subtract(update_ms, proc_ms)),
                         "proc_share": sum(proc_ms) / sum(update_ms), "updates": n, "peak_mib": peak_mib,
                         "truncations": len(truncations), "functional_err": functional_err, "halves_err": halves_err,
                         "cpu_err": cpu_err, "cpu_scores": [float(v) for v in cpu]}


def _mm_clip_iqa(tm, device, out):
    """CLIP-IQA at ViT-B/16's widths over KonIQ-10k-shaped images: see the module docstring, phase 27."""
    import copy

    import numpy as np
    import torch

    from torchmetrics_tpu_torch.functional.multimodal import clip_image_quality_assessment
    from torchmetrics_tpu_torch.functional.multimodal.clip_iqa import _PROMPTS, _clip_iqa_compute
    from torchmetrics_tpu_torch.utilities.data import dim_zero_cat

    model = _clip_model(CLIP_B16, device, MM_SEED + 1)
    proc = _ClipProcessor()
    prompts = tuple(_PROMPTS) + (IQA_CUSTOM,)
    gen = torch.Generator(device).manual_seed(MM_SEED + 1)
    batches = [torch.rand((KONIQ_BATCH, *KONIQ_IMAGE), generator=gen, device=device) for _ in range(KONIQ_IMAGES // KONIQ_BATCH)]
    rates, forms = _tower_rates(model, proc, device, batches[0], ["Good photo."] * KONIQ_BATCH)
    metric = tm.CLIPImageQualityAssessment(prompts=prompts, model=model, processor=proc)
    _require(len(metric.prompts_list) == 34 and len(metric.prompts_names) == 17, "CLIP-IQA prompts")
    update_ms, proc_ms, peak_mib = [], [], 0.0
    for images in batches:
        torch.cuda.reset_peak_memory_stats()
        n_proc = len(proc.seconds)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metric.update(images)
        torch.cuda.synchronize()
        update_ms.append((time.perf_counter() - t0) * 1e3)
        proc_ms.append(sum(proc.seconds[n_proc:]) * 1e3)
        peak_mib = max(peak_mib, torch.cuda.max_memory_allocated() / 2**20)
    t0 = time.perf_counter()
    value = metric.compute()
    torch.cuda.synchronize()
    compute_ms = (time.perf_counter() - t0) * 1e3
    # the module's dict comes with its keys sorted, as JAX's tree map rebuilds it
    _require(isinstance(value, dict) and list(value) == sorted(metric.prompts_names), f"CLIP-IQA dict {list(value)}")
    for key, probs in value.items():
        _require(probs.shape == (KONIQ_IMAGES,) and bool(((probs >= 0) & (probs <= 1)).all()), f"CLIP-IQA {key}")
    matrix = _clip_iqa_compute(dim_zero_cat(metric.img_features), metric.anchors, metric.prompts_names, format_as_dict=False)
    _require(matrix.shape == (KONIQ_IMAGES, 17) and torch.equal(matrix, torch.stack([value[k] for k in metric.prompts_names], dim=1)),
             "CLIP-IQA format_as_dict=False against the dict")
    cpu_model = copy.deepcopy(model).cpu()
    head = batches[0][:MM_CPU_IMAGES]
    card = clip_image_quality_assessment(head, prompts=prompts, model=model, processor=proc)
    cpu = clip_image_quality_assessment(head.cpu(), prompts=prompts, model=cpu_model, processor=proc, device="cpu")
    cpu_err = max(float((card[k].cpu() - cpu[k]).abs().max()) for k in card)
    _require(cpu_err <= CLIP_IQA_CPU_ATOL, f"CLIP-IQA card against CPU on {MM_CPU_IMAGES} images: {cpu_err:.2e}")
    del cpu_model, model
    torch.cuda.empty_cache()
    out["clip_iqa"] = {"means": {k: float(v.mean()) for k, v in value.items()}, "rates": rates, "forms": forms,
                       "update_ms": statistics.median(update_ms), "proc_ms": statistics.median(proc_ms),
                       "tower_ms": statistics.median(np.subtract(update_ms, proc_ms)),
                       "proc_share": sum(proc_ms) / sum(update_ms), "compute_ms": compute_ms, "peak_mib": peak_mib,
                       "cpu_err": cpu_err}


def phase_multimodal(device, smi):
    """CLIPScore and CLIP-IQA (ROADMAP A14's last domain) on seeded towers at full CLIP widths: see the
    module docstring, phase 27. The default-model paths raise (nothing is downloaded)."""
    import torch

    import torchmetrics_tpu_torch as tm

    t_phase = time.perf_counter()
    os.environ.setdefault("HF_HUB_OFFLINE", "1")  # the default-model paths read the local cache alone; say so to the hub too
    out = {"default_raises": []}
    for make in (lambda: tm.CLIPScore(), lambda: tm.CLIPImageQualityAssessment()):
        try:
            make()
        except (OSError, ModuleNotFoundError) as err:
            out["default_raises"].append(type(err).__name__)
        else:
            raise SmokeFailure("a CLIP default-model path loaded a model: nothing should be in the cache")
    flags = (torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision())
    _mm_clip_score(tm, device, out)
    _mm_clip_iqa(tm, device, out)
    _require((torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision()) == flags,
             f"the towers left the TF32 flags changed: {flags}")
    out["seconds"] = time.perf_counter() - t_phase
    cs, iqa = out["clip_score"], out["clip_iqa"]
    print(
        f"[multimodal] {smi}; CLIPScore at ViT-L/14's widths ({COCO_IMAGES} MS-COCO-shaped pairs in {cs['updates']}"
        f" updates of {COCO_BATCH}): value {cs['value']:.6f} (mean 100 * cos before the clamp {cs['raw_mean']:.6f}); towers vision {cs['rates']['vision']:.1f} images/s, text"
        f" {cs['rates']['text']:.1f} captions/s; update ms (median) {cs['update_ms']:.2f}, host preprocessing"
        f" {cs['proc_ms']:.2f}, towers and the rest {cs['tower_ms']:.2f} (preprocessing share {cs['proc_share']:.3f});"
        f" peak MiB of an update {cs['peak_mib']:.1f}; truncation warnings {cs['truncations']}; functional against module"
        f" {cs['functional_err']:.2e}, halves against one batch {cs['halves_err']:.2e}, card against CPU"
        f" {cs['cpu_err']:.2e} (budget {CLIP_SCORE_CPU_ATOL:g}); get_*_features' return forms and their largest gap to the projected pooled output {cs['forms']}. CLIP-IQA at ViT-B/16's widths"
        f" ({KONIQ_IMAGES} KonIQ-10k-shaped images, 34 prompts): vision {iqa['rates']['vision']:.1f} images/s, text"
        f" {iqa['rates']['text']:.1f} prompts/s; update ms (median) {iqa['update_ms']:.2f}, host preprocessing"
        f" {iqa['proc_ms']:.2f}, towers and the rest {iqa['tower_ms']:.2f} (preprocessing share {iqa['proc_share']:.3f});"
        f" compute {iqa['compute_ms']:.2f} ms; peak MiB of an update {iqa['peak_mib']:.1f}; card against CPU"
        f" {iqa['cpu_err']:.2e} (budget {CLIP_IQA_CPU_ATOL:g}); means {iqa['means']}; return forms and projection gaps {iqa['forms']};"
        f" cuDNN TF32 off and matmuls at 'highest' inside the towers, the flags restored; default models raise"
        f" {out['default_raises']}; {out['seconds']:.1f} s"
    )
    return out


# ------------------------------------------------------------------- lint

LINT_CORPUS = os.path.join("tests", "torch_lint_corpus")
LINT_BUDGET_S = 30.0  # the package-wide lint run, as its CPU test holds it
LINT_SEED = 27


def _load_lint(root):
    """The port's metriclint, loaded by file path (it imports only the standard library)."""
    import importlib.util

    lint_dir = os.path.join(root, "torchmetrics_tpu_torch", "lint")
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_metriclint", os.path.join(lint_dir, "__init__.py"), submodule_search_locations=[lint_dir])
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module
    spec.loader.exec_module(module)
    return module, os.path.join(lint_dir, "baseline.json")


def _capture_verdict(make, batches):
    """``make_jit_update(make())`` on the card, its step called once a batch
    (the first call runs eagerly, the second captures, the third replays):
    ``("capture error", message)`` when the port's capture error ends it, else
    ``("captures", equal)`` with whether the carry equals the eager fold of
    the same batches bit for bit."""
    import torch

    from torchmetrics_tpu_torch.parallel import make_jit_update

    metric = make()
    lists = [k for k, v in metric._defaults.items() if isinstance(v, list)]
    kw = {"cat_capacity": 64 * len(batches), "example_batch": batches[0]} if lists else {}
    step, state = make_jit_update(metric, **kw)
    try:
        for batch in batches:
            state = step(state, *batch)
        torch.cuda.synchronize()
    except RuntimeError as err:
        torch.cuda.synchronize()
        _require("as a CUDA graph failed" in str(err), f"{type(metric).__name__}: not the port's capture error: {err}")
        return "capture error", str(err).split("failed: ", 1)[-1].splitlines()[0][:80]
    _require(len(step._captured) == 1, f"{type(metric).__name__}: the step captured {len(step._captured)} graphs, expected 1")
    eager = make()
    for batch in batches:
        eager.update(*batch)
    return "captures", all(torch.equal(state[k], getattr(eager, k)) for k in eager._defaults if k not in lists)


def _lint_port_cases(tm, device):
    """``(name, static verdict, expected, make, batches)`` of the port's own
    classes held against capture: the linter's repairs (the linter is silent
    on them now, and they must capture and fold bitwise), the deliberate
    host paths the port suppresses with a reason (they must fail), and two
    clean updates."""
    import torch

    gen = torch.Generator(device=device).manual_seed(LINT_SEED)

    def ints(hi, *shape):
        return torch.randint(0, hi, shape, generator=gen, device=device)

    def unit(*shape):
        return torch.rand(*shape, generator=gen, device=device)

    def three(fn):
        return lambda: [fn() for _ in range(3)]

    repaired, suppressed = "repaired: clean", "suppressed (deliberate)"
    return [
        ("MulticlassExactMatch", repaired, "captures", lambda **kw: tm.classification.MulticlassExactMatch(num_classes=3, **kw),
         three(lambda: (ints(3, 64, 5), ints(3, 64, 5)))),
        ("MultilabelExactMatch", repaired, "captures", lambda **kw: tm.classification.MultilabelExactMatch(num_labels=4, **kw),
         three(lambda: (unit(64, 4), ints(2, 64, 4)))),
        ("MeanIoU", repaired, "captures", lambda **kw: tm.segmentation.MeanIoU(num_classes=3, **kw),
         three(lambda: (ints(3, 2, 32, 32), ints(3, 2, 32, 32)))),
        ("VisualInformationFidelity", repaired, "captures", lambda **kw: tm.image.VisualInformationFidelity(**kw),
         three(lambda: (unit(2, 1, 48, 48), unit(2, 1, 48, 48)))),
        ("MultiScaleStructuralSimilarityIndexMeasure", repaired, "captures",
         lambda **kw: tm.image.MultiScaleStructuralSimilarityIndexMeasure(data_range=1.0, **kw),
         three(lambda: (unit(2, 1, 192, 192), unit(2, 1, 192, 192)))),
        ("LearnedPerceptualImagePatchSimilarity", repaired, "captures",
         lambda **kw: tm.image.LearnedPerceptualImagePatchSimilarity(net_type="squeeze", **kw),
         three(lambda: (unit(2, 3, 64, 64) * 2 - 1, unit(2, 3, 64, 64) * 2 - 1))),
        ("SpeechReverberationModulationEnergyRatio", suppressed, "capture error",
         lambda **kw: tm.audio.SpeechReverberationModulationEnergyRatio(fs=8000, **kw), three(lambda: (unit(1, 8000) * 2 - 1,))),
        ("PanopticQuality", suppressed, "capture error", lambda **kw: tm.detection.PanopticQuality(things={0, 1}, stuffs={2}, **kw),
         three(lambda: (torch.stack([ints(3, 1, 16, 16), ints(2, 1, 16, 16)], -1),
                        torch.stack([ints(3, 1, 16, 16), ints(2, 1, 16, 16)], -1)))),
        ("RetrievalMAP(ignore_index=-1)", suppressed, "capture error", lambda **kw: tm.retrieval.RetrievalMAP(ignore_index=-1, **kw),
         three(lambda: (unit(32), torch.where(torch.arange(32, device=device) % 7 == 0, -1, ints(2, 32)), ints(4, 32)))),
        ("Dice(num_classes=3)", "clean", "captures", lambda **kw: tm.classification.Dice(num_classes=3, **kw),
         three(lambda: (ints(3, 64), ints(3, 64)))),
        ("Perplexity", "clean", "captures", lambda **kw: tm.text.Perplexity(**kw),
         three(lambda: (torch.randn(2, 40, 8, generator=gen, device=device), ints(8, 2, 40)))),
    ]


def phase_lint(device, smi):
    """The port's static checks held against CUDA-graph capture on the card:
    see the module docstring, phase 28."""
    import glob
    import importlib.util

    import torch

    import torchmetrics_tpu_torch as tm

    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    lint, baseline = _load_lint(root)
    t0 = time.perf_counter()
    found = lint.lint_paths([os.path.join(root, "torchmetrics_tpu_torch"), os.path.join(root, "chip_smoke.py")], root=root)
    lint_s = time.perf_counter() - t0
    new, stale = lint.diff_against_baseline(found, lint.load_baseline(baseline))
    _require(not new, "metriclint findings above the baseline:\n" + "\n".join(v.render() for v in new))
    _require(not stale, f"stale metriclint baseline entries: {stale}")
    _require(lint_s < LINT_BUDGET_S, f"the package-wide lint run took {lint_s:.1f} s (budget {LINT_BUDGET_S:g})")
    corpus = os.path.join(root, LINT_CORPUS)
    corpus_found = lint.lint_paths([corpus], root=corpus)
    fired = {v.rule for v in corpus_found}
    _require(fired == set(lint.RULES), f"rules that did not fire on the corpus: {set(lint.RULES) - fired}")
    rows = []
    for path in sorted(glob.glob(os.path.join(corpus, "ml0*.py"))):
        name = os.path.basename(path)[:-3]
        if not name.startswith(("ml002_", "ml011_")):
            continue
        spec = importlib.util.spec_from_file_location(f"chip_smoke_lint_{name}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        rules = sorted({v.rule for v in corpus_found if v.path == name + ".py"})
        static = f"flagged {'/'.join(rules)}" if rules else "clean"
        _require(bool(rules) == (not module.CAPTURES), f"{name}: static verdict {static} against CAPTURES={module.CAPTURES}")
        expected = "captures" if module.CAPTURES else "capture error"
        make = lambda module=module: module.Fixture(device=device)  # noqa: E731
        rows.append((f"corpus/{name}", static, expected) + _capture_verdict(make, module.batches(device)))
    for name, static, expected, make, batches in _lint_port_cases(tm, device):
        rows.append((name, static, expected) + _capture_verdict(lambda make=make: make(device=device), batches()))
    for name, static, expected, outcome, detail in rows:
        print(f"[lint] {name}: static {static}; on the card {outcome}"
              + (f" ({detail})" if outcome != "captures" else f", carry {'equal' if detail else 'NOT equal'} to the eager fold bit for bit"))
        _require(outcome == expected, f"{name}: expected {expected}, got {outcome} ({detail})")
        _require(outcome != "captures" or detail, f"{name}: the captured step's carry differs from the eager fold")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t_phase
    print(
        f"[lint] {smi}; the port and chip_smoke.py linted in {lint_s:.2f} s (budget {LINT_BUDGET_S:g} s): {len(found)} findings,"
        f" all baselined ML006/ML013, 0 new; every one of {len(lint.RULES)} rules fires on the corpus; capture fixtures"
        f" {sum(1 for r in rows if r[0].startswith('corpus/'))} and port classes {sum(1 for r in rows if not r[0].startswith('corpus/'))},"
        f" every static verdict held by capture; {seconds:.1f} s"
    )
    return {"seconds": seconds, "lint_s": lint_s, "rows": rows}


# ------------------------------------------------------------------ chaos

CHAOS_TIMEOUT_S = 420


def phase_chaos(smi):
    """The port's chaos harness (``torchmetrics_tpu_torch/serve/chaos.py``)
    in ``short`` and ``poison`` modes with its daemons on the card: see the
    module docstring, phase 26."""
    import shutil
    import tempfile

    import torch

    torch.cuda.empty_cache()
    root = os.path.dirname(os.path.abspath(__file__))
    harness = os.path.join(root, "torchmetrics_tpu_torch", "serve", "chaos.py")
    work = tempfile.mkdtemp(prefix="chip_smoke_chaos_")
    t_phase = time.perf_counter()
    reports = {}
    try:
        for mode in ("short", "poison"):
            try:
                done = subprocess.run(
                    [sys.executable, harness, "--workdir", os.path.join(work, mode), "--mode", mode, "--seed", "11", "--device", "cuda"],
                    capture_output=True, text=True, timeout=CHAOS_TIMEOUT_S, cwd=work,
                )
            except subprocess.TimeoutExpired as err:
                raise SmokeFailure(f"chaos {mode}: the harness outlived {CHAOS_TIMEOUT_S} s") from err
            lines = done.stdout.strip().splitlines()
            _require(done.returncode == 0 and lines, f"chaos {mode}: rc {done.returncode}\n{done.stdout[-3000:]}\n{done.stderr[-3000:]}")
            report = json.loads(lines[-1])
            _require(report.get("ok") and report.get("device") == "cuda", f"chaos {mode}: {report}")
            reports[mode] = {leg["leg"]: leg for leg in report["legs"]}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    short, poison = reports["short"], reports["poison"]["poison"]
    _require(set(short) == {"main", "circuit"}, f"chaos short: legs {sorted(short)}")
    _require(short["main"]["quarantined"] == [6] and short["main"]["degraded_observed"] is True, f"chaos short main: {short['main']}")
    _require(short["circuit"]["restarts"] >= 2, f"chaos short circuit: {short['circuit']}")
    _require(poison["quarantined"] == [2, 4] and poison["rollbacks"] == 2 and poison["masked_rows"] == 4
             and poison["rejected_batches"] == 2 and poison["health_walk"] == ["ok", "degraded", "ok"], f"chaos poison: {poison}")
    legs = {**{f"short.{k}": v for k, v in short.items()}, "poison": poison}
    seconds = time.perf_counter() - t_phase
    print(
        f"[chaos] {smi}; daemons on --device cuda; legs (seconds; each daemon's start to ready line, s):"
        f" {'; '.join(f'{k} {v['seconds']:.2f} ({', '.join(f'{s:.2f}' for s in v['ready_s'])})' for k, v in legs.items())};"
        f" short main quarantined {short['main']['quarantined']}, circuit restarts {short['circuit']['restarts']}; poison"
        f" rollbacks {poison['rollbacks']}, masked rows {poison['masked_rows']}, rejected batches {poison['rejected_batches']},"
        f" health {poison['health_walk']}; {seconds:.1f} s"
    )
    return {"seconds": seconds, "legs": legs}


def main() -> int:
    t_start = time.perf_counter()
    try:
        import torch
    except ImportError as err:
        print(f"chip_smoke: PyTorch is not importable: {err}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke run needs an NVIDIA GPU", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    try:
        from torchmetrics_tpu_torch.ops import KERNELS
    except ImportError as err:
        print(f"chip_smoke: the port is not beside this script ({err}); run it from a checkout", file=sys.stderr)
        return 2

    device, smi = phase_device()
    build_s = phase_build()
    batches = _main_path_batches(device)
    ml_batches = _multilabel_batches(device)
    rows = [check_binned_curve_state(device, batches), check_stat_counts(device, batches)]
    matrix_row = check_binned_curve_matrix_mode(device, ml_batches)
    k5_rows = time_biquad_cascade(device)
    k7_row = time_window_moments(device)
    k6_row = time_coco_match(device)
    k8_row = time_token_nll(device)
    sketch_kernels = {"cm_track": KERNELS["cm_track"]}
    KERNELS = _classification_kernels()
    entry_diffs = phase_entry(KERNELS)
    run = phase_slice(device, batches, KERNELS)
    exact = phase_exact(device, batches, KERNELS)
    ml_run = phase_multilabel(device, ml_batches, KERNELS)
    fam = phase_families(device, batches, KERNELS)
    points = phase_points(device, batches, KERNELS, run)
    scores = phase_scores(device, batches, ml_batches, KERNELS)
    regression = phase_regression(device, batches, KERNELS)
    wrappers = phase_wrappers(device, batches, KERNELS, smi)
    sketch = phase_sketch(device, sketch_kernels, smi)
    sliced = phase_sliced(device, batches, smi)
    guard = phase_guard(device, batches, smi)
    obs_run = phase_obs(device, batches, smi)
    fused = phase_fused(device, batches, KERNELS, run, exact)
    cache = phase_cache(device, batches, smi)
    durable = phase_durable(device, batches, KERNELS, run, exact, smi)
    serve = phase_serve(device, batches, KERNELS, run, smi)
    dist_run = phase_dist(run, exact, fused, smi)
    domains = phase_domains(device, batches, smi)
    audio = phase_audio(device, smi, k5_rows)
    detection = phase_detection(device, smi, k6_row)
    image = phase_image(device, smi, k7_row)
    text = phase_text(device, smi, k8_row)
    multimodal = phase_multimodal(device, smi)
    lint_run = phase_lint(device, smi)
    chaos = phase_chaos(smi)
    for row in rows:
        row["launches"] = run["launches"][row["name"]]
    matrix_row.update(name="binned_curve_state, matrix mode (multilabel path)", route="cuda",
                      source="torchmetrics_tpu_torch/csrc/binned_curve_state.cu", replaces=rows[0]["replaces"], library_ms=None,
                      launches=ml_run["launches"]["binned_curve_state"])
    rows.insert(1, matrix_row)
    rows.append(sketch["k3_row"])
    rows.extend(sliced["rows"])
    rows.extend(guard["rows"])
    rows.extend(audio["rows"])
    rows.append(detection["k6_row"])
    rows.append(image["k7_row"])
    rows.append(text["k8_row"])
    for row in rows:
        stream = ", ".join(f"{k} {v:.4f}" for k, v in row["stream_ms"].items())
        print(
            f"[kernels] {row['name']}: device ms {row['ms']:.5f} ({row.get('ms_source', 'profiler')}; kernel alone {row['kernel_only_us'] or 0:.2f} us),"
            f" plain {row['plain_ms']:.5f}, library {row['library_ms']}, bound {row['bound_ms']:.5f}"
            f" ({row['bound_by']}, {row['bytes']} B), read floor {row['read_floor_ms']:.5f} (torch.sum of the main input),"
            f" launches {row['launches']}; stream ms per call: {stream}"
        )
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    lo, hi = run["steady_range_ms"]
    print(
        f"[summary] build {build_s:.2f} s; entry on the card, max |card - CPU| {max(entry_diffs.values()):.2e};"
        f" suite {run['first_sps']:.1f} samples/s first pass, {run['steady_sps']:.1f} steady (median of"
        f" {STEADY_PASSES} passes of {NUM_BATCHES} batches, {lo:.2f}-{hi:.2f} ms); busy share {run['busy_share']:.3f}"
        f" ({run['busy_us']:.1f} us in kernels); device us by kernel:"
        f" {'; '.join(f'{name} {t:.1f}/{n}' for name, t, n in run['top'])}; launches per pass {run['device_launches']},"
        f" of them {', '.join(f'{k} {v}' for k, v in run['watched'].items())}; host {run['host_calls']} Python calls"
        f" per pass; exact compute {exact['compute_ms']:.3f} ms device, sort share {exact['sort_share']:.3f}, peak"
        f" {exact['peak_mib']:.1f} MiB; multilabel steady pass {ml_run['busy_us']:.1f} us device, busy share"
        f" {ml_run['busy_share']:.3f}; families phase {fam['seconds']:.1f} s, eager pass {fam['eager']['median_s'] * 1e3:.3f} ms, fused"
        f" {fam['fused']['median_s'] * 1e3:.3f} ms, confmat update {fam['update_ms']:.5f} ms device (bound"
        f" {fam['bound_ms']:.5f}, torch.bincount {fam['bincount_ms']:.5f}); points phase {points['seconds']:.1f} s, K1"
        f" {points['launches']['binned_curve_state']} eager / {points['k1_fused']} fused per pass, eager pass"
        f" {points['eager']['median_s'] * 1e3:.3f} ms, fused {points['fused']['median_s'] * 1e3:.3f} ms, compute"
        f" {points['compute_us']:.1f} us device; scores phase {scores['seconds']:.1f} s, update ms (bound):"
        f" {', '.join(f'{k} {t['ms']:.5f} ({t['bound_ms']:.5f})' for k, t in scores['timed'].items())}; regression phase"
        f" {regression['seconds']:.1f} s, eager pass {regression['eager']['median_s'] * 1e3:.3f} ms, fused"
        f" {regression['fused']['median_s'] * 1e3:.3f} ms, ms per call (bound):"
        f" {', '.join(f'{k} {t['ms']:.5f} ({t['bound_ms']:.5f})' for k, t in regression['timed'].items())}; wrappers phase"
        f" {wrappers['seconds']:.1f} s, K1/K2 per wrapper stream {wrappers['launches']}; sketch phase {sketch['seconds']:.1f} s,"
        f" K3 {sketch['k3_row']['ms']:.5f} ms per 65536 tags (bound {sketch['k3_row']['bound_ms']:.5f}), fused busy share"
        f" {sketch['fused_busy_share']:.4f}; fused steady pass {fused['median_s'] * 1e3:.3f} ms (unfused {run['median_s'] * 1e3:.3f};"
        f" in turns {fused['turns']['fused'] * 1e3:.3f} vs {fused['turns']['unfused'] * 1e3:.3f}), busy share"
        f" {fused['busy_share']:.3f}, {fused['device_launches']} device kernels and {fused['host_calls']} Python calls per"
        f" pass, hand kernels per pass {fused['per_pass']}, capture {fused['capture_s']:.3f} s, run_scan"
        f" {fused['scan_ms']:.3f} ms, run_stream {fused['stream_ms']:.3f} ms (copies alone {fused['h2d_ms']:.3f}); cache phase"
        f" {cache['seconds']:.1f} s, first update captured / adopted: fused {cache['fused']['first'][0]:.3f} /"
        f" {cache['fused']['rebuilt'][0]:.3f} ms, sliced {cache['sliced']['first'][0]:.3f} / {cache['sliced']['rebuilt'][0]:.3f} ms"
        f" (CUDA events), runner drives {cache['runner_ms'][0]:.1f} / {cache['runner_ms'][1]:.1f} ms; durable phase"
        f" {durable['seconds']:.1f} s, fused pass by snapshot_every_n {durable['cadence_ms']}, suite snapshot"
        f" {durable['suite_bytes']} B, exact snapshot {durable['exact_bytes']} B; dist phase"
        f" {dist_run['seconds']:.1f} s, sharded fused pass {dist_run['ranks'][0]['sharded_pass_ms']:.3f} ms (gloo on one card);"
        f" sliced phase {sliced['seconds']:.1f} s, fan-out {sliced['fanout_sps']:.1f} samples/s ({sliced['fanout_ratio']:.1f} x the naive"
        f" loop), drift ingest {sliced['drift_ingest_sps']:.1f} samples/s and {sliced['drift_windows_per_s']:.1f} windows/s, suite pass"
        f" {sliced['suite_pass_ms']:.3f} ms (busy share {sliced['suite_busy_us'] / sliced['suite_wall_us']:.4f}); sliced mesh pass"
        f" {dist_run['ranks'][0]['sliced_mesh_pass_ms']:.3f} ms (gloo on one card); guard phase {guard['seconds']:.1f} s, fused pass"
        f" ms unguarded/mask/reject/propagate {'/'.join(f'{v['fused']:.3f}' for v in guard['pass_ms'].values())}, row_invalid"
        f" {guard['row_invalid_ms'] * 1e3:.2f} us (bound {guard['row_invalid_bound_ms'] * 1e3:.2f}); obs phase {obs_run['seconds']:.1f} s,"
        f" fused pass {obs_run['pass_ms'][('fused', 'off')]:.3f} ms untraced / {obs_run['pass_ms'][('fused', 'on')]:.3f} traced, jit step"
        f" {obs_run['step_ms']['off']:.4f} / {obs_run['step_ms']['on']:.4f} ms telemetry off / on; serve phase"
        f" {serve['seconds']:.1f} s, served suite {serve['stream']['served_sps']:.1f} samples/s (fused pass"
        f" {serve['stream']['fused_sps']:.1f}), JSON decode {serve['daemon']['decode_ms']:.2f} ms a batch, socket ingest"
        f" {serve['daemon']['ingest_sps']:.1f} samples/s, restart-to-ready {serve['daemon']['restart_s']:.2f} s, export"
        f" {serve['fleet']['export_ms']:.2f} ms ({serve['fleet']['export_bytes']} B), fold {serve['fleet']['fold_ms']:.2f} ms;"
        f" domains phase {domains['seconds']:.1f} s, peak {domains['peak_mib']:.1f} MiB; audio phase {audio['seconds']:.1f} s,"
        f" K5 at T={QUALITY_T} {'/'.join(f'{r['ms']:.3f}' for r in audio['rows'])} ms device (gammatone/modulation);"
        f" detection phase {detection['seconds']:.1f} s, K6 {detection['k6_row']['ms']:.5f} ms device at COCO val2017's shape,"
        f" mAP compute {detection['compute_s']:.3f} s; image phase {image['seconds']:.1f} s, K7 {image['k7_row']['ms']:.5f} ms"
        f" device at {IMG_SHAPE}; text phase {text['seconds']:.1f} s, K8 {text['k8_row']['ms']:.5f} ms device at"
        f" {PPL_SHAPE} (F.cross_entropy {text['k8_row']['library_ms']:.5f}); multimodal phase {multimodal['seconds']:.1f} s,"
        f" ViT-L/14 {multimodal['clip_score']['rates']['vision']:.1f} images/s, ViT-B/16"
        f" {multimodal['clip_iqa']['rates']['vision']:.1f} images/s; lint phase {lint_run['seconds']:.1f} s (the lint run"
        f" {lint_run['lint_s']:.2f} s); chaos phase {chaos['seconds']:.1f} s;"
        f" total {time.perf_counter() - t_start:.1f} s"
    )
    print(smi)
    # ms_source: "profiler" (torch.profiler's device time; every row but K5's fails without it) or "cuda events"
    print(json.dumps({"kernels": [{**{k: row[k] for k in keys}, "ms_source": row.get("ms_source", "profiler")} for row in rows]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``flink_ml_tpu_torch``).

    python3 chip_smoke.py

Needs one NVIDIA GPU (H100) and the CUDA toolkit; run from the root of a
checkout.  Phases, in order (any failure exits nonzero, before the last
line is printed):

1. Device: fail without CUDA; print the card's name and power limit.
2. Build: compile every kernel under ``flink_ml_tpu_torch/kernels/csrc``
   (one nvcc per source, all at once) and print the seconds and nvcc's
   register/shared-memory report.
3. Kernels vs plain versions on the card, at the main path's shapes
   (2^20 features = 8192 table rows, batch 2^15, 26 categorical slots with
   the label marker in slot 0); the pair kernel at 128*1001 features.
   With and without the per-slot ``val``.  The margin reads the layout's
   sample routing (``sample_routing``); all three kernels must equal their
   plain versions bit for bit (tolerance 0), and two margin launches on
   the same inputs must agree bit for bit.
4. Main path: ``LogisticRegression(device="cuda")`` fit at 2^20 features,
   batch 2^15, 3 epochs over 2^18 Criteo-shaped rows (numpy seed 0), then
   ``transform``.  Checks: the loss falls every epoch, the plan is "ell",
   the margin and fused-scatter kernels launched steps x epochs times,
   one epoch's weights match the same fit through the plain versions on
   the card, and predictions match numpy scoring of the fitted weights.
   Then a small fit at 128*1001 features, the pair kernel's path.
5. Times (CUDA events, median, L2 flushed before each launch): each
   kernel, its plain version and one PyTorch library call computing the
   same function (the margin: ``embedding_bag`` over the routing, and
   ``index_add_`` of the pre-gathered slot weights beside it; the fused
   scatter: the ``r_ext`` gather plus ``index_add_``, and ``index_add_``
   of pre-gathered updates beside it; the pair scatter: ``index_add_``),
   beside the bound computed from bytes; the sample routing's one-time build for
   the fit's 8 steps; epochs/s through the kernels and through the plain
   versions; C4's cost at the leg: step 0's two overflow scatter-adds in
   the fit's fixed order against ``index_add_`` on the same inputs.
6. KMeans kernels vs plain versions on the card at the headline (2^20
   points x 64 dims, k = 256, numpy seed 0 N(0,1) points, centroids the
   midpoints of seeded-permutation pairs of points): the stats kernel
   under the three tie policies (one Lloyd step each) and on zero-padded
   rows against duplicated centroids; the assign kernel; the workset
   kernel with about half of the rows active and a tenth masked out.
   (first, assign and workset score on the tensor cores; fast and split
   on the CUDA cores.)
7. KMeans main paths with launch counters: ``KMeans(device="cuda")`` fit
   of 10 rounds on the 2^20 x 64 table (the kernel plan, 10 launches);
   the workset fit of up to 20 rounds (launches = rounds); each against
   the same fit through the plain versions on the card; ``transform`` of
   2^16 held-out rows (one launch) against a numpy float64 argmin.  The
   BSP fit's rounds are also held through the CUDA-core scoring (tie
   policy fast), and both paths' per-round error margins are printed.
8. KMeans times: each kernel, its plain version and ``torch.addmm`` of the
   score product alone, beside the bound from operations (3xTF32 on the
   tensor cores; the fp32 CUDA-core bound of the same work beside it); BSP
   iterations/s through the kernels and through the plain versions.
9. Wide&Deep fold kernel vs its plain version on the card, bit for bit
   (tolerance 0), at E = 64 (embeddings) and E = 1 (the squeezed wide
   table) on: step 0 of the bench route (26 fields x 40329 vocab, batch
   8192, numpy seed 17, ``bench.py:1094-1112``), the heavy-hitter route
   (vocab 2^20, field 0 = 7 in half the rows, ``bench.py:2911-2915``:
   12 passes, two launches of the level-group kernel), the deep route (a
   run of 2 x 8192: 14 passes, two launches) and a ragged S = 1000 x
   26; both placements through the kernel vs the plain fold; a route with
   fold_passes == 0 launches nothing.
10. Wide&Deep main path: ``WideDeep(device="cuda")`` fit of 2 epochs at
    the bench width (26 x 40329 vocab, 13 dense, embedding 64, MLP (1024,
    512, 256), batch 8192, 16 steps an epoch, 131072 rows, numpy seed 17),
    then ``transform`` of 4096 held-out rows.  Checks: gather placement,
    fold launches = 2 x 16 x 2, finite loss falling from epoch 1 to 2, one
    epoch through the kernel vs ``fit(plain=True)`` within the one-epoch
    tolerances of ``tests/test_widedeep.py:394-399`` (and bit for bit, as
    printed), every step of that epoch vs the autograd ``'off'`` step from
    the routed fit's own state within the same tolerances, a replay ending
    bit for bit on the fit, the whole ``'off'`` epoch's loss within them,
    two ``'off'`` fits and two lazy fits bit for bit (their table
    gradients sum in a fixed order), and scores within 1e-5 of a numpy
    float64 forward.
11. Wide&Deep times: the fold kernel (the bench, heavy-hitter and deep
    routes, each at E = 64 and E = 1) against its plain version, the
    ``index_add_`` scatter-add it replaces and the byte bound; steps/s over
    device-resident epoch tensors through the kernel, the plain fold, and
    the ``'off'`` step with its fixed-order table gradients (C4's cost:
    that gradient's ms against ``index_add_``); ``fit()`` wall and the
    host route build.

12. IVF retrieval main path, at the JAX package's retrieval bench
    (``bench.py:4171-4213``: 131072 x 64 points in 4096 masses of 32,
    numpy seed 77, 256 queries, nlist 256, k 10): ``IVFIndex.build`` flat
    and IVF-PQ (m 8, ksub 16) on the card, then ``transform`` and
    ``search`` at nprobe 1, 2, 4, 8, 16.  Checks: the coarse fits and the
    8 codebook fits planned the workset kernel and launched it once a
    round; each search called its retrieve kernel once (two CUDA
    launches: the probes, then the list-major scan); flat recall@10
    >= 0.95 at nprobe 2 with scan fraction <= 0.25 (``bench.py:4270-4276``);
    at nprobe = nlist the flat search returns the float64 exact top-10
    (rows whose 10th and 11th distances lie within 1e-6 (|q|^2 +
    max|x|^2) excluded and counted); a delta update of 64 inserts and 64
    deletes serves the inserts and drops the deletes.  Then, with the
    counts read: each of the 8 codebook fits (the workset kernel at
    131072 x 8, k 16) replayed with every round within the KMeans gate of
    the plain step from the same state, ending bit for bit on the index's
    stored books, its distortion within 1e-3 of the plain fit's; and the
    same IVF-PQ build on the host CPU (the plain versions throughout),
    whose recall@10 the card's must meet within 0.03 at every nprobe.
13. Retrieve kernels vs plain versions on the card, ``search`` against
    ``search(plain=True)``, ids and distance bits
    equal (tolerance 0): the phase-12 indexes at nprobe 1, 2, 4, 8, 16 and
    nlist, and b = 1 and b = 257 at nprobe 2 and nlist; a duplicated
    corpus (exact ties); an index with
    block 8 and k = 20 above the probed rows (-1 at +inf).  (They run after
    the main path, on the indexes it built.)
14. Retrieval times: each kernel at b = 256 and nprobe 1, 2, 16 and
    nlist beside its plain version, the
    bound (distinct probed lists' bytes vs
    operations) and the brute-force yardstick (``addmm`` + ``topk`` over
    the whole corpus: exact search, what ``retrieval_ivf_qps_ratio``
    divides by); the QPS / recall@10 / scan-fraction frontier of brute
    force, IVF and IVF-PQ over the nprobe sweep and the port's
    ``retrieval_ivf_qps_ratio``; the builds' wall seconds by part and the
    device copy.
15. The ELL plan where the sample routing outgrows its budget: at 2^17
    features, 26 slots and 2^24 rows the plan is "ell" (the JAX
    package's rule); a ``LogisticRegression`` fit at 2^17 features (2^17
    rows, batch 2^14, 2 epochs) with the routing budget cut to 3 steps
    builds its routing per chunk every epoch, launches the margin and
    fused-scatter kernels every step, gives every step's margin bit for
    bit, and equals the whole-routing fit bit for bit; the rebuild's cost
    a step.
16. Sparse LR at the Criteo width: phase 4's rows in the pair encoding
    (``bench.py:100-115``: indices 0-12 carry the dense values, the 26
    hashed slots 1.0; nnz 39), ``LogisticRegression(device="cuda")`` on
    the ``features_indices``/``features_values`` columns, 3 epochs at
    batch 2^15.  Checks: the plan is "ell"; the margin and fused-scatter
    kernels (their value variants) launch steps x epochs times; the loss
    falls every epoch; one epoch equals the same fit through the plain
    versions on the card, the fit equals phase 4's mixed fit of the same
    rows and the same fit from an ``ell_layout_device`` layout (heavy_cap
    24, ``bench.py:297-301``), each within allclose rtol 1e-3, atol 1e-4
    (``bench.py:266, 316``); ``transform`` equals numpy f64
    scoring; ``BinaryClassificationEvaluator`` gives the same
    areaUnderROC on the card as on the CPU.  Both value variants equal
    their plain versions bit for bit on the fit's step 0 and are timed
    there beside the plain versions, their byte bounds and
    ``embedding_bag(per_sample_weights=)`` (the margin) or the ``r_ext``
    gather x val plus ``index_add_`` (the fused scatter); the routing
    build and sparse epochs/s.
17. A small sparse fit at 128*1001 features with N(0,1) values on every
    slot: the pair kernel carries every step, the fit agrees with the
    plain versions on the card, and the pair kernel on the value updates
    equals its plain version bit for bit and is timed beside its bound
    and ``index_add_``.
18. Dense fits at the pipeline bench's width (``bench.py:1991-1994``:
    2^17 rows x 64 N(0,1) features, numpy seed 23), 2 epochs at the auto
    batch each: LinearRegression, LinearSVC, LogisticRegression and
    SoftmaxRegression (10 classes).  Checks: the loss falls; the card's
    fit equals the same fit on the CPU within allclose rtol 1e-3, atol
    1e-4; transforms equal numpy f64 scoring; the regression and
    multiclass evaluators' metrics of the card's fit equal the CPU fit's.
19. A Criteo TSV (``bench.py:611``'s format, 2^17 rows) through
    ``CriteoTSVReader`` (the native parser, required) into a Table and a
    mixed ``LogisticRegression`` fit at 2^20 features (hash_space 2^20 -
    13): the batches equal ``parse_chunk`` of the whole file, the fit
    plans "ell" and launches the margin and fused-scatter kernels; parse
    rows/s.

20. The iteration runtime on the card: the reference's anchor (4 sources
    x 1000 records, values 0-999, as device tensors; 5 rounds) sums to
    exactly 1,998,000 in every round in the fused and the hosted mode; the
    same with a ``FaultPlan`` crash at ``iterate.epoch`` 3 healed by
    ``resilient_fit`` from per-epoch checkpoints (every round 1,998,000,
    the final state equal to the uninterrupted run's bit for bit);
    ``steps_per_dispatch=4`` equals 1 bit for bit; listeners (at chunk
    boundaries) and ``per_round`` fire as on the CPU.
21. The streamed LR fit at the Criteo width: 2^20 Criteo-shaped rows
    (``criteo_rows``, seed 0) written once with ``DataCacheWriter`` to the
    gitignored ``scratch_stream/`` (~168 MB, removed at the end) and read
    by ``DataCacheReader(batch_rows=2^15)``:
    ``LogisticRegression.fit_outofcore(mixed=True)``, 2 epochs (the first
    records the decoded replay cache, the second replays it), W 8, 4
    decode workers.  Checks: B1 and B2 launch 64 times each (32 steps x 2
    epochs), B3 none; (b) the fit equals ``plain=True`` within
    allclose(1e-3, 1e-4); (c) W 8 equals W 1 bit for bit; (d) the replayed
    epoch equals an uncached fit bit for bit; (e) a fit whose reader dies
    fetching batch 13, resumed by ``resilient_fit`` from a
    ``checkpoint_every_steps=8`` cut, equals the uninterrupted fit bit for
    bit; the routing built in the decode workers equals the card's.
    Prints record and replay epochs/s, fit() wall s, ``PrefetchStats``,
    the checkpoint cut's host ms, the resume's recovery s and phase 4's
    in-memory rate beside them, each with the card line.
22. The streamed KMeans fit: the KMeans headline's points (2^20 x 64,
    N(0,1), seed 0) written once with ``DataCacheWriter`` to
    ``scratch_stream/`` (~256 MB, removed at the end) and read by
    ``DataCacheReader(batch_rows=2^17)``: ``KMeans.fit_outofcore``, k 256,
    10 rounds.  Checks: (a) the stats kernel (B4) launches 80 times (8
    batches x 10 rounds), B5 and B6 none; (b) each round, from the same
    centroids, within allclose(5e-3, 5e-3) of the same stream on the plain
    stats (and the round-by-round chain equals the fit bit for bit); (c)
    each round within the same gate of the in-memory Lloyd's round on the
    same rows from the same centroids (the two fits run free from one init
    are printed, not gated: their f32 sums add in another order, and on
    N(0,1) points near-tie flips compound over 10 rounds); (d) a second
    fit bit for bit.  Prints
    streamed iterations/s beside phase 7's and ``PrefetchStats``.
23. The streamed Wide&Deep fit at the bench width: 16 batches of 8192
    (phase 9's data, in the in-memory fit's shuffled order) through a
    data cache, ``WideDeep.fit_outofcore``, 2 epochs, W 8, dense Adam.
    Checks: (a) W 8 = W 1 bit for bit; (b) a fit whose reader dies
    fetching batch 12, healed by ``resilient_fit`` from a
    ``checkpoint_every_steps=8`` cut, equals the uninterrupted fit bit for
    bit; (c) a second run bit for bit; (d) the in-memory
    ``routedEmbeddingGrad='off'`` step (the streamed fit's own step)
    replayed from the streamed fit's state, two calls a step bit for bit,
    the replay ending bit for bit on the streamed fit, and the
    whole fit's loss log within rtol 1e-5 of the in-memory 'off' fit on
    the same rows (the whole fits' parameters are printed), and two
    in-memory 'off' fits bit for bit.
    Then (a)-(c) with ``lazyEmbeddingOptimizer`` on the first 4 batches
    (the crash fetching batch 6, cuts every 2 steps at W 2).  Prints
    streamed steps/s beside phase 11's, the cut's host ms, the recovery s
    and the streamed step's ms on the two fixed-order table-gradient
    routes (``scripts/stream_grad_routes.py``: the sort-based scatter-add
    the fit runs, and a per-batch sort with the fold kernel).
24. Streaming FTRL at ``bench_online_ftrl``'s shape (d 2^20, 16 windows
    of 4096 rows x 39 slots, 13 N(0,1) values and 26 unit values, seed
    13, alpha 0.1, beta 1, l1 = l2 = 1e-4): (a) windows/s of the update
    with the windows resident on the card; (b) windows/s of
    ``OnlineLogisticRegression.fit`` over a ``WindowLog`` on local disk
    (equal bit for bit to (a)'s weights); (c) a fit killed at window 11
    with ``CheckpointConfig(interval=4)``, resumed with the log replaying
    the windows past the cursor, equals the uninterrupted fit bit for bit
    at model version 16; (d) the weights within allclose(1e-4, 1e-6) of a
    float64 numpy FTRL.  Then ``OnlineKMeans`` (k 256, d 64, 32 windows
    of 256 rows, a drifting mean) killed at window 20 and resumed from an
    interval-8 cut, equal bit for bit; windows/s.

25. The pipeline bench (``bench.py:1979-2003``: 2^17 x 64 f32, numpy seed
    23): StandardScaler -> MinMaxScaler -> MaxAbsScaler -> PCA (k 16) ->
    LogisticRegression (3 epochs, the dense fit) fitted on the card, as
    one ``PipelineModel``.  Checks: the plan is one segment of 5 stages;
    a fused transform adds 1 to ``api.chain.dispatch_count``, a stagewise
    one (``chain_disabled``) 5; fused equals stagewise bit for bit; the
    same models on the CPU give the PCA output within allclose(1e-5,
    1e-6) and the same predictions.  Prints the byte accounting of
    ``bench.py:2030-2048`` and the median transform ms both ways.
26. The KMeans terminal: StandardScaler -> KMeans (k 256, 10 rounds
    through B4) on the KMeans headline's points (phase 7's), then the
    2^16 held-out rows fused and stagewise.  Checks: B5 launches once a
    transform (nothing else launches); the assignments bit for bit, and
    equal to a float64 argmin of the scaled rows off phase 7's near ties.
27. The IVF terminal: a StandardScaler fitted on the retrieval bench's
    corpus, the flat and the IVF-PQ index built on the scaled corpus, and
    [scaler, index] over the 256 queries at nprobe 2.  Checks: one B8 (then
    B9) call a transform (two CUDA launches); ids and distance bits equal
    fused and stagewise and to ``scaler.transform`` then ``search``.
28. The Wide&Deep terminal at the bench width: a StandardScaler on the
    dense column ahead of a model fitted 1 epoch; 8192 rows fused and
    stagewise, bit for bit; an out-of-range id raises (the terminal's
    host ``pre``) on both paths.
29. Composition: ``CrossValidator`` over phase 4's mixed LR (2^18 rows,
    2^20 features, batch 2^15, 2 epochs; reg 0 and 0.01; 3 folds;
    ``BinaryClassificationEvaluator``).  Checks: B1 and B2 launch the
    7 fits' steps x epochs (88); the same CV on the CPU chooses the same
    reg, gives every fold's AUC within 1e-4 and refits the winner within
    allclose(1e-3, 1e-4) (phase 4's marker saturates the AUC).  A ``GraphBuilder`` graph
    source -> StandardScaler -> KMeans fitted on phase 26's points gives
    phase 26's fused output bit for bit.
30. Serving, LR (``bench.py:1531-1624``'s endpoint: d 64, numpy seed 17
    weights, a 1024-row pool, 1-8-row requests, ``max_batch_rows`` 256,
    ``max_wait_ms`` 1.0, queue 2^14): the same 8 rows scored in every
    bucket 8-256 give the same bits (each family below too); 1, 8 and 64
    clients (64, 64, 16 requests each), every response equal to
    ``model.transform`` of its rows bit for bit, p50/p99 ms, requests/s,
    batches, fill ratio, warm-up ms by bucket; phase 4's Criteo-width
    mixed LR through ``make_servable`` (the ``model.transform`` route),
    bit for bit; a hot swap under 4 clients, every response exactly one
    generation's transform, nothing dropped.
31. Kernel servables at full width: KMeans on phase 7's centroids (B5 one
    launch a served batch; requests of 1-256 rows; B5 at every bucket
    8-256 against its plain version under phase 6's gate); phase 12's
    flat and IVF-PQ indexes at nprobe 2 (one retrieve call a batch; ids
    and distance bits equal ``search`` of each request alone); phase 10's
    Wide&Deep on a zipfian key mix (``bench.py:3841-3842``), plain and
    through the row cache (512 blocks of 512 rows), both bit for bit the
    offline transform; hit rate and pool bytes.
32. The multi-tenant scheduler (``bench.py:3414-3416,3496-3498``: 9 LR
    tenants at d 32, 1 interactive + 8 bulk with zipfian weights,
    ``max_batch_rows`` 128, bulk cap 8, ``max_wait_ms`` 0.5): tenants 2-9
    load no kernel library and build no plan; interactive p99 alone,
    under a bulk flood and through one FIFO endpoint; sheds under overload
    all bulk; a seeded ``chip_down`` schedule at the dispatch boundary
    requeues, and every retried response is bit-identical.
33. Int8: the LR of phase 30, the KMeans of phase 31 (B5, launches
    counted) and phase 10's Wide&Deep, plain and cached: decisions agree
    with f32 at 0.99 or better, two predicts give the same bits, cached
    int8 equals bypassed int8 bit for bit; resident param bytes.
34. Train while serving at the Criteo width: phase 4's mixed LR served,
    a ``ContinuousLearner`` (publish every 4 steps) over a ``WindowLog``
    of 16 windows of 2^15 Criteo-shaped rows: B1 and B2 once a step; 4
    publishes; the generation served after each cut equals an offline
    ``sgd_fit_outofcore`` over the first T windows bit for bit; 4
    clients throughout, nothing dropped, every response one published
    generation's transform bit for bit; a crash at ``serving.publish``
    and a torn WAL tail heal to the uninterrupted run's bits.
    ``bench_online``'s fields (``bench.py:2231-2392``), windows/s, cut ms.
35. Publishes into kernel servables: an OnlineKMeans body over phase 7's
    points (d 64, k 256) publishing each window's centroids into a KMeans
    endpoint (B5 once a served batch, each generation bit for bit its
    offline transform); phase 12's flat and IVF-PQ indexes as two
    tenants of one scheduler, 64 inserts + 64 deletes published as a
    sparse delta to each (one retrieve call a served batch, ids and
    distance bits = ``search`` of the updated index, the other tenant
    untouched, the recall probe gauge set); phase 10's Wide&Deep, plain
    and cached, a 1024-row embedding delta (payload bytes, encode and
    apply ms, bit for bit the offline transform, a fresh row cache).
36. Failover and placement (``bench_failover``'s shape,
    ``bench.py:4426-4470``): 4 logical chips, an LR d 32 victim, a bulk
    tenant and phase 31's KMeans on the victim chip; a seeded
    ``chip_down`` at a dispatch boundary under 16 closed-loop clients,
    unreplicated and 2-way replicated: nothing dropped, every response
    bit for bit its offline transform, brownout sheds bulk only and steps
    down after the hysteresis window, a requeued KMeans batch launches
    B5 again, an autoscale tick racing the failover costs one
    ``PlacementConflict`` retry; recovery wall s and interactive p99
    before/during/after.

37. GBT in core at ``bench_gbt``'s shape (``bench.py:1340-1357``: 2^19 x
    32 N(0,1) f32 rows, numpy seed 29, label ``X0 + 0.5 X1 X2 + 0.3 noise
    > 0``; 8 trees, depth 5, 64 bins, learning rate 0.2): ``train_forest``
    on the card, both histogram forms ("segsum": the fixed-order
    scatter-add; "mxu": the f32 one-hot product), each fit twice bit for
    bit; the first tree's level histograms of both forms against a
    float64 numpy histogram and each other (rtol 1e-4, atol 1e-5,
    ``bench.py:1388-1391``) and timed at n_nodes 1-16 beside the bytes
    bound; the training log-loss falling tree by tree and within 1e-3
    (relative) of the same fit on the CPU; the host share of a tree;
    ``predict_forest`` on the card equal to a numpy walk; a 3-class
    softmax fit at 2^16 rows whose probabilities sum to 1 within 1e-9.
    Prints the warm fits' trees/s.
38. GBT out of core: the same rows streamed from a ``DataCacheWriter``
    cache in 2^16-row batches; W 8 = W 1 and a rerun bit for bit; the
    training log-loss within 1e-4 (relative) of phase 37's in-core fit,
    and the nodes whose split differs; streamed trees/s.
39. The estimators: ``GBTClassifier(device="cuda")`` binary and 3-class
    and ``GBTRegressor`` (2^16 x 32) each within 1e-3 of the same fit on
    the CPU in training loss; ``NaiveBayes`` at smoothing 0 against
    float64 scores (-inf where a class never saw a present feature); KNN
    at k 5 (2^17 x 64 train, 4096 queries) against a float64 k-nearest
    vote, queries whose k-th and (k+1)-th distances tie within f32
    rounding held to the vote of some valid k-set; ``OneVsRest`` over
    ``LogisticRegression`` (4 classes) against the CPU; a
    ``StandardScaler -> GBTClassifier`` pipeline fitted and applied on
    the card (fused = stagewise bit for bit); the binary
    ``GBTClassifierModel`` served at requests of 1-256 rows, every
    response its offline transform bit for bit.  No kernel of the table
    runs in phases 37-41.
40. ALS at ``bench_als``'s shape (``bench.py:1218-1239``: 2^14 users,
    2^12 items, 2^21 uniform ratings N(0,1), numpy seed 3; rank 64, reg
    0.1, explicit), ``ALS(device="cuda")`` for 5 epochs: 'auto' plans
    the sorted form (both spans printed, under the cap of 256); two fits
    bit for bit; a user half-epoch from the start state on the card
    against the port on the host CPU (rtol 1e-4, atol 1e-4); 256 sampled
    users against float64 normal equations (1e-4 of the factor's norm);
    ALS-WR's objective falling every epoch through the fit's own body,
    whose factors equal the fit's (the training RMSE need not fall every
    epoch on ratings without low-rank structure: over the fit); the forced 'scatter' fit within 5e-3
    of the sorted fit; a workset fit (tol 1e-3) with its rounds and
    active fractions, its RMSE within 1% of the BSP fit's; an implicit
    fit finite and twice bit for bit; ``transform`` of 2^16 pairs within
    1e-5 of float64 dots (of |U_u| |V_i|); ``recommend_for_users`` for
    1024 users, k 10, training pairs excluded, equal to a float64 top-k
    (swaps within a tie of 1e-6 counted), scored by ``RankingEvaluator``
    over 2^14 held-out pairs.  Prints epochs/s of both forms (CUDA
    events, in turns) against the epoch's bound and the host plan build.
41. Swing (4096 users x 1024 items, 12-60 items a user drawn Zipf(1.1),
    the defaults): the scores twice bit for bit, symmetric within 1e-6,
    64 sampled item pairs within 1e-5 of a float64 sum over their common
    user pairs and those items' top-100 lists equal to float64's (swaps
    within a tie counted); seconds against ``2 U^2 I^2`` FLOPs.
    MinHashLSH (2^16 x 2048 binary rows, ~5% active, 4 tables x 4
    functions): signatures equal numpy int64 minima exactly, the masked
    min timed against its bound, ``approx_nearest_neighbors`` (k 10,
    16 planted near-duplicates) equal to the CPU's.
42. The text pipeline at 20 Newsgroups' size (scikit-learn's
    ``fetch_20newsgroups(subset="all")``: 18,846 documents, 20 classes),
    a synthetic corpus from numpy seed 0 (Zipf(1.1) word ids over 2^17
    rendered words, ~200 topic words a class, English stop words mixed
    in, 50-500 words a document): ``Tokenizer -> StopWordsRemover ->
    CountVectorizer (vocabularySize 2^14) -> IDF -> UnivariateFeatureSelector
    (ANOVA, numTopFeatures 2048) -> SoftmaxRegression`` fitted as one
    ``Pipeline`` on the card (3 epochs).  Prints the hasher that ran,
    the wall of each stage's fit and transform split into host and card
    time (``torch.profiler``; a spin kernel marks each stage), and which
    stages fused.  Checks: the fused transform = the stagewise one
    (numeric columns bit for bit, token columns list for list); IDF's
    product = the CPU port's bit for bit; ANOVA's F within rtol 1e-4 of
    the CPU's, and the card's 2048 indices = the CPU's selection by
    p-value, or every index that differs at the boundary (its F moved by
    1e-4 either way brackets the k-th p-value; p-values that underflow to
    0 tie and break to the lower index), the count printed; the softmax
    fit within allclose rtol 1e-3, atol 1e-4 of the CPU's, the loss
    falling every epoch; the evaluator's accuracy of the card's fit =
    the CPU fit's, or every prediction that differs a near tie.  Then, on
    phase 25's table (2^17 x 64, seed 23): ``VarianceThresholdSelector``
    (threshold 1.0) and the F-regression ``UnivariateFeatureSelector``
    (top 16), card against CPU by the same rules, and ``[variance
    selector, StandardScaler, F-regression selector, LinearRegression]``
    as one fused segment of 4 stages (one dispatch; stagewise 2: the
    selectors gather on the host), fused = stagewise.
43. A hashed Criteo fit: phase 4's 2^18 rows as columns ``I1..I13``
    (the dense values) and ``C1..C26`` (the ids as 8 hex digits):
    ``SQLTransformer`` (``LOG1P(MAX(Ij, 0))``, checked against numpy)
    -> ``FeatureHasher(numFeatures 2^20, sparseOutput)`` (nnz 39) ->
    ``LogisticRegression(device="cuda")``, 3 epochs at batch 2^15.
    Checks: every categorical slot = ``data/criteo.py``'s slot for the
    same token less ``n_reserved`` (``parse_chunk`` of the same rows as
    TSV, hash_space 2^20); the plan is "ell"; B1 and B2 ``kVal`` launch 8
    x 3 = 24 times each; one epoch = the same fit through the plain
    versions on the card; the loss falls every epoch; ``transform`` =
    numpy f64 scoring.

44. The bf16 stats kernel (``compute_dtype=torch.bfloat16``; at the
    headline ``kernels/csrc/kmeans_bf16.cu``, both products on ``wgmma``
    for every tie policy, the route asserted through ``bf16_plan``)
    against its plain twin at the headline (phase 6's points and
    centroids), each tie policy, and on phase 6's 1000 zero pad rows
    against duplicated centroids: one Lloyd step within the KMeans gate;
    the assignments that differ (half the counts' moves) at most the rows
    whose plain f32 top-two gap lies below the bf16 bound (``BF16_GAP``);
    no negative count after the pad correction, duplicated centroids
    counted alike; two launches the same bits.  ``kmeans.cu``'s bf16 modes
    (the route of shapes outside the plan) held against the twin at the
    headline under the same gates.  Times of the three policies beside
    ``kmeans.cu``'s bf16 modes, the f32 kernel, the plain twin, bf16
    ``addmm`` of the score product and the bare bf16 ``mm``, and the
    bound (the f32 points read once; the bf16 FLOPs of the score product,
    and of a dense one-hot sums product beside it); the bf16 BSP fit's
    iterations/s beside phase 7's f32 rate.  Appended: ``kmeans.cu``'s
    bf16 modes at the shapes outside ``bf16_plan`` (2^20 x 64 at k 1024,
    2^20 x 128 at k 256) against the plain twin (assignments that differ
    at most the rows near a bf16 flip; one Lloyd step within the KMeans
    gate on every cluster no flip touched), each policy timed beside bf16
    ``addmm``, the bare bf16 ``mm`` and the bound.
45. k-means++ on the card (``select_kmeanspp_centroids``, seed 0, k 256 on
    the headline table) with CUDA's sync debug mode at "error" around the
    k-1 rounds (no host sync), timed, k distinct centers, one seed one
    seeding; ``KMeans(initMode="k-means++", device="cuda")`` fit of 10
    rounds: the stats kernel launched once a round, the fit equal bit for
    bit to the seeding's rounds; the initial and final costs beside phase
    7's random-init fit (each fit lowers its cost).  Then KMeans at k 1024
    (5 rounds, the staged-centroid plan) and
    ``AgglomerativeClustering(ward, 16 clusters)`` over its 1024
    centroids, labels equal to a float64 numpy re-run.
46. The data-parallel fit (``parallel/``): two gloo ranks spawned on the
    one card, each with half of the headline table (NCCL refuses two ranks
    on one device), and a one-rank NCCL group with all of it;
    ``KMeans(device="cuda").fit`` in f32 and bf16, 10 rounds.  Every rank
    launches its stats kernel once a round (counted in the rank), all
    ranks hold the same centroids bit for bit, a replay through the
    group's kernel body ends on the fit bit for bit; each of the two-rank
    fit's rounds is within the KMeans gate of the one-process round from
    the same centroids and its objective within 1e-3 of the one-process
    fit's from the same init; the one-rank NCCL fit equals the one-process
    fit bit for bit.  Any rank that fails fails the phase.
47. The compressed data-parallel gradient reduction
    (``parallel/grad_reduce.py``; no kernel of the table on its path):
    four gloo ranks spawned on the one card, as a flat ``{"data": 4}``
    mesh and as the 2x2 ``("dcn", "data")`` mesh, each with a 2^20-f32
    gradient and a bias (numpy seed 4700 + rank; bench_comm's width,
    ``bench.py:1663``).  Reduces: exact, top-k 0.1 over the all-gather
    and over recursive halving/doubling, int8 dequant and fixed, top-k
    with 8 buckets, the adaptive ladder (0.01, 0.05, 0.1, "exact") and
    the hierarchical exact, top-k and int8.  Gates against numpy on the
    same inputs: every rank the same bits; exact within (P-1) u sum|g| of
    the float64 sum; top-k's residual on every rank bit for bit numpy's
    stable-argsort top-k, its sum bit for bit numpy's rank-order f32 sum
    (all-gather) or within (P-1) u of the f64 sum (rd); fixed's integer
    totals exactly; dequant within P quantization steps.  Each mode's
    first and median reduce ms, payload bytes, measured rd fill and the
    pairwise rounds staged through the host.  Then the data-parallel
    dense LR fit at d 2^14 (bench_comm's fit width, ``bench.py:1905``; 256
    rows a rank a step, 8 steps, 12 epochs): exact within the fit gate of
    the one-process fit of the same step batches; top-k 0.1 and the
    overlapped bucketed top-k within 1e-3 of the dense loss; blocking and
    overlapped step ms; and the exact and top-k fits in a one-rank NCCL
    group, bit for bit the one-process fits.

The last lines are the kernel table (ten kernels: the three ELL kernels,
each with its value variant's launches, error, times and bound under
``values`` and the streamed fit's launches under ``stream``, the three
KMeans kernels (the stats kernel with phase 22's launches under
``stream``) and the stats kernel's bf16 variant (``kmeans_bf16.cu``:
each policy's time, ``kmeans.cu``'s bf16 modes' and the bare bf16 ``mm``
beside it) beside them, the fold,
the two retrieve kernels; the launches a fused
transform or phase 29's CV added under ``chain``, the served batches'
launches of phase 31 under ``serve``, the train-while-serve launches
of phases 34-36 under ``online``, phase 43's under ``hashed`` and phase
46's data-parallel fits' under ``parallel``, by group)
as one JSON object, the card line from nvidia-smi, and ``{"ok": true,
"device": {...}}``.  The script imports neither JAX nor the JAX package.
"""

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

D_MAIN = 1 << 20            # hash-space size (the Criteo configuration)
BATCH = 1 << 15             # global batch
ROWS = 1 << 18              # 8 steps of 2^15
N_DENSE, N_CAT = 13, 26
EPOCHS = 3
D_PAIR = 128 * 1001         # 1001 table rows: not a multiple of 8
PAIR_ROWS, PAIR_BATCH = 1 << 14, 1 << 12
DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12      # H100 SXM fp32 on the CUDA cores (data sheet)
TF32_OPS_PER_S = 495e12     # H100 SXM TF32 on the tensor cores, dense

# KMeans headline (the JAX package's bench.py:54): N(0,1) f32 points
N_KM, D_KM, K_KM = 1 << 20, 64, 256
KM_ITERS, WS_ITERS = 10, 20
KM_HELD = 1 << 16           # held-out rows for transform
KM_RATE_ITERS = 50          # Lloyd rounds timed for iterations/s
KM_SOURCE = "flink_ml_tpu_torch/kernels/csrc/kmeans.cu"
KM_BF16_SOURCE = "flink_ml_tpu_torch/kernels/csrc/kmeans_bf16.cu"
KM_REPLACES = {
    "kmeans_update_stats": "flink_ml_tpu/ops/kmeans_pallas.py:300",
    "kmeans_assign_reduce": "flink_ml_tpu/ops/kmeans_pallas.py:340",
    "kmeans_workset_update": "flink_ml_tpu/ops/kmeans_pallas.py:507",
}
# The JAX benchmark's gate for the same near-tie rounding
# (bench.py:889-897): a point whose two best scores round apart flips,
# and one flip among ~4096 points of a cluster moves its centroid ~1e-3.
KM_GATE = dict(rtol=5e-3, atol=5e-3)
NEAR_TIE = 1e-5             # relative gap of the best two plain scores

# Wide&Deep bench width (the JAX package's bench.py:1094-1112)
WD_FIELDS, WD_DENSE = 26, 13
WD_VOCAB = (1 << 20) // WD_FIELDS          # 40329 per field
WD_EMB, WD_HIDDEN = 64, (1024, 512, 256)
WD_BATCH, WD_STEPS, WD_EPOCHS = 1 << 13, 16, 2
WD_HELD = 4096
WD_SOURCE = "flink_ml_tpu_torch/kernels/csrc/emb_grad.cu"
WD_REPLACES = "flink_ml_tpu/ops/emb_grad_pallas.py:98"
# one-epoch contract of tests/test_widedeep.py:394-399
WD_LOSS_TOL = dict(rtol=2e-5, atol=1e-6)
WD_PARAM_TOL = dict(rtol=1e-3, atol=1e-3)
WD_TABLE_KEYS = ("emb", "wide_cat", "wide_dense", "wide_b")
# the fold's timed routes (phase 11)
FOLD_TIMED = (("bench", 64), ("bench", 1), ("heavy", 64), ("heavy", 1),
              ("deep", 64), ("deep", 1))

# IVF retrieval bench (the JAX package's bench.py:4171-4213, full size):
# 4096 masses of 32 points, centers N(0,1) * 10, noise N(0,1) * 0.3, numpy
# seed 77; 256 queries near corpus rows
RT_N, RT_D, RT_PER_MASS = 131072, 64, 32
RT_NQ, RT_NLIST, RT_K = 256, 256, 10
RT_NPROBES = (1, 2, 4, 8, 16)
RT_REF_NPROBE = 2
RT_TIMED_NPROBES = (1, 2, 16)   # and nlist
RT_ROUNDS = 50              # timed rounds per frontier point
RT_PQ = dict(m=8, ksub=16)
RT_RECALL_FLOOR, RT_SCAN_BUDGET = 0.95, 0.25   # bench.py:4270-4276
RT_EDITS = 64               # inserts and deletes of the delta update
# the card's IVF-PQ recall@10 against a build on the CPU: 2560 slots near
# 0.34 put one standard error at ~0.01, and two builds whose fits part on
# near ties may land that far apart
RT_PQ_RECALL_GAP = 0.03
RT_SOURCE = "flink_ml_tpu_torch/kernels/csrc/retrieve.cu"
RT_REPLACES = {"retrieve_flat": "flink_ml_tpu/ops/retrieve_pallas.py:187",
               "retrieve_pq": "flink_ml_tpu/ops/retrieve_pallas.py:227"}
# the full-probe oracle excludes rows whose 10th and 11th float64
# distances lie within this share of |q|^2 + max|x|^2: the scale of the
# f32 rounding of (|q|^2 + |x|^2) - 2 q.x (phase 12 prints the rounding
# this run's full probe shows, as a share of the same)
RT_NEAR_TIE = 1e-6

SOURCE = "flink_ml_tpu_torch/kernels/csrc/ell_scatter.cu"
REPLACES = {
    "ell_margin": "flink_ml_tpu/ops/ell_scatter.py:790",
    "ell_scatter_apply_fused": "flink_ml_tpu/ops/ell_scatter.py:617",
    "ell_scatter_apply": "flink_ml_tpu/ops/ell_scatter.py:548",
}
# Tolerances of kernel vs plain version.  The three kernels add in the
# plain versions' order with rounded f32 operations and must match bit
# for bit.
TOL = {"ell_margin": 0.0, "ell_scatter_apply_fused": 0.0,
       "ell_scatter_apply": 0.0}
# The routing-chunk phase (15): the JAX package's plan at 2^17 features, 26
# slots and 2^24 rows puts the whole sample routing past its 1 GiB
# budget; the fit run there is cut to 2^17 rows in steps of 2^14 and its
# routing budget to 3 steps, so the fit builds its routing per chunk
C1_FEATURES, C1_ROWS = 1 << 17, 1 << 24
C1_FIT_ROWS, C1_FIT_BATCH, C1_CHUNK, C1_EPOCHS = 1 << 17, 1 << 14, 3, 2
# Dense fits (phase 18) at the pipeline bench's width (bench.py:1991-1994)
DN_ROWS, DN_DIM, DN_EPOCHS, DN_CLASSES = 1 << 17, 64, 2, 10
DN_HELD = 4096
# Criteo TSV ingest (phase 19): hash_space 2^20 - 13 gives 2^20 features
CT_ROWS = 1 << 17


# in-memory rates of phases 7 and 11, printed beside the streamed ones
RATES = {}


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg):
    print(msg, flush=True)


def criteo_rows(n, d, seed):
    """Criteo-shaped rows: 13 dense N(0,1) features, 26 hashed categorical
    indices in [32, d), labels driven by marker slot 0 in {16, 17} (the
    JAX package's benchmark data, ``bench.py:118-130``)."""
    rng = np.random.default_rng(seed)
    dense = rng.normal(size=(n, N_DENSE)).astype(np.float32)
    cat = rng.integers(32, d, size=(n, N_CAT)).astype(np.int32)
    y = rng.integers(0, 2, size=n).astype(np.float64)
    cat[:, 0] = np.where(y == 1, 16, 17)
    return dense, cat, y


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()
    return out[0]


class Timer:
    """Median milliseconds of ``fn`` over CUDA events.  Before each launch
    a 128 MB write evicts the 50 MB L2 (the training loop meets each
    step's layout cold), and a device sleep lets the host enqueue the
    launch before the start event fires, so host overhead stays out."""

    def __init__(self, torch, dev):
        self.torch = torch
        self.flush = torch.empty(32 << 20, dtype=torch.float32, device=dev)

    def ms(self, fn, reps=25, warm=3):
        torch = self.torch
        for _ in range(warm):
            fn()
        pairs = []
        for _ in range(reps):
            self.flush.zero_()
            torch.cuda._sleep(2_000_000)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in pairs)


def near_tie_rows(torch, scores):
    """Rows whose best two scores lie within NEAR_TIE (1 + |best|): there
    the kernel's dot order may pick the other centroid."""
    two = torch.topk(scores, 2, dim=1, largest=False).values
    return (two[:, 1] - two[:, 0]) <= NEAR_TIE * (1 + two[:, 0].abs())


def hold_rounds(torch, name, state, rounds, data, body, plain_body):
    """Steps a fit from ``state`` for ``rounds`` rounds through ``body``
    (the kernels), holding every round against ``plain_body`` (the plain
    versions) from the same state: the new centroids agree within KM_GATE.
    Returns the final centroids and the worst round's max |difference|."""
    worst = 0.0
    ws = isinstance(state, tuple)
    for r in range(rounds):
        args = (*state, r, data) if ws else (state, r, data)
        nxt = body(*args).feedback
        ref = plain_body(*args).feedback
        ck, cp = (nxt[0], ref[0]) if ws else (nxt, ref)
        worst = max(worst, float((ck - cp).abs().max()))
        if not torch.allclose(ck, cp, **KM_GATE):
            fail(f"{name}: round {r} of the fit disagrees with the plain "
                 f"versions' step (max {worst:.3e})")
        state = nxt
    return (state[0] if ws else state), worst


def kmeans_phases(torch, dev, card, timer):
    """Phases 6-8 (KMeans); returns the three kernels' JSON entries."""
    from flink_ml_tpu_torch import KMeans, Table
    from flink_ml_tpu_torch.distance import DistanceMeasure
    from flink_ml_tpu_torch.models.clustering import kmeans as KM
    from flink_ml_tpu_torch.ops import kmeans as K

    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.get_float32_matmul_precision() != "highest":
        fail("f32 matrix products must run in full f32 (TF32 is on)")
    n, d, k = N_KM, D_KM, K_KM
    host = np.random.default_rng(0).normal(size=(n, d)).astype(np.float32)
    pts = torch.from_numpy(host).to(dev)
    perm = np.random.default_rng(1).permutation(n)
    cents = torch.from_numpy(
        0.5 * (host[perm[:k]] + host[perm[k:2 * k]])).to(dev)
    ones = torch.ones(n, device=dev)
    err = {}

    def gate(name, got, want, what):
        e = float((got - want).abs().max())
        err[name] = max(err.get(name, 0.0), e)
        ok = torch.allclose(got, want, **KM_GATE)
        log(f"check {name} ({what}): max |kernel - plain| = {e:.3e} "
            f"(allclose rtol {KM_GATE['rtol']}, atol {KM_GATE['atol']})")
        if not ok:
            fail(f"{name} ({what}) disagrees with its plain version")

    def own_stats(name, a, s, c, weight):
        """Counts exactly, sums within 1e-5 of the cluster's sum of |p|
        (the scale of f32 summation error, whatever the cancellation), both
        against the plain stats of the kernel's own assignments."""
        want_s, want_c = K.stats_from_assign(k, pts, weight, a)
        abs_s, _ = K.stats_from_assign(k, pts.abs(), weight, a)
        ds = (s - want_s).abs()
        log(f"check {name}: counts max |diff| "
            f"{float((c - want_c).abs().max()):.1f} (exact), sums max "
            f"|diff| {float(ds.max()):.3e}, max |diff| / sum|p| "
            f"{float((ds / abs_s.clamp_min(1e-30)).max()):.3e} (1e-5)")
        if not torch.equal(c, want_c):
            fail(f"{name}: counts differ from its own assignments' counts")
        if not bool((ds <= 1e-5 * abs_s).all()):
            fail(f"{name}: sums differ from its own assignments' sums")
        err[name] = max(err.get(name, 0.0), float(ds.max()))

    def assignments(name, got, want, near):
        bad = int((got != want)[~near].sum())
        log(f"check {name}: {int(near.sum())} near-tie rows (best two "
            f"plain scores within {NEAR_TIE:g}(1+|best|)); {bad} differing "
            f"assignments elsewhere; {int((got != want).sum())} in all")
        if bad:
            fail(f"{name}: assignments differ off near-tie rows")

    def inertia(c):
        """Mean squared distance of the points to their nearest centroid."""
        sc = -2.0 * (pts @ c.T) + (c * c).sum(1)[None, :]
        return float(((pts * pts).sum(1) + sc.min(1).values).mean())

    def replay(name, fitted, plain_fit, state, rounds, body, plain_body):
        """A fit's rounds hold against the plain versions one round at a
        time (:func:`hold_rounds`), and the replay ends bit for bit on the
        fitted centroids (the kernels are deterministic).  Whole fits are
        not compared element-wise: on structureless N(0,1) data a near-tie
        flip in one round moves other points' ties in the next, so the two
        trajectories drift apart; they are held to the same objective
        (inertia within 1e-3 relative) instead."""
        final, worst = hold_rounds(torch, name, state, rounds, (pts, ones),
                                   body, plain_body)
        err[name] = max(err.get(name, 0.0), worst)
        ik, ip = inertia(fitted), inertia(plain_fit)
        log(f"check {name} ({rounds}-round fit): per-round max |kernel "
            f"step - plain step| {worst:.3e} (allclose rtol "
            f"{KM_GATE['rtol']}, atol {KM_GATE['atol']}); replay equals "
            f"the fit: {bool(torch.equal(final, fitted))}; whole fits differ "
            f"by max {float((fitted - plain_fit).abs().max()):.3e}; inertia "
            f"kernels {ik:.6f}, plain versions {ip:.6f}")
        if not torch.equal(final, fitted):
            fail(f"{name}: the fit is not reproduced by its replay")
        if not abs(ik - ip) <= 1e-3 * ip:
            fail(f"{name}: the fit's objective is off the plain fit's")
        return worst

    # -- 6. kernels vs plain versions at the headline ----------------------
    scores = -2.0 * (pts @ cents.T) + (cents * cents).sum(1)[None, :]
    near = near_tie_rows(torch, scores)
    del scores
    for tie in ("first", "fast", "split"):
        args = (cents, 0, (pts, ones))
        gate("kmeans_update_stats",
             KM.kmeans_epoch_step_kernel(k, tie_policy=tie)(*args).feedback,
             KM.kmeans_epoch_step_kernel(k, tie_policy=tie, plain=True)(
                 *args).feedback, f"one Lloyd step, tie {tie}")
    # zero pad rows against duplicated centroids (exact ties)
    n_pad = 1000
    pad_pts = pts.clone()
    pad_pts[-n_pad:] = 0.0
    pad_mask = ones.clone()
    pad_mask[-n_pad:] = 0.0
    dup = cents.clone()
    dup[0] *= 0.05
    dup[k - 1] = dup[0]                     # least norm, twice
    dup[k - 2] = dup[1]
    for tie in ("first", "fast", "split"):
        args = (dup, 0, (pad_pts, pad_mask))
        gate("kmeans_update_stats",
             KM.kmeans_epoch_step_kernel(k, tie_policy=tie)(*args).feedback,
             KM.kmeans_epoch_step_kernel(k, tie_policy=tie, plain=True)(
                 *args).feedback, f"zero pad rows, duplicated centroids, "
                                  f"tie {tie}")
        _, c = K.kmeans_update_stats(pad_pts, dup, tie_policy=tie)
        c = K.pad_correction(c, dup, n_pad, tie_policy=tie)
        if tie != "first" and not (c[0] == c[k - 1] and c[1] == c[k - 2]):
            fail(f"tie {tie}: duplicated centroids got unequal counts")
        if float(c.min()) < 0:
            fail(f"tie {tie}: pad correction left a negative count")

    a, s, c = K.kmeans_assign_reduce(pts, cents)
    want_a, _, _ = K.kmeans_assign_reduce_plain(pts, cents)
    assignments("kmeans_assign_reduce", a, want_a, near)
    own_stats("kmeans_assign_reduce", a, s, c, ones)

    rng = np.random.default_rng(3)
    prev = torch.from_numpy(rng.integers(0, k, n).astype(np.int32)).to(dev)
    active = torch.from_numpy((rng.random(n) < 0.5).astype(np.float32)
                              ).to(dev)
    ws_pad = torch.from_numpy((rng.random(n) < 0.9).astype(np.float32)
                              ).to(dev)
    ws_args = (pts, cents, prev, active, ws_pad)
    wa, wb, wsec, ws_s, ws_c = K.kmeans_workset_update(*ws_args)
    pa, pb, psec, _, _ = K.kmeans_workset_update_plain(*ws_args)
    assignments("kmeans_workset_update", wa, pa, near)
    db = max(float((wb - pb).abs().max()), float((wsec - psec).abs().max()))
    log(f"check kmeans_workset_update: max |d_best|, |d_second| error "
        f"{db:.3e} (tolerance 1e-4)")
    if not db <= 1e-4:
        fail("kmeans_workset_update: distances disagree")
    err["kmeans_workset_update"] = db
    own_stats("kmeans_workset_update", wa, ws_s, ws_c, ws_pad)
    if not torch.equal(wa[active == 0], prev[active == 0]):
        fail("kmeans_workset_update: a settled row lost its cached "
             "assignment")
    del pad_pts, pa, pb, psec, want_a

    # -- 7. main paths -----------------------------------------------------
    table = Table({"features": host})
    est = KMeans(device=DEVICE).set_k(k).set_max_iter(KM_ITERS)
    K.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = est.fit(table)
    torch.cuda.synchronize()
    bsp_s = time.perf_counter() - t0
    FITTED["kmeans"] = model
    bsp_launches = dict(K.LAUNCHES)
    log(f"KMeans fit: {bsp_s:.3f} s for {KM_ITERS} rounds of {n} x {d}, "
        f"k {k} (host->device copy included); plan {est.planned_impl}; "
        f"launches {bsp_launches}")
    if est.planned_impl != "kernel":
        fail(f"KMeans planned {est.planned_impl!r}, expected 'kernel'")
    if bsp_launches != {"kmeans_update_stats": KM_ITERS,
                        "kmeans_update_stats_bf16": 0,
                        "kmeans_assign_reduce": 0,
                        "kmeans_workset_update": 0}:
        fail(f"KMeans fit launches {bsp_launches}")
    measure = DistanceMeasure.get_instance("euclidean")
    init = torch.from_numpy(KM.select_random_centroids(host, k, 0)).to(dev)
    plan = KM._fit_plan(n, d, k, measure)
    got = torch.from_numpy(model.get_model_data()[0]["centroids"][0]).to(dev)
    want = KM.fit_centroids(pts, ones, init, plan, measure=measure,
                            max_iter=KM_ITERS, plain=True).state
    bsp_worst = replay("kmeans_update_stats", got, want, init, KM_ITERS,
                       KM.kmeans_epoch_step_kernel(k),
                       KM.kmeans_epoch_step_kernel(k, plain=True))
    # the same rounds through the CUDA-core scoring (tie policy fast),
    # for the per-round error margin of both scoring paths
    _, fma_worst = hold_rounds(
        torch, "kmeans_update_stats (fast)", init, KM_ITERS, (pts, ones),
        KM.kmeans_epoch_step_kernel(k, tie_policy="fast"),
        KM.kmeans_epoch_step_kernel(k, tie_policy="fast", plain=True))
    log(f"per-round error margin over the {KM_ITERS}-round fit: tensor-core "
        f"scoring (first) {bsp_worst:.3e}, CUDA-core "
        f"scoring (fast) {fma_worst:.3e} (allclose rtol {KM_GATE['rtol']}, "
        f"atol {KM_GATE['atol']})")

    ws_est = (KMeans(device=DEVICE).set_k(k).set_max_iter(WS_ITERS)
              .set_workset(True))
    K.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ws_model = ws_est.fit(table)
    torch.cuda.synchronize()
    ws_s_wall = time.perf_counter() - t0
    ws_launches = dict(K.LAUNCHES)
    rep = ws_est.last_workset_report
    log(f"KMeans workset fit: {ws_s_wall:.3f} s, {rep['rounds']} rounds "
        f"(max {WS_ITERS}); plan {ws_est.planned_impl}; launches "
        f"{ws_launches}; active fraction per round "
        f"{np.round(rep['active_fraction'], 4).tolist()}")
    if ws_est.planned_impl != "kernel_ws":
        fail(f"workset fit planned {ws_est.planned_impl!r}")
    if ws_launches["kmeans_workset_update"] != rep["rounds"] or \
            ws_launches["kmeans_update_stats"] != 0:
        fail(f"workset fit launches {ws_launches}, rounds {rep['rounds']}")
    if rep["rounds"] != len(rep["active_fraction"]) or \
            rep["points_scored"][0] != n or not 0 < rep["rounds"] <= WS_ITERS:
        fail(f"inconsistent workset report {rep}")
    ws_plan = KM._fit_plan(n, d, k, measure, workset=True)
    got = torch.from_numpy(ws_model.get_model_data()[0]["centroids"][0]
                           ).to(dev)
    want = KM.fit_centroids(pts, ones, init, ws_plan, measure=measure,
                            max_iter=WS_ITERS, workset=True, plain=True)
    log(f"plain workset fit on the card: {want.num_epochs} rounds")
    replay("kmeans_workset_update", got, want.state,
           (init, ws_plan.init_workset(ones)), rep["rounds"],
           KM.kmeans_workset_epoch_step(measure, k, kernel=True),
           KM.kmeans_workset_epoch_step(measure, k))

    held = np.random.default_rng(9).normal(size=(KM_HELD, d)).astype(
        np.float32)
    K.reset_launch_counts()
    (out,) = model.transform(Table({"features": held}))
    torch.cuda.synchronize()
    tr_launches = dict(K.LAUNCHES)
    if tr_launches["kmeans_assign_reduce"] != 1 or \
            sum(tr_launches.values()) != 1:
        fail(f"transform launches {tr_launches}")
    fitted = model.get_model_data()[0]["centroids"][0].astype(np.float64)
    h64 = held.astype(np.float64)
    d2 = ((h64 * h64).sum(1)[:, None] - 2.0 * h64 @ fitted.T
          + (fitted * fitted).sum(1)[None, :])
    two = np.sort(d2, axis=1)[:, :2]
    near64 = two[:, 1] - two[:, 0] <= 1e-5 * two[:, 1]
    pred = out["prediction"]
    off = int(np.sum((pred != d2.argmin(1)) & ~near64))
    log(f"transform: {KM_HELD} rows, launches {tr_launches}, "
        f"{int(near64.sum())} rows within 1e-5 relative of a tie in f64, "
        f"{off} other rows off the float64 argmin")
    if pred.shape != (KM_HELD,) or pred.dtype != np.int64 or off:
        fail("transform disagrees with the float64 argmin")

    # -- 8. times ----------------------------------------------------------
    c2 = (cents * cents).sum(1)[None, :]
    yard = lambda: torch.addmm(c2, pts, cents.T, alpha=-2.0)  # noqa: E731
    ops = 2.0 * n * k * d
    f4 = 4
    bytes_moved = {
        # points and centroids read; sums and counts written
        "kmeans_update_stats": (n * d + 2 * k * d + k) * f4,
        # + the (n,) assignment written
        "kmeans_assign_reduce": (n * d + 2 * k * d + k + n) * f4,
        # + prev, active, pad_mask read; assign, d_best, d_second written
        "kmeans_workset_update": (n * d + 2 * k * d + k + 6 * n) * f4,
    }
    runs = {
        "kmeans_update_stats": (
            lambda: K.kmeans_update_stats(pts, cents, tie_policy="first"),
            lambda: K.kmeans_update_stats_plain(pts, cents,
                                                tie_policy="first")),
        "kmeans_assign_reduce": (
            lambda: K.kmeans_assign_reduce(pts, cents),
            lambda: K.kmeans_assign_reduce_plain(pts, cents)),
        "kmeans_workset_update": (
            lambda: K.kmeans_workset_update(*ws_args),
            lambda: K.kmeans_workset_update_plain(*ws_args)),
    }
    count = {"kmeans_update_stats": bsp_launches["kmeans_update_stats"],
             "kmeans_assign_reduce": tr_launches["kmeans_assign_reduce"],
             "kmeans_workset_update": ws_launches["kmeans_workset_update"]}
    lib_ms = timer.ms(yard)
    entries = []
    for name, (kern, plain) in runs.items():
        ms, plain_ms = timer.ms(kern), timer.ms(plain, reps=10)
        # the timed modes score with 3xTF32 products on the tensor cores
        ops_ms = 3 * ops / TF32_OPS_PER_S * 1e3
        fp32_ms = ops / FP32_OPS_PER_S * 1e3
        bytes_ms = bytes_moved[name] / HBM_BYTES_PER_S * 1e3
        bound_ms = max(ops_ms, bytes_ms)
        bound_by = "operations" if ops_ms >= bytes_ms else "bytes"
        log(f"time {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"addmm (score product only) {lib_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by}: 3xTF32 on the tensor cores; "
            f"the same work in fp32 on the CUDA cores {fp32_ms:.4f} ms; "
            f"bytes alone {bytes_ms:.4f} ms) [{card}]")
        entries.append({
            "name": name, "route": "cuda", "source": KM_SOURCE,
            "replaces": KM_REPLACES[name], "launches": count[name],
            "max_abs_err": err[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_ms,
        })
    for tie in ("fast", "split"):
        ms = timer.ms(lambda: K.kmeans_update_stats(pts, cents,
                                                    tie_policy=tie))
        log(f"time kmeans_update_stats tie {tie}: kernel {ms:.4f} ms "
            f"[{card}]")

    rates = {}
    for label, plain in (("kernels", False), ("plain", True)):
        body = KM.kmeans_epoch_step_kernel(k, plain=plain)
        iters = KM_RATE_ITERS if not plain else KM_RATE_ITERS // 5
        c = body(cents, 0, (pts, ones)).feedback
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(iters):
            c = body(c, i, (pts, ones)).feedback
        torch.cuda.synchronize()
        rates[label] = iters / (time.perf_counter() - t0)
    RATES["kmeans_iters_per_s"] = rates["kernels"]
    log(f"KMeans BSP iterations/s at {n} x {d}, k {k}, device-resident "
        f"points: kernels {rates['kernels']:.3f}, plain versions "
        f"{rates['plain']:.3f}; workset fit {ws_s_wall:.3f} s for "
        f"{rep['rounds']} rounds [{card}]")
    return entries


def widedeep_bench_data(rows_per_step, steps, seed=17):
    """The JAX package's Wide&Deep bench data (``bench.py:1102-1112``):
    raw per-field ids uniform in [0, 40329), N(0,1) dense features, random
    labels, drawn in that order as ``(steps, batch, ...)`` stacks."""
    rng = np.random.default_rng(seed)
    cat = rng.integers(0, WD_VOCAB, size=(steps, rows_per_step, WD_FIELDS)
                       ).astype(np.int32)
    dense = rng.normal(size=(steps, rows_per_step, WD_DENSE)).astype(
        np.float32)
    y = rng.integers(0, 2, size=(steps, rows_per_step)).astype(np.float32)
    return cat, dense, y


def numpy_widedeep_scores(params, dense, ids):
    """float64 numpy forward of fitted parameters (``ids`` offset)."""
    p = {k: np.asarray(v, np.float64) for k, v in params.items()
         if k != "mlp"}
    d = dense.astype(np.float64)
    wide = d @ p["wide_dense"] + p["wide_cat"][ids].sum(1) + p["wide_b"]
    deep = np.concatenate([d, p["emb"][ids].reshape(len(d), -1)], axis=1)
    for i, layer in enumerate(params["mlp"]):
        deep = deep @ layer["w"].astype(np.float64) + layer["b"]
        if i + 1 < len(params["mlp"]):
            deep = np.maximum(deep, 0.0)
    return 1.0 / (1.0 + np.exp(-(wide + deep[:, 0])))


def fold_routes(G, dev):
    """Phase 9's fold routes on the card, ``name -> (route, table rows)``:
    step 0 of the bench route; the heavy-hitter route (vocab 2^20, field
    0 = 7 in half the rows, ``bench.py:2911-2915``: 12 passes); the deep
    route (a run of 2 x 8192: 14 passes); a ragged S = 1000 x 26 (scatter
    placement).  Also the every-id-distinct ids of the zero-pass check."""
    offs = np.arange(WD_FIELDS, dtype=np.int64) * WD_VOCAB
    total = WD_VOCAB * WD_FIELDS
    cat, _, _ = widedeep_bench_data(WD_BATCH, 1)
    rng = np.random.default_rng(2911)
    heavy = rng.integers(0, 1 << 20, size=(1, WD_BATCH, WD_FIELDS))
    heavy[0, :WD_BATCH // 2, 0] = 7
    deep = rng.integers(0, 1 << 20, size=(1, WD_BATCH, WD_FIELDS))
    deep[0, :, :2] = 7
    ragged = rng.integers(0, WD_VOCAB, size=(1, 1000, WD_FIELDS)) + offs
    unique = rng.permutation(total)[:WD_BATCH * WD_FIELDS].reshape(
        1, WD_BATCH, WD_FIELDS)
    routes = {
        "bench": (G.emb_grad_route(cat + offs, total).to(dev), total),
        "heavy": (G.emb_grad_route(heavy, 1 << 20).to(dev), 1 << 20),
        "deep": (G.emb_grad_route(deep, 1 << 20).to(dev), 1 << 20),
        "ragged": (G.emb_grad_route(ragged, total, placement="scatter"
                                    ).to(dev), total),
    }
    return routes, unique


def fold_rows(torch, route, E, dev):
    """Seeded (S, E) gradient rows (every 9th -0.0; E = 1 squeezed) of a
    phase-9 route: ``(sorted rows, rows in slot order)``."""
    n_slots = route.order.shape[1]
    g = torch.from_numpy(np.random.default_rng(E).normal(
        size=(n_slots, E)).astype(np.float32)).to(dev)
    g[::9] = -0.0
    flat = g if E > 1 else g[:, 0].contiguous()
    return torch.index_select(flat, 0, route.order[0]), flat


def fold_bound_ms(n_slots, E):
    """Bytes the fold must move at 3.35 TB/s: rows read and written once,
    ids read once."""
    return (2 * n_slots * E * 4 + n_slots * 4) / HBM_BYTES_PER_S * 1e3


def widedeep_phases(torch, dev, card, timer):
    """Phases 9-11 (Wide&Deep); returns the fold kernel's JSON entry."""
    from flink_ml_tpu_torch import Table, WideDeep
    from flink_ml_tpu_torch.models.common import sgd as S
    from flink_ml_tpu_torch.models.recommendation import widedeep as W
    from flink_ml_tpu_torch.ops import emb_grad as G

    vocab_sizes = [WD_VOCAB] * WD_FIELDS
    total = WD_VOCAB * WD_FIELDS
    offs = W._field_offsets(vocab_sizes)
    cat, dense, y = widedeep_bench_data(WD_BATCH, WD_STEPS)

    # -- 9. the fold kernel vs its plain version, bit for bit --------------
    routes, unique = fold_routes(G, dev)
    g_rows = {}
    err = 0.0
    for name, (route, _) in routes.items():
        n_slots = route.order.shape[1]
        P = route.fold_passes
        for E in (64, 1):
            sorted_g, flat = fold_rows(torch, route, E, dev)
            g_rows[name, E] = (sorted_g, flat)
            got = G.fold_runs(sorted_g, route.sorted_ids[0], P)
            want = G.fold_runs_plain(sorted_g, route.sorted_ids[0], P)
            placed = route.apply(flat, *route.step_slice(0))
            placed_plain = route.apply(flat, *route.step_slice(0),
                                       plain=True)
            torch.cuda.synchronize()
            e = max(float((got - want).abs().max()),
                    float((placed - placed_plain).abs().max()))
            err = max(err, e)
            same = torch.equal(got, want) and torch.equal(placed,
                                                          placed_plain)
            log(f"check fold_runs ({name} route, S {n_slots}, E {E}, "
                f"fold_passes {P}, {route.placement} placement): bitwise "
                f"equal to the plain fold: {same} (tolerance 0)")
            if not same:
                fail(f"fold_runs disagrees with its plain version on the "
                     f"{name} route at E {E}")
    # runs of >= batch/2 and >= 2 x batch rows: 12 and 14 passes at 8192
    if routes["heavy"][0].fold_passes < (WD_BATCH // 2).bit_length() - 1 \
            or routes["deep"][0].fold_passes < (2 * WD_BATCH).bit_length() - 1:
        fail("the heavy-hitter routes do not reach their fold depth")
    route0 = G.emb_grad_route(unique, total).to(dev)
    G.reset_launch_counts()
    zero = route0.apply(torch.ones(WD_BATCH * WD_FIELDS, 64, device=dev),
                        *route0.step_slice(0))
    torch.cuda.synchronize()
    log(f"fold_passes {route0.fold_passes} route (every id distinct): fold "
        f"launches {G.LAUNCHES['fold_runs']}")
    if route0.fold_passes != 0 or G.LAUNCHES["fold_runs"] != 0 or \
            float(zero.sum()) != WD_BATCH * WD_FIELDS * 64:
        fail("a route with fold_passes == 0 launched the fold kernel")

    # -- 10. main path -----------------------------------------------------
    rows = WD_BATCH * WD_STEPS
    table = Table({"denseFeatures": dense.reshape(rows, WD_DENSE),
                   "catFeatures": cat.reshape(rows, WD_FIELDS),
                   "label": y.reshape(rows)})

    def estimator(epochs):
        return (WideDeep(device=DEVICE).set_vocab_sizes(vocab_sizes)
                .set(WideDeep.EMBEDDING_DIM, WD_EMB)
                .set(WideDeep.HIDDEN_UNITS, WD_HIDDEN)
                .set_global_batch_size(WD_BATCH).set_max_iter(epochs)
                .set_seed(0))

    est = estimator(WD_EPOCHS)
    G.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = est.fit(table)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    FITTED["widedeep"] = model
    launches = G.LAUNCHES["fold_runs"]
    info = est.route_info
    losses = model.loss_log
    log(f"Wide&Deep fit: {fit_s:.3f} s for {WD_EPOCHS} epochs of {rows} "
        f"rows (host route build {info['build_s']:.3f} s, init and copies "
        f"included); route {info}; fold launches {launches}; loss log "
        f"{losses}")
    if info["placement"] != "gather":
        fail(f"placement {info['placement']!r}, expected 'gather'")
    if info["fold_passes"] < 1:
        fail("fold_passes 0 at the bench width: the kernel is not on the "
             "path")
    if launches != 2 * WD_STEPS * WD_EPOCHS:
        fail(f"fold_runs launched {launches} times on the main path, "
             f"expected {2 * WD_STEPS * WD_EPOCHS}")
    if len(losses) != WD_EPOCHS or not all(np.isfinite(losses)) or \
            not losses[1] < losses[0]:
        fail(f"loss log {losses}")

    def one_epoch_gate(what, a, b):
        d = {k: float(np.max(np.abs(a._params[k] - b._params[k])))
             for k in WD_TABLE_KEYS}
        identical = all(np.array_equal(a._params[k], b._params[k])
                        for k in WD_TABLE_KEYS) and all(
            np.array_equal(la["w"], lb["w"]) and np.array_equal(la["b"],
                                                               lb["b"])
            for la, lb in zip(a._params["mlp"], b._params["mlp"]))
        log(f"one epoch, {what}: loss {a.loss_log} vs {b.loss_log}; max "
            f"|d param| {d}; bit-identical: {identical} (loss rtol "
            f"{WD_LOSS_TOL['rtol']}, params rtol {WD_PARAM_TOL['rtol']} "
            f"atol {WD_PARAM_TOL['atol']})")
        if not np.allclose(a.loss_log, b.loss_log, **WD_LOSS_TOL):
            fail(f"one epoch, {what}: losses disagree")
        for k in WD_TABLE_KEYS:
            if not np.allclose(a._params[k], b._params[k], **WD_PARAM_TOL):
                fail(f"one epoch, {what}: {k} disagrees")

    # the fit's own epoch layout, route and init draws on the device (seed
    # 0: the row shuffle; seed + 1: the init), for the replay here and the
    # step rates of phase 11
    steps, batch, perm = S.plan_epoch_layout(rows, WD_BATCH, 1, 0)
    lay = lambda a: torch.from_numpy(np.ascontiguousarray(  # noqa: E731
        S.prepare_epoch_tensor(a, perm, steps, batch))).to(dev)
    C = S.prepare_epoch_tensor((cat.reshape(rows, WD_FIELDS) + offs
                                ).astype(np.int32), perm, steps, batch)
    t0 = time.perf_counter()
    fit_route = G.emb_grad_route(C, total)
    build_s = time.perf_counter() - t0
    fit_route = fit_route.to(dev)
    epoch = (lay(dense.reshape(rows, WD_DENSE)), torch.from_numpy(C).to(dev),
             lay(y.reshape(rows)), lay(np.ones(rows, np.float32)))
    host_params = W.init_params(np.random.default_rng(1), WD_DENSE,
                                vocab_sizes, WD_EMB, WD_HIDDEN)

    one_k = estimator(1).fit(table)
    one_p = estimator(1).fit(table, plain=True)
    one_epoch_gate("kernel vs plain fold on the card", one_k, one_p)
    del one_p

    # routed (kernel) vs the fixed-order scatter-add of the 'off' step.
    # From the same state one step differs only in the order of
    # the table-gradient sums, so every step of the epoch is gated from
    # the routed fit's own state, and the replay must end bit for bit on
    # the routed fit.  The whole epochs are held to the loss only: Adam's
    # update at a rarely touched row is ~sign(g) * lr whatever |g|, so a
    # ReLU that flips on one sample's ~1e-7 reordering moves that
    # sample's table rows by up to 2 * lr a step; the two trajectories
    # part there and nowhere else.
    params = W.params_to_device(host_params, dev)
    routed_step, state = W._make_train_ops(params, 1e-2, False,
                                             route=fit_route)
    off_step, _ = W._make_train_ops(params, 1e-2, False)
    worst = {k: 0.0 for k in WD_TABLE_KEYS}
    for i in range(steps):
        batch_i = tuple(a[i] for a in epoch)
        p_r, s_r, l_r = routed_step(params, state, *batch_i,
                                    *fit_route.step_slice(i))
        p_o, _, l_o = off_step(params, state, *batch_i)
        if not np.allclose(float(l_r), float(l_o), **WD_LOSS_TOL):
            fail(f"step {i}: routed loss {float(l_r)} vs 'off' "
                 f"{float(l_o)}")
        for k in WD_TABLE_KEYS:
            worst[k] = max(worst[k], float((p_r[k] - p_o[k]).abs().max()))
            if not torch.allclose(p_r[k], p_o[k], **WD_PARAM_TOL):
                fail(f"step {i}: routed vs 'off' {k} disagree")
        params, state = p_r, s_r
        del p_o
    replayed = all(np.array_equal(params[k].cpu().numpy(), one_k._params[k])
                   for k in WD_TABLE_KEYS)
    one_off = estimator(1).set(WideDeep.ROUTED_EMB_GRAD, "off").fit(table)
    # C4: the fits without the route gather through _FixedOrderRows, so
    # two of them give the same bits
    repeat = {"off": _wd_same(one_off, estimator(1).set(
        WideDeep.ROUTED_EMB_GRAD, "off").fit(table))}
    lazy_one = estimator(1).set(WideDeep.LAZY_EMB_OPT, True).fit(table)
    repeat["lazy"] = _wd_same(lazy_one, estimator(1).set(
        WideDeep.LAZY_EMB_OPT, True).fit(table))
    del lazy_one
    log(f"two in-memory Wide&Deep fits give the same bits: {repeat}")
    if not all(repeat.values()):
        fail("two in-memory Wide&Deep fits without the route differ")
    part = {k: int(np.sum(~np.isclose(one_k._params[k], one_off._params[k],
                                      **WD_PARAM_TOL)))
            for k in WD_TABLE_KEYS}
    whole = {k: float(np.max(np.abs(one_k._params[k] - one_off._params[k])))
             for k in WD_TABLE_KEYS}
    log(f"one epoch, routed (kernel) vs autograd scatter-add 'off', step "
        f"by step from the routed state: max |d param| {worst} (loss rtol "
        f"{WD_LOSS_TOL['rtol']}, params rtol {WD_PARAM_TOL['rtol']} atol "
        f"{WD_PARAM_TOL['atol']}); replay equals the fit: {replayed}; whole "
        f"epochs: loss {one_k.loss_log} vs {one_off.loss_log}, max |d "
        f"param| {whole}, values past the tolerance {part}")
    if not replayed:
        fail("the routed fit is not reproduced by its step replay")
    if not np.allclose(one_k.loss_log, one_off.loss_log, **WD_LOSS_TOL):
        fail("one epoch, routed vs 'off': losses disagree")
    del one_off, one_k, params, state, p_r, s_r

    h_cat, h_dense, _ = widedeep_bench_data(WD_HELD, 1, seed=9)
    h_cat, h_dense = h_cat[0], h_dense[0]
    (out,) = model.transform(Table({"denseFeatures": h_dense,
                                    "catFeatures": h_cat}))
    want = numpy_widedeep_scores(model._params, h_dense, h_cat + offs)
    perr = float(np.max(np.abs(out["rawPrediction"] - want)))
    log(f"transform: {WD_HELD} rows, max |score - numpy f64 score| = "
        f"{perr:.3e} (tolerance 1e-5)")
    if out["rawPrediction"].shape != (WD_HELD,) or not np.all(
            np.isfinite(out["rawPrediction"])) or perr > 1e-5:
        fail("transform disagrees with a numpy forward of the fitted "
             "parameters")

    # -- 11. times ---------------------------------------------------------
    results = {}
    for name, E in FOLD_TIMED:
        route, num_rows = routes[name]
        sorted_g, flat = g_rows[name, E]
        sid = route.sorted_ids[0]
        P = route.fold_passes
        # the slots' ids in batch order: sorted_ids[inverse of order]
        ids = sid.long()[torch.argsort(route.order[0].long())]
        ms = timer.ms(lambda: G.fold_runs(sorted_g, sid, P))
        plain_ms = timer.ms(lambda: G.fold_runs_plain(sorted_g, sid, P),
                            reps=10)
        lib_ms = timer.ms(lambda: torch.zeros(
            (num_rows,) + tuple(flat.shape[1:]), device=dev).index_add_(
                0, ids, flat))
        n_slots = sid.shape[0]
        bound_ms = fold_bound_ms(n_slots, E)
        results[name, E] = (ms, plain_ms, lib_ms, bound_ms)
        if (name, E) == ("bench", 64):
            # C4's cost at the 'off' step's table gradient: the backward
            # of _FixedOrderRows (fixed order) beside index_add_ above
            c4_ms = timer.ms(lambda: S._scatter_add_(torch.zeros(
                (num_rows,) + tuple(flat.shape[1:]), device=dev), ids, flat))
        levels = G._kernels().emb_fold_group_levels()
        log(f"time fold_runs ({name} route, S {n_slots}, E {E}, "
            f"fold_passes {P}: {-(-P // levels)} level-group launches of "
            f"up to {levels} levels): kernel {ms:.4f} ms,"
            f" plain {plain_ms:.4f} ms, index_add_ scatter-add into the "
            f"({num_rows}, {E}) table (the downstream table gradient, not "
            f"the fold) {lib_ms:.4f} ms, bound {bound_ms:.4f} ms (bytes) "
            f"[{card}]")

    rates = {}
    for label, mode in (("kernel", "kernel"), ("plain", "plain"),
                        ("off", "off")):
        params = W.params_to_device(host_params, dev)
        step, state = W._make_train_ops(
            params, 1e-2, False,
            route=None if mode == "off" else fit_route,
            plain=mode == "plain")

        def run(params, state):
            for i in range(steps):
                extra = () if mode == "off" else fit_route.step_slice(i)
                params, state, _ = step(params, state,
                                        *(a[i] for a in epoch), *extra)
            return params, state

        params, state = run(params, state)          # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state = run(params, state)
        torch.cuda.synchronize()
        rates[label] = steps / (time.perf_counter() - t0)
        del params, state
    RATES["widedeep_steps_per_s"] = dict(rates)
    log(f"Wide&Deep steps/s at the bench width (batch {WD_BATCH}, "
        f"{steps} steps, fold_passes {fit_route.fold_passes}), "
        f"device-resident "
        f"epoch tensors: kernel {rates['kernel']:.3f}, plain fold "
        f"{rates['plain']:.3f}, fixed-order autograd scatter-add 'off' "
        f"{rates['off']:.3f} (C4: its table gradient at step 0, E 64, "
        f"{c4_ms:.4f} ms against index_add_ "
        f"{results['bench', 64][2]:.4f}); fit() wall {fit_s:.3f} s for {WD_EPOCHS} "
        f"epochs incl. host route build {info['build_s']:.3f} s (route "
        f"build alone, this layout: {build_s:.3f} s) [{card}]")

    ms, plain_ms, lib_ms, bound_ms = results["bench", 64]
    return {
        "name": "fold_runs", "route": "cuda", "source": WD_SOURCE,
        "replaces": WD_REPLACES, "launches": launches, "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "bytes", "library_ms": lib_ms,
    }


def retrieval_corpus(n, d, nq, per_mass=RT_PER_MASS):
    """The JAX package's retrieval bench corpus (``bench.py:4208-4213``):
    ``n // per_mass`` masses, centers N(0,1) * 10, points N(0,1) * 0.3
    around them, and ``nq`` queries near corpus rows, numpy seed 77."""
    rng = np.random.default_rng(77)
    centers = rng.normal(size=(n // per_mass, d)).astype(np.float32) * 10.0
    X = (np.repeat(centers, per_mass, axis=0)
         + rng.normal(size=(n, d)) * 0.3).astype(np.float32)
    queries = (X[rng.choice(n, size=nq, replace=False)]
               + rng.normal(size=(nq, d)) * 0.05).astype(np.float32)
    return X, queries


def hold_codebook_fits(torch, dev, X, index):
    """An IVF-PQ build's codebook fits (the workset kernel at (n, d / m),
    k = ksub) against the plain versions on the card.  Each fit is replayed
    from its initial centroids with every round held to the plain step from
    the same state (:func:`hold_rounds`); the replay's books, quantized,
    equal the index's stored ``cb_q``/``cb_s`` bit for bit, so they are the
    build's own fits; and each fit's distortion (mean squared distance of
    the residual subvectors to their nearest entry) lies within 1e-3
    relative of the same fit through the plain versions."""
    from flink_ml_tpu_torch.distance import DistanceMeasure
    from flink_ml_tpu_torch.kernels.quantize import quantize_rows
    from flink_ml_tpu_torch.models.clustering import kmeans as KM
    from flink_ml_tpu_torch.retrieval.ivf import _nearest_list

    def distortion(pts, book):
        p, c = pts.double(), book.double()
        d2 = ((p * p).sum(1)[:, None] - 2.0 * p @ c.T
              + (c * c).sum(1)[None, :])
        return float(d2.min(1).values.mean())

    measure = DistanceMeasure.get_instance("euclidean")
    cfg, cents = index.pq, index.params["centroids"]
    n, d = X.shape
    dsub = d // cfg.m
    resid = X - cents[_nearest_list(cents, X)]
    plan = KM._fit_plan(n, dsub, cfg.ksub, measure, workset=True)
    body = KM.kmeans_workset_epoch_step(measure, cfg.ksub, kernel=True)
    plain_body = KM.kmeans_workset_epoch_step(measure, cfg.ksub)
    ones = torch.ones(n, device=dev)
    worst, held = 0.0, []
    for s in range(cfg.m):
        sub = np.ascontiguousarray(resid[:, s * dsub:(s + 1) * dsub])
        pts = torch.from_numpy(sub).to(dev)
        init = torch.from_numpy(KM.select_random_centroids(
            sub, cfg.ksub, index.seed + 1 + s)).to(dev)
        rounds = index.build_fits[1 + s][2]
        book, e = hold_rounds(torch, f"codebook fit {s}",
                              (init, plan.init_workset(ones)), rounds,
                              (pts, ones), body, plain_body)
        worst = max(worst, e)
        q8, scale = quantize_rows(book.cpu().numpy())
        if not (np.array_equal(q8, index.params["cb_q"][s])
                and np.array_equal(scale, index.params["cb_s"][s])):
            fail(f"codebook fit {s}: its replay does not give the index's "
                 "stored books")
        plain = KM.fit_centroids(pts, ones, init, plan, measure=measure,
                                 max_iter=cfg.max_iter, workset=True,
                                 plain=True).state
        dk, dp = distortion(pts, book), distortion(pts, plain)
        held.append((rounds, round(dk, 6), round(dp, 6)))
        if not abs(dk - dp) <= 1e-3 * dp:
            fail(f"codebook fit {s}: distortion {dk} off the plain fit's {dp}")
    log(f"check kmeans_workset_update (the {cfg.m} PQ codebook fits at {n} x "
        f"{dsub}, k {cfg.ksub}): per-round max |kernel step - plain step| "
        f"{worst:.3e} (allclose rtol {KM_GATE['rtol']}, atol "
        f"{KM_GATE['atol']}); each replay equals the index's books; (rounds, "
        f"distortion kernels, plain versions) {held}")


def retrieve_bound(R, qd, cents, nprobe, block, pq):
    """The least time of a search of ``qd`` at ``nprobe``: the larger of
    the bytes it must move (the distinct probed lists, the queries, the
    centroids, the results) at 3.35 TB/s and its fp32 operations (the
    coarse product and the scan) at 67 TFLOP/s.  Returns ``(distinct
    lists, bound ms, "bytes" or "operations", bytes ms, operations
    ms)``."""
    import torch

    f4 = 4
    b, d = qd.shape
    nlist = cents.shape[0]
    lists = int(torch.unique(R.select_probes(qd, cents, nprobe)).numel())
    common = (b * d + nlist * d + 2 * b * RT_K) * f4
    ops = 2.0 * b * d * nlist
    if not pq:
        moved = lists * block * (d + 1) * f4 + common
        ops += 2.0 * b * d * nprobe * block
    else:
        m, ksub = RT_PQ["m"], RT_PQ["ksub"]
        moved = (lists * block * (m + f4) + common + ksub * d
                 + m * ksub * f4)
        ops += b * nprobe * (3.0 * ksub * d + block * m)
    ops_ms = ops / FP32_OPS_PER_S * 1e3
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    bound_by = "operations" if ops_ms >= bytes_ms else "bytes"
    return lists, max(ops_ms, bytes_ms), bound_by, bytes_ms, ops_ms


def retrieval_phases(torch, dev, card, timer):
    """Phases 12-14 (IVF retrieval); returns the two kernels' JSON
    entries."""
    from flink_ml_tpu_torch import IVFIndex, PQConfig, Table
    from flink_ml_tpu_torch.ops import kmeans as K
    from flink_ml_tpu_torch.ops import retrieve as R
    from flink_ml_tpu_torch.retrieval import exact_neighbors, recall_at_k

    X, queries = retrieval_corpus(RT_N, RT_D, RT_NQ)
    n, d = X.shape
    qd = torch.from_numpy(queries).to(dev)
    Xd = torch.from_numpy(X).to(dev)
    # float64 oracle on the card: exact_neighbors' expression, stable sort
    X64, q64 = Xd.double(), qd.double()
    d2 = ((q64 * q64).sum(1)[:, None] + (X64 * X64).sum(1)[None, :]
          - 2.0 * q64 @ X64.T)
    top_d, top_i = torch.sort(d2, dim=1, stable=True)
    exact_d = top_d[:, :RT_K + 1].cpu().numpy()
    exact = top_i[:, :RT_K].cpu().numpy()
    del d2, top_d, top_i, X64
    if not np.array_equal(exact_neighbors(queries[:16], X, np.arange(n),
                                          RT_K), exact[:16]):
        fail("the float64 oracle on the card disagrees with exact_neighbors")
    scale = (queries.astype(np.float64) ** 2).sum(1) + float(
        (X.astype(np.float64) ** 2).sum(1).max())

    def sync():
        torch.cuda.synchronize()

    def once(name, fn):
        """fn() launches kernel ``name`` exactly once and nothing else."""
        before = dict(R.LAUNCHES)
        out = fn()
        sync()
        want = dict(before, **{name: before[name] + 1})
        if R.LAUNCHES != want:
            fail(f"a search launched {R.LAUNCHES} after {before}, expected "
                 f"one {name}")
        return out

    # -- 12. main path: builds, searches, an update ------------------------
    K.reset_launch_counts()
    R.reset_launch_counts()
    sync()
    t0 = time.perf_counter()
    flat = IVFIndex.build(X, RT_NLIST, k=RT_K, seed=1, device=DEVICE)
    sync()
    t1 = time.perf_counter()
    pq = IVFIndex.build(X, RT_NLIST, PQConfig(**RT_PQ), k=RT_K, seed=1,
                        device=DEVICE)
    sync()
    build_s = {"ivf": t1 - t0, "ivfpq": time.perf_counter() - t1}
    FITTED["flat"], FITTED["pq"] = flat, pq
    km = dict(K.LAUNCHES)
    fits = flat.build_fits + pq.build_fits
    log(f"IVF builds at {n} x {d}, nlist {RT_NLIST}: block {flat.block} "
        f"(PQ {pq.block}); fits (name, plan, rounds) {fits}; KMeans "
        f"launches {km}")
    if len(fits) != 2 + RT_PQ["m"] or \
            any(plan != "kernel_ws" for _, plan, _ in fits):
        fail(f"a build fit did not plan the workset kernel: {fits}")
    if km != {"kmeans_update_stats": 0, "kmeans_update_stats_bf16": 0,
              "kmeans_assign_reduce": 0,
              "kmeans_workset_update": sum(r for _, _, r in fits)}:
        fail(f"build launches {km} do not match the fits' rounds")
    copy_s = {}
    for variant, index in (("ivf", flat), ("ivfpq", pq)):
        t0 = time.perf_counter()
        index.device_params()
        sync()
        copy_s[variant] = time.perf_counter() - t0

    found = {}
    for variant, index, name in (("ivf", flat, "retrieve_flat"),
                                 ("ivfpq", pq, "retrieve_pq")):
        (out,) = once(name, lambda: index.transform(
            Table({"query": queries})))
        nn, dist = out["neighbors"], out["distances"]
        if nn.shape != (RT_NQ, RT_K) or nn.dtype != np.int64 or \
                dist.dtype != np.float32 or not np.all(np.isfinite(dist)) \
                or nn.min() < 0 or nn.max() >= n or \
                np.any(np.diff(dist, axis=1) < 0):
            fail(f"{variant} transform: bad neighbors or distances")
        for nprobe in RT_NPROBES:
            found[variant, nprobe] = once(name, lambda: index.search(
                queries, nprobe=nprobe))[0]
    rec = {key: recall_at_k(nn, exact) for key, nn in found.items()}
    scan = {p: flat.scan_fraction(queries, p) for p in RT_NPROBES}
    log(f"recall@{RT_K} by nprobe {list(RT_NPROBES)}: IVF "
        f"{[rec['ivf', p] for p in RT_NPROBES]}, IVF-PQ "
        f"{[rec['ivfpq', p] for p in RT_NPROBES]}; scan fraction "
        f"{[round(scan[p], 6) for p in RT_NPROBES]}")
    if not (rec["ivf", RT_REF_NPROBE] >= RT_RECALL_FLOOR
            and scan[RT_REF_NPROBE] <= RT_SCAN_BUDGET):
        fail(f"flat recall@{RT_K} {rec['ivf', RT_REF_NPROBE]} at nprobe "
             f"{RT_REF_NPROBE}, scan {scan[RT_REF_NPROBE]}: below the "
             "bench's acceptance point")

    full_nn, full_d = once("retrieve_flat", lambda: flat.search(
        queries, nprobe=RT_NLIST))
    tol = RT_NEAR_TIE * scale
    near = (exact_d[:, RT_K] - exact_d[:, RT_K - 1]) <= tol
    sets_off = [r for r in range(RT_NQ) if not near[r]
                and set(full_nn[r]) != set(exact[r])]
    got64 = ((X[full_nn].astype(np.float64)
              - queries[:, None, :].astype(np.float64)) ** 2).sum(-1)
    slots_off = int(np.sum(np.abs(got64 - exact_d[:, :RT_K])
                           > tol[:, None]))
    rounding = float(np.max(np.abs(full_d - got64) / scale[:, None]))
    log(f"full probe (nprobe {RT_NLIST}) vs the float64 oracle: "
        f"f32 distances off their ids' float64 distances by at most "
        f"{rounding:.3e} (|q|^2 + max|x|^2); "
        f"{int(near.sum())} rows excluded (10th and 11th distances within "
        f"{RT_NEAR_TIE:g} (|q|^2 + max|x|^2)); {len(sets_off)} other rows "
        f"with another top-{RT_K} set; {int(np.sum(full_nn != exact))} "
        f"slots with another id, {slots_off} of them off the oracle's "
        f"distance by more than the tolerance")
    if sets_off or slots_off:
        fail("the full-probe flat search is not the exact search")

    rng = np.random.default_rng(5)
    ins = (X[rng.choice(n, RT_EDITS, replace=False)]
           + rng.normal(size=(RT_EDITS, d)) * 0.3).astype(np.float32)
    dels = rng.choice(n, RT_EDITS, replace=False)
    # the bench's publish leg updates with the drift re-anchor off
    # (bench.py:4370-4372): a fresh build's drift (its member means off
    # the balanced centroids) is already past the default 0.25
    pub = flat.with_options()
    pub.drift_threshold = None
    mode, nxt = pub.updated(inserts=ins, delete_ids=dels)
    hit, _ = once("retrieve_flat", lambda: nxt.search(ins, k=1))
    gone, _ = once("retrieve_flat", lambda: nxt.search(X[dels]))
    launches = dict(R.LAUNCHES)
    first = int(np.sum(hit[:, 0] == n + np.arange(RT_EDITS)))
    log(f"update (built index's centroid drift {flat.centroid_drift():.4f}"
        f"): {RT_EDITS} inserts, {RT_EDITS} deletes -> {mode!r}; inserted "
        f"ids found first {first}/{RT_EDITS}; deleted ids returned "
        f"{int(np.isin(gone, dels).sum())}; retrieve calls on the main "
        f"path {launches}, each 2 CUDA launches (probes, scan)")
    if mode != "delta" or not np.array_equal(
            hit[:, 0], n + np.arange(RT_EDITS)) or np.isin(gone, dels).any():
        fail("the delta update does not serve its inserts and deletes")
    if launches != {"retrieve_flat": 2 + len(RT_NPROBES) + 2,
                    "retrieve_pq": 1 + len(RT_NPROBES)}:
        fail(f"retrieve launches {launches} on the main path")

    # the PQ build's codebook fits, held to the plain versions; the same PQ
    # build on the host's CPU (the plain versions throughout) as the
    # reference of the card's IVF-PQ recall
    hold_codebook_fits(torch, dev, X, pq)
    t0 = time.perf_counter()
    cpu_pq = IVFIndex.build(X, RT_NLIST, PQConfig(**RT_PQ), k=RT_K, seed=1,
                            device="cpu")
    cpu_rec = {p: recall_at_k(cpu_pq.search(queries, nprobe=p)[0], exact)
               for p in RT_NPROBES}
    gap = max(abs(rec["ivfpq", p] - cpu_rec[p]) for p in RT_NPROBES)
    same_lists = cpu_pq.block == pq.block and np.array_equal(
        cpu_pq.params["ids"], pq.params["ids"])
    log(f"IVF-PQ reference built and searched on the host CPU through the "
        f"plain versions ({time.perf_counter() - t0:.3f} s): recall@{RT_K} "
        f"{[cpu_rec[p] for p in RT_NPROBES]} against the card's "
        f"{[rec['ivfpq', p] for p in RT_NPROBES]} (largest gap {gap:.4f}, "
        f"gate {RT_PQ_RECALL_GAP}); posting lists equal: {same_lists}; "
        f"books equal: {np.array_equal(cpu_pq.params['cb_q'], pq.params['cb_q'])}"
        f"; codes equal: "
        f"{same_lists and np.array_equal(cpu_pq.params['codes'], pq.params['codes'])}")
    if gap > RT_PQ_RECALL_GAP:
        fail("the card's IVF-PQ recall is off the CPU reference build's")
    del cpu_pq

    # -- 13. kernels vs plain versions, bit for bit ------------------------
    err = {"retrieve_flat": 0.0, "retrieve_pq": 0.0}

    def same(what, view, q):
        """``search`` through the kernel and ``search(plain=True)``."""
        name = "retrieve_pq" if view.pq else "retrieve_flat"
        nn, dist = view.search(q)
        pnn, pdist = view.search(q, plain=True)
        ok = np.array_equal(nn, pnn) and np.array_equal(
            dist.view(np.int32), pdist.view(np.int32))
        fin = np.isfinite(pdist)
        e = float(np.abs(dist[fin] - pdist[fin]).max()) if fin.any() \
            else 0.0
        err[name] = max(err[name], e)
        log(f"check {name} ({what}, b {q.shape[0]}, nprobe {view.nprobe}, "
            f"k {view.k}, block {view.block}): ids and distance bits equal "
            f"to the plain version: {ok} (tolerance 0); short slots "
            f"{int((pnn == -1).sum())}")
        if not ok or nn.shape != (q.shape[0], view.k):
            fail(f"{name} disagrees with its plain version ({what})")

    q257 = np.concatenate([queries, queries[:1] * 1.001])
    for index in (flat, pq):
        for nprobe in RT_NPROBES + (RT_NLIST,):
            same("bench index", index.with_options(nprobe=nprobe), queries)
        for nprobe in (RT_REF_NPROBE, RT_NLIST):
            view = index.with_options(nprobe=nprobe)
            same("bench index", view, queries[:1])
            same("bench index", view, q257)
    dup = np.concatenate([X[:4096], X[:4096]])
    q_dup = (dup[::64] + np.random.default_rng(6).normal(
        size=(128, d)).astype(np.float32) * 0.05).astype(np.float32)
    small = X[::n // 128]                  # 128 rows of 128 masses
    for pq_cfg in (None, PQConfig(**RT_PQ)):
        di = IVFIndex.build(dup, 16, pq_cfg, k=RT_K, seed=1, device=DEVICE)
        for nprobe in (2, 16):
            same("duplicated rows, exact ties",
                 di.with_options(nprobe=nprobe), q_dup)
        si = IVFIndex.build(small, 32, pq_cfg, k=20, seed=1, block=8,
                            device=DEVICE)
        for nprobe in (1, 2, 32):
            same("block 8, k above the probed rows",
                 si.with_options(nprobe=nprobe), queries[:64])

    # -- 14. times ---------------------------------------------------------
    x2 = (Xd * Xd).sum(1)[None, :]

    def brute():
        return torch.topk(torch.addmm(x2, qd, Xd.T, alpha=-2.0), RT_K,
                          dim=1, largest=False).indices

    lib_ms = timer.ms(brute)
    kernel_ms = {}
    for name, index in (("retrieve_flat", flat), ("retrieve_pq", pq)):
        p = index.device_params()
        blk = index.block
        for nprobe in RT_TIMED_NPROBES + (RT_NLIST,):
            view = index.with_options(nprobe=nprobe)
            ms = timer.ms(lambda: view.search_tensors(qd))
            # what search(plain=True) runs between its copies
            plain_ms = timer.ms(lambda: view._scan(
                qd, R.retrieve_flat_plain, R.retrieve_pq_plain),
                reps=5, warm=1)
            lists, bound_ms, bound_by, bytes_ms, ops_ms = retrieve_bound(
                R, qd, p["centroids"], nprobe, blk, index.pq is not None)
            kernel_ms[name, nprobe] = (ms, plain_ms, bound_ms, bound_by)
            log(f"time {name} (b {RT_NQ}, nprobe {nprobe}, {lists} distinct "
                f"lists of {blk} rows): kernel {ms:.4f} ms (2 CUDA "
                f"launches: probes, scan), plain "
                f"{plain_ms:.4f} ms, brute-force addmm + topk over all {n} "
                f"rows (exact search) {lib_ms:.4f} ms, bound {bound_ms:.4f} "
                f"ms ({bound_by}; bytes {bytes_ms:.4f}, operations "
                f"{ops_ms:.4f}) [{card}]")

    def qps(fn):
        fn()
        sync()
        t0 = time.perf_counter()
        for _ in range(RT_ROUNDS):
            out = fn()
        sync()
        return RT_NQ * RT_ROUNDS / (time.perf_counter() - t0), out

    flat_qps, flat_ids = qps(brute)
    flat_rec = recall_at_k(flat_ids.cpu().numpy(), exact)
    log(f"frontier: flat brute force {flat_qps:.1f} QPS, recall@{RT_K} "
        f"{flat_rec:.4f}, scan 1.0 [{card}]")
    best = None
    for variant, index in (("ivf", flat), ("ivfpq", pq)):
        for nprobe in RT_NPROBES:
            view = index.with_options(nprobe=nprobe)
            rate, out = qps(lambda: view.search_tensors(qd))
            r = recall_at_k(out[0].cpu().numpy(), exact)
            log(f"frontier: {variant} nprobe {nprobe}: {rate:.1f} QPS, "
                f"recall@{RT_K} {r:.4f}, scan fraction {scan[nprobe]:.6f} "
                f"[{card}]")
            if variant == "ivf" and r >= RT_RECALL_FLOOR and \
                    scan[nprobe] <= RT_SCAN_BUDGET and \
                    (best is None or rate > best[0]):
                best = (rate, nprobe)
    if best is None:
        fail("no IVF point reaches the acceptance recall within the scan "
             "budget")
    log(f"retrieval_ivf_qps_ratio (fastest IVF point with recall@{RT_K} >= "
        f"{RT_RECALL_FLOOR} and scan <= {RT_SCAN_BUDGET}, nprobe "
        f"{best[1]}, over flat brute force): {best[0] / flat_qps:.3f} "
        f"[{card}]")
    for variant, index in (("ivf", flat), ("ivfpq", pq)):
        log(f"build {variant}: {build_s[variant]:.3f} s wall; parts "
            + ", ".join(f"{k} {v:.3f}" for k, v in index.build_times.items())
            + f"; device copy {copy_s[variant]:.3f} s [{card}]")

    entries = []
    for name in ("retrieve_flat", "retrieve_pq"):
        ms, plain_ms, bound_ms, bound_by = kernel_ms[name, RT_REF_NPROBE]
        entries.append({
            "name": name, "route": "cuda", "source": RT_SOURCE,
            "replaces": RT_REPLACES[name], "launches": launches[name],
            "max_abs_err": err[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_ms,
        })
    return entries


def pair_encoding(dense, cat):
    """The generic (indices, values) encoding of Criteo-shaped rows
    (``bench.py:100-115`` ``_as_sparse_pair``): indices 0-12 carry the 13
    dense values, the 26 hashed slots carry 1.0 (nnz 39)."""
    n = dense.shape[0]
    idx = np.concatenate([np.broadcast_to(
        np.arange(N_DENSE, dtype=np.int32), (n, N_DENSE)), cat], axis=1)
    vals = np.concatenate([dense, np.ones((n, N_CAT), np.float32)], axis=1)
    return idx, vals


def allclose_fit(what, got, want):
    """Weights of two fits within the bench's one-epoch tolerance
    (``bench.py:266, 316``): allclose rtol 1e-3, atol 1e-4."""
    diff = float(np.max(np.abs(got - want)))
    log(f"{what}: max |dw| = {diff:.3e} (allclose rtol 1e-3, atol 1e-4)")
    if not np.allclose(got, want, rtol=1e-3, atol=1e-4):
        fail(f"{what}: the weights disagree")


def sparse_phases(torch, dev, card, timer, dense, cat, y, mixed_model):
    """Phases 16-17: the generic sparse (indices, values) fit through the
    value variants of the ELL kernels.  Returns, for each of the three
    ELL kernels, its value variant's entry (launches, error, times,
    bound) for the kernel JSON line."""
    import torch.nn.functional as F

    from flink_ml_tpu_torch import LogisticRegression, Table
    from flink_ml_tpu_torch.models import BinaryClassificationEvaluator
    from flink_ml_tpu_torch.models.common import sgd as S
    from flink_ml_tpu_torch.models.common.losses import LOSSES
    from flink_ml_tpu_torch.ops import ell_scatter as E

    # -- 16. sparse LR at the Criteo width ---------------------------------
    idx, vals = pair_encoding(dense, cat)
    steps = ROWS // BATCH
    table = Table({"features_indices": idx, "features_values": vals,
                   "label": y})

    def estimator(epochs):
        return (LogisticRegression(device=DEVICE).set_num_features(D_MAIN)
                .set_global_batch_size(BATCH).set_max_iter(epochs)
                .set_tol(0))

    E.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = estimator(EPOCHS).fit(table)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = dict(E.LAUNCHES)
    losses = model.loss_log
    log(f"sparse path (pair encoding, nnz {idx.shape[1]}): fit {fit_s:.3f} "
        f"s, loss log {losses}, plan {model.planned_impl}, launches "
        f"{launches} [{card}]")
    if model.planned_impl != "ell":
        fail(f"the sparse fit planned {model.planned_impl!r}, expected 'ell'")
    if len(losses) != EPOCHS or not all(np.isfinite(losses)) or \
            not all(b < a for a, b in zip(losses, losses[1:])):
        fail(f"sparse loss log {losses}")
    for name in ("ell_margin", "ell_scatter_apply_fused"):
        if launches[name] != steps * EPOCHS:
            fail(f"{name} launched {launches[name]} times in the sparse "
                 f"fit, expected {steps * EPOCHS}")
    if launches["ell_scatter_apply"] != 0:
        fail("the pair kernel ran on a grid of 8192 rows")
    coef = model.get_model_data()[0]["coefficients"][0]
    cfg = estimator(1)._sgd_config()
    one_k, _ = S.sgd_fit_sparse(LOSSES["logistic"], idx, vals, y, None,
                                D_MAIN, cfg, device=dev)
    one_p, _ = S.sgd_fit_sparse(LOSSES["logistic"], idx, vals, y, None,
                                D_MAIN, cfg, device=dev, plain=True)
    allclose_fit("sparse, one epoch, kernels vs plain versions on the card",
                 one_k.coefficients, one_p.coefficients)
    allclose_fit(f"sparse fit vs the mixed fit of the same rows ({EPOCHS} "
                 f"epochs: same algebra, another f32 order)", coef,
                 mixed_model.get_model_data()[0]["coefficients"][0])

    # the same fit from a layout built on the card (ell_layout_device,
    # the bench's caps: bench.py:297-301)
    perm = np.random.default_rng(0).permutation(ROWS)

    def put(a):
        return torch.from_numpy(S.prepare_epoch_tensor(a, perm, steps,
                                                       BATCH)).to(dev)

    idx_t, vals_t = put(idx), put(vals)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lay = E.ell_layout_device(idx_t, D_MAIN, ovf_cap=1 << 13, heavy_cap=24,
                              values=vals_t).assert_capacities(
                              ).trim_overflow()
    torch.cuda.synchronize()
    layout_ms = (time.perf_counter() - t0) * 1e3
    route_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        route = S._StepRouting(lay, BATCH, steps)
        route[0]
        torch.cuda.synchronize()
        route_ms.append((time.perf_counter() - t0) * 1e3)
    log(f"ell_layout_device ({steps} steps, heavy_cap 24, ovf_cap 2^13): "
        f"{layout_ms:.3f} ms (first call); need_heavy "
        f"{lay.need_heavy.tolist()}, need_ovf {lay.need_ovf.tolist()}; "
        f"sample routing with values ({steps} steps, "
        f"{tuple(route._route.shape)}): {route_ms[0]:.3f} ms first, "
        f"{min(route_ms[1:]):.3f} ms again [{card}]")
    epoch_args = (route, lay.src, lay.pos, lay.mask, lay.val, lay.ovf_idx,
                  lay.ovf_src, lay.ovf_val, lay.heavy_idx, lay.heavy_cnt,
                  put(y.astype(np.float32)), put(np.ones(ROWS, np.float32)))
    run_cfg = dataclasses.replace(cfg, max_epochs=EPOCHS)
    params, dev_log = S._run_minibatch_epochs(
        S._sparse_update_ell(LOSSES["logistic"], run_cfg), epoch_args,
        S._zero_params(D_MAIN, dev), steps, run_cfg)
    allclose_fit("sparse fit from ell_layout_device vs the estimator's fit",
                 params["w"].cpu().numpy(), coef)

    t_dense, t_cat, t_y = criteo_rows(4096, D_MAIN, seed=9)
    t_idx, t_vals = pair_encoding(t_dense, t_cat)
    (out,) = model.transform(Table({"features_indices": t_idx,
                                    "features_values": t_vals}))
    icpt = float(model.get_model_data()[0]["intercept"][0])
    margin = (t_vals.astype(np.float64) * coef[t_idx]).sum(1) + icpt
    perr = float(np.max(np.abs(out["rawPrediction"]
                               - 1.0 / (1.0 + np.exp(-margin)))))
    scored = Table({"label": t_y, "rawPrediction": out["rawPrediction"]})
    auc = {d: float(BinaryClassificationEvaluator(device=d).transform(
        scored)[0]["areaUnderROC"][0]) for d in (DEVICE, "cpu")}
    log(f"sparse transform: 4096 rows, max |p - numpy f64 p| = {perr:.3e} "
        f"(tolerance 1e-5); areaUnderROC card {auc[DEVICE]!r}, CPU "
        f"{auc['cpu']!r} (tolerance 1e-12)")
    if out["rawPrediction"].shape != (4096,) or perr > 1e-5:
        fail("sparse transform disagrees with numpy scoring")
    if abs(auc[DEVICE] - auc["cpu"]) > 1e-12 or not auc[DEVICE] > 0.99:
        fail("areaUnderROC differs between the card and the CPU, or the "
             "fit did not learn the marker")

    # value variants at this shape: step 0 of the card-built layout
    w = torch.from_numpy(np.random.default_rng(2).normal(
        size=D_MAIN).astype(np.float32)).to(dev)
    r_ext = S._extended_r(torch.from_numpy(np.random.default_rng(3).normal(
        size=BATCH).astype(np.float32) / BATCH).to(dev))
    m_len = S._ext_len(BATCH)
    lr = 0.5
    src, pos, mask, val = lay.src[0], lay.pos[0], lay.mask[0], lay.val[0]
    route_w, route_val = route[0]
    nnz = route_w.shape[0]
    err = {}
    for name, got, want in (
            ("ell_margin",
             E.ell_margin(w, route_w, m_len=m_len, route_val=route_val),
             E.ell_margin_plain(w, route_w, m_len, route_val=route_val)),
            ("ell_scatter_apply_fused",
             E.ell_scatter_apply_fused(w, r_ext, src, pos, mask, lr=lr,
                                       val=val),
             E.ell_scatter_apply_fused_plain(w, r_ext, src, pos, mask, lr=lr,
                                             val=val))):
        torch.cuda.synchronize()
        err[name] = float((got - want).abs().max())
        log(f"check {name} (values, the sparse fit's step 0): max |kernel - "
            f"plain| = {err[name]:.3e} (tolerance 0)")
        if err[name] != 0.0:
            fail(f"{name} with values disagrees with its plain version")
    bag_idx = torch.where(route_w >= 0, route_w, D_MAIN).t().long() \
        .contiguous()
    bag_val = route_val.t().contiguous()
    w_bag = torch.cat([w, torch.zeros(1, device=dev)])[:, None]
    bag = F.embedding_bag(bag_idx, w_bag, mode="sum",
                          per_sample_weights=bag_val)[:, 0]
    if not torch.allclose(bag, E.ell_margin(w, route_w, m_len=m_len,
                                            route_val=route_val)[:BATCH],
                          rtol=1e-5, atol=1e-4):
        fail("embedding_bag with per-sample weights is not the margin")
    lanes, _ = E._slot_lanes(pos, mask)
    kept = src < BATCH
    slot_w = (torch.arange(D_MAIN // 128, device=dev)[:, None] * 128
              + lanes)[kept]
    slot_src, slot_val = src[kept].long(), val[kept]
    w_scratch = w.clone()
    w_touched = int(torch.unique(route_w[route_w >= 0]).numel())
    grid = D_MAIN
    runs = {
        "ell_margin": (
            lambda: E.ell_margin(w, route_w, m_len=m_len,
                                 route_val=route_val),
            lambda: E.ell_margin_plain(w, route_w, m_len,
                                       route_val=route_val),
            lambda: F.embedding_bag(bag_idx, w_bag, mode="sum",
                                    per_sample_weights=bag_val),
            # route_w and route_val, the distinct weights read; the table
            # written
            nnz * BATCH * 8 + w_touched * 4 + m_len * 4,
            "embedding_bag(per_sample_weights=route_val)"),
        "ell_scatter_apply_fused": (
            lambda: E.ell_scatter_apply_fused(w, r_ext, src, pos, mask,
                                              lr=lr, val=val),
            lambda: E.ell_scatter_apply_fused_plain(w, r_ext, src, pos, mask,
                                                    lr=lr, val=val),
            lambda: w_scratch.index_add_(0, slot_w,
                                         r_ext[slot_src] * slot_val,
                                         alpha=-lr),
            # src, pos, mask, val, w and r_ext read; the new w written
            grid * 24 + r_ext.numel() * 4,
            "r_ext gather x val + index_add_"),
    }
    variants = {}
    for name, (kern, plain, library, moved, lib_name) in runs.items():
        ms, plain_ms, lib_ms = (timer.ms(kern), timer.ms(plain),
                                timer.ms(library))
        bound_ms = moved / HBM_BYTES_PER_S * 1e3
        log(f"time {name} (values, sparse step 0: routing {nnz} x {BATCH}, "
            f"{w_touched} distinct weights): kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, {lib_name} {lib_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms (bytes) [{card}]")
        variants[name] = {
            "launches": launches[name], "max_abs_err": err[name], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": lib_ms}

    rates = {}
    for label, plain in (("kernels", False), ("plain", True)):
        update = S._sparse_update_ell(LOSSES["logistic"], run_cfg,
                                      plain=plain)
        S._run_minibatch_epochs(update, epoch_args,
                                S._zero_params(D_MAIN, dev), steps, run_cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        S._run_minibatch_epochs(update, epoch_args,
                                S._zero_params(D_MAIN, dev), steps, run_cfg)
        torch.cuda.synchronize()
        rates[label] = EPOCHS / (time.perf_counter() - t0)
    log(f"sparse epochs/s at {D_MAIN} features, batch {BATCH}, nnz "
        f"{idx.shape[1]}, {steps} steps/epoch, device-resident layout: "
        f"kernels "
        f"{rates['kernels']:.3f}, plain versions {rates['plain']:.3f}; fit() "
        f"wall {fit_s:.3f} s for {EPOCHS} epochs incl. host layout build "
        f"[{card}]")
    del lay, route, epoch_args, idx_t, vals_t

    # -- 17. small sparse fit on the pair kernel's grid --------------------
    p_dense, p_cat, p_y = criteo_rows(PAIR_ROWS, D_PAIR, seed=4)
    p_idx, _ = pair_encoding(p_dense, p_cat)
    p_vals = np.random.default_rng(7).normal(size=p_idx.shape).astype(
        np.float32)
    p_est = (LogisticRegression(device=DEVICE).set_num_features(D_PAIR)
             .set_global_batch_size(PAIR_BATCH).set_max_iter(2).set_tol(0))
    E.reset_launch_counts()
    p_model = p_est.fit(Table({"features_indices": p_idx,
                               "features_values": p_vals, "label": p_y}))
    torch.cuda.synchronize()
    p_launches = dict(E.LAUNCHES)
    p_steps = PAIR_ROWS // PAIR_BATCH * 2
    log(f"sparse pair path ({D_PAIR // 128} table rows, N(0,1) values): "
        f"plan {p_model.planned_impl}, loss log {p_model.loss_log}, "
        f"launches {p_launches}")
    if p_launches != {"ell_margin": p_steps, "ell_scatter_apply": p_steps,
                      "ell_scatter_apply_fused": 0}:
        fail("the pair kernel did not carry the 1001-row sparse fit")
    p_plain, _ = S.sgd_fit_sparse(LOSSES["logistic"], p_idx, p_vals, p_y,
                                  None, D_PAIR, p_est._sgd_config(),
                                  device=dev, plain=True)
    allclose_fit("sparse pair path, kernels vs plain versions on the card",
                 p_model.get_model_data()[0]["coefficients"][0],
                 p_plain.coefficients)
    p_perm = np.random.default_rng(0).permutation(PAIR_ROWS)
    p_lay = E.ell_layout(
        S.prepare_epoch_tensor(p_idx, p_perm, PAIR_ROWS // PAIR_BATCH,
                               PAIR_BATCH)[:1], D_PAIR,
        values=S.prepare_epoch_tensor(p_vals, p_perm,
                                      PAIR_ROWS // PAIR_BATCH,
                                      PAIR_BATCH)[:1]).to(dev)
    rows_p = D_PAIR // 128
    w_p = torch.from_numpy(np.random.default_rng(8).normal(
        size=D_PAIR).astype(np.float32)).to(dev)
    r_p = S._extended_r(torch.from_numpy(np.random.default_rng(9).normal(
        size=PAIR_BATCH).astype(np.float32)).to(dev))
    src_p, pos_p, mask_p = p_lay.src[0], p_lay.pos[0], p_lay.mask[0]
    upd = (-lr) * (p_lay.val[0] * E.gather_weights(r_p, src_p))
    got = E.ell_scatter_apply(w_p, upd, pos_p, mask_p)
    torch.cuda.synchronize()
    err_p = float((got - E.ell_scatter_apply_plain(w_p, upd, pos_p, mask_p)
                   ).abs().max())
    lanes_p, _ = E._slot_lanes(pos_p, mask_p)
    kept_p = src_p < PAIR_BATCH
    slot_wp = (torch.arange(rows_p, device=dev)[:, None] * 128
               + lanes_p)[kept_p]
    slot_up = upd[kept_p]
    wp_scratch = w_p.clone()
    ms = timer.ms(lambda: E.ell_scatter_apply(w_p, upd, pos_p, mask_p))
    plain_ms = timer.ms(lambda: E.ell_scatter_apply_plain(w_p, upd, pos_p,
                                                          mask_p))
    lib_ms = timer.ms(lambda: wp_scratch.index_add_(0, slot_wp, slot_up))
    bound_ms = rows_p * 128 * 20 / HBM_BYTES_PER_S * 1e3
    log(f"check ell_scatter_apply (values, the sparse pair fit's step 0): "
        f"max |kernel - plain| = {err_p:.3e} (tolerance 0)")
    log(f"time ell_scatter_apply (values, {rows_p} rows): kernel {ms:.4f} "
        f"ms, plain {plain_ms:.4f} ms, index_add_ {lib_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms (bytes) [{card}]")
    if err_p != 0.0:
        fail("ell_scatter_apply with values disagrees with its plain version")
    variants["ell_scatter_apply"] = {
        "launches": p_launches["ell_scatter_apply"], "max_abs_err": err_p,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "bytes", "library_ms": lib_ms}
    return variants


def dense_rows(rows, d, seed=23):
    """The pipeline bench's dense table (``bench.py:1991-1994``): (rows,
    d) N(0,1) f32 features from numpy ``seed``, the binary label
    ``x0 > 0``; then a regression target ``x @ beta + 0.1 noise`` and a
    10-class label ``argmax(x[:, :10])`` drawn from the same generator.
    Callers split held-out rows off the end."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(rows, d)).astype(np.float32)
    y_bin = (X[:, 0] > 0).astype(np.float64)
    beta = rng.normal(size=d) / 8.0
    y_reg = X.astype(np.float64) @ beta + 0.1 * rng.normal(size=rows)
    y_cls = np.argmax(X[:, :DN_CLASSES], axis=1)
    return X, y_bin, y_reg, y_cls


def dense_phase(torch, dev, card):
    """Phase 18: the dense fits at the pipeline bench's width, each on the
    card and on the CPU."""
    import flink_ml_tpu_torch as T
    from flink_ml_tpu_torch.models.common import sgd as S
    from flink_ml_tpu_torch.models.evaluation import (
        MulticlassClassificationEvaluator, RegressionEvaluator)

    batch = S.resolve_global_batch_size(S.SGDConfig(), DN_ROWS)
    X, y_bin, y_reg, y_cls = dense_rows(DN_ROWS + DN_HELD, DN_DIM)
    X, Xt = X[:DN_ROWS], X[DN_ROWS:]
    x64 = Xt.astype(np.float64)
    for name, yy in (("LinearRegression", y_reg), ("LinearSVC", y_bin),
                     ("LogisticRegression", y_bin),
                     ("SoftmaxRegression", y_cls)):
        y, yt = yy[:DN_ROWS], yy[DN_ROWS:]
        models, secs = {}, {}
        for where in (DEVICE, "cpu"):
            est = getattr(T, name)(device=where).set_max_iter(
                DN_EPOCHS).set_tol(0)
            if where == DEVICE:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            models[where] = est.fit(T.Table({"features": X, "label": y}))
            if where == DEVICE:
                torch.cuda.synchronize()
            secs[where] = time.perf_counter() - t0
        card_m, cpu_m = models[DEVICE], models["cpu"]
        losses = card_m.loss_log
        data = card_m.get_model_data()[0]
        (out,) = card_m.transform(T.Table({"features": Xt, "label": yt}))
        (cpu_out,) = cpu_m.transform(T.Table({"features": Xt, "label": yt}))
        if name == "SoftmaxRegression":
            scores = x64 @ data["coefficients"][0] + data["intercepts"][0]
            scores = np.exp(scores - scores.max(1, keepdims=True))
            want = scores / scores.sum(1, keepdims=True)
            got = out["rawPrediction"]
            ev = MulticlassClassificationEvaluator().set_metrics(
                "accuracy", "weightedFMeasure")
            metric_tol = dict(rtol=0.0, atol=2e-3)
        else:
            margin = x64 @ data["coefficients"][0] + data["intercept"][0]
            want = (1.0 / (1.0 + np.exp(-margin))
                    if name == "LogisticRegression" else margin)
            got = out["rawPrediction"]
            ev = (RegressionEvaluator().set_metrics("rmse", "r2")
                  if name == "LinearRegression" else
                  MulticlassClassificationEvaluator().set_metrics(
                      "accuracy"))
            metric_tol = dict(rtol=1e-3, atol=2e-3)
        metrics = {w: {k: float(v[0]) for k, v in ev.transform(
            o)[0].to_dict().items()} for w, o in ((DEVICE, out),
                                                  ("cpu", cpu_out))}
        key = "coefficients"
        dw = float(np.max(np.abs(data[key] - cpu_m.get_model_data()[0][key])))
        perr = float(np.max(np.abs(got - want)))
        log(f"dense {name} ({DN_ROWS} x {DN_DIM}, {DN_EPOCHS} epochs, "
            f"auto batch {batch}): loss log "
            f"{losses}; card vs CPU fit max |dw| {dw:.3e} (allclose rtol "
            f"1e-3, atol 1e-4); transform max |score - numpy f64| "
            f"{perr:.3e} (rtol 1e-5, atol 1e-5); metrics card "
            f"{metrics[DEVICE]}, CPU {metrics['cpu']} ({metric_tol}); "
            f"epochs/s card {DN_EPOCHS / secs[DEVICE]:.3f}, CPU "
            f"{DN_EPOCHS / secs['cpu']:.3f} (fit() wall) [{card}]")
        if len(losses) != DN_EPOCHS or not losses[1] < losses[0]:
            fail(f"dense {name}: loss log {losses}")
        if not np.allclose(data[key], cpu_m.get_model_data()[0][key],
                           rtol=1e-3, atol=1e-4):
            fail(f"dense {name}: the card's fit is off the CPU's")
        if not np.allclose(got, want, rtol=1e-5, atol=1e-5):
            fail(f"dense {name}: transform disagrees with numpy scoring")
        for k, v in metrics[DEVICE].items():
            if not np.isclose(v, metrics["cpu"][k], **metric_tol):
                fail(f"dense {name}: {k} of the card's fit is off the "
                     "CPU fit's")


def write_synth_tsv(path, rows, seed):
    """Criteo-format lines as the JAX package's bench writes them
    (``bench.py:611`` ``_synth_tsv``): label ``i & 1``, 13 integers in
    [0, 1000), 26 8-hex-digit tokens, from numpy ``seed``."""
    rng = np.random.default_rng(seed)
    ints = rng.integers(0, 1000, size=(rows, 13))
    toks = rng.integers(0, 1 << 32, size=(rows, 26))
    with open(path, "wb") as f:
        f.write(b"".join(
            b"%d\t%s\t%s\n" % (
                i & 1, b"\t".join(b"%d" % v for v in ints[i]),
                b"\t".join(b"%08x" % v for v in toks[i]))
            for i in range(rows)))


def criteo_phase(torch, dev, card):
    """Phase 19: a Criteo TSV through ``CriteoTSVReader`` into a Table and
    a mixed LogisticRegression fit through the ELL kernels."""
    import tempfile

    from flink_ml_tpu_torch import LogisticRegression, Table
    from flink_ml_tpu_torch.data import criteo
    from flink_ml_tpu_torch.ops import ell_scatter as E

    parser = criteo.parser_name()
    log(f"Criteo parser: {parser}")
    if parser != "native":
        fail("the native Criteo parser (native/criteo.cpp) did not load")
    hash_space = D_MAIN - criteo.N_DENSE
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "day_0.tsv")
        write_synth_tsv(path, CT_ROWS, seed=611)
        size = os.path.getsize(path)
        reader = criteo.CriteoTSVReader(path, batch_rows=BATCH,
                                        hash_space=hash_space)
        t0 = time.perf_counter()
        batches = list(reader)
        parse_s = time.perf_counter() - t0
        with open(path, "rb") as f:
            whole = criteo.parse_chunk(f.read(), CT_ROWS + 1, hash_space)
    cols = {k: np.concatenate([b[k] for b in batches])
            for k in batches[0]}
    log(f"CriteoTSVReader: {CT_ROWS} rows ({size} bytes) in "
        f"{len(batches)} batches of {BATCH}, {reader.workers} parse "
        f"workers: {CT_ROWS / parse_s:.1f} rows/s ({parse_s:.3f} s, host "
        f"CPU) [{card}]")
    if [len(b["label"]) for b in batches] != [BATCH] * (CT_ROWS // BATCH):
        fail("the reader's batches are not whole batches")
    for key, want in zip(("features_dense", "features_indices", "label"),
                         whole[:3]):
        if not np.array_equal(cols[key], want):
            fail(f"the reader's {key} differ from parse_chunk of the file")
    if reader.num_features != D_MAIN:
        fail(f"num_features {reader.num_features}")
    est = (LogisticRegression(device=DEVICE).set_num_features(D_MAIN)
           .set_global_batch_size(BATCH).set_max_iter(1).set_tol(0))
    # the integer counts log-transformed before training (the usual
    # Criteo preprocessing); the hashed slots as the reader gives them
    cols["features_dense"] = np.log1p(cols["features_dense"])
    E.reset_launch_counts()
    model = est.fit(Table(cols))
    torch.cuda.synchronize()
    launches = dict(E.LAUNCHES)
    steps = CT_ROWS // BATCH
    log(f"Criteo TSV -> Table -> LogisticRegression: plan "
        f"{model.planned_impl}, loss log {model.loss_log}, launches "
        f"{launches}")
    if model.planned_impl != "ell" or not np.all(np.isfinite(
            model.loss_log)):
        fail("the Criteo fit did not plan 'ell' or its loss is not finite")
    for name in ("ell_margin", "ell_scatter_apply_fused"):
        if launches[name] != steps:
            fail(f"{name} launched {launches[name]} times in the Criteo "
                 f"fit, expected {steps}")


def routing_chunk_phase(torch, dev, card):
    """Phase 15: the ELL plan where the sample routing outgrows its budget.
    At 2^17 features, 26 slots and 2^24 rows (auto batch) the plan is the
    JAX package's "ell"; a LogisticRegression fit at 2^17 features (2^17
    Criteo-shaped rows, numpy seed 5, batch 2^14, 2 epochs) with the
    routing budget cut to 3 steps builds its routing per chunk in every
    epoch and launches the margin and fused-scatter kernels every step;
    each step's margin through the chunks equals the margin through the
    whole routing bit for bit, and the fit agrees with the same fit with
    the whole routing."""
    from flink_ml_tpu_torch import LogisticRegression, Table
    from flink_ml_tpu_torch.models.common import sgd as S
    from flink_ml_tpu_torch.ops import ell_scatter as E

    batch = S.resolve_global_batch_size(S.SGDConfig(), C1_ROWS, C1_FEATURES)
    steps = -(-C1_ROWS // batch)
    plan = S.plan_mixed_impl(C1_FEATURES, steps)
    chunk = S.routing_chunk_steps(steps, batch * N_CAT)
    route_gb = steps * batch * N_CAT * 4 / 2**30
    log(f"plan at {C1_FEATURES} features, {N_CAT} slots, {C1_ROWS} rows: "
        f"batch {batch}, {steps} steps, plan {plan!r}; whole routing "
        f"{route_gb:.3f} GiB, built {chunk} steps at a time")
    if plan != "ell" or not chunk < steps:
        fail(f"plan {plan!r}, routing chunk {chunk} of {steps} steps")

    dense, cat, y = criteo_rows(C1_FIT_ROWS, C1_FEATURES, seed=5)
    table = Table({"features_dense": dense, "features_indices": cat,
                   "label": y})
    fit_steps = C1_FIT_ROWS // C1_FIT_BATCH
    made = []

    class Counted(S._StepRouting):
        def __init__(self, *a):
            super().__init__(*a)
            made.append(self)

    def fit():
        return (LogisticRegression(device=DEVICE)
                .set_num_features(C1_FEATURES)
                .set_global_batch_size(C1_FIT_BATCH)
                .set_max_iter(C1_EPOCHS).set_tol(0).fit(table))

    real_routing, real_budget = S._StepRouting, S._ROUTE_BUDGET_BYTES
    S._StepRouting = Counted
    try:
        whole = fit()
        S._ROUTE_BUDGET_BYTES = C1_CHUNK * C1_FIT_BATCH * N_CAT * 4
        E.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = fit()
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = dict(E.LAUNCHES)
    finally:
        S._StepRouting, S._ROUTE_BUDGET_BYTES = real_routing, real_budget
    builds = [m.builds for m in made]
    want_builds = C1_EPOCHS * -(-fit_steps // C1_CHUNK)
    log(f"routing-chunk fit ({C1_FIT_ROWS} rows, batch {C1_FIT_BATCH}, "
        f"{C1_EPOCHS} epochs, {C1_CHUNK} steps a chunk): plan "
        f"{model.planned_impl}, {fit_s:.3f} s, routing builds (whole, "
        f"chunked) {builds}, launches {launches}, loss log {model.loss_log} "
        f"[{card}]")
    if model.planned_impl != "ell" or builds != [1, want_builds]:
        fail(f"the chunked fit planned {model.planned_impl!r} with routing "
             f"builds {builds}, expected 'ell' and [1, {want_builds}]")
    for name in ("ell_margin", "ell_scatter_apply_fused"):
        if launches[name] != fit_steps * C1_EPOCHS:
            fail(f"{name} launched {launches[name]} times in the chunked "
                 f"fit, expected {fit_steps * C1_EPOCHS}")
    # each step's margin through the chunked routing equals the margin
    # through the whole routing bit for bit
    perm = np.random.default_rng(0).permutation(C1_FIT_ROWS)
    lay = E.ell_layout(S.prepare_epoch_tensor(cat, perm, fit_steps,
                                              C1_FIT_BATCH),
                       C1_FEATURES).to(dev)
    route_all, _ = E.sample_routing(lay.src, lay.pos, lay.mask,
                                    C1_FIT_BATCH)
    chunked = S._StepRouting(lay, C1_FIT_BATCH, C1_CHUNK)
    w = torch.from_numpy(np.random.default_rng(6).normal(
        size=C1_FEATURES).astype(np.float32)).to(dev)
    m_len = S._ext_len(C1_FIT_BATCH)
    same_margin = all(torch.equal(
        E.ell_margin(w, route_all[i], m_len=m_len),
        E.ell_margin(w, chunked[i], m_len=m_len)) for i in range(fit_steps))
    # what rebuilding the chunks costs a step: every chunk built once, as
    # an epoch of the chunked fit does
    rebuild = []
    for _ in range(3):
        fresh = S._StepRouting(lay, C1_FIT_BATCH, C1_CHUNK)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(0, fit_steps, C1_CHUNK):
            fresh[i]
        torch.cuda.synchronize()
        rebuild.append((time.perf_counter() - t0) / fit_steps)
    log(f"routing rebuild per step (chunks of {C1_CHUNK} steps, batch "
        f"{C1_FIT_BATCH}, {C1_FEATURES} features): {rebuild[0] * 1e3:.3f} ms "
        f"first, {min(rebuild[1:]) * 1e3:.3f} ms again [{card}]")
    # every scatter-add of the fits sums in a fixed order (C4): the
    # chunked routing gives the whole routing's fit bit for bit
    a = whole.get_model_data()[0]["coefficients"][0]
    b = model.get_model_data()[0]["coefficients"][0]
    diff = float(np.max(np.abs(a - b)))
    log(f"routing-chunk fit vs the whole-routing fit: max |dw| {diff:.3e} "
        f"(tolerance 0: bit for bit {np.array_equal(a, b)}); every step's "
        f"margin through the chunks bit for bit the whole routing's: "
        f"{same_margin}")
    if not same_margin or not np.array_equal(a, b):
        fail("the chunked routing changed the fit")

# The iteration runtime on the card (phase 20): the reference's bounded
# all-round anchor (BoundedAllRoundStreamIterationITCase.java:96-101)
IT_SOURCES, IT_RECORDS, IT_ROUNDS = 4, 1000, 5
IT_ANCHOR = 1998000.0
# The streamed LR fit (phase 21): 2^20 Criteo-shaped rows through the data
# cache, 32 steps of 2^15 an epoch, 2 epochs (record, then replay), W = 8
ST_ROWS = 1 << 20
ST_EPOCHS = 2
ST_W = 8
ST_WORKERS = 4
ST_CRASH_PULL = 13          # the reader dies fetching batch 13
ST_CUT_EVERY = 8
ST_DIR = os.path.join(HERE, "scratch_stream")


def iteration_phase(torch, dev, card):
    """Phase 20: ``iterate`` on the card.  The 4 x 1000 anchor sums to
    exactly 1,998,000 in every round, fused and hosted; the same under a
    crash injected at ``iterate.epoch`` 3 and healed by ``resilient_fit``
    (the final state equal to the uninterrupted run's); W = 4 equals W = 1
    bit for bit; listeners and ``per_round`` fire as on the CPU."""
    import shutil
    import tempfile

    from flink_ml_tpu_torch.iteration import (CheckpointConfig, FnListener,
                                              IterationBodyResult,
                                              IterationConfig, iterate)
    from flink_ml_tpu_torch.robustness import (FaultPlan, RecoveryReport,
                                               RetryPolicy, resilient_fit)

    t0 = time.perf_counter()
    records = torch.arange(IT_RECORDS, dtype=torch.float32,
                           device=dev).repeat(IT_SOURCES)

    def anchor(state, epoch, d):
        s = d.sum()
        return IterationBodyResult(
            {"rounds": state["rounds"] + 1, "acc": state["acc"] * 0.5 + s},
            outputs=s)

    def init():
        return {"rounds": torch.zeros((), dtype=torch.int64, device=dev),
                "acc": torch.zeros((), device=dev)}

    runs = {}
    for mode in ("fused", "hosted"):
        res = iterate(anchor, init(), records, max_epochs=IT_ROUNDS,
                      config=IterationConfig(mode=mode))
        sums = [float(o) for o in res.outputs]
        runs[mode] = res
        log(f"iterate {mode} on {dev}: per-round sums {sums}")
        if sums != [IT_ANCHOR] * IT_ROUNDS or res.num_epochs != IT_ROUNDS:
            fail(f"the {mode} anchor does not sum to {IT_ANCHOR} a round")
    if not torch.equal(runs["fused"].state["acc"],
                       runs["hosted"].state["acc"]):
        fail("fused and hosted anchor states differ")

    seen = []
    ckdir = tempfile.mkdtemp(prefix="it_ckpt_")
    try:
        def run(checkpoint=None, resume=False):
            return iterate(
                anchor, init(), records, max_epochs=IT_ROUNDS,
                listeners=[FnListener(lambda e, ctx: seen.append(
                    (e, float(ctx.outputs))))],
                config=IterationConfig(mode="hosted"),
                checkpoint=checkpoint, resume=resume)

        report = RecoveryReport()
        with FaultPlan().inject("iterate.epoch", at=3, kind="crash") as plan:
            healed = resilient_fit(
                run, checkpoint=CheckpointConfig(ckdir, interval=1),
                max_restarts=1, report=report,
                backoff=RetryPolicy(sleep=lambda s: None))
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    log(f"iterate under a crash at iterate.epoch 3: fires {plan.fires}, "
        f"restarts {report.restarts}, rounds seen {seen}")
    if (report.restarts != 1 or plan.fires != [("iterate.epoch", 3, "crash")]
            or {v for _, v in seen} != {IT_ANCHOR}
            or [e for e, _ in seen] != [0, 1, 2, 3, 4]
            or healed.num_epochs != IT_ROUNDS
            or int(healed.state["rounds"]) != IT_ROUNDS
            or not torch.equal(healed.state["acc"],
                               runs["hosted"].state["acc"])):
        fail("the healed iteration differs from the uninterrupted one")

    g = torch.Generator(device="cpu").manual_seed(20)
    w0 = torch.randn(4096, generator=g).to(dev)
    x = torch.randn(4096, generator=g).to(dev)

    def voting(state, epoch, d):
        new = state * 0.75 + d * 0.125
        return IterationBodyResult(new, outputs=new.sum(),
                                   termination=epoch < 9)

    def sweep(device, w):
        calls = []
        res = iterate(voting, w0.to(device), x.to(device), max_epochs=40,
                      steps_per_dispatch=w,
                      listeners=[FnListener(lambda e, ctx: calls.append(e))],
                      config=IterationConfig(mode="hosted"))
        return res, calls

    (one, calls1), (four, calls4) = sweep(dev, 1), sweep(dev, 4)
    (cpu4, cpu_calls4) = sweep("cpu", 4)
    log(f"steps_per_dispatch 4 vs 1 on {dev}: epochs {four.num_epochs} / "
        f"{one.num_epochs}, listener epochs {calls4} (W 1: {calls1}; the "
        f"CPU at W 4: {cpu_calls4})")
    if (not torch.equal(one.state, four.state)
            or one.num_epochs != 10 or four.num_epochs != 10
            or calls4 != cpu_calls4 or calls1 != list(range(10))):
        fail("W = 4 differs from W = 1, or listeners fired otherwise than "
             "on the CPU")

    def rounds(state, epoch, d):
        s = state["scratch"] + d.sum() + state["carried"]
        return IterationBodyResult({"carried": state["carried"] + 1.0,
                                    "scratch": s}, outputs=s)

    outs = {}
    for name, device in (("card", dev), ("cpu", torch.device("cpu"))):
        res = iterate(rounds, {"carried": torch.zeros((), device=device),
                               "scratch": torch.zeros((), device=device)},
                      torch.arange(4.0, device=device), max_epochs=4,
                      per_round=("scratch",),
                      config=IterationConfig(mode="hosted"))
        outs[name] = [float(o) for o in res.outputs]
    log(f"per_round on {dev}: {outs['card']} (CPU {outs['cpu']})")
    if outs["card"] != outs["cpu"] or outs["cpu"] != [6.0, 7.0, 8.0, 9.0]:
        fail("per_round differs from the CPU")
    log(f"phase 20: {time.perf_counter() - t0:.3f} s")


def stream_phase(torch, dev, card, mem_epochs_per_s, mem_fit_s):
    """Phase 21: the streamed LogisticRegression fit at the Criteo width
    (``fit_outofcore(mixed=True)`` over a ``DataCacheReader``), B1 and B2
    on every step; returns the streamed launches of each ELL kernel."""
    import shutil

    from flink_ml_tpu_torch import LogisticRegression
    from flink_ml_tpu_torch.data.datacache import (DataCacheReader,
                                                   DataCacheWriter)
    from flink_ml_tpu_torch.data.prefetch import PrefetchStats
    from flink_ml_tpu_torch.iteration import CheckpointConfig
    from flink_ml_tpu_torch.obs import tracer
    from flink_ml_tpu_torch.ops import ell_scatter as E
    from flink_ml_tpu_torch.robustness import (FaultPlan, RecoveryReport,
                                               RetryPolicy, resilient_fit)

    t_phase = time.perf_counter()
    shutil.rmtree(ST_DIR, ignore_errors=True)
    try:
        dense, cat, y = criteo_rows(ST_ROWS, D_MAIN, seed=0)
        t0 = time.perf_counter()
        w = DataCacheWriter(os.path.join(ST_DIR, "cache"))
        w.append({"features_dense": dense, "features_indices": cat,
                  "label": y.astype(np.float32)})
        w.finish()
        write_s = time.perf_counter() - t0
        cache = os.path.join(ST_DIR, "cache")
        size = sum(os.path.getsize(os.path.join(dp, f))
                   for dp, _, fs in os.walk(cache) for f in fs)
        del dense, cat, y
        steps = ST_ROWS // BATCH
        log(f"stream cache: {ST_ROWS} rows, {size} bytes, written in "
            f"{write_s:.3f} s; {steps} steps of {BATCH} an epoch")

        def fit(w=ST_W, stats=None, info=None, make_reader=None,
                supervise=None, **kw):
            """The user's call; with ``supervise`` (a RecoveryReport)
            through ``resilient_fit``."""
            est = (LogisticRegression(device=DEVICE).set_max_iter(ST_EPOCHS)
                   .set_tol(0))
            call, pre = est.fit_outofcore, ()
            if supervise is not None:
                call, pre = resilient_fit, (est.fit_outofcore,)
                kw.update(max_restarts=1, report=supervise,
                          backoff=RetryPolicy(sleep=lambda s: None))
            torch.cuda.synchronize()
            t = time.perf_counter()
            model = call(
                *pre, make_reader
                or (lambda: DataCacheReader(cache, batch_rows=BATCH)),
                num_features=D_MAIN, mixed=True, steps_per_dispatch=w,
                prefetch_workers=ST_WORKERS, prefetch_stats=stats,
                stream_info=info, **kw)
            torch.cuda.synchronize()
            return model, time.perf_counter() - t

        def coef(model):
            return model.get_model_data()[0]["coefficients"][0]

        stats, info = PrefetchStats(), {}
        E.reset_launch_counts()
        main, fit_s = fit(stats=stats, info=info)
        launches = dict(E.LAUNCHES)
        rec_s, rep_s = info["epoch_seconds"]
        log(f"streamed fit: plan {info['impl']}, loss log {main.loss_log}, "
            f"launches {launches}, decoded cache "
            f"{info['decoded_cache_batches']} batches "
            f"({info.get('decoded_cache_bytes')} bytes), dispatches "
            f"{info['dispatches_per_epoch']}")
        if info["impl"] != "ell-stream" or not np.all(
                np.isfinite(main.loss_log)):
            fail("the streamed fit did not plan 'ell-stream' or its loss "
                 "is not finite")
        if not main.loss_log[1] < main.loss_log[0]:
            fail(f"the streamed loss did not fall: {main.loss_log}")
        for name in ("ell_margin", "ell_scatter_apply_fused"):
            if launches[name] != steps * ST_EPOCHS:
                fail(f"{name} launched {launches[name]} times on the "
                     f"streamed path, expected {steps * ST_EPOCHS}")
        if launches["ell_scatter_apply"] != 0:
            fail("the pair kernel ran on a grid of 8192 rows")
        log(f"streamed epochs/s at 2^20 features, batch 2^15, {steps} "
            f"steps an epoch, W {ST_W}, {ST_WORKERS} decode workers: "
            f"record epoch {1 / rec_s:.4f} ({rec_s:.4f} s), replay epoch "
            f"{1 / rep_s:.4f} ({rep_s:.4f} s); fit() wall {fit_s:.3f} s; "
            f"rows/s record {ST_ROWS / rec_s:.1f}, replay "
            f"{ST_ROWS / rep_s:.1f} [{card}]")
        log(f"prefetch stats of the streamed fit: {stats.as_dict()} [{card}]")
        log(f"beside phase 4 (in memory, 2^18 rows, 8 steps an epoch, "
            f"device-resident epoch tensors): {mem_epochs_per_s:.3f} "
            f"epochs/s = {mem_epochs_per_s * ROWS:.1f} rows/s; fit() wall "
            f"{mem_fit_s:.3f} s for {EPOCHS} epochs [{card}]")

        # the same fit again, warm (the first paid the pinned staging and
        # the page cache)
        warm_info = {}
        warm, warm_s = fit(info=warm_info)
        w_rec_s, w_rep_s = warm_info["epoch_seconds"]
        log(f"the streamed fit again, warm: record epoch {w_rec_s:.4f} s, "
            f"replay epoch {w_rep_s:.4f} s; fit() wall {warm_s:.3f} s; "
            f"equal to the first {np.array_equal(coef(warm), coef(main))} "
            f"[{card}]")
        if not np.array_equal(coef(warm), coef(main)):
            fail("a second streamed fit differs from the first")
        plain, _ = fit(plain=True)
        diff = float(np.max(np.abs(coef(plain) - coef(main))))
        log(f"(b) streamed fit vs plain=True on the card: max |dw| = "
            f"{diff:.3e} (allclose rtol 1e-3, atol 1e-4)")
        if not np.allclose(coef(main), coef(plain), rtol=1e-3, atol=1e-4):
            fail("the streamed fit diverged from its plain versions")
        one, _ = fit(w=1)
        log(f"(c) W 8 vs W 1: equal {np.array_equal(coef(one), coef(main))}")
        if not (np.array_equal(coef(one), coef(main))
                and one.loss_log == main.loss_log):
            fail("W = 8 differs from W = 1")
        uncached_info = {}
        uncached, _ = fit(cache_decoded=False, info=uncached_info)
        log(f"(d) replayed epoch vs an uncached fit: equal "
            f"{np.array_equal(coef(uncached), coef(main))} (cached "
            f"batches {uncached_info['decoded_cache_batches']})")
        if not (np.array_equal(coef(uncached), coef(main))
                and uncached.loss_log == main.loss_log
                and uncached_info["decoded_cache_batches"] == 0):
            fail("the replayed epoch differs from an uncached fit")

        plan = FaultPlan().inject("source.pull", at=ST_CRASH_PULL,
                                  kind="crash")
        report = RecoveryReport()
        tracer.enable()
        with plan:
            healed, heal_s = fit(
                make_reader=lambda: plan.wrap_source(
                    DataCacheReader(cache, batch_rows=BATCH)),
                checkpoint=CheckpointConfig(os.path.join(ST_DIR, "ck")),
                checkpoint_every_steps=ST_CUT_EVERY, supervise=report)
        tracer.disable()
        cuts = [s.dur * 1e3 for s in tracer.find("checkpoint_write")]
        event = report.events[0] if report.events else None
        log(f"(e) crash at source pull {ST_CRASH_PULL}, resumed from a "
            f"checkpoint_every_steps={ST_CUT_EVERY} cut: restarts "
            f"{report.restarts}, restored step "
            f"{event.restored_step if event else None}, equal "
            f"{np.array_equal(coef(healed), coef(main))}; recovery "
            f"{event.mttr_s if event else float('nan'):.4f} s; checkpoint "
            f"cut host ms: median {statistics.median(cuts):.3f} over "
            f"{len(cuts)} cuts (max {max(cuts):.3f}); fit() wall with the "
            f"restart {heal_s:.3f} s [{card}]")
        if (report.restarts != 1 or event.restored_step != ST_CUT_EVERY
                or not np.array_equal(coef(healed), coef(main))
                or healed.loss_log != main.loss_log):
            fail("the resumed fit differs from the uninterrupted one")
    finally:
        shutil.rmtree(ST_DIR, ignore_errors=True)
    log(f"phase 21: {time.perf_counter() - t_phase:.3f} s")
    return {name: launches[name] for name in
            ("ell_margin", "ell_scatter_apply_fused", "ell_scatter_apply")}


# The streamed KMeans fit (phase 22): the KMeans headline's points through
# a data cache, 8 batches of 2^17 rows a round
SK_BATCH = 1 << 17
# The streamed Wide&Deep fit (phase 23): 16 bench-width batches, W 8, a
# crash fetching batch 12 healed from a checkpoint_every_steps=8 cut;
# lazy Adam on the first 4 batches (a crash fetching batch 6 healed from
# a checkpoint_every_steps=2 cut at W 2)
SW_W, SW_CRASH_PULL, SW_CUT_EVERY = 8, 12, 8
SW_LAZY_BATCHES = 4
# tests/test_torch_widedeep.py's loss tolerance of one step from converted
# state (held here between the streamed and the in-memory fit's loss logs)
SW_LOSS_TOL = dict(rtol=1e-5, atol=0.0)
# Streaming FTRL (phase 24) at bench_online_ftrl's shape (bench.py:1459-1472)
FT_D, FT_WINDOWS, FT_ROWS, FT_DENSE, FT_UNIT = 1 << 20, 16, 1 << 12, 13, 26
FT_ALPHA, FT_BETA, FT_L1, FT_L2 = 0.1, 1.0, 1e-4, 1e-4
FT_KILL_AT, FT_INTERVAL = 11, 4
FT_TOL = dict(rtol=1e-4, atol=1e-6)
# OnlineKMeans on a drifting stream: k 256, d 64, 32 windows of 256 rows
OK_K, OK_D, OK_WINDOWS, OK_ROWS = 256, 64, 32, 256
OK_KILL_AT, OK_INTERVAL = 20, 8


def stream_kmeans_phase(torch, dev, card):
    """Phase 22: ``KMeans.fit_outofcore`` at the KMeans headline's shape,
    the stats kernel (B4) on every batch; returns its launches."""
    import shutil

    from flink_ml_tpu_torch import KMeans
    from flink_ml_tpu_torch.data.datacache import (DataCacheReader,
                                                   DataCacheWriter)
    from flink_ml_tpu_torch.data.prefetch import PrefetchStats
    from flink_ml_tpu_torch.distance import DistanceMeasure
    from flink_ml_tpu_torch.models.clustering import kmeans as KM
    from flink_ml_tpu_torch.ops import kmeans as K

    t_phase = time.perf_counter()
    cache = os.path.join(ST_DIR, "kmeans")
    shutil.rmtree(ST_DIR, ignore_errors=True)
    try:
        pts = np.random.default_rng(0).normal(size=(N_KM, D_KM)).astype(
            np.float32)
        t0 = time.perf_counter()
        w = DataCacheWriter(cache)
        w.append({"features": pts})
        w.finish()
        log(f"streamed KMeans cache: {N_KM} x {D_KM} f32 written in "
            f"{time.perf_counter() - t0:.3f} s; {N_KM // SK_BATCH} batches "
            f"of {SK_BATCH} a round")

        def reader():
            return DataCacheReader(cache, batch_rows=SK_BATCH)

        def fit(stats=None):
            est = (KMeans(device=DEVICE).set_k(K_KM).set_max_iter(KM_ITERS)
                   .set_seed(0))
            torch.cuda.synchronize()
            t = time.perf_counter()
            model = est.fit_outofcore(reader, prefetch_stats=stats)
            torch.cuda.synchronize()
            return (est, model.get_model_data()[0]["centroids"][0],
                    time.perf_counter() - t)

        stats = PrefetchStats()
        K.reset_launch_counts()
        est, main, fit_s = fit(stats)
        launches = dict(K.LAUNCHES)
        want = -(-N_KM // SK_BATCH) * KM_ITERS
        log(f"(a) streamed KMeans fit: plan {est.planned_impl}, launches "
            f"{launches} (expected kmeans_update_stats {want})")
        if est.planned_impl != "kernel" or launches != {
                "kmeans_update_stats": want, "kmeans_update_stats_bf16": 0,
                "kmeans_assign_reduce": 0, "kmeans_workset_update": 0}:
            fail("the stats kernel did not carry every streamed batch")
        if main.shape != (K_KM, D_KM) or not np.all(np.isfinite(main)):
            fail("the streamed centroids are not finite (k, d)")
        log(f"streamed KMeans iterations/s at {N_KM} x {D_KM}, k {K_KM}, "
            f"batches of {SK_BATCH}: {KM_ITERS / fit_s:.3f} ({fit_s:.3f} s "
            f"for {KM_ITERS} rounds, cache read and transfer included); "
            f"phase 7's device-resident rate "
            f"{RATES.get('kmeans_iters_per_s', float('nan')):.3f} [{card}]")
        log(f"prefetch stats of the streamed KMeans fit: {stats.as_dict()} "
            f"[{card}]")

        # (b) every round from the same centroids: B4 against the plain
        # stats on the same stream
        init = KM.select_random_centroids(pts[:SK_BATCH], K_KM, 0)
        c, worst, chain = init, 0.0, [init]
        for r in range(KM_ITERS):
            got = KM.kmeans_fit_outofcore(reader, K_KM, max_iter=1,
                                          device=dev, init=c)
            ref = KM.kmeans_fit_outofcore(reader, K_KM, max_iter=1,
                                          device=dev, init=c, plain=True)
            e = float(np.max(np.abs(got - ref)))
            worst = max(worst, e)
            if not np.allclose(got, ref, **KM_GATE):
                fail(f"streamed round {r}: B4 vs the plain stats max |d| "
                     f"{e:.3e} outside allclose(5e-3, 5e-3)")
            c = got
            chain.append(got)
        log(f"(b) {KM_ITERS} streamed rounds, each from the same centroids: "
            f"B4 vs the plain stats, worst max |d| {worst:.3e} (allclose "
            f"5e-3, 5e-3); the round-by-round chain equals the fit "
            f"{np.array_equal(c, main)}")
        if not np.array_equal(c, main):
            fail("the round-by-round streamed chain differs from the fit")

        # (c) the in-memory Lloyd's on the same rows, round by round from
        # the streamed fit's centroids (the two sum in another f32 order;
        # run free from the same init, near-tie flips compound round over
        # round on this data, so the free run's distance is printed only)
        measure = DistanceMeasure.get_instance("euclidean")
        x = torch.from_numpy(pts).to(dev)
        ones = torch.ones(N_KM, device=dev)
        plan = KM._fit_plan(N_KM, D_KM, K_KM, measure)

        def in_memory(start, rounds):
            return KM.fit_centroids(
                x, ones, torch.from_numpy(start).to(dev), plan,
                measure=measure, max_iter=rounds).state.cpu().numpy()

        worst = 0.0
        for r in range(KM_ITERS):
            mem = in_memory(chain[r], 1)
            worst = max(worst, float(np.max(np.abs(chain[r + 1] - mem))))
            if not np.allclose(chain[r + 1], mem, **KM_GATE):
                fail(f"streamed round {r} diverged from the in-memory "
                     "Lloyd's round from the same centroids")
        free = float(np.max(np.abs(main - in_memory(init, KM_ITERS))))
        del x
        log(f"(c) streamed vs in-memory Lloyd's, each round from the same "
            f"centroids: worst max |d| {worst:.3e} (allclose 5e-3, 5e-3); "
            f"both run free {KM_ITERS} rounds from the same init: max |d| "
            f"{free:.3e} (not gated: near-tie flips compound)")
        _, again, again_s = fit()
        log(f"(d) a second streamed fit: equal bit for bit "
            f"{np.array_equal(again, main)} ({again_s:.3f} s) [{card}]")
        if not np.array_equal(again, main):
            fail("a second streamed KMeans fit differs from the first")
    finally:
        shutil.rmtree(ST_DIR, ignore_errors=True)
    log(f"phase 22: {time.perf_counter() - t_phase:.3f} s")
    return launches["kmeans_update_stats"]


def _wd_leaves(params):
    out = {k: params[k] for k in WD_TABLE_KEYS}
    for i, layer in enumerate(params["mlp"]):
        out[f"mlp_{i}_w"], out[f"mlp_{i}_b"] = layer["w"], layer["b"]
    return out


def _wd_same(a, b):
    la, lb = _wd_leaves(a._params), _wd_leaves(b._params)
    return a.loss_log == b.loss_log and all(
        np.array_equal(la[k], lb[k]) for k in la)


def stream_widedeep_phase(torch, dev, card):
    """Phase 23: ``WideDeep.fit_outofcore`` at the bench width, dense and
    lazy Adam, bit for bit across W, resume and reruns."""
    import importlib.util
    import shutil

    from flink_ml_tpu_torch import Table, WideDeep
    from flink_ml_tpu_torch.data.datacache import (DataCacheReader,
                                                   DataCacheWriter)
    from flink_ml_tpu_torch.iteration import CheckpointConfig
    from flink_ml_tpu_torch.models.common.sgd import plan_epoch_layout
    from flink_ml_tpu_torch.models.recommendation import widedeep as W
    from flink_ml_tpu_torch.obs import tracer
    from flink_ml_tpu_torch.robustness import (FaultPlan, RecoveryReport,
                                               RetryPolicy, resilient_fit)

    t_phase = time.perf_counter()
    shutil.rmtree(ST_DIR, ignore_errors=True)
    vocab = [WD_VOCAB] * WD_FIELDS
    try:
        cat, dense, y = widedeep_bench_data(WD_BATCH, WD_STEPS)
        cols = {"denseFeatures": dense.reshape(-1, WD_DENSE),
                "catFeatures": cat.reshape(-1, WD_FIELDS),
                "label": y.reshape(-1)}
        n = WD_BATCH * WD_STEPS
        # the cache holds the rows in the in-memory fit's shuffled order,
        # so both fits take the same batches
        _, _, perm = plan_epoch_layout(n, WD_BATCH, 1, 17)
        caches = {}
        for name, rows in (("dense", n), ("lazy", SW_LAZY_BATCHES
                                          * WD_BATCH)):
            caches[name] = os.path.join(ST_DIR, name)
            w = DataCacheWriter(caches[name])
            w.append({k: v[perm][:rows] for k, v in cols.items()})
            w.finish()

        def est(lazy, epochs=WD_EPOCHS):
            return (WideDeep(device=DEVICE).set_vocab_sizes(vocab)
                    .set(WideDeep.EMBEDDING_DIM, WD_EMB)
                    .set(WideDeep.HIDDEN_UNITS, WD_HIDDEN)
                    .set_global_batch_size(WD_BATCH).set_max_iter(epochs)
                    .set_seed(17).set(WideDeep.LAZY_EMB_OPT, lazy))

        def fit(lazy, w, crash=None, epochs=WD_EPOCHS, **kw):
            def reader():
                r = DataCacheReader(caches["lazy" if lazy else "dense"],
                                    batch_rows=WD_BATCH)
                return crash.wrap_source(r) if crash is not None else r

            call, pre = est(lazy, epochs).fit_outofcore, ()
            if "checkpoint" in kw:
                call, pre = resilient_fit, (call,)
                kw.update(max_restarts=1,
                          backoff=RetryPolicy(sleep=lambda s: None))
            torch.cuda.synchronize()
            t = time.perf_counter()
            model = call(*pre, reader, steps_per_dispatch=w, **kw)
            torch.cuda.synchronize()
            return model, time.perf_counter() - t

        for lazy in (False, True):
            label = "lazy" if lazy else "dense"
            steps = (SW_LAZY_BATCHES if lazy else WD_STEPS) * WD_EPOCHS
            main, fit_s = fit(lazy, SW_W)
            if not (len(main.loss_log) == WD_EPOCHS
                    and np.all(np.isfinite(main.loss_log))):
                fail(f"streamed Wide&Deep ({label}): loss log "
                     f"{main.loss_log}")
            log(f"streamed Wide&Deep ({label} Adam): loss log "
                f"{main.loss_log}; {steps / fit_s:.3f} steps/s ({fit_s:.3f} "
                f"s for {steps} steps, W {SW_W}, cache read and transfer "
                f"included) [{card}]")
            one, _ = fit(lazy, 1)
            log(f"(a) {label}: W {SW_W} vs W 1 bit for bit "
                f"{_wd_same(one, main)}")
            if not _wd_same(one, main):
                fail(f"streamed Wide&Deep ({label}): W {SW_W} differs from "
                     "W 1")
            plan = FaultPlan().inject(
                "source.pull", at=6 if lazy else SW_CRASH_PULL,
                kind="crash")
            report = RecoveryReport()
            every, w = (2, 2) if lazy else (SW_CUT_EVERY, SW_W)
            tracer.enable()
            with plan:
                healed, heal_s = fit(
                    lazy, w, crash=plan, report=report,
                    checkpoint=CheckpointConfig(os.path.join(ST_DIR,
                                                             "ck" + label)),
                    checkpoint_every_steps=every)
            tracer.disable()
            cuts = [sp.dur * 1e3 for sp in tracer.find("checkpoint_write")]
            tracer.clear()
            event = report.events[0] if report.events else None
            ref = main if w == SW_W else one
            log(f"(b) {label}: crash fetching batch "
                f"{plan.fires[0][1] if plan.fires else None}, resumed from "
                f"a checkpoint_every_steps={every} cut (restored step "
                f"{event.restored_step if event else None}): equal to the "
                f"uninterrupted fit {_wd_same(healed, ref)}; recovery "
                f"{event.mttr_s if event else float('nan'):.4f} s; "
                f"checkpoint cut host ms median "
                f"{statistics.median(cuts) if cuts else float('nan'):.3f} "
                f"over {len(cuts)} cuts; fit() wall with the restart "
                f"{heal_s:.3f} s [{card}]")
            if report.restarts != 1 or not _wd_same(healed, ref):
                fail(f"streamed Wide&Deep ({label}): the resumed fit "
                     "differs from the uninterrupted one")
            again, again_s = fit(lazy, SW_W)
            extra = ""
            if not lazy:
                # the fit's one-off work (the host init draws, the
                # parameters' copies in and out) cancels in the difference
                # of a 3-epoch and a 1-epoch fit (the lazy epoch of 4
                # steps is too short to read above the noise)
                _, one_epoch_s = fit(lazy, SW_W, epochs=1)
                _, three_epoch_s = fit(lazy, SW_W, epochs=3)
                t0 = time.perf_counter()
                W.init_params(np.random.default_rng(18), WD_DENSE, vocab,
                              WD_EMB, WD_HIDDEN)
                init_s = time.perf_counter() - t0
                marginal = 2 * WD_STEPS / (three_epoch_s - one_epoch_s)
                extra = (f"; epochs 2-3 alone (a 3-epoch fit less a "
                         f"1-epoch fit) {marginal:.3f} steps/s; the host "
                         f"init draws {init_s:.3f} s of each fit")
            log(f"(c) {label}: a second run bit for bit "
                f"{_wd_same(again, main)}; {steps / again_s:.3f} steps/s "
                f"({again_s:.3f} s){extra} [{card}]")
            if not _wd_same(again, main):
                fail(f"streamed Wide&Deep ({label}): a rerun differs")
            if lazy:
                break
            # (d) the in-memory 'off' step is the streamed fit's step
            # (both gather through _FixedOrderRows, C4): replayed on the
            # same batches, every step from the streamed fit's own state,
            # two calls of it give the same bits, and the replay must end
            # bit for bit on the streamed fit
            params = W.params_to_device(W.init_params(
                np.random.default_rng(18), WD_DENSE, vocab, WD_EMB,
                WD_HIDDEN), dev)
            off_step, state = W._make_train_ops(params, 1e-2, False)
            offs = W._field_offsets(vocab)
            for i in range(steps):
                rows_i = perm[(i % WD_STEPS) * WD_BATCH:
                              (i % WD_STEPS + 1) * WD_BATCH]
                batch_i = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(
                    dev) for a in (cols["denseFeatures"][rows_i],
                                   (cols["catFeatures"][rows_i]
                                    + offs).astype(np.int32),
                                   cols["label"][rows_i],
                                   np.ones(WD_BATCH, np.float32)))
                p_f, s_f, l_f = off_step(params, state, *batch_i)
                p_o, _, l_o = off_step(params, state, *batch_i)
                a, b = _wd_leaves(p_f), _wd_leaves(p_o)
                if not torch.equal(l_f, l_o) or not all(
                        torch.equal(a[k], b[k]) for k in a):
                    fail(f"step {i}: two calls of the 'off' step from one "
                         f"state differ")
                params, state = p_f, s_f
                del p_o
            replayed = all(np.array_equal(v.cpu().numpy(), want) for v, want
                           in zip(_wd_leaves(params).values(),
                                  _wd_leaves(main._params).values()))
            del params, state
            mem = (est(False).set(WideDeep.ROUTED_EMB_GRAD, "off")
                   .fit(Table(cols)))
            mem2 = (est(False).set(WideDeep.ROUTED_EMB_GRAD, "off")
                    .fit(Table(cols)))
            a, b, c = (_wd_leaves(m._params) for m in (main, mem, mem2))
            whole = {k: float(np.max(np.abs(a[k] - b[k]))) for k in a}
            self_d = {k: float(np.max(np.abs(b[k] - c[k]))) for k in b}
            # C4: the in-memory 'off' fit gathers through _FixedOrderRows,
            # so two of them give the same bits
            if not _wd_same(mem, mem2):
                fail("two in-memory 'off' Wide&Deep fits differ")
            log(f"(d) the in-memory 'off' step replayed from the streamed "
                f"state, twice a step: the same bits; the replay equals the "
                f"fit {replayed}; whole fits: loss {main.loss_log} vs "
                f"{mem.loss_log} (rtol 1e-5), max |d| by leaf {whole}; two "
                f"in-memory 'off' fits against each other: {self_d}")
            if not replayed:
                fail("the streamed Wide&Deep fit is not reproduced by its "
                     "step replay")
            if not np.allclose(main.loss_log, mem.loss_log, **SW_LOSS_TOL):
                fail("the streamed Wide&Deep loss left the in-memory fit's")
            mem_rates = RATES.get("widedeep_steps_per_s", {})
            log(f"beside phase 11 (in memory, device-resident epoch "
                f"tensors): kernel {mem_rates.get('kernel', float('nan')):.3f}"
                f", autograd 'off' {mem_rates.get('off', float('nan')):.3f} "
                f"steps/s [{card}]")

        spec = importlib.util.spec_from_file_location(
            "stream_grad_routes",
            os.path.join(HERE, "scripts", "stream_grad_routes.py"))
        routes = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(routes)

        def time_fn(fn):
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            return start.elapsed_time(end)

        route_ms = {}
        for route in ("fixed", "sort_fold", "sort_fold", "fixed"):
            ms, _ = routes.streamed_step_ms(
                route, dev, batch=WD_BATCH, vocab=WD_VOCAB, emb=WD_EMB,
                hidden=WD_HIDDEN, time_fn=time_fn)
            route_ms.setdefault(route, []).append(ms)
        log("the fixed-order table-gradient routes, the streamed dense-Adam "
            "step at the bench width (W 8, device-resident batches): "
            + ", ".join(f"{k} {min(v):.3f} ms" for k, v in route_ms.items())
            + f" (the fit runs 'fixed') [{card}]")
    finally:
        shutil.rmtree(ST_DIR, ignore_errors=True)
    log(f"phase 23: {time.perf_counter() - t_phase:.3f} s")


def ftrl_windows(seed=13):
    """``bench_online_ftrl``'s windows (``bench.py:1459-1472``): ids uniform
    in [0, d) over 39 slots, 13 N(0,1) values then 26 unit values."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, FT_D, size=(FT_WINDOWS, FT_ROWS,
                                      FT_DENSE + FT_UNIT)).astype(np.int32)
    vals = np.concatenate(
        [rng.normal(size=(FT_WINDOWS, FT_ROWS, FT_DENSE)).astype(np.float32),
         np.ones((FT_WINDOWS, FT_ROWS, FT_UNIT), np.float32)], axis=2)
    y = rng.integers(0, 2, size=(FT_WINDOWS, FT_ROWS)).astype(np.float32)
    return idx, vals, y


def numpy_ftrl(idx, vals, y):
    """float64 numpy FTRL-proximal over the windows: the final weights."""
    w = np.zeros(FT_D)
    z, n = np.zeros(FT_D), np.zeros(FT_D)
    for i in range(len(y)):
        iw, vw, yw = idx[i], vals[i].astype(np.float64), y[i]
        p = 1.0 / (1.0 + np.exp(-np.sum(vw * w[iw], axis=-1)))
        r = (p - yw) / len(yw)
        g = np.zeros(FT_D)
        np.add.at(g, iw.reshape(-1), (vw * r[:, None]).reshape(-1))
        sigma = (np.sqrt(n + g * g) - np.sqrt(n)) / FT_ALPHA
        z += g - sigma * w
        n += g * g
        w = np.where(np.abs(z) <= FT_L1, 0.0,
                     -(z - np.sign(z) * FT_L1)
                     / ((FT_BETA + np.sqrt(n)) / FT_ALPHA + FT_L2))
    return w


def online_phase(torch, dev, card):
    """Phase 24: streaming FTRL at ``bench_online_ftrl``'s shape through a
    write-ahead window log, healed bit for bit; OnlineKMeans likewise."""
    import shutil

    from flink_ml_tpu_torch import (OnlineKMeans, OnlineLogisticRegression,
                                    Table)
    from flink_ml_tpu_torch.data.wal import WindowLog
    from flink_ml_tpu_torch.iteration import CheckpointConfig
    from flink_ml_tpu_torch.models.classification import (
        online_logisticregression as OLR)

    t_phase = time.perf_counter()
    shutil.rmtree(ST_DIR, ignore_errors=True)
    try:
        idx, vals, y = ftrl_windows()
        # (a) the update rate with the windows resident on the card
        d_idx = torch.from_numpy(idx).to(dev).long()
        d_vals, d_y = (torch.from_numpy(vals).to(dev),
                       torch.from_numpy(y).to(dev))
        sw = torch.ones(FT_ROWS, device=dev)

        def run():
            state = {k: torch.zeros(FT_D, device=dev)
                     for k in ("w", "z", "n")}
            for i in range(FT_WINDOWS):
                state, _ = OLR.sparse_ftrl_step(
                    state, d_idx[i], d_vals[i], d_y[i], sw, FT_ALPHA,
                    FT_BETA, FT_L1, FT_L2)
            return state

        run()
        trials = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            resident = run()
            torch.cuda.synchronize()
            trials.append(time.perf_counter() - t0)
        log(f"(a) FTRL update rate, {FT_WINDOWS} windows of {FT_ROWS} x "
            f"{FT_DENSE + FT_UNIT} resident on the card, d {FT_D}: "
            f"{FT_WINDOWS / min(trials):.1f} windows/s [{card}]")
        del d_idx, d_vals, d_y

        def tables():
            return [Table({"features_indices": idx[i],
                           "features_values": vals[i], "label": y[i]})
                    for i in range(FT_WINDOWS)]

        def est():
            return (OnlineLogisticRegression(device=DEVICE)
                    .set_num_features(FT_D).set_alpha(FT_ALPHA)
                    .set_beta(FT_BETA).set_reg(FT_L1 + FT_L2)
                    .set_elastic_net(FT_L1 / (FT_L1 + FT_L2)))

        wal = os.path.join(ST_DIR, "wal")
        t0 = time.perf_counter()
        oracle = est().fit(WindowLog(iter(tables()), wal))
        torch.cuda.synchronize()
        wal_s = time.perf_counter() - t0
        log(f"(b) OnlineLogisticRegression.fit over a WindowLog on local "
            f"disk (one file and one directory fsync a window): "
            f"{FT_WINDOWS / wal_s:.1f} windows/s ({wal_s:.3f} s), model "
            f"version {oracle.model_version} [{card}]")
        if not np.array_equal(oracle._state.coefficients,
                              resident["w"].cpu().numpy().astype(np.float64)):
            fail("the fit's weights differ from the resident update's")

        class Killed(RuntimeError):
            pass

        wins = tables()
        chaos = os.path.join(ST_DIR, "chaos")
        ckpt = CheckpointConfig(os.path.join(ST_DIR, "ck"),
                                interval=FT_INTERVAL)
        try:
            est().fit(WindowLog(killing_at(wins, FT_KILL_AT, Killed),
                                chaos), checkpoint=ckpt)
            fail("the killed FTRL fit did not die")
        except Killed:
            pass
        t0 = time.perf_counter()
        resumed = est().fit(WindowLog(iter(wins[FT_KILL_AT:]), chaos),
                            checkpoint=ckpt, resume=True)
        torch.cuda.synchronize()
        same = np.array_equal(resumed._state.coefficients,
                              oracle._state.coefficients)
        log(f"(c) FTRL killed at window {FT_KILL_AT}, resumed from the "
            f"interval-{FT_INTERVAL} cut with the log replaying the windows "
            f"past the cursor: equal bit for bit {same}, model version "
            f"{resumed.model_version}; resume {time.perf_counter() - t0:.3f} "
            f"s [{card}]")
        if not same or resumed.model_version != FT_WINDOWS:
            fail("the healed FTRL fit differs from the uninterrupted one")
        want = numpy_ftrl(idx, vals, y)
        got = oracle._state.coefficients
        e = float(np.max(np.abs(got - want)))
        log(f"(d) FTRL weights vs a float64 numpy FTRL: max |d| {e:.3e} "
            f"(allclose 1e-4, 1e-6); nonzero {int(np.count_nonzero(got))} "
            f"vs {int(np.count_nonzero(want))}")
        if not np.allclose(got, want, **FT_TOL):
            fail("the FTRL weights left the float64 oracle's tolerance")

        # OnlineKMeans on a drifting stream
        rng = np.random.default_rng(21)
        centers = rng.normal(size=(OK_K, OK_D)).astype(np.float32) * 4
        km_wins = [Table({"features": (
            centers[rng.integers(0, OK_K, OK_ROWS)]
            + rng.normal(size=(OK_ROWS, OK_D)) + 0.05 * i).astype(
                np.float32)}) for i in range(OK_WINDOWS)]
        init = Table({"centroids": centers[None]})

        def km_est():
            return (OnlineKMeans(device=DEVICE).set_k(OK_K)
                    .set_decay_factor(0.5).set_initial_model_data(init))

        t0 = time.perf_counter()
        km_oracle = km_est().fit(WindowLog(iter(km_wins),
                                           os.path.join(ST_DIR, "kmo")))
        torch.cuda.synchronize()
        km_s = time.perf_counter() - t0
        try:
            km_est().fit(WindowLog(killing_at(km_wins, OK_KILL_AT, Killed),
                                   os.path.join(ST_DIR, "kmc")),
                         checkpoint=CheckpointConfig(
                             os.path.join(ST_DIR, "kmck"),
                             interval=OK_INTERVAL))
            fail("the killed OnlineKMeans fit did not die")
        except Killed:
            pass
        km_resumed = km_est().fit(
            WindowLog(iter(km_wins[OK_KILL_AT:]), os.path.join(ST_DIR,
                                                                "kmc")),
            checkpoint=CheckpointConfig(os.path.join(ST_DIR, "kmck"),
                                        interval=OK_INTERVAL), resume=True)
        a = km_oracle.get_model_data()[0]["centroids"]
        b = km_resumed.get_model_data()[0]["centroids"]
        log(f"OnlineKMeans (k {OK_K}, d {OK_D}, {OK_WINDOWS} windows of "
            f"{OK_ROWS}, drifting mean) over a WindowLog: "
            f"{OK_WINDOWS / km_s:.1f} windows/s; killed at window "
            f"{OK_KILL_AT}, resumed from the interval-{OK_INTERVAL} cut: "
            f"equal bit for bit {np.array_equal(a, b)}, model version "
            f"{km_resumed.model_version} [{card}]")
        if not (np.array_equal(a, b) and np.all(np.isfinite(a))
                and km_resumed.model_version == OK_WINDOWS):
            fail("the healed OnlineKMeans fit differs from the "
                 "uninterrupted one")
    finally:
        shutil.rmtree(ST_DIR, ignore_errors=True)
    log(f"phase 24: {time.perf_counter() - t_phase:.3f} s")


# the pipeline bench (the JAX package's bench.py:1979-2003): 2^17 x 64 f32,
# numpy seed 23; std -> minmax -> maxabs -> PCA k 16 -> LR, max_iter 3
PL_ROWS, PL_DIM, PL_K, PL_ITERS = 1 << 17, 64, 16, 3
PL_CPU_TOL = dict(rtol=1e-5, atol=1e-6)    # the PCA output, card vs CPU
PL_REPS = 5                                # transforms timed each way
WD_TRANSFORM_ROWS = 1 << 13                # phase 28
CV_REGS, CV_FOLDS, CV_ITERS = (0.0, 0.01), 3, 2
CV_AUC_TOL = 1e-4                          # per-fold AUC, card vs CPU


def same_bits(what, ref, out):
    """Every column of two tables equal in dtype and bits."""
    for c in ref.column_names:
        a, b = np.asarray(ref[c]), np.asarray(out[c])
        if a.dtype != b.dtype or a.shape != b.shape or \
                not np.array_equal(a.view(np.uint8), b.view(np.uint8)):
            fail(f"{what}: column {c!r} differs from its reference")


def fused_and_stagewise(torch, pm, table, counter=None):
    """(fused, stagewise) outputs of one transform each, with the
    dispatches and (``counter()``) the kernel launches each added."""
    from flink_ml_tpu_torch.api import chain

    out = {}
    for label in ("fused", "stagewise"):
        before = counter() if counter else None
        d0 = chain.dispatch_count()
        if label == "fused":
            (t,) = pm.transform(table)
        else:
            with chain.chain_disabled():
                (t,) = pm.transform(table)
        torch.cuda.synchronize()
        out[label] = (t, chain.dispatch_count() - d0,
                      counter() - before if counter else None)
    return out["fused"], out["stagewise"]


def median_transform_ms(torch, pm, table, reps=PL_REPS):
    """Median host-clock ms of ``pm.transform(table)``, fused and
    stagewise (each warmed once)."""
    from flink_ml_tpu_torch.api import chain

    def run(disabled):
        times = []
        for i in range(reps + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if disabled:
                with chain.chain_disabled():
                    pm.transform(table)
            else:
                pm.transform(table)
            torch.cuda.synchronize()
            if i:
                times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    return run(False), run(True)


def bench_pipeline(torch):
    """The pipeline bench fitted on ``DEVICE``: ``(pipeline model,
    features table, the stage tables t1-t4, LR model, fit s)``."""
    from flink_ml_tpu_torch import LogisticRegression, PipelineModel, Table
    from flink_ml_tpu_torch.models.feature import (PCA, MaxAbsScaler,
                                                   MinMaxScaler,
                                                   StandardScaler)

    X, y, _, _ = dense_rows(PL_ROWS, PL_DIM, seed=23)
    table = Table({"features": X, "label": y})
    t0 = time.perf_counter()
    s1 = StandardScaler(device=DEVICE).set_output_col("std").fit(table)
    t1 = s1.transform(table)[0]
    s2 = (MinMaxScaler(device=DEVICE).set_features_col("std")
          .set_output_col("mm").fit(t1))
    t2 = s2.transform(t1)[0]
    s3 = (MaxAbsScaler(device=DEVICE).set_features_col("mm")
          .set_output_col("ma").fit(t2))
    t3 = s3.transform(t2)[0]
    s4 = (PCA(device=DEVICE).set_k(PL_K).set_features_col("ma")
          .set_output_col("pc").fit(t3))
    t4 = s4.transform(t3)[0]
    lr = (LogisticRegression(device=DEVICE).set_features_col("pc")
          .set_max_iter(PL_ITERS).fit(t4))
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    pm = PipelineModel([s1, s2, s3, s4, lr])
    return pm, table.drop("label"), (t1, t2, t3, t4), lr, fit_s


def pipeline_phase(torch, dev, card):
    """Phase 25: the bench pipeline fitted on the card; its plan, fused
    against stagewise, the same models on the CPU, bytes and times."""
    import copy

    from flink_ml_tpu_torch import PipelineModel

    t_phase = time.perf_counter()
    pm, feats, (t1, t2, t3, t4), lr, fit_s = bench_pipeline(torch)
    plan = pm._chain_plan([feats])
    if plan is None or plan.describe() != [("segment", 5)]:
        fail(f"pipeline: plan {plan.describe() if plan else None}, "
             "expected one segment of 5 stages")
    (fused, d_f, _), (ref, d_s, _) = fused_and_stagewise(torch, pm, feats)
    log(f"pipeline (phase 25): fit {fit_s:.3f} s (LR loss log "
        f"{lr.loss_log}), plan {plan.describe()}, dispatches fused {d_f}, "
        f"stagewise {d_s} [{card}]")
    if (d_f, d_s) != (1, 5):
        fail(f"pipeline: dispatches fused {d_f}, stagewise {d_s}; "
             "expected 1 and 5")
    same_bits("pipeline", ref, fused)

    cpu_pm = PipelineModel([copy.copy(s) for s in pm.stages])
    for s in cpu_pm.stages:
        s.device = "cpu"
    (cpu,) = cpu_pm.transform(feats)
    pc_err = float(np.max(np.abs(np.asarray(cpu["pc"], np.float64)
                                 - np.asarray(fused["pc"], np.float64))))
    flips = int(np.sum(np.asarray(cpu["prediction"])
                       != np.asarray(fused["prediction"])))
    log(f"pipeline on the CPU: pc max |card - CPU| = {pc_err:.3e} "
        f"(allclose rtol {PL_CPU_TOL['rtol']}, atol {PL_CPU_TOL['atol']}), "
        f"{flips} predictions differ (tolerance 0)")
    if not np.allclose(fused["pc"], cpu["pc"], **PL_CPU_TOL) or flips:
        fail("pipeline: the card and the CPU disagree")

    # byte accounting (bench.py:2030-2048): stagewise moves every stage's
    # consumed and produced columns, fused each segment's entry and fetch
    widths = {}
    for t in (feats, t1, t2, t3, t4, fused):
        for name, (shape, _) in t.schema().items():
            widths.setdefault(name, int(np.prod(shape)) if shape else 1)
    bytes_stagewise = sum(
        4 * PL_ROWS * widths.get(name, 1) for seg in plan.segments
        for k in seg.kernels for name in k.consumes + k.produces)
    bytes_fused = sum(sum(seg.transfer_bytes(PL_ROWS))
                      for seg in plan.segments)
    fused_ms, stagewise_ms = median_transform_ms(torch, pm, feats)
    log(f"pipeline bytes a transform: stagewise {bytes_stagewise}, fused "
        f"{bytes_fused} ({bytes_stagewise / bytes_fused:.3f}x); transform "
        f"median ms: fused {fused_ms:.3f}, stagewise {stagewise_ms:.3f} "
        f"({stagewise_ms / fused_ms:.3f}x) over {PL_REPS} runs, "
        f"{PL_ROWS} x {PL_DIM} [{card}]")
    log(f"phase 25: {time.perf_counter() - t_phase:.2f} s [{card}]")


def kmeans_terminal_phase(torch, dev, card):
    """Phase 26: StandardScaler -> KMeans (k 256, 10 rounds through B4) on
    the KMeans headline's points; held-out rows fused and stagewise.
    Returns what phase 29's Graph is held to."""
    from flink_ml_tpu_torch import KMeans, PipelineModel, Table
    from flink_ml_tpu_torch.models.feature import StandardScaler
    from flink_ml_tpu_torch.ops import kmeans as K

    t_phase = time.perf_counter()
    host = np.random.default_rng(0).normal(size=(N_KM, D_KM)).astype(
        np.float32)
    table = Table({"features": host})
    sc = StandardScaler(device=DEVICE).set_output_col("scaled").fit(table)
    K.reset_launch_counts()
    km = (KMeans(device=DEVICE).set_k(K_KM).set_max_iter(KM_ITERS)
          .set_features_col("scaled").fit(sc.transform(table)[0]))
    torch.cuda.synchronize()
    fit_launches = dict(K.LAUNCHES)
    if fit_launches["kmeans_update_stats"] != KM_ITERS:
        fail(f"KMeans terminal: fit launches {fit_launches}")
    pm = PipelineModel([sc, km])
    held = Table({"features": np.random.default_rng(9).normal(
        size=(KM_HELD, D_KM)).astype(np.float32)})
    plan = pm._chain_plan([held])
    if plan is None or plan.describe() != [("segment", 2)]:
        fail(f"KMeans terminal: plan {plan.describe() if plan else None}")
    K.reset_launch_counts()
    (fused, d_f, b5_f), (ref, d_s, b5_s) = fused_and_stagewise(
        torch, pm, held, lambda: K.LAUNCHES["kmeans_assign_reduce"])
    others = K.LAUNCHES["kmeans_update_stats"] \
        + K.LAUNCHES["kmeans_workset_update"]
    same_bits("KMeans terminal", ref, fused)
    scaled = np.asarray(fused["scaled"], np.float64)
    cents = km.get_model_data()[0]["centroids"][0].astype(np.float64)
    d2 = ((scaled * scaled).sum(1)[:, None] - 2.0 * scaled @ cents.T
          + (cents * cents).sum(1)[None, :])
    two = np.sort(d2, axis=1)[:, :2]
    near = two[:, 1] - two[:, 0] <= 1e-5 * two[:, 1]
    pred = np.asarray(fused["prediction"])
    off = int(np.sum((pred != d2.argmin(1)) & ~near))
    log(f"KMeans terminal (phase 26): fit launches {fit_launches}; "
        f"transform of {KM_HELD} rows: B5 launches fused {b5_f}, stagewise "
        f"{b5_s}; dispatches {d_f} / {d_s}; {int(near.sum())} rows within "
        f"1e-5 relative of a tie in f64, {off} other rows off the float64 "
        f"argmin [{card}]")
    if (b5_f, b5_s, others, d_f, d_s) != (1, 1, 0, 1, 2) or off:
        fail("KMeans terminal: launches, dispatches or assignments wrong")
    fused_ms, stagewise_ms = median_transform_ms(torch, pm, held)
    log(f"KMeans terminal transform median ms: fused {fused_ms:.3f}, "
        f"stagewise {stagewise_ms:.3f}; phase 26: "
        f"{time.perf_counter() - t_phase:.2f} s [{card}]")
    return table, held, fused, b5_f


def ivf_terminal_phase(torch, dev, card):
    """Phase 27: StandardScaler fitted on the retrieval corpus, the flat
    and IVF-PQ indexes built on the scaled corpus, [scaler, index] over
    the bench queries at nprobe 2."""
    from flink_ml_tpu_torch import IVFIndex, PipelineModel, PQConfig, Table
    from flink_ml_tpu_torch.models.feature import StandardScaler
    from flink_ml_tpu_torch.ops import retrieve as R

    t_phase = time.perf_counter()
    X, queries = retrieval_corpus(RT_N, RT_D, RT_NQ)
    sc = (StandardScaler(device=DEVICE).set_features_col("query")
          .set_output_col("query").fit(Table({"query": X})))
    Xs = np.asarray(sc.transform(Table({"query": X}))[0]["query"],
                    np.float32)
    qt = Table({"query": queries})
    qs = np.asarray(sc.transform(qt)[0]["query"], np.float32)
    launches = {}
    for name, pq in (("retrieve_flat", None),
                     ("retrieve_pq", PQConfig(**RT_PQ))):
        index = IVFIndex.build(Xs, RT_NLIST, pq, k=RT_K, nprobe=2, seed=1,
                               device=DEVICE)
        pm = PipelineModel([sc, index])
        plan = pm._chain_plan([qt])
        if plan is None or plan.describe() != [("segment", 2)]:
            fail(f"IVF terminal: plan {plan.describe() if plan else None}")
        R.reset_launch_counts()
        (fused, d_f, c_f), (ref, d_s, c_s) = fused_and_stagewise(
            torch, pm, qt, lambda: sum(R.LAUNCHES.values()))
        launches[name] = c_f
        calls = int(R.LAUNCHES[name])
        same_bits(f"IVF terminal ({name})", ref, fused)
        nn, dist = index.search(qs)
        direct = (np.array_equal(nn, fused["neighbors"]) and
                  np.array_equal(dist.view(np.uint32),
                                 np.asarray(fused["distances"]).view(
                                     np.uint32)))
        log(f"IVF terminal (phase 27, {name}): {RT_NQ} queries at nprobe "
            f"2: calls fused {c_f}, stagewise {c_s} (2 CUDA launches "
            f"each); dispatches {d_f} / {d_s}; equal to scaler.transform "
            f"+ search: {direct} [{card}]")
        if (c_f, c_s, calls, d_f, d_s) != (1, 1, 2, 1, 2) or not direct:
            fail(f"IVF terminal ({name}): calls, dispatches or results "
                 "wrong")
    log(f"phase 27: {time.perf_counter() - t_phase:.2f} s [{card}]")
    return launches


def widedeep_terminal_phase(torch, dev, card):
    """Phase 28: StandardScaler on the dense column ahead of a Wide&Deep
    model at the bench width fitted 1 epoch; 8192 rows fused and
    stagewise; an out-of-range id raises on both paths."""
    from flink_ml_tpu_torch import PipelineModel, Table, WideDeep
    from flink_ml_tpu_torch.models.feature import StandardScaler

    t_phase = time.perf_counter()
    cat, dense, y = widedeep_bench_data(WD_BATCH, WD_STEPS)
    rows = WD_BATCH * WD_STEPS
    table = Table({"denseFeatures": dense.reshape(rows, WD_DENSE),
                   "catFeatures": cat.reshape(rows, WD_FIELDS),
                   "label": y.reshape(rows)})
    sc = (StandardScaler(device=DEVICE).set_features_col("denseFeatures")
          .set_output_col("denseFeatures").fit(table))
    wd = (WideDeep(device=DEVICE).set_vocab_sizes([WD_VOCAB] * WD_FIELDS)
          .set(WideDeep.EMBEDDING_DIM, WD_EMB)
          .set(WideDeep.HIDDEN_UNITS, WD_HIDDEN)
          .set_global_batch_size(WD_BATCH).set_max_iter(1).set_seed(0)
          .fit(sc.transform(table)[0]))
    pm = PipelineModel([sc, wd])
    h_cat, h_dense, _ = widedeep_bench_data(WD_TRANSFORM_ROWS, 1, seed=18)
    held = Table({"denseFeatures": h_dense[0], "catFeatures": h_cat[0]})
    plan = pm._chain_plan([held])
    if plan is None or plan.describe() != [("segment", 2)]:
        fail(f"Wide&Deep terminal: plan "
             f"{plan.describe() if plan else None}")
    (fused, d_f, _), (ref, d_s, _) = fused_and_stagewise(torch, pm, held)
    same_bits("Wide&Deep terminal", ref, fused)
    # the terminal against an independent float64 numpy forward of the
    # fitted parameters on the scaled rows the segment fetched
    want = numpy_widedeep_scores(
        wd._params, np.asarray(fused["denseFeatures"]),
        h_cat[0] + np.arange(WD_FIELDS, dtype=np.int64) * WD_VOCAB)
    perr = float(np.max(np.abs(fused["rawPrediction"] - want)))
    bad_cat = h_cat[0].copy()
    bad_cat[5, 3] = WD_VOCAB
    bad = Table({"denseFeatures": h_dense[0], "catFeatures": bad_cat})
    raised = []
    for disabled in (False, True):
        from flink_ml_tpu_torch.api import chain

        try:
            if disabled:
                with chain.chain_disabled():
                    pm.transform(bad)
            else:
                pm.transform(bad)
        except ValueError:
            raised.append(True)
    fused_ms, stagewise_ms = median_transform_ms(torch, pm, held)
    log(f"Wide&Deep terminal (phase 28): loss {wd.loss_log}, "
        f"{WD_TRANSFORM_ROWS} rows, dispatches {d_f} / {d_s}, scores "
        f"finite {bool(np.isfinite(fused['rawPrediction']).all())}, max "
        f"|score - numpy f64 score| = {perr:.3e} (tolerance 1e-5); an "
        f"out-of-range id raised on {len(raised)} of 2 paths; transform "
        f"median ms fused {fused_ms:.3f}, stagewise {stagewise_ms:.3f} "
        f"(the stagewise transform copies the model to the card each "
        f"call); phase 28: {time.perf_counter() - t_phase:.2f} s [{card}]")
    if (d_f, d_s) != (1, 2) or len(raised) != 2 or perr > 1e-5 or \
            not np.isfinite(fused["rawPrediction"]).all():
        fail("Wide&Deep terminal: dispatches, scores or the range check "
             "wrong")


def composition_phase(torch, dev, card, km_run):
    """Phase 29: CrossValidator over the Criteo-width mixed LR, against
    the same CV on the CPU; a Graph source -> StandardScaler -> KMeans
    against phase 26's pipeline."""
    from flink_ml_tpu_torch import (CrossValidator, GraphBuilder, KMeans,
                                    LogisticRegression, ParamGridBuilder,
                                    Table)
    from flink_ml_tpu_torch.models import BinaryClassificationEvaluator
    from flink_ml_tpu_torch.models.common import sgd as S
    from flink_ml_tpu_torch.models.feature import StandardScaler
    from flink_ml_tpu_torch.ops import ell_scatter as E
    from flink_ml_tpu_torch.ops import kmeans as K

    t_phase = time.perf_counter()
    dense, cat, y = criteo_rows(ROWS, D_MAIN, seed=0)
    table = Table({"features_dense": dense, "features_indices": cat,
                   "label": y})
    grid = (ParamGridBuilder()
            .add_grid(LogisticRegression.REG, list(CV_REGS)).build())

    def cv(device):
        est = (LogisticRegression(device=device).set_num_features(D_MAIN)
               .set_global_batch_size(BATCH).set_max_iter(CV_ITERS)
               .set_tol(0))
        ev = (BinaryClassificationEvaluator(device=device)
              .set_raw_prediction_col("rawPrediction")
              .set_metrics("areaUnderROC"))
        return CrossValidator(est, ev, grid).set_num_folds(CV_FOLDS) \
            .set_seed(0)

    card_cv = cv(DEVICE)
    fits = [tr.num_rows for tr, _ in card_cv._splits(table)] \
        * len(CV_REGS) + [table.num_rows]
    want = sum(S.plan_epoch_layout(n, BATCH, 1, 0)[0] * CV_ITERS
               for n in fits)
    E.reset_launch_counts()
    t0 = time.perf_counter()
    got = card_cv.fit(table)
    torch.cuda.synchronize()
    cv_s = time.perf_counter() - t0
    cv_launches = dict(E.LAUNCHES)
    t0 = time.perf_counter()
    cpu = cv("cpu").fit(table)
    cpu_s = time.perf_counter() - t0
    auc_d = float(np.max(np.abs(np.asarray(got.fold_metrics)
                                - np.asarray(cpu.fold_metrics))))
    log(f"CrossValidator (phase 29): {len(fits)} fits of {fits} rows, "
        f"launches {cv_launches}, expected {want} each of B1 and B2; "
        f"chosen reg card {got.best_params[LogisticRegression.REG]}, CPU "
        f"{cpu.best_params[LogisticRegression.REG]}; "
        f"per-fold AUC card {got.fold_metrics}, CPU {cpu.fold_metrics}, "
        f"max |d| {auc_d:.3e} (tolerance {CV_AUC_TOL}); fit s card "
        f"{cv_s:.3f}, CPU {cpu_s:.3f} [{card}]")
    if cv_launches["ell_margin"] != want or \
            cv_launches["ell_scatter_apply_fused"] != want or \
            cv_launches["ell_scatter_apply"] != 0:
        fail("CrossValidator: B1/B2 launches are not the fits' steps")
    if got.best_index != cpu.best_index or auc_d > CV_AUC_TOL:
        fail("CrossValidator: the card and the CPU disagree")
    # phase 4's label marker saturates the AUC, so the refitted winners'
    # weights are held too (the fits' tolerance, bench.py:266)
    coef = {name: m.best_model.get_model_data()[0]["coefficients"][0]
            for name, m in (("card", got), ("cpu", cpu))}
    coef_d = float(np.max(np.abs(coef["card"] - coef["cpu"])))
    log(f"CrossValidator refit on all rows: max |w card - w CPU| = "
        f"{coef_d:.3e} (allclose rtol 1e-3, atol 1e-4)")
    if not np.allclose(coef["card"], coef["cpu"], rtol=1e-3, atol=1e-4):
        fail("CrossValidator: the refitted models disagree")

    km_table, held, km_fused, _ = km_run
    b = GraphBuilder()
    src = b.source()
    scaled = b.add_stage(StandardScaler(device=DEVICE)
                         .set_output_col("scaled"), [src])[0]
    pred = b.add_stage(KMeans(device=DEVICE).set_k(K_KM)
                       .set_max_iter(KM_ITERS).set_features_col("scaled"),
                       [scaled])[0]
    K.reset_launch_counts()
    gm = b.build([src], [pred]).fit(km_table)
    torch.cuda.synchronize()
    fit_launches = dict(K.LAUNCHES)       # the fit's walk transforms too
    K.reset_launch_counts()
    (g_out,) = gm.transform(held)
    torch.cuda.synchronize()
    g_launches = dict(K.LAUNCHES)
    log(f"Graph (phase 29): source -> StandardScaler -> KMeans, fit "
        f"launches {fit_launches}, transform launches {g_launches}; phase "
        f"29: {time.perf_counter() - t_phase:.2f} s [{card}]")
    if fit_launches["kmeans_update_stats"] != KM_ITERS or \
            g_launches["kmeans_assign_reduce"] != 1 or \
            g_launches["kmeans_update_stats"] != 0:
        fail(f"Graph: launches {fit_launches}, {g_launches}")
    same_bits("Graph against phase 26's pipeline", km_fused, g_out)
    return cv_launches


# Serving (phases 30-33).  bench_serving's endpoint (bench.py:1531-1624):
# LR d 64 weights from numpy seed 17, a 1024-row pool, 1-8-row requests,
# max_batch_rows 256, max_wait_ms 1.0, queue 2^14, 1/8/64 clients.
SV_D, SV_POOL = 64, 1024
SV_CLIENTS = ((1, 64), (8, 64), (64, 16))
SV_BATCH, SV_WAIT_MS, SV_QUEUE = 256, 1.0, 1 << 14
SV_JOIN_S = 120
SV_BUCKETS = (8, 16, 32, 64, 128, 256)
# bench_multitenant's scheduler (bench.py:3414-3416, 3496-3498): 9 LR
# tenants at d 32, 1 interactive + 8 bulk with zipfian weights 1/(i+1)
MT_D, MT_BATCH, MT_BULK_ROWS, MT_WAIT_MS = 32, 128, 8, 0.5
# the Wide&Deep row cache (phase 31): a quarter of the 1,048,554 rows
WD_CACHE_BLOCK, WD_CACHE_BLOCKS = 512, 512
ENVELOPE = 0.99             # int8 decision agreement (tests/test_int8.py)
FITTED = {}                 # models of earlier phases the serving reuses


def zipf_ids(rng, size, vocab, a=1.3):
    """bench.py:3841-3842's zipfian key mix."""
    return ((rng.zipf(a, size=size) - 1) % vocab).astype(np.int32)


def close_endpoint(what, endpoint):
    """Close an endpoint or scheduler and fail if its loop outlived the
    join."""
    thread = endpoint._thread
    endpoint.close(timeout=SV_JOIN_S)
    if thread is not None and thread.is_alive():
        fail(f"{what}: the serve thread is still alive after close")


def run_clients(what, n_clients, work):
    """``work(worker)`` on ``n_clients`` threads at once; every thread is
    joined with a timeout and its exception, if any, fails the run.
    Returns the wall seconds."""
    import threading

    errors = []

    def body(worker):
        try:
            work(worker)
        except Exception as exc:  # noqa: BLE001 — reported below
            errors.append(repr(exc)[:300])

    threads = [threading.Thread(target=body, args=(w,))
               for w in range(n_clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(SV_JOIN_S)
    wall = time.perf_counter() - t0
    if any(t.is_alive() for t in threads):
        fail(f"{what}: a client thread is still alive after "
             f"{SV_JOIN_S} s")
    if errors:
        fail(f"{what}: client errors {errors[:3]}")
    return wall


def bucket_bits(servable, pool, name, card):
    """Trouble 1 of the serving path: the same 8 rows scored inside every
    bucket of the ladder (the other rows from the pool); prints, per pair
    of buckets, how many of the 8 rows differ, and fails on any."""
    from flink_ml_tpu_torch import Table

    heads = {}
    for b in SV_BUCKETS:
        out = servable.predict(Table({c: np.asarray(pool[c])[:b]
                                      for c in pool.column_names}))
        heads[b] = [np.asarray(out[c])[:8] for c in out.column_names
                    if c not in pool.column_names]
    diffs = {}
    for i, a in enumerate(SV_BUCKETS):
        for b in SV_BUCKETS[i + 1:]:
            diffs[(a, b)] = int(np.logical_or.reduce([
                (x.reshape(8, -1).view(np.uint8)
                 != y.reshape(8, -1).view(np.uint8)).any(1)
                for x, y in zip(heads[a], heads[b])]).sum())
    log(f"bucket invariance ({name}): rows of 8 differing per pair of "
        f"buckets {diffs} [{card}]")
    if any(diffs.values()):
        fail(f"{name}: a row's bits depend on the bucket it rides in")


def lr_from_weights(coef, icpt):
    from flink_ml_tpu_torch import LogisticRegressionModel, Table

    return LogisticRegressionModel(device=DEVICE).set_model_data(Table({
        "coefficients": np.asarray(coef)[None, :],
        "intercept": np.array([icpt])}))


def serving_lr_phase(torch, dev, card, mixed_model):
    """Phase 30: bench_serving's LR endpoint at 1/8/64 clients, every
    response against ``model.transform`` of its rows; phase 4's mixed LR
    through ``make_servable`` (the ``model.transform`` route); a hot swap
    under 4 clients.  Returns the LR model and its pool (phase 33)."""
    import threading

    from flink_ml_tpu_torch import Table
    from flink_ml_tpu_torch.serving import (ModelRegistry, ServingEndpoint,
                                            serve_model)

    t_phase = time.perf_counter()
    rng = np.random.default_rng(17)
    model = lr_from_weights(rng.normal(size=SV_D), 0.1)
    pool = Table({"features": rng.normal(size=(SV_POOL, SV_D)).astype(
        np.float32)})
    registry = ModelRegistry()
    t0 = time.perf_counter()
    registry.deploy("lr", model, pool.take(2), max_batch_rows=SV_BATCH)
    warm_s = time.perf_counter() - t0
    endpoint = ServingEndpoint(registry, "lr", max_batch_rows=SV_BATCH,
                               max_wait_ms=SV_WAIT_MS,
                               queue_capacity=SV_QUEUE).start()
    warm_ms = {b: v["ms"]
               for b, v in endpoint.warmup_report["buckets"].items()}
    log(f"serving LR (phase 30): deploy + warm-up {warm_s:.3f} s; warm-up "
        f"ms by bucket {warm_ms} [{card}]")
    try:
        bucket_bits(registry.current("lr").servable, pool,
                    "LR d 64", card)
        for clients, per_client in SV_CLIENTS:
            latencies, served = [], []
            lock = threading.Lock()

            def client(worker):
                crng = np.random.default_rng(worker)
                mine = []
                for _ in range(per_client):
                    start = int(crng.integers(0, SV_POOL - 24))
                    rows = int(crng.integers(1, 9))
                    req = pool.slice(start, start + rows)
                    t0 = time.perf_counter()
                    out = endpoint.predict(req, timeout=SV_JOIN_S)
                    mine.append((time.perf_counter() - t0, req, out))
                with lock:
                    latencies.extend(m[0] for m in mine)
                    served.extend(m[1:] for m in mine)

            b0 = endpoint.metrics.batches.value
            wall = run_clients(f"serving LR ({clients} clients)", clients,
                               client)
            batches = endpoint.metrics.batches.value - b0
            for req, out in served:
                same_bits(f"serving LR ({clients} clients)",
                           model.transform(req)[0], out)
            lat = np.asarray(latencies)
            log(f"serving LR, {clients} clients: {len(lat)} requests in "
                f"{wall:.3f} s, {len(lat) / wall:.1f} requests/s, p50 "
                f"{1e3 * np.quantile(lat, 0.5):.3f} ms, p99 "
                f"{1e3 * np.quantile(lat, 0.99):.3f} ms, {batches} batches, "
                f"fill ratio {endpoint.metrics.snapshot()['batch_fill_ratio']}"
                f"; every response = the offline transform bit for bit "
                f"[{card}]")
            if len(lat) != clients * per_client:
                fail("serving LR: requests were dropped")
        if endpoint.metrics.shed.value:
            fail("serving LR: requests were shed at ample capacity")

        # hot swap under load: 4 clients, every response exactly one
        # generation's offline transform, nothing dropped
        model_b = lr_from_weights(rng.normal(size=SV_D) + 0.5, -0.3)
        reqs = [pool.slice(s, s + 1 + s % 8) for s in range(0, 960, 6)]
        results = [None] * len(reqs)
        swapped = threading.Event()

        def swap_client(worker):
            for i in range(worker, len(reqs), 4):
                results[i] = endpoint.predict(reqs[i], timeout=SV_JOIN_S)
                if i == len(reqs) // 2:
                    swapped.wait(SV_JOIN_S)

        def swap():
            time.sleep(0.02)              # clients under way first
            endpoint.hot_swap(model_b)
            swapped.set()

        swapper = threading.Thread(target=swap)
        swapper.start()
        run_clients("hot swap", 4, swap_client)
        swapper.join(SV_JOIN_S)
        if swapper.is_alive():
            fail("hot swap: the deploy thread is still alive")
        gens = {"a": 0, "b": 0}
        for req, out in zip(reqs, results):
            if out is None:
                fail("hot swap: a request was dropped")
            raw = np.asarray(out["rawPrediction"])
            if np.array_equal(raw, model.transform(req)[0]["rawPrediction"]):
                gens["a"] += 1
            elif np.array_equal(raw, model_b.transform(req)[0][
                    "rawPrediction"]):
                gens["b"] += 1
            else:
                fail("hot swap: a response matches neither generation")
        log(f"hot swap under 4 clients: {len(reqs)} responses, "
            f"generation 1 {gens['a']}, generation 2 {gens['b']}, "
            f"live generation {registry.generation('lr')}, health "
            f"{endpoint.metrics.health} [{card}]")
        if registry.generation("lr") != 2 or not gens["b"]:
            fail("hot swap: generation 2 never served")
    finally:
        close_endpoint("serving LR", endpoint)

    # phase 4's Criteo-width mixed LR: make_servable's model.transform
    # route (the sparse layouts have no chain kernel)
    dense, cat, _ = criteo_rows(2048, D_MAIN, seed=31)
    mixed = Table({"features_dense": dense, "features_indices": cat})
    mep = serve_model(mixed_model, mixed.take(2), max_batch_rows=SV_BATCH,
                      max_wait_ms=SV_WAIT_MS, queue_capacity=SV_QUEUE)
    try:
        if mep.registry.current("default").servable._kernel is not None:
            fail("mixed LR: expected the model.transform route")
        reqs = [mixed.slice(s, s + 1 + s % 8) for s in range(0, 1920, 10)]
        outs = [None] * len(reqs)

        def mixed_client(worker):
            for i in range(worker, len(reqs), 8):
                outs[i] = mep.predict(reqs[i], timeout=SV_JOIN_S)

        run_clients("mixed LR", 8, mixed_client)
        for req, out in zip(reqs, outs):
            same_bits("mixed LR", mixed_model.transform(req)[0], out)
        log(f"serving the Criteo-width mixed LR: {len(reqs)} requests in "
            f"{mep.metrics.batches.value} batches, every response = the "
            f"offline transform bit for bit [{card}]")
    finally:
        close_endpoint("mixed LR", mep)
    log(f"phase 30: {time.perf_counter() - t_phase:.2f} s [{card}]")
    return model, pool


def serve_checked(what, endpoint, reqs, n_clients):
    """Serve ``reqs`` from ``n_clients`` threads; returns the responses in
    request order and the batches they took."""
    outs = [None] * len(reqs)

    def client(worker):
        for i in range(worker, len(reqs), n_clients):
            outs[i] = endpoint.predict(reqs[i], timeout=SV_JOIN_S)

    b0 = endpoint.metrics.batches.value
    wall = run_clients(what, n_clients, client)
    if any(o is None for o in outs):
        fail(f"{what}: a request was dropped")
    return outs, endpoint.metrics.batches.value - b0, wall


def serving_kernel_phase(torch, dev, card):
    """Phase 31: the kernel-backed servables at full width — KMeans (B5)
    on phase 7's centroids, the flat (B8) and IVF-PQ (B9) indexes of
    phase 12 at nprobe 2, phase 10's Wide&Deep served plain and through
    the row cache on a zipfian key mix.  Returns the serve launches of
    B5, B8 and B9."""
    from flink_ml_tpu_torch import Table
    from flink_ml_tpu_torch.ops import kmeans as K
    from flink_ml_tpu_torch.ops import retrieve as R
    from flink_ml_tpu_torch.serving import make_servable, serve_model

    t_phase = time.perf_counter()
    launches = {}
    rng = np.random.default_rng(61)

    # -- KMeans: B5 once a served batch ------------------------------------
    km = FITTED["kmeans"]
    pts = rng.normal(size=(4096, D_KM)).astype(np.float32)
    reqs = [Table({"features": pts[s:s + n]}) for s, n in zip(
        range(0, 4096, 128), rng.integers(1, 257, size=32))]
    refs = [km.transform(r)[0] for r in reqs]
    ep = serve_model(km, reqs[0], max_batch_rows=SV_BATCH,
                     max_wait_ms=SV_WAIT_MS)
    try:
        bucket_bits(ep.registry.current("default").servable,
                    Table({"features": pts[:SV_BATCH]}), "KMeans (B5)",
                    card)
        torch.cuda.synchronize()
        K.reset_launch_counts()
        outs, batches, wall = serve_checked("KMeans serving", ep, reqs, 8)
        torch.cuda.synchronize()
        launches["kmeans_assign_reduce"] = K.LAUNCHES["kmeans_assign_reduce"]
        others = K.LAUNCHES["kmeans_update_stats"] \
            + K.LAUNCHES["kmeans_workset_update"]
    finally:
        close_endpoint("KMeans serving", ep)
    for ref, out in zip(refs, outs):
        same_bits("KMeans serving", ref, out)
    log(f"serving KMeans (k {K_KM}, d {D_KM}): {len(reqs)} requests of "
        f"1-256 rows in {batches} batches, {wall:.3f} s; B5 launches "
        f"{launches['kmeans_assign_reduce']} (others {others}); every "
        f"response = the offline transform bit for bit [{card}]")
    if launches["kmeans_assign_reduce"] != batches or others:
        fail("KMeans serving: B5 did not launch once a served batch")
    cents = torch.from_numpy(km._centroids).to(dev)
    worst = 0
    for b in SV_BUCKETS:
        p = torch.from_numpy(pts[:b]).to(dev)
        got = K.kmeans_assign_reduce(p, cents)[0]
        want = K.kmeans_assign_reduce_plain(p, cents)[0]
        near = near_tie_rows(torch, -2.0 * (p @ cents.T)
                             + (cents * cents).sum(1)[None, :])
        bad = int((got != want)[~near].sum())
        worst = max(worst, bad)
    log(f"B5 at buckets {SV_BUCKETS} vs its plain version: {worst} "
        f"assignments differ off near-tie rows (phase 6's gate) [{card}]")
    if worst:
        fail("B5 disagrees with its plain version at a serving bucket")

    # -- IVF: one retrieve call a served batch ------------------------------
    _, queries = retrieval_corpus(RT_N, RT_D, 4096)
    for name, index in (("retrieve_flat", FITTED["flat"]),
                        ("retrieve_pq", FITTED["pq"])):
        index = index.with_options(nprobe=2)
        sizes = rng.integers(1, 257, size=24)
        starts = np.concatenate([[0], np.cumsum(sizes)[:-1]]) % 3800
        reqs = [Table({"query": queries[s:s + n]})
                for s, n in zip(starts, sizes)]
        ep = serve_model(index, reqs[0], max_batch_rows=SV_BATCH,
                         max_wait_ms=SV_WAIT_MS)
        try:
            torch.cuda.synchronize()
            R.reset_launch_counts()
            outs, batches, wall = serve_checked(f"IVF serving ({name})", ep,
                                                reqs, 8)
            torch.cuda.synchronize()
            launches[name] = R.LAUNCHES[name]
            other = sum(R.LAUNCHES.values()) - launches[name]
        finally:
            close_endpoint(f"IVF serving ({name})", ep)
        for req, out in zip(reqs, outs):
            nn, dist = index.search(req["query"])
            if not (np.array_equal(nn, out["neighbors"]) and np.array_equal(
                    dist.view(np.uint32),
                    np.asarray(out["distances"]).view(np.uint32))):
                fail(f"IVF serving ({name}): a response differs from "
                     "search of its request alone")
        log(f"serving IVF ({name}, nprobe 2): {len(reqs)} requests of "
            f"1-256 queries in {batches} batches, {wall:.3f} s; calls "
            f"{launches[name]} (others {other}); ids and distance bits = "
            f"search of each request alone [{card}]")
        if launches[name] != batches or other:
            fail(f"IVF serving ({name}): not one call a served batch")

    # -- Wide&Deep, plain and through the row cache -------------------------
    wd = FITTED["widedeep"]
    n_req = 48
    sizes = rng.integers(1, 17, size=n_req)
    total = int(sizes.sum())
    cat = np.stack([zipf_ids(rng, total, WD_VOCAB)
                    for _ in range(WD_FIELDS)], axis=1)
    dense = rng.normal(size=(total, WD_DENSE)).astype(np.float32)
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    reqs = [Table({"denseFeatures": dense[s:s + n],
                   "catFeatures": cat[s:s + n]})
            for s, n in zip(starts, sizes)]
    refs = [wd.transform(r)[0] for r in reqs]
    served = {}
    for label, kw in (("plain", {}),
                      ("row cache", dict(
                          emb_cache=True, cache_block_rows=WD_CACHE_BLOCK,
                          cache_capacity_blocks=WD_CACHE_BLOCKS))):
        ep = serve_model(wd, reqs[0], max_batch_rows=SV_BATCH,
                         max_wait_ms=SV_WAIT_MS, **kw)
        try:
            servable = ep.registry.current("default").servable
            if label == "plain":
                pool = Table({"denseFeatures": dense[:SV_BATCH],
                              "catFeatures": cat[:SV_BATCH]})
                bucket_bits(servable, pool, "Wide&Deep", card)
            else:
                servable.cache.reset_counters()
            outs, batches, wall = serve_checked(f"Wide&Deep ({label})", ep,
                                                reqs, 8)
        finally:
            close_endpoint(f"Wide&Deep ({label})", ep)
        for ref, out in zip(refs, outs):
            same_bits(f"Wide&Deep serving ({label})", ref, out)
        served[label] = outs
        extra = ""
        if label == "row cache":
            snap = servable.cache.snapshot()
            extra = (f"; hit rate {snap['hit_rate']}, {snap['block_faults']}"
                     f" block faults, {snap['evictions']} evictions, "
                     f"{snap['bypasses']} bypasses, pool bytes "
                     f"{snap['pool_bytes']} ({snap['capacity_blocks']} of "
                     f"{snap['n_blocks']} blocks)")
        log(f"serving Wide&Deep ({label}): {n_req} zipfian requests of "
            f"1-16 rows in {batches} batches, {wall:.3f} s, param bytes "
            f"{servable.param_bytes}{extra}; every response = the offline "
            f"transform bit for bit [{card}]")
    log(f"phase 31: {time.perf_counter() - t_phase:.2f} s [{card}]")
    return launches


def lr_tenant(seed):
    rng = np.random.default_rng(seed)
    return lr_from_weights(rng.normal(size=MT_D), 0.1)


def multitenant_phase(torch, dev, card):
    """Phase 32: bench_multitenant's scheduler — admission of 9 LR
    tenants, the interactive p99 alone, under a bulk flood and through
    one FIFO endpoint, the shed order under overload, a seeded chip_down
    schedule at the dispatch boundary."""
    import threading

    from flink_ml_tpu_torch import Table
    from flink_ml_tpu_torch.api import chain
    from flink_ml_tpu_torch.kernels import build
    from flink_ml_tpu_torch.robustness import FaultPlan
    from flink_ml_tpu_torch.serving import (ServingOverloadedError,
                                            SharedScheduler, serve_model)

    t_phase = time.perf_counter()
    rng = np.random.default_rng(41)
    feats = Table({"features": rng.normal(size=(1024, MT_D)).astype(
        np.float32)})
    bulk = [f"bulk{i}" for i in range(8)]
    zipf_w = 1.0 / (np.arange(8) + 1.0)
    zipf_w /= zipf_w.sum()
    models = {"inter": lr_tenant(0),
              **{name: lr_tenant(i + 1) for i, name in enumerate(bulk)}}
    sched = SharedScheduler(max_batch_rows=MT_BATCH, max_wait_ms=MT_WAIT_MS,
                            queue_capacity=1 << 13,
                            bulk_batch_rows=MT_BULK_ROWS)
    counted = {"load_library": 0, "compile_pipeline": 0}
    retries = [0]
    real_load, real_compile = build.load_library, chain.compile_pipeline

    def count(name, fn):
        def wrapped(*a, **k):
            counted[name] += 1
            return fn(*a, **k)
        return wrapped

    try:
        sched.add_tenant("inter", models["inter"], feats.take(2),
                         slo="interactive")
        build.load_library = count("load_library", real_load)
        chain.compile_pipeline = count("compile_pipeline", real_compile)
        try:
            reports = [sched.add_tenant(n, models[n], feats.take(2),
                                        slo="bulk").admission_report
                       for n in bulk]
        finally:
            build.load_library, chain.compile_pipeline = \
                real_load, real_compile
        log(f"admission of tenants 2-9 (tenant 1's schema): library loads "
            f"{counted['load_library']}, plan builds "
            f"{counted['compile_pipeline']}, warm-up wall s "
            f"{[r['wall_s'] for r in reports]} [{card}]")
        if any(counted.values()) or any(r["compiled"] for r in reports):
            fail("admission of a same-schema tenant built something")
        sched.start()

        def interactive(submit, n_clients=2, per_client=100):
            """p99 ms of paced interactive clients; a request shed (the
            FIFO endpoint's full queue) retries, its latency counted from
            the first attempt."""
            lat, lock = [], threading.Lock()

            def client(worker):
                crng = np.random.default_rng(100 + worker)
                mine = []
                for _ in range(per_client):
                    start = int(crng.integers(0, 1000))
                    req = feats.slice(start, start + int(crng.integers(1, 5)))
                    t0 = time.perf_counter()
                    while True:
                        try:
                            fut = submit(req)
                            break
                        except ServingOverloadedError:
                            with lock:
                                retries[0] += 1
                            time.sleep(0.002)
                    out = fut.result(SV_JOIN_S)
                    mine.append(time.perf_counter() - t0)
                    if not np.array_equal(
                            out["rawPrediction"],
                            models["inter"].transform(req)[0][
                                "rawPrediction"]):
                        raise AssertionError("interactive response wrong")
                    time.sleep(0.001)     # a user clicking, paced
                with lock:
                    lat.extend(mine)

            run_clients("interactive clients", n_clients, client)
            return 1e3 * float(np.quantile(np.asarray(lat), 0.99))

        def flood(submit, stop, sheds, admitted, worker):
            """Bursts of 4 eight-row requests at zipfian-picked bulk
            tenants, above the service rate (bench.py's bulk_flood)."""
            crng = np.random.default_rng(500 + worker)
            while not stop.is_set():
                shed = False
                for _ in range(4):
                    name = bulk[int(crng.choice(8, p=zipf_w))]
                    start = int(crng.integers(0, 900))
                    try:
                        admitted.append(submit(
                            name, feats.slice(start, start + 8)))
                    except ServingOverloadedError:
                        shed = True
                        sheds.append(name)
                time.sleep(0.001 if shed else 0.0005)

        def contended(submit_inter, submit_bulk):
            """(interactive p99 ms, bulk sheds, bulk requests admitted)
            under the flood; every admitted bulk request is answered."""
            stop, sheds, admitted = threading.Event(), [], []
            flooders = [threading.Thread(
                target=flood, args=(submit_bulk, stop, sheds, admitted, w))
                for w in range(2)]
            for t in flooders:
                t.start()
            try:
                time.sleep(0.25)          # past the queue-fill transient
                p99 = interactive(submit_inter)
            finally:
                stop.set()
                for t in flooders:
                    t.join(SV_JOIN_S)
                if any(t.is_alive() for t in flooders):
                    fail("a bulk flood thread is still alive")
            for fut in admitted:
                fut.result(SV_JOIN_S)     # raises if a request failed
            return p99, len(sheds), len(admitted)

        def to_inter(req):
            return sched.submit("inter", req)

        interactive(to_inter, per_client=10)           # warm
        alone = interactive(to_inter)
        p99_contended, bulk_sheds, bulk_admitted = contended(
            to_inter, sched.submit)
        sheds = sched.shed_counts()
        inter_retries = retries[0]
    finally:
        close_endpoint("scheduler", sched)

    # one FIFO endpoint: the same interactive and bulk requests through a
    # single queue with no classes
    fifo = serve_model(models["inter"], feats.take(2),
                       max_batch_rows=MT_BATCH, max_wait_ms=MT_WAIT_MS,
                       queue_capacity=1 << 10)
    try:
        def fifo_inter(req):
            return fifo.submit(req)

        interactive(fifo_inter, per_client=10)          # warm
        retries[0] = 0
        p99_fifo, fifo_sheds, fifo_admitted = contended(
            fifo_inter, lambda name, req: fifo.submit(req))
    finally:
        close_endpoint("FIFO endpoint", fifo)
    log(f"multi-tenant (phase 32): interactive p99 alone {alone:.3f} ms, "
        f"under the bulk flood {p99_contended:.3f} ms (bulk sheds "
        f"{bulk_sheds}, {bulk_admitted} bulk requests admitted and all "
        f"answered; shed counts {sheds}), through one FIFO endpoint "
        f"(queue 1024) under the same flood {p99_fifo:.3f} ms (bulk sheds "
        f"{fifo_sheds}, {fifo_admitted} admitted and answered, interactive "
        f"retries after a shed {retries[0]}) [{card}]")
    if sheds["interactive"] or sheds["standard"] or inter_retries:
        fail("multi-tenant: a non-bulk request was shed under the flood")

    # the shed order under overload: a small scheduler, not started
    small = SharedScheduler(max_batch_rows=MT_BATCH, max_wait_ms=MT_WAIT_MS,
                            queue_capacity=64, bulk_batch_rows=MT_BULK_ROWS)
    try:
        small.add_tenant("i", models["inter"], feats.take(2),
                         slo="interactive")
        small.add_tenant("b", models["bulk0"], feats.take(2), slo="bulk")
        order, futures = [], []
        for k in range(120):
            name = "i" if k % 4 == 0 else "b"
            try:
                futures.append((name, k, small.submit(
                    name, feats.slice(k, k + 1))))
            except ServingOverloadedError:
                order.append(name)
        counts = small.shed_counts()
        small.start()
        for name, k, fut in futures:
            fut.result(SV_JOIN_S)
    finally:
        close_endpoint("small scheduler", small)
    bulk_share = counts["bulk"] / max(1, sum(counts.values()))
    log(f"overload of a 64-request queue: {len(order)} sheds, "
        f"{100 * bulk_share:.1f}% bulk ({counts}); {len(futures)} admitted "
        f"requests all answered [{card}]")
    if counts["interactive"] or not counts["bulk"]:
        fail("overload: the sheds are not all bulk")

    # a seeded chip_down schedule at the dispatch boundary: requeued, then
    # answered bit-identically, nothing dropped
    chips = SharedScheduler(max_batch_rows=MT_BATCH, max_wait_ms=MT_WAIT_MS,
                            queue_capacity=1 << 13)
    plan = FaultPlan(seed=7).inject_random("serving.dispatch", rate=0.3,
                                           horizon=200, kind="chip_down")
    try:
        for name in ("inter", "bulk0", "bulk1"):
            chips.add_tenant(name, models[name], feats.take(2),
                             slo="interactive" if name == "inter"
                             else "standard")
        chips.start()
        reqs = [(("inter", "bulk0", "bulk1")[i % 3],
                 feats.slice(i, i + 1 + i % 8)) for i in range(0, 600, 5)]
        with plan:
            futures = [chips.submit(name, req) for name, req in reqs]
            outs = [f.result(SV_JOIN_S) for f in futures]
        snap = chips.snapshot()
    finally:
        close_endpoint("chip_down scheduler", chips)
    for (name, req), out in zip(reqs, outs):
        if not np.array_equal(out["rawPrediction"],
                              models[name].transform(req)[0][
                                  "rawPrediction"]):
            fail("chip_down: a retried response is not bit-identical")
    log(f"chip_down at the dispatch boundary: {len(plan.fires)} faults, "
        f"{snap['requeued_requests']} requests requeued, {len(reqs)} of "
        f"{len(reqs)} answered bit-identically [{card}]")
    if not plan.fires or snap["requeued_requests"] < len(plan.fires):
        fail("chip_down: no requeue happened")
    log(f"phase 32: {time.perf_counter() - t_phase:.2f} s [{card}]")


def int8_phase(torch, dev, card, lr_model, lr_pool):
    """Phase 33: the LR of phase 30, the KMeans of phase 31 (B5) and the
    Wide&Deep of phase 31, plain and cached, at precision int8."""
    from flink_ml_tpu_torch import Table
    from flink_ml_tpu_torch.ops import kmeans as K
    from flink_ml_tpu_torch.serving import make_servable

    t_phase = time.perf_counter()
    rng = np.random.default_rng(71)

    def agreement(a, b):
        return float(np.mean(np.asarray(a) == np.asarray(b)))

    def pair(what, model, example, batches, **kw):
        """(int8 servable, agreement with f32, resident bytes int8 / f32)
        over ``batches``; two int8 predicts of a batch give one set of
        bits."""
        sv8 = make_servable(model, example, max_batch_rows=SV_BATCH,
                            precision="int8", **kw).warm_up()
        svf = make_servable(model, example, max_batch_rows=SV_BATCH,
                            **kw).warm_up()
        agree = []
        for batch in batches:
            out8 = sv8.predict(batch)
            again = sv8.predict(batch)
            for c in out8.column_names:
                if not np.array_equal(np.asarray(out8[c]),
                                      np.asarray(again[c])):
                    fail(f"int8 {what}: two predicts differ")
            agree.append(agreement(out8["prediction"],
                                   svf.predict(batch)["prediction"]))
        return sv8, float(np.mean(agree)), sv8.param_bytes, svf.param_bytes

    lr_batches = [lr_pool.slice(s, s + SV_BATCH)
                  for s in range(0, SV_POOL, SV_BATCH)]
    _, lr_agree, lr8, lrf = pair("LR", lr_model, lr_pool.take(2), lr_batches)

    km = FITTED["kmeans"]
    pts = rng.normal(size=(1024, D_KM)).astype(np.float32)
    km_batches = [Table({"features": pts[s:s + SV_BATCH]})
                  for s in range(0, 1024, SV_BATCH)]
    sv8 = make_servable(km, km_batches[0].take(2), max_batch_rows=SV_BATCH,
                        precision="int8").warm_up()
    torch.cuda.synchronize()
    K.reset_launch_counts()
    km_outs = [sv8.predict(b) for b in km_batches]
    torch.cuda.synchronize()
    km_launches = K.LAUNCHES["kmeans_assign_reduce"]
    svf = make_servable(km, km_batches[0].take(2), max_batch_rows=SV_BATCH
                        ).warm_up()
    km_agree = float(np.mean([agreement(o["prediction"],
                                        svf.predict(b)["prediction"])
                              for o, b in zip(km_outs, km_batches)]))
    if not all(np.array_equal(o["prediction"], sv8.predict(b)["prediction"])
               for o, b in zip(km_outs, km_batches)):
        fail("int8 KMeans: two predicts differ")

    wd = FITTED["widedeep"]
    n = 1024
    cat = np.stack([zipf_ids(rng, n, WD_VOCAB) for _ in range(WD_FIELDS)],
                   axis=1)
    dense = rng.normal(size=(n, WD_DENSE)).astype(np.float32)
    wd_batches = [Table({"denseFeatures": dense[s:s + SV_BATCH],
                         "catFeatures": cat[s:s + SV_BATCH]})
                  for s in range(0, n, SV_BATCH)]
    wd_ex = wd_batches[0].take(2)
    _, wd_agree, wd8, wdf = pair("Wide&Deep", wd, wd_ex, wd_batches)
    cache_kw = dict(emb_cache=True, cache_block_rows=WD_CACHE_BLOCK,
                    cache_capacity_blocks=WD_CACHE_BLOCKS)
    cached8, c_agree, c8, cf = pair("Wide&Deep cached", wd, wd_ex,
                                    wd_batches, **cache_kw)
    # cached int8 against bypassed int8: a one-block cache bypasses every
    # batch and dequantizes the same codes on the host
    bypass = make_servable(wd, wd_ex, max_batch_rows=SV_BATCH,
                           precision="int8", emb_cache=True,
                           cache_block_rows=WD_CACHE_BLOCK,
                           cache_capacity_blocks=1).warm_up()
    for b in wd_batches:
        if not np.array_equal(cached8.predict(b)["rawPrediction"],
                              bypass.predict(b)["rawPrediction"]):
            fail("int8 Wide&Deep: cached and bypassed scores differ")
    log(f"int8 (phase 33): decision agreement with f32 — LR {lr_agree:.4f}"
        f", KMeans {km_agree:.4f} (B5 launches {km_launches} for "
        f"{len(km_batches)} batches), Wide&Deep {wd_agree:.4f}, Wide&Deep "
        f"cached {c_agree:.4f} (envelope {ENVELOPE}); two predicts "
        f"bit-identical; cached int8 = bypassed int8 bit for bit "
        f"({bypass.cache.bypasses} bypasses); resident param bytes int8 / "
        f"f32: LR {lr8} / {lrf}, Wide&Deep {wd8} / {wdf}, Wide&Deep "
        f"cached {c8} / {cf} [{card}]")
    if min(lr_agree, km_agree, wd_agree, c_agree) < ENVELOPE:
        fail("int8: decision agreement below the envelope")
    if km_launches != len(km_batches):
        fail("int8 KMeans: B5 did not launch once a batch")
    log(f"phase 33: {time.perf_counter() - t_phase:.2f} s [{card}]")


# Train while serving (phase 34): bench_online's learner (bench.py:2231-
# 2392) at the Criteo width — 16 windows of BATCH rows, a cut every 4
# steps, 4 clients on phase 4's served mixed LR
OL_WINDOWS, OL_EVERY, OL_CLIENTS, OL_POOL = 16, 4, 4, 2048
OL_CRASH_PULL = 10          # (e) the live source dies handing out window 10
OL_SPARSE_SLOTS = 1024      # weights a hand-made sparse delta touches
# Publishes into kernel servables (phase 35)
OKM_WINDOWS, OKM_ROWS, OKM_ALPHA = 8, 4096, 0.9
RT_EDIT_ROWS = 64           # inserts and deletes of each index delta
WD_DELTA_ROWS = 1024        # embedding rows of the Wide&Deep delta
# Failover (phase 36): bench_failover's shape (bench.py:4426-4470)
FO_D, FO_CLIENTS, FO_PER_PHASE, FO_KILL_AT = 32, 16, 25, 5
FO_HYSTERESIS_S = 30.0


class ShiftedClock:
    """``time.monotonic`` plus an offset a phase can advance: recovery
    walls stay real seconds, a hysteresis window passes at once."""

    def __init__(self):
        self.offset = 0.0

    def __call__(self):
        return time.monotonic() + self.offset

    def advance(self, dt):
        self.offset += dt


def train_while_serve_phase(torch, dev, card, mixed_model):
    """Phase 34: a ``ContinuousLearner`` over 16 Criteo-width windows
    publishing into phase 4's served mixed LR under 4 clients; returns the
    learner's B1/B2/B3 launches."""
    import shutil
    import threading

    from flink_ml_tpu_torch import Table
    from flink_ml_tpu_torch.iteration import CheckpointConfig
    from flink_ml_tpu_torch.models.common import sgd as S
    from flink_ml_tpu_torch.models.common.losses import LOSSES
    from flink_ml_tpu_torch.obs import tracer
    from flink_ml_tpu_torch.online import (ContinuousLearner, DeltaEncoder,
                                           DeltaPublisher, model_with_params,
                                           params_of_model)
    from flink_ml_tpu_torch.ops import ell_scatter as E
    from flink_ml_tpu_torch.robustness import (FaultPlan, InjectedCrash,
                                               RecoveryReport, RetryPolicy,
                                               corrupt_file)
    from flink_ml_tpu_torch.serving import serve_model

    t_phase = time.perf_counter()
    shutil.rmtree(ST_DIR, ignore_errors=True)
    dense, cat, y = criteo_rows(OL_WINDOWS * BATCH, D_MAIN, seed=34)
    windows = [Table({"features_dense": dense[i * BATCH:(i + 1) * BATCH],
                      "features_indices": cat[i * BATCH:(i + 1) * BATCH],
                      "label": y[i * BATCH:(i + 1) * BATCH].astype(
                          np.float32)})
               for i in range(OL_WINDOWS)]
    p_dense, p_cat, _ = criteo_rows(OL_POOL, D_MAIN, seed=35)
    pool = Table({"features_dense": p_dense, "features_indices": p_cat})
    keys = dict(dense_key="features_dense", indices_key="features_indices")
    cfg = S.SGDConfig(max_epochs=1, tol=0.0)
    event_at, landed = {}, []

    class Spy(DeltaPublisher):
        """Keeps every landed generation's params and landing time."""

        history = []

        def apply(self, update):
            result = super().apply(update)
            if result.mode != "noop":
                Spy.history.append((result.step, result.mode,
                                    result.generation, {
                                        k: v.copy()
                                        for k, v in self._base.items()}))
                landed.append((result.step, time.perf_counter()))
            return result

    def stamped(lo=0):
        for i in range(lo, OL_WINDOWS):
            event_at[i] = time.perf_counter()
            yield windows[i]

    def endpoint():
        return serve_model(mixed_model, pool.take(2),
                           max_batch_rows=SV_BATCH, max_wait_ms=SV_WAIT_MS,
                           queue_capacity=SV_QUEUE)

    def learner(ep, source, name, **kw):
        return ContinuousLearner(
            loss_fn=LOSSES["logistic"], num_features=D_MAIN, source=source,
            wal_dir=os.path.join(ST_DIR, name, "wal"), endpoint=ep,
            batch_rows=BATCH, config=cfg,
            checkpoint=CheckpointConfig(os.path.join(ST_DIR, name, "ck")),
            publish_every_steps=OL_EVERY, device=DEVICE,
            backoff=RetryPolicy(base_delay=0.0, sleep=lambda s: None),
            **keys, **kw)

    def served_w(ep):
        model = ep.registry.current("default").servable.model
        return np.asarray(model._state.coefficients, np.float32)

    try:
        ep = endpoint()
        responses, errors, lock = [], [], threading.Lock()
        stop = threading.Event()

        def client(worker):
            crng = np.random.default_rng(340 + worker)
            mine = []
            try:
                while not stop.is_set():
                    start = int(crng.integers(0, OL_POOL - 8))
                    rows = int(crng.integers(1, 9))
                    t0 = time.perf_counter()
                    out = ep.predict(pool.slice(start, start + rows),
                                     timeout=SV_JOIN_S)
                    mine.append((start, rows, time.perf_counter() - t0,
                                 np.asarray(out["rawPrediction"])))
            except Exception as exc:  # noqa: BLE001 — reported below
                errors.append(repr(exc)[:300])
            with lock:
                responses.extend(mine)

        try:
            run = learner(ep, stamped(), "main")
            run.publisher = Spy(ep.registry, "default", metrics=ep.metrics)
            clients = [threading.Thread(target=client, args=(w,))
                       for w in range(OL_CLIENTS)]
            for t in clients:
                t.start()
            time.sleep(0.05)
            tracer.clear()
            tracer.enable()
            E.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run.run(max_windows=OL_WINDOWS)
            torch.cuda.synchronize()
            learn_s = time.perf_counter() - t0
            launches = dict(E.LAUNCHES)
            cut_ms = [round(1e3 * r.publish_s, 3) for r in run.publish_log]
            tracer.disable()
            cuts = [sp.dur * 1e3 for sp in tracer.find("checkpoint_write")]
            tracer.clear()
            time.sleep(0.05)
            stop.set()
            for t in clients:
                t.join(SV_JOIN_S)
            held_wall = time.perf_counter() - t0
            if any(t.is_alive() for t in clients):
                fail("train while serving: a client thread is still alive")
            shed = ep.metrics.shed.value

            # a sparse delta at this width, against a full deploy
            pub, enc = ep.delta_publisher(), DeltaEncoder()
            p = params_of_model(ep.registry.current("default").servable
                                .model)
            pub.apply(enc.encode(100, p, pub.stats))
            enc.ack()
            srng = np.random.default_rng(36)
            delta_ms, delta_bytes = [], None
            for step in range(101, 106):
                p = {"w": p["w"].copy(), "b": p["b"]}
                p["w"][srng.integers(0, D_MAIN, OL_SPARSE_SLOTS)] += \
                    np.float32(0.01)
                res = pub.apply(enc.encode(step, p, pub.stats))
                enc.ack()
                if res.mode != "delta":
                    fail(f"a {OL_SPARSE_SLOTS}-weight update published "
                         f"as {res.mode!r}")
                delta_ms.append(res.publish_s * 1e3)
                delta_bytes = res.payload_bytes
            swap_ms = []
            for _ in range(3):
                t0 = time.perf_counter()
                ep.hot_swap(mixed_model)
                swap_ms.append((time.perf_counter() - t0) * 1e3)
        finally:
            stop.set()
            close_endpoint("train while serving", ep)

        steps = [s for s, _, _, _ in Spy.history]
        modes = [m for _, m, _, _ in Spy.history]
        log(f"train while serving (phase 34): learner {learn_s:.3f} s for "
            f"{OL_WINDOWS} windows of {BATCH} rows = "
            f"{OL_WINDOWS / learn_s:.3f} windows/s; launches {launches}; "
            f"publishes at steps {steps}, modes {modes}, payload bytes "
            f"{[len(f['w']) * 4 + 4 for *_, f in Spy.history]}; checkpoint "
            f"cut host ms median {statistics.median(cuts):.3f} over "
            f"{len(cuts)} cuts [{card}]")
        for name in ("ell_margin", "ell_scatter_apply_fused"):
            if launches[name] != OL_WINDOWS:
                fail(f"{name} launched {launches[name]} times in the "
                     f"learner, expected {OL_WINDOWS} (one a step)")
        if launches["ell_scatter_apply"]:
            fail("the pair kernel ran on the learner's 8192-row grid")
        if steps != list(range(OL_EVERY, OL_WINDOWS + 1, OL_EVERY)):
            fail(f"publishes landed at steps {steps}")

        # (c) each cut's generation against the offline streamed fit
        for step, _, _, flat in Spy.history:
            def reader(upto=step):
                for w in windows[:upto]:
                    yield w.to_dict()

            state, _ = S.sgd_fit_outofcore(
                LOSSES["logistic"], reader, num_features=D_MAIN,
                config=cfg, device=DEVICE, **keys)
            if state.planned_impl != "ell-stream" or \
                    flat["w"].tobytes() != np.asarray(
                        state.coefficients, np.float32).tobytes() or \
                    flat["b"].tobytes() != np.float32(
                        state.intercept).tobytes():
                fail(f"the generation published at step {step} is not "
                     "the offline streamed fit over its windows")
        log(f"(c) each of the {len(steps)} generations = the offline "
            f"sgd_fit_outofcore on the card over its first T windows "
            f"(default W 8 offline, W {min(8, OL_EVERY)} in the learner), "
            f"bit for bit")

        # (d) every response is one published generation's transform
        gens = [mixed_model] + [model_with_params(mixed_model, {
            "w": f["w"], "b": f["b"]}) for *_, f in Spy.history]
        refs = [np.asarray(g.transform(pool)[0]["rawPrediction"])
                for g in gens]
        served_by = [0] * len(gens)
        for start, rows, _, raw in responses:
            hits = [i for i, ref in enumerate(refs)
                    if np.array_equal(ref[start:start + rows].view(np.uint64),
                                      raw.view(np.uint64))]
            if not hits:
                fail("train while serving: a response matches no "
                     "published generation")
            served_by[hits[-1]] += 1
        lat = np.asarray([r[2] for r in responses])
        lags = [t - event_at[s - 1] for s, t in landed]
        log(f"(d) {OL_CLIENTS} clients across the publishes: "
            f"{len(responses)} responses, dropped {len(errors)}, shed "
            f"{shed}; by generation (boot, then each cut) {served_by}; "
            f"held {len(responses) / held_wall:.1f} requests/s, p99 "
            f"{1e3 * np.quantile(lat, 0.99):.3f} ms [{card}]")
        if errors or shed:
            fail(f"train while serving: requests dropped {errors[:3]} or "
                 f"shed ({shed})")
        log(f"bench_online fields at the Criteo width: publish_delta_ms "
            f"{statistics.median(delta_ms):.3f} ({OL_SPARSE_SLOTS} weights, "
            f"{delta_bytes} payload bytes; the learner's cut publishes, w "
            f"whole: {cut_ms} ms), "
            f"publish_full_swap_ms {statistics.median(swap_ms):.3f} "
            f"(hot_swap: adapt + warm {SV_BUCKETS} + swap), "
            f"freshness_lag_ms {1e3 * statistics.median(lags):.3f} "
            f"(ingest of a cut's newest window -> its generation live), "
            f"held_requests_per_sec {len(responses) / held_wall:.1f}, "
            f"held_p99_ms {1e3 * np.quantile(lat, 0.99):.3f}, "
            f"dropped_requests {len(errors)} [{card}]")
        final = Spy.history[-1][3]["w"]

        # (e1) a crash inside a publish heals through resilient_fit
        ep = endpoint()
        try:
            run = learner(ep, stamped(), "crash")
            report = RecoveryReport()
            with FaultPlan().inject("serving.publish", at=1, kind="crash"):
                run.run(max_windows=OL_WINDOWS, report=report)
            noops = run.publisher.stats.skips
            e1 = (report.restarts, noops, served_w(ep).tobytes()
                  == final.tobytes(), [r.step for r in run.publish_log])
        finally:
            close_endpoint("train while serving (crash)", ep)
        # (e2) the process dies pulling a window, its newest WAL append torn
        ep = endpoint()
        try:
            plan = FaultPlan().inject("source.pull", at=OL_CRASH_PULL,
                                      kind="crash")
            first = learner(ep, plan.wrap_source(stamped()), "torn",
                            max_restarts=0)
            with plan:
                try:
                    first.run(max_windows=OL_WINDOWS)
                    fail("the source crash did not stop the learner")
                except InjectedCrash:
                    pass
            wal = os.path.join(ST_DIR, "torn", "wal")
            logged = sorted(f for f in os.listdir(wal)
                            if f.startswith("win-"))
            corrupt_file(os.path.join(wal, logged[-1]), mode="torn")
            second = learner(ep, stamped(OL_CRASH_PULL - 1), "torn")
            second.run(max_windows=OL_WINDOWS)
            e2 = (logged[-1], second.publisher.stats.skips,
                  served_w(ep).tobytes() == final.tobytes())
        finally:
            close_endpoint("train while serving (torn)", ep)
        log(f"(e) crash at serving.publish #1: restarts {e1[0]}, publishes "
            f"{e1[3]}, replayed cuts published as noop {e1[1]}, final "
            f"served bits = the uninterrupted run's {e1[2]}; torn WAL tail "
            f"({e2[0]}) after a crash at source pull {OL_CRASH_PULL}: "
            f"noop replays {e2[1]}, final bits equal {e2[2]}")
        if e1[0] != 1 or not e1[1] or not e1[2] or not e2[1] or not e2[2]:
            fail("train while serving: a crash did not heal to the "
                 "uninterrupted run's bits")
    finally:
        shutil.rmtree(ST_DIR, ignore_errors=True)
    log(f"phase 34: {time.perf_counter() - t_phase:.2f} s [{card}]")
    return {name: launches[name] for name in
            ("ell_margin", "ell_scatter_apply_fused", "ell_scatter_apply")}


def _serve_and_check(what, ep, reqs, refs, counter, kernel):
    """Serve ``reqs`` from 4 clients; every response must equal its
    reference bit for bit and ``kernel`` must launch once a served batch.
    Returns (launches, batches)."""
    before = counter[kernel]
    outs, batches, _ = serve_checked(what, ep, reqs, 4)
    for ref, out in zip(refs, outs):
        same_bits(what, ref, out)
    launches = counter[kernel] - before
    if launches != batches:
        fail(f"{what}: {kernel} launched {launches} times for {batches} "
             "served batches")
    return launches, batches


def publish_kernel_phase(torch, dev, card):
    """Phase 35: publishes into the KMeans endpoint (OnlineKMeans through
    a PublishingListener), the two index tenants and the Wide&Deep
    servables.  Returns the B5, B8 and B9 launches of the served
    batches."""
    import copy

    from flink_ml_tpu_torch import Table
    from flink_ml_tpu_torch.distance import DistanceMeasure
    from flink_ml_tpu_torch.iteration import (IterationBodyResult,
                                              IterationConfig, iterate)
    from flink_ml_tpu_torch.models.clustering.online_kmeans import (
        decayed_update)
    from flink_ml_tpu_torch.online import (DeltaEncoder, PublishingListener,
                                           apply_delta, diff_params,
                                           encode_and_publish,
                                           flatten_params, model_with_params,
                                           params_of_model)
    from flink_ml_tpu_torch.online.driver import publish_index_update
    from flink_ml_tpu_torch.ops import kmeans as K
    from flink_ml_tpu_torch.ops import retrieve as R
    from flink_ml_tpu_torch.retrieval.metrics import RecallProbe
    from flink_ml_tpu_torch.serving import SharedScheduler, serve_model

    t_phase = time.perf_counter()
    launches = {}
    rng = np.random.default_rng(35)

    # -- (a) OnlineKMeans generations into a KMeans endpoint (B5) ---------
    km = FITTED["kmeans"]
    pts = np.random.default_rng(0).normal(
        size=(OKM_WINDOWS * OKM_ROWS, D_KM)).astype(np.float32)
    q = rng.normal(size=(2048, D_KM)).astype(np.float32)
    sizes = rng.integers(1, 257, size=12)
    reqs = [Table({"features": q[s:s + n]})
            for s, n in zip(range(0, 2048, 160), sizes)]
    ep = serve_model(km, reqs[0], max_batch_rows=SV_BATCH,
                     max_wait_ms=SV_WAIT_MS)
    measure = DistanceMeasure.get_instance("euclidean")
    gens, served = [], [0, 0]
    try:
        K.reset_launch_counts()
        base = K.LAUNCHES["kmeans_update_stats"]

        class Checking(PublishingListener):
            """After each landed publish, serve the generation and hold
            it to KMeansModel with those centroids, offline."""

            def _publish(self, epoch, context):
                before = len(self.publish_log)
                super()._publish(epoch, context)
                if len(self.publish_log) == before:
                    return
                live = ep.registry.current("default").servable.model
                refs = [live.transform(r)[0] for r in reqs]
                n, b = _serve_and_check(
                    "OnlineKMeans generation", ep, reqs, refs, K.LAUNCHES,
                    "kmeans_assign_reduce")
                served[0] += n
                served[1] += b
                gens.append(self.publish_log[-1])

        listener = Checking(ep.delta_publisher(), publish_on="epoch",
                            params_of=lambda s: {"centroids": s[0]})

        def body(state, epoch, X):
            return IterationBodyResult(decayed_update(
                measure, K_KM, OKM_ALPHA, state[0], state[1],
                torch.from_numpy(X).to(dev)))

        windows = (pts[i * OKM_ROWS:(i + 1) * OKM_ROWS]
                   for i in range(OKM_WINDOWS))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        iterate(body, (torch.from_numpy(km._centroids).to(dev),
                       torch.zeros(K_KM, device=dev)), windows,
                config=IterationConfig(mode="hosted"), listeners=[listener])
        torch.cuda.synchronize()
        okm_s = time.perf_counter() - t0
        stats_launches = K.LAUNCHES["kmeans_update_stats"] - base
    finally:
        close_endpoint("OnlineKMeans endpoint", ep)
    launches["kmeans_assign_reduce"] = served[0]
    log(f"(a) OnlineKMeans (d {D_KM}, k {K_KM}, {OKM_WINDOWS} windows of "
        f"{OKM_ROWS} of phase 7's points, decay {OKM_ALPHA}) -> "
        f"PublishingListener -> KMeans endpoint: {len(gens)} generations "
        f"(modes {[g.mode for g in gens]}, payload bytes "
        f"{[g.payload_bytes for g in gens]}, publish ms "
        f"{[round(1e3 * g.publish_s, 3) for g in gens]}); {served[1]} served "
        f"batches, B5 launches {served[0]}, stats kernel {stats_launches}; "
        f"each generation's responses = KMeansModel with its centroids, "
        f"offline, bit for bit; {okm_s:.3f} s with the serving [{card}]")
    if len(gens) != OKM_WINDOWS or stats_launches:
        fail("OnlineKMeans: a window's generation did not land, or the "
             "stats kernel ran")

    # -- (b) the flat and IVF-PQ indexes as two scheduler tenants ----------
    _, queries = retrieval_corpus(RT_N, RT_D, 4096)
    indexes = {"flat": FITTED["flat"].with_options(nprobe=2),
               "pq": FITTED["pq"].with_options(nprobe=2)}
    for index in indexes.values():
        # the bench's publish leg runs with the drift re-anchor off
        # (bench.py:4370-4372): a fresh build's drift is already past
        # the default 0.25 (phase 12)
        index.drift_threshold = None
    kernel_of = {"flat": "retrieve_flat", "pq": "retrieve_pq"}
    sched = SharedScheduler(max_batch_rows=SV_BATCH, max_wait_ms=SV_WAIT_MS,
                            queue_capacity=SV_QUEUE)
    qreqs = [Table({"query": queries[s:s + n]})
             for s, n in zip(range(0, 3800, 160),
                             rng.integers(1, 129, size=20))]
    try:
        for name, index in indexes.items():
            sched.add_tenant(name, index, qreqs[0], slo="interactive")
        sched.start()
        for name, index in indexes.items():
            pub, enc = sched.delta_publisher(name), DeltaEncoder()
            publish_index_update(enc, pub, 1, "delta", index)
            other = "pq" if name == "flat" else "flat"
            other_gen = sched.registry.current(other).generation
            other_before = [sched.predict(other, r, timeout=SV_JOIN_S)
                            for r in qreqs[:4]]
            ids, vecs = index.stored_vectors()
            pick = rng.choice(len(ids), size=RT_EDIT_ROWS, replace=False)
            t0 = time.perf_counter()
            mode, nxt = index.updated(
                inserts=vecs[pick] + rng.normal(
                    scale=1e-3, size=vecs[pick].shape).astype(np.float32),
                insert_ids=np.arange(RT_EDIT_ROWS) + int(ids.max()) + 1,
                delete_ids=ids[pick])
            edit_ms = (time.perf_counter() - t0) * 1e3
            if mode != "delta":
                fail(f"index {name}: {RT_EDIT_ROWS} inserts and deletes "
                     f"re-anchored ({mode})")
            update = enc.encode(2, params_of_model(nxt), pub.stats)
            res = pub.apply(update)
            enc.ack()
            full_bytes = sum(a.nbytes for a in nxt.params.values())
            log(f"(b) index {name}: {RT_EDIT_ROWS} inserts + "
                f"{RT_EDIT_ROWS} deletes published as {res.mode}: leaves "
                f"{update.changed_leaves}, payload {res.payload_bytes} of "
                f"{full_bytes} bytes, {sorted((k, 'rows' if d.idx is not None else 'whole') for k, d in update.leaves.items())}; "
                f"index edit {edit_ms:.3f} ms, publish "
                f"{1e3 * res.publish_s:.3f} ms [{card}]")
            if res.mode != "delta":
                fail(f"index {name}: the edit did not publish as a delta")
            refs = []
            for r in qreqs:
                nn, dist = nxt.search(r["query"])
                refs.append(Table({"query": r["query"], "neighbors": nn,
                                   "distances": dist}))
            tenant = sched.tenant(name)
            b0 = tenant.metrics.batches.value
            before = R.LAUNCHES[kernel_of[name]]
            outs, _, _ = serve_checked(f"index tenant {name}", TenantView(
                sched, name), qreqs, 4)
            calls = R.LAUNCHES[kernel_of[name]] - before
            batches = tenant.metrics.batches.value - b0
            for ref, out in zip(refs, outs):
                same_bits(f"index tenant {name} after the delta", ref, out)
            if calls != batches:
                fail(f"index tenant {name}: {calls} retrieve calls for "
                     f"{batches} served batches")
            launches[kernel_of[name]] = calls
            if sched.registry.current(other).generation != other_gen:
                fail(f"a delta to {name} moved tenant {other}")
            for r, was in zip(qreqs[:4], other_before):
                same_bits(f"tenant {other} across {name}'s delta", was,
                          sched.predict(other, r, timeout=SV_JOIN_S))
            probe = RecallProbe(nxt, sample=0.25)
            probe.observe(np.concatenate([np.asarray(r["query"])
                                          for r in qreqs[:8]]),
                          neighbors=np.concatenate(
                              [np.asarray(o["neighbors"])
                               for o in outs[:8]]))
            value = probe.publish(tenant.metrics)
            gauge = sched.snapshot()[f"tenants.{name}.recall_probe"]
            log(f"(b) index tenant {name} after the delta: {calls} "
                f"retrieve calls for {batches} served batches; ids and "
                f"distance bits = search of the updated index; tenant "
                f"{other} untouched (generation {other_gen}); recall probe "
                f"{value:.4f}, gauge {gauge} [{card}]")
            if gauge != value:
                fail("the recall probe did not reach the tenant gauge")
    finally:
        close_endpoint("index tenants", sched)

    # -- (c) a Wide&Deep embedding delta, plain and through the row cache ---
    wd = FITTED["widedeep"]
    n_req = 24
    sizes = rng.integers(1, 17, size=n_req)
    total = int(sizes.sum())
    cat = np.stack([zipf_ids(rng, total, WD_VOCAB)
                    for _ in range(WD_FIELDS)], axis=1)
    dense = rng.normal(size=(total, WD_DENSE)).astype(np.float32)
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    wreqs = [Table({"denseFeatures": dense[s:s + n],
                    "catFeatures": cat[s:s + n]})
             for s, n in zip(starts, sizes)]
    p = params_of_model(wd)
    full_bytes = sum(a.nbytes for a in flatten_params(p).values())
    p2 = copy.copy(p)
    p2["emb"] = p["emb"].copy()
    rows = np.random.default_rng(353).choice(
        p["emb"].shape[0], size=WD_DELTA_ROWS, replace=False)
    p2["emb"][rows] += np.random.default_rng(354).normal(
        scale=0.01, size=(WD_DELTA_ROWS, p["emb"].shape[1])).astype(
        np.float32)
    t0 = time.perf_counter()
    delta = diff_params(p, p2, step=2)
    encode_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    apply_delta(p, delta)
    apply_ms = (time.perf_counter() - t0) * 1e3
    published = model_with_params(wd, p2)
    refs = [published.transform(r)[0] for r in wreqs]
    log(f"(c) Wide&Deep delta of {WD_DELTA_ROWS} embedding rows: payload "
        f"{delta.payload_bytes} bytes of {full_bytes} (leaves "
        f"{delta.changed_leaves}); diff_params {encode_ms:.1f} ms, "
        f"apply_delta {apply_ms:.1f} ms on the host [{card}]")
    for label, kw in (("plain", {}),
                      ("row cache", dict(
                          emb_cache=True, cache_block_rows=WD_CACHE_BLOCK,
                          cache_capacity_blocks=WD_CACHE_BLOCKS))):
        ep = serve_model(wd, wreqs[0], max_batch_rows=SV_BATCH,
                         max_wait_ms=SV_WAIT_MS, **kw)
        try:
            serve_checked(f"Wide&Deep ({label}) before", ep, wreqs, 4)
            old = ep.registry.current("default").servable
            pub, enc = ep.delta_publisher(), DeltaEncoder()
            encode_and_publish(enc, pub, 1, p)
            t0 = time.perf_counter()
            update = enc.encode(2, p2, pub.stats)
            enc_ms = (time.perf_counter() - t0) * 1e3
            res = pub.apply(update)
            enc.ack()
            live = ep.registry.current("default").servable
            outs, batches, _ = serve_checked(f"Wide&Deep ({label})", ep,
                                             wreqs, 4)
        finally:
            close_endpoint(f"Wide&Deep ({label})", ep)
        for ref, out in zip(refs, outs):
            same_bits(f"Wide&Deep ({label}) after the delta", ref, out)
        fresh = ""
        if label == "row cache":
            snap = live.cache.snapshot()
            fresh = (f"; a fresh row cache {live.cache is not old.cache} "
                     f"(faults {snap['block_faults']}, hit rate "
                     f"{snap['hit_rate']})")
            if live.cache is old.cache:
                fail("the cached Wide&Deep servable kept its old cache")
        log(f"(c) Wide&Deep ({label}): published as {res.mode}, encode "
            f"{enc_ms:.1f} ms, apply + rebind + swap "
            f"{1e3 * res.publish_s:.1f} ms; {n_req} requests in {batches} "
            f"batches = the offline transform of the published model bit "
            f"for bit{fresh} [{card}]")
        if res.mode != "delta":
            fail(f"Wide&Deep ({label}): the row update did not publish as "
                 "a delta")
    log(f"phase 35: {time.perf_counter() - t_phase:.2f} s [{card}]")
    return launches


class TenantView:
    """One tenant of a scheduler with an endpoint's ``predict``."""

    def __init__(self, sched, name):
        self.sched, self.name = sched, name
        self.metrics = sched.tenant(name).metrics

    def predict(self, table, timeout=None):
        return self.sched.predict(self.name, table, timeout=timeout)


def failover_phase(torch, dev, card):
    """Phase 36: bench_failover's kill under 16 closed-loop clients,
    unreplicated and 2-way replicated, with phase 31's KMeans on the
    victim chip; the brownout ladder, a requeued KMeans batch, and an
    autoscale tick racing the failover.  Returns B5's served launches."""
    import threading

    from flink_ml_tpu_torch import Table
    from flink_ml_tpu_torch.autoscale import (AutoscaleController,
                                              PlacementStore, PolicyConfig)
    from flink_ml_tpu_torch.obs.tree import MetricsTree
    from flink_ml_tpu_torch.ops import kmeans as K
    from flink_ml_tpu_torch.robustness import (FaultPlan, InjectedChipDown)
    from flink_ml_tpu_torch.serving import (DISPATCH_SCOPE, FailoverDriver,
                                            ServingOverloadedError,
                                            SharedScheduler)

    t_phase = time.perf_counter()
    rng = np.random.default_rng(23)
    lr = lr_from_weights(rng.normal(size=FO_D), 0.1)
    km = FITTED["kmeans"]
    feats = Table({"features": rng.normal(size=(1024, FO_D)).astype(
        np.float32)})
    kpts = Table({"features": rng.normal(size=(1024, D_KM)).astype(
        np.float32)})
    b5 = [0, 0]                       # launches, batches

    def run_variant(replicas):
        clock = ShiftedClock()
        sched = SharedScheduler(max_batch_rows=64, max_wait_ms=0.5,
                                queue_capacity=1 << 13)
        try:
            sched.add_tenant("inter", lr, feats.take(2), slo="interactive")
            sched.add_tenant("bulk0", lr, feats.take(2), slo="bulk")
            sched.add_tenant("km", km, kpts.take(2), slo="standard")
            store = PlacementStore(4, clock=clock)
            store.publish({"inter": [3], "km": [3], "bulk0": [0]}, 0)
            driver = FailoverDriver(sched, store, chips=[0, 1, 2, 3],
                                    clock=clock,
                                    hysteresis_s=FO_HYSTERESIS_S)
            if replicas > 1:
                driver.ensure_replicas("inter", replicas)
            sched.start()
            drops, served, bulk_futs, bulk_sheds = [], [], [], [0]
            lock = threading.Lock()

            def sweep(samples):
                def client(worker):
                    crng = np.random.default_rng(300 + worker)
                    mine, got = [], []
                    try:
                        for i in range(FO_PER_PHASE):
                            start = int(crng.integers(0, 1000))
                            rows = int(crng.integers(1, 5))
                            name, pool = (("km", kpts) if i % 2
                                          else ("inter", feats))
                            req = pool.slice(start, start + rows)
                            t0 = time.perf_counter()
                            out = sched.predict(name, req, timeout=120)
                            if name == "inter":
                                mine.append(time.perf_counter() - t0)
                            got.append((name, req, out))
                            if i % 4 == 0:
                                try:
                                    fut = sched.submit("bulk0",
                                                       feats.take(8))
                                    with lock:
                                        bulk_futs.append(fut)
                                except ServingOverloadedError:
                                    with lock:
                                        bulk_sheds[0] += 1
                            time.sleep(0.001)
                    except Exception as exc:  # noqa: BLE001
                        with lock:
                            drops.append(repr(exc)[:200])
                    with lock:
                        samples.extend(mine)
                        served.extend(got)

                run_clients(f"failover sweep ({replicas} replicas)",
                            FO_CLIENTS, client)

            def p99(samples):
                return 1e3 * float(np.quantile(np.asarray(samples), 0.99))

            sweep([])                                  # warm
            km_t = sched.tenant("km")
            k0, kb0 = K.LAUNCHES["kmeans_assign_reduce"], \
                km_t.metrics.batches.value
            served.clear()
            before, during, after = [], [], []
            sweep(before)
            plan = FaultPlan(seed=20).inject(DISPATCH_SCOPE, at=FO_KILL_AT,
                                             kind="chip_down")
            with plan:
                sweep(during)
            level = driver.brownout_level
            sweep(after)
            for fut in bulk_futs:
                fut.result(SV_JOIN_S)
            torch.cuda.synchronize()
            b5[0] += K.LAUNCHES["kmeans_assign_reduce"] - k0
            b5[1] += km_t.metrics.batches.value - kb0
            if len(driver.reports) != 1:
                fail(f"failover: {len(driver.reports)} failovers (fires "
                     f"{plan.fires})")
            rep = driver.reports[0]
            sheds = sched.shed_counts()
            # the ladder: the chip comes back; level holds through the
            # hysteresis window, then steps down
            driver.health.recover(rep.dead_chips[0])
            driver.tick()
            held = driver.brownout_level
            clock.advance(FO_HYSTERESIS_S)
            driver.tick()
            return dict(rep=rep, level=level, held=held,
                        settled=driver.brownout_level, sheds=sheds,
                        bulk_sheds=bulk_sheds[0], drops=drops,
                        served=list(served), p99=(p99(before), p99(during),
                                                  p99(after)),
                        requeued=sched.snapshot()["requeued_requests"],
                        km_requeued=km_t.metrics.requeued.value,
                        restores=driver.snapshot()["restores"])
        finally:
            close_endpoint(f"failover ({replicas} replicas)", sched)

    K.reset_launch_counts()
    variants = {1: run_variant(1), 2: run_variant(2)}
    for replicas, v in variants.items():
        rep = v["rep"]
        for name, req, out in v["served"]:
            model = km if name == "km" else lr
            same_bits(f"failover ({replicas} replicas, {name})",
                      model.transform(req)[0], out)
        log(f"failover, {replicas} replica(s): chip {rep.dead_chips} lost "
            f"at a dispatch boundary ({rep.cause}), recovery wall "
            f"{rep.wall_s:.6f} s, requeued {rep.requeued} (scheduler "
            f"{v['requeued']}, KMeans tenant {v['km_requeued']}), moved "
            f"{rep.moved}, kept a replica {rep.replicated}, placement "
            f"generation {rep.generation}; brownout {v['level']} (held "
            f"{v['held']} through the dwell, {v['settled']} after "
            f"{FO_HYSTERESIS_S} s; restores {v['restores']}); shed counts "
            f"{v['sheds']}; dropped {len(v['drops'])}; interactive p99 ms "
            f"before/during/after {v['p99'][0]:.3f} / {v['p99'][1]:.3f} / "
            f"{v['p99'][2]:.3f}; {len(v['served'])} responses bit for bit "
            f"the offline transform [{card}]")
        if v["drops"] or v["sheds"]["interactive"] or \
                v["sheds"]["standard"]:
            fail(f"failover: dropped {v['drops'][:3]} or a non-bulk shed "
                 f"{v['sheds']}")
        if v["level"] != 1 or v["held"] != 1 or v["settled"] != 0:
            fail("failover: the brownout ladder did not rise to 1, hold "
                 "through the hysteresis window and settle to 0")
        if not v["bulk_sheds"]:
            fail("failover: the brownout shed no bulk request")
    solo, dual = variants[1]["rep"], variants[2]["rep"]
    log(f"failover recovery wall: unreplicated {solo.wall_s:.6f} s, 2-way "
        f"replicated {dual.wall_s:.6f} s, ratio "
        f"{dual.wall_s / solo.wall_s:.4f} [{card}]")
    if dual.moved != ("km",) or "inter" not in dual.replicated \
            or "inter" not in solo.moved:
        fail("failover: the replicated variant did not keep its replica")

    # a requeued KMeans batch launches B5 again, bit for bit
    sched = SharedScheduler(max_batch_rows=64, max_wait_ms=0.0)
    try:
        sched.add_tenant("km", km, kpts.take(2), slo="interactive")
        store = PlacementStore(2)
        store.publish({"km": [1]}, 0)
        driver = FailoverDriver(sched, store, chips=[0, 1])
        reqs = [kpts.slice(8 * i, 8 * i + 1 + i) for i in range(6)]
        futs = [sched.submit("km", r) for r in reqs]
        k0 = K.LAUNCHES["kmeans_assign_reduce"]
        with FaultPlan().inject(DISPATCH_SCOPE, at=0, kind="chip_down"):
            while True:
                formed = sched._next_batch(timeout=0.0)
                if formed is None:
                    break
                sched._dispatch(*formed)
        torch.cuda.synchronize()
        relaunch = K.LAUNCHES["kmeans_assign_reduce"] - k0
        b5[0] += relaunch
        b5[1] += sched.tenant("km").metrics.batches.value
        for r, f in zip(reqs, futs):
            same_bits("requeued KMeans batch", km.transform(r)[0],
                      f.result(0))
        requeued = sched.snapshot()["requeued_requests"]
    finally:
        sched.close()
    log(f"a KMeans batch requeued by the chip loss: {requeued} requests "
        f"requeued, B5 launched {relaunch} time(s) for the retried batch, "
        f"responses = the offline transform bit for bit [{card}]")
    if requeued != len(reqs) or relaunch != 1:
        fail("the requeued KMeans batch did not relaunch B5 once")

    # an autoscale tick racing the failover: one PlacementConflict retry
    clock = ShiftedClock()
    sched = SharedScheduler(max_batch_rows=64, max_wait_ms=0.0)
    try:
        sched.add_tenant("x", lr, feats.take(2), slo="interactive")
        sched.add_tenant("km", km, kpts.take(2), slo="standard")
        signals = MetricsTree().register("scheduler", {
            "tenants.x.slo": "interactive",
            "tenants.x.latency_p99_ms": 500.0})
        store = PlacementStore(4, clock=clock)
        store.publish({"x": [3], "km": [3]}, 1)
        driver = FailoverDriver(sched, store, chips=[0, 1, 2, 3],
                                clock=clock)
        controller = AutoscaleController.build(
            signals, store=store, scheduler=sched, health=driver.health,
            clock=clock, policy_config=PolicyConfig(p99_target_ms=50.0,
                                                    total_chips=4))
        real, raced = store.publish, []

        def racing(servables, workers, *, expected_generation=None):
            if expected_generation is not None and not raced:
                raced.append(None)
                raced[0] = controller.tick()
            return real(servables, workers,
                        expected_generation=expected_generation)

        store.publish = racing
        rep = driver.on_chip_fault(InjectedChipDown("killed under a tick"))
        pmap = store.current()
    finally:
        sched.close()
    log(f"an autoscale tick racing the failover: tick {raced[0].kind}, "
        f"failover conflicts {rep.conflicts}, placement generation "
        f"{pmap.generation}, learner workers {pmap.learner_workers}, "
        f"placement {dict(pmap.servables)}")
    if rep.conflicts != 1 or pmap.learner_workers != 0 or any(
            3 in chips for chips in pmap.servables.values()):
        fail("the racing autoscale tick did not resolve in one "
             "PlacementConflict retry onto the survivors")
    if b5[0] != b5[1]:
        fail(f"failover: B5 launched {b5[0]} times for {b5[1]} KMeans "
             "batches")
    log(f"phase 36: {time.perf_counter() - t_phase:.2f} s [{card}]")
    return {"kmeans_assign_reduce": b5[0]}


# The boosted trees and the instance classifiers (phases 37-39):
# bench_gbt's shape (bench.py:1340-1357)
GB_ROWS, GB_D, GB_SEED = 1 << 19, 32, 29
GB_TREES, GB_DEPTH, GB_BINS, GB_LR = 8, 5, 64, 0.2
GB_HIST_TOL = dict(rtol=1e-4, atol=1e-5)   # bench.py:1388-1391
GB_CPU_LOSS_RTOL = 1e-3       # the card's training log-loss vs the CPU's
GB_STREAM_BATCH = 1 << 16
GB_STREAM_LOSS_RTOL = 1e-4    # streamed vs in-core training log-loss
GB_SOFT_ROWS = 1 << 16
GB_HIST_REPS = 10
GB_EST_ROWS = 1 << 16         # phase 39's estimator fits
NB_ROWS, NB_D, NB_CLASSES = 1 << 16, 64, 3
NB_TOL = dict(rtol=1e-5, atol=1e-3)
KN_TRAIN, KN_D, KN_Q, KN_K = 1 << 17, 64, 4096, 5
KN_TIE = 1e-6        # k-th vs (k+1)-th squared distance, of |q|^2 + max|x|^2
OV_ROWS, OV_D, OV_CLASSES = 1 << 15, 16, 4
OV_TOL = dict(rtol=1e-3, atol=1e-4)        # bench.py:266
GB_SERVE_SIZES = (1, 2, 3, 5, 8, 9, 16, 17, 31, 32, 33, 63, 64, 65, 100,
                  127, 128, 129, 200, 255, 256)


def gbt_rows(n, d, seed):
    """bench_gbt's rows: N(0,1) f32 features, label ``X0 + 0.5 X1 X2 +
    0.3 noise > 0`` (``bench.py:1346-1349``)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] * X[:, 2]
         + 0.3 * rng.normal(size=n) > 0).astype(np.float64)
    return X, y


def gbt_grad_hess(y, pred):
    """``bench.py:1351-1353``."""
    p = 1.0 / (1.0 + np.exp(-pred))
    return (p - y), np.maximum(p * (1.0 - p), 1e-16)


def log_loss(y, margins):
    return float(np.mean(np.logaddexp(0.0, margins) - y * margins))


def forest_losses(G, X, y, forest, dev):
    """The training log-loss after each tree, from margins summed as
    ``train_forest`` sums them (base + lr * tree output, in f64)."""
    binned = G.apply_bins(X, forest.bin_edges)
    depth = int(np.log2(forest.feature.shape[1] + 1)) - 1
    outs = G._tree_preds(binned, forest.feature, forest.threshold,
                         forest.value, depth, dev)
    m = np.full(len(X), forest.base_score)
    losses = []
    for out in outs:
        m = m + forest.learning_rate * out.astype(np.float64)
        losses.append(log_loss(y, m))
    return losses


def numpy_forest(X, forest):
    """``predict_forest`` in numpy: searchsorted bins, each tree walked in
    arrays, its f32 outputs summed as ``predict_forest`` sums them."""
    binned = np.stack([np.searchsorted(forest.bin_edges[j], X[:, j],
                                       side="left")
                       for j in range(X.shape[1])], axis=1)
    n, nodes = len(X), forest.feature.shape[1]
    depth = int(np.log2(nodes + 1)) - 1
    rows = np.arange(n)
    pred = np.full(n, forest.base_score)
    for feature, threshold, value in zip(forest.feature, forest.threshold,
                                         forest.value):
        node = np.zeros(n, np.int64)
        out = np.zeros(n, np.float32)
        settled = np.zeros(n, bool)
        for _ in range(depth + 1):
            feat = feature[node]
            leaf = feat < 0
            out = np.where(leaf & ~settled, value[node], out)
            settled |= leaf
            right = binned[rows, np.maximum(feat, 0)] > threshold[node]
            node = np.where(settled, node,
                            np.minimum(2 * node + 1 + right, nodes - 1))
        pred += forest.learning_rate * out
    return pred


def same_forest(a, b):
    return all(np.array_equal(getattr(a, k), getattr(b, k))
               for k in ("feature", "threshold", "value"))


def split_differences(a, b):
    """Nodes whose split differs: the feature, or a split's threshold."""
    split = (a.feature >= 0) | (b.feature >= 0)
    return int(np.sum((a.feature != b.feature)
                      | (split & (a.threshold != b.threshold))))


def gbt_device_tree(torch, G, binned, g, h, d, cfg):
    """``_train_one_tree``'s device work with no host read between its
    launches: the levels, the leaf values, the tree rows, the in-sample
    walk."""
    impl = G.resolve_hist_impl()
    ids = torch.zeros((binned.shape[0],), dtype=torch.int32,
                      device=binned.device)
    splits, level_ids = [], [ids]
    for level in range(cfg.max_depth):
        f, b, gain, ids = G._build_level(
            binned, ids, g, h, 2 ** level, d, cfg.max_bins, cfg.reg_lambda,
            cfg.min_child_weight, hist_impl=impl)
        splits.append((f, b, gain))
        level_ids.append(ids)
    vals = [G._leaf_values(level_ids[level], g, h, 2 ** level,
                           cfg.reg_lambda)
            for level in range(cfg.max_depth + 1)]
    rows = G._tree_rows(splits, vals, cfg.max_depth)
    return G._predict_tree_device(binned, *rows, cfg.max_depth)


def gbt_phase(torch, dev, card, timer):
    """Phase 37: GBT in core at bench_gbt's shape: two fits on the card
    bit for bit, both histogram forms timed by fit and by level against
    float64 numpy histograms and the bytes bound, the log-loss falling and
    within GB_CPU_LOSS_RTOL of the CPU fit, the host share of a tree,
    ``predict_forest`` against a numpy walk, a 3-class softmax fit."""
    from flink_ml_tpu_torch.models.common import gbt as G

    t_phase = time.perf_counter()
    if torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 is on: the one-hot histogram product must run in f32")
    n, d, bins = GB_ROWS, GB_D, GB_BINS
    X, y = gbt_rows(n, d, GB_SEED)
    cfg = G.GBTConfig(num_trees=GB_TREES, max_depth=GB_DEPTH,
                      max_bins=bins, learning_rate=GB_LR)
    impl = G.resolve_hist_impl()
    other = "mxu" if impl == "segsum" else "segsum"

    def fit(form):
        old = G.HIST_IMPL
        G.HIST_IMPL = form
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            forest = G.train_forest(X, y, gbt_grad_hess, 0.0, cfg,
                                    device=dev)
            return forest, time.perf_counter() - t0
        finally:
            G.HIST_IMPL = old

    forest, cold_s = fit("auto")
    runs = {impl: [], other: []}
    for form in (impl, other, other, impl):
        runs[form].append(fit(form))
    repeat = {form: all(same_forest(f, rs[0][0]) for f, _ in rs)
              for form, rs in runs.items()}
    repeat[impl] = repeat[impl] and same_forest(forest, runs[impl][0][0])
    rate = {form: GB_TREES / statistics.median(s for _, s in rs)
            for form, rs in runs.items()}
    t0 = time.perf_counter()
    G.bin_features(X, bins)
    bin_s = time.perf_counter() - t0
    loop = GB_TREES / (statistics.median(s for _, s in runs[impl]) - bin_s)
    log(f"GBT in core ({n} x {d}, {GB_TREES} trees, depth {GB_DEPTH}, "
        f"{bins} bins, lr {GB_LR}; 'auto' = {impl} on the card): cold fit "
        f"{cold_s:.3f} s; warm trees/s {impl} {rate[impl]:.3f}, {other} "
        f"{rate[other]:.3f} (median of 2 fits each, in turns); of a fit's "
        f"wall the host binning (quantile edges and searchsorted, numpy) "
        f"{bin_s:.3f} s, the boosting loop alone {loop:.3f} trees/s; fits "
        f"repeat bit for bit {repeat}; splits that differ between the "
        f"forms {split_differences(runs[impl][0][0], runs[other][0][0])} "
        f"[{card}]")
    RATES["gbt_trees_per_sec"] = rate[impl]
    if not all(repeat.values()):
        fail("GBT: two fits on the card gave different forests")
    if not np.any(forest.feature[0] >= 0):
        fail("GBT: the fit grew no splits")

    losses = forest_losses(G, X, y, forest, dev)
    t0 = time.perf_counter()
    cpu = G.train_forest(X, y, gbt_grad_hess, 0.0, cfg, device="cpu")
    cpu_s = time.perf_counter() - t0
    cpu_losses = forest_losses(G, X, y, cpu, "cpu")
    worst = max(abs(a - b) / b for a, b in zip(losses, cpu_losses))
    log(f"GBT training log-loss by tree: card {[round(v, 6) for v in losses]}"
        f", CPU {[round(v, 6) for v in cpu_losses]} (worst relative gap "
        f"{worst:.3e}, tolerance {GB_CPU_LOSS_RTOL}); splits that differ "
        f"{split_differences(forest, cpu)}; the CPU fit {cpu_s:.3f} s")
    if not all(b < a for a, b in zip([log_loss(y, np.zeros(n))] + losses,
                                     losses)):
        fail(f"GBT: the training log-loss did not fall tree by tree: "
             f"{losses}")
    if worst > GB_CPU_LOSS_RTOL:
        fail("GBT: the card's fit left the CPU fit's log-loss")

    # the first tree's level histograms: both forms against a float64
    # numpy histogram and each other, and timed beside the bytes bound
    binned_host = G.apply_bins(X, forest.bin_edges)
    binned = torch.from_numpy(binned_host).to(dev)
    g, h = (a.astype(np.float32) for a in gbt_grad_hess(y, np.zeros(n)))
    gd, hd = torch.from_numpy(g).to(dev), torch.from_numpy(h).to(dev)
    f0 = torch.from_numpy(forest.feature[0]).to(dev)
    thr0 = torch.from_numpy(forest.threshold[0]).to(dev)
    bound_ms = (n * d * 4 + 3 * n * 4) / HBM_BYTES_PER_S * 1e3
    hist_ms = {}
    for level in range(GB_DEPTH):
        n_nodes = 2 ** level
        ids = G._route_to_level(binned, f0, thr0, level)
        ids_host = ids.cpu().numpy()
        live = ids_host >= 0
        keys = (ids_host[live, None] * (d * bins)
                + np.arange(d)[None, :] * bins + binned_host[live]).ravel()
        want = [np.bincount(keys, weights=np.repeat(v[live].astype(
            np.float64), d), minlength=n_nodes * d * bins).reshape(
            n_nodes, d, bins) for v in (g, h)]
        got = {form: [t.cpu().numpy() for t in G._HIST_IMPLS[form](
            binned, ids, gd, hd, n_nodes, d, bins)] for form in G._HIST_IMPLS}
        errs = {form: max(float(np.max(np.abs(a - w)))
                          for a, w in zip(got[form], want))
                for form in got}
        ok = all(np.allclose(a, w, **GB_HIST_TOL)
                 for form in got for a, w in zip(got[form], want))
        ok = ok and all(np.allclose(a, b, **GB_HIST_TOL) for a, b in
                        zip(got["segsum"], got["mxu"]))
        hist_ms[n_nodes] = {form: timer.ms(
            lambda form=form: G._HIST_IMPLS[form](binned, ids, gd, hd,
                                                  n_nodes, d, bins),
            reps=GB_HIST_REPS, warm=2) for form in G._HIST_IMPLS}
        log(f"GBT level {level} (n_nodes {n_nodes}): segsum "
            f"{hist_ms[n_nodes]['segsum']:.4f} ms, mxu "
            f"{hist_ms[n_nodes]['mxu']:.4f} ms, bound {bound_ms:.4f} ms "
            f"(bytes: binned rows, g, h, node ids); max |hist - float64| "
            f"{errs} (rtol {GB_HIST_TOL['rtol']}, atol "
            f"{GB_HIST_TOL['atol']}) [{card}]")
        if not ok:
            fail(f"GBT level {level}: a histogram form left the float64 "
                 "histogram or the other form")
    RATES["gbt_hist_ms"] = hist_ms

    # the host share of a tree: one tree's wall (host gradients, copies,
    # the tree, the in-sample read) against its device work enqueued with
    # no host read in between
    m = np.full(n, 0.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gh = [a.astype(np.float32) for a in gbt_grad_hess(y, m)]
    grad_s = time.perf_counter() - t0
    g1, h1 = (torch.from_numpy(a).to(dev) for a in gh)
    *_, tp = G._train_one_tree(binned, g1, h1, d, cfg)
    m = m + GB_LR * tp.cpu().numpy().astype(np.float64)
    tree_ms = (time.perf_counter() - t0) * 1e3
    device_ms = []
    for _ in range(4):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        gbt_device_tree(torch, G, binned, g1, h1, d, cfg)
        end.record()
        torch.cuda.synchronize()
        device_ms.append(start.elapsed_time(end))
    dev_ms = statistics.median(device_ms[1:])
    log(f"GBT host share of a tree: {1 - dev_ms / tree_ms:.3f} (tree wall "
        f"{tree_ms:.3f} ms, of it host gradients {grad_s * 1e3:.3f} ms; "
        f"the tree's device work alone {dev_ms:.3f} ms) [{card}]")

    Xh, _ = gbt_rows(50000, d, seed=30)
    got = G.predict_forest(Xh, forest, device=dev)
    if not np.array_equal(got, numpy_forest(Xh.astype(np.float64),
                                            forest)):
        fail("GBT: predict_forest on the card differs from a numpy walk")
    log("GBT predict_forest on the card (50000 held-out rows) = a numpy "
        "walk of the same forest, bit for bit")

    Xs, _ = gbt_rows(GB_SOFT_ROWS, d, seed=31)
    ys = ((Xs[:, 0] > 0).astype(np.int64)
          + (Xs[:, 1] + Xs[:, 2] > 0.5).astype(np.int64))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    soft = G.train_forest_softmax(Xs, ys, 3, cfg, device=dev)
    soft_s = time.perf_counter() - t0
    probs = G._softmax_rows(G.predict_forest_softmax(Xs, soft, device=dev))
    sum_err = float(np.max(np.abs(probs.sum(axis=1) - 1.0)))
    acc = float(np.mean(np.argmax(probs, axis=1) == ys))
    log(f"GBT softmax (3 classes, {GB_SOFT_ROWS} rows): {GB_TREES * 3} "
        f"trees in {soft_s:.3f} s ({GB_TREES * 3 / soft_s:.3f} trees/s), "
        f"training accuracy {acc:.4f}, max |sum p - 1| {sum_err:.3e} "
        f"(tolerance 1e-9) [{card}]")
    if sum_err > 1e-9 or acc < 0.9:
        fail("GBT softmax: probabilities do not sum to 1 or it did not "
             "learn")
    log(f"phase 37: {time.perf_counter() - t_phase:.2f} s [{card}]")
    return X, y, cfg, forest, losses


def gbt_stream_phase(torch, dev, card, X, y, cfg, incore, incore_losses):
    """Phase 38: the same rows streamed from a DataCacheWriter cache in
    2^16-row batches: W 8 = W 1 and a rerun bit for bit, the log-loss
    within GB_STREAM_LOSS_RTOL of the in-core fit's, streamed trees/s."""
    import shutil

    from flink_ml_tpu_torch.data.datacache import (DataCacheReader,
                                                   DataCacheWriter)
    from flink_ml_tpu_torch.models.common import gbt as G

    t_phase = time.perf_counter()
    shutil.rmtree(ST_DIR, ignore_errors=True)
    cache = os.path.join(ST_DIR, "gbt")
    try:
        writer = DataCacheWriter(cache)
        for s in range(0, len(y), GB_STREAM_BATCH):
            writer.append({"features": X[s:s + GB_STREAM_BATCH],
                           "label": y[s:s + GB_STREAM_BATCH]})
        writer.finish()

        def fit(W):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            forest = G.train_forest_outofcore(
                lambda: DataCacheReader(cache, batch_rows=GB_STREAM_BATCH),
                gbt_grad_hess, 0.0,
                dataclasses.replace(cfg, steps_per_dispatch=W),
                work_dir=os.path.join(ST_DIR, "work"), sample_rows=len(y),
                batch_device_rows=GB_STREAM_BATCH, device=dev)
            return forest, time.perf_counter() - t0

        w1, w1_s = fit(1)
        w8, w8_s = fit(8)
        again, again_s = fit(8)
    finally:
        shutil.rmtree(ST_DIR, ignore_errors=True)
    losses = forest_losses(G, X, y, w8, dev)
    gap = abs(losses[-1] - incore_losses[-1]) / incore_losses[-1]
    log(f"GBT streamed ({len(y) // GB_STREAM_BATCH} batches of "
        f"{GB_STREAM_BATCH}): W 8 = W 1 bit for bit {same_forest(w8, w1)}, "
        f"a rerun bit for bit {same_forest(again, w8)}; training log-loss "
        f"{losses[-1]:.6f} vs in core {incore_losses[-1]:.6f} (relative "
        f"{gap:.3e}, tolerance {GB_STREAM_LOSS_RTOL}); splits that differ "
        f"from the in-core forest {split_differences(w8, incore)}; trees/s "
        f"W 1 {GB_TREES / w1_s:.3f}, W 8 {GB_TREES / w8_s:.3f}, W 8 again "
        f"{GB_TREES / again_s:.3f} [{card}]")
    RATES["gbt_stream_trees_per_sec"] = GB_TREES / again_s
    if not same_forest(w8, w1) or not same_forest(again, w8):
        fail("GBT streamed: W 8 and W 1 (or a rerun) differ")
    if gap > GB_STREAM_LOSS_RTOL:
        fail("GBT streamed: the log-loss left the in-core fit's")
    log(f"phase 38: {time.perf_counter() - t_phase:.2f} s [{card}]")


def knn_reference(train, classes, queries, k, n_classes):
    """The float64 k-nearest vote, and for each query whether its k-th and
    (k+1)-th squared distances tie within KN_TIE, with the classes a
    valid k-set may vote for there."""
    x2 = np.sum(train * train, axis=1)
    scale = float(x2.max())
    votes, ties = [], {}
    for s in range(0, len(queries), 256):
        q = queries[s:s + 256]
        d2 = (np.sum(q * q, axis=1)[:, None] - 2.0 * (q @ train.T)
              + x2[None, :])
        near = np.argpartition(d2, k, axis=1)[:, :k + 1]
        for i in range(len(q)):
            row = d2[i, near[i]]
            order = near[i][np.argsort(row, kind="stable")]
            dk, dk1 = d2[i, order[k - 1]], d2[i, order[k]]
            counts = np.bincount(classes[order[:k]], minlength=n_classes)
            votes.append(int(np.argmax(counts)))
            tol = KN_TIE * (float(q[i] @ q[i]) + scale)
            if dk1 - dk <= tol:
                forced = np.flatnonzero(d2[i] < dk - tol)
                tied = np.flatnonzero(np.abs(d2[i] - dk) <= tol)
                ties[s + i] = valid_votes(classes, forced, tied, k,
                                          n_classes)
    return np.asarray(votes), ties


def valid_votes(classes, forced, tied, k, n_classes):
    """The winning classes of every k-set: the forced neighbours plus any
    ``k - len(forced)`` of the tied ones."""
    from itertools import combinations

    need = k - len(forced)
    base = np.bincount(classes[forced], minlength=n_classes)
    wins = set()
    for pick in combinations(tied.tolist(), need):
        counts = base + np.bincount(classes[list(pick)],
                                    minlength=n_classes)
        wins.add(int(np.argmax(counts)))
    return wins


def classifiers_phase(torch, dev, card):
    """Phase 39: GBTClassifier (binary, 3 classes) and GBTRegressor on the
    card against the CPU; NaiveBayes at smoothing 0 against float64
    scores; KNN at k 5 against a float64 vote; OneVsRest over
    LogisticRegression against the CPU; a StandardScaler -> GBTClassifier
    pipeline; a served GBT model equal to its offline transform in every
    bucket."""
    from flink_ml_tpu_torch import Pipeline, Table
    from flink_ml_tpu_torch.models.classification import (
        GBTClassifier, KNNClassifier, LogisticRegression, NaiveBayes,
        OneVsRest)
    from flink_ml_tpu_torch.models.classification.naivebayes import _scores
    from flink_ml_tpu_torch.models.feature import StandardScaler
    from flink_ml_tpu_torch.models.regression import GBTRegressor
    from flink_ml_tpu_torch.serving import ModelRegistry, ServingEndpoint

    t_phase = time.perf_counter()
    X, y = gbt_rows(GB_EST_ROWS, GB_D, seed=33)
    noise = np.random.default_rng(34).normal(size=len(y))
    targets = {
        "binary": (GBTClassifier, y),
        "3 classes": (GBTClassifier, (X[:, 0] > 0).astype(np.int64)
                      + (X[:, 1] + X[:, 2] > 0.5).astype(np.int64)),
        "regressor": (GBTRegressor, X[:, 0] + 0.5 * X[:, 1] * X[:, 2]
                      + 0.3 * noise),
    }

    def est(cls, device):
        return (cls(device=device).set_max_iter(GB_TREES)
                .set_max_depth(GB_DEPTH).set_max_bins(GB_BINS)
                .set_learning_rate(GB_LR))

    def loss_of(name, out, target):
        if name == "regressor":
            return float(np.mean((out["prediction"] - target) ** 2))
        p = np.clip(np.asarray(out["rawPrediction"], np.float64), 1e-15, 1)
        if p.ndim == 1:
            return float(-np.mean(target * np.log(p)
                                  + (1 - target) * np.log1p(-p)))
        return float(-np.mean(np.log(p[np.arange(len(target)), target])))

    feats = Table({"features": X})
    gbt_binary = None
    for name, (cls, target) in targets.items():
        table = Table({"features": X, "label": target})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card_model = est(cls, DEVICE).fit(table)
        card_s = time.perf_counter() - t0
        cpu_model = est(cls, "cpu").fit(table)
        a, b = (m.transform(feats)[0] for m in (card_model, cpu_model))
        la, lb = loss_of(name, a, target), loss_of(name, b, target)
        if name == "regressor":
            agree = (f"max |prediction - CPU's| "
                     f"{float(np.max(np.abs(a['prediction'] - b['prediction']))):.3e}")
        else:
            agree = (f"predictions equal on "
                     f"{float(np.mean(a['prediction'] == b['prediction'])):.4f}"
                     f" of the rows")
        log(f"{cls.__name__} ({name}, {GB_EST_ROWS} x {GB_D}) on the card: "
            f"fit {card_s:.3f} s; training loss {la:.6f} vs the CPU fit's "
            f"{lb:.6f} (relative {abs(la - lb) / lb:.3e}, tolerance "
            f"{GB_CPU_LOSS_RTOL}); {agree} [{card}]")
        if abs(la - lb) > GB_CPU_LOSS_RTOL * lb:
            fail(f"{cls.__name__} ({name}): the card's fit left the CPU's")
        if name == "binary":
            gbt_binary = card_model
            binary_acc = float(np.mean(a["prediction"] == target))

    # NaiveBayes at smoothing 0: per-class Poisson counts with features a
    # class never uses, so log-likelihoods of -inf reach the product
    rng = np.random.default_rng(35)
    rates = rng.gamma(2.0, 1.0, size=(NB_CLASSES, NB_D))
    rates[rng.random((NB_CLASSES, NB_D)) < 0.2] = 0.0
    cls_ids = rng.integers(0, NB_CLASSES, size=NB_ROWS)
    counts = rng.poisson(rates[cls_ids]).astype(np.float64)
    nb = NaiveBayes(device=DEVICE).set_smoothing(0.0).fit(
        Table({"features": counts, "label": cls_ids}))
    pred = nb.transform(Table({"features": counts}))[0]["prediction"]
    got = _scores(*(torch.as_tensor(np.asarray(a, np.float32), device=dev)
                    for a in (counts, nb._log_theta, nb._log_prior))
                  ).cpu().numpy()
    lt = nb._log_theta
    want = counts @ np.where(np.isneginf(lt), 0.0, lt).T + nb._log_prior
    impossible = ((counts > 0).astype(np.float64)
                  @ np.isneginf(lt).astype(np.float64).T) > 0
    want[impossible] = -np.inf
    finite = np.isfinite(want)
    top2 = np.sort(np.where(finite, want, -np.inf), axis=1)[:, -2:]
    tie = np.abs(top2[:, 1] - top2[:, 0]) <= NB_TOL["rtol"] * np.abs(
        top2[:, 1]) + NB_TOL["atol"]
    ref_pred = nb._labels[np.argmax(np.where(finite, want, -np.inf),
                                    axis=1)]
    bad_pred = int(np.sum((pred != ref_pred) & ~tie))
    score_ok = (np.allclose(got[finite], want[finite], **NB_TOL)
                and bool(np.all(got[~finite] <= -1e38)))
    log(f"NaiveBayes (smoothing 0, {NB_ROWS} x {NB_D}, {NB_CLASSES} "
        f"classes, {int((~finite).sum())} scores at -inf): card scores vs "
        f"float64 max |d| {float(np.max(np.abs(got[finite] - want[finite]))):.3e}"
        f" (rtol {NB_TOL['rtol']}, atol {NB_TOL['atol']}; -inf read as <= "
        f"-1e38); predictions differing off ties {bad_pred}, ties "
        f"{int(tie.sum())} [{card}]")
    if not score_ok or bad_pred:
        fail("NaiveBayes: the card's scores or predictions left float64")

    # KNN at k 5: 2^17 x 64 training rows, 4096 queries
    rng = np.random.default_rng(36)
    train = rng.normal(size=(KN_TRAIN, KN_D)).astype(np.float32)
    proj = rng.normal(size=(KN_D, 4))
    labels = np.argmax(train @ proj, axis=1)
    queries = rng.normal(size=(KN_Q, KN_D)).astype(np.float32)
    knn = KNNClassifier(device=DEVICE).set_k(KN_K).fit(
        Table({"features": train, "label": labels}))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    kpred = knn.transform(Table({"features": queries}))[0]["prediction"]
    knn_s = time.perf_counter() - t0
    ref, ties = knn_reference(train.astype(np.float64), labels,
                              queries.astype(np.float64), KN_K, 4)
    off = [i for i in range(KN_Q) if i not in ties and kpred[i] != ref[i]]
    bad_ties = [i for i, wins in ties.items() if kpred[i] not in wins]
    log(f"KNN (k {KN_K}, {KN_TRAIN} x {KN_D} train, {KN_Q} queries): "
        f"transform {knn_s:.3f} s ({KN_Q / knn_s:.1f} queries/s); votes "
        f"differing from the float64 vote {len(off)}; queries whose k-th "
        f"and (k+1)-th distances tie within f32 rounding {len(ties)}, "
        f"outside every valid k-set's vote {len(bad_ties)} [{card}]")
    if off or bad_ties:
        fail("KNN: the card's votes left the float64 k-nearest vote")

    # OneVsRest over LogisticRegression, 4 classes
    rng = np.random.default_rng(37)
    centers = rng.normal(size=(OV_CLASSES, OV_D)) * 2
    ov_y = rng.integers(0, OV_CLASSES, size=OV_ROWS)
    ov_X = (centers[ov_y] + rng.normal(size=(OV_ROWS, OV_D))).astype(
        np.float32)
    ov_table = Table({"features": ov_X, "label": ov_y.astype(np.float64)})

    def ovr(device):
        base = (LogisticRegression(device=device).set_max_iter(5)
                .set_learning_rate(0.5).set_global_batch_size(4096)
                .set_tol(0).set_raw_prediction_col("rawPrediction"))
        return OneVsRest(base).fit(ov_table)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ov_card = ovr(DEVICE)
    ov_s = time.perf_counter() - t0
    ov_cpu = ovr("cpu")
    coef_ok = all(np.allclose(a._state.coefficients, b._state.coefficients,
                              **OV_TOL)
                  for a, b in zip(ov_card.models, ov_cpu.models))
    oa, ob = (m.transform(Table({"features": ov_X}))[0]
              for m in (ov_card, ov_cpu))
    raw = np.sort(ob["rawPrediction"], axis=1)
    ov_tie = raw[:, -1] - raw[:, -2] <= 1e-3
    ov_off = int(np.sum((oa["prediction"] != ob["prediction"]) & ~ov_tie))
    acc = float(np.mean(oa["prediction"] == ov_y))
    log(f"OneVsRest over LogisticRegression ({OV_CLASSES} classes, "
        f"{OV_ROWS} x {OV_D}): 4 fits on the card {ov_s:.3f} s; every "
        f"sub-model within allclose(1e-3, 1e-4) of the CPU's {coef_ok}; "
        f"predictions differing off near ties {ov_off}; accuracy {acc:.4f} "
        f"[{card}]")
    if not coef_ok or ov_off or acc < 0.9:
        fail("OneVsRest: the card's fit left the CPU's")

    # StandardScaler -> GBTClassifier, fitted and applied on the card
    scaled = Table({"raw": X * 3.0 + 1.0, "label": y})
    pm = Pipeline([StandardScaler(device=DEVICE).set_features_col("raw")
                   .set_output_col("features"),
                   est(GBTClassifier, DEVICE)]).fit(scaled)
    out = pm.transform(Table({"raw": X * 3.0 + 1.0}))[0]
    stage = pm.stages[1].transform(pm.stages[0].transform(
        Table({"raw": X * 3.0 + 1.0}))[0])[0]
    same_bits("StandardScaler -> GBTClassifier", stage, out)
    acc = float(np.mean(out["prediction"] == y))
    log(f"Pipeline StandardScaler -> GBTClassifier on the card: fused "
        f"transform = stagewise bit for bit; training accuracy {acc:.4f} "
        f"(the unscaled binary fit's {binary_acc:.4f}: scaling keeps the "
        f"quantile bins' order) [{card}]")
    if abs(acc - binary_acc) > 0.01:
        fail("the StandardScaler -> GBTClassifier pipeline left the "
             "unscaled fit's accuracy")

    # a GBTClassifierModel served at requests of 1-256 rows
    registry = ModelRegistry(device=DEVICE)
    registry.deploy("gbt", gbt_binary, feats.take(2),
                    max_batch_rows=SV_BATCH)
    endpoint = ServingEndpoint(registry, "gbt", max_batch_rows=SV_BATCH,
                               max_wait_ms=SV_WAIT_MS).start()
    starts = [(i * 997) % (len(X) - SV_BATCH)
              for i in range(len(GB_SERVE_SIZES))]
    reqs = [Table({"features": X[s:s + size]})
            for s, size in zip(starts, GB_SERVE_SIZES)]
    try:
        outs, batches, wall = serve_checked("GBT serving", endpoint, reqs, 4)
    finally:
        close_endpoint("GBT serving", endpoint)
    for req, served in zip(reqs, outs):
        same_bits("GBT serving", gbt_binary.transform(req)[0], served)
    log(f"serving GBTClassifierModel: {len(reqs)} requests of 1-256 rows "
        f"in {batches} batches, {wall:.3f} s; every response = the offline "
        f"transform bit for bit [{card}]")
    log(f"phase 39: {time.perf_counter() - t_phase:.2f} s [{card}]")


# The recommenders (phases 40-41): bench_als's shape (bench.py:1218-1239)
ALS_USERS, ALS_ITEMS, ALS_NNZ, ALS_SEED = 1 << 14, 1 << 12, 1 << 21, 3
ALS_RANK, ALS_REG, ALS_EPOCHS = 64, 0.1, 5
ALS_CPU_TOL = dict(rtol=1e-4, atol=1e-4)   # a user half-epoch, card vs CPU
ALS_F64_RTOL = 1e-4          # sampled users vs float64, of the factor norm
ALS_SAMPLED = 256
ALS_FORM_TOL = dict(rtol=5e-3, atol=5e-3)  # tests/test_als.py:276-303
ALS_WS_TOL, ALS_WS_RMSE_RTOL = 1e-3, 0.01
ALS_PAIRS = 1 << 16
ALS_PRED_RTOL = 1e-5         # of |U_u| |V_i|
ALS_REC_USERS, ALS_REC_K, ALS_HELD = 1024, 10, 1 << 14
ALS_TIE = 1e-6               # of |U_u| max|V_i|: ranks may swap
ALS_EPOCH_REPS = 5
# Swing: 4096 users x 1024 items, 12-60 items a user, Zipf(1.1) over items
SG_USERS, SG_ITEMS, SG_ZIPF, SG_SEED = 4096, 1024, 1.1, 43
SG_MIN_ITEMS, SG_MAX_ITEMS = 12, 60
SG_PAIRS, SG_RTOL, SG_SYM = 64, 1e-5, 1e-6
# MinHashLSH: 2^16 x 2048 binary rows, ~5% active, 4 tables x 4 functions
MH_ROWS, MH_D, MH_ACTIVE, MH_TABLES, MH_FNS = 1 << 16, 2048, 0.05, 4, 4
MH_REPS, MH_DUPS = 10, 16


def als_ratings(n_users, n_items, nnz, seed):
    """bench_als's ratings: uniform (user, item) ids, N(0,1) ratings."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, n_users, size=nnz)
    i = rng.integers(0, n_items, size=nnz)
    return u, i, rng.normal(size=nnz).astype(np.float32)


def als_rmse(torch, dev, U, V, u, i, r, reg=None):
    """Training RMSE of the factors (numpy or tensors) over the ratings,
    on the card, summed in float64; with ``reg``, also ALS-WR's
    objective, ``sum (r - U_u.V_i)^2 + reg (sum_u n_u |U_u|^2 + sum_i
    n_i |V_i|^2)``, which each half-epoch minimizes over one side."""
    U, V = (torch.as_tensor(x, device=dev) for x in (U, V))
    ut, it = (torch.from_numpy(x).to(dev) for x in (u, i))
    pred = torch.sum(U[ut] * V[it], dim=1).double()
    err = pred - torch.from_numpy(r).to(dev).double()
    sq = torch.sum(err * err)
    rmse = float(torch.sqrt(sq / len(r)))
    if reg is None:
        return rmse
    norms = [torch.bincount(idx, minlength=len(F)).double()
             @ torch.sum(F.double() ** 2, dim=1)
             for idx, F in ((ut, U), (it, V))]
    return rmse, float(sq + reg * (norms[0] + norms[1]))


def als_phase(torch, dev, card, timer):
    """Phase 40: ALS at bench_als's shape on the card: 'auto' plans the
    sorted form, two fits bit for bit, a user half-epoch against the CPU
    and 256 users against float64 solves, the training RMSE falling epoch
    by epoch, the scatter, workset and implicit fits, transform against
    float64 dots, recommend_for_users against a float64 top-k and
    RankingEvaluator over held-out pairs; epochs/s of both forms against
    the epoch's bound."""
    from flink_ml_tpu_torch import Table
    from flink_ml_tpu_torch.models import ALS
    from flink_ml_tpu_torch.models.evaluation import RankingEvaluator
    from flink_ml_tpu_torch.models.recommendation import als as A

    t_phase = time.perf_counter()
    if torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 is on: the ALS normal equations must run in f32")
    n_u, n_i, nnz, rank = ALS_USERS, ALS_ITEMS, ALS_NNZ, ALS_RANK
    u, i, r = als_ratings(n_u, n_i, nnz, ALS_SEED)
    table = Table({"user": u, "item": i, "rating": r})
    user_ids, u_idx = np.unique(u, return_inverse=True)
    item_ids, i_idx = np.unique(i, return_inverse=True)
    if len(user_ids) != n_u or len(item_ids) != n_i:
        fail("ALS: some user or item drew no rating")

    def fit(form="auto", tab=table, **extra):
        est = (ALS(device=DEVICE).set_rank(rank).set_reg_param(ALS_REG)
               .set_max_iter(ALS_EPOCHS).set_seed(0)
               .set(ALS.NEQ_IMPL, form))
        for name, v in extra.items():
            getattr(est, f"set_{name}")(v)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = est.fit(tab)
        return est, model, time.perf_counter() - t0

    def factors(model):
        data = model.get_model_data()[0]
        return data["userFactors"][0], data["itemFactors"][0]

    def same(a, b):
        return all(np.array_equal(x, y)
                   for x, y in zip(factors(a), factors(b)))

    # 1-2. 'auto' plans the sorted form; two fits give the same bits
    est, model, cold_s = fit()
    spans = est.plan_spans
    log(f"ALS ({n_u} users x {n_i} items, {nnz} ratings, rank {rank}, reg "
        f"{ALS_REG}, {ALS_EPOCHS} epochs): 'auto' planned "
        f"{est.planned_impl}, spans users {spans and spans[0]} items "
        f"{spans and spans[1]} (cap {A._NEQ_AUTO_SPAN_CAP}); cold fit "
        f"{cold_s:.3f} s [{card}]")
    if est.planned_impl != "sorted" or max(spans) > A._NEQ_AUTO_SPAN_CAP:
        fail("ALS: 'auto' did not plan the sorted form")
    _, again, warm_s = fit()
    if not same(model, again):
        fail("ALS: two fits on the card gave different factors")
    log(f"ALS: a second fit {warm_s:.3f} s, the same bits [{card}]")

    # 3-4. one user half-epoch from the fit's start state: the card vs
    # the port on the host CPU, and 256 users vs float64 solves
    U0, V0 = A.init_factors(n_u, n_i, rank, 0)
    w = np.ones(nnz, np.float32)
    t0 = time.perf_counter()
    plan_u, plan_v = A.NeqPlan(u_idx), A.NeqPlan(i_idx)
    plan_s = time.perf_counter() - t0
    if (plan_u.span, plan_v.span) != tuple(spans):
        fail("ALS: the fit's spans differ from its plans'")

    def half_epoch(device):
        side = plan_u.side_data(i_idx, r, w, device)
        return A._solve_side_sorted(
            torch.from_numpy(U0).to(device), torch.from_numpy(V0).to(device),
            plan_u, *side, n_u, ALS_REG, False, 1.0).cpu().numpy()

    on_card = half_epoch(dev)
    t0 = time.perf_counter()
    on_cpu = half_epoch("cpu")
    cpu_s = time.perf_counter() - t0
    gap = float(np.max(np.abs(on_card - on_cpu)))
    log(f"ALS user half-epoch, card vs host CPU: max |d| {gap:.3e} (rtol "
        f"{ALS_CPU_TOL['rtol']}, atol {ALS_CPU_TOL['atol']}); the CPU's "
        f"{cpu_s:.3f} s")
    if not np.allclose(on_card, on_cpu, **ALS_CPU_TOL):
        fail("ALS: the card's half-epoch left the CPU's")
    order = np.argsort(u_idx, kind="stable")
    bounds = np.searchsorted(u_idx[order], np.arange(n_u + 1))
    worst = 0.0
    for s in np.random.default_rng(4).choice(n_u, ALS_SAMPLED,
                                             replace=False):
        rows = order[bounds[s]:bounds[s + 1]]
        y = V0[i_idx[rows]].astype(np.float64)
        lhs = y.T @ y + ALS_REG * max(len(rows), 1) * np.eye(rank)
        want = np.linalg.solve(lhs, y.T @ r[rows].astype(np.float64))
        worst = max(worst, float(np.linalg.norm(on_card[s] - want)
                                 / np.linalg.norm(want)))
    log(f"ALS: {ALS_SAMPLED} sampled users vs float64 normal equations: "
        f"worst |d| / |x| {worst:.3e} (tolerance {ALS_F64_RTOL})")
    if worst > ALS_F64_RTOL:
        fail("ALS: the card's solve left the float64 solve")

    # 5. epoch by epoch through the fit's own body: ALS-WR's objective
    # falls every epoch (each half-epoch minimizes it over one side); the
    # training RMSE need not, on ratings without low-rank structure
    sorted_data = (plan_u.side_data(i_idx, r, w, dev)
                   + plan_v.side_data(u_idx, r, w, dev))
    raw_data = tuple(torch.from_numpy(x).to(dev) for x in (
        u_idx.astype(np.int64), i_idx.astype(np.int64), r, w))
    bodies = {"sorted": (A.als_epoch_step(n_u, n_i, ALS_REG, False, 1.0,
                                          plans=(plan_u, plan_v)),
                         sorted_data),
              "scatter": (A.als_epoch_step(n_u, n_i, ALS_REG, False, 1.0),
                          raw_data)}
    body, data = bodies["sorted"]
    state = (torch.from_numpy(U0).to(dev), torch.from_numpy(V0).to(dev))
    trace = [als_rmse(torch, dev, *state, u_idx, i_idx, r, ALS_REG)]
    for e in range(ALS_EPOCHS):
        state = body(state, e, data).feedback
        trace.append(als_rmse(torch, dev, *state, u_idx, i_idx, r, ALS_REG))
    rmses, objs = [x for x, _ in trace], [y for _, y in trace]
    log(f"ALS by epoch from the start state: objective "
        f"{[round(x, 3) for x in objs]}; training RMSE "
        f"{[round(x, 6) for x in rmses]}")
    if not all(b < a for a, b in zip(objs, objs[1:])) \
            or rmses[-1] >= rmses[0]:
        fail(f"ALS: the objective did not fall every epoch, or the RMSE "
             f"did not fall over the fit: {objs}, {rmses}")
    if not all(np.array_equal(x.cpu().numpy(), y)
               for x, y in zip(state, factors(model))):
        fail("ALS: the epoch body's factors differ from the fit's")

    # 6. the scatter form within JAX's own tolerance of the sorted form
    s_est, s_model, s_s = fit("scatter")
    diff = max(float(np.max(np.abs(x - y)))
               for x, y in zip(factors(s_model), factors(model)))
    log(f"ALS scatter fit ({s_est.planned_impl}) {s_s:.3f} s: max |d| vs "
        f"the sorted fit {diff:.3e} (rtol/atol {ALS_FORM_TOL['rtol']})")
    if s_est.planned_impl != "scatter" or not all(
            np.allclose(x, y, **ALS_FORM_TOL)
            for x, y in zip(factors(s_model), factors(model))):
        fail("ALS: the scatter fit left the sorted fit")

    # 7. the workset fit
    ws_est, ws_model, ws_s = fit(workset_tol=ALS_WS_TOL)
    rep = ws_est.last_workset_report
    rmse_bsp = rmses[-1]
    rmse_ws = als_rmse(torch, dev, *factors(ws_model), u_idx, i_idx, r)
    log(f"ALS workset fit (tol {ALS_WS_TOL}) {ws_s:.3f} s: {rep['rounds']} "
        f"rounds of at most {ALS_EPOCHS}, active fractions "
        f"{[round(float(x), 6) for x in rep['active_fraction']]}; RMSE "
        f"{rmse_ws:.6f} vs BSP {rmse_bsp:.6f}")
    if rep["rounds"] > ALS_EPOCHS or len(rep["active_fraction"]) \
            != rep["rounds"] or abs(rmse_ws - rmse_bsp) \
            > ALS_WS_RMSE_RTOL * rmse_bsp:
        fail("ALS: the workset fit's report or RMSE is off")

    # 8. the implicit fit (|r|, alpha 1): finite, twice the same bits
    implicit = Table({"user": u, "item": i, "rating": np.abs(r)})
    im_est, im_a, im_s = fit(tab=implicit, implicit_prefs=True, alpha=1.0)
    _, im_b, _ = fit(tab=implicit, implicit_prefs=True, alpha=1.0)
    finite = all(np.isfinite(x).all() for x in factors(im_a))
    log(f"ALS implicit fit ({im_est.planned_impl}) {im_s:.3f} s: finite "
        f"{finite}, a second fit the same bits {same(im_a, im_b)}")
    if not finite or not same(im_a, im_b):
        fail("ALS: the implicit fit is not finite or not repeatable")

    # 9. transform against float64 dots of the fitted factors
    Uf, Vf = factors(model)
    rng = np.random.default_rng(5)
    pu = rng.integers(0, n_u, ALS_PAIRS)
    pi = rng.integers(0, n_i, ALS_PAIRS)
    pred = model.transform(Table({"user": pu, "item": pi}))[0]["prediction"]
    U64, V64 = Uf.astype(np.float64), Vf.astype(np.float64)
    want = np.einsum("nk,nk->n", U64[pu], V64[pi])
    scale = np.linalg.norm(U64[pu], axis=1) * np.linalg.norm(V64[pi], axis=1)
    rel = float(np.max(np.abs(pred - want) / scale))
    log(f"ALS transform of {ALS_PAIRS} pairs: max |p - float64| / (|U_u| "
        f"|V_i|) {rel:.3e} (tolerance {ALS_PRED_RTOL})")
    if pred.shape != (ALS_PAIRS,) or not np.isfinite(pred).all() \
            or rel > ALS_PRED_RTOL:
        fail("ALS: transform left the float64 dots")

    # 10. recommend_for_users with the training pairs excluded, against a
    # float64 top-k; RankingEvaluator over held-out pairs
    sel = np.arange(ALS_REC_USERS)
    t0 = time.perf_counter()
    recs = model.recommend_for_users(sel, ALS_REC_K, exclude=table)
    rec_s = time.perf_counter() - t0
    scores = U64[sel] @ V64.T
    seen = u < ALS_REC_USERS
    scores[u[seen], i[seen]] = -np.inf
    ties = 0
    for row in sel:
        got = np.asarray(recs["recommendations"][row])
        ref = np.argsort(-scores[row], kind="stable")[:ALS_REC_K]
        tie = ALS_TIE * np.linalg.norm(U64[row]) \
            * np.linalg.norm(V64, axis=1).max()
        for a, b in zip(got, ref):
            if a == b:
                continue
            if abs(scores[row, a] - scores[row, b]) > tie:
                fail(f"ALS: user {row}'s recommendations differ from the "
                     f"float64 top-k beyond a tie ({got} vs {ref})")
            ties += 1
        if len(got) != ALS_REC_K:
            fail(f"ALS: user {row} got {len(got)} recommendations")
    held_u = rng.integers(0, ALS_REC_USERS, ALS_HELD)
    held_i = rng.integers(0, n_i, ALS_HELD)
    truth = np.empty(ALS_REC_USERS, object)
    for row in sel:
        truth[row] = held_i[held_u == row].tolist()
    metrics = RankingEvaluator().set_k(ALS_REC_K).transform(Table({
        "prediction": recs["recommendations"], "label": truth}))[0]
    values = {m: float(metrics[m][0]) for m in metrics.column_names}
    log(f"ALS recommend_for_users ({ALS_REC_USERS} users, k {ALS_REC_K}, "
        f"{int(seen.sum())} training pairs excluded) {rec_s:.3f} s: the "
        f"float64 top-k's ids, {ties} positions swapped within a tie of "
        f"{ALS_TIE}; RankingEvaluator over {ALS_HELD} held-out pairs "
        f"(random ratings: no signal expected) {values}")
    if not all(0.0 <= v <= 1.0 for v in values.values()):
        fail("ALS: RankingEvaluator's metrics leave [0, 1]")

    # 11-12. epochs/s of both forms (warm, CUDA events, in turns) against
    # the epoch's bound
    ms = {"sorted": [], "scatter": []}
    for form in ("sorted", "scatter", "scatter", "sorted"):
        b, d = bodies[form]
        ms[form].append(timer.ms(lambda: b(state, 0, d),
                                 reps=ALS_EPOCH_REPS, warm=1))
    epoch_ms = {f: statistics.median(v) for f, v in ms.items()}
    ops = 2 * nnz * rank * rank * 2          # both sides' A terms
    gather_bytes = 2 * nnz * rank * 4
    bound_ms = max(ops / FP32_OPS_PER_S, gather_bytes / HBM_BYTES_PER_S) \
        * 1e3
    padded = [p.chunk * len(p.g_lo) for p in (plan_u, plan_v)]
    onehot_ops = sum(2 * p.span * n * rank * (rank + 1)
                     for p, n in zip((plan_u, plan_v), padded))
    outer_bytes = sum(2 * n * rank * rank * 4 for n in padded)
    log(f"ALS epoch (warm, median of {ALS_EPOCH_REPS} x 2, L2 flushed): "
        f"sorted {epoch_ms['sorted']:.3f} ms = "
        f"{1e3 / epoch_ms['sorted']:.3f} epochs/s, scatter "
        f"{epoch_ms['scatter']:.3f} ms = {1e3 / epoch_ms['scatter']:.3f} "
        f"epochs/s; bound {bound_ms:.4f} ms (operations: {ops:.3e} f32 "
        f"FLOPs at {FP32_OPS_PER_S:.0e}; bytes: {gather_bytes:.3e} B of "
        f"factor gathers, {gather_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms); "
        f"sorted {epoch_ms['sorted'] / bound_ms:.1f}x, scatter "
        f"{epoch_ms['scatter'] / bound_ms:.1f}x the bound; the sorted "
        f"form's one-hot products {onehot_ops:.3e} FLOPs and its outer "
        f"products {outer_bytes:.3e} B written and read; host plan build "
        f"(two NeqPlans) {plan_s:.3f} s, the scatter form none [{card}]")
    RATES["als_epochs_per_sec"] = {f: 1e3 / v for f, v in epoch_ms.items()}
    log(f"phase 40: {time.perf_counter() - t_phase:.2f} s [{card}]")


def swing_interactions(seed):
    """SG_USERS users, each with SG_MIN_ITEMS-SG_MAX_ITEMS distinct items
    drawn Zipf(SG_ZIPF) over SG_ITEMS items."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, SG_ITEMS + 1) ** SG_ZIPF
    p /= p.sum()
    counts = rng.integers(SG_MIN_ITEMS, SG_MAX_ITEMS + 1, size=SG_USERS)
    items = np.concatenate([rng.choice(SG_ITEMS, size=c, replace=False, p=p)
                            for c in counts])
    return np.repeat(np.arange(SG_USERS), counts), items


def swing_row64(B, w, i, alpha2):
    """Row ``i`` of the Swing similarity in float64: over the users of
    item i, ``0.5 sum_{u != v} K_uv B_uj B_vj``."""
    Bu = B[B[:, i] > 0]
    wu = w[B[:, i] > 0]
    uu = Bu @ Bu.T
    K = np.where(uu > 0, np.outer(wu, wu) / np.maximum(alpha2 + uu, 1e-300),
                 0.0)
    np.fill_diagonal(K, 0.0)
    return 0.5 * np.sum(Bu * (K @ Bu), axis=0)


def swing_pair64(B, w, i, j, alpha2):
    """The Swing similarity of items i and j summed directly in float64
    over the unordered pairs of their common users."""
    common = (B[:, i] > 0) & (B[:, j] > 0)
    Bc, wc = B[common], w[common]
    uu = Bc @ Bc.T
    K = np.where(uu > 0, np.outer(wc, wc) / np.maximum(alpha2 + uu, 1e-300),
                 0.0)
    return float(np.sum(np.triu(K, k=1)))


def minhash_reference(X, table):
    """(n, m) int64 signatures: numpy minima of the hash table's rows over
    each row's active indices, in row chunks."""
    out = np.empty((X.shape[0], table.shape[1]), np.int64)
    for s in range(0, X.shape[0], 8192):
        rows, cols = np.nonzero(X[s:s + 8192])
        starts = np.searchsorted(rows, np.arange(min(8192, len(X) - s)))
        out[s:s + 8192] = np.minimum.reduceat(table[cols], starts, axis=0)
    return out


def recommenders_phase(torch, dev, card, timer):
    """Phase 41: Swing (4096 x 1024, Zipf) twice bit for bit, symmetric,
    sampled pairs and top-k lists against float64; MinHashLSH signatures
    at 2^16 x 2048 against a numpy int64 minimum exactly, its kernel time
    against the bound, approx_nearest_neighbors against the CPU."""
    from flink_ml_tpu_torch import Table
    from flink_ml_tpu_torch.models.feature import MinHashLSH
    from flink_ml_tpu_torch.models.feature import lsh as L
    from flink_ml_tpu_torch.models.recommendation import Swing
    from flink_ml_tpu_torch.models.recommendation import swing as SW

    t_phase = time.perf_counter()
    users, items = swing_interactions(SG_SEED)
    table = Table({"user": users, "item": items})
    op = Swing(device=DEVICE)
    item_vals, B = op.interaction_matrix(table)
    a1, a2, beta = (float(op.get_alpha1()), float(op.get_alpha2()),
                    float(op.get_beta()))
    Bt = torch.from_numpy(B).to(dev)
    runs = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        S = SW._swing_scores(Bt, a1, a2, beta)
        torch.cuda.synchronize()
        runs.append((S, time.perf_counter() - t0))
    (S, s1), (S2, s2) = runs
    repeat = bool(torch.equal(S, S2))
    S = S.cpu().numpy().astype(np.float64)
    asym = float(np.max(np.abs(S - S.T)) / np.max(np.abs(S)))
    ops = 2.0 * B.shape[0] ** 2 * B.shape[1] ** 2
    log(f"Swing ({B.shape[0]} users x {B.shape[1]} items, "
        f"{int(B.sum())} interactions after the filter and the per-item cap "
        f"of {op.get_max_user_num_per_item()}): scores {s1:.3f} / "
        f"{s2:.3f} s, twice the same bits {repeat}; bound "
        f"{ops / FP32_OPS_PER_S:.3f} s ({ops:.3e} f32 FLOPs at "
        f"{FP32_OPS_PER_S:.0e}), {min(s1, s2) * FP32_OPS_PER_S / ops:.2f}x "
        f"it; "
        f"max |S - S^T| / max|S| {asym:.3e} (tolerance {SG_SYM}) [{card}]")
    if not repeat or asym > SG_SYM:
        fail("Swing: two runs differ, or S is not symmetric")

    t0 = time.perf_counter()
    out = op.transform(table)[0]
    tr_s = time.perf_counter() - t0
    counts = B.sum(axis=1).astype(np.float64)
    w64 = np.where(counts > 0, (counts + a1) ** -beta, 0.0)
    B64 = B.astype(np.float64)
    rng = np.random.default_rng(SG_SEED + 1)
    worst, ties, compared = 0.0, 0, 0
    for i in rng.choice(len(item_vals), SG_PAIRS, replace=False):
        row = swing_row64(B64, w64, i, a2)
        row[i] = 0.0
        live = np.flatnonzero(row > 0)
        if len(live):
            j = int(rng.choice(live))
            want = swing_pair64(B64, w64, i, j, a2)
            worst = max(worst, abs(S[i, j] - want) / want)
            compared += 1
        got = np.asarray(out["similar_items"][i])
        ref = np.argsort(-row, kind="stable")
        ref = ref[row[ref] > 0][:op.get_k()]
        if len(got) != len(ref):
            fail(f"Swing: item {i} lists {len(got)} items, float64 "
                 f"{len(ref)}")
        for a, b in zip(got, ref):
            if a != b:
                if abs(row[a] - row[b]) > SG_RTOL * row[b]:
                    fail(f"Swing: item {i}'s top-k differs from float64 "
                         "beyond a tie")
                ties += 1
    log(f"Swing transform {tr_s:.3f} s; {compared} sampled item pairs vs a "
        f"float64 sum over their common user pairs: worst relative "
        f"{worst:.3e} (tolerance {SG_RTOL}); their items' top-{op.get_k()} "
        f"lists = float64's, {ties} positions swapped within a tie")
    if worst > SG_RTOL:
        fail("Swing: a sampled pair left the float64 sum")

    # MinHashLSH
    rng = np.random.default_rng(SG_SEED + 2)
    X = rng.random((MH_ROWS, MH_D), dtype=np.float32) < MH_ACTIVE
    X[np.arange(MH_ROWS), np.arange(MH_ROWS) % MH_D] = True
    # near-duplicates of row 123 (a tenth of its bits dropped) for the
    # nearest-neighbour query to find
    dups = rng.choice(np.arange(124, MH_ROWS), MH_DUPS, replace=False)
    for d in dups:
        X[d] = X[123] & (rng.random(MH_D) >= 0.1)
    Xf = X.astype(np.float32)
    feats = Table({"features": Xf, "id": np.arange(MH_ROWS)})

    def lsh(device):
        return (MinHashLSH(device=device).set_num_hash_tables(MH_TABLES)
                .set_num_hash_functions_per_table(MH_FNS).set_seed(7)
                .fit(Table({"features": Xf[:1]})))

    model = lsh(DEVICE)
    t0 = time.perf_counter()
    sig = model.transform(feats)[0]["output"]
    sig_s = time.perf_counter() - t0
    hashes = model.hash_table(MH_D)
    want = minhash_reference(X, hashes.astype(np.int64))
    exact = sig.shape == (MH_ROWS, MH_TABLES, MH_FNS) and np.array_equal(
        sig.reshape(MH_ROWS, -1), want)
    active, table_d = (torch.from_numpy(X).to(dev),
                       torch.from_numpy(hashes).to(dev))
    mh_ms = timer.ms(lambda: L._minhash_batch(active, table_d),
                     reps=MH_REPS, warm=1)
    m = MH_TABLES * MH_FNS
    mh_bytes = MH_ROWS * MH_D + MH_D * m * 4 + MH_ROWS * m * 4
    mh_ops = MH_ROWS * MH_D * m
    mh_bound = max(mh_bytes / HBM_BYTES_PER_S,
                   mh_ops / FP32_OPS_PER_S) * 1e3
    log(f"MinHashLSH ({MH_ROWS} x {MH_D}, {X.mean():.4f} active, "
        f"{MH_TABLES} tables x {MH_FNS} functions): signatures = numpy "
        f"int64 minima {exact}; transform {sig_s:.3f} s; the masked min "
        f"{mh_ms:.3f} ms (median of {MH_REPS}) against a bound of "
        f"{mh_bound:.4f} ms (the larger of {mh_bytes:.3e} B and "
        f"{mh_ops:.3e} compare-selects at the fp32 rate), "
        f"{mh_ms / mh_bound:.1f}x [{card}]")
    if not exact:
        fail("MinHashLSH: signatures differ from the numpy minima")
    key = Xf[123]
    t0 = time.perf_counter()
    nn = model.approx_nearest_neighbors(feats, key, k=10)
    nn_s = time.perf_counter() - t0
    ref = lsh("cpu").approx_nearest_neighbors(feats, key, k=10)
    same_nn = np.array_equal(nn["id"], ref["id"]) and np.array_equal(
        nn["distCol"], ref["distCol"])
    log(f"MinHashLSH approx_nearest_neighbors (k 10) {nn_s:.3f} s: ids "
        f"{nn['id'].tolist()}, distances {nn['distCol'].round(4).tolist()}"
        f"; ids and distances = the CPU's {same_nn}")
    if not same_nn or nn["id"][0] != 123 or nn["distCol"][0] != 0.0 \
            or len(nn["id"]) != 10 or not set(nn["id"][1:]) <= set(dups):
        fail("MinHashLSH: the nearest neighbours differ from the CPU's")
    log(f"phase 41: {time.perf_counter() - t_phase:.2f} s [{card}]")


# -- phases 42-43: the text and selection stages ----------------------------

TX_DOCS, TX_CLASSES = 18846, 20    # 20 Newsgroups, subset "all"
TX_LEXICON = 1 << 17               # rendered words the corpus draws from
TX_VOCAB = 1 << 14                 # CountVectorizer vocabularySize
TX_TOPIC_WORDS = 200               # each class's topic words
TX_TOPIC_SHARE = 0.1               # of a document's words: its class's topic
TX_STOP_SHARE = 0.3                # of a document's words: stop words
TX_LEN = (50, 500)                 # words a document
TX_TOP = 2048                      # UnivariateFeatureSelector numTopFeatures
TX_EPOCHS = 3                      # SoftmaxRegression epochs
TX_F_RTOL = 1e-4                   # F values and variances, card vs CPU
TX_FIT_TOL = dict(rtol=1e-3, atol=1e-4)    # the softmax fit, card vs CPU
TX_TIE = 1e-3                      # top-two class scores within (relative)
SL_VAR_THRESHOLD = 1.0             # phase 25's N(0,1) columns: about half
SL_TOP = 16                        # the F-regression selector's top k
SL_EPOCHS = 2


def text_corpus(n, seed=0):
    """A synthetic corpus at 20 Newsgroups' size (scikit-learn's
    ``fetch_20newsgroups(subset="all")``: 18,846 documents, 20 classes)
    from numpy ``seed``: word ids Zipf(1.1) over TX_LEXICON rendered
    words (ranks permuted), a tenth of a document's words drawn from its
    class's 200 topic words, three tenths English stop words (a third of
    them capitalised), 50-500 words a document.  Returns (texts (n,)
    object, labels (n,) int64)."""
    from flink_ml_tpu_torch.models.feature import StopWordsRemover

    rng = np.random.default_rng(seed)
    syll = [c + v for c in "bcdfghjklmnprstvwz" for v in "aeiou"]
    s = len(syll)
    lexicon = np.asarray([syll[i // (s * s)] + syll[i // s % s]
                          + syll[i % s] + "s" for i in range(TX_LEXICON)],
                         dtype="U12")
    stop = list(StopWordsRemover.load_default_stop_words())
    if set(lexicon) & set(stop):
        fail("the rendered lexicon holds a stop word")
    stop = np.asarray(stop + [w.capitalize() for w in stop[::3]], "U12")
    labels = rng.integers(0, TX_CLASSES, size=n)
    lengths = rng.integers(TX_LEN[0], TX_LEN[1] + 1, size=n)
    total = int(lengths.sum())
    ids = rng.zipf(1.1, size=total) - 1
    while True:
        bad = np.flatnonzero(ids >= TX_LEXICON)
        if not bad.size:
            break
        ids[bad] = rng.zipf(1.1, size=bad.size) - 1
    ids = rng.permutation(TX_LEXICON)[ids]
    topics = rng.integers(0, TX_LEXICON, size=(TX_CLASSES, TX_TOPIC_WORDS))
    doc_of = np.repeat(np.arange(n), lengths)
    u = rng.random(total)
    topical = np.flatnonzero(u < TX_TOPIC_SHARE)
    ids[topical] = topics[labels[doc_of[topical]],
                          rng.integers(0, TX_TOPIC_WORDS, topical.size)]
    words = lexicon[ids]
    stops = np.flatnonzero((u >= TX_TOPIC_SHARE)
                           & (u < TX_TOPIC_SHARE + TX_STOP_SHARE))
    words[stops] = stop[rng.integers(0, len(stop), stops.size)]
    texts = np.empty(n, object)
    for i, chunk in enumerate(np.split(words, np.cumsum(lengths)[:-1])):
        texts[i] = " ".join(chunk.tolist())
    return texts, labels


class CardSpans:
    """Host-clock wall and card seconds of the spans run inside one
    ``torch.profiler`` profile (CUDA activity): a spin kernel launched
    at each span's start and end marks it on the device timeline, and
    its card time is the device time (kernels and copies) between its
    two marks, or None where the profiler recorded no device time.
    ``spans`` lists ``(name, wall s, card s)``; the profiler's own start
    and trace processing add up in ``RATES["profiler_s"]``."""

    MARK = "spin_kernel"

    def __init__(self, torch):
        self.torch = torch
        self.spans = []

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        self.torch.cuda.synchronize()
        self.t_all = time.perf_counter()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        return self

    def run(self, name, fn):
        torch = self.torch
        torch.cuda.synchronize()
        torch.cuda._sleep(1)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        torch.cuda._sleep(1)
        self.spans.append([name, wall, None])
        return out

    def __exit__(self, *exc):
        self.torch.cuda.synchronize()
        self.prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        # the raw kineto events: parsing them all into FunctionEvents
        # (``prof.events()``) takes longer than the spans themselves
        cuda = self.torch.autograd.DeviceType.CUDA
        events = sorted(
            (_ns(e, "start"), _ns(e, "duration"), e.name())
            for e in self.prof.profiler.kineto_results.events()
            if e.device_type() == cuda)
        marks = [i for i, e in enumerate(events) if self.MARK in e[2]]
        if len(marks) == 2 * len(self.spans) and \
                len(events) > len(marks):
            for k, span in enumerate(self.spans):
                lo, hi = marks[2 * k], marks[2 * k + 1]
                span[2] = sum(e[1] for e in events[lo + 1:hi]) / 1e9
        RATES["profiler_s"] = RATES.get("profiler_s", 0.0) + (
            time.perf_counter() - self.t_all
            - sum(w for _, w, _ in self.spans))
        return False


def _ns(event, what):
    """A kineto event's start or duration in ns (older PyTorch: us)."""
    if hasattr(event, f"{what}_ns"):
        return getattr(event, f"{what}_ns")()
    return getattr(event, f"{what}_us")() * 1000


def split_text(wall, card_s):
    if card_s is None:
        return f"{wall:.3f} s (card time not measured)"
    return (f"{wall:.3f} s = host {wall - card_s:.3f} s + card "
            f"{card_s:.3f} s")


def same_columns(what, ref, out, names):
    """``names`` of two tables equal: numeric columns in dtype and bits,
    token columns list for list."""
    for c in names:
        a, b = np.asarray(ref[c]), np.asarray(out[c])
        if a.dtype != b.dtype or a.shape != b.shape:
            fail(f"{what}: column {c!r} differs in dtype or shape")
        if a.dtype == object:
            same = all(list(x) == list(y) for x, y in zip(a, b))
        else:
            same = np.array_equal(np.ascontiguousarray(a).view(np.uint8),
                                  np.ascontiguousarray(b).view(np.uint8))
        if not same:
            fail(f"{what}: column {c!r} differs from its reference")


def boundary_diffs(what, f_card, f_cpu, dfn, dfd, got, k):
    """Selected indices ``got`` (the card's numTopFeatures ``k``) against
    the CPU's: the selection sorts p-values (the F survival function,
    which underflows to 0 for large F; ties break to the lower index), so
    equal, or every index in one set only is at the boundary: the
    p-values of its F moved by TX_F_RTOL either way bracket the CPU's
    k-th smallest p-value.  Returns the count of such indices."""
    from flink_ml_tpu_torch.models.feature.selectors import _select_by_mode
    from flink_ml_tpu_torch.models.stats import f_p_values

    d = len(f_cpu)

    def p_of(f):
        return f_p_values(f, np.full(d, dfn), np.full(d, dfd))

    p_cpu = p_of(f_cpu)
    want = _select_by_mode(p_cpu, "numTopFeatures", k)
    diff = np.setxor1d(got, want)
    edge = float(np.sort(p_cpu)[k - 1])
    lo = p_of(f_cpu * (1 + TX_F_RTOL))[diff]
    hi = p_of(f_cpu * (1 - TX_F_RTOL))[diff]
    off = diff[~((lo <= edge) & (edge <= hi))]
    n_zero = int(np.sum(p_cpu == 0.0))
    log(f"{what}: {len(got)} selected on the card, {diff.size} indices "
        f"differ from the CPU's top {k} by p-value (k-th p {edge!r}; "
        f"{n_zero} p-values underflow to 0 on the CPU, {int(np.sum(p_of(f_card) == 0.0))} "
        f"on the card), each at the boundary within rtol {TX_F_RTOL} of "
        f"its F: {off.size == 0}")
    if off.size:
        fail(f"{what}: the card selected {off.tolist()[:20]} off the "
             "boundary")
    return int(diff.size)


def text_phase(torch, dev, card):
    """Phase 42: the text pipeline at 20 Newsgroups' size on the card,
    held against the CPU port stage by stage; then the variance and
    F-regression selectors on phase 25's table and a fused selection
    segment."""
    import copy

    import flink_ml_tpu_torch as T
    from flink_ml_tpu_torch.api import chain
    from flink_ml_tpu_torch.models import stats as ST
    from flink_ml_tpu_torch.models.evaluation import (
        MulticlassClassificationEvaluator)
    from flink_ml_tpu_torch.models.feature import (
        IDF, CountVectorizer, StandardScaler, StopWordsRemover, Tokenizer,
        UnivariateFeatureSelector, VarianceThresholdSelector)
    from flink_ml_tpu_torch.models.feature import selectors as SEL
    from flink_ml_tpu_torch.utils import native_text

    t_phase = time.perf_counter()
    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.get_float32_matmul_precision() != "highest":
        fail("ANOVA's one-hot products must run in full f32 (TF32 is on)")
    t0 = time.perf_counter()
    texts, labels = text_corpus(TX_DOCS)
    n_words = sum(len(t.split(" ")) for t in texts[:512]) / 512
    log(f"text corpus: {TX_DOCS} documents, {TX_CLASSES} classes, "
        f"~{n_words:.0f} words a document (first 512), made in "
        f"{time.perf_counter() - t0:.3f} s (numpy seed 0); hashing through "
        f"{'native libtexthash' if native_text.native_available() else 'the Python FNV-1a loop'}")
    table = T.Table({"text": texts, "label": labels})

    stages = [
        Tokenizer().set_features_col("text").set_output_col("tokens"),
        StopWordsRemover().set_features_col("tokens").set_output_col("kept"),
        CountVectorizer().set_features_col("kept").set_output_col("counts")
        .set_vocabulary_size(TX_VOCAB),
        IDF(device=DEVICE).set_features_col("counts").set_output_col(
            "tfidf"),
        UnivariateFeatureSelector(device=DEVICE).set_features_col("tfidf")
        .set_output_col("selected").set_feature_type("continuous")
        .set_label_type("categorical").set_selection_threshold(TX_TOP),
        T.SoftmaxRegression(device=DEVICE).set_features_col("selected")
        .set_max_iter(TX_EPOCHS).set_tol(0),
    ]
    def timed(spans, stage, method, key):
        orig = getattr(stage, method)
        setattr(stage, method, lambda *t: spans.run(key, lambda: orig(*t)))

    with CardSpans(torch) as fit_spans:
        for stage in stages:
            name = type(stage).__name__
            method = "fit" if hasattr(stage, "fit") else "transform"
            timed(fit_spans, stage, method, f"{name}.{method}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pm = T.Pipeline(stages).fit(table)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
    for stage in stages:
        stage.__dict__.pop("fit", None)
        stage.__dict__.pop("transform", None)
    log(f"text pipeline fit: {fit_s:.3f} s wall; the stages' fits (and "
        f"the transforms of the stages that are not estimators), the "
        f"rest the fitted models' transforms between them [{card}]")
    for key, wall, card_s in fit_spans.spans:
        log(f"  {key}: {split_text(wall, card_s)}")
    cv, idf, sel, soft = pm.stages[2:]
    losses = soft.loss_log
    log(f"vocabulary {len(cv.vocabulary)} words (first {cv.vocabulary[:3]},"
        f" last {cv.vocabulary[-2:]}); softmax loss log {losses}")
    if len(cv.vocabulary) != TX_VOCAB:
        fail(f"vocabulary of {len(cv.vocabulary)} words, expected {TX_VOCAB}")
    if len(losses) != TX_EPOCHS or not all(np.isfinite(losses)) or \
            not all(b < a for a, b in zip(losses, losses[1:])):
        fail(f"text softmax: loss log {losses}")

    # the fused transform (the main path's scoring), then stagewise stage
    # by stage with each stage's split
    plan = pm._chain_plan([table])
    fused_desc = plan.describe() if plan is not None else None
    outs = [table]
    with CardSpans(torch) as tr_spans:
        d0 = chain.dispatch_count()
        fused = tr_spans.run("PipelineModel.transform", lambda: pm.transform(
            table)[0])
        d_fused = chain.dispatch_count() - d0
        with chain.chain_disabled():
            for stage in pm.stages:
                outs.append(tr_spans.run(
                    f"{type(stage).__name__}.transform",
                    lambda s=stage: s.transform(outs[-1])[0]))
    (_, tr_s, tr_card), *per_stage = tr_spans.spans
    log(f"text pipeline transform (fused plan {fused_desc}: "
        + ("no run of two chainable stages -- IDFModel and "
           "SoftmaxRegressionModel carry no chain kernel, in either "
           "package -- so every stage runs stagewise"
           if fused_desc is None else "segments as listed")
        + f"): {split_text(tr_s, tr_card)}, {d_fused} dispatches; then "
        f"stagewise, stage by stage: [{card}]")
    for key, wall, card_s in per_stage:
        log(f"  {key}: {split_text(wall, card_s)}")
    stagewise = outs[-1]
    same_columns("text pipeline fused vs stagewise", stagewise, fused,
                 stagewise.column_names)
    log("text pipeline: fused = stagewise, every column bit for bit "
        "(token columns list for list)")

    # IDF: the card's product = the CPU port's, bit for bit
    counts, tfidf, selected = (stagewise[c] for c in ("counts", "tfidf",
                                                       "selected"))
    cpu_idf = copy.copy(idf)
    cpu_idf.device = "cpu"
    cpu_tfidf = cpu_idf.transform(T.Table({"counts": counts}))[0]["tfidf"]
    same_idf = np.array_equal(cpu_tfidf.view(np.uint8), tfidf.view(np.uint8))
    log(f"IDF ({TX_DOCS} x {TX_VOCAB}): card = CPU bit for bit {same_idf}")
    if not same_idf:
        fail("IDF: the card's tf-idf differs from the CPU's")

    # ANOVA: F within TX_F_RTOL; the card's selection = the CPU's up to
    # the boundary
    f_card = ST.anova_f_scores(tfidf, labels, device=DEVICE)[0]
    f_cpu = ST.anova_f_scores(tfidf, labels, device="cpu")[0]
    rel = float(np.max(np.abs(f_card - f_cpu) / np.abs(f_cpu)))
    log(f"ANOVA F ({TX_VOCAB} features, {TX_CLASSES} classes): max "
        f"relative |card - CPU| = {rel:.3e} (rtol {TX_F_RTOL})")
    if not np.allclose(f_card, f_cpu, rtol=TX_F_RTOL, atol=0.0):
        fail("ANOVA: the card's F values are off the CPU's")
    got = sel.get_model_data()[0]["indices"]
    n_diff = boundary_diffs("ANOVA selector", f_card, f_cpu,
                            TX_CLASSES - 1, TX_DOCS - TX_CLASSES, got, TX_TOP)

    # the softmax fit on the card = the same fit on the CPU; accuracy
    cpu_soft = (T.SoftmaxRegression(device="cpu").set_features_col(
        "selected").set_max_iter(TX_EPOCHS).set_tol(0).fit(
            T.Table({"selected": selected, "label": labels})))
    w_card = soft.get_model_data()[0]["coefficients"][0]
    w_cpu = cpu_soft.get_model_data()[0]["coefficients"][0]
    dw = float(np.max(np.abs(w_card - w_cpu)))
    log(f"text softmax fit card vs CPU: max |dw| {dw:.3e} (allclose rtol "
        f"{TX_FIT_TOL['rtol']}, atol {TX_FIT_TOL['atol']})")
    if not np.allclose(w_card, w_cpu, **TX_FIT_TOL):
        fail("text softmax: the card's fit is off the CPU's")
    cpu_out = cpu_soft.transform(T.Table({"selected": selected}))[0]
    ev = MulticlassClassificationEvaluator().set_metrics("accuracy")
    acc = {w: float(ev.transform(T.Table({
        "label": labels, "prediction": o["prediction"]}))[0]["accuracy"][0])
        for w, o in ((DEVICE, fused), ("cpu", cpu_out))}
    flips = np.flatnonzero(fused["prediction"] != cpu_out["prediction"])
    probs = np.sort(cpu_out["rawPrediction"][flips], axis=1)
    tied = np.isclose(probs[:, -1], probs[:, -2], rtol=TX_TIE, atol=0.0) \
        if flips.size else np.zeros(0, bool)
    log(f"text accuracy: card {acc[DEVICE]!r}, CPU {acc['cpu']!r}; "
        f"{flips.size} predictions differ, each a near tie (top two "
        f"probabilities within rtol {TX_TIE}): {bool(tied.all())}")
    if acc[DEVICE] != acc["cpu"] and not tied.all():
        fail("text accuracy: the card's differs from the CPU's off a tie")
    if not acc[DEVICE] > 0.5:
        fail(f"the text fit did not learn the topics (accuracy "
             f"{acc[DEVICE]})")

    # the selectors on phase 25's table
    X, _, y_reg, _ = dense_rows(PL_ROWS, PL_DIM, seed=23)
    dense = T.Table({"features": X, "label": y_reg})
    var = {w: SEL._sample_variances(torch.as_tensor(X, device=w)).cpu(
        ).numpy().astype(np.float64) for w in (DEVICE, "cpu")}
    vts = {w: VarianceThresholdSelector(device=w).set_variance_threshold(
        SL_VAR_THRESHOLD).fit(dense) for w in (DEVICE, "cpu")}
    rel = float(np.max(np.abs(var[DEVICE] - var["cpu"]) / var["cpu"]))
    v_got = vts[DEVICE].get_model_data()[0]["indices"]
    v_want = vts["cpu"].get_model_data()[0]["indices"]
    v_diff = np.setxor1d(v_got, v_want)
    v_edge = bool(np.isclose(var["cpu"][v_diff], SL_VAR_THRESHOLD,
                             rtol=TX_F_RTOL, atol=0.0).all())
    log(f"VarianceThresholdSelector ({PL_ROWS} x {PL_DIM}, threshold "
        f"{SL_VAR_THRESHOLD}): max relative |var card - CPU| {rel:.3e} "
        f"(rtol {TX_F_RTOL}); kept {v_got.size}, {v_diff.size} differ "
        f"from the CPU's, each at the threshold: {v_edge}")
    if not np.allclose(var[DEVICE], var["cpu"], rtol=TX_F_RTOL, atol=0.0) \
            or not v_edge:
        fail("VarianceThresholdSelector: the card is off the CPU")
    fr = {w: ST.f_regression_scores(X, y_reg, device=w)[0]
          for w in (DEVICE, "cpu")}
    rel = float(np.max(np.abs(fr[DEVICE] - fr["cpu"]) / fr["cpu"]))
    log(f"F-regression F ({PL_ROWS} x {PL_DIM}): max relative |card - CPU| "
        f"{rel:.3e} (rtol {TX_F_RTOL})")
    if not np.allclose(fr[DEVICE], fr["cpu"], rtol=TX_F_RTOL, atol=0.0):
        fail("F-regression: the card's F values are off the CPU's")
    ufs = (UnivariateFeatureSelector(device=DEVICE).set_feature_type(
        "continuous").set_label_type("continuous").set_selection_threshold(
            SL_TOP).fit(dense))
    boundary_diffs("F-regression selector", fr[DEVICE], fr["cpu"], 1,
                   PL_ROWS - 2, ufs.get_model_data()[0]["indices"], SL_TOP)

    # a fused selection segment: VarianceThresholdSelector ->
    # StandardScaler -> UnivariateFeatureSelector -> LinearRegression
    sel_pm = T.Pipeline([
        VarianceThresholdSelector(device=DEVICE).set_variance_threshold(
            SL_VAR_THRESHOLD).set_output_col("kept"),
        StandardScaler(device=DEVICE).set_features_col("kept")
        .set_output_col("std"),
        UnivariateFeatureSelector(device=DEVICE).set_features_col("std")
        .set_output_col("top").set_feature_type("continuous")
        .set_label_type("continuous").set_selection_threshold(SL_TOP),
        T.LinearRegression(device=DEVICE).set_features_col("top")
        .set_max_iter(SL_EPOCHS),
    ]).fit(dense)
    feats = dense.drop("label")
    sel_plan = sel_pm._chain_plan([feats])
    if sel_plan is None or sel_plan.describe() != [("segment", 4)]:
        fail(f"selection pipeline: plan "
             f"{sel_plan.describe() if sel_plan else None}, expected one "
             "segment of 4 stages")
    (f_out, d_f, _), (s_out, d_s, _) = fused_and_stagewise(torch, sel_pm,
                                                           feats)
    log(f"selection pipeline (VarianceThresholdSelector -> StandardScaler "
        f"-> UnivariateFeatureSelector -> LinearRegression): plan "
        f"{sel_plan.describe()}, dispatches fused {d_f}, stagewise {d_s}")
    # stagewise, the scaler and the regression dispatch; the selectors'
    # standalone transforms gather on the host
    if (d_f, d_s) != (1, 2):
        fail(f"selection pipeline: dispatches fused {d_f}, stagewise "
             f"{d_s}; expected 1 and 2")
    # a selector's standalone gather returns the stacked f64 matrix, the
    # segment its f32 columns (the JAX package's dtypes too): the
    # intermediate columns equal in value, the outputs in bits
    for c in ("kept", "top"):
        if not np.array_equal(np.asarray(s_out[c], np.float64),
                              np.asarray(f_out[c], np.float64)):
            fail(f"selection pipeline: column {c!r} differs in value")
    same_columns("selection pipeline", s_out, f_out,
                 [c for c in s_out.column_names if c not in ("kept", "top")])
    log("selection pipeline: fused = stagewise (predictions and the "
        "scaled column bit for bit; the selected columns in value, f32 "
        "fused against the stagewise gather's f64)")
    log(f"phase 42: {time.perf_counter() - t_phase:.2f} s, of it "
        f"{RATES.get('profiler_s', 0.0):.2f} s the profiler's own start "
        f"and trace processing [{card}]")
    return n_diff


def hex_tokens(ids):
    """Criteo-style categorical tokens: each id as 8 lower-case hex
    digits."""
    digits = np.frombuffer(b"0123456789abcdef", np.uint8)
    nib = (ids.astype(np.int64)[:, None] >> np.arange(28, -4, -4)) & 15
    return np.ascontiguousarray(digits[nib]).view("S8")[:, 0].astype("U8")


def hashed_criteo_phase(torch, dev, card, dense, cat, y):
    """Phase 43: phase 4's rows as Criteo columns through SQLTransformer
    -> FeatureHasher (sparseOutput) -> LogisticRegression on the card.
    Returns the B1/B2 launches of the fit."""
    import flink_ml_tpu_torch as T
    from flink_ml_tpu_torch.data import criteo
    from flink_ml_tpu_torch.models.common import sgd as S
    from flink_ml_tpu_torch.models.common.losses import LOSSES
    from flink_ml_tpu_torch.models.feature import FeatureHasher, SQLTransformer
    from flink_ml_tpu_torch.ops import ell_scatter as E
    from flink_ml_tpu_torch.utils import native_text

    t_phase = time.perf_counter()
    n = len(y)
    num = [f"I{j + 1}" for j in range(N_DENSE)]
    cats = [f"C{f + 1}" for f in range(N_CAT)]
    t0 = time.perf_counter()
    cols = {name: dense[:, j] for j, name in enumerate(num)}
    cols.update({name: hex_tokens(cat[:, f]) for f, name in enumerate(cats)})
    cols["label"] = y
    table = T.Table(cols)
    render_s = time.perf_counter() - t0
    statement = ("SELECT " + ", ".join(
        [f"LOG1P(MAX({c}, 0)) AS {c}" for c in num] + cats + ["label"])
        + " FROM __THIS__")
    t0 = time.perf_counter()
    (logged,) = SQLTransformer().set_statement(statement).transform(table)
    sql_s = time.perf_counter() - t0
    want = np.log1p(np.maximum(dense, np.float32(0)))
    if not all(np.array_equal(logged[c], want[:, j])
               for j, c in enumerate(num)):
        fail("SQLTransformer: log1p(max(x, 0)) differs from numpy's")
    t0 = time.perf_counter()
    (hashed,) = (FeatureHasher().set_input_cols(*num, *cats)
                 .set_num_features(D_MAIN).set_sparse_output(True)
                 .set_output_col("features").transform(logged))
    hash_s = time.perf_counter() - t0
    idx, vals = hashed["features_indices"], hashed["features_values"]
    log(f"hashed Criteo (phase 4's {n} rows): rendered in {render_s:.3f} s;"
        f" SQLTransformer {sql_s:.3f} s; FeatureHasher ({D_MAIN} slots, "
        f"{'native' if native_text.native_available() else 'Python'} "
        f"FNV-1a) {hash_s:.3f} s; nnz {idx.shape[1]} [{card}]")
    if idx.shape != (n, N_DENSE + N_CAT) or idx.dtype != np.int32 or \
            vals.dtype != np.float32:
        fail(f"FeatureHasher: pair columns {idx.shape} {idx.dtype}, "
             f"{vals.dtype}")

    # each categorical slot = the Criteo reader's slot for the same token
    lines = ["\t".join([str(int(label))] + [""] * N_DENSE + list(row))
             for label, row in zip(y.tolist(),
                                   zip(*(cols[c].tolist() for c in cats)))]
    data = ("\n".join(lines) + "\n").encode()
    _, r_cat, _, _ = criteo.parse_chunk(data, n, D_MAIN, N_DENSE)
    same_slots = np.array_equal(r_cat - N_DENSE, idx[:, N_DENSE:])
    log(f"hashed slots vs criteo.parse_chunk ({criteo.parser_name()} "
        f"parser, hash_space {D_MAIN}, less n_reserved {N_DENSE}): equal "
        f"{same_slots}")
    if not same_slots:
        fail("FeatureHasher's categorical slots differ from the Criteo "
             "reader's")

    steps = n // BATCH

    def estimator(epochs):
        return (T.LogisticRegression(device=DEVICE).set_num_features(D_MAIN)
                .set_global_batch_size(BATCH).set_max_iter(epochs)
                .set_tol(0))

    E.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = estimator(EPOCHS).fit(hashed)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = dict(E.LAUNCHES)
    losses = model.loss_log
    log(f"hashed LR fit: {fit_s:.3f} s, loss log {losses}, plan "
        f"{model.planned_impl}, launches {launches} [{card}]")
    if model.planned_impl != "ell":
        fail(f"the hashed fit planned {model.planned_impl!r}, expected "
             "'ell'")
    if len(losses) != EPOCHS or not all(np.isfinite(losses)) or \
            not all(b < a for a, b in zip(losses, losses[1:])):
        fail(f"hashed loss log {losses}")
    for name in ("ell_margin", "ell_scatter_apply_fused"):
        if launches[name] != steps * EPOCHS:
            fail(f"{name} launched {launches[name]} times in the hashed "
                 f"fit, expected {steps * EPOCHS}")
    if launches["ell_scatter_apply"] != 0:
        fail("the pair kernel ran on a grid of 8192 rows")
    cfg = estimator(1)._sgd_config()
    one_k, _ = S.sgd_fit_sparse(LOSSES["logistic"], idx, vals, y, None,
                                D_MAIN, cfg, device=dev)
    one_p, _ = S.sgd_fit_sparse(LOSSES["logistic"], idx, vals, y, None,
                                D_MAIN, cfg, device=dev, plain=True)
    allclose_fit("hashed, one epoch, kernels vs plain versions on the card",
                 one_k.coefficients, one_p.coefficients)
    (out,) = model.transform(hashed.take(4096))
    coef = model.get_model_data()[0]["coefficients"][0]
    icpt = float(model.get_model_data()[0]["intercept"][0])
    margin = (vals[:4096].astype(np.float64) * coef[idx[:4096]]).sum(1) \
        + icpt
    perr = float(np.max(np.abs(out["rawPrediction"]
                               - 1.0 / (1.0 + np.exp(-margin)))))
    acc = float(np.mean(out["prediction"] == y[:4096]))
    log(f"hashed transform: 4096 rows, max |p - numpy f64 p| = {perr:.3e} "
        f"(tolerance 1e-5), accuracy {acc:.4f}")
    if perr > 1e-5 or not acc > 0.99:
        fail("hashed transform disagrees with numpy scoring, or the fit "
             "did not learn the label marker")
    log(f"phase 43: {time.perf_counter() - t_phase:.2f} s [{card}]")
    return {k: launches[k] for k in ("ell_margin", "ell_scatter_apply_fused")}


# -- phases 44-46: KMeans complete (bf16 stats, k-means++, agglomerative,
#    the data-parallel fit) --------------------------------------------------

BF16_OPS_PER_S = 989e12     # H100 SXM bf16 on the tensor cores, dense
# phase 44: a bf16 rounding moves a score -2 p.c + |c|^2 by at most
# 2 * 2^-8 * sum_j |p_j c_j| (p and c each within 2^-9, relative), so the
# gap of a row's best two scores by at most 2^-6 * max_c sum_j |p_j c_j|:
# a row whose plain f32 gap lies below that (plus 1e-5 (1 + |best|) for
# the f32 sums) may be assigned apart under bf16
BF16_GAP = 2.0 ** -6
KB_PAD = 1000               # zero pad rows of phase 44's padded problem
KP_K2, KP_ITERS2, KP_CLUSTERS = 1024, 5, 16   # phase 45's pre-clustering
DP_WORLD = 2                # phase 46: gloo ranks sharing the card
DP_DEVICE = "cuda:0"
DP_TIMEOUT_S = 300


def bf16_phase(torch, dev, card, timer):
    """Phase 44: the bf16 stats kernel (``kmeans_bf16.cu`` at the
    headline) against its plain twin, every tie policy, on the headline
    problem and on phase 6's zero-padded rows against duplicated
    centroids, and ``kmeans.cu``'s bf16 modes on the headline problem;
    times beside ``kmeans.cu``'s bf16 modes, the f32 kernel, bf16 ``addmm``
    of the score product, the bare bf16 ``mm`` and the bound; the bf16
    fit's iterations/s.  Returns the kernel line's entry (launches filled
    by phase 46) and the headline table (host and card)."""
    from flink_ml_tpu_torch.models.clustering import kmeans as KM
    from flink_ml_tpu_torch.ops import kmeans as K

    bf = torch.bfloat16
    t_phase = time.perf_counter()
    n, d, k = N_KM, D_KM, K_KM
    host = np.random.default_rng(0).normal(size=(n, d)).astype(np.float32)
    pts = torch.from_numpy(host).to(dev)
    perm = np.random.default_rng(1).permutation(n)
    cents = torch.from_numpy(
        0.5 * (host[perm[:k]] + host[perm[k:2 * k]])).to(dev)
    ones = torch.ones(n, device=dev)
    pad_pts = pts.clone()
    pad_pts[-KB_PAD:] = 0.0
    pad_mask = ones.clone()
    pad_mask[-KB_PAD:] = 0.0
    dup = cents.clone()
    dup[0] *= 0.05
    dup[k - 1] = dup[0]
    dup[k - 2] = dup[1]
    if K.bf16_plan(k, d) is None:
        fail(f"the headline (k {k}, d {d}) is outside kmeans_bf16.cu's plan")
    worst = 0.0
    for label, p, m, c in (("headline", pts, ones, cents),
                           ("zero pad rows, duplicated centroids", pad_pts,
                            pad_mask, dup)):
        real = p[:n - KB_PAD] if m is pad_mask else p
        sc = -2.0 * (real @ c.T) + (c * c).sum(1)[None, :]
        two = torch.topk(sc, 2, dim=1, largest=False).values
        bound = (BF16_GAP * (real.abs() @ c.abs().T).max(1).values
                 + 1e-5 * (1 + two[:, 0].abs()))
        exempt = int(((two[:, 1] - two[:, 0]) <= bound).sum())
        del sc
        sb = K._scores(real, c, bf)
        bnear = int(near_tie_rows(torch, sb).sum())
        del sb
        n_pad = n - int(m.sum())
        for tie, route in (("first", "kmeans_bf16.cu"),
                           ("fast", "kmeans_bf16.cu"),
                           ("split", "kmeans_bf16.cu"),
                           ("first", "kmeans.cu"), ("fast", "kmeans.cu"),
                           ("split", "kmeans.cu")):
            if route == "kmeans.cu" and m is pad_mask:
                continue
            if route == "kmeans.cu":
                s, cnt = K._launch("kmeans_update_stats_bf16",
                                   tie + "_bf16", p, c)
            else:
                s, cnt = K.kmeans_update_stats(p, c, tie_policy=tie,
                                               compute_dtype=bf)
                s2, cnt2 = K.kmeans_update_stats(p, c, tie_policy=tie,
                                                 compute_dtype=bf)
                if not (torch.equal(s, s2) and torch.equal(cnt, cnt2)):
                    fail(f"kmeans_bf16.cu ({label}, tie {tie}): two "
                         "launches differ")
            ws, wc = K.kmeans_update_stats_plain(p, c, tie_policy=tie,
                                                 compute_dtype=bf)
            cnt = K.pad_correction(cnt, c, n_pad, tie_policy=tie)
            wc = K.pad_correction(wc, c, n_pad, tie_policy=tie)
            moved = float((cnt - wc).abs().sum()) / 2
            ds = float((s - ws).abs().max())
            args = (c, 0, (p, m))
            if route == "kmeans.cu":
                # the Lloyd step from the old modes' stats, as the body
                # forms it (the body itself routes to kmeans_bf16.cu here)
                step = torch.where(cnt[:, None] > 0, s / torch.where(
                    cnt > 0, cnt, 1.0)[:, None], c)
                want = torch.where(wc[:, None] > 0, ws / torch.where(
                    wc > 0, wc, 1.0)[:, None], c)
            else:
                step = KM.kmeans_epoch_step_kernel(
                    k, tie_policy=tie, compute_dtype=bf)(*args).feedback
                want = KM.kmeans_epoch_step_kernel(
                    k, tie_policy=tie, compute_dtype=bf, plain=True)(
                        *args).feedback
            e = float((step - want).abs().max())
            if route == "kmeans_bf16.cu":
                worst = max(worst, e)
            log(f"check kmeans_update_stats_bf16 via {route} ({label}, "
                f"tie {tie}): "
                f"sums max |kernel - plain| {ds:.3e}, counts "
                f"{float((cnt - wc).abs().max()):.1f}, assignments that "
                f"differ (count moves) {moved:.1f}; rows whose plain f32 "
                f"top-two gap is below the bf16 bound {exempt}, rows within "
                f"{NEAR_TIE:g}(1+|best|) of a bf16 tie {bnear}; one Lloyd "
                f"step max |kernel - plain| {e:.3e} (allclose rtol "
                f"{KM_GATE['rtol']}, atol {KM_GATE['atol']})")
            if moved > exempt:
                fail(f"kmeans_update_stats_bf16 ({label}, tie {tie}): "
                     f"{moved} assignments differ, more than the {exempt} "
                     f"rows near a bf16 flip")
            if not torch.allclose(step, want, **KM_GATE):
                fail(f"kmeans_update_stats_bf16 ({label}, tie {tie}) "
                     "disagrees with its plain twin")
            if float(cnt.min()) < 0:
                fail(f"tie {tie}: the bf16 pad correction left a negative "
                     "count")
            if m is pad_mask and tie != "first" and not (
                    cnt[0] == cnt[k - 1] and cnt[1] == cnt[k - 2]):
                fail(f"tie {tie}: duplicated centroids got unequal bf16 "
                     "counts")
    del pad_pts

    c2b = (cents * cents).sum(1)[None, :].to(bf)
    pb, cb = pts.to(bf), cents.to(bf)
    lib_ms = timer.ms(lambda: torch.addmm(c2b, pb, cb.T, alpha=-2.0))
    mm_ms = timer.ms(lambda: torch.mm(pb, cb.T))
    f32_ms = timer.ms(lambda: K.kmeans_update_stats(pts, cents,
                                                    tie_policy="first"))
    ms = {tie: timer.ms(lambda: K.kmeans_update_stats(
        pts, cents, tie_policy=tie, compute_dtype=bf))
        for tie in ("first", "fast", "split")}
    # kmeans.cu's bf16 modes at the headline: the design before
    # kmeans_bf16.cu, in the same run
    before_ms = {tie: timer.ms(lambda: K._launch(
        "kmeans_update_stats_bf16", tie + "_bf16", pts, cents))
        for tie in ("first", "fast", "split")}
    plain_ms = timer.ms(lambda: K.kmeans_update_stats_plain(
        pts, cents, tie_policy="first", compute_dtype=bf), reps=10)
    del pb, cb
    # the bf16 BSP fit's rate, phase 7's loop (device-resident points)
    body = KM.kmeans_epoch_step_kernel(k, compute_dtype=bf)
    c_fit = body(cents, 0, (pts, ones)).feedback
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(KM_RATE_ITERS):
        c_fit = body(c_fit, i, (pts, ones)).feedback
    torch.cuda.synchronize()
    rate = KM_RATE_ITERS / (time.perf_counter() - t0)
    RATES["kmeans_bf16_iters_per_s"] = rate
    ops = 2.0 * n * k * d
    ops_ms = ops / BF16_OPS_PER_S * 1e3
    dense_ms = 2 * ops / BF16_OPS_PER_S * 1e3
    bytes_ms = (n * d + 2 * k * d + k) * 4 / HBM_BYTES_PER_S * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    bound_by = "operations" if ops_ms >= bytes_ms else "bytes"
    log(f"time kmeans_update_stats_bf16: kmeans_bf16.cu first "
        f"{ms['first']:.4f} ms, fast {ms['fast']:.4f}, split "
        f"{ms['split']:.4f}; kmeans.cu's bf16 modes first "
        f"{before_ms['first']:.4f} ms, fast {before_ms['fast']:.4f}, split "
        f"{before_ms['split']:.4f}; the f32 kernel (first) {f32_ms:.4f} ms; "
        f"plain twin {plain_ms:.4f} ms; bf16 addmm (score product only) "
        f"{lib_ms:.4f} ms, bare bf16 mm {mm_ms:.4f} ms; bound "
        f"{bound_ms:.4f} ms ({bound_by}: the f32 points read once "
        f"{bytes_ms:.4f} ms; the score product's {ops:.3e} bf16 FLOPs "
        f"{ops_ms:.4f} ms, {2 * ops:.3e} with a dense one-hot sums product "
        f"{dense_ms:.4f} ms) [{card}]")
    log(f"KMeans BSP iterations/s at {n} x {d}, k {k}, bf16: {rate:.3f} "
        f"(f32, phase 7: "
        f"{RATES.get('kmeans_iters_per_s', float('nan')):.3f}) [{card}]; "
        f"phase 44: {time.perf_counter() - t_phase:.2f} s")
    entry = {
        "name": "kmeans_update_stats_bf16", "route": "cuda",
        "source": KM_BF16_SOURCE,
        "replaces": KM_REPLACES["kmeans_update_stats"],
        "launches": 0, "max_abs_err": worst, "ms": ms["first"],
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": lib_ms, "policy_ms": ms, "kmeans_cu_ms": before_ms,
        "mm_ms": mm_ms, "iters_per_s": rate,
    }
    return entry, host, pts


KB_WIDE = ((1 << 20, 64, 1024), (1 << 20, 128, 256))   # (n, d, k)


def bf16_wide_phase(torch, dev, card, timer):
    """Phase 44, appended: the bf16 stats at the shapes outside
    ``bf16_plan`` (k 1024 at d 64, d 128 at k 256: ``kmeans.cu``'s bf16
    modes) against the plain twin under phase 44's gates (assignments
    that differ at most the rows whose f32 top-two gap lies below the
    bf16 bound; one Lloyd step within the KMeans gate on every cluster no
    such flip touched), each policy timed beside
    bf16 ``addmm`` of the score product, the bare bf16 ``mm`` and the
    bound.  Returns the times by shape."""
    from flink_ml_tpu_torch.ops import kmeans as K

    bf = torch.bfloat16
    t_phase = time.perf_counter()
    out = {}
    for n, d, k in KB_WIDE:
        if K.bf16_plan(k, d) is not None:
            fail(f"(k {k}, d {d}) is inside kmeans_bf16.cu's plan")
        host = np.random.default_rng(0).normal(size=(n, d)).astype(
            np.float32)
        pts = torch.from_numpy(host).to(dev)
        perm = np.random.default_rng(1).permutation(n)
        cents = torch.from_numpy(
            0.5 * (host[perm[:k]] + host[perm[k:2 * k]])).to(dev)
        del host
        sc = -2.0 * (pts @ cents.T) + (cents * cents).sum(1)[None, :]
        two = torch.topk(sc, 2, dim=1, largest=False).values
        del sc
        bound = (BF16_GAP * (pts.abs() @ cents.abs().T).max(1).values
                 + 1e-5 * (1 + two[:, 0].abs()))
        exempt = int(((two[:, 1] - two[:, 0]) <= bound).sum())
        del two, bound
        rec = {}
        for tie in ("first", "fast", "split"):
            s_, cnt = K.kmeans_update_stats(pts, cents, tie_policy=tie,
                                            compute_dtype=bf)
            ws, wc = K.kmeans_update_stats_plain(pts, cents, tie_policy=tie,
                                                 compute_dtype=bf)
            moved = float((cnt - wc).abs().sum()) / 2
            step = torch.where(cnt[:, None] > 0, s_ / torch.where(
                cnt > 0, cnt, 1.0)[:, None], cents)
            want = torch.where(wc[:, None] > 0, ws / torch.where(
                wc > 0, wc, 1.0)[:, None], cents)
            # a cluster holds ~n / k rows (~1000 at k 1024): one exempt
            # flip moves its centroid by ~|p - c| / 1000, ~1e-2, past the
            # KMeans gate; so the step gate holds the clusters whose
            # counts agree, and the flips are held by the exemption
            agree = cnt == wc
            e = float((step - want)[agree].abs().max())
            e_flip = float((step - want)[~agree].abs().max()) \
                if bool((~agree).any()) else 0.0
            ok = moved <= exempt and bool(torch.allclose(
                step[agree], want[agree], **KM_GATE))
            del s_, cnt, ws, wc
            ms = timer.ms(lambda: K.kmeans_update_stats(
                pts, cents, tie_policy=tie, compute_dtype=bf))
            rec[tie] = {"ms": ms, "max_abs_err": e, "moved": moved,
                        "flipped_cluster_err": e_flip}
            log(f"check kmeans_update_stats_bf16 via kmeans.cu (n {n}, d "
                f"{d}, k {k}, tie {tie}): {ms:.4f} ms; one Lloyd step max "
                f"|kernel - plain| {e:.3e} over the "
                f"{int(agree.sum())} clusters whose counts agree (allclose "
                f"rtol {KM_GATE['rtol']}, atol {KM_GATE['atol']}), "
                f"{e_flip:.3e} over the {int((~agree).sum())} a flip "
                f"touched; assignments that differ {moved:.1f} (rows near "
                f"a bf16 flip {exempt}) [{card}]")
            if not ok:
                fail(f"kmeans.cu's bf16 {tie} at (d {d}, k {k}) disagrees "
                     "with its plain twin")
        c2b = (cents * cents).sum(1)[None, :].to(bf)
        pb, cb = pts.to(bf), cents.to(bf)
        lib_ms = timer.ms(lambda: torch.addmm(c2b, pb, cb.T, alpha=-2.0))
        mm_ms = timer.ms(lambda: torch.mm(pb, cb.T))
        del pb, cb, c2b
        ops = 2.0 * n * k * d
        ops_ms = ops / BF16_OPS_PER_S * 1e3
        bytes_ms = (n * d + 2 * k * d + k) * 4 / HBM_BYTES_PER_S * 1e3
        bound_ms = max(ops_ms, bytes_ms)
        bound_by = "operations" if ops_ms >= bytes_ms else "bytes"
        rec.update(library_ms=lib_ms, mm_ms=mm_ms, bound_ms=bound_ms,
                   bound_by=bound_by)
        slower = [t for t in ("first", "fast", "split")
                  if rec[t]["ms"] > lib_ms]
        log(f"time kmeans_update_stats_bf16 via kmeans.cu at (n {n}, d {d}, "
            f"k {k}): first {rec['first']['ms']:.4f} ms, fast "
            f"{rec['fast']['ms']:.4f}, split {rec['split']['ms']:.4f}; bf16 "
            f"addmm (score product only) {lib_ms:.4f} ms, bare bf16 mm "
            f"{mm_ms:.4f} ms; bound {bound_ms:.4f} ms ({bound_by}: bytes "
            f"{bytes_ms:.4f}, the score product's {ops:.3e} bf16 FLOPs "
            f"{ops_ms:.4f}); slower than addmm: {slower or 'none'} [{card}]")
        out[f"{n}x{d}_k{k}"] = rec
        del pts, cents
    log(f"phase 44 (wide bf16 shapes): {time.perf_counter() - t_phase:.2f} "
        f"s [{card}]")
    return out


def naive_ward(X, k):
    """Ward agglomeration in numpy float64, the global closest pair each
    merge (no neighbour index), on the same squared euclidean distances;
    labels numbered by each cluster's smallest row."""
    X = X.astype(np.float64)
    n = len(X)
    sq = (X * X).sum(1)
    D = np.sqrt(np.maximum(sq[:, None] - 2.0 * (X @ X.T) + sq[None, :],
                           0.0)) ** 2
    np.fill_diagonal(D, np.inf)
    size = np.ones(n)
    root = np.arange(n)
    alive = np.ones(n, bool)
    for _ in range(n - k):
        i, j = np.unravel_index(np.argmin(D), D.shape)
        i, j = min(i, j), max(i, j)
        tot = size[i] + size[j] + size
        new = ((size[i] + size) * D[i] + (size[j] + size) * D[j]
               - size * D[i, j]) / tot
        new[~alive] = np.inf
        new[i] = np.inf
        D[i, :] = new
        D[:, i] = new
        D[j, :] = np.inf
        D[:, j] = np.inf
        alive[j] = False
        size[i] += size[j]
        root[root == j] = i
    return np.unique(root, return_inverse=True)[1].astype(np.int64)


def kpp_phase(torch, dev, card, host, pts):
    """Phase 45: k-means++ on the card (the k-1 rounds under CUDA's sync
    debug mode "error"), its fit through ``KMeans(initMode="k-means++")``
    against random init, then KMeans at k = 1024 and AgglomerativeClustering
    (ward) over its centroids against a float64 numpy re-run."""
    from flink_ml_tpu_torch import KMeans, Table
    from flink_ml_tpu_torch.distance import DistanceMeasure
    from flink_ml_tpu_torch.models import AgglomerativeClustering
    from flink_ml_tpu_torch.models.clustering import kmeans as KM
    from flink_ml_tpu_torch.ops import kmeans as K

    t_phase = time.perf_counter()
    n, d, k = N_KM, D_KM, K_KM
    ones = torch.ones(n, device=dev)

    def seeding(seed, kk=k):
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        return KM.select_kmeanspp_centroids(pts, kk, generator=gen)

    def inertia(c):
        sc = -2.0 * (pts @ c.T) + (c * c).sum(1)[None, :]
        return float(((pts * pts).sum(1) + sc.min(1).values).mean())

    seeding(1, 2)                 # allocator and kernel set-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.set_sync_debug_mode("error")
    try:
        start.record()
        init = seeding(0)
        end.record()
    except RuntimeError as exc:
        fail(f"k-means++ synchronized with the host inside its rounds: {exc}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    seed_ms = start.elapsed_time(end)
    distinct = len(torch.unique(init, dim=0))
    log(f"k-means++ seeding on the card: k {k} over {n} x {d} in "
        f"{seed_ms:.3f} ms ({k - 1} rounds, no host sync: CUDA sync debug "
        f"mode 'error'), {distinct} distinct centers [{card}]")
    if distinct != k or not torch.equal(init, seeding(0)):
        fail("k-means++: repeated centers, or one seed gave two seedings")

    est = (KMeans(device=DEVICE).set_k(k).set_max_iter(KM_ITERS)
           .set_init_mode("k-means++"))
    K.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = est.fit(Table({"features": host}))
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    got = torch.from_numpy(model.get_model_data()[0]["centroids"][0]).to(dev)
    measure = DistanceMeasure.get_instance("euclidean")
    replay = KM.fit_centroids(pts, ones, init, KM._fit_plan(n, d, k, measure),
                              measure=measure, max_iter=KM_ITERS).state
    rand_init = torch.from_numpy(KM.select_random_centroids(host, k, 0)).to(
        dev)
    rand_fit = torch.from_numpy(
        FITTED["kmeans"].get_model_data()[0]["centroids"][0]).to(dev)
    costs = {"k-means++": (inertia(init), inertia(got)),
             "random": (inertia(rand_init), inertia(rand_fit))}
    log(f"KMeans(initMode='k-means++') fit: {fit_s:.3f} s for {KM_ITERS} "
        f"rounds (seeding and host->device copy included), plan "
        f"{est.planned_impl}, launches {launches}; cost (mean squared "
        f"distance to the nearest centroid) initial / after {KM_ITERS} "
        f"rounds: k-means++ {costs['k-means++'][0]:.6f} / "
        f"{costs['k-means++'][1]:.6f}, random init with the same seed "
        f"(phase 7's fit) {costs['random'][0]:.6f} / "
        f"{costs['random'][1]:.6f} [{card}]")
    if est.planned_impl != "kernel" or launches["kmeans_update_stats"] != \
            KM_ITERS or sum(launches.values()) != KM_ITERS:
        fail(f"k-means++ fit launches {launches}")
    if not torch.equal(replay, got):
        fail("the k-means++ fit is not its seeding's rounds")
    if not all(b < a for a, b in costs.values()):
        fail(f"a fit did not lower its cost: {costs}")

    est2 = KMeans(device=DEVICE).set_k(KP_K2).set_max_iter(KP_ITERS2)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    pre = est2.fit(Table({"features": host}))
    torch.cuda.synchronize()
    pre_s = time.perf_counter() - t0
    pre_launches = dict(K.LAUNCHES)
    cents = pre.get_model_data()[0]["centroids"][0]
    if pre_launches["kmeans_update_stats"] != KP_ITERS2 or \
            sum(pre_launches.values()) != KP_ITERS2:
        fail(f"k = {KP_K2} fit launches {pre_launches}")
    t0 = time.perf_counter()
    (out,) = (AgglomerativeClustering().set_num_clusters(KP_CLUSTERS)
              .set_linkage("ward").transform(Table({"features": cents})))
    agg_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = naive_ward(cents, KP_CLUSTERS)
    ref_s = time.perf_counter() - t0
    labels = out["prediction"]
    log(f"pre-clustering: KMeans k {KP_K2}, {KP_ITERS2} rounds in "
        f"{pre_s:.3f} s (launches {pre_launches}), then "
        f"AgglomerativeClustering(ward, {KP_CLUSTERS} clusters) over its "
        f"{KP_K2} centroids on the host in {agg_s:.3f} s (numpy float64 "
        f"re-run {ref_s:.3f} s); labels equal: "
        f"{bool(np.array_equal(labels, want))}; cluster sizes "
        f"{np.bincount(labels).tolist()}; phase 45: "
        f"{time.perf_counter() - t_phase:.2f} s [{card}]")
    if not np.array_equal(labels, want):
        fail("AgglomerativeClustering disagrees with the float64 re-run")


def dp_rank(rank, world, rounds, n, d, k):
    """Phase 46's work on one rank of a process group on the card: the
    KMeans fit of this rank's share of the headline table (n x d, numpy
    seed 0; f32, then bf16), launches counted around each fit, then the
    fit's rounds replayed through the group's kernel body from the same
    init."""
    import torch

    from flink_ml_tpu_torch import KMeans, Table
    from flink_ml_tpu_torch.models.clustering import kmeans as KM
    from flink_ml_tpu_torch.ops import kmeans as K
    from flink_ml_tpu_torch.parallel import default_mesh, distributed

    host = np.random.default_rng(0).normal(size=(n, d)).astype(np.float32)
    shards = np.split(host, world)
    dev = distributed.rank_device()
    pts = torch.from_numpy(shards[rank]).to(dev)
    ones = torch.ones(len(pts), device=dev)
    init = torch.from_numpy(KM.select_random_centroids(shards[0], k,
                                                       0)).to(dev)
    out = {}
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        est = (KMeans(device=dev, compute_dtype=dt).set_k(k)
               .set_max_iter(rounds))
        K.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = est.fit(Table({"features": shards[rank]}))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
        cents = torch.from_numpy(model.get_model_data()[0]["centroids"][0])
        body = KM.kmeans_epoch_step_kernel(
            k, compute_dtype=dt, mesh=default_mesh(),
            n_pad=torch.zeros((), device=dev))
        states = [init]
        for r in range(rounds):
            states.append(body(states[-1], r, (pts, ones)).feedback)
        out[dtype] = {"centroids": cents, "launches": launches,
                      "wall_s": wall, "plan": est.planned_impl,
                      "states": torch.stack(states),
                      "replay_equal": bool(torch.equal(states[-1].cpu(),
                                                       cents))}
    return out


def parallel_phase(torch, dev, card, host, pts):
    """Phase 46: the data-parallel KMeans fit on the card, two gloo ranks
    sharing it (NCCL refuses two ranks on one device) and a one-rank NCCL
    group, f32 and bf16; returns each dtype's stats launches by group."""
    from flink_ml_tpu_torch.distance import DistanceMeasure
    from flink_ml_tpu_torch.models.clustering import kmeans as KM
    from flink_ml_tpu_torch.utils.backend import run_on_ranks

    t_phase = time.perf_counter()
    n, d, k = N_KM, D_KM, K_KM
    ones = torch.ones(n, device=dev)
    measure = DistanceMeasure.get_instance("euclidean")
    plan = KM._fit_plan(n, d, k, measure)
    keys = {"float32": "kmeans_update_stats",
            "bfloat16": "kmeans_update_stats_bf16"}
    runs = {}
    for label, world, backend in ((f"gloo_{DP_WORLD}_ranks", DP_WORLD,
                                   "gloo"), ("nccl_1_rank", 1, "nccl")):
        t0 = time.perf_counter()
        try:
            runs[label] = run_on_ranks(dp_rank, world, world, KM_ITERS, n,
                                       d, k, device=DP_DEVICE,
                                       backend=backend,
                                       timeout_s=DP_TIMEOUT_S)
        except (RuntimeError, TimeoutError) as exc:
            fail(f"the {label} fit failed: {exc}")
        log(f"{label}: spawned and fitted in {time.perf_counter() - t0:.2f} "
            f"s (f32 and bf16, {KM_ITERS} rounds each)")
    launches = {}
    for dtype, key in keys.items():
        dt = getattr(torch, dtype)
        launches[dtype] = {}
        for label, ranks in runs.items():
            world = len(ranks)
            res = [r[dtype] for r in ranks]
            for r, one in enumerate(res):
                want = {key: KM_ITERS}
                got = {kk: v for kk, v in one["launches"].items() if v}
                log(f"{label} {dtype} rank {r}: plan {one['plan']}, fit "
                    f"{one['wall_s']:.3f} s, launches {got} (one a round), "
                    f"replay equals the fit: {one['replay_equal']}")
                if one["plan"] != "kernel" or got != want:
                    fail(f"{label} {dtype} rank {r}: launches {got}")
                if not one["replay_equal"]:
                    fail(f"{label} {dtype} rank {r}: the replay is not the "
                         "fit")
                if not np.array_equal(one["centroids"], res[0]["centroids"]):
                    fail(f"{label} {dtype}: rank {r}'s centroids differ "
                         "from rank 0's")
            launches[dtype][label] = sum(one["launches"][key] for one in res)
            shard0 = np.split(host, world)[0]
            init = torch.from_numpy(KM.select_random_centroids(shard0, k,
                                                               0)).to(dev)
            one_proc = KM.fit_centroids(pts, ones, init, plan,
                                        measure=measure, max_iter=KM_ITERS,
                                        compute_dtype=dt).state
            got = torch.from_numpy(res[0]["centroids"]).to(dev)
            if world == 1:
                same = bool(torch.equal(got, one_proc))
                log(f"{label} {dtype}: equal to the one-process card fit "
                    f"from the same init bit for bit: {same}")
                if not same:
                    fail(f"{label} {dtype}: the one-rank fit is not the "
                         "one-process fit")
                continue
            states = torch.from_numpy(res[0]["states"]).to(dev)
            body = KM.kmeans_epoch_step_kernel(k, compute_dtype=dt)
            worst = 0.0
            for r in range(KM_ITERS):
                step = body(states[r], r, (pts, ones)).feedback
                worst = max(worst, float((step - states[r + 1]).abs().max()))
                if not torch.allclose(step, states[r + 1], **KM_GATE):
                    fail(f"{label} {dtype}: round {r} disagrees with the "
                         "one-process round from the same centroids")
            inert = [float(((pts * pts).sum(1) + (
                -2.0 * (pts @ c.T) + (c * c).sum(1)[None, :]).min(1).values)
                .mean()) for c in (got, one_proc)]
            log(f"{label} {dtype}: every round within the KMeans gate "
                f"(allclose rtol {KM_GATE['rtol']}, atol {KM_GATE['atol']}) "
                f"of the one-process round from the same centroids, worst "
                f"{worst:.3e}; the whole fits differ by max "
                f"{float((got - one_proc).abs().max()):.3e}, inertia "
                f"{inert[0]:.6f} against {inert[1]:.6f} (1e-3 relative)")
            if not abs(inert[0] - inert[1]) <= 1e-3 * inert[1]:
                fail(f"{label} {dtype}: the fit's objective is off the "
                     "one-process fit's")
    log(f"phase 46: {time.perf_counter() - t_phase:.2f} s [{card}]")
    return launches


GR_WORLD = 4                # phase 47: gloo ranks sharing the card
GR_D = 1 << 20              # bench_comm's gradient width (bench.py:1663)
GR_DENSITY = 0.1
GR_BUCKETS = 8
GR_LADDER = (0.01, 0.05, 0.1, "exact")
GR_BLOCK = 256              # int8 elements a scale
GR_REPS = 5                 # timed reduces a mode (after the gated one)
GR_FIT_D = 1 << 14          # bench_comm's fit width (bench.py:1905)
GR_FIT_ROWS = 256           # a rank's rows a step (bench.py:1906)
GR_FIT_STEPS = 8
GR_FIT_EPOCHS = 12
GR_FIT_LR = 0.1
GR_FIT_TOL = dict(rtol=1e-3, atol=1e-4)     # bench.py:266
GR_LOSS_GAP = 1e-3          # test_sgd_topk_ef_density01_converges_to_dense
GR_TIMEOUT_S = 600
GR_ONE_RANK_BACKEND = "nccl"
GR_U = 2.0 ** -24           # f32 unit roundoff


def gr_sizes():
    """Phase 47's sizes, handed to the ranks (which import this module
    afresh)."""
    return dict(d=GR_D, fit_d=GR_FIT_D, rows=GR_FIT_ROWS,
                steps=GR_FIT_STEPS, epochs=GR_FIT_EPOCHS, reps=GR_REPS)


def _fence(torch, dev):
    """Wait for the rank's card (the timing fence of phase 47)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def gr_grads(rank, d):
    """Rank ``rank``'s gradient tree of phase 47 (numpy seed 4700 +
    rank): ``w`` of ``d`` f32, N(0, 1) with its first 64 entries 0 (ties
    the selection must order), and the bias."""
    rng = np.random.default_rng(4700 + rank)
    w = rng.normal(size=d).astype(np.float32)
    w[:64] = 0.0
    return {"w": w, "b": np.float32(rng.normal())}


def gr_fit_rows(rank, sz):
    """Rank ``rank``'s rows of phase 47's fit: bench_comm's features
    (N(0, 1) / 16, numpy seed 11 + rank) labelled by a planted weight
    (seed 10), ``sz["steps"]`` steps of ``sz["rows"]``."""
    n = sz["steps"] * sz["rows"]
    X = (np.random.default_rng(11 + rank).normal(size=(n, sz["fit_d"]))
         / 16.0).astype(np.float32)
    w_true = np.random.default_rng(10).normal(size=sz["fit_d"])
    return X, (X @ w_true > 0).astype(np.float64)


def gr_modes():
    """Phase 47's reduces: (name, config, hybrid mesh)."""
    from flink_ml_tpu_torch.parallel.grad_reduce import GradReduceConfig as G

    tk = dict(mode="topk", density=GR_DENSITY)
    return [
        ("exact", G(), False),
        ("topk_allgather", G(**tk, wire_protocol="allgather"), False),
        ("topk_rd", G(**tk), False),
        ("int8_dequant", G(mode="int8", block_size=GR_BLOCK), False),
        ("int8_fixed", G(mode="int8", block_size=GR_BLOCK,
                         int8_accum="fixed"), False),
        ("topk_buckets8", G(**tk, bucket_count=GR_BUCKETS), False),
        ("adaptive", G(**tk, bucket_count=GR_BUCKETS, adaptive=True,
                       adaptive_window=2, density_ladder=GR_LADDER), False),
        ("hier_exact", G(dcn_axis="dcn"), True),
        ("hier_topk", G(**tk, dcn_axis="dcn"), True),
        ("hier_int8", G(mode="int8", block_size=GR_BLOCK, dcn_axis="dcn",
                        int8_accum="fixed"), True),
    ]


def topk_oracle(acc, k):
    """numpy's EF top-k of one unit: (sent, residual) by a stable
    descending argsort of |acc| (the JAX package's test oracle)."""
    order = np.argsort(-np.abs(acc), kind="stable")[:k]
    sent = np.zeros_like(acc)
    sent[order] = acc[order]
    res = acc.copy()
    res[order] = 0.0
    return sent, res


def gr_rank(rank, world, sz):
    """Phase 47 on one rank of a group on the card: each mode's first
    reduce (gated by the parent; the flat top-k residuals checked here
    against numpy bit for bit), its median time over ``GR_REPS`` more,
    its measured fill and the rounds staged through the host; then the
    data-parallel dense LR fits."""
    import hashlib
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from flink_ml_tpu_torch.models.common import sgd as S
    from flink_ml_tpu_torch.models.common.losses import LOSSES
    from flink_ml_tpu_torch.parallel import collectives as C
    from flink_ml_tpu_torch.parallel import distributed
    from flink_ml_tpu_torch.parallel import grad_reduce as GR
    from flink_ml_tpu_torch.parallel.grad_reduce import GradReduceConfig
    from flink_ml_tpu_torch.parallel.mesh import default_mesh

    dev = distributed.rank_device()
    flat = default_mesh()
    hybrid = distributed.hybrid_mesh({"data": 2})
    host = gr_grads(rank, sz["d"])
    g = {"w": torch.from_numpy(host["w"]).to(dev),
         "b": torch.tensor(host["b"], device=dev)}
    like = {"w": host["w"], "b": host["b"]}
    out = {"modes": {}}
    for name, cfg, hier in gr_modes():
        mesh = hybrid if hier else flat
        state = GR.init_state(cfg, g, mesh)
        reader = GR.RungReader(cfg) if cfg.adaptive else None

        def step(st):
            rungs = reader.rungs(st) if reader is not None else None
            return GR.reduce_gradients(g, st, cfg, mesh=mesh, rungs=rungs)

        C.reset_staged()
        distributed.barrier()
        _fence(torch, dev)
        t0 = time.perf_counter()
        red, st1 = step(state)
        _fence(torch, dev)
        first_ms = 1e3 * (time.perf_counter() - t0)
        staged = dict(C.STAGED)
        red_h = {k: v.cpu().numpy() for k, v in red.items()}
        rec = {"first_ms": first_ms, "staged": staged,
               "digest": hashlib.md5(red_h["w"].tobytes()
                                     + red_h["b"].tobytes()).hexdigest()}
        if rank == 0:
            rec["red"] = red_h
        if "fill" in st1:
            hop = 2 if hier else world
            rec["payload"] = GR.payload_bytes(
                like, cfg, ici_size=2 if hier else 1, hop_size=hop,
                fill=st1["fill"])
            rec["fill"] = st1["fill"].cpu().numpy()
        else:
            rec["payload"] = GR.payload_bytes(like, cfg,
                                              ici_size=2 if hier else 1)
        if cfg.mode == "topk" and not hier and not cfg.adaptive:
            # this rank's residual against numpy's, unit by unit
            plan = GR.plan_buckets(like, cfg)
            flat_g = np.concatenate([np.atleast_1d(host["b"]), host["w"]])
            units = (plan.ranges if cfg.bucket_count else
                     [(0, 1), (1, 1 + sz["d"])])
            want = np.concatenate([topk_oracle(flat_g[lo:hi], max(1, int(
                (hi - lo) * GR_DENSITY)))[1] for lo, hi in units])
            got = np.concatenate([np.atleast_1d(
                st1["ef"]["b"].cpu().numpy()), st1["ef"]["w"].cpu().numpy()])
            rec["residual_equal"] = bool(np.array_equal(got, want))
        if cfg.mode == "int8":
            rec["key"] = st1["key"].cpu().tolist()
        ms = []
        st = st1
        for _ in range(sz["reps"]):
            distributed.barrier()
            _fence(torch, dev)
            t0 = time.perf_counter()
            _, st = step(st)
            _fence(torch, dev)
            ms.append(1e3 * (time.perf_counter() - t0))
        rec["ms"] = statistics.median(ms)
        if reader is not None:
            rec["rungs"] = st["rung"].cpu().tolist()
            rec["rung_reads"] = reader.reads
        out["modes"][name] = rec
        del state, st1, st, red

    # (b) the data-parallel dense LR fit of this rank's rows
    X, y = gr_fit_rows(rank, sz)
    fits = {
        "exact": None,
        "topk": GradReduceConfig(mode="topk", density=GR_DENSITY),
        "blocking": GradReduceConfig(mode="topk", density=GR_DENSITY,
                                     bucket_count=GR_BUCKETS),
        "overlapped": GradReduceConfig(mode="topk", density=GR_DENSITY,
                                       bucket_count=GR_BUCKETS,
                                       overlap=True),
    }
    out["fits"] = {}
    for name, gr in fits.items():
        cfg = S.SGDConfig(learning_rate=GR_FIT_LR,
                          max_epochs=sz["epochs"], tol=0,
                          global_batch_size=sz["rows"] * world,
                          grad_reduce=gr)
        C.reset_staged()
        distributed.barrier()
        _fence(torch, dev)
        t0 = time.perf_counter()
        state, log = S.sgd_fit(LOSSES["logistic"], X, y, None, cfg, dev)
        _fence(torch, dev)
        wall = time.perf_counter() - t0
        out["fits"][name] = {
            "w": state.coefficients, "b": state.intercept, "log": log,
            "wall_s": wall,
            "step_ms": 1e3 * wall / (sz["epochs"] * sz["steps"]),
            "staged": dict(C.STAGED)}
    return out


def gr_one_rank(rank, world, sz):
    """Phase 47(c): the exact and top-k fits of every rank's rows (the
    one-process order, :func:`gr_one_process_rows`) in a one-rank
    group."""
    import torch

    from flink_ml_tpu_torch.models.common import sgd as S
    from flink_ml_tpu_torch.models.common.losses import LOSSES
    from flink_ml_tpu_torch.parallel import distributed
    from flink_ml_tpu_torch.parallel.grad_reduce import GradReduceConfig

    X, y = gr_one_process_rows(GR_WORLD, sz)
    dev = distributed.rank_device()
    out = {}
    for name, gr in (("exact", None), ("topk", GradReduceConfig(
            mode="topk", density=GR_DENSITY))):
        cfg = S.SGDConfig(learning_rate=GR_FIT_LR,
                          max_epochs=sz["epochs"], tol=0,
                          global_batch_size=sz["rows"] * GR_WORLD,
                          grad_reduce=gr)
        state, log = S.sgd_fit(LOSSES["logistic"], X, y, None, cfg, dev)
        _fence(torch, dev)
        out[name] = {"w": state.coefficients, "b": state.intercept,
                     "log": log}
    return out


def gr_one_process_rows(world, sz):
    """Every rank's rows in the order that gives a one-process fit the
    ranks' step batches: step i's global batch is each rank's step-i rows
    (its own seeded permutation), rank after rank, and the fit's own
    permutation (seed 0) puts them there."""
    parts = [gr_fit_rows(r, sz) for r in range(world)]
    n_local = len(parts[0][0])
    local = np.random.default_rng(0).permutation(n_local)
    b = sz["rows"]
    rows = [(r, local[i * b:(i + 1) * b])
            for i in range(sz["steps"]) for r in range(world)]
    Xd = np.concatenate([parts[r][0][idx] for r, idx in rows])
    yd = np.concatenate([parts[r][1][idx] for r, idx in rows])
    perm = np.random.default_rng(0).permutation(len(Xd))
    X, y = np.empty_like(Xd), np.empty_like(yd)
    X[perm], y[perm] = Xd, yd
    return X, y


def grad_reduce_phase(torch, dev, card):
    """Phase 47: the compressed data-parallel gradient reduction
    (``parallel/grad_reduce.py``) on four gloo ranks sharing the card, as
    a flat ``{"data": 4}`` mesh and a 2x2 ``("dcn", "data")`` mesh, gated
    against numpy oracles of the same seeded inputs; the data-parallel
    dense LR fit on those ranks; the same fit in a one-rank NCCL group.
    No kernel of the table runs here (the JAX package reduces in
    ``jnp``)."""
    from flink_ml_tpu_torch.models.common import sgd as S
    from flink_ml_tpu_torch.models.common.losses import LOSSES
    from flink_ml_tpu_torch.parallel import grad_reduce as GR
    from flink_ml_tpu_torch.utils.backend import run_on_ranks

    t_phase = time.perf_counter()
    world = GR_WORLD
    sz = gr_sizes()
    t0 = time.perf_counter()
    try:
        ranks = run_on_ranks(gr_rank, world, world, sz,
                             device=DP_DEVICE, backend="gloo",
                             timeout_s=GR_TIMEOUT_S)
    except (RuntimeError, TimeoutError) as exc:
        fail(f"phase 47's gloo ranks failed: {exc}")
    log(f"phase 47: {world} gloo ranks on the card spawned and run in "
        f"{time.perf_counter() - t0:.2f} s")
    hosts = [gr_grads(r, sz["d"]) for r in range(world)]
    W = np.stack([h["w"] for h in hosts])
    B = np.asarray([h["b"] for h in hosts], np.float32)
    exact64 = W.astype(np.float64).sum(0)
    abs_sum = np.abs(W).astype(np.float64).sum(0)
    k = max(1, int(sz["d"] * GR_DENSITY))
    modes = {name: (cfg, hier) for name, cfg, hier in gr_modes()}
    for name, (cfg, hier) in modes.items():
        recs = [r["modes"][name] for r in ranks]
        red = recs[0]["red"]["w"]
        if any(r["digest"] != recs[0]["digest"] for r in recs):
            fail(f"phase 47 {name}: the ranks' reduced gradients differ")
        if not np.all(np.isfinite(red)) or red.shape != (sz["d"],):
            fail(f"phase 47 {name}: reduced gradient {red.shape}, finite "
                 f"{bool(np.all(np.isfinite(red)))}")
        if cfg.mode == "exact":
            # a sum of 4 f32 values in any order is within (P-1) u sum|x|
            # of the exact sum (the adaptive ladder's exact rung too)
            err = np.abs(red - exact64)
            gate = (world - 1) * GR_U * abs_sum * (1 + 1e-6) + 1e-30
            ok = bool(np.all(err <= gate))
            detail = (f"max |red - f64 sum| {float(err.max()):.3e} within "
                      f"(P-1) u sum|g|: {ok}")
        elif cfg.mode == "topk" and not hier and not cfg.adaptive:
            if cfg.bucket_count:
                plan = GR.plan_buckets({"w": W[0], "b": B[0]}, cfg)
                flat_all = np.concatenate([B[:, None], W], axis=1)
                sent = np.stack([np.concatenate([topk_oracle(
                    flat_all[p, lo:hi], max(1, int((hi - lo) * GR_DENSITY)))[0]
                    for lo, hi in plan.ranges]) for p in range(world)])[:, 1:]
            else:
                sent = np.stack([topk_oracle(W[p], k)[0]
                                 for p in range(world)])
            seq = sent[0].copy()
            for p in range(1, world):
                seq = seq + sent[p]
            res_ok = all(r["residual_equal"] for r in recs)
            if cfg.wire_protocol == "allgather":
                # rank-order f32 sums of the gathered pairs: numpy's bits
                same = bool(np.array_equal(red, seq))
            else:
                err = np.abs(red - sent.astype(np.float64).sum(0))
                same = bool(np.all(err <= (world - 1) * GR_U * np.abs(
                    sent).astype(np.float64).sum(0) * (1 + 1e-6)))
            ok = res_ok and same
            detail = (f"residuals = numpy's stable-argsort top-k on every "
                      f"rank: {res_ok}; sum "
                      + ("= numpy's rank-order f32 sum bit for bit"
                         if cfg.wire_protocol == "allgather" else
                         "within (P-1) u sum|sent| of the f64 sum")
                      + f": {same}")
        elif cfg.mode == "int8" and cfg.int8_accum == "fixed":
            # the integer totals, from the port's stream on the host: flat
            # over the 4 ranks, or (2x2) over the dcn pair of each fast-
            # axis shard of the rows' sums
            hop = ([[(p, W[p]) for p in range(world)]] if not hier else
                   [[(2 * m + i, np.split(W[2 * m] + W[2 * m + 1], 2)[i])
                     for m in range(2)] for i in range(2)])
            want = []
            for members in hop:
                blocks = np.stack([x for _, x in members]).reshape(
                    len(members), -1, GR_BLOCK)
                scale = np.maximum(np.abs(blocks).max(axis=2, keepdims=True)
                                   / np.float32(127.0), np.float32(1e-12))
                scale = scale.max(axis=0).astype(np.float32)
                total = np.zeros(blocks.shape[1:], np.int64)
                for j, (p, _) in enumerate(members):
                    u = GR.draw_uniform(torch.tensor([0, p, 1]), 1,
                                        blocks.shape[1:], "cpu").numpy()
                    q = np.clip(np.floor(blocks[j] / scale + u), -127, 127)
                    total += q.astype(np.int64)
                want.append((total.astype(np.int32).astype(np.float32)
                             * scale).reshape(-1))
            ok = bool(np.array_equal(red, np.concatenate(want)))
            detail = f"integer totals = numpy's exactly: {ok}"
        elif cfg.mode == "topk" and hier:
            # each fast-axis shard of each dcn row's sum (f32, rank order)
            # sends its top-k; the dcn pair's two sends add exactly
            want = []
            for i in range(2):
                sent = [topk_oracle(np.split(W[2 * m] + W[2 * m + 1], 2)[i],
                                    max(1, int(sz["d"] // 2 * GR_DENSITY)))[0]
                        for m in range(2)]
                want.append(sent[0] + sent[1])
            ok = bool(np.array_equal(red, np.concatenate(want)))
            detail = ("sum = numpy's top-k of each dcn row's fast-axis "
                      f"shards, bit for bit: {ok}")
        elif cfg.mode == "int8" and not hier:
            scales = np.abs(W.reshape(world, -1, GR_BLOCK)).max(2) / 127.0
            bound = np.repeat(scales.sum(0), GR_BLOCK) * (1 + 1e-5) + 1e-6
            err = np.abs(red - exact64)
            ok = bool(np.all(err <= bound))
            detail = (f"max |red - f64 sum| {float(err.max()):.3e} within "
                      f"P quantization steps: {ok}")
        else:
            # the adaptive ladder: finite, the same bits on every rank
            err = np.abs(red - exact64)
            ok = bool(np.all(np.isfinite(red)))
            detail = (f"max |red - f64 sum| {float(err.max()):.3e} (no "
                      "numpy oracle gate: finite, the same on every rank)")
        pay = recs[0]["payload"]
        wire = pay.get("wire") or {}
        fill = recs[0].get("fill")
        log(f"phase 47 {name}{' (2x2 dcn x data)' if hier else ''}: "
            f"first reduce {recs[0]['first_ms']:.3f} ms, median of "
            f"{sz['reps']} more {statistics.median(r['ms'] for r in recs):.3f}"
            f" ms (rank 0 {recs[0]['ms']:.3f}); payload "
            f"{pay['compressed_bytes']} of {pay['dense_bytes']} B "
            f"(ratio {pay['compression_ratio']}, wire protocol "
            f"{pay['wire_protocol']}"
            + (f", ici {pay['ici_bytes']} B" if 'ici_bytes' in pay else "")
            + (f"; rd measured {wire.get('rd_bytes_measured')} B vs "
               f"all-gather {wire.get('allgather_bytes')}, fill rounds "
               f"{wire.get('fill_rounds_measured')}, switched "
               f"{wire.get('switch_rate_measured')}" if wire else "")
            + f"); pairwise rounds: "
            + (f"host staging (gloo ranks with CUDA tensors), "
               f"{recs[0]['staged']['rounds']} rounds, "
               f"{recs[0]['staged']['bytes']} B through the host"
               if recs[0]['staged']['rounds'] else "none")
            + (f"; rungs {recs[0]['rungs']} after {1 + sz['reps']} steps, "
               f"{recs[0]['rung_reads']} host reads"
               if 'rungs' in recs[0] else "")
            + (f"; union {float(fill[:, GR.FILL_UNION_SLOT].max()):.0f}"
               if fill is not None else "")
            + f"; {detail} [{card}]")
        if not ok:
            fail(f"phase 47 {name}: {detail}")

    # (b) the data-parallel fits against the one-process fit of the same
    # step batches, and (c) the one-rank NCCL group
    X1, y1 = gr_one_process_rows(world, sz)
    base = dict(learning_rate=GR_FIT_LR, max_epochs=sz["epochs"], tol=0,
                global_batch_size=sz["rows"] * world)
    one = {}
    for name, gr in (("exact", None), ("topk", GR.GradReduceConfig(
            mode="topk", density=GR_DENSITY))):
        _fence(torch, dev)
        t0 = time.perf_counter()
        st, lg = S.sgd_fit(LOSSES["logistic"], X1, y1, None,
                           S.SGDConfig(**base, grad_reduce=gr), dev)
        _fence(torch, dev)
        one[name] = (st, lg, time.perf_counter() - t0)
    fits = {name: ranks[0]["fits"][name] for name in ranks[0]["fits"]}
    for name in fits:
        for r in ranks[1:]:
            if not (np.array_equal(r["fits"][name]["w"], fits[name]["w"])
                    and r["fits"][name]["log"] == fits[name]["log"]):
                fail(f"phase 47 fit {name}: the ranks' weights differ")
    st1 = one["exact"][0]
    ex = fits["exact"]
    d_ex = float(np.abs(ex["w"] - st1.coefficients).max())
    log(f"phase 47 fit (d {sz['fit_d']}, {world} ranks x {sz['rows']} rows "
        f"a step, {sz['steps']} steps, {sz['epochs']} epochs, lr "
        f"{GR_FIT_LR}): exact loss {ex['log'][-1]:.6f} vs one process "
        f"{one['exact'][1][-1]:.6f}, max |dw| {d_ex:.3e} (allclose rtol "
        f"{GR_FIT_TOL['rtol']}, atol {GR_FIT_TOL['atol']}); "
        + "; ".join(f"{n} loss {f['log'][-1]:.6f} ({f['step_ms']:.3f} ms a "
                    f"step, {f['wall_s']:.3f} s)" for n, f in fits.items())
        + f"; one-process fits {one['exact'][2]:.3f} / {one['topk'][2]:.3f} "
        f"s [{card}]")
    if not (np.allclose(ex["w"], st1.coefficients, **GR_FIT_TOL)
            and abs(ex["b"] - st1.intercept) <= GR_FIT_TOL["atol"]
            + GR_FIT_TOL["rtol"] * abs(st1.intercept)):
        fail("phase 47: the exact data-parallel fit is off the one-process "
             "fit of the same step batches")
    dense_loss = ex["log"][-1]
    for name in ("topk", "overlapped"):
        gap = abs(fits[name]["log"][-1] - dense_loss)
        log(f"phase 47 fit {name}: final loss {fits[name]['log'][-1]:.6f}, "
            f"{gap:.3e} from the dense fit's (gate {GR_LOSS_GAP})")
        if not gap < GR_LOSS_GAP:
            fail(f"phase 47 fit {name}: {gap} from the dense fit's loss")
    log(f"phase 47 fit step ms, top-k {GR_DENSITY} x {GR_BUCKETS} buckets: "
        f"blocking {fits['blocking']['step_ms']:.3f}, overlapped "
        f"{fits['overlapped']['step_ms']:.3f} (rounds staged through the "
        f"host in the overlapped fit: "
        f"{fits['overlapped']['staged']['rounds']}) [{card}]")

    t0 = time.perf_counter()
    try:
        (nccl,) = run_on_ranks(gr_one_rank, 1, 1, sz,
                               device=DP_DEVICE, backend=GR_ONE_RANK_BACKEND,
                               timeout_s=GR_TIMEOUT_S)
    except (RuntimeError, TimeoutError) as exc:
        fail(f"phase 47's one-rank NCCL group failed: {exc}")
    for name in ("exact", "topk"):
        st, lg, _ = one[name]
        same = (np.array_equal(nccl[name]["w"], st.coefficients)
                and nccl[name]["b"] == st.intercept
                and nccl[name]["log"] == lg)
        log(f"phase 47 one-rank NCCL {name} fit: equal to the one-process "
            f"card fit bit for bit: {same}")
        if not same:
            fail(f"phase 47: the one-rank NCCL {name} fit is not the "
                 "one-process fit")
    log(f"phase 47: one-rank group {time.perf_counter() - t0:.2f} s; "
        f"phase 47 wall {time.perf_counter() - t_phase:.2f} s [{card}]")


def killing_at(wins, at, exc):
    """A live feed that dies handing out window ``at``."""
    for i, w in enumerate(wins):
        if i == at:
            raise exc()
        yield w


def main():
    import torch
    import torch.nn.functional as F

    # -- 1. device ---------------------------------------------------------
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no GPU")
    try:
        import flink_ml_tpu_torch
    except ImportError as exc:
        fail(f"flink_ml_tpu_torch is not importable ({exc}); run from the "
             "root of a checkout")
    pkg_dir = os.path.dirname(os.path.abspath(flink_ml_tpu_torch.__file__))
    if os.path.dirname(pkg_dir) != HERE:
        fail(f"flink_ml_tpu_torch came from {pkg_dir}, not this checkout")
    from flink_ml_tpu_torch import LogisticRegression, Table
    from flink_ml_tpu_torch.kernels import build
    from flink_ml_tpu_torch.models.common import sgd as S
    from flink_ml_tpu_torch.models.common.losses import LOSSES
    from flink_ml_tpu_torch.ops import ell_scatter as E

    dev = torch.device(DEVICE)
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # -- 2. build ----------------------------------------------------------
    secs = build.build_all()
    log(f"build: {secs:.2f} s (0 = already built)")
    for name in ("ell_scatter", "kmeans", "kmeans_bf16", "emb_grad",
                 "retrieve"):
        log(f"nvcc report ({name}):\n" + (build.build_log(name) or "(none)"))

    # -- 3. kernels vs plain versions at the main path's shapes ------------
    dense1, cat1, _ = criteo_rows(BATCH, D_MAIN, seed=1)
    lay = E.ell_layout(cat1[None], D_MAIN).to(dev)
    rows = D_MAIN // 128
    m_len = S._ext_len(BATCH)
    rng = np.random.default_rng(2)
    w = torch.from_numpy(rng.normal(size=D_MAIN).astype(np.float32)).to(dev)
    r = rng.normal(size=BATCH).astype(np.float32) / BATCH
    r_ext = S._extended_r(torch.from_numpy(r).to(dev))
    val = torch.from_numpy(rng.normal(size=(rows, 128)).astype(np.float32)
                           ).to(dev)
    src, pos, mask = lay.src[0], lay.pos[0], lay.mask[0]
    lr = 0.5
    log(f"layout at {D_MAIN} features: kept slots {int((src != BATCH).sum())}, overflow "
        f"{int(lay.need_ovf[0])}, heavy indices {int(lay.need_heavy[0])}")

    err = {}

    def check(name, got, want):
        torch.cuda.synchronize()
        e = float((got - want).abs().max())
        err[name] = max(err.get(name, 0.0), e)
        log(f"check {name}: max |kernel - plain| = {e:.3e} "
            f"(tolerance {TOL[name]:.0e})")
        if not e <= TOL[name]:
            fail(f"{name} disagrees with its plain version")

    for v in (None, val):
        route_w, route_val = E.sample_routing(src, pos, mask, BATCH, val=v)
        got = E.ell_margin(w, route_w, m_len=m_len, route_val=route_val)
        again = E.ell_margin(w, route_w, m_len=m_len, route_val=route_val)
        check("ell_margin", got,
              E.ell_margin_plain(w, route_w, m_len, route_val=route_val))
        if not torch.equal(got, again) or bool(got[BATCH:].any()):
            fail("ell_margin: two launches differ, or the pad is not 0")
        log(f"check ell_margin ({'with' if v is not None else 'no'} val, "
            f"nnz {route_w.shape[0]}): two launches bit-identical")
        check("ell_scatter_apply_fused",
              E.ell_scatter_apply_fused(w, r_ext, src, pos, mask, lr=lr,
                                        val=v),
              E.ell_scatter_apply_fused_plain(w, r_ext, src, pos, mask,
                                              lr=lr, val=v))
    _, cat_p, _ = criteo_rows(BATCH, D_PAIR, seed=3)
    lay_p = E.ell_layout(cat_p[None], D_PAIR).to(dev)
    w_p = torch.from_numpy(rng.normal(size=D_PAIR).astype(np.float32)
                           ).to(dev)
    rows_p = D_PAIR // 128
    val_p = torch.from_numpy(
        rng.normal(size=(rows_p, 128)).astype(np.float32)).to(dev)
    for v in (None, val_p):
        g = E.gather_weights(r_ext, lay_p.src[0])
        upd = (-lr) * (g if v is None else v * g)
        check("ell_scatter_apply",
              E.ell_scatter_apply(w_p, upd, lay_p.pos[0], lay_p.mask[0]),
              E.ell_scatter_apply_plain(w_p, upd, lay_p.pos[0],
                                        lay_p.mask[0]))

    # -- 4. main path ------------------------------------------------------
    dense, cat, y = criteo_rows(ROWS, D_MAIN, seed=0)
    table = Table({"features_dense": dense, "features_indices": cat,
                   "label": y})
    steps = ROWS // BATCH

    def estimator(epochs):
        return (LogisticRegression(device=DEVICE).set_num_features(D_MAIN)
                .set_global_batch_size(BATCH).set_max_iter(epochs)
                .set_tol(0))

    E.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = estimator(EPOCHS).fit(table)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = dict(E.LAUNCHES)
    log(f"main path: fit {fit_s:.3f} s, loss log {model.loss_log}, "
        f"plan {model.planned_impl}, launches {launches}")
    losses = model.loss_log
    if len(losses) != EPOCHS or not all(np.isfinite(losses)):
        fail(f"loss log {losses}")
    if not all(b < a for a, b in zip(losses, losses[1:])):
        fail(f"loss did not fall every epoch: {losses}")
    if model.planned_impl != "ell":
        fail(f"planned {model.planned_impl!r}, expected 'ell'")
    for name in ("ell_margin", "ell_scatter_apply_fused"):
        if launches[name] != steps * EPOCHS:
            fail(f"{name} launched {launches[name]} times on the main "
                 f"path, expected {steps * EPOCHS}")
    if launches["ell_scatter_apply"] != 0:
        fail("the pair kernel ran on a grid of 8192 rows")

    cfg = estimator(1)._sgd_config()
    one_k, _ = S.sgd_fit_mixed(LOSSES["logistic"], dense, cat, y, None,
                               D_MAIN, cfg, device=dev)
    one_p, _ = S.sgd_fit_mixed(LOSSES["logistic"], dense, cat, y, None,
                               D_MAIN, cfg, device=dev, plain=True)
    diff = float(np.max(np.abs(one_k.coefficients - one_p.coefficients)))
    log(f"one epoch, kernels vs plain versions on the card: max |dw| = "
        f"{diff:.3e} (allclose rtol 1e-3, atol 1e-4)")
    if not np.allclose(one_k.coefficients, one_p.coefficients, rtol=1e-3,
                       atol=1e-4):
        fail("the kernels' epoch diverged from the plain versions' epoch")

    t_dense, t_cat, t_y = criteo_rows(4096, D_MAIN, seed=9)
    (out,) = model.transform(Table({"features_dense": t_dense,
                                    "features_indices": t_cat}))
    coef = model.get_model_data()[0]["coefficients"][0]
    icpt = float(model.get_model_data()[0]["intercept"][0])
    margin = t_dense.astype(np.float64) @ coef[:N_DENSE] \
        + coef[t_cat].sum(axis=1) + icpt
    prob = 1.0 / (1.0 + np.exp(-margin))
    perr = float(np.max(np.abs(out["rawPrediction"] - prob)))
    acc = float(np.mean(out["prediction"] == t_y))
    log(f"transform: {len(t_y)} rows, max |p - numpy p| = {perr:.3e}, "
        f"accuracy {acc:.4f}")
    if out["rawPrediction"].shape != (4096,) or not np.all(
            np.isfinite(out["rawPrediction"])) or perr > 1e-5:
        fail("transform disagrees with numpy scoring of the fitted weights")
    if acc < 0.99:
        fail(f"the fit did not learn the label marker (accuracy {acc})")

    # the pair kernel's path: a grid of 1001 rows
    p_dense, p_cat, p_y = criteo_rows(PAIR_ROWS, D_PAIR, seed=4)
    p_table = Table({"features_dense": p_dense, "features_indices": p_cat,
                     "label": p_y})
    p_est = (LogisticRegression(device=DEVICE).set_num_features(D_PAIR)
             .set_global_batch_size(PAIR_BATCH).set_max_iter(2).set_tol(0))
    E.reset_launch_counts()
    p_model = p_est.fit(p_table)
    torch.cuda.synchronize()
    pair_launches = dict(E.LAUNCHES)
    log(f"pair path ({rows_p} table rows): plan {p_model.planned_impl}, "
        f"loss log {p_model.loss_log}, launches {pair_launches}")
    pair_steps = PAIR_ROWS // PAIR_BATCH * 2
    if pair_launches["ell_scatter_apply"] != pair_steps \
            or pair_launches["ell_margin"] != pair_steps \
            or pair_launches["ell_scatter_apply_fused"] != 0:
        fail("the pair kernel did not carry the 1001-row fit")
    p_plain, _ = S.sgd_fit_mixed(LOSSES["logistic"], p_dense, p_cat, p_y,
                                 None, D_PAIR, p_est._sgd_config(),
                                 device=dev, plain=True)
    p_coef = p_model.get_model_data()[0]["coefficients"][0]
    if not np.allclose(p_coef, p_plain.coefficients, rtol=1e-3, atol=1e-4):
        fail("the pair path diverged from the plain versions")

    # -- 5. times ----------------------------------------------------------
    timer = Timer(torch, dev)
    route_w, _ = E.sample_routing(src, pos, mask, BATCH)
    nnz = route_w.shape[0]
    # embedding_bag's bags: (batch, nnz) rows of weight indices, -1 sent
    # to an appended zero row
    bag_idx = torch.where(route_w >= 0, route_w, D_MAIN).t().long() \
        .contiguous()
    w_bag = torch.cat([w, torch.zeros(1, device=dev)])[:, None]
    w_touched = int(torch.unique(route_w[route_w >= 0]).numel())
    lanes, _ = E._slot_lanes(pos, mask)
    kept = src < BATCH
    slot_w = (torch.arange(rows, device=dev)[:, None] * 128 + lanes)[kept]
    slot_src = src[kept].long()
    slot_g = w[slot_w]
    w_scratch = w.clone()
    upd_p = (-lr) * E.gather_weights(r_ext, lay_p.src[0])
    lanes_p, _ = E._slot_lanes(lay_p.pos[0], lay_p.mask[0])
    kept_p = lay_p.src[0] < BATCH
    slot_wp = (torch.arange(rows_p, device=dev)[:, None] * 128
               + lanes_p)[kept_p]
    slot_up = upd_p[kept_p]
    wp_scratch = w_p.clone()

    grid = rows * 128
    ext = r_ext.numel()
    bytes_moved = {
        # the routing and the distinct weights it touches read; the margin
        # table written
        "ell_margin": nnz * BATCH * 4 + w_touched * 4 + m_len * 4,
        # src, pos, mask, w and r_ext read; the new w written
        "ell_scatter_apply_fused": grid * 20 + ext * 4,
        # upd, pos, mask, w read; the new w written (1001 rows)
        "ell_scatter_apply": rows_p * 128 * 20,
    }
    runs = {
        "ell_margin": (
            lambda: E.ell_margin(w, route_w, m_len=m_len),
            lambda: E.ell_margin_plain(w, route_w, m_len),
            lambda: F.embedding_bag(bag_idx, w_bag, mode="sum")),
        "ell_scatter_apply_fused": (
            lambda: E.ell_scatter_apply_fused(w, r_ext, src, pos, mask,
                                              lr=lr),
            lambda: E.ell_scatter_apply_fused_plain(w, r_ext, src, pos,
                                                    mask, lr=lr),
            lambda: w_scratch.index_add_(0, slot_w, r_ext[slot_src],
                                         alpha=-lr)),
        "ell_scatter_apply": (
            lambda: E.ell_scatter_apply(w_p, upd_p, lay_p.pos[0],
                                        lay_p.mask[0]),
            lambda: E.ell_scatter_apply_plain(w_p, upd_p, lay_p.pos[0],
                                              lay_p.mask[0]),
            lambda: wp_scratch.index_add_(0, slot_wp, slot_up)),
    }
    count = {"ell_margin": launches["ell_margin"],
             "ell_scatter_apply_fused": launches["ell_scatter_apply_fused"],
             "ell_scatter_apply": pair_launches["ell_scatter_apply"]}
    bag = F.embedding_bag(bag_idx, w_bag, mode="sum")[:, 0]
    if not torch.allclose(bag, E.ell_margin(w, route_w, m_len=m_len)[:BATCH],
                          rtol=1e-5, atol=1e-4):
        fail("embedding_bag over the routing is not the margin")
    index_add_ms = timer.ms(lambda: torch.zeros(m_len, device=dev)
                            .index_add_(0, slot_src, slot_g))
    slot_u = (-lr) * r_ext[slot_src]
    scatter_only_ms = timer.ms(lambda: w_scratch.index_add_(0, slot_w,
                                                            slot_u))
    log(f"time ell_scatter_apply_fused beside index_add_ alone: "
        f"{scatter_only_ms:.4f} ms (pre-gathered updates: no r_ext gather; "
        f"the fused scatter's library_ms is the r_ext gather plus "
        f"index_add_) [{card}]")
    log(f"time ell_margin beside index_add_: {index_add_ms:.4f} ms (a "
        f"scatter-add of the pre-gathered slot weights into a zeroed "
        f"table: no gather, so not the margin's function; the margin's "
        f"library_ms is embedding_bag's per-sample sum over the routing); "
        f"routing {nnz} x {BATCH}, {w_touched} distinct weights [{card}]")
    kernels = []
    for name, (kern, plain, library) in runs.items():
        ms, plain_ms, lib_ms = (timer.ms(kern), timer.ms(plain),
                                timer.ms(library))
        bound_ms = bytes_moved[name] / HBM_BYTES_PER_S * 1e3
        lib_name = {"ell_margin": "embedding_bag",
                    "ell_scatter_apply_fused": "r_ext gather + index_add_",
                    "ell_scatter_apply": "index_add_"}[name]
        log(f"time {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"{lib_name} {lib_ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"(bytes) [{card}]")
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": count[name],
            "max_abs_err": err[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": lib_ms,
        })

    # steady-state epochs/s over device-resident epoch tensors (the layout
    # build and the host->device copies of fit() excluded)
    perm = np.random.default_rng(0).permutation(ROWS)
    epoch_lay = E.ell_layout(S.prepare_epoch_tensor(cat, perm, steps, BATCH),
                             D_MAIN).to(dev)
    route_s = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        epoch_route, _ = E.sample_routing(epoch_lay.src, epoch_lay.pos,
                                          epoch_lay.mask, BATCH)
        torch.cuda.synchronize()
        route_s.append(time.perf_counter() - t0)
    log(f"sample routing build ({steps} steps, {tuple(epoch_route.shape)}) "
        f"on the card: {route_s[0] * 1e3:.3f} ms first, "
        f"{min(route_s[1:]) * 1e3:.3f} ms again; once per fit, inside "
        f"fit() wall [{card}]")

    def put(a):
        return torch.from_numpy(S.prepare_epoch_tensor(
            a, perm, steps, BATCH)).to(dev)

    epoch_args = (put(dense), epoch_route, epoch_lay.src, epoch_lay.pos,
                  epoch_lay.mask, epoch_lay.ovf_idx, epoch_lay.ovf_src,
                  epoch_lay.heavy_idx, epoch_lay.heavy_cnt,
                  put(y.astype(np.float32)), put(np.ones(ROWS, np.float32)))
    rates = {}
    for label, plain in (("kernels", False), ("plain", True)):
        update = S._mixed_update_ell(LOSSES["logistic"], cfg, plain=plain)
        run_cfg = dataclasses.replace(cfg, max_epochs=EPOCHS)
        init = {"w": torch.zeros(D_MAIN, device=dev),
                "b": torch.zeros((), device=dev)}
        S._run_minibatch_epochs(update, epoch_args, init, steps, run_cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        S._run_minibatch_epochs(update, epoch_args, init, steps, run_cfg)
        torch.cuda.synchronize()
        rates[label] = EPOCHS / (time.perf_counter() - t0)
    log(f"epochs/s at 2^20 features, batch 2^15, {steps} steps/epoch: "
        f"kernels {rates['kernels']:.3f}, plain versions "
        f"{rates['plain']:.3f}; fit() wall {fit_s:.3f} s for {EPOCHS} "
        f"epochs incl. layout build [{card}]")
    # C4's cost at the leg: step 0's two overflow legs as the fit sums
    # them (fixed order) and through index_add_ (atomics), on the same
    # inputs; the epoch against the parent's is
    # scripts/lr_epoch_rate.py --against
    ovf_idx, ovf_src = epoch_lay.ovf_idx[0], epoch_lay.ovf_src[0]
    r_ext = S._extended_r(torch.from_numpy(np.random.default_rng(2).normal(
        size=BATCH).astype(np.float32)).to(dev))
    w0 = torch.zeros(D_MAIN, device=dev)
    m0 = torch.zeros(S._ext_len(BATCH), device=dev)
    c4 = {}
    for leg, (dst, idx, vals) in {"margin": (m0, ovf_src, w0[ovf_idx]),
                                  "update": (w0, ovf_idx, r_ext[ovf_src])
                                  }.items():
        c4[leg] = (timer.ms(lambda: S._overflow_scatter_(
            dst, idx, vals, ovf_src, BATCH)),
            timer.ms(lambda: dst.index_add_(0, idx, vals)))
    log(f"C4 cost at the leg (overflow list of {ovf_idx.numel()}, step 0, "
        f"device ms): " + ", ".join(
            f"{leg} fixed order {f:.4f} vs index_add_ {a:.4f}"
            for leg, (f, a) in c4.items())
        + f"; 2 legs a step [{card}]")

    kernels += kmeans_phases(torch, dev, card, timer)
    kernels.append(widedeep_phases(torch, dev, card, timer))
    kernels += retrieval_phases(torch, dev, card, timer)
    routing_chunk_phase(torch, dev, card)
    # rows 1-3 carry their value variants' numbers beside the implicit-1.0
    # ones
    variants = sparse_phases(torch, dev, card, timer, dense, cat, y, model)
    for entry in kernels[:3]:
        entry["values"] = variants[entry["name"]]
    dense_phase(torch, dev, card)
    criteo_phase(torch, dev, card)
    iteration_phase(torch, dev, card)
    streamed = stream_phase(torch, dev, card, rates["kernels"], fit_s)
    for entry in kernels[:3]:
        entry["stream"] = {"launches": streamed[entry["name"]]}
    km_stream = stream_kmeans_phase(torch, dev, card)
    next(e for e in kernels if e["name"] == "kmeans_update_stats")[
        "stream"] = {"launches": km_stream}
    stream_widedeep_phase(torch, dev, card)
    online_phase(torch, dev, card)

    # phases 25-29: fused pipeline segments and the composition layer;
    # the launches each terminal's transform added land under "chain"
    pipeline_phase(torch, dev, card)
    km_run = kmeans_terminal_phase(torch, dev, card)
    ivf_launches = ivf_terminal_phase(torch, dev, card)
    widedeep_terminal_phase(torch, dev, card)
    cv_launches = composition_phase(torch, dev, card, km_run)
    chained = {"kmeans_assign_reduce": km_run[3], **ivf_launches,
               "ell_margin": cv_launches["ell_margin"],
               "ell_scatter_apply_fused":
                   cv_launches["ell_scatter_apply_fused"]}
    for entry in kernels:
        if entry["name"] in chained:
            entry["chain"] = {"launches": chained[entry["name"]]}

    # phases 30-33: serving; the launches the served batches took land
    # under "serve"
    lr_model, lr_pool = serving_lr_phase(torch, dev, card, model)
    served = serving_kernel_phase(torch, dev, card)
    multitenant_phase(torch, dev, card)
    int8_phase(torch, dev, card, lr_model, lr_pool)
    for entry in kernels:
        if entry["name"] in served:
            entry["serve"] = {"launches": served[entry["name"]]}

    # phases 34-36: train while serving, publishes, failover; the launches
    # of each land under "online"
    online = {34: train_while_serve_phase(torch, dev, card, model),
              35: publish_kernel_phase(torch, dev, card),
              36: failover_phase(torch, dev, card)}
    for entry in kernels:
        by_phase = {f"phase_{k}": v[entry["name"]]
                    for k, v in online.items() if entry["name"] in v}
        if by_phase:
            entry["online"] = {"launches": sum(by_phase.values()),
                               **by_phase}

    # phases 37-39: the boosted trees and the instance classifiers (no
    # kernel of the table: GBT's histograms are fixed-order PyTorch ops)
    X_gb, y_gb, cfg_gb, forest_gb, losses_gb = gbt_phase(torch, dev, card,
                                                         timer)
    gbt_stream_phase(torch, dev, card, X_gb, y_gb, cfg_gb, forest_gb,
                     losses_gb)
    classifiers_phase(torch, dev, card)

    # phases 40-41: the recommenders (no kernel of the table: their
    # products are cuBLAS GEMMs, cholesky_ex and PyTorch ops)
    als_phase(torch, dev, card, timer)
    recommenders_phase(torch, dev, card, timer)

    # phases 42-43: the text and selection stages; the hashed Criteo fit's
    # launches land under "hashed"
    text_phase(torch, dev, card)
    hashed = hashed_criteo_phase(torch, dev, card, dense, cat, y)
    for entry in kernels:
        if entry["name"] in hashed:
            entry["hashed"] = {"launches": hashed[entry["name"]]}

    # phases 44-46: the bf16 stats kernel, k-means++ with agglomerative,
    # the data-parallel fit; the bf16 variant's line sits beside the f32
    # stats kernel's, its launches those of phase 46's fits, and both
    # carry phase 46's launches by group under "parallel"
    bf16_entry, km_host, km_pts = bf16_phase(torch, dev, card, timer)
    bf16_entry["wide_shapes"] = bf16_wide_phase(torch, dev, card, timer)
    kpp_phase(torch, dev, card, km_host, km_pts)
    par = parallel_phase(torch, dev, card, km_host, km_pts)
    bf16_entry["launches"] = sum(par["bfloat16"].values())
    bf16_entry["parallel"] = {"launches": par["bfloat16"]}
    b4 = next(i for i, e in enumerate(kernels)
              if e["name"] == "kmeans_update_stats")
    kernels[b4]["parallel"] = {"launches": par["float32"]}
    kernels.insert(b4 + 1, bf16_entry)

    # phase 47: the compressed data-parallel gradient reduction (no
    # kernel of the table on its path)
    grad_reduce_phase(torch, dev, card)

    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

"""Drive the PyTorch port's training and serving paths on one NVIDIA GPU and check them.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py [--out results.json]

Phases (each prints one line; any failure exits non-zero):
 1. device and build: the card, its power limit, every kernel source of
    lightgbm_tpu_torch/csrc built with one nvcc each, all started at once,
    and each kernel's registers per thread and spill bytes as ptxas reports
    them (hist_v1's instances on their own, none spilling; histogram.cu's
    32, its grouped form and its int16 instantiations among them);
 2. leaf-histogram kernel vs its plain PyTorch version at the root shape
    (1M rows x 28 features, B=255) and at a leaf segment given by ``rows``:
    exact on dyadic values, within the f32 bound of two summation orders on
    real gradients; times against the bound and one ``index_add_``; then,
    on a line of its own, the kernel at the sizes of one tree's calls
    (sorted random segments of 256, 1024, 4096, 16384 and 100k rows, and
    the root) in f32 and bf16: exact on dyadic values, hist_v1 equal to it;
    hist_v1 on real values equal bit for bit to its host mirror
    (``hist_kernel.hist_v1_mirror``) up to 100k rows and to itself over 5
    calls at the root; each time beside its bytes bound and hist_v1's time
    on the same rows;
 3. two-child split-scan kernel vs its plain version on both children of
    phase 2's histograms, with missing types none/zero/nan and a monotone
    feature: every field exact (NaN where both are NaN) on dyadic and on
    real-valued histograms, also read by leaf index out of a grower-like
    buffer, and on 300 features of synthetic dyadic histograms;
 4. the main path: ``lightgbm_tpu_torch.train`` on make_higgs_like(1M, 28),
    binary, max_bin=255, num_leaves=255, learning_rate=0.1, 10 iterations
    through the device-resident split loop (the first eager, each later one
    a replay of the captured iteration), with the kernels' launch
    counters set to 0 just before and read just after (a replay adds the
    launches its capture recorded); iterations per
    second and the training AUC; then one more iteration under
    torch.profiler for the device busy time by kernel, the top 8, every
    kernel of the split scan, of an indexing copy or of the split loop, and
    the count of host-to-device and device-to-host copies (at most 4 each);
 4b. the two split loops paired in one process (the device loop's eager
    launches, not the captured iteration of 4c): on dyadic gradients
    (multiples of 2^-10) the host loop and the device loop, in turns host,
    device, device, host, grow the same tree bit for bit; the device loop
    runs from the root to the readback under sync debug mode "error"; on
    the real gradients of phase 4's model, tree times in turns (the device
    loop's enqueue time a split, the host loop's time a split), and a
    stopped loop's host cost a step; two boosters, one a loop, train in
    turns of 10 iterations (device, host, host, device), and the host
    loop's AUC at 10 iterations is within 2e-3 of phase 4's; the launch
    counts of the dyadic turns (the device loop's tree API, grow_tree_device,
    whose leaf_ids kernel only a renewing objective's iteration runs) count as a
    main-path run; at the main path's first step the root's split scan and
    each kernel of the step (pick_partition, the histogram's segment entry,
    the split scan's folded entry, which does the histogram subtraction)
    against its plain version on a copy of the state (the whole state
    equal, the real-valued histogram within the two-order bound), then
    timed from the same state against its bound, with one torch.sub of the
    subtraction's rows beside the folded scan; pick_partition and the
    folded scan also at step 128 of the 255-leaf tree, and pick_partition
    at a pick of a leaf of about 1k rows in that state;
 4c. device-resident boosting: on the dyadic gradients of 4b at 1M rows
    one replay of the captured tree (ops/cuda_graph.py) grows the eager
    launch_tree's tree and leaf index bit for bit; on that 255-leaf layout
    the leaf_ids kernel and the fused score update (score_update, which the
    boosting iteration runs in place of leaf_ids, a gather and an add)
    against their plain versions (the scores bit for bit on real values)
    and timed against their bytes bound; three boosters of the main path,
    the eager launches, a captured iteration a replay (device_chunk_size 1)
    and chunks of 10 replays with one readback, warmed up to 10 iterations
    (the chunked one's AUC within 2e-3 of the eager one's), a whole
    train_chunk(10) under sync debug mode "error", then turns of 10
    iterations (eager, graph, chunk, chunk, graph, eager) with the launch
    counts from 0 each (replays counted; equal across the three and to the
    captured tree's but for score_update in place of leaf_ids), after each
    chunk its train scores equal to the kept trees' raw prediction, one
    profiled iteration of each (device busy ms, kernels an iteration, at
    most 817 and none of them a subtract_kernel, the split-loop kernels'
    ms, idle share, no host-to-device copy and one device-to-host copy an
    iteration or a chunk; ``turns_and_profile``, which 4e and 4f share),
    the host's time to queue an iteration; then a
    stop in the middle of a chunk: at 100k rows with gradients rounded to
    multiples of 2^-7 (training exact whatever the summation order), a
    min_gain_to_split found by bisection stops chunk 1 inside the chunk, two
    chunk-1 runs stop alike, and chunk 10 keeps the same model text and
    train scores bit for bit;
 4d. validation, early stopping and sampling: ``train`` on the main path's
    dataset with a validation set of 500k rows of its distribution from
    another seed (``higgs_like_rows``), bagging_fraction 0.8 every
    iteration, feature_fraction 0.8, AUC and log-loss at every boundary and
    5 rounds of patience, 40 rounds, launch counts from 0 (predict_bins
    among them); every tree's predict_bins leaves equal to the plain
    traversal and the validation score equal to the plain per-tree f32 adds
    bit for bit; the bag equal to its CPU draw and the feature masks to
    numpy's; validation AUC above 0.7; an eval boundary's host time; on
    dyadic gradients at 100k rows chunk 4 equal to chunk 1 (trees, train and
    validation scores); turns of 10 iterations of the plain main path's
    graph booster and of this configuration's (a replay an iteration,
    chunks of 5), one profiled iteration and chunk (busy time, idle share,
    copies each way), a chunk's synchronizing calls under sync debug mode
    "warn", the bag draw's time (the JAX package's threefry permutation,
    equal to the same torch code on the CPU for every iteration the run
    drew), and predict_bins timed against its plain version and its bytes
    bound, and its device ms an iteration in the profile;
 4e. regression on a YearPredictionMSD-shaped table (``year_like_rows``:
    463,715 x 90 dense f32, synthetic values, label about 1998 +- 10):
    ``regression``, metric l2, 255 leaves, max_bin 255, 10 iterations with a
    held-out 51,630-row set; the held-out l2 below half the constant mean's;
    the captured iteration equal to the eager launches on 20,000 rows with
    the gradients rounded to 2^-10 (every histogram cell exact, checked);
    two eager iterations on the whole table with every histogram call held
    to its plain version within the two-order bound, every score update to
    ``score.add_(value[leaf_ids])`` bit for bit, and pick_partition and the
    folded scan at every 16th step of each tree to their plain versions on
    a copy of the state; iterations/s in 4c's turns (a replay an iteration,
    chunks of 10, eager), busy ms a replay and a chunk, kernels an
    iteration, copies;
 4f. multiclass on a Covertype-shaped table (``covertype_like_rows``:
    581,012 x 54, 10 continuous and 44 binary columns, 7 classes with
    Covertype's shares, synthetic values, EFB off): ``multiclass``, 7 trees
    an iteration in one captured replay, 255 leaves, max_bin 255, a
    100k-row validation set with multi_logloss and multi_error, early
    stopping 5, 10 iterations; multi_error below the majority share and
    multi_logloss below the prior's entropy; each class's validation score
    equal to the plain per-tree adds; on 16,000 rows with gradients rounded
    to 2^-10 the captured K-tree iteration equal to the eager launches and
    chunk 4 equal to single iterations; 4e's held eager run, one iteration
    of 7 trees on the whole table, the histograms in their grouped form
    (the table's 2-bin features) and each class's score update into its
    own row of the scores; the turns (of 5 iterations) and profile of 4e;
 4g. categorical features on Covertype in its published form
    (``covertype_compact_rows``: 4f's rows, 581,012 x 12, Wilderness_Area
    with 4 values and Soil_Type with 40 as two categorical columns): 4f's
    configuration in chunks of 10; Wilderness takes the one-hot branch and
    Soil the CTR one (from their num_bin); the first iteration's trees
    split them, a CTR node with more than one category among them;
    multi_error below the majority share; each class's validation score
    (predict_bins' categorical nodes) equal to the plain per-tree adds; the
    held-out multi_logloss of the same run with the two columns read as
    numerical, recorded; on 16,000 rows with gradients rounded to 2^-10 the
    captured iteration equal to the eager launches, chunks of 4 and the
    host loop (model text and scores); one eager iteration on the whole
    table with every split scan held (the root's and every folded one,
    membership words included), pick_partition every 16th step, among them
    picks of categorical splits; the categorical instantiations of the
    folded scan (step 16), pick_partition (the first categorical pick) and
    predict_bins (the held-out set) against their plain versions and
    timed against their bounds; the scan's entry timed on one pair of
    this table's histograms with its categorical blocks, with the same
    features as numerical blocks of the categorical instantiation, and in
    the numerical instantiation; the turns (of 5 iterations) and profile
    of 4e;
 4h. sparse input, EFB-bundled: 4f's rows as a scipy CSR matrix with 4f's
    parameters but the default enable_bundle and max_conflict_rate (the 10
    continuous columns alone, Wilderness in a group of 5 bins, Soil in one
    of 41: G = 12), a 100k-row held-out CSR set, early stopping 5, 10
    iterations; multi_error below the majority share and the held-out
    multi_logloss within 1% of 4f's; each class's validation score (the
    bundled predict_bins) equal to the plain per-tree adds; on 16,000 rows
    with gradients rounded to 2^-10 the replays, the eager launches, chunks
    of 4 and the host loop give one model text, and their trees equal the
    dense array's (no bundles) node for node; one eager iteration on the
    whole table with every remap held to its plain version bit for bit (and
    every root's and 16th step's to the histogram of the decoded rows), every
    pick_partition (the bundled instantiation) and histogram call held, the
    folded scan every 16th step; the bundled pick, the remap and the bundled
    predict_bins at step 16 and over the held-out set against their plain
    versions and timed against their bounds (the remap beside one
    index_select of the group rows); the turns (of 5 iterations) and
    profile of 4e;
 4i. a wide one-hot table shaped like the Flight Delay set
    (``bench.flight_like_rows``: 1,000,000 x 674 CSR, one-hot Month,
    DayofMonth, DayOfWeek, UniqueCarrier, 300 Origins and 300 Dests, then
    DepTime and Distance; about 10 groups), binary, 255 leaves, max_bin 255,
    10 iterations with a 100k-row held-out set; held-out AUC above 0.7,
    the validation score equal to the plain adds, 4h's held iteration and
    kernel timings at this shape, the turns and profile of 4e;
 4j. the boosting modes on the main path's table with 4d's held-out set and
    AUC at every boundary, one replay an iteration: GOSS (top_rate 0.2,
    other_rate 0.1, 20 iterations, the last 10 past its warm-up), DART (its
    defaults, 20 iterations) and random forest (bagging 0.8 every
    iteration, feature_fraction 0.8, 10 iterations); each trains through
    the split loop's kernels and predict_bins, its held-out AUC above 0.7
    and its train scores equal to its trees' raw prediction (DART's
    rescaled, random forest's averaged); GOSS's bag, amplification and
    permutation after one more sampled replay (run under sync debug mode
    "warn", its synchronizing calls recorded) equal to the same selection
    on the CPU from the same gradients, exactly top_k + other_k rows in the
    bag, the selection and the permutation draw timed; every tree a DART
    drop took out predicted by predict_bins over the 1M training rows equal
    to the plain version, predict_bins' calls an iteration (one validation
    add and three a dropped tree) and its time over the training rows;
    random forest's text with ``average_output`` and its prediction the
    average of its trees; on 100k rows with 4c's gradients rounded to 2^-7
    the replays equal to the eager launches (model text, train and
    validation scores); turns of 10 iterations (graph, eager, eager,
    graph) with launch counts equal between the two, and one profiled
    replay and eager iteration of each mode (busy ms, kernels an
    iteration, copies, idle share);
 4k. ranking on a LETOR-shaped table (``bench.letor_like_rows``: 2,000,000
    x 136 dense f32, about 16,300 queries of 1 to 1,251 rows, mean near 120,
    MSLR-WEB30K's label shares): ``lambdarank``, 255 leaves, max_bin 255,
    10 iterations with a 200,000-row held-out set from another seed and
    ndcg@1, 3, 5 and 10 at every boundary; held-out ndcg@10 above a
    constant score's; csrc/lambdarank.cu against its plain version
    (ops/rank.py) within rtol 2e-4 / atol 2e-6 at iteration 1's scores
    (all equal) and iteration 10's, a relaunch bit for bit, timed against
    its bound (bytes, or 23 operations for each unordered pair of unequal
    labels: the pair's formula and the four sums it enters); the replays equal to the eager launches on the first queries
    up to 100k rows with the lambdas rounded to 2^-7; the turns and profile
    of 4e with the kernel's device ms and share of busy time; an eval
    boundary's host ms;
 4l. leaf renewal on 4e's table and held-out set: ``regression_l1``,
    ``quantile`` at alpha 0.9 with bagging 0.8 every iteration, and
    ``mape``, 10 iterations each through ``train``'s chunks of 10; the
    held-out l1 below the constant median's, the quantile's held-out
    coverage within 0.05 of 0.9; one more eager iteration with the
    renewal's inputs recorded: the card's renewed leaf values equal to the
    plain renewal on the CPU from the rows' leaves (``leaf_ids``) bit for
    bit for L1 and quantile, and for MAPE (a weighted renewal, its
    cumulative weights an f32 cumsum in another order) each value an order
    statistic within 2^-10 of the leaf's weight of the CPU's pick
    (``renewal_bracket``); the renewal's ms a tree (an eager call, and a
    replay of the call captured alone); turns of 10 iterations
    (graph, chunk, chunk, graph) and a profiled replay and chunk;
 4m. the training API on the main path's table with 4d's held-out set: a
    numpy binary log-loss objective (``fobj``) through ``train``, 10
    iterations, its held-out AUC within 2e-3 of the built-in objective's at
    the same start (no boost from average), it/s in turns with the built-in
    one (fobj, built-in, built-in, fobj), the host's ms an iteration (score
    readback, objective, upload), kernels and copies of a profiled replay,
    one capture; the objective rounded to 2^-7 at 100k rows: the replays,
    the eager launches and the CPU's plain loop equal in trees and scores;
    ``init_model``: 5 + 5 iterations (bagging 0.8, feature_fraction 0.8)
    through a saved file, the warm start's init scores equal to the
    parent's live score carry bit for bit, its held-out AUC within 2e-3 of
    the 10-iteration run's, and at 100k rows with the rounded objective the
    model text equal to the one-shot run's; ``cv`` with 5 folds, 10
    iterations, AUC (auc-mean above 0.7, one capture a fold, its seconds);
    the mode x objective pairs GOSS x quantile, DART x regression_l1 (from
    the training median as init score) and random forest x mape on 4e's
    table and GOSS x lambdarank on 500,000 LETOR-shaped rows, 10 iterations
    each with 4l's or 4k's quality guard, it/s, busy ms, and the replays
    equal to the eager launches on 100k rows with the gradients rounded;
 5. the same configuration at 100k rows for 3 iterations on device="cuda"
    (the eager launches) and device="cpu" (the plain versions), every
    histogram call of the CUDA run (the root's and each segment entry's) held to its plain version
    within the two-order bound: trees equal
    up to an f32 near-tie flip; each side's split gains against the f64
    gains of its own splits, the kernel's largest error no larger than the
    plain version's; at a flip, the CUDA run's split no worse in f64 than
    the plain version's (rtol 1e-5); raw scores of all 3 trees within rtol
    1e-4 / atol 1e-4; and each side's root histogram against an f64 sum;
 6. the histogram kernel family on synthetic 1M x 28 bins at B = 15, 63 and
    255 with f32 and bf16 operands: every kernel the caps allow (histogram,
    hist_onehot, hist_bitplane, hist_packed4 at B=15, and the oracle
    hist_v1), at the root and at a 100k-row segment, against its plain
    version (exact on dyadic values, within the two-order bound on real
    ones) and hist_v1 against histogram, and on real values against its
    mirror at the segment and itself at the root; hist_packed4 reads the nibble-packed
    copy the grower makes at set-up, by row at the segment, and is also
    timed at the root on pack4's input; times against the bytes bound and
    one ``index_add_``, and hist_onehot's root times at every width on a
    line of their own;
 7. the tune sweep: ``python -m lightgbm_tpu_torch.obs.tune`` in process at
    1M rows, at the widths the datasets at max_bin 15/63/255 emit, f32 and
    bf16, into a temporary table; every winner is a hand-written kernel;
 8. routed training, 10 iterations at 1M x 28 each: under the sweep's table
    at (max_bin 15, f32), (63, bf16) and (255, bf16), and under a hand-built
    table that sends alternate row classes to cuda_onehot / cuda_bitplane
    (and cuda_packed4) at (63, f32) and (15, f32); every routable kernel
    launches; each run records its split loop (the device loop where the
    table sends every row class to cuda, the host loop otherwise); each run
    is timed, then trained again (the device loop's eager launches) with
    every call of each routed kernel held to its plain version on the same rows within
    the two-order bound; AUC > 0.7 in both, and the
    f32 runs grow the default route's trees up to a flip whose gain gap
    lies within the f32 error bound of the sums behind the flipped node;
 8b. serving: the main path's model at full width, 500 iterations of 255
    leaves (T = 500, M = 254), and 4g's categorical K = 7 model, packed on
    the card (``Booster.to_packed``); the three kernels of
    csrc/packed_predict.cu (``packed_bin_rows``, ``packed_predict_leaves``,
    ``packed_predict_values``) against their plain versions at 1, 16, 4,096
    and 10,000 rows, codes, leaves and values bit for bit; the exact path
    against ``Booster.predict`` bit for bit (raw, converted, ``pred_leaf``)
    on 100k held-out rows with 2% NaN (10k for the categorical model); then
    ``python -m lightgbm_tpu_torch.serve``'s ``main`` in this process on
    127.0.0.1 with ``--device cuda --warmup-rows 4096`` and
    LIGHTGBM_TPU_RETRACE=fail: 8 clients send 200 requests each of 1 to
    4,096 rows (log-uniform), alternating the exact path (every answer equal
    to ``Booster.predict`` bit for bit) and the fused path with raw scores
    (every answer within 2·T·2^-24·Σ|v| of the f64 sum of its f32 codes'
    leaves), one hot swap to the same trees cut to 100 iterations under
    that load (answers of both versions held to their own references),
    zero retraces after warmup; rows/s of that load and of an exact-only
    and a fused-only one, p50/p99 latency of 1-row and 1,000-row requests
    on both paths, then SIGTERM and the server's drain; each kernel timed
    at 16 and 4,096 rows against its bytes bound, its plain version and,
    for the bin kernel, one batched ``torch.searchsorted``; printed with the
    card's name and power limit;
 8c. prediction, on 8b's model and 4g's: ``Booster.predict(pred_contrib=True)``
    of 10,000 held-out rows with 2% NaN through all 500 trees on the TreeSHAP
    kernel (csrc/tree_shap.cu, ``tree_shap``), every row's contributions
    summing to ``predict_raw`` within (T (depth + 2)^2 + F + 1) 2^-53 of
    their absolute sums, the kernel's ms at that size against its f64
    operations bound (``shap_operations``, over 34 TFLOP/s); the kernel
    against its plain version bit for bit at the same 10,000 rows on the
    first 20 trees (the plain version's ms there; each block loops over
    several (128 rows, tree) tiles, re-staging a tree each, as in the
    500-tree call), on 4g's K = 7 categorical model's first 2 iterations
    and on a chain of 80 levels written as model text
    (``chain_model_text``); ``pred_early_stop`` on 100,000 rows (every 10
    iterations, margin 4): each row's value equal bit for bit to its stops
    replayed from its leaves, the rows never stopped to ``predict``, the
    rows stopped and both times; ``Booster.refit`` on 100,000 rows, its
    seconds and held-out AUC before and after; ``save_binary`` of the 1M x
    28 training Dataset reloaded with the same bins and mappers, 100,000 rows
    through a CSV file binned as in memory, and 10 iterations on the
    reloaded file within 2e-3 of phase 4's AUC;
 8d. wide bins and the histogram pool: ``train`` on the main path's table
    binned at max_bin 1024 (int16 bins on the card), 255 leaves, 10
    iterations with a 100k-row held-out set, captured, and the same with
    ``histogram_pool_size`` 16 MB (48 slots of 28 x 1024 x 3 x 4 bytes):
    AUC above 0.7, every histogram, scan, pick and predict launch an int16
    (the scan's: rows1024) or pool instantiation, no launch of a byte one
    (launches counted from 0); csrc/histogram.cu's
    int16 instantiations at the root and at phase 2's 100k-row segment on
    the card's int16 copy at B = 300 and B = 1024, f32 and bf16, exact on
    dyadic values and within the two-order bound on real ones, timed
    against the bytes bound and one ``index_add_``; csrc/split_pair.cu's
    rows1024 instantiations (numerical and categorical) at B = 1024 against the
    plain version bit for bit; one eager tree of each run on dyadic
    gradients with every kernel of every 16th step (pick_partition, the
    segment histogram, the pool's second segment histogram, the folded
    scan) and the root's scan held to their plain versions (the whole
    state equal), timed at steps 0 and 128; the pooled run's steps that
    built both children, counted on its real gradients; a 200k-row table
    with a categorical column of 1000 categories (5 iterations, a held-out
    set): a split whose categories pass bin 255, its tree held every 16th
    step, the first categorical pick and predict_bins over the held-out
    rows with words past 8 held and timed (predict_bins bounded by the mean
    depth of the rows' leaves in its tree); pooled = unpooled at 100k rows
    on gradients rounded to 2^-7 (model text and scores); turns of 10
    iterations of the main path (255 bins), wide and pooled boosters (a
    replay an iteration and chunks of 10) and one profiled iteration of
    each (busy ms, kernels, each kernel's ms an iteration, idle share);
 8e. forced splits and CEGB on the main path's table
    (1M x 28, 255 bins, 255 leaves, 10 iterations in one chunk of 10,
    captured): a three-level forced JSON on features 0-6 whose 7 nodes open
    every tree; the three CEGB penalties together (AUC above 0.7, fewer
    distinct features than phase 4's model); at 100k rows on gradients
    rounded to 2^-7 the captured replays and chunks of 4 equal the eager
    launches (a forced JSON with an invalid split, which aborts the
    preamble, and the three penalties; model text, scores and the paid
    features and rows); on one eager tree at 1M rows (dyadic values,
    the forced JSON, the three penalties) the forced record, the kExt pick,
    the lazy pass, the penalised root and folded scans and the all-leaves
    scan at a first coupled payment held to their plain versions (the whole
    state and the paid features and rows equal) and timed against their
    bounds; turns of 10 iterations of the main path and the CEGB booster
    (chunks of 10) and one profiled chunk of each (busy ms, kernels an
    iteration);
 8f. EFB groups past 256 bins, the pool with EFB and CEGB with the pool,
    each trained through the captured loop at full width: 4h's sparse
    Covertype rows at max_bin 1024 (K = 7, 5 iterations, a 100k-row
    held-out set; a group wider than 256 bins, int16 groups on the card),
    4i's Flight-shaped Dataset with ``histogram_pool_size`` 64 MB (the
    slots printed, fewer than the 255 leaves; 5 iterations) and 8e's CEGB
    configuration with a 4 MB pool (48 slots; 10 iterations in a chunk):
    each new instantiation launched; at 100k rows on gradients rounded to
    2^-7 the replays equal the eager launches (binary Covertype rows at
    max_bin 1024, Flight-shaped rows pooled, CEGB pooled); one eager tree
    of each on dyadic values with every new instantiation (the int16
    bundled pick, the wide remap, the pooled bundled pick, the larger
    child's remap, the pooled penalised all-leaves scan, with the pooled
    fold before it) held to its plain version at every step (the whole
    state equal) and timed
    against its bound (the pooled all-leaves scan at three steps: an
    ordinary one, which scans the children alone; the payment with the
    most resident leaves, the kernels line's time; and the step with the
    most resident leaves, with a payment set by hand), the int16 bundled
    predict_bins over the held-out rows through the Covertype tree;
 9. one JSON line of every kernel's numbers (launches summed over the
    main-path runs: phase 4, 4c's and 4d's turns and 4d's training, 4e's,
    4f's, 4g's, 4h's, 4i's, 4j's, 4k's, 4l's and 4m's trainings and turns, the
    sweep and the routed trainings, 8b's server under load (the
    serving kernels', timed in 8b at 4,096 rows) and 8c's ``pred_contrib``
    (tree_shap, timed in 8c),
    each with the counts set to 0 just before it and read just
    after; the split loop's kernels timed in phase 4b, leaf_ids and
    score_update in 4c, predict_bins in 4d; the categorical instantiations of
    the folded scan, pick_partition and predict_bins in rows of their own,
    timed in 4g, their launches 4g's training's; efb_remap and the bundled
    instantiations of pick_partition and predict_bins timed in 4i, the
    bundled ones' launches 4h's and 4i's trainings'; lambdarank timed in 4k;
    the int16 and pool instantiations timed in 8d, their launches 8d's
    trainings'; forced_record, pick_partition_ext, the penalised scans,
    split_pair_all and cegb_lazy timed in 8e, their launches 8e's
    trainings'; the int16 bundled, pooled bundled and pooled CEGB
    instantiations timed in 8f, their launches 8f's trainings'), the seconds
    of each phase, then the result line.

Exits non-zero without a result when CUDA is not available or the package
is missing. Imports no JAX and nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_FLOP_PER_S = 67e12  # H100 SXM, f32 outside the tensor cores
ROOT_ROWS = 1_000_000
FEATURES = 28
TRAIN_PARAMS = {
    "objective": "binary", "metric": "auc", "max_bin": 255, "num_leaves": 255,
    "learning_rate": 0.1, "verbose": -1,
}
VALID_ROWS = 500_000  # the size of HIGGS's published test split
VALID_ROUNDS = 40
VALID_PARAMS = {"metric": ["auc", "binary_logloss"], "bagging_fraction": 0.8, "bagging_freq": 1,
                "feature_fraction": 0.8}


def bound(bytes_moved, flops):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def higgs_like_rows(n, f, seed, model_rows=ROOT_ROWS, model_seed=7):
    """``n`` rows of the distribution of helpers/bench_data.py's
    ``make_higgs_like(model_rows, f, model_seed)`` (its derived-feature pairs
    and label weights, replayed from its generator) drawn from ``seed``: a
    validation set for the main path's training set."""
    import numpy as np

    rng = np.random.RandomState(model_seed)
    low = min(21, f)
    rng.standard_normal(model_rows * low)
    pairs = []
    for _ in range(low, f):
        pairs.append(rng.randint(0, low, 2))
        rng.standard_normal(model_rows)
    w = rng.randn(f) * (rng.rand(f) > 0.3)
    rng = np.random.RandomState(seed)
    X = np.empty((n, f), np.float32)
    X[:, :low] = rng.randn(n, low).astype(np.float32)
    for j, (a, b) in zip(range(low, f), pairs):
        X[:, j] = np.abs(X[:, a] * X[:, b] + rng.randn(n).astype(np.float32) * 0.5)
    logits = X @ w * 0.3 + rng.randn(n) * 2.0
    return X, (logits > 0).astype(np.float32)


def err_over_bound(got, want, abs_sum):
    """(largest cell of |got - want| over the f32 worst-case bound of two
    summation orders, count * 2^-23 * (sum of |values|); largest error).
    A histogram passes at a ratio of at most 1."""
    err = (got - want).abs()
    return float((err / (want[..., 2:] * 2.0 ** -23 * abs_sum + 1e-6)).max()), float(err.max())


def renewal_bracket(got, residual, leaf_id, weights, num_leaves, alpha, slack):
    """Hold a weighted renewal (WeightedPercentileFun of each leaf's
    residuals) whose cumulative weights were summed in another order: each
    leaf's value in ``got`` must be the residual at an index i of the leaf's
    (value, row) order with c[i - 1] <= t + d and c[i] > t - d, where c is
    the f64 cumulative weight, t = ``alpha`` times the leaf's total and d =
    ``slack`` times it (the pick of the reference is the first c[i] > t).
    Returns how many leaves took another index than that first one."""
    import numpy as np

    apart = 0
    for leaf in range(num_leaves):
        rows = np.nonzero(leaf_id == leaf)[0]
        if len(rows) <= 1:
            continue
        order = np.argsort(residual[rows], kind="stable")
        r = residual[rows][order]
        c = np.cumsum(weights[rows][order].astype(np.float64))
        t, d = alpha * c[-1], slack * c[-1]
        lo = min(int(np.searchsorted(c, t - d, side="right")), len(r) - 1)
        hi = min(int(np.searchsorted(c, t + d, side="right")), len(r) - 1)
        assert got[leaf] in r[lo:hi + 1], ("weighted renewal out of its bracket", leaf, got[leaf],
                                           r[lo], r[hi])
        apart += got[leaf] != r[min(int(np.searchsorted(c, t, side="right")), len(r) - 1)]
    return int(apart)


SERVE_ROUNDS = 500  # T = 500 trees of 255 leaves (M = 254) at full width
SERVE_HELD_ROWS = 100_000
SERVE_SWAP_ROUNDS = 100  # the hot-swapped model: the same trees cut to 100 iterations
SERVE_CLIENTS = 8
SERVE_REQUESTS = 200
SERVE_MAX_ROWS = 4096
SERVE_SIZES = (1, 16, 4096, 10000)


def chain_model_text(depth, num_features, seed=0):
    """LightGBM model text of one regression tree that is a chain of ``depth``
    levels: node i splits on a feature drawn from ``seed`` (so features
    repeat down the chain), with every missing type and default side, its
    left child a leaf and its right child node i + 1. Leaf counts of 1 to 3
    and internal counts their sums."""
    import numpy as np

    rng = np.random.RandomState(seed)
    feat = rng.randint(0, num_features, depth)
    thr = np.round(rng.randn(depth), 3)
    dtype = (rng.randint(0, 3, depth) << 2) | (rng.randint(0, 2, depth) << 1)
    leaf_value = rng.randn(depth + 1)
    leaf_count = 1 + np.arange(depth + 1) % 3
    internal_count = np.cumsum(leaf_count[::-1])[::-1][:depth]
    left = ["%d" % ~i for i in range(depth)]
    right = ["%d" % (i + 1) for i in range(depth - 1)] + ["%d" % ~depth]

    def join(vals, fmt):
        return " ".join(fmt % v for v in vals)

    tree = "\n".join([
        "num_leaves=%d" % (depth + 1), "num_cat=0", "split_feature=" + join(feat, "%d"),
        "split_gain=" + join(np.ones(depth), "%g"), "threshold=" + join(thr, "%.17g"),
        "decision_type=" + join(dtype, "%d"), "left_child=" + " ".join(left),
        "right_child=" + " ".join(right), "leaf_value=" + join(leaf_value, "%.17g"),
        "leaf_count=" + join(leaf_count, "%d"), "internal_value=" + join(np.zeros(depth), "%g"),
        "internal_count=" + join(internal_count, "%d"), "shrinkage=1",
    ])
    names = " ".join("Column_%d" % j for j in range(num_features))
    return "\n".join([
        "tree", "version=v2", "num_class=1", "num_tree_per_iteration=1", "label_index=0",
        "max_feature_idx=%d" % (num_features - 1), "objective=regression",
        "feature_names=" + names, "", "Tree=0", tree, "", "", "end of trees", "",
    ])


def packed_bounds(N, F, T, M, L, K, bmax, cat_words):
    """bound_ms of the three serving kernels at N rows: each input read once,
    each output written once, over the card's memory rate (their f32 work,
    one add a tree a row in packed_predict_values, is far below the f32
    rate). Returns {kernel: (ms, "bytes")}."""
    nodes = T * M * (6 * 4 + 3 * 1)  # six int32 and three bool fields a node
    per_feature = 3 * 4 * F  # rank0, zero_lo, zero_hi
    rows = N * F * (4 + 1)  # codes and NaN flags
    return {
        "packed_bin_rows": bound(N * F * 4 + F * bmax * 4 + F + N * F * (4 + 1), 0),
        "packed_predict_leaves": bound(rows + nodes + T * 4 + cat_words * 4 + per_feature
                                       + T * N * 4, 0),
        "packed_predict_values": bound(rows + nodes + T * 4 + cat_words * 4 + per_feature
                                       + T * L * 4 + K * N * 4, N * T),
    }


def serving_phase(lgb, dev, counted, time_ms, train_set, cat_booster, cat_rows, workdir):
    """The serving path on the card (phase 8b of the module docstring).
    Returns (the phase's record, each kernel's row of the kernels line, the
    500-iteration model)."""
    import http.client
    import signal
    import socket
    import threading

    import numpy as np
    import torch

    from lightgbm_tpu_torch.obs import retrace
    from lightgbm_tpu_torch.ops import packed_kernel
    from lightgbm_tpu_torch.ops import predict as predict_plain
    from lightgbm_tpu_torch.serve import __main__ as serve_main

    rec = {}
    t_part = [time.perf_counter()]
    part_s = {}

    def part_done(name):
        now = time.perf_counter()
        part_s[name] = now - t_part[0]
        t_part[0] = now

    # the main path's model at full width: 500 iterations of 255 leaves
    bst, train_s, _ = counted(lambda: lgb.train(dict(TRAIN_PARAMS), train_set, SERVE_ROUNDS,
                                                device=dev))
    assert bst.num_trees() == SERVE_ROUNDS, bst.num_trees()
    pk = bst.to_packed()
    assert pk.device.type == dev.type and tuple(pk.packed.feature.shape) == (
        SERVE_ROUNDS, TRAIN_PARAMS["num_leaves"] - 1), tuple(pk.packed.feature.shape)
    rec["model"] = dict(trees=pk.num_trees, max_nodes=int(pk.packed.feature.shape[1]),
                        features=pk.num_features, train_s=train_s,
                        lattice_max=max(len(b) for b in pk.feat_bounds))
    # held-out rows of the main path's distribution, 2% NaN
    Xh, _ = higgs_like_rows(SERVE_HELD_ROWS, FEATURES, seed=9)
    Xh = Xh.astype(np.float64)
    Xh[np.random.RandomState(10).rand(*Xh.shape) < 0.02] = np.nan
    Xc = np.asarray(cat_rows[:SERVE_HELD_ROWS], np.float64).copy()
    Xc[np.random.RandomState(11).rand(*Xc.shape) < 0.02] = np.nan
    pkc = cat_booster.to_packed()
    part_done("train_and_pack")

    # 1. each kernel against its plain version on the card, bit for bit
    for label, ens, rows in (("main", pk, Xh), ("categorical", pkc, Xc)):
        P, K = ens.packed, ens.num_tree_per_iteration
        for n in SERVE_SIZES:
            Xd = torch.as_tensor(np.resize(rows, (n, rows.shape[1])).astype(np.float32), device=dev)
            codes, isnan = packed_kernel.packed_bin_rows(Xd, ens.bounds_dev, ens.is_cat_dev)
            want_c, want_n = predict_plain.packed_bin_rows(Xd, ens.bounds_dev, ens.is_cat_dev)
            leaves = packed_kernel.packed_predict_leaves(codes, isnan, P)
            want_l = predict_plain.packed_predict_leaves(codes, isnan, P)
            vals = packed_kernel.packed_predict_values(codes, isnan, P, K, ens.average_output)
            want_v = predict_plain.packed_predict_values(codes, isnan, P, K, ens.average_output)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            errs = dict(
                packed_bin_rows=int(max((codes - want_c).abs().max(), (isnan != want_n).sum())),
                packed_predict_leaves=int((leaves - want_l).abs().max()),
                packed_predict_values=float((vals - want_v).abs().max()))
            assert not any(errs.values()), ("a serving kernel != its plain version", label, n, errs)
    rec["kernels_vs_plain"] = dict(sizes=list(SERVE_SIZES), models=["main", "categorical"],
                                   max_abs_err=0.0)
    part_done("kernels_vs_plain")

    # 2. the exact path on the card against Booster.predict, bit for bit
    ref = {"value": bst.predict(Xh), "raw": bst.predict(Xh, raw_score=True),
           "leaf": bst.predict(Xh, pred_leaf=True)}
    assert np.array_equal(pk.predict(Xh), ref["value"]), "exact path != Booster.predict"
    assert np.array_equal(pk.predict(Xh, raw_score=True), ref["raw"]), "exact raw != predict"
    leaves_h = pk.predict(Xh, pred_leaf=True)
    assert leaves_h.dtype == np.int32 and np.array_equal(leaves_h, ref["leaf"]), "pred_leaf"
    kc = Xc[:10_000]
    assert np.array_equal(pkc.predict(kc), cat_booster.predict(kc)), "categorical exact path"
    assert np.array_equal(pkc.predict(kc, pred_leaf=True), cat_booster.predict(kc, pred_leaf=True))
    ref_swap = bst.predict(Xh, num_iteration=SERVE_SWAP_ROUNDS)
    # the fused path's yardstick, for each served model: each row's leaves
    # from its f32 codes (the kernels', equal to the plain versions above),
    # their f64 values summed, and 2 T 2^-24 times their absolute sum as the
    # bound of f32 values summed in f32
    path1 = os.path.join(workdir, "serve_main.txt")
    path2 = os.path.join(workdir, "serve_swap.txt")
    bst.save_model(path1)
    bst.save_model(path2, num_iteration=SERVE_SWAP_ROUNDS)
    Xd = torch.as_tensor(Xh.astype(np.float32), device=dev)
    fused_ref, apart = {}, {}
    for version, path in ((1, path1), (2, path2)):
        ens = lgb.Booster(model_file=path, device=dev).to_packed()
        codes, isnan = packed_kernel.packed_bin_rows(Xd, ens.bounds_dev, ens.is_cat_dev)
        f32_leaves = packed_kernel.packed_predict_leaves(codes, isnan, ens.packed).long()
        v64 = torch.as_tensor(ens.leaf_value64, device=dev).gather(1, f32_leaves)  # [T, N]
        fused_ref[version] = (v64.sum(0).cpu().numpy(),
                              2.0 * ens.num_trees * 2.0 ** -24 * v64.abs().sum(0).cpu().numpy())
        # rows whose f32 codes differ from the f64 host codes somewhere
        apart[version] = int((codes.cpu().numpy() != ens._host_codes(Xh)[0]).any(1).sum())
        del codes, isnan, f32_leaves, v64
    rec["exact_vs_predict"] = dict(rows=SERVE_HELD_ROWS, nan_share=0.02, bit_equal=True,
                                   categorical_rows=10_000, f32_code_rows_apart=apart)
    del Xd
    part_done("exact_vs_predict")

    # 3. the server: python -m lightgbm_tpu_torch.serve's main() in this
    # process (the launch counts are read here), on the card, warmed to
    # 4096 rows, under 8 clients; a hot swap to the 100-iteration model
    with socket.socket() as so:
        so.bind(("127.0.0.1", 0))
        port = so.getsockname()[1]
    refs = {1: ref["value"], 2: ref_swap}
    rng = np.random.RandomState(12)
    plans = []  # (client, offset, rows, fused, body)
    for c in range(SERVE_CLIENTS):
        for i in range(SERVE_REQUESTS):
            n = int(min(max(np.exp(rng.uniform(0.0, np.log(SERVE_MAX_ROWS))), 1), SERVE_MAX_ROWS))
            off = int(rng.randint(0, SERVE_HELD_ROWS - n))
            fused = bool(i % 2)
            body = json.dumps({"rows": Xh[off:off + n].tolist(), "model": "main",
                               "fused": fused, "raw_score": fused})
            plans.append((c, off, n, fused, body))

    def post(body, path="/predict"):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        try:
            conn.request("POST", path, body, {"Content-Type": "application/json"})
            r = conn.getresponse()
            return r.status, json.loads(r.read())
        finally:
            conn.close()

    def get(path):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        try:
            conn.request("GET", path)
            r = conn.getresponse()
            return r.status, r.read().decode("utf-8")
        finally:
            conn.close()

    box = {"errors": [], "checked": {"exact": 0, "fused": 0}, "versions": set()}

    def check(plan, status, body):
        _, off, n, fused, _ = plan
        if status != 200:
            box["errors"].append((status, str(body)[:200]))
            return
        got = np.asarray(body["predictions"], np.float64)
        version = body["version"]
        box["versions"].add(version)
        if fused:
            want, tol = fused_ref[version]
            if not np.all(np.abs(got - want[off:off + n]) <= tol[off:off + n]):
                box["errors"].append(("fused past its bound", version, off, n))
            box["checked"]["fused"] += 1
        else:
            if got.tobytes() != refs[version][off:off + n].tobytes():
                box["errors"].append(("exact != Booster.predict", version, off, n))
            box["checked"]["exact"] += 1

    def load(plans_, clients):
        """Every plan through ``clients`` threads; (seconds, rows)."""
        per = [[p for p in plans_ if p[0] % clients == c] for c in range(clients)]

        def client(mine):
            for p in mine:
                check(p, *post(p[4]))

        threads = [threading.Thread(target=client, args=(m,), daemon=True) for m in per]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        return time.perf_counter() - t0, sum(p[2] for p in plans_)

    def latency(n, fused, reps):
        body = json.dumps({"rows": Xh[:n].tolist(), "model": "main", "fused": fused,
                           "raw_score": fused})
        ms = []
        for _ in range(reps):
            t0 = time.perf_counter()
            status, _ = post(body)
            ms.append((time.perf_counter() - t0) * 1e3)
            assert status == 200, status
        ms.sort()
        return {"p50_ms": ms[len(ms) // 2], "p99_ms": ms[min(int(0.99 * len(ms)), len(ms) - 1)],
                "requests": reps}

    def drive():
        try:
            deadline = time.perf_counter() + 300
            while True:
                if stopped.is_set():
                    return
                try:
                    if get("/healthz")[0] == 200:
                        break
                except OSError:
                    pass
                assert time.perf_counter() < deadline, "the server did not come up"
                time.sleep(0.2)
            box["armed"] = retrace.WATCHDOG.armed
            swap = {}

            def hot_swap():
                while sum(box["checked"].values()) < len(plans) // 10 and not stopped.is_set():
                    time.sleep(0.01)
                swap["t"] = time.perf_counter()
                swap["status"], swap["body"] = post(json.dumps({"name": "main", "path": path2}),
                                                    "/models")
                swap["s"] = time.perf_counter() - swap["t"]

            swapper = threading.Thread(target=hot_swap, daemon=True)
            swapper.start()
            secs, rows = load(plans, SERVE_CLIENTS)
            swapper.join(120)
            box["load"] = dict(seconds=secs, rows=rows, requests=len(plans),
                               rows_per_s=rows / secs, swap_status=swap.get("status"),
                               swap_s=swap.get("s"))
            # per-path throughput: 8 clients, 20 requests each, one path
            for fused in (False, True):
                sub = [(c, off, n, fused, json.dumps({"rows": Xh[off:off + n].tolist(),
                                                      "model": "main", "fused": fused,
                                                      "raw_score": fused}))
                       for (c, off, n, _, _) in plans[:SERVE_CLIENTS * 20]]
                s_, r_ = load(sub, SERVE_CLIENTS)
                box["fused_rows_per_s" if fused else "exact_rows_per_s"] = r_ / s_
            box["latency"] = {"exact_1": latency(1, False, 100), "fused_1": latency(1, True, 100),
                              "exact_1000": latency(1000, False, 30),
                              "fused_1000": latency(1000, True, 30)}
            box["retraces_after_warmup"] = retrace.retraces_after_warmup()
            box["metrics_text"] = get("/metrics")[1]
            box["models"] = json.loads(get("/models")[1])
        except BaseException as e:  # reported by the main thread
            box["drive_error"] = repr(e)
        finally:
            if not stopped.is_set():
                os.kill(os.getpid(), signal.SIGTERM)  # the server's graceful drain

    handlers = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    old_mode = os.environ.get("LIGHTGBM_TPU_RETRACE")
    os.environ["LIGHTGBM_TPU_RETRACE"] = "fail"  # a retrace after warmup fails its request
    stopped = threading.Event()  # main() has returned or raised
    driver = threading.Thread(target=drive, daemon=True)
    safety = threading.Timer(480.0, lambda: os.kill(os.getpid(), signal.SIGTERM))
    safety.daemon = True
    try:
        driver.start()
        safety.start()
        rc, serve_s, launches = counted(lambda: serve_main.main([
            "main=" + path1, "--host", "127.0.0.1", "--port", str(port), "--device", dev.type,
            "--warmup-rows", str(SERVE_MAX_ROWS)]))
    finally:
        stopped.set()
        safety.cancel()
        driver.join(60)
        for s, h in handlers.items():
            signal.signal(s, h)
        retrace.disarm()
        if old_mode is None:
            os.environ.pop("LIGHTGBM_TPU_RETRACE", None)
        else:
            os.environ["LIGHTGBM_TPU_RETRACE"] = old_mode
    assert rc == 0, rc
    assert "drive_error" not in box, box.get("drive_error")
    assert not box["errors"], box["errors"][:5]
    assert box["armed"], "the watchdog was not armed after warmup"
    assert box["retraces_after_warmup"] == {}, box["retraces_after_warmup"]
    assert box["load"]["swap_status"] == 200 and box["versions"] == {1, 2}, (
        box["load"], box["versions"])
    assert box["checked"]["exact"] >= SERVE_CLIENTS * SERVE_REQUESTS // 2, box["checked"]
    assert all(launches.get(k, 0) > 0 for k in packed_kernel.ENTRIES), launches
    assert "lgbtpu_requests_total" in box["metrics_text"]
    rec["server"] = dict(
        clients=SERVE_CLIENTS, requests_each=SERVE_REQUESTS, rows_per_request="1-%d, log-uniform"
        % SERVE_MAX_ROWS, seconds=serve_s, launches=launches, checked=box["checked"],
        versions=sorted(box["versions"]), retraces_after_warmup=0, load=box["load"],
        exact_rows_per_s=box["exact_rows_per_s"], fused_rows_per_s=box["fused_rows_per_s"],
        latency=box["latency"], models=[m["num_trees"] for m in box["models"]["models"]])
    part_done("server")

    # 4. each kernel's time at 16 and 4096 rows against its bound
    F = pk.num_features
    T, M = pk.packed.feature.shape
    L = pk.packed.leaf_value.shape[1]
    rows_t = {}
    for n in (16, 4096):
        Xd = torch.as_tensor(Xh[:n].astype(np.float32), device=dev)
        codes, isnan = packed_kernel.packed_bin_rows(Xd, pk.bounds_dev, pk.is_cat_dev)
        bounds_n = packed_bounds(n, F, T, M, L, 1, pk.bounds_dev.shape[1],
                                 pk.packed.cat_words.numel())
        fns = {
            "packed_bin_rows": (
                lambda: packed_kernel.packed_bin_rows(Xd, pk.bounds_dev, pk.is_cat_dev),
                lambda: predict_plain.packed_bin_rows(Xd, pk.bounds_dev, pk.is_cat_dev),
                lambda: torch.searchsorted(pk.bounds_dev, Xd.t().contiguous())),
            "packed_predict_leaves": (
                lambda: packed_kernel.packed_predict_leaves(codes, isnan, pk.packed),
                lambda: predict_plain.packed_predict_leaves(codes, isnan, pk.packed), None),
            "packed_predict_values": (
                lambda: packed_kernel.packed_predict_values(codes, isnan, pk.packed, 1, False),
                lambda: predict_plain.packed_predict_values(codes, isnan, pk.packed, 1, False),
                None),
        }
        for name, (kern, plain_fn, lib) in fns.items():
            b_ms, b_by = bounds_n[name]
            rows_t.setdefault(name, {})[n] = dict(
                ms=time_ms(kern), plain_ms=time_ms(plain_fn, reps=3), bound_ms=b_ms,
                bound_by=b_by, library_ms=None if lib is None else time_ms(lib))
    rec["kernel_times"] = rows_t
    part_done("kernel_times")
    rec["part_seconds"] = part_s
    replaces = {
        "packed_bin_rows": "lightgbm_tpu/ops/predict.py:299 (packed_bin_rows; XLA there)",
        "packed_predict_leaves": "lightgbm_tpu/ops/predict.py:266,204 (packed_predict_leaves, "
                                 "_packed_tree_leaf; XLA there)",
        "packed_predict_values": "lightgbm_tpu/ops/predict.py:276 (packed_predict_values; XLA "
                                 "there)",
    }
    kernels = []
    for name in packed_kernel.ENTRIES:
        t = rows_t[name]
        kernels.append(dict(
            name=name, route="cuda", source="lightgbm_tpu_torch/csrc/packed_predict.cu",
            replaces=replaces[name], launches=launches.get(name, 0), max_abs_err=0.0,
            ms=t[4096]["ms"], plain_ms=t[4096]["plain_ms"], bound_ms=t[4096]["bound_ms"],
            bound_by=t[4096]["bound_by"], library_ms=t[4096]["library_ms"],
            sizes={"rows": 4096, "at_16_rows": t[16]},
        ))
    return rec, kernels, bst


F64_FLOP_PER_S = 34e12  # H100 SXM, f64 outside the tensor cores (NVIDIA data sheet)
CONTRIB_ROWS = 10_000
CONTRIB_HELD_TREES = 20  # the kernel against its plain version on the first trees
CHAIN_DEPTH = 80
EARLY_STOP_ROWS = 100_000
EARLY_STOP_FREQ = 10
EARLY_STOP_MARGIN = 4.0
REFIT_ROWS = 100_000
CSV_ROWS = 100_000


def shap_operations(trees):
    """f64 operations of TreeSHAP for one row through ``trees`` (what every
    row needs: each row walks every leaf's path), counted on the cheaper side
    of each branch, so the count is a floor: ExtendPath 7 a position below
    the new one, UnwindPath 3 a position when the node's feature is already
    on the path, four for the two zero fractions, and at each leaf
    UnwoundPathSum 3 a position pair and 4 a position for its contribution."""
    total = 0
    for t in trees:
        if t.num_leaves <= 1:
            continue
        stack = [(0, [])]  # (node, the features of the path below the root)
        while stack:
            node, path = stack.pop()  # ExtendPath at depth len(path) first
            if node < 0:
                total += 7 * len(path) + len(path) * (3 * len(path) + 4)
                continue
            total += 7 * len(path) + 4
            f = int(t.split_feature[node])
            if f in path:
                total += 3 * len(path)
                path = [g for g in path if g != f]
            for child in (int(t.left_child[node]), int(t.right_child[node])):
                stack.append((child, path + [f]))
    return total


def prediction_phase(lgb, dev, counted, time_ms, bst, train_set, X, y, train_auc, cat_booster,
                     cat_rows, workdir):
    """The rest of prediction and the file-based Dataset on the card (phase
    8c of the module docstring). Returns (the phase's record, the tree_shap
    row of the kernels line)."""
    import numpy as np
    import torch

    from lightgbm_tpu_torch.basic import _mappers_json
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.dataset import Metadata
    from lightgbm_tpu_torch.metric import create_metric
    from lightgbm_tpu_torch.ops import shap as shap_plain
    from lightgbm_tpu_torch.ops import shap_kernel

    rec = {}
    t_part = [time.perf_counter()]
    part_s = {}

    def part_done(name):
        now = time.perf_counter()
        part_s[name] = now - t_part[0]
        t_part[0] = now

    def once_ms(fn):
        """(fn's result, its ms between two CUDA events), the L2 flushed first."""
        torch.cuda.synchronize()
        time_ms._flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)

    def auc_of(label, score):
        m = create_metric("auc", Config())
        m.init(Metadata(len(label), label=label), len(label))
        return m.eval(score, None)[0][1]

    def held_rows(n, seed):
        Xn, yn = higgs_like_rows(n, FEATURES, seed=seed)
        Xn = Xn.astype(np.float64)
        Xn[np.random.RandomState(seed + 1).rand(*Xn.shape) < 0.02] = np.nan
        return Xn, yn

    trees = bst._gbdt.trees()
    T, F = len(trees), bst.num_feature()
    # raw scores and leaves beside the checks come from the packed exact
    # path, equal to Booster.predict bit for bit (phase 8b) and far quicker
    pk = bst.to_packed()

    # 1. pred_contrib at full width: 10,000 held-out rows, all 500 trees
    Xc, _ = held_rows(CONTRIB_ROWS, 13)
    contrib, secs, launches = counted(lambda: bst.predict(Xc, pred_contrib=True))
    assert launches.get("tree_shap", 0) > 0, launches
    assert contrib.shape == (CONTRIB_ROWS, F + 1) and np.all(np.isfinite(contrib)), contrib.shape
    raw = pk.predict(Xc, raw_score=True)
    leaves = pk.predict(Xc, pred_leaf=True)
    leaf_abs = sum(np.abs(t.leaf_value[leaves[:, i]]) for i, t in enumerate(trees))
    depth = max(t.max_depth() for t in trees)
    # each SHAP value carries at most (depth + 2)^2 rounded operations a tree
    # on values no larger than the leaves', and the two sums F + 1 and T adds
    sum_err = np.abs(contrib.sum(axis=1) - raw)
    sum_bound = 2.0 ** -53 * (T * (depth + 2) ** 2 + F + 1) * (np.abs(contrib).sum(axis=1)
                                                                + leaf_abs)
    assert np.all(sum_err <= sum_bound), float((sum_err / sum_bound).max())
    ens = shap_kernel.shap_trees(trees, dev)
    Xd = torch.as_tensor(Xc, device=dev)
    _, kernel_ms = once_ms(lambda: shap_kernel.tree_shap(Xd, ens, 1, F))
    ops = shap_operations(trees) * CONTRIB_ROWS
    nbytes = (Xc.nbytes + ens.nodes.numel() + ens.leaves.numel() + ens.words.numel() * 4
              + T * 12 + CONTRIB_ROWS * (F + 1) * 8)
    t_ops, t_bytes = ops / F64_FLOP_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    rec["contrib"] = dict(
        rows=CONTRIB_ROWS, trees=T, max_depth=depth, seconds=secs, launches=launches,
        kernel_ms=kernel_ms, f64_operations=ops, bytes=nbytes,
        bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes",
        max_sum_err=float(sum_err.max()), sum_err_over_bound=float((sum_err / sum_bound).max()),
        slot_bytes=shap_kernel.slot_bytes(depth),
        plan=shap_kernel.launch_plan(ens, CONTRIB_ROWS, F, 1, dev)._asdict())
    del Xd
    part_done("contrib")

    # 2. the kernel against its plain version, bit for bit, at the 10,000
    # rows of 1: the first 20 trees (their tiles more than the grid, so each
    # block loops and re-stages trees as in 1), 4g's categorical K = 7 model
    # (its first 2 iterations) and a chain
    chain = lgb.Booster(model_str=chain_model_text(CHAIN_DEPTH, F, seed=17), device=dev)
    Kc = cat_booster.num_model_per_iteration()
    cat_x = np.asarray(cat_rows[:CONTRIB_ROWS], np.float64).copy()
    cat_x[np.random.RandomState(18).rand(*cat_x.shape) < 0.02] = np.nan
    cases = {
        "first_%d_trees" % CONTRIB_HELD_TREES: (trees[:CONTRIB_HELD_TREES], Xc, 1, F),
        "categorical": (cat_booster._gbdt.trees()[:2 * Kc], cat_x, Kc, cat_booster.num_feature()),
        "chain": (chain._gbdt.trees(), Xc, 1, F),
    }
    held = {}
    for name, (ts, rows, K, Fn) in cases.items():
        Xn = torch.as_tensor(np.ascontiguousarray(rows), device=dev)
        e = shap_kernel.shap_trees(ts, dev)
        plan = shap_kernel.launch_plan(e, len(Xn), Fn, K, dev)
        got, k_ms = once_ms(lambda: shap_kernel.tree_shap(Xn, e, K, Fn))
        want, p_ms = once_ms(lambda: shap_plain.contrib_plain(Xn, ts, K, Fn))
        assert torch.equal(got, want), (name, float((got - want).abs().max()))
        held[name] = dict(trees=len(ts), rows=len(Xn), classes=K, features=Fn,
                          max_depth=max(t.max_depth() for t in ts), ms=k_ms, plain_ms=p_ms,
                          categorical_nodes=sum(int(t.num_cat) for t in ts), equal=True,
                          plan=plan._asdict())
    first = held["first_%d_trees" % CONTRIB_HELD_TREES]
    assert first["rows"] == CONTRIB_ROWS and first["plan"]["staged"], first
    assert first["plan"]["tiles"] > first["plan"]["grid"], ("no block loops", first["plan"])
    rec["kernel_vs_plain"] = held
    part_done("kernel_vs_plain")

    # 3. pred_early_stop on 100,000 rows: the stops replayed from each row's
    # leaves (its running f64 sum in tree order, checked every
    # EARLY_STOP_FREQ iterations) give every row's value bit for bit
    Xe, _ = held_rows(EARLY_STOP_ROWS, 21)
    t0 = time.perf_counter()
    full = bst.predict(Xe, raw_score=True)
    predict_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    early = bst.predict(Xe, raw_score=True, pred_early_stop=True,
                        pred_early_stop_freq=EARLY_STOP_FREQ,
                        pred_early_stop_margin=EARLY_STOP_MARGIN)
    early_s = time.perf_counter() - t0
    leaves = torch.as_tensor(pk.predict(Xe, pred_leaf=True).astype(np.int64), device=dev)
    running = torch.zeros(EARLY_STOP_ROWS, dtype=torch.float64, device=dev)
    at_stop = torch.zeros_like(running)
    active = torch.ones(EARLY_STOP_ROWS, dtype=torch.bool, device=dev)
    for i, t in enumerate(trees):
        running += torch.as_tensor(t.leaf_value, device=dev)[leaves[:, i]]
        if (i + 1) % EARLY_STOP_FREQ == 0:
            stop = active & (2.0 * running.abs() > EARLY_STOP_MARGIN)
            at_stop = torch.where(stop, running, at_stop)
            active &= ~stop
    active_np = active.cpu().numpy()
    stopped = int((~active_np).sum())
    assert 0 < stopped < EARLY_STOP_ROWS, stopped
    assert np.array_equal(early[active_np], full[active_np]), "a row never stopped != predict"
    assert np.array_equal(early[~active_np], at_stop.cpu().numpy()[~active_np]), "stopped rows"
    rec["early_stop"] = dict(rows=EARLY_STOP_ROWS, freq=EARLY_STOP_FREQ, margin=EARLY_STOP_MARGIN,
                             rows_stopped=stopped, predict_ms=predict_s * 1e3,
                             early_stop_ms=early_s * 1e3, unstopped_equal_predict=True)
    del leaves, running, at_stop, active
    part_done("early_stop")

    # 4. Booster.refit of the model on 100,000 rows; held-out AUC before and after
    Xr, yr = higgs_like_rows(REFIT_ROWS, FEATURES, seed=23)
    Xa, ya = higgs_like_rows(REFIT_ROWS, FEATURES, seed=25)
    t0 = time.perf_counter()
    refit = bst.refit(Xr, yr, decay_rate=0.9)
    torch.cuda.synchronize()
    refit_s = time.perf_counter() - t0
    assert refit.num_trees() == T and refit._gbdt.device == bst._gbdt.device
    auc_before = auc_of(ya, pk.predict(Xa))
    auc_after = auc_of(ya, refit.to_packed().predict(Xa))
    assert auc_after > 0.7 and abs(auc_after - auc_before) < 0.05, (auc_before, auc_after)
    rec["refit"] = dict(rows=REFIT_ROWS, trees=T, decay_rate=0.9, seconds=refit_s,
                        held_out_auc_before=auc_before, held_out_auc_after=auc_after)
    del refit
    part_done("refit")

    # 5. files: the training Dataset's binary file, a CSV of 100,000 rows,
    # and 10 iterations on the reloaded binary file
    bin_path = os.path.join(workdir, "train.bin")
    t0 = time.perf_counter()
    train_set.save_binary(bin_path)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = lgb.Dataset(bin_path, params=dict(TRAIN_PARAMS)).construct()
    load_s = time.perf_counter() - t0
    assert np.array_equal(loaded._binned.bins, train_set._binned.bins), "binary file bins"
    assert _mappers_json(loaded._binned.mappers) == _mappers_json(train_set._binned.mappers)
    csv_path = os.path.join(workdir, "rows.csv")
    t0 = time.perf_counter()
    np.savetxt(csv_path, np.c_[y[:CSV_ROWS], X[:CSV_ROWS]], fmt="%.17g", delimiter=",")
    csv_ds = lgb.Dataset(csv_path, params=dict(TRAIN_PARAMS)).construct()
    csv_s = time.perf_counter() - t0
    mem = lgb.Dataset(X[:CSV_ROWS], label=y[:CSV_ROWS], params=dict(TRAIN_PARAMS)).construct()
    assert np.array_equal(csv_ds._binned.bins, mem._binned.bins), "CSV bins"
    assert np.array_equal(csv_ds._binned.metadata.label, mem._binned.metadata.label)
    file_bst = lgb.train(dict(TRAIN_PARAMS), loaded, 10, device=dev)
    (_, _, file_auc, _), = file_bst.eval_train()
    assert abs(file_auc - train_auc) <= 2e-3, (file_auc, train_auc)
    rec["files"] = dict(binary_bytes=os.path.getsize(bin_path), save_binary_s=save_s,
                        load_binary_s=load_s, csv_rows=CSV_ROWS, csv_write_and_load_s=csv_s,
                        bins_equal=True, mappers_equal=True, auc_10_iterations=file_auc,
                        in_memory_auc=train_auc)
    del loaded, csv_ds, mem, file_bst
    part_done("files")
    rec["part_seconds"] = part_s
    kernel = dict(
        name="tree_shap", route="cuda", source="lightgbm_tpu_torch/csrc/tree_shap.cu",
        replaces="lightgbm_tpu/models/tree.py:467 (predict_contrib_row; host Python there, "
                 "no TPU kernel)",
        launches=launches.get("tree_shap", 0), max_abs_err=0.0, ms=kernel_ms,
        plain_ms=first["plain_ms"], bound_ms=rec["contrib"]["bound_ms"],
        bound_by=rec["contrib"]["bound_by"], library_ms=None,
        sizes={"rows": CONTRIB_ROWS, "trees": T, "plain_at": {
            "rows": CONTRIB_ROWS, "trees": CONTRIB_HELD_TREES, "kernel_ms": first["ms"]}},
    )
    return rec, kernel


def plain_pick_partition(st):
    """pick_partition's plain versions on the state ``st``: the pick, then
    the partition (ops/grow_step.py ``pick``, ops/partition.py)."""
    from lightgbm_tpu_torch.ops import grow_step, partition
    grow_step.pick(st)
    partition.partition(st)


def same_state(a, b, what, skip=()):
    """Every state tensor of ``a`` equal to ``b``'s (NaN where ``b`` has
    NaN), but those named in ``skip``."""
    from lightgbm_tpu_torch.ops.grow_state import GrowState
    for k in GrowState.STATE:
        if k in skip:
            continue
        x_, y_ = getattr(a, k), getattr(b, k)
        eq = x_ == y_
        if x_.is_floating_point():
            eq |= x_.isnan() & y_.isnan()
        assert bool(eq.all()), ("kernel != plain", what, k)


def restore(dst, src):
    """Every state tensor of ``dst`` copied from ``src``."""
    from lightgbm_tpu_torch.ops.grow_state import GrowState
    for k in GrowState.STATE:
        getattr(dst, k).copy_(getattr(src, k))


def held_and_timed(st, name, kernel, plain, time_ms, check_small=None):
    """``kernel`` on the state ``st`` against ``plain`` on a copy (the whole
    state equal; with ``check_small(st, other)``, which checks ``small``
    itself and returns its max_abs_err, all but ``small``), then both timed
    from that state, which is left as the kernel made it."""
    before, other = st.clone(), st.clone()
    kernel(st)
    plain(other)
    same_state(st, other, name, ("small",) if check_small else ())
    err = check_small(st, other) if check_small else 0.0
    after, copy = st.clone(), before.clone()
    t = dict(ms=time_ms(lambda: kernel(st), setup=lambda: restore(st, before)),
             plain_ms=time_ms(lambda: plain(copy), reps=3, setup=lambda: restore(copy, before)),
             max_abs_err=err)
    restore(st, after)
    return t


WIDE_MAX_BIN = 1024  # the widest bins the port trains (int16 on the card)
WIDE_NARROW_BIN = 300  # inside the TPU kernel's own wide range (257-336)
WIDE_POOL_MB = 16  # 48 slots of 28 x 1024 x 3 x 4 = 344,064 bytes
WIDE_POOL_SLOTS = 48
WIDE_VALID_ROWS = 100_000
WIDE_CAT_ROWS = 200_000  # the categorical check's table: 11 numerical columns and one of
WIDE_CAT_CATEGORIES = 1000  # this many categories, so that a split's bits pass word 8
WIDE_BITWISE_ROWS = 100_000  # pooled = unpooled on gradients rounded to 2^-7
WIDE_HOLD_EVERY = 16  # the step kernels held to their plain versions every 16th step


def wide_bins_phase(lgb, dev, ctx):
    """Wide bins and the histogram pool on the card (phase 8d of the module
    docstring). ``ctx`` carries main's ``counted``, ``profiled``,
    ``time_ms``, ``X``, ``y``, the main path's ``train_set``, the dyadic and
    real root values ``dyq_vals`` / ``real_vals``, the 100k-row segment
    ``seg_rows``, ``dyadic_gradients`` (the binary objective rounded to
    2^-7) and ``card``. Returns (the phase's record, each new kernel's row
    of the kernels line)."""
    import numpy as np
    import torch

    from lightgbm_tpu_torch import objective as objective_mod
    from lightgbm_tpu_torch.bench import train_iterations
    from lightgbm_tpu_torch.ops import grow as grow_mod
    from lightgbm_tpu_torch.ops import grow_state as gs
    from lightgbm_tpu_torch.ops import grow_step as grow_step_plain
    from lightgbm_tpu_torch.ops import hist_kernel, partition_kernel, predict_kernel, split_kernel
    from lightgbm_tpu_torch.ops import predict as predict_plain
    from lightgbm_tpu_torch.ops.histogram import leaf_histogram, segment_histogram
    from lightgbm_tpu_torch.ops.split import find_best_split_pair
    from lightgbm_tpu_torch.ops.split import split_pair_step as split_pair_step_plain

    counted, profiled, time_ms = ctx.counted, ctx.profiled, ctx.time_ms
    X, y = ctx.X, ctx.y
    N, F = X.shape
    wide_params = dict(TRAIN_PARAMS, max_bin=WIDE_MAX_BIN)
    pool_params = dict(wide_params, histogram_pool_size=WIDE_POOL_MB)
    rec = {"card": ctx.card}

    # ---- training at max_bin 1024, unpooled and pooled, captured -------------------
    wide_set = lgb.Dataset(X, label=y)
    Xv, yv = higgs_like_rows(WIDE_VALID_ROWS, F, seed=11)
    wide_valid = lgb.Dataset(Xv, label=yv, reference=wide_set)
    runs = {}
    for name, params in (("unpooled", wide_params), ("pooled", pool_params)):
        res = {}
        bst, secs, got = counted(lambda: lgb.train(dict(params), wide_set, 10,
                                                   valid_sets=[wide_valid], evals_result=res,
                                                   verbose_eval=False))
        g = bst._gbdt
        assert g.grow_loop == "device" and g.captures == 1, (name, g.grow_loop, g.captures)
        assert g.bins_dev.dtype == torch.int16 and g.num_bins == WIDE_MAX_BIN, g.num_bins
        assert (g.hist_pool_slots or 0) == (WIDE_POOL_SLOTS if name == "pooled" else 0)
        (_, _, auc, _), = bst.eval_train()
        assert auc > 0.7, (name, auc)
        # every launch of the loop's kernels and of predict_bins (replays counted) is
        # an int16 (rows1024) instantiation, and with the pool every folded scan and
        # pick a pool one: no launch counts under another key of theirs
        pool = "_pool" if name == "pooled" else ""
        want = {"histogram_wide", "histogram_segment_wide", "split_pair_step_rows1024",
                "split_pair_fold_rows1024" + pool, "pick_partition_wide" + pool,
                "predict_bins_wide", "score_update"}
        assert all(got.get(k, 0) > 0 for k in want), (name, got)
        assert set(got) <= want | {"leaf_ids"}, (name, got)
        runs[name] = dict(booster=bst, seconds=secs, launches=got, auc=auc,
                          valid_auc=res["valid_0"]["auc"][-1],
                          leaves=[t.num_leaves for t in g.trees()])
    g_w, g_p = runs["unpooled"]["booster"]._gbdt, runs["pooled"]["booster"]._gbdt
    assert g_w.train_set.max_num_bin == WIDE_MAX_BIN

    # ---- histogram.cu's int16 instantiations at the root and a 100k segment -----------
    bins_nf = g_w.bins_nf  # the card's [N, F] int16 copy
    hist_checks, hist_t = {}, {}
    for B in (WIDE_NARROW_BIN, WIDE_MAX_BIN):
        nf = bins_nf if B == WIDE_MAX_BIN else bins_nf % B
        hb = nf.t()
        for dt in ("float32", "bfloat16"):
            for rows in (None, ctx.seg_rows):
                where = "root" if rows is None else "segment"
                got = hist_kernel.histogram(hb, ctx.dyq_vals, B, rows, dt)
                assert torch.equal(got, leaf_histogram(hb, ctx.dyq_vals, B, rows, dt)), (B, dt, where)
                got_r = hist_kernel.histogram(hb, ctx.real_vals, B, rows, dt)
                ratio, err = err_over_bound(got_r, leaf_histogram(hb, ctx.real_vals, B, rows, dt),
                                            leaf_histogram(hb, ctx.real_vals.abs(), B, rows, dt))
                assert ratio <= 1.0, ("histogram_wide off on real values", B, dt, where, err, ratio)
                hist_checks["%d_%s_%s" % (B, dt, where)] = dict(real_max_abs_err=err,
                                                                 real_err_over_bound=ratio)
                n = N if rows is None else int(rows.numel())
                t = dict(ms=time_ms(lambda: hist_kernel.histogram(hb, ctx.real_vals, B, rows, dt)),
                         max_abs_err=err)
                t.update(zip(("bound_ms", "bound_by"), bound(
                    n * F * 2 + n * 12 + (0 if rows is None else n * 4) + F * B * 12, 3 * n * F)))
                if dt == "float32":
                    t["plain_ms"] = time_ms(lambda: leaf_histogram(hb, ctx.real_vals, B, rows), reps=3)
                hist_t["%d_%s_%s" % (B, dt, where)] = t
    # one index_add_ at B = 1024: the yardstick
    flat_idx = (bins_nf.t().long() + torch.arange(F, device=dev)[:, None] * WIDE_MAX_BIN).reshape(-1)
    flat_vals = ctx.real_vals.repeat(F, 1)
    lib_out = torch.zeros((F * WIDE_MAX_BIN, 3), device=dev)

    def library_root():
        lib_out.zero_()
        lib_out.index_add_(0, flat_idx, flat_vals)
    hist_t["%d_float32_root" % WIDE_MAX_BIN]["library_ms"] = time_ms(library_root)
    # and over the 100k-row segment, the segment entry's yardstick
    seg_long = ctx.seg_rows.long()
    seg_idx = (bins_nf.index_select(0, seg_long).t().long()
               + torch.arange(F, device=dev)[:, None] * WIDE_MAX_BIN).reshape(-1)
    seg_vals = ctx.real_vals.index_select(0, seg_long).repeat(F, 1)

    def library_segment():
        lib_out.zero_()
        lib_out.index_add_(0, seg_idx, seg_vals)
    hist_t["%d_float32_segment" % WIDE_MAX_BIN]["library_ms"] = time_ms(library_segment)
    del flat_idx, flat_vals, lib_out, seg_idx, seg_vals

    # ---- split_pair.cu's wide instantiations at B = 1024 -------------------------------
    B = WIDE_MAX_BIN
    root_h = hist_kernel.histogram(bins_nf.t(), ctx.dyq_vals, B)
    seg_h = hist_kernel.histogram(bins_nf.t(), ctx.dyq_vals, B, ctx.seg_rows)
    hist2 = torch.stack([seg_h, root_h - seg_h]).contiguous()
    sums = hist2[:, 0].sum(dim=1).contiguous()
    cons = torch.tensor([[-np.inf, np.inf], [-np.inf, 0.5]], dtype=torch.float32, device=dev)
    meta = {k: v.clone() for k, v in g_w.feature_meta.items()}
    meta["missing_type"] = torch.arange(F, dtype=torch.int32, device=dev) % 3
    meta["monotone"] = torch.zeros(F, dtype=torch.int32, device=dev)
    meta["monotone"][3] = 1
    fmask = torch.ones(F, dtype=torch.bool, device=dev)
    cat_meta = dict(meta, is_categorical=torch.arange(F, device=dev) % 3 == 0)
    split_t = {}
    params = g_w.split_params
    for kind, mt in (("numerical", meta), ("categorical", cat_meta)):
        for two_way in (True, False):
            kf, ki, kb = split_kernel.find_best_split_pair(hist2, sums, cons, mt, fmask, params,
                                                           two_way)
            pf, pi, pb = find_best_split_pair(hist2, sums, cons, mt, fmask, params, two_way)
            same_f = (kf == pf) | (torch.isnan(kf) & torch.isnan(pf))
            assert bool(same_f.all()) and torch.equal(ki, pi) and torch.equal(kb, pb), (
                "split_pair wide != plain", kind, two_way, kf, pf, ki, pi)
        t = dict(ms=time_ms(lambda: split_kernel.find_best_split_pair(hist2, sums, cons, mt, fmask,
                                                                      params)),
                 plain_ms=time_ms(lambda: find_best_split_pair(hist2, sums, cons, mt, fmask,
                                                               params), reps=3), max_abs_err=0.0)
        t.update(zip(("bound_ms", "bound_by"), bound(hist2.numel() * 4 + 2 * 21 * 4 + F * 17,
                                                     2 * F * B * 60)))
        split_t[kind] = t
    del root_h, seg_h, hist2

    # ---- the step kernels held at every 16th step of a tree, timed at steps 0 and 128 ----
    dy_grad = ctx.dyq_vals[:, 0].contiguous()
    dy_hess = ctx.dyq_vals[:, 1].contiguous()

    def step_pairs(st, p):
        pairs = [("pick_partition", partition_kernel.pick_partition, plain_pick_partition),
                 ("histogram_segment", lambda s_: hist_kernel.histogram_segment(s_, p),
                  lambda s_: segment_histogram(s_, p))]
        if st.P:
            pairs.append(("histogram_segment_large",
                          lambda s_: hist_kernel.histogram_segment(s_, p, large=True),
                          lambda s_: segment_histogram(s_, p, large=True)))
        pairs.append(("split_pair_fold", lambda s_: split_kernel.split_pair_fold(s_, p),
                      lambda s_: grow_step_plain.split_pair_fold(s_, p)))
        return pairs

    def held_tree(g, grad, hess, bins, nf, time_steps=(), on_step=None, hold=True):
        """One eager tree on the state of ``g`` with every kernel of every
        16th step held to its plain version on a copy (the whole state
        equal: dyadic gradients; ``hold`` False holds none), the root's scan
        too; the kernels timed from the state of the steps in
        ``time_steps``; ``on_step(state, step)`` after each pick."""
        s = g._grow_state
        grow_mod.start_tree(s, bins, grad, hess, g.feature_mask, g.feature_meta,
                            g.config.max_depth, g.split_params, g._two_way, nf)
        root = ("split_pair_step", lambda s_: split_kernel.split_pair_step(s_, 1),
                lambda s_: split_pair_step_plain(s_, 1))
        times, held = {}, 0
        if 0 in time_steps:
            times["split_pair_step"] = held_and_timed(s, *root, time_ms)
        else:
            check = s.clone()
            root[2](check)
            same_state(s, check, "root")
        for step in range(s.M - 1):
            p = s.queued_steps % 2
            s.queued_steps += 1
            for name, kernel, plain in step_pairs(s, p):
                if step in time_steps:
                    times.setdefault(name, {})[step] = held_and_timed(s, name, kernel, plain,
                                                                      time_ms)
                    held += 1
                elif hold and step % WIDE_HOLD_EVERY == 0:
                    other = s.clone()
                    kernel(s)
                    plain(other)
                    same_state(s, other, (name, step))
                    held += 1
                else:
                    kernel(s)
                if on_step is not None and name == "pick_partition":
                    on_step(s, step)
        return s, times, held

    steps_t, held_n = {}, {}
    small_rows = []

    def note_small(st, step):
        if step == 0:
            small_rows.append(int(st.leaf_count[int(st.ctl[gs.SMALL])]))
    for name, g in (("unpooled", g_w), ("pooled", g_p)):
        s, t, held_n[name] = held_tree(g, dy_grad, dy_hess, g.bins_dev, g.bins_nf, (0, 128),
                                       note_small)
        assert int(s.ctl[gs.NUM_LEAVES]) > min(128, s.M - 2), int(s.ctl[gs.NUM_LEAVES])
        steps_t[name] = t
    steps_t["small_child_rows"] = small_rows[0]

    # the pooled steps that built both children, on the pooled run's real gradients
    grad_p, hess_p = g_p.objective.get_gradients(g_p.scores[0])
    misses = []

    def count_miss(st, step):
        if int(st.ctl[gs.ACTIVE]):
            misses.append(int(st.pool_ctl[gs.RUN]))
    held_tree(g_p, grad_p, hess_p, g_p.bins_dev, g_p.bins_nf, (), count_miss, hold=False)
    pool_rec = dict(slots=g_p.hist_pool_slots, slot_bytes=F * WIDE_MAX_BIN * 12,
                    steps=len(misses), steps_both_children=sum(misses),
                    share_both_children=sum(misses) / max(len(misses), 1))

    def predict_bound(st, leaf):
        """predict_bins' bound for the tree of the state ``st`` over rows
        that reached ``leaf``: each row's score read and written, and one
        int16 bin a level of its path (the mean depth of its leaf, from
        ``leaf_i``), beside the nodes (20 bytes) and membership words the
        blocks stage."""
        depth = float(st.leaf_i[leaf.long(), 1].double().mean())
        k = int(st.ctl[gs.NUM_LEAVES]) - 1
        staged = k * (20 + 4 * st.W)
        out = dict(mean_depth=depth, staged_bytes=staged)
        out.update(zip(("bound_ms", "bound_by"), bound(leaf.numel() * (8 + 2 * depth) + staged, 0)))
        return out

    # ---- a categorical feature of 1000 categories: bits past word 8 ----------------------
    rng = np.random.RandomState(5)
    cat_cols = 11
    Xc = np.empty((WIDE_CAT_ROWS + WIDE_VALID_ROWS // 2, cat_cols + 1), np.float32)
    Xc[:, :cat_cols] = rng.randn(len(Xc), cat_cols)
    Xc[:, cat_cols] = rng.randint(0, WIDE_CAT_CATEGORIES, len(Xc))
    effect = rng.randn(WIDE_CAT_CATEGORIES)
    yc = (Xc[:, 0] + effect[Xc[:, cat_cols].astype(int)] + 0.5 * rng.randn(len(Xc)) > 0).astype(np.float32)
    cat_set = lgb.Dataset(Xc[:WIDE_CAT_ROWS], label=yc[:WIDE_CAT_ROWS], categorical_feature=[cat_cols])
    cat_valid = lgb.Dataset(Xc[WIDE_CAT_ROWS:], label=yc[WIDE_CAT_ROWS:], reference=cat_set)
    cat_bst, cat_s, cat_launches = counted(lambda: lgb.train(
        dict(wide_params, metric="auc"), cat_set, 5, valid_sets=[cat_valid], verbose_eval=False))
    g_c = cat_bst._gbdt
    assert g_c.grow_loop == "device" and g_c.bins_dev.dtype == torch.int16
    assert g_c.num_words == -(-g_c.num_bins // 32) > 8, (g_c.num_bins, g_c.num_words)
    assert all(cat_launches.get(k, 0) > 0 for k in (
        "pick_partition_wide", "split_pair_fold_rows1024", "predict_bins_wide")), cat_launches
    ta = g_c._tree_arrays[0]
    nl = int(ta.num_leaves)
    cat_nodes = ta.split_feature[:nl - 1] == cat_cols
    assert bool(cat_nodes.any()) and bool(ta.cat_member[:nl - 1][cat_nodes][:, 256:].any()), \
        "no categorical split with a category past bin 255"
    # its kernels held on a dyadic tree of that table: the first categorical pick timed
    # (multiples of 2^-10 following the category's bin: every cell exact)
    rc = np.random.RandomState(6)
    q = 1024
    eff_q = torch.as_tensor(np.round(rc.randn(g_c.num_bins) / 8 * q) / q, dtype=torch.float32,
                            device=dev)
    gc = torch.tensor(rc.randint(-q, q + 1, WIDE_CAT_ROWS) / q, dtype=torch.float32, device=dev)
    gc = gc + eff_q[g_c.bins_dev[cat_cols].long()]
    hc = torch.tensor(rc.randint(1, 65, WIDE_CAT_ROWS) / q, dtype=torch.float32, device=dev)
    first_cat = []

    def note_cat(st, step):
        if not first_cat and int(st.ctl[gs.ACTIVE]):
            node = int(st.ctl[gs.STEP]) - 1
            if int(st.node_i[node, 0]) == cat_cols:
                first_cat.append(step)
    s_c, _, held_n["categorical"] = held_tree(g_c, gc, hc, g_c.bins_dev, g_c.bins_nf, (), note_cat)
    assert first_cat, "no categorical pick in the held tree"
    s_c2 = g_c._grow_state
    grow_mod.start_tree(s_c2, g_c.bins_dev, gc, hc, g_c.feature_mask, g_c.feature_meta,
                        g_c.config.max_depth, g_c.split_params, g_c._two_way, g_c.bins_nf)
    for _ in range(first_cat[0]):
        grow_mod.run_step(s_c2)
    rows_c = int(s_c2.leaf_count[int(torch.argmax(s_c2.best_f[:, 0]))])
    cat_pick_t = held_and_timed(s_c2, "categorical pick", partition_kernel.pick_partition,
                                plain_pick_partition, time_ms)
    assert int(s_c2.node_i[first_cat[0], 0]) == cat_cols
    cat_pick_t.update(rows=rows_c, **dict(zip(("bound_ms", "bound_by"), bound(
        s_c2.M * 4 + 320 + rows_c * 10, 0))))
    # the rest of that tree, then predict_bins over the held-out rows with its nodes
    while int(s_c2.ctl[gs.ACTIVE]) and int(s_c2.ctl[gs.STEP]) < s_c2.M - 1:
        grow_mod.run_step(s_c2)
    nodes, nl_t = s_c2.node_i[:s_c2.M - 1], s_c2.ctl[gs.NUM_LEAVES:gs.NUM_LEAVES + 1]
    cat_n = nodes[:int(nl_t) - 1, 0] == cat_cols
    assert bool((s_c2.node_b[:int(nl_t) - 1][cat_n][:, 8:] != 0).any()), "no word past 8 set"
    vbins = g_c._valid_bins[0]
    value = torch.randn(s_c2.M, device=dev)
    got_s, want_s = torch.zeros(vbins.shape[0], device=dev), torch.zeros(vbins.shape[0], device=dev)
    got_l = torch.empty(vbins.shape[0], dtype=torch.int32, device=dev)
    want_l = torch.empty_like(got_l)
    predict_kernel.add_tree_value(vbins, nodes, nl_t, g_c.feature_meta, value, got_s, got_l, s_c2.node_b)
    predict_plain.add_tree_value(vbins, nodes, nl_t, g_c.feature_meta, value, want_s, want_l, s_c2.node_b)
    assert torch.equal(got_l, want_l) and torch.equal(got_s, want_s)
    nv = vbins.shape[0]
    cat_predict_t = dict(
        ms=time_ms(lambda: predict_kernel.add_tree_value(vbins, nodes, nl_t, g_c.feature_meta, value,
                                                         got_s, None, s_c2.node_b)),
        plain_ms=time_ms(lambda: predict_plain.add_tree_value(vbins, nodes, nl_t, g_c.feature_meta,
                                                              value, want_s, None, s_c2.node_b), reps=3),
        max_abs_err=0.0, rows=nv)
    cat_predict_t.update(predict_bound(s_c2, got_l))
    # predict_bins over the wide run's held-out rows with its last tree (no categorical node)
    s_w = g_w._grow_state
    grow_mod.launch_tree(s_w, g_w.bins_dev, dy_grad, dy_hess, g_w.feature_mask, g_w.feature_meta,
                         g_w.config.max_depth, g_w.split_params, g_w._two_way, g_w.bins_nf)
    vb = g_w._valid_bins[0]
    nodes_w, nl_w = s_w.node_i[:s_w.M - 1], s_w.ctl[gs.NUM_LEAVES:gs.NUM_LEAVES + 1]
    value_w = torch.randn(s_w.M, device=dev)
    got_s, want_s = torch.zeros(vb.shape[0], device=dev), torch.zeros(vb.shape[0], device=dev)
    got_l = torch.empty(vb.shape[0], dtype=torch.int32, device=dev)
    want_l = torch.empty_like(got_l)
    predict_kernel.add_tree_value(vb, nodes_w, nl_w, g_w.feature_meta, value_w, got_s, got_l)
    predict_plain.add_tree_value(vb, nodes_w, nl_w, g_w.feature_meta, value_w, want_s, want_l)
    assert torch.equal(got_l, want_l) and torch.equal(got_s, want_s)
    predict_t = dict(
        ms=time_ms(lambda: predict_kernel.add_tree_value(vb, nodes_w, nl_w, g_w.feature_meta,
                                                         value_w, got_s)),
        plain_ms=time_ms(lambda: predict_plain.add_tree_value(vb, nodes_w, nl_w, g_w.feature_meta,
                                                              value_w, want_s), reps=3),
        max_abs_err=0.0, rows=int(vb.shape[0]))
    predict_t.update(predict_bound(s_w, got_l))

    # ---- pooled = unpooled at 100k rows on gradients rounded to 2^-7 --------------------
    get_gradients = objective_mod.BinaryLogloss.get_gradients
    objective_mod.BinaryLogloss.get_gradients = ctx.dyadic_gradients
    try:
        small = lgb.Dataset(X[:WIDE_BITWISE_ROWS], label=y[:WIDE_BITWISE_ROWS])
        pair = [lgb.train(dict(p_), small, 10) for p_ in (wide_params, pool_params)]
    finally:
        objective_mod.BinaryLogloss.get_gradients = get_gradients
    assert pair[1]._gbdt.hist_pool_slots == WIDE_POOL_SLOTS
    text = [b_.model_to_string().split("parameters:")[0] for b_ in pair]
    assert text[0] == text[1], "pooled trees differ from unpooled ones on rounded gradients"
    assert pair[0]._gbdt.train_score().tobytes() == pair[1]._gbdt.train_score().tobytes()
    del pair, small

    # ---- iterations/s in turns: the main path (255 bins), wide, wide pooled ------------
    kinds = {"main": (ctx.train_set, dict(TRAIN_PARAMS)), "wide": (wide_set, wide_params),
             "pooled": (wide_set, pool_params)}
    boosters = {}
    for kind, (ds, params) in kinds.items():
        for c in (1, 10):
            b_ = lgb.Booster(dict(params, device_chunk_size=c), ds)
            assert train_iterations(b_, 10, c) == 10
            boosters[(kind, c)] = b_
    order = [(k, c) for c in (1, 10) for k in kinds]
    order = order + order[::-1]
    ips = {"%s_%s" % (k, "graph" if c == 1 else "chunk"): [] for k, c in order}
    per_iter = {}
    for kind, c in order:
        ran, secs, got = counted(lambda: train_iterations(boosters[(kind, c)], 10, c))
        assert ran == 10, (kind, c, ran)
        ips["%s_%s" % (kind, "graph" if c == 1 else "chunk")].append(10 / secs)
        per_iter.setdefault(kind, {k_: v_ / 10 for k_, v_ in got.items()})
    prof = {}
    for kind in kinds:
        for c in (1, 10):
            b_ = boosters[(kind, c)]
            fn = b_.update if c == 1 else (lambda b2=b_: b2.update_chunk(10))
            for retake in range(3):
                busy, kernels, copies, timeline, named = profiled(fn)
                # the profiler loses events at these shapes (PERF.md §5): a trace
                # without the replay's one readback lost it, and is taken again
                if copies["DtoH"]:
                    break
            key = "%s_%s" % (kind, "graph" if c == 1 else "chunk")
            prof[key] = dict(
                device_busy_ms_per_iteration=busy / c, copies=copies,
                kernels_per_iteration=timeline["kernels"] / c if isinstance(timeline, dict)
                else "not measured",
                kernels_ms_per_iteration={k_: [v_[0] / c, v_[1] / c] for k_, v_ in named.items()},
                device_idle_share=[1 - busy / c * v / 1e3 for v in ips[key]] if busy
                else "not measured", traces_retaken=retake)
            assert copies["HtoD"] == 0 and copies["DtoH"] == 1, (key, copies, retake)
    del boosters

    rec.update(
        trainings={k: {k_: v_ for k_, v_ in r.items() if k_ != "booster"} for k, r in runs.items()},
        histogram=dict(checks=hist_checks, times=hist_t, dyadic_exact=True),
        split_pair=split_t, steps=steps_t, held_kernel_calls=held_n, pool=pool_rec,
        categorical=dict(num_bins=g_c.num_bins, words=g_c.num_words, launches=cat_launches,
                         first_categorical_pick_step=first_cat[0], pick=cat_pick_t,
                         predict_bins=cat_predict_t),
        predict_bins=predict_t, pooled_equals_unpooled_rows=WIDE_BITWISE_ROWS,
        iterations_per_s=ips, launches_per_iteration=per_iter, profile=prof)

    # ---- the kernels line's rows of the new instantiations --------------------------------
    src = "lightgbm_tpu_torch/csrc/"
    hist_rep = "lightgbm_tpu/ops/hist_pallas.py:225 (B <= 336; XLA code past it)"
    split_rep = "lightgbm_tpu/ops/split_pallas.py:221 (B <= 336; XLA code past it)"
    main_l = runs["unpooled"]["launches"]
    pool_l = runs["pooled"]["launches"]
    root_t = hist_t["%d_float32_root" % WIDE_MAX_BIN]

    def row(name, source, replaces, launches, t, library_ms=None):
        return dict(name=name, route="cuda", source=src + source, replaces=replaces,
                    launches=launches, max_abs_err=t["max_abs_err"], ms=t["ms"],
                    plain_ms=t["plain_ms"], bound_ms=t["bound_ms"], bound_by=t["bound_by"],
                    library_ms=library_ms)

    # bounds of the step kernels at step 0 (the root's split): the segment
    # histogram reads its child's rows (int16 bins, values, row ids) and
    # writes one [F, B, 3] row; the scans read and write the rows they fold;
    # the pick reads and writes a row id and reads a bin a row of the root
    seg = steps_t["unpooled"]["histogram_segment"][0]
    n_small = int(steps_t["small_child_rows"])
    cells = F * WIDE_MAX_BIN * 3
    seg.update(zip(("bound_ms", "bound_by"), bound(n_small * (2 * F + 16) + cells * 4,
                                                   3 * n_small * F)))
    fold = steps_t["unpooled"]["split_pair_fold"][0]
    fold.update(zip(("bound_ms", "bound_by"), bound(5 * cells * 4 + 2 * 21 * 4 + F * 17,
                                                   cells + 2 * F * WIDE_MAX_BIN * 60)))
    step_scan = steps_t["unpooled"]["split_pair_step"]
    step_scan.update(zip(("bound_ms", "bound_by"), bound(cells * 4 + 21 * 4 + F * 17,
                                                        F * WIDE_MAX_BIN * 60)))
    pick = steps_t["unpooled"]["pick_partition"][0]
    pick.update(zip(("bound_ms", "bound_by"), bound(g_w.config.num_leaves * 4 + 320 + N * 10, 0)))
    ppick = steps_t["pooled"]["pick_partition"][0]
    ppick.update(zip(("bound_ms", "bound_by"), bound(
        g_w.config.num_leaves * 4 + 320 + N * 10 + (g_w.config.num_leaves + 2 * WIDE_POOL_SLOTS) * 8, 0)))
    pfold = steps_t["pooled"]["split_pair_fold"][0]
    pfold.update(zip(("bound_ms", "bound_by"), bound(6 * cells * 4 + 2 * 21 * 4 + F * 17,
                                                    cells + 2 * F * WIDE_MAX_BIN * 60)))
    rows = [
        row("histogram_wide", "histogram.cu", hist_rep, main_l.get("histogram_wide", 0), root_t,
            root_t["library_ms"]),
        row("histogram_segment_wide", "histogram.cu", hist_rep,
            main_l.get("histogram_segment_wide", 0), seg,
            hist_t["%d_float32_segment" % WIDE_MAX_BIN]["library_ms"]),
        row("split_pair_step_rows1024", "split_pair.cu", split_rep,
            main_l.get("split_pair_step_rows1024", 0), step_scan),
        row("split_pair_fold_rows1024", "split_pair.cu", split_rep,
            main_l.get("split_pair_fold_rows1024", 0), fold),
        row("pick_partition_wide", "partition.cu", "lightgbm_tpu/ops/grow.py:439,1277",
            main_l.get("pick_partition_wide", 0), pick),
        row("predict_bins_wide", "predict_bins.cu", "lightgbm_tpu/ops/predict.py:85",
            main_l.get("predict_bins_wide", 0), predict_t),
        row("pick_partition_wide_categorical", "partition.cu", "lightgbm_tpu/ops/grow.py:284,1287",
            cat_launches.get("pick_partition_wide", 0), cat_pick_t),
        row("predict_bins_wide_categorical", "predict_bins.cu", "lightgbm_tpu/ops/predict.py:113",
            cat_launches.get("predict_bins_wide", 0), cat_predict_t),
        row("split_pair_rows1024_categorical", "split_pair.cu",
            "lightgbm_tpu/ops/split.py:325 (the categorical scan; XLA there)",
            cat_launches.get("split_pair_fold_rows1024", 0), split_t["categorical"]),
        row("pick_partition_wide_pool", "partition.cu",
            "lightgbm_tpu/ops/grow.py:1479-1536 (HistogramPool::Get; XLA there)",
            pool_l.get("pick_partition_wide_pool", 0), ppick),
        row("split_pair_fold_rows1024_pool", "split_pair.cu",
            "lightgbm_tpu/ops/grow.py:1484-1536 (the pooled subtraction; XLA there)",
            pool_l.get("split_pair_fold_rows1024_pool", 0), pfold),
    ]
    return rec, rows


FORCED_JSON = {  # three levels on features 0-6, BFS: 0 | 1, 2 | 3, 4, 5, 6
    "feature": 0, "threshold": 0.0,
    "left": {"feature": 1, "threshold": 0.0,
             "left": {"feature": 3, "threshold": 0.0}, "right": {"feature": 4, "threshold": 0.0}},
    "right": {"feature": 2, "threshold": 0.0,
              "left": {"feature": 5, "threshold": 0.0}, "right": {"feature": 6, "threshold": 0.0}},
}
# the left child's forced split puts every row of it on one side: invalid, the
# preamble aborts there and the right child's is skipped
FORCED_ABORT_JSON = {"feature": 0, "threshold": 0.0, "left": {"feature": 0, "threshold": 0.5},
                     "right": {"feature": 2, "threshold": 0.0}}
CEGB_PARAMS = {"cegb_penalty_split": 1e-4, "cegb_penalty_feature_coupled": [300.0] * FEATURES,
               "cegb_penalty_feature_lazy": [1e-4] * FEATURES}
CEGB_EQUAL_ROWS = 100_000


def forced_cegb_phase(lgb, dev, ctx):
    """Forced splits and CEGB on the card (phase 8e of the
    module docstring). ``ctx`` carries main's ``counted``, ``profiled``,
    ``time_ms``, ``X``, ``y``, the main path's ``train_set`` and phase 4's
    ``booster``, ``dyadic_gradients`` (the binary objective rounded to
    2^-7) and ``card``. Returns (the phase's record, each new kernel's row
    of the kernels line)."""
    import numpy as np
    import torch

    from lightgbm_tpu_torch import objective as objective_mod
    from lightgbm_tpu_torch.bench import train_iterations
    from lightgbm_tpu_torch.ops import grow as grow_mod
    from lightgbm_tpu_torch.ops import grow_state as gs
    from lightgbm_tpu_torch.ops import grow_step as grow_step_plain
    from lightgbm_tpu_torch.ops import grow_step_kernel, hist_kernel, partition_kernel
    from lightgbm_tpu_torch.ops import partition as partition_plain
    from lightgbm_tpu_torch.ops import split as split_plain
    from lightgbm_tpu_torch.ops import split_kernel
    from lightgbm_tpu_torch.ops.histogram import segment_histogram

    counted, profiled, time_ms = ctx.counted, ctx.profiled, ctx.time_ms
    X, y = ctx.X, ctx.y
    N, F = X.shape
    rec = {"card": ctx.card}
    workdir = tempfile.mkdtemp(prefix="lgbt-forced-")
    forced_path = os.path.join(workdir, "forced.json")
    abort_path = os.path.join(workdir, "abort.json")
    with open(forced_path, "w") as fh:
        json.dump(FORCED_JSON, fh)
    with open(abort_path, "w") as fh:
        json.dump(FORCED_ABORT_JSON, fh)
    chunked = dict(TRAIN_PARAMS, device_chunk_size=10)
    forced_params = dict(chunked, forcedsplits_filename=forced_path)
    cegb_params = dict(chunked, **CEGB_PARAMS)

    # ---- the main path's table: forced, CEGB; captured, chunks of 10 -----------------
    runs = {}
    for name, params, iters in (("forced", forced_params, 10), ("cegb", cegb_params, 10)):
        bst, secs, got = counted(lambda: lgb.train(dict(params), ctx.train_set, iters))
        g = bst._gbdt
        assert g.grow_loop == "device" and g.captures == 1, (name, g.grow_loop, g.captures)
        (_, _, auc, _), = bst.eval_train()
        assert auc > 0.7, (name, auc)
        runs[name] = dict(booster=bst, seconds=secs, launches=got, auc=auc,
                          ms_per_tree=secs / iters * 1e3,
                          leaves=[t.num_leaves for t in g.trees()])
    g_f, g_c = runs["forced"]["booster"]._gbdt, runs["cegb"]["booster"]._gbdt
    assert len(g_f._forced_splits) == 7, g_f._forced_splits
    for ta in g_f._tree_arrays:  # the 7 forced nodes open every tree, in BFS order
        assert ta.split_feature[:7].tolist() == [0, 1, 2, 3, 4, 5, 6], ta.split_feature[:7]
        assert ta.threshold_bin[:7].tolist() == [t for _, _, t in g_f._forced_splits]
    assert runs["forced"]["launches"].get("forced_record", 0) == 70
    assert runs["forced"]["launches"].get("pick_partition_ext", 0) > 0

    def distinct(bst):
        return sorted({int(f) for t in bst._gbdt.trees() for f in t.split_feature[:t.num_leaves - 1]})
    used_free, used_cegb = distinct(ctx.booster), distinct(runs["cegb"]["booster"])
    assert len(used_cegb) < len(used_free), (used_cegb, used_free)
    assert set(used_cegb) == set(np.flatnonzero(g_c._cegb.feature_used.cpu().numpy()))
    for k in ("split_pair_step_cegb", "split_pair_fold_cegb", "split_pair_all", "cegb_lazy",
              "pick_partition_ext"):
        assert runs["cegb"]["launches"].get(k, 0) > 0, (k, runs["cegb"]["launches"])

    # ---- 100k rows, gradients rounded to 2^-7: replays and chunks = eager -------------
    small = lgb.Dataset(X[:CEGB_EQUAL_ROWS], label=y[:CEGB_EQUAL_ROWS])
    params = dict(TRAIN_PARAMS, forcedsplits_filename=abort_path, **CEGB_PARAMS)
    objective_mod.BinaryLogloss.get_gradients = ctx.dyadic_gradients
    try:
        out = []
        for graph, chunk in ((True, 1), (False, 1), (True, 4)):
            b_ = lgb.Booster(dict(params, device_chunk_size=chunk), small)
            b_._gbdt.iteration_graph = graph
            assert train_iterations(b_, 8, chunk) == 8
            g_ = b_._gbdt
            state = (g_._cegb.feature_used.cpu(), g_._cegb.used_in_data.cpu())
            out.append((b_.model_to_string().split("parameters:")[0], g_.train_score(), state))
        for o in out[1:]:
            assert o[0] == out[0][0] and np.array_equal(o[1], out[0][1])
            assert all(torch.equal(a, b) for a, b in zip(o[2], out[0][2]))
        assert int(g_._grow_state.ctl[gs.ABORT]) == 1
        assert all(t.split_feature[0] == 0 for t in g_.trees())
        equal = {"forced_cegb": dict(rows=CEGB_EQUAL_ROWS, iterations=8, equal=True)}
    finally:
        objective_mod.BinaryLogloss.get_gradients = ctx.get_gradients

    # ---- one eager tree at 1M on dyadic values: each new kernel held and timed -------
    c = gs.Cegb(split_plain.CegbParams(1.0, CEGB_PARAMS["cegb_penalty_split"], True, True), F, N,
                np.asarray(CEGB_PARAMS["cegb_penalty_feature_coupled"]),
                np.asarray(CEGB_PARAMS["cegb_penalty_feature_lazy"]), dev)
    M, B = g_f.config.num_leaves, g_f.num_bins
    s = gs.GrowState(dev, N, F, B, M, 0, 0, 0, 0, cegb=True)
    dy = ctx.dyq_vals
    grow_mod.start_tree(s, g_f.bins_dev, dy[:, 0].contiguous(), dy[:, 1].contiguous(),
                        g_f.feature_mask, g_f.feature_meta, -1, g_f.split_params, g_f._two_way,
                        g_f.bins_nf, forced=g_f._forced_dev, cegb=c)

    def same(a, b, what):
        same_state(a, b, what)
        assert torch.equal(a.cegb.feature_used, b.cegb.feature_used), what
        assert torch.equal(a.cegb.used_in_data, b.cegb.used_in_data), what

    def held(name, kernel, plain, timed=True):
        """``kernel`` on ``s`` against ``plain`` on a copy (the whole state and
        the paid features and rows equal), then both timed from that state,
        which is left as the kernel made it."""
        before, other = s.clone(), s.clone()
        kernel(s)
        plain(other)
        same(s, other, name)
        if not timed:
            return None
        after, copy = s.clone(), before.clone()

        def back(dst, src):
            restore(dst, src)
            dst.cegb.feature_used.copy_(src.cegb.feature_used)
            dst.cegb.used_in_data.copy_(src.cegb.used_in_data)
        t = dict(ms=time_ms(lambda: kernel(s), setup=lambda: back(s, before)),
                 plain_ms=time_ms(lambda: plain(copy), reps=3, setup=lambda: back(copy, before)),
                 max_abs_err=0.0, library_ms=None)
        back(s, after)
        return t

    cells = F * B * 3
    kt = {}
    kt["cegb_lazy_root"] = held("cegb_lazy_root", lambda st: grow_step_kernel.cegb_lazy(st, True),
                                lambda st: grow_step_plain.cegb_lazy(st, True))
    kt["cegb_lazy_root"].update(zip(("bound_ms", "bound_by"), bound(N * (4 + F) + F * 4, N * F)))
    kt["split_pair_step_cegb"] = held("split_pair_step_cegb",
                                      lambda st: split_kernel.split_pair_step(st, 1),
                                      lambda st: split_plain.split_pair_step(st, 1))
    kt["split_pair_step_cegb"].update(zip(("bound_ms", "bound_by"), bound(
        cells * 4 + 21 * 4 + F * 17 + F * 13, F * B * 60)))
    K = len(g_f._forced_splits)
    all_t, step = None, 0
    for step in range(K + M - 1):
        p, k = step % 2, (step if step < K else None)
        first = step == 0
        if k is not None:
            t = held("forced_record", lambda st: split_kernel.forced_record(st, k),
                     lambda st: split_plain.forced_record(st, k), timed=first)
            if first:
                kt["forced_record"] = t
                t.update(zip(("bound_ms", "bound_by"), bound(B * 12 + 60 + 64, B * 3)))
        t = held("pick_partition_ext", lambda st: partition_kernel.pick_partition(st, k is not None),
                 lambda st: (grow_step_plain.pick(st, k is not None), partition_plain.partition(st)),
                 timed=first)
        if first:
            kt["pick_partition_ext"] = t
            t.update(zip(("bound_ms", "bound_by"), bound(M * 4 + 320 + N * 10 + 64, 0)))
        assert int(s.ctl[gs.ACTIVE]), step
        n_seg = int(s.ctl[gs.PCOUNT])
        t = held("cegb_lazy", grow_step_kernel.cegb_lazy, grow_step_plain.cegb_lazy, timed=first)
        if first:
            kt["cegb_lazy"] = t
            t.update(zip(("bound_ms", "bound_by"), bound(n_seg * (4 + 4 + F) + 2 * F * 4,
                                                         n_seg * F)))
        hist_kernel.histogram_segment(s, p)
        t = held("split_pair_fold_cegb", lambda st: split_kernel.split_pair_fold(st, p),
                 lambda st: grow_step_plain.split_pair_fold(st, p), timed=first)
        if first:
            kt["split_pair_fold_cegb"] = t
            t.update(zip(("bound_ms", "bound_by"), bound(5 * cells * 4 + 2 * 21 * 4 + F * 30,
                                                         cells + 2 * F * B * 60)))
        nl = int(s.ctl[gs.NUM_LEAVES])
        # timed at the first payment with at least 8 leaves (else the latest before it)
        paid_first = int(s.ctl[gs.NEWLY]) and nl > 2
        t = held("split_pair_all", split_kernel.split_pair_all, split_plain.split_pair_all,
                 timed=paid_first and (all_t is None or all_t["leaves"] < 8))
        if t is not None:
            all_t = t
            t.update(zip(("bound_ms", "bound_by"), bound(
                (nl - 2) * (cells * 4 + 21 * 4 + F * 13), (nl - 2) * F * B * 60)), leaves=nl,
                step=step)
        if all_t is not None and all_t["leaves"] >= 8 and step >= K + 16 or step >= K + 48:
            break
    assert all_t is not None, "no step paid a coupled feature first past the root"
    kt["split_pair_all"] = all_t
    assert s.node_i[:K, 0].tolist() == [f for _, f, _ in g_f._forced_splits]
    del s, c

    # ---- turns: the main path and the CEGB booster, chunks of 10; a profiled chunk ----
    boosters = {}
    for kind, params in (("main", chunked), ("cegb", cegb_params)):
        b_ = lgb.Booster(dict(params), ctx.train_set)
        assert train_iterations(b_, 10, 10) == 10
        boosters[kind] = b_
    ips = {k: [] for k in boosters}
    per_iter = {}
    for kind in ("main", "cegb", "cegb", "main"):
        ran, secs, got = counted(lambda: train_iterations(boosters[kind], 10, 10))
        assert ran == 10, (kind, ran)
        ips[kind].append(10 / secs)
        per_iter.setdefault(kind, {k_: v_ / 10 for k_, v_ in got.items()})
    prof = {}
    for kind, b_ in boosters.items():
        busy, kernels, copies, timeline, named = profiled(lambda b2=b_: b2.update_chunk(10))
        prof[kind] = dict(
            device_busy_ms_per_iteration=busy / 10, copies=copies,
            kernels_per_iteration=timeline["kernels"] / 10 if isinstance(timeline, dict)
            else "not measured",
            kernels_ms_per_iteration={k_: [v_[0] / 10, v_[1] / 10] for k_, v_ in named.items()},
            device_idle_share=[1 - busy / 10 * v / 1e3 for v in ips[kind]] if busy
            else "not measured")
    del boosters

    rec.update(
        trainings={k: {k_: v_ for k_, v_ in r.items() if k_ != "booster"} for k, r in runs.items()},
        distinct_features=dict(main=used_free, cegb=used_cegb), equal=equal, kernels=kt,
        iterations_per_s=ips, launches_per_iteration=per_iter, profile=prof)

    # ---- the kernels line's rows -----------------------------------------------------------
    src = "lightgbm_tpu_torch/csrc/"
    lf, lc = runs["forced"]["launches"], runs["cegb"]["launches"]

    def row(name, source, replaces, launches, t):
        return dict(name=name, route="cuda", source=src + source, replaces=replaces,
                    launches=launches, max_abs_err=t["max_abs_err"], ms=t["ms"],
                    plain_ms=t["plain_ms"], bound_ms=t["bound_ms"], bound_by=t["bound_by"],
                    library_ms=t["library_ms"])
    rows = [
        row("forced_record", "split_pair.cu",
            "lightgbm_tpu/ops/split.py:519 (gather_info_for_threshold; XLA there)",
            lf.get("forced_record", 0), kt["forced_record"]),
        row("pick_partition_ext", "partition.cu",
            "lightgbm_tpu/ops/grow.py:1600-1637,1392 (the forced preamble, feature_used; XLA there)",
            lf.get("pick_partition_ext", 0) + lc.get("pick_partition_ext", 0),
            kt["pick_partition_ext"]),
        row("split_pair_step_cegb", "split_pair.cu",
            "lightgbm_tpu/ops/split.py:649 (the penalised argmax; XLA there)",
            lc.get("split_pair_step_cegb", 0), kt["split_pair_step_cegb"]),
        row("split_pair_fold_cegb", "split_pair.cu",
            "lightgbm_tpu/ops/split.py:649 (the penalised argmax; XLA there)",
            lc.get("split_pair_fold_cegb", 0), kt["split_pair_fold_cegb"]),
        row("split_pair_all", "split_pair.cu",
            "lightgbm_tpu/ops/grow.py:1022 (rescan_all; XLA there)",
            lc.get("split_pair_all", 0), kt["split_pair_all"]),
        row("cegb_lazy", "grow_step.cu",
            "lightgbm_tpu/ops/grow.py:1392-1420 (lazy bookkeeping; XLA there)",
            lc.get("cegb_lazy", 0), kt["cegb_lazy"]),
    ]
    return rec, rows


EFB_WIDE_MAX_BIN = 1024  # sparse Covertype binned wide: its continuous columns pass 256 bins
EFB_WIDE_ITERATIONS = 5
FLIGHT_POOL_MB = 64  # about 31 slots of 674 x 255 x 3 x 4 = 2,062,440 bytes, against 255 leaves
CEGB_POOL_MB = 4  # 48 slots of 28 x 255 x 3 x 4 = 85,680 bytes
EFB_POOL_EQUAL_ROWS = 100_000  # replays = eager on gradients rounded to 2^-7
EAGER_CEGB = {"split": 1e-7, "coupled": 3.0, "lazy": 1e-7}  # 8f's held CEGB tree's penalties


def bundled_wide_pooled_phase(lgb, dev, ctx):
    """EFB groups past 256 bins, the pool with EFB and CEGB with the pool on
    the card (phase 8f of the module docstring). ``ctx`` carries main's
    ``counted``, ``time_ms``, ``X``, ``y``, the main path's ``train_set``,
    4h's Covertype CSR rows (``cover``: X, y, held-out X, y), 4i's Flight
    Dataset (``flight_set``), ``dyq_vals``, ``dyadic_gradients``,
    ``get_gradients`` and ``card``. Returns (the phase's record, each new
    instantiation's row of the kernels line)."""
    import numpy as np
    import torch

    from lightgbm_tpu_torch import objective as objective_mod
    from lightgbm_tpu_torch.bench import (
        COVER_PARAMS, FLIGHT_PARAMS, flight_like_rows, train_iterations,
    )
    from lightgbm_tpu_torch.ops import grow as grow_mod
    from lightgbm_tpu_torch.ops import grow_state as gs
    from lightgbm_tpu_torch.ops import grow_step as grow_step_plain
    from lightgbm_tpu_torch.ops import grow_step_kernel, hist_kernel, partition_kernel
    from lightgbm_tpu_torch.ops import predict as predict_plain
    from lightgbm_tpu_torch.ops import predict_kernel, remap_kernel
    from lightgbm_tpu_torch.ops import remap as remap_plain
    from lightgbm_tpu_torch.ops import split as split_plain
    from lightgbm_tpu_torch.ops import split_kernel

    counted, time_ms = ctx.counted, ctx.time_ms
    rec = {"card": ctx.card}
    cX, cy, cXv, cyv = ctx.cover
    cover_params = dict({k: v for k, v in COVER_PARAMS.items() if k != "enable_bundle"},
                        max_bin=EFB_WIDE_MAX_BIN)
    flight_params = dict(FLIGHT_PARAMS, histogram_pool_size=FLIGHT_POOL_MB)
    cegb_params = dict(TRAIN_PARAMS, device_chunk_size=10, histogram_pool_size=CEGB_POOL_MB,
                       **CEGB_PARAMS)

    # ---- three trainings through the captured loop, at full width ------------------------
    t0 = time.perf_counter()
    c_set = lgb.Dataset(cX, label=cy)
    c_valid = lgb.Dataset(cXv, label=cyv, reference=c_set)
    c_evals = {}
    cbst, c_s, c_l = counted(lambda: lgb.train(
        dict(cover_params), c_set, EFB_WIDE_ITERATIONS, valid_sets=[c_valid],
        evals_result=c_evals, verbose_eval=False))
    c_total_s = time.perf_counter() - t0
    gc_ = cbst._gbdt
    assert gc_.grow_loop == "device" and gc_.captures == 1 and gc_.num_groups > 0, gc_.captures
    assert gc_.hist_width > 256 and gc_.bins_dev.dtype == torch.int16, gc_.hist_width
    assert cbst.num_trees() == 7 * EFB_WIDE_ITERATIONS
    for k in ("pick_partition_wide_efb", "efb_remap_wide", "predict_bins_wide_efb"):
        assert c_l.get(k, 0) > 0, (k, c_l)
    c_err = c_evals["valid_0"]["multi_error"]
    prior = np.bincount(cy.astype(np.int64), minlength=7) / len(cy)
    assert min(c_err) < prior.max(), (c_err, prior)

    fbst, f_s, f_l = counted(lambda: lgb.train(dict(flight_params), ctx.flight_set,
                                               EFB_WIDE_ITERATIONS))
    gf_ = fbst._gbdt
    slots = gf_.hist_pool_slots
    print("pooled Flight: %s slots of %d bytes for %d leaves (%d features, %d groups)"
          % (slots, gf_.train_set.num_features * gf_.num_bins * 12, gf_.config.num_leaves,
             gf_.train_set.num_features, gf_.num_groups), flush=True)
    assert gf_.grow_loop == "device" and gf_.captures == 1 and slots is not None and slots < 255
    for k in ("pick_partition_pool_efb", "efb_remap_large", "split_pair_fold_pool"):
        assert f_l.get(k, 0) > 0, (k, f_l)
    (_, _, f_auc, _), = [r for r in fbst.eval_train() if r[1] == "auc"]
    assert f_auc > 0.7, f_auc

    pbst, p_s, p_l = counted(lambda: lgb.train(dict(cegb_params), ctx.train_set, 10))
    gp_ = pbst._gbdt
    assert gp_.grow_loop == "device" and gp_.captures == 1 and gp_.hist_pool_slots == 48, (
        gp_.hist_pool_slots)
    for k in ("split_pair_fold_pool", "split_pair_all_pool", "pick_partition_pool_ext",
              "cegb_lazy"):
        assert p_l.get(k, 0) > 0, (k, p_l)
    (_, _, p_auc, _), = pbst.eval_train()
    assert p_auc > 0.7, p_auc
    rec["trainings"] = {
        "sparse_covertype_wide": dict(rows=len(cy), max_bin=EFB_WIDE_MAX_BIN,
                                      groups=gc_.num_groups, max_group_bins=gc_.hist_width,
                                      seconds_with_binning=c_total_s, train_s=c_s,
                                      valid_multi_error=c_err, launches=c_l),
        "flight_pooled": dict(pool_mb=FLIGHT_POOL_MB, slots=slots, train_s=f_s, auc=f_auc,
                              launches=f_l, unpooled_hist_bytes=gf_.train_set.num_features
                              * gf_.num_bins * 12 * gf_.config.num_leaves),
        "cegb_pooled": dict(pool_mb=CEGB_POOL_MB, slots=gp_.hist_pool_slots, train_s=p_s,
                            auc=p_auc, launches=p_l),
    }

    # ---- 100k rows, gradients rounded to 2^-7: replays = eager ------------------------------
    objective_mod.BinaryLogloss.get_gradients = ctx.dyadic_gradients
    try:
        n = EFB_POOL_EQUAL_ROWS
        equal = {}
        sX, sy = flight_like_rows(n, seed=43)
        small_sets = {  # binary labels, so that the rounded gradients apply
            "sparse_covertype_wide": (lgb.Dataset(cX[:n], label=(cy[:n] == 1).astype(np.float64)),
                                      dict(TRAIN_PARAMS, max_bin=EFB_WIDE_MAX_BIN)),
            "flight_pooled": (lgb.Dataset(sX, label=sy), dict(FLIGHT_PARAMS, histogram_pool_size=8)),
            "cegb_pooled": (lgb.Dataset(ctx.X[:n], label=ctx.y[:n]),
                            dict(TRAIN_PARAMS, histogram_pool_size=CEGB_POOL_MB, **CEGB_PARAMS)),
        }
        for name, (ds, params) in small_sets.items():
            out = []
            for graph in (True, False):
                b_ = lgb.Booster(dict(params), ds)
                b_._gbdt.iteration_graph = graph
                assert train_iterations(b_, 4, 1) == 4
                out.append((b_.model_to_string().split("parameters:")[0], b_._gbdt.train_score()))
            assert out[0][0] == out[1][0] and np.array_equal(out[0][1], out[1][1]), name
            assert b_._gbdt.num_groups > 0 or name == "cegb_pooled", name
            assert (b_._gbdt.hist_pool_slots is not None) == (name != "sparse_covertype_wide"), name
            equal[name] = dict(rows=n, iterations=4, equal=True, groups=b_._gbdt.num_groups,
                               hist_width=b_._gbdt.hist_width, slots=b_._gbdt.hist_pool_slots)
    finally:
        objective_mod.BinaryLogloss.get_gradients = ctx.get_gradients
    rec["replays_equal_eager"] = equal

    # ---- one eager tree each, dyadic values: every new instantiation held every step ----
    def held(s, name, kernel, plain, timed):
        """``kernel`` on ``s`` against ``plain`` on a copy (the whole state and
        any CEGB state equal), then, when ``timed``, both timed from that
        state, which is left as the kernel made it."""
        before, other = s.clone(), s.clone()
        kernel(s)
        plain(other)
        same_state(s, other, name)
        if s.cegb is not None:
            assert torch.equal(s.cegb.feature_used, other.cegb.feature_used), name
            assert torch.equal(s.cegb.used_in_data, other.cegb.used_in_data), name
        if not timed:
            return None
        after = s.clone()
        t = timing(s, before, kernel, plain)
        back(s, after)
        return t

    def back(dst, src):
        restore(dst, src)
        if dst.cegb is not None:
            dst.cegb.feature_used.copy_(src.cegb.feature_used)
            dst.cegb.used_in_data.copy_(src.cegb.used_in_data)

    def timing(s, before, kernel, plain):
        """``kernel`` on ``s`` and ``plain`` on a copy timed, each run from
        the state ``before``; ``s`` is left as a run made it."""
        copy = before.clone()
        return dict(ms=time_ms(lambda: kernel(s), setup=lambda: back(s, before)),
                    plain_ms=time_ms(lambda: plain(copy), reps=3, setup=lambda: back(copy, before)),
                    max_abs_err=0.0, library_ms=None, step=int(before.ctl[gs.STEP]) - 1)

    def tree_of(g, P, cegb=None):
        """A state of the training ``g``'s shape (``P`` pool slots) with its
        root queued on the dyadic values."""
        N_ = g.num_data
        s = gs.GrowState(dev, N_, g.train_set.num_features, g.num_bins, g.config.num_leaves,
                         g.num_words, g.num_groups, g.hist_width, P, cegb=cegb is not None)
        dy = ctx.dyq_vals[:N_]
        grow_mod.start_tree(s, g.bins_dev, dy[:, 0].contiguous(), dy[:, 1].contiguous(),
                            g.feature_mask, g.feature_meta, -1, g.split_params, g._two_way,
                            g.bins_nf, "float32", None, g.grouped_adds, cegb=cegb)
        return s

    kt, checked = {}, {}

    def grow(s, holds):
        """Every step of the state's tree, kernel by kernel; ``holds`` names
        the kernels held at every step, each timed at the first step its
        ``when(state)`` accepts (the pick's name in ``holds`` starts with
        ``pick``; any other pick runs unheld)."""
        for step in range(s.M - 1):
            p = step % 2
            pick = [k for k in holds if k.startswith("pick")]
            if pick:
                kernel, plain, when = holds[pick[0]]
                t = held(s, pick[0], kernel(p), plain(p), pick[0] not in kt and when(s))
                if t is not None:
                    kt[pick[0]] = t
                checked[pick[0]] = checked.get(pick[0], 0) + 1
            else:
                partition_kernel.pick_partition(s)
            if not int(s.ctl[gs.ACTIVE]):
                break
            rows_ = int(s.ctl[gs.PCOUNT])
            if s.cegb is not None and s.cegb.used_in_data is not None:
                grow_step_kernel.cegb_lazy(s)
            hist_kernel.histogram_segment(s, p)
            if s.P:
                hist_kernel.histogram_segment(s, p, large=True)
            stages = [("efb_remap" + ("_wide" if s.B > 256 else ""), lambda q: (
                lambda st: remap_kernel.remap_step(st, q)), None)] if s.G else []
            if s.G and s.P:
                stages.append(("efb_remap_large", lambda q: (
                    lambda st: remap_kernel.remap_large(st, q)), None))
            stages.append(("split_pair_fold" + ("_pool" if s.P else "")
                           + ("_cegb" if s.cegb is not None and not s.pooled_rescan else ""),
                           lambda q: (lambda st: split_kernel.split_pair_fold(st, q)), None))
            if s.rescans_all:
                stages.append(("split_pair_all" + ("_pool" if s.P else ""),
                               lambda q: split_kernel.split_pair_all, None))
            for name, kernel, _ in stages:
                if name in holds:
                    _, plain, when = holds[name]
                    t = held(s, name, kernel(p), plain(p), name not in kt and when(s))
                    if t is not None:
                        kt[name] = t
                        t["rows"] = rows_
                        if s.P:
                            t["resident"] = resident_others(s)
                    checked[name] = checked.get(name, 0) + 1
                else:
                    kernel(p)(s)

    def resident_others(s):
        """The leaves resident in the pool, but the step's two children."""
        nl = int(s.ctl[gs.NUM_LEAVES])
        return int(((s.slot_leaf >= 0) & (s.slot_leaf < nl) & (s.slot_age > 0)).sum()) - 2

    def first(s):
        return True

    # sparse Covertype at max_bin 1024: the int16 bundled pick and the wide remap
    s = tree_of(gc_, 0)
    grow(s, {
        "pick_partition_wide_efb": (lambda p: partition_kernel.pick_partition,
                                    lambda p: plain_pick_partition, first),
        "efb_remap_wide": (lambda p: (lambda st: remap_kernel.remap_step(st, p)),
                           lambda p: (lambda st: remap_plain.remap_step(st, p)), first),
    })
    Fc, Gc, Bgc, Bc = s.F, s.G, s.Bg, s.B
    # the int16 bundled predict over the held-out rows, through this tree
    vb = gc_._valid_bins[0]
    pv_args = (vb, s.node_i[:s.M - 1], s.ctl[gs.NUM_LEAVES:gs.NUM_LEAVES + 1], gc_.feature_meta,
               s.leaf_f[:, 0].contiguous())
    nv = vb.shape[0]
    pk_, pp_ = torch.zeros(nv, device=dev), torch.zeros(nv, device=dev)
    leaf_k = torch.empty(nv, dtype=torch.int32, device=dev)
    leaf_p = torch.empty(nv, dtype=torch.int32, device=dev)
    predict_kernel.add_tree_value(*pv_args, pk_, leaf_k)
    predict_plain.add_tree_value(*pv_args, pp_, leaf_p)
    assert torch.equal(pk_, pp_) and torch.equal(leaf_k, leaf_p), "predict_bins_wide_efb != plain"
    depth = float(s.leaf_i[leaf_k.long(), 1].double().mean())
    staged = (int(s.ctl[gs.NUM_LEAVES]) - 1) * 20
    kt["predict_bins_wide_efb"] = dict(
        ms=time_ms(lambda: predict_kernel.add_tree_value(*pv_args, pk_)),
        plain_ms=time_ms(lambda: predict_plain.add_tree_value(*pv_args, pp_), reps=3),
        max_abs_err=0.0, library_ms=None, rows=nv, mean_depth=depth, staged_bytes=staged)
    kt["predict_bins_wide_efb"].update(zip(("bound_ms", "bound_by"),
                                           bound(nv * (8 + 2 * depth) + staged, 0)))
    checked["predict_bins_wide_efb"] = 1
    root_rows = gc_.num_data
    kt["pick_partition_wide_efb"].update(zip(("bound_ms", "bound_by"), bound(
        s.M * 4 + 24 * Fc + 32 + root_rows * 10, 0)))
    kt["efb_remap_wide"].update(zip(("bound_ms", "bound_by"), bound(
        2 * Gc * Bgc * 12 + Fc * Bc * 12 + 16 * Fc + 20, Fc * remap_plain.WIDE_SLOTS * 3)))
    c_leaves = int(s.ctl[gs.NUM_LEAVES])
    assert c_leaves > 2, c_leaves
    del s

    # Flight-shaped, pooled: the pooled bundled pick and the larger child's remap
    s = tree_of(gf_, slots)
    grow(s, {
        "pick_partition_pool_efb": (lambda p: partition_kernel.pick_partition,
                                    lambda p: plain_pick_partition, first),
        "efb_remap_large": (lambda p: (lambda st: remap_kernel.remap_large(st, p)),
                            lambda p: (lambda st: remap_plain.remap_large(st, p)),
                            lambda st: int(st.pool_ctl[gs.RUN]) == 1),
    })
    Ff, Gf, Bgf, Bf = s.F, s.G, s.Bg, s.B
    assert "efb_remap_large" in kt, "no step of the pooled Flight tree missed the pool"
    kt["pick_partition_pool_efb"].update(zip(("bound_ms", "bound_by"), bound(
        s.M * 4 + 24 * Ff + 32 + gf_.num_data * 9 + 4 * (s.M + 2 * s.P), 0)))
    kt["efb_remap_large"].update(zip(("bound_ms", "bound_by"), bound(
        2 * Gf * Bgf * 12 + Ff * Bf * 12 + 16 * Ff + 20 + 64, Ff * remap_plain.SLOTS * 3)))
    f_leaves = int(s.ctl[gs.NUM_LEAVES])
    assert f_leaves > s.P, (f_leaves, s.P)  # the tree grew past the pool's slots
    del s

    # the main path with CEGB under a pool: the pooled fold and the pooled all-leaves scan;
    # the tree's dyadic values are random, so its gains are noise of order 10, and the
    # training's penalties (a split and a lazy one of 1e-4 a row: 100 at the root's 1M
    # rows; a coupled one of 300) would stop it at the root: smaller ones pay features
    # all through the tree, evictions included
    Fp_ = gp_.train_set.num_features
    c = gs.Cegb(split_plain.CegbParams(1.0, EAGER_CEGB["split"], True, True), Fp_, gp_.num_data,
                np.full(Fp_, EAGER_CEGB["coupled"]), np.full(Fp_, EAGER_CEGB["lazy"]), dev)
    s = tree_of(gp_, gp_.hist_pool_slots, c)  # the root's lazy pass and penalised scan queued
    patches, saved = [], {}

    def plain_all(st):
        patches.append(split_plain.split_pair_all(st))

    def save_all_states(st):
        """Keep copies of the state before the pooled all-leaves launch of
        the first ordinary step past the root (the children alone), of the
        first payment with the most other resident leaves, and of the first
        step with the most resident leaves of all (``full_pool``, timed
        with ctl[NEWLY] set by hand: the launch's most work). Nothing is
        timed during the tree."""
        if int(st.ctl[gs.NUM_LEAVES]) <= 2:
            return False
        others = resident_others(st)
        kind = "payment" if int(st.ctl[gs.NEWLY]) else "children"
        if kind not in saved or (kind == "payment" and others > saved[kind][0]):
            saved[kind] = (others, st.clone())
        if others > saved.get("full_pool", (-1,))[0]:
            saved["full_pool"] = (others, st.clone())
            saved["full_pool"][1].ctl[gs.NEWLY] = 1
        return False

    grow(s, {
        "split_pair_fold_pool": (lambda p: (lambda st: split_kernel.split_pair_fold(st, p)),
                                 lambda p: (lambda st: grow_step_plain.split_pair_fold(st, p)),
                                 lambda st: False),
        "split_pair_all_pool": (lambda p: split_kernel.split_pair_all, lambda p: plain_all,
                                save_all_states),
    })
    Fp, Bp = s.F, s.B
    cells = Fp * Bp * 3
    p_leaves = int(s.ctl[gs.NUM_LEAVES])
    assert p_leaves > s.P, (p_leaves, s.P)  # the tree grew past the pool's slots
    assert set(saved) == {"children", "payment", "full_pool"}, sorted(saved)
    all_pool = {}
    for kind, (others, st) in saved.items():
        t = timing(st, st.clone(), split_kernel.split_pair_all, split_plain.split_pair_all)
        scanned = others + 2 if kind != "children" else 2  # and the step's children
        t.update(resident=others, scanned_leaves=scanned, leaves=int(st.ctl[gs.NUM_LEAVES]))
        t.update(zip(("bound_ms", "bound_by"), bound(
            scanned * (cells * 4 + 21 * 4 + Fp * 13) + 4 * (s.M + 2 * s.P),
            scanned * Fp * Bp * 60)))
        all_pool[kind] = t
    print("split_pair_all_pool: " + ", ".join(
        "%s %.4f ms (%d leaves scanned, bound %.4f)" % (k, v["ms"], v["scanned_leaves"],
                                                          v["bound_ms"])
        for k, v in sorted(all_pool.items())), flush=True)
    kt["split_pair_all_pool"] = all_pool["payment"]
    rec["split_pair_all_pool"] = all_pool
    del s, c, saved
    rec.update(eager_trees=dict(leaves=dict(sparse_covertype_wide=c_leaves, flight_pooled=f_leaves,
                                            cegb_pooled=p_leaves),
                                held_every_step=checked, patched_records=sum(patches)),
               kernels=kt)

    # ---- the kernels line's rows -----------------------------------------------------------
    src = "lightgbm_tpu_torch/csrc/"
    rows = []
    for name, source, replaces, launches in (
        ("pick_partition_wide_efb", "partition.cu",
         "lightgbm_tpu/ops/grow.py:490,1298 (decode_col of int32 groups; XLA there)",
         c_l["pick_partition_wide_efb"]),
        ("efb_remap_wide", "efb_remap.cu", "lightgbm_tpu/ops/grow.py:806 (remap_hist; XLA there)",
         c_l["efb_remap_wide"]),
        ("predict_bins_wide_efb", "predict_bins.cu", "lightgbm_tpu/ops/predict.py:104",
         c_l["predict_bins_wide_efb"]),
        ("pick_partition_pool_efb", "partition.cu",
         "lightgbm_tpu/ops/grow.py:1479-1536 (HistogramPool::Get; XLA there)",
         f_l["pick_partition_pool_efb"]),
        ("efb_remap_large", "efb_remap.cu",
         "lightgbm_tpu/ops/grow.py:1455-1476 (the larger child's remap_hist; XLA there)",
         f_l["efb_remap_large"]),
        ("split_pair_all_pool", "split_pair.cu",
         "lightgbm_tpu/ops/grow.py:1049 (rescan_resident; XLA there)",
         p_l["split_pair_all_pool"]),
    ):
        t = kt[name]
        rows.append(dict(name=name, route="cuda", source=src + source, replaces=replaces,
                         launches=launches, max_abs_err=t["max_abs_err"], ms=t["ms"],
                         plain_ms=t["plain_ms"], bound_ms=t["bound_ms"], bound_by=t["bound_by"],
                         library_ms=t["library_ms"]))
    return rec, rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="", help="also write the results as JSON here")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.config import Config
    from helpers.bench_data import make_higgs_like
    from lightgbm_tpu_torch import bench as bench_mod
    from lightgbm_tpu_torch.bench import (
        COVER_CATEGORICAL, COVER_PARAMS, COVER_ROWS, COVER_VALID_ROWS, YEAR_FEATURES, YEAR_PARAMS,
        YEAR_ROWS, YEAR_VALID_ROWS, covertype_compact_rows, covertype_like_rows, year_like_rows,
        FLIGHT_COLUMNS, FLIGHT_PARAMS, FLIGHT_ROWS, FLIGHT_VALID_ROWS, flight_like_rows,
    )
    from lightgbm_tpu_torch import objective as objective_mod
    from lightgbm_tpu_torch.obs import tune
    from lightgbm_tpu_torch.ops import cuda_build, cuda_graph, hist_kernel, split_kernel
    from lightgbm_tpu_torch.ops import grow as grow_mod
    from lightgbm_tpu_torch.ops import grow_state as gs
    from lightgbm_tpu_torch.ops import grow_step as grow_step_plain
    from lightgbm_tpu_torch.ops import grow_step_kernel, partition_kernel, predict_kernel
    from lightgbm_tpu_torch.ops import predict as predict_plain
    from lightgbm_tpu_torch.ops import remap as remap_plain
    from lightgbm_tpu_torch.ops import rank_kernel, remap_kernel
    from lightgbm_tpu_torch.models.gbdt import draw_bag
    from lightgbm_tpu_torch.ops.histogram import (
        leaf_histogram, leaf_histogram_packed4_rows, leaf_values, operands, segment_histogram,
    )
    from lightgbm_tpu_torch.ops.split import (
        MISSING_NAN, MISSING_ZERO, SplitParams, find_best_split_pair,
    )
    from lightgbm_tpu_torch.ops.split import split_pair_step as split_pair_step_plain

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results = {}
    phase_s = {}
    clock = [time.perf_counter()]

    def say(phase, **kw):
        now = time.perf_counter()
        phase_s[phase] = now - clock[0]
        clock[0] = now
        print("phase %s: %.1f s" % (phase, phase_s[phase]), file=sys.stderr, flush=True)
        results[phase] = kw
        print(json.dumps({"phase": phase, **kw}), flush=True)

    # median device time between two CUDA events, the L2 flushed and the
    # host's launch overhead hidden behind a spin kernel (obs/tune.py)
    time_ms = tune.CudaTimer(dev)

    # ---- 1. device and build ------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi unavailable"
    print(card)
    t0 = time.perf_counter()
    build_s = cuda_build.build()
    ptxas = {name: cuda_build.ptxas_usage(cuda_build.library_path(name).with_suffix(".log").read_text())
             for name in cuda_build.SOURCES}
    assert all(ptxas.values()), ("ptxas reported no kernel", ptxas)
    # hist_onehot: one instance per (16-bin tile count, operand type)
    onehot_instances = sorted(k for k in ptxas["hist_onehot"] if k.startswith("onehot_kernel<"))
    assert len(onehot_instances) == 10, onehot_instances
    # hist_v1: one instance per (operand type, bin path), and the chunks' reduction
    hist_v1_ptxas = ptxas["hist_v1"]
    assert len([k for k in hist_v1_ptxas if k.startswith("v1_kernel<")]) == 4, hist_v1_ptxas
    assert all(u.get("spill_stores", 0) == u.get("spill_loads", 0) == 0
               for u in hist_v1_ptxas.values()), ("hist_v1 spills", hist_v1_ptxas)
    # the split loop's kernels: the fused pick and partition, the split scan's
    # three instances (host-indexed, device-indexed, folded), grow_step's
    # leaf lookup (leaf_ids' int64 leaves; score_update's byte or int32
    # leaves) and score_update's pass in row order; the pick and partition,
    # the scan and predict_bins each also in a categorical instantiation; the
    # pick and partition and predict_bins each also for EFB-bundled tables
    # (the pick's second flag, predict_bins' own kernel), beside the remap
    # (and, since wide bins and the histogram pool, the pick and partition
    # for int16 bins and with the pool's LRU update, the scan for rows past
    # 336 bins and by pool slot, predict_bins for int16 bins)
    # (and, since forced splits and CEGB, the pick and partition's kExt
    # instantiations, the scan's penalised root and folded entries, the
    # forced record, and grow_step's lazy pass; since EFB groups past 256
    # bins, the pool with EFB and CEGB with the pool, every bundled pick
    # with int16 groups and with a pool, the scan's penalised pooled
    # all-leaves entry, the bundled predict of int16 groups, and the remap's
    # wide and larger-child instantiations)
    assert set(ptxas["partition"]) == {
        "pick_partition_kernel<%d,%d,%d,%d,%d>" % (ca, efb, wide, pool, ext) for ca in (0, 1)
        for efb in (0, 1) for wide in (0, 1) for pool in (0, 1) for ext in (0, 1)}, ptxas
    assert set(ptxas["split_pair"]) == {
        "split_pair_kernel<%d,%d,%d,%d,%d,%d>" % (d, fo, ca, wide, pool, pen)
        for d, fo, pool, pen in ((0, 0, 0, 0), (1, 0, 0, 0), (1, 1, 0, 0), (1, 1, 1, 0),
                                 (1, 0, 0, 1), (1, 1, 0, 1), (1, 0, 1, 1))
        for ca in (0, 1) for wide in (0, 1)} | {"forced_record_kernel"}, ptxas
    assert set(ptxas["grow_step"]) == {
        "leaf_tile_kernel<int64>", "leaf_tile_kernel<uint8>", "leaf_tile_kernel<int32>",
        "add_value_kernel<uint8>", "add_value_kernel<int32>", "cegb_lazy_kernel"}, ptxas
    assert set(ptxas["predict_bins"]) == {
        "%s<%d,%d>" % (k, ca, wide) for k in ("predict_bins_kernel", "predict_bins_bundled_kernel")
        for ca in (0, 1) for wide in (0, 1)}, ptxas
    assert set(ptxas["efb_remap"]) == {
        "efb_remap_kernel<%d,%d>" % (wide, large) for wide in (0, 1) for large in (0, 1)}, ptxas
    assert set(ptxas["lambdarank"]) == {"lambdarank_kernel"}, ptxas
    assert set(ptxas["packed_predict"]) == {"bin_rows_kernel", "leaves_kernel", "values_kernel"}, ptxas
    assert set(ptxas["tree_shap"]) == {"tree_shap_kernel", "tree_sum_kernel"}, ptxas
    # histogram.cu: both entries per (operand type, bin path, grouped form,
    # uint8 or int16 bins)
    assert len([k for k in ptxas["histogram"] if k.startswith("hist_")]) == 32, ptxas["histogram"]
    assert all(u.get("spill_stores", 0) == 0
               for n in ("partition", "split_pair", "grow_step", "predict_bins", "efb_remap",
                         "lambdarank", "packed_predict")
               for u in ptxas[n].values()), ("split-loop and predict kernels spill", ptxas)
    # tree_shap's path arrays live in a global scratch by design; its own
    # spill line is recorded (printed in phase 8c), not held to zero
    say("build", device=torch.cuda.get_device_name(0), nvidia_smi=card,
        seconds=round(time.perf_counter() - t0, 3), per_source=build_s, ptxas=ptxas,
        hist_v1=hist_v1_ptxas)

    # ---- data: the main path's dataset ---------------------------------------
    X, y = make_higgs_like(ROOT_ROWS, FEATURES)
    t0 = time.perf_counter()
    train_set = lgb.Dataset(X, label=y)
    cfg = Config.from_params(dict(TRAIN_PARAMS))
    binned = train_set.get_binned(cfg)
    bin_s = time.perf_counter() - t0
    N = binned.num_data
    F = binned.num_features
    B = binned.max_num_bin
    bins = torch.from_numpy(np.ascontiguousarray(binned.bins)).to(dev)
    bins_nf = bins.t().contiguous()
    hist_bins = bins_nf.t()  # the grower's layout: [F, N] view of the [N, F] copy
    rng = np.random.RandomState(0)
    dy_vals = leaf_values(
        torch.tensor(rng.randint(-64, 65, N) / 64.0, dtype=torch.float32, device=dev),
        torch.tensor(rng.randint(1, 65, N) / 64.0, dtype=torch.float32, device=dev),
        torch.ones(N, device=dev),
    )
    p0 = float(np.mean(y))
    score = np.log(p0 / (1 - p0))
    # real gradients: binary log-loss at the boost-from-average score
    resp = (-np.where(y > 0, 1.0, -1.0) / (1.0 + np.exp(np.where(y > 0, 1.0, -1.0) * score)))
    real_vals = leaf_values(
        torch.tensor(resp, dtype=torch.float32, device=dev),
        torch.tensor(np.abs(resp) * (1 - np.abs(resp)), dtype=torch.float32, device=dev),
        torch.ones(N, device=dev),
    )
    seg_rows = torch.from_numpy(
        np.sort(rng.permutation(N)[: N // 10]).astype(np.int32)
    ).to(dev)
    say("data", rows=N, features=F, num_bins=B, binning_s=round(bin_s, 3),
        segment_rows=int(seg_rows.numel()))

    # ---- 2. histogram kernel vs plain ------------------------------------------
    def hist_case(values, rows):
        got = hist_kernel.histogram(hist_bins, values, B, rows)
        want = leaf_histogram(bins, values, B, rows)
        return got, want

    got, want = hist_case(dy_vals, None)
    assert torch.equal(got, want), "histogram kernel != plain on dyadic root"
    got_s, want_s = hist_case(dy_vals, seg_rows)
    assert torch.equal(got_s, want_s), "histogram kernel != plain on dyadic segment"
    def check_real(rows):
        """Real values sum in other orders on the two sides: each cell must lie
        within the f32 worst-case bound of two summation orders,
        count * 2^-23 * (sum of |values|)."""
        got_r, want_r = hist_case(real_vals, rows)
        ratio, err = err_over_bound(got_r, want_r, leaf_histogram(bins, real_vals.abs(), B, rows))
        assert ratio <= 1.0, ("histogram kernel off on real values", err, ratio)
        return err, ratio, want_r

    hist_err, hist_ratio, want_r = check_real(None)
    seg_err, seg_ratio, _ = check_real(seg_rows)

    flat_idx = (bins.long() + torch.arange(F, device=dev)[:, None] * B).reshape(-1)
    flat_vals = real_vals.repeat(F, 1)
    lib_out = torch.zeros((F * B, 3), device=dev)

    def library_root():
        lib_out.zero_()
        lib_out.index_add_(0, flat_idx, flat_vals)

    library_root()
    lib_err = float((lib_out.view(F, B, 3) - want_r).abs().max())
    out_bytes = F * B * 12
    root_bound, root_by = bound(N * F + N * 12 + out_bytes, 3 * N * F)
    n_s = int(seg_rows.numel())
    seg_bound, seg_by = bound(n_s * F + n_s * 12 + n_s * 4 + out_bytes, 3 * n_s * F)
    hist_root = dict(
        ms=time_ms(lambda: hist_kernel.histogram(hist_bins, real_vals, B)),
        plain_ms=time_ms(lambda: leaf_histogram(bins, real_vals, B), reps=3),
        library_ms=time_ms(library_root),
        bound_ms=root_bound, bound_by=root_by,
    )
    hist_seg = dict(
        ms=time_ms(lambda: hist_kernel.histogram(hist_bins, real_vals, B, seg_rows)),
        plain_ms=time_ms(lambda: leaf_histogram(bins, real_vals, B, seg_rows), reps=3),
        bound_ms=seg_bound, bound_by=seg_by,
    )
    say("histogram", dyadic_exact=True, real_max_abs_err=hist_err,
        real_err_over_bound=hist_ratio, segment_max_abs_err=seg_err,
        segment_err_over_bound=seg_ratio, library_max_abs_err=lib_err,
        root=hist_root, segment=hist_seg)

    # ---- 2b. histogram at the sizes of one tree's calls ---------------------------
    q = 1024  # dyadic grid on which bf16 rounds and every per-bin sum stays exact in f32
    dyq_vals = leaf_values(
        torch.tensor(rng.randint(-q, q + 1, N) / q, dtype=torch.float32, device=dev),
        torch.tensor(rng.randint(1, 65, N) / q, dtype=torch.float32, device=dev),
        torch.ones(N, device=dev),
    )
    size_rng = np.random.RandomState(1)
    narrow = {Bn: (bins_nf % Bn).t() for Bn in (15, 63)}  # the grower's layout at narrower widths
    sms = hist_kernel._sm_count(dev)
    real_host = real_vals.cpu().numpy()
    sizes = {}
    for n in (256, 1024, 4096, 16384, 100_000, N):
        rows = None if n == N else torch.from_numpy(
            np.sort(size_rng.permutation(N)[:n]).astype(np.int32)).to(dev)
        size_bound, _ = bound(n * F + n * 12 + (0 if rows is None else n * 4) + out_bytes, 3 * n * F)
        rec = dict(grid=hist_kernel.histogram_grid(n, F, sms), v1_grid=hist_kernel.v1_grid(n, F, sms),
                   bound_ms=size_bound)
        for dt in ("float32", "bfloat16"):
            got = hist_kernel.histogram(hist_bins, dyq_vals, B, rows, dt)
            assert torch.equal(got, leaf_histogram(bins, dyq_vals, B, rows, dt)), (n, dt)
            assert torch.equal(hist_kernel.hist_v1(hist_bins, dyq_vals, B, rows, dt), got), (n, dt)
            # hist_v1's order is fixed: its mirror's bits on real values, the
            # same bits on every call at the root
            v1_real = hist_kernel.hist_v1(hist_bins, real_vals, B, rows, dt)
            if rows is None:
                for _ in range(4):
                    assert torch.equal(hist_kernel.hist_v1(hist_bins, real_vals, B, None, dt),
                                       v1_real), ("hist_v1 changed between calls", dt)
            else:
                assert np.array_equal(v1_real.cpu().numpy(), hist_kernel.hist_v1_mirror(
                    binned.bins, real_host, B, rows.cpu().numpy(), dt, sms)), (
                    "hist_v1 != its mirror", n, dt)
            for Bn, bins_n in narrow.items():
                assert torch.equal(hist_kernel.histogram(bins_n, dyq_vals, Bn, rows, dt),
                                   leaf_histogram(bins_n, dyq_vals, Bn, rows, dt)), (n, Bn, dt)
            rec[dt] = dict(
                ms=time_ms(lambda: hist_kernel.histogram(hist_bins, real_vals, B, rows, dt)),
                hist_v1_ms=time_ms(lambda: hist_kernel.hist_v1(hist_bins, real_vals, B, rows, dt)),
            )
        sizes["root" if rows is None else n] = rec
    del narrow
    say("histogram_sizes", num_bins=B, dyadic_exact_at_num_bins=[15, 63, B],
        hist_v1_real_equals_mirror_up_to=100_000, hist_v1_root_repeats_equal=5, sizes=sizes)

    # ---- 3. split kernel vs plain -----------------------------------------------
    hist2 = torch.stack([got_s, got - got_s]).contiguous()  # both children
    sums = hist2[:, 0].sum(dim=1).contiguous()
    cons = torch.tensor([[-np.inf, np.inf], [-np.inf, 0.5]], dtype=torch.float32, device=dev)
    meta_np = binned.feature_meta_arrays()
    meta = {
        "num_bin": torch.as_tensor(meta_np["num_bin"].astype(np.int32), device=dev),
        "missing_type": torch.arange(F, dtype=torch.int32, device=dev) % 3,
        "default_bin": torch.as_tensor(meta_np["default_bin"].astype(np.int32), device=dev),
        "monotone": torch.zeros(F, dtype=torch.int32, device=dev),
    }
    meta["monotone"][3] = 1
    fmask = torch.ones(F, dtype=torch.bool, device=dev)
    # the same children read by leaf index out of a grower-like buffer
    leaf_buf = torch.zeros((8, F, B, 3), dtype=torch.float32, device=dev)
    leaf_buf[5], leaf_buf[2] = hist2[0], hist2[1]
    # real-valued children: the same fold order and rounded ops, so bit for bit too
    seg_r = leaf_histogram(bins, real_vals, B, seg_rows)
    hist2_r = torch.stack([seg_r, want_r - seg_r]).contiguous()
    sums_r = hist2_r[:, 0].sum(dim=1).contiguous()
    # 300 features of synthetic dyadic histograms: many blocks race for a child's ticket
    F_wide = 300
    gen = torch.Generator(device=dev).manual_seed(3)
    cnt = torch.randint(0, 40, (2, F_wide, B), generator=gen, device=dev).float()
    grad_w = torch.randint(-64, 65, (2, F_wide, B), generator=gen, device=dev) / 64.0
    hist_w = torch.stack([grad_w * cnt.clamp(min=1), cnt * 0.25, cnt], -1).contiguous()
    meta_w = {
        "num_bin": torch.full((F_wide,), B, dtype=torch.int32, device=dev),
        "missing_type": torch.arange(F_wide, dtype=torch.int32, device=dev) % 3,
        "default_bin": torch.arange(F_wide, dtype=torch.int32, device=dev) % 3,
        "monotone": torch.zeros(F_wide, dtype=torch.int32, device=dev),
    }
    cases = {
        "dyadic": (hist2, sums, cons, meta, fmask, None),
        "dyadic_by_leaf": (leaf_buf, sums, cons, meta, fmask, (5, 2)),
        "real": (hist2_r, sums_r, cons, meta, fmask, None),
        "wide_dyadic": (hist_w, hist_w[:, 0].sum(dim=1).contiguous(), cons, meta_w,
                        torch.ones(F_wide, dtype=torch.bool, device=dev), None),
    }
    split_fields = dict.fromkeys(cases, 0)
    for pr in ((0.0, 0.0, 0.0, 20, 1e-3, 0.0), (0.5, 1.0, 0.3, 5, 0.5, 0.1)):
        params = SplitParams(*pr)
        for two_way in (True, False):
            for case, (h, s, cn, mt, fm, leaves) in cases.items():
                kf, ki, kb = split_kernel.find_best_split_pair(h, s, cn, mt, fm, params, two_way,
                                                               leaves)
                pf, pi, pb = find_best_split_pair(h, s, cn, mt, fm, params, two_way, leaves)
                same_f = (kf == pf) | (torch.isnan(kf) & torch.isnan(pf))
                assert bool(same_f.all()) and torch.equal(ki, pi) and torch.equal(kb, pb), (
                    "split kernel != plain", case, pr, two_way, kf, pf, ki, pi)
                split_fields[case] += kf.numel() + ki.numel()
    del leaf_buf, hist_w
    params = SplitParams(0.0, 0.0, 0.0, 20, 1e-3, 0.0)
    split_bound, split_by = bound(hist2.numel() * 4 + 2 * 21 * 4 + F * 17, 2 * F * B * 60)
    split_t = dict(
        ms=time_ms(lambda: split_kernel.find_best_split_pair(hist2, sums, cons, meta, fmask, params)),
        plain_ms=time_ms(lambda: find_best_split_pair(hist2, sums, cons, meta, fmask, params), reps=3),
        bound_ms=split_bound, bound_by=split_by, library_ms=None,
    )
    say("split", exact=True, fields_compared=split_fields, **split_t)

    # ---- 4. the main path ----------------------------------------------------------
    main_launches = {}  # summed over the main-path runs: phase 4, sweep, routed training

    def counted(fn):
        """Run ``fn`` with every launch count set to 0 just before and read
        just after; add the counts to the main path's."""
        cuda_graph.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = {k: v for k, v in cuda_graph.launch_counts().items() if v}
        for k, v in got.items():
            main_launches[k] = main_launches.get(k, 0) + v
        return out, secs, got

    booster, train_s, launches = counted(lambda: lgb.train(dict(TRAIN_PARAMS), train_set, 10))
    assert booster._gbdt.grow_loop == "device", booster._gbdt.grow_loop
    loop_kernels = ("histogram", "histogram_segment", "split_pair_step", "pick_partition",
                    "split_pair_fold", "score_update")
    assert all(launches.get(k, 0) > 0 for k in loop_kernels), launches
    (_, metric, auc, _), = booster.eval_train()
    raw = booster.predict(X[:1000], raw_score=True)
    assert booster.num_trees() == 10 and np.all(np.isfinite(raw)) and raw.shape == (1000,)
    np.testing.assert_allclose(raw, booster._gbdt.train_score()[:1000], rtol=1e-5, atol=1e-5)
    assert auc > 0.7, auc
    leaves = [t.num_leaves for t in booster._gbdt.trees()]
    say("train", rows=N, iterations=10, seconds=round(train_s, 3), grow_loop="device",
        iterations_per_s=10 / train_s, auc=auc, launches=launches, leaves=leaves)

    # one more iteration under the profiler: device busy time by kernel
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        booster.update()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel = {}
    copies = {"HtoD": 0, "DtoH": 0}
    for ev in prof.key_averages():
        for way in copies:
            if "Memcpy " + way in ev.key:
                copies[way] += ev.count
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue  # host ops carry their kernels' time too; count kernels once
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if us > 0:
            by_kernel[ev.key[:60]] = [round(us / 1e3, 3), ev.count]
    busy_ms = sum(v[0] for v in by_kernel.values())
    top = dict(sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:8])
    # the split scan's kernels and any indexing copy (a hist[idx] gather),
    # whatever their rank
    split_and_copy = {k: v for k, v in by_kernel.items()
                      if "split" in k.lower() or "index_elementwise" in k or "gpu_index" in k}
    # the split loop's own kernels (csrc/partition.cu, grow_step.cu, the
    # segment entry of histogram.cu, the split scan); no subtraction of its own
    loop_ms = {k: v for k, v in by_kernel.items() if any(
        n in k for n in ("pick_partition_kernel", "hist_segment_kernel", "split_pair_kernel",
                         "leaf_tile_kernel", "add_value_kernel", "subtract_kernel"))}
    assert not any("subtract_kernel" in k for k in by_kernel), by_kernel
    # no copy per split: the leaf values up, the packed tree down
    assert copies["HtoD"] <= 4 and copies["DtoH"] <= 4, copies
    # the profiler's host-side tracing slows the profiled iteration many
    # times over, so the idle share is taken against phase 4's unprofiled
    # iteration time
    iter_ms = train_s / 10 * 1e3
    say("profile", profiled_iteration_wall_ms=wall_ms, unprofiled_iteration_ms=iter_ms,
        device_busy_ms=busy_ms,
        device_idle_share=(1 - busy_ms / iter_ms) if busy_ms else "not measured",
        memcpy_calls=copies, top_device_ms_and_calls=top,
        split_and_copy_ms_and_calls=split_and_copy, split_loop_ms_and_calls=loop_ms)

    # ---- 4b. the two split loops, paired ------------------------------------------
    g0 = booster._gbdt
    assert not g0.grouped_adds  # spread bins: the histograms' plain loop
    loop_args = (g0.bins_dev, g0.feature_mask, g0.feature_meta, TRAIN_PARAMS["num_leaves"],
                 g0.config.max_depth, g0.num_bins, g0.split_params, g0._two_way)

    def grow_with(loop, grad_, hess_, state=None):
        bins_, mask_, meta_, M_, depth_, B_, params_, two_way_ = loop_args
        args_ = (bins_, grad_, hess_, mask_, meta_, M_, depth_, B_, params_, two_way_)
        if loop == "host":
            return grow_mod.grow_tree(*args_, bins_nf=g0.bins_nf) + (state,)
        return grow_mod.grow_tree_device(*args_, bins_nf=g0.bins_nf, state=state)

    # dyadic gradients (multiples of 2^-10): both loops must grow the same
    # tree bit for bit, in turns host, device, device, host
    dy_grad = dyq_vals[:, 0].contiguous()
    dy_hess = dyq_vals[:, 1].contiguous()
    trees = []

    def dyadic_turns():
        st = None
        for loop in ("host", "device", "device", "host"):
            tree, leaf_id, st = grow_with(loop, dy_grad, dy_hess, st)
            trees.append((tree, leaf_id))
        return st

    # the device loop's tree API (grow_tree_device) is a path of its own,
    # driven with the counts from 0: leaf_ids runs there, not in boosting
    state, _, tree_api_launches = counted(dyadic_turns)
    assert tree_api_launches.get("leaf_ids", 0) == 2, tree_api_launches
    assert "score_update" not in tree_api_launches, tree_api_launches
    for tree, leaf_id in trees[1:]:
        for name in tree._fields:
            assert torch.equal(getattr(tree, name), getattr(trees[0][0], name)), ("loops differ", name)
        assert torch.equal(leaf_id, trees[0][1]), "loops differ: leaf_id"
    dyadic_leaves = int(trees[0][0].num_leaves)

    # the device loop from the root to the readback makes no synchronizing call
    real_grad, real_hess = g0.objective.get_gradients(g0.scores[0])
    grow_args = (g0.bins_dev, real_grad, real_hess, g0.feature_mask, g0.feature_meta,
                 g0.config.max_depth, g0.split_params, g0._two_way, g0.bins_nf)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        grow_mod.launch_tree(state, *grow_args)
        grow_mod.leaf_ids(state)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert int(grow_mod.read_tree(state).num_leaves) > 1

    # real gradients: one tree a turn, host, device, device, host, twice
    tree_ms = {"host": [], "device": []}
    enqueue_ms = []
    splits = {}
    for _ in range(2):
        for loop in ("host", "device", "device", "host"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if loop == "device":
                grow_mod.launch_tree(state, *grow_args)
                enqueue_ms.append((time.perf_counter() - t0) * 1e3)
                leaf_id = grow_mod.leaf_ids(state)
                tree = grow_mod.read_tree(state)
            else:
                tree, leaf_id, _ = grow_with(loop, real_grad, real_hess)
            torch.cuda.synchronize()
            tree_ms[loop].append((time.perf_counter() - t0) * 1e3)
            splits[loop] = int(tree.num_leaves) - 1
    # the host's own cost of a step: a loop stopped from the root (no split
    # has min_data_in_leaf rows a side), whose kernels all return at once
    stopped = g0.split_params._replace(min_data_in_leaf=N)
    idle_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        grow_mod.launch_tree(state, *grow_args[:6], stopped, *grow_args[7:])
        torch.cuda.synchronize()
        idle_ms.append((time.perf_counter() - t0) * 1e3)
    assert int(state.ctl[gs.NUM_LEAVES]) == 1
    M = state.M

    # training, paired in turns: device, host, host, device (10 iterations
    # each); each booster's AUC at 10 iterations, where phase 4 stopped
    turn_boosters = {}
    for loop in ("device", "host"):
        turn_boosters[loop] = lgb.Booster(dict(TRAIN_PARAMS), train_set)
        turn_boosters[loop]._gbdt.grow_loop = loop
        turn_boosters[loop]._gbdt.iteration_graph = False  # the eager launches (4c has the graph)
    turn_ips = {"device": [], "host": []}  # iterations/s of each turn
    auc10 = {}
    for loop in ("device", "host", "host", "device"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            turn_boosters[loop].update()
        torch.cuda.synchronize()
        turn_ips[loop].append(10 / (time.perf_counter() - t0))
        if loop not in auc10:
            (_, _, auc10[loop], _), = turn_boosters[loop].eval_train()
    assert abs(auc - auc10["host"]) <= 2e-3, ("device loop AUC off the host loop's", auc, auc10)
    del turn_boosters

    # each kernel of a step against its plain version at the main path's
    # first step (the 1M-row root split), then timed from the same state
    s = gs.GrowState(dev, N, F, B, M)
    grow_mod.start_tree(s, *grow_args)

    # the root's scan (start_tree's, C = 1), then step 0: its segment
    # histogram into small[0] and the folded scan of parity 0
    fold_kernel = (lambda st: split_kernel.split_pair_fold(st, st.queued_steps % 2),
                   lambda st: grow_step_plain.split_pair_fold(st, st.queued_steps % 2))
    step_kernels = (
        ("split_pair_step", lambda st: split_kernel.split_pair_step(st, 1),
         lambda st: split_pair_step_plain(st, 1)),
        ("pick_partition", partition_kernel.pick_partition, plain_pick_partition),
        ("histogram_segment", hist_kernel.histogram_segment, segment_histogram),
        ("split_pair_fold",) + fold_kernel,
    )
    step_t = {}

    def small_rows(st):
        """The rows of the step's smaller child."""
        leaf = int(st.ctl[gs.SMALL])
        b0 = int(st.leaf_begin[leaf])
        return st.order[b0:b0 + int(st.leaf_count[leaf])]

    def small_err(st, want, parity=0):
        """err_over_bound of the state's smaller-child histogram (in
        ``small[parity]``) against ``want``."""
        abs_sum = leaf_histogram(st.hist_bins, st.values.abs(), B, small_rows(st), st.hist_dtype)
        return err_over_bound(st.small[parity], want, abs_sum)

    def seg_small(st, other):
        """The real-valued segment histogram (``small[0]``) within the
        two-order bound of the plain one, ``small[1]`` equal."""
        ratio, err = small_err(st, other.small[0])
        assert ratio <= 1.0, ("histogram_segment", err, ratio)
        assert torch.equal(st.small[1], other.small[1]), ("histogram_segment", "small[1]")
        return err

    def pick_rows(st):
        """Rows of the segment the state's next pick partitions."""
        gains = st.best_f[:, 0]
        return int(st.leaf_count[int(torch.argmax(gains))])

    root_rows = pick_rows(s)
    for name, kernel, plain in step_kernels:
        step_t[name] = held_and_timed(s, name, kernel, plain, time_ms,
                                      seg_small if name == "histogram_segment" else None)
    # pick_partition at step 128 of the real-gradient tree, and there at the
    # pick of the leaf nearest 1024 rows (its gain raised above the others)
    s128 = gs.GrowState(dev, N, F, B, M)
    grow_mod.start_tree(s128, *grow_args)
    for _ in range(128):
        grow_mod.run_step(s128)
    assert int(s128.ctl[gs.ACTIVE]) == 1 and int(s128.ctl[gs.STEP]) == 128
    # the folded scan of step 128 (its pick and segment histogram first)
    sf = s128.clone()
    partition_kernel.pick_partition(sf)
    hist_kernel.histogram_segment(sf, sf.queued_steps % 2)
    fold_sizes = {"root": dict(small_child_rows=int(small_rows(s).numel()),
                               **step_t["split_pair_fold"]),
                  "step128": dict(small_child_rows=int(small_rows(sf).numel()),
                                  **held_and_timed(sf, "split_pair_fold", *fold_kernel, time_ms))}
    del sf
    s1k = s128.clone()
    nl = int(s1k.ctl[gs.NUM_LEAVES])
    gains = s1k.best_f[:nl, 0]
    near = ((s1k.leaf_count[:nl] - 1024).abs().float() + torch.where(gains > 0, 0.0, float("inf")))
    leaf_1k = int(torch.argmin(near))
    s1k.best_f[leaf_1k, 0] = gains.max() + 1.0
    pick_sizes = {"root": dict(rows=root_rows, **step_t["pick_partition"])}
    for key, st in (("step128", s128), ("rows_1k", s1k)):
        rows = pick_rows(st)
        pick_sizes[key] = dict(rows=rows, **held_and_timed(
            st, "pick_partition", partition_kernel.pick_partition, plain_pick_partition, time_ms))
    for key, t in pick_sizes.items():
        t.update(zip(("bound_ms", "bound_by"), bound(M * 4 + 320 + t["rows"] * 9, 0)))
    del s128, s1k
    n_small = int(small_rows(s).numel())
    cells = F * B * 3
    step_t["pick_partition"].update(bound_ms=pick_sizes["root"]["bound_ms"],
                                    bound_by=pick_sizes["root"]["bound_by"], sizes=pick_sizes)
    step_t["histogram_segment"].update(zip(("bound_ms", "bound_by"), bound(
        n_small * (F + 16) + cells * 4, 3 * n_small * F)))
    # the root's scan reads one child's rows; the folded scan reads the
    # parent's row and the scratch's and writes three rows (csrc/split_pair.cu)
    step_t["split_pair_step"].update(zip(("bound_ms", "bound_by"), bound(
        cells * 4 + 21 * 4 + F * 17, F * B * 60)))
    step_t["split_pair_fold"].update(zip(("bound_ms", "bound_by"), bound(
        5 * cells * 4 + 2 * 21 * 4 + F * 17, cells + 2 * F * B * 60)), sizes=fold_sizes)
    # the nearest one call to the subtraction the scan took in: one torch.sub
    # of the parent's and the scratch's [F, B, 3] rows at slots known on the host
    sub_a = s.hist[int(s.ctl[gs.BEST])].clone()
    sub_b = s.small[0].clone()
    sub_out = torch.empty_like(sub_a)
    step_t["split_pair_fold"]["subtract_library_ms"] = time_ms(
        lambda: torch.sub(sub_a, sub_b, out=sub_out))
    del sub_a, sub_b, sub_out
    # one index_add_ over the small child's rows: the segment entry's yardstick
    child_rows = small_rows(s).long()
    child_idx = (hist_bins[:, child_rows].long() + torch.arange(F, device=dev)[:, None] * B).reshape(-1)
    child_vals = s.values[child_rows].repeat(F, 1)
    child_acc = torch.zeros((F * B, 3), device=dev)

    def child_library():
        child_acc.zero_()
        child_acc.index_add_(0, child_idx, child_vals)
    step_t["histogram_segment"]["library_ms"] = time_ms(child_library)
    for name in ("pick_partition", "split_pair_fold", "split_pair_step"):
        step_t[name]["library_ms"] = None
    # the segment entry in bf16 on the same rows
    s.hist_dtype = "bfloat16"
    s.args.pop("histogram_segment0")
    s.small[0].zero_()
    hist_kernel.histogram_segment(s)
    ratio, bf16_err = small_err(s, leaf_histogram(s.hist_bins, s.values, B, small_rows(s), "bfloat16"))
    assert ratio <= 1.0, ("histogram_segment bf16", bf16_err, ratio)
    step_t["histogram_segment_bf16"] = dict(
        step_t["histogram_segment"], max_abs_err=bf16_err,
        ms=time_ms(lambda: hist_kernel.histogram_segment(s), setup=lambda: s.small[0].zero_()),
        plain_ms=time_ms(lambda: segment_histogram(s), reps=3))
    del s, child_rows, child_idx, child_vals, child_acc
    say("loops", dyadic_trees_equal=True, dyadic_leaves=dyadic_leaves, sync_free=True,
        tree_ms=tree_ms, splits=splits,
        device_enqueue_us_per_split=[t * 1e3 / splits["device"] for t in enqueue_ms],
        host_loop_us_per_split=[t * 1e3 / splits["host"] for t in tree_ms["host"]],
        stopped_loop_us_per_step=[t * 1e3 / (M - 1) for t in idle_ms],
        training_iterations_per_s=turn_ips, auc_at_10=auc10, phase4_auc=auc,
        # the profiled iteration's busy time against a paired device turn's iteration
        device_idle_share=[1 - busy_ms * ips / 1e3 for ips in turn_ips["device"]]
        if busy_ms else "not measured",
        root_step=dict(small_child_rows=n_small, **step_t))

    # ---- 4c. device-resident boosting: the captured iteration and chunks ----------
    # dyadic gradients at 1M rows: one replay of the captured tree (root, the
    # M - 1 steps, leaf ids) grows the eager launch_tree's tree bit for bit
    cs = gs.GrowState(dev, N, F, B, M)
    dy_args = (g0.bins_dev, dy_grad, dy_hess, g0.feature_mask, g0.feature_meta,
               g0.config.max_depth, g0.split_params, g0._two_way, g0.bins_nf)

    def dy_tree():
        grow_mod.launch_tree(cs, *dy_args)
        return grow_mod.leaf_ids(cs)

    want_leaf = dy_tree()
    want_tree = grow_mod.read_tree(cs)
    tree_graph = cuda_graph.Graph(dy_tree, dev)
    cs.packed.zero_()
    tree_graph.out.zero_()
    tree_graph.replay()
    got_tree = grow_mod.read_tree(cs)
    for name in got_tree._fields:
        assert torch.equal(getattr(got_tree, name), getattr(want_tree, name)), ("graph != eager", name)
    assert torch.equal(tree_graph.out, want_leaf) and torch.equal(want_leaf, trees[0][1])
    assert int(got_tree.num_leaves) == dyadic_leaves
    # the leaf_ids kernel against its plain version on that 255-leaf layout
    assert torch.equal(grow_step_kernel.leaf_ids(cs), grow_step_plain.leaf_ids(cs))
    leaf_t = dict(ms=time_ms(lambda: grow_step_kernel.leaf_ids(cs)),
                  plain_ms=time_ms(lambda: grow_step_plain.leaf_ids(cs), reps=3),
                  max_abs_err=0.0, library_ms=None)
    leaf_t.update(zip(("bound_ms", "bound_by"), bound(N * 12 + M * 8, 0)))
    # the fused score update on that layout, what the boosting iteration runs
    # in place of leaf_ids, a gather and an add: equal to score.add_(value[
    # leaf_ids]) bit for bit on real values
    gen_v = torch.Generator(device=dev).manual_seed(17)
    leaf_value = torch.randn(M, generator=gen_v, device=dev)
    score0 = torch.randn(N, generator=gen_v, device=dev)
    got_score = score0.clone()
    grow_step_kernel.score_update(cs, leaf_value, got_score)
    assert torch.equal(got_score, score0.clone().add_(leaf_value[grow_step_plain.leaf_ids(cs)]))
    score_w = score0.clone()
    score_t = dict(ms=time_ms(lambda: grow_step_kernel.score_update(cs, leaf_value, score_w)),
                   plain_ms=time_ms(lambda: grow_step_plain.score_update(cs, leaf_value, score_w),
                                    reps=3),
                   max_abs_err=0.0, library_ms=None,
                   # what it replaces, the kernel and two PyTorch calls
                   leaf_ids_gather_add_ms=time_ms(lambda: score_w.add_(
                       leaf_value[grow_step_kernel.leaf_ids(cs)])))
    # order read, the score read and written, the leaves' begin, count and value
    score_t.update(zip(("bound_ms", "bound_by"), bound(N * 12 + M * 12, N)))
    # the nearest one calls, given each position's leaf (not their input):
    # a scatter of the leaves through order, an index_add_ of their values
    order_l = cs.order.long()
    pos_leaf = torch.empty_like(order_l).scatter_(0, order_l, grow_step_plain.leaf_ids(cs))
    pos_value = leaf_value[pos_leaf]
    leaf_out = torch.empty_like(order_l)
    leaf_t["nearest_library_ms"] = time_ms(lambda: leaf_out.scatter_(0, order_l, pos_leaf))
    score_t["nearest_library_ms"] = time_ms(lambda: score_w.index_add_(0, order_l, pos_value))
    tree_graph_launches = tree_graph.launches
    del tree_graph, cs, want_leaf, score0, got_score, score_w, order_l, pos_leaf, pos_value, leaf_out

    # three boosters of the main path: the eager launches, a replay an
    # iteration (device_chunk_size 1) and chunks of 10 replays
    chunk = 10
    boost_kinds = {"eager": (1, False), "graph": (1, True), "chunk": (chunk, True)}
    boosters = {}
    for kind, (c, graph_on) in boost_kinds.items():
        boosters[kind] = lgb.Booster(dict(TRAIN_PARAMS, device_chunk_size=c), train_set)
        boosters[kind]._gbdt.iteration_graph = graph_on
    chunk_g = boosters["chunk"]._gbdt
    assert chunk_g.grow_loop == "device" and chunk_g.device_chunk_fallback_reason() is None

    def scores_hold(bst):
        """The train scores equal the kept trees' raw prediction."""
        np.testing.assert_allclose(bst._gbdt.train_score(), bst.predict(X, raw_score=True),
                                   rtol=1e-5, atol=1e-5)

    # warm-up: 10 iterations each (the first eager; the graph captured at
    # the second; for the chunked booster one iteration, then a chunk of 9)
    auc_boost = {}
    for kind, b in boosters.items():
        assert bench_mod.train_iterations(b, 10, boost_kinds[kind][0]) == 10
        (_, _, auc_boost[kind], _), = b.eval_train()
    assert abs(auc_boost["chunk"] - auc_boost["eager"]) <= 2e-3, auc_boost
    assert min(auc_boost.values()) > 0.7, auc_boost
    scores_hold(boosters["chunk"])
    # a whole chunk, from its first replay to the readback, makes no
    # synchronizing call
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ran, stopped = boosters["chunk"].update_chunk(chunk)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert (ran, stopped) == (chunk, False) and boosters["chunk"].num_trees() == 20
    scores_hold(boosters["chunk"])
    for kind in ("eager", "graph"):
        assert bench_mod.train_iterations(boosters[kind], 10, 1) == 10

    # a profiled iteration (a chunk: all of it): device busy time,
    # copies each way, the kernels' span on the card with the gaps between
    # consecutive kernels (in a chunk, those between replays among them), and
    # the device ms and calls of the split loop's and predict_bins' kernels
    named_kernels = ("pick_partition_kernel", "hist_segment_kernel", "hist_kernel",
                     "split_pair_kernel", "leaf_tile_kernel", "add_value_kernel",
                     "subtract_kernel", "predict_bins_kernel", "efb_remap_kernel",
                     "lambdarank_kernel", "cegb_lazy_kernel", "forced_record_kernel")

    def profiled(fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof_:
            fn()
            torch.cuda.synchronize()
        spans = sorted((ev.time_range.start, ev.time_range.end) for ev in prof_.events()
                       if ev.device_type == torch.autograd.DeviceType.CUDA
                       and not ev.name.startswith(("Memcpy", "Memset")))
        gaps_us = sorted((b_[0] - a_[1] for a_, b_ in zip(spans, spans[1:])), reverse=True)
        timeline = dict(
            span_ms=(spans[-1][1] - spans[0][0]) / 1e3, kernels=len(spans),
            gaps_us_sum=sum(g_ for g_ in gaps_us if g_ > 0),
            gaps_us_median=statistics.median(gaps_us), gaps_us_largest=gaps_us[:12],
        ) if len(spans) > 1 else "not measured"
        busy, kernels, copies_, named = 0.0, 0, {"HtoD": 0, "DtoH": 0}, {}
        for ev in prof_.key_averages():
            for way in copies_:
                if "Memcpy " + way in ev.key:
                    copies_[way] += ev.count
            if ev.device_type != torch.autograd.DeviceType.CUDA:
                continue
            us = getattr(ev, "self_device_time_total", None)
            if us is None:
                us = getattr(ev, "self_cuda_time_total", 0)
            busy += us / 1e3
            kernels += ev.count
            if any(n_ in ev.key for n_ in named_kernels):
                named[ev.key[:80]] = [us / 1e3, ev.count]
        return busy, kernels, copies_, timeline, named

    def turns_and_profile(bsts, chunks, order, profile_kinds, on_turn=None, iters=10):
        """Turns of ``iters`` iterations of the boosters ``bsts`` (kind -> booster;
        ``chunks``: kind -> its device_chunk_size) in ``order``, each with
        the launch counts from 0 (replays counted by the graph), equal
        between turns and between kinds, ``on_turn(kind)`` after each; then
        one profiled iteration of each of ``profile_kinds`` (a chunk: all of
        it), with no host-to-device copy and one device-to-host copy.
        Returns (iterations/s by kind, a turn's launches by kind, profiles)."""
        ips, per_turn = {k: [] for k in bsts}, {}
        for kind in order:
            ran, secs, got = counted(lambda: bench_mod.train_iterations(bsts[kind], iters,
                                                                        chunks[kind]))
            assert ran == iters, (kind, ran)
            ips[kind].append(iters / secs)
            per_turn.setdefault(kind, got)
            assert got == per_turn[kind], ("launches differ between turns", kind)
            if on_turn is not None:
                on_turn(kind)
        assert all(v == per_turn[order[0]] for v in per_turn.values()), per_turn
        prof_ = {}
        for kind in profile_kinds:
            n = chunks[kind]
            fn = bsts[kind].update if n == 1 else (lambda b_=bsts[kind], n_=n: b_.update_chunk(n_))
            busy, kernels, copies_, timeline, named = profiled(fn)
            prof_[kind] = dict(
                device_busy_ms_per_iteration=busy / n, device_events=kernels, copies=copies_,
                timeline=timeline, kernels_per_iteration=timeline["kernels"] / n
                if isinstance(timeline, dict) else "not measured", kernels_ms_and_calls=named,
                iterations=n, device_idle_share=[1 - busy / n * v / 1e3 for v in ips[kind]]
                if busy else "not measured", median_iterations_per_s=statistics.median(ips[kind]))
            assert copies_["HtoD"] == 0 and copies_["DtoH"] == 1, (kind, copies_)
        return ips, per_turn, prof_

    # turns of 10 iterations, eager, graph, chunk, chunk, graph, eager, the
    # chunked booster's train scores held after each of its turns; then one
    # profiled iteration of each (the chunk: 10)
    boost_ips, turn_launches, prof_boost = turns_and_profile(
        boosters, {k: v[0] for k, v in boost_kinds.items()},
        ("eager", "graph", "chunk", "chunk", "graph", "eager"), ("eager", "graph", "chunk"),
        on_turn=lambda kind: kind == "chunk" and scores_hold(boosters["chunk"]))
    # an iteration launches the captured tree's kernels, score_update in
    # place of leaf_ids
    per_iter = {k: v / 10 for k, v in turn_launches["graph"].items()}
    tree_per_iter = {k: float(v) for k, v in tree_graph_launches.items() if k != "leaf_ids"}
    assert tree_graph_launches["leaf_ids"] == 1 and per_iter.pop("score_update") == 1.0, per_iter
    assert per_iter == tree_per_iter, (per_iter, tree_graph_launches)
    # a step is three launches (no subtract_kernel): 817 kernels an
    # iteration or fewer (the timeline's, copies and memsets aside)
    for kind in boosters:
        assert not any("subtract_kernel" in k for k in prof_boost[kind]["kernels_ms_and_calls"])
        assert prof_boost[kind]["kernels_per_iteration"] <= 817, prof_boost[kind]

    # the host's time to queue an iteration: the eager launches, one replay,
    # and 10 replays (the chunk's), each from a synchronised card
    enqueue_us = {"eager": [], "graph": [], "chunk": []}
    for kind, n, eager in (("eager", 1, True), ("graph", 1, False), ("chunk", chunk, False)):
        g = boosters[kind]._gbdt
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            g.launch_iterations(n, eager=eager)
            enqueue_us[kind].append((time.perf_counter() - t0) * 1e6 / n)
            assert not g._keep_trees(g.collect_iterations(n))
    scores_hold(boosters["chunk"])
    del boosters

    # a stop in the middle of a chunk, on 100k rows of the main path's data
    # with gradients and hessians rounded to multiples of 2^-7 (every
    # histogram sum exact, so training is the same bit for bit whatever the
    # kernels' summation order): a min_gain_to_split found by bisection stops
    # chunk 1 between iterations 2 and 10; chunk 1 stops at the same
    # iteration in two runs, and chunk 10 keeps the same trees and scores
    ds_stop = lgb.Dataset(X[:100_000], label=y[:100_000])
    get_gradients = objective_mod.BinaryLogloss.get_gradients

    def dyadic_gradients(self, score):
        g_, h_ = get_gradients(self, score)
        return torch.round(g_ * 128.0) / 128.0, torch.clamp(torch.round(h_ * 128.0), min=1.0) / 128.0

    def train_stop(gain, c):
        params = dict(TRAIN_PARAMS, min_gain_to_split=gain, device_chunk_size=c)
        return lgb.train(params, ds_stop, 12)

    objective_mod.BinaryLogloss.get_gradients = dyadic_gradients
    try:
        free = train_stop(0.0, 1)
        assert free.num_trees() == 12
        lo, hi = 0.0, float(free._gbdt._tree_arrays[0].split_gain[0])
        probes = []
        for _ in range(16):
            gain = (lo + hi) / 2
            kept = train_stop(gain, 1).num_trees()
            probes.append((gain, kept))
            if 2 <= kept <= 8:
                break
            lo, hi = (gain, hi) if kept > 8 else (lo, gain)
        assert 2 <= kept <= 8, ("no gain threshold stops inside the chunk", probes)
        runs = [train_stop(gain, c) for c in (1, 1, chunk)]
    finally:
        objective_mod.BinaryLogloss.get_gradients = get_gradients
    ref_stop = runs[0]
    text = ref_stop.model_to_string().split("parameters:")[0]
    for r in runs[1:]:
        assert r.num_trees() == kept, ("stop point differs", r.num_trees(), kept)
        assert r.model_to_string().split("parameters:")[0] == text, "trees differ across the stop"
        assert r._gbdt.train_score().tobytes() == ref_stop._gbdt.train_score().tobytes()
    assert runs[2]._gbdt.device_chunk_fallback_reason() is None
    np.testing.assert_allclose(runs[2]._gbdt.train_score(),
                               runs[2].predict(X[:100_000], raw_score=True), rtol=1e-5, atol=1e-5)
    del runs, ref_stop, free

    say("boosting", dyadic_graph_tree_equal=True, graph_launches_per_iteration=tree_graph_launches,
        leaf_ids=leaf_t, score_update=score_t, auc_at_10=auc_boost, sync_free_chunk=True,
        training_iterations_per_s=boost_ips, launches_per_turn=turn_launches,
        enqueue_us_per_iteration=enqueue_us, profile=prof_boost,
        stop=dict(rows=100_000, min_gain_to_split=gain, trees_kept=kept, probes=probes,
                  chunk=chunk, same_trees_and_scores=True))

    # ---- 4d. validation, early stopping, bagging and feature_fraction ------------
    # the main path's training set with a validation set of VALID_ROWS rows
    # of the same distribution from another seed, bagging_fraction 0.8 a
    # bag every iteration, feature_fraction 0.8, AUC and log-loss at every
    # boundary, 5 rounds of patience; depth cut to VALID_ROUNDS iterations
    Xv, yv = higgs_like_rows(VALID_ROWS, FEATURES, seed=8)
    valid_set = lgb.Dataset(Xv, label=yv, reference=train_set)
    vparams = dict(TRAIN_PARAMS, **VALID_PARAMS)
    t0 = time.perf_counter()
    valid_set.get_binned(cfg)
    valid_bin_s = time.perf_counter() - t0
    evals = {}
    vbst, valid_train_s, valid_launches = counted(lambda: lgb.train(
        dict(vparams), train_set, VALID_ROUNDS, valid_sets=[valid_set], early_stopping_rounds=5,
        evals_result=evals, verbose_eval=False))
    gv = vbst._gbdt
    assert gv.grow_loop == "device" and gv.captures == 1, (gv.grow_loop, gv.captures)
    assert valid_launches.get("predict_bins", 0) >= len(evals["valid_0"]["auc"]), valid_launches
    assert all(valid_launches.get(k, 0) > 0 for k in loop_kernels), valid_launches
    valid_auc = evals["valid_0"]["auc"]
    assert max(valid_auc) > 0.7 and np.all(np.isfinite(evals["valid_0"]["binary_logloss"])), valid_auc
    assert 1 <= vbst.best_iteration <= vbst.num_trees() <= VALID_ROUNDS
    # every tree of the run: the kernel's leaves equal the plain traversal's,
    # and the validation score equals the plain per-tree f32 adds bit for bit
    vbins = gv._valid_bins[0]
    plain_score = torch.zeros(VALID_ROWS, device=dev) + np.float32(gv._init_fold[0])
    depth_sum = 0.0
    for ta in gv._tree_arrays:
        ptree = predict_plain.make_predict_tree(ta, gv.feature_meta)
        want_leaf = predict_plain.tree_predict_leaf(vbins, ptree)
        nl = int(ta.num_leaves)
        nodes = torch.stack([ta.split_feature, ta.threshold_bin, ta.left_child, ta.right_child,
                             ta.default_left.to(torch.int32)], 1)[:nl - 1].to(dev, torch.int32).contiguous()
        got_leaf = torch.empty(VALID_ROWS, dtype=torch.int32, device=dev)
        scratch = torch.zeros(VALID_ROWS, device=dev)
        predict_kernel.add_tree_value(vbins, nodes, torch.tensor([nl], dtype=torch.int32, device=dev),
                                      gv.feature_meta, ptree.leaf_value, scratch, got_leaf)
        assert torch.equal(got_leaf.long(), want_leaf), "predict_bins leaves != plain traversal"
        plain_score += ptree.leaf_value[want_leaf]
        depth_sum += float(ta.leaf_depth.to(dev)[want_leaf].double().mean())
    assert plain_score.double().cpu().numpy().tobytes() == gv._valid_score_np(0).tobytes(), (
        "validation score != the plain per-tree adds")
    mean_depth = depth_sum / len(gv._tree_arrays)
    # the bag of the last iteration equals its CPU draw; the feature masks
    # equal numpy's draws for every iteration run
    bag_cnt = int(vparams["bagging_fraction"] * N)
    assert torch.equal(gv._bag.cpu(), draw_bag(gv.config.bagging_seed, gv._bag_iter, N, bag_cnt, "cpu"))
    assert int(gv._bag.sum()) == bag_cnt
    # the card's draw (the JAX package's threefry permutation) equals the
    # same torch code on the CPU for every iteration the run drew
    for it_ in range(gv.iter_ + 1):
        assert torch.equal(draw_bag(gv.config.bagging_seed, it_, N, bag_cnt, dev).cpu(),
                           draw_bag(gv.config.bagging_seed, it_, N, bag_cnt, "cpu")), it_
    feat_rng = np.random.RandomState(gv.config.feature_fraction_seed & 0x7FFFFFFF)
    k_feat = max(1, int(vparams["feature_fraction"] * F))
    for _ in range(vbst.num_trees()):
        want_mask = np.zeros(F, bool)
        want_mask[feat_rng.choice(F, size=k_feat, replace=False)] = True
    assert np.array_equal(gv.feature_mask.cpu().numpy(), want_mask)
    last = gv._tree_arrays[-1]
    assert want_mask[last.split_feature[:int(last.num_leaves) - 1].numpy()].all()
    # the host's time of an eval boundary: the validation score read back and
    # both metrics on the host
    eval_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vbst.eval_valid()
        eval_ms.append((time.perf_counter() - t0) * 1e3)

    # chunk 4 equals chunk 1 bit for bit: 100k rows of the main path's data,
    # gradients rounded to multiples of 2^-7 (4c's rule), with the bag, the
    # feature masks and a validation set of 50k rows
    ds_vc = lgb.Dataset(X[:100_000], label=y[:100_000])
    objective_mod.BinaryLogloss.get_gradients = dyadic_gradients
    try:
        vc_runs = {}
        for c in (1, 4):
            b_ = lgb.Booster(dict(vparams, device_chunk_size=c), ds_vc)
            b_.add_valid(lgb.Dataset(Xv[:50_000], label=yv[:50_000]), "v")
            ran_ = 0
            while ran_ < 13:
                ran_ += b_.update_chunk(c if ran_ else 1)[0]
            vc_runs[c] = b_
    finally:
        objective_mod.BinaryLogloss.get_gradients = get_gradients
    assert vc_runs[4]._gbdt.device_chunk_fallback_reason() is None
    assert vc_runs[4].model_to_string().split("parameters:")[0] == \
        vc_runs[1].model_to_string().split("parameters:")[0], "chunk 4 trees != chunk 1"
    for read in (lambda b_: b_._gbdt.train_score(), lambda b_: b_._gbdt._valid_score_np(0)):
        assert read(vc_runs[4]).tobytes() == read(vc_runs[1]).tobytes(), "chunk 4 scores != chunk 1"
    del vc_runs, ds_vc

    # iterations/s in turns: the main path's graph booster (no validation set,
    # bag or mask) and this configuration's, a replay an iteration and
    # chunks of 5, evaluation excluded (its host time is eval_ms)
    vchunk = 5
    vkinds = {"plain_graph": (dict(TRAIN_PARAMS), 1, False),
              "valid_graph": (dict(vparams), 1, True),
              "valid_chunk": (dict(vparams, device_chunk_size=vchunk), vchunk, True)}
    vboosters = {}
    for kind, (params_, c, with_valid) in vkinds.items():
        vboosters[kind] = lgb.Booster(params_, train_set)
        if with_valid:
            vboosters[kind].add_valid(valid_set, "valid_0")
        assert bench_mod.train_iterations(vboosters[kind], 11, c) == 11
    valid_ips = {kind: [] for kind in vkinds}
    valid_turn_launches = {}
    # each turn also keeps the host's ms of each update_chunk call (a call
    # ends on its readback, so a call's ms is its iterations' wall time), the
    # allocator's cudaMalloc calls and Python's garbage collections (their
    # generation and ms) during the turn
    import gc

    turn_calls = []
    gc_log = []

    def on_gc(gc_phase, info):
        if gc_phase == "start":
            gc_log.append([info["generation"], time.perf_counter()])
        elif gc_log:
            gc_log[-1][1] = round((time.perf_counter() - gc_log[-1][1]) * 1e3, 3)

    def turn(b_, c):
        calls, done_ = [], 0
        mallocs = torch.cuda.memory_stats(dev).get("num_device_alloc", 0)
        gc_log.clear()
        while done_ < 10:
            t0_ = time.perf_counter()
            done_ += b_.update_chunk(min(c, 10 - done_))[0]
            calls.append(round((time.perf_counter() - t0_) * 1e3, 3))
        return done_, calls, torch.cuda.memory_stats(dev).get("num_device_alloc", 0) - mallocs

    gc.callbacks.append(on_gc)
    try:
        for kind in ("plain_graph", "valid_graph", "valid_chunk", "valid_chunk", "valid_graph",
                     "plain_graph") * 2:
            (ran, calls, mallocs), secs, got = counted(lambda: turn(vboosters[kind], vkinds[kind][1]))
            assert ran == 10, (kind, ran)
            valid_ips[kind].append(10 / secs)
            valid_turn_launches.setdefault(kind, got)
            turn_calls.append(dict(kind=kind, call_ms=calls, cuda_mallocs=mallocs,
                                   gc_generation_ms=[g_ for g_ in gc_log if g_[0] == 2 or g_[1] > 1]))
    finally:
        gc.callbacks.remove(on_gc)
    assert valid_turn_launches["plain_graph"] == turn_launches["graph"], valid_turn_launches
    assert valid_turn_launches["valid_graph"]["predict_bins"] == 10, valid_turn_launches
    # one profiled iteration (and one chunk): busy time, idle share and copies
    valid_prof = {}
    for kind, fn, n in (("valid_graph", vboosters["valid_graph"].update, 1),
                        ("valid_chunk", lambda: vboosters["valid_chunk"].update_chunk(vchunk), vchunk)):
        busy, kernels, copies_, timeline, named = profiled(fn)
        valid_prof[kind] = dict(
            device_busy_ms_per_iteration=busy / n, device_events=kernels, copies=copies_,
            timeline=timeline, iterations=n, kernels_ms_and_calls=named,
            predict_bins_ms_per_iteration=sum(
                v[0] for k, v in named.items() if "predict_bins_kernel" in k) / n,
            device_idle_share=[1 - busy / n * v / 1e3 for v in valid_ips[kind]] if busy else "not measured")
        # up: the chunk's feature masks; down: the ring
        assert copies_["HtoD"] <= 1 and copies_["DtoH"] == 1, (kind, copies_)
    for b_ in vboosters.values():
        assert b_._gbdt.captures == 1
    # a whole chunk with the bag draws, the mask upload and the validation
    # update, under sync debug mode "warn": the synchronizing calls it makes
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            vboosters["valid_chunk"].update_chunk(vchunk)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    chunk_syncs = sorted({str(w_.message)[:120] for w_ in caught if "ynchroniz" in str(w_.message)})
    # the bag draw alone: device time, and the host's time to queue it
    bag_out = torch.empty(N, device=dev)
    draw_host_us = []
    for it_ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        draw_bag(gv.config.bagging_seed, it_, N, bag_cnt, dev, out=bag_out)
        draw_host_us.append((time.perf_counter() - t0) * 1e6)
    bag_draw = dict(ms=time_ms(lambda: draw_bag(gv.config.bagging_seed, 7, N, bag_cnt, dev, out=bag_out)),
                    host_us_to_queue=draw_host_us)
    # the predict kernel at this run's shapes: the last tree of the state
    # over the validation set, against its plain version and its bound
    gs_v = vboosters["valid_graph"]._gbdt._grow_state
    pv_args = (vbins, gs_v.node_i[:gs_v.M - 1], gs_v.ctl[gs.NUM_LEAVES:gs.NUM_LEAVES + 1],
               gv.feature_meta, gs_v.leaf_f[:, 0].contiguous())
    pv_k, pv_p = torch.zeros(VALID_ROWS, device=dev), torch.zeros(VALID_ROWS, device=dev)
    predict_kernel.add_tree_value(*pv_args, pv_k)
    predict_plain.add_tree_value(*pv_args, pv_p)
    assert torch.equal(pv_k, pv_p)
    pv_bound, pv_by = bound(VALID_ROWS * (8 + mean_depth), 0)
    predict_t = dict(
        ms=time_ms(lambda: predict_kernel.add_tree_value(*pv_args, pv_k)),
        plain_ms=time_ms(lambda: predict_plain.add_tree_value(*pv_args, pv_p), reps=3),
        bound_ms=pv_bound, bound_by=pv_by, max_abs_err=0.0, library_ms=None,
        mean_depth=mean_depth, rows=VALID_ROWS,
    )
    del vboosters
    say("valid", rows=N, valid_rows=VALID_ROWS, params=VALID_PARAMS, rounds=VALID_ROUNDS,
        valid_binning_s=valid_bin_s, train_s=valid_train_s,
        train_iterations_per_s_with_eval=vbst.num_trees() / valid_train_s,
        best_iteration=vbst.best_iteration, trees=vbst.num_trees(),
        valid_auc_first_last_best=[valid_auc[0], valid_auc[-1], max(valid_auc)],
        launches=valid_launches, kernel_leaves_equal_plain=True, valid_scores_equal_plain_adds=True,
        bag_equals_cpu=True, bag_iterations_checked=gv.iter_ + 1, feature_masks_equal_numpy=True,
        chunk4_equals_chunk1=True,
        eval_boundary_host_ms=eval_ms, iterations_per_s=valid_ips, bag_draw=bag_draw,
        chunk_sync_warnings=chunk_syncs,
        launches_per_turn=valid_turn_launches, turn_calls=turn_calls, profile=valid_prof,
        predict_bins=predict_t)

    def hold_calls(steps_every=0, scan_every=None, each_pick=False):
        """Hold every call of each histogram kernel wrapper to its plain
        version on the same rows within the two-order bound, and every
        score_update to ``score.add_(value[leaf_ids])`` bit for bit, until
        the returned ``release()`` (which returns the counts, the worst
        ratio, the calls of the histograms' grouped form and the scores each
        score_update wrote): every tree, those after a flip included. With
        ``steps_every``, pick_partition and the folded scan of every such
        step of a tree (steps 0, steps_every, ...) also run against their
        plain versions on a copy of the state, the whole state equal (the
        membership words of the records and nodes included); with
        ``scan_every`` the scans (the root's too) at that stride instead.
        ``categorical`` counts the held calls on a state with categorical
        features, and the held picks that split a categorical feature. With
        ``each_pick``, every other pick_partition call is held too, on a
        copy of what a pick writes (the packed tree and control words, the
        leaves' sums and bounds, ``order``): those tensors equal."""
        plains = dict(histogram=leaf_histogram, hist_onehot=leaf_histogram,
                      hist_bitplane=leaf_histogram, hist_packed4_rows=leaf_histogram_packed4_rows)
        orig = {n: (hist_kernel, getattr(hist_kernel, n)) for n in plains}
        held = dict(checked=dict.fromkeys(plains, 0), worst_err_over_bound=0.0, grouped_calls=0,
                    score_rows=[], categorical=dict(calls=0, picks_of_categorical_features=0))

        def check(name, got, plain, values):
            ratio, err = err_over_bound(got, plain(values), plain(values.abs()))
            assert ratio <= 1.0, ("routed call off its plain version", name, held["checked"][name], err, ratio)
            held["checked"][name] += 1
            held["worst_err_over_bound"] = max(held["worst_err_over_bound"], ratio)

        def rows_call(name):
            def call(bins_, values, num_bins, rows=None, hist_dtype="float32", **kw):
                got = orig[name][1](bins_, values, num_bins, rows, hist_dtype, **kw)
                check(name, got, lambda v: plains[name](bins_, v, num_bins, rows, hist_dtype), values)
                held["grouped_calls"] += bool(kw.get("grouped"))
                return got
            return call

        # the packed form (pack4's input) goes through hist_packed4_rows too
        for name in plains:
            setattr(hist_kernel, name, rows_call(name))
        # the device loop's segment entry: its rows read back from the state
        orig["histogram_segment"] = (hist_kernel, hist_kernel.histogram_segment)
        held["checked"]["histogram_segment"] = 0

        def segment_call(st, parity=0):
            orig["histogram_segment"][1](st, parity)
            if int(st.ctl[gs.ACTIVE]):
                leaf = int(st.ctl[gs.SMALL])
                b0, cnt = int(st.leaf_begin[leaf]), int(st.leaf_count[leaf])
                rows = st.order[b0:b0 + cnt]
                check("histogram_segment", st.hist_out(parity),  # a bundled state's group rows
                      lambda v: leaf_histogram(st.hist_bins, v, st.hist_width, rows, st.hist_dtype),
                      st.values)
                held["grouped_calls"] += st.grouped
        hist_kernel.histogram_segment = segment_call

        orig["score_update"] = (grow_step_kernel, grow_step_kernel.score_update)
        held["checked"]["score_update"] = 0

        def score_call(st, value, score):
            want = score.clone().add_(value[grow_step_plain.leaf_ids(st)])
            orig["score_update"][1](st, value, score)
            assert torch.equal(score, want), ("score_update != plain", held["checked"]["score_update"])
            held["checked"]["score_update"] += 1
            held["score_rows"].append(score.data_ptr())
        grow_step_kernel.score_update = score_call

        def step_call(name, plain, every):
            kernel = orig[name][1]

            def call(st, *a):
                if (st.queued_steps - 1) % every:
                    if not (each_pick and name == "pick_partition"):
                        return kernel(st, *a)
                    light = gs.GrowState.__new__(gs.GrowState)
                    light.__dict__.update(st.__dict__)
                    light.packed = st.packed.clone()
                    (light.ctl, light.node_i, light.leaf_i, light.node_f, light.leaf_f,
                     light.node_b) = gs.unpack(light.packed, st.M, st.W)
                    for k_ in ("laux", "leaf_begin", "leaf_count", "order"):
                        setattr(light, k_, getattr(st, k_).clone())
                    kernel(st, *a)
                    plain(light, *a)
                    for k_ in ("packed", "laux", "leaf_begin", "leaf_count", "order"):
                        assert torch.equal(getattr(st, k_), getattr(light, k_)), (
                            "kernel != plain", name, k_, st.queued_steps - 1)
                    held["checked"]["pick_partition_each"] = held["checked"].get(
                        "pick_partition_each", 0) + 1
                    return None
                other = st.clone()
                kernel(st, *a)
                plain(other, *a)
                for k in gs.GrowState.STATE:  # NaN where both are NaN (an empty side's output)
                    a_, b_ = getattr(st, k), getattr(other, k)
                    assert torch.equal(a_, b_) or (a_.is_floating_point() and bool(
                        ((a_ == b_) | (a_.isnan() & b_.isnan())).all())), (
                        "kernel != plain", name, k, st.queued_steps - 1)
                held["checked"][name] += 1
                if st.is_cat is not None:
                    held["categorical"]["calls"] += 1
                    if name == "pick_partition" and int(st.ctl[gs.ACTIVE]):
                        f_ = int(st.node_i[int(st.ctl[gs.STEP]) - 1, 0])
                        held["categorical"]["picks_of_categorical_features"] += bool(st.is_cat[f_])
            return call

        if steps_every:
            scans = steps_every if scan_every is None else scan_every
            held_steps = [(partition_kernel, "pick_partition", plain_pick_partition, steps_every),
                          (split_kernel, "split_pair_fold", grow_step_plain.split_pair_fold, scans)]
            if scan_every is not None:
                held_steps.append((split_kernel, "split_pair_step", split_pair_step_plain, 1))
            for mod, name, plain, every in held_steps:
                orig[name] = (mod, getattr(mod, name))
                held["checked"][name] = 0
                setattr(mod, name, step_call(name, plain, every))

        # a bundled table's remaps (ops/remap_kernel.py): every call against
        # the plain remap bit for bit, the next step's group scratch cleared;
        # every root's and every 16th step's against the feature-space
        # histogram of the decoded rows: a cell other than the default bin's
        # within the two-order bound, the default bin's (the totals minus the
        # others) within the leaf's two-order bound plus the distance of the
        # totals it was given from the rows' own sum
        held["checked"]["remap"] = 0
        held["remap_dense"] = dict(checked=0, worst_err_over_bound=0.0)

        def dense_check(st, out, totals, rows):
            vals = operands(st.values if rows is None else st.values[rows.long()], st.hist_dtype)
            m_ = st.feature_meta
            want = torch.zeros_like(out)
            abs_ = torch.zeros_like(out)
            for f_ in range(st.F):
                col = st.bins[int(m_["group_id"][f_])]
                sub = remap_plain.decode_col(col if rows is None else col[rows.long()],
                                             int(m_["bin_offset"][f_]), int(m_["default_bin"][f_]),
                                             int(m_["num_bin"][f_]))
                want[f_].index_add_(0, sub, vals)
                abs_[f_].index_add_(0, sub, vals.abs())
            is_def = torch.zeros(out.shape[:2], dtype=torch.bool, device=out.device)
            is_def[torch.arange(st.F, device=out.device), m_["default_bin"].long()] = True
            err = (out - want).abs()
            cell = want[..., 2:] * 2.0 ** -23 * abs_ + 1e-6
            leaf = vals.shape[0] * 2.0 ** -23 * vals.abs().sum(0) + (totals - vals.sum(0)).abs() \
                + 1e-6
            ratio = float(torch.where(is_def[..., None], err / leaf, err / cell).max())
            assert ratio <= 1.0, ("remap off the decoded rows' histogram", ratio)
            held["remap_dense"]["checked"] += 1
            held["remap_dense"]["worst_err_over_bound"] = max(
                held["remap_dense"]["worst_err_over_bound"], ratio)

        def remap_call(name):
            kernel = getattr(remap_kernel, name)
            orig[name] = (remap_kernel, kernel)

            def call(st, *a):
                step = name == "remap_step"
                parity = a[0] if step else 1
                active = bool(int(st.ctl[gs.ACTIVE]))
                if active:
                    totals = st.laux[int(st.ctl[gs.SMALL]) if step else 0, :3].clone()
                    src = st.small_g[parity].clone()
                kernel(st, *a)
                if not active:
                    return
                out = st.small[parity] if step else st.hist[0]
                want = remap_plain.remap_hist(src, totals, st.feature_meta, st.B)
                assert torch.equal(out, want), ("efb_remap != plain", name, st.queued_steps)
                assert not bool(st.small_g[1 - parity].any()), (name, "group scratch not cleared")
                held["checked"]["remap"] += 1
                if not step or (st.queued_steps - 1) % 16 == 0:
                    dense_check(st, out, totals, small_rows(st) if step else None)
            return call

        for name in ("remap_step", "remap_root"):
            setattr(remap_kernel, name, remap_call(name))

        def release():
            for name, (mod, fn) in orig.items():
                setattr(mod, name, fn)
            return held
        return release

    def held_iterations(train_set_, params_, n, steps_every=16, scan_every=None, each_pick=False):
        """``n`` eager iterations of a new booster on ``train_set_`` under
        :func:`hold_calls` (its ``steps_every`` and ``scan_every``): every
        histogram call and score update held, and pick_partition and the
        folded scan at every ``steps_every``-th step of each tree (the scans
        at every ``scan_every``-th). Returns the booster's gbdt and what was
        held."""
        release_ = hold_calls(steps_every, scan_every, each_pick)
        try:
            b_ = lgb.Booster(dict(params_), train_set_)
            b_._gbdt.iteration_graph = False  # a replay calls no wrapper to hold
            for _ in range(n):
                b_.update()
        finally:
            held_ = release_()
        g_ = b_._gbdt
        K_ = g_.num_tree_per_iteration
        assert g_.grow_loop == "device" and b_.num_trees() == n * K_, b_.num_trees()
        ck = held_["checked"]
        assert ck["histogram"] == n * K_ and ck["histogram_segment"] > 0, ck
        assert ck["pick_partition"] > 0 and ck["split_pair_fold"] > 0, ck
        # one score update a class an iteration, each into its own row of the scores
        assert ck["score_update"] == n * K_, ck
        assert set(held_["score_rows"]) == {g_.scores[k].data_ptr() for k in range(K_)}, held_
        held_["grouped_adds"] = g_.grouped_adds
        held_["score_rows"] = len(set(held_["score_rows"]))
        return g_, held_

    # ---- 4e. regression: a YearPredictionMSD-shaped table -----------------------------
    # 463,715 x 90 dense f32 (the UCI train split's shape), synthetic values,
    # a held-out 51,630-row set of the same generator; 10 iterations through
    # the captured iteration with the held-out set's l2 at every boundary
    Xy, yy = year_like_rows(YEAR_ROWS, seed=21)
    Xyv, yyv = year_like_rows(YEAR_VALID_ROWS, seed=22)
    t0 = time.perf_counter()
    year_set = lgb.Dataset(Xy, label=yy)
    year_valid = lgb.Dataset(Xyv, label=yyv, reference=year_set)
    year_cfg = Config.from_params(dict(YEAR_PARAMS))
    year_set.get_binned(year_cfg)
    year_valid.get_binned(year_cfg)
    year_bin_s = time.perf_counter() - t0
    year_evals = {}
    ybst, year_train_s, year_launches = counted(lambda: lgb.train(
        dict(YEAR_PARAMS), year_set, 10, valid_sets=[year_valid], evals_result=year_evals,
        verbose_eval=False))
    gy = ybst._gbdt
    assert gy.grow_loop == "device" and gy.captures == 1 and ybst.num_trees() == 10, gy.captures
    assert all(year_launches.get(k, 0) > 0 for k in loop_kernels + ("predict_bins",)), year_launches
    # the quality guard: held-out l2 below half the constant training mean's
    year_l2 = year_evals["valid_0"]["l2"]
    const_l2 = float(np.mean((yyv - np.mean(yy)) ** 2))
    assert np.all(np.isfinite(year_l2)) and year_l2[-1] < 0.5 * const_l2, (year_l2, const_l2)
    yraw = ybst.predict(Xyv[:1000])
    assert yraw.shape == (1000,) and np.all(np.isfinite(yraw))
    # the captured iteration equals the eager launches, on 20,000 rows with
    # the gradients rounded to multiples of 2^-10: every histogram cell is
    # then exact (a cell's rows times twice the largest |gradient| stay below
    # 2^14, checked), so any summation order gives the same trees
    eq_rows = 20_000
    get_reg = objective_mod.RegressionL2Loss.get_gradients

    def reg_dyadic(self, score):
        g_, h_ = get_reg(self, score)
        return torch.round(g_ * 1024.0) / 1024.0, h_

    ds_eq = lgb.Dataset(Xy[:eq_rows], label=yy[:eq_rows])
    eq_bins = ds_eq.get_binned(year_cfg).bins
    cell_rows = max(int(np.bincount(b_).max()) for b_ in eq_bins)
    grad_max = float(np.abs(yy[:eq_rows] - np.mean(yy[:eq_rows])).max())
    assert cell_rows * 2 * grad_max < 2 ** 14, (cell_rows, grad_max)
    objective_mod.RegressionL2Loss.get_gradients = reg_dyadic
    try:
        year_eq = {}
        for kind, graph_on in (("eager", False), ("graph", True)):
            b_ = lgb.Booster(dict(YEAR_PARAMS), ds_eq)
            b_._gbdt.iteration_graph = graph_on
            assert bench_mod.train_iterations(b_, 4, 1) == 4
            year_eq[kind] = b_
    finally:
        objective_mod.RegressionL2Loss.get_gradients = get_reg
    assert year_eq["graph"]._gbdt.captures == 1
    assert year_eq["graph"].model_to_string().split("parameters:")[0] == \
        year_eq["eager"].model_to_string().split("parameters:")[0], "captured != eager (regression)"
    assert year_eq["graph"]._gbdt.train_score().tobytes() == year_eq["eager"]._gbdt.train_score().tobytes()
    del year_eq, ds_eq

    def objective_turns(train_set_, params_, chunk_, iters=10):
        """Three boosters (a replay an iteration, chunks of ``chunk_``, the
        eager launches) warmed up 10 iterations each, then 4c's turns
        (graph, chunk, eager, eager, chunk, graph) of ``iters`` iterations
        and a profiled replay and chunk (``turns_and_profile``)."""
        kinds = {"graph": (1, True), "chunk": (chunk_, True), "eager": (1, False)}
        bsts = {}
        for kind, (c, graph_on) in kinds.items():
            b_ = lgb.Booster(dict(params_, device_chunk_size=c), train_set_)
            b_._gbdt.iteration_graph = graph_on
            assert bench_mod.train_iterations(b_, 10, c) == 10, kind
            bsts[kind] = b_
        got = turns_and_profile(bsts, {k: v[0] for k, v in kinds.items()},
                                ("graph", "chunk", "eager", "eager", "chunk", "graph"),
                                ("graph", "chunk"), iters=iters)
        for b_ in bsts.values():
            assert b_._gbdt.captures == (0 if not b_._gbdt.iteration_graph else 1)
        return got

    # the kernels against their plain versions at this table's shape: two
    # eager iterations on all 463,715 rows with every histogram call and
    # score update held, pick_partition and the folded scan every 16th step
    _, year_held = held_iterations(year_set, YEAR_PARAMS, 2)
    year_ips, year_turn_launches, year_prof = objective_turns(year_set, YEAR_PARAMS, 10)
    say("regression", rows=YEAR_ROWS, features=YEAR_FEATURES, valid_rows=YEAR_VALID_ROWS,
        params=YEAR_PARAMS, binning_s=year_bin_s, train_s=year_train_s,
        train_iterations_per_s_with_eval=10 / year_train_s, launches=year_launches,
        valid_l2=year_l2, constant_mean_l2=const_l2, l2_over_constant=year_l2[-1] / const_l2,
        captured_equals_eager=dict(rows=eq_rows, iterations=4, cell_rows=cell_rows,
                                   largest_gradient=grad_max), held_calls=year_held,
        iterations_per_s=year_ips, launches_per_turn=year_turn_launches, profile=year_prof)
    del ybst, gy, Xy  # the binned table and the held-out set serve 4l too

    # ---- 4f. multiclass: a Covertype-shaped table, K = 7 trees an iteration ------------
    # 581,012 x 54 (10 continuous, 44 binary columns: features with 2 bins
    # beside 255-bin ones), 7 classes with Covertype's shares, synthetic
    # values; EFB off (not ported); a 100k-row validation set, multi_logloss
    # and multi_error at every boundary, early stopping 5, 10 iterations
    Xc, yc = covertype_like_rows(COVER_ROWS, seed=31)
    Xcv, ycv = covertype_like_rows(COVER_VALID_ROWS, seed=32)
    t0 = time.perf_counter()
    cover_set = lgb.Dataset(Xc, label=yc)
    cover_valid = lgb.Dataset(Xcv, label=ycv, reference=cover_set)
    cover_cfg = Config.from_params(dict(COVER_PARAMS))
    cover_binned = cover_set.get_binned(cover_cfg)
    cover_valid.get_binned(cover_cfg)
    cover_bin_s = time.perf_counter() - t0
    widths = sorted({int(m.num_bin) for m in cover_binned.mappers})
    assert 2 in widths and max(widths) == 255 and not cover_binned.is_bundled, widths
    K = COVER_PARAMS["num_class"]
    cover_evals = {}
    cbst, cover_train_s, cover_launches = counted(lambda: lgb.train(
        dict(COVER_PARAMS), cover_set, 10, valid_sets=[cover_valid], early_stopping_rounds=5,
        evals_result=cover_evals, verbose_eval=False))
    gc_ = cbst._gbdt
    assert gc_.grow_loop == "device" and gc_.captures == 1 and gc_.num_tree_per_iteration == K
    assert cbst.num_trees() == K * cbst.current_iteration, cbst.num_trees()
    assert all(cover_launches.get(k, 0) > 0 for k in loop_kernels + ("predict_bins",)), cover_launches
    # the quality guard: multi_error below the majority class's share and
    # multi_logloss below the prior's entropy
    prior = np.bincount(yc.astype(np.int64), minlength=K) / len(yc)
    entropy = float(-np.sum(prior * np.log(prior)))
    merr, mll = cover_evals["valid_0"]["multi_error"], cover_evals["valid_0"]["multi_logloss"]
    assert min(merr) < prior.max() and min(mll) < entropy, (merr, mll, prior, entropy)
    cprob = cbst.predict(Xcv[:1000])
    assert cprob.shape == (1000, K) and np.allclose(cprob.sum(1), 1.0)
    # each class's validation score equals the plain traversal's per-tree f32 adds
    cbins = gc_._valid_bins[0]
    plain_valid = torch.zeros((K, COVER_VALID_ROWS), device=dev)
    for k in range(K):
        plain_valid[k] += np.float32(gc_._init_fold[k])
    for i, ta in enumerate(gc_._tree_arrays):
        ptree = predict_plain.make_predict_tree(ta, gc_.feature_meta)
        plain_valid[i % K] += ptree.leaf_value[predict_plain.tree_predict_leaf(cbins, ptree)]
    assert plain_valid.double().cpu().numpy().tobytes() == gc_._valid_score_np(0).tobytes(), (
        "a class's validation score != the plain per-tree adds")
    # on 16,000 rows with gradients and hessians rounded to multiples of
    # 2^-10 (|g| < 1 and h <= 1/2: every histogram cell exact at 16,000
    # rows), the captured K-tree iteration equals K eager launch_tree calls
    # a class, and a chunk of 4 equals 4 single iterations
    get_mc = objective_mod.MulticlassSoftmax.get_gradients

    def mc_dyadic(self, score):
        g_, h_ = get_mc(self, score)
        return torch.round(g_ * 1024.0) / 1024.0, torch.clamp(torch.round(h_ * 1024.0), min=1.0) / 1024.0

    ds_mc = lgb.Dataset(Xc[:16_000], label=yc[:16_000])
    objective_mod.MulticlassSoftmax.get_gradients = mc_dyadic
    try:
        mc_eq = {}
        for kind, c, graph_on in (("eager", 1, False), ("graph", 1, True), ("chunk", 4, True)):
            b_ = lgb.Booster(dict(COVER_PARAMS, device_chunk_size=c), ds_mc)
            b_._gbdt.iteration_graph = graph_on
            assert bench_mod.train_iterations(b_, 9, c) == 9, kind
            mc_eq[kind] = b_
    finally:
        objective_mod.MulticlassSoftmax.get_gradients = get_mc
    mc_text = mc_eq["eager"].model_to_string().split("parameters:")[0]
    for kind, b_ in mc_eq.items():
        assert b_.num_trees() == 9 * K, (kind, b_.num_trees())
        assert b_.model_to_string().split("parameters:")[0] == mc_text, ("K trees differ", kind)
        assert b_._gbdt.train_score().tobytes() == mc_eq["eager"]._gbdt.train_score().tobytes(), kind
    assert mc_eq["graph"]._gbdt.captures == mc_eq["chunk"]._gbdt.captures == 1
    del mc_eq, ds_mc
    # the kernels against their plain versions at this table's shape: one
    # eager iteration (7 trees) on all 581,012 rows with every histogram
    # call and each class's score update (into scores[k]) held,
    # pick_partition and the folded scan every 16th step; the table takes
    # the histograms' grouped form (its 2-bin features), and the held calls
    # ran it
    held_g, cover_held = held_iterations(cover_set, COVER_PARAMS, 1)
    assert held_g.grouped_adds and cover_held["grouped_calls"] > 0, cover_held
    assert cover_held["score_rows"] == K, cover_held
    del held_g
    # turns of 5 iterations, as 4g's (the smoke's time is near its limit on a slow host)
    cover_ips, cover_turn_launches, cover_prof = objective_turns(cover_set, COVER_PARAMS, 10,
                                                                 iters=5)
    say("multiclass", rows=COVER_ROWS, features=54, valid_rows=COVER_VALID_ROWS, num_class=K,
        params=COVER_PARAMS, bin_widths=widths, binning_s=cover_bin_s, train_s=cover_train_s,
        train_iterations_per_s_with_eval=cbst.current_iteration / cover_train_s,
        iterations=cbst.current_iteration, best_iteration=cbst.best_iteration,
        launches=cover_launches, valid_multi_error=merr, valid_multi_logloss=mll,
        majority_share=float(prior.max()), prior_entropy=entropy,
        valid_scores_equal_plain_adds=True,
        captured_equals_eager_and_chunk4=dict(rows=16_000, iterations=9), held_calls=cover_held,
        iterations_per_s=cover_ips, launches_per_turn=cover_turn_launches, profile=cover_prof)
    del cbst, gc_, cover_set, cover_valid, Xc, yc, Xcv, ycv

    # ---- 4g. categorical: Covertype in its published form --------------------------
    # 581,012 x 12 (bench.covertype_compact_rows: 4f's rows with the two
    # one-hot groups as two integer columns), Wilderness_Area (4 values: the
    # one-hot branch) and Soil_Type (40: the CTR branch) categorical; K = 7,
    # 255 leaves, 255 bins, a 100k-row held-out set with multi_logloss and
    # multi_error, early stopping 5, 10 iterations in chunks of 10
    cat_params = dict(COVER_PARAMS, device_chunk_size=10)
    Xk, yk = covertype_compact_rows(COVER_ROWS, seed=31)
    Xkv, ykv = covertype_compact_rows(COVER_VALID_ROWS, seed=32)
    t0 = time.perf_counter()
    cat_set = lgb.Dataset(Xk, label=yk, categorical_feature=COVER_CATEGORICAL)
    cat_valid = lgb.Dataset(Xkv, label=ykv, reference=cat_set)
    cat_cfg = Config.from_params(dict(cat_params))
    cat_binned = cat_set.get_binned(cat_cfg)
    cat_valid.get_binned(cat_cfg)
    cat_bin_s = time.perf_counter() - t0
    cat_pos = [list(cat_binned.used_feature_idx).index(j) for j in COVER_CATEGORICAL]
    cat_bins = [int(cat_binned.mappers[f].num_bin) for f in cat_pos]
    branches = ["one-hot" if nb <= cat_cfg.max_cat_to_onehot else "ctr" for nb in cat_bins]
    assert branches == ["one-hot", "ctr"] and all(
        cat_binned.mappers[f].bin_type == 1 for f in cat_pos), (cat_bins, branches)
    cat_evals = {}
    kbst, cat_train_s, cat_launches = counted(lambda: lgb.train(
        dict(cat_params), cat_set, 10, valid_sets=[cat_valid], early_stopping_rounds=5,
        evals_result=cat_evals, verbose_eval=False))
    gk = kbst._gbdt
    assert gk.grow_loop == "device" and gk.captures == 1 and gk.num_words == 8, gk.captures
    assert kbst.num_trees() == K * kbst.current_iteration, kbst.num_trees()
    assert all(cat_launches.get(k, 0) > 0 for k in loop_kernels + ("predict_bins",)), cat_launches
    kprior = np.bincount(yk.astype(np.int64), minlength=K) / len(yk)
    kerr, kll = cat_evals["valid_0"]["multi_error"], cat_evals["valid_0"]["multi_logloss"]
    assert min(kerr) < kprior.max(), (kerr, kprior)
    # the first iteration's trees split the categorical features, a CTR node
    # among them with more than one category on its left
    first_cat = first_ctr = 0
    for ta in gk._tree_arrays[:K]:
        m_ = int(ta.num_leaves) - 1
        f_ = ta.split_feature[:m_].numpy()
        members = ta.cat_member[:m_].sum(1).numpy()
        first_cat += int(np.isin(f_, cat_pos).sum())
        first_ctr += int(((f_ == cat_pos[1]) & (members > 1)).sum())
    assert first_cat > 0 and first_ctr > 0, (first_cat, first_ctr)
    kprob = kbst.predict(Xkv[:1000])
    assert kprob.shape == (1000, K) and np.allclose(kprob.sum(1), 1.0)
    # each class's validation score (predict_bins' categorical nodes) equals
    # the plain traversal's per-tree f32 adds
    kbins = gk._valid_bins[0]
    plain_valid = torch.zeros((K, COVER_VALID_ROWS), device=dev)
    for k in range(K):
        plain_valid[k] += np.float32(gk._init_fold[k])
    for i, ta in enumerate(gk._tree_arrays):
        ptree = predict_plain.make_predict_tree(ta, gk.feature_meta)
        plain_valid[i % K] += ptree.leaf_value[predict_plain.tree_predict_leaf(kbins, ptree)]
    assert plain_valid.double().cpu().numpy().tobytes() == gk._valid_score_np(0).tobytes(), (
        "a class's validation score != the plain per-tree adds (categorical)")
    # the same run with the two columns read as numerical: its held-out
    # multi_logloss, recorded beside the categorical run's
    num_evals = {}
    lgb.train(dict(cat_params), lgb.Dataset(Xk, label=yk), 10,
              valid_sets=[lgb.Dataset(Xkv, label=ykv)], early_stopping_rounds=5,
              evals_result=num_evals, verbose_eval=False)
    # on 16,000 rows with gradients and hessians rounded to multiples of
    # 2^-10 (every histogram cell exact), the captured iteration equals the
    # eager launches and chunks of 4, and the host loop the device loop
    ds_kq = lgb.Dataset(Xk[:16_000], label=yk[:16_000], categorical_feature=COVER_CATEGORICAL)
    objective_mod.MulticlassSoftmax.get_gradients = mc_dyadic
    try:
        kq = {}
        for kind, c, graph_on in (("eager", 1, False), ("graph", 1, True), ("chunk", 4, True),
                                  ("host", 1, False)):
            b_ = lgb.Booster(dict(COVER_PARAMS, device_chunk_size=c), ds_kq)
            b_._gbdt.iteration_graph = graph_on
            if kind == "host":
                b_._gbdt.grow_loop = "host"
            assert bench_mod.train_iterations(b_, 9, c) == 9, kind
            kq[kind] = b_
    finally:
        objective_mod.MulticlassSoftmax.get_gradients = get_mc
    kq_text = kq["eager"].model_to_string().split("parameters:")[0]
    assert "cat_threshold=" in kq_text
    for kind, b_ in kq.items():
        assert b_.num_trees() == 9 * K, (kind, b_.num_trees())
        assert b_.model_to_string().split("parameters:")[0] == kq_text, ("categorical trees differ", kind)
        assert b_._gbdt.train_score().tobytes() == kq["eager"]._gbdt.train_score().tobytes(), kind
    assert kq["graph"]._gbdt.captures == kq["chunk"]._gbdt.captures == 1
    del kq, ds_kq
    # the kernels against their plain versions at this table's shape: one
    # eager iteration (7 trees) on all 581,012 rows, every histogram call,
    # score update and split scan (the root's and every step's folded one,
    # the membership words included) held, pick_partition every 16th step
    held_k, cat_held = held_iterations(cat_set, cat_params, 1, steps_every=16, scan_every=1)
    kck = cat_held["checked"]
    assert kck["split_pair_step"] == K, kck  # the root's scan of every class's tree
    assert cat_held["categorical"]["calls"] == sum(
        kck[n] for n in ("split_pair_step", "split_pair_fold", "pick_partition")), cat_held
    assert cat_held["categorical"]["picks_of_categorical_features"] > 0, cat_held

    # the categorical instantiations at this table's shapes: a state of
    # class 0's tree on the run's gradients, grown to step 16, then to the
    # first pick of a categorical split
    kgrad, khess = held_k._compute_gradients()
    kargs = (held_k.bins_dev, kgrad[0].contiguous(), khess[0].contiguous(), held_k.feature_mask,
             held_k.feature_meta, held_k.config.max_depth, held_k.split_params, held_k._two_way,
             held_k.bins_nf)
    ks = gs.GrowState(dev, COVER_ROWS, 12, held_k.num_bins, 255, held_k.num_words)
    grow_mod.start_tree(ks, *kargs)
    for _ in range(16):
        grow_mod.run_step(ks)
    ksf = ks.clone()
    partition_kernel.pick_partition(ksf)
    hist_kernel.histogram_segment(ksf, ksf.queued_steps % 2)
    kfold_t = held_and_timed(ksf, "split_pair_fold", *fold_kernel, time_ms)
    kcells = 12 * held_k.num_bins * 3
    ctr_bins = sum(int(held_k.feature_meta["num_bin"][f]) for f in cat_pos
                   if int(held_k.feature_meta["num_bin"][f]) > cat_cfg.max_cat_to_onehot)
    kfold_t.update(zip(("bound_ms", "bound_by"), bound(
        5 * kcells * 4 + 2 * 21 * 4 + 12 * 17 + 2 * 12 * 8 * 4,
        kcells + 2 * 12 * held_k.num_bins * 60 + 2 * ctr_bins ** 2)), library_ms=None,
        small_child_rows=int(small_rows(ksf).numel()))
    del ksf
    while True:  # the next pick that splits a categorical feature
        gains = ks.best_f[:, 0]
        if int(ks.best_i[int(torch.argmax(gains)), 0]) in cat_pos and float(gains.max()) > 0:
            break
        grow_mod.run_step(ks)
        assert int(ks.ctl[gs.ACTIVE]), "no categorical split to time"
    kpick_rows = pick_rows(ks)
    kpick_t = held_and_timed(ks, "pick_partition", partition_kernel.pick_partition,
                             plain_pick_partition, time_ms)
    kpick_t.update(zip(("bound_ms", "bound_by"), bound(255 * 4 + 320 + 8 * 4 + kpick_rows * 9, 0)),
                   library_ms=None, rows=kpick_rows, step=int(ks.ctl[gs.STEP]) - 1)
    del ks
    # the split scan's entry on one pair of this table's histograms, its
    # categorical blocks against the same features scanned as numerical
    gk_s = held_k._grow_state
    kh = gk_s.hist[:2].contiguous()
    ksums = kh[:, 0].sum(1).contiguous()
    kcons = torch.tensor([[-np.inf, np.inf]] * 2, device=dev)
    meta_num = {k_: v for k_, v in held_k.feature_meta.items() if k_ != "is_categorical"}
    meta_none = dict(held_k.feature_meta, is_categorical=torch.zeros_like(
        held_k.feature_meta["is_categorical"]))
    scan_us = {}
    for key, mt in (("categorical_blocks", held_k.feature_meta),
                    ("numerical_blocks_of_the_categorical_instantiation", meta_none),
                    ("numerical_instantiation", meta_num)):
        got = split_kernel.find_best_split_pair(kh, ksums, kcons, mt, held_k.feature_mask,
                                                held_k.split_params)
        want = find_best_split_pair(kh, ksums, kcons, mt, held_k.feature_mask, held_k.split_params)
        assert all(torch.equal(a_.nan_to_num(), b_.nan_to_num()) for a_, b_ in zip(got, want)), (
            "scan != plain", key)
        scan_us[key] = 1e3 * time_ms(lambda mt=mt: split_kernel.find_best_split_pair(
            kh, ksums, kcons, mt, held_k.feature_mask, held_k.split_params))
    # predict_bins over the held-out set through the last tree of the run
    kpv_args = (kbins, gk_s.node_i[:gk_s.M - 1], gk_s.ctl[gs.NUM_LEAVES:gs.NUM_LEAVES + 1],
                held_k.feature_meta, gk_s.leaf_f[:, 0].contiguous())
    kpv_k = torch.zeros(COVER_VALID_ROWS, device=dev)
    kpv_p = torch.zeros(COVER_VALID_ROWS, device=dev)
    predict_kernel.add_tree_value(*kpv_args, kpv_k, node_b=gk_s.node_b)
    predict_plain.add_tree_value(*kpv_args, kpv_p, node_b=gk_s.node_b)
    assert torch.equal(kpv_k, kpv_p)
    kdepth = float(np.mean([float(ta.leaf_depth[:int(ta.num_leaves)].float().mean())
                            for ta in gk._tree_arrays]))
    kpredict_t = dict(
        ms=time_ms(lambda: predict_kernel.add_tree_value(*kpv_args, kpv_k, node_b=gk_s.node_b)),
        plain_ms=time_ms(lambda: predict_plain.add_tree_value(*kpv_args, kpv_p,
                                                              node_b=gk_s.node_b), reps=3),
        max_abs_err=0.0, library_ms=None, mean_depth=kdepth, rows=COVER_VALID_ROWS)
    kpredict_t.update(zip(("bound_ms", "bound_by"), bound(
        COVER_VALID_ROWS * (8 + kdepth) + 254 * (20 + 32), 0)))
    del held_k, gk_s, kh
    # turns of 5 iterations (the phase is the smoke's longest; every check kept)
    kips, kturn_launches, kprof = objective_turns(cat_set, cat_params, 10, iters=5)
    cat_t = {"split_pair_fold_categorical": kfold_t, "pick_partition_categorical": kpick_t,
             "predict_bins_categorical": kpredict_t}
    say("categorical", rows=COVER_ROWS, features=12, categorical_features=COVER_CATEGORICAL,
        num_bins=cat_bins, branches=branches, valid_rows=COVER_VALID_ROWS, num_class=K,
        params=cat_params, binning_s=cat_bin_s, train_s=cat_train_s,
        train_iterations_per_s_with_eval=kbst.current_iteration / cat_train_s,
        iterations=kbst.current_iteration, best_iteration=kbst.best_iteration,
        launches=cat_launches, valid_multi_error=kerr, valid_multi_logloss=kll,
        numerical_read_valid_multi_logloss=num_evals["valid_0"]["multi_logloss"],
        majority_share=float(kprior.max()), first_iteration_nodes=dict(
            categorical=first_cat, ctr_more_than_one_category=first_ctr),
        valid_scores_equal_plain_adds=True,
        captured_equals_eager_chunk4_and_host=dict(rows=16_000, iterations=9),
        held_calls=cat_held, split_scan_us_per_call=scan_us, kernels=cat_t,
        iterations_per_s=kips, launches_per_turn=kturn_launches, profile=kprof)
    # phase 8b serves this model from its text, on held-out rows of it
    cat_model_text, cat_rows = kbst.model_to_string(), Xkv[:20_000].copy()
    del kbst, gk, cat_set, cat_valid, Xk, yk, Xkv, ykv

    # ---- 4h. Covertype as a sparse matrix: EFB-bundled -------------------------------
    # 4f's rows as a scipy CSR matrix, 4f's parameters with the default
    # enable_bundle and max_conflict_rate: the 10 continuous columns alone,
    # Wilderness (4 one-hot columns) in a group of 5 bins, Soil (40) in one
    # of 41: G = 12; K = 7, 255 leaves, max_bin 255, a 100k-row held-out CSR
    # set, early stopping 5, 10 iterations
    import scipy.sparse as sparse

    efb_params = {k_: v_ for k_, v_ in COVER_PARAMS.items() if k_ != "enable_bundle"}
    cover_ll = mll[-1]  # 4f's held-out multi_logloss at its last iteration
    hXd, hy = covertype_like_rows(COVER_ROWS, seed=31)
    hXvd, hyv = covertype_like_rows(COVER_VALID_ROWS, seed=32)
    t0 = time.perf_counter()
    hX, hXv = sparse.csr_matrix(hXd), sparse.csr_matrix(hXvd)
    h_set = lgb.Dataset(hX, label=hy)
    h_valid = lgb.Dataset(hXv, label=hyv, reference=h_set)
    h_cfg = Config.from_params(dict(efb_params))
    h_binned = h_set.get_binned(h_cfg)
    h_valid.get_binned(h_cfg)
    h_bin_s = time.perf_counter() - t0

    def group_widths(b_):
        """Each group's width (its last member's offset + contributed bins)."""
        w_ = {}
        for f_, m_ in enumerate(b_.mappers):
            g_ = int(b_.group_id[f_])
            w_[g_] = max(w_.get(g_, 0), int(b_.bin_offset[f_]) + m_.num_bin - 1)
        return [w_[g_] for g_ in sorted(w_)]

    h_widths = group_widths(h_binned)
    assert h_binned.is_bundled and h_binned.num_groups == 12, h_widths
    assert sorted(h_widths)[:2] == [5, 41] and h_binned.max_group_bins == max(h_widths), h_widths
    h_evals = {}
    hbst, h_train_s, h_launches = counted(lambda: lgb.train(
        dict(efb_params), h_set, 10, valid_sets=[h_valid], early_stopping_rounds=5,
        evals_result=h_evals, verbose_eval=False))
    gh_ = hbst._gbdt
    assert gh_.grow_loop == "device" and gh_.captures == 1 and gh_.num_groups == 12, gh_.captures
    assert hbst.num_trees() == K * hbst.current_iteration, hbst.num_trees()
    assert all(h_launches.get(k_, 0) > 0 for k_ in loop_kernels + ("predict_bins", "efb_remap")), (
        h_launches)
    herr, hll = h_evals["valid_0"]["multi_error"], h_evals["valid_0"]["multi_logloss"]
    hprior = np.bincount(hy.astype(np.int64), minlength=K) / len(hy)
    assert min(herr) < hprior.max(), (herr, hprior)
    # the same data bundled exactly: the held-out multi_logloss within 1% of 4f's
    assert abs(hll[-1] - cover_ll) <= 0.01 * cover_ll, (hll, cover_ll)
    hprob = hbst.predict(hXv[:1000])
    assert hprob.shape == (1000, K) and np.allclose(hprob.sum(1), 1.0)
    assert np.array_equal(hprob, hbst.predict(hXvd[:1000])), "CSR and dense predictions differ"

    def valid_equals_plain_adds(g_, nv):
        """Each class's validation score (the bundled predict_bins nodes)
        equals the plain traversal's per-tree f32 adds, bit for bit."""
        vb = g_._valid_bins[0]
        K_ = g_.num_tree_per_iteration
        want_ = torch.zeros((K_, nv), device=dev)
        for k_ in range(K_):
            want_[k_] += np.float32(g_._init_fold[k_])
        for i_, ta in enumerate(g_._tree_arrays):
            ptree = predict_plain.make_predict_tree(ta, g_.feature_meta)
            want_[i_ % K_] += ptree.leaf_value[predict_plain.tree_predict_leaf(vb, ptree)]
        assert want_.double().cpu().numpy().tobytes() == g_._valid_score_np(0).tobytes(), (
            "a validation score != the plain per-tree adds (bundled)")

    valid_equals_plain_adds(gh_, COVER_VALID_ROWS)
    # on 16,000 rows with gradients and hessians rounded to multiples of
    # 2^-10 (every histogram cell exact, the remapped default rows too), the
    # replays, the eager launches, chunks of 4 and the host loop give one
    # model text, and their trees equal those of the dense array's run (no
    # bundles) node for node
    ds_hq = lgb.Dataset(hX[:16_000], label=hy[:16_000])
    ds_hd = lgb.Dataset(hXd[:16_000], label=hy[:16_000])
    objective_mod.MulticlassSoftmax.get_gradients = mc_dyadic
    try:
        hq = {}
        for kind, ds_, c, graph_on in (("eager", ds_hq, 1, False), ("graph", ds_hq, 1, True),
                                       ("chunk", ds_hq, 4, True), ("host", ds_hq, 1, False),
                                       ("dense", ds_hd, 1, False)):
            b_ = lgb.Booster(dict(efb_params, device_chunk_size=c), ds_)
            b_._gbdt.iteration_graph = graph_on
            if kind == "host":
                b_._gbdt.grow_loop = "host"
            assert bench_mod.train_iterations(b_, 9, c) == 9, kind
            hq[kind] = b_
    finally:
        objective_mod.MulticlassSoftmax.get_gradients = get_mc
    assert hq["eager"]._gbdt.num_groups and not hq["dense"]._gbdt.num_groups
    hq_text = hq["eager"].model_to_string().split("parameters:")[0]
    for kind, b_ in hq.items():
        assert b_.num_trees() == 9 * K, (kind, b_.num_trees())
        if kind != "dense":
            assert b_.model_to_string().split("parameters:")[0] == hq_text, ("bundled trees differ",
                                                                              kind)
            assert b_._gbdt.train_score().tobytes() == hq["eager"]._gbdt.train_score().tobytes()
    for ta, tb_ in zip(hq["eager"]._gbdt._tree_arrays, hq["dense"]._gbdt._tree_arrays):
        for name in ("num_leaves", "split_feature", "threshold_bin", "default_left", "left_child",
                     "right_child", "leaf_count", "leaf_value", "internal_count"):
            assert torch.equal(getattr(ta, name), getattr(tb_, name)), ("bundled != dense", name)
    assert hq["graph"]._gbdt.captures == hq["chunk"]._gbdt.captures == 1
    del hq, ds_hq, ds_hd

    def bundled_kernels(g_, held_g, n_valid):
        """The three bundled kernels at a table's shapes, against their plain
        versions and timed: pick_partition and efb_remap at step 16 of a
        tree of ``held_g``'s first class on its gradients (a state of its
        own), predict_bins over the held-out set of the trained booster
        ``g_`` through its last tree."""
        cfg_ = held_g.config
        grad_, hess_ = held_g._compute_gradients()
        F_, G_, Bg_, B_ = held_g.train_set.num_features, held_g.num_groups, held_g.hist_width, \
            held_g.num_bins
        st = gs.GrowState(dev, held_g.num_data, F_, B_, cfg_.num_leaves, held_g.num_words, G_, Bg_)
        grow_mod.start_tree(st, held_g.bins_dev, grad_[0].contiguous(), hess_[0].contiguous(),
                            held_g.feature_mask, held_g.feature_meta, cfg_.max_depth,
                            held_g.split_params, held_g._two_way, held_g.bins_nf,
                            cfg_.tpu_hist_dtype, None, held_g.grouped_adds)
        for _ in range(16):
            grow_mod.run_step(st)
        parity = st.queued_steps % 2
        st.queued_steps += 1
        rows_ = pick_rows(st)
        pick_t = held_and_timed(st, "pick_partition", partition_kernel.pick_partition,
                                plain_pick_partition, time_ms)
        pick_t.update(zip(("bound_ms", "bound_by"), bound(
            cfg_.num_leaves * 4 + 24 * F_ + 8 * 4 + rows_ * 9, 0)), library_ms=None, rows=rows_,
            step=int(st.ctl[gs.STEP]) - 1)
        hist_kernel.histogram_segment(st, parity)
        remap_t = held_and_timed(st, "efb_remap", lambda s_: remap_kernel.remap_step(s_, parity),
                                 lambda s_: remap_plain.remap_step(s_, parity), time_ms)
        cells_g, cells_f = G_ * Bg_ * 3, F_ * B_ * 3
        remap_t.update(zip(("bound_ms", "bound_by"), bound(
            2 * cells_g * 4 + cells_f * 4 + 16 * F_ + 20, F_ * remap_plain.SLOTS * 3)))
        # the nearest single call: one index_select of the group rows by the plan
        m_ = held_g.feature_meta
        s_iota = torch.arange(B_, device=dev)[None, :]
        d_ = m_["default_bin"].long()[:, None]
        valid_ = (s_iota < m_["num_bin"].long()[:, None]) & (s_iota != d_)
        flat = torch.where(valid_, m_["group_id"].long()[:, None] * Bg_
                           + m_["bin_offset"].long()[:, None] + s_iota - (s_iota > d_).long(),
                           0).reshape(-1)
        rows_g = st.small_g[parity].view(-1, 3)
        remap_t["library_ms"] = time_ms(lambda: torch.index_select(rows_g, 0, flat))
        remap_t["library_call"] = "torch.index_select of the [G*Bg, 3] rows by the [F*B] plan"
        remap_t.update(small_child_rows=int(small_rows(st).numel()), features=F_, groups=G_,
                       group_width=Bg_, num_bins=B_)
        del st
        # predict_bins' bundled instantiation over the held-out set
        gs_ = g_._grow_state
        vb = g_._valid_bins[0]
        pv_args = (vb, gs_.node_i[:gs_.M - 1], gs_.ctl[gs.NUM_LEAVES:gs.NUM_LEAVES + 1],
                   g_.feature_meta, gs_.leaf_f[:, 0].contiguous())
        nb_ = gs_.node_b if g_.num_words else None
        pk_ = torch.zeros(n_valid, device=dev)
        pp_ = torch.zeros(n_valid, device=dev)
        predict_kernel.add_tree_value(*pv_args, pk_, node_b=nb_)
        predict_plain.add_tree_value(*pv_args, pp_, node_b=nb_)
        assert torch.equal(pk_, pp_), "predict_bins (bundled) != plain"
        depth = float(np.mean([float(ta.leaf_depth[:int(ta.num_leaves)].float().mean())
                               for ta in g_._tree_arrays]))
        predict_t = dict(
            ms=time_ms(lambda: predict_kernel.add_tree_value(*pv_args, pk_, node_b=nb_)),
            plain_ms=time_ms(lambda: predict_plain.add_tree_value(*pv_args, pp_, node_b=nb_),
                             reps=3),
            max_abs_err=0.0, library_ms=None, mean_depth=depth, rows=n_valid, columns=G_)
        predict_t.update(zip(("bound_ms", "bound_by"), bound(
            n_valid * (8 + depth) + (cfg_.num_leaves - 1) * (20 + 4 * g_.num_words) + 8 * F_, 0)))
        return {"efb_remap": remap_t, "pick_partition_bundled": pick_t,
                "predict_bins_bundled": predict_t}

    # the kernels against their plain versions at this table's shapes: one
    # eager iteration (7 trees) on all 581,012 rows, every histogram call,
    # score update, remap and pick held (the whole state at every 16th
    # pick, what a pick writes at the others), the folded scan every 16th
    # step
    held_h, h_held = held_iterations(h_set, efb_params, 1, steps_every=16, scan_every=16,
                                     each_pick=True)
    hck = h_held["checked"]
    assert hck["remap"] > K, hck  # every tree's root and steps
    assert hck["pick_partition"] > 0 and hck["pick_partition_each"] > 0, h_held
    assert h_held["remap_dense"]["checked"] > 0, h_held
    h_kernels = bundled_kernels(gh_, held_h, COVER_VALID_ROWS)
    del held_h
    hips, hturn_launches, hprof = objective_turns(h_set, efb_params, 10, iters=5)  # as 4f's
    say("sparse_covertype", rows=COVER_ROWS, columns=54, groups=h_binned.num_groups,
        max_group_bins=h_binned.max_group_bins, group_widths=h_widths,
        valid_rows=COVER_VALID_ROWS, num_class=K, params=efb_params, binning_s=h_bin_s,
        train_s=h_train_s, train_iterations_per_s_with_eval=hbst.current_iteration / h_train_s,
        iterations=hbst.current_iteration, best_iteration=hbst.best_iteration,
        launches=h_launches, valid_multi_error=herr, valid_multi_logloss=hll,
        dense_4f_valid_multi_logloss=cover_ll, majority_share=float(hprior.max()),
        valid_scores_equal_plain_adds=True,
        dyadic_equal_across_loops_and_to_dense=dict(rows=16_000, iterations=9),
        held_calls=h_held, kernels=h_kernels, iterations_per_s=hips,
        launches_per_turn=hturn_launches, profile=hprof)
    bundled_launches = dict(h_launches)
    # phase 8f bins these rows again at max_bin 1024 (the CSR rows and 100k held-out ones)
    cover_rows = (hX, hy, hXv[:COVER_VALID_ROWS], hyv[:COVER_VALID_ROWS])
    del hbst, gh_, h_set, h_valid, hXv, hXd, hXvd, hy, hyv, hX

    # ---- 4i. a wide one-hot table, Flight-Delay-shaped: F >> G ------------------------
    # bench.flight_like_rows: 1,000,000 x 674 CSR (one-hot Month, DayofMonth,
    # DayOfWeek, UniqueCarrier, Origin 300, Dest 300, then DepTime and
    # Distance; the paper's 10M training rows cut to 1M), binary, 255
    # leaves, max_bin 255, 10 iterations, a 100k-row held-out set
    t0 = time.perf_counter()
    fX, fy = flight_like_rows(FLIGHT_ROWS, seed=41)
    fXv, fyv = flight_like_rows(FLIGHT_VALID_ROWS, seed=42)
    f_gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    f_set = lgb.Dataset(fX, label=fy)
    f_valid = lgb.Dataset(fXv, label=fyv, reference=f_set)
    f_cfg = Config.from_params(dict(FLIGHT_PARAMS))
    f_binned = f_set.get_binned(f_cfg)
    f_valid.get_binned(f_cfg)
    f_bin_s = time.perf_counter() - t0
    f_widths = group_widths(f_binned)
    assert f_binned.is_bundled and f_binned.num_features == FLIGHT_COLUMNS, f_binned.num_features
    assert 8 <= f_binned.num_groups <= 12, f_widths
    f_evals = {}
    fbst, f_train_s, f_launches = counted(lambda: lgb.train(
        dict(FLIGHT_PARAMS), f_set, 10, valid_sets=[f_valid], evals_result=f_evals,
        verbose_eval=False))
    gf = fbst._gbdt
    assert gf.grow_loop == "device" and gf.captures == 1 and fbst.num_trees() == 10, gf.captures
    assert all(f_launches.get(k_, 0) > 0 for k_ in loop_kernels + ("predict_bins", "efb_remap")), (
        f_launches)
    f_auc = f_evals["valid_0"]["auc"]
    assert f_auc[-1] > 0.7, f_auc
    fraw = fbst.predict(fXv[:1000], raw_score=True)
    assert fraw.shape == (1000,) and np.all(np.isfinite(fraw))
    valid_equals_plain_adds(gf, FLIGHT_VALID_ROWS)
    pool_bytes = gf._grow_state.hist.numel() * 4
    held_f, f_held = held_iterations(f_set, FLIGHT_PARAMS, 1, steps_every=64, scan_every=64,
                                     each_pick=True)
    assert f_held["checked"]["remap"] > 0 and f_held["remap_dense"]["checked"] > 0, f_held
    f_kernels = bundled_kernels(gf, held_f, FLIGHT_VALID_ROWS)
    del held_f
    fips, fturn_launches, fprof = objective_turns(f_set, FLIGHT_PARAMS, 10)
    say("sparse_flight", rows=FLIGHT_ROWS, columns=FLIGHT_COLUMNS, groups=f_binned.num_groups,
        max_group_bins=f_binned.max_group_bins, group_widths=f_widths,
        valid_rows=FLIGHT_VALID_ROWS, params=FLIGHT_PARAMS, generate_s=f_gen_s,
        binning_s=f_bin_s, train_s=f_train_s, train_iterations_per_s_with_eval=10 / f_train_s,
        launches=f_launches, valid_auc=f_auc, valid_binary_logloss=f_evals["valid_0"][
            "binary_logloss"], valid_scores_equal_plain_adds=True, pool_bytes=pool_bytes,
        held_calls=f_held, kernels=f_kernels, iterations_per_s=fips,
        launches_per_turn=fturn_launches, profile=fprof)
    for k_, v_ in f_launches.items():
        bundled_launches[k_] = bundled_launches.get(k_, 0) + v_
    flight_set = f_set  # phase 8f trains it again under a pool, on the same bins
    del fbst, gf, f_set, f_valid, fX, fy, fXv, fyv

    # ---- 4j. boosting modes: GOSS, DART and random forest -------------------------------
    # the main path's table (1M x 28, binary, 255 leaves, max_bin 255) with
    # 4d's 500k-row held-out set and AUC at every boundary: GOSS (top_rate
    # 0.2, other_rate 0.1 at learning_rate 0.1: 10 iterations of warm-up,
    # then 10 sampled), DART (its defaults) and random forest (bagging 0.8
    # every iteration, feature_fraction 0.8); a mode runs one replay an
    # iteration (no chunks, as in the JAX package), its host work between
    from lightgbm_tpu_torch.models.gbdt import draw_permutation
    from lightgbm_tpu_torch.models.goss import goss_mask_amp

    mode_params = {
        "goss": (dict(TRAIN_PARAMS, boosting="goss", top_rate=0.2, other_rate=0.1), 20),
        "dart": (dict(TRAIN_PARAMS, boosting="dart"), 20),
        "rf": (dict(TRAIN_PARAMS, boosting="rf", bagging_fraction=0.8, bagging_freq=1,
                    feature_fraction=0.8), 10),
    }
    mode_class = {"goss": "GOSS", "dart": "DART", "rf": "RandomForest"}

    def tree_args(ta):
        """A host tree's nodes, leaf count and leaf values on the card, as
        GBDT._add_tree hands them to predict_bins."""
        nl = int(ta.num_leaves)
        nodes = torch.stack([ta.split_feature, ta.threshold_bin, ta.left_child, ta.right_child,
                             ta.default_left.to(torch.int32)], 1)[:max(nl - 1, 0)]
        return (nodes.to(dev, torch.int32).contiguous(),
                torch.tensor([nl], dtype=torch.int32, device=dev), ta.leaf_value.to(dev))

    modes = {}
    for mode, (params_, rounds_) in mode_params.items():
        evals_m, drops_m = {}, []

        def on_iteration(env, drops_m=drops_m):
            drops_m.append(list(getattr(env.model._gbdt, "drop_index", ())))

        bst_m, secs_m, launches_m = counted(lambda: lgb.train(
            dict(params_), train_set, rounds_, valid_sets=[valid_set], evals_result=evals_m,
            verbose_eval=False, callbacks=[on_iteration]))
        g_m = bst_m._gbdt
        assert type(g_m).__name__ == mode_class[mode] and g_m.grow_loop == "device"
        assert bst_m.num_trees() == rounds_ and g_m.captures == (2 if mode == "goss" else 1), (
            mode, bst_m.num_trees(), g_m.captures)
        assert all(launches_m.get(k_, 0) > 0 for k_ in loop_kernels + ("predict_bins",)), launches_m
        auc_m = evals_m["valid_0"]["auc"]
        assert auc_m[-1] > 0.7, (mode, auc_m)
        vraw = bst_m.predict(Xv[:1000], raw_score=True)
        assert vraw.shape == (1000,) and np.all(np.isfinite(vraw))
        # the train scores equal the kept trees' raw prediction (DART's
        # rescaled, random forest's averaged)
        np.testing.assert_allclose(g_m.train_score(), bst_m.predict(X, raw_score=True),
                                   rtol=1e-5, atol=1e-5)
        rec = dict(rounds=rounds_, train_s=secs_m, launches=launches_m, valid_auc=auc_m,
                   train_iterations_per_s_with_eval=rounds_ / secs_m)
        if mode == "goss":
            top_k, other_k = g_m._goss_k
            assert (top_k, other_k) == (N // 5, N // 10), g_m._goss_k
            # one more sampled iteration under sync debug mode "warn": the
            # gradients at the scores before it, then its replay; the bag and
            # amplification it wrote against the same selection on the CPU
            it_ = g_m.iter_
            grad_d, hess_d = g_m._compute_gradients()
            grad_c, hess_c = grad_d.cpu(), hess_d.cpu()
            perm_c = draw_permutation(g_m.config.bagging_seed, it_, N - top_k, "cpu")
            torch.cuda.synchronize()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    assert not bst_m.update()
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            mask_c, amp_c = goss_mask_amp(grad_c, hess_c, perm_c, top_k, other_k)
            assert torch.equal(g_m._goss_perm.cpu(), perm_c), "GOSS permutation != the CPU's"
            assert torch.equal(g_m._goss_mask.cpu(), mask_c), "GOSS bag != the CPU's"
            assert torch.equal(g_m._goss_amp.cpu(), amp_c), "GOSS amplification != the CPU's"
            assert int(g_m._goss_mask.sum()) == top_k + other_k
            sel_mask, sel_amp = torch.empty_like(g_m._goss_mask), torch.empty_like(g_m._goss_amp)
            rec.update(
                top_k=top_k, other_k=other_k, bag_equals_cpu=True,
                replay_sync_warnings=sorted({str(w_.message)[:120] for w_ in caught
                                             if "ynchroniz" in str(w_.message)
                                             and "prototype" not in str(w_.message)}),
                selection_ms=time_ms(lambda: goss_mask_amp(grad_d, hess_d, g_m._goss_perm, top_k,
                                                           other_k, sel_mask, sel_amp)),
                permutation_draw_ms=time_ms(lambda: draw_permutation(
                    g_m.config.bagging_seed, it_, N - top_k, dev)))
            del grad_d, hess_d, sel_mask, sel_amp
        if mode == "dart":
            # every tree a drop took out: predict_bins over the 1M training
            # rows against its plain version; the calls an iteration are one
            # validation add and three a dropped tree (out of the training
            # scores, out of the validation scores, back into the training)
            dropped = sorted({i_ for d_ in drops_m for i_ in d_})
            assert dropped, "DART dropped no tree"
            got_p, want_p = torch.zeros(N, device=dev), torch.zeros(N, device=dev)
            for i_ in dropped:
                args_ = tree_args(g_m._tree_arrays[i_])
                got_p.zero_()
                want_p.zero_()
                predict_kernel.add_tree_value(g_m.bins_nf, args_[0], args_[1], g_m.feature_meta,
                                              args_[2], got_p)
                predict_plain.add_tree_value(g_m.bins_nf, args_[0], args_[1], g_m.feature_meta,
                                             args_[2], want_p)
                assert torch.equal(got_p, want_p), ("predict_bins != plain on a dropped tree", i_)
            n_drops = sum(len(d_) for d_ in drops_m)
            assert launches_m["predict_bins"] == rounds_ + 3 * n_drops, (launches_m, drops_m)
            args_ = tree_args(g_m._tree_arrays[dropped[0]])
            rec.update(
                drops_per_iteration=[len(d_) for d_ in drops_m], dropped_trees=dropped,
                dropped_predict_equals_plain=True,
                predict_bins_calls_per_iteration=launches_m["predict_bins"] / rounds_,
                predict_bins_train_rows_calls_per_iteration=2 * n_drops / rounds_,
                predict_bins_train_rows_us=1e3 * time_ms(lambda: predict_kernel.add_tree_value(
                    g_m.bins_nf, args_[0], args_[1], g_m.feature_meta, args_[2], got_p)),
                tree_weight=g_m.tree_weight)
            del got_p, want_p
        if mode == "rf":
            assert "\naverage_output\n" in bst_m.model_to_string()
            trees_m = g_m.trees()
            assert all(t.shrinkage == 1.0 for t in trees_m)
            want_avg = sum(t.predict_fast(X[:1000]) for t in trees_m) / len(trees_m)
            np.testing.assert_allclose(bst_m.predict(X[:1000], raw_score=True), want_avg,
                                       rtol=1e-12, atol=1e-12)
            rec.update(prediction_is_average=True, average_output_in_text=True)
        modes[mode] = rec
        del bst_m, g_m

    # the replays equal the eager launches: 100k rows of the main path's data
    # with 4c's gradients rounded to multiples of 2^-7 (every histogram sum
    # exact: |g| < 1, times GOSS's 8 on 10k rows, over 100k rows stays below
    # 2^17), a 50k-row validation set, 14 iterations (4 of them sampled by GOSS)
    ds_m = lgb.Dataset(X[:100_000], label=y[:100_000])
    objective_mod.BinaryLogloss.get_gradients = dyadic_gradients
    try:
        for mode, (params_, _) in mode_params.items():
            same = {}
            for kind, graph_on in (("eager", False), ("graph", True)):
                b_ = lgb.Booster(dict(params_), ds_m)
                b_.add_valid(lgb.Dataset(Xv[:50_000], label=yv[:50_000]), "v")
                b_._gbdt.iteration_graph = graph_on
                assert bench_mod.train_iterations(b_, 14, 1) == 14
                same[kind] = (b_.model_to_string().split("parameters:")[0],
                              b_._gbdt.train_score().tobytes(), b_._gbdt._valid_score_np(0).tobytes())
            assert same["graph"] == same["eager"], ("replays != eager launches", mode)
            modes[mode]["replays_equal_eager"] = dict(rows=100_000, iterations=14)
    finally:
        objective_mod.BinaryLogloss.get_gradients = get_gradients
    del ds_m

    # turns of 10 iterations (graph, eager, eager, graph) after 10 each (GOSS:
    # its sampled iterations), the launch counts equal between the two kinds
    # turn by turn; one profiled replay and eager iteration each
    for mode, (params_, _) in mode_params.items():
        bsts = {}
        for kind, graph_on in (("graph", True), ("eager", False)):
            b_ = lgb.Booster(dict(params_), train_set)
            b_._gbdt.iteration_graph = graph_on
            assert bench_mod.train_iterations(b_, 10, 1) == 10
            bsts[kind] = b_
        ips_m, turns_m = {k_: [] for k_ in bsts}, {k_: [] for k_ in bsts}
        for kind in ("graph", "eager", "eager", "graph"):
            ran, secs, got = counted(lambda: bench_mod.train_iterations(bsts[kind], 10, 1))
            assert ran == 10, (mode, kind, ran)
            ips_m[kind].append(10 / secs)
            turns_m[kind].append(got)
        assert turns_m["graph"] == turns_m["eager"], (mode, turns_m)
        prof_m = {}
        for kind, b_ in bsts.items():
            busy, kernels, copies_, timeline, named = profiled(b_.update)
            prof_m[kind] = dict(
                device_busy_ms_per_iteration=busy, device_events=kernels, copies=copies_,
                timeline=timeline, kernels_per_iteration=timeline["kernels"]
                if isinstance(timeline, dict) else "not measured", kernels_ms_and_calls=named,
                device_idle_share=[1 - busy * v / 1e3 for v in ips_m[kind]] if busy else "not measured",
                median_iterations_per_s=statistics.median(ips_m[kind]))
        assert bsts["graph"]._gbdt.captures == (2 if mode == "goss" else 1)
        modes[mode].update(iterations_per_s=ips_m, launches_per_turn=turns_m, profile=prof_m)
        del bsts
    say("boosting_modes", rows=N, valid_rows=VALID_ROWS, params={m_: p_ for m_, (p_, _) in
                                                                 mode_params.items()}, **modes)

    # ---- 4k. ranking: LambdaRank on a LETOR-shaped table ---------------------------------
    # 2,000,000 x 136 dense f32 in about 16,300 queries of 1 to 1,251 rows
    # (MSLR-WEB30K's width and sizes at the LightGBM paper's LETOR row count),
    # labels 0-4 with MSLR's shares; a 200,000-row held-out set from another
    # seed with ndcg@1, 3, 5 and 10 at every boundary; 10 iterations through
    # the captured iteration, the lambdas from csrc/lambdarank.cu inside it
    from lightgbm_tpu_torch.bench import (
        LETOR_PARAMS, LETOR_ROWS, LETOR_VALID_ROWS, RENEW_PARAMS, letor_like_rows,
    )
    from lightgbm_tpu_torch.ops import rank as rank_plain

    t0 = time.perf_counter()
    Xr, yr, qr = letor_like_rows(LETOR_ROWS, seed=31)
    Xrv, yrv, qrv = letor_like_rows(LETOR_VALID_ROWS, seed=32)
    rank_set = lgb.Dataset(Xr, label=yr, group=qr)
    rank_valid = rank_set.create_valid(Xrv, label=yrv, group=qrv)
    rank_cfg = Config.from_params(dict(LETOR_PARAMS))
    rank_set.get_binned(rank_cfg)
    rank_valid.get_binned(rank_cfg)
    rank_data_s = time.perf_counter() - t0
    rank_evals, before_last = {}, []

    def keep_scores(env):  # the scores the 10th iteration reads
        if env.iteration == 8:
            before_last.append(env.model._gbdt.scores[0].clone())

    rbst, rank_train_s, rank_launches = counted(lambda: lgb.train(
        dict(LETOR_PARAMS), rank_set, 10, valid_sets=[rank_valid], evals_result=rank_evals,
        verbose_eval=False, callbacks=[keep_scores]))
    gr = rbst._gbdt
    assert gr.grow_loop == "device" and gr.captures == 1 and rbst.num_trees() == 10, gr.captures
    assert rank_launches.get("lambdarank", 0) == 10, rank_launches
    assert all(rank_launches.get(k_, 0) > 0 for k_ in loop_kernels + ("predict_bins",)), rank_launches
    ndcg_at = {m_: v_ for m_, v_ in rank_evals["valid_0"].items()}
    # the quality guard: held-out ndcg@10 above a constant score's on the same
    # rows (equal scores keep each query's row order)
    const_ndcg = {m_: v_ for m_, v_, _ in gr.valid_metrics[0][0].eval(
        np.zeros(LETOR_VALID_ROWS), None)}
    assert ndcg_at["ndcg@10"][-1] > const_ndcg["ndcg@10"], (ndcg_at, const_ndcg)
    # the host's time of an eval boundary: the score read back, four ndcg@k
    t0 = time.perf_counter()
    gr.eval_valid()
    rank_eval_ms = (time.perf_counter() - t0) * 1e3
    # the kernel against its plain version at iteration 1's scores (all 0:
    # the equal-scores branch) and iteration 10's, within the JAX package's
    # twin tolerance; a relaunch gives the same bits
    ro = gr.objective
    plan = ro.plan
    held_rank = {}
    for when, sc in (("iteration_1", torch.zeros(plan.num_data, device=dev)),
                     ("iteration_10", before_last[0])):
        g1, h1 = rank_kernel.lambdarank(sc, plan, ro.sigmoid, ro._scratch)
        g2, h2 = rank_kernel.lambdarank(sc, plan, ro.sigmoid, ro._scratch)
        assert torch.equal(g1, g2) and torch.equal(h1, h2), ("lambdarank relaunch", when)
        pg, ph = rank_plain.lambdas(sc, plan, ro.sigmoid)
        torch.testing.assert_close(g1, pg, rtol=2e-4, atol=2e-6)
        torch.testing.assert_close(h1, ph, rtol=2e-4, atol=2e-6)
        held_rank[when] = max(float((g1 - pg).abs().max()), float((h1 - ph).abs().max()))
    sc10 = before_last[0]
    rank_pairs = plan.pairs()
    rank_bytes = plan.num_data * (4 + 4 + 4 + 8) + (2 * plan.num_queries + 1) * 4
    # 19 f32 operations of a pair's formula (its exp and two divisions each
    # priced as one) and the four sums it enters, once for each unordered
    # pair with unequal labels
    rank_bound = bound(rank_bytes, 23 * rank_pairs)
    rank_t = dict(
        ms=time_ms(lambda: rank_kernel.lambdarank(sc10, plan, ro.sigmoid, ro._scratch)),
        plain_ms=time_ms(lambda: rank_plain.lambdas(sc10, plan, ro.sigmoid), reps=3),
        bound_ms=rank_bound[0], bound_by=rank_bound[1], library_ms=None,
        max_abs_err=max(held_rank.values()), pairs_unequal_labels=rank_pairs,
        queries=plan.num_queries, largest_query=plan.max_size)
    # the replays equal the eager launches: the first queries up to 100k rows,
    # the lambdas rounded to multiples of 2^-7 after the kernel (hessians at
    # least 2^-7): every histogram sum exact, so any summation order agrees
    q_eq = int(np.searchsorted(np.cumsum(qr), 100_000, side="right"))
    eq_rows = int(np.sum(qr[:q_eq]))
    get_rank = objective_mod.LambdarankNDCG.get_gradients

    def rank_dyadic(self, score):
        g_, h_ = get_rank(self, score)
        return torch.round(g_ * 128.0) / 128.0, torch.clamp(torch.round(h_ * 128.0), min=1.0) / 128.0

    ds_eq = lgb.Dataset(Xr[:eq_rows], label=yr[:eq_rows], group=qr[:q_eq], reference=rank_set)
    objective_mod.LambdarankNDCG.get_gradients = rank_dyadic
    try:
        rank_eq = {}
        for kind, graph_on in (("eager", False), ("graph", True)):
            b_ = lgb.Booster(dict(LETOR_PARAMS), ds_eq)
            b_._gbdt.iteration_graph = graph_on
            assert bench_mod.train_iterations(b_, 6, 1) == 6
            rank_eq[kind] = (b_.model_to_string().split("parameters:")[0],
                             b_._gbdt.train_score().tobytes())
    finally:
        objective_mod.LambdarankNDCG.get_gradients = get_rank
    assert rank_eq["graph"] == rank_eq["eager"], "captured != eager (lambdarank)"
    del rank_eq, ds_eq
    turn_params = {k_: v_ for k_, v_ in LETOR_PARAMS.items() if k_ not in ("metric", "eval_at")}
    rank_ips, rank_turn_launches, rank_prof = objective_turns(rank_set, turn_params, 10)
    assert all(v_.get("lambdarank") == 10 for v_ in rank_turn_launches.values()), rank_turn_launches
    for kind in rank_prof:
        us = [v_ for k_, v_ in rank_prof[kind]["kernels_ms_and_calls"].items()
              if "lambdarank_kernel" in k_]
        rank_prof[kind]["lambdarank_ms_and_calls"] = us[0] if us else "not measured"
        busy_ = rank_prof[kind]["device_busy_ms_per_iteration"]
        rank_prof[kind]["lambdarank_share_of_busy"] = (
            us[0][0] / rank_prof[kind]["iterations"] / busy_) if us and busy_ else "not measured"
    say("ranking", rows=LETOR_ROWS, features=Xr.shape[1], queries=len(qr), largest_query=int(qr.max()),
        mean_query=float(np.mean(qr)), valid_rows=LETOR_VALID_ROWS, params=LETOR_PARAMS,
        data_and_binning_s=rank_data_s, train_s=rank_train_s,
        train_iterations_per_s_with_eval=10 / rank_train_s, launches=rank_launches,
        valid_ndcg=ndcg_at, constant_score_ndcg=const_ndcg, eval_ms=rank_eval_ms,
        lambdarank=rank_t, lambdarank_held=held_rank,
        captured_equals_eager=dict(rows=eq_rows, queries=q_eq, iterations=6),
        iterations_per_s=rank_ips, launches_per_turn=rank_turn_launches, profile=rank_prof)
    del rbst, gr, ro, plan, sc10, before_last, rank_set, rank_valid, Xr, yr, Xrv, yrv

    # ---- 4l. leaf renewal: regression_l1, quantile and mape on 4e's table -------------
    # 463,715 x 90 (4e's binned table and held-out set), 10 iterations each
    # through ``train``'s chunks of 10 (the first alone), the renewal
    # (objective.py ``segment_percentile`` over the loop's segments) inside
    # the captured iteration; quantile at alpha 0.9 with bagging 0.8 every
    # iteration
    med = float(np.median(yy))
    renew_rec = {"constant_median_valid_l1": float(np.mean(np.abs(yyv - med)))}
    for name_, params_ in RENEW_PARAMS.items():
        evals_ = {}
        b_, secs_, launches_ = counted(lambda: lgb.train(
            dict(params_, device_chunk_size=10), year_set, 10, valid_sets=[year_valid],
            evals_result=evals_, verbose_eval=False))
        g_ = b_._gbdt
        assert g_.grow_loop == "device" and g_.captures == 1 and b_.num_trees() == 10, name_
        assert all(launches_.get(k_, 0) > 0 for k_ in loop_kernels + ("predict_bins",)), launches_
        pred = b_.predict(Xyv)
        assert np.all(np.isfinite(pred))
        rec = dict(params=params_, train_s=secs_, train_iterations_per_s_with_eval=10 / secs_,
                   launches=launches_, valid_metric=evals_["valid_0"],
                   valid_l1=float(np.mean(np.abs(yyv - pred))))
        if name_ == "regression_l1":
            assert rec["valid_l1"] < renew_rec["constant_median_valid_l1"], rec["valid_l1"]
        if name_ == "quantile":
            rec["valid_coverage"] = float(np.mean(yyv <= pred))
            assert abs(rec["valid_coverage"] - 0.9) <= 0.05, rec["valid_coverage"]
        # one more eager iteration: the renewal's inputs (the rows' leaves
        # from the leaf_ids kernel over the loop's state) and output
        # recorded, then held to the plain renewal on the CPU
        ob_ = g_.objective
        seen = {}
        renew_on_card = ob_.renew_leaf_outputs

        def record(*a_, fn=renew_on_card, seen=seen):
            out_ = fn(*a_)
            seen["args"] = tuple(t_.clone() if torch.is_tensor(t_) else t_ for t_ in a_)
            seen["out"] = out_.clone()
            return out_

        ob_.renew_leaf_outputs = record
        g_.iteration_graph = False
        try:
            assert not b_.update()
        finally:
            del ob_.renew_leaf_outputs
        score_, leaf_card, bag_, num_leaves_, old_ = seen["args"]
        st_ = g_._grow_state
        assert torch.equal(leaf_card, grow_step_plain.leaf_ids(st_)), name_
        leaf_id = leaf_card.cpu()
        cpu_obj = objective_mod.create_objective(Config.from_params(dict(params_)))
        cpu_obj.init(year_set.get_binned(year_cfg).metadata, YEAR_ROWS, torch.device("cpu"))
        want = cpu_obj.renew_leaf_outputs(score_.cpu(), leaf_id, None if bag_ is None else bag_.cpu(),
                                          num_leaves_, old_.cpu())
        got = seen["out"].cpu()
        rec["renewal_max_abs_err"] = float((got - want).abs().max())
        if name_ == "mape":
            # weighted: the card's f32 scan of the cumulative weights and the
            # CPU's (a double accumulator) differ in the last bits, which may
            # move a leaf's pick to a neighbouring order statistic; each card
            # value must be a kept residual of its leaf whose f64 cumulative
            # weight lies within 2^-10 of the leaf's weight from the half
            rec["renewal_leaves_apart"] = renewal_bracket(
                got.numpy(), (cpu_obj._label_dev - score_.cpu()).numpy(), leaf_id.numpy(),
                cpu_obj.label_weight, g_.config.num_leaves, 0.5, 2.0 ** -10)
        else:
            assert torch.equal(got, want), (name_, rec["renewal_max_abs_err"])

        # the renewal's time, as the iteration runs it (the leaf_ids kernel,
        # then the percentiles): an eager call (its some 60 launches queued
        # by the host may outlast the timer's spin) and a replay of the call
        # captured alone (the card's time, as inside the iteration's graph)
        def renew_call():
            return ob_.renew_leaf_outputs(score_, grow_step_kernel.leaf_ids(st_), bag_,
                                          num_leaves_, old_)

        rec["renewal_ms"] = time_ms(renew_call)
        renew_graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(renew_graph):
            renew_call()
        rec["renewal_graph_ms"] = time_ms(renew_graph.replay)
        del renew_graph
        kinds = {"graph": (1, True), "chunk": (10, True)}
        bsts = {}
        for kind, (c, graph_on) in kinds.items():
            bb_ = lgb.Booster(dict(params_, device_chunk_size=c), year_set)
            assert bench_mod.train_iterations(bb_, 10, c) == 10, kind
            bsts[kind] = bb_
        rec["iterations_per_s"], rec["launches_per_turn"], rec["profile"] = turns_and_profile(
            bsts, {k_: v_[0] for k_, v_ in kinds.items()}, ("graph", "chunk", "chunk", "graph"),
            ("graph", "chunk"))
        renew_rec[name_] = rec
        del b_, g_, bsts, seen, ob_
    say("renewal", rows=YEAR_ROWS, valid_rows=YEAR_VALID_ROWS, **renew_rec)

    # ---- 4m. the training API: a custom objective, continued training, cv and the
    # boosting modes with ranking and leaf renewal ------------------------------------------
    # the main path's table (1M x 28, 255 leaves) and 4d's held-out set; the
    # mode pairs on 4e's table and on a LETOR-shaped one; each run's launches
    # count as the main path's (``counted``)
    api, api_s = {}, {}
    t_part = [time.perf_counter()]

    def part_done(name_):
        now_ = time.perf_counter()
        api_s[name_] = now_ - t_part[0]
        t_part[0] = now_

    def logloss_fobj(labels, q=None):
        """A user's numpy binary log-loss objective; with ``q`` its
        gradients and hessians rounded to multiples of 1/q (every
        histogram sum exact)."""
        def fobj(preds, _dataset):
            p_ = 1.0 / (1.0 + np.exp(-preds))
            g_, h_ = p_ - labels, p_ * (1.0 - p_)
            if q is not None:
                g_, h_ = np.round(g_ * q) / q, np.maximum(np.round(h_ * q), 1.0) / q
            return g_, h_
        return fobj

    def valid_auc(evals_):
        return evals_["valid_0"]["auc"][-1]

    # a custom objective against the built-in one at the same start (no boost
    # from average: a custom objective has none), 10 iterations each through
    # train with the held-out AUC at every boundary
    fobj_main = logloss_fobj(y)
    plain_params = dict(TRAIN_PARAMS, boost_from_average=False)
    evals_f, evals_b = {}, {}
    fbst, fobj_train_s, fobj_launches = counted(lambda: lgb.train(
        dict(TRAIN_PARAMS), train_set, 10, fobj=fobj_main, valid_sets=[valid_set],
        evals_result=evals_f, verbose_eval=False))
    bbst, builtin_train_s, builtin_launches = counted(lambda: lgb.train(
        dict(plain_params), train_set, 10, valid_sets=[valid_set], evals_result=evals_b,
        verbose_eval=False))
    gfo = fbst._gbdt
    assert gfo.objective is None and gfo._custom_grads and gfo.grow_loop == "device"
    assert all(fobj_launches.get(k_, 0) > 0 for k_ in loop_kernels + ("predict_bins",)), fobj_launches
    auc_f, auc_b = valid_auc(evals_f), valid_auc(evals_b)
    assert abs(auc_f - auc_b) <= 2e-3 and auc_f > 0.7, (auc_f, auc_b)
    # the host's share of a custom iteration: the scores read back, the
    # objective, the gradients' upload (queued)
    host_ms = {"score_readback": [], "fobj": [], "upload": []}

    def host_timed(name_, fn):
        def run(*a_):
            t0_ = time.perf_counter()
            out_ = fn(*a_)
            host_ms[name_].append((time.perf_counter() - t0_) * 1e3)
            return out_
        return run

    gfo.train_score = host_timed("score_readback", gfo.train_score)
    gfo._upload_gradients = host_timed("upload", gfo._upload_gradients)
    fobj_timed = host_timed("fobj", fobj_main)
    fobj_ips, builtin_ips, turn_launches = [], [], {}
    for kind in ("fobj", "builtin", "builtin", "fobj"):
        if kind == "fobj":
            def turn():
                for _ in range(10):
                    fbst.update(fobj=fobj_timed)
        else:
            def turn():
                for _ in range(10):
                    bbst.update()
        _, secs_, got_ = counted(turn)
        (fobj_ips if kind == "fobj" else builtin_ips).append(10 / secs_)
        turn_launches.setdefault(kind, got_)
    assert gfo.captures == 1, gfo.captures
    # two iterations a profiled window (the profiler may lose a window's
    # first events, the upload among them), reported per iteration
    busy_f, kernels_f, copies_f, timeline_f, _ = profiled(
        lambda: [fbst.update(fobj=fobj_main) for _ in range(2)])
    busy_b, kernels_b, copies_b, timeline_b, _ = profiled(lambda: [bbst.update() for _ in range(2)])
    assert gfo.captures == 1, gfo.captures
    del gfo.train_score, gfo._upload_gradients
    api["fobj"] = dict(
        valid_auc=auc_f, builtin_valid_auc=auc_b, train_s=fobj_train_s,
        builtin_train_s=builtin_train_s, iterations_per_s=fobj_ips,
        builtin_iterations_per_s=builtin_ips,
        host_ms_per_iteration={k_: statistics.median(v_) for k_, v_ in host_ms.items()},
        launches_per_turn=turn_launches, captures=gfo.captures,
        profile=dict(device_busy_ms_per_iteration=busy_f / 2, builtin_device_busy_ms=busy_b / 2,
                     kernels_per_iteration=timeline_f["kernels"] / 2
                     if isinstance(timeline_f, dict) else "not measured",
                     builtin_kernels_per_iteration=timeline_b["kernels"] / 2
                     if isinstance(timeline_b, dict) else "not measured",
                     copies_in_two_replays=copies_f, builtin_copies_in_two=copies_b))
    del fbst, bbst, gfo
    part_done("fobj")

    # the same objective rounded to 2^-7 at 100k rows: the replays, the eager
    # launches and the CPU's plain loop grow the same trees and scores
    Xs_api, ys_api = X[:100_000], y[:100_000]
    fobj_r = logloss_fobj(ys_api, q=128.0)
    eq_api = {}
    for kind, device_, graph_on in (("graph", "cuda", True), ("eager", "cuda", False),
                                    ("cpu", "cpu", False)):
        b_ = lgb.Booster(dict(TRAIN_PARAMS, objective="none"), lgb.Dataset(Xs_api, label=ys_api),
                         device=device_)
        b_._gbdt.iteration_graph = graph_on
        for _ in range(3):
            assert not b_.update(fobj=fobj_r)
        eq_api[kind] = (b_.model_to_string().split("parameters:")[0],
                        b_._gbdt.train_score().tobytes())
        if kind == "graph":
            assert b_._gbdt.captures == 1
    assert eq_api["graph"] == eq_api["eager"] == eq_api["cpu"], "fobj: replay != eager != cpu"
    api["fobj"]["replay_equals_eager_and_cpu"] = dict(rows=100_000, iterations=3)
    del eq_api
    part_done("fobj_bitwise")

    # continued training: 5 + 5 iterations with bagging 0.8 and
    # feature_fraction 0.8 through a saved file, against 10 in one run
    tmp_api = tempfile.TemporaryDirectory(prefix="lgbt-api-")
    warm_params = dict(TRAIN_PARAMS, bagging_fraction=0.8, bagging_freq=1, feature_fraction=0.8)
    evals_one, evals_warm = {}, {}
    one_bst, one_s, _ = counted(lambda: lgb.train(
        dict(warm_params), train_set, 10, valid_sets=[valid_set], evals_result=evals_one,
        verbose_eval=False))
    first_bst, first_s, _ = counted(lambda: lgb.train(dict(warm_params), train_set, 5,
                                                      verbose_eval=False))
    parent_carry = first_bst._gbdt.scores.cpu().numpy()
    model_path = os.path.join(tmp_api.name, "first.txt")
    first_bst.save_model(model_path)
    warm_set = train_set.subset(np.arange(N))
    warm_bst, warm_s, warm_launches = counted(lambda: lgb.train(
        dict(warm_params), warm_set, 5, init_model=model_path, valid_sets=[valid_set],
        evals_result=evals_warm, verbose_eval=False))
    init_f32 = warm_set.construct()._binned.metadata.init_score.astype(np.float32)
    assert init_f32.tobytes() == parent_carry[0].tobytes(), "warm-start init != parent carry"
    assert warm_bst.num_trees() == one_bst.num_trees() == 10 and warm_bst._gbdt.captures == 1
    assert all(warm_launches.get(k_, 0) > 0 for k_ in loop_kernels + ("predict_bins",))
    auc_one, auc_warm = valid_auc(evals_one), valid_auc(evals_warm)
    assert abs(auc_one - auc_warm) <= 2e-3, (auc_one, auc_warm)
    # byte for byte at 100k rows with the rounded objective
    ds_w = lgb.Dataset(Xs_api, label=ys_api)
    one_r = lgb.train(dict(warm_params), ds_w, 10, fobj=fobj_r, verbose_eval=False)
    first_r = lgb.train(dict(warm_params), ds_w, 5, fobj=fobj_r, verbose_eval=False)
    path_r = os.path.join(tmp_api.name, "first_r.txt")
    first_r.save_model(path_r)
    warm_r = lgb.train(dict(warm_params), lgb.Dataset(Xs_api, label=ys_api), 5, fobj=fobj_r,
                       init_model=path_r, verbose_eval=False)
    assert warm_r.model_to_string() == one_r.model_to_string(), "warm-start text != one-shot"
    api["init_model"] = dict(
        valid_auc=auc_warm, one_shot_valid_auc=auc_one, init_equals_parent_carry=True,
        first_train_s=first_s, warm_train_s=warm_s, one_shot_train_s=one_s,
        text_equals_one_shot=dict(rows=100_000, iterations="5 + 5"))
    del one_bst, first_bst, warm_bst, warm_set, one_r, first_r, warm_r, ds_w
    tmp_api.cleanup()
    part_done("init_model")

    # cv: 5 folds of the main path's table, 10 iterations, AUC
    t0 = time.perf_counter()
    cv_res = lgb.cv(dict(TRAIN_PARAMS, metric="auc"), train_set, 10, nfold=5,
                    return_cvbooster=True)
    cv_s = time.perf_counter() - t0
    cvb = cv_res.pop("cvbooster")
    fold_captures = [b_._gbdt.captures for b_ in cvb.boosters]
    assert fold_captures == [1] * 5 and all(b_._gbdt.grow_loop == "device" for b_ in cvb.boosters)
    assert cv_res["auc-mean"][-1] > 0.7, cv_res
    api["cv"] = dict(nfold=5, rounds=10, seconds=cv_s, auc_mean=cv_res["auc-mean"],
                     auc_stdv=cv_res["auc-stdv"], fold_captures=fold_captures,
                     fold_rows=[b_._gbdt.num_data for b_ in cvb.boosters])
    del cvb, cv_res
    part_done("cv")

    # the mode x objective pairs: GOSS x quantile, DART x regression_l1 and
    # random forest x mape on 4e's table, GOSS x lambdarank on 500,000
    # LETOR-shaped rows; 10 iterations each with the held-out metric at every
    # boundary, then a turn of 10 without evaluation and a profiled replay
    goss_ = dict(boosting="goss", top_rate=0.2, other_rate=0.1, learning_rate=0.25)
    quantile_goss = {k_: v_ for k_, v_ in RENEW_PARAMS["quantile"].items()
                     if not k_.startswith("bagging")}
    t0 = time.perf_counter()
    Xq, yq, qq = letor_like_rows(500_000, seed=33)
    Xqv, yqv, qqv = letor_like_rows(100_000, seed=34)
    letor_set = lgb.Dataset(Xq, label=yq, group=qq)
    letor_valid = letor_set.create_valid(Xqv, label=yqv, group=qqv)
    letor_cfg = Config.from_params(dict(LETOR_PARAMS))
    letor_set.get_binned(letor_cfg)
    letor_valid.get_binned(letor_cfg)
    letor_data_s = time.perf_counter() - t0
    # DART x L1 starts from the training median as every row's init score:
    # from the boost-from-average score its first tree would hold the label's
    # offset (years near 2000), and a drop of that tree leaves every residual
    # of one sign, where no L1 split has a gain (the JAX package stops there too)
    med_set, med_valid = year_set.subset(np.arange(YEAR_ROWS)), year_valid.subset(
        np.arange(YEAR_VALID_ROWS))
    med_set.construct(year_cfg).set_init_score(np.full(YEAR_ROWS, med))
    med_valid.construct(year_cfg).set_init_score(np.full(YEAR_VALID_ROWS, med))
    pairs = {  # params, training set, held-out set, the offset of its predictions
        "goss_quantile": (dict(quantile_goss, **goss_), year_set, year_valid, 0.0),
        "dart_regression_l1": (dict(RENEW_PARAMS["regression_l1"], boosting="dart"), med_set,
                               med_valid, med),
        "rf_mape": (dict(RENEW_PARAMS["mape"], boosting="rf", bagging_fraction=0.8,
                         bagging_freq=1), year_set, year_valid, 0.0),
        "goss_lambdarank": (dict(LETOR_PARAMS, **goss_), letor_set, letor_valid, 0.0),
    }
    rounded_classes = (objective_mod.RegressionQuantileLoss, objective_mod.RegressionL1Loss,
                       objective_mod.RegressionMAPELoss, objective_mod.LambdarankNDCG)

    def round_gradients():
        """Every pair's gradients rounded to multiples of 2^-7 (MAPE's, whose
        weights 1 / |label| are near 2^-11 here, to multiples of 2^-18; 100k
        of them sum below 2^6, still exact) and hessians to multiples of 2^-7
        (at least 2^-7), after the objective; returns the undo."""
        saved = {c_: c_.__dict__.get("get_gradients") for c_ in rounded_classes}
        for c_ in rounded_classes:
            q_ = 2.0 ** 18 if c_ is objective_mod.RegressionMAPELoss else 128.0

            def rounded(self, score, get_=c_.get_gradients, q_=q_):
                g_, h_ = get_(self, score)
                return (torch.round(g_ * q_) / q_,
                        torch.clamp(torch.round(h_ * 128.0), min=1.0) / 128.0)
            c_.get_gradients = rounded

        def undo():
            for c_, fn_ in saved.items():
                if fn_ is None:
                    del c_.get_gradients
                else:
                    c_.get_gradients = fn_
        return undo

    # 100,000 rows exactly (the last query cut short): GOSS's amplification
    # (100,000 - 20,000) / 10,000 = 8 keeps the amplified gradients dyadic
    n_eq = min(100_000, len(yq))
    q_eq = int(np.searchsorted(np.cumsum(qq), n_eq))
    q_sizes = np.append(qq[:q_eq], n_eq - int(np.sum(qq[:q_eq])))
    n_year = min(100_000, len(yy))
    eq_median = year_set.subset(np.arange(n_year))
    eq_median.construct(year_cfg).set_init_score(np.full(n_year, med))
    eq_sets = {"year": year_set.subset(np.arange(n_year)), "year_median": eq_median,
               "letor": lgb.Dataset(Xq[:n_eq], label=yq[:n_eq], group=q_sizes,
                                    reference=letor_set)}
    pair_rec = {"letor_data_s": letor_data_s}
    for pair, (params_, set_, valid_, offset_) in pairs.items():
        evals_ = {}
        b_, secs_, launches_ = counted(lambda: lgb.train(
            dict(params_), set_, 10, valid_sets=[valid_], evals_result=evals_, verbose_eval=False))
        g_ = b_._gbdt
        rank_ = params_["objective"] == "lambdarank"
        assert g_.grow_loop == "device" and b_.num_trees() == 10, (pair, g_.grow_loop, b_.num_trees())
        assert g_.captures == (2 if pair.startswith("goss") else 1), (pair, g_.captures)
        assert g_._renew == (not rank_), pair
        assert all(launches_.get(k_, 0) > 0 for k_ in loop_kernels + ("predict_bins",)), launches_
        if rank_:
            assert launches_.get("lambdarank", 0) == 10, launches_
            const_ = {m_: v_ for m_, v_, _ in g_.valid_metrics[0][0].eval(
                np.zeros(len(yqv)), None)}
            guard = dict(valid_ndcg10=evals_["valid_0"]["ndcg@10"][-1],
                         constant_ndcg10=const_["ndcg@10"])
            assert guard["valid_ndcg10"] > guard["constant_ndcg10"], guard
        else:
            pred_ = b_.predict(Xyv) + offset_
            assert np.all(np.isfinite(pred_))
            guard = dict(valid_l1=float(np.mean(np.abs(yyv - pred_))),
                         constant_median_valid_l1=renew_rec["constant_median_valid_l1"])
            if params_["objective"] == "quantile":
                # GOSS's bag keeps every row of the top gradients, the rows
                # under-predicted at alpha 0.9, so the renewal's percentile
                # over the bag sits high: the coverage is recorded and the
                # guard is the held-out quantile loss below the constant
                # 0.9-quantile's
                guard["valid_coverage"] = float(np.mean(yyv <= pred_))
                c_ = float(np.quantile(yy, 0.9))
                guard["constant_valid_quantile"] = float(np.mean(np.maximum(
                    0.9 * (yyv - c_), -0.1 * (yyv - c_))))
                guard["valid_quantile"] = evals_["valid_0"]["quantile"][-1]
                assert guard["valid_quantile"] < guard["constant_valid_quantile"], guard
            else:
                assert guard["valid_l1"] < guard["constant_median_valid_l1"], guard
        if pair.startswith("goss"):
            assert g_._bag is g_._goss_mask and int(g_._bag.sum()) == sum(g_._goss_k), pair
        _, turn_s, _ = counted(lambda: bench_mod.train_iterations(b_, 10, 1))
        busy_, kernels_, copies_, timeline_, _ = profiled(b_.update)
        rec = dict(params=params_, train_s=secs_, train_iterations_per_s_with_eval=10 / secs_,
                   iterations_per_s=10 / turn_s, launches=launches_, valid_metric=evals_["valid_0"],
                   guard=guard, captures=g_.captures,
                   profile=dict(device_busy_ms_per_iteration=busy_, copies=copies_,
                                kernels_per_iteration=timeline_["kernels"]
                                if isinstance(timeline_, dict) else "not measured",
                                device_idle_share=1 - busy_ * (10 / turn_s) / 1e3
                                if busy_ else "not measured"))
        del b_, g_
        # the replays equal the eager launches on 100k rows, gradients rounded
        eq_set = eq_sets["letor" if rank_ else "year_median" if offset_ else "year"]
        undo = round_gradients()
        try:
            same = {}
            for kind, graph_on in (("eager", False), ("graph", True)):
                bb_ = lgb.Booster(dict(params_), eq_set)
                bb_._gbdt.iteration_graph = graph_on
                ran_ = bench_mod.train_iterations(bb_, 6, 1)
                assert ran_ == 6, (pair, kind, ran_)
                same[kind] = (bb_.model_to_string().split("parameters:")[0],
                              bb_._gbdt.train_score().tobytes())
        finally:
            undo()
        assert same["graph"] == same["eager"], ("replays != eager launches", pair)
        rec["replays_equal_eager"] = dict(rows=eq_set.num_data(), iterations=6)
        pair_rec[pair] = rec
        del same
    api["mode_objectives"] = pair_rec
    del letor_set, letor_valid, eq_sets, eq_set, eq_median, med_set, med_valid, Xq, yq, qq, Xqv, yqv
    del qqv
    part_done("mode_objectives")
    say("api", rows=N, valid_rows=VALID_ROWS, part_seconds=api_s, **api)
    del year_set, year_valid, yy, Xyv, yyv

    # ---- 5. cross-check: CUDA vs the plain versions on the CPU ------------------
    Xs, ys = X[:100_000], y[:100_000]
    release = hold_calls()  # every histogram call of the CUDA run held to its plain version
    on_gpu = lgb.Booster(dict(TRAIN_PARAMS), lgb.Dataset(Xs, label=ys), device="cuda")
    on_gpu._gbdt.iteration_graph = False  # a replay calls no wrapper to hold
    for _ in range(3):
        on_gpu.update()
    held5 = release()
    assert held5["checked"]["histogram"] > 0 and held5["checked"]["histogram_segment"] > 0, held5
    on_cpu = lgb.train(dict(TRAIN_PARAMS), lgb.Dataset(Xs, label=ys), 3, device="cpu")

    def same_trees(base, other, rtol=1e-5):
        """Trees equal in order up to the first f32 near-tie flip, whose
        gains must agree to ``rtol`` (None: the caller holds them); returns
        (identical trees, flips, (tree, node) of the flip or None)."""
        flips = 0
        agree = 0
        where = None
        for a, b in zip(base._gbdt.trees(), other._gbdt.trees()):
            diff = np.nonzero(
                (a.split_feature != b.split_feature) | (a.threshold_bin != b.threshold_bin)
            )[0] if a.num_leaves == b.num_leaves else np.array([0])
            if len(diff):
                k = int(diff[0])
                if rtol is not None:
                    np.testing.assert_allclose(b.split_gain[k], a.split_gain[k], rtol=rtol,
                                               err_msg="tree %d node %d" % (agree, k))
                flips += 1
                where = (agree, k)
                break
            agree += 1
        assert agree >= 1 or flips == 1, "the trees differ beyond a near-tie"
        return agree, flips, where

    def exact_gains(bst, t, gh):
        """f64 gain of every split of tree t of ``bst``,
        G_L^2 / (H_L + l2) + G_R^2 / (H_R + l2) - G^2 / (H + l2), from the
        sums of ``gh`` ([n, 2] f64 gradients and hessians) over the rows each
        node splits."""
        g0 = bst._gbdt
        fb = g0.bins_dev.to(dev)
        meta = {kk: v.cpu().tolist() for kk, v in g0.feature_meta.items()}
        lam = g0.config.lambda_l2
        ta = g0._tree_arrays[t]
        lc, rc = ta.left_child.tolist(), ta.right_child.tolist()
        reach = {0: torch.ones(fb.shape[1], dtype=torch.bool, device=dev)}
        gains = []
        for i in range(int(ta.num_leaves) - 1):
            f, thr = int(ta.split_feature[i]), int(ta.threshold_bin[i])
            col = fb[f].long()
            left = col <= thr
            if meta["missing_type"][f] == MISSING_ZERO:
                left[col == meta["default_bin"][f]] = bool(ta.default_left[i])
            elif meta["missing_type"][f] == MISSING_NAN:
                left[col == meta["num_bin"][f] - 1] = bool(ta.default_left[i])
            sides = reach[i] & left, reach[i] & ~left
            (g_l, h_l), (g_r, h_r) = (gh[s].sum(0).tolist() for s in sides)
            gains.append(g_l * g_l / (h_l + lam) + g_r * g_r / (h_r + lam)
                         - (g_l + g_r) ** 2 / (h_l + h_r + lam))
            for child, s in zip((lc[i], rc[i]), sides):
                if child > 0:
                    reach[child] = s
        return gains

    # Each side's f32 gains against the f64 gains of its own splits, over
    # the nodes the trees share and the flipped node, from the plain run's
    # log-loss gradients (the runs' scores differ only in the last bits of
    # the leaf values). The kernel's sums must be no further from exact than
    # the plain version's sequential f32 sums. At a flip, the two splits are
    # a near tie in f32; the CUDA run's split must be no worse in exact
    # arithmetic than the plain version's, to rtol 1e-5.
    agree, flips, where = same_trees(on_cpu, on_gpu, rtol=None)
    labels5 = torch.as_tensor(ys, dtype=torch.float64, device=dev)
    p5 = float(np.mean(ys))
    gain_err, at_flip = {}, {}
    for t in range(where[0] + 1 if where else 3):
        s = (torch.as_tensor(on_cpu.predict(Xs, num_iteration=t, raw_score=True), device=dev) if t
             else torch.full((len(ys),), float(np.float32(np.log(p5 / (1 - p5)))),
                             dtype=torch.float64, device=dev))  # boost from average
        p = torch.sigmoid(s)
        gh = torch.stack([p - labels5, p * (1 - p)], 1)
        for name, b in (("cuda", on_gpu), ("cpu_plain", on_cpu)):
            exact = exact_gains(b, t, gh)
            upto = where[1] + 1 if where and t == where[0] else len(exact)
            assert upto <= len(exact), ("no node at the flip", name, where)
            got = b._gbdt._tree_arrays[t].split_gain[:upto].tolist()
            errs = [abs(a - e) for a, e in zip(got, exact[:upto])]
            gain_err[name] = max([gain_err.get(name, 0.0)] + errs)
            if upto and where and t == where[0]:
                at_flip[name] = dict(gain=got[-1], exact_gain=exact[upto - 1])
    assert gain_err["cuda"] <= gain_err["cpu_plain"], ("gains further from exact", gain_err)
    if where is not None:
        ex_cuda, ex_cpu = at_flip["cuda"]["exact_gain"], at_flip["cpu_plain"]["exact_gain"]
        assert ex_cuda >= ex_cpu - 1e-5 * abs(ex_cpu), ("flip to a worse split", where, at_flip)
    ra = on_cpu.predict(Xs, raw_score=True)  # all 3 trees, a flip included
    rb = on_gpu.predict(Xs, raw_score=True)
    np.testing.assert_allclose(rb, ra, rtol=1e-4, atol=1e-4)
    worst = float(np.abs(ra - rb).max())
    # mean |error| of the g and h channels of the 100k-row root histogram
    # (real gradients) against an f64 sum: the kernel and the plain version
    fb5, nb5 = on_gpu._gbdt.bins_dev, on_gpu._gbdt.num_bins
    vals5 = real_vals[: fb5.shape[1]].contiguous()
    flat5 = (fb5.long() + torch.arange(F, device=dev)[:, None] * nb5).reshape(-1)
    exact5 = torch.zeros((F * nb5, 3), dtype=torch.float64, device=dev).index_add_(
        0, flat5, vals5.double().repeat(F, 1)).view(F, nb5, 3)

    def err_f64(h):
        return [float(v) for v in (h.double().to(dev) - exact5)[..., :2].abs().mean((0, 1))]

    root_err = dict(cuda=err_f64(hist_kernel.histogram(fb5, vals5, nb5)),
                    cpu_plain=err_f64(leaf_histogram(fb5.cpu(), vals5.cpu(), nb5)))
    say("cross_check", rows=100_000, iterations=3, trees_identical=agree,
        near_tie_flips=flips, flip_at=where, flip=at_flip, max_gain_err_vs_f64=gain_err,
        worst_raw_score_diff=worst, held_calls=held5, root_err_vs_f64=root_err)

    # ---- 6. the histogram kernel family --------------------------------------------
    n_s = int(seg_rows.numel())
    seg_long = seg_rows.long()
    seg_host = seg_rows.cpu().numpy()
    family = {}  # (kernel, dtype) -> {B: numbers}
    checked = 0
    for Bf in (15, 63, 255):
        gen = torch.Generator(device=dev).manual_seed(Bf)
        syn_nf = torch.randint(0, Bf, (N, F), generator=gen, device=dev, dtype=torch.uint8)
        syn = syn_nf.t()  # the grower's layout: [F, N] view of the [N, F] copy
        syn_host = syn_nf.cpu().numpy().T  # for hist_v1's mirror
        # the nibble-packed [N2, F] copy the grower makes at set-up when B <= 16
        syn_p4 = hist_kernel.pack_bins(syn_nf).t() if Bf <= 16 else None
        out_b = F * Bf * 12
        root_b = bound(N * F + N * 12 + out_b, 3 * N * F)
        seg_b = bound(n_s * F + n_s * 12 + n_s * 4 + out_b, 3 * n_s * F)
        # packed: each packed byte once (at the segment, the pairs its rows touch)
        packed_b = bound((N + 1) // 2 * F + N * 12 + out_b, 3 * N * F)
        seg_pairs = int(torch.unique(seg_rows >> 1).numel())
        packed_seg_b = bound(seg_pairs * F + n_s * 12 + n_s * 4 + out_b, 3 * n_s * F)
        flat = (syn.long() + torch.arange(F, device=dev)[:, None] * Bf).reshape(-1)
        lib_acc = torch.zeros((F * Bf, 3), device=dev)
        for dt in ("float32", "bfloat16"):
            real_op = real_vals.to(torch.bfloat16).float() if dt == "bfloat16" else real_vals
            lib_vals = real_op.repeat(F, 1)

            def library():
                lib_acc.zero_()
                lib_acc.index_add_(0, flat, lib_vals)

            library_ms = time_ms(library)
            plain = {}
            for rows in (None, seg_rows):
                key = "root" if rows is None else "segment"
                plain[key] = dict(
                    dyadic=leaf_histogram(syn, dyq_vals, Bf, rows, dt),
                    real=leaf_histogram(syn, real_vals, Bf, rows, dt),
                    abs_sum=leaf_histogram(syn, real_vals.abs(), Bf, rows, dt),
                    ms=time_ms(lambda r=rows: leaf_histogram(syn, real_vals, Bf, r, dt), reps=3),
                )
            for name, fn in (("histogram", hist_kernel.histogram), ("hist_v1", hist_kernel.hist_v1),
                             ("hist_onehot", hist_kernel.hist_onehot),
                             ("hist_bitplane", hist_kernel.hist_bitplane),
                             ("hist_packed4", hist_kernel.hist_packed4_rows)):
                if name in ("hist_onehot", "hist_bitplane") and not 2 <= Bf <= 256:
                    continue
                if name == "hist_packed4" and Bf > 16:
                    continue
                rec = {}
                bins_in = syn_p4 if name == "hist_packed4" else syn
                for rows in (None, seg_rows):
                    key = "root" if rows is None else "segment"

                    def run(v, r=rows, fn=fn, b=bins_in):
                        return fn(b, v, Bf, r, dt)
                    want = plain[key]
                    got = run(dyq_vals)
                    assert torch.equal(got, want["dyadic"]), (name, Bf, dt, key, "dyadic")
                    ratio, err = err_over_bound(run(real_vals), want["real"], want["abs_sum"])
                    assert ratio <= 1.0, (name, Bf, dt, key, err, ratio)
                    rec[key + "_max_abs_err"] = err
                    rec[key + "_err_over_bound"] = ratio
                    rec[key + "_ms"] = time_ms(lambda: run(real_vals))
                    rec[key + "_plain_ms"] = want["ms"]
                    checked += 2
                if name == "hist_packed4":
                    # its own plain version on the set-up copy, and the root on
                    # pack4's [F, N2] input (the JAX kernel's own contract)
                    for rows in (None, seg_rows):
                        key = "root" if rows is None else "segment"
                        rec[key + "_plain_ms"] = time_ms(
                            lambda r=rows: leaf_histogram_packed4_rows(syn_p4, real_vals, Bf, r, dt),
                            reps=3)
                    bp, vp = hist_kernel.pack4(syn, dyq_vals)
                    assert torch.equal(hist_kernel.hist_packed4(bp, vp, Bf, dt),
                                       plain["root"]["dyadic"]), (Bf, dt, "pack4 input")
                    bp, vp = hist_kernel.pack4(syn, real_vals)
                    rec["root_packed_input_ms"] = time_ms(lambda: hist_kernel.hist_packed4(bp, vp, Bf, dt))
                    checked += 1
                if name == "hist_v1":  # the oracle of the default kernel
                    for rows in (None, seg_rows):
                        assert torch.equal(
                            hist_kernel.hist_v1(syn, dyq_vals, Bf, rows, dt),
                            hist_kernel.histogram(syn, dyq_vals, Bf, rows, dt),
                        ), ("hist_v1 != histogram", Bf, dt)
                    # fixed order: the mirror's bits on real values at the
                    # segment, the same bits on every call at the root
                    assert np.array_equal(
                        hist_kernel.hist_v1(syn, real_vals, Bf, seg_rows, dt).cpu().numpy(),
                        hist_kernel.hist_v1_mirror(syn_host, real_host, Bf, seg_host, dt, sms),
                    ), ("hist_v1 != its mirror", Bf, dt)
                    first = hist_kernel.hist_v1(syn, real_vals, Bf, None, dt)
                    for _ in range(4):
                        assert torch.equal(hist_kernel.hist_v1(syn, real_vals, Bf, None, dt),
                                           first), ("hist_v1 changed between calls", Bf, dt)
                    checked += 2
                rb, sb = (packed_b, packed_seg_b) if name == "hist_packed4" else (root_b, seg_b)
                rec.update(root_bound_ms=rb[0], segment_bound_ms=sb[0], bound_by=rb[1],
                           library_ms=library_ms)
                family.setdefault((name, dt), {})[Bf] = rec
        del syn_nf, syn, syn_host, syn_p4, flat, lib_acc
    say("kernel_family", rows=N, features=F, segment_rows=n_s, dyadic_exact=True,
        checks=checked, numbers={"%s/%s" % k: v for k, v in family.items()})
    print(json.dumps({"hist_onehot_root_ms": {
        dt: {Bf: family[("hist_onehot", dt)][Bf]["root_ms"] for Bf in (15, 63, 255)}
        for dt in ("float32", "bfloat16")}}), flush=True)

    # ---- 7. the tune sweep -------------------------------------------------------------
    datasets = {255: train_set}
    for mb in (15, 63):
        datasets[mb] = lgb.Dataset(X, label=y)
        datasets[mb].construct(Config.from_params(dict(TRAIN_PARAMS, max_bin=mb)))
    widths = {mb: ds.get_binned(cfg).max_num_bin for mb, ds in datasets.items()}
    assert widths[15] <= 16, widths  # else cuda_packed4 never routes
    tmp = tempfile.TemporaryDirectory(prefix="lgbt-tune-")
    table_path = os.path.join(tmp.name, "tune.json")
    argv = ["--out", table_path, "--rows", str(ROOT_ROWS), "--features", str(FEATURES),
            "--bins", ",".join(str(widths[mb]) for mb in (15, 63, 255)),
            "--dtypes", "float32,bfloat16"]
    rc, sweep_s, sweep_launches = counted(lambda: tune.main(argv))
    assert rc == 0
    table = tune.load_table(table_path)
    hand_kernels = set(hist_kernel.KERNEL_CAPS)
    winners = {"B=%d,%s,rows=%d" % (e["B"], e["hist_dtype"], e["rows_bucket"]): e["impl"]
               for e in table["entries"]}
    assert winners and set(winners.values()) <= hand_kernels, winners
    wins = {}
    for impl in winners.values():
        wins[impl] = wins.get(impl, 0) + 1
    say("sweep", argv=argv, seconds=sweep_s, widths=widths, entries=len(table["entries"]),
        device_family=table["device_family"], digest=table["digest"], wins=wins,
        winners=winners, launches=sweep_launches,
        times_ms=[{"B": e["B"], "dt": e["hist_dtype"], "rows": e["rows_bucket"], **e["times_ms"],
                   **e["baseline_ms"]} for e in table["entries"]])

    # ---- 8. routed training --------------------------------------------------------------
    classes = sorted({hist_kernel.rows_bucket(s) for s in hist_kernel.bucket_sizes(N)})

    def hand_table(mb, dt):
        """Alternate row classes to cuda_onehot / cuda_bitplane (/ cuda_packed4)."""
        B_mb = widths[mb]
        kinds = ["cuda_onehot", "cuda_bitplane"] + (["cuda_packed4"] if B_mb <= 16 else [])
        ents = [{"B": B_mb, "K": 3, "hist_dtype": dt, "rows_bucket": r, "impl": kinds[i % len(kinds)]}
                for i, r in enumerate(classes)]
        path = os.path.join(tmp.name, "hand-%d-%s.json" % (mb, dt))
        tune.save_table(tune.build_table(ents, device_kind=torch.cuda.get_device_name(0)), path)
        return path

    def train_at(mb, dt, tune_path, eager=False):
        """10 iterations; ``eager``: the device loop's eager launches, whose
        wrapper calls ``hold_calls`` can hold (a replay calls none)."""
        params = dict(TRAIN_PARAMS, max_bin=mb, tpu_hist_dtype=dt, hist_tune=tune_path)
        bst_ = lgb.Booster(params, datasets[mb])
        bst_._gbdt.iteration_graph = not eager
        for _ in range(10):
            bst_.update()
        return bst_

    U = 2.0 ** -24  # f32 unit roundoff
    labels = torch.as_tensor(y, dtype=torch.float64, device=dev)

    def flip_bound(base, other, t, k):
        """(gap, bound, detail) at the first node where two f32 runs differ,
        node k of tree t. Each run takes the best split of its own f32 sums,
        so the gap between the two runs' gains there is at most
        2 max(err_base, err_other), where err bounds the f32 error of a
        run's gain at node k against exact sums. The split leaf's histogram
        is that of its nearest directly built ancestor D less the smaller
        siblings between them, so a cell is off by at most
        (2 count_D + depth + B + 4) u sum_D |v| (sums, subtractions, the
        scan's prefix); the leaf's totals also carry every ancestor's
        histogram error. Both runs start tree 0 from the same scores and
        share its root sums; after tree 0 the gradients drift by the leaf
        values' last bits, so the bound adds the measured drift and the
        root sums' worst-case error, which at 1M rows admits a wide gap:
        there the per-call checks of ``hold_calls`` hold the kernels. At
        deep nodes of 1M-row trees a side's hessian sum can lie within its
        worst-case error, and the bound is then infinite."""
        g0 = base._gbdt
        fb = g0.bins_dev  # [F, N] u8, the same binned data in both runs
        nb = g0.num_bins
        lam = g0.config.lambda_l2
        meta = {kk: v.cpu().tolist() for kk, v in g0.feature_meta.items()}
        feat_off = torch.arange(F, device=dev)[:, None] * nb

        def grad_hess(bst):
            if t == 0:
                s = torch.full((N,), float(np.float32(score)), dtype=torch.float64, device=dev)
            else:
                s = torch.as_tensor(bst.predict(X, num_iteration=t, raw_score=True), device=dev)
            p = torch.sigmoid(s)
            return torch.stack([p - labels, p * (1 - p)], 1), s

        gh, s = grad_hess(base)
        absv = torch.cat([gh.abs(), torch.ones((N, 1), dtype=torch.float64, device=dev)], 1)
        drift = torch.zeros(2, dtype=torch.float64, device=dev)
        root = drift.clone()
        if t:
            gh_o, s_o = grad_hess(other)
            # training scores are f32: t rounded adds per run, gradients 1/4-Lipschitz
            slack = N * t * U * float(torch.maximum(s.abs().max(), s_o.abs().max())) / 2
            drift = (gh_o - gh).abs().sum(0) + slack
            root = 2 * N * U * absv[:, :2].sum(0) + drift

        def decide(f, thr, dl):
            col = fb[f].long()
            left = col <= thr
            if meta["missing_type"][f] == MISSING_ZERO:
                left[col == meta["default_bin"][f]] = dl
            elif meta["missing_type"][f] == MISSING_NAN:
                left[col == meta["num_bin"][f] - 1] = dl
            return left

        def abs_hist(rows):  # [F, B, 3] f64 sums of |g|, |h| and counts over rows
            out = torch.zeros((F * nb, 3), dtype=torch.float64, device=dev)
            out.index_add_(0, (fb[:, rows].long() + feat_off).reshape(-1), absv[rows].repeat(F, 1))
            return out.view(F, nb, 3)

        def split_error(ta):
            """(reported gain, error bound) of node k of one run's tree;
            (0, 0) where the tree has no node k (its best gain was <= 0)."""
            if k >= int(ta.num_leaves) - 1:
                return 0.0, 0.0
            lc, rc = ta.left_child.tolist(), ta.right_child.tolist()
            parent = {c: (i, c == lc[i]) for i in range(k) for c in (lc[i], rc[i]) if c > 0}
            path, node = [], k
            while node in parent:
                node, went_left = parent[node]
                path.append((node, went_left))
            rows = torch.ones(N, dtype=torch.bool, device=dev)
            a_d = abs_hist(rows)

            def hist_err(depth):
                w = (2 * a_d[..., 2:] + depth + nb + 4) * U
                return (w * a_d[..., :2]).sum(1).max(0).values + drift

            e_sum, e_hist = root, hist_err(0)
            for depth, (p, went_left) in enumerate(reversed(path), 1):
                e_sum = e_sum + e_hist  # the child's totals: its parent's split record
                gl = decide(int(ta.split_feature[p]), int(ta.threshold_bin[p]), bool(ta.default_left[p]))
                n_l, n_r = int((rows & gl).sum()), int((rows & ~gl).sum())
                rows = rows & (gl if went_left else ~gl)
                if (n_l <= n_r) == went_left:  # the smaller child: built from its own rows
                    a_d = abs_hist(rows)
                e_hist = hist_err(depth)
            gl = decide(int(ta.split_feature[k]), int(ta.threshold_bin[k]), bool(ta.default_left[k]))
            sides = [gh[rows & gl].sum(0), gh[rows & ~gl].sum(0)]
            sides.append(sides[0] + sides[1])
            eg, eh = (float(v) for v in e_sum + e_hist)
            err, terms = 0.0, 0.0
            for G, H in sides:  # left, right, parent: G^2 / (H + lambda_l2) each
                G, H = abs(float(G)), float(H) + lam
                if H - eh <= 0:
                    return float(ta.split_gain[k]), float("inf")
                term = G * G / H
                terms += term
                err += max((G + eg) ** 2 / (H - eh) - term, term - max(G - eg, 0.0) ** 2 / (H + eh))
            return float(ta.split_gain[k]), err + 8 * U * terms

        (gain_a, err_a), (gain_b, err_b) = (split_error(b._gbdt._tree_arrays[t]) for b in (base, other))
        return abs(gain_a - gain_b), 2 * max(err_a, err_b), dict(
            gains=[gain_a, gain_b], gain_error_bounds=[err_a, err_b], after_tree_0=bool(t))

    defaults = {}
    default_ips = {}
    for mb in (15, 63):  # the default route at the same widths, the f32 runs' yardstick
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        defaults[mb] = train_at(mb, "float32", "off")
        torch.cuda.synchronize()
        default_ips[mb] = 10 / (time.perf_counter() - t0)
    runs = [("table", 15, "float32", table_path), ("table", 63, "bfloat16", table_path),
            ("table", 255, "bfloat16", table_path), ("hand", 63, "float32", hand_table(63, "float32")),
            ("hand", 15, "float32", hand_table(15, "float32"))]
    routed = []
    routed_launches = {}
    for kind, mb, dt, path in runs:
        timed, secs, got = counted(lambda: train_at(mb, dt, path))
        release = hold_calls()  # the same training again, every kernel call held
        bst = train_at(mb, dt, path, eager=True)
        held = release()
        aucs = []
        for b in (timed, bst):
            assert b._gbdt.hist_route is not None and b.num_trees() == 10, (kind, mb, dt)
            (_, _, auc_b, _), = b.eval_train()
            assert auc_b > 0.7 and np.all(np.isfinite(b.predict(X[:1000], raw_score=True))), (
                kind, mb, dt, auc_b)
            aucs.append(auc_b)
        auc_r = aucs[1]
        rec = dict(kind=kind, max_bin=mb, num_bins=widths[mb], hist_dtype=dt,
                   grow_loop=bst._gbdt.grow_loop, seconds=secs,
                   iterations_per_s=10 / secs, auc=aucs[0], held_run_auc=auc_r, launches=got,
                   held_calls=held, route_digest=bst._gbdt.hist_route.digest)
        if dt == "float32" and mb in defaults:
            # phase 5's rule, the flipped node's gain held to the f32 error
            # bound of the sums behind it (flip_bound); the models must
            # still score alike
            agree_r, flips_r, where = same_trees(defaults[mb], bst, rtol=None)
            if where is not None:
                gap, tol, detail = flip_bound(defaults[mb], bst, *where)
                assert gap <= tol, ("flip beyond the f32 bound", kind, mb, where, gap, tol, detail)
                rec.update(flip_gap=gap, flip_bound=tol, flip=detail)
            (_, _, auc_d, _), = defaults[mb].eval_train()
            assert abs(auc_r - auc_d) <= 2e-3, (kind, mb, dt, auc_r, auc_d)
            rec.update(trees_identical=agree_r, near_tie_flips=flips_r, flip_at=where,
                       default_auc=auc_d, default_iterations_per_s=default_ips[mb])
        if got.get("hist_packed4", 0) + got.get("hist_packed4_bf16", 0):
            assert held["checked"]["hist_packed4_rows"] > 0, (kind, mb, dt, held)
        for k, v in got.items():
            routed_launches[k] = routed_launches.get(k, 0) + v
        routed.append(rec)
    for name in ("hist_onehot", "hist_bitplane", "hist_packed4"):
        assert routed_launches.get(name, 0) + routed_launches.get(name + "_bf16", 0) > 0, (
            name, routed_launches)
    tmp.cleanup()
    say("routed_training", rows=N, iterations=10, runs=routed, launches=routed_launches)

    # ---- 8b. serving: the packed ensemble, its three kernels and the HTTP server ----
    cat_booster = lgb.Booster(model_str=cat_model_text, device=dev)
    with tempfile.TemporaryDirectory(prefix="lgbt-serve-") as serve_dir:
        serve_rec, serve_kernels, serve_bst = serving_phase(
            lgb, dev, counted, time_ms, train_set, cat_booster, cat_rows, serve_dir)
    srv_ = serve_rec["server"]
    print("serving on %s: rows/s under load %.1f (exact %.1f, fused %.1f); latency ms p50/p99 "
          "1 row exact %.3f/%.3f fused %.3f/%.3f, 1000 rows exact %.3f/%.3f fused %.3f/%.3f"
          % (card, srv_["load"]["rows_per_s"], srv_["exact_rows_per_s"], srv_["fused_rows_per_s"],
             *(srv_["latency"][k_][q_] for k_ in ("exact_1", "fused_1", "exact_1000", "fused_1000")
               for q_ in ("p50_ms", "p99_ms"))), flush=True)
    for name_, t_ in serve_rec["kernel_times"].items():
        print("serving kernel %s on %s: us at 16 / 4096 rows %.3f / %.3f, bytes bound %.3f / %.3f"
              % (name_, card, t_[16]["ms"] * 1e3, t_[4096]["ms"] * 1e3, t_[16]["bound_ms"] * 1e3,
                 t_[4096]["bound_ms"] * 1e3), flush=True)
    say("serving", card=card, **serve_rec)

    # ---- 8c. prediction: SHAP on the TreeSHAP kernel, early stopping, refit, files ----
    with tempfile.TemporaryDirectory(prefix="lgbt-predict-") as predict_dir:
        predict_rec, shap_row = prediction_phase(
            lgb, dev, counted, time_ms, serve_bst, train_set, X, y, auc, cat_booster, cat_rows,
            predict_dir)
    del serve_bst
    c_ = predict_rec["contrib"]
    print("tree_shap on %s: %.3f ms at %d rows x %d trees (f64 bound %.3f ms, %s); plain %.3f ms "
          "at %d rows x %d trees; ptxas %s; |sum phi - raw| %.3e (%.3e of its bound)"
          % (card, c_["kernel_ms"], c_["rows"], c_["trees"], c_["bound_ms"], c_["bound_by"],
             shap_row["plain_ms"], CONTRIB_ROWS, CONTRIB_HELD_TREES, ptxas["tree_shap"],
             c_["max_sum_err"], c_["sum_err_over_bound"]), flush=True)
    say("prediction", card=card, **predict_rec)

    # ---- 8d. wide bins (max_bin 1024, int16) and the histogram pool ---------------------
    import types

    wide_rec, wide_rows = wide_bins_phase(lgb, dev, types.SimpleNamespace(
        counted=counted, profiled=profiled, time_ms=time_ms, X=X, y=y, train_set=train_set,
        dyq_vals=dyq_vals, real_vals=real_vals, seg_rows=seg_rows,
        dyadic_gradients=dyadic_gradients, card=card))
    ips_ = {k: statistics.median(v) for k, v in wide_rec["iterations_per_s"].items()}
    print("wide bins on %s: it/s (median of 2 turns) %s; busy ms an iteration %s; pooled steps "
          "that built both children %d of %d (%d slots)"
          % (card, json.dumps(ips_), json.dumps({k: v["device_busy_ms_per_iteration"]
                                                 for k, v in wide_rec["profile"].items()}),
             wide_rec["pool"]["steps_both_children"], wide_rec["pool"]["steps"],
             wide_rec["pool"]["slots"]), flush=True)
    say("wide_bins", **wide_rec)

    # ---- 8e. forced splits and CEGB -------------------------------------------------------
    fc_rec, fc_rows = forced_cegb_phase(lgb, dev, types.SimpleNamespace(
        counted=counted, profiled=profiled, time_ms=time_ms, X=X, y=y, train_set=train_set,
        booster=booster, dyq_vals=dyq_vals, dyadic_gradients=dyadic_gradients,
        get_gradients=get_gradients, card=card))
    print("forced/CEGB on %s: it/s %s; busy ms an iteration %s; kernels an iteration %s; "
          "distinct features %d (CEGB) of %d (main)"
          % (card, json.dumps(fc_rec["iterations_per_s"]),
             json.dumps({k: v["device_busy_ms_per_iteration"] for k, v in fc_rec["profile"].items()}),
             json.dumps({k: v["kernels_per_iteration"] for k, v in fc_rec["profile"].items()}),
             len(fc_rec["distinct_features"]["cegb"]), len(fc_rec["distinct_features"]["main"])),
          flush=True)
    say("forced_cegb", **fc_rec)

    # ---- 8f. EFB groups past 256 bins, the pool with EFB, CEGB with the pool ------------
    ew_rec, ew_rows = bundled_wide_pooled_phase(lgb, dev, types.SimpleNamespace(
        counted=counted, time_ms=time_ms, X=X, y=y, train_set=train_set, cover=cover_rows,
        flight_set=flight_set, dyq_vals=dyq_vals, dyadic_gradients=dyadic_gradients,
        get_gradients=get_gradients, card=card))
    del cover_rows, flight_set
    print("bundled wide/pooled on %s: sparse Covertype at max_bin %d, %d groups of up to %d bins; "
          "Flight pooled %s slots; CEGB pooled %s slots; held every step %s; records patched %d"
          % (card, EFB_WIDE_MAX_BIN, ew_rec["trainings"]["sparse_covertype_wide"]["groups"],
             ew_rec["trainings"]["sparse_covertype_wide"]["max_group_bins"],
             ew_rec["trainings"]["flight_pooled"]["slots"],
             ew_rec["trainings"]["cegb_pooled"]["slots"],
             json.dumps(ew_rec["eager_trees"]["held_every_step"]),
             ew_rec["eager_trees"]["patched_records"]), flush=True)
    say("bundled_wide_pooled", **ew_rec)

    # ---- 9. kernels line and result ---------------------------------------------
    sources = {
        "histogram": ("histogram.cu", "lightgbm_tpu/ops/hist_pallas.py:225"),
        "hist_onehot": ("hist_onehot.cu", "lightgbm_tpu/ops/hist_pallas.py:524"),
        "hist_bitplane": ("hist_bitplane.cu", "lightgbm_tpu/ops/hist_pallas.py:655"),
        "hist_packed4": ("hist_packed4.cu", "lightgbm_tpu/ops/hist_pallas.py:409"),
        "hist_v1": ("hist_v1.cu", "lightgbm_tpu/ops/hist_pallas.py:301"),
    }
    kernels = [
        dict(name="histogram", route="cuda", source="lightgbm_tpu_torch/csrc/histogram.cu",
             replaces=sources["histogram"][1], launches=main_launches.get("histogram", 0),
             max_abs_err=hist_err, **hist_root),
        dict(name="split_pair", route="cuda", source="lightgbm_tpu_torch/csrc/split_pair.cu",
             replaces="lightgbm_tpu/ops/split_pallas.py:221", launches=main_launches.get("split_pair", 0),
             max_abs_err=0.0, **split_t),
    ]
    for name, (src, rep) in sources.items():
        for dt in ("float32", "bfloat16"):
            if (name, dt) == ("histogram", "float32"):
                continue  # phase 2's entry above
            key = name + ("_bf16" if dt == "bfloat16" else "")
            r = family[(name, dt)][15 if name == "hist_packed4" else 255]
            kernels.append(dict(
                name=key, route="cuda", source="lightgbm_tpu_torch/csrc/" + src, replaces=rep,
                launches=main_launches.get(key, 0), max_abs_err=r["root_max_abs_err"],
                ms=r["root_ms"], plain_ms=r["root_plain_ms"], bound_ms=r["root_bound_ms"],
                bound_by=r["bound_by"], library_ms=r["library_ms"],
            ))
    # the split loop's kernels and entries, timed at the main path's root step
    # (phase 4b; the folded scan, which took in the histogram subtraction of
    # lightgbm_tpu/ops/grow.py:1421, also at step 128)
    loop_sources = {
        "pick_partition": ("partition.cu", "lightgbm_tpu/ops/grow.py:439,1277"),
        "histogram_segment": ("histogram.cu", sources["histogram"][1]),
        "histogram_segment_bf16": ("histogram.cu", sources["histogram"][1]),
        "split_pair_step": ("split_pair.cu", "lightgbm_tpu/ops/split_pallas.py:221"),
        "split_pair_fold": ("split_pair.cu", "lightgbm_tpu/ops/split_pallas.py:221"),
        "leaf_ids": ("grow_step.cu", "lightgbm_tpu/ops/grow.py:1880"),
        "score_update": ("grow_step.cu", "lightgbm_tpu/ops/grow.py:1880"),
        "predict_bins": ("predict_bins.cu", "lightgbm_tpu/ops/predict.py:85"),
    }
    step_t["leaf_ids"] = leaf_t  # timed in phase 4c on a 255-leaf layout at 1M rows
    step_t["score_update"] = score_t  # the same layout
    step_t["predict_bins"] = predict_t  # timed in phase 4d over the validation set
    for name, (src, rep) in loop_sources.items():
        t = step_t[name]
        kernels.append(dict(
            name=name, route="cuda", source="lightgbm_tpu_torch/csrc/" + src, replaces=rep,
            launches=main_launches.get(name, 0), max_abs_err=t["max_abs_err"], ms=t["ms"],
            plain_ms=t["plain_ms"], bound_ms=t["bound_ms"], bound_by=t["bound_by"],
            library_ms=t["library_ms"], **({"sizes": t["sizes"]} if "sizes" in t else {}),
        ))
    # the categorical instantiations of three of them, timed in phase 4g at
    # its shapes; their launches are 4g's training run's
    cat_replaces = {
        "split_pair_fold": "lightgbm_tpu/ops/split.py:325 (the categorical scan; XLA there)",
        "pick_partition": "lightgbm_tpu/ops/grow.py:284,1287",
        "predict_bins": "lightgbm_tpu/ops/predict.py:113",
    }
    for name, t in cat_t.items():
        base = name[:-len("_categorical")]
        kernels.append(dict(
            name=name, route="cuda", source="lightgbm_tpu_torch/csrc/" + loop_sources[base][0],
            replaces=cat_replaces[base], launches=cat_launches.get(base, 0),
            max_abs_err=t["max_abs_err"], ms=t["ms"], plain_ms=t["plain_ms"],
            bound_ms=t["bound_ms"], bound_by=t["bound_by"], library_ms=t["library_ms"],
        ))
    # the bundled kernels, timed in phase 4i at its shapes (4h's in its own
    # line); efb_remap's launches are the main path's, the bundled pick's and
    # predict's 4h's and 4i's trainings'
    bundled_replaces = {
        "efb_remap": ("efb_remap.cu", "lightgbm_tpu/ops/grow.py:806 (remap_hist; XLA there)",
                      main_launches.get("efb_remap", 0)),
        "pick_partition_bundled": ("partition.cu", "lightgbm_tpu/ops/grow.py:490,1298 (decode_col)",
                                   bundled_launches.get("pick_partition", 0)),
        "predict_bins_bundled": ("predict_bins.cu", "lightgbm_tpu/ops/predict.py:104",
                                 bundled_launches.get("predict_bins", 0)),
    }
    for name, (src, rep_, n_) in bundled_replaces.items():
        t = f_kernels[name]
        kernels.append(dict(
            name=name, route="cuda", source="lightgbm_tpu_torch/csrc/" + src, replaces=rep_,
            launches=n_, max_abs_err=t["max_abs_err"], ms=t["ms"], plain_ms=t["plain_ms"],
            bound_ms=t["bound_ms"], bound_by=t["bound_by"], library_ms=t["library_ms"],
        ))
    # the lambda kernel, timed in phase 4k at iteration 10's scores; its
    # launches are the main path's (4k's training and turns)
    kernels.append(dict(
        name="lambdarank", route="cuda", source="lightgbm_tpu_torch/csrc/lambdarank.cu",
        replaces="lightgbm_tpu/objective.py:842 (_lambdarank_bucket; XLA there)",
        launches=main_launches.get("lambdarank", 0), max_abs_err=rank_t["max_abs_err"],
        ms=rank_t["ms"], plain_ms=rank_t["plain_ms"], bound_ms=rank_t["bound_ms"],
        bound_by=rank_t["bound_by"], library_ms=None,
    ))
    # the serving kernels, timed in phase 8b at 4096 rows (16 rows beside);
    # their launches are the server's run under load
    kernels.extend(serve_kernels)
    # the TreeSHAP kernel, timed in phase 8c at 10,000 rows on 500 trees (its
    # plain version at 10,000 rows on 20); its launches are 8c's pred_contrib
    kernels.append(shap_row)
    # the int16 and pool instantiations, timed in phase 8d at max_bin 1024;
    # their launches are 8d's trainings' (the categorical ones its
    # categorical table's)
    kernels.extend(wide_rows)
    # forced splits' and CEGB's kernels, timed in phase 8e on one eager tree at
    # 1M rows; their launches are 8e's forced and CEGB trainings'
    kernels.extend(fc_rows)
    # the int16 bundled, pooled bundled and pooled CEGB instantiations, timed
    # in phase 8f on one eager tree of each training; their launches are 8f's
    # trainings'
    kernels.extend(ew_rows)
    unlaunched = [k["name"] for k in kernels if k["launches"] <= 0]
    assert not unlaunched, ("kernels the main path never launched", unlaunched, main_launches)
    print(json.dumps({"phase_seconds": phase_s, "total_s": sum(phase_s.values())}))
    print(json.dumps({"kernels": kernels}))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"results": results, "kernels": kernels, "phase_seconds": phase_s}, fh, indent=1)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0

if __name__ == "__main__":
    sys.exit(main())

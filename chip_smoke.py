"""Chip smoke of ydf_tpu_torch, the PyTorch/CUDA port: builds its CUDA
kernels, checks each against its plain PyTorch version at full width,
serves the committed fixture models through `load_model(...).predict`
on the card, trains the bench GBT, a GBT on vector sequences and the
library's default GBT (binary and three classes) on the card through
`GradientBoostedTreesLearner(...).train` and the library's default
random forest through `RandomForestLearner(...).train`, a pruned CART
tree and an isolation forest through `CartLearner(...).train` and
`IsolationForestLearner().train`, evaluates, saves and loads them,
trains each ported GBT loss and sampling option, times each kernel, and
prints one JSON summary.

    python3 chip_smoke.py        # needs one CUDA card and nvcc

Phases (one line each; any failure is an uncaught exception):
  1 device    card name, count, nvidia-smi name and power limit
  2 build     nvcc for sm_90a (all six sources in parallel), seconds,
              ptxas registers / shared memory / spills (per kernel for the
              histogram and binning sources); the shared atomics the two
              histogram sources compile to (cuobjdump -sass)
  3 kernels   each serving kernel == its plain version (torch.equal) on
              4096 rows of the 300-tree default GBT (QuickScorer,
              BankScorer) and the 50-tree depth-8 GBT (BankScorer), the
              bank in both its walks; the bank on synthetic forests, ==
              plain and the routed oracle in both walks: one whose first
              tree is too large for a shared tree block (walked in global
              memory), one whose feature and node ids pass a narrow
              record's 30 bits and one whose trees share a subtree (both
              packed in wide records)
  4 predict   load_model + predict on the stored rows == the JAX
              package's expected.npz (raw bitwise, predictions 1e-6)
  5 serve     requests of 1 .. 1,048,576 rows; the path's kernel time
              (CUDA events around each launch, each launch's rows and
              time logged) and its launches weighted by their rows; then
              the kernel timed alone at 1,048,576 rows; the registry's
              order held against the card's (QuickScorer and the bank on
              gbt_d6)
  6 train     the bench GBT (500,000 rows x 28 features, 20 trees,
              depth 6) trained on the card: each training kernel against
              its plain version at the path's shapes (binning in both
              layouts; the root histogram also on a pile-up case, 12% of
              200,000 rows in bin 0 of 36 features), then the training
              itself held against the JAX package's run (the committed
              ydf_tpu_torch/testdata/train_bench fixture), then one more
              training under torch.profiler (device time, idle share of
              the boosting loop), then each training kernel timed with
              CUDA events, the routed kernel at each hist-slot count of
              the path
  7 vs        the vector-sequence paths (ydf_tpu_torch/testdata/train_vs,
              the JAX package's run of its GBT on make_vs_data: 200,000
              rows, sequences of up to 16 vectors of 16, 20 trees, depth
              6): the scoring kernel against its plain version at the
              training shape and at ragged shapes (D = 1, 3, 5, 40 among
              them: the generic instantiation), bitwise; serve_vs, the JAX
              model loaded and served on 1024 fresh rows against the JAX
              package's scores, and the kernel against its plain version
              on the serve path's own inputs; train_vs, the same GBT
              trained on the card
              against the JAX run (anchors bitwise, tree 0, losses, raw
              scores); then each kernel timed at the path's shapes
  8 default   train_default (ydf_tpu_torch/testdata/train_default, the
              JAX package's GradientBoostedTreesLearner(label="label")
              with every default on make_frame: 500,000 rows, 28
              numerical and 4 categorical columns, evaluated on 100,000
              fresh rows): the frames' SHA-256; the main path (train with
              the validation split, look-ahead early stopping and
              categorical splits, then evaluate) with its launches, host
              reads and stage walls; against the JAX run (bins and
              validation rows bitwise, the kept and trained tree counts,
              tree 0 with its categorical masks, losses, raw scores,
              evaluate's metrics); the JAX model loaded and evaluated on
              the card; save -> load; the routed kernel against its plain
              version on the path's categorical tables; a profiled train
              of 50 trees (the device's idle share); each of the path's
              kernels timed at its shapes
  9 rf        train_rf (ydf_tpu_torch/testdata/train_rf, the JAX
              package's RandomForestLearner(label="label") with every
              default on make_frame: 50,000 rows, evaluated on 10,000
              fresh ones; 300 trees of depth 16, frontier 1024; the card
              grows its first RF_TREES = 100, held to the JAX run's
              cut of those trees): the
              frames' SHA-256; the main path (train, then evaluate) with
              its launches, host reads and stage walls; against the JAX
              run's hashes: bins, every tree's bootstrap counts, tree
              0's candidate masks at every layer, every tree's node
              arrays (a differing tree is located by depth and its
              closest gain pair printed), trees 0-2 node for node
              against the JAX package's saved 3-tree forest; out-of-bag
              and evaluate metrics, probabilities on 1,024 rows; tree 0
              in full (one long line); save -> load; the JAX
              forest served on the card; the routed kernel at every
              layer of tree 0 (Lh 1 .. 512, binary Sq 3 and 3-class
              Sq 4) and the root histogram torch.equal to plain, the
              routed kernel's launch shape at L = 1024; a profiled train
              of 5 trees; each kernel timed, the routed kernel at each
              Lh on the path's own layers
  10 multiclass  train_multiclass (ydf_tpu_torch/testdata/
              train_multiclass, the JAX package's default learner on the
              three-class variant of make_frame: 200,000 rows, evaluated
              on 50,000; K = 3 trees an iteration): the frames' SHA-256;
              the main path (train, then evaluate) with its launches,
              host reads and stage walls; against the JAX run: bins,
              validation rows, every tree's hash and the kept count
              (the fixture's update_form is replayed), the first 10
              iterations node for node, the validation loss (all
              bitwise), evaluate's
              metrics and confusion matrix, probabilities; the JAX model
              on the card and save -> load bitwise; each
              train_gbt_options configuration (Poisson, MAE, focal,
              subsample, GOSS, candidate features, three classes with
              both) trained on the card against its JAX run; the root
              and routed kernels against plain on the path's own layers;
              a profiled train of 5 iterations; each kernel timed
  11 cart_if  train_cart and train_if (ydf_tpu_torch/testdata/
              train_cart, train_if: the JAX package's CartLearner(label=
              "label") and IsolationForestLearner() with every default on
              make_frame's 500,000 rows; CART prunes on a 10% holdout and
              evaluates on 100,000 fresh rows, the isolation forest
              (on the card its first IF_TREES = 100 of the default
              300 trees, on 256-row subsamples) scores them, 1% made
              anomalous): the frames' SHA-256; both main paths with their
              launches, host reads and stage walls; against the JAX
              runs: the holdout and bins, the grown and the pruned tree
              node for node, the pruned count, the holdout and evaluate
              metrics, probabilities, a 20,000-row regression CART;
              every isolation tree and subsample by hash, tree 0 node
              for node, the scores bitwise, the AUC; both JAX models on
              the card and save -> load bitwise; the root and routed
              kernels against plain on both paths' layers (S = 1 on 256
              rows; Lh up to 512 on 450,032 rows); a profiled isolation
              forest of 10 trees; each kernel timed at both paths'
              shapes
  12 oblique  train_oblique_gbt, _rf, _cart and _if (ydf_tpu_torch/
              testdata/train_oblique: the JAX package's four learners
              with split_axis="SPARSE_OBLIQUE", 28 projections a tree,
              on the frames of phases 8, 9 and 11): each main path with
              its launches (binning once a tree for the projections, and
              once more for the GBT's validation rows), host reads and
              ms a tree; against the JAX runs: every kept tree (the
              random forest: the fixture's 50, all the card grows)
              by hash, its thresholds, projections and boundaries, the
              kept count, predictions and scores (SHA-256 of all
              100,000), evaluate and holdout metrics, CART's grown and
              pruned trees; the JAX-saved oblique GBT on the card and
              save -> load bitwise, with the predict wall; the binning,
              root and routed kernels against plain on each path's own
              calls (projection columns: 28 x 450,000 values); a
              profiled train per path; each kernel timed at each path's
              shapes

  13 sets     train_monotone, train_dart and train_sets (monotone
              constraints, DART, CATEGORICAL_SET columns in the GBT, RF
              and CART) against the JAX runs; the run-sum kernel at its
              edge shapes
  14 rank_surv  train_ranking, train_survival and train_rank_options
              (the RANKING and SURVIVAL_ANALYSIS GBTs) against the JAX
              runs; the losses' device time
  15 uplift   train_uplift (the CATEGORICAL_UPLIFT forest, the
              fixture's 50 trees at S = 5 stats, by hash; the uplift CART's
              AUUC pruning; a NUMERICAL_UPLIFT forest), train_honest
              (honest=True: classification and regression),
              train_sets_alone (the GBT, RF and CART on two set columns
              and no scalar feature: no routed launch) and
              train_multitasker (two GBT tasks) against the JAX runs,
              with launches, host reads, stage walls, ms a tree,
              evaluate (Qini, AUUC), save -> load and the JAX-saved
              models on the card; the binning, root and routed kernels
              against plain at S = 5 on every layer of tree 0, the run
              sums and prefix histograms at the set-only shapes, the
              bank on the multitasker's models; profiled trees; each
              kernel timed
  16 io       the reference YDF format and the model API: the
              committed YDF exports of the JAX package
              (ydf_tpu_torch/testdata/ydf_format: gbt_d6, the 3-class
              GBT, the isolation forest, the uplift forest, a prefixed
              uplift CART) loaded on the card, predictions and leaves
              bitwise the JAX importer's, gbt_d6's import served at
              1,048,576 rows (routed; predict and encode walls against
              the JAX-saved model's bank predict); each fixture's source
              model exported, every file's SHA-256 == the JAX export's; a
              20-tree default GBT trained on 100,000 rows, exported and
              loaded back, predictions bitwise; the binned QuickScorer
              on gbt_d6's bins at 1,048,576 rows, torch.equal to its
              plain version, the float QuickScorer and the routed
              oracle; benchmark(engines=True) at 65,536 rows;
              distance on 2,048 rows and serialize -> deserialize_model;
              the binned kernel timed
  17 cache    out-of-core data (ydf_tpu_torch/testdata/train_cache and
              train_discretized): make_frame's 500,000 + 100,000 rows
              written as 4 CSV shards and a test CSV (SHA-256 == the
              fixture's); the CSV loader built with g++; the main path:
              create_dataset_cache in chunks of 65,536 rows (pass 2 bins
              each chunk on the card: one binning launch a chunk), the
              default GBT trained from the cache, evaluate on the test
              CSV; against the JAX runs: every cache file and the
              metadata, the same bytes in chunks of 500,000 and the sketch
              mode's cache, the validation rows, every tree by hash, the
              losses, metrics (1e-12) and predictions bitwise; the default
              GBT with discretize_numerical_columns=True on 200,000 rows
              (trees by hash, predictions, save_ydf == the JAX export);
              predict on TFRecord and Avro files of 4,096 test rows and
              predict_tf_examples, bitwise the in-memory predict; each
              binning chunk, the root and tree 0's routed launches and the
              bank's against their plain versions; each kernel timed; a
              profiled 20-tree train from the cache (the idle share)

  18 robust  train_mhld (ydf_tpu_torch/testdata/train_mhld: the JAX
              package's GBT with split_axis="MHLD_OBLIQUE" on make_frame's
              500,000 + 100,000 rows): W of every kept tree bitwise, the
              boundaries, every kept tree by hash, the kept count, the
              predictions (SHA-256), evaluate; the launches (the scatter
              matrices' one host read before the loop), ms a tree, a
              profiled 10-tree train (the idle share), the path's
              kernels against plain and timed; train_default preempted
              after three snapshots and resumed (every tree == phase 8's
              run and the fixture; a mismatched resume refused); the GBT
              and the random forest with a deadline (their trees a prefix
              of phases 8's and 9's); a train and a predict with
              telemetry on (the metrics, the flushed trace; ms a tree on
              against off)

  19 mesh    training on a mesh of four data shards (four cards when
              the machine has them, else cuda:0 four times): the default
              GBT on train_default's frame, every kept tree == the
              fixture (and phase 8's run) by hash, the raw scores
              bitwise, evaluate within 1e-12; launches (each shard's),
              host reads, ms a tree, merge ms a layer, a profiled
              stretch (the idle share); shard 0's launches of tree 0
              against plain; a 2x2 (data, feature) GBT prefix and forest
              (train_rf's frame) against their fixtures; two processes
              (NCCL with a card each, or gloo on one card) against the
              one-process run; the kernels timed at the shards' shapes

  20 dist    feature-parallel distributed training over RPC workers
              (ydf_tpu_torch/testdata/train_dist: the JAX package's
              distributed default GBT, validation_ratio=0.0 and 50 trees,
              on cache_frames' 500,000 rows from a cache of two feature
              shards): the cache binned on the card (its files == the
              JAX package's); two worker processes (a card each when
              the machine has two, else both on cuda:0); the main path
              (train over the workers, then evaluate) with every tree ==
              the fixture by hash, predictions and raw scores bitwise,
              evaluate within 1e-12; the workers' launches (the root
              kernel at a tree's root, the routed kernel deeper) and
              their CUDA-event device time, host reads, ms a tree, RPC
              ms by verb, wire bytes, worker RSS; the single device from
              the same cache (every tree equal, ms a tree); a worker
              SIGKILLed after tree 5 (every tree still equal); both
              kernels at the workers' shapes (f32 and int8) torch.equal
              to plain; the card's idle share (the manager's profile
              plus a worker's spans); the kernels timed

Phases 4-5 run once per serving path: gbt_d6 with the registry's choice
(BankScorer), gbt_d6 with QuickScorer forced, and gbt_d8 (BankScorer);
phase 6 is the training path, phase 7 the serve_vs and train_vs paths,
phase 8 the default train path (train, then evaluate), phase 9 the
random forest's and phase 10 the multiclass GBT's (train, then
evaluate), phase 11 CART's (train, then evaluate) and the isolation
forest's (train, then predict), phase 12 the four oblique learners'
(train, then evaluate or predict), phases 13-15 each of their learners'
runs (train, then evaluate; the multitasker's two tasks together), phase
16 the model IO path (import, export, round trip, binned QuickScorer,
benchmark, leaves, distance, serialize) as one path, phase 17 the cache
path (build, train, evaluate) and the discretized GBT's (train,
predict), phase 18 the MHLD GBT's (train, evaluate), phase 19 the 4x1
mesh GBT's (train, evaluate), phase 20 the distributed GBT's (train
over the worker processes, whose launches they report, then evaluate).
The launch counters are set to 0 just before each path and read just
after it; phase 3, the comparisons and the timing launches do not count.
The `kernels` line has one entry per (kernel, path). Each timing gives a
call's time (CUDA events around calls back to back: host work included)
and its device time (torch.profiler: the sum of the kernels, memsets and
copies one call launches), and the same two for the library call; each
entry also has `path_ms`, the kernel's CUDA-event time summed over the
path's launches (the serving kernels add their launches weighted by
rows, the routed kernel its numbers at each hist-slot count).
Exits non-zero without a result when CUDA is absent.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
TESTDATA = os.path.join(HERE, "ydf_tpu_torch", "testdata")
SERVE_BATCHES = (1, 256, 4096, 65_536, 1_048_576)
TIMING_ROWS = 1_048_576
COMPARE_ROWS = 4096
# Card peaks used for bound_ms (NVIDIA H100 SXM data sheet, at 700 W):
# HBM bandwidth, and the 32-bit rate outside the tensor cores, the
# nearest listed rate for compare / bitwise / add work.
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
TRAIN_BENCH = os.path.join(TESTDATA, "train_bench")
DEVICE = "cuda"
# The training path: bench.py's run_bench configuration (bench.py:1778).
TRAIN_ROWS = 500_000
TRAIN_FEATURES = 28
DATA_SEED = 0
TRAIN_HP = dict(label="label", num_trees=20, max_depth=6,
                validation_ratio=0.0, early_stopping="NONE")
TRAIN_REQUEST_ROWS = 1024
REQUEST_SEED = 1
# The vector-sequence path (train_vs): the JAX package's GBT at its
# default anchor counts on make_vs_data. VS_RADIUS puts about half of the
# labels at 1.
TRAIN_VS = os.path.join(TESTDATA, "train_vs")
VS_ROWS = 200_000
VS_MAX_LEN = 16
VS_DIM = 16
VS_NOISE = 4
VS_RADIUS = 11.75
# Score tolerance of the comparisons of vector-sequence scores with the
# JAX package's (the kernel equals its plain version bitwise): |difference|
# <= VS_RTOL * M + VS_ATOL,
# M = max over the row's vectors of |v|^2 + |a|^2 + 2|v||a|.
VS_RTOL = 1e-5
VS_ATOL = 1e-6
# serve_vs: a raw score may differ from the JAX package's beyond 1e-5
# only on a row whose VS score sits within VS_RTOL * M of a threshold on
# its path, and on at most this share of the rows.
VS_SERVE_ATOL = 1e-5
VS_MAX_EXPLAINED = 0.005
VS_THRESHOLD_ULPS = 4
# The default train path (train_default): the JAX package's
# GradientBoostedTreesLearner(label="label") with every default, on
# make_frame's recipe (the 28 numerical columns of make_data with NaNs in
# three of them, four categorical columns), evaluated on fresh rows.
TRAIN_DEFAULT = os.path.join(TESTDATA, "train_default")
DEFAULT_ROWS = 500_000
DEFAULT_TEST_ROWS = 100_000
DEFAULT_CAT_SEED = 7
DEFAULT_CAT_VOCABS = (5, 12, 40, 200)
DEFAULT_MISSING = (0, 5, 11)
DEFAULT_HP = dict(label="label")
DEFAULT_COMPARE_ROWS = 1024
# train_default: evaluate() of the card-trained model against the JAX
# model's metrics on the test rows (a few split flips move them a
# little); the JAX model loaded by the port evaluates to within
# EVAL_SAME_ATOL of the JAX package's own evaluation.
EVAL_ATOL = 2e-3
EVAL_SAME_ATOL = 1e-12
# Trees of phase 8's profiled train: two chunks of the look-ahead stop.
PROFILE_TREES = 50
# train_rf (phase 9): the JAX package's RandomForestLearner(label=
# "label") with every default on make_frame's recipe, 50,000 training
# rows, evaluated on 10,000 fresh ones (ydf_tpu_torch/testdata/train_rf).
# At least RF_SAME_TREES of the trees equal JAX's by hash (a tree that
# differs is explained by a printed gain near-tie); the out-of-bag and
# evaluate accuracy and AUC within EVAL_ATOL; probabilities on the
# stored rows within RF_PROBA_ATOL (max) and RF_PROBA_MEAN_ATOL (mean).
TRAIN_RF = os.path.join(TESTDATA, "train_rf")
RF_ROWS = 50_000
RF_TEST_ROWS = 10_000
RF_HP = dict(label="label")
RF_COMPARE_ROWS = 1024
RF_SAME_TREES = 0.99
RF_PROBA_ATOL = 1e-2
RF_PROBA_MEAN_ATOL = 1e-3
# Trees of phase 9's profiled train.
RF_PROFILE_TREES = 5
# Trees of phase 9's main path: None is the learner's default, the
# fixture's 300; 100, the fixture's cut (its JAX out-of-bag, test
# metrics and probabilities, `--only forest_cuts`), keeps the script
# inside its time limit; a rehearsal on a CPU sets a few (the checks
# that need the whole forest, its out-of-bag and test metrics, then only
# log).
RF_TREES = 100
# Repetitions of phase 9's root-histogram and index_add_ timings (call
# and device time, each).
RF_ROOT_REPS = 50
# train_multiclass (phase 10): the JAX package's
# GradientBoostedTreesLearner(label="label") with every default on the
# three-class variant of make_frame (classes cut from the generator's
# logit plus logistic noise at CLASS_CUTS): 200,000 training rows,
# evaluated on 50,000 fresh ones (ydf_tpu_torch/testdata/
# train_multiclass). The fixture records the K > 1 prediction update XLA
# compiled ("unfused" in every class column, which the port replays), so
# the trees, the kept count and the validation loss at it must equal
# JAX's. The first MC_FULL_ITERATIONS iterations are held node for node
# against the committed JAX model, leaf values bitwise; evaluate's
# accuracy within EVAL_ATOL and
# its loss within MC_LOSS_RTOL (relative); probabilities on the stored
# rows within MC_PROBA_ATOL (max) and MC_PROBA_MEAN_ATOL (mean).
TRAIN_MULTICLASS = os.path.join(TESTDATA, "train_multiclass")
MC_ROWS = 200_000
MC_TEST_ROWS = 50_000
MC_HP = dict(label="label")
MC_COMPARE_ROWS = 1024
CLASS_CUTS = (-0.8, 0.8)
MC_FULL_ITERATIONS = 10
MC_LOSS_RTOL = 2e-3
MC_PROBA_ATOL = 2e-2
MC_PROBA_MEAN_ATOL = 2e-3
# Iterations of phase 10's profiled train.
MC_PROFILE_ITERS = 5
# train_gbt_options (phase 10): one small configuration per ported
# option (ydf_tpu_torch/testdata/train_gbt_options), each held against
# the JAX run: every tree's hash, the kept count, predictions bitwise.
TRAIN_GBT_OPTIONS = os.path.join(TESTDATA, "train_gbt_options")
# train_cart and train_if (phase 11): the JAX package's CartLearner
# (ydf_tpu_torch/testdata/train_cart: make_frame's 500,000 rows, 10% held
# out for pruning, 100,000 to evaluate; a 20,000-row regression CART)
# and IsolationForestLearner (testdata/train_if: the same rows' 32
# feature columns, 300 trees on 256-row subsamples, scored on 100,000
# fresh rows, IF_ANOMALY of them made anomalous). Held bitwise: the
# holdout, the bins, the grown and the pruned trees, every IF tree and
# subsample by hash, the scores.
TRAIN_CART = os.path.join(TESTDATA, "train_cart")
CART_ROWS = 500_000
CART_TEST_ROWS = 100_000
CART_HP = dict(label="label")
TRAIN_IF = os.path.join(TESTDATA, "train_if")
IF_ROWS = 500_000
IF_TEST_ROWS = 100_000
IF_ANOMALY = dict(fraction=0.01, scale=6.0, seed=11)
# Trees phases 11 and 12 grow of each isolation forest (the learner's
# default is 300; the fixtures hold the full runs' trees and the scores
# of their first IF_TREES, `--only if_cuts`): cut to keep the script
# inside its time limit.
IF_TREES = 100
IF_PROFILE_TREES = 5
# train_oblique (phase 12): the JAX package's learners with
# split_axis="SPARSE_OBLIQUE" and every other default
# (ydf_tpu_torch/testdata/train_oblique): the GBT and CART on the frame of
# train_default and train_cart, the random forest on train_rf's (the
# fixture holds its first OBLIQUE_RF_FIXTURE_TREES trees; the card grows
# the default 300), the isolation forest on train_if's. Held bitwise:
# every kept tree by hash, its thresholds, projections and boundaries,
# the predictions and scores.
TRAIN_MONOTONE = os.path.join(TESTDATA, "train_monotone")
TRAIN_DART = os.path.join(TESTDATA, "train_dart")
TRAIN_SETS = os.path.join(TESTDATA, "train_sets")
MONOTONE_CONSTRAINTS = {"f0": 1, "f1": -1, "f2": 1}
DART_ROWS = 100_000
DART_TEST_ROWS = 20_000
DART_HP = dict(label="label", dart_dropout=0.1)
SETS_GBT_ROWS = 200_000
SETS_GBT_TEST_ROWS = 20_000
SETS_RF_ROWS = 20_000
SETS_RF_TEST_ROWS = 5_000
SETS_RF_FIXTURE_TREES = 50
# Trees phase 13's set forest grows on the card (the learner's default is
# 300; cut to keep the whole script well inside its time limit).
SETS_RF_TREES = 50
SETS_CART_ROWS = 100_000
SETS_CART_TEST_ROWS = 20_000
SETS_VOCABS = (60, 500)
SETS_ITEM_A = "t2"
SETS_ITEM_B = "w5"
TRAIN_RANKING = os.path.join(TESTDATA, "train_ranking")
TRAIN_SURVIVAL = os.path.join(TESTDATA, "train_survival")
TRAIN_RANK_OPTIONS = os.path.join(TESTDATA, "train_rank_options")
RANK_QUERIES = 2_000
RANK_TEST_QUERIES = 500
RANK_DOCS = (20, 200)
RANK_FEATURES = 136
RANK_MISSING = (0, 7, 42, 99)
RANK_SKEW = (0.52, 0.32, 0.13, 0.02, 0.01)
RANK_SEED = 21
RANK_TEST_SEED = 22
RANK_HP = dict(label="relevance", task="RANKING", ranking_group="query")
SURV_ROWS = 200_000
SURV_TEST_ROWS = 50_000
SURV_CENSOR_SCALE = 2.5
SURV_HP = dict(label="time", task="SURVIVAL_ANALYSIS",
               label_event_observed="event")
TRAIN_UPLIFT = os.path.join(TESTDATA, "train_uplift")
TRAIN_HONEST = os.path.join(TESTDATA, "train_honest")
TRAIN_SETS_ALONE = os.path.join(TESTDATA, "train_sets_alone")
TRAIN_MULTITASKER = os.path.join(TESTDATA, "train_multitasker")
UPLIFT_FEATURES = 20
UPLIFT_SEED = 31
UPLIFT_ROWS = 50_000
UPLIFT_TEST_ROWS = 10_000
UPLIFT_HP = dict(label="y", task="CATEGORICAL_UPLIFT",
                 uplift_treatment="treat")
# The uplift forest's trees on the card: the fixture's 50 (the learner's
# default is 300; cut to keep the script inside its time limit).
UPLIFT_TREES = 50
UPLIFT_CART_ROWS = 100_000
UPLIFT_NUM_ROWS = 20_000
UPLIFT_NUM_TREES = 30
HONEST_HP = dict(label="label", honest=True)
HONEST_REG_ROWS = 20_000
HONEST_REG_TREES = 30
MULTITASK_SEED = 5
MULTITASK_ROWS = 100_000
MULTITASK_TEST_ROWS = 20_000
YDF_FORMAT = os.path.join(TESTDATA, "ydf_format")
TRAIN_CACHE = os.path.join(TESTDATA, "train_cache")
TRAIN_DISCRETIZED = os.path.join(TESTDATA, "train_discretized")
#: Phase 17: make_frame's train rows in CACHE_SHARDS CSV shards, its
#: test rows in one CSV; the cache built in chunks of CACHE_CHUNK_ROWS,
#: then of CACHE_BIG_CHUNK_ROWS (the same bytes).
CACHE_SHARDS = 4
CACHE_ROWS = 500_000
CACHE_TEST_ROWS = 100_000
CACHE_CHUNK_ROWS = 65_536
CACHE_BIG_CHUNK_ROWS = 500_000
CACHE_HP = dict(label="label")
CACHE_COMPARE_ROWS = 1024
#: The test rows' head that goes through the TFRecord and Avro files (the
#: Python record writer takes about 90 s for 100,000 rows on a CPU).
CACHE_RECORD_ROWS = 4_096
CACHE_PROFILE_TREES = 20
DISC_ROWS = 200_000
DISC_TEST_ROWS = 50_000
DISC_HP = dict(label="label", discretize_numerical_columns=True)
TRAIN_MHLD = os.path.join(TESTDATA, "train_mhld")
MHLD_HP = dict(label="label", split_axis="MHLD_OBLIQUE")
MHLD_PROFILE_TREES = 5
#: Phase 18's timed MHLD train with changing row weights (subsample <
#: 1: the scatter sums a tree on the card, one host read a tree).
MHLD_SUB_HP = dict(MHLD_HP, subsample=0.5, num_trees=5)
RESUME_INTERVAL = 25
RESUME_PREEMPT_AFTER = 3
DEADLINE_S = 3.0
#: Phase 8's and 9's card forests (Forest.to_numpy()), for phase 18's
#: resume and deadline runs.
CARD_FORESTS = {}
IO_PREDICT_ROWS = 1_048_576
IO_TRAIN_ROWS = 100_000
IO_TRAIN_TREES = 20
IO_ROUND_TRIP_ROWS = 10_000
IO_BENCHMARK_ROWS = 65_536
IO_DISTANCE_ROWS = 2_048
# Phase 19 (the mesh): four data shards (distinct cards when there are
# four, else cuda:0 four times); the 2x2 GBT's trees (a prefix of
# train_default's), the 2x2 forest's trees (a prefix of train_rf's), the
# two-process run's frame and trees, the profiled trees.
MESH_SHARDS = 4
MESH_GBT_PREFIX_TREES = 10
MESH_RF_TREES = 10
MESH_RANK_ROWS = 20_000
MESH_RANK_HP = dict(label="label", num_trees=5)
MESH_PROFILE_TREES = 5
TRAIN_DIST = os.path.join(TESTDATA, "train_dist")
# Phase 20: the distributed GBT over two RPC worker processes, from
# phase 17's cache_frames train frame (500,000 rows at full width) in a
# cache of two feature shards; the failover run SIGKILLs worker 1 once
# DIST_KILL_AFTER trees are done.
DIST_ROWS = 500_000
DIST_TEST_ROWS = 100_000
DIST_SHARDS = 2
DIST_HP = dict(label="label", validation_ratio=0.0, num_trees=50)
DIST_KILL_AFTER = 5
DIST_PROFILE_TREES = 5
TRAIN_OBLIQUE = os.path.join(TESTDATA, "train_oblique")
OBLIQUE_HP = dict(label="label", split_axis="SPARSE_OBLIQUE")
OBLIQUE_RF_FIXTURE_TREES = 50
# Trees of phase 12's profiled trains, per path.
OBLIQUE_PROFILE_TREES = dict(gbt=5, rf=3, cart=1, iforest=5)
# Trees phase 12's oblique forest grows on the card (the learner's
# default is 300; its fixture holds the first 50; cut to the fixture's
# to keep the script inside its time limit).
OBLIQUE_RF_TREES = 50
# Tolerances against the JAX package's run. The port's f32 histograms sum
# rows in another order (shared-memory atomics) than the JAX package's
# f64 block partials, so near-tie splits may flip in late trees; the
# first tree's splits must be equal.
TRAIN_LOSS_RTOL = 1e-3
#: The GBT's reported binomial and squared-error losses are torch's own
#: functions, not XLA's sums (learners/losses.py): within this relative
#: tolerance of the JAX package's, the trees bitwise.
REPORTED_LOSS_RTOL = 1e-5
RAW_SCORE_ATOL = 0.05
RAW_SCORE_MEAN_ATOL = 1e-3
# f32 histogram cells: |kernel - plain| <= HIST_RTOL * (sum of |terms|)
# + HIST_ATOL (the order of the shared-memory atomics varies by run).
HIST_RTOL = 1e-5
HIST_ATOL = 1e-6


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def draw_requests(req, rows, rng):
    """`rows` rows drawn from the stored requests, numerical columns
    with seeded noise (NaNs stay NaN)."""
    idx = rng.integers(0, len(next(iter(req.values()))), rows)
    out = {}
    for k, v in req.items():
        col = v[idx]
        if col.dtype == np.float32:
            col = col + rng.normal(0, 0.05, rows).astype(np.float32)
        out[k] = col
    return out


def synth_higgs_chunk(rng, rows, features):
    """bench.py:synth_higgs_chunk: the bench's synthetic Higgs-shaped
    rows (features f32 normal, a binary label from a non-linear logit)."""
    x = rng.normal(size=(rows, features)).astype(np.float32)
    logit = x[:, 0] - 0.5 * x[:, 1] + np.sin(2 * x[:, 2]) + x[:, 3] * x[:, 4]
    y = (rng.uniform(size=rows) < 1 / (1 + np.exp(-logit))).astype(np.int64)
    return x, y


def make_data(rows, features):
    """bench.py:make_data: columns f0.. and the int label."""
    x, y = synth_higgs_chunk(np.random.RandomState(DATA_SEED), rows,
                             features)
    data = {f"f{i}": x[:, i] for i in range(features)}
    data["label"] = y
    return data


def logit_class_label(x, seed):
    """scripts/make_torch_port_fixtures.py:logit_class_label: the
    generator's logit of the features x [n, 28] (float64) plus logistic
    noise from default_rng([seed, 3]), cut at CLASS_CUTS (int64)."""
    xd = x.astype(np.float64)
    logit = (xd[:, 0] - 0.5 * xd[:, 1] + np.sin(2 * xd[:, 2])
             + xd[:, 3] * xd[:, 4])
    noise = np.random.default_rng([seed, 3]).logistic(size=len(x))
    return np.digitize(logit + noise, CLASS_CUTS).astype(np.int64)


def make_frame(train_rows, test_rows, seed=DEFAULT_CAT_SEED, classes=2):
    """scripts/make_torch_port_fixtures.py:make_frame with the test rows'
    labels kept: (train, test) columns; numerical f32 (NaNs in
    DEFAULT_MISSING), categorical unicode with some signal about the
    label, an int label (binary, or with classes=3 logit_class_label);
    the test rows carry unseen ("unseen") and missing ("") categories."""
    n = train_rows + test_rows
    data = make_data(n, TRAIN_FEATURES)
    y = data["label"]
    if classes == 3:
        x = np.stack([data[f"f{i}"] for i in range(TRAIN_FEATURES)], 1)
        y = data["label"] = logit_class_label(x, seed)
    rng = np.random.default_rng(seed)
    for j, vocab in enumerate(DEFAULT_CAT_VOCABS):
        code = rng.integers(0, vocab, n)
        third = max(vocab // 3, 1)
        if classes == 2:
            # Positive rows favour the lower third of the vocabulary.
            skew = (y == 1) & (rng.uniform(size=n) < 0.4)
            code = np.where(skew, code % third, code)
        else:
            # Classes 1 and 2 favour the lower and middle thirds.
            skew = (y > 0) & (rng.uniform(size=n) < 0.4)
            code = np.where(skew, code % third + (y - 1) * third, code)
        data[f"c{j}"] = np.array([f"v{c}" for c in code])
    for i in DEFAULT_MISSING:
        miss = rng.uniform(size=n) < 0.03
        data[f"f{i}"] = np.where(miss, np.nan, data[f"f{i}"]).astype(
            np.float32)
    train = {k: v[:train_rows] for k, v in data.items()}
    test = {k: v[train_rows:].copy() for k, v in data.items()}
    for j in range(len(DEFAULT_CAT_VOCABS)):
        col = test[f"c{j}"].astype("<U8")
        col[rng.uniform(size=test_rows) < 0.05] = "unseen"
        col[rng.uniform(size=test_rows) < 0.03] = ""
        test[f"c{j}"] = col
    return train, test


def cache_frames(train_rows, test_rows):
    """make_frame's rows plus a weights column "w" (uniform in [0.5, 2),
    f32) and a treatment "treat" (int, 1 with probability 0.4), drawn
    from default_rng([DEFAULT_CAT_SEED, 17, rows]) for each part: the
    small dataset-cache runs."""
    train, test = make_frame(train_rows, test_rows)
    for part, n in ((train, train_rows), (test, test_rows)):
        rng = np.random.default_rng([DEFAULT_CAT_SEED, 17, n])
        part["w"] = rng.uniform(0.5, 2.0, n).astype(np.float32)
        part["treat"] = (rng.uniform(size=n) < 0.4).astype(np.int64)
    return train, test


def csv_text(cols):
    """A frame as CSV text: a header of the column names, one line a
    row; floats in the shortest repr of their own type
    (`astype(str)`), a NaN as an empty cell; other columns as str."""
    names = list(cols)
    cells = []
    for k in names:
        a = np.asarray(cols[k])
        s = a.astype(str)
        if a.dtype.kind == "f":
            s[np.isnan(a)] = ""
        cells.append(s.tolist())
    return "\n".join([",".join(names)]
                     + [",".join(r) for r in zip(*cells)]) + "\n"


def write_csv_shards(directory, train, test, shards):
    """Writes train-<k>.csv (the train rows cut into `shards` files of
    equal rows) and test.csv; returns the file names."""
    n = len(next(iter(train.values())))
    edges = np.linspace(0, n, shards + 1).astype(np.int64)
    names = []
    for k in range(shards):
        part = {c: v[edges[k]:edges[k + 1]] for c, v in train.items()}
        names.append(f"train-{k}.csv")
        with open(os.path.join(directory, names[-1]), "w") as f:
            f.write(csv_text(part))
    names.append("test.csv")
    with open(os.path.join(directory, names[-1]), "w") as f:
        f.write(csv_text(test))
    return names


def _avro_long(v):
    """Avro's zigzag varint of an int."""
    v = (v << 1) ^ (v >> 63)
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _avro_field(name, a):
    """(schema type, cell encoder) of one column: floats as nullable
    doubles (NaN -> null), ints as longs, strings as nullable strings
    ("" or None -> null), object cells of strings as string arrays, of
    float rows as arrays of float arrays (vector sequences)."""
    import struct

    def string(v):
        b = str(v).encode("utf-8")
        return _avro_long(len(b)) + b

    if a.dtype.kind == "f":
        return ["null", "double"], lambda v: (
            b"\x00" if np.isnan(v) else b"\x02" + struct.pack("<d", v))
    if a.dtype.kind in "iu":
        return "long", lambda v: _avro_long(int(v))
    if a.dtype.kind in "US":
        return ["null", "string"], lambda v: (
            b"\x00" if v == "" else b"\x02" + string(v))
    first = next((v for v in a if v is not None and len(v)), None)
    nested = first is not None and np.ndim(first[0]) == 1

    def array(v, item):
        v = list(v)
        body = b"".join(item(x) for x in v)
        return (_avro_long(len(v)) + body if v else b"") + b"\x00"

    if nested:
        row = lambda x: array(x, lambda f: struct.pack("<f", f))  # noqa
        return ["null", {"type": "array", "items": {
            "type": "array", "items": "float"}}], lambda v: (
            b"\x00" if v is None else b"\x02" + array(v, row))
    return ["null", {"type": "array", "items": "string"}], lambda v: (
        b"\x00" if v is None else b"\x02" + array(v, string))


def write_avro(path, cols, codec="deflate", block_rows=4096):
    """An Avro object container file of the columns (the reader's test
    encoder: one record a row, `codec` "null" or "deflate", a fixed sync
    marker, blocks of block_rows records)."""
    import zlib

    names = list(cols)
    fields = [_avro_field(k, np.asarray(cols[k])) for k in names]
    schema = {"type": "record", "name": "row", "fields": [
        {"name": k, "type": t} for k, (t, _) in zip(names, fields)]}
    sync = bytes(range(16))
    meta = {"avro.schema": json.dumps(schema).encode(),
            "avro.codec": codec.encode()}
    head = bytearray(b"Obj\x01")
    head += _avro_long(len(meta))
    for k, v in meta.items():
        head += _avro_long(len(k)) + k.encode() + _avro_long(len(v)) + v
    head += b"\x00" + sync
    n = len(cols[names[0]])
    cells = [list(np.asarray(cols[k])) for k in names]
    with open(path, "wb") as f:
        f.write(head)
        for s in range(0, n, block_rows):
            e = min(s + block_rows, n)
            block = b"".join(enc(cells[j][i])
                             for i in range(s, e)
                             for j, (_, enc) in enumerate(fields))
            if codec == "deflate":
                c = zlib.compressobj(6, zlib.DEFLATED, -15)
                block = c.compress(block) + c.flush()
            f.write(_avro_long(e - s) + _avro_long(len(block)) + block
                    + sync)


def set_cells(rng, n, vocab, max_items, prefix):
    """n item-set cells: 0..max_items draws a row from a Zipf-like law
    over `vocab` items (p_k ~ 1 / k^1.1), kept once each, sorted."""
    p = 1.0 / np.arange(1, vocab + 1) ** 1.1
    k = rng.integers(0, max_items + 1, n)
    flat = rng.choice(vocab, size=int(k.sum()), p=p / p.sum())
    ends = np.cumsum(k)
    cells = np.empty(n, dtype=object)
    for i, (a, b) in enumerate(zip(ends - k, ends)):
        cells[i] = [f"{prefix}{c}" for c in sorted(set(flat[a:b].tolist()))]
    return cells


def make_set_frame(train_rows, test_rows, seed=DEFAULT_CAT_SEED):
    """train_sets' frame: make_frame's columns plus two CATEGORICAL_SET
    columns, "tags" (SETS_VOCABS[0] items, 0-6 a row) and "words"
    (SETS_VOCABS[1] items, 0-20 a row), with a label redrawn from the
    generator's logit plus 1.5 if the row's tags hold SETS_ITEM_A and
    -1.0 if its words hold SETS_ITEM_B and f0 > 0 (after
    tests/test_categorical_set.py:_toy_set_data). 1% of the training
    cells and 3% of the test cells are missing (None); 5% of the test
    cells gain an unseen item."""
    train, test = make_frame(train_rows, test_rows, seed)
    n = train_rows + test_rows
    rng = np.random.default_rng([seed, 13])
    tags = set_cells(rng, n, SETS_VOCABS[0], 6, "t")
    words = set_cells(rng, n, SETS_VOCABS[1], 20, "w")
    x = make_data(n, TRAIN_FEATURES)  # the frame's values, before NaNs
    xd = np.stack([x[f"f{i}"] for i in range(5)], 1).astype(np.float64)
    logit = (xd[:, 0] - 0.5 * xd[:, 1] + np.sin(2 * xd[:, 2])
             + xd[:, 3] * xd[:, 4]
             + 1.5 * np.array([SETS_ITEM_A in c for c in tags])
             - 1.0 * (np.array([SETS_ITEM_B in c for c in words])
                      & (xd[:, 0] > 0)))
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-logit))).astype(np.int64)
    for cells, frac in ((tags, 0.01), (words, 0.01)):
        miss = rng.uniform(size=n) < np.where(np.arange(n) < train_rows,
                                              frac, 0.03)
        cells[miss] = None
    unseen = rng.uniform(size=(2, n)) < 0.05
    for j, cells in enumerate((tags, words)):
        for i in np.flatnonzero(unseen[j, train_rows:]) + train_rows:
            if cells[i] is not None:
                cells[i] = cells[i] + ["unseen"]
    train.update(tags=tags[:train_rows], words=words[:train_rows],
                 label=y[:train_rows])
    test.update(tags=tags[train_rows:], words=words[train_rows:],
                label=y[train_rows:])
    return train, test


def make_uplift_frame(train_rows, test_rows, seed=UPLIFT_SEED,
                      numerical=False):
    """train_uplift's frame, shaped like the reference's sim_pte data
    (the R uplift package's sim_pte simulation): UPLIFT_FEATURES
    covariates x1.. (standard normals of correlation 0.2, f32), a
    treatment "treat" (1 control, 2 treated; 45% treated, so that
    control is the most frequent value), and an outcome "y" from a
    logistic model with main effects of x1-x4 and a treatment effect
    that depends on x1-x3 (sim_pte's +-1 treatment coding): a 0/1 draw,
    or with numerical=True the logit plus normal noise (f32). 2% of the
    test rows carry an unseen treatment (3)."""
    n = train_rows + test_rows
    rng = np.random.default_rng([seed, 17])
    z0 = rng.standard_normal(n)
    x = (np.sqrt(0.2) * z0[:, None] + np.sqrt(0.8) * rng.standard_normal(
        (n, UPLIFT_FEATURES))).astype(np.float32)
    xd = x.astype(np.float64)
    treated = rng.uniform(size=n) < 0.45
    t = np.where(treated, 1.0, -1.0)
    effect = 0.6 * xd[:, 0] + 0.5 * (xd[:, 1] > 0) - 0.3 * xd[:, 2]
    logit = -0.8 + 0.25 * xd[:, :4].sum(1) + 0.5 * t * effect
    if numerical:
        y = (logit + rng.normal(0.0, np.sqrt(2.0), n)).astype(np.float32)
    else:
        y = (rng.uniform(size=n) < 1 / (1 + np.exp(-logit))).astype(
            np.int64)
    treat = np.where(treated, 2, 1).astype(np.int64)
    treat[train_rows:][rng.uniform(size=test_rows) < 0.02] = 3
    data = {f"x{i + 1}": x[:, i] for i in range(UPLIFT_FEATURES)}
    data.update(treat=treat, y=y)
    train = {k: v[:train_rows] for k, v in data.items()}
    test = {k: v[train_rows:].copy() for k, v in data.items()}
    return train, test


def sets_alone_frame(train_rows, test_rows, seed=DEFAULT_CAT_SEED):
    """train_sets_alone's frame: make_set_frame's two CATEGORICAL_SET
    columns and its label only (no scalar feature)."""
    frames = make_set_frame(train_rows, test_rows, seed)
    return tuple({k: f[k] for k in ("tags", "words", "label")}
                 for f in frames)


def multitask_target(frame, seed=MULTITASK_SEED):
    """The regression target of train_multitasker (and of the honest
    regression forest) on a make_frame frame: 1.5 f0 - f1 + f2 f3 (a
    missing f0 read as 0) plus normal noise of scale 0.5 from
    default_rng([seed, 19, rows]), f32."""
    x = [np.nan_to_num(frame[f"f{i}"].astype(np.float64)) for i in range(4)]
    n = len(x[0])
    noise = np.random.default_rng([seed, 19, n]).normal(0.0, 0.5, n)
    return (1.5 * x[0] - x[1] + x[2] * x[3] + noise).astype(np.float32)


def make_rank_frame(queries, seed=RANK_SEED, docs=RANK_DOCS,
                    features=RANK_FEATURES, first_query=0):
    """A frame shaped like MSLR-WEB10K/30K (the ranking cells): `queries`
    query groups ("query", int64 ids from first_query) of uniform
    docs[0]..docs[1] documents, `features` numerical f32 columns f0..
    (standard normal, plus a per-query offset on the first 16; 3% NaN in
    the RANK_MISSING columns) and an int64 "relevance" 0-4 cut at the quantiles of
    a latent score (a non-linear function of f0-f9 plus noise) that give
    MSLR's skew RANK_SKEW. Draws from default_rng([seed, 14])."""
    rng = np.random.default_rng([seed, 14])
    sizes = rng.integers(docs[0], docs[1] + 1, queries)
    n = int(sizes.sum())
    qid = np.repeat(np.arange(first_query, first_query + queries), sizes)
    x = rng.standard_normal((n, features), dtype=np.float32)
    shifted = min(16, features)
    x[:, :shifted] += np.repeat(
        rng.standard_normal((queries, shifted), dtype=np.float32), sizes, 0)
    xd = np.pad(x[:, :10].astype(np.float64),
                ((0, 0), (0, max(0, 10 - features))))
    latent = (xd[:, 0] + 0.7 * xd[:, 1] - 0.5 * xd[:, 2]
              + np.sin(2 * xd[:, 3]) + 0.5 * xd[:, 4] * xd[:, 5]
              + 0.3 * np.abs(xd[:, 6]) - 0.3 * xd[:, 7] ** 2 / 2
              + 0.2 * xd[:, 8] + rng.standard_normal(n))
    cuts = np.quantile(latent, np.cumsum(RANK_SKEW)[:-1])
    data = {"query": qid, "relevance": np.digitize(latent, cuts)}
    for i in range(features):
        col = x[:, i]
        if i in RANK_MISSING:
            col = np.where(rng.uniform(size=n) < 0.03, np.nan, col).astype(
                np.float32)
        data[f"f{i}"] = np.ascontiguousarray(col)
    return data


def rank_frames(queries, docs=RANK_DOCS, features=RANK_FEATURES,
                test_queries=None, seed=RANK_SEED, test_seed=RANK_TEST_SEED):
    """(train, test) of a ranking cell: make_rank_frame's `queries` and,
    from `test_seed`, `test_queries` (default max(queries // 4, 20))
    fresh queries numbered after them."""
    if test_queries is None:
        test_queries = max(queries // 4, 20)
    return (make_rank_frame(queries, seed, docs, features),
            make_rank_frame(test_queries, test_seed, docs, features,
                            first_query=queries))


def make_surv_frame(train_rows, test_rows, seed=DEFAULT_CAT_SEED,
                    entry=False, weights=False):
    """The survival cells' frame: make_frame's 32 feature columns (its
    label dropped), a departure age "time" (f32) and an event flag
    "event" (bool). Departures are exponential with the log hazard
    0.6 f0 - 0.4 f1 + 0.3 sin(2 f2) + 0.3 f3 f4 (missing values as 0),
    censored by an independent exponential of scale SURV_CENSOR_SCALE
    (about 30% censored). With `entry`, an entry age "entry" (a uniform
    share up to half of each time); with `weights`, example weights "w"
    (uniform 0.5-1.5). Draws from default_rng([seed, 15])."""
    train, test = make_frame(train_rows, test_rows, seed)
    n = train_rows + test_rows
    rng = np.random.default_rng([seed, 15])
    x = np.stack([np.concatenate([train[f"f{i}"], test[f"f{i}"]])
                  for i in range(5)], 1).astype(np.float64)
    x = np.nan_to_num(x)
    loghaz = (0.6 * x[:, 0] - 0.4 * x[:, 1] + 0.3 * np.sin(2 * x[:, 2])
              + 0.3 * x[:, 3] * x[:, 4])
    departure = rng.exponential(np.exp(-loghaz))
    censor = rng.exponential(SURV_CENSOR_SCALE, n)
    cols = {"time": np.minimum(departure, censor).astype(np.float32),
            "event": departure <= censor}
    if entry:
        cols["entry"] = (cols["time"] * rng.uniform(0, 0.5, n)).astype(
            np.float32)
    if weights:
        cols["w"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
    for frame, rows in ((train, slice(0, train_rows)),
                        (test, slice(train_rows, n))):
        del frame["label"]
        frame.update({k: v[rows] for k, v in cols.items()})
    return train, test


def if_test_frame(test, anomaly=None):
    """train_if's scored rows: the test frame's feature columns, with a
    seeded share of the rows (default_rng(seed).choice without
    replacement) made anomalous, every numerical column times `scale`
    (NaNs stay NaN). Returns (columns, anomalous int64 [n])."""
    anomaly = anomaly or IF_ANOMALY
    n = len(test["label"])
    rows = np.random.default_rng(anomaly["seed"]).choice(
        n, int(round(n * anomaly["fraction"])), replace=False)
    anomalous = np.zeros(n, np.int64)
    anomalous[rows] = 1
    out = {}
    for k, v in test.items():
        if k == "label":
            continue
        if v.dtype == np.float32:
            v = v.copy()
            v[rows] *= np.float32(anomaly["scale"])
        out[k] = v
    return out, anomalous


def frame_sha256(frame):
    """SHA-256 of a frame's columns: names, dtypes, shapes and bytes, in
    name order."""
    import hashlib

    h = hashlib.sha256()
    for name in sorted(frame):
        a = np.ascontiguousarray(frame[name])
        h.update(f"{name}|{a.dtype.str}|{a.shape}|".encode())
        if a.dtype == object:
            # Item-set cells: their items, a missing cell as None.
            h.update(repr([None if c is None else list(c)
                           for c in a.tolist()]).encode())
        else:
            h.update(a.tobytes())
    return h.hexdigest()


#: Where a tiled run-sum kernel (csrc/segment_sum.cu) goes wrong: runs
#: ending on a tile's edge and one past it, a run carried past its tile
#: to the end of the kernel's continuation chunk, a run longer than three
#: tiles, runs of one, one entry, fewer entries than a tile, an exact
#: multiple of the tile, and runs holding +-0, NaN, +-inf and subnormals.
SEGMENT_EDGE_SHAPES = ("tile_edge", "past_edge", "chunk_edge", "long_run",
                       "ones", "one", "small", "tile_multiple", "specials")
#: Stats a run: 1, 3 (every path), 4, 5, 9 (past the 8 the kernel
#: unrolls) and 40 (a smaller tile).
SEGMENT_EDGE_STATS = (1, 3, 4, 5, 9, 40)


def segment_edge_case(shape, S, T, seed=0):
    """(key i64 [E], vals f32 [E, S]) numpy for ops/segment_sum.py at
    tile T: sorted 64-bit keys (negative and huge ones, gaps of 1 to
    2^40), one key a run, the runs laid out as `shape` says
    (SEGMENT_EDGE_SHAPES); values of magnitudes 2^-24 to 2^24, so that
    the order of the adds shows."""
    from ydf_tpu_torch.ops.segment_sum import CONT

    rng = np.random.default_rng(
        [seed, S, T, SEGMENT_EDGE_SHAPES.index(shape)])

    def runs(total, longest=64):
        """Run lengths of 1 to `longest` summing to `total`."""
        out = []
        while total > 0:
            out.append(min(total, int(rng.integers(1, longest + 1))))
            total -= out[-1]
        return out

    lengths = {
        "tile_edge": lambda: [T] + runs(T) + [T] + runs(17),
        "past_edge": lambda: [T + 1] + runs(T - 1) + [T + 1] + runs(19),
        "chunk_edge": lambda: runs(T - 7) + [7 + min(CONT, T)] + runs(13),
        "long_run": lambda: runs(37, 8) + [3 * T + 11] + runs(40, 8),
        "ones": lambda: [1] * (2 * T + 5),
        "one": lambda: [1],
        "small": lambda: runs(T // 2 + 3),
        "tile_multiple": lambda: runs(2 * T, longest=300),
        "specials": lambda: [5] + runs(T + 72),
    }[shape]()
    gaps = np.where(rng.uniform(size=len(lengths)) < 0.5,
                    rng.integers(1, 4, len(lengths)),
                    rng.integers(1, 2 ** 40, len(lengths)))
    run_keys = int(rng.integers(-2 ** 62, -2 ** 61)) + np.cumsum(gaps)
    key = np.repeat(run_keys, lengths).astype(np.int64)
    E = key.shape[0]
    vals = (rng.normal(size=(E, S))
            * np.exp2(rng.integers(-24, 25, (E, S)))).astype(np.float32)
    if shape == "specials":
        pool = np.array([0.0, -0.0, np.nan, np.inf, -np.inf, 1e-45, -3e-39,
                         1e-38, 3.4e38, -3.4e38], np.float32)
        special = rng.uniform(size=(E, S)) < 0.3
        vals[special] = rng.choice(pool, size=int(special.sum()))
        vals[:5] = -0.0  # a run of -0 sums to +0
    return key, vals


def same_bits(got, want):
    """Two f32 tensors (or arrays) equal bit for bit, any NaN equal to any
    NaN: the run sums' contract leaves a NaN's payload open (x86 and
    the card make different ones)."""
    import torch

    got, want = (torch.as_tensor(np.asarray(x) if not isinstance(
        x, torch.Tensor) else x).cpu() for x in (got, want))
    if got.shape != want.shape or got.dtype != want.dtype:
        return False
    both_nan = torch.isnan(got) & torch.isnan(want)
    return bool(((got.view(torch.int32) == want.view(torch.int32))
                 | both_nan).all())


#: The node arrays a forest's tree hash covers, in order (a tree of
#: either package as Forest.to_numpy() holds it).
TREE_HASH_FIELDS = ("feature", "threshold_bin", "is_cat", "cat_mask",
                    "left", "right", "is_leaf", "leaf_value", "cover")
#: The node arrays a set forest's tree hash covers.
SET_TREE_HASH_FIELDS = TREE_HASH_FIELDS + ("is_set",)


def tree_sha256(forest_np, t, nodes=None, fields=TREE_HASH_FIELDS):
    """SHA-256 of tree t's node arrays (`fields` of Forest.to_numpy()),
    of the nodes `nodes` (a bool mask) or all."""
    import hashlib

    h = hashlib.sha256()
    for f in fields:
        a = np.asarray(forest_np[f][t])
        if nodes is not None:
            a = a[nodes]
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def canonical_nan(forest_np):
    """Forest.to_numpy() arrays with every NaN of a float field written
    as the one quiet NaN 0x7FC00000: a NaN a computation makes has
    another payload on x86 (0xFFC00000) than on the card (0x7FFFFFFF)."""
    out = {}
    for k, a in forest_np.items():
        a = np.asarray(a)
        if a.dtype.kind == "f" and np.isnan(a).any():
            a = np.where(np.isnan(a), np.float32(np.nan), a).astype(a.dtype)
        out[k] = a
    return out


def node_depths(forest_np, t):
    """Depth of each node of tree t (-1: no node), from the root down the
    left/right ids of its split nodes."""
    left, right = forest_np["left"][t], forest_np["right"][t]
    leaf = forest_np["is_leaf"][t]
    depth = np.full(left.shape[0], -1, np.int64)
    depth[0] = 0
    for i in range(int(forest_np["num_nodes"][t])):
        if not leaf[i] and depth[i] >= 0:
            depth[left[i]] = depth[right[i]] = depth[i] + 1
    return depth


def layer_sha256s(forest_np, t, max_depth):
    """tree_sha256 of each depth's nodes of tree t, [max_depth + 1]."""
    depth = node_depths(forest_np, t)
    return [tree_sha256(forest_np, t, depth == d)
            for d in range(max_depth + 1)]


def array_sha256(a):
    """SHA-256 of an array's bytes (C order)."""
    import hashlib

    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def make_vs_data(rows, max_len=VS_MAX_LEN, dim=VS_DIM, noise=VS_NOISE,
                 radius=VS_RADIUS, seed=DATA_SEED):
    """The train_vs task, modelled on the JAX package's
    tests/test_vector_sequence.py:_closer_task: column "seq" of
    vector sequences (2% missing cells, 8% empty sequences, the rest of
    uniform length 1..max_len with N(0, 1) vectors of `dim`), `noise`
    N(0, 1) columns x0.., and "label" = 1 where the sequence holds a
    vector within squared distance `radius` of
    c = linspace(-0.8, 0.8, dim). numpy RandomState(seed)."""
    rng = np.random.RandomState(seed)
    u = rng.uniform(size=rows)
    missing = u < 0.02
    empty = (u >= 0.02) & (u < 0.10)
    lens = rng.randint(1, max_len + 1, size=rows)
    lens[missing | empty] = 0
    flat = rng.normal(size=(int(lens.sum()), dim)).astype(np.float32)
    x = rng.normal(size=(rows, noise)).astype(np.float32)
    c = np.linspace(-0.8, 0.8, dim).astype(np.float32)
    d2 = ((flat - c) ** 2).sum(axis=1)
    ends = np.cumsum(lens)
    nonempty = lens > 0
    near = np.zeros(rows, bool)
    near[nonempty] = np.minimum.reduceat(d2, (ends - lens)[nonempty]) < radius
    seq = np.empty(rows, dtype=object)
    for i in range(rows):
        seq[i] = None if missing[i] else flat[ends[i] - lens[i]:ends[i]]
    data = {"seq": seq}
    data.update({f"x{j}": x[:, j] for j in range(noise)})
    data["label"] = near.astype(np.int64)
    return data


# Synthetic forests for the bank kernel (tests/test_torch_bank_vs_redesign.py
# uses them too): trees, numerical and categorical features, mask words,
# share of categorical splits, leaves a tree (cycled over the trees; 0:
# random in 2..200), chain trees (one child of every split a leaf), and
# the max_depth the walk stops at.
BANK_FORESTS = {
    "mixed": (23, 6, 3, 2, 0.4, (0, 1, 2, 0), False, 12),
    # Unbalanced deep trees, cut at max_depth.
    "chain": (5, 4, 2, 8, 0.5, (60, 3, 45), True, 40),
    # W = 0: a categorical split sends every code right.
    "numerical": (17, 7, 2, 0, 0.2, (0, 0, 1), False, 10),
    # Its first tree is larger than a shared tree block (TREE_BLOCK_BYTES).
    "oversize": (6, 8, 4, 8, 0.5, (1500, 0, 0, 0, 0, 0), False, 40),
    # Feature ids of 15 bits and a tree of about 40,000 nodes (16 bits):
    # past a narrow record's 30 bits, packed wide.
    "wide": (2, 16_390, 3, 2, 0.4, (20_000, 40), False, 64),
    # "mixed" with both sides of each root split sent to its left
    # subtree: nodes reached twice, not trees, packed wide.
    "shared": (23, 6, 3, 2, 0.4, (0, 1, 2, 0), False, 12),
}


def bank_forest(name, seed=0):
    """A BANK_FORESTS forest as numpy arrays in the JAX package's layout
    (Forest.to_numpy()): each tree's nodes at shuffled positions below its
    node count (the root at 0), unreachable junk nodes after them,
    finite thresholds everywhere, leaf values 0 at internal nodes."""
    T, Fn, Fc, W, cat_share, leaf_counts, chain, _ = BANK_FORESTS[name]
    rng = np.random.default_rng(seed)
    trees = []
    for t in range(T):
        k = leaf_counts[t % len(leaf_counts)] or int(rng.integers(2, 201))
        nodes = []  # [feature, threshold, is_cat, mask, left, right, value]

        def build(k):
            i = len(nodes)
            nodes.append(None)
            if k == 1:
                nodes[i] = [-1, 0.0, False, np.zeros(W, np.uint32), 0, 0,
                            float(rng.normal())]
                return i
            # A chain's split sends most examples on down its left side.
            kl = k - 1 if chain else int(rng.integers(1, k))
            left, right = build(kl), build(k - kl)
            cat = Fc > 0 and rng.uniform() < cat_share
            mask = rng.integers(0, 2**32, W, dtype=np.uint64).astype(
                np.uint32)
            nodes[i] = [Fn + int(rng.integers(0, Fc)) if cat
                        else int(rng.integers(0, Fn)),
                        0.0 if cat else 2.5 if chain else float(
                            rng.normal()), cat,
                        (mask | np.uint32(0xFFFFFFFE) if chain else mask)
                        if cat else np.zeros(W, np.uint32),
                        left, right, 0.0]
            return i

        build(k)
        trees.append(nodes)
    N = max(len(nodes) for nodes in trees) + 3
    f = {
        "feature": np.full((T, N), -1, np.int32),
        "threshold": rng.normal(size=(T, N)).astype(np.float32),
        "threshold_bin": np.zeros((T, N), np.int32),
        "is_cat": np.zeros((T, N), bool),
        "is_set": np.zeros((T, N), bool),
        "cat_mask": rng.integers(0, 2**32, (T, N, W), dtype=np.uint64
                                 ).astype(np.uint32),
        "left": rng.integers(0, N, (T, N)).astype(np.int32),
        "right": rng.integers(0, N, (T, N)).astype(np.int32),
        "is_leaf": rng.uniform(size=(T, N)) < 0.5,
        "na_left": np.zeros((T, N), bool),
        "leaf_value": rng.normal(size=(T, N, 1)).astype(np.float32),
        "cover": np.ones((T, N), np.float32),
        "oblique_weights": np.zeros((T, 0, 0), np.float32),
        "oblique_na_repl": np.zeros((T, 0, 0), np.float32),
        "vs_anchor": np.zeros((T, 0, 0), np.float32),
        "vs_feat": np.zeros((T, 0), np.int32),
        "vs_is_closer": np.zeros((T, 0), bool),
        "num_nodes": np.array([len(nodes) for nodes in trees], np.int32),
    }
    for t, nodes in enumerate(trees):
        pos = np.r_[0, 1 + rng.permutation(len(nodes) - 1)]
        for i, (feat, thr, cat, mask, left, right, value) in enumerate(nodes):
            k = pos[i]
            leaf = feat < 0
            f["feature"][t, k] = feat
            f["threshold"][t, k] = thr
            f["is_cat"][t, k] = cat
            f["cat_mask"][t, k] = mask
            f["is_leaf"][t, k] = leaf
            f["left"][t, k] = 0 if leaf else pos[left]
            f["right"][t, k] = 0 if leaf else pos[right]
            f["leaf_value"][t, k, 0] = value
    if name == "shared":
        split = ~f["is_leaf"][:, 0]
        f["right"][split, 0] = f["left"][split, 0]
    return f


def both_walks(fn):
    """[fn() in the bank's split walk, fn() in its per-thread walk],
    whatever the rows (bank_scorer.SPLIT_BELOW_ROWS set for each call)."""
    from ydf_tpu_torch.serving import bank_scorer

    keep = bank_scorer.SPLIT_BELOW_ROWS
    try:
        out = []
        for below in (1 << 62, 0):
            bank_scorer.SPLIT_BELOW_ROWS = below
            out.append(fn())
        return out
    finally:
        bank_scorer.SPLIT_BELOW_ROWS = keep


def bank_inputs(name, n, seed=1, inside=False):
    """x_num f32 [n, Fn] with 5% NaN and x_cat i32 [n, Fc] for a
    BANK_FORESTS forest: codes from -3 to 40 past the mask words' 32 W, or,
    with `inside`, within [0, 32 W), where the routed engine's test (a
    negative code takes na_left, a word past W reads as ones) and the
    bank's agree."""
    _, Fn, Fc, W, _, _, _, _ = BANK_FORESTS[name]
    rng = np.random.default_rng(seed)
    x_num = rng.normal(size=(n, Fn)).astype(np.float32)
    x_num[rng.uniform(size=x_num.shape) < 0.05] = np.nan
    lo, hi = (0, 32 * W) if inside else (-3, 32 * max(W, 1) + 40)
    return x_num, rng.integers(lo, hi, (n, Fc)).astype(np.int32)


def encoded_xT(model, data):
    """The engines' input: xT f32 [F, n] on the model's device."""
    import torch

    from ydf_tpu_torch.dataset.dataset import Dataset
    from ydf_tpu_torch.serving.quickscorer import feature_major

    x_num, x_cat = model._encode_inputs(
        Dataset.from_data(data, model.dataspec)
    )
    dev = model.device
    return feature_major(torch.from_numpy(x_num).to(dev),
                         torch.from_numpy(x_cat).to(dev))


def time_ms(fn, reps):
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# The CUDA kernels one call of each wrapper launches, once each (names
# as the profiler shows them contain these).
KERNELS_OF = {
    "quickscorer": ("qs_score_kernel",),
    "bank_scorer": ("bank_walk_kernel",),  # at TIMING_ROWS; fewer rows
                                           # launch bank_split_kernel
    "histogram": ("hist_kernel", "reduce_partials"),
    "histogram_routed": ("routed_kernel", "reduce_partials"),
    "binning": ("bin_feature_major",),
    "vector_sequence": ("vs_kernel",),
    "segment_sum": ("run_sums",),
}


def device_ms(fn, kernels=(), reps=10, warm=3):
    """Device time of one call of `fn` from torch.profiler over `warm` +
    `reps` calls: for each CUDA kernel, memset or copy, its mean time
    per record times the times one call launches it (its count over the
    calls, rounded, so a stray record counts for nothing). The profiler
    drops records now and then, the window's first most often (hence
    the `warm` calls): a profile counts only if each of `kernels` (name
    parts of the kernels one call launches, KERNELS_OF for a wrapper)
    shows at least `reps` times, and is taken again if not. Returns (ms,
    how). Without such a profile it falls back to CUDA events around
    each call alone, which also bracket the call's host work while the
    card waits: an upper bound, marked so."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    calls = warm + reps
    seen = {}
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        recs = [e for e in prof.key_averages()
                if str(getattr(e, "device_type", "")).endswith("CUDA")
                and getattr(e, "device_time_total", 0.0) > 0]
        seen = {k: sum(e.count for e in recs if k in e.key)
                for k in kernels}
        if not recs or min(seen.values(), default=reps) < reps:
            continue
        busy_us = sum(e.device_time_total / e.count
                      * round(e.count / calls) for e in recs)
        return busy_us / 1e3, "profiler"
    total = 0.0
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    counts = ", ".join(f"{k} {c} of {calls}" for k, c in seen.items())
    return total / reps, ("events, an upper bound; last profile: "
                          f"{counts or 'no device records'}")


def shared_atomics_finding(cuda_build):
    """What shared-memory atomics the two histogram sources compile to on
    sm_90a, read from the SASS (cuobjdump -sass). Both add float stats in
    tag rounds (no float atomics) and int8 stats with int32 atomicAdd;
    histogram_routed.cu also ranks rows with int32 atomics. An f64 shared
    atomicAdd would show as a 64-bit compare-and-swap loop
    (ATOMS.CAST.SPIN.64). scripts/bench_shared_adds.py times the f32
    ways."""
    tool = os.path.join(os.path.dirname(cuda_build.find_nvcc()),
                        "cuobjdump")
    if not os.path.isfile(tool):
        return f"cuobjdump not found beside nvcc ({tool}): SASS not read"
    found, cas64 = [], False
    for name in ("histogram_routed", "histogram"):
        sass = subprocess.run(
            [tool, "-sass", cuda_build.library_path(name)],
            capture_output=True, text=True, timeout=120, check=True,
        ).stdout
        ops = sorted({tok.rstrip(" ;") for line in sass.splitlines()
                      for tok in line.split() if tok.startswith("ATOMS")})
        found.append(f"{name}: {ops or 'no shared atomics'}")
        cas64 = cas64 or any("CAS" in op and "64" in op for op in ops)
    verdict = ("a 64-bit compare-and-swap loop remains" if cas64 else
               "no 64-bit compare-and-swap loop")
    return f"{verdict} ({'; '.join(found)})"


def pileup_case(n=200_000, F=36, B=256, frac=0.12, seed=12):
    """The root histogram at train_vs's width with frac of the rows in
    bin 0 of every feature (empty vector sequences pile up there):
    bins_t u8 [F, n], slot i32 [n] (all 0), integer-valued stats f32
    [n, 3] in -8..8, and real-valued f32 stats [n, 3], on the card."""
    import torch

    rng = np.random.default_rng(seed)
    bins = rng.integers(0, B, (F, n)).astype(np.uint8)
    bins[:, rng.uniform(size=n) < frac] = 0
    dev = torch.device(DEVICE)
    ints = rng.integers(-8, 9, (n, 3)).astype(np.float32)
    real = rng.normal(size=(n, 3)).astype(np.float32)
    return (torch.from_numpy(bins).to(dev),
            torch.zeros(n, dtype=torch.int32, device=dev),
            torch.from_numpy(ints).to(dev), torch.from_numpy(real).to(dev))


def pileup_check():
    """The pile-up case against the plain version: integer-valued stats
    bitwise in f32, bf16 and int8; real f32 stats within HIST_RTOL x cell
    mass + HIST_ATOL. Returns the real stats' max abs difference."""
    import torch

    from ydf_tpu_torch.ops import histogram_kernels as hk

    bins_t, slot, ints, real = pileup_case()
    B = 256
    for stats in (ints, ints.to(torch.bfloat16), ints.to(torch.int8)):
        got = hk.histogram(bins_t, slot, stats, 1, B)
        torch.cuda.synchronize()
        assert torch.equal(got, hk.histogram_plain(bins_t, slot, stats, 1,
                                                   B)), (
            f"pile-up {stats.dtype}: kernel != plain")
    return hist_check(
        hk.histogram(bins_t, slot, real, 1, B),
        hk.histogram_plain(bins_t, slot, real, 1, B),
        hk.histogram_plain(bins_t, slot, real.abs(), 1, B),
        "pile-up f32")


def table_bytes(tables):
    return sum(t.numel() * t.element_size() for t in tables
               if hasattr(t, "element_size"))


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import ydf_tpu_torch
    from ydf_tpu_torch.ops.routing import forest_predict_values
    from ydf_tpu_torch.serving import bank_scorer, quickscorer
    from ydf_tpu_torch.utils import cuda_build

    # -- 1 device ------------------------------------------------------ #
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi_line()
    log("1 device", f"{kind}; count={count}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    print(smi, flush=True)

    # -- 2 build ------------------------------------------------------- #
    sources = ["quickscorer", "bank_scorer", "histogram", "histogram_routed",
               "binning", "vector_sequence", "segment_sum"]
    secs = cuda_build.build_all(sources, force=True)
    # ptxas's registers, shared memory and spills of each entry function,
    # after the (mangled) name ptxas prints before them.
    ptxas, entry = [], ""
    for name, text in cuda_build.BUILD_LOGS.items():
        for line in text.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else ""
            elif "Used" in line or "spill" in line:
                ptxas.append(f"{name} {entry}: {line.strip()}")
    log("2 build", f"nvcc sm_90a, {len(sources)} sources in parallel, "
        f"{secs:.2f} s; " + " | ".join(ptxas))
    log("2 sass", shared_atomics_finding(cuda_build))

    # -- 3 kernels against plain, at full width ------------------------ #
    rng = np.random.default_rng(0)
    paths = {m: os.path.join(TESTDATA, m) for m in ("gbt_d6", "gbt_d8")}
    req = {m: dict(np.load(os.path.join(p, "requests.npz")))
           for m, p in paths.items()}
    m6 = ydf_tpu_torch.load_model(paths["gbt_d6"])
    m8 = ydf_tpu_torch.load_model(paths["gbt_d8"])
    qs6 = quickscorer.build_quickscorer(m6)
    bank6 = bank_scorer.build_bank_scorer(m6)
    bank8 = bank_scorer.build_bank_scorer(m8)
    assert qs6 is not None and bank6 is not None and bank8 is not None
    assert quickscorer.build_quickscorer(m8) is None, "d8 fits QuickScorer?"
    # One main path per (kernel, model): (summary name, model key, forced
    # engine or None for the registry's choice, kernel module, tables,
    # the same model's bank tables (they count the least work), source,
    # TPU kernel replaced).
    main_paths = (
        ("bank_scorer/gbt_d6", "gbt_d6", None, bank_scorer, bank6.tables,
         bank6.tables, "ydf_tpu_torch/csrc/bank_scorer.cu",
         "ydf_tpu/serving/pallas_scorer.py:118"),
        ("quickscorer/gbt_d6/forced", "gbt_d6", "QuickScorer", quickscorer,
         qs6.tables, bank6.tables, "ydf_tpu_torch/csrc/quickscorer.cu",
         "ydf_tpu/serving/quickscorer.py:232"),
        ("bank_scorer/gbt_d8", "gbt_d8", None, bank_scorer, bank8.tables,
         bank8.tables, "ydf_tpu_torch/csrc/bank_scorer.cu",
         "ydf_tpu/serving/pallas_scorer.py:118"),
    )
    models = {"gbt_d6": m6, "gbt_d8": m8}
    max_err = {}
    for label, model_key, _, mod, tables, _, _, _ in main_paths:
        model = models[model_key]
        xT = encoded_xT(model, draw_requests(req[model_key], COMPARE_ROWS,
                                             rng))
        got = mod.score(tables, xT)
        torch.cuda.synchronize()
        want = mod.score_plain(tables, xT)
        F = model.binner.num_numerical
        oracle = forest_predict_values(
            model.forest, xT[:F].t().contiguous(),
            xT[F:].t().to(torch.int32).contiguous(),
            num_numerical=F, max_depth=model.max_depth,
        )[:, 0]
        max_err[label] = float((got - want).abs().max())
        assert torch.equal(got, want), (
            f"{label}: kernel != plain ({max_err[label]})")
        assert torch.equal(got, oracle), f"{label}: kernel != routed oracle"
        walks = ""
        if mod is bank_scorer:  # both walks, whichever the rows pick
            for walk, got in zip(("split", "per-thread"), both_walks(
                    lambda: mod.score(tables, xT))):
                assert torch.equal(got, want), f"{label} {walk}: != plain"
            walks = " (the split and the per-thread walk)"
        log("3 kernels", f"{label}: {COMPARE_ROWS} rows, "
            f"{model.forest.feature.shape[0]} trees, torch.equal to plain "
            f"and to the routed oracle{walks}")
    for name in ("oversize", "wide", "shared"):
        max_err[f"bank_scorer/{name}"] = synthetic_check(name)

    # -- 4-5 main paths: load, predict, serve; then time the kernel ----- #
    counters = (quickscorer, bank_scorer)
    kernels = []
    for (label, name, forced, mod, tables, walk_tables, src,
         replaces) in main_paths:
        model = ydf_tpu_torch.load_model(paths[name])
        model.force_engine(forced)
        for c in counters:
            c.KERNEL_LAUNCHES = 0
            c.KERNEL_ROWS = 0
        cuda_build.LAUNCH_EVENTS = []
        drive_path(model, name, forced, req[name], paths[name], rng)
        torch.cuda.synchronize()
        events, cuda_build.LAUNCH_EVENTS = cuda_build.LAUNCH_EVENTS, None
        launches = {c.__name__: c.KERNEL_LAUNCHES for c in counters}
        short = mod.__name__.rsplit(".", 1)[-1]
        # Each launch's rows (the event's name) and CUDA-event time.
        per_launch = [(int(k.split("/rows=")[1]), s.elapsed_time(e))
                      for k, s, e in events if k.split("/")[0] == short]
        path_ms = sum(ms for _, ms in per_launch)
        # The path's launches weighted by their rows, in launches of
        # TIMING_ROWS rows (the size the kernel is timed at below).
        path_launches = mod.KERNEL_ROWS / TIMING_ROWS
        for c in counters:
            want_used = c is mod
            assert (launches[c.__name__] > 0) == want_used, (
                f"{label}: launches {launches}")
        log("4-5 launches", f"{label}: {launches[mod.__name__]} launches "
            f"of {short} on this path ({mod.KERNEL_ROWS} rows: "
            f"{path_launches:.4f} launches of {TIMING_ROWS} rows), none of "
            f"the other kernel; path time {path_ms:.4f} ms (CUDA events "
            "around each launch); each launch (rows:ms) " + " ".join(
                f"{r}:{ms:.4f}" for r, ms in per_launch))

        xT = encoded_xT(model, draw_requests(req[name], TIMING_ROWS, rng))
        t = measure(mod, tables, walk_tables, xT)
        max_err[label] = max(max_err[label], t["max_abs_err"])
        log("5 timing", f"{label} at {xT.shape[1]} rows x "
            f"{xT.shape[0]} features: kernel {t['ms']:.4f} ms a call back "
            f"to back, {t['device_ms']:.4f} ms on the card "
            f"({t['device_how']}), plain "
            f"{t['plain_ms']:.2f} ms, bound {t['bound_ms']:.4f} ms "
            f"({t['bound_by']}; {t['detail']}), {smi}")
        kernels.append({
            "name": label, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[mod.__name__],
            "max_abs_err": max_err[label], "ms": t["ms"],
            "device_ms": t["device_ms"],
            "device_how": t["device_how"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None,
            "library_device_ms": None,
            "path_ms": path_ms, "path_how": "CUDA events around each launch",
            "path_launch_ms": per_launch,
            "path_launches_at_timing_rows": path_launches,
            "path_bound_ms": t["bound_ms"] * path_launches,
        })
    registry_check(kernels, models["gbt_d6"], smi)
    torch.cuda.synchronize()
    kernels.extend(train_path(smi, serving=counters))
    torch.cuda.synchronize()
    kernels.extend(vs_path(smi, serving=counters))
    torch.cuda.synchronize()
    kernels.extend(default_path(smi, serving=counters))
    torch.cuda.synchronize()
    kernels.extend(rf_path(smi, serving=counters))
    torch.cuda.synchronize()
    kernels.extend(multiclass_path(smi, serving=counters))
    torch.cuda.synchronize()
    kernels.extend(cart_if_path(smi, serving=counters))
    torch.cuda.synchronize()
    kernels.extend(oblique_path(smi, serving=counters))
    torch.cuda.synchronize()
    kernels.extend(set_path(smi, serving=counters))
    torch.cuda.synchronize()
    kernels.extend(rank_surv_path(smi, serving=counters))
    torch.cuda.synchronize()
    kernels.extend(uplift_honest_sets_path(smi, serving=counters))
    torch.cuda.synchronize()
    kernels.extend(model_io_path(smi, serving=counters))
    torch.cuda.synchronize()
    kernels.extend(cache_path(smi, serving=counters))
    torch.cuda.synchronize()
    kernels.extend(robust_path(smi, serving=counters))
    torch.cuda.synchronize()
    kernels.extend(mesh_path(smi, serving=counters))
    torch.cuda.synchronize()
    kernels.extend(dist_path(smi, serving=counters))
    torch.cuda.synchronize()
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


def synthetic_check(name):
    """The bank kernel on a BANK_FORESTS forest, both walks, torch.equal
    to plain and to the routed oracle: "oversize", whose first tree is
    larger than a shared tree block (walked from its packed records in
    global memory); "wide" and "shared", packed in wide records. Returns
    the max abs difference to plain (0)."""
    import torch

    import ydf_tpu_torch
    from ydf_tpu_torch.ops.routing import forest_predict_values
    from ydf_tpu_torch.serving import bank_scorer
    from ydf_tpu_torch.serving.quickscorer import feature_major

    _, Fn, _, _, _, _, _, max_depth = BANK_FORESTS[name]
    forest = ydf_tpu_torch.forest_from_jax(bank_forest(name)).to(DEVICE)
    tables = bank_scorer.make_tables(forest, max_depth, DEVICE)
    biggest = 16 * int(tables.tree_off.diff().max())
    assert tables.wide == (name != "oversize"), (name, tables.wide)
    if name != "shared":
        assert biggest > bank_scorer.TREE_BLOCK_BYTES, biggest
    x_num, x_cat = (torch.from_numpy(a).to(DEVICE) for a in bank_inputs(
        name, COMPARE_ROWS, inside=True))
    xT = feature_major(x_num, x_cat)
    want = bank_scorer.score_plain(tables, xT)
    oracle = forest_predict_values(forest, x_num, x_cat, num_numerical=Fn,
                                   max_depth=max_depth)[:, 0]
    assert torch.equal(want, oracle), f"{name}: plain != routed oracle"
    err = 0.0
    for walk, got in zip(("split", "per-thread"), both_walks(
            lambda: bank_scorer.score(tables, xT))):
        torch.cuda.synchronize()
        assert torch.equal(got, want), f"{name} {walk}: != plain"
        err = max(err, float((got - want).abs().max()))
    log("3 kernels", f"bank_scorer/{name}: {COMPARE_ROWS} rows x "
        f"{xT.shape[0]} features, {forest.num_trees} trees, "
        f"{'wide' if tables.wide else 'narrow'} records, the largest tree "
        f"{biggest} bytes packed (a tree block holds "
        f"{bank_scorer.TREE_BLOCK_BYTES}; larger ones are walked in global "
        "memory), both walks torch.equal to plain and to the routed oracle")
    return err


def registry_check(kernels, model, smi):
    """The registry's order against the card's: QuickScorer's and the
    bank's device times on gbt_d6 at TIMING_ROWS rows. The registry must
    pick the faster engine when one is faster by more than 10%."""
    dev = {k["name"]: k["device_ms"] for k in kernels}
    qs_ms = dev["quickscorer/gbt_d6/forced"]
    bank_ms = dev["bank_scorer/gbt_d6"]
    faster = "QuickScorer" if qs_ms < bank_ms else "BankScorer"
    picked = model.list_compatible_engines()[0]
    log("5 registry", f"gbt_d6 at {TIMING_ROWS} rows on the card: "
        f"QuickScorer {qs_ms:.4f} ms, BankScorer {bank_ms:.4f} ms, so "
        f"{faster} is faster ({max(qs_ms, bank_ms) / min(qs_ms, bank_ms):.2f}"
        f"x); the registry picks {picked} (compatible, by rank: "
        f"{model.list_compatible_engines()}), {smi}")
    if max(qs_ms, bank_ms) > 1.1 * min(qs_ms, bank_ms):
        assert picked == faster, f"the registry picks {picked}, {faster} is"


def drive_path(model, name, forced, stored, path, rng):
    """One main path through the user's entry points: predict on the
    stored rows against the JAX package's expected.npz, serving batches
    of every size in SERVE_BATCHES, and a stage split of the largest."""
    import torch

    engine = forced or "auto"
    exp = np.load(os.path.join(path, "expected.npz"))
    raw = model._raw_scores(stored, combine="sum")[:, 0]
    pred = model.predict(stored)
    assert np.array_equal(raw.view(np.int32), exp["raw"].view(np.int32)), (
        f"{name} {engine}: raw scores differ from JAX "
        f"(max {np.abs(raw - exp['raw']).max()})")
    np.testing.assert_allclose(pred, exp["predictions"], rtol=0, atol=1e-6)
    log("4 predict", f"{name} engine={engine}: {len(raw)} rows, raw bitwise "
        f"== JAX, predictions within 1e-6 "
        f"(max {np.abs(pred - exp['predictions']).max():.3g})")

    walls = []
    for rows in SERVE_BATCHES:
        batch = draw_requests(stored, rows, rng)
        t0 = time.perf_counter()
        pred = model.predict(batch)
        torch.cuda.synchronize()
        walls.append(f"{rows}:{(time.perf_counter() - t0) * 1e3:.3f}ms")
        assert pred.shape == (rows,) and np.isfinite(pred).all()
        if rows == COMPARE_ROWS:
            model.force_engine("Routed")
            routed = model.predict(batch)
            model.force_engine(forced)
            assert np.array_equal(pred, routed), f"{name} {engine}: != Routed"
    log("5 serve", f"{name} engine={engine} predict host wall (rows:ms) "
        + " ".join(walls))
    stages = predict_stages(model, draw_requests(stored, SERVE_BATCHES[-1],
                                                 rng))
    log("5 stages", f"{name} engine={engine} predict of {SERVE_BATCHES[-1]} "
        "rows, ms: " + " ".join(f"{k}={v:.3f}" for k, v in stages.items()))


def predict_stages(model, data):
    """Host-clock split of one predict (each stage ends in a
    synchronize): dataset wrap + host encoding, copy to the card,
    feature-major assembly, engine, copy back."""
    import torch

    from ydf_tpu_torch.dataset.dataset import Dataset
    from ydf_tpu_torch.serving.quickscorer import feature_major

    marks = [("start", time.perf_counter())]

    def mark(name):
        torch.cuda.synchronize()
        marks.append((name, time.perf_counter()))

    x_num, x_cat = model._encode_inputs(Dataset.from_data(data,
                                                          model.dataspec))
    mark("encode")
    xn = torch.from_numpy(x_num).to(model.device)
    xc = torch.from_numpy(x_cat).to(model.device)
    mark("h2d")
    eng = model._fast_engine()
    xT = feature_major(xn, xc)
    mark("assemble")
    out = eng.score_xT(xT)
    mark("kernel")
    out.cpu().numpy()
    mark("d2h")
    return {name: (t - marks[i][1]) * 1e3
            for i, (name, t) in enumerate(marks[1:])}


def measure(mod, tables, walk_tables, xT, reps=20):
    """Kernel time (CUDA events, after warm-up), the plain version's
    time (once), their max abs difference, and the bound: the larger of
    bytes moved (inputs read once, output written once) over HBM
    bandwidth and the function's least work on these rows over the
    card's 32-bit scalar rate. The least work is the same for both
    kernels: the walk down each tree to the leaf this data reaches (a
    compare and a select per step, counted on `walk_tables`, the same
    model's bank tables) and one add per tree."""
    import torch

    n = xT.shape[1]
    for _ in range(3):
        got = mod.score(tables, xT)
    torch.cuda.synchronize()
    ms = time_ms(lambda: mod.score(tables, xT), reps=reps)
    dev_ms, how = device_ms(lambda: mod.score(tables, xT),
                            KERNELS_OF[mod.__name__.rsplit(".", 1)[-1]])
    plain_ms = time_ms(lambda: mod.score_plain(tables, xT), reps=1)
    want = mod.score_plain(tables, xT)
    assert torch.equal(got, want), f"{mod.__name__} at {n} rows: != plain"
    return {
        "ms": ms, "device_ms": dev_ms, "device_how": how,
        "plain_ms": plain_ms,
        "max_abs_err": float((got - want).abs().max()),
        **score_bound(tables, walk_tables, xT),
    }


def score_bound(tables, walk_tables, xT):
    """The least time of one scoring call (see `measure`): bytes moved
    over HBM bandwidth against the walk's compares, selects and adds
    over the card's 32-bit scalar rate, whichever is larger."""
    from ydf_tpu_torch.serving import bank_scorer

    n = xT.shape[1]
    nbytes = xT.numel() * 4 + table_bytes(tables) + n * 4
    steps = 0
    chunk = bank_scorer.PLAIN_ROW_CHUNK
    for r0 in range(0, n, chunk):
        steps += int(bank_scorer.walk_plain(
            walk_tables, xT[:, r0:r0 + chunk])[1].sum())
    ops = 2 * steps + n * walk_tables.num_trees
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / SCALAR_OPS_PER_S * 1e3
    return {
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "detail": f"{nbytes} bytes -> {bytes_ms:.4f} ms, {ops} ops -> "
                  f"{ops_ms:.4f} ms",
    }


# --------------------------------------------------------------------- #
# 6 train: the bench GBT trained on the card
# --------------------------------------------------------------------- #


def train_path(smi, serving):
    """Phase 6: returns the three training kernels' `kernels` entries."""
    import torch

    import ydf_tpu_torch
    from ydf_tpu_torch.ops import binning, histogram_kernels
    from ydf_tpu_torch.utils import cuda_build

    with open(os.path.join(TRAIN_BENCH, "config.json")) as f:
        cfg = json.load(f)
    assert (cfg["rows"], cfg["features"], cfg["learner"], cfg["data_seed"]) \
        == (TRAIN_ROWS, TRAIN_FEATURES, TRAIN_HP, DATA_SEED), cfg
    with open(os.path.join(TRAIN_BENCH, "binner.json")) as f:
        jax_binner = ydf_tpu_torch.binner_from_jax(json.load(f))
    jax_forest = dict(np.load(os.path.join(TRAIN_BENCH, "forest.npz")))
    exp = np.load(os.path.join(TRAIN_BENCH, "expected.npz"))
    t0 = time.perf_counter()
    data = make_data(TRAIN_ROWS, TRAIN_FEATURES)
    log("6 train", f"data {TRAIN_ROWS} x {TRAIN_FEATURES} (numpy "
        f"RandomState({DATA_SEED})) in {time.perf_counter() - t0:.2f} s; "
        f"JAX fixture impls {cfg['jax_impls']}")

    # -- 6a each training kernel against its plain version ------------- #
    inp = train_inputs(data, jax_binner)
    binning_check(inp["binning"], sha=cfg["bins_sha256"])
    log("6 kernels", f"binning {TRAIN_ROWS} x {TRAIN_FEATURES}: "
        "torch.equal to plain, feature-major in memory; SHA-256 of the bin "
        "matrix == the JAX package's")
    err = {"binning": 0.0}
    err["histogram"] = hist_check(
        histogram_kernels.histogram(*inp["root"]),
        histogram_kernels.histogram_plain(*inp["root"]),
        histogram_kernels.histogram_plain(*abs_stats(inp["root"], 2)),
        "root histogram")
    got = histogram_kernels.histogram_routed(*inp["routed"])
    want = histogram_kernels.histogram_routed_plain(*inp["routed"])
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2]), (
        "routed kernel: new_slot / new_leaf != plain")
    err["histogram_routed"] = hist_check(
        got[0], want[0],
        histogram_kernels.histogram_routed_plain(
            *abs_stats(inp["routed"], 4))[0],
        "routed histogram")
    log("6 kernels", f"root histogram (L=1) and routed layer (L=32, Lh=16) "
        f"at {TRAIN_ROWS} rows: within {HIST_RTOL} x cell mass + "
        f"{HIST_ATOL} of plain (max abs {err['histogram']:.3g}, "
        f"{err['histogram_routed']:.3g}); new_slot, new_leaf torch.equal")
    pile = pileup_check()
    log("6 kernels", "root histogram pile-up case (n=200000, F=36, 12% of "
        "rows in bin 0 of every feature): integer-valued stats torch.equal "
        "to plain in f32, bf16 and int8; real f32 stats within "
        f"{HIST_RTOL} x cell mass + {HIST_ATOL} (max abs {pile:.3g})")

    # -- 6b the main path: train on the card -------------------------- #
    counted = {"histogram": None, "histogram_routed": None,
               "binning": None}
    for k in histogram_kernels.LAUNCHES:
        histogram_kernels.LAUNCHES[k] = 0
    binning.KERNEL_LAUNCHES = 0
    for c in serving:
        c.KERNEL_LAUNCHES = 0
    cuda_build.LAUNCH_EVENTS = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    learner = ydf_tpu_torch.GradientBoostedTreesLearner(device=DEVICE,
                                                        **TRAIN_HP)
    model = learner.train(data)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    events, cuda_build.LAUNCH_EVENTS = cuda_build.LAUNCH_EVENTS, None
    counted.update(histogram_kernels.LAUNCHES)
    counted["binning"] = binning.KERNEL_LAUNCHES
    serving_launches = {c.__name__: c.KERNEL_LAUNCHES for c in serving}
    T, depth = TRAIN_HP["num_trees"], TRAIN_HP["max_depth"]
    assert counted["histogram"] == T, counted
    assert counted["histogram_routed"] == T * (depth - 1), counted
    assert counted["binning"] >= 1, counted
    assert not any(serving_launches.values()), serving_launches
    kernel_ms = {k: 0.0 for k in counted}
    ev_ms, routed_lh = split_events(events)
    kernel_ms.update(ev_ms)
    boost_ms = learner.last_timings["boost_s"] * 1e3
    log("6 launches", f"train_bench: {counted} launches (routed by hist "
        f"slots: {routed_lh}); serving kernels {serving_launches}")
    log("6 train", f"GradientBoostedTreesLearner(**{TRAIN_HP}).train: wall "
        f"{wall * 1e3:.1f} ms (host clock, ends in synchronize); stages "
        + " ".join(f"{k}={v * 1e3:.1f}ms" for k, v in
                   learner.last_timings.items())
        + "; kernel time (CUDA events) "
        + " ".join(f"{k}={v:.3f}ms" for k, v in kernel_ms.items())
        + f", sum {sum(kernel_ms.values()):.3f} ms = "
        f"{100 * sum(kernel_ms.values()) / (wall * 1e3):.2f}% of the wall, "
        f"{100 * (kernel_ms['histogram'] + kernel_ms['histogram_routed']) / boost_ms:.2f}% "
        f"of the boosting loop ({boost_ms:.1f} ms); {smi}")

    # -- 6c against the JAX package's run ------------------------------ #
    assert model.binner.boundaries.tobytes() == \
        jax_binner.boundaries.tobytes(), "boundaries != the JAX package's"
    from ydf_tpu_torch.dataset.dataset import Dataset

    bins = model.binner.transform(
        Dataset.from_data(data, dataspec=model.dataspec), model.device)
    assert sha256(bins) == cfg["bins_sha256"], "bins != the JAX package's"
    pf = model.forest.to_numpy()
    for field in ("feature", "threshold_bin", "left", "right", "is_leaf",
                  "num_nodes"):
        assert np.array_equal(pf[field][0], jax_forest[field][0]), (
            f"tree 0 {field} != the JAX package's")
    split = ~jax_forest["is_leaf"] | ~pf["is_leaf"]
    differ = split & ((pf["feature"] != jax_forest["feature"])
                      | (pf["threshold_bin"] != jax_forest["threshold_bin"])
                      | (pf["is_leaf"] != jax_forest["is_leaf"]))
    per_tree = differ.sum(axis=1)
    loss = np.asarray(model.training_logs["train_loss"], np.float32)
    loss_rel = np.abs(loss / exp["train_loss"] - 1)
    assert loss.shape == exp["train_loss"].shape
    assert loss_rel[-1] <= TRAIN_LOSS_RTOL, (loss[-1], exp["train_loss"][-1])
    x, _ = synth_higgs_chunk(np.random.RandomState(REQUEST_SEED),
                             TRAIN_REQUEST_ROWS, TRAIN_FEATURES)
    req = {f"f{i}": x[:, i] for i in range(TRAIN_FEATURES)}
    raw = model._raw_scores(req, combine="sum")[:, 0] \
        + model.initial_predictions[0]
    raw_exp = exp["raw"] + exp["initial_predictions"][0]
    pred = model.predict(req)
    served = {c.__name__.rsplit(".", 1)[-1]: c.KERNEL_LAUNCHES
              for c in serving}
    assert sum(served.values()) > 0, "predict did not reach a serving kernel"
    assert raw.shape == raw_exp.shape and np.isfinite(raw).all()
    raw_err = np.abs(raw - raw_exp)
    assert raw_err.max() <= RAW_SCORE_ATOL, raw_err.max()
    assert raw_err.mean() <= RAW_SCORE_MEAN_ATOL, raw_err.mean()
    assert np.all((pred >= 0) & (pred <= 1))
    log("6 vs JAX", f"boundaries and bins bitwise == JAX; tree 0 == JAX; "
        f"split nodes differing from JAX over {T} trees: "
        f"{int(per_tree.sum())} (per tree {per_tree.tolist()}); final "
        f"train loss {loss[-1]:.7f} vs {exp['train_loss'][-1]:.7f} (rel "
        f"{loss_rel[-1]:.2e} <= {TRAIN_LOSS_RTOL}; max over iterations "
        f"{loss_rel.max():.2e}); initial prediction "
        f"{model.initial_predictions[0]:.9g} vs "
        f"{exp['initial_predictions'][0]:.9g}; raw scores on "
        f"{TRAIN_REQUEST_ROWS} fresh rows: max abs {raw_err.max():.3g} "
        f"(<= {RAW_SCORE_ATOL}), mean {raw_err.mean():.3g} (<= "
        f"{RAW_SCORE_MEAN_ATOL}); predictions max abs "
        f"{np.abs(pred - exp['predictions']).max():.3g}; the trained model "
        f"served through {served}")

    # -- 6d where the boosting loop's time goes (torch.profiler) ------- #
    prof = profile_train(data)
    log("6 profile", f"one more train under torch.profiler (the profiler "
        f"slows the host): wall {prof['wall_ms']:.1f} ms, boosting loop "
        f"{prof['loop_ms']:.1f} ms; {prof['kernels']} device kernels, "
        f"{prof['busy_ms']:.3f} ms of device time over the whole train, so "
        f"the device is idle at least {100 * prof['idle_share']:.1f}% of "
        f"the loop; largest: " + "; ".join(
            f"{name[:60]} {ms:.3f} ms" for name, ms in prof["top"]))

    # -- 6e each training kernel timed at the path's shapes ------------ #
    out = []
    for name, src, replaces in (
        ("binning", "binning.cu", "ydf_tpu/ops/binning_pallas.py:60"),
        ("histogram", "histogram.cu", "ydf_tpu/ops/histogram_pallas.py:81"),
        ("histogram_routed", "histogram_routed.cu",
         "ydf_tpu/ops/histogram_pallas.py:172"),
    ):
        t = measure_train(name, inp)
        log("6 timing", f"{name} ({t['shape']}): {timing_text(t)}, {smi}")
        out.append(train_entry(name, "train_bench", src, replaces, t,
                               counted[name], err[name], kernel_ms[name]))
        if name == "histogram_routed":
            layers = routed_by_layer(name, inp, events, routed_lh)
            out[-1].update(layer_fields(layers))
            log("6 layers", f"{name} on train_bench by hist slots: "
                f"{layer_text(layers)}, {smi}")
    return out


def train_entry(name, path, src, replaces, t, launches, err, path_ms):
    """A training kernel's `kernels` entry: its timings at the path's
    shape (measure_train) and its CUDA-event time over the path's
    launches."""
    return {
        "name": f"{name}/{path}", "route": "cuda",
        "source": f"ydf_tpu_torch/csrc/{src}", "replaces": replaces,
        "launches": launches, "max_abs_err": err,
        "ms": t["ms"], "device_ms": t["device_ms"],
        "device_how": t["device_how"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": t["library_ms"],
        "library_device_ms": t["library_device_ms"],
        "path_ms": path_ms, "path_how": "CUDA events around each launch",
    }


def layer_fields(layers):
    """The routed kernel's per-layer numbers for its `kernels` entry; the
    path's bound is each layer's bound times its launches."""
    return {
        "by_hist_slots": {str(k): v for k, v in layers.items()},
        "path_bound_ms": sum(v["bound_ms"] * v["launches"]
                             for v in layers.values()),
    }


def layer_text(layers):
    return "; ".join(
        f"Lh={k}: {v['launches']} launches, {v['device_ms']:.4f} ms on the "
        f"card ({v['device_how']}), bound {v['bound_ms']:.4f} ms, path "
        f"{v['path_ms']:.3f} ms (events)" for k, v in layers.items())


def profile_train(data, hp=TRAIN_HP, learner_cls=None, loop="boost_s"):
    """One training (train_bench's configuration unless `hp` says
    otherwise; a GradientBoostedTreesLearner unless `learner_cls` says
    otherwise) under torch.profiler: device time by kernel name, the
    number of device kernels, and the device's idle share of the tree
    loop (its wall in last_timings[loop]), bounded from below by 1 -
    (device time of the whole train) / (loop wall)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import ydf_tpu_torch

    cls = learner_cls or ydf_tpu_torch.GradientBoostedTreesLearner
    learner = cls(device=DEVICE, **hp)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        learner.train(data)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # The device records straight from the profiler's kineto results:
    # key_averages() (and events()) first turn every record into a
    # Python event, which took minutes over the half million kernels of
    # an isolation forest's 50 trees.
    by_name, kernels = {}, 0
    for e in prof.profiler.kineto_results.events():
        if not str(e.device_type()).endswith("CUDA") or getattr(
                e, "is_user_annotation", lambda: False)():
            continue
        dev_ms = e.duration_ns() / 1e6
        if dev_ms > 0:
            by_name[e.name()] = by_name.get(e.name(), 0.0) + dev_ms
            kernels += 1
    busy = sum(by_name.values())
    loop_ms = learner.last_timings[loop] * 1e3
    assert kernels > 0, "the profiler saw no device kernel"
    return {
        "wall_ms": wall * 1e3, "loop_ms": loop_ms, "kernels": kernels,
        "busy_ms": busy, "idle_share": max(0.0, 1 - busy / loop_ms),
        "top": sorted(by_name.items(), key=lambda kv: -kv[1])[:6],
    }


def binning_check(args, sha=None):
    """The binning kernel against its plain version, and its bins
    feature-major in memory: the [n, F] result is the view of a
    contiguous [F, n]. With `sha`, the [n, F] matrix's SHA-256 against
    the JAX package's."""
    import torch

    from ydf_tpu_torch.ops import binning

    got = binning.bin_columns(*args)
    torch.cuda.synchronize()
    assert got.t().is_contiguous(), "binning kernel: bins not feature-major"
    assert torch.equal(got, binning.bin_columns_plain(*args)), (
        "binning kernel != plain")
    if sha is not None:
        assert sha256(got) == sha, "bins != the JAX package's"


def sha256(t):
    import hashlib

    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()


def abs_stats(args, i):
    """The same call with |stats| at argument position i: the cell mass
    that bounds an f32 sum's rounding."""
    args = list(args)
    args[i] = args[i].abs()
    return tuple(args)


def hist_check(got, want, mass, what):
    """Max abs difference of an f32 histogram from its plain version,
    after asserting every cell is within HIST_RTOL x mass + HIST_ATOL."""
    import torch

    torch.cuda.synchronize()
    diff = (got - want).abs()
    assert torch.all(diff <= HIST_RTOL * mass + HIST_ATOL), (
        f"{what}: kernel != plain beyond tolerance ({float(diff.max())})")
    return float(diff.max())


def train_inputs(data, binner, extra_bins=None):
    """The training kernels' inputs at the path's shapes, on the card:
    binning of every training value; the root histogram (one slot, the
    first tree's binomial stats); the deepest fused layer (the previous
    layer's 16 splits into 32 slots, each split's smaller child on one
    of Lh = 16 hist slots), with seeded tables over the real bins.
    `extra_bins` (u8 [P, n], on the card) are candidate columns a tree
    grows on after the binned features (train_vs: the anchors' bins)."""
    import torch

    from ydf_tpu_torch.learners.losses import BinomialLogLikelihood
    from ydf_tpu_torch.ops.binning import bin_columns

    dev = torch.device(DEVICE)
    Fn = binner.num_numerical
    values = np.stack([data[name] for name in binner.feature_names[:Fn]])
    bin_args = (
        torch.from_numpy(values).to(dev),
        torch.from_numpy(binner.boundaries[:Fn]).to(dev),
        torch.from_numpy(binner.feature_num_bins[:Fn] - 1).to(dev),
        torch.from_numpy(binner.impute_values[:Fn]).to(dev),
    )
    bins_t = bin_columns(*bin_args).t()
    if extra_bins is not None:
        bins_t = torch.cat([bins_t, extra_bins]).contiguous()
    F, n = bins_t.shape
    B = binner.num_bins
    # The first tree's stats, [g w, h w, w] at the initial prediction.
    loss = BinomialLogLikelihood()
    y = torch.from_numpy(data["label"].astype(np.float32)).to(dev)
    w = torch.ones(n, device=dev)
    preds = loss.initial_predictions(y, w).expand(n)
    g, h = loss.grad_hess(y, preds)
    stats = torch.stack([g * w, h * w, w], dim=1).contiguous()
    root = (bins_t, torch.zeros(n, dtype=torch.int32, device=dev), stats,
            1, B)
    routed = routed_layer(bins_t, stats, 16, B)
    return {"binning": bin_args, "root": root, "routed": routed}


def routed_layer(bins_t, stats, Lh, B, L=32, seed=6):
    """A fused layer's inputs with Lh hist slots, on the card: the previous
    layer's Lh splits into 2 Lh of L = 32 slots, each split's smaller
    child on a hist slot (the other on the trash slot), seeded tables over
    the real bins, 3% of the rows on the trash slot."""
    import torch

    from ydf_tpu_torch.ops.histogram_kernels import RouteTables

    dev = bins_t.device
    F, n = bins_t.shape
    N = 127
    rng = np.random.default_rng(seed)
    do_split = np.zeros(L + 1, bool)
    do_split[:Lh] = True
    split_rank = np.where(do_split, np.arange(L + 1), 0).astype(np.int32)
    cut = rng.integers(32, 224, L + 1)
    left_id = np.where(do_split, 31 + 2 * np.arange(L + 1), N)
    small_left = rng.uniform(size=Lh) < 0.5
    hmap = np.full(L + 1, Lh, np.int32)
    hmap[2 * np.arange(Lh)] = np.where(small_left, np.arange(Lh), Lh)
    hmap[2 * np.arange(Lh) + 1] = np.where(small_left, Lh, np.arange(Lh))
    tables = RouteTables(*(torch.from_numpy(a).to(dev) for a in (
        do_split, rng.integers(0, F, L + 1).astype(np.int32),
        np.arange(B)[None, :] <= cut[:, None], left_id.astype(np.int32),
        np.where(do_split, left_id + 1, N).astype(np.int32), split_rank,
        hmap, np.zeros(L + 1, bool), np.zeros(1, np.uint8),
    )))
    slot = np.where(rng.uniform(size=n) < 0.03, L,
                    rng.integers(0, Lh, n)).astype(np.int32)
    leaf = rng.integers(15, 31, n).astype(np.int32)
    return (bins_t, torch.from_numpy(slot).to(dev),
            torch.from_numpy(leaf).to(dev), tables, stats, Lh, B)


def routed_by_layer(name, inp, events, launches_by_lh):
    """The routed kernel at each hist-slot count of the path (the Lh of
    its launches): device time and bound from measure_train on
    routed_layer inputs, and the path's CUDA-event time of those
    launches. Returns {Lh: {...}}."""
    out = {}
    bins_t, _, _, _, stats, _, B = inp["routed"]
    for lh in sorted(launches_by_lh):
        layer = dict(inp, routed=routed_layer(bins_t, stats, lh, B))
        t = measure_train(name, layer, timing_only=True)
        out[lh] = {
            "launches": launches_by_lh[lh], "device_ms": t["device_ms"],
            "device_how": t["device_how"], "bound_ms": t["bound_ms"],
            "path_ms": sum(s.elapsed_time(e) for k, s, e in events
                           if k == f"histogram_routed/Lh={lh}"),
        }
    return out


def split_events(events):
    """Event time summed by kernel (the name before any '/'), and the
    routed kernel's launches by hist-slot count."""
    kernel_ms, by_lh = {}, {}
    for name, start, end in events:
        base = name.split("/")[0]
        kernel_ms[base] = kernel_ms.get(base, 0.0) + start.elapsed_time(end)
        if name.startswith("histogram_routed/Lh="):
            lh = int(name.split("=")[1])
            by_lh[lh] = by_lh.get(lh, 0) + 1
    return kernel_ms, by_lh


def measure_train(name, inp, reps=20, timing_only=False):
    """Kernel time (CUDA events, after warm-up), the plain version's time
    (once, after one call), the library call's time (each timed over
    `reps` calls, device times over `reps` profiled calls), and the bound: the
    larger of the bytes the function must move (inputs read once,
    outputs written once) over HBM bandwidth and its least operations
    on these inputs over the card's 32-bit scalar rate. timing_only skips
    the plain version and the library call."""
    import torch

    from ydf_tpu_torch.ops import binning, histogram_kernels, segment_sum

    extra = {}
    if name == "binning":
        args = inp["binning"]
        kernel = lambda: binning.bin_columns(*args)  # noqa: E731
        plain = lambda: binning.bin_columns_plain(*args)  # noqa: E731
        values, bounds, nb, impute = args
        F, n = values.shape
        v = torch.where(torch.isnan(values), impute[:, None], values)
        library = lambda: torch.searchsorted(bounds, v, right=True)  # noqa
        library_kernels = ("searchsorted",)
        nbytes = (values.numel() * 4 + bounds.numel() * 4 + F * 8 + n * F)
        # A binary search over nb boundaries: ceil(log2(nb + 1)) compares.
        steps = np.ceil(np.log2(nb.cpu().numpy().astype(np.float64) + 1))
        ops = int(n * steps.sum())
        shape = f"{n} x {F} values"
    elif name == "histogram":
        bins_t, slot, stats, L, B = args = inp["root"]
        # The mesh's shard sums (inp["wide"]): f64 cells out.
        wide = inp.get("wide", False)
        kernel = lambda: histogram_kernels.histogram(  # noqa: E731
            *args, wide=wide)
        plain = lambda: histogram_kernels.histogram_plain(  # noqa: E731
            *args, wide=wide)
        F, n = bins_t.shape
        S = stats.shape[1]
        idx, src = fused_index(bins_t, slot, stats, B)
        library = lambda: torch.zeros(  # noqa: E731
            (L * F * B, S), device=stats.device,
            dtype=torch.float64 if wide else torch.float32).index_add_(
                0, idx, src.double() if wide else src)
        library_kernels = ("index",)
        live = n
        nbytes = (bins_t.numel() + n * 4 + stats.numel() * 4
                  + L * F * B * S * (8 if wide else 4))
        ops = live * F * S
        shape = f"n={n}, F={F}, B={B}, L={L}, S={S}"
    elif name == "segment_sum":
        key, vals = args = inp["segment"]
        kernel = lambda: segment_sum.segment_sums(*args)  # noqa: E731
        plain = lambda: segment_sum.segment_sums_plain(*args)  # noqa
        head = segment_sum.run_heads(key)
        run_of = torch.cumsum(head.long(), 0) - 1
        heads = torch.nonzero(head)[:, 0][run_of]
        library = lambda: torch.zeros_like(vals).index_add_(  # noqa: E731
            0, heads, vals)
        library_kernels = ("index",)
        E, S = vals.shape
        nbytes = E * 8 + 2 * E * S * 4  # keys and values in, sums out
        ops = E * S  # one add a value
        extra = {"runs": int(head.sum()),
                 "longest_run": int(torch.bincount(run_of).max())}
        shape = (f"E={E}, S={S}, runs {extra['runs']}, longest run "
                 f"{extra['longest_run']}, tile "
                 f"{segment_sum.tile_entries(S)}")
    else:
        args = inp["routed"]
        bins_t, slot, leaf, tables, stats, Lh, B = args
        wide = inp.get("wide", False)
        kernel = lambda: histogram_kernels.histogram_routed(  # noqa: E731
            *args, wide=wide)
        plain = lambda: histogram_kernels.histogram_routed_plain(  # noqa
            *args, wide=wide)
        library = None
        F, n = bins_t.shape
        S = stats.shape[1]
        hist_slot = histogram_kernels.route_plain(bins_t, slot, leaf,
                                                  tables)[2]
        live = int((hist_slot < Lh).sum())
        table_b = sum(t.numel() * t.element_size() for t in tables)
        # bins, slot, leaf, stats, tables in; hist, new slot, new leaf out.
        nbytes = (bins_t.numel() + n * 4 * 2 + stats.numel() * 4 + table_b
                  + Lh * F * B * S * (8 if wide else 4) + n * 4 * 2)
        # One add per (live row, feature, stat); per row a slot read, the
        # split test, the go-left bit and the child and hist-slot selects.
        ops = live * F * S + 6 * n
        shape = f"n={n}, F={F}, B={B}, L={tables.do_split.shape[0] - 1}, " \
            f"Lh={Lh}, S={S}, live rows {live}"
    for _ in range(3):
        kernel()
    torch.cuda.synchronize()
    ms = time_ms(kernel, reps=reps)
    dev_ms, how = device_ms(kernel, KERNELS_OF[name], reps=reps)
    plain_ms = library_ms = library_dev_ms = None
    if not timing_only:
        plain()
        plain_ms = time_ms(plain, reps=1)
    if library is not None and not timing_only:
        library()
        library_ms = time_ms(library, reps=reps)
        library_dev_ms, lib_how = device_ms(library, library_kernels,
                                            reps=reps)
        how = how if lib_how == how else f"{how}; library {lib_how}"
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / SCALAR_OPS_PER_S * 1e3
    return {
        "ms": ms, "device_ms": dev_ms, "device_how": how,
        "plain_ms": plain_ms, "library_ms": library_ms,
        "library_device_ms": library_dev_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "detail": f"{nbytes} bytes -> {bytes_ms:.4f} ms, {ops} ops -> "
                  f"{ops_ms:.4f} ms", "shape": shape, **extra,
    }


def timing_text(t):
    """A `6 timing` / `7 timing` line's numbers: the kernel's call and
    device times, the plain version's, the library call's both, the
    bound."""
    lib = "null" if t["library_ms"] is None else (
        f"{t['library_ms']:.4f} ms a call, "
        f"{t['library_device_ms']:.4f} ms on the card")
    return (f"kernel {t['ms']:.4f} ms a call back to back, "
            f"{t['device_ms']:.4f} ms on the card ({t['device_how']}), "
            f"plain {t['plain_ms']:.3f} ms, library {lib}, bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}; {t['detail']})")


def fused_index(bins_t, slot, stats, B):
    """The library call's operands: the fused (slot, feature, bin) index
    of every (row, feature) and its stats rows, [F*n] and [F*n, S]."""
    import torch

    F, n = bins_t.shape
    f = torch.arange(F, device=bins_t.device)[:, None]
    idx = ((slot.long()[None, :] * F + f) * B + bins_t.long()).reshape(-1)
    src = stats[None].expand(F, n, stats.shape[1]).reshape(-1,
                                                            stats.shape[1])
    return idx, src.contiguous()


# --------------------------------------------------------------------- #
# 7 vs: the vector-sequence paths, served and trained on the card
# --------------------------------------------------------------------- #


def vs_ragged_cases():
    """(n, L, D, A, all rows empty): n not a multiple of a block's rows,
    L = 1, A = 1, a D that pads nothing evenly, all-empty rows."""
    return [(1, 1, 1, 1, False), (1001, 16, 16, 32, False),
            (777, 1, 16, 32, False), (513, 9, 5, 1, False),
            (300, 7, 3, 33, False), (257, 4, 16, 16, True),
            (129, 6, 40, 70, False)]


def vs_random_case(n, L, D, A, all_empty, seed):
    import torch

    rng = np.random.RandomState(seed)
    lengths = np.zeros(n, np.int32) if all_empty else rng.randint(
        0, L + 1, n).astype(np.int32)
    values = np.zeros((n, L, D), np.float32)
    for e in range(n):
        values[e, :lengths[e]] = rng.normal(size=(lengths[e], D))
    anchors = rng.normal(size=(A, D)).astype(np.float32)
    closer = rng.uniform(size=A) < 0.5
    dev = torch.device(DEVICE)
    return tuple(torch.from_numpy(a).to(dev)
                 for a in (values, lengths, anchors, closer))


def vs_check(args, what):
    """Kernel against plain on `args`: bitwise (the kernel rounds as the
    plain version does at every shape), empty rows' -FLT_MAX too. Returns
    the max abs error (0)."""
    import torch

    from ydf_tpu_torch.ops import vector_sequence as vso

    got = vso.vs_scores(*args)
    torch.cuda.synchronize()
    want = vso.vs_scores_plain(*args)
    empty = args[1] == 0
    assert torch.equal(got[empty].view(torch.int32),
                       want[empty].view(torch.int32)), (
        f"{what}: empty rows != -FLT_MAX")
    diff = (got.double() - want.double()).abs()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32)), (
        f"{what}: kernel != plain ({float(diff.max())})")
    return float(diff.max()) if diff.numel() else 0.0


def vs_near_threshold(model, data):
    """bool [n]: rows whose VS score at some VS node on their path (any
    tree) lies within VS_RTOL x M + VS_ATOL of the node's threshold; the
    rows where another summation order may route differently."""
    import torch

    from ydf_tpu_torch.dataset.dataset import Dataset
    from ydf_tpu_torch.ops import vector_sequence as vso
    from ydf_tpu_torch.ops.routing import (
        route_tree_values,
        vs_tree_projections,
    )

    ds = Dataset.from_data(data, model.dataspec)
    x_num, x_cat = model._encode_inputs(ds)
    vals, lens, _ = model.binner.transform_vs(ds)
    dev = model.device
    xn, xc = (torch.from_numpy(a).to(dev) for a in (x_num, x_cat))
    vals = [torch.from_numpy(np.ascontiguousarray(vals[:, j])).to(dev)
            for j in range(vals.shape[1])]
    lens = [torch.from_numpy(np.ascontiguousarray(lens[:, j])).to(dev)
            for j in range(lens.shape[1])]
    fo = model.forest
    F_total = x_num.shape[1] + x_cat.shape[1]
    near = torch.zeros(x_num.shape[0], dtype=torch.bool, device=dev)
    for t in range(fo.num_trees):
        proj = vs_tree_projections(fo, t, vals, lens)
        fsel = fo.vs_feat[t].long()
        M = torch.stack([vso.score_tolerance(v, ln, fo.vs_anchor[t])
                         for v, ln in zip(vals, lens)], dim=1)
        M = torch.gather(M, 1, fsel[None, None, :].expand(M.shape[0], 1, -1)
                         )[:, 0, :]
        for depth in range(model.max_depth):
            node = route_tree_values(fo, t, xn, xc, model.binner.num_numerical,
                                     depth, vs_proj=proj)
            f = fo.feature[t].long()[node]
            q = (f - F_total).clamp(0, proj.shape[1] - 1)[:, None]
            at_vs = (f >= F_total) & ~fo.is_leaf[t][node]
            gap = (proj.gather(1, q)[:, 0] - fo.threshold[t][node]).abs()
            near |= at_vs & (gap <= VS_RTOL * M.gather(1, q)[:, 0] + VS_ATOL)
    return near.cpu().numpy()


def ulps_apart(a, b):
    """Distance in units in the last place between float32 arrays."""
    def key(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(key(a) - key(b))


def vs_path(smi, serving):
    """Phase 7: returns the `kernels` entries of the vector-sequence
    kernel on serve_vs and train_vs and of the three training kernels on
    train_vs."""
    import torch

    import ydf_tpu_torch
    from ydf_tpu_torch.dataset.dataset import Dataset
    from ydf_tpu_torch.learners import gbt as port_gbt
    from ydf_tpu_torch.ops import binning, histogram_kernels
    from ydf_tpu_torch.ops import vector_sequence as vso
    from ydf_tpu_torch.utils import cuda_build

    t_phase = time.perf_counter()
    with open(os.path.join(TRAIN_VS, "config.json")) as f:
        cfg = json.load(f)
    assert (cfg["rows"], cfg["learner"], cfg["data_seed"],
            cfg["request_rows"], cfg["request_seed"], cfg["generator"]) == (
        VS_ROWS, TRAIN_HP, DATA_SEED, TRAIN_REQUEST_ROWS, REQUEST_SEED,
        dict(max_len=VS_MAX_LEN, dim=VS_DIM, noise=VS_NOISE,
             radius=VS_RADIUS)), cfg
    exp = np.load(os.path.join(TRAIN_VS, "expected.npz"))
    jax_forest = dict(np.load(os.path.join(TRAIN_VS, "forest.npz")))
    t0 = time.perf_counter()
    data = make_vs_data(VS_ROWS)
    req = make_vs_data(TRAIN_REQUEST_ROWS, seed=REQUEST_SEED)
    del req["label"]
    log("7 vs", f"data {VS_ROWS} rows (numpy RandomState({DATA_SEED})) in "
        f"{time.perf_counter() - t0:.2f} s; JAX fixture: jax "
        f"{cfg['jax_version']}, threefry partitionable "
        f"{cfg['jax_threefry_partitionable']}, impls {cfg['jax_impls']}")

    # -- 7a the kernel against plain: training shape, ragged shapes ---- #
    learner = ydf_tpu_torch.GradientBoostedTreesLearner(device=DEVICE,
                                                        **TRAIN_HP)
    prep = learner._prepare(data)
    vs = port_gbt.vs_inputs(prep["vs"], *learner._vs_anchor_counts(),
                            DEVICE)
    dev = vs.values[0].device
    full = (vs.values[0], vs.lengths[0],
            torch.from_numpy(jax_forest["vs_anchor"][0]).to(dev),
            torch.from_numpy(jax_forest["vs_is_closer"][0]).to(dev))
    err = {"vs/train_vs": vs_check(full, "training shape")}
    assert err["vs/train_vs"] == 0.0, (
        f"training shape: kernel != plain ({err['vs/train_vs']})")
    ragged = max(vs_check(vs_random_case(*case, seed=i), f"ragged {case}")
                 for i, case in enumerate(vs_ragged_cases()))
    n, L, D = full[0].shape
    log("7 kernels", f"vector_sequence at the training shape (n={n}, L={L}, "
        f"D={D}, A={full[2].shape[0]}; max abs {err['vs/train_vs']:.3g}) "
        f"and {len(vs_ragged_cases())} ragged shapes {vs_ragged_cases()} "
        f"(max abs {ragged:.3g}; D = 1, 3, 5, 40 take the generic "
        f"instantiation): bitwise to plain, -FLT_MAX rows too")

    out = []
    # -- 7b serve_vs: the JAX model served on the card ---------------- #
    vso.KERNEL_LAUNCHES = 0
    for c in serving:
        c.KERNEL_LAUNCHES = 0
    cuda_build.LAUNCH_EVENTS = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = ydf_tpu_torch.load_model(TRAIN_VS, device=DEVICE)
    pred = model.predict(req)
    torch.cuda.synchronize()
    serve_wall = time.perf_counter() - t0
    events, cuda_build.LAUNCH_EVENTS = cuda_build.LAUNCH_EVENTS, None
    path_ms = {"serve_vs": split_events(events)[0].get("vector_sequence",
                                                        0.0)}
    served = vso.KERNEL_LAUNCHES
    T = TRAIN_HP["num_trees"]
    assert served == T, served  # one launch per tree and VS feature
    assert not any(c.KERNEL_LAUNCHES for c in serving)
    # The kernel's inputs on this path, as vs_tree_projections passes them
    # for tree 0: the padded request sequences against the tree's anchors.
    sv, sl, _ = model.binner.transform_vs(Dataset.from_data(req,
                                                            model.dataspec))
    serve_args = (torch.from_numpy(np.ascontiguousarray(sv[:, 0])).to(dev),
                  torch.from_numpy(np.ascontiguousarray(sl[:, 0])).to(dev),
                  model.forest.vs_anchor[0].contiguous(),
                  model.forest.vs_is_closer[0].contiguous())
    err["vs/serve_vs"] = vs_check(serve_args, "serve_vs shape")
    raw = model._raw_scores(req, combine="sum")[:, 0]
    assert model.list_compatible_engines() == ["Routed"]
    off = np.abs(raw - exp["raw"]) > VS_SERVE_ATOL
    near = vs_near_threshold(model, req)
    explained = int(off.sum())
    assert not (off & ~near).any(), (
        f"serve_vs: {int((off & ~near).sum())} rows differ from JAX with no "
        "VS score near a threshold")
    assert explained <= VS_MAX_EXPLAINED * len(raw), explained
    assert np.isfinite(pred).all() and pred.shape == (len(raw),)
    emptied = dict(req)
    emptied["seq"] = req["seq"].copy()
    missing = [i for i, v in enumerate(req["seq"]) if v is None]
    for i in missing:
        emptied["seq"][i] = np.zeros((0, VS_DIM), np.float32)
    assert np.array_equal(model.predict(emptied), pred), (
        "missing != empty")
    t0 = time.perf_counter()
    model.predict(req)
    torch.cuda.synchronize()
    predict_ms = (time.perf_counter() - t0) * 1e3
    log("7 serve", f"serve_vs: load_model + predict of "
        f"{len(raw)} rows in {serve_wall * 1e3:.1f} ms, {served} launches "
        f"of vector_sequence (engines {model.list_compatible_engines()}); "
        f"raw vs JAX max abs {np.abs(raw - exp['raw']).max():.3g}, rows "
        f"beyond {VS_SERVE_ATOL}: {explained} (all explained by a VS score "
        f"within {VS_RTOL} x M of a threshold on the path; "
        f"{int(near.sum())} rows have one); predictions vs JAX max abs "
        f"{np.abs(pred - exp['predictions']).max():.3g}; {len(missing)} "
        f"missing cells predict like empty ones; one more predict "
        f"{predict_ms:.1f} ms (host clock)")

    # -- 7c train_vs: the GBT trained on the card --------------------- #
    for k in histogram_kernels.LAUNCHES:
        histogram_kernels.LAUNCHES[k] = 0
    binning.KERNEL_LAUNCHES = 0
    vso.KERNEL_LAUNCHES = 0
    for c in serving:
        c.KERNEL_LAUNCHES = 0
    cuda_build.LAUNCH_EVENTS = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    learner = ydf_tpu_torch.GradientBoostedTreesLearner(device=DEVICE,
                                                        **TRAIN_HP)
    model = learner.train(data)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    events, cuda_build.LAUNCH_EVENTS = cuda_build.LAUNCH_EVENTS, None
    counted = dict(histogram_kernels.LAUNCHES)
    counted["binning"] = binning.KERNEL_LAUNCHES
    counted["vector_sequence"] = vso.KERNEL_LAUNCHES
    depth = TRAIN_HP["max_depth"]
    assert counted["vector_sequence"] == T, counted
    assert counted["histogram"] == T, counted
    assert counted["histogram_routed"] == T * (depth - 1), counted
    assert counted["binning"] >= 1, counted
    assert not any(c.KERNEL_LAUNCHES for c in serving)
    kernel_ms = {k: 0.0 for k in counted}
    ev_ms, routed_lh = split_events(events)
    kernel_ms.update(ev_ms)
    path_ms["train_vs"] = kernel_ms["vector_sequence"]
    boost_ms = learner.last_timings["boost_s"] * 1e3
    log("7 launches", f"train_vs: {counted} (routed by hist slots: "
        f"{routed_lh})")
    log("7 train", f"train_vs GradientBoostedTreesLearner(**{TRAIN_HP})"
        f".train: wall {wall * 1e3:.1f} ms (host clock, ends in "
        "synchronize); stages " + " ".join(
            f"{k}={v * 1e3:.1f}ms" for k, v in learner.last_timings.items())
        + "; kernel time (CUDA events) " + " ".join(
            f"{k}={v:.3f}ms" for k, v in kernel_ms.items())
        + f", sum {sum(kernel_ms.values()):.3f} ms = "
        f"{100 * sum(kernel_ms.values()) / (wall * 1e3):.2f}% of the wall, "
        f"boosting loop {boost_ms:.1f} ms; {smi}")

    # -- 7d against the JAX package's run ----------------------------- #
    pf = model.forest.to_numpy()
    assert np.array_equal(pf["vs_anchor"].view(np.int32),
                          jax_forest["vs_anchor"].view(np.int32)), (
        "anchors != the JAX package's")
    for field in ("vs_feat", "vs_is_closer"):
        assert np.array_equal(pf[field], jax_forest[field]), field
    split = ~jax_forest["is_leaf"] | ~pf["is_leaf"]
    differ = split & ((pf["feature"] != jax_forest["feature"])
                      | (pf["threshold_bin"] != jax_forest["threshold_bin"])
                      | (pf["is_leaf"] != jax_forest["is_leaf"]))
    Fn = model.binner.num_numerical
    tree0 = []
    for k in np.nonzero(differ[0])[0]:
        jf = int(jax_forest["feature"][0, k])
        assert jf >= Fn, f"tree 0 node {k}: numerical split differs"
        a = torch.from_numpy(jax_forest["vs_anchor"][0, jf - Fn:jf - Fn + 1]
                             ).to(dev)
        ic = torch.from_numpy(
            jax_forest["vs_is_closer"][0, jf - Fn:jf - Fn + 1]).to(dev)
        sc = vso.vs_scores(vs.values[0], vs.lengths[0], a, ic)[:, 0]
        M = vso.score_tolerance(vs.values[0], vs.lengths[0], a)[:, 0]
        rows = int(((sc - float(jax_forest["threshold"][0, k])).abs()
                    <= VS_RTOL * M + VS_ATOL).sum())
        assert rows > 0, f"tree 0 node {k} differs, unexplained"
        tree0.append(f"node {k}: {rows} rows within {VS_RTOL} x M")
    same = ~differ & split & (pf["feature"] >= Fn) & ~pf["is_leaf"]
    ulps = ulps_apart(pf["threshold"][same], jax_forest["threshold"][same])
    assert (ulps <= VS_THRESHOLD_ULPS).all(), int(ulps.max())
    per_tree = differ.sum(axis=1)
    loss = np.asarray(model.training_logs["train_loss"], np.float32)
    loss_rel = np.abs(loss / exp["train_loss"] - 1)
    assert loss.shape == exp["train_loss"].shape
    assert loss_rel[-1] <= TRAIN_LOSS_RTOL, (loss[-1], exp["train_loss"][-1])
    traw = model._raw_scores(req, combine="sum")[:, 0] \
        + model.initial_predictions[0]
    raw_err = np.abs(traw - (exp["raw"] + exp["initial_predictions"][0]))
    assert np.isfinite(traw).all()
    assert raw_err.max() <= RAW_SCORE_ATOL, raw_err.max()
    assert raw_err.mean() <= RAW_SCORE_MEAN_ATOL, raw_err.mean()
    log("7 vs JAX", f"train_vs: anchors of all {T} trees bitwise == JAX; "
        f"tree 0 differing split nodes: {len(tree0)} {tree0}; split nodes "
        f"differing over {T} trees: {int(per_tree.sum())} (per tree "
        f"{per_tree.tolist()}); VS thresholds of equal nodes within "
        f"{int(ulps.max()) if ulps.size else 0} ulps ({int(same.sum())} "
        f"nodes); final train loss {loss[-1]:.7f} vs "
        f"{exp['train_loss'][-1]:.7f} (rel {loss_rel[-1]:.2e}); raw scores "
        f"on {TRAIN_REQUEST_ROWS} fresh rows: max abs {raw_err.max():.3g}, "
        f"mean {raw_err.mean():.3g}")

    # -- 7e the kernels timed at the path's shapes -------------------- #
    draws = port_gbt.vs_draws(learner.random_seed, 1, len(vs.values),
                              vs.num_closer + 2 * vs.num_projected, dev)
    B = model.binner.num_bins
    qs = port_gbt.prng.linspace_f32(1.0 / B, 1.0 - 1.0 / B, B - 1,
                                    device=dev)
    _, _, cols = port_gbt.make_vs_projections(
        vs, {k: v[0] for k, v in draws.items()}, qs)
    inp = train_inputs(data, model.binner, extra_bins=cols)
    got = histogram_kernels.histogram(*inp["root"])
    err["histogram"] = hist_check(
        got, histogram_kernels.histogram_plain(*inp["root"]),
        histogram_kernels.histogram_plain(*abs_stats(inp["root"], 2)),
        "train_vs root histogram")
    got = histogram_kernels.histogram_routed(*inp["routed"])
    want = histogram_kernels.histogram_routed_plain(*inp["routed"])
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    err["histogram_routed"] = hist_check(
        got[0], want[0], histogram_kernels.histogram_routed_plain(
            *abs_stats(inp["routed"], 4))[0], "train_vs routed histogram")
    binning_check(inp["binning"])
    err["binning"] = 0.0
    for path, args, launches in (
        ("serve_vs", serve_args, served),
        ("train_vs", full, counted["vector_sequence"]),
    ):
        t = measure_vs(args)
        log("7 timing", f"vector_sequence on {path} ({t['shape']}): kernel "
            f"{t['ms']:.4f} ms a call back to back ({t['launch_ms']:.4f} ms "
            f"between events around the launch alone, {t['device_ms']:.4f} "
            f"ms on the card ({t['device_how']})), plain "
            f"{t['plain_ms']:.3f} ms, library null "
            f"(no single PyTorch call scores a masked max/min over a "
            f"sequence), bound {t['bound_ms']:.4f} ms ({t['bound_by']}; "
            f"{t['detail']}), {smi}")
        out.append({
            "name": f"vector_sequence/{path}", "route": "cuda",
            "source": "ydf_tpu_torch/csrc/vector_sequence.cu",
            "replaces": "ydf_tpu/ops/vector_sequence.py:59",
            "launches": launches, "max_abs_err": err[f"vs/{path}"],
            "ms": t["ms"], "device_ms": t["device_ms"],
            "device_how": t["device_how"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None, "library_device_ms": None,
            "path_ms": path_ms[path],
            "path_how": "CUDA events around each launch",
        })
    for name, src, replaces in (
        ("binning", "binning.cu", "ydf_tpu/ops/binning_pallas.py:60"),
        ("histogram", "histogram.cu", "ydf_tpu/ops/histogram_pallas.py:81"),
        ("histogram_routed", "histogram_routed.cu",
         "ydf_tpu/ops/histogram_pallas.py:172"),
    ):
        t = measure_train(name, inp)
        log("7 timing", f"{name} on train_vs ({t['shape']}): "
            f"{timing_text(t)}, {smi}")
        out.append(train_entry(name, "train_vs", src, replaces, t,
                               counted[name], err[name], kernel_ms[name]))
        if name == "histogram_routed":
            layers = routed_by_layer(name, inp, events, routed_lh)
            out[-1].update(layer_fields(layers))
            log("7 layers", f"{name} on train_vs by hist slots: "
                f"{layer_text(layers)}, {smi}")
    log("7 vs", f"phase 7 wall {time.perf_counter() - t_phase:.1f} s")
    return out


# --------------------------------------------------------------------- #
# 8 default: the library's default GBT workflow on the card
# --------------------------------------------------------------------- #


def default_path(smi, serving):
    """Phase 8: GradientBoostedTreesLearner(label="label") with every
    default (the validation split, look-ahead early stopping, categorical
    splits) trained on the card, evaluated, saved and loaded, against the
    JAX package's run (ydf_tpu_torch/testdata/train_default). Returns the
    `kernels` entries of the path's four kernels."""
    import tempfile

    import torch

    import ydf_tpu_torch
    from ydf_tpu_torch.dataset.dataset import Dataset
    from ydf_tpu_torch.learners import gbt as port_gbt
    from ydf_tpu_torch.ops import binning, histogram_kernels
    from ydf_tpu_torch.serving import bank_scorer
    from ydf_tpu_torch.utils import cuda_build

    t_phase = time.perf_counter()
    with open(os.path.join(TRAIN_DEFAULT, "config.json")) as f:
        cfg = json.load(f)
    assert (cfg["rows"], cfg["test_rows"], cfg["cat_seed"],
            cfg["data_seed"], cfg["compare_rows"], cfg["learner"],
            cfg["generator"]) == (
        DEFAULT_ROWS, DEFAULT_TEST_ROWS, DEFAULT_CAT_SEED, DATA_SEED,
        DEFAULT_COMPARE_ROWS, DEFAULT_HP,
        dict(features=TRAIN_FEATURES, cat_vocabs=list(DEFAULT_CAT_VOCABS),
             missing_features=list(DEFAULT_MISSING))), cfg
    exp = np.load(os.path.join(TRAIN_DEFAULT, "expected.npz"))
    jax_forest = dict(np.load(os.path.join(TRAIN_DEFAULT, "forest.npz")))
    t0 = time.perf_counter()
    train, test = make_frame(DEFAULT_ROWS, DEFAULT_TEST_ROWS)
    assert frame_sha256(train) == cfg["train_sha256"], "train frame"
    assert frame_sha256(test) == cfg["test_sha256"], "test frame"
    log("8 default", f"frames {DEFAULT_ROWS} + {DEFAULT_TEST_ROWS} rows in "
        f"{time.perf_counter() - t0:.2f} s, SHA-256 == the fixture's; JAX "
        f"fixture: jax {cfg['jax_version']}, impls {cfg['jax_impls']}")

    # -- 8a the main path: train with every default, evaluate ---------- #
    for k in histogram_kernels.LAUNCHES:
        histogram_kernels.LAUNCHES[k] = 0
    binning.KERNEL_LAUNCHES = 0
    for c in serving:
        c.KERNEL_LAUNCHES = 0
        c.KERNEL_ROWS = 0
    reads0 = port_gbt.HOST_READS
    cuda_build.LAUNCH_EVENTS = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    learner = ydf_tpu_torch.GradientBoostedTreesLearner(device=DEVICE,
                                                        **DEFAULT_HP)
    model = learner.train(train)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    ev = model.evaluate(test)
    torch.cuda.synchronize()
    eval_wall = time.perf_counter() - t0
    events, cuda_build.LAUNCH_EVENTS = cuda_build.LAUNCH_EVENTS, None
    counted = dict(histogram_kernels.LAUNCHES)
    counted["binning"] = binning.KERNEL_LAUNCHES
    counted["bank_scorer"] = bank_scorer.KERNEL_LAUNCHES
    others = {c.__name__: c.KERNEL_LAUNCHES for c in serving
              if c is not bank_scorer}
    reads = port_gbt.HOST_READS - reads0
    logs = model.training_logs
    trained, kept = logs["num_trees_trained"], logs["num_trees"]
    depth = learner.max_depth
    chunks = -(-trained // min(learner.early_stopping_num_trees_look_ahead,
                               port_gbt.MAX_CHUNK_TREES))
    assert counted["histogram"] == trained, counted
    assert counted["histogram_routed"] == trained * (depth - 1), counted
    assert counted["binning"] >= 1 and counted["bank_scorer"] >= 1, counted
    assert not any(others.values()), others
    assert reads == chunks, (reads, chunks)
    kernel_ms, routed_lh = split_events(events)
    boost_ms = learner.last_timings["boost_s"] * 1e3
    valid_ms = kernel_ms.pop("valid_route", 0.0)
    log("8 launches", f"train_default (train + evaluate): {counted} "
        f"launches (routed by hist slots: {routed_lh}); other serving "
        f"kernels {others}")
    log("8 train", f"GradientBoostedTreesLearner(**{DEFAULT_HP}).train: "
        f"wall {wall * 1e3:.1f} ms (host clock, ends in synchronize); "
        "stages " + " ".join(f"{k}={v * 1e3:.1f}ms" for k, v in
                             learner.last_timings.items())
        + f"; {trained} trees trained, {kept} kept; {chunks} chunks, "
        f"{reads} host reads of the validation losses; "
        f"{boost_ms / trained:.2f} ms a tree (loop wall / trees trained); "
        f"validation routing {valid_ms:.1f} ms (CUDA events around each "
        f"tree's route, predictions and loss) = "
        f"{100 * valid_ms / boost_ms:.2f}% of the loop; kernel time (CUDA "
        "events, train + evaluate) " + " ".join(
            f"{k}={v:.3f}ms" for k, v in kernel_ms.items())
        + f"; evaluate of {DEFAULT_TEST_ROWS} rows {eval_wall * 1e3:.1f} "
        f"ms; {smi}")

    # -- 8b against the JAX package's run ------------------------------ #
    bins = model.binner.transform(
        Dataset.from_data(train, dataspec=model.dataspec), model.device)
    assert sha256(bins) == cfg["bins_sha256"], "bins != the JAX package's"
    _, va_idx = port_gbt.split_validation(DEFAULT_ROWS,
                                          learner.validation_ratio,
                                          learner.random_seed)
    import hashlib

    assert hashlib.sha256(va_idx.astype(np.int64).tobytes()).hexdigest() \
        == cfg["valid_idx_sha256"], "validation rows != the JAX package's"
    jv = exp["valid_loss"].astype(np.float64)
    pv = np.array([r["valid_loss"] for r in logs["iterations"]])
    pt = np.array([r["train_loss"] for r in logs["iterations"]])
    two = np.sort(jv)[:2]
    jax_tie = two[1] - two[0] <= 1e-5 * two[0]
    counts_same = (kept, trained) == (cfg["num_trees"],
                                      cfg["num_trees_trained"])
    if not counts_same:
        a = cfg["num_trees"] - 1
        lo, hi = max(a - 5, 0), a + 6
        log("8 vs JAX", f"kept/trained {kept}/{trained} != JAX "
            f"{cfg['num_trees']}/{cfg['num_trees_trained']}; validation "
            f"losses near JAX's argmin, iterations {lo + 1}-{hi}: JAX "
            f"{jv[lo:hi].tolist()}, port {pv[lo:hi].tolist()}")
    assert counts_same or jax_tie, (
        "the kept tree count differs from JAX's where JAX's two smallest "
        "validation losses lie more than rtol 1e-5 apart")
    pf = model.forest.to_numpy()
    for field in ("feature", "threshold_bin", "is_cat", "cat_mask", "left",
                  "right", "is_leaf", "num_nodes"):
        assert np.array_equal(pf[field][0], jax_forest[field][0]), (
            f"tree 0 {field} != the JAX package's")
    T = min(kept, cfg["num_trees"])
    jf = {k: v[:T] for k, v in jax_forest.items()}
    split = ~jf["is_leaf"] | ~pf["is_leaf"][:T]
    differ = split & ((pf["feature"][:T] != jf["feature"])
                      | (pf["threshold_bin"][:T] != jf["threshold_bin"])
                      | (pf["is_leaf"][:T] != jf["is_leaf"])
                      | (pf["cat_mask"][:T] != jf["cat_mask"]).any(-1))
    per_tree = differ.sum(axis=1)
    m = min(len(pv), len(jv))
    rel = {"train": np.abs(pt[:m] / exp["train_loss"][:m] - 1),
           "valid": np.abs(pv[:m] / jv[:m] - 1)}
    for k, r in rel.items():
        assert r.max() <= TRAIN_LOSS_RTOL, (k, r.max())
    CARD_FORESTS["train_default"] = pf
    head = {k: v[:DEFAULT_COMPARE_ROWS] for k, v in test.items()}
    raw = model._raw_scores(head, combine="sum")[:, 0] \
        + model.initial_predictions[0]
    raw_exp = exp["raw"] + exp["initial_predictions"][0]
    assert raw.shape == raw_exp.shape and np.isfinite(raw).all()
    raw_err = np.abs(raw - raw_exp)
    assert raw_err.max() <= RAW_SCORE_ATOL, raw_err.max()
    assert raw_err.mean() <= RAW_SCORE_MEAN_ATOL, raw_err.mean()
    jev = cfg["jax_evaluate"]
    ev_err = {k: abs(ev.metrics[k] - jev[k]) for k in jev}
    assert ev_err["accuracy"] <= EVAL_ATOL and ev_err["auc"] <= EVAL_ATOL, \
        ev_err
    assert ev_err["loss"] <= TRAIN_LOSS_RTOL * jev["loss"], ev_err
    cat_nodes = int((pf["is_cat"] & ~pf["is_leaf"]).sum())
    log("8 vs JAX", f"bins and validation rows bitwise == JAX; kept "
        f"{kept} of {trained} trained (JAX {cfg['num_trees']} of "
        f"{cfg['num_trees_trained']}; JAX's two smallest validation losses "
        f"{two[0]:.9g}, {two[1]:.9g}); tree 0 == JAX, categorical masks "
        f"included; {cat_nodes} of {int((~pf['is_leaf']).sum())} split "
        f"nodes categorical; split nodes differing from JAX over {T} "
        f"trees: {int(per_tree.sum())} (first differing tree "
        f"{int(np.argmax(per_tree > 0)) if per_tree.any() else None}); "
        f"losses over {m} iterations: train max rel "
        f"{rel['train'].max():.2e}, valid max rel {rel['valid'].max():.2e} "
        f"(<= {TRAIN_LOSS_RTOL}); raw scores on {DEFAULT_COMPARE_ROWS} "
        f"test rows: max abs {raw_err.max():.3g} (<= {RAW_SCORE_ATOL}), "
        f"mean {raw_err.mean():.3g} (<= {RAW_SCORE_MEAN_ATOL}); evaluate "
        f"on {DEFAULT_TEST_ROWS} rows: " + " ".join(
            f"{k} {ev.metrics[k]:.6f} (JAX {jev[k]:.6f})" for k in jev))

    # -- 8c the JAX model served and evaluated by the port ------------- #
    jm = ydf_tpu_torch.load_model(TRAIN_DEFAULT, device=DEVICE)
    jraw = jm._raw_scores(head, combine="sum")[:, 0]
    assert np.array_equal(jraw.view(np.int32), exp["raw"].view(np.int32)), (
        "the JAX model's raw scores on the card != JAX's")
    jme = jm.evaluate(test)
    same = max(abs(jme.metrics[k] - jev[k]) for k in jev)
    assert same <= EVAL_SAME_ATOL, (jme.metrics, jev)
    log("8 load", f"the JAX model on the card: raw scores on "
        f"{DEFAULT_COMPARE_ROWS} rows bitwise == JAX; evaluate on "
        f"{DEFAULT_TEST_ROWS} rows within {same:.3g} of JAX's metrics "
        f"(<= {EVAL_SAME_ATOL})")

    # -- 8d save -> load ----------------------------------------------- #
    with tempfile.TemporaryDirectory() as tmp:
        model.save(os.path.join(tmp, "m"))
        back = ydf_tpu_torch.load_model(os.path.join(tmp, "m"),
                                        device=DEVICE)
        got, want = back.predict(test), model.predict(test)
    assert np.array_equal(got.view(np.int32), want.view(np.int32)), (
        "save -> load changed the predictions")
    log("8 save", f"model.save -> load_model: predictions on "
        f"{DEFAULT_TEST_ROWS} rows bitwise equal")

    # -- 8e the routed kernel on the path's categorical tables --------- #
    tr_idx, _ = port_gbt.split_validation(DEFAULT_ROWS,
                                          learner.validation_ratio,
                                          learner.random_seed)
    layers = captured_routed_layers(model, learner, train, tr_idx)
    cat_layers = [a for a in layers if categorical_tables(a[3])]
    assert len(cat_layers) >= 3, f"{len(cat_layers)} categorical layers"
    err_routed = 0.0
    for args in cat_layers:
        got = histogram_kernels.histogram_routed(*args)
        want = histogram_kernels.histogram_routed_plain(*args)
        assert torch.equal(got[1], want[1]) and torch.equal(
            got[2], want[2]), "routed kernel: new_slot / new_leaf != plain"
        err_routed = max(err_routed, hist_check(
            got[0], want[0], histogram_kernels.histogram_routed_plain(
                *abs_stats(args, 4))[0], "routed histogram, categorical"))
    log("8 kernels", f"histogram_routed on {len(cat_layers)} layers of the "
        f"path's first two trees whose tables hold categorical (not prefix) "
        f"go_left rows (Lh = {[a[5] for a in cat_layers]}): new_slot, "
        f"new_leaf torch.equal to plain, the histogram within {HIST_RTOL} x "
        f"cell mass + {HIST_ATOL} (max abs {err_routed:.3g})")

    # -- 8f where the loop's time goes (torch.profiler) ---------------- #
    prof = profile_train(train, dict(DEFAULT_HP, num_trees=PROFILE_TREES))
    log("8 profile", f"one more train, num_trees={PROFILE_TREES} (two "
        "chunks), under torch.profiler (the profiler slows the host): wall "
        f"{prof['wall_ms']:.1f} ms, boosting loop {prof['loop_ms']:.1f} ms; "
        f"{prof['kernels']} device kernels, {prof['busy_ms']:.3f} ms of "
        "device time over the whole train, so the device is idle at least "
        f"{100 * prof['idle_share']:.1f}% of the loop; largest: " + "; ".join(
            f"{name[:60]} {ms:.3f} ms" for name, ms in prof["top"]))

    # -- 8g each kernel timed at the path's shapes --------------------- #
    rows = {k: v[tr_idx] for k, v in train.items()}
    Fn = model.binner.num_numerical
    cat_rows = bins.t()[Fn:].index_select(
        1, torch.from_numpy(tr_idx).to(bins.device)).contiguous()
    inp = train_inputs(rows, model.binner, extra_bins=cat_rows)
    inp["routed"] = max(cat_layers, key=lambda a: a[5])
    err = {"binning": 0.0, "histogram_routed": err_routed}
    err["histogram"] = hist_check(
        histogram_kernels.histogram(*inp["root"]),
        histogram_kernels.histogram_plain(*inp["root"]),
        histogram_kernels.histogram_plain(*abs_stats(inp["root"], 2)),
        "root histogram")
    out = []
    for name, src, replaces in (
        ("binning", "binning.cu", "ydf_tpu/ops/binning_pallas.py:60"),
        ("histogram", "histogram.cu", "ydf_tpu/ops/histogram_pallas.py:81"),
        ("histogram_routed", "histogram_routed.cu",
         "ydf_tpu/ops/histogram_pallas.py:172"),
    ):
        t = measure_train(name, inp)
        log("8 timing", f"{name} ({t['shape']}): {timing_text(t)}, {smi}")
        out.append(train_entry(name, "train_default", src, replaces, t,
                               counted[name], err[name],
                               kernel_ms.get(name, 0.0)))
        if name == "histogram_routed":
            by_lh = routed_by_captured(name, layers, events, routed_lh)
            out[-1].update(layer_fields(by_lh))
            log("8 layers", f"{name} on train_default by hist slots (timed "
                f"on the path's own layers of tree 0): "
                f"{layer_text(by_lh)}, {smi}")
    bank = bank_scorer.build_bank_scorer(model)
    xT = encoded_xT(model, test)
    t = measure(bank_scorer, bank.tables, bank.tables, xT)
    log("8 timing", f"bank_scorer/train_default at {xT.shape[1]} rows x "
        f"{xT.shape[0]} features ({kept} trees): kernel {t['ms']:.4f} ms a "
        f"call back to back, {t['device_ms']:.4f} ms on the card "
        f"({t['device_how']}), plain {t['plain_ms']:.2f} ms, bound "
        f"{t['bound_ms']:.4f} ms ({t['bound_by']}; {t['detail']}), {smi}")
    out.append({
        "name": "bank_scorer/train_default", "route": "cuda",
        "source": "ydf_tpu_torch/csrc/bank_scorer.cu",
        "replaces": "ydf_tpu/serving/pallas_scorer.py:118",
        "launches": counted["bank_scorer"], "max_abs_err": t["max_abs_err"],
        "ms": t["ms"], "device_ms": t["device_ms"],
        "device_how": t["device_how"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": None, "library_device_ms": None,
        "path_ms": kernel_ms.get("bank_scorer", 0.0),
        "path_how": "CUDA events around each launch",
    })
    log("8 default", f"phase 8 wall {time.perf_counter() - t_phase:.1f} s")
    return out


def rf_path(smi, serving):
    """Phase 9: RandomForestLearner(label="label") with every default
    (Poisson bootstrap, per-node candidate features, depth 16, frontier
    1024, out-of-bag evaluation) but RF_TREES trees trained on the card,
    evaluated, saved
    and loaded, against the JAX package's run (ydf_tpu_torch/testdata/
    train_rf). Returns the `kernels` entries of the path's three
    kernels."""
    import tempfile

    import torch

    import ydf_tpu_torch
    from ydf_tpu_torch.dataset.dataset import Dataset
    from ydf_tpu_torch.learners import random_forest as port_rf
    from ydf_tpu_torch.ops import binning, grower, histogram_kernels
    from ydf_tpu_torch.utils import cuda_build

    t_phase = time.perf_counter()
    with open(os.path.join(TRAIN_RF, "config.json")) as f:
        cfg = json.load(f)
    assert (cfg["rows"], cfg["test_rows"], cfg["cat_seed"],
            cfg["compare_rows"], cfg["learner"], cfg["generator"]) == (
        RF_ROWS, RF_TEST_ROWS, DEFAULT_CAT_SEED, RF_COMPARE_ROWS, RF_HP,
        dict(features=TRAIN_FEATURES, cat_vocabs=list(DEFAULT_CAT_VOCABS),
             missing_features=list(DEFAULT_MISSING))), cfg
    exp = np.load(os.path.join(TRAIN_RF, "expected.npz"))
    small_dir = os.path.join(TRAIN_RF, "rf_small")
    jax_small = dict(np.load(os.path.join(small_dir, "forest.npz")))
    t0 = time.perf_counter()
    train, test = make_frame(RF_ROWS, RF_TEST_ROWS)
    assert frame_sha256(train) == cfg["train_sha256"], "train frame"
    assert frame_sha256(test) == cfg["test_sha256"], "test frame"
    log("9 rf", f"frames {RF_ROWS} + {RF_TEST_ROWS} rows in "
        f"{time.perf_counter() - t0:.2f} s, SHA-256 == the fixture's; JAX "
        f"fixture: jax {cfg['jax_version']}, impls {cfg['jax_impls']}, "
        f"{cfg['num_trees']} trees in {cfg['jax_train_s_cpu']:.1f} s on "
        "the CPU that wrote it")

    # -- 9a the main path: train with every default, evaluate ---------- #
    for k in histogram_kernels.LAUNCHES:
        histogram_kernels.LAUNCHES[k] = 0
    binning.KERNEL_LAUNCHES = 0
    for c in serving:
        c.KERNEL_LAUNCHES = 0
        c.KERNEL_ROWS = 0
    reads0 = port_rf.HOST_READS
    cuda_build.LAUNCH_EVENTS = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hp = dict(RF_HP) if RF_TREES is None else dict(RF_HP, num_trees=RF_TREES)
    learner = ydf_tpu_torch.RandomForestLearner(device=DEVICE, **hp)
    model = learner.train(train)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    ev = model.evaluate(test)
    torch.cuda.synchronize()
    eval_wall = time.perf_counter() - t0
    events, cuda_build.LAUNCH_EVENTS = cuda_build.LAUNCH_EVENTS, None
    counted = dict(histogram_kernels.LAUNCHES)
    counted["binning"] = binning.KERNEL_LAUNCHES
    others = {c.__name__: c.KERNEL_LAUNCHES for c in serving}
    reads = port_rf.HOST_READS - reads0
    T = model.forest.num_trees
    depth = learner.max_depth
    full = T == cfg["num_trees"]
    # The JAX run whose metrics the forest is held to: the full one or
    # the fixture's cut of its first trees.
    held = full or T == cfg["cut"]["num_trees"]
    ref = (dict(cfg["cut"], proba=exp["cut/proba"]) if held and not full
           else dict(cfg, proba=exp["proba"]))
    assert T == learner.num_trees and (full or RF_TREES is not None), T
    assert counted["histogram"] == T, counted
    assert counted["histogram_routed"] == T * (depth - 1), counted
    assert counted["binning"] >= 1, counted
    assert not any(others.values()), others
    assert reads == 2, reads
    kernel_ms, routed_lh = split_events(events)
    stages = learner.last_timings
    loop_ms = stages["loop_s"] * 1e3
    log("9 launches", f"train_rf (train + evaluate): {counted} launches "
        f"({(counted['histogram'] + counted['histogram_routed']) / T:.0f} "
        f"training-kernel launches a tree; routed by hist slots: "
        f"{routed_lh}); serving kernels {others} (an RF serves routed)")
    log("9 train", f"RandomForestLearner(**{RF_HP}).train: wall "
        f"{wall * 1e3:.1f} ms (host clock, ends in synchronize); stages "
        + " ".join(f"{k}={v * 1e3:.1f}ms" for k, v in stages.items())
        + f"; {T} trees, depth {depth}, frontier "
        f"{cfg['frontier']}; {reads} host reads, both before the tree "
        f"loop; {loop_ms / T:.2f} ms a tree (loop wall / trees); kernel "
        "time (CUDA events, train + evaluate) " + " ".join(
            f"{k}={v:.3f}ms" for k, v in kernel_ms.items())
        + f"; evaluate of {RF_TEST_ROWS} rows {eval_wall * 1e3:.1f} ms; "
        f"{smi}")

    # -- 9b against the JAX package's run ------------------------------ #
    bins = model.binner.transform(
        Dataset.from_data(train, dataspec=model.dataspec), model.device)
    assert sha256(bins) == cfg["bins_sha256"], "bins != the JAX package's"
    keys = port_rf.tree_keys(cfg["seed"], T, model.device)
    counts = port_rf.bootstrap_counts(keys[:, 0], RF_ROWS).cpu().numpy()
    boot_same = [array_sha256(c.astype(np.int32)) == exp["boot_sha256"][t]
                 .tobytes().hex() for t, c in enumerate(counts)]
    assert all(boot_same), f"bootstrap counts differ in trees " \
        f"{[t for t, ok in enumerate(boot_same) if not ok][:10]}"
    k_feat = grower.layer_feature_keys(keys[:1, 1], depth)
    kept = []
    for d, kf in enumerate(k_feat):
        mask = grower.candidate_masks(kf, min(2 ** d, cfg["frontier"]),
                                      cfg["num_features"],
                                      cfg["candidate_features"])[0]
        m = mask.cpu().numpy()
        assert array_sha256(m) == exp["mask_sha256"][d].tobytes().hex(), d
        kept.append(int(m.sum()))
    assert kept == exp["mask_kept"].tolist()
    pf = model.forest.to_numpy()
    CARD_FORESTS["train_rf"] = pf
    same = [tree_sha256(pf, t) == exp["tree_sha256"][t].tobytes().hex()
            for t in range(T)]
    differ = [t for t, ok in enumerate(same) if not ok]
    for t in range(min(T, cfg["small_trees"])):
        for field in TREE_HASH_FIELDS + ("num_nodes", "threshold"):
            assert np.array_equal(pf[field][t], jax_small[field][t]), (
                f"tree {t} {field} != the JAX package's")
    assert np.array_equal(pf["num_nodes"], exp["num_nodes"][:T]) or differ, (
        "node counts differ with every tree hash equal")
    diagnosis = "none"
    if differ:
        diagnosis = rf_tree_diagnosis(model, learner, train, pf, exp,
                                      differ[0], cfg)
    assert len(differ) <= (1 - RF_SAME_TREES) * T, (
        f"{len(differ)} of {T} trees differ from JAX's: {diagnosis}")
    jo, po = ref["oob_evaluation"], model.self_evaluation()
    oob_err = {k: abs(po["metrics"][k] - jo["metrics"][k])
               for k in jo["metrics"]}
    head = {k: v[:RF_COMPARE_ROWS] for k, v in test.items()}
    proba = model.predict(head)
    assert proba.shape == ref["proba"].shape and np.isfinite(proba).all()
    p_err = np.abs(proba - ref["proba"])
    jev = ref["jax_evaluate"]
    ev_err = {k: abs(ev.metrics[k] - jev[k]) for k in jev}
    if held:
        assert po["num_examples"] == jo["num_examples"], (po, jo)
        assert oob_err["accuracy"] <= EVAL_ATOL and \
            oob_err["auc"] <= EVAL_ATOL, oob_err
        assert p_err.max() <= RF_PROBA_ATOL and p_err.mean() <= \
            RF_PROBA_MEAN_ATOL, (p_err.max(), p_err.mean())
        assert ev_err["accuracy"] <= EVAL_ATOL and \
            ev_err["auc"] <= EVAL_ATOL, ev_err
    cat_nodes = int((pf["is_cat"] & ~pf["is_leaf"]).sum())
    log("9 vs JAX", ("" if held else f"REHEARSAL of {T} trees, metrics "
        "not held; ") + ("" if full else f"the first {T} of JAX's "
                         f"{cfg['num_trees']} trees, held to JAX's forest "
                         "of those trees; ")
        + f"bins bitwise == JAX; bootstrap counts of all {T} "
        f"trees == JAX's (SHA-256, {int(counts.max()) + 1} Knuth steps "
        f"needed); tree 0's candidate masks == JAX's at all {depth} "
        f"layers ({cfg['candidate_features']} of {cfg['num_features']} "
        f"features, kept per layer {kept}); trees equal to JAX's by "
        f"SHA-256: {T - len(differ)} of {T} (first differing: {diagnosis});"
        f" trees 0-{cfg['small_trees'] - 1} == the JAX package's node for "
        f"node; {cat_nodes} of {int((~pf['is_leaf']).sum())} split nodes "
        f"categorical, {int(pf['num_nodes'].sum())} nodes; out-of-bag on "
        f"{po['num_examples']} rows: " + " ".join(
            f"{k} {po['metrics'][k]:.6f} (JAX {jo['metrics'][k]:.6f})"
            for k in jo["metrics"])
        + f"; P(class 1) on {RF_COMPARE_ROWS} test rows: max abs "
        f"{p_err.max():.3g} (<= {RF_PROBA_ATOL}), mean {p_err.mean():.3g} "
        f"(<= {RF_PROBA_MEAN_ATOL}), bitwise "
        f"{proba.tobytes() == ref['proba'].tobytes()}; evaluate on "
        f"{RF_TEST_ROWS} rows: " + " ".join(
            f"{k} {ev.metrics[k]:.6f} (JAX {jev[k]:.6f})" for k in jev))
    f0 = {k: v[0] for k, v in pf.items() if k in TREE_HASH_FIELDS}
    nodes0 = int(pf["num_nodes"][0])
    log("9 tree 0", f"{nodes0} nodes, {int((~f0['is_leaf'][:nodes0]).sum())}"
        f" splits; node: feature threshold_bin is_cat left right leaf "
        f"value: " + "; ".join(
            f"{i}: {f0['feature'][i]} {f0['threshold_bin'][i]} "
            f"{int(f0['is_cat'][i])} {f0['left'][i]} {f0['right'][i]} "
            f"{int(f0['is_leaf'][i])} "
            f"{np.array2string(f0['leaf_value'][i], precision=4)}"
            for i in range(nodes0)))

    # -- 9c save -> load, and the JAX package's saved forest ----------- #
    with tempfile.TemporaryDirectory() as tmp:
        model.save(os.path.join(tmp, "m"))
        back = ydf_tpu_torch.load_model(os.path.join(tmp, "m"),
                                        device=DEVICE)
        got, want = back.predict(test), model.predict(test)
        bf = back.forest.to_numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32)), (
        "save -> load changed the predictions")
    assert all(np.array_equal(bf[k], pf[k]) for k in pf), "save -> load"
    assert back.self_evaluation() == model.self_evaluation()
    jm = ydf_tpu_torch.load_model(small_dir, device=DEVICE)
    jp = jm.predict(head)
    assert jp.tobytes() == exp["small_proba"].tobytes(), (
        "the JAX forest's probabilities on the card != JAX's")
    log("9 save", f"model.save -> load_model: node arrays, out-of-bag "
        f"evaluation and predictions on {RF_TEST_ROWS} rows bitwise equal; "
        f"the JAX package's saved {cfg['small_trees']}-tree forest on the "
        f"card: probabilities on {RF_COMPARE_ROWS} rows bitwise == JAX's")

    # -- 9d each training kernel against its plain version ------------- #
    hp = dict(RF_HP, max_depth=learner.max_depth,
              random_seed=learner.random_seed)
    layers = captured_layers(ydf_tpu_torch.RandomForestLearner, hp, train)
    layers3 = captured_layers(ydf_tpu_torch.RandomForestLearner, hp,
                              dict(train, label=three_class_label(train)))
    checked = []
    for case in (layers, layers3):
        for args in case["routed"]:
            got = histogram_kernels.histogram_routed(*args)
            want = histogram_kernels.histogram_routed_plain(*args)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                assert torch.equal(g, w), (
                    f"routed kernel != plain at Lh {args[5]}, "
                    f"Sq {args[4].shape[1]}")
            checked.append((args[5], args[4].shape[1]))
        got = histogram_kernels.histogram(*case["root"][0])
        want = histogram_kernels.histogram_plain(*case["root"][0])
        torch.cuda.synchronize()
        assert torch.equal(got, want), "root histogram != plain"
    inp = train_inputs(train, model.binner)
    binning_check(inp["binning"])
    inp["root"] = layers["root"][0]
    lh_list = sorted({lh for lh, _ in checked})
    log("9 kernels", f"histogram_routed on every fused layer of tree 0 of "
        f"the path (binary label, Sq 3) and of a 3-class forest's tree 0 "
        f"on the same rows (Sq 4): new_slot, new_leaf and the class-count "
        f"histogram torch.equal to plain at Lh {lh_list} ({len(checked)} "
        f"layers); the root histogram (Sq 3 and 4) torch.equal; binning "
        f"torch.equal at {RF_ROWS} x {model.binner.num_numerical}; the "
        f"routed kernel's launch at L = {cfg['frontier']}: " + "; ".join(
            f"Lh {lh}: {routed_memory(args)}" for lh, args in {
                a[5]: a for a in layers["routed"]}.items()))

    # -- 9e where the loop's time goes (torch.profiler) ---------------- #
    prof = profile_train(train, dict(RF_HP, num_trees=RF_PROFILE_TREES),
                         ydf_tpu_torch.RandomForestLearner, "loop_s")
    log("9 profile", f"one more train, num_trees={RF_PROFILE_TREES}, under "
        "torch.profiler (the profiler slows the host): wall "
        f"{prof['wall_ms']:.1f} ms, tree loop {prof['loop_ms']:.1f} ms; "
        f"{prof['kernels']} device kernels "
        f"({prof['kernels'] / RF_PROFILE_TREES:.0f} a tree), "
        f"{prof['busy_ms']:.3f} ms of device "
        "time over the whole train, so the device is idle at least "
        f"{100 * prof['idle_share']:.1f}% of the loop; largest: " + "; ".join(
            f"{name[:60]} {ms:.3f} ms" for name, ms in prof["top"]))

    # -- 9f each kernel timed at the path's shapes --------------------- #
    out = []
    for name, src, replaces in (
        ("binning", "binning.cu", "ydf_tpu/ops/binning_pallas.py:60"),
        ("histogram", "histogram.cu", "ydf_tpu/ops/histogram_pallas.py:81"),
        ("histogram_routed", "histogram_routed.cu",
         "ydf_tpu/ops/histogram_pallas.py:172"),
    ):
        if name == "histogram_routed":
            inp["routed"] = max(layers["routed"], key=lambda a: a[5])
        # The root histogram against index_add_ (PERF.md's open question
        # at 50,000 rows): RF_ROOT_REPS repetitions of each.
        t = measure_train(name, inp, reps=RF_ROOT_REPS
                          if name == "histogram" else 20)
        log("9 timing", f"{name} ({t['shape']}): {timing_text(t)}"
            + (f" (each over {RF_ROOT_REPS} calls)" if name == "histogram"
               else "") + f", {smi}")
        # Every comparison above is torch.equal: no difference.
        out.append(train_entry(name, "train_rf", src, replaces, t,
                               counted[name], 0.0, kernel_ms.get(name, 0.0)))
        if name == "histogram_routed":
            by_lh = routed_by_captured(name, layers["routed"], events,
                                       routed_lh)
            out[-1].update(layer_fields(by_lh))
            log("9 layers", f"{name} on train_rf by hist slots: "
                f"{layer_text(by_lh)}, {smi}")
    log("9 rf", f"phase 9 wall {time.perf_counter() - t_phase:.1f} s")
    return out


def three_class_label(train):
    """A 3-class label on the train frame (the binary label split by the
    sign of f0): phase 9's Sq = 4 case."""
    return np.where(train["label"] == 1, 2,
                    (train["f0"] > 0).astype(np.int64))


def routed_memory(args):
    """The routed kernel's launch shape at a captured layer: its shared
    memory a block (against the opt-in limit) and its f64 partials."""
    from ydf_tpu_torch.ops import histogram_kernels as hk

    bins_t, _, _, tables, stats, Lh, B = args
    F, n = bins_t.shape
    L = tables.do_split.shape[0] - 1
    shape = hk.routed_launch_shape(n, F, Lh, B, stats.shape[1], L, 8)
    assert shape.smem <= hk.ROUTED_SMEM_LIMIT, shape
    partial = shape.chunks * Lh * F * B * stats.shape[1] * 8
    return (f"{shape.smem} B a block (<= {hk.ROUTED_SMEM_LIMIT}), "
            f"{shape.slot_blocks} slot blocks x {shape.G} feature groups x "
            f"{shape.chunks} chunks, partials {partial / 2**20:.1f} MiB")


def routed_by_captured(name, layers, events, launches_by_lh):
    """The routed kernel at each hist-slot count of a path, timed on the
    path's own captured layer of that count (its first): device time and
    bound (measure_train), the path's launches and CUDA-event time there.
    Returns {Lh: {...}}."""
    out = {}
    first = {}
    for args in layers:
        first.setdefault(args[5], args)
    for lh in sorted(launches_by_lh):
        t = measure_train(name, {"routed": first[lh]}, timing_only=True)
        out[lh] = {
            "launches": launches_by_lh[lh], "device_ms": t["device_ms"],
            "device_how": t["device_how"], "bound_ms": t["bound_ms"],
            "path_ms": sum(s.elapsed_time(e) for k, s, e in events
                           if k == f"histogram_routed/Lh={lh}"),
        }
    return out


def rf_tree_diagnosis(model, learner, train, pf, exp, t, cfg):
    """Where tree t first differs from the JAX package's (its per-depth
    hashes) and the two best gains of the port's slots at that depth when
    the tree is grown again alone (the closest pair that is not an exact
    tie: a near tie a last ulp can flip)."""
    import torch

    from ydf_tpu_torch.dataset.dataset import Dataset
    from ydf_tpu_torch.learners import random_forest as port_rf
    from ydf_tpu_torch.ops import grower
    from ydf_tpu_torch.ops.split_rules import ClassificationRule

    ours = layer_sha256s(pf, t, learner.max_depth)
    want = [h.tobytes().hex() for h in exp["layer_sha256"][t]]
    d = next(i for i, (a, b) in enumerate(zip(ours, want)) if a != b)
    depths = node_depths(pf, t)
    nodes = np.flatnonzero(depths == d)
    dev = model.device
    binner = model.binner
    bins_t = binner.transform(Dataset.from_data(train, model.dataspec),
                              dev).t().contiguous()
    n = bins_t.shape[1]
    keys = port_rf.tree_keys(cfg["seed"], t + 1, dev)[t:]
    counts = port_rf.bootstrap_counts(keys[:, 0], n)
    y = torch.from_numpy((train["label"].astype(str) == model.classes[1])
                         .astype(np.int64)).to(dev)
    basis = torch.cat([torch.nn.functional.one_hot(y, 2).float(),
                       torch.ones((n, 1), device=dev)], 1)
    rule = ClassificationRule(num_classes=2)
    columns = grower.layer_columns(
        keys[:, 1], max_depth=learner.max_depth, frontier=cfg["frontier"],
        num_features=binner.num_features,
        num_numerical=binner.num_numerical, orderings=1,
        k=cfg["candidate_features"])
    grower.GAIN_TRACE = []
    try:
        grower.grow_tree(
            bins_t, basis * counts[0].float()[:, None], rule=rule,
            max_depth=learner.max_depth, frontier=cfg["frontier"],
            max_nodes=pf["feature"].shape[1], num_bins=binner.num_bins,
            num_numerical=binner.num_numerical,
            min_examples=learner.min_examples,
            columns=[(i[0].long(), ok[0]) for i, ok in columns])
        top2 = grower.GAIN_TRACE[d - 1 if d > 0 else 0].cpu().numpy()
    finally:
        grower.GAIN_TRACE = None
    # Exact ties break by index in both packages; a flip needs two gains
    # an ulp or so apart.
    near = np.isfinite(top2).all(axis=1) & (top2[:, 0] != top2[:, 1])
    with np.errstate(invalid="ignore"):
        gap = np.where(near, np.abs(top2[:, 0] - top2[:, 1])
                       / np.maximum(np.abs(top2[:, 0]), 1e-30), np.inf)
    s = int(np.argmin(gap))
    return (f"tree {t}, depth {d} (nodes {nodes[:1].tolist()}-"
            f"{nodes[-1:].tolist()}); the split layer before it, slot {s}: "
            f"best gain {top2[s, 0]!r}, runner-up {top2[s, 1]!r} (relative "
            f"gap {gap[s]:.3g})")


def categorical_tables(tables):
    """Does a layer's table route some split by a mask that is not a
    prefix of bins (a categorical split)?"""
    import torch

    gl = tables.go_left[tables.do_split]
    prefix = torch.cummin(gl.to(torch.uint8), dim=1).values.bool()
    return bool((gl != prefix).any())


def captured_routed_layers(model, learner, train, tr_idx, num_trees=2):
    """The routed kernel's arguments at every fused layer of the first
    `num_trees` trees the default path grows (its training rows and
    binner, the learner's configuration), cloned as the kernel got them:
    the path's own tables, categorical splits included."""
    import torch

    from ydf_tpu_torch.config import TreeConfig, resolve_max_frontier
    from ydf_tpu_torch.dataset.dataset import Dataset
    from ydf_tpu_torch.learners import gbt as port_gbt
    from ydf_tpu_torch.learners.losses import make_loss
    from ydf_tpu_torch.ops import histogram_kernels
    from ydf_tpu_torch.ops.split_rules import HessianGainRule

    binner = model.binner
    dev = model.device
    idx = torch.from_numpy(tr_idx).to(dev)
    bins_t = binner.transform(Dataset.from_data(train, model.dataspec),
                              dev).t().index_select(1, idx).contiguous()
    n = bins_t.shape[1]
    labels = torch.from_numpy(
        (train["label"][tr_idx].astype(str) == model.classes[1]).astype(
            np.float32)).to(dev)
    cfg = TreeConfig(max_depth=learner.max_depth,
                     max_frontier=resolve_max_frontier(
                         learner.max_frontier, n, learner.min_examples),
                     num_bins=binner.num_bins,
                     min_examples=learner.min_examples)
    captured = []
    original = histogram_kernels.histogram_routed

    def record(*args):
        captured.append(tuple(
            a.clone() if isinstance(a, torch.Tensor) else
            type(a)(*(t.clone() for t in a)) if isinstance(
                a, histogram_kernels.RouteTables) else a for a in args))
        return original(*args)

    histogram_kernels.histogram_routed = record
    try:
        port_gbt.boost(bins_t, labels, torch.ones(n, device=dev),
                       loss_obj=make_loss("DEFAULT", model.task, 2),
                       rule=HessianGainRule(), tree_cfg=cfg,
                       num_trees=num_trees, shrinkage=learner.shrinkage,
                       num_numerical=binner.num_numerical)
    finally:
        histogram_kernels.histogram_routed = original
    return captured


def measure_vs(args, reps=20):
    """The scoring kernel's time (CUDA events, after warm-up: per call of
    the wrapper back to back, and per launch alone) and the
    plain version's (once, after one call) at the path's shape, and the
    bound: the larger of the bytes the function must move (each real
    vector and length read once, the anchors, the scores written once)
    over HBM bandwidth, and its multiply-adds on this run's data (per
    real vector, one per (anchor, d) for the dots and one per d for
    |v|^2; two FLOPs each) over the card's float32 rate."""
    import torch

    from ydf_tpu_torch.ops import vector_sequence as vso
    from ydf_tpu_torch.utils import cuda_build

    values, lengths, anchors, closer = args
    n, L, D = values.shape
    A = anchors.shape[0]
    for _ in range(3):
        vso.vs_scores(*args)
    torch.cuda.synchronize()
    ms = time_ms(lambda: vso.vs_scores(*args), reps=reps)
    # Events around each launch alone: the device time without the
    # wrapper's host work, which sets `ms` at a small shape.
    cuda_build.LAUNCH_EVENTS = []
    for _ in range(reps):
        vso.vs_scores(*args)
    torch.cuda.synchronize()
    events, cuda_build.LAUNCH_EVENTS = cuda_build.LAUNCH_EVENTS, None
    launch_ms = sum(s.elapsed_time(e) for _, s, e in events) / len(events)
    dev_ms, how = device_ms(lambda: vso.vs_scores(*args),
                            KERNELS_OF["vector_sequence"])
    vso.vs_scores_plain(*args)
    plain_ms = time_ms(lambda: vso.vs_scores_plain(*args), reps=1)
    vectors = int(lengths.clamp(0, L).long().sum())
    nbytes = vectors * D * 4 + n * 4 + A * D * 4 + A + n * A * 4
    flops = 2 * vectors * D * (A + 1)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / SCALAR_OPS_PER_S * 1e3
    return {
        "ms": ms, "launch_ms": launch_ms, "device_ms": dev_ms,
        "device_how": how, "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "detail": f"{nbytes} bytes -> {bytes_ms:.4f} ms, {flops} FLOPs -> "
                  f"{ops_ms:.4f} ms", "shape": f"n={n}, L={L}, D={D}, A={A}, "
                  f"{vectors} real vectors",
    }


# --------------------------------------------------------------------- #
# 10 multiclass: the default GBT on three classes, and the GBT options
# --------------------------------------------------------------------- #


def options_frame(kind, seed, rows, test_rows):
    """scripts/make_torch_port_fixtures.py:options_frame: make_frame
    (binary or three classes), or the binary frame with a regression label
    from the generator's logit (float64): "poisson" counts with rate
    exp(0.3 logit), "laplace" the logit plus Laplace noise, both drawn
    from default_rng([seed, 5])."""
    classes = 3 if kind == "three_class" else 2
    train, test = make_frame(rows, test_rows, seed=seed, classes=classes)
    if kind in ("poisson", "laplace"):
        data = make_data(rows + test_rows, TRAIN_FEATURES)
        xd = np.stack([data[f"f{i}"] for i in range(5)], 1).astype(
            np.float64)
        logit = (xd[:, 0] - 0.5 * xd[:, 1] + np.sin(2 * xd[:, 2])
                 + xd[:, 3] * xd[:, 4])
        rng = np.random.default_rng([seed, 5])
        if kind == "poisson":
            y = rng.poisson(np.exp(0.3 * logit)).astype(np.float32)
        else:
            y = (logit + rng.laplace(size=len(logit))).astype(np.float32)
        train["label"], test["label"] = y[:rows], y[rows:]
    return train, test


def captured_layers(learner_cls, hp, train):
    """The training kernels' arguments, cloned as the kernels got them, in
    a one-iteration train of `learner_cls(**hp)` on `train` (the path's
    own layers): "root", every root histogram's, "routed", every fused
    layer's (a forest's tree 0: Lh = 1 .. 512; a GBT's first K trees),
    "binning", every call made through ops/binning.py's module name
    (the projection columns of oblique splits; the binner holds the
    function by its own name), and "segment", every run sum of the set
    candidates (ops/segment_sum.py)."""
    import torch

    from ydf_tpu_torch.ops import histogram_kernels

    from ydf_tpu_torch.ops import binning, segment_sum

    captured = {"root": [], "routed": [], "binning": [], "segment": []}
    originals = (histogram_kernels.histogram,
                 histogram_kernels.histogram_routed, binning.bin_columns,
                 segment_sum.segment_sums)

    def clone(args):
        return tuple(
            a.clone() if isinstance(a, torch.Tensor) else
            type(a)(*(t.clone() for t in a)) if isinstance(
                a, histogram_kernels.RouteTables) else a for a in args)

    def root(*args):
        captured["root"].append(clone(args))
        return originals[0](*args)

    def routed(*args):
        captured["routed"].append(clone(args))
        return originals[1](*args)

    def bins(*args):
        captured["binning"].append(clone(args))
        return originals[2](*args)

    def segment(*args):
        captured["segment"].append(clone(args))
        return originals[3](*args)

    histogram_kernels.histogram = root
    histogram_kernels.histogram_routed = routed
    binning.bin_columns = bins
    segment_sum.segment_sums = segment
    try:
        learner_cls(device=DEVICE, **dict(hp, num_trees=1)).train(train)
    finally:
        (histogram_kernels.histogram, histogram_kernels.histogram_routed,
         binning.bin_columns, segment_sum.segment_sums) = originals
    torch.cuda.synchronize()
    return captured


def multiclass_path(smi, serving):
    """Phase 10: GradientBoostedTreesLearner(label="label") with every
    default on three classes (K = 3 trees an iteration, the validation
    split, look-ahead early stopping, categorical splits) trained on the
    card, evaluated, saved and loaded, against the JAX package's run
    (ydf_tpu_torch/testdata/train_multiclass); then each small
    configuration of ydf_tpu_torch/testdata/train_gbt_options (the
    Poisson, MAE and focal losses, subsample, GOSS, candidate features,
    three classes with both samplings). Returns the `kernels` entries of
    the multiclass path's four kernels."""
    import hashlib
    import tempfile

    import torch

    import ydf_tpu_torch
    from ydf_tpu_torch.config import Task
    from ydf_tpu_torch.dataset.dataset import Dataset
    from ydf_tpu_torch.learners import gbt as port_gbt
    from ydf_tpu_torch.ops import binning, histogram_kernels
    from ydf_tpu_torch.serving import bank_scorer
    from ydf_tpu_torch.utils import cuda_build

    t_phase = time.perf_counter()
    with open(os.path.join(TRAIN_MULTICLASS, "config.json")) as f:
        cfg = json.load(f)
    assert (cfg["rows"], cfg["test_rows"], cfg["cat_seed"],
            cfg["data_seed"], cfg["compare_rows"], cfg["learner"],
            cfg["full_iterations"], cfg["generator"]) == (
        MC_ROWS, MC_TEST_ROWS, DEFAULT_CAT_SEED, DATA_SEED, MC_COMPARE_ROWS,
        MC_HP, MC_FULL_ITERATIONS,
        dict(features=TRAIN_FEATURES, cat_vocabs=list(DEFAULT_CAT_VOCABS),
             missing_features=list(DEFAULT_MISSING),
             class_cuts=list(CLASS_CUTS))), cfg
    K = cfg["num_trees_per_iter"]
    # The fixture writer refuses a fused update, so the port replays
    # JAX's update and every tree must come out bitwise.
    assert cfg["update_form"] == ["unfused"] * K, cfg["update_form"]
    exp = np.load(os.path.join(TRAIN_MULTICLASS, "expected.npz"))
    model_dir = os.path.join(TRAIN_MULTICLASS, "model")
    jax_forest = dict(np.load(os.path.join(model_dir, "forest.npz")))
    t0 = time.perf_counter()
    train, test = make_frame(MC_ROWS, MC_TEST_ROWS, classes=3)
    assert frame_sha256(train) == cfg["train_sha256"], "train frame"
    assert frame_sha256(test) == cfg["test_sha256"], "test frame"
    log("10 multiclass", f"frames {MC_ROWS} + {MC_TEST_ROWS} rows in "
        f"{time.perf_counter() - t0:.2f} s, SHA-256 == the fixture's; "
        f"classes {cfg['class_fractions']}; JAX fixture: jax "
        f"{cfg['jax_version']}, impls {cfg['jax_impls']}, {K} trees an "
        f"iteration, update form {cfg['update_form']} (the fusions XLA "
        f"compiled: {cfg['update_fusions']}), trained in "
        f"{cfg['jax_train_s_cpu']:.1f} s on the CPU that wrote it")

    # -- 10a the main path: train with every default, evaluate --------- #
    for k in histogram_kernels.LAUNCHES:
        histogram_kernels.LAUNCHES[k] = 0
    binning.KERNEL_LAUNCHES = 0
    for c in serving:
        c.KERNEL_LAUNCHES = 0
        c.KERNEL_ROWS = 0
    reads0 = port_gbt.HOST_READS
    cuda_build.LAUNCH_EVENTS = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    learner = ydf_tpu_torch.GradientBoostedTreesLearner(device=DEVICE,
                                                        **MC_HP)
    model = learner.train(train)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    ev = model.evaluate(test)
    torch.cuda.synchronize()
    eval_wall = time.perf_counter() - t0
    events, cuda_build.LAUNCH_EVENTS = cuda_build.LAUNCH_EVENTS, None
    counted = dict(histogram_kernels.LAUNCHES)
    counted["binning"] = binning.KERNEL_LAUNCHES
    counted["bank_scorer"] = bank_scorer.KERNEL_LAUNCHES
    others = {c.__name__: c.KERNEL_LAUNCHES for c in serving
              if c is not bank_scorer}
    reads = port_gbt.HOST_READS - reads0
    logs = model.training_logs
    trained, kept = logs["num_trees_trained"], logs["num_trees"]
    depth = learner.max_depth
    chunks = -(-trained // min(learner.early_stopping_num_trees_look_ahead,
                               port_gbt.MAX_CHUNK_TREES))
    assert model.num_trees_per_iter == K, model.num_trees_per_iter
    assert counted["histogram"] == trained * K, counted
    assert counted["histogram_routed"] == trained * K * (depth - 1), counted
    assert counted["binning"] >= 1 and counted["bank_scorer"] == K, counted
    assert not any(others.values()), others
    assert reads == chunks, (reads, chunks)
    kernel_ms, routed_lh = split_events(events)
    boost_ms = learner.last_timings["boost_s"] * 1e3
    valid_ms = kernel_ms.pop("valid_route", 0.0)
    log("10 launches", f"train_multiclass (train + evaluate): {counted} "
        f"launches (routed by hist slots: {routed_lh}); other serving "
        f"kernels {others}")
    log("10 train", f"GradientBoostedTreesLearner(**{MC_HP}).train: wall "
        f"{wall * 1e3:.1f} ms (host clock, ends in synchronize); stages "
        + " ".join(f"{k}={v * 1e3:.1f}ms" for k, v in
                   learner.last_timings.items())
        + f"; {trained} iterations ({trained * K} trees) trained, {kept} "
        f"kept; {chunks} chunks, {reads} host reads of the validation "
        f"losses; {boost_ms / trained:.2f} ms an iteration (loop wall / "
        f"iterations trained); validation routing {valid_ms:.1f} ms (CUDA "
        f"events) = {100 * valid_ms / boost_ms:.2f}% of the loop; kernel "
        "time (CUDA events, train + evaluate) " + " ".join(
            f"{k}={v:.3f}ms" for k, v in kernel_ms.items())
        + f"; evaluate of {MC_TEST_ROWS} rows {eval_wall * 1e3:.1f} ms; "
        f"{smi}")

    # -- 10b against the JAX package's run ----------------------------- #
    bins = model.binner.transform(
        Dataset.from_data(train, dataspec=model.dataspec), model.device)
    assert sha256(bins) == cfg["bins_sha256"], "bins != the JAX package's"
    _, va_idx = port_gbt.split_validation(MC_ROWS, learner.validation_ratio,
                                          learner.random_seed)
    assert hashlib.sha256(va_idx.astype(np.int64).tobytes()).hexdigest() \
        == cfg["valid_idx_sha256"], "validation rows != the JAX package's"
    pf = model.forest.to_numpy()
    T = min(kept, cfg["num_trees"]) * K
    same = [tree_sha256(pf, t) == exp["tree_sha256"][t].tobytes().hex()
            for t in range(T)]
    differ = [t for t, ok in enumerate(same) if not ok]
    first = MC_FULL_ITERATIONS * K
    for field in ("feature", "threshold_bin", "is_cat", "cat_mask", "left",
                  "right", "is_leaf", "num_nodes"):
        assert np.array_equal(pf[field][:first], jax_forest[field][:first]), (
            f"the first {MC_FULL_ITERATIONS} iterations' {field} != JAX's")
    assert pf["leaf_value"][:first].tobytes() == \
        jax_forest["leaf_value"][:first].tobytes(), (
            f"the first {MC_FULL_ITERATIONS} iterations' leaf values")
    jv = exp["valid_loss"].astype(np.float64)
    pv = np.array([r["valid_loss"] for r in logs["iterations"]])
    assert pv[kept - 1] == jv.min(), (pv[kept - 1], jv.min())
    assert (kept, trained) == (cfg["num_trees"], cfg["num_trees_trained"]), (
        kept, trained, cfg["num_trees"], cfg["num_trees_trained"])
    assert not differ, f"trees differing from JAX's: {differ[:10]}"
    head = {k: v[:MC_COMPARE_ROWS] for k, v in test.items()}
    proba = model.predict(head)
    assert proba.shape == exp["proba"].shape and np.isfinite(proba).all()
    p_err = np.abs(proba - exp["proba"])
    assert p_err.max() <= MC_PROBA_ATOL and p_err.mean() <= \
        MC_PROBA_MEAN_ATOL, (p_err.max(), p_err.mean())
    jev = cfg["jax_evaluate"]
    assert abs(ev.metrics["accuracy"] - jev["accuracy"]) <= EVAL_ATOL, (
        ev.metrics, jev)
    assert abs(ev.metrics["loss"] / jev["loss"] - 1) <= MC_LOSS_RTOL, (
        ev.metrics, jev)
    confusion_same = np.array_equal(ev.confusion, cfg["jax_confusion"])
    log("10 vs JAX", f"bins and validation rows bitwise == JAX; kept "
        f"{kept} of {trained} iterations trained (JAX {cfg['num_trees']} "
        f"of {cfg['num_trees_trained']}); trees equal to JAX's by SHA-256: "
        f"{T - len(differ)} of {T} (first differing: "
        f"{differ[0] if differ else None}); the first {MC_FULL_ITERATIONS} "
        f"iterations' {first} trees == the JAX model's splits and leaf "
        f"values bitwise; validation loss at the kept count "
        f"{pv[kept - 1]!r} == JAX's best {jv.min()!r}; probabilities on "
        f"{MC_COMPARE_ROWS} test rows: max abs {p_err.max():.3g}, mean "
        f"{p_err.mean():.3g}, bitwise "
        f"{proba.tobytes() == exp['proba'].tobytes()}; evaluate on "
        f"{MC_TEST_ROWS} rows: " + " ".join(
            f"{k} {ev.metrics[k]:.6f} (JAX {jev[k]:.6f})" for k in jev)
        + f"; confusion matrix equal {confusion_same}")

    # -- 10c the JAX model on the card; save -> load ------------------- #
    jm = ydf_tpu_torch.load_model(model_dir, device=DEVICE)
    jp = jm.predict(head)
    assert jp.tobytes() == exp["model_proba"].tobytes(), (
        "the JAX model's probabilities on the card != JAX's")
    with tempfile.TemporaryDirectory() as tmp:
        model.save(os.path.join(tmp, "m"))
        back = ydf_tpu_torch.load_model(os.path.join(tmp, "m"),
                                        device=DEVICE)
        got, want = back.predict(test), model.predict(test)
    assert got.tobytes() == want.tobytes(), "save -> load changed them"
    log("10 save", f"the JAX model ({cfg['model_iterations']} iterations) "
        f"on the card: probabilities on {MC_COMPARE_ROWS} rows bitwise == "
        f"JAX's; model.save -> load_model: probabilities on "
        f"{MC_TEST_ROWS} rows bitwise equal")

    # -- 10d the options, each against its JAX run --------------------- #
    with open(os.path.join(TRAIN_GBT_OPTIONS, "config.json")) as f:
        ocfg = json.load(f)
    oexp = np.load(os.path.join(TRAIN_GBT_OPTIONS, "expected.npz"))
    for name, c in ocfg["configs"].items():
        res = ocfg["results"][name]
        tr, te = options_frame(c["frame"], ocfg["cat_seed"], ocfg["rows"],
                               ocfg["test_rows"])
        assert frame_sha256(tr) == res["train_sha256"], name
        t0 = time.perf_counter()
        m = ydf_tpu_torch.GradientBoostedTreesLearner(
            label="label", num_trees=ocfg["num_trees"], device=DEVICE,
            task=Task[c.get("task", "CLASSIFICATION")],
            **c["learner"]).train(tr)
        torch.cuda.synchronize()
        o_wall = time.perf_counter() - t0
        fo = m.forest.to_numpy()
        want = [h.tobytes().hex() for h in oexp[f"{name}/tree_sha256"]]
        got = [tree_sha256(fo, t) for t in range(fo["feature"].shape[0])]
        pred = m.predict(te)
        ok = (got == want
              and m.training_logs["num_trees"] == res["num_trees"]
              and pred.tobytes() == oexp[f"{name}/predictions"].tobytes())
        log("10 options", f"{name} ({c['learner']}): {len(got)} trees, "
            f"kept {m.training_logs['num_trees']} (JAX {res['num_trees']})"
            f", trees equal to JAX's by SHA-256: "
            f"{sum(a == b for a, b in zip(got, want))} of {len(want)}, "
            f"predictions on {ocfg['test_rows']} rows bitwise "
            f"{pred.tobytes() == oexp[f'{name}/predictions'].tobytes()}; "
            f"train wall {o_wall * 1e3:.1f} ms")
        assert ok, f"{name} differs from the JAX package's run"

    # -- 10e the kernels against plain on the path's own layers -------- #
    layers = captured_layers(ydf_tpu_torch.GradientBoostedTreesLearner,
                             MC_HP, train)
    # f64 cells round once, so the kernels equal plain (as in phase 9)
    # and every max abs error is 0.
    err = {"binning": 0.0, "histogram": 0.0, "histogram_routed": 0.0}
    for args in layers["routed"]:
        got = histogram_kernels.histogram_routed(*args)
        want = histogram_kernels.histogram_routed_plain(*args)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w), (
                f"routed kernel != plain at Lh {args[5]}")
    for args in layers["root"]:
        got = histogram_kernels.histogram(*args)
        want = histogram_kernels.histogram_plain(*args)
        torch.cuda.synchronize()
        assert torch.equal(got, want), "root histogram != plain"
    inp = train_inputs(train, model.binner)
    binning_check(inp["binning"])
    inp["root"] = layers["root"][0]
    lh_list = sorted({a[5] for a in layers["routed"]})
    log("10 kernels", f"on iteration 0's {K} trees of the path: the root "
        f"histogram ({len(layers['root'])} launches) and the routed kernel "
        f"({len(layers['routed'])} layers, Lh {lh_list}) against plain: "
        f"new_slot, new_leaf and the histograms torch.equal; binning "
        f"torch.equal at {MC_ROWS} x {model.binner.num_numerical}")

    # -- 10f where the loop's time goes (torch.profiler) --------------- #
    prof = profile_train(train, dict(MC_HP, num_trees=MC_PROFILE_ITERS))
    log("10 profile", f"one more train, num_trees={MC_PROFILE_ITERS} "
        f"iterations of {K} trees, under torch.profiler (the profiler "
        f"slows the host): wall {prof['wall_ms']:.1f} ms, boosting loop "
        f"{prof['loop_ms']:.1f} ms = {prof['loop_ms'] / MC_PROFILE_ITERS:.2f}"
        f" ms an iteration; {prof['kernels']} device kernels "
        f"({prof['kernels'] / MC_PROFILE_ITERS:.0f} an iteration), "
        f"{prof['busy_ms']:.3f} ms of device time over the whole train, so "
        f"the device is idle at least {100 * prof['idle_share']:.1f}% of "
        "the loop; largest: " + "; ".join(
            f"{name[:60]} {ms:.3f} ms" for name, ms in prof["top"]))

    # -- 10g each kernel timed at the path's shapes -------------------- #
    out = []
    for name, src, replaces in (
        ("binning", "binning.cu", "ydf_tpu/ops/binning_pallas.py:60"),
        ("histogram", "histogram.cu", "ydf_tpu/ops/histogram_pallas.py:81"),
        ("histogram_routed", "histogram_routed.cu",
         "ydf_tpu/ops/histogram_pallas.py:172"),
    ):
        if name == "histogram_routed":
            inp["routed"] = max(layers["routed"], key=lambda a: a[5])
        t = measure_train(name, inp)
        log("10 timing", f"{name} ({t['shape']}): {timing_text(t)}, {smi}")
        out.append(train_entry(name, "train_multiclass", src, replaces, t,
                               counted[name], err[name],
                               kernel_ms.get(name, 0.0)))
        if name == "histogram":
            out[-1]["path_bound_ms"] = t["bound_ms"] * counted[name]
        if name == "binning":
            out[-1]["path_bound_ms"] = t["bound_ms"] * counted[name]
        if name == "histogram_routed":
            by_lh = routed_by_captured(name, layers["routed"], events,
                                       routed_lh)
            out[-1].update(layer_fields(by_lh))
            log("10 layers", f"{name} on train_multiclass by hist slots "
                f"(timed on the path's own layers of iteration 0): "
                f"{layer_text(by_lh)}, {smi}")
    # The bank is timed on class 0's trees; evaluate scores each class's
    # sub-forest once, so the path bound sums every class's own bound.
    full = model.forest
    xT = encoded_xT(model, test)
    class_bounds = []
    try:
        for k in range(K):
            model.forest = model._dim_forests[k]
            bank = bank_scorer.build_bank_scorer(model)
            if k == 0:
                t = measure(bank_scorer, bank.tables, bank.tables, xT)
                class_bounds.append(t["bound_ms"])
            else:
                class_bounds.append(score_bound(bank.tables, bank.tables,
                                                xT)["bound_ms"])
    finally:
        model.forest = full
    log("10 timing", f"bank_scorer/train_multiclass at {xT.shape[1]} rows x "
        f"{xT.shape[0]} features (class 0's {kept} trees): kernel "
        f"{t['ms']:.4f} ms a call back to back, {t['device_ms']:.4f} ms on "
        f"the card ({t['device_how']}), plain {t['plain_ms']:.2f} ms, bound "
        f"{t['bound_ms']:.4f} ms ({t['bound_by']}; {t['detail']}); each "
        f"class's bound " + " ".join(f"{b:.4f}" for b in class_bounds)
        + f" ms, {smi}")
    out.append({
        "name": "bank_scorer/train_multiclass", "route": "cuda",
        "source": "ydf_tpu_torch/csrc/bank_scorer.cu",
        "replaces": "ydf_tpu/serving/pallas_scorer.py:118",
        "launches": counted["bank_scorer"], "max_abs_err": t["max_abs_err"],
        "ms": t["ms"], "device_ms": t["device_ms"],
        "device_how": t["device_how"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": None, "library_device_ms": None,
        "path_ms": kernel_ms.get("bank_scorer", 0.0),
        "path_how": "CUDA events around each launch",
        "path_bound_ms": sum(class_bounds),
    })
    log("10 multiclass", f"phase 10 wall {time.perf_counter() - t_phase:.1f} "
        "s")
    return out


# --------------------------------------------------------------------- #
# 11 cart_if: the CART and isolation forest learners on the card
# --------------------------------------------------------------------- #


def reset_counts(serving):
    """Every kernel wrapper's launch count set to 0, the launch events
    list started."""
    from ydf_tpu_torch.ops import binning, histogram_kernels, segment_sum
    from ydf_tpu_torch.utils import cuda_build

    for k in histogram_kernels.LAUNCHES:
        histogram_kernels.LAUNCHES[k] = 0
    binning.KERNEL_LAUNCHES = 0
    segment_sum.KERNEL_LAUNCHES = 0
    for c in serving:
        c.KERNEL_LAUNCHES = 0
        c.KERNEL_ROWS = 0
    cuda_build.LAUNCH_EVENTS = []


def read_counts(serving):
    """(training kernels' launches, serving kernels' launches, the
    launch events) since reset_counts; stops the events list."""
    from ydf_tpu_torch.ops import binning, histogram_kernels, segment_sum
    from ydf_tpu_torch.utils import cuda_build

    events, cuda_build.LAUNCH_EVENTS = cuda_build.LAUNCH_EVENTS, None
    counted = dict(histogram_kernels.LAUNCHES)
    counted["binning"] = binning.KERNEL_LAUNCHES
    counted["segment_sum"] = segment_sum.KERNEL_LAUNCHES
    return counted, {c.__name__: c.KERNEL_LAUNCHES for c in serving}, events


def same_tree(got, want, what, fields=TREE_HASH_FIELDS + (
        "num_nodes", "threshold")):
    """Tree 0 of two forests' numpy arrays equal field for field."""
    for f in fields:
        assert np.array_equal(np.asarray(got[f])[0], np.asarray(want[f])[0]), (
            f"{what}: {f} != the JAX package's")


def cart_train(learner, data):
    """learner.train(data) with the grown tree (tree 0's numpy arrays)
    recorded before the pruning: (model, grown arrays)."""
    from ydf_tpu_torch.learners import cart

    grown = []
    originals = (cart.prune_single_tree, cart.prune_single_tree_uplift)

    def capture(fn):
        def prune(model, valid_data, **kwargs):
            grown.append(model.forest.to_numpy())
            return fn(model, valid_data, **kwargs)
        return prune

    cart.prune_single_tree = capture(originals[0])
    cart.prune_single_tree_uplift = capture(originals[1])
    try:
        model = learner.train(data)
    finally:
        cart.prune_single_tree, cart.prune_single_tree_uplift = originals
    return model, grown[0]


def cart_if_path(smi, serving):
    """Phase 11: CartLearner(label="label") and IsolationForestLearner()
    with every default (the forest cut to IF_TREES trees) trained on the
    card (CART: train, then evaluate;
    the isolation forest: train, then predict), saved and loaded, against
    the JAX package's runs (ydf_tpu_torch/testdata/train_cart, train_if).
    Returns the `kernels` entries of both paths' three kernels."""
    import tempfile

    import torch

    import ydf_tpu_torch
    from ydf_tpu_torch.config import Task
    from ydf_tpu_torch.dataset.dataset import Dataset
    from ydf_tpu_torch.learners import isolation_forest as port_if
    from ydf_tpu_torch.learners import random_forest as port_rf
    from ydf_tpu_torch.metrics.metrics import evaluate_predictions
    from ydf_tpu_torch.ops import histogram_kernels
    from ydf_tpu_torch.utils import prng

    t_phase = time.perf_counter()
    walls, last = {}, [t_phase]

    def lap(part):
        """The wall seconds since the last lap, under `part`."""
        now = time.perf_counter()
        walls[part] = round(now - last[0], 2)
        last[0] = now

    with open(os.path.join(TRAIN_CART, "config.json")) as f:
        cc = json.load(f)
    with open(os.path.join(TRAIN_IF, "config.json")) as f:
        ci = json.load(f)
    gen = dict(features=TRAIN_FEATURES, cat_vocabs=list(DEFAULT_CAT_VOCABS),
               missing_features=list(DEFAULT_MISSING))
    assert (cc["rows"], cc["test_rows"], cc["cat_seed"], cc["learner"],
            cc["generator"]) == (CART_ROWS, CART_TEST_ROWS,
                                 DEFAULT_CAT_SEED, CART_HP, gen), cc
    assert (ci["rows"], ci["test_rows"], ci["cat_seed"], ci["learner"],
            ci["generator"]) == (IF_ROWS, IF_TEST_ROWS, DEFAULT_CAT_SEED, {},
                                 dict(gen, anomaly=IF_ANOMALY)), ci
    ec = np.load(os.path.join(TRAIN_CART, "expected.npz"))
    ei = np.load(os.path.join(TRAIN_IF, "expected.npz"))
    t0 = time.perf_counter()
    train, test = make_frame(CART_ROWS, CART_TEST_ROWS)
    feats = {k: v for k, v in train.items() if k != "label"}
    test_x, anomalous = if_test_frame(test)
    rc = cc["regression"]
    rtrain, rtest = options_frame(rc["frame"], DEFAULT_CAT_SEED, rc["rows"],
                                  rc["test_rows"])
    rr = cc["regression_result"]
    for frame, want, what in (
            (train, cc["train_sha256"], "train"),
            (test, cc["test_sha256"], "test"),
            (feats, ci["train_sha256"], "IF train"),
            (test_x, ci["test_sha256"], "IF test"),
            (rtrain, rr["train_sha256"], "regression train"),
            (rtest, rr["test_sha256"], "regression test")):
        assert frame_sha256(frame) == want, f"{what} frame"
    log("11 cart_if", f"frames {CART_ROWS} + {CART_TEST_ROWS} rows (IF: "
        f"the 32 feature columns, {int(anomalous.sum())} test rows made "
        f"anomalous) and {rc['rows']} + {rc['test_rows']} ({rc['frame']} "
        f"regression) in {time.perf_counter() - t0:.2f} s, SHA-256 == the "
        f"fixtures'; JAX fixtures: jax {cc['jax_version']}, CART in "
        f"{cc['jax_train_s_cpu']:.1f} s and {ci['num_trees']} IF trees in "
        f"{ci['jax_train_s_cpu']:.1f} s on the CPU that wrote them")

    lap("setup")
    # -- 11a CART: train with every default, evaluate ------------------ #
    reset_counts(serving)
    reads0 = port_rf.HOST_READS
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    learner = ydf_tpu_torch.CartLearner(device=DEVICE, **CART_HP)
    model, grown = cart_train(learner, train)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    ev = model.evaluate(test)
    torch.cuda.synchronize()
    eval_wall = time.perf_counter() - t0
    counted_c, others, events_c = read_counts(serving)
    reads = port_rf.HOST_READS - reads0
    depth = learner.max_depth
    assert counted_c["histogram"] == 1, counted_c
    assert counted_c["histogram_routed"] == depth - 1, counted_c
    assert counted_c["binning"] == 1, counted_c
    assert not any(others.values()), others
    assert reads == 0, reads
    kernel_ms_c, routed_lh_c = split_events(events_c)
    log("11 launches", f"train_cart (train + evaluate): {counted_c} "
        f"launches (routed by hist slots: {routed_lh_c}); serving kernels "
        f"{others} (CART serves routed, a one-tree mean)")
    log("11 cart", f"CartLearner(**{CART_HP}).train: wall {wall * 1e3:.1f} "
        "ms (host clock, ends in synchronize; the grown tree copied to the "
        "host once more for the check below); stages " + " ".join(
            f"{k}={v * 1e3:.1f}ms" for k, v in learner.last_timings.items())
        + f"; depth {depth}, {reads} host reads before or in the tree "
        "loop; kernel time (CUDA events, train + evaluate) " + " ".join(
            f"{k}={v:.3f}ms" for k, v in kernel_ms_c.items())
        + f"; evaluate of {CART_TEST_ROWS} rows {eval_wall * 1e3:.1f} ms; "
        f"{smi}")

    lap("11a")
    # -- 11b CART against the JAX package's run ------------------------ #
    mask = np.random.RandomState(cc["seed"]).uniform(size=CART_ROWS) \
        < cc["validation_ratio"]
    assert array_sha256(mask) == cc["holdout_sha256"], "holdout"
    bins = model.binner.transform(Dataset.from_data(
        {k: v[~mask] for k, v in train.items()}, dataspec=model.dataspec),
        model.device)
    assert sha256(bins) == cc["bins_sha256"], "bins != the JAX package's"
    jax_grown = {k.split("/", 1)[1]: ec[k] for k in ec.files
                 if k.startswith("grown/")}
    same_tree(grown, jax_grown, "CART's grown tree")
    assert tree_sha256(grown, 0) == cc["grown_sha256"]
    pf = model.forest.to_numpy()
    jax_cart = dict(np.load(os.path.join(TRAIN_CART, "model", "forest.npz")))
    same_tree(pf, jax_cart, "CART's pruned tree")
    assert tree_sha256(pf, 0) == cc["pruned_sha256"]
    pruned = model.extra_metadata["num_pruned_nodes"]
    assert pruned == cc["num_pruned_nodes"], pruned
    jo, po = cc["oob_evaluation"], model.self_evaluation()
    assert (po["source"], po["num_examples"]) == (jo["source"],
                                                  jo["num_examples"]), po
    hold_err = max(abs(po["metrics"][k] - jo["metrics"][k])
                   for k in jo["metrics"])
    jev = cc["jax_evaluate"]
    ev_err = max(abs(ev.metrics[k] - jev[k]) for k in jev)
    assert hold_err <= EVAL_SAME_ATOL and ev_err <= EVAL_SAME_ATOL, (
        hold_err, ev_err)
    head = {k: v[:cc["compare_rows"]] for k, v in test.items()}
    proba = model.predict(head)
    assert proba.tobytes() == ec["proba"].tobytes(), "CART probabilities"
    rlearner = ydf_tpu_torch.CartLearner(device=DEVICE, task=Task.REGRESSION,
                                         **CART_HP)
    rmodel, rgrown = cart_train(rlearner, rtrain)
    rf_np = rmodel.forest.to_numpy()
    assert tree_sha256(rgrown, 0) == rr["grown_sha256"], "regression grown"
    assert tree_sha256(rf_np, 0) == rr["pruned_sha256"], "regression pruned"
    assert rmodel.extra_metadata["num_pruned_nodes"] == \
        rr["num_pruned_nodes"]
    rpred = rmodel.predict(rtest)
    assert rpred.tobytes() == ec["regression_predictions"].tobytes()
    log("11 cart vs JAX", f"holdout ({cc['holdout_rows']} rows) and bins "
        f"bitwise; the grown tree ({cc['grown_num_nodes']} nodes) and the "
        f"pruned one ({int(pf['num_nodes'][0])} nodes, {pruned} pruned) "
        "node for node == JAX's; holdout evaluation " + " ".join(
            f"{k} {po['metrics'][k]:.6f}" for k in jo["metrics"])
        + f" and evaluate on {CART_TEST_ROWS} rows " + " ".join(
            f"{k} {ev.metrics[k]:.6f}" for k in jev)
        + f", each within {EVAL_SAME_ATOL} of JAX's (max "
        f"{max(hold_err, ev_err):.3g}); "
        f"P(class 1) on {cc['compare_rows']} rows bitwise; the "
        f"{rc['rows']}-row regression CART: grown and pruned trees "
        f"({rr['num_pruned_nodes']} pruned) and {rc['test_rows']} "
        "predictions bitwise")

    lap("11b")
    # -- 11c the isolation forest: train with every default, predict --- #
    reset_counts(serving)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ilearner = ydf_tpu_torch.IsolationForestLearner(device=DEVICE,
                                                    num_trees=IF_TREES)
    imodel = ilearner.train(feats)
    torch.cuda.synchronize()
    iwall = time.perf_counter() - t0
    t0 = time.perf_counter()
    scores = imodel.predict(test_x)
    torch.cuda.synchronize()
    pred_wall = time.perf_counter() - t0
    counted_i, others, events_i = read_counts(serving)
    T = imodel.forest.num_trees
    idepth = imodel.max_depth
    assert (T, idepth) == (ci["cut"]["num_trees"], ci["max_depth"]), (
        T, idepth)
    assert counted_i["histogram"] == T, counted_i
    assert counted_i["histogram_routed"] == T * (idepth - 1), counted_i
    assert counted_i["binning"] == 1, counted_i
    assert not any(others.values()), others
    kernel_ms_i, routed_lh_i = split_events(events_i)
    loop_ms = ilearner.last_timings["loop_s"] * 1e3
    log("11 launches", f"train_if (train + predict): {counted_i} launches "
        f"(routed by hist slots: {routed_lh_i}); serving kernels {others} "
        "(an isolation forest serves routed, a mean)")
    log("11 if", f"IsolationForestLearner().train: wall {iwall * 1e3:.1f} "
        "ms (host clock, ends in synchronize); stages " + " ".join(
            f"{k}={v * 1e3:.1f}ms" for k, v in ilearner.last_timings.items())
        + f"; {T} trees of depth {idepth} on {imodel.num_examples_per_tree}"
        f" rows, no host read in the tree loop (sync debug mode error); "
        f"{loop_ms / T:.2f} ms a tree (loop wall / trees); kernel time "
        "(CUDA events, train + predict) " + " ".join(
            f"{k}={v:.3f}ms" for k, v in kernel_ms_i.items())
        + f"; predict of {IF_TEST_ROWS} rows {pred_wall * 1e3:.1f} ms; "
        f"{smi}")

    lap("11c")
    # -- 11d the isolation forest against the JAX package's run -------- #
    ibins = imodel.binner.transform(
        Dataset.from_data(feats, dataspec=imodel.dataspec), imodel.device)
    assert sha256(ibins) == ci["bins_sha256"], "IF bins != the JAX package's"
    keys = port_if.tree_keys(ci["seed"], T, imodel.device)[:, 0]
    rows = np.sort(np.concatenate([prng.top_k(prng.uniform(
        keys[t:t + 25], (IF_ROWS,)), ci["subsample"]).cpu().numpy()
        for t in range(0, T, 25)]), axis=1)
    sub_same = [array_sha256(r) == ei["subsample_sha256"][t].tobytes().hex()
                for t, r in enumerate(rows)]
    assert all(sub_same), [t for t, ok in enumerate(sub_same) if not ok][:10]
    fi = imodel.forest.to_numpy()
    differ = [t for t in range(T) if tree_sha256(fi, t)
              != ei["tree_sha256"][t].tobytes().hex()]
    assert not differ, f"IF trees differ from JAX's: {differ[:10]}"
    assert np.array_equal(fi["num_nodes"], ei["num_nodes"][:T])
    same_tree(fi, {k.split("/", 1)[1]: ei[k] for k in ei.files
                   if k.startswith("tree0/")}, "IF tree 0")
    cut = ci["cut"]
    assert array_sha256(scores) == cut["scores_sha256"], "IF scores"
    assert scores[:ci["compare_rows"]].tobytes() == \
        ei["cut/scores"].tobytes()
    auc = evaluate_predictions(Task.ANOMALY_DETECTION, anomalous,
                               scores).metrics["auc"]
    assert auc == cut["auc"], (auc, cut["auc"])
    nodes = fi["num_nodes"]
    log("11 if vs JAX", f"bins bitwise; all {T} subsamples ({ci['subsample']}"
        f" rows each) and all {T} trees == JAX's by SHA-256 (the first {T} of"
        f" its {ci['num_trees']}; nodes a tree "
        f"{int(nodes.min())}-{int(nodes.max())}, mean {nodes.mean():.1f}); "
        f"tree 0 node for node; scores on {IF_TEST_ROWS} rows bitwise "
        f"(SHA-256), AUC {auc:.6f} on the {int(anomalous.sum())} anomalous "
        "rows == JAX's")

    lap("11d")
    # -- 11e save -> load, the JAX models on the card ------------------ #
    with tempfile.TemporaryDirectory() as tmp:
        model.save(os.path.join(tmp, "cart"))
        imodel.save(os.path.join(tmp, "if"))
        back = ydf_tpu_torch.load_model(os.path.join(tmp, "cart"),
                                        device=DEVICE)
        iback = ydf_tpu_torch.load_model(os.path.join(tmp, "if"),
                                         device=DEVICE)
    assert back.predict(test).tobytes() == model.predict(test).tobytes()
    assert back.self_evaluation() == model.self_evaluation()
    assert back.extra_metadata == model.extra_metadata
    assert iback.predict(test_x).tobytes() == scores.tobytes()
    for b, m in ((back, model), (iback, imodel)):
        bf, mf = b.forest.to_numpy(), m.forest.to_numpy()
        assert all(np.array_equal(bf[k], mf[k]) for k in mf), "save -> load"
    jc = ydf_tpu_torch.load_model(os.path.join(TRAIN_CART, "model"),
                                  device=DEVICE)
    assert jc.predict(head).tobytes() == ec["proba"].tobytes()
    ji = ydf_tpu_torch.load_model(os.path.join(TRAIN_IF, "model"),
                                  device=DEVICE)
    ihead = {k: v[:ci["compare_rows"]] for k, v in test_x.items()}
    assert ji.predict(ihead).tobytes() == ei["model_scores"].tobytes()
    log("11 save", "model.save -> load_model of both: node arrays, the "
        f"holdout evaluation, num_pruned_nodes and predictions on "
        f"{CART_TEST_ROWS} rows bitwise; the JAX package's saved CART and "
        f"{ci['model_trees']}-tree isolation forest on the card: "
        f"probabilities and scores on {ci['compare_rows']} rows bitwise == "
        "JAX's")

    lap("11e")
    # -- 11f each training kernel against its plain version ------------ #
    layers = {
        "train_cart": captured_layers(ydf_tpu_torch.CartLearner, CART_HP,
                                      train),
        "train_if": captured_layers(ydf_tpu_torch.IsolationForestLearner,
                                    {}, feats),
    }
    checked = {}
    for path, case in layers.items():
        for args in case["routed"]:
            got = histogram_kernels.histogram_routed(*args)
            want = histogram_kernels.histogram_routed_plain(*args)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                assert torch.equal(g, w), (
                    f"{path}: routed kernel != plain at Lh {args[5]}, "
                    f"Sq {args[4].shape[1]}, n {args[0].shape[1]}")
            checked.setdefault(path, []).append(args[5])
        for args in case["root"]:
            got = histogram_kernels.histogram(*args)
            want = histogram_kernels.histogram_plain(*args)
            torch.cuda.synchronize()
            assert torch.equal(got, want), f"{path}: root histogram != plain"
    cart_routed = layers["train_cart"]["routed"]
    widest = max(cart_routed, key=lambda a: a[5])
    if_root = layers["train_if"]["root"][0]
    log("11 kernels", "histogram_routed on every fused layer of each path's "
        "tree 0 (new_slot, new_leaf, histogram) and the root histogram "
        "torch.equal to plain: train_cart at Lh "
        f"{checked['train_cart']} on {cart_routed[0][0].shape[1]} rows, "
        f"Sq {cart_routed[0][4].shape[1]}; train_if at Lh "
        f"{checked['train_if']} on {if_root[0].shape[1]} rows, Sq "
        f"{if_root[2].shape[1]} (root launch {root_shape_text(if_root)}); "
        f"the routed launch at train_cart's widest layer, Lh {widest[5]}: "
        f"{routed_memory(widest)}")

    lap("11f")
    # -- 11g where the isolation forest's loop time goes --------------- #
    prof = profile_train(feats, dict(num_trees=IF_PROFILE_TREES),
                         ydf_tpu_torch.IsolationForestLearner, "loop_s")
    log("11 profile", f"one more IF train, num_trees={IF_PROFILE_TREES}, "
        "under torch.profiler (the profiler slows the host): wall "
        f"{prof['wall_ms']:.1f} ms, tree loop {prof['loop_ms']:.1f} ms; "
        f"{prof['kernels']} device kernels "
        f"({prof['kernels'] / IF_PROFILE_TREES:.0f} a tree), "
        f"{prof['busy_ms']:.3f} ms of device time over the whole train, so "
        f"the device is idle at least {100 * prof['idle_share']:.1f}% of "
        "the loop; largest: " + "; ".join(
            f"{name[:60]} {ms:.3f} ms" for name, ms in prof["top"]))

    lap("11g")
    # -- 11h each kernel timed at the paths' shapes -------------------- #
    out = []
    inputs = {
        "train_cart": dict(train_inputs(
            {k: v[~mask] for k, v in train.items()}, model.binner),
            root=layers["train_cart"]["root"][0]),
        "train_if": dict(train_inputs(train, imodel.binner), root=if_root),
    }
    paths = {"train_cart": (counted_c, kernel_ms_c, events_c, routed_lh_c),
             "train_if": (counted_i, kernel_ms_i, events_i, routed_lh_i)}
    for path, inp in inputs.items():
        counted, kernel_ms, events, routed_lh = paths[path]
        for name, src, replaces in (
            ("binning", "binning.cu", "ydf_tpu/ops/binning_pallas.py:60"),
            ("histogram", "histogram.cu",
             "ydf_tpu/ops/histogram_pallas.py:81"),
            ("histogram_routed", "histogram_routed.cu",
             "ydf_tpu/ops/histogram_pallas.py:172"),
        ):
            if name == "histogram_routed":
                inp["routed"] = max(layers[path]["routed"],
                                    key=lambda a: a[5])
            t = measure_train(name, inp, reps=RF_ROOT_REPS
                              if name == "histogram" else 20)
            log("11 timing", f"{path} {name} ({t['shape']}): "
                f"{timing_text(t)}, {smi}")
            out.append(train_entry(name, path, src, replaces, t,
                                   counted[name], 0.0,
                                   kernel_ms.get(name, 0.0)))
            if name == "histogram_routed":
                by_lh = routed_by_captured(name, layers[path]["routed"],
                                           events, routed_lh)
                out[-1].update(layer_fields(by_lh))
                log("11 layers", f"{name} on {path} by hist slots: "
                    f"{layer_text(by_lh)}, {smi}")
    lap("11h")
    log("11 cart_if", f"phase 11 wall {time.perf_counter() - t_phase:.1f} s "
        f"(by part, s: {walls})")
    return out


def capture_returns(module, name):
    """Wraps module.name so that each call's return value is recorded:
    (the records, a function restoring the original)."""
    records = []
    original = getattr(module, name)

    def wrapped(*args, **kwargs):
        out = original(*args, **kwargs)
        records.append(out)
        return out

    setattr(module, name, wrapped)
    return records, lambda: setattr(module, name, original)


def check_oblique_trees(exp, prefix, forest_np, W, bounds, T):
    """Trees [0, T) of a port forest (Forest.to_numpy()) against the
    fixture's: node arrays and thresholds by hash, projections bitwise,
    each tree's boundaries by hash (tree 0's bitwise), node counts."""
    W, bounds = W.cpu().numpy(), bounds.cpu().numpy()

    def hexes(key):
        return [d.tobytes().hex() for d in exp[f"{prefix}/{key}"][:T]]

    for what, got in (
            ("tree", [tree_sha256(forest_np, t) for t in range(T)]),
            ("threshold", [array_sha256(forest_np["threshold"][t])
                           for t in range(T)]),
            ("bounds", [array_sha256(bounds[t]) for t in range(T)])):
        differ = [t for t, (a, b) in enumerate(zip(got, hexes(
            f"{what}_sha256"))) if a != b]
        assert not differ, f"{prefix}: {what} of trees {differ[:10]} != JAX's"
    assert W[:T].tobytes() == exp[f"{prefix}/oblique_weights"][:T].tobytes(), (
        f"{prefix}: projections != JAX's")
    assert bounds[0].tobytes() == exp[f"{prefix}/bounds0"].tobytes()
    assert np.array_equal(forest_np["num_nodes"][:T],
                          exp[f"{prefix}/num_nodes"][:T])


def oblique_layers(name, captured, events, launches_by_lh):
    """The routed kernel at each hist-slot count of an oblique path,
    timed on the path's own captured layer of that count where the
    captured tree reached it, else on routed_layer's seeded layer over
    the same bins and stats: {Lh: {...}} as routed_by_captured."""
    first = {}
    for args in captured:
        first.setdefault(args[5], args)
    bins_t, _, _, _, stats, _, B = captured[0]
    out = {}
    for lh in sorted(launches_by_lh):
        args = first.get(lh) or routed_layer(bins_t, stats, lh, B)
        t = measure_train(name, {"routed": args}, timing_only=True)
        out[lh] = {
            "launches": launches_by_lh[lh], "device_ms": t["device_ms"],
            "device_how": t["device_how"], "bound_ms": t["bound_ms"],
            "captured": lh in first,
            "path_ms": sum(s.elapsed_time(e) for k, s, e in events
                           if k == f"histogram_routed/Lh={lh}"),
        }
    return out


def oblique_path(smi, serving):
    """Phase 12: the GBT, random forest, CART and isolation forest with
    split_axis="SPARSE_OBLIQUE" and every other default trained on the
    card (then evaluated, or the isolation forest's rows scored), saved
    and loaded, against the JAX package's runs
    (ydf_tpu_torch/testdata/train_oblique). Returns the `kernels` entries
    of the four paths' three training kernels."""
    import tempfile

    import torch

    import ydf_tpu_torch
    from ydf_tpu_torch.config import Task
    from ydf_tpu_torch.learners import gbt as port_gbt
    from ydf_tpu_torch.learners import isolation_forest as port_if
    from ydf_tpu_torch.learners import random_forest as port_rf
    from ydf_tpu_torch.metrics.metrics import evaluate_predictions
    from ydf_tpu_torch.models.forest import Forest
    from ydf_tpu_torch.ops import histogram_kernels

    t_phase = time.perf_counter()
    walls, last = {}, [t_phase]

    def lap(part):
        now = time.perf_counter()
        walls[part] = round(now - last[0], 2)
        last[0] = now

    with open(os.path.join(TRAIN_OBLIQUE, "config.json")) as f:
        cfg = json.load(f)
    exp = np.load(os.path.join(TRAIN_OBLIQUE, "expected.npz"))
    cg, cr, cc, ci = (cfg[k] for k in ("gbt", "rf", "cart", "iforest"))
    assert cfg["generator"] == dict(
        features=TRAIN_FEATURES, cat_vocabs=list(DEFAULT_CAT_VOCABS),
        missing_features=list(DEFAULT_MISSING)), cfg["generator"]
    assert cfg["cat_seed"] == DEFAULT_CAT_SEED
    assert (cg["rows"], cg["test_rows"], cg["learner"]) == (
        DEFAULT_ROWS, DEFAULT_TEST_ROWS, OBLIQUE_HP), cg
    assert (cr["rows"], cr["test_rows"], cr["learner"],
            cr["fixture_trees"]) == (RF_ROWS, RF_TEST_ROWS, OBLIQUE_HP,
                                     OBLIQUE_RF_FIXTURE_TREES), cr
    assert (cc["rows"], cc["test_rows"], cc["learner"]) == (
        CART_ROWS, CART_TEST_ROWS, OBLIQUE_HP), cc
    assert (ci["rows"], ci["test_rows"], ci["learner"]) == (
        IF_ROWS, IF_TEST_ROWS, {"split_axis": "SPARSE_OBLIQUE"}), ci
    t0 = time.perf_counter()
    train, test = make_frame(DEFAULT_ROWS, DEFAULT_TEST_ROWS)
    rtrain, rtest = make_frame(RF_ROWS, RF_TEST_ROWS)
    feats = {k: v for k, v in train.items() if k != "label"}
    test_x, anomalous = if_test_frame(test)
    for frame, want, what in (
            (train, cg["train_sha256"], "train"),
            (test, cg["test_sha256"], "test"),
            (rtrain, cr["train_sha256"], "RF train"),
            (rtest, cr["test_sha256"], "RF test"),
            (feats, ci["train_sha256"], "IF train"),
            (test_x, ci["test_sha256"], "IF test")):
        assert frame_sha256(frame) == want, f"{what} frame"
    log("12 oblique", f"frames {DEFAULT_ROWS} + {DEFAULT_TEST_ROWS} rows "
        f"(GBT, CART, IF) and {RF_ROWS} + {RF_TEST_ROWS} (RF) in "
        f"{time.perf_counter() - t0:.2f} s, SHA-256 == the fixture's; JAX "
        f"fixture: jax {cfg['jax_version']}, impls {cfg['jax_impls']}; "
        f"JAX on the CPU that wrote it: GBT {cg['jax_train_s_cpu']:.1f} s, "
        f"RF ({cr['fixture_trees']} trees) {cr['jax_train_s_cpu']:.1f} s, "
        f"CART {cc['jax_train_s_cpu']:.1f} s, IF {ci['jax_train_s_cpu']:.1f}"
        " s")
    lap("setup")
    paths = {}  # path -> (launches, kernel ms, events, routed by Lh)

    def main_run(path, fn, module, name):
        """Counts at 0, fn() on the card, counts read: (fn's result, the
        captured loop result, launches, serving launches, events)."""
        records, restore = capture_returns(module, name)
        reset_counts(serving)
        torch.cuda.synchronize()
        try:
            t0 = time.perf_counter()
            result = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            restore()
        counted, others, events = read_counts(serving)
        assert not any(others.values()), (path, others)
        kernel_ms, routed_lh = split_events(events)
        paths[path] = (counted, kernel_ms, events, routed_lh)
        log("12 launches", f"{path}: {counted} launches (routed by hist "
            f"slots: {routed_lh}); serving kernels {others} (an oblique "
            "forest serves routed)")
        return result, records[0], counted, wall, kernel_ms

    # -- 12a the GBT: train with every default, evaluate --------------- #
    reads0 = port_gbt.HOST_READS
    learner = ydf_tpu_torch.GradientBoostedTreesLearner(device=DEVICE,
                                                        **OBLIQUE_HP)

    def gbt_main():
        m = learner.train(train)
        t0 = time.perf_counter()
        ev = m.evaluate(test)
        torch.cuda.synchronize()
        return m, ev, time.perf_counter() - t0

    (model, ev, eval_wall), out, counted, wall, kernel_ms = main_run(
        "train_oblique_gbt", gbt_main, port_gbt, "boost")
    logs = model.training_logs
    trained, kept = logs["num_trees_trained"], logs["num_trees"]
    depth = learner.max_depth
    chunks = -(-trained // min(learner.early_stopping_num_trees_look_ahead,
                               port_gbt.MAX_CHUNK_TREES))
    reads = port_gbt.HOST_READS - reads0
    assert counted["histogram"] == trained, counted
    assert counted["histogram_routed"] == trained * (depth - 1), counted
    # The binner's one call, then each iteration's training and
    # validation projections.
    assert counted["binning"] == 1 + 2 * trained, counted
    assert reads == chunks, (reads, chunks)
    boost_ms = learner.last_timings["boost_s"] * 1e3
    P = model.forest.oblique_weights.shape[1]
    log("12 gbt", f"GradientBoostedTreesLearner(**{OBLIQUE_HP}).train: "
        f"wall {wall * 1e3 - eval_wall * 1e3:.1f} ms (host clock, ends in "
        "synchronize); stages " + " ".join(
            f"{k}={v * 1e3:.1f}ms" for k, v in learner.last_timings.items())
        + f"; P = {P} projections an iteration; {trained} trees trained, "
        f"{kept} kept; {reads} host reads ({chunks} chunks); "
        f"{boost_ms / trained:.2f} ms a tree (loop wall / trees trained); "
        "kernel time (CUDA events, train + evaluate) " + " ".join(
            f"{k}={v:.3f}ms" for k, v in kernel_ms.items())
        + f"; evaluate of {DEFAULT_TEST_ROWS} rows {eval_wall * 1e3:.1f} "
        f"ms; {smi}")
    assert (kept, trained) == (cg["num_trees"], cg["num_trees_trained"]), (
        kept, trained)
    pf = model.forest.to_numpy()
    W, bounds = out.obl_out
    check_oblique_trees(exp, "gbt", pf, W, bounds, kept)
    preds = model.predict(test)
    assert array_sha256(preds) == cg["predictions_sha256"], "GBT predictions"
    jev = cg["jax_evaluate"]
    ev_err = max(abs(ev.metrics[k] - jev[k]) for k in jev)
    assert ev_err <= EVAL_SAME_ATOL, ev_err
    il = logs["iterations"]
    vl = np.array([r["valid_loss"] for r in il], np.float32)
    log("12 gbt vs JAX", f"{kept} of {trained} trees == JAX's ({kept} kept "
        "by the same look-ahead stop): every kept tree by SHA-256 (node "
        "arrays, thresholds), its 28 x 28 projections bitwise and its "
        "28 x 255 boundaries by SHA-256 (iteration 0's bitwise); the "
        f"{DEFAULT_TEST_ROWS} predictions bitwise (SHA-256) to JAX's Routed "
        "engine; evaluate " + " ".join(
            f"{k} {ev.metrics[k]:.6f}" for k in jev)
        + f" within {EVAL_SAME_ATOL} of JAX's (max {ev_err:.3g}); "
        f"validation loss at the kept count {vl[kept - 1]:.6f} (JAX "
        f"{exp['gbt/valid_loss'][kept - 1]:.6f})")
    lap("12a")

    # -- 12b serving: the JAX-saved oblique GBT, save -> load ---------- #
    jm = ydf_tpu_torch.load_model(os.path.join(TRAIN_OBLIQUE, "gbt_model"),
                                  device=DEVICE)
    assert jm.list_compatible_engines() == ["Routed"]
    head = {k.split("/", 1)[1]: exp[k] for k in exp.files
            if k.startswith("gbt_head/")}
    assert jm.predict(head).tobytes() == exp["gbt/predictions"].tobytes()
    reset_counts(serving)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    jpreds = jm.predict(test)
    torch.cuda.synchronize()
    serve_wall = time.perf_counter() - t0
    counted_s, others, _ = read_counts(serving)
    assert not any(others.values()) and not any(counted_s.values()), (
        counted_s, others)
    assert array_sha256(jpreds) == cg["predictions_sha256"]
    with tempfile.TemporaryDirectory() as tmp:
        model.save(os.path.join(tmp, "gbt"))
        back = ydf_tpu_torch.load_model(os.path.join(tmp, "gbt"),
                                        device=DEVICE)
    bf = back.forest.to_numpy()
    assert all(bf[k].tobytes() == pf[k].tobytes() for k in pf), (
        "save -> load")
    assert back.predict(test).tobytes() == preds.tobytes()
    log("12 serving", f"the JAX-saved oblique GBT ({jm.forest.num_trees} "
        f"trees, {P} projections each) on the card: registry "
        f"{jm.list_compatible_engines()}; predictions on the fixture's "
        f"{len(exp['gbt/predictions'])} rows and on all {DEFAULT_TEST_ROWS} "
        "test rows (SHA-256) bitwise == JAX's Routed engine; predict of "
        f"{DEFAULT_TEST_ROWS} rows {serve_wall * 1e3:.1f} ms wall (host "
        "encode, copy, routed scan over the trees with each tree's "
        "projections, copy back); no kernel launched; save -> load on "
        f"the card bitwise; {smi}")
    lap("12b")

    # -- 12c the random forest: OBLIQUE_RF_TREES on train_rf's frame --- #
    rlearner = ydf_tpu_torch.RandomForestLearner(
        device=DEVICE, **dict(OBLIQUE_HP, num_trees=OBLIQUE_RF_TREES))

    def rf_main():
        m = rlearner.train(rtrain)
        t0 = time.perf_counter()
        ev = m.evaluate(rtest)
        torch.cuda.synchronize()
        return m, ev, time.perf_counter() - t0

    reads0 = port_rf.HOST_READS
    (rmodel, rev, reval_wall), rout, counted, wall, kernel_ms = main_run(
        "train_oblique_rf", rf_main, port_rf, "train_rf")
    T = rmodel.forest.num_trees
    rdepth = rlearner.max_depth
    assert counted["histogram"] == T, counted
    assert counted["binning"] == 1 + T, counted
    assert 0 < counted["histogram_routed"] <= T * (rdepth - 1), counted
    rreads = port_rf.HOST_READS - reads0
    loop_ms = rlearner.last_timings["loop_s"] * 1e3
    log("12 rf", f"RandomForestLearner(**{OBLIQUE_HP}).train: wall "
        f"{(wall - reval_wall) * 1e3:.1f} ms (host clock, ends in "
        "synchronize); stages " + " ".join(
            f"{k}={v * 1e3:.1f}ms" for k, v in rlearner.last_timings.items())
        + f"; {T} trees of depth {rdepth}, {rreads} host reads before the "
        f"loop, none in it; {loop_ms / T:.2f} ms a tree (loop wall / "
        "trees); kernel time (CUDA events, train + evaluate) " + " ".join(
            f"{k}={v:.3f}ms" for k, v in kernel_ms.items())
        + f"; evaluate of {RF_TEST_ROWS} rows {reval_wall * 1e3:.1f} ms; "
        f"{smi}")
    K = cr["fixture_trees"]
    rf_np = rmodel.forest.to_numpy()
    check_oblique_trees(exp, "rf", rf_np, *rout.obl_out, K)
    # The fixture's forest: the first K trees of the card's.
    sub = port_rf.RandomForestModel(
        task=rmodel.task, label=rmodel.label, classes=rmodel.classes,
        dataspec=rmodel.dataspec, binner=rmodel.binner,
        forest=Forest(*(a[:K] for a in rmodel.forest)),
        max_depth=rmodel.max_depth)
    rhead = {k: v[:cfg["compare_rows"]] for k, v in rtest.items()}
    assert sub.predict(rhead).tobytes() == exp["rf/proba"].tobytes(), (
        "the first trees' probabilities")
    sev = sub.evaluate(rtest)
    jev = cr["jax_evaluate"]
    rf_err = max(abs(sev.metrics[k] - jev[k]) for k in jev)
    assert rf_err <= EVAL_SAME_ATOL, rf_err
    oob = rmodel.self_evaluation()
    log("12 rf vs JAX", f"the first {K} of {T} trees == the JAX fixture's "
        "by SHA-256 (node arrays, thresholds, boundaries), projections "
        f"bitwise; those {K} trees' probabilities on {cfg['compare_rows']} "
        f"rows bitwise and evaluate on {RF_TEST_ROWS} rows " + " ".join(
            f"{k} {sev.metrics[k]:.6f}" for k in jev)
        + f" within {EVAL_SAME_ATOL} of JAX's (max {rf_err:.3g}); the "
        f"{T}-tree forest: evaluate " + " ".join(
            f"{k} {rev.metrics[k]:.6f}" for k in jev)
        + ", out of bag " + " ".join(
            f"{k} {v:.6f}" for k, v in oob["metrics"].items()))
    lap("12c")

    # -- 12d CART: train with every default, evaluate ------------------ #
    clearner = ydf_tpu_torch.CartLearner(device=DEVICE, **OBLIQUE_HP)

    def cart_main():
        m, grown = cart_train(clearner, train)
        t0 = time.perf_counter()
        ev = m.evaluate(test)
        torch.cuda.synchronize()
        return m, grown, ev, time.perf_counter() - t0

    (cmodel, grown, cev, ceval_wall), cout, counted, wall, kernel_ms = \
        main_run("train_oblique_cart", cart_main, port_rf, "train_rf")
    cdepth = clearner.max_depth
    assert counted["histogram"] == 1, counted
    assert counted["histogram_routed"] == cdepth - 1, counted
    assert counted["binning"] == 2, counted
    log("12 cart", f"CartLearner(**{OBLIQUE_HP}).train: wall "
        f"{(wall - ceval_wall) * 1e3:.1f} ms (host clock, ends in "
        "synchronize; the grown tree copied to the host once more for the "
        "check below); stages " + " ".join(
            f"{k}={v * 1e3:.1f}ms" for k, v in clearner.last_timings.items())
        + "; kernel time (CUDA events, train + evaluate) " + " ".join(
            f"{k}={v:.3f}ms" for k, v in kernel_ms.items())
        + f"; evaluate of {CART_TEST_ROWS} rows {ceval_wall * 1e3:.1f} ms; "
        f"{smi}")
    assert tree_sha256(grown, 0) == cc["grown_sha256"], "CART grown tree"
    assert array_sha256(grown["threshold"][0]) == \
        cc["grown_threshold_sha256"], "CART grown thresholds"
    cf = cmodel.forest.to_numpy()
    check_oblique_trees(exp, "cart", cf, *cout.obl_out, 1)
    assert tree_sha256(cf, 0) == cc["pruned_sha256"]
    assert array_sha256(cf["threshold"][0]) == cc["pruned_threshold_sha256"]
    pruned = cmodel.extra_metadata["num_pruned_nodes"]
    assert pruned == cc["num_pruned_nodes"], pruned
    jo, po = cc["oob_evaluation"], cmodel.self_evaluation()
    assert (po["source"], po["num_examples"]) == (jo["source"],
                                                  jo["num_examples"]), po
    jev = cc["jax_evaluate"]
    cart_err = max([abs(po["metrics"][k] - jo["metrics"][k])
                    for k in jo["metrics"]]
                   + [abs(cev.metrics[k] - jev[k]) for k in jev])
    assert cart_err <= EVAL_SAME_ATOL, cart_err
    chead = {k: v[:cfg["compare_rows"]] for k, v in test.items()}
    assert cmodel.predict(chead).tobytes() == exp["cart/proba"].tobytes()
    log("12 cart vs JAX", f"the grown tree ({cc['grown_num_nodes']} nodes) "
        f"and the pruned one ({int(cf['num_nodes'][0])} nodes, {pruned} "
        "pruned) node for node == JAX's (SHA-256 of the node arrays and "
        "thresholds), projections bitwise; the holdout evaluation "
        "(pruning routes the holdout through the oblique nodes) and "
        "evaluate " + " ".join(f"{k} {cev.metrics[k]:.6f}" for k in jev)
        + f" within {EVAL_SAME_ATOL} of JAX's (max {cart_err:.3g}); "
        f"probabilities on {cfg['compare_rows']} rows bitwise")
    lap("12d")

    # -- 12e the isolation forest: train, score ------------------------ #
    ilearner = ydf_tpu_torch.IsolationForestLearner(
        device=DEVICE, num_trees=IF_TREES, **ci["learner"])

    def if_main():
        m = ilearner.train(feats)
        t0 = time.perf_counter()
        sc = m.predict(test_x)
        torch.cuda.synchronize()
        return m, sc, time.perf_counter() - t0

    (imodel, scores, pred_wall), iout, counted, wall, kernel_ms = main_run(
        "train_oblique_if", if_main, port_if, "train_if")
    T = imodel.forest.num_trees
    idepth = imodel.max_depth
    assert (T, idepth) == (ci["cut"]["num_trees"], ci["max_depth"]), (
        T, idepth)
    assert counted["histogram"] == T, counted
    assert counted["histogram_routed"] == T * (idepth - 1), counted
    assert counted["binning"] == 1 + T, counted
    iloop_ms = ilearner.last_timings["loop_s"] * 1e3
    log("12 if", f"IsolationForestLearner(split_axis='SPARSE_OBLIQUE')"
        f".train: wall {(wall - pred_wall) * 1e3:.1f} ms (host clock, ends "
        "in synchronize); stages " + " ".join(
            f"{k}={v * 1e3:.1f}ms" for k, v in ilearner.last_timings.items())
        + f"; {T} trees of depth {idepth}, no host read in the tree loop; "
        f"{iloop_ms / T:.2f} ms a tree (loop wall / trees); kernel time "
        "(CUDA events, train + predict) " + " ".join(
            f"{k}={v:.3f}ms" for k, v in kernel_ms.items())
        + f"; predict of {IF_TEST_ROWS} rows {pred_wall * 1e3:.1f} ms; "
        f"{smi}")
    fi = imodel.forest.to_numpy()
    check_oblique_trees(exp, "iforest", fi, *iout.obl_out, T)
    assert array_sha256(scores) == ci["cut"]["scores_sha256"], "IF scores"
    assert scores[:cfg["compare_rows"]].tobytes() == \
        exp["iforest_cut/scores"].tobytes()
    auc = evaluate_predictions(Task.ANOMALY_DETECTION, anomalous,
                               scores).metrics["auc"]
    assert auc == ci["cut"]["auc"], (auc, ci["cut"]["auc"])
    with tempfile.TemporaryDirectory() as tmp:
        imodel.save(os.path.join(tmp, "if"))
        iback = ydf_tpu_torch.load_model(os.path.join(tmp, "if"),
                                         device=DEVICE)
    assert iback.predict(test_x).tobytes() == scores.tobytes()
    log("12 if vs JAX", f"all {T} trees (the first {T} of JAX's "
        f"{ci['num_trees']}) == JAX's by SHA-256 (node arrays, "
        "thresholds, the 28 x 255 uniform boundaries), projections "
        f"bitwise; scores on {IF_TEST_ROWS} rows bitwise (SHA-256), AUC "
        f"{auc:.6f} on the {int(anomalous.sum())} anomalous rows == JAX's; "
        "save -> load on the card bitwise")
    lap("12e")

    # -- 12f each training kernel against its plain version ------------ #
    layers = {
        "train_oblique_gbt": captured_layers(
            ydf_tpu_torch.GradientBoostedTreesLearner, OBLIQUE_HP, train),
        "train_oblique_rf": captured_layers(
            ydf_tpu_torch.RandomForestLearner, OBLIQUE_HP, rtrain),
        "train_oblique_cart": captured_layers(
            ydf_tpu_torch.CartLearner, OBLIQUE_HP, train),
        "train_oblique_if": captured_layers(
            ydf_tpu_torch.IsolationForestLearner, ci["learner"], feats),
    }
    for path, case in layers.items():
        assert case["binning"], f"{path}: no projection binning captured"
        for args in case["binning"]:
            binning_check(args)
        for args in case["routed"]:
            got = histogram_kernels.histogram_routed(*args)
            want = histogram_kernels.histogram_routed_plain(*args)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                assert torch.equal(g, w), (
                    f"{path}: routed kernel != plain at Lh {args[5]}")
        for args in case["root"]:
            got = histogram_kernels.histogram(*args)
            want = histogram_kernels.histogram_plain(*args)
            torch.cuda.synchronize()
            assert torch.equal(got, want), f"{path}: root histogram != plain"
        log("12 kernels", f"{path}: the projection binning "
            f"({len(case['binning'])} calls, values "
            f"{tuple(case['binning'][0][0].shape)}), the root histogram "
            f"(F {case['root'][0][0].shape[0]} columns, n "
            f"{case['root'][0][0].shape[1]}) and histogram_routed at Lh "
            f"{sorted({a[5] for a in case['routed']})} of a one-tree "
            "train's own calls torch.equal to plain")
    lap("12f")

    # -- 12g where each loop's time goes ------------------------------- #
    profiles = {}
    for path, cls, hp, data, loop in (
            ("train_oblique_gbt", ydf_tpu_torch.GradientBoostedTreesLearner,
             dict(OBLIQUE_HP, num_trees=OBLIQUE_PROFILE_TREES["gbt"]),
             train, "boost_s"),
            ("train_oblique_rf", ydf_tpu_torch.RandomForestLearner,
             dict(OBLIQUE_HP, num_trees=OBLIQUE_PROFILE_TREES["rf"]),
             rtrain, "loop_s"),
            ("train_oblique_cart", ydf_tpu_torch.CartLearner, OBLIQUE_HP,
             train, "loop_s"),
            ("train_oblique_if", ydf_tpu_torch.IsolationForestLearner,
             dict(ci["learner"], num_trees=OBLIQUE_PROFILE_TREES["iforest"]),
             feats, "loop_s")):
        trees = hp.get("num_trees", 1)
        prof = profiles[path] = dict(profile_train(data, hp, cls, loop),
                                     trees=trees)
        log("12 profile", f"{path}: one more train, num_trees={trees}, "
            "under torch.profiler (the profiler slows the host): wall "
            f"{prof['wall_ms']:.1f} ms, tree loop {prof['loop_ms']:.1f} ms "
            f"({prof['loop_ms'] / trees:.2f} ms a tree); {prof['kernels']} "
            f"device kernels ({prof['kernels'] / trees:.0f} a tree), "
            f"{prof['busy_ms']:.3f} ms of device time over the whole "
            "train, so the device is idle at least "
            f"{100 * prof['idle_share']:.1f}% of the loop; largest: "
            + "; ".join(f"{name[:60]} {ms:.3f} ms"
                        for name, ms in prof["top"]))
    lap("12g")

    # -- 12h each kernel timed at each path's shapes ------------------- #
    result = []
    for path, case in layers.items():
        counted, kernel_ms, events, routed_lh = paths[path]
        inp = {"binning": max(case["binning"],
                              key=lambda a: a[0].shape[1]),
               "root": case["root"][0],
               "routed": max(case["routed"], key=lambda a: a[5])}
        for name, src, replaces in (
            ("binning", "binning.cu", "ydf_tpu/ops/binning_pallas.py:60"),
            ("histogram", "histogram.cu",
             "ydf_tpu/ops/histogram_pallas.py:81"),
            ("histogram_routed", "histogram_routed.cu",
             "ydf_tpu/ops/histogram_pallas.py:172"),
        ):
            t = measure_train(name, inp, reps=RF_ROOT_REPS
                              if name == "histogram" else 20)
            log("12 timing", f"{path} {name} ({t['shape']}): "
                f"{timing_text(t)}, {smi}")
            result.append(train_entry(name, path, src, replaces, t,
                                      counted[name], 0.0,
                                      kernel_ms.get(name, 0.0)))
            result[-1]["loop_ms_a_tree"] = (profiles[path]["loop_ms"]
                                            / profiles[path]["trees"])
            if name == "histogram_routed":
                by_lh = oblique_layers(name, case["routed"], events,
                                       routed_lh)
                result[-1].update(layer_fields(by_lh))
                log("12 layers", f"{name} on {path} by hist slots: "
                    f"{layer_text(by_lh)}, {smi}")
    lap("12h")
    log("12 oblique", f"phase 12 wall {time.perf_counter() - t_phase:.1f} s "
        f"(by part, s: {walls})")
    return result


def check_tree_hashes(exp, prefix, forest_np, T, fields):
    """Trees [0, T) of a port forest (Forest.to_numpy()) against the
    fixture's per-tree SHA-256 of `fields`, and the node counts."""
    got = [tree_sha256(forest_np, t, fields=fields) for t in range(T)]
    want = [d.tobytes().hex() for d in exp[f"{prefix}/tree_sha256"][:T]]
    bad = [t for t in range(T) if got[t] != want[t]]
    assert not bad, f"{prefix}: trees {bad[:10]} != the JAX package's"
    assert np.array_equal(forest_np["num_nodes"][:T],
                          exp[f"{prefix}/num_nodes"][:T]), prefix


def monotone_grid_check(model, base_rows, constraints, points=41):
    """Along a grid of each constrained feature over [-3, 3] (the other
    columns of `base_rows` fixed) the predictions never move against the
    constraint: the largest step against it (0 when monotone)."""
    worst = 0.0
    grid = np.linspace(-3, 3, points, dtype=np.float32)
    n = len(base_rows["label"])
    for name, d in constraints.items():
        preds = []
        for g in grid:
            rows = dict(base_rows)
            rows[name] = np.full(n, g, np.float32)
            preds.append(np.asarray(model.predict(rows), np.float64))
        steps = np.diff(np.stack(preds), axis=0) * d
        worst = max(worst, float(-steps.min()))
    return worst


def set_path(smi, serving):
    """Phase 13: monotone constraints, DART and categorical-set columns
    (ROADMAP items 14b and 14c) trained on the card through the
    learners' entry points with every other default, evaluated, saved
    and loaded, against the JAX package's runs
    (ydf_tpu_torch/testdata/train_monotone, train_dart, train_sets).
    Returns the `kernels` entries of the five paths' training kernels
    and of the set prefix histograms."""
    import tempfile

    import torch

    import ydf_tpu_torch
    from ydf_tpu_torch.learners import gbt as port_gbt
    from ydf_tpu_torch.learners import random_forest as port_rf
    from ydf_tpu_torch.models.forest import Forest
    from ydf_tpu_torch.ops import histogram_kernels, segment_sum

    t_phase = time.perf_counter()
    walls, last = {}, [t_phase]

    def lap(part):
        now = time.perf_counter()
        walls[part] = round(now - last[0], 2)
        last[0] = now

    fixtures = {}
    for name, d in (("monotone", TRAIN_MONOTONE), ("dart", TRAIN_DART),
                    ("sets", TRAIN_SETS)):
        with open(os.path.join(d, "config.json")) as f:
            cfg = json.load(f)
        fixtures[name] = (cfg, np.load(os.path.join(d, "expected.npz")))
    mcfg, mexp = fixtures["monotone"]
    dcfg, dexp = fixtures["dart"]
    scfg, sexp = fixtures["sets"]
    assert mcfg["constraints"] == MONOTONE_CONSTRAINTS
    assert (mcfg["gbt"]["rows"], mcfg["gbt"]["test_rows"]) == (
        DEFAULT_ROWS, DEFAULT_TEST_ROWS)
    assert (dcfg["gbt"]["rows"], dcfg["gbt"]["test_rows"],
            dcfg["gbt"]["learner"]) == (DART_ROWS, DART_TEST_ROWS, DART_HP)
    sg, sr, sc = scfg["gbt"], scfg["rf"], scfg["cart"]
    assert (sg["rows"], sg["test_rows"], sr["rows"], sr["test_rows"],
            sr["fixture_trees"], sc["rows"], sc["test_rows"]) == (
        SETS_GBT_ROWS, SETS_GBT_TEST_ROWS, SETS_RF_ROWS, SETS_RF_TEST_ROWS,
        SETS_RF_FIXTURE_TREES, SETS_CART_ROWS, SETS_CART_TEST_ROWS)
    assert scfg["generator"] == dict(vocabs=list(SETS_VOCABS),
                                     item_a=SETS_ITEM_A, item_b=SETS_ITEM_B)
    t0 = time.perf_counter()
    train, test = make_frame(DEFAULT_ROWS, DEFAULT_TEST_ROWS)
    dtrain, dtest = make_frame(DART_ROWS, DART_TEST_ROWS)
    strain, stest = make_set_frame(SETS_GBT_ROWS, SETS_GBT_TEST_ROWS)
    rtrain, rtest = make_set_frame(SETS_RF_ROWS, SETS_RF_TEST_ROWS)
    ctrain, ctest = make_set_frame(SETS_CART_ROWS, SETS_CART_TEST_ROWS)
    for frame, want, what in (
            (train, mcfg["gbt"]["train_sha256"], "monotone train"),
            (test, mcfg["gbt"]["test_sha256"], "monotone test"),
            (dtrain, dcfg["gbt"]["train_sha256"], "DART train"),
            (dtest, dcfg["gbt"]["test_sha256"], "DART test"),
            (strain, sg["train_sha256"], "sets GBT train"),
            (stest, sg["test_sha256"], "sets GBT test"),
            (rtrain, sr["train_sha256"], "sets RF train"),
            (rtest, sr["test_sha256"], "sets RF test"),
            (ctrain, sc["train_sha256"], "sets CART train"),
            (ctest, sc["test_sha256"], "sets CART test")):
        assert frame_sha256(frame) == want, f"{what} frame"
    log("13 sets", f"frames (monotone {DEFAULT_ROWS} + {DEFAULT_TEST_ROWS},"
        f" DART {DART_ROWS} + {DART_TEST_ROWS}, sets GBT {SETS_GBT_ROWS} + "
        f"{SETS_GBT_TEST_ROWS}, RF {SETS_RF_ROWS} + {SETS_RF_TEST_ROWS}, "
        f"CART {SETS_CART_ROWS} + {SETS_CART_TEST_ROWS}) in "
        f"{time.perf_counter() - t0:.2f} s, SHA-256 == the fixtures'; JAX "
        f"on the CPU that wrote them: monotone GBT "
        f"{mcfg['gbt']['jax_train_s_cpu']:.1f} s, DART "
        f"{dcfg['gbt']['jax_train_s_cpu']:.1f} s, sets GBT "
        f"{sg['jax_train_s_cpu']:.1f} s, RF ({sr['fixture_trees']} trees) "
        f"{sr['jax_train_s_cpu']:.1f} s, CART {sc['jax_train_s_cpu']:.1f} s")
    lap("setup")
    paths = {}  # path -> (launches, kernel ms, events, routed by Lh)

    def main_run(path, fn):
        """Counts at 0, fn() on the card, counts read: (fn's result,
        launches, wall, kernel ms, routed launches with set tables)."""
        reset_counts(serving)
        histogram_kernels.SET_TABLE_LAUNCHES = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counted, others, events = read_counts(serving)
        kernel_ms, routed_lh = split_events(events)
        set_launches = histogram_kernels.SET_TABLE_LAUNCHES
        paths[path] = (counted, kernel_ms, events, routed_lh)
        log("13 launches", f"{path}: {counted} launches, "
            f"{set_launches} of the routed ones with set tables (routed by "
            f"hist slots: {routed_lh}); serving kernels {others}")
        return result, counted, wall, kernel_ms, others, set_launches

    def gbt_run(path, hp, data, tst, cfg, exp, prefix, fields):
        learner = ydf_tpu_torch.GradientBoostedTreesLearner(device=DEVICE,
                                                            **hp)
        reads0 = port_gbt.HOST_READS

        def fn():
            m = learner.train(data)
            t0 = time.perf_counter()
            ev = m.evaluate(tst)
            torch.cuda.synchronize()
            return m, ev, time.perf_counter() - t0

        (m, ev, eval_wall), counted, wall, kernel_ms, others, sets_n = \
            main_run(path, fn)
        logs = m.training_logs
        trained, kept = logs["num_trees_trained"], logs["num_trees"]
        K = m.num_trees_per_iter
        assert (kept, trained) == (cfg["num_trees"],
                                   cfg["num_trees_trained"]), (kept, trained)
        assert counted["histogram_routed"] == \
            trained * K * (learner.max_depth - 1), counted
        # Two run sums a layer with set features (set_item_stats).
        assert counted["segment_sum"] == (
            2 * trained * K * learner.max_depth if m.binner.num_set
            else 0), counted
        pf = m.forest.to_numpy()
        check_tree_hashes(exp, prefix, pf, kept * K, fields)
        preds = m.predict(tst)
        assert array_sha256(preds) == cfg["predictions_sha256"], (
            f"{path} predictions")
        jev = cfg["jax_evaluate"]
        err = max(abs(ev.metrics[k] - jev[k]) for k in jev)
        assert err <= EVAL_SAME_ATOL, (path, err)
        boost_ms = learner.last_timings["boost_s"] * 1e3
        log("13 " + path, f"GradientBoostedTreesLearner(**{hp}).train: wall "
            f"{(wall - eval_wall) * 1e3:.1f} ms (host clock, ends in "
            "synchronize); stages " + " ".join(
                f"{k}={v * 1e3:.1f}ms"
                for k, v in learner.last_timings.items())
            + f"; {trained} iterations trained, {kept} kept (== JAX's), "
            f"{port_gbt.HOST_READS - reads0} host reads; "
            f"{boost_ms / (trained * K):.2f} ms a tree (loop wall / trees); "
            "kernel time (CUDA events, train + evaluate) " + " ".join(
                f"{k}={v:.3f}ms" for k, v in kernel_ms.items())
            + f"; every kept tree by SHA-256 == JAX's, the {len(preds)} "
            f"predictions bitwise (SHA-256), evaluate within "
            f"{EVAL_SAME_ATOL} (max {err:.3g}); evaluate "
            f"{eval_wall * 1e3:.1f} ms; {smi}")
        return learner, m, preds, trained * K, sets_n, others

    # -- 13a monotone constraints -------------------------------------- #
    mono_hp = dict(DEFAULT_HP, monotonic_constraints=MONOTONE_CONSTRAINTS)
    mlearner, mmodel, mpreds, mtrees, _, others = gbt_run(
        "train_monotone", mono_hp, train, test, mcfg["gbt"], mexp, "gbt",
        TREE_HASH_FIELDS)
    assert sum(others.values()) > 0, others  # served by a kernel
    with tempfile.TemporaryDirectory() as tmp:
        mmodel.save(os.path.join(tmp, "m"))
        back = ydf_tpu_torch.load_model(os.path.join(tmp, "m"),
                                        device=DEVICE)
    assert back.predict(test).tobytes() == mpreds.tobytes()
    base = {k: v[:64] for k, v in test.items()}
    worst = monotone_grid_check(back, base, MONOTONE_CONSTRAINTS)
    assert worst == 0.0, worst
    for run in ("three_class", "oblique"):
        c = mcfg[run]
        kind = "three_class" if run == "three_class" else "binary"
        otrain, otest = options_frame(kind, DEFAULT_CAT_SEED, c["rows"],
                                      c["test_rows"])
        m = ydf_tpu_torch.GradientBoostedTreesLearner(
            device=DEVICE, monotonic_constraints=MONOTONE_CONSTRAINTS,
            **c["learner"]).train(otrain)
        K = m.num_trees_per_iter
        assert m.training_logs["num_trees"] == c["num_trees"], run
        check_tree_hashes(mexp, run, m.forest.to_numpy(),
                          c["num_trees"] * K, TREE_HASH_FIELDS)
        assert array_sha256(m.predict(otest)) == c["predictions_sha256"], run
    log("13 monotone", "save -> load on the card bitwise; the loaded model "
        f"monotone along a 41-point grid of each of "
        f"{sorted(MONOTONE_CONSTRAINTS)} on 64 test rows (largest step "
        f"against a constraint {worst}); the 3-class and SPARSE_OBLIQUE "
        f"monotone runs at {mcfg['oblique']['rows']} rows: every kept tree "
        "(clamped leaves) by "
        "SHA-256 and the predictions bitwise == JAX's")
    lap("13a")

    # -- 13b DART ------------------------------------------------------ #
    dlearner, dmodel, _, dtrees, _, _ = gbt_run(
        "train_dart", DART_HP, dtrain, dtest, dcfg["gbt"], dexp, "gbt",
        TREE_HASH_FIELDS)
    T = dlearner.num_trees
    carry_mb = 4 * T * DART_ROWS / 2 ** 20
    log("13 dart", f"the DART carry (each of the {T} iterations' "
        f"contributions at the {DART_ROWS} training and validation rows, "
        f"f32) {carry_mb:.1f} MiB on the card")
    lap("13b")

    # -- 13c the GBT on set columns ------------------------------------ #
    fields = SET_TREE_HASH_FIELDS
    slearner, smodel, spreds, strees, sets_n, others = gbt_run(
        "train_sets_gbt", DEFAULT_HP, strain, stest, sg, sexp, "gbt", fields)
    assert not any(others.values()), others  # set models serve routed
    assert sets_n >= 1 and sets_n == strees * (slearner.max_depth - 1), (
        sets_n, strees)
    assert paths["train_sets_gbt"][0]["histogram"] == strees * (
        1 + 2 * 2 * slearner.max_depth), paths["train_sets_gbt"][0]
    assert smodel.list_compatible_engines() == ["Routed"]
    with tempfile.TemporaryDirectory() as tmp:
        smodel.save(os.path.join(tmp, "s"))
        sback = ydf_tpu_torch.load_model(os.path.join(tmp, "s"),
                                         device=DEVICE)
    assert sback.predict(stest).tobytes() == spreds.tobytes()
    log("13 sets gbt", f"{sets_n} routed launches with set tables (every "
        "layer below the root); save -> load -> predict on the card "
        "bitwise; the set model serves on the routed engine")
    lap("13c")

    # -- 13d the random forest on set columns: SETS_RF_TREES trees ----- #
    rlearner = ydf_tpu_torch.RandomForestLearner(
        device=DEVICE, **dict(RF_HP, num_trees=SETS_RF_TREES))

    def rf_main():
        m = rlearner.train(rtrain)
        t0 = time.perf_counter()
        ev = m.evaluate(rtest)
        torch.cuda.synchronize()
        return m, ev, time.perf_counter() - t0

    (rmodel, rev, reval_wall), counted, wall, kernel_ms, _, rsets = \
        main_run("train_sets_rf", rf_main)
    T = rmodel.forest.num_trees
    # A tree's root histogram, then each layer's two prefix histograms
    # per set feature (F = 1, Tc bins).
    Fs = rmodel.binner.num_set
    assert counted["histogram"] == T * (1 + 2 * Fs * rlearner.max_depth), (
        counted, Fs)
    assert rsets == counted["histogram_routed"] > 0, (counted, rsets)
    assert counted["segment_sum"] == 2 * T * rlearner.max_depth, counted
    K = sr["fixture_trees"]
    rf_np = rmodel.forest.to_numpy()
    check_tree_hashes(sexp, "rf", rf_np, K, fields)
    sub = port_rf.RandomForestModel(
        task=rmodel.task, label=rmodel.label, classes=rmodel.classes,
        dataspec=rmodel.dataspec, binner=rmodel.binner,
        forest=Forest(*(a[:K] for a in rmodel.forest)),
        max_depth=rmodel.max_depth)
    rhead = {k: v[:scfg["compare_rows"]] for k, v in rtest.items()}
    assert sub.predict(rhead).tobytes() == sexp["rf/proba"].tobytes()
    sev = sub.evaluate(rtest)
    jev = sr["jax_evaluate"]
    rf_err = max(abs(sev.metrics[k] - jev[k]) for k in jev)
    assert rf_err <= EVAL_SAME_ATOL, rf_err
    loop_ms = rlearner.last_timings["loop_s"] * 1e3
    log("13 sets rf", f"RandomForestLearner(**{RF_HP}, num_trees="
        f"{SETS_RF_TREES}).train: wall "
        f"{(wall - reval_wall) * 1e3:.1f} ms; stages " + " ".join(
            f"{k}={v * 1e3:.1f}ms" for k, v in rlearner.last_timings.items())
        + f"; {T} trees, {loop_ms / T:.2f} ms a tree; kernel time (CUDA "
        "events) " + " ".join(f"{k}={v:.3f}ms" for k, v in kernel_ms.items())
        + f"; the first {K} trees == JAX's by SHA-256, their probabilities "
        f"bitwise, evaluate within {EVAL_SAME_ATOL} (max {rf_err:.3g}); the "
        f"{T}-tree forest: " + " ".join(
            f"{k} {rev.metrics[k]:.6f}" for k in jev) + f"; {smi}")
    lap("13d")

    # -- 13e CART on set columns --------------------------------------- #
    clearner = ydf_tpu_torch.CartLearner(device=DEVICE, **CART_HP)

    def cart_main():
        m, grown = cart_train(clearner, ctrain)
        t0 = time.perf_counter()
        ev = m.evaluate(ctest)
        torch.cuda.synchronize()
        return m, grown, ev, time.perf_counter() - t0

    (cmodel, grown, cev, ceval_wall), counted, wall, kernel_ms, _, csets = \
        main_run("train_sets_cart", cart_main)
    assert counted["histogram"] == 1 + 2 * 2 * clearner.max_depth, counted
    assert csets == counted["histogram_routed"] > 0, (counted, csets)
    assert counted["segment_sum"] == 2 * clearner.max_depth, counted
    assert tree_sha256(grown, 0, fields=fields) == sc["grown_sha256"]
    cf = cmodel.forest.to_numpy()
    assert tree_sha256(cf, 0, fields=fields) == sc["pruned_sha256"]
    pruned = cmodel.extra_metadata["num_pruned_nodes"]
    assert pruned == sc["num_pruned_nodes"], pruned
    jo, po = sc["oob_evaluation"], cmodel.self_evaluation()
    jev = sc["jax_evaluate"]
    cart_err = max([abs(po["metrics"][k] - jo["metrics"][k])
                    for k in jo["metrics"]]
                   + [abs(cev.metrics[k] - jev[k]) for k in jev])
    assert cart_err <= EVAL_SAME_ATOL, cart_err
    chead = {k: v[:scfg["compare_rows"]] for k, v in ctest.items()}
    assert cmodel.predict(chead).tobytes() == sexp["cart/proba"].tobytes()
    log("13 sets cart", f"CartLearner(**{CART_HP}).train: wall "
        f"{(wall - ceval_wall) * 1e3:.1f} ms; stages " + " ".join(
            f"{k}={v * 1e3:.1f}ms" for k, v in clearner.last_timings.items())
        + "; kernel time (CUDA events) " + " ".join(
            f"{k}={v:.3f}ms" for k, v in kernel_ms.items())
        + f"; grown ({sc['grown_num_nodes']} nodes) and pruned ({pruned} "
        "pruned) trees == JAX's by SHA-256; holdout evaluation and "
        f"evaluate within {EVAL_SAME_ATOL} (max {cart_err:.3g}); "
        f"probabilities bitwise; {smi}")
    lap("13e")

    # -- 13f the kernels against their plain versions ------------------ #
    layers = {
        "train_monotone": captured_layers(
            ydf_tpu_torch.GradientBoostedTreesLearner, mono_hp, train),
        "train_dart": captured_layers(
            ydf_tpu_torch.GradientBoostedTreesLearner, DART_HP, dtrain),
        "train_sets_gbt": captured_layers(
            ydf_tpu_torch.GradientBoostedTreesLearner, DEFAULT_HP, strain),
        "train_sets_rf": captured_layers(
            ydf_tpu_torch.RandomForestLearner, RF_HP, rtrain),
        "train_sets_cart": captured_layers(
            ydf_tpu_torch.CartLearner, CART_HP, ctrain),
    }
    binned = {"train_monotone": (mmodel.binner, train),
              "train_dart": (dmodel.binner, dtrain),
              "train_sets_gbt": (smodel.binner, strain),
              "train_sets_rf": (rmodel.binner, rtrain),
              "train_sets_cart": (cmodel.binner, ctrain)}
    prefix_calls = []
    for path, case in layers.items():
        # The binner's one call (it holds the function under its own
        # name, so the capture does not see it): its arguments again.
        binner, data = binned[path]
        Fn = binner.num_numerical
        case["binning"].append(tuple(torch.from_numpy(a).to(DEVICE) for a in (
            np.stack([data[k] for k in binner.feature_names[:Fn]]),
            binner.boundaries[:Fn], binner.feature_num_bins[:Fn] - 1,
            binner.impute_values[:Fn])))
        binning_check(case["binning"][-1])
        with_sets = 0
        for args in case["routed"]:
            got = histogram_kernels.histogram_routed(*args)
            want = histogram_kernels.histogram_routed_plain(*args)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                assert torch.equal(g, w), (
                    f"{path}: routed kernel != plain at Lh {args[5]}")
            with_sets += bool(args[3].is_set.any())
        for args in case["root"]:
            got = histogram_kernels.histogram(*args)
            want = histogram_kernels.histogram_plain(*args)
            torch.cuda.synchronize()
            assert torch.equal(got, want), f"{path}: histogram != plain"
            if args[0].shape[0] == 1 and path.startswith("train_sets"):
                prefix_calls.append((path, args))
        for args in case["segment"]:
            got = segment_sum.segment_sums(*args)
            torch.cuda.synchronize()
            assert torch.equal(got, segment_sum.segment_sums_plain(*args)), (
                f"{path}: segment sums != plain")
        if path.startswith("train_sets"):
            assert with_sets >= 1, f"{path}: no routed launch with is_set"
            assert case["segment"], f"{path}: no run sums captured"
        log("13 kernels", f"{path}: the binning of the training values, "
            f"{len(case['root'])} histogram calls (the root and, with "
            "sets, the set prefix histograms at F = 1), "
            f"{len(case['routed'])} routed calls ({with_sets} with an "
            f"is_set row true) and {len(case['segment'])} run sums of a "
            "one-tree train torch.equal to plain")
    assert prefix_calls, "no set prefix histogram captured"
    # The run-sum kernel at the shapes a tiled kernel gets wrong.
    t_edge, edges = time.perf_counter(), 0
    for S in SEGMENT_EDGE_STATS:
        T = segment_sum.tile_entries(S)
        for shape in SEGMENT_EDGE_SHAPES:
            key, vals = (torch.from_numpy(a).to(DEVICE)
                         for a in segment_edge_case(shape, S, T))
            got = segment_sum.segment_sums(key, vals)
            torch.cuda.synchronize()
            assert same_bits(got, segment_sum.segment_sums_plain(key, vals)), (
                f"segment sums != plain at {shape}, S={S}, tile {T}")
            edges += 1
    log("13 kernels", f"segment_sum: {edges} edge shapes "
        f"({', '.join(SEGMENT_EDGE_SHAPES)} at S = "
        f"{', '.join(map(str, SEGMENT_EDGE_STATS))}) bitwise to plain (a "
        f"NaN as any NaN) in {time.perf_counter() - t_edge:.2f} s")
    lap("13f")

    # -- 13g where each loop's time goes ------------------------------- #
    profiles = {}
    for path, cls, hp, data, loop, trees in (
            ("train_monotone", ydf_tpu_torch.GradientBoostedTreesLearner,
             mono_hp, train, "boost_s", 3),
            ("train_dart", ydf_tpu_torch.GradientBoostedTreesLearner,
             DART_HP, dtrain, "boost_s", 3),
            ("train_sets_gbt", ydf_tpu_torch.GradientBoostedTreesLearner,
             DEFAULT_HP, strain, "boost_s", 3),
            ("train_sets_rf", ydf_tpu_torch.RandomForestLearner, RF_HP,
             rtrain, "loop_s", 3),
            ("train_sets_cart", ydf_tpu_torch.CartLearner, CART_HP, ctrain,
             "loop_s", 1)):
        hp = dict(hp, num_trees=trees) if cls is not \
            ydf_tpu_torch.CartLearner else hp
        prof = profiles[path] = dict(profile_train(data, hp, cls, loop),
                                     trees=trees)
        log("13 profile", f"{path}: num_trees={trees} under torch.profiler: "
            f"wall {prof['wall_ms']:.1f} ms, tree loop "
            f"{prof['loop_ms']:.1f} ms ({prof['loop_ms'] / trees:.2f} ms a "
            f"tree); {prof['kernels']} device kernels "
            f"({prof['kernels'] / trees:.0f} a tree), device idle at least "
            f"{100 * prof['idle_share']:.1f}% of the loop; largest: "
            + "; ".join(f"{name[:50]} {ms:.3f} ms"
                        for name, ms in prof["top"][:4]))
    lap("13g")

    # -- 13h each kernel timed at each path's shapes ------------------- #
    result = []
    for path, case in layers.items():
        counted, kernel_ms, events, routed_lh = paths[path]
        inp = {"binning": max(case["binning"],
                              key=lambda a: a[0].shape[1]),
               "root": case["root"][0],
               "routed": max(case["routed"], key=lambda a: a[5])}
        for name, src, replaces in (
            ("binning", "binning.cu", "ydf_tpu/ops/binning_pallas.py:60"),
            ("histogram", "histogram.cu",
             "ydf_tpu/ops/histogram_pallas.py:81"),
            ("histogram_routed", "histogram_routed.cu",
             "ydf_tpu/ops/histogram_pallas.py:172"),
        ):
            t = measure_train(name, inp, reps=20)
            log("13 timing", f"{path} {name} ({t['shape']}): "
                f"{timing_text(t)}, {smi}")
            result.append(train_entry(name, path, src, replaces, t,
                                      counted[name], 0.0,
                                      kernel_ms.get(name, 0.0)))
            result[-1]["loop_ms_a_tree"] = (profiles[path]["loop_ms"]
                                            / profiles[path]["trees"])
            result[-1]["idle_share"] = profiles[path]["idle_share"]
            if name == "histogram_routed":
                by_lh = oblique_layers(name, case["routed"], events,
                                       routed_lh)
                result[-1].update(layer_fields(by_lh))
                log("13 layers", f"{name} on {path} by hist slots: "
                    f"{layer_text(by_lh)}, {smi}")
    for path, case in layers.items():
        if not case["segment"]:
            continue
        counted, kernel_ms = paths[path][:2]
        inp = {"segment": max(case["segment"], key=lambda a: a[0].shape[0])}
        t = measure_train("segment_sum", inp, reps=20)
        log("13 timing", f"{path} segment_sum ({t['shape']}): "
            f"{timing_text(t)}, {smi}")
        result.append(train_entry(
            "segment_sum", path, "segment_sum.cu",
            "ydf_tpu/ops/grower.py:810 (an XLA einsum; no Pallas kernel)",
            t, counted["segment_sum"], 0.0, kernel_ms.get("segment_sum",
                                                          0.0)))
        result[-1].update(runs=t["runs"], longest_run=t["longest_run"])
        result[-1]["loop_ms_a_tree"] = (profiles[path]["loop_ms"]
                                        / profiles[path]["trees"])
        result[-1]["idle_share"] = profiles[path]["idle_share"]
    path, args = max(prefix_calls, key=lambda pa: pa[1][0].shape[1])
    t = measure_train("histogram", {"root": args}, reps=20)
    log("13 timing", f"{path} set prefix histogram ({t['shape']}): "
        f"{timing_text(t)}, {smi}")
    result.append(train_entry("histogram", f"{path}/set_prefix",
                              "histogram.cu",
                              "ydf_tpu/ops/histogram_pallas.py:81", t,
                              paths[path][0]["histogram"], 0.0,
                              paths[path][1].get("histogram", 0.0)))
    lap("13h")
    log("13 sets", f"phase 13 wall {time.perf_counter() - t_phase:.1f} s "
        f"(by part, s: {walls})")
    return result


def plain_ops_profile(fn, reps=3):
    """A plain PyTorch step on the card (the ranking and survival
    losses, which run no kernel of the port's own): per call, its
    device kernels and their device time under torch.profiler, and its
    time between CUDA events, after one warm call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels, busy = 0, 0.0
    for e in prof.profiler.kineto_results.events():
        if str(e.device_type()).endswith("CUDA") and e.duration_ns() > 0:
            kernels += 1
            busy += e.duration_ns() / 1e6
    return {"kernels": kernels / reps, "device_ms": busy / reps,
            "ms": time_ms(fn, reps)}


def rank_surv_path(smi, serving):
    """Phase 14: the RANKING and SURVIVAL_ANALYSIS tasks (ROADMAP items
    11, 12 and 15's tasks) trained on the card through the GBT learner's
    entry point with every other default (LambdaMART-NDCG on a frame
    shaped like MSLR, F = 136; Cox on make_frame's 32 columns), evaluated
    (NDCG@5, MRR, MAP@5; concordance), saved and loaded, the JAX-saved
    models served on the card, and the rank-options runs (XE-NDCG, SELGB,
    truncated groups, Cox with entry ages, with weights), against the
    JAX package's runs (ydf_tpu_torch/testdata/train_ranking,
    train_survival, train_rank_options). Returns the `kernels` entries of
    the two paths' training kernels and of the bank on their models."""
    import tempfile
    import warnings

    import torch

    import ydf_tpu_torch
    from ydf_tpu_torch.config import Task
    from ydf_tpu_torch.learners import gbt as port_gbt
    from ydf_tpu_torch.learners import ranking_loss, survival_loss
    from ydf_tpu_torch.ops import histogram_kernels
    from ydf_tpu_torch.serving import bank_scorer

    t_phase = time.perf_counter()
    walls, last = {}, [t_phase]

    def lap(part):
        now = time.perf_counter()
        walls[part] = round(now - last[0], 2)
        last[0] = now

    fixtures = {}
    for name, d in (("ranking", TRAIN_RANKING), ("survival", TRAIN_SURVIVAL),
                    ("options", TRAIN_RANK_OPTIONS)):
        with open(os.path.join(d, "config.json")) as f:
            cfg = json.load(f)
        fixtures[name] = (cfg, np.load(os.path.join(d, "expected.npz")))
    rcfg, rexp = fixtures["ranking"]
    scfg, sexp = fixtures["survival"]
    ocfg, oexp = fixtures["options"]
    assert (rcfg["queries"], rcfg["test_queries"], tuple(rcfg["docs"]),
            rcfg["features"], rcfg["seed"], rcfg["test_seed"]) == (
        RANK_QUERIES, RANK_TEST_QUERIES, RANK_DOCS, RANK_FEATURES,
        RANK_SEED, RANK_TEST_SEED)
    assert (scfg["rows"], scfg["test_rows"], scfg["cat_seed"]) == (
        SURV_ROWS, SURV_TEST_ROWS, DEFAULT_CAT_SEED)
    rank_hp = dict(RANK_HP, task=Task[RANK_HP["task"]])
    surv_hp = dict(SURV_HP, task=Task[SURV_HP["task"]])
    t0 = time.perf_counter()
    rtrain, rtest = rank_frames(RANK_QUERIES, test_queries=RANK_TEST_QUERIES)
    strain, stest = make_surv_frame(SURV_ROWS, SURV_TEST_ROWS)
    for frame, want, what in (
            (rtrain, rcfg["train_sha256"], "ranking train"),
            (rtest, rcfg["test_sha256"], "ranking test"),
            (strain, scfg["train_sha256"], "survival train"),
            (stest, scfg["test_sha256"], "survival test")):
        assert frame_sha256(frame) == want, f"{what} frame"
    log("14 rank_surv", f"frames (ranking {len(rtrain['query'])} rows in "
        f"{RANK_QUERIES} queries x {RANK_FEATURES} features + "
        f"{len(rtest['query'])} rows in {RANK_TEST_QUERIES} test queries, "
        f"survival {SURV_ROWS} + {SURV_TEST_ROWS}, "
        f"{100 * (1 - strain['event'].mean()):.1f}% censored) in "
        f"{time.perf_counter() - t0:.2f} s, SHA-256 == the fixtures'; JAX "
        f"on the CPU that wrote them: ranking "
        f"{rcfg['jax_train_s_cpu']:.1f} s, survival "
        f"{scfg['jax_train_s_cpu']:.1f} s")
    lap("setup")
    paths = {}  # path -> (launches, kernel ms, events, routed by Lh)

    def main_run(path, fn):
        """Counts at 0, fn() on the card, counts read."""
        reset_counts(serving)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counted, others, events = read_counts(serving)
        kernel_ms, routed_lh = split_events(events)
        paths[path] = (counted, kernel_ms, events, routed_lh, others)
        log("14 launches", f"{path}: {counted} launches (routed by hist "
            f"slots: {routed_lh}); serving kernels {others}")
        return result, counted, wall, kernel_ms, others

    def task_run(path, hp, data, tst, cfg, exp, prefix):
        """One training through the learner's entry point, its
        evaluation, and every check against the fixture."""
        learner = ydf_tpu_torch.GradientBoostedTreesLearner(device=DEVICE,
                                                            **hp)
        reads0 = port_gbt.HOST_READS

        def fn():
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                m = learner.train(data)
            t0 = time.perf_counter()
            ev = m.evaluate(tst)
            torch.cuda.synchronize()
            return m, ev, time.perf_counter() - t0, caught

        (m, ev, eval_wall, caught), counted, wall, kernel_ms, others = \
            main_run(path, fn)
        logs = m.training_logs
        trained, kept = logs["num_trees_trained"], logs["num_trees"]
        assert (kept, trained) == (cfg["num_trees"],
                                   cfg["num_trees_trained"]), (kept, trained)
        assert counted["histogram_routed"] == \
            trained * (learner.max_depth - 1), counted
        assert counted["histogram"] == trained, counted
        assert counted["binning"] >= 1, counted
        assert sum(others.values()) > 0, others  # served by a kernel
        check_tree_hashes(exp, prefix, canonical_nan(m.forest.to_numpy()),
                          kept, TREE_HASH_FIELDS)
        for key in ("train_loss", "valid_loss"):
            got = np.float32([r[key] for r in logs["iterations"]])
            assert same_bits(got, exp[f"{prefix}/{key}"]), f"{path} {key}"
        preds = m.predict(tst)
        assert same_bits(preds[:len(exp[f"{prefix}/predictions"])],
                         exp[f"{prefix}/predictions"]), f"{path} predictions"
        if "predictions_sha256" in cfg and not np.isnan(preds).any():
            assert array_sha256(preds) == cfg["predictions_sha256"], path
        jev = cfg["jax_evaluate"]
        err = max(abs(ev.metrics[k] - jev[k]) for k in jev)
        assert err <= EVAL_SAME_ATOL, (path, err)
        assert m.extra_metadata == cfg["extra_metadata"], path
        warned = [str(w.message) for w in caught
                  if "max_group_size" in str(w.message)]
        assert warned == cfg.get("warnings", []), (path, warned)
        boost_ms = learner.last_timings["boost_s"] * 1e3
        log("14 " + path, f"GradientBoostedTreesLearner(**{hp}).train: "
            f"wall {(wall - eval_wall) * 1e3:.1f} ms (host clock, ends in "
            "synchronize); stages " + " ".join(
                f"{k}={v * 1e3:.1f}ms"
                for k, v in learner.last_timings.items())
            + f"; {trained} iterations trained, {kept} kept (== JAX's), "
            f"{port_gbt.HOST_READS - reads0} host reads (one a chunk of the "
            f"look-ahead stop; the loop runs under sync debug mode "
            f"\"error\"); {boost_ms / trained:.2f} ms a tree (loop wall / "
            "trees); kernel time (CUDA events, train + evaluate) " + " ".join(
                f"{k}={v:.3f}ms" for k, v in kernel_ms.items())
            + f"; every kept tree by SHA-256, the {trained} train and "
            "validation losses bitwise == JAX's, the predictions bitwise "
            f"(a NaN as any NaN), evaluate " + " ".join(
                f"{k} {ev.metrics[k]:.12f}" for k in jev)
            + f" within {EVAL_SAME_ATOL} of JAX's (max {err:.3g}); "
            f"evaluate {eval_wall * 1e3:.1f} ms; {smi}")
        return m

    def jax_model_check(path, d, model, tst, cfg, exp):
        """save -> load on the card bitwise; the JAX-saved model served
        on the card: its raw scores and predictions bitwise to JAX's,
        its evaluation equal."""
        with tempfile.TemporaryDirectory() as tmp:
            model.save(os.path.join(tmp, "m"))
            back = ydf_tpu_torch.load_model(os.path.join(tmp, "m"),
                                            device=DEVICE)
        assert back.predict(tst).tobytes() == model.predict(tst).tobytes()
        assert back.extra_metadata == model.extra_metadata
        jm = ydf_tpu_torch.load_model(os.path.join(d, "model"),
                                      device=DEVICE)
        head = {k: v[:len(exp["gbt/raw"])] for k, v in tst.items()}
        raw = jm._raw_scores(head, combine="sum")[:, 0]
        assert raw.tobytes() == exp["gbt/raw"].tobytes(), path
        assert array_sha256(jm.predict(tst)) == cfg["predictions_sha256"]
        jev = jm.evaluate(tst).metrics
        err = max(abs(jev[k] - cfg["jax_evaluate"][k]) for k in jev)
        assert err <= EVAL_SAME_ATOL, (path, err)
        log("14 " + path, "save -> load on the card: predictions and "
            "extra_metadata equal; the JAX-saved model on the card: raw "
            f"scores on {len(raw)} rows bitwise, all {len(tst[model.label])} "
            f"predictions by SHA-256, evaluate within {EVAL_SAME_ATOL}")

    # -- 14a ranking ---------------------------------------------------- #
    rmodel = task_run(
        "train_ranking", rank_hp, rtrain, rtest, rcfg, rexp, "gbt")
    jax_model_check("train_ranking", TRAIN_RANKING, rmodel, rtest, rcfg,
                    rexp)
    lap("14a")

    # -- 14b survival --------------------------------------------------- #
    smodel = task_run(
        "train_survival", surv_hp, strain, stest, scfg, sexp, "gbt")
    jax_model_check("train_survival", TRAIN_SURVIVAL, smodel, stest, scfg,
                    sexp)
    lap("14b")

    # -- 14c the rank-options runs -------------------------------------- #
    for name, c in ocfg["configs"].items():
        if c["frame"] == "rank":
            otrain, otest = rank_frames(c["queries"], tuple(c["docs"]), 24)
            task = Task.RANKING
        else:
            otrain, otest = make_surv_frame(
                c["rows"], ocfg["compare_rows"], entry=c.get("entry", False),
                weights=c.get("weights", False))
            task = Task.SURVIVAL_ANALYSIS
        assert frame_sha256(otrain) == c["train_sha256"], name
        assert frame_sha256(otest) == c["test_sha256"], name
        task_run(f"rank_options/{name}", dict(c["learner"], task=task),
                 otrain, otest, c, oexp, name)
    lap("14c")

    # -- 14d the kernels against their plain versions, at F = 136 ------- #
    layers = {
        "train_ranking": captured_layers(
            ydf_tpu_torch.GradientBoostedTreesLearner, rank_hp, rtrain),
        "train_survival": captured_layers(
            ydf_tpu_torch.GradientBoostedTreesLearner, surv_hp, strain),
    }
    binned = {"train_ranking": (rmodel.binner, rtrain),
              "train_survival": (smodel.binner, strain)}
    for path, case in layers.items():
        binner, data = binned[path]
        Fn = binner.num_numerical
        case["binning"].append(tuple(torch.from_numpy(a).to(DEVICE) for a in (
            np.stack([data[k] for k in binner.feature_names[:Fn]]),
            binner.boundaries[:Fn], binner.feature_num_bins[:Fn] - 1,
            binner.impute_values[:Fn])))
        binning_check(case["binning"][-1])
        shapes = []
        for args in case["routed"]:
            got = histogram_kernels.histogram_routed(*args)
            want = histogram_kernels.histogram_routed_plain(*args)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                assert torch.equal(g, w), (
                    f"{path}: routed kernel != plain at Lh {args[5]}")
            bins_t, _, _, tables, stats, Lh, B = args
            shape = histogram_kernels.routed_launch_shape(
                bins_t.shape[1], bins_t.shape[0], Lh, B, stats.shape[1],
                tables.do_split.shape[0] - 1,
                4 if stats.dtype == torch.int8 else 8)
            assert shape.smem <= histogram_kernels.ROUTED_SMEM_LIMIT
            shapes.append(f"Lh={Lh}: G {shape.G} x Fb {shape.Fb}, Lb "
                          f"{shape.Lb}, {shape.blocks} blocks of "
                          f"{shape.rows} rows, {shape.smem} B shared")
        for args in case["root"]:
            got = histogram_kernels.histogram(*args)
            want = histogram_kernels.histogram_plain(*args)
            torch.cuda.synchronize()
            assert torch.equal(got, want), f"{path}: histogram != plain"
        log("14 kernels", f"{path} at F = {binner.num_features}: the binning "
            f"of the {data[binner.feature_names[0]].shape[0]} training "
            f"values, {len(case['root'])} root histograms ("
            f"{root_shape_text(case['root'][0])}) and "
            f"{len(case['routed'])} routed layers of a one-tree train "
            "torch.equal to plain; routed launch shapes " + "; ".join(shapes))
    bank_inputs_of = {}
    for path, model, tst in (("train_ranking", rmodel, rtest),
                             ("train_survival", smodel, stest)):
        bank = bank_scorer.build_bank_scorer(model)
        assert bank is not None, path
        xT = encoded_xT(model, tst)
        got = bank_scorer.score(bank.tables, xT)
        want = bank_scorer.score_plain(bank.tables, xT)
        for walk, g in zip(("split", "per-thread"), both_walks(
                lambda: bank_scorer.score(bank.tables, xT))):
            assert torch.equal(g, want), f"{path} bank {walk} != plain"
        assert torch.equal(got, want), f"{path} bank != plain"
        bank_inputs_of[path] = (bank, xT)
        log("14 kernels", f"bank_scorer on the {path} model "
            f"({model.forest.num_trees} trees): {xT.shape[1]} rows x "
            f"{xT.shape[0]} features torch.equal to plain in both walks")
    lap("14d")

    # -- 14e where the loops' time goes; the losses' own device work ---- #
    profiles = {}
    for path, hp, data in (("train_ranking", rank_hp, rtrain),
                           ("train_survival", surv_hp, strain)):
        trees = 5
        prof = profiles[path] = dict(profile_train(
            data, dict(hp, num_trees=trees)), trees=trees)
        log("14 profile", f"{path}: num_trees={trees} under torch.profiler: "
            f"wall {prof['wall_ms']:.1f} ms, tree loop "
            f"{prof['loop_ms']:.1f} ms ({prof['loop_ms'] / trees:.2f} ms a "
            f"tree); {prof['kernels']} device kernels "
            f"({prof['kernels'] / trees:.0f} a tree), device idle at least "
            f"{100 * prof['idle_share']:.1f}% of the loop; largest: "
            + "; ".join(f"{name[:50]} {ms:.3f} ms"
                        for name, ms in prof["top"][:4]))
    # The losses at the paths' shapes: the training rows after the split.
    groups = rtrain["query"]
    tr_idx, _ = port_gbt.split_validation_groups(groups, 0.1, 123456)
    rows, G = ranking_loss.build_group_rows(groups[tr_idx])
    n = len(tr_idx)
    y = torch.from_numpy(rtrain["relevance"][tr_idx].astype(np.float32)).to(
        DEVICE)
    p = torch.from_numpy(np.random.default_rng(3).normal(
        size=n).astype(np.float32)).to(DEVICE)
    lam = ranking_loss.LambdaMartNdcg()
    lam.register_groups("train", n, rows, DEVICE)
    rows_t = torch.from_numpy(np.where(rows < 0, n, rows)).to(DEVICE)
    str_idx, _ = port_gbt.split_validation(SURV_ROWS, 0.1, 123456)
    cox = survival_loss.CoxProportionalHazardLoss()
    cox.register_survival("train", strain["time"][str_idx],
                          strain["event"][str_idx], device=DEVICE)
    sy = torch.from_numpy(strain["time"][str_idx]).to(DEVICE)
    sp = torch.from_numpy(np.random.default_rng(4).normal(
        0, 0.3, len(str_idx)).astype(np.float32)).to(DEVICE)
    steps = {
        "train_ranking lambdas (grad_hess)": lambda: lam.grad_hess(y, p),
        "train_ranking -NDCG (loss)": lambda: lam.loss(y, p, None),
        "train_ranking SELGB mask": lambda: port_gbt.selgb_mask(
            rows_t, y, p, 0.01),
        "train_survival Cox sweep (grad_hess)": lambda: cox.grad_hess(sy, sp),
        "train_survival Cox loss": lambda: cox.loss(sy, sp, None),
    }
    loss_steps = {}
    for what, fn in steps.items():
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(prev)
        st = loss_steps[what] = plain_ops_profile(fn)
        log("14 losses", f"{what} at {n if 'rank' in what else len(str_idx)}"
            f" rows{f' ({rows.shape[0]} groups, G = {G})' if 'rank' in what else ''}: "
            f"{st['kernels']:.0f} device kernels a call, "
            f"{st['device_ms']:.3f} ms on the card (torch.profiler), "
            f"{st['ms']:.3f} ms a call (CUDA events); plain PyTorch, no "
            f"kernel of the port's own (the JAX package computes it in XLA, "
            f"no Pallas kernel); no host sync; {smi}")
    lap("14e")

    # -- 14f each kernel timed at each path's shapes -------------------- #
    result = []
    for path, case in layers.items():
        counted, kernel_ms, events, routed_lh, others = paths[path]
        inp = {"binning": case["binning"][-1], "root": case["root"][0],
               "routed": max(case["routed"], key=lambda a: a[5])}
        for name, src, replaces in (
            ("binning", "binning.cu", "ydf_tpu/ops/binning_pallas.py:60"),
            ("histogram", "histogram.cu",
             "ydf_tpu/ops/histogram_pallas.py:81"),
            ("histogram_routed", "histogram_routed.cu",
             "ydf_tpu/ops/histogram_pallas.py:172"),
        ):
            t = measure_train(name, inp, reps=20)
            log("14 timing", f"{path} {name} ({t['shape']}): "
                f"{timing_text(t)}, {smi}")
            result.append(train_entry(name, path, src, replaces, t,
                                      counted[name], 0.0,
                                      kernel_ms.get(name, 0.0)))
            result[-1]["loop_ms_a_tree"] = (profiles[path]["loop_ms"]
                                            / profiles[path]["trees"])
            result[-1]["idle_share"] = profiles[path]["idle_share"]
            if name == "histogram_routed":
                by_lh = oblique_layers(name, case["routed"], events,
                                       routed_lh)
                result[-1].update(layer_fields(by_lh))
                log("14 layers", f"{name} on {path} by hist slots: "
                    f"{layer_text(by_lh)}, {smi}")
        bank, xT = bank_inputs_of[path]
        t = measure(bank_scorer, bank.tables, bank.tables, xT)
        log("14 timing", f"bank_scorer/{path} at {xT.shape[1]} rows x "
            f"{xT.shape[0]} features: kernel {t['ms']:.4f} ms a call back "
            f"to back, {t['device_ms']:.4f} ms on the card "
            f"({t['device_how']}), plain {t['plain_ms']:.2f} ms, bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}; {t['detail']}), {smi}")
        result.append({
            "name": f"bank_scorer/{path}", "route": "cuda",
            "source": "ydf_tpu_torch/csrc/bank_scorer.cu",
            "replaces": "ydf_tpu/serving/pallas_scorer.py:118",
            "launches": others[bank_scorer.__name__],
            "max_abs_err": t["max_abs_err"],
            "ms": t["ms"], "device_ms": t["device_ms"],
            "device_how": t["device_how"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None, "library_device_ms": None,
            "path_ms": kernel_ms.get("bank_scorer", 0.0),
            "path_how": "CUDA events around each launch",
        })
    for entry in result:
        path = entry["name"].split("/", 1)[1]
        entry["loss_steps"] = {k: v for k, v in loss_steps.items()
                               if k.startswith(path)}
    lap("14f")
    log("14 rank_surv", f"phase 14 wall {time.perf_counter() - t_phase:.1f} "
        f"s (by part, s: {walls})")
    return result


def uplift_honest_sets_path(smi, serving):
    """Phase 15: the uplift and honest forests, set-only datasets and the
    multitasker (ROADMAP items 29 and 15's rest) trained on the card
    through the learners' entry points with every other default,
    evaluated (Qini and AUUC for uplift), saved and loaded, the JAX-saved
    models served on the card, against the JAX package's runs
    (ydf_tpu_torch/testdata/train_uplift, train_honest, train_sets_alone,
    train_multitasker). Returns the `kernels` entries of the paths'
    training kernels, run sums and bank."""
    import tempfile

    import torch

    import ydf_tpu_torch
    from ydf_tpu_torch.config import Task
    from ydf_tpu_torch.learners import gbt as port_gbt
    from ydf_tpu_torch.learners import random_forest as port_rf
    from ydf_tpu_torch.models.forest import Forest
    from ydf_tpu_torch.ops import histogram_kernels, segment_sum
    from ydf_tpu_torch.serving import bank_scorer

    t_phase = time.perf_counter()
    walls, last = {}, [t_phase]

    def lap(part):
        now = time.perf_counter()
        walls[part] = round(now - last[0], 2)
        last[0] = now

    fixtures = {}
    for name, d in (("uplift", TRAIN_UPLIFT), ("honest", TRAIN_HONEST),
                    ("sets", TRAIN_SETS_ALONE),
                    ("multitasker", TRAIN_MULTITASKER)):
        with open(os.path.join(d, "config.json")) as f:
            cfg = json.load(f)
        fixtures[name] = (cfg, np.load(os.path.join(d, "expected.npz")))
    ucfg, uexp = fixtures["uplift"]
    hcfg, hexp = fixtures["honest"]
    scfg, sexp = fixtures["sets"]
    mcfg, mexp = fixtures["multitasker"]
    ur, uc, un = ucfg["rf"], ucfg["cart"], ucfg["numerical"]
    hr, hg = hcfg["rf"], hcfg["regression"]
    sg, sr, sc = scfg["gbt"], scfg["rf"], scfg["cart"]
    assert ucfg["generator"] == dict(features=UPLIFT_FEATURES,
                                     seed=UPLIFT_SEED)
    assert (ur["rows"], ur["test_rows"], uc["rows"], un["rows"],
            un["num_trees"]) == (UPLIFT_ROWS, UPLIFT_TEST_ROWS,
                                 UPLIFT_CART_ROWS, UPLIFT_NUM_ROWS,
                                 UPLIFT_NUM_TREES)
    assert (hr["rows"], hr["test_rows"], hg["rows"], hg["num_trees"]) == (
        RF_ROWS, RF_TEST_ROWS, HONEST_REG_ROWS, HONEST_REG_TREES)
    assert (sg["rows"], sg["test_rows"], sr["rows"], sr["test_rows"],
            sr["fixture_trees"], sc["rows"], sc["test_rows"]) == (
        SETS_GBT_ROWS, SETS_GBT_TEST_ROWS, SETS_RF_ROWS, SETS_RF_TEST_ROWS,
        SETS_RF_FIXTURE_TREES, SETS_CART_ROWS, SETS_CART_TEST_ROWS)
    assert (mcfg["rows"], mcfg["test_rows"]) == (MULTITASK_ROWS,
                                                 MULTITASK_TEST_ROWS)
    t0 = time.perf_counter()
    frames = {
        "uplift": make_uplift_frame(UPLIFT_ROWS, UPLIFT_TEST_ROWS),
        "uplift_cart": make_uplift_frame(UPLIFT_CART_ROWS, uc["test_rows"]),
        "uplift_numerical": make_uplift_frame(
            UPLIFT_NUM_ROWS, un["test_rows"], numerical=True),
        "honest": make_frame(RF_ROWS, RF_TEST_ROWS),
        "honest_regression": make_frame(HONEST_REG_ROWS, hg["test_rows"]),
        "sets_gbt": sets_alone_frame(SETS_GBT_ROWS, SETS_GBT_TEST_ROWS),
        "sets_rf": sets_alone_frame(SETS_RF_ROWS, SETS_RF_TEST_ROWS),
        "sets_cart": sets_alone_frame(SETS_CART_ROWS, SETS_CART_TEST_ROWS),
        "multitasker": make_frame(MULTITASK_ROWS, MULTITASK_TEST_ROWS),
    }
    for key in ("honest_regression", "multitasker"):
        for frame in frames[key]:
            frame["target"] = multitask_target(frame)
    for key, c in (("uplift", ur), ("uplift_cart", uc),
                   ("uplift_numerical", un), ("honest", hr),
                   ("honest_regression", hg), ("sets_gbt", sg),
                   ("sets_rf", sr), ("sets_cart", sc),
                   ("multitasker", mcfg)):
        assert frame_sha256(frames[key][0]) == c["train_sha256"], key
        assert frame_sha256(frames[key][1]) == c["test_sha256"], key
    log("15 uplift", f"frames (uplift {UPLIFT_ROWS} x {UPLIFT_FEATURES} + "
        f"{UPLIFT_TEST_ROWS}, CART {UPLIFT_CART_ROWS}, numerical "
        f"{UPLIFT_NUM_ROWS}; honest {RF_ROWS}, regression "
        f"{HONEST_REG_ROWS}; sets alone {SETS_GBT_ROWS} / {SETS_RF_ROWS} / "
        f"{SETS_CART_ROWS}; multitasker {MULTITASK_ROWS} + "
        f"{MULTITASK_TEST_ROWS}) in {time.perf_counter() - t0:.2f} s, "
        "SHA-256 == the fixtures'; JAX on the CPU that wrote them: uplift "
        f"RF {ur['jax_train_s_cpu']:.1f} s ({ur['fixture_trees']} trees), "
        f"honest {hr['jax_train_s_cpu']:.1f} s, sets GBT "
        f"{sg['jax_train_s_cpu']:.1f} s, multitasker "
        f"{mcfg['jax_train_s_cpu']:.1f} s")
    lap("setup")
    paths = {}  # path -> (launches, kernel ms, events, routed by Lh)

    def main_run(path, fn):
        """Counts at 0, fn() on the card, counts read."""
        reset_counts(serving)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counted, others, events = read_counts(serving)
        kernel_ms, routed_lh = split_events(events)
        paths[path] = (counted, kernel_ms, events, routed_lh)
        log("15 launches", f"{path}: {counted} launches (routed by hist "
            f"slots: {routed_lh}); serving kernels {others}")
        return result, counted, wall, kernel_ms, others

    def check_run(path, m, c, exp, prefix, T, fields, tst, ev):
        """Trees [0, T) by hash; the first T trees' predictions (1,024
        bitwise, all by SHA-256) and evaluation against the fixture."""
        pf = m.forest.to_numpy()
        check_tree_hashes(exp, prefix, pf, T, fields)
        sub = m
        if m.forest.num_trees > T:
            sub = type(m)(task=m.task, label=m.label, classes=m.classes,
                          dataspec=m.dataspec, binner=m.binner,
                          forest=Forest(*(a[:T] for a in m.forest)),
                          max_depth=m.max_depth,
                          extra_metadata=m.extra_metadata)
            ev = sub.evaluate(tst)
        preds = sub.predict(tst)
        want = exp[f"{prefix}/predictions"]
        assert same_bits(preds[:len(want)], want), f"{path} predictions"
        assert array_sha256(preds) == c["predictions_sha256"], path
        jev = c["jax_evaluate"]
        err = max(abs(ev.metrics[k] - jev[k]) for k in jev)
        assert err <= EVAL_SAME_ATOL, (path, err)
        assert m.extra_metadata.get("uplift_treatment") == c.get(
            "extra_metadata", {}).get("uplift_treatment"), path
        return preds, err

    def rf_run(path, hp, data, tst, c, exp, prefix, fields, T_fix,
               cls=None):
        """A forest trained through the learner's entry point, then
        evaluated; every check against the fixture."""
        cls = cls or ydf_tpu_torch.RandomForestLearner
        learner = cls(device=DEVICE, **hp)
        reads0 = port_rf.HOST_READS

        def fn():
            m = learner.train(data)
            t0 = time.perf_counter()
            ev = m.evaluate(tst)
            torch.cuda.synchronize()
            return m, ev, time.perf_counter() - t0

        (m, ev, eval_wall), counted, wall, kernel_ms, others = main_run(
            path, fn)
        T = m.forest.num_trees
        depth = learner.max_depth
        Fs = m.binner.num_set
        if m.binner.num_scalar:
            assert counted["histogram"] == T, counted
            assert counted["histogram_routed"] == T * (depth - 1), counted
            assert counted["binning"] >= 1, counted
        else:  # sets alone: the prefix histograms, no routed launch
            assert counted["histogram"] == T * 2 * Fs * depth, counted
            assert counted["histogram_routed"] == 0, counted
        honest = getattr(learner, "honest", False)
        assert counted["segment_sum"] == (
            2 * T * depth if Fs else 0) + (T if honest else 0), counted
        preds, err = check_run(path, m, c, exp, prefix, T_fix, fields, tst,
                               ev)
        oob = ""
        if c.get("oob_evaluation") and T == T_fix:
            jo, po = c["oob_evaluation"], m.self_evaluation()
            oerr = max(abs(po["metrics"][k] - jo["metrics"][k])
                       for k in jo["metrics"])
            assert oerr <= EVAL_SAME_ATOL, (path, oerr)
            assert po["num_examples"] == jo["num_examples"], path
            oob = f", out-of-bag metrics within {EVAL_SAME_ATOL}"
        loop_ms = learner.last_timings["loop_s"] * 1e3
        log("15 " + path, f"{cls.__name__}(**{hp}).train: wall "
            f"{(wall - eval_wall) * 1e3:.1f} ms (host clock, ends in "
            "synchronize); stages " + " ".join(
                f"{k}={v * 1e3:.1f}ms" for k, v in
                learner.last_timings.items())
            + f"; {T} trees, {loop_ms / T:.2f} ms a tree (loop wall / "
            f"trees), {port_rf.HOST_READS - reads0} host reads (before the "
            "loop; the loop runs under sync debug mode \"error\"); kernel "
            "time (CUDA events, train + evaluate) " + " ".join(
                f"{k}={v:.3f}ms" for k, v in kernel_ms.items())
            + f"; the first {T_fix} trees == JAX's by SHA-256, their "
            f"{len(preds)} predictions bitwise (SHA-256), evaluate " +
            " ".join(f"{k} {v:.12f}" for k, v in c["jax_evaluate"].items())
            + f" within {EVAL_SAME_ATOL} (max {err:.3g}){oob}; evaluate "
            f"{eval_wall * 1e3:.1f} ms; {smi}")
        return learner, m

    def cart_run(path, hp, data, tst, c, exp, fields):
        learner = ydf_tpu_torch.CartLearner(device=DEVICE, **hp)

        def fn():
            m, grown = cart_train(learner, data)
            t0 = time.perf_counter()
            ev = m.evaluate(tst)
            torch.cuda.synchronize()
            return m, grown, ev, time.perf_counter() - t0

        (m, grown, ev, eval_wall), counted, wall, kernel_ms, _ = main_run(
            path, fn)
        assert tree_sha256(grown, 0, fields=fields) == c["grown_sha256"]
        assert tree_sha256(m.forest.to_numpy(), 0, fields=fields) == \
            c["pruned_sha256"], path
        pruned = m.extra_metadata["num_pruned_nodes"]
        assert pruned == c["num_pruned_nodes"], (path, pruned)
        jo, po = c["oob_evaluation"], m.self_evaluation()
        err = max(abs(po["metrics"][k] - jo["metrics"][k])
                  for k in jo["metrics"])
        assert err <= EVAL_SAME_ATOL, (path, err)
        preds, err2 = check_run(path, m, c, exp, "cart", 1, fields, tst, ev)
        log("15 " + path, f"CartLearner(**{hp}).train: wall "
            f"{(wall - eval_wall) * 1e3:.1f} ms; stages " + " ".join(
                f"{k}={v * 1e3:.1f}ms" for k, v in
                learner.last_timings.items())
            + "; kernel time (CUDA events) " + " ".join(
                f"{k}={v:.3f}ms" for k, v in kernel_ms.items())
            + f"; grown ({c['grown_num_nodes']} nodes) and pruned ({pruned} "
            "pruned) trees == JAX's by SHA-256; holdout and evaluate "
            f"metrics within {EVAL_SAME_ATOL} (max {max(err, err2):.3g}); "
            f"the {len(preds)} predictions bitwise; {smi}")
        return m

    def jax_saved(path, d, tst, want, evaluate=None):
        """A JAX-saved model on the card: predictions on the fixture's
        rows bitwise, its evaluation equal."""
        jm = ydf_tpu_torch.load_model(d, device=DEVICE)
        head = {k: v[:len(want)] for k, v in tst.items()}
        assert same_bits(jm.predict(head), want), path
        if evaluate:
            jev = jm.evaluate(tst).metrics
            err = max(abs(jev[k] - evaluate[k]) for k in evaluate)
            assert err <= EVAL_SAME_ATOL, (path, err)
        return jm

    def save_load(path, m, tst):
        with tempfile.TemporaryDirectory() as tmp:
            m.save(os.path.join(tmp, "m"))
            back = ydf_tpu_torch.load_model(os.path.join(tmp, "m"),
                                            device=DEVICE)
        assert back.predict(tst).tobytes() == m.predict(tst).tobytes(), path
        assert back.extra_metadata == m.extra_metadata, path

    fields = TREE_HASH_FIELDS
    uplift_hp = dict(UPLIFT_HP, task=Task[UPLIFT_HP["task"]])
    # -- 15a the uplift forest: UPLIFT_TREES trees at S = 5 ------------ #
    utrain, utest = frames["uplift"]
    ulearner, umodel = rf_run("train_uplift",
                              dict(uplift_hp, num_trees=UPLIFT_TREES),
                              utrain, utest, ur, uexp, "rf", fields,
                              ur["fixture_trees"])
    assert umodel.forest.num_trees == UPLIFT_TREES == ulearner.num_trees
    save_load("train_uplift", umodel, utest)
    jax_saved("train_uplift", os.path.join(TRAIN_UPLIFT, "rf_small"), utest,
              uexp["rf/small_predictions"], ur["small_evaluate"])
    lap("15a")
    # -- 15b the uplift CART (AUUC pruning) and NUMERICAL_UPLIFT -------- #
    ctrain, ctest = frames["uplift_cart"]
    ucart = cart_run("train_uplift_cart", uplift_hp, ctrain, ctest, uc,
                     uexp, fields)
    jax_saved("train_uplift_cart", os.path.join(TRAIN_UPLIFT, "cart_model"),
              ctest, uexp["cart/predictions"], uc["jax_evaluate"])
    ntrain, ntest = frames["uplift_numerical"]
    num_hp = dict(uplift_hp, task=Task.NUMERICAL_UPLIFT,
                  num_trees=UPLIFT_NUM_TREES)
    _, nmodel = rf_run("train_uplift_numerical", num_hp, ntrain, ntest, un,
                       uexp, "numerical", fields, UPLIFT_NUM_TREES)
    lap("15b")
    # -- 15c honest forests --------------------------------------------- #
    htrain, htest = frames["honest"]
    honest_hp = dict(HONEST_HP, num_trees=hr["fixture_trees"])
    hlearner, hmodel = rf_run("train_honest", honest_hp, htrain, htest, hr,
                              hexp, "rf", fields, hr["fixture_trees"])
    save_load("train_honest", hmodel, htest)
    jax_saved("train_honest", os.path.join(TRAIN_HONEST, "rf_small"), htest,
              hexp["rf/small_predictions"])
    gtrain, gtest = frames["honest_regression"]
    reg_hp = dict(HONEST_HP, label="target", task=Task.REGRESSION,
                  num_trees=HONEST_REG_TREES)
    _, gmodel = rf_run("train_honest_regression", reg_hp, gtrain, gtest, hg,
                       hexp, "regression", fields, HONEST_REG_TREES)
    lap("15c")
    # -- 15d sets alone -------------------------------------------------- #
    sfields = SET_TREE_HASH_FIELDS
    strain, stest = frames["sets_gbt"]
    slearner = ydf_tpu_torch.GradientBoostedTreesLearner(device=DEVICE,
                                                         **DEFAULT_HP)
    reads0 = port_gbt.HOST_READS

    def sets_gbt():
        m = slearner.train(strain)
        t0 = time.perf_counter()
        ev = m.evaluate(stest)
        torch.cuda.synchronize()
        return m, ev, time.perf_counter() - t0

    (smodel, sev, seval_wall), counted, wall, kernel_ms, others = main_run(
        "train_sets_alone_gbt", sets_gbt)
    logs = smodel.training_logs
    trained, kept = logs["num_trees_trained"], logs["num_trees"]
    assert (kept, trained) == (sg["num_trees"], sg["num_trees_trained"])
    assert counted["histogram_routed"] == 0, counted
    assert counted["histogram"] == trained * 2 * 2 * slearner.max_depth, (
        counted)
    assert counted["segment_sum"] == 2 * trained * slearner.max_depth
    assert not any(others.values()), others  # set models serve routed
    check_tree_hashes(sexp, "gbt", smodel.forest.to_numpy(), kept, sfields)
    spreds = smodel.predict(stest)
    assert array_sha256(spreds) == sg["predictions_sha256"]
    err = max(abs(sev.metrics[k] - sg["jax_evaluate"][k])
              for k in sg["jax_evaluate"])
    assert err <= EVAL_SAME_ATOL, err
    boost_ms = slearner.last_timings["boost_s"] * 1e3
    log("15 train_sets_alone_gbt", f"GradientBoostedTreesLearner(**"
        f"{DEFAULT_HP}).train on the two set columns alone: wall "
        f"{(wall - seval_wall) * 1e3:.1f} ms; {trained} iterations trained, "
        f"{kept} kept (== JAX's), {port_gbt.HOST_READS - reads0} host reads; "
        f"{boost_ms / trained:.2f} ms a tree; kernel time (CUDA events) "
        + " ".join(f"{k}={v:.3f}ms" for k, v in kernel_ms.items())
        + "; no routed launch (rows routed by route_plain); every kept tree "
        f"by SHA-256, the {len(spreds)} predictions by SHA-256, evaluate "
        f"within {EVAL_SAME_ATOL} (max {err:.3g}); {smi}")
    save_load("train_sets_alone_gbt", smodel, stest)
    rtrain, rtest = frames["sets_rf"]
    rf_run("train_sets_alone_rf", dict(RF_HP, num_trees=sr["fixture_trees"]),
           rtrain, rtest, sr, sexp, "rf", sfields, sr["fixture_trees"])
    ctrain2, ctest2 = frames["sets_cart"]
    cart_run("train_sets_alone_cart", CART_HP, ctrain2, ctest2, sc, sexp,
             sfields)
    lap("15d")
    # -- 15e the multitasker -------------------------------------------- #
    mtrain, mtest = frames["multitasker"]
    tasks = [dict(t, task=Task[t.get("task", "CLASSIFICATION")])
             for t in mcfg["tasks"]]
    reads0 = port_gbt.HOST_READS

    def multitask():
        m = ydf_tpu_torch.MultitaskerLearner(tasks, device=DEVICE).train(
            mtrain)
        t0 = time.perf_counter()
        ev = m.evaluate(mtest)
        torch.cuda.synchronize()
        return m, ev, time.perf_counter() - t0

    (mmodel, mev, meval_wall), counted, wall, kernel_ms, others = main_run(
        "train_multitasker", multitask)
    trained_all = 0
    for label, sub in mmodel.models.items():
        c = mcfg["models"][label]
        logs = sub.training_logs
        assert (logs["num_trees"], logs["num_trees_trained"]) == (
            c["num_trees"], c["num_trees_trained"]), label
        trained_all += logs["num_trees_trained"]
        check_tree_hashes(mexp, label, sub.forest.to_numpy(),
                          c["num_trees"], fields)
        preds = sub.predict(mtest)
        assert same_bits(preds[:len(mexp[f"{label}/predictions"])],
                         mexp[f"{label}/predictions"]), label
        assert array_sha256(preds) == c["predictions_sha256"], label
        err = max(abs(mev[label].metrics[k] - c["jax_evaluate"][k])
                  for k in c["jax_evaluate"])
        assert err <= EVAL_SAME_ATOL, (label, err)
    assert counted["histogram"] == trained_all, counted
    assert counted["histogram_routed"] == trained_all * 5, counted
    assert others[bank_scorer.__name__] > 0, others  # evaluate: the bank
    with tempfile.TemporaryDirectory() as tmp:
        mmodel.save(os.path.join(tmp, "m"))
        back = ydf_tpu_torch.load_model(os.path.join(tmp, "m"),
                                        device=DEVICE)
    assert isinstance(back, ydf_tpu_torch.MultitaskerModel)
    for label, p in back.predict(mtest).items():
        assert p.tobytes() == mmodel.models[label].predict(mtest).tobytes()
    jmt = ydf_tpu_torch.load_model(os.path.join(TRAIN_MULTITASKER, "model"),
                                   device=DEVICE)
    head = {k: v[:mcfg["compare_rows"]] for k, v in mtest.items()}
    for label, p in jmt.predict(head).items():
        assert same_bits(p, mexp[f"{label}/predictions"]), label
    log("15 train_multitasker", f"MultitaskerLearner({mcfg['tasks']}).train "
        f"(default GBT sub-learners): wall {(wall - meval_wall) * 1e3:.1f} ms;"
        f" {trained_all} iterations trained over both tasks, "
        f"{port_gbt.HOST_READS - reads0} host reads; kernel time (CUDA "
        "events) " + " ".join(f"{k}={v:.3f}ms" for k, v in kernel_ms.items())
        + f"; serving {others}; both sub-models' kept trees == JAX's by "
        "SHA-256, predictions bitwise, evaluate within "
        f"{EVAL_SAME_ATOL}; the multitasker directory save -> load on the "
        "card bitwise, the JAX-saved directory on the card bitwise; "
        f"{smi}")
    lap("15e")
    # -- 15f the kernels against their plain versions ------------------- #
    mfeatures = [k for k in mtrain if k not in ("label", "target")]
    layers = {
        "train_uplift": captured_layers(
            ydf_tpu_torch.RandomForestLearner, uplift_hp, utrain),
        "train_uplift_numerical": captured_layers(
            ydf_tpu_torch.RandomForestLearner, num_hp, ntrain),
        "train_honest_regression": captured_layers(
            ydf_tpu_torch.RandomForestLearner, reg_hp, gtrain),
        "train_sets_alone_gbt": captured_layers(
            ydf_tpu_torch.GradientBoostedTreesLearner, DEFAULT_HP, strain),
        "train_sets_alone_rf": captured_layers(
            ydf_tpu_torch.RandomForestLearner, RF_HP, rtrain),
        "train_multitasker_label": captured_layers(
            ydf_tpu_torch.GradientBoostedTreesLearner,
            dict(label="label", features=mfeatures), mtrain),
        "train_multitasker_target": captured_layers(
            ydf_tpu_torch.GradientBoostedTreesLearner,
            dict(label="target", task=Task.REGRESSION, features=mfeatures),
            mtrain),
    }
    binned = {"train_uplift": (umodel.binner, utrain),
              "train_uplift_numerical": (nmodel.binner, ntrain),
              "train_honest_regression": (gmodel.binner, gtrain),
              "train_multitasker_label": (
                  mmodel.models["label"].binner, mtrain),
              "train_multitasker_target": (
                  mmodel.models["target"].binner, mtrain)}
    for path, case in layers.items():
        if path in binned:
            binner, data = binned[path]
            Fn = binner.num_numerical
            case["binning"].append(tuple(
                torch.from_numpy(a).to(DEVICE) for a in (
                    np.stack([np.asarray(data[k], np.float32)
                              for k in binner.feature_names[:Fn]]),
                    binner.boundaries[:Fn], binner.feature_num_bins[:Fn] - 1,
                    binner.impute_values[:Fn])))
            binning_check(case["binning"][-1])
        lhs = []
        for args in case["routed"]:
            got = histogram_kernels.histogram_routed(*args)
            want = histogram_kernels.histogram_routed_plain(*args)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                assert torch.equal(g, w), (
                    f"{path}: routed kernel != plain at Lh {args[5]}")
            lhs.append(args[5])
        for args in case["root"]:
            got = histogram_kernels.histogram(*args)
            want = histogram_kernels.histogram_plain(*args)
            torch.cuda.synchronize()
            assert torch.equal(got, want), f"{path}: histogram != plain"
        for args in case["segment"]:
            got = segment_sum.segment_sums(*args)
            torch.cuda.synchronize()
            assert torch.equal(got, segment_sum.segment_sums_plain(*args)), (
                f"{path}: segment sums != plain")
        S = {a[4].shape[1] for a in case["routed"]} | {
            a[2].shape[1] for a in case["root"]}
        if path.startswith("train_uplift"):
            # Every layer of a depth-16 tree, at the uplift width.
            L = case["routed"][0][3].do_split.shape[0] - 1
            assert S == {5} and lhs == [min(2 ** k, L // 2)
                                        for k in range(15)], (path, S, lhs)
        if path.startswith("train_sets_alone"):
            assert not case["routed"] and case["segment"], path
            assert all(a[0].shape[0] == 1 for a in case["root"]), path
        if path == "train_honest_regression":
            assert len(case["segment"]) == 1, path
        log("15 kernels", f"{path}: {len(case['binning'])} binning, "
            f"{len(case['root'])} histogram calls (S {sorted(S)}; the set "
            "prefix shape F = 1 on the set-only paths), "
            f"{len(case['routed'])} routed calls (Lh {sorted(set(lhs))}) and "
            f"{len(case['segment'])} run sums of a one-tree train torch.equal "
            "to plain")
    bank_inputs_of = {}
    for label in ("label", "target"):
        model = mmodel.models[label]
        bank = bank_scorer.build_bank_scorer(model)
        assert bank is not None, label
        xT = encoded_xT(model, mtest)
        want = bank_scorer.score_plain(bank.tables, xT)
        for walk, g in zip(("split", "per-thread"), both_walks(
                lambda: bank_scorer.score(bank.tables, xT))):
            assert torch.equal(g, want), f"{label} bank {walk} != plain"
        bank_inputs_of[f"train_multitasker_{label}"] = (bank, xT)
        log("15 kernels", f"bank_scorer on the multitasker's {label} model "
            f"({model.forest.num_trees} trees): {xT.shape[1]} rows x "
            f"{xT.shape[0]} features torch.equal to plain in both walks")
    lap("15f")
    # -- 15g where each loop's time goes -------------------------------- #
    profiles = {}
    for path, cls, hp, data, loop, trees in (
            ("train_uplift", ydf_tpu_torch.RandomForestLearner, uplift_hp,
             utrain, "loop_s", 3),
            ("train_honest_regression", ydf_tpu_torch.RandomForestLearner,
             reg_hp, gtrain, "loop_s", 3),
            ("train_sets_alone_gbt",
             ydf_tpu_torch.GradientBoostedTreesLearner, DEFAULT_HP, strain,
             "boost_s", 2),
            ("train_multitasker_label",
             ydf_tpu_torch.GradientBoostedTreesLearner,
             dict(label="label", features=mfeatures), mtrain, "boost_s",
             5)):
        prof = profiles[path] = dict(profile_train(
            data, dict(hp, num_trees=trees), cls, loop), trees=trees)
        log("15 profile", f"{path}: num_trees={trees} under torch.profiler: "
            f"wall {prof['wall_ms']:.1f} ms, tree loop "
            f"{prof['loop_ms']:.1f} ms ({prof['loop_ms'] / trees:.2f} ms a "
            f"tree); {prof['kernels']} device kernels "
            f"({prof['kernels'] / trees:.0f} a tree), device idle at least "
            f"{100 * prof['idle_share']:.1f}% of the loop; largest: "
            + "; ".join(f"{name[:50]} {ms:.3f} ms"
                        for name, ms in prof["top"][:4]))
    lap("15g")
    # -- 15h each kernel timed at each path's shapes -------------------- #
    result = []
    main_of = {"train_multitasker_label": "train_multitasker",
               "train_multitasker_target": "train_multitasker"}
    for path, case in layers.items():
        counted, kernel_ms, events, routed_lh = paths[main_of.get(path, path)]
        prof = profiles.get(path)
        kinds = []
        if case["binning"]:
            kinds.append(("binning", "binning.cu",
                          "ydf_tpu/ops/binning_pallas.py:60"))
        kinds.append(("histogram", "histogram.cu",
                      "ydf_tpu/ops/histogram_pallas.py:81"))
        if case["routed"]:
            kinds.append(("histogram_routed", "histogram_routed.cu",
                          "ydf_tpu/ops/histogram_pallas.py:172"))
        if case["segment"]:
            kinds.append(("segment_sum", "segment_sum.cu",
                          "ydf_tpu/ops/grower.py:810 (an XLA einsum; no "
                          "Pallas kernel)"))
        inp = {"binning": max(case["binning"], key=lambda a: a[0].shape[1])
               if case["binning"] else None,
               "root": case["root"][0],
               "routed": max(case["routed"], key=lambda a: a[5])
               if case["routed"] else None,
               "segment": max(case["segment"], key=lambda a: a[0].shape[0])
               if case["segment"] else None}
        for name, src, replaces in kinds:
            t = measure_train(name, inp, reps=20)
            log("15 timing", f"{path} {name} ({t['shape']}): "
                f"{timing_text(t)}, {smi}")
            entry = train_entry(name, path, src, replaces, t, counted[name],
                                0.0, kernel_ms.get(name, 0.0))
            if main_of.get(path):
                entry["launches_of"] = main_of[path] + " (both tasks)"
            if name == "segment_sum":
                entry.update(runs=t["runs"], longest_run=t["longest_run"])
            if prof:
                entry["loop_ms_a_tree"] = prof["loop_ms"] / prof["trees"]
                entry["idle_share"] = prof["idle_share"]
            if name == "histogram_routed":
                by_lh = oblique_layers(name, case["routed"], events,
                                       routed_lh)
                entry.update(layer_fields(by_lh))
                log("15 layers", f"{name} on {path} by hist slots: "
                    f"{layer_text(by_lh)}, {smi}")
            result.append(entry)
    counted, kernel_ms = paths["train_multitasker"][:2]
    for path, (bank, xT) in bank_inputs_of.items():
        t = measure(bank_scorer, bank.tables, bank.tables, xT)
        log("15 timing", f"bank_scorer/{path} at {xT.shape[1]} rows x "
            f"{xT.shape[0]} features: kernel {t['ms']:.4f} ms a call back "
            f"to back, {t['device_ms']:.4f} ms on the card "
            f"({t['device_how']}), plain {t['plain_ms']:.2f} ms, bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}; {t['detail']}), {smi}")
        result.append({
            "name": f"bank_scorer/{path}", "route": "cuda",
            "source": "ydf_tpu_torch/csrc/bank_scorer.cu",
            "replaces": "ydf_tpu/serving/pallas_scorer.py:118",
            "launches": others[bank_scorer.__name__],
            "launches_of": "train_multitasker (both tasks)",
            "max_abs_err": t["max_abs_err"],
            "ms": t["ms"], "device_ms": t["device_ms"],
            "device_how": t["device_how"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None, "library_device_ms": None,
            "path_ms": kernel_ms.get("bank_scorer", 0.0),
            "path_how": "CUDA events around each launch",
        })
    lap("15h")
    log("15 uplift", f"phase 15 wall {time.perf_counter() - t_phase:.1f} s "
        f"(by part, s: {walls})")
    return result


def file_sha256(path):
    import hashlib

    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def file_sha256s(d):
    """{file name: SHA-256} of a directory's files."""
    return {f: file_sha256(os.path.join(d, f)) for f in sorted(os.listdir(d))}


def model_io_path(smi, serving):
    """Phase 16: reference-format model IO and the model API (ROADMAP
    items 10, 30 and 9's rest) on the card, through the entry points a
    user calls: the committed YDF exports imported and served (gbt_d6 on
    IO_PREDICT_ROWS rows), the fixture models exported (SHA-256 against
    the JAX package's export), a default GBT trained on the card,
    exported and imported back, the binned QuickScorer on gbt_d6,
    benchmark(engines=True), predict_leaves, distance and serialize.
    The counts are read after these and before the checks and timings.
    Returns the `kernels` entry of the binned QuickScorer."""
    import tempfile

    import torch

    import ydf_tpu_torch
    from ydf_tpu_torch.dataset.dataset import Dataset
    from ydf_tpu_torch.models.ydf_format import export_ydf_model
    from ydf_tpu_torch.ops.routing import forest_predict_values, leaf_proximity
    from ydf_tpu_torch.serving import bank_scorer, quickscorer

    t_phase = time.perf_counter()
    with open(os.path.join(YDF_FORMAT, "config.json")) as f:
        cfg = json.load(f)
    exp = np.load(os.path.join(YDF_FORMAT, "expected.npz"))
    reqs = {}
    for name, c in cfg["models"].items():
        with np.load(os.path.join(TESTDATA, c["requests"])) as z:
            reqs[name] = {k: z[k] for k in z.files}
    stored = reqs["gbt_d6"]
    rng = np.random.default_rng(16)
    extra = draw_requests(stored, IO_PREDICT_ROWS - len(stored["f0"]), rng)
    # The stored rows first, so that the first 1,024 predictions are the
    # fixture's.
    big = {k: np.concatenate([v, extra[k]]) for k, v in stored.items()}
    train, test = make_frame(IO_TRAIN_ROWS, IO_ROUND_TRIP_ROWS)
    log("16 io", f"{len(cfg['models'])} YDF exports of the JAX package "
        f"(jax {cfg['jax_version']}); {IO_PREDICT_ROWS} request rows, a "
        f"{IO_TRAIN_ROWS}-row frame in {time.perf_counter() - t_phase:.2f} s")

    walls = {}
    reset_counts(serving)
    torch.cuda.synchronize()
    t_path = time.perf_counter()
    # (a) import: every committed YDF directory, gbt_d6 at full size.
    t0 = time.perf_counter()
    imported = {name: ydf_tpu_torch.load_model(os.path.join(YDF_FORMAT,
                                                            name),
                                               device=DEVICE)
                for name in cfg["models"]}
    walls["load_all"] = time.perf_counter() - t0
    m = imported["gbt_d6"]
    assert m.device.type == torch.device(DEVICE).type and m.native_missing
    assert m.list_compatible_engines() == ["Routed"]
    t0 = time.perf_counter()
    m._encode(big)
    torch.cuda.synchronize()
    walls["import_encode"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pred = m.predict(big)
    walls["import_predict"] = time.perf_counter() - t0
    assert pred.shape == (IO_PREDICT_ROWS,) and np.isfinite(pred).all()
    n0 = len(stored["f0"])
    assert same_bits(pred[:n0], exp["gbt_d6/predictions"]), "gbt_d6 import"
    for name, model in imported.items():
        got = model.predict(reqs[name])
        assert same_bits(got, exp[f"{name}/predictions"]), f"{name} import"
        leaves = model.predict_leaves(reqs[name])
        assert np.array_equal(leaves, exp[f"{name}/leaves"]), (
            f"{name} predict_leaves")
    saved = ydf_tpu_torch.load_model(os.path.join(TESTDATA, "gbt_d6"),
                                     device=DEVICE)
    t0 = time.perf_counter()
    saved._encode(big)
    torch.cuda.synchronize()
    walls["saved_encode"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    saved_pred = saved.predict(big)
    walls["saved_predict"] = time.perf_counter() - t0
    assert np.isfinite(saved_pred).all()
    # (b) export: the port's export of each fixture's source model.
    t0 = time.perf_counter()
    for name, c in cfg["models"].items():
        src = ydf_tpu_torch.load_model(os.path.join(TESTDATA, c["source"]),
                                       device=DEVICE)
        with tempfile.TemporaryDirectory() as tmp:
            export_ydf_model(src, tmp)
            assert file_sha256s(tmp) == c["sha256"], f"{name} export"
    walls["export_all"] = time.perf_counter() - t0
    # (c) round trip of a GBT trained on the card.
    t0 = time.perf_counter()
    trained = ydf_tpu_torch.GradientBoostedTreesLearner(
        label="label", num_trees=IO_TRAIN_TREES, device=DEVICE).train(train)
    walls["train"] = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        trained.save_ydf(tmp)
        back = ydf_tpu_torch.load_model(tmp, device=DEVICE)
    assert back.native_missing and back.num_trees() == trained.num_trees()
    rt_trained, rt_back = trained.predict(test), back.predict(test)
    assert same_bits(rt_trained, rt_back), "round trip"
    # (d) the binned QuickScorer on gbt_d6's bins.
    bq = quickscorer.build_binned_quickscorer(saved)
    assert bq is not None
    t0 = time.perf_counter()
    bins = saved.binner.transform(Dataset.from_data(big, saved.dataspec),
                                  saved.device)
    binned = bq(bins)
    torch.cuda.synchronize()
    walls["binned_path"] = time.perf_counter() - t0
    # (e) benchmark, every engine.
    sub = {k: v[:IO_BENCHMARK_ROWS] for k, v in big.items()}
    t0 = time.perf_counter()
    bench = saved.benchmark(sub, num_runs=5, engines=True)
    walls["benchmark"] = time.perf_counter() - t0
    # (f) distance and serialize.
    two = {k: v[:IO_DISTANCE_ROWS] for k, v in big.items()}
    t0 = time.perf_counter()
    dist = saved.distance(two)
    walls["distance"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    restored = ydf_tpu_torch.deserialize_model(saved.serialize(),
                                               device=DEVICE)
    assert same_bits(restored.predict(stored), saved.predict(stored)), (
        "serialize -> deserialize_model")
    walls["serialize"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    path_wall = time.perf_counter() - t_path
    counted, others, events = read_counts(serving)
    path_launches = quickscorer.KERNEL_ROWS / TIMING_ROWS
    kernel_ms, _ = split_events(events)
    for kernel in ("binning", "histogram", "histogram_routed"):
        assert counted[kernel] > 0, f"phase 16 launched no {kernel}"
    for mod in (quickscorer, bank_scorer):
        assert others[mod.__name__] > 0, f"phase 16 launched no {mod}"
    log("16 launches", f"path of {path_wall:.2f} s: training kernels "
        f"{counted}; serving kernels {others}; kernel ms (CUDA events) "
        + ", ".join(f"{k} {v:.3f}" for k, v in kernel_ms.items()))
    log("16 import", f"{len(imported)} YDF directories loaded on the card in "
        f"{walls['load_all']:.2f} s, each bitwise the JAX importer's "
        f"predictions and leaves on its 1,024 rows; gbt_d6 imported "
        f"(routed, native missing values) at {IO_PREDICT_ROWS} rows: "
        f"predict {walls['import_predict'] * 1e3:.1f} ms host wall, of it "
        f"encode {walls['import_encode'] * 1e3:.1f} ms; the JAX-saved "
        f"gbt_d6 (bank) predict {walls['saved_predict'] * 1e3:.1f} ms, "
        f"encode {walls['saved_encode'] * 1e3:.1f} ms, {smi}")
    log("16 export", f"{len(cfg['models'])} models exported in "
        f"{walls['export_all']:.2f} s, every file's SHA-256 == the JAX "
        "export's")
    log("16 round trip", f"{trained.num_trees()} trees on {IO_TRAIN_ROWS} "
        f"rows trained on the card in {walls['train']:.2f} s, exported, "
        f"loaded back: {IO_ROUND_TRIP_ROWS} predictions bitwise")
    log("16 benchmark", f"gbt_d6 at {IO_BENCHMARK_ROWS} rows: "
        + json.dumps(bench) + f", {smi}")

    # Checks and timings, after the counts.
    xT_bins = bins.t()[:bq.tables.num_features].to(torch.float32)
    plain = quickscorer.score_plain(bq.tables, xT_bins)
    assert torch.equal(binned, plain), "binned QuickScorer != plain"
    qs = quickscorer.build_quickscorer(saved)
    xT = encoded_xT(saved, big)
    float_scores = qs.score_xT(xT)
    assert torch.equal(binned, float_scores), "binned != float QuickScorer"
    F = saved.binner.num_numerical
    oracle = forest_predict_values(
        saved.forest, xT[:F].t().contiguous(),
        xT[F:].t().to(torch.int32).contiguous(), num_numerical=F,
        max_depth=saved.max_depth)[:, 0]
    assert torch.equal(binned, oracle), "binned != routed oracle"
    assert dist.shape == (IO_DISTANCE_ROWS, IO_DISTANCE_ROWS)
    assert np.isfinite(dist).all() and (np.diag(dist) == 0).all()
    assert np.array_equal(dist, dist.T)
    leaves = saved._leaves(two).cpu()
    part = 1.0 - leaf_proximity(leaves[:256], leaves).numpy()
    assert same_bits(dist[:256], part), "distance != the CPU proximity"
    err = float((binned - plain).abs().max())
    log("16 binned", f"gbt_d6 binned QuickScorer at {IO_PREDICT_ROWS} rows "
        f"(binning + engine {walls['binned_path'] * 1e3:.1f} ms host wall): "
        "torch.equal to its plain version, the float QuickScorer and the "
        f"routed oracle; distance {IO_DISTANCE_ROWS} x {IO_DISTANCE_ROWS} in "
        f"{walls['distance'] * 1e3:.1f} ms, bitwise the CPU proximity on "
        f"256 rows; serialize round trip {walls['serialize'] * 1e3:.1f} ms")
    bank = bank_scorer.build_bank_scorer(saved)
    for _ in range(3):
        quickscorer.score(bq.tables, xT_bins)
    torch.cuda.synchronize()
    t = {
        "ms": time_ms(lambda: quickscorer.score(bq.tables, xT_bins), reps=20),
        "plain_ms": time_ms(lambda: quickscorer.score_plain(bq.tables,
                                                            xT_bins), reps=1),
        **score_bound(bq.tables, bank.tables, xT),
    }
    t["device_ms"], t["device_how"] = device_ms(
        lambda: quickscorer.score(bq.tables, xT_bins),
        KERNELS_OF["quickscorer"])
    per_launch = [(int(k.split("/rows=")[1]), s.elapsed_time(e))
                  for k, s, e in events if k.startswith("quickscorer/")]
    log("16 timing", f"quickscorer/gbt_d6/binned at {xT_bins.shape[1]} rows "
        f"x {xT_bins.shape[0]} features: kernel {t['ms']:.4f} ms a call "
        f"back to back, {t['device_ms']:.4f} ms on the card "
        f"({t['device_how']}), plain {t['plain_ms']:.2f} ms, bound "
        f"{t['bound_ms']:.4f} ms ({t['bound_by']}; {t['detail']}); the "
        f"path's {others[quickscorer.__name__]} QuickScorer launches "
        f"(binned and, in benchmark, float) {sum(ms for _, ms in per_launch):.4f}"
        f" ms, {smi}")
    log("16 io", f"phase 16 wall {time.perf_counter() - t_phase:.1f} s "
        "(path walls, s: " + json.dumps(
            {k: round(v, 3) for k, v in walls.items()}) + ")")
    return [{
        "name": "quickscorer/gbt_d6/binned", "route": "cuda",
        "source": "ydf_tpu_torch/csrc/quickscorer.cu",
        "replaces": "ydf_tpu/serving/quickscorer.py:232",
        "launches": others[quickscorer.__name__],
        "launches_of": "phase 16's path (the binned engine, and the float "
                       "one inside benchmark)",
        "max_abs_err": err, "ms": t["ms"], "device_ms": t["device_ms"],
        "device_how": t["device_how"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": None, "library_device_ms": None,
        "path_ms": sum(ms for _, ms in per_launch),
        "path_how": "CUDA events around each launch",
        "path_launch_ms": per_launch,
        "path_launches_at_timing_rows": path_launches,
        "path_bound_ms": t["bound_ms"] * path_launches,
    }]


def record_calls(module, name, limit):
    """Wraps module.name so that the tensor arguments of its first
    `limit` calls are cloned as it got them (route tables included):
    (the records, a function restoring the original)."""
    import torch

    from ydf_tpu_torch.ops.histogram_kernels import RouteTables

    calls = []
    original = getattr(module, name)

    def wrapped(*args):
        if len(calls) < limit:
            calls.append(tuple(
                a.clone() if isinstance(a, torch.Tensor) else
                type(a)(*(t.clone() for t in a)) if isinstance(
                    a, RouteTables) else a for a in args))
        return original(*args)

    setattr(module, name, wrapped)
    return calls, lambda: setattr(module, name, original)


def cache_record(cache):
    """{"files": {data file: SHA-256}, "meta_sha256": ...} of a dataset
    cache: the metadata hashed as canonical JSON without its source path
    and request fingerprint (scripts/make_torch_port_fixtures.py writes
    the JAX package's the same way)."""
    import hashlib

    files = {f: file_sha256(os.path.join(cache.path, f))
             for f in sorted(cache._meta["integrity"]["files"])}
    meta = {k: v for k, v in cache._meta.items()
            if k not in ("source", "request_fingerprint")}
    return {"files": files, "meta_sha256": hashlib.sha256(json.dumps(
        meta, sort_keys=True).encode()).hexdigest()}


def check_run_trees(exp, prefix, model):
    """Every tree of a port model against the fixture's per-tree SHA-256
    (a NaN hashed as canonical_nan writes it) and node counts; returns
    the tree count."""
    fo = canonical_nan(model.forest.to_numpy())
    T = fo["feature"].shape[0]
    want = [h.tobytes().hex() for h in exp[f"{prefix}/tree_sha256"]]
    got = [tree_sha256(fo, t) for t in range(T)]
    bad = [t for t in range(max(T, len(want)))
           if t >= min(T, len(want)) or got[t] != want[t]]
    assert not bad, f"{prefix}: trees {bad[:10]} != the JAX package's"
    assert np.array_equal(fo["num_nodes"], exp[f"{prefix}/num_nodes"])
    return T


def cache_path(smi, serving):
    """Phase 17: out-of-core data (ROADMAP item 16) on the card. The
    phase writes make_frame's rows as CSV shards, builds the dataset
    cache from them (pass 2 bins every chunk on the card), trains the
    default GBT from the cache and evaluates it on the test CSV: the main
    path, its counts read after it. Then, against the JAX package's runs
    (ydf_tpu_torch/testdata/train_cache, train_discretized): the files,
    the cache at another chunking and in sketch mode, the trees, losses,
    metrics and predictions; the GBT on DISCRETIZED_NUMERICAL columns and
    its YDF export; predict on TFRecord and Avro files and
    predict_tf_examples; each kernel against its plain version on the
    path's own launches, and timed. Returns the `kernels` entries of the
    path's four kernels."""
    import gzip
    import hashlib
    import shutil
    import tempfile

    import torch

    import ydf_tpu_torch
    from ydf_tpu_torch.dataset import binning as dataset_binning
    from ydf_tpu_torch.dataset import cache as pcache
    from ydf_tpu_torch.dataset import native_csv, tfrecord
    from ydf_tpu_torch.learners import gbt as port_gbt
    from ydf_tpu_torch.ops import binning, histogram_kernels
    from ydf_tpu_torch.serving import bank_scorer
    from ydf_tpu_torch.utils import telemetry

    t_phase = time.perf_counter()
    rss0 = telemetry.peak_rss_bytes()
    with open(os.path.join(TRAIN_CACHE, "config.json")) as f:
        cfg = json.load(f)
    with open(os.path.join(TRAIN_DISCRETIZED, "config.json")) as f:
        dcfg = json.load(f)
    exp = np.load(os.path.join(TRAIN_CACHE, "expected.npz"))
    dexp = np.load(os.path.join(TRAIN_DISCRETIZED, "expected.npz"))
    assert (cfg["rows"], cfg["test_rows"], cfg["shards"], cfg["chunk_rows"],
            cfg["big_chunk_rows"], cfg["learner"], cfg["compare_rows"],
            cfg["record_rows"]) == (
        CACHE_ROWS, CACHE_TEST_ROWS, CACHE_SHARDS, CACHE_CHUNK_ROWS,
        CACHE_BIG_CHUNK_ROWS, CACHE_HP, CACHE_COMPARE_ROWS,
        CACHE_RECORD_ROWS), cfg
    assert (dcfg["rows"], dcfg["test_rows"], dcfg["learner"]) == (
        DISC_ROWS, DISC_TEST_ROWS, DISC_HP), dcfg
    tmp = tempfile.mkdtemp(prefix="ydf_cache_")
    walls = {}
    try:
        # -- 17a the files --------------------------------------------- #
        t0 = time.perf_counter()
        train, test = make_frame(CACHE_ROWS, CACHE_TEST_ROWS)
        walls["frame"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        names = write_csv_shards(tmp, train, test, CACHE_SHARDS)
        walls["csv_write"] = time.perf_counter() - t0
        shas = {n: file_sha256(os.path.join(tmp, n)) for n in names}
        assert shas == cfg["csv_sha256"], "CSV files != the fixture's"
        train_bytes = sum(os.path.getsize(os.path.join(tmp, n))
                          for n in names[:-1])
        walls["gxx"] = native_csv.build(force=True)
        log("17 files", f"{CACHE_SHARDS} CSV shards of "
            f"{CACHE_ROWS // CACHE_SHARDS} rows ({train_bytes} bytes) and a "
            f"{CACHE_TEST_ROWS}-row test CSV written in "
            f"{walls['csv_write']:.2f} s (frame {walls['frame']:.2f} s), "
            f"every SHA-256 == the fixture's (numpy {np.__version__}); the "
            f"CSV loader built with g++ in {walls['gxx']:.2f} s")

        # -- 17b the main path: cache, train, evaluate on the CSV ------- #
        reset_counts(serving)
        recs, restores = {}, []
        for key, mod, name, limit in (
                ("binning", dataset_binning, "bin_columns", 64),
                ("root", histogram_kernels, "histogram", 1),
                ("routed", histogram_kernels, "histogram_routed", 5),
                ("bank", bank_scorer, "score", 1)):
            recs[key], undo = record_calls(mod, name, limit)
            restores.append(undo)
        reads0 = port_gbt.HOST_READS
        try:
            torch.cuda.synchronize()
            t_path = time.perf_counter()
            t0 = time.perf_counter()
            cache = pcache.create_dataset_cache(
                f"csv:{tmp}/train-*.csv", os.path.join(tmp, "cache"),
                chunk_rows=CACHE_CHUNK_ROWS, **CACHE_HP)
            walls["cache_build"] = time.perf_counter() - t0
            build = cache.build_timings
            t0 = time.perf_counter()
            learner = ydf_tpu_torch.GradientBoostedTreesLearner(**CACHE_HP)
            model = learner.train(cache)
            torch.cuda.synchronize()
            walls["train"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            ev = model.evaluate(f"csv:{tmp}/test.csv")
            torch.cuda.synchronize()
            walls["evaluate"] = time.perf_counter() - t0
            path_wall = time.perf_counter() - t_path
        finally:
            for undo in restores:
                undo()
        counted, others, events = read_counts(serving)
        reads = port_gbt.HOST_READS - reads0
        assert model.device.type == torch.device(DEVICE).type
        logs = model.training_logs
        trained, kept = logs["num_trees_trained"], logs["num_trees"]
        chunks = build["chunk_rows"]
        assert chunks == [CACHE_CHUNK_ROWS, CACHE_ROWS // CACHE_SHARDS
                          - CACHE_CHUNK_ROWS] * CACHE_SHARDS, chunks
        assert counted["binning"] == len(chunks), counted
        assert counted["histogram"] == trained, counted
        assert counted["histogram_routed"] == trained * (
            learner.max_depth - 1), counted
        assert others[bank_scorer.__name__] >= 1, others
        assert not any(v for k, v in others.items()
                       if k != bank_scorer.__name__), others
        kernel_ms, routed_lh = split_events(events)
        bin_ms = [s.elapsed_time(e) for k, s, e in events if k == "binning"]
        mb = train_bytes / 1e6
        log("17 launches", f"cache + train + evaluate ({path_wall:.2f} s): "
            f"{counted} launches (routed by hist slots {routed_lh}); "
            f"serving {others}; {reads} host reads; kernel ms (CUDA "
            "events) " + ", ".join(f"{k} {v:.3f}" for k, v in
                                   kernel_ms.items()))
        log("17 cache", f"create_dataset_cache of {CACHE_ROWS} rows in "
            f"{walls['cache_build']:.2f} s: pass 1 {build['pass1_s']:.2f} s "
            f"({mb / build['pass1_s']:.1f} MB/s of CSV parsed and "
            f"summarized), fit {build['fit_s']:.3f} s, pass 2 "
            f"{build['pass2_s']:.2f} s ({mb / build['pass2_s']:.1f} MB/s), "
            f"of it the device binning {build['bin_s']:.3f} s (transform, "
            "row-major copy on the card, copy back; host clock); "
            f"{len(chunks)} chunks {chunks[:2]}..., one binning launch "
            "each, device ms (CUDA events) " + " ".join(
                f"{ms:.4f}" for ms in bin_ms) + f"; peak host RSS "
            f"{telemetry.peak_rss_bytes() / 2**30:.2f} GiB (process "
            f"lifetime; {rss0 / 2**30:.2f} GiB before the phase), {smi}")
        log("17 train", f"GradientBoostedTreesLearner(**{CACHE_HP})"
            f".train(cache): wall {walls['train'] * 1e3:.1f} ms; stages "
            + " ".join(f"{k}={v * 1e3:.1f}ms" for k, v in
                       learner.last_timings.items())
            + f"; {trained} trees trained, {kept} kept; "
            f"{learner.last_timings['boost_s'] * 1e3 / trained:.2f} ms a "
            f"tree; evaluate of {CACHE_TEST_ROWS} CSV rows "
            f"{walls['evaluate'] * 1e3:.1f} ms, {smi}")

        # -- 17c against the JAX package's run ------------------------- #
        rec = cache_record(cache)
        assert rec["files"] == cfg["cache"]["files"], "cache files"
        assert rec["meta_sha256"] == cfg["cache"]["meta_sha256"], "meta"
        t0 = time.perf_counter()
        big = pcache.create_dataset_cache(
            f"csv:{tmp}/train-*.csv", os.path.join(tmp, "big"),
            chunk_rows=CACHE_BIG_CHUNK_ROWS, **CACHE_HP)
        walls["big_chunks"] = time.perf_counter() - t0
        assert cache_record(big) == rec, "chunking changed a byte"
        shutil.rmtree(big.path)
        t0 = time.perf_counter()
        sk = pcache.create_dataset_cache(
            f"csv:{tmp}/train-*.csv", os.path.join(tmp, "sketch"),
            chunk_rows=CACHE_CHUNK_ROWS, boundaries="sketch", **CACHE_HP)
        walls["sketch"] = time.perf_counter() - t0
        assert cache_record(sk) == cfg["sketch_cache"], "sketch cache"
        shutil.rmtree(sk.path)
        _, va_idx = port_gbt.split_validation(cache.num_rows,
                                              learner.validation_ratio,
                                              learner.random_seed)
        assert array_sha256(va_idx.astype(np.int64)) == \
            cfg["valid_idx_sha256"], "validation rows"
        jf = cfg["full"]
        assert (kept, trained) == (jf["num_trees_kept"],
                                   jf["num_trees_trained"]), (kept, trained)
        T = check_run_trees(exp, "full", model)
        loss_rel = 0.0
        for k in ("train_loss", "valid_loss"):
            got = np.array([r[k] for r in logs["iterations"]], np.float64)
            want = exp[f"full/{k}"].astype(np.float64)
            assert got.shape == want.shape, k
            loss_rel = max(loss_rel, float(np.abs(got / want - 1).max()))
        assert loss_rel <= REPORTED_LOSS_RTOL, loss_rel
        jev = jf["jax_evaluate"]
        same = max(abs(ev.metrics[k] - jev[k]) for k in jev)
        assert same <= EVAL_SAME_ATOL, (ev.metrics, jev)
        head = {k: v[:CACHE_COMPARE_ROWS] for k, v in test.items()}
        pred = model.predict(head)
        assert same_bits(pred, exp["full/predictions"]), "predictions"
        log("17 vs JAX", f"every cache file's SHA-256 and the metadata == "
            f"the JAX package's; the same bytes in chunks of "
            f"{CACHE_BIG_CHUNK_ROWS} ({walls['big_chunks']:.2f} s) and in "
            f"sketch mode == JAX's sketch cache ({walls['sketch']:.2f} s); "
            f"validation rows, {kept} of {trained} trees kept, all {T} trees "
            f"by hash and {CACHE_COMPARE_ROWS} predictions bitwise, the "
            f"reported losses within {loss_rel:.2e} (<= "
            f"{REPORTED_LOSS_RTOL}, torch's binomial loss); "
            f"evaluate on the test CSV within {same:.3g} of JAX's (<= "
            f"{EVAL_SAME_ATOL}): " + " ".join(
                f"{k} {ev.metrics[k]:.6f}" for k in jev))

        # -- 17d the GBT on DISCRETIZED_NUMERICAL columns --------------- #
        dtrain, dtest = make_frame(DISC_ROWS, DISC_TEST_ROWS)
        reset_counts(serving)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dlearner = ydf_tpu_torch.GradientBoostedTreesLearner(**DISC_HP)
        dmodel = dlearner.train(dtrain)
        dpred = dmodel.predict(dtest)
        torch.cuda.synchronize()
        walls["discretized"] = time.perf_counter() - t0
        dcounted, dothers, _ = read_counts(serving)
        dtrained = dmodel.training_logs["num_trees_trained"]
        assert dcounted["binning"] >= 1 and dcounted["histogram"] == \
            dtrained and dothers[bank_scorer.__name__] >= 1, (dcounted,
                                                             dothers)
        dj = dcfg["full"]
        assert dmodel.training_logs["num_trees"] == dj["num_trees_kept"]
        DT = check_run_trees(dexp, "full", dmodel)
        assert same_bits(dpred[:CACHE_COMPARE_ROWS], dexp["full/predictions"])
        assert array_sha256(dpred) == dj["test_predictions_sha256"]
        ydir = os.path.join(tmp, "ydf")
        dmodel.save_ydf(ydir)
        assert file_sha256s(ydir) == dj["export_sha256"]
        log("17 discretized", f"GradientBoostedTreesLearner(**{DISC_HP}) "
            f"on {DISC_ROWS} rows, predict on {DISC_TEST_ROWS}: "
            f"{walls['discretized']:.2f} s ("
            f"{dlearner.last_timings['boost_s'] * 1e3 / dtrained:.2f} ms a "
            f"tree), launches {dcounted}, serving "
            f"{dothers}; {dmodel.training_logs['num_trees']} of {dtrained} "
            f"kept, all {DT} trees by hash and the predictions bitwise the "
            "JAX run's; save_ydf's files == the JAX export's by SHA-256; "
            f"served by {dmodel.list_compatible_engines()[0]}")

        # -- 17e TFRecord and Avro -------------------------------------- #
        rows = {k: v[:CACHE_RECORD_ROWS] for k, v in test.items()}
        tf = os.path.join(tmp, "test.tfrecord.gz")
        t0 = time.perf_counter()
        tfrecord.write_tfrecord_columns(tf, rows, compressed=True)
        walls["tfrecord_write"] = time.perf_counter() - t0
        with gzip.open(tf, "rb") as f:
            stream = f.read()
        assert hashlib.sha256(stream).hexdigest() == \
            cfg["tfrecord_records_sha256"], "TFRecord records"
        av = os.path.join(tmp, "test.avro")
        write_avro(av, rows)
        want = model.predict(rows)
        t0 = time.perf_counter()
        got_tf = model.predict(f"tfrecord:{tf}")
        walls["tfrecord_predict"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        got_av = model.predict(f"avro:{av}")
        walls["avro_predict"] = time.perf_counter() - t0
        records = list(tfrecord.iter_records(tf))[:CACHE_COMPARE_ROWS]
        got_ex = model.predict_tf_examples(records)
        assert same_bits(got_tf, want) and same_bits(got_av, want)
        assert same_bits(got_ex, want[:CACHE_COMPARE_ROWS])
        log("17 readers", f"{CACHE_RECORD_ROWS} test rows: TFRecord (gzip) "
            f"written in {walls['tfrecord_write']:.2f} s, its records' "
            "SHA-256 == the JAX writer's; predict on the tfrecord path "
            f"({len(stream) / 1e6 / walls['tfrecord_predict']:.2f} MB/s of "
            f"records, {walls['tfrecord_predict']:.2f} s), on the avro path "
            f"(deflate, {os.path.getsize(av)} bytes, "
            f"{walls['avro_predict']:.2f} s) and predict_tf_examples of "
            f"{CACHE_COMPARE_ROWS} records bitwise the in-memory predict")

        # -- 17f each kernel against plain on the path's launches ------- #
        assert len(recs["binning"]) == len(chunks)
        for args in recs["binning"]:
            assert torch.equal(binning.bin_columns(*args),
                               binning.bin_columns_plain(*args)), \
                "binning chunk != plain"
        root = recs["root"][0]
        err_root = hist_check(
            histogram_kernels.histogram(*root),
            histogram_kernels.histogram_plain(*root),
            histogram_kernels.histogram_plain(*abs_stats(root, 2)),
            "root histogram")
        err_routed = 0.0
        for args in recs["routed"]:
            got = histogram_kernels.histogram_routed(*args)
            want_r = histogram_kernels.histogram_routed_plain(*args)
            assert torch.equal(got[1], want_r[1]) and torch.equal(
                got[2], want_r[2]), "routed: new_slot / new_leaf != plain"
            err_routed = max(err_routed, hist_check(
                got[0], want_r[0], histogram_kernels.histogram_routed_plain(
                    *abs_stats(args, 4))[0], "routed histogram"))
        tables, xT = recs["bank"][0]
        assert torch.equal(bank_scorer.score(tables, xT),
                           bank_scorer.score_plain(tables, xT)), "bank"
        log("17 kernels", f"{len(chunks)} binning chunks "
            f"({tuple(recs['binning'][0][0].shape)} ... "
            f"{tuple(recs['binning'][-1][0].shape)}) torch.equal to plain; "
            f"the root histogram (max abs {err_root:.3g}) and tree 0's "
            f"{len(recs['routed'])} routed layers (Lh "
            f"{[a[5] for a in recs['routed']]}; new_slot, new_leaf "
            f"torch.equal, max abs {err_routed:.3g}) within {HIST_RTOL} x "
            f"mass + {HIST_ATOL}; the bank on evaluate's {xT.shape[1]} "
            "rows torch.equal")

        # -- 17g timings ------------------------------------------------ #
        inp = {"binning": recs["binning"][0], "root": root,
               "routed": max(recs["routed"], key=lambda a: a[5])}
        err = {"binning": 0.0, "histogram": err_root,
               "histogram_routed": err_routed}
        out = []
        for name, src, replaces in (
            ("binning", "binning.cu", "ydf_tpu/ops/binning_pallas.py:60"),
            ("histogram", "histogram.cu",
             "ydf_tpu/ops/histogram_pallas.py:81"),
            ("histogram_routed", "histogram_routed.cu",
             "ydf_tpu/ops/histogram_pallas.py:172"),
        ):
            t = measure_train(name, inp)
            log("17 timing", f"{name} ({t['shape']}): {timing_text(t)}, "
                f"{smi}")
            out.append(train_entry(name, "train_cache", src, replaces, t,
                                   counted[name], err[name],
                                   kernel_ms.get(name, 0.0)))
            if name == "binning":
                out[-1]["path_launch_ms"] = bin_ms
        t = measure(bank_scorer, tables, tables, xT)
        log("17 timing", f"bank_scorer/train_cache at {xT.shape[1]} rows x "
            f"{xT.shape[0]} features ({kept} trees): kernel {t['ms']:.4f} "
            f"ms a call back to back, {t['device_ms']:.4f} ms on the card "
            f"({t['device_how']}), plain {t['plain_ms']:.2f} ms, bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}; {t['detail']}), "
            f"{smi}")
        out.append({
            "name": "bank_scorer/train_cache", "route": "cuda",
            "source": "ydf_tpu_torch/csrc/bank_scorer.cu",
            "replaces": "ydf_tpu/serving/pallas_scorer.py:118",
            "launches": others[bank_scorer.__name__],
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "device_ms": t["device_ms"], "device_how": t["device_how"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None,
            "library_device_ms": None,
            "path_ms": kernel_ms.get("bank_scorer", 0.0),
            "path_how": "CUDA events around each launch",
        })
        prof = profile_train(cache, dict(CACHE_HP, num_trees=CACHE_PROFILE_TREES))
        log("17 profile", f"one more train from the cache, num_trees="
            f"{CACHE_PROFILE_TREES}, under torch.profiler: wall "
            f"{prof['wall_ms']:.1f} ms, boosting loop {prof['loop_ms']:.1f} "
            f"ms; {prof['kernels']} device kernels, {prof['busy_ms']:.3f} ms "
            "of device time over the whole train, so the device is idle at "
            f"least {100 * prof['idle_share']:.1f}% of the loop; largest: "
            + "; ".join(f"{n[:60]} {ms:.3f} ms" for n, ms in prof["top"]))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log("17 cache", f"phase 17 wall {time.perf_counter() - t_phase:.1f} s "
        "(walls, s: " + json.dumps({k: round(v, 3) for k, v in
                                    walls.items()}) + ")")
    return out


def forest_hashes(forest_np, T=None, fields=TREE_HASH_FIELDS):
    """Per-tree SHA-256 (tree_sha256) of a forest's first T trees."""
    T = forest_np["feature"].shape[0] if T is None else T
    return [tree_sha256(forest_np, t, fields=fields) for t in range(T)]


def robust_path(smi, serving):
    """Phase 18: MHLD-oblique splits and the GBT's robustness surface.
    18 mhld: GradientBoostedTreesLearner(split_axis="MHLD_OBLIQUE") with
    every other default trained on train_default's frame on the card
    against the JAX package's run (ydf_tpu_torch/testdata/train_mhld):
    W, boundaries, the kept count, every kept tree by hash, the
    predictions; its launches, host reads, ms a tree, the device's idle
    share of a profiled stretch; the path's kernels against plain and
    timed. 18 resume: train_default's GBT with a working_dir, preempted
    after three chunks of 25, then resumed: every tree == phase 8's card
    run and the fixture; a mismatched resume refused. 18 deadline: the
    GBT and the random forest with a deadline: their trees a prefix of
    phases 8's and 9's. 18 telemetry: a training and a predict with
    telemetry on: the metrics, the flushed trace, ms a tree on and off.
    Returns the `kernels` entries of the MHLD path's three kernels."""
    import shutil
    import tempfile

    import torch

    import ydf_tpu_torch
    from ydf_tpu_torch.learners import gbt as port_gbt
    from ydf_tpu_torch.ops import histogram_kernels
    from ydf_tpu_torch.utils import telemetry
    from ydf_tpu_torch.utils.snapshot import Snapshots

    t_phase = time.perf_counter()
    walls, last = {}, [t_phase]

    def lap(part):
        now = time.perf_counter()
        walls[part] = round(now - last[0], 2)
        last[0] = now

    with open(os.path.join(TRAIN_MHLD, "config.json")) as f:
        cfg = json.load(f)
    exp = np.load(os.path.join(TRAIN_MHLD, "expected.npz"))
    c = cfg["gbt"]
    assert (c["rows"], c["test_rows"], c["learner"], cfg["cat_seed"]) == (
        DEFAULT_ROWS, DEFAULT_TEST_ROWS, MHLD_HP, DEFAULT_CAT_SEED), c
    train, test = make_frame(DEFAULT_ROWS, DEFAULT_TEST_ROWS)
    assert frame_sha256(train) == c["train_sha256"], "train frame"
    assert frame_sha256(test) == c["test_sha256"], "test frame"
    import scipy

    try:
        blas = scipy.show_config(mode="dicts")["Build Dependencies"]["blas"]
        blas = blas.get("openblas configuration") or blas.get("name")
    except Exception as e:  # the build information is optional
        blas = f"unknown ({type(e).__name__})"
    log("18 mhld", f"the solves' LAPACK on this host: scipy "
        f"{scipy.__version__}, numpy {np.__version__}, BLAS {blas}; frames "
        f"{DEFAULT_ROWS} + {DEFAULT_TEST_ROWS} rows, "
        f"SHA-256 == the fixture's; JAX fixture: jax {cfg['jax_version']}, "
        f"impls {cfg['jax_impls']}, {c['num_trees']} of "
        f"{c['num_trees_trained']} trees kept in {c['jax_train_s_cpu']:.1f} "
        "s on the CPU that wrote it")
    lap("setup")

    # -- 18a the main path: MHLD with every other default, evaluate ---- #
    records, restore = capture_returns(port_gbt, "boost")
    reads0 = port_gbt.HOST_READS
    reset_counts(serving)
    torch.cuda.synchronize()
    try:
        t0 = time.perf_counter()
        learner = ydf_tpu_torch.GradientBoostedTreesLearner(device=DEVICE,
                                                            **MHLD_HP)
        model = learner.train(train)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        t0 = time.perf_counter()
        ev = model.evaluate(test)
        torch.cuda.synchronize()
        eval_wall = time.perf_counter() - t0
    finally:
        restore()
    counted, others, events = read_counts(serving)
    reads = port_gbt.HOST_READS - reads0
    kernel_ms, routed_lh = split_events(events)
    logs = model.training_logs
    trained, kept = logs["num_trees_trained"], logs["num_trees"]
    depth = learner.max_depth
    chunks = -(-trained // min(learner.early_stopping_num_trees_look_ahead,
                               port_gbt.MAX_CHUNK_TREES))
    assert counted["histogram"] == trained, counted
    assert counted["histogram_routed"] == trained * (depth - 1), counted
    # The binner's call, then each iteration's training and validation
    # projections.
    assert counted["binning"] == 1 + 2 * trained, counted
    assert not any(others.values()), others  # an oblique forest: routed
    # The scatter matrices' one read before the loop (the row weights
    # stay), then the look-ahead stop's read a chunk: none for MHLD in it.
    assert reads == 1 + chunks, (reads, chunks)
    boost_ms = learner.last_timings["boost_s"] * 1e3
    log("18 launches", f"train_mhld (train + evaluate): {counted} launches "
        f"(routed by hist slots: {routed_lh}); serving kernels {others} (an "
        "oblique forest serves routed)")
    log("18 train", f"GradientBoostedTreesLearner(**{MHLD_HP}).train: wall "
        f"{wall * 1e3:.1f} ms (host clock, ends in synchronize); stages "
        + " ".join(f"{k}={v * 1e3:.1f}ms"
                   for k, v in learner.last_timings.items())
        + f"; {trained} trees trained, {kept} kept; {reads} host reads "
        f"(1 before the loop: the scatter matrices; {chunks} chunks); "
        f"{boost_ms / trained:.2f} ms a tree (loop wall / trees trained, "
        "each chunk's 28 solves a tree at its start included); kernel "
        "time "
        "(CUDA events, train + evaluate) " + " ".join(
            f"{k}={v:.3f}ms" for k, v in kernel_ms.items())
        + f"; evaluate of {DEFAULT_TEST_ROWS} rows {eval_wall * 1e3:.1f} ms;"
        f" {smi}")
    pf = model.forest.to_numpy()
    W, bounds = (a.cpu().numpy() for a in records[0].obl_out)
    jW = exp["gbt/oblique_weights"]
    T = min(kept, c["num_trees"])
    hashes = forest_hashes(pf, T, TREE_HASH_FIELDS + ("threshold",))
    tree_same = [h == exp["gbt/tree_sha256"][t].tobytes().hex()
                 for t, h in enumerate(hashes)]
    w_same = W[:T].tobytes() == jW[:T].tobytes()
    bounds_same = [array_sha256(b) == exp["gbt/bounds_sha256"][t].tobytes(
    ).hex() for t, b in enumerate(bounds[:T])]
    preds = model.predict(test)
    exact = (w_same and all(tree_same) and all(bounds_same)
             and kept == c["num_trees"]
             and trained == c["num_trees_trained"]
             and array_sha256(preds) == c["predictions_sha256"])
    jev = c["jax_evaluate"]
    ev_err = max(abs(ev.metrics[k] - jev[k]) for k in jev)
    if exact:
        log("18 mhld vs JAX", f"{kept} of {trained} trees == JAX's: every "
            "kept tree by SHA-256 (node arrays with thresholds), its 28 x 28 "
            "projections W bitwise, its 28 x 255 boundaries by SHA-256; "
            f"the {DEFAULT_TEST_ROWS} predictions bitwise (SHA-256); "
            "evaluate " + " ".join(f"{k} {ev.metrics[k]:.6f}" for k in jev)
            + f" (max |diff| to JAX's {ev_err:.3g})")
    else:
        # Where the two part, for the record; the check is exact.
        w_err = float(np.abs(W[:T] - jW[:T]).max())
        first = next((t for t, ok in enumerate(tree_same) if not ok), None)
        w_first = next((t for t in range(T)
                        if W[t].tobytes() != jW[t].tobytes()), None)
        log("18 mhld vs JAX", f"NOT bitwise: W max |diff| {w_err:.3g} "
            f"(first differing W: iteration {w_first}), first differing "
            f"tree {first}, {sum(tree_same)} of {T} trees equal, bounds "
            f"{sum(bounds_same)} of {T} equal, kept/trained {kept}/"
            f"{trained} vs JAX {c['num_trees']}/{c['num_trees_trained']}, "
            "evaluate " + " ".join(f"{k} {ev.metrics[k]:.6f} (JAX "
                                   f"{jev[k]:.6f})" for k in jev))
    assert exact, "train_mhld on the card != the JAX run (18 mhld vs JAX)"
    lap("18a")

    # -- 18a' changing row weights; the host's part of a tree ---------- #
    reads0 = port_gbt.HOST_READS
    records, restore = capture_returns(port_gbt, "boost")
    try:
        t0 = time.perf_counter()
        sub = ydf_tpu_torch.GradientBoostedTreesLearner(device=DEVICE,
                                                        **MHLD_SUB_HP)
        smodel = sub.train(train)
        torch.cuda.synchronize()
        sub_wall = time.perf_counter() - t0
    finally:
        restore()
    sub_reads = port_gbt.HOST_READS - reads0
    sub_trained = smodel.training_logs["num_trees_trained"]
    assert sub_trained == MHLD_SUB_HP["num_trees"], sub_trained
    # One read a tree (the scatter sums and w), none other: no look-ahead
    # stop at 5 trees.
    assert sub_reads == sub_trained, (sub_reads, sub_trained)
    sW = records[0].obl_out[0].cpu().numpy()
    assert sW.shape == (sub_trained, 28, 28) and np.isfinite(sW).all()
    norms = np.sqrt((sW.astype(np.float64) ** 2).sum(-1))
    assert np.abs(norms - 1).max() < 1e-5, norms
    sub_ms = sub.last_timings["boost_s"] * 1e3 / sub_trained
    # The host's part of a tree: 28 solves (path i and ii) and, with
    # changing row weights, the w^T x chain over the training rows.
    from ydf_tpu_torch.ops import mhld
    from ydf_tpu_torch.utils import prng

    rng = np.random.default_rng(0)
    n_tr = int(round(DEFAULT_ROWS * 0.9))
    xh = rng.normal(size=(n_tr, 28)).astype(np.float32)
    wh = (rng.random(n_tr) < 0.5).astype(np.float32)
    mhld.fma_chain(wh[:1000], xh[:1000])  # built and warm
    t0 = time.perf_counter()
    mhld.fma_chain(wh, xh)
    chain_ms = (time.perf_counter() - t0) * 1e3
    X = rng.normal(size=(400, 28)).astype(np.float32)
    Y = rng.normal(size=(2, 28)).astype(np.float32)
    masks = mhld.subset_masks(prng.prng_key(0)[None], 28, 28, 4)[0].numpy()
    SW, SB = (X.T @ X).astype(np.float32), (Y.T @ Y).astype(np.float32)
    mhld.solve_projections(SW, SB, np.float32(0.05), masks)
    t0 = time.perf_counter()
    mhld.solve_projections(SW, SB, np.float32(0.05), masks)
    solve_ms = (time.perf_counter() - t0) * 1e3
    log("18 mhld ii", f"GradientBoostedTreesLearner(**{MHLD_SUB_HP}) at "
        f"full width: wall {sub_wall * 1e3:.1f} ms, {sub_ms:.2f} ms a tree "
        f"(loop wall / trees), {sub_reads} host reads (one a tree), W "
        "finite with unit rows; the host's part of a tree: 28 solves "
        f"{solve_ms:.2f} ms, the w^T x chain over {n_tr} x 28 rows "
        f"{chain_ms:.2f} ms (host clock); {smi}")
    lap("18a'")

    # -- 18b the path's kernels against plain, timed ------------------- #
    case = captured_layers(ydf_tpu_torch.GradientBoostedTreesLearner,
                           MHLD_HP, train)
    assert case["binning"], "no projection binning captured"
    for args in case["binning"]:
        binning_check(args)
    for args in case["routed"]:
        got = histogram_kernels.histogram_routed(*args)
        want = histogram_kernels.histogram_routed_plain(*args)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w), f"routed != plain at Lh {args[5]}"
    for args in case["root"]:
        got = histogram_kernels.histogram(*args)
        want = histogram_kernels.histogram_plain(*args)
        torch.cuda.synchronize()
        assert torch.equal(got, want), "root histogram != plain"
    log("18 kernels", f"train_mhld: the projection binning "
        f"({len(case['binning'])} calls, values "
        f"{tuple(case['binning'][0][0].shape)}), the root histogram (F "
        f"{case['root'][0][0].shape[0]}, n {case['root'][0][0].shape[1]}) "
        f"and histogram_routed at Lh {sorted({a[5] for a in case['routed']})}"
        " of a one-tree train's own calls torch.equal to plain")
    prof = profile_train(train, dict(MHLD_HP, num_trees=MHLD_PROFILE_TREES))
    log("18 profile", f"one more train, num_trees={MHLD_PROFILE_TREES}, "
        "under torch.profiler (the profiler slows the host): wall "
        f"{prof['wall_ms']:.1f} ms, boosting loop {prof['loop_ms']:.1f} ms "
        f"({prof['loop_ms'] / MHLD_PROFILE_TREES:.2f} ms a tree); "
        f"{prof['kernels']} device kernels, {prof['busy_ms']:.3f} ms of "
        "device time over the whole train, so the device is idle at least "
        f"{100 * prof['idle_share']:.1f}% of the loop; largest: "
        + "; ".join(f"{n[:60]} {ms:.3f} ms" for n, ms in prof["top"]))
    result = []
    inp = {"binning": max(case["binning"], key=lambda a: a[0].shape[1]),
           "root": case["root"][0],
           "routed": max(case["routed"], key=lambda a: a[5])}
    for name, src, replaces in (
            ("binning", "binning.cu", "ydf_tpu/ops/binning_pallas.py:60"),
            ("histogram", "histogram.cu",
             "ydf_tpu/ops/histogram_pallas.py:81"),
            ("histogram_routed", "histogram_routed.cu",
             "ydf_tpu/ops/histogram_pallas.py:172")):
        t = measure_train(name, inp, reps=RF_ROOT_REPS
                          if name == "histogram" else 20)
        log("18 timing", f"train_mhld {name} ({t['shape']}): "
            f"{timing_text(t)}, {smi}")
        result.append(train_entry(name, "train_mhld", src, replaces, t,
                                  counted[name], 0.0,
                                  kernel_ms.get(name, 0.0)))
        result[-1]["loop_ms_a_tree"] = boost_ms / trained
        result[-1]["idle_share"] = prof["idle_share"]
        result[-1]["host_reads"] = reads
        if name == "histogram_routed":
            by_lh = oblique_layers(name, case["routed"], events, routed_lh)
            result[-1].update(layer_fields(by_lh))
            log("18 layers", f"{name} on train_mhld by hist slots: "
                f"{layer_text(by_lh)}, {smi}")
    lap("18b")

    # -- 18c resume: preempted after 3 chunks, resumed ----------------- #
    with open(os.path.join(TRAIN_DEFAULT, "config.json")) as f:
        dcfg = json.load(f)
    jax_default = dict(np.load(os.path.join(TRAIN_DEFAULT, "forest.npz")))
    dtrain, _ = make_frame(DEFAULT_ROWS, DEFAULT_TEST_ROWS)
    tmp = tempfile.mkdtemp(prefix="phase18_")
    try:
        wd = os.path.join(tmp, "wd")
        kw = dict(DEFAULT_HP, working_dir=wd,
                  resume_training_snapshot_interval_trees=RESUME_INTERVAL)
        t0 = time.perf_counter()
        learner = ydf_tpu_torch.GradientBoostedTreesLearner(device=DEVICE,
                                                            **kw)
        learner._preempt_after_chunks = RESUME_PREEMPT_AFTER
        try:
            learner.train(dtrain)
            raise AssertionError("no TrainingPreempted")
        except port_gbt.TrainingPreempted as e:
            preempted = str(e)
        pre_wall = time.perf_counter() - t0
        done = Snapshots(wd).latest()[2]["completed_iters"]
        assert done == RESUME_INTERVAL * RESUME_PREEMPT_AFTER, done
        t0 = time.perf_counter()
        resumed = ydf_tpu_torch.GradientBoostedTreesLearner(
            device=DEVICE, resume_training=True, **kw).train(dtrain)
        torch.cuda.synchronize()
        res_wall = time.perf_counter() - t0
        rf_ = resumed.forest.to_numpy()
        rk = resumed.training_logs["num_trees"]
        assert rk == dcfg["num_trees"], (rk, dcfg["num_trees"])
        got = forest_hashes(rf_)
        assert got == forest_hashes(jax_default), "resumed != train_default"
        card = CARD_FORESTS.get("train_default")
        if card is not None:
            assert got == forest_hashes(card), "resumed != phase 8's run"
        try:
            ydf_tpu_torch.GradientBoostedTreesLearner(
                device=DEVICE, resume_training=True,
                **dict(kw, max_depth=5)).train(dtrain)
            raise AssertionError("a mismatched resume was accepted")
        except ValueError as e:
            assert "refusing to resume" in str(e), e
        log("18 resume", f"working_dir, a snapshot every {RESUME_INTERVAL} "
            f"iterations, SIGTERM's path after chunk {RESUME_PREEMPT_AFTER}:"
            f" {preempted!r} after {pre_wall:.1f} s; resumed from "
            f"{done} iterations in {res_wall:.1f} s: {rk} trees kept, every "
            "tree == the train_default fixture by hash"
            + (" and == phase 8's uninterrupted card run"
               if card is not None else " (phase 8's run not in this "
                                         "process)")
            + "; a resume with max_depth=5 refused; " + smi)
        lap("18c")

        # -- 18d deadlines: a prefix of the full runs' trees ----------- #
        t0 = time.perf_counter()
        cut = ydf_tpu_torch.GradientBoostedTreesLearner(
            device=DEVICE, maximum_training_duration=DEADLINE_S,
            **DEFAULT_HP).train(dtrain)
        g_wall = time.perf_counter() - t0
        cf = cut.forest.to_numpy()
        ck, ct = (cut.training_logs["num_trees"],
                  cut.training_logs["num_trees_trained"])
        assert ct % 25 == 0 or ct == dcfg["num_trees_trained"]
        assert forest_hashes(cf) == forest_hashes(jax_default, ck), (
            "the GBT's deadline trees are not a prefix of the full run's")
        rtrain, _ = make_frame(RF_ROWS, RF_TEST_ROWS)
        t0 = time.perf_counter()
        rcut = ydf_tpu_torch.RandomForestLearner(
            device=DEVICE, maximum_training_duration=DEADLINE_S,
            **RF_HP).train(rtrain)
        r_wall = time.perf_counter() - t0
        rcf = rcut.forest.to_numpy()
        rT = rcf["feature"].shape[0]
        rexp = np.load(os.path.join(TRAIN_RF, "expected.npz"))
        rf_hashes = forest_hashes(rcf)
        rf_fix = [h.tobytes().hex() for h in rexp["tree_sha256"][:rT]]
        rcard = CARD_FORESTS.get("train_rf")
        if rcard is not None:
            assert rf_hashes == forest_hashes(rcard, rT), (
                "the forest's deadline trees are not a prefix of phase 9's")
        log("18 deadline", f"maximum_training_duration={DEADLINE_S} s (the "
            "clock from train()'s entry): the GBT stopped at "
            f"{ct} iterations ({ck} kept) in {g_wall:.1f} s, its trees == "
            f"the first {ck} of the full run's by hash; the random forest "
            f"kept {rT} of {RF_HP.get('num_trees', 300)} trees in "
            f"{r_wall:.1f} s, "
            + ("== the first of phase 9's card forest by hash, "
               if rcard is not None else "")
            + f"{sum(a == b for a, b in zip(rf_hashes, rf_fix))} of {rT} == "
            f"the train_rf fixture's; {smi}")
        lap("18d")

        # -- 18e telemetry: metrics, trace, cost ----------------------- #
        data = make_data(TRAIN_ROWS, TRAIN_FEATURES)
        hp = dict(TRAIN_HP)

        def ms_a_tree():
            learner = ydf_tpu_torch.GradientBoostedTreesLearner(
                device=DEVICE, **hp)
            model = learner.train(data)
            return model, learner.last_timings["boost_s"] * 1e3 / hp[
                "num_trees"]

        tdir = os.path.join(tmp, "telemetry")
        # [warm, off, on]: the first train of these shapes warms them.
        runs = [ms_a_tree()[1], ms_a_tree()[1]]
        with telemetry.active(tdir):
            m, ms = ms_a_tree()
            runs.append(ms)
            m.predict({c: v[:4096] for c, v in data.items()
                       if c != "label"})
            text = telemetry.metrics_text()
            telemetry.flush()
        off_ms, on_ms = runs[1], runs[2]
        for name in ("ydf_train_iterations_total", "ydf_train_chunk_latency_ns",
                     "ydf_train_last_train_loss", "ydf_serve_requests_total",
                     "ydf_serve_latency_ns", 'subsystem="bin_matrix"'):
            assert name in text, name
        files = os.listdir(tdir)
        trace = [f for f in files if f.startswith("trace-")]
        assert trace and any(f.startswith("metrics-") for f in files), files
        with open(os.path.join(tdir, trace[0])) as f:
            spans = {json.loads(line)["name"] for line in f}
        assert {"train", "train.chunk", "train.tree", "serve.predict",
                "serve.kernel"} <= spans, spans
        log("18 telemetry", f"train_bench's GBT ({hp['num_trees']} trees) "
            f"and a predict of 4,096 rows under telemetry.active: "
            f"metrics_text() names {len(text.splitlines())} lines (the "
            "train, serve and memory families), flush wrote "
            f"{sorted(files)} with spans {sorted(spans)}; ms a tree "
            f"(loop wall / trees) of a warm-up, off, on: "
            + ", ".join(f"{r:.2f}" for r in runs)
            + f" ({on_ms:.2f} on against {off_ms:.2f} off); {smi}")
        lap("18e")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log("18 robust", f"phase 18 wall {time.perf_counter() - t_phase:.1f} s "
        f"(by part, s: {walls})")
    return result


_RANK_WORKER = """
import json, os, sys, time
sys.path.insert(0, sys.argv[5])
import torch
import chip_smoke
import ydf_tpu_torch
from ydf_tpu_torch.learners import gbt as port_gbt
from ydf_tpu_torch.parallel import mesh as pmesh, shards as pshards

rank, port, backend, out = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                            sys.argv[4])
pmesh.init_distributed(f"127.0.0.1:{port}", 2, rank, backend=backend)
card = f"cuda:{rank}" if backend == "nccl" else "cuda:0"
mesh = pmesh.make_mesh([card] * (chip_smoke.MESH_SHARDS // 2))
train, _ = chip_smoke.make_frame(chip_smoke.MESH_RANK_ROWS, 1000)
reads0, stages0 = port_gbt.HOST_READS, pshards.HOST_STAGES
learner = ydf_tpu_torch.GradientBoostedTreesLearner(
    mesh=mesh, **chip_smoke.MESH_RANK_HP)
t0 = time.perf_counter()
model = learner.train(train)
torch.cuda.synchronize()
with open(out, "w") as f:
    json.dump({"hashes": chip_smoke.forest_hashes(
                   chip_smoke.canonical_nan(model.forest.to_numpy())),
               "wall_s": time.perf_counter() - t0,
               "boost_s": learner.last_timings["boost_s"],
               "host_reads": port_gbt.HOST_READS - reads0,
               "host_stages": pshards.HOST_STAGES - stages0,
               "mesh": repr(mesh)}, f)
torch.distributed.destroy_process_group()
"""


def mesh_path(smi, serving):
    """Phase 19: training on a mesh (parallel/mesh.py, parallel/shards.py).
    19 gbt: GradientBoostedTreesLearner(label="label", mesh=) with every
    other default on train_default's frame over MESH_SHARDS data shards
    (four cards when the machine has them, else cuda:0 four times):
    every kept tree == the JAX package's run (the train_default fixture)
    and phase 8's card run by hash, the predictions bitwise, evaluate
    within 1e-12; its launches (each shard's), host reads, ms a tree,
    merge ms a layer and the device's idle share. 19 kernels: every
    launch of shard 0's first tree against its plain version. 19 2x2:
    the same GBT on a 2x2 (data, feature) mesh, a prefix of
    MESH_GBT_PREFIX_TREES trees; the random forest of train_rf's frame
    on 2x2, MESH_RF_TREES trees, against train_rf's trees and phase 9's.
    19 ranks: two processes (NCCL with a card each when there are two
    cards, else gloo with both on cuda:0), two shards each, against the
    one-process four-shard run. 19 timing: the training kernels at the
    shards' shapes. Returns the `kernels` entries of the mesh path."""
    import subprocess
    import tempfile

    import torch

    import ydf_tpu_torch
    from ydf_tpu_torch.learners import gbt as port_gbt
    from ydf_tpu_torch.learners import random_forest as port_rf
    from ydf_tpu_torch.ops import binning, histogram_kernels
    from ydf_tpu_torch.parallel import mesh as pmesh
    from ydf_tpu_torch.parallel import shards as pshards
    from ydf_tpu_torch.serving import bank_scorer

    t_phase = time.perf_counter()
    walls, last = {}, [t_phase]

    def lap(part):
        now = time.perf_counter()
        walls[part] = round(now - last[0], 2)
        last[0] = now

    count = torch.cuda.device_count()
    devices = ([f"cuda:{i}" for i in range(MESH_SHARDS)]
               if count >= MESH_SHARDS else ["cuda:0"] * MESH_SHARDS)
    where = ("distinct cards" if count >= MESH_SHARDS
             else f"one card, cuda:0 {MESH_SHARDS} times")
    with open(os.path.join(TRAIN_DEFAULT, "config.json")) as f:
        cfg = json.load(f)
    jax_forest = canonical_nan(dict(np.load(os.path.join(
        TRAIN_DEFAULT, "forest.npz"))))
    exp = np.load(os.path.join(TRAIN_DEFAULT, "expected.npz"))
    train, test = make_frame(DEFAULT_ROWS, DEFAULT_TEST_ROWS)
    assert frame_sha256(train) == cfg["train_sha256"], "train frame"
    log("19 mesh", f"{count} card(s): the mesh's {MESH_SHARDS} data shards "
        f"on {where} ({devices}); {smi}")

    # -- 19a the 4x1 GBT: the main path, shard 0's launches captured ---- #
    captured = []
    orig = (histogram_kernels.histogram, histogram_kernels.histogram_routed)
    depth = port_gbt.GradientBoostedTreesLearner(label="label",
                                                 device=DEVICE).max_depth
    first_tree = MESH_SHARDS * depth  # every shard's launches of tree 0

    def capture(name, fn):
        def wrapped(*args, **kw):
            if len(captured) < first_tree:
                captured.append((name, args, kw))
            return fn(*args, **kw)
        return wrapped

    mesh = pmesh.make_mesh(devices)
    histogram_kernels.histogram = capture("histogram", orig[0])
    histogram_kernels.histogram_routed = capture("histogram_routed", orig[1])
    try:
        reset_counts(serving)
        for k in histogram_kernels.WIDE_LAUNCHES:
            histogram_kernels.WIDE_LAUNCHES[k] = 0
        reads0, stages0 = port_gbt.HOST_READS, pshards.HOST_STAGES
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        learner = ydf_tpu_torch.GradientBoostedTreesLearner(mesh=mesh,
                                                            **DEFAULT_HP)
        model = learner.train(train)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ev = model.evaluate(test)
        torch.cuda.synchronize()
        counted, others, events = read_counts(serving)
    finally:
        histogram_kernels.histogram, histogram_kernels.histogram_routed = orig
    wide = dict(histogram_kernels.WIDE_LAUNCHES)
    reads = port_gbt.HOST_READS - reads0
    logs = model.training_logs
    trained, kept = logs["num_trees_trained"], logs["num_trees"]
    chunks = -(-trained // min(learner.early_stopping_num_trees_look_ahead,
                               port_gbt.MAX_CHUNK_TREES))
    assert counted["histogram"] == trained * MESH_SHARDS, counted
    assert counted["histogram_routed"] == \
        trained * (depth - 1) * MESH_SHARDS, counted
    assert wide == {k: counted[k] for k in wide}, (wide, counted)
    bank_launches = others[bank_scorer.__name__]
    assert counted["binning"] >= 1 and bank_launches >= 1, (counted, others)
    assert reads == chunks, (reads, chunks)
    assert pshards.HOST_STAGES == stages0, "a host stage inside one process"
    kernel_ms, routed_lh = split_events(events)
    merges = trained * depth
    merge_ms = kernel_ms.pop("mesh_merge", 0.0)
    boost_ms = learner.last_timings["boost_s"] * 1e3
    log("19 gbt", f"GradientBoostedTreesLearner(**{DEFAULT_HP}, mesh="
        f"{MESH_SHARDS}x1).train: wall {wall * 1e3:.1f} ms; stages "
        + " ".join(f"{k}={v * 1e3:.1f}ms" for k, v in
                   learner.last_timings.items())
        + f"; {trained} trees trained, {kept} kept; {boost_ms / trained:.2f}"
        f" ms a tree (loop wall / trees trained); launches {counted} "
        f"({(counted['histogram'] + counted['histogram_routed']) / trained:.0f}"
        f" training-kernel launches a tree, all in the wide mode; routed by "
        f"hist slots {routed_lh}); {reads} host reads ({chunks} chunks, as "
        f"on one device); merge {merge_ms / merges:.4f} ms a layer (CUDA "
        f"events around each of {merges} merges); kernel time (events) "
        + " ".join(f"{k}={v:.3f}ms" for k, v in kernel_ms.items())
        + f"; {smi}")
    lap("19a")

    # -- 19b against the fixture and phase 8 --------------------------- #
    pf = canonical_nan(model.forest.to_numpy())
    assert (kept, trained) == (cfg["num_trees"], cfg["num_trees_trained"]), (
        kept, trained)
    got = forest_hashes(pf)
    want = forest_hashes(jax_forest)
    bad = [t for t in range(kept) if got[t] != want[t]]
    assert not bad, f"mesh trees {bad[:10]} != the JAX package's"
    card = CARD_FORESTS.get("train_default")
    if card is not None:
        assert got == forest_hashes(canonical_nan(card)), "!= phase 8's"
    head = {k: v[:DEFAULT_COMPARE_ROWS] for k, v in test.items()}
    raw = model._raw_scores(head, combine="sum")[:, 0]
    assert np.array_equal(raw.view(np.int32), exp["raw"].view(np.int32)), (
        "mesh model's raw scores != the JAX package's")
    jev = cfg["jax_evaluate"]
    ev_err = max(abs(ev.metrics[k] - jev[k]) for k in jev)
    assert ev_err <= EVAL_SAME_ATOL, (ev.metrics, jev)
    log("19 vs fixture", f"kept {kept} of {trained} (JAX {cfg['num_trees']}"
        f" of {cfg['num_trees_trained']}); all {kept} kept trees == the "
        "train_default fixture by SHA-256 "
        + ("and == phase 8's card run" if card is not None else
           "(phase 8 did not run in this process)")
        + f"; raw scores on {DEFAULT_COMPARE_ROWS} test rows bitwise == "
        f"JAX's; evaluate on {DEFAULT_TEST_ROWS} rows within {ev_err:.3g} "
        f"of JAX's metrics (<= {EVAL_SAME_ATOL})")

    # -- 19c every launch of shard 0's first tree against plain -------- #
    def check_shard0(what):
        """Shard 0's captured launches of tree 0 run again and held
        against their plain versions; (errors by kernel, root args, the
        widest routed layer's args)."""
        err = {"histogram": 0.0, "histogram_routed": 0.0}
        shard0 = [c for k, c in enumerate(captured) if k % MESH_SHARDS == 0]
        assert len(shard0) == depth, len(shard0)
        for name, args, kw in shard0:
            assert kw.get("wide"), f"{name} outside the wide mode"
            got = orig[0 if name == "histogram" else 1](*args, wide=True)
            plain = (histogram_kernels.histogram_plain if name == "histogram"
                     else histogram_kernels.histogram_routed_plain)
            want = plain(*args, wide=True)
            if name == "histogram_routed":
                assert torch.equal(got[1], want[1]) and torch.equal(
                    got[2], want[2]), "routed: new_slot / new_leaf != plain"
                got, want = got[0], want[0]
            err[name] = max(err[name], float((got - want).abs().max()))
            assert torch.equal(got.float(), want.float()), (
                f"{what} {name} on shard 0: rounded shard sum != plain")
        bins = shard0[0][1][0]
        log("19 kernels", f"{what}: shard 0's {len(shard0)} launches of "
            f"tree 0 (1 root, {len(shard0) - 1} routed; {bins.shape[1]} rows "
            f"x {bins.shape[0]} columns a shard): each shard sum rounded to "
            "f32 torch.equal to plain, new_slot / new_leaf torch.equal; the "
            f"f64 shard sums within {max(err.values()):.3g} of plain's")
        return err, shard0[0][1], max((c[1] for c in shard0[1:]),
                                      key=lambda a: a[5])

    err, root_args, routed_args = check_shard0("4x1")
    lap("19c")

    # -- 19d the 2x2 GBT prefix and the 2x2 forest --------------------- #
    mesh22 = pmesh.make_mesh(devices, feature_parallelism=2)
    reset_counts(serving)
    histogram_kernels.SET_TABLE_LAUNCHES = 0
    captured.clear()
    histogram_kernels.histogram = capture("histogram", orig[0])
    histogram_kernels.histogram_routed = capture("histogram_routed", orig[1])
    try:
        t0 = time.perf_counter()
        l22 = ydf_tpu_torch.GradientBoostedTreesLearner(
            mesh=mesh22, **dict(DEFAULT_HP, num_trees=MESH_GBT_PREFIX_TREES))
        m22 = l22.train(train)
        torch.cuda.synchronize()
        wall22 = time.perf_counter() - t0
        c22, _, ev22 = read_counts(serving)
    finally:
        histogram_kernels.histogram, histogram_kernels.histogram_routed = orig
    kernel_ms22 = split_events(ev22)[0]
    t22 = m22.training_logs["num_trees_trained"]
    k22 = m22.training_logs["num_trees"]
    p22 = canonical_nan(m22.forest.to_numpy())
    bad = [t for t, h in enumerate(forest_hashes(p22)) if h != want[t]]
    assert not bad, f"2x2 mesh trees {bad[:10]} != the JAX package's"
    assert c22["histogram"] == t22 * MESH_SHARDS, c22
    sets22 = histogram_kernels.SET_TABLE_LAUNCHES
    assert sets22 == c22["histogram_routed"], (sets22, c22)
    err22, root22, routed22 = check_shard0("2x2")
    log("19 2x2", f"GradientBoostedTreesLearner(num_trees="
        f"{MESH_GBT_PREFIX_TREES}, mesh=2x2): {t22} trained, {k22} kept in "
        f"{wall22 * 1e3:.1f} ms ({l22.last_timings['boost_s'] * 1e3 / t22:.2f}"
        f" ms a tree); all {k22} kept trees == the fixture's first {k22} by "
        f"SHA-256; launches {c22} (the routed kernel takes each row's "
        f"direction from its split column's owner: {sets22} launches with "
        "a row-direction table in this process so far)")
    with open(os.path.join(TRAIN_RF, "config.json")) as f:
        rcfg = json.load(f)
    rexp = np.load(os.path.join(TRAIN_RF, "expected.npz"))
    rtrain, _ = make_frame(RF_ROWS, RF_TEST_ROWS)
    reset_counts(serving)
    t0 = time.perf_counter()
    lrf = ydf_tpu_torch.RandomForestLearner(
        mesh=mesh22, **dict(RF_HP, num_trees=MESH_RF_TREES))
    mrf = lrf.train(rtrain)
    torch.cuda.synchronize()
    wall_rf = time.perf_counter() - t0
    crf = read_counts(serving)[0]
    prf = mrf.forest.to_numpy()
    rf_same = [tree_sha256(prf, t) == rexp["tree_sha256"][t].tobytes().hex()
               for t in range(MESH_RF_TREES)]
    card_rf = CARD_FORESTS.get("train_rf")
    if card_rf is not None:
        same9 = [tree_sha256(prf, t) == tree_sha256(card_rf, t)
                 for t in range(MESH_RF_TREES)]
        assert all(same9), f"2x2 forest trees != phase 9's: {same9}"
    assert sum(rf_same) >= RF_SAME_TREES * MESH_RF_TREES - 1, rf_same
    assert crf["histogram"] == MESH_RF_TREES * MESH_SHARDS, crf
    log("19 rf", f"RandomForestLearner(num_trees={MESH_RF_TREES}, mesh="
        f"2x2) on train_rf's frame: {wall_rf * 1e3:.1f} ms "
        f"({lrf.last_timings['loop_s'] * 1e3 / MESH_RF_TREES:.2f} ms a tree);"
        f" trees == train_rf's by SHA-256: {sum(rf_same)} of "
        f"{MESH_RF_TREES}" + (", all == phase 9's card run"
                              if card_rf is not None else "")
        + f"; launches {crf}")
    lap("19d")

    # -- 19e two processes --------------------------------------------- #
    backend = "nccl" if count >= 2 else "gloo"
    rank_train, _ = make_frame(MESH_RANK_ROWS, 1000)
    one = ydf_tpu_torch.GradientBoostedTreesLearner(
        mesh=pmesh.make_mesh(devices), **MESH_RANK_HP).train(rank_train)
    want_rank = forest_hashes(canonical_nan(one.forest.to_numpy()))
    tmp = tempfile.mkdtemp()
    script = os.path.join(tmp, "rank.py")
    with open(script, "w") as f:
        f.write(_RANK_WORKER)
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    outs = [os.path.join(tmp, f"rank{r}.json") for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, script, str(r), str(port), backend, outs[r], HERE],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(2)]
    texts = []
    try:
        for p in procs:
            texts.append(p.communicate(timeout=300)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, text) in enumerate(zip(procs, texts)):
        assert p.returncode == 0, f"rank {r}: {text[-3000:]}"
    ranks = []
    for o in outs:
        with open(o) as f:
            ranks.append(json.load(f))
    for r, res in enumerate(ranks):
        assert res["hashes"] == want_rank, f"rank {r}'s trees != one process"
    log("19 ranks", f"two processes, backend {backend} ("
        + ("a card each" if backend == "nccl" else
           "both on cuda:0, merges staged through the host")
        + f"), {MESH_SHARDS // 2} shards each, "
        f"GradientBoostedTreesLearner(**{MESH_RANK_HP}) on "
        f"{MESH_RANK_ROWS} rows: every tree == the one-process "
        f"{MESH_SHARDS}-shard run by SHA-256 in both ranks; ms a tree "
        + ", ".join(f"rank {r} {res['boost_s'] * 1e3 / len(want_rank):.2f}"
                    for r, res in enumerate(ranks))
        + "; host reads " + ", ".join(str(res["host_reads"]) for res in ranks)
        + "; host stages (gloo) " + ", ".join(
            str(res["host_stages"]) for res in ranks)
        + f"; meshes {[res['mesh'] for res in ranks]}")
    lap("19e")

    # -- 19f the device's idle share of a profiled 4x1 stretch ---------- #
    prof = profile_train(train, dict(DEFAULT_HP, mesh=mesh,
                                     num_trees=MESH_PROFILE_TREES))
    log("19 profile", f"4x1 mesh, num_trees={MESH_PROFILE_TREES} under "
        f"torch.profiler: loop {prof['loop_ms']:.1f} ms, {prof['kernels']} "
        f"device kernels, {prof['busy_ms']:.3f} ms of device time: the "
        f"device is idle at least {100 * prof['idle_share']:.1f}% of the "
        "loop; largest: " + "; ".join(f"{name[:60]} {ms:.3f} ms"
                                      for name, ms in prof["top"]))
    lap("19f")

    # -- 19g the kernels at the shards' shapes ------------------------- #
    out = []
    n_shard = root_args[0].shape[1]
    rows = {k: v[:n_shard] for k, v in train.items()}
    shapes = (
        ("binning", "4x1", train_inputs(rows, model.binner),
         "binning.cu", "ydf_tpu/ops/binning_pallas.py:60",
         counted["binning"]),
        ("histogram", "4x1", {"root": root_args, "wide": True},
         "histogram.cu", "ydf_tpu/ops/histogram_pallas.py:81",
         counted["histogram"]),
        ("histogram_routed", "4x1", {"routed": routed_args, "wide": True},
         "histogram_routed.cu", "ydf_tpu/ops/histogram_pallas.py:172",
         counted["histogram_routed"]),
        ("histogram", "2x2", {"root": root22, "wide": True},
         "histogram.cu", "ydf_tpu/ops/histogram_pallas.py:81",
         c22["histogram"]),
        ("histogram_routed", "2x2", {"routed": routed22, "wide": True},
         "histogram_routed.cu", "ydf_tpu/ops/histogram_pallas.py:172",
         c22["histogram_routed"]),
    )
    for name, where_, inp, src, replaces, launches in shapes:
        t = measure_train(name, inp)
        log("19 timing", f"{name} on a {where_} shard ({t['shape']}"
            + ("" if name == "binning" else ", wide") + f"): "
            f"{timing_text(t)}, {smi}")
        e = train_entry(name, f"mesh_{where_}", src, replaces, t, launches,
                        (err if where_ == "4x1" else err22).get(name, 0.0),
                        (kernel_ms if where_ == "4x1" else kernel_ms22)
                        .get(name, 0.0))
        if where_ == "4x1" and name != "binning":
            e["merge_ms_a_layer"] = merge_ms / merges
            e["ms_a_tree"] = boost_ms / trained
        out.append(e)
    bank = bank_scorer.build_bank_scorer(model)
    xT = encoded_xT(model, test)
    t = measure(bank_scorer, bank.tables, bank.tables, xT)
    log("19 timing", f"bank_scorer/mesh_4x1 at {xT.shape[1]} rows x "
        f"{xT.shape[0]} features ({kept} trees): kernel {t['ms']:.4f} ms a "
        f"call back to back, {t['device_ms']:.4f} ms on the card "
        f"({t['device_how']}), plain {t['plain_ms']:.2f} ms, bound "
        f"{t['bound_ms']:.4f} ms ({t['bound_by']}; {t['detail']}), {smi}")
    out.append({
        "name": "bank_scorer/mesh_4x1", "route": "cuda",
        "source": "ydf_tpu_torch/csrc/bank_scorer.cu",
        "replaces": "ydf_tpu/serving/pallas_scorer.py:118",
        "launches": bank_launches, "max_abs_err": t["max_abs_err"],
        "ms": t["ms"], "device_ms": t["device_ms"],
        "device_how": t["device_how"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": None, "library_device_ms": None,
        "path_ms": kernel_ms.get("bank_scorer", 0.0),
        "path_how": "CUDA events around each launch",
    })
    lap("19g")
    log("19 mesh", f"phase 19 wall {time.perf_counter() - t_phase:.1f} s "
        f"(by part, s: {walls})")
    return out


_DIST_WORKER = """
import sys
sys.path.insert(0, sys.argv[3])
from ydf_tpu_torch.parallel.worker_service import start_worker

start_worker(int(sys.argv[1]), device=sys.argv[2])
"""


def start_dist_workers(devices, timeout_s=180.0):
    """One worker process per entry of `devices` (sys.executable running
    worker_service.start_worker on a free port); returns (processes,
    addresses) once every worker answers a ping."""
    import socket
    import subprocess
    import tempfile

    from ydf_tpu_torch.parallel.worker_service import WorkerPool

    script = os.path.join(tempfile.mkdtemp(), "worker.py")
    with open(script, "w") as f:
        f.write(_DIST_WORKER)
    procs, addrs = [], []
    for dev in devices:
        with socket.socket() as sk:
            sk.bind(("127.0.0.1", 0))
            port = sk.getsockname()[1]
        procs.append(subprocess.Popen(
            [sys.executable, script, str(port), dev, HERE],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
        addrs.append(f"127.0.0.1:{port}")
    deadline = time.monotonic() + timeout_s
    for p, addr in zip(procs, addrs):
        pool = WorkerPool([addr], timeout_s=5.0)
        while True:
            if p.poll() is not None:
                raise RuntimeError(f"worker {addr} exited: "
                                   + p.stdout.read().decode()[-3000:])
            try:
                if pool.request(0, {"verb": "ping"}, timeout_s=5.0)["ok"]:
                    break
            except OSError:
                pass
            if time.monotonic() > deadline:
                raise RuntimeError(f"worker {addr} never answered")
            time.sleep(0.2)
        pool.close()
    return procs, addrs


def worker_launches(addrs, reset=False, time_launches=False):
    """Each worker process's histogram kernel launch counts, the device
    time of its timed spans by name ([count, ms]: CUDA events around
    each kernel launch, apply_split's ops and the histograms' copy out)
    and its RSS, through the get_telemetry verb: reset=True sets the
    counts and times to 0 after the read, time_launches=True turns the
    timing on."""
    from ydf_tpu_torch.parallel.worker_service import WorkerPool

    pool = WorkerPool(addrs, timeout_s=60.0)
    out = [pool.request(i, {"verb": "get_telemetry",
                            "reset_launches": reset,
                            "time_launches": time_launches})
           for i in range(len(addrs))]
    pool.close()
    return ([r["launches"] for r in out], [r["rss_bytes"] for r in out],
            [r["launch_ms"] for r in out])


def summed_spans(per_worker):
    """The workers' timed spans added by name: {name: [count, ms]}."""
    out = {}
    for spans in per_worker:
        for name, (c, ms) in spans.items():
            acc = out.setdefault(name, [0, 0.0])
            acc[0] += c
            acc[1] += ms
    return out


def capture_dist_layers(manager_cls, tree=0):
    """Wraps manager_cls.routed to record, for each deeper layer of tree
    `tree`, what a worker's routed launch gets: the manager's row state
    before the route (== every worker's), the row-direction tables built
    from the grower's tables and the merged go-left bitmap, the tree's
    f32 operand and Lh; and the manager's leaf ids after the route.
    Returns (records, restore)."""
    import torch

    from ydf_tpu_torch.parallel import dist_worker
    from ydf_tpu_torch.parallel.shards import direction_tables

    records, orig = [], manager_cls.routed

    def routed(self, tables, Lh, B):
        if self.it != tree:
            return orig(self, tables, Lh, B)
        slot, leaf = self.slot.clone(), self.leaf_id.clone()
        out = orig(self, tables, Lh, B)
        dirs = torch.from_numpy(dist_worker.unpack_bits(
            self.pending_route["go_left"], self.n).view(np.uint8)).to(
            self.device)
        records.append(dict(
            slot=slot, leaf=leaf, Lh=Lh, B=B,
            tables=direction_tables(type(tables)(
                *(t.clone() for t in tables)), dirs),
            op=dist_worker.from_wire(self.cur_hist_stats, self.device),
            leaf_after=self.leaf_id.clone()))
        return out

    manager_cls.routed = routed

    def restore():
        manager_cls.routed = orig

    return records, restore


def dist_path(smi, serving):
    """Phase 20: feature-parallel distributed GBT training over RPC
    workers (parallel/worker_service.py, dist_worker.py, dist_gbt.py).
    20 cache: cache_frames' 500,000 train rows binned on the card into a
    cache of DIST_SHARDS feature shards (its files == the JAX package's
    cache of the train_dist fixture). 20 workers: two worker processes,
    cuda:0 and cuda:1 when the machine has two cards, else both on
    cuda:0. 20 dist: the main path, GradientBoostedTreesLearner(
    distributed_workers=..., **DIST_HP).train(cache) then evaluate; every
    tree == the train_dist fixture (the JAX package's distributed run,
    itself == its single machine) by hash, the predictions and raw
    scores bitwise through the bank kernel, evaluate within 1e-12; the
    workers' launches, host reads, ms a tree, RPC ms a layer by verb,
    wire bytes a tree, worker RSS. 20 single: the port's single-device
    GBT from the same cache, every tree == the distributed run's, ms a
    tree. 20 failover: the same distributed train with worker 1 killed
    (SIGKILL) after tree DIST_KILL_AFTER: its shards move to worker 0
    and every tree still matches. 20 kernels: the histogram kernel at
    the workers' shapes (n rows, a shard's columns; f32 and int8)
    torch.equal to its plain version, in this process: the root kernel
    at the root's one slot, the routed kernel at every deeper layer of
    the failover run's first tree as a worker launched it (its row
    state, its row-direction tables from the merged bitmap, Lh), its
    new leaf ids == the manager's route. 20 profile: the manager's
    device time over a profiled stretch on one worker, and that worker's
    device time (CUDA events): the card's idle share. 20 timing: the
    kernels timed at these shapes. A `finally` kills the worker
    processes. Returns the `kernels` entries."""
    import signal
    import tempfile

    import torch

    import ydf_tpu_torch
    from ydf_tpu_torch.dataset.cache import create_dataset_cache
    from ydf_tpu_torch.ops import histogram_kernels
    from ydf_tpu_torch.ops.histogram import prepare_stats_for_hist
    from ydf_tpu_torch.parallel import dist_gbt
    from ydf_tpu_torch.serving import bank_scorer
    from ydf_tpu_torch.utils import telemetry

    t_phase = time.perf_counter()
    walls, last = {}, [t_phase]

    def lap(part):
        now = time.perf_counter()
        walls[part] = round(now - last[0], 2)
        last[0] = now

    count = torch.cuda.device_count()
    devices = [f"{DEVICE}:{i if count >= 2 else 0}" for i in range(2)]
    with open(os.path.join(TRAIN_DIST, "config.json")) as f:
        cfg = json.load(f)
    exp = np.load(os.path.join(TRAIN_DIST, "expected.npz"))
    assert (cfg["rows"], cfg["test_rows"], cfg["feature_shards"],
            cfg["learner"]) == (DIST_ROWS, DIST_TEST_ROWS, DIST_SHARDS,
                                DIST_HP), "train_dist fixture config"
    train, test = cache_frames(DIST_ROWS, DIST_TEST_ROWS)
    assert frame_sha256(train) == cfg["train_sha256"], "train frame"
    assert frame_sha256(test) == cfg["test_sha256"], "test frame"
    tmp = tempfile.mkdtemp()

    # -- 20a the cache, binned on the card ------------------------------ #
    reset_counts(serving)
    t0 = time.perf_counter()
    cache = create_dataset_cache(train, os.path.join(tmp, "c"),
                                 label="label", feature_shards=DIST_SHARDS,
                                 device=DEVICE)
    torch.cuda.synchronize()
    cache_s = time.perf_counter() - t0
    c_cache = read_counts(serving)[0]
    assert c_cache["binning"] >= 1, c_cache
    assert cache_record(cache) == cfg["cache"], (
        "the cache's files != the JAX package's")
    log("20 cache", f"create_dataset_cache(cache_frames' {DIST_ROWS} rows, "
        f"feature_shards={DIST_SHARDS}) on the card in {cache_s:.2f} s "
        f"({c_cache['binning']} binning launches); every file and the "
        f"metadata == the JAX package's cache by SHA-256; shards "
        f"{[cache.shard_col_range(k) for k in range(DIST_SHARDS)]} of "
        f"{cache.binner.num_scalar} columns")
    lap("20a")

    procs = []
    try:
        # -- 20b the workers ------------------------------------------- #
        procs, addrs = start_dist_workers(devices)
        log("20 workers", f"{len(procs)} worker processes ({sys.executable}"
            f" ... start_worker(port, device=...)) on {devices} ("
            + ("a card each" if count >= 2 else
               f"one card: both workers and the manager share cuda:0, "
               f"{count} card(s) on this machine")
            + f"), addresses {addrs}; {smi}")
        lap("20b")

        # -- 20c the main path: distributed train, then evaluate -------- #
        reset_counts(serving)
        worker_launches(addrs, reset=True, time_launches=True)
        reads0 = dist_gbt.HOST_READS
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        learner = ydf_tpu_torch.GradientBoostedTreesLearner(
            distributed_workers=addrs, **DIST_HP)
        model = learner.train(cache)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ev = model.evaluate(test)
        torch.cuda.synchronize()
        counted, others, events = read_counts(serving)
        w_launch, w_rss, w_spans = worker_launches(addrs, reset=True)
        spans = summed_spans(w_spans)
        reads = dist_gbt.HOST_READS - reads0
        d = model.training_logs["distributed"]
        T, depth = DIST_HP["num_trees"], learner.max_depth
        hist_launches = sum(w["histogram"] for w in w_launch)
        routed_launches = sum(w["histogram_routed"] for w in w_launch)
        # One build_histograms a layer but the last, one launch a shard:
        # the root kernel at the root, the routed kernel deeper.
        assert hist_launches == T * DIST_SHARDS, w_launch
        assert routed_launches == T * (depth - 1) * DIST_SHARDS, w_launch
        assert all(w["histogram"] > 0 and w["histogram_routed"] > 0
                   for w in w_launch), w_launch
        assert counted["histogram"] == counted["histogram_routed"] == 0, (
            "the manager launched a histogram kernel", counted)
        routed_lh = {int(k.split("=")[1]): c for k, (c, _) in spans.items()
                     if k.startswith("histogram_routed/Lh=")}
        assert sum(routed_lh.values()) == routed_launches, spans
        assert spans["histogram"][0] == hist_launches, spans
        worker_ms = {k: ms for k, (_, ms) in spans.items()}
        bank_launches = others[bank_scorer.__name__]
        assert bank_launches >= 1, others
        assert reads == T * (1 + depth), (reads, T, depth)
        assert d["recoveries"] == 0, d
        dist_tree_ms = 1e3 * float(np.mean(d["tree_s"]))
        rpc_ms = {v: d["rpc_total_ns"][v] / d["rpc_count"][v] / 1e6
                  for v in d["rpc_count"]}
        layer_rpcs = {v: d["rpc_count"][v] / (T * depth)
                      for v in ("build_histograms", "apply_split")}
        wire = {"requests": (d["rpc_header_bytes"]
                             + d["rpc_payload_bytes"]) / T,
                "histograms": d["reduce_bytes"] / T,
                "bitmaps": d["bitmap_bytes"] / T,
                "stats": d["stats_bytes"] / T}
        log("20 dist", f"GradientBoostedTreesLearner(distributed_workers="
            f"[2 addresses], **{DIST_HP}).train(cache): wall "
            f"{wall * 1e3:.1f} ms ({learner.last_timings}); {T} trees, "
            f"{dist_tree_ms:.2f} ms a tree (mean of the manager's tree "
            f"walls); the workers launched histogram.cu {hist_launches} "
            f"times and histogram_routed.cu {routed_launches} times "
            f"({w_launch}: a root and {depth - 1} deeper layers x "
            f"{DIST_SHARDS} shards a tree; routed by Lh {routed_lh}), the "
            f"manager none; the workers' device time (CUDA events), ms a "
            "tree: " + ", ".join(f"{k} {ms / T:.4f}"
                                 for k, ms in sorted(worker_ms.items()))
            + f" (all {sum(worker_ms.values()) / T:.4f}); {reads} host reads "
            f"({reads / T:.1f} a tree: the operand and one a layer); RPC "
            "ms a call by verb " + ", ".join(
                f"{v} {ms:.3f} ({layer_rpcs.get(v, 0):.2f} a layer)"
                for v, ms in rpc_ms.items())
            + f"; exchange {d['exchange_s']:.3f} s (compute "
            f"{d['compute_s']:.3f}, net {d['net_s']:.3f}, wait "
            f"{d['wait_s']:.3f}), merge {d['merge_s'] * 1e3 / (T * depth):.3f}"
            f" ms a layer; wire bytes a tree " + ", ".join(
                f"{k} {v:.0f}" for k, v in wire.items())
            + f"; worker RSS {w_rss} bytes; manager RSS "
            f"{telemetry.rss_bytes()} bytes; {smi}")
        lap("20c")

        # -- 20d against the fixture ------------------------------------ #
        kept = check_run_trees(exp, "run", model)
        head = {k: v[:cfg["compare_rows"]] for k, v in test.items()}
        assert np.array_equal(np.asarray(model.predict(head)),
                              exp["run/predictions"]), "predictions"
        raw = model._raw_scores(head, combine="sum")[:, 0]
        assert np.array_equal(raw.view(np.int32),
                              exp["run/raw"].view(np.int32)), "raw scores"
        # The reported binomial loss is torch's (the trees are bitwise).
        assert np.allclose(model.training_logs["train_loss"],
                           exp["run/train_loss"], rtol=REPORTED_LOSS_RTOL,
                           atol=0), "train losses"
        jev = cfg["jax_evaluate"]
        ev_err = max(abs(ev.metrics[k] - jev[k]) for k in jev)
        assert ev_err <= EVAL_SAME_ATOL, (ev.metrics, jev)
        log("20 vs fixture", f"all {kept} trees == the train_dist fixture "
            "(the JAX package's distributed GBT, == its single machine) by "
            f"SHA-256 and node counts; predictions and raw scores on "
            f"{cfg['compare_rows']} test rows bitwise (the bank kernel, "
            f"{bank_launches} launches on the path); evaluate on "
            f"{DIST_TEST_ROWS} rows within {ev_err:.3g} of JAX's "
            f"(<= {EVAL_SAME_ATOL})")
        lap("20d")

        # -- 20e the single device from the same cache ------------------- #
        t0 = time.perf_counter()
        l1 = ydf_tpu_torch.GradientBoostedTreesLearner(**DIST_HP)
        single = l1.train(cache)
        torch.cuda.synchronize()
        single_wall = time.perf_counter() - t0
        got = forest_hashes(canonical_nan(model.forest.to_numpy()))
        assert forest_hashes(canonical_nan(single.forest.to_numpy())) == \
            got, "the distributed trees != the single device's"
        single_tree_ms = l1.last_timings["boost_s"] * 1e3 / T
        log("20 single", f"GradientBoostedTreesLearner(**{DIST_HP})"
            f".train(cache) on cuda:0: wall {single_wall * 1e3:.1f} ms, "
            f"{single_tree_ms:.2f} ms a tree; every tree == the "
            f"distributed run's by SHA-256; distributed / single ms a tree "
            f"= {dist_tree_ms:.2f} / {single_tree_ms:.2f} = "
            f"{dist_tree_ms / single_tree_ms:.1f}x")
        lap("20e")

        # -- 20f a real failover ----------------------------------------- #
        killed = []
        orig = dist_gbt.DistGBTManager._tree_boundary

        def killing(self, guard, done, loop):
            if done == DIST_KILL_AFTER and not killed:
                procs[1].send_signal(signal.SIGKILL)
                procs[1].wait()
                killed.append(time.perf_counter())
            return orig(self, guard, done, loop)

        dist_gbt.DistGBTManager._tree_boundary = killing
        layers, restore = capture_dist_layers(dist_gbt.DistGBTManager)
        try:
            t0 = time.perf_counter()
            m2 = ydf_tpu_torch.GradientBoostedTreesLearner(
                distributed_workers=addrs, **DIST_HP).train(cache)
            torch.cuda.synchronize()
            wall2 = time.perf_counter() - t0
        finally:
            dist_gbt.DistGBTManager._tree_boundary = orig
            restore()
        assert {r["Lh"] for r in layers} == set(routed_lh), (
            [r["Lh"] for r in layers], routed_lh)
        assert killed and procs[1].returncode == -signal.SIGKILL, killed
        d2 = m2.training_logs["distributed"]
        assert d2["recoveries"] >= 1, d2
        assert forest_hashes(canonical_nan(m2.forest.to_numpy())) == got, (
            "trees after the failover != the fault-free run's")
        log("20 failover", f"worker 1 ({addrs[1]}) SIGKILLed after tree "
            f"{DIST_KILL_AFTER}: {d2['recoveries']} recoveries (its shard "
            "moved to worker 0 with the manager's state), all "
            f"{T} trees == the fault-free run's by SHA-256; wall "
            f"{wall2 * 1e3:.1f} ms; trees after the kill "
            f"{1e3 * float(np.mean(d2['tree_s'][DIST_KILL_AFTER:])):.2f} ms "
            "a tree on one worker")
        lap("20f")

        # -- 20g the manager's device time, profiled --------------------- #
        worker_launches(addrs[:1], reset=True, time_launches=True)
        prof = profile_train(cache, dict(DIST_HP, num_trees=DIST_PROFILE_TREES,
                                         distributed_workers=addrs[:1]))
        prof_spans = summed_spans(worker_launches(addrs[:1], reset=True)[2])
        # The card's idle share over the profiled loop: the manager's
        # device time (torch.profiler) and the worker's (CUDA events
        # around its kernels, apply_split's ops and the copy out) over
        # the loop's wall; both processes are on cuda:0. Not counted: the
        # worker's small host-to-device copies (tables, bitmap, operand).
        per_tree = prof["loop_ms"] / DIST_PROFILE_TREES
        mgr_ms = prof["busy_ms"] / DIST_PROFILE_TREES
        wk_ms = sum(ms for _, ms in prof_spans.values()) / DIST_PROFILE_TREES
        idle = max(0.0, 1 - (mgr_ms + wk_ms) / per_tree)
        log("20 profile", f"the manager's process under torch.profiler, "
            f"{DIST_PROFILE_TREES} trees on one worker: loop "
            f"{prof['loop_ms']:.1f} ms, {prof['kernels']} device records, "
            f"{prof['busy_ms']:.3f} ms of the manager's device time; "
            "largest: " + "; ".join(f"{name[:60]} {ms:.3f} ms"
                                    for name, ms in prof["top"]))
        log("20 idle", f"a profiled tree: loop {per_tree:.2f} ms, the "
            f"manager's device time {mgr_ms:.3f} ms, the worker's "
            f"{wk_ms:.3f} ms (CUDA events, ms a tree: " + ", ".join(
                f"{k} {ms / DIST_PROFILE_TREES:.4f} in {c}"
                for k, (c, ms) in sorted(prof_spans.items()))
            + f"): cuda:0 is idle {100 * idle:.1f}% of the distributed "
            "loop (its host: the RPCs, pickling, the copies); the "
            f"worker's small host-to-device copies are not counted; {smi}")
        lap("20g")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()

    # -- 20h the kernels at the workers' shapes, against plain ------------ #
    dev = torch.device(DEVICE)
    B = cache.binner.num_bins
    op = layers[0]["op"]
    int8_op = prepare_stats_for_hist(op, "int8")[0]
    n = op.shape[0]
    checked = []
    shard_bins = [torch.from_numpy(np.array(cache.shard_bins(k))).to(
        dev).t().contiguous() for k in range(DIST_SHARDS)]
    root_slot = torch.zeros(n, dtype=torch.int32, device=dev)
    for k, bins_t in enumerate(shard_bins):
        Fk = bins_t.shape[0]
        for quant, x in (("f32", op), ("int8", int8_op)):
            got_h = histogram_kernels.histogram(bins_t, root_slot, x, 1, B)
            want_h = histogram_kernels.histogram_plain(bins_t, root_slot, x,
                                                       1, B)
            assert torch.equal(got_h, want_h), (
                f"root histogram at shard {k}, {quant} != plain")
            checked.append(f"shard {k} Fk={Fk} root {quant}")
            for r in layers:
                got = histogram_kernels.histogram_routed(
                    bins_t, r["slot"], r["leaf"], r["tables"], x, r["Lh"], B)
                want = histogram_kernels.histogram_routed_plain(
                    bins_t, r["slot"], r["leaf"], r["tables"], x, r["Lh"], B)
                assert all(torch.equal(a, b) for a, b in zip(got, want)), (
                    f"routed histogram at shard {k}, Lh={r['Lh']}, {quant} "
                    "!= plain")
                assert torch.equal(got[2], r["leaf_after"]), (
                    f"the routed kernel's leaves at Lh={r['Lh']} != the "
                    "manager's route")
                checked.append(f"shard {k} Fk={Fk} Lh={r['Lh']} {quant}")
    log("20 kernels", f"at the workers' shapes ({n} rows), each torch.equal "
        "to its plain version (the routed kernel's histogram, new slots and "
        "new leaves; its leaves also == the manager's route): "
        + "; ".join(checked))
    lap("20h")

    # -- 20i the kernels timed at the workers' shapes -------------------- #
    out = []
    dist_fields = dict(
        ms_a_tree=dist_tree_ms, single_ms_a_tree=single_tree_ms,
        host_reads_a_tree=reads / T, wire_bytes_a_tree=wire,
        rpc_ms_by_verb=rpc_ms, worker_rss_bytes=w_rss,
        worker_device_ms_a_tree={k: ms / T for k, ms in worker_ms.items()},
        idle_share=idle, idle_how=(
            "1 - (the manager's device time by torch.profiler + the "
            "worker's by CUDA events) / the loop's wall, over "
            f"{DIST_PROFILE_TREES} trees on one worker"))
    t = measure_train("histogram", {"root": (shard_bins[0], root_slot, op,
                                             1, B)})
    log("20 timing", f"histogram at worker shard 0's root ({t['shape']}, "
        f"f32): {timing_text(t)}, {smi}")
    out.append(train_entry("histogram", "dist_root", "histogram.cu",
                           "ydf_tpu/ops/histogram_pallas.py:81", t,
                           hist_launches, 0.0, worker_ms["histogram"]))
    out[-1].update(path_how="CUDA events around each launch in the "
                   "worker processes", **dist_fields)
    routed_args = [(shard_bins[0], r["slot"], r["leaf"], r["tables"], op,
                    r["Lh"], B) for r in layers]
    t = measure_train("histogram_routed", {
        "routed": max(routed_args, key=lambda a: a[5])})
    log("20 timing", f"histogram_routed at worker shard 0's deepest layer "
        f"of tree 0 ({t['shape']}, f32): {timing_text(t)}, {smi}")
    out.append(train_entry(
        "histogram_routed", "dist", "histogram_routed.cu",
        "ydf_tpu/ops/histogram_pallas.py:172", t, routed_launches, 0.0,
        sum(ms for k, ms in worker_ms.items()
            if k.startswith("histogram_routed/"))))
    by_lh = {}
    for args in routed_args:
        lh = args[5]
        if lh in by_lh:
            continue
        tl = measure_train("histogram_routed", {"routed": args},
                           timing_only=True)
        by_lh[lh] = {
            "launches": routed_lh[lh], "device_ms": tl["device_ms"],
            "device_how": tl["device_how"], "bound_ms": tl["bound_ms"],
            "path_ms": worker_ms[f"histogram_routed/Lh={lh}"]}
    out[-1].update(path_how="CUDA events around each launch in the worker "
                   "processes", **layer_fields(by_lh), **dist_fields)
    log("20 layers", "histogram_routed on the workers by hist slots (timed "
        "here on shard 0's layers of tree 0; launches and path times from "
        f"the workers' CUDA events): {layer_text(by_lh)}, {smi}")
    bank = bank_scorer.build_bank_scorer(model)
    xT = encoded_xT(model, test)
    t = measure(bank_scorer, bank.tables, bank.tables, xT)
    log("20 timing", f"bank_scorer/dist at {xT.shape[1]} rows x "
        f"{xT.shape[0]} features ({kept} trees): kernel {t['ms']:.4f} ms a "
        f"call back to back, {t['device_ms']:.4f} ms on the card "
        f"({t['device_how']}), plain {t['plain_ms']:.2f} ms, bound "
        f"{t['bound_ms']:.4f} ms ({t['bound_by']}; {t['detail']}), {smi}")
    out.append({
        "name": "bank_scorer/dist", "route": "cuda",
        "source": "ydf_tpu_torch/csrc/bank_scorer.cu",
        "replaces": "ydf_tpu/serving/pallas_scorer.py:118",
        "launches": bank_launches, "max_abs_err": t["max_abs_err"],
        "ms": t["ms"], "device_ms": t["device_ms"],
        "device_how": t["device_how"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": None, "library_device_ms": None,
        "path_ms": split_events(events)[0].get("bank_scorer", 0.0),
        "path_how": "CUDA events around each launch",
    })
    # The binner's numerical columns as the f32 values binning takes
    # (cache_frames' "treat" is an integer column).
    numerical = cache.binner.feature_names[:cache.binner.num_numerical]
    t = measure_train("binning", train_inputs(
        {k: np.asarray(v, np.float32) if k in numerical else v
         for k, v in train.items()}, cache.binner))
    log("20 timing", f"binning at the cache's shape ({t['shape']}): "
        f"{timing_text(t)}, {smi}")
    out.append(train_entry("binning", "dist_cache", "binning.cu",
                           "ydf_tpu/ops/binning_pallas.py:60", t,
                           c_cache["binning"], 0.0, None))
    lap("20i")
    log("20 dist", f"phase 20 wall {time.perf_counter() - t_phase:.1f} s "
        f"(by part, s: {walls})")
    return out


def root_shape_text(args):
    """The root histogram's launch shape at a captured call."""
    from ydf_tpu_torch.ops import histogram_kernels as hk

    bins_t, _, stats, L, B = args
    shape = hk.root_launch_shape(bins_t.shape[1], bins_t.shape[0], L, B,
                                 stats.shape[1], hk.root_cell_bytes(stats))
    return (f"{shape.blocks} blocks (G {shape.G}, Fb {shape.Fb}, chunks "
            f"{shape.chunks} of {shape.rows} rows), cell stride "
            f"{hk.cell_stride(stats.shape[1])}")


if __name__ == "__main__":
    sys.exit(main())

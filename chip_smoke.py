"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --profile off,pair   # device time by op, nothing else

Drives the port's main path: the x8 (d4) TTA predictor over the full-width
flagship UnetPlusPlusStar, with weights made from a seed, with the decoder's
``pallas_tail`` off and under each of its modes (v1, pair, pair_up). Phases:

1. device: the card's name and power limit; build the four CUDA kernel
   libraries from ``eyediseasesegmentation_tpu_torch/csrc`` (one nvcc per
   source, started together) and print the build times;
2. kernel K1 (fused axial attention) against its plain PyTorch version at the
   five main-path shapes: fp32 (TF32 off) on the wmma variant, bf16 on the
   sm90 variant (TMA + wgmma projection, mma.sync attention), with
   CUDA-event times of the kernel, the plain version (fp32) and the library
   composition in bf16 (cuBLAS projection, einsum products, softmax: the
   plain version run in bf16), per shape and per forward; and at the vessel
   path's five shapes (the flagship at base_dim 19 for 608², L 38 and 19,
   16 views), which take the wmma variant in fp32 and the sm90 variant in
   bf16 (padded to 64 and 32, the padded keys masked), with the wmma
   kernel's bf16 time at the same shapes beside it (``_run(...,
   force="wmma")``, also held to the plain version);
3. kernels K3 (scSE-gated conv), K2 (decode pair, ``up_part0`` off and on) at
   the four main-path node shapes and K4 (plain conv) at two of them: fp32 at
   batch 1 (the wmma variants) and bf16 at batch 24 (the sm90 variants: TMA
   and wgmma) against their plain versions, with CUDA-event times of the
   kernel, the plain version and the library composition the logical path
   runs for the same stage (eager gating + ``torch.cat`` + cuDNN conv + BN +
   ReLU [+ conv2 + pooled sum]); each kernel's bound on this card from the
   bytes and operations of the call;
4. slice parity: one 1024² fp32 forward on the GPU with ``pallas_tail`` off
   and under each mode (``fast_min_res=256``) against the same forward on the
   CPU (plain path), with the launches per forward and variant (wmma, K1
   included); and the same forward in bf16 under each mode against bf16
   ``off`` (max|Δlogit| / max|logit|, at most ``ROUTE_BOUND``; the sm90
   variants, K1 included);
5. the bench workload: d4 TTA in bf16 on 3 random 2848×4288 uint8 images,
   images/sec and peak memory, off and under each mode, with the launch
   counts of the run per variant (every K1, K3 and K2 launch sm90); K4, which no
   model calls, is driven through its public function at the decode node's
   conv2 shape;
6. ``test_tta`` at full width: a run directory made by the port alone
   (``config.json`` of the flagship under ``pair_up``, ``inference_dtype``
   bf16, and ``checkpoints/best.ckpt``: the seed-0 weights through
   ``convert.torch_to_flax`` and ``train.checkpoint.save_checkpoint``),
   loaded by ``load_model_for_inference`` on the card; 3 synthetic
   fundus-like 2848×4288 images with lesion masks from a numpy seed go
   through every step of ``test_tta`` but the file decode and encode:
   ``tta_pass`` (d4 predict + per-image AP and the 19-threshold sweep on the
   card, batch 2, so the second batch is padded), ``pr_curve_report`` and
   the device half of the mask export (``masks_to_uint8``). The card
   machine has no matplotlib, which ``test_tta``'s PR figure needs, so the
   file leg runs on the CPU tests only. Checks K1 (12) and K2 (4) launches a
   forward, all sm90; ``mean_auc`` in [0, 1]; thresholds from the sweep's
   list; uint8 masks in {0, 1} at full size; and ``batch_image_metrics`` of
   the first batch on the card against the CPU (counts equal, ``ap_sum``
   within 1e-5 relative). Prints the pass, ``predict`` alone and metrics
   plus export, with the peak device memory;
7. training (PR 8): one fp32 train step of a small flagship, card against
   CPU (and in fp64); 1 + 8 full-width train steps (no kernel launch);
   one ``eval_step`` (K1 on sm90); ``train_model`` for one epoch on 5
   synthetic 2848×4288 images (``pallas_tail=pair_up`` in its config, so its
   validation launches K2 too), whose run directory the next phase reads;
8. the experiment drivers (``pipeline.py``, ``pipeline_vessel.py``) stage
   by stage at full width, the PR/ROC figure aside (no matplotlib on the
   card's machine): ``test_tta``'s steps on phase 7's run (d4, 2 test
   images written as files, masks and prob images written, then
   ``export_result``'s five CSVs checked); the ``multiscale`` alias at
   ``multiscale_max_res=1024`` (1 + 4 + 16 forwards); tile mode
   (``build_patches`` + ``build_dataframe`` on 2 full-size images, 8 / 2
   patches in the train / val lists, ``train_model`` with ``data_type:
   "tile"``, ``tiled_pass``: 6 windows of 2048 an image, each a d4 batch at
   1024²); the vessel driver's stages (the flagship at base_dim 19 on 4
   DRIVE-shaped images padded to 608², ``advanced_vessel``, one epoch, d4
   without resize scored by AUC-ROC, ``export_result_vessel``), whose K1
   launches are all sm90; and ``tiled_predict`` and the multiscale tiled
   legs of an fp32 base_dim-4 flagship, card against CPU on logits within
   ``SLICE_TOL`` × max|logit|. Launch counts are held per path (each path
   between a reset and a read of the counts);
9. ensemble and zoo: ``ensemble.predict``'s steps, the figure
   aside, over two flagship members (phase 7's run and a second run
   directory in phase 6's form with weights of another seed; bf16,
   ``pair_up``) on phase 8's 2 test images in one batch of 2: the
   ensemble within ``ENSEMBLE_TOL`` of the members' mean, K1 24 / K2 8
   launches (2 member forwards, all sm90), ``mean_auc`` in [0, 1], uint8
   masks in {0, 1} at full size; one bf16 d4 ``predict`` of one full-size
   image for each of 33 zoo models at registry width (``ZOO_FULL``:
   the ResNet, EfficientNet and MobileNetV3 families, the classic U-Net,
   UNet 3+, smp's Linknet / PSPNet / DeepLabV3 / PAN / MAnet, the
   transformer families (the Swin-tiny and Swin-small attention U-Nets,
   SwinformerStar, SegFormerStar, TransUNet R50 / B16, TransUnet_V2),
   misc.py's (HRNet-48, the DoubleU-Nets on ResNet-50 and VGG, UneXt50,
   the dense HED-UNet, DC-UNet, ResUNet++, HuBMAP, and ``gated`` / ``medt``
   at 512², ``ZOO_SCALE``: their score tensors at 1024² do not fit), none
   of which launches a kernel, and the models that launch kernels: the
   axial UNet++, K1 6 a forward, and the
   flagship on ``BoTSER50_Imagenet`` under pair_up, K1 6 and K2 4 a
   forward, all sm90), images/sec and peak memory per model; and one fp32
   64² forward of every registered name (built for 64² where its
   parameters depend on the input size; and of Unet / UNet++ on the axial
   encoder at base_dim 2, Unet on densenet121 and the BoTSER50_Imagenet
   flagship at base_dim 2, K1 6 and K2 4 on wmma) on the card against the
   CPU within ``SLICE_TOL`` × max|logit|;
10. GAN fine-tuning and the host code: ``GanTrainer.fit`` at GanConfig's
    widths (SegFormerStar / mit_b0 generator in fp32 at 512², patches of
    128², d_weight 0.01, rates 1e-4, batch 2) for 2 epochs on a tree the
    port's ``make_idrid_tree`` writes (lesion SE, 4 train and 2 test
    images), with ``best_gan.ckpt`` loaded into a fresh trainer (the same
    probabilities), then 1 + 8 timed steps on one batch and a timed
    ``evaluate_ap``, with the peak memory; one step of a small GAN
    (``classic_unet`` at filters (4, 8), 32², patches of 8) on the card
    against the CPU from the same weights (losses at 1e-5 relative, each
    leaf's update within 1e-3 of its largest, or in fp64 where fp32 cannot
    hold that); 8 steps of each ported optimizer past ``adamw`` / ``adam``
    / ``sgd`` and ``radam_lookahead`` on the base_dim-2 flagship's modules
    that span its three parameter groups, card against CPU within 1e-5 of
    each leaf's max; the full-width flagship's parameter count and the
    FLOPs of one 1024² view from ``utils.summary.cost_estimate`` on the
    CPU's plain path. No kernel launches in the phase.
11. the training options (ROADMAP item E): the elastic, grid and optical
    distortions and ``clahe_rgb`` on a 1024² synthetic fundus, card against
    CPU at the same draws (images within 1e-4 × 255, masks equal but at
    pixels whose source coordinate lies within 1e-3 px of a rounding
    boundary), with ms per call and CLAHE's peak memory; phase 7's
    full-width train step (1 + 8 steps) under ``advanced``, ``easy``,
    ``easy_v2`` and ``medium``, and with ``remat`` (per-block
    checkpointing: ms/step and peak memory against the run without); one
    fp32 train step of the flagship at 256² with and without ``remat`` on
    the card (DropBlock on, cuDNN deterministic): loss, gradients and
    running statistics agree; ``Trainer(encoder_weights=...)`` at full
    width from a stand-in se_resnet50 ``.pth`` written with ``torch.save``
    (random values under the real names), its report and the stem conv
    equal to the file. No kernel launches in the phase; resuming from a
    JAX ``best_full.ckpt`` is held by the CPU tests only (no flax here).
12. multi-GPU (``parallel.mesh``) on the one card: ranks spawned by
    ``parallel.mesh.spawn`` (the kernels built once by this process
    before), at world size 1 over NCCL and at world size 2 with both ranks
    on cuda:0 over gloo (the ranks on cuDNN's heuristics). Each world: one
    fp32 train step of the flagship at 256² (batch 2, SGD, DropBlock on)
    data-parallel against the same step unsharded (a ``{"data": 1,
    "model": n}`` mesh: every rank the whole batch): the loss and the
    updated parameters at remat parity's card-against-card bounds, the
    running statistics at 1e-4 (``MG_PARITY_BOUNDS``), the gradients
    reported; 1 + 1
    full-width dp steps (bf16, ``advanced``, AdamW: the first loss within
    1e-2 of the unsharded step's, ms/step and peak memory per rank); one
    sharded d4 ``predict`` of 3 raw 2848×4288 images in bf16 under each
    ``pallas_tail`` mode against the unsharded one (K1 / K3 / K2 launches
    per rank held); ``tiled_predict_sharded`` against ``tiled_predict``
    (both blends, phase 8's 2048-windows at 1024²); the sharded ensemble
    (one member per rank) against ``EnsemblePredictor``;
    ``spatial_flagship_predict`` at full width, 1024², fp32, against the
    eval forward, with the peak memory of each; one data-parallel GAN step
    (fp64) against one unsharded. A rank's failure fails the run.

Any failure exits non-zero before the last line. The last line is
``{"ok": true, "device": {...}}``; the line before it lists the kernels.
``--routes`` runs only the bf16 route check and prints its ratios without
holding them to a bound (how the bound's baseline was measured, on the
previous kernels). ``--profile train`` prints the device time by op of one
full-width train step (forward, backward and the optimizer) instead. The
profiles are taken through ``utils.profiling.trace``, the port's tracer,
which also writes each region's Chrome trace (to a temporary directory
here).
Needs a CUDA device and the repository beside this file; imports no JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
SEED = 0
FULL_HW = (2848, 4288)      # IDRiD native resolution
SCALE = 1024
BATCH = 3
WARMUP, ITERS = 2, 8
TAIL_WARMUP, TAIL_ITERS = 1, 3      # the pallas_tail modes: fewer iterations
VIEWS = 8 * BATCH                   # images of one d4 forward
FAST_MIN_RES = 256                  # the bench workload's (4 kernel nodes)
# tolerances, as fractions of max|reference|
K1_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
CONV_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
CSUM_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
SLICE_TOL = 1e-3
# bf16 forward under each pallas_tail route against bf16 off, max|Δlogit| /
# max|logit|: twice what the wmma K3 and K2 gave on the same inputs before
# their bf16 path moved to the sm90 body (``--routes`` on that version;
# PERF.md, section 6)
ROUTE_BASELINE = {"v1": 2.8514e-02, "pair": 3.2258e-02, "pair_up": 3.2258e-02}
ROUTE_BOUND = {m: 2 * b for m, b in ROUTE_BASELINE.items()}
# the card's peaks (NVIDIA H100 SXM data sheet): dense bf16 tensor-core rate
# and device-memory rate
PEAK_FLOPS, PEAK_BYTES = 989e12, 3.35e12
TAIL_MODES = {"off": None, "v1": "v1", "pair": "pair", "pair_up": "pair_up"}

# (L, Cq, Cv or None for self-attention, heads, dv, sequences per call at
# 24 views of 1024², calls per forward) of K1's main-path callers
K1_SHAPES = {
    "layer4_first": (64, 512, None, 8, 64, 1536, 2),
    "layer4_shared": (32, 512, None, 8, 64, 768, 4),
    "x_0_0": (32, 2048, 64, 4, 16, 768, 2),
    "x_1_1": (64, 1024, 32, 4, 8, 1536, 2),
    "x_0_1": (64, 256, 64, 4, 16, 1536, 2),
}
# the same callers on the vessel path: the flagship at base_dim 19 for
# 608² (L 38 and 19), 16 views (d4 TTA at batch 2): K1's sm90 variant, the
# sequences padded to 64 and 32
VESSEL_SCALE, VESSEL_VIEWS = 608, 16
VESSEL_K1_SHAPES = {
    f"vessel_{name}": (L * VESSEL_SCALE // SCALE, cq, cv, H, dv,
                       VESSEL_VIEWS * (L * VESSEL_SCALE // SCALE), calls)
    for name, (L, cq, cv, H, dv, _, calls) in K1_SHAPES.items()}
# part channels → cout @ resolution of the decode nodes on the kernel route
# at 24 views of 1024² (x_0_2 only with fast_min_res=256)
NODE_SHAPES = {
    "x_3_3": ([256, 64], 64, 512),
    "x_2_3": ([256, 64, 64], 64, 512),
    "x_1_3": ([256, 64, 64, 64], 64, 512),
    "x_0_2": ([128, 256, 256, 256], 64, 256),
}
K4_SHAPES = {"conv1_x_1_3": (448, 64, 512), "conv2": (64, 64, 512)}
SOURCES = {
    "axial_attention": ("axial_attention.cu",
                        "eyediseasesegmentation_tpu/ops/axial_attention.py:90"),
    "scse_conv": ("scse_conv.cu",
                  "eyediseasesegmentation_tpu/ops/pallas_scse_conv.py:80"),
    "decode_pair": ("decode_pair.cu",
                    "eyediseasesegmentation_tpu/ops/pallas_decode_pair.py:64"),
    "conv3x3": ("conv3x3.cu",
                "eyediseasesegmentation_tpu/ops/pallas_conv.py:40"),
}
MODEL_PARAMS = {"encoder_name": "BoTSER50_Axial_Imagenet_3",
                "decoder_attention_type": "scse", "base_dim": SCALE // 32,
                "decoder_channels": (256, 128, 64, 32, 16), "classes": 1}
TTA_IMAGES, TTA_BATCH = 3, 2        # test_tta phase: the 2nd batch is padded
TTA_MODE = "pair_up"
AP_SUM_RTOL = 1e-5
# the train phase: tools/bench_train.py's configuration
TRAIN_CONFIG = {
    "dataset_name": "IDRiD", "lesion_type": "EX", "augmentation": "advanced",
    "scale_size": SCALE, "batch_size": 2, "learning_rate": 1e-3,
    "weight_decay": 1e-5, "is_fp16": True, "model_name": "unetplusplusstar",
    "model_params": {"encoder_name": "BoTSER50_Axial_Imagenet_3",
                     "decoder_attention_type": "scse",
                     "base_dim": SCALE // 32, "classes": 1},
    "criterion": {"bce": 0.8, "log_dice": 0.2}, "pos_weights": [500.0],
    "optimizer": "adamw", "num_workers": 2, "tensorboard": False}
TRAIN_WARMUP, TRAIN_STEPS = 1, 8
PARITY_SIZE = 128                   # card against CPU: base_dim 4
TRAIN_LOSS_RTOL = 1e-4
# fp32 gradients of the whole network carry rounding noise of a median few
# 1e-3 of a leaf's max (tests/test_torch_train_step.py measures it against
# an fp64 run); held as the CPU tests hold the port to JAX
TRAIN_GRAD_LEAF, TRAIN_GRAD_FLOOR, TRAIN_GRAD_MEDIAN = 1e-1, 1e-3, 5e-2
# in fp64 the card and the CPU compute the same gradients to 1e-3 of every
# leaf's max; the floor covers leaves whose exact gradient vanishes by an
# invariance (an attention norm's bias), which are rounding noise
FP64_LOSS_RTOL, FP64_GRAD_LEAF, FP64_GRAD_FLOOR = 1e-10, 1e-3, 1e-9
TREE_IMAGES = 5                     # train_model: 4 train, 1 val
# phase 7's run (and the tile run): the train configuration with the decode
# tail on K2, so that its validation and the pipeline phase launch it
TREE_CONFIG = dict(TRAIN_CONFIG, model_params=dict(
    TRAIN_CONFIG["model_params"], pallas_tail=TTA_MODE,
    fast_min_res=FAST_MIN_RES))
# the pipeline phase
PIPE_IMAGES = 2                     # lesion test images, one batch of 2
PATCH_WINDOW = 256                  # build_patches' (the reference's)
TILE_TRAIN, TILE_VAL = 8, 2         # patches in the tile-mode lists
TILES_PER_IMAGE = 6                 # windows of 2048 over 2848×4288
MULTISCALE_FORWARDS = 1 + 4 + 16    # scales 1, 2, 4 at max_res 1024
VESSEL_HW, VESSEL_IMAGES = (584, 565), 4    # DRIVE's size
VESSEL_CONFIG = dict(
    TRAIN_CONFIG, dataset_name="DRIVE", lesion_type="Vessel_DRIVE",
    augmentation="advanced_vessel", scale_size=VESSEL_SCALE,
    model_params=dict(TRAIN_CONFIG["model_params"],
                      base_dim=VESSEL_SCALE // 32))
CPU_TILED_HW = (300, 400)           # card against CPU: 4 windows of 256
RESULT_CSVS = ("sn", "ppv", "sp", "iou", "dice")
# phase 9: the ensemble's members, the zoo at full width, the card against
# the CPU on every registered name
ENSEMBLE_SEED = SEED + 20           # the second member's weights
ENSEMBLE_TOL = 1e-6                 # ensemble against the members' mean
AXIAL = "BoTSER50_Axial_Imagenet_3"
# the flagship on the BoTSER50 without the axial layer4: its decoder's
# cross-axial gates run K1, its tail K2 (pair_up)
BOTSER50_IMAGENET = {"encoder_name": "BoTSER50_Imagenet",
                     "decoder_attention_type": "scse",
                     "pallas_tail": TTA_MODE, "fast_min_res": FAST_MIN_RES}
ZOO_FULL = {"resnet34_unet32": {}, "UnetPlusPlus": {
                "encoder_name": AXIAL, "decoder_attention_type": "scse"},
            "resnet50_attunet": {}, "seresnext50_fpncat128": {},
            "resnet34_deeplab128": {}, "classic_unet": {},
            "Unet3Plus_Base": {}, "Linknet": {}, "PSPNet": {},
            "DeepLabV3": {}, "PAN": {}, "MAnet": {}, "b4_unet32": {},
            "mobilenetv3_attunet": {}, "b2_fpn_cat": {},
            "swin_tiny_attunet": {}, "swin_small_attunet": {},
            "SwinformerStar": {}, "SegFormerStar": {}, "transunet_r50": {},
            "transunet_b16": {}, "TransUnet_V2": {}, "hrnet48": {},
            "resnet50_doubleunet": {}, "vgg_doubleunet": {},
            "unet_resnext50_ssl": {}, "hed_denseunet": {}, "dcunet": {},
            "resunetplusplus": {}, "hubmap_kaggle": {},
            "gated": {"input_size": 512}, "medt": {"input_size": 512},
            "unetplusplusstar": BOTSER50_IMAGENET}
# the MedT rows run at 512²: their axial attention holds every L×L score
# tensor whole, as JAX's does; at 1024² the first block of ``gated`` scores
# 8 heads × 512² over 8 views × 512 columns, 32 GiB per fp32 tensor, and
# several are alive at once (4 GiB each at 512²)
ZOO_SCALE = {"gated": 512, "medt": 512}
# launches a forward: layer4 of the axial UNet++ (3 blocks, K1); the
# BoTSER50_Imagenet flagship's gates on x_0_0, x_1_1 and x_0_1 in H and W
# (K1) and its 4 tail nodes (K2)
ZOO_KERNELS_PER_FORWARD = {
    "UnetPlusPlus": {"axial_attention": 6},
    "unetplusplusstar": {"axial_attention": 6, "decode_pair": 4}}
ZOO_PARITY_SIZE = 64                # card against CPU: the axial ones and
                                    # the flagship at base_dim 2, the models
                                    # with an input_size field built for it
# phase 10: GAN fine-tuning at GanConfig's widths (the JAX GanTrainer's
# default generator), on a tree the port's make_idrid_tree writes
GAN_CONFIG = {"generator": "SegFormerStar",
              "generator_params": {"encoder_name": "mit_b0"},
              "image_size": 512, "patch_size": 128, "d_weight": 0.01,
              "g_learning_rate": 1e-4, "d_learning_rate": 1e-4,
              "num_epochs": 2, "eval_every": 2, "seg_loss": "bce"}
GAN_TRAIN, GAN_TEST, GAN_BATCH, GAN_STEPS = 4, 2, 2, 8
GAN_RELOAD_TOL = 1e-5               # a reloaded best_gan.ckpt's probabilities
# card against CPU: one step of a small GAN (the CPU tests' configuration)
GAN_SMALL = {"generator": "classic_unet",
             "generator_params": {"filters": (4, 8), "classes": 1},
             "image_size": 32, "patch_size": 8, "d_weight": 0.01,
             "g_learning_rate": 1e-3, "d_learning_rate": 1e-3,
             "seg_loss": "bce"}
GAN_LOSS_RTOL, GAN_UPDATE_TOL = 1e-5, 1e-3
# the adversarial term is d_weight·mean(1 − D(fake)) with D(fake) near 1 on
# raw [0, 255] patches: fp32 knows it to half an ulp of 1 times d_weight
GAN_ADV_ATOL = GAN_SMALL["d_weight"] * 2.0 ** -22
# the optimizers card against CPU: the seven names the CPU tests hold to
# optax and a lookahead wrapper, on the small flagship's modules that span
# its three groups (tests/test_torch_optim.py's REST_SLICE)
OPT_NAMES = ("rms", "radam", "ranger", "lamb", "diffgrad", "novograd",
             "madgrad", "radam_lookahead")
OPT_SLICE = ("encoder.seresnet.stem_conv", "encoder.seresnet.stem_bn",
             "encoder.seresnet.layer1_block0", "decoder.x_0_0.h_catt",
             "decoder.x_0_4", "segmentation_head")
OPT_STEPS, OPT_TOL, OPT_LR, OPT_WD = 8, 1e-5, 1e-2, 0.05
# phase 11: the training options of ROADMAP's item E. The distortions and
# CLAHE on a full-size 1024² image, card against CPU at the same draws
POLICY_IMG_TOL = 1e-4 * 255
POLICY_EDGE = 1e-3                  # px from a nearest-rounding boundary
POLICY_NAMES = ("advanced", "easy", "easy_v2", "medium")
# remat card-vs-card parity: the flagship at 256² (base_dim 8), fp32,
# batch 2, DropBlock on, cuDNN deterministic; with and without remat
REMAT_SIZE = 256
REMAT_LOSS_RTOL, REMAT_STAT_TOL, REMAT_GRAD_TOL = 1e-6, 1e-6, 1e-5
# a gradient leaf within max(REMAT_GRAD_TOL · its max, floor · the largest
# gradient): a leaf whose exact gradient vanishes by an invariance is
# rounding noise, and the card's atomic adds make two runs without remat
# differ by 1.3e-7 of the largest gradient in fp32 (1.3e-16 in fp64)
REMAT_GRAD_FLOOR = {"fp32": 1e-6, "fp64": 1e-14}
# encoder_weights: a stand-in se_resnet50 .pth (torch's names and shapes,
# random values): layers 0-4 and last_linear
SENET_STAGES = ((64, 3), (128, 4), (256, 6), (512, 3))
# phase 12: multi-GPU on the one card: world size 1 over NCCL, world size 2
# with both ranks on cuda:0 over gloo (NCCL takes one rank per device)
MG_WORLDS = ((1, "nccl"), (2, "gloo"))
MG_PARITY_SIZE = 256                # the train parity: remat parity's size
MG_TIMED_STEPS = 2                  # full-width dp steps; the 1st compared
MG_LOSS_RTOL = 1e-2                 # bf16 dp step against the unsharded one
MG_PREDICT_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
MG_SPATIAL_TOL = 1e-3               # × max|logit|, fp32, full width
MG_GAN_LOSS_RTOL, MG_GAN_UPDATE_TOL = 1e-10, 1e-6   # fp64
# the dp parity step against the unsharded one: (loss, running statistics,
# updated parameters) as fractions of each leaf's max: remat parity's
# card-against-card bounds for the loss and the parameters; the statistics
# at 1e-4, as the split batch reorders the fp32 sums of x and x² whose
# difference is the variance (E[x²] − E[x]² cancels: 1.39e-5 measured at
# world size 2, PERF.md; the CPU tests hold the same step exact in fp64)
MG_PARITY_BOUNDS = (REMAT_LOSS_RTOL, 1e-4, REMAT_GRAD_TOL)


class SmokeFailure(Exception):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def time_ms(fn, reps, warm=3):
    import torch
    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def k1_shape(shape):
    return K1_SHAPES.get(shape) or VESSEL_K1_SHAPES[shape]


def k1_inputs(shape, dtype, device, gen):
    """Random folded-attention operands at one main-path shape."""
    import torch
    L, cq, cv, H, dv, b, _ = k1_shape(shape)
    dkq = 8
    cross = cv is not None
    nkq = H * (2 * dkq + (0 if cross else dv))

    def rnd(*s, scale=1.0, positive=False):
        t = torch.randn(*s, generator=gen, device=device) * scale
        return t.abs() if positive else t

    x_q = rnd(b, L, cq).to(dtype)
    x_v = rnd(b, L, cv).to(dtype) if cross else x_q
    w_kq = rnd(cq, nkq, scale=cq ** -0.5)
    w_v = rnd(cv, H * dv, scale=cv ** -0.5) if cross else None
    kq_aff = (rnd(nkq, positive=True), rnd(nkq, scale=0.1))
    v_aff = ((rnd(H * dv, positive=True), rnd(H * dv, scale=0.1)) if cross
             else None)
    r = [rnd(n, L, L) for n in (dkq, dkq, dv)]
    # the folded attention_norm scales each logit term to about unit
    # variance, as the BatchNorm it comes from does
    logit_aff = (rnd(H * 3, scale=dkq ** -0.5, positive=True),
                 rnd(H * 3, scale=0.1))
    out_aff = (rnd(2 * H * dv, positive=True), rnd(2 * H * dv, scale=0.1))
    return ([x_q, x_v, w_kq, w_v, kq_aff, v_aff, *r, logit_aff, out_aff],
            dict(heads=H, dkq=dkq, dv=dv))


def k1_work(shape):
    """(operations, bytes) of one bf16 K1 call at a main-path shape: the
    projections and the five attention products; each operand read once and
    the output written once."""
    L, cq, cv, H, dv, b, _ = k1_shape(shape)
    dkq = 8
    cross = cv is not None
    nkq = H * (2 * dkq + (0 if cross else dv))
    nv = H * dv
    flops = 2 * b * L * cq * nkq + (2 * b * L * cv * nv if cross else 0)
    flops += 2 * b * H * L * L * (3 * dkq + 2 * dv)
    elems = (b * L * cq + (b * L * cv if cross else 0) + cq * nkq
             + (cv * nv if cross else 0) + b * L * nv + dv * L * L)
    return flops, 2 * elems + 4 * 2 * dkq * L * L


def bound_ms(flops, nbytes):
    """The least time the card could take, and which side sets it."""
    t_ops, t_bytes = 1e3 * flops / PEAK_FLOPS, 1e3 * nbytes / PEAK_BYTES
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def phase_kernel(device):
    """K1 against its plain version at the main-path shapes and at the
    vessel path's (L 38 and 19, padded by the sm90 kernel): fp32 on the
    wmma variant, bf16 on the sm90 variant. Per-forward sums over the 12
    calls of each path in bf16; at the vessel shapes also the wmma kernel's
    bf16 time (forced through ``_run``, which counts no launch)."""
    import torch
    from eyediseasesegmentation_tpu_torch.ops import _build
    from eyediseasesegmentation_tpu_torch.ops import axial_attention as AK

    gen = torch.Generator(device=device).manual_seed(SEED)
    lib = _build.load("axial_attention")
    worst = 0.0
    paths = {name: dict.fromkeys(("ms", "plain_ms", "lib_ms", "wmma_ms",
                                  "flops", "nbytes"), 0.0)
             for name in ("main", "vessel")}
    shapes = {}
    for path, table in (("main", K1_SHAPES), ("vessel", VESSEL_K1_SHAPES)):
        acc = paths[path]
        for shape, (L, cq, cv, H, dv, b, calls) in table.items():
            line = [f"K1 {shape} L={L} b={b}:"]
            for dname, tol in K1_TOL.items():
                dtype = getattr(torch, dname)
                args, kw = k1_inputs(shape, dtype, device, gen)
                # the variant is a function of dtype and shapes: wmma in
                # fp32, sm90 in bf16 on both paths
                var = AK.variant(dtype, L, H, kw["dkq"], dv, cq, cv or cq,
                                 [args[0].data_ptr(), args[1].data_ptr()],
                                 cv is None)
                want_var = "sm90" if dtype == torch.bfloat16 else "wmma"
                check(var == want_var, f"K1 {shape} {dname}: variant {var}")
                before = getattr(AK, f"launches_{var}")
                got = AK.axial_attention(*args, dtype=dtype, **kw)
                torch.cuda.synchronize()
                check(getattr(AK, f"launches_{var}") == before + 1,
                      f"K1 {shape} {dname}: the {var} kernel did not run")
                ref_args = list(args)
                ref_args[0], ref_args[1] = args[0].float(), args[1].float()
                ref = AK.axial_attention_reference(
                    *ref_args, dtype=torch.float32, **kw)
                err = (got.float() - ref).abs().max().item()
                bound = tol * ref.abs().max().item()
                line.append(f"{dname} {var} max_abs_err={err:.3e} "
                            f"(<= {bound:.3e})")
                check(got.shape == ref.shape and got.dtype == dtype,
                      f"K1 {shape} {dname}: shape/dtype {tuple(got.shape)} "
                      f"{got.dtype}")
                check(err <= bound, f"K1 {shape} {dname}: max_abs_err {err}"
                                    f" > {bound}")
                worst = max(worst, err)
                if dtype == torch.bfloat16:   # the paths' dtype
                    t_k = time_ms(lambda: AK.axial_attention(
                        *args, dtype=dtype, **kw), 10)
                    t_p = time_ms(lambda: AK.axial_attention_reference(
                        *ref_args, dtype=torch.float32, **kw), 10)
                    t_l = time_ms(lambda: AK.axial_attention_reference(
                        *args, dtype=dtype, **kw), 10)
                    f, nb = k1_work(shape)
                    b_ms, b_by = bound_ms(f, nb)
                    line.append(f"bf16 kernel {t_k:.4f} ms plain {t_p:.4f} "
                                f"ms library {t_l:.4f} ms bound {b_ms:.4f} "
                                f"ms ({b_by})")
                    t_w = 0.0
                    if path == "vessel":    # the wmma kernel at the same call
                        t_w, w_err = k1_wmma(lib, args, kw, ref)
                        line.append(f"wmma kernel {t_w:.4f} ms "
                                    f"max_abs_err={w_err:.3e}")
                        check(w_err <= bound, f"K1 {shape} bf16 wmma: "
                                              f"max_abs_err {w_err} > {bound}")
                    for k, v in zip(("ms", "plain_ms", "lib_ms", "wmma_ms",
                                     "flops", "nbytes"),
                                    (t_k, t_p, t_l, t_w, f, nb)):
                        acc[k] += calls * v
                    shapes[shape] = {"kernel_ms": t_k, "plain_ms": t_p,
                                     "library_ms": t_l, "bound_ms": b_ms,
                                     "bound_by": b_by, "calls": calls,
                                     "variant": var}
                    if path == "vessel":
                        shapes[shape]["wmma_ms"] = t_w
                del args, got, ref, ref_args
            print(" | ".join(line), flush=True)
        acc["bound_ms"], acc["bound_by"] = bound_ms(acc.pop("flops"),
                                                    acc.pop("nbytes"))
        wmma = (f", wmma kernel {acc['wmma_ms']:.4f} ms" if path == "vessel"
                else "")
        print(f"K1 per forward of the {path} path (12 calls, bf16, sm90): "
              f"kernel {acc['ms']:.4f} ms{wmma}, plain {acc['plain_ms']:.4f} "
              f"ms, library {acc['lib_ms']:.4f} ms, bound "
              f"{acc['bound_ms']:.4f} ms ({acc['bound_by']})", flush=True)
    torch.cuda.empty_cache()
    main, vessel = paths["main"], paths["vessel"]
    return {"max_abs_err": worst, "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["lib_ms"],
            "variant": "sm90", "shapes": shapes,
            "vessel": {"variant": "sm90", "ms": vessel["ms"],
                       "wmma_ms": vessel["wmma_ms"],
                       "plain_ms": vessel["plain_ms"],
                       "library_ms": vessel["lib_ms"],
                       "bound_ms": vessel["bound_ms"],
                       "bound_by": vessel["bound_by"]}}


def k1_wmma(lib, args, kw, ref):
    """(ms, max_abs_err against ``ref``) of K1's wmma kernel on a bf16 call,
    forced through the op's marshalling (``_run``), which counts no launch."""
    import torch
    from eyediseasesegmentation_tpu_torch.ops import axial_attention as AK

    stream = torch.cuda.current_stream().cuda_stream

    def kernel():
        rc, out, var = AK._run(lib, stream, *args, kw["heads"], kw["dkq"],
                               kw["dv"], torch.bfloat16, force="wmma")
        check(rc == 0 and var == "wmma", f"K1 wmma: CUDA error {rc}")
        return out

    got = kernel()
    torch.cuda.synchronize()
    err = (got.float() - ref).abs().max().item()
    return time_ms(kernel, 10), err


def conv_inputs(chs, cout, res, batch, dtype, device, gen):
    """Random operands of one decode-node stage: parts, raw gates, the two
    convs' weights and folded-BN affines (outputs of about unit size)."""
    import torch

    def rnd(*s, scale=1.0):
        return torch.randn(*s, generator=gen, device=device) * scale

    C = sum(chs)
    return dict(
        parts=[rnd(batch, c, res, res).to(dtype) for c in chs],
        gate_c=torch.sigmoid(rnd(batch, C)),
        sse_k=rnd(C, scale=C ** -0.5), sse_b=rnd(1)[0],
        k1=rnd(cout, C, 3, 3, scale=(9 * C) ** -0.5),
        s1=rnd(cout).abs() + 0.5, b1=rnd(cout, scale=0.1),
        k2=rnd(cout, cout, 3, 3, scale=(9 * cout) ** -0.5),
        s2=rnd(cout).abs() + 0.5, b2=rnd(cout, scale=0.1))


def library_stage(a, pair, up0=False):
    """What the logical path runs for the same stage, from PyTorch's own
    operators: eager scSE gating of the parts (fp32-promoted, as
    ``SCSEAttention`` leaves them), ``torch.cat``, cuDNN conv in the compute
    dtype, BN affine, ReLU; with ``pair`` also conv2 and the pooled sum."""
    import torch
    import torch.nn.functional as F

    parts = list(a["parts"])
    dt = parts[0].dtype
    if up0:
        parts[0] = F.interpolate(parts[0], scale_factor=(2, 1),
                                 mode="bilinear", align_corners=False)
    w = a["sse_k"].to(dt)
    t, off = None, 0
    for p in parts:
        c = p.shape[1]
        tp = (p * w[off:off + c, None, None]).sum(1, keepdim=True,
                                                  dtype=torch.float32)
        t = tp if t is None else t + tp
        off += c
    gate_s = torch.sigmoid(t + a["sse_b"])
    gated, off = [], 0
    for p in parts:
        c = p.shape[1]
        gated.append((p * (a["gate_c"][:, off:off + c, None, None]
                           + gate_s)).to(dt))
        off += c

    def conv_bn_relu(x, k, s, b):
        y = F.conv2d(x, k.to(dt), padding=1)
        return torch.relu(y * s.to(dt).view(1, -1, 1, 1)
                          + b.to(dt).view(1, -1, 1, 1))

    y = conv_bn_relu(torch.cat(gated, 1), a["k1"], a["s1"], a["b1"])
    if not pair:
        return y
    y = conv_bn_relu(y, a["k2"], a["s2"], a["b2"])
    return y, y.sum((2, 3), dtype=torch.float32)


def conv_work(chs, cout, res, batch, elem, pair=False, up0=False):
    """(operations, bytes) of one decode-node kernel call: the conv products
    (and the gate's logit and product, 3 per input value); parts, weights and
    gates read once, the output (and the channel sums) written once."""
    C, px = sum(chs), batch * res * res
    flops = (2 * 9 * C * cout + 3 * C) * px
    in_elems = px * C - (px * chs[0] // 2 if up0 else 0)   # half-height part
    nbytes = elem * (in_elems + 9 * C * cout + px * cout) + 4 * batch * C
    if pair:
        flops += 2 * 9 * cout * cout * px
        nbytes += elem * 9 * cout * cout + 4 * batch * cout
    return flops, nbytes


def rel_err(got, ref):
    ref = ref.float()
    return ((got.float() - ref).abs().max().item(), ref.abs().max().item())


def phase_conv_kernels(device):
    """K3, K2 (both forms) and K4 against their plain versions at the
    main-path node shapes; returns the per-forward sums for the kernels
    line (bf16, 24 views, the four nodes of ``fast_min_res=256``)."""
    import torch
    from eyediseasesegmentation_tpu_torch.ops import conv as CK
    from eyediseasesegmentation_tpu_torch.ops import decode_pair as PK
    from eyediseasesegmentation_tpu_torch.ops import scse_conv as SK

    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    keys = ("ms", "plain_ms", "library_ms", "flops", "bytes")
    out = {k: dict.fromkeys(keys, 0.0) | {"max_abs_err": 0.0}
           for k in ("scse_conv", "decode_pair", "decode_pair_up", "conv3x3")}

    def gate_args(a):
        return a["parts"], a["gate_c"], a["sse_k"], a["sse_b"]

    def variants(a):
        """name → (kernel call, plain call, library call, pair, up0,
        parts)."""
        g = gate_args(a)
        c1 = (a["k1"], a["s1"], a["b1"])
        c2 = (a["k2"], a["s2"], a["b2"])
        half = dict(a, parts=[a["parts"][0][:, :, ::2].contiguous()]
                    + a["parts"][1:])
        gh = gate_args(half)
        return {
            "scse_conv": (
                lambda: SK.scse_conv3x3_bn_relu(*g, *c1),
                lambda: SK.scse_conv3x3_bn_relu_reference(*g, *c1),
                lambda: library_stage(a, False), False, False, a["parts"]),
            "decode_pair": (
                lambda: PK.scse_conv3x3_pair(*g, *c1, *c2),
                lambda: PK.scse_conv3x3_pair_reference(*g, *c1, *c2),
                lambda: library_stage(a, True), True, False, a["parts"]),
            "decode_pair_up": (
                lambda: PK.scse_conv3x3_pair(*gh, *c1, *c2, up_part0=True),
                lambda: PK.scse_conv3x3_pair_reference(*gh, *c1, *c2,
                                                       up_part0=True),
                lambda: library_stage(half, True, up0=True), True, True,
                half["parts"]),
        }

    def compare(tag, name, got, ref, dname, acc):
        """Hold a kernel's output(s) against the plain version's."""
        pairs = [("", got, ref, CONV_TOL[dname])]
        if isinstance(got, tuple):
            pairs = [("y2 ", got[0], ref[0], CONV_TOL[dname]),
                     ("csum ", got[1], ref[1], CSUM_TOL[dname])]
        text = []
        for what, g, r, tol in pairs:
            check(g.shape == r.shape, f"{tag}: {what}shape {tuple(g.shape)}")
            err, top = rel_err(g, r)
            text.append(f"{what}max_abs_err={err:.3e} (<= {tol * top:.3e})")
            check(err <= tol * top, f"{tag}: {what}max_abs_err {err} > "
                                    f"{tol * top}")
            if what != "csum ":
                acc["max_abs_err"] = max(acc["max_abs_err"], err)
        return f"{dname} " + " ".join(text)

    mods = {"scse_conv": SK, "decode_pair": PK, "decode_pair_up": PK}
    for node, (chs, cout, res) in NODE_SHAPES.items():
        for dname, batch in (("float32", 1), ("bfloat16", VIEWS)):
            dtype = getattr(torch, dname)
            a = conv_inputs(chs, cout, res, batch, dtype, device, gen)
            for name, (kern, plain, lib, pair, up0, parts) in variants(
                    a).items():
                tag = f"{name} {node} {dname}"
                # the variant is a function of dtype, width, alignment and
                # part channels: wmma in fp32, sm90 in bf16 at these nodes
                var = SK.variant(dtype, res, [q.data_ptr() for q in parts],
                                 chs)
                check(var == ("sm90" if dtype == torch.bfloat16 else "wmma"),
                      f"{tag}: variant {var}")
                before = getattr(mods[name], f"launches_{var}")
                got = kern()
                torch.cuda.synchronize()
                check(getattr(mods[name], f"launches_{var}") == before + 1,
                      f"{tag}: the {var} kernel did not run")
                line = [f"{name} {node} {sum(chs)}->{cout}@{res} b={batch} "
                        f"{var}:",
                        compare(tag, name, got, plain(), dname, out[name])]
                del got
                if dtype == torch.bfloat16:
                    t_k = time_ms(kern, 5, warm=1)
                    t_p = time_ms(plain, 2, warm=0)
                    t_l = time_ms(lib, 5, warm=1)
                    f, nb = conv_work(chs, cout, res, batch, 2, pair, up0)
                    b_ms, b_by = bound_ms(f, nb)
                    line.append(f"kernel {t_k:.4f} ms plain {t_p:.4f} ms "
                                f"library {t_l:.4f} ms bound {b_ms:.4f} ms "
                                f"({b_by})")
                    for k, v in zip(keys, (t_k, t_p, t_l, f, nb)):
                        out[name][k] += v
                    out[name]["variant"] = var
                print(" | ".join(line), flush=True)
                torch.cuda.empty_cache()
            del a
            torch.cuda.empty_cache()

    import torch.nn.functional as F
    out["conv3x3"]["shapes"] = {}
    for shape, (cin, cout, res) in K4_SHAPES.items():
        for dname, batch in (("float32", 1), ("bfloat16", VIEWS)):
            dtype = getattr(torch, dname)
            a = conv_inputs([cin], cout, res, batch, dtype, device, gen)
            x, c1 = a["parts"][0], (a["k1"], a["s1"], a["b1"])

            def lib():
                y = F.conv2d(x, c1[0].to(dtype), padding=1)
                return torch.relu(y * c1[1].to(dtype).view(1, -1, 1, 1)
                                  + c1[2].to(dtype).view(1, -1, 1, 1))

            # the variant is a function of dtype, width and alignment: the
            # wmma kernel in fp32, the sm90 kernel in bf16 at these widths
            var = CK.variant(dtype, res, x.data_ptr())
            check(var == ("sm90" if dtype == torch.bfloat16 else "wmma"),
                  f"conv3x3 {shape} {dname}: variant {var}")
            before = getattr(CK, f"launches_{var}")
            got = CK.conv3x3_bn_relu(x, *c1)
            torch.cuda.synchronize()
            check(getattr(CK, f"launches_{var}") == before + 1,
                  f"conv3x3 {shape} {dname}: the {var} kernel did not run")
            ref = CK.conv3x3_bn_relu_reference(x, *c1)
            line = [f"conv3x3 {shape} {cin}->{cout}@{res} b={batch} {var}:",
                    compare(f"conv3x3 {shape} {dname}", "conv3x3", got, ref,
                            dname, out["conv3x3"])]
            del got, ref
            if dtype == torch.bfloat16:
                t_k = time_ms(lambda: CK.conv3x3_bn_relu(x, *c1), 5, warm=1)
                t_p = time_ms(lambda: CK.conv3x3_bn_relu_reference(x, *c1), 2,
                              warm=0)
                t_l = time_ms(lib, 5, warm=1)
                f = 2 * 9 * cin * cout * batch * res * res
                nb = 2 * (batch * res * res * (cin + cout) + 9 * cin * cout)
                b_ms, b_by = bound_ms(f, nb)
                line.append(f"kernel {t_k:.4f} ms plain {t_p:.4f} ms library "
                            f"{t_l:.4f} ms bound {b_ms:.4f} ms ({b_by})")
                for k, v in zip(keys, (t_k, t_p, t_l, f, nb)):
                    out["conv3x3"][k] += v
                out["conv3x3"]["variant"] = var
                out["conv3x3"]["shapes"][shape] = {
                    "kernel_ms": t_k, "plain_ms": t_p, "library_ms": t_l,
                    "bound_ms": b_ms, "bound_by": b_by}
            print(" | ".join(line), flush=True)
            del a, x, c1
            torch.cuda.empty_cache()

    for name, acc in out.items():
        acc["bound_ms"], acc["bound_by"] = bound_ms(acc.pop("flops"),
                                                    acc.pop("bytes"))
        print(f"{name} summed over its shapes (bf16, b={VIEWS}): kernel "
              f"{acc['ms']:.4f} ms, plain {acc['plain_ms']:.4f} ms, library "
              f"{acc['library_ms']:.4f} ms, bound {acc['bound_ms']:.4f} ms "
              f"({acc['bound_by']})", flush=True)
    return out


def kernel_modules():
    from eyediseasesegmentation_tpu_torch.ops import (axial_attention, conv,
                                                      decode_pair, scse_conv)
    return {"axial_attention": axial_attention, "scse_conv": scse_conv,
            "decode_pair": decode_pair, "conv3x3": conv}


VARIANT_KERNELS = ("axial_attention", "scse_conv", "decode_pair", "conv3x3")


def reset_counts():
    for name, mod in kernel_modules().items():
        mod.launches = 0
        if name in VARIANT_KERNELS:
            mod.launches_sm90 = mod.launches_wmma = 0


def read_counts():
    return {name: mod.launches for name, mod in kernel_modules().items()}


def read_variant_counts():
    """{kernel: {"sm90": launches, "wmma": launches}} of every kernel."""
    mods = kernel_modules()
    return {name: {v: getattr(mods[name], f"launches_{v}")
                   for v in ("sm90", "wmma")} for name in VARIANT_KERNELS}


def check_variants(tag, by_variant, want):
    """Every launch of K1, K3 and K2 took the ``want`` variant."""
    for name in ("axial_attention", "scse_conv", "decode_pair"):
        other = "wmma" if want == "sm90" else "sm90"
        check(by_variant[name][other] == 0,
              f"{tag}: {name} launches by variant {by_variant[name]}, "
              f"expected only {want}")


def expected_counts(mode, forwards):
    """Launches of ``forwards`` forwards with ``fast_min_res=256``: 12 K1
    always, and the four tail nodes through K3 (v1) or K2 (pair, pair_up)."""
    return {"axial_attention": 12 * forwards,
            "scse_conv": 4 * forwards if mode == "v1" else 0,
            "decode_pair": 4 * forwards if mode in ("pair", "pair_up") else 0,
            "conv3x3": 0}


def build_model(dtype, device, state=None, mode="off", seed=SEED):
    import torch
    from eyediseasesegmentation_tpu_torch import models as zoo

    params = dict(MODEL_PARAMS, pallas_tail=TAIL_MODES[mode],
                  fast_min_res=FAST_MIN_RES)
    model = zoo.get_model("unetplusplusstar", params, training=False,
                          dtype=dtype, device="cpu")
    if state is None:
        zoo.init_random(model, torch.Generator().manual_seed(seed))
    else:
        model.load_state_dict(state)
    return model.to(device)


def phase_slice(device):
    """fp32 1024² forward: GPU (kernels), with pallas_tail off and under each
    mode, against CPU (plain path)."""
    import torch

    cpu_model = build_model(torch.float32, "cpu")
    state = cpu_model.state_dict()
    gen = torch.Generator().manual_seed(SEED + 1)
    x = torch.randn(1, 3, SCALE, SCALE, generator=gen)
    with torch.inference_mode():
        t0 = time.perf_counter()
        want = cpu_model(x)
        t_cpu = time.perf_counter() - t0
    del cpu_model
    bound = SLICE_TOL * want.abs().max().item()
    for mode in TAIL_MODES:
        gpu_model = build_model(torch.float32, device, state, mode)
        reset_counts()
        with torch.inference_mode():
            t0 = time.perf_counter()
            got = gpu_model(x.to(device)).cpu()
            t_gpu = time.perf_counter() - t0
        counts = read_counts()
        check(counts == expected_counts(mode, 1),
              f"slice {mode}: launches {counts}, expected "
              f"{expected_counts(mode, 1)}")
        check_variants(f"slice {mode}", read_variant_counts(), "wmma")
        check(bool(torch.isfinite(got).all()), f"slice {mode}: non-finite "
                                               "logits")
        err = (got - want).abs().max().item()
        print(f"slice parity {SCALE}² fp32 base_dim={SCALE // 32} "
              f"pallas_tail={mode}: max_abs_err={err:.3e} (<= {bound:.3e}), "
              f"max|logit|={want.abs().max().item():.4f}, launches {counts},"
              f" GPU {t_gpu:.2f} s (first call), CPU {t_cpu:.2f} s",
              flush=True)
        check(got.shape == want.shape == (1, 1, SCALE, SCALE),
              f"slice {mode}: shape {tuple(got.shape)}")
        check(err <= bound, f"slice {mode}: max_abs_err {err} > {bound}")
        del gpu_model
        torch.cuda.empty_cache()


def phase_routes(device, hold=True):
    """bf16 1024² forward under each pallas_tail route against bf16 off, on
    the same weights and input: max|Δlogit| / max|logit| of off, held to
    ``ROUTE_BOUND`` (with ``hold``), and every K3 and K2 launch sm90."""
    import torch

    gen = torch.Generator().manual_seed(SEED + 5)
    x = torch.randn(2, 3, SCALE, SCALE, generator=gen).to(device,
                                                          torch.bfloat16)
    want, ratios = None, {}
    for mode in TAIL_MODES:
        model = build_model(torch.bfloat16, device, mode=mode)
        reset_counts()
        with torch.inference_mode():
            got = model(x).float()
        torch.cuda.synchronize()
        check(got.shape == (2, 1, SCALE, SCALE) and
              bool(torch.isfinite(got).all()),
              f"routes {mode}: shape {tuple(got.shape)} or non-finite logits")
        counts, by_variant = read_counts(), read_variant_counts()
        check(counts == expected_counts(mode, 1),
              f"routes {mode}: launches {counts}, expected "
              f"{expected_counts(mode, 1)}")
        if want is None:
            want = got
            continue
        top = want.abs().max().item()
        ratios[mode] = (got - want).abs().max().item() / top
        line = (f"bf16 route check {SCALE}² b=2 pallas_tail={mode} against "
                f"off: max|Δlogit| / max|logit| = {ratios[mode]:.4e} "
                f"(max|logit| {top:.4f})")
        if hold:
            check_variants(f"routes {mode}", by_variant, "sm90")
            bound = ROUTE_BOUND[mode]
            line += f" (<= {bound:.4e}), launches by variant {by_variant}"
            check(ratios[mode] <= bound,
                  f"routes {mode}: {ratios[mode]} > {bound}")
        print(line, flush=True)
        del model
        torch.cuda.empty_cache()
    return ratios


def bench_predictor(device, mode):
    import torch
    from eyediseasesegmentation_tpu_torch.infer.tta import TTAPredictor

    torch.backends.cudnn.benchmark = True
    model = build_model(torch.bfloat16, device, mode=mode)
    cfg = {"dataset_name": "IDRiD", "gray": False, "scale_size": SCALE}
    return TTAPredictor(model, cfg, tta="d4", ori_hw=FULL_HW)


def phase_bench(device, mode):
    """The bench workload: d4 TTA, bf16, full-resolution batch. Returns the
    launch counts of the run."""
    import torch

    predictor = bench_predictor(device, mode)
    warmup, iters = ((WARMUP, ITERS) if mode == "off"
                     else (TAIL_WARMUP, TAIL_ITERS))
    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    for batch in range(BATCH, 0, -1):
        try:
            imgs = [torch.randint(0, 256, (batch, *FULL_HW, 3), generator=gen,
                                  device=device, dtype=torch.uint8)
                    for _ in range(2)]
            torch.cuda.reset_peak_memory_stats()
            reset_counts()                       # the main path starts here
            for i in range(warmup):
                probs = predictor.predict(imgs[i % 2])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(iters):
                probs = predictor.predict(imgs[i % 2])
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            counts = read_counts()               # ... and ends here
            by_variant = read_variant_counts()
            break
        except torch.cuda.OutOfMemoryError:
            print(f"bench {mode}: batch {batch} does not fit", flush=True)
            imgs = probs = None
            torch.cuda.empty_cache()
    else:
        raise SmokeFailure(f"bench {mode}: no batch fits")
    forwards = warmup + iters
    check(counts == expected_counts(mode, forwards),
          f"bench {mode}: launches {counts} in {forwards} forwards, expected "
          f"{expected_counts(mode, forwards)}")
    check_variants(f"bench {mode}", by_variant, "sm90")
    check(tuple(probs.shape) == (batch, *FULL_HW),
          f"bench {mode}: output shape {tuple(probs.shape)}")
    check(bool(torch.isfinite(probs).all()), f"bench {mode}: non-finite "
                                             "output")
    check(probs.min().item() >= 0.0 and probs.max().item() <= 1.0,
          f"bench {mode}: probabilities outside [0, 1]")
    ips = batch * iters / dt
    peak = torch.cuda.max_memory_allocated()
    used = {k: v for k, v in counts.items() if v}
    print(f"bench d4 x8 TTA bf16 pallas_tail={mode}: batch {batch} of "
          f"{FULL_HW[0]}x{FULL_HW[1]} at {SCALE}², {iters} iters after "
          f"{warmup} warm-ups: {ips:.4f} images/sec "
          f"({1e3 * dt / iters:.2f} ms per batch), peak memory "
          f"{peak / 2**30:.3f} GiB, launches {used} in {forwards} forwards "
          f"(K1 / K3 / K2 by variant {by_variant['axial_attention']} / "
          f"{by_variant['scse_conv']} / {by_variant['decode_pair']})",
          flush=True)
    del predictor, imgs, probs
    torch.cuda.empty_cache()
    return counts, by_variant


def phase_conv3x3_path(device):
    """K4 has no caller in any model: its path is its public function,
    driven here at the decode node's conv2 shape (64 → 64 at 512², 24
    views, bf16), where it takes the sm90 kernel. Returns the launch count of
    the call."""
    import torch
    from eyediseasesegmentation_tpu_torch.ops import conv as CK

    cin, cout, res = K4_SHAPES["conv2"]
    gen = torch.Generator(device=device).manual_seed(SEED + 4)
    a = conv_inputs([cin], cout, res, VIEWS, torch.bfloat16, device, gen)
    reset_counts()
    y = CK.conv3x3_bn_relu(a["parts"][0], a["k1"], a["s1"], a["b1"])
    torch.cuda.synchronize()
    counts = read_counts()
    by_variant = read_variant_counts()["conv3x3"]
    check(tuple(y.shape) == (VIEWS, cout, res, res) and
          y.dtype == torch.bfloat16, f"conv3x3 path: {tuple(y.shape)}")
    check(bool(torch.isfinite(y).all()) and y.min().item() >= 0.0,
          "conv3x3 path: non-finite or negative output after ReLU")
    check(counts["conv3x3"] == 1 and by_variant == {"sm90": 1, "wmma": 0},
          f"conv3x3 path: launches {counts}, by variant {by_variant}")
    print(f"conv3x3 path: conv3x3_bn_relu {cin}->{cout}@{res} b={VIEWS} bf16,"
          f" launches {counts['conv3x3']} (by variant {by_variant})",
          flush=True)
    return counts["conv3x3"], by_variant


def synthetic_fundus(rng, hw):
    """A fundus-like uint8 image (circular field of view, smooth colour
    field, noise, 4 bright blob lesions) and its {0, 1} lesion mask."""
    import numpy as np
    h, w = hw
    yy = np.linspace(-1.0, 1.0, h, dtype=np.float32)[:, None]
    xx = np.linspace(-1.0, 1.0, w, dtype=np.float32)[None, :]
    fov = (yy / 0.96) ** 2 + (xx / 0.96) ** 2 < 1.0
    img = np.empty((h, w, 3), np.float32)
    img[..., 0] = 120 + 30 * np.sin(3.1 * xx)
    img[..., 1] = 60 + 20 * np.cos(2.7 * yy)
    img[..., 2] = 30 + 10 * np.sin(3.1 * (xx + yy))
    img += rng.standard_normal((h, w, 3), dtype=np.float32) * 8.0
    mask = np.zeros((h, w), bool)
    for _ in range(4):
        by, bx = rng.uniform(-0.5, 0.5, 2)
        r = rng.uniform(0.03, 0.08)
        blob = np.exp(-((yy - by) ** 2 + (xx - bx) ** 2) / (2 * r * r))
        img[..., 0] += 120 * blob
        img[..., 1] += 110 * blob
        mask |= blob > 0.4
    img = np.clip(img * fov[..., None], 0, 255).astype(np.uint8)
    return img, (mask & fov).astype(np.float32)


class ArrayTestSet:
    """``TestSegmentation`` over arrays in memory: the same samples (GT
    through ``reference_gt_roundtrip`` at ``scale``) without the file
    decode."""

    def __init__(self, images, masks, scale):
        self.images, self.masks, self.scale = images, masks, scale

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i):
        from eyediseasesegmentation_tpu_torch.data.datasets import (
            reference_gt_roundtrip)
        img = self.images[i]
        return {"image": img, "filename": f"IDRiD_{i:02d}.jpg",
                "ori_h": img.shape[0], "ori_w": img.shape[1],
                "mask": reference_gt_roundtrip(self.masks[i], self.scale)}


def write_run_dir(logdir, seed=SEED):
    """A run directory from the port alone: config.json and the ``seed``
    weights as ``checkpoints/best.ckpt`` in the JAX package's format."""
    import torch
    from eyediseasesegmentation_tpu_torch.convert import torch_to_flax
    from eyediseasesegmentation_tpu_torch.train.checkpoint import (
        save_checkpoint)

    config = {"model_name": "unetplusplusstar",
              "model_params": dict(MODEL_PARAMS, pallas_tail=TTA_MODE,
                                   fast_min_res=FAST_MIN_RES),
              "scale_size": SCALE, "lesion_type": "EX",
              "dataset_name": "IDRiD", "inference_dtype": "bfloat16"}
    (logdir / "checkpoints").mkdir(parents=True)
    (logdir / "config.json").write_text(json.dumps(config))
    state = build_model(torch.float32, "cpu", seed=seed).state_dict()
    save_checkpoint(logdir / "checkpoints" / "best.ckpt",
                    {"model_state_dict": torch_to_flax(state),
                     "metric": 0.0, "epoch": 0})
    return state


def phase_test_tta(device, card):
    """``test_tta``'s steps at full width on the card, files aside."""
    import tempfile

    import numpy as np
    import torch
    from eyediseasesegmentation_tpu_torch.analysis.aucpr import (
        pr_curve_report)
    from eyediseasesegmentation_tpu_torch.data.datasets import (
        batch_iterator, prefetch)
    from eyediseasesegmentation_tpu_torch.infer.tta import (
        TTAPredictor, load_model_for_inference, masks_to_uint8, tta_pass)
    from eyediseasesegmentation_tpu_torch.ops import metrics as M

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        logdir = Path(tmp) / "models" / "IDRiD" / "EX" / "smoke"
        state = write_run_dir(logdir)
        model, cfg = load_model_for_inference(logdir, device=device)
    loaded = model.state_dict()
    check(all(torch.equal(loaded[k].cpu(), v) for k, v in state.items()),
          "test_tta: the checkpoint did not round-trip the weights")
    check(cfg["model_params"]["pallas_tail"] == TTA_MODE
          and model.dtype == torch.bfloat16,
          f"test_tta: run config {cfg['model_params']} / {model.dtype}")
    del state, loaded
    rng = np.random.default_rng(SEED + 6)
    pairs = [synthetic_fundus(rng, FULL_HW) for _ in range(TTA_IMAGES)]
    ds = ArrayTestSet([p[0] for p in pairs], [p[1] for p in pairs], SCALE)
    predictor = TTAPredictor(model, cfg, tta="d4", ori_hw=FULL_HW)

    def run_pass():
        return tta_pass(predictor,
                        prefetch(batch_iterator(ds, TTA_BATCH, workers=2)))

    # a first pass takes cuDNN's tuning at 16 views (the bench tuned 24)
    t_first = run_pass()[2]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()                               # the main path starts here
    totals, prob_batches, t_pass = run_pass()
    counts, by_variant = read_counts(), read_variant_counts()  # ... ends
    peak_pass = torch.cuda.max_memory_allocated()
    forwards = len(prob_batches)
    check(forwards == 2 and [len(f) for _, f in prob_batches] == [2, 1],
          f"test_tta: batches {[len(f) for _, f in prob_batches]}")
    check(counts == expected_counts(TTA_MODE, forwards),
          f"test_tta: launches {counts} in {forwards} forwards, expected "
          f"{expected_counts(TTA_MODE, forwards)}")
    check_variants("test_tta", by_variant, "sm90")
    mean_auc = float(totals["ap_sum"]) / max(float(totals["ap_count"]), 1)
    check(np.isfinite(mean_auc) and 0.0 <= mean_auc <= 1.0,
          f"test_tta: mean_auc {mean_auc}")
    check(float(totals["px"]) == TTA_IMAGES * FULL_HW[0] * FULL_HW[1],
          f"test_tta: {totals['px']} pixels counted")
    thresholds = pr_curve_report(totals["tp"], totals["ap"], totals["pp"],
                                 "smoke", figure_dir=None)
    allowed = {float(t) for t in M.THRESH_LIST}
    check(all(thresholds[k] in allowed for k in (
        "optimal_threshold", "optimal_threshold_1", "optimal_threshold_2")),
        f"test_tta: thresholds {thresholds}")

    # the device half of the export, fetched as the file writer would
    optim = thresholds["optimal_threshold_2"]
    for probs, fnames in prob_batches:
        check(tuple(probs.shape) == (TTA_BATCH, *FULL_HW)
              and bool(torch.isfinite(probs).all()),
              f"test_tta: probabilities {tuple(probs.shape)}")
        m8, p8 = (t.cpu().numpy() for t in masks_to_uint8(probs, optim,
                                                          True))
        check(m8.dtype == np.uint8 and p8.dtype == np.uint8
              and m8.shape[1:] == FULL_HW
              and set(np.unique(m8[:len(fnames)]).tolist()) <= {0, 1},
              f"test_tta: masks {m8.dtype} {m8.shape}")

    # batch_image_metrics of the first batch: the card against the CPU
    probs0 = prob_batches[0][0]
    masks0 = torch.from_numpy(np.stack([ds[i]["mask"] for i in
                                        range(TTA_BATCH)]).astype(np.uint8))
    with torch.inference_mode():
        gpu = M.batch_image_metrics(probs0, masks0.to(device), TTA_BATCH)
        cpu = M.batch_image_metrics(probs0.cpu(), masks0, TTA_BATCH)
    for k in ("tp", "ap", "pp", "tn", "px", "ap_count"):
        check(torch.equal(gpu[k].cpu(), cpu[k]),
              f"test_tta: {k} on the card {gpu[k].tolist()} against the CPU "
              f"{cpu[k].tolist()}")
    rel = abs(float(gpu["ap_sum"]) - float(cpu["ap_sum"])) / max(
        abs(float(cpu["ap_sum"])), 1e-30)
    check(rel <= AP_SUM_RTOL, f"test_tta: ap_sum {float(gpu['ap_sum'])} on "
                              f"the card, {float(cpu['ap_sum'])} on the CPU")

    # predict alone, then metrics plus the export's device half, per pass
    batches = list(batch_iterator(ds, TTA_BATCH))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches:
        predictor.predict(b["image"])
    torch.cuda.synchronize()
    t_predict = time.perf_counter() - t0
    masks = [torch.from_numpy(b["mask"].astype(np.uint8)).to(device)
             for b in batches]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    with torch.inference_mode():
        for (probs, _), m, b in zip(prob_batches, masks, batches):
            stats = M.batch_image_metrics(probs, m, b["n_valid"])
            fetched = [v.cpu() for v in stats.values()]
            fetched += [t.cpu() for t in masks_to_uint8(probs, optim, True)]
    torch.cuda.synchronize()
    t_metrics = time.perf_counter() - t0
    peak_metrics = torch.cuda.max_memory_allocated() - base
    print(f"test_tta d4 bf16 pallas_tail={TTA_MODE}: {TTA_IMAGES} images of "
          f"{FULL_HW[0]}x{FULL_HW[1]} in batches of {TTA_BATCH}: pass "
          f"{t_pass:.4f} s ({TTA_IMAGES / t_pass:.4f} images/sec; predict + "
          f"metrics, host batching and GT round trip included, one batch in "
          f"flight; the first pass {t_first:.4f} s); predict alone {t_predict:.4f} s; metrics + export "
          f"device half {t_metrics:.4f} s; peak memory {peak_pass / 2**30:.3f}"
          f" GiB in the pass (probabilities of every batch resident), "
          f"metrics {peak_metrics / 2**30:.3f} GiB above what was resident; "
          f"mean_auc {mean_auc:.6f}, thresholds {thresholds}; card-vs-CPU "
          f"ap_sum rel {rel:.2e}; launches {counts} by variant "
          f"{by_variant['axial_attention']} / {by_variant['decode_pair']} "
          f"(K1 / K2); phase {time.perf_counter() - t_phase:.1f} s; {card}",
          flush=True)
    del model, predictor, prob_batches, masks
    torch.cuda.empty_cache()
    return counts


def small_trainer(device):
    """The card-vs-CPU parity's trainer: the flagship at base_dim 4, fp32,
    augmentation none, seed-0 weights, every DropBlock off."""
    import torch
    from eyediseasesegmentation_tpu_torch import models as zoo
    from eyediseasesegmentation_tpu_torch.models.modules.layers import (
        DropBlock2d)
    from eyediseasesegmentation_tpu_torch.train.trainer import Trainer

    cfg = dict(TRAIN_CONFIG, scale_size=PARITY_SIZE, is_fp16=False,
               augmentation="none", model_params=dict(
                   TRAIN_CONFIG["model_params"], base_dim=PARITY_SIZE // 32))
    trainer = Trainer(cfg, device=device)
    zoo.init_random(trainer.model, torch.Generator().manual_seed(SEED))
    for mod in trainer.model.modules():
        if isinstance(mod, DropBlock2d):
            mod.drop_prob = 0.0
    return trainer


def grads_fp64(trainer, images, masks):
    """The small trainer's loss and gradients of one step's forward and
    backward in fp64 (weights, inputs, statistics, softmax and loss)."""
    import torch
    model = trainer.model.double()
    for mod in model.modules():
        if hasattr(mod, "dtype"):
            mod.dtype = torch.float64
    model.train()
    dev = trainer.device
    x = trainer.transform.test(torch.from_numpy(images).to(dev).double())
    m4 = torch.from_numpy(masks).to(dev).double()[:, None]
    loss = trainer.compute_loss(model(x.permute(0, 3, 1, 2)), m4)[0]
    loss.backward()
    return loss.item(), {n: p.grad.detach().cpu()
                         for n, p in model.named_parameters()}


def hold_grads(tag, got, want, leaf_tol, floor):
    """Every gradient leaf within max(leaf_tol · its max, floor · the
    largest); returns (median |Δ| / leaf max, worst share of a bound, the
    leaf it was, leaves within 1e-3 of their max)."""
    import numpy as np
    check(set(got) == set(want), f"{tag}: gradient leaves differ")
    scale = max(g.abs().max().item() for g in want.values())
    rels, worst, tight = [], (0.0, ""), 0
    for k, w in want.items():
        err = (got[k] - w).abs().max().item()
        top = w.abs().max().item()
        bound = max(leaf_tol * top, floor * scale)
        check(err <= bound, f"{tag}: grad {k} err {err} > {bound}")
        worst = max(worst, (err / bound, k))
        tight += err <= 1e-3 * top
        rels.append(err / top if top > 0 else 0.0)
    return float(np.median(rels)), worst[0], worst[1], tight


def phase_train_parity(device):
    """One train step of the small flagship on the card against the same
    step on the CPU: ``train_step`` in fp32, and its forward and backward
    in fp64, where rounding no longer hides a difference."""
    import numpy as np
    import torch

    rng = np.random.default_rng(SEED + 7)
    images = rng.integers(0, 256, (2, PARITY_SIZE, PARITY_SIZE, 3),
                          dtype=np.uint8)
    masks = (rng.random((2, PARITY_SIZE, PARITY_SIZE)) < 0.1).astype(
        np.uint8)
    benchmark = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = False
    runs = {}
    for where in ("cpu", device):
        trainer = small_trainer(where)
        reset_counts()
        m = trainer.train_step(images, masks, torch.Generator(), 1e-3)
        grads = {n: p.grad.detach().float().cpu()
                 for n, p in trainer.model.named_parameters()}
        trainer = small_trainer(where)
        exact = grads_fp64(trainer, images, masks)
        counts = read_counts()
        check(not any(counts.values()),
              f"train parity on {where}: kernel launches {counts}")
        runs[str(where)] = (float(m["loss"]), grads, *exact)
        del trainer
    torch.backends.cudnn.benchmark = benchmark
    want, got = runs["cpu"], runs[str(device)]
    line = [f"train parity {PARITY_SIZE}² b=2 base_dim={PARITY_SIZE // 32}, "
            "card against CPU:"]
    for tag, i, rtol, leaf, floor, med_tol in (
            ("fp32", 0, TRAIN_LOSS_RTOL, TRAIN_GRAD_LEAF, TRAIN_GRAD_FLOOR,
             TRAIN_GRAD_MEDIAN),
            ("fp64", 2, FP64_LOSS_RTOL, FP64_GRAD_LEAF, FP64_GRAD_FLOOR,
             None)):
        rel_loss = abs(got[i] - want[i]) / abs(want[i])
        median, worst, leaf_name, tight = hold_grads(
            f"train parity {tag}", got[i + 1], want[i + 1], leaf, floor)
        line.append(f"{tag} loss {got[i]:.9f} / {want[i]:.9f} (rel "
                    f"{rel_loss:.2e} <= {rtol}), grads median rel "
                    f"{median:.2e}, worst {worst:.2f} of its bound "
                    f"({leaf_name}), {tight} of {len(want[i + 1])} leaves "
                    "within 1e-3 of their max;")
        check(rel_loss <= rtol, f"train parity {tag}: loss rel {rel_loss}")
        check(med_tol is None or median <= med_tol,
              f"train parity {tag}: median {median}")
    print(" ".join(line) + " no kernel launched", flush=True)
    torch.cuda.empty_cache()


def full_trainer(device):
    import torch
    from eyediseasesegmentation_tpu_torch import models as zoo
    from eyediseasesegmentation_tpu_torch.train.trainer import Trainer

    torch.backends.cudnn.benchmark = True
    trainer = Trainer(dict(TRAIN_CONFIG), device=device)
    zoo.init_random(trainer.model, torch.Generator().manual_seed(SEED))
    return trainer


def train_batch():
    import numpy as np
    rng = np.random.default_rng(SEED)
    images = rng.integers(0, 256, (2, SCALE, SCALE, 3), dtype=np.uint8)
    masks = (rng.random((2, SCALE, SCALE)) < 0.1).astype(np.uint8)
    return images, masks


def phase_train(device, card):
    """The full-width train step (no kernel launched), then one eval_step on
    the same model (K1 on sm90). Returns K1's launches in the eval_step."""
    import math

    import torch
    from eyediseasesegmentation_tpu_torch.utils import fold_in

    trainer = full_trainer(device)
    images, masks = train_batch()
    epoch_gen = fold_in(torch.Generator().manual_seed(SEED), 1000)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()                               # the train steps start here
    first = trainer.train_step(images, masks, epoch_gen, 1e-3)["loss"]
    first = float(first)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        m = trainer.train_step(images, masks, epoch_gen, 1e-3)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts()                       # ... and end here
    last = float(m["loss"])
    peak = torch.cuda.max_memory_allocated()
    check(math.isfinite(first) and math.isfinite(last),
          f"train: losses {first}, {last}")
    check(not any(counts.values()),
          f"train: kernel launches in the train steps {counts}")
    ms = 1e3 * dt / TRAIN_STEPS
    print(f"train step {SCALE}² b=2 bf16 advanced base_dim={SCALE // 32} "
          f"AdamW: {ms:.2f} ms/step, {2 * TRAIN_STEPS / dt:.4f} images/sec "
          f"over {TRAIN_STEPS} steps after {TRAIN_WARMUP} warm-up; peak "
          f"memory {peak / 2**30:.3f} GiB; loss first {first:.6f} last "
          f"{last:.6f}; kernel launches {counts}; {card}", flush=True)

    reset_counts()
    r = trainer.eval_step(images, masks, 2)
    torch.cuda.synchronize()
    counts, by_variant = read_counts(), read_variant_counts()
    check(trainer.model.training, "eval_step: model not back in train()")
    k1 = counts["axial_attention"]
    check(k1 > 0 and by_variant["axial_attention"]["wmma"] == 0,
          f"eval_step: K1 launches {by_variant['axial_attention']}")
    check_variants("eval_step", by_variant, "sm90")
    vals = [float(r[k]) for k in ("inter", "pred", "true", "loss")]
    check(all(math.isfinite(v) for v in vals)
          and bool(torch.isfinite(r["tp"]).all()),
          f"eval_step: {vals}")
    dice = (2 * vals[0] + 1e-7) / (vals[1] + vals[2] + 1e-7)
    print(f"eval_step {SCALE}² b=2 bf16: loss {vals[3]:.6f}, dice "
          f"{dice:.6f}, launches {counts} (K1 by variant "
          f"{by_variant['axial_attention']})", flush=True)
    del trainer
    torch.cuda.empty_cache()
    return k1


def write_tree(root, split="train", n=TREE_IMAGES, seed=SEED + 8,
               mask_sub="mask"):
    """A split in the IDRiD layout: ``n`` synthetic fundus images (jpg) and
    their EX masks (tif), written with PIL. Returns (image dir, mask
    root)."""
    import numpy as np
    from PIL import Image
    from eyediseasesegmentation_tpu_torch.data.paths import lesion_dict

    img_dir = root / split / "image"
    msk_dir = root / split / mask_sub / lesion_dict["EX"].dir_name
    img_dir.mkdir(parents=True)
    msk_dir.mkdir(parents=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        img, mask = synthetic_fundus(rng, FULL_HW)
        Image.fromarray(img).save(img_dir / f"IDRiD_{i:02d}.jpg", quality=95)
        Image.fromarray((mask * 255).astype(np.uint8)).save(
            msk_dir / f"IDRiD_{i:02d}_EX.tif")
    return img_dir, root / split / mask_sub


def phase_train_model(device, root):
    """``train_model`` for one epoch at full width under ``root`` (the run
    directory stays for the pipeline phase), then ``best.ckpt`` loaded for
    inference and one d4 predict. Returns (K1's launches in the run, the run
    directory)."""
    import math

    import numpy as np
    import torch
    from PIL import Image
    from eyediseasesegmentation_tpu_torch.infer.tta import (
        TTAPredictor, load_model_for_inference)
    from eyediseasesegmentation_tpu_torch.train.trainer import train_model

    t_phase = time.perf_counter()
    img_dir, mask_dir = write_tree(root / "data")
    cfg = dict(TREE_CONFIG, num_epochs=1, train_img_path=str(img_dir),
               train_mask_path=str(mask_dir))
    reset_counts()
    t0 = time.perf_counter()
    logdir = train_model("smoke", cfg, seed=1999,
                         models_root=str(root / "models"))
    t_train = time.perf_counter() - t0
    counts, by_variant = read_counts(), read_variant_counts()
    check(counts["axial_attention"] > 0, f"train_model: {counts}")
    check_variants("train_model", by_variant, "sm90")
    check(json.loads((logdir / "config.json").read_text()) == cfg,
          "train_model: config.json")
    rows = [json.loads(x) for x in
            (logdir / "metrics.jsonl").read_text().splitlines()]
    check(len(rows) == 1 and all(
        math.isfinite(v) for v in rows[0].values()),
        f"train_model: metrics rows {rows}")
    for name in ("best", "last", "best_full"):
        check((logdir / "checkpoints" / f"{name}.ckpt").is_file(),
              f"train_model: no {name}.ckpt")
    model, run_cfg = load_model_for_inference(logdir)
    check(next(model.parameters()).device.type == "cuda",
          "train_model: the run did not load on the card")
    predictor = TTAPredictor(model, run_cfg, tta="d4", ori_hw=FULL_HW)
    img = np.asarray(Image.open(img_dir / "IDRiD_00.jpg").convert(
        "RGB"))[None]
    probs = predictor.predict(img)
    torch.cuda.synchronize()
    check(tuple(probs.shape) == (1, *FULL_HW)
          and bool(torch.isfinite(probs).all())
          and 0.0 <= probs.min().item() <= probs.max().item() <= 1.0,
          f"train_model: predict {tuple(probs.shape)}")
    print(f"train_model 1 epoch at {SCALE}² bf16 on {TREE_IMAGES} images of "
          f"{FULL_HW[0]}x{FULL_HW[1]} (4 train, 1 val): {t_train:.2f} s, row "
          f"{rows[0]}; K1 launches {counts['axial_attention']} (by variant "
          f"{by_variant['axial_attention']}), K2 {counts['decode_pair']} "
          f"(pallas_tail={TTA_MODE}); best.ckpt loaded for one d4 predict; "
          f"phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    del model, predictor, probs
    torch.cuda.empty_cache()
    return counts["axial_attention"], logdir


def check_csvs(tag, csv_dir, n_images):
    """The five result CSVs: a row per image and the ``Avg:`` row, every
    value finite and in [0, 1]."""
    import math
    for key in RESULT_CSVS:
        lines = (csv_dir / f"{key}.csv").read_text().splitlines()
        check(len(lines) == n_images + 1 and lines[-1].startswith("Avg:,"),
              f"{tag}: {key}.csv has {len(lines)} rows")
        vals = [float(ln.rsplit(",", 1)[1]) for ln in lines]
        check(all(math.isfinite(v) and 0.0 <= v <= 1.0 for v in vals),
              f"{tag}: {key}.csv values {vals}")


def check_probs(tag, probs, shape):
    import torch
    check(probs.device.type == "cuda" and tuple(probs.shape) == shape
          and bool(torch.isfinite(probs).all())
          and 0.0 <= probs.min().item() <= probs.max().item() <= 1.0,
          f"{tag}: probabilities {probs.device} {tuple(probs.shape)}")


def pipeline_whole_image(logdir, test):
    """``pipeline.py``'s inference and analysis on phase 7's run: the steps
    of ``test_tta`` (d4, ``createprob`` on, as the driver forces it) but the
    figure, then ``export_result``. Returns the launch counts of the
    pass."""
    import torch
    from eyediseasesegmentation_tpu_torch.analysis.aucpr import (
        pr_curve_report)
    from eyediseasesegmentation_tpu_torch.analysis.stat_result import (
        export_result)
    from eyediseasesegmentation_tpu_torch.data import (
        TestSegmentation, batch_iterator, get_datapath, prefetch)
    from eyediseasesegmentation_tpu_torch.infer.tta import (
        TTAPredictor, export_masks_on_device, load_model_for_inference,
        tta_pass)

    model, run_cfg = load_model_for_inference(logdir)
    cfg = {**run_cfg, **test}
    check(cfg["model_params"].get("pallas_tail") == TTA_MODE
          and model.dtype == torch.bfloat16,
          f"pipeline: run config {cfg['model_params']} / {model.dtype}")
    ds = TestSegmentation(*get_datapath(Path(cfg["test_img_path"]),
                                        Path(cfg["test_mask_path"]), "EX"),
                          metric_roundtrip_scale=SCALE)
    predictor = TTAPredictor(model, cfg, tta="d4", ori_hw=FULL_HW)
    torch.cuda.synchronize()
    reset_counts()                               # the path starts here
    totals, prob_batches, t_pass = tta_pass(
        predictor, prefetch(batch_iterator(ds, TTA_BATCH, workers=2)))
    counts, by_variant = read_counts(), read_variant_counts()  # ... ends
    forwards = len(prob_batches)
    check(counts == expected_counts(TTA_MODE, forwards),
          f"pipeline test_tta: launches {counts} in {forwards} forwards")
    check_variants("pipeline test_tta", by_variant, "sm90")
    for probs, _ in prob_batches:
        check_probs("pipeline test_tta", probs, (TTA_BATCH, *FULL_HW))
    thresholds = pr_curve_report(totals["tp"], totals["ap"], totals["pp"],
                                 logdir.name, figure_dir=None)
    out = Path(cfg["out_dir"]) / "IDRiD" / "tta" / "EX"
    t0 = time.perf_counter()
    export_masks_on_device(
        ((p, [Path(n).stem + ".jpg" for n in f]) for p, f in prob_batches),
        thresholds["optimal_threshold_2"], out / logdir.name,
        out / "prob_image" / logdir.name)
    csv_dir = export_result(f"EX/{logdir.name}", cfg)
    t_files = time.perf_counter() - t0
    check_csvs("pipeline test_tta", csv_dir, len(ds))
    mean_auc = float(totals["ap_sum"]) / max(float(totals["ap_count"]), 1)
    print(f"pipeline lesion whole image: {len(ds)} images of "
          f"{FULL_HW[0]}x{FULL_HW[1]}, d4 bf16 pallas_tail={TTA_MODE}, "
          f"pass {t_pass:.4f} s ({len(ds) / t_pass:.4f} images/sec), masks "
          f"+ prob images + result CSVs {t_files:.2f} s; mean_auc "
          f"{mean_auc:.6f}, thresholds {thresholds}; launches {counts} by "
          f"variant {by_variant['axial_attention']} / "
          f"{by_variant['decode_pair']} (K1 / K2)", flush=True)
    return counts, model, cfg


def pipeline_tiles(root, train_tree, test):
    """Tile mode: patches of 2 full-size train images, a train list of
    ``TILE_TRAIN`` and a val list of ``TILE_VAL`` of them, ``train_model``
    on them for one epoch, then ``tta_patches``' steps (``tiled_pass``, the
    PR sweep, the renamed masks) but the figure. Returns the launch counts
    of the pass."""
    import shutil

    import numpy as np
    import torch
    from eyediseasesegmentation_tpu_torch.analysis.aucpr import (
        pr_curve_report)
    from eyediseasesegmentation_tpu_torch.analysis.stat_result import (
        export_result)
    from eyediseasesegmentation_tpu_torch.data import (TestSegmentation,
                                                       get_datapath)
    from eyediseasesegmentation_tpu_torch.data.patches import (
        build_dataframe, build_patches, read_img_mask_csv)
    from eyediseasesegmentation_tpu_torch.infer.tta import (
        TTAPredictor, export_masks_on_device, load_model_for_inference,
        tiled_pass)
    from eyediseasesegmentation_tpu_torch.train.trainer import train_model
    from eyediseasesegmentation_tpu_torch.utils import make_grid

    t0 = time.perf_counter()
    imgs, masks = get_datapath(*train_tree, "EX")
    built = build_patches(imgs[:2], masks[:2], root / "patches" / "image",
                          root / "patches" / "mask", window=PATCH_WINDOW)
    all_i, all_m = read_img_mask_csv(build_dataframe(
        root / "patches" / "image", root / "patches" / "mask"))
    check(len(all_i) == built["pos"] + built["neg"] - built["removed"]
          >= TILE_TRAIN + TILE_VAL and built["pos"] > 0,
          f"build_patches: {built}, {len(all_i)} listed")
    pick = np.linspace(0, len(all_i) - 1, TILE_TRAIN + TILE_VAL).astype(int)
    lists = {}
    for split, idx in (("train", pick[:TILE_TRAIN]),
                       ("val", pick[TILE_TRAIN:])):
        d = root / "tiles" / split / "EX"
        for sub, src in (("image", all_i), ("mask", all_m)):
            (d / sub).mkdir(parents=True)
            for i in idx:
                shutil.copy(src[i], d / sub / Path(src[i]).name)
        lists[split] = build_dataframe(d / "image", d / "mask")
    t_patches = time.perf_counter() - t0
    cfg = dict(TREE_CONFIG, num_epochs=1, data_type="tile",
               tile_train_csv=str(lists["train"]),
               tile_val_csv=str(lists["val"]))
    t0 = time.perf_counter()
    logdir = train_model("smoke_tile", cfg, seed=1999,
                         models_root=str(root / "models"))
    t_train = time.perf_counter() - t0
    rows = (logdir / "metrics.jsonl").read_text().splitlines()
    check(len(rows) == 1, f"tile train_model: {rows}")

    model, run_cfg = load_model_for_inference(logdir)
    cfg = {**run_cfg, **test}
    ds = TestSegmentation(*get_datapath(Path(cfg["test_img_path"]),
                                        Path(cfg["test_mask_path"]), "EX"))
    engine = TTAPredictor(model, cfg, tta="d4", resize=False)
    window = min(2 * SCALE, *FULL_HW)
    grid = make_grid(FULL_HW, window=window, min_overlap=32)
    check(len(grid) == TILES_PER_IMAGE, f"tiled: {len(grid)} windows")
    t0 = time.perf_counter()
    tiled_pass(engine, ds, grid, window, SCALE, "pr")   # cuDNN tunes 8 views
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    reset_counts()                               # the path starts here
    t0 = time.perf_counter()
    totals, probs = tiled_pass(engine, ds, grid, window, SCALE, "pr")
    torch.cuda.synchronize()
    t_pass = time.perf_counter() - t0
    counts, by_variant = read_counts(), read_variant_counts()  # ... ends
    peak = torch.cuda.max_memory_allocated()
    forwards = TILES_PER_IMAGE * len(ds)
    check(counts == expected_counts(TTA_MODE, forwards),
          f"tiled_pass: launches {counts} in {forwards} tile forwards")
    check_variants("tiled_pass", by_variant, "sm90")
    for p, _ in probs:
        check_probs("tiled_pass", p, FULL_HW)
    thresholds = pr_curve_report(totals["tp"], totals["ap"], totals["pp"],
                                 logdir.name, figure_dir=None)
    out = Path(cfg["out_dir"]) / "IDRiD" / "tta" / "EX" / logdir.name
    export_masks_on_device(
        ((p, [Path(n).stem.replace("_EX", "") + ".jpg"]) for p, n in probs),
        thresholds["optimal_threshold_2"], out)
    check_csvs("tiled", export_result(f"EX/{logdir.name}", cfg), len(ds))

    tile = torch.randint(0, 256, (SCALE, SCALE, 3), device=model_device(
        model)).float()
    t_tile = time_ms(lambda: engine.predict_tile(tile), 3, warm=1)
    mean_auc = float(totals["ap_sum"]) / max(float(totals["ap_count"]), 1)
    print(f"pipeline lesion tiles: build_patches on 2 images {built} "
          f"+ lists of {TILE_TRAIN} / {TILE_VAL} patches {t_patches:.2f} s; "
          f"train_model 1 epoch on them {t_train:.2f} s; tiled_pass of "
          f"{len(ds)} images of {FULL_HW[0]}x{FULL_HW[1]}, {len(grid)} "
          f"windows of {window} at {SCALE}² each, d4 bf16 "
          f"pallas_tail={TTA_MODE}: {t_pass:.4f} s ({len(ds) / t_pass:.4f}"
          f" images/sec; the first pass {t_first:.4f} s), predict_tile "
          f"{t_tile:.2f} ms, peak memory "
          f"{peak / 2**30:.3f} GiB; mean_auc {mean_auc:.6f}; launches "
          f"{counts} by variant {by_variant['axial_attention']} / "
          f"{by_variant['decode_pair']} (K1 / K2)", flush=True)
    del model, engine, probs
    torch.cuda.empty_cache()
    return counts


def model_device(model):
    return next(model.parameters()).device


def pipeline_multiscale(model, cfg, images):
    """``TTAPredictor(tta="multiscale", multiscale_max_res=1024)`` on a
    batch of full-size images: scale 1 whole, scales 2 and 4 as 4 and 16
    tiles of 1024². Returns the launch counts."""
    import torch
    from eyediseasesegmentation_tpu_torch.infer.tta import TTAPredictor

    predictor = TTAPredictor(model, cfg, tta="multiscale", ori_hw=FULL_HW,
                             multiscale_max_res=SCALE)
    t0 = time.perf_counter()
    predictor.predict(images)                    # cuDNN tunes batch 2
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    reset_counts()                               # the path starts here
    t0 = time.perf_counter()
    probs = predictor.predict(images)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts, by_variant = read_counts(), read_variant_counts()  # ... ends
    peak = torch.cuda.max_memory_allocated()
    check(counts == expected_counts(TTA_MODE, MULTISCALE_FORWARDS),
          f"multiscale: launches {counts}")
    check_variants("multiscale", by_variant, "sm90")
    check_probs("multiscale", probs, (len(images), *FULL_HW))
    print(f"pipeline multiscale (1, 2, 4; max_res {SCALE}): {len(images)} "
          f"images of {FULL_HW[0]}x{FULL_HW[1]} bf16 pallas_tail={TTA_MODE}"
          f", {MULTISCALE_FORWARDS} forwards of {SCALE}²: {dt:.4f} s "
          f"({len(images) / dt:.4f} images/sec; the first call "
          f"{t_first:.4f} s), peak memory "
          f"{peak / 2**30:.3f} GiB; launches {counts}", flush=True)
    return counts


def synthetic_vessels(rng):
    """A DRIVE-shaped (584×565) uint8 image with dark curved vessels on a
    fundus-like field and their {0, 1} mask, padded to 608² as the vessel
    path's images are."""
    import numpy as np
    h, w = VESSEL_HW
    yy = np.arange(h, dtype=np.float32)[:, None]
    xx = np.arange(w, dtype=np.float32)[None, :]
    img = np.empty((h, w, 3), np.float32)
    img[...] = (150.0, 80.0, 40.0)
    img += rng.standard_normal((h, w, 3), dtype=np.float32) * 6.0
    mask = np.zeros((h, w), bool)
    for _ in range(8):
        a, f, ph, c = (rng.uniform(20, 120), rng.uniform(0.005, 0.03),
                       rng.uniform(0, 6.3), rng.uniform(0, h))
        dist = np.abs(yy - (c + a * np.sin(f * xx + ph)))
        mask |= dist < rng.uniform(1.5, 4.0)
    img[mask] *= 0.5
    top, left = (VESSEL_SCALE - h) // 2, (VESSEL_SCALE - w) // 2
    pad_img = np.zeros((VESSEL_SCALE, VESSEL_SCALE, 3), np.uint8)
    pad_img[top:top + h, left:left + w] = np.clip(img, 0, 255)
    pad_mask = np.zeros((VESSEL_SCALE, VESSEL_SCALE), np.uint8)
    pad_mask[top:top + h, left:left + w] = mask
    return pad_img, pad_mask


def pipeline_vessel(root):
    """``pipeline_vessel.py``'s stages: ``train_model`` of the flagship at
    base_dim 19 with ``advanced_vessel`` for one epoch on
    ``VESSEL_IMAGES`` synthetic images, then ``test_tta``'s vessel steps
    (d4, no resize, AUC-ROC) on the same images but the figure, the masks
    and ``export_result_vessel``. Returns (K1's launches in training, the
    counts of the pass)."""
    import torch
    from PIL import Image
    from eyediseasesegmentation_tpu_torch.analysis.aucpr import (
        roc_curve_report)
    from eyediseasesegmentation_tpu_torch.analysis.stat_result_vessel import (
        export_result_vessel)
    from eyediseasesegmentation_tpu_torch.data import (
        TestSegmentation, batch_iterator, get_datapath, prefetch)
    from eyediseasesegmentation_tpu_torch.infer.tta import (
        TTAPredictor, export_masks_on_device, load_model_for_inference,
        tta_pass)
    from eyediseasesegmentation_tpu_torch.train.trainer import train_model

    import numpy as np
    rng = np.random.default_rng(SEED + 9)
    img_dir, msk_dir = root / "vdata" / "image", root / "vdata" / "mask"
    img_dir.mkdir(parents=True)
    msk_dir.mkdir(parents=True)
    for i in range(VESSEL_IMAGES):
        img, mask = synthetic_vessels(rng)
        Image.fromarray(img).save(img_dir / f"{i}.jpg", quality=95)
        Image.fromarray(mask * 255).save(msk_dir / f"{i}.jpg", quality=95)
    cfg = dict(VESSEL_CONFIG, num_epochs=1, train_img_path=str(img_dir),
               train_mask_path=str(msk_dir))
    reset_counts()                               # training starts here
    t0 = time.perf_counter()
    logdir = train_model("smoke_vessel", cfg, seed=1999,
                         models_root=str(root / "models"))
    t_train = time.perf_counter() - t0
    train_counts, train_variants = read_counts(), read_variant_counts()
    check(train_counts["axial_attention"] > 0,
          f"vessel train_model: {train_counts}")
    check_variants("vessel train_model", train_variants, "sm90")

    model, run_cfg = load_model_for_inference(logdir)
    cfg = {**run_cfg, "test_img_path": str(img_dir),
           "test_mask_path": str(msk_dir), "out_dir": str(root / "outputs")}
    ds = TestSegmentation(*get_datapath(img_dir, msk_dir, "Vessel_DRIVE"))
    predictor = TTAPredictor(model, cfg, tta="d4", resize=False)

    def run_pass():
        return tta_pass(predictor,
                        prefetch(batch_iterator(ds, TTA_BATCH, workers=2)),
                        score="roc")

    t_first = run_pass()[2]         # carries cuDNN's tuning at 608²
    torch.cuda.synchronize()
    reset_counts()                               # the pass starts here
    totals, prob_batches, t_pass = run_pass()
    counts, by_variant = read_counts(), read_variant_counts()  # ... ends
    forwards = len(prob_batches)
    check(counts == expected_counts("off", forwards),
          f"vessel test_tta: launches {counts} in {forwards} forwards")
    check_variants("vessel test_tta", by_variant, "sm90")
    for probs, _ in prob_batches:
        check_probs("vessel test_tta", probs,
                    (TTA_BATCH, VESSEL_SCALE, VESSEL_SCALE))
    thresholds = roc_curve_report(totals["tp"], totals["ap"], totals["tn"],
                                  totals["px"], logdir.name, figure_dir=None,
                                  pp=totals["pp"])
    export_masks_on_device(
        ((p, [Path(n).stem + ".jpg" for n in f]) for p, f in prob_batches),
        thresholds["optimal_threshold_2"],
        Path(cfg["out_dir"]) / "DRIVE" / "tta" / "Vessel_DRIVE" / logdir.name)
    check_csvs("vessel", export_result_vessel(
        f"Vessel_DRIVE/{logdir.name}", cfg), VESSEL_IMAGES)
    mean_auc = float(totals["ap_sum"]) / max(float(totals["ap_count"]), 1)
    print(f"pipeline vessel: {VESSEL_IMAGES} images of {VESSEL_HW[0]}x"
          f"{VESSEL_HW[1]} padded to {VESSEL_SCALE}², base_dim "
          f"{VESSEL_SCALE // 32}, advanced_vessel: train_model 1 epoch "
          f"{t_train:.2f} s (K1 launches "
          f"{train_variants['axial_attention']} in its validation); "
          f"d4 bf16 pass {t_pass:.4f} s ({VESSEL_IMAGES / t_pass:.4f} "
          f"images/sec; the first pass {t_first:.4f} s), mean AUC-ROC "
          f"{mean_auc:.6f}, thresholds "
          f"{thresholds}; launches {counts} (K1 by variant "
          f"{by_variant['axial_attention']})", flush=True)
    del model, predictor, prob_batches
    torch.cuda.empty_cache()
    return train_counts["axial_attention"], counts


def pipeline_card_vs_cpu(device):
    """``tiled_predict`` and the multiscale tiled leg on the fp32 flagship
    at base_dim 4 (128²), the card against the CPU, on logits: within
    ``SLICE_TOL`` × max|logit| of the CPU's. Returns the card's K1
    launches."""
    import numpy as np
    import torch
    from eyediseasesegmentation_tpu_torch import models as zoo
    from eyediseasesegmentation_tpu_torch.infer.tta import TTAPredictor
    from eyediseasesegmentation_tpu_torch.ops.tiling import tiled_predict
    from eyediseasesegmentation_tpu_torch.utils import make_grid

    params = dict(MODEL_PARAMS, base_dim=PARITY_SIZE // 32)
    cpu_model = zoo.get_model("unetplusplusstar", params, training=False,
                              dtype=torch.float32, device="cpu")
    zoo.init_random(cpu_model, torch.Generator().manual_seed(SEED))
    card_model = zoo.get_model("unetplusplusstar", params, training=False,
                               dtype=torch.float32, device="cpu")
    card_model.load_state_dict(cpu_model.state_dict())
    card_model.to(device)
    rng = np.random.default_rng(SEED + 10)
    image = torch.from_numpy(rng.integers(0, 256, (*CPU_TILED_HW, 3),
                                          dtype=np.uint8))
    window = min(2 * PARITY_SIZE, *CPU_TILED_HW)
    grid = make_grid(CPU_TILED_HW, window=window, min_overlap=32)
    cfg = {"dataset_name": "IDRiD", "gray": False,
           "scale_size": PARITY_SIZE}
    out, k1 = {}, 0
    for where, model in (("cpu", cpu_model), ("card", card_model)):
        dev = model_device(model)
        engine = TTAPredictor(model, cfg, tta="none", resize=False)
        prep = engine.transform.preprocessing_fn
        x = prep(image[:PARITY_SIZE, :PARITY_SIZE].float())[None].to(dev)
        reset_counts()
        with torch.inference_mode():
            out[where] = [
                tiled_predict(lambda t: engine._forward(prep(t)[None])[0],
                              image.to(dev), grid, window, PARITY_SIZE)]
            out[where] += [engine._scaled_logits_tiled(x, s) for s in (2, 4)]
        if where == "card":
            torch.cuda.synchronize()
            k1 = read_counts()["axial_attention"]
    forwards = len(grid) + 4 + 16
    check(k1 == 12 * forwards and read_variant_counts()[
        "axial_attention"]["wmma"] == k1,
        f"card vs CPU: K1 launches {k1} in {forwards} fp32 forwards")
    line = []
    for name, want, got in zip(("tiled_predict", "multiscale s=2",
                                "multiscale s=4"), out["cpu"], out["card"]):
        err = (got.cpu() - want).abs().max().item()
        bound = SLICE_TOL * want.abs().max().item()
        check(got.shape == want.shape and err <= bound,
              f"card vs CPU {name}: max_abs_err {err} > {bound}")
        line.append(f"{name} max_abs_err={err:.3e} (<= {bound:.3e})")
    print(f"pipeline card vs CPU, fp32 base_dim={PARITY_SIZE // 32} on "
          f"logits: {'; '.join(line)}; K1 {k1} launches on the card "
          f"(wmma)", flush=True)
    del card_model
    torch.cuda.empty_cache()
    return k1


def phase_pipeline(device, card, root, logdir):
    """The experiment drivers' stages at full width, the figure aside:
    ``pipeline.py`` on phase 7's run (whole image), in tile mode and with
    the multiscale alias, ``pipeline_vessel.py``, and the card against the
    CPU on ``tiled_predict`` and the multiscale tiled leg. Returns the
    launch counts of each path."""
    import torch
    from eyediseasesegmentation_tpu_torch.data import (TestSegmentation,
                                                       batch_iterator)

    t_phase = time.perf_counter()
    test_img, test_mask = write_tree(root / "data", "test", PIPE_IMAGES,
                                     SEED + 11, "label")
    test = {"test_img_path": str(test_img),
            "test_mask_path": str(test_mask),
            "out_dir": str(root / "outputs")}
    whole, model, cfg = pipeline_whole_image(logdir, test)
    images = next(batch_iterator(TestSegmentation(sorted(
        test_img.iterdir())), PIPE_IMAGES))["image"]
    multiscale = pipeline_multiscale(model, cfg, images)
    del model
    torch.cuda.empty_cache()
    tiles = pipeline_tiles(root, (root / "data" / "train" / "image",
                                  root / "data" / "train" / "mask"), test)
    vessel_train_k1, vessel = pipeline_vessel(root)
    card_k1 = pipeline_card_vs_cpu(device)
    seconds = time.perf_counter() - t_phase
    print(f"pipeline phase {seconds:.1f} s; {card}", flush=True)
    return {"test_tta": whole, "tiled": tiles, "multiscale": multiscale,
            "vessel": vessel, "vessel_train_k1": vessel_train_k1,
            "card_vs_cpu_k1": card_k1, "seconds": seconds, "test": test}


def ensemble_pass(root, logdir, test):
    """``ensemble.predict``'s steps, the figure aside: phase 7's run and a
    second flagship run (phase 6's form, weights of ``ENSEMBLE_SEED``) as
    the members, the pipeline phase's 2 test images in one batch of 2.
    Returns the launch counts of the pass."""
    import numpy as np
    import torch
    from eyediseasesegmentation_tpu_torch.analysis.aucpr import (
        pr_curve_report)
    from eyediseasesegmentation_tpu_torch.data import (
        TestSegmentation, batch_iterator, get_datapath, prefetch)
    from eyediseasesegmentation_tpu_torch.infer.ensemble import (
        EnsemblePredictor, get_best_models)
    from eyediseasesegmentation_tpu_torch.infer.tta import (masks_to_uint8,
                                                            tta_pass)

    second = root / "models" / "IDRiD" / "EX" / "ensemble_b"
    write_run_dir(second, seed=ENSEMBLE_SEED)
    # the ensemble reads the masks as they are (no GT round trip)
    ds = TestSegmentation(*get_datapath(Path(test["test_img_path"]),
                                        Path(test["test_mask_path"]), "EX"))
    members = get_best_models([logdir, second], tta="d4", ori_hw=FULL_HW)
    check([p.model.dtype for p in members] == [torch.bfloat16] * 2
          and all(p.config["model_params"]["pallas_tail"] == TTA_MODE
                  for p in members),
          f"ensemble: members {[p.config['model_params'] for p in members]}")
    ensemble = EnsemblePredictor(members)
    batches = list(batch_iterator(ds, TTA_BATCH))
    check(len(batches) == 1 and batches[0]["n_valid"] == PIPE_IMAGES,
          f"ensemble: {len(batches)} batches")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()                               # the path starts here
    totals, prob_batches, t_pass = tta_pass(ensemble, prefetch(iter(batches)))
    counts, by_variant = read_counts(), read_variant_counts()  # ... ends
    peak = torch.cuda.max_memory_allocated()
    check(counts == expected_counts(TTA_MODE, len(members)),
          f"ensemble: launches {counts} for {len(members)} member forwards, "
          f"expected {expected_counts(TTA_MODE, len(members))}")
    check_variants("ensemble", by_variant, "sm90")
    probs = prob_batches[0][0]
    check_probs("ensemble", probs, (TTA_BATCH, *FULL_HW))
    each = [p.predict(batches[0]["image"]) for p in members]
    err = (probs - (each[0] + each[1]) / 2).abs().max().item()
    check(err <= ENSEMBLE_TOL,
          f"ensemble: {err} from the members' mean > {ENSEMBLE_TOL}")
    spread = (each[0] - each[1]).abs().max().item()
    mean_auc = float(totals["ap_sum"]) / max(float(totals["ap_count"]), 1)
    check(np.isfinite(mean_auc) and 0.0 <= mean_auc <= 1.0,
          f"ensemble: mean_auc {mean_auc}")
    thresholds = pr_curve_report(totals["tp"], totals["ap"], totals["pp"],
                                 "ensemble", figure_dir=None)
    m8, _ = masks_to_uint8(probs, thresholds["optimal_threshold_2"], False)
    m8 = m8.cpu().numpy()
    check(m8.dtype == np.uint8 and m8.shape[1:] == FULL_HW
          and set(np.unique(m8).tolist()) <= {0, 1},
          f"ensemble: masks {m8.dtype} {m8.shape}")
    print(f"ensemble of 2 flagships (d4 bf16 pallas_tail={TTA_MODE}): "
          f"{PIPE_IMAGES} images of {FULL_HW[0]}x{FULL_HW[1]} in one batch: "
          f"pass {t_pass:.4f} s ({PIPE_IMAGES / t_pass:.4f} images/sec), peak "
          f"memory {peak / 2**30:.3f} GiB; against the members' mean "
          f"max_abs_err {err:.3e} (members differ by up to {spread:.3f}); "
          f"mean_auc {mean_auc:.6f}, thresholds {thresholds}; launches "
          f"{counts} by variant {by_variant['axial_attention']} / "
          f"{by_variant['decode_pair']} (K1 / K2)", flush=True)
    del members, ensemble, prob_batches, probs, each
    torch.cuda.empty_cache()
    return counts


def zoo_full_width(device, image):
    """One bf16 d4 ``predict`` of one full-size image at 1024² (at
    ``ZOO_SCALE`` for the MedT rows) for each model of ``ZOO_FULL`` (seeded
    weights), after a first call that carries cuDNN's tuning. Returns the
    launches of each kernel in the timed calls."""
    import torch
    from eyediseasesegmentation_tpu_torch import models as zoo
    from eyediseasesegmentation_tpu_torch.infer.tta import TTAPredictor

    totals, line = {}, []
    for i, (name, params) in enumerate(ZOO_FULL.items()):
        model = zoo.get_model(name, params, training=False,
                              dtype=torch.bfloat16, device="cpu")
        zoo.init_random(model, torch.Generator().manual_seed(SEED + 30 + i))
        scale = ZOO_SCALE.get(name, SCALE)
        cfg = {"scale_size": scale, "dataset_name": "IDRiD"}
        predictor = TTAPredictor(model.to(device), cfg, tta="d4",
                                 ori_hw=FULL_HW)
        t0 = time.perf_counter()
        predictor.predict(image)
        torch.cuda.synchronize()
        t_first = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        reset_counts()                           # the path starts here
        t0 = time.perf_counter()
        probs = predictor.predict(image)
        torch.cuda.synchronize()
        t = time.perf_counter() - t0
        counts, by_variant = read_counts(), read_variant_counts()  # ends
        check_probs(f"zoo {name}", probs, (1, *FULL_HW))
        want = {k: 0 for k in counts}
        want.update(ZOO_KERNELS_PER_FORWARD.get(name, {}))
        check(counts == want, f"zoo {name}: launches {counts}, expected "
                              f"{want}")
        if name in ZOO_KERNELS_PER_FORWARD:
            check_variants(f"zoo {name}", by_variant, "sm90")
        for k, n in counts.items():
            totals[k] = totals.get(k, 0) + n
        tag = {"UnetPlusPlus": "(axial, scse)",
               "unetplusplusstar": "(BoTSER50_Imagenet, scse, pair_up)",
               **{n: f"(at {s}²)" for n, s in ZOO_SCALE.items()}}
        line.append(f"{name}{tag.get(name, '')} "
                    f"{1 / t:.4f} images/sec ({t:.4f} s, first call "
                    f"{t_first:.2f} s), peak "
                    f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
        del model, predictor, probs
        torch.cuda.empty_cache()
    print(f"zoo at full width, one {FULL_HW[0]}x{FULL_HW[1]} image, d4 bf16 "
          f"at {SCALE}² unless named: {'; '.join(line)}; launches {totals} "
          "(sm90)", flush=True)
    return totals


def zoo_card_vs_cpu(device):
    """Every registered name but the flagship at its registry defaults
    (``input_size`` set to the check's input size: PAN, the Swin models and
    the TransUNets are built for it, and the registry drops the key for the
    models without the field), Unet / UnetPlusPlus on the
    axial encoder at base_dim 2 (the axial encoder fits 32·base_dim only),
    Unet on densenet121 and the flagship on BoTSER50_Imagenet at base_dim 2
    under pair_up (its 4 tail nodes at this size: ``fast_min_res`` scaled
    with the input), built by ``get_model`` on the CPU and on the card (its
    default device) with the CPU model's seeded weights: one fp32 forward
    at 64² on each, within ``SLICE_TOL`` × max|logit|. The flagship's K1
    and K2 launches on the card are held (wmma in fp32). Returns them."""
    import numpy as np
    import torch
    from eyediseasesegmentation_tpu_torch import models as zoo
    from eyediseasesegmentation_tpu_torch.models.encoders import get_encoder

    cases = [(n, {"input_size": ZOO_PARITY_SIZE})
             for n in zoo.list_models() if n != "unetplusplusstar"]
    cases += [(n, {"encoder_name": AXIAL, "decoder_attention_type": "scse"})
              for n in ("Unet", "UnetPlusPlus")]
    cases += [("Unet", {"encoder_name": "densenet121"}),
              ("unetplusplusstar", dict(
                  BOTSER50_IMAGENET, base_dim=ZOO_PARITY_SIZE // 32,
                  fast_min_res=FAST_MIN_RES * ZOO_PARITY_SIZE // SCALE))]
    flagship_want = ZOO_KERNELS_PER_FORWARD["unetplusplusstar"]
    rng = np.random.default_rng(SEED + 40)
    x = torch.from_numpy(rng.uniform(-1, 1, (1, 3, ZOO_PARITY_SIZE,
                                             ZOO_PARITY_SIZE))
                         .astype(np.float32))
    worst, worst_name, flagship = 0.0, None, {}
    for i, (name, params) in enumerate(cases):
        model, card = (zoo.get_model(name, params, training=False,
                                     dtype=torch.float32, device=where)
                       for where in ("cpu", None))
        check(model_device(card).type == "cuda",
              f"zoo: get_model built {name} on {model_device(card)}")
        if params.get("encoder_name") == AXIAL:
            for m in (model, card):
                m.encoder = get_encoder(AXIAL, base_dim=ZOO_PARITY_SIZE
                                        // 32)[0].to(model_device(m))
        zoo.init_random(model, torch.Generator().manual_seed(SEED + 50 + i))
        card.load_state_dict(model.state_dict())
        with torch.inference_mode():
            want = model(x)
            reset_counts()
            got = card(x.to(device)).cpu()
            counts, by_variant = read_counts(), read_variant_counts()
        err = (got - want).abs().max().item()
        bound = SLICE_TOL * want.abs().max().item()
        check(got.shape == want.shape and bool(torch.isfinite(got).all())
              and err <= bound,
              f"zoo card vs CPU {name} {params}: max_abs_err {err} > {bound}")
        rel = err / max(want.abs().max().item(), 1e-30)
        if rel >= worst:
            worst, worst_name = rel, name
        if name == "unetplusplusstar":
            flagship = {k: n for k, n in counts.items() if n}
            check(flagship == flagship_want,
                  f"zoo card vs CPU {name}: launches {counts}, expected "
                  f"{flagship_want}")
            check_variants(f"zoo card vs CPU {name}", by_variant, "wmma")
        del model, card
    torch.cuda.empty_cache()
    print(f"zoo card vs CPU, fp32 at {ZOO_PARITY_SIZE}²: {len(cases)} models "
          f"(the {len(cases) - 4} registered names but the flagship, the 2 "
          f"axial pieces at "
          f"base_dim {ZOO_PARITY_SIZE // 32}, Unet on densenet121 and the "
          f"BoTSER50_Imagenet flagship under {TTA_MODE}, launches "
          f"{flagship} wmma), worst max|Δlogit| / max|logit| {worst:.3e} "
          f"({worst_name}; <= {SLICE_TOL})", flush=True)
    return flagship


def phase_ensemble_zoo(device, card, root, logdir, test):
    """The ensemble of two flagships, the zoo at full width and the zoo
    card against the CPU. Returns the launch counts of each path."""
    import numpy as np
    from PIL import Image

    t_phase = time.perf_counter()
    ensemble = ensemble_pass(root, logdir, test)
    image = np.asarray(Image.open(sorted(Path(test["test_img_path"])
                                         .iterdir())[0]).convert("RGB"))[None]
    zoo_full = zoo_full_width(device, image)
    zoo_parity = zoo_card_vs_cpu(device)
    seconds = time.perf_counter() - t_phase
    print(f"ensemble and zoo phase {seconds:.1f} s; {card}", flush=True)
    return {"ensemble": ensemble, "zoo": zoo_full, "zoo_parity": zoo_parity,
            "seconds": seconds}


def gan_datasets(root):
    """The GAN's train and test sets: the port's ``make_idrid_tree`` (lesion
    SE) at ``image_size``², GAN_TRAIN / GAN_TEST images."""
    from eyediseasesegmentation_tpu_torch.data import (OneLesionSegmentation,
                                                       get_datapath)
    from eyediseasesegmentation_tpu_torch.data.synthetic import (
        make_idrid_tree)

    size = GAN_CONFIG["image_size"]
    paths = make_idrid_tree(root, lesion_type="SE", n_train=GAN_TRAIN,
                            n_test=GAN_TEST, size=(size, size), seed=SEED)
    return [OneLesionSegmentation(*get_datapath(paths[split]["image"],
                                                paths[split]["mask"], "SE"))
            for split in ("train", "test")]


def gan_full_width(device, card, root):
    """``GanTrainer.fit`` for 2 epochs at GanConfig's widths, a fresh
    trainer loading its ``best_gan.ckpt``, then 1 + GAN_STEPS timed steps
    on one batch and one timed ``evaluate_ap``."""
    import math

    import numpy as np
    import torch
    from eyediseasesegmentation_tpu_torch.data import batch_iterator
    from eyediseasesegmentation_tpu_torch.train.gan import GanTrainer

    train_ds, test_ds = gan_datasets(root / "gan_data")
    logdir = root / "gan"
    trainer = GanTrainer(dict(GAN_CONFIG), logdir=logdir, seed=SEED,
                         device=device)
    t0 = time.perf_counter()
    result = trainer.fit(train_ds, test_ds, batch_size=GAN_BATCH)
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    rows = result["history"]
    check(len(rows) == 2 and all(math.isfinite(r[k]) for r in rows
                                 for k in ("d_loss", "g_loss", "seg", "adv")),
          f"gan fit: rows {rows}")
    check(0.0 <= result["best_ap"] <= 1.0, f"gan: best_ap {result['best_ap']}")
    check((logdir / "best_gan.ckpt").is_file()
          and len((logdir / "gan_metrics.jsonl").read_text().splitlines())
          == 2, "gan fit: best_gan.ckpt / gan_metrics.jsonl")
    batch = next(batch_iterator(train_ds, GAN_BATCH))
    want = trainer.predict_probs(batch["image"])
    fresh = GanTrainer(dict(GAN_CONFIG), seed=SEED + 1, device=device)
    meta = fresh.load_checkpoint(logdir / "best_gan.ckpt")
    reload_err = (fresh.predict_probs(batch["image"]) - want).abs().max()
    check(float(reload_err) <= GAN_RELOAD_TOL and meta["step"] == 4,
          f"gan reload: {meta}, max |Δprob| {float(reload_err)}")
    del fresh

    trainer.train_step(batch["image"], batch["mask"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(GAN_STEPS):
        m = trainer.train_step(batch["image"], batch["mask"])
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / GAN_STEPS
    peak = torch.cuda.max_memory_allocated()
    losses = {k: float(v) for k, v in m.items()}
    check(all(math.isfinite(v) for v in losses.values()),
          f"gan steps: losses {losses}")
    t0 = time.perf_counter()
    ap = trainer.evaluate_ap(test_ds, GAN_BATCH)
    ms_ap = 1e3 * (time.perf_counter() - t0)
    check(0.0 <= ap <= 1.0, f"gan evaluate_ap {ap}")
    size, patch = GAN_CONFIG["image_size"], GAN_CONFIG["patch_size"]
    shown = [{k: round(v, 6) for k, v in r.items()} for r in rows]
    print(f"gan {GAN_CONFIG['generator']}/mit_b0 fp32 {size}² patches "
          f"{patch}² ({(size // patch) ** 2} an image) b={GAN_BATCH}: fit 2 "
          f"epochs ({len(train_ds) // GAN_BATCH * 2} steps + evaluate_ap) "
          f"{t_fit:.2f} s, rows {shown}, "
          f"best_ap {result['best_ap']:.6f}; best_gan.ckpt reloaded max "
          f"|Δprob| {float(reload_err):.3e}; {ms:.2f} ms/step over "
          f"{GAN_STEPS} steps after 1 warm-up, peak memory "
          f"{peak / 2**30:.3f} GiB, losses {losses}; evaluate_ap of "
          f"{len(test_ds)} images {ms_ap:.2f} ms (AP {ap:.6f}); {card}",
          flush=True)
    del trainer, result
    torch.cuda.empty_cache()
    return {"ms_step": ms, "peak_gib": peak / 2**30, "ms_ap": ms_ap,
            "fit_s": t_fit}


def gan_step_state(device, dtype, images, masks, **extra):
    """One small GAN step on ``device`` in ``dtype`` from the seed's
    weights (``extra``: config keys, e.g. a ``mesh_shape``): the losses and
    each leaf's update (new − old) on the CPU."""
    import torch
    from eyediseasesegmentation_tpu_torch.train.gan import GanTrainer

    trainer = GanTrainer(dict(GAN_SMALL, **extra), seed=SEED, device=device)
    if dtype == torch.float64:
        for model in (trainer.generator, trainer.discriminator):
            model.double()
            for mod in model.modules():
                if hasattr(mod, "dtype"):
                    mod.dtype = dtype
        trainer.dtype = dtype

    def state():       # copies: the step updates the tensors in place
        return {**{k: v.detach().cpu().double().clone() for k, v in
                   trainer.generator.state_dict().items()},
                **{f"D.{k}": v.detach().cpu().double().clone() for k, v in
                   trainer.discriminator.state_dict().items()}}
    old = state()
    losses = {k: float(v) for k, v in trainer.train_step(images,
                                                         masks).items()}
    return losses, {k: v - old[k] for k, v in state().items()}


def gan_card_vs_cpu(device):
    """One step of the small GAN on the card against the CPU from the same
    weights and batch: the losses at GAN_LOSS_RTOL (adv plus its fp32
    rounding), each leaf's update within GAN_UPDATE_TOL of the leaf's
    largest; where fp32 cannot hold that (Adam's first step divides a
    near-zero gradient by its own size), the same step in fp64 must."""
    import numpy as np
    import torch

    rng = np.random.default_rng(SEED + 30)
    size = GAN_SMALL["image_size"]
    images = (rng.random((2, size, size, 3)) * 255).astype(np.float32)
    masks = (rng.random((2, size, size)) < 0.2).astype(np.float32)
    benchmark = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = False
    runs = {(str(where), dt): gan_step_state(where, dt, images, masks)
            for where in ("cpu", device)
            for dt in (torch.float32, torch.float64)}
    torch.backends.cudnn.benchmark = benchmark
    (cpu32, card32), (cpu64, card64) = (
        (runs[("cpu", dt)], runs[(str(device), dt)])
        for dt in (torch.float32, torch.float64))
    worst_loss = 0.0
    for k, want in cpu32[0].items():
        err = abs(card32[0][k] - want)
        bound = GAN_LOSS_RTOL * abs(want) + (GAN_ADV_ATOL if k == "adv"
                                             else 0.0)
        check(err <= bound, f"gan card vs CPU: {k} {card32[0][k]} / {want}")
        worst_loss = max(worst_loss, err / bound)
    fp32_worst, fp64_worst, fallback = (0.0, ""), (0.0, ""), []
    for k, want in cpu32[1].items():
        top = max(float(want.abs().max()), 1e-30)
        rel = float((card32[1][k] - want).abs().max()) / top
        fp32_worst = max(fp32_worst, (rel, k))
        w64 = cpu64[1][k]
        rel64 = float((card64[1][k] - w64).abs().max()) / max(
            float(w64.abs().max()), 1e-30)
        fp64_worst = max(fp64_worst, (rel64, k))
        if rel > GAN_UPDATE_TOL:
            fallback.append(k)
            check(rel64 <= GAN_UPDATE_TOL,
                  f"gan card vs CPU: update of {k} {rel} (fp64 {rel64})")
    print(f"gan card vs CPU, {GAN_SMALL['generator']} {size}² patches "
          f"{GAN_SMALL['patch_size']}, one step fp32 (TF32 off): losses "
          f"{card32[0]} / {cpu32[0]} (worst {worst_loss:.2f} of its bound); "
          f"leaf updates worst {fp32_worst[0]:.2e} of the leaf's largest "
          f"({fp32_worst[1]}), {len(fallback)} of {len(cpu32[1])} leaves "
          f"over {GAN_UPDATE_TOL} held in fp64 {fallback}; fp64 step worst "
          f"{fp64_worst[0]:.2e} ({fp64_worst[1]})", flush=True)


def optimizers_card_vs_cpu(device):
    """OPT_STEPS steps of each name in OPT_NAMES on the small flagship's
    OPT_SLICE modules, on the card and on the CPU, from the same weights
    and seeded gradients: the parameters within OPT_TOL of each leaf's
    largest."""
    import copy

    import torch
    from eyediseasesegmentation_tpu_torch import models as zoo
    from eyediseasesegmentation_tpu_torch.optim import (get_optimizer,
                                                        set_learning_rate)
    from eyediseasesegmentation_tpu_torch.train.param_groups import (
        param_groups)

    full = zoo.get_model("unetplusplusstar", dict(MODEL_PARAMS, base_dim=2),
                         training=True, device="cpu")
    zoo.init_random(full, torch.Generator().manual_seed(SEED + 31))
    root = torch.nn.Module()
    for path in OPT_SLICE:
        node, src = root, full
        *parents, leaf = path.split(".")
        for name in parents:
            src = getattr(src, name)
            if not hasattr(node, name):
                node.add_module(name, torch.nn.Module())
            node = getattr(node, name)
        node.add_module(leaf, getattr(src, leaf))
    gen = torch.Generator().manual_seed(SEED + 32)
    grads = [{n: torch.randn(p.shape, generator=gen)
              for n, p in root.named_parameters()} for _ in range(OPT_STEPS)]
    worst = []
    for name in OPT_NAMES:
        params = {}
        for where in ("cpu", device):
            model = copy.deepcopy(root).to(where)
            groups = param_groups(model, "unetplusplusstar", OPT_WD)
            check(len(groups) == 3, f"optimizers: groups {len(groups)}")
            opt = get_optimizer(name, groups, OPT_LR)
            named = dict(model.named_parameters())
            for i in range(OPT_STEPS):
                if i == 3:
                    set_learning_rate(opt, OPT_LR / 2.5)
                for n, p in named.items():
                    p.grad = grads[i][n].to(where)
                opt.step()
            params[str(where)] = {n: p.detach().cpu()
                                  for n, p in named.items()}
        rel = max(float((params[str(device)][n] - w).abs().max())
                  / max(float(w.abs().max()), 1e-30)
                  for n, w in params["cpu"].items())
        check(rel <= OPT_TOL, f"optimizer {name} card vs CPU: {rel}")
        worst.append(f"{name} {rel:.2e}")
    n_params = sum(p.numel() for p in root.parameters())
    print(f"optimizers card vs CPU, {OPT_STEPS} steps on the base_dim-2 "
          f"flagship's {len(OPT_SLICE)} modules ({n_params} parameters, 3 "
          f"groups), worst |Δ| / leaf max (<= {OPT_TOL}): "
          f"{', '.join(worst)}", flush=True)


def model_summary(card):
    """The full-width flagship's parameter count (built on the meta
    device) and the FLOPs of one 1024² view from ``cost_estimate`` on the
    plain path: fp32 on the CPU, where the ctypes kernels are not in the
    way of the counter."""
    import torch
    from eyediseasesegmentation_tpu_torch import models as zoo
    from eyediseasesegmentation_tpu_torch.utils.summary import (
        cost_estimate, get_num_parameters)

    meta = zoo.get_model("unetplusplusstar", MODEL_PARAMS, training=False,
                         device="meta")
    trainable, total = get_num_parameters(meta)
    model = build_model(torch.float32, "cpu")
    x = torch.zeros(1, 3, SCALE, SCALE)
    t0 = time.perf_counter()
    with torch.no_grad():
        cost = cost_estimate(model, x)
    seconds = time.perf_counter() - t0
    check(total == sum(p.numel() for p in model.parameters())
          and cost["flops"] > 0, f"summary: {total}, {cost}")
    print(f"flagship summary: {total} parameters ({trainable} trainable); "
          f"one {SCALE}² view fp32 {cost['flops'] / 1e9:.2f} GFLOP "
          f"(FlopCounterMode, 2 a multiply-add), "
          f"{cost['bytes_accessed'] / 2**30:.2f} "
          f"GiB moved by the eager ops, counted on the CPU's plain path in "
          f"{seconds:.1f} s; {card}", flush=True)
    return {"params": total, "gflop": cost["flops"] / 1e9}


def phase_gan(device, card, root):
    """Phase 10: the GAN at full width, the GAN and the optimizers card
    against the CPU, the flagship's summary. No kernel launches."""
    t_phase = time.perf_counter()
    reset_counts()
    gan = gan_full_width(device, card, root)
    gan_card_vs_cpu(device)
    optimizers_card_vs_cpu(device)
    summary = model_summary(card)
    counts = read_counts()
    check(not any(counts.values()), f"gan phase: kernel launches {counts}")
    seconds = time.perf_counter() - t_phase
    print(f"gan and host phase {seconds:.1f} s, kernel launches {counts}; "
          f"{card}", flush=True)
    return {**gan, **summary, "seconds": seconds}


def ramp(hw):
    """(H, W, 2) fp32 image of each pixel's row and column: a bilinear warp
    of it returns the source coordinates it sampled at."""
    import torch
    gy, gx = torch.meshgrid(torch.arange(hw[0], dtype=torch.float32),
                            torch.arange(hw[1], dtype=torch.float32),
                            indexing="ij")
    return torch.stack([gy, gx], -1)


def policy_ops(device, card):
    """The distortions and CLAHE at 1024², card against CPU at the same
    draws (the CPU's fields copied to the card): images within
    ``POLICY_IMG_TOL``, masks equal but where the CPU's source coordinate
    lies within ``POLICY_EDGE`` of a rounding boundary (counted); ms per
    call on the card and CLAHE's peak memory."""
    import numpy as np
    import torch
    from eyediseasesegmentation_tpu_torch.ops import image as I

    img8, mask = synthetic_fundus(np.random.default_rng(SEED + 40),
                                  (SCALE, SCALE))
    img_cpu = torch.from_numpy(img8.astype(np.float32))
    mask_cpu = torch.from_numpy(mask)
    gen = torch.Generator().manual_seed(SEED + 41)
    fields = I.draw_elastic(gen, SCALE, SCALE)
    draws = {"elastic": (I.apply_elastic, fields, {"sigma": 6.0}),
             "grid": (I.apply_grid_distortion,
                      I.draw_grid_distortion(gen), {}),
             "optical": (I.apply_optical_distortion,
                         I.draw_optical_distortion(gen, SCALE, SCALE), {})}
    img, m = img_cpu.to(device), mask_cpu.to(device)
    out = {}
    for name, (fn, args, kw) in draws.items():
        on = [a.to(device) if isinstance(a, torch.Tensor) else a
              for a in args]
        want_img, want_mask = fn(img_cpu, mask_cpu, *args, **kw)
        got_img, got_mask = fn(img, m, *on, **kw)
        err = float((got_img.cpu() - want_img).abs().max())
        check(err <= POLICY_IMG_TOL, f"{name}: image max err {err}")
        bad = got_mask.cpu() != want_mask
        if bool(bad.any()):
            coords = fn(ramp((SCALE, SCALE)), None, *args, **kw)
            frac = coords - torch.floor(coords)
            near = ((frac - 0.5).abs() < POLICY_EDGE).any(-1)
            check(not bool((bad & ~near).any()),
                  f"{name}: {int((bad & ~near).sum())} mask pixels differ "
                  "away from a rounding boundary")
        ms = time_ms(lambda: fn(img, m, *on, **kw), reps=10)
        out[name] = {"max_abs_err": err, "mask_boundary_pixels": int(
            bad.sum()), "ms": ms}
    want = I.clahe_rgb(img_cpu)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    got = I.clahe_rgb(img)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    err = float((got.cpu() - want).abs().max())
    check(err <= POLICY_IMG_TOL, f"clahe_rgb: image max err {err}")
    out["clahe_rgb"] = {"max_abs_err": err,
                        "ms": time_ms(lambda: I.clahe_rgb(img), reps=10),
                        "peak_mib": peak / 2 ** 20}
    for name, r in out.items():
        print(f"policy op {name} {SCALE}²: card vs CPU max|Δ| "
              f"{r['max_abs_err']:.3e} (bound {POLICY_IMG_TOL:.4f})"
              + (f", mask pixels at a rounding boundary "
                 f"{r['mask_boundary_pixels']}" if "mask_boundary_pixels"
                 in r else f", peak {r['peak_mib']:.1f} MiB above the "
                 "input") + f"; {r['ms']:.3f} ms a call; {card}", flush=True)
    return out


def timed_steps(trainer, tag, card):
    """1 + ``TRAIN_STEPS`` train steps of phase 7's batch: (ms a step,
    peak GiB), with no kernel launch."""
    import math

    import torch
    from eyediseasesegmentation_tpu_torch.utils import fold_in

    images, masks = train_batch()
    epoch_gen = fold_in(torch.Generator().manual_seed(SEED), 1000)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    first = float(trainer.train_step(images, masks, epoch_gen, 1e-3)["loss"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        m = trainer.train_step(images, masks, epoch_gen, 1e-3)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / TRAIN_STEPS
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    counts = read_counts()
    last = float(m["loss"])
    check(math.isfinite(first) and math.isfinite(last),
          f"{tag}: losses {first}, {last}")
    check(not any(counts.values()), f"{tag}: kernel launches {counts}")
    print(f"train step {tag} {SCALE}² b=2 bf16 AdamW: {ms:.2f} ms/step over "
          f"{TRAIN_STEPS} steps after {TRAIN_WARMUP} warm-up; peak memory "
          f"{peak:.3f} GiB; loss first {first:.6f} last {last:.6f}; kernel "
          f"launches {counts}; {card}", flush=True)
    return ms, peak


def remat_switches(model):
    """The modules of ``model`` that hold a ``remat`` switch (the flagship's
    encoders and decoder)."""
    return [m for m in model.modules()
            if isinstance(getattr(m, "remat", None), bool)]


def policies_and_remat_steps(device, card):
    """Phase 7's full-width train step on a trainer built with ``remat``
    (the trainer's own seed-1999 initialisation): its switches off under
    each policy (the transform swapped), then on (per-block
    checkpointing) under ``advanced``."""
    import torch
    from eyediseasesegmentation_tpu_torch.data import get_transform
    from eyediseasesegmentation_tpu_torch.train.trainer import Trainer

    torch.backends.cudnn.benchmark = True
    trainer = Trainer(dict(TRAIN_CONFIG, remat=True), device=device)
    switches = remat_switches(trainer.model)
    check(trainer._model_remat and len(switches) >= 3,
          "remat: the flagship took the whole-model fallback")
    prep = trainer.transform.preprocessing_fn
    out = {}
    for mod in switches:
        mod.remat = False
    for name in POLICY_NAMES:
        trainer.transform = get_transform(name)(image_size=SCALE,
                                                preprocessing_fn=prep)
        out[name] = timed_steps(trainer, f"augmentation={name}", card)
    for mod in switches:
        mod.remat = True
    out["remat"] = timed_steps(trainer, "remat advanced", card)
    del trainer
    torch.cuda.empty_cache()
    return out


def remat_card_parity(device):
    """One train step of the flagship at ``REMAT_SIZE``² with and without
    ``remat`` on the card, on one model (the ``remat`` switches of its
    encoder and decoder flipped; the same weights, optimizer state, batch
    and generators for every run; DropBlock on; cuDNN deterministic): fp32
    without, with, and without again, whose spread is the card's own
    run-to-run noise (atomic adds in some backwards), and the same pair in
    fp64. Holds the loss, every gradient leaf and every running statistic
    with remat to the run without; no kernel launch."""
    import numpy as np
    import torch
    from eyediseasesegmentation_tpu_torch import models as zoo
    from eyediseasesegmentation_tpu_torch.train.trainer import Trainer
    from eyediseasesegmentation_tpu_torch.utils import fold_in

    cfg = dict(TRAIN_CONFIG, is_fp16=False, scale_size=REMAT_SIZE,
               remat=True, model_params=dict(
                   TRAIN_CONFIG["model_params"], base_dim=REMAT_SIZE // 32,
                   drop_block_prob=0.3))
    rng = np.random.default_rng(SEED + 50)
    images = rng.integers(0, 256, (2, REMAT_SIZE, REMAT_SIZE, 3),
                          dtype=np.uint8)
    masks = (rng.random((2, REMAT_SIZE, REMAT_SIZE)) < 0.1).astype(np.uint8)
    tr = Trainer(cfg, device=device)
    zoo.init_random(tr.model, torch.Generator().manual_seed(SEED))
    switches = remat_switches(tr.model)
    check(len(switches) >= 3 and all(m.remat for m in switches),
          "remat parity: the flagship built without its remat switches")
    start = {k: v.clone() for k, v in tr.model.state_dict().items()}

    def run(on, dtype):
        tr.model.to(dtype)
        for mod in tr.model.modules():
            if hasattr(mod, "dtype"):
                mod.dtype = dtype
        tr.model.load_state_dict(start)
        tr.optimizer.state.clear()
        tr.step = 0
        for mod in switches:
            mod.remat = on
        m = tr.train_step(images, masks,
                          fold_in(torch.Generator().manual_seed(SEED), 1000),
                          1e-3)
        return (float(m["loss"]),
                {k: p.grad.detach().double().cpu()
                 for k, p in tr.model.named_parameters()},
                {k: b.detach().double().cpu()
                 for k, b in tr.model.named_buffers()
                 if b.is_floating_point()})

    bench = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    try:
        reset_counts()
        runs = {"fp32": [run(on, torch.float32) for on in (False, True,
                                                             False)],
                "fp64": [run(on, torch.float64) for on in (False, True)]}
        counts = read_counts()
    finally:
        torch.backends.cudnn.deterministic = False
        torch.backends.cudnn.benchmark = bench
    del tr
    torch.cuda.empty_cache()
    check(not any(counts.values()), f"remat parity: launches {counts}")

    def gap(a, b):
        """(loss rel, worst gradient leaf / its max, worst gradient leaf /
        the largest gradient, worst running statistic / its max)."""
        scale = max(float(g.abs().max()) for g in a[1].values())
        leaf = max(float((b[1][k] - g).abs().max())
                   / max(float(g.abs().max()), 1e-300)
                   for k, g in a[1].items())
        glob = max(float((b[1][k] - g).abs().max()) / scale
                   for k, g in a[1].items())
        stat = max(float((b[2][k] - v).abs().max())
                   / max(float(v.abs().max()), 1e-300)
                   for k, v in a[2].items())
        return abs(b[0] - a[0]) / abs(a[0]), leaf, glob, stat

    out = {"fp32 remat": gap(runs["fp32"][0], runs["fp32"][1]),
           "fp32 spread": gap(runs["fp32"][0], runs["fp32"][2]),
           "fp64 remat": gap(runs["fp64"][0], runs["fp64"][1])}
    for tag, (loss, leaf, glob, stat) in out.items():
        print(f"remat parity {REMAT_SIZE}² b=2 drop_block 0.3 {tag}: loss "
              f"rel {loss:.3e}, worst gradient leaf {leaf:.3e} of its max "
              f"({glob:.3e} of the largest gradient), worst running "
              f"statistic {stat:.3e}", flush=True)
    for dt in ("fp32", "fp64"):
        without, with_ = runs[dt][0], runs[dt][1]
        loss, _, _, stat = out[f"{dt} remat"]
        check(loss <= REMAT_LOSS_RTOL, f"remat parity {dt}: loss {loss}")
        check(stat <= REMAT_STAT_TOL,
              f"remat parity {dt}: running statistics {stat}")
        hold_grads(f"remat parity {dt}", with_[1], without[1],
                   REMAT_GRAD_TOL, REMAT_GRAD_FLOOR[dt])
    return out


def senet_state_dict(gen):
    """se_resnet50's state_dict names and shapes (pretrainedmodels'
    ``senet``: layer0 stem, four stages of SE bottlenecks, last_linear),
    filled with random values from ``gen``."""
    import torch

    def conv(o, i, k):
        return torch.randn((o, i, k, k), generator=gen) * (i * k * k) ** -0.5

    sd = {"layer0.conv1.weight": conv(64, 3, 7)}

    def bn(name, c):
        sd[f"{name}.weight"] = 1.0 + 0.1 * torch.randn(c, generator=gen)
        sd[f"{name}.bias"] = 0.1 * torch.randn(c, generator=gen)
        sd[f"{name}.running_mean"] = 0.1 * torch.randn(c, generator=gen)
        sd[f"{name}.running_var"] = 1.0 + torch.rand(c, generator=gen)
        sd[f"{name}.num_batches_tracked"] = torch.tensor(1000)

    bn("layer0.bn1", 64)
    cin = 64
    for s, (width, blocks) in enumerate(SENET_STAGES, 1):
        for b in range(blocks):
            p, out = f"layer{s}.{b}", 4 * width
            for i, (o, ci, k) in enumerate(((width, cin, 1),
                                            (width, width, 3),
                                            (out, width, 1)), 1):
                sd[f"{p}.conv{i}.weight"] = conv(o, ci, k)
                bn(f"{p}.bn{i}", o)
            sd[f"{p}.se_module.fc1.weight"] = conv(out // 16, out, 1)
            sd[f"{p}.se_module.fc1.bias"] = torch.zeros(out // 16)
            sd[f"{p}.se_module.fc2.weight"] = conv(out, out // 16, 1)
            sd[f"{p}.se_module.fc2.bias"] = torch.zeros(out)
            if b == 0:
                sd[f"{p}.downsample.0.weight"] = conv(out, cin, 1)
                bn(f"{p}.downsample.1", out)
            cin = out
    sd["last_linear.weight"] = torch.randn((1000, 2048), generator=gen)
    sd["last_linear.bias"] = torch.zeros(1000)
    return sd


def encoder_weights_full_width(device, root, card):
    """``Trainer(encoder_weights=...)`` at full width on the card from a
    stand-in se_resnet50 ``.pth`` written here: the key-diff report, and
    the stem conv equal to the file's tensor bit for bit."""
    import torch
    from eyediseasesegmentation_tpu_torch.train.trainer import Trainer

    sd = senet_state_dict(torch.Generator().manual_seed(SEED + 60))
    path = Path(root) / "se_resnet50.pth"
    torch.save(sd, path)
    t0 = time.perf_counter()
    trainer = Trainer(dict(TRAIN_CONFIG, encoder_weights=str(path)),
                      device=device)
    seconds = time.perf_counter() - t0
    rep = trainer.encoder_report
    n = {k: len(rep[k]) for k in ("loaded", "missing_in_jax",
                                  "shape_mismatch", "unused_torch")}
    stem = trainer.model.encoder.seresnet.stem_conv.weight
    check(stem.device.type == torch.device(device).type and torch.equal(
        stem.detach().cpu(), sd["layer0.conv1.weight"]),
        "encoder_weights: stem_conv differs from the file's tensor")
    check(n["loaded"] > 0 and n["missing_in_jax"] == 0
          and n["shape_mismatch"] == 0,
          f"encoder_weights: report {n}")
    print(f"encoder_weights se_resnet50 -> {TRAIN_CONFIG['model_name']} at "
          f"base_dim {SCALE // 32} on the card: loaded {n['loaded']}, "
          f"missing {n['missing_in_jax']}, mismatched "
          f"{n['shape_mismatch']}, unused {n['unused_torch']} (layer4 and "
          f"last_linear); stem_conv equal to the file; Trainer built in "
          f"{seconds:.2f} s; {card}", flush=True)
    del trainer
    torch.cuda.empty_cache()
    return n


def phase_train_options(device, card, root):
    """Phase 11: the transform policies' ops and train steps, ``remat``,
    ``encoder_weights``. Resuming from a JAX ``best_full.ckpt`` is held by
    the CPU tests only: this machine has no flax and the script imports no
    JAX package, so it cannot write one."""
    t_phase = time.perf_counter()
    parts = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        r = fn(*args)
        parts[name] = time.perf_counter() - t0
        return r

    ops = timed("ops", policy_ops, device, card)
    steps = timed("steps", policies_and_remat_steps, device, card)
    parity = timed("remat parity", remat_card_parity, device)
    report = timed("encoder_weights", encoder_weights_full_width, device,
                   root, card)
    (ms0, peak0), (ms1, peak1) = steps["advanced"], steps["remat"]
    check(peak1 < peak0, f"remat: peak {peak1:.3f} GiB not under "
          f"{peak0:.3f} GiB")
    seconds = time.perf_counter() - t_phase
    print(f"train options: ms/step " + ", ".join(
        f"{k} {v[0]:.2f}" for k, v in steps.items()) + f"; remat peak "
        f"{peak1:.3f} GiB against {peak0:.3f} GiB without ({ms1:.2f} "
        f"against {ms0:.2f} ms/step); JAX best_full.ckpt resume: CPU tests "
        f"only (no flax here); phase {seconds:.1f} s (" + ", ".join(
            f"{k} {v:.1f}" for k, v in parts.items()) + f"); {card}",
        flush=True)
    return {"ops": ops, "steps": steps, "remat_parity": parity,
            "encoder_weights": report, "seconds": seconds}


# ---------------------------------------------------------------------------
# phase 12: multi-GPU (one process per rank, spawned from here)
# ---------------------------------------------------------------------------

def set_tail_mode(model, mode):
    """Switch every ``pallas_tail`` of a flagship to ``mode`` (a key of
    TAIL_MODES) in place: the weights stay."""
    for mod in model.modules():
        if hasattr(mod, "pallas_tail"):
            mod.pallas_tail = TAIL_MODES[mode]


def mg_step_state(trainer):
    """The trainer's gradients, running statistics and parameters on the
    CPU in fp64."""
    m = trainer.model
    return ({k: p.grad.detach().double().cpu()
             for k, p in m.named_parameters() if p.grad is not None},
            {k: b.detach().double().cpu() for k, b in m.named_buffers()
             if k.rsplit(".", 1)[-1].startswith("running")},
            {k: p.detach().double().cpu() for k, p in m.named_parameters()})


def mg_unsharded(trainer, ref_mesh, fn):
    """``fn()`` with the trainer on ``ref_mesh`` (data axis 1: every rank
    the whole batch, the step of world size 1)."""
    mesh, dp = trainer.mesh, trainer.dp
    trainer.mesh, trainer.dp = ref_mesh, False
    try:
        return fn()
    finally:
        trainer.mesh, trainer.dp = mesh, dp


def mg_train(mesh, device, ref_mesh):
    """(a) The fp32 parity step at 256² and the timed full-width
    steps."""
    import numpy as np
    import torch
    from eyediseasesegmentation_tpu_torch import models as zoo
    from eyediseasesegmentation_tpu_torch.train.trainer import Trainer
    from eyediseasesegmentation_tpu_torch.utils import fold_in

    n = mesh.size
    out = {}
    cfg = dict(TRAIN_CONFIG, is_fp16=False, scale_size=MG_PARITY_SIZE,
               optimizer="sgd", model_params=dict(
                   TRAIN_CONFIG["model_params"],
                   base_dim=MG_PARITY_SIZE // 32, drop_block_prob=0.3))
    rng = np.random.default_rng(SEED + 60)
    images = rng.integers(0, 256, (2, MG_PARITY_SIZE, MG_PARITY_SIZE, 3),
                          dtype=np.uint8)
    masks = (rng.random((2, MG_PARITY_SIZE, MG_PARITY_SIZE)) < 0.1).astype(
        np.uint8)
    tr = Trainer(cfg, device=device)
    check(tr.mesh.shape == {"data": n}, f"dp mesh {tr.mesh.shape}")
    zoo.init_random(tr.model, torch.Generator().manual_seed(SEED))
    start = {k: v.clone() for k, v in tr.model.state_dict().items()}

    def step(unsharded):
        tr.model.load_state_dict(start)
        tr.optimizer.state.clear()
        tr.step = 0
        run = lambda: tr.train_step(  # noqa: E731
            images, masks, fold_in(torch.Generator().manual_seed(SEED),
                                   1000), 1e-3)
        m = mg_unsharded(tr, ref_mesh, run) if unsharded else run()
        return (float(m["loss"]), *mg_step_state(tr))

    t0 = time.perf_counter()
    want, got = step(True), step(False)
    out["parity_seconds"] = time.perf_counter() - t0
    del tr
    torch.cuda.empty_cache()
    loss_tol, stat_tol, param_tol = MG_PARITY_BOUNDS
    loss = abs(got[0] - want[0]) / abs(want[0])
    check(loss <= loss_tol, f"dp parity: loss {got[0]} against {want[0]}")
    stat = max(float((got[2][k] - v).abs().max())
               / max(float(v.abs().max()), 1e-300)
               for k, v in want[2].items())
    check(stat <= stat_tol, f"dp parity: running statistics {stat}")
    par = max(float((got[3][k] - v).abs().max())
              / max(float(v.abs().max()), 1e-300)
              for k, v in want[3].items())
    check(par <= param_tol, f"dp parity: updated parameters {par}")
    # reported, not held: fp32 gradients through a hundred train-mode
    # BatchNorms carry the reordered sums' rounding (the CPU tests hold
    # them in fp64 at 1e-12)
    scale = max(float(g.abs().max()) for g in want[1].values())
    grad = max(float((got[1][k] - g).abs().max())
               / max(float(g.abs().max()), REMAT_GRAD_FLOOR["fp32"] * scale)
               for k, g in want[1].items())
    out["parity"] = {"loss_rel": loss, "stat_rel": stat, "param_rel": par,
                     "grad_rel": grad}

    # timed full-width steps: bf16, advanced, AdamW, global batch 2
    t0 = time.perf_counter()
    tr = Trainer(dict(TRAIN_CONFIG), device=device)
    out["build_seconds"] = time.perf_counter() - t0
    images, masks = train_batch()
    gen = fold_in(torch.Generator().manual_seed(SEED), 1000)
    start = {k: v.clone() for k, v in tr.model.state_dict().items()}
    t0 = time.perf_counter()
    want = mg_unsharded(
        tr, ref_mesh,
        lambda: float(tr.train_step(images, masks, gen, 1e-3)["loss"]))
    out["unsharded_step_seconds"] = time.perf_counter() - t0
    tr.model.load_state_dict(start)
    tr.optimizer.state.clear()
    tr.step = 0
    del start
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    first = float(tr.train_step(images, masks, gen, 1e-3)["loss"])
    torch.cuda.synchronize()
    out["first_dp_step_seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(MG_TIMED_STEPS - 1):
        last = float(tr.train_step(images, masks, gen, 1e-3)["loss"])
    ms = 1e3 * (time.perf_counter() - t0) / (MG_TIMED_STEPS - 1)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(np.isfinite(first) and np.isfinite(last),
          f"dp full width: losses {first}, {last}")
    check(abs(first - want) <= MG_LOSS_RTOL * abs(want),
          f"dp full width: loss {first} against the unsharded {want}")
    del tr
    torch.cuda.empty_cache()
    out["timing"] = {"ms_per_step": ms, "peak_gib": peak, "loss": first,
                     "unsharded_loss": want}
    return out


def mg_predict(mesh, device, model, imgs):
    """(b) The sharded d4 predict under each pallas_tail mode against the
    unsharded predict (on rank 0), with the launches of the sharded one."""
    import torch
    from eyediseasesegmentation_tpu_torch.infer.tta import TTAPredictor

    cfg = {"dataset_name": "IDRiD", "gray": False, "scale_size": SCALE}
    sharded = TTAPredictor(model, cfg, tta="d4", ori_hw=FULL_HW, mesh=mesh)
    plain = TTAPredictor(model, cfg, tta="d4", ori_hw=FULL_HW)
    out = {}
    sharded.predict(imgs)               # the first call's lazy set-up
    for mode in TAIL_MODES:
        set_tail_mode(model, mode)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        probs = sharded.predict(imgs)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        counts, by_variant = read_counts(), read_variant_counts()
        check(counts == expected_counts(mode, 1),
              f"sharded predict {mode}: launches {counts}, expected "
              f"{expected_counts(mode, 1)}")
        check_variants(f"sharded predict {mode}", by_variant, "sm90")
        check(tuple(probs.shape) == (BATCH, *FULL_HW)
              and bool(torch.isfinite(probs).all()),
              f"sharded predict {mode}: {tuple(probs.shape)}")
        err = None
        if mesh.is_main:
            ref = plain.predict(imgs)
            err = float((probs - ref).abs().max() / ref.abs().max())
            check(err <= MG_PREDICT_TOL["bfloat16"],
                  f"sharded predict {mode}: {err} of max|ref|")
        out[mode] = {"launches": counts, "ms": ms, "rel_err": err}
        del probs
    set_tail_mode(model, TTA_MODE)
    return out


def mg_tiled(mesh, device, model, image):
    """(c) ``tiled_predict_sharded`` against ``tiled_predict`` on phase 8's
    tiled workload (windows of 2048 with 32 px of overlap, each a d4 batch
    at 1024²), both blends."""
    import torch
    from eyediseasesegmentation_tpu_torch.infer.tta import TTAPredictor
    from eyediseasesegmentation_tpu_torch.ops.tiling import (
        tiled_predict, tiled_predict_sharded)
    from eyediseasesegmentation_tpu_torch.utils import make_grid

    cfg = {"dataset_name": "IDRiD", "gray": False, "scale_size": SCALE}
    engine = TTAPredictor(model, cfg, tta="d4", resize=False)
    grid = make_grid(FULL_HW, window=2 * SCALE, min_overlap=32)
    out = {}
    for blend in ("overwrite", "mean"):
        reset_counts()
        with torch.inference_mode():
            got = tiled_predict_sharded(engine.predict_tile, image, grid,
                                        2 * SCALE, SCALE, mesh, blend=blend)
        counts = read_counts()
        err = None
        if mesh.is_main:
            with torch.inference_mode():
                ref = tiled_predict(engine.predict_tile, image, grid,
                                    2 * SCALE, SCALE, blend=blend)
            err = float((got - ref).abs().max() / ref.abs().max())
            check(err <= MG_PREDICT_TOL["bfloat16"],
                  f"tiled sharded {blend}: {err} of max|ref|")
        out[blend] = {"launches": counts, "tiles": len(grid),
                      "rel_err": err}
    return out


def mg_ensemble(mesh, device, model, second, imgs):
    """(d) The device-axis ensemble (one member per rank; at world size 1
    the one member, two raise) against ``EnsemblePredictor``."""
    import torch
    from eyediseasesegmentation_tpu_torch.infer.ensemble import (
        EnsemblePredictor, make_sharded_ensemble)
    from eyediseasesegmentation_tpu_torch.infer.tta import TTAPredictor

    cfg = {"dataset_name": "IDRiD", "gray": False, "scale_size": SCALE}
    members = [TTAPredictor(m, cfg, tta="d4", ori_hw=FULL_HW)
               for m in (model, second)][:mesh.size]
    out = {"members": len(members)}
    if mesh.size == 1:
        try:
            make_sharded_ensemble(members * 2, mesh)
            raise SmokeFailure("sharded ensemble: 2 members on 1 rank ran")
        except ValueError as e:
            out["two_on_one"] = str(e)
    # cuDNN's choice may differ between the ranks' processes: its
    # deterministic algorithms make the members' arithmetic one
    torch.backends.cudnn.deterministic = True
    reset_counts()
    got = make_sharded_ensemble(members, mesh).predict(imgs)
    out["launches"] = read_counts()
    if mesh.is_main:
        want = EnsemblePredictor(members).predict(imgs)
        out["abs_err"] = float((got - want).abs().max())
        check(out["abs_err"] <= ENSEMBLE_TOL,
              f"sharded ensemble: {out['abs_err']} from the members' mean")
    torch.backends.cudnn.deterministic = False
    del got
    return out


def mg_spatial(mesh, device, state):
    """(e) ``spatial_flagship_predict`` at full width, 1024², fp32, batch
    1, against the eval forward (rank 0), with the peak memory of each."""
    import torch
    from eyediseasesegmentation_tpu_torch.parallel.spatial_model import (
        spatial_flagship_predict)

    model = build_model(torch.float32, device, state=state)
    x = torch.randn(1, 3, SCALE, SCALE,
                    generator=torch.Generator().manual_seed(SEED + 1)).to(
        device)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with torch.inference_mode():
        got = spatial_flagship_predict(model, x, mesh, gather=True)
    torch.cuda.synchronize()
    out = {"launches": read_counts(),
           "peak_gib": (torch.cuda.max_memory_allocated() - base) / 2 ** 30}
    check(tuple(got.shape) == (1, 1, SCALE, SCALE)
          and bool(torch.isfinite(got).all()), "spatial flagship output")
    if mesh.is_main:
        torch.cuda.reset_peak_memory_stats()
        with torch.inference_mode():
            ref = model(x)
        torch.cuda.synchronize()
        out["unsharded_peak_gib"] = (torch.cuda.max_memory_allocated()
                                     - base) / 2 ** 30
        out["rel_err"] = float((got - ref).abs().max() / ref.abs().max())
        check(out["rel_err"] <= MG_SPATIAL_TOL,
              f"spatial flagship: {out['rel_err']} of max|logit|")
        del ref
    del model, got
    torch.cuda.empty_cache()
    return out


def mg_gan(mesh, device, ref_mesh):
    """(f) One data-parallel GAN step against one without a mesh (fp64)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(SEED + 30)
    size = GAN_SMALL["image_size"]
    images = (rng.random((2, size, size, 3)) * 255).astype(np.float32)
    masks = (rng.random((2, size, size)) < 0.2).astype(np.float32)
    want = gan_step_state(device, torch.float64, images, masks,
                          mesh_shape=ref_mesh.shape)
    got = gan_step_state(device, torch.float64, images, masks)
    loss = max(abs(got[0][k] - v) / abs(v) for k, v in want[0].items())
    check(loss <= MG_GAN_LOSS_RTOL, f"dp gan: losses {got[0]} / {want[0]}")
    upd = max(float((got[1][k] - v).abs().max())
              / max(float(v.abs().max()), 1e-300)
              for k, v in want[1].items())
    check(upd <= MG_GAN_UPDATE_TOL, f"dp gan: updates {upd}")
    return {"loss_rel": loss, "update_rel": upd}


def mg_rank(mesh, out_dir):
    """One rank of phase 12 (a spawned process): the parts (a)-(f), each
    checked here (rank 0 against the unsharded references); writes its
    numbers to ``out_dir/rank<r>.json``."""
    import torch
    import torch.distributed as dist
    from eyediseasesegmentation_tpu_torch.parallel import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # a new process would spend tens of seconds in cuDNN's timed search for
    # every shape again: the ranks take its heuristics (their ms with them)
    torch.backends.cudnn.benchmark = False
    device = mesh.device
    res = {"rank": mesh.rank, "world": mesh.size, "backend": mesh.backend,
           "seconds": {}}
    if mesh.size == 1:
        one = torch.ones(1, device=device)
        dist.all_reduce(one)
        check(float(one) == 1.0, "nccl all_reduce at world size 1")
    ref_mesh = make_mesh({"data": 1, "model": mesh.size}, device)

    def part(name, fn, *args):
        t0 = time.perf_counter()
        res[name] = fn(*args)
        res["seconds"][name] = time.perf_counter() - t0

    part("train", mg_train, mesh, device, ref_mesh)
    model = build_model(torch.bfloat16, device, mode=TTA_MODE)
    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    imgs = torch.randint(0, 256, (BATCH, *FULL_HW, 3), generator=gen,
                         device=device, dtype=torch.uint8)
    part("predict", mg_predict, mesh, device, model, imgs)
    part("tiled", mg_tiled, mesh, device, model, imgs[0])
    second = build_model(torch.bfloat16, device, mode=TTA_MODE,
                         seed=ENSEMBLE_SEED)
    part("ensemble", mg_ensemble, mesh, device, model, second, imgs[:2])
    state = {k: v.cpu() for k, v in model.state_dict().items()}
    del model, second, imgs
    torch.cuda.empty_cache()
    part("spatial", mg_spatial, mesh, device, state)
    part("gan", mg_gan, mesh, device, ref_mesh)
    with open(Path(out_dir) / f"rank{mesh.rank}.json", "w") as f:
        json.dump(res, f)


def phase_multi_gpu(card, rank_fn=mg_rank, worlds=MG_WORLDS):
    """Phase 12: ``mg_rank`` at each (world size, backend) of MG_WORLDS,
    every rank on cuda:0. The kernels are built (and cached under
    build/kernels) by this process before, so the ranks only load them.
    Returns {world tag: [each rank's numbers]}."""
    import tempfile

    import torch
    from eyediseasesegmentation_tpu_torch.parallel import spawn

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    out = {}
    for world, backend in worlds:
        tag = f"w{world}_{backend}"
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            try:
                spawn(rank_fn, world, "cuda:0", tmp, backend=backend)
            except Exception as e:          # a rank's failure, re-raised
                raise SmokeFailure(f"multi-GPU {tag}: {e}") from None
            ranks = [json.loads((Path(tmp) / f"rank{r}.json").read_text())
                     for r in range(world)]
        out[tag] = ranks
        for r in ranks:
            tr, pr = r["train"], r["predict"]
            print(f"multi-GPU {tag} rank {r['rank']}/{world}: dp parity "
                  f"256² fp32 (loss, statistics, parameters, gradients: "
                  f"worst rel) " + "/".join(
                      f"{tr['parity'][k]:.2e}" for k in (
                          "loss_rel", "stat_rel", "param_rel", "grad_rel"))
                  + "; full-width "
                  f"dp step {tr['timing']['ms_per_step']:.2f} ms, peak "
                  f"{tr['timing']['peak_gib']:.3f} GiB, loss "
                  f"{tr['timing']['loss']:.6f} (unsharded "
                  f"{tr['timing']['unsharded_loss']:.6f}; parity "
                  f"{tr['parity_seconds']:.1f} s, build "
                  f"{tr['build_seconds']:.1f} s, unsharded step "
                  f"{tr['unsharded_step_seconds']:.1f} s, first dp step "
                  f"{tr['first_dp_step_seconds']:.1f} s); sharded predict "
                  + ", ".join(f"{m} {v['ms']:.1f} ms K1/K3/K2 "
                              f"{v['launches']['axial_attention']}/"
                              f"{v['launches']['scse_conv']}/"
                              f"{v['launches']['decode_pair']} err "
                              f"{v['rel_err']}" for m, v in pr.items())
                  + f"; tiled {r['tiled']}; ensemble {r['ensemble']}; "
                  f"spatial {r['spatial']}; gan {r['gan']}; seconds "
                  f"{ {k: round(v, 1) for k, v in r['seconds'].items()} }; "
                  f"{card}", flush=True)
        print(f"multi-GPU {tag}: {time.perf_counter() - t0:.1f} s", flush=True)
    print(f"multi-GPU phase {time.perf_counter() - t_phase:.1f} s; {card}",
          flush=True)
    return out


def multi_gpu_launches(mg, name, paths):
    """{world tag: {path: [launches of ``name`` per rank]}}; a path of
    predict's is ``predict:<mode>``."""
    def count(r, path):
        if path.startswith("predict:"):
            return r["predict"][path.split(":")[1]]["launches"][name]
        if path == "tiled":
            return sum(v["launches"][name] for v in r["tiled"].values())
        return r[path]["launches"][name]
    return {tag: {path: [count(r, path) for r in ranks] for path in paths}
            for tag, ranks in mg.items()}


def phase_profile_train(device, logdir):
    """Device time by op of one full-width train step after two warm-ups
    (``utils.profiling.trace``, which writes its Chrome trace to
    ``logdir``)."""
    import torch
    from eyediseasesegmentation_tpu_torch.utils import fold_in
    from eyediseasesegmentation_tpu_torch.utils.profiling import trace

    trainer = full_trainer(device)
    images, masks = train_batch()
    gen = fold_in(torch.Generator().manual_seed(SEED), 1000)
    for _ in range(2):
        trainer.train_step(images, masks, gen, 1e-3)
    torch.cuda.synchronize()
    with trace(logdir) as prof:
        t0 = time.perf_counter()
        trainer.train_step(images, masks, gen, 1e-3)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    print_profile("train", prof, wall, rows=24)


def print_profile(tag, prof, wall, rows=16):
    """Device time by op: the self device time of each aten op (the kernels
    it launched itself), and the port's own kernels, which no aten op
    launches. Kernel records of aten ops are skipped here, or their time
    would count twice; they give the busy time."""
    from torch.autograd import DeviceType
    table, busy = [], 0.0
    for evt in prof.key_averages():
        dev = getattr(evt, "self_device_time_total",
                      getattr(evt, "self_cuda_time_total", 0.0)) / 1e3
        if dev <= 0 or evt.key == "Command Buffer Full":
            continue
        if evt.device_type == DeviceType.CUDA:
            busy += dev
            if "dconv::" not in evt.key and "axial" not in evt.key:
                continue
        table.append((dev, evt.count, evt.key))
    table.sort(reverse=True)
    total = sum(r[0] for r in table)
    print(f"profile {tag}: wall {wall:.1f} ms, device busy {busy:.1f} ms "
          f"(kernel and copy records, one stream), idle "
          f"{100 * (1 - busy / wall):.1f} %; {total:.1f} ms attributed to "
          f"ops", flush=True)
    for ms, count, key in table[:rows]:
        print(f"  {ms:9.2f} ms {100 * ms / busy:5.1f} %  x{count:<5d} "
              f"{key[:90]}", flush=True)


def phase_profile(device, modes, logdir):
    """Device time by op of one ``predict`` of the bench workload, after two
    warm-ups, for each mode (``utils.profiling.trace``, which writes each
    mode's Chrome trace to ``logdir``)."""
    import torch
    from eyediseasesegmentation_tpu_torch.utils.profiling import trace

    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    imgs = torch.randint(0, 256, (BATCH, *FULL_HW, 3), generator=gen,
                         device=device, dtype=torch.uint8)
    for mode in modes:
        predictor = bench_predictor(device, mode)
        for _ in range(2):
            predictor.predict(imgs)
        torch.cuda.synchronize()
        with trace(logdir) as prof:
            t0 = time.perf_counter()
            predictor.predict(imgs)
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0)
        print_profile(f"pallas_tail={mode}", prof, wall)
        del predictor
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    import argparse
    import tempfile

    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--profile", default=None, metavar="MODES",
                        help="comma-separated pallas_tail modes "
                             f"({', '.join(TAIL_MODES)}): print the device "
                             "time by op of one predict and stop; 'train': "
                             "of one full-width train step")
    parser.add_argument("--routes", action="store_true",
                        help="print the bf16 route check's ratios, hold "
                             "them to no bound, and stop")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (REPO / "eyediseasesegmentation_tpu_torch").is_dir():
        print("chip_smoke: the port package is not beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from eyediseasesegmentation_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    _build.load_all(list(SOURCES))
    print(f"build: {len(SOURCES)} libraries in "
          f"{time.perf_counter() - t0:.2f} s, one nvcc each, side by side",
          flush=True)
    for name in SOURCES:
        info = _build.build_info[name]
        print(f"build: {name} nvcc {info['seconds']:.2f} s", flush=True)
        for ln in info["log"].splitlines():
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln:
                print(f"  ptxas: {ln.strip()}", flush=True)

    try:
        if args.profile is not None:
            modes = args.profile.split(",")
            check(all(m in TAIL_MODES or m == "train" for m in modes),
                  f"--profile: unknown mode in {modes}")
            with tempfile.TemporaryDirectory() as logdir:
                if "train" in modes:
                    phase_profile_train(device, logdir)
                modes = [m for m in modes if m != "train"]
                if modes:
                    phase_profile(device, modes, logdir)
            print(card, flush=True)
            return 0
        if args.routes:
            phase_routes(device, hold=False)
            print(card, flush=True)
            return 0
        k1 = phase_kernel(device)
        conv = phase_conv_kernels(device)
        phase_slice(device)
        phase_routes(device)
        runs = {mode: phase_bench(device, mode) for mode in TAIL_MODES}
        phase_test_tta(device, card)
        k4_launches, k4_variants = phase_conv3x3_path(device)
        phase_train_parity(device)
        k1_eval_step = phase_train(device, card)
        with tempfile.TemporaryDirectory() as tmp:
            k1_train_model, logdir = phase_train_model(device, Path(tmp))
            pipe = phase_pipeline(device, card, Path(tmp), logdir)
            ens = phase_ensemble_zoo(device, card, Path(tmp), logdir,
                                     pipe["test"])
            phase_gan(device, card, Path(tmp))
            phase_train_options(device, card, Path(tmp))
        mg = phase_multi_gpu(card)
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1

    def entry(name, launches, stats, **extra):
        source, replaces = SOURCES[name]
        return {"name": name, "route": "cuda",
                "source": f"eyediseasesegmentation_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches,
                **{k: stats[k] for k in ("max_abs_err", "ms", "plain_ms",
                                         "bound_ms", "bound_by",
                                         "library_ms")}, **extra}

    up = conv["decode_pair_up"]
    counts = {mode: run[0] for mode, run in runs.items()}
    by_variant = {mode: run[1] for mode, run in runs.items()}
    kernels = [
        entry("axial_attention", counts["off"]["axial_attention"], k1,
              variant=k1["variant"],
              variants=by_variant["off"]["axial_attention"],
              shapes=k1["shapes"],
              train={"eval_step_launches": k1_eval_step,
                     "train_model_launches": k1_train_model},
              vessel=k1["vessel"],
              pipeline={
                  "test_tta_launches": pipe["test_tta"]["axial_attention"],
                  "tiled_pass_launches": pipe["tiled"]["axial_attention"],
                  "multiscale_launches":
                      pipe["multiscale"]["axial_attention"],
                  "vessel_sm90_launches": pipe["vessel"]["axial_attention"],
                  "vessel_train_model_sm90_launches":
                      pipe["vessel_train_k1"],
                  "card_vs_cpu_wmma_launches": pipe["card_vs_cpu_k1"]},
              ensemble_launches=ens["ensemble"]["axial_attention"],
              zoo_launches=ens["zoo"]["axial_attention"],
              zoo_card_vs_cpu_wmma_launches=ens["zoo_parity"][
                  "axial_attention"],
              multi_gpu=multi_gpu_launches(
                  mg, "axial_attention",
                  [f"predict:{m}" for m in TAIL_MODES]
                  + ["tiled", "ensemble", "spatial"])),
        entry("scse_conv", counts["v1"]["scse_conv"], conv["scse_conv"],
              variant=conv["scse_conv"]["variant"],
              variants=by_variant["v1"]["scse_conv"],
              multi_gpu=multi_gpu_launches(mg, "scse_conv", ["predict:v1"])),
        entry("decode_pair", counts["pair"]["decode_pair"],
              conv["decode_pair"], variant=conv["decode_pair"]["variant"],
              variants=by_variant["pair"]["decode_pair"],
              up_part0={"launches": counts["pair_up"]["decode_pair"],
                        "variants": by_variant["pair_up"]["decode_pair"],
                        **{k: up[k] for k in up}},
              pipeline={f"{path}_launches": pipe[path]["decode_pair"]
                        for path in ("test_tta", "tiled", "multiscale")},
              ensemble_launches=ens["ensemble"]["decode_pair"],
              zoo_launches=ens["zoo"]["decode_pair"],
              zoo_card_vs_cpu_wmma_launches=ens["zoo_parity"][
                  "decode_pair"],
              multi_gpu=multi_gpu_launches(
                  mg, "decode_pair", ["predict:pair", "predict:pair_up",
                                      "tiled", "ensemble"])),
        entry("conv3x3", k4_launches, conv["conv3x3"],
              variant=conv["conv3x3"]["variant"], variants=k4_variants,
              shapes=conv["conv3x3"]["shapes"]),
    ]
    launched = [(k["name"], field, k[field]) for k in kernels
                for field in ("launches", "ensemble_launches", "zoo_launches",
                              "zoo_card_vs_cpu_wmma_launches")
                if field in k]
    launched += [(k["name"], "up_part0", k["up_part0"]["launches"])
                 for k in kernels if "up_part0" in k]
    launched += [(k["name"], f"multi_gpu {tag} {path} rank {r}", n)
                 for k in kernels if "multi_gpu" in k
                 for tag, paths in k["multi_gpu"].items()
                 for path, per_rank in paths.items()
                 for r, n in enumerate(per_rank)]
    check(all(n > 0 for _, _, n in launched),
          f"a kernel of the path was never launched: {launched}")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Vessel-segmentation experiment driver (torch port): TRAIN → TTA
INFERENCE (AUC-ROC) → ANALYSIS.

Counterpart of the repository's ``pipeline_vessel.py`` (reference
train_vessel / tta_vessel / stat_result_vessel): DRIVE-layout defaults
(``VESSEL_DEFAULTS``: 608² padded images, ``advanced_vessel``
augmentation), the ROC threshold search, whole images without a resize.
Flags as in :mod:`.pipeline`, ``--device`` included; under ``torchrun``
the training is data-parallel and rank 0 alone infers and writes.

    python -m eyediseasesegmentation_tpu_torch.pipeline_vessel \\
        [--config overrides.json] [--exp_name NAME] [--device cpu]
"""

from __future__ import annotations

import logging
from typing import Any, Dict

from .analysis.stat_result_vessel import export_result_vessel
from .infer.tta import test_tta, tta_patches
from .pipeline import SEED, experiment_configs, parse_arg
from .train.trainer import train_model
from .parallel.mesh import is_main_process
from .utils import set_global_seed

logger = logging.getLogger("eyediseasesegmentation_tpu_torch")

VESSEL_DEFAULTS = dict(
    dataset_name="DRIVE",
    lesion_type="Vessel_DRIVE",
    train_img_path="data/processed/DRIVE/train/image",
    train_mask_path="data/processed/DRIVE/train/mask",
    test_img_path="data/processed/DRIVE/test/image",
    test_mask_path="data/processed/DRIVE/test/mask",
    augmentation="advanced_vessel",
    scale_size=608,
    data_type="all",
)


def start_experiment(args: Dict[str, Any]):
    """Train, infer with TTA scored by AUC-ROC and write the result CSVs;
    returns (run directory, inference result)."""
    exp_name, configs, test_configs = experiment_configs(args,
                                                         VESSEL_DEFAULTS)
    logger.info("Performing vessel experiment %s (SEED %d)", exp_name, SEED)
    set_global_seed(SEED)
    device = args.get("device")

    logger.info("=== TRAINING (vessel) ===")
    logdir = train_model(exp_name, configs, SEED, device=device)
    if not is_main_process():      # under torchrun: rank 0 infers
        return logdir, None

    logger.info("=== INFERENCE (TTA, AUC-ROC) ===")
    if test_configs["data_type"] == "all":
        # whole vessel images are pre-padded squares: no resize
        # (reference tta_vessel.py:76)
        result = test_tta(logdir, test_configs, args, metric="roc",
                          resize=False, device=device)
    else:
        # vessel tiled inference reports the ROC curve family
        # (reference tta_vessel.py:206-218)
        result = tta_patches(logdir, test_configs, args, metric="roc",
                             device=device)
    logger.info("inference result: %s", {k: v for k, v in result.items()
                                         if k != "out_dir"})

    logger.info("=== ANALYSIS ===")
    export_result_vessel(f"{test_configs['lesion_type']}/{exp_name}",
                         test_configs)
    logger.info("=== FINISH EXPERIMENT ===")
    return logdir, result


if __name__ == "__main__":
    # under torchrun the other ranks log warnings only
    logging.basicConfig(level=logging.INFO if is_main_process()
                        else logging.WARNING)
    start_experiment(parse_arg())

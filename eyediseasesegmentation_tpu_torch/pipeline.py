"""Lesion-segmentation experiment driver (torch port): TRAIN → TTA
INFERENCE → ANALYSIS.

Counterpart of the repository's ``pipeline.py`` (reference ``pipeline.py``):
the same flags (--createprob / --optim_thres / --best / --tta / --config /
--exp_name), the same artifact tree (checkpoints and config.json under
``models/<dataset>/<lesion>/<exp>/``; masks, figures and CSVs under
``outputs/``) and the same SEED=1999, plus ``--device``: the model runs on
the GPU unless ``--device cpu`` is given. Whole images go through
``test_tta``, ``data_type: "tile"`` through ``tta_patches``. Under
``torchrun --nproc_per_node=N -m eyediseasesegmentation_tpu_torch.pipeline``
the training is data-parallel over the N ranks (the batch size a multiple
of N) and rank 0 alone runs the inference and the analysis and writes.

    python -m eyediseasesegmentation_tpu_torch.pipeline [--tta d4] \\
        [--config overrides.json] [--exp_name NAME] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import logging
from datetime import datetime
from typing import Any, Dict, Optional, Sequence, Tuple

from .analysis.stat_result import export_result
from .config import BaseConfig, TestConfig
from .infer.tta import test_tta, tta_patches
from .train.trainer import train_model
from .parallel.mesh import is_main_process
from .utils import set_global_seed

logger = logging.getLogger("eyediseasesegmentation_tpu_torch")
SEED = 1999


def parse_arg(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    parse = argparse.ArgumentParser()
    parse.add_argument("--createprob", default="false", type=str,
                       help="Also save probability masks, not only binary")
    parse.add_argument("--optim_thres", default=0.0,
                       help="Optimal threshold obtained from the AUC-PR curve")
    parse.add_argument("--best", default="true", type=str,
                       help="Use best checkpoint (true) or last (false)")
    parse.add_argument("--tta", default="d4",
                       help="TTA alias: d4, multiscale, flip, hflip, "
                            "five_crop, ten_crop, none")
    parse.add_argument("--config", default=None, type=str,
                       help="Optional json file overriding BaseConfig fields")
    parse.add_argument("--exp_name", default=None, type=str,
                       help="Pin the experiment name (default: timestamp)")
    parse.add_argument("--device", default=None, type=str,
                       help="torch device of the model (default: the GPU)")
    return vars(parse.parse_args(argv))


def experiment_configs(args: Dict[str, Any], defaults: Dict[str, Any]
                       ) -> Tuple[str, Dict[str, Any], Dict[str, Any]]:
    """(experiment name, train config, test config): ``defaults``, then the
    ``--config`` file's keys, over ``BaseConfig`` and ``TestConfig``."""
    exp_name = args.get("exp_name") or datetime.now().strftime("%b%d_%H_%M")
    overrides = dict(defaults)
    if args.get("config"):
        with open(args["config"]) as f:
            overrides.update(json.load(f))
    configs = BaseConfig.from_dict({**BaseConfig().get_all_attributes(),
                                    **overrides}).get_all_attributes()
    test_configs = TestConfig.from_dict({**TestConfig().get_all_attributes(),
                                         **overrides}).get_all_attributes()
    return exp_name, configs, test_configs


def start_experiment(args: Dict[str, Any]):
    """Train, infer with TTA (``createprob`` forced on) and write the result
    CSVs; returns (run directory, inference result)."""
    exp_name, configs, test_configs = experiment_configs(args, {})
    logger.info("Performing experiment %s (SEED %d)", exp_name, SEED)
    set_global_seed(SEED)
    device = args.get("device")

    logger.info("=== TRAINING ===")
    logdir = train_model(exp_name, configs, SEED, device=device)
    if not is_main_process():      # under torchrun: rank 0 infers
        return logdir, None

    logger.info("=== INFERENCE (TTA) ===")
    args = dict(args, createprob="true")
    if test_configs["data_type"] == "all":
        result = test_tta(logdir, test_configs, args, device=device)
    else:
        result = tta_patches(logdir, test_configs, args, device=device)
    logger.info("inference result: %s", {k: v for k, v in result.items()
                                         if k != "out_dir"})

    logger.info("=== ANALYSIS ===")
    export_result(f"{test_configs['lesion_type']}/{exp_name}", test_configs)
    logger.info("=== FINISH EXPERIMENT ===")
    return logdir, result


if __name__ == "__main__":
    # under torchrun the other ranks log warnings only
    logging.basicConfig(level=logging.INFO if is_main_process()
                        else logging.WARNING)
    start_experiment(parse_arg())

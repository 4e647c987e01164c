"""Experiment configuration (torch port).

A copy of ``eyediseasesegmentation_tpu/config.py``: the port imports nothing
of the JAX package, so it keeps its own. ``BaseConfig`` and ``TestConfig``
carry the same key names, defaults and ``config.json`` shape, so a run
directory written by either package is read by the other; ``GanConfig``
holds the GAN trainer's constants under the JAX package's names.

Mirrors the public config surface of the reference (``src/main/config.py:16-207``):
class attributes are the experiment spec, ``get_all_attributes()`` reflects them into
a plain dict, and the trainer snapshots that dict to ``<logdir>/config.json`` which
inference/ensemble re-hydrate models from (reference ``train.py:369-372``,
``ensemble.py:41-54``).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Dict, List, Optional, Union


def _asdict_shallow(obj) -> Dict[str, Any]:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


@dataclasses.dataclass
class BaseConfig:
    """Training-time experiment spec.

    Field names/defaults follow reference ``src/main/config.py``.
    """

    # --- data (reference config.py:16-28) ---
    train_img_path: str = "data/processed/IDRiD/train/image"
    train_mask_path: str = "data/processed/IDRiD/train/mask"
    dataset_name: str = "IDRiD"
    lesion_type: str = "SE"  # MA | HE | EX | SE | vessel
    data_mode: str = "binary"
    gray: bool = False
    augmentation: str = "advanced"  # normal|easy|easy_v2|medium|advanced|advanced_vessel
    use_ben_transform: bool = False
    scale_size: int = 1024
    data_type: str = "all"  # 'all' (whole image) | 'tile' (patch csvs)

    # --- training hparams (reference config.py:31-38) ---
    finetune: bool = False
    num_epochs: int = 100
    batch_size: int = 2
    val_size: float = 0.2
    learning_rate: float = 1e-3
    weight_decay: float = 1e-5
    is_fp16: bool = True  # on TPU: bfloat16 compute policy

    # --- model (reference config.py:41-165) ---
    model_name: str = "unetplusplusstar"
    model_params: Dict[str, Any] = dataclasses.field(
        default_factory=lambda: dict(
            encoder_name="BoTSER50_Axial_Imagenet_3",
            decoder_attention_type="scse",
            base_dim=32,
            classes=1,
        )
    )

    # --- metric / loss / optim (reference config.py:167-183) ---
    metric: str = "dice"
    mode: str = "max"
    criterion: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {"bce": 0.8, "log_dice": 0.2}
    )
    deep_supervision: bool = False
    criterion_ds: Optional[str] = "bce"
    ds_weight: float = 1.0
    pos_weights: List[float] = dataclasses.field(default_factory=lambda: [500.0])
    optimizer: str = "adamw"
    scheduler: str = "reduce"
    resume_path: Optional[str] = None
    # pretrained-encoder bootstrap: path to a torch .pth whose weights are
    # imported into the encoder at init (reference keeps these under
    # models/pretrained_models/, unetplusplusstar.py:282-284); arch is
    # inferred from model_params.encoder_name unless encoder_arch is set
    encoder_weights: Optional[str] = None
    encoder_arch: Optional[str] = None

    # --- TPU-specific knobs (additive; absent keys default on load) ---
    mesh_shape: Optional[Dict[str, int]] = None  # e.g. {"data": 8} ; None = all-data
    early_stopping_patience: int = 20
    seed: int = 1999

    def get_all_attributes(self) -> Dict[str, Any]:
        """Reflect the config into a plain dict (reference config.py:185-196)."""
        return _asdict_shallow(self)

    # --- persistence (config.json contract) ---
    def to_json(self, path: Union[str, Path]) -> None:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.get_all_attributes(), f, indent=2, default=str)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "BaseConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        known = {k: v for k, v in d.items() if k in names}
        cfg = cls(**known)
        # keep unknown keys round-trippable
        cfg._extra = {k: v for k, v in d.items() if k not in names}  # type: ignore[attr-defined]
        return cfg

    @classmethod
    def from_json(cls, path: Union[str, Path]) -> "BaseConfig":
        with open(path) as f:
            return cls.from_dict(json.load(f))


@dataclasses.dataclass
class TestConfig(BaseConfig):
    """Inference-time spec (reference config.py:198-207)."""

    test_img_path: str = "data/processed/IDRiD/test/image"
    test_mask_path: str = "data/processed/IDRiD/test/label"
    out_dir: str = "outputs"
    tta: str = "d4"  # d4 | multiscale | flip | hflip | five_crop | ten_crop | none


@dataclasses.dataclass
class GanConfig:
    """GAN fine-tuning constants (reference config_gan.py:8-31). The JAX
    trainer does not read ``d_multiply``; it is kept for the key set."""

    lesion_name: str = "SE"
    image_size: int = 512
    patch_size: int = 128
    d_weight: float = 0.01
    d_multiply: int = 1
    g_learning_rate: float = 1e-4
    d_learning_rate: float = 1e-4
    num_epochs: int = 200
    eval_every: int = 40

"""Dataset path algebra (torch port).

A copy of ``eyediseasesegmentation_tpu/data/paths.py``: the behavioral
port of reference ``util/base_utils.py:20-41`` (lesion_dict) and
``get_datapath`` (l.82-122). IDRiD masks live in per-lesion subdirectories
with the ``_<LESION>.tif`` suffix; DDR/FGADR/vessel layouts differ.
"""

from __future__ import annotations

import collections
import os
import re
from pathlib import Path
from typing import Tuple, Union

Lesion = collections.namedtuple("Lesion", ["dir_name", "project_name"])

lesion_dict = {
    "MA": Lesion("1. Microaneurysms", "MicroaneurysmsSegmentation"),
    "EX": Lesion("3. Hard Exudates", "HardExudatesSegmentation"),
    "HE": Lesion("2. Haemorrhages", "HaemorrhageSegmentation"),
    "SE": Lesion("4. Soft Exudates", "SoftExudatesSegmentation"),
    "MA_DDR": Lesion("MA", "DDRMicroaneurysmsSegmentation"),
    "EX_DDR": Lesion("EX", "DDRHardExudatesSegmentation"),
    "HE_DDR": Lesion("HE", "DDRHaemorrhageSegmentation"),
    "SE_DDR": Lesion("SE", "DDRSoftExudatesSegmentation"),
    "OD": Lesion("5. Optic Disc", "OpticDiscSegmentation"),
    "EX_FGADR": Lesion("HardExudate_Masks", "FGADRHardExudatesSegmentation"),
    "HE_FGADR": Lesion("Hemohedge_Masks", "FGADRHaemorrhageSegmentation"),
    "SE_FGADR": Lesion("SoftExudate_Masks", "FGADRSoftExudatesSegmentation"),
    "MA_FGADR": Lesion("Microaneurysms_Masks", "FGADRMicroaneurysmsSegmentation"),
    "Vessel_DRIVE": Lesion("", "DRIVE_VesselSegmentation"),
    "Vessel_HRF": Lesion("", "HRF_VesselSegmentation"),
    "Vessel_CHASEDB1": Lesion("", "CHASEDB1_VesselSegmentation"),
}


def get_datapath(img_path: Union[Path, Tuple[Path, ...]],
                 mask_path: Union[Path, Tuple[Path, ...]],
                 lesion_type: str = "EX"):
    """Pair image and mask paths for a lesion/vessel dataset
    (reference base_utils.py:82-122)."""
    img_path = Path(img_path) if not isinstance(img_path, tuple) else img_path
    mask_path = Path(mask_path) if not isinstance(mask_path, tuple) else mask_path

    parts = lesion_type.split("_")
    if parts[0] == "Vessel":
        return (sorted(Path(img_path).glob("*.jpg")),
                sorted(Path(mask_path).glob("*.jpg")))

    if len(parts) == 1:  # IDRiD: masks <id>_<LESION>.tif under the lesion dir
        lesion_dir = lesion_dict[lesion_type].dir_name
        mask_suffix = "_" + lesion_type + ".tif"
        mask_names = sorted(os.listdir(os.path.join(mask_path, lesion_dir)))
        mask_ids = [re.sub(mask_suffix, "", m) for m in mask_names]
        imgs = [Path(img_path) / (mid + ".jpg") for mid in mask_ids]
        masks = [Path(mask_path) / lesion_dir / m for m in mask_names]
        return sorted(imgs), sorted(masks)

    if parts[1] == "FGADR":
        lesion_dir = lesion_dict[lesion_type].dir_name
        return (sorted(Path(img_path).glob("*.png")),
                sorted((Path(mask_path) / lesion_dir).glob("*.png")))

    if parts[1] == "DDR":
        lesion_dir = lesion_dict[lesion_type].dir_name
        if isinstance(img_path, tuple):
            tr_i = sorted(Path(img_path[0]).glob("*.jpg"))
            tr_m = sorted((Path(mask_path[0]) / lesion_dir).glob("*.tif"))
            va_i = sorted(Path(img_path[1]).glob("*.jpg"))
            va_m = sorted((Path(mask_path[1]) / lesion_dir).glob("*.tif"))
            return (tr_i, va_i), (tr_m, va_m)
        return (sorted(Path(img_path).glob("*.jpg")),
                sorted((Path(mask_path) / lesion_dir).glob("*.tif")))

    raise KeyError(lesion_type)

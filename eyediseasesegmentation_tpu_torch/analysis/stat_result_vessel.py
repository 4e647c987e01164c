"""Vessel-layout per-image statistic CSVs (torch port).

A copy of ``eyediseasesegmentation_tpu/analysis/stat_result_vessel.py``
(reference ``src/main/stat_result_vessel.py:16-101``). The vessel layout
has no lesion subdirectory (``lesion_dict`` dir_name '' for Vessel_*) and
predictions share the GT file names, so the generic exporter handles it;
this module keeps the reference's entry point.
"""

from __future__ import annotations

from .stat_result import export_result


def export_result_vessel(save_dir, test_config):
    return export_result(save_dir, test_config)

from .aucpr import pr_curve_report, roc_curve_report
from .stat_result import export_result

__all__ = ["pr_curve_report", "roc_curve_report", "export_result"]

from .aucpr import pr_curve_report, roc_curve_report

__all__ = ["pr_curve_report", "roc_curve_report"]

"""Tabular models: tree ensembles (random forest, gradient boosting)."""
from repro_torch.models.tabular.trees import GradientBoosting, RandomForest, TreeEnsemble

__all__ = ["GradientBoosting", "RandomForest", "TreeEnsemble"]

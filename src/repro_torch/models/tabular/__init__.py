"""Tabular models: tree ensembles (random forest, gradient boosting) and the MLP head."""
from repro_torch.models.tabular.mlp import MLP
from repro_torch.models.tabular.trees import GradientBoosting, RandomForest, TreeEnsemble

__all__ = ["GradientBoosting", "MLP", "RandomForest", "TreeEnsemble"]

"""Tabular models: tree ensembles (random forest, gradient boosting), linear models and the MLP."""
from repro_torch.models.tabular.linear import LinearRegression, LogisticRegression
from repro_torch.models.tabular.mlp import MLP
from repro_torch.models.tabular.trees import GradientBoosting, RandomForest, TreeEnsemble, TreeModel

__all__ = ["GradientBoosting", "LinearRegression", "LogisticRegression", "MLP", "RandomForest",
           "TreeEnsemble", "TreeModel"]

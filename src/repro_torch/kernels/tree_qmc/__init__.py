"""Tree-ensemble inference over QMC megabatches: the ``ensemble_sum`` kernel."""

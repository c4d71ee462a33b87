"""Datastore read path, AFC estimators and the synthetic ``turbofan`` workload."""

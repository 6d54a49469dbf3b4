"""Transforms, the MLP, constant folds, likelihoods and kernels."""

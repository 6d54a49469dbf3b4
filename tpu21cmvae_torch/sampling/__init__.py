"""Posterior samplers (HMC) and their diagnostics."""

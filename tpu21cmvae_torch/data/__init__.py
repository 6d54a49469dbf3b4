"""Dataset container and the synthetic 21-cm-like dataset."""

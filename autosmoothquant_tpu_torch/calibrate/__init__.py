"""See the package docstring of autosmoothquant_tpu_torch."""

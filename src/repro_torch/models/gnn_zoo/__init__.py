"""Part of the repro_torch port; see the modules."""

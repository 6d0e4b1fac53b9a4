"""Data-parallel (+ optional model-parallel) training and inference across
ranks (port of ``ptbxl_tpu/parallel/``)."""

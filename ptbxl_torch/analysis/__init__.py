"""The eval path's analysis: prediction-CSV merging and the figures of CLIs 14-17."""

from ptbxl_torch.analysis.merge import merge_prediction_frames  # noqa: F401

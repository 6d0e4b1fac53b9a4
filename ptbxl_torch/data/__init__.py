"""The PTB-XL data layer: datasets, the ADC cache, the validity manifest and the batch pipeline."""

from ptbxl_torch.data.datasets import (  # noqa: F401
    PTBXLAFDataset,
    PTBXLDataset,
    PTBXLECGMultimodalDataset,
    load_ecg,
    zscore_per_lead,
)

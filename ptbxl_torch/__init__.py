"""PyTorch / CUDA port of ptbxl_tpu for NVIDIA Hopper (H100).

The JAX package ``ptbxl_tpu`` is the reference; this package imports nothing
of it (and never ``jax``).  Public functions keep the reference's
channels-last ``[B, T, C]`` layout.  Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``; without a GPU they raise.

So far it covers inference of the baseline / AF ECGCNN and of the FiLM
multimodal model: weights bridge, z-score, models, demographic vectors,
``Predictor`` (framework and hand-written-kernel engines), Grad-CAM and
demo importance; and their training: train and eval steps, epoch loops,
batch pipeline, metrics and the trainer with its checkpoints, with the
ReLU -> MaxPool backward as a hand-written kernel.
"""

__version__ = "0.1.0"

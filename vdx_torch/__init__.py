"""vdx_torch — the PyTorch/CUDA port of vdx for NVIDIA Hopper.

Same layout as ``vdx`` (core, ops, kernels, nn, models, schedulers,
pipelines) so each module's counterpart is easy to find; ``csrc/`` holds
the hand-written CUDA kernels that replace vdx's Pallas TPU kernels.

Activations keep vdx's channels-last layout ([B, F, H, W, C]; attention
[B, S, H, D]). Entry points run on ``device="cuda"`` unless the caller
passes ``device="cpu"``. This package never imports ``jax`` or ``vdx``.
"""

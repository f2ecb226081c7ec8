"""paddle_tpu_torch: the PyTorch + CUDA port of paddle_tpu for NVIDIA H100.

The first slice serves LLaMA through the paged continuous-batching
`inference.ServingEngine`, with hand-written CUDA kernels for the prefill
flash attention (`ops.flash_attention`) and the paged decode attention
(`ops.paged_decode`). Importing this package pulls in neither jax nor
paddle_tpu. Entry points run on ``"cuda"`` unless the caller passes
``device="cpu"``, where the kernels' plain PyTorch versions run.
"""
__version__ = "0.1.0"

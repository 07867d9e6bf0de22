"""allocators layer of the PyTorch/CUDA port (mirrors ``openr_tpu/allocators/``)."""

"""monitor layer of the PyTorch/CUDA port (mirrors ``openr_tpu/monitor/``)."""

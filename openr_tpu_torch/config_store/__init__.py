"""config_store layer of the PyTorch/CUDA port (mirrors ``openr_tpu/config_store/``)."""

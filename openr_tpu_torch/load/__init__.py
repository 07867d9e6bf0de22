"""load layer of the PyTorch/CUDA port: ``admission`` only (mirrors ``openr_tpu/load/admission.py``)."""

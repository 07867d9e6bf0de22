"""analysis layer of the PyTorch/CUDA port: the runtime-inert markers (``annotations``)."""
